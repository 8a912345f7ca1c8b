"""In-AM job state: task registry, cluster-spec assembly, success policy —
the port's copy of :mod:`tony_tpu.session` (standard library only).

Mirrors ``com.linkedin.tony.TonySession`` / ``TonySession.TonyTask`` /
``TaskStatus`` (upstream ``tony-core/src/main/java/com/linkedin/tony/
TonySession.java``, unverified — SURVEY.md §0).  The subtle part carried over
faithfully is the **success-policy matrix** (SURVEY.md §7 "hard parts" #2):

* *untracked* job types (``ps``/``tensorboard``/``notebook``…) never affect the
  final status and are torn down when the job completes;
* if a *chief-like* task (``chief``/``master``) exists, its completion ends the
  job with its exit code ("stop on chief done");
* otherwise the job succeeds when **all tracked** tasks exit 0, and (with
  fail-fast on, the default) fails on the first tracked non-zero exit;
* a task that misses too many heartbeats is marked LOST and fails the job.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from tony_tpu_torch import constants
from tony_tpu_torch import util
from tony_tpu_torch.conf import TonyConfig


class TaskStatus(enum.Enum):
    """Lifecycle of one task (reference: ``TonySession.TaskStatus``)."""
    NEW = "NEW"                  # declared in config, no container yet
    REQUESTED = "REQUESTED"      # container requested from the scheduler
    ALLOCATED = "ALLOCATED"      # container granted, executor launching
    REGISTERED = "REGISTERED"    # executor called registerWorkerSpec
    RUNNING = "RUNNING"          # gang barrier passed, user process running
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    LOST = "LOST"                # missed-heartbeat expiry
    KILLED = "KILLED"            # torn down (untracked at job end, or preempted)
    DRAINED = "DRAINED"          # clean elastic-resize exit (committed + left)

    @property
    def is_terminal(self) -> bool:
        return self in (TaskStatus.SUCCEEDED, TaskStatus.FAILED,
                        TaskStatus.LOST, TaskStatus.KILLED,
                        TaskStatus.DRAINED)


class JobStatus(enum.Enum):
    """Final-status of the whole application (reference: ``FinalApplicationStatus``)."""
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    KILLED = "KILLED"


class TonyTask:
    """One (job_type, index) task and its container/executor state."""

    def __init__(self, job_type: str, index: int, tracked: bool,
                 elastic: bool = False):
        self.job_type = job_type
        self.index = index
        self.tracked = tracked
        # Elastic tasks are added AFTER the session was built (the serve
        # plane's replica scale-up): they never gate the gang barrier —
        # the original gang's cluster spec is already sealed — and they
        # are the only scale-DOWN victims, so the conf-declared floor
        # stays intact.
        self.elastic = elastic
        self._status = TaskStatus.NEW
        # Every status this task has held, in order (wire-visible via
        # to_info): the client's monitor poll is sampled, so a fast
        # worker can pass REGISTERED→RUNNING→SUCCEEDED between polls —
        # the history lets the monitor print every transition it
        # missed instead of silently skipping RUNNING.
        self.status_history: List[str] = [TaskStatus.NEW.value]
        self.host: Optional[str] = None
        self.port: Optional[int] = None          # rendezvous port registered by executor
        self.container_id: Optional[str] = None
        self.exit_code: Optional[int] = None
        self.diagnostics: str = ""
        self.last_heartbeat: float = 0.0
        self.start_time: float = 0.0
        self.end_time: float = 0.0
        self.preemption_retries = 0
        # Last checkpoint step this task reported committed (heartbeat
        # piggyback; None until a tony.ckpt.dir executor reports one).
        self.ckpt_step: Optional[int] = None
        # Latest weight-publication pointer this task's heartbeat
        # announced ({"version": int, "step": int} — tony_tpu.publish):
        # the AM's rolling fleet swap reads the max version across
        # tasks as its target. None until a publication exists.
        self.published: Optional[Dict[str, int]] = None
        # Latest serving telemetry this task piggybacked on its
        # heartbeat (qps / p99_ms / queue_depth / prefix_cache_hit_rate
        # / blocks_shared / prefill_chunks, plus the router's
        # prefix_digest key list and rpc_port — tony_tpu.serve): what
        # the AM's replica autoscaler and the request router decide on.
        self.serve_metrics: Dict[str, object] = {}
        self.metrics: Dict[str, float] = {}
        # Timeline of TaskMonitor samples (reference: the per-task metric
        # history MetricsRpc accumulates for the portal). Bounded: at the
        # cap, every other sample is dropped so coverage stays full-span.
        self.metrics_history: List[Dict[str, float]] = []

    METRICS_HISTORY_CAP = 512

    @property
    def status(self) -> TaskStatus:
        return self._status

    @status.setter
    def status(self, value: TaskStatus) -> None:
        self._status = value
        if self.status_history[-1] != value.value:
            self.status_history.append(value.value)

    def record_metrics(self, metrics: Dict[str, float]) -> Dict[str, float]:
        """Record one TaskMonitor sample; returns the normalized sample."""
        sample = {str(k): float(v) for k, v in metrics.items()}
        self.metrics.update(sample)
        self.metrics_history.append({"ts": time.time(), **sample})
        if len(self.metrics_history) > self.METRICS_HISTORY_CAP:
            # Thin odd indices: keeps both the span start and the sample
            # appended just above.
            del self.metrics_history[1::2]
        return sample

    @property
    def task_id(self) -> str:
        return f"{self.job_type}:{self.index}"

    @property
    def spec(self) -> Optional[str]:
        if self.host is None or self.port is None:
            return None
        return f"{self.host}:{self.port}"

    def touch(self) -> None:
        self.last_heartbeat = time.monotonic()

    def to_info(self) -> Dict[str, object]:
        """Wire form served over ``getTaskInfos`` (reference: ``TaskInfo``)."""
        return {
            "job_type": self.job_type,
            "index": self.index,
            "status": self.status.value,
            "status_history": list(self.status_history),
            "host": self.host,
            "port": self.port,
            "tracked": self.tracked,
            "exit_code": self.exit_code,
            "diagnostics": self.diagnostics,
            "ckpt_step": self.ckpt_step,
            "published": dict(self.published) if self.published else None,
            "elastic": self.elastic,
            "serve_metrics": dict(self.serve_metrics),
            "metrics": dict(self.metrics),
            "metrics_samples": len(self.metrics_history),
        }

    def __repr__(self) -> str:
        return f"TonyTask({self.task_id}, {self.status.value})"


class TonySession:
    """Thread-safe task registry + job-final-status logic.

    Built once per AM attempt from the effective config (reference:
    ``TonySession.Builder``); the AM drives transitions, the RPC service reads
    and writes under :attr:`lock`.
    """

    def __init__(self, conf: TonyConfig, app_id: str, attempt_id: int = 1):
        self.conf = conf
        self.app_id = app_id
        self.attempt_id = attempt_id
        self.lock = threading.RLock()
        self.job_status = JobStatus.RUNNING
        self.final_message = ""
        self.tensorboard_url: Optional[str] = None
        # Executor-pushed framework info by task_id (registerCallbackInfo).
        self.task_callback_info: Dict[str, str] = {}
        # submit → all-RUNNING latency, set by the AM when the gang barrier
        # passes (BASELINE.md secondary metric).
        self.all_running_latency_s: Optional[float] = None
        # Elastic-resize drain (tony_tpu.am.resize): while True, the
        # heartbeat response tells every live task to commit-and-exit,
        # and the success policy holds its verdict — the resize
        # controller, not task completion, decides what happens next.
        self._draining = False
        self._tasks: Dict[Tuple[str, int], TonyTask] = {}
        untracked = set(conf.untracked_job_types())
        for jt in conf.job_types():
            for i in range(conf.instances(jt)):
                self._tasks[(jt, i)] = TonyTask(jt, i, tracked=jt not in untracked)

    # -- registry ----------------------------------------------------------
    def task(self, job_type: str, index: int) -> TonyTask:
        with self.lock:
            key = (job_type, int(index))
            if key not in self._tasks:
                raise KeyError(f"unknown task {job_type}:{index}")
            return self._tasks[key]

    def tasks(self) -> List[TonyTask]:
        with self.lock:
            return list(self._tasks.values())

    def tracked_tasks(self) -> List[TonyTask]:
        return [t for t in self.tasks() if t.tracked]

    def untracked_tasks(self) -> List[TonyTask]:
        return [t for t in self.tasks() if not t.tracked]

    def task_by_container(self, container_id: str) -> Optional[TonyTask]:
        with self.lock:
            for t in self._tasks.values():
                if t.container_id == container_id:
                    return t
        return None

    def __iter__(self) -> Iterator[TonyTask]:
        return iter(self.tasks())

    # -- cluster spec (gang barrier) ---------------------------------------
    def all_registered(self) -> bool:
        """True once every task has called registerWorkerSpec — the gang
        barrier after which executors may start user processes. Elastic
        tasks (added after the session was built) never gate it: the
        original gang's spec is sealed, and a scale-up replica must not
        re-open the barrier for anyone."""
        with self.lock:
            return all(t.spec is not None for t in self._tasks.values()
                       if not t.elastic)

    def cluster_spec(self) -> Dict[str, List[str]]:
        """``{job_type: ["host:port", ...]}`` ordered by task index
        (reference: ``TonySession#getClusterSpec``)."""
        with self.lock:
            spec: Dict[str, List[str]] = {}
            for jt in self.conf.job_types():
                members = []
                for i in range(self.conf.instances(jt)):
                    t = self._tasks[(jt, i)]
                    members.append(t.spec or "")
                spec[jt] = members
            return spec

    # -- global rank assignment (TPU-native addition) ----------------------
    def global_rank(self, job_type: str, index: int) -> int:
        """Deterministic dense rank over rendezvous tasks (sidecars excluded),
        ordered (job_types(), index). Used by the PyTorch adapter for RANK. Must match
        ``TaskContext.global_rank``."""
        rank = 0
        for jt in self.conf.job_types():
            if jt in constants.SIDECAR_JOB_TYPES:
                continue
            n = self.conf.instances(jt)
            if jt == job_type:
                if not (0 <= index < n):
                    raise KeyError(f"unknown task {job_type}:{index}")
                return rank + index
            rank += n
        raise KeyError(f"unknown job type {job_type}")

    def num_tasks(self) -> int:
        with self.lock:
            return len(self._tasks)

    # -- transitions driven by RPC/AM --------------------------------------
    def on_registered(self, job_type: str, index: int, host: str, port: int) -> TonyTask:
        with self.lock:
            t = self.task(job_type, index)
            t.host, t.port = host, int(port)
            if not t.status.is_terminal:
                t.status = TaskStatus.REGISTERED
            t.touch()
            return t

    def on_running(self) -> None:
        """Gang barrier passed: mark all registered tasks RUNNING."""
        with self.lock:
            now = time.monotonic()
            for t in self._tasks.values():
                if t.status == TaskStatus.REGISTERED:
                    t.status = TaskStatus.RUNNING
                    t.start_time = t.start_time or now

    def on_heartbeat(self, job_type: str, index: int,
                     ckpt_step: Optional[int] = None,
                     serve: Optional[Dict[str, float]] = None,
                     published: Optional[Dict[str, int]] = None) -> None:
        t = self.task(job_type, index)
        t.touch()
        if ckpt_step is not None:
            t.ckpt_step = int(ckpt_step)
        if serve:
            try:
                t.serve_metrics = util.normalize_serve_telemetry(serve)
            except (TypeError, ValueError):
                pass          # malformed telemetry must not sink liveness
        if published:
            try:
                t.published = {"version": int(published["version"]),
                               "step": int(published["step"])}
            except (TypeError, ValueError, KeyError):
                pass          # same contract: advisory, never liveness

    # -- elastic replica scaling (tony_tpu.serve) --------------------------
    def add_task(self, job_type: str) -> TonyTask:
        """Append one ELASTIC task to ``job_type`` (the AM's replica
        scale-up): next free index, flagged so it never gates the gang
        barrier and is the preferred scale-down victim."""
        with self.lock:
            indices = [i for (jt, i) in self._tasks if jt == job_type]
            if not indices:
                raise KeyError(f"unknown job type {job_type!r}")
            idx = max(indices) + 1
            task = TonyTask(job_type, idx,
                            tracked=self.conf.is_tracked(job_type),
                            elastic=True)
            self._tasks[(job_type, idx)] = task
            return task

    def mark_scaled_down(self, task: TonyTask, reason: str) -> None:
        """Terminal KILLED without failing the job — the deliberate
        scale-down exit (vs LOST/FAILED, which trip the success
        policy)."""
        with self.lock:
            if task.status.is_terminal:
                return
            task.status = TaskStatus.KILLED
            task.exit_code = constants.EXIT_KILLED
            task.diagnostics = reason
            task.end_time = time.monotonic()

    def serve_samples(self, job_type: str) -> List[Dict[str, float]]:
        """Latest serve telemetry per live replica of ``job_type`` —
        the autoscaler's decision input."""
        with self.lock:
            return [dict(t.serve_metrics) for t in self._tasks.values()
                    if t.job_type == job_type and not t.status.is_terminal
                    and t.serve_metrics]

    def serve_job_types(self) -> List[str]:
        """Every jobtype serving traffic: the classic ``serve`` type
        plus any jobtype carrying a ``tony.serve.role.<jobtype>`` conf
        key (the disaggregated prefill/decode gangs — heterogeneous
        jobtypes of ONE job, tony_tpu.serve.disagg)."""
        from tony_tpu_torch.conf import serve_role_key

        out = []
        for jt in self.conf.job_types():
            if jt == constants.SERVE or self.conf.get(serve_role_key(jt)):
                out.append(jt)
        return out

    def serve_endpoints(self, job_type: Optional[str] = None
                        ) -> List[Dict[str, object]]:
        """Wire form of every serving replica that has reported
        telemetry — what the request router
        (:mod:`tony_tpu.serve.router`) ingests to track the elastic
        fleet: live replicas whose heartbeat carried an ``rpc_port``
        become routable at ``host:rpc_port``; terminal entries ride
        along so the router retires them. ``job_type=None`` (the
        default since the disaggregated split) spans every serve-role
        jobtype, so one poll wires the router to the prefill AND decode
        gangs; a named jobtype scopes to it. Live warm STANDBYS
        (heartbeating ``warm_standby`` — the cold-start plane's
        compiled-and-idle pool) are excluded: a standby is capacity,
        not an endpoint, until the AM promotes it; its terminal entry
        still rides along so the router retires it."""
        jts = [job_type] if job_type is not None \
            else self.serve_job_types()
        with self.lock:
            return [t.to_info() for t in self._tasks.values()
                    if t.job_type in jts
                    and (t.serve_metrics or t.status.is_terminal)
                    and not (t.serve_metrics.get("warm_standby")
                             and not t.status.is_terminal)]

    # -- elastic-resize drain (tony_tpu.am.resize) -------------------------
    def request_drain(self) -> None:
        """Arm the drain directive: every subsequent heartbeat response
        carries it, and the success policy freezes until the resize
        controller rules (clean drains must not read as job success)."""
        with self.lock:
            self._draining = True

    def clear_drain(self) -> None:
        with self.lock:
            self._draining = False

    @property
    def draining(self) -> bool:
        with self.lock:
            return self._draining

    def drain_pending(self, job_type: str, index: int) -> bool:
        """Should this task's heartbeat response carry the drain
        directive? True for any live task while a drain is armed."""
        with self.lock:
            if not self._draining:
                return False
            try:
                t = self.task(job_type, index)
            except KeyError:
                return False
            return not t.status.is_terminal

    def drain_complete(self, job_type: str) -> bool:
        """True once every tracked task of ``job_type`` is terminal —
        the DRAINING phase's completion predicate."""
        with self.lock:
            gang = [t for t in self._tasks.values()
                    if t.job_type == job_type and t.tracked]
            return bool(gang) and all(t.status.is_terminal for t in gang)

    def last_committed_step(self) -> Optional[int]:
        """Newest checkpoint step any executor has reported committed —
        what the next attempt will resume from (commit is global: process
        0 renames the manifest only after every process's shards landed,
        so ANY reporter reflects the gang-wide durable state)."""
        with self.lock:
            steps = [t.ckpt_step for t in self._tasks.values()
                     if t.ckpt_step is not None]
            return max(steps) if steps else None

    def on_task_result(self, job_type: str, index: int, exit_code: int,
                       diagnostics: str = "") -> TonyTask:
        with self.lock:
            t = self.task(job_type, index)
            if t.status.is_terminal:
                return t
            t.exit_code = int(exit_code)
            t.diagnostics = diagnostics
            t.end_time = time.monotonic()
            if exit_code == 0:
                t.status = TaskStatus.SUCCEEDED
            elif exit_code == constants.EXIT_DRAINED:
                # Clean elastic-resize exit: the task committed its
                # model+cursor and left on request — terminal, but
                # neither a success nor a failure of the job.
                t.status = TaskStatus.DRAINED
            else:
                t.status = TaskStatus.FAILED
            self._update_job_status()
            return t

    def on_task_lost(self, task: TonyTask, diagnostics: str) -> None:
        with self.lock:
            if task.status.is_terminal:
                return
            task.status = TaskStatus.LOST
            task.exit_code = constants.EXIT_LOST_TASK
            task.diagnostics = diagnostics
            task.end_time = time.monotonic()
            self._update_job_status()

    def kill_remaining(self, reason: str) -> List[TonyTask]:
        """Mark all non-terminal tasks KILLED (untracked teardown at job end,
        or client-initiated kill). Returns the tasks transitioned."""
        with self.lock:
            killed = []
            for t in self._tasks.values():
                if not t.status.is_terminal:
                    t.status = TaskStatus.KILLED
                    t.exit_code = constants.EXIT_KILLED
                    t.diagnostics = reason
                    t.end_time = time.monotonic()
                    killed.append(t)
            return killed

    # -- success policy ----------------------------------------------------
    def _chief_tasks(self) -> List[TonyTask]:
        """All tracked chief-like tasks, in (CHIEF_LIKE_JOB_TYPES, index)
        order. Plural on purpose: ``chief.instances=2`` or chief+master
        configs make every one of them decide the job, not just the first."""
        out = []
        for jt in constants.CHIEF_LIKE_JOB_TYPES:
            for (t_jt, _i), t in sorted(self._tasks.items()):
                if t_jt == jt and t.tracked:
                    out.append(t)
        return out

    def _update_job_status(self) -> None:
        """Re-derive the job status after any tracked-task transition.
        Callers hold :attr:`lock`; the re-entrant re-acquisition here
        costs nothing and makes the guard LEXICAL, so the concurrency
        lint (analysis.concurrency) flags any future job_status write
        that forgets the lock instead of trusting the docstring."""
        with self.lock:
            if self.job_status != JobStatus.RUNNING:
                return
            if self._draining:
                # Mid-resize: tasks are SUPPOSED to go terminal (drained
                # survivors, the preempted victim). The resize controller
                # owns the verdict; a frozen success policy can never
                # misread a drained gang as a finished job.
                return
            fail_fast = self.conf.get_bool(
                "tony.application.fail-fast", True)
            chiefs = self._chief_tasks()
            if chiefs:
                # Chief-done policy: the chiefs' exits decide the job. A
                # failed chief fails the job immediately; success requires
                # all chiefs. If no chief has decided yet, fall through so
                # fail-fast on other tracked tasks still applies while the
                # chief runs.
                failed_chief = next(
                    (c for c in chiefs if c.status.is_terminal
                     and c.status != TaskStatus.SUCCEEDED), None)
                if failed_chief is not None:
                    self.job_status = JobStatus.FAILED
                    self.final_message = (
                        f"chief {failed_chief.task_id} "
                        f"{failed_chief.status.value}: "
                        f"{failed_chief.diagnostics}")
                    return
                if all(c.status == TaskStatus.SUCCEEDED for c in chiefs):
                    self.job_status = JobStatus.SUCCEEDED
                    self.final_message = "chief completed successfully"
                    return
            tracked = [t for t in self._tasks.values() if t.tracked]
            failed = [t for t in tracked
                      if t.status in (TaskStatus.FAILED, TaskStatus.LOST)]
            if failed and fail_fast:
                t = failed[0]
                self.job_status = JobStatus.FAILED
                self.final_message = (
                    f"task {t.task_id} {t.status.value} "
                    f"(exit={t.exit_code}): {t.diagnostics}")
                return
            if tracked and all(t.status.is_terminal for t in tracked):
                if failed:
                    t = failed[0]
                    self.job_status = JobStatus.FAILED
                    self.final_message = (
                        f"{len(failed)}/{len(tracked)} tracked tasks "
                        f"failed; first: {t.task_id} exit={t.exit_code}")
                else:
                    self.job_status = JobStatus.SUCCEEDED
                    self.final_message = (
                        "all tracked tasks completed successfully")

    def is_done(self) -> bool:
        with self.lock:
            return self.job_status != JobStatus.RUNNING

    def task_infos(self) -> List[Dict[str, object]]:
        return [t.to_info() for t in self.tasks()]
