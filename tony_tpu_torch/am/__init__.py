"""ApplicationMaster: the scheduler brain (layer L4) — the port's copy of
the core of :mod:`tony_tpu.am` (standard library only).

Mirrors ``com.linkedin.tony.TonyApplicationMaster`` (upstream ``tony-core/src/
main/java/com/linkedin/tony/TonyApplicationMaster.java`` ≈1,500 LoC,
unverified — SURVEY.md §0, call stacks §3.1/§3.3). Responsibilities carried
over, re-mapped from YARN to the :mod:`tony_tpu_torch.scheduler` substrate:

* translate per-jobtype config into container launches (gang allocation);
* serve the control-plane RPC (register / cluster-spec / heartbeat /
  result / metrics) to executors;
* the monitor loop: heartbeat-expiry → LOST, completed-container handling,
  preemption re-request (``tony.container.preemption.max-retries``), gang
  allocation timeout, application timeout;
* success policy via :class:`~tony_tpu_torch.session.TonySession`;
* AM-attempt gang restart (``tony.am.retry-count``) — a process group is
  unforgiving about world membership (SURVEY.md §7 hard part #1), so a retry
  tears down the WHOLE gang and relaunches with ``attempt_id + 1``;
* lifecycle event emission to the jhist log (SURVEY.md §3.5).

The port's AM sizes its local scheduler from the GPU census
(:func:`tony_tpu_torch.discovery.discover_gpus`, or
``tony.scheduler.total-gpus``) whenever a job type asks for
``tony.<jobtype>.gpus``; with no card found and no override it raises
instead of launching without a limit. With ``tony.security.enabled`` it
mints the job's RPC token itself (the original's default token
provider). Not in this copy (ROADMAP queue 1, item 10; the port's client
refuses a conf that arms them): the serve autoscaler and its warm-standby
pool, the rolling fleet swap and follow mode, elastic resize, trace
collection, the pluggable credential provider and docker.
"""

from __future__ import annotations

import json
import os
import secrets
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

from tony_tpu_torch import conf as conf_mod
from tony_tpu_torch import constants
from tony_tpu_torch.conf import TonyConfig
from tony_tpu_torch.events import EventHandler
from tony_tpu_torch.rpc import ENV_JOB_TOKEN, ApplicationRpcHandler, RpcServer
from tony_tpu_torch.scheduler import (Container, ContainerLaunch,
                                      ContainerScheduler,
                                      LocalProcessScheduler)
from tony_tpu_torch.session import JobStatus, TaskStatus, TonySession

AM_ADDRESS_FILE = "am.address"
AM_TOKEN_FILE = "am.token"
FINAL_STATUS_FILE = "final-status.json"
_TICK_S = 0.05

_ITEM_10 = "ROADMAP.md, queue 1 item 10"


def refuse_unported(conf: TonyConfig) -> None:
    """Raise ``ValueError`` naming ROADMAP item 10 where the conf arms a
    part of the original AM this copy does not have — never ignore the
    setting quietly. The client calls it at submit, the AM at start."""
    armed = []
    for jt in conf.job_types():
        if jt != constants.SERVE and not conf.get(conf_mod.serve_role_key(jt)):
            continue
        ceiling = conf.get(conf_mod.serve_replicas_max_key(jt)) \
            or conf.get(conf_mod.SERVE_REPLICAS_MAX)
        if ceiling and int(ceiling) > conf.instances(jt):
            armed.append(f"{conf_mod.SERVE_REPLICAS_MAX}={ceiling} above "
                         f"{conf_mod.instances_key(jt)} (the serve "
                         f"autoscaler)")
        standby = conf.get(conf_mod.serve_warm_standby_key(jt)) \
            or conf.get(conf_mod.SERVE_WARM_STANDBY)
        if standby and int(standby) > 0:
            armed.append(f"{conf_mod.SERVE_WARM_STANDBY}={standby} (the "
                         f"AM's warm-standby pool)")
    for key, what in ((conf_mod.SERVE_SLO_TARGET_MS, "SLO autoscaling"),
                      (conf_mod.SERVE_SLO_TARGETS, "SLO autoscaling")):
        if conf.get(key) not in (None, "", "0", "0.0"):
            armed.append(f"{key} ({what})")
    for key, what in ((conf_mod.PUBLISH_FOLLOW, "the rolling fleet swap"),
                      (conf_mod.RESIZE_ENABLED, "elastic resize"),
                      ("tony.task.profiler.enabled", "trace collection"),
                      (conf_mod.DOCKER_ENABLED, "docker")):
        if conf.get_bool(key, False):
            armed.append(f"{key}=true ({what})")
    if conf.get("tony.task.profiler.collect-after-s") is not None:
        armed.append("tony.task.profiler.collect-after-s (trace "
                     "collection)")
    provider = conf.get("tony.security.credential-provider", "token")
    if provider != "token":
        armed.append(f"tony.security.credential-provider={provider} (the "
                     f"credential provider)")
    if armed:
        raise ValueError(f"not in the port's control plane yet "
                         f"({_ITEM_10}): " + "; ".join(armed))


class ApplicationMaster:
    """One AM process/thread: owns the RPC server, the scheduler client, the
    session, and the monitor loop."""

    def __init__(self, conf: TonyConfig, app_id: str, job_dir: str | Path,
                 scheduler: Optional[ContainerScheduler] = None,
                 host: str = "127.0.0.1", quiet: bool = True):
        self.conf = conf
        self.app_id = app_id
        # Resolve: executors run with a different cwd, so every path shipped
        # to them (conf, src) must be absolute.
        self.job_dir = Path(job_dir).resolve()
        self.job_dir.mkdir(parents=True, exist_ok=True)
        if scheduler is None:
            # Config-selected backend (ssh) or fall through to local.
            from tony_tpu_torch.scheduler import scheduler_from_conf
            scheduler = scheduler_from_conf(conf, self.job_dir, host)
        if scheduler is None:
            # Local substrate: enforce card asks against what this host
            # actually has (reference: GpuDiscoverer feeding the AM's
            # resource accounting) whenever any job type requests gpus.
            total_gpus = 0
            if any(conf.get_int(conf_mod.gpus_key(jt), 0) > 0
                   for jt in conf.job_types()):
                total_gpus = conf.get_int(conf_mod.SCHEDULER_TOTAL_GPUS, 0)
                if total_gpus <= 0:
                    from tony_tpu_torch import discovery
                    total_gpus = discovery.discover_gpus(
                        use_torch=True).num_gpus
                if total_gpus <= 0:
                    # 0 would mean "unlimited" to the scheduler — the
                    # opposite of what an unsatisfiable ask deserves.
                    raise ValueError(
                        "tony.<jobtype>.gpus requested but no GPUs "
                        "discovered on this host; set "
                        f"{conf_mod.SCHEDULER_TOTAL_GPUS} to override")
            scheduler = LocalProcessScheduler(
                self.job_dir, host=host, conf=conf, total_gpus=total_gpus)
        self.scheduler = scheduler
        self.host = host
        self.quiet = quiet
        self.token: Optional[str] = None
        if conf.get_bool(conf_mod.SECURITY_ENABLED, False):
            # The job's RPC token (the original's default "token"
            # provider: a per-job random shared secret). An AM relaunched
            # for the same job keeps the token its executors were born
            # with.
            token_path = self.job_dir / AM_TOKEN_FILE
            if token_path.is_file():
                self.token = token_path.read_text().strip()
            else:
                self.token = secrets.token_hex(16)
                fd = os.open(token_path, os.O_WRONLY | os.O_CREAT
                             | os.O_TRUNC, 0o600)
                with os.fdopen(fd, "w") as f:
                    f.write(self.token)
        from tony_tpu_torch.runtime import get_framework
        self.framework = get_framework(
            conf.get(conf_mod.APPLICATION_FRAMEWORK, "pytorch"))
        self.session: Optional[TonySession] = None
        self.server: Optional[RpcServer] = None
        self.handler: Optional[ApplicationRpcHandler] = None
        self.events: Optional[EventHandler] = None
        self._containers: Dict[str, Container] = {}   # task_id -> live container
        self.final_status = JobStatus.FAILED
        self.final_message = ""
        self.history_dir: Optional[Path] = None       # set in run()
        self._stop_reason: Optional[str] = None       # set by request_stop

    def _log(self, msg: str) -> None:
        if not self.quiet:
            print(f"[tony-am {self.app_id}] {msg}", file=sys.stderr, flush=True)

    def request_stop(self, reason: str) -> None:
        """Graceful external stop (SIGTERM from the client's kill fallback).
        Signal-handler safe: only sets a flag — no locks — and the monitor
        loop applies it (KILLED → normal teardown: containers reaped, events
        finalized, final status written)."""
        self._stop_reason = reason

    # -- container plumbing ------------------------------------------------
    def _launch_task(self, session: TonySession, job_type: str,
                     index: int) -> None:
        req = self.conf.container_request(job_type)
        env = {
            constants.ENV_JOB_NAME: job_type,
            constants.ENV_TASK_INDEX: str(index),
            constants.ENV_TASK_NUM: str(session.num_tasks()),
            # The REACHABLE address (matches the am.address file), not
            # RpcServer.address which maps a 0.0.0.0 bind to loopback and
            # would strand remote executors.
            constants.ENV_AM_ADDRESS: f"{self.host}:{self.server.port}",  # type: ignore[union-attr]
            constants.ENV_APP_ID: self.app_id,
            constants.ENV_ATTEMPT_ID: str(session.attempt_id),
            constants.ENV_CONF_PATH: str(self.job_dir / constants.TONY_JOB_JSON),
        }
        src = self.job_dir / "src"
        if src.is_dir():
            env[constants.ENV_SRC_DIR] = str(src)
        res = self.job_dir / "resources"
        if res.is_dir():
            env[constants.ENV_RESOURCES_DIR] = str(res)
        venv = self.conf.get(conf_mod.PYTHON_VENV)
        if venv and Path(venv).exists():
            # Resolve against the AM's cwd (= the client's, which wrote the
            # conf): executors run elsewhere and a relative path would
            # silently localize nothing.
            env[constants.ENV_VENV] = str(Path(venv).resolve())
        if self.token:
            env[ENV_JOB_TOKEN] = self.token
        container = self.scheduler.launch(ContainerLaunch(
            job_type=job_type, index=index, env=env,
            memory_mb=req.memory_mb, vcores=req.vcores, gpus=req.gpus))
        task = session.task(job_type, index)
        with session.lock:
            task.container_id = container.container_id
            if not task.status.is_terminal:
                task.status = TaskStatus.ALLOCATED
            task.touch()
        self._containers[task.task_id] = container
        self._log(f"launched {task.task_id} in {container.container_id}")

    def _try_launch(self, session: TonySession, job_type: str,
                    index: int) -> None:
        """Launch, converting substrate failures (unsatisfiable resource
        ask, staging error on the ssh substrate) into a task failure the
        success policy sees — not an AM crash (reference: the RM rejecting
        an ask surfaces as a failed container, never kills the AM)."""
        try:
            self._launch_task(session, job_type, index)
        except Exception as e:  # noqa: BLE001 — substrate errors vary
            self._log(f"launch of {job_type}:{index} failed: {e}")
            session.on_task_result(
                job_type, index, constants.EXIT_AM_ERROR,
                f"container launch failed: {e}")

    def _stop_task_containers(self, session: TonySession) -> None:
        for task in session.tasks():
            c = self._containers.get(task.task_id)
            if c is not None and c.is_running:
                self.scheduler.stop_container(c)

    # -- monitor-loop checks ----------------------------------------------
    def _check_heartbeats(self, session: TonySession) -> None:
        interval_s = self.conf.get_int(
            conf_mod.TASK_HEARTBEAT_INTERVAL_MS, 1000) / 1e3
        max_missed = self.conf.get_int(conf_mod.TASK_MAX_MISSED_HEARTBEATS, 25)
        expiry = interval_s * max_missed
        now = time.monotonic()
        # Before the gang barrier, non-registration is the gang timeout's
        # job; after it, a relaunched (preempted) executor that freezes
        # before registering has no other watchdog, so ALLOCATED tasks are
        # covered too (touch() at launch seeds their clock).
        barrier_passed = (self.handler is not None
                          and self.handler._all_registered_fired)
        watched = (TaskStatus.REGISTERED, TaskStatus.RUNNING) if not \
            barrier_passed else (TaskStatus.ALLOCATED, TaskStatus.REGISTERED,
                                 TaskStatus.RUNNING)
        for task in session.tasks():
            if task.status in watched \
                    and task.last_heartbeat \
                    and now - task.last_heartbeat > expiry:
                self._log(f"task {task.task_id} missed {max_missed} "
                          f"heartbeats -> LOST")
                session.on_task_lost(
                    task, f"missed {max_missed} heartbeats "
                          f"({expiry:.1f}s without contact)")
                c = self._containers.get(task.task_id)
                if c is not None and c.is_running:
                    self.scheduler.stop_container(c)

    def _handle_completed_containers(self, session: TonySession) -> None:
        max_preempt = self.conf.get_int(conf_mod.PREEMPTION_MAX_RETRIES, 3)
        for c in self.scheduler.poll_completed():
            task = session.task_by_container(c.container_id)
            if task is None:
                continue
            live = self._containers.get(task.task_id)
            if live is not None and live.container_id == c.container_id:
                del self._containers[task.task_id]
            if task.status.is_terminal:
                continue
            if c.exit_code == constants.EXIT_PREEMPTED:
                task.preemption_retries += 1
                if task.preemption_retries <= max_preempt:
                    self._log(f"{task.task_id} preempted "
                              f"(retry {task.preemption_retries}/{max_preempt})"
                              f" -> re-requesting container")
                    with session.lock:
                        task.host = task.port = None
                        task.status = TaskStatus.REQUESTED
                    self._try_launch(session, task.job_type, task.index)
                else:
                    session.on_task_result(
                        task.job_type, task.index, constants.EXIT_PREEMPTED,
                        f"preempted {task.preemption_retries} times "
                        f"(max {max_preempt})")
            else:
                # Executor died without a result RPC (crash, OOM-kill).
                session.on_task_result(
                    task.job_type, task.index,
                    c.exit_code if c.exit_code else constants.EXIT_FAILURE,
                    f"executor exited with {c.exit_code} without reporting")

    def _log_history_events(self, session: TonySession) -> None:
        """Append each task's latest stats-file window to the jhist log
        (tony_tpu_torch.events SERVE_WINDOW / TRAIN_STEP) — the history
        plane's ONLY collection hook: the payload is the task's already-
        normalized heartbeat dict verbatim (no second bookkeeping path),
        de-duplicated per task so an idle tick appends nothing. A dict
        carrying a train step counter (the train stats writer's schema)
        logs as TRAIN_STEP; everything else is a serve window."""
        if self.events is None:
            return
        if not hasattr(self, "_history_window_sig"):
            self._history_window_sig: Dict[str, str] = {}
        for t in session.tasks():
            m = t.serve_metrics
            if not m or t.status.is_terminal:
                continue
            sig = json.dumps(m, sort_keys=True, default=str)
            if self._history_window_sig.get(t.task_id) == sig:
                continue
            self._history_window_sig[t.task_id] = sig
            if "step" in m and "qps" not in m:
                self.events.train_step(
                    t.job_type, t.index, step=int(m.get("step", 0)),
                    step_time_s=float(m.get("step_time_s", 0.0)),
                    collective_bytes=float(m.get("collective_bytes",
                                                 0.0)),
                    mfu=float(m.get("mfu", 0.0)))
            else:
                self.events.serve_window(t.job_type, t.index, m)

    # -- one attempt -------------------------------------------------------
    def run_attempt(self, attempt_id: int) -> JobStatus:
        conf = self.conf
        session = TonySession(conf, self.app_id, attempt_id=attempt_id)
        self.session = session
        am_adapter = self.framework.am_adapter()
        am_adapter.validate_and_update_config(conf)
        am_adapter.set_session(session)
        if self.handler is None:
            self.handler = ApplicationRpcHandler(session)
        else:
            self.handler.reset(session)
        handler = self.handler

        def on_all_registered() -> None:
            am_adapter.on_all_registered()
            handler.callback_info.update(am_adapter.callback_info())
            # submit → all-RUNNING latency (BASELINE.md secondary metric):
            # the client ships its submit wall-clock in TONY_SUBMIT_TS.
            latency = None
            submit_ts = os.environ.get(constants.ENV_SUBMIT_TS)
            if submit_ts:
                try:
                    latency = time.time() - float(submit_ts)
                except ValueError:
                    pass
            session.all_running_latency_s = latency
            self._log("gang barrier passed: all tasks registered"
                      + (f" ({latency:.2f}s after submit)" if latency else ""))
            if self.events is not None:
                self.events.all_running(session.attempt_id, latency)

        handler.on_all_registered = on_all_registered
        handler.on_callback_info = am_adapter.receive_task_callback_info
        if self.events is not None:
            handler.on_registered = (
                lambda jt, i: self.events.task_started(
                    jt, i, session.task(jt, i).host or ""))
            handler.on_metrics = (
                lambda jt, i, m: self.events.task_metrics(jt, i, m))
        if self.server is None:
            self.server = RpcServer(handler, host="0.0.0.0",
                                    token=self.token).start()
            # Advertise the reachable address, not the bind-all one.
            (self.job_dir / AM_ADDRESS_FILE).write_text(
                f"{self.host}:{self.server.port}")
        if self.events is not None:
            self.events.application_inited(attempt_id, session.num_tasks())

        self._containers.clear()
        start = time.monotonic()
        gang_timeout_s = conf.get_int(conf_mod.AM_GANG_TIMEOUT_MS, 120000) / 1e3
        app_timeout_s = conf.get_int(conf_mod.APPLICATION_TIMEOUT, 0) / 1e3
        pending = [(jt, i) for jt in conf.job_types()
                   for i in range(conf.instances(jt))]
        launch_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="launch")
        try:
            while True:
                # Launch whatever the adapter allows (the reference's
                # Horovod gates workers on its driver — ``canStartTask``). Launches run
                # CONCURRENTLY: on the ssh substrate each launch pays
                # staging + connection latency, and a serial loop makes the
                # submit→all-running latency O(gang size) (SURVEY.md §7
                # hard part #4). The pool is joined before the tick
                # continues so completed-container/heartbeat checks never
                # race a half-launched task.
                still_pending = []
                launching = []
                for jt, i in pending:
                    if am_adapter.can_start_task(jt, i):
                        launching.append(launch_pool.submit(
                            self._try_launch, session, jt, i))
                    else:
                        still_pending.append((jt, i))
                for f in launching:
                    f.result()
                pending = still_pending

                self._handle_completed_containers(session)
                self._check_heartbeats(session)
                self._log_history_events(session)

                if self._stop_reason is not None:
                    with session.lock:
                        if session.job_status == JobStatus.RUNNING:
                            session.job_status = JobStatus.KILLED
                            session.final_message = self._stop_reason

                # Gang timeout applies only before the first barrier pass —
                # a preemption relaunch transiently un-registers one task and
                # must not trip it.
                if not handler._all_registered_fired and \
                        time.monotonic() - start > gang_timeout_s:
                    with session.lock:
                        for t in session.tasks():
                            if t.spec is None and not t.status.is_terminal:
                                session.on_task_lost(
                                    t, f"not registered within gang timeout "
                                       f"({gang_timeout_s:.0f}s)")
                        if session.job_status == JobStatus.RUNNING:
                            session.job_status = JobStatus.FAILED
                            session.final_message = "gang allocation timed out"
                if app_timeout_s and time.monotonic() - start > app_timeout_s:
                    with session.lock:
                        if session.job_status == JobStatus.RUNNING:
                            session.job_status = JobStatus.FAILED
                            session.final_message = (
                                f"application exceeded "
                                f"tony.application.timeout-ms")
                if session.is_done():
                    break
                time.sleep(_TICK_S)
        finally:
            launch_pool.shutdown(wait=True)
            # Teardown: untracked sidecars and any stragglers die with the job.
            session.kill_remaining(
                f"job finished: {session.job_status.value}")
            self._stop_task_containers(session)
            self.scheduler.poll_completed()
            am_adapter.stop()
            if self.events is not None:
                for t in session.tasks():
                    self.events.task_finished(
                        t.job_type, t.index, t.status.value, t.exit_code,
                        t.diagnostics, t.metrics)
        # Checkpoint plane: what the executors reported committed this
        # attempt (heartbeat piggyback) — the step the NEXT attempt's
        # restore_on_start will resume from after a gang restart.
        ckpt_step = session.last_committed_step()
        self._log(f"attempt {attempt_id}: {session.job_status.value} "
                  f"- {session.final_message}"
                  + (f" (last committed ckpt step: {ckpt_step})"
                     if ckpt_step is not None else ""))
        return session.job_status

    # -- whole application -------------------------------------------------
    def run(self) -> int:
        conf = self.conf
        conf.validate()
        refuse_unported(conf)
        conf.save(self.job_dir / constants.TONY_JOB_JSON)
        history = conf.get(conf_mod.HISTORY_LOCATION) or str(
            self.job_dir / "history")
        self.history_dir = Path(history)
        self.events = EventHandler(
            history, self.app_id,
            conf_snapshot=dict(conf.items()),
            app_name=conf.get(conf_mod.APPLICATION_NAME, ""))
        retries = conf.get_int(conf_mod.AM_RETRY_COUNT, 0)
        status = JobStatus.FAILED
        try:
            attempt = 1
            retries_used = 0
            while True:
                status = self.run_attempt(attempt)
                if status in (JobStatus.SUCCEEDED, JobStatus.KILLED):
                    break
                if retries_used < retries:
                    retries_used += 1
                    ckpt_step = (self.session.last_committed_step()
                                 if self.session else None)
                    self._log(
                        f"attempt {attempt} failed; gang restart "
                        f"({retries_used}/{retries} retries used)"
                        + (f"; resuming from committed ckpt step "
                           f"{ckpt_step}" if ckpt_step is not None
                           else ""))
                    attempt += 1
                    continue
                break
        finally:
            self.final_status = status
            self.final_message = (self.session.final_message
                                  if self.session else "")
            self.events.application_finished(status.value, self.final_message)
            self.events.close()
            (self.job_dir / FINAL_STATUS_FILE).write_text(
                json.dumps({
                    "status": status.value,
                    "message": self.final_message,
                    "app_id": self.app_id,
                    # Terminal task snapshot so the client can report final
                    # transitions even after the RPC server is gone.
                    "task_infos": (self.session.task_infos()
                                   if self.session else []),
                }))
            self.scheduler.stop()
            if self.server is not None:
                # Give the client one last poll window before the socket dies.
                time.sleep(0.1)
                self.server.stop()
        return (constants.EXIT_SUCCESS if status == JobStatus.SUCCEEDED
                else constants.EXIT_FAILURE)
