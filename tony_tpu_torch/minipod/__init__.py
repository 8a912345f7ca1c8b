"""MiniPod: the in-process dev/test cluster (MiniYARNCluster analogue) —
the port's copy of :mod:`tony_tpu.minipod`, on the port's AM and
scheduler.

The reference's single best testing idea (SURVEY.md §4): a full
RM+NM+HDFS inside one JUnit JVM, launching containers as REAL local
processes, so every failure semantic — heartbeat expiry, gang barriers,
fail-fast, preemption — is exercised against live executors rather than
mocks. MiniPod is that trick for this framework: the AM runs on a thread in
the calling process, containers are real ``python -S -m tony_tpu_torch.executor``
subprocesses via :class:`~tony_tpu_torch.scheduler.LocalProcessScheduler`, and the
caller gets the live :class:`~tony_tpu_torch.am.ApplicationMaster` to poke at
(preempt containers, inspect the session) while the job runs.

Also the substance of ``tony-mini`` (the reference's docker pseudo-cluster,
SURVEY.md §2.2) — here no docker is needed because the substrate is plain
processes.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Dict, Optional

from tony_tpu_torch.am import ApplicationMaster
from tony_tpu_torch.conf import TonyConfig
from tony_tpu_torch.scheduler import LocalProcessScheduler


class MiniPodJob:
    """A running (or finished) MiniPod job: join it, or reach into the live
    AM/session/scheduler mid-flight."""

    def __init__(self, am: ApplicationMaster):
        self.am = am
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"minipod-{am.app_id}")
        self.exit_code: Optional[int] = None

    def _run(self) -> None:
        self.exit_code = self.am.run()

    def start(self) -> "MiniPodJob":
        self._thread.start()
        return self

    @property
    def session(self):
        return self.am.session

    @property
    def scheduler(self) -> LocalProcessScheduler:
        return self.am.scheduler  # type: ignore[return-value]

    def wait(self, timeout: float = 60.0) -> int:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"MiniPod job {self.am.app_id} still running after {timeout}s")
        assert self.exit_code is not None
        return self.exit_code

    def wait_for(self, predicate, timeout: float = 30.0, what: str = ""):
        """Poll a predicate over the live job (e.g. "task running") —
        the e2e tests' synchronization primitive."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            value = predicate()
            if value:
                return value
            time.sleep(0.02)
        raise TimeoutError(f"MiniPod wait_for timed out: {what}")

    def kill(self, reason: str = "killed by test") -> None:
        if self.session is not None:
            handler = self.am.handler
            if handler is not None:
                handler.rpc_finish_application(reason=reason)


class MiniPod:
    """Factory for MiniPod jobs rooted in one work directory."""

    _counter = 0

    def __init__(self, workdir: str | Path):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)

    def submit(self, props: Dict[str, str],
               src_dir: Optional[str | Path] = None,
               app_id: Optional[str] = None) -> MiniPodJob:
        """Build a job from config props (fast heartbeats defaulted for test
        speed), optionally stage ``src_dir``, start the AM thread."""
        MiniPod._counter += 1
        app_id = app_id or f"app_minipod_{MiniPod._counter:04d}"
        conf = TonyConfig({
            "tony.task.heartbeat-interval-ms": "200",
            "tony.am.gang-allocation-timeout-ms": "30000",
            **{str(k): str(v) for k, v in props.items()},
        })
        job_dir = self.workdir / app_id
        job_dir.mkdir(parents=True, exist_ok=True)
        if src_dir is not None:
            import shutil
            dest = job_dir / "src"
            if not dest.exists():
                shutil.copytree(src_dir, dest)
        am = ApplicationMaster(conf, app_id=app_id, job_dir=job_dir)
        return MiniPodJob(am).start()

    def run(self, props: Dict[str, str],
            src_dir: Optional[str | Path] = None,
            timeout: float = 60.0) -> MiniPodJob:
        """Submit and wait; returns the finished job."""
        job = self.submit(props, src_dir=src_dir)
        job.wait(timeout)
        return job
