"""TonyClient: the gateway-side submitter + monitor (layer L5) — the port's
copy of :mod:`tony_tpu.client` (standard library only).

Mirrors ``com.linkedin.tony.TonyClient`` (upstream ``tony-core/src/main/java/
com/linkedin/tony/TonyClient.java`` ≈1,200 LoC, unverified — SURVEY.md §0,
call stack §3.1). Responsibilities carried over:

* assemble the effective config (file + ``-D`` overrides + CLI switches) and
  sanity-check it before submission (reference: ``TonyClient#init``);
* stage the user's ``--src_dir`` into the job directory — the moral
  equivalent of the HDFS staging upload (``Utils.uploadFileAndSetConfResources``,
  SURVEY.md §2.1 "Resource localization"); executors then localize a
  per-container copy;
* "submit the application": here the AM launches as a local subprocess
  (``python -S -m tony_tpu_torch.am``) instead of a YARN AM container — the
  :mod:`tony_tpu_torch.scheduler` substrate behind the AM decides where
  executors actually run (local processes or GPU hosts over SSH);
* the 1-second monitor poll loop: ``get_task_infos`` + ``get_job_status``
  over the control-plane RPC, printing task transitions and the TensorBoard
  URL exactly like the reference's ``monitorApplication``;
* listener callbacks for task-info updates (reference: ``addListener``);
* the exit-code contract: 0 iff the job's final status is SUCCEEDED.

A conf that arms a part of the original AM the port's does not have (the
serve autoscaler, the fleet swap, resize, trace collection, a credential
provider, docker) is refused at submit, naming ROADMAP item 10
(:func:`tony_tpu_torch.am.refuse_unported`).
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from tony_tpu_torch import conf as conf_mod
from tony_tpu_torch import constants
from tony_tpu_torch.am import (AM_ADDRESS_FILE, AM_TOKEN_FILE,
                               FINAL_STATUS_FILE, refuse_unported)
from tony_tpu_torch.conf import TonyConfig
from tony_tpu_torch.rpc import RpcClient
from tony_tpu_torch.util import (child_pythonpath, control_plane_site_env,
                                 default_workdir)

_POLL_INTERVAL_S = 0.2


_app_seq = itertools.count(1)


def new_app_id() -> str:
    """``app_<epoch_ms>_<pid><seq>`` — YARN-shaped, collision-free across
    processes (ms + pid) and within one process (sequence counter)."""
    return (f"app_{int(time.time() * 1000)}_"
            f"{os.getpid() % 10000:04d}{next(_app_seq):03d}")


class TonyClient:
    """One submission lifecycle: :meth:`run` returns the job exit code."""

    def __init__(self, conf: TonyConfig,
                 src_dir: Optional[str | Path] = None,
                 workdir: Optional[str | Path] = None,
                 app_id: Optional[str] = None,
                 am_host: str = "127.0.0.1",
                 quiet: bool = False,
                 stream: Optional[object] = None):
        self.conf = conf
        self.src_dir = Path(src_dir) if src_dir else None
        self.workdir = Path(workdir) if workdir else default_workdir()
        self.app_id = app_id or new_app_id()
        self.am_host = am_host
        self.quiet = quiet
        self.stream = stream or sys.stderr
        # Resolved: paths derived from the job dir (staged venv/src) are
        # shipped through the conf to executors running with a DIFFERENT
        # cwd — a relative --workdir must not produce relative staged
        # paths (found live: a relative venv path resolved fine in the
        # AM's cwd, then silently vanished in every container).
        self.job_dir = (self.workdir / self.app_id).resolve()
        self.am_proc: Optional[subprocess.Popen] = None
        self._am_launches = 0
        self.final_status: Optional[str] = None
        self.final_message = ""
        self.tensorboard_url: Optional[str] = None
        self.submit_time: Optional[float] = None
        self.all_running_latency_s: Optional[float] = None
        self._listeners: List[Callable[[List[Dict]], None]] = []
        self._last_status: Dict[str, str] = {}

    # -- reference: TonyClient#addListener ---------------------------------
    def add_listener(self, fn: Callable[[List[Dict]], None]) -> None:
        """``fn(task_infos)`` invoked on every monitor poll."""
        self._listeners.append(fn)

    def _log(self, msg: str) -> None:
        if not self.quiet:
            print(msg, file=self.stream, flush=True)

    def _notify(self, infos: List[Dict]) -> None:
        """Listener fan-out. Guarded: a broken listener must not abort the
        monitor loop (which would SIGKILL a healthy AM in the finally path)."""
        for fn in self._listeners:
            try:
                fn(infos)
            except Exception as e:  # noqa: BLE001 — listener is user code
                self._log(f"listener {fn!r} raised: {e}")

    # -- staging (reference: HDFS upload in TonyClient#run) ----------------
    def stage(self) -> None:
        self.job_dir.mkdir(parents=True, exist_ok=True)
        if self.src_dir is not None:
            if not self.src_dir.is_dir():
                raise FileNotFoundError(f"--src_dir {self.src_dir} not found")
            dest = self.job_dir / "src"
            if not dest.exists():
                # The workdir may live INSIDE src_dir (e.g. `tony submit
                # --src_dir . --workdir ./jobs`): copying it would recurse
                # into the copy being made until ENAMETOOLONG. Prune any
                # entry that is (or contains) the job workdir.
                job_root = self.job_dir.resolve()
                skip = {job_root, job_root.parent}  # job dir AND workdir:
                # --workdir . makes workdir_root == src_dir (never a child
                # entry), but the job dir itself then is one.

                def _skip_workdir(path, names):
                    p = Path(path)
                    return [n for n in names if (p / n).resolve() in skip]

                shutil.copytree(self.src_dir, dest, ignore=_skip_workdir)
        # Stage the venv (dir or archive) next to the job, like the
        # reference's HDFS venv upload; executors localize per container.
        venv = self.conf.get(conf_mod.PYTHON_VENV)
        if venv:
            src = Path(venv)
            if src.is_dir():
                staged = self.job_dir / "venv"
                if not staged.exists():
                    shutil.copytree(src, staged, symlinks=True)
            elif src.is_file():
                staged = self.job_dir / src.name
                if not staged.exists():
                    shutil.copy2(src, staged)
            else:
                raise FileNotFoundError(f"--python_venv {venv} not found")
            self.conf.set(conf_mod.PYTHON_VENV, str(staged))
        # tony.containers.resources: stage each entry under <job>/resources
        # and rewrite the conf to the staged copies — executors resolve
        # entries by basename against the (possibly remote) resources dir.
        entries = self.conf.get_list(conf_mod.CONTAINERS_RESOURCES)
        if entries:
            res_dir = self.job_dir / "resources"
            res_dir.mkdir(exist_ok=True)
            names = [Path(e.partition("#")[0]).name for e in entries]
            dupes = {n for n in names if names.count(n) > 1}
            if dupes:
                # Entries localize by basename into one flat dir; a
                # collision would silently ship the first entry's bytes
                # under the second entry's name.
                raise ValueError(
                    f"{conf_mod.CONTAINERS_RESOURCES}: duplicate "
                    f"basenames {sorted(dupes)}")
            staged_csv = []
            for entry in entries:
                path_s, marker, flag = entry.partition("#")
                src = Path(path_s)
                if not src.exists():
                    raise FileNotFoundError(
                        f"{conf_mod.CONTAINERS_RESOURCES} entry "
                        f"{path_s!r} not found")
                dest = res_dir / src.name
                if not dest.exists():
                    if src.is_dir():
                        shutil.copytree(src, dest, symlinks=True)
                    else:
                        shutil.copy2(src, dest)
                staged_csv.append(f"{dest}{marker}{flag}")
            self.conf.set(conf_mod.CONTAINERS_RESOURCES,
                          ",".join(staged_csv))
        self.conf.save(self.job_dir / "client-conf.json")

    def submit(self) -> None:
        """Validate, stage, and launch the AM process (reference:
        ``createYarnApplication`` + ``submitApplication``)."""
        self.conf.validate()
        refuse_unported(self.conf)
        self.stage()
        self._launch_am()
        self._log(f"submitted application {self.app_id} "
                  f"(job dir {self.job_dir})")

    def _launch_am(self) -> None:
        am_log = open(self.job_dir / "am.log", "ab")
        env = dict(os.environ)
        env["PYTHONPATH"] = child_pythonpath(env)
        env.update(control_plane_site_env())
        # Submit timestamp for the AM's submit→all-RUNNING latency metric.
        self.submit_time = time.time()
        env[constants.ENV_SUBMIT_TS] = repr(self.submit_time)
        self.am_proc = subprocess.Popen(
            # -S: the AM is stdlib-only; skipping the site import is pure
            # submit→running latency. Lazy imports still work via
            # TONY_SITE_DIRS (control_plane_site_env above +
            # restore_site_dirs in the AM __main__) — NOT via PYTHONPATH,
            # which reaches user processes.
            [sys.executable, "-S", "-m", "tony_tpu_torch.am",
             "--conf", str(self.job_dir / "client-conf.json"),
             "--app-id", self.app_id,
             "--job-dir", str(self.job_dir),
             "--host", self.am_host],
            env=env, stdout=am_log, stderr=subprocess.STDOUT,
            start_new_session=True)
        am_log.close()
        self._am_launches += 1

    # -- monitoring (reference: monitorApplication poll loop) --------------
    def _am_address(self) -> Optional[str]:
        path = self.job_dir / AM_ADDRESS_FILE
        if path.is_file():
            addr = path.read_text().strip()
            if addr:
                return addr
        return None

    def _token(self) -> Optional[str]:
        """The job's RPC token the AM minted (``tony.security.enabled``),
        or None."""
        path = self.job_dir / AM_TOKEN_FILE
        return path.read_text().strip() if path.is_file() else None

    def _print_transitions(self, infos: List[Dict]) -> None:
        for info in infos:
            tid = f"{info['job_type']}:{info['index']}"
            # The poll is sampled, so a fast worker can pass through
            # RUNNING between two polls — walk the AM's status history
            # (to_info carries it) and print every transition not yet
            # logged, in order, instead of only the latest snapshot.
            # Older AMs (no history) degrade to the snapshot alone.
            history = info.get("status_history") or [info["status"]]
            statuses = [s for s in history if s != "NEW"]
            printed = self._last_status.get(tid, [])
            if statuses[:len(printed)] != printed:
                printed = []          # a new AM attempt restarted the task
            for status in statuses[len(printed):]:
                where = f" on {info['host']}" if info.get("host") else ""
                extra = ""
                if status in ("FAILED", "LOST") and info.get("diagnostics"):
                    extra = f" — {info['diagnostics']}"
                self._log(f"task {tid} -> {status}{where}{extra}")
            self._last_status[tid] = statuses

    def monitor(self, timeout: Optional[float] = None) -> int:
        """Poll until the job reaches a final status; returns the exit code
        (0 iff SUCCEEDED). Ctrl-C kills the job via ``finish_application``."""
        assert self.am_proc is not None, "call submit() first"
        deadline = time.monotonic() + timeout if timeout else None
        client: Optional[RpcClient] = None
        try:
            while True:
                final = self._read_final_status()
                if final is not None:
                    # Drain: the AM has written its verdict; report it, plus
                    # the terminal task transitions the live poll may have
                    # missed in the AM's last tick.
                    self.final_status = final["status"]
                    self.final_message = final.get("message", "")
                    infos = final.get("task_infos") or []
                    if infos:
                        self._print_transitions(infos)
                        self._notify(infos)
                    break
                if self.am_proc.poll() is not None \
                        and self._read_final_status() is None:
                    # AM process died without a verdict. Reference: the RM
                    # relaunches the AM container up to yarn's am
                    # max-attempts and the new attempt re-runs the session
                    # (executors of the dead attempt self-terminate on
                    # heartbeat loss). Same contract here via
                    # tony.am.max-attempts.
                    max_attempts = self.conf.get_int(
                        conf_mod.AM_MAX_ATTEMPTS, 1)
                    if self._am_launches < max_attempts:
                        self._log(
                            f"AM process exited with "
                            f"{self.am_proc.returncode} before a final "
                            f"status; relaunching "
                            f"(attempt {self._am_launches + 1}"
                            f"/{max_attempts})")
                        (self.job_dir / AM_ADDRESS_FILE).unlink(
                            missing_ok=True)
                        if client is not None:
                            client.close()
                            client = None
                        # Let the dead attempt's executors notice the AM
                        # loss and release their resources (chips!) before
                        # the new attempt spawns its gang — otherwise the
                        # two attempts double-book the hardware.
                        hb_s = self.conf.get_int(
                            conf_mod.TASK_HEARTBEAT_INTERVAL_MS, 1000) / 1e3
                        misses = max(3, self.conf.get_int(
                            conf_mod.TASK_MAX_MISSED_HEARTBEATS, 25))
                        # Worst-case executor detection time — NOT capped
                        # below it: relaunching early double-books chips
                        # against the dead attempt's still-live executors.
                        # Each missed heartbeat costs up to the RPC client's
                        # worst-case call time (retry window + a last
                        # attempt's socket connect+recv — an unreachable
                        # host blackholes, it doesn't refuse) plus the
                        # inter-beat wait.
                        per_call = RpcClient.worst_case_call_s(
                            max(1.0, hb_s))
                        grace = misses * (per_call + hb_s) + 2.0
                        self._log(f"waiting {grace:.0f}s for the previous "
                                  f"attempt's executors to wind down")
                        time.sleep(grace)
                        self._last_status.clear()  # re-log attempt-2 states
                        self._launch_am()
                        continue
                    self.final_status = "FAILED"
                    self.final_message = (
                        f"AM process exited with {self.am_proc.returncode} "
                        f"before reporting a final status (see "
                        f"{self.job_dir / 'am.log'})")
                    break
                addr = self._am_address()
                if addr is not None:
                    if client is None:
                        client = RpcClient(addr, token=self._token(),
                                           timeout=2.0)
                    try:
                        infos = client.call("get_task_infos")
                        status = client.call("get_job_status")
                    except Exception:
                        infos, status = None, None  # AM mid-shutdown; re-poll
                    if infos is not None:
                        self._print_transitions(infos)
                        self._notify(infos)
                    if status is not None:
                        url = status.get("tensorboard_url")
                        if url and url != self.tensorboard_url:
                            self.tensorboard_url = url
                            self._log(f"TensorBoard at {url}")
                        lat = status.get("all_running_latency_s")
                        if lat and self.all_running_latency_s is None:
                            self.all_running_latency_s = float(lat)
                            self._log(f"all tasks running {lat:.2f}s "
                                      f"after submit")
                if deadline and time.monotonic() > deadline:
                    self._log(f"client monitor timed out; killing {self.app_id}")
                    self.kill("client monitor timeout")
                    self.final_status = "KILLED"
                    self.final_message = "client monitor timeout"
                    break
                time.sleep(_POLL_INTERVAL_S)
        except KeyboardInterrupt:
            self._log(f"interrupt: killing application {self.app_id}")
            self.kill("killed by client interrupt")
            self.final_status = "KILLED"
            self.final_message = "killed by client interrupt"
        finally:
            if client is not None:
                client.close()
            self._reap_am()
        self._log(f"application {self.app_id} finished: {self.final_status}"
                  + (f" — {self.final_message}" if self.final_message else ""))
        return (constants.EXIT_SUCCESS if self.final_status == "SUCCEEDED"
                else constants.EXIT_FAILURE)

    def _read_final_status(self) -> Optional[Dict]:
        path = self.job_dir / FINAL_STATUS_FILE
        if not path.is_file():
            return None
        try:
            return json.loads(path.read_text())
        except (ValueError, OSError):
            return None

    def _reap_am(self, grace_s: float = 10.0) -> None:
        if self.am_proc is None:
            return
        try:
            self.am_proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            self.am_proc.kill()
            self.am_proc.wait()

    def kill(self, reason: str = "killed by client") -> None:
        """Best-effort job kill over RPC, then SIGTERM the AM."""
        addr = self._am_address()
        if addr is not None:
            try:
                with RpcClient(addr, token=self._token(), timeout=2.0) as c:
                    c.call("finish_application", reason=reason)
                    return
            except Exception:
                pass
        if self.am_proc is not None and self.am_proc.poll() is None:
            self.am_proc.terminate()

    def run(self, timeout: Optional[float] = None) -> int:
        """submit + monitor: the whole reference ``TonyClient.run`` path."""
        self.submit()
        return self.monitor(timeout=timeout)
