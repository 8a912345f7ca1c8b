"""TaskExecutor: the in-container bootstrap around the user process — the
port's copy of :mod:`tony_tpu.executor`, launched as ``python -S -m
tony_tpu_torch.executor`` (standard library only: it imports no torch).

Mirrors ``com.linkedin.tony.TaskExecutor`` + ``TaskMonitor`` (upstream
``tony-core/src/main/java/com/linkedin/tony/TaskExecutor.java`` ≈600 LoC /
``TaskMonitor.java`` ≈400 LoC, unverified — SURVEY.md §0, call stack §3.2).
Sequence, faithfully carried over:

1. read the AM→executor env contract (job type, index, AM address, conf path);
2. reserve the rendezvous port (and the TensorBoard port when the adapter
   asks) via a held listening socket — the reference's ``ServerSocket`` trick;
3. ``register_worker_spec`` over RPC;
4. poll ``get_cluster_spec`` until the AM has ALL registrations (gang barrier);
5. build the framework env via the runtime adapter (``TF_CONFIG``, the JAX
   coordinator triple, …), localize ``src_dir`` into the container workdir;
6. release the reserved sockets, fork the user process, pump its output to
   the container log;
7. heartbeat + metrics threads while the user process runs;
8. ``register_execution_result`` and exit with the user's exit code.

The metrics monitor samples ``/proc`` (cpu%/rss), as the original does
(the reference TonY's monitor also samples GPU utilization; that is not
ported). The heartbeat carries the last committed checkpoint step and the
publication pointer of ``tony.ckpt.dir``, read through
:mod:`tony_tpu_torch.ckpt_layout` (standard library: the heartbeat never
imports torch). The profiler-port reservation and its callback
push are not in the port: no port runtime asks for them.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Optional

from tony_tpu_torch import chaos, constants
from tony_tpu_torch import conf as conf_mod
from tony_tpu_torch import util
from tony_tpu_torch.ckpt_layout import latest_publication, latest_step
from tony_tpu_torch.conf import TonyConfig
from tony_tpu_torch.rpc import ENV_JOB_TOKEN, RpcClient
from tony_tpu_torch.runtime import TaskContext, get_framework

def _proc_descendants(root: int) -> list:
    """All live descendant pids of ``root``, via one /proc scan. Callers
    must kill ``root`` before this list so a supervising parent can't
    respawn children mid-sweep."""
    children: Dict[int, list] = {}
    for p in Path("/proc").glob("[0-9]*"):
        try:
            stat = (p / "stat").read_text()
        except OSError:
            continue
        # field 4 (after the parenthesised comm, which may contain spaces)
        ppid = int(stat.rsplit(")", 1)[1].split()[1])
        children.setdefault(ppid, []).append(int(p.name))
    out, stack = [], [root]
    while stack:
        for c in children.get(stack.pop(), []):
            out.append(c)
            stack.append(c)
    return out


def _link_tree(src: Path, dest: Path, symlinks: bool = False) -> None:
    """copytree that hardlinks file content instead of copying (falls back
    to a real copy across filesystems). Venvs run to GBs and localization
    is per-container — a byte copy per container is the dominant cost in
    the submit→all-running latency (SURVEY.md §7 hard part #4); links make
    it metadata-only. ONLY for trees used read-only by convention (the
    venv): an in-place write through a hardlink would mutate the staged
    copy and every sibling container. src trees keep real copies — user
    code freely writes into its own src dir."""
    def _link(s, d, **kw):
        try:
            os.link(s, d)
        except OSError:           # cross-device, perms, or FS without links
            shutil.copy2(s, d)

    shutil.copytree(src, dest, symlinks=symlinks, copy_function=_link)


def read_serve_stats(path: str | Path) -> Optional[Dict[str, object]]:
    """The replica engine's published telemetry (qps/p99_ms/queue_depth
    — see ``ServeEngine.write_stats``), or None. Scalars normalize to
    float; the router's ``prefix_digest`` (a list of block chain-keys)
    passes through as a string list. Jax-free and failure-silent by
    contract: this rides the heartbeat loop, and a torn/absent/garbage
    stats file must never sink liveness."""
    try:
        with open(path) as fh:
            raw = json.load(fh)
        return util.normalize_serve_telemetry(raw)
    except Exception:   # noqa: BLE001 — advisory telemetry only
        return None


def reserve_port(host: str = "") -> socket.socket:
    """Bind a listening socket on an ephemeral port and keep it open —
    the reference's ServerSocket reservation. Caller closes just before the
    user process needs to bind the port itself."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    s.listen(1)
    return s


class TaskMonitor:
    """Samples the user process from /proc on ``tony.task.metrics-interval-ms``
    and ships ``{cpu_pct, rss_mb, uptime_s}`` to the AM (reference:
    ``TaskMonitor`` → ``MetricsRpc``)."""

    def __init__(self, pid: int, client: RpcClient, job_type: str, index: int,
                 interval_s: float):
        self.pid = pid
        self.client = client
        self.job_type = job_type
        self.index = index
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="task-monitor")
        self._start_time = time.monotonic()
        self._last_cpu: Optional[tuple[float, float]] = None  # (cpu_s, wall)

    def start(self) -> None:
        self._thread.start()

    def sample(self) -> Optional[Dict[str, float]]:
        try:
            with open(f"/proc/{self.pid}/stat") as f:
                fields = f.read().rsplit(") ", 1)[1].split()
            utime, stime = int(fields[11]), int(fields[12])
            with open(f"/proc/{self.pid}/statm") as f:
                rss_pages = int(f.read().split()[1])
        except (OSError, IndexError, ValueError):
            return None
        hz = os.sysconf("SC_CLK_TCK")
        page = os.sysconf("SC_PAGE_SIZE")
        cpu_s = (utime + stime) / hz
        now = time.monotonic()
        cpu_pct = 0.0
        if self._last_cpu is not None:
            prev_cpu, prev_wall = self._last_cpu
            dt = now - prev_wall
            if dt > 0:
                cpu_pct = 100.0 * (cpu_s - prev_cpu) / dt
        self._last_cpu = (cpu_s, now)
        return {
            "cpu_pct": round(cpu_pct, 2),
            "rss_mb": round(rss_pages * page / (1024 * 1024), 2),
            "uptime_s": round(now - self._start_time, 2),
        }

    def _run(self) -> None:
        # A failed report must not kill the monitor: during an AM-relaunch
        # window every metrics RPC fails transiently, and dying here would
        # silence metrics for the rest of the job (the heartbeat loop
        # tolerates the same outage). Back off exponentially while the AM
        # is unreachable, resume the normal cadence on the first success.
        backoff = 0.0
        while not self._stop.wait(self.interval_s + backoff):
            m = self.sample()
            if m is None:
                return  # user process exited; nothing left to sample
            try:
                self.client.call("metrics_report", job_type=self.job_type,
                                 index=self.index, metrics=m)
                backoff = 0.0
            except Exception:
                backoff = min(60.0, max(self.interval_s, backoff * 2))

    def stop(self, join_timeout_s: float = 2.0) -> None:
        """Signal and JOIN (bounded): the monitor shares the executor's
        RPC client, and teardown closing that client under a mid-call
        sampler was a race, not a shutdown. The monitor's own RPC window
        is short; a stuck call is abandoned at the timeout rather than
        wedging executor exit."""
        self._stop.set()
        if self._thread.is_alive() \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=join_timeout_s)


class TaskExecutor:
    """One executor lifecycle; :meth:`run` returns the exit code to die with."""

    def __init__(self, env: Optional[Dict[str, str]] = None):
        e = env if env is not None else os.environ
        self.job_type = e[constants.ENV_JOB_NAME]
        self.index = int(e[constants.ENV_TASK_INDEX])
        self.am_address = e[constants.ENV_AM_ADDRESS]
        self.app_id = e.get(constants.ENV_APP_ID, "app_unknown")
        self.attempt_id = int(e.get(constants.ENV_ATTEMPT_ID, "1"))
        self.conf = TonyConfig.load(e[constants.ENV_CONF_PATH])
        self.host = e.get("TONY_EXECUTOR_HOST", "127.0.0.1")
        self.src_dir = e.get(constants.ENV_SRC_DIR) or None
        self.venv_path = e.get(constants.ENV_VENV) or None
        self.resources_dir = e.get(constants.ENV_RESOURCES_DIR) or None
        self.log_dir = Path(e.get(constants.ENV_LOG_DIR, "."))
        self.token = e.get(ENV_JOB_TOKEN) or None
        self.client = RpcClient(self.am_address, token=self.token,
                                timeout=60.0)
        self.framework = get_framework(
            self.conf.get(conf_mod.APPLICATION_FRAMEWORK, "pytorch"))
        self.user_proc: Optional[subprocess.Popen] = None
        self._am_lost = False
        self._hb_stop = threading.Event()

    # -- pieces ------------------------------------------------------------
    def serve_stats_path(self) -> Path:
        """The per-container serving-telemetry file: the executor
        exports this path (``TONY_SERVE_STATS``) into the user env, a
        serve replica's engine publishes into it, and the heartbeat
        loop piggybacks whatever appears there to the AM."""
        return self.log_dir / "serve-stats.json"

    def drain_file_path(self) -> Path:
        """The per-container drain flag: the executor exports this path
        (``TONY_DRAIN_FILE``) into the user env and CREATES the file when
        the AM's heartbeat reply carries the drain directive; train_loop
        polls for it between steps and exits EXIT_DRAINED after a
        synchronous commit. A file, not a signal: the user process may be
        several forks deep, and the drain must reach the training loop —
        not whatever shell happens to be the direct child."""
        return self.log_dir / "drain"

    def user_command(self) -> str:
        cmd = (self.conf.get(conf_mod.command_key(self.job_type))
               or self.conf.get("tony.application.executes"))
        if not cmd:
            raise RuntimeError(
                f"no command for task {self.job_type}:{self.index}: set "
                f"tony.application.executes or tony.{self.job_type}.command")
        return cmd

    def localize_src(self) -> Optional[Path]:
        """Per-container copy of the staged src dir (reference:
        ``LocalizableResource`` download into the container sandbox)."""
        if not self.src_dir or not Path(self.src_dir).is_dir():
            return None
        dest = Path.cwd() / "src"
        if not dest.exists():
            shutil.copytree(self.src_dir, dest)
        return dest

    def localize_venv(self) -> Optional[Path]:
        """Localize the staged venv (dir or archive) into the container
        sandbox (reference: the venv zip in the YARN LocalResource map)."""
        if not self.venv_path:
            return None
        src = Path(self.venv_path)
        dest = Path.cwd() / "venv"
        if dest.exists():
            return dest
        if src.is_dir():
            # link vs copy: see conf.VENV_LOCALIZATION — links alias the
            # staged inodes, so in-place writers must opt into "copy".
            mode = (self.conf.get(conf_mod.VENV_LOCALIZATION) or "link")
            if mode == "copy":
                shutil.copytree(src, dest, symlinks=True)
            else:
                _link_tree(src, dest, symlinks=True)
        elif src.is_file():
            shutil.unpack_archive(str(src), str(dest))
            # Archives often wrap a single top-level dir: flatten to it.
            entries = list(dest.iterdir())
            if len(entries) == 1 and entries[0].is_dir() \
                    and (entries[0] / "bin").is_dir():
                dest = entries[0]
        else:
            return None
        return dest

    def localize_resources(self, dest: Path) -> None:
        """Localize ``tony.containers.resources`` entries into the user
        process cwd (reference: the YARN ``LocalResource`` map built by
        ``Utils.uploadFileAndSetConfResources`` / ``LocalizableResource``).
        Entries are resolved by basename against the staged resources dir
        (``TONY_RESOURCES_DIR``) — the conf carries client-side staged
        paths that need not exist on a remote worker. ``#archive`` entries
        are unpacked in place of copied."""
        entries = self.conf.get_list(conf_mod.CONTAINERS_RESOURCES)
        for entry in entries:
            path_s, _, flag = entry.partition("#")
            name = Path(path_s).name
            src = (Path(self.resources_dir) / name if self.resources_dir
                   else Path(path_s))
            if not src.exists():
                raise RuntimeError(
                    f"container resource {name!r} not found "
                    f"(resources dir: {self.resources_dir})")
            # Resources OVERWRITE same-named files in the cwd: they
            # localize after the src copy, and a stale src-shipped file
            # silently shadowing the declared resource is the worse bug.
            target = dest / name
            if flag == "archive":
                shutil.unpack_archive(str(src), str(dest))
            elif src.is_dir():
                shutil.copytree(src, target, symlinks=True,
                                dirs_exist_ok=True)
            else:
                shutil.copy2(src, target)

    def _venv_env(self, venv: Optional[Path]) -> Dict[str, str]:
        """PATH/VIRTUAL_ENV entries so ``python`` in the user command
        resolves inside the shipped venv; ``tony.application.python-binary``
        (absolute, or relative to the venv) takes precedence."""
        out: Dict[str, str] = {}
        paths = []
        pybin = self.conf.get(conf_mod.PYTHON_BINARY)
        if pybin:
            p = Path(pybin)
            if not p.is_absolute() and venv is not None:
                p = venv / p
            paths.append(str(p.parent))
        if venv is not None:
            out["VIRTUAL_ENV"] = str(venv)
            paths.append(str(venv / "bin"))
        if paths:
            out["PATH"] = os.pathsep.join(
                paths + [os.environ.get("PATH", "")])
        return out

    def _heartbeat_loop(self, interval_s: float,
                        max_failures: int = 5) -> None:
        """Heartbeat to the AM; after ``max_failures`` CONSECUTIVE failed
        calls the AM is presumed dead and the user process is killed —
        the container-side half of AM-attempt restart (reference: the NM
        tears down containers when the application terminates). Without
        this, an AM crash would orphan executors training forever.

        Uses its own short-timeout RPC client: the shared ``self.client``
        retries transport errors internally for its full 30s window, which
        would stretch ``max_failures`` consecutive misses into minutes.

        When the job configures ``tony.ckpt.dir``, each heartbeat also
        carries the last COMMITTED checkpoint step found there (a cheap
        committed-dir scan — the manifest rename is the commit point, so
        listing is race-free): the AM logs per attempt what a gang restart
        will resume from. The scan must never sink liveness — any failure
        degrades to reporting nothing."""
        hb_client = RpcClient(self.am_address, token=self.token,
                              timeout=max(1.0, interval_s))
        ckpt_dir = self.conf.get(conf_mod.CKPT_DIR) or None
        serve_stats_path = self.serve_stats_path()
        drain_path = self.drain_file_path()

        def ckpt_step() -> Optional[int]:
            if not ckpt_dir:
                return None
            try:
                return latest_step(ckpt_dir)
            except Exception:   # noqa: BLE001 — advisory telemetry only
                return None

        def published() -> Optional[Dict[str, object]]:
            # Publication pointer announcement: the beat carries the ckpt
            # root's published.json version/step so the AM learns of a new
            # pointer from ANY gang member's heartbeat.
            rec = latest_publication(ckpt_dir) if ckpt_dir else None
            if rec is None:
                return None
            return {"version": rec["version"], "step": rec["step"]}

        failures = 0
        try:
            while not self._hb_stop.wait(interval_s):
                if chaos.drop_heartbeat():
                    # Injected silence: the AM sees missed heartbeats, the
                    # executor stays healthy — the lost-task path under test.
                    continue
                try:
                    step = ckpt_step()
                    serve = read_serve_stats(serve_stats_path) \
                        if serve_stats_path.is_file() else None
                    extras: Dict[str, object] = {}
                    if step is not None:
                        extras["ckpt_step"] = step
                    if serve is not None:
                        extras["serve"] = serve
                    pub = published()
                    if pub is not None:
                        extras["published"] = pub
                    resp = hb_client.call("heartbeat", job_type=self.job_type,
                                          index=self.index, **extras)
                    failures = 0
                    if isinstance(resp, dict) and resp.get("drain"):
                        try:
                            drain_path.touch()
                        except OSError:
                            pass  # retried on the next beat; never fatal
                    if self._am_lost and self.user_proc is None:
                        # The AM was only transiently unreachable (e.g. a
                        # relaunch window) and recovered before launch —
                        # un-stick the flag so run() doesn't abort a task
                        # whose AM is demonstrably alive again.
                        print("[tony-executor] AM reachable again before "
                              "launch; resuming", file=sys.stderr)
                        self._am_lost = False
                except Exception:
                    failures += 1
                    if failures < max_failures:
                        continue
                    if self._hb_stop.is_set():
                        return
                    if not self._am_lost:
                        print(f"[tony-executor] AM unreachable for "
                              f"{failures} heartbeats; terminating task",
                              file=sys.stderr)
                        self._am_lost = True
                    if self.user_proc is None:
                        # Not launched yet (gang barrier / localization):
                        # run() aborts before launch on _am_lost; keep
                        # polling in case the launch raced this check.
                        continue
                    self._kill_user_proc()
                    return
        finally:
            hb_client.close()

    def _kill_user_proc(self) -> None:
        """SIGKILL the user process TREE. The command runs via a shell
        that does not exec (dash keeps `sh -c` as the parent), and user
        code may fork — killing only the direct child leaves the real
        workload alive. The tree is walked via /proc rather than killpg:
        the user proc shares the executor's process group (the scheduler's
        teardown killpg depends on that), so a group kill would take the
        executor down with it."""
        if self.user_proc is None or self.user_proc.poll() is not None:
            return
        # Root FIRST: a supervising parent (e.g. a retry-loop shell) could
        # otherwise fork a replacement child between the /proc scan and
        # its own kill; dead parents can't respawn. A supervisor DEEPER in
        # the tree can still fork between the scan and its own kill, so
        # re-scan and sweep until no new live descendants appear (bounded:
        # each pass only finds children of processes killed in the prior
        # pass, so the tree depth bounds the real iteration count).
        root = self.user_proc.pid
        targets = [root] + _proc_descendants(root)
        killed: set = set()
        for _ in range(5):
            for pid in targets:
                try:
                    os.kill(pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                killed.add(pid)
            targets = [p for p in _proc_descendants(root) if p not in killed]
            if not targets:
                break

    def run(self) -> int:
        conf = self.conf
        # 1-2. reserve ports.
        rendezvous_sock = reserve_port()
        port = rendezvous_sock.getsockname()[1]
        adapter = self.framework.task_adapter()
        pre_ctx = TaskContext(conf=conf, job_type=self.job_type,
                              index=self.index, cluster_spec={},
                              am_address=self.am_address, app_id=self.app_id,
                              attempt_id=self.attempt_id)
        tb_sock = None
        tb_port = None
        if adapter.need_reserve_tb_port(pre_ctx):
            tb_sock = reserve_port()
            tb_port = tb_sock.getsockname()[1]
        # 3. register.
        self.client.call("register_worker_spec", job_type=self.job_type,
                         index=self.index, host=self.host, port=port)
        # 4. gang barrier.
        gang_timeout_s = conf.get_int(conf_mod.AM_GANG_TIMEOUT_MS, 120000) / 1e3
        deadline = time.monotonic() + gang_timeout_s
        hb_interval_s = conf.get_int(
            conf_mod.TASK_HEARTBEAT_INTERVAL_MS, 1000) / 1e3
        max_missed = self.conf.get_int(
            conf_mod.TASK_MAX_MISSED_HEARTBEATS, 25)
        hb_thread = threading.Thread(
            target=self._heartbeat_loop,
            args=(hb_interval_s, max(3, max_missed)),
            daemon=True, name="heartbeat")
        hb_thread.start()
        try:
            while True:
                # Clamp the RPC window to the barrier's remaining budget:
                # with the client's default 60s retry window, one call
                # begun just before the deadline could overshoot the gang
                # timeout by a full minute.
                remaining = max(0.5, deadline - time.monotonic())
                try:
                    resp = self.client.call("get_cluster_spec",
                                            _timeout=min(10.0, remaining))
                    last_err = None
                except (ConnectionError, OSError) as e:
                    resp, last_err = None, e  # transient; deadline decides
                if resp is not None and resp["complete"]:
                    cluster_spec = resp["spec"]
                    callback_info = resp.get("callback_info", {})
                    break
                if time.monotonic() > deadline:
                    cause = f"; last RPC error: {last_err}" if last_err \
                        else ""
                    print(f"[tony-executor] gang barrier timed out after "
                          f"{gang_timeout_s:.0f}s{cause}", file=sys.stderr)
                    return constants.EXIT_FAILURE
                time.sleep(0.1)
            # 5. build env + localize.
            ctx = TaskContext(conf=conf, job_type=self.job_type,
                              index=self.index, cluster_spec=cluster_spec,
                              am_address=self.am_address, app_id=self.app_id,
                              attempt_id=self.attempt_id, tb_port=tb_port,
                              callback_info=callback_info)
            adapter.validate(ctx)
            task_env = adapter.build_task_env(ctx)
            src = self.localize_src()
            cmd = self.user_command()
            env = dict(os.environ)
            env.update(self._venv_env(self.localize_venv()))
            env.update(task_env)
            env[constants.ENV_SERVE_STATS] = str(
                self.serve_stats_path().resolve())
            drain_path = self.drain_file_path()
            try:
                # Incremental-grant reuse relaunches into this same sandbox:
                # a drain flag left by the PREVIOUS drain must not instantly
                # drain the fresh worker.
                drain_path.unlink()
            except OSError:
                pass
            env[constants.ENV_DRAIN_FILE] = str(drain_path.resolve())
            if self.token:
                env[ENV_JOB_TOKEN] = self.token
            cwd = str(src) if src else os.getcwd()
            self.localize_resources(Path(cwd))
            pypath = [p for p in (cwd, env.get("PYTHONPATH")) if p]
            env["PYTHONPATH"] = os.pathsep.join(pypath)
            # 6. release reserved ports, launch the user process.
            if self._am_lost:
                # AM died while we were still in the barrier/localization
                # phase — launching now would create an unmonitored orphan.
                print("[tony-executor] AM lost before launch; aborting",
                      file=sys.stderr)
                return constants.EXIT_FAILURE
            rendezvous_sock.close()
            if tb_sock is not None:
                tb_sock.close()
            stdout = open(self.log_dir / constants.USER_STDOUT_NAME, "ab")
            stderr = open(self.log_dir / constants.USER_STDERR_NAME, "ab")
            # Stays in the executor's process group on purpose: the
            # scheduler's teardown killpg must keep reaping executor +
            # user tree together; the executor's own kills walk the tree
            # (see _kill_user_proc).
            self.user_proc = subprocess.Popen(
                cmd, shell=True, env=env, cwd=cwd,
                stdout=stdout, stderr=stderr)
            stdout.close()
            stderr.close()
            if tb_port is not None and self.job_type in (
                    constants.TENSORBOARD, constants.NOTEBOOK,
                    *constants.CHIEF_LIKE_JOB_TYPES):
                try:
                    self.client.call("register_tensorboard_url",
                                     url=f"http://{self.host}:{tb_port}")
                except Exception:
                    pass
            # 7. metrics monitor.
            metrics_interval_s = conf.get_int(
                conf_mod.TASK_METRICS_INTERVAL_MS, 5000) / 1e3
            monitor = TaskMonitor(self.user_proc.pid, self.client,
                                  self.job_type, self.index,
                                  metrics_interval_s)
            monitor.start()
            # 8. wait (with optional execution timeout), report, exit.
            timeout_ms = conf.get_int(
                conf_mod.TASK_EXECUTOR_EXECUTION_TIMEOUT_MS, 0)
            diagnostics = ""
            try:
                exit_code = self.user_proc.wait(
                    timeout=timeout_ms / 1e3 if timeout_ms else None)
            except subprocess.TimeoutExpired:
                self._kill_user_proc()
                self.user_proc.wait()
                exit_code = constants.EXIT_FAILURE
                diagnostics = f"execution timed out after {timeout_ms}ms"
            if self._am_lost and not diagnostics:
                diagnostics = "AM unreachable; task terminated by executor"
            monitor.stop()
            if self._am_lost:
                # The AM is gone — reporting would only burn the RPC
                # client's full retry window before failing anyway.
                print(f"[tony-executor] skipping result RPC: {diagnostics}",
                      file=sys.stderr)
                return exit_code
            try:
                self.client.call("register_execution_result",
                                 job_type=self.job_type, index=self.index,
                                 exit_code=exit_code, diagnostics=diagnostics)
            except Exception as e:
                print(f"[tony-executor] result RPC failed: {e}",
                      file=sys.stderr)
            return exit_code
        finally:
            self._hb_stop.set()
            # Bounded join so teardown is deterministic, not
            # daemon-abandoned: the loop's own RPC window is short
            # (timeout = heartbeat interval), so a live thread exits
            # within one wait tick; a wedged one is abandoned rather
            # than blocking executor exit.
            hb_thread.join(timeout=5.0)
            for s in (rendezvous_sock, tb_sock):
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
            self._kill_user_proc()
            self.client.close()


def main() -> int:
    try:
        executor = TaskExecutor()
    except Exception as e:  # bad env/conf: fail loudly before any RPC
        print(f"[tony-executor] bootstrap failed: {e}", file=sys.stderr)
        return constants.EXIT_FAILURE
    # Forward SIGTERM (scheduler stop) to the user process so it can die fast.
    def _on_term(signum, frame):
        executor._kill_user_proc()
        sys.exit(constants.EXIT_KILLED)
    signal.signal(signal.SIGTERM, _on_term)
    return executor.run()
