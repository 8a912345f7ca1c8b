"""Container scheduling substrate: the YARN-RM/NM replacement (layer L0),
the port's copy of :mod:`tony_tpu.scheduler` with GPU accounting.

The reference delegates this layer entirely to Hadoop YARN (SURVEY.md §1 L0);
the AM asks the RM for containers sized ``{memory, vcores, gpus}`` and the NM
launches ``TaskExecutor`` JVMs. Here the same two verbs — allocate/launch and
reap — sit behind :class:`ContainerScheduler`, with two backends:

* :class:`LocalProcessScheduler` — containers are local subprocesses running
  ``python -S -m tony_tpu_torch.executor``: the MiniPod test substrate and
  the single-host path on one GPU machine. ``gpus`` asks are accounted
  against ``total_gpus`` (the GPU census or ``tony.scheduler.total-gpus``):
  an over-ask fails at launch, and a container's cards come back when it
  ends.
* :class:`SshScheduler` — the multi-host backend (the original's
  ``TpuVmScheduler``, renamed: its hosts are GPU machines, and the conf
  names it ``tony.scheduler.backend=ssh``): the same interface, executors
  launched on remote hosts over SSH, ``host_gpus`` cards accounted per
  host.

The executor then pins each task's cards with ``CUDA_VISIBLE_DEVICES``
(:mod:`tony_tpu_torch.runtime.pytorch_runtime`). Preemption is a
first-class verb (``preempt``) because the reference's failure machinery
distinguishes preempted containers (re-request) from crashed ones
(fail-fast) — SURVEY.md §3.3. Docker wrapping is not in the port
(ROADMAP queue 1, item 10). Standard library only.
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from tony_tpu_torch import constants
from tony_tpu_torch import conf as conf_mod
from tony_tpu_torch.util import child_pythonpath, control_plane_site_env

EXECUTOR_MODULE = "tony_tpu_torch.executor"


@dataclass
class ContainerLaunch:
    """One container ask: which task, with what env (reference: the
    ``ContainerLaunchContext`` the AM builds per matched allocation)."""
    job_type: str
    index: int
    env: Dict[str, str]
    memory_mb: int = 1024
    vcores: int = 1
    gpus: int = 0


@dataclass
class Container:
    """A granted container and its lifecycle (reference: YARN ``Container`` +
    completion status)."""
    container_id: str
    job_type: str
    index: int
    host: str
    exit_code: Optional[int] = None
    preempted: bool = False
    _proc: Optional[subprocess.Popen] = field(default=None, repr=False)

    @property
    def is_running(self) -> bool:
        return self.exit_code is None


class ContainerScheduler:
    """Substrate SPI: allocate-and-launch, reap, kill, preempt."""

    def launch(self, launch: ContainerLaunch) -> Container:
        raise NotImplementedError

    def poll_completed(self) -> List[Container]:
        """Containers that exited since the last poll (reference:
        ``onContainersCompleted``)."""
        raise NotImplementedError

    def stop_container(self, container: Container) -> None:
        raise NotImplementedError

    def preempt(self, container_id: str) -> bool:
        """Simulate/execute a scheduler preemption: the container dies and is
        reported with ``preempted=True`` (reference: YARN exit status
        ``PREEMPTED``). Returns False if the container is not running."""
        raise NotImplementedError

    def stop(self, drain_s: float = 5.0) -> None:
        """Tear down everything still running, then drain completions."""
        for c in self._live_containers():
            self.stop_container(c)
        deadline = time.monotonic() + drain_s
        while self._live_containers() and time.monotonic() < deadline:
            self.poll_completed()
            time.sleep(0.05)

    def _live_containers(self) -> List["Container"]:
        raise NotImplementedError


class LocalProcessScheduler(ContainerScheduler):
    """Containers as local subprocesses (MiniYARNCluster analogue).

    Each container gets a working directory ``<job_dir>/containers/<cid>``
    and its executor stdout/stderr tee into ``executor.log`` there. Resource
    numbers (memory/vcores) are recorded, not enforced — exactly like
    MiniYARNCluster's default; ``gpus`` asks are validated against
    ``total_gpus`` so over-subscription fails at launch, mirroring an RM
    rejecting an unsatisfiable resource ask, and a container's cards are
    released when it ends.
    """

    def __init__(self, job_dir: str | Path, host: str = "127.0.0.1",
                 total_gpus: int = 0, conf=None):
        self.job_dir = Path(job_dir)
        self.host = host
        self.conf = conf
        self.total_gpus = total_gpus          # 0 = unlimited (no GPU asks)
        self._gpus_in_use = 0
        self._lock = threading.Lock()
        self._running: Dict[str, Container] = {}
        self._next_id = 0

    def _new_cid(self) -> str:
        with self._lock:
            self._next_id += 1
            return f"container_{os.getpid()}_{self._next_id:04d}"

    def launch(self, launch: ContainerLaunch) -> Container:
        gpus = launch.gpus if self.total_gpus else 0
        if gpus:
            with self._lock:
                if self._gpus_in_use + gpus > self.total_gpus:
                    raise RuntimeError(
                        f"unsatisfiable gpu ask: {gpus} requested, "
                        f"{self.total_gpus - self._gpus_in_use} free")
                self._gpus_in_use += gpus
        try:
            cid = self._new_cid()
            workdir = self.job_dir / "containers" / cid
            workdir.mkdir(parents=True, exist_ok=True)
            log = open(workdir / constants.EXECUTOR_LOG_NAME, "ab")
            # Curated task env (the YARN launch-context analogue): what the
            # executor needs, on top of the host environ it inherits.
            env = dict(os.environ)
            env.update(launch.env)
            env[constants.ENV_CONTAINER_ID] = cid
            env.setdefault(constants.ENV_LOG_DIR, str(workdir))
            env["TONY_EXECUTOR_HOST"] = self.host
            env["PYTHONPATH"] = child_pythonpath(env)
            # -S: the executor is stdlib-only control plane; the USER
            # process it spawns runs plain python with the full site. Site
            # dirs for the executor's own lazy imports travel via
            # TONY_SITE_DIRS (util.restore_site_dirs).
            env.update(control_plane_site_env())
            proc = subprocess.Popen(
                [sys.executable, "-S", "-m", EXECUTOR_MODULE], env=env,
                cwd=workdir, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)
            log.close()
        except Exception:
            # Give the cards back: the scheduler outlives attempts, and a
            # failed launch must not hold them for the next one.
            with self._lock:
                self._gpus_in_use -= gpus
            raise
        c = Container(container_id=cid, job_type=launch.job_type,
                      index=launch.index, host=self.host, _proc=proc)
        c._gpus = gpus  # type: ignore[attr-defined]
        with self._lock:
            self._running[cid] = c
        return c

    @property
    def gpus_in_use(self) -> int:
        with self._lock:
            return self._gpus_in_use

    def poll_completed(self) -> List[Container]:
        done = []
        with self._lock:
            for cid, c in list(self._running.items()):
                rc = c._proc.poll() if c._proc else -1
                if rc is not None:
                    c.exit_code = (constants.EXIT_PREEMPTED if c.preempted
                                   else rc)
                    self._gpus_in_use -= getattr(c, "_gpus", 0)
                    del self._running[cid]
                    done.append(c)
        return done

    def stop_container(self, container: Container) -> None:
        with self._lock:
            c = self._running.get(container.container_id)
        if c is not None and c._proc is not None and c._proc.poll() is None:
            # Kill the whole process group: executor + its user child.
            try:
                os.killpg(c._proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    def preempt(self, container_id: str) -> bool:
        with self._lock:
            c = self._running.get(container_id)
        if c is None or c._proc is None or c._proc.poll() is not None:
            return False
        c.preempted = True
        try:
            os.killpg(c._proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            return False
        return True

    def running(self) -> List[Container]:
        with self._lock:
            return list(self._running.values())

    _live_containers = running


def scheduler_from_conf(conf, job_dir: str | Path,
                        host: str = "127.0.0.1") -> ContainerScheduler:
    """Build the substrate the config names (reference: the RM is chosen by
    the cluster, not the job; here ``tony.scheduler.backend`` picks
    ``local`` (default) or ``ssh``). ``tony.application.node-blacklist``
    hosts are excluded from placement — the reference's blacklist semantics
    applied at scheduler level."""
    backend = conf.get(conf_mod.SCHEDULER_BACKEND, "local")
    blacklist = set(conf.get_list(conf_mod.APPLICATION_NODE_BLACKLIST))
    if backend == "ssh":
        hosts = [h for h in conf.get_list("tony.scheduler.hosts")
                 if h not in blacklist]
        if not hosts:
            raise ValueError(
                "tony.scheduler.backend=ssh needs tony.scheduler.hosts "
                "(after node-blacklist filtering)")
        return SshScheduler(
            hosts,
            ssh_cmd=conf.get("tony.scheduler.ssh-command", "ssh"),
            remote_python=conf.get("tony.scheduler.remote-python", "python3"),
            remote_workdir=conf.get("tony.scheduler.remote-workdir",
                                    "/tmp/tony-tpu"),
            remote_pythonpath=conf.get("tony.scheduler.remote-pythonpath")
            or None,
            host_gpus=conf.get_int(conf_mod.SCHEDULER_HOST_GPUS, 0))
    if backend == "tpu-vm":
        raise ValueError(
            "tony.scheduler.backend=tpu-vm names a TPU-VM pod slice; the "
            "port's multi-host backend is tony.scheduler.backend=ssh")
    if backend != "local":
        raise ValueError(f"unknown tony.scheduler.backend={backend!r}")
    return None  # caller builds LocalProcessScheduler with its own args


class SshScheduler(ContainerScheduler):
    """Multi-host backend: one executor per remote GPU host via SSH (the
    original's ``TpuVmScheduler``).

    ``hosts`` lists host addresses; the executor env rides the SSH
    command line; completion is detected by the remote shell exiting with
    the executor's code.

    Remote lifecycle: each launch runs the executor under ``setsid`` with
    its pid written to ``pids/<cid>.pid`` on the host, so kill/preempt can
    reach the *remote process group* (executor + user child) over a second
    SSH exec — terminating only the local SSH client would orphan them.

    Placement: when ``host_gpus`` is set, each host carries that many cards
    and tasks are placed least-loaded-first so card asks never
    oversubscribe a host; with no card asks, placement balances running
    task count. The executor pins each task's cards on its host.
    """

    def __init__(self, hosts: List[str], ssh_cmd: str = "ssh",
                 remote_python: str = "python3",
                 remote_workdir: str = "/tmp/tony-tpu",
                 remote_pythonpath: Optional[str] = None,
                 host_gpus: int = 0):
        if not hosts:
            raise ValueError("SshScheduler requires at least one host")
        self.hosts = list(hosts)
        self.ssh_cmd = ssh_cmd
        self.remote_python = remote_python
        self.remote_workdir = remote_workdir
        self.remote_pythonpath = remote_pythonpath  # None = pip-installed
        self.host_gpus = host_gpus                  # cards per host; 0 = off
        self._host_cards: Dict[str, int] = {h: 0 for h in self.hosts}
        self._host_tasks: Dict[str, int] = {h: 0 for h in self.hosts}
        self._running: Dict[str, Container] = {}
        self._lock = threading.Lock()
        self._stage_lock = threading.Lock()      # guards the lock table
        self._host_stage_locks: Dict[str, threading.Lock] = {}
        self._next_id = 0
        self._staged_hosts: set = set()

    def _ssh_argv(self, host: str, remote_sh: str) -> List[str]:
        """argv for one remote exec; ``ssh_cmd`` may carry flags
        (``ssh -i key``) or be a local shim script (tests)."""
        return shlex.split(self.ssh_cmd) + [host, remote_sh]

    def build_stage_command(self, local_dir: str, host: str,
                            remote_subdir: str, items: str = ".") -> str:
        """Shell pipeline staging a local dir (or named items within it)
        onto the worker (the HDFS localization analogue for the SSH
        substrate): tar stream over ssh — no temp files, one round trip."""
        dest = f"{self.remote_workdir}/{remote_subdir}"
        return (f"tar -C {shlex.quote(local_dir)} -cf - {items} | "
                f"{self.ssh_cmd} {host} "
                f"{shlex.quote(f'mkdir -p {dest} && tar -xf - -C {dest}')}")

    def build_remote_command(self, launch: ContainerLaunch, host: str,
                             cid: str = "adhoc") -> List[str]:
        """The SSH argv for one executor launch (separated for testability:
        command construction is covered by unit tests, the network is not).
        Paths in the env that point at client-side staging (conf, src,
        venv) are rewritten to the worker-side copies laid down by
        :meth:`build_stage_command`."""
        env = {**launch.env, "TONY_EXECUTOR_HOST": host}
        wd = self.remote_workdir
        if constants.ENV_CONF_PATH in env:
            env[constants.ENV_CONF_PATH] = (
                f"{wd}/conf/{constants.TONY_JOB_JSON}")
        if constants.ENV_SRC_DIR in env:
            env[constants.ENV_SRC_DIR] = f"{wd}/src"
        if constants.ENV_RESOURCES_DIR in env:
            env[constants.ENV_RESOURCES_DIR] = f"{wd}/resources"
        venv = env.get(constants.ENV_VENV)
        if venv:
            # Archives stage as the file itself; dirs stage as contents.
            if Path(venv).is_file():
                env[constants.ENV_VENV] = (
                    f"{wd}/venv-stage/{Path(venv).name}")
            else:
                env[constants.ENV_VENV] = f"{wd}/venv-stage"
        if self.remote_pythonpath:
            env["PYTHONPATH"] = self.remote_pythonpath
        # -S latency cut only when the package arrives via
        # remote_pythonpath; a pip-installed remote (remote_pythonpath=None)
        # NEEDS the site import to find it at all. Remote site dirs are
        # unknown here, so no TONY_SITE_DIRS.
        interp_flags = " -S" if self.remote_pythonpath else ""
        exports = " ".join(
            f"export {k}={shlex.quote(v)};" for k, v in sorted(env.items()))
        # setsid: the executor becomes leader of a fresh process group whose
        # pgid == its pid, so `kill -- -$(cat pidfile)` reaps it AND the
        # user process it spawned; `wait` propagates the executor's exit
        # code (or 128+SIG after a remote kill) back through ssh.
        remote = (
            f"mkdir -p {wd}/pids && cd {wd} || exit 1; {exports} "
            f"setsid {self.remote_python}{interp_flags} -m {EXECUTOR_MODULE} "
            f"< /dev/null & pid=$!; echo $pid > pids/{cid}.pid; "
            f"wait $pid; rc=$?; rm -f pids/{cid}.pid; exit $rc")
        return self._ssh_argv(host, remote)

    def _host_for(self, launch: ContainerLaunch) -> str:
        """Least-loaded placement with per-host card accounting (reference:
        the RM matching a resource ask to a node with capacity)."""
        with self._lock:
            if launch.gpus and self.host_gpus:
                if launch.gpus > self.host_gpus:
                    raise RuntimeError(
                        f"unsatisfiable gpu ask: task wants {launch.gpus} "
                        f"cards but hosts have {self.host_gpus}")
                fits = [h for h in self.hosts
                        if self._host_cards[h] + launch.gpus <= self.host_gpus]
                if not fits:
                    raise RuntimeError(
                        f"unsatisfiable gpu ask: {launch.gpus} cards "
                        f"requested, per-host free: "
                        f"{ {h: self.host_gpus - self._host_cards[h] for h in self.hosts} }")
                host = min(fits, key=lambda h: (self._host_cards[h],
                                                self._host_tasks[h]))
                self._host_cards[host] += launch.gpus
            else:
                host = min(self.hosts, key=lambda h: self._host_tasks[h])
            self._host_tasks[host] += 1
        return host

    def _stage(self, local: str, host: str, subdir: str,
               items: str = ".") -> None:
        cmd = self.build_stage_command(local, host, subdir, items=items)
        proc = subprocess.run(cmd, shell=True, timeout=300,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"staging {local} -> {host}:{self.remote_workdir}/{subdir} "
                f"failed (rc={proc.returncode}): {proc.stderr[-500:]}")

    def _host_stage_lock(self, host: str) -> "threading.Lock":
        with self._stage_lock:
            return self._host_stage_locks.setdefault(host, threading.Lock())

    def _stage_once(self, launch: ContainerLaunch, host: str) -> None:
        """Stage conf + src + venv onto the worker the first time it's
        used. The host is marked staged only after every transfer succeeds;
        a failure raises so the launch (and the job) fails loudly instead
        of executors dying later on a missing-conf error. Serialized PER
        HOST (not globally): the AM launches a gang concurrently, and one
        global lock would make first-time staging to N hosts O(N) in
        transfer time — the exact latency the concurrent launches exist
        to remove."""
        with self._host_stage_lock(host):
            if host in self._staged_hosts:
                return
            conf_path = launch.env.get(constants.ENV_CONF_PATH)
            if conf_path and Path(conf_path).is_file():
                self._stage(str(Path(conf_path).parent), host, "conf",
                            items=Path(conf_path).name)
            src_dir = launch.env.get(constants.ENV_SRC_DIR)
            if src_dir and Path(src_dir).is_dir():
                self._stage(src_dir, host, "src")
            venv = launch.env.get(constants.ENV_VENV)
            if venv and Path(venv).is_file():
                self._stage(str(Path(venv).parent), host, "venv-stage",
                            items=Path(venv).name)
            elif venv and Path(venv).is_dir():
                self._stage(venv, host, "venv-stage")
            res_dir = launch.env.get(constants.ENV_RESOURCES_DIR)
            if res_dir and Path(res_dir).is_dir():
                self._stage(res_dir, host, "resources")
            self._staged_hosts.add(host)

    def launch(self, launch: ContainerLaunch) -> Container:
        host = self._host_for(launch)
        with self._lock:
            self._next_id += 1
            cid = f"container_ssh_{self._next_id:04d}"
        try:
            self._stage_once(launch, host)
            proc = subprocess.Popen(
                self.build_remote_command(launch, host, cid=cid),
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                start_new_session=True)
        except Exception:
            # Release the accounting or gang-restart retries would see the
            # cards as permanently occupied (the scheduler outlives attempts).
            self._release_host(host, launch.gpus)
            raise
        c = Container(container_id=cid, job_type=launch.job_type,
                      index=launch.index, host=host, _proc=proc)
        c._gpus = launch.gpus  # type: ignore[attr-defined]
        with self._lock:
            self._running[cid] = c
        return c

    def _release_host(self, host: str, gpus: int) -> None:
        with self._lock:
            if self.host_gpus and gpus:
                self._host_cards[host] -= gpus
            self._host_tasks[host] -= 1

    def poll_completed(self) -> List[Container]:
        done = []
        with self._lock:
            for cid, c in list(self._running.items()):
                rc = c._proc.poll() if c._proc else -1
                if rc is not None:
                    c.exit_code = (constants.EXIT_PREEMPTED if c.preempted
                                   else rc)
                    if self.host_gpus and getattr(c, "_gpus", 0):
                        self._host_cards[c.host] -= c._gpus
                    self._host_tasks[c.host] -= 1
                    del self._running[cid]
                    done.append(c)
        return done

    def _remote_kill(self, c: Container, sig: str = "KILL") -> bool:
        """Kill the remote executor's whole process group via its pidfile
        (second ssh exec). Returns True when the remote kill ran."""
        pidfile = f"{self.remote_workdir}/pids/{c.container_id}.pid"
        # `kill -s SIG -- -pgid`: the only group-kill spelling both dash
        # and bash builtins accept (`kill -SIG -- -pgid` is rejected by
        # dash, the default /bin/sh on debian-family images). The
        # pidfile is removed here, not only by the launch shell's cleanup —
        # the local ssh client may be torn down before that cleanup runs.
        sh = (f"[ -f {pidfile} ] && pid=$(cat {pidfile}) && "
              f"rm -f {pidfile} && kill -s {sig} -- -$pid 2>/dev/null")
        try:
            proc = subprocess.run(self._ssh_argv(c.host, sh), timeout=30,
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL)
            return proc.returncode == 0
        except (subprocess.TimeoutExpired, OSError):
            return False

    def stop_container(self, container: Container) -> None:
        with self._lock:
            c = self._running.get(container.container_id)
        if c is not None and c._proc is not None and c._proc.poll() is None:
            if not self._remote_kill(c):
                # Remote side unreachable (or already gone): at least drop
                # the local ssh client so the AM's teardown completes.
                try:
                    c._proc.terminate()
                except OSError:
                    pass

    def preempt(self, container_id: str) -> bool:
        with self._lock:
            c = self._running.get(container_id)
        if c is None or c._proc is None or c._proc.poll() is not None:
            return False
        c.preempted = True
        if not self._remote_kill(c):
            c._proc.kill()
        return True

    def _live_containers(self) -> List[Container]:
        with self._lock:
            return list(self._running.values())

    def stop(self, drain_s: float = 10.0) -> None:
        super().stop(drain_s)
