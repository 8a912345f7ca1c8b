"""Control-plane RPC wire: a copy of the transport of :mod:`tony_tpu.rpc`
(the port imports nothing of the JAX package).

Newline-delimited JSON over TCP, byte-compatible with the reference: one
request line ``{"method", "params"[, "token"]}``, one response line
``{"ok": true, "result"}`` or ``{"ok": false, "error"}``, so a JAX
:class:`tony_tpu.rpc.RpcClient` calls a port :class:`RpcServer` and the
reverse (``tests/test_torch_replica.py``). :class:`RpcServer` dispatches
``rpc_<method>`` callables on a handler object, one thread per
connection; :class:`RpcClient` keeps one connection, re-dialed with
bounded, jittered exponential backoff. The port's server fronts a serve
replica (:mod:`tony_tpu_torch.serve.replica`) and the port's AM, whose
verb set is :class:`ApplicationRpcHandler` (a copy of the reference's:
register_worker_spec, get_cluster_spec, heartbeat, register_execution_
result, register_tensorboard_url, register_callback_info,
metrics_report, get_task_infos, serve_endpoints, get_task_callback_info,
get_job_status, finish_application; the reference's ``resize`` verb
waits for elastic resize).

Security: when ``tony.security.enabled`` is true the client must present
the job token (shipped to executors in :data:`ENV_JOB_TOKEN`); a
mismatch is rejected before dispatch.
"""

from __future__ import annotations

import json
import random
import socket
import socketserver
import threading
import time
from typing import Any, Callable, Dict, Optional

from tony_tpu_torch import chaos

__all__ = ["ApplicationRpcHandler", "ENV_JOB_TOKEN", "RpcClient",
           "RpcError", "RpcServer"]

# Env var carrying the job token to executors (security.enabled only).
ENV_JOB_TOKEN = "TONY_JOB_TOKEN"

# Transport faults of RpcClient.call by method, over this process's
# life: a refused or dropped connection, a malformed reply line, or a
# reply slower than the client's wait for it. The call is sent again
# after each one until its retry window closes. The disaggregated serve
# path reports them (a kv_import sent again collides with its own first
# import, and the request falls back to colocated prefill).
RESENDS: Dict[str, int] = {}
_RESENDS_LOCK = threading.Lock()


class RpcError(Exception):
    """Remote call failed: transported application-level error."""


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        server: RpcServer = self.server  # type: ignore[assignment]
        while True:
            try:
                line = self.rfile.readline()
            except OSError:
                return
            if not line:
                return
            try:
                req = json.loads(line)
                method = req["method"]
                params = req.get("params") or {}
                if server.token and req.get("token") != server.token:
                    resp = {"ok": False, "error": "invalid job token"}
                else:
                    fn = server.lookup(method)
                    result = fn(**params)
                    resp = {"ok": True, "result": result}
            except RpcError as e:
                resp = {"ok": False, "error": str(e)}
            except Exception as e:  # noqa: BLE001 — transported to caller
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            try:
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
            except OSError:
                return


class RpcServer:
    """Threaded JSON-lines RPC server dispatching to ``rpc_<method>``
    callables on a handler object (reference: ``ApplicationRpcServer``)."""

    def __init__(self, handler: object, host: str = "0.0.0.0",
                 port: int = 0, token: Optional[str] = None):
        self._handler = handler
        self.token = token
        self._tcp = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=False)
        self._tcp.allow_reuse_address = True
        self._tcp.daemon_threads = True
        self._tcp.server_bind()
        self._tcp.server_activate()
        self.host, self.port = self._tcp.server_address[:2]
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, name="tony-rpc", daemon=True)

    # socketserver instantiates _Handler with the TCPServer as .server; give
    # that object the lookup/token surface _Handler expects.
    def start(self) -> "RpcServer":
        self._tcp.lookup = self.lookup          # type: ignore[attr-defined]
        self._tcp.token = self.token            # type: ignore[attr-defined]
        self._thread.start()
        return self

    @property
    def address(self) -> str:
        host = self.host if self.host != "0.0.0.0" else "127.0.0.1"
        return f"{host}:{self.port}"

    def lookup(self, method: str) -> Callable[..., Any]:
        fn = getattr(self._handler, f"rpc_{method}", None)
        if fn is None or not callable(fn):
            raise RpcError(f"unknown RPC method {method!r}")
        return fn

    def stop(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()
        self._thread.join(timeout=5)


class RpcClient:
    """Reconnecting JSON-lines RPC client (reference: ``ApplicationRpcClient``).

    One persistent connection, re-dialed on failure; every call retries
    transport errors up to ``timeout`` seconds with BOUNDED JITTERED
    exponential backoff (base ``retry_interval``, doubling to
    :data:`BACKOFF_CAP_S`, ×[0.5, 1.5) jitter) — executors come up before
    the AM socket is reachable in some orderings, and the reference's
    Hadoop RPC retries the same way. The jitter keeps a gang of
    executors whose AM hiccuped from re-dialing in lockstep; the cap
    keeps a long-timeout call responsive once the fault clears.

    ``reply_timeout`` is the wait for the reply once a request is on the
    wire (None: the per-operation cap, as the reference's client). A
    verb that replies when its work is done, such as a serve replica's
    ``generate``, sets it to the longest wait its caller accepts: a
    reply slower than the wait is a transport fault, and the call is
    sent again while the retry window is open.
    """

    def __init__(self, address: str, token: Optional[str] = None,
                 timeout: float = 30.0, retry_interval: float = 0.2,
                 reply_timeout: Optional[float] = None):
        host, _, port = address.rpartition(":")
        self._addr = (host, int(port))
        self.token = token
        self.timeout = timeout
        self.retry_interval = retry_interval
        self.reply_timeout = reply_timeout
        self._sock: Optional[socket.socket] = None
        self._file = None
        self._lock = threading.Lock()

    # Backoff ceiling for the transport-retry loop: delays double from
    # retry_interval up to this cap, so a transient fault early in a long
    # window is probed promptly while a dead AM is not hammered.
    BACKOFF_CAP_S = 2.0

    # Per-operation socket timeout cap. Individual connect/recv calls are
    # additionally capped by the client's own retry window so that a
    # short-timeout client (the executor's heartbeat probe) fails FAST when
    # the AM host is unreachable rather than refusing — an unreachable host
    # blackholes SYNs and a bare connect would block the full 10s.
    SOCKET_TIMEOUT_S = 10.0

    @classmethod
    def _per_op(cls, timeout: float) -> float:
        """Single-op (connect/recv) cap for a call with this retry window
        — THE one definition; worst_case_call_s/_connect/call all use it."""
        return min(cls.SOCKET_TIMEOUT_S, max(0.1, timeout))

    @classmethod
    def worst_case_call_s(cls, timeout: float) -> float:
        """Upper bound on one :meth:`call`'s wall time: the retry window,
        plus one last attempt begun just before the deadline that blocks
        for a full socket connect + recv. The client's AM-relaunch grace
        is derived from this."""
        return timeout + 2.0 * cls._per_op(timeout)

    def _connect(self, per_op: Optional[float] = None) -> None:
        """(Re)dial. Caller holds ``self._lock`` (``call`` does)."""
        self._close_locked()
        if per_op is None:
            per_op = self._per_op(self.timeout)
        self._sock = socket.create_connection(self._addr, timeout=per_op)
        self._file = self._sock.makefile("rwb")

    def call(self, method: str, _timeout: Optional[float] = None,
             **params: Any) -> Any:
        """Invoke ``method`` remotely; retries transport errors until
        ``timeout`` (``_timeout`` overrides per call — deadline-driven
        loops like the executor's gang barrier must not block a full
        default window past their own deadline), raises :class:`RpcError`
        on application errors."""
        if any(k.startswith("_") for k in params):
            # "_"-prefixed kwargs are reserved for client-side options
            # (today: _timeout). Without this guard an RPC param named
            # _timeout would silently become the deadline override — and,
            # conversely, this line is where a future _retries/_trace
            # option is protected from leaking onto the wire.
            raise TypeError(
                f"reserved client-option name(s) in RPC params: "
                f"{sorted(k for k in params if k.startswith('_'))}")
        req = {"method": method, "params": params}
        if self.token:
            req["token"] = self.token
        payload = (json.dumps(req) + "\n").encode()
        effective = self.timeout if _timeout is None else _timeout
        per_op = self._per_op(effective)
        chaos.rpc_delay()
        deadline = time.monotonic() + effective
        last_err: Optional[Exception] = None
        attempt = 0
        while time.monotonic() < deadline:
            try:
                with self._lock:
                    if self._file is None:
                        self._connect(per_op)
                    elif self._sock is not None:
                        # Re-arm the per-op cap: a persistent connection
                        # keeps the timeout of the call that dialed it.
                        self._sock.settimeout(per_op)
                    assert self._file is not None
                    self._file.write(payload)
                    self._file.flush()
                    if self.reply_timeout is not None \
                            and self._sock is not None:
                        self._sock.settimeout(self.reply_timeout)
                    line = self._file.readline()
                if not line:
                    raise ConnectionError("server closed connection")
                resp = json.loads(line)
                if resp.get("ok"):
                    return resp.get("result")
                raise RpcError(resp.get("error", "unknown remote error"))
            except RpcError:
                raise
            except (OSError, ValueError, ConnectionError) as e:
                last_err = e
                with _RESENDS_LOCK:
                    RESENDS[method] = RESENDS.get(method, 0) + 1
                with self._lock:
                    self._close_locked()
                delay = min(self.retry_interval * (2.0 ** attempt),
                            self.BACKOFF_CAP_S)
                delay *= 0.5 + random.random()  # jitter in [0.5x, 1.5x)
                # Never sleep past the deadline — the loop guard would
                # otherwise charge the overshoot to the caller's budget.
                delay = min(delay, max(0.0, deadline - time.monotonic()))
                attempt += 1
                if delay > 0:
                    time.sleep(delay)
        raise ConnectionError(
            f"RPC {method} to {self._addr} failed after {effective}s: "
            f"{last_err}")

    def _close_locked(self) -> None:
        """Tear down the connection. Caller holds ``self._lock``."""
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        # Under the lock: teardown (executor finally, __exit__) races a
        # sharer mid-call — the TaskMonitor thread and the executor main
        # thread share one client — and nulling _file under a writer was
        # an AttributeError crash, not a clean ConnectionError retry
        # (found by the concurrency audit; call() already serializes all
        # connection use on this lock).
        with self._lock:
            self._close_locked()

    def __enter__(self) -> "RpcClient":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


class ApplicationRpcHandler:
    """Server-side verb set bridging RPC to a :class:`TonySession` — the
    reference's ``ApplicationRpc`` service implementation living inside the
    AM (``TonyApplicationMaster`` implements these verbs against its session).

    The AM subclasses/owns this and may hook extra behavior (events, adapter
    callbacks) via the ``on_*`` callback slots.
    """

    def __init__(self, session):
        self.session = session
        self.callback_info: Dict[str, str] = {}
        self.on_registered: Optional[Callable[[str, int], None]] = None
        self.on_result: Optional[Callable[[str, int, int, str], None]] = None
        self.on_all_registered: Optional[Callable[[], None]] = None
        self.on_metrics: Optional[Callable[[str, int, Dict[str, float]],
                                           None]] = None
        self.on_callback_info: Optional[Callable[[str, str], None]] = None
        self._all_registered_fired = False
        self._fire_lock = threading.Lock()

    def reset(self, session) -> None:
        """Point the handler at a fresh session (AM gang restart: the RPC
        server survives across attempts, the session does not)."""
        with self._fire_lock:
            self.session = session
            self.callback_info = {}
            self._all_registered_fired = False

    # -- executor-facing verbs --------------------------------------------
    def rpc_register_worker_spec(self, job_type: str, index: int,
                                 host: str, port: int) -> Dict[str, Any]:
        self.session.on_registered(job_type, index, host, port)
        if self.on_registered:
            self.on_registered(job_type, index)
        if self.session.all_registered():
            # The once-only adapter callback runs under the lock BEFORE the
            # barrier becomes visible to get_cluster_spec, so no executor can
            # observe a complete spec with missing callback_info. A second
            # pass (executor relaunch after preemption) re-marks RUNNING but
            # does not re-fire the adapter.
            with self._fire_lock:
                if not self._all_registered_fired:
                    if self.on_all_registered:
                        self.on_all_registered()
                    self._all_registered_fired = True
            self.session.on_running()
        return {"task_id": f"{job_type}:{index}"}

    def rpc_get_cluster_spec(self) -> Dict[str, Any]:
        complete = self._all_registered_fired and self.session.all_registered()
        return {
            "complete": complete,
            "spec": self.session.cluster_spec() if complete else {},
            "callback_info": dict(self.callback_info),
        }

    def rpc_heartbeat(self, job_type: str, index: int,
                      ckpt_step: Optional[int] = None,
                      serve: Optional[Dict[str, float]] = None,
                      published: Optional[Dict[str, int]] = None) -> Any:
        """Liveness + checkpoint progress + serving telemetry: executors
        that see a ``tony.ckpt.dir`` piggyback the last COMMITTED step;
        serve-replica executors piggyback the engine's published
        qps/p99_ms/queue_depth (the autoscaler's signal). Both params
        optional — seed-era executors send neither. ``published`` is the
        ckpt root's publication pointer the executor's heartbeat carries
        (the reference's verb lacks the parameter its own executor sends,
        so there such a beat is an application error; here it is
        recorded on the task).

        Returns bare ``True`` normally; when an elastic resize has the
        gang draining, returns ``{"ok": True, "drain": True}`` so the
        executor can relay the drain directive to its user process (the
        asymmetry keeps seed-era executors, which only truth-test the
        reply, working unchanged)."""
        self.session.on_heartbeat(job_type, index, ckpt_step=ckpt_step,
                                  serve=serve, published=published)
        if self.session.drain_pending(job_type, index):
            return {"ok": True, "drain": True}
        return True

    def rpc_register_execution_result(self, job_type: str, index: int,
                                      exit_code: int,
                                      diagnostics: str = "") -> bool:
        self.session.on_task_result(job_type, index, exit_code, diagnostics)
        if self.on_result:
            self.on_result(job_type, index, exit_code, diagnostics)
        return True

    def rpc_register_tensorboard_url(self, url: str) -> bool:
        self.session.tensorboard_url = url
        return True

    def rpc_register_callback_info(self, task_id: str, payload: str) -> bool:
        """Executor-pushed framework info (reference: registerCallbackInfo
        feeding Framework.ApplicationMasterAdapter.receiveTaskCallbackInfo).
        Recorded on the session and dispatched to the AM adapter hook."""
        self.session.task_callback_info[task_id] = payload
        if self.on_callback_info:
            self.on_callback_info(task_id, payload)
        return True

    def rpc_metrics_report(self, job_type: str, index: int,
                           metrics: Dict[str, float]) -> bool:
        task = self.session.task(job_type, index)
        sample = task.record_metrics(metrics)
        if self.on_metrics:
            # The sample, not the cumulative dict: a TASK_METRICS event is
            # one TaskMonitor reading, and stale keys must not reappear
            # with fresh timestamps in the portal timeline.
            self.on_metrics(job_type, index, sample)
        return True

    # -- client-facing verbs ----------------------------------------------
    def rpc_get_task_infos(self) -> list:
        return self.session.task_infos()

    def rpc_serve_endpoints(self, job_type: Optional[str] = None) -> list:
        """The routable replica set (the reference's serve.router): serving
        tasks with reported telemetry, in task_infos wire form — the
        router derives each live replica's dial address from
        ``host`` + the heartbeat-carried ``rpc_port`` and retires
        terminal entries. Default spans EVERY serve-role jobtype (the
        disaggregated prefill/decode gangs included); pass a jobtype to
        scope."""
        return self.session.serve_endpoints(job_type)

    def rpc_get_task_callback_info(self) -> Dict[str, str]:
        """The per-task pushed callback payloads (e.g. profiler endpoints) —
        consumed by ``tony profile`` to find live trace servers."""
        return dict(self.session.task_callback_info)

    def rpc_get_job_status(self) -> Dict[str, Any]:
        return {
            "status": self.session.job_status.value,
            "message": self.session.final_message,
            "attempt_id": self.session.attempt_id,
            "tensorboard_url": self.session.tensorboard_url,
            "all_running_latency_s": self.session.all_running_latency_s,
        }

    def rpc_finish_application(self, reason: str = "killed by client") -> bool:
        from tony_tpu_torch.session import JobStatus
        with self.session.lock:
            if self.session.job_status == JobStatus.RUNNING:
                self.session.job_status = JobStatus.KILLED
                self.session.final_message = reason
        self.session.kill_remaining(reason)
        return True
