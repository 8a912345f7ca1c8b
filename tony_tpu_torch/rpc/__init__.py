"""Control-plane RPC wire: a copy of the transport of :mod:`tony_tpu.rpc`
(the port imports nothing of the JAX package).

Newline-delimited JSON over TCP, byte-compatible with the reference: one
request line ``{"method", "params"[, "token"]}``, one response line
``{"ok": true, "result"}`` or ``{"ok": false, "error"}``, so a JAX
:class:`tony_tpu.rpc.RpcClient` calls a port :class:`RpcServer` and the
reverse (``tests/test_torch_replica.py``). :class:`RpcServer` dispatches
``rpc_<method>`` callables on a handler object, one thread per
connection; :class:`RpcClient` keeps one connection, re-dialed with
bounded, jittered exponential backoff. The AM's verb set
(``ApplicationRpcHandler``) stays in the control plane: the port's
server fronts a serve replica (:mod:`tony_tpu_torch.serve.replica`).
"""

from __future__ import annotations

import json
import random
import socket
import socketserver
import threading
import time
from typing import Any, Callable, Optional

from tony_tpu_torch import chaos

__all__ = ["RpcClient", "RpcError", "RpcServer"]


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
    """

    def __init__(self, address: str, token: Optional[str] = None,
                 timeout: float = 30.0, retry_interval: float = 0.2):
        host, _, port = address.rpartition(":")
        self._addr = (host, int(port))
        self.token = token
        self.timeout = timeout
        self.retry_interval = retry_interval
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
