"""Scripted faults for the port's train loop, publication, serve replica
and RPC client: a copy of the part of :mod:`tony_tpu.chaos` that
:func:`tony_tpu_torch.train.train_loop`, :mod:`tony_tpu_torch.publish`,
:meth:`tony_tpu_torch.serve.replica.Replica.hot_swap`,
:class:`tony_tpu_torch.rpc.RpcClient`, the control plane's event log and
the executor's heartbeat consult.

``TONY_CHAOS_KILL_STEP=k`` SIGKILLs this process as training step ``k``
completes, the same env the control plane's chaos harness arms for the
JAX package's loop; ``TONY_CHAOS_CRASH=<site>`` SIGKILLs it at the named
crash site (:func:`crash_point`). A malformed step raises
``ValueError``: a typoed fault schedule must not turn a chaos test into a
vacuous pass. ``TONY_CHAOS_HB_DROP=n`` swallows the executor's first
``n`` heartbeat sends (:func:`drop_heartbeat`): a flaky window that must
not mark a healthy task lost. ``TONY_CHAOS_RPC_DELAY_S=s`` stalls the first
``TONY_CHAOS_RPC_DELAY_CALLS`` (default 1) RPC calls by ``s`` seconds
(:func:`rpc_delay`). In-process tests set ``KILL_HOOK``/``CRASH_HOOK`` to
observe the fault instead of receiving SIGKILL and ``SLEEP_HOOK`` to
replace the delay's sleep, and call :func:`reset` after.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Callable, Dict, Optional

ENV_KILL_STEP = "TONY_CHAOS_KILL_STEP"
ENV_HB_DROP = "TONY_CHAOS_HB_DROP"
ENV_RPC_DELAY_S = "TONY_CHAOS_RPC_DELAY_S"
ENV_RPC_DELAY_CALLS = "TONY_CHAOS_RPC_DELAY_CALLS"
ENV_CRASH = "TONY_CHAOS_CRASH"

# When set, called with the step (the site, the delay) INSTEAD of
# delivering SIGKILL (sleeping).
KILL_HOOK: Optional[Callable[[int], None]] = None
CRASH_HOOK: Optional[Callable[[str], None]] = None
SLEEP_HOOK: Optional[Callable[[float], None]] = None

_lock = threading.Lock()    # guards _counters (probe sites span threads)
_counters: Dict[str, int] = {}


def reset() -> None:
    """Disarm the test hooks and clear the "first n" schedule counters
    (test epilogue)."""
    global KILL_HOOK, CRASH_HOOK, SLEEP_HOOK
    KILL_HOOK = None
    CRASH_HOOK = None
    SLEEP_HOOK = None
    with _lock:
        _counters.clear()


def _count(key: str) -> int:
    with _lock:
        _counters[key] = _counters.get(key, 0) + 1
        return _counters[key]


def _int_env(name: str) -> Optional[int]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"chaos schedule {name}={raw!r} is not an integer") from None


def _float_env(name: str) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(
            f"chaos schedule {name}={raw!r} is not a number") from None
    if val != val or val < 0:
        raise ValueError(
            f"chaos schedule {name}={raw!r} must be >= 0")
    return val


def kill_point(step: int) -> None:
    """SIGKILL this process if ``TONY_CHAOS_KILL_STEP`` names ``step``
    (the scheduler's kill -9, not a clean exit)."""
    at = _int_env(ENV_KILL_STEP)
    if at is None or step != at:
        return
    if KILL_HOOK is not None:
        KILL_HOOK(step)
        return
    os.kill(os.getpid(), signal.SIGKILL)


def drop_heartbeat() -> bool:
    """True if this heartbeat send should be swallowed (the first ``n``
    probes when ``TONY_CHAOS_HB_DROP=n`` is armed)."""
    n = _int_env(ENV_HB_DROP)
    if n is None or n <= 0:
        return False
    return _count("hb_drop") <= n


def rpc_delay() -> None:
    """Stall the first ``TONY_CHAOS_RPC_DELAY_CALLS`` (default 1) RPC
    calls by ``TONY_CHAOS_RPC_DELAY_S`` seconds: injected transport
    latency, counted per logical call (retries of a delayed call are not
    delayed again)."""
    delay = _float_env(ENV_RPC_DELAY_S)
    if delay is None or delay <= 0:
        return
    n = _int_env(ENV_RPC_DELAY_CALLS)
    if _count("rpc_delay") <= (1 if n is None else n):
        (SLEEP_HOOK or time.sleep)(delay)


def crash_point(site: str) -> None:
    """SIGKILL at a named crash site when ``TONY_CHAOS_CRASH`` names it:
    production code declares the site, a test arms exactly one, and the
    invariant is whatever must survive a kill -9 there."""
    if os.environ.get(ENV_CRASH, "") != site:
        return
    if CRASH_HOOK is not None:
        CRASH_HOOK(site)
        return
    os.kill(os.getpid(), signal.SIGKILL)
