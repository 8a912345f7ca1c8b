"""Scripted faults for the port's train loop and publication: a copy of
the part of :mod:`tony_tpu.chaos` that
:func:`tony_tpu_torch.train.train_loop` and
:mod:`tony_tpu_torch.publish` consult.

``TONY_CHAOS_KILL_STEP=k`` SIGKILLs this process as training step ``k``
completes, the same env the control plane's chaos harness arms for the
JAX package's loop; ``TONY_CHAOS_CRASH=<site>`` SIGKILLs it at the named
crash site (:func:`crash_point`). A malformed step raises
``ValueError``: a typoed fault schedule must not turn a chaos test into a
vacuous pass. In-process tests set ``KILL_HOOK``/``CRASH_HOOK`` to observe
the fault instead of receiving SIGKILL, and call :func:`reset` after.
"""

from __future__ import annotations

import os
import signal
from typing import Callable, Optional

ENV_KILL_STEP = "TONY_CHAOS_KILL_STEP"
ENV_CRASH = "TONY_CHAOS_CRASH"

# When set, called with the step (the site) INSTEAD of delivering SIGKILL.
KILL_HOOK: Optional[Callable[[int], None]] = None
CRASH_HOOK: Optional[Callable[[str], None]] = None


def reset() -> None:
    """Disarm the test hooks (test epilogue)."""
    global KILL_HOOK, CRASH_HOOK
    KILL_HOOK = None
    CRASH_HOOK = None


def _int_env(name: str) -> Optional[int]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"chaos schedule {name}={raw!r} is not an integer") from None


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
