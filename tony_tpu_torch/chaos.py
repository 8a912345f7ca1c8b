"""Scripted preemption for the port's train loop: a copy of the part of
:mod:`tony_tpu.chaos` that :func:`tony_tpu_torch.train.train_loop`
consults.

``TONY_CHAOS_KILL_STEP=k`` SIGKILLs this process as training step ``k``
completes, the same env the control plane's chaos harness arms for the
JAX package's loop. A malformed value raises ``ValueError``: a typoed
fault schedule must not turn a chaos test into a vacuous pass.
In-process tests set ``KILL_HOOK`` to observe the fault instead of
receiving SIGKILL, and call :func:`reset` after.
"""

from __future__ import annotations

import os
import signal
from typing import Callable, Optional

ENV_KILL_STEP = "TONY_CHAOS_KILL_STEP"

# When set, called with the step INSTEAD of delivering SIGKILL.
KILL_HOOK: Optional[Callable[[int], None]] = None


def reset() -> None:
    """Disarm the test hook (test epilogue)."""
    global KILL_HOOK
    KILL_HOOK = None


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
