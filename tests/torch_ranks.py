"""Waiting on the gloo ranks a port test spawns (a helper module of
tests/test_torch_*.py, not a test file)."""

from __future__ import annotations

import subprocess
import time
from typing import List, Sequence

import pytest


def wait_ranks(procs: Sequence[subprocess.Popen], timeout: float,
               what: str) -> List[str]:
    """Wait for ``procs``, ranks started together, against ONE deadline
    ``timeout`` s away, and return each rank's output. A rank still
    running at the deadline fails the test with a message naming
    ``what`` and the tail of every rank's output; every rank is killed
    on the way out, whatever happened. A rank that exited non-zero fails
    the test with its output."""
    deadline = time.monotonic() + timeout
    logs: List[str] = [None] * len(procs)
    late = False
    try:
        for i, p in enumerate(procs):
            try:
                logs[i] = p.communicate(
                    timeout=max(0.1, deadline - time.monotonic()))[0]
            except subprocess.TimeoutExpired:
                late = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for i, p in enumerate(procs):
            if logs[i] is None:
                logs[i] = p.communicate()[0] or ""
    if late:
        tails = "\n".join(f"--- rank {i}:\n{log[-2000:]}"
                          for i, log in enumerate(logs))
        pytest.fail(f"{what}: {len(procs)} gloo rank(s) still running "
                    f"after {timeout:.0f} s, killed\n{tails}",
                    pytrace=False)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{what} rank {rank}:\n{log}"
    return logs
