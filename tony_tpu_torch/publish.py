"""Continuous weight publication: the train->serve pointer plane (a copy of
:mod:`tony_tpu.publish` over the port's checkpoint format and chaos
sites).

One small durable artifact: a versioned pointer file ``published.json``
in the checkpoint root, naming the committed step the serving fleet
should be running.

* the TRAIN side (``train_loop``'s ``publish_every``) advances it — only
  ever to a step that :func:`tony_tpu_torch.ckpt.format.committed_steps`
  proves committed, and only through stage-and-rename, so a SIGKILL
  anywhere leaves the OLD pointer or the NEW one, never a torn file;
* the SERVE side reads it with :func:`latest_publication`, failure-silent:
  a half-visible network-filesystem read degrades to "no news".

Versions are a monotonically increasing integer minted here (previous
pointer's version + 1, starting at 1), NOT the step number: a rollback
publication re-points at an OLDER step with a NEWER version. The chaos
sites (``publish_before_stage`` / ``publish_after_stage`` /
``publish_after_replace``) bracket both moves.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

from tony_tpu_torch import chaos
from tony_tpu_torch.ckpt.format import MANIFEST_NAME, _fsync_dir, \
    committed_steps, step_dir

__all__ = ["PUBLISH_FILE", "PublishError", "publish_step",
           "latest_publication"]

# Lives in the checkpoint ROOT, next to the step_%08d dirs it points
# into — one rename away from every manifest it can name, so pointer
# and checkpoint are always on the same filesystem (os.replace must be
# atomic between them).
PUBLISH_FILE = "published.json"


class PublishError(RuntimeError):
    """The publication cannot be made (uncommitted step, missing ckpt
    root). Typed so callers distinguish "nothing to publish yet" from a
    broken pointer write — the CLI surfaces it as a clean error, the
    train loop as a hard fault (publishing an uncommitted step would
    hand the fleet a manifest that may never exist)."""


def publish_step(ckpt_dir: str | Path, step: Optional[int] = None, *,
                 note: str = "") -> Dict[str, Any]:
    """Advance the pointer to ``step`` (default: the newest committed
    step) and return the new record. The step MUST already be committed
    — the pointer may only ever name a manifest a restore can land, and
    the async checkpointer's caller is responsible for ``wait()``-ing
    its own commit before publishing it.

    Crash-safe by stage-and-rename: the tmp file is fsynced before the
    rename and the directory after it, and the three declared chaos
    sites bracket both moves. Re-publishing the same step mints a new
    version (an explicit re-push is a fleet-wide "converge again"
    signal, not a no-op).
    """
    root = Path(ckpt_dir)
    steps = committed_steps(root)
    if step is None:
        if not steps:
            raise PublishError(f"no committed checkpoint under {root} "
                               f"— nothing to publish")
        step = steps[-1]
    step = int(step)
    if step not in steps:
        raise PublishError(
            f"step {step} is not committed under {root} "
            f"(committed: {steps[-5:] if steps else []}) — a pointer "
            f"must only name a manifest a restore can land")
    prev = latest_publication(root)
    record = {
        "version": (int(prev["version"]) + 1) if prev else 1,
        "step": step,
        "manifest": f"{step_dir(root, step).name}/{MANIFEST_NAME}",
        "published_at": time.time(),
        "note": str(note),
    }
    target = root / PUBLISH_FILE
    tmp = root / (PUBLISH_FILE + ".tmp")
    chaos.crash_point("publish_before_stage")
    with open(tmp, "w") as f:
        json.dump(record, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    chaos.crash_point("publish_after_stage")
    os.replace(tmp, target)
    chaos.crash_point("publish_after_replace")
    _fsync_dir(root)
    return record


def latest_publication(ckpt_dir: str | Path) -> Optional[Dict[str, Any]]:
    """The current pointer record, or ``None`` when nothing was ever
    published (or the file is unreadable/malformed — failure-silent BY
    CONTRACT: this runs inside every executor heartbeat and the AM
    tick, where a transiently half-visible network filesystem must read
    as "no publication news", never kill the probe). A well-formed
    record always carries integer ``version`` and ``step``."""
    try:
        with open(Path(ckpt_dir) / PUBLISH_FILE) as f:
            rec = json.load(f)
        if not isinstance(rec, dict):
            return None
        rec["version"] = int(rec["version"])
        rec["step"] = int(rec["step"])
        return rec
    except (OSError, ValueError, TypeError, KeyError):
        return None
