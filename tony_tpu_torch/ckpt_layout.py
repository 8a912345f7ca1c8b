"""The checkpoint root's layout: what a committed step and the
publication pointer look like on disk, and the two scans over them.

A committed step is a ``step_<n>`` directory (``n`` zero-padded to 8)
holding its manifest; a save stages into ``step_<n>.tmp`` and commits by
renaming it. The publication pointer ``published.json`` lives in the
root beside the steps. :mod:`tony_tpu_torch.ckpt.format` and
:mod:`tony_tpu_torch.publish` write this layout (their originals are
``tony_tpu.ckpt.format`` and ``tony_tpu.publish``); the executor's
heartbeat reads it. Standard library only, so the executor reads it
without importing torch; the persisted prefix store
(:mod:`tony_tpu_torch.serve.kvstore`) commits its stems with the same
two writes.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

MANIFEST_NAME = "manifest.json"
TMP_SUFFIX = ".tmp"
# Lives in the checkpoint ROOT, next to the step_%08d dirs it points
# into — one rename away from every manifest it can name, so pointer
# and checkpoint are always on the same filesystem (os.replace must be
# atomic between them).
PUBLISH_FILE = "published.json"

STEP_RE = re.compile(r"^step_(\d+)$")


def _fsync_dir(path: Path) -> None:
    """fsync a directory, so a rename inside it is durable (a no-op where
    the directory cannot be opened)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write_json(path: Path, payload: Dict[str, Any]) -> None:
    """``payload`` as JSON at ``path``: written and fsynced beside it,
    then renamed into place."""
    tmp = path.with_suffix(path.suffix + ".part")
    with open(tmp, "w") as f:
        json.dump(payload, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def step_dir(root: str | Path, step: int) -> Path:
    return Path(root) / f"step_{step:08d}"


def tmp_dir(root: str | Path, step: int) -> Path:
    return Path(root) / f"step_{step:08d}{TMP_SUFFIX}"


def committed_steps(root: str | Path) -> List[int]:
    """All committed step numbers under ``root``, ascending. A directory
    counts only if the commit rename happened AND the manifest is inside —
    ``.tmp`` staging dirs and torn leftovers never appear here."""
    root = Path(root)
    if not root.is_dir():
        return []
    out = []
    for entry in root.iterdir():
        m = STEP_RE.match(entry.name)
        if m and (entry / MANIFEST_NAME).is_file():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(root: str | Path) -> Optional[int]:
    steps = committed_steps(root)
    return steps[-1] if steps else None


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
