"""Crash-consistent on-disk checkpoint format (the ckpt subsystem's wire):
a copy of :mod:`tony_tpu.ckpt.format`, so the port writes and reads the
reference's files (``FORMAT_VERSION`` is the reference's).

One checkpoint step is one directory::

    <root>/step_00000042/
        shards_00000.bin    # proc 0's chunk payload (raw concatenated blobs)
        shards_00000.json   # proc 0's sidecar: chunk table + checksums
        shards_00001.bin    # ... one pair per process
        manifest.json       # written LAST, by process 0 only

and is written under ``<root>/step_00000042.tmp`` until process 0 commits it
with ONE atomic ``os.replace`` of the directory. The invariants that make a
``kill -9`` at any instant recoverable:

* a step directory without the ``.tmp`` suffix always holds a complete,
  checksummed checkpoint (the rename is the commit point — POSIX renames
  are atomic, and the payload/manifest are fsynced before it);
* :func:`latest_step` only ever looks at committed directories, so a crash
  mid-write leaves the previous step exactly restorable and the torn
  ``.tmp`` dir inert (reclaimed by the next save);
* the manifest is itself written via tmp-file + rename inside the staging
  dir, so even the commit's final rename never exposes a torn JSON.

The payload is dtype-transparent raw bytes (little-endian blobs, offsets
in the sidecar) rather than ``.npz``: bf16 round-trips without pickle,
and elastic restore can ``seek``/read exactly the chunks that cover a new
topology's shard instead of decompressing whole archives. Every chunk
carries a CRC32; restore verifies the chunks it actually reads.

Two departures from the reference, neither visible in the files: numpy
has no bfloat16 and the port does not use ``ml_dtypes``, so a
``bfloat16`` leaf is carried as its raw ``uint16`` bytes
(:func:`dtype_from_name` gives the storage dtype, :func:`torch_dtype` the
type to view it as); and PartitionSpecs stay in their JSON form
(:func:`spec_from_json`), the port having no ``jax.sharding``.

Fault injection for the crash-consistency tests: :data:`CRASH_HOOK` (or the
``TONY_CKPT_CRASH`` env var naming a phase) fires at the phases marked by
:func:`_crash_point` — the test hook SIGKILLs the writer mid-save and the
previous step must restore bit-exact.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# The layout of the root (names, the commit rule, the scans) lives in the
# standard-library module the executor's heartbeat also reads.
from tony_tpu_torch.ckpt_layout import MANIFEST_NAME, TMP_SUFFIX  # noqa: F401
from tony_tpu_torch.ckpt_layout import (  # noqa: F401
    _atomic_write_json, _fsync_dir)
from tony_tpu_torch.ckpt_layout import STEP_RE as _STEP_RE
from tony_tpu_torch.ckpt_layout import (committed_steps,  # noqa: F401
                                        latest_step, step_dir, tmp_dir)

FORMAT_VERSION = "tony-ckpt-v1"
ENV_CRASH = "TONY_CKPT_CRASH"
# A chunk is read in pieces of this many bytes, each checksummed on a
# second thread while the next is read.
_READ_PIECE = 64 << 20

# Test seam: a callable ``(phase) -> None`` invoked at the marked phases of
# a save ("after_shards" — payload written, manifest not; "before_commit" —
# manifest staged, directory rename not yet issued). The env var variant
# SIGKILLs the process outright so subprocess tests exercise a true kill -9.
CRASH_HOOK: Optional[Callable[[str], None]] = None


def _crash_point(phase: str) -> None:
    if CRASH_HOOK is not None:
        CRASH_HOOK(phase)
    if os.environ.get(ENV_CRASH) == phase:
        os.kill(os.getpid(), signal.SIGKILL)


# ---------------------------------------------------------------------------
# Naming / discovery
# ---------------------------------------------------------------------------

def shard_file_name(proc: int) -> str:
    return f"shards_{proc:05d}.bin"


def sidecar_name(proc: int) -> str:
    return f"shards_{proc:05d}.json"


# ---------------------------------------------------------------------------
# Dtype / PartitionSpec serialization
# ---------------------------------------------------------------------------

# Manifest dtype names numpy does not know → the numpy dtype of their raw
# little-endian bytes.
_STORAGE = {"bfloat16": np.dtype("<u2")}


def dtype_name(dt: Any) -> str:
    """The manifest name of a numpy or torch dtype (``float32``,
    ``bfloat16``, ``int64``, ...)."""
    if isinstance(dt, torch.dtype):
        return str(dt).rpartition(".")[2]
    return np.dtype(dt).name


def dtype_from_name(name: str) -> np.dtype:
    """The numpy dtype a leaf's bytes are read as: the dtype itself, or,
    for ``bfloat16``, its ``uint16`` storage."""
    if name in _STORAGE:
        return _STORAGE[name]
    return np.dtype(name)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a manifest dtype name stands for."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint dtype {name!r} has no torch dtype")
    return dt


def spec_to_json(spec: Any) -> Optional[List[Any]]:
    """PartitionSpec → JSON (None when the array carried no named spec).
    Each dim entry is ``None`` | ``"axis"`` | ``["axis", ...]``."""
    if spec is None:
        return None
    out: List[Any] = []
    for entry in tuple(spec):
        if entry is None:
            out.append(None)
        elif isinstance(entry, tuple):
            out.append([str(a) for a in entry])
        else:
            out.append(str(entry))
    return out


def spec_from_json(entries: Optional[Sequence[Any]]
                   ) -> Optional[List[Any]]:
    """A manifest spec as the list of its per-dim entries (None when the
    leaf carried no named spec)."""
    if entries is None:
        return None
    return [list(e) if isinstance(e, (list, tuple)) else e for e in entries]


# ---------------------------------------------------------------------------
# Write side
# ---------------------------------------------------------------------------

def write_process_file(staging: str | Path, proc: int,
                       chunks: Sequence[Tuple[int, Sequence[int],
                                              np.ndarray]]) -> Dict[str, Any]:
    """Write this process's chunk payload + sidecar into the staging dir.

    ``chunks`` is ``[(leaf_index, start_offsets, host_array), ...]``; each
    array's bytes are written as they lie (a bfloat16 leaf as its
    ``uint16`` view), without a copy. The sidecar (written tmp+rename
    AFTER the payload is fsynced — its presence is the per-process
    completion signal the committer waits on) records every chunk's byte
    offset, extent, and CRC32.
    """
    staging = Path(staging)
    staging.mkdir(parents=True, exist_ok=True)
    fname = shard_file_name(proc)
    # NOT ascontiguousarray: it promotes 0-d scalars to 1-d, and the
    # recorded chunk shape must match the leaf geometry.
    arrays = [np.asarray(arr, order="C") for _, _, arr in chunks]
    blobs = [a.reshape(-1).view(np.uint8) for a in arrays]  # no copy

    def file_crc32() -> int:
        crc = 0
        for blob in blobs:
            crc = zlib.crc32(blob, crc) & 0xFFFFFFFF
        return crc

    # zlib and the file write release the GIL: the chunk checksums and
    # the whole-file checksum run on two threads while this one writes.
    with ThreadPoolExecutor(max_workers=2) as pool:
        chunk_crcs = pool.submit(
            lambda: [zlib.crc32(b) & 0xFFFFFFFF for b in blobs])
        file_crc_f = pool.submit(file_crc32)
        with open(staging / fname, "wb") as f:
            for blob in blobs:
                f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        crcs, file_crc = chunk_crcs.result(), file_crc_f.result()
    table: List[Dict[str, Any]] = []
    offset = 0
    for (leaf, start, _), arr, blob, crc in zip(chunks, arrays, blobs,
                                                crcs):
        table.append({
            "leaf": int(leaf),
            "start": [int(s) for s in start],
            "shape": [int(s) for s in arr.shape],
            "offset": offset,
            "nbytes": int(blob.nbytes),
            "crc32": crc,
        })
        offset += int(blob.nbytes)
    sidecar = {"file": fname, "process": int(proc), "nbytes": offset,
               "crc32": file_crc, "chunks": table}
    _atomic_write_json(staging / sidecar_name(proc), sidecar)
    return sidecar


def commit(root: str | Path, step: int, *, leaves: List[Dict[str, Any]],
           mesh: Optional[Dict[str, Any]], num_processes: int,
           barrier_timeout_s: float = 300.0) -> Path:
    """Process-0 commit: wait for every process's sidecar, merge them into
    the single manifest, then atomically rename the staging dir into place.
    The filesystem IS the barrier (the root is the durable shared dir the
    TonY contract already assumes for checkpoints)."""
    staging = tmp_dir(root, step)
    deadline = time.monotonic() + barrier_timeout_s
    sidecars: List[Dict[str, Any]] = []
    for proc in range(num_processes):
        path = staging / sidecar_name(proc)
        while not path.is_file():
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"checkpoint step {step}: process {proc} did not finish "
                    f"its shard file within {barrier_timeout_s:.0f}s")
            time.sleep(0.05)
        sidecars.append(json.loads(path.read_text()))
    _crash_point("after_shards")
    manifest = {
        "format": FORMAT_VERSION,
        "step": int(step),
        "num_processes": int(num_processes),
        "created": time.time(),
        "mesh": mesh,
        "leaves": leaves,
        "files": [{"file": s["file"], "nbytes": s["nbytes"],
                   "crc32": s["crc32"]} for s in sidecars],
        "chunks": [dict(c, file=s["file"])
                   for s in sidecars for c in s["chunks"]],
    }
    _atomic_write_json(staging / MANIFEST_NAME, manifest)
    _fsync_dir(staging)
    _crash_point("before_commit")
    final = step_dir(root, step)
    old: Optional[Path] = None
    if final.exists():
        # Re-saving an already-committed step (same-step retry after a
        # restart): move the old copy ASIDE (atomic rename, invisible to
        # committed_steps) rather than rmtree-then-replace — a kill
        # between delete and rename would otherwise lose the only
        # committed copy of this step. Deleted only after the new commit.
        old = final.with_name(final.name + ".old")
        if old.exists():
            shutil.rmtree(old)
        os.replace(final, old)
    os.replace(staging, final)
    _fsync_dir(Path(root))
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    return final


def wait_committed(root: str | Path, step: int,
                   timeout_s: float = 300.0) -> Path:
    """Block until ``step`` is committed (the manifest is visible at the
    final path) — the non-zero-process half of the commit barrier: every
    process's blocking save must mean GLOBALLY durable, not just "my
    shards landed", or a gang-wide save-then-restore diverges across
    processes."""
    final = step_dir(root, step)
    deadline = time.monotonic() + timeout_s
    while not (final / MANIFEST_NAME).is_file():
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint step {step}: process 0 did not commit the "
                f"manifest within {timeout_s:.0f}s")
        time.sleep(0.05)
    return final


def clean_stale(root: str | Path) -> None:
    """Remove torn ``.tmp`` staging dirs left by crashed writers and
    ``.old`` dirs left by a same-step recommit killed mid-swap. Caller
    contract (AsyncCheckpointer): at most ONE live writer instance per
    process per directory — a sweep concurrent with another instance's
    in-flight save would reclaim its staging dir."""
    root = Path(root)
    if not root.is_dir():
        return
    for entry in root.iterdir():
        if entry.name.endswith(".old") \
                and _STEP_RE.match(entry.name[:-len(".old")]):
            shutil.rmtree(entry, ignore_errors=True)
        elif entry.name.endswith(TMP_SUFFIX) \
                and _STEP_RE.match(entry.name[: -len(TMP_SUFFIX)]):
            shutil.rmtree(entry, ignore_errors=True)


def prune(root: str | Path, keep: int) -> List[int]:
    """Delete committed steps beyond the newest ``keep`` (0/negative keeps
    everything). Returns the pruned step numbers."""
    if keep <= 0:
        return []
    steps = committed_steps(root)
    victims = steps[:-keep] if len(steps) > keep else []
    for s in victims:
        shutil.rmtree(step_dir(root, s), ignore_errors=True)
    return victims


# ---------------------------------------------------------------------------
# Read side
# ---------------------------------------------------------------------------

def read_manifest(root: str | Path, step: int) -> Dict[str, Any]:
    path = step_dir(root, step) / MANIFEST_NAME
    manifest = json.loads(path.read_text())
    if manifest.get("format") != FORMAT_VERSION:
        raise ValueError(
            f"{path}: unknown checkpoint format "
            f"{manifest.get('format')!r} (expected {FORMAT_VERSION})")
    return manifest


class ChunkReader:
    """Random-access reader over one committed step's chunk payload:
    ``read(chunk)`` seeks into the owning shard file, verifies the chunk's
    CRC32 (on a second thread, piece by piece as the read goes on), and
    returns the ndarray (read into ``out`` when given — the restore's
    pinned staging buffer). File handles are cached per file."""

    def __init__(self, root: str | Path, step: int,
                 manifest: Optional[Dict[str, Any]] = None,
                 verify: bool = True):
        self.dir = step_dir(root, step)
        self.manifest = manifest if manifest is not None \
            else read_manifest(root, step)
        self.verify = verify
        self._files: Dict[str, Any] = {}
        self._crc = ThreadPoolExecutor(max_workers=1)
        # Indexed once: restore assembles per leaf per shard extent, and a
        # linear manifest scan per call would be O(leaves x extents x
        # chunks).
        self._by_leaf: Dict[int, List[Dict[str, Any]]] = {}
        for c in self.manifest["chunks"]:
            self._by_leaf.setdefault(int(c["leaf"]), []).append(c)

    def chunks_for_leaf(self, leaf: int) -> List[Dict[str, Any]]:
        return self._by_leaf.get(leaf, [])

    def read(self, chunk: Dict[str, Any], dtype: np.dtype,
             out: Optional[np.ndarray] = None) -> np.ndarray:
        f = self._files.get(chunk["file"])
        if f is None:
            f = open(self.dir / chunk["file"], "rb")
            self._files[chunk["file"]] = f
        f.seek(chunk["offset"])
        if out is None:
            out = np.empty(chunk["shape"], dtype=dtype)
        elif not out.flags["C_CONTIGUOUS"]:
            raise ValueError("ChunkReader.read needs a C-contiguous out")
        blob = out.reshape(-1).view(np.uint8)
        if blob.nbytes != chunk["nbytes"]:
            raise ValueError(
                f"{self.dir / chunk['file']}: chunk of leaf {chunk['leaf']} "
                f"has {chunk['nbytes']} bytes, the buffer {blob.nbytes}")
        # Checksum each piece on the reader's thread while the next one is
        # read (zlib and the read both release the GIL).
        crc = [0]

        def update(piece: np.ndarray) -> None:
            crc[0] = zlib.crc32(piece, crc[0])

        got = 0
        pending = []
        while got < blob.nbytes:
            n = f.readinto(blob[got:got + _READ_PIECE])
            if not n:
                break
            if self.verify:
                pending.append(self._crc.submit(update, blob[got:got + n]))
            got += n
        for fut in pending:
            fut.result()
        if got != chunk["nbytes"]:
            raise IOError(
                f"{self.dir / chunk['file']}: short read at offset "
                f"{chunk['offset']} (wanted {chunk['nbytes']}, got "
                f"{got}) — truncated shard file")
        if self.verify and (crc[0] & 0xFFFFFFFF) != chunk["crc32"]:
            raise IOError(
                f"{self.dir / chunk['file']}: CRC mismatch for leaf "
                f"{chunk['leaf']} chunk at offset {chunk['offset']} — "
                f"corrupt checkpoint payload")
        return out

    def close(self) -> None:
        self._crc.shutdown(wait=True)
        for f in self._files.values():
            try:
                f.close()
            except OSError:
                pass
        self._files.clear()

    def __enter__(self) -> "ChunkReader":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()
