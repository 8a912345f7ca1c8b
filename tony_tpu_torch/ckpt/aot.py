"""Persisted AOT cache of the cold-start plane: the counterpart of
:mod:`tony_tpu.ckpt.aot`.

In the JAX package a step program is one compiled XLA executable, and
the cache persists it so that a later replica of the same family
deserializes it instead of compiling. The port's compiled artifacts are
the ``nvcc``-built kernel libraries a step family launches
(:mod:`tony_tpu_torch.ops._build`): the cache persists their bytes, so a
later process of the same family on the same toolchain and card loads
them instead of running ``nvcc``. An entry holds one set of libraries
(:func:`library_fingerprint`): a library does not depend on the shapes
it runs at, so every step shape that launches the same set shares it.
The step itself is then captured into a CUDA graph
(:meth:`tony_tpu_torch.serve.ServeEngine.warm`), which no process can
persist.

One cache entry is one directory::

    <root>/aot_<key>/
        payload.bin     # the entry's bytes, chunked
        entry.json      # format tag + FULL fingerprint + chunk table

committed with the checkpoint plane's stage-then-rename discipline
(:mod:`tony_tpu_torch.ckpt.format`): payload and entry are written
(fsynced) into a per-writer staging directory and ``os.replace``d into
place. A crashed writer leaves a ``.tmp`` orphan, never a half entry, and
a concurrent populate of one key is first-writer-wins.

``<key>`` is a digest of the fingerprint, but the name is only an
address: ``entry.json`` stores the FULL fingerprint and
:meth:`AOTCache.get` requires an exact match, so a digest collision, a
hand-edited entry or any drift (geometry, torch, CUDA, driver, card,
``nvcc``, flags) is a counted miss. Every payload chunk carries a CRC32
checked on read; corruption or truncation is a counted miss too, and
``get`` never changes the directory. The cache may cost a build, never a
wrong library.

Imports torch and numpy only; the toolchain half of the fingerprint
reads :mod:`tony_tpu_torch.ops._build` lazily.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import json
import os
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from tony_tpu_torch.ckpt.format import (TMP_SUFFIX, _atomic_write_json,
                                        _fsync_dir)

_PREFIX = "aot_"
FORMAT = "tony-aot-v1"

# Payload chunking: a CRC32 per chunk bounds what one flipped bit costs
# to detect without hashing a large payload twice.
CHUNK_BYTES = 1 << 20


# ---------------------------------------------------------------------------
# Fingerprinting: what makes two builds THE SAME libraries
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _driver_version() -> int:
    """The CUDA driver's version (``cuDriverGetVersion``, e.g. 12080), or
    0 where no driver library loads."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return 0
    out = ctypes.c_int(0)
    if lib.cuDriverGetVersion(ctypes.byref(out)) != 0:
        return 0
    return int(out.value)


def runtime_fingerprint(device: Optional[Union[str, torch.device]] = None
                        ) -> Dict[str, Any]:
    """The toolchain half of a fingerprint: torch and its CUDA runtime,
    the driver, the card's name and compute capability, the ``nvcc
    --version`` line and the build flags. A library is only valid for
    the toolchain and card family that built it, so any of these
    changing must be a miss, not a wrong load. ``device`` (default: the
    card when one is present) names the card; a CPU device has none."""
    from tony_tpu_torch.ops import _build

    dev = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    name, capability = "", []
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        name = torch.cuda.get_device_name(index)
        capability = list(torch.cuda.get_device_capability(index))
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "driver": _driver_version() if dev.type == "cuda" else 0,
        "device_type": dev.type,
        "device_name": name,
        "capability": capability,
        "nvcc": _build.nvcc_version() if dev.type == "cuda" else "",
        "nvcc_flags": list(_build.NVCC_FLAGS),
    }


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of a module (its state dict), a dataclass
    (its fields), a mapping (sorted keys), a list or tuple, or a leaf."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from _leaves(tree[key], f"{path}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, f"{path}[{i}]")
    else:
        yield path, tree


def tree_digest(tree: Any) -> str:
    """Digest of a tree's SHAPE: each leaf's path, shape and dtype. A
    module enters through its state dict (parameters and buffers), so
    restored weights of the same geometry hit while another geometry or
    storage type misses; values never enter."""
    h = hashlib.sha256()
    for path, leaf in _leaves(tree):
        if isinstance(leaf, (torch.Tensor, np.ndarray)):
            desc = f"{tuple(leaf.shape)}|{leaf.dtype}"
        else:
            desc = type(leaf).__name__
        h.update(f"{path}:{desc};".encode())
    return h.hexdigest()


def make_fingerprint(kind: str, *,
                     device: Optional[Union[str, torch.device]] = None,
                     geometry: Optional[Dict[str, Any]] = None,
                     model: Any = None, tree: Any = None,
                     batch: Any = None,
                     extra: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """One step family's full fingerprint: toolchain + step geometry +
    model config + state-shape digests. JSON-canonicalized, so the dict
    a fresh process derives compares equal to the one :meth:`AOTCache.get`
    reads back from ``entry.json``."""
    fp: Dict[str, Any] = {"format": FORMAT, "kind": str(kind)}
    fp.update(runtime_fingerprint(device))
    fp["geometry"] = dict(geometry or {})
    fp["model"] = "" if model is None else str(model)
    if tree is not None:
        fp["tree"] = tree_digest(tree)
    if batch is not None:
        fp["batch"] = tree_digest(batch)
    if extra:
        fp["extra"] = dict(extra)
    return json.loads(json.dumps(fp, sort_keys=True))


def library_fingerprint(names: Tuple[str, ...]) -> Dict[str, Any]:
    """The cache identity of one set of kernel libraries: their hashed
    file names (source, headers and flags) and the toolchain of the card
    they run on, the CPU's for an empty set. A library does not depend
    on the shapes or weights it runs at, so every step family that
    launches the same set shares one entry."""
    from tony_tpu_torch.ops import _build

    return make_fingerprint(
        "kernels", device="cuda" if names else "cpu",
        extra={"libraries": [_build.library_file(n) for n in names]})


def fingerprint_key(fp: Dict[str, Any]) -> str:
    """The entry's directory name stem — an ADDRESS, not the identity:
    ``get`` always re-verifies the stored full fingerprint."""
    blob = json.dumps(fp, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:20]


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

class AOTCache:
    """One directory of persisted build artifacts (module docstring).
    ``put`` stores a payload of bytes under a fingerprint; ``get``
    returns them, or ``None`` on any corruption or drift.

    Counters are lifetime and shared by every consumer (the serve engine
    and the train step keep their own too): ``hits``/``misses`` per
    ``get``, ``puts`` committed, ``put_races`` lost to a first writer."""

    def __init__(self, root: Union[str, Path]) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.put_races = 0

    def _dir(self, fp: Dict[str, Any]) -> Path:
        return self.root / f"{_PREFIX}{fingerprint_key(fp)}"

    def entries(self) -> List[str]:
        """Committed entry keys, sorted (staging orphans excluded)."""
        return [name[len(_PREFIX):] for name in sorted(os.listdir(self.root))
                if name.startswith(_PREFIX) and TMP_SUFFIX not in name]

    # -- read --------------------------------------------------------------
    def get(self, fp: Dict[str, Any]) -> Optional[bytes]:
        """The payload stored under ``fp``, or ``None`` (a counted miss)
        on: no entry, format or fingerprint drift, a chunk whose CRC32
        does not match, or a truncated payload. Never raises, never
        changes the store: a poisoned entry costs a build on every
        consult, not a crash and never a wrong library."""
        d = self._dir(fp)
        try:
            with open(d / "entry.json") as f:
                entry = json.load(f)
            if entry.get("format") != FORMAT:
                raise ValueError("format drift")
            if entry.get("fingerprint") != fp:
                raise ValueError("fingerprint drift")
            payload = bytearray()
            with open(d / "payload.bin", "rb") as f:
                for chunk in entry["chunks"]:
                    f.seek(int(chunk["offset"]))
                    raw = f.read(int(chunk["nbytes"]))
                    if len(raw) != int(chunk["nbytes"]) or \
                            (zlib.crc32(raw) & 0xFFFFFFFF) \
                            != int(chunk["crc32"]):
                        raise ValueError("payload chunk CRC mismatch")
                    payload += raw
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            self.misses += 1
            return None
        self.hits += 1
        return bytes(payload)

    # -- write -------------------------------------------------------------
    def put(self, fp: Dict[str, Any], payload: bytes) -> bool:
        """Persist ``payload`` under ``fp``. True only when THIS call
        committed the entry; False when the key was already committed
        (idempotent, or lost a concurrent race: both counted in
        ``put_races``). Stage-then-rename: a crash leaves a ``.tmp``
        orphan, never a half entry."""
        final = self._dir(fp)
        if final.exists():
            self.put_races += 1
            return False
        payload = bytes(payload)
        table: List[Dict[str, int]] = []
        for off in range(0, max(1, len(payload)), CHUNK_BYTES):
            raw = payload[off:off + CHUNK_BYTES]
            table.append({"offset": off, "nbytes": len(raw),
                          "crc32": zlib.crc32(raw) & 0xFFFFFFFF})
        # Per-writer staging name: concurrent populates of ONE key each
        # stage alone; the rename onto a committed entry fails and the
        # loser's staging is discarded.
        staging = Path(f"{final}{TMP_SUFFIX}.{os.getpid()}"
                       f".{threading.get_ident()}")
        staging.mkdir(parents=True, exist_ok=True)
        with open(staging / "payload.bin", "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        _atomic_write_json(staging / "entry.json", {
            "format": FORMAT, "fingerprint": fp, "chunks": table})
        try:
            os.replace(staging, final)
        except OSError:
            shutil.rmtree(staging, ignore_errors=True)
            self.put_races += 1
            return False
        _fsync_dir(self.root)
        self.puts += 1
        return True

    # -- maintenance -------------------------------------------------------
    def gc(self, *, dry_run: bool = False,
           runtime: Optional[Dict[str, Any]] = None) -> tuple:
        """Drop entries no live process can hit: those whose stored
        toolchain half (:func:`runtime_fingerprint`) differs from this
        process's (``get`` compares the full fingerprint, and that half
        comes from the machine, not the caller), unreadable entries, and
        staging ``.tmp`` orphans. Geometry and model are not a drop
        criterion: other families of the live toolchain are what the
        cache is for. Returns ``(dropped, kept, freed_bytes)``;
        ``dry_run`` reports without deleting; ``runtime`` overrides the
        live toolchain (tests)."""
        if runtime is None:
            runtime = runtime_fingerprint()
        rt_keys = sorted(runtime)

        def _size(d: Path) -> int:
            try:
                return sum(f.stat().st_size for f in d.rglob("*")
                           if f.is_file())
            except OSError:
                return 0

        dropped, kept, freed = 0, 0, 0
        for name in sorted(os.listdir(self.root)):
            if not name.startswith(_PREFIX):
                continue
            d = self.root / name
            if TMP_SUFFIX in name:
                stale = True          # a crashed writer's staging
            else:
                try:
                    with open(d / "entry.json") as f:
                        fp = json.load(f).get("fingerprint") or {}
                    stale = any(fp.get(k) != runtime[k] for k in rt_keys)
                except (OSError, ValueError, AttributeError):
                    stale = True      # unreadable = unhittable
            if stale:
                freed += _size(d)
                dropped += 1
                if not dry_run:
                    shutil.rmtree(d, ignore_errors=True)
            else:
                kept += 1
        if dropped and not dry_run:
            _fsync_dir(self.root)
        return dropped, kept, freed
