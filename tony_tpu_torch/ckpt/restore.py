"""Restore: the counterpart of :mod:`tony_tpu.ckpt.restore`.

A committed step — written by the port or by the JAX package — is
restored INTO the target's tensors in place (a parameter that is a view
of a fused-optimizer bucket stays one), host → device through a pinned
staging buffer when the target lies on the card. Each target part's
extent is assembled from the covering file chunks, so the geometry is the
reference's: a leaf the JAX package saved whole (a scanned ``[L, in,
out]`` kernel) fills the port's per-layer ``[out, in]`` weights, a leaf
the port saved one chunk per layer fills a JAX template, and a step
written by any number of processes restores onto any other (under data
parallelism every rank reads every leaf).

Leaves absent from the manifest pass through from the target (``strict``
raises for array leaves); a shape mismatch raises naming the leaf; a
dtype change casts. Each restore is recorded through
:func:`tony_tpu_torch.profiler.record_ckpt` (``"restore"``: its wall time
and the device time and bytes of its host → device copies).

A ZeRO-3 target (tensors with a sharded
:class:`~tony_tpu_torch.parallel.layout.Layout`) restores each rank's
slice from the chunks that cover it, whatever fsdp size (or package)
wrote the step. A manifest spec naming a mesh axis the port does not
shard over (anything but data and fsdp, unless the manifest's mesh has
it at size 1) raises ``NotImplementedError``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tony_tpu_torch import profiler
from tony_tpu_torch.ckpt import format as fmt
from tony_tpu_torch.ckpt.snapshot import (LeafView, _host_array,
                                          _is_saveable, _oriented, _parts,
                                          _region, as_leaf, leaf_paths,
                                          tree_unflatten)

# Mesh axes a restore maps, and the ROADMAP items of the others.
_PORTED_AXES = ("data", "fsdp")
_AXIS_ITEMS = {"slice": 8, "pipe": 11, "expert": 11, "seq": 11, "model": 11}


def _assemble(reader: fmt.ChunkReader, leaf_idx: int, dtype: np.dtype,
              start: Sequence[int], shape: Sequence[int],
              out: Optional[np.ndarray] = None,
              chunk_cache: Optional[Dict[Any, np.ndarray]] = None
              ) -> np.ndarray:
    """Build the extent ``[start, start + shape)`` of a leaf from the
    covering chunks (into ``out`` when given). A chunk that is exactly the
    extent is read straight into ``out``; ``chunk_cache`` (keyed by
    file+offset, scoped to one leaf) avoids re-reading a chunk that
    covers several extents."""
    start = [int(s) for s in start]
    stop = [a + int(n) for a, n in zip(start, shape)]
    chunks = reader.chunks_for_leaf(leaf_idx)
    for chunk in chunks:
        if list(chunk["start"]) == start and list(chunk["shape"]) == \
                [int(n) for n in shape]:
            return reader.read(chunk, dtype, out=out)
    if out is None:
        out = np.empty([int(n) for n in shape], dtype=dtype)
    filled = 0
    for chunk in chunks:
        c_start = chunk["start"]
        c_stop = [a + s for a, s in zip(c_start, chunk["shape"])]
        lo = [max(a, b) for a, b in zip(start, c_start)]
        hi = [min(a, b) for a, b in zip(stop, c_stop)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        key = (chunk["file"], chunk["offset"])
        data = chunk_cache.get(key) if chunk_cache is not None else None
        if data is None:
            data = reader.read(chunk, dtype)
            if chunk_cache is not None:
                chunk_cache[key] = data
        src = tuple(slice(a - cs, b - cs)
                    for a, b, cs in zip(lo, hi, c_start))
        dst = tuple(slice(a - os_, b - os_)
                    for a, b, os_ in zip(lo, hi, start))
        out[dst] = data[src]
        filled += int(np.prod([b - a for a, b in zip(lo, hi)],
                              dtype=np.int64))
    if filled != out.size:
        raise IOError(
            f"checkpoint leaf {leaf_idx}: chunks cover {filled} of "
            f"{out.size} elements for the extent at {start} of shape "
            f"{list(shape)} — incomplete payload (replica-0 chunks must "
            f"partition every leaf)")
    return out


# Restore-time dtype policies (f32 master → serving dtype): policy name →
# the dtype float leaves cast to.
DTYPE_POLICIES: Dict[str, str] = {"bf16": "bfloat16", "f32": "float32"}

# Leaves the policy NEVER touches: optimizer slots (optax state and the
# fused plane's portable leaf-major form both live under .opt_state) and
# the quant lane's delayed-scaling state.
POLICY_EXEMPT_MARKERS: tuple = (".opt_state", ".quant_state")

_FLOATS = ("float16", "bfloat16", "float32", "float64")


def _apply_dtype_policy(policy: Optional[str], path: str,
                        dtype: str) -> str:
    """The dtype name a leaf at ``path`` assembles into under ``policy``:
    float leaves cast to the policy dtype, optimizer/scale state and
    non-float leaves (tokens, counters, bools) keep their own."""
    if policy is None:
        return dtype
    if policy not in DTYPE_POLICIES:
        raise ValueError(f"unknown dtype_policy {policy!r} "
                         f"(one of {sorted(DTYPE_POLICIES)})")
    if any(m in path for m in POLICY_EXEMPT_MARKERS):
        return dtype
    if dtype not in _FLOATS:
        return dtype
    return DTYPE_POLICIES[policy]


def _check_spec(meta: Dict[str, Any],
                mesh_meta: Optional[Dict[str, Any]]) -> None:
    sizes = (mesh_meta or {}).get("shape") or {}
    for entry in fmt.spec_from_json(meta.get("spec")) or ():
        names = entry if isinstance(entry, list) else (
            [entry] if entry is not None else [])
        other = [a for a in names
                 if a not in _PORTED_AXES and sizes.get(a) != 1]
        if other:
            items = sorted({_AXIS_ITEMS.get(a, 11) for a in other})
            raise NotImplementedError(
                f"checkpoint leaf {meta['path']} is sharded over mesh "
                f"axes {other}; only the data and fsdp axes are ported "
                f"(ROADMAP.md, queue 1 item "
                f"{' and '.join(map(str, items))})")


def _as_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """A host array of a leaf's storage dtype as a tensor of its dtype
    (no copy)."""
    if fmt.dtype_from_name(name).name != name:
        return torch.from_numpy(arr.view(np.int16)).view(
            fmt.torch_dtype(name))
    return torch.from_numpy(arr)


class _Pinned:
    """One reusable pinned host buffer for the restore's host → device
    copies; ``take`` waits until the previous copy out of it is done.
    Each copy is bracketed by timing events (:meth:`h2d_s`)."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None
        self.event: Optional[Any] = None
        self.copies: List[Tuple[Any, Any]] = []
        self.nbytes = 0

    def take(self, nbytes: int) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = torch.empty(nbytes, dtype=torch.uint8,
                                   pin_memory=True)
        return self.buf[:nbytes]

    def copy(self, src: torch.Tensor, device: torch.device) -> torch.Tensor:
        """``src`` (a view of the buffer) on ``device``, without a host
        wait."""
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        self.event = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = src.to(device, non_blocking=True)
        self.event.record(stream)
        self.copies.append((start, self.event))
        self.nbytes += src.numel() * src.element_size()
        return out

    def h2d_s(self) -> float:
        """Device time of every copy so far (waits for the last)."""
        if self.event is not None:
            self.event.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.copies) / 1e3


@torch.no_grad()
def _fill(reader: fmt.ChunkReader, leaf_idx: int, meta: Dict[str, Any],
          target: Any, dtype: str, pinned: _Pinned) -> None:
    """Assemble each part of a tensor or leaf-view target and copy it
    into the part's tensor in place, through the part's permuted view
    (on its device: any strides, channels-last included)."""
    saved = meta["dtype"]
    storage = fmt.dtype_from_name(saved)
    shape = tuple(meta["shape"])
    cache: Dict[Any, np.ndarray] = {}
    for start, t, perm in _parts(target):
        region = _region(shape, t, perm)
        out = None
        if t.device.type == "cuda":
            n = int(np.prod(region, dtype=np.int64)) * storage.itemsize
            out = pinned.take(n).numpy().view(storage).reshape(region)
        host = _assemble(reader, leaf_idx, storage, start, region, out=out,
                         chunk_cache=cache)
        src = _as_tensor(host, saved)
        if t.device.type == "cuda":
            src = pinned.copy(src, t.device)
        src = src.to(fmt.torch_dtype(dtype))
        view = _oriented(t, perm)
        view.copy_(src.reshape(view.shape))


def _restore_leaf(reader: fmt.ChunkReader, leaf_idx: int,
                  meta: Dict[str, Any], target: Any,
                  dtype_policy: Optional[str], pinned: _Pinned,
                  mesh_meta: Optional[Dict[str, Any]] = None) -> Any:
    _check_spec(meta, mesh_meta)
    global_shape = tuple(meta["shape"])
    live, target = target, as_leaf(target)
    if isinstance(target, (torch.Tensor, LeafView)):
        t_shape = tuple(target.shape)
    elif isinstance(target, (bool, int, float, complex)):
        t_shape = ()
    else:
        t_shape = tuple(np.shape(target))
    if (hasattr(target, "shape") or isinstance(target, (torch.Tensor,
                                                        LeafView))) \
            and t_shape != global_shape:
        raise ValueError(
            f"checkpoint leaf {meta['path']}: saved shape "
            f"{global_shape} != target shape {t_shape} — the checkpoint "
            f"was written for a different model")
    if isinstance(target, (torch.Tensor, LeafView)):
        dtype = _apply_dtype_policy(dtype_policy, meta["path"],
                                    fmt.dtype_name(target.dtype))
        _fill(reader, leaf_idx, meta, target, dtype, pinned)
        return live
    name = fmt.dtype_name(getattr(target, "dtype", None)
                          or fmt.dtype_from_name(meta["dtype"]))
    name = _apply_dtype_policy(dtype_policy, meta["path"], name)
    full = _assemble(reader, leaf_idx, fmt.dtype_from_name(meta["dtype"]),
                     (0,) * len(global_shape), global_shape)
    if fmt.dtype_from_name(meta["dtype"]).name != meta["dtype"] \
            or fmt.dtype_from_name(name).name != name:
        # bfloat16 on either side: cast through torch.
        cast = _as_tensor(full, meta["dtype"]).to(fmt.torch_dtype(name))
        return _host_array(cast.contiguous())
    return full.astype(name, copy=False)


def restore_pytree(root: str | Path, target: Any, *,
                   step: Optional[int] = None, mesh: Optional[Any] = None,
                   verify: bool = True, strict: bool = True,
                   dtype_policy: Optional[str] = None,
                   path_prefix: str = "") -> Any:
    """Restore ``target``'s array leaves from the committed checkpoint at
    ``step`` (default: newest). Tensor and :class:`LeafView` leaves are
    filled in place, on their own devices; numpy and Python scalar leaves
    come back as numpy arrays. Returns the tree with the restored leaves.
    ``strict`` raises when an array leaf has no manifest entry (else it
    passes through). ``mesh`` is the reference's elastic-restore target
    and has nothing to map here: every rank restores its own tensors,
    a ZeRO-3 shard the extent its layout names.

    ``dtype_policy`` is the serving plane's restore-time cast (``"bf16"``:
    float leaves assembled in bf16; optimizer/scale state never cast —
    :data:`POLICY_EXEMPT_MARKERS`). ``path_prefix`` restores a SUBTREE of
    a larger manifest: target leaf paths are looked up as ``path_prefix +
    path`` (``".params"`` pulls the params out of a whole train state);
    :func:`find_path_prefix` locates it."""
    del mesh
    t0 = time.perf_counter()
    if step is None:
        step = fmt.latest_step(root)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {root}")
    manifest = fmt.read_manifest(root, step)
    by_path = {m["path"]: (i, m) for i, m in enumerate(manifest["leaves"])}
    paths, leaves, treedef = leaf_paths(target)
    out: List[Any] = []
    pinned = _Pinned()
    with fmt.ChunkReader(root, step, manifest, verify=verify) as reader:
        for path, leaf in zip(paths, leaves):
            path = path_prefix + path
            if path not in by_path:
                if strict and _is_saveable(leaf) and _ndim(leaf) > 0:
                    raise KeyError(
                        f"target leaf {path} has no entry in checkpoint "
                        f"step {step} (pass strict=False to keep the "
                        f"target's value)")
                out.append(leaf)
                continue
            idx, meta = by_path[path]
            out.append(_restore_leaf(reader, idx, meta, leaf, dtype_policy,
                                     pinned, manifest.get("mesh")))
    h2d_s = pinned.h2d_s()
    profiler.record_ckpt("restore", step=int(step), path_prefix=path_prefix,
                         seconds=time.perf_counter() - t0,
                         h2d_s=h2d_s, h2d_nbytes=pinned.nbytes)
    return tree_unflatten(treedef, out)


def _ndim(leaf: Any) -> int:
    return len(leaf.shape) if isinstance(leaf, LeafView) else np.ndim(leaf)


def find_path_prefix(root: str | Path, target: Any, *,
                     step: Optional[int] = None) -> str:
    """The ``path_prefix`` under which ``target``'s leaves live in the
    committed manifest (a raw params save → ``""``, a train state →
    ``".params"``, train_loop's wrapped payload → ``"['model'].params"``).
    Raises ``KeyError`` when no prefix covers every array leaf."""
    if step is None:
        step = fmt.latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    manifest = fmt.read_manifest(root, step)
    mpaths = {m["path"] for m in manifest["leaves"]}
    paths, leaves, _ = leaf_paths(target)
    needed = [p for p, leaf in zip(paths, leaves)
              if _is_saveable(leaf) and _ndim(leaf) > 0]
    if not needed:
        return ""
    probe = needed[0]
    candidates = []
    for mp in sorted(mpaths):
        if not mp.endswith(probe):
            continue
        prefix = mp[:len(mp) - len(probe)]
        if all(prefix + p in mpaths for p in needed):
            candidates.append(prefix)
    if not candidates:
        raise KeyError(
            f"no manifest path prefix covers the target's leaves (probe "
            f"{probe!r}; manifest has {len(mpaths)} leaves) — is this "
            f"checkpoint for a different model?")
    # adamw's mu/nu trees mirror the params' leaf paths exactly, so
    # ".opt_state[0].mu" covers a bare params target too: prefer prefixes
    # outside the derived-state subtrees, shortest first.
    primary = [c for c in candidates
               if not any(m in c for m in POLICY_EXEMPT_MARKERS)]
    return min(primary or candidates, key=len)


def restore_latest(root: str | Path, target: Any, *,
                   mesh: Optional[Any] = None, verify: bool = True,
                   dtype_policy: Optional[str] = None) -> Any:
    """``restore_pytree`` when a committed step exists, else ``target``
    unchanged — the first-attempt no-op the gang-restart contract needs."""
    if fmt.latest_step(root) is None:
        return target
    return restore_pytree(root, target, mesh=mesh, verify=verify,
                          dtype_policy=dtype_policy)
