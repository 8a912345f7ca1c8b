"""Async snapshot engine: the counterpart of :mod:`tony_tpu.ckpt.snapshot`.

A save is split at the device/host boundary, and only the first part
stalls the train loop:

* **stage** (synchronous, inside :meth:`AsyncCheckpointer.save`): every
  chunk this process owns is copied on the caller's stream into ONE
  device staging buffer, already in the reference's layout (flax's
  ``[in, out]`` kernels: the transpose runs here, on the card). The port's
  step updates parameters and moments in place, where the JAX step
  donates them, so ``save`` returns only once this copy has completed:
  from then on the loop may overwrite the state.
* **extract** (writer thread): a side stream copies the staging buffer
  into a slot of pinned host arenas (allocated once per slot, reused), a
  256 MiB piece at a time: device→host copies share one copy engine in
  issue order, so the loop's own small reads (a logged loss) wait behind
  one piece, never behind the whole state. The staging buffer is
  released once this copy has read it, so between saves the card holds
  no second copy of the state; the next save allocates it again.
  **In pieces**: where the owned chunks do not fit in the card's free
  memory (``torch.cuda.mem_get_info`` and the allocator's cached bytes,
  less a margin), ``save`` stages them through one device buffer of that
  size (at least the largest chunk), piece by piece, and copies each
  piece into the pinned slot before it stages the next; it returns once
  the last piece is on the host, so its stall grows to the state's
  device→host time. The bytes are the same either way;
* **write + commit** (writer thread): serializes the chunks through
  :mod:`tony_tpu_torch.ckpt.format` and commits the step. ``buffers``
  host slots are kept: a save issued while one write is in flight
  proceeds into the next slot; only a save that finds every slot busy
  stalls until one frees.

Ownership is the reference's ``replica_id == 0`` rule. A replicated leaf
is written by rank 0 alone. A ZeRO-3 state's sharded leaf (a tensor with
a :class:`~tony_tpu_torch.parallel.layout.Layout`) is written slice by
slice, each rank of data index 0 writing its own fsdp shard: so a rank
stages only its 1/fsdp of the sharded state. A rank that owns nothing
writes an empty shard file and waits for the global commit. Tensors on
the CPU are copied synchronously and nothing is pinned.

The stall, the extract, the write and the payload are recorded per save
through :func:`tony_tpu_torch.profiler.record_ckpt`. Writer errors never
vanish: they surface on the next ``save``/``wait``.

The manifest keys leaves by the reference's ``jax.tree_util.keystr``
paths. The port's trees are nested dicts (``['key']``, sorted),
lists/tuples (``[i]``), NamedTuples and :class:`Attrs` nodes
(``.name``), with tensors, numpy arrays, Python scalars and
:class:`LeafView`\\ s as leaves; :func:`leaf_paths` spells their paths as
``keystr`` does.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, \
    Tuple

import numpy as np
import torch
import torch.distributed as td

from tony_tpu_torch import profiler
from tony_tpu_torch.ckpt import format as fmt
from tony_tpu_torch.parallel.layout import layout_of

# Pinned host arenas: the caching host allocator rounds every request up
# to a power of two, so a slot is cut into power-of-two arenas (1 GiB, or
# the next power of two of a larger chunk) instead of one rounded block.
_ARENA = 1 << 30
_ALIGN = 256
# Host memory left unpinned when sizing the slots.
_HOST_MARGIN = 16 << 30
# Device→host copies are issued this many bytes at a time.
_D2H_PIECE = 256 << 20
# Device memory a save leaves free beside its staging buffer.
_DEVICE_MARGIN = 2 << 30
# The staging budget in bytes, None to size it from the card's free
# memory (tests force a small one).
_STAGING_BUDGET: Optional[int] = None


class Attrs(dict):
    """A tree node whose children are named attributes (a flax struct or
    an optax NamedTuple in the reference): keystr ``.name``, in insertion
    order. Attribute access reads the children."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


@dataclass(eq=False)
class LeafView:
    """One leaf of the reference's tree over the port's tensors.

    ``shape`` and ``dtype`` are the leaf's in the reference's layout;
    ``parts`` cover it, each ``(start, tensor, perm)``: the tensor's
    values at offset ``start``, its axes permuted by ``perm`` when it is
    not None (a torch ``[out, in]`` weight standing for flax's ``[in,
    out]`` kernel is ``(1, 0)``, an OIHW conv weight standing for flax's
    HWIO kernel ``(2, 3, 1, 0)``), with leading unit dims where the leaf
    stacks layers (layer ``l`` of a scanned ``[L, in, out]`` kernel is the
    part at ``(l, 0, 0)``). A checkpoint writes one chunk per part; a
    restore fills the parts in place, through the same permuted view.

    A tensor with a sharded layout (a ZeRO-3 shard) is a part at its
    slice's offset in the global leaf; ``spec`` is then the leaf's spec
    (for the manifest) and ``replica`` the rank's data index, and only
    replica 0 writes the part. ``replica`` None: the leaf is replicated
    and rank 0 writes it."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    parts: List[Tuple[Tuple[int, ...], torch.Tensor,
                      Optional[Tuple[int, ...]]]]
    spec: Optional[Tuple[Any, ...]] = None
    replica: Optional[int] = None

    @classmethod
    def of(cls, t: torch.Tensor, transpose: bool = False,
           perm: Optional[Sequence[int]] = None) -> "LeafView":
        """``t`` as a leaf, its axes reversed (``transpose``) or permuted
        by ``perm``."""
        if transpose:
            perm = tuple(range(t.dim()))[::-1]
        perm = None if perm is None else tuple(perm)
        lay = layout_of(t)
        if lay is None or not lay.sharded:
            return cls(_permuted(tuple(t.shape), perm), t.dtype,
                       [((0,) * t.dim(), t, perm)])
        shape, start = tuple(lay.shape), lay.offsets()
        spec = tuple(lay.spec) + (None,) * (len(shape) - len(lay.spec))
        # A pipeline stage's layer lies at its index of the stacked dim,
        # which the tensor (and its permutation) drops.
        lead = 1 if lay.stage_layer else 0
        shape, start, spec = (x[:lead] + _permuted(x[lead:], perm)
                              for x in (shape, start, spec))
        # A rank whose slice of a padded leaf lies wholly in the pad owns
        # no part of it.
        parts = [(start, t, perm)] if t.numel() else []
        return cls(shape, t.dtype, parts, spec, lay.replica)

    @classmethod
    def stacked(cls, ts: Sequence[torch.Tensor],
                transpose: bool = False) -> "LeafView":
        """The layers ``ts`` stacked on a new leading dim; the layers of a
        pipeline stage (each already a part of the whole stacked leaf)
        as that leaf, whose other layers other ranks hold."""
        views = [LeafView.of(t, transpose) for t in ts]
        inner = views[0].shape
        if len(inner) > ts[0].dim():
            if any(v.shape != inner for v in views):
                raise ValueError(f"stacked leaf: stage layers of shapes "
                                 f"{sorted({v.shape for v in views})}")
            return cls(inner, ts[0].dtype,
                       [part for v in views for part in v.parts],
                       views[0].spec, views[0].replica)
        for t, v in zip(ts, views):
            if v.shape != inner:
                raise ValueError(f"stacked leaf: part of shape "
                                 f"{tuple(t.shape)} vs {inner}")
        spec = None if views[0].spec is None else (None,) + views[0].spec
        return cls((len(ts),) + inner, ts[0].dtype,
                   [((i,) + tuple(start), t, pm)
                    for i, v in enumerate(views)
                    for start, t, pm in v.parts], spec, views[0].replica)

    def owned_by(self, process: int) -> bool:
        """Whether ``process`` writes this leaf's parts."""
        return process == 0 if self.replica is None else self.replica == 0


def _permuted(xs: Tuple[Any, ...], perm: Optional[Tuple[int, ...]]
              ) -> Tuple[Any, ...]:
    return xs if perm is None else tuple(xs[i] for i in perm)


def as_leaf(leaf: Any) -> Any:
    """A tensor with a sharded layout as its :class:`LeafView`; any other
    leaf as it is."""
    if isinstance(leaf, torch.Tensor):
        lay = layout_of(leaf)
        if lay is not None and lay.sharded:
            return LeafView.of(leaf)
    return leaf


def _parts(leaf: Any) -> List[Tuple[Tuple[int, ...], torch.Tensor,
                                    Optional[Tuple[int, ...]]]]:
    if isinstance(leaf, LeafView):
        return leaf.parts
    return [((0,) * leaf.dim(), leaf, None)]


def _oriented(t: torch.Tensor, perm: Optional[Tuple[int, ...]]
              ) -> torch.Tensor:
    """The part's values in the reference's layout (a view)."""
    return t if perm is None else t.permute(perm)


def _region(leaf_shape: Sequence[int], t: torch.Tensor,
            perm: Optional[Tuple[int, ...]]) -> Tuple[int, ...]:
    """A part's extent in the leaf: its oriented shape with leading unit
    dims up to the leaf's rank."""
    shape = _permuted(tuple(t.shape), perm)
    return (1,) * (len(leaf_shape) - len(shape)) + shape


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """``(keystr piece, child)`` pairs of an inner node; None for a leaf."""
    if node is None:
        return []
    if isinstance(node, Attrs):
        return [(f".{k}", v) for k, v in node.items()]
    if isinstance(node, Mapping):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _flatten(node: Any, path: str, out: List[Tuple[str, Any]]) -> None:
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for key, child in kids:
        _flatten(child, path + key, out)


def leaf_paths(tree: Any) -> Tuple[List[str], List[Any], Any]:
    """Stable leaf addressing: ``jax.tree_util.keystr`` paths in flatten
    order — the join key between a manifest and any same-structured tree.
    Returns ``(paths, leaves, treedef)``; the treedef is the tree itself,
    read by :func:`tree_unflatten`."""
    flat: List[Tuple[str, Any]] = []
    _flatten(tree, "", flat)
    return [p for p, _ in flat], [leaf for _, leaf in flat], tree


def _rebuild(node: Any, leaves: Iterator[Any]) -> Any:
    if node is None:
        return None
    if isinstance(node, Attrs):
        out = type(node).__new__(type(node))
        out.__dict__.update(node.__dict__)
        for k, v in node.items():
            out[k] = _rebuild(v, leaves)
        return out
    if isinstance(node, Mapping):
        return {k: _rebuild(node[k], leaves) for k in sorted(node)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*[_rebuild(getattr(node, f), leaves)
                            for f in node._fields])
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, leaves) for v in node)
    return next(leaves)


def tree_unflatten(treedef: Any, leaves: Sequence[Any]) -> Any:
    """The tree ``treedef`` with its leaves replaced, in flatten order."""
    return _rebuild(treedef, iter(leaves))


def _is_saveable(leaf: Any) -> bool:
    """Array-like leaves (tensors, leaf views, numpy arrays and scalars,
    Python scalars) are checkpointed; everything else passes through
    restore untouched."""
    if isinstance(leaf, (bool, int, float, complex)):
        return True
    return hasattr(leaf, "shape") and hasattr(leaf, "dtype")


def _leaf_meta(path: str, leaf: Any) -> Dict[str, Any]:
    if isinstance(leaf, (torch.Tensor, LeafView)):
        shape, dtype = tuple(leaf.shape), leaf.dtype
    else:
        arr = np.asarray(leaf)
        shape, dtype = arr.shape, arr.dtype
    return {"path": path, "shape": [int(s) for s in shape],
            "dtype": fmt.dtype_name(dtype),
            "spec": fmt.spec_to_json(getattr(leaf, "spec", None))}


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's values as a numpy array of their storage dtype
    (bfloat16 as its uint16 bytes); ``t`` must own its memory."""
    name = fmt.dtype_name(t.dtype)
    storage = fmt.dtype_from_name(name)
    if storage.name != name:
        return t.view(torch.int16).numpy().view(storage)
    return t.numpy()


def _process_index() -> int:
    return td.get_rank() if td.is_available() and td.is_initialized() else 0


def _process_count() -> int:
    return td.get_world_size() if td.is_available() and td.is_initialized() \
        else 1


def _mem_available() -> Optional[int]:
    """``MemAvailable`` of ``/proc/meminfo`` in bytes (None elsewhere)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


@dataclass
class Snapshot:
    """One step's host-side copy of this process's owned chunks. On the
    card the chunks are views of a pinned host slot that
    :meth:`copy_out` fills from the staging buffer; ``copied`` is set once
    their bytes are valid."""
    step: int
    leaves: List[Dict[str, Any]]                 # manifest leaf metadata
    chunks: List[Tuple[int, List[int], np.ndarray]]
    mesh: Optional[Dict[str, Any]]
    nbytes: int = 0
    extract_s: float = 0.0
    stall_s: float = 0.0
    stage_s: float = 0.0
    d2h_s: float = 0.0
    alloc_s: float = 0.0
    write_s: float = 0.0
    pieces: int = 0                              # device staging pieces
    staging_nbytes: int = 0                      # device staging buffer
    budget_nbytes: int = 0                       # the budget it fit in
    slot: Optional[int] = None
    d2h: Optional[Tuple[Any, ...]] = None        # the pending copy-out
    copied: threading.Event = field(default_factory=threading.Event)
    done: threading.Event = field(default_factory=threading.Event)

    def copy_out(self) -> None:
        """Copy the staged chunks into their pinned host slot, one piece
        in flight at a time, and time the staging and the copy (a no-op
        for a snapshot copied at extraction)."""
        if self.d2h is not None:
            staging, arenas, start, staged = self.d2h
            self.d2h = None
            side = staging.side
            first = torch.cuda.Event(enable_timing=True)
            last = torch.cuda.Event(enable_timing=True)
            try:
                side.wait_event(staged)
                first.record(side)
                base = 0
                with torch.cuda.stream(side):
                    for arena, used in zip(arenas, staging.used):
                        for off in range(0, used, _D2H_PIECE):
                            n = min(_D2H_PIECE, used - off)
                            arena[off:off + n].copy_(
                                staging.dev[base + off:base + off + n],
                                non_blocking=True)
                            piece = torch.cuda.Event()
                            piece.record(side)
                            piece.synchronize()
                        base += used
                    last.record(side)
                last.synchronize()
            finally:
                staging.release()
            self.stage_s = start.elapsed_time(staged) / 1e3
            self.d2h_s = first.elapsed_time(last) / 1e3
            self.extract_s = self.stage_s + self.d2h_s
        self.copied.set()


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def plan_arenas(sizes: Sequence[int]) -> Tuple[List[int], List[int],
                                                List[Tuple[int, int]]]:
    """Pack chunks of ``sizes`` bytes (in order, 256-byte aligned) into
    power-of-two host arenas of up to 1 GiB (a larger chunk gets its own):
    ``(capacity per arena, bytes used per arena, (arena, offset) per
    chunk)`` — one host slot's allocations."""
    aligned = [_aligned(n) for n in sizes]
    caps: List[int] = []
    used: List[int] = []
    place: List[Tuple[int, int]] = []
    left = sum(aligned)
    for n in aligned:
        if not used or used[-1] + n > caps[-1]:
            want = max(n, min(_ARENA, left))
            caps.append(1 << max(0, want - 1).bit_length())
            used.append(0)
        place.append((len(used) - 1, used[-1]))
        used[-1] += n
        left -= n
    return caps, used, place


def plan_pieces(sizes: Sequence[int], budget: int
                ) -> Tuple[int, List[List[int]]]:
    """Chunks of ``sizes`` bytes (in order, 256-byte aligned) grouped into
    the pieces of a staging buffer of ``budget`` bytes, or of the largest
    chunk where that is larger: ``(buffer bytes, chunk indices per
    piece)``."""
    aligned = [_aligned(n) for n in sizes]
    cap = max([int(budget)] + aligned)
    pieces: List[List[int]] = []
    used = cap
    for i, n in enumerate(aligned):
        if used + n > cap:
            pieces.append([])
            used = 0
        pieces[-1].append(i)
        used += n
    return cap, pieces


def staging_budget(device: torch.device) -> int:
    """The bytes a save may stage on ``device`` at once: the card's free
    memory and the allocator's cached bytes, less a margin."""
    if _STAGING_BUDGET is not None:
        return int(_STAGING_BUDGET)
    free, _ = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)
    return free + cached - _DEVICE_MARGIN


class _Staging:
    """The transfer buffers of one checkpointer on one card: one device
    buffer the owned chunks are staged into, allocated by each save and
    released once its copy-out has read it (a save in pieces releases it
    before it returns), and per host slot a list of pinned arenas that
    buffer is copied into, allocated on first use and kept while the
    chunk layout holds (pinning costs seconds a slot, the device buffer
    milliseconds)."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.side = torch.cuda.Stream(device)
        self.key: Optional[Tuple[int, ...]] = None
        self.slots = slots
        self.place: List[Tuple[int, int]] = []   # (arena, offset) per chunk
        self.caps: List[int] = []
        self.used: List[int] = []
        self.dev: Optional[torch.Tensor] = None
        self.host: List[Optional[List[torch.Tensor]]] = []
        # Set once the last snapshot's copy-out has read self.dev.
        self.busy: Optional[threading.Event] = None

    def layout(self, sizes: Sequence[int]) -> None:
        key = tuple(sizes)
        if key != self.key:
            self.caps, self.used, self.place = plan_arenas(sizes)
            self.key = key
            self.drop()
            self.host = [None] * self.slots

    def device_buffer(self, nbytes: int) -> torch.Tensor:
        if self.dev is None or self.dev.numel() != max(1, nbytes):
            self.dev = None
            self.dev = torch.empty(max(1, nbytes), dtype=torch.uint8,
                                   device=self.device)
        return self.dev

    def release(self) -> None:
        """Free the device buffer (its copy-out has completed)."""
        self.dev = None

    def dev_view(self, i: int, nbytes: int) -> torch.Tensor:
        arena, off = self.place[i]
        base = sum(self.used[:arena]) + off
        return self.dev[base:base + nbytes]

    def host_view(self, arenas: List[torch.Tensor], i: int,
                  nbytes: int) -> torch.Tensor:
        arena, off = self.place[i]
        return arenas[arena][off:off + nbytes]

    def host_arenas(self, slot: int) -> List[torch.Tensor]:
        if self.host[slot] is None:
            self.host[slot] = [torch.empty(c, dtype=torch.uint8,
                                           pin_memory=True)
                               for c in self.caps]
        return self.host[slot]

    def drop(self) -> None:
        if self.busy is not None:
            self.busy.wait()
        self.dev = None
        self.host = []
        self.busy = None


def _owned_parts(tree: Any, process: int = 0) -> Tuple[
        List[Dict[str, Any]],
        List[Tuple[int, Tuple[int, ...], Any, Optional[Tuple[int, ...]],
                   Tuple[int, ...]]]]:
    """Manifest metas of every saveable leaf, and the parts ``process``
    writes, as ``(leaf index, start, tensor or host value, perm,
    region)``."""
    paths, leaves, _ = leaf_paths(tree)
    metas: List[Dict[str, Any]] = []
    parts = []
    for path, leaf in zip(paths, leaves):
        if not _is_saveable(leaf):
            continue
        leaf = as_leaf(leaf)
        metas.append(_leaf_meta(path, leaf))
        li = len(metas) - 1
        owner = leaf.owned_by(process) if isinstance(leaf, LeafView) \
            else process == 0
        if not owner:
            continue
        if isinstance(leaf, (torch.Tensor, LeafView)):
            shape = tuple(leaf.shape)
            for start, t, perm in _parts(leaf):
                parts.append((li, tuple(start), t.detach(), perm,
                              _region(shape, t, perm)))
        else:
            arr = np.asarray(leaf)
            parts.append((li, (0,) * arr.ndim, arr, None, arr.shape))
    return metas, parts


def _copy_to_host(value: Any, perm: Optional[Tuple[int, ...]],
                  region: Tuple[int, ...]) -> np.ndarray:
    """A synchronous host copy of one part, in the reference's layout."""
    if isinstance(value, np.ndarray):
        return np.array(value, copy=True)
    t = _oriented(value, perm).to("cpu", copy=True)
    t = t.contiguous().reshape(region)
    return _host_array(t)


def _stage_in_pieces(staging: _Staging, parts: List[Any], card: List[int],
                     sizes: List[int], arenas: List[torch.Tensor],
                     budget: int, snap: "Snapshot") -> None:
    """Stage the card chunks through one buffer of at most ``budget``
    bytes (at least the largest chunk), piece by piece, each piece copied
    into its pinned host arenas before the next is staged; returns once
    the last piece is on the host and the buffer is freed."""
    cap, pieces = plan_pieces(sizes, budget)
    largest = max(_aligned(n) for n in sizes)
    while True:
        try:
            dev = staging.device_buffer(cap)
            break
        except torch.cuda.OutOfMemoryError:
            # The cached bytes were fragmented: halve the buffer.
            staging.release()
            if cap <= largest:
                raise
            cap, pieces = plan_pieces(sizes, max(cap // 2, largest))
    cur = torch.cuda.current_stream(staging.device)
    stage_ms = d2h_ms = 0.0
    try:
        with torch.no_grad():
            for piece in pieces:
                marks = [torch.cuda.Event(enable_timing=True)
                         for _ in range(3)]
                marks[0].record(cur)
                offs, off = [], 0
                for j in piece:
                    _, _, t, perm, _ = parts[card[j]]
                    src = _oriented(t, perm)
                    dev[off:off + sizes[j]].view(t.dtype).view(
                        src.shape).copy_(src)
                    offs.append(off)
                    off += _aligned(sizes[j])
                marks[1].record(cur)
                for j, o in zip(piece, offs):
                    staging.host_view(arenas, j, sizes[j]).copy_(
                        dev[o:o + sizes[j]], non_blocking=True)
                marks[2].record(cur)
                marks[2].synchronize()      # the buffer is free again
                stage_ms += marks[0].elapsed_time(marks[1])
                d2h_ms += marks[1].elapsed_time(marks[2])
    finally:
        staging.release()
    snap.pieces, snap.staging_nbytes = len(pieces), cap
    snap.stage_s, snap.d2h_s = stage_ms / 1e3, d2h_ms / 1e3


def extract_snapshot(tree: Any, step: int, *,
                     staging: Optional[_Staging] = None,
                     slot: Optional[int] = None,
                     process: Optional[int] = None) -> Snapshot:
    """Copy this process's owned chunks of ``tree`` off the live state.

    Returns once the live tensors may be overwritten. Without ``staging``
    every chunk is copied to the host synchronously. With it (the
    checkpointer's, on the card), card tensors are staged into its device
    buffer on the current stream — ``save``'s stall — and the chunks are
    views of pinned host slot ``slot``, which :meth:`Snapshot.copy_out`
    fills; where they do not fit in :func:`staging_budget`, they are
    staged and copied into the slot piece by piece before this returns
    (:func:`plan_pieces`)."""
    t0 = time.perf_counter()
    proc = _process_index() if process is None else process
    metas, parts = _owned_parts(tree, proc)
    chunks: List[Tuple[int, List[int], np.ndarray]] = [None] * len(parts)
    card = [i for i, p in enumerate(parts)
            if staging is not None and isinstance(p[2], torch.Tensor)
            and p[2].device.type == "cuda"]
    snap = Snapshot(step=int(step), leaves=metas, chunks=[], mesh=None)
    if card:
        sizes = [parts[i][2].numel() * parts[i][2].element_size()
                 for i in card]
        if staging.busy is not None:
            staging.busy.wait()           # the last copy-out read the buffer
        t_alloc = time.perf_counter()
        staging.layout(sizes)
        whole = sum(staging.used)
        snap.budget_nbytes = staging_budget(staging.device)
        fits = whole <= snap.budget_nbytes
        if fits:
            staging.device_buffer(whole)
            snap.pieces, snap.staging_nbytes = 1, whole
        snap.alloc_s = time.perf_counter() - t_alloc
        if fits:
            cur = torch.cuda.current_stream(staging.device)
            start = torch.cuda.Event(enable_timing=True)
            staged = torch.cuda.Event(enable_timing=True)
            start.record(cur)
            with torch.no_grad():
                for j, (i, n) in enumerate(zip(card, sizes)):
                    _, _, t, perm, _ = parts[i]
                    src = _oriented(t, perm)
                    dst = staging.dev_view(j, n).view(t.dtype).view(
                        src.shape)
                    dst.copy_(src)
            staged.record(cur)
        t_alloc = time.perf_counter()
        arenas = staging.host_arenas(slot)
        snap.alloc_s += time.perf_counter() - t_alloc
        if fits:
            staging.dev.record_stream(staging.side)
            staging.busy = snap.copied
            snap.d2h = (staging, arenas, start, staged)
        else:
            _stage_in_pieces(staging, parts, card, sizes, arenas,
                             snap.budget_nbytes, snap)
        for j, (i, n) in enumerate(zip(card, sizes)):
            li, start_off, t, _, region = parts[i]
            storage = fmt.dtype_from_name(fmt.dtype_name(t.dtype))
            host = staging.host_view(arenas, j, n).numpy().view(storage)
            chunks[i] = (li, list(start_off), host.reshape(region))
        if fits:
            staged.synchronize()
    for i, (li, start_off, value, perm, region) in enumerate(parts):
        if chunks[i] is None:
            chunks[i] = (li, list(start_off),
                         _copy_to_host(value, perm, region))
    snap.chunks = chunks
    snap.nbytes = sum(int(a.nbytes) for _, _, a in chunks)
    snap.extract_s = time.perf_counter() - t0
    if snap.d2h is None:
        snap.copied.set()
    return snap


def write_snapshot(root: str | Path, snap: Snapshot, *,
                   process_index: Optional[int] = None,
                   num_processes: Optional[int] = None,
                   keep: int = 0,
                   barrier_timeout_s: float = 300.0) -> Optional[Path]:
    """Serialize + commit one snapshot (blocking), copying it out first if
    it is still staged. Every process writes its shard file; process 0
    additionally merges the sidecars into the manifest and atomically
    commits the step, then prunes old steps."""
    proc = _process_index() if process_index is None else process_index
    n = _process_count() if num_processes is None else num_processes
    snap.copy_out()
    staging = fmt.tmp_dir(root, snap.step)
    fmt.write_process_file(staging, proc, snap.chunks)
    if proc != 0:
        # Block until process 0's manifest rename lands: a blocking save
        # must mean GLOBALLY committed on every process.
        fmt.wait_committed(root, snap.step, barrier_timeout_s)
        return None
    path = fmt.commit(root, snap.step, leaves=snap.leaves, mesh=snap.mesh,
                      num_processes=n, barrier_timeout_s=barrier_timeout_s)
    if keep:
        fmt.prune(root, keep)
    return path


class AsyncCheckpointer:
    """Double-buffered async checkpoint writer bound to one directory.

    ``save(state, step)`` stalls the caller only for slot acquisition plus
    the device-side staging copy; the device→host copy (the writer
    thread's first act on a snapshot), serialization, fsync and the atomic
    commit overlap the steps that follow.
    ``save(..., block=True)`` waits for the commit.

    One live instance per process per directory: construction sweeps torn
    staging dirs from crashed predecessors (process 0 only), then, in a
    process group of several ranks, waits at a barrier for every rank, so
    that no rank writes into a staging dir the sweep still removes (every
    rank constructs its checkpointer, as ``train_loop`` does).
    ``buffers`` host slots of pinned memory are allocated on the first
    save that needs each, as many as fit in the host's available memory
    (at least one)."""

    def __init__(self, directory: str | Path, *, keep: int = 3,
                 buffers: int = 2, process_index: Optional[int] = None,
                 num_processes: Optional[int] = None,
                 barrier_timeout_s: float = 300.0):
        self.directory = Path(directory)
        self.keep = keep
        self.buffers = max(1, buffers)
        self.process_index = _process_index() if process_index is None \
            else process_index
        self.num_processes = _process_count() if num_processes is None \
            else num_processes
        self.barrier_timeout_s = barrier_timeout_s
        self._free: Optional["queue.Queue[int]"] = None
        self._staging: Optional[_Staging] = None
        self._q: "queue.Queue[Optional[Snapshot]]" = queue.Queue()
        self._err_lock = threading.Lock()    # guards _err (writer/caller)
        self._err: Optional[BaseException] = None
        self._closed = False
        self.stats: Dict[str, Any] = {
            "saves": 0, "stall_s": [], "extract_s": [], "write_s": [],
            "nbytes": 0, "slots": 0}
        if self.process_index == 0:
            fmt.clean_stale(self.directory)
        if self.num_processes > 1 and td.is_available() \
                and td.is_initialized():
            td.barrier()
        self._writer = threading.Thread(target=self._run, daemon=True,
                                        name="ckpt-writer")
        self._writer.start()

    # -- background side ---------------------------------------------------
    def _run(self) -> None:
        while True:
            snap = self._q.get()
            if snap is None:
                self._q.task_done()
                return
            try:
                snap.copy_out()
                t0 = time.perf_counter()
                write_snapshot(
                    self.directory, snap,
                    process_index=self.process_index,
                    num_processes=self.num_processes, keep=self.keep,
                    barrier_timeout_s=self.barrier_timeout_s)
                write_s = snap.write_s = time.perf_counter() - t0
                self.stats["extract_s"].append(snap.extract_s)
                self.stats["write_s"].append(write_s)
                profiler.record_ckpt(
                    "async_save", step=snap.step, stall_s=snap.stall_s,
                    extract_s=snap.extract_s, write_s=write_s,
                    nbytes=snap.nbytes, n_chunks=len(snap.chunks),
                    keep=self.keep, stage_s=snap.stage_s,
                    d2h_s=snap.d2h_s, alloc_s=snap.alloc_s,
                    pieces=snap.pieces, staging_nbytes=snap.staging_nbytes,
                    budget_nbytes=snap.budget_nbytes)
            except BaseException as e:  # noqa: BLE001 — surfaced on save/wait
                with self._err_lock:
                    self._err = e
            finally:
                snap.chunks = []
                snap.copied.set()
                snap.done.set()
                self._free.put(snap.slot)
                self._q.task_done()

    def _raise_pending(self) -> None:
        with self._err_lock:
            err, self._err = self._err, None
        if err is not None:
            raise RuntimeError("checkpoint writer failed") from err

    def _acquire(self, tree: Any) -> Tuple[int, Optional[_Staging]]:
        """A free slot (blocking while every slot is busy) and, when this
        process stages card tensors, the staging buffers. Sizes the slot
        count on the first save: each slot holds the pinned copy of every
        owned card chunk."""
        card = 0
        device = None
        for _, _, t, _, _ in _owned_parts(tree, self.process_index)[1]:
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                card += t.numel() * t.element_size()
                device = t.device
        if self._free is None:
            slots = self.buffers
            avail = _mem_available() if card else None
            if avail is not None:
                slots = max(1, min(slots, (avail - _HOST_MARGIN) // card))
            self._free = queue.Queue()
            for s in range(slots):
                self._free.put(s)
            self.stats["slots"] = slots
        slot = self._free.get()
        if not card:
            return slot, None
        if self._staging is None or self._staging.device != device:
            self._staging = _Staging(device, self.stats["slots"])
        return slot, self._staging

    # -- caller side -------------------------------------------------------
    def save(self, state: Any, step: Optional[int] = None,
             block: bool = False) -> Snapshot:
        """Snapshot ``state`` and enqueue the write. Returns once the live
        tensors may be overwritten (the staging copy is complete); the
        commit lands asynchronously unless ``block``."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._raise_pending()
        if step is None:
            step_leaf = getattr(state, "step", None)
            step = int(step_leaf) if step_leaf is not None else 0
        t0 = time.perf_counter()
        slot, staging = self._acquire(state)
        try:
            snap = extract_snapshot(state, step, staging=staging, slot=slot,
                                    process=self.process_index)
        except BaseException:
            self._free.put(slot)
            raise
        snap.slot = slot
        snap.stall_s = time.perf_counter() - t0
        self.stats["saves"] += 1
        self.stats["stall_s"].append(snap.stall_s)
        self.stats["nbytes"] = snap.nbytes
        self._q.put(snap)
        if block:
            snap.done.wait()
            self._raise_pending()
        return snap

    def wait(self) -> None:
        """Block until every enqueued save has committed (or failed)."""
        self._q.join()
        self._raise_pending()

    def latest_step(self) -> Optional[int]:
        return fmt.latest_step(self.directory)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._writer.join(timeout=self.barrier_timeout_s + 60.0)
        if self._staging is not None:
            self._staging.drop()
            self._staging = None
        self._raise_pending()
