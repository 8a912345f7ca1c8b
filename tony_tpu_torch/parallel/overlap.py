"""Gradient buckets and microbatch accumulation: the counterpart of
:mod:`tony_tpu.parallel.overlap`.

* :class:`GradBuckets` — the size-targeted partition of a parameter list
  into flat per-dtype buckets, by the JAX planner's rule;
  :meth:`GradBuckets.plan_sharded` is the ZeRO-3 planner: leaves with an
  fsdp-sharded dim are packed *shard-major* (chunk *f* of a bucket is
  every member leaf's shard *f*), so one ``reduce_scatter`` over the
  fsdp group leaves each rank exactly its shard of the summed grads;
  leaves whose sharded dim does not divide the fsdp size are zero-padded
  into buckets of their own;
* :class:`ResidentBuckets` — parameters and their grads living in a
  plan's flat buffers, so backward accumulates straight into the buckets
  and an update kernel writes them in place; :class:`ShardBuckets` — a
  ZeRO-3 plan's local parameters (each rank's shards) living in its
  bucket buffers, so a bucket's forward gather and its fused update read
  and write one buffer;
* :func:`microbatch_grads` — gradient accumulation over microbatches,
  then either the leaf grads (the unfused tail) or the fused optimizer's
  in-place update (the fused tail). With a mesh, each microbatch gathers
  the ZeRO-3 parameters (:class:`~tony_tpu_torch.parallel.sched
  .GatherPlan`; ``gather="bucketed"`` through the gather window of
  :mod:`~tony_tpu_torch.parallel.window`, which frees each bucket after
  use, gathers it again for the backward and reduces each bucket as its
  grads land) and reduces its grads bucket by bucket over the gradient
  sync group (:func:`reduce_schedule`);
* :func:`fsdp_param_specs` — a ZeRO-3 layout detected from the
  parameters' :class:`~tony_tpu_torch.parallel.layout.Layout`\\ s: the
  layout the state was created with is the contract, not a flag.

The reference issues its collectives inside one traced ``lax.scan`` for
XLA to overlap; the port issues them eagerly, per microbatch and bucket,
through ``torch.distributed``. The hierarchical (multi-slice) reduce is
not ported (ROADMAP.md, queue 1 item 8).
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch
import torch.distributed as td

from tony_tpu_torch import profiler
from tony_tpu_torch.parallel import DATA, EXPERT, FSDP, MODEL, SEQ, SLICE
from tony_tpu_torch.parallel.layout import Layout, layout_of, set_layout

_log = logging.getLogger(__name__)

# The JAX planner's default (Horovod's fusion buffer is 64 MiB; smaller
# buckets let the first reduction start sooner after the first grads).
DEFAULT_BUCKET_BYTES = 4 << 20

_LATER = "ROADMAP.md, queue 1 item 8"


def sync_axes(mesh: Any) -> Tuple[str, ...]:
    """The gradient-sync mesh axes: the slice axis plus both DP axes, in
    mesh order, as the batch is placed, and the seq axis where the mesh
    has one (size > 1): every parameter is replicated over ``seq`` and
    the batch split over it, so a leaf's grads are summed over it too.
    ``model`` never joins (a tensor-parallel leaf's shard is reduced
    over the data and seq axes only)."""
    return (SLICE, DATA, FSDP) + ((SEQ,) if mesh.shape[SEQ] > 1 else ())


def sync_size(mesh: Any) -> int:
    """Rank count of the gradient-sync group (the product of the slice, DP
    and seq axes)."""
    return math.prod(mesh.shape[a] for a in sync_axes(mesh))


class _Leaf(NamedTuple):
    shape: Tuple[int, ...]
    dtype: Any


def global_leaves(params: Sequence[torch.Tensor]) -> List[_Leaf]:
    """Each parameter's GLOBAL shape and dtype (a shard's layout gives the
    global shape): what the reference's planner reads off its global
    arrays."""
    out = []
    for p in params:
        lay = layout_of(p)
        out.append(_Leaf(tuple(lay.shape) if lay is not None
                         else tuple(p.shape), p.dtype))
    return out


def _names(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def fsdp_param_specs(params: Sequence[torch.Tensor], mesh: Any
                     ) -> Optional[List[Tuple[Any, ...]]]:
    """Detect a ZeRO-3 parameter layout from the parameters' layouts: a
    list of specs (one per parameter, ``()`` for replicated ones, size-1
    mesh axes stripped) when at least one is sharded over the fsdp axis
    of a mesh with ``fsdp > 1``, else None."""
    if mesh is None or mesh.shape[FSDP] <= 1:
        return None
    specs = [strip_spec(lay.spec if (lay := layout_of(p)) is not None
                        else (), mesh) for p in params]
    found = any(FSDP in _names(e) for spec in specs for e in spec)
    return specs if found else None


def strip_spec(spec: Any, mesh: Any) -> Tuple[Any, ...]:
    """``spec`` without the mesh axes of size 1 (a dim over ``model`` on
    a mesh with ``tp=1`` is replicated in fact): the engine plans off
    real sharding."""
    entries = []
    for entry in tuple(spec or ()):
        kept = tuple(a for a in _names(entry) if mesh.shape.get(a, 1) > 1)
        entries.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(entries)


def _shard_dim(spec: Any, shape: Tuple[int, ...], shard_axis: str,
               shard_size: int) -> Optional[int]:
    """The leaf dim sharded over ``shard_axis`` per ``spec`` (None when
    replicated). Raises on layouts the engine cannot own: sharding over
    any other mesh axis, or fsdp combined with another axis on one dim.
    A sharded dim not divisible by the shard count is legal — the planner
    pads it into its scatter bucket."""
    dim: Optional[int] = None
    for d, entry in enumerate(tuple(spec or ())):
        names = _names(entry)
        if not names:
            continue
        if shard_axis in names:
            if len(names) > 1:
                raise ValueError(
                    f"param dim {d} sharded over {names}: the accum engine "
                    f"supports {shard_axis!r} alone on a dim")
            if dim is not None:
                raise ValueError(
                    f"param sharded over {shard_axis!r} on two dims "
                    f"({dim} and {d}) — not a ZeRO-3 layout")
            dim = d
        else:
            raise ValueError(
                f"param dim {d} sharded over {names}: only {shard_axis!r} "
                f"is supported inside the accum engine (model/pipe/seq "
                f"axes belong to later slices)")
    return dim


def _itemsize(dtype: Any) -> int:
    return dtype.itemsize


@dataclass(frozen=True)
class GradBuckets:
    """A size-targeted partition of a parameter list into buckets: every
    leaf lands in exactly one bucket; leaves of one dtype pack together (a
    bucket is one concatenated 1-D buffer) in list order until adding the
    next leaf would cross ``threshold`` bytes; a single leaf bigger than
    the threshold gets a bucket of its own. Leaves are grouped by dtype in
    order of first appearance, as the JAX planner groups its flattened
    tree. The port plans over ``model.parameters()`` order.

    A plan from :meth:`plan_sharded` carries the ZeRO-3 layout as the
    reference's does: ``shard_dims[i]`` (None for replicated leaves),
    scatter buckets (``bucket_scatter``) packed shard-major, and uneven
    leaves zero-padded on their shard dim (``shard_pads``) into buckets of
    their own (``bucket_padded``)."""

    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[Any, ...]
    buckets: Tuple[Tuple[int, ...], ...]   # leaf indices per bucket
    bucket_nbytes: Tuple[int, ...]         # payload bytes per bucket
    bucket_numel: Tuple[int, ...]          # payload elements per bucket
    threshold: int
    shard_size: int = 1                    # fsdp size (1 = replicated)
    shard_dims: Tuple[Optional[int], ...] = ()
    bucket_scatter: Tuple[bool, ...] = ()
    shard_pads: Tuple[int, ...] = ()
    bucket_padded: Tuple[bool, ...] = ()

    @classmethod
    def plan(cls, leaves: Sequence[Any],
             bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> "GradBuckets":
        """Plan from a sequence of tensors (only ``.shape`` and ``.dtype``
        are read)."""
        return cls._plan(leaves, bucket_bytes, shard_dims=None,
                         shard_size=1)

    @classmethod
    def plan_sharded(cls, leaves: Sequence[Any], specs: Sequence[Any], *,
                     shard_size: int,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES
                     ) -> "GradBuckets":
        """ZeRO-3 plan over the GLOBAL leaves (:func:`global_leaves` of a
        sharded state): ``specs`` holds one spec per leaf (``()`` =
        replicated); leaves with an fsdp-sharded dim land in scatter
        buckets (uneven dims padded into their own), the rest in ordinary
        buckets. ``shard_size`` is the fsdp size."""
        leaves, specs = list(leaves), list(specs)
        if len(specs) != len(leaves):
            raise ValueError(f"param/spec lists disagree: {len(leaves)} "
                             f"leaves vs {len(specs)} specs")
        shard_dims = tuple(_shard_dim(s, tuple(l.shape), FSDP, shard_size)
                           for l, s in zip(leaves, specs))
        return cls._plan(leaves, bucket_bytes, shard_dims=shard_dims,
                         shard_size=shard_size)

    @classmethod
    def _plan(cls, leaves, bucket_bytes, *, shard_dims, shard_size):
        if bucket_bytes <= 0:
            raise ValueError(f"bucket_bytes must be positive, got "
                             f"{bucket_bytes}")
        leaves = list(leaves)
        if not leaves:
            raise ValueError("GradBuckets.plan: empty parameter list — "
                             "nothing to bucket")
        shapes = tuple(tuple(int(n) for n in l.shape) for l in leaves)
        dtypes = tuple(l.dtype for l in leaves)
        if shard_dims is None:
            shard_dims = (None,) * len(leaves)
        pads = tuple(
            (-shapes[i][d]) % shard_size if (d := shard_dims[i]) is not None
            and shard_size > 1 else 0 for i in range(len(leaves)))
        # Scatter leaves count their padded extent: the pad rows ride the
        # collective.
        sizes = []
        for i, (s, d) in enumerate(zip(shapes, dtypes)):
            numel = math.prod(s)
            if pads[i] and s[shard_dims[i]]:
                numel = numel // s[shard_dims[i]] * (s[shard_dims[i]]
                                                    + pads[i])
            sizes.append(numel * _itemsize(d))
        # Group key (dtype, scatter, padded): a scatter bucket cannot host
        # replicated leaves, and padded leaves get buckets of their own.
        groups: Dict[Tuple[Any, bool, bool], List[int]] = {}
        for i, d in enumerate(dtypes):
            sc = shard_dims[i] is not None and shard_size > 1
            groups.setdefault((d, sc, sc and pads[i] > 0), []).append(i)
        buckets, nbytes, numel, scatter, padded = [], [], [], [], []

        def close(cur, cur_b, d, sc, pd):
            buckets.append(tuple(cur))
            nbytes.append(cur_b)
            numel.append(cur_b // _itemsize(d))
            scatter.append(sc)
            padded.append(pd)

        for (d, sc, pd), idxs in groups.items():
            cur: List[int] = []
            cur_b = 0
            for i in idxs:
                if cur and cur_b + sizes[i] > bucket_bytes:
                    close(cur, cur_b, d, sc, pd)
                    cur, cur_b = [], 0
                cur.append(i)
                cur_b += sizes[i]
            if cur:
                close(cur, cur_b, d, sc, pd)
        return cls(shapes, dtypes, tuple(buckets), tuple(nbytes),
                   tuple(numel), bucket_bytes, shard_size, shard_dims,
                   tuple(scatter), pads, tuple(padded))

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_scatter_buckets(self) -> int:
        return sum(1 for s in self.bucket_scatter if s)

    def bucket_dtype(self, b: int) -> Any:
        return self.dtypes[self.buckets[b][0]]

    def _is_scatter(self, b: int) -> bool:
        return bool(self.bucket_scatter) and self.bucket_scatter[b]

    def _is_padded(self, b: int) -> bool:
        return bool(self.bucket_padded) and self.bucket_padded[b]

    def _pad(self, i: int) -> int:
        return self.shard_pads[i] if self.shard_pads else 0

    def local_numel(self, b: int) -> int:
        """Elements of bucket ``b``'s buffer on one rank: a scatter
        bucket's shard chunk, or the whole buffer."""
        n = self.bucket_numel[b]
        return n // self.shard_size if self._is_scatter(b) else n

    def padded_shape(self, i: int) -> Tuple[int, ...]:
        """Leaf ``i``'s shape with the uneven-shard pad applied."""
        pad = self._pad(i)
        if not pad:
            return self.shapes[i]
        s = list(self.shapes[i])
        s[self.shard_dims[i]] += pad
        return tuple(s)

    def shard_shape(self, i: int) -> Tuple[int, ...]:
        """Leaf ``i``'s local-shard shape under the plan's fsdp layout
        (the padded extent for uneven leaves)."""
        d = self.shard_dims[i] if self.shard_dims else None
        if d is None or self.shard_size == 1:
            return self.shapes[i]
        s = list(self.padded_shape(i))
        s[d] //= self.shard_size
        return tuple(s)

    def pack_bucket(self, b: int, leaves: Sequence[Any]) -> torch.Tensor:
        """Bucket ``b``'s 1-D buffer from the whole leaves (only its
        members are read): shard-major for a scatter bucket, uneven leaves
        zero-padded first; a one-leaf bucket whose layout is the leaf's
        own is a flattened view of it, as in the JAX planner."""
        idxs = self.buckets[b]
        if self._is_scatter(b):
            src = {}
            for i in idxs:
                leaf, pad = leaves[i], self._pad(i)
                if pad:
                    d = self.shard_dims[i]
                    full = leaf.new_zeros(self.padded_shape(i))
                    full.narrow(d, 0, self.shapes[i][d]).copy_(leaf)
                    leaf = full
                src[i] = leaf
            if len(idxs) == 1 and self.shard_dims[idxs[0]] == 0:
                return src[idxs[0]].reshape(-1)
            parts = []
            for f in range(self.shard_size):
                for i in idxs:
                    d = self.shard_dims[i]
                    n = self.padded_shape(i)[d] // self.shard_size
                    parts.append(src[i].narrow(d, f * n, n).reshape(-1))
            return torch.cat(parts)
        if len(idxs) > 1:
            return torch.cat([leaves[i].reshape(-1) for i in idxs])
        return leaves[idxs[0]].reshape(-1)

    def pack(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Leaves → per-bucket 1-D buffers (:meth:`pack_bucket`)."""
        return [self.pack_bucket(b, leaves) for b in range(self.n_buckets)]

    def leaf_buffers(self, b: int, buf: torch.Tensor, *,
                     layout: str = "full") -> Dict[int, torch.Tensor]:
        """Bucket ``b``'s buffer → ``{leaf_index: tensor}``.

        ``"full"``: whole leaves packed linearly (views).
        ``"shard"``: a scatter bucket's local chunk → shard-shaped leaves
        (views). ``"gathered"``: a scatter bucket's buffer gathered over
        the fsdp group (shard-major, padded) → whole unpadded leaves (a
        copy, or a view where the leaf's shards lie in order)."""
        idxs = self.buckets[b]
        out: Dict[int, torch.Tensor] = {}
        if layout == "gathered":
            if not self._is_scatter(b):
                raise ValueError(f"layout 'gathered' belongs to scatter "
                                 f"buckets; bucket {b} is not one")
            chunk = self.bucket_numel[b] // self.shard_size
            off = 0
            for i in idxs:
                shp = self.shard_shape(i)
                n = math.prod(shp)
                d = self.shard_dims[i]
                if len(idxs) == 1 and d == 0:
                    full = buf.view(self.padded_shape(i))
                else:
                    full = torch.cat(
                        [buf[f * chunk + off:f * chunk + off + n].view(shp)
                         for f in range(self.shard_size)], dim=d)
                if self._pad(i):
                    full = full.narrow(d, 0, self.shapes[i][d])
                out[i] = full
                off += n
            return out
        if layout not in ("full", "shard"):
            raise ValueError(f"unknown layout {layout!r}")
        off = 0
        for i in idxs:
            shp = self.shard_shape(i) if layout == "shard" \
                else self.shapes[i]
            n = math.prod(shp)
            out[i] = buf[off:off + n].view(shp)
            off += n
        return out

    def unpack(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per-bucket full buffers → the leaves, as views (inverse of
        :meth:`pack` for a plan without scatter buckets)."""
        leaves: List[Any] = [None] * len(self.shapes)
        for b in range(self.n_buckets):
            for i, v in self.leaf_buffers(b, bufs[b]).items():
                leaves[i] = v
        return leaves

    def unpack_shards(self, bufs: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
        """Per-bucket local buffers → the leaves in the shard layout:
        scatter buckets' chunks unpack to shard-shaped leaves, other
        buffers whole."""
        leaves: List[Any] = [None] * len(self.shapes)
        for b in range(self.n_buckets):
            layout = "shard" if self._is_scatter(b) else "full"
            for i, v in self.leaf_buffers(b, bufs[b],
                                          layout=layout).items():
                leaves[i] = v
        return leaves

    def reduce(self, leaves: Sequence[torch.Tensor], group: Any = None, *,
               op: str = "all_reduce", group_size: int = 1
               ) -> List[torch.Tensor]:
        """Per-bucket sum of ``leaves`` over the process group ``group``
        (None: the world), returned as new leaves. ``op="all_reduce"``:
        one ``all_reduce`` per bucket; ``op="reduce_scatter"``: a
        ``reduce_scatter`` per (zero-padded) bucket and one tail
        ``all_gather``, the bandwidth-optimal split of an all-reduce;
        ``group_size`` is the group's rank count."""
        if self.n_scatter_buckets:
            raise ValueError(
                "reduce() is the replicated-plan primitive; ZeRO-3 scatter "
                "plans are driven by microbatch_grads (shard-major buffers "
                "unpack to the SHARD layout, not whole leaves)")
        if op not in ("all_reduce", "reduce_scatter"):
            raise ValueError(f"unknown reduce op {op!r} "
                             "(all_reduce|reduce_scatter)")
        out = []
        for b in range(self.n_buckets):
            buf = torch.cat([leaves[i].reshape(-1)
                             for i in self.buckets[b]])
            if op == "all_reduce":
                td.all_reduce(buf, group=group)
                out.append(buf)
                continue
            n = buf.numel()
            buf = _padded(buf, group_size)
            shard = buf.new_empty(buf.numel() // group_size)
            _reduce_scatter(shard, buf, group)
            out.append(_all_gather(shard, group_size, group)[:n])
        return self.unpack(out)


def _padded(buf: torch.Tensor, group_size: int) -> torch.Tensor:
    pad = (-buf.numel()) % group_size
    if not pad:
        return buf
    return torch.cat([buf, buf.new_zeros(pad)])


def _reduce_scatter(out: torch.Tensor, buf: torch.Tensor,
                    group: Any, async_op: bool = False) -> Any:
    """``out`` = this rank's chunk of the sum of ``buf`` over ``group``
    (returns the work handle with ``async_op``)."""
    scatter = getattr(td, "reduce_scatter_single", None) \
        or td.reduce_scatter_tensor
    return scatter(out, buf, group=group, async_op=async_op)


def _all_gather(shard: torch.Tensor, size: int, group: Any,
                async_op: bool = False):
    """``shard`` gathered from the ``size`` ranks of ``group`` into one
    new buffer, rank-major (returns ``(buffer, work)`` with
    ``async_op``)."""
    out = shard.new_empty(shard.numel() * size)
    gather = getattr(td, "all_gather_single", None) \
        or td.all_gather_into_tensor
    work = gather(out, shard.contiguous().view(-1), group=group,
                  async_op=async_op)
    return (out, work) if async_op else out


@dataclass
class ResidentBuckets:
    """A plan's parameters living in its flat buffers.

    Each parameter's ``.data`` is a view of its bucket's parameter buffer
    (``param_bufs``) and each ``.grad`` a view of the matching gradient
    buffer (``grad_bufs``). Backward then accumulates straight into the
    buckets (autograd adds in place into an existing ``.grad``), and the
    fused update writes parameters and slots in place: a step makes no
    pack or unpack copy, where the JAX step packs grads and unpacks
    parameters every step. ``param_bufs`` is ``None`` when only the grads
    are bucketed (the unfused accumulation)."""

    plan: GradBuckets
    params: List[torch.Tensor]
    param_bufs: Optional[List[torch.Tensor]]
    grad_bufs: List[torch.Tensor]

    @classmethod
    @torch.no_grad()
    def adopt(cls, plan: GradBuckets,
              params: Sequence[torch.Tensor]) -> "ResidentBuckets":
        """Move every parameter's storage into its bucket (a one-leaf
        bucket keeps the leaf's own storage) and bind zeroed grad views."""
        params = _check_params(plan, params)
        param_bufs = plan.pack([p.detach() for p in params])
        for b, buf in enumerate(param_bufs):
            for i, v in plan.leaf_buffers(b, buf).items():
                params[i].data = v
        out = cls(plan, params, param_bufs, _zeros(plan, params[0].device))
        out.bind_grads()
        return out

    @classmethod
    def grads_only(cls, plan: GradBuckets,
                   params: Sequence[torch.Tensor]) -> "ResidentBuckets":
        """Zeroed grad buckets bound to ``params``, which keep their own
        storage."""
        params = _check_params(plan, params)
        out = cls(plan, params, None, _zeros(plan, params[0].device))
        out.bind_grads()
        return out

    def bind_grads(self) -> None:
        """Point every ``.grad`` at its view of the grad buckets."""
        for p, g in zip(self.params, self.plan.unpack(self.grad_bufs)):
            p.grad = g

    def zero_grads(self) -> None:
        """One ``zero_()`` per grad bucket, then bind the views again (a
        caller may have set ``.grad`` to None in between)."""
        for g in self.grad_bufs:
            g.zero_()
        self.bind_grads()

    def check(self) -> None:
        """Raise ``RuntimeError`` if a parameter or a grad no longer
        aliases its bucket (compared by ``data_ptr``): autograd replaced a
        grad instead of accumulating into it, or the parameter's storage
        was swapped. The step never copies back silently."""
        for b, idxs in enumerate(self.plan.buckets):
            item = self.plan.bucket_dtype(b).itemsize
            off = 0
            for i in idxs:
                p = self.params[i]
                pairs = [("grad", p.grad, self.grad_bufs[b])]
                if self.param_bufs is not None:
                    pairs.append(("parameter", p, self.param_bufs[b]))
                for what, t, buf in pairs:
                    _check_alias(what, i, self.plan.shapes[i], b, t, buf,
                                 off * item)
                off += math.prod(self.plan.shapes[i])


def _check_alias(what, i, shape, b, t, buf, offset) -> None:
    if t is None or not t.is_contiguous() \
            or t.data_ptr() != buf.data_ptr() + offset:
        raise RuntimeError(
            f"{what} of leaf {i} {shape} no longer aliases bucket {b} of "
            f"its plan; it was replaced, not updated in place")


@dataclass
class ShardBuckets:
    """A ZeRO-3 plan's local parameters living in its bucket buffers: each
    rank's shard of every even scatter leaf is a view of the bucket's
    shard chunk (``param_bufs[b]``, the linear pack of the member leaves'
    shards — the chunk ``pack`` puts at this rank's offset), and each
    replicated leaf a view of its whole bucket. A bucket's forward gather
    sends its buffer as it is, and the fused update writes it in place.
    Leaves of padded (uneven) buckets stay whole in their own storage
    (``param_bufs[b]`` is None): they cross the step replicated."""

    plan: GradBuckets
    params: List[torch.Tensor]
    param_bufs: List[Optional[torch.Tensor]]

    @classmethod
    @torch.no_grad()
    def adopt(cls, plan: GradBuckets,
              params: Sequence[torch.Tensor]) -> "ShardBuckets":
        params = list(params)
        bufs: List[Optional[torch.Tensor]] = []
        for b, idxs in enumerate(plan.buckets):
            if plan._is_padded(b):
                bufs.append(None)
                continue
            layout = "shard" if plan._is_scatter(b) else "full"
            for i in idxs:
                want = plan.shard_shape(i) if layout == "shard" \
                    else plan.shapes[i]
                if tuple(params[i].shape) != want:
                    raise ValueError(
                        f"leaf {i}: local shape {tuple(params[i].shape)}, "
                        f"the plan's {layout} layout needs {want}")
            buf = torch.cat([params[i].detach().reshape(-1) for i in idxs])
            for i, v in plan.leaf_buffers(b, buf, layout=layout).items():
                params[i].data = v
            bufs.append(buf)
        return cls(plan, params, bufs)

    def check(self) -> None:
        """Raise ``RuntimeError`` if a parameter no longer aliases its
        bucket buffer."""
        for b, idxs in enumerate(self.plan.buckets):
            buf = self.param_bufs[b]
            if buf is None:
                continue
            scatter = self.plan._is_scatter(b)
            off = 0
            for i in idxs:
                shp = self.plan.shard_shape(i) if scatter \
                    else self.plan.shapes[i]
                _check_alias("parameter", i, shp, b, self.params[i], buf,
                             off * buf.element_size())
                off += math.prod(shp)


def _check_params(plan: GradBuckets,
                  params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    params = list(params)
    if tuple(tuple(p.shape) for p in params) != plan.shapes \
            or tuple(p.dtype for p in params) != plan.dtypes:
        raise ValueError("parameters do not match the bucket plan's shapes "
                         "and dtypes")
    devices = {p.device for p in params}
    if len(devices) != 1:
        raise ValueError(f"bucketed parameters must share one device, got "
                         f"{sorted(map(str, devices))}")
    if not all(p.is_contiguous() for p in params):
        raise ValueError("bucketed parameters must be contiguous")
    return params


def _zeros(plan: GradBuckets, device: torch.device) -> List[torch.Tensor]:
    return [torch.zeros(n, dtype=plan.bucket_dtype(b), device=device)
            for b, n in enumerate(plan.bucket_numel)]


# ---------------------------------------------------------------------------
# Sharding a state: whole parameters → this rank's shards
# ---------------------------------------------------------------------------

@torch.no_grad()
def shard_params(params: Sequence[torch.Tensor], specs: Sequence[Any],
                 mesh: Any) -> List[Optional[Layout]]:
    """Keep only this rank's shard of every parameter whose spec names the
    fsdp axis and whose sharded dim divides the fsdp size (``p.data``
    becomes the shard, a copy with its own storage; the whole tensor is
    freed) and attach each parameter's :class:`Layout`. Uneven leaves
    stay whole (they cross the step replicated, as in the reference).
    Returns the layouts, one per parameter."""
    size = mesh.shape[FSDP]
    coords = mesh.coords()
    layouts = []
    for p, spec in zip(params, specs):
        spec = strip_spec(spec, mesh)
        shape = tuple(p.shape)
        d = _shard_dim(spec, shape, FSDP, size) if size > 1 else None
        if d is not None and shape[d] % size == 0:
            n = shape[d] // size
            lay = Layout(shape, spec, d, coords[FSDP] * n, coords[DATA])
            p.data = p.data.narrow(d, lay.start, n).clone()
        else:
            lay = Layout(shape, spec, None, 0, coords[DATA])
        set_layout(p, lay)
        layouts.append(lay)
    return layouts


def shard_experts(model: Any, specs: Sequence[Any], mesh: Any
                  ) -> List[bool]:
    """Keep only this rank's experts of every parameter whose spec names
    the expert axis (``p.data`` becomes its ``E/ep`` experts, a copy; the
    whole tensor is freed), attach its :class:`Layout` (the expert dim
    sliced, the data index as the replica), and give every MoE layer of
    ``model`` the mesh. Returns, per parameter, whether it was sliced."""
    from tony_tpu_torch.models.moe import MoEMLP

    size = mesh.shape[EXPERT]
    coords = mesh.coords()
    out = []
    for p, spec in zip(model.parameters(), specs):
        spec = strip_spec(spec, mesh)
        dims = [d for d, entry in enumerate(spec) if EXPERT in _names(entry)]
        if not dims:
            out.append(False)
            continue
        d, shape = dims[0], tuple(p.shape)
        if len(dims) > 1 or len(_names(spec[d])) > 1 or shape[d] % size:
            raise ValueError(
                f"param of shape {shape} with spec {spec}: the expert axis "
                f"must shard one dim alone, into {size} equal parts — every "
                f"rank owns the same number of experts")
        n = shape[d] // size
        lay = Layout(shape, spec, d, coords[EXPERT] * n, coords[DATA])
        p.data = p.data.narrow(d, lay.start, n).clone()
        set_layout(p, lay)
        out.append(True)
    for m in model.modules():
        if isinstance(m, MoEMLP):
            m.mesh = mesh
    return out


def attach_like(tensors: Sequence[torch.Tensor],
                params: Sequence[torch.Tensor]) -> None:
    """Give each tensor (an optimizer slot of the same shape as its
    parameter) its parameter's layout."""
    for t, p in zip(tensors, params):
        set_layout(t, layout_of(p))


# ---------------------------------------------------------------------------
# The reduce schedule and the step's plans
# ---------------------------------------------------------------------------

def reduce_schedule(plan: GradBuckets, mesh: Any, *,
                    reduce_op: str = "all_reduce",
                    hierarchy: str = "auto"
                    ) -> Tuple[List[Tuple[str, list]], Tuple[str, ...],
                               int, bool]:
    """The per-bucket reduce schedule, one derivation for the engine and
    its records. Each bucket gets ``(mode, post_groups)``:

    * ``"scatter"``: ``reduce_scatter`` over fsdp into the ZeRO-3 shard
      layout, then an ``all_reduce`` over each post group (the data axis);
    * ``"rs"``: ``reduce_scatter`` over the (padded) sync group + a tail
      ``all_gather``;
    * ``"ar"``: one ``all_reduce`` over the sync group.

    Returns ``(sched, rs_axes, rs_group, hier)``; ``hier`` is False: the
    flat reduce is the only one ported (the multi-slice hierarchy is
    ROADMAP.md queue 1 item 8)."""
    if reduce_op not in ("all_reduce", "reduce_scatter"):
        raise ValueError(f"unknown reduce op {reduce_op!r} "
                         "(all_reduce|reduce_scatter)")
    if hierarchy not in ("auto", "flat", "hierarchical"):
        raise ValueError(f"unknown hierarchy {hierarchy!r} "
                         "(auto|flat|hierarchical)")
    if hierarchy == "hierarchical":
        raise NotImplementedError(
            f"hierarchy='hierarchical' (the two-level multi-slice reduce) "
            f"is not ported yet ({_LATER})")
    axes = sync_axes(mesh)
    sched: List[Tuple[str, list]] = []
    for b in range(plan.n_buckets):
        if plan._is_scatter(b):
            post = tuple(a for a in axes if a != FSDP and mesh.shape[a] > 1)
            sched.append(("scatter", [post] if post else []))
        elif reduce_op == "reduce_scatter":
            sched.append(("rs", []))
        else:
            sched.append(("ar", []))
    return sched, axes, sync_size(mesh), False


def step_plans(params: Sequence[torch.Tensor], mesh: Any, *,
               bucket_bytes: int = DEFAULT_BUCKET_BYTES,
               param_specs: Optional[Sequence[Any]] = None,
               prefetch: int = 1):
    """``(plan, gather_plan)`` exactly as :func:`microbatch_grads` derives
    them for a step over ``params`` (the local tensors; a ZeRO-3 plan is
    made over their global shapes). ``gather_plan`` is None for a
    replicated layout."""
    from tony_tpu_torch.parallel import sched as sched_mod

    if param_specs is None:
        return GradBuckets.plan(params, bucket_bytes), None
    plan = GradBuckets.plan_sharded(global_leaves(params), param_specs,
                                    shard_size=mesh.shape[FSDP],
                                    bucket_bytes=bucket_bytes)
    return plan, sched_mod.GatherPlan.from_buckets(plan, prefetch=prefetch)


def region_param_specs(plan: GradBuckets, param_specs: Sequence[Any]
                       ) -> Tuple[List[Tuple[Any, ...]],
                                  List[Tuple[int, ...]]]:
    """Per-leaf specs of the step's boundary (one entry per dim): uneven
    leaves — shard dim not divisible by fsdp — cross it replicated, their
    grads reduced through a padded scatter bucket and returned whole.
    Returns ``(specs, uneven_shapes)``."""
    out, uneven = [], []
    for i, s in enumerate(param_specs):
        entries = list(tuple(s or ())) + [None] * (len(plan.shapes[i])
                                                  - len(tuple(s or ())))
        if plan._pad(i):
            entries[plan.shard_dims[i]] = None
            uneven.append(plan.shapes[i])
        out.append(tuple(entries))
    return out, uneven


_WARNED: set = set()


def _warn_uneven(plan: GradBuckets, uneven: List[Tuple[int, ...]]) -> None:
    """Loud on purpose, once per plan: these leaves lose the ZeRO-3
    per-leaf memory saving (replicated at the boundary, whole grads)."""
    if not uneven or plan in _WARNED:
        return
    _WARNED.add(plan)
    _log.warning(
        "ZeRO-3 plan: %d leaf(s) with fsdp-indivisible sharded dims "
        "(shapes %s) are replicated at the accum-region boundary; their "
        "grads reduce via padded scatter buckets but return whole",
        len(uneven), uneven[:4])


def _record_plan(plan, mesh, sched, gplan, *, microbatches, reduce_op,
                 gather, zero3, window=None, quant_window=0) -> None:
    """The step's records under the reference's schema: the plan in the
    overlap registry, its reduce levels and (ZeRO-3) forward gathers in
    the collective registry. The reference's level name ``"ici"`` is its
    single-slice level. With the gather window (``window``), the
    ``accum.fwd_gather`` record lists the wire bytes of every gather of
    the last microbatch, its forward's and its backward's, and the plan
    record carries the window's high-water mark of gathered bytes beside
    ``window_nbytes()`` and the allowance; on the quantized lane
    (``quant_window``, the amax-history length) the wire bytes are int8
    and ``quant_report()["accum_gather"]`` is recorded."""
    from tony_tpu_torch.parallel import sched as sched_mod

    axes = sync_axes(mesh)
    levels: List[Dict[str, object]] = []
    if zero3 and plan.n_scatter_buckets:
        levels.append({
            "level": "ici", "op": "psum_scatter", "axes": [FSDP],
            "bucket_nbytes": [n if plan._is_scatter(b) else 0
                              for b, n in enumerate(plan.bucket_nbytes)]})
    for mode, op in (("rs", "psum_scatter"), ("ar", "all_reduce")):
        if any(m == mode for m, _ in sched):
            levels.append({
                "level": "ici", "op": op, "axes": list(axes),
                "bucket_nbytes": [n if m == mode else 0 for (m, _), n in
                                  zip(sched, plan.bucket_nbytes)]})
    extra = {}
    if window is not None:
        extra["window"] = dict(
            window.stats, high_water_nbytes=gplan.live.high,
            window_nbytes=gplan.window_nbytes(),
            allowance_nbytes=window.allowance_nbytes(),
            bound_nbytes=window.bound_nbytes(),
            gather_nbytes=list(gplan.gather_nbytes),
            prefetch=gplan.prefetch, reduces=list(window.reduces))
    profiler.record_overlap(
        "accum_step", n_buckets=plan.n_buckets,
        bucket_nbytes=list(plan.bucket_nbytes), threshold=plan.threshold,
        microbatches=microbatches, reduce_op=reduce_op,
        sync_group=sync_size(mesh), hierarchy="flat", zero3=zero3,
        n_scatter_buckets=plan.n_scatter_buckets,
        n_padded_buckets=sum(1 for b in range(plan.n_buckets)
                             if plan._is_padded(b)),
        levels=levels, **extra)
    sched_mod.record_reduce_levels("accum", levels)
    if zero3 and gplan.gather_leaves:
        if window is not None:
            nbytes = list(window.stats["gathered_wire_nbytes"])
        elif gather == "bucketed":
            nbytes = list(gplan.gather_nbytes)
        else:
            nbytes = [math.prod(plan.shapes[i]) * _itemsize(plan.dtypes[i])
                      for i, _ in gplan.gather_leaves]
        profiler.record_collective(
            "accum.fwd_gather", kind="all_gather", plane="fwd_gather",
            axes=[FSDP], nbytes=nbytes, gather=gather,
            quant="int8" if quant_window else None,
            prefetch=gplan.prefetch if gather == "bucketed" else None,
            per_microbatch=microbatches)
    if quant_window:
        raw = list(gplan.gather_nbytes)
        q_nb = [plan.bucket_numel[b] for b in gplan.gather_buckets]
        profiler.record_quant(
            "accum_gather", n_buckets=gplan.n_gather_buckets,
            window=quant_window, raw_nbytes=raw, int8_nbytes=q_nb,
            bytes_saved=sum(raw) - sum(q_nb), per_microbatch=microbatches)


class _Reducer:
    """A microbatch's bucket reduces, issued as each bucket's grads are
    packed and completed in issue order into the step's accumulators
    (``acc[b] += reduced``, so each accumulator adds its microbatches in
    order). At most ``depth`` reduces stay in flight, so the packed grads
    of a bucket are freed one bucket later."""

    def __init__(self, plan, sched, acc, mesh, rs_group, depth=1):
        self.plan, self.sched, self.acc, self.mesh = plan, sched, acc, mesh
        self.rs_group, self.depth = rs_group, depth
        self.fsdp = mesh.group((FSDP,))
        self.sync = mesh.group(sync_axes(mesh))
        self.pending: List[Tuple[int, torch.Tensor, Any, list,
                                 torch.Tensor]] = []

    @torch.no_grad()
    def issue(self, b: int, grads: Sequence[Optional[torch.Tensor]]) -> None:
        plan = self.plan
        leaves = {i: g if g is not None else torch.zeros(
            plan.shapes[i], dtype=plan.dtypes[i], device=self.acc[b].device)
            for i, g in zip(plan.buckets[b], grads)}
        buf = plan.pack_bucket(b, leaves)
        del leaves
        mode, post = self.sched[b]
        if mode == "scatter":
            s = buf.new_empty(buf.numel() // plan.shard_size)
            work = _reduce_scatter(s, buf, self.fsdp, async_op=True)
        elif mode == "rs":
            buf = _padded(buf, self.rs_group)
            s = buf.new_empty(buf.numel() // self.rs_group)
            work = _reduce_scatter(s, buf, self.sync, async_op=True)
        else:
            s = buf
            work = td.all_reduce(s, group=self.sync, async_op=True)
        self.pending.append((b, s, work, post, buf))
        while len(self.pending) > self.depth:
            self._complete(self.pending.pop(0))

    @torch.no_grad()
    def drain(self) -> None:
        while self.pending:
            self._complete(self.pending.pop(0))

    def _complete(self, item) -> None:
        b, s, work, post, _buf = item
        work.wait()
        for g in post:
            td.all_reduce(s, group=self.mesh.group(g))
        self.acc[b].add_(s)


def microbatch_grads(loss_fn: Callable[[Dict[str, Any]], Tuple[
                         torch.Tensor, torch.Tensor]],
                     params: Sequence[torch.Tensor],
                     batch: Dict[str, torch.Tensor],
                     mesh: Optional[Any] = None, *, microbatches: int,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                     resident: Optional[Any] = None,
                     fused: Optional[Any] = None,
                     opt_slots: Optional[Dict[str, List[torch.Tensor]]] = None,
                     opt_scal: Optional[torch.Tensor] = None,
                     reduce_op: str = "all_reduce",
                     param_specs: Optional[Sequence[Any]] = None,
                     hierarchy: str = "auto", gather: str = "bucketed",
                     prefetch: int = 1, module: Optional[Any] = None,
                     quant_amax: Optional[Sequence[torch.Tensor]] = None):
    """Gradient accumulation over ``microbatches`` into per-bucket buffers.

    ``loss_fn(microbatch) -> (loss, aux)`` runs the model that owns
    ``params`` on one microbatch and returns means over it. Every tensor
    of the ``batch`` dict is split on its leading dim into
    ``microbatches`` equal slices, run in order by a Python loop (the
    JAX engine's ``lax.scan``). Loss and aux are the mean of the
    microbatch means, and the grads are divided by ``microbatches`` × the
    sync group (a true division by a device scalar, as the JAX tail
    divides by its step constant).

    Without a mesh (one device): each slice's backward adds its grads
    into the bucket buffers, which start from zeros. Unfused
    (``fused=None``): returns ``(loss, aux, grads)``, the grads as views
    of the buckets, which are ``resident``'s or planned with
    ``bucket_bytes`` for this call. Fused (``fused`` =
    :class:`~tony_tpu_torch.ops.fused_optim.FusedOptimizer`, with
    ``resident`` holding the parameters, ``opt_slots`` its
    bucket-resident slots and ``opt_scal`` its :meth:`scalars`): the
    update runs in place on the accumulated buckets through
    :meth:`region_apply`; returns ``(loss, aux, grad_norm)``, the norm
    bucket-major and before any clipping.

    With a mesh (:class:`~tony_tpu_torch.parallel.Mesh`), ``batch`` is
    this rank's rows of the global batch (split over slice × data ×
    fsdp) and each microbatch's grads are reduced bucket by bucket over
    the sync group (:func:`reduce_schedule`; ``reduce_op``
    ``"all_reduce"`` or ``"reduce_scatter"``) into accumulators, so the
    returned loss and grads are the global batch's.

    **ZeRO-3** (``param_specs``, one spec per parameter, from
    :func:`fsdp_param_specs`; the parameters are this rank's shards):
    each microbatch gathers the sharded parameters over the fsdp group
    and ``reduce_scatter``\\ s the grads of each shard-major bucket over
    fsdp (then sums over the data axis): even leaves' grads come back in
    the shard layout, uneven ones whole (warned once per plan).
    ``gather="bucketed"`` runs the gather window over ``module`` (the
    model that owns ``params``, :class:`~tony_tpu_torch.parallel.window
    .GatherWindow`): one ``all_gather`` per scatter bucket just before
    its readers run, ``prefetch`` buckets ahead, freed after them and
    gathered again, in reverse, for their backward; each bucket's reduce
    is issued as soon as its last grad lands. ``"per_leaf"``: one
    ``all_gather`` per leaf, every leaf gathered for the whole forward
    and backward and the reduces issued after them (the numerics pin).
    Both give the same bits: data movement only. ``resident`` is then
    the state's :class:`ShardBuckets` when the fused update runs.

    **Quantized gathers** (``quant_amax``: one f32 ``[window]`` amax
    history per gather bucket, the same on every rank; ZeRO-3 with
    ``gather="bucketed"`` only): each gather sends int8 codes quantized
    with the delayed scale ``max(history) / 127``, shared by every rank,
    so the int8 gather is bitwise quantize-after-gather, and the
    backward's re-gathers send the same codes. The current amax of each
    bucket is measured once at entry (local max, then a max all-reduce
    over fsdp) and rolled into its history: the call returns the new
    histories after its other results."""
    if mesh is not None:
        return _mesh_grads(
            loss_fn, list(params), batch, mesh, microbatches=microbatches,
            bucket_bytes=bucket_bytes, resident=resident, fused=fused,
            opt_slots=opt_slots, opt_scal=opt_scal, reduce_op=reduce_op,
            param_specs=param_specs, hierarchy=hierarchy, gather=gather,
            prefetch=prefetch, module=module, quant_amax=quant_amax)
    if param_specs is not None or quant_amax is not None:
        raise ValueError("microbatch_grads(param_specs=..., quant_amax=...) "
                         "is the ZeRO-3 path and needs its mesh")
    params = list(params)
    plan = resident.plan if resident is not None else GradBuckets.plan(
        params, bucket_bytes)
    if fused is not None:
        _check_fused(fused, plan, resident, opt_slots, opt_scal)
    lead = batch[sorted(batch)[0]].shape[0]
    if microbatches < 1 or lead % microbatches:
        raise ValueError(
            f"global batch {lead} not divisible by sync group 1 x "
            f"microbatches {microbatches} (= {microbatches})")
    own = resident is None
    if own:
        resident = ResidentBuckets.grads_only(plan, params)
    else:
        resident.zero_grads()
    dev = resident.grad_bufs[0].device
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    aux_acc = torch.zeros((), dtype=torch.float32, device=dev)
    size = lead // microbatches
    for k in range(microbatches):
        loss, aux = loss_fn({key: v[k * size:(k + 1) * size]
                             for key, v in batch.items()})
        loss.backward()
        loss_acc = loss_acc + loss.detach()
        aux_acc = aux_acc + aux.detach()
    resident.check()
    denom = torch.full((), float(microbatches), dtype=torch.float32,
                       device=dev)
    loss, aux = loss_acc / denom, aux_acc / denom
    with torch.no_grad():
        for g in resident.grad_bufs:
            g.div_(denom)
        if fused is not None:
            gnorm = fused.region_apply(plan, resident.param_bufs,
                                       resident.grad_bufs, opt_slots,
                                       opt_scal)
            return loss, aux, gnorm
        grads = plan.unpack(resident.grad_bufs)
    if own:
        for p in params:
            p.grad = None
    return loss, aux, grads


def _check_fused(fused, plan, resident, opt_slots, opt_scal) -> None:
    if opt_slots is None or opt_scal is None:
        raise ValueError(
            "microbatch_grads(fused=...) needs opt_slots (the bucket-"
            "resident slot buffers) and opt_scal (FusedOptimizer"
            ".scalars(count))")
    if resident is None or resident.param_bufs is None:
        raise ValueError("microbatch_grads(fused=...) needs the "
                         "parameters resident in their buckets "
                         "(create_train_state with a FusedOptimizer)")
    fused.check_slots(plan, opt_slots)


def gather_params(gplan: Any, params: List[torch.Tensor], mesh: Any
                  ) -> Dict[int, torch.Tensor]:
    """The whole tensors of every gathered (even sharded) parameter,
    ``{leaf index: tensor}``, from this rank's shards, one ``all_gather``
    per leaf: the ``gather="per_leaf"`` path, which holds them for the
    whole microbatch (the bucketed path runs the gather window)."""
    group = mesh.group((FSDP,))
    size = mesh.shape[FSDP]
    out = {}
    for i, d in gplan.gather_leaves:
        shard = params[i].detach()
        flat = _all_gather(shard, size, group)
        out[i] = torch.cat(list(flat.view((size,) + tuple(shard.shape))
                                .unbind(0)), dim=d)
    return out


def _mesh_grads(loss_fn, params, batch, mesh, *, microbatches, bucket_bytes,
                resident, fused, opt_slots, opt_scal, reduce_op,
                param_specs, hierarchy, gather, prefetch, module, quant_amax):
    """The cross-device engine of :func:`microbatch_grads`."""
    from tony_tpu_torch.parallel import sched as sched_mod

    if gather not in ("bucketed", "per_leaf"):
        raise ValueError(f"unknown gather mode {gather!r} "
                         "(bucketed|per_leaf)")
    axes = sync_axes(mesh)
    group = sync_size(mesh)
    lead = batch[sorted(batch)[0]].shape[0]
    if microbatches < 1 or lead % microbatches:
        raise ValueError(
            f"global batch {lead * group} not divisible by sync group "
            f"{group} x microbatches {microbatches} "
            f"(= {group * microbatches})")
    zero3 = param_specs is not None
    quant = quant_amax is not None
    if quant and (not zero3 or gather != "bucketed"):
        raise ValueError(
            "quantize-on-gather (quant_amax=) needs the ZeRO-3 bucketed "
            "gather path (fsdp-sharded params, gather='bucketed'): the "
            "int8 lane lives on the GatherPlan bucket boundary")
    gplan = None
    if zero3:
        if resident is not None:
            plan = resident.plan
            gplan = sched_mod.GatherPlan.from_buckets(plan,
                                                      prefetch=prefetch)
        else:
            plan, gplan = step_plans(params, mesh, bucket_bytes=bucket_bytes,
                                     param_specs=param_specs,
                                     prefetch=prefetch)
        _warn_uneven(plan, region_param_specs(plan, param_specs)[1])
    else:
        plan = resident.plan if resident is not None else GradBuckets.plan(
            params, bucket_bytes)
    if fused is not None:
        _check_fused(fused, plan, resident, opt_slots, opt_scal)
    sched, _, rs_group, _ = reduce_schedule(
        plan, mesh, reduce_op=reduce_op, hierarchy=hierarchy)
    windowed = zero3 and gather == "bucketed"
    if windowed and module is None:
        raise ValueError("the bucketed ZeRO-3 gather runs the gather window "
                         "over the model: pass module= (the model that "
                         "owns params)")
    fsdp_group, sync_group = mesh.group((FSDP,)), mesh.group(axes)
    scales, new_amax = None, []
    if quant:
        from tony_tpu_torch.ops import quant as quant_mod

        quant_mod.check_quant_amax(gplan, quant_amax)
        scales, new_amax = quant_mod.delayed_scales(
            gplan, params, quant_amax, fsdp_group)
    own = resident is None and not zero3
    if own:
        # Replicated leaves: backward writes each microbatch's grads into
        # the buckets the collectives read (no pack copy).
        resident = ResidentBuckets.grads_only(plan, params)
    bucketed_grads = isinstance(resident, ResidentBuckets)
    dev = mesh.device
    acc = [torch.zeros(plan.local_numel(b) if sched[b][0] == "scatter"
                       else -(-plan.bucket_numel[b] // rs_group)
                       if sched[b][0] == "rs" else plan.bucket_numel[b],
                       dtype=plan.bucket_dtype(b), device=dev)
           for b in range(plan.n_buckets)]
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    aux_acc = torch.zeros((), dtype=torch.float32, device=dev)
    size = lead // microbatches
    window = None
    if windowed:
        from tony_tpu_torch.parallel.window import GatherWindow

        reducer = _Reducer(plan, sched, acc, mesh, rs_group)
        window = GatherWindow(
            module, params, plan, gplan, fsdp_group, reduce=reducer.issue,
            drain=reducer.drain, bufs=getattr(resident, "param_bufs", None),
            scales=scales)
        with window:
            for k in range(microbatches):
                mb = {key: v[k * size:(k + 1) * size]
                      for key, v in batch.items()}
                window.begin()
                try:
                    loss, aux = loss_fn(mb)
                    window.backward()
                    loss.backward()
                    window.finish_backward()
                finally:
                    window.end()
                loss_acc = loss_acc + loss.detach()
                aux_acc = aux_acc + aux.detach()
                del loss, aux
    else:
        local = [p.data for p in params]
        for k in range(microbatches):
            mb = {key: v[k * size:(k + 1) * size]
                  for key, v in batch.items()}
            full = gather_params(gplan, params, mesh) if zero3 else {}
            if bucketed_grads:
                resident.zero_grads()
            else:
                for p in params:
                    p.grad = None
            try:
                for i, t in full.items():
                    params[i].data = t
                loss, aux = loss_fn(mb)
                loss.backward()
                if bucketed_grads:
                    resident.check()
                    bufs = resident.grad_bufs
                else:
                    grads = [torch.zeros_like(p) if p.grad is None
                             else p.grad for p in params]
                    for p in params:
                        p.grad = None
            finally:
                for i in full:
                    params[i].data = local[i]
            del full
            loss_acc = loss_acc + loss.detach()
            aux_acc = aux_acc + aux.detach()
            with torch.no_grad():
                if not bucketed_grads:
                    bufs = plan.pack(grads)
                    del grads
                for b, buf in enumerate(bufs):
                    mode, post = sched[b]
                    if mode == "scatter":
                        s = buf.new_empty(buf.numel() // plan.shard_size)
                        _reduce_scatter(s, buf, fsdp_group)
                    elif mode == "rs":
                        buf = _padded(buf, rs_group)
                        s = buf.new_empty(buf.numel() // rs_group)
                        _reduce_scatter(s, buf, sync_group)
                    else:
                        s = buf
                        td.all_reduce(s, group=sync_group)
                    for g in post:
                        td.all_reduce(s, group=mesh.group(g))
                    acc[b].add_(s)
                del bufs
    _record_plan(plan, mesh, sched, gplan, microbatches=microbatches,
                 reduce_op=reduce_op, gather=gather, zero3=zero3,
                 window=window, quant_window=int(quant_amax[0].shape[0])
                 if quant and quant_amax else 0)
    tail = (new_amax,) if quant else ()
    denom = torch.full((), float(microbatches * group), dtype=torch.float32,
                       device=dev)
    scalars = torch.stack([loss_acc, aux_acc])
    td.all_reduce(scalars, group=sync_group)
    loss, aux = scalars[0] / denom, scalars[1] / denom
    with torch.no_grad():
        for b, a in enumerate(acc):
            a.div_(denom)
            if sched[b][0] == "rs":
                # "rs" buckets gather once; their leaves live replicated.
                acc[b] = _all_gather(a, rs_group, sync_group)[
                    :plan.bucket_numel[b]]
        if fused is not None:
            gnorm = fused.region_apply(
                plan, resident.param_bufs, acc, opt_slots, opt_scal,
                sharded=zero3 and plan.shard_size > 1, mesh=mesh,
                params=params)
            return (loss, aux, gnorm) + tail
        leaf_out: List[Any] = [None] * len(plan.shapes)
        for b, a in enumerate(acc):
            if plan._is_scatter(b) and plan._is_padded(b):
                parts = plan.leaf_buffers(
                    b, _all_gather(a, plan.shard_size, fsdp_group),
                    layout="gathered")
            elif plan._is_scatter(b):
                parts = plan.leaf_buffers(b, a, layout="shard")
            else:
                parts = plan.leaf_buffers(b, a, layout="full")
            for i, v in parts.items():
                leaf_out[i] = v
    if own:
        for p in params:
            p.grad = None
    return (loss, aux, leaf_out) + tail


def sharded_global_norm(grads: Sequence[torch.Tensor],
                        params: Sequence[torch.Tensor], mesh: Any
                        ) -> torch.Tensor:
    """optax.global_norm of a ZeRO-3 state's grads: each shard leaf's sum
    of squares (the leaves whose parameter is a shard) summed over the
    fsdp group, the replicated leaves' counted once, in f32."""
    zero = torch.zeros((), dtype=torch.float32, device=mesh.device)
    shard_sq, rest_sq = zero, zero
    for g, p in zip(grads, params):
        lay = layout_of(p)
        sq = (g.float() * g.float()).sum()
        if lay is not None and lay.sharded:
            shard_sq = shard_sq + sq
        else:
            rest_sq = rest_sq + sq
    td.all_reduce(shard_sq, group=mesh.group((FSDP,)))
    return torch.sqrt(rest_sq + shard_sq)


@torch.no_grad()
def full_params(params: Sequence[torch.Tensor], mesh: Any
                ) -> List[torch.Tensor]:
    """Every parameter whole: a ZeRO-3 shard gathered over the fsdp group
    along its sharded dim (a new tensor), an expert mesh's experts over
    the expert group, a tensor-parallel shard over the model group, any
    other parameter (a pipeline stage's layer too: the other stages hold
    theirs) as it is. For evaluation and checks; the train steps gather
    bucket by bucket."""
    out = []
    for p in params:
        lay = layout_of(p)
        if lay is None or not lay.sharded or lay.stage_layer:
            # A pipeline stage's layer is whole (its stage holds it).
            out.append(p.detach())
            continue
        axis = next(a for a in (EXPERT, MODEL, FSDP)
                    if a in _names(lay.spec[lay.dim]))
        size = mesh.shape[axis]
        flat = _all_gather(p.detach(), size, mesh.group((axis,)))
        out.append(torch.cat(list(flat.view((size,) + tuple(p.shape))
                                  .unbind(0)), dim=lay.dim))
    return out
