"""Collective scheduling: the counterpart of :mod:`tony_tpu.parallel.sched`
for the ZeRO-3 forward gathers and the reduce records.

* :class:`GatherPlan` — the forward twin of the backward scatter: the
  ZeRO-3 parameter ``all_gather``\\ s coalesced into the same shard-major
  buckets the scatter plan uses (one ``all_gather`` per bucket returns
  the buffer in exactly the layout ``GradBuckets.pack`` writes, so
  ``leaf_buffers(layout="gathered")`` unpacks whole leaves — data
  movement only, the bits of per-leaf gathers). Gathers are issued
  asynchronously on the process group's own stream, at most
  ``prefetch`` ahead of the oldest one not yet waited for, and each is
  waited for — the compute stream ordered after it — before the forward
  reads its leaves. One bucket at a time (:meth:`GatherPlan.issue`,
  :meth:`GatherPlan.finish`) is what the ZeRO-3 gather window
  (:mod:`~tony_tpu_torch.parallel.window`) drives; its
  :class:`LiveBytes` counter keeps the step's high-water mark of
  gathered bytes beside :meth:`GatherPlan.window_nbytes`. ``scales=``
  (one shared f32 scale per gather bucket) sends int8 on the wire: the
  quantize-on-gather lane of :mod:`tony_tpu_torch.ops.quant`.
* :func:`record_reduce_levels` — the step's reduce levels in the unified
  registry (:func:`tony_tpu_torch.profiler.collective_report`).
* :func:`record_pipeline_edges` — a pipeline schedule's stage edges in
  the same registry (:mod:`~tony_tpu_torch.parallel.pipeline`);
* :func:`moe_dispatch_ffn_combine` — the expert-parallel exchange of a
  MoE layer's capacity slots: one ``all_to_all`` over the expert group
  each way per capacity chunk, the next chunk's dispatch issued before
  this chunk's expert FFN runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as td

from tony_tpu_torch import profiler
from tony_tpu_torch.models.moe import swiglu_experts
from tony_tpu_torch.parallel import EXPERT, FSDP, MODEL, PIPE, SEQ
from tony_tpu_torch.parallel.overlap import GradBuckets

# Forward-gather prefetch depth: how many bucket gathers may be in flight
# ahead of the one compute is consuming (0: no chain, every gather issued
# at once).
DEFAULT_PREFETCH = 1


@dataclass
class LiveBytes:
    """Gathered bytes alive on this rank: ``live`` now, ``high`` the most
    at once (a plan is made for one step: its high-water mark), and the
    wire bytes of each gather issued (``issued``: int8 bytes on the
    quantized lane; the window starts a list a microbatch). A bucket
    counts its whole gathered payload from its issue to its release."""

    live: int = 0
    high: int = 0
    issued: List[int] = field(default_factory=list)

    def add(self, nbytes: int, wire: int) -> None:
        self.live += nbytes
        self.high = max(self.high, self.live)
        self.issued.append(wire)

    def sub(self, nbytes: int) -> None:
        self.live -= nbytes


class Gathering(NamedTuple):
    """One bucket's gather in flight: the buffer the collective writes
    (int8 on the quantized lane), its work handle, the shared scale (or
    None) and the bucket's dtype."""
    buf: torch.Tensor
    work: Any
    scale: Optional[torch.Tensor]
    dtype: Any


@dataclass(frozen=True)
class GatherPlan:
    """Bucketed + prefetched forward ``all_gather`` schedule over a ZeRO-3
    :class:`GradBuckets` plan, resolved when it is built:

    * ``gather_buckets`` — the plan's even (unpadded) scatter buckets in
      leaf-consumption order;
    * ``gather_leaves`` — ``(leaf_index, shard_dim)`` of their leaves,
      the drive list of the per-leaf path;
    * ``passthrough`` — leaves not gathered: replicated, scalar and
      uneven (padded) ones, which a ZeRO-3 state holds whole."""

    plan: GradBuckets
    prefetch: int = DEFAULT_PREFETCH
    axis: str = FSDP
    gather_buckets: Tuple[int, ...] = ()
    gather_leaves: Tuple[Tuple[int, int], ...] = ()
    passthrough: Tuple[int, ...] = ()
    live: LiveBytes = field(default_factory=LiveBytes, compare=False,
                            repr=False)

    @classmethod
    def from_buckets(cls, plan: GradBuckets, *,
                     prefetch: int = DEFAULT_PREFETCH,
                     axis: str = FSDP) -> "GatherPlan":
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        gatherable = set()
        buckets = []
        for b in range(plan.n_buckets):
            if plan._is_scatter(b) and not plan._is_padded(b):
                buckets.append(b)
                gatherable.update(plan.buckets[b])
        # Consumption order: the bucket holding the earliest leaf first.
        buckets.sort(key=lambda b: min(plan.buckets[b]))
        leaves = tuple((i, plan.shard_dims[i])
                       for i in range(len(plan.shapes)) if i in gatherable)
        passthrough = tuple(i for i in range(len(plan.shapes))
                            if i not in gatherable)
        return cls(plan, prefetch, axis, tuple(buckets), leaves,
                   passthrough)

    @property
    def n_gather_buckets(self) -> int:
        return len(self.gather_buckets)

    @property
    def gather_nbytes(self) -> Tuple[int, ...]:
        """Per-gather payload bytes: the whole gathered buffer (the fsdp
        size × what each rank sends)."""
        return tuple(self.plan.bucket_nbytes[b] for b in self.gather_buckets)

    def window_nbytes(self) -> int:
        """The most gathered bytes the chained gathers may have in flight
        at once: ``prefetch + 1`` consecutive buckets (all of them with
        ``prefetch=0``)."""
        sizes = self.gather_nbytes
        if not sizes:
            return 0
        if not self.prefetch:
            return sum(sizes)
        width = min(len(sizes), self.prefetch + 1)
        return max(sum(sizes[k:k + width])
                   for k in range(len(sizes) - width + 1))

    def chunk(self, k: int, leaves: Sequence[torch.Tensor],
              bufs: Optional[Sequence[Optional[torch.Tensor]]] = None
              ) -> torch.Tensor:
        """This rank's chunk of gather bucket ``k``: ``bufs[b]`` where the
        shards live in a bucket buffer, else the member shards
        concatenated."""
        b = self.gather_buckets[k]
        if bufs is not None and bufs[b] is not None:
            return bufs[b]
        return torch.cat([leaves[i].detach().reshape(-1)
                          for i in self.plan.buckets[b]])

    def issue(self, k: int, chunk: torch.Tensor, group: Any = None, *,
              scale: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None) -> Gathering:
        """Issue gather bucket ``k``'s ``all_gather`` of ``chunk`` over
        ``group`` asynchronously, into ``out`` where given (a 1-D buffer of
        the bucket's size) and counted in :attr:`live`. With ``scale``
        the chunk is quantized first and int8 crosses the wire."""
        plan, b = self.plan, self.gather_buckets[k]
        dtype = chunk.dtype
        if scale is not None:
            from tony_tpu_torch.ops.quant import quantize

            chunk, out = quantize(chunk, scale), None
        if out is None:
            out = chunk.new_empty(chunk.numel() * plan.shard_size)
        work = _all_gather_into(out, chunk, group)
        self.live.add(plan.bucket_nbytes[b],
                      plan.bucket_numel[b] if scale is not None
                      else plan.bucket_nbytes[b])
        return Gathering(out, work, scale, dtype)

    @staticmethod
    def finish(g: Gathering) -> torch.Tensor:
        """Wait for a gather (on the card: the current stream waits for
        the collective's) and return the gathered buffer in the bucket's
        dtype: on the quantized lane, the int8 codes dequantized with the
        shared scale."""
        g.work.wait()
        if g.scale is None:
            return g.buf
        from tony_tpu_torch.ops.quant import dequantize

        return dequantize(g.buf, g.scale, g.dtype)

    def release(self, k: int) -> None:
        """Gather bucket ``k``'s gathered bytes are freed."""
        self.live.sub(self.plan.bucket_nbytes[self.gather_buckets[k]])

    def gather(self, leaves: Sequence[torch.Tensor], group: Any = None, *,
               bufs: Optional[Sequence[Optional[torch.Tensor]]] = None,
               scales: Optional[Sequence[torch.Tensor]] = None
               ) -> Dict[int, torch.Tensor]:
        """This rank's shards → ``{leaf index: whole leaf}`` for every
        gathered leaf, one ``all_gather`` over ``group`` (the fsdp group)
        per bucket (:meth:`chunk` is what each rank sends). Bucket ``k``'s
        gather is issued only once bucket ``k − prefetch``'s has
        completed, which bounds the gathered bytes in flight; every
        gather is waited for before the leaves are returned. ``scales``
        (one f32 scale per gather bucket, the same on every rank) sends
        int8 codes and dequantizes them on arrival: bitwise quantize
        after the gather, since every shard shares the scale."""
        plan = self.plan
        pending: List[Tuple[int, Gathering]] = []
        out: Dict[int, torch.Tensor] = {}
        for k, b in enumerate(self.gather_buckets):
            if self.prefetch and k >= self.prefetch:
                pending[k - self.prefetch][1].work.wait()
            pending.append((b, self.issue(
                k, self.chunk(k, leaves, bufs), group,
                scale=None if scales is None else scales[k])))
        for k, (b, g) in enumerate(pending):
            out.update(plan.leaf_buffers(b, self.finish(g),
                                         layout="gathered"))
            self.release(k)
        return out


def _all_gather_into(out: torch.Tensor, chunk: torch.Tensor,
                     group: Any) -> Any:
    """``out`` ← ``chunk`` gathered rank-major over ``group``; returns the
    async work handle."""
    gather = getattr(td, "all_gather_single", None) \
        or td.all_gather_into_tensor
    return gather(out, chunk.contiguous().view(-1), group=group,
                  async_op=True)


def record_reduce_levels(tag: str, levels: Sequence[dict]) -> None:
    """Mirror an accum plan's per-level reduce schedule into the unified
    collective registry: one record per (level, op) with the per-bucket
    bytes that move at that level."""
    for lv in levels:
        nbytes = [n for n in lv.get("bucket_nbytes", []) if n]
        profiler.record_collective(
            f"{tag}.grad.{lv['level']}.{lv['op']}", kind=lv["op"],
            plane="grad_reduce", axes=list(lv["axes"]), nbytes=nbytes)


def record_pipeline_edges(tag: str, *, stages: int, microbatches: int,
                          mb_nbytes: int, reverse: bool = False) -> None:
    """Register a pipeline schedule's ring edges, as the reference does:
    one microbatch buffer crosses a stage edge per tick (forward
    fill/drain; the 1F1B backward runs the mirrored reverse ring too),
    under ``<tag>.ppermute``."""
    ticks = microbatches + stages - 1
    directions = 2 if reverse else 1
    profiler.record_collective(
        f"{tag}.ppermute", kind="ppermute", plane="pipeline", axes=[PIPE],
        nbytes=[mb_nbytes] * (ticks * directions), stages=stages,
        microbatches=microbatches, ticks_per_direction=ticks,
        directions=directions)


def _issue_all_to_all(sent: torch.Tensor, group: Any) -> Tuple[torch.Tensor,
                                                                 Any]:
    """Start an equal-split ``all_to_all`` of ``sent`` (contiguous, its
    dim 0 split over the group's ranks); returns the buffer it writes
    and the work handle."""
    buf = torch.empty_like(sent)
    work = td.all_to_all_single(buf, sent.detach(), group=group,
                                async_op=True)
    return buf, work


class _Exchanged(torch.autograd.Function):
    """The receiving end of an ``all_to_all`` issued earlier
    (:func:`_issue_all_to_all`): the forward waits for it and returns
    its buffer; the backward sends the gradient back through the inverse
    exchange, which for equal splits is the same ``all_to_all``."""

    @staticmethod
    def forward(ctx, sent, pending, group):
        buf, work = pending
        work.wait()
        ctx.group = group
        return buf

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = torch.empty_like(grad)
        td.all_to_all_single(out, grad, group=ctx.group)
        return out, None, None


def moe_dispatch_ffn_combine(xin: torch.Tensor,
                             weights: Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor],
                             mesh: Any, *, chunks: int = 2,
                             axis: str = EXPERT) -> torch.Tensor:
    """Expert-parallel SwiGLU over a MoE layer's slots, the counterpart of
    the reference's ``moe_dispatch_ffn_combine``.

    ``xin`` is this rank's ``[E, B_l, C, D]`` slot grid (its rows'
    tokens dispatched to all E experts, in the compute dtype) and
    ``weights`` the stacked ``(w_gate, w_up, w_down)`` of the ``E/ep``
    experts this rank owns (its index on ``axis``), cast to the compute
    dtype. The capacity dim splits into ``chunks`` waves (clamped to C).
    Each wave's slots go to their experts' owners by an ``all_to_all``
    over the expert group (split on experts, concatenated on groups),
    run through the owner's experts, and come back by the inverse
    exchange; wave c+1's dispatch is issued before wave c's FFN, so it
    travels while that computes. Returns the ``[E, B_l, C, D]`` outputs
    in the slots' places. Autograd sends each gradient back through the
    inverse exchange.

    The ranks along ``axis`` hold the same rows (the batch is sharded
    over the data axes only), so an expert's owner computes every row
    ``ep`` times, once for each peer: its weight grads are ``ep`` times
    one peer's, which the train step's reduce accounts for.

    Writes the reference's ``moe.dispatch`` and ``moe.combine`` records:
    each chunk's per-rank payload, ``E · B_l · C_c · D`` elements."""
    w_gate, w_up, w_down = weights
    ep = mesh.shape[axis]
    e, b, c, d = xin.shape
    if e % ep:
        raise ValueError(
            f"n_experts={e} not divisible by the {ep}-way {axis!r} mesh "
            f"axis — every rank must own the same number of experts")
    for a in (MODEL, SEQ, PIPE):
        if mesh.shape[a] > 1:
            raise ValueError(
                f"the expert exchange owns only the {axis!r} axis; mesh "
                f"axis {a!r} has size {mesh.shape[a]}")
    e_l = e // ep
    if w_gate.shape[0] != e_l:
        raise ValueError(f"{tuple(w_gate.shape)}: this rank should hold "
                         f"{e_l} of the {e} experts")
    n_chunks = max(1, min(chunks, c))
    sizes = [c // n_chunks + (j < c % n_chunks) for j in range(n_chunks)]
    nbytes = [e * b * n * d * xin.element_size() for n in sizes]
    for tag in ("moe.dispatch", "moe.combine"):
        profiler.record_collective(
            tag, kind="all_to_all", plane="moe", axes=[axis],
            nbytes=nbytes, chunks=n_chunks, capacity=c, experts=e)
    group = mesh.group((axis,))
    lo = [sum(sizes[:j]) for j in range(n_chunks)]
    parts = [xin[:, :, a:a + n].contiguous() for a, n in zip(lo, sizes)]
    sent = [_issue_all_to_all(parts[0], group)]
    back = []
    for j, n in enumerate(sizes):
        if j + 1 < n_chunks:
            sent.append(_issue_all_to_all(parts[j + 1], group))
        # Block p of what arrives is peer p's rows for this rank's
        # experts: [ep, E/ep, B_l, C_c, D] → [E/ep, ep·B_l·C_c, D].
        got = _Exchanged.apply(parts[j], sent[j], group)
        h = got.view(ep, e_l, b, n, d).transpose(0, 1).reshape(
            e_l, ep * b * n, d)
        out = swiglu_experts(h, w_gate, w_up, w_down)
        out = out.view(e_l, ep, b, n, d).transpose(0, 1).contiguous()
        back.append((out, _issue_all_to_all(out, group)))
    return torch.cat([_Exchanged.apply(out, pending, group).view(e, b, n, d)
                      for (out, pending), n in zip(back, sizes)], dim=2)

