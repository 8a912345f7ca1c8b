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
  reads its leaves.
* :func:`record_reduce_levels` — the step's reduce levels in the unified
  registry (:func:`tony_tpu_torch.profiler.collective_report`).

The expert-parallel dispatch and the pipeline edges wait for their
slices (ROADMAP.md, queue 1 item 11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from tony_tpu_torch import profiler
from tony_tpu_torch.parallel import FSDP
from tony_tpu_torch.parallel.overlap import GradBuckets, _all_gather

# Forward-gather prefetch depth: how many bucket gathers may be in flight
# ahead of the one compute is consuming (0: no chain, every gather issued
# at once).
DEFAULT_PREFETCH = 1


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

    def gather(self, leaves: Sequence[torch.Tensor], group: Any = None, *,
               bufs: Optional[Sequence[Optional[torch.Tensor]]] = None
               ) -> Dict[int, torch.Tensor]:
        """This rank's shards → ``{leaf index: whole leaf}`` for every
        gathered leaf, one ``all_gather`` over ``group`` (the fsdp group)
        per bucket. ``bufs[b]``, where given, is bucket ``b``'s local
        buffer (:class:`~tony_tpu_torch.parallel.overlap.ShardBuckets`),
        sent as it is; otherwise the member shards are concatenated.
        Bucket ``k``'s gather is issued only once bucket ``k − prefetch``'s
        has completed, which bounds the gathered bytes in flight; every
        gather is waited for (on the card: the current stream waits for
        the collective's stream) before the leaves are returned."""
        plan = self.plan
        size = plan.shard_size
        pending: List[Tuple[int, torch.Tensor, Any]] = []
        for k, b in enumerate(self.gather_buckets):
            if self.prefetch and k >= self.prefetch:
                pending[k - self.prefetch][2].wait()
            chunk = bufs[b] if bufs is not None and bufs[b] is not None \
                else torch.cat([leaves[i].detach().reshape(-1)
                                for i in plan.buckets[b]])
            full, work = _all_gather(chunk, size, group, async_op=True)
            pending.append((b, full, work))
        out: Dict[int, torch.Tensor] = {}
        for b, full, work in pending:
            work.wait()
            out.update(plan.leaf_buffers(b, full, layout="gathered"))
        return out


def record_reduce_levels(tag: str, levels: Sequence[dict]) -> None:
    """Mirror an accum plan's per-level reduce schedule into the unified
    collective registry: one record per (level, op) with the per-bucket
    bytes that move at that level."""
    for lv in levels:
        nbytes = [n for n in lv.get("bucket_nbytes", []) if n]
        profiler.record_collective(
            f"{tag}.grad.{lv['level']}.{lv['op']}", kind=lv["op"],
            plane="grad_reduce", axes=list(lv["axes"]), nbytes=nbytes)
