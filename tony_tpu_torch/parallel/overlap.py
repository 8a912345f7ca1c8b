"""Gradient buckets and microbatch accumulation: the counterpart of
:mod:`tony_tpu.parallel.overlap` on one device.

* :class:`GradBuckets` — the size-targeted partition of a parameter list
  into flat per-dtype buckets, by the JAX planner's rule;
* :class:`ResidentBuckets` — parameters and their grads living in a
  plan's flat buffers, so backward accumulates straight into the buckets
  and an update kernel writes them in place;
* :func:`microbatch_grads` — gradient accumulation over microbatches into
  the bucket buffers, then either the leaf grads (the unfused tail) or the
  fused optimizer's in-place update (the fused tail).

The JAX package's ZeRO-3 scatter and padded buckets, bucketed
collectives, forward-gather scheduling and multi-slice reduction need a
mesh and come with their slice (ROADMAP.md, queue 1 item 8).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

# The JAX planner's default (Horovod's fusion buffer is 64 MiB; smaller
# buckets let the first reduction start sooner after the first grads).
DEFAULT_BUCKET_BYTES = 4 << 20

_LATER = "ROADMAP.md, queue 1 item 8"


@dataclass(frozen=True)
class GradBuckets:
    """A size-targeted partition of a parameter list into buckets: every
    leaf lands in exactly one bucket; leaves of one dtype pack together (a
    bucket is one concatenated 1-D buffer) in list order until adding the
    next leaf would cross ``threshold`` bytes; a single leaf bigger than
    the threshold gets a bucket of its own. Leaves are grouped by dtype in
    order of first appearance, as the JAX planner groups its flattened
    tree. The port plans over ``model.parameters()`` order."""

    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    buckets: Tuple[Tuple[int, ...], ...]   # leaf indices per bucket
    bucket_nbytes: Tuple[int, ...]         # payload bytes per bucket
    bucket_numel: Tuple[int, ...]          # payload elements per bucket
    threshold: int

    @classmethod
    def plan(cls, leaves: Sequence[Any],
             bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> "GradBuckets":
        """Plan from a sequence of tensors (only ``.shape`` and ``.dtype``
        are read)."""
        if bucket_bytes <= 0:
            raise ValueError(f"bucket_bytes must be positive, got "
                             f"{bucket_bytes}")
        leaves = list(leaves)
        if not leaves:
            raise ValueError("GradBuckets.plan: empty parameter list — "
                             "nothing to bucket")
        shapes = tuple(tuple(l.shape) for l in leaves)
        dtypes = tuple(l.dtype for l in leaves)
        sizes = [math.prod(s) * d.itemsize for s, d in zip(shapes, dtypes)]
        groups: Dict[torch.dtype, List[int]] = {}
        for i, d in enumerate(dtypes):
            groups.setdefault(d, []).append(i)
        buckets, nbytes, numel = [], [], []
        for d, idxs in groups.items():
            cur: List[int] = []
            cur_b = 0
            for i in idxs:
                if cur and cur_b + sizes[i] > bucket_bytes:
                    buckets.append(tuple(cur))
                    nbytes.append(cur_b)
                    numel.append(cur_b // d.itemsize)
                    cur, cur_b = [], 0
                cur.append(i)
                cur_b += sizes[i]
            buckets.append(tuple(cur))
            nbytes.append(cur_b)
            numel.append(cur_b // d.itemsize)
        return cls(shapes, dtypes, tuple(buckets), tuple(nbytes),
                   tuple(numel), bucket_bytes)

    @classmethod
    def plan_sharded(cls, *args, **kwargs) -> "GradBuckets":
        raise NotImplementedError(f"ZeRO-3 scatter plans are not ported yet "
                                  f"({_LATER})")

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def bucket_dtype(self, b: int) -> torch.dtype:
        return self.dtypes[self.buckets[b][0]]

    def pack(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Leaves → per-bucket 1-D buffers (a one-leaf bucket is a
        flattened view of its contiguous leaf, as in the JAX planner)."""
        out = []
        for idxs in self.buckets:
            if len(idxs) > 1:
                out.append(torch.cat([leaves[i].reshape(-1) for i in idxs]))
            else:
                out.append(leaves[idxs[0]].reshape(-1))
        return out

    def leaf_buffers(self, b: int, buf: torch.Tensor, *,
                     layout: str = "full") -> Dict[int, torch.Tensor]:
        """Bucket ``b``'s buffer → ``{leaf_index: view}``, whole leaves
        packed linearly. The scatter layouts ``"shard"`` and
        ``"gathered"`` belong to ZeRO-3 plans."""
        if layout in ("shard", "gathered"):
            raise NotImplementedError(f"layout {layout!r} belongs to ZeRO-3 "
                                      f"scatter buckets ({_LATER})")
        if layout != "full":
            raise ValueError(f"unknown layout {layout!r}")
        out: Dict[int, torch.Tensor] = {}
        off = 0
        for i in self.buckets[b]:
            n = math.prod(self.shapes[i])
            out[i] = buf[off:off + n].view(self.shapes[i])
            off += n
        return out

    def unpack(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per-bucket buffers → the leaves, as views (inverse of
        :meth:`pack`)."""
        leaves: List[Any] = [None] * len(self.shapes)
        for b in range(self.n_buckets):
            for i, v in self.leaf_buffers(b, bufs[b]).items():
                leaves[i] = v
        return leaves


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
                    if t is None or not t.is_contiguous() \
                            or t.data_ptr() != buf.data_ptr() + off * item:
                        raise RuntimeError(
                            f"{what} of leaf {i} {self.plan.shapes[i]} no "
                            f"longer aliases bucket {b} of its plan; it was "
                            f"replaced, not updated in place")
                off += math.prod(self.plan.shapes[i])


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


def microbatch_grads(loss_fn: Callable[[Dict[str, Any]], Tuple[
                         torch.Tensor, torch.Tensor]],
                     params: Sequence[torch.Tensor],
                     batch: Dict[str, torch.Tensor],
                     mesh: Optional[Any] = None, *, microbatches: int,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                     resident: Optional[ResidentBuckets] = None,
                     fused: Optional[Any] = None,
                     opt_slots: Optional[Dict[str, List[torch.Tensor]]] = None,
                     opt_scal: Optional[torch.Tensor] = None):
    """Gradient accumulation over ``microbatches`` into per-bucket buffers.

    ``loss_fn(microbatch) -> (loss, aux)`` runs the model that owns
    ``params`` on one microbatch and returns means over it. Every tensor
    of the ``batch`` dict is split on its leading dim into
    ``microbatches`` equal slices, run in order by a Python loop (the
    JAX engine's ``lax.scan``); each slice's backward adds its grads into
    the bucket buffers, which start from zeros. Loss and aux are the mean
    of the microbatch means, and the buffers are divided by
    ``microbatches`` (a true division by a device scalar, as the JAX tail
    divides by its step constant).

    Unfused (``fused=None``): returns ``(loss, aux, grads)``, the grads as
    views of the buckets. The grad buckets are ``resident``'s, or planned
    with ``bucket_bytes`` for this call and unbound from ``.grad`` after
    it.

    Fused (``fused`` = :class:`~tony_tpu_torch.ops.fused_optim
    .FusedOptimizer`, with ``resident`` holding the parameters,
    ``opt_slots`` its bucket-resident slots and ``opt_scal`` its
    :meth:`scalars`): the update runs in place on the accumulated buckets
    through :meth:`region_apply`; returns ``(loss, aux, grad_norm)``, the
    norm bucket-major and before any clipping.

    One device: the JAX engine's cross-device reduction (``mesh``) is not
    ported yet."""
    if mesh is not None:
        raise NotImplementedError(f"cross-device gradient accumulation is "
                                  f"not ported yet ({_LATER})")
    params = list(params)
    plan = resident.plan if resident is not None else GradBuckets.plan(
        params, bucket_bytes)
    if fused is not None:
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
