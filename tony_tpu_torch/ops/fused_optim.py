"""Fused bucket optimizer: the counterpart of :mod:`tony_tpu.ops.fused_optim`
on one device.

* :func:`_rule_math` — the per-element AdamW / SGD-momentum /
  Adafactor-style update in optax's order of operations, in plain
  PyTorch: the plain version of the kernel.
* :func:`fused_bucket_update` — ONE update launch over one bucket's flat
  buffers, in place. A CUDA tensor runs the hand-written Hopper kernel
  ``csrc/fused_optim.cu`` (or raises), a CPU tensor :func:`_rule_math`.
  The JAX package's ``impl=``/``interpret=`` switches have no
  counterpart: the tensors' device decides.
* :class:`FusedOptimizer` — rule, hyperparameters and bucket policy;
  bucket-resident f32 slots (:meth:`~FusedOptimizer.init_state`) and the
  bucket-major update core (:meth:`~FusedOptimizer.region_apply`: grad
  norm, optional clip, one launch per bucket) that
  ``make_accum_train_step(update="fused_bucket")`` runs.
* :func:`fused_update_step` — the standalone leaf-major entry.
* :func:`slots_to_leaf_major` / :func:`leaf_major_to_slots` — host-numpy
  converters between bucket-resident slots and param-shaped leaves.
* :func:`encode_state` / :func:`decode_state` — the checkpoint codec
  (registered with :mod:`tony_tpu_torch.ckpt`): a fused train state as the
  reference's portable form, ``.opt_state['count']`` and
  ``.opt_state['leaf'][slot][...]`` over views of the bucket buffers, so
  a restore copies into the buckets the parameters are views of.

Unlike the JAX package, updates happen in place: parameters (or their
bucket buffers) and slots are overwritten, and the functions return the
same tensors. On a ZeRO-3 plan (fsdp > 1) every rank holds, for each
scatter bucket, its shard chunk of the parameters and slots: the update
kernel runs once per bucket on that chunk (a buffer of its own, so its
16-byte vector loads start aligned; the kernel masks a ragged tail), a
padded (uneven) bucket's chunk is packed from the whole leaves with zero
pad rows, which every rule keeps at zero, and its updated chunk is
gathered back into the leaves.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from tony_tpu_torch import resolve_device
from tony_tpu_torch.ops.attention import LAUNCHES, _DTYPE_CODES
from tony_tpu_torch.parallel import FSDP
from tony_tpu_torch.parallel.layout import Layout, layout_of, set_layout
from tony_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_BYTES,
                                             GradBuckets, _all_gather,
                                             fsdp_param_specs,
                                             global_leaves)

RULES: Tuple[str, ...] = ("adamw", "sgd", "adafactor")

# Moment slots per rule, in kernel-operand order.
_SLOTS: Dict[str, Tuple[str, ...]] = {
    "adamw": ("mu", "nu"),
    "sgd": ("trace",),
    "adafactor": ("nu",),
}

# Scalar operand layout (one f32 vector per step, shared by every bucket's
# launch): [-lr, adam bias correction 1, bias correction 2, pad].
_N_SCAL = 4

_RULE_CODES = {"adamw": 0, "sgd": 1, "adafactor": 2}


def _rule_math(rule: str, g, p, slots, neg_lr, bc1, bc2, *, b1: float,
               b2: float, eps: float, weight_decay: float, momentum: float):
    """The per-element update, op for op as the JAX package's
    ``_rule_math`` (optax's order: ``(1-b)*g + b*m``, bias-correct by
    division, ``sqrt(v̂)+eps``, decayed weights added to the update,
    ``-lr`` scale last), each product and sum rounded on its own.
    ``g``/``p``/``slots`` are f32; ``neg_lr``/``bc1``/``bc2`` are 0-d
    tensors on their device, so every division is a true division (a
    Python-scalar divisor would become a multiply by its reciprocal on
    the card)."""
    if rule == "adamw":
        mu, nu = slots
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * (g * g) + b2 * nu
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p
        return p + neg_lr * u, (mu, nu)
    if rule == "sgd":
        (tr,) = slots
        tr = g + momentum * tr            # optax trace: g + decay * t
        u = tr
        if weight_decay:
            u = u + weight_decay * p
        return p + neg_lr * u, (tr,)
    if rule == "adafactor":
        # Adafactor-STYLE: second moment only, elementwise, no factoring
        # and no bias correction.
        (nu,) = slots
        nu = (1 - b2) * (g * g) + b2 * nu
        u = g / (torch.sqrt(nu) + eps)
        if weight_decay:
            u = u + weight_decay * p
        return p + neg_lr * u, (nu,)
    raise ValueError(f"unknown fused optimizer rule {rule!r} "
                     f"(one of {RULES})")


def bias_correction(b: float, count: int) -> float:
    """``1 - b**count`` as the JAX package computes it: an f32 power of
    the f32-rounded base by the count as an f32, then ``1 -`` in f32."""
    power = torch.tensor(b, dtype=torch.float32) ** torch.tensor(
        float(count), dtype=torch.float32)
    return float(1 - power)


@torch.no_grad()
def _update_plain(g, p, slots, scal, rule, hyper):
    p_new, new_slots = _rule_math(rule, g.float(), p.float(), tuple(slots),
                                  scal[0], scal[1], scal[2], **hyper)
    p.copy_(p_new)                  # round to nearest even for bf16
    for s, v in zip(slots, new_slots):
        s.copy_(v)


def _lib() -> ctypes.CDLL:
    from tony_tpu_torch.ops import _build

    lib = _build.load(["fused_optim"])["fused_optim"]
    fn = lib.fused_optim_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int64] + [ctypes.c_float] * 7
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_optim_error_string.argtypes = [ctypes.c_int]
        lib.fused_optim_error_string.restype = ctypes.c_char_p
    return lib


def _update_cuda(g, p, slots, scal, rule, hyper):
    """Check what the kernel takes and launch it on the current stream.
    Raises ``ValueError`` on a device, type, size or layout the kernel does
    not take and ``RuntimeError`` when the launch fails."""
    dev = p.device
    for name, x in (("g", g), ("scal", scal)) + tuple(
            (f"slot {i}", s) for i, s in enumerate(slots)):
        if x.device != dev:
            raise ValueError(f"fused_bucket_update: {name} on {x.device}, p "
                             f"on {dev}")
    if p.dtype not in _DTYPE_CODES or g.dtype != p.dtype:
        raise ValueError(f"fused_bucket_update kernel takes g and p both "
                         f"float32 or both bfloat16, got {g.dtype}/{p.dtype}")
    if any(s.dtype != torch.float32 for s in slots):
        raise ValueError("fused_bucket_update kernel takes float32 slots")
    if scal.dtype != torch.float32 or scal.numel() != _N_SCAL \
            or not scal.is_contiguous():
        raise ValueError(f"fused_bucket_update kernel takes a contiguous "
                         f"float32 scalar vector of {_N_SCAL}")
    n = p.numel()
    for name, x in (("g", g), ("p", p)) + tuple(
            (f"slot {i}", s) for i, s in enumerate(slots)):
        if x.numel() != n:
            raise ValueError(f"fused_bucket_update: {name} has {x.numel()} "
                             f"elements, p {n}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"fused_bucket_update kernel needs {name} "
                             f"contiguous and 16-byte aligned")
    if n == 0:
        return
    lib = _lib()
    ptrs = [s.data_ptr() for s in slots] + [0] * (2 - len(slots))
    wd = hyper["weight_decay"]
    rc = lib.fused_optim_launch(
        _RULE_CODES[rule], _DTYPE_CODES[p.dtype], g.data_ptr(), p.data_ptr(),
        ptrs[0], ptrs[1], scal.data_ptr(), n, hyper["b1"], hyper["b2"],
        1 - hyper["b1"], 1 - hyper["b2"], hyper["eps"], wd,
        hyper["momentum"], int(bool(wd)),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_bucket_update kernel launch failed: cuda error {rc} "
            f"({lib.fused_optim_error_string(rc).decode()})")
    LAUNCHES["fused_bucket_update"] += 1


def fused_bucket_update(g: torch.Tensor, p: torch.Tensor,
                        slots: Sequence[torch.Tensor], scal: torch.Tensor, *,
                        rule: str, hyper: Dict[str, float]
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """ONE optimizer-update launch over one bucket's buffers, in place.

    ``g``/``p`` are the bucket's gradient and parameter buffers (both
    float32 or both bfloat16); ``slots`` its f32 moment buffers (count and
    order per ``_SLOTS[rule]``); ``scal`` the ``_N_SCAL``-vector from
    :meth:`FusedOptimizer.scalars`; ``hyper`` is
    :attr:`FusedOptimizer.hyper`. Overwrites ``p`` and ``slots`` and
    returns ``(p, slots)``. A CUDA tensor launches the kernel, a CPU tensor
    runs :func:`_rule_math`; the two agree bitwise."""
    if rule not in RULES:
        raise ValueError(f"unknown fused optimizer rule {rule!r} "
                         f"(one of {RULES})")
    nslots = len(_SLOTS[rule])
    if len(slots) != nslots:
        raise ValueError(f"rule {rule!r} expects {nslots} slot buffer(s) "
                         f"({_SLOTS[rule]}), got {len(slots)}")
    if p.device.type == "cuda":
        _update_cuda(g, p, slots, scal, rule, hyper)
    elif p.device.type == "cpu":
        _update_plain(g, p, slots, scal, rule, hyper)
    else:
        raise ValueError(f"fused_bucket_update runs on cuda or cpu tensors, "
                         f"got {p.device}")
    return p, tuple(slots)


@dataclass(frozen=True)
class FusedOptimizer:
    """Rule, hyperparameters and bucket policy of the fused optimizer.

    Passed as the ``tx`` of ``train.create_train_state``, which then moves
    the parameters into their buckets and builds bucket-resident f32
    slots; ``train.make_accum_train_step(update="fused_bucket")`` drives
    the update. ``lr`` is a float or a callable ``count -> lr`` (the
    count is the step's 1-based update count, a Python int).

    AdamW and SGD-momentum follow optax's order of operations
    (``adamw(lr, b1, b2, eps, weight_decay=...)``; ``sgd(lr, momentum)``
    with ``weight_decay=0``). ``clip_norm`` clips by the bucket-major
    global norm before the update (optax's ``clip_by_global_norm``
    ratio)."""

    rule: str = "adamw"
    lr: Union[float, Callable[[int], Any]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    clip_norm: Optional[float] = None
    bucket_bytes: int = DEFAULT_BUCKET_BYTES

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown fused optimizer rule {self.rule!r} "
                             f"(one of {RULES})")

    @property
    def slot_names(self) -> Tuple[str, ...]:
        return _SLOTS[self.rule]

    @property
    def hyper(self) -> Dict[str, float]:
        return {"b1": self.b1, "b2": self.b2, "eps": self.eps,
                "weight_decay": self.weight_decay,
                "momentum": self.momentum}

    def scalars(self, count: int,
                device: Optional[Union[str, torch.device]] = None
                ) -> torch.Tensor:
        """The per-step scalar vector ``[-lr, 1-b1^t, 1-b2^t, 0]`` (f32,
        shared by every bucket's launch) on ``device`` (``None``: the
        card). It is computed on the host and copied without a
        synchronisation (from pinned memory to a card), so neither an lr
        schedule nor the bias corrections make a step wait."""
        if self.rule == "adamw":
            bc1 = bias_correction(self.b1, count)
            bc2 = bias_correction(self.b2, count)
        else:
            bc1 = bc2 = 1.0
        lr = self.lr(count) if callable(self.lr) else self.lr
        host = torch.tensor([-float(lr), bc1, bc2, 0.0], dtype=torch.float32)
        dev = resolve_device(device)
        if dev.type == "cuda":
            return host.pin_memory().to(dev, non_blocking=True)
        return host.to(dev)

    # -- planning / state ---------------------------------------------------

    def plan_for(self, params: Sequence[torch.Tensor],
                 mesh: Optional[Any] = None) -> GradBuckets:
        """The bucket plan for ``params`` on ``mesh``: the same derivation
        at state creation, in the step and at a restore. A ZeRO-3 state's
        parameters (shards with layouts, fsdp > 1) give the sharded plan
        over their global shapes; anything else the plain plan."""
        specs = fsdp_param_specs(params, mesh) if mesh is not None else None
        if specs is None:
            return GradBuckets.plan(params, self.bucket_bytes)
        return GradBuckets.plan_sharded(global_leaves(params), specs,
                                        shard_size=mesh.shape[FSDP],
                                        bucket_bytes=self.bucket_bytes)

    def bucket_specs(self, plan: GradBuckets) -> List[Tuple[Any, ...]]:
        """Per-bucket specs of the bucket buffers: scatter buckets live in
        the scatter layout (``("fsdp",)``), the rest replicated."""
        return [(FSDP,) if plan._is_scatter(b) else ()
                for b in range(plan.n_buckets)]

    def init_state(self, params: Sequence[torch.Tensor],
                   mesh: Optional[Any] = None,
                   plan: Optional[GradBuckets] = None) -> Dict[str, Any]:
        """Bucket-resident zero state ``{"count": 0, "slots": {name:
        [per-bucket f32 buffer]}}`` on the parameters' device; a scatter
        bucket's buffer is this rank's chunk of it."""
        params = list(params)
        plan = self.plan_for(params, mesh) if plan is None else plan
        dev = params[0].device
        slots = {name: [torch.zeros(plan.local_numel(b), dtype=torch.float32,
                                    device=dev)
                        for b in range(plan.n_buckets)]
                 for name in self.slot_names}
        return {"count": 0, "slots": slots}

    def check_slots(self, plan: GradBuckets, slots: Dict[str, Any]) -> None:
        names = tuple(slots)
        if set(names) != set(self.slot_names):
            raise ValueError(
                f"fused opt state carries slots {sorted(names)} but rule "
                f"{self.rule!r} needs {sorted(self.slot_names)}")
        for name in names:
            if len(slots[name]) != plan.n_buckets:
                raise ValueError(
                    f"fused opt state slot {name!r} has "
                    f"{len(slots[name])} bucket buffers but the plan has "
                    f"{plan.n_buckets} — the state was initialized for a "
                    f"different bucket_bytes or fsdp topology; rebuild it "
                    f"(create_train_state) or elastic-restore through the "
                    f"leaf-major portable form")

    # -- the update core ----------------------------------------------------

    @staticmethod
    def local_pack(plan: GradBuckets, leaves: Sequence[torch.Tensor],
                   b: int, f_idx: Optional[int], *,
                   sharded: bool = True) -> torch.Tensor:
        """Bucket ``b``'s local buffer from this rank's leaves: even
        scatter leaves are their shard already, padded leaves (whole) are
        zero-padded and sliced to shard ``f_idx``, everything else
        concatenates whole (a one-leaf bucket is a view of its leaf)."""
        idxs = plan.buckets[b]
        if plan._is_scatter(b) and sharded and plan._is_padded(b):
            parts = []
            for i in idxs:
                d = plan.shard_dims[i]
                leaf = leaves[i]
                full = leaf.new_zeros(plan.padded_shape(i))
                full.narrow(d, 0, plan.shapes[i][d]).copy_(leaf)
                rows = plan.padded_shape(i)[d] // plan.shard_size
                parts.append(full.narrow(d, f_idx * rows, rows).reshape(-1))
        else:
            parts = [leaves[i].reshape(-1) for i in idxs]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    @torch.no_grad()
    def region_apply(self, plan: GradBuckets,
                     param_bufs: Optional[Sequence[Optional[torch.Tensor]]],
                     grad_bufs: Sequence[torch.Tensor],
                     slots: Dict[str, List[torch.Tensor]],
                     scal: torch.Tensor, *, sharded: Optional[bool] = None,
                     mesh: Optional[Any] = None,
                     params: Optional[Sequence[torch.Tensor]] = None
                     ) -> torch.Tensor:
        """Bucket-major update core over one rank's bucket buffers: the
        global grad norm (one sum of squares per buffer, in plain torch;
        the scatter buckets' partial sums summed over the fsdp group of
        ``mesh``), optax's clip ratio ``clip_norm / max(norm, clip_norm)``
        when ``clip_norm`` is set (applied to copies; the grad buffers are
        left as they are), then one :func:`fused_bucket_update` per
        bucket, which overwrites the parameter buffers and ``slots``.

        ``param_bufs[b]`` is bucket ``b``'s parameter buffer; where it is
        None (or ``param_bufs`` is), the buffer is packed from ``params``
        (:meth:`local_pack`) and the updated values are written back into
        them — a padded bucket's through an ``all_gather`` of its chunks,
        as its leaves are whole. Returns the norm (before clipping), a 0-d
        f32 tensor."""
        self.check_slots(plan, slots)
        if sharded is None:
            sharded = plan.shard_size > 1
        fsdp_group = mesh.group((FSDP,)) if sharded else None
        sq = torch.zeros((), dtype=torch.float32, device=scal.device)
        shard_sq = torch.zeros((), dtype=torch.float32, device=scal.device)
        for b, gb in enumerate(grad_bufs):
            g = gb.float()
            if sharded and plan._is_scatter(b):
                shard_sq = shard_sq + (g * g).sum()
            else:
                sq = sq + (g * g).sum()
        if sharded and plan.n_scatter_buckets:
            import torch.distributed as td

            td.all_reduce(shard_sq, group=fsdp_group)
            sq = sq + shard_sq
        gnorm = torch.sqrt(sq)
        if self.clip_norm is not None:
            clip = torch.full((), self.clip_norm, dtype=torch.float32,
                              device=gnorm.device)
            trim = clip / torch.maximum(gnorm, clip)
            grad_bufs = [gb * trim.to(gb.dtype) for gb in grad_bufs]
        f_idx = mesh.coords()[FSDP] if sharded else None
        for b in range(plan.n_buckets):
            p_buf = param_bufs[b] if param_bufs is not None else None
            packed = p_buf is None
            if packed:
                p_buf = self.local_pack(plan, params, b, f_idx,
                                        sharded=sharded)
            fused_bucket_update(
                grad_bufs[b], p_buf,
                tuple(slots[n][b] for n in self.slot_names), scal,
                rule=self.rule, hyper=self.hyper)
            if not packed:
                continue
            if sharded and plan._is_scatter(b) and plan._is_padded(b):
                parts = plan.leaf_buffers(
                    b, _all_gather(p_buf, plan.shard_size, fsdp_group),
                    layout="gathered")
            else:
                parts = plan.leaf_buffers(
                    b, p_buf, layout="shard" if sharded
                    and plan._is_scatter(b) else "full")
            for i, v in parts.items():
                if v.data_ptr() != params[i].data_ptr():
                    params[i].copy_(v)
        return gnorm

    def region_collectives(self, plan: GradBuckets, *, sharded: bool = True,
                           axis: str = FSDP
                           ) -> List[Tuple[str, Tuple[str, ...], int, str]]:
        """The collectives :meth:`region_apply` itself issues, as
        ``(kind, axes, nbytes, note)``: one parameter ``all_gather`` per
        padded scatter bucket (its uneven leaves are whole, so their
        updated chunks gather back once); the scalar norm sum is left
        out."""
        out: List[Tuple[str, Tuple[str, ...], int, str]] = []
        if not sharded:
            return out
        for b in range(plan.n_buckets):
            if plan._is_scatter(b) and plan._is_padded(b):
                out.append(("all_gather", (axis,), plan.bucket_nbytes[b],
                            f"bucket {b} padded param re-gather"))
        return out


def fused_update_step(fused: FusedOptimizer, params: Sequence[torch.Tensor],
                      grads: Sequence[torch.Tensor],
                      opt_state: Dict[str, Any], mesh: Optional[Any] = None,
                      *, plan: Optional[GradBuckets] = None,
                      param_specs: Optional[Sequence[Any]] = None
                      ) -> Tuple[List[torch.Tensor], Dict[str, Any],
                                 torch.Tensor]:
    """Standalone leaf-major entry: pack ``params`` and ``grads`` into the
    plan's bucket buffers (a one-leaf bucket is its leaf's own storage),
    run :meth:`FusedOptimizer.region_apply`, and write the updated
    buckets back into ``params``. Returns ``(params, {"count", "slots"},
    grad_norm)``; parameters and slots are updated in place.

    On a ZeRO-3 plan (``mesh`` with fsdp > 1: ``plan`` from
    :meth:`FusedOptimizer.plan_for` of the sharded parameters, or
    ``param_specs``) ``params`` and ``grads`` are this rank's leaves:
    even scatter leaves their shards, the others whole; each bucket's
    chunk is packed locally and updated by one launch."""
    params, grads = list(params), list(grads)
    if plan is None:
        if param_specs is not None:
            plan = GradBuckets.plan_sharded(
                global_leaves(params), param_specs,
                shard_size=mesh.shape[FSDP], bucket_bytes=fused.bucket_bytes)
        else:
            plan = fused.plan_for(params, mesh)
    fused.check_slots(plan, opt_state["slots"])
    sharded = plan.shard_size > 1 and mesh is not None
    if plan.shard_size > 1 and mesh is None:
        raise ValueError("fused_update_step: a sharded plan needs its mesh")
    count = opt_state["count"] + 1
    scal = fused.scalars(count, params[0].device)
    f_idx = mesh.coords()[FSDP] if sharded else None
    with torch.no_grad():
        g_bufs = [fused.local_pack(plan, [g.detach() for g in grads], b,
                                   f_idx, sharded=sharded)
                  for b in range(plan.n_buckets)]
        gnorm = fused.region_apply(plan, None, g_bufs, opt_state["slots"],
                                   scal, sharded=sharded, mesh=mesh,
                                   params=[p.detach() for p in params])
    return params, {"count": count, "slots": opt_state["slots"]}, gnorm


# ---------------------------------------------------------------------------
# Leaf-major ⇄ bucket-major converters (host numpy)
# ---------------------------------------------------------------------------

def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _np_unpack_bucket(plan: GradBuckets, b: int,
                      buf: np.ndarray) -> Dict[int, np.ndarray]:
    """Host-numpy twin of ``leaf_buffers``: whole leaves from one bucket's
    whole buffer (a scatter bucket's shard-major one in the "gathered"
    layout, pads dropped)."""
    out: Dict[int, np.ndarray] = {}
    off = 0
    if plan._is_scatter(b):
        chunk = plan.bucket_numel[b] // plan.shard_size
        for i in plan.buckets[b]:
            shp = plan.shard_shape(i)
            n = int(np.prod(shp, dtype=np.int64))
            d = plan.shard_dims[i]
            full = np.concatenate(
                [buf[f * chunk + off:f * chunk + off + n].reshape(shp)
                 for f in range(plan.shard_size)], axis=d)
            out[i] = np.take(full, range(plan.shapes[i][d]), axis=d)
            off += n
        return out
    for i in plan.buckets[b]:
        n = int(np.prod(plan.shapes[i], dtype=np.int64))
        out[i] = buf[off:off + n].reshape(plan.shapes[i])
        off += n
    return out


def _np_pack_bucket(plan: GradBuckets, b: int,
                    leaves: Sequence[np.ndarray]) -> np.ndarray:
    """Host-numpy twin of ``pack`` for one bucket: shard-major with
    zero-padded uneven leaves for a scatter bucket."""
    if not plan._is_scatter(b):
        return np.concatenate(
            [np.asarray(leaves[i]).reshape(-1) for i in plan.buckets[b]])
    src = {}
    for i in plan.buckets[b]:
        a = np.asarray(leaves[i])
        if plan._pad(i):
            d = plan.shard_dims[i]
            a = np.pad(a, [(0, plan._pad(i) if k == d else 0)
                           for k in range(a.ndim)])
        src[i] = a
    parts = []
    for f in range(plan.shard_size):
        for i in plan.buckets[b]:
            d = plan.shard_dims[i]
            n = plan.padded_shape(i)[d] // plan.shard_size
            parts.append(np.take(src[i], range(f * n, (f + 1) * n),
                                 axis=d).reshape(-1))
    return np.concatenate(parts)


def slots_to_leaf_major(plan: GradBuckets,
                        slots: Dict[str, Sequence[torch.Tensor]]
                        ) -> Dict[str, List[np.ndarray]]:
    """Bucket-resident slot buffers (whole ones: a scatter bucket's
    buffer shard-major over every rank's chunk) → per-slot lists of host
    numpy arrays shaped like the parameters, in the plan's leaf order
    (the portable form a checkpoint carries). A ZeRO-3 state's
    checkpoint does not come through here: each rank writes its chunk's
    leaves at their extents (:func:`slot_leaves`)."""
    out: Dict[str, List[np.ndarray]] = {}
    for name, bufs in slots.items():
        leaves: List[Any] = [None] * len(plan.shapes)
        for b in range(plan.n_buckets):
            for i, v in _np_unpack_bucket(plan, b, _host(bufs[b])).items():
                leaves[i] = v
        out[name] = leaves
    return out


def leaf_major_to_slots(plan: GradBuckets,
                        trees: Dict[str, Sequence[np.ndarray]],
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Dict[str, List[torch.Tensor]]:
    """Inverse of :func:`slots_to_leaf_major` onto this plan's buckets,
    re-packed on the host and placed on ``device`` (``None``: the
    card)."""
    dev = resolve_device(device)
    return {name: [torch.from_numpy(_np_pack_bucket(plan, b, list(leaves)))
                   .to(dev) for b in range(plan.n_buckets)]
            for name, leaves in trees.items()}


def slot_leaves(plan: GradBuckets, bufs: Sequence[torch.Tensor],
                params: Sequence[torch.Tensor], mesh: Optional[Any] = None
                ) -> List[torch.Tensor]:
    """One slot's bucket buffers as per-leaf views (no copy). On a ZeRO-3
    plan a scatter bucket's views are this rank's shard of each leaf,
    carrying a :class:`~tony_tpu_torch.parallel.layout.Layout` at the
    shard's offset; a padded leaf's view is cut to the rows that lie
    inside the leaf (none for a rank whose shard is all pad), so the
    portable form holds no pad row."""
    if plan.shard_size == 1:
        return plan.unpack(bufs)
    f_idx = mesh.coords()[FSDP]
    out: List[Any] = [None] * len(plan.shapes)
    for b in range(plan.n_buckets):
        if not plan._is_scatter(b):
            out_b = plan.leaf_buffers(b, bufs[b], layout="full")
        else:
            out_b = {}
            for i, v in plan.leaf_buffers(b, bufs[b],
                                          layout="shard").items():
                d = plan.shard_dims[i]
                rows = plan.shard_shape(i)[d]
                start = f_idx * rows
                v = v.narrow(d, 0, max(0, min(rows,
                                              plan.shapes[i][d] - start)))
                lay = layout_of(params[i])
                out_b[i] = set_layout(v, Layout(
                    plan.shapes[i], lay.spec, d, start, lay.replica))
        for i, v in out_b.items():
            out[i] = v
    return out


def is_fused_state(state: Any) -> bool:
    """A train state driven by this optimizer: ``tx`` is a FusedOptimizer
    and the opt state is a count+slots dict."""
    return isinstance(getattr(state, "tx", None), FusedOptimizer) \
        and isinstance(getattr(state, "opt_state", None), dict) \
        and "count" in state.opt_state


def _is_fused_tree(tree: Any) -> bool:
    """A fused train state, or its portable form (the codec's trees)."""
    from tony_tpu_torch.models.convert import PortableState

    if isinstance(tree, PortableState):
        tree = tree.live
    return is_fused_state(tree)


def encode_state(state: Any) -> Any:
    """Ckpt codec, encode half: a fused train state → its portable form,
    the reference's ``{"count", "leaf": {slot: param-shaped tree}}``
    (count an int32 scalar) beside ``.step`` and ``.params``, every leaf a
    view of the live buffers (no copy). Anything else passes through."""
    from tony_tpu_torch.models.convert import jax_param_tree, portable_state

    if not is_fused_state(state) or "slots" not in state.opt_state:
        return state
    plan = state.buckets.plan
    state.tx.check_slots(plan, state.opt_state["slots"])
    names = [n for n, _ in state.model.named_parameters()]
    params = list(state.model.parameters())
    leaf = {slot: jax_param_tree(state.model, dict(zip(
                names, slot_leaves(plan, bufs, params, state.mesh))))
            for slot, bufs in state.opt_state["slots"].items()}
    count = torch.tensor(state.opt_state["count"], dtype=torch.int32)
    return portable_state(state, {"count": count, "leaf": leaf})


def decode_state(tree: Any, mesh: Optional[Any] = None) -> Any:
    """Ckpt codec, decode half: the restored portable form → the live
    fused state. The restore has already copied the moments into the
    bucket buffers the views alias (on a ZeRO-3 state each rank's
    shards, read from whatever fsdp size wrote the step); this writes
    back the count and the step. ``mesh`` has nothing to re-plan: the
    live state was planned for its own mesh."""
    del mesh
    from tony_tpu_torch.models.convert import PortableState

    if not isinstance(tree, PortableState):
        return tree
    state = tree.live
    state.step = int(tree.step)
    state.opt_state = {"count": int(tree.opt_state["count"]),
                       "slots": state.opt_state["slots"]}
    return state


def _register_codec() -> None:
    from tony_tpu_torch import ckpt

    ckpt.register_portable_codec("fused_optim", _is_fused_tree,
                                 encode_state, decode_state)


_register_codec()
