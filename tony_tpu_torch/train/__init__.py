"""Training: the counterpart of :mod:`tony_tpu.train`.

* :func:`cross_entropy_loss`, :func:`next_token_loss` — mean softmax
  cross entropy on f32 logits, and its causal-LM shift;
* :func:`chunked_next_token_xent` — the fused LM head and causal cross
  entropy over row chunks, which never builds the ``[B, T, V]`` logits
  (a decoder with ``xent_chunk`` returns it for ``targets=``);
* :func:`adamw` — AdamW in optax's order of operations
  (``scale_by_adam`` → ``add_decayed_weights`` → ``scale_by_learning_rate``,
  then ``apply_updates`` as ``p + u``), with optax's defaults;
* :func:`sgd` — optax's SGD (``trace`` momentum, then
  ``scale_by_learning_rate``, then ``p + u``);
* :func:`create_train_state` and :func:`make_train_step` — one step is
  loss → grad → update, returning ``{"loss", "grad_norm", "aux_loss"}``;
  with a data-parallel :class:`~tony_tpu_torch.parallel.Mesh` the state
  is broadcast from rank 0 and the step averages the grads over the
  ranks, one ``all_reduce`` per bucket of the
  :class:`~tony_tpu_torch.parallel.overlap.GradBuckets` plan;
* :func:`make_accum_train_step` — the same step over microbatches, with
  the grads accumulated in flat per-bucket buffers
  (:func:`tony_tpu_torch.parallel.overlap.microbatch_grads`) and either
  the optimizer applied to the leaf grads (``update="optax"``) or the
  fused bucket optimizer applied in place, one kernel launch per bucket
  (``update="fused_bucket"``, with a
  :class:`~tony_tpu_torch.ops.fused_optim.FusedOptimizer` state);
* :func:`global_batch` — this rank's local shard of the global batch,
  checked against the mesh's batch contract, on the rank's device;
* :func:`train_loop` and :func:`train_stats_writer` — the step fold of a
  TonY job, with checkpointed resume, the drain commit, continuous
  publication, the chaos kill point and per-step telemetry for the
  executor's heartbeat;
* :func:`encode_state` / :func:`decode_state` — the checkpoint codec of
  a train state with a per-leaf optimizer state (registered with
  :mod:`tony_tpu_torch.ckpt`; the fused optimizer registers its own).

The module holds its parameters (an ``nn.Module``), so the train state
wraps the model, and a step updates parameters and optimizer slots in
place — the counterpart of the JAX step's donated state. Checkpoints
carry the reference's ``TrainState`` (``.step``, ``.params``,
``.opt_state``) in the JAX package's paths, shapes and layout. The
sequence axis and cross-device accumulation are later slices
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import math
import os
import time
import weakref
from typing import (Any, Callable, Dict, Iterable, List, Mapping,
                    NamedTuple, Optional, Tuple)

import numpy as np
import torch
import torch.distributed as td
import torch.nn.functional as F
from torch import nn

from tony_tpu_torch import chaos, ckpt, constants, profiler
from tony_tpu_torch.ckpt.snapshot import Attrs
from tony_tpu_torch.models.convert import (PortableState, jax_param_tree,
                                           portable_state)
from tony_tpu_torch.ops.fused_optim import FusedOptimizer, bias_correction
from tony_tpu_torch.parallel import BATCH_AXES, DATA, SEQ, Mesh
from tony_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_BYTES,
                                             GradBuckets, ResidentBuckets,
                                             microbatch_grads)

_LATER = "ROADMAP.md, queue 1"
_log = logging.getLogger(__name__)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy; labels are integer classes (any rank)."""
    logits = logits.float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def next_token_loss(logits: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
    """Causal-LM loss: predict token t+1 from position t."""
    return cross_entropy_loss(logits[:, :-1], tokens[:, 1:])


def _chunk_logits(hc: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """One chunk's logits [c, V] in f32 from the compute-dtype product."""
    return (hc @ wb.t()).float()


class _ChunkedXent(torch.autograd.Function):
    """Forward: Σ over chunks of (logsumexp − label logit) / rows, no
    chunk's logits kept. Backward: each chunk's logits recomputed,
    softmax − onehot scaled by g / rows, ``dh`` written per chunk and
    ``dW += dlogitsᵀ·h`` accumulated in f32. The extra memory is one
    chunk × vocab in f32 at a time, never ``[B, T, V]``."""

    @staticmethod
    def forward(ctx, hidden, weight, tokens, chunk: int, dtype):
        d = hidden.shape[-1]
        rows = hidden[:, :-1].reshape(-1, d).to(dtype)
        labels = tokens[:, 1:].reshape(-1).long()
        wb = weight.to(dtype)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        # The last chunk is short where JAX pads it with rows of weight 0:
        # the same terms, and the mean divides by the real rows.
        for lo in range(0, rows.shape[0], chunk):
            logits = _chunk_logits(rows[lo:lo + chunk], wb)
            lab = labels[lo:lo + chunk, None]
            total = total + (torch.logsumexp(logits, dim=-1)
                             - logits.gather(1, lab)[:, 0]).sum()
        ctx.save_for_backward(rows, labels, wb)
        ctx.chunk = chunk
        ctx.hidden_meta = (hidden.shape, hidden.dtype)
        ctx.weight_dtype = weight.dtype
        return total / rows.shape[0]

    @staticmethod
    def backward(ctx, g):
        rows, labels, wb = ctx.saved_tensors
        shape, h_dtype = ctx.hidden_meta
        scale = g.float() / rows.shape[0]
        drows = torch.empty_like(rows)
        dw = torch.zeros(wb.shape, dtype=torch.float32, device=wb.device)
        for lo in range(0, rows.shape[0], ctx.chunk):
            hc = rows[lo:lo + ctx.chunk]
            logits = _chunk_logits(hc, wb)
            lab = labels[lo:lo + ctx.chunk, None]
            p = logits.sub_(torch.logsumexp(logits, dim=-1,
                                            keepdim=True)).exp_()
            p.scatter_(1, lab, p.gather(1, lab) - 1.0)
            dlog = p.mul_(scale).to(rows.dtype)
            drows[lo:lo + ctx.chunk] = dlog @ wb
            dw.add_(dlog.t() @ hc)
        dhidden = torch.zeros(shape, dtype=h_dtype, device=rows.device)
        dhidden[:, :-1] = drows.view(shape[0], shape[1] - 1, shape[2])
        return dhidden, dw.to(ctx.weight_dtype), None, None, None


def chunked_next_token_xent(hidden: torch.Tensor, lm_head: torch.Tensor,
                            tokens: torch.Tensor, chunk: int,
                            dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """Fused LM head + causal cross entropy without the ``[B, T, V]``
    logits: the mean over the ``B·(T−1)`` rows of ``logsumexp(h·Wᵀ) −
    (h·Wᵀ)[label]``, predicting token t+1 from position t, in chunks of
    ``chunk`` rows (the JAX package's ``chunked_next_token_xent``).

    ``hidden`` is ``[B, T, D]`` (the final norm's output), ``lm_head``
    the head's weight in torch's layout ``[V, D]`` (the JAX kernel
    transposed) and ``tokens`` ``[B, T]``. Each chunk's product runs in
    ``dtype`` and its softmax in f32; the backward recomputes the chunk's
    logits instead of keeping them."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return _ChunkedXent.apply(hidden, lm_head, tokens, int(chunk), dtype)


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params)`` applies
    the update to ``params`` in place and returns the new state."""
    init: Callable[[List[torch.Tensor]], Any]
    update: Callable[[List[torch.Tensor], Any, List[torch.Tensor]], Any]


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw with its defaults (weight decay 1e-4, applied to every
    leaf), leaf by leaf in optax's order: mu = (1-b1)·g + b1·mu,
    nu = (1-b2)·g² + b2·nu, bias corrections 1 - b**(count+1) in f32,
    u = mu_hat / (sqrt(nu_hat + eps_root) + eps), u += wd·p, u = -lr·u,
    p = p + u. One leaf at a time, so the update needs one leaf's scratch,
    not a copy of the model."""

    def init(params: List[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(grads: List[torch.Tensor], state: AdamState,
               params: List[torch.Tensor]) -> AdamState:
        count = state.count + 1
        bc1 = bias_correction(b1, count)
        bc2 = bias_correction(b2, count)
        # In place, op for op as optax: every product is rounded on its
        # own before its sum (no fused multiply-add) and a sum's operands
        # commute, so the moments keep optax's bits. (On the card, the
        # division by a Python scalar is a multiply by its reciprocal.)
        for g, mu, nu, p in zip(grads, state.mu, state.nu, params):
            mu.mul_(b1).add_(g * (1 - b1))
            nu.mul_(b2).add_((g * g).mul_(1 - b2))
            u = (mu / bc1).div_(torch.sqrt(nu / bc2 + eps_root).add_(eps))
            p.add_(u.add_(p * weight_decay).mul_(-learning_rate))
        return AdamState(count, state.mu, state.nu)

    return GradientTransformation(init, update)


@dataclasses.dataclass
class TraceState:
    """optax's ``TraceState``: the momentum trace per leaf (None without
    momentum)."""
    trace: Optional[List[torch.Tensor]]


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    """optax.sgd, leaf by leaf and in place, in optax's order: ``trace``
    (t = g + momentum·t; the update is t, or g + momentum·t with
    Nesterov), then the update scaled by −lr, then p = p + u. Without
    momentum the update is −lr·g. Each product is rounded on its own
    before its sum, as optax's separate ops."""

    def init(params: List[torch.Tensor]) -> TraceState:
        if momentum is None:
            return TraceState(None)
        return TraceState([torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(grads: List[torch.Tensor], state: TraceState,
               params: List[torch.Tensor]) -> TraceState:
        if momentum is None:
            for g, p in zip(grads, params):
                p.add_(g * -learning_rate)
            return state
        for g, t, p in zip(grads, state.trace, params):
            t.mul_(momentum).add_(g)
            u = g + t * momentum if nesterov else t
            p.add_(u * -learning_rate)
        return state

    return GradientTransformation(init, update)


@dataclasses.dataclass
class TrainState:
    """The model (which holds the parameters), its optimizer and the
    optimizer's state; ``step`` counts applied updates. With a
    :class:`FusedOptimizer`, ``buckets`` holds the parameters and grads
    resident in their flat bucket buffers."""
    step: int
    model: nn.Module
    tx: Any
    opt_state: Any
    buckets: Optional[ResidentBuckets] = None


def create_train_state(model: nn.Module, tx: Any,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """A train state over ``model``'s own (already initialised or loaded)
    parameters. With a data-parallel ``mesh`` every parameter and buffer
    is first broadcast from rank 0, so the replicas start equal (the
    reference creates them replicated); the model must lie on the mesh's
    device.

    ``tx`` is a :class:`GradientTransformation` (leaf-major state) or a
    :class:`~tony_tpu_torch.ops.fused_optim.FusedOptimizer`: then every
    parameter's storage moves into its flat per-bucket buffer of the tx's
    plan (``model.parameters()`` order), each ``.grad`` becomes a view of
    a matching grad buffer, and the optimizer state is bucket-resident
    f32 slots, consumed in place by
    ``make_accum_train_step(update="fused_bucket")``. The parameters stay
    ordinary ``nn.Parameter``s, so loading weights, ``state_dict()`` and
    remat work on the views. Any other optimizer object raises
    ``NotImplementedError``."""
    params = [p for p in model.parameters()]
    if mesh is not None:
        tensors = list(itertools.chain(params, model.buffers()))
        off = sorted({str(t.device) for t in tensors
                      if t.device != mesh.device})
        if off:
            raise ValueError(f"the model lies on {off}, the mesh's device is "
                             f"{mesh.device}")
        with torch.no_grad():
            for t in tensors:
                td.broadcast(t, src=0)
    if isinstance(tx, FusedOptimizer):
        resident = ResidentBuckets.adopt(tx.plan_for(params), params)
        return TrainState(step=0, model=model, tx=tx,
                          opt_state=tx.init_state(params,
                                                  plan=resident.plan),
                          buckets=resident)
    if not isinstance(tx, GradientTransformation):
        raise NotImplementedError(
            f"optimizer {type(tx).__name__} is not ported; "
            f"create_train_state takes a GradientTransformation or a "
            f"FusedOptimizer ({_LATER})")
    return TrainState(step=0, model=model, tx=tx, opt_state=tx.init(params))


def _is_leaf_state(tree: Any) -> bool:
    """A train state with a per-leaf optimizer state, or its portable
    form (the codec's trees)."""
    if isinstance(tree, PortableState):
        tree = tree.live
    return isinstance(tree, TrainState) \
        and not isinstance(tree.tx, FusedOptimizer)


def encode_state(state: TrainState) -> PortableState:
    """Ckpt codec, encode half: a train state with per-leaf AdamW state →
    the reference's ``TrainState`` tree with optax adamw's
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``,
    count an int32 scalar, every leaf a view of the live tensors. Other
    optimizer states raise ``NotImplementedError``."""
    opt = state.opt_state
    if not isinstance(opt, AdamState):
        raise NotImplementedError(
            f"the checkpoint form of {type(opt).__name__} is not ported yet "
            f"(ROADMAP.md, queue 1 item 3)")
    names = [n for n, _ in state.model.named_parameters()]
    adam = Attrs(count=torch.tensor(opt.count, dtype=torch.int32),
                 mu=jax_param_tree(state.model, dict(zip(names, opt.mu))),
                 nu=jax_param_tree(state.model, dict(zip(names, opt.nu))))
    return portable_state(state, (adam, Attrs(), Attrs()))


def decode_state(tree: PortableState, mesh: Optional[Mesh] = None
                 ) -> TrainState:
    """Ckpt codec, decode half: the restore has filled the live tensors
    through the views; this writes back the step and the count."""
    del mesh
    state = tree.live
    adam = tree.opt_state[0]
    state.step = int(tree.step)
    state.opt_state = AdamState(int(adam.count), state.opt_state.mu,
                                state.opt_state.nu)
    return state


ckpt.register_portable_codec("train_state", _is_leaf_state, encode_state,
                             decode_state)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over leaves of sum(x²), in f32."""
    return torch.sqrt(sum((x.float() * x.float()).sum() for x in tensors))


# The data-parallel step's record in the collective registry.
GRAD_REDUCE_TAG = "train_step.grad.data.all_reduce"


def make_train_step(loss_of: Optional[Callable[[torch.Tensor, Dict[str, Any]],
                                               torch.Tensor]] = None,
                    mesh: Optional[Mesh] = None, seq_axis: bool = False,
                    apply_kwargs_of: Optional[Callable[
                        [Dict[str, Any]], Dict[str, Any]]] = None):
    """The train step ``(state, batch) -> (state, metrics)``.

    ``loss_of(logits, batch)`` defaults to cross entropy on
    ``batch={'x', 'y'}``; ``apply_kwargs_of(batch)`` feeds extra kwargs to
    the model (``{"targets": batch["x"]}`` for a decoder with
    ``xent_chunk``, whose scalar loss ``loss_of`` then receives in place
    of the logits). Metrics are 0-d tensors on the model's device:
    ``loss`` (with the auxiliary loss), ``grad_norm`` (optax.global_norm
    of the f32 grads) and ``aux_loss`` (0 for dense models). The state
    updates in place, which takes the place of the JAX step's donation;
    the grads are freed after the update.

    With a data-parallel ``mesh`` (:meth:`MeshSpec.build
    <tony_tpu_torch.parallel.MeshSpec.build>`) the batch is this rank's
    local shard (:func:`global_batch`) and its loss the local mean. The
    backward runs on that loss divided by the rank count, so the sum
    over the ranks is the mean: the grads are packed into the flat
    buckets of a :class:`~tony_tpu_torch.parallel.overlap.GradBuckets`
    plan (``DEFAULT_BUCKET_BYTES``; a one-leaf bucket is a view of its
    grad, so only small leaves are copied), each bucket is summed over
    the ranks by one ``all_reduce``, recorded in
    :func:`tony_tpu_torch.profiler.collective_report` under
    :data:`GRAD_REDUCE_TAG`, and ``grad_norm`` is taken over the
    averaged grads; ``loss`` and ``aux_loss`` are averaged the same way,
    so the metrics are the global batch's, as GSPMD's are in the
    reference. On one rank every bit is the step's without a mesh. Every
    rank applies the same update to the same replica.
    ``seq_axis=True`` raises ``NotImplementedError``."""
    if seq_axis:
        raise NotImplementedError(
            "seq_axis=True (the ring-attention sequence axis) is not ported "
            "yet (ROADMAP.md, queue 1 item 11)")
    if loss_of is None:
        loss_of = lambda logits, batch: cross_entropy_loss(logits,
                                                           batch["y"])
    plans: Dict[Tuple, GradBuckets] = {}

    def reduce_plan(params: List[torch.Tensor]) -> GradBuckets:
        key = tuple((tuple(p.shape), p.dtype) for p in params)
        if key not in plans:
            plans[key] = GradBuckets.plan(params, DEFAULT_BUCKET_BYTES)
        return plans[key]

    def step(state: TrainState, batch: Dict[str, Any]):
        model = state.model
        params = [p for p in model.parameters()]
        for p in params:
            p.grad = None
        extra = apply_kwargs_of(batch) if apply_kwargs_of else {}
        logits = model(batch["x"], **extra)
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        loss = loss_of(logits, batch) + aux
        if mesh is not None:
            ranks = mesh.shape[DATA]
            loss, aux = loss / ranks, aux / ranks
        loss.backward()
        loss = loss.detach()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if mesh is not None:
            plan = reduce_plan(params)
            profiler.record_collective(
                GRAD_REDUCE_TAG, kind="all_reduce", plane="grad_reduce",
                axes=[DATA], nbytes=list(plan.bucket_nbytes))
            scalars = torch.stack([loss, aux])
            bufs = plan.pack(grads) + [scalars]
            for buf in bufs:
                td.all_reduce(buf)
            grads = plan.unpack(bufs[:-1])
            loss, aux = scalars[0], scalars[1]
        gnorm = global_norm(grads)
        state.opt_state = state.tx.update(grads, state.opt_state, params)
        state.step += 1
        for p in params:
            p.grad = None
        return state, {"loss": loss, "grad_norm": gnorm, "aux_loss": aux}

    return step


def make_accum_train_step(loss_of: Optional[Callable[[torch.Tensor,
                                                      Dict[str, Any]],
                                                     torch.Tensor]] = None,
                          mesh: Optional[Any] = None, *, microbatches: int,
                          bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                          reduce_op: str = "all_reduce",
                          hierarchy: str = "auto",
                          gather: str = "bucketed", prefetch: int = 1,
                          update: str = "optax", quant: bool = False,
                          donate: bool = True,
                          apply_kwargs_of: Optional[Callable[
                              [Dict[str, Any]], Dict[str, Any]]] = None,
                          aot_cache: Optional[Any] = None):
    """The microbatched-accumulation train step ``(state, batch) ->
    (state, metrics)``, on one device.

    The batch's leading dim is split into ``microbatches``; each slice's
    backward adds its grads into flat per-bucket buffers
    (:func:`~tony_tpu_torch.parallel.overlap.microbatch_grads`), and loss,
    grads and grad norm are the microbatch means: the values of
    :func:`make_train_step` up to float reassociation. Metrics are
    ``loss``, ``grad_norm`` and ``aux_loss``, 0-d tensors.

    ``update="optax"``: the accumulated grads, as leaf views of buckets
    planned with ``bucket_bytes`` for this step, go to the state's
    :class:`GradientTransformation`; ``grad_norm`` is
    :func:`global_norm` of the leaf grads. ``update="fused_bucket"``: the
    state's tx must be a
    :class:`~tony_tpu_torch.ops.fused_optim.FusedOptimizer`, whose
    ``create_train_state`` put parameters and grads in its buckets; the
    update runs in place on them, one ``fused_bucket_update`` launch per
    bucket, and ``grad_norm`` is the bucket-major norm. The plan is the
    tx's: a ``bucket_bytes`` given here must agree with it.

    ``mesh=None`` means the model's own device. (The JAX step raises on
    ``None``: its bucketed reduction is the cross-device sync, which a
    one-device step does not have.) A mesh, or ``reduce_op``,
    ``hierarchy``, ``gather`` or ``prefetch`` away from their defaults
    (ROADMAP.md queue 1 item 8), ``quant=True`` (the int8 ZeRO-3
    forward gathers, item 8) and ``aot_cache`` (item 12) raise
    ``NotImplementedError``. The quantized compute lane needs no switch
    here: a model built with ``quant=`` carries it. ``donate`` is
    accepted and has no effect: the step updates the state in place."""
    if update not in ("optax", "fused_bucket"):
        raise ValueError(f"unknown update mode {update!r} "
                         "(optax|fused_bucket)")
    if mesh is not None or (reduce_op, hierarchy, gather, prefetch) != (
            "all_reduce", "auto", "bucketed", 1):
        raise NotImplementedError(
            "cross-device accumulation (mesh, reduce_op, hierarchy, "
            "gather, prefetch) is not ported yet (ROADMAP.md, queue 1 "
            "item 8)")
    if quant:
        raise NotImplementedError("quant=True (int8 ZeRO-3 forward gathers) "
                                  "is not ported yet (ROADMAP.md, queue 1 "
                                  "item 8)")
    if aot_cache is not None:
        raise NotImplementedError("aot_cache is not ported yet (ROADMAP.md, "
                                  "queue 1 item 12)")
    if loss_of is None:
        loss_of = lambda logits, batch: cross_entropy_loss(logits,
                                                           batch["y"])

    def stepper(state: TrainState, batch: Dict[str, Any]):
        model = state.model
        params = [p for p in model.parameters()]

        def loss_fn(mb):
            extra = apply_kwargs_of(mb) if apply_kwargs_of else {}
            logits = model(mb["x"], **extra)
            aux = torch.zeros((), dtype=torch.float32, device=logits.device)
            return loss_of(logits, mb) + aux, aux

        if update == "fused_bucket":
            tx = state.tx
            if not isinstance(tx, FusedOptimizer):
                raise ValueError(
                    "update='fused_bucket' needs a state whose tx is a "
                    "tony_tpu_torch.ops.fused_optim.FusedOptimizer (build "
                    f"it with create_train_state), got {type(tx)}")
            if bucket_bytes != DEFAULT_BUCKET_BYTES \
                    and bucket_bytes != tx.bucket_bytes:
                raise ValueError(
                    f"update='fused_bucket': bucket_bytes={bucket_bytes} "
                    f"disagrees with the FusedOptimizer's "
                    f"{tx.bucket_bytes} — the tx's value sized the "
                    f"bucket-resident opt state and wins; set it there")
            count = state.opt_state["count"] + 1
            scal = tx.scalars(count, params[0].device)
            loss, aux, gnorm = microbatch_grads(
                loss_fn, params, batch, microbatches=microbatches,
                resident=state.buckets, fused=tx,
                opt_slots=state.opt_state["slots"], opt_scal=scal)
            state.opt_state = {"count": count,
                               "slots": state.opt_state["slots"]}
        else:
            if not isinstance(state.tx, GradientTransformation):
                raise ValueError(
                    f"update='optax' needs a state whose tx is a "
                    f"GradientTransformation, got {type(state.tx)}")
            loss, aux, grads = microbatch_grads(
                loss_fn, params, batch, microbatches=microbatches,
                bucket_bytes=bucket_bytes)
            gnorm = global_norm(grads)
            state.opt_state = state.tx.update(grads, state.opt_state, params)
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm, "aux_loss": aux}

    return stepper


def train_loop(state: TrainState, step_fn: Callable[[TrainState, Any],
                                                    Tuple[TrainState, Any]],
               batches: Optional[Iterable[Any]] = None, *,
               data: Optional[Any] = None,
               ckpt_dir: Optional[str] = None,
               save_every: Optional[int] = None,
               keep: Optional[int] = None,
               restore_on_start: bool = True,
               mesh: Optional[Mesh] = None,
               save_final: bool = True,
               on_step: Optional[Callable[[int, Dict[str, Any]],
                                          None]] = None,
               drain_file: Optional[str] = None,
               publish_every: Optional[int] = None):
    """Drive ``step_fn`` over ``batches`` (or the ``data=`` iterable,
    exactly one of them) with checkpointed resume: the fold a TonY job
    trains in, which attempt N+1 calls exactly as attempt N did and which
    resumes from the newest committed step. Returns ``(state,
    last_metrics)``.

    ``ckpt_dir``/``save_every``/``keep`` default from ``TONY_CKPT_DIR`` /
    ``TONY_CKPT_EVERY`` / ``TONY_CKPT_KEEP`` (keep 3); with no directory
    the loop is a plain fold.

    * ``restore_on_start``: restore the newest committed step into
      ``state`` in place before the first step (a no-op on the first
      attempt); a step saved with a data cursor restores it into
      ``data``. Under data parallelism every rank restores every leaf, so
      a changed world size restores too; ``mesh`` is the reference's
      elastic target and is passed to the codecs.
    * ``save_every=k``: an async save
      (:class:`tony_tpu_torch.ckpt.AsyncCheckpointer`) after every k-th
      step — the loop stalls for the device-side staging copy only — and,
      with ``save_final``, a save after the last step.
    * ``data=`` (:class:`tony_tpu_torch.data.DeviceIterator` or any
      iterable with ``state()``/``restore()``): the pipeline cursor is
      saved inside the same committed step as the train state
      (:mod:`tony_tpu_torch.data.ckptio`), so a resumed run's example
      stream is element-identical to an uninterrupted one.

    Every payload goes through :func:`tony_tpu_torch.ckpt.encode_portable`
    and every restore through ``decode_portable``: the manifest carries the
    reference's ``TrainState`` paths and layout.

    After each step: :func:`tony_tpu_torch.chaos.kill_point` (the scripted
    preemption ``TONY_CHAOS_KILL_STEP``), then ``on_step(step, metrics)``,
    then the periodic save, then the drain poll: when ``drain_file``
    (default: ``TONY_DRAIN_FILE``) exists, model and cursor are committed
    SYNCHRONOUSLY and the loop exits with ``SystemExit(EXIT_DRAINED)``.

    ``publish_every=n`` (default: ``TONY_PUBLISH_EVERY``): after every
    n-th periodic save, and the final save, rank 0 waits out the commit
    and advances the checkpoint root's ``published.json``
    (:mod:`tony_tpu_torch.publish`) over the committed step.
    ``data.close()`` runs in ``finally``."""
    from tony_tpu_torch.data import ckptio

    if (batches is None) == (data is None):
        raise ValueError("train_loop needs exactly one of batches= or "
                         "data=")
    if data is not None:
        batches = data
    stateful_data = (data is not None and hasattr(data, "state")
                     and hasattr(data, "restore"))
    if ckpt_dir is None:
        ckpt_dir = os.environ.get(constants.ENV_CKPT_DIR) or None
    if save_every is None:
        save_every = int(os.environ.get(constants.ENV_CKPT_EVERY, "0")
                         or 0)
    if keep is None:
        keep = int(os.environ.get(constants.ENV_CKPT_KEEP, "3") or 3)
    if drain_file is None:
        drain_file = os.environ.get(constants.ENV_DRAIN_FILE) or None
    if publish_every is None:
        publish_every = int(os.environ.get(constants.ENV_PUBLISH_EVERY,
                                           "0") or 0)
    mgr = None
    try:
        if ckpt_dir:
            mgr = ckpt.AsyncCheckpointer(ckpt_dir, keep=keep)
            latest = ckpt.latest_step(ckpt_dir) if restore_on_start \
                else None
            if latest is not None and ckptio.has_iter_state(ckpt_dir,
                                                           latest):
                # A wrapped {model, data_iter} step: unwrap keyed on what
                # the manifest holds, not on what this caller passed.
                state = ckpt.decode_portable(ckpt.restore_pytree(
                    ckpt_dir, {ckptio.MODEL_KEY: ckpt.encode_portable(state)},
                    step=latest, mesh=mesh)[ckptio.MODEL_KEY], mesh)
                if stateful_data:
                    data.restore(ckptio.load_iter_state(ckpt_dir, latest))
                else:
                    _log.warning(
                        "checkpoint step %d carries data-iterator state "
                        "but this train_loop has no stateful data=; the "
                        "model resumes, the input stream starts from the "
                        "beginning", latest)
            elif latest is not None:
                state = ckpt.decode_portable(ckpt.restore_pytree(
                    ckpt_dir, ckpt.encode_portable(state), step=latest,
                    mesh=mesh), mesh)

        def payload():
            st = ckpt.encode_portable(state)
            if stateful_data:
                return ckptio.wrap_for_save(st, data.state())
            return st

        def step_of(done: int) -> int:
            return int(state.step) if hasattr(state, "step") else done

        metrics: Dict[str, Any] = {}
        done = 0
        saved_at: Optional[int] = None
        saves = 0
        published_step: Optional[int] = None

        def maybe_publish(step: int) -> None:
            # The pointer may only advance over a COMMITTED manifest:
            # wait() drains the queue and re-raises a writer failure.
            nonlocal published_step
            if not publish_every or mgr is None or step == published_step:
                return
            from tony_tpu_torch import publish as publish_mod

            mgr.wait()
            if mgr.process_index == 0:
                publish_mod.publish_step(ckpt_dir, step)
            published_step = step

        for batch in batches:
            state, metrics = step_fn(state, batch)
            done += 1
            chaos.kill_point(done)
            if on_step is not None:
                on_step(done, metrics)
            if mgr is not None and save_every and done % save_every == 0:
                saved_at = step_of(done)
                mgr.save(payload(), step=saved_at)
                saves += 1
                if publish_every and saves % publish_every == 0:
                    maybe_publish(saved_at)
            if drain_file is not None and os.path.exists(drain_file):
                # Drain: commit model + cursor SYNCHRONOUSLY, so
                # EXIT_DRAINED is only reported over a durable manifest.
                if mgr is not None:
                    here = step_of(done)
                    if here != saved_at:
                        mgr.save(payload(), step=here)
                    mgr.wait()
                raise SystemExit(constants.EXIT_DRAINED)
        if mgr is not None and save_final and done:
            final = step_of(done)
            if final != saved_at:
                mgr.save(payload(), step=final)
            maybe_publish(final)
        if mgr is not None:
            mgr.wait()
    finally:
        if mgr is not None:
            mgr.close()
        if data is not None and hasattr(data, "close"):
            data.close()
    return state, metrics


def train_stats_writer(path: Optional[str] = None, *,
                       flops_per_step: float = 0.0,
                       peak_flops: float = 0.0
                       ) -> Callable[[int, Dict[str, Any]], None]:
    """An ``on_step`` callback for :func:`train_loop` that publishes each
    step's telemetry — ``step``, ``step_time_s`` (host time since the
    previous call, or since the writer was made), ``collective_bytes``
    (the planned per-issue payloads of
    :func:`tony_tpu_torch.profiler.collective_report`), ``mfu``
    (``flops_per_step / (step_time_s · peak_flops)`` when both are
    given) and ``loss`` — as one JSON object, staged and renamed into
    place, the reference's schema. ``path`` defaults to the
    ``TONY_SERVE_STATS`` file the executor's heartbeat carries to the AM;
    without one the callback is a no-op. Writing is advisory: an
    ``OSError`` never fails the step."""
    target = path or os.environ.get(constants.ENV_SERVE_STATS)
    last = {"t": time.monotonic()}

    def on_step(step: int, metrics: Dict[str, Any]) -> None:
        now = time.monotonic()
        dt = now - last["t"]
        last["t"] = now
        if not target:
            return
        nbytes = float(sum(sum(rec.get("nbytes") or ())
                           for rec in profiler.collective_report().values()))
        mfu = (flops_per_step / (dt * peak_flops)
               if flops_per_step > 0 and peak_flops > 0 and dt > 0
               else 0.0)
        payload = {"step": float(step), "step_time_s": float(dt),
                   "collective_bytes": nbytes, "mfu": float(mfu)}
        loss = metrics.get("loss") if isinstance(metrics, dict) else None
        if loss is not None:
            payload["loss"] = float(loss)
        tmp = f"{target}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                json.dump(payload, fh)
            os.replace(tmp, target)
        except OSError:
            pass

    return on_step


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs, paths spelled as ``jax.tree_util.keystr``
    spells them (``['x']``, ``[0]``), dict keys sorted."""
    if isinstance(tree, Mapping):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(tree: Any, leaves: Iterable[Any]) -> Any:
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(tree)


def _validate_local_batch(mesh: Mesh, local_batch: Any,
                          seq_axis: bool = False) -> None:
    """The reference's pre-flight of the local-batch contract, raising a
    ``ValueError`` that names the offending leaf: every leaf an array with
    a leading batch dim, all leaves agreeing on it, the global batch dim
    (local × processes) divisible by the mesh's batch sharding and the
    local dim by this process's share of it, and with ``seq_axis`` the
    sequence dim divisible by the ring axis."""
    flat = _flatten(local_batch)
    if not flat:
        return
    nproc = mesh.processes
    n_shards = math.prod(mesh.shape[a] for a in BATCH_AXES)
    ref_path = ref_dim = None
    for name, leaf in flat:
        if not hasattr(leaf, "shape") or np.ndim(leaf) == 0:
            raise ValueError(
                f"global_batch leaf {name}: expected an array with a "
                f"leading batch dim, got {type(leaf).__name__} of rank "
                f"{np.ndim(leaf)}")
        dim = int(leaf.shape[0])
        if ref_dim is None:
            ref_path, ref_dim = name, dim
        elif dim != ref_dim:
            raise ValueError(
                f"global_batch leaf {name}: local batch dim {dim} != "
                f"{ref_dim} (leaf {ref_path}) — every leaf of every "
                f"process must contribute the same local batch count")
        if seq_axis and np.ndim(leaf) >= 2:
            seq = int(leaf.shape[1])
            seq_shards = mesh.shape[SEQ]
            if seq % seq_shards:
                raise ValueError(
                    f"global_batch leaf {name}: sequence dim {seq} not "
                    f"divisible by the {seq_shards}-way ring axis "
                    f"({SEQ!r}) of the mesh")
    global_dim = ref_dim * nproc
    if global_dim % n_shards:
        raise ValueError(
            f"global_batch leaf {ref_path}: local batch dim {ref_dim} x "
            f"{nproc} process(es) = global {global_dim}, not divisible by "
            f"the {n_shards}-way batch sharding {BATCH_AXES} of the "
            f"mesh — pad or resize the per-process batch")
    if n_shards % nproc == 0:
        per_proc = n_shards // nproc
        if per_proc and ref_dim % per_proc:
            raise ValueError(
                f"global_batch leaf {ref_path}: local batch dim {ref_dim} "
                f"not divisible by this process's {per_proc} addressable "
                f"batch shard(s) ({n_shards}-way sharding over {nproc} "
                f"process(es))")


# Contracts already validated, mesh → {(seq_axis, paths, leaf shapes)}:
# per-step callers pay the pre-flight once per contract. Only successes
# are kept, so a bad contract raises on every call; weakly keyed, and
# bounded per mesh (when full, validation just runs).
_VALIDATED_CONTRACTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_VALIDATED_CONTRACTS_MAX = 256


def global_batch(mesh: Mesh, local_batch: Any, seq_axis: bool = False,
                 check: bool = True) -> Any:
    """This rank's part of the global batch — every rank calls it with its
    own local shard (multi-host feeding) — as tensors on the mesh's
    device, in the local batch's dict/list structure (a pinned host
    tensor is copied without a host wait, on the current stream). Under
    data parallelism each rank holds its own rows, so nothing crosses
    ranks.
    ``check`` pre-flights the reference's shape contract with a
    leaf-naming ``ValueError`` (memoized per contract)."""
    flat = _flatten(local_batch)
    if check:
        key = (seq_axis, tuple(p for p, _ in flat),
               tuple(np.shape(leaf) for _, leaf in flat))
        seen = _VALIDATED_CONTRACTS.setdefault(mesh, set())
        if key not in seen:
            _validate_local_batch(mesh, local_batch, seq_axis=seq_axis)
            if len(seen) < _VALIDATED_CONTRACTS_MAX:
                seen.add(key)
    return _unflatten(local_batch, (_to_device(leaf, mesh.device)
                                    for _, leaf in flat))


def _to_device(leaf: Any, device: torch.device) -> torch.Tensor:
    """A leaf on ``device``; from pinned memory without a host wait, on
    the current stream."""
    if isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu" \
            and device.type == "cuda" and leaf.is_pinned():
        return leaf.to(device, non_blocking=True)
    return torch.as_tensor(leaf, device=device)
