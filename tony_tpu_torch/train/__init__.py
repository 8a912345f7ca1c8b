"""Training step: the counterpart of :mod:`tony_tpu.train` for one device.

* :func:`cross_entropy_loss`, :func:`next_token_loss` — mean softmax
  cross entropy on f32 logits, and its causal-LM shift;
* :func:`adamw` — AdamW in optax's order of operations
  (``scale_by_adam`` → ``add_decayed_weights`` → ``scale_by_learning_rate``,
  then ``apply_updates`` as ``p + u``), with optax's defaults;
* :func:`sgd` — optax's SGD (``trace`` momentum, then
  ``scale_by_learning_rate``, then ``p + u``);
* :func:`create_train_state` and :func:`make_train_step` — one step is
  loss → grad → update, returning ``{"loss", "grad_norm", "aux_loss"}``;
* :func:`make_accum_train_step` — the same step over microbatches, with
  the grads accumulated in flat per-bucket buffers
  (:func:`tony_tpu_torch.parallel.overlap.microbatch_grads`) and either
  the optimizer applied to the leaf grads (``update="optax"``) or the
  fused bucket optimizer applied in place, one kernel launch per bucket
  (``update="fused_bucket"``, with a
  :class:`~tony_tpu_torch.ops.fused_optim.FusedOptimizer` state).

The module holds its parameters (an ``nn.Module``), so the train state
wraps the model, and a step updates parameters and optimizer slots in
place — the counterpart of the JAX step's donated state. Meshes, the
sequence axis and cross-device accumulation are later slices
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tony_tpu_torch.ops.fused_optim import FusedOptimizer, bias_correction
from tony_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_BYTES,
                                             ResidentBuckets,
                                             microbatch_grads)

_LATER = "ROADMAP.md, queue 1"


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
                       mesh: Optional[Any] = None) -> TrainState:
    """A train state over ``model``'s own (already initialised or loaded)
    parameters.

    ``tx`` is a :class:`GradientTransformation` (leaf-major state) or a
    :class:`~tony_tpu_torch.ops.fused_optim.FusedOptimizer`: then every
    parameter's storage moves into its flat per-bucket buffer of the tx's
    plan (``model.parameters()`` order), each ``.grad`` becomes a view of
    a matching grad buffer, and the optimizer state is bucket-resident
    f32 slots, consumed in place by
    ``make_accum_train_step(update="fused_bucket")``. The parameters stay
    ordinary ``nn.Parameter``s, so loading weights, ``state_dict()`` and
    remat work on the views. One device only: a mesh raises
    ``NotImplementedError``, and so does any other optimizer object."""
    if mesh is not None:
        raise NotImplementedError(f"sharded training states are not ported "
                                  f"yet ({_LATER})")
    params = [p for p in model.parameters()]
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


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over leaves of sum(x²), in f32."""
    return torch.sqrt(sum((x.float() * x.float()).sum() for x in tensors))


def make_train_step(loss_of: Optional[Callable[[torch.Tensor, Dict[str, Any]],
                                               torch.Tensor]] = None,
                    mesh: Optional[Any] = None, seq_axis: bool = False,
                    apply_kwargs_of: Optional[Callable[
                        [Dict[str, Any]], Dict[str, Any]]] = None):
    """The train step ``(state, batch) -> (state, metrics)``.

    ``loss_of(logits, batch)`` defaults to cross entropy on
    ``batch={'x', 'y'}``; ``apply_kwargs_of(batch)`` feeds extra kwargs to
    the model. Metrics are 0-d tensors on the model's device: ``loss``
    (with the auxiliary loss), ``grad_norm`` (optax.global_norm of the
    f32 grads) and ``aux_loss`` (0 for dense models). The state updates
    in place, which takes the place of the JAX step's donation; the
    grads are freed after the update."""
    if mesh is not None or seq_axis:
        raise NotImplementedError(f"sharded train steps are not ported yet "
                                  f"({_LATER})")
    if loss_of is None:
        loss_of = lambda logits, batch: cross_entropy_loss(logits,
                                                           batch["y"])

    def step(state: TrainState, batch: Dict[str, Any]):
        model = state.model
        params = [p for p in model.parameters()]
        for p in params:
            p.grad = None
        extra = apply_kwargs_of(batch) if apply_kwargs_of else {}
        logits = model(batch["x"], **extra)
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        loss = loss_of(logits, batch) + aux
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        gnorm = global_norm(grads)
        state.opt_state = state.tx.update(grads, state.opt_state, params)
        state.step += 1
        for p in params:
            p.grad = None
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "aux_loss": aux}

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
    (ROADMAP.md queue 1 items 2 and 8), ``quant=True`` (the int8 ZeRO-3
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
            "items 2 and 8)")
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
