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
* :func:`param_specs`, :func:`create_train_state` and
  :func:`make_train_step` — one step is loss → grad → update, returning
  ``{"loss", "grad_norm", "aux_loss"}``; with a data-parallel
  :class:`~tony_tpu_torch.parallel.Mesh` the state is broadcast from
  rank 0 and the step averages the grads over the ranks, one
  ``all_reduce`` per bucket of the
  :class:`~tony_tpu_torch.parallel.overlap.GradBuckets` plan; on an
  ``fsdp > 1`` mesh the state is ZeRO-3: each rank keeps its shard of
  every parameter whose logical axes map to fsdp, and of its optimizer
  state, and the step gathers and reduce-scatters them;
* :func:`make_accum_train_step` — the same step over microbatches, with
  the grads accumulated in flat per-bucket buffers
  (:func:`tony_tpu_torch.parallel.overlap.microbatch_grads`; with a mesh,
  reduced bucket by bucket over the gradient sync group) and either the
  optimizer applied to the leaf grads (``update="optax"``) or the fused
  bucket optimizer applied in place, one kernel launch per bucket
  (``update="fused_bucket"``, with a
  :class:`~tony_tpu_torch.ops.fused_optim.FusedOptimizer` state);
* :func:`global_batch` — this rank's local shard of the global batch,
  checked against the mesh's batch contract, on the rank's device;
* :func:`train_loop` and :func:`train_stats_writer` — the step fold of a
  TonY job, with checkpointed resume, the drain commit, continuous
  publication, the chaos kill point and per-step telemetry for the
  executor's heartbeat;
* :func:`encode_state` / :func:`decode_state` — the checkpoint codec of
  a train state with a per-leaf optimizer state, AdamW's or SGD's
  (registered with :mod:`tony_tpu_torch.ckpt`; the fused optimizer
  registers its own).

The module holds its parameters (an ``nn.Module``), so the train state
wraps the model, and a step updates parameters and optimizer slots in
place — the counterpart of the JAX step's donated state. Checkpoints
carry the reference's ``TrainState`` (``.step``, ``.params``,
``.opt_state``) in the JAX package's paths, shapes and layout; a ZeRO-3
state's ranks each write their shards. The sequence axis, the other
mesh axes and the int8 gather wire format are later slices (ROADMAP.md,
queue 1 items 8 and 11).
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

from tony_tpu_torch import chaos, ckpt, conf, constants, profiler
from tony_tpu_torch.ckpt.snapshot import Attrs
from tony_tpu_torch.models.convert import (PortableState, jax_param_tree,
                                           portable_state)
from tony_tpu_torch.ops.fused_optim import FusedOptimizer, bias_correction
from tony_tpu_torch.parallel import (BATCH_AXES, DATA, FSDP, SEQ, Mesh,
                                     logical_spec)
from tony_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_BYTES,
                                             GradBuckets, ResidentBuckets,
                                             ShardBuckets, attach_like,
                                             fsdp_param_specs,
                                             microbatch_grads, shard_params,
                                             sharded_global_norm)

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
    :class:`FusedOptimizer`, ``buckets`` holds the parameters (and on one
    device or a replicated mesh the grads) resident in their flat bucket
    buffers: a :class:`ResidentBuckets`, or on a ZeRO-3 state a
    :class:`ShardBuckets`. ``mesh`` is the mesh the state was created
    on."""
    step: int
    model: nn.Module
    tx: Any
    opt_state: Any
    buckets: Optional[Any] = None
    mesh: Optional[Mesh] = None


@dataclasses.dataclass
class QuantTrainState(TrainState):
    """A :class:`TrainState` on the quantized-gather lane
    (:func:`tony_tpu_torch.ops.quant.with_gather_quant`): ``quant_state``
    is ``{"amax": [one f32 [window] history per gather bucket]}``, the
    same on every rank, and ``qconfig`` the
    :class:`~tony_tpu_torch.ops.quant.QuantConfig` it was built for. The
    parameters and the reduce are untouched: only the ZeRO-3 gathers'
    wire is int8."""
    qconfig: Any = None
    quant_state: Any = None


def param_specs(model: nn.Module) -> List[Tuple[Any, ...]]:
    """One spec per parameter (``model.parameters()`` order) from the
    model's logical axes (its ``logical_axes(name)``) through
    :data:`tony_tpu_torch.parallel.RULES`: the counterpart of the
    reference's ``param_shardings``. A model that names no logical axes
    (the MNIST nets, ResNet) is replicated: every spec is ``()``."""
    axes_of = getattr(model, "logical_axes", None)
    names = [n for n, _ in model.named_parameters()]
    if axes_of is None:
        return [() for _ in names]
    return [logical_spec(*axes_of(n)) for n in names]


def _attach_slot_layouts(opt_state: Any, params: List[torch.Tensor]) -> None:
    """A ZeRO-3 state's per-leaf slots carry their parameters' layouts."""
    for name in ("mu", "nu", "trace"):
        slots = getattr(opt_state, name, None)
        if slots is not None:
            attach_like(slots, params)


def create_train_state(model: nn.Module, tx: Any,
                       mesh: Optional[Mesh] = None,
                       specs: Optional[List[Tuple[Any, ...]]] = None
                       ) -> TrainState:
    """A train state over ``model``'s own (already initialised or loaded)
    parameters. With a ``mesh`` every parameter and buffer is first
    broadcast from rank 0, so the replicas start equal (the reference
    creates them replicated); the model must lie on the mesh's device.

    On a mesh with ``fsdp > 1`` the state is ZeRO-3: each parameter whose
    spec (``specs``, one per parameter in the port's layout; default
    :func:`param_specs`, the model's logical axes) names the fsdp axis
    keeps only this rank's shard of its sharded dim (``p.data`` becomes
    the shard, the whole tensor is freed), with its
    :class:`~tony_tpu_torch.parallel.layout.Layout` attached; so does its
    optimizer state. A leaf whose sharded dim does not divide the fsdp
    size stays whole (it crosses the step replicated). The model's
    forward then needs the step's gathers: call it through the train
    steps.

    ``tx`` is a :class:`GradientTransformation` (leaf-major state) or a
    :class:`~tony_tpu_torch.ops.fused_optim.FusedOptimizer`: then every
    parameter's storage moves into its flat per-bucket buffer of the tx's
    plan (``model.parameters()`` order; on a ZeRO-3 state this rank's
    chunk of each scatter bucket, :class:`ShardBuckets`), each ``.grad``
    becomes a view of a matching grad buffer (not on a ZeRO-3 state), and
    the optimizer state is bucket-resident f32 slots, consumed in place
    by ``make_accum_train_step(update="fused_bucket")``. The parameters
    stay ordinary ``nn.Parameter``s, so loading weights, ``state_dict()``
    and remat work on the views. Any other optimizer object raises
    ``NotImplementedError``."""
    params = [p for p in model.parameters()]
    fused = isinstance(tx, FusedOptimizer)
    if not fused and not isinstance(tx, GradientTransformation):
        raise NotImplementedError(
            f"optimizer {type(tx).__name__} is not ported; "
            f"create_train_state takes a GradientTransformation or a "
            f"FusedOptimizer ({_LATER})")
    zero3 = False
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
        if mesh.shape[FSDP] > 1:
            shard_params(params, param_specs(model) if specs is None
                         else list(specs), mesh)
            zero3 = fsdp_param_specs(params, mesh) is not None
    if fused:
        plan = tx.plan_for(params, mesh)
        buckets = ShardBuckets.adopt(plan, params) if zero3 \
            else ResidentBuckets.adopt(plan, params)
        return TrainState(step=0, model=model, tx=tx,
                          opt_state=tx.init_state(params, plan=plan),
                          buckets=buckets, mesh=mesh)
    opt_state = tx.init(params)
    if zero3:
        _attach_slot_layouts(opt_state, params)
    return TrainState(step=0, model=model, tx=tx, opt_state=opt_state,
                      mesh=mesh)


def _is_leaf_state(tree: Any) -> bool:
    """A train state with a per-leaf optimizer state, or its portable
    form (the codec's trees)."""
    if isinstance(tree, PortableState):
        tree = tree.live
    return isinstance(tree, TrainState) \
        and not isinstance(tree.tx, FusedOptimizer)


def encode_state(state: TrainState) -> PortableState:
    """Ckpt codec, encode half: a train state with a per-leaf optimizer
    state → the reference's ``TrainState`` tree, every leaf a view of the
    live tensors: AdamW's as optax adamw's ``(ScaleByAdamState(count, mu,
    nu), EmptyState(), EmptyState())``, count an int32 scalar; SGD's as
    optax sgd's ``(TraceState(trace), EmptyState())``, or two empty
    states without momentum. On a ZeRO-3 state the moments and the trace
    are shards, as the parameters. Other optimizer states raise
    ``NotImplementedError``."""
    opt = state.opt_state
    names = [n for n, _ in state.model.named_parameters()]

    def tree_of(slots):
        return jax_param_tree(state.model, dict(zip(names, slots)))

    if isinstance(opt, AdamState):
        adam = Attrs(count=torch.tensor(opt.count, dtype=torch.int32),
                     mu=tree_of(opt.mu), nu=tree_of(opt.nu))
        return portable_state(state, (adam, Attrs(), Attrs()))
    if isinstance(opt, TraceState):
        trace = Attrs() if opt.trace is None \
            else Attrs(trace=tree_of(opt.trace))
        return portable_state(state, (trace, Attrs()))
    raise NotImplementedError(
        f"the checkpoint form of {type(opt).__name__} is not ported yet "
        f"(ROADMAP.md, queue 1 item 3)")


def decode_state(tree: PortableState, mesh: Optional[Mesh] = None
                 ) -> TrainState:
    """Ckpt codec, decode half: the restore has filled the live tensors
    through the views; this writes back the step and AdamW's count."""
    del mesh
    state = tree.live
    state.step = int(tree.step)
    if isinstance(state.opt_state, AdamState):
        state.opt_state = AdamState(int(tree.opt_state[0].count),
                                    state.opt_state.mu, state.opt_state.nu)
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

    On a ZeRO-3 state (:func:`create_train_state` on an ``fsdp > 1``
    mesh), where the reference gets ZeRO-3 from GSPMD, the step runs the
    accumulating engine with one microbatch
    (:func:`~tony_tpu_torch.parallel.overlap.microbatch_grads`): the
    sharded parameters gathered bucket by bucket, the grads
    reduce-scattered into the shard layout, ``grad_norm`` summed over the
    shards, the update applied to each rank's shards.
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
        specs = fsdp_param_specs(params, mesh)
        if specs is not None:
            return _zero3_step(state, batch, params, specs)
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

    def _zero3_step(state, batch, params, specs):
        def loss_fn(mb):
            extra = apply_kwargs_of(mb) if apply_kwargs_of else {}
            logits = state.model(mb["x"], **extra)
            aux = torch.zeros((), dtype=torch.float32, device=logits.device)
            return loss_of(logits, mb) + aux, aux

        if not isinstance(state.tx, GradientTransformation):
            raise ValueError(f"make_train_step on a ZeRO-3 state needs a "
                             f"GradientTransformation, got {type(state.tx)}")
        loss, aux, grads = microbatch_grads(
            loss_fn, params, batch, mesh, microbatches=1,
            param_specs=specs, module=state.model)
        gnorm = sharded_global_norm(grads, params, mesh)
        state.opt_state = state.tx.update(grads, state.opt_state, params)
        state.step += 1
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
    (state, metrics)``, on one device or over a mesh.

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
    one-device step does not have.) With a mesh
    (:meth:`MeshSpec.build <tony_tpu_torch.parallel.MeshSpec.build>`)
    the batch is this rank's rows of the global batch
    (:func:`global_batch`) and each microbatch's grads are reduced over
    the data × fsdp sync group bucket by bucket: ``reduce_op=
    "all_reduce"`` or ``"reduce_scatter"`` (a zero-padded
    ``reduce_scatter`` and one tail ``all_gather``). The layout is
    detected from the state, as the reference detects it from the
    committed shardings: on a ZeRO-3 state
    (:func:`~tony_tpu_torch.parallel.overlap.fsdp_param_specs`) each
    microbatch gathers the sharded parameters, the scatter buckets' grads
    are reduce-scattered into the shard layout and the update runs on
    each rank's shards (the fused update: one kernel launch per bucket
    on the rank's chunk). ``gather="bucketed"`` runs the gather window
    (:class:`~tony_tpu_torch.parallel.window.GatherWindow`): each bucket
    gathered just before its readers, ``prefetch`` buckets ahead, freed
    after them and gathered again for their backward, and reduced as
    soon as its grads land, so a rank holds its shards and a window of
    whole buckets; ``"per_leaf"`` gathers every leaf for the whole
    microbatch (the numerics pin). Both give the same bits. ``hierarchy``
    is ``"auto"`` or ``"flat"`` (the same flat reduce);
    ``"hierarchical"`` (the multi-slice reduce, ROADMAP.md queue 1 item
    8) raises ``NotImplementedError``.

    ``quant=True`` sends the ZeRO-3 gathers as int8
    (:mod:`tony_tpu_torch.ops.quant`): the state must be a
    :class:`QuantTrainState` (``quant.with_gather_quant``) whose
    delayed-scaling amax histories ride the step; it needs
    ``gather="bucketed"`` and composes with both ``update`` modes. The
    quantized compute lane needs no switch here: a model built with
    ``quant=`` carries it. ``donate`` is accepted and has no effect: the
    step updates the state in place.

    ``aot_cache`` (a :class:`tony_tpu_torch.ckpt.AOTCache`, e.g.
    :func:`shared_aot_cache`): before the first step, the kernel
    libraries the step launches (flash attention, the BN kernels, the
    int8 GEMM of a quantized model, the fused optimizer under
    ``update="fused_bucket"``) resolve through the cache, so a gang mate
    or a re-gang loads what the first worker built instead of running
    ``nvcc``. The entry is the library set's
    (:func:`tony_tpu_torch.ckpt.aot.library_fingerprint`): a library
    does not depend on the state's or the batch's geometry, so unlike
    the reference's lowered program they are not part of it. The step
    itself stays eager, the same bits as without a cache: it is
    device-bound (the device idles 0.033-0.069 of an 8-layer 7B step on
    an H100, ``PERF.md`` §5), so capturing it would buy little."""
    if update not in ("optax", "fused_bucket"):
        raise ValueError(f"unknown update mode {update!r} "
                         "(optax|fused_bucket)")
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a tony_tpu_torch.parallel.Mesh "
                        f"(MeshSpec(...).build()), got {type(mesh)}")
    if reduce_op not in ("all_reduce", "reduce_scatter"):
        raise ValueError(f"unknown reduce op {reduce_op!r} "
                         "(all_reduce|reduce_scatter)")
    if hierarchy == "hierarchical":
        raise NotImplementedError(
            "hierarchy='hierarchical' (the two-level multi-slice reduce) "
            "is not ported yet (ROADMAP.md, queue 1 item 8)")
    if hierarchy not in ("auto", "flat"):
        raise ValueError(f"unknown hierarchy {hierarchy!r} "
                         "(auto|flat|hierarchical)")
    if gather not in ("bucketed", "per_leaf"):
        raise ValueError(f"unknown gather mode {gather!r} "
                         "(bucketed|per_leaf)")
    if prefetch < 0:
        raise ValueError(f"prefetch must be >= 0, got {prefetch}")
    if quant and gather != "bucketed":
        raise ValueError(
            "quant=True quantizes the BUCKETED gather wire format; "
            f"gather={gather!r} has no bucket boundary to quantize at")
    if loss_of is None:
        loss_of = lambda logits, batch: cross_entropy_loss(logits,
                                                           batch["y"])
    # Cold-start plane: whether the step's libraries resolved through
    # the cache yet.
    resolved = []

    def stepper(state: TrainState, batch: Dict[str, Any]):
        model = state.model
        params = [p for p in model.parameters()]
        if aot_cache is not None and not resolved:
            from tony_tpu_torch.ops import _build

            _build.resolve(_step_libraries(model, update), cache=aot_cache)
            resolved.append(True)

        def loss_fn(mb):
            extra = apply_kwargs_of(mb) if apply_kwargs_of else {}
            logits = model(mb["x"], **extra)
            aux = torch.zeros((), dtype=torch.float32, device=logits.device)
            return loss_of(logits, mb) + aux, aux

        mesh_kw = {}
        if mesh is not None:
            mesh_kw = dict(reduce_op=reduce_op,
                           param_specs=fsdp_param_specs(params, mesh),
                           hierarchy=hierarchy, gather=gather,
                           prefetch=prefetch, module=model)
        if quant:
            mesh_kw["quant_amax"] = _quant_amax(state, mesh, update,
                                                bucket_bytes)
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
            loss, aux, gnorm, *amax = microbatch_grads(
                loss_fn, params, batch, mesh, microbatches=microbatches,
                resident=state.buckets, fused=tx,
                opt_slots=state.opt_state["slots"], opt_scal=scal,
                **mesh_kw)
            state.opt_state = {"count": count,
                               "slots": state.opt_state["slots"]}
        else:
            if not isinstance(state.tx, GradientTransformation):
                raise ValueError(
                    f"update='optax' needs a state whose tx is a "
                    f"GradientTransformation, got {type(state.tx)}")
            loss, aux, grads, *amax = microbatch_grads(
                loss_fn, params, batch, mesh, microbatches=microbatches,
                bucket_bytes=bucket_bytes, **mesh_kw)
            gnorm = sharded_global_norm(grads, params, mesh) \
                if mesh_kw.get("param_specs") is not None \
                else global_norm(grads)
            state.opt_state = state.tx.update(grads, state.opt_state, params)
        if quant:
            state.quant_state = {"amax": amax[0]}
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm, "aux_loss": aux}

    return stepper


def _quant_amax(state: Any, mesh: Optional[Mesh], update: str,
                bucket_bytes: int) -> List[torch.Tensor]:
    """The quantized step's amax histories, after checking that the state
    rides the lane with the step's bucket plan."""
    from tony_tpu_torch.ops import quant as quant_mod

    if mesh is None:
        raise ValueError("quant=True quantizes the ZeRO-3 gathers: it needs "
                         "a mesh")
    if not quant_mod.is_quant_state(state):
        raise ValueError(
            "quant=True needs a QuantTrainState carrying the "
            "delayed-scaling amax state — attach it with "
            "tony_tpu_torch.ops.quant.with_gather_quant(state, mesh)")
    bb = getattr(state.tx, "bucket_bytes", bucket_bytes) \
        if update == "fused_bucket" else bucket_bytes
    if state.qconfig.bucket_bytes != bb:
        raise ValueError(
            f"quant=True: the state's QuantConfig.bucket_bytes="
            f"{state.qconfig.bucket_bytes} disagrees with the step's {bb} "
            f"— the amax histories were sized for a different bucket "
            f"plan; rebuild with with_gather_quant(bucket_bytes={bb})")
    return state.quant_state["amax"]


def _step_libraries(model: nn.Module, update: str) -> Tuple[str, ...]:
    """The kernel libraries a train step of ``model`` launches on the
    card: flash attention where a decoder attends with ``"flash"``, the
    BN kernels on the fused BN lane, the int8 GEMM where a projection is
    quantized, the fused optimizer under ``update="fused_bucket"``; none
    on the CPU."""
    if next(model.parameters()).device.type != "cuda":
        return ()
    from tony_tpu_torch.models.resnet import FusedBNAct
    from tony_tpu_torch.ops.quant import QuantDense

    modules = list(model.modules())
    names = []
    if getattr(getattr(model, "cfg", None), "attention", None) == "flash":
        names.append("flash_attention")
    if any(isinstance(m, FusedBNAct) for m in modules):
        names.append("batchnorm")
    if any(isinstance(m, QuantDense) for m in modules):
        names.append("int8_matmul")
    if update == "fused_bucket":
        names.append("fused_optim")
    return tuple(names)


def shared_aot_cache(path: Optional[str] = None):
    """The gang-shared train AOT cache for ``make_accum_train_step(
    aot_cache=...)``, or ``None`` when the plane is unarmed. ``path``
    defaults from ``TONY_TRAIN_AOT_CACHE`` (``tony.train.aot-cache``),
    so a script arms it with one keyword and runs unchanged elsewhere.
    Every worker opens the SAME durable directory: the first to resolve
    a fingerprint builds and populates it (first writer wins), the rest
    load the libraries without ``nvcc``."""
    path = path or os.environ.get(constants.ENV_TRAIN_AOT_CACHE) or None
    if not path:
        return None
    return ckpt.AOTCache(path)


def _job_conf() -> conf.TonyConfig:
    """The job conf the executor hands a task (``TONY_CONF_PATH``); an
    empty one outside a job or where the file cannot be read."""
    path = os.environ.get(constants.ENV_CONF_PATH)
    if path:
        try:
            return conf.TonyConfig.load(path)
        except (OSError, ValueError):
            _log.warning("cannot read the job conf %s", path)
    return conf.TonyConfig()


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
    ``TONY_CKPT_EVERY`` / ``TONY_CKPT_KEEP`` and, where a variable is
    unset, from ``tony.ckpt.dir`` / ``.every`` / ``.keep`` of the job
    conf at ``TONY_CONF_PATH`` (what ``JAXRuntime`` exports to a jax
    task, read here for a ``--framework pytorch`` one; every 0, keep 3);
    with no directory the loop is a plain fold.

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
    job = _job_conf()
    if ckpt_dir is None:
        ckpt_dir = os.environ.get(constants.ENV_CKPT_DIR) \
            or job.get(conf.CKPT_DIR) or None
    if save_every is None:
        save_every = int(os.environ.get(constants.ENV_CKPT_EVERY) or
                         job.get_int(conf.CKPT_EVERY, 0))
    if keep is None:
        keep = int(os.environ.get(constants.ENV_CKPT_KEEP) or
                   job.get_int(conf.CKPT_KEEP, 3))
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
