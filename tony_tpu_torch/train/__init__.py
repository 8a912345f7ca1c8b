"""Training step: the counterpart of :mod:`tony_tpu.train` for one device.

* :func:`cross_entropy_loss`, :func:`next_token_loss` — mean softmax
  cross entropy on f32 logits, and its causal-LM shift;
* :func:`adamw` — AdamW in optax's order of operations
  (``scale_by_adam`` → ``add_decayed_weights`` → ``scale_by_learning_rate``,
  then ``apply_updates`` as ``p + u``), with optax's defaults;
* :func:`create_train_state` and :func:`make_train_step` — one step is
  loss → grad → update, returning ``{"loss", "grad_norm", "aux_loss"}``.

The module holds its parameters (an ``nn.Module``), so the train state
wraps the model, and a step updates parameters and optimizer slots in
place — the counterpart of the JAX step's donated state. Meshes, the
sequence axis and the fused bucket optimizer are later slices
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

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
        # 1 - b**count in f32, as optax; its compiled power may differ from
        # this one in the last bit.
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
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
class TrainState:
    """The model (which holds the parameters), its optimizer and the
    optimizer's state; ``step`` counts applied updates."""
    step: int
    model: nn.Module
    tx: GradientTransformation
    opt_state: Any


def create_train_state(model: nn.Module, tx: GradientTransformation,
                       mesh: Optional[Any] = None) -> TrainState:
    """A train state over ``model``'s own (already initialised or loaded)
    parameters. One device only: a mesh, or an optimizer other than a
    :class:`GradientTransformation` (the JAX package's FusedOptimizer),
    raises ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError(f"sharded training states are not ported "
                                  f"yet ({_LATER})")
    if not isinstance(tx, GradientTransformation):
        raise NotImplementedError(
            f"optimizer {type(tx).__name__} is not ported; the fused bucket "
            f"optimizer lands with its slice ({_LATER})")
    params = [p for p in model.parameters()]
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
