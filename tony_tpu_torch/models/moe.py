"""Mixture-of-experts layer: the counterpart of :mod:`tony_tpu.models.moe`.

The routing is the reference's GShard/Switch formulation with a static
expert capacity ``C``: top-k experts a token, a token's slot in its
expert's queue counting the earlier tokens of its group and the slots
taken by earlier top-k rounds, over-capacity tokens dropped (their
residual path carries them), the combine weights renormalised over the
kept choices and the Switch load-balancing loss read from the first
choice. :func:`router_assignment` returns the reference's dense
``dispatch``/``combine`` tensors; :class:`MoEMLP` keeps the same routing
as indices (:func:`route`) and moves the tokens by gather instead of by
one-hot einsums. A capacity slot holds at most one token and a token at
most ``top_k`` slots, so the dispatch is the einsum's values exactly,
and the combine is too wherever the products are exact in f32 (bf16
operands, the model's dtype).

The expert weights are stacked on a leading expert dim in the
reference's layout, ``w_gate``/``w_up`` ``[E, D, F]`` and ``w_down``
``[E, F, D]``, beside the f32 router ``w_router`` ``[D, E]``. On a mesh
with an ``expert`` axis (:func:`tony_tpu_torch.train.create_train_state`
attaches it) each rank holds ``E/ep`` experts and the slots cross ranks
through :func:`tony_tpu_torch.parallel.sched.moe_dispatch_ffn_combine`,
one ``all_to_all`` each way per capacity chunk. The forward returns the
auxiliary loss beside the output instead of sowing it, so a block
recomputed under remat cannot count it twice.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tony_tpu_torch.models import lecun_normal_


class Routes(NamedTuple):
    """The top-k assignment of ``[G, S]`` tokens, one row per round:
    ``expert`` and ``pos`` (the slot in that expert's queue) as int64,
    ``fits`` whether the slot is below the capacity, and ``weight`` the
    renormalised combine weight in f32 (0 for a dropped choice); ``aux``
    is the un-scaled Switch loss. Each field but ``aux`` is
    ``[top_k, G, S]``."""
    expert: torch.Tensor
    pos: torch.Tensor
    fits: torch.Tensor
    weight: torch.Tensor
    aux: torch.Tensor


def capacity_of(tokens: int, top_k: int, n_experts: int,
                capacity_factor: float) -> int:
    """The reference's static capacity, in its Python float arithmetic."""
    return max(1, int(capacity_factor * tokens * top_k / n_experts))


def route(gates: torch.Tensor, top_k: int, capacity: int,
          choices: Optional[torch.Tensor] = None) -> Routes:
    """The reference's ``router_assignment`` as indices. ``gates`` is
    ``[G, S, E]`` f32 router probabilities (softmax over E). ``choices``
    (``[top_k, G, S]``, another call's ``expert``) pins each round's
    expert instead of its argmax: how two numerically different runs of
    a layer are compared on the same routing."""
    g, s, e = gates.shape
    if top_k > e:
        raise ValueError(f"top_k={top_k} exceeds n_experts={e}")
    remaining = gates
    taken = gates.new_zeros(g, e)
    experts, positions, fitted, weights = [], [], [], []
    for i in range(top_k):
        choice = remaining.argmax(dim=-1) if choices is None \
            else choices[i]                                     # [G, S]
        onehot = F.one_hot(choice, e).to(gates.dtype)           # [G, S, E]
        pos = onehot.cumsum(dim=1) - onehot + taken[:, None, :]
        pos = (pos * onehot).sum(dim=-1).long()                 # [G, S]
        fits = pos < capacity
        taken = taken + (onehot * fits[..., None]).sum(dim=1)
        weights.append((gates * onehot).sum(dim=-1) * fits)
        experts.append(choice)
        positions.append(pos)
        fitted.append(fits)
        # -inf, not 0: a chosen expert can never win argmax again while
        # an unchosen one remains, even if the rest underflowed to 0.
        remaining = remaining.masked_fill(onehot > 0, float("-inf"))
    weight = torch.stack(weights)
    total = weight.sum(dim=0)
    weight = torch.where(total > 0, weight / total.clamp_min(1e-9),
                         torch.zeros_like(weight))
    first = F.one_hot(gates.argmax(dim=-1), e).to(gates.dtype)
    frac = first.mean(dim=1)                 # [G, E] fraction routed
    prob = gates.mean(dim=1)                 # [G, E] mean probability
    aux = e * (frac * prob).sum(dim=-1).mean()
    return Routes(torch.stack(experts), torch.stack(positions),
                  torch.stack(fitted), weight, aux)


def router_assignment(gates: torch.Tensor, top_k: int, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's dense form: ``dispatch`` ``[G, S, E, C]`` one-hot
    f32 (token s of group g holds slot c of expert e), ``combine`` the
    dispatch weighted by the renormalised router probability, and the
    un-scaled Switch aux loss."""
    r = route(gates, top_k, capacity)
    g, s, e = gates.shape
    hot = F.one_hot(r.expert, e).to(gates.dtype)[..., None] \
        * F.one_hot(r.pos.clamp_max(capacity), capacity + 1)[
            ..., None, :capacity].to(gates.dtype) \
        * r.fits[..., None, None]                          # [k, G, S, E, C]
    return hot.sum(dim=0), (hot * r.weight[..., None, None]).sum(dim=0), \
        r.aux


class Slots(NamedTuple):
    """Where the routed tokens sit in the ``[E, G, C]`` slot grid:
    ``source`` the flat token (``g·S + s``) each slot holds, ``G·S`` for
    an empty slot (a zero row), and ``slot`` each choice's flat slot
    ``(e·G + g)·C + c``, ``E·G·C`` for a dropped one (a zero row);
    ``weight`` the choices' combine weights ``[G, S, k]``."""
    source: torch.Tensor
    slot: torch.Tensor
    weight: torch.Tensor
    capacity: int


def slots_of(r: Routes, n_experts: int, capacity: int) -> Slots:
    """The slot grid of ``r`` over ``n_experts`` experts."""
    k, g, s = r.expert.shape
    n = n_experts * g * capacity
    rows = torch.arange(g, device=r.expert.device)[:, None]
    slot = (r.expert * g + rows) * capacity + r.pos
    slot = torch.where(r.fits, slot, torch.full_like(slot, n))
    token = (rows * s + torch.arange(s, device=slot.device)).expand(k, g, s)
    source = torch.full((n + 1,), g * s, dtype=torch.long,
                        device=slot.device)
    source.scatter_(0, slot.reshape(-1), token.reshape(-1))
    source[n] = g * s
    return Slots(source[:n], slot.permute(1, 2, 0),
                 r.weight.permute(1, 2, 0), capacity)


def dispatch(x: torch.Tensor, slots: Slots, n_experts: int) -> torch.Tensor:
    """``[G, S, D]`` tokens into their ``[E, G, C, D]`` slots (empty slots
    zero): the reference's dispatch einsum as a gather. Its backward adds
    at most ``top_k`` rows into each token (and zeros into the empty
    slots' zero row), so the order of those adds changes no bit."""
    g, s, d = x.shape
    rows = torch.cat([x.reshape(g * s, d), x.new_zeros(1, d)])
    return rows.index_select(0, slots.source).view(
        n_experts, g, slots.capacity, d)


def combine(out: torch.Tensor, slots: Slots, dtype: torch.dtype
            ) -> torch.Tensor:
    """``[E, G, C, D]`` expert outputs back to ``[G, S, D]`` token order,
    each token the weighted sum of its kept choices: the reference's
    combine einsum (weights cast to ``dtype``, products summed in f32,
    the result in ``dtype``)."""
    d = out.shape[-1]
    rows = torch.cat([out.reshape(-1, d), out.new_zeros(1, d)])
    picked = rows.index_select(0, slots.slot.reshape(-1)).view(
        slots.slot.shape + (d,))                           # [G, S, k, D]
    w = slots.weight.to(dtype).float()[..., None]
    return (w * picked.float()).sum(dim=-2).to(dtype)


def swiglu_experts(xin: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its own rows: ``xin`` ``[E, N, D]`` with
    the stacked weights in the compute dtype, one batched product each."""
    h = F.silu(torch.bmm(xin, w_gate)) * torch.bmm(xin, w_up)
    return torch.bmm(h, w_down)


class MoEMLP(nn.Module):
    """Expert-parallel SwiGLU FFN, the dense MLP's drop-in: ``[B, T, D]``
    in, ``(y [B, T, D], aux_coef · aux)`` out. Groups are the batch rows.

    ``mesh`` is None until a train state on a mesh with ``ep > 1``
    attaches it; then the parameters hold this rank's ``E/ep`` experts
    and the slots cross ranks in ``a2a_chunks`` capacity chunks with
    ``explicit_a2a`` (one exchange each way without: the reference's
    GSPMD einsum path moves the same bytes in one). A decoder builds its
    blocks' layers with the defaults, as the reference's does; set the
    two attributes on them to chunk the exchange."""

    def __init__(self, dim: int, ffn_hidden: int, n_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 aux_coef: float = 0.01, dtype: torch.dtype = torch.bfloat16,
                 explicit_a2a: bool = False, a2a_chunks: int = 2,
                 device: Optional[torch.device] = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.ffn_hidden, self.n_experts = dim, ffn_hidden, n_experts
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.aux_coef, self.dtype = aux_coef, dtype
        self.explicit_a2a, self.a2a_chunks = explicit_a2a, a2a_chunks
        self.mesh: Any = None
        # The router is f32 whatever the storage type, as the reference's.
        self.w_router = nn.Parameter(torch.empty(
            dim, n_experts, dtype=torch.float32, device=device))
        self.w_gate = nn.Parameter(torch.empty(
            n_experts, dim, ffn_hidden, dtype=param_dtype, device=device))
        self.w_up = nn.Parameter(torch.empty(
            n_experts, dim, ffn_hidden, dtype=param_dtype, device=device))
        self.w_down = nn.Parameter(torch.empty(
            n_experts, ffn_hidden, dim, dtype=param_dtype, device=device))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """flax's ``lecun_normal`` on the reference's layouts: fan-in is
        every dim but the last (flax counts the stacked expert dim as a
        receptive field)."""
        for w in (self.w_router, self.w_gate, self.w_up, self.w_down):
            lecun_normal_(w, gen, fan_in=w.numel() // w.shape[-1])

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, _ = x.shape
        e = self.n_experts
        capacity = capacity_of(t, self.top_k, e, self.capacity_factor)
        gates = torch.softmax(x.float() @ self.w_router, dim=-1)
        r = route(gates, self.top_k, capacity)
        slots = slots_of(r, e, capacity)
        weights = tuple(w.to(self.dtype)
                        for w in (self.w_gate, self.w_up, self.w_down))
        xin = dispatch(x.to(self.dtype), slots, e)
        if self.mesh is not None:
            from tony_tpu_torch.parallel import sched

            out = sched.moe_dispatch_ffn_combine(
                xin, weights, self.mesh,
                chunks=self.a2a_chunks if self.explicit_a2a else 1)
        else:
            out = swiglu_experts(xin.view(e, b * capacity, -1),
                                 *weights).view(xin.shape)
        return combine(out, slots, self.dtype), self.aux_coef * r.aux


@contextlib.contextmanager
def routing(model: nn.Module, seen: Optional[Dict[int, torch.Tensor]] = None,
            pin: Optional[Any] = None) -> Iterator[None]:
    """Within the block, each MoE layer of ``model`` (by its index among
    them) records the expert choices of its first call (:func:`route`'s
    ``expert``) into ``seen``, or takes them from ``pin[index]``: how two
    numerically different runs of one model are compared on one routing
    (remat's recomputation calls a layer again, with the same choices)."""
    layers = [m for m in model.modules() if isinstance(m, MoEMLP)]
    current = [0]
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, i=i: current.__setitem__(0, i))
        for i, m in enumerate(layers)]
    plain = globals()["route"]

    def routed(gates, top_k, capacity):
        i = current[0]
        r = plain(gates, top_k, capacity, None if pin is None else pin[i])
        if seen is not None:
            seen.setdefault(i, r.expert)
        return r

    globals()["route"] = routed
    try:
        yield
    finally:
        globals()["route"] = plain
        for h in hooks:
            h.remove()
