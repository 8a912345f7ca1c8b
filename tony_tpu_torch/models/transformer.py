"""Llama-style decoder: the counterpart of
:mod:`tony_tpu.models.transformer`.

Two forwards:

* training (``kv=None``): tokens ``[b, t]`` at positions ``arange(t)``
  (or given), causal attention through
  :func:`tony_tpu_torch.ops.flash_attention_packed` (head_dim a multiple
  of 128, no mesh — the JAX module's packed route),
  :func:`~tony_tpu_torch.ops.flash_attention` (any other head_dim) or
  :func:`~tony_tpu_torch.ops.reference_attention`; with ``remat`` each
  block runs under ``torch.utils.checkpoint`` (the counterpart of
  ``nn.remat``), and ``remat_policy`` keeps the matmul outputs
  (``"dots"``: ``mm``/``addmm``/``bmm``; ``"dots_no_batch"``: the
  batch-free ``mm``/``addmm``) through selective checkpointing. Returns
  f32 logits and runs with autograd; with ``xent_chunk`` and
  ``targets`` it returns the fused LM-head loss instead
  (:func:`tony_tpu_torch.train.chunked_next_token_xent`), which never
  builds the ``[b, t, vocab]`` logits. A mixture-of-experts decoder
  (``moe_experts > 0``: each block's FFN is a
  :class:`~tony_tpu_torch.models.moe.MoEMLP` named ``moe_mlp``) returns
  ``(logits or loss, aux)``, ``aux`` the blocks' scaled load-balancing
  losses summed over layers: a value each block returns, so a block
  recomputed under remat does not add it twice.
* serving (``kv=``): the t rows are NEW tokens at per-sequence absolute
  ``positions`` ``[b, t]``, the context lives in a per-layer KV buffer
  ``[b, width, n_kv_heads·head_dim]`` of which attention reads the first
  ``ctx`` columns (column ``ctx`` is a sink), the rows' post-rope k/v
  are written into that buffer before attention (so a row attends
  itself and everything the cache holds below its position), attention
  runs through :func:`tony_tpu_torch.ops.flash_decode`, and the raw rows
  come back for the engine to commit into its paged pool. Runs under
  inference mode. A MoE decoder refuses it, as the reference does.

On a mesh with a ``model`` or ``seq`` axis (``TransformerConfig.mesh``,
or the mesh :func:`tony_tpu_torch.train.create_train_state` hands the
model, which cuts the parameters with
:func:`tony_tpu_torch.parallel.tensor.shard_model`) the training forward
is Megatron's, the collectives the reference gets from GSPMD written by
hand (:mod:`tony_tpu_torch.parallel.tensor`): ``wq``/``wk``/``wv``,
``w_gate``/``w_up`` and the LM head are column shards, ``wo`` and
``w_down`` row shards, the embedding a vocab shard; each rank attends
its ``n_heads/tp`` local heads with the classic ``[B, H, T, D]`` flash
kernels (not the packed ones, as the JAX module's mesh route), K/V
repeated up to the query heads where the kv heads do not divide ``tp``.
With ``seq > 1`` (or ``attention="ring"``) each rank holds ``T/sp``
positions at their global offset and attention is
:func:`tony_tpu_torch.parallel.ring_attention.ring_attention`. The
logits are this rank's vocab columns and positions, returned as
:class:`tony_tpu_torch.parallel.tensor.ShardedLogits` for the
vocab-parallel losses.

On a mesh with a ``pipe`` axis (``MeshSpec(dp=, pp=)``)
:func:`tony_tpu_torch.train.create_train_state` cuts the decoder to this
rank's stage (:meth:`Transformer.cut_to_stage`): its ``layers`` are the
stage's blocks, which run with no mesh (the packed flash route), and the
training forward is :func:`tony_tpu_torch.parallel.pipeline.
pipelined_lm_logits`; the whole-model forward raises there.

Both forwards run the ``quant=`` lanes (:meth:`TransformerConfig.quant_lanes`):
a projection group in the set computes through
:class:`tony_tpu_torch.ops.quant.QuantDense` (int8 × int8 → int32 on the
card's int8 kernel, f32 rescale) instead of :class:`Dense`, with the
same ``*.weight`` parameter names either way.

The numerics follow the JAX module: parameters stored in
``param_dtype`` (f32 by default, as the JAX module's ``param_dtype``),
cast to ``cfg.dtype`` where they are used (projections and the embedded
rows; a server stores ``cfg.dtype`` directly, which gives the same bits
as casting at every use), RMSNorm in f32 with an f32 scale,
interleaved-pair rotary embeddings computed in f32 by bf16×f32
promotion, logits in f32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import (Any, Callable, List, NamedTuple, Optional, Tuple,
                    Union)

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models import lecun_normal_, register
from tony_tpu_torch.models.convert import params_from_jax, params_to_jax
from tony_tpu_torch.models.moe import MoEMLP
from tony_tpu_torch.ops import (flash_attention, flash_attention_packed,
                                flash_decode, reference_attention)
from tony_tpu_torch.ops.quant import QuantDense
from tony_tpu_torch.parallel import DATA, MODEL, PIPE, SEQ, Mesh
from tony_tpu_torch.parallel.layout import Layout, set_layout
from tony_tpu_torch.parallel import tensor as tpar
from tony_tpu_torch.parallel.ring_attention import ring_attention
from tony_tpu_torch.train import chunked_next_token_xent

_LATER = "ROADMAP.md, queue 1"

_aten = torch.ops.aten
# remat_policy → the aten products whose outputs a remat block keeps for
# the backward (JAX's checkpoint_dots and
# dots_with_no_batch_dims_saveable: the attention einsums of
# attention="reference" are bmm). Everything else is recomputed, the
# flash kernels too: their launches write buffers the dispatcher never
# sees, so no policy may keep one (a Pallas call is no dot_general in
# JAX either).
REMAT_SAVED = {
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_hidden: int = 11008
    max_seq: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # The fields below shape the training forward; the serving forward
    # ignores attention/scan_layers/remat/remat_policy/xent_chunk (a plain
    # layer loop, no gradients, the plain head). scan_layers only names
    # the JAX param layout (convert.py reads both). mesh: a built
    # tony_tpu_torch.parallel.Mesh whose seq and model axes the training
    # forward runs over (attention="ring" needs one; an expert mesh
    # reaches the MoE blocks through create_train_state instead).
    # quant: which projection groups run the int8 lane — True means
    # ("qkv", "o", "mlp"); a string or tuple selects ("lm_head" opts the
    # unembed in).
    attention: str = "flash"
    scan_layers: bool = True
    remat: bool = True
    remat_policy: Optional[str] = None
    mesh: Optional[Any] = None
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    xent_chunk: int = 0
    quant: Any = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def quant_lanes(self) -> frozenset:
        """The validated set of quantized projection groups."""
        if not self.quant:
            return frozenset()
        lanes = ("qkv", "o", "mlp") if self.quant is True else (
            (self.quant,) if isinstance(self.quant, str)
            else tuple(self.quant))
        unknown = set(lanes) - {"qkv", "o", "mlp", "lm_head"}
        if unknown:
            raise ValueError(
                f"unknown quant lane(s) {sorted(unknown)} — choose from "
                f"('qkv', 'o', 'mlp', 'lm_head')")
        if "lm_head" in lanes and self.xent_chunk:
            raise ValueError(
                "quant lane 'lm_head' is not supported with xent_chunk "
                "(the fused head+loss consumes the kernel row-chunked; "
                "quantize it separately or drop the lane)")
        return frozenset(lanes)

    def flops_per_token(self) -> int:
        """≈6·N_matmul FLOPs per trained token (fwd+bwd), plus attention's
        12·L·dim·seq term — matmul-FLOPs-only accounting (the embedding
        gather counts zero; for MoE only the top-k experts' FFN)."""
        ffn_active = 3 * self.dim * self.ffn_hidden
        if self.moe_experts > 0:
            ffn_active = (self.moe_top_k * ffn_active
                          + self.dim * self.moe_experts)
        n_params = (
            self.vocab * self.dim
            + self.n_layers * (
                self.dim * self.head_dim
                * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * self.head_dim * self.dim
                + ffn_active))
        return 6 * n_params + 12 * self.n_layers * self.dim * self.max_seq


RopeTables = Tuple[torch.Tensor, torch.Tensor]


def rope_tables(positions: torch.Tensor, d: int, theta: float
                ) -> RopeTables:
    """cos/sin of the rotary angles for positions [T] (shared across the
    batch; tables [T, D/2]) or [B, T] (per-sequence; [B, T, D/2]), in f32.
    A forward computes them once and every layer's q and k reuse them."""
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=positions.device) / d)
    if positions.ndim == 2:
        angles = positions[..., None].float() * freqs        # [B, T, D/2]
    else:
        angles = positions[:, None].float() * freqs[None, :]  # [T, D/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, tables: RopeTables,
               seq_axis: int = 2) -> torch.Tensor:
    """Rotate ``x`` (sequence dim at ``seq_axis``) by precomputed tables.
    Interleaved pairs ``x[..., ::2]``/``x[..., 1::2]``, re-stacked on a
    new last axis (not the rotate-half convention)."""
    cos, sin = tables
    shape = [1] * x.ndim
    shape[-1] = x.shape[-1] // 2
    if cos.ndim == 3:
        shape[0] = cos.shape[0]
    shape[seq_axis] = cos.shape[-2]
    cos, sin = cos.reshape(shape), sin.reshape(shape)
    x1, x2 = x[..., ::2], x[..., 1::2]
    # bf16 × f32 promotes to f32, as in the JAX module.
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True)
                              + self.eps)
        return (y * self.scale).to(x.dtype)


# The weight casts shared_weight_casts() keeps, per thread: (weight id,
# grad mode) -> (weight, its cast).
_CASTS = threading.local()


@contextlib.contextmanager
def shared_weight_casts():
    """Within the context each :class:`Dense` weight is cast to its
    compute dtype once (once with autograd, once without) and every call
    reuses that cast and its autograd node: a pipeline stage's
    microbatches then keep one compute-dtype copy of the stage's weights
    for their backward, not one each. The same values as casting at
    every use."""
    prev = getattr(_CASTS, "table", None)
    _CASTS.table = {}
    try:
        yield
    finally:
        _CASTS.table = prev


def _cast(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    table = getattr(_CASTS, "table", None)
    if table is None or weight.dtype == dtype:
        return weight.to(dtype)
    key = (id(weight), torch.is_grad_enabled())
    hit = table.get(key)
    if hit is None or hit[0] is not weight:
        hit = table[key] = (weight, weight.to(dtype))
    return hit[1]


class Dense(nn.Linear):
    """A bias-free projection that computes in ``compute_dtype`` whatever
    its weight is stored in (flax ``nn.Dense(dtype=..., param_dtype=...)``:
    input and kernel cast to the compute type at use)."""

    def __init__(self, n_in: int, n_out: int, compute_dtype: torch.dtype,
                 param_dtype: torch.dtype, device: torch.device):
        super().__init__(n_in, n_out, bias=False, dtype=param_dtype,
                         device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.compute_dtype),
                        _cast(self.weight, self.compute_dtype))


def _proj_dense(cfg: TransformerConfig, lane: str, n_in: int, n_out: int,
                device: torch.device, param_dtype: torch.dtype) -> nn.Linear:
    """One projection on either compute lane (transformer.py:148-162):
    :class:`Dense` or, when ``lane`` is in the config's quant set, its
    quantized twin; the parameter is ``weight [n_out, n_in]`` either way,
    so weights move freely between the lanes."""
    if lane in cfg.quant_lanes():
        return QuantDense(n_in, n_out, dtype=cfg.dtype,
                          param_dtype=param_dtype, device=device)
    return Dense(n_in, n_out, cfg.dtype, param_dtype, device)


# Per-layer KV buffers: (k_buf, v_buf), each [b, width, n_kv_heads·head_dim]
# with width > ctx, the attended extent: column ctx is the sink.
LayerKV = Tuple[torch.Tensor, torch.Tensor]


class _Keep(NamedTuple):
    """Where one serve forward's rows land in the per-layer buffers,
    decided once a forward: ``ctx`` is the attended extent, and row
    (i, j) lands at column ``sink[i, j] = min(positions[i, j], ctx)`` of
    batch ``batch[i, j]`` (device tensors, no host sync)."""
    ctx: int
    batch: torch.Tensor
    sink: torch.Tensor


def _keep_of(positions: torch.Tensor, width: int,
             ctx: Optional[int]) -> _Keep:
    if ctx is None or not 0 < ctx < width:
        raise ValueError(
            f"the serve forward needs ctx, the attended extent, below the "
            f"KV buffers' width (column ctx is the sink for rows past "
            f"it): got ctx={ctx} for a {width}-column buffer")
    b, t = positions.shape
    batch = torch.arange(b, device=positions.device)[:, None].expand(b, t)
    return _Keep(ctx, batch, positions.long().clamp(0, ctx))


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device,
                 param_dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        self.wq = _proj_dense(cfg, "qkv", cfg.dim, nh * hd, device,
                              param_dtype)
        self.wk = _proj_dense(cfg, "qkv", cfg.dim, nkv * hd, device,
                              param_dtype)
        self.wv = _proj_dense(cfg, "qkv", cfg.dim, nkv * hd, device,
                              param_dtype)
        self.wo = _proj_dense(cfg, "o", nh * hd, cfg.dim, device,
                              param_dtype)
        self.mesh = _block_mesh(cfg.mesh)

    def forward(self, x: torch.Tensor, tables: RopeTables) -> torch.Tensor:
        """Training forward: causal self-attention over the t rows, routed
        as the JAX module routes it (transformer.py:237-287)."""
        cfg = self.cfg
        if self.mesh is not None:
            return self._forward_mesh(x, tables, self.mesh)
        b, t, _ = x.shape
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        if cfg.attention == "flash" and hd % 128 == 0:
            # Packed layout: the kernels read the heads of the natural
            # [b, t, h·d] projections as strided views, and GQA K/V stay
            # at [b, t, nkv·hd]; no transpose is copied.
            q4 = apply_rope(q.view(b, t, nh, hd), tables, seq_axis=1)
            k4 = apply_rope(k.view(b, t, nkv, hd), tables, seq_axis=1)
            out = flash_attention_packed(q4.view(b, t, nh * hd),
                                         k4.view(b, t, nkv * hd), v, nh,
                                         causal=True)
            return self.wo(out)
        q = apply_rope(q.view(b, t, nh, hd).transpose(1, 2), tables)
        k = apply_rope(k.view(b, t, nkv, hd).transpose(1, 2), tables)
        v = v.view(b, t, nkv, hd).transpose(1, 2)
        attend = (flash_attention if cfg.attention == "flash"
                  else reference_attention)
        out = attend(q, k, v, causal=True)
        return self.wo(out.transpose(1, 2).reshape(b, t, nh * hd))

    def _forward_mesh(self, x: torch.Tensor, tables: RopeTables,
                      mesh: Mesh) -> torch.Tensor:
        """The training forward on this rank's local heads (``wq``,
        ``wk``, ``wv`` column shards, ``wo`` a row shard), over its seq
        shard with ring attention where the mesh has one."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd, tp = cfg.head_dim, mesh.shape[MODEL]
        nh = cfg.n_heads // tp
        x = tpar.copy_to_model(x, mesh)
        q = self.wq(x).view(b, t, nh, hd)
        if cfg.n_kv_heads % tp == 0:
            nkv = cfg.n_kv_heads // tp
            k = self.wk(x).view(b, t, nkv, hd)
            v = self.wv(x).view(b, t, nkv, hd)
        else:
            # The kv heads do not divide tp: every rank projects them all
            # (its weight grads summed over the model group) and repeats
            # them up to its query heads, as the reference repeats K/V.
            reps, first = cfg.n_heads // cfg.n_kv_heads, \
                mesh.coords()[MODEL] * nh
            k, v = (F.linear(x.to(cfg.dtype), tpar.copy_to_model(
                w.weight, mesh).to(cfg.dtype)).view(b, t, cfg.n_kv_heads, hd)
                .repeat_interleave(reps, dim=2).narrow(2, first, nh)
                for w in (self.wk, self.wv))
            nkv = nh
        q = apply_rope(q.transpose(1, 2), tables)
        k = apply_rope(k.transpose(1, 2), tables)
        v = v.transpose(1, 2)
        if cfg.attention == "ring" or mesh.shape[SEQ] > 1:
            out = ring_attention(q, k, v, mesh, causal=True)
        elif cfg.attention == "flash":
            # flash_attention_sharded's body: this rank's heads.
            out = flash_attention(q, k, v, causal=True)
        else:
            out = reference_attention(q, k, v, causal=True)
        out = out.transpose(1, 2).reshape(b, t, nh * hd)
        return tpar.row_parallel(self.wo, out, mesh)

    def serve(self, x: torch.Tensor, positions: torch.Tensor,
              tables: RopeTables, kv: LayerKV, keep: _Keep
              ) -> Tuple[torch.Tensor, LayerKV]:
        cfg = self.cfg
        b, t, _ = x.shape
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        k_buf, v_buf = kv
        q4 = apply_rope(self.wq(x).view(b, t, nh, hd), tables, seq_axis=1)
        k4 = apply_rope(self.wk(x).view(b, t, nkv, hd), tables, seq_axis=1)
        k_rows = k4.reshape(b, t, nkv * hd).to(k_buf.dtype)
        v_rows = self.wv(x).to(v_buf.dtype)
        # Scatter the rows into the buffer in place (it is this forward's
        # private scratch). Rows past the attended extent (padding rows
        # near ctx_max) must write nothing there, like the JAX package's
        # mode="drop" — an out-of-range CUDA index would be a device
        # assert, not a no-op. They land in the sink column
        # (``keep.sink``), past what attention reads, with no host sync.
        # Dummy batch slots write every row to position 0
        # (duplicate indices, an unspecified winner): harmless only
        # because their buffer rows and outputs are private and
        # discarded.
        k_buf[keep.batch, keep.sink] = k_rows
        v_buf[keep.batch, keep.sink] = v_rows
        ctx = keep.ctx
        # [b, ctx, nkv·hd] -> [b, nkv, ctx, hd] views of the attended
        # extent: no copy; the kernel takes the strides.
        out = flash_decode(
            q4.transpose(1, 2),
            k_buf[:, :ctx].view(b, ctx, nkv, hd).transpose(1, 2),
            v_buf[:, :ctx].view(b, ctx, nkv, hd).transpose(1, 2),
            positions)
        out = out.transpose(1, 2).reshape(b, t, nh * hd)
        return self.wo(out), (k_rows, v_rows)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device,
                 param_dtype: torch.dtype):
        super().__init__()
        self.w_gate = _proj_dense(cfg, "mlp", cfg.dim, cfg.ffn_hidden,
                                  device, param_dtype)
        self.w_up = _proj_dense(cfg, "mlp", cfg.dim, cfg.ffn_hidden, device,
                                param_dtype)
        self.w_down = _proj_dense(cfg, "mlp", cfg.ffn_hidden, cfg.dim,
                                  device, param_dtype)
        self.mesh = _block_mesh(cfg.mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """SwiGLU; on a model axis ``w_gate``/``w_up`` are column shards
        and ``w_down`` a row shard."""
        x = tpar.copy_to_model(x, self.mesh)
        return tpar.row_parallel(
            self.w_down, F.silu(self.w_gate(x)) * self.w_up(x), self.mesh)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device,
                 param_dtype: torch.dtype):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.attn = Attention(cfg, device, param_dtype)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        if cfg.moe_experts > 0:
            self.moe_mlp = MoEMLP(
                cfg.dim, cfg.ffn_hidden, cfg.moe_experts,
                top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
                aux_coef=cfg.moe_aux_coef, dtype=cfg.dtype, device=device,
                param_dtype=param_dtype)
        else:
            self.mlp = MLP(cfg, device, param_dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor):
        """The block's output; a MoE block's with its scaled aux loss."""
        x = x + self.attn(self.attn_norm(x), (cos, sin))
        if hasattr(self, "moe_mlp"):
            y, aux = self.moe_mlp(self.mlp_norm(x))
            return x + y, aux
        return x + self.mlp(self.mlp_norm(x))

    def serve(self, x, positions, tables, kv, keep):
        attn_out, new_kv = self.attn.serve(self.attn_norm(x), positions,
                                           tables, kv, keep)
        x = x + attn_out
        x = x + self.mlp(self.mlp_norm(x))
        return x, new_kv


# The reference's logical axes of each parameter (transformer.py:148-155,
# :190, :296, :368, :470), in flax's layout: kernels are ``[in, out]``,
# so a torch ``[out, in]`` weight reads its tuple reversed.
_KERNEL_LOGICAL = {
    "attn.wq": ("embed", "heads"), "attn.wk": ("embed", "kv_heads"),
    "attn.wv": ("embed", "kv_heads"), "attn.wo": ("heads", "embed"),
    "mlp.w_gate": ("embed", "ffn"), "mlp.w_up": ("embed", "ffn"),
    "mlp.w_down": ("ffn", "embed"), "lm_head": ("embed", "vocab"),
}
# The MoE leaves keep the reference's layout, so their tuples read as
# they are (moe.py:109-123).
_MOE_LOGICAL = {
    "moe_mlp.w_router": ("embed", "expert_dim"),
    "moe_mlp.w_gate": ("expert", "embed", "ffn"),
    "moe_mlp.w_up": ("expert", "embed", "ffn"),
    "moe_mlp.w_down": ("expert", "ffn", "embed"),
}


def logical_axes(name: str) -> Tuple[str, ...]:
    """The logical axes of the decoder's parameter ``name`` (a
    ``named_parameters()`` name) in the port's layout: the embedding
    ``("vocab", "embed")``, each projection's weight its flax kernel's
    tuple reversed, the norm scales ``("norm",)``, the MoE leaves the
    reference's tuples (``("expert", "embed", "ffn")`` ...)."""
    if name == "embedding":
        return ("vocab", "embed")
    if name.endswith(".scale"):
        return ("norm",)
    key = name[:-len(".weight")] if name.endswith(".weight") else name
    key = key.split(".", 2)[-1] if key.startswith("layers.") else key
    if key in _MOE_LOGICAL:
        return _MOE_LOGICAL[key]
    if key not in _KERNEL_LOGICAL:
        raise KeyError(f"decoder parameter {name!r} has no logical axes")
    return tuple(reversed(_KERNEL_LOGICAL[key]))


class Transformer(nn.Module):
    # The JAX decoder tree's converter, read by ``load_jax_params``, and
    # its inverse, read by ``jax_param_tree`` (checkpoints).
    params_from_jax = staticmethod(params_from_jax)
    params_to_jax = staticmethod(params_to_jax)
    # Each parameter's logical axes, read by ``train.param_specs``.
    logical_axes = staticmethod(logical_axes)

    def __init__(self, cfg: TransformerConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg.quant_lanes()       # validates the lanes, as the JAX module
        if cfg.attention not in ("flash", "reference", "ring"):
            raise ValueError(f"unknown attention {cfg.attention!r}")
        if cfg.attention == "ring" and cfg.mesh is None:
            # The reference asserts it (transformer.py:268).
            raise ValueError("attention='ring' needs cfg.mesh")
        _check_mesh(cfg, cfg.mesh)
        # As the JAX module: an unknown policy, or a policy without remat,
        # fails loudly instead of silently not applying.
        if cfg.remat_policy is not None \
                and cfg.remat_policy not in REMAT_SAVED:
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
        if cfg.remat_policy is not None and not cfg.remat:
            raise ValueError("remat_policy set but remat=False")
        dev = resolve_device(device)
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty(
            cfg.vocab, cfg.dim, dtype=param_dtype, device=dev))
        self.layers = nn.ModuleList(Block(cfg, dev, param_dtype)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, dev)
        self.lm_head = _proj_dense(cfg, "lm_head", cfg.dim, cfg.vocab, dev,
                                   param_dtype)
        self.mesh = cfg.mesh

    def set_mesh(self, mesh: Optional[Mesh]) -> None:
        """Run the training forward over ``mesh``'s seq and model axes
        (:func:`tony_tpu_torch.parallel.tensor.shard_model` cuts the
        parameters and calls it)."""
        _check_mesh(self.cfg, mesh)
        for m in self.modules():
            if isinstance(m, (Attention, MLP)):
                m.mesh = _block_mesh(mesh)
        self.mesh = mesh

    def whole_under(self, mesh: Mesh) -> List[str]:
        """The parameters whose spec names ``model`` but which stay whole
        on ``mesh``: the K/V projections where the kv heads do not divide
        ``tp``."""
        if self.cfg.n_kv_heads % mesh.shape[MODEL] == 0:
            return []
        return [n for n, _ in self.named_parameters()
                if n.endswith(("attn.wk.weight", "attn.wv.weight"))]

    def cut_to_stage(self, mesh: Mesh) -> None:
        """Keep only this rank's pipeline stage of the block stack: with
        ``S = mesh.shape["pipe"]`` and stage ``s`` (the rank's pipe
        index), layers ``[s·L/S, (s+1)·L/S)``, renumbered from 0; the
        others are dropped. Each kept parameter gets its
        :class:`~tony_tpu_torch.parallel.layout.Layout`: index ``s·L/S +
        i`` of the stacked ``[L, ...]`` leaf, spec ``("pipe", None,
        ...)``, the replica being the rank's data index. The embedding,
        the norms and the head stay whole. The blocks keep running with
        no mesh; the model's own forward then raises (the pipelined one
        is :func:`tony_tpu_torch.parallel.pipeline.
        pipelined_lm_logits`)."""
        _check_mesh(self.cfg, mesh)
        n = self.cfg.n_layers // mesh.shape[PIPE]
        first = mesh.coords()[PIPE] * n
        if len(self.layers) != self.cfg.n_layers:
            raise ValueError(f"the decoder holds {len(self.layers)} of "
                             f"{self.cfg.n_layers} layers: it is cut already")
        self.layers = nn.ModuleList(list(self.layers)[first:first + n])
        replica = mesh.index((DATA,))
        for i, block in enumerate(self.layers):
            for p in block.parameters():
                set_layout(p, Layout((self.cfg.n_layers,) + tuple(p.shape),
                                     (PIPE,) + (None,) * p.dim(), 0,
                                     first + i, replica))
        self.mesh = mesh

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Transformer":
        """The JAX package's init laws from a seeded ``torch.Generator``
        on the model's device: lecun-normal kernels, ``normal(0.02)``
        embedding, ones for the norms, drawn in f32 and cast to the
        storage type. (The same seed does not give the JAX package's
        numbers; tests carry weights across with
        :func:`tony_tpu_torch.models.convert.load_jax_params`.)"""
        dev = self.embedding.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        tmp = torch.empty(self.embedding.shape, dtype=torch.float32,
                          device=dev)
        self.embedding.copy_(tmp.normal_(0.0, 0.02, generator=gen))
        del tmp
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name.endswith(".weight"):
                lecun_normal_(p, gen)
            elif ".moe_mlp." in name:
                # The reference's layout: fan-in is every dim but the last.
                lecun_normal_(p, gen, fan_in=p.numel() // p.shape[-1])
        return self

    def forward(self, tokens: torch.Tensor, targets=None, *,
                positions: Optional[torch.Tensor] = None,
                kv: Union[Tuple[torch.Tensor, torch.Tensor],
                          Callable[[int], LayerKV], None] = None,
                ctx: Optional[int] = None):
        """``kv=None``: the training forward, ``tokens`` [b, t] at
        ``positions`` (default ``arange(t)``, shared over the batch);
        returns f32 logits [b, t, vocab] with autograd, or, with
        ``xent_chunk`` and ``targets`` (the tokens [b, t]), the scalar
        chunked next-token loss; a MoE decoder returns that with its aux
        loss summed over layers, ``(out, aux)``. With ``kv``: the serving
        forward (:meth:`serve`)."""
        if kv is not None:
            return self.serve(tokens, targets, positions=positions, kv=kv,
                              ctx=ctx)
        if ctx is not None:
            raise ValueError("ctx is the serve forward's attended extent; "
                             "pass it with kv=")
        cfg = self.cfg
        if targets is not None and not cfg.xent_chunk:
            raise ValueError("targets are only taken with xent_chunk (the "
                             "fused LM-head loss)")
        mesh = self.mesh
        if mesh is not None:
            _check_sharded(self, mesh)
            if mesh.shape[PIPE] > 1:
                raise ValueError(
                    "the whole decoder's forward on a pipeline mesh: run "
                    "tony_tpu_torch.parallel.pipelined_lm_logits(model, "
                    "tokens, mesh, n_stages=, microbatches=), e.g. as "
                    "make_train_step(forward=...)")
        t = tokens.shape[1]
        if positions is None:
            # Under sp this rank's positions are its shard's, global.
            start = 0 if mesh is None else mesh.coords()[SEQ] * t
            positions = torch.arange(start, start + t, device=tokens.device)
        cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        x = tpar.vocab_parallel_embedding(tokens.long(), self.embedding,
                                          mesh).to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        policy = {}
        if cfg.remat_policy is not None:
            policy["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts,
                list(REMAT_SAVED[cfg.remat_policy]))
        moe = cfg.moe_experts > 0
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.layers:
            if remat:
                x = checkpoint(block, x, cos, sin, use_reentrant=False,
                               **policy)
            else:
                x = block(x, cos, sin)
            if moe:
                x, layer_aux = x
                aux = aux + layer_aux
        x = self.final_norm(x)
        if targets is not None:
            out = chunked_next_token_xent(x, self.lm_head.weight, targets,
                                          cfg.xent_chunk, cfg.dtype)
        elif mesh is not None:
            out = tpar.ShardedLogits.of(tpar.column_parallel(
                self.lm_head, x, mesh).float(), mesh)
        else:
            out = self.lm_head(x).float()
        return (out, aux) if moe else out

    @torch.inference_mode()
    def serve(self, tokens: torch.Tensor, targets=None, *,
              positions: Optional[torch.Tensor] = None,
              kv: Union[Tuple[torch.Tensor, torch.Tensor],
                        Callable[[int], LayerKV], None] = None,
              ctx: Optional[int] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Serve-mode forward: ``tokens`` [b, t] new rows at
        ``positions`` [b, t]; ``kv`` is either the stacked buffers
        ``(k, v)`` of shape [n_layers, b, width, kv_dim] or a callable
        ``layer -> (k_buf, v_buf)`` that gathers layer i's buffers just
        before layer i runs. The buffers are written in place (they are
        scratch for this forward). Returns
        ``(logits f32 [b, t, vocab], (k_rows, v_rows))`` with the fresh
        rows stacked [n_layers, b, t, kv_dim].

        ``ctx`` is the extent attention reads, below the buffers' width
        (the JAX package's buffers are ``ctx`` wide; these hold one more
        column at least). Rows at a position at or past ``ctx`` write
        nothing the attention reads, as the JAX package's
        ``mode="drop"``: they land in column ``ctx``, a sink, with no
        host sync (what a CUDA graph needs)."""
        if targets is not None:
            raise ValueError("serve-mode forward takes no targets")
        if positions is None:
            raise ValueError("serve-mode forward needs positions [b, t] "
                             "(per-sequence absolute)")
        if self.cfg.moe_experts > 0:
            raise ValueError("serve mode does not support MoE blocks")
        if self.mesh is not None and (self.mesh.shape[MODEL] > 1
                                      or self.mesh.shape[SEQ] > 1
                                      or self.mesh.shape[PIPE] > 1):
            raise NotImplementedError(
                f"the serve forward on a model, seq or pipe axis (tensor-, "
                f"sequence- or pipeline-parallel serving) is not ported "
                f"({_LATER} item 11)")
        layer_kv = kv if callable(kv) else (lambda i: (kv[0][i], kv[1][i]))
        positions = positions.to(torch.int32)
        tables = rope_tables(positions, self.cfg.head_dim,
                             self.cfg.rope_theta)
        x = F.embedding(tokens.long(), self.embedding).to(self.cfg.dtype)
        keep = None
        ks: List[torch.Tensor] = []
        vs: List[torch.Tensor] = []
        for i, block in enumerate(self.layers):
            buf = layer_kv(i)
            if keep is None:
                # Once a forward (not a layer): where the rows land.
                keep = _keep_of(positions, buf[0].shape[1], ctx)
            x, (kr, vr) = block.serve(x, positions, tables, buf, keep)
            ks.append(kr)
            vs.append(vr)
        x = self.final_norm(x)
        logits = self.lm_head(x).float()
        return logits, (torch.stack(ks), torch.stack(vs))


def _check_mesh(cfg: TransformerConfig, mesh: Optional[Mesh]) -> None:
    """What a decoder on ``mesh`` cannot run yet raises."""
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a tony_tpu_torch.parallel.Mesh "
                        f"(MeshSpec(...).build()), got {type(mesh)}")
    pp = mesh.shape[PIPE]
    if pp > 1:
        for on, what in ((cfg.moe_experts > 0, "a MoE decoder"),
                         (bool(cfg.quant_lanes()), "the quant lanes"),
                         (bool(cfg.xent_chunk), "xent_chunk")):
            if on:
                raise NotImplementedError(
                    f"{what} on a pipeline axis is not ported yet ({_LATER} "
                    f"item 11)")
        if not cfg.scan_layers:
            raise ValueError("pipeline stages cut the stacked [L, ...] "
                             "layers: they need scan_layers=True")
        if cfg.n_layers % pp:
            raise ValueError(f"n_layers={cfg.n_layers} does not divide over "
                             f"pp={pp} stages")
    if mesh.shape[MODEL] == 1 and mesh.shape[SEQ] == 1:
        return
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            f"a MoE decoder on a model or seq axis (tp inside the MoE "
            f"block) is not ported yet ({_LATER} item 11)")
    if cfg.quant_lanes():
        raise NotImplementedError(
            f"the quant lanes on a model or seq axis are not ported yet "
            f"({_LATER} item 11)")
    if cfg.xent_chunk:
        raise NotImplementedError(
            f"xent_chunk on a model or seq axis is not ported yet "
            f"({_LATER} item 11)")
    tp = mesh.shape[MODEL]
    for what, n in (("n_heads", cfg.n_heads), ("ffn_hidden", cfg.ffn_hidden),
                    ("vocab", cfg.vocab)):
        if n % tp:
            raise ValueError(f"{what}={n} does not divide over tp={tp}")


def _block_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh a block's attention and MLP run over: none on a pipeline
    mesh, whose stages apply their blocks whole."""
    return None if mesh is None or mesh.shape[PIPE] > 1 else mesh


def _check_sharded(model: "Transformer", mesh: Mesh) -> None:
    if mesh.shape[MODEL] > 1 and \
            model.embedding.shape[0] == model.cfg.vocab:
        raise RuntimeError(
            "the decoder's parameters are whole on a tp mesh: "
            "create_train_state(model, tx, mesh=mesh) (or "
            "tony_tpu_torch.parallel.tensor.shard_model) cuts them")


def _build(defaults: dict, kw: dict) -> Transformer:
    device = kw.pop("device", None)
    seed = kw.pop("seed", 0)
    param_dtype = kw.pop("param_dtype", torch.float32)
    cfg = dict(defaults)
    cfg.update(kw)
    return Transformer(TransformerConfig(**cfg), device=device,
                       param_dtype=param_dtype).init_weights(seed)


@register("llama2-7b")
def llama2_7b(**kw) -> Transformer:
    """Full-width Llama-2-7B; ``device=`` (default: the card), ``seed=``
    (random weights) and ``param_dtype=`` (storage, default f32; a
    server passes ``cfg.dtype``) besides the config fields."""
    return _build({}, kw)


@register("llama-tiny")
def llama_tiny(**kw) -> Transformer:
    """Test-scale config: same code path as 7B at toy shapes."""
    return _build(dict(vocab=256, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, ffn_hidden=128, max_seq=64,
                       attention="reference", scan_layers=True,
                       remat=False), kw)


@register("mixtral-8x7b")
def mixtral_8x7b(**kw) -> Transformer:
    """Mixtral-style sparse MoE: 8 experts, top-2 routing, GQA (training
    only, as in the reference)."""
    return _build(dict(vocab=32000, dim=4096, n_layers=32, n_heads=32,
                       n_kv_heads=8, ffn_hidden=14336, max_seq=4096,
                       moe_experts=8, moe_top_k=2), kw)


@register("llama-moe-tiny")
def llama_moe_tiny(**kw) -> Transformer:
    """Test-scale MoE config: the mixtral code path at toy shapes."""
    return _build(dict(vocab=256, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, ffn_hidden=128, max_seq=64,
                       attention="reference", scan_layers=True,
                       remat=False, moe_experts=4, moe_top_k=2), kw)
