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
  builds the ``[b, t, vocab]`` logits.
* serving (``kv=``): the t rows are NEW tokens at per-sequence absolute
  ``positions`` ``[b, t]``, the context lives in a per-layer KV buffer
  ``[b, ctx, n_kv_heads·head_dim]``, the rows' post-rope k/v are written
  into that buffer before attention (so a row attends itself and
  everything the cache holds below its position), attention runs through
  :func:`tony_tpu_torch.ops.flash_decode`, and the raw rows come back for
  the engine to commit into its paged pool. Runs under inference mode.

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

import dataclasses
import functools
from typing import Any, Callable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models import lecun_normal_, register
from tony_tpu_torch.models.convert import params_from_jax, params_to_jax
from tony_tpu_torch.ops import (flash_attention, flash_attention_packed,
                                flash_decode, reference_attention)
from tony_tpu_torch.ops.quant import QuantDense
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
    # the JAX param layout (convert.py reads both). attention="ring", a
    # mesh and MoE raise until their slices land.
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
                        self.weight.to(self.compute_dtype))


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


# Per-layer KV buffers: (k_buf, v_buf), each [b, ctx, n_kv_heads·head_dim].
LayerKV = Tuple[torch.Tensor, torch.Tensor]


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

    def forward(self, x: torch.Tensor, tables: RopeTables) -> torch.Tensor:
        """Training forward: causal self-attention over the t rows, routed
        as the JAX module routes it (transformer.py:237-287)."""
        cfg = self.cfg
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

    def serve(self, x: torch.Tensor, positions: torch.Tensor,
              tables: RopeTables, kv: LayerKV,
              keep: Tuple[torch.Tensor, torch.Tensor]
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
        # private scratch). ``keep`` lists the (batch, row) pairs whose
        # position lies inside the buffer: rows past its end (padding
        # rows near ctx_max) write nothing, like the JAX package's
        # mode="drop" — an out-of-range CUDA index would be a device
        # assert, not a no-op. Dummy batch slots write every row to
        # position 0 (duplicate indices, an unspecified winner): harmless
        # only because their buffer rows and outputs are private and
        # discarded.
        bsel, tsel = keep
        psel = positions[bsel, tsel].long()
        k_buf[bsel, psel] = k_rows[bsel, tsel]
        v_buf[bsel, psel] = v_rows[bsel, tsel]
        ctx = k_buf.shape[1]
        # [b, ctx, nkv·hd] -> [b, nkv, ctx, hd] views: no copy; the
        # kernel takes the strides.
        out = flash_decode(
            q4.transpose(1, 2),
            k_buf.view(b, ctx, nkv, hd).transpose(1, 2),
            v_buf.view(b, ctx, nkv, hd).transpose(1, 2),
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device,
                 param_dtype: torch.dtype):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.attn = Attention(cfg, device, param_dtype)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.mlp = MLP(cfg, device, param_dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), (cos, sin))
        return x + self.mlp(self.mlp_norm(x))

    def serve(self, x, positions, tables, kv, keep):
        attn_out, new_kv = self.attn.serve(self.attn_norm(x), positions,
                                           tables, kv, keep)
        x = x + attn_out
        x = x + self.mlp(self.mlp_norm(x))
        return x, new_kv


class Transformer(nn.Module):
    # The JAX decoder tree's converter, read by ``load_jax_params``, and
    # its inverse, read by ``jax_param_tree`` (checkpoints).
    params_from_jax = staticmethod(params_from_jax)
    params_to_jax = staticmethod(params_to_jax)

    def __init__(self, cfg: TransformerConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg.quant_lanes()       # validates the lanes, as the JAX module
        for field, slice_name in (("moe_experts", "the MoE slice"),
                                  ("mesh", "the sharded slices")):
            if getattr(cfg, field):
                raise NotImplementedError(
                    f"TransformerConfig.{field} is not ported yet; it lands "
                    f"with {slice_name} ({_LATER})")
        if cfg.attention == "ring":
            raise NotImplementedError(
                f"attention='ring' is not ported yet; it lands with the "
                f"sharded slices ({_LATER})")
        if cfg.attention not in ("flash", "reference"):
            raise ValueError(f"unknown attention {cfg.attention!r}")
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
        return self

    def forward(self, tokens: torch.Tensor, targets=None, *,
                positions: Optional[torch.Tensor] = None,
                kv: Union[Tuple[torch.Tensor, torch.Tensor],
                          Callable[[int], LayerKV], None] = None):
        """``kv=None``: the training forward, ``tokens`` [b, t] at
        ``positions`` (default ``arange(t)``, shared over the batch);
        returns f32 logits [b, t, vocab] with autograd, or, with
        ``xent_chunk`` and ``targets`` (the tokens [b, t]), the scalar
        chunked next-token loss. With ``kv``: the serving forward
        (:meth:`serve`)."""
        if kv is not None:
            return self.serve(tokens, targets, positions=positions, kv=kv)
        cfg = self.cfg
        if targets is not None and not cfg.xent_chunk:
            raise ValueError("targets are only taken with xent_chunk (the "
                             "fused LM-head loss)")
        t = tokens.shape[1]
        if positions is None:
            positions = torch.arange(t, device=tokens.device)
        cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        x = F.embedding(tokens.long(), self.embedding).to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        policy = {}
        if cfg.remat_policy is not None:
            policy["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts,
                list(REMAT_SAVED[cfg.remat_policy]))
        for block in self.layers:
            if remat:
                x = checkpoint(block, x, cos, sin, use_reentrant=False,
                               **policy)
            else:
                x = block(x, cos, sin)
        x = self.final_norm(x)
        if targets is not None:
            return chunked_next_token_xent(x, self.lm_head.weight, targets,
                                           cfg.xent_chunk, cfg.dtype)
        return self.lm_head(x).float()

    @torch.inference_mode()
    def serve(self, tokens: torch.Tensor, targets=None, *,
              positions: Optional[torch.Tensor] = None,
              kv: Union[Tuple[torch.Tensor, torch.Tensor],
                        Callable[[int], LayerKV], None] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Serve-mode forward: ``tokens`` [b, t] new rows at
        ``positions`` [b, t]; ``kv`` is either the stacked buffers
        ``(k, v)`` of shape [n_layers, b, ctx, kv_dim] (as in the JAX
        package) or a callable ``layer -> (k_buf, v_buf)`` that gathers
        layer i's buffers just before layer i runs. The buffers are
        written in place (they are scratch for this forward). Returns
        ``(logits f32 [b, t, vocab], (k_rows, v_rows))`` with the fresh
        rows stacked [n_layers, b, t, kv_dim]."""
        if targets is not None:
            raise ValueError("serve-mode forward takes no targets")
        if positions is None:
            raise ValueError("serve-mode forward needs positions [b, t] "
                             "(per-sequence absolute)")
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
                # One host sync per forward (not per layer): which rows
                # land inside the ctx-long buffer.
                keep = (positions < buf[0].shape[1]).nonzero(as_tuple=True)
            x, (kr, vr) = block.serve(x, positions, tables, buf, keep)
            ks.append(kr)
            vs.append(vr)
        x = self.final_norm(x)
        logits = self.lm_head(x).float()
        return logits, (torch.stack(ks), torch.stack(vs))


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
