"""Llama-style decoder, serving path: the counterpart of
:mod:`tony_tpu.models.transformer`.

Only the ``kv=`` serving forward is ported: the t rows are NEW tokens at
per-sequence absolute ``positions`` ``[b, t]``, the context lives in a
per-layer KV buffer ``[b, ctx, n_kv_heads·head_dim]``, the rows'
post-rope k/v are written into that buffer before attention (so a row
attends itself and everything the cache holds below its position),
attention runs through :func:`tony_tpu_torch.ops.flash_decode`, and the
raw rows come back for the engine to commit into its paged pool.

The numerics follow the JAX module: projections in ``cfg.dtype`` with
the f32 parameters cast to it (here the parameters are stored in
``cfg.dtype``), RMSNorm in f32 with an f32 scale, interleaved-pair
rotary embeddings computed in f32 by bf16×f32 promotion, logits in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models import register
from tony_tpu_torch.ops import flash_decode

_LATER = "ROADMAP.md, queue 1"


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
    # The fields below shape the JAX package's training forward. The
    # serving forward ignores attention/scan_layers/remat/remat_policy
    # (a plain layer loop, no gradients); mesh, MoE, xent_chunk and
    # quant raise until their slices land.
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


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         seq_axis: int = 2) -> torch.Tensor:
    """Rotary embedding with positions [T] (shared across the batch) or
    [B, T] (per-sequence absolute positions); the sequence dim sits at
    ``seq_axis``. Interleaved pairs ``x[..., ::2]``/``x[..., 1::2]``,
    re-stacked on a new last axis (not the rotate-half convention)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    shape = [1] * x.ndim
    shape[-1] = d // 2
    if positions.ndim == 2:
        angles = positions[..., None].float() * freqs        # [B, T, D/2]
        shape[0] = angles.shape[0]
        shape[seq_axis] = angles.shape[1]
    else:
        angles = positions[:, None].float() * freqs[None, :]  # [T, D/2]
        shape[seq_axis] = angles.shape[0]
    cos = torch.cos(angles).reshape(shape)
    sin = torch.sin(angles).reshape(shape)
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


def _linear(cfg: TransformerConfig, n_in: int, n_out: int,
            device: torch.device) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, dtype=cfg.dtype, device=device)


# Per-layer KV buffers: (k_buf, v_buf), each [b, ctx, n_kv_heads·head_dim].
LayerKV = Tuple[torch.Tensor, torch.Tensor]


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        self.wq = _linear(cfg, cfg.dim, nh * hd, device)
        self.wk = _linear(cfg, cfg.dim, nkv * hd, device)
        self.wv = _linear(cfg, cfg.dim, nkv * hd, device)
        self.wo = _linear(cfg, nh * hd, cfg.dim, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv: LayerKV, keep: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, LayerKV]:
        cfg = self.cfg
        b, t, _ = x.shape
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        k_buf, v_buf = kv
        q4 = rope(self.wq(x).view(b, t, nh, hd), positions, cfg.rope_theta,
                  seq_axis=1)
        k4 = rope(self.wk(x).view(b, t, nkv, hd), positions,
                  cfg.rope_theta, seq_axis=1)
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
    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.w_gate = _linear(cfg, cfg.dim, cfg.ffn_hidden, device)
        self.w_up = _linear(cfg, cfg.dim, cfg.ffn_hidden, device)
        self.w_down = _linear(cfg, cfg.ffn_hidden, cfg.dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, positions, kv, keep):
        attn_out, new_kv = self.attn(self.attn_norm(x), positions, kv, keep)
        x = x + attn_out
        x = x + self.mlp(self.mlp_norm(x))
        return x, new_kv


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's ``lecun_normal``: truncated normal on [-2σ, 2σ] with
    variance 1/fan_in (σ corrected for the truncation), drawn in f32 and
    cast. ``w`` is torch's ``[out, in]``, so fan_in is ``w.shape[1]``."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    nn.init.trunc_normal_(tmp, std=std, a=-2 * std, b=2 * std,
                          generator=gen)
    w.copy_(tmp)


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        for field, slice_name in (("xent_chunk", "the training slice"),
                                  ("quant", "the quantized lane"),
                                  ("moe_experts", "the MoE slice"),
                                  ("mesh", "the sharded slices")):
            if getattr(cfg, field):
                raise NotImplementedError(
                    f"TransformerConfig.{field} is not ported yet; it lands "
                    f"with {slice_name} ({_LATER})")
        dev = resolve_device(device)
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty(
            cfg.vocab, cfg.dim, dtype=cfg.dtype, device=dev))
        self.layers = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, dev)
        self.lm_head = _linear(cfg, cfg.dim, cfg.vocab, dev)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Transformer":
        """The JAX package's init laws from a seeded ``torch.Generator``
        on the model's device: lecun-normal kernels, ``normal(0.02)``
        embedding, ones for the norms. (The same seed does not give the
        JAX package's numbers; tests carry weights across with
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
                _lecun_normal_(p, gen)
        return self

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor, targets=None, *,
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
        if kv is None:
            raise NotImplementedError(
                f"the training forward (kv=None) is not ported yet; it "
                f"lands with the training slice ({_LATER})")
        if targets is not None:
            raise ValueError("serve-mode forward takes no targets")
        if positions is None:
            raise ValueError("serve-mode forward needs positions [b, t] "
                             "(per-sequence absolute)")
        layer_kv = kv if callable(kv) else (lambda i: (kv[0][i], kv[1][i]))
        positions = positions.to(torch.int32)
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
            x, (kr, vr) = block(x, positions, buf, keep)
            ks.append(kr)
            vs.append(vr)
        x = self.final_norm(x)
        logits = self.lm_head(x).float()
        return logits, (torch.stack(ks), torch.stack(vs))


def _build(defaults: dict, kw: dict) -> Transformer:
    device = kw.pop("device", None)
    seed = kw.pop("seed", 0)
    cfg = dict(defaults)
    cfg.update(kw)
    return Transformer(TransformerConfig(**cfg), device=device
                       ).init_weights(seed)


@register("llama2-7b")
def llama2_7b(**kw) -> Transformer:
    """Full-width Llama-2-7B; ``device=`` (default: the card) and
    ``seed=`` (random weights) besides the config fields."""
    return _build({}, kw)


@register("llama-tiny")
def llama_tiny(**kw) -> Transformer:
    """Test-scale config: same code path as 7B at toy shapes."""
    return _build(dict(vocab=256, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, ffn_hidden=128, max_seq=64,
                       attention="reference", scan_layers=True,
                       remat=False), kw)
