"""Attention for the serving path: the counterpart of the serving part of
:mod:`tony_tpu.ops.attention`.

* :func:`reference_attention` — the plain spec over ``[B, H, T, D]``.
* :func:`flash_decode` — position-masked flash-decoding attention of a
  small q-block against a cached K/V buffer. A CUDA tensor runs the
  hand-written Hopper kernel ``csrc/flash_decode.cu`` (or raises on a
  shape it does not take); a CPU tensor runs :func:`_decode_plain`, the
  counterpart of the JAX package's ``_decode_xla``, with the same
  ``[b, hkv, g·t, d]`` grouping and the same k-block order, all in f32.

Numerics: the kernel and the plain version compute the same function
with the same online-softmax recurrence (:func:`_decode_mask_update`)
but in another summation order, so they agree to a tolerance, not
bitwise. Each is row-independent on its own: a row's bits do not depend
on t, on its row tile, or on the other rows of the call.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

_NEG_INF = -1e30

# Kernel launches by wrapper name: each wrapper adds one where it
# launches its kernel and nowhere else (a run resets the counts to 0 and
# reads them back to show that its path went through the kernels).
LAUNCHES: Dict[str, int] = {"flash_decode": 0}


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention over [B, H, T, D], f32 softmax accumulation.
    K/V may carry fewer heads (GQA); they are repeated up to H here —
    this is the semantic spec the kernels are tested against."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    if k.shape[1] != q.shape[1]:
        reps = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(reps, dim=1)
        v = v.repeat_interleave(reps, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        t_q, t_k = q.shape[2], k.shape[2]
        mask = (torch.arange(t_q, device=q.device)[:, None]
                >= torch.arange(t_k, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _fit_block(limit: int, t: int) -> int:
    """Largest block ≤ limit that divides ``t`` and is a multiple of 16;
    0 if none exists (ragged ``t``)."""
    b = min(limit, t)
    b -= b % 16
    while b >= 16 and t % b:
        b -= 16
    return b if b >= 16 else 0


def _decode_mask_update(s, q_pos, k_pos, m, l):
    """One online-softmax block step: mask scores by absolute position
    (``k_pos <= q_pos`` — causal over the cache, which also hides
    unwritten buffer tail positions), then fold the block into the
    running (m, l) state. All f32; broadcasting carries the leading
    batch dims."""
    s = torch.where(k_pos <= q_pos, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    return p, alpha, m_new, l_new


def _decode_plain(q, k, v, q_positions, scale, block_k):
    """Plain flash-decode: a loop over k-blocks of the cache, grouped
    [b, hkv, g·t, d] so GQA query heads batch onto their kv head exactly
    like the kernel's head map."""
    b, h, t, d = q.shape
    hkv, ctx = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, hkv, g * t, d)
    kf = k.float()
    vf = v.float()
    # [b, hkv, g·t, 1] absolute position per row (the g query heads of
    # one kv head share their rows' positions).
    q_pos = q_positions.to(torch.int32)[:, None, None, :].expand(
        b, hkv, g, t).reshape(b, hkv, g * t, 1)
    m = torch.full((b, hkv, g * t, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g * t, 1), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((b, hkv, g * t, d), dtype=torch.float32,
                      device=q.device)
    for kb in range(ctx // block_k):
        k_blk = kf[:, :, kb * block_k:(kb + 1) * block_k]
        v_blk = vf[:, :, kb * block_k:(kb + 1) * block_k]
        s = torch.matmul(qf, k_blk.transpose(-1, -2)) * scale
        k_pos = kb * block_k + torch.arange(block_k, dtype=torch.int32,
                                            device=q.device)
        p, alpha, m, l = _decode_mask_update(s, q_pos, k_pos, m, l)
        acc = acc * alpha + torch.matmul(p, v_blk)
    out = acc / torch.where(l > 0, l, torch.ones_like(l))
    return out.reshape(b, h, t, d).to(q.dtype)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_I64 = ctypes.c_int64


def _lib() -> ctypes.CDLL:
    from tony_tpu_torch.ops import _build

    lib = _build.load(["flash_decode"])["flash_decode"]
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 6 + [ctypes.c_float]
                       + [_I64] * 18 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def _decode_cuda(q, k, v, q_positions, scale):
    """Check what the kernel takes, allocate the output, launch on the
    current stream. Raises ``ValueError`` on a shape, type or layout the
    kernel does not take and ``RuntimeError`` when the launch fails."""
    b, h, t, d = q.shape
    hkv, ctx = k.shape[1], k.shape[2]
    dev = q.device
    for name, x in (("k", k), ("v", v), ("q_positions", q_positions)):
        if x.device != dev:
            raise ValueError(f"flash_decode: {name} on {x.device}, q on "
                             f"{dev}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_decode kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if b > 65535 or hkv > 65535:
        raise ValueError(f"flash_decode kernel grid takes b and hkv up to "
                         f"65535, got {b}/{hkv}")
    if d % 8 or d > 256:
        raise ValueError(f"flash_decode kernel takes head_dim a multiple "
                         f"of 8 up to 256, got {d}")
    vec = 16 // q.element_size()
    for name, x in (("k", k), ("v", v)):
        if x.stride(3) != 1 or any(s % vec for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"flash_decode kernel needs {name} rows contiguous and "
                f"16-byte aligned (strides {x.stride()})")
    pos = q_positions
    if pos.dtype != torch.int32:
        pos = pos.to(torch.int32)
    # Output allocated [b, t, h, d] and returned as the [b, h, t, d]
    # view: the caller's transpose back to [b, t, h·d] is then free.
    out = torch.empty((b, t, h, d), dtype=q.dtype,
                      device=dev).permute(0, 2, 1, 3)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.flash_decode_launch(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, h, hkv, t, d, ctx, float(scale),
        *q.stride(), *k.stride(), *v.stride(), *pos.stride(), *out.stride(),
        stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_decode kernel launch failed: cuda error {rc} "
            f"({lib.flash_decode_error_string(rc).decode()})")
    LAUNCHES["flash_decode"] += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_positions: torch.Tensor, *, scale: Optional[float] = None,
                 block_k: int = 128) -> torch.Tensor:
    """Flash-decoding attention for the serving path: a small q-block
    ``[b, h, t, d]`` against a cached K/V buffer ``[b, hkv, ctx, d]``,
    masked by each row's ABSOLUTE position (``q_positions`` int32
    ``[b, t]``: key j participates in row i iff ``j <= q_positions[i]``
    — causal over the cache, and unwritten buffer tail positions are
    excluded because they sit above every live row's position).

    q, k and v may be strided views (the serving forward passes the
    ``[b, ctx, hkv·d]`` buffer viewed as ``[b, hkv, ctx, d]``; nothing
    is copied for the kernel). A CUDA tensor runs the kernel, which
    streams 32-key tiles; a CPU tensor runs the plain version in
    ``block_k``-key blocks. GQA is zero-copy (query head h reads kv
    head ``h·hkv/h``). Forward only.
    """
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"flash_decode wants [b, h, t, d] q and "
                         f"[b, hkv, ctx, d] k/v, got {tuple(q.shape)}/"
                         f"{tuple(k.shape)}")
    b, h, t, d = q.shape
    hkv, ctx = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"query heads {h} not a multiple of kv heads "
                         f"{hkv}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"match")
    if tuple(q_positions.shape) != (b, t):
        raise ValueError(f"q_positions must be [b, t]={b, t}, got "
                         f"{tuple(q_positions.shape)}")
    scale = d ** -0.5 if scale is None else scale
    if q.device.type == "cuda":
        return _decode_cuda(q, k, v, q_positions, scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_decode runs on cuda or cpu tensors, got "
                         f"{q.device}")
    return _decode_plain(q, k, v, q_positions, scale,
                         _fit_block(block_k, ctx) or ctx)
