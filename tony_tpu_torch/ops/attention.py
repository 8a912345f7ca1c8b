"""Attention: the counterpart of :mod:`tony_tpu.ops.attention`.

* :func:`reference_attention` — the plain spec over ``[B, H, T, D]``.
* :func:`flash_attention` (``[B, H, T, D]``) and
  :func:`flash_attention_packed` (``[B, T, H·D]``) — fused attention for
  training, forward and backward, through one ``torch.autograd.Function``
  (:class:`_FlashFn`). A CUDA tensor runs the hand-written Hopper kernels
  of ``csrc/flash_attention.cu`` (forward; backward dQ; backward dK/dV;
  bf16 on the tensor cores, f32 on the CUDA cores),
  a CPU tensor their plain versions :func:`_flash_fwd_plain`,
  :func:`_flash_bwd_dq_plain` and :func:`_flash_bwd_dkv_plain`, which
  follow the JAX kernels' math block by block with their rounding points.
  Both layouts are the same [B, H, T, D] views with other strides.
* :func:`flash_decode` — position-masked flash-decoding attention of a
  small q-block against a cached K/V buffer. A CUDA tensor runs the
  hand-written Hopper kernels of ``csrc/flash_decode.cu`` (bf16 on the
  tensor cores, the cache cut into 256-key chunks folded in order and
  split over blocks by :func:`_decode_plan`; f32 on the CUDA cores), or
  raises on a shape they do not take; a CPU tensor runs
  :func:`_decode_plain`, the counterpart of the JAX package's
  ``_decode_xla``, with the same ``[b, hkv, g·t, d]`` grouping and the
  same k-block order, all in f32. :func:`_decode_chunked_plain` models
  the bf16 kernel's fold for the tests and ``chip_smoke.py``.

Numerics: the kernels and the plain version compute the same function
with the same online-softmax recurrence (:func:`_decode_mask_update`)
but in another summation order, so they agree to a tolerance, not
bitwise. Each is row-independent on its own: a row's bits do not depend
on t, on its row tile, on the other rows of the call or, in bf16, on how
the launch splits the cache.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

_NEG_INF = -1e30

# Kernel launches by wrapper name, for every kernel of ``ops``: each
# wrapper adds one where it launches its kernel and nowhere else (a run
# resets the counts to 0 and reads them back to show that its path went
# through the kernels).
LAUNCHES: Dict[str, int] = {"flash_decode": 0, "flash_attention_fwd": 0,
                             "flash_attention_bwd_dq": 0,
                             "flash_attention_bwd_dkv": 0,
                             "fused_bucket_update": 0, "int8_matmul": 0,
                             "bn_stats": 0, "bn_apply": 0,
                             "bn_bwd_reduce": 0, "bn_bwd_dx": 0,
                             "bn_add_bwd_reduce": 0, "bn_add_bwd_dx": 0}


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

# The bf16 kernel's fold unit: the key axis is cut at multiples of this
# many positions (``CHUNK`` of csrc/flash_decode.cu, which refuses any
# other value).
_DECODE_CHUNK = 256


def _merge_state(m, l, acc, mc, lc, accc, take):
    """Fold a chunk's softmax state ``(mc, lc, accc)`` into the running
    ``(m, l, acc)`` where ``take`` (rows the chunk belongs to), else keep
    the running one. ``merge(fresh, x) == x`` exactly: exp(-1e30 - m) is
    0 and x·1 is x."""
    m_new = torch.maximum(m, mc)
    a = torch.exp(m - m_new)
    ac = torch.exp(mc - m_new)
    return (torch.where(take, m_new, m),
            torch.where(take, l * a + lc * ac, l),
            torch.where(take, acc * a + accc * ac, acc))


def _decode_chunked_plain(q, k, v, q_positions, scale, chunk, splits=1):
    """Plain model of the bf16 kernel's fold (tests and chip_smoke only):
    each ``chunk``-key chunk's softmax state is computed from a fresh
    state, and a row folds the states of the chunks that start at or
    below its position, left to right. With ``splits`` > 1 the chunks are
    cut into that many ranges as the kernel's launch would be: range 0
    folds its chunks itself, every other range hands each chunk's state
    over, and a combine step folds range 0's state and then those, in
    order. The result is the same bits at every ``splits``. A row with a
    negative position admits no key and gives 0."""
    b, h, t, d = q.shape
    hkv, ctx = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, hkv, g * t, d)
    kf, vf = k.float(), v.float()
    q_pos = q_positions.to(torch.int32)[:, None, None, :].expand(
        b, hkv, g, t).reshape(b, hkv, g * t, 1)
    n_chunks = -(-ctx // chunk)
    cps = -(-n_chunks // max(1, min(splits, n_chunks)))

    def fresh():
        return (torch.full((b, hkv, g * t, 1), _NEG_INF, device=q.device),
                torch.zeros((b, hkv, g * t, 1), device=q.device),
                torch.zeros((b, hkv, g * t, d), device=q.device))

    def chunk_state(c):
        lo, hi = c * chunk, min(ctx, (c + 1) * chunk)
        s = torch.matmul(qf, kf[:, :, lo:hi].transpose(-1, -2)) * scale
        k_pos = torch.arange(lo, hi, dtype=torch.int32, device=q.device)
        m0, l0, _ = fresh()
        p, _, m, l = _decode_mask_update(s, q_pos, k_pos, m0, l0)
        return m, l, torch.matmul(p, vf[:, :, lo:hi])

    def fold(state, chunks):
        for c in chunks:
            state = _merge_state(*state, *chunk_state(c),
                                 c * chunk <= q_pos)
        return state

    prefix = fold(fresh(), range(min(cps, n_chunks)))
    m, l, acc = fold(_merge_state(*fresh(), *prefix, q_pos >= 0),
                     range(cps, n_chunks))
    out = acc / torch.where(l > 0, l, torch.ones_like(l))
    return out.reshape(b, h, t, d).to(q.dtype)


class DecodePlan(NamedTuple):
    """How the bf16 kernel cuts one launch: ``rt`` m16 row tiles a
    block, the cache's ``n_chunks`` chunks in ``splits`` ranges of
    ``cps`` chunks, one block each, and the f32 workspace's shape (rows,
    chunk slots, d + 2) when ``splits`` > 1, else None."""
    rt: int
    splits: int
    cps: int
    workspace: Optional[Tuple[int, int, int]]


def _decode_plan(b, h, hkv, t, d, ctx, slots, splits=None):
    """The launch plan of the bf16 kernel. Its rows of one kv head (g·t)
    take one row-tile block when they fit one m16 tile, else blocks of 4
    tiles. ``slots(rt)`` is how many such blocks the card holds at once.
    The row blocks alone run unsplit when they fill half of that; fewer
    split the cache to fill two waves' worth, never into more ranges than
    it has chunks (``splits`` forces a count: tests and tuning). No
    choice here changes a bit of the output."""
    gt = (h // hkv) * t
    n_mt = -(-gt // 16)
    rt = 1 if n_mt == 1 else 4
    blocks = -(-n_mt // rt) * hkv * b
    n_chunks = -(-ctx // _DECODE_CHUNK)
    if splits is None:
        full = slots(rt)
        splits = 1 if 2 * blocks >= full else -(-2 * full // blocks)
    splits = max(1, min(splits, n_chunks, 65535 // b))
    cps = -(-n_chunks // splits)
    splits = -(-n_chunks // cps)
    ws = (b * hkv * gt, n_chunks, d + 2) if splits > 1 else None
    return DecodePlan(rt, splits, cps, ws)


@functools.lru_cache(maxsize=256)
def _decode_plan_on(index: int, b, h, hkv, t, d, ctx,
                    splits=None) -> DecodePlan:
    """The plan of a launch on card ``index`` (cached: the serving path
    launches a handful of shapes many times)."""
    return _decode_plan(b, h, hkv, t, d, ctx,
                        lambda rt: _decode_slots(index, d, rt), splits)


@functools.lru_cache(maxsize=None)
def _decode_slots(index: int, d: int, rt: int) -> int:
    """Blocks of the bf16 kernel (head_dim ``d``, ``rt`` row tiles) that
    card ``index`` holds at once: its SMs times the kernel's occupancy."""
    per_sm = _lib().flash_decode_blocks_per_sm(d, rt)
    if per_sm <= 0:
        raise RuntimeError(f"flash_decode occupancy query failed: cuda "
                           f"error {-per_sm}")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * per_sm


def _lib() -> ctypes.CDLL:
    from tony_tpu_torch.ops import _build

    lib = _build.load(["flash_decode"])["flash_decode"]
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_float]
                       + [ctypes.c_int] * 4 + [_STRIDES, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        lib.flash_decode_blocks_per_sm.argtypes = [ctypes.c_int] * 2
        lib.flash_decode_blocks_per_sm.restype = ctypes.c_int
    return lib


def _decode_cuda(q, k, v, q_positions, scale, splits=None):
    """Check what the kernel takes, allocate the output (and the split's
    workspace), launch on the current stream. bf16 runs the tensor-core
    ``flash_decode_mma_kernel`` (plus its combine kernel when the plan
    splits the cache; ``splits`` forces a split count), on q copied where
    its layout does not fit the kernel's 16-byte copies; f32 the CUDA-core
    ``flash_decode_kernel`` on q as given. Raises ``ValueError`` on a
    shape, type or layout the kernels do not take and ``RuntimeError``
    when a launch fails."""
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
    plan, ws = DecodePlan(1, 1, 1, None), None
    if q.dtype == torch.bfloat16:
        q = _for_mma(q, d)
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        plan = _decode_plan_on(index, b, h, hkv, t, d, ctx, splits)
        if plan.workspace is not None:
            ws = torch.empty(plan.workspace, dtype=torch.float32,
                             device=dev)
    strides = (ctypes.c_int64 * 18)(*q.stride(), *k.stride(), *v.stride(),
                                    *pos.stride(), *out.stride())
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.flash_decode_launch(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pos.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), b, h, hkv, t, d, ctx,
        float(scale), _DECODE_CHUNK, plan.rt, plan.splits, plan.cps,
        strides, stream)
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
    ``[b, ctx, hkv·d]`` buffer viewed as ``[b, hkv, ctx, d]``; the K/V
    buffer is never copied). A CUDA tensor runs the kernel (bf16 on the
    tensor cores, which streams 32-key tiles and folds 256-key chunks;
    f32 on the CUDA cores); a CPU tensor runs the plain version in
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


# --------------------------------------------------------------------
# Flash attention for training: forward and backward. The plain versions
# follow the JAX kernels (`_flash_kernel_resident`, `_flash_bwd_dq_kernel`,
# `_flash_bwd_dkv_kernel`) block by block with their rounding points:
# scores (q·kᵀ)·scale in f32, p rounded to V's (dO's) type before P·V
# (Pᵀ·dO), ds rounded to the input type before dS·K and dSᵀ·Q, and
# l_safe = where(l > 0, l, 1). They are not autograd of
# reference_attention. Query head h reads kv head h·hkv/h: the q side is
# grouped [b, hkv, reps·t, d], so no repeated K/V is ever made.
# --------------------------------------------------------------------

_PLAIN_BLOCK_K = 128


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 accumulation, or f64 for f64 inputs (gradcheck)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _grouped(x: torch.Tensor, hkv: int, f: torch.dtype) -> torch.Tensor:
    """[b, h, t, d] -> [b, hkv, reps·t, d] in the accumulation type."""
    b, h, t, d = x.shape
    return x.to(f).reshape(b, hkv, (h // hkv) * t, d)


def _row_positions(t: int, reps: int, device) -> torch.Tensor:
    return torch.arange(t, device=device).repeat(reps)[:, None]


def _scores(qg, k_blk, k0, q_pos, causal, scale):
    """Masked f32 scores of one key block (keys past tk are not in the
    block; the causal mask is aligned at the top left)."""
    s = torch.matmul(qg, k_blk.transpose(-1, -2)) * scale
    if causal:
        k_pos = torch.arange(k0, k0 + k_blk.shape[2], device=qg.device)
        s = torch.where(k_pos[None, :] <= q_pos, s, _NEG_INF)
    return s


def _flash_fwd_plain(q, k, v, causal, scale, block_k=_PLAIN_BLOCK_K):
    """Online-softmax forward over key blocks; returns (O in q's type,
    LSE [b, h, t] in the accumulation type)."""
    b, h, t, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    f = _acc_dtype(q)
    qg = _grouped(q, hkv, f)
    q_pos = _row_positions(t, h // hkv, q.device)
    rows = qg.shape[2]
    m = torch.full((b, hkv, rows, 1), _NEG_INF, dtype=f, device=q.device)
    l = torch.zeros((b, hkv, rows, 1), dtype=f, device=q.device)
    acc = torch.zeros((b, hkv, rows, d), dtype=f, device=q.device)
    k_end = min(tk, t) if causal else tk      # the diagonal's last key
    for k0 in range(0, k_end, block_k):
        k_blk = k[:, :, k0:k0 + block_k].to(f)
        v_blk = v[:, :, k0:k0 + block_k]
        s = _scores(qg, k_blk, k0, q_pos, causal, scale)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).to(f), v_blk.to(f))
        m = m_new
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    out = (acc / l_safe).reshape(b, h, t, d).to(q.dtype)
    return out, (m + torch.log(l_safe)).reshape(b, h, t)


def _flash_bwd_dq_plain(q, k, v, o, do, lse, causal, scale,
                        block_k=_PLAIN_BLOCK_K):
    """dQ over key blocks up to the diagonal; also returns
    D = rowsum(dO∘O) [b, h, t], which the dK/dV pass reads."""
    b, h, t, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    f = _acc_dtype(q)
    dsum = (do.to(f) * o.to(f)).sum(dim=-1)
    qg, dog = _grouped(q, hkv, f), _grouped(do, hkv, f)
    lse_g = lse.to(f).reshape(b, hkv, -1, 1)
    d_g = dsum.reshape(b, hkv, -1, 1)
    q_pos = _row_positions(t, h // hkv, q.device)
    dq = torch.zeros_like(qg)
    k_end = min(tk, t) if causal else tk
    for k0 in range(0, k_end, block_k):
        k_blk = k[:, :, k0:k0 + block_k].to(f)
        v_blk = v[:, :, k0:k0 + block_k].to(f)
        p = torch.exp(_scores(qg, k_blk, k0, q_pos, causal, scale) - lse_g)
        dp = torch.matmul(dog, v_blk.transpose(-1, -2))
        ds = (p * (dp - d_g)).to(k.dtype).to(f)
        dq = dq + torch.matmul(ds, k_blk) * scale
    return dq.reshape(b, h, t, d).to(q.dtype), dsum


def _flash_bwd_dkv_plain(q, k, v, do, lse, dsum, causal, scale,
                         block_k=_PLAIN_BLOCK_K):
    """dK and dV per key block, summed over every query row of the query
    heads of each kv head (keys no row admits get zeros)."""
    b, h, t, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    f = _acc_dtype(q)
    qg, dog = _grouped(q, hkv, f), _grouped(do, hkv, f)
    lse_g = lse.to(f).reshape(b, hkv, -1, 1)
    d_g = dsum.to(f).reshape(b, hkv, -1, 1)
    q_pos = _row_positions(t, h // hkv, q.device)
    dk = torch.zeros(k.shape, dtype=f, device=k.device)
    dv = torch.zeros(v.shape, dtype=f, device=v.device)
    k_end = min(tk, t) if causal else tk
    for k0 in range(0, k_end, block_k):
        k_blk = k[:, :, k0:k0 + block_k].to(f)
        v_blk = v[:, :, k0:k0 + block_k].to(f)
        p = torch.exp(_scores(qg, k_blk, k0, q_pos, causal, scale) - lse_g)
        dv[:, :, k0:k0 + block_k] = torch.matmul(
            p.to(do.dtype).to(f).transpose(-1, -2), dog)
        dp = torch.matmul(dog, v_blk.transpose(-1, -2))
        ds = (p * (dp - d_g)).to(q.dtype).to(f)
        dk[:, :, k0:k0 + block_k] = torch.matmul(
            ds.transpose(-1, -2), qg) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


_FLASH_FNS = ("flash_attention_fwd_launch", "flash_attention_bwd_dq_launch",
              "flash_attention_bwd_dkv_launch")
_STRIDES = ctypes.POINTER(ctypes.c_int64)


def _attn_lib() -> ctypes.CDLL:
    from tony_tpu_torch.ops import _build

    lib = _build.load(["flash_attention"])["flash_attention"]
    if lib.flash_attention_fwd_launch.argtypes is None:
        tail = [ctypes.c_int] * 7 + [ctypes.c_float, _STRIDES,
                                     ctypes.c_void_p]
        lib.flash_attention_fwd_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + tail)
        for name in _FLASH_FNS[1:]:
            getattr(lib, name).argtypes = (
                [ctypes.c_int] + [ctypes.c_void_p] * 8 + tail)
        for name in _FLASH_FNS:
            getattr(lib, name).restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_flash_cuda(q, k, v, *more):
    """What the kernels take: one device, float32 or bfloat16 throughout,
    head_dim up to 128, b and h within the grid. Any strides."""
    d = q.shape[-1]
    for x in (k, v) + more:
        if x.device != q.device:
            raise ValueError(f"flash_attention: tensors on {x.device} and "
                             f"{q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"flash_attention kernel takes one dtype, got "
                             f"{q.dtype} and {x.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if d > 128:
        raise ValueError(f"flash_attention kernel takes head_dim up to 128, "
                         f"got {d}")
    if q.shape[0] > 65535 or q.shape[1] > 65535:
        raise ValueError(f"flash_attention kernel grid takes b and h up to "
                         f"65535, got {q.shape[0]}/{q.shape[1]}")


def _vec_ok(x: torch.Tensor) -> bool:
    """Whether the bf16 kernels (the forward and the backward pair) can
    take ``x`` (a [B, H, T, D] view) as it is: their 16-byte ``cp.async``
    copies and stores need feature stride 1, the stride of every other
    dimension longer than 1 a multiple of 8 elements (16 bytes of bf16), a
    16-byte aligned base, and D % 8 == 0. The packed [B, T, H·D] views and
    contiguous [B, H, T, D] qualify. The launchers in
    ``csrc/flash_attention.cu`` (``rows16``) refuse a layout that breaks
    the rule."""
    return (x.shape[-1] % 8 == 0 and x.stride(-1) == 1
            and x.data_ptr() % 16 == 0
            and all(n == 1 or s % 8 == 0
                    for n, s in zip(x.shape[:-1], x.stride()[:-1])))


def _for_mma(x: torch.Tensor, d8: int) -> torch.Tensor:
    """``x`` as the bf16 kernels take it: zero-padded to ``d8`` features
    (a multiple of 8; the zeros add nothing to any product), or copied to
    a fresh contiguous tensor where :func:`_vec_ok` fails (a transposed q
    or an unaligned view; a zero-stride or transposed dO from autograd),
    else ``x`` itself."""
    if x.shape[-1] != d8:
        return torch.nn.functional.pad(x, (0, d8 - x.shape[-1]))
    return x if _vec_ok(x) else x.clone(memory_format=torch.contiguous_format)


def _launch(lib, fn_name, counter, args, dims, tensors):
    strides = (ctypes.c_int64 * (4 * len(tensors)))(
        *[s for x in tensors for s in x.stride()])
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = getattr(lib, fn_name)(*args, *dims, strides, stream)
    if rc != 0:
        raise RuntimeError(
            f"{counter} kernel launch failed: cuda error {rc} "
            f"({lib.flash_attention_error_string(rc).decode()})")
    LAUNCHES[counter] += 1


def _dims(q, k, causal, scale):
    b, h, t, d = q.shape
    return (b, h, k.shape[1], t, k.shape[2], d, int(causal), float(scale))


def _flash_fwd_cuda(q, k, v, causal, scale):
    """The forward kernel: O in q's layout and LSE, contiguous f32
    [B, H, T]. bf16 runs the tensor-core kernel (``flash_fwd_mma_kernel``)
    on operands made fit by :func:`_for_mma`, f32 the CUDA-core one on the
    operands as given."""
    _check_flash_cuda(q, k, v)
    b, h, t, d = q.shape
    # O keeps q's memory layout: for the packed [b, t, h·d] views the
    # caller's reshape back is then free. Where that layout (or d) does
    # not fit the bf16 kernel, it writes a fitting buffer that is copied
    # over.
    out = run = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if q.numel() == 0 or k.numel() == 0:
        return out.zero_(), lse.zero_()
    if q.dtype == torch.bfloat16:
        d8 = -(-d // 8) * 8
        q, k, v = (_for_mma(x, d8) for x in (q, k, v))
        if not _vec_ok(out):
            run = torch.empty_like(q)
    _launch(_attn_lib(), "flash_attention_fwd_launch", "flash_attention_fwd",
            (_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             run.data_ptr(), lse.data_ptr()), _dims(q, k, causal, scale),
            (q, k, v, run))
    if run is not out:
        out.copy_(run[..., :d])
    return out, lse


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale):
    """dQ kernel (which also writes D = rowsum(dO∘O)), then the dK/dV
    kernel that reads D. dO is taken with whatever strides autograd gives
    it. bf16 runs the tensor-core kernels (``flash_bwd_dq_mma_kernel``,
    ``flash_bwd_dkv_mma_kernel``) on operands made fit by
    :func:`_for_mma`, f32 the CUDA-core ones on the operands as given."""
    _check_flash_cuda(q, k, v, o, do)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention backward needs the forward's "
                         "contiguous float32 LSE")
    if q.numel() == 0 or k.numel() == 0:
        return tuple(torch.zeros_like(x) for x in (q, k, v))
    b, h, t, d = q.shape
    # The grads keep q's, k's and v's layouts. Where one does not fit the
    # bf16 kernels, they write a fitting buffer that is copied over.
    outs = runs = [torch.empty_like(x) for x in (q, k, v)]
    if q.dtype == torch.bfloat16:
        d8 = -(-d // 8) * 8
        q, k, v, o, do = (_for_mma(x, d8) for x in (q, k, v, o, do))
        runs = [y if _vec_ok(y) else torch.empty_like(x)
                for y, x in zip(outs, (q, k, v))]
    dq, dk, dv = runs
    dsum = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _attn_lib()
    code = _DTYPE_CODES[q.dtype]
    dims = _dims(q, k, causal, scale)
    _launch(lib, "flash_attention_bwd_dq_launch", "flash_attention_bwd_dq",
            (code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dsum.data_ptr()),
            dims, (q, k, v, o, do, dq))
    _launch(lib, "flash_attention_bwd_dkv_launch", "flash_attention_bwd_dkv",
            (code, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            dims, (q, k, v, do, dk, dv))
    for y, run in zip(outs, runs):
        if run is not y:
            y.copy_(run[..., :d])
    return tuple(outs)


def _on(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{x.device}")
    return x.device.type


def _flash_fwd(q, k, v, causal, scale):
    if _on(q) == "cuda":
        return _flash_fwd_cuda(q, k, v, causal, scale)
    return _flash_fwd_plain(q, k, v, causal, scale)


def _flash_bwd(q, k, v, o, lse, do, causal, scale):
    if _on(q) == "cuda":
        return _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale)
    dq, dsum = _flash_bwd_dq_plain(q, k, v, o, do, lse, causal, scale)
    dk, dv = _flash_bwd_dkv_plain(q, k, v, do, lse, dsum, causal, scale)
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """The counterpart of the JAX package's ``_flash``/``_flash_packed``
    custom VJPs, over [B, H, T, D] views of any strides: the forward
    saves q, k, v, O and the per-row LSE [B, H, T]; the backward returns
    dq, dk, dv in the caller's layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = _flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, do, ctx.causal,
                                ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention over ``[batch, heads, seq, head_dim]``, with its
    backward. K/V may carry fewer heads (GQA, zero-copy: query head h
    reads kv head h·hkv/h) and another length (``tk``; the causal mask is
    aligned at the top left). Ragged lengths need no padding: the kernels
    mask keys at or past ``tk`` and never write rows at or past ``t``."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention wants [b, h, t, d] q/k/v, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"query heads {q.shape[1]} not a multiple of kv "
                         f"heads {k.shape[1]}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"match")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head_dim")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _FlashFn.apply(q, k, v, bool(causal), float(scale))


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention over the packed ``[batch, seq, heads·head_dim]``
    layout, the projections' natural shape. The heads are read as strided
    [B, H, T, D] views, so no transpose is copied; K/V may be packed
    ``[B, Tk, Hkv·D]`` with ``heads % Hkv == 0``."""
    b, t, hd = q.shape
    if hd % heads:
        raise ValueError(f"packed dim {hd} is not divisible by "
                         f"heads={heads}")
    d = hd // heads
    if k.shape[2] % d or heads % (k.shape[2] // d):
        raise ValueError(f"packed kv dim {k.shape[2]} is not a "
                         f"head-multiple of head_dim {d} dividing "
                         f"heads={heads}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"match")

    def heads_view(x: torch.Tensor) -> torch.Tensor:
        return x.unflatten(2, (x.shape[2] // d, d)).transpose(1, 2)

    out = flash_attention(heads_view(q), heads_view(k), heads_view(v),
                          causal=causal, scale=scale)
    return out.transpose(1, 2).reshape(b, t, hd)
