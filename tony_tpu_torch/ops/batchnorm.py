"""Fused train-mode BatchNorm(+residual add)(+ReLU): the counterpart of
:mod:`tony_tpu.ops.batchnorm`.

Everything works on the ``[M, C]`` view of a channels-last activation
(``M = N·H·W`` rows, channels contiguous): the view of an NHWC tensor, or
of an NCHW tensor in ``torch.channels_last`` layout after
``permute(0, 2, 3, 1)``, costs no copy.

* Plain versions, one per kernel, following the JAX kernels' expressions
  (all in f32): :func:`_stats_plain` (``[Σx, Σx²]``), :func:`_apply_plain`
  (``relu?(x̂·γ + β [+ res])``, ``x̂ = (x − mean)·rsqrt(var + eps)``),
  :func:`_bwd_reduce_plain` (``[dβ, dγ] = [Σg, Σg·x̂]`` with ``g`` the
  cotangent masked by the recomputed ReLU) and :func:`_bwd_dx_plain`
  (``dx = γ·inv·(g − dβ·minv − x̂·dγ·minv)``, plus ``dres = g``).
* :func:`bn_act_2d` / :func:`bn_add_act_2d` — one
  ``torch.autograd.Function`` over the ``[M, C]`` view returning
  ``(out, mean, var)``; the batch statistics are outputs without a
  gradient (the batch-statistic chain rule is inside the dx formula, as
  in the JAX VJP).
* :func:`fused_bn_act` — the ``[..., C]`` entry. On a CUDA tensor it
  always runs the kernels, which mask a ragged M and any C. On a CPU
  tensor it follows the port's copy of :func:`pick_block_rows`, the JAX
  package's Pallas tiling rule: where that rule finds no tiling it
  returns ``None`` and the caller falls back to plain math, so the CPU
  port takes the reference's path for every shape.

A CUDA tensor runs the hand-written Hopper kernels of
``csrc/batchnorm.cu`` (or raises); a CPU tensor runs the plain versions.
``LAUNCHES`` counts kernel launches by wrapper name.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tony_tpu_torch.ops.attention import LAUNCHES, _DTYPE_CODES

# The JAX package's VMEM budget (tony_tpu/ops/batchnorm.py:34): kept so
# that :func:`pick_block_rows` takes the reference's path on the CPU.
_VMEM_BUDGET = 8 << 20


def pick_block_rows(m: int, c: int, itemsize: int = 2, n_bufs: int = 3,
                    n_temps: int = 8) -> Optional[int]:
    """The JAX package's row-block rule (``pick_block_rows``), copied:
    the largest power-of-two row block that divides ``m`` and keeps
    ``n_bufs`` double-buffered ``[bm, C]`` blocks plus ``n_temps`` f32
    temporaries within the TPU's VMEM budget; ``None`` = no clean tiling.
    The port uses it only on CPU tensors, to take the reference's path
    (plain versions or the caller's fallback); the CUDA kernels need no
    tiling rule."""
    per_row = 2 * n_bufs * c * itemsize + n_temps * c * 4
    limit = _VMEM_BUDGET // per_row
    for bm in (8192, 4096, 2048, 1024, 512, 256, 128, 64, 32, 16):
        if bm <= limit and m % bm == 0:
            return bm
    return None


# ---------------------------------------------------------------------
# Plain versions (the CPU path, and what the card's kernels are held to).
# ---------------------------------------------------------------------

def _stats_plain(x2d: torch.Tensor) -> torch.Tensor:
    """``[2, C]`` f32: per-channel Σx and Σx² (``_stats_kernel``)."""
    xf = x2d.float()
    return torch.stack([xf.sum(0), (xf * xf).sum(0)])


def _pre_act(x2d, mean, var, gamma, beta, eps):
    """``(pre, x̂, inv)`` in f32 (``_pre_act``): x̂ = (x − mean)·inv,
    inv = rsqrt(var + eps), pre = x̂·γ + β; each op rounded on its own."""
    inv = torch.rsqrt(var + eps)
    xhat = (x2d.float() - mean) * inv
    return xhat * gamma + beta, xhat, inv


def _masked_grad(dy, pre, res2d, relu):
    """The cotangent under the recomputed ReLU mask: ``g = dy`` where
    ``pre (+ res) > 0``, else 0 (the residual counts only under ReLU)."""
    g = dy.float()
    if relu:
        if res2d is not None:
            pre = pre + res2d.float()
        g = torch.where(pre > 0, g, 0.0)
    return g


def _apply_plain(x2d, mean, var, gamma, beta, res2d, eps: float,
                 relu: bool) -> torch.Tensor:
    """``relu?(x̂·γ + β [+ res])`` in f32, out in x's dtype
    (``_apply_kernel`` / ``_apply_res_kernel``)."""
    pre, _, _ = _pre_act(x2d, mean, var, gamma, beta, eps)
    if res2d is not None:
        pre = pre + res2d.float()
    if relu:
        pre = torch.clamp_min(pre, 0.0)
    return pre.to(x2d.dtype)


def _bwd_reduce_plain(dy, x2d, mean, var, gamma, beta, res2d, eps: float,
                      relu: bool) -> torch.Tensor:
    """``[2, C]`` f32 ``[dβ, dγ] = [Σg, Σg·x̂]`` (``_bwd_reduce_kernel`` /
    ``_bwd_reduce_res_kernel``)."""
    pre, xhat, _ = _pre_act(x2d, mean, var, gamma, beta, eps)
    g = _masked_grad(dy, pre, res2d, relu)
    return torch.stack([g.sum(0), (g * xhat).sum(0)])


def _bwd_dx_plain(dy, x2d, mean, var, gamma, beta, red, res2d, eps: float,
                  relu: bool, minv: float
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(dx, dres)``: dx = (γ·inv)·(g − dβ·minv − x̂·dγ·minv) in x's
    dtype, dres = g in the residual's (None without one)
    (``_bwd_dx_kernel`` / ``_bwd_dx_res_kernel``). ``minv`` is ``1/M``:
    a multiply, not a division by M."""
    pre, xhat, inv = _pre_act(x2d, mean, var, gamma, beta, eps)
    g = _masked_grad(dy, pre, res2d, relu)
    scale = gamma * inv
    dx = (scale * (g - red[0] * minv - xhat * red[1] * minv)).to(x2d.dtype)
    return dx, (None if res2d is None else g.to(res2d.dtype))


# ---------------------------------------------------------------------
# The CUDA kernels (csrc/batchnorm.cu).
# ---------------------------------------------------------------------

_THREADS = 256
_BLOCKS_PER_SM = 8          # 8 x 256 threads: one full wave of the card
_MODE = {"stats": 0, "bwd": 1, "bwd_res": 2}
_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    from tony_tpu_torch.ops import _build

    lib = _build.load(["batchnorm"])["batchnorm"]
    if lib.bn_reduce_launch.argtypes is None:
        i, f, i64 = ctypes.c_int, ctypes.c_float, ctypes.c_int64
        geo = [i64, i, i, i, i, i64]       # m, c, tx, ctiles, blocks, rows
        lib.bn_reduce_launch.argtypes = ([i] * 4 + [_P] * 7 + [f] + geo
                                         + [_P] * 3)
        lib.bn_apply_launch.argtypes = [i] * 4 + [_P] * 6 + [f] + geo \
            + [_P] * 2
        lib.bn_dx_launch.argtypes = [i] * 4 + [_P] * 8 + [f, f] + geo \
            + [_P] * 3
        for fn in (lib.bn_reduce_launch, lib.bn_apply_launch,
                   lib.bn_dx_launch):
            fn.restype = ctypes.c_int
        lib.bn_error_string.argtypes = [ctypes.c_int]
        lib.bn_error_string.restype = ctypes.c_char_p
    return lib


def _geometry(m: int, c: int, rows_2d, device) -> Tuple[int, ...]:
    """``(vec, tx, ctiles, blocks, rows)`` of a launch over ``[m, c]``:
    16-byte vectors when C and every row tensor allow it; TX threads along
    C (a power of two up to 32) by 256/TX along M; enough row blocks for
    about one full wave of 8 blocks per SM, each thread lane taking at
    least 4 rows."""
    itemsize = rows_2d[0].element_size()
    vec = 16 // itemsize
    if c % vec or any(t.data_ptr() % 16 for t in rows_2d):
        vec = 1
    nv = -(-c // vec)
    tx = min(32, 1 << (nv - 1).bit_length())
    ctiles = -(-nv // tx)
    ty = _THREADS // tx
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = max(1, min(-(-sms * _BLOCKS_PER_SM // ctiles), -(-m // (4 * ty))))
    rows = -(-m // blocks)
    return vec, tx, ctiles, -(-m // rows), rows


def _check_cuda(what, rows_2d, chans):
    """Raise ``ValueError`` on what the kernels do not take: row tensors
    ``[M, C]`` contiguous, of one dtype (float32 or bfloat16) and device;
    channel vectors contiguous float32 ``[C]`` (``[2, C]`` for red)."""
    x = rows_2d[0]
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{what}: wants a non-empty [M, C] tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what} kernel takes float32 or bfloat16 rows, got "
                         f"{x.dtype}")
    for t in rows_2d:
        if t.device != x.device or t.dtype != x.dtype \
                or t.shape != x.shape or not t.is_contiguous():
            raise ValueError(f"{what} kernel wants contiguous [M, C] rows of "
                             f"one dtype and device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device} (contiguous="
                             f"{t.is_contiguous()}) beside {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    c = x.shape[1]
    for t in chans:
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape[-1] != c:
            raise ValueError(f"{what} kernel wants contiguous float32 "
                             f"channel vectors of {c} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cuda error {rc} "
                           f"({lib.bn_error_string(rc).decode()})")


def _reduce_cuda(mode, relu, x2d, dy, res2d, chans, eps, name):
    rows_2d = [t for t in (x2d, dy, res2d) if t is not None]
    _check_cuda(name, rows_2d, chans)
    m, c = x2d.shape
    geo = _geometry(m, c, rows_2d, x2d.device)
    ws = torch.empty((geo[3], 2, c), dtype=torch.float32, device=x2d.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x2d.device)
    ptrs = [0 if t is None else t.data_ptr() for t in (x2d, dy, res2d)]
    ptrs += [t.data_ptr() for t in chans] if chans else [0] * 4
    lib = _lib()
    rc = lib.bn_reduce_launch(
        _MODE[mode], int(relu), _DTYPE_CODES[x2d.dtype], geo[0], *ptrs, eps,
        m, c, *geo[1:], ws.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def _stats_cuda(x2d: torch.Tensor) -> torch.Tensor:
    return _reduce_cuda("stats", False, x2d, None, None, (), 0.0, "bn_stats")


def _apply_cuda(x2d, mean, var, gamma, beta, res2d, eps, relu):
    rows_2d = [x2d] + ([] if res2d is None else [res2d])
    _check_cuda("bn_apply", rows_2d, (mean, var, gamma, beta))
    m, c = x2d.shape
    out = torch.empty_like(x2d)
    vec, *geo = _geometry(m, c, rows_2d + [out], x2d.device)
    lib = _lib()
    rc = lib.bn_apply_launch(
        int(res2d is not None), int(relu), _DTYPE_CODES[x2d.dtype], vec,
        x2d.data_ptr(), 0 if res2d is None else res2d.data_ptr(),
        mean.data_ptr(), var.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        eps, m, c, *geo, out.data_ptr(),
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _raise_on(lib, rc, "bn_apply")
    LAUNCHES["bn_apply"] += 1
    return out


def _bwd_reduce_cuda(dy, x2d, mean, var, gamma, beta, res2d, eps, relu):
    if res2d is None:
        return _reduce_cuda("bwd", relu, x2d, dy, None,
                            (mean, var, gamma, beta), eps, "bn_bwd_reduce")
    return _reduce_cuda("bwd_res", relu, x2d, dy, res2d,
                        (mean, var, gamma, beta), eps, "bn_add_bwd_reduce")


def _bwd_dx_cuda(dy, x2d, mean, var, gamma, beta, red, res2d, eps, relu,
                 minv):
    name = "bn_bwd_dx" if res2d is None else "bn_add_bwd_dx"
    rows_2d = [t for t in (x2d, dy, res2d) if t is not None]
    _check_cuda(name, rows_2d, (mean, var, gamma, beta, red))
    if red.shape != (2, x2d.shape[1]):
        raise ValueError(f"{name}: red must be [2, C], got "
                         f"{tuple(red.shape)}")
    m, c = x2d.shape
    dx = torch.empty_like(x2d)
    dres = None if res2d is None else torch.empty_like(res2d)
    vec, *geo = _geometry(
        m, c, rows_2d + [t for t in (dx, dres) if t is not None], x2d.device)
    lib = _lib()
    rc = lib.bn_dx_launch(
        int(res2d is not None), int(relu), _DTYPE_CODES[x2d.dtype], vec,
        dy.data_ptr(), x2d.data_ptr(),
        0 if res2d is None else res2d.data_ptr(), mean.data_ptr(),
        var.data_ptr(), gamma.data_ptr(), beta.data_ptr(), red.data_ptr(),
        eps, minv, m, c, *geo, dx.data_ptr(),
        0 if dres is None else dres.data_ptr(),
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return dx, dres


# ---------------------------------------------------------------------
# Dispatch by the tensors' device.
# ---------------------------------------------------------------------

def _on(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused BatchNorm runs on cuda or cpu tensors, got "
                         f"{x.device}")
    return x.device.type


def _bn_stats(x2d):
    if _on(x2d) == "cuda":
        return _stats_cuda(x2d)
    return _stats_plain(x2d)


def _bn_apply(x2d, mean, var, gamma, beta, res2d, eps, relu):
    if _on(x2d) == "cuda":
        return _apply_cuda(x2d, mean, var, gamma, beta, res2d, eps, relu)
    return _apply_plain(x2d, mean, var, gamma, beta, res2d, eps, relu)


def _bn_bwd_reduce(dy, x2d, mean, var, gamma, beta, res2d, eps, relu):
    if _on(x2d) == "cuda":
        return _bwd_reduce_cuda(dy, x2d, mean, var, gamma, beta, res2d, eps,
                                relu)
    return _bwd_reduce_plain(dy, x2d, mean, var, gamma, beta, res2d, eps,
                             relu)


def _bn_bwd_dx(dy, x2d, mean, var, gamma, beta, red, res2d, eps, relu, minv):
    if _on(x2d) == "cuda":
        return _bwd_dx_cuda(dy, x2d, mean, var, gamma, beta, red, res2d, eps,
                            relu, minv)
    return _bwd_dx_plain(dy, x2d, mean, var, gamma, beta, red, res2d, eps,
                         relu, minv)


def _batch_stats(sums: torch.Tensor, m: int):
    """mean = Σx/M, var = max(Σx²/M − mean², 0), as true divisions by a
    0-d tensor (a Python divisor becomes a reciprocal multiply on the
    card)."""
    mt = torch.full((), float(m), dtype=torch.float32, device=sums.device)
    mean = sums[0] / mt
    return mean, torch.clamp_min(sums[1] / mt - mean * mean, 0.0)


class _BNActFn(torch.autograd.Function):
    """The counterpart of the JAX package's ``bn_act_2d`` /
    ``bn_add_act_2d`` custom VJPs over ``[M, C]``: the forward saves x
    (and the residual), the batch statistics and γ/β; the backward runs
    the reduce pass, then the dx pass, and ignores the statistics'
    cotangents."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, res2d, eps, relu):
        sums = _bn_stats(x2d)
        mean, var = _batch_stats(sums, x2d.shape[0])
        g32, b32 = gamma.float().contiguous(), beta.float().contiguous()
        out = _bn_apply(x2d, mean, var, g32, b32, res2d, eps, relu)
        ctx.save_for_backward(x2d, res2d, mean, var, g32, b32)
        ctx.eps, ctx.relu = eps, relu
        ctx.gamma_dtype, ctx.beta_dtype = gamma.dtype, beta.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2d, res2d, mean, var, g32, b32 = ctx.saved_tensors
        dy = dy.contiguous()
        red = _bn_bwd_reduce(dy, x2d, mean, var, g32, b32, res2d, ctx.eps,
                             ctx.relu)
        dx, dres = _bn_bwd_dx(dy, x2d, mean, var, g32, b32, red, res2d,
                              ctx.eps, ctx.relu, 1.0 / x2d.shape[0])
        return (dx, red[1].to(ctx.gamma_dtype), red[0].to(ctx.beta_dtype),
                dres, None, None)


def bn_act_2d(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5, relu: bool = True):
    """Fused train-mode BatchNorm(+ReLU) over ``[M, C]``: returns
    ``(out, mean, var)``; mean/var are the batch statistics (f32, no
    gradient) for the running averages."""
    return _BNActFn.apply(x2d, gamma, beta, None, eps, relu)


def bn_add_act_2d(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  res2d: torch.Tensor, eps: float = 1e-5, relu: bool = True):
    """``relu?(bn(x) + res)`` over ``[M, C]`` — the bottleneck-exit
    epilogue in one pass. Returns ``(out, mean, var)``."""
    return _BNActFn.apply(x2d, gamma, beta, res2d, eps, relu)


def fused_bn_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 residual: Optional[torch.Tensor] = None, *,
                 eps: float = 1e-5, relu: bool = True
                 ) -> Optional[Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]]:
    """NHWC (or any ``[..., C]``) entry: train-mode fused
    BN(+add)(+ReLU). Returns ``(out, mean, var)``. A CUDA tensor always
    runs the kernels (or raises). A CPU tensor returns ``None`` where the
    JAX package's tiling rule finds no clean tiling, and the caller falls
    back to plain math, as the reference does.

    ``x`` (and ``residual``, of x's shape) must be contiguous in their
    ``[..., C]`` order — for an NCHW tensor, pass
    ``x.permute(0, 2, 3, 1)`` of a ``torch.channels_last`` one: the
    ``[M, C]`` view is then free. A tensor that would need a copy raises
    ``ValueError``."""
    c = x.shape[-1]
    m = x.numel() // c
    # Worst kernel: the dx pass — (dy, x[, res]) in, (dx[, dres]) out.
    n_bufs = 3 if residual is None else 5
    if _on(x) == "cpu" and pick_block_rows(m, c, x.element_size(),
                                           n_bufs) is None:
        return None
    for name, t in (("x", x), ("residual", residual)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"fused_bn_act: {name} of shape "
                             f"{tuple(t.shape)} and strides {t.stride()} is "
                             f"not contiguous with channels last; its "
                             f"[M, C] view would need a copy")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"fused_bn_act: residual {tuple(residual.shape)} "
                         f"vs x {tuple(x.shape)}")
    x2d = x.view(m, c)
    if residual is None:
        out, mean, var = bn_act_2d(x2d, gamma, beta, eps, relu)
    else:
        out, mean, var = bn_add_act_2d(x2d, gamma, beta,
                                       residual.view(m, c), eps, relu)
    return out.view(x.shape), mean, var
