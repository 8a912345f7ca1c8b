"""Quantized compute lane: the counterpart of :mod:`tony_tpu.ops.quant`
(its int8 compute part, quant.py:68-357).

* :func:`scale_of`, :func:`quantize`, :func:`dequantize`, :func:`_rescale`
  — symmetric int8 quantization: ``clip(round(x / scale), ±127)`` with
  round-half-even, scales ``max(amax, 1e-12) / 127``.
* :func:`int8_matmul` — ``[M, K] int8 @ [N, K]ᵀ int8 → int32`` over the
  whole K, then ``f32(acc) · (sx · sw[n])``. A CUDA tensor launches the
  hand-written Hopper kernels of ``csrc/int8_matmul.cu`` as
  :func:`_int8_plan` says (``wgmma`` with TMA; the ``mma.sync`` kernel
  for operands TMA cannot address), or raises; a CPU tensor runs
  :func:`_int8_matmul_plain`. Integer accumulation is exact in any order
  and every path rounds the epilogue the same way, so all are bitwise
  equal (:func:`_int8_matmul_split_plain` models the split on the CPU),
  and bitwise the JAX package's XLA and Pallas paths.
* :func:`quant_dot` / :func:`quant_dot_general` — quantize (per-tensor
  activations, per-channel or per-tensor weights), matmul, rescale, with
  straight-through gradients (:class:`_QuantDot`): the backward is two f32
  matmuls on the dequantized operands, as in the JAX package's
  ``custom_vjp``.
* :class:`QuantDense` — the ``nn.Linear`` twin the model lanes use
  (weight ``[N, K]``, optional bias), dynamic (current-tensor) scales.
* :class:`QuantConfig`, :func:`push_amax`, :func:`hist_scale`,
  :func:`bucket_amax` — the delayed-scaling helpers (pure tensor math).
* Quantize-on-gather (quant.py:309-624): the ZeRO-3 forward gathers
  (:class:`~tony_tpu_torch.parallel.sched.GatherPlan`, through the gather
  window) send int8 codes of each even scatter bucket's local chunk,
  quantized with a bucket scale every rank shares, and dequantize them on
  arrival, so the int8 gather is bitwise quantize-after-gather. The scale
  is delayed: a per-bucket ``[window]`` amax history rides the train
  state (:func:`with_gather_quant` → :class:`~tony_tpu_torch.train
  .QuantTrainState`), each step quantizes with ``max(history) / 127``
  and rolls the current amax in (:func:`delayed_scales`). The history
  saves and restores through a portable codec whose form is per leaf, so
  a step saved at one fsdp size or by either package restores into
  another (:func:`amax_to_leaf_major`, :func:`leaf_major_to_amax`).

The public functions keep the JAX package's layout (``quant_dot(x, w)``
with ``w`` ``[K, N]``); the module and the kernel take torch's ``[N, K]``
weight, whose rows are the contraction-contiguous ``col`` operand of the
tensor-core MMA, so nothing is transposed or copied.

Rounding follows the JAX package's expressions as written, which is
what its functions compute op by op: ``scale_of`` divides by 127 and the
rescale multiplies ``f32(acc)`` by the rounded product ``sx · sw``. Every
division here is by a tensor, never by a Python scalar (on the card a
Python-scalar divisor becomes a multiply by its reciprocal and flips
codes at ties). Under ``jax.jit`` XLA rewrites both: the division by the
constant 127 becomes a multiply by its f32 reciprocal, and the rescale's
two scales are reassociated with the folded constant 127⁻², so a jitted
JAX program's scales can differ from these (and from eager JAX's) in
the last bit; the model-level comparisons hold a tolerance for that.

The lane is not row-independent: the activation scale is the amax over
every row of the call, so a row's codes depend on the rows it is
launched with (padding rows included).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as td
from torch import nn

from tony_tpu_torch import resolve_device
from tony_tpu_torch.ops.attention import LAUNCHES
from tony_tpu_torch.parallel.overlap import DEFAULT_BUCKET_BYTES

# Symmetric int8: codes in [-127, 127] (the -128 code is unused, so the
# range is symmetric and negation is exact).
QMAX = 127.0
# An all-zero tensor quantizes to zeros, not NaNs.
AMAX_FLOOR = 1e-12


def scale_of(amax) -> torch.Tensor:
    """Symmetric scale from an amax statistic (elementwise over
    per-channel vectors): ``max(amax, floor) / 127`` in f32, divided by
    a 0-d tensor on ``amax``'s device (no host sync)."""
    a = torch.as_tensor(amax).to(torch.float32)
    return torch.clamp_min(a, AMAX_FLOOR) / a.new_full((), QMAX)


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), ±127)`` as int8, round-half-even.
    ``scale`` is a tensor that broadcasts against ``x`` (0-d per tensor,
    a vector per channel)."""
    q = torch.div(x.to(torch.float32), scale.to(torch.float32))
    return q.round_().clamp_(-QMAX, QMAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _rescale(acc: torch.Tensor, sx: torch.Tensor,
             sw: torch.Tensor) -> torch.Tensor:
    """The f32 rescale of an int32 accumulator (quant.py:100), shared by
    the plain version; the kernel's epilogue rounds the same two
    products: ``f32(acc) · (sx · sw)``."""
    return acc.to(torch.float32) * (sx * sw)


# ---------------------------------------------------------------------
# The int8 matmul core: kernel row 15.
# ---------------------------------------------------------------------

def _int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                       sw: torch.Tensor) -> torch.Tensor:
    """Plain version: the integer product in float64 (exact while
    |acc| < 2⁵³; here |acc| ≤ K·127²), back to int32, then
    :func:`_rescale`. Bitwise the kernel on the card and the JAX
    package's paths on the CPU."""
    acc = torch.matmul(xq.to(torch.float64), wq.to(torch.float64).t())
    return _rescale(acc.to(torch.int32), sx, sw)


# The wgmma kernel's output tiles (BM, BN), in the order of the C
# launcher's tile codes.
_TILES = ((64, 128), (128, 128), (128, 176), (128, 256))
_TILE_CODE = {t: i for i, t in enumerate(_TILES)}
_KTILE = 128            # bytes of K in one stage of the TMA ring
# M up to this (decode, prefill) picks its tile by how its units fill
# the card; larger M takes 128 x 256.
_SMALL_M = 512


class Int8Plan(NamedTuple):
    """How one ``int8_matmul`` call runs on the card. ``path`` is
    ``"wgmma"`` (TMA + ``wgmma``) or ``"mma_sync"`` (the first kernel, for
    operands TMA cannot address, which tiles itself: the rest stay at
    their defaults). On ``wgmma``: ``tile`` the (BM, BN) output tile of a
    block; the ``ceil(K / 128)`` K tiles go to ``splits`` ranges of
    ``cps`` tiles; ``units`` = tiles × splits, walked by ``grid`` blocks;
    ``workspace`` the int32 partials' shape ``(splits, M, N)`` when
    split, else None."""
    path: str
    tile: Optional[Tuple[int, int]] = None
    splits: int = 1
    cps: Optional[int] = None
    units: Optional[int] = None
    grid: Optional[int] = None
    workspace: Optional[Tuple[int, int, int]] = None


def _k_ranges(nk: int, splits: int) -> Tuple[int, int]:
    """``nk`` K tiles cut into at most ``splits`` ranges of ``cps`` tiles,
    none empty: returns ``(splits, cps)``."""
    splits = max(1, min(splits, nk))
    cps = -(-nk // splits)
    return -(-nk // cps), cps


@functools.lru_cache(maxsize=512)
def _int8_plan(m: int, n: int, k: int, sms: int, lda: Optional[int] = None,
               ldb: Optional[int] = None, aligned: bool = True,
               splits: int = 1,
               tile: Optional[Tuple[int, int]] = None) -> Int8Plan:
    """The launch plan of one call on a card with ``sms`` SMs: pure
    arithmetic on the shape, the row strides (``lda``/``ldb``, default K)
    and whether both base pointers are 16-byte aligned. TMA needs K, both
    row strides (at least K) and both pointers in 16-byte steps; anything
    else takes the ``mma_sync`` path. M > 512 is bound by its operations
    and takes 128 × 256 tiles. M ≤ 512 takes, of the tiles of ``_TILES``
    no taller than M needs, the one whose units fill the persistent
    grid's waves best (ties to the larger tile). Blocks of neighbouring
    units share a weight tile, so it crosses DRAM once and the other m
    tiles read it from L2. K is split over blocks only where ``splits``
    asks for it (tests, the bench): a split adds an int32 partial's
    round trip and the combine kernel's launch, and on an H100 it saved
    card time only at some 16- and 64-row shapes, less than the host
    time the second launch adds to their host-paced step
    (``exp/port_int8_bench.py --sweep``). ``tile`` forces the tile; no
    choice here changes a bit of the output."""
    lda = k if lda is None else lda
    ldb = k if ldb is None else ldb
    if not (aligned and k > 0 and k % 16 == 0 and lda % 16 == 0
            and ldb % 16 == 0 and lda >= k and ldb >= k):
        return Int8Plan("mma_sync")

    def tiles(t):
        return -(-m // t[0]) * -(-n // t[1])

    def fill(t):
        return tiles(t) / (-(-tiles(t) // sms) * sms)
    if tile is None:
        if m > _SMALL_M:
            tile = (128, 256)
        else:
            fits = [t for t in _TILES if t[0] <= -(-m // 64) * 64]
            tile = max(fits, key=lambda t: (fill(t), t[0] * t[1]))
    splits, cps = _k_ranges(-(-k // _KTILE), splits)
    units = tiles(tile) * splits
    return Int8Plan("wgmma", tuple(tile), splits, cps, units,
                    min(units, sms), (splits, m, n) if splits > 1 else None)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _int8_matmul_split_plain(xq: torch.Tensor, wq: torch.Tensor,
                             sx: torch.Tensor, sw: torch.Tensor,
                             splits: int, ktile: int = _KTILE) -> torch.Tensor:
    """Plain model of the split over K: int32 partial sums over the plan's
    K ranges (``splits`` ranges of whole ``ktile``-wide tiles, as
    :func:`_k_ranges` cuts them), added, then :func:`_rescale` once.
    Bitwise :func:`_int8_matmul_plain` at every split count."""
    k = xq.shape[1]
    splits, cps = _k_ranges(max(1, -(-k // ktile)), splits)
    acc = torch.zeros((xq.shape[0], wq.shape[0]), dtype=torch.int32,
                      device=xq.device)
    for s in range(splits):
        lo, hi = s * cps * ktile, min(k, (s + 1) * cps * ktile)
        acc += torch.matmul(xq[:, lo:hi].to(torch.float64),
                            wq[:, lo:hi].to(torch.float64).t()).to(torch.int32)
    return _rescale(acc, sx, sw)


def _lib() -> ctypes.CDLL:
    from tony_tpu_torch.ops import _build

    lib = _build.load(["int8_matmul"])["int8_matmul"]
    fn = lib.int8_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.int8_matmul_wgmma_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_int64] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _int8_matmul_cuda(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                      sw: torch.Tensor, splits: int = 1,
                      tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Check what the kernels take, plan the call (:func:`_int8_plan`;
    ``splits`` and ``tile`` force its choices on the ``wgmma`` path:
    tests and tuning), allocate the
    output (and the split's workspace), launch on the current stream.
    Raises ``ValueError`` on an input the kernels do not take and
    ``RuntimeError`` when a launch fails."""
    dev = xq.device
    m, k = xq.shape
    n = wq.shape[0]
    for name, x in (("wq", wq), ("sx", sx), ("sw", sw)):
        if x.device != dev:
            raise ValueError(f"int8_matmul: {name} on {x.device}, xq on "
                             f"{dev}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"int8_matmul kernel takes int8 xq and wq, got "
                         f"{xq.dtype}/{wq.dtype}")
    if sx.dtype != torch.float32 or sx.numel() != 1 \
            or sw.dtype != torch.float32 or tuple(sw.shape) != (n,) \
            or sw.stride(0) != 1:
        raise ValueError(f"int8_matmul kernel takes an f32 scalar sx and a "
                         f"contiguous f32 sw [{n}], got {sx.dtype} "
                         f"{tuple(sx.shape)} / {sw.dtype} {tuple(sw.shape)}")
    if (k > 1 and (xq.stride(1) != 1 or wq.stride(1) != 1)) \
            or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"int8_matmul kernel needs K-contiguous rows and "
                         f"dims below 2^31 (strides {xq.stride()}/"
                         f"{wq.stride()})")
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _lib()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    # The raw handle: a Stream object costs the host ~6 µs a call.
    stream = torch._C._cuda_getCurrentRawStream(index)
    pa, pb = xq.data_ptr(), wq.data_ptr()
    lda, ldb = xq.stride(0), wq.stride(0)
    plan = _int8_plan(m, n, k, _sms(index), lda, ldb,
                      pa % 16 == 0 and pb % 16 == 0, splits, tile)
    if plan.workspace is not None:
        # The combine kernel writes each output over its own split-0
        # partial, read first: one allocation holds both.
        ws = torch.empty(plan.workspace, dtype=torch.int32, device=dev)
        out = ws[0].view(torch.float32)
    else:
        ws = None
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if plan.path == "wgmma":
        rc = lib.int8_matmul_wgmma_launch(
            pa, pb, sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, k, lda, ldb,
            _TILE_CODE[plan.tile], plan.splits, plan.cps, plan.grid,
            stream)
    else:
        rc = lib.int8_matmul_launch(pa, pb, sx.data_ptr(), sw.data_ptr(),
                                    out.data_ptr(), m, n, k, lda, ldb, n,
                                    stream)
    if rc != 0:
        raise RuntimeError(
            f"int8_matmul kernel launch failed: cuda error {rc} "
            f"({lib.int8_matmul_error_string(rc).decode()})")
    LAUNCHES["int8_matmul"] += 1
    return out


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] int8`` times ``wq [N, K] int8`` transposed, accumulated
    in int32 over the whole K, rescaled to f32 ``[M, N]`` by the scalar
    ``sx`` and the per-column ``sw [N]`` (0-d / 1-D f32 tensors on the
    inputs' device: never read back to the host). A CUDA tensor launches
    the kernel (``LAUNCHES["int8_matmul"]``) or raises; a CPU tensor runs
    :func:`_int8_matmul_plain`."""
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"int8_matmul wants xq [M, K] and wq [N, K], got "
                         f"{tuple(xq.shape)} / {tuple(wq.shape)}")
    if xq.device.type == "cuda":
        return _int8_matmul_cuda(xq, wq, sx, sw)
    if xq.device.type != "cpu":
        raise ValueError(f"int8_matmul runs on cuda or cpu tensors, got "
                         f"{xq.device}")
    return _int8_matmul_plain(xq, wq, sx, sw)


# ---------------------------------------------------------------------
# quant_dot: quantize + matmul + rescale, straight-through gradients.
# ---------------------------------------------------------------------

# The codes are made K-contiguous for the kernel: a no-op for contiguous
# operands (quant_dot's [K, N] weight arrives as a transposed view).

def _quantize_act(x2: torch.Tensor):
    """Per-tensor codes and 0-d scale of the rows ``x2 [M, K]``."""
    sx = scale_of(torch.amax(torch.abs(x2)))
    return quantize(x2, sx).contiguous(), sx


def _quantize_weight(w: torch.Tensor, per_channel: bool):
    """Codes of ``w [N, K]`` and its ``[N]`` scales, one per output row
    (or the per-tensor scale broadcast)."""
    aw = torch.amax(torch.abs(w), dim=1) if per_channel \
        else torch.amax(torch.abs(w))
    sw = scale_of(aw).expand(w.shape[0]).contiguous()
    return quantize(w, sw[:, None]).contiguous(), sw


def _qdot_impl(x: torch.Tensor, w: torch.Tensor, per_channel: bool):
    """Quantize ``x [..., K]`` per tensor and ``w [N, K]`` per row (or
    per tensor), then :func:`int8_matmul`. Returns ``(y f32 [..., N],
    (xq, sx, wq, sw))`` — the int8 residuals the STE backward
    dequantizes."""
    xq, sx = _quantize_act(x.reshape(-1, x.shape[-1]))
    wq, sw = _quantize_weight(w, per_channel)
    y = int8_matmul(xq, wq, sx, sw)
    return y.reshape(*x.shape[:-1], w.shape[0]), (xq, sx, wq, sw)


class _QuantDot(torch.autograd.Function):
    """``y = quant(x) @ quant(w)ᵀ`` with the straight-through estimator:
    ``dx = g @ deq(wq)`` and ``dw = gᵀ @ deq(xq)`` in f32, cast to the
    primal dtypes (quant.py:208-234)."""

    @staticmethod
    def forward(ctx, x, w, per_channel):
        y, (xq, sx, wq, sw) = _qdot_impl(x, w, per_channel)
        ctx.save_for_backward(xq, sx, wq, sw)
        ctx.x_meta = (x.shape, x.dtype)
        ctx.w_dtype = w.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        xq, sx, wq, sw = ctx.saved_tensors
        x_shape, x_dtype = ctx.x_meta
        g2 = g.reshape(-1, g.shape[-1]).to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g2 @ dequantize(wq, sw[:, None])).reshape(x_shape) \
                .to(x_dtype)
        if ctx.needs_input_grad[1]:
            dw = (g2.t() @ dequantize(xq, sx)).to(ctx.w_dtype)
        return dx, dw, None


def quant_dot(x: torch.Tensor, w: torch.Tensor, *,
              per_channel: bool = True) -> torch.Tensor:
    """Quantized ``x @ w``: ``x`` is ``[..., K]``, ``w`` is ``[K, N]`` (the
    JAX package's layout); the result is f32 ``[..., N]``, with
    straight-through gradients in the primal dtypes. The device picks the
    path (kernel on the card, plain version on the CPU)."""
    if w.ndim != 2:
        raise ValueError(f"quant_dot expects a rank-2 rhs [K, N], got "
                         f"shape {tuple(w.shape)}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"contraction mismatch: x[..., {x.shape[-1]}] "
                         f"@ w[{w.shape[0]}, ...]")
    return _QuantDot.apply(x, w.t(), per_channel)


def quant_dot_general(lhs: torch.Tensor, rhs: torch.Tensor,
                      dimension_numbers, **kw) -> torch.Tensor:
    """``lax.dot_general``-shaped entry over :func:`quant_dot`: one
    contracting dim per side, no batch dims; anything else raises
    ``NotImplementedError``."""
    (lc, rc), (lb, rb) = dimension_numbers
    if lb or rb or len(lc) != 1 or len(rc) != 1:
        raise NotImplementedError(
            "quant_dot_general supports a single contracting dim per "
            f"side and no batch dims, got {dimension_numbers}")
    lhs_t = torch.movedim(lhs, lc[0], -1)
    rhs_t = torch.movedim(rhs, rc[0], 0)
    rest = rhs_t.shape[1:]
    y = quant_dot(lhs_t, rhs_t.reshape(rhs_t.shape[0], -1), **kw)
    return y.reshape(*lhs_t.shape[:-1], *rest)


class QuantDense(nn.Linear):
    """``nn.Linear`` twin on the quantized lane (the JAX ``QuantDense``):
    ``weight [N, K]`` stored in ``param_dtype`` and quantized per output
    channel as stored (never cast to ``dtype`` first), optional ``bias``;
    returns ``(y + bias)`` cast to ``dtype``, with ``y`` the f32 rescaled
    product of :func:`quant_dot`'s core. ``device=None`` means the card
    (:func:`tony_tpu_torch.resolve_device`)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False, *, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=param_dtype, device=resolve_device(device))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _QuantDot.apply(x, self.weight, True)
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.compute_dtype)


# ---------------------------------------------------------------------
# Delayed scaling (the mesh-free helpers of quant.py:312-357).
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """The quantized-gather lane's knobs: ``window`` is the amax-history
    length, ``bucket_bytes`` the bucket plan geometry the per-bucket amax
    state was built for."""

    window: int = 8
    bucket_bytes: int = DEFAULT_BUCKET_BYTES

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")


def push_amax(hist: torch.Tensor, amax) -> torch.Tensor:
    """Roll one fresh amax into a ``[window]`` history (oldest falls
    out)."""
    new = torch.as_tensor(amax, device=hist.device).to(torch.float32)
    return torch.cat([hist[1:], new.reshape(1)]).to(hist.dtype)


def hist_scale(hist: torch.Tensor) -> torch.Tensor:
    """Delayed scale from a history: ``max(hist) / 127``."""
    return scale_of(torch.amax(hist))


def bucket_amax(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Current amax of one bucket: the max over its leaves' |max| (max
    commutes with concatenation, so no buffer is built)."""
    return functools.reduce(
        torch.maximum,
        [torch.amax(torch.abs(leaf.to(torch.float32))) for leaf in leaves])


# ---------------------------------------------------------------------
# Quantize-on-gather (quant.py:309-490): the ZeRO-3 gathers' int8 wire.
# ---------------------------------------------------------------------

def is_quant_state(state: Any) -> bool:
    """A train state riding the quantized-gather lane (or its portable
    form)."""
    from tony_tpu_torch.models.convert import PortableState

    if isinstance(state, PortableState):
        state = state.live
    return getattr(state, "quant_state", None) is not None \
        and getattr(state, "qconfig", None) is not None


def check_quant_amax(gplan: Any, amax: Sequence[torch.Tensor]) -> None:
    """The amax state must match this gather plan's bucket geometry: a
    mismatch means it was built for another ``bucket_bytes`` or fsdp
    size."""
    if len(amax) != gplan.n_gather_buckets:
        raise ValueError(
            f"quant_amax carries {len(amax)} histories but the gather "
            f"plan has {gplan.n_gather_buckets} buckets — the state was "
            f"built for a different bucket_bytes or fsdp topology; "
            f"rebuild it (with_gather_quant) or restore through the "
            f"portable leaf-major form")
    for k, h in enumerate(amax):
        shape = tuple(h.shape)
        if len(shape) != 1 or shape[0] < 1 or (
                k and shape != tuple(amax[0].shape)):
            raise ValueError(
                f"amax history {k} has shape {shape} — every history "
                f"must be one non-empty [window] f32 vector (bucket 0's "
                f"is {tuple(amax[0].shape)})")


def _current_amax(gplan: Any, leaves: Sequence[torch.Tensor],
                  group: Any) -> torch.Tensor:
    """Each gather bucket's amax over every rank: the local max over its
    member leaves (this rank's shards), then one max all-reduce over the
    fsdp ``group`` for all buckets."""
    plan = gplan.plan
    cur = torch.stack([bucket_amax([leaves[i].detach()
                                    for i in plan.buckets[b]])
                       for b in gplan.gather_buckets])
    td.all_reduce(cur, op=td.ReduceOp.MAX, group=group)
    return cur


def delayed_scales(gplan: Any, leaves: Sequence[torch.Tensor],
                   amax: Sequence[torch.Tensor], group: Any
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """This step's shared scale per gather bucket, from the history the
    state carried in, and each history with the current amax rolled in
    (measured once, at the step's entry: the parameters do not change
    inside it)."""
    scales = [hist_scale(h) for h in amax]
    if not amax:
        return scales, []
    cur = _current_amax(gplan, leaves, group)
    return scales, [push_amax(h, cur[k]) for k, h in enumerate(amax)]


def _plans_of(params: Sequence[torch.Tensor], mesh: Any,
              bucket_bytes: int):
    """(plan, gplan) of the quantized-gather lane: the derivation the
    accumulating step uses (``overlap.step_plans``)."""
    from tony_tpu_torch.parallel import overlap

    if mesh is None:
        raise ValueError(
            "quantize-on-gather needs a ZeRO-3 (fsdp-sharded) layout on "
            "a mesh — the state has no mesh")
    specs = overlap.fsdp_param_specs(params, mesh)
    if specs is None:
        raise ValueError(
            "quantize-on-gather needs fsdp-sharded params (the lane "
            "quantizes the forward param gathers; a replicated layout "
            "has none)")
    return overlap.step_plans(params, mesh, bucket_bytes=bucket_bytes,
                              param_specs=specs)


def _seed_histories(gplan: Any, params: Sequence[torch.Tensor], mesh: Any,
                    window: int) -> List[torch.Tensor]:
    from tony_tpu_torch.parallel import FSDP

    cur = _current_amax(gplan, params, mesh.group((FSDP,))) \
        if gplan.n_gather_buckets else []
    return [torch.full((window,), float(m), dtype=torch.float32,
                       device=mesh.device) for m in cur]


def with_gather_quant(state: Any, mesh: Any, *, window: int = 8,
                      bucket_bytes: Optional[int] = None) -> Any:
    """Attach the quantized-gather lane to a ZeRO-3 train state: derive
    the gather plan from the parameters' layouts and seed every bucket's
    ``[window]`` amax history from the current parameter magnitudes (so
    step 1's delayed scale is already calibrated). ``bucket_bytes``
    defaults from a FusedOptimizer tx. Returns a
    :class:`~tony_tpu_torch.train.QuantTrainState` over the same model,
    optimizer and buckets."""
    from tony_tpu_torch import profiler
    from tony_tpu_torch.train import QuantTrainState

    if bucket_bytes is None:
        bucket_bytes = getattr(state.tx, "bucket_bytes",
                               DEFAULT_BUCKET_BYTES)
    qcfg = QuantConfig(window=window, bucket_bytes=bucket_bytes)
    params = list(state.model.parameters())
    plan, gplan = _plans_of(params, mesh, bucket_bytes)
    amax = _seed_histories(gplan, params, mesh, window)
    profiler.record_quant(
        "attach", n_buckets=gplan.n_gather_buckets, window=window,
        bucket_bytes=bucket_bytes, raw_nbytes=list(gplan.gather_nbytes),
        int8_nbytes=[plan.bucket_numel[b] for b in gplan.gather_buckets])
    fields = {f.name: getattr(state, f.name)
              for f in dataclasses.fields(state)
              if f.name not in ("qconfig", "quant_state")}
    return QuantTrainState(**fields, qconfig=qcfg,
                           quant_state={"amax": amax})


def gather_roundtrip_exact(params: Sequence[torch.Tensor], mesh: Any,
                           bucket_bytes: int) -> bool:
    """The quantize-on-gather exactness pin as a callable check: for every
    gathered leaf, the int8 gather dequantized equals quantize then
    dequantize of the unquantized gather, bit for bit (the shared scale
    commutes with the collective). True on every rank or on none."""
    from tony_tpu_torch.parallel import FSDP

    params = list(params)
    plan, gplan = _plans_of(params, mesh, bucket_bytes)
    group = mesh.group((FSDP,))
    scales = [scale_of(m) for m in _current_amax(gplan, params, group)] \
        if gplan.n_gather_buckets else []
    q_full = gplan.gather(params, group, scales=scales)
    full = gplan.gather(params, group)
    ok = True
    for k, b in enumerate(gplan.gather_buckets):
        for i in plan.buckets[b]:
            ref = dequantize(quantize(full[i], scales[k]), scales[k],
                             full[i].dtype)
            ok = ok and torch.equal(q_full[i], ref)
    flag = torch.tensor(1 if ok else 0, dtype=torch.int32,
                        device=mesh.device)
    td.all_reduce(flag, op=td.ReduceOp.MIN)
    return bool(flag.item())


# ---------------------------------------------------------------------
# The checkpoint codec (quant.py:493-624): per-bucket amax ⇄ per leaf.
# ---------------------------------------------------------------------

def _leaf_names(tree: Any, names: Dict[int, str],
                path: Tuple[Any, ...] = ()) -> List[Tuple[Tuple, List[str]]]:
    """The reference tree's leaves (``jax_param_tree``'s), each with the
    parameter names it covers (a stacked leaf covers one per layer)."""
    from tony_tpu_torch.ckpt.snapshot import LeafView

    found: List[Tuple[Tuple, List[str]]] = []
    if isinstance(tree, dict):
        for key, sub in tree.items():
            found += _leaf_names(sub, names, path + (key,))
        return found
    tensors = [t for _, t, _ in tree.parts] if isinstance(tree, LeafView) \
        else [tree]
    found.append((path, [names[id(t)] for t in tensors]))
    return found


def _amax_paths(model: nn.Module) -> List[Tuple[Tuple, List[str]]]:
    from tony_tpu_torch.models.convert import jax_param_tree

    names = {id(p): n for n, p in model.named_parameters()}
    return _leaf_names(jax_param_tree(model), names)


def _nest(items: Sequence[Tuple[Tuple, Any]]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in items:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def amax_to_leaf_major(model: nn.Module, plan: Any, gplan: Any,
                       amax: Sequence[torch.Tensor]) -> Dict[str, Any]:
    """Per-bucket histories → the reference's param tree of ``[window]``
    f32 host tensors: every member leaf carries its bucket's history, a
    leaf outside the lane zeros, and a leaf that stacks layers the
    elementwise max of its layers' (the conservative merge). The paths
    do not depend on the fsdp size: the portable form the manifest
    keeps."""
    window = int(amax[0].shape[0]) if amax else 1
    names = [n for n, _ in model.named_parameters()]
    per: Dict[str, np.ndarray] = {n: np.zeros((window,), np.float32)
                                  for n in names}
    for k, b in enumerate(gplan.gather_buckets):
        h = amax[k].detach().to("cpu", torch.float32).numpy()
        for i in plan.buckets[b]:
            per[names[i]] = h
    return _nest([(path, torch.from_numpy(functools.reduce(
        np.maximum, [per[n] for n in covered]).copy()))
        for path, covered in _amax_paths(model)])


def leaf_major_to_amax(model: nn.Module, plan: Any, gplan: Any,
                       tree: Dict[str, Any], device: Any
                       ) -> List[torch.Tensor]:
    """Inverse of :func:`amax_to_leaf_major` onto this plan's buckets: a
    bucket's history is the elementwise max over its member leaves' (the
    conservative merge when the partition changed; a too-large scale
    quantizes coarser for ``window`` steps, never clips). A bucket whose
    members all carry zeros merges to zeros, which the codec reseeds."""
    names = [n for n, _ in model.named_parameters()]
    per: Dict[str, torch.Tensor] = {}
    for path, covered in _amax_paths(model):
        node = tree
        for key in path:
            node = node[key]
        for n in covered:
            per[n] = torch.as_tensor(node).to(torch.float32)
    return [functools.reduce(torch.maximum, [per[names[i]] for i in
                                             plan.buckets[b]]).to(device)
            for b in gplan.gather_buckets]


def _inner_codec(tree: Any):
    from tony_tpu_torch import ckpt

    for name, predicate, encode, decode in ckpt.PORTABLE_CODECS:
        if name != "quant_gather" and predicate(tree):
            return encode, decode
    raise NotImplementedError(
        f"no portable codec takes the optimizer of this quantized state "
        f"({type(getattr(tree, 'tx', None)).__name__})")


def encode_state(state: Any) -> Any:
    """Ckpt codec, encode half: the train state's own portable form (its
    optimizer's codec) plus ``.quant_state['amax_leaf']``, the per-leaf
    histories."""
    encode, _ = _inner_codec(state)
    tree = encode(state)
    plan, gplan = _plans_of(list(state.model.parameters()), state.mesh,
                            state.qconfig.bucket_bytes)
    tree["quant_state"] = {"amax_leaf": amax_to_leaf_major(
        state.model, plan, gplan, state.quant_state["amax"])}
    return tree


def decode_state(tree: Any, mesh: Optional[Any] = None) -> Any:
    """Ckpt codec, decode half: the optimizer's decode, then the restored
    per-leaf histories merged onto this topology's buckets; a bucket that
    became gatherable only here (all-zero history) is reseeded from the
    live parameters, as :func:`with_gather_quant` seeds it — a floored
    scale would clip it to zero."""
    from tony_tpu_torch.models.convert import PortableState

    if not isinstance(tree, PortableState):
        return tree
    _, decode = _inner_codec(tree)
    state = decode(tree, mesh)
    params = list(state.model.parameters())
    plan, gplan = _plans_of(params, state.mesh, state.qconfig.bucket_bytes)
    amax = leaf_major_to_amax(state.model, plan, gplan,
                              tree["quant_state"]["amax_leaf"],
                              state.mesh.device)
    fresh = _seed_histories(gplan, params, state.mesh, state.qconfig.window)
    state.quant_state = {"amax": [
        fresh[k] if float(torch.amax(h)) == 0.0 else h
        for k, h in enumerate(amax)]}
    return state


def _register_codec() -> None:
    from tony_tpu_torch import ckpt

    # Ahead of the optimizers' codecs: a quantized state matches theirs
    # too, and this one delegates its optimizer to them.
    ckpt.register_portable_codec("quant_gather", is_quant_state,
                                 encode_state, decode_state, prepend=True)


_register_codec()


__all__ = ["AMAX_FLOOR", "QMAX", "QuantConfig", "QuantDense",
           "amax_to_leaf_major", "bucket_amax", "check_quant_amax",
           "delayed_scales", "dequantize", "gather_roundtrip_exact",
           "hist_scale", "int8_matmul", "is_quant_state",
           "leaf_major_to_amax", "push_amax", "quant_dot",
           "quant_dot_general", "quantize", "scale_of", "with_gather_quant"]
