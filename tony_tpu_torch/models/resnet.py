"""ResNet v1.5: the counterpart of :mod:`tony_tpu.models.resnet`.

``forward(x, train=True)`` takes NHWC images, as the JAX model does, and
returns f32 logits. Inside, activations are NCHW tensors in
``torch.channels_last`` layout — NHWC in memory — so cuDNN's convolutions
read and write NHWC, and the fused BatchNorm's ``[M, C]`` view of an
activation is a ``permute`` plus a ``view``, never a copy.

The numerics follow the JAX module: parameters (and the f32 running
statistics) stored f32, convolutions in the compute dtype (bf16 by
default; the weights cast at use), BatchNorm statistics in f32, the
final Dense in f32. Two BatchNorm lanes:

* ``fused_bn=True`` — :class:`FusedBNAct`: train-mode BN(+residual
  add)(+ReLU) through :func:`tony_tpu_torch.ops.batchnorm.fused_bn_act`
  (the hand-written kernels on the card at every shape; on the CPU, plain
  math in the compute dtype where the reference's tiling rule declines
  the shape); eval runs plain math in the compute dtype; blocks are
  :class:`FusedBottleneck`.
* ``fused_bn=False`` — :class:`BatchNorm`, the counterpart of flax's
  ``nn.BatchNorm`` as the plain lane uses it (f32 stats with
  E[x²] − E[x]², f32 normalize, output in the compute dtype); blocks are
  :class:`Bottleneck`.

Both lanes update the running statistics in place in train mode,
``mom·ra + (1 − mom)·stat`` with the biased batch variance (flax's rule,
not ``F.batch_norm``'s). Module names follow the flax auto-names
(``stem``, ``stem_bn``, ``Bottleneck_i``/``FusedBottleneck_i`` with
``Conv_j``, ``BatchNorm_k``/``FusedBNAct_k``, ``proj``, ``proj_bn``;
``Dense_0``), so :func:`tony_tpu_torch.models.convert.load_jax_params`
carries a JAX ``{"params", "batch_stats"}`` tree of either lane across.

A block takes a projection shortcut when its input channels differ from
``4·filters`` or its stride is not 1 (the fused lane's rule; the plain
JAX lane compares whole shapes, which differs only for a stride-2 stage
fed a 1×1 map).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models import lecun_normal_, register
from tony_tpu_torch.models.convert import conv_params_from_jax
from tony_tpu_torch.ops.batchnorm import fused_bn_act

Pads = Tuple[Tuple[int, int], Tuple[int, int]]

# BatchNorm's running-average momentum and epsilon, as the JAX ResNet
# sets them on both lanes.
MOMENTUM, EPSILON = 0.9, 1e-5


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: the output is
    ceil(size / s); the total padding splits low = total // 2, high = the
    rest (asymmetric, e.g. (0, 1) for a 3×3/s2 conv on an even input)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` over channels-last NCHW tensors: weight
    ``[O, I, kh, kw]`` f32 (flax's HWIO kernel transposed), cast with the
    input to ``dtype`` at use; ``padding`` is ``"SAME"`` or explicit
    ``((lo, hi), (lo, hi))``. Asymmetric padding runs as ``F.pad`` and an
    unpadded convolution."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 padding: Union[str, Pads] = "SAME", bias: bool = False,
                 dtype: Any = torch.float32, device=None):
        super().__init__()
        self.strides, self.padding, self.dtype = strides, padding, dtype
        self.weight = nn.Parameter(torch.empty(
            (cout, cin, *kernel), dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(cout, dtype=torch.float32,
                                              device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.weight.shape[2:]
        if self.padding == "SAME":
            pads = (_same_pads(x.shape[2], kh, self.strides[0]),
                    _same_pads(x.shape[3], kw, self.strides[1]))
        else:
            pads = self.padding
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        (t, btm), (lft, rgt) = pads
        if t == btm and lft == rgt:
            return F.conv2d(x, w, b, self.strides, (t, lft))
        return F.conv2d(F.pad(x, (lft, rgt, t, btm)), w, b, self.strides)


class Dense(nn.Linear):
    """flax ``nn.Dense`` in f32 (``dtype=param_dtype=float32``): weight
    ``[out, in]`` (the JAX kernel transposed)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight, self.bias)


def _chan(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _nhwc(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.permute(0, 2, 3, 1)


def _f32_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel batch mean and biased variance in f32 as
    ``E[x²] − E[x]²`` clamped at 0 (flax's ``use_fast_variance``)."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    return mean, torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                                 0.0)


class _BNBase(nn.Module):
    """Scale/bias parameters (f32) and mean/var running statistics (f32
    buffers) named as flax's ``params`` and ``batch_stats`` leaves."""

    def __init__(self, c: int, zero_scale: bool = False,
                 dtype: Any = torch.bfloat16, device=None):
        super().__init__()
        self.dtype, self.zero_scale = dtype, zero_scale
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(c, **f32))
        self.bias = nn.Parameter(torch.zeros(c, **f32))
        self.register_buffer("mean", torch.zeros(c, **f32))
        self.register_buffer("var", torch.ones(c, **f32))

    @torch.no_grad()
    def reset(self) -> None:
        (self.scale.zero_() if self.zero_scale else self.scale.fill_(1.0))
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.mean.copy_(MOMENTUM * self.mean + (1 - MOMENTUM) * mean.detach())
        self.var.copy_(MOMENTUM * self.var + (1 - MOMENTUM) * var.detach())


class BatchNorm(_BNBase):
    """flax ``nn.BatchNorm`` as the plain lane uses it: train mode takes
    f32 batch statistics (``use_fast_variance``: var = max(E[x²] −
    E[x]², 0)) and updates the running averages; eval reads them. The
    normalize is f32, ``(x − mean)·(rsqrt(var + eps)·scale) + bias``,
    then cast to ``dtype``."""

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if train:
            mean, var = _f32_stats(x)
            self._update(mean, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + EPSILON) * self.scale
        y = (x.float() - _chan(mean)) * _chan(mul) + _chan(self.bias)
        return y.to(self.dtype)


class FusedBNAct(_BNBase):
    """BatchNorm(+residual add)(+ReLU) on the fused kernels
    (:func:`~tony_tpu_torch.ops.batchnorm.fused_bn_act`), the
    counterpart of the JAX ``FusedBNAct``. Train mode runs the kernels on
    a CUDA tensor at every shape; on a CPU tensor, where the reference's
    tiling rule declines the shape, it takes the plain f32 statistics, as
    the reference does. Eval reads the running statistics. Outside the
    kernels the elementwise math runs in the compute dtype, as the
    reference's fallback."""

    def __init__(self, c: int, relu: bool = True, **kw):
        super().__init__(c, **kw)
        self.relu = relu

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                train: bool = True) -> torch.Tensor:
        fused = None
        if train:
            fused = fused_bn_act(_nhwc(x), self.scale, self.bias,
                                 _nhwc(residual), eps=EPSILON,
                                 relu=self.relu)
        if fused is not None:
            out, mean, var = fused
            out = out.permute(0, 3, 1, 2)
        else:
            mean, var = _f32_stats(x) if train else (self.mean, self.var)
            ct = self.dtype
            inv = torch.rsqrt(var + EPSILON) * self.scale
            out = ((x.to(ct) - _chan(mean.to(ct))) * _chan(inv.to(ct))
                   + _chan(self.bias.to(ct)))
            if residual is not None:
                out = out + residual.to(ct)
            if self.relu:
                out = torch.relu(out)
            out = out.to(x.dtype)
        if train:
            self._update(mean, var)
        return out


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1 bottleneck with a projection shortcut (v1.5: the
    stride sits on the 3×3); plain BatchNorm and ReLUs."""

    def __init__(self, cin: int, filters: int, strides: Tuple[int, int],
                 dtype: Any, device=None):
        super().__init__()
        conv = dict(dtype=dtype, device=device)
        norm = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(cin, filters, (1, 1), **conv)
        self.BatchNorm_0 = BatchNorm(filters, **norm)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, **conv)
        self.BatchNorm_1 = BatchNorm(filters, **norm)
        self.Conv_2 = Conv(filters, 4 * filters, (1, 1), **conv)
        self.BatchNorm_2 = BatchNorm(4 * filters, zero_scale=True, **norm)
        if cin != 4 * filters or strides != (1, 1):
            self.proj = Conv(cin, 4 * filters, (1, 1), strides, **conv)
            self.proj_bn = BatchNorm(4 * filters, **norm)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        residual = x
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        if hasattr(self, "proj"):
            residual = self.proj_bn(self.proj(x), train)
        return torch.relu(y + residual)


class FusedBottleneck(nn.Module):
    """The bottleneck over the fused kernels: each BN+ReLU is one fused
    op, and the block exit (zeros-init BN + residual add + ReLU) is one
    more."""

    def __init__(self, cin: int, filters: int, strides: Tuple[int, int],
                 dtype: Any, device=None):
        super().__init__()
        conv = dict(dtype=dtype, device=device)
        norm = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(cin, filters, (1, 1), **conv)
        self.FusedBNAct_0 = FusedBNAct(filters, **norm)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, **conv)
        self.FusedBNAct_1 = FusedBNAct(filters, **norm)
        self.Conv_2 = Conv(filters, 4 * filters, (1, 1), **conv)
        if cin != 4 * filters or strides != (1, 1):
            self.proj = Conv(cin, 4 * filters, (1, 1), strides, **conv)
            self.proj_bn = FusedBNAct(4 * filters, relu=False, **norm)
        self.FusedBNAct_2 = FusedBNAct(4 * filters, zero_scale=True, **norm)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        residual = x
        y = self.FusedBNAct_0(self.Conv_0(x), train=train)
        y = self.FusedBNAct_1(self.Conv_1(y), train=train)
        y = self.Conv_2(y)
        if hasattr(self, "proj"):
            residual = self.proj_bn(self.proj(x), train=train)
        return self.FusedBNAct_2(y, residual=residual, train=train)


class ResNet(nn.Module):
    """ResNet v1.5 over NHWC input; ``s2d_stem`` is the MLPerf
    space-to-depth stem (the 7×7/s2 conv as the equivalent 4×4/s1 conv on
    the 2×2-packed image, see :func:`s2d_stem_kernel`)."""

    # The JAX tree's converter, read by ``load_jax_params``.
    params_from_jax = staticmethod(conv_params_from_jax)

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, dtype: Any = torch.bfloat16,
                 fused_bn: bool = False, s2d_stem: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype, self.fused_bn, self.s2d_stem = dtype, fused_bn, s2d_stem
        conv = dict(dtype=dtype, device=dev)
        if s2d_stem:
            self.stem = Conv(12, width, (4, 4), (1, 1),
                             ((2, 1), (2, 1)), **conv)
        else:
            self.stem = Conv(3, width, (7, 7), (2, 2), ((3, 3), (3, 3)),
                             **conv)
        self.stem_bn = (FusedBNAct if fused_bn else BatchNorm)(
            width, dtype=dtype, device=dev)
        block_cls = FusedBottleneck if fused_bn else Bottleneck
        names = []
        cin = width
        for stage, size in enumerate(stage_sizes):
            for block in range(size):
                strides = (2, 2) if stage > 0 and block == 0 else (1, 1)
                filters = width * 2 ** stage
                name = f"{block_cls.__name__}_{len(names)}"
                self.add_module(name, block_cls(cin, filters, strides,
                                                dtype=dtype, device=dev))
                names.append(name)
                cin = 4 * filters
        self.block_names = tuple(names)
        self.Dense_0 = Dense(cin, num_classes, device=dev)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "ResNet":
        """flax's initializers from a seeded ``torch.Generator`` on the
        model's device: lecun-normal conv and Dense kernels (fan-in
        ``I·kh·kw``), zero biases, BatchNorm scale ones (zeros on each
        block's exit BN) and bias zeros, running mean 0 and var 1."""
        gen = torch.Generator(device=self.Dense_0.weight.device)
        gen.manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, (Conv, Dense)):
                lecun_normal_(mod.weight, gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, _BNBase):
                mod.reset()
        return self

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype).contiguous()
        if self.s2d_stem:
            n, h, w, c = x.shape
            x = x.reshape(n, h // 2, 2, w // 2, 2, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
        x = self.stem(x.permute(0, 3, 1, 2))        # channels_last NCHW
        if self.fused_bn:
            x = self.stem_bn(x, train=train)
        else:
            x = torch.relu(self.stem_bn(x, train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x, train=train)
        return self.Dense_0(x.mean(dim=(2, 3)))


def _build(stage_sizes, kw) -> ResNet:
    seed = kw.pop("seed", 0)
    return ResNet(stage_sizes, **kw).init_weights(seed)


@register("resnet50")
def resnet50(**kw) -> ResNet:
    """``fused_bn``, ``s2d_stem``, ``dtype``, ``num_classes``, ``width``
    as the JAX model; ``device=`` (default: the card) and ``seed=``
    (random weights)."""
    return _build((3, 4, 6, 3), kw)


@register("resnet18-thin")
def resnet18_thin(**kw) -> ResNet:
    """Small variant for tests: same code path, toy width and depth."""
    kw.setdefault("width", 8)
    kw.setdefault("num_classes", 10)
    return _build((1, 1), kw)


def s2d_stem_kernel(k7: torch.Tensor) -> torch.Tensor:
    """A flax ``[7, 7, Cin, Cout]`` stem kernel as the equivalent
    ``[4, 4, 4·Cin, Cout]`` space-to-depth kernel: packed tap (p, q, dr,
    dc) reads original tap (2p − 1 + dr, 2q − 1 + dc); the out-of-range
    taps are the zero padding that makes 7 → 8 taps exact."""
    cin, cout = k7.shape[2], k7.shape[3]
    k8 = k7.new_zeros((8, 8, cin, cout))
    k8[1:, 1:] = k7
    k4 = k8.reshape(4, 2, 4, 2, cin, cout).permute(0, 2, 1, 3, 4, 5)
    return k4.reshape(4, 4, 4 * cin, cout)


def resnet50_flops(batch: int, image: int = 224) -> int:
    """Analytic forward FLOPs (≈ 8.2 GFLOP per 224² image, training ≈ 3×
    forward), as the JAX package counts them for MFU."""
    per_image = 8.2e9 * (image / 224) ** 2
    return int(per_image * batch)
