"""MNIST nets: the counterparts of :class:`tony_tpu.models.mnist.MLP` and
:class:`tony_tpu.models.mnist.CNN`.

Three biased dense layers (``784 → hidden → hidden → classes``, ReLU
between), named ``Dense_0..2`` as the JAX module's param tree
(``Dense_i/kernel|bias``), so :func:`tony_tpu_torch.models.convert.load_jax_params`
carries its weights across. ``quant=True`` runs every layer on the
quantized lane (:class:`~tony_tpu_torch.ops.quant.QuantDense`, f32 out)
with the same parameter names and shapes: a checkpoint of either lane
loads into the other.

The CNN takes flat 784 or NHWC ``[N, 28, 28, 1]`` images: two 3×3
``"SAME"`` convolutions with bias (32, 64 channels), each followed by
ReLU and a 2×2 average pool, then ``Dense_0`` (256, ReLU) and
``Dense_1`` — all in f32, as the flax module with its default dtypes.
Inside, activations are channels-last NCHW; the flatten reads them in
NHWC order ``(h, w, c)``, as the JAX reshape does, so the converted
``Dense_0`` kernel needs no permutation.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models import lecun_normal_, register
from tony_tpu_torch.models.convert import (conv_params_from_jax,
                                           mlp_params_from_jax)
from tony_tpu_torch.models.resnet import Conv
from tony_tpu_torch.ops.quant import QuantDense


class MLP(nn.Module):
    # The JAX tree's converter, read by ``load_jax_params``.
    params_from_jax = staticmethod(mlp_params_from_jax)

    def __init__(self, hidden: int = 512, classes: int = 10,
                 quant: bool = False, in_features: int = 784,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        dev = resolve_device(device)
        self.quant = quant
        dims = ((in_features, hidden), (hidden, hidden), (hidden, classes))
        for i, (n_in, n_out) in enumerate(dims):
            layer = (QuantDense(n_in, n_out, bias=True, device=dev) if quant
                     else nn.Linear(n_in, n_out, device=dev))
            self.add_module(f"Dense_{i}", layer)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "MLP":
        """flax's ``nn.Dense`` defaults from a seeded ``torch.Generator``:
        lecun-normal kernels, zero biases."""
        dev = self.Dense_0.weight.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith(".weight"):
                lecun_normal_(p, gen)
            else:
                p.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class CNN(nn.Module):
    # The JAX tree's converter, read by ``load_jax_params``.
    params_from_jax = staticmethod(conv_params_from_jax)

    def __init__(self, classes: int = 10,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        dev = resolve_device(device)
        self.Conv_0 = Conv(1, 32, (3, 3), bias=True, device=dev)
        self.Conv_1 = Conv(32, 64, (3, 3), bias=True, device=dev)
        self.Dense_0 = nn.Linear(7 * 7 * 64, 256, device=dev)
        self.Dense_1 = nn.Linear(256, classes, device=dev)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "CNN":
        """flax's ``nn.Conv``/``nn.Dense`` defaults from a seeded
        ``torch.Generator``: lecun-normal kernels, zero biases."""
        dev = self.Dense_0.weight.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith(".weight"):
                lecun_normal_(p, gen)
            else:
                p.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:                    # flat 784 -> NHWC
            x = x.reshape(x.shape[0], 28, 28, 1)
        x = x.float().contiguous().permute(0, 3, 1, 2)
        x = F.avg_pool2d(torch.relu(self.Conv_0(x)), 2, 2)
        x = F.avg_pool2d(torch.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(self.Dense_0(x))
        return self.Dense_1(x)


@register("mnist-mlp")
def mnist_mlp(**kw) -> MLP:
    """``hidden``, ``classes``, ``quant`` as the JAX model; ``device=``
    (default: the card) and ``seed=`` (random weights)."""
    seed = kw.pop("seed", 0)
    return MLP(**kw).init_weights(seed)


@register("mnist-cnn")
def mnist_cnn(**kw) -> CNN:
    """``classes`` as the JAX model; ``device=`` (default: the card) and
    ``seed=`` (random weights)."""
    seed = kw.pop("seed", 0)
    return CNN(**kw).init_weights(seed)
