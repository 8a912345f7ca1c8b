"""MNIST MLP: the counterpart of :class:`tony_tpu.models.mnist.MLP`.

Three biased dense layers (``784 → hidden → hidden → classes``, ReLU
between), named ``Dense_0..2`` as the JAX module's param tree
(``Dense_i/kernel|bias``), so :func:`tony_tpu_torch.models.convert.load_jax_params`
carries its weights across. ``quant=True`` runs every layer on the
quantized lane (:class:`~tony_tpu_torch.ops.quant.QuantDense`, f32 out)
with the same parameter names and shapes: a checkpoint of either lane
loads into the other. The JAX package's ``CNN`` waits for the
convolution slice (ROADMAP.md, queue 1 item 7).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tony_tpu_torch import resolve_device
from tony_tpu_torch.models import lecun_normal_, register
from tony_tpu_torch.models.convert import mlp_params_from_jax
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


@register("mnist-mlp")
def mnist_mlp(**kw) -> MLP:
    """``hidden``, ``classes``, ``quant`` as the JAX model; ``device=``
    (default: the card) and ``seed=`` (random weights)."""
    seed = kw.pop("seed", 0)
    return MLP(**kw).init_weights(seed)
