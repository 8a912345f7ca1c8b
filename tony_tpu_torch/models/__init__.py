"""Model zoo of the port: the counterpart of :mod:`tony_tpu.models`.

Ported so far: the Llama-style decoder
(:mod:`~tony_tpu_torch.models.transformer`: its training and serving
forwards), registered as ``llama2-7b`` and ``llama-tiny`` with the JAX
package's defaults, and its mixture-of-experts form (training only, as
in the reference; the layer is :mod:`~tony_tpu_torch.models.moe`),
``mixtral-8x7b`` and ``llama-moe-tiny``; ResNet v1.5 with its plain and fused BatchNorm lanes
(:mod:`~tony_tpu_torch.models.resnet`, ``resnet50`` and
``resnet18-thin``); and the MNIST MLP and CNN
(:mod:`~tony_tpu_torch.models.mnist`, ``mnist-mlp`` and ``mnist-cnn``).
Models are ``torch.nn.Module``s built on an explicit device (``None`` =
the card).
"""

import math
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def lecun_normal_(w: torch.Tensor, gen: torch.Generator,
                  fan_in: Optional[int] = None) -> None:
    """flax's ``lecun_normal``: truncated normal on [-2σ, 2σ] with
    variance 1/fan_in (σ corrected for the truncation), drawn in f32 and
    cast. ``w`` is torch's ``[out, in]`` or ``[out, in, kh, kw]``, so
    fan_in defaults to ``w[0].numel()`` (``in``, or ``in·kh·kw`` as flax
    counts a conv kernel's receptive field); a weight kept in flax's
    layout passes its own."""
    std = math.sqrt(1.0 / (fan_in or w[0].numel())) / 0.87962566103423978
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    nn.init.trunc_normal_(tmp, std=std, a=-2 * std, b=2 * std,
                          generator=gen)
    w.copy_(tmp)


def get_model(name: str, **kw):
    """Build a registered model by name (``llama2-7b``, ``llama-tiny``,
    ``mixtral-8x7b``, ``llama-moe-tiny``, ``resnet50``,
    ``resnet18-thin``, ``mnist-mlp``, ``mnist-cnn``)."""
    # Import for registration side effects.
    from tony_tpu_torch.models import mnist, resnet, transformer  # noqa: F401
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)
