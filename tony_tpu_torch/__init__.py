"""PyTorch/CUDA port of the TonY-TPU compute plane.

The JAX package :mod:`tony_tpu` is the reference; this package holds its
counterparts module for module (``ops/attention.py``,
``ops/batchnorm.py``, ``ops/fused_optim.py``, ``ops/quant.py``,
``models/transformer.py``, ``models/resnet.py``, ``models/mnist.py``,
``parallel/__init__.py``, ``parallel/overlap.py``, ``train/__init__.py``,
``serve/kvcache.py``, ``serve/engine.py``, ``distributed.py``,
``profiler.py``, and copies of the parts of ``constants.py`` and
``chaos.py`` the train loop reads) in
PyTorch, with every Pallas kernel on a ported path rewritten by hand in
CUDA C++ for Hopper (``ops/csrc/``). It imports torch and numpy only —
never jax, flax, optax or anything of :mod:`tony_tpu`.

Entry points run on the card: a ``device=None`` argument resolves to
``"cuda"`` and raises when no GPU is present. Tests and CPU callers pass
``device="cpu"`` explicitly, and every kernel wrapper then runs its plain
PyTorch version because the tensors it was given lie on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    A CUDA device (explicit or defaulted) with no GPU present raises
    ``RuntimeError`` instead of quietly running on the CPU — a serving
    process that lost its card must fail loudly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev
