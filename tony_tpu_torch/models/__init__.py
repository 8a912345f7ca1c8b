"""Model zoo of the port: the counterpart of :mod:`tony_tpu.models`.

Only the Llama-style decoder is ported so far
(:mod:`~tony_tpu_torch.models.transformer`: its training and serving
forwards), registered as ``llama2-7b`` and ``llama-tiny`` with the JAX
package's defaults. Models are ``torch.nn.Module``s built on an explicit
device (``None`` = the card).
"""

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_model(name: str, **kw):
    """Build a registered model by name (``llama2-7b``, ``llama-tiny``)."""
    # Import for registration side effects.
    from tony_tpu_torch.models import transformer  # noqa: F401
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)
