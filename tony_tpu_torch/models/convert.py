"""Carry the JAX package's weights into the port's modules: the decoder
and the MNIST MLP.

The input is the JAX package's param tree as a nested dict of **numpy**
arrays (``jax.tree.map(np.asarray, params)`` on the JAX side — this
module never imports jax). Both of its layouts are read:

* scanned (``scan_layers=True``, remat or not): ``layers/block/...``
  with a leading layer axis, e.g. ``layers/block/attn/wq/kernel`` of
  shape ``[L, dim, n_heads·head_dim]``;
* unscanned: ``layer_{i}/block/...``.

The MNIST MLP's tree is ``Dense_i/kernel`` and ``Dense_i/bias`` on both
of its lanes.

flax's Dense kernels are ``[in, out]``; torch's ``nn.Linear`` weights
are ``[out, in]``, so every kernel is transposed. The quantized lanes
keep the same paths (``QuantDense`` is ``nn.Dense``'s twin), so one
converter serves both lanes of each model. bfloat16 arrays
(ml_dtypes, which ``torch.from_numpy`` rejects) cross through a
``uint16`` view.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_BLOCK_LEAVES = {
    ("attn_norm", "scale"): "attn_norm.scale",
    ("attn", "wq", "kernel"): "attn.wq.weight",
    ("attn", "wk", "kernel"): "attn.wk.weight",
    ("attn", "wv", "kernel"): "attn.wv.weight",
    ("attn", "wo", "kernel"): "attn.wo.weight",
    ("mlp_norm", "scale"): "mlp_norm.scale",
    ("mlp", "w_gate", "kernel"): "mlp.w_gate.weight",
    ("mlp", "w_up", "kernel"): "mlp.w_up.weight",
    ("mlp", "w_down", "kernel"): "mlp.w_down.weight",
}


def _tensor(arr: Any) -> torch.Tensor:
    arr = np.array(arr)     # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _get(tree: Mapping[str, Any], path) -> Any:
    node = tree
    for key in path:
        if key not in node:
            raise KeyError(f"JAX param tree lacks {'/'.join(path)}")
        node = node[key]
    return node


def _block_params(block: Mapping[str, Any], index=None
                  ) -> Dict[str, torch.Tensor]:
    out = {}
    for path, name in _BLOCK_LEAVES.items():
        arr = _get(block, path)
        if index is not None:
            arr = arr[index]
        t = _tensor(arr)
        out[name] = t.t() if path[-1] == "kernel" else t
    return out


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` names → CPU tensors (kernels transposed
    to ``[out, in]``) from a JAX decoder param tree of numpy arrays."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {
        "embedding": _tensor(_get(tree, ("embedding",))),
        "final_norm.scale": _tensor(_get(tree, ("final_norm", "scale"))),
        "lm_head.weight": _tensor(_get(tree, ("lm_head", "kernel"))).t(),
    }
    if "layers" in tree:
        block = _get(tree, ("layers", "block"))
        n_layers = np.shape(_get(block, ("attn", "wq", "kernel")))[0]
        layers = [_block_params(block, i) for i in range(n_layers)]
    else:
        layers = []
        while f"layer_{len(layers)}" in tree:
            layers.append(_block_params(
                _get(tree, (f"layer_{len(layers)}", "block"))))
    for i, params in enumerate(layers):
        for name, t in params.items():
            out[f"layers.{i}.{name}"] = t
    return out


def mlp_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The MNIST MLP's ``state_dict`` names → CPU tensors from its JAX tree
    (``Dense_i/kernel`` ``[in, out]`` → ``Dense_i.weight`` ``[out, in]``,
    ``Dense_i/bias``)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for name in sorted(tree):
        out[f"{name}.weight"] = _tensor(_get(tree, (name, "kernel"))).t()
        out[f"{name}.bias"] = _tensor(_get(tree, (name, "bias")))
    return out


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Fill ``model`` in place from a JAX param tree of numpy arrays,
    through the tree converter the model names as its
    ``params_from_jax`` (the decoder's :func:`params_from_jax`, the MNIST
    MLP's :func:`mlp_params_from_jax`), casting to each parameter's
    storage dtype and device: an f32 tree lands bitwise in the default
    f32 parameters (training), and a server built with
    ``param_dtype=cfg.dtype`` gets the one cast that the JAX module makes
    at every use. Every parameter must be covered and every converted
    leaf used, with equal shapes."""
    convert = getattr(model, "params_from_jax", None)
    if convert is None:
        raise TypeError(f"{type(model).__name__} names no JAX tree "
                        f"converter (params_from_jax)")
    src = convert(tree)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(src))
    extra = sorted(set(src) - set(params))
    if missing or extra:
        raise ValueError(f"JAX params do not match the model: missing "
                         f"{missing[:4]}, unexpected {extra[:4]}")
    for name, p in params.items():
        t = src[name]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {tuple(t.shape)} vs "
                             f"model {tuple(p.shape)}")
        p.copy_(t.to(device=p.device, dtype=p.dtype))
    return model
