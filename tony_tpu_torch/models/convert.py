"""Carry the JAX package's weights into the port's modules: the decoder,
the MNIST MLP, and the convolutional nets (ResNet, the MNIST CNN).

The input is the JAX package's param tree as a nested dict of **numpy**
arrays (``jax.tree.map(np.asarray, params)`` on the JAX side — this
module never imports jax). Both of its layouts are read:

* scanned (``scan_layers=True``, remat or not): ``layers/block/...``
  with a leading layer axis, e.g. ``layers/block/attn/wq/kernel`` of
  shape ``[L, dim, n_heads·head_dim]``;
* unscanned: ``layer_{i}/block/...``.

The MNIST MLP's tree is ``Dense_i/kernel`` and ``Dense_i/bias`` on both
of its lanes. The convolutional nets take the whole variables dict,
``{"params": ..., "batch_stats": ...}`` (or a params tree alone): every
path keeps its flax module names (``Bottleneck_0/Conv_1/kernel`` →
``Bottleneck_0.Conv_1.weight``), conv kernels go from flax's HWIO to
torch's OIHW, and ``batch_stats`` leaves (``mean``, ``var``) land in the
BatchNorm buffers of the same name. The names are the model's own, so
one converter serves the plain and the fused BatchNorm lanes.

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
    to ``[out, in]``) from a JAX decoder param tree of numpy arrays, with
    the head at ``lm_head/kernel`` or, from an ``xent_chunk`` model, at
    ``lm_head_kernel``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    # A model with xent_chunk hoists the head kernel to "lm_head_kernel"
    # ([dim, vocab], as lm_head/kernel); the port keeps one lm_head.
    head = ("lm_head_kernel",) if "lm_head_kernel" in tree \
        else ("lm_head", "kernel")
    out: Dict[str, torch.Tensor] = {
        "embedding": _tensor(_get(tree, ("embedding",))),
        "final_norm.scale": _tensor(_get(tree, ("final_norm", "scale"))),
        "lm_head.weight": _tensor(_get(tree, head)).t(),
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


def conv_params_from_jax(tree: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """A convolutional net's ``state_dict`` names → CPU tensors from its
    JAX variables (``{"params", "batch_stats"}``, or params alone): the
    flax path joined by dots, ``kernel`` → ``weight`` (4-D HWIO → OIHW,
    2-D ``[in, out]`` → ``[out, in]``), ``bias``/``scale`` and the
    ``mean``/``var`` statistics as they are."""
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        trees = [tree["params"], tree.get("batch_stats", {})]
    else:
        trees = [tree]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key in sorted(node):
            val = node[key]
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
                continue
            t = _tensor(val)
            if key == "kernel":
                t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
                key = "weight"
            out[f"{prefix}{key}"] = t

    for sub in trees:
        walk(sub, "")
    return out


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Fill ``model`` in place from a JAX param tree of numpy arrays,
    through the tree converter the model names as its
    ``params_from_jax`` (the decoder's :func:`params_from_jax`, the MNIST
    MLP's :func:`mlp_params_from_jax`, the conv nets'
    :func:`conv_params_from_jax`), casting to each parameter's storage
    dtype and device: an f32 tree lands bitwise in the default f32
    parameters (training), and a server built with
    ``param_dtype=cfg.dtype`` gets the one cast that the JAX module makes
    at every use. Every parameter must be covered and every converted
    leaf used, with equal shapes; converted leaves that name a buffer
    (BatchNorm running statistics) fill it."""
    convert = getattr(model, "params_from_jax", None)
    if convert is None:
        raise TypeError(f"{type(model).__name__} names no JAX tree "
                        f"converter (params_from_jax)")
    src = convert(tree)
    params = dict(model.named_parameters())
    targets = {**dict(model.named_buffers()), **params}
    missing = sorted(set(params) - set(src))
    extra = sorted(set(src) - set(targets))
    if missing or extra:
        raise ValueError(f"JAX params do not match the model: missing "
                         f"{missing[:4]}, unexpected {extra[:4]}")
    for name, t in src.items():
        p = targets[name]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {tuple(t.shape)} vs "
                             f"model {tuple(p.shape)}")
        p.copy_(t.to(device=p.device, dtype=p.dtype))
    return model
