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

The other way, :func:`jax_param_tree` views the port's tensors as the
JAX package's param tree — its paths, shapes and layout, without a copy
(:class:`~tony_tpu_torch.ckpt.snapshot.LeafView`): the decoder's
scanned leaves stacked over layers (``layer_{i}`` without
``scan_layers``), kernels ``[in, out]``, the head at ``lm_head_kernel``
with ``xent_chunk``; the MNIST MLP's ``Dense_i/kernel`` ``[in, out]``;
the conv nets' flax paths with HWIO conv kernels (a permuted view of
the OIHW weight), each BatchNorm lane under its own module names.
:func:`portable_state` wraps a train state's views as the reference's
``TrainState`` (``.step``, ``.params``, ``.opt_state``, and
``.batch_stats`` for a model with BatchNorm statistics): the form its
checkpoints carry.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from tony_tpu_torch.ckpt.snapshot import Attrs, LeafView

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


# flax's HWIO conv kernel as a view of torch's OIHW weight.
_HWIO = (2, 3, 1, 0)


def _put(tree: Dict[str, Any], path: Sequence[str], leaf: Any) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = leaf


def conv_params_to_jax(cfg: Any, tensors: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """The inverse of :func:`conv_params_from_jax` for one collection:
    the flax tree over ``tensors`` (parameters, one optimizer slot per
    parameter, or the BatchNorm buffers), the dotted names split into
    flax's path, ``weight`` as ``kernel`` (4-D OIHW as an HWIO view, 2-D
    ``[out, in]`` transposed), everything else as it is. The names are
    the model's own, so each BatchNorm lane writes its own JAX lane's
    paths. ``cfg`` is unused."""
    del cfg
    tree: Dict[str, Any] = {}
    for name, t in tensors.items():
        path = name.split(".")
        if path[-1] == "weight":
            path[-1] = "kernel"
            t = LeafView.of(t, perm=_HWIO) if t.dim() == 4 \
                else LeafView.of(t, transpose=True)
        _put(tree, path, t)
    return tree


# The inverse of :func:`mlp_params_from_jax`: the MLP's tree is a conv
# net's without convolutions (``Dense_i/kernel`` ``[in, out]``, ``bias``).
mlp_params_to_jax = conv_params_to_jax


def params_to_jax(cfg: Any, tensors: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: the JAX decoder's param
    tree over ``tensors`` (``state_dict`` names → tensors: the parameters,
    or one optimizer moment per parameter), as leaf views
    (:class:`LeafView`) and tensors that alias them."""
    head = LeafView.of(tensors["lm_head.weight"], transpose=True)
    tree: Dict[str, Any] = {
        "embedding": tensors["embedding"],
        "final_norm": {"scale": tensors["final_norm.scale"]}}
    if cfg.xent_chunk:
        tree["lm_head_kernel"] = head
    else:
        tree["lm_head"] = {"kernel": head}

    if cfg.scan_layers:
        block: Dict[str, Any] = {}
        for path, name in _BLOCK_LEAVES.items():
            _put(block, path, LeafView.stacked(
                [tensors[f"layers.{i}.{name}"] for i in range(cfg.n_layers)],
                transpose=path[-1] == "kernel"))
        tree["layers"] = {"block": block}
        return tree
    for i in range(cfg.n_layers):
        block = {}
        for path, name in _BLOCK_LEAVES.items():
            t = tensors[f"layers.{i}.{name}"]
            _put(block, path, LeafView.of(t, transpose=True)
                 if path[-1] == "kernel" else t)
        tree[f"layer_{i}"] = {"block": block}
    return tree


def jax_param_tree(model: nn.Module,
                   tensors: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Dict[str, Any]:
    """``model``'s parameters (or ``tensors``, one per parameter name) as
    the JAX package's param tree of the same model, through the layout the
    model names as its ``params_to_jax``. A model that names none raises
    ``NotImplementedError``: its portable form is not ported yet."""
    layout = getattr(model, "params_to_jax", None)
    if layout is None:
        raise NotImplementedError(
            f"{type(model).__name__} names no JAX param layout "
            f"(params_to_jax): its checkpoint form is not ported yet "
            f"(ROADMAP.md, queue 1 item 3)")
    if tensors is None:
        tensors = dict(model.named_parameters())
    return layout(getattr(model, "cfg", None), tensors)


def jax_batch_stats(model: nn.Module) -> Optional[Dict[str, Any]]:
    """``model``'s BatchNorm running statistics as the JAX model's
    ``batch_stats`` collection (``.../mean``, ``.../var``, f32, the live
    buffers), through the layout the model names as its
    ``batch_stats_to_jax``; None for a model without."""
    layout = getattr(model, "batch_stats_to_jax", None)
    if layout is None:
        return None
    return layout(None, dict(model.named_buffers()))


class PortableState(Attrs):
    """The portable form of a port train state: the reference
    ``TrainState``'s ``.step`` (an int64 scalar), ``.params`` and
    ``.opt_state`` over views of the live tensors, and a model's
    ``.batch_stats`` beside them (the flax ``TrainState`` with
    ``batch_stats`` a BatchNorm net trains in, the carry of the
    reference's ``resnet_window``); ``live`` is the state it views, which
    a codec's decode writes the restored scalars back into."""
    live: Any


def portable_state(state: Any, opt_state: Any) -> PortableState:
    """``state`` as the reference's ``TrainState`` tree, with the
    optimizer's portable tree ``opt_state``."""
    tree = PortableState(
        step=torch.tensor(state.step, dtype=torch.int64),
        params=jax_param_tree(state.model), opt_state=opt_state)
    stats = jax_batch_stats(state.model)
    if stats is not None:
        tree["batch_stats"] = stats
    tree.live = state
    return tree


def _field(tree: Any, name: str) -> Any:
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _load_opt_state(model: nn.Module, state: Any, tree: Any) -> None:
    """Moments, count and step of a JAX train state's numpy tree into the
    port's ``state``: optax adamw's ``(ScaleByAdamState, ...)`` into an
    ``AdamState``, optax sgd's ``(TraceState, EmptyState)`` (or two
    empty states without momentum) into a ``TraceState``, or the fused
    optimizer's portable ``{"count", "leaf"}`` into its bucket-resident
    slots, in place."""
    names = [n for n, _ in model.named_parameters()]
    opt = _field(tree, "opt_state")
    live = state.opt_state
    if isinstance(live, dict) and "slots" in live:
        leaf = _field(opt, "leaf")
        plan = state.buckets.plan
        for slot, bufs in live["slots"].items():
            src = model.params_from_jax(_field(leaf, slot))
            for name, view in zip(names, plan.unpack(bufs)):
                view.copy_(src[name].to(view.device, view.dtype))
        live["count"] = int(np.asarray(_field(opt, "count")))
    elif hasattr(live, "mu") and hasattr(live, "nu"):
        adam = opt[0]
        for slot in ("mu", "nu"):
            src = model.params_from_jax(_field(adam, slot))
            for name, t in zip(names, getattr(live, slot)):
                t.copy_(src[name].to(t.device, t.dtype))
        live.count = int(np.asarray(_field(adam, "count")))
    elif hasattr(live, "trace"):
        if live.trace is not None:
            src = model.params_from_jax(_field(opt[0], "trace"))
            for name, t in zip(names, live.trace):
                t.copy_(src[name].to(t.device, t.dtype))
    else:
        raise NotImplementedError(
            f"loading a JAX optimizer state into "
            f"{type(live).__name__} is not ported (ROADMAP.md, queue 1 "
            f"item 3)")
    state.step = int(np.asarray(_field(tree, "step")))


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: Any,
                    state: Optional[Any] = None) -> nn.Module:
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
    (BatchNorm running statistics) fill it.

    With ``state`` (a port train state over ``model``), ``tree`` is a JAX
    train state's numpy tree (``.step``, ``.params``, ``.opt_state``, and
    ``.batch_stats`` where the model has BatchNorm statistics) and its
    moments, count and step fill ``state`` too: optax adamw's into an
    ``AdamState``, optax sgd's trace into a ``TraceState``, the fused
    optimizer's portable form into the bucket slots."""
    convert = getattr(model, "params_from_jax", None)
    if convert is None:
        raise TypeError(f"{type(model).__name__} names no JAX tree "
                        f"converter (params_from_jax)")
    if state is not None:
        _load_opt_state(model, state, tree)
        stats = tree.get("batch_stats") if isinstance(tree, Mapping) \
            else getattr(tree, "batch_stats", None)
        tree = _field(tree, "params")
        if stats is not None:
            tree = {"params": tree, "batch_stats": stats}
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
