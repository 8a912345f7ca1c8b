"""Where a tensor of a sharded state lies in its global array: the port's
counterpart of a ``jax.Array``'s committed sharding.

A ZeRO-3 state keeps, on each rank, only that rank's slice of every
fsdp-sharded parameter (and of its optimizer slots), an expert mesh its
experts, a tensor-parallel mesh its ``model`` shard of each column- or
row-parallel weight; the tensor itself has the slice's shape. Its
:class:`Layout`, attached to the tensor object, says which slice: the
global shape, the spec (one entry per dim, as
:func:`~tony_tpu_torch.parallel.logical_spec` gives it), the sharded dim
and the slice's offset on it, and the rank's replica index: on the data
axis, or on a tensor-parallel mesh over the data and seq axes (the
ranks that hold the same shard; replica 0 writes the slice in a
checkpoint, the reference's ``replica_id == 0`` rule). A pipeline
stage's layer is one index of its stacked ``[L, ...]`` leaf: its layout
has the leaf's shape, spec ``("pipe", ...)`` and ``start`` the layer's
index on dim 0, which the tensor drops (:attr:`Layout.stage_layer`).
The train step detects a ZeRO-3 state from these layouts, and the
checkpoint plane saves and restores each slice at its extent.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

_ATTR = "_tony_layout"


@dataclasses.dataclass(frozen=True)
class Layout:
    """``shape`` and ``spec`` are the global array's (torch layout);
    ``dim`` is the dim this tensor slices (None: the tensor is whole,
    replicated on every rank) and ``start`` the slice's offset on it;
    ``replica`` is the rank's index among the ranks that hold the same
    slice (the data axis; the data and seq axes on a tensor-parallel
    mesh)."""
    shape: Tuple[int, ...]
    spec: Tuple[Any, ...]
    dim: Optional[int] = None
    start: int = 0
    replica: int = 0

    @property
    def sharded(self) -> bool:
        return self.dim is not None

    @property
    def stage_layer(self) -> bool:
        """A pipeline stage's layer: the tensor is index ``start`` of the
        stacked leaf's dim 0 (over ``pipe``), that dim dropped."""
        return self.dim == 0 and bool(self.spec) and self.spec[0] == "pipe"

    def offsets(self) -> Tuple[int, ...]:
        """The slice's start in every dim of the global array."""
        return tuple(self.start if d == self.dim else 0
                     for d in range(len(self.shape)))


def layout_of(t: Any) -> Optional[Layout]:
    """The layout attached to ``t`` (None for a tensor of an unsharded
    state)."""
    return getattr(t, _ATTR, None)


def set_layout(t: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """Attach ``layout`` to ``t`` (None removes it); returns ``t``."""
    if layout is None:
        if hasattr(t, _ATTR):
            delattr(t, _ATTR)
    else:
        setattr(t, _ATTR, layout)
    return t
