"""Parallelism plane of the port: the counterpart of
:mod:`tony_tpu.parallel`.

* :class:`MeshSpec` / :class:`Mesh` — the data axis of the reference's
  mesh over ``torch.distributed``'s default process group, one rank per
  device: ``MeshSpec(dp=0).build()`` spans the whole world. The other
  axes keep their names (:data:`AXES`) at size 1; asking for one of them
  raises ``NotImplementedError`` (ROADMAP.md, queue 1 item 8).
* the gradient-bucket planner and microbatch accumulation of
  :mod:`~tony_tpu_torch.parallel.overlap` (:class:`GradBuckets`,
  :func:`microbatch_grads`), which the train steps run on; the
  data-parallel step all-reduces one bucket of its plan at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as td

from tony_tpu_torch import resolve_device
from tony_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_BYTES,
                                             GradBuckets, ResidentBuckets,
                                             microbatch_grads)

__all__ = ["AXES", "BATCH_AXES", "DATA", "DEFAULT_BUCKET_BYTES",
           "GradBuckets", "Mesh", "MeshSpec", "ResidentBuckets", "SEQ",
           "microbatch_grads"]

# The reference's axis names, outermost to innermost.
SLICE, DATA, FSDP, PIPE, EXPERT, SEQ, MODEL = (
    "slice", "data", "fsdp", "pipe", "expert", "seq", "model")
AXES: Tuple[str, ...] = (SLICE, DATA, FSDP, PIPE, EXPERT, SEQ, MODEL)
# The axes an input batch's leading dim is sharded over.
BATCH_AXES: Tuple[str, ...] = (SLICE, DATA, FSDP)

_LATER = "ROADMAP.md, queue 1 item 8"


@dataclasses.dataclass(eq=False)
class Mesh:
    """A device mesh over the default process group, one rank per device.

    ``shape`` maps every name of :data:`AXES` to its size, ``processes``
    is the number of ranks that hold its devices and ``device`` this
    rank's device. Compared and hashed by identity, as a mesh object is a
    cache key."""
    shape: Dict[str, int]
    processes: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """One parallelism layout; only the data axis is ported. ``dp=0``
    resolves to the world size."""
    dp: int = 0
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    slices: int = 1

    def build(self, device: Optional[Union[str, torch.device]] = None
              ) -> Mesh:
        """The mesh over the default process group (brought up by
        :func:`tony_tpu_torch.distributed.initialize` or
        ``init_process_group``). ``device=None`` is this rank's current
        card and raises without a GPU; pass ``device="cpu"`` for gloo."""
        for axis in ("fsdp", "pp", "ep", "sp", "tp", "slices"):
            if getattr(self, axis) > 1:
                raise NotImplementedError(
                    f"MeshSpec({axis}={getattr(self, axis)}): only the data "
                    f"axis is ported ({_LATER})")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if not td.is_initialized():
            raise RuntimeError(
                "MeshSpec.build needs torch.distributed's default process "
                "group: call tony_tpu_torch.distributed.initialize() (or "
                "init_process_group) first")
        if td.get_backend() == "nccl" and dev.type != "cuda":
            raise ValueError(f"an NCCL process group cannot reduce tensors "
                             f"on {dev}")
        world = td.get_world_size()
        dp = self.dp or world
        if dp != world:
            raise ValueError(f"mesh shape {{'data': {dp}}} needs {dp} "
                             f"devices, have {world} (one rank per device)")
        shape = dict.fromkeys(AXES, 1)
        shape[DATA] = dp
        return Mesh(shape=shape, processes=world, device=dev)
