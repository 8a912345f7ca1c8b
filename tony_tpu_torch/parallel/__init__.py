"""Parallelism plane of the port: the counterpart of
:mod:`tony_tpu.parallel`.

* :class:`MeshSpec` / :class:`Mesh` — the reference's mesh over
  ``torch.distributed``'s default process group, one rank per device,
  ranks laid out as the reference's ``build`` lays out devices
  (``slices, dp, fsdp, pp, ep, sp, tp``, the last axis fastest). The
  data, fsdp and expert axes are ported: ``MeshSpec(dp=0, fsdp=N)`` or
  ``MeshSpec(dp=0, ep=N)`` spans the whole world, and the mesh carries
  one process group per axis of size > 1 (an axis that spans the world
  uses the default group). The batch is sharded over the data axes
  alone (:data:`BATCH_AXES`), so the ranks along ``expert`` hold the
  same rows, as in the reference. The sequence and tensor axes are
  ported too: ``MeshSpec(dp=, sp=, tp=)`` adds the ``seq`` group (ring
  attention, :mod:`~tony_tpu_torch.parallel.ring_attention`), the
  ``model`` group (the decoder's Megatron shards,
  :mod:`~tony_tpu_torch.parallel.tensor`) and the ``(data, seq)``
  gradient-sync group; ``model`` is innermost, so tp neighbours are
  adjacent ranks. The pipeline axis is ported beside data parallelism:
  ``MeshSpec(dp=, pp=)`` adds the ``pipe`` group, over which the stages
  of :mod:`~tony_tpu_torch.parallel.pipeline` send their microbatches;
  the ranks along ``pipe`` read the same batch block. ``ep`` beside
  ``fsdp``, ``tp`` or ``sp`` beside ``fsdp`` or ``ep``, and ``pp`` beside
  any of ``fsdp``, ``ep``, ``sp`` and ``tp``, raise
  ``NotImplementedError`` (ROADMAP.md, queue 1 item 11). The slice axis
  keeps its name (:data:`AXES`) at size 1; asking for it raises
  ``NotImplementedError`` (ROADMAP.md, queue 1 item 8).
* :data:`RULES` and :func:`logical_spec` — the logical-axis → mesh-axis
  lookup, as data: a spec is a tuple with one entry per dim (``None``,
  an axis name or a tuple of names), what a ``PartitionSpec`` is to the
  reference. There are no NamedShardings: a ZeRO-3 parameter carries its
  global shape and spec (:class:`~tony_tpu_torch.parallel.layout.Layout`).
* the gradient-bucket planner and microbatch accumulation of
  :mod:`~tony_tpu_torch.parallel.overlap` (:class:`GradBuckets`,
  :func:`microbatch_grads`, :func:`fsdp_param_specs`) and the forward
  gather scheduler of :mod:`~tony_tpu_torch.parallel.sched`
  (:class:`~tony_tpu_torch.parallel.sched.GatherPlan`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as td

from tony_tpu_torch import resolve_device

# The reference's axis names, outermost to innermost.
SLICE, DATA, FSDP, PIPE, EXPERT, SEQ, MODEL = (
    "slice", "data", "fsdp", "pipe", "expert", "seq", "model")
AXES: Tuple[str, ...] = (SLICE, DATA, FSDP, PIPE, EXPERT, SEQ, MODEL)
# The axes an input batch's leading dim is sharded over (the reference's
# ``batch_sharding``).
BATCH_AXES: Tuple[str, ...] = (SLICE, DATA, FSDP)

# Logical-axis → mesh-axis rules (a copy of the reference's): weights
# shard over fsdp on their "embed"-like dim and over model on their
# "heads/ffn/vocab"-like dim; activations' batch over the DP axes.
RULES: Tuple[Tuple[str, object], ...] = (
    ("batch", (SLICE, DATA, FSDP)),
    ("act_seq", SEQ),
    ("act_embed", None),
    ("act_heads", MODEL),
    ("embed", FSDP),
    ("heads", MODEL),
    ("kv_heads", MODEL),
    ("ffn", MODEL),
    ("vocab", MODEL),
    ("expert", EXPERT),
    ("expert_dim", None),
    ("stage", None),
    ("norm", None),
)

# MeshSpec field → (mesh axis, the ROADMAP item that ports it).
_UNPORTED = {"slices": (SLICE, 8)}


def logical_spec(*logical_axes: Optional[str],
                 allow_unknown: bool = False) -> Tuple[Any, ...]:
    """The spec of an array whose dims carry the given logical axis names
    (None = unsharded dim), resolved through :data:`RULES`: the
    reference's ``logical_sharding`` without the mesh. Unknown names
    raise (a typo must not silently replicate a dim); ``allow_unknown``
    leaves them unsharded deliberately."""
    table = dict(RULES)
    spec = []
    for ax in logical_axes:
        if ax is None:
            spec.append(None)
        elif ax in table:
            spec.append(table[ax])
        elif allow_unknown:
            spec.append(None)
        else:
            raise ValueError(
                f"unknown logical axis {ax!r}: not in RULES "
                f"({sorted(table)}); pass allow_unknown=True to leave it "
                f"unsharded deliberately")
    return tuple(spec)


@dataclasses.dataclass(eq=False)
class Mesh:
    """A device mesh over the default process group, one rank per device.

    ``shape`` maps every name of :data:`AXES` to its size, ``processes``
    is the number of ranks that hold its devices, ``device`` this rank's
    device and ``rank`` its rank; ``groups`` holds, for each tuple of
    axes a collective runs over, the process group of this rank's
    members along them (``None`` is the default group, the whole world).
    Compared and hashed by identity, as a mesh object is a cache key."""
    shape: Dict[str, int]
    processes: int
    device: torch.device
    rank: int = 0
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Each axis's index of ``rank`` (default: this rank)."""
        rest = self.rank if rank is None else rank
        out: Dict[str, int] = {}
        for axis in reversed(AXES):
            out[axis] = rest % self.shape[axis]
            rest //= self.shape[axis]
        return {a: out[a] for a in AXES}

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def group(self, axes: Sequence[str]) -> Any:
        """The process group of this rank's members along ``axes`` (its
        size-1 axes dropped); ``None``, the default group, when they span
        the world. Raises when the mesh made no such group."""
        key = tuple(a for a in AXES if a in axes and self.shape[a] > 1)
        if self.size(key) == self.processes:
            return None
        if key not in self.groups:
            raise KeyError(f"the mesh has no process group over {key}")
        return self.groups[key]

    def peer(self, axis: str, offset: int) -> int:
        """The global rank ``offset`` steps along ``axis`` from this rank
        (cyclic): the ring's neighbours are ``peer(SEQ, ±1)``."""
        coords = self.coords()
        coords[axis] = (coords[axis] + offset) % self.shape[axis]
        return self.index(AXES, coords)

    def index(self, axes: Sequence[str],
              coords: Optional[Dict[str, int]] = None) -> int:
        """The linear index of ``coords`` (default: this rank's) over
        ``axes``, the first outermost: over :data:`AXES` it is the rank."""
        coords = self.coords() if coords is None else coords
        index = 0
        for a in axes:
            index = index * self.shape[a] + coords[a]
        return index

    def batch_index(self) -> Tuple[int, int]:
        """``(index, count)`` of this rank's block of the global batch
        over :data:`BATCH_AXES`: the ranks along ``pipe``, ``expert``,
        ``seq`` and ``model`` share one block (the ``ShardSpec`` a rank's
        input pipeline reads)."""
        return self.index(BATCH_AXES), self.size(BATCH_AXES)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """One parallelism layout; the data, fsdp, pipeline, expert, sequence
    and tensor axes are ported (pipe and expert beside data; seq and
    model beside data and each other, not beside fsdp or expert).
    ``dp=0`` resolves to the world size over the other axes."""
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
        card and raises without a GPU; pass ``device="cpu"`` for gloo.
        Every rank must build the same mesh, in the same order as its
        other meshes: the process groups are created collectively."""
        for field, (axis, item) in _UNPORTED.items():
            if getattr(self, field) > 1:
                raise NotImplementedError(
                    f"MeshSpec({field}={getattr(self, field)}): the {axis!r} "
                    f"axis is not ported yet (ROADMAP.md, queue 1 item "
                    f"{item}); the data, fsdp, pipe, expert, seq and "
                    f"model axes are")
        if self.ep > 1 and self.fsdp > 1:
            raise NotImplementedError(
                f"MeshSpec(fsdp={self.fsdp}, ep={self.ep}): expert "
                f"parallelism beside ZeRO-3 is not ported yet (ROADMAP.md, "
                f"queue 1 item 11)")
        for field in ("tp", "sp"):
            size = getattr(self, field)
            for other in ("fsdp", "ep"):
                if size > 1 and getattr(self, other) > 1:
                    raise NotImplementedError(
                        f"MeshSpec({field}={size}, {other}="
                        f"{getattr(self, other)}): the {field} axis beside "
                        f"{other} is not ported yet (ROADMAP.md, queue 1 "
                        f"item 11); it runs beside data parallelism")
        if self.pp > 1:
            for other in ("fsdp", "ep", "sp", "tp"):
                if getattr(self, other) > 1:
                    raise NotImplementedError(
                        f"MeshSpec(pp={self.pp}, {other}="
                        f"{getattr(self, other)}): the pipeline axis beside "
                        f"{other} is not ported yet (ROADMAP.md, queue 1 "
                        f"item 11); it runs beside data parallelism")
        if min(self.fsdp, self.pp, self.ep, self.sp, self.tp) < 1 \
                or self.dp < 0:
            raise ValueError(f"MeshSpec(dp={self.dp}, fsdp={self.fsdp}, "
                             f"pp={self.pp}, ep={self.ep}, sp={self.sp}, "
                             f"tp={self.tp}): sizes must be positive (dp=0: "
                             f"the rest)")
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
        rest = self.fsdp * self.pp * self.ep * self.sp * self.tp
        if not self.dp and world % rest:
            raise ValueError(f"{world} devices not divisible by "
                             f"slices*fsdp*pp*ep*sp*tp={rest}")
        dp = self.dp or world // rest
        shape = dict.fromkeys(AXES, 1)
        shape[DATA], shape[FSDP], shape[EXPERT] = dp, self.fsdp, self.ep
        shape[PIPE] = self.pp
        shape[SEQ], shape[MODEL] = self.sp, self.tp
        if dp * rest != world:
            named = {a: n for a, n in shape.items() if n > 1} or {DATA: 1}
            raise ValueError(
                f"mesh shape {named} needs {dp * rest} devices, have "
                f"{world} (one rank per device)")
        mesh = Mesh(shape=shape, processes=world, device=dev,
                    rank=td.get_rank())
        # One group per line of the grid along each axis (and along the
        # data and seq axes together, the gradient-sync group of a
        # sequence-parallel mesh) that neither is trivial nor spans the
        # world, created by every rank in the same order.
        for axes in ((FSDP,), (DATA,), (EXPERT,), (SEQ,), (MODEL,),
                     (DATA, SEQ), (PIPE,)):
            key = tuple(a for a in axes if shape[a] > 1)
            if key in mesh.groups or not 1 < mesh.size(key) < world:
                continue
            for ranks in _lines(shape, key, world):
                group = td.new_group(ranks)
                if mesh.rank in ranks:
                    mesh.groups[key] = group
        return mesh


def _lines(shape: Dict[str, int], axes: Sequence[str], world: int):
    """The rank lists of the mesh's sub-grids along ``axes`` (the ranks
    that differ in those coordinates alone), in rank order."""
    def others(r):
        rest, out = r, []
        for a in reversed(AXES):
            if a not in axes:
                out.append(rest % shape[a])
            rest //= shape[a]
        return tuple(out)

    lines: Dict[Tuple[int, ...], list] = {}
    for r in range(world):
        lines.setdefault(others(r), []).append(r)
    return list(lines.values())

from tony_tpu_torch.parallel.layout import (Layout, layout_of,  # noqa: E402
                                            set_layout)
from tony_tpu_torch.parallel.overlap import (  # noqa: E402  (re-export)
    DEFAULT_BUCKET_BYTES, GradBuckets, ResidentBuckets, ShardBuckets,
    fsdp_param_specs, microbatch_grads, sync_axes, sync_size)
from tony_tpu_torch.parallel.sched import GatherPlan  # noqa: E402
from tony_tpu_torch.parallel.pipeline import (  # noqa: E402  (re-export)
    gpipe, gpipe_1f1b, pipelined_lm_logits, stage_split)

__all__ = ["AXES", "BATCH_AXES", "DATA", "DEFAULT_BUCKET_BYTES", "EXPERT",
           "FSDP", "GatherPlan", "GradBuckets", "Layout", "MODEL", "Mesh",
           "MeshSpec", "PIPE", "RULES", "ResidentBuckets", "SEQ", "SLICE",
           "ShardBuckets", "fsdp_param_specs", "gpipe", "gpipe_1f1b",
           "layout_of", "logical_spec", "microbatch_grads",
           "pipelined_lm_logits", "set_layout", "stage_split", "sync_axes",
           "sync_size"]
