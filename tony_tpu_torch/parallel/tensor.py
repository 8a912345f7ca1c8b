"""Tensor parallelism over the mesh's ``model`` axis: the port's
counterpart of what GSPMD inserts for :data:`tony_tpu_torch.parallel.RULES`
in the reference.

The reference gives every parameter logical axes; ``heads``,
``kv_heads``, ``ffn`` and ``vocab`` map onto ``model`` and XLA inserts
the collectives. The port has no GSPMD, so this module writes them by
hand: Megatron's column/row split, which computes the same function.

* :func:`copy_to_model` / :func:`reduce_from_model` — the conjugate pair
  over the ``model`` group: identity forward and all-reduce backward
  (a column-parallel projection's input), all-reduce forward and
  identity backward (a row-parallel projection's output);
* :func:`column_parallel` / :func:`row_parallel` — a projection whose
  weight holds this rank's rows (``wq``/``wk``/``wv``, ``w_gate``/
  ``w_up``, the LM head: its output features) or columns (``wo``,
  ``w_down``: its input features), built on the pair;
* :func:`vocab_parallel_embedding` — the ids outside this rank's
  ``[lo, hi)`` masked, looked up locally, the rows all-reduced;
* :func:`vocab_parallel_xent` — the cross entropy of vocab-sharded
  logits: the row max and ``Σexp`` all-reduced over ``model``, the target
  logit from its owning rank; a decoder on a mesh returns its block of
  the logits as :class:`ShardedLogits`, on which
  :func:`tony_tpu_torch.train.cross_entropy_loss` and
  :func:`~tony_tpu_torch.train.next_token_loss` take this path;
* :func:`shard_model` — a whole decoder's parameters cut to this rank's
  shards, each with its :class:`~tony_tpu_torch.parallel.layout.Layout`
  (the ``model`` dim and offset; the replica is the rank's index over
  the data and seq axes, which decides who writes it in a checkpoint).

Every rank of a ``model`` group runs the same graph, so the collectives
come in the same order on each, also when a remat block recomputes its
forward. An all-reduce gives every rank the same bits (NCCL, and gloo
on the CPU), which keeps the replicated leaves (the norms) bitwise
equal across the tp ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as td
import torch.nn.functional as F

from tony_tpu_torch import profiler
from tony_tpu_torch.parallel import DATA, MODEL, SEQ, Mesh
from tony_tpu_torch.parallel.layout import Layout, layout_of, set_layout
from tony_tpu_torch.parallel.overlap import _names, strip_spec

# The model axis' all-reduces in the collective registry (this rank's
# bytes in, ``calls`` and ``nbytes_total``).
MODEL_REDUCE_TAG = "tensor.model.all_reduce"


def model_size(mesh: Optional[Mesh]) -> int:
    """The tensor-parallel degree of ``mesh`` (1 without one)."""
    return 1 if mesh is None else mesh.shape[MODEL]


def _all_reduce(x: torch.Tensor, mesh: Mesh,
                op=td.ReduceOp.SUM) -> torch.Tensor:
    """``x`` summed (or ``op``-reduced) over the model group, in a new
    tensor."""
    out = x.contiguous().clone()
    profiler.count_collective(MODEL_REDUCE_TAG,
                              out.numel() * out.element_size(),
                              kind="all_reduce", plane="tensor",
                              axes=[MODEL])
    td.all_reduce(out, op=op, group=mesh.group((MODEL,)))
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Identity forward, all-reduce over ``model`` backward (``x`` as it
    is without a model axis)."""
    return x if model_size(mesh) == 1 else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]
                      ) -> torch.Tensor:
    """All-reduce over ``model`` forward, identity backward."""
    return x if model_size(mesh) == 1 else _ReduceFromModel.apply(x, mesh)


def column_parallel(dense: torch.nn.Module, x: torch.Tensor,
                    mesh: Optional[Mesh]) -> torch.Tensor:
    """``dense`` (whose weight holds this rank's output features) on the
    replicated ``x``: this rank's slice of the output features."""
    return dense(copy_to_model(x, mesh))


def row_parallel(dense: torch.nn.Module, x: torch.Tensor,
                 mesh: Optional[Mesh]) -> torch.Tensor:
    """``dense`` (whose weight holds this rank's input features) on this
    rank's slice of the features, summed over the ranks: the replicated
    output."""
    return reduce_from_model(dense(x), mesh)


def vocab_range(mesh: Optional[Mesh], local_vocab: int) -> int:
    """The first vocab id of this rank's rows."""
    return 0 if mesh is None else mesh.coords()[MODEL] * local_vocab


def vocab_parallel_embedding(tokens: torch.Tensor, weight: torch.Tensor,
                             mesh: Optional[Mesh]) -> torch.Tensor:
    """Rows of the embedding whose ``weight`` holds this rank's vocab rows
    ``[lo, lo + n)``: ids outside it looked up as row 0 and zeroed, then
    the rows summed over ``model`` (exact: one rank holds each id)."""
    if model_size(mesh) == 1:
        return F.embedding(tokens, weight)
    n = weight.shape[0]
    lo = vocab_range(mesh, n)
    outside = (tokens < lo) | (tokens >= lo + n)
    rows = F.embedding((tokens - lo).masked_fill(outside, 0), weight)
    return reduce_from_model(rows.masked_fill(outside[..., None], 0.0), mesh)


@dataclasses.dataclass(frozen=True)
class ShardedLogits:
    """What a decoder on a ``model`` or ``seq`` axis returns in place of
    its logits: ``logits``, this rank's block ``[B, T/sp, V/tp]`` (f32),
    whose vocab columns start at ``lo`` and whose positions are the seq
    shard ``mesh.coords()[SEQ]``. Not a tensor: the losses of
    :mod:`tony_tpu_torch.train` take it (the vocab-parallel cross
    entropy, the next-token shift across the shard boundary), and a loss
    written for whole logits fails on it instead of computing another
    function."""
    logits: torch.Tensor
    mesh: Mesh
    lo: int

    @classmethod
    def of(cls, logits: torch.Tensor, mesh: Mesh) -> "ShardedLogits":
        """``logits``, this rank's block on ``mesh``."""
        return cls(logits, mesh, vocab_range(mesh, logits.shape[-1]))

    def narrow(self, start: int, length: int) -> "ShardedLogits":
        """The positions ``[start, start + length)`` of the block."""
        return dataclasses.replace(
            self, logits=self.logits.narrow(1, start, length))


class _VocabXent(torch.autograd.Function):
    """Per-row cross entropy of ``[N, V/tp]`` f32 logits; the backward is
    ``(softmax − onehot) · g`` on this rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, lo, mesh):
        n = logits.shape[-1]
        # The max is only a shift for the exponent: no gradient.
        m = _all_reduce(logits.amax(dim=-1), mesh, td.ReduceOp.MAX)
        e = torch.exp(logits - m[:, None])
        total = _all_reduce(e.sum(dim=-1), mesh)
        mine = (labels >= lo) & (labels < lo + n)
        idx = (labels - lo).clamp(0, n - 1)
        target = _all_reduce(
            logits.gather(1, idx[:, None])[:, 0].masked_fill(~mine, 0.0),
            mesh)
        ctx.save_for_backward(e.div_(total[:, None]), idx, mine)
        return m + torch.log(total) - target

    @staticmethod
    def backward(ctx, g):
        p, idx, mine = ctx.saved_tensors
        grad = p.clone()
        rows = torch.arange(grad.shape[0], device=grad.device)
        grad[rows, idx] -= mine.to(grad.dtype)
        return grad.mul_(g[:, None]), None, None, None


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        lo: int, mesh: Mesh) -> torch.Tensor:
    """Per-row softmax cross entropy ``[N]`` of ``logits`` ``[N, V/tp]``
    (this rank's vocab columns from ``lo`` on, f32) against integer
    ``labels`` ``[N]`` (global ids): ``logsumexp`` over all columns of
    all ranks minus the label's logit. The same value on every rank of
    the model group."""
    return _VocabXent.apply(logits.float(), labels.long(), lo, mesh)


@torch.no_grad()
def shard_model(model: torch.nn.Module, specs: Sequence[Any],
                mesh: Mesh) -> List[Layout]:
    """Cut ``model``'s parameters to this rank's ``model`` shards and give
    the model the mesh (:meth:`set_mesh`). A parameter whose spec
    (``specs``, one per parameter) names ``model`` on a dim keeps this
    rank's ``1/tp`` of it (``p.data`` becomes the slice, a copy); the
    dim must divide, except a GQA K/V projection whose kv heads do not
    divide ``tp``, which stays whole (the model repeats its heads and
    all-reduces its grad, as the reference repeats K/V). Every parameter
    gets its :class:`Layout`, the replica being the rank's index over the
    data and seq axes. Returns the layouts."""
    tp = mesh.shape[MODEL]
    coords = mesh.coords()
    replica = mesh.index((DATA, SEQ))
    whole = set(model.whole_under(mesh))
    layouts = []
    for (name, p), spec in zip(model.named_parameters(), specs):
        spec = strip_spec(spec, mesh)
        dims = [d for d, e in enumerate(spec) if MODEL in _names(e)]
        shape = tuple(p.shape)
        if not dims or name in whole:
            lay = Layout(shape, (), None, 0, replica)
        else:
            d = dims[0]
            if len(dims) > 1 or shape[d] % tp:
                raise ValueError(
                    f"parameter {name} of shape {shape} with spec {spec}: "
                    f"the model axis must cut one dim into {tp} equal "
                    f"parts")
            n = shape[d] // tp
            lay = Layout(shape, spec, d, coords[MODEL] * n, replica)
            p.data = p.data.narrow(d, lay.start, n).clone()
        set_layout(p, lay)
        layouts.append(lay)
    model.set_mesh(mesh)
    return layouts


def model_leaves(params: Sequence[torch.Tensor]) -> List[bool]:
    """Which parameters hold this rank's ``model`` shard (the others are
    replicated over the model group)."""
    return [(lay := layout_of(p)) is not None and lay.sharded
            and lay.spec[lay.dim] == MODEL for p in params]


__all__ = ["MODEL_REDUCE_TAG", "ShardedLogits", "column_parallel",
           "copy_to_model", "model_leaves", "model_size",
           "reduce_from_model", "row_parallel", "shard_model",
           "vocab_parallel_embedding", "vocab_parallel_xent",
           "vocab_range"]
