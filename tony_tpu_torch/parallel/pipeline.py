"""Pipeline parallelism over the mesh's ``pipe`` axis: the counterpart of
:mod:`tony_tpu.parallel.pipeline`.

Each rank of a ``pipe`` group holds one stage (``stage s`` of ``S``: in
a decoder, layers ``[s·L/S, (s+1)·L/S)``). A batch is cut into ``M``
microbatches, and they flow down the chain of stages: stage ``s``
receives microbatch ``m`` from stage ``s - 1``, applies ``stage_fn``
and sends the result on to stage ``s + 1`` (``dist.batch_isend_irecv``
over the ``pipe`` group, the next microbatch's receive in flight while
one computes). The chain is the reference's ``ppermute`` perm ``(i,
i+1)``: stage ``S - 1`` sends nothing on, and its outputs, in the
original batch order, are broadcast over the ``pipe`` group, so every
rank of it returns them (the reference replicates them with ``psum``).
The reference computes ``stage_fn`` on clamped inputs in the fill and
drain ticks and drops the results; those ticks add nothing to outputs
or grads, so here a stage simply waits for its next input.

The backward is the reversed chain: the cotangent of microbatch ``m``
enters at stage ``S - 1`` and rides down to stage 0, each stage turning
its output's cotangent into its input's and its parameters'. Every rank
of the ``pipe`` group computes the same loss from the same replicated
output, so stage ``S - 1`` takes the cotangent of its own copy, once
(not the sum of ``S`` copies), and the input's grad is stage 0's,
broadcast so that every rank of the group holds the same. As every op
of the port, the stage grads are this data index's: the train step sums
them over the data group (the reference's ``psum(dparams, dp_axes)``).

* :func:`gpipe` keeps every microbatch's autograd graph from the forward
  (the reference's autodiff backward: ``M`` microbatches of a stage's
  residuals);
* :func:`gpipe_1f1b` keeps each microbatch's stage input alone and, in
  the backward, recomputes one microbatch's forward and runs its
  backward at a time (the 1F1B discipline: one forward and one backward
  of one microbatch in flight a stage);
* :func:`pipelined_lm_logits` is the decoder's forward with its block
  stack as a pipeline, the embedding, final norm and head computed on
  every rank of the group (the reference leaves them to GSPMD,
  replicated over ``pipe``).

The schedule is written once, as per-stage generator loops
(:func:`_forward_loop`, :func:`_backward_loop`) that yield their sends
and receives: the autograd Function drives a rank's loop over the
``pipe`` group, and :func:`pipeline_blocks` drives every stage's loop on
one device in lockstep, handing each send to the next stage in memory.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as td

from tony_tpu_torch import profiler
from tony_tpu_torch.parallel import BATCH_AXES, PIPE, Mesh
from tony_tpu_torch.parallel import sched as _sched

# What a stage loop yields: ``(_START, (send, like))`` sends the tensor
# ``send`` on (to the next stage forward, the previous one backward) and
# posts a receive into a buffer shaped as ``like`` from the other side
# (either may be None), and gets back a handle; ``(_FINISH, handle)``
# gets back what the receive got (None for a send).
_START, _FINISH = "start", "finish"
SCHEDULES = ("gpipe", "1f1b")


def _flat(tree: Any) -> List[torch.Tensor]:
    """The tensors of a stage's parameters: a tensor or a (nested) list,
    tuple or dict of tensors (a dict's keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    raise TypeError(f"stage parameters must be tensors in lists, tuples "
                    f"or dicts, got {type(tree).__name__}")


def _map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    raise TypeError(f"stage parameters must be tensors in lists, tuples "
                    f"or dicts, got {type(tree).__name__}")


def _mb_nbytes(x: torch.Tensor, microbatches: int) -> int:
    """Bytes of ONE microbatch buffer on one pipeline edge (``x`` is this
    data index's rows): what each tick moves between neighbour stages."""
    rows = x.shape[0] // microbatches
    return int(rows * math.prod(x.shape[1:]) * x.element_size())


def _local_batch(rows: int, dp_size: int, microbatches: int) -> int:
    """Per-DP-group batch size of a global batch of ``rows``, validated:
    an indivisible global batch fails loudly, naming both numbers (the
    reference's check: floor division would drop rows silently)."""
    if rows % dp_size:
        raise ValueError(
            f"global batch {rows} not divisible by the DP group count "
            f"{dp_size}; {rows % dp_size} rows would be silently dropped")
    local = rows // dp_size
    if local % microbatches:
        raise ValueError(
            f"per-DP-group batch {local} (global {rows} / dp {dp_size}) "
            f"not divisible by microbatches={microbatches}")
    return local


def stage_split(params: Any, n_stages: int) -> Any:
    """Reshape stacked layer params ``[L, ...]`` into pipeline-stage
    params ``[S, L/S, ...]`` (stage-major: stage s owns layers
    ``[s·L/S, (s+1)·L/S)``); views of the inputs. ``params`` is a tensor
    or a list, tuple or dict of them; stage ``s``'s slice is ``[s]`` of
    each leaf."""
    def reshape(leaf):
        n = leaf.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers not divisible by {n_stages} "
                             f"stages")
        return leaf.reshape((n_stages, n // n_stages) + tuple(leaf.shape[1:]))
    return _map(reshape, params)


def _check_out(y: Any, like: torch.Tensor) -> None:
    if not isinstance(y, torch.Tensor) or y.shape != like.shape \
            or y.dtype != like.dtype:
        got = (tuple(y.shape), y.dtype) if isinstance(y, torch.Tensor) \
            else type(y).__name__
        raise ValueError(f"stage_fn must return a microbatch of its input's "
                         f"shape and dtype {(tuple(like.shape), like.dtype)}"
                         f", got {got}")


def _forward_loop(stage_fn, params, x, s, n_stages, microbatches, keep):
    """Stage ``s``'s forward over the microbatches of ``x`` (this data
    index's rows; only stage 0 reads them, the others receive their
    inputs), the next microbatch's receive in flight while one computes.
    ``keep="graph"`` keeps each microbatch's autograd graph (input and
    output), ``"input"`` its input alone. A generator of the exchanges;
    returns ``(the outputs in batch order on the last stage, else None,
    what it kept)``."""
    mbs = list(x.chunk(microbatches))
    like = mbs[0]
    kept, outs, sends = [], [], []
    recv = (yield _START, (None, like)) if s > 0 else None
    for m in range(microbatches):
        if s == 0:
            xm = mbs[m]
        else:
            xm = yield _FINISH, recv
            recv = (yield _START, (None, like)) \
                if m + 1 < microbatches else None
        if keep == "graph":
            xm = xm.detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(params, xm)
            kept.append((xm, y))
        else:
            xm = xm.detach()
            with torch.no_grad():
                y = stage_fn(params, xm)
            kept.append(xm)
        _check_out(y, like)
        y = y.detach()
        if s == n_stages - 1:
            outs.append(y)
            continue
        sends.append((yield _START, (y, None)))
        if len(sends) > 1:
            yield _FINISH, sends.pop(0)
    for handle in sends:
        yield _FINISH, handle
    return (torch.cat(outs) if outs else None), kept


def _backward_loop(stage_fn, params, kept, dy, s, n_stages, microbatches,
                   keep, need_dx):
    """Stage ``s``'s backward: the cotangent of each microbatch (the last
    stage's from ``dy``, the others' received from the next stage) turned
    into its input's, sent to the previous stage, and into the stage
    parameters' grads, summed over the microbatches. With ``keep=
    "input"`` each microbatch's forward is recomputed first. A generator
    of the exchanges; returns ``(one grad per tensor of params, or None
    where it has none; on stage 0 with need_dx the input's grad in batch
    order, else None)``."""
    flat = _flat(params)
    train = [i for i, p in enumerate(flat) if p.requires_grad]
    grads: List[Optional[torch.Tensor]] = [None] * len(flat)
    first = kept[0][0] if keep == "graph" else kept[0]
    dys = list(dy.chunk(microbatches)) if s == n_stages - 1 else None
    dxs, sends = [], []
    recv = (yield _START, (None, first)) if s < n_stages - 1 else None
    for m in range(microbatches):
        if s == n_stages - 1:
            ct = dys[m]
        else:
            ct = yield _FINISH, recv
            recv = (yield _START, (None, first)) \
                if m + 1 < microbatches else None
        if keep == "graph":
            xm, y = kept[m]
        else:
            xm = kept[m].requires_grad_()
            with torch.enable_grad():
                y = stage_fn(params, xm)
        kept[m] = None
        want_dx = s > 0 or need_dx
        inputs = [flat[i] for i in train] + ([xm] if want_dx else [])
        got = torch.autograd.grad(y, inputs, ct, allow_unused=True)
        del y
        for i, g in zip(train, got):
            if g is not None:
                grads[i] = g if grads[i] is None else grads[i].add_(g)
        if not want_dx:
            continue
        dx = got[-1] if got[-1] is not None else torch.zeros_like(xm)
        if s == 0:
            dxs.append(dx)
            continue
        sends.append((yield _START, (dx, None)))
        if len(sends) > 1:
            yield _FINISH, sends.pop(0)
    for handle in sends:
        yield _FINISH, handle
    return grads, (torch.cat(dxs) if dxs else None)


class _Chain:
    """Sends to the next stage of this rank's ``pipe`` group (``step``
    +1 forward, -1 backward) and receives from the other side, one
    ``batch_isend_irecv`` a start; counts the bytes this rank sends
    under ``<tag>.send_recv`` in
    :func:`tony_tpu_torch.profiler.collective_report` (``calls``,
    ``nbytes_total``)."""

    def __init__(self, mesh: Mesh, tag: str, step: int):
        self.group = mesh.group((PIPE,)) if mesh.shape[PIPE] > 1 else None
        self.nxt = mesh.peer(PIPE, step)
        self.prv = mesh.peer(PIPE, -step)
        self.tag = f"{tag}.send_recv"

    def start(self, arg):
        send, like = arg
        ops, buf = [], None
        if send is not None:
            send = send.contiguous()
            ops.append(td.P2POp(td.isend, send, self.nxt, self.group))
            profiler.count_collective(
                self.tag, send.numel() * send.element_size(),
                kind="send_recv", plane="pipeline", axes=[PIPE])
        if like is not None:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device=like.device)
            ops.append(td.P2POp(td.irecv, buf, self.prv, self.group))
        return td.batch_isend_irecv(ops), buf, send

    @staticmethod
    def finish(pending):
        reqs, buf, _sent = pending
        for req in reqs:
            req.wait()
        return buf

    def drive(self, loop):
        """Run this rank's loop over the pipe group; its result."""
        reply = None
        try:
            while True:
                op, arg = loop.send(reply)
                reply = self.start(arg) if op is _START \
                    else self.finish(arg)
        except StopIteration as stop:
            return stop.value


def _drive_local(loops, step: int):
    """Every stage's loop on one device, in lockstep: stage ``s``'s n-th
    send is what stage ``s + step``'s n-th receive gets. Returns each
    loop's result."""
    n = len(loops)
    boxes = [{} for _ in range(n)]
    sent, posted = [0] * n, [0] * n
    waiting: List[Optional[int]] = [None] * n
    reply: List[Any] = [None] * n
    out: List[Any] = [None] * n
    live = list(range(n))
    while live:
        moved = False
        for s in list(live):
            while True:
                if waiting[s] is not None:
                    if waiting[s] not in boxes[s]:
                        break
                    reply[s] = boxes[s].pop(waiting[s])
                    waiting[s] = None
                try:
                    op, arg = loops[s].send(reply[s])
                except StopIteration as stop:
                    out[s] = stop.value
                    live.remove(s)
                    break
                moved = True
                if op is _START:
                    send, like = arg
                    if send is not None:
                        boxes[s + step][sent[s]] = send
                        sent[s] += 1
                    reply[s] = None
                    if like is not None:
                        reply[s] = posted[s]
                        posted[s] += 1
                elif arg is None:
                    reply[s] = None
                else:
                    waiting[s], reply[s] = arg, None
        if not moved:
            raise RuntimeError("pipeline stage loops are waiting on each "
                               "other")
    return out


def _broadcast(t: torch.Tensor, mesh: Mesh, stage: int, tag: str
               ) -> torch.Tensor:
    """``t`` from pipe stage ``stage`` of this rank's group on every rank
    of it (a buffer shaped as ``t`` elsewhere)."""
    if mesh.shape[PIPE] == 1:
        return t
    here = mesh.coords()[PIPE]
    t = t.contiguous()
    if here == stage:
        profiler.count_collective(
            f"{tag}.broadcast", t.numel() * t.element_size(),
            kind="broadcast", plane="pipeline", axes=[PIPE])
    td.broadcast(t, src=mesh.peer(PIPE, stage - here),
                 group=mesh.group((PIPE,)))
    return t


def _warm(mesh: Mesh) -> None:
    """One collective over the pipe group before its first send: NCCL
    wants every rank of a group in its first call."""
    if mesh.shape[PIPE] > 1 and not getattr(mesh, "_pipe_warm", False):
        td.all_reduce(torch.zeros(1, device=mesh.device),
                      group=mesh.group((PIPE,)))
        mesh._pipe_warm = True


class _Run:
    """One pipelined call's fixed arguments."""

    def __init__(self, tag, keep, stage_fn, params, mesh, microbatches):
        self.tag, self.keep = tag, keep
        self.stage_fn, self.params = stage_fn, params
        self.mesh, self.microbatches = mesh, microbatches
        self.stage = mesh.coords()[PIPE]
        self.stages = mesh.shape[PIPE]


class _PipeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *flat):
        del flat
        last = run.stages - 1
        y, kept = _Chain(run.mesh, run.tag, 1).drive(_forward_loop(
            run.stage_fn, run.params, x, run.stage, run.stages,
            run.microbatches, run.keep))
        if y is None:
            y = torch.empty_like(x)
        y = _broadcast(y, run.mesh, last, run.tag)
        ctx.run, ctx.kept = run, kept
        return y

    @staticmethod
    def backward(ctx, dy):
        run, kept = ctx.run, ctx.kept
        ctx.kept = None
        need_dx = ctx.needs_input_grad[1]
        grads, dx = _Chain(run.mesh, run.tag, -1).drive(_backward_loop(
            run.stage_fn, run.params, kept, dy.contiguous(), run.stage,
            run.stages, run.microbatches, run.keep, need_dx))
        if need_dx:
            if dx is None:
                dx = torch.empty_like(dy)
            dx = _broadcast(dx, run.mesh, 0, run.tag)
        return (None, dx if need_dx else None) + tuple(grads)


def _pipelined(tag: str, keep: str, stage_fn, stage_params, x: torch.Tensor,
               mesh: Mesh, microbatches: int, pipe_axis: str
               ) -> torch.Tensor:
    if pipe_axis != PIPE:
        raise ValueError(f"the port's mesh pipelines over {PIPE!r}, got "
                         f"pipe_axis={pipe_axis!r}")
    n_stages = mesh.shape[PIPE]
    dp = mesh.size(BATCH_AXES)
    _local_batch(x.shape[0] * dp, dp, microbatches)
    ticks = microbatches + n_stages - 1
    profiler.record_overlap(tag, stages=n_stages, microbatches=microbatches,
                            ticks=ticks if keep == "graph" else 2 * ticks)
    _sched.record_pipeline_edges(
        tag, stages=n_stages, microbatches=microbatches,
        mb_nbytes=_mb_nbytes(x, microbatches), reverse=keep == "input")
    _warm(mesh)
    run = _Run(tag, keep, stage_fn, stage_params, mesh, microbatches)
    return _PipeFn.apply(run, x, *_flat(stage_params))


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          stage_params: Any, x: torch.Tensor, mesh: Mesh, *,
          microbatches: int, pipe_axis: str = PIPE) -> torch.Tensor:
    """Run ``x`` through the ``S = mesh.shape["pipe"]`` stages of this
    rank's pipe group, ``microbatches`` microbatches in flight.

    Args:
      stage_fn: ``(stage_params, mb) -> mb_out``, one stage's compute on
        one microbatch: no collectives, ``mb_out`` of ``mb``'s shape and
        dtype (uniform stages, the transformer-block case).
      stage_params: THIS rank's stage's parameters (a tensor or a list,
        tuple or dict of them; e.g. ``stage_split(w, S)[s]``); ``stage_fn``
        may read them from this argument or from modules that hold them.
      x: this rank's rows of the global batch (its data index's block,
        the same on every rank of its pipe group; only stage 0 reads the
        values); the rows must divide into ``microbatches``.
      mesh: the mesh; composes with data parallelism (each data index
        runs its own pipeline).

    Returns the last stage's outputs for ``x``'s rows in their order, on
    every rank of the pipe group. The backward keeps every microbatch's
    graph from the forward (the reference's autodiff backward)."""
    return _pipelined("gpipe", "graph", stage_fn, stage_params, x, mesh,
                      microbatches, pipe_axis)


def gpipe_1f1b(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
               stage_params: Any, x: torch.Tensor, mesh: Mesh, *,
               microbatches: int, pipe_axis: str = PIPE) -> torch.Tensor:
    """:func:`gpipe`'s contract and outputs, with the 1F1B backward: the
    forward keeps each microbatch's stage input alone (no graph), and the
    backward, the reversed chain, recomputes one microbatch's forward and
    runs its backward at a time, so a stage holds the residuals of one
    microbatch instead of ``M``."""
    return _pipelined("gpipe_1f1b", "input", stage_fn, stage_params, x,
                      mesh, microbatches, pipe_axis)


def pipeline_blocks(stage_fn: Union[Callable[[Any, torch.Tensor],
                                              torch.Tensor],
                                     Sequence[Callable]],
                    stage_params: Sequence[Any], x: torch.Tensor,
                    dy: torch.Tensor, microbatches: int,
                    schedule: str = "gpipe", dp: int = 1
                    ) -> Tuple[torch.Tensor, List[List[Optional[
                        torch.Tensor]]], torch.Tensor]:
    """Every stage of a pipeline of ``len(stage_params)`` stages, run on
    one device: the loops :func:`gpipe` (``schedule="gpipe"``) or
    :func:`gpipe_1f1b` (``"1f1b"``) ranks run, the forward then the
    backward at the cotangent ``dy``, each send handed to the next stage
    in memory. ``stage_fn`` is every stage's, or a list of one per stage
    (a stage that applies its own modules). ``x`` and ``dy`` are the
    global batch, cut into ``dp``
    data indexes that each run their own pipeline. Returns ``(output,
    each stage's grads, one per tensor of its parameters (None where it
    has none), summed over the data indexes, the input's grad)``."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r} {SCHEDULES}")
    keep = "graph" if schedule == "gpipe" else "input"
    n = len(stage_params)
    fns = list(stage_fn) if isinstance(stage_fn, (list, tuple)) \
        else [stage_fn] * n
    local = _local_batch(x.shape[0], dp, microbatches)
    ys, dxs = [], []
    grads: List[List[Optional[torch.Tensor]]] = [
        [None] * len(_flat(p)) for p in stage_params]
    for d in range(dp):
        xd = x[d * local:(d + 1) * local]
        fwd = _drive_local([_forward_loop(fns[s], stage_params[s], xd, s,
                                          n, microbatches, keep)
                            for s in range(n)], 1)
        y = fwd[-1][0]
        bwd = _drive_local([_backward_loop(
            fns[s], stage_params[s], fwd[s][1],
            dy[d * local:(d + 1) * local].contiguous(), s, n, microbatches,
            keep, True) for s in range(n)], -1)
        ys.append(y)
        dxs.append(bwd[0][1])
        for s in range(n):
            for i, g in enumerate(bwd[s][0]):
                if g is not None:
                    grads[s][i] = g if grads[s][i] is None \
                        else grads[s][i] + g
    return torch.cat(ys), grads, torch.cat(dxs)


def pipelined_lm_logits(model: torch.nn.Module, tokens: torch.Tensor,
                        mesh: Mesh, *, n_stages: int, microbatches: int,
                        schedule: str = "gpipe") -> torch.Tensor:
    """The decoder's training forward with its block stack run as a
    pipeline over ``mesh``'s pipe axis: f32 logits ``[b, t, vocab]`` of
    this rank's ``tokens`` ``[b, t]`` (its data index's rows), on every
    rank of its pipe group.

    ``model`` is a decoder cut to this rank's stage
    (:func:`tony_tpu_torch.train.create_train_state` on the pp mesh: its
    ``layers`` are the stage's blocks). As the reference's tail, the
    embedding is cast to the compute dtype, the head runs in the compute
    dtype and the logits come out in f32; the Blocks run without remat,
    each stage applying its blocks one after the other
    (``schedule="gpipe"``, :func:`gpipe`; ``"1f1b"``,
    :func:`gpipe_1f1b`), their microbatches sharing one compute-dtype
    cast of each weight (:func:`~tony_tpu_torch.models.transformer.
    shared_weight_casts`). The embedding, the final norm and the head are
    replicated over ``pipe`` and computed on every rank of the group."""
    import torch.nn.functional as F

    from tony_tpu_torch.models.transformer import (rope_tables,
                                                   shared_weight_casts)

    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r} {SCHEDULES}")
    if n_stages != mesh.shape[PIPE]:
        raise ValueError(f"n_stages={n_stages} on a mesh with "
                         f"{mesh.shape[PIPE]} pipe stages")
    cfg = model.cfg
    blocks = model.layers
    if n_stages > 1 and len(blocks) != cfg.n_layers // n_stages:
        raise ValueError(
            f"the decoder holds {len(blocks)} of {cfg.n_layers} layers, not "
            f"its stage's {cfg.n_layers // n_stages}: cut it with "
            f"create_train_state(model, tx, mesh=mesh)")
    t = tokens.shape[1]
    positions = torch.arange(t, device=tokens.device)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = F.embedding(tokens.long(), model.embedding).to(cfg.dtype)

    def stage_fn(_params, h):
        for block in blocks:
            h = block(h, cos, sin)
        return h

    run = gpipe if schedule == "gpipe" else gpipe_1f1b
    # One compute-dtype copy of the stage's weights for all microbatches
    # (gpipe keeps every microbatch's graph until the backward).
    with shared_weight_casts():
        x = run(stage_fn, list(blocks.parameters()), x, mesh,
                microbatches=microbatches)
    return model.lm_head(model.final_norm(x)).float()


__all__ = ["SCHEDULES", "gpipe", "gpipe_1f1b", "pipeline_blocks",
           "pipelined_lm_logits", "stage_split"]
