"""Ring attention over the mesh's ``seq`` axis: the counterpart of
:mod:`tony_tpu.parallel.ring_attention`.

Each rank holds one sequence shard of Q, K and V. The K/V blocks rotate
around the ``seq`` group (``dist.batch_isend_irecv``: the next block's
send and receive are in flight while the current block computes), and
each rank attends its query shard to every block it holds in turn:

* the diagonal block (key shard ``j`` equal to the query shard ``r``)
  causally, the blocks ``j < r`` fully; blocks ``j > r`` are skipped (in
  the reference they contribute exactly nothing: ``p`` underflows to 0
  and ``alpha`` is 1);
* each block's output and log-sum-exp come from :func:`block_forward`,
  and the partial outputs merge by their LSE.

The backward is an explicit ``torch.autograd.Function``: with the global
LSE and output of the forward, each block's dQ, dK and dV come from
:func:`block_backward`; dQ accumulates on the rank, and each block's dK
and dV travel around the ring with the block, collecting every rank's
share, back to the block's owner.

:func:`block_forward` and :func:`block_backward` are the loop body, a
function of "the block this rank holds now". On a CUDA tensor they run
the ported flash kernels (``ops.attention._flash_fwd_cuda``: the forward
with its LSE and the ``causal`` flag; ``_flash_bwd_cuda``: the dQ kernel,
which computes ``D = rowsum(dO∘O)`` from the global output, and the
dK/dV kernel, both on the global LSE). On a CPU tensor they run the
ring's plain version: the reference's ``_block_step`` math in f32, and
its gradient written out. The loops around them are generators that
yield their sends and receives: the autograd Function drives a rank's
over the seq group, and :func:`ring_blocks` drives every rank's on one
device in lockstep, handing each send to the next rank in memory.

GQA: the blocks rotate at the narrow kv width (``heads % kv_heads ==
0``). :func:`ring_attention_sharded` is the global-array entry point
(each rank's block of global ``[B, H, T, D]`` arrays); where the kv
heads do not divide the model axis it repeats K/V up to the query heads
first, as the reference does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as td

from tony_tpu_torch import profiler
from tony_tpu_torch.parallel import BATCH_AXES, MODEL, SEQ, Mesh

_NEG_INF = -1e30

# The ring's record in the collective registry.
RING_TAG = "ring_attention.send_recv"


def _block_step(q, k, v, m, l, o, scale, mask):
    """The reference's online-softmax accumulation step, in f32.
    q: [B, Hkv, R·Tq, D], k/v: [B, Hkv, Tk, D], mask [R·Tq, Tk] (True =
    attend); m, l: [B, Hkv, R·Tq, 1], o: [B, Hkv, R·Tq, D]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s = torch.where(mask[None, None], s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    o_new = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, o_new


def _plain_mask(tq: int, tk: int, reps: int, diag: bool,
                device) -> torch.Tensor:
    """The grouped rows' mask: causal on the diagonal block, else all."""
    if not diag:
        return torch.ones((reps * tq, tk), dtype=torch.bool, device=device)
    q_pos = torch.arange(tq, device=device)[:, None]
    mask = q_pos >= torch.arange(tk, device=device)[None, :]
    return mask.repeat(reps, 1)


def _skip(r: int, j: int, causal: bool) -> bool:
    return causal and j > r


def block_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  r: int, j: int, causal: bool, scale: float,
                  plain: bool = False
                  ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Query shard ``r`` against the key shard ``j`` this rank holds now:
    ``(O [B, H, Tq, D], LSE [B, H, Tq] f32)`` of that block alone, or None
    where a causal ring skips it (``j > r``). q ``[B, H, Tq, D]``, k/v
    ``[B, Hkv, Tk, D]``. ``plain`` runs the plain version on a CUDA
    tensor too (the comparison on the card)."""
    if _skip(r, j, causal):
        return None
    diag = causal and j == r
    if q.device.type == "cuda" and not plain:
        from tony_tpu_torch.ops import attention

        return attention._flash_fwd_cuda(q, k, v, diag, scale)
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    reps = h // hkv
    qg = q.float().reshape(b, hkv, reps * tq, d)
    m = torch.full((b, hkv, reps * tq, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, reps * tq, 1), device=q.device)
    o = torch.zeros((b, hkv, reps * tq, d), device=q.device)
    m, l, o = _block_step(qg, k.float(), v.float(), m, l, o, scale,
                          _plain_mask(tq, tk, reps, diag, q.device))
    return ((o / l).reshape(b, h, tq, d),
            (m + torch.log(l)).reshape(b, h, tq))


def block_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                   dsum: torch.Tensor, r: int, j: int, causal: bool,
                   scale: float, plain: bool = False
                   ) -> Optional[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]]:
    """dQ, dK, dV of the block (``r``, ``j``) at the GLOBAL output ``o``,
    its LSE ``lse`` [B, H, Tq] and ``dsum = rowsum(dO∘O)`` [B, H, Tq]
    (f32): this block's share of each (dK/dV at the kv width), or None
    where a causal ring skips the block. On the card the dQ kernel
    computes ``dsum`` itself from ``o`` and ``do``; ``plain`` as in
    :func:`block_forward`."""
    if _skip(r, j, causal):
        return None
    diag = causal and j == r
    if q.device.type == "cuda" and not plain:
        from tony_tpu_torch.ops import attention

        return attention._flash_bwd_cuda(q, k, v, o, lse, do, diag, scale)
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    reps = h // hkv
    qg = q.float().reshape(b, hkv, reps * tq, d)
    dog = do.float().reshape(b, hkv, reps * tq, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qg, kf) * scale
    s = torch.where(_plain_mask(tq, tk, reps, diag, q.device)[None, None],
                    s, _NEG_INF)
    p = torch.exp(s - lse.reshape(b, hkv, reps * tq, 1))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dog)
    dp = torch.einsum("bhqd,bhkd->bhqk", dog, vf)
    ds = p * (dp - dsum.reshape(b, hkv, reps * tq, 1))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qg) * scale
    return dq.reshape(b, h, tq, d), dk, dv


def merge(o: Optional[torch.Tensor], lse: Optional[torch.Tensor],
          o_j: torch.Tensor, lse_j: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a block's ``(O, LSE)`` into the running pair, in f32."""
    if o is None:
        return o_j.float(), lse_j
    new = torch.logaddexp(lse, lse_j)
    return (o * torch.exp(lse - new)[..., None]
            + o_j.float() * torch.exp(lse_j - new)[..., None]), new


class _Ring:
    """Sends to the next rank of the seq group and receives from the
    previous one, a batch of tensors at a time; counts the bytes this
    rank sends under ``RING_TAG.fwd``/``.bwd`` in
    :func:`tony_tpu_torch.profiler.collective_report` (``calls``,
    ``nbytes_total``)."""

    def __init__(self, mesh: Mesh, what: str):
        self.group = mesh.group((SEQ,)) if mesh.shape[SEQ] > 1 else None
        self.nxt = mesh.peer(SEQ, 1)
        self.prv = mesh.peer(SEQ, -1)
        self.tag = f"{RING_TAG}.{what}"

    def start(self, tensors):
        bufs = [torch.empty_like(t) for t in tensors]
        ops = [td.P2POp(td.isend, t, self.nxt, self.group) for t in tensors]
        ops += [td.P2POp(td.irecv, b, self.prv, self.group) for b in bufs]
        profiler.count_collective(
            self.tag, sum(t.numel() * t.element_size() for t in tensors),
            kind="send_recv", plane="ring", axes=[SEQ])
        return td.batch_isend_irecv(ops), bufs, tensors

    @staticmethod
    def finish(pending):
        reqs, bufs, _sent = pending
        for req in reqs:
            req.wait()
        return bufs

    def drive(self, loop):
        """Run this rank's loop (:func:`_forward_loop`,
        :func:`_backward_loop`) over the seq group; its result."""
        reply = None
        try:
            while True:
                op, arg = loop.send(reply)
                reply = self.start(arg) if op is _START else self.finish(arg)
        except StopIteration as stop:
            return stop.value


# What a ring loop yields: ``(_START, tensors)`` sends this rank's
# tensors on to the next rank and gets back a handle; ``(_FINISH,
# handle)`` gets back what the previous rank sent at the start of the
# same handle.
_START, _FINISH = "start", "finish"


def _forward_loop(q, k, v, r, sp, causal, scale, plain=False):
    """Rank ``r``'s forward around a ring of ``sp``: its query shard
    against every block in turn, the next block in flight while one
    computes. A generator of the exchanges; returns ``(O in q's dtype,
    LSE f32 [B, H, Tq])``."""
    kc, vc = k.contiguous(), v.contiguous()
    o = lse = None
    for s in range(sp):
        j = (r - s) % sp
        pending = (yield _START, [kc, vc]) if s < sp - 1 else None
        part = block_forward(q, kc, vc, r, j, causal, scale, plain)
        if part is not None:
            o, lse = merge(o, lse, *part)
        if pending is not None:
            kc, vc = yield _FINISH, pending
    return o.to(q.dtype), lse.contiguous()


def _backward_loop(q, k, v, o, do, lse, r, sp, causal, scale, plain=False):
    """Rank ``r``'s backward: ``dsum`` from the global output once, each
    block's dQ/dK/dV at the global LSE; dQ accumulates here, each block's
    dK/dV travels on with the block, collecting every rank's share, and
    reaches its owner one hop after the last block. A generator of the
    exchanges, as :func:`_forward_loop`; returns ``(dQ, dK, dV)`` in the
    inputs' dtypes."""
    do = do.contiguous()
    dsum = (do.float() * o.float()).sum(dim=-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kc, vc = k.contiguous(), v.contiguous()
    travelling = None
    for s in range(sp):
        j = (r - s) % sp
        pending = (yield _START, [kc, vc]) if s < sp - 1 else None
        part = block_backward(q, kc, vc, o, do, lse, dsum, r, j, causal,
                              scale, plain)
        if part is None:
            dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            dv = torch.zeros_like(dk)
        else:
            dq += part[0].float()
            dk, dv = part[1].float(), part[2].float()
        # Block j's dK/dV so far, from the rank that held it before;
        # then on to the next, the last hop reaching the owner.
        if travelling is not None:
            dk_in, dv_in = yield _FINISH, travelling
            dk += dk_in
            dv += dv_in
        if sp > 1:
            travelling = yield _START, [dk, dv]
        if pending is not None:
            kc, vc = yield _FINISH, pending
    if travelling is not None:
        dk, dv = yield _FINISH, travelling
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _drive_local(loops):
    """Every rank's loop on one device, in lockstep: rank ``r``'s n-th
    start is what rank ``r + 1``'s n-th finish receives. Returns each
    loop's result."""
    sp = len(loops)
    boxes = [{} for _ in range(sp)]
    sent = [0] * sp
    waiting = [None] * sp
    reply = [None] * sp
    out = [None] * sp
    live = list(range(sp))
    while live:
        for r in list(live):
            while True:
                if waiting[r] is not None:
                    if waiting[r] not in boxes[r]:
                        break
                    reply[r] = boxes[r].pop(waiting[r])
                    waiting[r] = None
                try:
                    op, arg = loops[r].send(reply[r])
                except StopIteration as stop:
                    out[r] = stop.value
                    live.remove(r)
                    break
                if op is _START:
                    boxes[(r + 1) % sp][sent[r]] = arg
                    reply[r] = sent[r]
                    sent[r] += 1
                else:
                    waiting[r], reply[r] = arg, None
    return out


def ring_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                do: torch.Tensor, shards: int, causal: bool = True,
                scale: Optional[float] = None, plain: bool = False
                ) -> Tuple[torch.Tensor, ...]:
    """Every rank of a ring over a sequence cut into ``shards`` shards,
    run on one device: the loops :func:`ring_attention`'s ranks run
    (the forward, then the backward at its output), each send handed to
    the next rank in memory. q/k/v/dO are the whole ``[B, H, T, D]``
    arrays; returns ``(O, dQ, dK, dV)`` whole, in the inputs' dtype.
    ``plain`` as in :func:`block_forward`."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    qs, ks, vs, dos = (x.chunk(shards, dim=2) for x in (q, k, v, do))
    fwd = _drive_local([_forward_loop(qs[r], ks[r], vs[r], r, shards,
                                      causal, scale, plain)
                        for r in range(shards)])
    bwd = _drive_local([_backward_loop(qs[r], ks[r], vs[r], fwd[r][0],
                                       dos[r], fwd[r][1], r, shards, causal,
                                       scale, plain)
                        for r in range(shards)])
    return tuple(torch.cat(parts, dim=2) for parts in
                 zip(*[(o,) + g for (o, _), g in zip(fwd, bwd)]))


class _RingFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, causal, scale):
        out, lse = _Ring(mesh, "fwd").drive(_forward_loop(
            q, k, v, mesh.coords()[SEQ], mesh.shape[SEQ], causal, scale))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.causal, ctx.scale = mesh, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh = ctx.mesh
        dq, dk, dv = _Ring(mesh, "bwd").drive(_backward_loop(
            q, k, v, o, do, lse, mesh.coords()[SEQ], mesh.shape[SEQ],
            ctx.causal, ctx.scale))
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over the sequence sharded along the mesh's ``seq``
    axis, with its backward. Per rank: q ``[B, H, T/sp, D]`` (this rank's
    query shard), k/v ``[B, Hkv, T/sp, D]`` with ``H % Hkv == 0`` (GQA:
    the narrow blocks rotate). Returns ``[B, H, T/sp, D]`` in q's dtype.
    Every rank of the seq group must call it together."""
    b, h, tq, d = q.shape
    if h % k.shape[1]:
        raise ValueError(f"query heads {h} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or k.shape[2] != tq:
        raise ValueError(f"ring attention wants equal shards: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    scale = d ** -0.5 if scale is None else float(scale)
    return _RingFn.apply(q, k, v, mesh, bool(causal), scale)


def local_block(x: torch.Tensor, mesh: Mesh, dims) -> torch.Tensor:
    """This rank's block of a global array: ``dims`` maps a dim to the
    mesh axes it is split over (outermost first)."""
    for dim, axes in dims.items():
        count, index = mesh.size(axes), mesh.index(axes)
        if x.shape[dim] % count:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"divide over the mesh axes {tuple(axes)} "
                             f"({count} ways)")
        n = x.shape[dim] // count
        x = x.narrow(dim, index * n, n)
    return x


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh: Mesh, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Global-array entry point: q/k/v are the global ``[B, H, T, D]``
    arrays (the same on every rank); returns this rank's block of the
    output, batch over the data axes, heads over ``model`` and sequence
    over ``seq``. Where the kv heads do not divide the model axis, K/V
    are repeated up to the query heads first (the reference's fallback:
    exact, without the narrow ring)."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"query heads {q.shape[1]} not a multiple of kv "
                         f"heads {k.shape[1]}")
    tp = mesh.shape[MODEL]
    if tp > 1 and k.shape[1] % tp:
        reps = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(reps, dim=1)
        v = v.repeat_interleave(reps, dim=1)
    dims = {0: BATCH_AXES, 1: (MODEL,), 2: (SEQ,)}
    return ring_attention(*(local_block(x, mesh, dims) for x in (q, k, v)),
                          mesh, causal=causal, scale=scale)


__all__ = ["RING_TAG", "block_backward", "block_forward", "local_block",
           "merge", "ring_attention", "ring_attention_sharded",
           "ring_blocks"]
