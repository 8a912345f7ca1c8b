"""Chip smoke test of the PyTorch/CUDA port (``tony_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase's failure is
caught):

1. device — require CUDA, print ``nvidia-smi`` name and power limit;
2. build — compile every kernel of the port from
   ``tony_tpu_torch/ops/csrc`` with nvcc (sm_90a), one nvcc per source,
   all started together, and print the build time;
3. kernels — hold each kernel against its plain PyTorch version on the
   card: flash-decode at the serving path's shapes (the b=16 and b=4
   decode buckets, one sequence, GQA and a 512-token prefill at ctx
   2048; bf16 on the tensor-core ``flash_decode_mma_kernel``, timed
   beside its bound, plain version and SDPA, and f32 on the CUDA-core
   kernel; ragged positions; row independence and, in bf16, the same
   bits at every split of the cache, with ``torch.equal``), and the flash
   attention forward, backward dQ and backward dK/dV at one shape per TPU
   launcher family (packed and classic layouts, GQA, t=8192, ragged t,
   non-causal t != tk; bf16 and f32; O, LSE, dQ, dK and dV run twice and
   compared with ``torch.equal``; the bf16 forward is the tensor-core
   ``flash_fwd_mma_kernel`` and the bf16 backward the tensor-core pair
   ``flash_bwd_dq_mma_kernel``/``flash_bwd_dkv_mma_kernel``, f32 runs the
   CUDA-core kernels). Each is timed beside its plain version, the
   ``scaled_dot_product_attention`` yardstick and the bytes/operations
   bound; and the fused bucket optimizer update for every rule (AdamW
   with and without weight decay, SGD-momentum, Adafactor-style), in f32
   and bf16, at n = 1, 1000 and one 7B ``w_gate`` bucket, with
   ``torch.equal`` on p and every slot, timed at the ``w_gate`` and the
   embedding bucket beside its plain version, its bound and
   ``torch.optim.AdamW(fused=True)``;
4. serve — full-width llama2-7b (random bf16 weights made on the card
   from a seed) behind ``ServeEngine``/``EngineFront``: 16 requests from
   16 threads; every request completes with its token count, the kernel
   ran 32 times per forward, and two requests' streamed decode logits
   match the engine's own full-prefill logits within the stated
   tolerance with greedy tokens equal;
5. profile — device time by kernel over three b=16 decode steps
   (torch.profiler), grouped (flash_decode, the per-layer KV gather,
   GEMMs, ...), and the device's idle share of the step;
6. train — llama2-7b at full width cut to 8 layers (f32 parameters,
   bf16 compute, flash attention, remat), AdamW(3e-4), 8 steps on one
   fixed batch of 2 x 2048 seeded tokens: one step's grads through the
   kernels against the same model run with the plain attention on the
   card (in bf16 and in f32 compute, and both bf16 paths against the f32
   grads), the loss finite and falling, the kernels' launch counts exact,
   and the step time, throughput, MFU and peak memory; then where two
   steps' device time goes (torch.profiler), whose kernel names must
   show the forward in the tensor-core forward only and the backward in
   the two tensor-core kernels only, each launched exactly as often as
   the step needs (as must the train_fused and train_quant profiles);
7. train_fused — the same model, weights and batch through
   ``make_accum_train_step(microbatches=2, update="fused_bucket")`` with
   ``FusedOptimizer(adamw, 3e-4)``, 8 steps: the loss finite and falling
   and its first value within 1e-2 of the train phase's, one update
   launch per bucket per step and the flash launches of two microbatches,
   every parameter still in its bucket, one step's real buckets through
   the kernel and the plain version with ``torch.equal``; step time,
   throughput, MFU, peak memory and a profile;
8. serve_quant — the serve phase's model, seed and 16-request mix with
   ``quant=True`` (int8 qkv/o/mlp projections through ``int8_matmul``):
   every request completes, the int8 kernel ran 7 × 32 times per
   forward, one prefill and one decode forward give ``torch.equal``
   logits through the kernel and through its plain version, decode
   against the engine's own full prefill within the stated quantization
   limit, the distance to the unquantized serve phase's logits, the
   serve numbers, the quantize passes timed apart, and a decode profile;
9. train_quant — the train phase's model, batch and AdamW(3e-4) with
   ``quant=True``, 8 steps: one step's loss and grads ``torch.equal``
   through the kernel and through its plain version, the loss finite,
   falling and within 5e-2 of the train phase's first loss, exact launch
   counts (remat recomputes each quantized projection: 7 × layers × 2
   per step), step time, throughput, MFU, peak memory and a profile;
10. train_resnet — ResNet-50 at full width (224², s2d stem, bf16
   compute, f32 parameters and statistics) on the fused BN lane, batch
   256 of seeded images, ``sgd(0.1, momentum=0.9)`` through
   ``make_train_step``, 8 steps: exact BN launch counts (53 stats, 53
   apply, 37 + 37 backward without the residual and 16 + 16 with it, per
   step), the loss finite and falling, every running statistic finite
   and moved; step time, images/s, MFU, peak memory and a profile; then
   the plain lane (flax-style BatchNorm, no BN kernel launched) from the
   same weights on the same batch; then one f32 step at batch 32 with
   deterministic cuDNN, on loss, every grad and the new running
   statistics, from flax's init (the reference test's setup) and with
   every block's exit scale 1: the elementwise kernels bitwise their
   plain versions in the model; the kernels against the plain versions;
   the fused lane against the plain lane;
11. train_loop — the train phase's model, weights and batch as a TonY
   job steps them: ``xent_chunk=1024`` (the chunked LM-head loss),
   ``remat_policy="dots"``, AdamW(3e-4) and
   ``make_train_step(mesh=MeshSpec(dp=1).build())`` on a one-rank NCCL
   group, 8 steps through ``train_loop`` with ``train_stats_writer`` as
   ``on_step``: one backward under each remat policy from the same
   weights ``torch.equal`` in loss and grads, the chunked loss within
   1e-3 of the train phase's first loss and its grads within the train
   phase's bf16 limit of the plain head's, the loss finite and falling,
   exact flash launches (forward 2 × 8 a step under remat, backward 8 +
   8), the stats file's five keys with MFU > 0 and the grad bytes a step
   reduces, a profile; step time, tokens/s, MFU and peak memory for
   each remat policy and for ``xent_chunk`` 0; then one step with the
   mesh against one without from fresh copies of the same weights at 2
   layers, ``torch.equal`` in loss and parameters;
12. train_ckpt — the train_loop cell with the checkpoint and data plane
   armed: 64 x 2048 seeded tokens in a memmapped ``.npy`` through
   ``Dataset.from_memmap(...).shuffle().repeat().batch(2).with_ids()`` and
   a ``DeviceIterator`` (pinned memory, side stream); run A 8 steps
   uninterrupted; run B from the same weights with an async save at step
   4, killed after step 6, then resumed by ``train_loop`` from other
   weights and a fresh iterator (the step-4 state and data cursor
   restored from disk, in place); B's state and cursor at step 8 equal
   A's chunk for chunk (extents, CRC32, bytes, through the snapshot
   engine), the ids of steps 5-8 and the first loss after the restore
   equal, the flash launches of 4 steps; then at 2 layers a fused run
   with ``save_every=2``, ``publish_every=1`` and the drain file after
   step 2: ``EXIT_DRAINED`` over a committed model + cursor,
   ``published.json`` on it, and a fresh ``FusedOptimizer`` state that
   restores it and takes step 3 ``torch.equal`` to the drained state's
   own step 3 (parameters, every slot; one update launch per bucket).
   The save's stall, staging, device→host and write times, the
   restore's, the input stall, peak memory and the memory allocated
   after each step (the save's device staging buffer lives until its
   device→host copy has read it); the host's free memory
   and disk are printed first, and too little disk raises. The phase
   writes two checkpoints (22.57 and 8.07 GB), so that the whole script
   stays under 45 GiB of disk writes, where some hosts end a run;
13. serve_replica — inside train_ckpt, on B's committed step 4 before it
   is deleted, with the training state freed (it writes no checkpoint:
   only ``published.json`` and the stats file): ``publish_step`` and a
   ``Replica`` of the 8-layer model (``xent_chunk=1024``, bf16 storage,
   ctx 2048, 16 running) restoring the params subtree with the bf16
   policy; the step and version are the pointer's, every served
   parameter is bitwise the bf16 cast of the step's f32 leaf (read back
   through the port's restore into host memory); ``serve_forever`` on
   127.0.0.1 in a thread; the 16-request mix in-process (decode against
   the full prefill within 5e-2, greedy tokens equal) and then over the
   port's ``RpcClient`` from 16 threads (every request completes, row 9
   launched 8 times a forward); one prompt alone over RPC and in-process
   gives the same tokens; the stats file holds the RPC port, the step
   and the control plane's keys; ``publish_step`` again, then the
   ``swap`` verb while 16 RPC clients keep requests in flight (none
   dropped, version 2, one swap, the alone prompt's tokens unchanged);
   a swap to an uncommitted step is refused with the weights kept. It
   reports the restore, the time to the first token, RPC and in-process
   decode numbers, the swap's restore, the decode step p50 during it,
   the quiesce and the flip, and peak memory. At full depth:
   ``python3 exp/port_replica_phase.py``;
14. report — a ``{"kernels": [...]}`` line (rows 1-15), a
   ``{"serve": {...}}`` line, a ``{"train": {...}}`` line, a
   ``{"train_fused": {...}}`` line, a ``{"quant": {...}}`` line, a
   ``{"bn_shapes": {...}}`` line, a ``{"resnet": {...}}`` line, a
   ``{"train_loop": {...}}`` line, a ``{"train_ckpt": {...}}`` line, a
   ``{"serve_replica": {...}}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Phase 3 also holds the int8 matmul (row 15) ``torch.equal`` to its plain
version at the quant lane's decode (b=16 and b=4), prefill, train and
``lm_head`` shapes of the 7B and at ragged shapes, as planned and at
forced split counts over K, every shape but the ragged ones on the
``wgmma`` path (which the serve_quant and train_quant comparisons assert
for every call too); each is timed back to back, on the card alone (a
CUDA graph) and, up to 512 rows, with a cold L2, with the host's µs a
call, beside its bound, the plain version, ``torch._int_mm`` plus the
rescale, and the bf16 ``F.linear`` the lane replaces; and the fused BatchNorm kernels (rows 10-13) against
their plain versions at every distinct BN input of ResNet-50 at batch
256 in bf16, at its stem, stage-1 exit and stage-4 shapes and a ragged
shape in f32 (the ragged one in bf16 too), with and without the
residual and the ReLU (elementwise passes ``torch.equal``,
reductions within 1e-5 of their sums' scale, two runs of every kernel
``torch.equal``), timed in bf16 beside their bounds, plain versions, the
``torch.batch_norm_*`` passes and ``F.batch_norm`` + ``F.relu`` (+ the
add) with its autograd backward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import torch
import torch.distributed as td

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tony_tpu_torch import ckpt, profiler, publish  # noqa: E402
from tony_tpu_torch.ckpt import snapshot as ckpt_snapshot  # noqa: E402
from tony_tpu_torch.constants import EXIT_DRAINED  # noqa: E402
from tony_tpu_torch.data import Dataset, ShardSpec, ckptio  # noqa: E402
from tony_tpu_torch.models import get_model  # noqa: E402
from tony_tpu_torch.models.convert import jax_param_tree  # noqa: E402
from tony_tpu_torch.models.resnet import (FusedBNAct,  # noqa: E402
                                          resnet50_flops)
from tony_tpu_torch.ops import LAUNCHES, _build  # noqa: E402
from tony_tpu_torch.ops import attention as attn  # noqa: E402
from tony_tpu_torch.ops import batchnorm as bn  # noqa: E402
from tony_tpu_torch.ops import fused_optim as fo  # noqa: E402
from tony_tpu_torch.ops import quant as tq  # noqa: E402
from tony_tpu_torch.parallel import MeshSpec  # noqa: E402
from tony_tpu_torch.rpc import RpcClient, RpcError  # noqa: E402
from tony_tpu_torch.serve import (EngineFront, Replica,  # noqa: E402
                                  ServeEngine)
from tony_tpu_torch.train import (adamw, create_train_state,  # noqa: E402
                                  cross_entropy_loss, global_batch,
                                  make_accum_train_step, make_train_step,
                                  next_token_loss, sgd, train_loop,
                                  train_stats_writer)

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8_OPS = 1979e12            # H100 SXM, dense
# Kernel vs plain: f32 to 1e-5 absolute; bf16 to one bf16 ulp of the
# output's scale (both round the same f32 recurrence, summed in another
# order, to bf16).
F32_TOL = 1e-5
# Decode vs full prefill, bf16 7B on the card: cuBLAS picks other GEMM
# kernels for the 16-row decode blocks than for the whole-prompt
# prefill, so rows differ by rounding, and 32 random-weight layers carry
# the difference up to ~2e-2 of the row's largest logit. Per row,
# max|Δ| must stay within 5e-2·max|ref|, and the greedy token must equal
# the reference's argmax wherever the reference's top-two gap exceeds
# that tolerance (a closer near-tie may flip; the flips are counted).
SERVE_REL_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_ms(fn, reps: int = 10, iters: int = 20) -> float:
    """Device ms of one ``fn()`` alone: ``reps`` calls captured in a CUDA
    graph and replayed ``iters`` times between two events, so no host
    time is in it (``cuda_ms`` reads host time too where the host enqueues
    a call more slowly than the card runs it)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters=iters, warmup=1) / reps


def decode_inputs(b, h, hkv, t, d, ctx, dtype, gen, prefill=False):
    """q/k/v laid out as the serving forward passes them: q a transposed
    view of [b, t, h, d], k/v [b, hkv, ctx, d] views of the gathered
    [b, ctx, hkv·d] buffer; ragged positions from ``gen``."""
    dev = "cuda"
    q = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
    kbuf = torch.randn((b, ctx, hkv * d), generator=gen,
                       device=dev).to(dtype)
    vbuf = torch.randn((b, ctx, hkv * d), generator=gen,
                       device=dev).to(dtype)
    if prefill:
        p0 = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    else:
        p0 = torch.randint(0, ctx - t, (b, 1), generator=gen, device=dev,
                           dtype=torch.int32)
    pos = p0 + torch.arange(t, dtype=torch.int32, device=dev)[None]
    return (q.transpose(1, 2),
            kbuf.view(b, ctx, hkv, d).transpose(1, 2),
            vbuf.view(b, ctx, hkv, d).transpose(1, 2), pos)


def bound(q, k, pos):
    """Least time for the work these inputs need: the K/V rows up to each
    sequence's largest position read once, q read, o written, over HBM
    bandwidth; against 4·d flops per (row, admitted key) at the peak
    rate of the input type. Returns (ms, "bytes" | "operations")."""
    b, h, t, d = q.shape
    hkv, ctx = k.shape[1], k.shape[2]
    es = q.element_size()
    keys = (pos.clamp(max=ctx - 1) + 1).to(torch.float64)     # [b, t]
    kv_rows = keys.max(dim=1).values.sum().item()
    nbytes = (2 * kv_rows * hkv * d * es + 2 * b * h * t * d * es
              + pos.numel() * 4)
    flops = 4.0 * d * h * keys.sum().item()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_fn(q, k, v, pos):
    """The library yardstick: one scaled_dot_product_attention call with
    the equivalent boolean mask (timed here only; the port never calls
    it)."""
    ctx = k.shape[2]
    mask = (torch.arange(ctx, device=q.device)[None, None, None, :]
            <= pos[:, None, :, None])
    gqa = q.shape[1] != k.shape[1]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=gqa)


# The serving shapes of flash-decode (row 9), llama2-7b's d=128 at ctx
# 2048: (name, (b, h, hkv, t, d, ctx), prefill). decode is the serve
# phase's b=16 bucket, b4 the engine's other bucket, b1 one sequence, gqa
# eight kv heads, prefill a 512-token prompt.
DECODE_SHAPES = [("decode", (16, 32, 32, 16, 128, 2048), False),
                 ("b4", (4, 32, 32, 16, 128, 2048), False),
                 ("b1", (1, 32, 32, 16, 128, 2048), False),
                 ("gqa", (16, 32, 8, 16, 128, 2048), False),
                 ("prefill", (1, 32, 32, 512, 128, 2048), True)]


def check_kernel(name, shape, dtype, gen, prefill=False, time_it=False):
    q, k, v, pos = decode_inputs(*shape, dtype, gen, prefill=prefill)
    scale = q.shape[-1] ** -0.5
    out = attn.flash_decode(q, k, v, pos)
    ref = attn._decode_plain(q, k, v, pos, scale, 128)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        tol = F32_TOL
    else:
        tol = 2.0 ** (math.floor(math.log2(ref.float().abs().max().item()))
                      - 7)
    log(f"  {name} {dtype}: max|kernel - plain| = {err:.3e} (tol "
        f"{tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name} {dtype}: kernel disagrees with the "
                             f"plain version: {err} > {tol}")
    res = {"max_abs_err": err}
    if dtype == torch.bfloat16:
        b, h, t, d = q.shape
        dev = torch.cuda.current_device()
        res["plan"] = attn._decode_plan_on(
            dev, b, h, k.shape[1], t, d, k.shape[2])._asdict()
    if time_it:
        res["ms"] = cuda_ms(lambda: attn.flash_decode(q, k, v, pos))
        res["plain_ms"] = cuda_ms(
            lambda: attn._decode_plain(q, k, v, pos, scale, 128), iters=5)
        res["library_ms"] = cuda_ms(sdpa_fn(q, k, v, pos))
        res["bound_ms"], res["bound_by"] = bound(q, k, pos)
        res["device_ms"] = cuda_graph_ms(
            lambda: attn.flash_decode(q, k, v, pos))
        res["library_device_ms"] = cuda_graph_ms(sdpa_fn(q, k, v, pos))
        log(f"    kernel {res['ms']:.4f} ms ({res['device_ms']:.4f} on the "
            f"card alone), plain {res['plain_ms']:.4f} ms, sdpa "
            f"{res['library_ms']:.4f} ms ({res['library_device_ms']:.4f}), "
            f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res


def check_row_independence(dtype, gen):
    """The same rows in a t=16 launch and inside a t=64 launch must be
    bit-equal (another tile, other neighbours, another key-loop end); in
    bf16 also one sequence alone (b=1, the cache split over blocks) and
    inside the b=4 launch, and the launch at forced split counts."""
    b, h, hkv, d, ctx = 4, 32, 8, 128, 2048
    q16, k, v, pos16 = decode_inputs(b, h, hkv, 16, d, ctx, dtype, gen)
    q64 = torch.randn((b, 64, h, d), generator=gen,
                      device="cuda").to(dtype).transpose(1, 2).clone()
    q64[:, :, 16:32] = q16
    pos64 = torch.randint(0, ctx, (b, 64), generator=gen, device="cuda",
                          dtype=torch.int32)
    pos64[:, 16:32] = pos16
    o16 = attn.flash_decode(q16, k, v, pos16)
    o64 = attn.flash_decode(q64, k, v, pos64)
    torch.cuda.synchronize()
    if not torch.equal(o16, o64[:, :, 16:32]):
        raise AssertionError(f"row independence broken ({dtype})")
    log(f"  row independence {dtype}: t=16 rows == the same rows in a "
        f"t=64 launch (torch.equal)")
    if dtype != torch.bfloat16:
        return
    scale = d ** -0.5
    o1 = attn.flash_decode(q16[2:3], k[2:3], v[2:3], pos16[2:3].clone())
    forced = {s: attn._decode_cuda(q16, k, v, pos16, scale, splits=s)
              for s in (1, 2, 4, 8)}
    torch.cuda.synchronize()
    if not torch.equal(o1, o16[2:3]) or not all(
            torch.equal(o, o16) for o in forced.values()):
        raise AssertionError("the split over the cache changed a bit")
    log("  split invariance bf16: b=1 rows == the same rows in the b=4 "
        "launch; splits 1, 2, 4, 8 == the planned launch (torch.equal)")


def serve_phase(gen_seed: int, quant=None, tol: float = SERVE_REL_TOL):
    """The 16-request serve drive of full-width llama2-7b (bf16 storage)
    on the model's ``quant`` lanes. Returns the serve numbers, the
    launches counted over the drive, the engine and the completions."""
    torch.manual_seed(gen_seed)
    t0 = time.monotonic()
    # Stored in bf16: the same weights as f32 storage cast at every use.
    model = get_model("llama2-7b", device="cuda", seed=gen_seed,
                      param_dtype=torch.bfloat16, quant=quant)
    torch.cuda.synchronize()
    cfg = model.cfg
    log(f"  llama2-7b (quant={quant}) built on the card in "
        f"{time.monotonic() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e9:.2f} B "
        f"params, {torch.cuda.memory_allocated() / 2**30:.1f} GiB)")
    engine = ServeEngine(model, ctx_max=2048, block_size=16, q_block=16,
                         max_running=16, decode_buckets=(4, 16),
                         keep_logits=True)
    front = EngineFront(engine)
    # Warm-up (cuBLAS handles, allocator): one short request, outside
    # the counted window.
    front.generate([1, 2, 3, 4], 2)
    reqs = serve_mix(gen_seed, cfg.vocab)
    results = [None] * len(reqs)

    def worker(i):
        results[i] = front.generate(*reqs[i])

    torch.cuda.reset_peak_memory_stats()
    forwards0 = engine.forwards
    names = ("flash_decode", "int8_matmul")
    for name in names:
        LAUNCHES[name] = 0
    t_start = time.monotonic()
    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(reqs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.monotonic() - t_start
    launches = {name: LAUNCHES[name] for name in names}
    forwards = engine.forwards - forwards0
    if any(th.is_alive() for th in threads):
        raise AssertionError("serve phase did not finish")
    for (toks, max_new), c in zip(reqs, results):
        if c is None or len(c.tokens) != max_new:
            raise AssertionError(f"request did not complete with "
                                 f"{max_new} tokens: {c}")
    quantized = 7 * cfg.n_layers if "qkv" in cfg.quant_lanes() else 0
    expect = {"flash_decode": cfg.n_layers * forwards,
              "int8_matmul": quantized * forwards}
    if launches != expect or forwards == 0:
        raise AssertionError(f"launches {launches} != {expect} over "
                             f"{forwards} forwards")
    log(f"  16 requests done in {wall:.2f} s: {forwards} forwards, "
        f"launches {launches}")
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated()
    worst, near_ties, rows = decode_vs_prefill(engine, reqs, results, tol)
    gen_tokens = sum(len(c.tokens) for c in results)
    serve = {
        "model": "llama2-7b", "quant": quant, "requests": len(reqs),
        "prompt_tokens": sum(len(t) for t, _ in reqs),
        "generated_tokens": gen_tokens, "wall_s": wall,
        "decode_tokens_per_s": gen_tokens / wall,
        "ttft_p50_ms": stats["ttft_p50_ms"],
        "step_p50_ms": stats["step_p50_ms"],
        "forwards": forwards, "flash_decode_launches":
            launches["flash_decode"],
        "int8_matmul_launches": launches["int8_matmul"],
        "decode_vs_prefill_max_rel": worst, "decode_vs_prefill_tol": tol,
        "decode_vs_prefill_rows": rows, "near_tie_flips": near_ties,
        "max_memory_allocated": peak,
    }
    return serve, launches, engine, results


def serve_mix(seed: int, vocab: int):
    """The serve phases' 16 seeded requests: prompts of 16-512 tokens,
    16-64 new tokens each."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(16, 513))).tolist(),
             int(rng.integers(16, 65))) for _ in range(16)]


def decode_vs_prefill(engine, reqs, results, tol):
    """Decode vs the engine's own full prefill, for the shortest and the
    longest prompt: per row max|Δ| within ``tol``·max|ref|, and the
    greedy token the reference's argmax wherever the reference's top-two
    gap exceeds that tolerance. Returns the worst relative difference,
    the near-tie flips and the rows compared."""
    order = sorted(range(len(reqs)), key=lambda i: len(reqs[i][0]))
    worst, near_ties, rows = 0.0, 0, 0
    for i in (order[0], order[-1]):
        c = results[i]
        ref = engine.full_prefill_logits(list(c.prompt) + list(c.tokens))
        p = len(c.prompt)
        for j, row in enumerate(c.logits):
            r = ref[p - 1 + j]
            scale = float(np.abs(r).max())
            diff = float(np.abs(r - row).max())
            worst = max(worst, diff / scale)
            rows += 1
            top2 = np.sort(r)[-2:]
            if c.tokens[j] != int(np.argmax(r)):
                if top2[1] - top2[0] > tol * scale:
                    raise AssertionError(
                        f"request {c.rid}: greedy token at {p + j} "
                        f"differs from the full-prefill argmax")
                near_ties += 1
            if diff > tol * scale:
                raise AssertionError(
                    f"request {c.rid}: decode logits at {p - 1 + j} off "
                    f"the full prefill by {diff} > {tol}·{scale}")
    log(f"  decode vs full prefill: {rows} rows, max|Δ|/max|ref| = "
        f"{worst:.3e} (tol {tol}), near-tie token flips {near_ties}")
    return worst, near_ties, rows


def profile_decode(engine: ServeEngine, vocab: int, steps: int = 3):
    """Where a decode step's device time goes: 16 sequences of 256-token
    prompts join (not traced), then ``steps`` pure decode steps at the
    b=16 bucket run under torch.profiler. Returns device time by kernel
    name (ms per step, largest first), the step wall time and the
    device's idle share of it, or None when the trace holds no device
    events."""
    rng = np.random.default_rng(SEED + 1)
    from tony_tpu_torch.serve import Request
    for i in range(16):
        engine.submit(Request(rid=f"prof-{i}",
                              tokens=rng.integers(0, vocab, 256).tolist(),
                              max_new_tokens=steps + 2))
    engine.step()                     # joins + prefills + one decode
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0) / steps
    engine.run()
    by_name = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / steps
    if not by_name:
        return None
    busy = sum(by_name.values())
    groups = {}
    for key, ms in by_name.items():
        group = decode_group(key)
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "device_ms_by_group": groups,
            "top_kernels_ms_per_step": [[k[:80], v] for k, v in top]}


# Kernel-name fragments of the quantize passes (|x|, amax, the division
# by the scale, round, clip); the casts around them (bf16 -> f32, f32 ->
# int8) are PyTorch's generic copy kernels, counted as "casts".
QUANTIZE_NAMES = ("abs", "maxnan", "max_values", "div", "round", "clamp")


def decode_group(name: str) -> str:
    low = name.lower()
    if "int8_matmul" in low:
        return "int8_matmul"
    if "flash_decode" in low:
        return "flash_decode"
    if "indexselect" in low or "gather" in low:
        return "kv_gather"
    if any(w in low for w in ("gemm", "nvjet", "cutlass", "sm90_xmma",
                              "ampere", "cublas")):
        return "gemm"
    if any(w in low for w in QUANTIZE_NAMES):
        return "quantize"
    if "copy" in low:
        return "casts"
    return "other"


# ---------------------------------------------------------------------
# Flash attention (training): forward, backward dQ, backward dK/dV.
# ---------------------------------------------------------------------

# One shape per TPU launcher family (PERF.md rows 1-8) and the edges:
# (name, b, h, hkv, t, tk, d, causal, packed, rows, timed).
FLASH_SHAPES = [
    ("packed", 2, 32, 32, 2048, 2048, 128, True, True, "3/7", True),
    ("packed_gqa", 2, 32, 8, 2048, 2048, 128, True, True, "3/7 GQA", False),
    ("packed_t8192", 1, 32, 32, 8192, 8192, 128, True, True, "4/8", True),
    ("classic_d64", 2, 32, 32, 1024, 1024, 64, True, False, "2/6", True),
    ("classic_t8192", 1, 32, 32, 8192, 8192, 128, True, False, "1/5",
     True),
    ("ragged_t1000", 2, 32, 32, 1000, 1000, 128, True, True, "ragged",
     False),
    ("cross_t1000_tk1536", 2, 32, 32, 1000, 1536, 128, False, False,
     "non-causal t != tk", False),
]
FLASH_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
# The kernels behind each wrapper in bf16 (the timed type) and f32, how
# their products run, and the kernel each replaced in bf16 (its times are
# in PERF.md's kernel table, with the chip run that took them).
FLASH_KERNELS = {
    "flash_attention_fwd": {
        "kernel": "flash_fwd_mma_kernel (bf16); flash_fwd_kernel (f32)",
        "products": "bf16: mma.sync.m16n8k16 tensor cores, 32 query rows "
                    "a warp, ldmatrix, cp.async two-stage ring; f32: "
                    "CUDA-core FMAs",
        "replaced": "flash_fwd_kernel in bf16 (CUDA-core FMAs; f32 only "
                    "now)"},
    "flash_attention_bwd_dq": {
        "kernel": "flash_bwd_dq_mma_kernel (bf16); flash_bwd_dq_kernel "
                  "(f32)",
        "products": "bf16: mma.sync.m16n8k16 tensor cores, ldmatrix, "
                    "cp.async two-stage ring; f32: CUDA-core FMAs",
        "replaced": "flash_bwd_dq_kernel in bf16 (CUDA-core FMAs; f32 "
                    "only now)"},
    "flash_attention_bwd_dkv": {
        "kernel": "flash_bwd_dkv_mma_kernel (bf16); flash_bwd_dkv_kernel "
                  "(f32)",
        "products": "bf16: mma.sync.m16n8k16 tensor cores, ldmatrix, "
                    "cp.async two-stage ring; f32: CUDA-core FMAs",
        "replaced": "flash_bwd_dkv_kernel in bf16 (CUDA-core FMAs; f32 "
                    "only now)"},
}


def flash_inputs(b, h, hkv, t, tk, d, packed, dtype, gen):
    """q/k/v/dO as the model hands them to the kernels: [b, h, t, d]
    views of packed [b, t, h·d] projections, or contiguous [b, h, t, d]."""
    def make(n, length):
        if packed:
            x = torch.randn((b, length, n * d), generator=gen, device="cuda")
            return x.to(dtype).unflatten(2, (n, d)).transpose(1, 2)
        return torch.randn((b, n, length, d), generator=gen,
                           device="cuda").to(dtype)
    return make(h, t), make(hkv, tk), make(hkv, tk), make(h, t)


def output_tol(ref, dtype):
    """bf16: one bf16 ulp of the output's scale (kernel and plain round
    the same f32 math to bf16 at the same points, summed in another
    order); f32: 1e-5 of the output's scale (at least 1e-5 absolute)."""
    scale = float(ref.float().abs().max())
    if dtype == torch.float32:
        return F32_TOL * max(1.0, scale)
    return 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


def admitted_pairs(t, tk, causal):
    """(row, key) pairs the mask admits per (batch, head)."""
    if not causal:
        return t * tk
    return sum(min(i + 1, tk) for i in range(t))


def flash_bounds(b, h, hkv, t, tk, d, causal, dtype):
    """Least time per kernel for this run's inputs: the larger of the
    bytes it must move (inputs read once, outputs written once) over HBM
    bandwidth and its products' flops (2·d per admitted pair and product:
    forward S and P·V; dQ S, dO·Vᵀ and dS·K; dK/dV S, dO·Vᵀ, Pᵀ·dO and
    dSᵀ·Q) at the input type's peak."""
    es = torch.tensor([], dtype=dtype).element_size()
    pairs = b * h * admitted_pairs(t, tk, causal)
    q_side = b * h * t * d * es           # q, o, dO or dq
    kv_side = b * hkv * tk * d * es       # k, v, dk or dv
    rows = b * h * t * 4                  # lse or D, f32
    work = {
        "flash_attention_fwd": (2 * q_side + 2 * kv_side + rows, 2),
        "flash_attention_bwd_dq": (4 * q_side + 2 * kv_side + 2 * rows, 3),
        "flash_attention_bwd_dkv": (2 * q_side + 4 * kv_side + 2 * rows, 4),
    }
    out = {}
    for name, (nbytes, products) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 2.0 * d * products * pairs / PEAK_FLOPS[dtype]
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def plain_bwd(q, k, v, o, lse, do, causal, scale):
    dq, dsum = attn._flash_bwd_dq_plain(q, k, v, o, do, lse, causal, scale)
    dk, dv = attn._flash_bwd_dkv_plain(q, k, v, do, lse, dsum, causal,
                                       scale)
    return dq, dk, dv


def bwd_launchers(q, k, v, o, lse, do, causal, scale):
    """The two backward kernels as separate callables on fixed buffers
    (dK/dV reads the D the dQ launch wrote), for timing each alone."""
    lib = attn._attn_lib()
    code = attn._DTYPE_CODES[q.dtype]
    dims = attn._dims(q, k, causal, scale)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dsum = torch.empty(lse.shape, dtype=torch.float32, device=q.device)

    def run_dq():
        attn._launch(lib, "flash_attention_bwd_dq_launch",
                     "flash_attention_bwd_dq",
                     (code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                      dq.data_ptr(), dsum.data_ptr()), dims,
                     (q, k, v, o, do, dq))

    def run_dkv():
        attn._launch(lib, "flash_attention_bwd_dkv_launch",
                     "flash_attention_bwd_dkv",
                     (code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                      dk.data_ptr(), dv.data_ptr()), dims,
                     (q, k, v, do, dk, dv))
    run_dq()
    return run_dq, run_dkv


def check_flash(shape, dtype, gen, time_it=False):
    name, b, h, hkv, t, tk, d, causal, packed, rows, _ = shape
    q, k, v, do = flash_inputs(b, h, hkv, t, tk, d, packed, dtype, gen)
    scale = d ** -0.5
    out, lse = attn._flash_fwd_cuda(q, k, v, causal, scale)
    out2, lse2 = attn._flash_fwd_cuda(q, k, v, causal, scale)
    dq, dk, dv = attn._flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)
    again = attn._flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)
    ref_o, ref_lse = attn._flash_fwd_plain(q, k, v, causal, scale)
    ref_dq, ref_dk, ref_dv = plain_bwd(q, k, v, ref_o, ref_lse, do, causal,
                                       scale)
    torch.cuda.synchronize()
    if not (torch.equal(out2, out) and torch.equal(lse2, lse)):
        raise AssertionError(f"flash {name} {dtype}: O/LSE differ between "
                             f"two identical launches")
    del out2, lse2
    if not (torch.equal(again[0], dq) and torch.equal(again[1], dk)
            and torch.equal(again[2], dv)):
        raise AssertionError(f"flash {name} {dtype}: dQ/dK/dV differ "
                             f"between two identical launches")
    errs = {}
    for key, got, ref in (("o", out, ref_o), ("dq", dq, ref_dq),
                          ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        err = (got.float() - ref.float()).abs().max().item()
        tol = output_tol(ref, dtype)
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"flash {name} {dtype} {key}: kernel vs "
                                 f"plain max|Δ| {err} > {tol}")
        errs[key] = err
    lse_err = (lse - ref_lse).abs().max().item()
    lse_tol = F32_TOL * max(1.0, ref_lse.abs().max().item())
    if not lse_err <= lse_tol:
        raise AssertionError(f"flash {name} {dtype} lse: {lse_err} > "
                             f"{lse_tol}")
    errs["lse"] = lse_err
    log(f"  flash {name} ({rows}) {str(dtype)[6:]}: max|kernel - plain| o "
        f"{errs['o']:.2e} lse {lse_err:.2e} dq {errs['dq']:.2e} dk "
        f"{errs['dk']:.2e} dv {errs['dv']:.2e}; O/LSE/dQ/dK/dV "
        f"deterministic")
    res = {"shape": dict(b=b, h=h, hkv=hkv, t=t, tk=tk, d=d, causal=causal,
                         layout="packed" if packed else "classic",
                         dtype=str(dtype)[6:], rows=rows),
           "max_abs_err": errs}
    if not time_it:
        return res
    iters = 10 if t <= 2048 else 3
    run_dq, run_dkv = bwd_launchers(q, k, v, out, lse, do, causal, scale)
    dsum = (do.float() * out.float()).sum(dim=-1)
    times = {
        "flash_attention_fwd": (
            lambda: attn._flash_fwd_cuda(q, k, v, causal, scale),
            lambda: attn._flash_fwd_plain(q, k, v, causal, scale)),
        "flash_attention_bwd_dq": (
            run_dq, lambda: attn._flash_bwd_dq_plain(
                q, k, v, out, do, lse, causal, scale)),
        "flash_attention_bwd_dkv": (
            run_dkv, lambda: attn._flash_bwd_dkv_plain(
                q, k, v, do, lse, dsum, causal, scale)),
    }
    bounds = flash_bounds(b, h, hkv, t, tk, d, causal, dtype)
    # The library yardstick (never called by the port): SDPA's forward,
    # its backward alone (autograd.grad over a kept graph), and both.
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, enable_gqa=hkv != h)
    kept = sdpa()
    lib_fwd = cuda_ms(lambda: sdpa().detach(), iters=iters, warmup=2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        kept, (qs, ks, vs), do, retain_graph=True), iters=iters, warmup=2)
    lib_both = cuda_ms(lambda: torch.autograd.grad(
        sdpa(), (qs, ks, vs), do), iters=iters, warmup=2)
    res["sdpa_ms"] = {"fwd": lib_fwd, "bwd": lib_bwd, "fwd_bwd": lib_both}
    res["kernels"] = {}
    for kname, (kernel_fn, plain_fn) in times.items():
        ms = cuda_ms(kernel_fn, iters=iters, warmup=1)
        plain_ms = cuda_ms(plain_fn, iters=max(2, iters // 3), warmup=1)
        res["kernels"][kname] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[kname][0],
            "bound_by": bounds[kname][1],
            "library_ms": lib_fwd if kname.endswith("fwd") else lib_bwd}
        log(f"    {kname}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bounds[kname][0]:.4f} ms ({bounds[kname][1]})")
    log(f"    sdpa: fwd {lib_fwd:.3f} ms, bwd {lib_bwd:.3f} ms, fwd+bwd "
        f"{lib_both:.3f} ms")
    return res


# ---------------------------------------------------------------------
# Fused bucket optimizer update.
# ---------------------------------------------------------------------

# (rule, weight decay): AdamW with and without decay, SGD-momentum (0.9),
# Adafactor-style. Sizes: one element, a ragged 1000, and one w_gate
# bucket of the 7B (4096 x 11008); timed at that bucket and at the
# embedding bucket (32000 x 4096), f32 AdamW.
FUSED_RULES = (("adamw", 0.0), ("adamw", 1e-2), ("sgd", 0.0),
               ("adafactor", 0.0))
FUSED_SIZES = (1, 1000, 4096 * 11008)
FUSED_TIMED = (4096 * 11008, 32000 * 4096)
# AdamW's f32 operations per element without weight decay, and its
# bytes per element with f32 g, p and slots (4 read, 3 written).
ADAMW_FLOPS, ADAMW_BYTES = 14, 28


def fused_case(rule, wd, n, dtype, gen):
    fused = fo.FusedOptimizer(rule=rule, lr=TRAIN_LR, weight_decay=wd,
                              momentum=0.9)
    g = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(dtype)
    p = torch.randn(n, generator=gen, device="cuda").to(dtype)
    slots = [torch.rand(n, generator=gen, device="cuda") * 1e-3
             for _ in fused.slot_names]
    return fused, g, p, slots, fused.scalars(3, "cuda")


def fused_against_plain(fused, g, p, slots, scal, what):
    """One launch on clones of ``p`` and the slots against ``_rule_math``
    on the originals: ``torch.equal`` for p and every slot. Returns the
    max |kernel - plain| (0.0 when equal)."""
    kp, ks = p.clone(), [s.clone() for s in slots]
    fo.fused_bucket_update(g, kp, ks, scal, rule=fused.rule,
                           hyper=fused.hyper)
    rp, rs = fo._rule_math(fused.rule, g.float(), p.float(), tuple(slots),
                           scal[0], scal[1], scal[2], **fused.hyper)
    torch.cuda.synchronize()
    pairs = [(kp, rp.to(p.dtype))] + list(zip(ks, rs))
    err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"fused_bucket_update {what}: kernel differs "
                             f"from the plain version (max |Δ| {err})")
    return err


def adamw_bound(n):
    """f32 AdamW without decay over n elements: g, p, mu and nu read once,
    p, mu and nu written once, over HBM bandwidth; against its f32
    operations."""
    t_bytes = ADAMW_BYTES * n / HBM_BYTES_PER_S
    t_ops = ADAMW_FLOPS * n / PEAK_FLOPS[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_fused(gen):
    """Every rule and dtype against the plain version, then the timed
    sizes. Returns the max error and the timings."""
    worst = 0.0
    for rule, wd in FUSED_RULES:
        for dtype in (torch.float32, torch.bfloat16):
            for n in FUSED_SIZES:
                case = fused_case(rule, wd, n, dtype, gen)
                worst = max(worst, fused_against_plain(
                    *case, f"{rule} wd={wd} {dtype} n={n}"))
                del case
    log(f"  fused_bucket_update: {len(FUSED_RULES)} rules x f32/bf16 x n "
        f"{FUSED_SIZES}: kernel == plain (torch.equal, p and every slot)")
    timed = {}
    for n in FUSED_TIMED:
        fused, g, p, slots, scal = fused_case("adamw", 0.0, n,
                                              torch.float32, gen)
        ms = cuda_ms(lambda: fo.fused_bucket_update(
            g, p, slots, scal, rule="adamw", hyper=fused.hyper))
        plain_ms = cuda_ms(lambda: fo._rule_math(
            "adamw", g, p, tuple(slots), scal[0], scal[1], scal[2],
            **fused.hyper), iters=5)
        del slots
        # The library yardstick (timed only, never called by the port):
        # PyTorch's fused AdamW over one tensor of the same size.
        w = p.clone().requires_grad_()
        w.grad = g
        opt = torch.optim.AdamW([w], lr=TRAIN_LR, weight_decay=0.0,
                                fused=True)
        library_ms = cuda_ms(opt.step)
        bound_ms, bound_by = adamw_bound(n)
        timed[n] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms,
                    "gb_per_s": ADAMW_BYTES * n / ms / 1e6}
        log(f"    adamw f32 n={n}: kernel {ms:.4f} ms "
            f"({timed[n]['gb_per_s']:.0f} GB/s), plain {plain_ms:.4f} ms, "
            f"AdamW(fused=True) {library_ms:.4f} ms, bound {bound_ms:.4f} "
            f"ms ({bound_by})")
        del opt, w, g, p
        torch.cuda.empty_cache()
    return worst, timed


# ---------------------------------------------------------------------
# Train phase.
# ---------------------------------------------------------------------

TRAIN_LAYERS = 8          # of 32: f32 AdamW state for 32 would not fit
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 2048, 8, 3e-4
# One step's grads through the kernels against the same model with the
# plain attention on the card, per parameter ||g_k - g_p|| / ||g_p||.
# In f32 compute the two agree to 8.4e-6 (measured on one H100): 1e-4.
# In bf16 compute they differ by ~2% in EVERY parameter, lm_head and the
# final norm included: the attention's f32 summation order flips a few
# bf16 roundings, and the random-init 8-layer bf16 model carries that
# into every grad. The limit started at 2e-2 and measured 2.24e-2, so it
# is 5e-2; what holds the bf16 kernels to account is that their grads
# stand no farther from the f32-compute grads than the plain version's
# (measured 3.244e-2 vs 3.240e-2): at most 1.1x as far.
TRAIN_GRAD_REL_L2 = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
TRAIN_GRAD_VS_F32_RATIO = 1.1


@contextlib.contextmanager
def swapped(module, **attrs):
    """Set ``module``'s attributes for the block and restore them after:
    how the comparisons route a wrapper to its plain version on the card
    (there is no public switch)."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def plain_attention_on_the_card():
    """The autograd Function's kernels swapped for the plain versions."""
    return swapped(attn, _flash_fwd=attn._flash_fwd_plain,
                   _flash_bwd=plain_bwd)


def rel_l2(a, b):
    """Per parameter ||a - b|| / ||b|| (0 where both are exactly zero);
    raises on a non-finite value."""
    out = {}
    for name, gb in b.items():
        diff = (a[name].float() - gb.float()).norm()
        ref = gb.float().norm()
        rel = diff if float(ref) == 0.0 and float(diff) == 0.0 \
            else diff / ref
        out[name] = rel.item()
        if not math.isfinite(out[name]):
            raise AssertionError(f"train grads: {name} not finite")
    return out


def grads_both_ways(model, tokens):
    loss_k, g_k = one_step_grads(model, tokens)
    with plain_attention_on_the_card():
        loss_p, g_p = one_step_grads(model, tokens)
    return (loss_k, g_k), (loss_p, g_p)


def compare_grads(model, tokens):
    """One step's grads, kernels vs plain attention, in the model's bf16
    compute and in an f32-compute twin with the same parameters."""
    (loss_k, g_k), (loss_p, g_p) = grads_both_ways(model, tokens)
    twin = get_model("llama2-7b", device="cuda", seed=SEED,
                     n_layers=TRAIN_LAYERS, dtype=torch.float32)
    twin.load_state_dict(model.state_dict())
    (_, f_k), (loss_f, f_p) = grads_both_ways(twin, tokens)
    del twin
    out = {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_f32": loss_f}
    for tag, dtype, a, b in (("bf16", torch.bfloat16, g_k, g_p),
                             ("f32", torch.float32, f_k, f_p)):
        rel = rel_l2(a, b)
        worst = max(rel, key=rel.get)
        out[f"{tag}_kernel_vs_plain_max_rel_l2"] = rel[worst]
        out[f"{tag}_worst_param"] = worst
        log(f"  one step's grads ({tag} compute), kernels vs plain: max "
            f"relative L2 {rel[worst]:.3e} ({worst}; tol "
            f"{TRAIN_GRAD_REL_L2[dtype]})")
        if rel[worst] > TRAIN_GRAD_REL_L2[dtype]:
            raise AssertionError(f"train grads ({tag}): {worst} kernel vs "
                                 f"plain relative L2 {rel[worst]} > "
                                 f"{TRAIN_GRAD_REL_L2[dtype]}")
    k_far = max(rel_l2(g_k, f_p).values())
    p_far = max(rel_l2(g_p, f_p).values())
    out["bf16_kernel_vs_f32_max_rel_l2"] = k_far
    out["bf16_plain_vs_f32_max_rel_l2"] = p_far
    log(f"  bf16 grads vs the f32-compute grads: kernels {k_far:.4e}, plain "
        f"{p_far:.4e} (kernels at most {TRAIN_GRAD_VS_F32_RATIO}x as far); "
        f"losses kernel {loss_k:.6f} plain {loss_p:.6f} f32 {loss_f:.6f}")
    if k_far > TRAIN_GRAD_VS_F32_RATIO * p_far:
        raise AssertionError(f"train grads: bf16 kernels {k_far} from the "
                             f"f32 grads, plain {p_far}")
    return out


def one_step_grads(model, tokens):
    model.zero_grad(set_to_none=True)
    loss = next_token_loss(model(tokens), tokens)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def profile_train(step, state, batch, steps=2):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0) / steps
    by_name, counts = {}, {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / steps
        counts[e.key] = counts.get(e.key, 0) + e.count
    if not by_name:
        return None
    busy = sum(by_name.values())
    flash_launches = {key[:120]: n // steps for key, n in counts.items()
                      if "flash_" in key and "kernel" in key}
    groups = {"flash_attention": 0.0, "fused_update": 0.0, "gemm": 0.0,
              "int8_matmul": 0.0, "quantize": 0.0, "bn_kernels": 0.0,
              "conv": 0.0, "other": 0.0}
    for key, ms in by_name.items():
        low = key.lower()
        if any(w in low for w in ("bn_reduce_kernel", "bn_finalize_kernel",
                                  "bn_apply_kernel", "bn_dx_kernel")):
            groups["bn_kernels"] += ms
        elif any(w in low for w in ("fprop", "dgrad", "wgrad", "convolve",
                                    "cudnn")):
            groups["conv"] += ms
        elif "fused_bucket_update_kernel" in low:
            groups["fused_update"] += ms
        elif "int8_matmul" in low:
            groups["int8_matmul"] += ms
        elif any(w in low for w in ("round", "clamp", "abs", "maxnan",
                                    "max_values")):
            # The quantize passes but their division (AdamW divides too).
            groups["quantize"] += ms
        elif "flash_" in low and "kernel" in low and "pytorch" not in low:
            groups["flash_attention"] += ms
        elif any(w in low for w in ("gemm", "nvjet", "cutlass", "sm90_xmma",
                                    "ampere", "cublas")):
            groups["gemm"] += ms
        else:
            groups["other"] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "device_ms_by_group": groups,
            "flash_kernel_launches_per_step": flash_launches,
            "top_kernels_ms_per_step": [[k[:90], v] for k, v in top]}


# The bf16 kernels by the names the profiler gives them: the tensor-core
# forward and backward pair, and the CUDA-core kernels they replaced in
# bf16 (f32 only since).
MMA_FWD_KERNELS = ("flash_fwd_mma_kernel",)
CORE_FWD_KERNELS = ("flash_fwd_kernel",)
MMA_BWD_KERNELS = ("flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel")
CORE_BWD_KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def check_profiled(tag, prof, what, mma, core, per_step):
    """The profiled steps ran ``what`` in the tensor-core kernels ``mma``,
    ``per_step`` launches of each per step, and never in one of the
    CUDA-core kernels ``core``."""
    if prof is None:
        raise AssertionError(f"{tag}: the profiler traced no device event, "
                             f"so the {what} kernels cannot be named")
    launches = prof["flash_kernel_launches_per_step"]
    for name in mma:
        got = sum(n for key, n in launches.items() if name in key)
        if got != per_step:
            raise AssertionError(f"{tag}: {name} ran {got} times a step, "
                                 f"not {per_step}: {launches}")
    ran = [key for key in launches if any(name in key for name in core)]
    if ran:
        raise AssertionError(f"{tag}: a CUDA-core {what} kernel ran: {ran}")
    log(f"  profile: the {what} ran {', '.join(mma)} ({per_step} each a "
        f"step) and no CUDA-core {what} kernel")


def check_fwd_kernels(tag, prof, per_step):
    check_profiled(tag, prof, "forward", MMA_FWD_KERNELS, CORE_FWD_KERNELS,
                   per_step)


def check_bwd_kernels(tag, prof, per_step):
    check_profiled(tag, prof, "backward", MMA_BWD_KERNELS, CORE_BWD_KERNELS,
                   per_step)


def timed_steps(tag, step, state, batch, names, expect, steps):
    """``steps`` steps, the launch counts of ``names`` set to 0 just
    before and read just after (they must equal ``expect``), the loss
    finite and falling; then a two-step profile. Returns the losses,
    grad norms, step times, p50, peak memory, launches and profile."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in names:
        LAUNCHES[name] = 0
    losses, step_ms, gnorms = [], [], []
    for _ in range(steps):
        t1 = time.monotonic()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))      # syncs
        step_ms.append(1e3 * (time.monotonic() - t1))
        gnorms.append(float(metrics["grad_norm"]))
    launches = {name: LAUNCHES[name] for name in names}
    peak = torch.cuda.max_memory_allocated()
    log(f"  losses {[round(x, 4) for x in losses]}; step ms "
        f"{[round(x, 1) for x in step_ms]}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"{tag}: non-finite loss or grad norm: "
                             f"{losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss did not fall: {losses}")
    if launches != expect:
        raise AssertionError(f"{tag}: launches {launches} != {expect}")
    log(f"  launches {launches} (= expected); peak memory "
        f"{peak / 1e9:.1f} GB")
    log(f"[{tag} profile]")
    prof = profile_train(step, state, batch)
    log(f"  {json.dumps(prof) if prof else 'no device events traced'}")
    if "flash_attention_fwd" in names:
        check_fwd_kernels(tag, prof, expect["flash_attention_fwd"] // steps)
        check_bwd_kernels(tag, prof, expect["flash_attention_bwd_dq"] // steps)
    return {"steps": steps, "losses": losses, "grad_norms": gnorms,
            "step_ms": step_ms, "step_p50_ms": float(np.median(step_ms)),
            "max_memory_allocated": peak, "launches": launches,
            "profile": prof}


def drive_steps(tag, cfg, step, state, batch, names, expect):
    """TRAIN_STEPS decoder steps through :func:`timed_steps`, with
    tokens/s and MFU. Returns the step numbers of the phase's report
    line."""
    run = timed_steps(tag, step, state, batch, names, expect, TRAIN_STEPS)
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (run["step_p50_ms"] / 1e3)
    flops_tok = dataclasses.replace(cfg, max_seq=TRAIN_SEQ).flops_per_token()
    return {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR, **run,
            "tokens_per_s": tokens_per_s, "flops_per_token": flops_tok,
            "mfu": tokens_per_s * flops_tok / PEAK_FLOPS[torch.bfloat16]}


def train_phase(card: str):
    t0 = time.monotonic()
    model = get_model("llama2-7b", device="cuda", seed=SEED,
                      n_layers=TRAIN_LAYERS)
    cfg = model.cfg
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  llama2-7b x{TRAIN_LAYERS} layers built in "
        f"{time.monotonic() - t0:.1f} s ({n_params / 1e9:.3f} B f32 params; "
        f"attention={cfg.attention}, remat={cfg.remat})")
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (TRAIN_BATCH, TRAIN_SEQ)),
                             device="cuda")
    grads_check = compare_grads(model, tokens)
    gc.collect()
    torch.cuda.empty_cache()

    state = create_train_state(model, adamw(TRAIN_LR))
    step = make_train_step(
        loss_of=lambda logits, batch: next_token_loss(logits, batch["x"]))
    # Remat: the attention forward runs twice per layer and step.
    expect = {"flash_attention_fwd": 2 * TRAIN_LAYERS * TRAIN_STEPS,
              "flash_attention_bwd_dq": TRAIN_LAYERS * TRAIN_STEPS,
              "flash_attention_bwd_dkv": TRAIN_LAYERS * TRAIN_STEPS}
    run = drive_steps("train", cfg, step, state, {"x": tokens}, FLASH_NAMES,
                      expect)
    train = {"model": f"llama2-7b n_layers={TRAIN_LAYERS}/32",
             "params": n_params, **run, "grads_check": grads_check,
             "card": card}
    return train, run["launches"]


# One update launch per bucket per step; under remat the attention
# forward runs twice per layer and microbatch, the backward once.
FUSED_MICROBATCHES, FUSED_WD = 2, 1e-4
# The first loss is the mean of the two microbatch means of the train
# phase's first batch, from the same weights: within 1e-2 relative.
FUSED_FIRST_LOSS_REL = 1e-2


def check_real_buckets(state):
    """The last step's real buckets (its mean-scaled grads, the parameters
    and slots) through the kernel and through the plain version with the
    next step's scalars, bucket by bucket: ``torch.equal``."""
    fused, res = state.tx, state.buckets
    scal = fused.scalars(state.opt_state["count"] + 1, "cuda")
    worst = 0.0
    for b in range(res.plan.n_buckets):
        slots = [state.opt_state["slots"][n][b] for n in fused.slot_names]
        worst = max(worst, fused_against_plain(
            fused, res.grad_bufs[b], res.param_bufs[b], slots, scal,
            f"train bucket {b}"))
    return worst


def train_fused_phase(card: str, first_loss: float):
    t0 = time.monotonic()
    model = get_model("llama2-7b", device="cuda", seed=SEED,
                      n_layers=TRAIN_LAYERS)
    cfg = model.cfg
    fused = fo.FusedOptimizer(rule="adamw", lr=TRAIN_LR,
                              weight_decay=FUSED_WD)
    state = create_train_state(model, fused)
    plan = state.buckets.plan
    torch.cuda.synchronize()
    log(f"  llama2-7b x{TRAIN_LAYERS} in {plan.n_buckets} buckets "
        f"(bucket_bytes {fused.bucket_bytes}) built in "
        f"{time.monotonic() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (TRAIN_BATCH, TRAIN_SEQ)),
                             device="cuda")
    step = make_accum_train_step(
        lambda logits, batch: next_token_loss(logits, batch["x"]),
        microbatches=FUSED_MICROBATCHES, update="fused_bucket")
    per_step = TRAIN_LAYERS * FUSED_MICROBATCHES * TRAIN_STEPS
    expect = {"flash_attention_fwd": 2 * per_step,
              "flash_attention_bwd_dq": per_step,
              "flash_attention_bwd_dkv": per_step,
              "fused_bucket_update": plan.n_buckets * TRAIN_STEPS}
    run = drive_steps("train_fused", cfg, step, state, {"x": tokens},
                      FLASH_NAMES + ("fused_bucket_update",), expect)
    losses = run["losses"]
    rel = abs(losses[0] - first_loss) / abs(first_loss)
    if not rel <= FUSED_FIRST_LOSS_REL:
        raise AssertionError(f"train_fused: first loss {losses[0]} vs the "
                             f"train phase's {first_loss} (rel {rel})")
    state.buckets.check()
    log(f"  every parameter and grad still in its bucket; first loss "
        f"{losses[0]:.6f} vs train {first_loss:.6f} (rel {rel:.2e})")
    bucket_err = check_real_buckets(state)
    log(f"  one step's {plan.n_buckets} real buckets: kernel == plain "
        f"(torch.equal)")
    return {
        "model": f"llama2-7b n_layers={TRAIN_LAYERS}/32",
        "params": sum(plan.bucket_numel), "n_buckets": plan.n_buckets,
        "bucket_bytes": fused.bucket_bytes,
        "microbatches": FUSED_MICROBATCHES, "weight_decay": FUSED_WD,
        **run, "first_loss_vs_train_rel": rel,
        "real_buckets_max_abs_err": bucket_err, "card": card,
    }


# ---------------------------------------------------------------------
# Int8 matmul (kernel row 15) and the quantized lane.
# ---------------------------------------------------------------------

# (name, M, K, N): the quant lane's projections of the 7B on each path
# (decode: the b=16 bucket x q_block 16 rows; prefill: 16 and 512 rows;
# train: 2 x 2048 rows; the lm_head lane at decode; the engine's b=4
# decode bucket), then ragged edges (the mma.sync path).
INT8_SHAPES = [
    ("decode_qkvo", 256, 4096, 4096), ("decode_gate_up", 256, 4096, 11008),
    ("decode_down", 256, 11008, 4096), ("prefill16_qkvo", 16, 4096, 4096),
    ("prefill512_qkvo", 512, 4096, 4096),
    ("prefill512_gate_up", 512, 4096, 11008),
    ("prefill512_down", 512, 11008, 4096), ("train_qkvo", 4096, 4096, 4096),
    ("train_gate_up", 4096, 4096, 11008), ("train_down", 4096, 11008, 4096),
    ("lm_head", 256, 4096, 32000), ("decode_b4_qkvo", 64, 4096, 4096),
    ("decode_b4_down", 64, 11008, 4096), ("ragged_1x1x1", 1, 1, 1),
    ("ragged_33x70x130", 33, 70, 130), ("ragged_17x4099x257", 17, 4099, 257),
]
# Decode against the engine's own full prefill on the quant lane: the
# activation scale spans every row of a launch (the decode block's 15
# padding rows, a prefill's pad tail), so decode and prefill quantize a
# row with different scales — quantization noise, not rounding. Set
# before the first chip run from exp/port_quant_noise.py on the CPU
# (dim 256, bf16, 4-32 layers: 0.11-0.19 of the row's max|ref|); the
# same mix at full width on an H100 reads 0.13-0.14 at 4-32 layers, and
# this phase's own mix (prompts up to 512 tokens) reads 0.263 there.
SERVE_QUANT_REL_TOL = 0.3
# First quantized training loss against the train phase's, relative.
QUANT_FIRST_LOSS_REL = 5e-2


def int8_inputs(m, k, n, gen):
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    sx = torch.rand((), generator=gen, device="cuda") * 1e-2
    sw = torch.rand((n,), generator=gen, device="cuda") * 1e-2
    return xq, wq, sx, sw


def int8_bound(m, k, n):
    """xq, wq, sx and sw read once, f32 out written once, over HBM
    bandwidth; against 2·M·N·K integer operations at the int8 peak."""
    nbytes = m * k + n * k + 4 * m * n + 4 * n + 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * m * n * k / PEAK_INT8_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def int_mm_rescale(xq, wq, sx, sw):
    """The library yardstick (timed here only; the port never calls it):
    cuBLASLt's int8 GEMM through ``torch._int_mm`` plus the rescale."""
    return tq._rescale(torch._int_mm(xq, wq.t()), sx, sw)


# Forced split counts held torch.equal at every int8 shape.
INT8_SPLITS = (1, 2, 4, 8)
# Calls with a cold L2 rotate over weight copies that together hold
# twice the H100's 50 MB L2: a decode layer's weights are never hot in
# the real step.
COLD_L2_BYTES = 100e6


def host_us(fn, calls: int = 200, rounds: int = 5) -> float:
    """Host µs a call: the median over ``rounds`` of ``calls`` calls
    enqueued back to back with no synchronize between them (fewer
    launches than the card's queue holds), so the host's own time
    whatever the card's."""
    fn()
    per_round = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_round.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * sorted(per_round)[rounds // 2] / calls


def weight_copies(wq, gen):
    """``wq`` and random copies of its shape, ``COLD_L2_BYTES`` or more
    together."""
    n, k = wq.shape
    return [wq] + [torch.randint(-127, 128, (n, k), generator=gen,
                                 device="cuda", dtype=torch.int8)
                   for _ in range(max(2, math.ceil(COLD_L2_BYTES
                                                   / (n * k))) - 1)]


def rotating(fn, xq, copies, sx, sw):
    """A call of ``fn(xq, wq, sx, sw)`` that reads the next of the weight
    ``copies`` each time, so its weight is cold in L2."""
    turn = [0]

    def call():
        turn[0] += 1
        return fn(xq, copies[turn[0] % len(copies)], sx, sw)
    return call


def cold_int8_ms(xq, wq, sx, sw, gen):
    """(ms back to back, ms on the card alone, copies) of
    ``int8_matmul`` with the weight cold in L2 (:func:`rotating`)."""
    copies = weight_copies(wq, gen)
    call = rotating(tq.int8_matmul, xq, copies, sx, sw)
    ms = cuda_ms(call, iters=10 * len(copies))
    device = cuda_graph_ms(call, reps=2 * len(copies))
    return ms, device, len(copies)


def record_int8_paths():
    """``tq._int8_plan`` wrapped for the block: the paths it chose, to
    hold the lane's shapes to the wgmma path."""
    paths = []
    plan = tq._int8_plan

    def recording(*args):
        out = plan(*args)
        paths.append(out.path)
        return out
    return paths, swapped(tq, _int8_plan=recording)


def check_int8(gen):
    """Every shape against the plain version with ``torch.equal``, as
    planned and at forced split counts; every shape but the ragged ones
    on the wgmma path. The path shapes timed beside their bound, the
    plain version, the library yardstick and the bf16 ``F.linear`` the
    lane replaces: back to back, on the card alone (a CUDA graph) and,
    where M <= 512, with a cold L2; the host µs a call."""
    out = {}
    dev = torch.cuda.current_device()
    for name, m, k, n in INT8_SHAPES:
        xq, wq, sx, sw = int8_inputs(m, k, n, gen)
        y = tq.int8_matmul(xq, wq, sx, sw)
        ref = tq._int8_matmul_plain(xq, wq, sx, sw)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        if not torch.equal(y, ref):
            raise AssertionError(f"int8_matmul {name} ({m}x{k}x{n}): kernel "
                                 f"differs from the plain version (max "
                                 f"|Δ| {err})")
        plan = tq._int8_plan(m, n, k, tq._sms(dev), k, k, True)
        want = "mma_sync" if name.startswith("ragged") else "wgmma"
        if plan.path != want:
            raise AssertionError(f"int8_matmul {name}: planned on the "
                                 f"{plan.path} path, not {want}")
        forced = {}
        for s in INT8_SPLITS:
            ys = tq._int8_matmul_cuda(xq, wq, sx, sw, splits=s)
            torch.cuda.synchronize()
            if not torch.equal(ys, ref):
                raise AssertionError(f"int8_matmul {name}: {s} forced "
                                     f"splits differ from the plain version")
            forced[s] = tq._int8_plan(m, n, k, tq._sms(dev), k, k, True,
                                      s).splits
        res = {"m": m, "k": k, "n": n, "max_abs_err": err,
               "plan": plan._asdict(), "forced_splits_equal": forced}
        if not name.startswith("ragged"):
            iters = 10 if m * n * k > 1e11 else 50
            call = lambda: tq.int8_matmul(xq, wq, sx, sw)  # noqa: E731
            res["ms"] = cuda_ms(call, iters=iters)
            res["device_ms"] = cuda_graph_ms(call)
            res["host_us"] = host_us(call)
            res["plain_ms"] = cuda_ms(
                lambda: tq._int8_matmul_plain(xq, wq, sx, sw), iters=3,
                warmup=1)
            res["bound_ms"], res["bound_by"] = int8_bound(m, k, n)
            if m <= tq._SMALL_M:
                (res["cold_ms"], res["cold_device_ms"],
                 res["cold_copies"]) = cold_int8_ms(xq, wq, sx, sw, gen)
                res["bound_share_cold"] = (res["bound_ms"]
                                           / res["cold_device_ms"])
            res["bound_share"] = res["bound_ms"] / res["device_ms"]
            try:
                lib = int_mm_rescale(xq, wq, sx, sw)
            except RuntimeError as exc:     # shape rules of _int_mm
                res["library_ms"] = None
                res["library_refused"] = str(exc).splitlines()[0][:160]
            else:
                res["library_equal"] = bool(torch.equal(lib, y))
                res["library_ms"] = cuda_ms(
                    lambda: int_mm_rescale(xq, wq, sx, sw), iters=iters)
                res["library_device_ms"] = cuda_graph_ms(
                    lambda: int_mm_rescale(xq, wq, sx, sw))
            xb = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            wb = torch.randn((n, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            res["bf16_linear_ms"] = cuda_ms(
                lambda: torch.nn.functional.linear(xb, wb), iters=iters)
            res["tops"] = 2.0 * m * n * k / res["device_ms"] / 1e9
            cold = (f", cold L2 {res['cold_ms']:.4f} ms "
                    f"({res['cold_device_ms']:.4f} alone, "
                    f"{100 * res['bound_share_cold']:.0f}% of bound)"
                    if "cold_ms" in res else "")
            log(f"  int8_matmul {name} {m}x{k}x{n} [{plan.path} "
                f"{plan.tile[0]}x{plan.tile[1]}, {plan.splits} splits]: "
                f"kernel {res['ms']:.4f} ms "
                f"({res['device_ms']:.4f} alone, {res['tops']:.0f} TOP/s, "
                f"{100 * res['bound_share']:.0f}% of bound){cold}, host "
                f"{res['host_us']:.1f} µs a call, plain "
                f"{res['plain_ms']:.3f} ms, _int_mm+rescale "
                f"{res['library_ms']}, bf16 linear "
                f"{res['bf16_linear_ms']:.4f} ms, bound "
                f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
            del xb, wb
        out[name] = res
        del xq, wq, sx, sw, y, ref
    torch.cuda.empty_cache()
    log(f"  int8_matmul: {len(INT8_SHAPES)} shapes, kernel == plain "
        f"(torch.equal) as planned and at {INT8_SPLITS} forced splits; the "
        f"ragged ones on mma.sync, the rest on wgmma")
    return out


def quantize_costs(cfg, m, gen):
    """Device ms per serve forward of the lane's parts at ``m`` rows,
    timed apart with CUDA events: re-quantizing every bf16 weight (amax,
    scale, quantize), quantizing the activations, and the int8 kernel —
    per projection shape, times its count in a layer, times the layers."""
    shapes = {(cfg.dim, cfg.dim): 4, (cfg.ffn_hidden, cfg.dim): 2,
              (cfg.dim, cfg.ffn_hidden): 1}     # (N, K): wq/wk/wv/wo ...
    parts = {"weight_quantize": 0.0, "act_quantize": 0.0, "int8_matmul": 0.0}
    for (n, k), count in shapes.items():
        w = torch.randn((n, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        (wq, sw), (xq, sx) = tq._quantize_weight(w, True), tq._quantize_act(x)
        per = count * cfg.n_layers
        parts["weight_quantize"] += per * cuda_ms(
            lambda: tq._quantize_weight(w, True))
        parts["act_quantize"] += per * cuda_ms(lambda: tq._quantize_act(x))
        parts["int8_matmul"] += per * cuda_ms(
            lambda: tq.int8_matmul(xq, wq, sx, sw))
        del w, x, wq, xq
    # What the same 7 x layers projections would read as bf16 weights.
    weight_bytes = 2 * cfg.n_layers * sum(n * k * c for (n, k), c in
                                          shapes.items())
    parts["weight_bf16_read_bound_ms"] = 1e3 * weight_bytes / HBM_BYTES_PER_S
    return parts


def plain_int8_on_the_card():
    """``int8_matmul`` on CUDA tensors swapped for its plain version."""
    return swapped(tq, _int8_matmul_cuda=tq._int8_matmul_plain)


def serve_forward(model, b, t, ctx, seed, prefill):
    """One serve-mode forward at engine shapes with per-layer KV buffers
    made from ``seed`` (the same bits on every call)."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (b, t), generator=gen, device="cuda")
    if prefill:
        p0 = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    else:
        p0 = torch.randint(0, ctx - t, (b, 1), generator=gen, device="cuda",
                           dtype=torch.int32)
    positions = p0 + torch.arange(t, dtype=torch.int32, device="cuda")[None]
    kvd = cfg.n_kv_heads * cfg.head_dim

    def layer_kv(i):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + i)
        return tuple(torch.randn((b, ctx, kvd), generator=g, device="cuda")
                     .to(cfg.dtype) for _ in range(2))
    logits, _ = model(tokens, positions=positions, kv=layer_kv)
    return logits


def serve_kernel_vs_plain(model):
    """One prefill (1 x 512) and one decode (16 x 16, ctx 2048) forward
    through the kernel and through the plain version: ``torch.equal``."""
    out = {}
    for name, shape in (("prefill", (1, 512, 512, True)),
                        ("decode", (16, 16, 2048, False))):
        b, t, ctx, prefill = shape
        paths, recording = record_int8_paths()
        with recording:
            kernel = serve_forward(model, b, t, ctx, SEED + 7, prefill)
        if not paths or set(paths) != {"wgmma"}:
            raise AssertionError(f"serve_quant {name}: int8 paths {paths}")
        with plain_int8_on_the_card():
            plain = serve_forward(model, b, t, ctx, SEED + 7, prefill)
        torch.cuda.synchronize()
        if not torch.equal(kernel, plain):
            raise AssertionError(
                f"serve_quant {name}: logits through the kernel differ from "
                f"the plain version (max |Δ| "
                f"{(kernel - plain).abs().max().item()})")
        out[name] = {"b": b, "t": t, "ctx": ctx, "equal": True}
    log("  one prefill and one decode forward: kernel == plain logits "
        "(torch.equal), every int8 call on the wgmma path")
    return out


def distance_to_unquantized(results, reference):
    """Per request, the generated rows while both runs' tokens agree:
    max|Δ|/max|ref| against the unquantized serve phase's logits."""
    rels, first_equal = [], 0
    for c, r in zip(results, reference):
        first_equal += int(c.tokens[0] == r.tokens[0])
        for j, (a, b) in enumerate(zip(c.logits, r.logits)):
            rels.append(float(np.abs(a - b).max() / np.abs(b).max()))
            if c.tokens[j] != r.tokens[j]:
                break
    return {"rows": len(rels), "max_rel": max(rels),
            "median_rel": float(np.median(rels)),
            "first_token_equal": first_equal, "requests": len(results)}


def serve_quant_phase(reference):
    serve, launches, engine, results = serve_phase(
        SEED, quant=True, tol=SERVE_QUANT_REL_TOL)
    model = engine.model
    serve["vs_unquantized"] = distance_to_unquantized(results, reference)
    log(f"  vs the unquantized serve phase: {serve['vs_unquantized']}")
    serve["kernel_vs_plain"] = serve_kernel_vs_plain(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    serve["decode_forward_parts_ms"] = quantize_costs(model.cfg, 256, gen)
    log(f"  decode forward (256 rows) by part: "
        f"{serve['decode_forward_parts_ms']}")
    log("[serve_quant profile]")
    prof = profile_decode(engine, model.cfg.vocab)
    log(f"  {json.dumps(prof) if prof else 'no device events traced'}")
    serve["decode_profile"] = prof
    return serve, launches


def train_quant_phase(card: str, first_loss: float):
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train_quant: TF32 matmuls are on; the STE "
                             "backward must be f32 as on the CPU")
    t0 = time.monotonic()
    model = get_model("llama2-7b", device="cuda", seed=SEED,
                      n_layers=TRAIN_LAYERS, quant=True)
    cfg = model.cfg
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  llama2-7b x{TRAIN_LAYERS} layers, quant=True, built in "
        f"{time.monotonic() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (TRAIN_BATCH, TRAIN_SEQ)),
                             device="cuda")
    paths, recording = record_int8_paths()
    with recording:
        loss_k, g_k = one_step_grads(model, tokens)
    if not paths or set(paths) != {"wgmma"}:
        raise AssertionError(f"train_quant: int8 paths {sorted(set(paths))}")
    with plain_int8_on_the_card():
        loss_p, g_p = one_step_grads(model, tokens)
    unequal = [n for n in g_k if not torch.equal(g_k[n], g_p[n])]
    if loss_k != loss_p or unequal:
        raise AssertionError(f"train_quant: kernel vs plain loss {loss_k} / "
                             f"{loss_p}, grads differ in {unequal[:4]}")
    log(f"  one step's loss ({loss_k:.6f}) and all {len(g_k)} grads: kernel "
        f"== plain (torch.equal); {len(paths)} int8 calls, all on wgmma")
    del g_k, g_p
    gc.collect()
    torch.cuda.empty_cache()

    state = create_train_state(model, adamw(TRAIN_LR))
    step = make_train_step(
        loss_of=lambda logits, batch: next_token_loss(logits, batch["x"]))
    # Remat: each layer's forward runs twice per step (attention and the
    # seven quantized projections), the attention backward once.
    per_step = TRAIN_LAYERS * TRAIN_STEPS
    expect = {"flash_attention_fwd": 2 * per_step,
              "flash_attention_bwd_dq": per_step,
              "flash_attention_bwd_dkv": per_step,
              "int8_matmul": 7 * 2 * per_step}
    run = drive_steps("train_quant", cfg, step, state, {"x": tokens},
                      FLASH_NAMES + ("int8_matmul",), expect)
    losses = run["losses"]
    rel = abs(losses[0] - first_loss) / abs(first_loss)
    if not rel <= QUANT_FIRST_LOSS_REL:
        raise AssertionError(f"train_quant: first loss {losses[0]} vs the "
                             f"train phase's {first_loss} (rel {rel})")
    log(f"  first loss {losses[0]:.6f} vs train {first_loss:.6f} (rel "
        f"{rel:.2e})")
    return {
        "model": f"llama2-7b n_layers={TRAIN_LAYERS}/32 quant=True",
        "params": n_params, **run, "first_loss_vs_train_rel": rel,
        "kernel_vs_plain_loss_and_grads_equal": True, "card": card,
    }


# ---------------------------------------------------------------------
# Fused BatchNorm (kernel rows 10-13) and ResNet-50 training.
# ---------------------------------------------------------------------

# (name, N, H, W, C): three of ResNet-50's BN inputs at batch 256 — the
# stem (112² x 64), stage 1's block exit (56² x 256) and stage 4 (7² x
# 2048) — checked in f32 and timed in bf16, then a ragged M with a C that
# is not a power of two. Every distinct BN input of the main path is
# checked in bf16 besides (resnet_bn_inputs).
BN_SHAPES = [("stem", 256, 112, 112, 64), ("stage1_exit", 256, 56, 56, 256),
             ("stage4", 256, 7, 7, 2048), ("ragged", 1, 1, 1000003, 96)]
BN_TIMED = ("stem", "stage1_exit", "stage4")
BN_MAIN = "stage1_exit"
BN_EPS = 1e-5
# Reductions against their plain versions: another summation order, so
# |Δ| within 1e-5 of each sum's scale (the sum of its terms' magnitudes,
# which bounds f32 summation error); elementwise passes bitwise.
BN_SUM_REL = 1e-5
# Rows 10-13 by wrapper: (TPU kernel line, row).
BN_NAMES = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx",
            "bn_add_bwd_reduce", "bn_add_bwd_dx")
BN_REPLACES = {"bn_stats": (58, 10), "bn_apply": (98, 11),
               "bn_bwd_reduce": (114, 12), "bn_bwd_dx": (157, 12),
               "bn_add_bwd_reduce": (135, 13), "bn_add_bwd_dx": (168, 13)}
# Elements of [M, C] each timed variant reads and writes (relu=True; the
# residual variants read the residual and, in dx, write dres), and its
# f32 operations per element.
BN_TRAFFIC = {"bn_stats": (1, 3), "bn_apply": (2, 6),
              "bn_bwd_reduce": (2, 10), "bn_bwd_dx": (3, 12),
              "bn_add_bwd_reduce": (3, 11), "bn_add_bwd_dx": (5, 13)}


def bn_case(n, h, w, c, dtype, gen):
    m = n * h * w
    x = (torch.randn((m, c), generator=gen, device="cuda") * 2 + 0.5).to(
        dtype)
    res = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1.0
    beta = torch.randn(c, generator=gen, device="cuda") * 0.1
    mean, var = bn._batch_stats(bn._stats_plain(x), m)
    return x, res, dy, mean, var, gamma, beta


def sum_rel(got, ref, scale):
    return float(((got - ref).abs() / scale.clamp_min(1e-30)).max())


def equal_twice(fn, what):
    """Two runs of a kernel give the same bits (one tensor or a tuple)."""
    a, b = fn(), fn()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for u, v in zip(a, b):
        if u is not None and not torch.equal(u, v):
            raise AssertionError(f"{what}: two runs differ")


def check_bn_case(name, shape, dtype, gen):
    """Rows 10-13 against their plain versions at one shape: the
    reductions within BN_SUM_REL of their sums' scale, the elementwise
    passes torch.equal, with and without the residual and the ReLU; two
    runs of every kernel torch.equal. Returns the worst errors."""
    x, res, dy, mean, var, gamma, beta = bn_case(*shape, dtype, gen)
    m = x.shape[0]
    chans = (mean, var, gamma, beta)
    out = {"max_abs_err": {}, "sum_rel": {}}

    def note(kernel, err, rel=None):
        out["max_abs_err"][kernel] = max(out["max_abs_err"].get(kernel, 0.0),
                                         err)
        if rel is not None:
            out["sum_rel"][kernel] = max(out["sum_rel"].get(kernel, 0.0), rel)

    sums = bn._stats_cuda(x)
    ref = bn._stats_plain(x)
    xd = x.double()
    scale = torch.stack([xd.abs().sum(0), (xd * xd).sum(0)]).float()
    del xd
    rel = sum_rel(sums, ref, scale)
    note("bn_stats", (sums - ref).abs().max().item(), rel)
    if rel > BN_SUM_REL:
        raise AssertionError(f"bn_stats {name} {dtype}: {rel} > {BN_SUM_REL}")
    equal_twice(lambda: bn._stats_cuda(x), f"bn_stats {name}")
    for r in (None, res):
        red_name = "bn_bwd_reduce" if r is None else "bn_add_bwd_reduce"
        dx_name = "bn_bwd_dx" if r is None else "bn_add_bwd_dx"
        for relu in (True, False):
            what = f"{name} {str(dtype)[6:]} residual={r is not None} " \
                   f"relu={relu}"
            o = bn._apply_cuda(x, *chans, r, BN_EPS, relu)
            o_p = bn._apply_plain(x, *chans, r, BN_EPS, relu)
            note("bn_apply", (o.float() - o_p.float()).abs().max().item())
            if not torch.equal(o, o_p):
                raise AssertionError(f"bn_apply {what}: differs from plain")
            equal_twice(lambda: bn._apply_cuda(x, *chans, r, BN_EPS, relu),
                        f"bn_apply {what}")
            del o, o_p
            red = bn._bwd_reduce_cuda(dy, x, *chans, r, BN_EPS, relu)
            red_p = bn._bwd_reduce_plain(dy, x, *chans, r, BN_EPS, relu)
            pre, xhat, _ = bn._pre_act(x, *chans, BN_EPS)
            g = bn._masked_grad(dy, pre, r, relu)
            del pre
            scale = torch.stack([g.abs().sum(0, dtype=torch.float64),
                                 (g * xhat).abs().sum(0, dtype=torch.float64)
                                 ]).float()
            del g, xhat
            rel = sum_rel(red, red_p, scale)
            note(red_name, (red - red_p).abs().max().item(), rel)
            if rel > BN_SUM_REL:
                raise AssertionError(f"{red_name} {what}: {rel} > "
                                     f"{BN_SUM_REL}")
            equal_twice(lambda: bn._bwd_reduce_cuda(dy, x, *chans, r, BN_EPS,
                                                    relu), f"{red_name} {what}")
            dx, dres = bn._bwd_dx_cuda(dy, x, *chans, red_p, r, BN_EPS, relu,
                                       1.0 / m)
            dx_p, dres_p = bn._bwd_dx_plain(dy, x, *chans, red_p, r, BN_EPS,
                                            relu, 1.0 / m)
            err = (dx.float() - dx_p.float()).abs().max().item()
            same = torch.equal(dx, dx_p)
            if r is not None:
                err = max(err, (dres.float() - dres_p.float()).abs().max()
                          .item())
                same = same and torch.equal(dres, dres_p)
            note(dx_name, err)
            if not same:
                raise AssertionError(f"{dx_name} {what}: differs from plain "
                                     f"(max |Δ| {err})")
            equal_twice(lambda: bn._bwd_dx_cuda(dy, x, *chans, red_p, r,
                                                BN_EPS, relu, 1.0 / m),
                        f"{dx_name} {what}")
            del dx, dres, dx_p, dres_p, red, red_p
    torch.cuda.synchronize()
    return out


def bn_bound(name, m, c, itemsize):
    """Bytes each input is read once and each output written once (the
    [M, C] tensors plus the [C] and [2, C] vectors), over HBM bandwidth;
    against the pass's f32 operations at the f32 peak."""
    elems, ops = BN_TRAFFIC[name]
    nbytes = elems * m * c * itemsize + 8 * 4 * c
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops * m * c / PEAK_FLOPS[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_bn(shape, gen):
    """bf16, relu=True, at one ResNet-50 shape: each kernel beside its
    plain version, its bound and a library yardstick (timed here only;
    the port never calls them): ``torch.batch_norm_stats`` for row 10,
    ``torch.batch_norm_elemt`` for row 11, ``batch_norm_backward_reduce``
    and ``batch_norm_backward_elemt`` for rows 12/13 (the same passes
    without the ReLU mask and the residual); and both directions against
    ``F.batch_norm(training=True)`` + ``F.relu`` (+ the add) and its
    autograd backward."""
    n, h, w, c = shape
    x, res, dy, mean, var, gamma, beta = bn_case(*shape, torch.bfloat16, gen)
    m = x.shape[0]
    chans = (mean, var, gamma, beta)
    red = bn._bwd_reduce_plain(dy, x, *chans, None, BN_EPS, True)
    kernels = {
        "bn_stats": (lambda: bn._stats_cuda(x),
                     lambda: bn._stats_plain(x)),
        "bn_apply": (lambda: bn._apply_cuda(x, *chans, None, BN_EPS, True),
                     lambda: bn._apply_plain(x, *chans, None, BN_EPS, True)),
        "bn_bwd_reduce": (
            lambda: bn._bwd_reduce_cuda(dy, x, *chans, None, BN_EPS, True),
            lambda: bn._bwd_reduce_plain(dy, x, *chans, None, BN_EPS, True)),
        "bn_bwd_dx": (
            lambda: bn._bwd_dx_cuda(dy, x, *chans, red, None, BN_EPS, True,
                                    1 / m),
            lambda: bn._bwd_dx_plain(dy, x, *chans, red, None, BN_EPS, True,
                                     1 / m)),
        "bn_add_bwd_reduce": (
            lambda: bn._bwd_reduce_cuda(dy, x, *chans, res, BN_EPS, True),
            lambda: bn._bwd_reduce_plain(dy, x, *chans, res, BN_EPS, True)),
        "bn_add_bwd_dx": (
            lambda: bn._bwd_dx_cuda(dy, x, *chans, red, res, BN_EPS, True,
                                    1 / m),
            lambda: bn._bwd_dx_plain(dy, x, *chans, red, res, BN_EPS, True,
                                     1 / m)),
    }
    # NCHW views in channels_last layout for the library calls.
    nchw = lambda t: t.view(n, h, w, c).permute(0, 3, 1, 2)
    xn, dyn, resn = nchw(x), nchw(dy), nchw(res)
    invstd = torch.rsqrt(var + BN_EPS)
    count = torch.full((1,), m, dtype=torch.int32, device="cuda")
    sum_dy, sum_dy_xmu = red[0], red[1]
    library = {
        "bn_stats": lambda: torch.batch_norm_stats(xn, BN_EPS),
        "bn_apply": lambda: torch.batch_norm_elemt(xn, gamma, beta, mean,
                                                   invstd, BN_EPS),
        "bn_bwd_reduce": lambda: torch.batch_norm_backward_reduce(
            dyn, xn, mean, invstd, gamma, True, True, True),
        "bn_bwd_dx": lambda: torch.batch_norm_backward_elemt(
            dyn, xn, mean, invstd, gamma, sum_dy, sum_dy_xmu, count),
    }
    library["bn_add_bwd_reduce"] = library["bn_bwd_reduce"]
    library["bn_add_bwd_dx"] = library["bn_bwd_dx"]
    out = {}
    for name, (kern, plain) in kernels.items():
        res_ms = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, iters=5,
                                                            warmup=1)}
        res_ms["bound_ms"], res_ms["bound_by"] = bn_bound(name, m, c, 2)
        try:
            res_ms["library_ms"] = cuda_ms(library[name])
        except (RuntimeError, TypeError) as exc:   # yardstick only
            res_ms["library_ms"] = None
            res_ms["library_refused"] = str(exc).splitlines()[0][:160]
        res_ms["gb_per_s"] = (BN_TRAFFIC[name][0] * m * c * 2
                              / res_ms["ms"] / 1e6)
        out[name] = res_ms
    # Both directions against F.batch_norm + relu (+ add) and autograd.
    torch.cuda.empty_cache()
    for tag, r in (("plain", None), ("residual", resn)):
        xg = xn.detach().requires_grad_()
        wg = gamma.detach().requires_grad_()
        bg = beta.detach().requires_grad_()
        rg = None if r is None else r.detach().requires_grad_()

        def fwd():
            y = torch.nn.functional.batch_norm(xg, None, None, wg, bg,
                                               training=True, eps=BN_EPS)
            if rg is not None:
                y = y + rg
            return torch.relu(y)
        y = fwd()
        inputs = (xg, wg, bg) + (() if rg is None else (rg,))
        with torch.no_grad():
            fwd_ms = cuda_ms(fwd)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            y, inputs, dyn, retain_graph=True))
        ours_fwd = out["bn_stats"]["ms"] + out["bn_apply"]["ms"]
        pre = "bn_bwd" if r is None else "bn_add_bwd"
        ours_bwd = out[f"{pre}_reduce"]["ms"] + out[f"{pre}_dx"]["ms"]
        out[f"vs_f_batch_norm_{tag}"] = {
            "fwd_library_ms": fwd_ms, "fwd_kernels_ms": ours_fwd,
            "bwd_library_ms": bwd_ms, "bwd_kernels_ms": ours_bwd}
        del y, xg, rg
        torch.cuda.empty_cache()
    return out


def resnet_bn_inputs(batch):
    """The distinct ``(M, C)`` BN inputs of the main path's ResNet-50
    (fused lane, s2d stem, 224²) at ``batch``, largest first: read by
    forward pre-hooks on every FusedBNAct in one batch-1 forward on the
    card (M = N·H·W scales with the batch)."""
    model = get_model("resnet50", device="cuda", fused_bn=True,
                      s2d_stem=True, seed=SEED)
    seen = []
    for mod in model.modules():
        if isinstance(mod, FusedBNAct):
            mod.register_forward_pre_hook(lambda _mod, args: seen.append(
                (batch * args[0].shape[2] * args[0].shape[3],
                 args[0].shape[1])))
    with torch.no_grad():
        model(torch.zeros((1, RESNET_IMAGE, RESNET_IMAGE, 3), device="cuda"),
              train=True)
    if len(seen) != RESNET_BN_PER_STEP["bn_stats"]:
        raise AssertionError(f"resnet50: {len(seen)} BN layers seen, not "
                             f"{RESNET_BN_PER_STEP['bn_stats']}")
    return sorted(set(seen), reverse=True)


def check_bn(gen):
    """Against the plain versions: every distinct BN input of the main
    path in bf16 (its dtype), the named shapes in f32 and the ragged one
    in both; then the named ResNet-50 shapes timed (bf16)."""
    path = resnet_bn_inputs(RESNET_BATCH)
    named = {name: (n * h * w, c) for name, n, h, w, c in BN_SHAPES}
    off_path = [name for name in BN_TIMED if named[name] not in path]
    if off_path:
        raise AssertionError(f"BN shapes {off_path} are not ResNet-50's at "
                             f"batch {RESNET_BATCH}: {path}")
    cases = [(f"m{m}_c{c}", (1, 1, m, c), torch.bfloat16) for m, c in path]
    cases += [(name, shape, torch.float32) for name, *shape in BN_SHAPES]
    cases += [(name, shape, torch.bfloat16) for name, *shape in BN_SHAPES
              if name not in BN_TIMED]
    checked = {}
    for name, shape, dtype in cases:
        checked[f"{name}_{str(dtype)[6:]}"] = check_bn_case(name, shape,
                                                            dtype, gen)
        torch.cuda.empty_cache()
    worst = {k: max(c["max_abs_err"].get(k, 0.0) for c in checked.values())
             for k in BN_NAMES}
    worst_rel = {k: max(c["sum_rel"].get(k, 0.0) for c in checked.values())
                 for k in BN_NAMES if "dx" not in k and k != "bn_apply"}
    log(f"  batchnorm rows 10-13: all {len(path)} distinct BN inputs of "
        f"ResNet-50 at batch {RESNET_BATCH} in bf16 ({path}), "
        f"{len(BN_SHAPES)} shapes in f32, ragged in bf16; x residual x "
        f"relu: elementwise == plain (torch.equal), reductions within "
        f"{worst_rel} of their sums' scale (limit {BN_SUM_REL}); two runs "
        f"of each kernel torch.equal")
    timed = {}
    for name, *shape in BN_SHAPES:
        if name not in BN_TIMED:
            continue
        timed[name] = time_bn(shape, gen)
        for k in BN_NAMES:
            t = timed[name][k]
            log(f"    {k} {name} bf16: kernel {t['ms']:.4f} ms "
                f"({t['gb_per_s']:.0f} GB/s), plain {t['plain_ms']:.4f}, "
                f"library {t['library_ms']}, bound {t['bound_ms']:.4f} "
                f"({t['bound_by']})")
        for tag in ("plain", "residual"):
            log(f"    {name} vs F.batch_norm ({tag}): "
                f"{timed[name][f'vs_f_batch_norm_{tag}']}")
        torch.cuda.empty_cache()
    return {"path_inputs": path, "checked": checked, "max_abs_err": worst,
            "sum_rel": worst_rel, "timed": timed}


RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS = 256, 224, 8
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
# One step's comparisons run in f32 compute at RESNET_CHECK_BATCH with
# deterministic cuDNN, from two states made from the seeded weights, never
# from the (non-deterministic) timed steps: flax's init, where each block's
# exit BN scale is 0 (the reference test's setup; the residual branches
# then get no grad), and the same weights with every exit scale 1 (every
# parameter gets a grad). Any two valid f32 summation orders of the BN
# sums flip ReLU masks where a pre-activation is within rounding of 0; a
# per-parameter relative L2 turns that into up to 4e-2 wherever a BN
# scale's or bias's own grad cancels (Σg over normalised features). So
# grads are held per parameter as ||Δ|| over the norm of the whole grad
# (grad_err). exp/port_resnet_grad_noise.py measured on one H100 (NVIDIA
# H100 80GB HBM3, 700 W; 4 seeds, batch 32): sound pairs (kernels, plain
# versions, f64-accumulated sums, plain lane) read at most 7.0e-4 from
# init and 1.72e-2 with unit exit scales (16 blocks that all pass grads
# carry the mask flips into every parameter); faulty controls (the sums
# rounded to bf16; the residual left out of the backward's ReLU mask) at
# least 3.88e-2 from init and 6.06e-1 with unit exit scales. Each limit
# lies about midway between, on a log scale. The statistics (sound at most
# 3.4e-6, the bf16 control at least 6.4e-3) and the loss (1.0e-6 vs
# 3.6e-5) likewise. The checks: (1) the elementwise kernels (apply, dx)
# against their plain versions in the model: loss, every grad and every
# new statistic bitwise; (2) the kernels against the plain versions and
# (3) the fused lane against the plain lane: grads within
# RESNET_GRAD_TOL[state], new statistics within RESNET_STATS_REL of
# max(|ref|, 1), loss within RESNET_LOSS_REL.
RESNET_CHECK_BATCH = 32
RESNET_GRAD_TOL = {"init": 5e-3, "unit_exit_scale": 1e-1}
RESNET_STATS_REL, RESNET_LOSS_REL = 1e-4, 1e-5
# BN layers of ResNet-50 by kernel: 53 = stem + 16 blocks x 3 + 4
# projections; 16 block exits carry the residual.
RESNET_BN_PER_STEP = {"bn_stats": 53, "bn_apply": 53, "bn_bwd_reduce": 37,
                      "bn_bwd_dx": 37, "bn_add_bwd_reduce": 16,
                      "bn_add_bwd_dx": 16}


def lane_name(name: str) -> str:
    """A fused-lane state name as the plain lane's."""
    return name.replace("FusedBottleneck", "Bottleneck").replace(
        "FusedBNAct", "BatchNorm")


def plain_bn_on_the_card():
    """The BN wrappers on CUDA tensors swapped for the plain versions."""
    return swapped(bn, _stats_cuda=bn._stats_plain,
                   _apply_cuda=bn._apply_plain,
                   _bwd_reduce_cuda=bn._bwd_reduce_plain,
                   _bwd_dx_cuda=bn._bwd_dx_plain)


def resnet_step_outputs(model, init, x, y):
    """One train forward and backward from the ``init`` state: loss,
    grads and the new running statistics, by the fused lane's names."""
    own = model.state_dict()
    model.load_state_dict({(n if n in own else lane_name(n)): t
                           for n, t in init.items()})
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model(x, train=True), y)
    loss.backward()
    plain = not model.fused_bn
    rename = (lambda n: next(f for f in init if lane_name(f) == n)) \
        if plain else (lambda n: n)
    grads = {rename(n): p.grad.detach().clone()
             for n, p in model.named_parameters()}
    stats = {rename(n): b.detach().clone() for n, b in model.named_buffers()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, stats


def stats_rel(a, b):
    return max(float((a[n] - t).abs().max() / max(float(t.abs().max()), 1.0))
               for n, t in b.items())


def grad_err(a, b):
    """Per parameter ||a − b|| / ||b||_all, with ||b||_all the norm of
    every parameter's grad together: a parameter whose own grad cancels
    weighs by its share of the whole. Raises on a non-finite value."""
    total = math.sqrt(sum(float(g.float().norm()) ** 2 for g in b.values()))
    out = {}
    for name, gb in b.items():
        out[name] = float((a[name].float() - gb.float()).norm()) / total
        if not math.isfinite(out[name]):
            raise AssertionError(f"resnet grads: {name} not finite")
    return out


def compare_runs(tag, a, b, g_tol, s_tol, loss_tol):
    """Loss, grads (grad_err) and new running statistics (per buffer
    |Δ| / max(|ref|, 1)) of run ``a`` against run ``b``; raises past a
    tolerance."""
    err = grad_err(a[1], b[1])
    worst = max(err, key=err.get)
    srel = stats_rel(a[2], b[2])
    lrel = abs(a[0] - b[0]) / abs(b[0])
    log(f"  {tag}: grads max ||Δ||/||g||_all {err[worst]:.3e} ({worst}; tol "
        f"{g_tol}), new running stats {srel:.3e} (tol {s_tol}), loss "
        f"{lrel:.2e} (tol {loss_tol})")
    for what, got, tol in (("grads", err[worst], g_tol),
                           ("stats", srel, s_tol), ("loss", lrel, loss_tol)):
        if not got <= tol:
            raise AssertionError(f"resnet {tag}: {what} {got} > {tol}")
    return {"grads_max_err": err[worst], "worst_param": worst,
            "stats_max_rel": srel, "loss_rel": lrel, "grads_tol": g_tol,
            "stats_tol": s_tol, "loss_tol": loss_tol}


def elementwise_plain_on_the_card():
    """Only the elementwise wrappers (apply, dx) swapped for the plain
    versions; the reductions stay the kernels'."""
    return swapped(bn, _apply_cuda=bn._apply_plain,
                   _bwd_dx_cuda=bn._bwd_dx_plain)


def bitwise_equal(a, b):
    return a[0] == b[0] and all(torch.equal(a[i][n], b[i][n])
                                for i in (1, 2) for n in b[i])


def unit_exit_scale(state):
    """``state`` with every block's exit BN scale 1 instead of flax's 0."""
    return {n: torch.ones_like(t) if n.endswith("FusedBNAct_2.scale") else t
            for n, t in state.items()}


@contextlib.contextmanager
def deterministic_cudnn():
    """Deterministic cuDNN algorithms (benchmark off) for the block."""
    flags = torch.backends.cudnn
    saved = (flags.deterministic, flags.benchmark)
    flags.deterministic, flags.benchmark = True, False
    try:
        yield
    finally:
        flags.deterministic, flags.benchmark = saved


def check_models(batch, seed=SEED):
    """ResNet-50 in f32 compute on both lanes, and a batch of
    ``batch`` images from ``seed``, for the one-step comparisons."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(
        (batch, RESNET_IMAGE, RESNET_IMAGE, 3), dtype=np.float32),
        device="cuda")
    y = torch.as_tensor(rng.integers(0, 1000, (batch,)), device="cuda")
    return [get_model("resnet50", device="cuda", fused_bn=f, s2d_stem=True,
                      dtype=torch.float32) for f in (True, False)], x, y


def resnet_comparisons(init):
    """One step's loss, grads and new running statistics in f32 compute
    at RESNET_CHECK_BATCH (deterministic cuDNN, TF32 off), from flax's
    init and with unit exit scales: see the note above
    RESNET_CHECK_BATCH for the three checks."""
    (fused, plain), x, y = check_models(RESNET_CHECK_BATCH)
    out = {"batch": RESNET_CHECK_BATCH, "dtype": "float32",
           "cudnn_deterministic": True}
    with deterministic_cudnn():
        for label, state in (("init", init),
                             ("unit_exit_scale", unit_exit_scale(init))):
            for name in BN_NAMES:
                LAUNCHES[name] = 0
            k = resnet_step_outputs(fused, state, x, y)
            launches = {name: LAUNCHES[name] for name in BN_NAMES}
            if launches != RESNET_BN_PER_STEP:
                raise AssertionError(f"resnet f32 step ({label}): launches "
                                     f"{launches} != {RESNET_BN_PER_STEP}")
            with elementwise_plain_on_the_card():
                e = resnet_step_outputs(fused, state, x, y)
            if not bitwise_equal(k, e):
                raise AssertionError(f"resnet {label}: the elementwise "
                                     f"kernels in the model differ from "
                                     f"their plain versions")
            log(f"  {label}: elementwise kernels bitwise in the model")
            with plain_bn_on_the_card():
                p = resnet_step_outputs(fused, state, x, y)
            lane = resnet_step_outputs(plain, state, x, y)
            out[label] = {
                "loss": k[0], "launches": launches,
                "elementwise_kernels_bitwise": True,
                "kernels_vs_plain_versions": compare_runs(
                    f"{label}, kernels vs plain versions", k, p,
                    RESNET_GRAD_TOL[label], RESNET_STATS_REL,
                    RESNET_LOSS_REL),
                "fused_vs_plain_lane": compare_runs(
                    f"{label}, fused lane vs plain lane", k, lane,
                    RESNET_GRAD_TOL[label], RESNET_STATS_REL,
                    RESNET_LOSS_REL)}
            del k, e, p, lane
    return out


def resnet_run(tag, model, batch, expect):
    """RESNET_STEPS steps of sgd(0.1, momentum=0.9) through
    ``make_train_step``, with images/s and MFU."""
    state = create_train_state(model, sgd(RESNET_LR,
                                          momentum=RESNET_MOMENTUM))
    step = make_train_step(apply_kwargs_of=lambda b: {"train": True})
    run = timed_steps(tag, step, state, batch, BN_NAMES, expect,
                      RESNET_STEPS)
    flops = 3 * resnet50_flops(RESNET_BATCH, RESNET_IMAGE)
    run["images_per_s"] = RESNET_BATCH / (run["step_p50_ms"] / 1e3)
    run["mfu"] = flops / (run["step_p50_ms"] / 1e3) / PEAK_FLOPS[
        torch.bfloat16]
    return run


def train_resnet_phase(card: str):
    """ResNet-50 at full width (224², s2d stem, bf16 compute, f32 params
    and statistics), fused BN lane, batch 256: launches, loss, running
    statistics, step time, images/s, MFU, memory, profile; then the plain
    lane on the same weights and batch; then the f32 comparisons."""
    t0 = time.monotonic()
    model = get_model("resnet50", device="cuda", fused_bn=True,
                      s2d_stem=True, seed=SEED)
    init = {n: t.detach().clone() for n, t in model.state_dict().items()}
    rng = np.random.default_rng(SEED)
    x_np = rng.standard_normal((RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3),
                               dtype=np.float32)
    y_np = rng.integers(0, 1000, (RESNET_BATCH,))
    batch = {"x": torch.as_tensor(x_np, device="cuda").to(torch.bfloat16),
             "y": torch.as_tensor(y_np, device="cuda")}
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  resnet50 (fused_bn, s2d stem) built, batch made in "
        f"{time.monotonic() - t0:.1f} s ({n_params / 1e6:.2f} M params); "
        f"cudnn.benchmark={torch.backends.cudnn.benchmark}, "
        f"deterministic={torch.backends.cudnn.deterministic}")
    expect = {k: v * RESNET_STEPS for k, v in RESNET_BN_PER_STEP.items()}
    fused = resnet_run("train_resnet", model, batch, expect)
    moved = {n: float((model.get_buffer(n) - init[n]).abs().max())
             for n, _ in model.named_buffers()}
    finite = all(bool(torch.isfinite(b).all()) for b in model.buffers())
    if not finite or min(moved.values()) <= 0.0:
        raise AssertionError(f"train_resnet: running statistics finite "
                             f"{finite}, least move {min(moved.values())}")
    log(f"  all {len(moved)} running statistics finite and moved (least "
        f"max|Δ| {min(moved.values()):.3e})")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    log("[train_resnet plain lane]")
    plain = get_model("resnet50", device="cuda", fused_bn=False,
                      s2d_stem=True)
    plain.load_state_dict({lane_name(n): t for n, t in init.items()})
    plain_run = resnet_run("train_resnet_plain", plain, batch,
                           {k: 0 for k in BN_NAMES})
    rel = abs(plain_run["losses"][0] - fused["losses"][0]) / abs(
        plain_run["losses"][0])
    log(f"  first loss fused {fused['losses'][0]:.6f} vs plain lane "
        f"{plain_run['losses'][0]:.6f} (rel {rel:.2e}); step p50 fused "
        f"{fused['step_p50_ms']:.1f} ms vs plain {plain_run['step_p50_ms']:.1f}"
        f" ms; peak {fused['max_memory_allocated'] / 1e9:.1f} vs "
        f"{plain_run['max_memory_allocated'] / 1e9:.1f} GB")
    del plain, batch
    gc.collect()
    torch.cuda.empty_cache()

    log("[train_resnet checks]")
    checks = resnet_comparisons(init)
    return {"model": "resnet50 fused_bn=True s2d_stem=True bf16 compute",
            "params": n_params, "batch": RESNET_BATCH, "image": RESNET_IMAGE,
            "lr": RESNET_LR, "momentum": RESNET_MOMENTUM,
            "cudnn": {"benchmark": torch.backends.cudnn.benchmark,
                      "deterministic": torch.backends.cudnn.deterministic,
                      "allow_tf32": torch.backends.cudnn.allow_tf32},
            "flops_per_step": 3 * resnet50_flops(RESNET_BATCH, RESNET_IMAGE),
            **fused, "running_stats_least_move": min(moved.values()),
            "plain_lane": plain_run, "first_loss_fused_vs_plain_rel": rel,
            "checks": checks, "card": card}


# ---------------------------------------------------------------------
# Train loop phase: the step of a TonY job (data-parallel mesh, the
# chunked LM-head loss, selective remat) through train_loop.
# ---------------------------------------------------------------------

# The JAX package's 7B training bench runs xent_chunk=1024 with remat.
LOOP_XENT_CHUNK, LOOP_POLICY = 1024, "dots"
# The chunked loss against the plain head's first loss on the same
# weights and batch: one bf16 GEMM per chunk of rows instead of one over
# all rows, the same f32 softmax: 1e-3 relative.
LOOP_FIRST_LOSS_REL = 1e-3
LOOP_MESH_LAYERS = 2      # two 8-layer AdamW states do not fit together
LOOP_VARIANT_STEPS = 4
STATS_KEYS = {"step", "step_time_s", "collective_bytes", "mfu", "loss"}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def with_config(model, **fields):
    """The same module and weights under other training-forward fields
    (``remat_policy``, ``xent_chunk``: read only by the forward)."""
    model.cfg = dataclasses.replace(model.cfg, **fields)
    return model


def loop_loss(model, tokens):
    """The model's training loss: chunked with ``targets`` when the
    config has ``xent_chunk``, else the plain head's next-token loss."""
    if model.cfg.xent_chunk:
        return model(tokens, targets=tokens)
    return next_token_loss(model(tokens), tokens)


def loop_grads(model, tokens):
    """Loss and grads of one backward, and memory above what was allocated
    before it: ``saved``, what the forward leaves for the backward (the
    remat inputs, the kept products, the loss head's saved tensors), and
    ``peak``, the most the forward and backward held (grads included)."""
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = loop_loss(model, tokens)
    memory = {"saved": torch.cuda.memory_allocated() - base}
    loss.backward()
    memory["peak"] = torch.cuda.max_memory_allocated() - base
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads, memory


def loop_step_fn(model, mesh):
    if model.cfg.xent_chunk:
        return make_train_step(
            loss_of=lambda out, batch: out, mesh=mesh,
            apply_kwargs_of=lambda batch: {"targets": batch["x"]})
    return make_train_step(
        loss_of=lambda logits, batch: next_token_loss(logits, batch["x"]),
        mesh=mesh)


def check_remat_policies(model, tokens):
    """One backward under each remat policy from the same weights, no
    update between: ``torch.equal`` loss and grads (the kept products and
    the recomputed ones come from the same kernels on the same inputs)."""
    ref_loss, ref, memory = loop_grads(with_config(model, remat_policy=None),
                                      tokens)
    peaks = {"None": memory}
    for policy in ("dots", "dots_no_batch"):
        loss, grads, peaks[policy] = loop_grads(
            with_config(model, remat_policy=policy), tokens)
        bad = [n for n, g in grads.items() if not torch.equal(g, ref[n])]
        if not torch.equal(loss, ref_loss) or bad:
            raise AssertionError(f"train_loop: remat_policy={policy!r} "
                                 f"differs from None: loss {float(loss)} vs "
                                 f"{float(ref_loss)}, grads {bad[:4]}")
        del grads
    log(f"  remat None / dots / dots_no_batch: loss and every grad "
        f"torch.equal (loss {float(ref_loss):.6f}); saved by the forward / "
        f"peak of forward + backward above the model: " + ", ".join(
            f"{k} {v['saved'] / 1e9:.2f} / {v['peak'] / 1e9:.2f} GB"
            for k, v in peaks.items()))
    return ref_loss, ref, peaks


def check_chunked_vs_plain(model, tokens, chunked_loss, chunked,
                           train_first_loss):
    """The chunked loss against the plain head from the same weights:
    the first loss within LOOP_FIRST_LOSS_REL of the train phase's and of
    this model's plain head, the grads within the train phase's bf16
    limit."""
    plain_loss, plain, plain_memory = loop_grads(
        with_config(model, xent_chunk=0), tokens)
    with_config(model, xent_chunk=LOOP_XENT_CHUNK)
    rel = rel_l2(chunked, plain)
    worst = max(rel, key=rel.get)
    vs_train = abs(float(chunked_loss) - train_first_loss) \
        / abs(train_first_loss)
    vs_plain = abs(float(chunked_loss - plain_loss)) / abs(float(plain_loss))
    log(f"  chunked loss {float(chunked_loss):.6f} vs the train phase's "
        f"first {train_first_loss:.6f} (rel {vs_train:.3e}) and this "
        f"plain head's {float(plain_loss):.6f} (rel {vs_plain:.3e}; limit "
        f"{LOOP_FIRST_LOSS_REL}); grads vs plain head: max rel L2 "
        f"{rel[worst]:.3e} ({worst}; limit "
        f"{TRAIN_GRAD_REL_L2[torch.bfloat16]}); the plain head: saved "
        f"{plain_memory['saved'] / 1e9:.2f} GB, peak "
        f"{plain_memory['peak'] / 1e9:.2f} GB above the model")
    if not max(vs_train, vs_plain) <= LOOP_FIRST_LOSS_REL:
        raise AssertionError(f"train_loop: chunked loss {float(chunked_loss)}"
                             f" vs plain {float(plain_loss)} / train "
                             f"{train_first_loss}")
    if rel[worst] > TRAIN_GRAD_REL_L2[torch.bfloat16]:
        raise AssertionError(f"train_loop: chunked grads vs plain head: "
                             f"{worst} {rel[worst]}")
    return {"chunked_loss": float(chunked_loss),
            "plain_loss": float(plain_loss),
            "first_loss_vs_train_rel": vs_train,
            "first_loss_vs_plain_rel": vs_plain,
            "grads_vs_plain_max_rel_l2": rel[worst],
            "grads_vs_plain_worst_param": worst,
            "plain_head_memory": plain_memory}


def timed_variant(tag, model, state, mesh, tokens, steps):
    """``steps`` steps of the current config through ``train_loop``;
    step time p50, tokens/s, MFU and peak memory."""
    step = loop_step_fn(model, mesh)
    batch = {"x": tokens}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps = [time.monotonic()]
    losses = []

    def on_step(i, metrics):
        losses.append(float(metrics["loss"]))        # syncs
        stamps.append(time.monotonic())

    train_loop(state, step, [batch] * steps, on_step=on_step)
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    p50 = float(np.median(step_ms))
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3)
    flops_tok = dataclasses.replace(model.cfg,
                                    max_seq=TRAIN_SEQ).flops_per_token()
    out = {"remat_policy": model.cfg.remat_policy,
           "xent_chunk": model.cfg.xent_chunk, "steps": steps,
           "losses": losses, "step_ms": step_ms, "step_p50_ms": p50,
           "tokens_per_s": tokens_per_s,
           "mfu": tokens_per_s * flops_tok / PEAK_FLOPS[torch.bfloat16],
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"  {tag}: remat_policy={out['remat_policy']} xent_chunk="
        f"{out['xent_chunk']}: p50 {p50:.1f} ms, {tokens_per_s:.0f} "
        f"tokens/s, MFU {out['mfu']:.4f}, peak "
        f"{out['max_memory_allocated'] / 1e9:.2f} GB")
    return out


def check_mesh_step(tokens):
    """One step with the one-rank mesh against the same step without it,
    each from a fresh copy of the same weights at LOOP_MESH_LAYERS
    layers: ``torch.equal`` loss, metrics and every parameter."""
    mesh = MeshSpec(dp=1).build()
    runs = []
    for m in (mesh, None):
        model = get_model("llama2-7b", device="cuda", seed=SEED,
                          n_layers=LOOP_MESH_LAYERS,
                          xent_chunk=LOOP_XENT_CHUNK,
                          remat_policy=LOOP_POLICY)
        state = create_train_state(model, adamw(TRAIN_LR), mesh=m)
        _, metrics = loop_step_fn(model, m)(state, {"x": tokens})
        runs.append((metrics, model.state_dict()))
        del state, model
        gc.collect()
    (m_mesh, p_mesh), (m_plain, p_plain) = runs
    bad = [k for k in ("loss", "grad_norm", "aux_loss")
           if not torch.equal(m_mesh[k], m_plain[k])]
    bad += [n for n in p_plain if not torch.equal(p_mesh[n], p_plain[n])]
    if bad:
        raise AssertionError(f"train_loop: the one-rank mesh step differs "
                             f"from the step without a mesh: {bad[:4]}")
    log(f"  {LOOP_MESH_LAYERS}-layer step with the one-rank mesh == without "
        f"(torch.equal loss {float(m_mesh['loss']):.6f}, grad norm and "
        f"{len(p_plain)} parameters)")
    return float(m_mesh["loss"])


def train_loop_phase(card: str, train_first_loss: float):
    """llama2-7b x TRAIN_LAYERS through ``train_loop`` on a one-rank NCCL
    group: make_train_step(mesh=MeshSpec(dp=1).build()), xent_chunk=1024,
    remat_policy="dots", AdamW(3e-4), the train phase's batch and weights,
    train_stats_writer as on_step."""
    td.init_process_group("nccl", rank=0, world_size=1,
                          init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        return train_loop_run(card, train_first_loss)
    finally:
        td.destroy_process_group()


def train_loop_run(card: str, train_first_loss: float):
    t0 = time.monotonic()
    model = get_model("llama2-7b", device="cuda", seed=SEED,
                      n_layers=TRAIN_LAYERS, xent_chunk=LOOP_XENT_CHUNK,
                      remat_policy=LOOP_POLICY)
    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (TRAIN_BATCH, TRAIN_SEQ)),
                             device="cuda")
    torch.cuda.synchronize()
    log(f"  llama2-7b x{TRAIN_LAYERS} built in {time.monotonic() - t0:.1f} s "
        f"(xent_chunk={cfg.xent_chunk}, remat_policy={cfg.remat_policy})")
    chunked_loss, chunked, policy_memory = check_remat_policies(model,
                                                                 tokens)
    with_config(model, remat_policy=LOOP_POLICY)
    vs_plain = check_chunked_vs_plain(model, tokens, chunked_loss, chunked,
                                      train_first_loss)
    del chunked
    gc.collect()
    torch.cuda.empty_cache()

    mesh = MeshSpec(dp=1).build()
    state = create_train_state(model, adamw(TRAIN_LR), mesh=mesh)
    step = loop_step_fn(model, mesh)
    batch = global_batch(mesh, {"x": tokens})
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters())
    flops_tok = dataclasses.replace(cfg, max_seq=TRAIN_SEQ).flops_per_token()
    stats_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "train_loop_stats.json")
    os.makedirs(os.path.dirname(stats_path), exist_ok=True)
    writer = train_stats_writer(
        stats_path, flops_per_step=flops_tok * TRAIN_BATCH * TRAIN_SEQ,
        peak_flops=PEAK_FLOPS[torch.bfloat16])
    stamps, losses, gnorms, stats = [], [], [], []

    def on_step(i, metrics):
        writer(i, metrics)                           # float(loss) syncs
        stamps.append(time.monotonic())
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        with open(stats_path) as fh:
            stats.append(json.load(fh))

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in FLASH_NAMES:
        LAUNCHES[name] = 0
    stamps.append(time.monotonic())
    state, _ = train_loop(state, step, [batch] * TRAIN_STEPS,
                          on_step=on_step)
    launches = {name: LAUNCHES[name] for name in FLASH_NAMES}
    peak = torch.cuda.max_memory_allocated()
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    log(f"  losses {[round(x, 4) for x in losses]}; step ms "
        f"{[round(x, 1) for x in step_ms]}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"train_loop: non-finite loss or grad norm: "
                             f"{losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_loop: loss did not fall: {losses}")
    # remat: each layer's flash forward runs again in the backward (no
    # policy keeps a kernel's output), the backward once.
    expect = {"flash_attention_fwd": 2 * TRAIN_LAYERS * TRAIN_STEPS,
              "flash_attention_bwd_dq": TRAIN_LAYERS * TRAIN_STEPS,
              "flash_attention_bwd_dkv": TRAIN_LAYERS * TRAIN_STEPS}
    if launches != expect:
        raise AssertionError(f"train_loop: launches {launches} != {expect}")
    last = stats[-1]
    if set(last) != STATS_KEYS or not last["mfu"] > 0 \
            or last["collective_bytes"] != grad_bytes \
            or last["step"] != TRAIN_STEPS or last["loss"] != losses[-1]:
        raise AssertionError(f"train_loop: stats file {last}; grad bytes "
                             f"{grad_bytes}")
    log(f"  launches {launches} (= expected); stats file {last} "
        f"(collective bytes = the {grad_bytes} grad bytes a step reduces)")
    p50 = float(np.median(step_ms))
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3)
    main = {"remat_policy": LOOP_POLICY, "xent_chunk": LOOP_XENT_CHUNK,
            "steps": TRAIN_STEPS, "losses": losses, "grad_norms": gnorms,
            "step_ms": step_ms, "step_p50_ms": p50,
            "tokens_per_s": tokens_per_s,
            "mfu": tokens_per_s * flops_tok / PEAK_FLOPS[torch.bfloat16],
            "stats_mfu_by_step": [s["mfu"] for s in stats],
            "max_memory_allocated": peak}
    log(f"  main: p50 {p50:.1f} ms, {tokens_per_s:.0f} tokens/s, MFU "
        f"{main['mfu']:.4f}, peak {peak / 1e9:.2f} GB")
    log("[train_loop profile]")
    prof = main["profile"] = profile_train(step, state, batch)
    log(f"  {json.dumps(prof) if prof else 'no device events traced'}")
    variants = [main]
    for fields in ({"remat_policy": None}, {"remat_policy": "dots_no_batch"},
                   {"remat_policy": LOOP_POLICY, "xent_chunk": 0}):
        with_config(model, **fields)
        variants.append(timed_variant("variant", model, state, mesh, tokens,
                                      LOOP_VARIANT_STEPS))
    del state, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    mesh_loss = check_mesh_step(tokens)
    return {"model": f"llama2-7b n_layers={TRAIN_LAYERS}/32", "batch":
            TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR, "mesh": "dp=1 "
            "(one-rank NCCL group)", "launches": launches,
            "stats_last": last, "grad_bytes_reduced": grad_bytes,
            "flops_per_token": flops_tok, **vs_plain,
            "memory_by_policy": policy_memory,
            "mesh_check_layers": LOOP_MESH_LAYERS,
            "mesh_check_loss": mesh_loss, "runs": variants, "card": card}


# ---------------------------------------------------------------------
# train_ckpt: the checkpoint and data plane on the train_loop cell.
# ---------------------------------------------------------------------

CKPT_EVERY, CKPT_KILL_AFTER = 4, 6
CKPT_EXAMPLES = 64        # seeded 2048-token sequences in the .npy
CKPT_VOCAB = 32000
CKPT_SMALL_LAYERS = 2     # fused codec, drain, publish: full width
CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "ckpt_smoke")
# Hosts that meter a run's disk writes (deleted files included) end it
# past 45 GiB: the phase writes one 8-layer step (22.57 GB) and one
# 2-layer step (8.07 GB), and compares the 8-layer step 8 of its two
# runs in host memory through the same snapshot engine instead of
# writing both.
CKPT_WRITE_LIMIT = 45 << 30


class _Killed(Exception):
    """The scripted preemption of run B."""


class FirstSteps:
    """The first ``n`` batches of a DeviceIterator, with its cursor:
    what bounds a ``repeat()``-forever stream to a run's steps."""

    def __init__(self, it, n):
        self.it, self.n = it, n

    def __iter__(self):
        return self

    def __next__(self):
        if self.n <= 0:
            raise StopIteration
        self.n -= 1
        return next(self.it)

    def state(self):
        return self.it.state()

    def restore(self, state):
        self.it.restore(state)

    def close(self):
        self.it.close()


def meminfo_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def ckpt_model(layers, seed):
    return get_model("llama2-7b", device="cuda", seed=seed, n_layers=layers,
                     xent_chunk=LOOP_XENT_CHUNK, remat_policy=LOOP_POLICY)


def token_stream(mesh, data_path, steps):
    ds = (Dataset.from_memmap({"x": data_path}, seed=SEED).shuffle()
          .repeat().batch(TRAIN_BATCH).with_ids())
    return FirstSteps(ds.device_iterator(mesh, shard=ShardSpec(0, 1)),
                      steps)


def recorded_save():
    """The run's one save as its writer thread recorded it (profiler
    record ``async_save``: stall, allocation, staging, device-to-host and
    write times), or none."""
    r = profiler.ckpt_report().get("async_save")
    if r is None:
        return []
    return [{"step": r["step"], "stall_ms": 1e3 * r["stall_s"],
             "alloc_ms": 1e3 * r["alloc_s"], "stage_ms": 1e3 * r["stage_s"],
             "d2h_ms": 1e3 * r["d2h_s"], "write_s": r["write_s"],
             "nbytes": r["nbytes"]}]


def ckpt_run(tag, mesh, seed, data_path, ckpt_dir=None, save_every=0,
             kill=None, reference=None):
    """One run of the 8-layer job through train_loop on the memmapped
    tokens, on a DeviceIterator: a ``ckpt_dir`` arms the restore and, with
    ``save_every``, the async saves (no final save). Returns the run's
    numbers and, after its last step, its state and data cursor as the
    manifest would hold them: a host snapshot (the snapshot engine's
    synchronous copy, nothing written), or, given a ``reference``
    snapshot, their comparison with it (:func:`same_state`)."""
    model = ckpt_model(TRAIN_LAYERS, seed)
    state = create_train_state(model, adamw(TRAIN_LR), mesh=mesh)
    step = loop_step_fn(model, mesh)
    start = (ckpt.latest_step(ckpt_dir) or 0) if ckpt_dir else 0
    data = token_stream(mesh, data_path, TRAIN_STEPS - start)
    ids, losses, stamps, allocated = [], [], [], []

    def rec_step(st, batch):
        ids.append(batch["id"].tolist())
        return step(st, batch)

    def on_step(i, metrics):
        losses.append(float(metrics["loss"]))     # syncs
        stamps.append(time.monotonic())
        allocated.append(torch.cuda.memory_allocated())
        if kill is not None and i == kill:
            raise _Killed(i)

    for name in FLASH_NAMES:
        LAUNCHES[name] = 0
    profiler.reset_input_records()
    profiler.reset_ckpt_records()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps.append(time.monotonic())
    t0 = time.monotonic()
    try:
        state, _ = train_loop(state, rec_step, data=data, ckpt_dir=ckpt_dir,
                              save_every=save_every, save_final=False,
                              on_step=on_step)
    except _Killed:
        pass
    run = {"tag": tag, "start_step": start, "steps": len(losses),
           "losses": losses, "ids": ids, "seconds": time.monotonic() - t0,
           "step_ms": [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])],
           "launches": {n: LAUNCHES[n] for n in FLASH_NAMES},
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "allocated_after_step": allocated,
           "memory_reserved": torch.cuda.memory_reserved(),
           "alloc_retries": torch.cuda.memory_stats().get(
               "num_alloc_retries", 0),
           "input": profiler.input_report().get("input"),
           "restore": profiler.ckpt_report().get("restore"),
           "saves": recorded_save(),
           "final_step": state.step}
    t0 = time.monotonic()
    tree = ckptio.wrap_for_save(ckpt.encode_portable(state), data.state())
    if reference is None:
        out = ckpt_snapshot.extract_snapshot(tree, state.step)
    else:
        out = same_state(reference, tree)
    run["host_copy_s"] = time.monotonic() - t0
    del tree
    log(f"  {tag}: steps {start + 1}..{start + len(losses)} in "
        f"{run['seconds']:.1f} s, losses "
        f"{[round(x, 4) for x in losses]}, peak "
        f"{run['max_memory_allocated'] / 1e9:.2f} GB, allocated after each "
        f"step {[round(x / 1e9, 2) for x in allocated]} GB"
        + "".join(f"; save at step {v['step']}: stall {v['stall_ms']:.1f} "
                  f"ms (allocation {v['alloc_ms']:.1f}, staging "
                  f"{v['stage_ms']:.1f}),"
                  f" d2h {v['d2h_ms']:.1f} ms, write {v['write_s']:.1f} s"
                  for v in run["saves"]))
    del state, model, step, data
    gc.collect()
    torch.cuda.empty_cache()
    return run, out


def rate(nbytes, seconds):
    """GB/s, or None where nothing was timed (a copy on the CPU)."""
    return nbytes / seconds / 1e9 if seconds else None


def same_state(snap, tree):
    """``tree`` holds the checkpoint ``snap`` holds: the same leaves, and
    per chunk the same extent, CRC32 and bytes; ``tree``'s chunks are
    copied to the host one at a time (never a second whole state)."""
    leaves, parts = ckpt_snapshot._owned_parts(tree)
    if leaves != snap.leaves or len(parts) != len(snap.chunks):
        raise AssertionError("train_ckpt: A and B hold other leaves")
    nbytes = 0
    for (li, start, value, tr, region), (la, sa, xa) in zip(parts,
                                                           snap.chunks):
        xb = ckpt_snapshot._copy_to_host(value, tr, region)
        ba, bb = (x.reshape(-1).view(np.uint8) for x in (xa, xb))
        if (li, list(start), tuple(region)) != (la, sa, xa.shape) \
                or zlib.crc32(ba) != zlib.crc32(bb) \
                or not np.array_equal(ba, bb):
            raise AssertionError(f"train_ckpt: step {snap.step} differs at "
                                 f"{leaves[li]['path']} chunk {start}")
        nbytes += ba.nbytes
    return {"leaves": len(leaves), "chunks": len(parts),
            "bytes_compared": nbytes}


def warm_pinned(state):
    """Pin and free one host slot of ``state``'s checkpoint, arena for
    arena as the checkpointer plans it, so the timed save finds its slot
    in the caching host allocator as every save after a job's first
    does; returns the pinning time."""
    parts = ckpt_snapshot._owned_parts(ckpt.encode_portable(state))[1]
    caps = ckpt_snapshot.plan_arenas(
        [t.numel() * t.element_size() for _, _, t, _, _ in parts
         if isinstance(t, torch.Tensor) and t.is_cuda])[0]
    t0 = time.monotonic()
    arenas = [torch.empty(c, dtype=torch.uint8, pin_memory=True)
              for c in caps]
    del arenas
    return time.monotonic() - t0


def small_run_check(mesh, data_path):
    """2-layer fused run on the memmapped stream with save_every=2,
    publish_every=1 and the drain file created after step 2: the loop
    exits EXIT_DRAINED over a committed manifest holding model + cursor
    and published.json names it. Then a fresh FusedOptimizer state from
    other weights restores it and takes step 3: torch.equal to the
    drained state's own step 3 in parameters and every slot, one update
    launch per bucket, every parameter still a view of its bucket."""
    root = os.path.join(CKPT_ROOT, "small")
    drain = os.path.join(CKPT_ROOT, "drain_flag")
    step = make_accum_train_step(
        lambda out, b: out, microbatches=FUSED_MICROBATCHES,
        update="fused_bucket",
        apply_kwargs_of=lambda b: {"targets": b["x"]})

    def fresh(seed):
        return create_train_state(ckpt_model(CKPT_SMALL_LAYERS, seed),
                                  fo.FusedOptimizer(rule="adamw",
                                                    lr=TRAIN_LR))

    def on_step(i, metrics):
        if i == 2:
            open(drain, "w").close()

    ref = fresh(SEED)
    code = None
    profiler.reset_ckpt_records()
    try:
        train_loop(ref, step, data=token_stream(mesh, data_path, 8),
                   ckpt_dir=root, save_every=2, publish_every=1,
                   on_step=on_step, drain_file=drain)
    except SystemExit as e:
        code = e.code
    saves = recorded_save()
    os.remove(drain)
    committed = ckpt.committed_steps(root)
    pointer = publish.latest_publication(root)
    cursor = ckptio.load_iter_state(root, 2) \
        if committed == [2] and ckptio.has_iter_state(root, 2) else None
    if code != EXIT_DRAINED or cursor is None or cursor["batches"] != 2 \
            or ref.step != 2:
        raise AssertionError(f"train_ckpt: drain exit {code}, committed "
                             f"{committed}, cursor {cursor}")
    if pointer is None or pointer["step"] != 2:
        raise AssertionError(f"train_ckpt: published {pointer}, committed "
                             f"{committed}")
    log(f"  drain after step 2 ({CKPT_SMALL_LAYERS} layers, fused): "
        f"SystemExit({code}) over committed {committed} with model + "
        f"cursor (batches {cursor['batches']}); published.json version "
        f"{pointer['version']} -> step {pointer['step']}")
    third = token_stream(mesh, data_path, 1)
    third.restore(cursor)
    ref, m_ref = step(ref, next(third))
    third.close()
    got = fresh(SEED + 1)
    n_buckets = got.buckets.plan.n_buckets
    LAUNCHES["fused_bucket_update"] = 0
    got, m_got = train_loop(got, step,
                            data=token_stream(mesh, data_path, 1),
                            ckpt_dir=root, save_final=False)
    launches = LAUNCHES["fused_bucket_update"]
    got.buckets.check()
    bad = [n for (n, a), (_, b) in zip(got.model.named_parameters(),
                                       ref.model.named_parameters())
           if not torch.equal(a, b)]
    for slot in got.tx.slot_names:
        bad += [f"{slot}[{i}]" for i, (a, b) in enumerate(zip(
            got.opt_state["slots"][slot], ref.opt_state["slots"][slot]))
            if not torch.equal(a, b)]
    if bad or got.step != 3 or ref.step != 3 or not torch.equal(
            m_got["loss"], m_ref["loss"]):
        raise AssertionError(f"train_ckpt: restored fused step != the "
                             f"uninterrupted step 3: {bad[:4]}")
    if launches != n_buckets:
        raise AssertionError(f"train_ckpt: fused step after restore "
                             f"launched {launches} updates, {n_buckets} "
                             f"buckets")
    log(f"  fused codec: restored step 3 torch.equal to the uninterrupted "
        f"one in parameters, mu and nu; {launches} update launches for "
        f"{n_buckets} buckets; every parameter in its bucket")
    out = {"layers": CKPT_SMALL_LAYERS, "n_buckets": n_buckets,
           "launches": launches, "loss": float(m_got["loss"]),
           "exit_code": code, "committed": committed,
           "cursor_batches": cursor["batches"],
           "published": {"version": pointer["version"],
                         "step": pointer["step"]},
           "saves": saves,
           "restore": profiler.ckpt_report().get("restore")}
    del ref, got
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_ckpt_phase(card: str, loop_p50_ms):
    """The train_loop cell with the checkpoint and data plane armed, on a
    one-rank NCCL group: run A uninterrupted, run B killed and resumed
    from other weights, their step 8 compared chunk for chunk; then the
    fused codec, the drain commit and the publication at 2 layers."""
    td.init_process_group("nccl", rank=0, world_size=1,
                          init_method=f"tcp://127.0.0.1:{free_port()}")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    os.makedirs(CKPT_ROOT)
    try:
        return train_ckpt_run(card, loop_p50_ms)
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
        td.destroy_process_group()


def train_ckpt_run(card: str, loop_p50_ms):
    mesh = MeshSpec(dp=1).build()
    probe = create_train_state(ckpt_model(TRAIN_LAYERS, SEED),
                               adamw(TRAIN_LR))
    cfg = probe.model.cfg
    n_params = sum(p.numel() for p in probe.model.parameters())
    shared = 2 * cfg.vocab * cfg.dim                # embedding + lm_head
    pin_s = warm_pinned(probe)
    del probe
    gc.collect()
    torch.cuda.empty_cache()
    state_bytes = 3 * 4 * n_params                  # params, mu, nu in f32
    free = shutil.disk_usage(CKPT_ROOT).free
    avail = meminfo_available()
    log(f"  state {n_params} parameters = {state_bytes / 1e9:.2f} GB a "
        f"checkpoint; host MemAvailable {avail / 1e9:.1f} GB; free disk at "
        f"{CKPT_ROOT} {free / 1e9:.1f} GB")
    if free < 3 * state_bytes:
        raise RuntimeError(f"train_ckpt: {free / 1e9:.1f} GB free cannot "
                           f"hold two committed steps and one staging step "
                           f"({3 * state_bytes / 1e9:.1f} GB)")
    per_layer = (n_params - shared) // cfg.n_layers
    writes = state_bytes + 12 * (shared + CKPT_SMALL_LAYERS * per_layer)
    if writes > CKPT_WRITE_LIMIT:
        raise RuntimeError(f"train_ckpt: the phase would write "
                           f"{writes / 2**30:.1f} GiB, more than the "
                           f"machine allows a command")
    rng = np.random.default_rng(SEED)
    data_path = os.path.join(CKPT_ROOT, "tokens.npy")
    np.save(data_path, rng.integers(0, CKPT_VOCAB,
                                    (CKPT_EXAMPLES, TRAIN_SEQ),
                                    dtype=np.int32))
    b_root = os.path.join(CKPT_ROOT, "B")
    log(f"  pinned one {state_bytes / 1e9:.2f} GB host slot in "
        f"{pin_s:.2f} s (a job's first save pays this once)")
    run_a, snap_a = ckpt_run("A (uninterrupted)", mesh, SEED, data_path)
    run_b1, _ = ckpt_run("B (killed after step 6)", mesh, SEED, data_path,
                         b_root, save_every=CKPT_EVERY, kill=CKPT_KILL_AFTER)
    run_b2, compared = ckpt_run("B (resumed, other weights)", mesh,
                                SEED + 1, data_path, b_root,
                                reference=snap_a)
    del snap_a
    gc.collect()
    if ckpt.committed_steps(b_root) != [CKPT_EVERY]:
        raise AssertionError(f"train_ckpt: B committed "
                             f"{ckpt.committed_steps(b_root)}")
    if run_b2["start_step"] != CKPT_EVERY or run_b2["final_step"] != \
            TRAIN_STEPS or run_b1["steps"] != CKPT_KILL_AFTER \
            or run_a["final_step"] != TRAIN_STEPS:
        raise AssertionError(f"train_ckpt: B resumed at "
                             f"{run_b2['start_step']}, ended at "
                             f"{run_b2['final_step']}")
    log(f"  B's step {TRAIN_STEPS} == A's: {compared['leaves']} leaves, "
        f"{compared['chunks']} chunks (extents, CRC32 and "
        f"{compared['bytes_compared']} bytes)")
    if run_b2["ids"] != run_a["ids"][CKPT_EVERY:]:
        raise AssertionError(f"train_ckpt: ids after the restore "
                             f"{run_b2['ids']} != A's "
                             f"{run_a['ids'][CKPT_EVERY:]}")
    after = TRAIN_STEPS - CKPT_EVERY
    expect = {"flash_attention_fwd": 2 * TRAIN_LAYERS * after,
              "flash_attention_bwd_dq": TRAIN_LAYERS * after,
              "flash_attention_bwd_dkv": TRAIN_LAYERS * after}
    if run_b2["launches"] != expect:
        raise AssertionError(f"train_ckpt: launches after the restore "
                             f"{run_b2['launches']} != {expect}")
    first = run_b2["losses"][0]
    if not math.isfinite(first) or first != run_a["losses"][CKPT_EVERY]:
        raise AssertionError(f"train_ckpt: first loss after the restore "
                             f"{first} != A's step-{CKPT_EVERY + 1} loss "
                             f"{run_a['losses'][CKPT_EVERY]}")
    log(f"  ids of steps {CKPT_EVERY + 1}-{TRAIN_STEPS} equal; first loss "
        f"after the restore {first!r} == A's; launches {run_b2['launches']}")
    # The serving end of the loop, on B's committed step before it goes
    # (a second 8-layer step would pass the machine's write limit).
    log("[serve_replica]")
    replica = serve_replica_phase(card, b_root, TRAIN_LAYERS, CKPT_EVERY)
    shutil.rmtree(b_root, ignore_errors=True)
    small = small_run_check(mesh, data_path)

    p50 = float(np.median(run_a["step_ms"]))
    saves = run_b1["saves"] + small["saves"]
    for v in saves:
        v["stall_x_step_p50"] = v["stall_ms"] / p50
        v["d2h_GBps"] = rate(v["nbytes"], v["d2h_ms"] / 1e3)
        v["write_GBps"] = rate(v["nbytes"], v["write_s"])
    restore = run_b2["restore"]
    restore["h2d_GBps"] = rate(restore["h2d_nbytes"], restore["h2d_s"])
    restore["GBps"] = rate(restore["h2d_nbytes"], restore["seconds"])
    b_step_ms = run_b1["step_ms"]
    log(f"  run A step p50 {p50:.1f} ms (train_loop phase {loop_p50_ms}); "
        f"B's steps {[round(x, 1) for x in b_step_ms]} ms; restore "
        f"{restore['seconds']:.1f} s ({restore['GBps']} GB/s), "
        f"host-to-device {restore['h2d_GBps']} GB/s; input stall "
        f"{run_a['input']['wait_ms_mean']:.3f} ms a step (A), "
        f"{run_b1['input']['wait_ms_mean']:.3f} (B); peak "
        f"{run_b1['max_memory_allocated'] / 1e9:.2f} GB with a save (A: "
        f"{run_a['max_memory_allocated'] / 1e9:.2f})")
    return {"model": f"llama2-7b n_layers={TRAIN_LAYERS}/32", "batch":
            TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR,
            "xent_chunk": LOOP_XENT_CHUNK, "remat_policy": LOOP_POLICY,
            "mesh": "dp=1 (one-rank NCCL group)", "save_every": CKPT_EVERY,
            "state_bytes": state_bytes, "host_mem_available": avail,
            "disk_free": free, "pin_slot_s": pin_s, "step_p50_ms": p50,
            "train_loop_step_p50_ms": loop_p50_ms,
            "saves": saves, "restore": restore, "compared": compared,
            "runs": [{k: v for k, v in r.items() if k != "ids"}
                     for r in (run_a, run_b1, run_b2)],
            "ids_after_restore": run_b2["ids"],
            "launches_after_restore": run_b2["launches"],
            "max_memory_allocated_with_save":
                run_b1["max_memory_allocated"],
            "small": small, "card": card, "serve_replica": replica}


# ---------------------------------------------------------------------
# Serve-replica phase.
# ---------------------------------------------------------------------

REPLICA_ENGINE = dict(ctx_max=2048, block_size=16, q_block=16,
                      max_running=16)
# The keys of a replica's stats file that the reference's AM, session,
# router and autoscaler read.
REPLICA_STATS_KEYS = {"qps", "p99_ms", "queue_depth", "running", "completed",
                      "acceptance_rate", "role", "warm_standby",
                      "weight_version", "weight_step", "weight_swaps",
                      "swapping", "rpc_port"}
REPLICA_STATS_EVERY_S = 0.5
REPLICA_UNCOMMITTED_STEP = 7


class LongCallRpcClient(RpcClient):
    """The port's RPC client with a per-operation socket timeout long
    enough for a 32-layer generate under load or a swap's restore: past
    ``SOCKET_TIMEOUT_S`` the client re-sends the call as a transport
    fault."""
    SOCKET_TIMEOUT_S = 600.0


def replica_model_kwargs(layers):
    """The train_loop cell's model as a replica serves it: its depth and
    ``xent_chunk`` (which put the head at ``lm_head_kernel``); the bf16
    policy gives it bf16 storage."""
    return {"n_layers": layers, "xent_chunk": LOOP_XENT_CHUNK}


def rpc_generate(port, tokens, max_new):
    with LongCallRpcClient(f"127.0.0.1:{port}", timeout=600.0) as client:
        return client.call("generate", tokens=tokens,
                           max_new_tokens=max_new)


def run_threads(fn, n, timeout=900):
    """``fn(i)`` on ``n`` threads at once; their results in order. A
    thread's exception fails the phase."""
    out, errors = [None] * n, []

    def worker(i):
        try:
            out[i] = fn(i)
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
    if any(th.is_alive() for th in threads):
        raise AssertionError("serve_replica: requests did not finish")
    if errors:
        raise AssertionError(f"serve_replica: {len(errors)} request(s) "
                             f"failed") from errors[0]
    return out


def window_numbers(engine, t0, t1):
    """TTFT p50, engine step p50 (ms), requests/s and tokens/s of what the
    engine finished between ``t0`` and ``t1`` (``time.monotonic``), from
    its windowed stats."""
    st = engine.stats(t0, t1)
    return {k: st[k] for k in ("ttft_p50_ms", "step_p50_ms", "qps",
                               "tokens_per_s")}


def check_served_params(replica, root, step):
    """Every served parameter is bitwise the bf16 cast of the step's f32
    leaf: the f32 leaves read from the manifest into a host template
    through the port's restore, cast on the host. Returns the parameter
    count."""
    params = dict(replica.model.named_parameters())
    masters = {n: torch.empty(p.shape, dtype=torch.float32)
               for n, p in params.items()}
    template = jax_param_tree(replica.model, masters)
    ckpt.restore_pytree(root, template, step=step,
                        path_prefix=ckpt.find_path_prefix(root, template,
                                                          step=step))
    for name, p in params.items():
        got = p.detach().cpu()
        want = masters[name].to(torch.bfloat16)
        # f32-stored leaves (the norm scales) hold the bf16 value.
        if not torch.equal(got.to(torch.bfloat16).view(torch.int16),
                           want.view(torch.int16)) \
                or not torch.equal(got, want.to(got.dtype)):
            raise AssertionError(f"serve_replica: served {name} is not the "
                                 f"bf16 cast of step {step}'s f32 leaf")
    return sum(p.numel() for p in params.values())


def wait_for_stats(path, done, timeout=60.0):
    """The stats file's payload once ``done(payload)`` holds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                payload = json.load(f)
            if done(payload):
                return payload
        time.sleep(0.05)
    raise AssertionError(f"serve_replica: stats file {path} never showed "
                         f"what the phase waits for")


def swap_under_load(replica, reqs, version):
    """The ``swap`` RPC verb while 16 RPC clients keep requests in
    flight (each sends mix requests until the swap has returned).
    Returns the swap's answer and the completions."""
    engine, port = replica.engine, replica.port
    swapped = threading.Event()

    def traffic(i):
        done = []
        while not swapped.is_set() or not done:
            toks, n = reqs[(i + len(done)) % len(reqs)]
            out = rpc_generate(port, toks, n)
            if len(out["tokens"]) != n:
                raise AssertionError(f"serve_replica: request under swap "
                                     f"gave {len(out['tokens'])} of {n}")
            done.append(len(out["tokens"]))
        return done

    answer = {}

    def swap():
        deadline = time.monotonic() + 60
        while engine.running < len(reqs) and time.monotonic() < deadline:
            time.sleep(0.005)
        answer["in_flight"] = engine.running + engine.queue_depth
        with LongCallRpcClient(f"127.0.0.1:{port}", timeout=600.0) as cl:
            answer["swap"] = cl.call("swap", version=version)
        swapped.set()

    swapper = threading.Thread(target=swap, daemon=True)
    swapper.start()
    completed = run_threads(traffic, len(reqs))
    swapper.join(timeout=600)
    if swapper.is_alive() or "swap" not in answer:
        raise AssertionError("serve_replica: the swap did not return")
    return answer, completed


def serve_replica_phase(card, root, layers, step):
    """The train -> serve loop's serving end on one card: publish the
    committed step ``step`` under ``root``, restore it through
    ``Replica`` (bf16 policy) into ``layers``-deep llama2-7b, check every
    served parameter bitwise, serve the 16-request mix over the RPC wire
    (and in-process), check the stats file the heartbeat would carry,
    then hot-swap onto a republication under load and refuse a swap to
    an uncommitted step."""
    gc.collect()
    torch.cuda.empty_cache()
    rec = publish.publish_step(root, step)
    profiler.reset_ckpt_records()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    replica = Replica(model_name="llama2-7b",
                      model_kwargs=replica_model_kwargs(layers),
                      ckpt_dir=root, dtype_policy="bf16", keep_logits=True,
                      **REPLICA_ENGINE)
    replica.generate([1, 2, 3, 4], 1)
    to_first_token = time.monotonic() - t0
    restore = profiler.ckpt_report()["restore"]
    restore["GBps"] = rate(restore["h2d_nbytes"], restore["seconds"])
    engine = replica.engine
    cfg = replica.model.cfg
    if replica.restored_step != step or \
            engine.weight_version != rec["version"]:
        raise AssertionError(f"serve_replica: serving step "
                             f"{replica.restored_step} version "
                             f"{engine.weight_version}, published {rec}")
    log(f"  Replica up in {to_first_token:.2f} s to its first token "
        f"({replica.timings}); restore {restore['seconds']:.2f} s "
        f"({restore['GBps']} GB/s) of step {step}, version "
        f"{rec['version']}")
    n_params = check_served_params(replica, root, step)
    log(f"  all {n_params} served parameters == bf16 cast of the f32 "
        f"leaves")
    stats_path = os.path.join(root, "serve-stats.json")
    stop = threading.Event()
    server = threading.Thread(
        target=replica.serve_forever, daemon=True,
        kwargs=dict(host="127.0.0.1", port=0, stats_path=stats_path,
                    stats_every_s=REPLICA_STATS_EVERY_S, stop=stop))
    server.start()
    try:
        first = wait_for_stats(stats_path, lambda s: "rpc_port" in s)
        port = replica.port
        if first["rpc_port"] != port:
            raise AssertionError(f"serve_replica: stats rpc_port "
                                 f"{first['rpc_port']} != {port}")
        reqs = serve_mix(SEED, cfg.vocab)
        gen = sum(n for _, n in reqs)
        # The mix in-process first: it warms the shapes (cuBLAS, the
        # allocator) and its logits are held against the full prefill.
        local = run_threads(lambda i: replica.generate(*reqs[i]), len(reqs))
        worst, near_ties, rows = decode_vs_prefill(engine, reqs, local,
                                                   SERVE_REL_TOL)
        LAUNCHES["flash_decode"] = 0
        forwards0 = engine.forwards
        t_a = time.monotonic()
        outs = run_threads(lambda i: rpc_generate(port, *reqs[i]), len(reqs))
        t_b = time.monotonic()
        launches = LAUNCHES["flash_decode"]
        forwards = engine.forwards - forwards0
        for (toks, n), out in zip(reqs, outs):
            if len(out["tokens"]) != n:
                raise AssertionError(f"serve_replica: RPC request gave "
                                     f"{len(out['tokens'])} of {n} tokens")
        if forwards == 0 or launches != cfg.n_layers * forwards:
            raise AssertionError(f"serve_replica: flash_decode launches "
                                 f"{launches} != {cfg.n_layers} x "
                                 f"{forwards} forwards")
        rpc = dict(window_numbers(engine, t_a, t_b), wall_s=t_b - t_a,
                   decode_tokens_per_s=gen / (t_b - t_a),
                   forwards=forwards, flash_decode_launches=launches)
        forwards0 = engine.forwards
        t_c = time.monotonic()
        run_threads(lambda i: replica.generate(*reqs[i]), len(reqs))
        t_d = time.monotonic()
        in_process = dict(window_numbers(engine, t_c, t_d), wall_s=t_d - t_c,
                          decode_tokens_per_s=gen / (t_d - t_c),
                          forwards=engine.forwards - forwards0)
        log(f"  16 requests over RPC: {rpc}; in-process: {in_process}")
        prompt, n = reqs[0]
        alone = replica.generate(prompt, n).tokens
        if rpc_generate(port, prompt, n)["tokens"] != alone:
            raise AssertionError("serve_replica: a prompt alone over RPC "
                                 "gave other tokens than in-process")
        stats = wait_for_stats(stats_path,
                               lambda s: s["completed"] >= 3 * 16 + 3)
        missing = REPLICA_STATS_KEYS - set(stats)
        if missing or stats["weight_step"] != step or \
                stats["rpc_port"] != port:
            raise AssertionError(f"serve_replica: stats file {stats} "
                                 f"(missing {missing})")
        rec2 = publish.publish_step(root, step)
        if rec2["version"] != rec["version"] + 1:
            raise AssertionError(f"serve_replica: republication {rec2}")
        answer, completed = swap_under_load(replica, reqs, rec2["version"])
        swap = answer["swap"]
        if engine.weight_version != rec2["version"] or \
                engine.weight_swaps != 1 or swap["to_version"] != \
                rec2["version"] or answer["in_flight"] < len(reqs):
            raise AssertionError(f"serve_replica: swap {answer}, engine "
                                 f"version {engine.weight_version}, swaps "
                                 f"{engine.weight_swaps}")
        during = window_numbers(engine, *swap["restore_window"])
        if replica.generate(prompt, n).tokens != alone:
            raise AssertionError("serve_replica: the flip changed a token")
        try:
            with LongCallRpcClient(f"127.0.0.1:{port}") as client:
                client.call("swap", step=REPLICA_UNCOMMITTED_STEP)
        except RpcError as exc:
            refused = str(exc)
        else:
            refused = None
        if refused is None or not refused.startswith("SwapError") or \
                engine.weight_version != rec2["version"] or \
                replica.generate(prompt, n).tokens != alone:
            raise AssertionError(f"serve_replica: swap to an uncommitted "
                                 f"step: {refused}")
        log(f"  swap under load ({answer['in_flight']} requests in "
            f"flight, {sum(len(c) for c in completed)} completed, none "
            f"dropped): restore {swap['restore_s']:.2f} s, decode step p50 "
            f"during it {during['step_p50_ms']} ms at "
            f"{during['tokens_per_s']:.1f} tokens/s, quiesce "
            f"{swap['quiesce_ms']:.1f} ms, flip "
            f"{swap['flip_ms']:.2f} ms; refused: {refused}")
    finally:
        stop.set()
        server.join(timeout=30)
    if server.is_alive():
        raise AssertionError("serve_replica: serve_forever did not stop")
    peak = torch.cuda.max_memory_allocated()
    del replica, engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": f"llama2-7b n_layers={layers}/32 xent_chunk="
                     f"{LOOP_XENT_CHUNK}", "dtype_policy": "bf16",
            "ckpt_step": step, "version": rec["version"],
            "engine": REPLICA_ENGINE, "parameters": n_params,
            "restore": restore, "to_first_token_s": to_first_token,
            "rpc": rpc, "in_process": in_process,
            "decode_vs_prefill_max_rel": worst,
            "decode_vs_prefill_rows": rows, "near_tie_flips": near_ties,
            "swap": dict(swap, in_flight=answer["in_flight"],
                         completed_during=sum(len(c) for c in completed),
                         decode_during_restore=during),
            "swap_refused": refused, "stats_file_keys": sorted(stats),
            "max_memory_allocated": peak, "card": card}


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False — this "
            "script needs a GPU")
        return 1
    # Phase 1: device.
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 2: build every kernel of the path (one nvcc per source,
    # started together).
    t0 = time.monotonic()
    _build.load(_build.SOURCES)
    log(f"[build] {time.monotonic() - t0:.1f} s")
    for name, info in _build.build_info.items():
        log(f"  {name}: nvcc {info['seconds']:.1f} s")
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line or (
                    name == "flash_decode" and "entry function" in line):
                log(f"    {line.strip()}")

    # Phase 3: kernels against their plain versions.
    log("[kernels]")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    decode_timed = {}
    for name, shape, pf in DECODE_SHAPES:
        decode_timed[name] = check_kernel(name, shape, torch.bfloat16, gen,
                                          prefill=pf, time_it=True)
    dec, pre = decode_timed["decode"], decode_timed["prefill"]
    errs = [r["max_abs_err"] for r in decode_timed.values()]
    for name, shape, pf in DECODE_SHAPES:
        if name in ("decode", "gqa", "prefill"):
            errs.append(check_kernel(name, shape, torch.float32, gen,
                                     prefill=pf)["max_abs_err"])
    check_row_independence(torch.bfloat16, gen)
    check_row_independence(torch.float32, gen)
    flash = {}
    for shape in FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            res = check_flash(shape, dtype, gen,
                              time_it=shape[-1] and dtype == torch.bfloat16)
            flash[f"{shape[0]}_{str(dtype)[6:]}"] = res
        torch.cuda.empty_cache()
    fused_err, fused_timed = check_fused(gen)
    int8 = check_int8(gen)
    bn_kernels = check_bn(gen)

    # Phase 4: the main path.
    log("[serve]")
    serve, serve_launches, engine, serve_results = serve_phase(SEED)
    log("[profile]")
    prof = profile_decode(engine, engine.model.cfg.vocab)
    log(f"  {json.dumps(prof) if prof else 'no device events traced'}")
    serve["decode_profile"] = prof
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  serve phase freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"still allocated")

    # Phase 6: the training path.
    log("[train]")
    train, train_launches = train_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  train phase freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"still allocated")

    # Phase 7: the accumulating step with the fused bucket optimizer.
    log("[train_fused]")
    train_fused = train_fused_phase(card, train["losses"][0])
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 8: the quantized lane, serving (against the serve phase's
    # completions, kept on the host).
    log("[serve_quant]")
    serve_quant, quant_launches = serve_quant_phase(serve_results)
    del serve_results
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  serve_quant phase freed: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    # Phase 9: the quantized lane, training.
    log("[train_quant]")
    train_quant = train_quant_phase(card, train["losses"][0])
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 10: ResNet-50 training on the fused BN lane, then the plain
    # lane, then one f32 step's comparisons.
    log("[train_resnet]")
    train_resnet = train_resnet_phase(card)
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 11: the decoder through train_loop on a one-rank NCCL mesh,
    # with the chunked LM-head loss and the "dots" remat policy.
    log("[train_loop]")
    train_loop_res = train_loop_phase(card, train["losses"][0])
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 12: the same cell with the checkpoint and data plane armed.
    log("[train_ckpt]")
    train_ckpt = train_ckpt_phase(card,
                                  train_loop_res["runs"][0]["step_p50_ms"])
    serve_replica = train_ckpt.pop("serve_replica")

    entry = {
        "name": "flash_decode", "route": "cuda",
        "source": "tony_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "tony_tpu/ops/attention.py:1231",
        "launches": serve_launches["flash_decode"]
        + serve_replica["rpc"]["flash_decode_launches"],
        "launches_by_path": {
            "serve": serve_launches["flash_decode"],
            "serve_replica": serve_replica["rpc"]["flash_decode_launches"]},
        "max_abs_err": dec["max_abs_err"],
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        # Aliases of "ms" and "max_abs_err".
        "kernel_ms": dec["ms"], "max_abs_diff": dec["max_abs_err"],
        "shape": "decode bf16 b=16 h=32 hkv=32 t=16 d=128 ctx=2048",
        "prefill": dict(pre, shape="bf16 b=1 h=32 t=512 d=128 ctx=2048"),
        "by_shape": {name: {k: r[k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "max_abs_err", "plan")}
            for name, r in decode_timed.items()},
        "max_abs_err_all_cases": max(errs),
        "kernel": "flash_decode_mma_kernel<HEAD_DIM, RT> + "
                  "flash_decode_combine_kernel (bf16); flash_decode_kernel "
                  "(f32)",
        "products": "bf16: mma.sync.m16n8k16 tensor cores, P as bf16 hi + "
                    "lo, ldmatrix, cp.async two-stage ring of 32-key tiles, "
                    "256-key chunks folded in order, split over blocks; "
                    "f32: CUDA-core FMAs",
        "replaced": "flash_decode_kernel in bf16 (CUDA-core FMAs; f32 only "
                    "now)",
    }
    main_shape = flash["packed_bfloat16"]
    entries = [entry]
    for name, kernel_line, outs in (
            ("flash_attention_fwd", 408, ("o",)),
            ("flash_attention_bwd_dq", 462, ("dq",)),
            ("flash_attention_bwd_dkv", 500, ("dk", "dv"))):
        timed = main_shape["kernels"][name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "tony_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": f"tony_tpu/ops/attention.py:{kernel_line}",
            "launches": train_launches[name]
            + train_loop_res["launches"][name]
            + train_ckpt["launches_after_restore"][name],
            "launches_by_path": {
                "train": train_launches[name],
                "train_loop": train_loop_res["launches"][name],
                "train_ckpt_after_restore":
                    train_ckpt["launches_after_restore"][name]},
            "max_abs_err": max(main_shape["max_abs_err"][e] for e in outs),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "shape": "packed bf16 b=2 h=32 t=2048 d=128 causal",
            "max_abs_err_all_cases": max(
                res["max_abs_err"][e] for res in flash.values()
                for e in outs),
            **FLASH_KERNELS[name],
            "by_shape": {res["shape"]["rows"]: {
                k: res["kernels"][name][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for res in flash.values() if "kernels" in res},
        })
    w_gate, embedding = (fused_timed[n] for n in FUSED_TIMED)
    prof = train_fused["profile"]
    entries.append({
        "name": "fused_bucket_update", "route": "cuda",
        "source": "tony_tpu_torch/ops/csrc/fused_optim.cu",
        "replaces": "tony_tpu/ops/fused_optim.py:123",
        "launches": train_fused["launches"]["fused_bucket_update"]
        + train_ckpt["small"]["launches"],
        "launches_by_path": {
            "train_fused": train_fused["launches"]["fused_bucket_update"],
            "train_ckpt_after_restore": train_ckpt["small"]["launches"]},
        "max_abs_err": max(fused_err, train_fused["real_buckets_max_abs_err"]),
        "ms": w_gate["ms"], "plain_ms": w_gate["plain_ms"],
        "bound_ms": w_gate["bound_ms"], "bound_by": w_gate["bound_by"],
        "library_ms": w_gate["library_ms"],
        "shape": f"adamw f32 n={FUSED_TIMED[0]} (one w_gate bucket)",
        "embedding_bucket": dict(embedding,
                                 shape=f"adamw f32 n={FUSED_TIMED[1]}"),
        "step_device_ms": prof["device_ms_by_group"]["fused_update"]
        if prof else None,
    })
    decode_int8 = int8["decode_gate_up"]
    int8_launches = {"serve_quant": quant_launches["int8_matmul"],
                     "train_quant": train_quant["launches"]["int8_matmul"]}
    entries.append({
        "name": "int8_matmul", "route": "cuda",
        "source": "tony_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "tony_tpu/ops/quant.py:127",
        "launches": sum(int8_launches.values()),
        "launches_by_path": int8_launches,
        "max_abs_err": max(r["max_abs_err"] for r in int8.values()),
        "ms": decode_int8["ms"], "plain_ms": decode_int8["plain_ms"],
        "bound_ms": decode_int8["bound_ms"],
        "bound_by": decode_int8["bound_by"],
        "library_ms": decode_int8["library_ms"],
        "shape": "decode w_gate/w_up: M=256 K=4096 N=11008",
        "kernel": "int8_matmul_wgmma_kernel<BM, BN> (+ "
                  "int8_matmul_combine_kernel when a split is asked for); "
                  "int8_matmul_kernel (mma.sync) for operands TMA cannot "
                  "address",
        "products": "wgmma m64nBNk32 s8 from 128-byte-swizzled TMA tiles, "
                    "one producer warp, an mbarrier ring, persistent grid, "
                    "exact int32 split over K on request",
        "replaced": "int8_matmul_kernel on every path (mma.sync m16n8k32, "
                    "two-stage cp.async ring; ragged operands only now)",
        "by_shape": {name: {k: r.get(k) for k in (
            "ms", "device_ms", "cold_ms", "cold_device_ms", "host_us",
            "plain_ms", "bound_ms", "bound_by", "bound_share",
            "bound_share_cold", "library_ms", "library_device_ms",
            "bf16_linear_ms", "plan")}
            for name, r in int8.items() if "ms" in r},
    })
    bn_main = bn_kernels["timed"][BN_MAIN]
    rn_prof = train_resnet["profile"]
    for name in BN_NAMES:
        line, row = BN_REPLACES[name]
        t = bn_main[name]
        entries.append({
            "name": name, "route": "cuda", "row": row,
            "source": "tony_tpu_torch/ops/csrc/batchnorm.cu",
            "replaces": f"tony_tpu/ops/batchnorm.py:{line}",
            "launches": train_resnet["launches"][name],
            "max_abs_err": bn_kernels["max_abs_err"][name],
            "sum_rel_err": bn_kernels["sum_rel"].get(name),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": f"bf16 relu M={256 * 56 * 56} C=256 (stage 1, batch "
                     f"256)",
            "by_shape": {k: {f: v[name][f] for f in (
                "ms", "plain_ms", "bound_ms", "library_ms")}
                for k, v in bn_kernels["timed"].items()},
        })
    train_resnet["step_device_ms_bn"] = (
        rn_prof["device_ms_by_group"]["bn_kernels"] if rn_prof else None)
    serve["card"] = card
    serve_quant["card"] = card
    print(json.dumps({"flash_shapes": flash}), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"train_fused": train_fused}), flush=True)
    print(json.dumps({"quant": {"int8_shapes": int8,
                                "serve_quant": serve_quant,
                                "train_quant": train_quant}}), flush=True)
    print(json.dumps({"bn_shapes": bn_kernels}), flush=True)
    print(json.dumps({"resnet": train_resnet}), flush=True)
    print(json.dumps({"train_loop": train_loop_res}), flush=True)
    print(json.dumps({"train_ckpt": train_ckpt}), flush=True)
    print(json.dumps({"serve_replica": serve_replica}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
