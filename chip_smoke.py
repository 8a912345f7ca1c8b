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
5a. serve_coldstart — the cold-start plane on the serve phase's model,
   one engine (and one 17 GB pool) at a time, every engine driven the
   same way on the serve mix (request 0 alone to its first token, then
   the other 15): an eager engine; then three starts of an engine with
   an AOT cache: *cold* (an empty cache and an empty kernel directory:
   nvcc builds flash-decode, ``warm()`` captures the decode buckets in
   CUDA graphs, the prefill pads are captured at their first launch),
   *hit* (the populated cache and a second empty kernel directory: no
   nvcc, no miss) and a *standby* (warmed with the mix's pads while
   idle, then ``promote()``); each start's tokens and every logit row
   equal to the eager engine's, every forward a replay, flash-decode
   replayed 32 times a forward; the seconds from construction (from
   ``promote()`` for the standby) to the first token; the decode step
   replayed against eager (tokens/s, step p50, idle share over three
   b=16 steps); ``swap_params`` onto other weights then a replay, equal
   to an eager engine on those weights;
5b. serve_prefix, serve_spec, serve_disagg — the routed lanes on the
   serve phase's model; serve_disagg: a prefill-role and a decode-role
   engine, each behind the replica's RPC handler and server, the port's
   ``RequestRouter`` (built as ``cli route`` builds it) dispatching to
   them, the KV blocks over a loopback socket: (a) the serve mix one
   request at a time, tokens and every logits row equal to a colocated
   engine's, 16 handoffs, no fallback, no failover, ``blocks_shipped`` =
   the mix's 268 blocks, the first import's blocks ``torch.equal`` to
   the exported ones; (b) the longest request after ``warm()`` on the
   decode engine, equal to (a); (c) the mix from 16 threads within
   ``SERVE_REL_TOL`` of the serve phase's completions; row 9 launched 32
   times a forward on both engines. Wire bytes, export and import ms,
   re-sends, fallbacks and failovers, per-request wall, decode tokens/s
   and peak for each pass. ``--disagg-cards-only`` (two or more
   cards) runs (a) and (c) with the engines on ``cuda:0`` and ``cuda:1``,
   then the split serve job with ``--gpus 1``;
5c. serve_kvtier — the KV memory hierarchy and the tenants on the serve
   phase's model: (a) the serve mix's 16 prompts as turn 1 of 16
   conversations and turn 2 each history + 16-64 seeded tokens (16
   generated), one request at a time, on an engine with a 512-block
   host tier (the encode on its offload thread) and one without, turn 1
   replayed on the host-tier engine, turn 2 there eager (its captured
   steps set aside) and, from the same parked records put back,
   replayed: 16 resumes each, every re-staged block ``torch.equal`` to
   the block parked, turn
   2's prefill rows fewer than the never-parked engine's, tokens and
   logits within ``SERVE_REL_TOL`` of it, the replayed turn 2 equal to
   the eager one; (b) the prefix mix on a prefix-cache engine with the
   demotion daemon at watermark 0.5 over a 192-block pool (8 of the mix's
   conversations, two waves of second turns): daemon demotions and
   promotions, within
   ``SERVE_REL_TOL`` of a host-tier-off engine; (c) the system prompt's
   stem exported into a prefix store and adopted by a second engine
   through the replica's ``_load_stems``: the adopted blocks
   ``torch.equal`` to the exported ones, a probe hitting them equal to
   the exporting engine's own hit and within ``SERVE_REL_TOL`` of a cold
   engine; (d) tenants ``gold:3,silver:1``, 12 ``silver`` requests
   against 4 ``gold`` from 16 threads: deferrals on ``silver`` only, the
   victim within ``SERVE_REL_TOL`` of an unloaded engine, every tenant's
   blocks drained; (e) two turns of one session through the router's
   RPC verb over two host-tier replicas: the same replica, one resume.
   Park, resume, demote and promote counts, bytes raw and base64, park
   and resume ms, tokens/s, peaks and per-tenant numbers for each pass;
   row 9 launched 32 times a forward in every pass;
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
7a. train_zero3 — ZeRO-3 over the fsdp axis, on a one-rank NCCL group:
   (a) ``make_accum_train_step(mesh=MeshSpec(dp=0).build(),
   microbatches=2, reduce_op="reduce_scatter")`` with the fused AdamW and
   with the per-leaf adamw, each from fresh 2-layer full-width states
   against the step without a mesh: two steps' loss and grad norm, every
   parameter and slot ``torch.equal``; then the fused mesh step at the
   train_fused depth and batch (8 steps, exact launches), its step p50,
   tokens/s, MFU and peak memory beside train_fused's; (b) row 14 on
   ZeRO-3 shard buffers: ``plan_sharded`` of the 8-layer 7B's parameters
   (global shapes, logical-axis specs) at fsdp 2 and 4 and of the CPU
   tests' uneven tree at fsdp 4, the first and the last rank's chunk of
   every scatter bucket through the kernel and its plain version
   (``torch.equal`` on p and both slots, pad rows staying zero, every
   buffer 16-byte aligned), the largest chunk timed beside its bound;
   (c) where ``torch.cuda.device_count() >= 2``: one NCCL rank per card
   running ``tests/workloads/torch_zero3_steps.py`` (the CPU tests'
   gloo worker) with ``MeshSpec(fsdp=cards)`` on the 8-layer 7B, two
   fused steps through the gather window on 2 rows a card, against the
   one-card mesh path on the same rows: first loss within 1e-2, each
   parameter's update within the train phase's bf16 grad limit, every
   rank's parameter and slot storage 1/cards of the whole; the same
   steps with ``gather="per_leaf"`` ``torch.equal`` on every parameter,
   both step peaks (after a reset once the state is built) and step
   times, the window's high-water mark within its bound, and a third
   step of each under ``torch.profiler`` (device time of the NCCL and
   the other rows beside the wall time); (d) llama2-7b
   at all 32 layers, nothing cut, at fsdp=cards: 2 rows of 2048 a card,
   two microbatches, the fused AdamW, remat "dots" with
   ``xent_chunk=1024``, 3 steps, the first loss within 1e-2 of a one-card
   no-grad forward of the same seeded model on the same rows, the losses
   finite and falling, storage 1/cards, each rank's step and build
   peaks; (e) the 8-layer step with ``quant=True`` (the int8 gather
   wire), 2 steps, its first loss within 5e-2 of (c)'s windowed one,
   int8 bytes a quarter of the raw ones, ``gather_roundtrip_exact`` true
   on NCCL. On one card a line says that (c)-(e) did not run and why.
   ``python3 chip_smoke.py --zero3-cards-only`` runs (c)-(e) and their
   references alone. ``python3 chip_smoke.py --ckpt-depth-only`` runs
   alone, on one card, the save of an unsharded llama2-7b at 16 layers
   with per-leaf AdamW (3.50 B parameters; the deepest depth above 12
   the host's memory and disk hold, with the reason, where 16 does not
   fit) after one step: its whole staging does not fit beside the state,
   so it stages in pieces (the staged bytes ``torch.equal`` the live
   state, the buffer within the budget), writes ~42 GB and restores into
   a fresh state equal to the saved one chunk for chunk; it prints the
   staging high-water mark beside the budget, the stall and the peak;
7b. train_moe — mixtral-8x7b at full width (dim 4096, ffn 14336, 8
   experts, top-2, 32/8 heads, vocab 32000) cut to 2 of 32 layers (3.165
   B f32 parameters: with grads and AdamW's slots ~51 GB beside the
   activations), random weights from the seed, the train batch of 2 x
   2048: one step's loss and grads on the flash lane against the
   ``attention="reference"`` lane of the same weights (loss within 1e-2;
   the share of tokens a layer whose top-k expert set differs between
   the lanes; the grads' relative L2 with each lane routing itself,
   reported, and with the reference lane on the flash lane's routing,
   held to the train phase's bf16 limit); then 4 steps of
   ``make_train_step`` with AdamW(3e-4) and 4 of
   ``make_accum_train_step(microbatches=2, update="fused_bucket")``:
   the loss finite and falling, the first step's ``aux_loss`` within the
   reference's band (coef x layers x 0.25-5), the fused first loss within
   1e-2 of the reference lane's, exact launches of rows 3/4, 7/8 and 14,
   step time, tokens/s, MFU, peak memory and a profile each.
   ``python3 chip_smoke.py --moe-cards-only`` (4 cards) runs alone one
   NCCL rank per card of ``tests/workloads/torch_moe_ep_steps.py`` (the
   CPU tests' gloo worker): ``MeshSpec(ep=4)`` and ``MeshSpec(dp=2,
   ep=2)`` at 2 layers with the chunked exchange, one step each against
   rank 0's one-card step on the same weights and batch (loss within
   1e-2; grads within the train phase's bf16 limit on the mesh's
   routing, and reported with the card routing itself, beside the share
   of top-k sets that differ), then ``ep=4`` at 8 layers, AdamW, 4 steps:
   losses finite and falling, the step times, each rank holding 2 of the
   8 experts, rank 0's step peak and the exchange's bytes a step from
   the ``moe`` records;
8. serve_quant — the serve phase's model, seed and 16-request mix with
   ``quant=True`` (int8 qkv/o/mlp projections through ``int8_matmul``):
   every request completes, the int8 kernel ran 7 × 32 times per
   forward, one prefill and one decode forward give ``torch.equal``
   logits through the kernel and through its plain version, decode
   against the engine's own full prefill within the stated quantization
   limit, the distance to the unquantized serve phase's logits, the
   serve numbers, the quantize passes timed apart, a decode profile, and
   one request's prefill and decode steps replayed from captured steps
   ``torch.equal`` to the eager engine's (int8 replayed 7 × 32 a
   forward);
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
10a. train_resnet_ckpt — the same model and optimizer through
   ``train_loop`` with deterministic cuDNN, a seeded batch a step made on
   the card: run A 8 steps uninterrupted; run B from the same weights
   with a save at step 4 (the portable form: flax ``params`` with HWIO
   conv kernels, ``batch_stats``, optax sgd's trace), killed after step
   6, then resumed by ``train_loop`` from other weights; B's step-8
   parameters, BN buffers and traces ``torch.equal`` A's, the losses of
   steps 5-8 equal, rows 10-13 launched exactly 4 steps' counts after
   the restore; then the step-8 state saved whole-staged and through a
   1 MiB staging budget in pieces writes the same bytes. The save's
   stall, write and bytes and the restore's seconds are printed;
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
   the quiesce and the flip, and peak memory; then a replica started as
   a warm standby: its stats file says ``warm_standby`` 1, ``promote``
   over RPC flips it to 0 as the call returns, a second ``promote``
   returns False. At full depth: ``python3 exp/port_replica_phase.py``;
13a. tony_jobs — the train -> serve loop as TonY jobs of the port's own
   control plane (``python -m tony_tpu_torch.cli``, its AM, scheduler and
   ``python -S`` executor; nothing of the JAX package): (a) the GPU
   census finds every card ``nvidia-smi --query-gpu=index,uuid,name``
   names, at its index, under its UUID and name; (b) an in-process
   ``ckpt_run`` of llama2-7b at full width and 1 layer (the job's two
   saves must stay under the machine's write limit beside train_ckpt's),
   4 steps, the train_ckpt seed, data file and AdamW, finished and freed,
   then the same run as ``cli submit --framework pytorch --conf
   tony.worker.instances=1 --conf tony.worker.gpus=1 --conf
   tony.ckpt.dir=... --conf tony.ckpt.every=2`` of
   ``tests/workloads/torch_job_train.py``: the job SUCCEEDED, its task saw
   exactly the census's card (``CUDA_VISIBLE_DEVICES``, UUID, one card),
   rows 1-8's forward and backward pair launched in it (the run's counts
   and a profiled last step's kernel names), its losses equal, and its
   committed step 4 holds the in-process state and cursor byte for byte;
   (c) a job asking one card more than the host has fails at launch with
   ``unsatisfiable gpu ask``, no task started; (d) an in-process
   ``Replica`` (bf16) on that step, then ``cli serve ... --gpus 1``: four
   seeded prompts sent one at a time over RPC give the in-process greedy
   tokens, row 9 launched in the replica as often (the ``launches`` of
   its ``serve_stats`` verb), and ``cli kill`` ends the job KILLED; (e)
   the same step served split, ``cli serve --role prefill=1,decode=1``
   (no card ask: both replicas on card 0) behind ``cli route --am``: the
   four prompts through the router give (d)'s tokens by 4 handoffs,
   each replica's heartbeat carries its role, row 9 launched 4 times in
   the prefill replica and (d)'s count less 4 in the decode one. It
   prints submit-to-first-step and submit-to-first-token seconds and the
   job's step times by kind: its plain steps (neither the first, nor
   one that carries the save made after the step before it, nor the
   profiled last) with their p50, apart from those that carry a save. ``python3 chip_smoke.py --job-depth-only`` runs the phase
   alone at 8 layers, the depth the train phase runs (its two saves,
   45.14 GB, are the command's only large writes; the phase checks them
   against the write limit and the free disk before it starts).
   ``python3 chip_smoke.py --job-cards-only`` (2 or more
   cards) runs alone one worker a card, each with
   ``tony.worker.gpus=1``, training the train phase's 8-layer model by
   NCCL data parallelism over 2 rows a card for 5 steps: every task saw
   one card, the census's at its rank, the cards disjoint; the first loss
   within 1e-2 of a one-card no-grad forward on the same global rows;
   each rank's step times and peak;
14. report — a ``{"kernels": [...]}`` line (rows 1-15), a
   ``{"serve": {...}}`` line, a ``{"train": {...}}`` line, a
   ``{"train_fused": {...}}`` line, a ``{"train_zero3": {...}}`` line,
   a ``{"train_moe": {...}}`` line,
   a ``{"quant": {...}}`` line, a
   ``{"bn_shapes": {...}}`` line, a ``{"resnet": {...}}`` line, a
   ``{"train_resnet_ckpt": {...}}`` line, a
   ``{"train_loop": {...}}`` line, a ``{"train_ckpt": {...}}`` line, a
   ``{"serve_replica": {...}}`` line, a ``{"tony_jobs": {...}}`` line,
   the ``{"serve_prefix": ...}``,
   ``{"serve_spec": ...}``, ``{"serve_disagg": ...}`` and
   ``{"serve_coldstart": ...}`` lines, the
   card line, and last ``{"ok": true, "device": {...}}``.

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
from tony_tpu_torch.models import moe as moe_module  # noqa: E402
from tony_tpu_torch.models.moe import MoEMLP  # noqa: E402
from tony_tpu_torch.models.transformer import (  # noqa: E402
    Transformer, TransformerConfig)
from tony_tpu_torch.models.resnet import (FusedBNAct,  # noqa: E402
                                          resnet50_flops)
from tony_tpu_torch.ops import LAUNCHES, _build  # noqa: E402
from tony_tpu_torch.ops import attention as attn  # noqa: E402
from tony_tpu_torch.ops import batchnorm as bn  # noqa: E402
from tony_tpu_torch.ops import fused_optim as fo  # noqa: E402
from tony_tpu_torch.ops import quant as tq  # noqa: E402
from tony_tpu_torch.parallel import AXES, Mesh, MeshSpec  # noqa: E402
from tony_tpu_torch.parallel.overlap import (GradBuckets,  # noqa: E402
                                             strip_spec)
from tony_tpu_torch.rpc import RpcClient, RpcError  # noqa: E402
from tony_tpu_torch.serve import (AdmissionError,  # noqa: E402
                                  EngineFront, Replica, ServeEngine)
from tony_tpu_torch.serve.swap import derive_prefill_pads  # noqa: E402
from tony_tpu_torch.train import (adamw, create_train_state,  # noqa: E402
                                  cross_entropy_loss, global_batch,
                                  make_accum_train_step, make_train_step,
                                  next_token_loss, param_specs, sgd,
                                  train_loop, train_stats_writer)

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


T_SCRIPT = time.monotonic()


def log(msg: str) -> None:
    """One line to stderr; a phase's header (``[name]``) carries the
    seconds since the script started."""
    if msg.startswith("[") and msg.endswith("]"):
        msg = f"{msg} t={time.monotonic() - T_SCRIPT:.1f} s"
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


# Row 9 at the shapes the routed lanes launch it, llama2-7b's d=128 at ctx
# 2048: (name, (b, h, hkv, t, d, ctx), first position, real rows a
# sequence). chunk is one 256-row prefill chunk at positions 1024-1279
# (the serve_prefix phase's prefill_chunk past its 1024-token system
# prompt); verify the b=16 verify block of spec_k=4 (5 real rows of 16,
# ragged first positions).
LANE_SHAPES = [("chunk", (1, 32, 32, 256, 128, 2048), 1024, 256),
               ("verify", (16, 32, 32, 16, 128, 2048), None, 5)]


def check_lane_shape(name, shape, p0, real, gen):
    """Row 9 at a lane's shape in bf16: against its plain version on the
    real rows (one bf16 ulp of the output's scale, as check_kernel), the
    same bits at forced cache splits 1, 2, 4, 8 and in a second launch
    (``torch.equal``), timed beside its bound, plain version and SDPA."""
    b, h, hkv, t, d, ctx = shape
    q, k, v, pos = decode_inputs(b, h, hkv, t, d, ctx, torch.bfloat16, gen)
    if p0 is not None:
        pos = (p0 + torch.arange(t, dtype=torch.int32,
                                 device="cuda"))[None].repeat(b, 1)
    scale = d ** -0.5
    out = attn.flash_decode(q, k, v, pos)
    ref = attn._decode_plain(q, k, v, pos, scale, 128)
    forced = {s: attn._decode_cuda(q, k, v, pos, scale, splits=s)
              for s in (1, 2, 4, 8)}
    again = attn.flash_decode(q, k, v, pos)
    torch.cuda.synchronize()
    err = (out[:, :, :real].float()
           - ref[:, :, :real].float()).abs().max().item()
    tol = 2.0 ** (math.floor(math.log2(
        ref[:, :, :real].float().abs().max().item())) - 7)
    log(f"  {name} bf16 b={b} t={t} ({real} real rows) positions "
        f"{int(pos.min())}-{int(pos.max())}: max|kernel - plain| = "
        f"{err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version: {err} > {tol}")
    if not torch.equal(again, out) or not all(
            torch.equal(o, out) for o in forced.values()):
        raise AssertionError(f"{name}: the split over the cache or a "
                             f"second launch changed a bit")
    log(f"  {name}: splits 1, 2, 4, 8 and a second launch == the planned "
        f"launch (torch.equal)")
    res = {"shape": f"bf16 b={b} h={h} hkv={hkv} t={t} d={d} ctx={ctx}",
           "positions": [int(pos.min()), int(pos.max())],
           "real_rows": real, "max_abs_err": err, "tol": tol,
           "plan": attn._decode_plan_on(torch.cuda.current_device(), b, h,
                                        hkv, t, d, ctx)._asdict()}
    res["ms"] = cuda_ms(lambda: attn.flash_decode(q, k, v, pos))
    res["plain_ms"] = cuda_ms(
        lambda: attn._decode_plain(q, k, v, pos, scale, 128), iters=5)
    res["library_ms"] = cuda_ms(sdpa_fn(q, k, v, pos))
    res["bound_ms"], res["bound_by"] = bound(q, k, pos)
    log(f"    kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
        f"sdpa {res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']})")
    return res


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
    device's idle share of it (None when the trace holds no device
    events), and the steps' wall times, p50 and decode tokens/s."""
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
    step_ms = []
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            t1 = time.monotonic()
            engine.step()
            step_ms.append(1e3 * (time.monotonic() - t1))
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
    timing = {"step_wall_ms": wall_ms, "step_ms": step_ms,
              "step_p50_ms": float(np.median(step_ms)),
              "decode_tokens_per_s": 16e3 / wall_ms}
    if not by_name:
        return dict(timing, device_busy_ms=None, idle_share=None,
                    device_ms_by_group=None, top_kernels_ms_per_step=None)
    busy = sum(by_name.values())
    groups = {}
    for key, ms in by_name.items():
        group = decode_group(key)
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {**timing, "device_busy_ms": busy,
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
# The routed serving lanes: prefix cache, chunked prefill, speculation.
# ---------------------------------------------------------------------

SERVE_ENGINE = dict(ctx_max=2048, block_size=16, q_block=16,
                    max_running=16, decode_buckets=(4, 16),
                    keep_logits=True)
PREFIX_SYSTEM = 1024       # tokens of the shared, seeded system prompt
PREFIX_CHUNK = 256
PREFIX_NEW = 32
PREFIX_TURN2 = 4           # requests that come back for a second turn
LONG_PROMPT = 2040         # + 8 new tokens = the 2048 context


def prefix_mix(seed: int, vocab: int):
    """The serve_prefix mix: one seeded 1024-token system prompt, 16
    requests of it + their own 16-256-token suffix, 32 new tokens each;
    the second-turn suffixes (16-64 tokens) of 4 of them."""
    rng = np.random.default_rng(seed + 2)
    system = rng.integers(0, vocab, PREFIX_SYSTEM).tolist()
    turn1 = [system + rng.integers(0, vocab, int(rng.integers(16, 257)))
             .tolist() for _ in range(16)]
    more = [rng.integers(0, vocab, int(rng.integers(16, 65))).tolist()
            for _ in range(PREFIX_TURN2)]
    return turn1, more


def drive(engine, reqs, warm_first=False):
    """Submit ``reqs`` ((rid, tokens, max_new)) and run the engine dry.
    ``warm_first``: the first request alone until its prompt is in the
    pool (published), then the rest at once. Returns the completions by
    rid, the wall seconds and the ``time.monotonic`` window."""
    from tony_tpu_torch.serve import Request
    done = {}
    t0 = time.monotonic()
    rest = list(reqs)
    if warm_first:
        rid, toks, n = rest.pop(0)
        engine.submit(Request(rid=rid, tokens=toks, max_new_tokens=n))
        while engine.queue_depth or engine._prefilling:
            done.update({c.rid: c for c in engine.step()})
    for rid, toks, n in rest:
        engine.submit(Request(rid=rid, tokens=toks, max_new_tokens=n))
    done.update({c.rid: c for c in engine.run()})
    torch.cuda.synchronize()
    t1 = time.monotonic()
    return done, t1 - t0, (t0, t1)


def compare_streams(got, ref, tol, what):
    """Tokens and logits of ``got`` against ``ref`` (completions by rid,
    same prompts): rows within ``tol``·max|ref| and tokens equal up to
    each request's first divergence, which must sit at a near-tie of the
    reference row (top-two gap within ``tol``·max|ref|); the rest of
    that request is not compared. Returns the worst relative difference,
    the divergences and the rows compared."""
    worst, diverged, rows = 0.0, 0, 0
    for rid, r in ref.items():
        c = got[rid]
        if list(c.prompt) != list(r.prompt):
            raise AssertionError(f"{what}: request {rid} got another "
                                 f"prompt than the reference's")
        for j, (a, b) in enumerate(zip(c.logits, r.logits)):
            scale = float(np.abs(b).max())
            diff = float(np.abs(a - b).max())
            worst = max(worst, diff / scale)
            rows += 1
            if diff > tol * scale:
                raise AssertionError(f"{what}: request {rid} row {j} off "
                                     f"the reference by {diff} > "
                                     f"{tol}·{scale}")
            if c.tokens[j] != r.tokens[j]:
                top2 = np.sort(b)[-2:]
                if top2[1] - top2[0] > tol * scale:
                    raise AssertionError(f"{what}: request {rid} token {j} "
                                         f"differs outside a near-tie")
                diverged += 1
                break
    return worst, diverged, rows


def prefix_expected(turn1, turn2, chunk, cache):
    """The lane counters the serve_prefix mix implies, from its token
    counts alone (bs = q_block = 16): request 0 warms the pool alone, so
    each of the other 15 adopts the 64 system-prompt blocks; a second
    turn adopts every full block below its first turn's last token
    (the rows written by that turn: prompt + 31 decoded). Prefill rows
    are the rest of each prompt padded to 16 (a 256-row chunk is a
    multiple of 16, so chunking adds none); chunks are the rest over
    256, rounded up."""
    bs = 16
    hits, rows, chunks, arith = 0, 0, 0, []
    for i, toks in enumerate(turn1):
        m = PREFIX_SYSTEM // bs if (cache and i) else 0
        hits += m
        rest = len(toks) - m * bs
        rows += -(-rest // bs) * bs
        chunks += -(-rest // chunk) if chunk else 0
    arith.append(f"turn 1: 15 x {PREFIX_SYSTEM // bs} hit blocks")
    for first, toks in turn2:
        m = (first - 1) // bs if cache else 0
        hits += m
        rest = len(toks) - m * bs
        rows += -(-rest // bs) * bs
        chunks += -(-rest // chunk) if chunk else 0
        arith.append(f"turn 2: ({first} - 1) // 16 = {m}")
    return {"prefix_hit_blocks": hits, "prefill_rows": rows,
            "prefill_chunks": chunks}, "; ".join(arith)


def long_prompt_steps(model, chunk, seed):
    """The decode step while one 2040-token prompt prefills beside 15
    running sequences (128-token prompts, 64 new tokens): the host wall
    of every engine step from the long prompt's submission to its first
    token. Returns their p50, max and count (ms)."""
    from tony_tpu_torch.serve import Request
    rng = np.random.default_rng(seed + 3)
    engine = ServeEngine(model, prefill_chunk=chunk,
                         **dict(SERVE_ENGINE, keep_logits=False))
    vocab = model.cfg.vocab
    for i in range(15):
        engine.submit(Request(rid=f"bg-{i}",
                              tokens=rng.integers(0, vocab, 128).tolist(),
                              max_new_tokens=64))
    while engine.queue_depth or engine._prefilling:
        engine.step()
    for _ in range(3):
        engine.step()
    engine.submit(Request(rid="long",
                          tokens=rng.integers(0, vocab, LONG_PROMPT)
                          .tolist(), max_new_tokens=8))
    steps = []
    while True:
        t0 = time.monotonic()
        engine.step()
        steps.append(1e3 * (time.monotonic() - t0))
        if any(s.rid == "long" for s in engine._running):
            break
    engine.run()
    steps.sort()
    del engine
    return {"step_p50_ms": steps[(len(steps) - 1) // 2],
            "step_max_ms": steps[-1], "steps": len(steps)}


def serve_prefix_phase(model):
    """The prefix-cache and chunked-prefill lanes at full width: the
    prefix mix with the cache off, on, and on with 256-row chunks; lane
    counters against the mix's arithmetic, every way's tokens and logits
    against the cache-off run's; then the decode step while a 2040-token
    prompt prefills chunked and monolithic beside 15 running
    sequences."""
    vocab = model.cfg.vocab
    turn1, more = prefix_mix(SEED, vocab)
    ways = {"off": {}, "on": {"prefix_cache": True},
            "on_chunk": {"prefix_cache": True,
                         "prefill_chunk": PREFIX_CHUNK}}
    res, ref1, ref2 = {}, None, None
    for way, lanes in ways.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = ServeEngine(model, **SERVE_ENGINE, **lanes)
        EngineFront(engine).generate([1, 2, 3, 4], 2)       # warm-up
        c0 = {k: getattr(engine, k) for k in (
            "prefix_hit_blocks", "prefill_rows", "prefill_chunks",
            "prefix_lookup_blocks")}
        LAUNCHES["flash_decode"] = 0
        forwards0 = engine.forwards
        done1, wall1, win1 = drive(
            engine, [(f"t1-{i}", t, PREFIX_NEW)
                     for i, t in enumerate(turn1)], warm_first=True)
        turn2 = [(len(turn1[i]) + PREFIX_NEW,
                  turn1[i] + list(done1[f"t1-{i}"].tokens) + more[i])
                 for i in range(PREFIX_TURN2)]
        done2, wall2, win2 = drive(
            engine, [(f"t2-{i}", t, PREFIX_NEW)
                     for i, (_, t) in enumerate(turn2)])
        launches = LAUNCHES["flash_decode"]
        forwards = engine.forwards - forwards0
        peak = torch.cuda.max_memory_allocated()
        for d in (done1, done2):
            for c in d.values():
                if len(c.tokens) != PREFIX_NEW:
                    raise AssertionError(f"serve_prefix {way}: request "
                                         f"{c.rid} gave {len(c.tokens)}")
        if launches != model.cfg.n_layers * forwards or forwards == 0:
            raise AssertionError(f"serve_prefix {way}: flash_decode "
                                 f"launches {launches} over {forwards} "
                                 f"forwards")
        got = {k: getattr(engine, k) - c0[k] for k in c0}
        want, arith = prefix_expected(
            turn1, turn2, lanes.get("prefill_chunk"),
            lanes.get("prefix_cache", False))
        log(f"  {way}: counters {got}; the mix implies {want} ({arith})")
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"serve_prefix {way}: lane counters "
                                 f"{got} != {want}")
        if way == "off":
            ref1, ref2 = done1, done2
            cmp = (0.0, 0, 0)
        else:
            w1, d1, r1 = compare_streams(done1, ref1, SERVE_REL_TOL,
                                         f"serve_prefix {way}")
            same = {k: c for k, c in done2.items()
                    if list(c.prompt) == list(ref2[k].prompt)}
            w2, d2, r2 = compare_streams(same, {k: ref2[k] for k in same},
                                         SERVE_REL_TOL,
                                         f"serve_prefix {way}")
            cmp = (max(w1, w2), d1 + d2 + len(done2) - len(same), r1 + r2)
        gen = PREFIX_NEW * (len(turn1) + len(turn2))
        res[way] = {
            "lanes": lanes, "counters": got, "expected": want,
            "arithmetic": arith,
            "prefix_cache_hit_rate": (
                got["prefix_hit_blocks"] / got["prefix_lookup_blocks"]
                if got["prefix_lookup_blocks"] else 0.0),
            "cow_total": engine.cache.cow_total,
            "turn1": dict(window_numbers(engine, *win1), wall_s=wall1),
            "turn2": dict(window_numbers(engine, *win2), wall_s=wall2),
            "decode_tokens_per_s": gen / (wall1 + wall2),
            "forwards": forwards, "flash_decode_launches": launches,
            "vs_cache_off_max_rel": cmp[0], "near_tie_divergences": cmp[1],
            "rows_compared": cmp[2], "max_memory_allocated": peak}
        log(f"  {way}: TTFT p50 turn 1 {res[way]['turn1']['ttft_p50_ms']:.1f}"
            f" ms, turn 2 {res[way]['turn2']['ttft_p50_ms']:.1f} ms, "
            f"{res[way]['decode_tokens_per_s']:.1f} tokens/s, vs cache off "
            f"{cmp[0]:.3e} over {cmp[2]} rows, {cmp[1]} near-tie "
            f"divergences, peak {peak / 1e9:.2f} GB")
        del engine
    gc.collect()
    torch.cuda.empty_cache()
    long = {"monolithic": long_prompt_steps(model, None, SEED),
            "chunked": long_prompt_steps(model, PREFIX_CHUNK, SEED)}
    log(f"  decode step while a {LONG_PROMPT}-token prompt prefills beside "
        f"15 running sequences: {long}")
    return {"model": "llama2-7b", "engine": {
        k: v for k, v in SERVE_ENGINE.items() if k != "keep_logits"},
        "mix": f"16 x ({PREFIX_SYSTEM} shared + 16-256) tokens, "
               f"{PREFIX_NEW} new; {PREFIX_TURN2} second turns (+16-64)",
        "ways": res, "long_prompt": long,
        "flash_decode_launches": sum(r["flash_decode_launches"]
                                     for r in res.values())}


class RejectionWatch:
    """Watches a SpecEngine's verify rounds: each draft row the target
    rejects must be a near-tie of the verify row (the gap between the
    target's argmax and the draft token within ``tol``·max|row|)."""

    def __init__(self, engine, tol):
        self.engine, self.tol = engine, tol
        self.rejected, self.worst_gap = 0, 0.0
        self._drafts, self._pos = {}, {}
        propose, emit = engine.draft.propose, engine._emit_token

        def watched_propose(seqs, ks):
            out = propose(seqs, ks)
            for s, d in zip(seqs, out):
                self._drafts[s.rid], self._pos[s.rid] = list(d), 0
            return out

        def watched_emit(seq, row):
            d = self._drafts.get(seq.rid)
            if d is not None:
                i = self._pos[seq.rid]
                self._pos[seq.rid] = i + 1
                if i < len(d) and int(np.argmax(row)) != d[i]:
                    self.rejected += 1
                    gap = float(row.max() - row[d[i]]) / float(
                        np.abs(row).max())
                    self.worst_gap = max(self.worst_gap, gap)
                    if gap > tol:
                        raise AssertionError(
                            f"serve_spec: the target rejected a draft "
                            f"token {gap:.3e} below its argmax (> {tol})")
            emit(seq, row)

        engine.draft.propose = watched_propose
        engine._emit_token = watched_emit


def serve_spec_phase(model):
    """The speculative lane at full width: the serve phase's 16-request
    mix through the plain engine, SpecEngine(spec_k=4) with the n-gram
    draft, and SpecEngine(spec_k=4) with a ModelDraft of the target
    itself (a second 32-layer KV pool); streams against the plain run's,
    row 9 launched 32 times a forward (target and draft)."""
    from tony_tpu_torch.serve import SpecEngine
    reqs = [(f"s-{i}", toks, n) for i, (toks, n) in
            enumerate(serve_mix(SEED, model.cfg.vocab))]
    gen = sum(n for _, _, n in reqs)
    res, ref = {}, None
    for way in ("plain", "ngram", "self_draft"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if way == "plain":
            engine = ServeEngine(model, **SERVE_ENGINE)
        else:
            engine = SpecEngine(
                model, spec_k=4, **SERVE_ENGINE,
                **({"draft_model": model} if way == "self_draft" else {}))
        EngineFront(engine).generate([1, 2, 3, 4], 6)       # warm-up
        watch = RejectionWatch(engine, SERVE_REL_TOL) \
            if way == "self_draft" else None
        draft = getattr(engine, "draft", None)
        forwards0 = engine.forwards + getattr(draft, "forwards", 0)
        LAUNCHES["flash_decode"] = 0
        done, wall, win = drive(engine, reqs)
        launches = LAUNCHES["flash_decode"]
        forwards = (engine.forwards + getattr(draft, "forwards", 0)
                    - forwards0)
        peak = torch.cuda.max_memory_allocated()
        for rid, _, n in reqs:
            if len(done[rid].tokens) != n:
                raise AssertionError(f"serve_spec {way}: {rid} gave "
                                     f"{len(done[rid].tokens)} of {n}")
        if launches != model.cfg.n_layers * forwards or forwards == 0:
            raise AssertionError(f"serve_spec {way}: flash_decode launches "
                                 f"{launches} != {model.cfg.n_layers} x "
                                 f"{forwards} forwards")
        out = {"decode_tokens_per_s": gen / wall, "wall_s": wall,
               **window_numbers(engine, *win), "forwards": forwards,
               "flash_decode_launches": launches,
               "max_memory_allocated": peak}
        if way == "plain":
            ref = done
        else:
            worst, div, rows = compare_streams(done, ref, SERVE_REL_TOL,
                                               f"serve_spec {way}")
            st = engine.stats()
            out.update({k: st[k] for k in (
                "acceptance_rate", "tokens_per_verify",
                "tokens_per_seq_round", "spec_proposed", "spec_accepted",
                "verify_launches", "draft_forwards")})
            out.update(vs_plain_max_rel=worst, near_tie_divergences=div,
                       rows_compared=rows)
            if watch is not None:
                out.update(rejected=watch.rejected,
                           rejected_worst_gap=watch.worst_gap)
                # A round's first rejection ends it, so the rejections
                # seen are the rounds that lost proposals.
                lost = st["spec_proposed"] - st["spec_accepted"]
                if (lost > 0) != (watch.rejected > 0) \
                        or watch.rejected > lost:
                    raise AssertionError(
                        f"serve_spec: {watch.rejected} rejections seen, "
                        f"{lost} proposals lost")
        log(f"  {way}: {json.dumps(out)}")
        res[way] = out
        del engine, draft, watch
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": "llama2-7b", "spec_k": 4, "engine": {
        k: v for k, v in SERVE_ENGINE.items() if k != "keep_logits"},
        "mix": "serve_mix(SEED): 16 prompts of 16-512 tokens, 16-64 new",
        "ways": res,
        "flash_decode_launches": sum(r["flash_decode_launches"]
                                     for w, r in res.items()
                                     if w != "plain")}


# ---------------------------------------------------------------------
# Disaggregated serving: a prefill-role and a decode-role engine on one
# model, each behind the port's RPC server, the KV blocks shipped over a
# loopback socket, the port's router dispatching.
# ---------------------------------------------------------------------

class DisaggWatch:
    """What the split engines did that the wire does not carry back: the
    decode engine's completions (with their logits rows), the wire size
    of each export (blocks, base64 characters), and, at the first
    import, whether the decode pool's new blocks are ``torch.equal`` to
    the prefill pool's exported blocks (the prefill side freed them at
    export, and nothing reuses them before the first import)."""

    def __init__(self, pf, dc):
        self.done, self.wire, self.exported = {}, {}, {}
        self.first_import = None
        step, export, imp = dc.step, pf.cache.export_blocks, \
            dc.cache.import_blocks

        def watched_step():
            out = step()
            for c in out:
                self.done[c.rid] = c
            return out

        def watched_export(seq_id, length):
            blocks = export(seq_id, length)
            self.exported[seq_id] = pf.cache.table(seq_id)[:len(blocks)]
            self.wire[seq_id] = (len(blocks), sum(
                len(b["k"]) + len(b["v"]) for b in blocks))
            return blocks

        def watched_import(seq_id, length, blocks, *, keys=(), offset=0):
            adopted = imp(seq_id, length, blocks, keys=keys, offset=offset)
            if self.first_import is None and blocks:
                ids = torch.as_tensor(dc.cache.table(seq_id)[
                    offset:offset + len(blocks)], device=dc.device)
                src = torch.as_tensor(self.exported[seq_id][offset:],
                                      device=pf.device)
                same = all(torch.equal(a.index_select(1, ids),
                                       b.index_select(1, src).to(a.device))
                           for a, b in ((dc.cache.k, pf.cache.k),
                                        (dc.cache.v, pf.cache.v)))
                self.first_import = {"rid": seq_id, "blocks": len(blocks),
                                     "torch_equal": same}
            return adopted

        dc.step = watched_step
        pf.cache.export_blocks = watched_export
        dc.cache.import_blocks = watched_import

    def completion(self, rid):
        """The completion the router returned for ``rid``: the fallback's
        when the handoff fell back."""
        return self.done.get(f"{rid}~fallback") or self.done[rid]


class SplitReplica:
    """The request surface of ``serve.replica.Replica`` over an engine
    built here (no checkpoint restore), served by the replica's own RPC
    handler on a free loopback port."""

    def __init__(self, engine):
        from tony_tpu_torch.rpc import RpcServer
        from tony_tpu_torch.serve.disagg import DecodeFront, PrefillFront
        from tony_tpu_torch.serve.replica import _ReplicaRpcHandler

        self.engine = engine
        self._front = EngineFront(engine)
        self._prefill_front = PrefillFront(self._front)
        self._decode_front = DecodeFront(self._front)
        self.server = RpcServer(_ReplicaRpcHandler(self),
                                host="127.0.0.1").start()

    def generate(self, tokens, max_new_tokens, rid=None, conv=None,
                 tenant=None):
        return self._front.generate(tokens, max_new_tokens, rid=rid,
                                    conv=conv, tenant=tenant)

    def prefill_handoff(self, tokens, max_new_tokens, rid=None,
                        decode=None, conv=None, tenant=None):
        return self._prefill_front.prefill_handoff(
            tokens, max_new_tokens, rid=rid, decode=decode, conv=conv,
            tenant=tenant)

    def kv_offer(self, keys):
        return self._decode_front.kv_offer(keys)

    def kv_import(self, payload):
        return self._decode_front.kv_import(payload)


def split_router(pf, dc):
    """``pf`` and ``dc`` as :class:`SplitReplica` s behind their RPC
    servers, and the port's router over them built as ``cli route``
    builds it (``RequestRouter(block_size=...)``: its own RPC dial, the
    15 s retry window, the wait for a reply of ``REPLY_TIMEOUT_S``); one
    request through the split as a warm-up. Returns the router and the
    servers' stop."""
    from tony_tpu_torch.serve import RequestRouter

    reps = {"prefill:0": SplitReplica(pf), "decode:0": SplitReplica(dc)}
    router = RequestRouter(block_size=SERVE_ENGINE["block_size"])
    for name, rep in reps.items():
        router.upsert_replica(name, address=rep.server.address,
                              stats=rep.engine.stats())
    router.dispatch([1, 2, 3, 4], 2, rid="warm-up")
    return router, lambda: [rep.server.stop() for rep in reps.values()]


def resent():
    """This process's RPC transport faults so far, by method."""
    from tony_tpu_torch import rpc as rpc_mod
    return dict(rpc_mod.RESENDS)


class SplitCounters:
    """The split's counters at one moment; ``since`` gives a pass's
    numbers from two of them."""

    def __init__(self, router, pf, dc):
        st = router.stats()
        self.values = {
            "handoffs": st["handoffs"], "fallbacks": st["handoff_fallbacks"],
            "failovers": st["failovers"], "export_ms": pf.handoff_ms,
            "import_ms": dc.handoff_ms, "blocks_shipped": pf.blocks_shipped,
            "imports_failed": dc.imports_failed,
            "pf_forwards": pf.forwards, "dc_forwards": dc.forwards,
            "dc_replays": dc.graph_replays(),
            "dc_replayed": dc.graph_launches().get("flash_decode", 0)}

        self.resends = resent()

    def since(self, before):
        d = {k: v - before.values[k] for k, v in self.values.items()}
        d["resends"] = {m: n - before.resends.get(m, 0)
                        for m, n in self.resends.items()
                        if n != before.resends.get(m, 0)}
        return d


def split_pass(tag, router, pf, dc, watch, reqs, concurrent, n_layers):
    """``reqs`` ((rid, tokens, max_new)) through ``router.dispatch``, one
    at a time or from one thread each. Row 9's launches are counted
    exactly: the eager ones (``LAUNCHES``, reset here) and the decode
    engine's replays together are ``n_layers`` times both engines'
    forwards. Returns the pass's numbers and the router's outputs."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    before = SplitCounters(router, pf, dc)
    LAUNCHES["flash_decode"] = 0
    walls = [None] * len(reqs)

    def one(i):
        rid, toks, n = reqs[i]
        t0 = time.monotonic()
        out = router.dispatch(toks, n, rid=rid)
        walls[i] = 1e3 * (time.monotonic() - t0)
        return out

    t0 = time.monotonic()
    if concurrent:
        outs = run_threads(one, len(reqs))
    else:
        outs = [one(i) for i in range(len(reqs))]
    torch.cuda.synchronize()
    t1 = time.monotonic()
    d = SplitCounters(router, pf, dc).since(before)
    eager = LAUNCHES["flash_decode"]
    launches = eager + d["dc_replayed"]
    forwards = d["pf_forwards"] + d["dc_forwards"]
    if launches != n_layers * forwards or forwards == 0:
        raise AssertionError(f"serve_disagg {tag}: flash_decode launches "
                             f"{eager} eager + {d['dc_replayed']} replayed "
                             f"!= {n_layers} x {forwards} forwards")
    if d["dc_replays"] == d["dc_forwards"] and (
            d["dc_replayed"] != n_layers * d["dc_forwards"]
            or eager != n_layers * d["pf_forwards"]):
        # Every decode forward replayed: the two engines' launches apart.
        raise AssertionError(f"serve_disagg {tag}: decode engine "
                             f"{d['dc_replayed']} replayed launches for "
                             f"{d['dc_forwards']} forwards, prefill engine "
                             f"{eager} for {d['pf_forwards']}")
    for (rid, _, n), out in zip(reqs, outs):
        if out["rid"] != rid or len(out["tokens"]) != n:
            raise AssertionError(f"serve_disagg {tag}: {rid} gave {out}")
    blocks = [watch.wire[rid][0] for rid, _, _ in reqs
              if rid in watch.wire]
    b64 = [watch.wire[rid][1] for rid, _, _ in reqs if rid in watch.wire]
    raw_block = 2 * n_layers * pf.block_size * pf.kv_dim \
        * pf.cache.k.element_size()
    gen = sum(n for _, _, n in reqs)
    res = {"requests": len(reqs), "concurrent": concurrent,
           "handoffs": d["handoffs"], "fallbacks": d["fallbacks"],
           "failovers": d["failovers"],
           "rpc_resends": sum(d["resends"].values()),
           "rpc_resends_by_method": d["resends"],
           "imports_failed": d["imports_failed"],
           "blocks_shipped": d["blocks_shipped"],
           "wire_raw_bytes": raw_block * sum(blocks),
           "wire_raw_bytes_per_request": [raw_block * b for b in blocks],
           "wire_b64_bytes_per_request": b64,
           "export_ms": d["export_ms"], "import_ms": d["import_ms"],
           "request_wall_ms": walls,
           "request_wall_p50_ms": float(np.median(walls)),
           "wall_s": t1 - t0, "decode_tokens_per_s": gen / (t1 - t0),
           "decode_engine": window_numbers(dc, t0, t1),
           "prefill_engine": window_numbers(pf, t0, t1),
           "forwards": {"prefill": d["pf_forwards"],
                        "decode": d["dc_forwards"],
                        "decode_replayed": d["dc_replays"]},
           "flash_decode_launches": launches,
           "flash_decode_launches_eager": eager,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"  {tag}: {json.dumps({k: v for k, v in res.items() if not k.endswith('per_request') and k != 'request_wall_ms'})}")
    return res, outs


def serve_disagg_phase(model, serve_results):
    """Disaggregated serving at the serve phase's full width: a
    prefill-role and a decode-role ``ServeEngine`` on the one model, each
    behind the port's RPC server answering the replica's verbs (the KV
    crosses a real loopback socket), the port's ``RequestRouter``
    dispatching to them as role replicas. (a) the serve mix one request
    at a time, against a colocated engine one at a time: tokens and
    every logits row equal, 16 handoffs, no fallback or failover, the
    mix's blocks shipped, the first import's blocks ``torch.equal`` to the exported
    ones (the colocated engine's decode steps replayed CUDA graphs, the
    split decode engine's eager); (b) the longest request again after
    ``warm()`` on the decode engine (its decode steps replayed CUDA
    graphs, reading the imported blocks): equal to (a); (c)
    the mix from 16 threads, against the serve phase's completions
    within ``SERVE_REL_TOL`` with greedy tokens equal up to a near-tie.
    Row 9 launched ``n_layers`` times a forward on both engines."""
    cfg = model.cfg
    mix = serve_mix(SEED, cfg.vocab)
    want_blocks = sum(-(-len(t) // SERVE_ENGINE["block_size"])
                      for t, _ in mix)
    # Colocated reference, one request at a time, its decode steps
    # replayed CUDA graphs (the eager steps' bits, a quarter of their
    # host time).
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    co = ServeEngine(model, **SERVE_ENGINE)
    co.warm()
    co_front = EngineFront(co)
    co_front.generate([1, 2, 3, 4], 2)                 # warm-up
    ref, co_walls = {}, []
    forwards0 = co.forwards
    replayed0 = co.graph_launches().get("flash_decode", 0)
    LAUNCHES["flash_decode"] = 0
    t0 = time.monotonic()
    for i, (toks, n) in enumerate(mix):
        t1 = time.monotonic()
        ref[f"a-{i}"] = co_front.generate(toks, n, rid=f"a-{i}")
        co_walls.append(1e3 * (time.monotonic() - t1))
    torch.cuda.synchronize()
    t1 = time.monotonic()
    co_forwards = co.forwards - forwards0
    co_launches = LAUNCHES["flash_decode"] + co.graph_launches().get(
        "flash_decode", 0) - replayed0
    if co_launches != cfg.n_layers * co_forwards:
        raise AssertionError(f"serve_disagg colocated: launches "
                             f"{co_launches} != {cfg.n_layers} x "
                             f"{co_forwards}")
    gen = sum(n for _, n in mix)
    colocated = {"wall_s": t1 - t0, "decode_tokens_per_s": gen / (t1 - t0),
                 "engine": window_numbers(co, t0, t1),
                 "request_wall_ms": co_walls,
                 "request_wall_p50_ms": float(np.median(co_walls)),
                 "forwards": co_forwards,
                 "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"  colocated, one at a time: {gen} tokens in {t1 - t0:.2f} s")
    # The split.
    pf = ServeEngine(model, role="prefill", **SERVE_ENGINE)
    dc = ServeEngine(model, role="decode", **SERVE_ENGINE)
    watch = DisaggWatch(pf, dc)
    router, stop = split_router(pf, dc)
    try:
        watch.first_import = None       # check the mix's first, 28 blocks
        reqs = [(f"a-{i}", toks, n) for i, (toks, n) in enumerate(mix)]
        res_a, _ = split_pass("(a) sequential", router, pf, dc, watch,
                              reqs, False, cfg.n_layers)
        rows = same_streams({rid: watch.completion(rid)
                             for rid, _, _ in reqs}, ref,
                            "serve_disagg (a)")
        if res_a["handoffs"] != len(mix) or res_a["fallbacks"] \
                or res_a["failovers"] \
                or res_a["blocks_shipped"] != want_blocks \
                or not (watch.first_import or {}).get("torch_equal"):
            raise AssertionError(f"serve_disagg (a): {res_a['handoffs']} "
                                 f"handoffs, {res_a['fallbacks']} "
                                 f"fallbacks, {res_a['failovers']} "
                                 f"failovers, {res_a['blocks_shipped']} "
                                 f"blocks (want {want_blocks}), first "
                                 f"import {watch.first_import}")
        res_a.update(bitwise_rows=rows, first_import=watch.first_import)
        del co_front, co
        free_cuda()
        # (b): the longest request after warm() on the decode engine.
        warmed = dc.warm()
        longest = max(range(len(mix)), key=lambda i: len(mix[i][0]))
        toks, n = mix[longest]
        res_b, _ = split_pass("(b) after warm()", router, pf, dc, watch,
                              [(f"b-{longest}", toks, n)], False,
                              cfg.n_layers)
        if res_b["forwards"]["decode_replayed"] \
                != res_b["forwards"]["decode"]:
            raise AssertionError(f"serve_disagg (b): {res_b['forwards']}: "
                                 f"a decode forward was not a replay")
        same_streams({f"a-{longest}": watch.completion(f"b-{longest}")},
                     {f"a-{longest}": ref[f"a-{longest}"]},
                     "serve_disagg (b)")
        res_b.update(warmed_programs=warmed, request=longest,
                     equal_to_a=True)
        # (c): the mix from 16 threads.
        reqs_c = [(f"c-{i}", toks, n) for i, (toks, n) in enumerate(mix)]
        res_c, _ = split_pass("(c) concurrent", router, pf, dc, watch,
                              reqs_c, True, cfg.n_layers)
        worst, div, rows_c = compare_streams(
            {i: watch.completion(f"c-{i}") for i in range(len(mix))},
            dict(enumerate(serve_results)), SERVE_REL_TOL,
            "serve_disagg (c)")
        res_c.update(vs_serve_max_rel=worst, near_tie_divergences=div,
                     rows_compared=rows_c, tol=SERVE_REL_TOL)
    finally:
        stop()
    launches = sum(r["flash_decode_launches"] for r in (res_a, res_b, res_c))
    del watch, pf, dc, router
    free_cuda()
    return {"model": "llama2-7b", "engine": {
        k: v for k, v in SERVE_ENGINE.items() if k != "keep_logits"},
        "mix": "serve_mix(SEED): 16 prompts of 24-475 tokens, 16-64 new",
        "want_blocks": want_blocks, "colocated": colocated,
        "a_sequential": res_a, "b_after_warm": res_b,
        "c_concurrent": res_c, "flash_decode_launches": launches}


# ---------------------------------------------------------------------
# The KV memory hierarchy and the tenants: parking, the demotion daemon,
# the persisted prefix store, QoS budgets, a routed session.
# ---------------------------------------------------------------------

KVTIER_HOST_BLOCKS = 512   # 4 GiB raw at 7B (8 MiB a block)
KVTIER_POOL = 128          # device blocks of a one-at-a-time engine
KVTIER_DAEMON_POOL = 192   # (b): the running prefix mix crosses 0.5 of it
KVTIER_DAEMON_CONVERSATIONS = 8   # (b): the prefix mix cut from 16 (time)
KVTIER_QOS_POOL = 128      # (d): the aggressor burst outgrows its share
KVTIER_TENANTS = "gold:3,silver:1"
KVTIER_TURN2_NEW = 16      # (a): tokens generated in a second turn


def kvtier_engine(model, **kw):
    """A serve engine of the phase on the model's device: the serve
    cell's geometry, a pool of ``KVTIER_POOL`` blocks unless ``kw``
    names another (the pool's size changes no launch: the step gathers
    through the block tables)."""
    return ServeEngine(model, **{**SERVE_ENGINE, "n_blocks": KVTIER_POOL,
                                 "device": next(model.parameters()).device,
                                 **kw})


class Row9:
    """Row 9's launches over one pass: ``LAUNCHES`` set to 0 when the
    pass starts (after any ``warm()``), the engines' forwards and
    replayed launches read when it ends; eager + replayed launches must
    be ``n_layers`` times the engines' forwards."""

    def __init__(self, engines):
        self.engines = list(engines)
        self.forwards0 = sum(e.forwards for e in self.engines)
        self.replayed0 = sum(e.graph_launches().get("flash_decode", 0)
                             for e in self.engines)
        self.banked = 0
        LAUNCHES["flash_decode"] = 0

    def eager_from_now(self, engine):
        """Set ``engine``'s captured steps aside (its later launches run
        eager), banking the launches their replays made. Returns them
        for :meth:`replay_from_now`."""
        fns = dict(engine._aot_fns)
        self.banked += engine.graph_launches().get("flash_decode", 0)
        engine._aot_fns.clear()
        return fns

    def replay_from_now(self, engine, fns):
        """Put the captured steps ``fns`` back: ``engine``'s later
        launches replay them (the replays before were banked)."""
        engine._aot_fns.update(fns)
        self.banked -= engine.graph_launches().get("flash_decode", 0)

    def close(self, tag, n_layers):
        eager = LAUNCHES["flash_decode"]
        replayed = self.banked + sum(
            e.graph_launches().get("flash_decode", 0)
            for e in self.engines) - self.replayed0
        forwards = sum(e.forwards for e in self.engines) - self.forwards0
        if eager + replayed != n_layers * forwards or forwards == 0:
            raise AssertionError(f"serve_kvtier {tag}: flash_decode "
                                 f"launches {eager} eager + {replayed} "
                                 f"replayed != {n_layers} x {forwards} "
                                 f"forwards")
        return {"flash_decode_launches": eager + replayed,
                "flash_decode_launches_replayed": replayed,
                "forwards": forwards}


class TierWatch:
    """The host tier of one engine, watched: each park and resume timed
    on the drive thread (a resume's wait for the offload thread's encode
    included); with ``snapshot``, the blocks each park takes copied on
    the card first (``snaps``, by parked id), and each resume's
    re-staged blocks held against them with ``torch.equal``; raw and
    base64 bytes of every resumed record. :meth:`numbers` reports what
    happened since its last call."""

    def __init__(self, engine, snapshot=False):
        cache = engine.cache
        park, resume = cache.park, cache.resume
        self.engine = engine
        self.snaps = {}
        self._start()
        raw_block = 2 * cache.n_layers * cache.block_size * cache.kv_dim \
            * cache.k.element_size()

        def watched_park(seq_id, length, *, keys=()):
            if snapshot:
                ids = torch.as_tensor(
                    cache.table(seq_id)[:cache.blocks_for(length)],
                    device=cache.k.device)
                self.snaps[seq_id] = (cache.k.index_select(1, ids),
                                      cache.v.index_select(1, ids))
            t0 = time.monotonic()
            try:
                n = park(seq_id, length, keys=keys)
            except AdmissionError:
                self.snaps.pop(seq_id, None)
                raise
            self.park_ms.append(1e3 * (time.monotonic() - t0))
            return n

        def watched_resume(new_id, length, parked_id):
            t0 = time.monotonic()
            rec = cache._parked.get(parked_id)
            if rec is not None:
                rec["ready"].wait()
            adopted = resume(new_id, length, parked_id)
            self.resume_ms.append(1e3 * (time.monotonic() - t0))
            self.resumed_blocks += rec["n"]
            self.raw_bytes += raw_block * rec["n"]
            self.b64_bytes += sum(len(b["k"]) + len(b["v"])
                                  for b in rec["blocks"])
            snap = self.snaps.pop(parked_id, None)
            if snap is not None:
                ids = torch.as_tensor(cache.table(new_id)[:rec["n"]],
                                      device=cache.k.device)
                self.equal.append(
                    torch.equal(cache.k.index_select(1, ids), snap[0])
                    and torch.equal(cache.v.index_select(1, ids), snap[1]))
            return adopted

        cache.park = watched_park
        cache.resume = watched_resume

    def _counters(self):
        e, c = self.engine, self.engine.cache
        return {"parks": c.parked_total, "resumes": c.resumed_total,
                "park_hits": e.park_hits, "demotions": c.demoted_total,
                "promotions": c.promoted_total}

    def _start(self):
        self.park_ms, self.resume_ms, self.equal = [], [], []
        self.raw_bytes = self.b64_bytes = self.resumed_blocks = 0
        self._base = self._counters()

    def keep_parked(self):
        """The engine's parked conversations as they stand: its
        conversation map, the host tier's records and their snapshots
        (a record's payloads are strings, never written again, so
        shallow copies keep them whole)."""
        e = self.engine
        return dict(e._parked), dict(e.cache._parked), dict(self.snaps)

    def put_back(self, kept):
        """Drop the conversations parked since :meth:`keep_parked` and
        put its records back, so a turn can resume them again."""
        e = self.engine
        for rec in list(e._parked.values()):
            e.cache.unpark(rec["rid"])
        convs, recs, snaps = kept
        e._parked.clear()
        e._parked.update(convs)
        e.cache._parked.update(recs)
        self.snaps.clear()
        self.snaps.update(snaps)

    def numbers(self):
        now = self._counters()
        out = {k: now[k] - self._base[k] for k in now}
        out.update({
            "host_blocks_used": self.engine.cache.host_blocks_used,
            "restaged_torch_equal": sum(self.equal),
            "resumed_blocks": self.resumed_blocks,
            "resumed_raw_bytes": self.raw_bytes,
            "resumed_b64_bytes": self.b64_bytes,
            "park_ms_mean": float(np.mean(self.park_ms))
            if self.park_ms else 0.0,
            "resume_ms_mean": float(np.mean(self.resume_ms))
            if self.resume_ms else 0.0,
            "park_ms_total": float(sum(self.park_ms)),
            "resume_ms_total": float(sum(self.resume_ms))})
        self._start()
        return out


def converse(front, convs, turns, tag):
    """Each conversation's turn ``turns`` (a list of (prompt, max_new)
    by conversation), one request at a time, tagged ``conv=`` when
    ``tag``. Returns the completions by conversation index, the
    generated tokens and the wall seconds."""
    out = {}
    t0 = time.monotonic()
    for i, (toks, n) in enumerate(turns):
        out[i] = front.generate(toks, n, rid=f"{tag}-{i}",
                                conv=convs[i] if convs else None)
    torch.cuda.synchronize()
    return out, sum(n for _, n in turns), time.monotonic() - t0


def kvtier_parking(model, n_layers):
    """(a): the serve mix's 16 prompts as turn 1 of 16 conversations,
    turn 2 each history + 16-64 seeded new tokens (16 generated), one
    request at a time, on an engine with the host tier and one without
    (both warmed: their decode steps replay CUDA graphs). Turn 1 runs on
    the host-tier engine, parking every conversation. Turn 2 runs there
    twice from the same parked records: eager (its captured steps set
    aside: every resume re-staged into the stores the next launch
    reads), then, with the turn-1 records put back, replayed (the
    re-staged blocks read by the captured graphs); and once on the
    never-parked engine."""
    cfg = model.cfg
    mix = serve_mix(SEED, cfg.vocab)
    rng = np.random.default_rng(SEED + 5)
    more = [rng.integers(0, cfg.vocab, int(rng.integers(16, 65))).tolist()
            for _ in range(len(mix))]
    convs = [f"c{i}" for i in range(len(mix))]
    plain = kvtier_engine(model)
    host = kvtier_engine(model, host_blocks=KVTIER_HOST_BLOCKS,
                         async_offload=True)
    for e in (plain, host):
        e.warm()
    watch = TierWatch(host, snapshot=True)
    fronts = {e: EngineFront(e) for e in (plain, host)}
    for front in fronts.values():
        front.generate([1, 2, 3, 4], 2, rid="warm-up")
    torch.cuda.reset_peak_memory_stats()
    row9 = Row9([plain, host])
    got1, _, _ = converse(fronts[host], convs, mix, "k1")
    turn1 = watch.numbers()
    kept = watch.keep_parked()
    turn2 = [(list(mix[i][0]) + list(got1[i].tokens) + more[i],
              KVTIER_TURN2_NEW) for i in range(len(mix))]
    fns = row9.eager_from_now(host)
    rows0 = host.prefill_rows
    got2, gen, parked_s = converse(fronts[host], convs, turn2, "k2")
    parked_rows = host.prefill_rows - rows0
    eager = watch.numbers()
    rows0 = plain.prefill_rows
    ref2, _, plain_s = converse(fronts[plain], None, turn2, "p2")
    plain_rows = plain.prefill_rows - rows0
    worst, div, rows = compare_streams(got2, ref2, SERVE_REL_TOL,
                                       "serve_kvtier (a) turn 2")
    watch.put_back(kept)
    row9.replay_from_now(host, fns)
    rep2, _, replayed_s = converse(fronts[host], convs, turn2, "r2")
    replayed = watch.numbers()
    same_streams(rep2, got2, "serve_kvtier (a) replayed turn 2")
    launches = row9.close("(a)", n_layers)
    for tag, nums in (("eager", eager), ("replayed", replayed)):
        if nums["park_hits"] != len(mix):
            raise AssertionError(f"serve_kvtier (a) {tag}: park hits "
                                 f"{nums['park_hits']}, want {len(mix)}")
        if nums["restaged_torch_equal"] != len(mix):
            raise AssertionError(f"serve_kvtier (a) {tag}: re-staged "
                                 f"records equal to the parked ones: "
                                 f"{nums['restaged_torch_equal']} of "
                                 f"{len(mix)}")
    if not parked_rows < plain_rows:
        raise AssertionError(f"serve_kvtier (a): turn 2 prefilled "
                             f"{parked_rows} rows, the never-parked "
                             f"engine {plain_rows}")
    if launches["flash_decode_launches_replayed"] == 0:
        raise AssertionError("serve_kvtier (a): no decode step replayed")
    res = {"conversations": len(mix), "turn2_new_tokens": gen,
           "turn1": turn1, "eager_turn2": eager, "replayed_turn2": replayed,
           "turn2_prefill_rows": parked_rows,
           "never_parked_turn2_prefill_rows": plain_rows,
           "turn2_tokens_per_s": {"parked_eager": gen / parked_s,
                                  "parked_replayed": gen / replayed_s,
                                  "never_parked_replayed": gen / plain_s},
           "vs_never_parked_max_rel": worst,
           "near_tie_divergences": div, "rows_compared": rows,
           "replayed_equal_to_eager": True,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **launches}
    host.cache.close()
    log(f"  (a) parking: {json.dumps(res)}")
    return res


def kvtier_daemon(model, n_layers):
    """(b): the prefix mix cut to 8 conversations (turn 1 of 8, then two
    waves of 4 second turns), each wave from one submission, on a
    prefix-cache engine with the host tier and the demotion daemon at
    watermark 0.5 over a pool the running waves cross it in, against a
    host-tier-off engine."""
    cfg = model.cfg
    turn1, more = prefix_mix(SEED, cfg.vocab)
    turn1 = turn1[:KVTIER_DAEMON_CONVERSATIONS]
    kw = dict(prefix_cache=True, n_blocks=KVTIER_DAEMON_POOL)
    host = kvtier_engine(model, host_blocks=KVTIER_HOST_BLOCKS,
                         demote_watermark=0.5, **kw)
    off = kvtier_engine(model, **kw)
    torch.cuda.reset_peak_memory_stats()
    row9 = Row9([host, off])
    reqs = [(f"d1-{i}", toks, PREFIX_NEW) for i, toks in enumerate(turn1)]
    ref1, off_s, _ = drive(off, reqs)
    got1, host_s, _ = drive(host, reqs)
    # Second turns of conversations 0-3 (their ~80-block requests hold
    # the pool past the watermark, and the daemon demotes the cold own
    # blocks of the others), then of 4-7 (whose demoted blocks promote).
    waves = []
    for w, base in enumerate((0, len(more))):
        reqs2 = [(f"d{w + 2}-{base + j}", list(turn1[base + j])
                  + list(ref1[f"d1-{base + j}"].tokens) + more[j],
                  PREFIX_NEW) for j in range(len(more))]
        ref2, _, _ = drive(off, reqs2)
        got2, _, _ = drive(host, reqs2)
        waves.append((got2, ref2, w + 2))
        reqs += reqs2
    launches = row9.close("(b)", n_layers)
    worst, div, rows = 0.0, 0, 0
    for got, ref, turn in [(got1, ref1, 1)] + waves:
        w, d, r = compare_streams(got, ref, SERVE_REL_TOL,
                                  f"serve_kvtier (b) turn {turn}")
        worst, div, rows = max(worst, w), div + d, rows + r
    st = host.stats()
    if host.daemon_demotions <= 0 or st["promotions"] <= 0:
        raise AssertionError(f"serve_kvtier (b): daemon demotions "
                             f"{host.daemon_demotions}, promotions "
                             f"{st['promotions']}")
    gen = PREFIX_NEW * len(turn1)
    res = {"requests": len(reqs), "pool_blocks":
           KVTIER_DAEMON_POOL, "watermark": 0.5,
           "demote_batch": host.demote_batch,
           "daemon_demotions": host.daemon_demotions,
           "demotions": st["demotions"], "promotions": st["promotions"],
           "host_blocks_used": st["host_blocks"],
           "host_degraded": host.host_degraded,
           "prefill_rows": {"host_tier": host.prefill_rows,
                            "off": off.prefill_rows},
           "prefix_hit_blocks": {"host_tier": host.prefix_hit_blocks,
                                 "off": off.prefix_hit_blocks},
           "turn1_tokens_per_s": {"host_tier": gen / host_s,
                                  "off": gen / off_s},
           "vs_off_max_rel": worst, "near_tie_divergences": div,
           "rows_compared": rows,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **launches}
    log(f"  (b) demotion daemon: {json.dumps(res)}")
    return res


def block_bits(cache, keys):
    """The k and v rows of the blocks indexed under ``keys``."""
    ids = torch.as_tensor([cache._index[k] for k in keys],
                          device=cache.k.device)
    return cache.k.index_select(1, ids), cache.v.index_select(1, ids)


def kvtier_store(model, n_layers):
    """(c): the system prompt's stem, proved hot by a second request on
    an exporting engine, persisted with ``export_stems`` into a
    ``PrefixStore`` under the run's temporary root and adopted by a
    second engine through the replica's ``_load_stems``; one probe
    request on the adopting engine, on the exporting one (its own cache
    hit) and on a cold engine."""
    import tempfile

    from tony_tpu_torch.serve import PrefixStore, prefix

    cfg = model.cfg
    turn1, _ = prefix_mix(SEED, cfg.vocab)
    system = turn1[0][:PREFIX_SYSTEM]
    rng = np.random.default_rng(SEED + 7)
    probe = system + rng.integers(0, cfg.vocab, 100).tolist()
    keys = prefix.chain_keys(system, SERVE_ENGINE["block_size"])
    exporter = kvtier_engine(model, prefix_cache=True)
    adopter = kvtier_engine(model, prefix_cache=True)
    cold = kvtier_engine(model, prefix_cache=True)
    ex_front = EngineFront(exporter)
    row9 = Row9([exporter, adopter, cold])
    for i in range(2):
        ex_front.generate(turn1[i], PREFIX_NEW, rid=f"s-{i}")
    root = tempfile.mkdtemp(prefix="kvtier-stems-")
    try:
        store = PrefixStore(root)
        t0 = time.monotonic()
        wrote = exporter.export_stems(store, lock=ex_front._drive)
        export_s = time.monotonic() - t0
        stub = Replica.__new__(Replica)
        stub.engine, stub._store = adopter, store
        t0 = time.monotonic()
        Replica._load_stems(stub)
        adopt_s = time.monotonic() - t0
        disk_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(root) for f in fs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if wrote < 1 or adopter.store_adopted != len(keys):
        raise AssertionError(f"serve_kvtier (c): {wrote} stem(s) written, "
                             f"{adopter.store_adopted} block(s) adopted "
                             f"of {len(keys)}")
    a, b = block_bits(adopter.cache, keys), block_bits(exporter.cache, keys)
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise AssertionError("serve_kvtier (c): adopted blocks differ from "
                             "the exported ones")
    got = EngineFront(adopter).generate(probe, PREFIX_NEW, rid="probe")
    if adopter.prefix_hit_blocks != len(keys):
        raise AssertionError(f"serve_kvtier (c): the probe hit "
                             f"{adopter.prefix_hit_blocks} adopted blocks, "
                             f"want {len(keys)}")
    hits0 = exporter.prefix_hit_blocks
    own = ex_front.generate(probe, PREFIX_NEW, rid="probe")
    if exporter.prefix_hit_blocks - hits0 != len(keys):
        raise AssertionError("serve_kvtier (c): the exporting engine's own "
                             "hit is not the system stem")
    rows = same_streams({"probe": got}, {"probe": own},
                        "serve_kvtier (c) adopted vs the exporter's hit")
    ref = EngineFront(cold).generate(probe, PREFIX_NEW, rid="probe")
    worst, div, rows_c = compare_streams({"probe": got}, {"probe": ref},
                                         SERVE_REL_TOL,
                                         "serve_kvtier (c) vs cold")
    launches = row9.close("(c)", n_layers)
    res = {"stems_written": wrote, "stem_blocks": len(keys),
           "store_bytes_on_disk": disk_bytes, "export_s": export_s,
           "load_and_adopt_s": adopt_s,
           "adopted_torch_equal_to_exported": True,
           "probe_hit_blocks": len(keys),
           "equal_to_exporters_hit_rows": rows,
           "vs_cold_max_rel": worst, "near_tie_divergences": div,
           "rows_compared": rows_c, **launches}
    log(f"  (c) prefix store: {json.dumps(res)}")
    return res


def kvtier_qos(model, n_layers):
    """(d): tenants gold:3,silver:1 over a small pool, 16 threads: the
    serve mix's first 12 requests from ``silver`` (the aggressor, all
    submitted first), its last 4 from ``gold`` (the victim), against the
    4 gold requests on an unloaded engine."""
    from tony_tpu_torch.serve import QosPolicy, parse_tenants

    cfg = model.cfg
    mix = serve_mix(SEED, cfg.vocab)
    silver, gold = list(range(12)), list(range(12, 16))
    qos = QosPolicy(classes=parse_tenants(KVTIER_TENANTS))
    eng = kvtier_engine(model, n_blocks=KVTIER_QOS_POOL, qos=qos)
    unloaded = kvtier_engine(model, n_blocks=KVTIER_QOS_POOL)
    front, ufront = EngineFront(eng), EngineFront(unloaded)
    torch.cuda.reset_peak_memory_stats()
    row9 = Row9([eng, unloaded])
    ref = dict(zip(gold, run_threads(
        lambda j: ufront.generate(*mix[gold[j]], rid=f"u-{gold[j]}"),
        len(gold))))
    done = {}

    def one(i):
        tenant = "silver" if i in silver else "gold"
        if tenant == "gold":
            # The aggressor's burst is in the queue first.
            deadline = time.monotonic() + 300
            while eng.queue_depth + eng.running < len(silver) \
                    and len(done) == 0:
                if time.monotonic() > deadline:
                    raise AssertionError("serve_kvtier (d): the burst "
                                         "never queued")
                time.sleep(0.005)
        c = front.generate(*mix[i], rid=f"q-{i}", tenant=tenant)
        done[i] = c
        return c

    t0 = time.monotonic()
    run_threads(one, len(mix))
    wall = time.monotonic() - t0
    launches = row9.close("(d)", n_layers)
    worst, div, rows = compare_streams({i: done[i] for i in gold}, ref,
                                       SERVE_REL_TOL,
                                       "serve_kvtier (d) victim")
    st = eng.stats()
    ten = st["tenants"]
    if st["qos_deferrals"] <= 0 or ten["gold"]["deferred"] != 0.0 \
            or ten["silver"]["deferred"] != st["qos_deferrals"]:
        raise AssertionError(f"serve_kvtier (d): deferrals "
                             f"{st['qos_deferrals']}, by tenant "
                             f"{ {t: v['deferred'] for t, v in ten.items()} }")
    if eng._tenant_blocks or any(v["blocks"] for v in ten.values()) \
            or eng.cache.free_blocks != eng.cache.n_blocks:
        raise AssertionError(f"serve_kvtier (d): tenant blocks did not "
                             f"drain: {eng._tenant_blocks}")
    res = {"tenants": KVTIER_TENANTS, "pool_blocks": KVTIER_QOS_POOL,
           "requests": {"silver": len(silver), "gold": len(gold)},
           "qos_deferrals": st["qos_deferrals"],
           "by_tenant": {t: {k: v[k] for k in ("completed", "deferred",
                                               "blocks")}
                         for t, v in ten.items()},
           "victim_vs_unloaded_max_rel": worst,
           "near_tie_divergences": div, "rows_compared": rows,
           "wall_s": wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **launches}
    log(f"  (d) QoS: {json.dumps(res)}")
    return res


def kvtier_routed(model, n_layers):
    """(e): two host-tier engines behind the replica's RPC handler, the
    port's router (built as ``cli route`` builds it) and its RPC front
    over them; two turns under one ``session_id``."""
    from tony_tpu_torch.serve import RequestRouter
    from tony_tpu_torch.serve.router import RouterRpcHandler

    cfg = model.cfg
    toks, n = serve_mix(SEED, cfg.vocab)[0]
    engines = [kvtier_engine(model, host_blocks=KVTIER_HOST_BLOCKS)
               for _ in range(2)]
    reps = [SplitReplica(e) for e in engines]
    router = RequestRouter(block_size=SERVE_ENGINE["block_size"])
    for i, rep in enumerate(reps):
        router.upsert_replica(f"kv:{i}", address=rep.server.address,
                              stats=rep.engine.stats())
    handler = RouterRpcHandler(router)
    row9 = Row9(engines)
    try:
        out1 = handler.rpc_generate(toks, n, rid="e-1", session_id="kv-s")
        turn2 = list(toks) + list(out1["tokens"]) + [1, 2, 3, 4]
        out2 = handler.rpc_generate(turn2, n, rid="e-2", session_id="kv-s")
    finally:
        for rep in reps:
            rep.server.stop()
    launches = row9.close("(e)", n_layers)
    eng = engines[int(out1["replica"].split(":")[1])]
    if out2["replica"] != out1["replica"] or eng.park_hits != 1:
        raise AssertionError(f"serve_kvtier (e): turns on "
                             f"{out1['replica']} / {out2['replica']}, "
                             f"park hits {eng.park_hits}")
    res = {"replica": out1["replica"], "park_hits": eng.park_hits,
           "router": {k: router.stats()[k] for k in (
               "dispatched", "failovers", "sessions")}, **launches}
    log(f"  (e) routed session: {json.dumps(res)}")
    return res


KVTIER_PASSES = (("a_parking", kvtier_parking), ("b_daemon", kvtier_daemon),
                 ("c_store", kvtier_store), ("d_qos", kvtier_qos),
                 ("e_routed", kvtier_routed))


def serve_kvtier_phase(model, passes="abcde"):
    """The KV memory hierarchy and the tenants at the serve phase's full
    width (llama2-7b, 32 layers, bf16, ctx 2048, blocks of 16, random
    weights from seed 0): (a) conversation parking, (b) the demotion
    daemon, (c) the persisted prefix store, (d) QoS, (e) a routed
    session (``passes``: the letters of those to run). Row 9 launched
    ``n_layers`` times a forward in every pass."""
    n_layers = model.cfg.n_layers
    res = {"model": "llama2-7b", "host_blocks": KVTIER_HOST_BLOCKS}
    for key, fn in KVTIER_PASSES:
        if key[0] not in passes:
            continue
        t0 = time.monotonic()
        res[key] = fn(model, n_layers)
        res[key]["phase_s"] = time.monotonic() - t0
        free_cuda()
    res["flash_decode_launches"] = sum(
        res[key]["flash_decode_launches"] for key, _ in KVTIER_PASSES
        if key in res)
    return res


# ---------------------------------------------------------------------
# The cold-start plane: the AOT cache, warm() into CUDA graphs, a warm
# standby promoted.
# ---------------------------------------------------------------------

COLDSTART_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "coldstart_smoke")


def coldstart_drive(engine, reqs):
    """The serve_coldstart drive, the same for every engine so that
    their batches are the same: request 0 alone until its first token,
    then the rest at once, run dry on this thread. Returns the
    completions by rid and the ``time.monotonic`` stamps of request 0's
    first token and of the end."""
    from tony_tpu_torch.serve import Request
    (toks, n), rest = reqs[0], reqs[1:]
    engine.submit(Request(rid=0, tokens=toks, max_new_tokens=n))
    done = {c.rid: c for c in engine.step()}   # join, prefill: 1st token
    torch.cuda.synchronize()
    t_first = time.monotonic()
    for i, (toks, n) in enumerate(rest, 1):
        engine.submit(Request(rid=i, tokens=toks, max_new_tokens=n))
    done.update({c.rid: c for c in engine.run()})
    torch.cuda.synchronize()
    return done, t_first, time.monotonic()


def same_streams(got, ref, what):
    """Every token and every logit row of ``got`` equal to ``ref``'s
    (the rows are the host's f32 copies of the device rows, so equal
    arrays are ``torch.equal`` rows). Returns the rows compared."""
    if sorted(got) != sorted(ref):
        raise AssertionError(f"{what}: requests {sorted(got)} != "
                             f"{sorted(ref)}")
    rows = 0
    for rid, r in ref.items():
        c = got[rid]
        if c.tokens != r.tokens or len(c.logits) != len(r.logits):
            raise AssertionError(f"{what}: request {rid} tokens differ "
                                 f"from the eager engine's")
        for j, (a, b) in enumerate(zip(c.logits, r.logits)):
            if not np.array_equal(a, b):
                raise AssertionError(f"{what}: request {rid} logits row "
                                     f"{j} differs from the eager "
                                     f"engine's")
            rows += 1
    return rows


def check_replayed(engine, what, quantized=0):
    """Every forward of an armed engine on the card is a replay, and the
    replays ran each captured kernel once a layer a forward: flash-decode
    ``n_layers`` × forwards (the wrappers count a captured launch once,
    at capture) and, on the int8 lane, ``quantized`` × forwards."""
    n_layers = engine.model.cfg.n_layers
    replays, launches = engine.graph_replays(), engine.graph_launches()
    expect = {"flash_decode": n_layers * engine.forwards}
    if quantized:
        expect["int8_matmul"] = quantized * engine.forwards
    if replays != engine.forwards or launches != expect:
        raise AssertionError(f"{what}: {replays} replays of "
                             f"{engine.forwards} forwards, launches "
                             f"{launches} != {expect}")
    return launches


def free_cuda():
    gc.collect()
    torch.cuda.empty_cache()


def decode_steps(engine, vocab, steps=8):
    """Wall ms of ``steps`` pure b=16 decode steps with no profiler (its
    host overhead weighs on the eager step's ~1000 launches): 16
    sequences of 256-token prompts join first, untimed. Returns the
    step times, their p50 and the decode tokens/s at the p50."""
    from tony_tpu_torch.serve import Request
    rng = np.random.default_rng(SEED + 1)
    for i in range(16):
        engine.submit(Request(rid=f"steps-{i}",
                              tokens=rng.integers(0, vocab, 256).tolist(),
                              max_new_tokens=steps + 2))
    engine.step()
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(steps):
        t0 = time.monotonic()
        engine.step()
        step_ms.append(1e3 * (time.monotonic() - t0))
    engine.run()
    p50 = float(np.median(step_ms))
    return {"step_ms": step_ms, "step_p50_ms": p50,
            "decode_tokens_per_s": 16e3 / p50}


def coldstart_start(model, reqs, ref, name, kernel_dir, **kw):
    """One start of an armed engine: construct, ``warm()``, drive the
    mix; its streams held bitwise to the eager engine's, every forward a
    replay. Returns the engine (its caller frees it) and its numbers."""
    from tony_tpu_torch.ckpt import AOTCache
    builds0 = _build.builds
    l0 = LAUNCHES["flash_decode"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = ServeEngine(model, aot_cache=AOTCache(
        os.path.join(COLDSTART_ROOT, "aot")), kernel_dir=kernel_dir,
        **SERVE_ENGINE, **kw)
    warmed = engine.warm()
    torch.cuda.synchronize()
    t_warm = time.monotonic()
    got, t_first, t_end = coldstart_drive(engine, reqs)
    rows = same_streams(got, ref, f"serve_coldstart {name}")
    launches = check_replayed(engine, f"serve_coldstart {name}")
    # The wrappers launched only for the warm-up and the capture of a
    # program resolved at its first launch: 2 x n_layers each.
    captured = len(engine._aot_fns) - warmed
    wrapper = LAUNCHES["flash_decode"] - l0
    if wrapper != 2 * model.cfg.n_layers * len(engine._aot_fns):
        raise AssertionError(f"serve_coldstart {name}: {wrapper} wrapper "
                             f"launches for {len(engine._aot_fns)} captures")
    gen_tokens = sum(len(c.tokens) for c in got.values())
    res = {"engine_to_first_token_s": t_first - t0,
           "warm_s": t_warm - t0, "programs_warmed": warmed,
           "programs_at_first_launch": captured,
           "nvcc_builds": _build.builds - builds0,
           "fresh_compiles": engine.fresh_compiles,
           "aot_hits": engine.aot_hits, "aot_misses": engine.aot_misses,
           "compile_ms": engine.compile_ms,
           "deserialize_ms": engine.deserialize_ms,
           "forwards": engine.forwards, "replays": engine.graph_replays(),
           "replayed_launches": launches,
           "wrapper_launches_at_capture": wrapper,
           "drive_s": t_end - t_first,
           "decode_tokens_per_s": gen_tokens / (t_end - t_warm),
           "rows_equal": rows,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"  {name}: first token {res['engine_to_first_token_s']:.2f} s "
        f"after construction (warm {res['warm_s']:.2f} s, {warmed} "
        f"programs; {captured} more at first launch), nvcc builds "
        f"{res['nvcc_builds']}, aot hits {engine.aot_hits} misses "
        f"{engine.aot_misses}; {rows} logit rows == eager")
    return engine, res


def swap_then_replay(model, engine, reqs):
    """``swap_params`` onto other weights (a second seeded model), then
    the captured steps: the streams of an eager engine on the new
    weights, bitwise. The old weights are copied back afterwards."""
    other = get_model("llama2-7b", device="cuda", seed=SEED + 1,
                      param_dtype=torch.bfloat16)
    old = {n: p.detach().cpu() for n, p in model.named_parameters()}
    engine.swap_params(dict(other.named_parameters()), version=1, step=1)
    del other
    free_cuda()
    got, _, _ = coldstart_drive(engine, reqs)
    return got, old


def serve_coldstart_phase(model):
    """The cold-start plane on the serve phase's llama2-7b (bf16,
    SERVE_ENGINE geometry), one engine at a time: an eager engine's
    streams and decode step; three starts of an armed engine on the
    same mix — cold (an empty cache and an empty kernel directory: nvcc
    runs, then capture), hit (the populated cache, a second empty kernel
    directory: no nvcc) and a warm standby promoted — each bitwise the
    eager engine's; the decode step replayed against eager; a swap then
    a replay against an eager engine on the new weights."""
    shutil.rmtree(COLDSTART_ROOT, ignore_errors=True)
    os.makedirs(COLDSTART_ROOT)
    vocab = model.cfg.vocab
    reqs = serve_mix(SEED, vocab)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = ServeEngine(model, **SERVE_ENGINE)
    t_drive = time.monotonic()
    ref, t_first, t_end = coldstart_drive(engine, reqs)
    gen_tokens = sum(len(c.tokens) for c in ref.values())
    eager = {"engine_to_first_token_s": t_first - t0,
             "drive_s": t_end - t_first, "forwards": engine.forwards,
             "decode_tokens_per_s": gen_tokens / (t_end - t_drive),
             "max_memory_allocated": torch.cuda.max_memory_allocated()}
    eager["decode_steps"] = decode_steps(engine, vocab)
    eager["decode_profile"] = profile_decode(engine, vocab)
    log(f"  eager: {json.dumps(eager)}")
    del engine
    free_cuda()
    starts = {}
    engine, starts["cold"] = coldstart_start(
        model, reqs, ref, "cold", os.path.join(COLDSTART_ROOT, "k_cold"))
    # One cache entry, the engine's library set: its first resolution
    # misses and builds, every later one hits.
    if starts["cold"]["nvcc_builds"] < 1 or \
            starts["cold"]["aot_misses"] != 1:
        raise AssertionError(f"serve_coldstart cold: {starts['cold']}")
    pads = derive_prefill_pads([{"stats": engine.stats()}], q_block=16,
                               ctx_max=engine.ctx_pad, limit=64)
    replay_steps = decode_steps(engine, vocab)
    replay_profile = profile_decode(engine, vocab)
    log(f"  replay: {json.dumps(replay_steps)}; "
        f"{json.dumps(replay_profile)}")
    swap_reqs = reqs[:2]
    swapped, old = swap_then_replay(model, engine, swap_reqs)
    del engine
    free_cuda()
    engine = ServeEngine(model, **SERVE_ENGINE)
    swap_ref, _, _ = coldstart_drive(engine, swap_reqs)
    del engine
    free_cuda()
    swap_rows = same_streams(swapped, swap_ref, "serve_coldstart swap")
    if all(swap_ref[r].tokens == ref[r].tokens for r in swap_ref):
        raise AssertionError("serve_coldstart swap: the new weights gave "
                             "the old tokens")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(old[n])
    del old
    log(f"  swap then replay: {swap_rows} rows == an eager engine on the "
        f"new weights")
    engine, starts["hit"] = coldstart_start(
        model, reqs, ref, "hit", os.path.join(COLDSTART_ROOT, "k_hit"))
    if starts["hit"]["nvcc_builds"] or starts["hit"]["aot_misses"] or \
            not starts["hit"]["aot_hits"] or \
            starts["hit"]["fresh_compiles"]:
        raise AssertionError(f"serve_coldstart hit: {starts['hit']}")
    del engine
    free_cuda()
    # The standby: warmed (the mix's prompt pads, as the pad tuner would
    # derive them from the cold engine's histogram) while it idles, then
    # promoted; its clock starts at promote().
    from tony_tpu_torch.ckpt import AOTCache
    standby = ServeEngine(model, aot_cache=AOTCache(
        os.path.join(COLDSTART_ROOT, "aot")),
        kernel_dir=os.path.join(COLDSTART_ROOT, "k_standby"),
        warm_standby=True, **SERVE_ENGINE)
    torch.cuda.synchronize()
    pinned0 = torch.cuda.memory_allocated()
    warmed = standby.warm(prefill_pads=pads)
    torch.cuda.synchronize()
    # What the warmed graphs keep alive: their outputs (a prefill pad
    # past q_block returns one row of logits), static inputs and cuBLAS
    # workspaces.
    pinned = torch.cuda.memory_allocated() - pinned0
    for (b, t), fn in standby._aot_fns.items():
        if t > standby.q_block and fn.out.shape != (b, 1, vocab):
            raise AssertionError(f"serve_coldstart standby: the ({b}, {t}) "
                                 f"graph keeps {tuple(fn.out.shape)} logits")
    if standby.stats()["warm_standby"] != 1.0:
        raise AssertionError("serve_coldstart standby: not a standby")
    t0 = time.monotonic()
    if standby.promote() is not True:
        raise AssertionError("serve_coldstart standby: promote() False")
    got, t_first, _ = coldstart_drive(standby, reqs)
    rows = same_streams(got, ref, "serve_coldstart standby")
    check_replayed(standby, "serve_coldstart standby")
    if standby.promote() is not False or \
            standby.stats()["warm_standby"] != 0.0 or \
            standby.aot_misses or standby.fresh_compiles:
        raise AssertionError(f"serve_coldstart standby: after promote "
                             f"{standby.stats()}")
    starts["standby"] = {
        "promote_to_first_token_s": t_first - t0,
        "programs_warmed": warmed, "prefill_pads": pads,
        "warm_pinned_bytes": pinned,
        "programs_at_first_launch": len(standby._aot_fns) - warmed,
        "aot_hits": standby.aot_hits, "aot_misses": standby.aot_misses,
        "deserialize_ms": standby.deserialize_ms, "rows_equal": rows,
        "forwards": standby.forwards}
    log(f"  standby: first token {t_first - t0:.3f} s after promote() "
        f"({warmed} programs warmed idle, pinning {pinned / 2**20:.1f} "
        f"MiB, "
        f"{starts['standby']['programs_at_first_launch']} at first "
        f"launch); {rows} rows == eager")
    replayed = {
        name: starts[name]["replayed_launches"]["flash_decode"]
        for name in ("cold", "hit")}
    replayed["standby"] = standby.graph_launches()["flash_decode"]
    del standby
    free_cuda()
    shutil.rmtree(COLDSTART_ROOT, ignore_errors=True)
    return {"model": "llama2-7b", "engine": {
        k: v for k, v in SERVE_ENGINE.items() if k != "keep_logits"},
        "mix": "serve_mix(SEED) driven the same way for every engine: "
               "request 0 alone to its first token, then the other 15",
        "eager": eager, "starts": starts,
        "replay_decode_steps": replay_steps,
        "replay_decode_profile": replay_profile,
        "swap_then_replay_rows_equal": swap_rows,
        "flash_decode_launches": sum(replayed.values()),
        "flash_decode_launches_by_start": replayed}


def quant_replay_vs_eager(model):
    """The int8 lane under capture: one request (a prefill and decode
    steps) through an armed engine's captured steps and through the
    eager engine, its logits ``torch.equal``; the replays ran the int8
    kernel 7 × n_layers times a forward."""
    from tony_tpu_torch.ckpt import AOTCache
    reqs = serve_mix(SEED, model.cfg.vocab)[:1]
    reqs = [(reqs[0][0], 3)]
    engine = ServeEngine(model, **SERVE_ENGINE)
    ref, _, _ = coldstart_drive(engine, reqs)
    del engine
    free_cuda()
    root = os.path.join(COLDSTART_ROOT, "quant")
    shutil.rmtree(root, ignore_errors=True)
    engine = ServeEngine(model, aot_cache=AOTCache(root), **SERVE_ENGINE)
    engine.warm()
    got, _, _ = coldstart_drive(engine, reqs)
    rows = same_streams(got, ref, "serve_quant replay")
    launches = check_replayed(engine, "serve_quant replay",
                              quantized=7 * model.cfg.n_layers)
    del engine
    free_cuda()
    shutil.rmtree(root, ignore_errors=True)
    log(f"  replayed prefill + decode == eager: {rows} rows, launches "
        f"{launches}")
    return {"rows_equal": rows, "replayed_launches": launches}


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
    # One warm-up step in the profiler's schedule before the ``steps``
    # recorded: a session's first kernel records are often lost while its
    # tracing starts (exp/port_profile_count_probe.py).
    sched = torch.profiler.schedule(wait=0, warmup=1, active=steps,
                                    repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        step(state, batch)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.monotonic()
        for i in range(steps):
            step(state, batch)
            if i == steps - 1:
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.monotonic() - t0) / steps
            prof.step()
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


# Profiled windows a counting check may take: the profiler on the card
# loses a kernel record in some windows even after a warm-up step (1 of
# 20 in exp/port_profile_count_probe.py). Only that signature takes
# another window (:func:`lost_records`).
PROFILE_WINDOWS = 3


def profiled_counts(prof, names):
    """Launches a step the profiled window counted of each kernel in
    ``names`` (None without device events)."""
    if prof is None:
        return None
    launches = prof["flash_kernel_launches_per_step"]
    return [sum(n for key, n in launches.items() if name in key)
            for name in names]


def core_records(prof):
    """The profiled window's records of a CUDA-core flash kernel."""
    return [key for key in prof["flash_kernel_launches_per_step"]
            if any(name in key
                   for name in CORE_FWD_KERNELS + CORE_BWD_KERNELS)]


def lost_records(prof, fwd, bwd):
    """The signature of a window whose profiler lost kernel records:
    device events traced, no CUDA-core flash kernel among them, and the
    tensor-core kernels counted at most their launches, some fewer. Any
    other mismatch is a fault, judged at once."""
    if prof is None or core_records(prof):
        return False
    got = profiled_counts(prof, MMA_FWD_KERNELS + MMA_BWD_KERNELS)
    want = [fwd, bwd, bwd]
    return got != want and all(g <= w for g, w in zip(got, want))


def check_profiled(tag, prof, what, mma, core, per_step):
    """The profiled steps ran ``what`` in the tensor-core kernels ``mma``,
    ``per_step`` launches of each per step, and never in one of the
    CUDA-core kernels ``core``."""
    if prof is None:
        raise AssertionError(f"{tag}: the profiler traced no device event, "
                             f"so the {what} kernels cannot be named")
    launches = prof["flash_kernel_launches_per_step"]
    ran = [key for key in launches if any(name in key for name in core)]
    if ran:
        raise AssertionError(f"{tag}: a CUDA-core {what} kernel ran: {ran}")
    for name, got in zip(mma, profiled_counts(prof, mma)):
        if got != per_step:
            raise AssertionError(f"{tag}: {name} ran {got} times a step, "
                                 f"not {per_step}: {launches}")
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
    losses, step_ms, gnorms, auxes = [], [], [], []
    for _ in range(steps):
        t1 = time.monotonic()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))      # syncs
        step_ms.append(1e3 * (time.monotonic() - t1))
        gnorms.append(float(metrics["grad_norm"]))
        auxes.append(float(metrics["aux_loss"]))
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
        fwd = expect["flash_attention_fwd"] // steps
        bwd = expect["flash_attention_bwd_dq"] // steps
        windows = 1
        while windows < PROFILE_WINDOWS and lost_records(prof, fwd, bwd):
            log(f"  WARNING: {tag}: the profiled window counted "
                f"{prof['flash_kernel_launches_per_step']}, fewer than "
                f"{fwd} forward and {bwd} of each backward kernel a step, "
                f"and no CUDA-core kernel: profiling another window")
            prof = profile_train(step, state, batch)
            windows += 1
        check_fwd_kernels(tag, prof, fwd)
        check_bwd_kernels(tag, prof, bwd)
        prof["windows"] = windows
    return {"steps": steps, "losses": losses, "grad_norms": gnorms,
            "aux_losses": auxes, "step_ms": step_ms, "step_p50_ms": float(np.median(step_ms)),
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
# ZeRO-3 over the fsdp axis: the mesh path on one card, the fused update
# (row 14) on shard buffers, the sharded step across cards.
# ---------------------------------------------------------------------

# Two full-width states of 2 layers fit beside each other (8 do not).
ZERO3_BITWISE_LAYERS = 2
# The shard counts row 14 is held at on the 8-layer 7B's plan.
ZERO3_SHARDS = (2, 4)
ZERO3_WORKER = os.path.join("tests", "workloads", "torch_zero3_steps.py")
ZERO3_CARD_STEPS = 2
ZERO3_RANK_TIMEOUT_S = 420
# The sharded step's first loss against the one-card mesh path on the
# same rows, relative (the train_fused limit).
ZERO3_FIRST_LOSS_REL = FUSED_FIRST_LOSS_REL
# (d): the whole depth of llama2-7b, 3 steps on one batch.
ZERO3_FULL_LAYERS, ZERO3_FULL_STEPS = 32, 3
# (e): the int8 gather wire's amax history and its first loss against
# the unquantized windowed step's, relative.
ZERO3_QUANT_WINDOW = 8
ZERO3_QUANT_FIRST_LOSS_REL = 5e-2


def zero3_loss(logits, batch):
    return next_token_loss(logits, batch["x"])


def zero3_state(layers, update, mesh):
    """A full-width llama2-7b state of ``layers`` layers from the phase's
    seed: the fused AdamW of train_fused, or the per-leaf adamw."""
    model = get_model("llama2-7b", device="cuda", seed=SEED,
                      n_layers=layers)
    tx = (fo.FusedOptimizer(rule="adamw", lr=TRAIN_LR,
                            weight_decay=FUSED_WD)
          if update == "fused_bucket" else adamw(TRAIN_LR))
    return create_train_state(model, tx, mesh=mesh)


def zero3_slots(state):
    opt = state.opt_state
    if isinstance(opt, dict):
        return [b for name in sorted(opt["slots"])
                for b in opt["slots"][name]]
    return list(opt.mu) + list(opt.nu)


def zero3_bitwise(mesh, tokens):
    """(a) ``make_accum_train_step(mesh=..., reduce_op="reduce_scatter")``
    on the one-rank NCCL group against the step without a mesh, from
    fresh states of the same weights at ZERO3_BITWISE_LAYERS layers, in
    both update modes: two steps' loss and grad norm, then every
    parameter and slot, ``torch.equal``."""
    out = {}
    for update in ("fused_bucket", "optax"):
        runs = []
        for m in (mesh, None):
            state = zero3_state(ZERO3_BITWISE_LAYERS, update, m)
            step = make_accum_train_step(
                zero3_loss, m, microbatches=FUSED_MICROBATCHES,
                update=update,
                reduce_op="reduce_scatter" if m is not None
                else "all_reduce")
            metrics = [step(state, {"x": tokens})[1] for _ in range(2)]
            runs.append((state, metrics))
        (s_mesh, m_mesh), (s_plain, m_plain) = runs
        bad = [f"step {i} {k}" for i, (a, b) in enumerate(zip(m_mesh,
                                                              m_plain))
               for k in ("loss", "grad_norm", "aux_loss")
               if not torch.equal(a[k], b[k])]
        pairs = list(zip(s_mesh.model.named_parameters(),
                         s_plain.model.named_parameters()))
        bad += [n for (n, a), (_, b) in pairs if not torch.equal(a, b)]
        slots = list(zip(zero3_slots(s_mesh), zero3_slots(s_plain)))
        bad += [f"slot {i}" for i, (a, b) in enumerate(slots)
                if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"train_zero3 (a) {update}: the one-rank "
                                 f"mesh step differs from the step without "
                                 f"a mesh: {bad[:6]}")
        log(f"  (a) {update}: {ZERO3_BITWISE_LAYERS}-layer mesh step "
            f"(reduce_scatter) == no-mesh step, torch.equal: 2 steps' loss "
            f"and grad norm, {len(pairs)} parameters, {len(slots)} slot "
            f"tensors (loss {float(m_mesh[-1]['loss']):.6f})")
        out[update] = {"params": len(pairs), "slots": len(slots),
                       "losses": [float(m["loss"]) for m in m_mesh]}
        del runs, s_mesh, s_plain, pairs, slots
        gc.collect()
        torch.cuda.empty_cache()
    return out


def zero3_timed(mesh, tokens, card, fused_run):
    """(a) The fused mesh step at the train_fused depth: its numbers
    beside train_fused's from this run."""
    state = zero3_state(TRAIN_LAYERS, "fused_bucket", mesh)
    plan = state.buckets.plan
    step = make_accum_train_step(
        zero3_loss, mesh, microbatches=FUSED_MICROBATCHES,
        update="fused_bucket", reduce_op="reduce_scatter")
    per_step = TRAIN_LAYERS * FUSED_MICROBATCHES * TRAIN_STEPS
    expect = {"flash_attention_fwd": 2 * per_step,
              "flash_attention_bwd_dq": per_step,
              "flash_attention_bwd_dkv": per_step,
              "fused_bucket_update": plan.n_buckets * TRAIN_STEPS}
    run = drive_steps("train_zero3", state.model.cfg, step, state,
                      {"x": tokens}, FLASH_NAMES + ("fused_bucket_update",),
                      expect)
    same = run["losses"] == fused_run["losses"]
    log(f"  (a) mesh step at {TRAIN_LAYERS} layers: p50 "
        f"{run['step_p50_ms']:.1f} ms, {run['tokens_per_s']:.0f} tokens/s, "
        f"MFU {run['mfu']:.4f}, peak {run['max_memory_allocated'] / 1e9:.2f}"
        f" GB | train_fused: p50 {fused_run['step_p50_ms']:.1f} ms, "
        f"{fused_run['tokens_per_s']:.0f} tokens/s, MFU "
        f"{fused_run['mfu']:.4f}, peak "
        f"{fused_run['max_memory_allocated'] / 1e9:.2f} GB; losses equal "
        f"to train_fused's: {same}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(run, n_buckets=plan.n_buckets, reduce_op="reduce_scatter",
                losses_equal_train_fused=same,
                train_fused={k: fused_run[k] for k in (
                    "step_p50_ms", "tokens_per_s", "mfu",
                    "max_memory_allocated")})


def zero3_plans():
    """The ZeRO-3 plans row 14 is held on: the 8-layer 7B's parameters
    (their global shapes and logical-axis specs, no weights) at each of
    ZERO3_SHARDS, and the CPU tests' uneven tree
    (tests/test_torch_zero3.py ``_zero3_tree``) at fsdp 4, whose 6-row
    leaf pads into a bucket of its own."""
    meta = Transformer(TransformerConfig(n_layers=TRAIN_LAYERS),
                       device="meta")
    leaves = list(meta.parameters())
    for size in ZERO3_SHARDS:
        mesh = Mesh(shape={**dict.fromkeys(AXES, 1), "fsdp": size},
                    processes=size, device=torch.device("meta"))
        specs = [strip_spec(sp, mesh) for sp in param_specs(meta)]
        yield f"llama2-7b x{TRAIN_LAYERS} fsdp={size}", \
            GradBuckets.plan_sharded(leaves, specs, shard_size=size)
    tree = [((5,), torch.float32, ()), ((), torch.float32, ()),
            ((16, 8), torch.float32, ("fsdp",)),
            ((6, 8), torch.float32, ("fsdp",)),
            ((8, 4), torch.bfloat16, ("fsdp",))]
    yield "uneven tree fsdp=4", GradBuckets.plan_sharded(
        [torch.empty(s, dtype=d, device="meta") for s, d, _ in tree],
        [sp for _, _, sp in tree], shard_size=4, bucket_bytes=256)


def zero3_chunk_case(plan, b, f, gen):
    """Rank ``f``'s chunk of bucket ``b``, each operand a buffer of its
    own: g and p seeded, for a padded bucket packed shard-major from
    seeded whole leaves (uneven ones zero-padded); f32 slots seeded on the
    real rows and zero on the pad rows (the state starts at zero there and
    stays so); and the pad mask."""
    dt = plan.bucket_dtype(b)
    n = plan.local_numel(b)
    if plan._is_padded(b):
        idxs = plan.buckets[b]
        whole = {i: torch.randn(plan.shapes[i], generator=gen,
                                device="cuda") for i in idxs}
        sl = slice(f * n, (f + 1) * n)
        p = plan.pack_bucket(b, {i: t.to(dt) for i, t in whole.items()})[sl]
        g = plan.pack_bucket(b, {i: (t * 0.1).to(dt)
                                 for i, t in whole.items()})[sl]
        pad = plan.pack_bucket(b, {i: torch.ones(plan.shapes[i],
                                                 device="cuda")
                                   for i in idxs})[sl] == 0
    else:
        p = torch.randn(n, generator=gen, device="cuda").to(dt)
        g = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(dt)
        pad = torch.zeros(n, dtype=torch.bool, device="cuda")
    mu = torch.randn(n, generator=gen, device="cuda") * 1e-3
    nu = torch.rand(n, generator=gen, device="cuda") * 1e-3
    slots = [mu.masked_fill_(pad, 0.0), nu.masked_fill_(pad, 0.0)]
    return g.clone(), p.clone(), slots, pad


def check_zero3_shards(gen):
    """(b) Row 14 on ZeRO-3 shard buffers: for every scatter bucket of
    every plan of :func:`zero3_plans`, the first and the last rank's chunk
    through the kernel and through its plain version, ``torch.equal`` on
    p and both slots; pad rows stay zero. Every buffer starts 16-byte
    aligned (its own allocation; the kernel masks a ragged tail). The
    largest chunk is timed beside its bytes bound."""
    fused = fo.FusedOptimizer(rule="adamw", lr=TRAIN_LR,
                              weight_decay=FUSED_WD)
    scal = fused.scalars(3, "cuda")
    checked, padded, largest = 0, 0, None
    for name, plan in zero3_plans():
        for b in range(plan.n_buckets):
            if not plan._is_scatter(b):
                continue
            for f in sorted({0, plan.shard_size - 1}):
                g, p, slots, pad = zero3_chunk_case(plan, b, f, gen)
                for t in [g, p] + slots:
                    if t.data_ptr() % 16:
                        raise AssertionError(f"train_zero3 (b): a chunk "
                                             f"buffer is not 16-byte "
                                             f"aligned")
                kp, ks = p.clone(), [s.clone() for s in slots]
                fused_against_plain(fused, g, p, slots, scal,
                                    f"{name} bucket {b} rank {f}")
                fo.fused_bucket_update(g, kp, ks, scal, rule="adamw",
                                       hyper=fused.hyper)
                if pad.any():
                    padded += 1
                    if any(t[pad].any() for t in [kp] + ks):
                        raise AssertionError(f"train_zero3 (b): {name} "
                                             f"bucket {b} rank {f}: a pad "
                                             f"row moved off zero")
                checked += 1
                if largest is None or p.numel() > largest[0]:
                    largest = (p.numel(), name, b)
                del g, p, slots, kp, ks
        torch.cuda.empty_cache()
    if not padded:
        raise AssertionError("train_zero3 (b): no padded chunk was checked")
    n, name, b = largest
    g, p, slots = (torch.randn(n, generator=gen, device="cuda")
                   for _ in range(3))
    slots = [slots * 1e-3, torch.rand(n, generator=gen, device="cuda")]
    ms = cuda_ms(lambda: fo.fused_bucket_update(
        g, p, slots, scal, rule="adamw", hyper=fused.hyper))
    plain_ms = cuda_ms(lambda: fo._rule_math(
        "adamw", g, p, tuple(slots), scal[0], scal[1], scal[2],
        **fused.hyper), iters=5)
    bound_ms, bound_by = adamw_bound(n)
    # The library yardstick on the same chunk (timed only, never called
    # by the port): PyTorch's fused AdamW over one tensor of n elements.
    w = p.clone().requires_grad_()
    w.grad = g
    opt = torch.optim.AdamW([w], lr=TRAIN_LR, weight_decay=FUSED_WD,
                            fused=True)
    library_ms = cuda_ms(opt.step)
    del g, p, slots, opt, w
    torch.cuda.empty_cache()
    log(f"  (b) row 14 on {checked} ZeRO-3 chunks ({padded} with pad rows): "
        f"kernel == plain (torch.equal, p and both slots), pad rows zero; "
        f"largest chunk ({name} bucket {b}, n={n}) {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
        f"AdamW(fused=True) {library_ms:.4f} ms")
    return {"chunks_checked": checked, "padded_chunks": padded,
            "largest": {"plan": name, "bucket": b, "n": n, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms}}


def zero3_rows_tokens(rows):
    rng = np.random.default_rng(SEED + 3)
    return rng.integers(0, 32000, (rows, TRAIN_SEQ)).astype(np.int64)


def zero3_reference(mesh, tokens):
    """(c)'s reference: the one-card mesh path over the same rows, one
    row a microbatch (so the loss is the same mean over rows), two steps.
    Returns the first loss, every parameter after two steps on the host
    and the norm of each parameter's update."""
    state = zero3_state(TRAIN_LAYERS, "fused_bucket", mesh)
    p0 = [p.detach().clone() for p in state.model.parameters()]
    step = make_accum_train_step(
        zero3_loss, mesh, microbatches=tokens.shape[0],
        update="fused_bucket", reduce_op="reduce_scatter")
    feed = {"x": torch.as_tensor(tokens, device="cuda")}
    losses = [float(step(state, feed)[1]["loss"])
              for _ in range(ZERO3_CARD_STEPS)]
    names = [n for n, _ in state.model.named_parameters()]
    delta = {n: float((p.detach() - q).norm()) for n, p, q in zip(
        names, state.model.parameters(), p0)}
    params = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    del state, p0, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses, params, delta


def run_zero3_ranks(tag, cfg, tmp):
    """One NCCL rank per card running the CPU tests' worker
    (tests/workloads/torch_zero3_steps.py) on ``cfg``: returns every
    rank's report and the wall time with the ranks' start."""
    wall = run_ranks(f"train_zero3 {tag}", ZERO3_WORKER, tag, cfg, tmp,
                     ZERO3_RANK_TIMEOUT_S)
    return [json.load(open(os.path.join(tmp, f"{tag}{r}.json")))["runs"]
            for r in range(torch.cuda.device_count())], wall


def run_ranks(what, worker, tag, cfg, tmp, timeout):
    """One NCCL rank per card running ``worker`` (a CPU tests' worker
    under tests/workloads) on ``cfg``, each writing under
    ``<tmp>/<tag><rank>`` and logging to ``<tmp>/<tag><rank>.log``;
    returns the wall time with the ranks' start. A rank that fails, or
    the time limit, ends every rank at once, and the error carries each
    rank's log tail."""
    cards = torch.cuda.device_count()
    cpath = os.path.join(tmp, f"{tag}_cfg.json")
    with open(cpath, "w") as fh:
        json.dump(cfg, fh)
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    procs, logs = [], []
    t0 = time.monotonic()
    for rank in range(cards):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(cards),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port),
                   INIT_METHOD=f"tcp://127.0.0.1:{port}",
                   PYTHONPATH=os.pathsep.join(
                       [root, os.environ.get("PYTHONPATH", "")]))
        logs.append(os.path.join(tmp, f"{tag}{rank}.log"))
        with open(logs[-1], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(root, worker), cpath,
                 os.path.join(tmp, f"{tag}{rank}")], env=env, stdout=out,
                stderr=subprocess.STDOUT, text=True))
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is not None or time.monotonic() - t0 > timeout:
                break
            time.sleep(1.0)
        else:
            failed = next((r for r, p in enumerate(procs)
                           if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.monotonic() - t0
    if failed is not None or wall > timeout:
        tails = []
        for rank, path in enumerate(logs):
            with open(path) as fh:
                tails.append(f"--- rank {rank} (exit "
                             f"{procs[rank].returncode}):\n"
                             f"{fh.read()[-3000:]}")
        why = f"rank {failed} failed" if failed is not None \
            else f"the ranks ran past {timeout} s"
        raise AssertionError(f"{what}: {why}\n" + "\n".join(tails))
    return wall


def check_zero3_storage(tag, reports, cards):
    """Every rank's parameter and slot storage is 1/cards of the whole
    (the norm scales, replicated, whole), before and after the steps."""
    for rank, rep in enumerate(reports):
        for when in ("before", "after"):
            rec = rep[when]
            if not all(loc * cards == whole or loc == whole == 4096
                       for loc, whole in rec["params"]):
                raise AssertionError(f"train_zero3 {tag}: rank {rank} holds "
                                     f"more than its shard ({when})")
            for bufs in rec["slots"]:
                if not all(n * (cards if sc else 1) == whole for n, whole, sc
                           in zip(bufs, rec["slot_whole"], rec["scatter"])):
                    raise AssertionError(f"train_zero3 {tag}: rank {rank}'s "
                                         f"slots are not 1/{cards} ({when})")


def zero3_window_record(rep):
    """The step's gather-window record: its high-water mark of gathered
    bytes beside window_nbytes and the allowance."""
    w = rep["overlap"]["accum_step"].get("window")
    if w is None:
        return None
    return {k: w[k] for k in ("high_water_nbytes", "window_nbytes",
                              "allowance_nbytes", "bound_nbytes",
                              "fwd_gathers", "bwd_gathers", "prefetch")}


def zero3_across_cards(mesh, card):
    """(c) The ZeRO-3 step on every card: one NCCL rank per card running
    the CPU tests' worker (tests/workloads/torch_zero3_steps.py) with
    ``MeshSpec(fsdp=cards)`` on the 8-layer 7B, two fused steps through
    the gather window, against (c)'s reference on one card: the first
    loss within ZERO3_FIRST_LOSS_REL, each parameter's update within the
    train phase's bf16 grad limit (relative L2), every rank's parameter
    and slot storage 1/cards of the whole; then the same steps with
    ``gather="per_leaf"`` (every leaf gathered for the whole microbatch)
    ``torch.equal`` to the windowed ones on every parameter, both step
    peaks and step times beside each other. (e) rides the same ranks: the
    8-layer step on the int8 gather wire (``quant=True``), two steps,
    its first loss within ZERO3_QUANT_FIRST_LOSS_REL of the windowed
    run's, int8 bytes a quarter of the raw bytes in ``quant_report()``
    and ``gather_roundtrip_exact`` true on NCCL."""
    cards = torch.cuda.device_count()
    rows = 2 * cards
    tokens = zero3_rows_tokens(rows)
    ref_losses, ref_params, ref_delta = zero3_reference(mesh, tokens)
    tmp = os.path.join("build", "zero3")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "batch.npz"), x=tokens)
    fused = {"step": "accum", "microbatches": FUSED_MICROBATCHES,
             "steps": ZERO3_CARD_STEPS, "update": "fused_bucket",
             "reduce_op": "reduce_scatter",
             "tx": {"rule": "adamw", "lr": TRAIN_LR,
                    "weight_decay": FUSED_WD}}
    cfg = {"model": "llama2-7b", "device": "cuda", "loss": "next_token",
           "model_kwargs": {"n_layers": TRAIN_LAYERS, "seed": SEED},
           "dp": 1, "fsdp": cards, "batch": os.path.join(tmp, "batch.npz"),
           "runs": {
               "zero3": fused,
               "per_leaf": {**fused, "gather": "per_leaf",
                            "equal_to": "zero3", "dump": False},
               "quant": {**fused, "quant": {"window": ZERO3_QUANT_WINDOW},
                         "roundtrip": True, "dump": False},
               # Where the time goes: a third step under the profiler,
               # windowed and per_leaf.
               "prof_window": {**fused, "steps": 3, "profile": True,
                               "dump": False},
               "prof_per_leaf": {**fused, "steps": 3, "profile": True,
                                 "gather": "per_leaf", "dump": False}}}
    reports, wall = run_zero3_ranks("c", cfg, tmp)
    win = [rep["zero3"] for rep in reports]
    got = dict(np.load(os.path.join(tmp, "c0.zero3.npz")))
    first = win[0]["metrics"][0]["loss"]
    rel = abs(first - ref_losses[0]) / abs(ref_losses[0])
    if not rel <= ZERO3_FIRST_LOSS_REL:
        raise AssertionError(f"train_zero3 (c): first loss {first} vs the "
                             f"one-card {ref_losses[0]} (rel {rel})")
    limit = TRAIN_GRAD_REL_L2[torch.bfloat16]
    worst = max((float(np.linalg.norm(got[n] - ref_params[n].numpy()))
                 / max(ref_delta[n], 1e-30), n) for n in ref_params)
    if not worst[0] <= limit:
        raise AssertionError(f"train_zero3 (c): parameter {worst[1]}'s "
                             f"update differs from the one-card run's by "
                             f"{worst[0]} (relative L2) > {limit}")
    check_zero3_storage("(c)", win, cards)
    for rank, rep in enumerate(reports):
        bad = rep["per_leaf"]["unequal_to"]
        if bad or rep["per_leaf"]["metrics"] != rep["zero3"]["metrics"]:
            raise AssertionError(f"train_zero3 (c): rank {rank}: the "
                                 f"windowed step differs from "
                                 f"gather='per_leaf': {bad[:6]}")
    window = zero3_window_record(win[0])
    if window is None or window["high_water_nbytes"] > (
            window["window_nbytes"] + window["allowance_nbytes"]):
        raise AssertionError(f"train_zero3 (c): the window's high-water "
                             f"mark passed its bound: {window}")
    peaks = [rep["peak_bytes"] for rep in win]
    leaf_peaks = [rep["per_leaf"]["peak_bytes"] for rep in reports]
    steps_s = [rep["step_s"] for rep in win]
    leaf_s = [rep["per_leaf"]["step_s"] for rep in reports]
    log(f"  (c) {cards} cards, fsdp={cards}: first loss {first:.6f} vs "
        f"one card {ref_losses[0]:.6f} (rel {rel:.2e}); worst update "
        f"{worst[1]} rel L2 {worst[0]:.3e} (limit {limit}); storage 1/"
        f"{cards} on every rank; windowed == per_leaf (torch.equal, "
        f"{len(ref_params)} parameters on every rank); step s windowed "
        f"{steps_s[0]} per_leaf {leaf_s[0]}; step peak windowed "
        f"{[round(x / 1e9, 2) for x in peaks]} GB, per_leaf "
        f"{[round(x / 1e9, 2) for x in leaf_peaks]} GB; window high-water "
        f"{window['high_water_nbytes'] / 1e9:.3f} GB vs window_nbytes "
        f"{window['window_nbytes'] / 1e9:.3f} + allowance "
        f"{window['allowance_nbytes'] / 1e9:.3f} GB; {wall:.1f} s with "
        f"the ranks' start")
    profiles = {run: reports[0][run]["profile"]
                for run in ("prof_window", "prof_per_leaf")}
    for run, prof in profiles.items():
        log(f"  (c) {run}, rank 0, step 3 under torch.profiler: wall "
            f"{prof['wall_ms']:.1f} ms, device time of the other rows "
            f"{prof['compute_ms']:.1f} ms, of the NCCL rows "
            f"{prof['nccl_ms']:.1f} ms (each kernel counted twice: its "
            f"row and its op's); top "
            f"{[(n[:40], round(ms, 1)) for n, ms in prof['top'][:5]]}")
    across = {"cards": cards, "rows": rows, "first_loss": first,
              "reference_first_loss": ref_losses[0], "first_loss_rel": rel,
              "worst_update_rel_l2": worst[0], "worst_param": worst[1],
              "losses": [m["loss"] for m in win[0]["metrics"]],
              "step_s_by_rank": steps_s, "peak_bytes_by_rank": peaks,
              "build_peak_bytes_by_rank": [r["build_peak_bytes"]
                                           for r in win],
              "per_leaf_step_s_by_rank": leaf_s,
              "per_leaf_peak_bytes_by_rank": leaf_peaks,
              "windowed_equal_per_leaf": True, "window": window,
              "profiles": profiles,
              "wall_s": wall, "card": card}
    quant_run = zero3_quant_checks(reports, first, card)
    shutil.rmtree(tmp, ignore_errors=True)
    return across, quant_run


def zero3_quant_checks(reports, first_unquantized, card):
    """(e) The int8 gather wire's readings from (c)'s ranks."""
    runs = [rep["quant"] for rep in reports]
    losses = [m["loss"] for m in runs[0]["metrics"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_zero3 (e): losses {losses}")
    rel = abs(losses[0] - first_unquantized) / abs(first_unquantized)
    if not rel <= ZERO3_QUANT_FIRST_LOSS_REL:
        raise AssertionError(f"train_zero3 (e): first loss {losses[0]} vs "
                             f"the unquantized {first_unquantized} (rel "
                             f"{rel})")
    gather = runs[0]["quant"]["accum_gather"]
    raw, int8 = sum(gather["raw_nbytes"]), sum(gather["int8_nbytes"])
    if raw != 4 * int8:
        raise AssertionError(f"train_zero3 (e): int8 bytes {int8} are not "
                             f"a quarter of the raw {raw}")
    if not all(r["roundtrip_exact"] for r in runs):
        raise AssertionError("train_zero3 (e): gather_roundtrip_exact is "
                             "false on NCCL")
    wire = sum(runs[0]["collectives"]["accum.fwd_gather"]["nbytes"])
    check_zero3_storage("(e)", runs, len(runs))
    log(f"  (e) quant=True at {TRAIN_LAYERS} layers, fsdp={len(runs)}: "
        f"losses {losses}, first vs unquantized rel {rel:.2e} (limit "
        f"{ZERO3_QUANT_FIRST_LOSS_REL}); gather bytes a bucket pass "
        f"int8 {int8} vs raw {raw}; wire bytes a microbatch {wire} "
        f"(forward and backward); gather_roundtrip_exact on NCCL: True; "
        f"step s {runs[0]['step_s']}; step peak "
        f"{[round(r['peak_bytes'] / 1e9, 2) for r in runs]} GB")
    return {"losses": losses, "first_loss_vs_unquantized_rel": rel,
            "raw_nbytes": raw, "int8_nbytes": int8,
            "wire_nbytes_per_microbatch": wire, "roundtrip_exact": True,
            "amax_window": ZERO3_QUANT_WINDOW,
            "step_s_by_rank": [r["step_s"] for r in runs],
            "peak_bytes_by_rank": [r["peak_bytes"] for r in runs],
            "card": card}


def zero3_full_reference(tokens):
    """(d)'s reference: a one-card no-grad forward of the same seeded
    32-layer model (f32 parameters, 26.95 GB) on the same rows, freed
    before the ranks start. Returns the loss."""
    model = get_model("llama2-7b", device="cuda", seed=SEED,
                      n_layers=ZERO3_FULL_LAYERS,
                      xent_chunk=LOOP_XENT_CHUNK)
    feed = torch.as_tensor(tokens, device="cuda")
    with torch.no_grad():
        loss = float(model(feed, targets=feed))
    del model, feed
    gc.collect()
    torch.cuda.empty_cache()
    return loss


def zero3_full_depth(card):
    """(d) llama2-7b at all 32 layers, nothing cut, trained at
    fsdp=cards through the gather window: 2 rows of 2048 seeded tokens a
    card, two microbatches, the fused AdamW, reduce_scatter, remat
    ``"dots"`` with ``xent_chunk=1024`` (train_loop's cell), 3 steps on
    the same batch. No one card holds this model's AdamW state, so the
    checks are: the first loss against a one-card no-grad forward within
    ZERO3_FIRST_LOSS_REL, the losses finite and falling, storage
    1/cards on every rank before and after; each rank's step peak and
    build peak are reported."""
    cards = torch.cuda.device_count()
    rows = 2 * cards
    rng = np.random.default_rng(SEED + 4)
    tokens = rng.integers(0, 32000, (rows, TRAIN_SEQ)).astype(np.int64)
    ref = zero3_full_reference(tokens)
    tmp = os.path.join("build", "zero3_full")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "batch.npz"), x=tokens)
    cfg = {"model": "llama2-7b", "device": "cuda", "targets": True,
           "model_kwargs": {"n_layers": ZERO3_FULL_LAYERS, "seed": SEED,
                            "xent_chunk": LOOP_XENT_CHUNK,
                            "remat_policy": LOOP_POLICY},
           "dp": 1, "fsdp": cards, "batch": os.path.join(tmp, "batch.npz"),
           "runs": {"full": {
               "step": "accum", "microbatches": FUSED_MICROBATCHES,
               "steps": ZERO3_FULL_STEPS, "update": "fused_bucket",
               "reduce_op": "reduce_scatter",
               "tx": {"rule": "adamw", "lr": TRAIN_LR,
                      "weight_decay": FUSED_WD}}}}
    reports, wall = run_zero3_ranks("d", cfg, tmp)
    runs = [rep["full"] for rep in reports]
    losses = [m["loss"] for m in runs[0]["metrics"]]
    rel = abs(losses[0] - ref) / abs(ref)
    if not rel <= ZERO3_FIRST_LOSS_REL:
        raise AssertionError(f"train_zero3 (d): first loss {losses[0]} vs "
                             f"the one-card forward {ref} (rel {rel})")
    if not (all(math.isfinite(x) for x in losses)
            and all(b < a for a, b in zip(losses, losses[1:]))):
        raise AssertionError(f"train_zero3 (d): losses not finite and "
                             f"falling: {losses}")
    if any(r["dumped"] for r in runs):
        raise AssertionError("train_zero3 (d): the whole 32-layer model was "
                             "written out")
    check_zero3_storage("(d)", runs, cards)
    window = zero3_window_record(runs[0])
    peaks = [r["peak_bytes"] for r in runs]
    builds = [r["build_peak_bytes"] for r in runs]
    steps_s = [r["step_s"] for r in runs]
    log(f"  (d) llama2-7b x{ZERO3_FULL_LAYERS} at fsdp={cards}: losses "
        f"{losses}, first vs the one-card forward {ref:.6f} (rel "
        f"{rel:.2e}); storage 1/{cards} on every rank; step s "
        f"{steps_s[0]}; step peak {[round(x / 1e9, 2) for x in peaks]} "
        f"GB, build peak {[round(x / 1e9, 2) for x in builds]} GB; window "
        f"{window}; whole parameters {runs[0]['whole_param_bytes'] / 1e9:.2f}"
        f" GB; {wall:.1f} s with the ranks' start")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"cards": cards, "layers": ZERO3_FULL_LAYERS, "rows": rows,
            "losses": losses, "reference_loss": ref,
            "first_loss_rel": rel, "step_s_by_rank": steps_s,
            "peak_bytes_by_rank": peaks, "build_peak_bytes_by_rank": builds,
            "build_s_by_rank": [r["build_s"] for r in runs],
            "whole_param_bytes": runs[0]["whole_param_bytes"],
            "window": window, "wall_s": wall, "card": card}


def train_zero3_phase(card, fused_run, gen, cards_only=False):
    """ZeRO-3 on a one-rank NCCL group (as train_loop brings it up): (a)
    the mesh path bitwise to the no-mesh step and timed at the
    train_fused depth, (b) row 14 on shard buffers, (c) the sharded step
    across every card where there are two or more."""
    t0 = time.monotonic()
    td.init_process_group("nccl", rank=0, world_size=1,
                          init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        mesh = MeshSpec(dp=0).build()
        out = {"card": card}
        if not cards_only:
            rng = np.random.default_rng(SEED)
            tokens = torch.as_tensor(rng.integers(
                0, 32000, (TRAIN_BATCH, TRAIN_SEQ)), device="cuda")
            out["bitwise"] = zero3_bitwise(mesh, tokens)
            out["timed"] = zero3_timed(mesh, tokens, card, fused_run)
            out["shards"] = check_zero3_shards(gen)
        cards = torch.cuda.device_count()
        if cards >= 2:
            out["across_cards"], out["quant_gather"] = zero3_across_cards(
                mesh, card)
            out["full_depth"] = zero3_full_depth(card)
        else:
            log(f"  (c), (d), (e) the ZeRO-3 steps across cards did not "
                f"run: this machine has {cards} card (NCCL takes one rank "
                f"per card); the CPU tests run them on gloo ranks "
                f"(tests/test_torch_zero3.py, "
                f"tests/test_torch_zero3_window.py, "
                f"tests/test_torch_quant_gather.py)")
            out["across_cards"] = out["quant_gather"] = None
            out["full_depth"] = None
        out["seconds"] = time.monotonic() - t0
        log(f"  train_zero3: {out['seconds']:.1f} s")
        return out
    finally:
        td.destroy_process_group()
        # Later phases read the collective registry per step
        # (train_stats_writer): leave none of this phase's records.
        profiler.reset_collective_records()
        profiler.reset_overlap_records()


# ---------------------------------------------------------------------
# train_moe: mixtral-8x7b at full width through the flash kernels and
# row 14; --moe-cards-only: expert parallelism across the cards.
# ---------------------------------------------------------------------

# Of 32 layers: 2 hold 3.17 B f32 parameters, ~51 GB with their grads
# and AdamW's slots, beside the activations of 2 x 2048 tokens.
MOE_LAYERS = 2
MOE_STEPS = 4
# The reference's band for the first step's summed aux loss
# (tests/test_moe.py: 0.005 to 0.1 at coef 0.01 and 2 layers): coef ·
# layers times 0.25 to 5.
MOE_AUX_BAND = (0.25, 5.0)
MOE_WORKER = os.path.join("tests", "workloads", "torch_moe_ep_steps.py")
MOE_RANK_TIMEOUT_S = 420
# --moe-cards-only: the 2-layer meshes held against one card, then the
# timed depth at ep = cards.
MOE_CARD_MESHES = ((1, 4), (2, 2))
MOE_DEPTH_LAYERS = 8
# The reference's MoEMLP default: two capacity chunks, the second's
# dispatch in flight under the first's expert FFN.
MOE_A2A_CHUNKS = 2


@contextlib.contextmanager
def reference_attention_lane(model):
    """Every module of ``model`` that reads its config sees
    ``attention="reference"`` for the block: the plain lane of the same
    weights."""
    mods = [m for m in model.modules() if hasattr(m, "cfg")]
    saved = [m.cfg for m in mods]
    for m in mods:
        m.cfg = dataclasses.replace(m.cfg, attention="reference")
    try:
        yield
    finally:
        for m, cfg in zip(mods, saved):
            m.cfg = cfg


def moe_step_grads(model, tokens, pin=None):
    """One forward and backward of loss + aux: the loss, the aux, every
    parameter's grad and each MoE layer's routing (its expert choices a
    round, by layer). ``pin`` (such routing) makes each layer take those
    choices instead of its own argmax."""
    routes = {}
    model.zero_grad(set_to_none=True)
    with moe_module.routing(model, seen=routes, pin=pin):
        out, aux = model(tokens)
        loss = next_token_loss(out, tokens) + aux
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), float(aux.detach()), grads, routes


def topk_differ(a, b):
    """Per layer, the share of tokens whose set of chosen experts differs
    between two routings."""
    return [float((a[k].sort(dim=0).values != b[k].sort(dim=0).values)
                  .any(dim=0).float().mean()) for k in a]


def moe_lanes(model, tokens):
    """One step on the flash lane against the reference attention lane of
    the same weights: the losses; the share of tokens whose top-k expert
    set differs between the lanes, per layer; the grads' largest
    relative L2 distance with each lane routing itself (reported: a
    flipped near-tie moves a whole token between experts), and with the
    reference lane taking the flash lane's routing, which is held to the
    train phase's bf16 limit."""
    loss_k, aux_k, g_k, r_k = moe_step_grads(model, tokens)
    with reference_attention_lane(model):
        loss_p, aux_p, g_p, r_p = moe_step_grads(model, tokens)
    free = rel_l2(g_k, g_p)
    del g_p
    with reference_attention_lane(model):
        _, _, g_q, _ = moe_step_grads(model, tokens, pin=r_k)
    rel = rel_l2(g_k, g_q)
    del g_q
    worst, free_worst = max(rel, key=rel.get), max(free, key=free.get)
    differ = topk_differ(r_k, r_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    limit = TRAIN_GRAD_REL_L2[torch.bfloat16]
    log(f"  one step, flash vs reference attention: loss {loss_k:.6f} vs "
        f"{loss_p:.6f} (rel {loss_rel:.2e}, tol {FUSED_FIRST_LOSS_REL}); "
        f"tokens whose top-k set differs, by layer: "
        f"{[round(x, 5) for x in differ]}; grads max relative L2 "
        f"{free[free_worst]:.3e} ({free_worst}) each lane routing itself, "
        f"{rel[worst]:.3e} ({worst}; tol {limit}) on the flash lane's "
        f"routing")
    if rel[worst] > limit:
        raise AssertionError(f"train_moe grads: {worst} flash vs reference "
                             f"relative L2 {rel[worst]} > {limit}")
    if not loss_rel <= FUSED_FIRST_LOSS_REL:
        raise AssertionError(f"train_moe: first loss {loss_k} vs the "
                             f"reference lane's {loss_p}")
    return {"loss_flash": loss_k, "loss_reference": loss_p,
            "aux_flash": aux_k, "aux_reference": aux_p,
            "loss_rel": loss_rel, "loss_rel_limit": FUSED_FIRST_LOSS_REL,
            "topk_differ_share_by_layer": differ,
            "grad_max_rel_l2_own_routing": free[free_worst],
            "grad_worst_param_own_routing": free_worst,
            "grad_max_rel_l2": rel[worst], "grad_worst_param": worst,
            "grad_rel_l2_limit": limit}


def check_aux(tag, coef, layers, auxes):
    """The first step's aux loss within the reference's band (its test
    reads the first step's too: training on one batch unbalances the
    router, and the aux climbs)."""
    lo, hi = (f * coef * layers for f in MOE_AUX_BAND)
    if not lo < auxes[0] < hi:
        raise AssertionError(f"{tag}: first aux_loss {auxes[0]} outside "
                             f"({lo}, {hi})")
    log(f"  aux_loss {[round(a, 5) for a in auxes]}, the first within "
        f"({lo:.4f}, {hi:.4f})")


def moe_run(tag, cfg, step, state, tokens, names, expect):
    run = timed_steps(tag, step, state, {"x": tokens}, names, expect,
                      MOE_STEPS)
    check_aux(tag, cfg.moe_aux_coef, cfg.n_layers, run["aux_losses"])
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (run["step_p50_ms"] / 1e3)
    flops_tok = dataclasses.replace(cfg, max_seq=TRAIN_SEQ).flops_per_token()
    return {**run, "tokens_per_s": tokens_per_s,
            "flops_per_token": flops_tok,
            "mfu": tokens_per_s * flops_tok / PEAK_FLOPS[torch.bfloat16],
            "peak_gb": run["max_memory_allocated"] / 1e9}


def train_moe_phase(card: str):
    t0 = time.monotonic()
    model = get_model("mixtral-8x7b", device="cuda", seed=SEED,
                      n_layers=MOE_LAYERS)
    cfg = model.cfg
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  mixtral-8x7b x{MOE_LAYERS} layers built in "
        f"{time.monotonic() - t0:.1f} s ({n_params / 1e9:.3f} B f32 params; "
        f"attention={cfg.attention}, remat={cfg.remat}, "
        f"{cfg.moe_experts} experts, top-{cfg.moe_top_k})")
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (TRAIN_BATCH, TRAIN_SEQ)),
                             device="cuda")
    lanes = moe_lanes(model, tokens)
    gc.collect()
    torch.cuda.empty_cache()

    state = create_train_state(model, adamw(TRAIN_LR))
    step = make_train_step(
        loss_of=lambda out, batch: next_token_loss(out, batch["x"]))
    expect = {"flash_attention_fwd": 2 * MOE_LAYERS * MOE_STEPS,
              "flash_attention_bwd_dq": MOE_LAYERS * MOE_STEPS,
              "flash_attention_bwd_dkv": MOE_LAYERS * MOE_STEPS}
    train = moe_run("train_moe", cfg, step, state, tokens, FLASH_NAMES,
                    expect)
    del state, model, step
    gc.collect()
    torch.cuda.empty_cache()

    model = get_model("mixtral-8x7b", device="cuda", seed=SEED,
                      n_layers=MOE_LAYERS)
    fused = fo.FusedOptimizer(rule="adamw", lr=TRAIN_LR,
                              weight_decay=FUSED_WD)
    state = create_train_state(model, fused)
    n_buckets = state.buckets.plan.n_buckets
    step = make_accum_train_step(
        lambda out, batch: next_token_loss(out, batch["x"]),
        microbatches=FUSED_MICROBATCHES, update="fused_bucket")
    per_step = MOE_LAYERS * FUSED_MICROBATCHES * MOE_STEPS
    expect = {"flash_attention_fwd": 2 * per_step,
              "flash_attention_bwd_dq": per_step,
              "flash_attention_bwd_dkv": per_step,
              "fused_bucket_update": n_buckets * MOE_STEPS}
    accum = moe_run("train_moe_fused", cfg, step, state, tokens,
                    FLASH_NAMES + ("fused_bucket_update",), expect)
    rel = abs(accum["losses"][0] - lanes["loss_reference"]) \
        / abs(lanes["loss_reference"])
    log(f"  fused first loss {accum['losses'][0]:.6f} vs the reference "
        f"lane's {lanes['loss_reference']:.6f} (rel {rel:.2e}, tol "
        f"{FUSED_FIRST_LOSS_REL})")
    if not rel <= FUSED_FIRST_LOSS_REL:
        raise AssertionError(f"train_moe_fused: first loss "
                             f"{accum['losses'][0]} vs "
                             f"{lanes['loss_reference']}")
    state.buckets.check()
    del state, model, step
    gc.collect()
    torch.cuda.empty_cache()
    launches = {name: train["launches"].get(name, 0)
                + accum["launches"].get(name, 0)
                for name in FLASH_NAMES + ("fused_bucket_update",)}
    return {"model": f"mixtral-8x7b n_layers={MOE_LAYERS}/32",
            "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "lanes": lanes, "train_step": train,
            "accum_fused": dict(accum, n_buckets=n_buckets,
                                microbatches=FUSED_MICROBATCHES,
                                first_loss_vs_reference_rel=rel),
            "launches": launches, "card": card}


def moe_cards_phase(card: str):
    """Expert parallelism across the cards: NCCL ranks of the CPU tests'
    worker. The 2-layer meshes against the one-card step on the same
    weights and batch, then ep = cards at MOE_DEPTH_LAYERS, timed."""
    cards = torch.cuda.device_count()
    if cards < 4:
        raise AssertionError(f"--moe-cards-only needs 4 cards, found {cards}")
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "moe_cards")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    rng = np.random.default_rng(SEED)
    np.savez(os.path.join(tmp, "batch.npz"), x=rng.integers(
        0, 32000, (TRAIN_BATCH, TRAIN_SEQ)))
    runs = [dict(name=f"dp{dp}_ep{ep}", dp=dp, ep=ep, steps=1,
                 tx={"rule": "capture"}, reference=True, dump=False,
                 a2a_chunks=MOE_A2A_CHUNKS,
                 model_kwargs={"n_layers": MOE_LAYERS})
            for dp, ep in MOE_CARD_MESHES]
    runs.append(dict(name="depth", dp=1, ep=cards, steps=MOE_STEPS,
                     tx={"rule": "adamw", "learning_rate": TRAIN_LR},
                     dump=False, a2a_chunks=MOE_A2A_CHUNKS,
                     model_kwargs={"n_layers": MOE_DEPTH_LAYERS}))
    cfg = dict(model="mixtral-8x7b", device="cuda", seed=SEED,
               batch=os.path.join(tmp, "batch.npz"), runs=runs)
    wall = run_ranks("moe_cards", MOE_WORKER, "moe", cfg, tmp,
                     MOE_RANK_TIMEOUT_S)
    report = json.load(open(os.path.join(tmp, "moe0.json")))
    shutil.rmtree(tmp, ignore_errors=True)
    limit = TRAIN_GRAD_REL_L2[torch.bfloat16]
    out = {"wall_s": wall, "card": card}
    for dp, ep in MOE_CARD_MESHES:
        rep = report[f"dp{dp}_ep{ep}"]
        ref = rep["reference"]
        own, rel = ref["grad_rel_l2"], ref["pinned_grad_rel_l2"]
        worst, own_worst = max(rel, key=rel.get), max(own, key=own.get)
        loss_rel = abs(ref["mesh_loss"] - ref["loss"]) / abs(ref["loss"])
        log(f"  dp={dp} x ep={ep}, {MOE_LAYERS} layers: loss "
            f"{ref['mesh_loss']:.6f} vs one card {ref['loss']:.6f} (rel "
            f"{loss_rel:.2e}, tol {FUSED_FIRST_LOSS_REL}); tokens whose "
            f"top-k set differs, by layer: "
            f"{[round(x, 5) for x in ref['topk_differ_share_by_layer']]}; "
            f"grads max relative L2 {own[own_worst]:.3e} ({own_worst}) "
            f"with the card routing itself, {rel[worst]:.3e} ({worst}; tol "
            f"{limit}) on the mesh's routing; experts a rank "
            f"{rep['counts']['layers.0.moe_mlp.w_gate']}")
        if rel[worst] > limit or not loss_rel <= FUSED_FIRST_LOSS_REL:
            raise AssertionError(f"moe cards dp={dp} ep={ep}: loss rel "
                                 f"{loss_rel}, {worst} rel L2 {rel[worst]}")
        out[f"dp{dp}_ep{ep}"] = {
            "loss": ref["mesh_loss"], "one_card_loss": ref["loss"],
            "loss_rel": loss_rel,
            "topk_differ_share_by_layer": ref["topk_differ_share_by_layer"],
            "grad_max_rel_l2_own_routing": own[own_worst],
            "grad_worst_param_own_routing": own_worst,
            "grad_max_rel_l2": rel[worst], "grad_worst_param": worst,
            "grad_rel_l2_limit": limit, "records": rep["records"]}
    rep = report["depth"]
    losses = [m["loss"] for m in rep["metrics"]]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"moe cards depth: losses {losses}")
    check_aux("moe cards depth", TransformerConfig.moe_aux_coef,
              MOE_DEPTH_LAYERS, [m["aux_loss"] for m in rep["metrics"]])
    step_ms = [1e3 * s for s in rep["step_s"]]
    p50 = float(np.median(step_ms[1:]))
    disp = rep["records"]["moe.dispatch"]
    # A step exchanges each layer's slots four times forward (dispatch and
    # combine, again in the remat recompute) and twice backward.
    a2a_step = 3 * 2 * MOE_DEPTH_LAYERS * sum(disp["nbytes"])
    log(f"  ep={cards}, {MOE_DEPTH_LAYERS} layers: losses "
        f"{[round(x, 4) for x in losses]}; step ms "
        f"{[round(x, 1) for x in step_ms]} (p50 after the first {p50:.1f}); "
        f"peak {rep['peak_bytes'] / 1e9:.2f} GB a rank; a2a "
        f"{a2a_step / 1e9:.3f} GB a step a rank")
    out["depth"] = {
        "model": f"mixtral-8x7b n_layers={MOE_DEPTH_LAYERS}/32",
        "ep": cards, "steps": MOE_STEPS, "losses": losses,
        "aux_losses": [m["aux_loss"] for m in rep["metrics"]],
        "step_ms": step_ms, "step_p50_ms": p50,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3),
        "peak_bytes_rank0": rep["peak_bytes"],
        "experts_a_rank": rep["counts"]["layers.0.moe_mlp.w_gate"],
        "a2a_record": disp, "a2a_bytes_per_step": a2a_step}
    return out


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
        # ctx columns of context and the sink column after them.
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + i)
        return tuple(torch.nn.functional.pad(
            torch.randn((b, ctx, kvd), generator=g, device="cuda")
            .to(cfg.dtype), (0, 0, 0, 1)) for _ in range(2))
    logits, _ = model(tokens, positions=positions, kv=layer_kv, ctx=ctx)
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
    del engine
    log("[serve_quant replay]")
    serve["replay_vs_eager"] = quant_replay_vs_eager(model)
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
# train_resnet_ckpt: ResNet-50 with SGD saved, killed and resumed through
# train_loop.
# ---------------------------------------------------------------------

RESNET_CKPT_EVERY, RESNET_CKPT_KILL = 4, 6
RESNET_CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "build", "resnet_ckpt_smoke")
# The forced staging budget of the same save in pieces (bytes): the
# largest chunk (a stage-4 3x3 conv kernel, 9.4 MB) sets the buffer.
RESNET_PIECE_BUDGET = 1 << 20


def resnet_batches(start, stop):
    """Batches ``start``..``stop - 1`` of RESNET_BATCH seeded images and
    labels, each made on the card from its own seed: a resumed run reads
    the batches an uninterrupted one reads at the same steps."""
    for i in range(start, stop):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1000 + i)
        x = torch.randn((RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3),
                        generator=gen, device="cuda")
        y = torch.randint(0, 1000, (RESNET_BATCH,), generator=gen,
                          device="cuda")
        yield {"x": x.to(torch.bfloat16), "y": y}


def resnet_state_tensors(state):
    """Every parameter, BN buffer and momentum trace of a ResNet train
    state, cloned."""
    model = state.model
    out = {n: t.detach().clone() for n, t in model.state_dict().items()}
    names = [n for n, _ in model.named_parameters()]
    out.update({f"trace:{n}": t.clone()
                for n, t in zip(names, state.opt_state.trace)})
    return out


def resnet_ckpt_run(tag, seed, ckpt_dir="", save_every=0, kill=None):
    """ResNet-50 (fused BN lane, s2d stem, bf16 compute) from ``seed``
    through ``train_loop`` with ``sgd(0.1, momentum=0.9)`` up to step
    RESNET_STEPS: a ``ckpt_dir`` arms the restore and, with
    ``save_every``, the saves (no final save); ``kill`` ends the run after
    that many steps. Returns the run's numbers and its state."""
    model = get_model("resnet50", device="cuda", fused_bn=True,
                      s2d_stem=True, seed=seed)
    state = create_train_state(model, sgd(RESNET_LR,
                                          momentum=RESNET_MOMENTUM))
    step = make_train_step(apply_kwargs_of=lambda b: {"train": True})
    start = (ckpt.latest_step(ckpt_dir) or 0) if ckpt_dir else 0
    losses = []

    def on_step(i, metrics):
        losses.append(float(metrics["loss"]))     # syncs
        if kill is not None and i == kill:
            raise _Killed(i)

    for name in BN_NAMES:
        LAUNCHES[name] = 0
    profiler.reset_ckpt_records()
    t0 = time.monotonic()
    try:
        state, _ = train_loop(state, step,
                              resnet_batches(start, RESNET_STEPS),
                              ckpt_dir=ckpt_dir, save_every=save_every,
                              save_final=False, on_step=on_step)
    except _Killed:
        pass
    torch.cuda.synchronize()
    run = {"tag": tag, "start_step": start, "steps": len(losses),
           "losses": losses, "seconds": time.monotonic() - t0,
           "launches": {n: LAUNCHES[n] for n in BN_NAMES},
           "final_step": state.step, "saves": recorded_save(),
           "restore": profiler.ckpt_report().get("restore")}
    log(f"  {tag}: steps {start + 1}..{start + len(losses)} in "
        f"{run['seconds']:.1f} s, losses {[round(x, 5) for x in losses]}"
        + "".join(f"; save at step {v['step']}: stall {v['stall_ms']:.1f} "
                  f"ms, write {v['write_s']:.3f} s, {v['nbytes']} bytes, "
                  f"{v['pieces']} piece(s)" for v in run["saves"])
        + (f"; restore {run['restore']['seconds']:.3f} s"
           if run["restore"] else ""))
    return run, state


def step_files(root, step):
    """The shard files of a committed step, name → bytes."""
    d = ckpt.step_dir(root, step)
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.name.endswith(".bin")}


def save_both_ways(state, root):
    """``state`` saved whole-staged and through RESNET_PIECE_BUDGET in
    pieces: the pieces save's record and whether both wrote the same
    bytes."""
    tree = ckpt.encode_portable(state)
    snaps = {}
    for how, budget in (("whole", None), ("pieces", RESNET_PIECE_BUDGET)):
        saved = ckpt_snapshot._STAGING_BUDGET
        ckpt_snapshot._STAGING_BUDGET = budget
        try:
            mgr = ckpt.AsyncCheckpointer(os.path.join(root, how))
            snaps[how] = mgr.save(tree, step=state.step, block=True)
            mgr.close()
        finally:
            ckpt_snapshot._STAGING_BUDGET = saved
    same = step_files(os.path.join(root, "whole"), state.step) == \
        step_files(os.path.join(root, "pieces"), state.step)
    return snaps, same


def train_resnet_ckpt_phase(card: str):
    """ResNet-50 at batch 256 on the fused BN lane with deterministic
    cuDNN: run A 8 steps uninterrupted; run B saves at step 4 through
    train_loop, is killed after step 6 and resumed to step 8 from other
    weights; B's step-8 parameters, BN buffers and traces torch.equal
    A's, rows 10-13 launched their exact counts after the restore; the
    step-8 state saved whole and in pieces writes the same bytes."""
    shutil.rmtree(RESNET_CKPT_ROOT, ignore_errors=True)
    os.makedirs(RESNET_CKPT_ROOT)
    try:
        with deterministic_cudnn():
            return train_resnet_ckpt_run(card)
    finally:
        shutil.rmtree(RESNET_CKPT_ROOT, ignore_errors=True)


def train_resnet_ckpt_run(card: str):
    root = os.path.join(RESNET_CKPT_ROOT, "B")
    run_a, state = resnet_ckpt_run("A (uninterrupted)", SEED)
    ref = resnet_state_tensors(state)
    del state
    run_b1, state = resnet_ckpt_run("B (killed after step 6)", SEED, root,
                                    save_every=RESNET_CKPT_EVERY,
                                    kill=RESNET_CKPT_KILL)
    del state
    committed = ckpt.committed_steps(root)
    if committed != [RESNET_CKPT_EVERY] or run_b1["steps"] != \
            RESNET_CKPT_KILL:
        raise AssertionError(f"train_resnet_ckpt: B committed {committed} "
                             f"after {run_b1['steps']} steps")
    run_b2, state = resnet_ckpt_run("B (resumed, other weights)", SEED + 1,
                                    root)
    got = resnet_state_tensors(state)
    differ = [n for n in ref if not torch.equal(ref[n], got[n])]
    control = None
    if differ:
        # Whether two uninterrupted runs agree at all on this machine.
        _, again = resnet_ckpt_run("A again (control)", SEED)
        control = [n for n in ref
                   if not torch.equal(ref[n], resnet_state_tensors(again)[n])]
        raise AssertionError(
            f"train_resnet_ckpt: the resumed step 8 differs from A's in "
            f"{len(differ)} of {len(ref)} tensors ({differ[:4]}); two "
            f"uninterrupted runs differ in {len(control)}")
    after = RESNET_STEPS - RESNET_CKPT_EVERY
    expect = {k: v * after for k, v in RESNET_BN_PER_STEP.items()}
    if run_b2["start_step"] != RESNET_CKPT_EVERY or run_b2["final_step"] \
            != RESNET_STEPS or run_b2["launches"] != expect:
        raise AssertionError(f"train_resnet_ckpt: resumed at "
                             f"{run_b2['start_step']}, ended at "
                             f"{run_b2['final_step']}, launches "
                             f"{run_b2['launches']} != {expect}")
    if run_b2["losses"] != run_a["losses"][RESNET_CKPT_EVERY:]:
        raise AssertionError(f"train_resnet_ckpt: losses after the restore "
                             f"{run_b2['losses']} != A's "
                             f"{run_a['losses'][RESNET_CKPT_EVERY:]}")
    n_params = len([n for n in ref if n.startswith("trace:")])
    log(f"  B's step {RESNET_STEPS} == A's: {len(ref)} tensors torch.equal "
        f"({n_params} parameters, their traces, "
        f"{len(ref) - 2 * n_params} BN buffers); losses of steps "
        f"{RESNET_CKPT_EVERY + 1}-{RESNET_STEPS} equal; launches after the "
        f"restore {run_b2['launches']}")
    snaps, same = save_both_ways(state, os.path.join(RESNET_CKPT_ROOT, "AB"))
    pieces, whole = snaps["pieces"], snaps["whole"]
    if not same or whole.pieces != 1 or pieces.pieces < 2:
        raise AssertionError(f"train_resnet_ckpt: whole ({whole.pieces} "
                             f"piece) and in pieces ({pieces.pieces}) "
                             f"wrote the same bytes: {same}")
    log(f"  step {RESNET_STEPS} saved whole and in {pieces.pieces} pieces "
        f"of a {pieces.staging_nbytes} byte buffer (budget "
        f"{RESNET_PIECE_BUDGET}): the same bytes on disk; stall "
        f"{1e3 * whole.stall_s:.1f} ms whole, "
        f"{1e3 * pieces.stall_s:.1f} ms in pieces")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    save, restore = run_b1["saves"][0], run_b2["restore"]
    return {"model": "resnet50 fused_bn=True s2d_stem=True bf16 compute",
            "batch": RESNET_BATCH, "image": RESNET_IMAGE, "lr": RESNET_LR,
            "momentum": RESNET_MOMENTUM, "cudnn_deterministic": True,
            "save_every": RESNET_CKPT_EVERY, "killed_after": RESNET_CKPT_KILL,
            "state_bytes": save["nbytes"], "save": save,
            "restore_s": restore["seconds"], "restore": restore,
            "tensors_equal": len(ref), "runs": [run_a, run_b1, run_b2],
            "launches_after_restore": run_b2["launches"],
            "pieces": {"budget": RESNET_PIECE_BUDGET,
                       "pieces": pieces.pieces,
                       "staging_nbytes": pieces.staging_nbytes,
                       "stall_ms": 1e3 * pieces.stall_s,
                       "whole_stall_ms": 1e3 * whole.stall_s,
                       "same_bytes": same},
            "card": card}



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
    write times, and the device staging's pieces, buffer and budget), or
    none."""
    r = profiler.ckpt_report().get("async_save")
    if r is None:
        return []
    return [{"step": r["step"], "stall_ms": 1e3 * r["stall_s"],
             "alloc_ms": 1e3 * r["alloc_s"], "stage_ms": 1e3 * r["stage_s"],
             "d2h_ms": 1e3 * r["d2h_s"], "write_s": r["write_s"],
             "nbytes": r["nbytes"], "pieces": r["pieces"],
             "staging_nbytes": r["staging_nbytes"],
             "budget_nbytes": r["budget_nbytes"]}]


def ckpt_run(tag, mesh, seed, data_path, ckpt_dir=None, save_every=0,
             kill=None, reference=None, layers=TRAIN_LAYERS,
             steps=TRAIN_STEPS):
    """One run of the ``layers``-deep job (8 by default) through
    train_loop on the memmapped tokens, on a DeviceIterator, to step
    ``steps``: a ``ckpt_dir`` arms the restore and, with ``save_every``,
    the async saves (no final save). Returns the run's numbers and, after
    its last step, its state and data cursor as the manifest would hold
    them: a host snapshot (the snapshot engine's synchronous copy, nothing
    written), or, given a ``reference`` snapshot, their comparison with it
    (:func:`same_state`)."""
    model = ckpt_model(layers, seed)
    state = create_train_state(model, adamw(TRAIN_LR), mesh=mesh)
    step = loop_step_fn(model, mesh)
    start = (ckpt.latest_step(ckpt_dir) or 0) if ckpt_dir else 0
    data = token_stream(mesh, data_path, steps - start)
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
    if [v["pieces"] for v in run_b1["saves"]] != [1]:
        raise AssertionError(f"train_ckpt: the {TRAIN_LAYERS}-layer save "
                             f"was not staged whole: {run_b1['saves']}")
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
# --ckpt-depth-only: an unsharded state whose whole staging does not fit
# on the card, saved in pieces.
# ---------------------------------------------------------------------

# llama2-7b unsharded with per-leaf AdamW: 16 bytes a parameter for the
# step (f32 params, grads, mu, nu) and 12 for a whole-staged save do not
# fit in 80 GB at 16 layers (3.50 B parameters, ~98 GB); in pieces ~56 GB
# plus one piece. The save writes 12 bytes a parameter (42.0 GB at 16
# layers), under CKPT_WRITE_LIMIT.
DEPTH_LAYERS, DEPTH_MIN_LAYERS = 16, 13
DEPTH_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "ckpt_depth_smoke")
# Host memory left beside the pinned slot (the checkpointer's own margin,
# the restore's pinned buffer and the interpreter).
DEPTH_HOST_MARGIN = ckpt_snapshot._HOST_MARGIN + (4 << 30)


def decoder_params(layers):
    """llama2-7b's parameter count at ``layers`` layers (a meta-device
    model: nothing is allocated)."""
    cfg = TransformerConfig(n_layers=layers)
    return sum(p.numel() for p in Transformer(cfg, device="meta")
               .parameters())


def depth_layers():
    """DEPTH_LAYERS, or the deepest depth down to DEPTH_MIN_LAYERS whose
    checkpoint (12 bytes a parameter) the host's free memory (one pinned
    slot), its disk and the command's write limit hold; with why."""
    avail = meminfo_available()
    free = shutil.disk_usage(os.path.dirname(DEPTH_ROOT)).free
    for layers in range(DEPTH_LAYERS, DEPTH_MIN_LAYERS - 1, -1):
        nbytes = 12 * decoder_params(layers)
        short = [what for what, ok in (
            ("host memory", nbytes + DEPTH_HOST_MARGIN <= avail),
            ("disk", 1.1 * nbytes <= free),
            ("write limit", nbytes <= CKPT_WRITE_LIMIT)) if not ok]
        if not short:
            why = None if layers == DEPTH_LAYERS else (
                f"{DEPTH_LAYERS} layers: too little {', '.join(last)}")
            return layers, nbytes, avail, free, why
        last = short
    raise RuntimeError(f"--ckpt-depth-only: not even {DEPTH_MIN_LAYERS} "
                       f"layers fit ({', '.join(last)}; host "
                       f"MemAvailable {avail / 1e9:.1f} GB, free disk "
                       f"{free / 1e9:.1f} GB)")


def chunks_equal_on_card(tree, chunks):
    """Each part of ``tree`` this process owns against the host chunk of
    a snapshot of the same structure, byte for byte: card tensors on the
    card (``torch.equal`` of their integer views, one chunk at a time),
    host leaves on the host. Returns the paths that differ."""
    leaves, parts = ckpt_snapshot._owned_parts(tree)
    if len(parts) != len(chunks):
        return ["<chunk count>"]
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    bad = []
    for (li, start, value, perm, region), (lc, sc, host) in zip(parts,
                                                               chunks):
        path = leaves[li]["path"]
        if (li, list(start), tuple(region)) != (lc, sc, host.shape):
            bad.append(path)
            continue
        if not isinstance(value, torch.Tensor):
            if not np.array_equal(np.asarray(value).reshape(region), host):
                bad.append(path)
            continue
        kind = ints[value.element_size()]
        live = ckpt_snapshot._oriented(value, perm).contiguous().view(kind)
        saved = torch.from_numpy(np.ascontiguousarray(host).reshape(-1)
                                 .view(np.uint8)).to(value.device)
        if not torch.equal(live.reshape(-1), saved.view(kind)):
            bad.append(f"{path} {start}")
        del live, saved
    return bad


def ckpt_depth_phase(card: str):
    """llama2-7b unsharded at DEPTH_LAYERS (or the deepest the host
    holds) with per-leaf AdamW: one step, a save whose whole staging does
    not fit on the card, staged in pieces (the staged bytes torch.equal
    the live state); a fresh state from other weights restores it and
    equals the saved one chunk for chunk on the card."""
    layers, nbytes, avail, free, why = depth_layers()
    log(f"  depth {layers} layers ({nbytes / 1e9:.2f} GB a checkpoint); "
        f"host MemAvailable {avail / 1e9:.1f} GB, free disk "
        f"{free / 1e9:.1f} GB" + (f"; {why}" if why else ""))
    shutil.rmtree(DEPTH_ROOT, ignore_errors=True)
    os.makedirs(DEPTH_ROOT)
    try:
        out = ckpt_depth_run(layers, DEPTH_ROOT)
    finally:
        shutil.rmtree(DEPTH_ROOT, ignore_errors=True)
    out.update(layers=layers, reduced_because=why, host_mem_available=avail,
               disk_free=free, card=card)
    return out


def ckpt_depth_run(layers, root):
    state = create_train_state(ckpt_model(layers, SEED), adamw(TRAIN_LR))
    n_params = sum(p.numel() for p in state.model.parameters())
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, CKPT_VOCAB, (TRAIN_BATCH, TRAIN_SEQ), dtype=np.int32),
        device="cuda")
    step = make_train_step(lambda out, b: out,
                           apply_kwargs_of=lambda b: {"targets": b["x"]})
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, {"x": tokens})
    loss = float(metrics["loss"])
    step_peak = torch.cuda.max_memory_allocated()
    tree = ckpt.encode_portable(state)
    parts = ckpt_snapshot._owned_parts(tree)[1]
    sizes = [t.numel() * t.element_size() for _, _, t, _, _ in parts
             if isinstance(t, torch.Tensor) and t.is_cuda]
    whole = sum(-(-n // 256) * 256 for n in sizes)
    largest = max(sizes)
    budget = ckpt_snapshot.staging_budget(torch.device("cuda"))
    allocated = torch.cuda.memory_allocated()
    log(f"  {n_params} parameters; step loss {loss:.4f}, step peak "
        f"{step_peak / 1e9:.2f} GB; allocated {allocated / 1e9:.2f} GB; "
        f"whole staging {whole / 1e9:.2f} GB against a budget of "
        f"{budget / 1e9:.2f} GB")
    if whole <= budget:
        raise AssertionError(f"--ckpt-depth-only: the whole staging "
                             f"({whole / 1e9:.2f} GB) fits the budget "
                             f"({budget / 1e9:.2f} GB): nothing in pieces")
    profiler.reset_ckpt_records()
    torch.cuda.reset_peak_memory_stats()
    mgr = ckpt.AsyncCheckpointer(root, keep=1)
    snap = mgr.save(tree, step=state.step)
    chunks = snap.chunks          # views of the pinned slot, kept
    save_peak = torch.cuda.max_memory_allocated()
    high_water = save_peak - allocated
    t0 = time.monotonic()
    staged_bad = chunks_equal_on_card(tree, chunks)
    check_s = time.monotonic() - t0
    mgr.wait()
    mgr.close()
    save = recorded_save()[0]
    budget = snap.budget_nbytes          # the save's own reading
    if staged_bad or snap.pieces < 2:
        raise AssertionError(f"--ckpt-depth-only: {snap.pieces} piece(s); "
                             f"staged bytes differ from the live state at "
                             f"{staged_bad[:4]}")
    if snap.staging_nbytes > max(budget, largest) \
            or high_water > budget + largest:
        raise AssertionError(f"--ckpt-depth-only: staging buffer "
                             f"{snap.staging_nbytes}, high-water "
                             f"{high_water} past the budget {budget} + the "
                             f"largest chunk {largest}")
    log(f"  save in {snap.pieces} pieces of a "
        f"{snap.staging_nbytes / 1e9:.2f} GB buffer: stall "
        f"{snap.stall_s:.2f} s (staging {snap.stage_s:.3f} s, "
        f"device-to-host {snap.d2h_s:.2f} s, pinning and allocation "
        f"{snap.alloc_s:.2f} s), staging high-water "
        f"{high_water / 1e9:.2f} GB against the budget "
        f"{budget / 1e9:.2f} GB + largest chunk {largest / 1e9:.3f} GB; "
        f"peak {save_peak / 1e9:.2f} GB; staged bytes equal the live "
        f"state ({check_s:.1f} s); write {save['write_s']:.1f} s")
    del tree, state, metrics, step, parts
    gc.collect()
    torch.cuda.empty_cache()
    fresh = create_train_state(ckpt_model(layers, SEED + 1),
                               adamw(TRAIN_LR))
    profiler.reset_ckpt_records()
    fresh = ckpt.decode_portable(ckpt.restore_pytree(
        root, ckpt.encode_portable(fresh)))
    restore = profiler.ckpt_report()["restore"]
    t0 = time.monotonic()
    restored_bad = chunks_equal_on_card(ckpt.encode_portable(fresh), chunks)
    check2_s = time.monotonic() - t0
    if restored_bad or fresh.step != 1 or fresh.opt_state.count != 1:
        raise AssertionError(f"--ckpt-depth-only: the restored state "
                             f"differs at {restored_bad[:4]} (step "
                             f"{fresh.step}, count {fresh.opt_state.count})")
    log(f"  restore {restore['seconds']:.1f} s (host-to-device "
        f"{restore['h2d_s']:.2f} s); the restored state equals the saved "
        f"one chunk for chunk on the card ({len(chunks)} chunks, "
        f"{check2_s:.1f} s)")
    del fresh, chunks, snap
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": f"llama2-7b n_layers={layers}/32 unsharded, per-leaf "
                     f"AdamW, xent_chunk={LOOP_XENT_CHUNK}, remat "
                     f"{LOOP_POLICY}", "params": n_params, "loss": loss,
            "checkpoint_bytes": save["nbytes"], "whole_staging_bytes": whole,
            "budget_bytes": budget, "largest_chunk_bytes": largest,
            "pieces": save["pieces"],
            "staging_nbytes": save["staging_nbytes"],
            "staging_high_water_bytes": high_water,
            "allocated_before_save": allocated, "step_peak": step_peak,
            "save_peak": save_peak, "save": save, "restore": restore,
            "staged_equal_live": True, "restored_equal_saved": True}


# ---------------------------------------------------------------------
# Serve-replica phase.
# ---------------------------------------------------------------------

REPLICA_ENGINE = dict(ctx_max=2048, block_size=16, q_block=16,
                      max_running=16, prefix_cache=True,
                      prefill_chunk=PREFIX_CHUNK)
# The keys of a replica's stats file that the reference's AM, session,
# router and autoscaler read.
REPLICA_STATS_KEYS = {"qps", "p99_ms", "queue_depth", "running", "completed",
                      "acceptance_rate", "role", "warm_standby",
                      "weight_version", "weight_step", "weight_swaps",
                      "swapping", "rpc_port", "prefix_digest",
                      "prefix_cache_hit_rate", "blocks_shared",
                      "prefill_chunks"}
REPLICA_STATS_EVERY_S = 0.5
REPLICA_UNCOMMITTED_STEP = 7


class LongCallRpcClient(RpcClient):
    """The port's RPC client with a per-operation socket timeout long
    enough for a 32-layer generate under load or a swap's restore: past
    ``SOCKET_TIMEOUT_S`` the client re-sends the call as a transport
    fault."""
    SOCKET_TIMEOUT_S = 600.0


def chain_keys_of(tokens):
    """The chain keys of ``tokens``' full 16-token blocks."""
    from tony_tpu_torch.serve import prefix
    return prefix.chain_keys(tokens, REPLICA_ENGINE["block_size"])


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
        # A prompt served only before the swap: its blocks are published.
        before = np.random.default_rng(SEED + 4).integers(
            0, cfg.vocab, 300).tolist()
        replica.generate(before, 8)
        if not set(chain_keys_of(before)) <= set(engine.prefix_digest()):
            raise AssertionError("serve_replica: a served prompt's blocks "
                                 "are not in the prefix digest")
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
        # The flip flushed the prefix tier: the prompt served only before
        # it adopts nothing. The mix's prompt is served once to publish
        # its blocks again, so the next call takes the launches ``alone``
        # took before the swap.
        hits = engine.prefix_hit_blocks
        after_swap = replica.generate(before, 8).tokens
        if engine.prefix_hit_blocks != hits:
            raise AssertionError(
                f"serve_replica: {engine.prefix_hit_blocks - hits} hit "
                f"blocks after the swap")
        replica.generate(prompt, n)
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
    digest = len(engine.prefix_digest())
    lanes = {k: float(stats[k]) for k in (
        "prefix_cache_hit_rate", "blocks_shared", "prefill_chunks")}
    del replica, engine
    gc.collect()
    torch.cuda.empty_cache()
    # A fresh replica on the step the swap published gives the prompt
    # served before the swap the tokens the swapped replica gave it.
    fresh = Replica(model_name="llama2-7b",
                    model_kwargs=replica_model_kwargs(layers),
                    ckpt_dir=root, dtype_policy="bf16", **REPLICA_ENGINE)
    fresh_tokens = fresh.generate(before, 8).tokens
    if fresh.restored_step != step or fresh_tokens != after_swap:
        raise AssertionError("serve_replica: the swapped replica's tokens "
                             "differ from a fresh replica's")
    log(f"  after the swap: 0 hit blocks for the prompt served before it; "
        f"its tokens == a fresh Replica's ({digest} keys in the digest)")
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    standby = standby_replica(root, layers)
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
            "prefix_lanes": dict(lanes, digest_keys=digest,
                                 hit_blocks_after_swap=0,
                                 fresh_replica_tokens_equal=True),
            "max_memory_allocated": peak, "standby": standby, "card": card}


def standby_replica(root, layers):
    """A replica started as a warm standby: its stats file says
    ``warm_standby`` 1; ``promote`` over RPC returns True and the file
    says 0 as the call returns (the publisher's own tick is an hour
    away); a second ``promote`` returns False."""
    t0 = time.monotonic()
    replica = Replica(model_name="llama2-7b",
                      model_kwargs=replica_model_kwargs(layers),
                      ckpt_dir=root, dtype_policy="bf16", warm_standby=True,
                      **REPLICA_ENGINE)
    up_s = time.monotonic() - t0
    path = os.path.join(root, "standby-stats.json")
    stop = threading.Event()
    server = threading.Thread(
        target=replica.serve_forever, daemon=True,
        kwargs=dict(host="127.0.0.1", port=0, stats_path=path,
                    stats_every_s=3600.0, stop=stop))
    server.start()
    try:
        first = wait_for_stats(path, lambda s: "rpc_port" in s)
        with LongCallRpcClient(f"127.0.0.1:{replica.port}") as client:
            promoted = client.call("promote")
            with open(path) as f:
                after = json.load(f)
            again = client.call("promote")
    finally:
        stop.set()
        server.join(timeout=30)
    if server.is_alive():
        raise AssertionError("serve_replica standby: serve_forever did not "
                             "stop")
    if first["warm_standby"] != 1.0 or promoted is not True or \
            after["warm_standby"] != 0.0 or again is not False:
        raise AssertionError(f"serve_replica standby: stats "
                             f"{first['warm_standby']} -> promote "
                             f"{promoted} -> {after['warm_standby']}, "
                             f"second promote {again}")
    res = {"up_s": up_s, "warmed_programs": replica.warmed,
           "timings": replica.timings,
           "warm_standby_before_after": [first["warm_standby"],
                                         after["warm_standby"]],
           "second_promote": again}
    log(f"  standby replica: up in {up_s:.2f} s ({replica.warmed} programs "
        f"warmed), warm_standby 1 -> promote over RPC -> 0 at once, "
        f"second promote False")
    del replica
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------
# tony_jobs: the train -> serve loop as TonY jobs of the port's own
# control plane (tony_tpu_torch.cli submit / serve, its AM, scheduler
# and executor), with a gpus ask pinned to the census's card.
# ---------------------------------------------------------------------

# The train job commits a step every JOB_EVERY of its JOB_STEPS steps:
# two saves of 12 bytes a parameter. In the whole script they run at
# JOB_LAYERS (5.57 GB each): at 8 layers (22.57 GB each) they would pass,
# beside train_ckpt's 30.6 GB, the 45 GiB of disk writes a command may
# make on the card's machine. ``--job-depth-only`` runs the phase alone
# at JOB_DEPTH_LAYERS, its two saves (45.14 GB) its only large writes.
JOB_LAYERS, JOB_DEPTH_LAYERS = 1, 8
JOB_STEPS, JOB_EVERY = 4, 2
JOB_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "tony_jobs_smoke")
JOB_SCRIPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "workloads")
JOB_PROMPT_LENS = (16, 64, 200, 512)     # the serve job's four prompts
JOB_NEW_TOKENS = 8
JOB_TIMEOUT_S = 600
# --job-cards-only: one worker a card, the train cell's depth, no saves.
JOB_CARDS_LAYERS, JOB_CARDS_STEPS = TRAIN_LAYERS, 5
JOB_FLASH_KERNELS = MMA_FWD_KERNELS + MMA_BWD_KERNELS + CORE_FWD_KERNELS \
    + CORE_BWD_KERNELS


def gpu_census():
    """(a) The port's GPU census against what ``nvidia-smi
    --query-gpu=index,uuid,name`` names: every card, at its index, under
    its UUID and name."""
    from tony_tpu_torch import discovery

    rows = [line.split(", ") for line in subprocess.run(
        ["nvidia-smi", "--query-gpu=index,uuid,name",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()]
    named = discovery.restrict_to_visible(
        [discovery.GpuDevice(int(i), uuid, name, 0) for i, uuid, name in rows],
        os.environ.get("CUDA_VISIBLE_DEVICES"))
    topo = discovery.discover_gpus()
    got = [(d.index, d.uuid, d.name) for d in topo.devices]
    want = [(d.index, d.uuid, d.name) for d in named]
    if topo.source != "nvidia-smi" or got != want \
            or topo.num_gpus != torch.cuda.device_count():
        raise AssertionError(f"tony_jobs: the census ({topo.source}) found "
                             f"{got}, nvidia-smi names {want}, torch counts "
                             f"{torch.cuda.device_count()}")
    log(f"  census ({topo.source}): {got}")
    return topo


def job_env():
    """The env the jobs run in: the checkout on PYTHONPATH, and ``python``
    on PATH being this interpreter (the tasks' commands say ``python``)."""
    bin_dir = os.path.join(JOB_ROOT, "bin")
    os.makedirs(bin_dir, exist_ok=True)
    wrapper = os.path.join(bin_dir, "python")
    if not os.path.exists(wrapper):
        # exec by this interpreter's own path (a symlink elsewhere would
        # lose its virtual environment).
        with open(wrapper, "w") as fh:
            fh.write(f"#!/bin/sh\nexec {sys.executable} \"$@\"\n")
        os.chmod(wrapper, 0o755)
    root = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ,
                PATH=os.pathsep.join([bin_dir, os.environ.get("PATH", "")]),
                PYTHONPATH=os.pathsep.join(
                    [root, os.environ.get("PYTHONPATH", "")]))


def tony_cli(args, workdir, out_name, wait=True):
    """``python -m tony_tpu_torch.cli <args> --workdir <workdir>``, its
    output in ``<workdir>/<out_name>``: the return code, or the running
    process (``wait=False``)."""
    os.makedirs(workdir, exist_ok=True)
    out = open(os.path.join(workdir, out_name), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.cli", *args, "--workdir",
         workdir], cwd=os.path.dirname(os.path.abspath(__file__)),
        env=job_env(), stdout=out, stderr=subprocess.STDOUT)
    out.close()
    if not wait:
        return proc
    try:
        return proc.wait(timeout=JOB_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def job_dir(workdir):
    """The one application directory a submit made under ``workdir``."""
    apps = [d for d in os.listdir(workdir) if d.startswith("app_")]
    if len(apps) != 1:
        raise AssertionError(f"tony_jobs: {workdir} holds {apps}")
    return os.path.join(workdir, apps[0])


def job_final(workdir):
    with open(os.path.join(job_dir(workdir), "final-status.json")) as fh:
        return json.load(fh)


def job_tail(workdir, out_name):
    """The client's output and the containers' logs, for a failure."""
    parts = []
    for path in [os.path.join(workdir, out_name)] + sorted(
            glob_files(job_dir(workdir), ("executor.log", "stdout.log",
                                          "stderr.log"))):
        with open(path, errors="replace") as fh:
            parts.append(f"== {path}\n{fh.read()[-3000:]}")
    return "\n".join(parts)


def glob_files(root, names):
    return [os.path.join(d, n) for d, _, files in os.walk(root)
            for n in files if n in names]


def job_results(workdir):
    """Every task's ``job_result.json``, in rank order."""
    out = []
    for path in glob_files(job_dir(workdir), ("job_result.json",)):
        with open(path) as fh:
            out.append(json.load(fh))
    return sorted(out, key=lambda r: r["rank"])


def train_job_args(layers, steps, data_path, batch, workers, gpus,
                   ckpt_dir=None, name="tony-jobs-train"):
    cmd = (f"python torch_job_train.py --model llama2-7b --layers {layers} "
           f"--steps {steps} --data {data_path} --batch {batch} "
           f"--lr {TRAIN_LR!r} --seed {SEED} --xent-chunk {LOOP_XENT_CHUNK} "
           f"--remat-policy {LOOP_POLICY} --device cuda")
    args = ["submit", "--framework", "pytorch", "--src_dir", JOB_SCRIPT_DIR,
            "--executes", cmd, "--name", name,
            "--conf", f"tony.worker.instances={workers}",
            "--conf", f"tony.worker.gpus={gpus}",
            "--conf", f"tony.data.seed={SEED}"]
    if ckpt_dir:
        args += ["--conf", f"tony.ckpt.dir={ckpt_dir}",
                 "--conf", f"tony.ckpt.every={JOB_EVERY}"]
    return args


def check_task_card(tag, result, topo, offset):
    """The task saw exactly one card, the census's card at ``offset``,
    pinned by TonY."""
    card = topo.devices[offset]
    if result["visible"] != str(card.index) or result["task_gpus"] != "1" \
            or result["device_count"] != 1 or result["uuid"] != card.uuid:
        raise AssertionError(f"{tag}: rank {result['rank']} saw "
                             f"{result['visible']!r} (TONY_TASK_GPUS "
                             f"{result['task_gpus']}, {result['device_count']}"
                             f" card(s), {result['uuid']}), the census's card"
                             f" {offset} is {card}")


def steady_p50(step_ms):
    """The p50 of a job's steps between its first (allocation, cuBLAS
    and kernel-library warm-up) and its last (profiled), for a job that
    saves no checkpoint."""
    return float(np.median(step_ms[1:-1]))


def job_step_kinds(step_ms, every):
    """A saving job's step times by kind. ``step_ms[k - 1]`` runs from
    the end of step k - 1 to the end of step k, so it carries the save
    ``train_loop`` makes after step k - 1 where ``every`` divides k - 1:
    the first (warm-up), the steps that carry a save (the first of them
    pinning its host slot), the last (profiled), and the plain rest with
    their p50 (None where there is none)."""
    last = len(step_ms)
    saves = [k for k in range(2, last) if (k - 1) % every == 0]
    plain = [k for k in range(2, last) if (k - 1) % every]
    return {"warmup_ms": step_ms[0], "last_ms": step_ms[-1],
            "last_carries_save": (last - 1) % every == 0,
            "save_steps": saves,
            "save_ms": [step_ms[k - 1] for k in saves],
            "plain_steps": plain,
            "plain_ms": [step_ms[k - 1] for k in plain],
            "plain_p50_ms": float(np.median([step_ms[k - 1] for k in plain]))
            if plain else None}


def job_writes(layers):
    """The bytes the train job's saves write at ``layers`` layers (12 a
    parameter: f32 parameters and AdamW's two moments)."""
    return JOB_STEPS // JOB_EVERY * 12 * decoder_params(layers)


def job_flash_profile(result):
    return {"flash_kernel_launches_per_step": {
        k: n for k, n in result["profiled_kernels"].items()
        if any(name in k for name in JOB_FLASH_KERNELS)}}


def committed_equals(snap, root, step):
    """The committed step ``step`` under ``root`` holds ``snap``: the same
    leaves, and per chunk the same extent and bytes (read back through the
    port's ``ChunkReader``, which checks each chunk's CRC32)."""
    from tony_tpu_torch.ckpt import format as ckpt_format

    manifest = ckpt_format.read_manifest(root, step)
    if manifest["leaves"] != json.loads(json.dumps(snap.leaves)):
        raise AssertionError(f"tony_jobs: step {step} under {root} holds "
                             f"other leaves than the in-process run")
    index = {(c["leaf"], tuple(c["start"])): c for c in manifest["chunks"]}
    if len(index) != len(snap.chunks):
        raise AssertionError(f"tony_jobs: {len(index)} chunks on disk, "
                             f"{len(snap.chunks)} in process")
    nbytes = 0
    with ckpt_format.ChunkReader(root, step, manifest) as reader:
        for leaf, start, arr in snap.chunks:
            chunk = index.get((leaf, tuple(start)))
            want = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
            got = None if chunk is None else reader.read(chunk, arr.dtype)
            if got is None or got.shape != arr.shape or not np.array_equal(
                    got.reshape(-1).view(np.uint8), want):
                raise AssertionError(
                    f"tony_jobs: step {step} differs at "
                    f"{snap.leaves[leaf]['path']} chunk {list(start)}")
            nbytes += want.nbytes
    return {"leaves": len(snap.leaves), "chunks": len(snap.chunks),
            "bytes_compared": nbytes}


def job_tokens(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CKPT_VOCAB, (n, TRAIN_SEQ), dtype=np.int32)


def train_job(topo, data_path, layers):
    """(b) The in-process reference (``ckpt_run`` of the same depth, seed,
    data and optimizer), finished and freed, then the same 4 steps as a
    TonY job with ``tony.worker.gpus=1`` and ``tony.ckpt.every=2``: the job
    SUCCEEDED, its task saw the census's card alone, rows 1-8's forward
    and backward pair launched in it (the whole run and a profiled last
    step), its losses equal the reference's, and its committed step 4
    holds the reference's state and cursor byte for byte."""
    td.init_process_group("nccl", rank=0, world_size=1,
                          init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        ref, snap = ckpt_run("in-process reference", MeshSpec(dp=1).build(),
                             SEED, data_path, layers=layers,
                             steps=JOB_STEPS)
    finally:
        td.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_dir = os.path.join(JOB_ROOT, "ckpt")
    workdir = os.path.join(JOB_ROOT, "train")
    t_submit = time.time()
    rc = tony_cli(train_job_args(layers, JOB_STEPS, data_path,
                                 TRAIN_BATCH, 1, 1, ckpt_dir),
                  workdir, "submit.log")
    wall = time.time() - t_submit
    final = job_final(workdir)
    if rc != 0 or final["status"] != "SUCCEEDED":
        raise AssertionError(f"tony_jobs: the train job ended {rc} "
                             f"{final['status']}: {final['message']}\n"
                             + job_tail(workdir, "submit.log"))
    (res,) = job_results(workdir)
    check_task_card("tony_jobs train", res, topo, 0)
    launches = {n: res["launches"][n] for n in FLASH_NAMES}
    expect = {"flash_attention_fwd": 2 * layers * JOB_STEPS,
              "flash_attention_bwd_dq": layers * JOB_STEPS,
              "flash_attention_bwd_dkv": layers * JOB_STEPS}
    if launches != expect or launches != ref["launches"]:
        raise AssertionError(f"tony_jobs: the job launched {launches}, "
                             f"expected {expect} (in process: "
                             f"{ref['launches']})")
    prof = job_flash_profile(res)
    check_fwd_kernels("tony_jobs train", prof, 2 * layers)
    check_bwd_kernels("tony_jobs train", prof, layers)
    if res["losses"] != ref["losses"]:
        raise AssertionError(f"tony_jobs: job losses {res['losses']} != "
                             f"in-process {ref['losses']}")
    committed = ckpt.committed_steps(ckpt_dir)
    if committed != list(range(JOB_EVERY, JOB_STEPS + 1, JOB_EVERY)):
        raise AssertionError(f"tony_jobs: the job committed {committed}")
    compared = committed_equals(snap, ckpt_dir, JOB_STEPS)
    del snap
    gc.collect()
    forbidden = {"jax", "jaxlib", "flax", "optax", "tony_tpu"}
    if forbidden & set(res["modules"]):
        raise AssertionError(f"tony_jobs: the task imported "
                             f"{forbidden & set(res['modules'])}")
    out = {"layers": layers, "steps": JOB_STEPS, "every": JOB_EVERY,
           "status": final["status"], "wall_s": wall,
           "submit_to_first_step_s": res["first_step_at"] - t_submit,
           "step_ms": res["step_ms"],
           "step_kinds": job_step_kinds(res["step_ms"], JOB_EVERY),
           "losses": res["losses"], "launches": launches,
           "profiled_flash": prof["flash_kernel_launches_per_step"],
           "card": {"visible": res["visible"], "uuid": res["uuid"]},
           "peak_bytes": res["peak_bytes"], "committed": committed,
           "compared": compared,
           "reference": {"seconds": ref["seconds"], "step_ms": ref["step_ms"],
                         "losses": ref["losses"]}}
    kinds = out["step_kinds"]
    log(f"  train job: SUCCEEDED in {wall:.1f} s on {res['uuid']} (visible "
        f"{res['visible']!r}); submit to first step "
        f"{out['submit_to_first_step_s']:.1f} s; plain step(s) "
        f"{kinds['plain_steps']} {kinds['plain_ms']} ms, step(s) carrying "
        f"a save {kinds['save_steps']} {kinds['save_ms']} ms, profiled last "
        f"{kinds['last_ms']:.1f} ms; launches {launches}; losses equal "
        f"the in-process run's; committed {committed}, step {JOB_STEPS} "
        f"== in process ({compared['chunks']} chunks, "
        f"{compared['bytes_compared']} bytes)")
    return out, ckpt_dir


def overask_job(data_path):
    """(c) A job asking one card more than the host has fails at launch
    with the scheduler's message, and no task starts."""
    cards = torch.cuda.device_count()
    workdir = os.path.join(JOB_ROOT, "overask")
    rc = tony_cli(train_job_args(JOB_LAYERS, JOB_STEPS, data_path,
                                 TRAIN_BATCH, 1, cards + 1,
                                 name="tony-jobs-overask"),
                  workdir, "submit.log")
    final = job_final(workdir)
    started = os.path.isdir(os.path.join(job_dir(workdir), "containers"))
    want = f"unsatisfiable gpu ask: {cards + 1} requested, {cards} free"
    if rc == 0 or final["status"] != "FAILED" or want not in \
            final["message"] or started:
        raise AssertionError(f"tony_jobs: the over-ask ended {rc} "
                             f"{final['status']} ({final['message']}), a "
                             f"task started: {started}")
    log(f"  over-ask of {cards + 1} card(s): FAILED at launch, no task "
        f"started ({final['message']})")
    return {"gpus": cards + 1, "status": final["status"],
            "message": final["message"]}


def serve_job(ckpt_dir, vocab, layers):
    """(d) The committed step served by an in-process ``Replica`` (bf16)
    and then by ``tony_tpu_torch.cli serve --gpus 1``: four seeded
    prompts, one at a time over the RPC wire, give the in-process greedy
    tokens; row 9 launched in the replica as often as in process; ``kill``
    ends the job KILLED."""
    prompts = job_prompts(vocab)
    engine_kw = dict(ctx_max=2048, block_size=16, max_running=16)
    ref, ref_launches, ref_step = replica_reference(ckpt_dir, vocab, layers)
    workdir = os.path.join(JOB_ROOT, "serve")
    t_submit = time.time()
    proc = tony_cli(["serve", "--model", "llama2-7b", "--model_kwargs",
                     json.dumps(replica_model_kwargs(layers)),
                     "--ckpt_dir", ckpt_dir, "--gpus", "1",
                     "--ctx_max", str(engine_kw["ctx_max"]),
                     "--name", "tony-jobs-serve"],
                    workdir, "serve.log", wait=False)
    try:
        deadline = time.monotonic() + JOB_TIMEOUT_S
        stats = None
        while stats is None and time.monotonic() < deadline \
                and proc.poll() is None:
            time.sleep(0.5)
            if not any(d.startswith("app_") for d in os.listdir(workdir)):
                continue
            for path in glob_files(job_dir(workdir), ("serve-stats.json",)):
                try:
                    with open(path) as fh:
                        got = json.load(fh)
                except (OSError, ValueError):
                    continue
                if "rpc_port" in got:
                    stats = got
        if stats is None:
            raise AssertionError("tony_jobs: the serve job published no RPC "
                                 "port\n" + job_tail(workdir, "serve.log"))
        tokens, t_first = [], None
        with LongCallRpcClient(f"127.0.0.1:{int(stats['rpc_port'])}",
                               timeout=600.0) as client:
            before = client.call("serve_stats")["launches"]["flash_decode"]
            for prompt in prompts:
                out = client.call("generate", tokens=prompt,
                                  max_new_tokens=JOB_NEW_TOKENS)
                t_first = t_first or time.time()
                tokens.append(out["tokens"])
            launches = client.call("serve_stats")["launches"][
                "flash_decode"] - before
        if tokens != ref or launches != ref_launches or launches == 0 \
                or stats["weight_step"] != ref_step:
            raise AssertionError(f"tony_jobs: the serve job gave {tokens} "
                                 f"(step {stats['weight_step']}, row 9 "
                                 f"{launches}), in process {ref} (step "
                                 f"{ref_step}, row 9 {ref_launches})")
        app_id = os.path.basename(job_dir(workdir))
        rc = tony_cli(["kill", app_id], workdir, "kill.log")
        code = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    final = job_final(workdir)
    if rc != 0 or code == 0 or final["status"] != "KILLED":
        raise AssertionError(f"tony_jobs: kill returned {rc}, the serve "
                             f"job ended {code} {final['status']}")
    out = {"layers": layers, "prompts": list(JOB_PROMPT_LENS),
           "new_tokens": JOB_NEW_TOKENS, "step": ref_step, "tokens_equal": True,
           "tokens": tokens, "flash_decode_launches": launches,
           "submit_to_first_token_s": t_first - t_submit,
           "status": final["status"]}
    log(f"  serve job: step {ref_step}, {len(prompts)} prompts over RPC "
        f"give the in-process greedy tokens; row 9 launched {launches} "
        f"times in the replica; submit to first token "
        f"{out['submit_to_first_token_s']:.1f} s; kill -> {final['status']}")
    return out


def replica_reference(ckpt_dir, vocab, layers):
    """The serve jobs' reference: an in-process ``Replica`` (bf16) on the
    committed step, the four prompts one at a time. Returns their greedy
    tokens, row 9's launches and the step."""
    replica = Replica(model_name="llama2-7b",
                      model_kwargs=replica_model_kwargs(layers),
                      ckpt_dir=ckpt_dir, dtype_policy="bf16", ctx_max=2048,
                      block_size=16, max_running=16)
    LAUNCHES["flash_decode"] = 0
    tokens = [replica.generate(p, JOB_NEW_TOKENS).tokens
              for p in job_prompts(vocab)]
    launches, step = LAUNCHES["flash_decode"], replica.restored_step
    del replica
    free_cuda()
    return tokens, launches, step


def job_prompts(vocab):
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, n).tolist() for n in JOB_PROMPT_LENS]


def wait_for_replicas(workdir, proc, n):
    """The ``n`` replicas' stats files once each carries its RPC port, by
    role (the stats' ``role``)."""
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while time.monotonic() < deadline and proc.poll() is None:
        time.sleep(0.5)
        if not any(d.startswith("app_") for d in os.listdir(workdir)):
            continue
        found = {}
        for path in glob_files(job_dir(workdir), ("serve-stats.json",)):
            try:
                with open(path) as fh:
                    got = json.load(fh)
            except (OSError, ValueError):
                continue
            if "rpc_port" in got:
                found[got["role"]] = got
        if len(found) == n:
            return found
    raise AssertionError(f"tony_jobs: {n} replicas did not publish an RPC "
                         f"port\n" + job_tail(workdir, "serve.log"))


def start_route(workdir, am_address):
    """``python -m tony_tpu_torch.cli route --am <am_address>`` as a
    process; returns it and the router's port (from its first line)."""
    log_path = os.path.join(workdir, "route.log")
    out = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.cli", "route", "--am",
         am_address, "--poll_s", "0.5"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=job_env(),
        stdout=out, stderr=subprocess.STDOUT)
    out.close()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and proc.poll() is None:
        with open(log_path) as fh:
            line = fh.readline()
        if " listening on " in line:
            return proc, int(line.split(" listening on ")[1].split(",")[0]
                             .rsplit(":", 1)[1])
        time.sleep(0.1)
    proc.kill()
    proc.wait()
    with open(log_path) as fh:
        raise AssertionError(f"tony_jobs: tony route did not start: "
                             f"{fh.read()[-2000:]}")


def replica_launches(port):
    with LongCallRpcClient(f"127.0.0.1:{port}", timeout=60.0) as client:
        st = client.call("serve_stats")
    return st["launches"].get("flash_decode", 0), st


def serve_roles_job(ckpt_dir, vocab, layers, want_tokens, want_launches,
                    gpus=0):
    """(e) The committed step served split: ``cli serve --role
    prefill=1,decode=1`` (``--gpus`` as given; none: both replicas share
    card 0) and ``cli route --am <the job's AM>`` as a process. The four
    prompts sent to the router's RPC one at a time give the colocated
    serve job's tokens through 4 handoffs and no fallback; each
    replica's heartbeat, as the AM's ``serve_endpoints`` shows it,
    carries its role; row 9 launched once a layer a forward on each
    replica, the prefill replica's four prefills and the decode
    replica's the rest of the colocated job's launches. With ``gpus``,
    each task saw its own cards (``CUDA_VISIBLE_DEVICES``). ``cli kill``
    ends the job KILLED."""
    from tony_tpu_torch.am import AM_ADDRESS_FILE

    prompts = job_prompts(vocab)
    workdir = os.path.join(JOB_ROOT, f"serve_roles_gpus{gpus}")
    t_submit = time.time()
    proc = tony_cli(["serve", "--model", "llama2-7b", "--model_kwargs",
                     json.dumps(replica_model_kwargs(layers)),
                     "--ckpt_dir", ckpt_dir, "--role", "prefill=1,decode=1",
                     "--ctx_max", "2048", "--name", "tony-jobs-serve-roles"]
                    + (["--gpus", str(gpus)] if gpus else []),
                    workdir, "serve.log", wait=False)
    route = None
    try:
        stats = wait_for_replicas(workdir, proc, 2)
        with open(os.path.join(job_dir(workdir), AM_ADDRESS_FILE)) as fh:
            am_address = fh.read().strip()
        route, route_port = start_route(workdir, am_address)
        ports = {role: int(st["rpc_port"]) for role, st in stats.items()}
        before = {role: replica_launches(p)[0] for role, p in ports.items()}
        with LongCallRpcClient(f"127.0.0.1:{route_port}",
                               timeout=600.0) as router:
            deadline = time.monotonic() + 60
            while router.call("router_stats")["replicas_live"] < 2:
                if time.monotonic() > deadline:
                    raise AssertionError("tony_jobs: the router saw no "
                                         "split fleet")
                time.sleep(0.2)
            tokens, outs, t_first = [], [], None
            for prompt in prompts:
                out = router.call("generate", tokens=prompt,
                                  max_new_tokens=JOB_NEW_TOKENS)
                t_first = t_first or time.time()
                tokens.append(out["tokens"])
                outs.append({k: out[k] for k in ("replica",
                                                 "prefill_replica")})
            rstats = router.call("router_stats")
        after = {role: replica_launches(p) for role, p in ports.items()}
        launches = {role: after[role][0] - before[role] for role in ports}
        with RpcClient(am_address, timeout=30.0) as am:
            eps = am.call("serve_endpoints")
        roles = {e["job_type"]: (e.get("serve_metrics") or {}).get("role")
                 for e in eps}
        visible = {role: after[role][1].get("visible_devices")
                   for role in ports}
        if tokens != want_tokens or rstats["handoffs"] != len(prompts) \
                or rstats["handoff_fallbacks"] \
                or roles != {"prefill": "prefill", "decode": "decode"} \
                or launches["prefill"] != layers * len(prompts) \
                or sum(launches.values()) != want_launches:
            raise AssertionError(
                f"tony_jobs: the split job gave {tokens} (colocated "
                f"{want_tokens}), router {rstats}, roles {roles}, row 9 "
                f"{launches} (colocated {want_launches})\n"
                + job_tail(workdir, "serve.log"))
        if gpus and (sorted(visible.values()) != [
                ",".join(str(i) for i in range(k * gpus, (k + 1) * gpus))
                for k in range(2)]):
            raise AssertionError(f"tony_jobs: the split job's tasks saw "
                                 f"{visible}")
        app_id = os.path.basename(job_dir(workdir))
        rc = tony_cli(["kill", app_id], workdir, "kill.log")
        code = proc.wait(timeout=120)
    finally:
        if route is not None and route.poll() is None:
            route.kill()
            route.wait()
        if proc.poll() is None:
            # A failure before the kill: end the job (its AM, executors
            # and replicas), not only its client.
            with contextlib.suppress(Exception):
                tony_cli(["kill", os.path.basename(job_dir(workdir))],
                         workdir, "kill.log")
                proc.wait(timeout=60)
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    final = job_final(workdir)
    if rc != 0 or code == 0 or final["status"] != "KILLED":
        raise AssertionError(f"tony_jobs: kill returned {rc}, the split "
                             f"serve job ended {code} {final['status']}")
    out = {"layers": layers, "gpus": gpus, "tokens_equal": True,
           "router": rstats, "dispatches": outs, "roles": roles,
           "visible_devices": visible,
           "flash_decode_launches": sum(launches.values()),
           "flash_decode_launches_by_role": launches,
           "submit_to_first_token_s": t_first - t_submit,
           "status": final["status"]}
    log(f"  split serve job ({gpus} card(s) a replica): the router's 4 "
        f"handoffs give the colocated job's tokens; roles {roles}; row 9 "
        f"{launches}; visible {visible}; submit to first token "
        f"{out['submit_to_first_token_s']:.1f} s; kill -> "
        f"{final['status']}")
    return out


def tony_jobs_phase(card, layers=JOB_LAYERS):
    """(a)-(d) at ``layers`` layers: the census, the train job against
    its in-process run, the over-ask, and the serve job on the train
    job's committed step. Refuses to start where the job's saves would
    pass the command's write limit or the free disk."""
    shutil.rmtree(JOB_ROOT, ignore_errors=True)
    os.makedirs(JOB_ROOT)
    writes = job_writes(layers)
    free = shutil.disk_usage(JOB_ROOT).free
    log(f"  the train job's saves write {writes / 1e9:.2f} GB; free disk "
        f"{free / 1e9:.1f} GB")
    if writes > CKPT_WRITE_LIMIT or 1.1 * writes > free:
        raise RuntimeError(f"tony_jobs at {layers} layers: the saves write "
                           f"{writes / 1e9:.2f} GB, the write limit is "
                           f"{CKPT_WRITE_LIMIT / 1e9:.2f} GB, the free disk "
                           f"{free / 1e9:.1f} GB")
    try:
        topo = gpu_census()
        data_path = os.path.join(JOB_ROOT, "tokens.npy")
        np.save(data_path, job_tokens(SEED, CKPT_EXAMPLES))
        train, ckpt_dir = train_job(topo, data_path, layers)
        overask = overask_job(data_path)
        serve = serve_job(ckpt_dir, CKPT_VOCAB, layers)
        serve_roles = serve_roles_job(ckpt_dir, CKPT_VOCAB, layers,
                                      serve["tokens"],
                                      serve["flash_decode_launches"])
        kinds = train["step_kinds"]
        log(f"  tony_jobs at {layers} layer(s) on {card}: submit to first "
            f"step {train['submit_to_first_step_s']:.1f} s, submit to first "
            f"token {serve['submit_to_first_token_s']:.1f} s, job plain "
            f"step(s) {kinds['plain_ms']} ms (p50 {kinds['plain_p50_ms']}), "
            f"step(s) carrying a save {kinds['save_ms']} ms")
        return {"census": [d.__dict__ for d in topo.devices],
                "train": train, "overask": overask, "serve": serve,
                "serve_roles": serve_roles, "card": card}
    finally:
        shutil.rmtree(JOB_ROOT, ignore_errors=True)


def disagg_cards_phase(card):
    """``--disagg-cards-only`` (two or more cards): serve_disagg's (a) and
    (c) with the prefill engine on ``cuda:0`` and the decode engine on
    ``cuda:1``, each with its own copy of llama2-7b from the same seed
    (every parameter ``torch.equal`` across the cards): (a) tokens and
    every logits row equal to a colocated engine's on ``cuda:0``, one
    request at a time; (c) the mix from 16 threads within
    ``SERVE_REL_TOL`` of (a)'s colocated completions. Then the split
    serve job (``cli serve --role prefill=1,decode=1 --gpus 1``) on a
    committed 1-layer step, each task pinned to its own card."""
    cards = torch.cuda.device_count()
    if cards < 2:
        raise AssertionError("--disagg-cards-only needs two or more cards")
    models = [get_model("llama2-7b", device=f"cuda:{i}", seed=SEED,
                        param_dtype=torch.bfloat16) for i in range(2)]
    for (name, a), (_, b) in zip(models[0].named_parameters(),
                                 models[1].named_parameters()):
        if not torch.equal(a, b.to("cuda:0")):
            raise AssertionError(f"disagg_cards: {name} differs across the "
                                 f"cards")
    cfg = models[0].cfg
    mix = serve_mix(SEED, cfg.vocab)
    co = ServeEngine(models[0], **SERVE_ENGINE, device="cuda:0")
    front = EngineFront(co)
    front.generate([1, 2, 3, 4], 2)
    t0 = time.monotonic()
    ref = {f"a-{i}": front.generate(toks, n, rid=f"a-{i}")
           for i, (toks, n) in enumerate(mix)}
    co_wall = time.monotonic() - t0
    del front, co
    free_cuda()
    pf = ServeEngine(models[0], role="prefill", **SERVE_ENGINE,
                     device="cuda:0")
    dc = ServeEngine(models[1], role="decode", **SERVE_ENGINE,
                     device="cuda:1")
    watch = DisaggWatch(pf, dc)
    router, stop = split_router(pf, dc)
    try:
        watch.first_import = None       # check the mix's first, 28 blocks
        reqs = [(f"a-{i}", toks, n) for i, (toks, n) in enumerate(mix)]
        with torch.cuda.device(1):
            torch.cuda.reset_peak_memory_stats()
        res_a, _ = split_pass("cards (a) sequential", router, pf, dc, watch,
                              reqs, False, cfg.n_layers)
        rows = same_streams({rid: watch.completion(rid)
                             for rid, _, _ in reqs}, ref,
                            "disagg_cards (a)")
        if res_a["handoffs"] != len(mix) or res_a["fallbacks"] \
                or res_a["failovers"]:
            raise AssertionError(f"disagg_cards (a): {res_a}")
        res_a.update(bitwise_rows=rows, first_import=watch.first_import,
                     colocated_wall_s=co_wall,
                     decode_card_peak=torch.cuda.max_memory_allocated(1))
        reqs_c = [(f"c-{i}", toks, n) for i, (toks, n) in enumerate(mix)]
        res_c, _ = split_pass("cards (c) concurrent", router, pf, dc, watch,
                              reqs_c, True, cfg.n_layers)
        worst, div, rows_c = compare_streams(
            {f"a-{i}": watch.completion(f"c-{i}") for i in range(len(mix))},
            ref, SERVE_REL_TOL, "disagg_cards (c)")
        res_c.update(vs_colocated_max_rel=worst, near_tie_divergences=div,
                     rows_compared=rows_c,
                     decode_card_peak=torch.cuda.max_memory_allocated(1))
    finally:
        stop()
    del watch, pf, dc, router, models
    free_cuda()
    return {"cards": cards, "a_sequential": res_a, "c_concurrent": res_c,
            "serve_roles_job": roles_job_on_a_fresh_step(gpus=1),
            "card": card}


def roles_job_on_a_fresh_step(gpus):
    """The split serve job (``serve_roles_job``) on a 1-layer step saved
    here from a fresh state (no train job), against an in-process
    replica's tokens on that step."""
    shutil.rmtree(JOB_ROOT, ignore_errors=True)
    os.makedirs(JOB_ROOT)
    try:
        ckpt_dir = os.path.join(JOB_ROOT, "ckpt")
        state = create_train_state(ckpt_model(JOB_LAYERS, SEED),
                                   adamw(TRAIN_LR))
        saver = ckpt.AsyncCheckpointer(ckpt_dir)
        saver.save(ckpt.encode_portable(state), step=1, block=True)
        saver.close()
        del state
        free_cuda()
        tokens, launches, _ = replica_reference(ckpt_dir, CKPT_VOCAB,
                                                JOB_LAYERS)
        return serve_roles_job(ckpt_dir, CKPT_VOCAB, JOB_LAYERS, tokens,
                               launches, gpus=gpus)
    finally:
        shutil.rmtree(JOB_ROOT, ignore_errors=True)


def job_cards_phase(card):
    """``--job-cards-only``: one worker a card through the port's TonY
    job, each with ``tony.worker.gpus=1``, training the train cell's
    model by NCCL data parallelism over 2 rows a card: every task saw one
    card, the census's at its offset, the cards disjoint; the first loss
    within 1e-2 of a one-card no-grad forward on the same global rows;
    the step times and each rank's peak."""
    cards = torch.cuda.device_count()
    if cards < 2:
        raise AssertionError("--job-cards-only needs two or more cards")
    shutil.rmtree(JOB_ROOT, ignore_errors=True)
    os.makedirs(JOB_ROOT)
    try:
        topo = gpu_census()
        batch = TRAIN_BATCH * cards
        data_path = os.path.join(JOB_ROOT, "tokens.npy")
        np.save(data_path, job_tokens(SEED, CKPT_EXAMPLES))
        workdir = os.path.join(JOB_ROOT, "cards")
        t_submit = time.time()
        rc = tony_cli(train_job_args(JOB_CARDS_LAYERS, JOB_CARDS_STEPS,
                                     data_path, batch, cards, 1,
                                     name="tony-jobs-cards"),
                      workdir, "submit.log")
        wall = time.time() - t_submit
        final = job_final(workdir)
        if rc != 0 or final["status"] != "SUCCEEDED":
            raise AssertionError(f"job_cards: the job ended {rc} "
                                 f"{final['status']}: {final['message']}\n"
                                 + job_tail(workdir, "submit.log"))
        results = job_results(workdir)
        if [r["rank"] for r in results] != list(range(cards)):
            raise AssertionError(f"job_cards: results of ranks "
                                 f"{[r['rank'] for r in results]}")
        for r in results:
            check_task_card("job_cards", r, topo, r["rank"])
        uuids = {r["uuid"] for r in results}
        if len(uuids) != cards:
            raise AssertionError(f"job_cards: the tasks shared cards: "
                                 f"{[r['uuid'] for r in results]}")
        ds = (Dataset.from_memmap({"x": data_path}, seed=SEED).shuffle()
              .repeat().batch(batch).with_ids())
        first = next(ds.iterator(ShardSpec(0, 1)))["x"]
        model = ckpt_model(JOB_CARDS_LAYERS, SEED)
        with torch.no_grad():
            x = torch.from_numpy(np.asarray(first)).cuda()
            ref = float(loop_loss(model, x))
        del model, x
        gc.collect()
        torch.cuda.empty_cache()
        got = results[0]["losses"][0]
        rel = abs(got - ref) / abs(ref)
        if not all(math.isfinite(v) for r in results for v in r["losses"]) \
                or rel > FUSED_FIRST_LOSS_REL:
            raise AssertionError(f"job_cards: first loss {got} vs one card "
                                 f"{ref} (rel {rel:.2e})")
        step_ms = [r["step_ms"] for r in results]
        out = {"cards": cards, "layers": JOB_CARDS_LAYERS,
               "steps": JOB_CARDS_STEPS, "global_batch": batch,
               "wall_s": wall,
               "submit_to_first_step_s": min(
                   r["first_step_at"] for r in results) - t_submit,
               "first_loss": got, "one_card_loss": ref, "rel": rel,
               "losses": results[0]["losses"], "step_ms": step_ms,
               "step_p50_ms": [steady_p50(s) for s in step_ms],
               "peak_bytes": [r["peak_bytes"] for r in results],
               "visible": [r["visible"] for r in results],
               "uuids": [r["uuid"] for r in results],
               "launches": [{n: r["launches"][n] for n in FLASH_NAMES}
                            for r in results], "card": card}
        log(f"  {cards} tasks on disjoint cards {out['visible']} "
            f"({out['uuids']}); first loss {got!r} vs one card {ref!r} "
            f"(rel {rel:.2e}); step p50 {out['step_p50_ms']} ms; peaks "
            f"{[round(b / 1e9, 2) for b in out['peak_bytes']]} GB")
        return out
    finally:
        shutil.rmtree(JOB_ROOT, ignore_errors=True)


def main() -> int:
    t_script = time.monotonic()
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False — this "
            "script needs a GPU")
        return 1
    cards_only = "--zero3-cards-only" in sys.argv[1:]
    depth_only = "--ckpt-depth-only" in sys.argv[1:]
    job_cards_only = "--job-cards-only" in sys.argv[1:]
    job_depth_only = "--job-depth-only" in sys.argv[1:]
    moe_cards_only = "--moe-cards-only" in sys.argv[1:]
    disagg_cards_only = "--disagg-cards-only" in sys.argv[1:]
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

    if depth_only:
        # An unsharded state whose whole staging does not fit, saved in
        # pieces and restored (a separate command: it writes ~42 GB).
        log("[ckpt_depth]")
        res = ckpt_depth_phase(card)
        print(json.dumps({"ckpt_depth": res}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if job_depth_only:
        # The train -> serve jobs at 8 layers (a separate command: the
        # two saves write 45.14 GB).
        log(f"[tony_jobs at {JOB_DEPTH_LAYERS} layers]")
        res = tony_jobs_phase(card, layers=JOB_DEPTH_LAYERS)
        print(json.dumps({"tony_jobs_depth": res}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if job_cards_only:
        # Data parallelism through a TonY job of the port, one worker a
        # card (a multi-card machine's measurement).
        log("[job_cards]")
        res = job_cards_phase(card)
        print(json.dumps({"job_cards": res}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if disagg_cards_only:
        # The prefill and the decode engine on two cards (a multi-card
        # machine's measurement).
        log("[disagg_cards]")
        res = disagg_cards_phase(card)
        print(json.dumps({"disagg_cards": res}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if moe_cards_only:
        # Expert parallelism across four cards (a multi-card machine's
        # measurement).
        log("[moe_cards]")
        res = moe_cards_phase(card)
        print(json.dumps({"moe_cards": res}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if cards_only:
        # The ZeRO-3 step across the cards and its one-card reference
        # alone (a multi-card machine's measurement).
        log("[train_zero3 (c)-(e)]")
        res = train_zero3_phase(card, None, None, cards_only=True)
        if res["across_cards"] is None:
            raise AssertionError("--zero3-cards-only needs two or more "
                                 "cards")
        print(json.dumps({"train_zero3": res}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

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
    lane_timed = {name: check_lane_shape(name, shape, p0, real, gen)
                  for name, shape, p0, real in LANE_SHAPES}
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
    model = engine.model
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 5a: the cold-start plane on the serve phase's model.
    log("[serve_coldstart]")
    serve_coldstart = serve_coldstart_phase(model)

    # Phase 5b: the routed lanes on the serve phase's model.
    log("[serve_prefix]")
    serve_prefix = serve_prefix_phase(model)
    log("[serve_spec]")
    serve_spec = serve_spec_phase(model)
    log("[serve_disagg]")
    t_phase = time.monotonic()
    serve_disagg = serve_disagg_phase(model, serve_results)
    log(f"  serve_disagg: {time.monotonic() - t_phase:.1f} s")
    log("[serve_kvtier]")
    t_phase = time.monotonic()
    serve_kvtier = serve_kvtier_phase(model)
    log(f"  serve_kvtier: {time.monotonic() - t_phase:.1f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  serve phases freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
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

    # Phase 7a: ZeRO-3 over the fsdp axis.
    log("[train_zero3]")
    train_zero3 = train_zero3_phase(card, train_fused, gen)
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 7b: mixtral-8x7b at full width, cut in depth.
    log("[train_moe]")
    train_moe = train_moe_phase(card)
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

    # Phase 10a: ResNet-50 with SGD saved, killed and resumed through
    # train_loop.
    log("[train_resnet_ckpt]")
    train_resnet_ckpt = train_resnet_ckpt_phase(card)
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
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 13a: the train -> serve loop as TonY jobs of the port's own
    # control plane.
    log("[tony_jobs]")
    t_phase = time.monotonic()
    tony_jobs = tony_jobs_phase(card)
    log(f"  tony_jobs: {time.monotonic() - t_phase:.1f} s")

    entry = {
        "name": "flash_decode", "route": "cuda",
        "source": "tony_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "tony_tpu/ops/attention.py:1231",
        "launches": serve_launches["flash_decode"]
        + serve_coldstart["flash_decode_launches"]
        + serve_prefix["flash_decode_launches"]
        + serve_spec["flash_decode_launches"]
        + serve_disagg["flash_decode_launches"]
        + serve_kvtier["flash_decode_launches"]
        + serve_replica["rpc"]["flash_decode_launches"]
        + tony_jobs["serve"]["flash_decode_launches"]
        + tony_jobs["serve_roles"]["flash_decode_launches"],
        # serve_coldstart's launches are the replays' (each captured
        # launch times its graph's replays).
        "launches_by_path": {
            "serve": serve_launches["flash_decode"],
            "serve_coldstart_replayed":
                serve_coldstart["flash_decode_launches"],
            "serve_prefix": serve_prefix["flash_decode_launches"],
            "serve_spec": serve_spec["flash_decode_launches"],
            "serve_disagg": serve_disagg["flash_decode_launches"],
            "serve_kvtier": serve_kvtier["flash_decode_launches"],
            "serve_replica": serve_replica["rpc"]["flash_decode_launches"],
            "tony_jobs_serve": tony_jobs["serve"]["flash_decode_launches"],
            "tony_jobs_serve_roles":
                tony_jobs["serve_roles"]["flash_decode_launches"]},
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
        "lane_shapes": lane_timed,
        "max_abs_err_all_cases": max(errs + [
            r["max_abs_err"] for r in lane_timed.values()]),
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
            + train_zero3["timed"]["launches"][name]
            + train_moe["launches"][name]
            + train_loop_res["launches"][name]
            + train_ckpt["launches_after_restore"][name]
            + tony_jobs["train"]["launches"][name],
            "launches_by_path": {
                "train": train_launches[name],
                "train_zero3": train_zero3["timed"]["launches"][name],
                "train_moe": train_moe["launches"][name],
                "train_loop": train_loop_res["launches"][name],
                "train_ckpt_after_restore":
                    train_ckpt["launches_after_restore"][name],
                "tony_jobs_train": tony_jobs["train"]["launches"][name]},
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
        + train_zero3["timed"]["launches"]["fused_bucket_update"]
        + train_moe["launches"]["fused_bucket_update"]
        + train_ckpt["small"]["launches"],
        "launches_by_path": {
            "train_fused": train_fused["launches"]["fused_bucket_update"],
            "train_zero3":
                train_zero3["timed"]["launches"]["fused_bucket_update"],
            "train_moe": train_moe["launches"]["fused_bucket_update"],
            "train_ckpt_after_restore": train_ckpt["small"]["launches"]},
        "zero3_shards": train_zero3["shards"],
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
    int8_launches = {
        "serve_quant": quant_launches["int8_matmul"],
        "serve_quant_replayed":
            serve_quant["replay_vs_eager"]["replayed_launches"]["int8_matmul"],
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
            "launches": train_resnet["launches"][name]
            + train_resnet_ckpt["launches_after_restore"][name],
            "launches_by_path": {
                "train_resnet": train_resnet["launches"][name],
                "train_resnet_ckpt_after_restore":
                    train_resnet_ckpt["launches_after_restore"][name]},
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
    print(json.dumps({"train_zero3": train_zero3}), flush=True)
    print(json.dumps({"train_moe": train_moe}), flush=True)
    print(json.dumps({"quant": {"int8_shapes": int8,
                                "serve_quant": serve_quant,
                                "train_quant": train_quant}}), flush=True)
    print(json.dumps({"bn_shapes": bn_kernels}), flush=True)
    print(json.dumps({"resnet": train_resnet}), flush=True)
    print(json.dumps({"train_resnet_ckpt": train_resnet_ckpt}), flush=True)
    print(json.dumps({"train_loop": train_loop_res}), flush=True)
    print(json.dumps({"train_ckpt": train_ckpt}), flush=True)
    print(json.dumps({"serve_replica": serve_replica}), flush=True)
    print(json.dumps({"tony_jobs": tony_jobs}), flush=True)
    serve_prefix["card"] = card
    serve_spec["card"] = card
    serve_disagg["card"] = card
    print(json.dumps({"serve_prefix": serve_prefix}), flush=True)
    print(json.dumps({"serve_spec": serve_spec}), flush=True)
    print(json.dumps({"serve_disagg": serve_disagg}), flush=True)
    serve_kvtier["card"] = card
    print(json.dumps({"serve_kvtier": serve_kvtier}), flush=True)
    serve_coldstart["card"] = card
    print(json.dumps({"serve_coldstart": serve_coldstart}), flush=True)
    log(f"[done] {time.monotonic() - t_script:.1f} s")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
