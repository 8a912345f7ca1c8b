"""Chip smoke test of the PyTorch/CUDA port (``tony_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase's failure is
caught):

1. device — require CUDA, print ``nvidia-smi`` name and power limit;
2. build — compile every kernel of the serving path from
   ``tony_tpu_torch/ops/csrc`` with nvcc (sm_90a), print the build time;
3. kernels — hold each kernel against its plain PyTorch version on the
   card at the serving path's shapes (bf16 and f32, ragged positions,
   GQA), check row independence with ``torch.equal``, and time kernel,
   plain version, the ``scaled_dot_product_attention`` yardstick and the
   bytes/operations bound;
4. serve — full-width llama2-7b (random bf16 weights made on the card
   from a seed) behind ``ServeEngine``/``EngineFront``: 16 requests from
   16 threads; every request completes with its token count, the kernel
   ran 32 times per forward, and two requests' streamed decode logits
   match the engine's own full-prefill logits within the stated
   tolerance with greedy tokens equal;
5. profile — device time by kernel over three b=16 decode steps
   (torch.profiler), and the device's idle share of the step;
6. report — a ``{"kernels": [...]}`` line, a ``{"serve": {...}}`` line,
   the card line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tony_tpu_torch.models import get_model  # noqa: E402
from tony_tpu_torch.ops import LAUNCHES, _build  # noqa: E402
from tony_tpu_torch.ops import attention as attn  # noqa: E402
from tony_tpu_torch.serve import EngineFront, ServeEngine  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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
    if time_it:
        res["ms"] = cuda_ms(lambda: attn.flash_decode(q, k, v, pos))
        res["plain_ms"] = cuda_ms(
            lambda: attn._decode_plain(q, k, v, pos, scale, 128), iters=5)
        res["library_ms"] = cuda_ms(sdpa_fn(q, k, v, pos))
        res["bound_ms"], res["bound_by"] = bound(q, k, pos)
        log(f"    kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} "
            f"ms, sdpa {res['library_ms']:.4f} ms, bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res


def check_row_independence(dtype, gen):
    """The same rows in a t=16 launch and inside a t=64 launch must be
    bit-equal (another tile, other neighbours, another key-loop end)."""
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


def serve_phase(gen_seed: int):
    torch.manual_seed(gen_seed)
    t0 = time.monotonic()
    model = get_model("llama2-7b", device="cuda", seed=gen_seed)
    torch.cuda.synchronize()
    cfg = model.cfg
    log(f"  llama2-7b built on the card in {time.monotonic() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e9:.2f} B "
        f"params, {torch.cuda.memory_allocated() / 2**30:.1f} GiB)")
    engine = ServeEngine(model, ctx_max=2048, block_size=16, q_block=16,
                         max_running=16, decode_buckets=(4, 16),
                         keep_logits=True)
    front = EngineFront(engine)
    # Warm-up (cuBLAS handles, allocator): one short request, outside
    # the counted window.
    front.generate([1, 2, 3, 4], 2)
    rng = np.random.default_rng(gen_seed)
    reqs = [(rng.integers(0, cfg.vocab, int(rng.integers(16, 513))).tolist(),
             int(rng.integers(16, 65))) for _ in range(16)]
    results = [None] * len(reqs)

    def worker(i):
        results[i] = front.generate(*reqs[i])

    torch.cuda.reset_peak_memory_stats()
    forwards0 = engine.forwards
    LAUNCHES["flash_decode"] = 0
    t_start = time.monotonic()
    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(reqs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.monotonic() - t_start
    launches = LAUNCHES["flash_decode"]
    forwards = engine.forwards - forwards0
    if any(th.is_alive() for th in threads):
        raise AssertionError("serve phase did not finish")
    for (toks, max_new), c in zip(reqs, results):
        if c is None or len(c.tokens) != max_new:
            raise AssertionError(f"request did not complete with "
                                 f"{max_new} tokens: {c}")
    if launches != cfg.n_layers * forwards or forwards == 0:
        raise AssertionError(f"flash_decode launches {launches} != "
                             f"{cfg.n_layers} x {forwards} forwards")
    log(f"  16 requests done in {wall:.2f} s: {forwards} forwards, "
        f"{launches} flash_decode launches")
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated()
    # Decode vs the engine's own full prefill, for the shortest and the
    # longest prompt.
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
                if top2[1] - top2[0] > SERVE_REL_TOL * scale:
                    raise AssertionError(
                        f"request {c.rid}: greedy token at {p + j} "
                        f"differs from the full-prefill argmax")
                near_ties += 1
            if diff > SERVE_REL_TOL * scale:
                raise AssertionError(
                    f"request {c.rid}: decode logits at {p - 1 + j} off "
                    f"the full prefill by {diff} > {SERVE_REL_TOL}·{scale}")
    log(f"  decode vs full prefill: {rows} rows, max|Δ|/max|ref| = "
        f"{worst:.3e} (tol {SERVE_REL_TOL}), near-tie token flips "
        f"{near_ties}")
    gen_tokens = sum(len(c.tokens) for c in results)
    serve = {
        "model": "llama2-7b", "requests": len(reqs),
        "prompt_tokens": sum(len(t) for t, _ in reqs),
        "generated_tokens": gen_tokens, "wall_s": wall,
        "decode_tokens_per_s": gen_tokens / wall,
        "ttft_p50_ms": stats["ttft_p50_ms"],
        "step_p50_ms": stats["step_p50_ms"],
        "forwards": forwards, "flash_decode_launches": launches,
        "decode_vs_prefill_max_rel": worst,
        "decode_vs_prefill_rows": rows, "near_tie_flips": near_ties,
        "max_memory_allocated": peak,
    }
    return serve, launches, engine


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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "top_kernels_ms_per_step": [[k[:80], v] for k, v in top]}


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
    _build.load(["flash_decode"])
    log(f"[build] {time.monotonic() - t0:.1f} s")
    for name, info in _build.build_info.items():
        log(f"  {name}: nvcc {info['seconds']:.1f} s")
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")

    # Phase 3: kernels against their plain versions.
    log("[kernels]")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    decode = (16, 32, 32, 16, 128, 2048)
    gqa = (16, 32, 8, 16, 128, 2048)
    prefill = (1, 32, 32, 512, 128, 2048)
    dec = check_kernel("decode", decode, torch.bfloat16, gen, time_it=True)
    pre = check_kernel("prefill", prefill, torch.bfloat16, gen,
                       prefill=True, time_it=True)
    errs = [dec["max_abs_err"], pre["max_abs_err"]]
    for name, shape, pf in (("decode", decode, False), ("gqa", gqa, False),
                            ("prefill", prefill, True)):
        errs.append(check_kernel(name, shape, torch.float32, gen,
                                 prefill=pf)["max_abs_err"])
    errs.append(check_kernel("gqa", gqa, torch.bfloat16, gen)["max_abs_err"])
    check_row_independence(torch.bfloat16, gen)
    check_row_independence(torch.float32, gen)

    # Phase 4: the main path.
    log("[serve]")
    serve, launches, engine = serve_phase(SEED)
    log("[profile]")
    prof = profile_decode(engine, engine.model.cfg.vocab)
    log(f"  {json.dumps(prof) if prof else 'no device events traced'}")
    serve["decode_profile"] = prof

    entry = {
        "name": "flash_decode", "route": "cuda",
        "source": "tony_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "tony_tpu/ops/attention.py:1231",
        "launches": launches, "max_abs_err": dec["max_abs_err"],
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        # Aliases of "ms" and "max_abs_err".
        "kernel_ms": dec["ms"], "max_abs_diff": dec["max_abs_err"],
        "shape": "decode bf16 b=16 h=32 hkv=32 t=16 d=128 ctx=2048",
        "prefill": dict(pre, shape="bf16 b=1 h=32 t=512 d=128 ctx=2048"),
        "max_abs_err_all_cases": max(errs),
    }
    serve["card"] = card
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"serve": serve}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
