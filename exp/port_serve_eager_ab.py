"""Time the port's default serve path (the eager engine: no AOT cache, no
``warm()``) of two checkouts in turns, on the card.

Each root given to ``--roots`` runs in a fresh Python process of its own,
in the order given, importing that checkout's ``tony_tpu_torch``. It builds
full-width llama2-7b (bf16 storage, random weights from ``--seed``) on the
card and an engine of ``chip_smoke.py``'s serving geometry (ctx 2048,
blocks of 16, q_block 16, decode buckets 4 and 16, max_running 16), and
measures, with no profiler on:

* ``mix``: the 16 requests of ``chip_smoke.py``'s serve mix (prompts of
  16-512 tokens, 16-64 new tokens each), submitted at once and run dry on
  one thread; wall seconds and generated tokens/s, ``--mix-reps`` times;
* ``steps``: 16 sequences of 256-token prompts join (untimed), then
  ``--steps`` pure b=16 decode steps, each timed on the wall clock; the
  p50, ``--step-reps`` times;
* ``replay`` (a checkout whose engine has ``warm()``): the same steps on
  a second engine that warmed its step family into CUDA graphs.

Then three b=16 decode steps run under ``torch.profiler``: the device's
busy ms a step, the kernels launched a step, and the host's self time a
step by PyTorch op (the ops that cost the most host time first). Last,
``steps`` once more, unprofiled, in the process that has now run the
profiler (``steps_after_profiler_p50_ms``).

One JSON line per root, then the card's name and power limit::

    git archive HEAD | tar -x -C build/parent      # build/ is gitignored
    python exp/port_serve_eager_ab.py --roots build/parent . . build/parent

It needs one NVIDIA GPU; it exits non-zero without one.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = dict(ctx_max=2048, block_size=16, q_block=16, max_running=16,
              decode_buckets=(4, 16), keep_logits=True)


def serve_mix(seed, vocab):
    """chip_smoke.py's serve mix: 16 seeded requests."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(16, 513))).tolist(),
             int(rng.integers(16, 65))) for _ in range(16)]


def join16(engine, Request, vocab, seed, tag, new_tokens):
    """16 sequences of 256-token prompts joined and prefilled, one decode
    step run."""
    rng = np.random.default_rng(seed + 1)
    for i in range(16):
        engine.submit(Request(rid=f"{tag}-{i}",
                              tokens=rng.integers(0, vocab, 256).tolist(),
                              max_new_tokens=new_tokens))
    engine.step()


def child(root, args):
    sys.path.insert(0, root)
    import torch

    from tony_tpu_torch.models import get_model
    from tony_tpu_torch.serve import Request, ServeEngine

    t0 = time.monotonic()
    model = get_model("llama2-7b", device="cuda", seed=args.seed,
                      param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    vocab = model.cfg.vocab
    engine = ServeEngine(model, **ENGINE)
    # Warm-up (the kernel library, cuBLAS handles, the allocator).
    engine.submit(Request(rid="warm", tokens=[1, 2, 3, 4], max_new_tokens=2))
    engine.run()
    reqs = serve_mix(args.seed, vocab)
    mix_s, mix_tps = [], []
    for rep in range(args.mix_reps):
        for i, (toks, n) in enumerate(reqs):
            engine.submit(Request(rid=f"mix{rep}-{i}", tokens=toks,
                                  max_new_tokens=n))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        mix_s.append(wall)
        mix_tps.append(sum(len(c.tokens) for c in done) / wall)

    def steps(tag, eng=engine):
        join16(eng, Request, vocab, args.seed, tag, args.steps + 2)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.steps):
            t0 = time.monotonic()
            eng.step()
            times.append(1e3 * (time.monotonic() - t0))
        eng.run()
        return times

    step_ms = [steps(f"steps{rep}") for rep in range(args.step_reps)]
    step_p50 = [float(np.median(times)) for times in step_ms]
    replay_p50 = None
    if hasattr(ServeEngine, "warm"):
        graphs = ServeEngine(model, **ENGINE)
        graphs.warm()
        replay_p50 = [float(np.median(steps(f"replay{rep}", graphs)))
                      for rep in range(args.step_reps)]
        del graphs
    join16(engine, Request, vocab, args.seed, "prof", 5)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(3):
            engine.step()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.monotonic() - t0) / 3
    engine.run()
    busy, kernels, host = 0.0, 0, {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == \
                torch.autograd.DeviceType.CUDA:
            busy += getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)) / 1e3
            kernels += e.count
        else:
            host[e.key] = (e.self_cpu_time_total / 1e3 / 3, e.count / 3)
    top = sorted(host.items(), key=lambda kv: -kv[1][0])[:args.top]
    after = steps("after")
    print(json.dumps({
        "root": root, "model_build_s": build_s,
        "mix_s": mix_s, "mix_tokens_per_s": mix_tps,
        "step_p50_ms": step_p50, "step_ms": step_ms,
        "replay_step_p50_ms": replay_p50,
        "steps_after_profiler_p50_ms": float(np.median(after)),
        "profiled": {"step_wall_ms": prof_ms, "device_busy_ms": busy / 3,
                     "kernels_per_step": kernels / 3,
                     "host_ms_per_step_by_op": [[k, ms, n]
                                                for k, (ms, n) in top]},
    }), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=[HERE])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mix-reps", type=int, default=3)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--step-reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    rc = 0
    for root in args.roots:
        root = os.path.abspath(root)
        cmd = [sys.executable, os.path.abspath(__file__), "--child", root,
               "--seed", str(args.seed), "--mix-reps", str(args.mix_reps),
               "--steps", str(args.steps), "--step-reps",
               str(args.step_reps), "--top", str(args.top)]
        rc |= subprocess.run(cmd, cwd=root).returncode
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main())
