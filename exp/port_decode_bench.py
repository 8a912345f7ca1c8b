"""Time the port's flash-decode kernel (kernel row 9) on the card.

Rebuilds ``flash_decode.cu`` and prints what ``ptxas`` reports for the
tensor-core kernel and the combine kernel (registers, spills). Then, at the
serving shapes of ``chip_smoke.py`` (decode b=16, the engine's b=4 bucket,
b=1, GQA hkv=8, prefill t=512; d=128, ctx=2048) it checks the bf16 kernel
against the plain version, checks that forced split counts give
``torch.equal`` outputs, and times it at the planned split count and at
each forced one beside the bound and ``scaled_dot_product_attention``:
with CUDA events around back-to-back calls (``ms``, as ``chip_smoke.py``
times), and as device time alone, from a CUDA graph of ten calls
replayed (``graph_ms``), with the host's µs per call beside it.

With ``--parent DIR``, DIR holds a checkout of an earlier commit (for
example ``git archive HEAD | tar -x -C build/parent``; ``build/`` is
gitignored). Its ``flash_decode.cu`` is built beside this one, and at each
shape the two bf16 kernels are timed in turns (parent, change, change,
parent), the two wrappers' host time a call is read the same way (the
parent's ``ops/attention.py`` loaded as a module of its own), and the two
f32 kernels are held ``torch.equal``. One JSON line
per shape, then the card's name and power limit::

    python exp/port_decode_bench.py [--parent build/parent] [--splits 1 2 4 8]

It needs one NVIDIA GPU; it exits non-zero without one.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from tony_tpu_torch.ops import _build  # noqa: E402
from tony_tpu_torch.ops import attention as attn  # noqa: E402

# name, (b, h, hkv, t, d, ctx), prefill
SHAPES = [("decode", (16, 32, 32, 16, 128, 2048), False),
          ("b4", (4, 32, 32, 16, 128, 2048), False),
          ("b1", (1, 32, 32, 16, 128, 2048), False),
          ("gqa", (16, 32, 8, 16, 128, 2048), False),
          ("prefill", (1, 32, 32, 512, 128, 2048), True)]


def ptxas_report(log):
    """Each entry function of flash_decode.cu with its registers and
    spills."""
    out = []
    for line in str(log).splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            out.append(line.strip())
    return out


def parent_lib(parent):
    """The parent's flash_decode.cu built into build/kernels (its C entry
    takes the 18 strides as separate arguments)."""
    src = os.path.join(parent, "tony_tpu_torch/ops/csrc/flash_decode.cu")
    out = _build.BUILD_DIR / "parent_flash_decode.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.flash_decode_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_float] + [ctypes.c_int64] * 18 + [ctypes.c_void_p])
    lib.flash_decode_launch.restype = ctypes.c_int
    return lib


def parent_call(lib, q, k, v, pos, scale):
    b, h, t, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    code = {torch.float32: 0, torch.bfloat16: 1}[q.dtype]
    rc = lib.flash_decode_launch(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, h, k.shape[1], t, d, k.shape[2], float(scale),
        *q.stride(), *k.stride(), *v.stride(), *pos.stride(), *out.stride(),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"parent flash_decode launch failed: {rc}")
    return out


def graph_ms(fn, reps=10, iters=20):
    """Device ms of one ``fn()`` with no host time in it: ``reps`` calls
    captured in a CUDA graph, the graph replayed ``iters`` times between
    two events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def host_us(fn, calls=200):
    """Host µs a call: ``calls`` calls enqueued back to back, then one
    synchronize (the host's time where it, not the card, is slower)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def parent_wrapper(parent, lib):
    """The parent's ops/attention.py as a module of its own, its
    ``_decode_cuda`` launching the parent's library: its host time per
    call is the yardstick of this wrapper's."""
    spec = importlib.util.spec_from_file_location(
        "parent_attention",
        os.path.join(parent, "tony_tpu_torch/ops/attention.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib.flash_decode_error_string.argtypes = [ctypes.c_int]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    mod._lib = lambda: lib
    return mod


def bench(name, shape, prefill, gen, splits, old, iters):
    b, h, hkv, t, d, ctx = shape
    q, k, v, pos = cs.decode_inputs(b, h, hkv, t, d, ctx, torch.bfloat16,
                                    gen, prefill=prefill)
    scale = d ** -0.5
    dev = torch.cuda.current_device()
    plan = attn._decode_plan_on(dev, b, h, hkv, t, d, ctx)
    new = lambda s=None: attn._decode_cuda(q, k, v, pos, scale, splits=s)
    out = new()
    ref = attn._decode_plain(q, k, v, pos, scale, 128)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = cs.output_tol(ref, torch.bfloat16)
    res = {"shape": name, "b_h_hkv_t_d_ctx": shape,
           "plan": plan._asdict(), "max_abs_err": err, "tol": tol,
           "ms": cs.cuda_ms(new, iters=iters),
           "library_ms": cs.cuda_ms(cs.sdpa_fn(q, k, v, pos), iters=iters)}
    res["bound_ms"], res["bound_by"] = cs.bound(q, k, pos)
    res["graph_ms"] = graph_ms(new)
    res["library_graph_ms"] = graph_ms(cs.sdpa_fn(q, k, v, pos))
    res["host_us_per_call"] = host_us(new)
    res["splits_graph_ms"] = {s: graph_ms(lambda: new(s)) for s in splits}
    res["splits_ms"], equal = {}, True
    for s in splits:
        equal &= torch.equal(new(s), out)
        res["splits_ms"][s] = cs.cuda_ms(lambda: new(s), iters=iters)
    res["splits_equal"] = equal
    if old is not None:
        turns = [cs.cuda_ms(lambda: parent_call(old, q, k, v, pos, scale),
                            iters=iters),
                 cs.cuda_ms(new, iters=iters), cs.cuda_ms(new, iters=iters),
                 cs.cuda_ms(lambda: parent_call(old, q, k, v, pos, scale),
                            iters=iters)]
        res["turns_parent_change_change_parent_ms"] = turns
        wrap = old.parent_wrapper
        res["host_us_per_call_parent_change_change_parent"] = [
            host_us(lambda: wrap._decode_cuda(q, k, v, pos, scale)),
            host_us(new), host_us(new),
            host_us(lambda: wrap._decode_cuda(q, k, v, pos, scale))]
        f32 = [x.float() for x in (q, k, v)]
        res["f32_equal_to_parent"] = torch.equal(
            attn._decode_cuda(*f32, pos, scale),
            parent_call(old, *f32, pos, scale))
    if not (err <= tol and equal and res.get("f32_equal_to_parent", True)):
        raise AssertionError(json.dumps(res))
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--splits", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = _build._target("flash_decode")
    if target.exists():
        target.unlink()                   # rebuild, for ptxas's report
    _build.load(["flash_decode"])
    for line in ptxas_report(_build.build_info["flash_decode"]["log"]):
        print(line, flush=True)
    old = parent_lib(args.parent) if args.parent else None
    if old is not None:
        old.parent_wrapper = parent_wrapper(args.parent, old)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for name, shape, prefill in SHAPES:
        print(json.dumps(bench(name, shape, prefill, gen, args.splits, old,
                               args.iters)), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
