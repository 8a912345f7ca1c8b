"""Time the port's int8 GEMM (kernel row 15) on the card.

Rebuilds ``int8_matmul.cu`` and prints what ``ptxas`` reports for each
kernel (registers, spills; the wgmma kernel's ring is as deep as shared
memory holds for its tile, ``Tile::STAGES`` in the source). Then, at the
path shapes of ``chip_smoke.py`` (``INT8_SHAPES``: the quant lane's
decode, prefill, train, ``lm_head`` and b=4 decode projections of
llama2-7b), it checks the kernel against the plain version
(``torch.equal``, as planned and at forced split counts) and times it
as planned: with CUDA events around back-to-back calls
(``ms``, as ``chip_smoke.py`` times), on the card alone (a CUDA graph of
calls replayed, ``device_ms``), with a cold L2 where M <= 512 (the weight
rotated over copies of more than 50 MB, ``cold_device_ms``), and the
host's µs a call, beside the bound and ``torch._int_mm`` + the rescale.

``--sweep`` times every tile x split count on the card
alone (with a cold L2 where M <= 512) and prints the fastest: how the
plan of ``ops/quant.py::_int8_plan`` was chosen.

With ``--parent DIR``, DIR holds a checkout of an earlier commit (for
example ``git archive HEAD | tar -x -C build/parent``; ``build/`` is
gitignored). Its ``int8_matmul.cu`` is built beside this one, and at each
shape the two are timed in turns (parent, change, change, parent), back
to back and on the card alone, the two wrappers' host µs a call read the
same way (the parent's ``ops/quant.py`` loaded as a module of its own),
and the two outputs held ``torch.equal``; first, one line breaks the
host's µs a call down (wrappers, C launchers, plan lookup) at
decode_qkvo. One JSON line per shape, then the card's name and power
limit::

    python exp/port_int8_bench.py [--parent build/parent] [--sweep]
                                  [--shapes decode_qkvo train_down ...]

It needs one NVIDIA GPU; it exits non-zero without one.
"""

import argparse
import ctypes
import functools
import importlib.util
import itertools
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from tony_tpu_torch.ops import _build  # noqa: E402
from tony_tpu_torch.ops import quant as tq  # noqa: E402

PATH_SHAPES = [s for s in cs.INT8_SHAPES if not s[0].startswith("ragged")]
SWEEP_SPLITS = (1, 2, 3, 4, 5, 6, 8, 12)


def ptxas_report(log):
    """Each entry function of int8_matmul.cu with its registers and
    spills."""
    return [line.strip() for line in str(log).splitlines()
            if any(w in line for w in ("entry function", "registers",
                                       "spill"))]


def parent_module(parent):
    """The parent's int8_matmul.cu built into build/kernels and its
    ops/quant.py loaded as a module of its own, launching that library."""
    src = os.path.join(parent, "tony_tpu_torch/ops/csrc/int8_matmul.cu")
    out = _build.BUILD_DIR / "parent_int8_matmul.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.int8_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_int64] * 3
        + [ctypes.c_void_p])
    lib.int8_matmul_launch.restype = ctypes.c_int
    lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
    lib.int8_matmul_error_string.restype = ctypes.c_char_p
    spec = importlib.util.spec_from_file_location(
        "parent_quant", os.path.join(parent, "tony_tpu_torch/ops/quant.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # its dataclasses look it up
    spec.loader.exec_module(mod)
    mod._lib = lambda: lib
    return mod


def sweep(name, xq, wq, sx, sw, copies, ref):
    """Device ms (cold L2 where M <= 512) of every tile x splits that
    plans differently, fastest first."""
    m, k = xq.shape
    n = wq.shape[0]
    sms = tq._sms(torch.cuda.current_device())
    small = m <= tq._SMALL_M
    seen, rows = set(), []
    for tile, splits in itertools.product(tq._TILES, SWEEP_SPLITS):
        if not small and splits > 2:
            continue
        plan = tq._int8_plan(m, n, k, sms, k, k, True, splits, tile)
        if plan in seen:
            continue
        seen.add(plan)
        call = functools.partial(tq._int8_matmul_cuda, splits=splits,
                                 tile=tile)
        if not torch.equal(call(xq, wq, sx, sw), ref):
            raise AssertionError(f"{name}: {plan} differs from plain")
        if small:
            ms = cs.cuda_graph_ms(cs.rotating(call, xq, copies, sx, sw),
                                  reps=2 * len(copies), iters=10)
        else:
            ms = cs.cuda_graph_ms(lambda: call(xq, wq, sx, sw), reps=5,
                                  iters=5)
        rows.append((ms, tile, plan.splits, plan.units))
    rows.sort()
    return [{"device_ms": r[0], "tile": r[1], "splits": r[2],
             "units": r[3]} for r in rows]


def host_parts(old, gen):
    """Host µs a call of each part of the two wrappers at decode_qkvo,
    in turns (parent, change, change, parent) where both have the part:
    the whole wrapper, the C launcher alone with its arguments ready, and
    the new wrapper's plan lookup."""
    m, k, n = 256, 4096, 4096
    xq, wq, sx, sw = cs.int8_inputs(m, k, n, gen)
    out = torch.empty((m, n), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.cuda.current_device()
    plan = tq._int8_plan(m, n, k, tq._sms(dev), k, k, True)
    new_lib, old_lib = tq._lib(), old._lib()
    args = (xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            out.data_ptr())

    def new_launch():
        new_lib.int8_matmul_wgmma_launch(
            *args, None, m, n, k, k, k, tq._TILE_CODE[plan.tile],
            plan.splits, plan.cps, plan.grid, stream)

    def old_launch():
        old_lib.int8_matmul_launch(*args, m, n, k, k, k, n, stream)
    wrap_new = lambda: tq._int8_matmul_cuda(xq, wq, sx, sw)  # noqa: E731
    wrap_old = lambda: old._int8_matmul_cuda(xq, wq, sx, sw)  # noqa: E731
    return {
        "wrapper_parent_change_change_parent": [
            cs.host_us(f) for f in (wrap_old, wrap_new, wrap_new, wrap_old)],
        "launcher_parent_change_change_parent": [
            cs.host_us(f) for f in (old_launch, new_launch, new_launch,
                                    old_launch)],
        "plan_lookup": cs.host_us(lambda: tq._int8_plan(
            m, n, k, tq._sms(dev), k, k, True, 1, None)),
        "current_stream": cs.host_us(
            lambda: torch.cuda.current_stream(xq.device).cuda_stream),
        "empty_out": cs.host_us(lambda: torch.empty(
            (m, n), dtype=torch.float32, device=xq.device)),
    }


def bench(name, m, k, n, gen, old, do_sweep, iters):
    xq, wq, sx, sw = cs.int8_inputs(m, k, n, gen)
    dev = torch.cuda.current_device()
    plan = tq._int8_plan(m, n, k, tq._sms(dev), k, k, True)
    call = lambda: tq.int8_matmul(xq, wq, sx, sw)  # noqa: E731
    out = call()
    ref = tq._int8_matmul_plain(xq, wq, sx, sw)
    equal = torch.equal(out, ref) and all(
        torch.equal(tq._int8_matmul_cuda(xq, wq, sx, sw, splits=s), ref)
        for s in cs.INT8_SPLITS)
    res = {"shape": name, "m_k_n": [m, k, n], "plan": plan._asdict(),
           "equal_to_plain_at_every_split": equal,
           "ms": cs.cuda_ms(call, iters=iters),
           "device_ms": cs.cuda_graph_ms(call),
           "host_us": cs.host_us(call),
           "library_ms": cs.cuda_ms(
               lambda: cs.int_mm_rescale(xq, wq, sx, sw), iters=iters)
           if m > 16 else None}
    res["bound_ms"], res["bound_by"] = cs.int8_bound(m, k, n)
    res["bound_share"] = res["bound_ms"] / res["device_ms"]
    copies = cs.weight_copies(wq, gen) if m <= tq._SMALL_M else None
    if copies is not None:
        res["cold_device_ms"] = cs.cuda_graph_ms(
            cs.rotating(tq.int8_matmul, xq, copies, sx, sw),
            reps=2 * len(copies))
        res["bound_share_cold"] = res["bound_ms"] / res["cold_device_ms"]
    if old is not None:
        parent = lambda: old._int8_matmul_cuda(xq, wq, sx, sw)  # noqa: E731
        res["parent_equal"] = torch.equal(parent(), out)
        res["turns_parent_change_change_parent_ms"] = [
            cs.cuda_ms(f, iters=iters) for f in (parent, call, call, parent)]
        res["turns_parent_change_change_parent_device_ms"] = [
            cs.cuda_graph_ms(f) for f in (parent, call, call, parent)]
        res["host_us_parent_change_change_parent"] = [
            cs.host_us(f) for f in (parent, call, call, parent)]
    if do_sweep:
        res["sweep"] = sweep(name, xq, wq, sx, sw, copies, ref)[:8]
    if not (equal and res.get("parent_equal", True)):
        raise AssertionError(json.dumps(res))
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--shapes", nargs="*", default=None)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = _build._target("int8_matmul")
    if target.exists():
        target.unlink()                   # rebuild, for ptxas's report
    _build.load(["int8_matmul"])
    for line in ptxas_report(_build.build_info["int8_matmul"]["log"]):
        print(line, flush=True)
    old = parent_module(args.parent) if args.parent else None
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    if old is not None:
        print(json.dumps({"host_us": host_parts(old, gen)}), flush=True)
    for name, m, k, n in PATH_SHAPES:
        if args.shapes and name not in args.shapes:
            continue
        iters = 10 if m * n * k > 1e11 else args.iters
        print(json.dumps(bench(name, m, k, n, gen, old, args.sweep, iters)),
              flush=True)
        torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
