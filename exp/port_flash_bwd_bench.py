"""Time the flash-attention backward kernels of the PyTorch port on the card.

Builds ``flash_attention.cu``, prints what ``ptxas`` reports for each
backward kernel (registers, shared memory, spills), then, at the timed
shapes of ``chip_smoke.py``'s ``FLASH_SHAPES`` (rows 7, 8, 6 and 5 of
the kernel table), runs the bf16 backward once against its plain version
(max|kernel - plain| for dQ, dK and dV), and times the dQ kernel and the
dK/dV kernel alone beside their bounds and SDPA's backward. One JSON line
per shape, then the card's name and power limit::

    python exp/port_flash_bwd_bench.py                 # all timed shapes
    python exp/port_flash_bwd_bench.py --shapes packed

It needs one NVIDIA GPU; it exits non-zero without one.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from tony_tpu_torch.ops import _build  # noqa: E402
from tony_tpu_torch.ops import attention as attn  # noqa: E402


def bench(shape, gen, iters):
    name, b, h, hkv, t, tk, d, causal, packed, rows, _ = shape
    dtype = torch.bfloat16
    q, k, v, do = cs.flash_inputs(b, h, hkv, t, tk, d, packed, dtype, gen)
    scale = d ** -0.5
    out, lse = attn._flash_fwd_cuda(q, k, v, causal, scale)
    dq, dk, dv = attn._flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)
    ref = cs.plain_bwd(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    errs = {key: float((got.float() - r.float()).abs().max())
            for key, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
    tols = {key: cs.output_tol(r, dtype)
            for key, r in zip(("dq", "dk", "dv"), ref)}
    del ref
    run_dq, run_dkv = cs.bwd_launchers(q, k, v, out, lse, do, causal, scale)
    bounds = cs.flash_bounds(b, h, hkv, t, tk, d, causal, dtype)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    kept = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, enable_gqa=hkv != h)
    sdpa_bwd = cs.cuda_ms(lambda: torch.autograd.grad(
        kept, (qs, ks, vs), do, retain_graph=True), iters=iters, warmup=2)
    res = {"shape": name, "rows": rows, "max_abs_err": errs, "tol": tols,
           "within_tol": all(errs[key] <= tols[key] for key in errs),
           "sdpa_bwd_ms": sdpa_bwd}
    for key, fn in (("flash_attention_bwd_dq", run_dq),
                    ("flash_attention_bwd_dkv", run_dkv)):
        ms = cs.cuda_ms(fn, iters=iters, warmup=2)
        work = 2.0 * d * (3 if key.endswith("dq") else 4) * b * h \
            * cs.admitted_pairs(t, tk, causal)
        res[key] = {"ms": ms, "bound_ms": bounds[key][0],
                    "bound_by": bounds[key][1], "tflops": work / ms / 1e9}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="FLASH_SHAPES names (default: the timed ones)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    _build.load(["flash_attention"])
    for line in str(_build.build_info["flash_attention"]["log"]).splitlines():
        if any(w in line for w in ("mma_kernel", "registers", "spill")):
            print(line.strip(), file=sys.stderr)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for shape in cs.FLASH_SHAPES:
        if (shape[0] in args.shapes) if args.shapes else shape[-1]:
            print(json.dumps(bench(shape, gen, args.iters)), flush=True)
            torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
