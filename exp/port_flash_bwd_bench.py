"""Time the bf16 flash-attention kernels of the PyTorch port on the card.

Rebuilds ``flash_attention.cu`` and prints what ``ptxas`` reports for each
tensor-core kernel (registers, shared memory, spills). Then, at the timed
shapes of ``chip_smoke.py``'s ``FLASH_SHAPES`` (rows 1-8 of the kernel
table), it runs the bf16 forward and backward once against their plain
versions (max|kernel - plain| for O, LSE, dQ, dK and dV), and times the
forward, the dQ kernel and the dK/dV kernel alone beside their bounds and
SDPA's forward and backward. One JSON line per shape, then the card's name
and power limit::

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


def ptxas_report(log):
    """The ptxas lines of the tensor-core kernels: each entry function's
    name, then its registers, shared memory and spills."""
    keep, out = False, []
    for line in str(log).splitlines():
        if "Compiling entry function" in line:
            keep = "mma_kernel" in line
        if keep and any(w in line for w in ("entry function", "registers",
                                            "spill")):
            out.append(line.strip())
    return out


def bench(shape, gen, iters):
    name, b, h, hkv, t, tk, d, causal, packed, rows, _ = shape
    dtype = torch.bfloat16
    q, k, v, do = cs.flash_inputs(b, h, hkv, t, tk, d, packed, dtype, gen)
    scale = d ** -0.5
    fwd = lambda: attn._flash_fwd_cuda(q, k, v, causal, scale)
    out, lse = fwd()
    ref_o, ref_lse = attn._flash_fwd_plain(q, k, v, causal, scale)
    dq, dk, dv = attn._flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)
    ref = cs.plain_bwd(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    errs = {key: float((got.float() - r.float()).abs().max())
            for key, got, r in zip(("o", "dq", "dk", "dv"),
                                   (out, dq, dk, dv), (ref_o,) + ref)}
    tols = {key: cs.output_tol(r, dtype)
            for key, r in zip(("o", "dq", "dk", "dv"), (ref_o,) + ref)}
    errs["lse"] = float((lse - ref_lse).abs().max())
    tols["lse"] = cs.F32_TOL * max(1.0, float(ref_lse.abs().max()))
    del ref, ref_o, ref_lse
    run_dq, run_dkv = cs.bwd_launchers(q, k, v, out, lse, do, causal, scale)
    bounds = cs.flash_bounds(b, h, hkv, t, tk, d, causal, dtype)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, enable_gqa=hkv != h)
    kept = sdpa()
    sdpa_fwd = cs.cuda_ms(lambda: sdpa().detach(), iters=iters, warmup=2)
    sdpa_bwd = cs.cuda_ms(lambda: torch.autograd.grad(
        kept, (qs, ks, vs), do, retain_graph=True), iters=iters, warmup=2)
    res = {"shape": name, "rows": rows, "max_abs_err": errs, "tol": tols,
           "within_tol": all(errs[key] <= tols[key] for key in errs),
           "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd}
    for key, fn, products in (("flash_attention_fwd", fwd, 2),
                              ("flash_attention_bwd_dq", run_dq, 3),
                              ("flash_attention_bwd_dkv", run_dkv, 4)):
        ms = cs.cuda_ms(fn, iters=iters, warmup=2)
        work = 2.0 * d * products * b * h * cs.admitted_pairs(t, tk, causal)
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
    _build._target("flash_attention").unlink(missing_ok=True)
    _build.load(["flash_attention"])
    for line in ptxas_report(_build.build_info["flash_attention"]["log"]):
        print(line, file=sys.stderr)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for shape in cs.FLASH_SHAPES:
        if (shape[0] in args.shapes) if args.shapes else shape[-1]:
            print(json.dumps(bench(shape, gen, args.iters)), flush=True)
            torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
