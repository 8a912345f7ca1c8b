"""Rehearse chip_smoke.py's serve_prefix and serve_spec phases on the
CPU at llama-tiny width (2 layers), with the phases' own mixes, counter
arithmetic and checks: the engines run on the CPU, the wrappers' plain
versions stand in for the kernels (row 9's launches are counted by a
wrapper around ``flash_decode``), and the CUDA memory and sync calls
are no-ops. Times printed here are the CPU's, not the card's.

    python3 exp/port_routed_lanes_cpu.py [--dtype f32|bf16]

Prints each way's lane counters, its distance to the cache-off (or
plain) run and its near-tie divergences.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from tony_tpu_torch import serve as tserve  # noqa: E402
from tony_tpu_torch.models import get_model  # noqa: E402
from tony_tpu_torch.models import transformer  # noqa: E402
from tony_tpu_torch.ops import LAUNCHES  # noqa: E402
from tony_tpu_torch.serve import engine as tengine  # noqa: E402


def on_the_cpu() -> None:
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    cs.ServeEngine = functools.partial(tengine.ServeEngine, device="cpu")
    tserve.SpecEngine = functools.partial(tserve.SpecEngine, device="cpu")
    plain = transformer.flash_decode

    def counted(*args, **kwargs):
        LAUNCHES["flash_decode"] += 1
        return plain(*args, **kwargs)

    transformer.flash_decode = counted


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    args = ap.parse_args()
    on_the_cpu()
    dt = torch.float32 if args.dtype == "f32" else torch.bfloat16
    model = get_model("llama-tiny", n_layers=2, device="cpu", dtype=dt,
                      param_dtype=dt, seed=cs.SEED)
    prefix = cs.serve_prefix_phase(model)
    spec = cs.serve_spec_phase(model)
    print(json.dumps({
        "dtype": args.dtype,
        "serve_prefix": {w: {k: r[k] for k in (
            "counters", "expected", "vs_cache_off_max_rel",
            "near_tie_divergences", "rows_compared")}
            for w, r in prefix["ways"].items()},
        "serve_spec": {w: {k: r.get(k) for k in (
            "acceptance_rate", "tokens_per_verify", "vs_plain_max_rel",
            "near_tie_divergences", "rejected")}
            for w, r in spec["ways"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
