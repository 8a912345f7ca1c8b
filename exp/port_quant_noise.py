"""The quantized lane's serving noise in the PyTorch port, by depth.

The int8 lane scales activations per tensor over every row of a launch,
padding rows included, so a decode row and the same row inside a full
prefill are quantized with different scales. This script serves a
16-request mix through ``tony_tpu_torch.serve.ServeEngine`` with a
llama-style decoder (bf16, random weights from a seed) at several
depths, once with ``quant=True`` and once without, and prints one JSON
line per depth: the worst per-row max|decode - full prefill| /
max|full prefill| over four requests on each lane, and the first
generated row's distance between the two lanes.

    python exp/port_quant_noise.py            # dim 256 on the CPU
    python exp/port_quant_noise.py --width full --device cuda

``--width full`` is llama2-7b's width (dim 4096, 32 heads, ffn 11008,
vocab 32000; about 0.4 GB of bf16 weights per layer), for the card.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tony_tpu_torch.models import get_model  # noqa: E402
from tony_tpu_torch.serve import Request, ServeEngine  # noqa: E402


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def serve(model, device):
    eng = ServeEngine(model, device=device, ctx_max=256, block_size=16,
                      q_block=16, decode_buckets=(4, 16), max_running=16,
                      keep_logits=True)
    rng = np.random.RandomState(0)
    for i in range(16):
        eng.submit(Request(rid=i, tokens=list(rng.randint(
            0, model.cfg.vocab, rng.randint(16, 120))),
            max_new_tokens=int(rng.randint(4, 16))))
    done = sorted(eng.run(), key=lambda c: c.rid)
    worst = 0.0
    for c in done[:4]:
        ref = eng.full_prefill_logits(list(c.prompt) + list(c.tokens))
        p = len(c.prompt)
        for j, row in enumerate(c.logits):
            worst = max(worst, rel(row, ref[p - 1 + j]))
    return worst, done


WIDTHS = {
    "256": ("llama-tiny", dict(dim=256, n_heads=2, n_kv_heads=2,
                               ffn_hidden=688, vocab=4096)),
    "full": ("llama2-7b", {}),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", choices=sorted(WIDTHS), default="256")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 8, 16, 32])
    args = ap.parse_args()
    name, dims = WIDTHS[args.width]
    for layers in args.layers:
        kw = dict(dims, n_layers=layers, device=args.device, seed=3,
                  dtype=torch.bfloat16, param_dtype=torch.bfloat16)
        q_worst, q_done = serve(get_model(name, quant=True, **kw),
                                args.device)
        u_worst, u_done = serve(get_model(name, **kw), args.device)
        first = max(rel(a.logits[0], b.logits[0])
                    for a, b in zip(q_done, u_done))
        print(json.dumps({"width": args.width, "n_layers": layers,
                          "quant_decode_vs_prefill_max_rel": q_worst,
                          "plain_decode_vs_prefill_max_rel": u_worst,
                          "quant_vs_plain_first_row_max_rel": first}))


if __name__ == "__main__":
    main()
