"""The ``serve_disagg`` phase of ``chip_smoke.py`` alone, on one card.

Runs the serve phase (full-width llama2-7b, the 16-request mix from 16
threads: the completions ``serve_disagg`` (c) is held against), then
``serve_disagg`` (a)-(c) on its model, then, with ``--jobs``, the split
serve job of the ``tony_jobs`` phase (``cli serve --role
prefill=1,decode=1`` and ``cli route``) on a 1-layer step saved from a
fresh state. Every check of the phases included. Builds only
flash-decode. Run from the repository root on a machine with one GPU::

    python3 exp/port_disagg_phase.py [--jobs] > out.json

stderr has the phase log; stdout ends with the ``{"serve_disagg": ...}``
line (and ``{"serve_roles": ...}``) and the card's ``nvidia-smi`` name
and power limit.
"""

import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tony_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"[device] {card}")
    t0 = time.monotonic()
    _build.load(("flash_decode",))
    cs.log(f"[build] {time.monotonic() - t0:.1f} s")
    cs.log("[serve]")
    serve, _, engine, results = cs.serve_phase(cs.SEED)
    model = engine.model
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    cs.log("[serve_disagg]")
    t0 = time.monotonic()
    res = cs.serve_disagg_phase(model, results)
    cs.log(f"  phase {time.monotonic() - t0:.1f} s")
    res["serve_tokens_per_s"] = serve["decode_tokens_per_s"]
    del model, results
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"serve_disagg": res}), flush=True)
    if "--jobs" in sys.argv[1:]:
        cs.log("[serve_roles job]")
        t0 = time.monotonic()
        job = cs.roles_job_on_a_fresh_step(gpus=0)
        cs.log(f"  job {time.monotonic() - t0:.1f} s")
        print(json.dumps({"serve_roles": job}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
