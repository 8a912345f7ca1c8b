"""The ``serve_kvtier`` phase of ``chip_smoke.py`` alone, on one card.

Builds flash-decode and full-width llama2-7b (random bf16 weights from
seed 0, as the serve phase builds it), then runs ``serve_kvtier``
(a)-(e) on it, every check of the phase included; with ``--passes``
(e.g. ``--passes a,c``) only those passes. Run from the repository root
on a machine with one GPU::

    python3 exp/port_kvtier_phase.py [--passes a,b,c,d,e] > out.json

stderr has the phase log; stdout ends with the ``{"serve_kvtier": ...}``
line and the card's ``nvidia-smi`` name and power limit.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tony_tpu_torch.models import get_model  # noqa: E402
from tony_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    which = "abcde"
    if "--passes" in sys.argv[1:]:
        which = sys.argv[sys.argv.index("--passes") + 1].replace(",", "")
    card = cs.card_line()
    cs.log(f"[device] {card}")
    t0 = time.monotonic()
    _build.load(("flash_decode",))
    cs.log(f"[build] {time.monotonic() - t0:.1f} s")
    model = get_model("llama2-7b", device="cuda", seed=cs.SEED,
                      param_dtype=torch.bfloat16)
    res = cs.serve_kvtier_phase(model, which)
    print(json.dumps({"serve_kvtier": res}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
