"""The ``pipeline_stages`` check of ``chip_smoke.py``'s kernels phase
alone, on one card: llama2-7b's first two Blocks at full width as two
pipeline stages, the gpipe and 1F1B loops in lockstep on the card
(``parallel.pipeline.pipeline_blocks``), held against the two Blocks
applied one after the other, with the launches of rows 3 and 7. Builds
only flash attention. Run from the repository root on a machine with
one GPU::

    python3 exp/port_pipeline_stages.py > out.json

stderr has the phase log; stdout ends with the ``{"pipeline_stages":
...}`` line and the card's ``nvidia-smi`` name and power limit.
"""

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
    _build.load(("flash_attention",))
    cs.log(f"[build] {time.monotonic() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    res = cs.check_pipeline_stages(gen)
    print(json.dumps({"pipeline_stages": res}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
