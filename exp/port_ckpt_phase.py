"""The ``train_ckpt`` phase of ``chip_smoke.py`` alone, on one card.

Runs only the checkpoint-and-data-plane phase, every check of it
included: the 8-layer llama2-7b train_loop cell saving at step 4 (one
async save), killed after step 6 and resumed through the port's
checkpointer and DeviceIterator, its step 8 compared with the
uninterrupted run's chunk for chunk in host memory (extents, CRC32,
bytes), then the fused codec, the drain commit and the publication at 2
layers; and inside it the ``serve_replica`` phase, which serves the
8-layer step 4 through the port's replica before it is deleted. It
writes two checkpoints, 22.57 GB (8 layers) and 8.07 GB (2 layers), and
raises before writing unless the disk has room for three times the
8-layer state. The train_loop phase's step p50, which the
whole script reports beside this phase's, is not measured here. Builds
only the kernels the phase launches. Run from the repository root on a
machine with one GPU::

    python3 exp/port_ckpt_phase.py > out.json

stderr has the phase log; stdout ends with the ``{"train_ckpt": ...}``
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
from tony_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"[device] {card}")
    t0 = time.monotonic()
    _build.load(("flash_attention", "fused_optim", "flash_decode"))
    cs.log(f"[build] {time.monotonic() - t0:.1f} s")
    cs.log("[train_ckpt]")
    t0 = time.monotonic()
    res = cs.train_ckpt_phase(card, None)
    cs.log(f"  phase {time.monotonic() - t0:.1f} s")
    print(json.dumps({"train_ckpt": res}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
