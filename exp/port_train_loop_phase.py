"""The ``train_loop`` phase of ``chip_smoke.py`` alone, on one card.

The whole smoke test takes minutes; this runs only its last phase (the
8-layer llama2-7b through ``train_loop`` on a one-rank NCCL mesh with
the chunked LM-head loss and the remat policies, every check of the
phase included), for iterating on that path. The train phase's first
loss, which the phase holds the chunked loss against, is taken here as
the plain head's loss of the same weights on the same batch (the train
phase's first step computes the same forward). Builds only the flash
kernels. Run from the repository root on a machine with one GPU::

    python3 exp/port_train_loop_phase.py > out.json

stderr has the phase log; stdout ends with the ``{"train_loop": ...}``
line and the card's ``nvidia-smi`` name and power limit.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
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
    model = cs.get_model("llama2-7b", device="cuda", seed=cs.SEED,
                         n_layers=cs.TRAIN_LAYERS)
    tokens = torch.as_tensor(np.random.default_rng(cs.SEED).integers(
        0, model.cfg.vocab, (cs.TRAIN_BATCH, cs.TRAIN_SEQ)), device="cuda")
    with torch.no_grad():
        first = float(cs.next_token_loss(model(tokens), tokens))
    del model
    torch.cuda.empty_cache()
    cs.log("[train_loop]")
    t0 = time.monotonic()
    res = cs.train_loop_phase(card, first)
    cs.log(f"  phase {time.monotonic() - t0:.1f} s")
    print(json.dumps({"train_loop": res}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
