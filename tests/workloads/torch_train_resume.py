"""Gang-restart resume through the port's train loop, launched by
``tony submit --framework pytorch``: the counterpart of
``train_resume.py``. The checkpoint directory comes from the job conf's
``tony.ckpt.dir`` alone (``train_loop`` reads the conf the executor
names in ``TONY_CONF_PATH``); no ``CKPT_DIR`` variable is read.

Attempt 1: ``train_loop`` trains mnist-mlp three steps with
``sgd(0.1, momentum=0.9)``, commits its final step and the script exits
1 (induced failure: the AM must gang-restart). Attempt 2: the same call
restores step 3 from the conf's directory, trains two more steps,
commits, writes resume.json and exits 0. Imports only the port, torch
and numpy."""

import json
import sys
import time

import numpy as np
import torch

from tony_tpu_torch import train
from tony_tpu_torch.models import get_model

rng = np.random.default_rng(0)
batch = {"x": torch.tensor(rng.standard_normal((8, 784), dtype=np.float32)),
         "y": torch.tensor(rng.integers(0, 10, 8))}
model = get_model("mnist-mlp", hidden=32, device="cpu", seed=0)
state = train.create_train_state(model, train.sgd(0.1, momentum=0.9))
starts = []


def batches():
    # Runs once train_loop has restored into ``state`` in place.
    starts.append(state.step)
    for _ in range(3 if state.step == 0 else 2):
        yield batch


state, metrics = train.train_loop(state, train.make_train_step(), batches())
if starts[0] == 0:
    # Let a heartbeat carry the committed step to the AM, then fail.
    time.sleep(1.0)
    sys.exit(1)

assert starts[0] == 3, f"expected to resume from step 3, got {starts[0]}"
assert torch.isfinite(metrics["loss"]), "post-resume loss is not finite"
with open("resume.json", "w") as f:
    json.dump({"resumed_from": starts[0], "final_step": state.step}, f)
sys.exit(0)
