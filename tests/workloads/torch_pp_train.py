"""Distributed pipeline-parallel training of the port: 2 processes form
one pp=2 mesh and the stage sends cross the process boundary (the
counterpart of ``jax_pp_train.py``, run by ``tony submit --framework
pytorch``, gloo on the CPU). Process 0 writes the loss history to
``pp_losses.json``."""

import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as td

from tony_tpu_torch import distributed as dist
from tony_tpu_torch import train
from tony_tpu_torch.models import get_model
from tony_tpu_torch.parallel import DATA, MeshSpec
from tony_tpu_torch.parallel.pipeline import pipelined_lm_logits

torch.set_num_threads(1)
assert dist.initialize(device="cpu"), "expected a multi-process TonY env"

mesh = MeshSpec(dp=td.get_world_size() // 2, pp=2).build(device="cpu")
model = get_model("llama-tiny", device="cpu")
# 2 microbatches x 2 rows per data index.
rows = 4
index, count = mesh.batch_index()
tokens = np.random.RandomState(0).randint(0, model.cfg.vocab,
                                          (rows * count, 16))
state = train.create_train_state(model, train.adamw(1e-2, weight_decay=0.0),
                                 mesh=mesh)
step = train.make_train_step(
    loss_of=lambda out, b: train.next_token_loss(out, b["x"]), mesh=mesh,
    forward=lambda m, b: pipelined_lm_logits(m, b["x"], mesh, n_stages=2,
                                             microbatches=2))
batch = train.global_batch(mesh, {"x": tokens[index * rows:
                                              (index + 1) * rows]})
losses = []
for _ in range(6):
    state, metrics = step(state, batch)
    losses.append(float(metrics["loss"]))

if td.get_rank() == 0:
    Path("pp_losses.json").write_text(json.dumps({
        "num_processes": td.get_world_size(),
        "mesh": {k: v for k, v in mesh.shape.items() if v > 1 or k == DATA},
        "layers_held": len(state.model.layers),
        "losses": losses}))
td.destroy_process_group()
