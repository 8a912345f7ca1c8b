"""Distributed data-parallel training of the port's decoder, launched by
``tony submit --framework pytorch``: the counterpart of
``jax_dp_train.py``. Each process joins the gloo process group wired by
the PyTorchRuntime env, builds the data mesh over every rank, and trains
llama-tiny with the chunked LM-head loss through ``train_loop``; the step
averages the grads over the ranks. Process 0 writes the loss history for
the e2e test to assert on. Imports only the port, torch and numpy."""

import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as td

from tony_tpu_torch import distributed as dist
from tony_tpu_torch import train
from tony_tpu_torch.models import get_model
from tony_tpu_torch.parallel import MeshSpec

# Several ranks share the host's cores: one thread each, not one pool
# each.
torch.set_num_threads(1)
initialized = dist.initialize(device="cpu")
assert initialized, "expected a multi-process TonY env"
rank, world = dist.process_id(), dist.num_processes()
mesh = MeshSpec(dp=world).build(device="cpu")

# Different seeds per rank on purpose: create_train_state broadcasts
# rank 0's weights, so the replicas start equal anyway.
model = get_model("llama-tiny", device="cpu", dtype=torch.float32,
                  xent_chunk=8, seed=rank)
state = train.create_train_state(model, train.adamw(1e-2), mesh=mesh)
step = train.make_train_step(
    loss_of=lambda loss, batch: loss,
    mesh=mesh, apply_kwargs_of=lambda batch: {"targets": batch["x"]})

local = np.random.default_rng(rank).integers(0, 256, (4, 16)).astype(
    np.int32)
batches = (train.global_batch(mesh, {"x": local}) for _ in range(8))
losses = []
stats = train.train_stats_writer()


def on_step(i, metrics):
    losses.append(float(metrics["loss"]))
    stats(i, metrics)


state, _ = train.train_loop(state, step, batches, on_step=on_step)
assert all(np.isfinite(losses)), losses
assert losses[-1] < losses[0], losses
if rank == 0:
    Path("torch_dp_losses.json").write_text(json.dumps({
        "losses": losses, "world_size": world}))
print(f"rank {rank}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
td.destroy_process_group()
