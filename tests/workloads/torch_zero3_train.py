"""ZeRO-3 training of the port's decoder, launched by ``tony submit
--framework pytorch``: the fsdp counterpart of ``torch_dp_train.py``.
Each process joins the gloo group wired by the PyTorchRuntime env,
builds an fsdp mesh over every rank, keeps its shard of every sharded
parameter and of the AdamW state, and trains llama-tiny with the chunked
LM-head loss through ``make_accum_train_step`` and ``train_loop``,
saving every 3 steps (each rank writes its own shards). Process 0 writes
the loss history and what it checked for the e2e test. Imports only the
port, torch and numpy."""

import json
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as td

from tony_tpu_torch import ckpt, train
from tony_tpu_torch import distributed as dist
from tony_tpu_torch.models import get_model
from tony_tpu_torch.parallel import MeshSpec, layout_of

# Several ranks share the host's cores: one thread each, not one pool
# each.
torch.set_num_threads(1)
assert dist.initialize(device="cpu"), "expected a multi-process TonY env"
rank, world = dist.process_id(), dist.num_processes()
mesh = MeshSpec(dp=1, fsdp=world).build(device="cpu")

# Different seeds per rank on purpose: create_train_state broadcasts
# rank 0's weights before each rank keeps its shards.
model = get_model("llama-tiny", device="cpu", dtype=torch.float32,
                  xent_chunk=8, seed=rank)
state = train.create_train_state(model, train.adamw(1e-2), mesh=mesh)
half = all(p.numel() * world == int(np.prod(layout_of(p).shape))
           for p in model.parameters() if layout_of(p).sharded)
step = train.make_accum_train_step(
    lambda loss, batch: loss, mesh, microbatches=2,
    apply_kwargs_of=lambda batch: {"targets": batch["x"]})

local = np.random.default_rng(rank).integers(0, 256, (4, 16)).astype(
    np.int32)
batches = (train.global_batch(mesh, {"x": local}) for _ in range(6))
losses = []
with tempfile.TemporaryDirectory(dir=".") as ck_dir:
    if rank:
        ck_dir = None
    # One directory for the gang: rank 0's, shared through a broadcast.
    names = [ck_dir]
    td.broadcast_object_list(names, src=0)
    state, _ = train.train_loop(
        state, step, batches, ckpt_dir=names[0], save_every=3,
        on_step=lambda i, m: losses.append(float(m["loss"])))
    td.barrier()
    files = len({ch["file"] for ch in ckpt.read_manifest(
        names[0], state.step)["chunks"]})
    td.barrier()
assert all(np.isfinite(losses)), losses
if rank == 0:
    Path("torch_zero3_losses.json").write_text(json.dumps({
        "losses": losses, "world_size": world, "fsdp": mesh.shape["fsdp"],
        "half_shards": half, "shard_files": files}))
print(f"rank {rank}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
td.destroy_process_group()
