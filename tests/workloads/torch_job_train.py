"""The train job of the port's control plane: launched by ``python -m
tony_tpu_torch.cli submit --framework pytorch`` with a
``tony.worker.gpus`` ask, it trains the port's decoder through
``train_loop`` on a memmapped token file, with checkpoints from
``tony.ckpt.*`` (``TONY_CKPT_DIR/EVERY/KEEP``).

Each process joins the gang through ``distributed.initialize()`` (one
process forms a one-rank group itself), builds the data mesh over every
rank and reads its shard of each global batch. At the end of its last
step (profiled with ``torch.profiler`` on the card) each process writes
``job_result.json`` into its log dir: the card it saw (UUID, name, the
visible list and ``TONY_TASK_GPUS``), its losses and step times, the
port's kernel launches over the run (``ops.LAUNCHES``) and by kernel name
in the profiled step, its peak memory, and the top-level modules it
imported. With ``--final-params`` process 0 also writes the final
parameters (``final_params.pt``). Imports only the port, torch and
numpy.

    python torch_job_train.py --model llama2-7b --layers 1 --steps 4 \\
        --data tokens.npy --batch 2 --device cuda
"""

import argparse
import json
import os
import socket
import sys
import time
from pathlib import Path

import torch
import torch.distributed as td

from tony_tpu_torch import distributed as dist
from tony_tpu_torch import train
from tony_tpu_torch.data import Dataset, ShardSpec
from tony_tpu_torch.models import get_model
from tony_tpu_torch.ops import LAUNCHES
from tony_tpu_torch.parallel import MeshSpec

p = argparse.ArgumentParser()
p.add_argument("--model", default="llama-tiny")
p.add_argument("--layers", type=int, default=0, help="0 = the model's")
p.add_argument("--steps", type=int, default=4)
p.add_argument("--data", required=True, help=".npy of [examples, seq] ids")
p.add_argument("--batch", type=int, default=2, help="global batch rows")
p.add_argument("--lr", type=float, default=3e-4)
p.add_argument("--seed", type=int, default=0)
p.add_argument("--xent-chunk", type=int, default=0)
p.add_argument("--remat-policy", default=None)
p.add_argument("--device", default="cuda")
p.add_argument("--dtype", default=None, help="parameter dtype (float32)")
p.add_argument("--final-params", action="store_true",
               help="process 0 writes final_params.pt into its log dir")
args = p.parse_args()

on_card = args.device == "cuda"
if not on_card:
    # Several ranks share the host's cores: one thread each, not one
    # pool each.
    torch.set_num_threads(1)
if not dist.initialize(device=args.device):
    # One process: a one-rank group, so the step runs the mesh path of a
    # multi-rank job (the rendezvous env's address, else a free port).
    spec = dist.env_spec()
    if spec is None:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            init = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    else:
        init = spec[0]
    if on_card:
        torch.cuda.set_device(dist.task_card())
    td.init_process_group("nccl" if on_card else "gloo", init_method=init,
                          rank=0, world_size=1)
rank, world = td.get_rank(), td.get_world_size()
mesh = MeshSpec(dp=world).build(device=args.device)

kwargs = {"device": args.device, "seed": args.seed}
if args.layers:
    kwargs["n_layers"] = args.layers
if args.xent_chunk:
    kwargs["xent_chunk"] = args.xent_chunk
if args.remat_policy:
    kwargs["remat_policy"] = args.remat_policy
if args.dtype:
    kwargs["dtype"] = getattr(torch, args.dtype)
model = get_model(args.model, **kwargs)
state = train.create_train_state(model, train.adamw(args.lr), mesh=mesh)
if model.cfg.xent_chunk:
    step = train.make_train_step(
        loss_of=lambda out, batch: out, mesh=mesh,
        apply_kwargs_of=lambda batch: {"targets": batch["x"]})
else:
    step = train.make_train_step(
        loss_of=lambda logits, batch: train.next_token_loss(logits,
                                                            batch["x"]),
        mesh=mesh)


class FirstSteps:
    """The first ``n`` batches of a DeviceIterator, with its cursor."""

    def __init__(self, it, n):
        self.it, self.n = it, n

    def __iter__(self):
        return self

    def __next__(self):
        if self.n <= 0:
            raise StopIteration
        self.n -= 1
        return next(self.it)

    def state(self):
        return self.it.state()

    def restore(self, state):
        self.it.restore(state)

    def close(self):
        self.it.close()


# The stream's seed is the job's tony.data.seed (TONY_DATA_SEED).
ds = Dataset.from_memmap({"x": args.data}).shuffle().repeat() \
    .batch(args.batch).with_ids()
data = FirstSteps(ds.device_iterator(mesh, shard=ShardSpec(rank, world)),
                  args.steps)
losses, stamps, kernels = [], [time.monotonic()], {}
first_step_at = []


def profiled(st, batch):
    if len(losses) + 1 < args.steps or not on_card:
        return step(st, batch)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = step(st, batch)
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0) + evt.count
    return out


def on_step(i, metrics):
    losses.append(float(metrics["loss"]))         # syncs
    stamps.append(time.monotonic())
    if i == 1:
        first_step_at.append(time.time())


for name in LAUNCHES:
    LAUNCHES[name] = 0
if on_card:
    torch.cuda.reset_peak_memory_stats()
state, _ = train.train_loop(state, profiled, data=data, on_step=on_step)

result = {
    "rank": rank, "world": world, "losses": losses,
    "step_ms": [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])],
    "first_step_at": first_step_at[0] if first_step_at else None,
    "final_step": int(state.step),
    "launches": dict(LAUNCHES), "profiled_kernels": kernels,
    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
    "task_gpus": os.environ.get("TONY_TASK_GPUS"),
    "modules": sorted({m.split(".")[0] for m in sys.modules}),
}
if on_card:
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    result.update(uuid=f"GPU-{props.uuid}", device_name=props.name,
                  device_index=torch.cuda.current_device(),
                  device_count=torch.cuda.device_count(),
                  peak_bytes=torch.cuda.max_memory_allocated())
log_dir = Path(os.environ.get("TONY_LOG_DIR", "."))
(log_dir / "job_result.json").write_text(json.dumps(result))
if rank == 0 and args.final_params:
    torch.save({n: t.detach().cpu() for n, t in model.named_parameters()},
               log_dir / "final_params.pt")
print(f"rank {rank}/{world}: losses {[round(x, 4) for x in losses]}")
td.destroy_process_group()
