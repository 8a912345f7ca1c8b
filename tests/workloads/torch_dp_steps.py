"""One rank of a data-parallel run of the port's train step, for
``tests/test_torch_dp.py``: joins the gloo group from the PyTorchRuntime
env, loads llama-tiny (``xent_chunk=8``) from ``argv[1]`` (an ``.npz``
of the port's parameters plus the global batch ``tokens``), trains three
SGD(0.1) steps through ``train_loop`` on this rank's rows of the
global batch, and writes its parameters, metrics and collective records
under the prefix ``argv[2]``. Imports only the port, torch and numpy."""

import json
import sys

import numpy as np
import torch
import torch.distributed as td

from tony_tpu_torch import distributed as dist
from tony_tpu_torch import profiler, train
from tony_tpu_torch.models import get_model
from tony_tpu_torch.parallel import MeshSpec

src, out = sys.argv[1], sys.argv[2]
assert dist.initialize(device="cpu"), "expected a multi-process TonY env"
rank, world = dist.process_id(), dist.num_processes()
mesh = MeshSpec().build(device="cpu")
arrays = dict(np.load(src))
tokens = arrays.pop("tokens")
model = get_model("llama-tiny", device="cpu", dtype=torch.float32,
                  xent_chunk=8)
if rank == 0:
    # Only rank 0 loads the weights: create_train_state broadcasts them.
    model.load_state_dict({k: torch.from_numpy(v) for k, v in arrays.items()})
state = train.create_train_state(model, train.sgd(0.1), mesh=mesh)
step = train.make_train_step(
    loss_of=lambda loss, batch: loss, mesh=mesh,
    apply_kwargs_of=lambda batch: {"targets": batch["x"]})
rows = tokens.shape[0] // world
local = tokens[rank * rows:(rank + 1) * rows]
metrics = []
state, _ = train.train_loop(
    state, step, [train.global_batch(mesh, {"x": local})] * 3,
    on_step=lambda i, m: metrics.append({k: float(v) for k, v in m.items()}))
np.savez(f"{out}.npz", **{k: v.detach().numpy()
                          for k, v in model.state_dict().items()})
with open(f"{out}.json", "w") as fh:
    json.dump({"metrics": metrics, "world": world,
               "collectives": profiler.collective_report()}, fh)
td.destroy_process_group()
