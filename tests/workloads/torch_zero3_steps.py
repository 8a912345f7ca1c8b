"""One rank of a ZeRO-3 run of the port's train steps, for
``tests/test_torch_zero3.py`` (gloo ranks on the CPU) and the
``train_zero3`` phase of ``chip_smoke.py`` (one NCCL rank per card).

Usage: ``python torch_zero3_steps.py <config.json> <out prefix>``, with
the PyTorchRuntime env (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``). The config names the model (``model``,
``model_kwargs``), the mesh (``dp``, ``fsdp``), the device, the weights
(``init``: an ``.npz`` of whole parameters that rank 0 loads, or
``seed``), the global batch (``batch``: an ``.npz`` of arrays) and a list
of ``runs``: each builds a fresh ZeRO-3 state from the same weights and
takes ``steps`` steps of ``make_accum_train_step`` (``"step": "accum"``,
or ``fused_update_step`` alone with grads made from the parameters,
``"step": "update"``,
with ``microbatches``, ``update``, ``reduce_op``, ``gather``,
``prefetch``, ``bucket_bytes``) or of ``make_train_step``
(``"step": "train"``; the loss: the model's own with ``targets``, the
next-token loss on ``x`` with ``"loss": "next_token"``, else cross
entropy on ``y``), optionally with its own ``specs`` (one per
parameter; default: the model's logical axes), starting from a saved
state (``restore_dir``) and saving it after the steps (``save_dir``). Per run it
writes the metrics of every step, each parameter's and slot's local and
global element counts before and after the steps, the whole parameters
(gathered over fsdp; ``<prefix>.<run>.npz``, rank 0) and the collective
records (``<prefix>.json``). Imports only the port, torch and numpy.
"""

import json
import sys
import time

import numpy as np
import torch
import torch.distributed as td

from tony_tpu_torch import ckpt, profiler, train
from tony_tpu_torch import distributed as dist
from tony_tpu_torch.models import get_model
from tony_tpu_torch.ops import fused_optim
from tony_tpu_torch.ops.fused_optim import FusedOptimizer
from tony_tpu_torch.parallel import MeshSpec, layout_of
from tony_tpu_torch.parallel.overlap import full_params

cfg = json.loads(open(sys.argv[1]).read())
out = sys.argv[2]
device = cfg.get("device", "cpu")
assert dist.initialize(device=device), "expected a multi-process TonY env"
rank = dist.process_id()
mesh = MeshSpec(dp=cfg.get("dp", 0), fsdp=cfg["fsdp"]).build(
    device=None if device == "cuda" else device)
init = dict(np.load(cfg["init"])) if cfg.get("init") and rank == 0 else None
batch = {k: torch.from_numpy(v) for k, v in np.load(cfg["batch"]).items()}
group = mesh.shape["data"] * mesh.shape["fsdp"]
rows = next(iter(batch.values())).shape[0] // group
local = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}


def build(run):
    kwargs = dict(cfg.get("model_kwargs", {}))
    if "dtype" in kwargs:
        kwargs["dtype"] = getattr(torch, kwargs["dtype"])
    model = get_model(cfg["model"], device=mesh.device, **kwargs)
    if init is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in init.items()})
    if run.get("update") == "fused_bucket":
        tx = FusedOptimizer(**run["tx"])
    else:
        tx = getattr(train, run["tx"].pop("rule"))(**run["tx"])
    return model, train.create_train_state(
        model, tx, mesh=mesh, specs=run.get("specs", cfg.get("specs")))


def storage(state):
    """Per leaf: (local, global) parameter elements, and the slots'."""
    params = list(state.model.parameters())

    def whole(p):
        lay = layout_of(p)
        return int(np.prod(lay.shape)) if lay is not None else p.numel()
    rec = {"params": [[p.numel(), whole(p)] for p in params]}
    opt = state.opt_state
    if isinstance(opt, dict):
        rec["slots"] = [[int(b.numel()) for b in bufs]
                        for bufs in opt["slots"].values()]
        plan = state.buckets.plan
        rec["slot_whole"] = [plan.bucket_numel[b]
                             for b in range(plan.n_buckets)]
        rec["scatter"] = [plan._is_scatter(b) and not plan._is_padded(b)
                          for b in range(plan.n_buckets)]
    else:
        rec["slots"] = [[t.numel(), whole(t)]
                        for name in ("mu", "nu", "trace")
                        for t in (getattr(opt, name, None) or ())]
    return rec


def fused_update(state, batch):
    """``fused_update_step`` alone on this rank's leaves, with grads made
    from the parameters (0.01·p + 0.001), in place of a train step."""
    params = list(state.model.parameters())
    grads = [p.detach() * 0.01 + 0.001 for p in params]
    _, state.opt_state, gnorm = fused_optim.fused_update_step(
        state.tx, params, grads, state.opt_state, mesh,
        plan=state.buckets.plan)
    zero = torch.zeros(())
    return state, {"loss": zero, "grad_norm": gnorm, "aux_loss": zero}


report = {"world": td.get_world_size(), "runs": {}}
for name, run in cfg["runs"].items():
    run = json.loads(json.dumps(run))
    model, state = build(run)
    kw = {"apply_kwargs_of": (lambda b: {"targets": b["x"]})} \
        if cfg.get("targets") else {}
    if cfg.get("targets"):
        loss_of = lambda o, b: o                            # noqa: E731
    elif cfg.get("loss") == "next_token":
        loss_of = lambda o, b: train.next_token_loss(o, b["x"])  # noqa
    else:
        loss_of = lambda o, b: train.cross_entropy_loss(o, b["y"])  # noqa
    if run["step"] == "train":
        step = train.make_train_step(loss_of, mesh=mesh, **kw)
    elif run["step"] == "update":
        step = fused_update
    else:
        step = train.make_accum_train_step(
            loss_of, mesh, microbatches=run["microbatches"],
            update=run.get("update", "optax"),
            reduce_op=run.get("reduce_op", "all_reduce"),
            gather=run.get("gather", "bucketed"),
            prefetch=run.get("prefetch", 1),
            bucket_bytes=run.get("bucket_bytes", 4 << 20), **kw)
    if run.get("restore_dir"):
        state = ckpt.decode_portable(ckpt.restore_pytree(
            run["restore_dir"], ckpt.encode_portable(state), mesh=mesh),
            mesh)
    before = storage(state)
    profiler.reset_collective_records()
    profiler.reset_overlap_records()
    feed = train.global_batch(mesh, local)
    metrics, times = [], []
    for _ in range(run["steps"]):
        t0 = time.perf_counter()
        state, m = step(state, feed)
        metrics.append({k: float(v) for k, v in m.items()})
        times.append(time.perf_counter() - t0)
    if hasattr(state.buckets, "check"):
        state.buckets.check()
    if run.get("save_dir"):
        saver = ckpt.AsyncCheckpointer(run["save_dir"])
        saver.save(ckpt.encode_portable(state), step=state.step, block=True)
        saver.close()
    whole = full_params(list(model.parameters()), mesh)
    if rank == 0:
        names = [n for n, _ in model.named_parameters()]
        np.savez(f"{out}.{name}.npz", **{
            n: t.detach().float().cpu().numpy() for n, t in zip(names, whole)})
    del whole
    report["runs"][name] = {
        "metrics": metrics, "step_s": times, "before": before,
        "after": storage(state),
        "collectives": profiler.collective_report(),
        "overlap": profiler.overlap_report(),
        "peak_bytes": torch.cuda.max_memory_allocated(mesh.device)
        if mesh.device.type == "cuda" else 0}
    del model, state, step
with open(f"{out}.json", "w") as fh:
    json.dump(report, fh)
td.destroy_process_group()
