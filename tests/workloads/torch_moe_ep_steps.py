"""One rank of the port's expert-parallel train step, for
``tests/test_torch_moe_ep.py`` (gloo ranks on the CPU) and the
``--moe-cards-only`` run of ``chip_smoke.py`` (one NCCL rank per card).

Usage: ``python torch_moe_ep_steps.py <config.json> <out prefix>``, with
the PyTorchRuntime env (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``). The config names the model (``model``,
``model_kwargs``), the device, the weights (``init``: an ``.npz`` of
whole parameters by the port's names, or ``seed``), the global batch
(``batch``: an ``.npz`` with ``x`` [B, T] tokens) and a list of ``runs``,
each on its own mesh ``MeshSpec(dp=, ep=)`` over the whole world: a
fresh train state from the same weights (``tx``: ``{"rule": "sgd" |
"adamw", ...}``, or ``{"rule": "capture"}``, which keeps each step's
reduced grads and updates nothing), ``steps`` steps of
``make_train_step`` with the
next-token loss on this rank's rows (those of its data index: the ranks
along ``expert`` share them), the run's ``model_kwargs`` on top of the
config's, and ``a2a_chunks`` (every MoE layer's exchange in that many
capacity chunks, ``explicit_a2a``; one exchange each way without),
optionally restored from a saved step first (``restore_dir``) and saved
after the steps (``save_dir``, every rank through
``ckpt.AsyncCheckpointer``), and optionally driven through
``train_loop`` (``"loop": true``). With ``"reference": true`` (and the
capture rule, one step) rank 0 then runs the same step on its card
alone, with no mesh, on the whole batch, twice: routing itself, and
taking the mesh step's routing (each layer's expert choices, gathered
from the ranks); it reports both losses, the share of tokens whose
top-k set differs between the mesh's routing and its own, and each
parameter's relative L2 distance between the grads of each and the
mesh's (gathered over the expert group). Per run rank 0 writes the metrics of
every step, each parameter's local and global element counts, the
``moe`` collective records, the wall time of every step and on the card
the peak memory (``<prefix>.json``, the runs by name) and the whole
parameters after the steps (``<prefix>.<run>.npz``, unless ``"dump":
false``). Imports only the port, torch and numpy.
"""

import json
import sys
import time

import numpy as np
import torch
import torch.distributed as td

from tony_tpu_torch import ckpt, profiler, train
from tony_tpu_torch import distributed as dist
from tony_tpu_torch.models import get_model, moe
from tony_tpu_torch.parallel import DATA, MeshSpec, layout_of
from tony_tpu_torch.parallel.overlap import attach_like, full_params

cfg = json.loads(open(sys.argv[1]).read())
out = sys.argv[2]
device = cfg.get("device", "cpu")
if device == "cpu":
    # Several ranks share the host's cores: one thread each, not one
    # pool each.
    torch.set_num_threads(1)
assert dist.initialize(device=device), "expected a multi-process TonY env"
rank = dist.process_id()
# Every mesh first, in the same order on every rank: their process
# groups are created collectively.
meshes = {(r["dp"], r["ep"]): None for r in cfg["runs"]}
for key in meshes:
    meshes[key] = MeshSpec(dp=key[0], ep=key[1]).build(
        device=None if device == "cuda" else device)
batch = np.load(cfg["batch"])["x"]
report = {}


def log(msg):
    print(f"[rank {rank} {time.strftime('%H:%M:%S')}] {msg}",
          file=sys.stderr, flush=True)


def capture(kept):
    """A transformation that keeps each step's grads in ``kept`` (the
    step's own tensors, no copy) and leaves the parameters as they
    are."""
    def update(grads, state, params):
        kept[:] = [g.detach() for g in grads]
        return state
    return train.GradientTransformation(lambda params: None, update)


def build(run, device, mesh, kept):
    kwargs = dict(cfg.get("model_kwargs", {}), **run.get("model_kwargs", {}))
    if "dtype" in kwargs:
        kwargs["dtype"] = getattr(torch, kwargs["dtype"])
    model = get_model(cfg["model"], device=device, seed=cfg.get("seed", 0),
                      **kwargs)
    for m in model.modules():
        if isinstance(m, moe.MoEMLP) and run.get("a2a_chunks"):
            m.explicit_a2a, m.a2a_chunks = True, run["a2a_chunks"]
    if cfg.get("init"):
        with torch.no_grad():
            for name, arr in np.load(cfg["init"]).items():
                model.get_parameter(name).copy_(torch.from_numpy(arr))
    tx = dict(run["tx"])
    rule = tx.pop("rule")
    tx = capture(kept) if rule == "capture" else getattr(train, rule)(**tx)
    return train.create_train_state(model, tx, mesh=mesh)


def next_token(out, b):
    return train.next_token_loss(out, b["x"])


def whole_routing(seen, mesh):
    """The mesh step's routing of the whole batch, ``[layers, k, B, T]``:
    every rank's gathered, the rows of data index d from the rank of
    expert index 0 there."""
    mine = torch.stack([seen[i] for i in sorted(seen)])
    every = [torch.empty_like(mine) for _ in range(td.get_world_size())]
    td.all_gather(every, mine)
    owners = [r for r in range(td.get_world_size())
              if mesh.coords(r)["expert"] == 0]
    return torch.cat([every[r] for r in owners], dim=2)


def rel_l2(names, got, ref):
    out = {}
    for name, a, b in zip(names, got, ref):
        norm = b.float().norm()
        diff = (a.float() - b.float()).norm()
        out[name] = float(diff / norm) if float(norm) else float(diff)
    return out


def reference(run, whole_grads, mesh_loss, routes):
    """Rank 0's one-card step on the whole batch, routing itself and on
    the mesh's ``routes``: the losses, the top-k sets that differ, and
    each parameter's relative L2 distance to ``whole_grads``."""
    out = {"mesh_loss": mesh_loss}
    for tag, pin in (("", None), ("pinned_", routes)):
        kept, seen = [], {}
        state = build(run, mesh.device, None, kept)
        with moe.routing(state.model, seen=seen, pin=pin):
            _, m = train.make_train_step(loss_of=next_token)(
                state, {"x": torch.from_numpy(batch).to(mesh.device)})
        names = [n for n, _ in state.model.named_parameters()]
        out[f"{tag}loss"] = float(m["loss"])
        out[f"{tag}aux_loss"] = float(m["aux_loss"])
        out[f"{tag}grad_rel_l2"] = rel_l2(names, whole_grads, kept)
        if pin is None:
            own = torch.stack([seen[i] for i in sorted(seen)])
            out["topk_differ_share_by_layer"] = [
                float((a.sort(dim=0).values != b.sort(dim=0).values)
                      .any(dim=0).float().mean())
                for a, b in zip(own, routes)]
        del state, kept
    return out


for run in cfg["runs"]:
    mesh = meshes[(run["dp"], run["ep"])]
    profiler.reset_collective_records()
    kept = []
    log(f"{run['name']}: building")
    state = build(run, mesh.device, mesh, kept)
    log(f"{run['name']}: built")
    if run.get("restore_dir"):
        state = ckpt.decode_portable(ckpt.restore_pytree(
            run["restore_dir"], ckpt.encode_portable(state)), mesh)
    rows = batch.shape[0] // mesh.shape[DATA]
    d = mesh.coords()[DATA]
    local = {"x": torch.from_numpy(batch[d * rows:(d + 1) * rows]).to(
        mesh.device)}
    step = train.make_train_step(loss_of=next_token, mesh=mesh)
    metrics, times = [], []
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)

    def on_step(i, m):
        metrics.append({k: float(v) for k, v in m.items()})
        times.append(time.perf_counter())

    seen = {}
    t0 = time.perf_counter()
    if run.get("reference"):
        with moe.routing(state.model, seen=seen):
            state, m = step(state, local)
        on_step(0, m)
    elif run.get("loop"):
        state, _ = train.train_loop(state, step, (local for _ in
                                               range(run["steps"])),
                                 on_step=on_step)
    else:
        for i in range(run["steps"]):
            state, m = step(state, local)
            on_step(i, m)
    log(f"{run['name']}: {len(metrics)} steps {metrics}")
    if run.get("save_dir"):
        saver = ckpt.AsyncCheckpointer(run["save_dir"])
        saver.save(ckpt.encode_portable(state), step=state.step, block=True)
        saver.close()
    params = list(state.model.parameters())
    names = [n for n, _ in state.model.named_parameters()]
    counts = {n: [p.numel(), int(np.prod(layout_of(p).shape))
                  if layout_of(p) is not None else p.numel()]
              for n, p in zip(names, params)}
    slots = [t.numel() for t in state.opt_state.trace] \
        if getattr(state.opt_state, "trace", None) else \
        [t.numel() for t in getattr(state.opt_state, "mu", [])]
    entry = {"metrics": metrics, "counts": counts, "step": state.step,
             "slot_elems": sum(slots),
             "step_s": [b - a for a, b in zip([t0] + times, times)],
             "records": {k: v for k, v in
                         profiler.collective_report().items()
                         if k.startswith("moe.") or "grad" in k}}
    if mesh.device.type == "cuda":
        entry["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    whole = full_params(params, mesh) if run.get("dump", True) else None
    if run.get("reference"):
        attach_like(kept, params)
        grads = full_params(kept, mesh)
        routes = whole_routing(seen, mesh)
        # The mesh state goes before the one-card model is built.
        del state, params, kept
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
        if rank == 0:
            entry["reference"] = reference(run, grads, metrics[-1]["loss"],
                                           routes)
            log(f"{run['name']}: one-card reference done")
        del grads
        state = params = None
    if rank == 0:
        report[run["name"]] = entry
        if whole is not None:
            np.savez(f"{out}.{run['name']}.npz",
                     **{n: t.float().cpu().numpy()
                        for n, t in zip(names, whole)})
    del state, params, whole
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    td.barrier()

if rank == 0:
    with open(f"{out}.json", "w") as f:
        json.dump(report, f)
td.barrier()
td.destroy_process_group()
