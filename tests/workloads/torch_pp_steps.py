"""One rank of the port's pipeline-parallel train step: the port's
counterpart of ``examples/jax_llama_pp.py``, for ``tony submit
--framework pytorch`` (one worker a card), for
``tests/test_torch_pipeline.py`` (gloo ranks on the CPU) and for the
``--pipeline-cards-only`` run of ``chip_smoke.py`` (one NCCL rank a
card).

Without arguments it reads the example's knobs: ``MODEL``
(llama-tiny|llama2-7b), ``MESH_PP`` (default 2), ``MICROBATCHES``
(default 2·pp), ``STEPS`` (5), ``BATCH`` (the global batch; default one
row a microbatch of each data index) and ``SEQ`` (64), and trains
``adamw(3e-4)`` on ``MeshSpec(pp=)`` over the whole world through
``pipelined_lm_logits`` on seeded random tokens; rank 0 prints each step
and writes ``pp_losses.json`` (model, mesh, microbatches, losses).

``python torch_pp_steps.py <config.json> <out prefix>`` runs the
config's ``runs`` instead, each on its own mesh ``MeshSpec(dp=, pp=)``
over the whole world. A run of ``"kind": "toy"`` is the reference tests'
stack (tests/test_pipeline.py): ``w`` ``[L, D, D]`` (its first
``layers``) and ``x`` ``[B, D]`` from the run's (or the config's)
``toy`` ``.npz``, a stage applying ``tanh(h @ w_l)``
for each of its layers, through ``gpipe`` or ``gpipe_1f1b``
(``schedule``) with ``microbatches``, the loss ``sum(y)`` or
``sum(y**2)`` (``loss``); rank 0 writes the whole output, the stage
grads (summed over the data group) and the input's grad, and with
``sgd_steps`` the losses of that many SGD steps (``lr``) on the stage
weights. A decoder run has the model (``model``, ``model_kwargs`` and
the run's on top), the device (``device``), the weights (``init``: an
``.npz`` of whole parameters by the port's names, or ``seed``), the
global batch (``batch``: an ``.npz`` with ``x`` [B, T], or
``batch_shape`` [B, T] of seeded tokens; a run's own wins), ``tx``
(``{"rule": "sgd" | "adamw", ...}``, or ``{"rule": "capture"}``, which
keeps each step's reduced grads and updates nothing), ``microbatches``
and ``schedule``, and ``steps`` steps of ``make_train_step(forward=
pipelined_lm_logits)`` with the next-token loss (the collective records
cover the steps from ``records_from`` on; ``"profile": true`` adds two
steps, rank 0's second under ``torch.profiler`` on the card), optionally
restored from a saved step first (``restore_dir``) and saved after the
steps (``save_dir``); ``"logits": true`` first runs the forward alone
and writes the whole logits (``<prefix>.<run>.logits.npy``); with
``"reference": true`` rank 0 then runs the same steps on its device
alone, the whole model with no mesh, on the whole batch, and reports
their losses, and with the capture rule each parameter's relative L2
distance between its grads and the pipeline's. Rank 0 writes, per run,
the metrics of every step, the wall and host-queue time of each, every
rank's kernel launches in the steps (``ops.LAUNCHES``), coordinates,
peak memory on the card and collective records, each parameter's local
and global element counts, whether the replicated leaves are bitwise
equal on every rank (``<prefix>.json``), and the whole parameters by
the whole model's names (``<prefix>.<run>.npz``, unless ``"dump":
false``; ``"dump_opt": true`` adds AdamW's moments and ``"dump_grads":
true`` the capture rule's grads). Imports only the port, torch and
numpy.
"""

import json
import os
import socket
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as td

from tony_tpu_torch import ckpt, profiler, train
from tony_tpu_torch import distributed as dist
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import whole_names
from tony_tpu_torch.ops import LAUNCHES
from tony_tpu_torch.parallel import DATA, PIPE, MeshSpec, layout_of
from tony_tpu_torch.parallel.pipeline import (gpipe, gpipe_1f1b,
                                              pipelined_lm_logits,
                                              stage_split)
from torch_sharded_steps import (build_model, global_tokens, log,
                                 make_tx, next_token, profile_steps, rel_l2,
                                 replicated_equal)


def pipelined(mesh, run):
    pp = mesh.shape[PIPE]

    def forward(model, batch):
        return pipelined_lm_logits(model, batch["x"], mesh, n_stages=pp,
                                   microbatches=run["microbatches"],
                                   schedule=run.get("schedule", "gpipe"))
    return forward


def warm(mesh):
    """Bring up the communicators of the data group and the pipe chain
    (NCCL builds them at their first use) before any timed step."""
    x = torch.ones(1, device=mesh.device)
    for axis in (DATA, PIPE):
        if mesh.shape[axis] > 1:
            td.all_reduce(x, group=mesh.group((axis,)))
    if mesh.shape[PIPE] > 1:
        s, group = mesh.coords()[PIPE], mesh.group((PIPE,))
        ops = []
        if s + 1 < mesh.shape[PIPE]:
            ops.append(td.P2POp(td.isend, x, mesh.peer(PIPE, 1), group))
        if s > 0:
            ops.append(td.P2POp(td.irecv, torch.empty_like(x),
                                mesh.peer(PIPE, -1), group))
        for req in td.batch_isend_irecv(ops):
            req.wait()


def gather_stages(mesh, named):
    """Rank 0's whole tensors by the whole model's names: every rank of
    data index 0 contributes its own (a stage's layers, and the
    replicated leaves from rank 0); None elsewhere."""
    mine = {k: v.detach().float().cpu().numpy() for k, v in named.items()} \
        if mesh.coords()[DATA] == 0 else {}
    every = [None] * td.get_world_size()
    td.all_gather_object(every, mine)
    if td.get_rank():
        return None
    out = {}
    for part in every:
        out.update(part)
    return out


def by_whole_name(model, tensors):
    names = whole_names(model)
    return {names[n]: t for (n, _), t in zip(model.named_parameters(),
                                              tensors)}


def toy_run(cfg, run, mesh):
    """The reference tests' tanh stack through gpipe or gpipe_1f1b."""
    data = np.load(run.get("toy") or cfg["toy"])
    w_all = torch.from_numpy(data["w"][:run.get("layers",
                                                 data["w"].shape[0])])
    x_all = torch.from_numpy(data["x"])
    pp, s = mesh.shape[PIPE], mesh.coords()[PIPE]
    index, count = mesh.batch_index()
    rows = x_all.shape[0] // count
    x = x_all[index * rows:(index + 1) * rows].clone().requires_grad_()
    w = stage_split(w_all, pp)[s].clone().requires_grad_()
    fn = gpipe if run.get("schedule", "gpipe") == "gpipe" else gpipe_1f1b

    def stage_fn(p, h):
        for layer in p.unbind(0):
            h = torch.tanh(h @ layer)
        return h

    def loss_of(y):
        return (y ** 2).sum() if run.get("loss") == "sq" else y.sum()

    profiler.reset_collective_records()
    profiler.reset_overlap_records()
    y = fn(stage_fn, w, x, mesh, microbatches=run["microbatches"])
    loss_of(y).backward()
    records = profiler.collective_report()
    overlap = profiler.overlap_report()
    gw = w.grad.clone()
    if mesh.shape[DATA] > 1:
        td.all_reduce(gw, group=mesh.group((DATA,)))
    losses = []
    for _ in range(run.get("sgd_steps", 0)):
        w.grad = None
        out = fn(stage_fn, w, x, mesh, microbatches=run["microbatches"])
        loss = loss_of(out)
        loss.backward()
        g = w.grad.clone()
        total = loss.detach().clone()
        if mesh.shape[DATA] > 1:
            td.all_reduce(g, group=mesh.group((DATA,)))
            td.all_reduce(total, group=mesh.group((DATA,)))
        with torch.no_grad():
            w -= run["lr"] * g
        losses.append(float(total))
    mine = {"index": index, "stage": s, "y": y.detach().numpy(),
            "dx": x.grad.numpy(), "gw": gw.numpy(), "records": records,
            "overlap": overlap, "rank": td.get_rank(),
            "coords": {k: v for k, v in mesh.coords().items()
                       if mesh.shape[k] > 1}}
    every = [None] * td.get_world_size()
    td.all_gather_object(every, mine)
    if td.get_rank():
        return None, None
    per = w_all.shape[0] // pp
    out_y, out_dx = np.zeros(tuple(x_all.shape), np.float32), \
        np.zeros(tuple(x_all.shape), np.float32)
    out_gw = np.zeros(tuple(w_all.shape), np.float32)
    for e in every:
        blk = slice(e["index"] * rows, (e["index"] + 1) * rows)
        out_y[blk], out_dx[blk] = e["y"], e["dx"]
        out_gw[e["stage"] * per:(e["stage"] + 1) * per] = e["gw"]
    entry = {"losses": losses, "mesh": {k: v for k, v in mesh.shape.items()
                                        if v > 1},
             "ranks": [{k: e[k] for k in ("rank", "coords", "records",
                                          "overlap")} for e in every]}
    return entry, {"y": out_y, "dx": out_dx, "gw": out_gw}


def reference(cfg, run, tokens, device, whole_grads):
    """Rank 0's run on its device alone, the whole model with no mesh:
    the run's steps with its tx on the whole batch; with the capture
    rule each parameter's relative L2 distance between the pipeline's
    grads and these."""
    kept = []
    model = build_model(cfg, run, device, None)
    state = train.create_train_state(model, make_tx(run, kept))
    step = train.make_train_step(loss_of=next_token)
    batch = {"x": torch.from_numpy(tokens).to(device)}
    metrics = []
    for _ in range(run["steps"]):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"loss": metrics[0]["loss"], "grad_norm": metrics[0]["grad_norm"],
           "losses": [m["loss"] for m in metrics]}
    if whole_grads is not None:
        names = [n for n, _ in model.named_parameters()]
        out["grad_rel_l2"] = rel_l2(
            names, [torch.from_numpy(whole_grads[n]) for n in names],
            [g.cpu() for g in kept])
    del state, model, kept
    return out


def decoder_run(cfg, run, mesh, out, rank):
    tokens = global_tokens(cfg, run)
    dev = mesh.device
    profiler.reset_collective_records()
    kept = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"{run['name']}: building")
    t_build = time.perf_counter()
    model = build_model(cfg, run, dev, None)
    state = train.create_train_state(model, make_tx(run, kept), mesh=mesh)
    build_s = time.perf_counter() - t_build
    build_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else None
    log(f"{run['name']}: built in {build_s:.1f} s")
    if run.get("restore_dir"):
        state = ckpt.decode_portable(ckpt.restore_pytree(
            run["restore_dir"], ckpt.encode_portable(state)), mesh)
    index, count = mesh.batch_index()
    rows = tokens.shape[0] // count
    local = train.global_batch(
        mesh, {"x": tokens[index * rows:(index + 1) * rows]})
    forward = pipelined(mesh, run)
    if run.get("logits"):
        with torch.no_grad():
            mine = forward(state.model, local).cpu().numpy()
        every = [None] * td.get_world_size()
        td.all_gather_object(every, (index, mine))
        if rank == 0:
            whole = np.zeros((tokens.shape[0],) + mine.shape[1:], np.float32)
            for i, blk in every:
                whole[i * rows:(i + 1) * rows] = blk
            np.save(f"{out}.{run['name']}.logits.npy", whole)
    step = train.make_train_step(loss_of=next_token, mesh=mesh,
                                 forward=forward)
    metrics, times, host = [], [], []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    t0 = time.perf_counter()
    for i in range(run["steps"]):
        if i == run.get("records_from", 0):
            profiler.reset_collective_records()
        state, m = step(state, local)
        host.append(time.perf_counter())
        metrics.append({k: float(v) for k, v in m.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter())
    launches = {k: v for k, v in LAUNCHES.items() if v}
    log(f"{run['name']}: {len(metrics)} steps "
        f"{[round(x['loss'], 5) for x in metrics]}, launches {launches}")
    records = profiler.collective_report()
    own = {"rank": rank, "launches": launches,
           "coords": {k: v for k, v in mesh.coords().items()
                      if mesh.shape[k] > 1},
           "records": records}
    if dev.type == "cuda":
        own["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        own["build_peak_bytes"] = build_peak
    profiled = None
    if run.get("profile"):
        if rank == 0 and dev.type == "cuda":
            state, profiled = profile_steps(step, state, local, dev)
        else:
            for _ in range(2):
                state, _ = step(state, local)
    if run.get("save_dir"):
        saver = ckpt.AsyncCheckpointer(run["save_dir"])
        saver.save(ckpt.encode_portable(state), step=state.step, block=True)
        saver.close()
    every = [None] * td.get_world_size()
    td.all_gather_object(every, own)
    params = list(state.model.parameters())
    names = [n for n, _ in state.model.named_parameters()]
    differ = replicated_equal([p.detach() for p in params], params)
    if kept:
        differ += [f"grad:{i}" for i in replicated_equal(kept, params)]
    entry = {
        "metrics": metrics, "step": state.step, "build_s": build_s,
        "step_s": [b - a for a, b in zip([t0] + times, times)],
        "host_s": [h - a for a, h in zip([t0] + times, host)],
        "counts": {n: [p.numel(), int(np.prod(layout_of(p).shape))
                       if layout_of(p) is not None else p.numel()]
                   for n, p in zip(names, params)},
        "layers_held": len(state.model.layers),
        "slot_elements": sum(t.numel() for slot in ("mu", "nu", "trace")
                             for t in getattr(state.opt_state, slot, None)
                             or ()),
        "replicated_differ": [names[i] if isinstance(i, int)
                              else f"grad of {names[int(i[5:])]}"
                              for i in differ],
        "ranks": every, "profile": profiled,
        "mesh": {k: v for k, v in mesh.shape.items() if v > 1}}
    dumps = {}
    if run.get("dump", True):
        dumps[""] = gather_stages(mesh, by_whole_name(state.model, params))
    if run.get("dump_opt"):
        for slot in ("mu", "nu"):
            dumps[f".{slot}"] = gather_stages(mesh, by_whole_name(
                state.model, getattr(state.opt_state, slot)))
    grads = gather_stages(mesh, by_whole_name(state.model, kept)) \
        if (run.get("reference") or run.get("dump_grads")) and kept else None
    if run.get("dump_grads"):
        dumps[".grads"] = grads
    del state, model, params, kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if run.get("reference") and rank == 0:
        entry["reference"] = reference(cfg, run, tokens, dev, grads)
        log(f"{run['name']}: one-device reference "
            f"{entry['reference']['loss']:.5f}")
    if rank == 0:
        for tag, tensors in dumps.items():
            np.savez(f"{out}.{run['name']}{tag}.npz", **tensors)
    return entry


def run_config(cfg_path, out):
    cfg = json.loads(Path(cfg_path).read_text())
    device = cfg.get("device", "cpu")
    if device == "cpu":
        # Several ranks share the host's cores: one thread each.
        torch.set_num_threads(1)
    assert dist.initialize(device=device), "expected a multi-process TonY env"
    rank = td.get_rank()
    # Every mesh first, in the same order on every rank: their process
    # groups are created collectively.
    meshes = {}
    for r in cfg["runs"]:
        key = (r.get("dp", 0), r.get("pp", 1))
        if key not in meshes:
            meshes[key] = MeshSpec(dp=key[0], pp=key[1]).build(
                device=None if device == "cuda" else device)
            warm(meshes[key])
    report = {}
    for run in cfg["runs"]:
        mesh = meshes[(run.get("dp", 0), run.get("pp", 1))]
        if run.get("kind") == "toy":
            entry, arrays = toy_run(cfg, run, mesh)
            if rank == 0:
                np.savez(f"{out}.{run['name']}.npz", **arrays)
        else:
            entry = decoder_run(cfg, run, mesh, out, rank)
        if rank == 0:
            report[run["name"]] = entry
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
        td.barrier()
    if rank == 0:
        Path(f"{out}.json").write_text(json.dumps(report))
    td.barrier()
    td.destroy_process_group()


def run_knobs():
    """The example's run: MODEL, MESH_PP, MICROBATCHES, STEPS, BATCH,
    SEQ."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cpu":
        torch.set_num_threads(1)
    if not dist.initialize(device=device):
        # One process outside a job: a world of one.
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        td.init_process_group("nccl" if device == "cuda" else "gloo",
                              init_method=f"tcp://127.0.0.1:{port}",
                              rank=0, world_size=1)
    pp = int(os.environ.get("MESH_PP", str(min(2, td.get_world_size()))))
    mesh = MeshSpec(pp=pp).build(device=None if device == "cuda" else device)
    microbatches = int(os.environ.get("MICROBATCHES", str(2 * pp)))
    name = os.environ.get("MODEL", "llama-tiny")
    model = get_model(name, device=mesh.device)
    cfg = model.cfg
    dp = mesh.shape[DATA]
    batch = int(os.environ.get("BATCH", str(microbatches * dp)))
    seq = min(cfg.max_seq, int(os.environ.get("SEQ", "64")))
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, (batch, seq))
    index, count = mesh.batch_index()
    rows = batch // count
    state = train.create_train_state(model, train.adamw(3e-4), mesh=mesh)
    step = train.make_train_step(
        loss_of=next_token, mesh=mesh,
        forward=pipelined(mesh, {"microbatches": microbatches}))
    local = train.global_batch(
        mesh, {"x": tokens[index * rows:(index + 1) * rows]})
    losses = []
    for i in range(int(os.environ.get("STEPS", "5"))):
        state, metrics = step(state, local)
        losses.append(float(metrics["loss"]))
        if td.get_rank() == 0:
            print(f"step {i} loss {losses[-1]:.4f}", flush=True)
    if td.get_rank() == 0:
        Path("pp_losses.json").write_text(json.dumps({
            "model": name, "mesh": {k: v for k, v in mesh.shape.items()
                                    if v > 1},
            "microbatches": microbatches, "losses": losses}))
    td.destroy_process_group()


if __name__ == "__main__":
    if len(sys.argv) > 2:
        run_config(sys.argv[1], sys.argv[2])
    else:
        run_knobs()
