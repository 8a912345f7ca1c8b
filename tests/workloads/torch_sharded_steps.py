"""One rank of the port's tensor- and sequence-parallel train step: the
port's counterpart of ``examples/jax_llama_sharded.py``, for ``tony
submit --framework pytorch`` (one worker a card), for
``tests/test_torch_tp.py`` (gloo ranks on the CPU) and for the
``--sharded-cards-only`` run of ``chip_smoke.py`` (one NCCL rank a card).

Without arguments it reads the example's knobs: ``MODEL``
(llama-tiny|llama2-7b), ``MESH_TP``, ``MESH_SP``, ``STEPS``, ``SEQ``,
``BATCH`` (the global batch; default 2 per data index), and trains
``adamw(3e-4)`` on ``MeshSpec(sp=, tp=)`` over the whole world, with ring
attention when ``MESH_SP > 1``, on seeded random tokens; rank 0 prints
each step and writes ``result.json`` (model, mesh, losses).

``python torch_sharded_steps.py <config.json> <out prefix>`` runs the
config's ``runs`` instead, each on its own mesh ``MeshSpec(dp=, sp=,
tp=)`` over the whole world: the model (``model``, ``model_kwargs`` and
the run's on top; ``attention``), the device (``device``), the weights
(``init``: an ``.npz`` of whole parameters by the port's names, or
``seed``), the global batch (``batch``: an ``.npz`` with ``x`` [B, T],
or ``batch_shape`` [B, T] of seeded tokens; a run's own ``batch_shape``
wins), ``tx`` (``{"rule": "sgd" | "adamw", ...}``, or ``{"rule":
"capture"}``, which keeps each step's reduced grads and updates
nothing), ``steps`` steps of ``make_train_step`` with the next-token
loss on this rank's ``[B/dp, T/sp]`` shard (through ``train_loop`` with
``"loop": true``; the collective records cover the steps from
``records_from`` on; with ``"profile": true`` two more steps after
them, rank 0's second under ``torch.profiler`` on the card: its wall
time and device time by kernel group), optionally restored from a saved
step first
(``restore_dir``) and saved after the steps (``save_dir``);
``"logits": true`` first runs the forward alone and writes the whole
logits, assembled from the ranks' blocks
(``<prefix>.<run>.logits.npy``). With ``"reference": true`` rank 0
then runs the same steps on its device alone, no mesh, on the whole
batch (the run's attention, flash in place of the ring) and reports
their losses, and with the capture rule each parameter's relative L2
distance between its grads and the mesh's (gathered over the model
group). Rank 0 writes, per run, the metrics of every step, the wall
time of each and the time the host took to queue it, every rank's
kernel launches in the steps (``ops.LAUNCHES``, set to 0 before them)
and mesh coordinates, each parameter's local and global element counts,
whether every replicated leaf (and its grad, with the capture rule) is
bitwise equal on every rank, the collective records (the model axis'
all-reduce bytes, the ring's send/recv bytes, the grad reduce) and on
the card every rank's peak memory (``<prefix>.json``), and the whole
parameters (``<prefix>.<run>.npz``, unless ``"dump": false``; with
``"dump_opt": true`` also AdamW's moments,
``<prefix>.<run>.mu.npz``/``.nu.npz``). Imports only the port, torch and
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
from tony_tpu_torch.ops import LAUNCHES
from tony_tpu_torch.parallel import (BATCH_AXES, DATA, MODEL, SEQ,
                                     MeshSpec, layout_of)
from tony_tpu_torch.parallel.overlap import attach_like, full_params


def log(msg):
    print(f"[rank {td.get_rank()} {time.strftime('%H:%M:%S')}] {msg}",
          file=sys.stderr, flush=True)


def capture(kept):
    """A transformation that keeps each step's grads in ``kept`` and
    leaves the parameters as they are."""
    def update(grads, state, params):
        kept[:] = [g.detach() for g in grads]
        return state
    return train.GradientTransformation(lambda params: None, update)


def next_token(out, b):
    return train.next_token_loss(out, b["x"])


def build_model(cfg, run, device, mesh):
    kwargs = dict(cfg.get("model_kwargs", {}), **run.get("model_kwargs", {}))
    if "dtype" in kwargs:
        kwargs["dtype"] = getattr(torch, kwargs["dtype"])
    if run.get("attention"):
        kwargs["attention"] = run["attention"]
    if mesh is not None and kwargs.get("attention") == "ring":
        kwargs["mesh"] = mesh
    model = get_model(cfg["model"], device=device, seed=cfg.get("seed", 0),
                      **kwargs)
    if cfg.get("init"):
        with torch.no_grad():
            for name, arr in np.load(cfg["init"]).items():
                model.get_parameter(name).copy_(torch.from_numpy(arr))
    return model


def make_tx(run, kept):
    tx = dict(run["tx"])
    rule = tx.pop("rule")
    return capture(kept) if rule == "capture" else getattr(train, rule)(**tx)


def global_tokens(cfg, run):
    if cfg.get("batch") and "batch_shape" not in run:
        return np.load(cfg["batch"])["x"]
    b, t = run.get("batch_shape") or cfg["batch_shape"]
    vocab = cfg.get("vocab", 32000)
    return np.random.RandomState(cfg.get("seed", 0) + 1).randint(
        0, vocab, (b, t)).astype(np.int64)


def warm(mesh):
    """Bring up the communicators of the mesh's model group and seq ring
    (NCCL builds them at their first use) before any timed step."""
    x = torch.ones(1, device=mesh.device)
    for axis in (MODEL, SEQ):
        if mesh.shape[axis] > 1:
            td.all_reduce(x, group=mesh.group((axis,)))
    if mesh.shape[SEQ] > 1:
        y = torch.empty_like(x)
        group = mesh.group((SEQ,))
        for req in td.batch_isend_irecv([
                td.P2POp(td.isend, x, mesh.peer(SEQ, 1), group),
                td.P2POp(td.irecv, y, mesh.peer(SEQ, -1), group)]):
            req.wait()


def replicated_equal(tensors, params):
    """Whether each replicated leaf of ``tensors`` (a parameter's layout
    unsharded) has the same bits on every rank: the names that differ."""
    differ = []
    for i, (t, p) in enumerate(zip(tensors, params)):
        lay = layout_of(p)
        if lay is not None and lay.sharded:
            continue
        every = [torch.empty_like(t) for _ in range(td.get_world_size())]
        td.all_gather(every, t.contiguous())
        if not all(torch.equal(every[0], e) for e in every):
            differ.append(i)
    return differ


def profile_steps(step, state, batch, dev):
    """Two more steps, the second recorded by ``torch.profiler`` (the
    first is its warm-up: a session's first kernel records are often
    lost): that step's wall ms and this card's device ms by kernel group
    (GEMMs, the flash kernels, NCCL's collectives, elementwise, other)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            prof.step()
    groups = dict.fromkeys(("gemm", "flash_attention", "nccl",
                            "elementwise", "other"), 0.0)
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA \
                or e.key.startswith("ProfilerStep"):
            # The step's own annotation spans the whole step.
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        low = e.key.lower()
        if "nccl" in low:
            groups["nccl"] += ms
        elif "flash_" in low and "kernel" in low:
            groups["flash_attention"] += ms
        elif any(w in low for w in ("gemm", "nvjet", "cutlass", "sm90_xmma",
                                    "cublas")):
            groups["gemm"] += ms
        elif "elementwise" in low:
            groups["elementwise"] += ms
        else:
            groups["other"] += ms
    return state, {"step_wall_ms": 1e3 * wall, "device_ms_by_group": groups}


def whole_logits(model, local, mesh):
    """The forward's logits of the global batch on rank 0 (None on the
    others), each rank's ``[B/dp, T/sp, V/tp]`` block placed by its
    coordinates."""
    with torch.no_grad():
        mine = model(local).logits.contiguous()
    every = [torch.empty_like(mine) for _ in range(td.get_world_size())]
    td.all_gather(every, mine)
    if td.get_rank():
        return None
    b, t, v = mine.shape
    shape = mesh.shape
    out = torch.empty((b * mesh.size(BATCH_AXES), t * shape[SEQ],
                       v * shape[MODEL]))
    for r, blk in enumerate(every):
        c = mesh.coords(r)
        bi = mesh.index(BATCH_AXES, c)
        out[bi * b:(bi + 1) * b, c[SEQ] * t:(c[SEQ] + 1) * t,
            c[MODEL] * v:(c[MODEL] + 1) * v] = blk.cpu()
    return out.numpy()


def rel_l2(names, got, ref):
    out = {}
    for name, a, b in zip(names, got, ref):
        norm = b.float().norm()
        diff = (a.float() - b.float()).norm()
        out[name] = float(diff / norm) if float(norm) else float(diff)
    return out


def reference(cfg, run, tokens, device, whole_grads, names):
    """Rank 0's run on its device alone, no mesh: the run's steps with its
    tx on the whole batch; with the capture rule each parameter's
    relative L2 distance between the mesh's grads and these."""
    kept = []
    ref_run = dict(run, attention="flash" if run.get("attention") == "ring"
                   else run.get("attention"))
    model = build_model(cfg, ref_run, device, None)
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
        out["grad_rel_l2"] = rel_l2(names, whole_grads, kept)
    del state, model, kept
    return out


def run_config(cfg_path, out):
    cfg = json.loads(Path(cfg_path).read_text())
    device = cfg.get("device", "cpu")
    if device == "cpu":
        # Several ranks share the host's cores: one thread each.
        torch.set_num_threads(1)
    assert dist.initialize(device=device), "expected a multi-process TonY env"
    rank, world = td.get_rank(), td.get_world_size()
    # Every mesh first, in the same order on every rank: their process
    # groups are created collectively.
    meshes = {}
    for r in cfg["runs"]:
        key = (r.get("dp", 0), r.get("sp", 1), r.get("tp", 1))
        if key not in meshes:
            meshes[key] = MeshSpec(dp=key[0], sp=key[1], tp=key[2]).build(
                device=None if device == "cuda" else device)
            warm(meshes[key])
    report = {}
    for run in cfg["runs"]:
        mesh = meshes[(run.get("dp", 0), run.get("sp", 1), run.get("tp", 1))]
        tokens = global_tokens(cfg, run)
        dev = mesh.device
        profiler.reset_collective_records()
        kept = []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        log(f"{run['name']}: building")
        t_build = time.perf_counter()
        model = build_model(cfg, run, dev, mesh)
        state = train.create_train_state(model, make_tx(run, kept),
                                         mesh=mesh)
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
        if run.get("logits"):
            logits = whole_logits(state.model, local["x"], mesh)
            if rank == 0:
                np.save(f"{out}.{run['name']}.logits.npy", logits)
        step = train.make_train_step(loss_of=next_token, mesh=mesh)
        metrics, times, host = [], [], []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)

        def on_step(i, m):
            # The host has queued the step when it returns; the card may
            # still be running it.
            host.append(time.perf_counter())
            metrics.append({k: float(v) for k, v in m.items()})
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append(time.perf_counter())

        # The kernels' launches of these steps alone.
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        t0 = time.perf_counter()
        if run.get("loop"):
            state, _ = train.train_loop(
                state, step, (local for _ in range(run["steps"])),
                on_step=on_step)
        else:
            for i in range(run["steps"]):
                if i == run.get("records_from", 0):
                    profiler.reset_collective_records()
                state, m = step(state, local)
                on_step(i, m)
        launches = {k: v for k, v in LAUNCHES.items() if v}
        log(f"{run['name']}: {len(metrics)} steps "
            f"{[round(x['loss'], 5) for x in metrics]}, launches {launches}")
        records = profiler.collective_report()
        profiled = None
        if run.get("profile"):
            if rank == 0 and dev.type == "cuda":
                state, profiled = profile_steps(step, state, local, dev)
            else:
                for _ in range(2):
                    state, _ = step(state, local)
        if run.get("save_dir"):
            saver = ckpt.AsyncCheckpointer(run["save_dir"])
            saver.save(ckpt.encode_portable(state), step=state.step,
                       block=True)
            saver.close()
        params = list(state.model.parameters())
        names = [n for n, _ in state.model.named_parameters()]
        own = {"rank": rank, "launches": launches,
               "coords": {k: v for k, v in mesh.coords().items()
                          if mesh.shape[k] > 1}}
        if dev.type == "cuda":
            own["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            own["build_peak_bytes"] = build_peak
        every = [None] * world
        td.all_gather_object(every, own)
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
            "replicated_differ": [names[i] if isinstance(i, int)
                                  else f"grad of {names[int(i[5:])]}"
                                  for i in differ],
            "ranks": every,
            "records": records, "profile": profiled,
            "mesh": {k: v for k, v in mesh.shape.items() if v > 1}}
        whole = full_params(params, mesh) if run.get("dump", True) else None
        moments = {}
        if run.get("dump_opt"):
            for slot in ("mu", "nu"):
                live = getattr(state.opt_state, slot)
                attach_like(live, params)
                moments[slot] = full_params(live, mesh)
        if run.get("reference"):
            grads = None
            if kept:
                attach_like(kept, params)
                grads = full_params(kept, mesh)
            del state, model, params, kept
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            if rank == 0:
                entry["reference"] = reference(cfg, run, tokens, dev, grads,
                                               names)
                log(f"{run['name']}: one-device reference "
                    f"{entry['reference']['loss']:.5f}")
            del grads
            state = model = params = None
        if rank == 0:
            report[run["name"]] = entry
            for tag, tensors in [("", whole)] + [
                    (f".{k}", v) for k, v in moments.items()]:
                if tensors is not None:
                    np.savez(f"{out}.{run['name']}{tag}.npz",
                             **{n: t.float().cpu().numpy()
                                for n, t in zip(names, tensors)})
        del state, model, params, whole, moments
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        td.barrier()
    if rank == 0:
        Path(f"{out}.json").write_text(json.dumps(report))
    td.barrier()
    td.destroy_process_group()


def run_knobs():
    """The example's run: MODEL, MESH_TP, MESH_SP, STEPS, SEQ, BATCH."""
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
    tp = int(os.environ.get("MESH_TP", "1"))
    sp = int(os.environ.get("MESH_SP", "1"))
    mesh = MeshSpec(sp=sp, tp=tp).build(
        device=None if device == "cuda" else device)
    name = os.environ.get("MODEL", "llama-tiny")
    kwargs = {"device": mesh.device,
              "attention": "ring" if sp > 1 else
              ("flash" if device == "cuda" else "reference")}
    if sp > 1:
        kwargs["mesh"] = mesh
    model = get_model(name, **kwargs)
    cfg = model.cfg
    batch = int(os.environ.get("BATCH", str(2 * mesh.shape[DATA])))
    seq = min(cfg.max_seq, int(os.environ.get("SEQ", "64")))
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, (batch, seq))
    index, count = mesh.batch_index()
    rows = batch // count
    state = train.create_train_state(model, train.adamw(3e-4), mesh=mesh)
    step = train.make_train_step(loss_of=next_token, mesh=mesh)
    local = train.global_batch(
        mesh, {"x": tokens[index * rows:(index + 1) * rows]})
    losses = []
    for i in range(int(os.environ.get("STEPS", "10"))):
        state, metrics = step(state, local)
        losses.append(float(metrics["loss"]))
        if td.get_rank() == 0:
            print(f"step {i}: loss {losses[-1]:.4f} grad_norm "
                  f"{float(metrics['grad_norm']):.3f}", flush=True)
    if td.get_rank() == 0:
        Path("result.json").write_text(json.dumps({
            "model": name, "mesh": {k: v for k, v in mesh.shape.items()
                                    if v > 1},
            "losses": losses}))
    td.destroy_process_group()


if __name__ == "__main__":
    if len(sys.argv) > 2:
        run_config(sys.argv[1], sys.argv[2])
    else:
        run_knobs()
