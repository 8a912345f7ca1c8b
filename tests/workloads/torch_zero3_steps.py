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
parameter; default: the model's logical axes), on the int8 gather lane
(``quant``: ``{"window": n}``, the state attached with
``with_gather_quant`` and the step built with ``quant=True``; with
``"amax": {leaf name: history}`` the histories start from those; with
``"roundtrip": true`` also ``gather_roundtrip_exact``), starting from a
saved state (``restore_dir``) and saving it after the steps
(``save_dir``); ``"equal_to": <an earlier run>`` compares every local
parameter with that run's after the steps (``torch.equal``, on every
rank: the whole parameters) and ``"dump": false`` skips the whole
parameters' file. A run may name its own ``model`` (with its own
``model_kwargs``), ``init``, ``batch``, ``targets`` and ``loss``, or add
``model_kwargs`` to the config's, drive its steps through
``train_loop`` (``"loop": true``), profile its last step on the card
(``"profile": true``: device-time sums of its NCCL and other rows beside
the wall time), and take one more step whose loss
raises (``"fail": true``); each run reports the hooks left on the model
after it (``hooks_left``, and ``after_raise``: the hooks left and
whether every parameter is back on its shard after the step that
raised). Per run it writes the metrics of every step, each
parameter's and slot's local and global element counts before and after
the steps, the whole parameters (gathered over fsdp;
``<prefix>.<run>.npz``, rank 0; not for a model above
``DUMP_LIMIT_BYTES``), the amax histories of a quantized run, the
collective, overlap and quant records, and on the card the build peak
(``max_memory_allocated`` once the state is built) and the step peak
(after a ``reset_peak_memory_stats()`` there) (``<prefix>.json``).
Imports only the port, torch and numpy.
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
from tony_tpu_torch.ops import quant
from tony_tpu_torch.ops.fused_optim import FusedOptimizer
from tony_tpu_torch.parallel import MeshSpec, layout_of
from tony_tpu_torch.parallel.overlap import full_params

# Whole models above this many bytes are not gathered and written out:
# the 32-layer 7B's 27 GB would take that much host memory and disk.
DUMP_LIMIT_BYTES = 8 << 30

cfg = json.loads(open(sys.argv[1]).read())
out = sys.argv[2]
device = cfg.get("device", "cpu")
assert dist.initialize(device=device), "expected a multi-process TonY env"
rank = dist.process_id()
mesh = MeshSpec(dp=cfg.get("dp", 0), fsdp=cfg["fsdp"]).build(
    device=None if device == "cuda" else device)
group = mesh.shape["data"] * mesh.shape["fsdp"]


def opt(run, key):
    """A run's own setting, else the config's."""
    return run.get(key, cfg.get(key))


def local_rows(path):
    """This rank's rows of the global batch in ``path``."""
    batch = {k: torch.from_numpy(v) for k, v in np.load(path).items()}
    rows = next(iter(batch.values())).shape[0] // group
    return {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}


def build(run):
    base = {} if "model" in run else cfg.get("model_kwargs", {})
    kwargs = dict(base, **run.get("model_kwargs", {}))
    if "dtype" in kwargs:
        kwargs["dtype"] = getattr(torch, kwargs["dtype"])
    model = get_model(opt(run, "model"), device=mesh.device, **kwargs)
    init = dict(np.load(opt(run, "init"))) if opt(run, "init") \
        and rank == 0 else None
    if init is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in init.items()})
    if run.get("update") == "fused_bucket":
        tx = FusedOptimizer(**run["tx"])
    else:
        tx = getattr(train, run["tx"].pop("rule"))(**run["tx"])
    state = train.create_train_state(
        model, tx, mesh=mesh, specs=run.get("specs", cfg.get("specs")))
    if run.get("quant"):
        state = quant.with_gather_quant(
            state, mesh, window=run["quant"]["window"],
            bucket_bytes=run.get("bucket_bytes", 4 << 20))
        if run["quant"].get("amax"):
            # Histories given by leaf name: each bucket takes its first
            # leaf's.
            params = list(model.parameters())
            names = [n for n, _ in model.named_parameters()]
            plan, gplan = quant._plans_of(
                params, mesh, run.get("bucket_bytes", 4 << 20))
            state.quant_state = {"amax": [
                torch.tensor(run["quant"]["amax"][names[plan.buckets[b][0]]],
                             dtype=torch.float32, device=mesh.device)
                for b in gplan.gather_buckets]}
    return model, state


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


def hooks_left(model):
    """Forward hooks on the model's modules and post-accumulate-grad
    hooks on its parameters: the step's own must all be gone."""
    return sum(len(m._forward_pre_hooks) + len(m._forward_hooks)
               for m in model.modules()) + sum(
        len(getattr(p, "_post_accumulate_grad_hooks", None) or {})
        for p in model.parameters())


def on_shards(model):
    """Every sharded parameter holds its shard (its layout's local
    shape)."""
    for p in model.parameters():
        lay = layout_of(p)
        if lay is not None and lay.sharded:
            want = list(lay.shape)
            want[lay.dim] //= mesh.shape["fsdp"]
            if list(p.shape) != want:
                return False
    return True


def amax_by_leaf(state, run):
    """A quantized state's histories by parameter name: each gathered
    leaf carries its bucket's."""
    params = list(state.model.parameters())
    names = [n for n, _ in state.model.named_parameters()]
    plan, gplan = quant._plans_of(params, mesh,
                                  run.get("bucket_bytes", 4 << 20))
    return {names[i]: state.quant_state["amax"][k].cpu().tolist()
            for k, b in enumerate(gplan.gather_buckets)
            for i in plan.buckets[b]}


def profiled_step(step, state, feed):
    """One step under ``torch.profiler`` (CPU and CUDA): its wall time
    between two synchronizes and sums of ``self_device_time_total`` over
    the profile's rows whose names hold "nccl" (``nccl_ms``) and over the
    others (``compute_ms``, with its top rows). A kernel's time counts
    under its own row and again under the row of the op that launched
    it (``record_param_comms`` for a collective)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, feed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.self_device_time_total > 0]
    nccl = sum(ms for name, ms in kernels if "nccl" in name.lower())
    compute = sorted(((ms, name) for name, ms in kernels
                      if "nccl" not in name.lower()), reverse=True)
    return state, m, {
        "wall_ms": wall * 1e3, "nccl_ms": nccl,
        "compute_ms": sum(ms for ms, _ in compute),
        "top": [[name[:80], ms] for ms, name in compute[:8]]}


class Injected(RuntimeError):
    pass


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


cuda = mesh.device.type == "cuda"
report = {"world": td.get_world_size(), "runs": {}}
# Runs a later run compares its parameters with: their local shards.
compared = {r.get("equal_to") for r in cfg["runs"].values()} - {None}
kept = {}
for name, run in cfg["runs"].items():
    run = json.loads(json.dumps(run))
    t_build = time.perf_counter()
    model, state = build(run)
    kw = {"apply_kwargs_of": (lambda b: {"targets": b["x"]})} \
        if opt(run, "targets") else {}
    if opt(run, "targets"):
        base_loss = lambda o, b: o                            # noqa: E731
    elif opt(run, "loss") == "next_token":
        base_loss = lambda o, b: train.next_token_loss(o, b["x"])  # noqa
    else:
        base_loss = lambda o, b: train.cross_entropy_loss(o, b["y"])  # noqa
    failing = []

    def loss_of(o, b, base_loss=base_loss, failing=failing):
        if failing:
            raise Injected("injected failure after the forward")
        return base_loss(o, b)
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
            bucket_bytes=run.get("bucket_bytes", 4 << 20),
            quant=bool(run.get("quant")), **kw)
    if run.get("restore_dir"):
        state = ckpt.decode_portable(ckpt.restore_pytree(
            run["restore_dir"], ckpt.encode_portable(state), mesh=mesh),
            mesh)
    roundtrip = quant.gather_roundtrip_exact(
        list(model.parameters()), mesh, run.get("bucket_bytes", 4 << 20)) \
        if run.get("roundtrip") else None
    before = storage(state)
    build_s = time.perf_counter() - t_build
    build_peak = 0
    if cuda:
        torch.cuda.synchronize()
        build_peak = torch.cuda.max_memory_allocated(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    profiler.reset_collective_records()
    profiler.reset_overlap_records()
    profiler.reset_quant_records()
    feed = train.global_batch(mesh, local_rows(opt(run, "batch")))
    metrics, times = [], []
    if run.get("loop"):
        state, _ = train.train_loop(
            state, step, [feed] * run["steps"],
            on_step=lambda i, m: metrics.append(
                {k: float(v) for k, v in m.items()}))
    prof = None
    for k in range(0 if run.get("loop") else run["steps"]):
        t0 = time.perf_counter()
        if run.get("profile") and cuda and k == run["steps"] - 1:
            state, m, prof = profiled_step(step, state, feed)
        else:
            state, m = step(state, feed)
        metrics.append({k: float(v) for k, v in m.items()})
        times.append(time.perf_counter() - t0)
    after_raise = None
    if run.get("fail"):
        failing.append(True)
        try:
            step(state, feed)
        except Injected:
            after_raise = {"hooks_left": hooks_left(model),
                           "on_shards": on_shards(model)}
        failing.clear()
    step_peak = torch.cuda.max_memory_allocated(mesh.device) if cuda else 0
    if hasattr(state.buckets, "check"):
        state.buckets.check()
    if run.get("save_dir"):
        saver = ckpt.AsyncCheckpointer(run["save_dir"])
        saver.save(ckpt.encode_portable(state), step=state.step, block=True)
        saver.close()
    names = [n for n, _ in model.named_parameters()]
    unequal = None
    if run.get("equal_to"):
        unequal = [n for n, a, b in zip(names, model.parameters(),
                                        kept[run["equal_to"]])
                   if not torch.equal(a.detach().cpu(), b)]
    if name in compared:
        # On the host, so no later run's device peak holds them.
        kept[name] = [p.detach().cpu() for p in model.parameters()]
    whole_bytes = sum(int(np.prod(layout_of(p).shape)) * p.element_size()
                      if layout_of(p) is not None
                      else p.numel() * p.element_size()
                      for p in model.parameters())
    dumped = run.get("dump", True) and whole_bytes <= DUMP_LIMIT_BYTES
    if dumped:
        whole = full_params(list(model.parameters()), mesh)
        if rank == 0:
            np.savez(f"{out}.{name}.npz", **{
                n: t.detach().float().cpu().numpy()
                for n, t in zip(names, whole)})
        del whole
    report["runs"][name] = {
        "metrics": metrics, "step_s": times, "before": before,
        "after": storage(state),
        "collectives": profiler.collective_report(),
        "overlap": profiler.overlap_report(),
        "quant": profiler.quant_report(),
        "amax": [h.cpu().tolist() for h in state.quant_state["amax"]]
        if run.get("quant") else None,
        "amax_by_leaf": amax_by_leaf(state, run) if run.get("quant")
        else None,
        "roundtrip_exact": roundtrip, "dumped": dumped,
        "unequal_to": unequal, "hooks_left": hooks_left(model),
        "profile": prof,
        "after_raise": after_raise,
        "whole_param_bytes": whole_bytes, "build_s": build_s,
        "build_peak_bytes": build_peak, "peak_bytes": step_peak}
    del model, state, step
with open(f"{out}.json", "w") as fh:
    json.dump(report, fh)
td.destroy_process_group()
