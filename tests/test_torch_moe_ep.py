"""Expert parallelism in the port, on the CPU: one spawned world of four
gloo ranks (tests/workloads/torch_moe_ep_steps.py) runs llama-moe-tiny's
``make_train_step`` on ``MeshSpec(dp=2, ep=2)`` and ``MeshSpec(ep=4)``,
each with one exchange each way and with two capacity chunks
(``MoEMLP.explicit_a2a``; one run under remat, one through
``train_loop``), held against the JAX package's ``make_train_step`` on
the same meshes over 4 of the 8 virtual CPU devices and against the
port's one-process step: loss, aux_loss, grad norm and every parameter
after two steps of SGD(0.5, momentum 0.9) within 1e-5 in f32 — the
expert grads are the reference's, not ``ep`` times them, although every
expert owner computes each row once for each of its ``ep`` peers. Each
rank holds ``E/ep`` experts and their slots; the
``moe.dispatch``/``moe.combine`` records carry the reference's per-rank
bytes; a step saved at ``dp=2 × ep=2`` restores at ``ep=4``, in one
process and into the JAX package's loader, equal; and what stays
unported names ROADMAP item 11."""

from __future__ import annotations

import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from tony_tpu import ckpt as jckpt
from tony_tpu import parallel as jpar
from tony_tpu import train as jtrain
from tony_tpu.models import get_model as jax_model
from tony_tpu_torch import ckpt
from tony_tpu_torch import train as ttrain
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params, params_from_jax
from tony_tpu_torch.ops import fused_optim as fo
from tony_tpu_torch.parallel import AXES, EXPERT, Mesh, MeshSpec

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).parent / "workloads" / "torch_moe_ep_steps.py"
WORLD = 4
TOL = 1e-5
LR = 0.5
STEPS = 2
MOMENTUM = 0.9
SGD = {"rule": "sgd", "learning_rate": LR, "momentum": MOMENTUM}
# name → (dp, ep, run settings)
RUNS = {
    "dp2_ep2": (2, 2, {"save_dir": "ck"}),
    "dp2_ep2_a2a2": (2, 2, {"a2a_chunks": 2,
                            "model_kwargs": {"remat": True}}),
    "ep4": (1, 4, {"loop": True}),
    "ep4_a2a2": (1, 4, {"a2a_chunks": 2}),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def _jax_init():
    """llama-moe-tiny's JAX weights and a global batch of 4 rows."""
    model = jax_model("llama-moe-tiny", dtype=jnp.float32)
    params = nn.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)))["params"]
    tokens = np.random.RandomState(7).randint(0, 256, (4, 16)).astype(
        np.int32)
    return model, jax.tree.map(np.asarray, params), tokens


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks' runs: the four steps above (the first saved after
    its steps), then that save restored at ep=4. The ranks start first
    and the JAX references are computed while they run."""
    root = tmp_path_factory.mktemp("moe_ep")
    _, params, tokens = _jax_init()
    np.savez(root / "init.npz", **{k: v.numpy() for k, v in
                                   params_from_jax(params).items()})
    np.savez(root / "batch.npz", x=tokens)
    runs = [dict(dict(name=name, dp=dp, ep=ep, steps=STEPS, tx=SGD, **kw),
                 **({"save_dir": str(root / kw["save_dir"])}
                    if "save_dir" in kw else {}))
            for name, (dp, ep, kw) in RUNS.items()]
    runs.append(dict(name="restore_ep4", dp=1, ep=4, steps=0, tx=SGD,
                     restore_dir=str(root / "ck")))
    cfg = dict(model="llama-moe-tiny", model_kwargs={"dtype": "float32"},
               init=str(root / "init.npz"), batch=str(root / "batch.npz"),
               runs=runs)
    (root / "cfg.json").write_text(json.dumps(cfg))
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT), os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(root / "cfg.json"),
             str(root / f"r{rank}")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        for dp, ep in {(dp, ep) for dp, ep, _ in RUNS.values()}:
            _jax_mesh_steps(dp, ep)
        _port_steps()
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log}"
    report = json.loads((root / "r0.json").read_text())
    return root, report


def _dump(root, run):
    return dict(np.load(root / f"r0.{run}.npz"))


@functools.lru_cache(maxsize=None)
def _jax_mesh_steps(dp, ep):
    """The JAX package's make_train_step on MeshSpec(dp=, ep=) over 4 of
    the 8 virtual devices: per-step metrics, the parameters after and the
    final state."""
    model, params, tokens = _jax_init()
    mesh = jpar.MeshSpec(dp=dp, ep=ep).build(jax.devices()[:WORLD])
    state = jtrain.create_train_state(model, optax.sgd(LR, momentum=MOMENTUM),
                                      jnp.asarray(tokens),
                                      jax.random.PRNGKey(0), mesh=mesh)
    wg = state.params["layers"]["block"]["moe_mlp"]["w_gate"]
    assert "expert" in tuple(wg.sharding.spec)
    state = state.replace(params=jax.tree.map(
        lambda a, ref: jax.device_put(a, ref.sharding), params,
        state.params))
    step = jtrain.make_train_step(
        loss_of=lambda lg, b: jtrain.next_token_loss(lg, b["x"]), mesh=mesh)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, {"x": jnp.asarray(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, state.params)).items()}, state


@functools.lru_cache(maxsize=None)
def _port_steps():
    """The port's step on one process, no mesh."""
    _, params, tokens = _jax_init()
    model = load_jax_params(get_model("llama-moe-tiny", device="cpu",
                                      dtype=torch.float32), params)
    state = ttrain.create_train_state(model, ttrain.sgd(LR, MOMENTUM))
    step = ttrain.make_train_step(
        loss_of=lambda lg, b: ttrain.next_token_loss(lg, b["x"]))
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, {"x": torch.from_numpy(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {n: p.detach().numpy().copy()
                     for n, p in model.named_parameters()}


def _close(got, ref, what):
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], atol=TOL, rtol=0,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("run", sorted(RUNS))
def test_steps_match_jax_mesh_and_one_process(world, run):
    root, report = world
    dp, ep, _ = RUNS[run]
    got = report[run]["metrics"]
    for ref_metrics, ref_params, what in (
            _jax_mesh_steps(dp, ep)[:2] + ("JAX",),
            _port_steps() + ("one process",)):
        assert len(got) == len(ref_metrics) == STEPS
        for g, r in zip(got, ref_metrics):
            for key in ("loss", "grad_norm", "aux_loss"):
                assert g[key] == pytest.approx(r[key], abs=TOL, rel=TOL), \
                    (what, key)
            assert g["aux_loss"] > 0
        _close(_dump(root, run), ref_params, f"{run} vs {what}")


@pytest.mark.parametrize("run", sorted(RUNS))
def test_each_rank_holds_its_experts(world, run):
    """E/ep experts of each expert leaf (and of its momentum trace),
    every other leaf whole; the experts' grads are reduced over the data
    axis alone, the rest over every rank."""
    _, report = world
    dp, ep, _ = RUNS[run]
    for name, (local, whole) in report[run]["counts"].items():
        want = whole // ep if name.split(".")[-1] in (
            "w_gate", "w_up", "w_down") else whole
        assert local == want, name
    recs = report[run]["records"]
    assert recs[ttrain.GRAD_REDUCE_TAG]["axes"] == ["data", "expert"]
    assert (ttrain.EXPERT_REDUCE_TAG in recs) == (dp > 1)
    n_local = sum(local for local, _ in report[run]["counts"].values())
    assert report[run]["slot_elems"] == n_local


@pytest.mark.parametrize("run", sorted(RUNS))
def test_exchange_records_carry_the_references_bytes(world, run):
    """Per chunk and per rank the [E, B/dp, C_c, D] slots: summed over
    the chunks E · B/dp · C · D · 4 bytes in f32 (tests/test_sched.py's
    formula)."""
    _, report = world
    dp, ep, kw = RUNS[run]
    chunks = kw.get("a2a_chunks", 1)
    e, b, d, t = 4, 4, 64, 16
    capacity = max(1, int(1.25 * t * 2 / e))
    for tag in ("moe.dispatch", "moe.combine"):
        rec = report[run]["records"][tag]
        assert (rec["kind"], rec["plane"], rec["axes"]) == (
            "all_to_all", "moe", ["expert"])
        assert rec["chunks"] == len(rec["nbytes"]) == chunks
        assert (rec["capacity"], rec["experts"]) == (capacity, e)
        assert sum(rec["nbytes"]) == e * (b // dp) * capacity * d * 4


def test_ep2_step_restores_at_ep4_in_one_process_and_in_jax(world):
    """The dp=2 × ep=2 step (data index 0 of each expert rank wrote its
    experts) restores at ep=4 and in one process to the ranks' gathered
    parameters bit for bit, at step 2; JAX restore_pytree reads the same
    parameters and momentum traces into a JAX template."""
    root, report = world
    saved = _dump(root, "dp2_ep2")
    assert report["restore_ep4"]["step"] == STEPS
    np.testing.assert_equal(_dump(root, "restore_ep4"), saved)
    model = get_model("llama-moe-tiny", device="cpu", dtype=torch.float32)
    state = ckpt.decode_portable(ckpt.restore_pytree(
        root / "ck", ckpt.encode_portable(ttrain.create_train_state(
            model, ttrain.sgd(LR, MOMENTUM)))))
    assert state.step == STEPS
    names = [n for n, _ in model.named_parameters()]
    np.testing.assert_equal({n: p.detach().numpy() for n, p in
                             model.named_parameters()}, saved)
    manifest = ckpt.read_manifest(root / "ck", STEPS)
    assert len({ch["file"] for ch in manifest["chunks"]}) == 2
    spec = {m["path"]: m["spec"] for m in manifest["leaves"]}
    assert spec[".params['layers']['block']['moe_mlp']['w_gate']"][:2] == \
        [None, "expert"]
    back = jckpt.restore_pytree(root / "ck", _jax_mesh_steps(2, 2)[2])
    assert int(back.step) == STEPS
    for tree, live in ((back.params, model.parameters()),
                       (back.opt_state[0].trace, state.opt_state.trace)):
        ref = params_from_jax(jax.tree.map(np.asarray, tree))
        for name, t in zip(names, live):
            np.testing.assert_array_equal(t.detach().numpy(),
                                          ref[name].numpy(), err_msg=name)


def test_unported_expert_pieces_name_item_11():
    shape = dict.fromkeys(AXES, 1)
    shape[EXPERT] = 2
    mesh = Mesh(shape=shape, processes=2, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="item 11"):
        ttrain.make_accum_train_step(mesh=mesh, microbatches=2)
    with pytest.raises(NotImplementedError, match="item 11"):
        MeshSpec(fsdp=2, ep=2).build(device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        ttrain.create_train_state(
            get_model("llama-moe-tiny", device="cpu"),
            fo.FusedOptimizer(rule="sgd"), mesh=mesh)
