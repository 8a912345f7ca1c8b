"""Pipeline parallelism in the port, on the CPU: one spawned world of
eight gloo ranks (tests/workloads/torch_pp_steps.py) runs every case of
tests/test_pipeline.py and tests/test_sched.py:389 on the port's
``MeshSpec(pp=)`` meshes (the data axis filling the world, as the
reference's meshes fill the 8 virtual devices), each held against the
JAX functions on the same inputs, made from a numpy seed: ``gpipe``
against the sequential stack at (pp, M) = (2, 4) and (4, 8), its grads,
dp × pp, ``gpipe_1f1b``'s outputs and grads against ``gpipe`` at four
stages, dp=2 × pp=4 grads and an SGD loop whose loss falls, within the
reference's tolerances (1e-5 for outputs; rtol 1e-4, atol 1e-5 for
grads, in f32). llama-tiny's ``pipelined_lm_logits`` on dp=4 × pp=2
equals the JAX package's and the port's own unpipelined forward, and
its steps (``make_train_step(forward=...)``) equal the reference
example's loop. The pipeline edges' records equal the reference's and
the counted bytes equal the sends. Checkpoints cross both ways: a port
pp=2 step restores into JAX and onto one rank, and a JAX step saved on
a dp=4 × pp=2 mesh restores into the port's pp=2 ranks, leaf for leaf.
On one process: the same loops in lockstep on one device, the pipe
ranks' shared batch block, the stage cut and its converter, the mesh's
pipe lines and the pairings that stay refused (item 11). The example's
knobs run through two ranks, and the two-worker TonY job trains at pp=2
through the port's ``tony submit --framework pytorch`` MiniPod."""

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
from tony_tpu import profiler as jprofiler
from tony_tpu import train as jtrain
from tony_tpu.models import get_model as jax_model
from tony_tpu.parallel import gpipe as jgpipe
from tony_tpu.parallel import gpipe_1f1b as jgpipe_1f1b
from tony_tpu.parallel import pipelined_lm_logits as jpipelined
from tony_tpu.parallel import stage_split as jstage_split
from torch_ranks import wait_ranks
from tony_tpu_torch import ckpt
from tony_tpu_torch import train as ttrain
from tony_tpu_torch.minipod import MiniPod
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params, params_from_jax
from tony_tpu_torch.ops.fused_optim import FusedOptimizer
from tony_tpu_torch.parallel import (AXES, PIPE, Mesh, MeshSpec, _lines,
                                     layout_of)
from tony_tpu_torch.parallel import pipeline as tpipe

ROOT = Path(__file__).resolve().parent.parent
WORKLOADS = Path(__file__).parent / "workloads"
WORKER = WORKLOADS / "torch_pp_steps.py"
WORLD = 8
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ADAM = {"rule": "adamw", "learning_rate": 1e-2, "weight_decay": 0.0}
LM_STEPS = 3
SAVED_STEPS = 2


def _toy_arrays():
    """The reference tests' inputs, from a numpy seed: ``a`` for d=16
    (up to 8 layers), ``b`` for d=8 (up to 4 layers) and ``edges`` for
    the records pin (test_sched.py:389, one layer a stage, scale 0.1)."""
    g = np.random.RandomState(0)
    return {
        "a": dict(w=(g.randn(8, 16, 16) * 0.3).astype(np.float32),
                  x=g.randn(16, 16).astype(np.float32)),
        "b": dict(w=(g.randn(4, 8, 8) * 0.3).astype(np.float32),
                  x=g.randn(16, 8).astype(np.float32)),
        "edges": dict(w=(g.randn(4, 8, 8) * 0.1).astype(np.float32),
                      x=g.randn(16, 8).astype(np.float32)),
    }


# name -> the toy run: the inputs, layers, pp (dp fills the world),
# microbatches, schedule and loss; the reference test it mirrors.
TOY_RUNS = {
    "seq_pp2_m4": dict(toy="a", layers=4, pp=2, microbatches=4),
    "seq_pp4_m8": dict(toy="a", layers=4, pp=4, microbatches=8),
    "grads_dp4_pp2": dict(toy="b", layers=2, pp=2, microbatches=2),
    "gpipe_pp4": dict(toy="a", layers=8, pp=4, microbatches=8, loss="sq"),
    "f1b_pp4": dict(toy="a", layers=8, pp=4, microbatches=8, loss="sq",
                    schedule="1f1b"),
    "f1b_dp2_pp4": dict(toy="b", layers=4, pp=4, microbatches=4, loss="sq",
                        schedule="1f1b", sgd_steps=5, lr=0.01),
    "edges_gpipe": dict(toy="edges", layers=4, pp=4, microbatches=4),
    "edges_1f1b": dict(toy="edges", layers=4, pp=4, microbatches=4,
                       schedule="1f1b"),
}
# The decoder runs: llama-tiny f32 from the JAX weights, batch 16 x 16,
# on dp=4 x pp=2.
LM_RUNS = {
    "lm_dp4_pp2": dict(pp=2, microbatches=4, steps=1, logits=True,
                       tx={"rule": "capture"}, dump_grads=True, dump=False),
    "lm_1f1b_dp4_pp2": dict(pp=2, microbatches=4, steps=1,
                            schedule="1f1b", tx={"rule": "capture"},
                            dump_grads=True, dump=False),
    "lm_train_dp4_pp2": dict(pp=2, microbatches=4, steps=LM_STEPS, tx=ADAM),
    "ckpt_pp2": dict(pp=2, microbatches=2, steps=SAVED_STEPS, tx=ADAM,
                     save_dir="ck", dump_opt=True),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh(rank=0, **sizes):
    shape = dict.fromkeys(AXES, 1)
    shape.update(sizes)
    return Mesh(shape=shape, processes=int(np.prod(list(shape.values()))),
                device=torch.device("cpu"), rank=rank)


def _stage_fn(p, x):
    def body(h, w):
        return jnp.tanh(h @ w), None
    h, _ = jax.lax.scan(body, x, p)
    return h


def _sequential(params, x):
    return _stage_fn(params, x)


def _loss(run, y):
    return (y ** 2).sum() if run.get("loss") == "sq" else y.sum()


@functools.lru_cache(maxsize=None)
def _jax_toy(name):
    """The JAX functions on the run's inputs on the reference's mesh
    (``MeshSpec(pp=)`` over the 8 virtual devices): the output, the
    param grads (stacked ``[L, D, D]``) and the input grads of gpipe or
    gpipe_1f1b, and of the sequential stack."""
    run = TOY_RUNS[name]
    arrays = _toy_arrays()[run["toy"]]
    w, x = jnp.asarray(arrays["w"][:run["layers"]]), jnp.asarray(arrays["x"])
    mesh = jpar.MeshSpec(pp=run["pp"]).build(jax.devices())
    fn = jgpipe_1f1b if run.get("schedule") == "1f1b" else jgpipe

    def loss_pp(p, xx):
        return _loss(run, fn(_stage_fn, jstage_split(p, run["pp"]), xx,
                             mesh, microbatches=run["microbatches"]))

    y = jax.jit(lambda p, xx: fn(_stage_fn, jstage_split(p, run["pp"]), xx,
                                 mesh, microbatches=run["microbatches"]))(
        w, x)
    gw, gx = jax.jit(jax.grad(loss_pp, argnums=(0, 1)))(w, x)
    sw, sx = jax.grad(lambda p, xx: _loss(run, _sequential(p, xx)),
                      argnums=(0, 1))(w, x)
    losses = []
    p = w
    grad = jax.jit(jax.value_and_grad(lambda q: loss_pp(q, x)))
    for _ in range(run.get("sgd_steps", 0)):
        val, g = grad(p)
        p = p - run["lr"] * g
        losses.append(float(val))
    return {"y": np.asarray(y), "gw": np.asarray(gw), "dx": np.asarray(gx),
            "seq_y": np.asarray(_sequential(w, x)), "seq_gw": np.asarray(sw),
            "seq_dx": np.asarray(sx), "losses": losses}


@functools.lru_cache(maxsize=None)
def _jax_init():
    """llama-tiny's JAX weights (f32) and a global batch of 16 x 16."""
    model = jax_model("llama-tiny", dtype=jnp.float32)
    tokens = np.random.RandomState(7).randint(0, 256, (16, 16)).astype(
        np.int32)
    params = nn.unbox(jax.jit(model.init)(jax.random.PRNGKey(0),
                                          jnp.asarray(tokens)))["params"]
    return jax.tree.map(np.asarray, params), tokens


@functools.lru_cache(maxsize=None)
def _jax_lm(microbatches, steps):
    """The reference example's loop (examples/jax_llama_pp.py) on dp=4 x
    pp=2: the pipelined logits and the grads of the initial weights,
    each step's loss over ``steps`` adam(1e-2) steps, and the final
    state."""
    params, tokens = _jax_init()
    model = jax_model("llama-tiny", dtype=jnp.float32)
    cfg = model.cfg
    mesh = jpar.MeshSpec(dp=4, pp=2).build(jax.devices())
    state = jtrain.create_train_state(
        model, optax.adam(1e-2), jnp.asarray(tokens),
        jax.random.PRNGKey(0), mesh=mesh)
    state = state.replace(params=jax.tree.map(
        lambda a, ref: jax.device_put(a, ref.sharding), params,
        state.params))

    def logits_of(p):
        return jpipelined(p, jnp.asarray(tokens), cfg, mesh, n_stages=2,
                          microbatches=microbatches)

    def loss_fn(p):
        return jtrain.next_token_loss(logits_of(p), jnp.asarray(tokens))

    @jax.jit
    def step(st):
        loss, grads = jax.value_and_grad(loss_fn)(st.params)
        return st.apply_gradients(grads=grads), loss

    logits = np.asarray(jax.jit(logits_of)(state.params))
    grads = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss_fn))(state.params))).items()}
    losses = []
    for _ in range(steps):
        state, loss = step(state)
        losses.append(float(loss))
    return logits, losses, grads, state


def _jax_save(root):
    """A JAX adamw state of llama-tiny after one step of make_train_step
    on a dp=4 x pp=2 mesh (its layers replicated over pipe), saved at
    ``root``."""
    params, tokens = _jax_init()
    model = jax_model("llama-tiny", dtype=jnp.float32)
    mesh = jpar.MeshSpec(dp=4, pp=2).build(jax.devices())
    state = jtrain.create_train_state(
        model, optax.adamw(1e-3), jnp.asarray(tokens),
        jax.random.PRNGKey(0), mesh=mesh)
    state = state.replace(params=jax.tree.map(
        lambda a, ref: jax.device_put(a, ref.sharding), params,
        state.params))
    step = jtrain.make_train_step(
        loss_of=lambda lg, b: jtrain.next_token_loss(lg, b["x"]), mesh=mesh,
        donate=False)
    state, _ = step(state, {"x": jnp.asarray(tokens)})
    saver = jckpt.AsyncCheckpointer(root)
    saver.save(state, step=1, block=True)
    saver.close()
    return state


def _jax_records():
    """The reference's pipeline-edge records on the edges run's mesh and
    inputs (tests/test_sched.py:389)."""
    arrays = _toy_arrays()["edges"]
    w, x = jnp.asarray(arrays["w"]), jnp.asarray(arrays["x"])
    mesh = jpar.make_mesh(pp=4)

    def stage_fn(p, mb):
        return jnp.tanh(mb @ p["w"][0])

    jprofiler.reset_collective_records()
    jgpipe(stage_fn, jstage_split({"w": w}, 4), x, mesh, microbatches=4)
    jgpipe_1f1b(stage_fn, jstage_split({"w": w}, 4), x, mesh,
                microbatches=4)
    return jprofiler.collective_report()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The eight ranks' runs, then the JAX save restored at pp=2. The
    JAX save comes first; the other JAX references are computed while
    the ranks run."""
    root = tmp_path_factory.mktemp("pp")
    params, tokens = _jax_init()
    np.savez(root / "init.npz", **{k: v.numpy() for k, v in
                                   params_from_jax(params).items()})
    np.savez(root / "batch.npz", x=tokens)
    for key, arrays in _toy_arrays().items():
        np.savez(root / f"toy_{key}.npz", **arrays)
    jax_state = _jax_save(root / "jax_ck")
    runs = [dict(run, name=name, kind="toy",
                 toy=str(root / f"toy_{run['toy']}.npz"))
            for name, run in TOY_RUNS.items()]
    runs += [dict(dict(run, name=name),
                  **({"save_dir": str(root / run["save_dir"])}
                     if "save_dir" in run else {}))
             for name, run in LM_RUNS.items()]
    runs.append(dict(name="restore_jax", pp=2, microbatches=2, steps=0,
                     tx={"rule": "adamw", "learning_rate": 1e-3},
                     restore_dir=str(root / "jax_ck"), dump_opt=True))
    cfg = dict(model="llama-tiny", model_kwargs={"dtype": "float32"},
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
             str(root / "r0")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        for name in TOY_RUNS:
            _jax_toy(name)
        _jax_lm(4, LM_STEPS)
        _jax_lm(2, SAVED_STEPS)
        records = _jax_records()
    except BaseException:
        for p in procs:
            p.kill()
        raise
    wait_ranks(procs, 300, "the pipeline-parallel ranks")
    report = json.loads((root / "r0.json").read_text())
    return root, report, jax_state, records


def _dump(root, run, tag=""):
    return dict(np.load(root / f"r0.{run}{tag}.npz"))


@pytest.mark.parametrize("run", ["seq_pp2_m4", "seq_pp4_m8"])
def test_gpipe_matches_sequential(world, run):
    """gpipe at (pp, M) = (2, 4) and (4, 8), the data axis filling the
    world: the output equals JAX's gpipe and the sequential stack."""
    root, _, _, _ = world
    got, ref = _dump(root, run), _jax_toy(run)
    np.testing.assert_allclose(got["y"], ref["y"], **OUT_TOL)
    np.testing.assert_allclose(got["y"], ref["seq_y"], **OUT_TOL)


def test_gpipe_grads_match_sequential(world):
    """The reversed chain's grads (summed over the data group) equal the
    unpipelined stack's and JAX's gpipe's; the input grad is stage 0's
    on every rank, not a sum over the pipe ranks (each computes the same
    loss from the same replicated output)."""
    root, _, _, _ = world
    got, ref = _dump(root, "grads_dp4_pp2"), _jax_toy("grads_dp4_pp2")
    np.testing.assert_allclose(got["gw"], ref["seq_gw"], **GRAD_TOL)
    np.testing.assert_allclose(got["gw"], ref["gw"], **GRAD_TOL)
    np.testing.assert_allclose(got["dx"], ref["seq_dx"], **GRAD_TOL)


def test_gpipe_composes_with_dp(world):
    """dp=4 x pp=2: each data index pipelines its own rows; the output
    equals the sequential stack on the whole batch."""
    root, report, _, _ = world
    got, ref = _dump(root, "grads_dp4_pp2"), _jax_toy("grads_dp4_pp2")
    assert report["grads_dp4_pp2"]["mesh"] == {"data": 4, "pipe": 2}
    np.testing.assert_allclose(got["y"], ref["seq_y"], **OUT_TOL)


def test_gpipe_rejects_indivisible_dp_batch():
    """A global batch that does not divide over the data indexes raises
    naming both numbers (pipeline_blocks takes the global batch);
    a rank's rows that do not divide into the microbatches raise too."""
    w = torch.zeros(2, 8, 8)
    x = torch.zeros(15, 8)
    fn = lambda p, h: torch.tanh(h @ p[0])  # noqa: E731
    for schedule in tpipe.SCHEDULES:
        with pytest.raises(ValueError, match="15.*4"):
            tpipe.pipeline_blocks(fn, list(w.split(1)), x, x, 1,
                                  schedule=schedule, dp=4)
    with pytest.raises(ValueError, match="per-DP-group batch 3 .*"
                                         "microbatches=2"):
        tpipe._local_batch(12, 4, 2)


def test_gpipe_1f1b_matches_gpipe_4_stages(world):
    """The 1F1B schedule's outputs equal gpipe's (the port's and JAX's)
    and the sequential stack's on a 4-stage mesh."""
    root, _, _, _ = world
    got, ref = _dump(root, "f1b_pp4"), _jax_toy("f1b_pp4")
    np.testing.assert_allclose(got["y"], _dump(root, "gpipe_pp4")["y"],
                               **OUT_TOL)
    np.testing.assert_allclose(got["y"], ref["y"], **OUT_TOL)
    np.testing.assert_allclose(got["y"], ref["seq_y"], **OUT_TOL)


def test_gpipe_1f1b_grads_match_gpipe_4_stages(world):
    """The recomputing reverse chain gives gpipe's param and input grads
    on a 4-stage mesh (the port's and JAX's)."""
    root, _, _, _ = world
    got, gp = _dump(root, "f1b_pp4"), _dump(root, "gpipe_pp4")
    ref = _jax_toy("f1b_pp4")
    for key in ("gw", "dx"):
        np.testing.assert_allclose(got[key], gp[key], **GRAD_TOL)
        np.testing.assert_allclose(got[key], ref[key], **GRAD_TOL)


def test_gpipe_1f1b_composes_with_dp_and_trains(world):
    """dp=2 x pp=4: the stage grads summed over the data group equal the
    sequential stack's, and five SGD steps on the stages follow JAX's
    losses down."""
    root, report, _, _ = world
    got, ref = _dump(root, "f1b_dp2_pp4"), _jax_toy("f1b_dp2_pp4")
    np.testing.assert_allclose(got["gw"], ref["seq_gw"], **GRAD_TOL)
    losses = report["f1b_dp2_pp4"]["losses"]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("schedule", ["gpipe", "gpipe_1f1b"])
def test_pipeline_edges_registered(world, schedule):
    """Each rank's ``<tag>.ppermute`` record equals the reference's
    (per-tick microbatch bytes, forward only or both ways), the overlap
    record carries the ticks, and the counted sends are the bytes the
    chain moves: a stage sends its M outputs on unless it is the last,
    and its M input grads back unless it is the first."""
    _, report, _, records = world
    run = "edges_gpipe" if schedule == "gpipe" else "edges_1f1b"
    ref = records[f"{schedule}.ppermute"]
    mb_bytes = (16 // 2 // 4) * 8 * 4
    m, s_count = 4, 4
    for rank in report[run]["ranks"]:
        rec = rank["records"][f"{schedule}.ppermute"]
        assert {k: rec[k] for k in ref} == ref
        assert set(rec["nbytes"]) == {mb_bytes}
        ticks = m + s_count - 1
        assert rank["overlap"][schedule]["ticks"] == (
            ticks if schedule == "gpipe" else 2 * ticks)
        s = rank["coords"]["pipe"]
        sends = m * ((s < s_count - 1) + (s > 0))
        sent = rank["records"][f"{schedule}.send_recv"]
        assert (sent["calls"], sent["nbytes_total"]) == (sends,
                                                         sends * mb_bytes)
        assert sent["axes"] == [PIPE]


def test_pipelined_logits_match_jax_and_the_unpipelined_forward(world):
    """llama-tiny's pipelined_lm_logits on dp=4 x pp=2 (each rank's rows
    assembled by data index) equals the JAX package's on the same
    weights and the port's own unpipelined forward within 1e-5."""
    root, _, _, _ = world
    got = np.load(root / "r0.lm_dp4_pp2.logits.npy")
    ref_logits, _, _, _ = _jax_lm(4, LM_STEPS)
    params, tokens = _jax_init()
    model = get_model("llama-tiny", device="cpu", dtype=torch.float32)
    load_jax_params(model, params)
    with torch.no_grad():
        own = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, ref_logits, **OUT_TOL)
    np.testing.assert_allclose(got, own, **OUT_TOL)


@pytest.mark.parametrize("run", ["lm_dp4_pp2", "lm_1f1b_dp4_pp2"])
def test_pipelined_step_grads_match_the_example(world, run):
    """One make_train_step(forward=pipelined_lm_logits) on dp=4 x pp=2,
    both schedules: the loss within 1e-5 of the reference example's and
    every parameter's grad (summed over the data group; each stage's
    from its ranks) within its grad tolerance. Each rank holds its
    stage's layer and that layer's slots, and the replicated leaves and
    their grads are bitwise equal on every rank."""
    root, report, _, _ = world
    entry = report[run]
    _, ref_losses, ref_grads, _ = _jax_lm(4, LM_STEPS)
    assert entry["metrics"][0]["loss"] == pytest.approx(
        ref_losses[0], abs=1e-5, rel=1e-5)
    got = _dump(root, run, ".grads")
    assert sorted(got) == sorted(ref_grads)
    for name, ref in ref_grads.items():
        np.testing.assert_allclose(got[name], ref, err_msg=name, **GRAD_TOL)
    assert entry["layers_held"] == 1
    assert entry["replicated_differ"] == []
    counts = entry["counts"]
    assert all(c[1] == 2 * c[0] for n, c in counts.items()
               if n.startswith("layers."))
    assert all(c[1] == c[0] for n, c in counts.items()
               if not n.startswith("layers."))


def test_pipelined_steps_train_as_the_example(world):
    """Three adam(1e-2) steps through the pipeline on dp=4 x pp=2 follow
    the reference example's losses within 1e-5, and the loss falls; the
    AdamW slots are the stage's."""
    _, report, _, _ = world
    entry = report["lm_train_dp4_pp2"]
    _, ref_losses, _, _ = _jax_lm(4, LM_STEPS)
    losses = [m["loss"] for m in entry["metrics"]]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=1e-5)
    assert losses[-1] < losses[0]
    local = sum(c[0] for c in entry["counts"].values())
    assert entry["slot_elements"] == 2 * local


def test_port_pp_save_restores_into_jax_and_onto_one_rank(world):
    """The port's pp=2 save (each stage's rank of data index 0 wrote its
    layers as chunks of the stacked [L, ...] leaves, spec ("pipe", ...);
    rank 0 the replicated leaves) restores leaf for leaf into a JAX
    template and into the port's whole model on one rank: parameters and
    AdamW moments."""
    root, report, _, _ = world
    assert report["ckpt_pp2"]["step"] == SAVED_STEPS
    tmpl = _jax_lm(2, SAVED_STEPS)[3]
    back = jckpt.restore_pytree(root / "ck", tmpl)
    assert int(back.step) == SAVED_STEPS
    for tree, tag in ((back.params, ""), (back.opt_state[0].mu, ".mu"),
                      (back.opt_state[0].nu, ".nu")):
        got = _dump(root, "ckpt_pp2", tag)
        for name, t in params_from_jax(jax.tree.map(np.asarray,
                                                    tree)).items():
            np.testing.assert_array_equal(t.numpy(), got[name],
                                          err_msg=f"{tag} {name}")
    manifest = jckpt.read_manifest(root / "ck", SAVED_STEPS)
    spec = {m["path"]: m["spec"] for m in manifest["leaves"]}
    assert spec[".params['layers']['block']['mlp']['w_gate']['kernel']"] \
        == ["pipe", None, None]
    model = get_model("llama-tiny", device="cpu", dtype=torch.float32)
    state = ttrain.create_train_state(model, ttrain.adamw(1e-2))
    state = ckpt.decode_portable(ckpt.restore_pytree(
        root / "ck", ckpt.encode_portable(state)))
    assert state.step == SAVED_STEPS and state.opt_state.count == SAVED_STEPS
    want = _dump(root, "ckpt_pp2")
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name],
                                      err_msg=name)
    mu = _dump(root, "ckpt_pp2", ".mu")
    for (name, _), t in zip(model.named_parameters(), state.opt_state.mu):
        np.testing.assert_array_equal(t.numpy(), mu[name], err_msg=name)


def test_jax_save_restores_into_the_pp_mesh(world):
    """The step JAX saved on dp=4 x pp=2 (layers replicated over pipe)
    restores into the port's pp=2 ranks leaf for leaf: each stage's
    layers, the replicated leaves and the AdamW moments."""
    root, report, jax_state, _ = world
    assert report["restore_jax"]["step"] == 1
    assert report["restore_jax"]["layers_held"] == 1
    for tree, tag in ((jax_state.params, ""),
                      (jax_state.opt_state[0].mu, ".mu"),
                      (jax_state.opt_state[0].nu, ".nu")):
        got = _dump(root, "restore_jax", tag)
        ref = params_from_jax(jax.tree.map(np.asarray, tree))
        assert sorted(got) == sorted(ref)
        for name, t in ref.items():
            np.testing.assert_array_equal(got[name], t.numpy(),
                                          err_msg=f"{tag} {name}")


def test_one_device_lockstep_matches_the_sequential_stack():
    """pipeline_blocks: every stage's loop on one device in lockstep,
    both schedules, at 4 stages x 2 data indexes: output, stage grads and
    input grad equal the sequential stack's autograd."""
    arrays = _toy_arrays()["a"]
    w = torch.from_numpy(arrays["w"])
    x = torch.from_numpy(arrays["x"])
    dy = torch.from_numpy(np.random.RandomState(3).randn(16, 16)
                          .astype(np.float32))
    wr, xr = w.clone().requires_grad_(), x.clone().requires_grad_()
    h = xr
    for layer in wr.unbind(0):
        h = torch.tanh(h @ layer)
    h.backward(dy)

    def stage_fn(p, hh):
        for layer in p.unbind(0):
            hh = torch.tanh(hh @ layer)
        return hh

    staged = [t.clone().requires_grad_() for t in tpipe.stage_split(w, 4)]
    for schedule in tpipe.SCHEDULES:
        y, grads, dx = tpipe.pipeline_blocks(stage_fn, staged, x, dy, 4,
                                             schedule=schedule, dp=2)
        np.testing.assert_allclose(y.detach().numpy(), h.detach().numpy(),
                                   **OUT_TOL)
        np.testing.assert_allclose(torch.cat([g[0] for g in grads]).numpy(),
                                   wr.grad.numpy(), **GRAD_TOL)
        np.testing.assert_allclose(dx.numpy(), xr.grad.numpy(), **GRAD_TOL)


def test_shared_weight_casts_keep_one_copy_and_the_grads():
    """Within shared_weight_casts a Dense of f32 weights computing in
    bf16 casts its weight once for every call (one tensor, one autograd
    node; one with grad and one without), and the outputs and the f32
    grads of the weight and the inputs equal casting at every use."""
    from tony_tpu_torch.models import transformer as tmod

    dense = tmod.Dense(8, 4, torch.bfloat16, torch.float32,
                       torch.device("cpu"))
    torch.nn.init.normal_(dense.weight)
    xs = [torch.randn(3, 8, generator=torch.Generator().manual_seed(i))
          .requires_grad_() for i in range(3)]

    def run():
        ys = [dense(x) for x in xs]
        grads = [torch.autograd.grad(y, [dense.weight, x],
                                     torch.ones_like(y))
                 for y, x in zip(ys, xs)]
        return ys, sum(g[0] for g in grads), [g[1] for g in grads]

    plain = run()
    cast = lambda: tmod._cast(dense.weight, torch.bfloat16)  # noqa: E731
    assert cast() is not cast()
    with tmod.shared_weight_casts():
        shared = run()
        assert cast() is cast()
        with torch.no_grad():
            assert cast() is cast() and cast().grad_fn is None
        assert cast().grad_fn is not None
    assert cast() is not cast()
    for a, b in zip(shared[0], plain[0]):
        assert torch.equal(a, b)
    assert torch.equal(shared[1], plain[1])
    for a, b in zip(shared[2], plain[2]):
        assert torch.equal(a, b)


def test_pipe_ranks_share_one_batch_block():
    """The ranks along pipe read the same batch block (pipe is not a
    batch axis, as in the reference): on dp=2 x pp=2 a rank's block is
    its data index, and global_batch hands the pipe ranks the same
    rows; the pipe lines are the stage chains of each data index."""
    x = np.arange(8 * 4).reshape(8, 4)
    for rank in range(4):
        mesh = _mesh(rank, data=2, pipe=2)
        assert mesh.batch_index() == (mesh.coords()["data"], 2)
        peer = mesh.peer(PIPE, 1)
        assert _mesh(peer, data=2, pipe=2).batch_index() == \
            mesh.batch_index()
        got = ttrain.global_batch(mesh, {"x": x[:4]})["x"]
        np.testing.assert_array_equal(got.numpy(), x[:4])
    shape = dict.fromkeys(AXES, 1)
    shape.update(data=2, pipe=4)
    assert _lines(shape, ("pipe",), 8) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert _lines(shape, ("data",), 8) == [[0, 4], [1, 5], [2, 6], [3, 7]]


def test_stage_cut_and_its_jax_slice():
    """cut_to_stage keeps layers [s·L/S, (s+1)·L/S) with pipe layouts on
    the stacked dim, and load_jax_params fills them from the JAX stack's
    slice (the replicated leaves whole); the whole forward then points
    to pipelined_lm_logits."""
    params, tokens = _jax_init()
    whole = {k: v.numpy() for k, v in params_from_jax(params).items()}
    for rank in range(2):
        model = get_model("llama-tiny", device="cpu", dtype=torch.float32)
        model.cut_to_stage(_mesh(rank, pipe=2))
        assert len(model.layers) == 1
        load_jax_params(model, params)
        for name, p in model.named_parameters():
            src = name.replace("layers.0.", f"layers.{rank}.")
            np.testing.assert_array_equal(p.detach().numpy(), whole[src],
                                          err_msg=name)
        lay = layout_of(model.layers[0].attn.wq.weight)
        assert lay.spec[0] == PIPE and lay.start == rank and lay.stage_layer
        with pytest.raises(ValueError, match="pipelined_lm_logits"):
            model(torch.from_numpy(tokens))


def test_unported_pairings_name_item_11():
    """pp beside fsdp, ep, sp or tp, make_accum_train_step on a pp mesh,
    a FusedOptimizer there, and the MoE, quant and xent_chunk decoders on
    it raise NotImplementedError naming item 11."""
    for spec in (dict(pp=2, fsdp=2), dict(pp=2, ep=2), dict(pp=2, sp=2),
                 dict(pp=2, tp=2)):
        with pytest.raises(NotImplementedError, match="item 11"):
            MeshSpec(**spec).build(device="cpu")
    mesh = _mesh(pipe=2)
    with pytest.raises(NotImplementedError, match="item 11"):
        ttrain.make_accum_train_step(mesh=mesh, microbatches=2)
    for kw in (dict(xent_chunk=8), dict(quant=True)):
        with pytest.raises(NotImplementedError, match="item 11"):
            get_model("llama-tiny", device="cpu", mesh=mesh, **kw)
    with pytest.raises(NotImplementedError, match="item 11"):
        get_model("llama-moe-tiny", device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="item 11"):
        ttrain.create_train_state(get_model("llama-tiny", device="cpu"),
                                  FusedOptimizer("adamw", 1e-3), mesh=mesh)


def _knob_ranks(tmp_path, env_extra, world=2):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT), str(WORKLOADS),
                        os.environ.get("PYTHONPATH", "")]), **env_extra)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER)], env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    wait_ranks(procs, 120, "the example's knob ranks")
    return json.loads((tmp_path / "pp_losses.json").read_text())


def test_example_knobs_train(tmp_path):
    """The example's knobs (MODEL, MESH_PP, MICROBATCHES, STEPS, BATCH,
    SEQ) on two ranks: llama-tiny on MeshSpec(pp=2), adamw(3e-4) through
    pipelined_lm_logits; rank 0 writes finite, falling losses."""
    result = _knob_ranks(tmp_path, {
        "MODEL": "llama-tiny", "MESH_PP": "2", "MICROBATCHES": "2",
        "STEPS": "4", "BATCH": "4", "SEQ": "16"})
    assert result["mesh"] == {"pipe": 2} and result["microbatches"] == 2
    losses = result["losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_pipeline_parallel_job_through_the_minipod(tmp_path):
    """The counterpart of tests/test_e2e.py:388 on the port's control
    plane: `tony submit --framework pytorch` with two workers forms one
    pp=2 mesh across the processes; every task succeeds, each holds one
    of llama-tiny's two layers, and the loss falls."""
    job = MiniPod(tmp_path).run({
        "tony.application.framework": "pytorch",
        "tony.worker.instances": "2",
        "tony.application.executes": "python torch_pp_train.py",
    }, src_dir=WORKLOADS, timeout=240)
    assert job.exit_code == 0, [
        (t.task_id, t.status.value, t.diagnostics) for t in job.session]
    [result] = [json.loads(p.read_text())
                for p in Path(job.am.job_dir).rglob("pp_losses.json")]
    assert result["num_processes"] == 2
    assert result["mesh"]["pipe"] == 2 and result["layers_held"] == 1
    assert result["losses"][-1] < result["losses"][0]
