"""The int8 gather wire of the port's ZeRO-3 step on the CPU
(``make_accum_train_step(quant=True)``, :mod:`tony_tpu_torch.ops.quant`):
the pins of the reference's ``tests/test_quant.py`` rebuilt against the
JAX package on the same numpy-seeded weights, on one 4-rank and one
2-rank gloo world (tests/workloads/torch_zero3_steps.py):

* ``test_quant_gather_accum_tracks_unquantized`` — mnist-mlp (hidden 32)
  at fsdp 4, AdamW, 8 steps: the quantized loss within 2% of the
  unquantized one, the amax histories moved, int8 bytes a quarter of
  the raw ones;
* the port's ``quant=True`` step against the JAX package's over the
  reference's 8 steps (SGD, as the other ZeRO-3 pins), losses,
  parameters and amax histories within 1e-5: mnist-mlp at fsdp 4 run
  free for 8 steps, and llama-tiny at fsdp 2 taking each of JAX's 8
  steps from JAX's state before it. Run free, llama-tiny's int8 codes
  turn last-bit differences into whole quanta: from parameters 1 ulp
  apart JAX itself moves up to 2.6e-3 in loss within 8 steps, where its
  unquantized step moves at most 1.1e-6; the port run free moves 1.9e-4
  from JAX by step 8, 6.2e-7 unquantized
  (``exp/port_quant_gather_drift.py``). The two
  packages order a model's leaves differently (JAX flattens its dicts by
  sorted key, the port by module order), so only a plan of one leaf a
  bucket partitions them alike: these pins use one (64- and 1024-byte
  buckets); bucket scales of any other plan differ between the packages
  by construction, not by fault;
* ``TestQuantGather`` — the round trip bit-exact on gloo, padded
  buckets outside the lane, a tree with no gatherable bucket the
  identity step, the validation errors;
* ``TestCkptPortability`` — a same-topology round trip exact, a step
  saved at fsdp 2 restored at fsdp 4, a newly gatherable bucket
  reseeded from the parameters, fused-only states on their own codec,
  and a quantized ZeRO-3 step saved by either package restored by the
  other."""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from tony_tpu import ckpt as jckpt
from tony_tpu import parallel as jpar
from tony_tpu import train as jtrain
from tony_tpu.benchmark import fsdp_shard_state
from tony_tpu.models import get_model as jax_model
from tony_tpu.ops import fused_optim as jfo
from tony_tpu.ops import quant as jq
from tony_tpu.parallel import overlap as joverlap
from tony_tpu.parallel import sched as jsched
from torch_ranks import wait_ranks
from tony_tpu_torch import ckpt, train as ttrain
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params, params_from_jax
from tony_tpu_torch.ops import fused_optim as fo
from tony_tpu_torch.ops import quant as q
from tony_tpu_torch.parallel import AXES, Mesh, sched
from tony_tpu_torch.parallel.overlap import GradBuckets

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).parent / "workloads" / "torch_zero3_steps.py"
RANK_TIMEOUT_S = 240
TOL = 1e-5
GATHER_LOSS_TOL = 0.02      # the reference's pin (test_quant.py)
STEPS = 8
WINDOW = 4
MNIST_HIDDEN = 32
BB_MNIST = 64               # one leaf a bucket (the smallest is 128 B)
BB_TINY = 1024              # one leaf a bucket (the smallest is 8 KiB)
BB_TRACK = 1 << 15          # the reference's pin
TINY_KW = {"xent_chunk": 8, "dtype": "float32", "scan_layers": False}
TINY_TOKENS = np.random.RandomState(21).randint(0, 256, (8, 17)).astype(
    np.int32)
SGD = {"rule": "sgd", "learning_rate": 0.1}
ADAMW = {"rule": "adamw", "learning_rate": 1e-3}
FUSED_ADAMW = {"rule": "adamw", "lr": 1e-3, "bucket_bytes": BB_TINY}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(world, cfg, prefix):
    cpath = Path(f"{prefix}cfg.json")
    cpath.write_text(json.dumps(cfg))
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port),
                   INIT_METHOD=f"tcp://127.0.0.1:{port}",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT), os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(cpath), f"{prefix}{rank}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    wait_ranks(procs, RANK_TIMEOUT_S, "the quant-gather ranks")
    return [json.loads(Path(f"{prefix}{r}.json").read_text())["runs"]
            for r in range(world)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mnist_names(tree):
    """The JAX MLP's ``Dense_i/kernel|bias`` leaves by the port's names
    (kernels transposed to ``[out, in]``)."""
    return {f"{layer}.{'weight' if leaf == 'kernel' else 'bias'}":
            (np.asarray(v).T if leaf == "kernel" else np.asarray(v))
            for layer, leaves in tree.items() for leaf, v in leaves.items()}


def _mnist_specs(model, fsdp, only=None):
    """The port's specs for fsdp_shard_state's layout (each leaf's first
    fsdp-divisible JAX dim, the torch weight's dim reversed), or every
    leaf replicated but ``only``, which shards its JAX dim 0."""
    specs = []
    for name, p in model.named_parameters():
        jshape = tuple(p.shape[::-1])
        if only is not None:
            d = 0 if name == only else None
        else:
            d = next((k for k, n in enumerate(jshape) if n % fsdp == 0),
                     None)
        if d is None:
            specs.append(())
            continue
        specs.append(tuple("fsdp" if k == p.dim() - 1 - d else None
                           for k in range(p.dim())))
    return specs


def _jax_amax(state, mesh, bb, names_of):
    """A JAX quant state's histories by the port's parameter names, the
    gathered leaves only (the others are marked NaN and dropped)."""
    plan, gplan = jq._plans_of(state.params, mesh, bb)
    tree = jq.amax_to_leaf_major(plan, gplan, state.quant_state["amax"])
    gathered = {i for b in gplan.gather_buckets for i in plan.buckets[b]}
    marked = jax.tree.unflatten(plan.treedef, [
        np.asarray(h, np.float32) if i in gathered
        else np.full((WINDOW,), np.nan, np.float32)
        for i, h in enumerate(jax.tree.leaves(tree))])
    return {k: np.asarray(v, np.float32) for k, v in names_of(
        marked).items() if not np.isnan(v).any()}


def _tiny_names(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def _jax_tiny(mesh, tx, bb):
    model = jax_model("llama-tiny", dtype=jnp.float32, xent_chunk=8,
                      scan_layers=False)
    return model, jtrain.create_train_state(
        model, tx, jnp.asarray(TINY_TOKENS), jax.random.PRNGKey(0),
        mesh=mesh)


def _jax_tiny_quant(mesh, tx, bb, params):
    _, st = _jax_tiny(mesh, tx, bb)
    st = st.replace(params=jax.device_put(
        params, jax.tree.map(lambda a: a.sharding, st.params)))
    if isinstance(tx, jfo.FusedOptimizer):
        st = st.replace(opt_state=tx.init_state(st.params, mesh))
    return jq.with_gather_quant(st, mesh, window=WINDOW, bucket_bytes=bb)


def _tiny_step(mesh, bb, update="optax"):
    return jtrain.make_accum_train_step(
        lambda o, b: o, mesh, microbatches=2, bucket_bytes=bb, quant=True,
        update=update, apply_kwargs_of=lambda b: {"targets": b["x"]},
        donate=False)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The JAX package's quantized ZeRO-3 runs and saves: mnist-mlp at
    fsdp 4 and llama-tiny (unscanned) at fsdp 2, 8 SGD steps each; a
    2-step AdamW llama-tiny step at fsdp 2 saved by the JAX
    checkpointer."""
    root = tmp_path_factory.mktemp("quant_gather")
    rng = np.random.RandomState(1)
    x = rng.normal(size=(64, 784)).astype(np.float32)
    y = rng.randint(0, 10, (64,)).astype(np.int32)
    np.savez(root / "mnist_batch.npz", x=x, y=y)
    np.savez(root / "tiny_batch.npz", x=TINY_TOKENS)
    out = {"root": root}
    # mnist-mlp at fsdp 4.
    mesh4 = jpar.make_mesh(n_devices=4, fsdp=4)
    model = jax_model("mnist-mlp", hidden=MNIST_HIDDEN)
    st = jtrain.create_train_state(model, optax.sgd(0.1), jnp.asarray(x),
                                   jax.random.PRNGKey(2))
    port = get_model("mnist-mlp", hidden=MNIST_HIDDEN, device="cpu")
    load_jax_params(port, _np(st.params))
    np.savez(root / "mnist_init.npz", **{
        k: v.detach().numpy() for k, v in port.state_dict().items()})
    sq = jq.with_gather_quant(fsdp_shard_state(st, mesh4), mesh4,
                              window=WINDOW, bucket_bytes=BB_MNIST)
    step = jtrain.make_accum_train_step(mesh=mesh4, microbatches=4,
                                        bucket_bytes=BB_MNIST, quant=True,
                                        donate=False)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    losses = []
    for _ in range(STEPS):
        sq, m = step(sq, batch)
        losses.append(float(m["loss"]))
    out["mnist"] = (losses, _mnist_names(_np(sq.params)),
                    _jax_amax(sq, mesh4, BB_MNIST, _mnist_names))
    # llama-tiny, unscanned, at fsdp 2.
    mesh2 = jpar.make_mesh(n_devices=2, fsdp=2)
    _, st = _jax_tiny(None, optax.sgd(0.1), BB_TINY)
    np.savez(root / "tiny_init.npz", **_tiny_names(_np(st.params)))
    init_params = st.params
    sq = _jax_tiny_quant(mesh2, optax.sgd(0.1), BB_TINY, init_params)
    step = _tiny_step(mesh2, BB_TINY)
    # Every step's state before it (parameters as the port's npz, amax
    # by leaf) and what the step makes of it.
    states = [(_tiny_names(_np(sq.params)),
               _jax_amax(sq, mesh2, BB_TINY, _tiny_names))]
    losses = []
    for k in range(STEPS):
        np.savez(root / f"tiny_step{k}.npz", **states[-1][0])
        sq, m = step(sq, {"x": jnp.asarray(TINY_TOKENS)})
        losses.append(float(m["loss"]))
        states.append((_tiny_names(_np(sq.params)),
                       _jax_amax(sq, mesh2, BB_TINY, _tiny_names)))
    out["tiny"] = (losses, states)
    # A JAX quantized AdamW step saved for the port to restore.
    sa = _jax_tiny_quant(mesh2, optax.adamw(1e-3), BB_TINY, init_params)
    step = _tiny_step(mesh2, BB_TINY)
    for _ in range(2):
        sa, _ = step(sa, {"x": jnp.asarray(TINY_TOKENS)})
    saver = jckpt.AsyncCheckpointer(root / "jax_save")
    saver.save(jckpt.encode_portable(sa), step=2, block=True)
    saver.close()
    out["jax_save"] = (_tiny_names(_np(sa.params)),
                       _jax_amax(sa, mesh2, BB_TINY, _tiny_names))
    out["init_params"] = init_params
    return out


def _accum(**kw):
    return {"step": "accum", "steps": STEPS, **kw}


@pytest.fixture(scope="module")
def worlds(refs):
    """One 2-rank world (llama-tiny, fsdp 2) and then one 4-rank world
    (mnist-mlp and llama-tiny, fsdp 4), every case a run of one of
    them."""
    root = refs["root"]
    port = get_model("mnist-mlp", hidden=MNIST_HIDDEN, device="cpu")
    zero3 = _mnist_specs(port, 4)
    none_gatherable = _mnist_specs(port, 4, only="Dense_2.bias")
    decoder = get_model("llama-tiny", device="cpu",
                        **{**TINY_KW, "dtype": torch.float32})
    head_replicated = [() if n == "lm_head.weight" else tuple(s)
                       for (n, _), s in zip(decoder.named_parameters(),
                                            ttrain.param_specs(decoder))]
    tiny = {"model": "llama-tiny", "model_kwargs": TINY_KW, "targets": True,
            "init": str(root / "tiny_init.npz"),
            "batch": str(root / "tiny_batch.npz")}
    fused = {"update": "fused_bucket", "tx": FUSED_ADAMW,
             "bucket_bytes": BB_TINY, "microbatches": 2,
             "quant": {"window": WINDOW}}
    runs2 = {
        f"q{k}": _accum(microbatches=2, bucket_bytes=BB_TINY, tx=SGD,
                        steps=1, init=str(root / f"tiny_step{k}.npz"),
                        quant={"window": WINDOW, "amax": {
                            n: h.tolist() for n, h in
                            refs["tiny"][1][k][1].items()}},
                        roundtrip=k == 0)
        for k in range(STEPS)}
    runs2.update({
        "save": _accum(**fused, steps=2, save_dir=str(root / "port_save")),
        "same": _accum(**fused, steps=0,
                       restore_dir=str(root / "port_save")),
        "more": _accum(**fused, steps=1,
                       restore_dir=str(root / "port_save")),
        "jax": _accum(microbatches=2, bucket_bytes=BB_TINY, tx=ADAMW,
                      quant={"window": WINDOW}, steps=0,
                      restore_dir=str(root / "jax_save")),
        # The head replicated: outside the lane when it is saved.
        "ungath": _accum(**fused, steps=1, save_dir=str(root / "ungath"),
                         specs=head_replicated),
        "regath": _accum(**fused, steps=0, restore_dir=str(root / "ungath")),
    })
    out = {}
    out[2] = _run_ranks(2, {**tiny, "dp": 1, "fsdp": 2, "runs": runs2},
                        str(root / "w2_"))
    mnist = {"model": "mnist-mlp", "model_kwargs": {"hidden": MNIST_HIDDEN},
             "init": str(root / "mnist_init.npz"),
             "batch": str(root / "mnist_batch.npz")}
    runs4 = {
        "q": _accum(microbatches=4, bucket_bytes=BB_MNIST, tx=SGD,
                    specs=zero3, quant={"window": WINDOW}, roundtrip=True),
        "track_p": _accum(microbatches=4, bucket_bytes=BB_TRACK, tx=ADAMW,
                          specs=zero3),
        "track_q": _accum(microbatches=4, bucket_bytes=BB_TRACK, tx=ADAMW,
                          specs=zero3, quant={"window": WINDOW}),
        # Every leaf over its JAX dim 0: Dense_2's bias (10 rows over 4
        # ranks) pads into a bucket of its own.
        "uneven": _accum(microbatches=4, bucket_bytes=BB_MNIST, tx=SGD,
                         steps=2, quant={"window": WINDOW}, roundtrip=True,
                         specs=[tuple("fsdp" if k == p.dim() - 1 else None
                                      for k in range(p.dim()))
                                for _, p in port.named_parameters()]),
        "none_p": _accum(microbatches=2, bucket_bytes=BB_MNIST, tx=SGD,
                         steps=2, specs=none_gatherable),
        "none_q": _accum(microbatches=2, bucket_bytes=BB_MNIST, tx=SGD,
                         steps=2, specs=none_gatherable,
                         quant={"window": WINDOW}),
        "x0": {**tiny, **_accum(**fused, steps=0,
                                restore_dir=str(root / "port_save"))},
        "x1": {**tiny, **_accum(**fused, steps=1,
                                restore_dir=str(root / "port_save"))},
    }
    out[4] = _run_ranks(4, {**mnist, "dp": 1, "fsdp": 4, "runs": runs4},
                        str(root / "w4_"))
    return out


def _params(refs, world, run):
    return dict(np.load(refs["root"] / f"w{world}_0.{run}.npz"))


def _close(got, ref, what):
    assert sorted(got) == sorted(ref), what
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=0,
                                   err_msg=f"{what}: {k}")


def test_quant_gather_accum_tracks_unquantized(worlds):
    """mnist-mlp at fsdp 4, AdamW(1e-3), 8 steps of 4 microbatches on
    32 KiB buckets: the int8-gather loss within 2% of the unquantized
    one; the delayed-scaling histories moved off their seed; the records
    show int8 bytes a quarter of the raw f32 bytes and the window."""
    rep = worlds[4][0]
    lp = rep["track_p"]["metrics"][-1]["loss"]
    lq = rep["track_q"]["metrics"][-1]["loss"]
    assert abs(lq - lp) / lp < GATHER_LOSS_TOL, (lp, lq)
    assert len(set(rep["track_q"]["amax"][-1])) > 1
    g = rep["track_q"]["quant"]["accum_gather"]
    assert g["bytes_saved"] > 0
    assert sum(g["raw_nbytes"]) == 4 * sum(g["int8_nbytes"])
    assert g["window"] == WINDOW
    gather = rep["track_q"]["collectives"]["accum.fwd_gather"]
    assert gather["quant"] == "int8"
    assert sum(gather["nbytes"]) == 2 * sum(g["int8_nbytes"])


def _amax(rep):
    return {k: np.asarray(v, np.float32)
            for k, v in rep["amax_by_leaf"].items()}


def test_quant_step_matches_jax_mnist(refs, worlds):
    """mnist-mlp at fsdp 4: the port's ``quant=True`` step and the JAX
    package's, 8 SGD steps from the same weights: every step's loss, the
    parameters and every gathered leaf's amax history within 1e-5, on
    every rank."""
    losses, params, amax = refs["mnist"]
    for rep in worlds[4]:
        got = [m["loss"] for m in rep["q"]["metrics"]]
        np.testing.assert_allclose(got, losses, rtol=TOL, atol=0)
        _close(_amax(rep["q"]), amax, "amax")
    _close(_params(refs, 4, "q"), params, "params")


@pytest.mark.parametrize("k", range(STEPS))
def test_quant_step_matches_jax_tiny(refs, worlds, k):
    """llama-tiny (unscanned) at fsdp 2: JAX's step k+1 taken by the port
    from JAX's state before it (parameters and amax histories): the
    loss, the parameters and the histories after it within 1e-5, on
    every rank."""
    losses, states = refs["tiny"]
    params, amax = states[k + 1]
    for rep in worlds[2]:
        run = rep[f"q{k}"]
        assert run["metrics"][0]["loss"] == pytest.approx(losses[k],
                                                          rel=TOL)
        _close(_amax(run), amax, "amax")
    _close(_params(refs, 2, f"q{k}"), params, "params")


class TestQuantGather:
    def test_gather_roundtrip_bit_exact(self, worlds):
        """The int8 gather dequantized equals quantize-after-gather bit
        for bit, on every rank, for llama-tiny and mnist-mlp (with and
        without a padded bucket)."""
        for world, runs in ((2, ("q0",)), (4, ("q", "uneven"))):
            for rep in worlds[world]:
                for run in runs:
                    assert rep[run]["roundtrip_exact"] is True, run

    def test_padded_buckets_stay_out_of_the_quant_lane(self, worlds):
        """The reference's tree: the uneven leaf pads into a scatter
        bucket of its own, which is gather passthrough (no int8 ever
        touches pad rows), as the JAX planner has it; and a step with a
        padded bucket runs on the lane."""
        params = {"w1": np.ones((16, 8), np.float32),
                  "w2": np.ones((6, 8), np.float32),
                  "w3": np.ones((8, 4), np.float32),
                  "bias": np.ones((5,), np.float32),
                  "scale": np.float32(1.5)}
        specs = {"w1": P("fsdp"), "w2": P("fsdp"), "w3": P("fsdp"),
                 "bias": P(), "scale": P()}
        ref = joverlap.GradBuckets.plan_sharded(params, specs,
                                                shard_size=4,
                                                bucket_bytes=256)
        leaves = [torch.from_numpy(np.asarray(v))
                  for v in jax.tree.leaves(params)]
        got = GradBuckets.plan_sharded(
            leaves, [tuple(s) for s in jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, P))],
            shard_size=4, bucket_bytes=256)
        gplan = sched.GatherPlan.from_buckets(got)
        assert any(got._is_padded(b) for b in range(got.n_buckets))
        assert all(not got._is_padded(b) for b in gplan.gather_buckets)
        assert gplan.gather_buckets == jsched.GatherPlan.from_buckets(
            ref).gather_buckets
        rep = worlds[4][0]["uneven"]
        assert rep["overlap"]["accum_step"]["n_padded_buckets"] == 1
        assert all(math.isfinite(m["loss"]) for m in rep["metrics"])

    def test_no_gatherable_buckets_is_identity_step(self, refs, worlds):
        """A layout with no even scatter bucket (mnist-mlp with only
        Dense_2's 10-row bias declared sharded, which pads): the lane has
        nothing to quantize, its histories are empty, and the step is
        bitwise the unquantized one."""
        for rep in worlds[4]:
            assert rep["none_q"]["amax"] == []
            assert rep["none_q"]["metrics"] == rep["none_p"]["metrics"]
        a, b = _params(refs, 4, "none_q"), _params(refs, 4, "none_p")
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    def test_validation_errors(self):
        with pytest.raises(ValueError, match="bucket boundary"):
            ttrain.make_accum_train_step(microbatches=2, gather="per_leaf",
                                         quant=True)
        # A state without the lane, and one built for another plan.
        model = get_model("llama-tiny", device="cpu", dtype=torch.float32)
        plain = ttrain.create_train_state(model, ttrain.sgd(0.1))
        fake_mesh = Mesh(shape={**dict.fromkeys(AXES, 1), "fsdp": 2},
                         processes=2, device=torch.device("cpu"))
        with pytest.raises(ValueError, match="QuantTrainState"):
            ttrain._quant_amax(plain, fake_mesh, "optax", 1 << 15)
        qstate = ttrain.QuantTrainState(
            **{f: getattr(plain, f) for f in ("step", "model", "tx",
                                              "opt_state")},
            qconfig=q.QuantConfig(window=2, bucket_bytes=1 << 15),
            quant_state={"amax": []})
        with pytest.raises(ValueError, match="bucket_bytes"):
            ttrain._quant_amax(qstate, fake_mesh, "optax", 1 << 14)
        with pytest.raises(ValueError, match="needs a mesh"):
            ttrain._quant_amax(qstate, None, "optax", 1 << 15)
        # Replicated layout: nothing to quantize-gather.
        with pytest.raises(ValueError, match="fsdp-sharded"):
            q.with_gather_quant(plain, fake_mesh)
        with pytest.raises(ValueError, match="no mesh"):
            q.with_gather_quant(plain, None)
        # Histories for the wrong geometry are named, not garbled.
        plan = GradBuckets.plan_sharded(
            [torch.zeros(8, 4), torch.zeros(8, 4)],
            [("fsdp",), ("fsdp",)], shard_size=2, bucket_bytes=64)
        gplan = sched.GatherPlan.from_buckets(plan)
        with pytest.raises(ValueError, match="histories"):
            q.check_quant_amax(gplan, [torch.zeros(2)])
        with pytest.raises(ValueError, match="shape"):
            q.check_quant_amax(gplan, [torch.zeros(2), torch.zeros(3)])
        with pytest.raises(ValueError, match="window"):
            q.QuantConfig(window=0)


class TestCkptPortability:
    """The amax state rides the checkpoint through the quant codec: per
    leaf on disk, re-bucketed for whatever topology restores, composed
    with the optimizer's codec."""

    def test_same_topology_roundtrip_exact(self, refs, worlds):
        """A fused AdamW quantized step saved at fsdp 2 and restored at
        fsdp 2: histories and parameters bitwise the saved ones."""
        for rep in worlds[2]:
            assert rep["same"]["amax"] == rep["save"]["amax"]
        a, b = _params(refs, 2, "same"), _params(refs, 2, "save")
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    def test_cross_topology_restore_steps(self, refs, worlds):
        """The same step restored at fsdp 4: the parameters bitwise the
        saved ones, every history live and re-bucketed for the new plan,
        and one more step tracks the fsdp-2 run's within 1e-3."""
        saved = _params(refs, 2, "save")
        got = _params(refs, 4, "x0")
        for k in saved:
            np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
        rep4 = worlds[4][0]
        hists = rep4["x0"]["amax_by_leaf"]
        assert hists and all(max(h) > 0 for h in hists.values())
        assert rep4["x0"]["amax_by_leaf"] == worlds[2][0]["save"][
            "amax_by_leaf"]
        l4 = rep4["x1"]["metrics"][0]["loss"]
        l2 = worlds[2][0]["more"]["metrics"][0]["loss"]
        assert l4 == pytest.approx(l2, rel=1e-3)

    def test_newly_gatherable_bucket_reseeds_from_params(self, refs,
                                                         worlds):
        """A head saved replicated (outside the lane, a zero portable
        history) restored where it is sharded: its bucket's merged
        history would floor the scale and clip the head to zero, so the
        codec reseeds it from the restored head's amax."""
        for rep in worlds[2]:
            assert "lm_head.weight" not in rep["ungath"]["amax_by_leaf"]
            hist = rep["regath"]["amax_by_leaf"]["lm_head.weight"]
            head = _params(refs, 2, "regath")["lm_head.weight"]
            np.testing.assert_array_equal(
                np.asarray(hist, np.float32),
                np.full(WINDOW, np.abs(head).max(), np.float32))
            assert all(max(h) > 0 for h in
                       rep["regath"]["amax_by_leaf"].values())

    def test_fused_only_states_keep_their_codec(self):
        """The quant codec comes first but takes only quantized states: a
        fused state keeps the fused codec's form, an AdamW state the
        train state's, neither grows a quant_state."""
        assert ckpt.PORTABLE_CODECS[0][0] == "quant_gather"
        model = get_model("llama-tiny", device="cpu", dtype=torch.float32)
        fused = ttrain.create_train_state(
            model, fo.FusedOptimizer(rule="sgd", lr=0.1,
                                     bucket_bytes=1 << 15))
        enc = ckpt.encode_portable(fused)
        assert "leaf" in enc.opt_state and "quant_state" not in enc
        model = get_model("llama-tiny", device="cpu", dtype=torch.float32)
        plain = ttrain.create_train_state(model, ttrain.adamw(1e-3))
        enc = ckpt.encode_portable(plain)
        assert "quant_state" not in enc and hasattr(enc.opt_state[0], "mu")

    def test_port_step_restores_in_jax(self, refs, worlds):
        """The port's fused quantized step saved at fsdp 2 restores into
        the JAX package's quantized fused state: parameters and amax
        histories equal the port's."""
        mesh2 = jpar.make_mesh(n_devices=2, fsdp=2)
        tx = jfo.FusedOptimizer(rule="adamw", lr=1e-3,
                                bucket_bytes=BB_TINY, interpret=True)
        tmpl = _jax_tiny_quant(mesh2, tx, BB_TINY, refs["init_params"])
        got = jckpt.decode_portable(jckpt.restore_pytree(
            refs["root"] / "port_save", jckpt.encode_portable(tmpl), step=2,
            mesh=mesh2), mesh2)
        assert int(jax.device_get(got.opt_state["count"])) == 2
        params = _tiny_names(_np(got.params))
        saved = _params(refs, 2, "save")
        for k in saved:
            np.testing.assert_array_equal(params[k], saved[k], err_msg=k)
        amax = _jax_amax(got, mesh2, BB_TINY, _tiny_names)
        port = {k: np.asarray(v, np.float32) for k, v in
                worlds[2][0]["save"]["amax_by_leaf"].items()}
        assert sorted(amax) == sorted(port)
        for k in port:
            np.testing.assert_array_equal(amax[k], port[k], err_msg=k)

    def test_jax_step_restores_in_the_port(self, refs, worlds):
        """A JAX quantized AdamW step saved at fsdp 2 restores into the
        port's quantized state: parameters and histories bitwise JAX's."""
        params, amax = refs["jax_save"]
        rep = worlds[2][0]["jax"]
        got = _params(refs, 2, "jax")
        for k in params:
            np.testing.assert_array_equal(got[k], params[k], err_msg=k)
        port = {k: np.asarray(v, np.float32)
                for k, v in rep["amax_by_leaf"].items()}
        assert sorted(port) == sorted(amax)
        for k in amax:
            np.testing.assert_array_equal(port[k], amax[k], err_msg=k)
