"""The ZeRO-3 gather window of the port on the CPU
(``tony_tpu_torch/parallel/window.py``, driven by ``gather="bucketed"``):
llama-tiny at 4 layers on one 4-rank and one 2-rank gloo world
(``fsdp=4``, ``fsdp=2``; tests/workloads/torch_zero3_steps.py), every
case a run of the same spawned world. The mirror of the reference's
``tests/test_sched.py::TestZero3ForwardGathers``:

* the windowed step is ``torch.equal`` to ``gather="per_leaf"`` (every
  leaf gathered for the whole microbatch) after 2 steps, in both update
  modes, with remat off, on and under the ``"dots"`` policy, and
  through ``make_accum_train_step``, ``make_train_step`` and
  ``train_loop``;
* it matches the JAX package's ZeRO-3 accumulating step within 1e-5
  (SGD, as tests/test_torch_zero3.py);
* the recorded high-water mark of gathered bytes is within
  ``window_nbytes()`` plus the window's stated allowance for prefetch
  0, 1 and 2 (every bucket at 0, as in the reference), and at prefetch 1
  at most half of all the gather bytes;
* every scatter bucket is reduced exactly once a microbatch, the first
  reduce before the embedding's grad exists, and the gathers are
  counted forward and backward;
* no hook is left on the model after a step, nor after a step that
  raised, and the parameters are back on their shards."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from tony_tpu import parallel as jpar
from tony_tpu import train as jtrain
from tony_tpu.models import get_model as jax_model
from tony_tpu_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).parent / "workloads" / "torch_zero3_steps.py"
RANK_TIMEOUT_S = 240
TOL = 1e-5
LAYERS = 4
TOKENS = np.random.RandomState(21).randint(0, 256, (8, 17)).astype(np.int32)
BB = 16384
# 64 KiB buckets pack leaves of two modules, and of two layers, together.
BB_STRADDLE = 65536
SGD = {"rule": "sgd", "learning_rate": 0.1}
FUSED_SGD = {"rule": "sgd", "lr": 0.1, "momentum": 0.0, "bucket_bytes": BB}
ACCUM = {"step": "accum", "microbatches": 2, "steps": 2, "bucket_bytes": BB,
         "tx": SGD}
REMAT = {"model_kwargs": {"remat": True}}
DOTS = {"model_kwargs": {"remat": True, "remat_policy": "dots"}}
STRADDLE = {**REMAT, "bucket_bytes": BB_STRADDLE}


def _runs(world):
    fused = {**ACCUM, "update": "fused_bucket", "tx": FUSED_SGD}
    runs = {
        "pl": {**ACCUM, "gather": "per_leaf"},
        "b": {**ACCUM, "fail": True},
        "fpl": {**fused, "gather": "per_leaf"},
        "fb": fused,
        "dpl": {**ACCUM, **DOTS, "gather": "per_leaf"},
        "db": {**ACCUM, **DOTS},
        "fdb": {**fused, **DOTS},
        "fdpl": {**fused, **DOTS, "gather": "per_leaf"},
        "loop": {**ACCUM, "loop": True},
        "train": {"step": "train", "steps": 2, "tx": SGD},
        "train_pl": {**ACCUM, "microbatches": 1, "bucket_bytes": 4 << 20,
                     "gather": "per_leaf"},
    }
    if world == 4:
        runs.update({
            "b0": {**ACCUM, "prefetch": 0},
            "b2": {**ACCUM, "prefetch": 2},
            "rpl": {**ACCUM, **REMAT, "gather": "per_leaf"},
            "rb": {**ACCUM, **REMAT},
            "rs0": {**ACCUM, **STRADDLE, "prefetch": 0},
            "rs1": {**ACCUM, **STRADDLE},
            "rs2": {**ACCUM, **STRADDLE, "prefetch": 2},
            "rspl": {**ACCUM, **STRADDLE, "gather": "per_leaf"},
        })
    return runs


# (windowed run, its gather="per_leaf" twin) on each world.
PAIRS = {4: [("b", "pl"), ("b0", "pl"), ("b2", "pl"), ("fb", "fpl"),
             ("rb", "rpl"), ("db", "dpl"), ("fdb", "fdpl"),
             ("rs0", "rspl"), ("rs1", "rspl"), ("rs2", "rspl"),
             ("loop", "pl"), ("train", "train_pl")],
         2: [("b", "pl"), ("fb", "fpl"), ("db", "dpl"), ("fdb", "fdpl"),
             ("loop", "pl"), ("train", "train_pl")]}


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
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log}"
    return [json.loads(Path(f"{prefix}{r}.json").read_text())["runs"]
            for r in range(world)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX llama-tiny weights at 4 layers (xent_chunk=8, f32) as the
    port's npz, and the JAX package's ZeRO-3 accumulating step on both
    meshes: two SGD(0.1) steps, microbatches 2, 16 KiB buckets."""
    root = tmp_path_factory.mktemp("window")
    model = jax_model("llama-tiny", dtype=jnp.float32, xent_chunk=8,
                      n_layers=LAYERS)
    st = jtrain.create_train_state(
        model, optax.sgd(0.1), jnp.asarray(TOKENS), jax.random.PRNGKey(0))
    init = {k: v.numpy() for k, v in params_from_jax(
        _np(st.params)).items()}
    np.savez(root / "init.npz", **init)
    np.savez(root / "batch.npz", x=TOKENS)
    refs = {}
    for world in (4, 2):
        mesh = jpar.make_mesh(n_devices=world, fsdp=world)
        js = jtrain.create_train_state(
            model, optax.sgd(0.1), jnp.asarray(TOKENS),
            jax.random.PRNGKey(0), mesh=mesh)
        js = js.replace(params=jax.device_put(
            st.params, jax.tree.map(lambda a: a.sharding, js.params)))
        step = jtrain.make_accum_train_step(
            lambda o, b: o, mesh, microbatches=2, bucket_bytes=BB,
            apply_kwargs_of=lambda b: {"targets": b["x"]}, donate=False)
        metrics = []
        for _ in range(2):
            js, m = step(js, {"x": jnp.asarray(TOKENS)})
            metrics.append({k: float(v) for k, v in m.items()})
        refs[world] = (metrics, {k: v.numpy() for k, v in params_from_jax(
            _np(js.params)).items()})
    return root, refs


@pytest.fixture(scope="module")
def worlds(tiny):
    """One spawned world per rank count, every case a run of it."""
    root, _ = tiny
    out = {}
    for world in (4, 2):
        prefix = str(root / f"w{world}_")
        cfg = {"model": "llama-tiny", "targets": True,
               "model_kwargs": {"xent_chunk": 8, "dtype": "float32",
                                "n_layers": LAYERS},
               "dp": 1, "fsdp": world, "init": str(root / "init.npz"),
               "batch": str(root / "batch.npz"), "runs": _runs(world)}
        out[world] = (_run_ranks(world, cfg, prefix), prefix)
    return out


def _params(prefix, run):
    return dict(np.load(f"{prefix}0.{run}.npz"))


def _window(rep):
    return rep["overlap"]["accum_step"]["window"]


@pytest.mark.parametrize("world,pair", [(w, p) for w in (4, 2)
                                        for p in PAIRS[w]],
                         ids=lambda x: "-".join(x) if isinstance(x, tuple)
                         else f"fsdp{x}")
def test_bucketed_bitexact_vs_per_leaf(worlds, world, pair):
    """THE pin: the windowed step (gathers freed after use and gathered
    again for the backward, reduces issued as grads land) gives the
    per-leaf gather-everything step's bits after 2 steps: loss, grad
    norm and every parameter, on every rank — optax and fused updates,
    remat off, on and "dots", prefetch 0/1/2, buckets straddling
    modules and layers, and through make_train_step and train_loop."""
    reports, prefix = worlds[world]
    got, ref = pair
    for rep in reports:
        assert rep[got]["metrics"] == rep[ref]["metrics"], pair
    a, b = _params(prefix, got), _params(prefix, ref)
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name],
                                      err_msg=f"{pair}: {name}")
    if got != "train":
        assert _window(reports[0][got])["prefetch"] == \
            _runs(world)[got].get("prefetch", 1)


@pytest.mark.parametrize("world", [4, 2])
def test_windowed_step_matches_jax(tiny, worlds, world):
    """The windowed accumulating step against the JAX package's ZeRO-3
    step on the same mesh: loss and grad norm of both steps and every
    gathered parameter within 1e-5."""
    _, refs = tiny
    reports, prefix = worlds[world]
    metrics, params = refs[world]
    for rep in reports:
        for g, r in zip(rep["b"]["metrics"], metrics):
            for key in ("loss", "grad_norm"):
                assert g[key] == pytest.approx(r[key], rel=TOL), key
    got = _params(prefix, "b")
    assert sorted(got) == sorted(params)
    for name in params:
        np.testing.assert_allclose(got[name], params[name], atol=TOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("prefetch", [0, 1, 2])
@pytest.mark.parametrize("kind", ["plain", "remat_straddle"])
def test_window_bound(worlds, prefetch, kind):
    """The recorded high-water mark of gathered bytes is at most
    ``window_nbytes()`` plus the window's allowance (buckets a reader or
    a recomputed block spans beyond one), on every rank; at prefetch 0
    every bucket is live at once, as in the reference; at prefetch 1 at
    most half of all the gather bytes."""
    reports, _ = worlds[4]
    run = {("plain", 0): "b0", ("plain", 1): "b", ("plain", 2): "b2",
           ("remat_straddle", 0): "rs0", ("remat_straddle", 1): "rs1",
           ("remat_straddle", 2): "rs2"}[kind, prefetch]
    for rep in reports:
        w = _window(rep[run])
        assert w["prefetch"] == prefetch
        assert 0 < w["high_water_nbytes"] <= (w["window_nbytes"]
                                              + w["allowance_nbytes"])
        total = sum(w["gather_nbytes"])
        if prefetch == 0:
            assert w["window_nbytes"] == w["high_water_nbytes"] == total
        if prefetch == 1:
            assert w["high_water_nbytes"] <= total / 2
        if kind == "plain":
            # One leaf a reader, one reader a bucket: no allowance.
            assert w["allowance_nbytes"] == 0


def test_straddling_buckets_are_planned(worlds):
    """The straddle runs do pack leaves of two layers into one bucket
    (their gather buckets are fewer than the gathered leaves), and remat
    raises the allowance above zero."""
    reports, _ = worlds[4]
    plain, straddle = _window(reports[0]["b"]), _window(reports[0]["rs1"])
    assert len(straddle["gather_nbytes"]) < len(plain["gather_nbytes"])
    assert straddle["allowance_nbytes"] > 0


@pytest.mark.parametrize("world", [4, 2])
def test_reduce_once_early(worlds, world):
    """Every bucket (scatter and replicated) is reduced exactly once a
    microbatch, and the first reduce is issued before the embedding (leaf
    0, the last grad of the backward) has its grad."""
    reports, _ = worlds[world]
    for rep in reports:
        for run in ("b", "fb", "db", "loop"):
            w = _window(rep[run])
            assert set(w["reduces"]) == {2}, run
            first = w["first_reduce_landed"]
            assert first and 0 not in first, (run, first)


@pytest.mark.parametrize("world", [4, 2])
def test_fwd_gather_recorded(worlds, world):
    """``accum.fwd_gather`` keeps the reference's schema and counts a
    microbatch's gathers forward and backward: every gather bucket
    twice."""
    reports, _ = worlds[world]
    for run, prefetch in (("b", 1), ("fb", 1)) + (
            (("b2", 2),) if world == 4 else ()):
        rec = reports[0][run]["collectives"]["accum.fwd_gather"]
        w = _window(reports[0][run])
        assert (rec["kind"], rec["plane"], rec["axes"], rec["gather"],
                rec["prefetch"], rec["per_microbatch"], rec["quant"]) == (
            "all_gather", "fwd_gather", ["fsdp"], "bucketed", prefetch, 2,
            None)
        n = len(w["gather_nbytes"])
        assert w["fwd_gathers"] == w["bwd_gathers"] == n
        assert sum(rec["nbytes"]) == 2 * sum(w["gather_nbytes"])


@pytest.mark.parametrize("world", [4, 2])
def test_hooks_removed(worlds, world):
    """No hook is left on the model after a step, nor after a step whose
    loss raised; the parameters are then back on their shards."""
    reports, _ = worlds[world]
    for rep in reports:
        for run in rep.values():
            assert run["hooks_left"] == 0
        assert rep["b"]["after_raise"] == {"hooks_left": 0,
                                           "on_shards": True}


def test_whole_tensors_hold_no_storage_until_gathered():
    """A gathered leaf's whole tensor starts on a storage of 0 bytes (the
    window holds nothing of a bucket before its gather) and keeps it when
    a parameter's ``.data`` points at it; the storage the parameter and
    a view autograd saved of it read is the one the gather fills and
    the release empties."""
    import torch

    from tony_tpu_torch.parallel.window import _empty_like_shape

    whole = _empty_like_shape((4, 5), torch.float32, torch.device("cpu"))
    assert tuple(whole.shape) == (4, 5)
    assert whole.untyped_storage().nbytes() == 0
    p = torch.nn.Parameter(torch.zeros(2, 5))
    p.data = whole
    assert p.untyped_storage().nbytes() == 0
    whole.untyped_storage().resize_(80)
    whole.copy_(torch.arange(20.0).view(4, 5))
    x = torch.ones(3, 4, requires_grad=True)
    y = x @ p                       # autograd saves p
    whole.untyped_storage().resize_(0)
    assert p.untyped_storage().nbytes() == 0
    whole.untyped_storage().resize_(80)
    whole.copy_(torch.arange(20.0).view(4, 5))
    y.sum().backward()
    assert torch.equal(x.grad[0], torch.arange(20.0).view(4, 5).sum(1))
