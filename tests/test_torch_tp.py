"""Tensor and sequence parallelism in the port, on the CPU: one spawned
world of four gloo ranks (tests/workloads/torch_sharded_steps.py) runs
llama-tiny's ``make_train_step`` in f32 on ``MeshSpec(dp=4)``,
``MeshSpec(tp=4)`` (through ``train_loop``; the 2 kv heads narrower than
the model axis, so K/V stay whole and repeat), ``dp=2 × tp=2``,
``sp=4`` with ring attention, ``tp=2 × sp=2`` with ring attention under
remat and ``dp=2 × sp=2`` (the mesh cutting the sequence, as the
reference's ``seq_axis=True``) with the model's own attention, each
held against the JAX package's ``make_train_step`` on
the same mesh over 4 of the 8 virtual CPU devices (tests/test_models.py
:51-103, tests/test_overlap.py:550): loss and grad norm within 1e-5,
every parameter within 1e-5 after the steps. The replicated leaves are
bitwise equal on every rank after two steps (the tensor axis'
all-reduces give every rank the same bits), each rank holds its
Megatron shards, and the model axis' all-reduces and the ring's sends
carry the bytes the layout implies. The ring model's logits equal the
JAX reference attention's within 2e-4 (the reference's tolerance).
Checkpoints cross both ways: a step JAX saved on ``fsdp=2 × tp=2 ×
sp=2`` (tests/test_checkpoint.py:48-94) restores bitwise into the port's
``tp=2 × sp=2`` mesh, and the port's ``dp=2 × tp=2`` save restores
bitwise into JAX. The seq-sharded input (tests/test_data.py:725), the
mesh's groups and the unported pairings (item 11) are pinned on one
process, and the example's knobs run through the port's MiniPod."""

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
import torch.distributed as td

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from tony_tpu import ckpt as jckpt
from tony_tpu import parallel as jpar
from tony_tpu import train as jtrain
from tony_tpu.models import get_model as jax_model
from torch_ranks import wait_ranks
from tony_tpu_torch import train as ttrain
from tony_tpu_torch.minipod import MiniPod
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import params_from_jax
from tony_tpu_torch.parallel import (AXES, MODEL, SEQ, Mesh, MeshSpec,
                                     tensor as tpar)
from tony_tpu_torch.parallel import _lines

ROOT = Path(__file__).resolve().parent.parent
WORKLOADS = Path(__file__).parent / "workloads"
WORKER = WORKLOADS / "torch_sharded_steps.py"
WORLD = 4
TOL = 1e-5
ADAM = {"rule": "adamw", "learning_rate": 1e-3}
# name -> the run: its MeshSpec (dp=0 fills), attention, tx, steps and
# the worker's options; the JAX step runs on the same mesh.
RUNS = {
    "dp4": dict(dp=4, tx=ADAM, steps=2),
    "tp4": dict(tp=4, tx=ADAM, steps=2, loop=True),
    "dp2_tp2": dict(dp=2, tp=2, tx=ADAM, steps=2, save_dir="ck",
                    dump_opt=True),
    "sp4_ring": dict(sp=4, attention="ring", steps=1, logits=True,
                     tx={"rule": "sgd", "learning_rate": 1e-3}),
    "tp2_sp2_ring": dict(tp=2, sp=2, attention="ring", tx=ADAM, steps=2,
                         model_kwargs={"remat": True}),
    "sp2_seq_axis": dict(sp=2, steps=1,
                         tx={"rule": "adamw", "learning_rate": 1e-2}),
}
JAX_SAVED_STEPS = 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def _jax_init():
    """llama-tiny's JAX weights (f32) and a global batch of 8 × 16."""
    model = jax_model("llama-tiny", dtype=jnp.float32)
    tokens = np.random.RandomState(7).randint(0, 256, (8, 16)).astype(
        np.int32)
    params = nn.unbox(jax.jit(model.init)(jax.random.PRNGKey(0),
                                          jnp.asarray(tokens)))["params"]
    return jax.tree.map(np.asarray, params), tokens


def _jax_tx(tx):
    kw = dict(tx)
    rule = kw.pop("rule")
    return optax.adamw(kw["learning_rate"]) if rule == "adamw" \
        else optax.sgd(kw["learning_rate"])


def _jax_state(run, mesh, devices=None):
    """A JAX train state of the run's model on ``mesh`` holding the
    shared weights."""
    params, tokens = _jax_init()
    kw = {}
    if run.get("attention") == "ring":
        kw = dict(attention="ring", mesh=mesh)
    kw.update(run.get("model_kwargs", {}))
    model = jax_model("llama-tiny", dtype=jnp.float32, **kw)
    seq = run.get("sp", 1) > 1 and run.get("attention") != "ring"
    state = jtrain.create_train_state(
        model, _jax_tx(run["tx"]), jnp.asarray(tokens),
        jax.random.PRNGKey(0), mesh=None if seq else mesh)
    if seq:
        return model, state.replace(params=jax.tree.map(jnp.asarray, params))
    return model, state.replace(params=jax.tree.map(
        lambda a, ref: jax.device_put(a, ref.sharding), params,
        state.params))


def _jax_spec(run):
    return {k: run[k] for k in ("dp", "sp", "tp") if k in run}


@functools.lru_cache(maxsize=None)
def _jax_steps(name):
    """The JAX package's make_train_step on the run's mesh over 4 of the
    8 virtual devices: per-step metrics, the parameters after, and the
    final state."""
    run = RUNS[name]
    _, tokens = _jax_init()
    mesh = jpar.MeshSpec(**_jax_spec(run)).build(jax.devices()[:WORLD])
    _, state = _jax_state(run, mesh)
    step = jtrain.make_train_step(
        loss_of=lambda lg, b: jtrain.next_token_loss(lg, b["x"]), mesh=mesh,
        seq_axis=run.get("sp", 1) > 1, donate=False)
    metrics = []
    for _ in range(run["steps"]):
        state, m = step(state, {"x": jnp.asarray(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, state.params)).items()}, state


@functools.lru_cache(maxsize=None)
def _jax_reference_logits():
    """llama-tiny's logits with the reference attention, no mesh."""
    params, tokens = _jax_init()
    model = jax_model("llama-tiny", dtype=jnp.float32,
                      attention="reference")
    return np.asarray(model.apply({"params": params}, jnp.asarray(tokens)))


def _jax_save(root):
    """A JAX adamw state of llama-tiny after one step on make_mesh(fsdp=2,
    tp=2, sp=2) over the 8 virtual devices, saved at ``root``."""
    _, tokens = _jax_init()
    mesh = jpar.make_mesh(fsdp=2, tp=2, sp=2)
    _, state = _jax_state({"tx": ADAM}, mesh)
    step = jtrain.make_train_step(
        loss_of=lambda lg, b: jtrain.next_token_loss(lg, b["x"]), mesh=mesh,
        donate=False)
    for _ in range(JAX_SAVED_STEPS):
        state, _ = step(state, {"x": jnp.asarray(tokens)})
    saver = jckpt.AsyncCheckpointer(root)
    saver.save(state, step=JAX_SAVED_STEPS, block=True)
    saver.close()
    return state


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks' runs, then the JAX save restored at tp=2 × sp=2.
    The JAX save comes first; the other JAX references are computed
    while the ranks run."""
    root = tmp_path_factory.mktemp("tp")
    params, tokens = _jax_init()
    np.savez(root / "init.npz", **{k: v.numpy() for k, v in
                                   params_from_jax(params).items()})
    np.savez(root / "batch.npz", x=tokens)
    jax_state = _jax_save(root / "jax_ck")
    runs = [dict(dict(name=name, **run),
                 **({"save_dir": str(root / run["save_dir"])}
                    if "save_dir" in run else {}))
            for name, run in RUNS.items()]
    runs.append(dict(name="restore_jax", tp=2, sp=2, steps=0, tx=ADAM,
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
        for name in RUNS:
            _jax_steps(name)
        _jax_reference_logits()
    except BaseException:
        for p in procs:
            p.kill()
        raise
    wait_ranks(procs, 300, "the tensor/sequence-parallel ranks")
    report = json.loads((root / "r0.json").read_text())
    return root, report, jax_state


def _dump(root, run, tag=""):
    return dict(np.load(root / f"r0.{run}{tag}.npz"))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_steps_match_jax_mesh(world, run):
    """Loss and grad norm of every step within 1e-5 of the JAX step on
    the same mesh, and every parameter after the steps within 1e-5."""
    root, report, _ = world
    got = report[run]["metrics"]
    ref_metrics, ref_params, _ = _jax_steps(run)
    assert len(got) == len(ref_metrics) == RUNS[run]["steps"]
    for g, r in zip(got, ref_metrics):
        for key in ("loss", "grad_norm"):
            assert g[key] == pytest.approx(r[key], abs=TOL, rel=TOL), key
    dump = _dump(root, run)
    assert sorted(dump) == sorted(ref_params)
    for name in ref_params:
        np.testing.assert_allclose(dump[name], ref_params[name], atol=TOL,
                                   rtol=0, err_msg=f"{run}: {name}")


@pytest.mark.parametrize("run", sorted(RUNS))
def test_replicated_leaves_bitwise_equal_and_shards_held(world, run):
    """After the steps every replicated leaf (the norms; the K/V
    projections where the kv heads do not divide tp) has the same bits
    on every rank, and each rank holds 1/tp of every column- and
    row-parallel weight, the embedding and the head; the mesh filled
    its data axis."""
    _, report, _ = world
    entry = report[run]
    assert entry["replicated_differ"] == []
    tp, sp = RUNS[run].get("tp", 1), RUNS[run].get("sp", 1)
    assert entry["mesh"] == {k: v for k, v in (
        ("data", WORLD // (tp * sp)), ("seq", sp), ("model", tp)) if v > 1}
    for name, (local, whole) in entry["counts"].items():
        kv_whole = name.endswith(("wk.weight", "wv.weight")) and 2 % tp
        sharded = tp > 1 and not name.endswith("scale") and not kv_whole
        assert local == (whole // tp if sharded else whole), name


def test_model_axis_all_reduces_carry_the_megatron_bytes(world):
    """tp=4, batch 8 × 16 on one data index, f32: per step one all-reduce
    for the embedding, four a layer (the attention's and the MLP's row
    outputs forward, their column inputs' grads backward), one for the
    head's input grad, two a layer for the whole K/V weights' grads and
    three for the cross entropy (max, Σexp, target logit)."""
    _, report, _ = world
    rec = report["tp4"]["records"][tpar.MODEL_REDUCE_TAG]
    b, t, dim, layers, kv = 8, 16, 64, 2, 32
    act = b * t * dim * 4
    per_step = (act * (2 + 4 * layers) + layers * 2 * kv * dim * 4
                + 3 * b * (t - 1) * 4)
    steps = RUNS["tp4"]["steps"]
    assert rec["calls"] == steps * (2 + 4 * layers + 2 * layers + 3)
    assert rec["nbytes_total"] == steps * per_step
    assert rec["axes"] == [MODEL]


def test_ring_sends_carry_the_blocks(world):
    """sp=4, batch 8 × 16, 2 kv heads of 16: a layer's forward sends K and
    V three times, its backward K and V three times and the travelling
    f32 dK and dV four times (the last hop reaches the owner)."""
    _, report, _ = world
    recs = report["sp4_ring"]["records"]
    block = 8 * 2 * (16 // 4) * 16 * 4
    layers = 2
    fwd, bwd = (recs[f"ring_attention.send_recv.{w}"] for w in
                ("fwd", "bwd"))
    assert (fwd["calls"], fwd["nbytes_total"]) == (3 * layers,
                                                   3 * layers * 2 * block)
    assert (bwd["calls"], bwd["nbytes_total"]) == (7 * layers,
                                                   7 * layers * 2 * block)
    assert fwd["axes"] == [SEQ]


def test_ring_logits_equal_reference_attention(world):
    """The sp=4 ring model's logits, assembled from the ranks' blocks,
    against the JAX model with reference attention on the same weights,
    within 2e-4 (tests/test_models.py's tolerance)."""
    root, _, _ = world
    got = np.load(root / "r0.sp4_ring.logits.npy")
    np.testing.assert_allclose(got, _jax_reference_logits(), atol=2e-4,
                               rtol=2e-4)


def test_jax_save_on_fsdp_tp_sp_restores_into_the_tp_sp_mesh(world):
    """The step JAX saved on make_mesh(fsdp=2, tp=2, sp=2) restores into
    the port's tp=2 × sp=2 ranks bitwise: parameters and AdamW moments,
    gathered over the model group."""
    root, report, jax_state = world
    assert report["restore_jax"]["step"] == JAX_SAVED_STEPS
    ref = params_from_jax(jax.tree.map(np.asarray, jax_state.params))
    got = _dump(root, "restore_jax")
    for name, t in ref.items():
        np.testing.assert_array_equal(got[name], t.numpy(), err_msg=name)
    for slot in ("mu", "nu"):
        ref = params_from_jax(jax.tree.map(
            np.asarray, getattr(jax_state.opt_state[0], slot)))
        got = _dump(root, "restore_jax", f".{slot}")
        for name, t in ref.items():
            np.testing.assert_array_equal(got[name], t.numpy(),
                                          err_msg=f"{slot} {name}")


def test_port_save_at_tp2_restores_into_jax(world):
    """The port's dp=2 × tp=2 save (each tp rank of data index 0 wrote
    its shards, rank 0 the replicated leaves) restores into a JAX
    template bitwise: parameters and AdamW moments at step 2."""
    root, report, _ = world
    steps = RUNS["dp2_tp2"]["steps"]
    tmpl = _jax_steps("dp2_tp2")[2]
    back = jckpt.restore_pytree(root / "ck", tmpl)
    assert int(back.step) == steps
    assert int(back.opt_state[0].count) == steps
    for tree, tag in ((back.params, ""), (back.opt_state[0].mu, ".mu"),
                      (back.opt_state[0].nu, ".nu")):
        got = _dump(root, "dp2_tp2", tag)
        for name, t in params_from_jax(jax.tree.map(np.asarray,
                                                    tree)).items():
            np.testing.assert_array_equal(t.numpy(), got[name],
                                          err_msg=f"{tag} {name}")
    manifest = jckpt.read_manifest(root / "ck", steps)
    spec = {m["path"]: m["spec"] for m in manifest["leaves"]}
    assert spec[".params['layers']['block']['mlp']['w_gate']['kernel']"] \
        == [None, None, "model"]
    assert len({ch["file"] for ch in manifest["chunks"]}) == 2


def _mesh(rank=0, **sizes):
    shape = dict.fromkeys(AXES, 1)
    shape.update(sizes)
    return Mesh(shape=shape, processes=int(np.prod(list(shape.values()))),
                device=torch.device("cpu"), rank=rank)


def test_seq_axis_input_is_each_ranks_shard():
    """global_batch(seq_axis=True): every rank of a data index passes its
    rows with the whole sequence and keeps its [B/dp, T/sp] shard; a 1-D
    leaf stays whole (the reference's leaf-rank guard); a sequence that
    does not divide the ring raises naming the leaf
    (tests/test_data.py:725)."""
    x = np.arange(4 * 8).reshape(4, 8)
    w = np.ones((4,))
    for rank in range(4):
        mesh = _mesh(rank, data=2, seq=2)
        got = ttrain.global_batch(mesh, {"x": x, "w": w}, seq_axis=True)
        s = mesh.coords()["seq"]
        np.testing.assert_array_equal(got["x"].numpy(),
                                      x[:, s * 4:(s + 1) * 4])
        assert got["w"].shape == (4,)
        assert mesh.batch_index() == (mesh.coords()["data"], 2)
    with pytest.raises(ValueError, match="sequence dim 7"):
        ttrain.global_batch(_mesh(0, data=4, seq=2),
                            {"x": np.zeros((8, 7))}, seq_axis=True)


def test_seq_mesh_cuts_the_sequence_without_the_flag():
    """The seq axis decides: global_batch and a DeviceIterator on a
    dp=2 × sp=2 mesh hand each rank its [B/dp, T/sp] block with no
    seq_axis given, the block seq_axis=True gives; without a seq axis
    the sequence stays whole."""
    from tony_tpu_torch.data import Dataset

    x = np.arange(4 * 8).reshape(4, 8)
    for rank in range(4):
        mesh = _mesh(rank, data=2, seq=2)
        got = ttrain.global_batch(mesh, {"x": x})["x"]
        want = ttrain.global_batch(mesh, {"x": x}, seq_axis=True)["x"]
        assert got.shape == (4, 4)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        it = Dataset.from_arrays({"x": x}).batch(4).device_iterator(
            mesh, prefetch=0)
        try:
            assert next(it)["x"].shape == (2, 4)
        finally:
            it.close()
    assert ttrain.global_batch(_mesh(0, data=2, model=2),
                               {"x": x})["x"].shape == (4, 8)


def test_step_on_a_model_axis_takes_sharded_logits():
    """On a mesh with a model or seq axis the loss takes the decoder's
    block of the logits (ShardedLogits): a model that returns a plain
    tensor there raises before any loss is taken, and the whole-logit
    loss refuses the block (it is not a tensor)."""
    class Whole(torch.nn.Module):
        def forward(self, x):
            return torch.zeros(x.shape + (8,))

    batch = {"x": torch.zeros((2, 4), dtype=torch.long)}
    for mesh in (_mesh(model=2), _mesh(seq=2)):
        with pytest.raises(ValueError, match="ShardedLogits"):
            ttrain.model_loss(Whole(), batch,
                              lambda lg, b: ttrain.next_token_loss(
                                  lg, b["x"]), mesh=mesh)
    block = tpar.ShardedLogits.of(torch.zeros((2, 4, 4)), _mesh(model=2))
    assert block.lo == 0 and block.narrow(0, 3).logits.shape == (2, 3, 4)
    with pytest.raises(TypeError):
        torch.nn.functional.cross_entropy(block, batch["x"])


def test_device_iterator_yields_each_ranks_shard():
    """A DeviceIterator with ``seq_axis=True`` on a dp=2 × sp=2 mesh: each
    rank's batch (its ShardSpec from ``mesh.batch_index()``) is its
    [B/dp, T/sp] block, the block the JAX package's
    ``global_batch(..., seq_axis=True)`` puts on the device of the same
    index."""
    from tony_tpu_torch.data import Dataset

    x = np.arange(8 * 8).reshape(8, 8).astype(np.int32)
    jmesh = jpar.MeshSpec(dp=2, sp=2).build(jax.devices()[:4])
    jbatch = jtrain.global_batch(jmesh, {"x": x}, seq_axis=True)["x"]
    want = {next(i for i, d in enumerate(jax.devices()[:4])
                 if d == shard.device): np.asarray(shard.data)
            for shard in jbatch.addressable_shards}
    for rank in range(4):
        it = Dataset.from_arrays({"x": x}).batch(8).device_iterator(
            _mesh(rank, data=2, seq=2), seq_axis=True, prefetch=0)
        try:
            got = next(it)["x"].numpy()
        finally:
            it.close()
        np.testing.assert_array_equal(got, want[rank])
        assert got.shape == (4, 4)


def test_load_jax_params_takes_the_ranks_slice():
    """``load_jax_params`` on a decoder cut for tp=2 (``shard_model`` on
    each rank's coordinates) fills each parameter with its rank's slice
    of the JAX leaf: the column shards' rows, the row shards' columns,
    the vocab rows, the norms and (kv heads dividing tp) K/V shards."""
    from tony_tpu_torch.models.convert import load_jax_params

    params, _ = _jax_init()
    whole = {k: v.numpy() for k, v in params_from_jax(params).items()}
    for rank in range(2):
        model = get_model("llama-tiny", device="cpu", dtype=torch.float32)
        mesh = _mesh(rank, model=2)
        tpar.shard_model(model, ttrain.param_specs(model), mesh)
        load_jax_params(model, params)
        for name, p in model.named_parameters():
            ref = whole[name]
            if name.endswith("scale"):
                np.testing.assert_array_equal(p.detach().numpy(), ref)
                continue
            dim = 1 if name.endswith(("wo.weight", "w_down.weight")) else 0
            n = ref.shape[dim] // 2
            np.testing.assert_array_equal(
                p.detach().numpy(), np.take(ref, range(rank * n,
                                                       (rank + 1) * n),
                                            axis=dim), err_msg=name)


def test_mesh_lines_put_model_innermost():
    """The seq and model groups of dp=2 × sp=2 × tp=2: model innermost
    (tp neighbours adjacent ranks), the (data, seq) sync group spanning
    both; the ring's neighbours and the batch block of each rank."""
    shape = dict.fromkeys(AXES, 1)
    shape.update(data=2, seq=2, model=2)
    assert _lines(shape, ("model",), 8) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert _lines(shape, ("seq",), 8) == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert _lines(shape, ("data", "seq"), 8) == [[0, 2, 4, 6],
                                                 [1, 3, 5, 7]]
    m = _mesh(5, data=2, seq=2, model=2)
    assert m.coords()["data"] == 1 and m.coords()["model"] == 1
    assert (m.peer(SEQ, 1), m.peer(SEQ, -1)) == (7, 7)
    assert m.batch_index() == (1, 2)


@pytest.fixture
def one_rank_group(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    td.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                          f"{_free_port()}", rank=0, world_size=1)
    try:
        yield
    finally:
        td.destroy_process_group()


def test_mesh_spec_rejects_bad_shape(one_rank_group):
    with pytest.raises(ValueError, match="needs 6 devices, have 1"):
        MeshSpec(dp=3, tp=2).build(device="cpu")
    mesh = MeshSpec(sp=1, tp=1).build(device="cpu")
    assert mesh.shape[SEQ] == mesh.shape[MODEL] == 1


def test_unported_pairings_name_item_11():
    """The pipeline axis beside tp, tp beside fsdp, tp beside ep (tp
    inside the MoE block), make_accum_train_step on a tp or sp mesh and
    xent_chunk on a model axis raise NotImplementedError naming item 11;
    seq_axis=False on an sp mesh raises."""
    for spec in (dict(pp=2, tp=2), dict(fsdp=2, tp=2), dict(ep=2, tp=2),
                 dict(fsdp=2, sp=2)):
        with pytest.raises(NotImplementedError, match="item 11"):
            MeshSpec(**spec).build(device="cpu")
    for mesh in (_mesh(model=2), _mesh(seq=2)):
        with pytest.raises(NotImplementedError, match="item 11"):
            ttrain.make_accum_train_step(mesh=mesh, microbatches=2)
    with pytest.raises(NotImplementedError, match="item 11"):
        get_model("llama-tiny", device="cpu", xent_chunk=8,
                  mesh=_mesh(model=2))
    with pytest.raises(NotImplementedError, match="item 11"):
        get_model("llama-moe-tiny", device="cpu", mesh=_mesh(model=2))
    for call in (lambda m: ttrain.make_train_step(mesh=m, seq_axis=False),
                 lambda m: ttrain.global_batch(m, {"x": np.zeros((2, 4))},
                                               seq_axis=False)):
        with pytest.raises(ValueError, match="seq_axis=False"):
            call(_mesh(seq=2))


def test_example_knobs_through_the_minipod(tmp_path):
    """The example's knobs through the port's `tony submit --framework
    pytorch` MiniPod: four workers train llama-tiny on MESH_TP=2 ×
    MESH_SP=2 with ring attention; every task succeeds and rank 0 writes
    finite, falling losses."""
    job = MiniPod(tmp_path).run({
        "tony.application.framework": "pytorch",
        "tony.worker.instances": "4",
        "tony.application.executes": "python torch_sharded_steps.py",
        "tony.worker.env": "MODEL=llama-tiny,MESH_TP=2,MESH_SP=2,STEPS=3,"
                           "SEQ=16,BATCH=2",
    }, src_dir=WORKLOADS, timeout=240)
    assert job.exit_code == 0, [
        (t.task_id, t.status.value, t.diagnostics) for t in job.session]
    [result] = [json.loads(p.read_text())
                for p in Path(job.am.job_dir).rglob("result.json")]
    assert result["mesh"] == {"seq": 2, "model": 2}
    losses = result["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
