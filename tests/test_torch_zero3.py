"""ZeRO-3 over the fsdp axis in the port, on the CPU: the planner
(``plan_sharded``, shard-major ``pack``, the ``shard``/``gathered``
layouts, ``unpack_shards``, the reduce schedule) and the forward gather
schedule (``GatherPlan``) against the JAX package's on the reference
tests' trees, exactly; the sharded fused update ``torch.equal`` to the
port's leaf-wise AdamW on the same shards, pad rows inert; and the port
on 2 and 4 gloo ranks (``fsdp=2``, ``fsdp=4``, ``dp=2 x fsdp=2``;
tests/workloads/torch_zero3_steps.py) against the JAX package's
``make_accum_train_step`` and ``make_train_step`` on
``make_mesh(n_devices=N, ...)`` — llama-tiny with its logical axes and
mnist-mlp with the reference's ``fsdp_shard_state`` layout, f32 —
within 1e-5; the uneven path against the port's own one-process step;
bucketed and per-leaf gathers and every prefetch depth bitwise; each
rank's parameter and optimizer storage 1/fsdp of the whole; a step saved
at fsdp=4 restored at fsdp=2, in one process and by JAX, and a JAX fsdp=2
step restored by the port; and a two-worker ``tony submit --framework
pytorch`` job at fsdp=2. Against JAX the updates are SGD (AdamW's first
steps magnify last-bit grad differences, ROADMAP.md queue 3); the
storage and checkpoint runs use AdamW."""

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
import torch.distributed as td

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from tony_tpu import ckpt as jckpt
from tony_tpu import parallel as jpar
from tony_tpu import train as jtrain
from tony_tpu.benchmark import fsdp_shard_state
from tony_tpu.minipod import MiniPod
from tony_tpu.models import get_model as jax_model
from tony_tpu.ops import fused_optim as jfo
from tony_tpu.parallel import overlap as joverlap
from tony_tpu.parallel import sched as jsched
from tony_tpu.session import TaskStatus
from torch_ranks import wait_ranks
from tony_tpu_torch import ckpt, profiler
from tony_tpu_torch import train as ttrain
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import params_from_jax
from tony_tpu_torch.ops import fused_optim as fo
from tony_tpu_torch.parallel import (AXES, DATA, FSDP, Mesh, MeshSpec,
                                     logical_spec, sched)
from tony_tpu_torch.parallel import overlap
from tony_tpu_torch.parallel.overlap import GradBuckets

ROOT = Path(__file__).resolve().parent.parent
WORKLOADS = Path(__file__).parent / "workloads"
RANK_TIMEOUT_S = 240
TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(world, cfg, prefix):
    """``world`` gloo ranks of the worker on ``cfg``; returns rank 0's
    report and each rank's."""
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
            [sys.executable, str(WORKLOADS / "torch_zero3_steps.py"),
             str(cpath), f"{prefix}{rank}"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    wait_ranks(procs, RANK_TIMEOUT_S, "torch_zero3_steps.py")
    return [json.loads(Path(f"{prefix}{r}.json").read_text())
            for r in range(world)]


def _params(prefix, run):
    return dict(np.load(f"{prefix}0.{run}.npz"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, what):
    """Per tensor: max |Δ| ≤ 1e-5 (the reference's ZeRO-3 pins)."""
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], atol=TOL, rtol=0,
                                   err_msg=f"{what}: {name}")


def _metrics_close(got, ref, what):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for key in ("loss", "grad_norm"):
            assert g[key] == pytest.approx(r[key], rel=TOL), (what, key)
        assert g["aux_loss"] == 0.0


def _same(a, b, what):
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name],
                                      err_msg=f"{what}: {name}")


# ---------------------------------------------------------------------------
# The planner and the gather schedule against the reference's, exactly
# ---------------------------------------------------------------------------

def _jtree(tree):
    """A reference tree (dict) → its flatten-order leaves as numpy and the
    port's tensors (bf16 through its bits)."""
    leaves = [np.asarray(l) for l in jax.tree.leaves(tree)]
    return leaves, [_tensor(l) for l in leaves]


def _tensor(arr):
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _bits(arr):
    arr = np.asarray(arr)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _zero3_tree():
    """test_fused_optim.py::_zero3_tree: sharded, uneven, bf16,
    replicated and scalar leaves."""
    ks = jax.random.split(jax.random.PRNGKey(3), 8)
    params = {"w1": jax.random.normal(ks[0], (16, 8), jnp.float32),
              "w2": jax.random.normal(ks[1], (6, 8), jnp.float32),
              "w3": jax.random.normal(ks[2], (8, 4), jnp.bfloat16),
              "bias": jax.random.normal(ks[3], (5,), jnp.float32),
              "scale": jnp.float32(1.5)}
    specs = {"w1": P("fsdp"), "w2": P("fsdp"), "w3": P("fsdp"),
             "bias": P(), "scale": P()}
    return params, specs, 256


def _mixed_tree():
    """test_sched.py::_mixed_tree."""
    k = jax.random.split(jax.random.PRNGKey(7), 4)
    params = {"w": jax.random.normal(k[0], (8, 16)),
              "u": jax.random.normal(k[1], (6, 16)),
              "b": jax.random.normal(k[2], (16,)),
              "s": jnp.float32(0.5)}
    specs = {"w": P("fsdp"), "u": P("fsdp"), "b": P(), "s": P()}
    return params, specs, 1 << 20


def _edge_big_tree():
    """TestPlanShardedEdgeCases::test_single_leaf_larger_than_bucket_bytes."""
    params = {"big": jnp.arange(64 * 16, dtype=jnp.float32).reshape(64, 16),
              "small": jnp.ones((8, 4))}
    return params, {"big": P("fsdp"), "small": P("fsdp")}, 1024


def _edge_replicated_tree():
    """TestPlanShardedEdgeCases::test_pure_replicated_tree_falls_back."""
    k = jax.random.split(jax.random.PRNGKey(1), 2)
    params = {"a": jax.random.normal(k[0], (8, 4)),
              "b": jax.random.normal(k[1], (16,))}
    return params, {"a": P(), "b": P()}, 1 << 20


def _dim1_tree():
    """Leaves sharded on dim 1 and dim 0 in one bucket (the port's torch
    weights shard their ``in`` dim, dim 1)."""
    k = jax.random.split(jax.random.PRNGKey(5), 3)
    params = {"a": jax.random.normal(k[0], (3, 8)),
              "b": jax.random.normal(k[1], (8, 5)),
              "c": jax.random.normal(k[2], (4, 6))}
    return params, {"a": P(None, "fsdp"), "b": P("fsdp"),
                    "c": P(None, "fsdp")}, 1 << 20


TREES = {"zero3": _zero3_tree, "mixed": _mixed_tree, "big": _edge_big_tree,
         "replicated": _edge_replicated_tree, "dim1": _dim1_tree}


def _specs(specs):
    """Reference PartitionSpecs (flatten order) → the port's tuples."""
    return [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, P))]


def _plans(name, shard_size=4):
    params, specs, bb = TREES[name]()
    jleaves, tleaves = _jtree(params)
    ref = joverlap.GradBuckets.plan_sharded(params, specs,
                                            shard_size=shard_size,
                                            bucket_bytes=bb)
    got = GradBuckets.plan_sharded(tleaves, _specs(specs),
                                   shard_size=shard_size, bucket_bytes=bb)
    return ref, got, params, jleaves, tleaves


def _mesh(**shape):
    """A port mesh of the given axis sizes, without process groups (for
    the pure planning functions)."""
    full = dict.fromkeys(AXES, 1)
    full.update(shape)
    return Mesh(shape=full, processes=math.prod(full.values()),
                device=torch.device("cpu"))


class TestPlanner:
    @pytest.mark.parametrize("shard_size", [2, 4])
    @pytest.mark.parametrize("name", sorted(TREES))
    def test_plan_sharded_equals_the_reference(self, name, shard_size):
        ref, got, *_ = _plans(name, shard_size)
        for field in ("shapes", "buckets", "bucket_nbytes", "bucket_numel",
                      "threshold", "shard_size", "shard_dims",
                      "bucket_scatter", "shard_pads", "bucket_padded"):
            assert getattr(got, field) == getattr(ref, field), field
        assert [str(d).rpartition(".")[2] for d in got.dtypes] == \
            [np.dtype(d).name for d in ref.dtypes]
        for i in range(len(got.shapes)):
            assert got.padded_shape(i) == ref.padded_shape(i)
            assert got.shard_shape(i) == ref.shard_shape(i)
        assert got.n_scatter_buckets == ref.n_scatter_buckets

    @pytest.mark.parametrize("name", sorted(TREES))
    def test_pack_and_every_layout_equal_the_reference(self, name):
        """Shard-major pack (uneven leaves zero-padded), ``full``,
        ``shard`` (each rank's chunk) and ``gathered`` unpacking and
        ``unpack_shards``: bit for bit the reference's."""
        ref, got, params, jleaves, tleaves = _plans(name)
        jbufs = ref.pack(params)
        tbufs = got.pack(tleaves)
        for jb, tb in zip(jbufs, tbufs):
            np.testing.assert_array_equal(_numpy(tb), _bits(jb))
        for b in range(got.n_buckets):
            layouts = ["gathered"] if got._is_scatter(b) else ["full"]
            for layout in layouts:
                want = ref.leaf_buffers(b, jbufs[b], layout=layout)
                have = got.leaf_buffers(b, tbufs[b], layout=layout)
                assert sorted(want) == sorted(have)
                for i in want:
                    np.testing.assert_array_equal(
                        _numpy(have[i].contiguous()), _bits(want[i]))
            if got._is_scatter(b):
                n = got.bucket_numel[b] // got.shard_size
                for f in range(got.shard_size):
                    want = ref.leaf_buffers(
                        b, jbufs[b][f * n:(f + 1) * n], layout="shard")
                    have = got.leaf_buffers(b, tbufs[b][f * n:(f + 1) * n],
                                            layout="shard")
                    for i in want:
                        np.testing.assert_array_equal(_numpy(have[i]),
                                                      _bits(want[i]))
        chunks_j = [jb[:got.local_numel(b)] for b, jb in enumerate(jbufs)]
        chunks_t = [tb[:got.local_numel(b)] for b, tb in enumerate(tbufs)]
        want = jax.tree.leaves(ref.unpack_shards(chunks_j))
        for w, h in zip(want, got.unpack_shards(chunks_t)):
            np.testing.assert_array_equal(_numpy(h), _bits(w))

    def test_reduce_schedule_equals_the_reference(self):
        _, got, params, _, _ = _plans("zero3")
        for n, kw in ((4, dict(fsdp=4)), (8, dict(fsdp=4)),
                      (4, dict(fsdp=2))):
            jmesh = jpar.make_mesh(n_devices=n, **kw)
            dp = n // kw["fsdp"]
            plan = GradBuckets.plan_sharded(
                _jtree(params)[1], _specs(_zero3_tree()[1]),
                shard_size=kw["fsdp"], bucket_bytes=256)
            jplan = joverlap.GradBuckets.plan_sharded(
                params, _zero3_tree()[1], shard_size=kw["fsdp"],
                bucket_bytes=256)
            for op in ("all_reduce", "reduce_scatter"):
                want = joverlap.reduce_schedule(jplan, jmesh, reduce_op=op)
                have = overlap.reduce_schedule(
                    plan, _mesh(data=dp, fsdp=kw["fsdp"]), reduce_op=op)
                assert [(m, [tuple(g) for g in post])
                        for m, post in have[0]] == \
                    [(m, [tuple(g) for g in post]) for m, post in want[0]]
                assert have[2:] == want[2:]
        with pytest.raises(NotImplementedError, match="item 8"):
            overlap.reduce_schedule(got, _mesh(fsdp=4),
                                    hierarchy="hierarchical")
        with pytest.raises(ValueError, match="reduce op"):
            overlap.reduce_schedule(got, _mesh(fsdp=4), reduce_op="x")

    def test_region_specs_and_step_plans(self):
        ref, got, params, _, tleaves = _plans("zero3")
        specs = _zero3_tree()[1]
        want_specs, want_uneven = joverlap.region_param_specs(ref, specs)
        have_specs, have_uneven = overlap.region_param_specs(
            got, _specs(specs))
        assert have_uneven == want_uneven == [(6, 8)]
        assert [tuple(s) for s in jax.tree.leaves(
            want_specs, is_leaf=lambda x: isinstance(x, P))] == have_specs
        plan, gplan = overlap.step_plans(
            tleaves, _mesh(fsdp=4), bucket_bytes=256,
            param_specs=_specs(specs), prefetch=2)
        assert plan == got and gplan.prefetch == 2

    def test_planner_errors(self):
        with pytest.raises(ValueError, match="disagree"):
            GradBuckets.plan_sharded([torch.zeros(4)], [], shard_size=2)
        for spec, match in ((("fsdp", "fsdp"), "two dims"),
                            ((("fsdp", "model"),), "alone"),
                            (("model",), "only 'fsdp'")):
            with pytest.raises(ValueError, match=match):
                GradBuckets.plan_sharded([torch.zeros(4, 4)], [spec],
                                         shard_size=2)


class TestGatherPlan:
    @pytest.mark.parametrize("name", sorted(TREES))
    @pytest.mark.parametrize("prefetch", [0, 1, 2])
    def test_schedule_equals_the_reference(self, name, prefetch):
        ref, got, *_ = _plans(name)
        want = jsched.GatherPlan.from_buckets(ref, prefetch=prefetch)
        have = sched.GatherPlan.from_buckets(got, prefetch=prefetch)
        for field in ("gather_buckets", "gather_leaves", "passthrough",
                      "gather_nbytes", "n_gather_buckets", "prefetch",
                      "axis"):
            assert getattr(have, field) == getattr(want, field), field
        assert have.window_nbytes() == want.window_nbytes()

    @pytest.mark.parametrize("prefetch", [0, 1, 2])
    def test_many_buckets_equal_the_reference(self, prefetch):
        """test_sched.py::test_gather_bitexact_vs_per_leaf's tree: six
        leaves over several 512-byte gather buckets."""
        k = jax.random.split(jax.random.PRNGKey(0), 6)
        params = {f"w{i}": jax.random.normal(k[i], (8, 4 + i))
                  for i in range(6)}
        specs = jax.tree.map(lambda _: P("fsdp"), params)
        ref = joverlap.GradBuckets.plan_sharded(params, specs, shard_size=4,
                                                bucket_bytes=512)
        got = GradBuckets.plan_sharded(_jtree(params)[1], _specs(specs),
                                       shard_size=4, bucket_bytes=512)
        want = jsched.GatherPlan.from_buckets(ref, prefetch=prefetch)
        have = sched.GatherPlan.from_buckets(got, prefetch=prefetch)
        assert have.gather_buckets == want.gather_buckets
        assert have.n_gather_buckets > 1
        assert have.gather_nbytes == want.gather_nbytes
        assert have.window_nbytes() == want.window_nbytes()

    def test_rejects_negative_prefetch(self):
        with pytest.raises(ValueError, match="prefetch"):
            sched.GatherPlan.from_buckets(GradBuckets.plan([torch.zeros(3)]),
                                          prefetch=-1)


class TestShardedFusedUpdate:
    """One ZeRO-3 plan's chunks through the fused update: every rank's
    chunk of every bucket ``torch.equal`` to the port's leaf-wise AdamW
    (``train.adamw``) on the same shard leaves, three steps; the pad rows
    of the padded bucket stay zero in p and every slot."""

    def test_every_rank_chunk_equals_leaf_wise_adamw(self):
        _, plan, params, _, tleaves = _plans("zero3")
        grads = [t.float().mul(0.5).add(0.25).to(t.dtype) for t in tleaves]
        fused = fo.FusedOptimizer(rule="adamw", lr=1e-3, weight_decay=1e-2,
                                  bucket_bytes=256)
        leafwise = ttrain.adamw(1e-3, weight_decay=1e-2)
        ones = plan.pack([torch.ones_like(t, dtype=torch.float32)
                          for t in tleaves])
        for b in range(plan.n_buckets):
            p_full, g_full = plan.pack_bucket(b, tleaves), \
                plan.pack_bucket(b, grads)
            n = plan.local_numel(b)
            ranks = range(plan.shard_size) if plan._is_scatter(b) else [0]
            for f in ranks:
                p = p_full[f * n:(f + 1) * n].clone()
                g = g_full[f * n:(f + 1) * n].clone()
                slots = [torch.zeros(n), torch.zeros(n)]
                layout = "shard" if plan._is_scatter(b) else "full"
                leaves_p = [v.clone() for v in plan.leaf_buffers(
                    b, p, layout=layout).values()]
                leaves_g = list(plan.leaf_buffers(b, g,
                                                  layout=layout).values())
                state = leafwise.init(leaves_p)
                for count in (1, 2, 3):
                    fo.fused_bucket_update(g, p, slots, fused.scalars(
                        count, "cpu"), rule="adamw", hyper=fused.hyper)
                    state = leafwise.update(leaves_g, state, leaves_p)
                got = plan.leaf_buffers(b, p, layout=layout).values()
                for a, c in zip(got, leaves_p):
                    assert torch.equal(a, c), (b, f)
                mu = plan.leaf_buffers(b, slots[0], layout=layout) \
                    if p.dtype == torch.float32 else None
                if mu is not None:
                    for a, c in zip(mu.values(), state.mu):
                        assert torch.equal(a, c), (b, f, "mu")
                if plan._is_padded(b):
                    pad = ones[b][f * n:(f + 1) * n] == 0
                    for buf in [p] + slots:
                        assert not buf[pad].any(), (b, f)


# ---------------------------------------------------------------------------
# Meshes and logical axes
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_group(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK", "INIT_METHOD"):
        monkeypatch.delenv(name, raising=False)
    td.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                          f"{_free_port()}", rank=0, world_size=1)
    profiler.reset_collective_records()
    try:
        yield
    finally:
        td.destroy_process_group()


class TestMeshAndLogicalAxes:
    def test_rules_and_logical_spec_equal_the_reference(self):
        from tony_tpu_torch.parallel import RULES, BATCH_AXES

        assert RULES == jpar.RULES
        assert BATCH_AXES == tuple(jpar.batch_sharding(
            jpar.make_mesh(n_devices=1)).spec[0])
        for axes in (("embed", "heads"), ("vocab", "embed"), ("norm",),
                     (None, "ffn"), ("batch", "act_seq")):
            want = tuple(jpar.logical_sharding(jpar.make_mesh(n_devices=1),
                                               *axes).spec)
            assert logical_spec(*axes) == want
        with pytest.raises(ValueError, match="unknown logical axis"):
            logical_spec("embd")
        assert logical_spec("embd", allow_unknown=True) == (None,)

    def test_decoder_specs_equal_the_reference_param_shardings(self):
        """Every parameter's spec is the reference's ``param_shardings``
        spec of the same leaf, in the port's layout (kernels reversed;
        the scanned layer axis dropped)."""
        jm = jax_model("llama-tiny", dtype=jnp.float32)
        _, shardings = jtrain.param_shardings(
            jm, jnp.zeros((1, 8), jnp.int32),
            jpar.make_mesh(n_devices=4, fsdp=2))
        flat = {jax.tree_util.keystr(k): tuple(v.spec) for k, v in
                jax.tree_util.tree_flatten_with_path(shardings)[0]}
        model = get_model("llama-tiny", device="cpu")
        specs = dict(zip([n for n, _ in model.named_parameters()],
                         ttrain.param_specs(model)))
        assert specs["embedding"] == flat["['embedding']"][:2]
        assert specs["lm_head.weight"] == \
            flat["['lm_head']['kernel']"][::-1]
        for name, jname in (("attn.wq", "['attn']['wq']"),
                            ("attn.wo", "['attn']['wo']"),
                            ("mlp.w_down", "['mlp']['w_down']")):
            ref = flat[f"['layers']['block']{jname}['kernel']"]
            assert specs[f"layers.0.{name}.weight"] == tuple(ref[1:][::-1])
        assert specs["final_norm.scale"] == (None,)
        mlp = get_model("mnist-mlp", hidden=8, device="cpu")
        assert ttrain.param_specs(mlp) == [()] * 6

    def test_mesh_coords_and_groups(self, one_rank_group):
        mesh = MeshSpec(dp=0, fsdp=1).build(device="cpu")
        assert mesh.shape[DATA] == 1 and mesh.shape[FSDP] == 1
        assert mesh.coords() == dict.fromkeys(AXES, 0)
        assert mesh.group((FSDP,)) is None and mesh.group((DATA, FSDP)) \
            is None
        m = _mesh(data=2, fsdp=4)
        assert m.coords(6) == {**dict.fromkeys(AXES, 0), DATA: 1, FSDP: 2}
        with pytest.raises(KeyError, match="no process group"):
            m.group((FSDP,))
        with pytest.raises(ValueError, match="needs 2 devices"):
            MeshSpec(dp=1, fsdp=2).build(device="cpu")
        with pytest.raises(ValueError, match="not divisible"):
            MeshSpec(dp=0, fsdp=3).build(device="cpu")

    def test_fsdp_size_one_is_the_replicated_state(self, one_rank_group):
        """A mesh with fsdp=1 shards nothing: no layout is attached and
        the state is the data-parallel one."""
        mesh = MeshSpec(fsdp=1).build(device="cpu")
        model = get_model("llama-tiny", device="cpu")
        ttrain.create_train_state(model, ttrain.adamw(1e-3), mesh=mesh)
        assert overlap.fsdp_param_specs(list(model.parameters()),
                                        mesh) is None


# ---------------------------------------------------------------------------
# The port on gloo ranks against the JAX package
# ---------------------------------------------------------------------------

MESHES = {"fsdp2": (2, 1, 2), "fsdp4": (4, 1, 4), "dp2_fsdp2": (4, 2, 2)}
TINY_TOKENS = np.random.RandomState(21).randint(0, 256, (8, 17)).astype(
    np.int32)
BB = 16384
SGD = {"rule": "sgd", "learning_rate": 0.1}
FUSED_SGD = {"rule": "sgd", "lr": 0.1, "momentum": 0.0, "bucket_bytes": BB}
ADAMW = {"rule": "adamw", "learning_rate": 1e-3}
FUSED_ADAMW = {"rule": "adamw", "lr": 1e-3, "weight_decay": 1e-4,
               "bucket_bytes": BB}


def _tiny_runs(mesh_name):
    accum = {"step": "accum", "microbatches": 2, "steps": 2,
             "bucket_bytes": BB}
    runs = {
        "optax_ar": {**accum, "tx": SGD},
        "optax_rs": {**accum, "tx": SGD, "reduce_op": "reduce_scatter"},
        "fused_ar": {**accum, "update": "fused_bucket", "tx": FUSED_SGD},
        "fused_rs": {**accum, "update": "fused_bucket", "tx": FUSED_SGD,
                     "reduce_op": "reduce_scatter"},
        "train": {"step": "train", "steps": 2, "tx": SGD},
        "update": {"step": "update", "steps": 3, "update": "fused_bucket",
                   "tx": FUSED_ADAMW},
        "adamw": {**accum, "tx": ADAMW},
        "fused_adamw": {**accum, "update": "fused_bucket",
                        "tx": FUSED_ADAMW},
    }
    if mesh_name == "fsdp4":
        runs.update({
            "per_leaf": {**accum, "tx": SGD, "gather": "per_leaf"},
            "prefetch0": {**accum, "tx": SGD, "prefetch": 0},
            "prefetch2": {**accum, "tx": SGD, "prefetch": 2},
            "fused_per_leaf": {**accum, "update": "fused_bucket",
                               "tx": FUSED_SGD, "gather": "per_leaf"},
        })
    return runs


def _jax_tiny_state(tx, mesh):
    model = jax_model("llama-tiny", dtype=jnp.float32, xent_chunk=8)
    return model, jtrain.create_train_state(
        model, tx, jnp.asarray(TINY_TOKENS), jax.random.PRNGKey(0),
        mesh=mesh)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX llama-tiny weights (xent_chunk=8, f32) as the port's npz,
    and the JAX package's runs on each mesh: two SGD(0.1) steps of
    ``make_accum_train_step`` (microbatches 2, 16 KiB buckets) and of
    ``make_train_step``, and a two-step fused-SGD run on fsdp=2."""
    root = tmp_path_factory.mktemp("zero3_tiny")
    _, st = _jax_tiny_state(optax.sgd(0.1), None)
    init = {k: v.numpy() for k, v in params_from_jax(
        _np(st.params)).items()}
    np.savez(root / "init.npz", **init)
    np.savez(root / "batch.npz", x=TINY_TOKENS)
    refs = {}
    for name, (n, dp, fsdp) in MESHES.items():
        mesh = jpar.make_mesh(n_devices=n, fsdp=fsdp)
        out = {}
        steps = {
            "accum": jtrain.make_accum_train_step(
                lambda o, b: o, mesh, microbatches=2, bucket_bytes=BB,
                apply_kwargs_of=lambda b: {"targets": b["x"]},
                donate=False),
            "train": jtrain.make_train_step(
                lambda o, b: o, mesh=mesh, donate=False,
                apply_kwargs_of=lambda b: {"targets": b["x"]})}
        for kind, step in steps.items():
            _, js = _jax_tiny_state(optax.sgd(0.1), mesh)
            js = js.replace(params=jax.device_put(
                st.params, jax.tree.map(lambda a: a.sharding, js.params)))
            metrics = []
            for _ in range(2):
                js, m = step(js, {"x": jnp.asarray(TINY_TOKENS)})
                metrics.append({k: float(v) for k, v in m.items()})
            out[kind] = (metrics, {k: v.numpy() for k, v in params_from_jax(
                _np(js.params)).items()})
        refs[name] = out
    return root, init, refs


@pytest.fixture(scope="module")
def tiny_runs(tiny, tmp_path_factory):
    root, _, _ = tiny
    out = {}
    for name, (n, dp, fsdp) in MESHES.items():
        prefix = str(root / f"{name}_")
        runs = _tiny_runs(name)
        if name == "fsdp4":
            runs["adamw"]["save_dir"] = str(root / "ck_adamw")
            runs["fused_adamw"]["save_dir"] = str(root / "ck_fused")
        cfg = {"model": "llama-tiny", "targets": True,
               "model_kwargs": {"xent_chunk": 8, "dtype": "float32"},
               "dp": dp, "fsdp": fsdp, "init": str(root / "init.npz"),
               "batch": str(root / "batch.npz"), "runs": runs}
        out[name] = (_run_ranks(n, cfg, prefix), prefix)
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("run", ["optax_ar", "optax_rs", "fused_ar",
                                 "fused_rs"])
def test_accum_step_matches_jax(tiny, tiny_runs, mesh_name, run):
    """make_accum_train_step(mesh=) on a ZeRO-3 llama-tiny state, two
    steps: loss, grad norm (every step) and the gathered parameters
    within 1e-5 of the JAX package's ZeRO-3 accumulating step on the same
    mesh (SGD; the fused runs' sgd rule with momentum 0 is the same
    update), and every rank reports the same metrics."""
    _, _, refs = tiny
    reports, prefix = tiny_runs[mesh_name]
    ref_metrics, ref_params = refs[mesh_name]["accum"]
    for rep in reports:
        _metrics_close(rep["runs"][run]["metrics"], ref_metrics, run)
    _close(_params(prefix, run), ref_params, run)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_train_step_matches_jax(tiny, tiny_runs, mesh_name):
    """make_train_step(mesh=) on a ZeRO-3 state (the engine with one
    microbatch) against the JAX make_train_step (GSPMD's ZeRO-3)."""
    _, _, refs = tiny
    reports, prefix = tiny_runs[mesh_name]
    ref_metrics, ref_params = refs[mesh_name]["train"]
    _metrics_close(reports[0]["runs"]["train"]["metrics"], ref_metrics,
                   "train")
    _close(_params(prefix, "train"), ref_params, "train")


def test_fused_matches_the_jax_fused_step(tiny, tiny_runs):
    """The port's fused ZeRO-3 step against the JAX package's
    ``update="fused_bucket"`` on fsdp=2 (interpret mode), two steps."""
    root, _, _ = tiny
    mesh = jpar.make_mesh(n_devices=2, fsdp=2)
    _, js = _jax_tiny_state(jfo.FusedOptimizer(
        rule="sgd", lr=0.1, momentum=0.0, bucket_bytes=BB, interpret=True),
        mesh)
    step = jtrain.make_accum_train_step(
        lambda o, b: o, mesh, microbatches=2, update="fused_bucket",
        bucket_bytes=BB, apply_kwargs_of=lambda b: {"targets": b["x"]},
        donate=False)
    metrics = []
    for _ in range(2):
        js, m = step(js, {"x": jnp.asarray(TINY_TOKENS)})
        metrics.append({k: float(v) for k, v in m.items()})
    reports, prefix = tiny_runs["fsdp2"]
    for run in ("fused_ar", "fused_rs"):
        _metrics_close(reports[0]["runs"][run]["metrics"], metrics, run)
        _close(_params(prefix, run), {k: v.numpy() for k, v in
                                      params_from_jax(_np(js.params))
                                      .items()}, run)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_fused_update_step_on_shards_is_the_one_process_update(
        tiny, tiny_runs, mesh_name):
    """``fused_update_step(mesh=)`` on each rank's leaves (its chunk of
    every scatter bucket packed locally, one launch a bucket), three
    AdamW steps with grads made from the parameters: every gathered
    parameter bitwise the one-process ``fused_update_step``'s, the grad
    norm within 1e-5 (summed in another order)."""
    root, init, _ = tiny
    reports, prefix = tiny_runs[mesh_name]
    model = get_model("llama-tiny", device="cpu", dtype=torch.float32,
                      xent_chunk=8)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    tx = fo.FusedOptimizer(**FUSED_ADAMW)
    state = ttrain.create_train_state(model, tx)
    norms = []
    for _ in range(3):
        params = list(model.parameters())
        grads = [p.detach() * 0.01 + 0.001 for p in params]
        _, state.opt_state, gnorm = fo.fused_update_step(
            tx, params, grads, state.opt_state)
        norms.append(float(gnorm))
    _same(_params(prefix, "update"), {n: p.detach().numpy() for n, p in
                                      model.named_parameters()}, "update")
    for got, ref in zip(reports[0]["runs"]["update"]["metrics"], norms):
        assert got["grad_norm"] == pytest.approx(ref, rel=TOL)


@pytest.mark.parametrize("run", ["per_leaf", "prefetch0", "prefetch2"])
def test_gather_modes_are_bitwise(tiny_runs, run):
    """gather="per_leaf" and prefetch 0/1/2 give the bucketed prefetch-1
    run's bits: loss, grad norm and every parameter (data movement
    only)."""
    reports, prefix = tiny_runs["fsdp4"]
    for rep in reports:
        assert rep["runs"][run]["metrics"] == rep["runs"]["optax_ar"][
            "metrics"]
    _same(_params(prefix, run), _params(prefix, "optax_ar"), run)
    _same(_params(prefix, "fused_per_leaf"), _params(prefix, "fused_ar"),
          "fused per_leaf")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("run", ["adamw", "fused_adamw", "optax_rs",
                                 "fused_rs"])
def test_each_rank_holds_one_fsdp_share(tiny_runs, mesh_name, run):
    """Every even leaf's parameter and optimizer-state storage on a rank
    is 1/fsdp of the whole, before and after the steps; replicated leaves
    (the norm scales) whole. llama-tiny's widths divide 2 and 4, so every
    projection and the embedding and head are sharded."""
    reports, _ = tiny_runs[mesh_name]
    fsdp = MESHES[mesh_name][2]
    for rep in reports:
        for when in ("before", "after"):
            rec = rep["runs"][run][when]
            sharded = [loc * fsdp == whole for loc, whole in rec["params"]]
            assert sum(sharded) == len(sharded) - 5   # 2 x 2 norms + final
            for loc, whole in rec["params"]:
                assert loc * fsdp == whole or loc == whole == 64
            if "slot_whole" in rec:
                for bufs in rec["slots"]:
                    for n, whole, sc in zip(bufs, rec["slot_whole"],
                                            rec["scatter"]):
                        assert n * (fsdp if sc else 1) == whole
                assert any(rec["scatter"])
            else:
                for (loc, whole), (ploc, pwhole) in zip(
                        rec["slots"], rec["params"] * 2):
                    assert (loc, whole) == (ploc, pwhole)


def test_fused_plan_pieces_equal_the_reference():
    """``plan_for`` of a sharded state, ``bucket_specs``,
    ``region_collectives`` and ``init_state``'s per-rank slot sizes on
    the reference's ZeRO-3 tree."""
    ref, got, *_ = _plans("zero3")
    jfused = jfo.FusedOptimizer(bucket_bytes=256)
    fused = fo.FusedOptimizer(bucket_bytes=256)
    assert fused.bucket_specs(got) == [tuple(s) for s in
                                       jfused.bucket_specs(ref)]
    assert fused.region_collectives(got) == jfused.region_collectives(ref)
    assert fused.region_collectives(got, sharded=False) == []
    slots = fused.init_state([torch.zeros(1)], plan=got)["slots"]
    assert [b.numel() for b in slots["mu"]] == [
        n // 4 if sc else n for n, sc in zip(ref.bucket_numel,
                                             ref.bucket_scatter)]


def test_replicated_plan_reduce(one_rank_group):
    """``GradBuckets.reduce`` (the replicated-plan primitive): both ops
    sum over the group — on one rank, the leaves themselves, in new
    tensors — and a scatter plan is refused."""
    leaves = [torch.arange(6.0).reshape(2, 3), torch.ones(5)]
    plan = GradBuckets.plan(leaves, 16)
    for op in ("all_reduce", "reduce_scatter"):
        out = plan.reduce(leaves, op=op, group_size=1)
        for a, b in zip(out, leaves):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    _, sharded, *_ = _plans("zero3")
    with pytest.raises(ValueError, match="replicated-plan"):
        sharded.reduce([])


def test_records_name_the_planes(tiny_runs):
    """The step records its reduce levels and forward gathers under the
    reference's schema (``grad_reduce`` psum_scatter over fsdp,
    ``fwd_gather`` with gather/prefetch/per_microbatch, its bytes those
    of a microbatch's forward and backward gathers) and the plan under
    ``accum_step``."""
    reports, _ = tiny_runs["dp2_fsdp2"]
    run = reports[0]["runs"]["optax_ar"]
    col, plan = run["collectives"], run["overlap"]["accum_step"]
    scatter = col["accum.grad.ici.psum_scatter"]
    assert scatter["plane"] == "grad_reduce" and scatter["axes"] == [FSDP]
    assert col["accum.grad.ici.all_reduce"]["axes"] == ["slice", "data",
                                                        "fsdp"]
    gather = col["accum.fwd_gather"]
    assert (gather["kind"], gather["plane"], gather["axes"],
            gather["gather"], gather["prefetch"],
            gather["per_microbatch"]) == ("all_gather", "fwd_gather",
                                          [FSDP], "bucketed", 1, 2)
    assert plan["zero3"] is True and plan["n_scatter_buckets"] >= 1
    assert plan["sync_group"] == 4 and plan["microbatches"] == 2
    # The gather window gathers every even scatter bucket twice a
    # microbatch: for its forward and again for its backward.
    assert sum(gather["nbytes"]) == 2 * sum(
        n for n, lv in zip(plan["bucket_nbytes"], plan["levels"][0][
            "bucket_nbytes"]) if lv)
    train = reports[0]["runs"]["train"]["collectives"]["accum.fwd_gather"]
    assert train["per_microbatch"] == 1


# ---------------------------------------------------------------------------
# mnist-mlp: the replicated path, fsdp_shard_state's layout, uneven leaves
# ---------------------------------------------------------------------------

MNIST_HIDDEN = 32


def _first_divisible(shape, fsdp):
    """benchmark.fsdp_shard_state's rule on a JAX leaf shape."""
    for d, n in enumerate(shape):
        if n % fsdp == 0:
            return d
    return None


def _mnist_specs(model, fsdp, uneven=False):
    """The port's specs for fsdp_shard_state's layout (its JAX kernel dim
    → the torch weight's), or, ``uneven``, every leaf over its first dim
    in JAX's layout (Dense_2's bias of 10 does not divide 4)."""
    specs = []
    for name, p in model.named_parameters():
        jshape = tuple(p.shape[::-1])
        d = 0 if uneven else _first_divisible(jshape, fsdp)
        if d is None:
            specs.append(())
            continue
        td_ = p.dim() - 1 - d
        specs.append(tuple("fsdp" if k == td_ else None
                           for k in range(p.dim())))
    return specs


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero3_mnist")
    model = jax_model("mnist-mlp", hidden=MNIST_HIDDEN)
    rng = np.random.RandomState(3)
    x = rng.normal(size=(32, 784)).astype(np.float32)
    y = rng.randint(0, 10, (32,)).astype(np.int32)
    state = jtrain.create_train_state(model, optax.sgd(0.1), jnp.asarray(x),
                                      jax.random.PRNGKey(0))
    port = get_model("mnist-mlp", hidden=MNIST_HIDDEN, device="cpu")
    from tony_tpu_torch.models.convert import load_jax_params

    load_jax_params(port, _np(state.params))
    init = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    np.savez(root / "init.npz", **init)
    np.savez(root / "batch.npz", x=x, y=y)
    mesh = jpar.make_mesh(n_devices=4, fsdp=4)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    refs = {}
    for kind, st in (("repl", state), ("zero3", fsdp_shard_state(state,
                                                                 mesh))):
        step = jtrain.make_accum_train_step(mesh=mesh, microbatches=4,
                                            bucket_bytes=1024, donate=False)
        s, metrics = st, []
        for _ in range(2):
            s, m = step(s, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        refs[kind] = (metrics, {
            f"{layer}.{'weight' if leaf == 'kernel' else 'bias'}":
            (np.asarray(v).T if leaf == "kernel" else np.asarray(v))
            for layer, leaves in _np(s.params).items()
            for leaf, v in leaves.items()})
    specs = {"zero3": _mnist_specs(port, 4),
             "uneven": _mnist_specs(port, 4, uneven=True)}
    accum = {"step": "accum", "microbatches": 4, "steps": 2,
             "bucket_bytes": 1024, "tx": SGD}
    runs = {"repl": accum, "zero3": {**accum, "specs": specs["zero3"]},
            "uneven": {**accum, "specs": specs["uneven"]},
            "uneven_rs": {**accum, "specs": specs["uneven"],
                          "reduce_op": "reduce_scatter"},
            "uneven_fused": {**accum, "specs": specs["uneven"],
                             "update": "fused_bucket",
                             "tx": {**FUSED_SGD, "bucket_bytes": 1024}},
            "uneven_train": {"step": "train", "steps": 2, "tx": SGD,
                             "specs": specs["uneven"]}}
    cfg = {"model": "mnist-mlp", "model_kwargs": {"hidden": MNIST_HIDDEN},
           "fsdp": 4, "init": str(root / "init.npz"),
           "batch": str(root / "batch.npz"), "runs": runs}
    prefix = str(root / "m_")
    return refs, _run_ranks(4, cfg, prefix), prefix, init, (x, y)


@pytest.mark.parametrize("kind", ["repl", "zero3"])
def test_mnist_matches_jax(mnist, kind):
    """mnist-mlp (hidden 32) at fsdp=4: replicated (no logical axes, the
    sync group is data x fsdp) and in fsdp_shard_state's ZeRO-3 layout,
    against the JAX package's accumulating step on the same mesh and
    layout, within 1e-5."""
    refs, reports, prefix, _, _ = mnist
    metrics, params = refs[kind]
    _metrics_close(reports[0]["runs"][kind]["metrics"], metrics, kind)
    _close(_params(prefix, kind), params, kind)
    sharded = [loc < whole for loc, whole in
               reports[0]["runs"][kind]["after"]["params"]]
    assert any(sharded) == (kind == "zero3")


@pytest.mark.parametrize("run", ["uneven", "uneven_rs", "uneven_fused",
                                 "uneven_train"])
def test_uneven_leaves_match_the_one_process_step(mnist, run, caplog):
    """Every mnist leaf over fsdp on its JAX dim 0: Dense_2's bias (10
    rows over 4 ranks) is uneven, padded into its own scatter bucket and
    held whole on every rank (warned once per plan); the steps match the
    port's monolithic one-process step on the whole batch within 1e-5."""
    _, reports, prefix, init, (x, y) = mnist
    model = get_model("mnist-mlp", hidden=MNIST_HIDDEN, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    state = ttrain.create_train_state(model, ttrain.sgd(0.1))
    step = ttrain.make_train_step()
    metrics = []
    for _ in range(2):
        state, m = step(state, {"x": torch.from_numpy(x),
                                "y": torch.from_numpy(y)})
        metrics.append({k: float(v) for k, v in m.items()})
    _metrics_close(reports[0]["runs"][run]["metrics"], metrics, run)
    _close(_params(prefix, run), {n: p.detach().numpy() for n, p in
                                  model.named_parameters()}, run)
    rec = reports[0]["runs"][run]["after"]["params"]
    assert rec[-1] == [10, 10]                  # the uneven bias, whole
    assert rec[0][0] * 4 == rec[0][1]
    if run != "uneven_train":
        assert reports[0]["runs"][run]["overlap"]["accum_step"][
            "n_padded_buckets"] == 1


# ---------------------------------------------------------------------------
# Sharded checkpoints: across fsdp sizes and between the packages
# ---------------------------------------------------------------------------

def _port_state(fused, mesh=None, seed=9):
    model = get_model("llama-tiny", device="cpu", dtype=torch.float32,
                      xent_chunk=8, seed=seed)
    tx = fo.FusedOptimizer(**FUSED_ADAMW) if fused else ttrain.adamw(1e-3)
    return ttrain.create_train_state(model, tx, mesh=mesh)


def _restored(root, fused):
    """One process restores a step: parameters and slots by name."""
    state = ckpt.decode_portable(ckpt.restore_pytree(
        root, ckpt.encode_portable(_port_state(fused))))
    names = [n for n, _ in state.model.named_parameters()]
    out = {f"p.{n}": p.detach().numpy().copy()
           for n, p in state.model.named_parameters()}
    if fused:
        plan = state.buckets.plan
        slots = {s: plan.unpack(b) for s, b in
                 state.opt_state["slots"].items()}
        count = state.opt_state["count"]
    else:
        slots = {"mu": state.opt_state.mu, "nu": state.opt_state.nu}
        count = state.opt_state.count
    for s, leaves in slots.items():
        out.update({f"{s}.{n}": t.numpy().copy()
                    for n, t in zip(names, leaves)})
    return state.step, count, out


@pytest.fixture(scope="module")
def jax_fsdp2_step(tiny, tmp_path_factory):
    """A JAX ZeRO-3 AdamW state on fsdp=2 after two accumulating steps,
    saved by the JAX checkpointer."""
    root = tmp_path_factory.mktemp("zero3_jax_ck")
    mesh = jpar.make_mesh(n_devices=2, fsdp=2)
    _, js = _jax_tiny_state(optax.adamw(1e-3), mesh)
    step = jtrain.make_accum_train_step(
        lambda o, b: o, mesh, microbatches=2, bucket_bytes=BB,
        apply_kwargs_of=lambda b: {"targets": b["x"]}, donate=False)
    for _ in range(2):
        js, _ = step(js, {"x": jnp.asarray(TINY_TOKENS)})
    c = jckpt.AsyncCheckpointer(root)
    c.save(js, step=2, block=True)
    c.close()
    return root, js


@pytest.fixture(scope="module")
def restored_at_fsdp2(tiny, tiny_runs, jax_fsdp2_step, tmp_path_factory):
    """fsdp=2 ranks restore the fsdp=4 steps (AdamW and fused AdamW) and
    the JAX fsdp=2 step, take no step, and save them again."""
    root, _, _ = tiny
    out = tmp_path_factory.mktemp("zero3_restore")
    noop = {"step": "accum", "microbatches": 2, "steps": 0}
    runs = {
        "adamw": {**noop, "tx": ADAMW, "restore_dir": str(root / "ck_adamw"),
                  "save_dir": str(out / "adamw")},
        "fused": {**noop, "tx": FUSED_ADAMW, "update": "fused_bucket",
                  "restore_dir": str(root / "ck_fused"),
                  "save_dir": str(out / "fused")},
        "jax": {**noop, "tx": ADAMW,
                "restore_dir": str(jax_fsdp2_step[0]),
                "save_dir": str(out / "jax")}}
    cfg = {"model": "llama-tiny", "targets": True,
           "model_kwargs": {"xent_chunk": 8, "dtype": "float32"},
           "fsdp": 2, "init": str(root / "init.npz"),
           "batch": str(root / "batch.npz"), "runs": runs}
    prefix = str(out / "r_")
    return out, _run_ranks(2, cfg, prefix), prefix


@pytest.mark.parametrize("fused", [False, True], ids=["adamw", "fused"])
def test_fsdp4_step_restores_at_fsdp2_and_in_one_process(
        tiny, tiny_runs, restored_at_fsdp2, fused):
    """The fsdp=4 ranks' step (each rank wrote its own shards) restores
    bitwise: in one process (parameters equal to the fsdp=4 ranks'
    gathered parameters; step and count 2), and at fsdp=2, whose re-save
    restores in one process to the same bits, every slot included."""
    root, _, _ = tiny
    name = "fused" if fused else "adamw"
    ck = root / ("ck_fused" if fused else "ck_adamw")
    step, count, got = _restored(ck, fused)
    assert (step, count) == (2, 2)
    _, prefix = tiny_runs["fsdp4"]
    gathered = _params(prefix, "fused_adamw" if fused else "adamw")
    _same({k[2:]: v for k, v in got.items() if k.startswith("p.")},
          gathered, "fsdp=4 → one process")
    out, reports, r_prefix = restored_at_fsdp2
    _same(_params(r_prefix, name), gathered, "fsdp=4 → fsdp=2")
    assert _restored(out / name, fused)[2].keys() == got.keys()
    _same(_restored(out / name, fused)[2], got, "fsdp=4 → fsdp=2 → saved")
    manifest = ckpt.read_manifest(ck, 2)
    files = {ch["file"] for ch in manifest["chunks"]}
    assert len(files) == 4          # every rank wrote its shards
    spec = {m["path"]: m["spec"] for m in manifest["leaves"]}
    assert spec[".params['embedding']"] == [None, "fsdp"]


def test_port_fsdp4_step_restores_in_jax(tiny, tiny_runs):
    """JAX restore_pytree reads the port's fsdp=4 AdamW step into a JAX
    ZeRO-3 template on fsdp=2: every parameter and moment equal to what
    the port restores in one process."""
    root, _, _ = tiny
    mesh = jpar.make_mesh(n_devices=2, fsdp=2)
    _, tmpl = _jax_tiny_state(optax.adamw(1e-3), mesh)
    back = jckpt.restore_pytree(root / "ck_adamw", tmpl)
    assert int(back.step) == 2 and int(back.opt_state[0].count) == 2
    _, _, got = _restored(root / "ck_adamw", False)
    for prefix, tree in (("p", back.params), ("mu", back.opt_state[0].mu),
                         ("nu", back.opt_state[0].nu)):
        ref = {f"{prefix}.{k}": v.numpy() for k, v in
               params_from_jax(_np(tree)).items()}
        _same({k: got[k] for k in ref}, ref, prefix)


def test_jax_fsdp2_step_restores_at_fsdp2(jax_fsdp2_step,
                                          restored_at_fsdp2):
    """A JAX ZeRO-3 step written on fsdp=2 restores into the port's
    fsdp=2 ranks: their re-save holds the JAX state's parameters and
    moments bit for bit."""
    _, js = jax_fsdp2_step
    out, _, _ = restored_at_fsdp2
    step, count, got = _restored(out / "jax", False)
    assert (step, count) == (2, 2)
    for prefix, tree in (("p", js.params), ("mu", js.opt_state[0].mu),
                         ("nu", js.opt_state[0].nu)):
        ref = {f"{prefix}.{k}": v.numpy() for k, v in
               params_from_jax(_np(tree)).items()}
        _same({k: got[k] for k in ref}, ref, prefix)


# ---------------------------------------------------------------------------
# The launch
# ---------------------------------------------------------------------------

def test_pytorch_framework_zero3_training_e2e(tmp_path):
    """Two MiniPod workers join one gloo group from the PyTorchRuntime
    env and train llama-tiny ZeRO-3 at fsdp=2 through train_loop with
    checkpoints (tests/workloads/torch_zero3_train.py): every task
    succeeds, the loss falls, each rank holds half of every sharded
    leaf, and the committed step holds both ranks' shard files."""
    pod = MiniPod(tmp_path)
    job = pod.run({
        "tony.application.framework": "pytorch",
        "tony.worker.instances": "2",
        "tony.application.executes": "python torch_zero3_train.py",
        "tony.am.gang-allocation-timeout-ms": "120000",
        "tony.task.max-missed-heartbeats": "100",
    }, src_dir=WORKLOADS, timeout=240)
    for t in job.session.tasks():
        assert t.status is TaskStatus.SUCCEEDED, (t.task_id, t.diagnostics)
    assert job.exit_code == 0
    [result] = Path(job.am.job_dir).glob(
        "containers/*/src/torch_zero3_losses.json")
    data = json.loads(result.read_text())
    assert data["world_size"] == 2 and data["fsdp"] == 2
    assert data["losses"][-1] < data["losses"][0]
    assert data["half_shards"] and data["shard_files"] == 2


# ---------------------------------------------------------------------------
# What is left for later slices still raises
# ---------------------------------------------------------------------------

def test_unported_pieces_name_their_items(one_rank_group):
    mesh = MeshSpec().build(device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        ttrain.make_accum_train_step(mesh=mesh, microbatches=2,
                                     hierarchy="hierarchical")
    # quant=True is ported (the int8 gather wire): it needs the bucketed
    # gather, whose buckets it quantizes.
    with pytest.raises(ValueError, match="bucket boundary"):
        ttrain.make_accum_train_step(mesh=mesh, microbatches=2, quant=True,
                                     gather="per_leaf")
    for axis, item in (("slices", 8), ("tp", 11), ("pp", 11)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            MeshSpec(**{axis: 2}).build(device="cpu")
    for kw, match in ((dict(gather="x"), "gather mode"),
                      (dict(reduce_op="x"), "reduce op"),
                      (dict(hierarchy="x"), "hierarchy"),
                      (dict(prefetch=-1), "prefetch")):
        with pytest.raises(ValueError, match=match):
            ttrain.make_accum_train_step(mesh=mesh, microbatches=2, **kw)
    with pytest.raises(TypeError, match="Mesh"):
        ttrain.make_accum_train_step(mesh=object(), microbatches=2)


@pytest.mark.parametrize("name", ["zero3", "mixed", "dim1"])
def test_host_converters_equal_the_reference(name):
    """slots_to_leaf_major / leaf_major_to_slots on whole shard-major
    buffers (the host twins of pack and the gathered layout): the
    reference's leaves, and a round trip that is the identity."""
    ref, got, params, jleaves, tleaves = _plans(name)
    f32 = [l.astype(np.float32) for l in jleaves]
    bufs = {"mu": [torch.from_numpy(fo._np_pack_bucket(got, b, f32))
                   for b in range(got.n_buckets)]}
    jbufs = jfo.leaf_major_to_slots(ref, {"mu": jax.tree.unflatten(
        jax.tree.structure(params), f32)})
    for a, b in zip(bufs["mu"], jbufs["mu"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    leaves = fo.slots_to_leaf_major(got, bufs)["mu"]
    for a, b in zip(leaves, f32):
        np.testing.assert_array_equal(a, b)
    back = fo.leaf_major_to_slots(got, {"mu": leaves}, "cpu")
    for a, b in zip(back["mu"], bufs["mu"]):
        assert torch.equal(a, b)
