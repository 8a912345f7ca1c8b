"""Ring attention in the port, on the CPU: one spawned world of eight gloo
ranks (tests/workloads/torch_ring_ranks.py) runs
``ring_attention_sharded`` on the meshes of the reference's ring tests
(tests/test_parallel.py: ``sp=8``; ``sp=4``, which fills ``dp=2``;
``sp=4 × tp=2``; ``tp=4 × sp=2``), and the test process assembles the
ranks' blocks and holds them against the JAX package's
``ring_attention_sharded`` on the same meshes over the 8 virtual CPU
devices and against its ``reference_attention``: outputs and grads
within the reference's 2e-5 in f32 — causal and not, GQA with the
narrow blocks rotating, the kv heads narrower than the model axis
(K/V repeated), and ``q = k = v``. The ring's plain block step and
its skipped blocks are pinned on one process, as are
``flash_attention_sharded`` on ``dp=2 × sp=2 × tp=2``
(tests/test_ops.py) and the ragged-GQA refusal."""

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

import jax
import jax.numpy as jnp

from tony_tpu import parallel as jpar
from tony_tpu.ops import reference_attention as jax_reference
from torch_ranks import wait_ranks
from tony_tpu_torch.ops import flash_attention_sharded, reference_attention
from tony_tpu_torch.parallel import AXES, BATCH_AXES, MODEL, SEQ, Mesh
from tony_tpu_torch.parallel import ring_attention as ring

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).parent / "workloads" / "torch_ring_ranks.py"
WORLD = 8
TOL = 2e-5
# name -> the case: mesh (dp=0 fills), [b, h, hkv, t, d], seed, causal,
# grads; each mirrors a ring test of tests/test_parallel.py.
CASES = {
    "sp8_causal": dict(sp=8, shape=[2, 4, 4, 64, 16], seed=0, causal=True),
    "sp8_full": dict(sp=8, shape=[2, 4, 4, 64, 16], seed=0, causal=False),
    "sp4_tp2_grads": dict(sp=4, tp=2, shape=[1, 2, 2, 32, 8], seed=1,
                          causal=True, grads=True, qkv_same=True),
    "gqa_causal": dict(sp=4, shape=[2, 4, 2, 64, 16], seed=5, causal=True),
    "gqa_full": dict(sp=4, shape=[2, 4, 2, 64, 16], seed=5, causal=False),
    "gqa_grads": dict(sp=4, shape=[2, 4, 2, 32, 8], seed=3, causal=True,
                      grads=True),
    "tp4_wider_than_kv": dict(tp=4, sp=2, shape=[2, 8, 2, 32, 8], seed=7,
                              causal=True, grads=True),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(case):
    sys.path.insert(0, str(WORKER.parent))
    try:
        import torch_ring_ranks
    finally:
        sys.path.pop(0)
    return torch_ring_ranks.inputs(case)


def _mesh_of(case):
    return dict(sp=case.get("sp", 1), tp=case.get("tp", 1))


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """The JAX package's ring over the case's mesh on the 8 virtual
    devices: the output and, for a grads case, the grads of Σ out·w."""
    case = CASES[name]
    q, k, v, w = (jnp.asarray(x) for x in _inputs(case))
    mesh = jpar.make_mesh(**_mesh_of(case))
    causal = case["causal"]
    out = jpar.ring_attention_sharded(q, k, v, mesh, causal=causal)
    grads = None
    if case.get("grads"):
        if case.get("qkv_same"):
            g = jax.grad(lambda q: (jpar.ring_attention_sharded(
                q, q, q, mesh, causal=causal) * w).sum())(q)
            grads = (np.asarray(g),)
        else:
            grads = tuple(np.asarray(g) for g in jax.grad(
                lambda q, k, v: (jpar.ring_attention_sharded(
                    q, k, v, mesh, causal=causal) * w).sum(),
                (0, 1, 2))(q, k, v))
    ref = jax_reference(q, k, v, causal=causal)
    return np.asarray(out), np.asarray(ref), grads


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The eight ranks' blocks of every case; the JAX references are
    computed while the ranks run."""
    root = tmp_path_factory.mktemp("ring")
    cfg = {"cases": [dict(case, name=name) for name, case in CASES.items()]}
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
             str(root / "r")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        for name in CASES:
            _jax_case(name)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    wait_ranks(procs, 240, "the ring-attention ranks")
    return root


def _assembled(root, name):
    """The global output from the ranks' blocks (batch over the data
    axes, heads over model, sequence over seq), and the grads summed
    over the ranks' shares."""
    case = CASES[name]
    b, h, _, t, d = case["shape"]
    out = np.zeros((b, h, t, d), np.float32)
    grads = None
    for rank in range(WORLD):
        got = dict(np.load(root / f"r.{name}.r{rank}.npz"))
        coords = dict(zip(AXES, got["coords"]))
        shape = dict.fromkeys(AXES, 1)
        shape.update(data=WORLD // (case.get("sp", 1) * case.get("tp", 1)),
                     seq=case.get("sp", 1), model=case.get("tp", 1))
        blk = got["out"]
        bi = 0
        for a in BATCH_AXES:
            bi = bi * shape[a] + coords[a]
        sl = (slice(bi * blk.shape[0], (bi + 1) * blk.shape[0]),
              slice(coords[MODEL] * blk.shape[1],
                    (coords[MODEL] + 1) * blk.shape[1]),
              slice(coords[SEQ] * blk.shape[2],
                    (coords[SEQ] + 1) * blk.shape[2]))
        out[sl] = blk
        if case.get("grads"):
            share = [got["dq"], got["dk"], got["dv"]]
            grads = share if grads is None else [
                a + s for a, s in zip(grads, share)]
    return out, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_jax_and_reference(world, name):
    """Each case's output against the JAX ring on the same mesh and
    against the JAX reference attention (repeat-then-attend for GQA),
    within 2e-5."""
    out, _ = _assembled(world, name)
    jax_out, ref, _ = _jax_case(name)
    np.testing.assert_allclose(out, jax_out, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if c.get("grads")))
def test_ring_grads_match_jax(world, name):
    """dq, dk, dv of Σ out·w (each rank's dK/dV carried back around the
    ring to the block's owner; with q = k = v their sum) against JAX's
    grads, within 2e-5, finite and of the inputs' shapes (GQA: dK/dV at
    the narrow width)."""
    _, grads = _assembled(world, name)
    *_, ref = _jax_case(name)
    if CASES[name].get("qkv_same"):
        grads = [sum(grads)]
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        assert g.shape == r.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, atol=TOL, rtol=TOL)


def _mesh(rank=0, **sizes):
    shape = dict.fromkeys(AXES, 1)
    shape.update(sizes)
    return Mesh(shape=shape, processes=int(np.prod(list(shape.values()))),
                device=torch.device("cpu"), rank=rank)


def test_gqa_rejects_ragged():
    q = torch.zeros((2, 4, 32, 8))
    kv = torch.zeros((2, 3, 32, 8))
    with pytest.raises(ValueError, match="multiple"):
        ring.ring_attention_sharded(q, kv, kv, _mesh(data=2, seq=4))
    with pytest.raises(ValueError, match="multiple"):
        ring.ring_attention(q, kv, kv, _mesh(data=2, seq=4))


def test_flash_sharded_matches_reference():
    """tests/test_ops.py's dp=2 × sp=2 × tp=2 case: every rank's block
    (its batch rows and heads, the sequence whole) against the JAX
    package's shard_map'ed flash kernel and the plain reference, within
    2e-5; kv heads narrower than tp are repeated."""
    from tony_tpu.ops import flash_attention_sharded as jax_flash_sharded

    rs = np.random.RandomState(0)
    q, k, v = (rs.standard_normal((4, 8, 32, 8)).astype(np.float32)
               for _ in range(3))
    mesh = jpar.make_mesh(dp=2, sp=2, tp=2)
    want = np.asarray(jax.jit(lambda q, k, v: jax_flash_sharded(
        q, k, v, mesh, block_q=16, block_k=16, interpret=True))(q, k, v))
    ref = reference_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    for rank in range(8):
        m = _mesh(rank, data=2, seq=2, model=2)
        got = flash_attention_sharded(*(torch.from_numpy(x)
                                        for x in (q, k, v)), m)
        c = m.coords()
        sl = (slice(c["data"] * 2, c["data"] * 2 + 2),
              slice(c["model"] * 4, c["model"] * 4 + 4))
        np.testing.assert_allclose(got.numpy(), want[sl], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(got.numpy(), ref.numpy()[sl], atol=TOL,
                                   rtol=TOL)
    # GQA narrower than tp: K/V repeated up to the query heads.
    kv2 = torch.from_numpy(k[:, :2].copy())
    m = _mesh(1, data=1, seq=1, model=4)
    got = flash_attention_sharded(torch.from_numpy(q), kv2, kv2, m)
    np.testing.assert_allclose(
        got.numpy(), reference_attention(torch.from_numpy(q), kv2,
                                         kv2).numpy()[:, 2:4],
        atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="divide"):
        flash_attention_sharded(torch.from_numpy(q[:3]), kv2[:3], kv2[:3],
                                _mesh(0, data=2, model=2))


@pytest.mark.parametrize("causal", [True, False])
def test_block_step_is_the_references(causal):
    """The ring's plain version on one process (``ring_blocks``: every
    rank's forward and backward loops, the ones the ranks run, driven in
    lockstep with the sends handed over in memory): its output
    and grads over a 4-shard sequence equal the whole sequence's plain
    attention and autograd's grads within 2e-5 in f32, and the causal
    ring skips exactly the blocks past the diagonal (j > r)."""
    rs = np.random.RandomState(2)
    b, h, hkv, t, d, sp = 2, 4, 2, 32, 8, 4
    q, k, v, do = (torch.from_numpy(rs.standard_normal(s).astype(
        np.float32)) for s in ((b, h, t, d), (b, hkv, t, d),
                               (b, hkv, t, d), (b, h, t, d)))
    out, dq, dk, dv = ring.ring_blocks(q, k, v, do, sp, causal)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    want = reference_attention(qg, kg, vg, causal=causal)
    (want * do).sum().backward()
    for got, ref in ((out, want.detach()), (dq, qg.grad), (dk, kg.grad),
                     (dv, vg.grad)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL,
                                   rtol=TOL)
    ran = [(r, j) for r in range(sp) for j in range(sp)
           if ring.block_forward(q[:, :, :8], k[:, :, :8], v[:, :, :8], r,
                                 j, causal, 1.0) is not None]
    assert len(ran) == (sp * (sp + 1) // 2 if causal else sp * sp)
