"""The port's fused BatchNorm (:mod:`tony_tpu_torch.ops.batchnorm`) against
the JAX package's (:mod:`tony_tpu.ops.batchnorm`) on the CPU: the same
numpy inputs through the Pallas kernels in interpret mode and through the
port's plain versions (which a CPU tensor runs), at the reference op
tests' tolerances (tests/test_batchnorm.py)."""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops import batchnorm as jbn
from tony_tpu_torch.ops import LAUNCHES
from tony_tpu_torch.ops import batchnorm as bn

EPS = 1e-5


def _inputs(seed, shape, with_residual):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape, dtype=np.float32)
    gamma = rng.standard_normal(c, dtype=np.float32) * 0.5 + 1.0
    beta = rng.standard_normal(c, dtype=np.float32) * 0.1
    res = rng.standard_normal(shape, dtype=np.float32) if with_residual \
        else None
    wgt = rng.standard_normal(shape, dtype=np.float32)
    return x, gamma, beta, res, wgt


def _port_value_and_grads(x, gamma, beta, res, wgt, relu, dtype=None):
    args = [torch.tensor(a) for a in (x, gamma, beta)]
    if dtype is not None:
        args[0] = args[0].to(dtype)
    if res is not None:
        args.append(torch.tensor(res))
    for a in args:
        a.requires_grad_()
    out, mean, var = bn.fused_bn_act(args[0], args[1], args[2],
                                     args[3] if res is not None else None,
                                     eps=EPS, relu=relu)
    loss = (out.float() * torch.tensor(wgt)).sum()
    loss.backward()
    return out, mean, var, loss, [a.grad for a in args]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_residual", [False, True])
def test_fused_bn_act_matches_jax(relu, with_residual):
    """Forward, batch statistics and every grad of the port's
    ``fused_bn_act`` against the JAX one (Pallas, interpreted), f32: loss
    1e-4 relative, mean 1e-5, var 1e-4, grads 2e-4 (test_batchnorm.py's
    tolerances)."""
    x, gamma, beta, res, wgt = _inputs(0, (4, 8, 8, 16), with_residual)

    def loss_jax(x, gamma, beta, res):
        out, mean, var = jbn.fused_bn_act(x, gamma, beta, res, relu=relu,
                                          interpret=True)
        return (out * wgt).sum(), (out, mean, var)

    diff = (0, 1, 2, 3) if with_residual else (0, 1, 2)
    (lj, (oj, mj, vj)), gj = jax.value_and_grad(
        loss_jax, diff, has_aux=True)(x, gamma, beta, res)
    out, mean, var, loss, grads = _port_value_and_grads(
        x, gamma, beta, res, wgt, relu)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(oj),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(vj), atol=1e-4,
                               rtol=1e-4)
    assert len(grads) == len(gj)
    for a, b in zip(grads, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4,
                                   rtol=2e-4)


def test_fused_bn_act_bf16_matches_jax():
    """bf16 activations (f32 γ/β/statistics): the output stays bf16 and
    agrees with the JAX kernels' within one bf16 step at these magnitudes
    (3e-2, the reference's bf16 bar); mean within 1e-5 (both sum the same
    bf16 values in f32)."""
    x, gamma, beta, _, wgt = _inputs(1, (2, 4, 4, 32), False)
    xb = jnp.asarray(x, jnp.bfloat16)
    oj, mj, _ = jbn.fused_bn_act(xb, jnp.asarray(gamma), jnp.asarray(beta),
                                 interpret=True)
    out, mean, _, _, grads = _port_value_and_grads(
        np.asarray(xb.astype(jnp.float32)), gamma, beta, None, wgt, True,
        dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and grads[0].dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(oj, np.float32), atol=3e-2,
                               rtol=3e-2)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mj), atol=1e-5)


def _jax_fwd_bwd(x2d, gamma, beta, res2d, relu, dy):
    """The JAX package's forward and backward passes, kernel by kernel
    (interpreted): stats, out, and the backward's (dx, dγ, dβ[, dres])."""
    m, c = x2d.shape
    bm = jbn.pick_block_rows(m, c, x2d.dtype.itemsize,
                             3 if res2d is None else 5)
    out, mean, var, stats, gb = jbn._bn_act_fwd_impl(
        x2d, gamma, beta, res2d, EPS, relu, bm, True)
    sums = jbn._bn_sums(x2d, bm, True)
    if res2d is None:
        bwd = jbn._bn_act_bwd(EPS, relu, bm, True, (x2d, stats, gb),
                              (dy, None, None))
    else:
        bwd = jbn._bn_add_act_bwd(EPS, relu, bm, True,
                                  (x2d, res2d, stats, gb), (dy, None, None))
    return sums, out, mean, var, bwd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu,with_residual",
                         list(itertools.product([True, False], repeat=2)))
def test_plain_versions_match_the_jax_kernels(dtype, relu, with_residual):
    """Each plain version on the JAX kernels' own inputs (their batch
    statistics, their reduction for the dx pass): Σx/Σx² 1e-5 relative,
    the elementwise outputs to 1e-5 in f32 and one bf16 step (2⁻⁸
    relative) in bf16, dγ/dβ 1e-4 relative, dres exactly."""
    x, gamma, beta, res, _ = _inputs(2, (512, 24), with_residual)
    dy = np.random.default_rng(3).standard_normal(x.shape, dtype=np.float32)
    jdt = jnp.dtype(dtype)
    xj, dyj = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    rj = None if res is None else jnp.asarray(res, jdt)
    sums, out, mean, var, bwd = _jax_fwd_bwd(xj, jnp.asarray(gamma),
                                             jnp.asarray(beta), rj, relu,
                                             dyj)
    tdt = getattr(torch, dtype)

    def t(a):
        return torch.tensor(np.asarray(jnp.asarray(a, jnp.float32)))
    x2d, dy2d = t(xj).to(tdt), t(dyj).to(tdt)
    r2d = None if rj is None else t(rj).to(tdt)
    mean_t, var_t, g_t, b_t = t(mean), t(var), t(gamma), t(beta)
    np.testing.assert_allclose(bn._stats_plain(x2d).numpy(),
                               np.asarray(sums), rtol=1e-5, atol=1e-5)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2 ** -8, atol=2 ** -8)
    got = bn._apply_plain(x2d, mean_t, var_t, g_t, b_t, r2d, EPS, relu)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), t(out).numpy(), **tol)
    red = bn._bwd_reduce_plain(dy2d, x2d, mean_t, var_t, g_t, b_t, r2d, EPS,
                               relu)
    np.testing.assert_allclose(red[0].numpy(), np.asarray(bwd[2]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(red[1].numpy(), np.asarray(bwd[1]),
                               rtol=1e-4, atol=1e-4)
    red_j = torch.stack([t(bwd[2]), t(bwd[1])])
    dx, dres = bn._bwd_dx_plain(dy2d, x2d, mean_t, var_t, g_t, b_t, red_j,
                                r2d, EPS, relu, 1.0 / x.shape[0])
    assert dx.dtype == tdt
    np.testing.assert_allclose(dx.float().numpy(), t(bwd[0]).numpy(), **tol)
    if with_residual:
        assert dres.dtype == tdt
        np.testing.assert_array_equal(dres.float().numpy(),
                                      t(bwd[3]).numpy())
    else:
        assert dres is None


@pytest.mark.parametrize("n_bufs", [3, 5])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_pick_block_rows_is_the_reference_rule(itemsize, n_bufs):
    """The port's copy of the dispatch rule equals the JAX package's over
    a grid of row counts and widths (ResNet-50's at batch 256 and 16
    included), so the port takes the kernel path exactly where the
    reference does."""
    ms = [1, 8, 16, 17, 48, 784, 1000, 1000003, 12544, 50176, 200704,
          802816, 3211264, 18816, 1 << 20]
    cs = [1, 3, 16, 64, 96, 128, 256, 512, 1024, 2048, 4096, 32768]
    for m, c in itertools.product(ms, cs):
        assert bn.pick_block_rows(m, c, itemsize, n_bufs) == \
            jbn.pick_block_rows(m, c, itemsize, n_bufs), (m, c)


def test_fused_bn_act_declines_where_the_reference_does():
    """No clean tiling (17 rows): None, as the JAX entry returns."""
    x = np.ones((17, 64), np.float32)
    g, b = np.ones(64, np.float32), np.zeros(64, np.float32)
    assert jbn.fused_bn_act(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                            interpret=True) is None
    assert bn.fused_bn_act(torch.tensor(x), torch.tensor(g),
                           torch.tensor(b)) is None


def test_fused_bn_act_refuses_a_copy():
    """A [..., C] tensor whose [M, C] view needs a copy raises; the
    permuted view of a channels_last NCHW tensor is taken as it is."""
    nchw = torch.randn(2, 16, 4, 4)
    g, b = torch.ones(16), torch.zeros(16)
    with pytest.raises(ValueError, match="copy"):
        bn.fused_bn_act(nchw.permute(0, 2, 3, 1), g, b)
    cl = nchw.to(memory_format=torch.channels_last)
    out, _, _ = bn.fused_bn_act(cl.permute(0, 2, 3, 1), g, b)
    assert out.shape == (2, 4, 4, 16)
    with pytest.raises(ValueError, match="residual"):
        bn.fused_bn_act(cl.permute(0, 2, 3, 1), g, b,
                        torch.zeros(2, 4, 4, 8))


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    """A CPU tensor never reaches a kernel wrapper and counts no launch;
    forward and backward each run their plain versions once."""
    calls = []
    for name in ("_stats_plain", "_apply_plain", "_bwd_reduce_plain",
                 "_bwd_dx_plain"):
        fn = getattr(bn, name)
        monkeypatch.setattr(bn, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    for name in ("_stats_cuda", "_apply_cuda", "_bwd_reduce_cuda",
                 "_bwd_dx_cuda"):
        monkeypatch.setattr(bn, name, lambda *a: pytest.fail("kernel"))
    before = dict(LAUNCHES)
    x = torch.randn(4, 4, 4, 8, requires_grad=True)
    out, _, _ = bn.fused_bn_act(x, torch.ones(8), torch.zeros(8),
                                torch.randn(4, 4, 4, 8))
    out.sum().backward()
    assert calls == ["_stats_plain", "_apply_plain", "_bwd_reduce_plain",
                     "_bwd_dx_plain"]
    assert LAUNCHES == before


def test_statistics_carry_no_gradient():
    """mean and var are outputs without a gradient, as the JAX VJP ignores
    their cotangents."""
    x = torch.randn(32, 8, requires_grad=True)
    out, mean, var = bn.bn_act_2d(x, torch.ones(8), torch.zeros(8))
    assert out.requires_grad
    assert not mean.requires_grad and not var.requires_grad
