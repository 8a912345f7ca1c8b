"""The port's ResNet (:mod:`tony_tpu_torch.models.resnet`), its SGD and the
MNIST CNN against the JAX package on the CPU: the JAX variables carried
over by the port's converter, the same numpy batch through both.

The model-level pins hold both port lanes (plain BatchNorm and the fused
BN kernels' plain versions) against the JAX plain lane, which the
reference's own tests pin to its fused lane
(tests/test_batchnorm.py::test_fused_resnet_matches_plain_resnet); one
test runs the JAX fused lane itself (Pallas, interpreted)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu import train as jtrain
from tony_tpu.models import get_model as jget
from tony_tpu.models import resnet as jresnet
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models import resnet as tresnet
from tony_tpu_torch.models.convert import (conv_params_from_jax,
                                           load_jax_params)
from tony_tpu_torch.ops import batchnorm as bn
from tony_tpu_torch.train import (create_train_state, cross_entropy_loss,
                                  make_train_step, sgd)

LANES = ["plain", "fused"]


def _rename_fused(tree):
    """The plain lane's flax paths as the fused lane's
    (tests/test_batchnorm.py's ``_rename_fused``)."""
    if not isinstance(tree, dict):
        return tree
    return {k.replace("Bottleneck", "FusedBottleneck").replace(
        "BatchNorm", "FusedBNAct"): _rename_fused(v) for k, v in tree.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=0, n=4, size=32, classes=10):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, size, size, 3), dtype=np.float32),
            rng.integers(0, classes, (n,)))


def _jax_train_step(model, variables, x, y):
    """The JAX train forward and backward of the reference's ResNet step
    (tony_tpu/benchmark.py:75-85): loss, logits, grads, new stats."""
    def loss_fn(params):
        logits, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jtrain.cross_entropy_loss(logits, jnp.asarray(y)), (
            logits, upd["batch_stats"])
    (loss, (logits, stats)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    return float(loss), np.asarray(logits), _np(grads), _np(stats)


def _port_model(lane, variables, **kw):
    fused = lane == "fused"
    m = get_model("resnet18-thin", device="cpu", fused_bn=fused,
                  dtype=kw.pop("dtype", torch.float32), **kw)
    load_jax_params(m, _rename_fused(variables) if fused else variables)
    return m


def _by_port_name(tree, lane):
    """A JAX tree (grads or stats) under the port's state_dict names."""
    return conv_params_from_jax(_rename_fused(tree) if lane == "fused"
                                else tree)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def jax_plain():
    """resnet18-thin, f32, the JAX plain lane: variables and one train
    step's outputs on a seeded batch."""
    x, y = _batch()
    model = jget("resnet18-thin", dtype=jnp.float32)
    variables = _np(model.init(jax.random.PRNGKey(1), jnp.asarray(x),
                               train=False))
    # Non-trivial exit scales and statistics, so every term matters.
    rng = np.random.default_rng(7)
    variables = jax.tree.map(
        lambda a: a + rng.standard_normal(a.shape).astype(a.dtype) * 0.1,
        variables)
    variables["batch_stats"] = jax.tree.map(np.abs, variables["batch_stats"])
    return model, variables, x, y, _jax_train_step(model, variables, x, y)


@pytest.mark.parametrize("lane", LANES)
def test_train_forward_and_grads_match_jax(jax_plain, lane):
    """Logits and loss (1e-5), every grad (relative L2 5e-3, the
    reference's fused-vs-plain bar) and the new running statistics (1e-4)
    of one train step, f32, against the JAX plain lane."""
    jmodel, variables, x, y, (jloss, jlogits, jgrads, jstats) = jax_plain
    m = _port_model(lane, variables)
    logits = m(torch.tensor(x), train=True)
    loss = cross_entropy_loss(logits, torch.tensor(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, atol=1e-5,
                               rtol=1e-5)
    assert float(loss.detach()) == pytest.approx(jloss, rel=1e-5)
    grads = _by_port_name(jgrads, lane)
    params = dict(m.named_parameters())
    assert set(grads) == set(params)
    for name, p in params.items():
        assert _rel_l2(p.grad.numpy(), grads[name].numpy()) <= 5e-3, name
    stats = _by_port_name(jstats, lane)
    buffers = dict(m.named_buffers())
    assert set(stats) == set(buffers)
    for name, t in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), t.numpy(),
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("lane", LANES)
def test_eval_matches_jax(jax_plain, lane):
    """Eval (running statistics, no update) against JAX's
    ``train=False``: logits to 1e-5, the buffers untouched."""
    jmodel, variables, x, _, _ = jax_plain
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    m = _port_model(lane, variables)
    before = {n: b.clone() for n, b in m.named_buffers()}
    with torch.no_grad():
        out = m(torch.tensor(x), train=False)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    for name, b in m.named_buffers():
        assert torch.equal(b, before[name])


def test_fused_lane_matches_jax_fused_lane_interpreted(jax_plain):
    """The one test that runs the JAX fused lane (its Pallas kernels
    interpreted): the port's fused lane against it, f32 — logits 1e-5,
    grads 5e-3 relative L2, new statistics 1e-4."""
    _, variables, x, y, _ = jax_plain
    jmodel = jget("resnet18-thin", dtype=jnp.float32, fused_bn=True,
                  bn_interpret=True)
    fvars = _rename_fused(variables)
    jloss, jlogits, jgrads, jstats = _jax_train_step(jmodel, fvars, x, y)
    m = _port_model("fused", variables)
    logits = m(torch.tensor(x), train=True)
    loss = cross_entropy_loss(logits, torch.tensor(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, atol=1e-5,
                               rtol=1e-5)
    assert float(loss.detach()) == pytest.approx(jloss, rel=1e-5)
    grads = conv_params_from_jax(jgrads)
    for name, p in m.named_parameters():
        assert _rel_l2(p.grad.numpy(), grads[name].numpy()) <= 5e-3, name
    stats = conv_params_from_jax(jstats)
    for name, b in m.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), atol=1e-4,
                                   err_msg=name)


def test_s2d_stem_kernel_matches_jax():
    k7 = np.random.default_rng(4).standard_normal((7, 7, 3, 8),
                                                  dtype=np.float32)
    np.testing.assert_array_equal(
        tresnet.s2d_stem_kernel(torch.tensor(k7)).numpy(),
        np.asarray(jresnet.s2d_stem_kernel(jnp.asarray(k7))))


def test_s2d_stem_is_the_7x7_stem():
    """The port's s2d model with the transported stem kernel gives the
    7×7/s2 model's logits (the stem is the same linear map)."""
    x, _ = _batch(5)
    m7 = get_model("resnet18-thin", device="cpu", dtype=torch.float32,
                   seed=2)
    m4 = get_model("resnet18-thin", device="cpu", dtype=torch.float32,
                   s2d_stem=True, seed=2)
    state = m7.state_dict()
    k7 = state["stem.weight"].permute(2, 3, 1, 0)           # OIHW -> HWIO
    state["stem.weight"] = tresnet.s2d_stem_kernel(k7).permute(3, 2, 0, 1)
    m4.load_state_dict(state)
    with torch.no_grad():
        a = m7(torch.tensor(x), train=True)
        b = m4(torch.tensor(x), train=True)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("lane", LANES)
def test_s2d_model_matches_jax(lane):
    """The s2d-stem model (the ResNet-50 path's stem) against JAX's: one
    train step's logits (1e-5) and grads (5e-3)."""
    x, y = _batch(6)
    jmodel = jget("resnet18-thin", dtype=jnp.float32, s2d_stem=True)
    variables = _np(jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x),
                                train=False))
    assert variables["params"]["stem"]["kernel"].shape == (4, 4, 12, 8)
    jloss, jlogits, jgrads, _ = _jax_train_step(jmodel, variables, x, y)
    m = _port_model(lane, variables, s2d_stem=True)
    logits = m(torch.tensor(x), train=True)
    cross_entropy_loss(logits, torch.tensor(y)).backward()
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, atol=1e-5,
                               rtol=1e-5)
    grads = _by_port_name(jgrads, lane)
    for name, p in m.named_parameters():
        assert _rel_l2(p.grad.numpy(), grads[name].numpy()) <= 5e-3, name


@pytest.mark.parametrize("lane", LANES)
def test_bf16_logits_match_jax(jax_plain, lane):
    """bf16 compute (f32 parameters and statistics), train mode, against
    the JAX plain lane in bf16: max |Δ| within 1e-2 of the logits' scale
    (measured 7.8e-4 plain, 3.3e-3 fused). Each conv output rounds to
    bf16 in both, after other summation orders, and the fused lane keeps
    the exit's add in f32 where the plain lane adds in bf16."""
    _, variables, x, _, _ = jax_plain
    jmodel = jget("resnet18-thin", dtype=jnp.bfloat16)
    ref, _ = jmodel.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    ref = np.asarray(ref)
    m = _port_model(lane, variables, dtype=torch.bfloat16)
    with torch.no_grad():
        out = m(torch.tensor(x), train=True)
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("lane", LANES)
def test_three_sgd_steps_match_jax(jax_plain, lane):
    """Three steps of ``sgd(0.1, momentum=0.9)`` through
    ``make_train_step`` against the reference's step
    (tony_tpu/benchmark.py:75-89: value_and_grad with the batch stats
    mutable, optax.sgd, apply_updates), f32: every parameter and running
    statistic to 1e-4 of its scale, and the losses to 1e-5."""
    jmodel, variables, x, y, _ = jax_plain
    tx = optax.sgd(0.1, momentum=0.9)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    jlosses = []
    for _ in range(3):
        loss, _, grads, stats_new = _jax_train_step(
            jmodel, {"params": params, "batch_stats": stats}, x, y)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = _np(optax.apply_updates(params, updates))
        stats = stats_new
        jlosses.append(loss)

    m = _port_model(lane, variables)
    state = create_train_state(m, sgd(0.1, momentum=0.9))
    step = make_train_step(apply_kwargs_of=lambda b: {"train": True})
    batch = {"x": torch.tensor(x), "y": torch.tensor(y)}
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    ref = _by_port_name({"params": params, "batch_stats": stats}, lane)
    got = {**dict(m.named_parameters()), **dict(m.named_buffers())}
    assert set(ref) == set(got)
    for name, t in ref.items():
        a, b = got[name].detach().numpy(), t.numpy()
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1.0), name


def test_sgd_matches_optax():
    """sgd without momentum, with it and with Nesterov against optax op
    by op on random leaves, three updates: bitwise (each product rounds
    on its own before its sum in both)."""
    rng = np.random.default_rng(8)
    shapes = [(5, 3), (7,)]
    for kw in ({}, {"momentum": 0.9}, {"momentum": 0.9, "nesterov": True}):
        params = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
        tx_j, tx_t = optax.sgd(0.1, **kw), sgd(0.1, **kw)
        pj = [jnp.asarray(p) for p in params]
        pt = [torch.tensor(p) for p in params]
        sj, st = tx_j.init(pj), tx_t.init(pt)
        for _ in range(3):
            grads = [rng.standard_normal(s, dtype=np.float32)
                     for s in shapes]
            uj, sj = tx_j.update([jnp.asarray(g) for g in grads], sj, pj)
            pj = optax.apply_updates(pj, uj)
            st = tx_t.update([torch.tensor(g) for g in grads], st, pt)
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_resnet50_takes_the_jax_tree_and_counts_its_launches(monkeypatch):
    """ResNet-50 (fused lane, s2d stem) at full width: the converter
    fills every parameter and running statistic from the JAX model's
    variable shapes; one train step at 4 × 64² (f32, where the
    reference's tiling rule takes the kernel path at every layer) runs
    each BN pass once per layer — 53 stats and apply passes, 37 backward
    pairs without the residual and 16 with it, the counts the card's run
    holds to."""
    jmodel = jget("resnet50", fused_bn=True, s2d_stem=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    tree = jax.tree.map(lambda s: np.full(s.shape, 0.5, np.float32), shapes)
    m = get_model("resnet50", device="cpu", fused_bn=True, s2d_stem=True,
                  dtype=torch.float32)
    load_jax_params(m, tree)
    n_params = sum(p.numel() for p in m.parameters())
    assert n_params == sum(np.size(a) for a in
                           jax.tree.leaves(tree["params"]))
    assert all(bool((p == 0.5).all()) for p in m.parameters())

    m = get_model("resnet50", device="cpu", fused_bn=True, s2d_stem=True,
                  dtype=torch.float32, seed=0)
    calls = {"stats": 0, "apply": 0, "reduce": 0, "reduce_res": 0, "dx": 0,
             "dx_res": 0}

    def count(name, fn, res_at):
        def wrapped(*a):
            key = name + ("_res" if res_at is not None
                          and a[res_at] is not None else "")
            calls[key] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(bn, "_stats_plain", count("stats", bn._stats_plain,
                                                  None))
    monkeypatch.setattr(bn, "_apply_plain", count("apply", bn._apply_plain,
                                                  None))
    monkeypatch.setattr(bn, "_bwd_reduce_plain",
                        count("reduce", bn._bwd_reduce_plain, 6))
    monkeypatch.setattr(bn, "_bwd_dx_plain", count("dx", bn._bwd_dx_plain, 7))
    x, y = _batch(9, n=4, size=64, classes=1000)
    loss = cross_entropy_loss(m(torch.tensor(x), train=True),
                              torch.tensor(y))
    loss.backward()
    assert calls == {"stats": 53, "apply": 53, "reduce": 37,
                     "reduce_res": 16, "dx": 37, "dx_res": 16}
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in m.parameters())


def test_resnet50_flops_matches_jax():
    for b, img in ((1, 224), (256, 224), (8, 64)):
        assert tresnet.resnet50_flops(b, img) == jresnet.resnet50_flops(
            b, img)


def test_registered_defaults():
    m = get_model("resnet18-thin", device="cpu")
    assert m.Dense_0.out_features == 10 and m.stem.weight.shape[0] == 8
    assert m.dtype == torch.bfloat16 and not m.fused_bn
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert not m.Bottleneck_0.BatchNorm_2.scale.detach().any()
    with pytest.raises(ValueError, match="unknown model"):
        get_model("resnet-nope", device="cpu")


def test_converter_rejects_a_mismatched_tree(jax_plain):
    _, variables, _, _, _ = jax_plain
    m = get_model("resnet18-thin", device="cpu", fused_bn=True)
    with pytest.raises(ValueError, match="do not match"):
        load_jax_params(m, variables)           # plain-lane names


def test_mnist_cnn_logits_match_jax():
    """mnist-cnn on flat and NHWC input: logits to 1e-5 (f32), the NHWC
    flatten order carried by the converted Dense_0 kernel as it is."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 784), dtype=np.float32)
    jmodel = jget("mnist-cnn")
    variables = _np(jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    m = get_model("mnist-cnn", device="cpu")
    load_jax_params(m, variables)
    with torch.no_grad():
        out = m(torch.tensor(x))
        out4 = m(torch.tensor(x).reshape(3, 28, 28, 1))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert torch.equal(out, out4)
