"""Port parity for the fused bucket optimizer slice
(tony_tpu_torch.parallel.overlap, tony_tpu_torch.ops.fused_optim, the
accumulating train step): the bucket planner against the JAX planner,
the plain ``fused_bucket_update`` against the JAX package's Pallas kernel
(interpret mode) and XLA path, ``fused_update_step`` against the JAX
package's jitted one and optax, and three ``make_accum_train_step`` steps
against the JAX package's on a one-device mesh. Inputs are made with
numpy from a seed and handed to both packages."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from tony_tpu import parallel as jpar
from tony_tpu import train as jtrain
from tony_tpu.models import get_model as jax_model
from tony_tpu.ops import fused_optim as jfo
from tony_tpu.parallel import overlap as joverlap
from tony_tpu_torch import train as ttrain
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params, params_from_jax
from tony_tpu_torch.ops import LAUNCHES
from tony_tpu_torch.ops import fused_optim as fo
from tony_tpu_torch.parallel import overlap

# ---------------------------------------------------------------------------
# The bucket planner
# ---------------------------------------------------------------------------

# f32 and bf16 mixed, a scalar, leaves above and below every threshold.
PLAN_LEAVES = [((4, 8), "float32"), ((), "float32"), ((300,), "bfloat16"),
               ((3, 5), "float32"), ((600, 1000), "float32"),
               ((7,), "bfloat16"), ((64, 16), "float32"), ((2,), "float32"),
               ((1200, 900), "bfloat16"), ((9,), "float32")]
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("bucket_bytes", [256, 4096,
                                          overlap.DEFAULT_BUCKET_BYTES])
def test_plan_matches_jax(bucket_bytes):
    jleaves = [jax.ShapeDtypeStruct(s, jnp.dtype(d)) for s, d in PLAN_LEAVES]
    tleaves = [torch.empty(s, dtype=_TORCH[d]) for s, d in PLAN_LEAVES]
    ref = joverlap.GradBuckets.plan(jleaves, bucket_bytes)
    got = overlap.GradBuckets.plan(tleaves, bucket_bytes)
    assert got.buckets == ref.buckets
    assert got.bucket_nbytes == ref.bucket_nbytes
    assert got.bucket_numel == ref.bucket_numel
    assert got.shapes == ref.shapes and got.n_buckets == ref.n_buckets
    assert overlap.DEFAULT_BUCKET_BYTES == joverlap.DEFAULT_BUCKET_BYTES


def test_pack_unpack_round_trips_bitwise():
    rng = np.random.RandomState(0)
    leaves = [torch.from_numpy(np.asarray(rng.randn(*s), np.float32)).to(
        _TORCH[d]) for s, d in PLAN_LEAVES]
    plan = overlap.GradBuckets.plan(leaves, 4096)
    bufs = plan.pack(leaves)
    assert [b.numel() for b in bufs] == list(plan.bucket_numel)
    back = plan.unpack(bufs)
    for a, b in zip(back, leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_planner_errors():
    with pytest.raises(ValueError, match="positive"):
        overlap.GradBuckets.plan([torch.zeros(3)], 0)
    with pytest.raises(ValueError, match="empty"):
        overlap.GradBuckets.plan([])
    # The scatter layouts are ported (tests/test_torch_zero3.py): on a
    # plan without scatter buckets "shard" is the whole leaf and
    # "gathered" belongs to scatter buckets only.
    plan = overlap.GradBuckets.plan([torch.zeros(3)])
    assert torch.equal(plan.leaf_buffers(0, torch.arange(3.0),
                                         layout="shard")[0],
                       torch.arange(3.0))
    with pytest.raises(ValueError, match="scatter"):
        plan.leaf_buffers(0, torch.zeros(3), layout="gathered")
    with pytest.raises(ValueError, match="unknown layout"):
        plan.leaf_buffers(0, torch.zeros(3), layout="rows")
    sharded = overlap.GradBuckets.plan_sharded([torch.zeros(4)],
                                               [("fsdp",)], shard_size=2)
    assert sharded.n_scatter_buckets == 1 and sharded.local_numel(0) == 2


# ---------------------------------------------------------------------------
# One bucket's update: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def _bucket(rule, n, seed=0):
    rng = np.random.RandomState(seed)
    g = (rng.randn(n) * 0.1).astype(np.float32)
    p = rng.randn(n).astype(np.float32)
    slots = [(rng.randn(n) * 0.01).astype(np.float32)]
    if rule != "sgd":              # nu >= 0
        slots[-1] = np.abs(slots[-1]) * 0.01
    if rule == "adamw":
        slots = [(rng.randn(n) * 0.01).astype(np.float32),
                 np.abs(rng.randn(n) * 1e-4).astype(np.float32)]
    return g, p, slots


def _port_update(rule, hyper, g, p, slots, scal, dtype=torch.float32):
    tp = torch.from_numpy(p.copy()).to(dtype)
    ts = [torch.from_numpy(s.copy()) for s in slots]
    out_p, out_s = fo.fused_bucket_update(
        torch.from_numpy(g).to(dtype), tp, ts, torch.from_numpy(scal),
        rule=rule, hyper=hyper)
    assert out_p is tp and all(a is b for a, b in zip(out_s, ts))
    return tp, ts


@pytest.mark.parametrize("wd", [0.0, 1e-2])
@pytest.mark.parametrize("n", [1, 300, 9000])
@pytest.mark.parametrize("rule", fo.RULES)
def test_update_matches_pallas_and_xla(rule, n, wd):
    """To rtol 1e-6, atol 1e-8 (test_fused_optim.py::TestKernel's float
    ulps: the compile pipeline may rewrite a division as a multiply by
    the reciprocal)."""
    g, p, slots = _bucket(rule, n)
    jf = jfo.FusedOptimizer(rule=rule, lr=1e-3, weight_decay=wd)
    scal = np.array(jf.scalars(jnp.int32(3)))
    tf = fo.FusedOptimizer(rule=rule, lr=1e-3, weight_decay=wd)
    assert tf.hyper == jf.hyper and tf.slot_names == jf.slot_names
    tp, ts = _port_update(rule, tf.hyper, g, p, slots, scal)
    args = (jnp.asarray(g), jnp.asarray(p),
            tuple(jnp.asarray(s) for s in slots), jnp.asarray(scal))
    for kw in (dict(interpret=True), dict(impl="xla")):
        rp, rs = jfo.fused_bucket_update(*args, rule=rule, hyper=jf.hyper,
                                         **kw)
        np.testing.assert_allclose(tp.numpy(), np.asarray(rp), rtol=1e-6,
                                   atol=1e-8)
        for a, b in zip(ts, rs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-8)


def test_bf16_params_keep_dtype_f32_slots():
    g, p, slots = _bucket("adamw", 50)
    tf = fo.FusedOptimizer(rule="adamw")
    tp, ts = _port_update("adamw", tf.hyper, g, p, slots,
                          tf.scalars(1, "cpu").numpy(), torch.bfloat16)
    assert tp.dtype == torch.bfloat16
    assert all(s.dtype == torch.float32 for s in ts)


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_bad_rule_and_slot_count_raise_with_the_jax_messages():
    jg, tg = jnp.zeros((4,)), torch.zeros(4)
    hyper = fo.FusedOptimizer(rule="adamw").hyper
    assert _message(lambda: fo.fused_bucket_update(
        tg, tg, (tg,), tg, rule="rmsprop", hyper={})) == _message(
        lambda: jfo.fused_bucket_update(jg, jg, (jg,), jg, rule="rmsprop",
                                        hyper={}))
    assert _message(lambda: fo.fused_bucket_update(
        tg, tg, (tg,), tg, rule="adamw", hyper=hyper)) == _message(
        lambda: jfo.fused_bucket_update(jg, jg, (jg,), jg, rule="adamw",
                                        hyper=hyper, impl="xla"))
    assert _message(lambda: fo.FusedOptimizer(rule="nope")) == _message(
        lambda: jfo.FusedOptimizer(rule="nope"))


def test_scalars_match_jax():
    """``[-lr, 1-b1^t, 1-b2^t, 0]`` against the JAX package's scalars
    under jit (as its step computes them), counts 1-300: within one ulp
    of the power b^t (the one f32 rounding the two could place apart)."""
    for rule in ("adamw", "sgd"):
        jf = jfo.FusedOptimizer(rule=rule, lr=3e-4)
        tf = fo.FusedOptimizer(rule=rule, lr=3e-4)
        ref = jax.jit(jax.vmap(jf.scalars))(jnp.arange(1, 301,
                                                       dtype=jnp.int32))
        for c in range(1, 301):
            got = tf.scalars(c, "cpu")
            assert got.dtype == torch.float32 and got.shape == (4,)
            want = np.asarray(ref[c - 1])
            ulp = np.spacing(np.float32(1) - want[1:3])
            assert got[0].item() == want[0] and got[3].item() == 0.0
            assert np.all(np.abs(got[1:3].numpy() - want[1:3]) <= ulp), c


# ---------------------------------------------------------------------------
# fused_update_step: the leaf-major entry against the JAX package and optax
# ---------------------------------------------------------------------------

def _tree(seed=0):
    """test_fused_optim.py's multi-shape tree: matrices, a vector and a
    scalar; grads sin(p + 0.1)·0.05. A list in the JAX tree's key order."""
    rng = np.random.RandomState(seed)
    params = [rng.randn(12, 8).astype(np.float32),
              (rng.randn(33) * 0.3).astype(np.float32),
              np.array(1.7, np.float32),
              rng.randn(7, 3).astype(np.float32)]
    grads = [np.asarray(np.sin(p + np.float32(0.1)) * np.float32(0.05),
                        np.float32) for p in params]
    return params, grads


def _jax_fused(kw, params, grads, steps):
    fused = jfo.FusedOptimizer(**kw)
    jp = [jnp.asarray(p) for p in params]
    jg = [jnp.asarray(g) for g in grads]
    plan = fused.plan_for(jp, None)
    fstep = jax.jit(lambda p, s: jfo.fused_update_step(fused, p, jg, s,
                                                       plan=plan))
    st = fused.init_state(jp)
    norms = []
    for _ in range(steps):
        jp, st, gn = fstep(jp, st)
        norms.append(float(gn))
    return [np.asarray(p) for p in jp], jfo.slots_to_leaf_major(
        plan, st["slots"]), norms


def _port_fused(kw, params, grads, steps, dtype=torch.float32):
    fused = fo.FusedOptimizer(**kw)
    tp = [torch.from_numpy(p.copy()).to(dtype) for p in params]
    tg = [torch.from_numpy(g).to(dtype) for g in grads]
    plan = fused.plan_for(tp)
    st = fused.init_state(tp)
    norms = []
    for _ in range(steps):
        tp, st, gn = fo.fused_update_step(fused, tp, tg, st, plan=plan)
        norms.append(float(gn))
    assert st["count"] == steps
    return tp, fo.slots_to_leaf_major(plan, st["slots"]), norms


def _close_to_leaf_scale(got, ref, rel=1e-6):
    """Each leaf within ``rel`` of its largest magnitude: the moments
    agree bitwise, and the bias corrections' f32 powers may differ in
    their last bit."""
    for a, b in zip(got, ref):
        b = np.asarray(b, np.float32)
        assert np.abs(a.float().numpy() - b).max() <= rel * np.abs(b).max()


OPTAX_PINS = {
    "adamw": dict(rule="adamw", lr=1e-3),
    "adamw_wd": dict(rule="adamw", lr=1e-3, weight_decay=1e-2),
    "sgd_momentum": dict(rule="sgd", lr=0.1, momentum=0.9),
    "adafactor": dict(rule="adafactor", lr=1e-3, b2=0.999, eps=1e-8),
}


@pytest.mark.parametrize("name", sorted(OPTAX_PINS))
def test_fused_update_step_matches_jax(name):
    """Five steps against the JAX package's jitted fused_update_step:
    parameters to 1e-6 of each leaf's largest magnitude, slots and grad
    norms to float ulps (rtol 1e-6)."""
    kw = OPTAX_PINS[name]
    params, grads = _tree()
    tp, tslots, tnorms = _port_fused(kw, params, grads, 5)
    jp, jslots, jnorms = _jax_fused(kw, params, grads, 5)
    _close_to_leaf_scale(tp, jp)
    for slot in tslots:
        for a, b in zip(tslots[slot], jslots[slot]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-12)
    np.testing.assert_allclose(tnorms, jnorms, rtol=1e-6)


@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_adamw_moments_bitwise_against_optax(wd):
    """Moments bitwise against optax run op by op, parameters to 1e-6 of
    each leaf's scale. (Under jit the XLA CPU compiler contracts
    ``(1-b1)*g + b1*mu`` into a fused multiply-add, one rounding fewer,
    so against the jitted JAX step above they agree to an ulp; the port
    rounds every product and sum, on the CPU and in the kernel.)"""
    params, grads = _tree()
    tp, tslots, _ = _port_fused(dict(rule="adamw", lr=1e-3,
                                     weight_decay=wd), params, grads, 5)
    tx = optax.adamw(1e-3, weight_decay=wd)
    jg = [jnp.asarray(g) for g in grads]
    jp = [jnp.asarray(p) for p in params]
    ost = tx.init(jp)
    for _ in range(5):
        u, ost = tx.update(jg, ost, jp)
        jp = optax.apply_updates(jp, u)
    _close_to_leaf_scale(tp, jp)
    for a, b in zip(tslots["mu"] + tslots["nu"], ost[0].mu + ost[0].nu):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_clip_norm_matches_jax():
    """rtol 1e-5, atol 1e-7 (the JAX package's own clip test): the
    bucket-major norms differ by float reassociation."""
    params, grads = _tree()
    kw = dict(rule="adamw", lr=1e-3, clip_norm=0.05)
    tp, _, tn = _port_fused(kw, params, grads, 2)
    jp, _, jn = _jax_fused(kw, params, grads, 2)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tn, jn, rtol=1e-5)


def test_lr_callable_matches_jax():
    params, grads = _tree()
    kw = dict(rule="sgd", momentum=0.0, lr=lambda count: 0.1 / count)
    tp, _, _ = _port_fused(kw, params, grads, 2)
    jp, _, _ = _jax_fused(kw, params, grads, 2)
    for a, b, p, g in zip(tp, jp, params, grads):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-7)
        # Step 1 at lr 0.1, step 2 at lr 0.05.
        np.testing.assert_allclose(a.numpy(), p - 0.1 * g - 0.05 * g,
                                   rtol=1e-5, atol=1e-7)


def test_bf16_params_documented_tolerance():
    """bf16 params against optax's adamw to 1e-2 (the JAX package's
    documented bf16 pin: optax keeps bf16 moments, the fused plane f32
    slots and rounds only the parameter write)."""
    params, grads = _tree()
    kw = dict(rule="adamw", lr=1e-2, weight_decay=1e-2)
    tp, _, _ = _port_fused(kw, params, grads, 3, dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in tp)
    tx = optax.adamw(1e-2, weight_decay=1e-2)
    jp = [jnp.asarray(p, jnp.bfloat16) for p in params]
    jg = [jnp.asarray(g, jnp.bfloat16) for g in grads]
    ost = tx.init(jp)
    for _ in range(3):
        u, ost = tx.update(jg, ost, jp)
        jp = optax.apply_updates(jp, u)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=1e-2,
                                   atol=1e-2)


def test_slot_state_mismatch_raises_like_check_slots():
    params, _ = _tree()
    tp = [torch.from_numpy(p) for p in params]
    jp = [jnp.asarray(p) for p in params]
    tf, jf = (m.FusedOptimizer(rule="adamw", bucket_bytes=64)
              for m in (fo, jfo))
    tplan, jplan = tf.plan_for(tp), jf.plan_for(jp, None)
    assert tplan.n_buckets == jplan.n_buckets > 1
    for bad in ({"mu": [None] * tplan.n_buckets},
                {"mu": [None], "nu": [None]}):
        assert _message(lambda: tf.check_slots(tplan, bad)) == _message(
            lambda: jf.check_slots(jplan, bad))
    wrong = fo.FusedOptimizer(rule="adamw").init_state(tp)
    with pytest.raises(ValueError, match="different bucket_bytes"):
        fo.fused_update_step(tf, tp, tp, wrong, plan=tplan)


def test_leaf_major_round_trip():
    params, _ = _tree()
    tp = [torch.from_numpy(p) for p in params]
    fused = fo.FusedOptimizer(rule="adamw", bucket_bytes=64)
    plan = fused.plan_for(tp)
    rng = np.random.RandomState(3)
    slots = {n: [torch.from_numpy(rng.randn(k).astype(np.float32))
                 for k in plan.bucket_numel] for n in fused.slot_names}
    leaf = fo.slots_to_leaf_major(plan, slots)
    assert [x.shape for x in leaf["mu"]] == [p.shape for p in params]
    back = fo.leaf_major_to_slots(plan, leaf, device="cpu")
    for n in slots:
        for a, b in zip(back[n], slots[n]):
            assert torch.equal(a, b)
    state = ttrain.TrainState(step=0, model=None, tx=fused,
                              opt_state=fused.init_state(tp))
    assert fo.is_fused_state(state)
    assert not fo.is_fused_state(ttrain.TrainState(0, None, None, {}))


# ---------------------------------------------------------------------------
# The accumulating train step against the JAX package's, one device
# ---------------------------------------------------------------------------

LAYERS = 2
# Small enough that both plans have several buckets, some with several
# leaves (port, parameters() order: 13 buckets; JAX, sorted tree: 10).
ACCUM_BUCKET_BYTES = 32768


def _next_token(logits, batch):
    return jtrain.next_token_loss(logits, batch["x"])


def _jax_accum(update, tokens, steps):
    model = jax_model("llama-tiny", n_layers=LAYERS, dtype=jnp.float32)
    mesh = jpar.make_mesh(1)
    tx = (jfo.FusedOptimizer(rule="adamw", lr=1e-3, weight_decay=1e-4,
                             bucket_bytes=ACCUM_BUCKET_BYTES, interpret=True)
          if update == "fused_bucket" else optax.adamw(1e-3))
    state = jtrain.create_train_state(model, tx, jnp.asarray(tokens),
                                      jax.random.PRNGKey(0), mesh=mesh)
    init = jax.tree.map(np.asarray, state.params)
    step = jtrain.make_accum_train_step(
        _next_token, mesh, microbatches=2, update=update, donate=False,
        bucket_bytes=ACCUM_BUCKET_BYTES)
    metrics = []
    for _ in range(steps):
        state, m = step(state, {"x": jnp.asarray(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, jax.tree.map(np.asarray, state.params), metrics


@pytest.mark.parametrize("update", ["fused_bucket", "optax"])
def test_accum_steps_match_jax(update):
    """Three steps, microbatches=2, from the JAX state's weights on one
    batch of 8 x 16 tokens: loss and grad norm to 1e-5 relative and
    parameters to 2e-6 absolute (test_torch_train.py's three-step pins;
    the bucket-major norm differs from JAX's by float reassociation and
    the two plans differ, which no result depends on). As there, a grad
    within float noise of zero can move AdamW's normalised step past the
    limit, and none does at this seed (at seed 20 one weight's grad,
    5e-8 against a noise of 2e-8, moves it by 2.9e-6)."""
    tokens = np.random.RandomState(8).randint(0, 256, (8, 16)).astype(
        np.int32)
    init, jparams, jmetrics = _jax_accum(update, tokens, 3)
    tm = load_jax_params(get_model("llama-tiny", n_layers=LAYERS,
                                   device="cpu", dtype=torch.float32), init)
    if update == "fused_bucket":
        tx = fo.FusedOptimizer(rule="adamw", lr=1e-3, weight_decay=1e-4,
                               bucket_bytes=ACCUM_BUCKET_BYTES)
    else:
        tx = ttrain.adamw(1e-3)
    state = ttrain.create_train_state(tm, tx)
    if update == "fused_bucket":
        plan = state.buckets.plan
        assert plan.n_buckets > 1 and max(map(len, plan.buckets)) > 1
    step = ttrain.make_accum_train_step(
        lambda logits, batch: ttrain.next_token_loss(logits, batch["x"]),
        microbatches=2, update=update, bucket_bytes=ACCUM_BUCKET_BYTES)
    batch = {"x": torch.from_numpy(tokens)}
    for want in jmetrics:
        state, m = step(state, batch)
        assert float(m["loss"]) == pytest.approx(want["loss"], rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                      rel=1e-5)
        assert float(m["aux_loss"]) == want["aux_loss"] == 0.0
    assert state.step == 3
    ref = params_from_jax(jparams)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   atol=2e-6, rtol=0, err_msg=name)


def _bucket_of(plan, bufs, i):
    """(buffer, element offset) of leaf i."""
    for b, idxs in enumerate(plan.buckets):
        if i in idxs:
            off = sum(math.prod(plan.shapes[j]) for j in idxs[:idxs.index(i)])
            return bufs[b], off
    raise AssertionError(i)


def _assert_resident(state):
    res = state.buckets
    params = list(state.model.parameters())
    for i, p in enumerate(params):
        for t, bufs in ((p, res.param_bufs), (p.grad, res.grad_bufs)):
            buf, off = _bucket_of(res.plan, bufs, i)
            assert t.data_ptr() == buf.data_ptr() + off * buf.element_size()
            assert t.is_contiguous()


def test_parameters_and_grads_live_in_their_buckets(monkeypatch):
    """After create_train_state and after each step every parameter and
    every ``.grad`` is a view of its bucket; load_jax_params into the
    bucketed model lands bitwise; the update dispatches once per bucket
    per step (the plain version on the CPU, where no kernel launches)."""
    model = jax_model("llama-tiny", n_layers=LAYERS, dtype=jnp.float32)
    jparams = jax.tree.map(np.asarray, nn.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 16), jnp.int32)))["params"])
    tm = get_model("llama-tiny", n_layers=LAYERS, device="cpu")
    fused = fo.FusedOptimizer(rule="adamw", bucket_bytes=ACCUM_BUCKET_BYTES)
    state = ttrain.create_train_state(tm, fused)
    _assert_resident(state)
    load_jax_params(tm, jparams)
    _assert_resident(state)
    ref = params_from_jax(jparams)
    for name, p in tm.named_parameters():
        assert torch.equal(p.detach(), ref[name]), name
    calls = []
    plain = fo._update_plain
    monkeypatch.setattr(fo, "_update_plain",
                        lambda *a: calls.append(1) or plain(*a))
    launches = LAUNCHES["fused_bucket_update"]
    step = ttrain.make_accum_train_step(
        lambda logits, batch: ttrain.next_token_loss(logits, batch["x"]),
        microbatches=2, update="fused_bucket")
    tok = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (4, 16)).astype(np.int32))
    for k in range(2):
        tm.zero_grad(set_to_none=True)     # the step binds the views again
        state, _ = step(state, {"x": tok})
        _assert_resident(state)
        assert len(calls) == state.buckets.plan.n_buckets * (k + 1)
    assert LAUNCHES["fused_bucket_update"] == launches
    assert state.opt_state["count"] == 2
    assert set(tm.state_dict()) == {n for n, _ in tm.named_parameters()}


def test_replaced_storage_is_refused():
    tm = get_model("llama-tiny", n_layers=LAYERS, device="cpu")
    state = ttrain.create_train_state(tm, fo.FusedOptimizer())
    step = ttrain.make_accum_train_step(
        lambda logits, batch: ttrain.next_token_loss(logits, batch["x"]),
        microbatches=2, update="fused_bucket")
    tok = torch.zeros((2, 8), dtype=torch.int64)
    state, _ = step(state, {"x": tok})
    p = tm.layers[0].attn.wq.weight
    p.grad = p.grad.clone()
    with pytest.raises(RuntimeError, match="no longer aliases"):
        state.buckets.check()
    p.data = p.data.clone()
    with pytest.raises(RuntimeError, match="no longer aliases"):
        step(state, {"x": tok})
