"""Port parity for the training slice (tony_tpu_torch.models training
forward, tony_tpu_torch.train): the decoder's next-token loss and every
parameter's grad against ``jax.value_and_grad`` of the JAX package's
``next_token_loss`` on llama-tiny (the JAX model runs reference attention
on the CPU; weights carried across by load_jax_params), AdamW against
``optax.adamw``, and three ``make_train_step`` steps against the JAX
package's ``make_train_step``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from tony_tpu import train as jtrain
from tony_tpu.models import get_model as jax_model
from tony_tpu_torch import train as ttrain
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params, params_from_jax
from tony_tpu_torch.ops import FusedOptimizer
from tony_tpu_torch.ops import attention as tattn
from tony_tpu_torch.parallel import MeshSpec

LAYERS = 2
TINY_PACKED = dict(dim=256, n_heads=2, n_kv_heads=1, ffn_hidden=256)


def _jax_model(scan=True, dtype=jnp.float32, **kw):
    model = jax_model("llama-tiny", n_layers=LAYERS, dtype=dtype,
                      scan_layers=scan, **kw)
    params = nn.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)))["params"]
    return model, params


def _port(params, dtype=torch.float32, **kw):
    kw.setdefault("n_layers", LAYERS)
    model = get_model("llama-tiny", dtype=dtype, device="cpu", **kw)
    return load_jax_params(model, jax.tree.map(np.asarray, params))


def _tokens(seed, vocab=256, b=2, t=24):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(
        np.int32)


def _jax_loss_and_grads(model, params, tokens):
    def loss_fn(p):
        return jtrain.next_token_loss(
            model.apply({"params": p}, jnp.asarray(tokens)),
            jnp.asarray(tokens))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(model, tokens):
    model.zero_grad(set_to_none=True)
    tok = torch.from_numpy(tokens)
    loss = ttrain.next_token_loss(model(tok), tok)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


def _assert_grads_close(got, ref, tol):
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   atol=tol, rtol=tol, err_msg=name)


class TestDecoderVsJax:
    @pytest.mark.parametrize("scan", [True, False])
    def test_f32_loss_and_grads(self, scan):
        jm, params = _jax_model(scan)
        tokens = _tokens(0)
        jl, jg = _jax_loss_and_grads(jm, params, tokens)
        tl, tg = _port_loss_and_grads(_port(params), tokens)
        assert tl == pytest.approx(jl, rel=1e-5)
        _assert_grads_close(tg, jg, 1e-4)

    def test_packed_flash_route(self):
        """head_dim 128 routes the port through flash_attention_packed
        (GQA 2:1); the JAX model's reference attention gives the same
        loss and grads."""
        jm, params = _jax_model(**TINY_PACKED)
        tokens = _tokens(1)
        jl, jg = _jax_loss_and_grads(jm, params, tokens)
        tm = _port(params, attention="flash", **TINY_PACKED)
        assert tm.cfg.head_dim == 128
        tl, tg = _port_loss_and_grads(tm, tokens)
        assert tl == pytest.approx(jl, rel=1e-5)
        _assert_grads_close(tg, jg, 1e-4)

    def test_bf16_loss(self):
        jm, params = _jax_model(dtype=jnp.bfloat16)
        tokens = _tokens(2)
        jl, _ = _jax_loss_and_grads(jm, params, tokens)
        tl, _ = _port_loss_and_grads(_port(params, torch.bfloat16), tokens)
        assert abs(tl - jl) <= 2e-2 * abs(jl)

    def test_logits_and_positions(self):
        """Default positions are arange(t); explicit per-batch positions
        give the same logits as the JAX module with the same positions."""
        jm, params = _jax_model()
        tm = _port(params)
        tokens = _tokens(3, t=16)
        pos = np.arange(5, 21, dtype=np.int32)
        ref = jm.apply({"params": params}, jnp.asarray(tokens),
                       positions=jnp.asarray(pos))
        got = tm(torch.from_numpy(tokens), positions=torch.from_numpy(pos))
        assert got.dtype == torch.float32 and got.requires_grad
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)
        same = tm(torch.from_numpy(tokens),
                  positions=torch.arange(16))
        assert torch.equal(same, tm(torch.from_numpy(tokens)))


class TestDecoderPaths:
    def test_remat_is_bitwise(self):
        _, params = _jax_model()
        tokens = _tokens(4)
        off = _port_loss_and_grads(_port(params, attention="flash"), tokens)
        on = _port_loss_and_grads(
            _port(params, attention="flash", remat=True), tokens)
        assert on[0] == off[0]
        for name in off[1]:
            assert torch.equal(on[1][name], off[1][name]), name

    def test_flash_matches_reference(self):
        _, params = _jax_model()
        tokens = _tokens(5)
        ref = _port_loss_and_grads(_port(params, attention="reference"),
                                   tokens)
        got = _port_loss_and_grads(_port(params, attention="flash"), tokens)
        assert got[0] == pytest.approx(ref[0], rel=2e-5)
        _assert_grads_close(got[1], ref[1], 2e-5)

    @pytest.mark.parametrize("remat", [True, False])
    def test_attention_calls_per_step(self, monkeypatch, remat):
        """With remat each block's forward runs again in the backward:
        per step the attention forward runs 2·L times, the backward L
        times (L without remat) — the counts the card's kernels show."""
        calls = {"fwd": 0, "bwd": 0}
        fwd, bwd = tattn._flash_fwd, tattn._flash_bwd

        def count(name, fn):
            def wrapped(*a):
                calls[name] += 1
                return fn(*a)
            return wrapped
        monkeypatch.setattr(tattn, "_flash_fwd", count("fwd", fwd))
        monkeypatch.setattr(tattn, "_flash_bwd", count("bwd", bwd))
        _, params = _jax_model()
        _port_loss_and_grads(_port(params, attention="flash", remat=remat),
                             _tokens(6))
        assert calls == {"fwd": (2 if remat else 1) * LAYERS, "bwd": LAYERS}

    def test_remat_policy_errors(self):
        with pytest.raises(ValueError, match="unknown remat_policy"):
            get_model("llama-tiny", device="cpu", remat=True,
                      remat_policy="everything")
        with pytest.raises(ValueError, match="remat=False"):
            get_model("llama-tiny", device="cpu", remat=False,
                      remat_policy="dots")
        with pytest.raises(ValueError, match="unknown attention"):
            get_model("llama-tiny", device="cpu", attention="sparse")

    def test_f32_jax_tree_lands_bitwise(self):
        _, params = _jax_model()
        tm = _port(params)
        for name, p in tm.named_parameters():
            assert p.dtype == torch.float32, name
        w = np.asarray(params["layers"]["block"]["attn"]["wq"]["kernel"][1])
        assert torch.equal(tm.layers[1].attn.wq.weight,
                           torch.from_numpy(np.ascontiguousarray(w.T)))


def _grads_and_params(seed, shapes):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 10.0 ** -rng.randint(0, 4)
              for s in shapes] for _ in range(3)]
    return params, grads


class TestAdamW:
    @pytest.mark.parametrize("kw", [dict(), dict(weight_decay=0.1, b1=0.8,
                                                 eps=1e-6)])
    def test_matches_optax(self, kw):
        shapes = [(4, 8), (16,), (3, 5, 2)]
        params, grads = _grads_and_params(7, shapes)
        tx = optax.adamw(1e-2, **kw)
        jp = [jnp.asarray(p) for p in params]
        jstate = tx.init(jp)
        tp = [torch.from_numpy(p.copy()) for p in params]
        ttx = ttrain.adamw(1e-2, **kw)
        tstate = ttx.init(tp)
        for g in grads:
            upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
            jp = optax.apply_updates(jp, upd)
            tstate = ttx.update([torch.from_numpy(x) for x in g], tstate, tp)
            # 1e-6 relative to each leaf's largest magnitude: the moments
            # agree bitwise, and the bias corrections' f32 powers may
            # differ in their last bit.
            for a, b in zip(tp, jp):
                b = np.asarray(b)
                assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()
            for a, b in zip(tstate.mu + tstate.nu,
                            jstate[0].mu + jstate[0].nu):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tstate.count == 3


def _jax_train(params, model, tokens, steps):
    state = jtrain.create_train_state(model, optax.adamw(1e-3),
                                      jnp.asarray(tokens),
                                      jax.random.PRNGKey(0))
    state = state.replace(params=params,
                          opt_state=state.tx.init(params))
    step = jtrain.make_train_step(
        loss_of=lambda logits, batch: jtrain.next_token_loss(
            logits, batch["x"]))
    metrics = []
    for _ in range(steps):
        state, m = step(state, {"x": jnp.asarray(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    return state.params, metrics


class TestTrainStep:
    def test_three_steps_match_jax(self):
        """Three steps of AdamW(1e-3) from the same weights on the same
        batch. Per step, loss and grad norm to 1e-5 relative. Parameters
        to 2e-6 absolute: after three updates a parameter moves by at most
        ~3e-3 (AdamW's step is ~lr where |g| >> eps), and a grad that
        differs between the frameworks in its last bits moves the update
        by far less than that; only a grad within float noise of zero can
        flip the step's sign, and none does at this seed (the limit is
        three orders of magnitude under one such flip)."""
        jm, params = _jax_model()
        tokens = _tokens(8)
        tm = _port(params)
        jparams, jmetrics = _jax_train(params, jm, tokens, 3)
        state = ttrain.create_train_state(tm, ttrain.adamw(1e-3))
        step = ttrain.make_train_step(
            loss_of=lambda logits, batch: ttrain.next_token_loss(
                logits, batch["x"]))
        batch = {"x": torch.from_numpy(tokens)}
        for jm_ in jmetrics:
            state, m = step(state, batch)
            assert float(m["loss"]) == pytest.approx(jm_["loss"], rel=1e-5)
            assert float(m["grad_norm"]) == pytest.approx(jm_["grad_norm"],
                                                          rel=1e-5)
            assert float(m["aux_loss"]) == jm_["aux_loss"] == 0.0
        assert state.step == 3 and state.opt_state.count == 3
        assert all(p.grad is None for p in tm.parameters())
        ref = params_from_jax(jax.tree.map(np.asarray, jparams))
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                       atol=2e-6, rtol=0, err_msg=name)

    def test_loss_falls_and_apply_kwargs(self):
        _, params = _jax_model()
        tm = _port(params, attention="flash", remat=True)
        state = ttrain.create_train_state(tm, ttrain.adamw(1e-2))
        seen = []

        def kwargs_of(batch):
            seen.append(True)
            return {"positions": batch["pos"]}
        step = ttrain.make_train_step(
            loss_of=lambda logits, batch: ttrain.next_token_loss(
                logits, batch["x"]), apply_kwargs_of=kwargs_of)
        tok = torch.from_numpy(_tokens(9))
        batch = {"x": tok, "pos": torch.arange(tok.shape[1])}
        losses = [float(step(state, batch)[1]["loss"]) for _ in range(4)]
        assert losses[-1] < losses[0] and len(seen) == 4

    def test_default_loss_is_classification(self):
        _, params = _jax_model()
        tm = _port(params)
        state = ttrain.create_train_state(tm, ttrain.adamw(1e-3))
        tok = torch.from_numpy(_tokens(10))
        _, m = ttrain.make_train_step()(state, {"x": tok, "y": tok})
        logits = tm(tok).detach()
        # The step ran one update, so only the finite scalar is checked.
        assert np.isfinite(float(m["loss"])) and logits.shape[-1] == 256

    def test_unported_arguments_raise(self):
        tm = get_model("llama-tiny", device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            MeshSpec(fsdp=2).build(device="cpu")
        with pytest.raises(NotImplementedError,
                           match="GradientTransformation or a FusedOptimizer"):
            ttrain.create_train_state(tm, object())
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrain.make_accum_train_step(mesh=object(), microbatches=1)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrain.make_train_step(seq_axis=True)
        with pytest.raises(ValueError, match="xent_chunk"):
            tm(torch.zeros((1, 8), dtype=torch.int32),
               torch.zeros((1, 8), dtype=torch.int32))


def _next_token(logits, batch):
    return ttrain.next_token_loss(logits, batch["x"])


class TestAccumTrainStep:
    def test_one_microbatch_is_bitwise_the_train_step(self):
        """microbatches=1 through the grad buckets: the same parameters,
        bit for bit, as make_train_step over three steps (0 + g is g, and
        the division by 1 is exact)."""
        _, params = _jax_model()
        tok = torch.from_numpy(_tokens(13, b=4))
        models = [_port(params), _port(params)]
        states = [ttrain.create_train_state(m, ttrain.adamw(1e-3))
                  for m in models]
        steps = [ttrain.make_train_step(loss_of=_next_token),
                 ttrain.make_accum_train_step(_next_token, microbatches=1,
                                              bucket_bytes=4096)]
        for _ in range(3):
            ms = [step(state, {"x": tok})[1]
                  for step, state in zip(steps, states)]
            for key in ("loss", "grad_norm"):
                assert float(ms[0][key]) == float(ms[1][key])
        for (name, a), b in zip(models[0].named_parameters(),
                                models[1].parameters()):
            assert torch.equal(a, b), name
        assert all(p.grad is None for p in models[1].parameters())

    @pytest.mark.parametrize("update", ["optax", "fused_bucket"])
    def test_attention_calls_scale_with_microbatches(self, monkeypatch,
                                                     update):
        """Per step and microbatch, with remat: the attention forward runs
        2·L times and the backward L times."""
        calls = {"fwd": 0, "bwd": 0}
        fwd, bwd = tattn._flash_fwd, tattn._flash_bwd

        def count(name, fn):
            def wrapped(*a):
                calls[name] += 1
                return fn(*a)
            return wrapped
        monkeypatch.setattr(tattn, "_flash_fwd", count("fwd", fwd))
        monkeypatch.setattr(tattn, "_flash_bwd", count("bwd", bwd))
        _, params = _jax_model()
        tm = _port(params, attention="flash", remat=True)
        tx = FusedOptimizer() if update == "fused_bucket" \
            else ttrain.adamw(1e-3)
        state = ttrain.create_train_state(tm, tx)
        step = ttrain.make_accum_train_step(_next_token, microbatches=4,
                                            update=update)
        for _ in range(2):
            state, m = step(state, {"x": torch.from_numpy(_tokens(14,
                                                                  b=8))})
        assert calls == {"fwd": 2 * LAYERS * 4 * 2, "bwd": LAYERS * 4 * 2}
        assert np.isfinite(float(m["loss"]))

    def test_errors(self):
        tm = get_model("llama-tiny", device="cpu")
        tok = {"x": torch.zeros((4, 8), dtype=torch.int64)}
        with pytest.raises(ValueError, match="unknown update mode"):
            ttrain.make_accum_train_step(microbatches=2, update="sgd")
        for kw, item in ((dict(mesh=object()), "item 8"),
                         (dict(reduce_op="reduce_scatter"), "item 8"),
                         (dict(hierarchy="flat"), "item 8"),
                         (dict(gather="per_leaf"), "item 8"),
                         (dict(prefetch=2), "item 8"),
                         (dict(quant=True), "item 8"),
                         (dict(aot_cache=object()), "item 12")):
            with pytest.raises(NotImplementedError, match=item):
                ttrain.make_accum_train_step(microbatches=2, **kw)
        plain = ttrain.create_train_state(tm, ttrain.adamw(1e-3))
        with pytest.raises(ValueError, match="needs a state whose tx is a "
                                             "tony_tpu_torch"):
            ttrain.make_accum_train_step(
                _next_token, microbatches=2, update="fused_bucket")(plain,
                                                                    tok)
        with pytest.raises(ValueError, match="not divisible by sync group "
                                             "1 x microbatches 3"):
            ttrain.make_accum_train_step(_next_token, microbatches=3)(
                plain, tok)
        fused = ttrain.create_train_state(
            get_model("llama-tiny", device="cpu"),
            FusedOptimizer(bucket_bytes=1 << 16))
        with pytest.raises(ValueError, match="disagrees with the "
                                             "FusedOptimizer's 65536"):
            ttrain.make_accum_train_step(
                _next_token, microbatches=2, update="fused_bucket",
                bucket_bytes=1 << 12)(fused, tok)
        with pytest.raises(ValueError, match="GradientTransformation"):
            ttrain.make_accum_train_step(_next_token, microbatches=2)(
                fused, tok)


class TestLosses:
    def test_cross_entropy_matches_optax(self):
        rng = np.random.RandomState(11)
        logits = rng.randn(3, 5, 7).astype(np.float32)
        labels = rng.randint(0, 7, (3, 5)).astype(np.int32)
        ref = jtrain.cross_entropy_loss(jnp.asarray(logits),
                                        jnp.asarray(labels))
        got = ttrain.cross_entropy_loss(torch.from_numpy(logits),
                                        torch.from_numpy(labels))
        assert float(got) == pytest.approx(float(ref), rel=1e-6)
        ref = jtrain.next_token_loss(jnp.asarray(logits),
                                     jnp.asarray(labels))
        got = ttrain.next_token_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels))
        assert float(got) == pytest.approx(float(ref), rel=1e-6)

    def test_global_norm_matches_optax(self):
        rng = np.random.RandomState(12)
        xs = [rng.randn(*s).astype(np.float32) for s in [(3, 4), (5,)]]
        ref = optax.global_norm([jnp.asarray(x) for x in xs])
        got = ttrain.global_norm([torch.from_numpy(x) for x in xs])
        assert float(got) == pytest.approx(float(ref), rel=1e-6)
