"""The port's mixture-of-experts slice on one process, against the JAX
package: ``router_assignment`` (dispatch equal, combine and aux within
1e-6) at ample capacity, at capacity 1 (drops) and with top_k = E;
``MoEMLP`` against flax's at llama-moe-tiny widths (1e-5 in f32, the
repo's bf16 limit of 2e-2 in bf16), its gather dispatch and combine
against the reference's one-hot einsums (bitwise where the products are
exact, 1e-6 where f32 products round), the single-expert layer equal to
the dense SwiGLU; llama-moe-tiny through ``load_jax_params``: logits and
loss within 1e-5, aux within 1e-6 and every grad within 1e-5 with and
without remat, and ``make_train_step`` and ``make_accum_train_step``
(both update modes) against the JAX package's steps (SGD: AdamW magnifies
last-bit grads); the serve refusal, the registered configs and the
convert round trip of a scanned MoE tree. Every routed input's top-k
margins are asserted above 1e-4, so no comparison rests on a near-tie
that a last bit could flip."""

from __future__ import annotations

import dataclasses
import functools

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
from tony_tpu.models import moe as jmoe
from tony_tpu_torch import train as ttrain
from tony_tpu_torch.models import get_model, moe
from tony_tpu_torch.models import transformer as ttransformer
from tony_tpu_torch.models.convert import (jax_param_tree, load_jax_params,
                                           params_from_jax)
from tony_tpu_torch.ops import fused_optim as fo

TOL = 1e-5
AUX_TOL = 1e-6
BF16 = dict(atol=2e-2, rtol=2e-2)
MARGIN = 1e-4
D, F, E, K = 64, 128, 4, 2        # llama-moe-tiny's widths


def _gates(g, s, e, seed):
    logits = np.random.RandomState(seed).randn(g, s, e).astype(np.float32)
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def _margins(gates, top_k):
    """The smallest gap, over tokens and top-k rounds, between the chosen
    expert's probability and the best of the rest."""
    g = np.sort(np.asarray(gates, np.float64), axis=-1)[..., ::-1]
    gaps = [g[..., r] - g[..., r + 1] for r in range(min(top_k,
                                                          g.shape[-1] - 1))]
    return min(float(x.min()) for x in gaps) if gaps else np.inf


@pytest.mark.parametrize("g,s,e,k,cap", [
    (2, 16, 4, 2, 10),      # the layer's capacity at llama-moe-tiny
    (2, 8, 4, 1, 1),        # capacity 1: most tokens dropped
    (1, 8, 4, 4, 8),        # top_k = E
])
def test_router_matches_jax(g, s, e, k, cap):
    gates = _gates(g, s, e, seed=g * 100 + s + k)
    assert _margins(gates, k) > MARGIN
    jd, jc, ja = jmoe.router_assignment(jnp.asarray(gates), k, cap)
    td_, tc, ta = moe.router_assignment(torch.tensor(gates), k, cap)
    np.testing.assert_array_equal(td_.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=AUX_TOL,
                               rtol=0)
    assert abs(float(ta) - float(ja)) <= AUX_TOL
    if cap == 1:
        assert float(td_.sum()) < g * s * k     # some choices dropped


def test_capacity_is_the_references_float_arithmetic():
    for t, k, e, cf in ((16, 2, 4, 1.25), (2048, 2, 8, 1.25), (7, 1, 3, 1.0),
                        (1, 1, 8, 0.5)):
        assert moe.capacity_of(t, k, e, cf) == max(1, int(cf * t * k / e))


def _flax_layer(dtype, e=E, k=K, cf=1.25, seed=3):
    layer = jmoe.MoEMLP(dim=D, ffn_hidden=F, n_experts=e, top_k=k,
                        capacity_factor=cf, dtype=dtype)
    x = np.random.RandomState(seed).randn(2, 16, D).astype(np.float32)
    params = nn.unbox(layer.init(jax.random.PRNGKey(seed),
                                 jnp.asarray(x)))["params"]
    return layer, params, x


def _port_layer(params, dtype, e=E, k=K, cf=1.25):
    layer = moe.MoEMLP(D, F, e, top_k=k, capacity_factor=cf, dtype=dtype)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.tensor(np.asarray(params[name])))
    return layer


def _gates_of(layer, x):
    return torch.softmax(x.float() @ layer.w_router, dim=-1).detach()


class TestLayer:
    def test_f32_matches_flax(self):
        jl, params, x = _flax_layer(jnp.float32)
        y_ref, sown = jl.apply({"params": params}, jnp.asarray(x),
                               mutable="losses")
        tl = _port_layer(params, torch.float32)
        xt = torch.from_numpy(x)
        assert _margins(_gates_of(tl, xt), K) > MARGIN
        y, aux = tl(xt)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                                   atol=TOL, rtol=0)
        want = float(jax.tree.leaves(sown["losses"])[0])
        assert abs(float(aux.detach()) - want) <= AUX_TOL

    def test_bf16_matches_flax(self):
        jl, params, x = _flax_layer(jnp.bfloat16)
        xb = jnp.asarray(x, jnp.bfloat16)
        y_ref = jl.apply({"params": params}, xb)
        tl = _port_layer(params, torch.bfloat16)
        xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
        assert _margins(_gates_of(tl, xt), K) > MARGIN
        y, _ = tl(xt)
        np.testing.assert_allclose(y.float().detach().numpy(),
                                   np.asarray(y_ref.astype(jnp.float32)),
                                   **BF16)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_gathers_are_the_one_hot_einsums(self, dtype):
        """A slot holds one token and a token at most top_k slots, so the
        gather dispatch is the einsum's values bit for bit, and so is the
        combine where the products are exact in f32 (bf16 operands). In
        f32 a product rounds and the einsum's GEMM may fuse it into its
        sum: there the two stay within 1e-6."""
        _, params, x = _flax_layer(jnp.float32)
        tl = _port_layer(params, dtype)
        xt = torch.from_numpy(x).to(dtype)
        cap = moe.capacity_of(16, K, E, 1.25)
        gates = _gates_of(tl, xt)
        r = moe.route(gates, K, cap)
        slots = moe.slots_of(r, E, cap)
        disp, comb, _ = moe.router_assignment(gates, K, cap)
        xin = moe.dispatch(xt, slots, E)
        assert torch.equal(xin, torch.einsum("gsec,gsd->egcd",
                                             disp.to(dtype), xt))
        out = torch.randn(xin.shape, generator=torch.Generator()
                          .manual_seed(0)).to(dtype)
        y = moe.combine(out, slots, dtype)
        ref = torch.einsum("gsec,egcd->gsd", comb.to(dtype), out)
        if dtype == torch.bfloat16:
            assert torch.equal(y, ref)
        else:
            torch.testing.assert_close(y, ref, atol=1e-6, rtol=0)

    def test_single_expert_is_the_dense_swiglu(self):
        """E=1, k=1, capacity ≥ T: the combine weight is 1 and no token
        drops, so the layer is the SwiGLU it wraps (tests/test_moe.py)."""
        tl = moe.MoEMLP(8, 16, 1, top_k=1, capacity_factor=1.0,
                        dtype=torch.float32)
        tl.init_weights(torch.Generator().manual_seed(1))
        x = torch.randn(2, 6, 8, generator=torch.Generator().manual_seed(0))
        y, _ = tl(x)
        h = torch.nn.functional.silu(x @ tl.w_gate[0]) * (x @ tl.w_up[0])
        torch.testing.assert_close(y, h @ tl.w_down[0], atol=1e-5, rtol=0)


def _jax_moe(remat=False, **kw):
    model = jax_model("llama-moe-tiny", dtype=jnp.float32, remat=remat, **kw)
    params = nn.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)))["params"]
    return model, params


def _port_moe(params, **kw):
    model = get_model("llama-moe-tiny", device="cpu", dtype=torch.float32,
                      **kw)
    return load_jax_params(model, jax.tree.map(np.asarray, params))


def _tokens(seed, b=2, t=16):
    return np.random.RandomState(seed).randint(0, 256, (b, t)).astype(
        np.int32)


def _routed_margin(model, tokens):
    """The smallest top-k margin over every MoE layer's router input in
    one forward of ``model``."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(_margins(_gates_of(mod, args[0]),
                                               mod.top_k)))
        for m in model.modules() if isinstance(m, moe.MoEMLP)]
    with torch.no_grad():
        model(torch.from_numpy(tokens))
    for h in hooks:
        h.remove()
    return min(seen)


def _dense(leaf):
    """A leaf of the port's view of a JAX tree as one numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().numpy()
    arr = np.zeros(leaf.shape, np.float32)
    for start, t, perm in leaf.parts:
        v = t.detach() if perm is None else t.detach().permute(perm)
        v = v.reshape((1,) * (len(leaf.shape) - v.dim()) + tuple(v.shape))
        arr[tuple(slice(a, a + n) for a, n in zip(start, v.shape))] = \
            v.numpy()
    return arr


def _next_token(out, batch):
    return ttrain.next_token_loss(out, batch["x"])


def _jax_next_token(out, batch):
    return jtrain.next_token_loss(out, batch["x"])


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """llama-moe-tiny's JAX weights, a batch, and JAX's logits, loss, aux
    and grads of ``loss + aux`` on it (remat changes none of them)."""
    jm, params = _jax_moe()
    tokens = _tokens(4)

    def loss_fn(p):
        logits, sown = jm.apply({"params": p}, jnp.asarray(tokens),
                                mutable="losses")
        aux = sum(leaf.sum() for leaf in jax.tree.leaves(sown["losses"]))
        loss = jtrain.next_token_loss(logits, jnp.asarray(tokens))
        return loss + aux, (logits, loss, aux)

    (total, (logits, loss, aux)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    grads = params_from_jax(jax.tree.map(np.asarray, grads))
    return (params, tokens, np.asarray(logits), float(total), float(aux),
            grads, float(optax.global_norm(
                jax.tree.map(jnp.asarray, list(grads.values())))))


@functools.lru_cache(maxsize=None)
def _jax_accum():
    """Two steps of the JAX package's make_accum_train_step (two
    microbatches, SGD with momentum 0.9) on llama-moe-tiny: the initial
    and final parameters and the metrics."""
    tokens = _tokens(6, b=4)
    jm, _ = _jax_moe()
    mesh = jpar.make_mesh(1)
    state = jtrain.create_train_state(
        jm, optax.sgd(0.5, momentum=0.9), jnp.asarray(tokens),
        jax.random.PRNGKey(0), mesh=mesh)
    init = jax.tree.map(np.asarray, state.params)
    step = jtrain.make_accum_train_step(_jax_next_token, mesh,
                                        microbatches=2, donate=False)
    metrics = []
    for _ in range(2):
        state, m = step(state, {"x": jnp.asarray(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    return tokens, init, jax.tree.map(np.asarray, state.params), metrics


class TestModel:
    @pytest.mark.parametrize("remat", [False, True])
    def test_logits_loss_aux_and_grads(self, remat):
        params, tokens, jlogits, jtotal, jaux, jgrads, _ = _jax_reference()
        tm = _port_moe(params, remat=remat)
        assert _routed_margin(tm, tokens) > MARGIN
        tok = torch.from_numpy(tokens)
        logits, aux = tm(tok)
        total = ttrain.next_token_loss(logits, tok) + aux
        total.backward()
        np.testing.assert_allclose(logits.detach().numpy(), jlogits,
                                   atol=TOL, rtol=0)
        assert abs(total.item() - jtotal) <= TOL
        assert abs(aux.item() - jaux) <= AUX_TOL
        assert 0.005 < aux.item() < 0.1     # coef · layers · ~1
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                       atol=TOL, rtol=0, err_msg=name)

    def test_train_step_adds_and_reports_aux(self):
        """One SGD(0.5) step of make_train_step: loss (with aux), aux_loss
        and grad norm are JAX's, and each parameter moved by half JAX's
        grad of loss + aux, to 1e-5 (the reference's train step sums the
        sown losses into its objective the same way)."""
        params, tokens, _, jtotal, jaux, jgrads, jnorm = _jax_reference()
        tm = _port_moe(params)
        state = ttrain.create_train_state(tm, ttrain.sgd(0.5))
        step = ttrain.make_train_step(loss_of=_next_token)
        _, m = step(state, {"x": torch.from_numpy(tokens)})
        assert float(m["loss"]) == pytest.approx(jtotal, abs=TOL)
        assert float(m["aux_loss"]) == pytest.approx(jaux, abs=AUX_TOL)
        assert float(m["grad_norm"]) == pytest.approx(jnorm, rel=TOL)
        ref = params_from_jax(jax.tree.map(np.asarray, params))
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(),
                ref[name].numpy() - 0.5 * jgrads[name].numpy(),
                atol=TOL, rtol=0, err_msg=name)

    @pytest.mark.parametrize("update", ["optax", "fused_bucket"])
    def test_accum_step_matches_jax(self, update):
        """Two steps of two microbatches with SGD, momentum 0.9 (the port's
        per-leaf rule or the fused bucket kernel's, which is optax's trace
        too), against the JAX package's accumulating step: loss, aux_loss
        (the mean over microbatches) and grad norm to 1e-5, the parameters
        to 1e-5."""
        tokens, init, jparams, jmetrics = _jax_accum()
        tm = load_jax_params(get_model("llama-moe-tiny", device="cpu",
                                       dtype=torch.float32), init)
        assert _routed_margin(tm, tokens[:2]) > MARGIN
        assert _routed_margin(tm, tokens[2:]) > MARGIN
        tx = fo.FusedOptimizer(rule="sgd", lr=0.5, momentum=0.9,
                               bucket_bytes=32768) \
            if update == "fused_bucket" else ttrain.sgd(0.5, momentum=0.9)
        state = ttrain.create_train_state(tm, tx)
        step = ttrain.make_accum_train_step(
            _next_token, microbatches=2, update=update, bucket_bytes=32768)
        for want in jmetrics:
            state, m = step(state, {"x": torch.from_numpy(tokens)})
            for key in ("loss", "grad_norm", "aux_loss"):
                assert float(m[key]) == pytest.approx(
                    want[key], abs=TOL, rel=TOL), key
            assert float(m["aux_loss"]) > 0
        ref = params_from_jax(jparams)
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                       atol=TOL, rtol=0, err_msg=name)

    def test_routing_records_and_pins_each_layer(self):
        """moe.routing records each layer's first choices (remat's
        recomputation routes again) and pins them: a bf16 twin of the
        model, pinned to the f32 model's routing, routes every token of
        every layer as it did, and the pin leaves the f32 grads' bits
        as they were."""
        params, *_ = _jax_reference()
        tok = torch.from_numpy(_tokens(4))
        grads, seen = [], []
        for pin in (None, "f32"):
            tm = _port_moe(params, remat=True)
            seen.append({})
            with moe.routing(tm, seen=seen[-1],
                             pin=seen[0] if pin else None):
                out, aux = tm(tok)
                (ttrain.next_token_loss(out, tok) + aux).backward()
            grads.append([p.grad for p in tm.parameters()])
        assert sorted(seen[0]) == [0, 1]
        assert all(torch.equal(a, b) for a, b in zip(*grads))
        twin = get_model("llama-moe-tiny", device="cpu",
                         dtype=torch.bfloat16)
        twin.load_state_dict(tm.state_dict())
        got = {}
        with moe.routing(twin, seen=got, pin=seen[0]), torch.no_grad():
            twin(tok)
        for i, choice in seen[0].items():
            assert torch.equal(got[i], choice)

    def test_serve_refuses_moe(self):
        tm = get_model("llama-moe-tiny", device="cpu")
        tok = torch.zeros((1, 4), dtype=torch.int32)
        kv = (torch.zeros(2, 1, 8, 32), torch.zeros(2, 1, 8, 32))
        with pytest.raises(ValueError, match="serve mode does not support "
                                             "MoE blocks"):
            tm(tok, positions=tok, kv=kv, ctx=4)

    def test_convert_round_trip_of_a_scanned_tree(self):
        """The JAX tree → the port → the port's view of the JAX tree:
        every leaf's path, shape and values as JAX holds them (the stacked
        [L, E, D, F] experts included), and the logical axes the
        reference names for the MoE leaves."""
        _, params = _jax_moe()
        tm = _port_moe(params)
        view = jax_param_tree(tm)
        ref = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, params))[0]
        got = dict(jax.tree_util.tree_flatten_with_path(
            view, is_leaf=lambda x: not isinstance(x, dict))[0])
        assert sorted(map(str, got)) == sorted(str(p) for p, _ in ref)
        for path, want in ref:
            np.testing.assert_array_equal(_dense(got[path]), want,
                                          err_msg=str(path))
        axes = ttransformer.logical_axes
        assert axes("layers.0.moe_mlp.w_router") == ("embed", "expert_dim")
        assert axes("layers.1.moe_mlp.w_gate") == ("expert", "embed", "ffn")
        assert axes("layers.1.moe_mlp.w_down") == ("expert", "ffn", "embed")


def test_registered_configs_are_the_references(monkeypatch):
    """mixtral-8x7b and llama-moe-tiny build with the JAX package's
    defaults (mixtral on the meta device: 46.7 B parameters)."""
    monkeypatch.setattr(ttransformer.Transformer, "init_weights",
                        lambda self, seed=0: self)
    for name in ("mixtral-8x7b", "llama-moe-tiny"):
        tm = get_model(name, device="meta" if name[0] == "m" else "cpu")
        want = dataclasses.asdict(jax_model(name).cfg)
        for field, value in dataclasses.asdict(tm.cfg).items():
            if field in want and field not in ("dtype", "mesh"):
                assert value == want[field], (name, field)
        blocks = [m for m in tm.modules() if isinstance(m, moe.MoEMLP)]
        assert len(blocks) == tm.cfg.n_layers
        assert tuple(blocks[0].w_gate.shape) == (
            tm.cfg.moe_experts, tm.cfg.dim, tm.cfg.ffn_hidden)
    assert sum(p.numel() for p in get_model(
        "mixtral-8x7b", device="meta").parameters()) == 46_702_792_704
