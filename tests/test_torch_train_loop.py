"""Port parity for the training loop slice (tony_tpu_torch.train,
models.transformer, constants, chaos, profiler): the chunked LM-head
loss (``xent_chunk``) and the selective remat policies against the JAX
package on llama-tiny (weights carried across by load_jax_params; the
JAX model runs reference attention on the CPU), ``global_batch``'s
contract errors, ``train_loop`` and ``train_stats_writer`` against the
JAX package's, and the copied constants. Inputs come from numpy seeds."""

from __future__ import annotations

import json
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from tony_tpu import chaos as jchaos
from tony_tpu import constants as jconstants
from tony_tpu import profiler as jprofiler
from tony_tpu import train as jtrain
from tony_tpu.models import get_model as jax_model
from tony_tpu_torch import chaos, ckpt, constants, profiler, publish
from tony_tpu_torch import train as ttrain
from tony_tpu_torch.ckpt import format as fmt
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params, params_from_jax
from tony_tpu_torch.parallel import AXES, Mesh

TINY_PACKED = dict(dim=256, n_heads=2, n_kv_heads=1, ffn_hidden=256)


def _tokens(seed, b=2, t=17, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(
        np.int32)


def _jax_params(model, tokens):
    return nn.unbox(jax.jit(model.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(tokens)))["params"]


def _port(params, **kw):
    model = get_model("llama-tiny", dtype=torch.float32, device="cpu", **kw)
    return load_jax_params(model, jax.tree.map(np.asarray, params))


def _port_grads(model, tokens):
    """Loss and every grad of one backward: the chunked loss with
    ``targets`` where the model has ``xent_chunk``, else the plain head's
    next-token loss."""
    model.zero_grad(set_to_none=True)
    tok = torch.from_numpy(tokens)
    if model.cfg.xent_chunk:
        loss = model(tok, targets=tok)
    else:
        loss = ttrain.next_token_loss(model(tok), tok)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def _jax_grads(fn, params):
    loss, grads = jax.jit(jax.value_and_grad(fn))(params)
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


def _close(got, ref, atol, rtol):
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   atol=atol, rtol=rtol, err_msg=name)


def _equal(got, ref):
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert torch.equal(got[name], ref[name]), name


class TestChunkedLoss:
    """The JAX package's test_chunked_xent_matches_plain_head setup: f32
    llama-tiny, tokens [2, 17] (32 rows), the plain model's weights with
    the head kernel moved to ``lm_head_kernel``."""

    @pytest.fixture(scope="class")
    def setup(self):
        tokens = _tokens(1)
        plain = jax_model("llama-tiny", dtype=jnp.float32)
        fused = jax_model("llama-tiny", dtype=jnp.float32, xent_chunk=8)
        params = _jax_params(plain, tokens)
        fparams = dict(params)
        fparams["lm_head_kernel"] = fparams.pop("lm_head")["kernel"]
        jl_plain, jg_plain = _jax_grads(
            lambda p: jtrain.next_token_loss(
                plain.apply({"params": p}, jnp.asarray(tokens)),
                jnp.asarray(tokens)), params)
        jl_fused, jg_fused = _jax_grads(
            lambda p: fused.apply({"params": p}, jnp.asarray(tokens),
                                  targets=jnp.asarray(tokens)), fparams)
        return dict(tokens=tokens, fparams=fparams, plain=(jl_plain,
                                                           jg_plain),
                    fused=(jl_fused, jg_fused))

    @pytest.mark.parametrize("ref", ["fused", "plain"])
    def test_loss_and_grads_vs_jax(self, setup, ref):
        """The port's xent_chunk=8 model (the JAX tree's lm_head_kernel
        mapped into lm_head.weight) against JAX's chunked loss and JAX's
        plain head: loss to 1e-5 relative, grads atol 1e-5, rtol 1e-4."""
        tm = _port(setup["fparams"], xent_chunk=8)
        loss, grads = _port_grads(tm, setup["tokens"])
        jl, jg = setup[ref]
        assert float(loss) == pytest.approx(jl, rel=1e-5)
        _close(grads, jg, atol=1e-5, rtol=1e-4)

    def test_padded_chunks_equal_the_plain_head(self, setup):
        """chunk 7 over 32 rows: the last chunk holds 4 real rows, and the
        loss and grads divide by the 32 real rows, not by 35."""
        plain_loss, plain_grads = _port_grads(_port(setup["fparams"]),
                                              setup["tokens"])
        loss, grads = _port_grads(_port(setup["fparams"], xent_chunk=7),
                                  setup["tokens"])
        assert float(loss) == pytest.approx(float(plain_loss), rel=1e-5)
        _close(grads, plain_grads, atol=1e-5, rtol=1e-4)

    @pytest.mark.parametrize("chunk", [1, 7, 30, 64])
    def test_function_vs_jax(self, chunk):
        """chunked_next_token_xent alone on random hidden rows, f32: the
        value and both grads against JAX's function (the head in torch's
        [V, D] layout against JAX's [D, V] kernel)."""
        rng = np.random.RandomState(chunk)
        h = rng.standard_normal((3, 11, 16)).astype(np.float32)
        w = (0.3 * rng.standard_normal((16, 40))).astype(np.float32)
        tok = rng.randint(0, 40, (3, 11)).astype(np.int32)
        jl, (jdh, jdw) = jax.value_and_grad(
            lambda a, b: jtrain.chunked_next_token_xent(
                a, b, jnp.asarray(tok), chunk, jnp.float32),
            argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
        th = torch.from_numpy(h).requires_grad_()
        tw = torch.from_numpy(w.T.copy()).requires_grad_()
        loss = ttrain.chunked_next_token_xent(th, tw, torch.from_numpy(tok),
                                              chunk, torch.float32)
        loss.backward()
        assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-6)
        np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh),
                                   atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw).T,
                                   atol=1e-6, rtol=1e-5)

    def test_bf16_loss_vs_jax(self, setup):
        """bf16 compute: each chunk's product in bf16, the softmax in f32,
        against JAX's bf16 chunked loss (bf16 rounding: 2e-2)."""
        fused = jax_model("llama-tiny", dtype=jnp.bfloat16, xent_chunk=8)
        tokens = setup["tokens"]
        jl = float(fused.apply({"params": setup["fparams"]},
                               jnp.asarray(tokens),
                               targets=jnp.asarray(tokens)))
        tm = get_model("llama-tiny", dtype=torch.bfloat16, device="cpu",
                       xent_chunk=8)
        load_jax_params(tm, jax.tree.map(np.asarray, setup["fparams"]))
        loss, grads = _port_grads(tm, tokens)
        assert loss.dtype == torch.float32
        assert abs(float(loss) - jl) <= 2e-2 * abs(jl)
        assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                   for g in grads.values())

    @pytest.mark.parametrize("chunk", [8, 7])
    def test_bf16_grads_vs_jax(self, chunk):
        """bf16 compute over 4 chunks (8 rows each) and 5 (the last one
        padded in JAX): the value and both grads against JAX's bf16
        function, each grad held to its own size — relative L2 ≤ 2e-2 and
        max |Δ| ≤ 5e-2·max |ref| (measured: dh 3.3e-3 / 6.9e-3, dW 4.8e-3
        / 8.5e-3); the loss to 1e-3 relative (measured 2e-4). The port
        sums the head's dW over chunks in f32 where JAX's scan carries it
        in bf16 (a stated deviation, ROADMAP.md queue 3). Controls: a
        zeroed dh or dW, and the dW of every chunk but the last (rows of
        the last chunk zeroed: relative L2 0.37-0.50), fail the limit."""
        rng = np.random.RandomState(chunk)
        h = rng.standard_normal((2, 17, 64)).astype(np.float32)
        w = (0.3 * rng.standard_normal((64, 256))).astype(np.float32)
        tok = rng.randint(0, 256, (2, 17)).astype(np.int32)
        jl, (jdh, jdw) = jax.value_and_grad(
            lambda a, b: jtrain.chunked_next_token_xent(
                a, b, jnp.asarray(tok), chunk, jnp.bfloat16),
            argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
        jdh, jdw = np.asarray(jdh), np.asarray(jdw).T

        def port(hidden):
            th = torch.from_numpy(hidden).requires_grad_()
            tw = torch.from_numpy(w.T.copy()).requires_grad_()
            loss = ttrain.chunked_next_token_xent(
                th, tw, torch.from_numpy(tok), chunk, torch.bfloat16)
            loss.backward()
            return float(loss.detach()), th.grad.numpy(), tw.grad.numpy()

        def near(got, ref):
            d = got - ref
            return (np.linalg.norm(d) <= 2e-2 * np.linalg.norm(ref)
                    and np.abs(d).max() <= 5e-2 * np.abs(ref).max())

        loss, dh, dw = port(h)
        assert -(-32 // chunk) >= 2
        assert abs(loss - float(jl)) <= 1e-3 * abs(float(jl))
        assert near(dh, jdh) and near(dw, jdw)
        short = h.copy()
        for row in range(31 // chunk * chunk, 32):   # the last chunk's rows
            short[row // 16, row % 16] = 0.0
        assert not near(port(short)[2], jdw)
        assert not near(np.zeros_like(dw), jdw)
        assert not near(np.zeros_like(dh), jdh)

    def test_without_targets_the_plain_head(self, setup):
        """No targets: the same logits as the plain-head model, bitwise,
        in training and in the serving forward."""
        tok = torch.from_numpy(setup["tokens"])
        plain = _port(setup["fparams"])
        fused = _port(setup["fparams"], xent_chunk=8)
        assert torch.equal(fused(tok), plain(tok))
        kv = (torch.zeros(2, 2, 32, 32), torch.zeros(2, 2, 32, 32))
        pos = torch.arange(17).repeat(2, 1)
        got, _ = fused(tok, positions=pos, kv=kv)
        ref, _ = plain(tok, positions=pos, kv=tuple(t.clone() for t in kv))
        assert torch.equal(got, ref)

    def test_argument_errors(self):
        with pytest.raises(ValueError, match="xent_chunk"):
            get_model("llama-tiny", device="cpu", quant=("lm_head",),
                      xent_chunk=8)
        with pytest.raises(ValueError, match="xent_chunk"):
            tm = get_model("llama-tiny", device="cpu")
            tok = torch.zeros((1, 8), dtype=torch.int32)
            tm(tok, targets=tok)
        with pytest.raises(ValueError, match="chunk must be positive"):
            ttrain.chunked_next_token_xent(torch.zeros(1, 4, 8),
                                           torch.zeros(5, 8),
                                           torch.zeros(1, 4), 0)

    def test_through_train_step_matches_jax(self, setup):
        """The reference's test_chunked_xent_through_train_step: the step
        drives the fused loss through apply_kwargs_of and loss_of returns
        the model's scalar. Three AdamW(1e-3) steps from the same weights
        on the same batch against the JAX step: loss and grad norm to 1e-5
        relative, parameters to 2e-6 absolute (as the plain-head step's
        parity test)."""
        tokens = setup["tokens"]
        fused = jax_model("llama-tiny", dtype=jnp.float32, xent_chunk=8)
        jstate = jtrain.create_train_state(
            fused, optax.adamw(1e-3), jnp.asarray(tokens),
            jax.random.PRNGKey(0))
        # A copy: the JAX step donates its state's parameters.
        jparams = jax.tree.map(jnp.array, setup["fparams"])
        jstate = jstate.replace(params=jparams,
                                opt_state=jstate.tx.init(jparams))
        jstep = jtrain.make_train_step(
            loss_of=lambda out, batch: out,
            apply_kwargs_of=lambda batch: {"targets": batch["x"]})
        tm = _port(setup["fparams"], xent_chunk=8)
        state = ttrain.create_train_state(tm, ttrain.adamw(1e-3))
        step = ttrain.make_train_step(
            loss_of=lambda out, batch: out,
            apply_kwargs_of=lambda batch: {"targets": batch["x"]})
        losses = []
        for _ in range(3):
            jstate, jm = jstep(jstate, {"x": jnp.asarray(tokens)})
            state, m = step(state, {"x": torch.from_numpy(tokens)})
            assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                     rel=1e-5)
            assert float(m["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=1e-5)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0]
        ref = params_from_jax(jax.tree.map(np.asarray, jstate.params))
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                       atol=2e-6, rtol=0, err_msg=name)


class _CountProducts(TorchDispatchMode):
    """Counts the aten products a forward and backward dispatch."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "addmm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


class TestRematPolicies:
    POLICIES = [None, "dots", "dots_no_batch"]

    @pytest.mark.parametrize("packed", [False, True],
                             ids=["reference", "flash_packed"])
    @pytest.mark.parametrize("policy", POLICIES)
    def test_grads_equal_no_remat_and_jax(self, policy, packed):
        """The reference's test_remat_policy_variants, unscanned: every
        policy trains (a finite step) and its grads equal the port's
        remat=False grads bitwise (the kept and the recomputed values
        come from the same ops on the same inputs) and JAX's grads under
        the same policy within 1e-4. ``flash_packed`` routes the port
        through the flash autograd Function (head_dim 128), whose plain
        version the remat region recomputes."""
        shape = TINY_PACKED if packed else {}
        tokens = _tokens(0, t=16)
        jm = jax_model("llama-tiny", dtype=jnp.float32, remat=True,
                       remat_policy=policy, scan_layers=False, **shape)
        params = _jax_params(jm, tokens)
        jl, jg = _jax_grads(
            lambda p: jtrain.next_token_loss(
                jm.apply({"params": p}, jnp.asarray(tokens)),
                jnp.asarray(tokens)), params)
        attention = "flash" if packed else "reference"
        loss, grads = _port_grads(_port(params, remat=True,
                                        remat_policy=policy,
                                        attention=attention, **shape),
                                  tokens)
        base_loss, base = _port_grads(_port(params, remat=False,
                                            attention=attention, **shape),
                                      tokens)
        assert torch.equal(loss, base_loss)
        _equal(grads, base)
        assert float(loss) == pytest.approx(jl, rel=1e-5)
        _close(grads, jg, atol=1e-4, rtol=1e-4)
        tm = _port(params, remat=True, remat_policy=policy,
                   attention=attention, **shape)
        state = ttrain.create_train_state(tm, ttrain.adamw(1e-3))
        _, m = ttrain.make_train_step(
            loss_of=lambda lg, b: ttrain.next_token_loss(lg, b["x"]))(
                state, {"x": torch.from_numpy(tokens)})
        assert np.isfinite(float(m["loss"]))

    def test_what_each_policy_recomputes(self):
        """Products dispatched by one forward and backward, less those of
        remat=False: ``None`` recomputes the projections' mm and the
        reference attention's bmm, ``dots`` neither, ``dots_no_batch`` the
        bmm only."""
        tokens = torch.from_numpy(_tokens(3, t=16))
        model = get_model("llama-tiny", dtype=torch.float32, device="cpu",
                          remat=False)

        def counts(**kw):
            m = get_model("llama-tiny", dtype=torch.float32, device="cpu",
                          **kw)
            m.load_state_dict(model.state_dict())
            with _CountProducts() as mode:
                ttrain.next_token_loss(m(tokens), tokens).backward()
            return mode.counts

        base = counts(remat=False)
        assert base["mm"] > 0 and base["bmm"] > 0
        extra = {policy: {k: v - base[k] for k, v in
                          counts(remat=True, remat_policy=policy).items()}
                 for policy in self.POLICIES}
        layers = model.cfg.n_layers
        # Per layer the two attention einsums, and the projections up to
        # the last one a backward needs (the recompute stops once every
        # saved value is back, so w_down's product is not redone).
        assert extra[None]["mm"] > 0
        assert extra[None]["bmm"] == 2 * layers
        assert extra["dots"] == {"mm": 0, "addmm": 0, "bmm": 0}
        assert extra["dots_no_batch"] == {"mm": 0, "addmm": 0,
                                          "bmm": 2 * layers}

    def test_policy_errors(self):
        with pytest.raises(ValueError, match="unknown remat_policy"):
            get_model("llama-tiny", device="cpu", remat=True,
                      remat_policy="nope")
        with pytest.raises(ValueError, match="remat=False"):
            get_model("llama-tiny", device="cpu", remat=False,
                      remat_policy="dots_no_batch")


def _mesh(**sizes):
    """A hand-built mesh of the JAX tests' shape: the port runs one rank
    per device, so a one-process mesh of 8 devices (the JAX package's
    virtual CPU mesh) is written out by hand to reach the contract's
    errors."""
    shape = dict.fromkeys(AXES, 1)
    shape.update(sizes)
    return Mesh(shape=shape, processes=1, device=torch.device("cpu"))


class TestGlobalBatch:
    """The reference's TestGlobalBatchValidation, message for message."""

    def test_mismatched_leaf_batch_dim_names_leaf(self):
        with pytest.raises(ValueError) as e:
            ttrain.global_batch(_mesh(data=8), {"x": np.zeros((8, 4)),
                                                "y": np.zeros((6,))})
        assert "['y']" in str(e.value) and "['x']" in str(e.value)

    def test_indivisible_batch_dim_names_sharding(self):
        with pytest.raises(ValueError, match="not divisible by the 8-way"):
            ttrain.global_batch(_mesh(data=8), {"x": np.zeros((7, 4)),
                                                "y": np.zeros((7,))})

    def test_rank0_leaf_rejected(self):
        with pytest.raises(ValueError, match=r"\['n'\]"):
            ttrain.global_batch(_mesh(data=8), {"n": np.float32(3.0)})

    def test_seq_axis_divisibility_checked(self):
        with pytest.raises(ValueError, match="sequence dim 7"):
            ttrain.global_batch(_mesh(data=4, seq=2),
                                {"x": np.zeros((8, 7))}, seq_axis=True)

    def test_messages_equal_the_reference(self):
        """The same bad batches give the JAX package's exact messages."""
        from tony_tpu import parallel as par

        jmesh = par.make_mesh()
        for batch in ({"x": np.zeros((8, 4)), "y": np.zeros((6,))},
                      {"x": np.zeros((7, 4)), "y": np.zeros((7,))},
                      {"n": np.float32(3.0)}, {"a": [np.zeros((8,)), 3.0]}):
            with pytest.raises(ValueError) as ref:
                jtrain.global_batch(jmesh, batch)
            with pytest.raises(ValueError) as got:
                ttrain.global_batch(_mesh(data=8), batch)
            assert str(got.value) == str(ref.value)

    def test_validation_memoized_per_contract(self, monkeypatch):
        calls = {"n": 0}
        orig = ttrain._validate_local_batch

        def counting(*a, **k):
            calls["n"] += 1
            return orig(*a, **k)

        monkeypatch.setattr(ttrain, "_validate_local_batch", counting)
        monkeypatch.setattr(ttrain, "_VALIDATED_CONTRACTS",
                            weakref.WeakKeyDictionary())
        mesh = _mesh(data=8)
        good = {"x": np.zeros((8, 4)), "y": np.zeros((8,))}
        for _ in range(3):
            ttrain.global_batch(mesh, good)
        assert calls["n"] == 1
        for _ in range(2):
            with pytest.raises(ValueError):
                ttrain.global_batch(mesh, {"x": np.zeros((8, 4)),
                                           "y": np.zeros((6,))})
        assert calls["n"] == 3

    def test_valid_batch_passes_and_check_can_be_skipped(self, monkeypatch):
        """A valid batch comes back as tensors on the mesh's device in its
        own structure. ``check=False`` skips the pre-flight (the reference
        then fails in jax's assembly; under data parallelism there is no
        assembly, so the port returns the rows as given)."""
        out = ttrain.global_batch(_mesh(data=8), {
            "x": np.arange(32).reshape(8, 4), "y": [np.zeros((8,))]})
        assert out["x"].shape == (8, 4) and out["x"].device.type == "cpu"
        assert torch.equal(out["x"], torch.arange(32).reshape(8, 4))
        assert isinstance(out["y"], list) and out["y"][0].shape == (8,)
        monkeypatch.setattr(ttrain, "_validate_local_batch",
                            lambda *a, **k: pytest.fail("validated"))
        out = ttrain.global_batch(_mesh(data=8), {"x": np.zeros((7, 4))},
                                  check=False)
        assert out["x"].shape == (7, 4)


@pytest.fixture
def clean_train_env(monkeypatch):
    for name in (constants.ENV_CKPT_DIR, constants.ENV_CKPT_EVERY,
                 constants.ENV_CKPT_KEEP, constants.ENV_PUBLISH_EVERY,
                 constants.ENV_DRAIN_FILE, constants.ENV_SERVE_STATS,
                 chaos.ENV_KILL_STEP):
        monkeypatch.delenv(name, raising=False)
    yield
    chaos.reset()


class _Data:
    def __init__(self, n):
        self.items = [{"i": i} for i in range(n)]
        self.closed = 0

    def __iter__(self):
        return iter(self.items)

    def close(self):
        self.closed += 1


@pytest.mark.usefixtures("clean_train_env")
class TestTrainLoop:
    def test_needs_exactly_one_of_batches_and_data(self):
        with pytest.raises(ValueError, match="exactly one"):
            ttrain.train_loop({}, lambda s, b: (s, {}), batches=[],
                              data=iter([]))
        with pytest.raises(ValueError, match="exactly one"):
            ttrain.train_loop({}, lambda s, b: (s, {}))

    def test_folds_in_order_and_returns_the_last_metrics(self):
        seen = []

        def step(state, batch):
            return state + [batch["i"]], {"loss": float(batch["i"])}

        data = _Data(4)
        state, metrics = ttrain.train_loop(
            [], step, data=data,
            on_step=lambda i, m: seen.append((i, m["loss"])))
        assert state == [0, 1, 2, 3] and metrics == {"loss": 3.0}
        assert seen == [(1, 0.0), (2, 1.0), (3, 2.0), (4, 3.0)]
        assert data.closed == 1

    def test_consults_kill_point(self, monkeypatch):
        """The reference's test_train_loop_consults_kill_point: the kill
        lands as step 2 completes, after step 1's on_step and before step
        2's."""
        class _Killed(Exception):
            pass

        def hook(step):
            raise _Killed(step)

        monkeypatch.setenv(chaos.ENV_KILL_STEP, "2")
        monkeypatch.setattr(chaos, "KILL_HOOK", hook)
        seen = []
        data = _Data(5)
        with pytest.raises(_Killed):
            ttrain.train_loop({"w": 0}, lambda s, b: (s, {}), data=data,
                              on_step=lambda step, m: seen.append(step))
        assert seen == [1]
        assert data.closed == 1          # closed on the way out
        monkeypatch.setenv(chaos.ENV_KILL_STEP, "two")
        with pytest.raises(ValueError, match="not an integer"):
            ttrain.train_loop({}, lambda s, b: (s, {}), [{}])

    @pytest.mark.parametrize("by_env", [False, True])
    def test_drain_file_exits_drained(self, tmp_path, monkeypatch, by_env):
        """With the drain flag present the loop stops after the step it
        polls on with SystemExit(14), the executor's EXIT_DRAINED (no
        checkpoint directory, so nothing to commit first)."""
        flag = tmp_path / "drain"
        flag.write_text("")
        if by_env:
            monkeypatch.setenv(constants.ENV_DRAIN_FILE, str(flag))
        kw = {} if by_env else {"drain_file": str(flag)}
        seen = []
        data = _Data(5)
        with pytest.raises(SystemExit) as e:
            ttrain.train_loop({}, lambda s, b: (s, {}), data=data,
                              on_step=lambda i, m: seen.append(i), **kw)
        assert e.value.code == constants.EXIT_DRAINED == 14
        assert seen == [1] and data.closed == 1

    @pytest.mark.parametrize("arg,env", [
        ({"ckpt_dir": "ckpt"}, None), ({"save_every": 2}, None),
        ({"keep": 3}, None), ({"publish_every": 1}, None),
        ({}, ("TONY_CKPT_DIR", "ckpt")), ({}, ("TONY_CKPT_EVERY", "2")),
        ({}, ("TONY_PUBLISH_EVERY", "1"))])
    def test_checkpoint_settings_take_effect(self, tmp_path, monkeypatch,
                                             arg, env):
        """Each checkpoint argument and env takes effect, where it raised
        before the checkpoint plane was ported: a directory commits the
        final step, a save interval commits every k-th step, a retention
        prunes, a publication interval advances published.json. Five
        steps on a tensor state; the directory comes from the case or,
        for the other settings, is passed beside them."""
        root = tmp_path / "ckpt"
        arg = {k: (str(root) if k == "ckpt_dir" else v)
               for k, v in arg.items()}
        if env is not None:
            monkeypatch.setenv(env[0], str(root) if env[1] == "ckpt"
                               else env[1])
        kw = dict(arg)
        if "ckpt_dir" not in kw and (env is None or env[0] !=
                                     constants.ENV_CKPT_DIR):
            kw["ckpt_dir"] = str(root)
        if "keep" in kw:
            kw["save_every"] = 1
        calls = []

        def step(state, batch):
            calls.append(batch)
            state["w"] += 1.0
            return state, {}

        state, _ = ttrain.train_loop({"w": torch.zeros(2)}, step,
                                     [{}] * 5, **kw)
        assert len(calls) == 5 and torch.equal(state["w"],
                                               torch.full((2,), 5.0))
        steps = fmt.committed_steps(root)
        name = next(iter(arg)) if arg else env[0]
        if name in ("save_every", constants.ENV_CKPT_EVERY):
            assert steps == [2, 4, 5]           # every 2nd step + final
        elif name == "keep":
            assert steps == [3, 4, 5]           # 5 saves, 3 kept
        else:
            assert steps == [5]
        published = publish.latest_publication(root)
        if name in ("publish_every", constants.ENV_PUBLISH_EVERY):
            assert (published["version"], published["step"]) == (1, 5)
        else:
            assert published is None
        target = {"w": torch.zeros(2)}
        ckpt.restore_pytree(root, target)
        assert torch.equal(target["w"], torch.full((2,), 5.0))

    def test_unset_checkpoint_env_trains(self, monkeypatch):
        """Empty or zero checkpoint env values mean "not set", as in the
        reference."""
        monkeypatch.setenv(constants.ENV_CKPT_DIR, "")
        monkeypatch.setenv(constants.ENV_CKPT_EVERY, "0")
        monkeypatch.setenv(constants.ENV_PUBLISH_EVERY, "")
        state, _ = ttrain.train_loop(0, lambda s, b: (s + 1, {}), [{}, {}])
        assert state == 2


@pytest.mark.usefixtures("clean_train_env")
class TestStatsWriter:
    def test_same_keys_and_values_as_the_jax_writer(self, tmp_path):
        """The same metrics and collective records through both writers:
        the same keys, step, loss and collective bytes, and an MFU above 0
        from the flops given."""
        record = dict(kind="all_reduce", plane="grad_reduce", axes=["data"],
                      nbytes=[4096, 1024, 12])
        jprofiler.reset_collective_records()
        profiler.reset_collective_records()
        jprofiler.record_collective("train.grad", **record)
        profiler.record_collective("train.grad", **record)
        try:
            out = {}
            for name, writer, loss in (
                    ("jax", jtrain.train_stats_writer, jnp.float32(2.5)),
                    ("torch", ttrain.train_stats_writer,
                     torch.tensor(2.5))):
                path = tmp_path / f"{name}.json"
                on_step = writer(str(path), flops_per_step=1e9,
                                 peak_flops=1e12)
                on_step(3, {"loss": loss, "grad_norm": loss})
                out[name] = json.loads(path.read_text())
        finally:
            jprofiler.reset_collective_records()
            profiler.reset_collective_records()
        assert sorted(out["torch"]) == sorted(out["jax"]) == sorted(
            ["step", "step_time_s", "collective_bytes", "mfu", "loss"])
        for key in ("step", "collective_bytes", "loss"):
            assert out["torch"][key] == out["jax"][key], key
        assert out["torch"]["collective_bytes"] == 5132.0
        assert out["torch"]["mfu"] > 0 and out["torch"]["step_time_s"] > 0
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "jax.json", "torch.json"]          # no staged file left

    def test_env_path_and_no_op_without_one(self, tmp_path, monkeypatch):
        ttrain.train_stats_writer()(1, {"loss": torch.tensor(1.0)})
        assert list(tmp_path.iterdir()) == []
        path = tmp_path / "stats.json"
        monkeypatch.setenv(constants.ENV_SERVE_STATS, str(path))
        writer = ttrain.train_stats_writer()
        writer(1, {"loss": torch.tensor(1.0)})
        writer(2, {})
        got = json.loads(path.read_text())
        assert got["step"] == 2.0 and "loss" not in got
        assert got["mfu"] == 0.0          # no flops given


def test_constants_equal_the_reference():
    names = ("ENV_CKPT_DIR", "ENV_CKPT_EVERY", "ENV_CKPT_KEEP",
             "ENV_DATA_SEED", "ENV_PROCESS_ID", "ENV_NUM_PROCESSES",
             "ENV_TASK_INDEX", "ENV_TASK_NUM", "ENV_SERVE_STATS",
             "ENV_DRAIN_FILE", "ENV_PUBLISH_EVERY", "ENV_MASTER_ADDR",
             "ENV_MASTER_PORT", "ENV_RANK", "ENV_WORLD_SIZE",
             "ENV_LOCAL_RANK", "ENV_INIT_METHOD", "EXIT_DRAINED",
             "ENV_JOB_NAME", "ENV_CONF_PATH")
    for name in names:
        assert getattr(constants, name) == getattr(jconstants, name), name
    for name in ("ENV_KILL_STEP", "ENV_CRASH", "ENV_RPC_DELAY_S",
                 "ENV_RPC_DELAY_CALLS"):
        assert getattr(chaos, name) == getattr(jchaos, name), name
    ours = {k for k in vars(constants) if k.isupper()}
    assert ours == set(names)


def test_collective_report_is_a_copy():
    profiler.reset_collective_records()
    profiler.record_collective("t", kind="all_reduce", nbytes=[1, 2])
    report = profiler.collective_report()
    report["t"]["nbytes"].append(3)
    assert profiler.collective_report() == {
        "t": {"kind": "all_reduce", "nbytes": [1, 2]}}
    profiler.reset_collective_records()
    assert profiler.collective_report() == {}
