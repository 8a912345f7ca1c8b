"""Port parity for the serving replica (tony_tpu_torch.serve.replica,
.swap, the engine's stats and in-place swap, tony_tpu_torch.rpc): a
checkpoint the JAX package wrote, served by the JAX replica and by the
port's (bf16 policy: every parameter bitwise; f32: greedy tokens equal,
logits within 1e-4, the tolerance tests/test_torch_serve.py holds the
engines to); a step the port's train_loop committed served bitwise; the
reference's TestDtypePolicy (tests/test_serve.py), TestEngineSwap and
TestHotSwap (tests/test_publish.py) pins on the port; the RPC wire in
both directions through the JAX ProxyServer; the JAX executor's
heartbeat, session and RequestRouter routing a request to the port
replica; ``python -m tony_tpu_torch.serve.replica`` launched with the
executor's environment; the routed lanes (prefix cache, chunked
prefill, speculation) armed through ``main()`` serving the plain
replica's tokens, the prefix digest through the JAX executor's reader
and router, and a hot swap flushing the prefix tier; and every lane the
port has not ported raising with its ROADMAP item. llama-tiny, 2
layers, on the CPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tony_tpu import ckpt as jckpt
from tony_tpu import constants as jconstants
from tony_tpu import train as jtrain
from tony_tpu.conf import TonyConfig as JTonyConfig
from tony_tpu.executor import TaskExecutor
from tony_tpu.models import get_model as jax_model
from tony_tpu.proxy import ProxyServer
from tony_tpu.rpc import ApplicationRpcHandler
from tony_tpu.rpc import RpcClient as JRpcClient
from tony_tpu.rpc import RpcError as JRpcError
from tony_tpu.rpc import RpcServer as JRpcServer
from tony_tpu.serve.replica import Replica as JReplica
from tony_tpu.serve.router import RequestRouter
from tony_tpu.session import TonySession
from tony_tpu.util import normalize_serve_telemetry
from tony_tpu_torch import chaos, ckpt, constants, profiler, publish
from tony_tpu_torch import train as ttrain
from tony_tpu_torch.ckpt import format as fmt
from tony_tpu_torch.conf import (SERVE_AOT_CACHE, SERVE_CKPT_DIR,
                                 SERVE_DEMOTE_BATCH, SERVE_DEMOTE_WATERMARK,
                                 SERVE_DRAFT_MODEL, SERVE_DRAFT_MODEL_KWARGS,
                                 SERVE_HOST_BLOCKS,
                                 SERVE_MESH, SERVE_MODEL, SERVE_MODEL_KWARGS,
                                 SERVE_PREFILL_CHUNK, SERVE_PREFIX_CACHE,
                                 SERVE_PREFIX_STORE, SERVE_QOS_TENANTS,
                                 SERVE_SPEC_K, SERVE_WARM_STANDBY,
                                 serve_role_key, serve_warm_standby_key)
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import jax_param_tree, params_from_jax
from tony_tpu_torch.rpc import RpcClient, RpcError, RpcServer
from tony_tpu_torch.serve import (Replica, Request, ServeEngine, SpecEngine,
                                  SwapError, replica as replica_mod)

ROOT = Path(__file__).resolve().parent.parent
ENGINE_KW = dict(ctx_max=64, block_size=8, q_block=16, max_running=4,
                 keep_logits=True)
PROMPTS = [[int(x) for x in np.random.RandomState(s).randint(0, 256, n)]
           for s, n in ((1, 6), (2, 11), (3, 14))]
TOKENS = np.random.RandomState(0).randint(0, 256, (4, 16)).astype(np.int32)


class _Crashed(RuntimeError):
    """A chaos crash site fired (the test hook stands in for SIGKILL)."""


@pytest.fixture(autouse=True)
def _chaos_clean(monkeypatch):
    for name in (chaos.ENV_KILL_STEP, chaos.ENV_CRASH,
                 chaos.ENV_RPC_DELAY_S, chaos.ENV_RPC_DELAY_CALLS,
                 constants.ENV_SERVE_STATS, constants.ENV_CONF_PATH,
                 constants.ENV_JOB_NAME):
        monkeypatch.delenv(name, raising=False)
    chaos.reset()
    yield
    chaos.reset()


def _replica(root, **kw):
    """The port replica of llama-tiny (2 layers) on the CPU."""
    model_kwargs = {"n_layers": 2, "device": "cpu",
                    **kw.pop("model_kwargs", {})}
    return Replica(model_name="llama-tiny", model_kwargs=model_kwargs,
                   ckpt_dir=str(root), dtype_policy=kw.pop("dtype_policy",
                                                           "bf16"),
                   **{**ENGINE_KW, **kw})


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor's (or a bf16-valued tensor's) 16 bits."""
    return t.detach().to(torch.bfloat16).view(torch.int16)


def _port_state(seed, **kw):
    model = get_model("llama-tiny", device="cpu", dtype=torch.float32,
                      seed=seed, **kw)
    return ttrain.create_train_state(model, ttrain.adamw(1e-3))


def _save(root, tree, step):
    saver = ckpt.AsyncCheckpointer(root)
    saver.save(tree, step=step, block=True)
    saver.close()


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """Two committed train states the JAX package wrote (llama-tiny,
    adamw, f32 masters): step 1 from seed 0, step 2 from seed 7."""
    root = tmp_path_factory.mktemp("jax") / "ckpt"
    model = jax_model("llama-tiny", n_layers=2)
    saver = jckpt.AsyncCheckpointer(root)
    for step, seed in ((1, 0), (2, 7)):
        state = jtrain.create_train_state(
            model, optax.adamw(1e-3), jnp.asarray(TOKENS),
            jax.random.PRNGKey(seed))
        saver.save(state, step=step, block=True)
    saver.close()
    return str(root)


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """Two committed train states the port wrote (llama-tiny, adamw, f32
    masters; the reference's TrainState paths): step 1 from seed 0, step
    2 from seed 7."""
    root = tmp_path_factory.mktemp("port") / "ckpt"
    for step, seed in ((1, 0), (2, 7)):
        _save(root, ckpt.encode_portable(_port_state(seed)), step)
    return str(root)


# ---------------------------------------------------------------------------
# Restore: the JAX replica against the port's
# ---------------------------------------------------------------------------

class TestRestoreAgainstJax:
    def test_bf16_params_bitwise_the_jax_replicas(self, jax_ckpt):
        jr = JReplica(model_name="llama-tiny", model_kwargs={"n_layers": 2},
                      ckpt_dir=jax_ckpt, dtype_policy="bf16", ctx_max=64,
                      block_size=8, q_block=16, max_running=4)
        pr = _replica(jax_ckpt)
        assert jr.restored_step == pr.restored_step == 2
        ref = params_from_jax(jax.tree.map(np.asarray, jr.engine.params))
        served = dict(pr.model.named_parameters())
        assert sorted(served) == sorted(ref)
        for name, p in served.items():
            assert ref[name].dtype == torch.bfloat16, name
            assert torch.equal(_bits(p), ref[name].view(torch.int16)), name
            # The f32-stored norm scales hold the bf16 value itself.
            assert torch.equal(p, ref[name].to(p.dtype)), name
        assert served["embedding"].dtype == torch.bfloat16

    def test_f32_tokens_and_logits_vs_jax(self, jax_ckpt):
        jr = JReplica(model_name="llama-tiny",
                      model_kwargs={"n_layers": 2, "dtype": jnp.float32},
                      ckpt_dir=jax_ckpt, dtype_policy=None, ctx_max=64,
                      block_size=8, q_block=16, max_running=4,
                      keep_logits=True)
        pr = _replica(jax_ckpt, dtype_policy=None,
                      model_kwargs={"dtype": torch.float32})
        assert pr.model.embedding.dtype == torch.float32
        for prompt in PROMPTS:
            a = jr.generate(prompt, 5)
            b = pr.generate(prompt, 5)
            assert b.tokens == a.tokens
            for x, y in zip(b.logits, a.logits):
                np.testing.assert_allclose(x, np.asarray(y), atol=1e-4,
                                           rtol=0)

    @pytest.mark.parametrize("layout", [{"xent_chunk": 8},
                                        {"scan_layers": False}],
                             ids=["xent_chunk", "unscanned"])
    def test_f32_param_layouts_vs_jax(self, tmp_path, layout):
        """The head at lm_head_kernel (xent_chunk: both packages serve it
        as a plain x @ w) and the unscanned layer_{i} tree restore and
        serve as the JAX replica does."""
        model = jax_model("llama-tiny", n_layers=2, **layout)
        state = jtrain.create_train_state(
            model, optax.adamw(1e-3), jnp.asarray(TOKENS),
            jax.random.PRNGKey(3))
        saver = jckpt.AsyncCheckpointer(tmp_path)
        saver.save(state, step=1, block=True)
        saver.close()
        jr = JReplica(model_name="llama-tiny",
                      model_kwargs={"n_layers": 2, "dtype": jnp.float32,
                                    **layout},
                      ckpt_dir=str(tmp_path), dtype_policy="f32",
                      ctx_max=64, block_size=8, q_block=16, max_running=4,
                      keep_logits=True)
        pr = _replica(tmp_path, dtype_policy="f32",
                      model_kwargs={"dtype": torch.float32, **layout})
        a, b = jr.generate(PROMPTS[2], 5), pr.generate(PROMPTS[2], 5)
        assert b.tokens == a.tokens
        for x, y in zip(b.logits, a.logits):
            np.testing.assert_allclose(x, np.asarray(y), atol=1e-4, rtol=0)

    def test_port_train_loop_step_served_bitwise(self, tmp_path):
        """A step the port's train_loop committed (xent_chunk: the head
        at lm_head_kernel) serves the bf16 cast of the trained f32
        master, bit for bit; a replica whose kwargs omit xent_chunk is
        told which kwargs to check."""
        state = _port_state(0, xent_chunk=8)
        step = ttrain.make_train_step(
            loss_of=lambda loss, b: loss,
            apply_kwargs_of=lambda b: {"targets": b["x"]})
        batch = {"x": torch.from_numpy(TOKENS)}
        state, _ = ttrain.train_loop(state, step, [batch] * 2,
                                     ckpt_dir=str(tmp_path), save_every=2)
        assert fmt.committed_steps(tmp_path) == [2]
        pr = _replica(tmp_path, model_kwargs={"xent_chunk": 8})
        assert pr.restored_step == 2
        trained = dict(state.model.named_parameters())
        for name, p in pr.model.named_parameters():
            assert torch.equal(_bits(p), _bits(trained[name])), name
        with pytest.raises(KeyError, match="xent_chunk"):
            _replica(tmp_path)

    def test_no_committed_step_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="trained model"):
            _replica(tmp_path)


# ---------------------------------------------------------------------------
# The reference's TestDtypePolicy pins on the port's restore
# ---------------------------------------------------------------------------

class TestDtypePolicy:
    @pytest.fixture()
    def saved_state(self, tmp_path):
        """A port train state after one AdamW step (moments non-zero),
        committed at step 1."""
        state = _port_state(0)
        step = ttrain.make_train_step(
            loss_of=lambda lg, b: ttrain.next_token_loss(lg, b["x"]))
        state, _ = step(state, {"x": torch.from_numpy(TOKENS)})
        _save(tmp_path, ckpt.encode_portable(state), 1)
        return state, tmp_path

    def test_bf16_policy_casts_params_never_opt_slots(self, saved_state):
        state, root = saved_state
        target = _port_state(9)
        ckpt.restore_pytree(root, ckpt.encode_portable(target),
                            dtype_policy="bf16")
        saved = dict(state.model.named_parameters())
        rounded = False
        for name, p in target.model.named_parameters():
            want = saved[name].detach().to(torch.bfloat16).to(p.dtype)
            assert torch.equal(p, want), name
            rounded |= not torch.equal(p, saved[name])
        assert rounded, "the bf16 cast changed nothing: vacuous"
        # Optimizer slots: bit-untouched f32.
        for slot in ("mu", "nu"):
            for a, b in zip(getattr(target.opt_state, slot),
                            getattr(state.opt_state, slot)):
                assert a.dtype == torch.float32 and torch.equal(a, b)
        assert any(bool(m.abs().max() > 0) for m in target.opt_state.mu)

    def test_find_path_prefix_and_subtree_restore(self, saved_state):
        state, root = saved_state
        server = get_model("llama-tiny", device="cpu",
                           param_dtype=torch.bfloat16)
        params = jax_param_tree(server)
        prefix = ckpt.find_path_prefix(root, params)
        assert prefix == ".params"
        ckpt.restore_pytree(root, params, path_prefix=prefix,
                            dtype_policy="bf16")
        saved = dict(state.model.named_parameters())
        for name, p in server.named_parameters():
            assert torch.equal(_bits(p), _bits(saved[name])), name
        assert ckpt.find_path_prefix(root, ckpt.encode_portable(state)) \
            == ""
        with pytest.raises(KeyError):
            ckpt.find_path_prefix(root, {"not": torch.ones(3, 3)})

    def test_unknown_policy_raises(self, saved_state):
        state, root = saved_state
        with pytest.raises(ValueError, match="dtype_policy"):
            ckpt.restore_pytree(root, ckpt.encode_portable(state),
                                dtype_policy="int4")
        with pytest.raises(ValueError, match="dtype_policy"):
            _replica(root, dtype_policy="int4")


# ---------------------------------------------------------------------------
# The reference's TestEngineSwap pins on the port's engine
# ---------------------------------------------------------------------------

def _engine(seed=0, **kw):
    model = get_model("llama-tiny", device="cpu", dtype=torch.float32,
                      seed=seed)
    return ServeEngine(model, device="cpu", decode_buckets=(2, 4),
                       **{**ENGINE_KW, **kw})


def _run_one(eng, rid, prompt, n=4):
    eng.submit(Request(rid=rid, tokens=list(prompt), max_new_tokens=n))
    return eng.run()[0]


# The keys of a replica's stats that the reference's AM, session, router
# and autoscaler read (tony_tpu/am/__init__.py, session.py,
# serve/router.py, serve/scaling.py).
CONTROL_PLANE_KEYS = {"qps", "p99_ms", "queue_depth", "running",
                      "acceptance_rate", "role", "warm_standby",
                      "weight_version", "weight_step", "weight_swaps",
                      "swapping"}


class TestEngineSwap:
    def test_stats_schema_and_prompt_hist(self, tmp_path):
        profiler.reset_serve_records()
        eng = _engine(tag="serve_t")
        eng.submit(Request(rid="a", tokens=list(range(6)),
                           max_new_tokens=2))
        eng.submit(Request(rid="b", tokens=list(range(20)),
                           max_new_tokens=2))
        eng.run()
        s = eng.stats()
        assert s["weight_version"] == 0.0 and s["weight_step"] == 0.0
        assert s["weight_swaps"] == 0.0 and s["swapping"] == 0.0
        assert s["acceptance_rate"] == 0.0 and s["warm_standby"] == 0.0
        assert s["role"] == "colocated"
        # Histogram keys are the PADDED prompt lengths (q_block=16).
        assert s["prompt_hist"] == {"16": 1.0, "32": 1.0}
        assert CONTROL_PLANE_KEYS <= set(s)
        # The reference's heartbeat normalizer takes the payload whole,
        # and every key but the port's two latency percentiles is one
        # the JAX engine publishes too.
        wire = normalize_serve_telemetry(json.loads(json.dumps(s)))
        assert wire["prompt_hist"] == {"16": 1.0, "32": 1.0}
        assert wire["weight_version"] == 0.0
        jm = jax_model("llama-tiny", n_layers=2)
        from tony_tpu.serve import ServeEngine as JServeEngine
        jparams = jax.tree.map(np.asarray, jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))["params"])
        jkeys = set(JServeEngine(jm, jparams, ctx_max=64, block_size=8,
                                 q_block=16).stats())
        assert set(s) - jkeys == {"ttft_p50_ms", "step_p50_ms"}
        report = profiler.serve_report()
        assert report["serve_t"]["ctx_pad"] == eng.ctx_pad
        assert report["serve_t_stats"]["completed"] == 2.0
        path = tmp_path / "stats.json"
        eng.write_stats(str(path), extra={"rpc_port": 1234})
        read = json.loads(path.read_text())
        assert read["rpc_port"] == 1234 and read["completed"] == 2.0

    def test_swap_params_bitwise_and_zero_rebuild(self):
        eng = _engine()
        prompt = list(range(5))
        pre = _run_one(eng, "pre", prompt)
        fns = dict(eng._fns)
        ptrs = {n: p.data_ptr() for n, p in eng.model.named_parameters()}
        other = get_model("llama-tiny", device="cpu", dtype=torch.float32,
                          seed=7)
        eng.swap_params({n: p.detach() for n, p in
                         other.named_parameters()}, version=3, step=20)
        assert eng.weight_version == 3 and eng.weight_step == 20
        assert eng.weight_swaps == 1
        post = _run_one(eng, "post", prompt)
        # Same geometry, same step functions: the swap built nothing,
        # and every parameter kept its address.
        assert dict(eng._fns) == fns
        assert {n: p.data_ptr() for n, p in
                eng.model.named_parameters()} == ptrs
        ref = _run_one(_engine(seed=7), "r", prompt)
        assert post.tokens == ref.tokens
        assert all(np.array_equal(a, b)
                   for a, b in zip(post.logits, ref.logits))
        assert pre.tokens != post.tokens or not all(
            np.array_equal(a, b) for a, b in zip(pre.logits, post.logits))

    @pytest.mark.parametrize("drift", ["names", "dtype", "shape"])
    def test_swap_geometry_mismatch_rolls_back(self, drift):
        eng = _engine()
        before = {n: p.detach().clone()
                  for n, p in eng.model.named_parameters()}
        new = {n: torch.full_like(p, 0.5)
               for n, p in eng.model.named_parameters()}
        last = list(new)[-1]
        if drift == "names":
            new = {"w": torch.zeros(2)}
        elif drift == "dtype":
            new[last] = new[last].double()
        else:
            new[last] = new[last][:-1]
        with pytest.raises(SwapError, match="old weights kept"):
            eng.swap_params(new, version=9, step=9)
        assert eng.weight_version == 0 and eng.weight_swaps == 0
        for n, p in eng.model.named_parameters():
            assert torch.equal(p, before[n]), n

    def test_wire_is_plain_json(self):
        eng = _engine()
        c = _run_one(eng, np.int64(3), PROMPTS[0])
        c.tokens = [np.int64(t) for t in c.tokens]
        c.latency_s = np.float64(c.latency_s)
        wire = json.loads(json.dumps({**c.wire(), "rid": 3}))
        assert wire["tokens"] == [int(t) for t in c.tokens]
        assert all(type(t) is int for t in c.wire()["tokens"])
        assert type(c.wire()["latency_ms"]) is float

    def test_windowed_stats(self):
        """``stats(t0, t1)`` reads what finished between ``t0`` and ``t1``;
        the lifetime counters stay lifetime."""
        eng = _engine()
        _run_one(eng, "a", PROMPTS[0])
        t0 = time.monotonic()
        _run_one(eng, "b", PROMPTS[1], n=3)
        _run_one(eng, "c", PROMPTS[2], n=2)
        t1 = time.monotonic()
        s = eng.stats(t0, t1)
        assert s["qps"] == pytest.approx(2 / (t1 - t0))
        assert s["tokens_per_s"] == pytest.approx(5 / (t1 - t0))
        assert s["ttft_p50_ms"] > 0 and s["step_p50_ms"] > 0
        assert s["completed"] == 3.0
        idle = eng.stats(t1 + 1.0, t1 + 2.0)
        assert idle["qps"] == idle["tokens_per_s"] == 0.0
        assert idle["ttft_p50_ms"] == idle["step_p50_ms"] == 0.0
        assert eng.stats()["qps"] > 0

    def test_write_stats_from_two_threads(self, tmp_path):
        """The replica's publisher thread and a hot swap's republish
        write the stats file at once: no write raises, every read finds a
        whole payload, and no temp file is left behind."""
        eng = _engine()
        _run_one(eng, "a", PROMPTS[0])
        path = tmp_path / "stats.json"
        eng.write_stats(str(path), extra={"rpc_port": 0})
        errors, ports = [], set()
        start = threading.Barrier(2)

        def writer(port):
            start.wait()
            try:
                for _ in range(200):
                    eng.write_stats(str(path), extra={"rpc_port": port})
            except Exception as exc:   # noqa: BLE001 — reported below
                errors.append(exc)

        threads = [threading.Thread(target=writer, args=(p,))
                   for p in (1, 2)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            payload = json.loads(path.read_text())
            assert payload["completed"] == 1.0
            ports.add(payload["rpc_port"])
        for t in threads:
            t.join()
        assert errors == []
        assert json.loads(path.read_text())["rpc_port"] in (1, 2)
        assert ports <= {0, 1, 2}
        assert [p.name for p in tmp_path.iterdir()] == ["stats.json"]


# ---------------------------------------------------------------------------
# The reference's TestHotSwap pins on a two-step port checkpoint
# ---------------------------------------------------------------------------

class TestHotSwap:
    def test_startup_follows_pointer_not_latest(self, port_ckpt):
        rec = publish.publish_step(port_ckpt, 1)
        replica = _replica(port_ckpt)
        assert replica.restored_step == 1
        assert replica.engine.weight_step == 1
        assert replica.engine.weight_version == rec["version"]

    def test_hot_swap_bitwise_vs_fresh_replica_zero_drops(self, port_ckpt):
        v1 = publish.publish_step(port_ckpt, 1)["version"]
        replica = _replica(port_ckpt)
        ref1 = {i: replica.generate(p, 4).tokens
                for i, p in enumerate(PROMPTS)}
        v2 = publish.publish_step(port_ckpt, 2, note="eval passed")["version"]
        streams, errors = [], []

        def traffic(pi):
            try:
                for _ in range(5):
                    c = replica.generate(PROMPTS[pi], 4)
                    streams.append((pi, list(c.tokens)))
            except Exception as e:   # noqa: BLE001 — any drop fails the pin
                errors.append(e)

        threads = [threading.Thread(target=traffic, args=(pi,))
                   for pi in range(len(PROMPTS))]
        for t in threads:
            t.start()
        out = replica.hot_swap()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, f"swap dropped traffic: {errors[0]!r}"
        assert out["ok"] and out["from_version"] == v1
        assert out["to_version"] == v2 and out["step"] == 2
        assert out["restore_s"] >= 0 and out["flip_ms"] >= 0
        assert replica.engine.weight_version == v2
        assert replica.engine.weight_step == 2
        assert replica.restored_step == 2
        assert replica.engine.stats()["weight_swaps"] == 1.0
        fresh = _replica(port_ckpt)
        assert fresh.restored_step == 2
        ref2 = {i: fresh.generate(p, 4).tokens
                for i, p in enumerate(PROMPTS)}
        assert ref2 != ref1          # the two steps really differ
        for i, p in enumerate(PROMPTS):
            assert replica.generate(p, 4).tokens == ref2[i]
        for (n, a), (_, b) in zip(replica.model.named_parameters(),
                                  fresh.model.named_parameters()):
            assert torch.equal(a.view(torch.int16) if a.dtype ==
                               torch.bfloat16 else a, b.view(torch.int16)
                               if b.dtype == torch.bfloat16 else b), n
        # Zero drops and no mixed-version stream.
        assert len(streams) == 5 * len(PROMPTS)
        for pi, toks in streams:
            assert len(toks) == 4 and toks in (ref1[pi], ref2[pi]), (
                pi, toks)

    def test_prefix_lanes_digest_and_swap_flush(self, port_ckpt, tmp_path):
        """A replica with the prefix cache and chunked prefill armed: its
        stats file, read by the JAX executor's reader, carries the
        prefix digest the JAX router scores; after a hot swap the
        prompt served before it gets zero hit blocks, and its tokens
        equal a fresh replica's on the new step."""
        from tony_tpu.executor import read_serve_stats
        from tony_tpu.serve import prefix as jprefix

        publish.publish_step(port_ckpt, 1)
        replica = _replica(port_ckpt, prefix_cache=True, prefill_chunk=16)
        prompt = PROMPTS[2] + PROMPTS[1]
        first = replica.generate(prompt, 4)
        assert replica.generate(prompt, 4).tokens == first.tokens
        engine = replica.engine
        assert engine.prefix_hit_blocks > 0 and engine.prefill_chunks > 0
        path = tmp_path / "stats.json"
        engine.write_stats(str(path), extra={"rpc_port": 1})
        read = read_serve_stats(path)
        keys = jprefix.chain_keys(prompt, engine.block_size)
        assert set(keys) <= set(read["prefix_digest"])
        router = RequestRouter(block_size=engine.block_size)
        router.upsert_replica("warm", address="127.0.0.1:1", stats=read)
        router.upsert_replica("cold", address="127.0.0.1:2",
                              stats={"queue_depth": 0.0})
        assert router.route(prompt) == "warm"
        publish.publish_step(port_ckpt, 2)
        replica.hot_swap()
        assert engine.prefix_digest() == []
        hits = engine.prefix_hit_blocks
        after = replica.generate(prompt, 4).tokens
        assert engine.prefix_hit_blocks == hits
        assert after == _replica(port_ckpt).generate(prompt, 4).tokens

    @pytest.mark.parametrize("site", ["swap_before_restore",
                                      "swap_after_restore",
                                      "swap_before_flip",
                                      "swap_after_flip"])
    def test_chaos_sweep_exactly_one_weight_version(self, site, port_ckpt,
                                                    monkeypatch):
        v1 = publish.publish_step(port_ckpt, 1)["version"]
        replica = _replica(port_ckpt)
        t1 = {i: replica.generate(p, 3).tokens
              for i, p in enumerate(PROMPTS[:2])}
        v2 = publish.publish_step(port_ckpt, 2)["version"]

        def hook(where):
            raise _Crashed(where)

        monkeypatch.setattr(chaos, "CRASH_HOOK", hook)
        monkeypatch.setenv(chaos.ENV_CRASH, site)
        with pytest.raises(_Crashed):
            replica.hot_swap()
        monkeypatch.delenv(chaos.ENV_CRASH)
        # Never left wedged mid-quiesce...
        assert replica.engine.swapping is False
        got = {i: replica.generate(p, 3).tokens
               for i, p in enumerate(PROMPTS[:2])}
        if site == "swap_after_flip":
            # Crash after the flip: the new version committed whole.
            assert replica.engine.weight_version == v2
            fresh = _replica(port_ckpt)
            assert got == {i: fresh.generate(p, 3).tokens
                           for i, p in enumerate(PROMPTS[:2])}
        else:
            # Crash anywhere before: the old version, bitwise.
            assert replica.engine.weight_version == v1
            assert replica.engine.weight_step == 1
            assert got == t1

    def test_swap_rpc_verb_and_stale_version_pin(self, port_ckpt,
                                                  monkeypatch):
        publish.publish_step(port_ckpt, 1)
        replica = _replica(port_ckpt)
        handler = replica.rpc_handler()
        rec = publish.publish_step(port_ckpt, 2)
        out = handler.rpc_swap(version=rec["version"])
        assert out["ok"] and out["to_version"] == rec["version"]
        # A stale version pin (the pointer moved past what the AM saw) is
        # a typed refusal with the current weights kept.
        publish.publish_step(port_ckpt, 1)
        with pytest.raises(SwapError):
            handler.rpc_swap(version=rec["version"])
        assert replica.engine.weight_version == rec["version"]
        # An uncommitted step and a failed restore roll back alike.
        with pytest.raises(SwapError, match="no committed manifest"):
            handler.rpc_swap(step=7)
        before = replica.generate(PROMPTS[0], 3).tokens

        def unreadable(*args, **kwargs):
            raise OSError("disk gone")

        monkeypatch.setattr(ckpt, "restore_pytree", unreadable)
        with pytest.raises(SwapError, match="restore of step 2 failed: "
                                            "OSError: disk gone"):
            handler.rpc_swap(step=2)
        assert replica.engine.weight_swaps == 1
        assert replica.engine.weight_version == rec["version"]
        assert replica.generate(PROMPTS[0], 3).tokens == before


# ---------------------------------------------------------------------------
# The RPC wire, both directions, through the reference's TCP proxy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(port_ckpt):
    publish.publish_step(port_ckpt, 2)
    return _replica(port_ckpt)


class TestWire:
    def test_jax_client_to_port_server(self, served):
        server = RpcServer(served.rpc_handler(), host="127.0.0.1").start()
        try:
            with ProxyServer("127.0.0.1", server.port) as proxy:
                with JRpcClient(f"{proxy.local_host}:{proxy.local_port}",
                                timeout=60.0) as client:
                    out = client.call("generate", tokens=PROMPTS[0],
                                      max_new_tokens=5)
                    stats = client.call("serve_stats")
                    with pytest.raises(JRpcError, match="^SwapError"):
                        client.call("swap", step=7)
                    # A tenant tag crosses the wire to the engine.
                    tagged = client.call("generate", tokens=PROMPTS[0],
                                         max_new_tokens=2, tenant="gold")
        finally:
            server.stop()
        assert out["tokens"] == served.generate(PROMPTS[0], 5).tokens
        assert tagged["tokens"] == out["tokens"][:2]
        assert stats["completed"] >= 1.0 and stats["weight_step"] == 2.0

    def test_port_client_to_jax_server(self, served):
        server = JRpcServer(served.rpc_handler(), host="127.0.0.1").start()
        try:
            with ProxyServer("127.0.0.1", server.port) as proxy:
                with RpcClient(f"{proxy.local_host}:{proxy.local_port}",
                               timeout=60.0) as client:
                    out = client.call("generate", tokens=PROMPTS[1],
                                      max_new_tokens=4)
                    with pytest.raises(RpcError, match="^SwapError"):
                        client.call("swap", step=7)
                    with pytest.raises(RpcError, match="unknown RPC"):
                        client.call("no_such_verb")
        finally:
            server.stop()
        assert out["tokens"] == served.generate(PROMPTS[1], 4).tokens


# ---------------------------------------------------------------------------
# The heartbeat: the JAX executor, session and router over the port replica
# ---------------------------------------------------------------------------

class TestHeartbeat:
    def test_executor_session_router_route_to_the_port_replica(
            self, served, tmp_path):
        conf = JTonyConfig({"tony.serve.instances": "1",
                            "tony.serve.command": "x"})
        session = TonySession(conf, app_id="app_port_replica_hb")
        session.on_registered("serve", 0, "127.0.0.1", 4000)
        am = JRpcServer(ApplicationRpcHandler(session),
                        host="127.0.0.1").start()
        conf_path = tmp_path / "conf.json"
        conf_path.write_text(json.dumps(dict(conf.items())))
        executor = TaskExecutor(env={
            jconstants.ENV_JOB_NAME: "serve",
            jconstants.ENV_TASK_INDEX: "0",
            jconstants.ENV_AM_ADDRESS: am.address,
            jconstants.ENV_CONF_PATH: str(conf_path),
            jconstants.ENV_LOG_DIR: str(tmp_path),
        })
        stop = threading.Event()
        serving = threading.Thread(
            target=served.serve_forever, daemon=True,
            kwargs=dict(host="127.0.0.1",
                        stats_path=str(executor.serve_stats_path()),
                        stats_every_s=0.05, stop=stop))
        serving.start()
        beat = threading.Thread(target=executor._heartbeat_loop,
                                args=(0.05,), daemon=True)
        beat.start()
        try:
            task = session.task("serve", 0)
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline and \
                    not task.serve_metrics.get("rpc_port"):
                time.sleep(0.05)
            got = task.serve_metrics
            assert got["rpc_port"] == float(served.port)
            assert got["weight_step"] == 2.0 and got["swapping"] == 0.0
            assert got["role"] == "colocated"
            eps = session.serve_endpoints("serve")
            assert len(eps) == 1
            router = RequestRouter(block_size=8)
            router.refresh_from_task_infos(eps)
            assert router.replicas()[0].address == \
                f"127.0.0.1:{served.port}"
            out = router.dispatch(PROMPTS[2], 4)
            assert out["replica"] == "serve:0"
            assert out["tokens"] == served.generate(PROMPTS[2], 4).tokens
        finally:
            executor._hb_stop.set()
            beat.join(timeout=5)
            stop.set()
            serving.join(timeout=10)
            am.stop()
        assert not serving.is_alive() and not beat.is_alive()


# ---------------------------------------------------------------------------
# The launch: python -m tony_tpu_torch.serve.replica under the executor's env
# ---------------------------------------------------------------------------

def _conf_file(tmp_path, ckpt_dir, **extra):
    conf = {SERVE_MODEL: "llama-tiny",
            SERVE_MODEL_KWARGS: json.dumps({"n_layers": 2, "device": "cpu",
                                            "dtype": "float32"}),
            SERVE_CKPT_DIR: str(ckpt_dir), "tony.serve.ctx-max": "64",
            "tony.serve.block-size": "8", "tony.serve.max-running": "4",
            **extra}
    path = tmp_path / "tony-final.json"
    path.write_text(json.dumps(conf))
    return path


class TestLaunch:
    def test_python_m_replica_answers_generate(self, port_ckpt, tmp_path):
        publish.publish_step(port_ckpt, 2)
        stats = tmp_path / "serve-stats.json"
        env = {**os.environ, "PYTHONPATH": str(ROOT),
               constants.ENV_CONF_PATH: str(_conf_file(tmp_path,
                                                       port_ckpt)),
               constants.ENV_SERVE_STATS: str(stats),
               constants.ENV_JOB_NAME: "serve"}
        proc = subprocess.Popen(
            [sys.executable, "-m", "tony_tpu_torch.serve.replica"],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.monotonic() + 120.0
            payload = None
            while time.monotonic() < deadline and proc.poll() is None:
                if stats.exists():
                    payload = json.loads(stats.read_text())
                    break
                time.sleep(0.1)
            assert payload is not None, proc.poll()
            assert payload["weight_step"] == 2.0
            with RpcClient(f"127.0.0.1:{int(payload['rpc_port'])}",
                           timeout=60.0) as client:
                out = client.call("generate", tokens=PROMPTS[0],
                                  max_new_tokens=4)
            ref = _replica(port_ckpt, dtype_policy="bf16",
                           model_kwargs={"dtype": torch.float32})
            assert out["tokens"] == ref.generate(PROMPTS[0], 4).tokens
        finally:
            proc.terminate()
            log, _ = proc.communicate(timeout=30)
        assert "listening on" in log

    def test_tony_submit_serve_job(self, port_ckpt, tmp_path):
        """The documented serve job: ``tony submit`` with conf overrides
        (the JAX CLI unedited) launches the port's replica in a MiniPod
        container; its stats file carries the RPC port, a generate over
        the wire answers, and ``tony kill`` ends the job."""
        from tony_tpu.cli import build_conf, make_parser
        from tony_tpu.cli import main as cli_main
        from tony_tpu.client import TonyClient

        publish.publish_step(port_ckpt, 2)
        kwargs = json.dumps({"n_layers": 2, "device": "cpu"})
        args = make_parser().parse_args([
            "submit", "--framework", "standalone",
            "--conf", "tony.application.fail-fast=false",
            "--conf", "tony.serve.instances=1",
            "--conf", "tony.serve.command=python -m "
                      "tony_tpu_torch.serve.replica",
            "--conf", "tony.serve.model=llama-tiny",
            "--conf", f"tony.serve.model-kwargs={kwargs}",
            "--conf", f"tony.serve.ckpt-dir={port_ckpt}",
            "--conf", "tony.serve.ctx-max=64",
            "--conf", "tony.serve.block-size=8",
            "--conf", "tony.task.heartbeat-interval-ms=200"])
        workdir = tmp_path / "jobs"
        client = TonyClient(build_conf(args), workdir=workdir, quiet=True)
        client.submit()
        try:
            deadline = time.monotonic() + 120.0
            payload = None
            while time.monotonic() < deadline and payload is None:
                for path in client.job_dir.rglob("serve-stats.json"):
                    payload = json.loads(path.read_text())
                time.sleep(0.1)
            assert payload is not None, "the replica never published"
            assert payload["weight_step"] == 2.0
            with RpcClient(f"127.0.0.1:{int(payload['rpc_port'])}",
                           timeout=60.0) as rpc_client:
                out = rpc_client.call("generate", tokens=PROMPTS[1],
                                      max_new_tokens=3)
            ref = _replica(port_ckpt)
            assert out["tokens"] == ref.generate(PROMPTS[1], 3).tokens
            assert cli_main(["kill", client.app_id, "--workdir",
                             str(workdir)]) == 0
            assert client.monitor(timeout=60) == 1
            assert client.final_status == "KILLED"
        finally:
            if client.am_proc is not None and client.am_proc.poll() is None:
                client.am_proc.kill()

    def test_main_needs_the_conf(self, tmp_path, capsys):
        assert replica_mod.main() == 1
        path = tmp_path / "c.json"
        path.write_text(json.dumps({SERVE_MODEL: "llama-tiny"}))
        os.environ[constants.ENV_CONF_PATH] = str(path)
        try:
            assert replica_mod.main() == 1
        finally:
            del os.environ[constants.ENV_CONF_PATH]
        assert SERVE_CKPT_DIR in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Absent devices and lanes not ported
# ---------------------------------------------------------------------------

UNPORTED = [(SERVE_MESH, '{"fsdp": 2}', 8)]


# The lanes ported from the refused list, each armed through main().
# "{tmp}" is the test's own directory.
PORTED = [
    {SERVE_SPEC_K: "4"},
    {SERVE_SPEC_K: "3", SERVE_DRAFT_MODEL: "llama-tiny",
     SERVE_DRAFT_MODEL_KWARGS: json.dumps({"n_layers": 2, "device": "cpu",
                                           "dtype": "float32"})},
    {SERVE_PREFIX_CACHE: "true"},
    {SERVE_PREFILL_CHUNK: "16", SERVE_PREFIX_CACHE: "true"},
    {SERVE_AOT_CACHE: "{tmp}/aot"}, {SERVE_WARM_STANDBY: "1"},
    {serve_warm_standby_key("serve"): "2"},
    {serve_role_key("serve"): "decode"},
    {SERVE_HOST_BLOCKS: "8"},
    {SERVE_HOST_BLOCKS: "16", SERVE_PREFIX_CACHE: "true",
     SERVE_DEMOTE_WATERMARK: "0.5", SERVE_DEMOTE_BATCH: "4"},
    {SERVE_PREFIX_STORE: "{tmp}/stems", SERVE_PREFIX_CACHE: "true"},
    {SERVE_QOS_TENANTS: "gold:3,silver:1"}]


class TestUnported:
    def test_device_absent_without_a_gpu_raises(self, port_ckpt,
                                                monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            Replica(model_name="llama-tiny", model_kwargs={"n_layers": 2},
                    ckpt_dir=port_ckpt)

    @pytest.mark.parametrize("key,value,item", UNPORTED,
                             ids=[k for k, _, _ in UNPORTED])
    def test_unported_conf_lane_raises_naming_its_item(
            self, key, value, item, tmp_path, monkeypatch):
        monkeypatch.setenv(constants.ENV_CONF_PATH,
                           str(_conf_file(tmp_path, tmp_path, **{key: value})))
        with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
            replica_mod.main()

    @pytest.mark.parametrize("lanes", PORTED,
                             ids=["-".join(k.split(".")[-1] for k in lanes)
                                  for lanes in PORTED])
    def test_ported_conf_lane_serves(self, lanes, port_ckpt, tmp_path,
                                     monkeypatch):
        """A lane this port serves: ``main()`` builds the replica with
        it armed, and the replica's tokens equal a plain replica's. The
        cold-start lanes warm the step family at startup; a warm pool
        makes task 0 of a jobtype with no configured instances a
        standby."""
        publish.publish_step(port_ckpt, 2)
        lanes = {k: v.replace("{tmp}", str(tmp_path))
                 for k, v in lanes.items()}
        monkeypatch.setenv(constants.ENV_CONF_PATH, str(_conf_file(
            tmp_path, port_ckpt, **lanes)))
        built = []
        monkeypatch.setattr(Replica, "serve_forever",
                            lambda self, **kw: built.append(self))
        assert replica_mod.main() == 0
        (rep,) = built
        engine = rep.engine
        if SERVE_SPEC_K in lanes:
            assert isinstance(engine, SpecEngine)
            assert engine.spec_k == int(lanes[SERVE_SPEC_K])
            kind = "model" if SERVE_DRAFT_MODEL in lanes else "ngram"
            assert engine.draft.kind == kind
        assert engine.prefix_cache == (SERVE_PREFIX_CACHE in lanes)
        assert engine.role == rep.role == lanes.get(
            serve_role_key("serve"), "colocated")
        assert engine.prefill_chunk == (
            int(lanes[SERVE_PREFILL_CHUNK])
            if SERVE_PREFILL_CHUNK in lanes else None)
        standby = bool({SERVE_WARM_STANDBY,
                        serve_warm_standby_key("serve")} & set(lanes))
        armed = SERVE_AOT_CACHE in lanes
        assert engine.warm_standby is standby
        assert (engine.aot_cache is not None) is armed
        if armed:
            assert engine.aot_cache.root == tmp_path / "aot"
            # One entry, the engine's library set: put by the first
            # program warmed, hit by the others.
            assert engine.aot_misses == 1 and rep.warmed > 1
            assert engine.aot_hits == rep.warmed - 1
        assert rep.warmed == (len(engine.decode_buckets)
                              if standby or armed else 0)
        assert engine.cache.host_blocks == int(lanes.get(SERVE_HOST_BLOCKS,
                                                         0))
        assert (engine.cache._offload is not None) == \
            (SERVE_HOST_BLOCKS in lanes)
        assert engine.demote_watermark == float(
            lanes.get(SERVE_DEMOTE_WATERMARK, 0.0))
        assert engine.demote_batch == int(
            lanes.get(SERVE_DEMOTE_BATCH, 0) or engine.nb_max)
        assert (rep._store is not None) == (SERVE_PREFIX_STORE in lanes)
        if SERVE_QOS_TENANTS in lanes:
            assert engine.qos.classes == {"gold": 3.0, "silver": 1.0}
        else:
            assert engine.qos is None
        plain = _replica(port_ckpt, dtype_policy="bf16",
                         model_kwargs={"dtype": torch.float32})
        # Tagged requests: a host tier parks each turn, a QoS engine
        # meters the tenant; neither changes a token.
        tags = {"conv": "c" if SERVE_HOST_BLOCKS in lanes else None,
                "tenant": "gold" if SERVE_QOS_TENANTS in lanes else None}
        for prompt in PROMPTS:
            assert rep.generate(prompt, 5, **tags).tokens == \
                plain.generate(prompt, 5).tokens
        if SERVE_HOST_BLOCKS in lanes:
            assert engine.parked_digest() == ["c"]
        if SERVE_QOS_TENANTS in lanes:
            assert engine.stats()["tenants"]["gold"]["completed"] == \
                len(PROMPTS)

    def test_promote_verb(self, served, port_ckpt):
        """``promote`` left the unported verbs: on an active replica it
        is a no-op that returns False; a standby flips once, over the
        JAX client too."""
        assert served.rpc_handler().rpc_promote() is False
        standby = _replica(port_ckpt, warm_standby=True)
        server = RpcServer(standby.rpc_handler(), host="127.0.0.1").start()
        try:
            with JRpcClient(f"127.0.0.1:{server.port}",
                            timeout=60.0) as client:
                assert client.call("serve_stats")["warm_standby"] == 1.0
                assert client.call("promote") is True
                assert client.call("promote") is False
                assert client.call("serve_stats")["warm_standby"] == 0.0
        finally:
            server.stop()

    def test_standby_needs_a_pool_and_an_index_past_the_instances(
            self, port_ckpt, tmp_path, monkeypatch):
        """The position rule of ``main()``: a pool configured and the
        task index at or past the jobtype's instance count."""
        publish.publish_step(port_ckpt, 2)
        built = []
        monkeypatch.setattr(Replica, "serve_forever",
                            lambda self, **kw: built.append(self))
        for index, conf, standby in (
                ("0", {SERVE_WARM_STANDBY: "1",
                       "tony.serve.instances": "1"}, False),
                ("1", {SERVE_WARM_STANDBY: "1",
                       "tony.serve.instances": "1"}, True),
                ("3", {"tony.serve.instances": "1"}, False),
                ("1", {SERVE_WARM_STANDBY: "2",
                       serve_warm_standby_key("serve"): "0",
                       "tony.serve.instances": "1"}, False)):
            monkeypatch.setenv(constants.ENV_TASK_INDEX, index)
            monkeypatch.setenv(constants.ENV_CONF_PATH, str(_conf_file(
                tmp_path, port_ckpt, **conf)))
            assert replica_mod.main() == 0
            assert built[-1].engine.warm_standby is standby, (index, conf)

    def test_idle_conf_values_are_not_lanes(self, tmp_path, monkeypatch):
        """The values the JAX CLI writes for lanes that are off arm
        nothing: main() gets past the check to the (missing) step."""
        monkeypatch.setenv(constants.ENV_CONF_PATH, str(_conf_file(
            tmp_path, tmp_path, **{SERVE_SPEC_K: "0",
                                   SERVE_PREFIX_CACHE: "false",
                                   SERVE_PREFILL_CHUNK: "0",
                                   serve_role_key("serve"): "colocated",
                                   SERVE_WARM_STANDBY: "0",
                                   SERVE_QOS_TENANTS: ""})))
        with pytest.raises(FileNotFoundError):
            replica_mod.main()

    def test_unported_verbs_and_request_tags(self, served):
        """The handoff verbs answer (tests/test_torch_disagg.py drives
        them end to end), and the request tags, once refused, are
        served: ``conv`` on a replica without a host tier is ignored,
        and a ``tenant`` through the RPC verb is metered under its name,
        the tokens the untagged request's."""
        handler = served.rpc_handler()
        assert handler.rpc_kv_offer(keys=["0" * 16]) == 0
        with pytest.raises(ValueError, match="decode target"):
            handler.rpc_prefill_handoff(PROMPTS[0], 2)
        from tony_tpu_torch.serve import HandoffError
        with pytest.raises(HandoffError, match="malformed"):
            handler.rpc_kv_import({"rid": "x"})
        want = served.generate(PROMPTS[0], 2).tokens
        assert served.generate(PROMPTS[0], 2, conv="c-1").tokens == want
        assert served.engine.parked_digest() == []
        before = served.engine.stats()["tenants"].get(
            "gold", {}).get("completed", 0.0)
        out = handler.rpc_generate(PROMPTS[0], 2, tenant="gold")
        assert out["tokens"] == want
        assert served.engine.stats()["tenants"]["gold"]["completed"] == \
            before + 1
