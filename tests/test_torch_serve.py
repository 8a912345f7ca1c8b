"""Port parity for the serving core (tony_tpu_torch.serve): the paged KV
cache's invariants (mirroring tests/test_serve.py::TestKVCache), the
port's engine against the JAX package's engine on the same ragged
request mix and weights (f32: equal greedy tokens, logits within 1e-4),
and the port's decode rows against its own full prefill (equal tokens,
logits within 1e-5), with the static join policy and pool back-pressure
included."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from tony_tpu.models import get_model as jax_model
from tony_tpu.serve import Request as JRequest
from tony_tpu.serve import ServeEngine as JServeEngine
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params
from tony_tpu_torch.ops import LAUNCHES
from tony_tpu_torch.serve import (AdmissionError, EngineFront, PagedKVCache,
                                  Request, ServeEngine)

ENGINE_KW = dict(ctx_max=64, block_size=8, q_block=16, decode_buckets=(2, 4),
                 max_running=4, keep_logits=True)


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny decoder (f32) and the port's, on the same weights."""
    jm = jax_model("llama-tiny", n_layers=2, dtype=jnp.float32)
    params = nn.unbox(jm.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 16), jnp.int32)))["params"]
    tm = get_model("llama-tiny", n_layers=2, dtype=torch.float32,
                   device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return (jm, params), tm


def make_engine(tm, **kw):
    return ServeEngine(tm, **{"device": "cpu", **ENGINE_KW, **kw})


def pin_vs_full_prefill(eng, completions, atol=1e-5):
    """Every request's streamed decode logits against rows of a
    sequential full prefill of its final token sequence: within
    ``atol``, and the greedy token is the reference row's argmax."""
    for c in completions:
        full = list(c.prompt) + list(c.tokens)
        ref = eng.full_prefill_logits(full)
        p = len(c.prompt)
        assert len(c.logits) == len(c.tokens)
        for j, row in enumerate(c.logits):
            np.testing.assert_allclose(row, ref[p - 1 + j], atol=atol,
                                       rtol=0)
            assert c.tokens[j] == int(np.argmax(ref[p - 1 + j]))


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, 256, n)) for n in lengths]


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------

class TestKVCache:
    def _cache(self, n_blocks=8, block_size=4):
        return PagedKVCache(2, 8, n_blocks=n_blocks, block_size=block_size,
                            device="cpu")

    def test_alloc_free_reuse_invariants(self):
        c = self._cache()
        t_a = c.reserve("a", 9)      # 3 blocks of 4
        t_b = c.reserve("b", 4)      # 1 block
        assert len(t_a) == 3 and len(t_b) == 1
        assert not set(t_a) & set(t_b), "tables must be disjoint"
        assert c.free_blocks == 4
        assert sorted(c.owned_blocks()) == ["a", "b"]
        t_a2 = c.reserve("a", 13)    # growth extends the same table
        assert t_a2[:3] == t_a and len(t_a2) == 4
        assert c.free_seq("a") == 4
        assert c.free_blocks == 7
        t_c = c.reserve("c", 28)     # 7 blocks — only fits if a's returned
        assert len(t_c) == 7
        assert set(t_c) | set(t_b) == set(range(8))
        assert c.free_seq("a") == 0  # idempotent eviction

    def test_lifo_reuse(self):
        c = self._cache()
        t_a = c.reserve("a", 8)
        c.free_seq("a")
        assert c.reserve("b", 8) == t_a

    def test_exhaustion_is_typed_admission_error_not_oom(self):
        c = self._cache(n_blocks=4, block_size=4)
        c.reserve("a", 12)           # 3 of 4 blocks
        free_before = c.free_blocks
        with pytest.raises(AdmissionError) as exc:
            c.reserve("b", 8)        # needs 2, only 1 free
        assert exc.value.needed_blocks == 2
        assert exc.value.free_blocks == 1
        assert exc.value.retryable
        assert c.free_blocks == free_before
        assert "b" not in c.owned_blocks() or not c.owned_blocks()["b"]

    def test_flat_and_write_index_and_oob(self):
        c = self._cache()
        table = c.reserve("s", 10)
        assert c.flat_index("s", 0) == table[0] * 4
        assert c.flat_index("s", 5) == table[1] * 4 + 1
        assert c.write_index("s", 5) == c.flat_index("s", 5)
        with pytest.raises(IndexError):
            c.flat_index("s", 12)    # beyond the 3-block reservation
        with pytest.raises(IndexError):
            c.write_index("s", 12)
        assert c.oob_index == 8 * 4

    def test_table_array_padding_and_overflow(self):
        c = self._cache()
        c.reserve("s", 10)
        arr = c.table_array(["s", "missing"], nb_max=4)
        assert arr.shape == (2, 4) and arr.dtype == np.int32
        assert list(arr[0, :3]) == c.table("s") and arr[0, 3] == 0
        assert (arr[1] == 0).all()
        with pytest.raises(ValueError):
            c.table_array(["s"], nb_max=2)

    def test_pools_are_torch_tensors(self):
        c = PagedKVCache(3, 16, n_blocks=5, block_size=4, device="cpu",
                         dtype=torch.float32)
        assert isinstance(c.k, torch.Tensor) and c.k.shape == (3, 5, 4, 16)
        assert c.v.dtype == torch.float32 and c.k.device.type == "cpu"
        with pytest.raises(ValueError):
            PagedKVCache(2, 8, n_blocks=0, block_size=4, device="cpu")


# ---------------------------------------------------------------------------
# Engine vs the JAX engine
# ---------------------------------------------------------------------------

class TestEngineVsJax:
    @pytest.mark.parametrize("policy", ["continuous", "static"])
    def test_ragged_mix_matches_jax(self, pair, policy):
        """Ragged prompt lengths across the KV block boundary
        (block_size=8: 7/8/9) and the q-block boundary (15/17), more
        requests than max_running."""
        (jm, params), tm = pair
        prompts = _prompts(0, [7, 8, 9, 15, 17])
        jeng = JServeEngine(jm, params, join_policy=policy, **ENGINE_KW)
        teng = make_engine(tm, join_policy=policy)
        for i, p in enumerate(prompts):
            jeng.submit(JRequest(rid=i, tokens=p, max_new_tokens=4))
            teng.submit(Request(rid=i, tokens=p, max_new_tokens=4))
        jdone = {c.rid: c for c in jeng.run()}
        tdone = {c.rid: c for c in teng.run()}
        assert sorted(tdone) == sorted(jdone) == list(range(5))
        for rid, jc in jdone.items():
            tc = tdone[rid]
            assert tc.tokens == jc.tokens
            assert len(tc.logits) == len(jc.logits) == 4
            for a, b in zip(tc.logits, jc.logits):
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
        assert teng.forwards == jeng.forwards
        assert teng.cache.free_blocks == teng.cache.n_blocks

    def test_full_prefill_matches_jax(self, pair):
        (jm, params), tm = pair
        toks = _prompts(1, [23])[0]
        jeng = JServeEngine(jm, params, **ENGINE_KW)
        teng = make_engine(tm)
        np.testing.assert_allclose(teng.full_prefill_logits(toks),
                                   jeng.full_prefill_logits(toks),
                                   atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# Engine vs its own full prefill
# ---------------------------------------------------------------------------

class TestEngine:
    def test_decode_vs_full_prefill_ragged(self, pair):
        _, tm = pair
        eng = make_engine(tm)
        for i, p in enumerate(_prompts(2, [7, 8, 9, 15, 17])):
            eng.submit(Request(rid=f"r{i}", tokens=p, max_new_tokens=4))
        done = eng.run()
        assert sorted(c.rid for c in done) == [f"r{i}" for i in range(5)]
        pin_vs_full_prefill(eng, done)
        assert eng.cache.free_blocks == eng.cache.n_blocks

    def test_decode_is_bitwise_on_cpu(self, pair):
        """On the CPU in f32 the port's decode rows come out bit-equal to
        its full prefill (the property PERF.md reports; on the card the
        engine holds a tolerance instead)."""
        _, tm = pair
        eng = make_engine(tm)
        for i, p in enumerate(_prompts(8, [7, 9, 17])):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=3))
        for c in eng.run():
            ref = eng.full_prefill_logits(list(c.prompt) + list(c.tokens))
            p = len(c.prompt)
            for j, row in enumerate(c.logits):
                assert np.array_equal(row, ref[p - 1 + j])

    def test_overlapping_joins(self, pair):
        """Requests arriving MID-decode join the running batch at
        iteration granularity, everyone still matching full prefill."""
        _, tm = pair
        eng = make_engine(tm)
        prompts = _prompts(3, [5, 11, 9, 20])
        eng.submit(Request(rid="r0", tokens=prompts[0], max_new_tokens=6))
        done = eng.step()
        eng.submit(Request(rid="r1", tokens=prompts[1], max_new_tokens=5))
        eng.submit(Request(rid="r2", tokens=prompts[2], max_new_tokens=3))
        done += eng.step()
        eng.submit(Request(rid="r3", tokens=prompts[3], max_new_tokens=4))
        done += eng.run()
        assert sorted(c.rid for c in done) == ["r0", "r1", "r2", "r3"]
        pin_vs_full_prefill(eng, done)

    def test_static_and_continuous_emit_identical_tokens(self, pair):
        _, tm = pair
        prompts = _prompts(4, [4, 13, 8])

        def tokens_of(policy):
            eng = make_engine(tm, join_policy=policy, keep_logits=False)
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, tokens=p, max_new_tokens=5))
            return {c.rid: c.tokens for c in eng.run()}

        assert tokens_of("continuous") == tokens_of("static")

    def test_never_fits_request_rejected_nonretryable(self, pair):
        _, tm = pair
        eng = make_engine(tm)                  # ctx_pad = 64
        with pytest.raises(AdmissionError) as exc:
            eng.submit(Request(rid="big", tokens=list(range(60)),
                               max_new_tokens=10))
        assert not exc.value.retryable
        with pytest.raises(ValueError, match="empty prompt"):
            eng.submit(Request(rid="empty", tokens=[], max_new_tokens=1))
        small = make_engine(tm, n_blocks=4)    # 4 blocks of 8 = 32 slots
        with pytest.raises(AdmissionError) as exc:
            small.submit(Request(rid="poolbig", tokens=list(range(30)),
                                 max_new_tokens=10))
        assert not exc.value.retryable
        assert small.queue_depth == 0

    def test_pool_pressure_queues_then_completes(self, pair):
        """A pool sized for one sequence keeps the second request QUEUED
        (AdmissionError back-pressure inside the join, no error) until
        the first evicts; a small pool also clamps full_prefill's
        scratch table."""
        _, tm = pair
        eng = make_engine(tm, n_blocks=5)
        for i, p in enumerate(_prompts(5, [17, 17])):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=4))
        done = eng.step()
        assert eng.queue_depth == 1 and eng.running == 1
        done += eng.run()
        assert sorted(c.rid for c in done) == [0, 1]
        pin_vs_full_prefill(eng, done)
        assert eng.cache.free_blocks == eng.cache.n_blocks

    def test_single_token_requests_and_context_edge(self, pair):
        """max_new_tokens == 1 evicts at prefill; a request filling the
        context exactly decodes with padding rows past the buffer end."""
        _, tm = pair
        eng = make_engine(tm)
        p_short, p_long = _prompts(6, [3, 58])
        eng.submit(Request(rid="one", tokens=p_short, max_new_tokens=1))
        eng.submit(Request(rid="edge", tokens=p_long, max_new_tokens=6))
        done = {c.rid: c for c in eng.run()}
        assert len(done["one"].tokens) == 1 and len(done["edge"].tokens) == 6
        pin_vs_full_prefill(eng, done.values())

    def test_engine_front_threads(self, pair):
        """Overlapping generate() calls from several threads ride one
        continuous batch and return what a sequential run returns."""
        _, tm = pair
        prompts = _prompts(7, [6, 12, 9, 14, 3, 10])
        seq = make_engine(tm, keep_logits=False)
        for i, p in enumerate(prompts):
            seq.submit(Request(rid=i, tokens=p, max_new_tokens=5))
        want = {c.rid: c.tokens for c in seq.run()}
        front = EngineFront(make_engine(tm, keep_logits=False))
        got = {}

        def worker(i):
            got[i] = front.generate(prompts[i], 5, rid=i).tokens

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert got == want
        c = front.generate(prompts[0], 2)
        assert c.rid.startswith("req-") and c.wire()["tokens"] == c.tokens

    def test_stats(self, pair):
        _, tm = pair
        eng = make_engine(tm, keep_logits=False)
        eng.submit(Request(rid="r", tokens=[1, 2, 3], max_new_tokens=2))
        eng.run()
        stats = eng.stats()
        for key in ("qps", "p50_ms", "p99_ms", "queue_depth",
                    "tokens_per_s", "ttft_p50_ms", "step_p50_ms"):
            assert key in stats
        assert stats["completed"] == 1.0
        assert stats["forwards"] == 2.0 == eng.forwards   # prefill + decode
        assert stats["tokens_per_forward"] == pytest.approx(1.0)
        assert stats["p50_ms"] >= stats["ttft_p50_ms"] > 0

    def test_cpu_path_launches_no_kernel(self, pair):
        _, tm = pair
        before = LAUNCHES["flash_decode"]
        eng = make_engine(tm, keep_logits=False)
        eng.submit(Request(rid="r", tokens=[5, 6], max_new_tokens=2))
        eng.run()
        assert LAUNCHES["flash_decode"] == before

    def test_bad_arguments(self, pair):
        _, tm = pair
        with pytest.raises(ValueError, match="join_policy"):
            make_engine(tm, join_policy="fifo")
        with pytest.raises(ValueError, match="q_block"):
            make_engine(tm, q_block=12)
        with pytest.raises(ValueError, match="model lives on"):
            make_engine(tm, device="meta")
