"""Port parity for the speculative lane (tony_tpu_torch.serve.spec and
the speculative tier of .kvcache): the cache's reserve/commit/rollback
against the reference's cache op for op (tests/test_spec.py's
TestSpecCache); the n-gram draft's proposals equal the reference's; the
port's SpecEngine against the JAX SpecEngine on the same mixes and
weights (f32: equal tokens and spec counters, logits within 1e-4);
inside the port, speculative against plain bitwise at k = 1, 2, 4, 7,
with overlapping joins, with the prefix cache and chunked prefill
armed, in f32 and bf16; the self-draft accepting every proposal, a
draft with other weights accepting some, draft-pool pressure degrading;
the validation errors and the stats schema. llama-tiny, 2 layers, on
the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from tony_tpu.models import get_model as jax_model
from tony_tpu.serve import NgramDraft as JNgramDraft
from tony_tpu.serve import PagedKVCache as JPagedKVCache
from tony_tpu.serve import Request as JRequest
from tony_tpu.serve import SpecEngine as JSpecEngine
from tony_tpu.serve.kvcache import AdmissionError as JAdmissionError
from tony_tpu_torch import profiler
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params
from tony_tpu_torch.serve import (AdmissionError, ModelDraft, NgramDraft,
                                  PagedKVCache, Request, ServeEngine,
                                  SpecEngine)

ENGINE_KW = dict(ctx_max=64, block_size=8, q_block=16, decode_buckets=(2, 4),
                 max_running=4, keep_logits=True)


def _jax_params(jm, seed):
    return nn.unbox(jm.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 16), jnp.int32)))["params"]


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny decoder (f32) and the port's, on the same weights."""
    jm = jax_model("llama-tiny", n_layers=2, dtype=jnp.float32)
    params = _jax_params(jm, 0)
    tm = get_model("llama-tiny", n_layers=2, dtype=torch.float32,
                   device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return (jm, params), tm


@pytest.fixture(scope="module")
def bf16_model(pair):
    _, tm = pair
    m = get_model("llama-tiny", n_layers=2, dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        for (_, p), (_, q) in zip(m.named_parameters(),
                                  tm.named_parameters()):
            p.copy_(q)
    return m


@pytest.fixture(params=["f32", "bf16"])
def model(request, pair, bf16_model):
    return pair[1] if request.param == "f32" else bf16_model


def plain(model, **kw):
    return ServeEngine(model, **{"device": "cpu", **ENGINE_KW, **kw})


def spec(model, **kw):
    return SpecEngine(model, **{"device": "cpu", **ENGINE_KW, **kw})


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 256, n)] for n in lengths]


def run_all(eng, prompts, new, request=Request):
    for i, p in enumerate(prompts):
        eng.submit(request(rid=f"r{i}", tokens=p, max_new_tokens=new[i]))
    return {c.rid: c for c in eng.run()}


def drive_overlapping(eng, prompts, new, request=Request):
    """r0 alone for a step, r1/r2 join mid-flight, then r3 late."""
    done = []
    eng.submit(request(rid="r0", tokens=prompts[0], max_new_tokens=new[0]))
    done += eng.step()
    for i in (1, 2):
        eng.submit(request(rid=f"r{i}", tokens=prompts[i],
                           max_new_tokens=new[i]))
    done += eng.step()
    eng.submit(request(rid="r3", tokens=prompts[3], max_new_tokens=new[3]))
    done += eng.run()
    return {c.rid: c for c in done}


def assert_bitwise(base, got):
    assert sorted(base) == sorted(got)
    for rid in base:
        assert base[rid].tokens == got[rid].tokens, rid
        assert len(base[rid].logits) == len(got[rid].logits)
        for a, b in zip(base[rid].logits, got[rid].logits):
            assert np.array_equal(a, b), (rid, float(np.abs(a - b).max()))


SPEC_COUNTERS = ("spec_proposed", "spec_accepted", "verify_launches",
                 "spec_rounds", "spec_tokens_out", "forwards")


# ---------------------------------------------------------------------------
# The speculative tier against the reference's cache
# ---------------------------------------------------------------------------

def _state(c):
    return ({k: list(v) for k, v in c._tables.items()}, list(c._free),
            {k: list(v) for k, v in c._spec.items() if v},
            dict(c._committed), c.free_blocks)


class TestSpecCache:
    def test_commit_promotes_covering_blocks_like_the_reference(self):
        caches = (PagedKVCache(2, 8, n_blocks=8, block_size=4, device="cpu"),
                  JPagedKVCache(2, 8, n_blocks=8, block_size=4))
        for c in caches:
            c.reserve("s", 4)
            c.spec_reserve("s", 12)
            c.commit("s", 7)
            assert c.rollback("s") == 1
            c.commit("s", 5)
        assert _state(caches[0]) == _state(caches[1])
        assert caches[0].committed_len("s") == 7
        with pytest.raises(ValueError, match="cannot commit"):
            caches[0].commit("s", 40)

    @pytest.mark.parametrize("seed", [7, 8])
    def test_randomized_accept_reject_identical_and_leak_free(self, seed):
        rng = np.random.RandomState(seed)
        tc = PagedKVCache(2, 8, n_blocks=16, block_size=4, device="cpu")
        jc = JPagedKVCache(2, 8, n_blocks=16, block_size=4)
        live = set()
        for _ in range(300):
            op, sid = rng.randint(5), int(rng.randint(6))
            arg = int(rng.randint(1, 32))
            outs = []
            for c, admission in ((tc, AdmissionError),
                                 (jc, JAdmissionError)):
                try:
                    if op == 0 and not c._spec.get(sid):
                        c.reserve(sid, arg % 24)
                    elif op == 1:
                        c.spec_reserve(sid, arg)
                    elif op == 2 and sid in live:
                        covered = len(c.table(sid)) * c.block_size
                        c.commit(sid, arg % (covered + 1))
                    elif op == 3 and sid in live:
                        outs.append(c.rollback(sid))
                    elif op == 4 and sid in live:
                        outs.append(c.free_seq(sid))
                except admission:
                    outs.append("pressure")
            if op in (0, 1):
                live.add(sid)
            elif op == 4:
                live.discard(sid)
            assert outs[:len(outs) // 2] == outs[len(outs) // 2:]
            assert _state(tc) == _state(jc)
            flat = [b for t in tc.owned_blocks().values() for b in t]
            assert len(flat) == len(set(flat))
            assert len(flat) + tc.free_blocks == tc.n_blocks
        for sid in list(live):
            tc.free_seq(sid)
        assert tc.free_blocks == tc.n_blocks


# ---------------------------------------------------------------------------
# The n-gram draft
# ---------------------------------------------------------------------------

class _S:
    def __init__(self, rid, tokens):
        self.rid, self.tokens = rid, tokens


class TestNgramDraft:
    def test_proposals_equal_the_reference(self):
        rng = np.random.RandomState(0)
        port, ref = NgramDraft(max_n=3), JNgramDraft(max_n=3)
        hists = {i: [int(t) for t in rng.randint(0, 6, 5 + i)]
                 for i in range(4)}
        for _ in range(6):
            seqs = [_S(i, h) for i, h in hists.items()]
            ks = [int(k) for k in rng.randint(1, 6, len(seqs))]
            assert port.propose(seqs, ks) == ref.propose(seqs, ks)
            for h in hists.values():          # "accepted" tokens arrive
                h.extend(int(t) for t in rng.randint(0, 6, 2))
        assert port.propose([_S("a", [1, 2, 3, 9, 1, 2, 3])], [3]) == \
            [[9, 1, 2]]
        assert port.propose([_S("b", [5])], [2]) == [[5, 5]]
        port.evict(_S("a", []))
        assert "a" not in port._index

    def test_validation(self):
        for kw in ({"max_n": 0}, {"max_n": 2, "min_n": 3}):
            with pytest.raises(ValueError):
                NgramDraft(**kw)


# ---------------------------------------------------------------------------
# The port's SpecEngine against the JAX SpecEngine
# ---------------------------------------------------------------------------

class TestSpecAgainstJax:
    @pytest.mark.parametrize("draft", ["ngram", "self"])
    def test_overlapping_mix_matches_jax(self, pair, draft):
        (jm, params), tm = pair
        prompts = _prompts(1, (5, 11, 9, 20))
        new = [6, 5, 3, 4]
        jkw, tkw = {}, {}
        if draft == "self":
            jkw = dict(draft_model=jm, draft_params=params)
            tkw = dict(draft_model=tm)
        jeng = JSpecEngine(jm, params, spec_k=4, **ENGINE_KW, **jkw)
        teng = spec(tm, spec_k=4, **tkw)
        jdone = drive_overlapping(jeng, prompts, new, request=JRequest)
        tdone = drive_overlapping(teng, prompts, new)
        assert sorted(tdone) == sorted(jdone)
        for rid, jc in jdone.items():
            assert tdone[rid].tokens == jc.tokens
            for a, b in zip(tdone[rid].logits, jc.logits):
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
        for key in SPEC_COUNTERS:
            assert getattr(teng, key) == getattr(jeng, key), key
        assert teng.draft.forwards == jeng.draft.forwards
        js, ts = jeng.stats(), teng.stats()
        for key in ("acceptance_rate", "tokens_per_verify",
                    "tokens_per_seq_round", "draft_forwards"):
            assert ts[key] == js[key], key
        # Every key the port publishes is one the JAX engine publishes,
        # but the port's two latency percentiles.
        assert set(ts) - set(js) == {"ttft_p50_ms", "step_p50_ms"}


# ---------------------------------------------------------------------------
# Inside the port: speculation changes no bit
# ---------------------------------------------------------------------------

class TestSpecBitwise:
    @pytest.mark.parametrize("k", [1, 2, 4, 7])
    def test_depth_sweep_bitwise_vs_plain(self, model, k):
        prompts = _prompts(0, (7, 8, 9, 15, 17))
        new = [6] * 5
        base = run_all(plain(model), prompts, new)
        eng = spec(model, spec_k=k)
        assert_bitwise(base, run_all(eng, prompts, new))
        assert eng.spec_proposed > 0 and eng.verify_launches > 0
        assert eng.cache.free_blocks == eng.cache.n_blocks

    def test_overlapping_joins_with_both_admission_lanes(self, model):
        """Shared-prefix prompts, chunked, joining mid-flight: forked
        sequences verify through copy-on-write writes and roll back
        without touching the shared prefix."""
        rng = np.random.RandomState(3)
        shared = [int(t) for t in rng.randint(0, 256, 16)]
        prompts = [shared + [int(t) for t in rng.randint(0, 256, n)]
                   for n in (0, 3, 7, 20)]
        new = [6, 6, 5, 4]
        base = drive_overlapping(plain(model), prompts, new)
        eng = spec(model, spec_k=4, prefix_cache=True, prefill_chunk=16)
        assert_bitwise(base, drive_overlapping(eng, prompts, new))
        assert eng.cache.adopted_total > 0 and eng.prefill_chunks > 0
        assert eng.cache.free_blocks == eng.cache.n_blocks

    def test_self_draft_accepts_every_proposal(self, model):
        prompts = _prompts(4, (7, 10, 16, 9))
        new = [6, 5, 4, 6]
        base = drive_overlapping(plain(model), prompts, new)
        eng = spec(model, spec_k=4, draft_model=model)
        assert_bitwise(base, drive_overlapping(eng, prompts, new))
        assert eng.spec_accepted == eng.spec_proposed > 0
        assert eng.draft.forwards > 0
        assert eng.draft.cache.free_blocks == eng.draft.cache.n_blocks

    def test_draft_with_other_weights_accepts_some(self, pair):
        _, tm = pair
        other = get_model("llama-tiny", n_layers=1, dtype=torch.float32,
                          device="cpu", seed=9)
        prompts = _prompts(5, (8, 12, 6, 15))
        new = [6, 4, 6, 5]
        base = drive_overlapping(plain(tm), prompts, new)
        eng = spec(tm, spec_k=4, draft_model=other)
        assert_bitwise(base, drive_overlapping(eng, prompts, new))
        assert eng.spec_accepted < eng.spec_proposed
        assert eng.draft.cache.free_blocks == eng.draft.cache.n_blocks

    def test_draft_pool_pressure_degrades_never_wedges(self, pair):
        _, tm = pair
        prompts = _prompts(8, (9, 12, 7))
        new = [5, 5, 5]
        base = run_all(plain(tm), prompts, new)
        # 3 blocks of 8: one sequence syncs, the others draft nothing.
        draft = ModelDraft(tm, ctx_max=64, block_size=8, q_block=16,
                           decode_buckets=(2, 4), max_running=4, n_blocks=3,
                           device="cpu")
        eng = spec(tm, spec_k=4, draft=draft)
        assert_bitwise(base, run_all(eng, prompts, new))
        assert draft.cache.free_blocks == draft.cache.n_blocks
        assert eng.spec_proposed > 0

    def test_rolled_back_rows_regenerate_like_a_full_prefill(self, pair):
        _, tm = pair
        eng = spec(tm, spec_k=4)
        run_all(eng, _prompts(3, (9,)), [6])
        p2 = _prompts(9, (11,))[0]
        done = run_all(eng, [p2], [5])["r0"]
        ref = eng.full_prefill_logits(p2 + done.tokens)
        for j, row in enumerate(done.logits):
            assert np.array_equal(ref[len(p2) - 1 + j], row)

    def test_validation_and_records(self, pair):
        _, tm = pair
        for k in (0, 16):
            with pytest.raises(ValueError, match="spec_k"):
                spec(tm, spec_k=k)
        with pytest.raises(ValueError, match="not both"):
            spec(tm, spec_k=2, draft=NgramDraft(), draft_model=tm)
        profiler.reset_serve_records()
        eng = spec(tm, spec_k=3, tag="spec_t")
        assert profiler.serve_report()["spec_t_spec"]["k"] == 3
        assert profiler.serve_report()["spec_t_spec"]["draft"] == "ngram"
        run_all(eng, [[1, 2, 3]], [4])
        s = eng.stats()
        assert s["verify_launches"] == float(eng.verify_launches) > 0
        for key in ("prefix_cache_hit_rate", "blocks_shared",
                    "prefill_chunks"):
            assert s[key] == 0.0
        assert plain(tm).stats()["acceptance_rate"] == 0.0

    def test_verify_copies_its_rows_to_the_host_once(self, pair,
                                                     monkeypatch):
        """One device-to-host copy of the [b, k+1, V] rows a verify
        round, not one a row."""
        _, tm = pair
        eng = spec(tm, spec_k=4)
        eng.submit(Request(rid="a", tokens=_prompts(2, (9,))[0],
                           max_new_tokens=12))
        eng.step()                             # join + prefill + 1 round
        calls = []
        real = eng._run_fn

        def counting(*args):
            out = real(*args)

            class Logits:
                def __getitem__(self, idx):
                    calls.append(idx)
                    return out[idx]
            return Logits()

        monkeypatch.setattr(eng, "_run_fn", counting)
        eng.step()
        assert len(calls) == 1
        # The write cursor names exactly the verified rows: every row
        # below the newest (not yet fed) token.
        (seq,) = eng._running
        assert eng.cache.committed_len("a") == len(seq.tokens) - 1
