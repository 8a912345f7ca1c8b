"""Port parity for the routed serving lanes (tony_tpu_torch.serve.prefix,
the prefix tier of .kvcache, the prefix-cache and chunked-prefill lanes
of .engine and the digest): the chain keys equal
the JAX package's; the port's cache and the reference's, driven by the
same randomized admit/fork/COW/publish/free/evict/spec sequence and by
the reference's TestPrefixKVCache scenarios, hold the same tables,
refcounts, free and LRU order, index, counters and pool bytes; the port
engine's lanes against the JAX engine's on the same mixes (f32: equal
tokens and lane counters, logits within 1e-4, the tolerance
tests/test_torch_serve.py holds the engines to); inside the port, hit
against miss, COW, LRU revival and chunked against monolithic bitwise
(f32 and bf16); the engine's stats file through the JAX executor's
reader and RequestRouter; a weight swap flushing the tier. The replica
with the lanes armed through ``main()`` is in
tests/test_torch_replica.py. llama-tiny, 2 layers, on the CPU."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from tony_tpu.executor import read_serve_stats
from tony_tpu.models import get_model as jax_model
from tony_tpu.serve import PagedKVCache as JPagedKVCache
from tony_tpu.serve import Request as JRequest
from tony_tpu.serve import ServeEngine as JServeEngine
from tony_tpu.serve import prefix as jprefix
from tony_tpu.serve.kvcache import AdmissionError as JAdmissionError
from tony_tpu.serve.router import ReplicaView, RequestRouter, RouterPolicy
from tony_tpu.serve.router import score as router_score
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params
from tony_tpu_torch.serve import (AdmissionError, EngineFront, PagedKVCache,
                                  Request, ServeEngine, prefix)

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


@pytest.fixture(scope="module")
def bf16_model(pair):
    """The same weights stored and computed in bf16."""
    _, tm = pair
    m = get_model("llama-tiny", n_layers=2, dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        for (_, p), (_, q) in zip(m.named_parameters(),
                                  tm.named_parameters()):
            p.copy_(q)
    return m


def port_engine(model, **kw):
    return ServeEngine(model, **{"device": "cpu", **ENGINE_KW, **kw})


def run_requests(eng, prompts, max_new=4, stagger=True, request=Request):
    """Submit and drive; staggered submission joins requests mid-flight
    (a live donor's blocks shared) as real traffic would."""
    done = {}
    for i, p in enumerate(prompts):
        eng.submit(request(rid=i, tokens=list(p), max_new_tokens=max_new))
        if stagger:
            done.update({c.rid: c for c in eng.step()})
    done.update({c.rid: c for c in eng.run()})
    return done


def assert_bitwise(got, ref):
    assert sorted(got) == sorted(ref)
    for rid in ref:
        assert got[rid].tokens == ref[rid].tokens, rid
        assert len(got[rid].logits) == len(ref[rid].logits)
        for a, b in zip(got[rid].logits, ref[rid].logits):
            assert np.array_equal(a, b), (rid, float(np.abs(a - b).max()))


def assert_close_to_jax(got, ref):
    assert sorted(got) == sorted(ref)
    for rid in ref:
        assert got[rid].tokens == ref[rid].tokens, rid
        for a, b in zip(got[rid].logits, ref[rid].logits):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


LANE_COUNTERS = ("prefix_lookup_blocks", "prefix_hit_blocks",
                 "prefill_launches", "prefill_rows", "prefill_chunks",
                 "forwards")


def lane_counters(eng):
    c = eng.cache
    return {**{k: getattr(eng, k) for k in LANE_COUNTERS},
            "adopted": c.adopted_total, "cow": c.cow_total,
            "revived": c.revived_total, "evicted": c.lru_evicted_total,
            "free_blocks": c.free_blocks}


# ---------------------------------------------------------------------------
# Chain keys
# ---------------------------------------------------------------------------

class TestChainKeys:
    @pytest.mark.parametrize("seed,bs", [(0, 1), (1, 4), (2, 8), (3, 16),
                                         (4, 5)])
    def test_keys_equal_the_reference(self, seed, bs):
        rng = np.random.RandomState(seed)
        toks = [int(t) for t in rng.randint(0, 32000, 3 * bs + seed)]
        keys = prefix.chain_keys(toks, bs)
        assert keys == jprefix.chain_keys(toks, bs)
        assert len(keys) == len(toks) // bs
        # A continued chain, numpy ints and the empty prompt.
        assert prefix.chain_keys(toks[bs:], bs, prior=keys[0]) == \
            jprefix.chain_keys(toks[bs:], bs, prior=keys[0]) == keys[1:]
        assert prefix.chain_keys(np.asarray(toks), bs) == keys
        assert prefix.chain_keys([], bs) == []
        # The router's overlap score over a digest with a gap.
        digest = set(keys[:2]) | set(keys[3:])
        assert prefix.match_overlap(keys, digest) == \
            jprefix.match_overlap(keys, digest) == min(2, len(keys))
        assert prefix.KEY_HEX == jprefix.KEY_HEX
        with pytest.raises(ValueError):
            prefix.chain_keys(toks, 0)


# ---------------------------------------------------------------------------
# The prefix and speculative tiers against the reference's cache
# ---------------------------------------------------------------------------

def _pair_caches(n_blocks, block_size):
    """The port's cache and the reference's, pools filled with the same
    distinct values so a copy-on-write shows in the bytes."""
    jc = JPagedKVCache(2, 4, n_blocks=n_blocks, block_size=block_size,
                       dtype=jnp.float32)
    tc = PagedKVCache(2, 4, n_blocks=n_blocks, block_size=block_size,
                      dtype=torch.float32, device="cpu")
    init = np.arange(np.prod(tc.k.shape), dtype=np.float32).reshape(
        tc.k.shape)
    jc.k, jc.v = jnp.asarray(init), jnp.asarray(-init)
    tc.k.copy_(torch.from_numpy(init))
    tc.v.copy_(torch.from_numpy(-init))
    return tc, jc


def cache_state(c):
    return {"tables": {k: list(v) for k, v in c._tables.items()},
            "refs": dict(c._refs), "free": list(c._free),
            "lru": list(c._lru), "index": list(c._index.items()),
            "key_of": dict(c._key_of),
            "spec": {k: list(v) for k, v in c._spec.items() if v},
            "committed": dict(c._committed),
            "counters": (c.adopted_total, c.cow_total,
                         c.lru_evicted_total, c.revived_total),
            "free_blocks": c.free_blocks, "digest": c.digest(),
            "shared": c.shared_blocks()}


def assert_same_cache(tc, jc):
    assert cache_state(tc) == cache_state(jc)
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


def both(tc, jc, op, *args):
    """``op`` on both caches: the same result, or the same failure."""
    out = []
    for c, admission in ((tc, AdmissionError), (jc, JAdmissionError)):
        try:
            out.append(("ok", getattr(c, op)(*args)))
        except admission as exc:
            out.append(("admission", exc.needed_blocks, exc.free_blocks))
        except (ValueError, IndexError, KeyError) as exc:
            out.append((type(exc).__name__,))
    assert out[0] == out[1], (op, args, out)
    return out[0]


def _publish_all(tc, jc, sid, tokens, bs):
    for i, key in enumerate(prefix.chain_keys(tokens, bs)):
        both(tc, jc, "publish_block", sid, i, key)


def scenario_admit_shared_adopts(tc, jc):
    toks = list(range(10))
    both(tc, jc, "reserve", "a", 12)
    _publish_all(tc, jc, "a", toks, 4)
    assert both(tc, jc, "admit_shared", "b", 12,
                prefix.chain_keys(toks, 4)) == ("ok", 2)
    assert tc.table("b")[:2] == tc.table("a")[:2]


def scenario_admit_atomic_on_pressure(tc, jc):
    both(tc, jc, "reserve", "a", 8)
    _publish_all(tc, jc, "a", list(range(8)), 4)
    both(tc, jc, "reserve", "z", 32)            # 2 of 12 left
    out = both(tc, jc, "admit_shared", "b", 20,
               prefix.chain_keys(list(range(8)), 4))
    assert out[0] == "admission" and tc.table("b") == []


def scenario_cow_never_mutates_shared(tc, jc):
    toks = list(range(8))
    both(tc, jc, "reserve", "a", 8)
    _publish_all(tc, jc, "a", toks, 4)
    both(tc, jc, "admit_shared", "b", 8, prefix.chain_keys(toks, 4))
    shared = tc.table("a")[0]
    both(tc, jc, "write_index", "b", 1)
    assert tc.table("b")[0] != shared and tc.ref(shared) == 1
    assert torch.equal(tc.k[:, tc.table("b")[0]], tc.k[:, shared])
    both(tc, jc, "write_index", "a", 2)         # private: no copy
    assert tc.cow_total == 1


def scenario_lru_retire_revive_and_evict(tc, jc):
    for sid, toks in (("a", [1, 2, 3, 4]), ("b", [5, 6, 7, 8])):
        both(tc, jc, "reserve", sid, 4)
        _publish_all(tc, jc, sid, toks, 4)
        both(tc, jc, "free_seq", sid)
    assert len(tc.cached_blocks()) == 2 and tc.free_blocks == tc.n_blocks
    both(tc, jc, "admit_shared", "c", 6, prefix.chain_keys([5, 6, 7, 8], 4))
    assert tc.revived_total == 1
    both(tc, jc, "reserve", "z", 4 * (tc.free_blocks - 1))
    both(tc, jc, "reserve", "y", 4)             # reclaims a's block
    assert tc.lru_evicted_total == 1
    assert tc.match_prefix(prefix.chain_keys([1, 2, 3, 4], 4)) == []


def scenario_spec_rollback_keeps_shared_prefix(tc, jc):
    toks = list(range(8))
    both(tc, jc, "reserve", "a", 8)
    _publish_all(tc, jc, "a", toks, 4)
    both(tc, jc, "admit_shared", "b", 8, prefix.chain_keys(toks, 4))
    shared = tc.table("b")[:2]
    both(tc, jc, "spec_reserve", "b", 14)
    both(tc, jc, "commit", "b", 9)
    assert both(tc, jc, "rollback", "b") == ("ok", 1)
    assert tc.table("b")[:2] == shared and tc.committed_len("b") == 9
    assert all(tc.ref(b) == 2 for b in shared)


def scenario_spec_reserve_reject_and_reuse(tc, jc):
    both(tc, jc, "reserve", "s", 6)
    both(tc, jc, "commit", "s", 6)
    table = tc.table("s")
    both(tc, jc, "spec_reserve", "s", 14)
    spec = tc.table("s")[2:]
    assert both(tc, jc, "rollback", "s") == ("ok", 2)
    assert tc.table("s") == table
    # LIFO: the same blocks come back in the same order.
    assert both(tc, jc, "spec_reserve", "s", 14)[1][2:] == spec
    both(tc, jc, "reserve", "s", 20)            # refused: interleaving
    both(tc, jc, "commit", "s", 11)
    both(tc, jc, "commit", "s", 5)              # never backwards
    assert tc.committed_len("s") == 11
    both(tc, jc, "spec_reserve", "t", 60)       # exhaustion, typed
    assert both(tc, jc, "free_seq", "s")[1] == 4


def scenario_flush_prefix(tc, jc):
    toks = list(range(12))
    both(tc, jc, "reserve", "a", 12)
    _publish_all(tc, jc, "a", toks, 4)
    both(tc, jc, "reserve", "b", 8)
    _publish_all(tc, jc, "b", [9] * 8, 4)
    both(tc, jc, "free_seq", "b")
    assert both(tc, jc, "flush_prefix") == ("ok", 5)
    assert tc.digest() == [] and tc.cached_blocks() == []
    assert both(tc, jc, "admit_shared", "c", 12,
                prefix.chain_keys(toks, 4)) == ("ok", 0)


SCENARIOS = [scenario_admit_shared_adopts, scenario_admit_atomic_on_pressure,
             scenario_cow_never_mutates_shared,
             scenario_lru_retire_revive_and_evict,
             scenario_spec_rollback_keeps_shared_prefix,
             scenario_spec_reserve_reject_and_reuse, scenario_flush_prefix]


class TestCacheAgainstReference:
    @pytest.mark.parametrize("scenario", SCENARIOS,
                             ids=[s.__name__[9:] for s in SCENARIOS])
    def test_scenario(self, scenario):
        tc, jc = _pair_caches(12, 4)
        scenario(tc, jc)
        assert_same_cache(tc, jc)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_randomized_ops_hold_identical_state(self, seed):
        """≥300 random admit (shared) / publish / write (COW) /
        spec-reserve + commit + rollback / permanent grow / free /
        flush ops over a small pool: after every op both caches hold the
        same state, and at the end the same pool bytes."""
        rng = np.random.RandomState(seed)
        bs = 4
        tc, jc = _pair_caches(16, bs)
        stems = [[int(t) for t in rng.randint(0, 50, 8)] for _ in range(3)]
        seqs = {}
        n = 0
        for _ in range(320):
            op = rng.choice(["admit", "admit", "write", "spec", "grow",
                             "free", "flush"], p=[.25, .1, .25, .2, .05,
                                                  .14, .01])
            live = sorted(seqs)
            if op == "admit":
                n += 1
                sid = f"s{n}"
                toks = stems[rng.randint(3)][:rng.choice([4, 8])] + [
                    int(t) for t in rng.randint(0, 50, rng.randint(0, 6))]
                out = both(tc, jc, "admit_shared", sid, len(toks) + 4,
                           prefix.chain_keys(toks, bs))
                if out[0] == "ok":
                    seqs[sid] = toks
                    _publish_all(tc, jc, sid, toks, bs)
            elif op == "write" and live:
                sid = live[rng.randint(len(live))]
                pos = rng.randint(len(tc.table(sid)) * bs)
                both(tc, jc, "write_index", sid, pos)
            elif op == "spec" and live:
                sid = live[rng.randint(len(live))]
                extent = len(tc.table(sid)) * bs
                if both(tc, jc, "spec_reserve", sid,
                        extent + rng.randint(1, 9))[0] == "ok":
                    both(tc, jc, "commit", sid, rng.randint(extent + 1))
                    both(tc, jc, "rollback", sid)
            elif op == "grow" and live:
                sid = live[rng.randint(len(live))]
                both(tc, jc, "reserve", sid,
                     len(tc.table(sid)) * bs + rng.randint(1, 6))
            elif op == "free" and live:
                sid = live[rng.randint(len(live))]
                del seqs[sid]
                both(tc, jc, "free_seq", sid)
            elif op == "flush":
                both(tc, jc, "flush_prefix")
            assert cache_state(tc) == cache_state(jc)
        assert tc.adopted_total > 0 and tc.cow_total > 0 \
            and tc.revived_total > 0
        assert_same_cache(tc, jc)

    def test_lanes_off_cache_is_the_plain_lifo_one(self):
        """Without publication the tiers stay empty: reserve, free and
        reuse follow the LIFO list exactly as before."""
        c = PagedKVCache(2, 8, n_blocks=8, block_size=4, device="cpu")
        t_a = c.reserve("a", 8)
        c.free_seq("a")
        assert c.reserve("b", 8) == t_a
        assert c.cached_blocks() == [] and c.digest() == []
        assert c.write_index("b", 5) == c.flat_index("b", 5)


# ---------------------------------------------------------------------------
# The port engine's lanes against the JAX engine's
# ---------------------------------------------------------------------------

def _prefix_mix(seed):
    rng = np.random.RandomState(seed)
    shared = [int(t) for t in rng.randint(0, 256, 24)]
    return [shared + [int(t) for t in rng.randint(0, 256, 5)],
            shared + [int(t) for t in rng.randint(0, 256, 9)],
            [int(t) for t in rng.randint(0, 256, 11)],         # miss
            shared[:12] + [int(t) for t in rng.randint(0, 256, 7)],
            list(shared),                                       # full cover
            shared[:8] + [int(t) for t in rng.randint(0, 256, 3)]]


class TestLanesAgainstJax:
    @pytest.mark.parametrize("lanes", [
        {"prefix_cache": True}, {"prefill_chunk": 16},
        {"prefix_cache": True, "prefill_chunk": 16}],
        ids=["prefix", "chunked", "both"])
    def test_mix_matches_jax(self, pair, lanes):
        (jm, params), tm = pair
        prompts = _prefix_mix(0)
        jeng = JServeEngine(jm, params, **ENGINE_KW, **lanes)
        teng = port_engine(tm, **lanes)
        jdone = run_requests(jeng, prompts, max_new=5, request=JRequest)
        tdone = run_requests(teng, prompts, max_new=5)
        assert_close_to_jax(tdone, jdone)
        assert lane_counters(teng) == lane_counters(jeng)
        for key in ("prefix_cache_hit_rate", "blocks_shared",
                    "prefill_chunks"):
            assert teng.stats()[key] == jeng.stats()[key]
        assert teng.prefix_digest() == jeng.prefix_digest()

    def test_follow_up_turn_revives_like_jax(self, pair):
        (jm, params), tm = pair
        rng = np.random.RandomState(2)
        turn1 = [int(t) for t in rng.randint(0, 256, 17)]
        engines = (JServeEngine(jm, params, prefix_cache=True, **ENGINE_KW),
                   port_engine(tm, prefix_cache=True))
        outs = []
        for eng, req in zip(engines, (JRequest, Request)):
            first = run_requests(eng, [turn1], request=req)[0]
            turn2 = turn1 + list(first.tokens) + [3, 1, 4]
            outs.append(run_requests(eng, [turn2], request=req))
        assert_close_to_jax(outs[1], outs[0])
        assert lane_counters(engines[1]) == lane_counters(engines[0])
        assert engines[1].cache.revived_total > 0


# ---------------------------------------------------------------------------
# Inside the port: the lanes change no bit
# ---------------------------------------------------------------------------

@pytest.fixture(params=["f32", "bf16"])
def model(request, pair, bf16_model):
    return pair[1] if request.param == "f32" else bf16_model


class TestPrefixBitwise:
    def test_hit_and_miss_bitwise_vs_plain(self, model):
        prompts = _prefix_mix(1)
        ref = run_requests(port_engine(model), prompts)
        eng = port_engine(model, prefix_cache=True)
        assert_bitwise(run_requests(eng, prompts), ref)
        assert eng.prefix_hit_blocks > 0
        assert eng.cache.free_blocks == eng.cache.n_blocks

    def test_cow_mid_block_and_at_boundary(self, model):
        rng = np.random.RandomState(3)
        base = [int(t) for t in rng.randint(0, 256, 16)]
        prompts = [base,
                   base[:12] + [int(t) for t in rng.randint(0, 256, 7)],
                   base[:8] + [int(t) for t in rng.randint(0, 256, 5)],
                   list(base)]
        ref = run_requests(port_engine(model), prompts, max_new=5)
        eng = port_engine(model, prefix_cache=True)
        assert_bitwise(run_requests(eng, prompts, max_new=5), ref)
        assert eng.cache.cow_total >= 1 and eng.cache.adopted_total >= 4

    def test_recently_evicted_prefix_revives(self, model):
        rng = np.random.RandomState(4)
        turn1 = [int(t) for t in rng.randint(0, 256, 17)]
        eng = port_engine(model, prefix_cache=True)
        first = run_requests(eng, [turn1])[0]
        assert eng.cache.cached_blocks()
        turn2 = turn1 + list(first.tokens) + [7, 7, 7, 7]
        rows = eng.prefill_rows
        got = run_requests(eng, [turn2])
        assert eng.cache.revived_total > 0
        assert eng.prefill_rows - rows < -(-len(turn2) // 16) * 16
        assert_bitwise(got, run_requests(port_engine(model), [turn2]))

    def test_full_prefill_reference_leaves_the_index_alone(self, model):
        eng = port_engine(model, prefix_cache=True)
        run_requests(eng, _prefix_mix(5)[:2])
        before = cache_state(eng.cache)
        eng.full_prefill_logits(_prefix_mix(5)[0])
        assert cache_state(eng.cache) == before


class TestChunkedBitwise:
    def test_chunked_vs_monolithic_ragged(self, model):
        rng = np.random.RandomState(6)
        prompts = [[int(t) for t in rng.randint(0, 256, n)]
                   for n in (7, 15, 16, 17, 23, 40)]
        ref = run_requests(port_engine(model), prompts)
        eng = port_engine(model, prefill_chunk=16)
        assert_bitwise(run_requests(eng, prompts), ref)
        assert eng.prefill_chunks == 1 + 1 + 1 + 2 + 2 + 3
        both_lanes = port_engine(model, prefill_chunk=16, prefix_cache=True)
        assert_bitwise(run_requests(both_lanes, _prefix_mix(7)),
                       run_requests(port_engine(model), _prefix_mix(7)))

    def test_decode_keeps_its_cadence_during_chunks(self, pair):
        """While a 60-token prompt prefills in 4 chunks, the running
        sequence emits one token every iteration."""
        _, tm = pair
        eng = port_engine(tm, ctx_max=128, prefill_chunk=16,
                          keep_logits=False)
        eng.submit(Request(rid="short", tokens=[1, 2, 3], max_new_tokens=8))
        eng.step()
        eng.submit(Request(rid="long", tokens=list(range(60)),
                           max_new_tokens=2))
        grew = []
        for _ in range(4):
            short = next(s for s in eng._running if s.rid == "short")
            before = len(short.tokens)
            eng.step()
            grew.append(len(short.tokens) - before)
        # The short prompt's one chunk, then the long one's four.
        assert grew == [1, 1, 1, 1] and eng.prefill_chunks == 5
        assert sorted(c.rid for c in eng.run()) == ["short"]

    def test_quiesce_drains_a_half_prefilled_prompt(self, pair):
        """A hot swap's quiesce finishes a prompt caught between chunks
        under the old weights before the flip."""
        _, tm = pair
        eng = port_engine(tm, prefill_chunk=16, keep_logits=False)
        front = EngineFront(eng)
        eng.submit(Request(rid="p", tokens=list(range(40)),
                           max_new_tokens=2))
        eng.step()
        assert eng._prefilling and eng.prefill_chunks == 1
        seen = []
        front.quiesce_and_swap(
            lambda: seen.append((len(eng._prefilling), len(eng._running))))
        assert seen == [(0, 0)] and "p" in front._done

    def test_validation(self, pair):
        _, tm = pair
        for bad in (12, -16, 0):
            with pytest.raises(ValueError, match="prefill_chunk"):
                port_engine(tm, prefill_chunk=bad)


# ---------------------------------------------------------------------------
# Stats, digest, router, hot swap
# ---------------------------------------------------------------------------

class TestStatsAndRouting:
    def test_lane_stats_zero_when_off(self, pair):
        _, tm = pair
        eng = port_engine(tm, keep_logits=False)
        run_requests(eng, [[1, 2, 3]], max_new=2)
        s = eng.stats()
        assert s["prefix_cache_hit_rate"] == s["blocks_shared"] == \
            s["prefill_chunks"] == 0.0
        assert eng.prefix_digest() == []

    def test_stats_file_digest_through_the_jax_reader_and_router(
            self, pair, tmp_path):
        _, tm = pair
        eng = port_engine(tm, prefix_cache=True, keep_logits=False)
        toks = [int(t) for t in np.random.RandomState(8).randint(0, 256, 19)]
        run_requests(eng, [toks], max_new=3)
        path = tmp_path / "serve-stats.json"
        eng.write_stats(str(path), extra={"rpc_port": 4321})
        read = read_serve_stats(path)
        assert read["rpc_port"] == 4321.0
        keys = jprefix.chain_keys(toks, eng.block_size)
        assert set(keys) <= set(read["prefix_digest"])
        # The router's deterministic score: overlap first, then load.
        pol = RouterPolicy()
        warm = ReplicaView(name="warm", address="x",
                           digest=frozenset(read["prefix_digest"]))
        cold = ReplicaView(name="cold", address="x")
        assert router_score(pol, warm, keys) > router_score(pol, cold, keys)
        router = RequestRouter(block_size=eng.block_size)
        router.upsert_replica("warm", address="127.0.0.1:1", stats=read)
        router.upsert_replica("cold", address="127.0.0.1:2",
                              stats={"queue_depth": 0.0})
        assert router.route(toks + [1, 2, 3]) == "warm"

    def test_swap_flushes_the_prefix_tier(self, pair):
        _, tm = pair
        m = get_model("llama-tiny", n_layers=2, dtype=torch.float32,
                      device="cpu", seed=3)
        eng = port_engine(m, prefix_cache=True)
        prompt = _prefix_mix(9)[0]
        run_requests(eng, [prompt])
        assert eng.prefix_digest()
        other = get_model("llama-tiny", n_layers=2, dtype=torch.float32,
                          device="cpu", seed=11)
        eng.swap_params({n: p.detach() for n, p in
                         other.named_parameters()}, version=2, step=2)
        assert eng.prefix_digest() == [] and eng.cache.cached_blocks() == []
        hits = eng.prefix_hit_blocks
        got = run_requests(eng, [prompt])
        assert eng.prefix_hit_blocks == hits
        assert_bitwise(got, run_requests(port_engine(other), [prompt]))
        assert json.loads(json.dumps(eng.stats()))["blocks_shared"] >= 0
