"""Port parity for the KV memory hierarchy (tony_tpu_torch.serve: the host
tier of .kvcache, conversation parking in .engine and .spec, the decode
side's parking in .disagg, the persisted prefix store .kvstore): the
reference's tests/test_kvtier.py rebuilt on the port.

* The host tier at the pool level: demoted and parked payloads are
  equal, as bytes, to the JAX package's for the same pool contents (the
  two pools are filled with the same seeded bytes); promotion and resume
  put the bytes back verbatim, in place in the stores; corrupt payloads
  reject with both tiers unchanged.
* Parking: every parked-and-resumed conversation's tokens AND per-token
  logits are ``np.array_equal`` to the port's own never-parked engine
  (bf16 weights, as the reference's tests serve), and a parked f32
  engine's tokens equal the JAX package's parked engine's, with logits
  within the 1e-4 tests/test_torch_serve.py holds the engines to.
* The prefix store: a store written by either package loads into the
  other, file for file.

llama-tiny, 2 layers, ctx_max 64, blocks of 8, on the CPU."""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from tony_tpu.models import get_model as jax_model
from tony_tpu.serve import EngineFront as JEngineFront
from tony_tpu.serve import PagedKVCache as JPagedKVCache
from tony_tpu.serve import PrefixStore as JPrefixStore
from tony_tpu.serve import ServeEngine as JServeEngine
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params
from tony_tpu_torch.serve import (AdmissionError, EngineFront, HandoffError,
                                  PagedKVCache, PrefixStore, Request,
                                  ServeEngine, SpecEngine, prefix)
from tony_tpu_torch.serve.disagg import DecodeFront, PrefillFront
from tony_tpu_torch.serve.replica import Replica

ENGINE_KW = dict(ctx_max=64, block_size=8, q_block=16, decode_buckets=(2, 4),
                 max_running=4, keep_logits=True)


@pytest.fixture(scope="module")
def tiny():
    """The port's tiny decoder with bf16 weights and compute."""
    return get_model("llama-tiny", n_layers=2, dtype=torch.bfloat16,
                     param_dtype=torch.bfloat16, device="cpu", seed=0)


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny decoder (f32) and the port's on the same weights."""
    jm = jax_model("llama-tiny", n_layers=2, dtype=jnp.float32)
    params = nn.unbox(jm.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 16), jnp.int32)))["params"]
    tm = get_model("llama-tiny", n_layers=2, dtype=torch.float32,
                   device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return (jm, params), tm


def make_engine(model, **kw):
    return ServeEngine(model, **{"device": "cpu", **ENGINE_KW, **kw})


def assert_bitwise(got, ref, what):
    assert got.tokens == ref.tokens, f"{what}: token streams differ"
    assert got.logits is not None and ref.logits is not None
    assert len(got.logits) == len(ref.logits)
    for j, (g, r) in enumerate(zip(got.logits, ref.logits)):
        assert np.array_equal(g, r), (
            f"{what}: logits row {j} differs "
            f"(max abs diff {np.max(np.abs(g - r))})")


def assert_close_to_jax(got, ref, what):
    """Tokens equal, logits within the engines' f32 tolerance."""
    assert got.tokens == ref.tokens, f"{what}: token streams differ"
    assert len(got.logits) == len(ref.logits)
    for g, r in zip(got.logits, ref.logits):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-4, rtol=0,
                                   err_msg=what)


def run_conversation(front, turns, conv, max_new=4):
    """Each turn's prompt is the FULL history (prior prompt + generated
    tokens) plus the new user tokens. Returns the per-turn completions.
    ``front`` is either package's EngineFront."""
    history: list = []
    outs = []
    for t in turns:
        prompt = history + [int(x) for x in t]
        kw = {} if conv is None else {"conv": conv}
        c = front.generate(prompt, max_new, **kw)
        outs.append(c)
        history = prompt + list(c.tokens)
    return outs


def converse(eng, turns, conv, max_new=4):
    return run_conversation(EngineFront(eng), turns, conv, max_new)


def cache_snapshot(c):
    return (dict(c._refs), list(c._free), c.cached_blocks(),
            {s: list(t) for s, t in c.owned_blocks().items()},
            list(c.host_keys()), list(c.parked_ids()),
            c.k_store.clone(), c.v_store.clone())


def assert_same_snapshot(a, b):
    assert a[:6] == b[:6]
    assert torch.equal(a[6], b[6]) and torch.equal(a[7], b[7])


def check_partition(c):
    """The pool partition, host tier included: free + cached + owned
    cover the device ids exactly; host keys never shadow device keys;
    parked ids never alias live tables."""
    owned = {}
    for t in c.owned_blocks().values():
        for b in t:
            owned[b] = owned.get(b, 0) + 1
    free, lru = set(c._free), set(c.cached_blocks())
    assert not free & lru
    assert not (free | lru) & set(owned)
    assert free | lru | set(owned) == set(range(c.n_blocks))
    assert not set(c.host_keys()) & set(c._index)
    assert c.host_blocks_used <= max(0, c.host_blocks)
    assert not set(c.parked_ids()) & set(c.owned_blocks())


def block_of(c, b):
    return c.k[:, b].clone(), c.v[:, b].clone()


# ---------------------------------------------------------------------------
# Host tier: demote / promote / park / resume at the pool level
# ---------------------------------------------------------------------------

def twin_pools(n_blocks=8, block_size=4, host_blocks=8, dtype="float32",
               **kw):
    """The port's pool and the JAX package's, both holding the same
    seeded bytes in every block (``dtype`` "float32" or "bfloat16")."""
    rng = np.random.RandomState(n_blocks * 31 + block_size)
    shape = (2, n_blocks, block_size, 8)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    port = PagedKVCache(2, 8, n_blocks=n_blocks, block_size=block_size,
                        host_blocks=host_blocks, dtype=tdt, device="cpu",
                        **kw)
    ref = JPagedKVCache(2, 8, n_blocks=n_blocks, block_size=block_size,
                        host_blocks=host_blocks, dtype=jdt, **kw)
    for part in ("k", "v"):
        f32 = rng.standard_normal(shape).astype(np.float32)
        jarr = jnp.asarray(f32).astype(jdt)
        setattr(ref, part, jarr)
        raw = np.asarray(jarr).tobytes()
        src = torch.frombuffer(bytearray(raw), dtype=tdt).reshape(shape)
        getattr(port, f"{part}_store")[:, :n_blocks] = src
    return port, ref


def both(pools, fn):
    """Run ``fn`` on the port's pool and the JAX package's; return both
    results."""
    return [fn(c) for c in pools]


class TestHostTier:
    def _keys(self, tokens, bs=4):
        return prefix.chain_keys(tokens, bs)

    def _publish(self, c, sid, tokens):
        keys = self._keys(tokens, c.block_size)
        c.admit_shared(sid, len(tokens), keys)
        for i, key in enumerate(keys):
            c.write_index(sid, i * c.block_size)
            c.publish_block(sid, i, key)
        return keys

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_demote_promote_round_trip_bytes_verbatim(self, dtype):
        pools = twin_pools(dtype=dtype)
        c = pools[0]
        keys = both(pools, lambda p: self._publish(p, "a", list(range(8))))[0]
        both(pools, lambda p: p.free_seq("a"))     # refcount-0 cached tier
        assert c.cached_blocks()
        before = {k: block_of(c, c._index[k]) for k in keys}
        assert both(pools, lambda p: p.demote(len(keys))) == [len(keys)] * 2
        assert set(c.host_keys()) == set(keys)
        assert c.demoted_total == len(keys)
        assert not set(keys) & set(c._index), \
            "a demoted key must leave the device index"
        # The demoted payloads are the JAX package's, byte for byte.
        assert c._host_index == pools[1]._host_index
        check_partition(c)
        stores = (c.k_store.data_ptr(), c.v_store.data_ptr())
        assert both(pools, lambda p: p.promote(keys)) == [len(keys)] * 2
        assert c.host_keys() == []
        assert c.promoted_total == len(keys)
        assert (c.k_store.data_ptr(), c.v_store.data_ptr()) == stores, \
            "promotion must scatter into the stores in place"
        for k in keys:
            kb, vb = block_of(c, c._index[k])
            assert torch.equal(kb, before[k][0])
            assert torch.equal(vb, before[k][1])
        assert len(c.match_prefix(keys)) == len(keys)
        check_partition(c)

    def test_promote_consumes_lifo_tier_only(self):
        """Promotion under device pressure truncates to the free list
        instead of allocating through LRU eviction (which could evict,
        or demote again, the very chain being promoted)."""
        c, _ = twin_pools(n_blocks=4, block_size=4)
        keys = self._publish(c, "a", list(range(8)))   # 2 blocks
        c.free_seq("a")
        assert c.demote(2) == 2
        c.reserve("hog", 16)               # all 4 device blocks owned
        assert c.promote(keys) == 0, \
            "no free block: promote must degrade, not evict"
        assert set(c.host_keys()) == set(keys)
        c.free_seq("hog")
        assert c.promote(keys) == 2
        check_partition(c)

    def test_host_crc_corruption_rejected_state_unchanged(self):
        c, _ = twin_pools()
        keys = self._publish(c, "a", list(range(8)))
        c.free_seq("a")
        c.demote(len(keys))
        c._host_index[keys[0]]["crc"] ^= 1
        snap = cache_snapshot(c)
        with pytest.raises(HandoffError) as ei:
            c.promote(keys)
        assert not ei.value.retryable
        assert_same_snapshot(cache_snapshot(c), snap)
        assert c.discard_host(keys) == len(keys)
        assert c.host_keys() == []

    def test_host_tier_budget_reclaims_stems_never_parked(self):
        c, _ = twin_pools(n_blocks=12, block_size=4, host_blocks=3)
        self._publish(c, "a", list(range(8)))          # 2 stem blocks
        c.free_seq("a")
        assert c.demote(2) == 2
        c.reserve("p", 12)                             # 3 blocks
        # Parking 3 blocks forces both stems out (the only legal
        # victims); a SECOND park then fails typed.
        assert c.park("p", 12, keys=self._keys(list(range(12)))) == 3
        assert c.host_keys() == [], "stems are the reclaim victims"
        assert c.host_blocks_used == 3
        c.reserve("q", 4)
        with pytest.raises(AdmissionError) as ei:
            c.park("q", 4, keys=self._keys(list(range(4))))
        assert ei.value.retryable
        assert "q" in c.owned_blocks(), "failed park leaves the seq live"
        assert "p" in c.parked_ids()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_park_resume_round_trip_sync(self, dtype):
        pools = twin_pools(dtype=dtype)
        c = pools[0]
        toks = list(range(10))             # 2 full blocks + partial tail
        keys = self._keys(toks)[:2]
        both(pools, lambda p: p.reserve("s", 12))
        for i in range(3):
            both(pools, lambda p: p.write_index("s", i * 4))
        want = [block_of(c, b) for b in c.table("s")]
        assert both(pools, lambda p: p.park("s", 10, keys=keys)) == [3, 3]
        # The parked record's payloads are the JAX package's.
        assert c._parked["s"]["blocks"] == pools[1]._parked["s"]["blocks"]
        assert "s" not in c.owned_blocks()
        assert c.parked_ids() == ["s"]
        check_partition(c)
        adopted = c.resume("s2", 14, "s")
        assert c.parked_ids() == []
        t = c.table("s2")
        for i in range(3):
            assert torch.equal(c.k[:, t[i]], want[i][0])
            assert torch.equal(c.v[:, t[i]], want[i][1])
        assert c.parked_total == 1 and c.resumed_total == 1
        assert adopted >= 0
        check_partition(c)

    def test_park_async_offload_worker_and_close(self):
        """The async double buffer: the encode runs off-thread, the
        ready event gates the resume, and close() joins the worker. The
        worker's payloads equal the synchronous path's."""
        c, ref = twin_pools(async_offload=True)
        try:
            assert any(t.name == "tony-kv-offload"
                       for t in threading.enumerate())
            toks = list(range(8))
            for p in (c, ref):
                p.reserve("s", 8)
                for i in range(2):
                    p.write_index("s", i * 4)
            want = [block_of(c, b) for b in c.table("s")]
            c.park("s", 8, keys=self._keys(toks))
            ref.park("s", 8, keys=self._keys(toks))
            c._parked["s"]["ready"].wait()
            ref._parked["s"]["ready"].wait()
            assert c._parked["s"]["blocks"] == ref._parked["s"]["blocks"]
            c.resume("s2", 12, "s")        # waits on the ready event
            t = c.table("s2")
            for i in range(2):
                assert torch.equal(c.k[:, t[i]], want[i][0])
        finally:
            c.close()
            ref.close()
        assert not any(t.name == "tony-kv-offload"
                       for t in threading.enumerate())

    def test_parked_crc_corruption_rejected_record_kept(self):
        c, _ = twin_pools()
        c.reserve("s", 8)
        for i in range(2):
            c.write_index("s", i * 4)
        c.park("s", 8, keys=self._keys(list(range(8))))
        rec = c._parked["s"]
        rec["blocks"][0]["crc"] ^= 1
        snap = cache_snapshot(c)
        with pytest.raises(HandoffError):
            c.resume("s2", 12, "s")
        assert_same_snapshot(cache_snapshot(c), snap)
        rec["blocks"][0]["crc"] ^= 1       # restore: record still good
        assert c.resume("s2", 12, "s") >= 0

    def test_park_tier_off_typed_state_unchanged(self):
        c, _ = twin_pools(host_blocks=0)
        c.reserve("s", 8)
        snap = cache_snapshot(c)
        with pytest.raises(AdmissionError):
            c.park("s", 8, keys=self._keys(list(range(8))))
        assert_same_snapshot(cache_snapshot(c), snap)

    def test_park_validates_geometry(self):
        c, _ = twin_pools()
        c.reserve("s", 8)
        with pytest.raises(ValueError):
            c.park("s", 8, keys=[])        # needs 2 chain keys
        with pytest.raises(ValueError):
            c.park("s", 99, keys=[])       # beyond the held extent
        with pytest.raises(KeyError):
            c.resume("x", 8, "never-parked")
        assert c.unpark("never-parked") == 0


# ---------------------------------------------------------------------------
# Conversation parking: bitwise against a never-parked engine
# ---------------------------------------------------------------------------

class TestParkingParity:
    def test_two_turn_resume_bitwise_and_counted(self, tiny, pair):
        """Turn 2 of a parked conversation resumes from the host tier:
        no prefill launch for the shared history, tokens AND logits
        bitwise the never-parked engine's. An f32 parked engine's tokens
        equal the JAX package's parked engine's."""
        parked = make_engine(tiny, host_blocks=64)
        plain = make_engine(tiny)
        rng = np.random.RandomState(21)
        turns = [list(rng.randint(0, 256, 11)),
                 list(rng.randint(0, 256, 5))]
        got = converse(parked, turns, conv="c1")
        ref = converse(plain, turns, conv=None)
        for g, r in zip(got, ref):
            assert_bitwise(g, r, "two-turn parked vs never-parked")
        assert parked.park_hits == 1 and parked.park_lookups == 2
        s = parked.stats()
        assert s["park_hit_rate"] == 0.5
        assert s["parked_seqs"] == 1.0      # turn 2 re-parked on finish
        assert parked.parked_digest() == ["c1"]
        assert parked.prefill_rows < plain.prefill_rows
        # Against the reference: the same conversation on both packages'
        # parked engines, f32 weights.
        (jm, params), tm = pair
        jeng = JServeEngine(jm, params, host_blocks=64, **ENGINE_KW)
        teng = make_engine(tm, host_blocks=64)
        jout = run_conversation(JEngineFront(jeng), turns, conv="c1")
        tout = converse(teng, turns, conv="c1")
        for g, r in zip(tout, jout):
            assert_close_to_jax(g, r, "parked port vs parked JAX")
        assert teng.park_hits == jeng.park_hits == 1
        assert teng.prefill_rows == jeng.prefill_rows
        # The host record's payloads are the reference's only where the
        # pool bytes are; f32 matmul orders differ, so compare geometry.
        trec = teng.cache._parked[teng._parked["c1"]["rid"]]
        jrec = jeng.cache._parked[jeng._parked["c1"]["rid"]]
        assert trec["keys"] == jrec["keys"] and trec["n"] == jrec["n"]

    @pytest.mark.parametrize("n", [7, 8, 9, 15, 17])
    def test_park_resume_bitwise_ragged_lengths(self, tiny, n):
        """Ragged turn-1 lengths around the block and row-block
        boundaries: partial tail blocks, exact fits and the q_block
        boundary all park and resume bitwise."""
        rng = np.random.RandomState(22 + n)
        parked = make_engine(tiny, host_blocks=64)
        plain = make_engine(tiny)
        turns = [list(rng.randint(0, 256, n)),
                 list(rng.randint(0, 256, 4))]
        got = converse(parked, turns, conv=f"c{n}")
        ref = converse(plain, turns, conv=None)
        for g, r in zip(got, ref):
            assert_bitwise(g, r, f"ragged turn-1 length {n}")
        assert parked.park_hits == 1, f"length {n} must resume"
        parked.cache.close()

    def test_three_turn_conversation_reparks(self, tiny):
        parked = make_engine(tiny, host_blocks=64)
        plain = make_engine(tiny)
        rng = np.random.RandomState(23)
        turns = [list(rng.randint(0, 256, 9)),
                 list(rng.randint(0, 256, 3)),
                 list(rng.randint(0, 256, 5))]
        got = converse(parked, turns, conv="c3", max_new=3)
        ref = converse(plain, turns, conv=None, max_new=3)
        for g, r in zip(got, ref):
            assert_bitwise(g, r, "three-turn conversation")
        assert parked.park_hits == 2

    def test_diverged_turn_drops_record_and_reprefills(self, tiny):
        """A second turn that does not extend the parked history drops
        the record and admits fresh: correct output, no resume."""
        parked = make_engine(tiny, host_blocks=64)
        plain = make_engine(tiny)
        rng = np.random.RandomState(24)
        t1 = list(rng.randint(0, 256, 9))
        converse(parked, [t1], conv="d1")
        edited = list(rng.randint(0, 256, 13))
        edited[0] = (t1[0] + 1) % 256               # not an extension
        got = EngineFront(parked).generate(edited, 4, conv="d1")
        ref = EngineFront(plain).generate(edited, 4)
        assert_bitwise(got, ref, "diverged turn")
        assert parked.park_hits == 0
        assert parked.cache.resumed_total == 0
        assert parked.cache.parked_ids() == [got.rid], \
            "only the new turn's record remains"

    def test_park_composes_with_prefix_cache_shared_stem(self, tiny):
        """Parking + prefix caching: the resumed turn's blocks publish
        back into the prefix tier, a second conversation over the stem
        adopts them, both bitwise against prefix-only engines, and
        nothing strands."""
        parked = make_engine(tiny, host_blocks=64, prefix_cache=True)
        plain = make_engine(tiny, prefix_cache=True)
        rng = np.random.RandomState(25)
        stem = list(rng.randint(0, 256, 8))
        turns = [stem + list(rng.randint(0, 256, 3)),
                 list(rng.randint(0, 256, 4))]
        got = converse(parked, turns, conv="p1")
        ref = converse(plain, turns, conv=None)
        for g, r in zip(got, ref):
            assert_bitwise(g, r, "parked+prefix vs prefix-only")
        t2 = [stem + list(rng.randint(0, 256, 5))]
        got2 = converse(parked, t2, conv="p2")
        ref2 = converse(plain, t2, conv=None)
        assert_bitwise(got2[0], ref2[0], "second conv over shared stem")
        assert parked.prefix_hit_blocks > 0
        check_partition(parked.cache)
        for conv in list(parked._parked):
            rec = parked._parked.pop(conv)
            parked.cache.unpark(rec["rid"])
        assert parked.cache.free_blocks == parked.cache.n_blocks

    def test_spec_engine_parks_and_resumes_bitwise(self, tiny):
        """The speculative lane rides the host tier through the same
        constructor keywords; greedy parity holds across a park."""
        spec = SpecEngine(tiny, spec_k=2, host_blocks=64,
                          **{"device": "cpu", **ENGINE_KW})
        plain = make_engine(tiny)
        rng = np.random.RandomState(26)
        turns = [list(rng.randint(0, 256, 9)),
                 list(rng.randint(0, 256, 4))]
        got = converse(spec, turns, conv="s1")
        ref = converse(plain, turns, conv=None)
        for g, r in zip(got, ref):
            assert g.tokens == r.tokens, "spec parked vs plain"
        assert spec.park_hits == 1
        # Bitwise against the spec engine that never parks.
        spec_plain = SpecEngine(tiny, spec_k=2,
                                **{"device": "cpu", **ENGINE_KW})
        for g, r in zip(got, converse(spec_plain, turns, conv=None)):
            assert_bitwise(g, r, "spec parked vs spec never-parked")

    def test_pool_pressure_on_resume_degrades_to_reprefill(self, tiny):
        """Device pressure at resume: the typed AdmissionError is
        counted (host_degraded), the record dropped, the turn waits and
        re-prefills once the pressure clears — bitwise, never wedged."""
        parked = make_engine(tiny, host_blocks=64)
        plain = make_engine(tiny)
        rng = np.random.RandomState(27)
        turns = [list(rng.randint(0, 256, 9))]
        converse(parked, turns, conv="g1")
        hist = parked._parked["g1"]["tokens"]
        hog_extent = parked.cache.free_blocks * parked.cache.block_size
        parked.cache.reserve("hog", hog_extent)
        turn2 = hist + list(rng.randint(0, 256, 4))
        parked.submit(Request(rid="g1t2", tokens=turn2, max_new_tokens=4,
                              conv="g1"))
        for _ in range(3):
            assert parked.step() == []
        assert parked.host_degraded == 1, "the degrade is counted"
        assert parked._parked == {}, "a failed resume drops the record"
        parked.cache.free_seq("hog")
        got = parked.run()
        ref = EngineFront(plain).generate(turn2, 4)
        assert len(got) == 1
        assert_bitwise(got[0], ref, "post-degrade re-prefill")

    def test_host_tier_off_engine_never_parks(self, tiny):
        eng = make_engine(tiny)
        rng = np.random.RandomState(28)
        converse(eng, [list(rng.randint(0, 256, 9))], conv="x")
        assert eng._parked == {} and eng.cache.parked_total == 0
        assert eng.stats()["parked_seqs"] == 0.0

    def test_resume_scatters_in_place_for_a_captured_step(self, tiny):
        """The resumed blocks land in the stores a captured step reads:
        their addresses survive a park and a resume."""
        eng = make_engine(tiny, host_blocks=64)
        stores = (eng.cache.k_store.data_ptr(),
                  eng.cache.v_store.data_ptr())
        rng = np.random.RandomState(30)
        converse(eng, [list(rng.randint(0, 256, 12)),
                       list(rng.randint(0, 256, 3))], conv="ip")
        assert eng.park_hits == 1
        assert (eng.cache.k_store.data_ptr(),
                eng.cache.v_store.data_ptr()) == stores


# ---------------------------------------------------------------------------
# Disaggregated composition: the decode engine parks, the returning turn
# resumes through its colocated path
# ---------------------------------------------------------------------------

class TestDisaggParking:
    def test_decode_side_park_resume_bitwise(self, tiny):
        """Turn 1 rides the prefill -> decode handoff (conv on the
        payload); the decode engine parks it at eviction. Turn 2 lands
        on the decode replica's own generate with the same conv and
        resumes, bitwise against a never-parked colocated engine, with
        fewer prefill rows."""
        pf_eng = make_engine(tiny, role="prefill")
        dc_eng = make_engine(tiny, role="decode", host_blocks=64)
        plain = make_engine(tiny)
        pf = PrefillFront(EngineFront(pf_eng))
        dc = DecodeFront(EngineFront(dc_eng))
        rng = np.random.RandomState(29)
        t1 = list(rng.randint(0, 256, 9))
        out1 = pf.prefill_handoff(t1, 4, rid="h1", decode=dc,
                                  conv="dconv", tenant="gold")
        ref1 = EngineFront(plain).generate(t1, 4)
        assert_bitwise(out1, ref1, "disagg turn 1")
        assert dc_eng.parked_digest() == ["dconv"], \
            "the decode engine holds the parked conversation"
        assert dc_eng.stats()["tenants"]["gold"]["completed"] == 1.0
        hist = t1 + list(out1.tokens)
        t2 = hist + list(rng.randint(0, 256, 6))
        rows_before = dc_eng.prefill_rows
        out2 = dc.generate(t2, 4, rid="h2", conv="dconv")
        plain_rows_before = plain.prefill_rows
        ref2 = EngineFront(plain).generate(t2, 4)
        assert_bitwise(out2, ref2, "disagg turn 2 resume")
        assert dc_eng.park_hits == 1
        assert dc_eng.prefill_rows - rows_before \
            < plain.prefill_rows - plain_rows_before


# ---------------------------------------------------------------------------
# Persisted prefix store
# ---------------------------------------------------------------------------

class TestPrefixStore:
    def _pools_with_stem(self, tokens):
        pools = twin_pools(n_blocks=8, block_size=4, host_blocks=0)
        keys = prefix.chain_keys(tokens, 4)
        for c in pools:
            c.admit_shared("a", len(tokens), keys)
            for i, key in enumerate(keys):
                c.write_index("a", i * 4)
                c.publish_block("a", i, key)
        return pools, keys

    def test_put_get_round_trip_idempotent(self, tmp_path):
        (c, ref), keys = self._pools_with_stem(list(range(8)))
        blocks = c.export_keys(keys)
        assert blocks == ref.export_keys(keys), \
            "exported stems are the JAX package's, byte for byte"
        store = PrefixStore(str(tmp_path / "stems"))
        assert store.stems() == []
        assert store.put(keys, blocks, c.wire_header()) is True
        assert store.put(keys, blocks, c.wire_header()) is False, \
            "a committed stem is idempotent"
        assert store.stems() == [keys[-1]]
        rec = store.get(keys[-1])
        assert rec is not None
        assert rec["keys"] == list(keys)
        assert rec["header"] == c.wire_header()
        for got, want in zip(rec["blocks"], blocks):
            assert got == want

    def test_put_validates_and_get_rejects_corruption(self, tmp_path):
        (c, _), keys = self._pools_with_stem(list(range(8)))
        blocks = c.export_keys(keys)
        store = PrefixStore(str(tmp_path / "stems"))
        with pytest.raises(ValueError):
            store.put(keys[:1], blocks, c.wire_header())   # len mismatch
        bad = [dict(b) for b in blocks]
        bad[0]["crc"] ^= 1
        with pytest.raises(ValueError):
            store.put(keys, bad, c.wire_header())          # pre-write CRC
        assert store.stems() == []
        store.put(keys, blocks, c.wire_header())
        blob = tmp_path / "stems" / f"stem_{keys[-1]}" / "blocks.bin"
        raw = bytearray(blob.read_bytes())
        raw[3] ^= 1
        blob.write_bytes(bytes(raw))
        assert store.get(keys[-1]) is None

    def test_tmp_staging_is_invisible(self, tmp_path):
        root = tmp_path / "stems"
        store = PrefixStore(str(root))
        (root / "stem_deadbeef.tmp").mkdir(parents=True)
        assert store.stems() == [], \
            "a crashed staging dir must never be listed as committed"
        assert store.get("deadbeef") is None

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_store_crosses_packages(self, writer, tmp_path):
        """A stem written by either package's store loads into the
        other's, and both write the same files."""
        (c, ref), keys = self._pools_with_stem(list(range(12)))
        blocks = c.export_keys(keys)
        roots = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
        PrefixStore(str(roots["port"])).put(keys, blocks, c.wire_header())
        JPrefixStore(str(roots["jax"])).put(keys, ref.export_keys(keys),
                                            ref.wire_header())
        stem = f"stem_{keys[-1]}"
        for name in ("blocks.bin", "stem.json"):
            assert (roots["port"] / stem / name).read_bytes() == \
                (roots["jax"] / stem / name).read_bytes(), name
        reader = (JPrefixStore if writer == "port" else PrefixStore)(
            str(roots[writer]))
        rec = reader.get(keys[-1])
        assert rec is not None and rec["keys"] == list(keys)
        assert rec["blocks"] == blocks
        assert json.loads((roots[writer] / stem / "stem.json")
                          .read_text())["format"] == "tony-kvstem-v1"

    def test_engine_export_adopt_round_trip_bitwise(self, tiny, tmp_path):
        """A hot stem (proved shared by a second prompt) exports to the
        store; a FRESH engine adopts it through the replica's
        ``_load_stems``, holds it bit for bit, and serves the stem's next
        prompt from it: bitwise the exporting engine's own hit, and the
        tokens a cold engine gives."""
        src = make_engine(tiny, prefix_cache=True)
        rng = np.random.RandomState(31)
        stem = list(rng.randint(0, 256, 16))
        front = EngineFront(src)
        front.generate(stem + list(rng.randint(0, 256, 3)), 3)
        front.generate(stem + list(rng.randint(0, 256, 4)), 3)
        store = PrefixStore(str(tmp_path / "stems"))
        with front._drive:
            wrote = src.export_stems(store)
        assert wrote >= 1 and store.stems(), \
            "a twice-proved stem must persist"
        keys = prefix.chain_keys(stem, 8)
        fresh = make_engine(tiny, prefix_cache=True)
        stub = Replica.__new__(Replica)
        stub.engine = fresh
        stub._store = store
        Replica._load_stems(stub)
        assert fresh.store_adopted == len(keys)
        check_partition(fresh.cache)
        for key in keys:
            a = block_of(fresh.cache, fresh.cache._index[key])
            b = block_of(src.cache, src.cache._index[key])
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        probe = stem + list(rng.randint(0, 256, 5))
        got = EngineFront(fresh).generate(probe, 4)
        assert fresh.prefix_hit_blocks > 0, \
            "the adopted stem must actually be hit"
        assert_bitwise(got, front.generate(probe, 4), "adopted vs own hit")
        cold = make_engine(tiny, prefix_cache=True)
        assert got.tokens == EngineFront(cold).generate(probe, 4).tokens

    def test_export_stems_encodes_and_writes_outside_the_drive_lock(
            self, tiny, tmp_path):
        """With ``lock=`` (the replica's publisher), the stem is fetched
        under the drive lock and encoded and written after its release:
        the store's write sees the lock free, the stem is the one an
        export under the caller's lock writes, and the tip is marked
        stored (a second export writes nothing)."""
        src = make_engine(tiny, prefix_cache=True)
        rng = np.random.RandomState(32)
        stem = list(rng.randint(0, 256, 16))
        front = EngineFront(src)
        front.generate(stem + list(rng.randint(0, 256, 3)), 3)
        front.generate(stem + list(rng.randint(0, 256, 4)), 3)
        held = []

        class Watched(PrefixStore):
            def put(self, keys, blocks, header):
                held.append(front._drive.locked())
                return super().put(keys, blocks, header)

        free = Watched(str(tmp_path / "free"))
        assert src.export_stems(free, lock=front._drive) >= 1
        assert held and not any(held), held
        assert src.export_stems(free, lock=front._drive) == 0
        src._stored_tips.clear()
        under = PrefixStore(str(tmp_path / "under"))
        with front._drive:
            assert src.export_stems(under) == len(held)
        assert free.stems() == under.stems()
        for tip in free.stems():
            assert free.get(tip) == under.get(tip)

    def test_load_stems_skips_geometry_mismatch(self, tiny, tmp_path):
        (c, _), keys = self._pools_with_stem(list(range(8)))
        store = PrefixStore(str(tmp_path / "stems"))
        store.put(keys, c.export_keys(keys), c.wire_header())
        eng = make_engine(tiny, prefix_cache=True)   # other geometry
        stub = Replica.__new__(Replica)
        stub.engine = eng
        stub._store = store
        Replica._load_stems(stub)
        assert eng.store_adopted == 0, \
            "a geometry-skewed stem must be skipped, not imported"
        assert eng.cache.free_blocks == eng.cache.n_blocks

    def test_adopt_stem_rejects_bad_input_quietly(self, tiny):
        eng = make_engine(tiny, prefix_cache=True)
        assert eng.adopt_stem([], []) == 0
        assert eng.adopt_stem(["aa"], []) == 0        # length mismatch
        assert eng.adopt_stem(["aa"], [{"k": "", "v": "", "crc": 1}]) == 0
        off = make_engine(tiny)                       # prefix cache off
        assert off.adopt_stem(["aa"], [{}]) == 0


# ---------------------------------------------------------------------------
# Stats surface
# ---------------------------------------------------------------------------

class TestTierStats:
    def test_stats_count_tier_activity(self, tiny):
        eng = make_engine(tiny, host_blocks=64)
        rng = np.random.RandomState(32)
        turns = [list(rng.randint(0, 256, 9)),
                 list(rng.randint(0, 256, 4))]
        converse(eng, turns, conv="st")
        s = eng.stats()
        assert s["parked_seqs"] == 1.0
        assert s["host_blocks"] >= 1.0
        assert s["park_hit_rate"] == 0.5
        assert set(eng.parked_digest()) == {"st"}
        plain = make_engine(tiny).stats()
        for key in ("host_blocks", "parked_seqs", "demotions",
                    "promotions", "park_hit_rate", "daemon_demotions",
                    "qos_deferrals", "admission_rejections"):
            assert plain[key] == 0.0, key
        assert plain["tenants"] == {}

    def test_write_stats_carries_parked_digest(self, tiny, tmp_path):
        eng = make_engine(tiny, host_blocks=64)
        rng = np.random.RandomState(33)
        converse(eng, [list(rng.randint(0, 256, 9))], conv="wd")
        path = tmp_path / "serve-stats.json"
        eng.write_stats(str(path))
        payload = json.loads(path.read_text())
        assert payload["parked_digest"] == ["wd"]
        assert payload["parked_seqs"] == 1.0
        # The heartbeat's normalizer (the executor's reader) keeps the
        # digest and the tenants breakdown; the router pins the
        # conversation to the replica that parked it.
        from tony_tpu_torch.serve.router import RequestRouter
        from tony_tpu_torch.util import normalize_serve_telemetry

        wire = normalize_serve_telemetry(payload)
        assert wire["parked_digest"] == ["wd"]
        assert wire["tenants"] == {}
        router = RequestRouter(block_size=8)
        router.upsert_replica("a", client=object(), stats={})
        router.upsert_replica("b", client=object(), stats=wire)
        assert router.route([1, 2, 3], session_id="wd") == "b"

    def test_demotion_daemon_demotes_and_promotes_bitwise(self, tiny):
        """Above the watermark each step demotes cold cached blocks to
        the host; a later prompt over a demoted stem promotes it back,
        and every stream is bitwise a host-tier-off engine's."""
        kw = dict(prefix_cache=True, n_blocks=16)
        eng = make_engine(tiny, host_blocks=64, demote_watermark=0.25,
                          demote_batch=4, **kw)
        off = make_engine(tiny, **kw)
        rng = np.random.RandomState(34)
        stem = list(rng.randint(0, 256, 24))
        # The stem's blocks retire to the cached tier; two long
        # unrelated prompts hold the pool past the watermark, so the
        # daemon demotes them; the stem's next prompt promotes them.
        prompts = [stem + list(rng.randint(0, 256, 3))]
        prompts += [list(rng.randint(0, 256, 28)) for _ in range(2)]
        prompts += [stem + list(rng.randint(0, 256, 4))]
        for p in prompts:
            assert_bitwise(EngineFront(eng).generate(p, 4),
                           EngineFront(off).generate(p, 4),
                           "daemon engine vs host-tier-off engine")
        s = eng.stats()
        assert eng.daemon_demotions > 0 and s["daemon_demotions"] > 0
        assert s["demotions"] >= eng.daemon_demotions
        assert s["promotions"] > 0
        check_partition(eng.cache)

    def test_swap_flushes_stems_keeps_parked(self, tiny):
        """A weight swap flushes the device index and the host stems
        (rows of the old weights) and keeps parked conversations."""
        eng = make_engine(tiny, host_blocks=64, prefix_cache=True)
        rng = np.random.RandomState(35)
        stem = list(rng.randint(0, 256, 16))
        converse(eng, [stem + [1, 2]], conv="sw")
        EngineFront(eng).generate(stem + [3, 4], 3)
        eng.cache.demote(64)
        assert eng.cache.host_keys() and eng._hot_tips
        live = dict(tiny.named_parameters())
        eng.swap_params({k: v.detach().clone() for k, v in live.items()},
                        version=1, step=1)
        assert eng.cache.host_keys() == [] and eng.cache.digest() == []
        assert not eng._hot_tips and not eng._chain_parent
        assert eng.parked_digest() == ["sw"]
