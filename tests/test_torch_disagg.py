"""Port parity for disaggregated prefill/decode serving
(tony_tpu_torch.serve.disagg, the wire tier of .kvcache, the engine's
prefill-only and handoff-admission paths, the replica's handoff verbs and
``cli serve --role``): the reference's tests/test_disagg.py rebuilt on
the port — the wire tier's round trip and typed, state-unchanged
rejections; every disaggregated path's tokens AND per-token logits
``np.array_equal`` to the port's own colocated engine; the failure
split; role-aware routing; the heartbeat schema; the handoff over the
port's RPC. Against the JAX package: blocks exported by either pool
import into the other with equal bytes, the wire headers are equal, and
a prefill on either engine ships to the other's decode engine (f32:
equal tokens, logits within the 1e-4 tests/test_torch_serve.py holds
the engines to). llama-tiny, 2 layers, ctx_max 64, blocks of 8, on the
CPU."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from tony_tpu.models import get_model as jax_model
from tony_tpu.serve import EngineFront as JEngineFront
from tony_tpu.serve import PagedKVCache as JPagedKVCache
from tony_tpu.serve import Request as JRequest
from tony_tpu.serve import ServeEngine as JServeEngine
from tony_tpu.serve.disagg import DecodeFront as JDecodeFront
from tony_tpu.serve.disagg import PrefillFront as JPrefillFront
from tony_tpu_torch import rpc as rpc_mod
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params
from tony_tpu_torch.serve import (AdmissionError, EngineFront, HandoffError,
                                  KVShipper, PagedKVCache, Request,
                                  RequestRouter, ServeEngine, SpecEngine,
                                  prefix)
from tony_tpu_torch.serve.disagg import DecodeFront, PrefillFront

ENGINE_KW = dict(ctx_max=64, block_size=8, q_block=16, decode_buckets=(2, 4),
                 max_running=4, keep_logits=True, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    """The port's tiny decoder with bf16 weights and compute (the
    reference's tests serve bf16 params)."""
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
    return ServeEngine(model, **{**ENGINE_KW, **kw})


def run_requests(eng, prompts, max_new=4):
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=[int(t) for t in p],
                           max_new_tokens=max_new))
    return {c.rid: c for c in eng.run()}


def disagg_requests(model, prompts, max_new=4, *, prefill_kw=None,
                    decode_kw=None, spec_k=0):
    """Prefill engine -> KV handoff -> decode engine, per request;
    returns (completions, prefill engine, decode engine)."""
    pf_eng = make_engine(model, role="prefill", **(prefill_kw or {}))
    if spec_k:
        dc_eng = SpecEngine(model, spec_k=spec_k, role="decode",
                            **{**ENGINE_KW, **(decode_kw or {})})
    else:
        dc_eng = make_engine(model, role="decode", **(decode_kw or {}))
    pf = PrefillFront(EngineFront(pf_eng))
    dc = DecodeFront(EngineFront(dc_eng))
    done = {i: pf.prefill_handoff([int(t) for t in p], max_new, rid=i,
                                  decode=dc)
            for i, p in enumerate(prompts)}
    return done, pf_eng, dc_eng


def assert_bitwise_equal(got, ref):
    """Token streams AND per-token logits of two completion maps."""
    assert sorted(got) == sorted(ref)
    for rid in ref:
        assert got[rid].tokens == ref[rid].tokens, rid
        assert len(got[rid].logits) == len(ref[rid].logits)
        for a, b in zip(got[rid].logits, ref[rid].logits):
            assert np.array_equal(a, b), rid


def cache_snapshot(c):
    return (dict(c._refs), list(c._free), c.cached_blocks(),
            {s: list(t) for s, t in c.owned_blocks().items()},
            dict(c._index), c.imported_total,
            c.k_store.clone(), c.v_store.clone())


def assert_same_snapshot(a, b):
    assert a[:6] == b[:6]
    assert torch.equal(a[6], b[6]) and torch.equal(a[7], b[7])


def prefill_payload(eng, tokens, rid="r", max_new=4):
    with EngineFront(eng)._drive:
        return eng.prefill_only(Request(rid=rid, tokens=list(tokens),
                                        max_new_tokens=max_new))


# ---------------------------------------------------------------------------
# The KV wire tier (kvcache export/import)
# ---------------------------------------------------------------------------

class TestWireTier:
    def _pool(self, n_blocks=8, block_size=4, kv_dim=4,
              dtype=torch.float32):
        return PagedKVCache(2, kv_dim, n_blocks=n_blocks,
                            block_size=block_size, dtype=dtype,
                            device="cpu")

    def _fill(self, c, sid, length):
        """Reserve and write recognizable bytes for ``length``
        positions."""
        c.reserve(sid, length)
        for b in c.table(sid):
            c.k[:, b] = float(b + 1)
            c.v[:, b] = float(-(b + 1))
        return c.table(sid)

    def test_export_import_round_trips_bytes(self):
        src = self._pool()
        self._fill(src, "s", 7)
        blocks = src.export_blocks("s", 7)
        assert len(blocks) == 2 and all("crc" in b for b in blocks)
        dst = self._pool()
        keys = prefix.chain_keys(list(range(7)), 4)
        adopted = dst.import_blocks("d", 11, blocks, keys=keys, offset=0)
        assert adopted == 0 and dst.imported_total == 2
        st, dt = src.table("s"), dst.table("d")
        for i in range(2):
            assert torch.equal(src.k[:, st[i]], dst.k[:, dt[i]])
            assert torch.equal(src.v[:, st[i]], dst.v[:, dt[i]])
        assert len(dt) == dst.blocks_for(11)

    def test_import_writes_the_stores_in_place(self):
        """The bytes land in ``k_store``/``v_store`` themselves (one
        ``index_copy_`` a pool): the step and its captured graphs read
        those stores' addresses, and a rebind would leave them stale."""
        src = self._pool(dtype=torch.bfloat16)
        self._fill(src, "s", 8)
        dst = self._pool(dtype=torch.bfloat16)
        ptrs = (dst.k_store.data_ptr(), dst.v_store.data_ptr())
        k_view, v_view = dst.k, dst.v
        dst.import_blocks("d", 8, src.export_blocks("s", 8))
        assert (dst.k_store.data_ptr(), dst.v_store.data_ptr()) == ptrs
        assert dst.k is k_view and dst.v is v_view
        for a, b in zip(src.table("s"), dst.table("d")):
            assert torch.equal(k_view[:, b], src.k[:, a])

    def test_corrupt_crc_is_typed_and_state_unchanged(self):
        src = self._pool()
        self._fill(src, "s", 8)
        blocks = src.export_blocks("s", 8)
        blocks[1] = dict(blocks[1], crc=(blocks[1]["crc"] ^ 1))
        dst = self._pool()
        snap = cache_snapshot(dst)
        with pytest.raises(HandoffError) as ei:
            dst.import_blocks("d", 8, blocks)
        assert not ei.value.retryable
        assert_same_snapshot(cache_snapshot(dst), snap)

    def test_pool_pressure_is_admission_error_state_unchanged(self):
        src = self._pool()
        self._fill(src, "s", 8)
        blocks = src.export_blocks("s", 8)
        dst = self._pool(n_blocks=4)
        dst.reserve("hog", 12)          # 3 of 4 blocks
        snap = cache_snapshot(dst)
        with pytest.raises(AdmissionError) as ei:
            dst.import_blocks("d", 8, blocks)
        assert ei.value.retryable
        assert_same_snapshot(cache_snapshot(dst), snap)
        dst.free_seq("hog")
        assert dst.import_blocks("d", 8, blocks) == 0   # heals

    def test_import_adopts_offered_stem_not_rewritten(self):
        stem = list(range(8))           # 2 full blocks of 4
        keys = prefix.chain_keys(stem, 4)
        src = self._pool()
        self._fill(src, "s", 10)
        blocks = src.export_blocks("s", 10)
        dst = self._pool()
        dst.import_blocks("prior", 8, blocks[:2])
        for i, key in enumerate(keys):
            dst.publish_block("prior", i, key)
        imported_before = dst.imported_total
        offset = len(dst.match_prefix(keys))
        assert offset == 2
        adopted = dst.import_blocks("d", 12, blocks[offset:], keys=keys,
                                    offset=offset)
        assert adopted == 2
        assert dst.imported_total - imported_before == 1   # only the tail
        t_prior, t_d = dst.table("prior"), dst.table("d")
        assert t_d[:2] == t_prior[:2]
        assert all(dst.ref(b) == 2 for b in t_d[:2])
        dst.write_index("d", 0)         # a write into an adopted block
        assert dst.table("d")[0] != t_prior[0], "COW must repoint"
        assert dst.ref(t_prior[0]) == 1

    def test_evaporated_offer_is_retryable_with_matched_count(self):
        src = self._pool()
        self._fill(src, "s", 8)
        blocks = src.export_blocks("s", 8)
        keys = prefix.chain_keys(list(range(8)), 4)
        dst = self._pool()
        snap = cache_snapshot(dst)
        with pytest.raises(HandoffError) as ei:
            dst.import_blocks("d", 8, blocks[2:], keys=keys, offset=2)
        assert ei.value.retryable and ei.value.matched == 0
        assert_same_snapshot(cache_snapshot(dst), snap)

    @pytest.mark.parametrize("other", [
        dict(kv_dim=8), dict(dtype=torch.bfloat16), dict(block_size=8)],
        ids=["kv_dim", "dtype", "block_size"])
    def test_geometry_mismatch_is_non_retryable(self, other):
        src = self._pool()
        self._fill(src, "s", 4)
        blocks = src.export_blocks("s", 4)
        dst = self._pool(**other)
        snap = cache_snapshot(dst)
        with pytest.raises(HandoffError) as ei:
            dst.import_blocks("d", 4, blocks)
        assert not ei.value.retryable
        assert src.wire_header() != dst.wire_header()
        assert_same_snapshot(cache_snapshot(dst), snap)

    def test_shipper_bounded_retry_reships_missing_tail(self):
        calls = []

        class FlakyDecode:
            def kv_offer(self, keys):
                return 2                      # stale promise

            def kv_import(self, payload):
                calls.append((payload["offset"], len(payload["blocks"])))
                if len(calls) == 1:
                    raise HandoffError("evaporated", matched=1)
                return {"rid": payload.get("rid"), "tokens": [1]}

        handoff = {"keys": ["a", "b", "c"],
                   "blocks": [{"n": i} for i in range(3)]}
        out, shipped = KVShipper(max_attempts=3, backoff_s=0.0).ship(
            handoff, FlakyDecode())
        assert out["tokens"] == [1]
        assert shipped == 2
        assert calls == [(2, 1), (1, 2)]

        class AlwaysFull:
            def kv_offer(self, keys):
                return 0

            def kv_import(self, payload):
                raise HandoffError("pool full")

        with pytest.raises(HandoffError) as ei:
            KVShipper(max_attempts=3, backoff_s=0.0).ship(
                handoff, AlwaysFull())
        assert not ei.value.retryable
        assert "after 3 attempt(s)" in str(ei.value)

        class Corrupt:
            def kv_offer(self, keys):
                return 0

            def kv_import(self, payload):
                raise HandoffError("crc mismatch", retryable=False)

        with pytest.raises(HandoffError) as ei:
            KVShipper(max_attempts=3, backoff_s=0.0).ship(
                handoff, Corrupt())
        assert "after 1 attempt(s)" in str(ei.value)


# ---------------------------------------------------------------------------
# The wire against the JAX package's
# ---------------------------------------------------------------------------

class TestWireAcrossPackages:
    @pytest.mark.parametrize("tdt,jdt", [(torch.bfloat16, jnp.bfloat16),
                                         (torch.float32, jnp.float32)],
                             ids=["bf16", "f32"])
    def test_wire_header_equal(self, tdt, jdt):
        ours = PagedKVCache(2, 8, n_blocks=4, block_size=4, dtype=tdt,
                            device="cpu")
        ref = JPagedKVCache(2, 8, n_blocks=4, block_size=4, dtype=jdt)
        assert ours.wire_header() == ref.wire_header()

    def _bits(self, t):
        """A pool tensor's bytes as numpy (bf16 through int16)."""
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()

    def _jbits(self, a):
        a = np.asarray(a)
        return a.view(np.int16) if a.dtype.itemsize == 2 else a

    @pytest.mark.parametrize("tdt,jdt", [(torch.bfloat16, jnp.bfloat16),
                                         (torch.float32, jnp.float32)],
                             ids=["bf16", "f32"])
    def test_blocks_cross_both_ways_with_equal_bytes(self, tdt, jdt):
        rng = np.random.RandomState(3)
        ours = PagedKVCache(2, 8, n_blocks=6, block_size=4, dtype=tdt,
                            device="cpu")
        ours.reserve("s", 11)
        with torch.no_grad():
            ours.k.copy_(torch.from_numpy(
                rng.randn(*ours.k.shape).astype(np.float32)).to(tdt))
            ours.v.copy_(torch.from_numpy(
                rng.randn(*ours.v.shape).astype(np.float32)).to(tdt))
        blocks = ours.export_blocks("s", 11)
        ref = JPagedKVCache(2, 8, n_blocks=6, block_size=4, dtype=jdt)
        ref.reserve("pad", 4)           # the import lands elsewhere
        ref.import_blocks("d", 11, blocks)
        for a, b in zip(ours.table("s"), ref.table("d")):
            assert np.array_equal(self._bits(ours.k[:, a]),
                                  self._jbits(ref.k[:, b]))
            assert np.array_equal(self._bits(ours.v[:, a]),
                                  self._jbits(ref.v[:, b]))
        # And back: the JAX export imports into a fresh port pool.
        back = PagedKVCache(2, 8, n_blocks=6, block_size=4, dtype=tdt,
                            device="cpu")
        back.reserve("pad", 8)
        jblocks = ref.export_blocks("d", 11)
        assert jblocks == blocks, "one wire: the same payload bytes"
        back.import_blocks("e", 11, jblocks)
        for a, b in zip(ours.table("s"), back.table("e")):
            assert torch.equal(ours.k[:, a], back.k[:, b])
            assert torch.equal(ours.v[:, a], back.v[:, b])


class TestHandoffAcrossPackages:
    """A prefill on one package's engine ships to the other's decode
    engine through the JAX fronts (f32 weights converted with
    models/convert.py)."""

    def _prompts(self):
        rng = np.random.RandomState(21)
        return [[int(t) for t in rng.randint(0, 256, n)] for n in (9, 17)]

    def _jax_engine(self, pair, **kw):
        (jm, params), _ = pair
        kw = {k: v for k, v in {**ENGINE_KW, **kw}.items() if k != "device"}
        return JServeEngine(jm, params, **kw)

    def _port_engine(self, pair, **kw):
        return make_engine(pair[1], **kw)

    def _reference(self, pair, prompts):
        eng = self._jax_engine(pair)
        for i, p in enumerate(prompts):
            eng.submit(JRequest(rid=i, tokens=p, max_new_tokens=4))
        return {c.rid: c for c in eng.run()}

    def _close(self, got, ref):
        for rid in ref:
            assert got[rid].tokens == ref[rid].tokens, rid
            assert len(got[rid].logits) == len(ref[rid].logits)
            for a, b in zip(got[rid].logits, ref[rid].logits):
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)

    def test_port_prefill_to_jax_decode(self, pair):
        prompts = self._prompts()
        ref = self._reference(pair, prompts)
        pf_eng = self._port_engine(pair, role="prefill")
        pf = PrefillFront(EngineFront(pf_eng))
        dc = JDecodeFront(JEngineFront(self._jax_engine(pair,
                                                        role="decode")))
        got = {i: pf.prefill_handoff(p, 4, rid=i, decode=dc)
               for i, p in enumerate(prompts)}
        self._close(got, ref)
        assert pf_eng.handoffs_out == 2
        assert pf_eng.blocks_shipped == sum(-(-len(p) // 8) for p in prompts)

    def test_jax_prefill_to_port_decode(self, pair):
        prompts = self._prompts()
        ref = self._reference(pair, prompts)
        dc_eng = self._port_engine(pair, role="decode")
        pf = JPrefillFront(JEngineFront(self._jax_engine(pair,
                                                         role="prefill")))
        dc = DecodeFront(EngineFront(dc_eng))
        got = {i: pf.prefill_handoff(p, 4, rid=i, decode=dc)
               for i, p in enumerate(prompts)}
        self._close(got, ref)
        assert dc_eng.handoffs_in == 2
        assert dc_eng.cache.free_blocks == dc_eng.cache.n_blocks


# ---------------------------------------------------------------------------
# Engine-level bitwise pins vs the colocated engine
# ---------------------------------------------------------------------------

class TestDisaggBitwise:
    def test_ragged_lengths_bitwise_vs_colocated(self, tiny):
        rng = np.random.RandomState(0)
        prompts = [list(rng.randint(0, 256, n)) for n in (7, 8, 9, 15, 17)]
        ref = run_requests(make_engine(tiny), prompts, max_new=5)
        got, pf_eng, dc_eng = disagg_requests(tiny, prompts, max_new=5)
        assert_bitwise_equal(got, ref)
        assert dc_eng.handoffs_in == len(prompts)
        assert dc_eng.cache.imported_total > 0
        # Both pools drain: the prefill side frees at export, decode at
        # eviction.
        assert pf_eng.cache.free_blocks == pf_eng.cache.n_blocks
        assert dc_eng.cache.free_blocks == dc_eng.cache.n_blocks

    def test_chunked_prefill_family_bitwise(self, tiny):
        rng = np.random.RandomState(1)
        prompts = [list(rng.randint(0, 256, n)) for n in (9, 17, 33)]
        ref = run_requests(make_engine(tiny), prompts, max_new=4)
        got, pf_eng, _ = disagg_requests(
            tiny, prompts, max_new=4, prefill_kw={"prefill_chunk": 16})
        assert_bitwise_equal(got, ref)
        assert pf_eng.prefill_chunks >= 4

    def test_hit_and_miss_admissions_bitwise(self, tiny):
        rng = np.random.RandomState(2)
        stem = list(rng.randint(0, 256, 16))    # 2 full blocks of 8
        prompts = [stem + list(rng.randint(0, 256, 5)),
                   stem + list(rng.randint(0, 256, 9)),
                   list(rng.randint(0, 256, 11)),   # miss
                   stem[:8] + list(rng.randint(0, 256, 3))]
        ref = run_requests(make_engine(tiny), prompts, max_new=5)
        got, pf_eng, dc_eng = disagg_requests(
            tiny, prompts, max_new=5,
            prefill_kw={"prefix_cache": True},
            decode_kw={"prefix_cache": True})
        assert_bitwise_equal(got, ref)
        assert pf_eng.prefix_hit_blocks > 0, "prefill-side hits"
        assert dc_eng.cache.adopted_total > 0, "decode-side adoption"
        covered = sum(pf_eng.cache.blocks_for(len(p)) for p in prompts)
        assert pf_eng.blocks_shipped < covered

    def test_spec_lane_on_decode_side_bitwise(self, tiny):
        rng = np.random.RandomState(3)
        prompts = [list(rng.randint(0, 256, n)) for n in (7, 12, 17)]
        ref = run_requests(make_engine(tiny), prompts, max_new=6)
        got, _, dc_eng = disagg_requests(tiny, prompts, max_new=6,
                                         spec_k=4)
        assert_bitwise_equal(got, ref)
        assert dc_eng.verify_launches > 0
        assert dc_eng.cache.free_blocks == dc_eng.cache.n_blocks

    def test_mismatched_chain_keys_reject_before_poisoning_index(self, tiny):
        pf_eng = make_engine(tiny, role="prefill")
        dc_eng = make_engine(tiny, role="decode", prefix_cache=True)
        dc = DecodeFront(EngineFront(dc_eng))
        rng = np.random.RandomState(14)
        payload = prefill_payload(pf_eng, rng.randint(0, 256, 17))
        payload["keys"] = ["deadbeef" * 2] * len(payload["keys"])
        snap = cache_snapshot(dc_eng.cache)
        with pytest.raises(HandoffError) as ei:
            dc.kv_import(payload)
        assert not ei.value.retryable
        assert_same_snapshot(cache_snapshot(dc_eng.cache), snap)
        assert dc_eng.cache.match_prefix(payload["keys"]) == []

    def test_corrupt_logits_rejects_typed_and_state_unchanged(self, tiny):
        pf_eng = make_engine(tiny, role="prefill")
        dc_eng = make_engine(tiny, role="decode")
        dc = DecodeFront(EngineFront(dc_eng))
        rng = np.random.RandomState(12)
        payload = prefill_payload(pf_eng, rng.randint(0, 256, 9))
        payload["logits_b64"] = payload["logits_b64"][:-3]   # corrupt
        snap = cache_snapshot(dc_eng.cache)
        with pytest.raises(HandoffError) as ei:
            dc.kv_import(payload)
        assert not ei.value.retryable
        assert dc_eng.imports_failed == 1
        assert_same_snapshot(cache_snapshot(dc_eng.cache), snap)

    def test_max_new_one_degenerate_handoff(self, tiny):
        rng = np.random.RandomState(4)
        prompts = [list(rng.randint(0, 256, 9))]
        ref = run_requests(make_engine(tiny), prompts, max_new=1)
        got, _, dc_eng = disagg_requests(tiny, prompts, max_new=1)
        assert_bitwise_equal(got, ref)
        assert dc_eng.cache.free_blocks == dc_eng.cache.n_blocks
        assert dc_eng.forwards == 0, \
            "a one-token handoff costs the decode side no launch"

    def test_long_prompt_handoff_bitwise(self, tiny):
        """A prompt near the context extent: chunked prefill and an
        8-block ship."""
        rng = np.random.RandomState(11)
        prompts = [list(rng.randint(0, 256, 57))]   # 8 blocks of 8
        ref = run_requests(make_engine(tiny), prompts, max_new=4)
        got, pf_eng, dc_eng = disagg_requests(
            tiny, prompts, max_new=4, prefill_kw={"prefill_chunk": 16})
        assert_bitwise_equal(got, ref)
        assert pf_eng.blocks_shipped == 8
        assert dc_eng.cache.imported_total == 8

    def test_warmed_decode_engine_reads_the_import(self, tiny):
        """After ``warm()`` (the resolved steps; captured graphs on the
        card) the import lands where the resolved steps read."""
        rng = np.random.RandomState(15)
        prompts = [list(rng.randint(0, 256, n)) for n in (9, 20)]
        ref = run_requests(make_engine(tiny), prompts, max_new=5)
        got, _, dc_eng = disagg_requests(tiny, prompts, max_new=5,
                                         decode_kw={"prefill_chunk": 16})
        assert_bitwise_equal(got, ref)
        warmed = make_engine(tiny, role="decode")
        assert warmed.warm() > 0
        pf = PrefillFront(EngineFront(make_engine(tiny, role="prefill")))
        dc = DecodeFront(EngineFront(warmed))
        again = {i: pf.prefill_handoff([int(t) for t in p], 5, rid=i,
                                       decode=dc)
                 for i, p in enumerate(prompts)}
        assert_bitwise_equal(again, ref)

    def test_unported_request_tags_refused(self, tiny):
        """A handoff's ``conv`` and ``tenant`` tags (once refused, before
        the host tier and QoS were ported) ride the payload: the decode
        engine admits the turn under them, parks it at eviction on a
        host tier, counts it under its tenant, and its tokens and logits
        are the untagged handoff's."""
        rng = np.random.RandomState(16)
        prompt = [int(t) for t in rng.randint(0, 256, 9)]
        ref, _, _ = disagg_requests(tiny, [prompt], max_new=4)
        pf_eng = make_engine(tiny, role="prefill")
        payload = prefill_payload(pf_eng, prompt, rid="t")
        assert payload["conv"] is None and payload["tenant"] is None
        dc_eng = make_engine(tiny, role="decode", host_blocks=16)
        dc = DecodeFront(EngineFront(dc_eng))
        out = PrefillFront(EngineFront(pf_eng)).prefill_handoff(
            prompt, 4, rid="t2", decode=dc, conv="c-1", tenant="gold")
        assert_bitwise_equal({0: out}, ref)
        assert dc_eng.parked_digest() == ["c-1"]
        assert dc_eng.stats()["tenants"]["gold"]["completed"] == 1.0
        assert pf_eng.cache.free_blocks == pf_eng.cache.n_blocks
        assert dc_eng.imports_failed == 0


# ---------------------------------------------------------------------------
# Failure semantics: bounded retry, fallback, the failover split
# ---------------------------------------------------------------------------

class TestHandoffFailure:
    def test_pressure_rejects_state_unchanged_then_heals(self, tiny):
        pf_eng = make_engine(tiny, role="prefill")
        dc_eng = make_engine(tiny, role="decode", n_blocks=4)
        dc = DecodeFront(EngineFront(dc_eng))
        dc_eng.cache.reserve("hog", 16)     # 2 of 4 blocks
        rng = np.random.RandomState(5)
        p = [int(t) for t in rng.randint(0, 256, 12)]   # 3-block extent
        snap = cache_snapshot(dc_eng.cache)
        pf = PrefillFront(EngineFront(pf_eng),
                          shipper=KVShipper(max_attempts=3, backoff_s=0.0))
        with pytest.raises(HandoffError) as ei:
            pf.prefill_handoff(p, 5, rid="r", decode=dc)
        assert not ei.value.retryable
        assert dc_eng.imports_failed == 3, "every bounded attempt counted"
        assert_same_snapshot(cache_snapshot(dc_eng.cache), snap)
        assert pf_eng.cache.free_blocks == pf_eng.cache.n_blocks
        dc_eng.cache.free_seq("hog")
        out = pf.prefill_handoff(p, 5, rid="r2", decode=dc)
        ref = run_requests(make_engine(tiny), [p], max_new=5)
        assert out.tokens == ref[0].tokens

    def test_prefill_pool_pressure_falls_back_colocated(self, tiny):
        pf_eng = make_engine(tiny, role="prefill", n_blocks=4)
        dc_eng = make_engine(tiny, role="decode")
        pf_eng.cache.reserve("hog", 24)     # 3 of 4 blocks
        pf = PrefillFront(EngineFront(pf_eng))
        dc = DecodeFront(EngineFront(dc_eng))
        rng = np.random.RandomState(7)
        p = [int(t) for t in rng.randint(0, 256, 12)]   # 2 blocks, 1 free
        with pytest.raises(HandoffError) as ei:
            pf.prefill_handoff(p, 5, rid="r", decode=dc)
        assert not ei.value.retryable
        router = RequestRouter(block_size=8)
        router.upsert_replica("prefill:0", client=pf, stats=pf_eng.stats())
        router.upsert_replica("decode:0", client=dc, stats=dc_eng.stats())
        out = router.dispatch(p, 5, rid="r2")
        assert out["replica"] == "decode:0"
        assert router.stats()["handoff_fallbacks"] == 1
        assert router.stats()["failovers"] == 0
        ref = run_requests(make_engine(tiny), [p], max_new=5)
        assert out["tokens"] == ref[0].tokens
        big = [int(t) for t in rng.randint(0, 256, 40)]  # 5 blocks > 4
        with pytest.raises(AdmissionError) as ei2:
            pf.prefill_handoff(big, 5, rid="r3", decode=dc)
        assert not ei2.value.retryable

    def test_missing_payload_field_rejects_typed(self, tiny):
        dc_eng = make_engine(tiny, role="decode")
        snap = cache_snapshot(dc_eng.cache)
        base = {"rid": "r", "tokens": [1, 2, 3], "max_new_tokens": 4,
                "first_token": 5, "length": 3, "keys": [], "blocks": [],
                **dc_eng.cache.wire_header()}
        bad = []
        for missing in ("rid", "tokens", "max_new_tokens", "first_token"):
            payload = dict(base)
            del payload[missing]
            bad.append(payload)
        bad.append(dict(base, tokens=None))          # mistyped
        for payload in bad:
            with pytest.raises(HandoffError) as ei:
                dc_eng.admit_handoff(payload)
            assert not ei.value.retryable
        assert dc_eng.imports_failed == len(bad)
        assert_same_snapshot(cache_snapshot(dc_eng.cache), snap)

    def test_truncated_blocks_reject_typed(self, tiny):
        pf_eng = make_engine(tiny, role="prefill")
        dc_eng = make_engine(tiny, role="decode")
        rng = np.random.RandomState(9)
        payload = prefill_payload(pf_eng, rng.randint(0, 256, 12))
        snap = cache_snapshot(dc_eng.cache)
        for bad in (dict(payload, blocks=payload["blocks"][:-1]),
                    {k: v for k, v in payload.items() if k != "blocks"}):
            with pytest.raises(HandoffError) as ei:
                dc_eng.admit_handoff(bad)
            assert not ei.value.retryable
        assert_same_snapshot(cache_snapshot(dc_eng.cache), snap)

    def test_rid_collision_rejects_typed_and_minted_rids_unique(
            self, tiny):
        pf_eng = make_engine(tiny, role="prefill")
        dc_eng = make_engine(tiny, role="decode")
        f1, f2 = EngineFront(pf_eng), EngineFront(dc_eng)
        rids = {f1.fresh_rid() for _ in range(4)} \
            | {f2.fresh_rid() for _ in range(4)}
        assert len(rids) == 8, "two fronts must not share a namespace"
        rng = np.random.RandomState(10)
        payload = prefill_payload(pf_eng, rng.randint(0, 256, 12),
                                  rid="dup")
        dc_eng.cache.reserve("dup", 8)     # a live holder of the rid
        snap = cache_snapshot(dc_eng.cache)
        with pytest.raises(HandoffError) as ei:
            dc_eng.admit_handoff(payload)
        assert not ei.value.retryable
        assert_same_snapshot(cache_snapshot(dc_eng.cache), snap)

    def test_router_falls_back_to_colocated_on_decode(self, tiny):
        pf_eng = make_engine(tiny, role="prefill")
        dc_eng = make_engine(tiny, role="decode")

        class PressuredDecode(DecodeFront):
            imports = 0

            def kv_import(self, payload):
                PressuredDecode.imports += 1
                raise AdmissionError("decode pool exhausted",
                                     needed_blocks=3, free_blocks=0)

        router = RequestRouter(block_size=8)
        router.upsert_replica(
            "prefill:0",
            client=PrefillFront(EngineFront(pf_eng),
                                shipper=KVShipper(max_attempts=2,
                                                  backoff_s=0.0)),
            stats=pf_eng.stats())
        router.upsert_replica(
            "decode:0", client=PressuredDecode(EngineFront(dc_eng)),
            stats=dc_eng.stats())
        rng = np.random.RandomState(6)
        p = [int(t) for t in rng.randint(0, 256, 12)]
        out = router.dispatch(p, 5, rid="r")
        assert PressuredDecode.imports == 2, "bounded shipping budget"
        assert out["replica"] == "decode:0"
        assert router.stats()["handoff_fallbacks"] == 1
        assert router.stats()["failovers"] == 0
        ref = run_requests(make_engine(tiny), [p], max_new=5)
        assert out["tokens"] == ref[0].tokens

    def test_prefill_transport_fault_fails_over(self, tiny):
        """A dead prefill replica (OSError) is down-marked and the request
        re-dispatches to the live one; request-level errors propagate.
        Sessionless: the port's fronts refuse the session's ``conv``
        (the host tier is not ported)."""
        class DeadPrefill:
            def prefill_handoff(self, tokens, max_new_tokens, rid=None,
                                decode=None, conv=None):
                raise ConnectionRefusedError("replica gone")

        pf_eng = make_engine(tiny, role="prefill")
        dc_eng = make_engine(tiny, role="decode")
        router = RequestRouter(block_size=8)
        router.upsert_replica("prefill:0", client=DeadPrefill(),
                              stats={"role": "prefill", "queue_depth": 0.0})
        router.upsert_replica("prefill:1",
                              client=PrefillFront(EngineFront(pf_eng)),
                              stats={**pf_eng.stats(), "queue_depth": 2.0})
        router.upsert_replica("decode:0",
                              client=DecodeFront(EngineFront(dc_eng)),
                              stats=dc_eng.stats())
        rng = np.random.RandomState(7)
        p = [int(t) for t in rng.randint(0, 256, 9)]
        out = router.dispatch(p, 4, rid="r")
        assert out["prefill_replica"] == "prefill:1"
        assert router.stats()["failovers"] >= 1
        assert not [v for v in router.replicas()
                    if v.name == "prefill:0"][0].alive
        with pytest.raises(AdmissionError):
            router.dispatch([int(t) for t in rng.randint(0, 256, 30)], 60,
                            rid="r2")
        assert [v for v in router.replicas()
                if v.name == "prefill:1"][0].alive


# ---------------------------------------------------------------------------
# Role-aware routing decisions
# ---------------------------------------------------------------------------

class TestRouterRoles:
    def _mk(self, **stats):
        base = {"queue_depth": 0.0, "running": 0.0, "p99_ms": 0.0}
        base.update(stats)
        return base

    def test_route_split_scores_prefill_by_overlap_decode_by_queue(self):
        router = RequestRouter(block_size=4)
        toks = list(range(12))
        keys = prefix.chain_keys(toks, 4)
        router.upsert_replica("prefill:0", address="h:1", stats=self._mk(
            role="prefill", prefix_digest=keys[:2]))
        router.upsert_replica("prefill:1", address="h:2", stats=self._mk(
            role="prefill"))
        router.upsert_replica("decode:0", address="h:3", stats=self._mk(
            role="decode", queue_depth=3.0))
        router.upsert_replica("decode:1", address="h:4", stats=self._mk(
            role="decode", queue_depth=1.0))
        assert router.route_split(toks) == ("prefill:0", "decode:1")

    def test_sticky_pair_affinity_and_repin(self):
        router = RequestRouter(block_size=4)
        for n, r in (("prefill:0", "prefill"), ("prefill:1", "prefill"),
                     ("decode:0", "decode"), ("decode:1", "decode")):
            router.upsert_replica(n, address=f"h:{n}",
                                  stats=self._mk(role=r))
        pf1, dc1 = router.route_split([1, 2, 3], session_id="s")
        router.upsert_replica(dc1, address=f"h:{dc1}", stats=self._mk(
            role="decode", queue_depth=9.0))
        assert router.route_split([1, 2, 3], session_id="s") == (pf1, dc1)
        assert router.affinity_hits == 1
        router.retire_replica(dc1)
        pf2, dc2 = router.route_split([1, 2, 3], session_id="s")
        assert dc2 != dc1
        assert router.route_split([1, 2, 3], session_id="s") == (pf2, dc2)

    def test_colocated_fleet_has_no_split(self, tiny):
        eng = make_engine(tiny)
        router = RequestRouter(block_size=8)
        router.upsert_replica("serve:0", client=EngineFront(eng),
                              stats=eng.stats())
        assert router.route_split([1, 2, 3]) == (None, None)
        rng = np.random.RandomState(8)
        p = [int(t) for t in rng.randint(0, 256, 9)]
        out = router.dispatch(p, 4, rid="r")
        assert out["replica"] == "serve:0"
        assert "prefill_replica" not in out
        assert router.stats()["handoffs"] == 0

    def test_split_dissolving_mid_retry_serves_colocated(self, tiny):
        class DeadPrefill:
            def prefill_handoff(self, tokens, max_new_tokens, rid=None,
                                decode=None, conv=None):
                raise ConnectionRefusedError("gang gone")

        dc_eng = make_engine(tiny, role="decode")
        router = RequestRouter(block_size=8)
        router.upsert_replica("prefill:0", client=DeadPrefill(),
                              stats={"role": "prefill", "queue_depth": 0.0})
        router.upsert_replica("decode:0",
                              client=DecodeFront(EngineFront(dc_eng)),
                              stats=dc_eng.stats())
        rng = np.random.RandomState(13)
        p = [int(t) for t in rng.randint(0, 256, 9)]
        out = router.dispatch(p, 4, rid="r")
        assert out["replica"] == "decode:0"
        assert "prefill_replica" not in out, "served colocated"
        assert router.stats()["failovers"] == 1
        ref = run_requests(make_engine(tiny), [p], max_new=4)
        assert out["tokens"] == ref[0].tokens

    def test_split_dissolved_falls_back_to_colocated_path(self, tiny):
        pf_eng = make_engine(tiny, role="prefill")
        router = RequestRouter(block_size=8)
        router.upsert_replica("prefill:0",
                              client=PrefillFront(EngineFront(pf_eng)),
                              stats=pf_eng.stats())
        rng = np.random.RandomState(9)
        p = [int(t) for t in rng.randint(0, 256, 9)]
        assert router.dispatch(p, 4, rid="r")["replica"] == "prefill:0"


# ---------------------------------------------------------------------------
# The heartbeat schema: stats file -> heartbeat -> session -> router
# ---------------------------------------------------------------------------

class TestHeartbeatSchema:
    NEW_FIELDS = ("blocks_shipped", "handoff_ms", "imports_failed")

    def test_stats_fields_present_and_zero_on_colocated(self, tiny):
        s = make_engine(tiny).stats()
        assert s["role"] == "colocated"
        for f in self.NEW_FIELDS:
            assert s[f] == 0.0, f
        with pytest.raises(ValueError, match="role"):
            make_engine(tiny, role="both")

    def test_prefill_role_reports_load(self, tiny):
        pf_eng = make_engine(tiny, role="prefill")
        dc_eng = make_engine(tiny, role="decode")
        pf = PrefillFront(EngineFront(pf_eng))
        dc = DecodeFront(EngineFront(dc_eng))
        rng = np.random.RandomState(11)
        for i in range(2):
            pf.prefill_handoff([int(t) for t in rng.randint(0, 256, 12)],
                               3, rid=f"r{i}", decode=dc)
        s = pf_eng.stats()
        assert s["completed"] == 2.0
        assert s["qps"] > 0.0 and s["p99_ms"] > 0.0
        assert s["blocks_shipped"] == 4.0 and s["handoff_ms"] > 0.0
        assert dc_eng.stats()["handoff_ms"] > 0.0

    def test_round_trip_stats_file_to_router(self, tiny, tmp_path):
        """The port's chain: engine stats file -> executor reader ->
        heartbeat RPC -> session -> serve_endpoints -> router view, the
        role string and handoff counters surviving every hop."""
        from tony_tpu_torch.conf import TonyConfig, serve_role_key
        from tony_tpu_torch.executor import read_serve_stats
        from tony_tpu_torch.rpc import ApplicationRpcHandler
        from tony_tpu_torch.session import TonySession

        eng = make_engine(tiny, role="prefill", prefix_cache=True)
        eng.blocks_shipped = 7
        eng.handoff_ms = 12.5
        path = tmp_path / "stats.json"
        eng.write_stats(str(path), extra={"rpc_port": 4242})
        stats = read_serve_stats(path)
        assert stats["role"] == "prefill"
        assert stats["blocks_shipped"] == 7.0
        assert stats["handoff_ms"] == 12.5
        conf = TonyConfig({"tony.prefill.instances": "1",
                           "tony.prefill.command": "x",
                           "tony.decode.instances": "1",
                           "tony.decode.command": "x",
                           serve_role_key("prefill"): "prefill",
                           serve_role_key("decode"): "decode"})
        session = TonySession(conf, "app_disagg")
        handler = ApplicationRpcHandler(session)
        session.on_registered("prefill", 0, "hostA", 1)
        session.on_registered("decode", 0, "hostB", 2)
        handler.rpc_heartbeat("prefill", 0, serve=stats)
        dec = make_engine(tiny, role="decode")
        handler.rpc_heartbeat("decode", 0, serve={
            **dec.stats(), "rpc_port": 4243})
        assert set(session.serve_job_types()) == {"prefill", "decode"}
        eps = handler.rpc_serve_endpoints()
        assert {e["job_type"] for e in eps} == {"prefill", "decode"}
        router = RequestRouter(block_size=8)
        router.refresh_from_task_infos(json.loads(json.dumps(eps)))
        views = {v.name: v for v in router.replicas()}
        assert views["prefill:0"].role == "prefill"
        assert views["prefill:0"].address == "hostA:4242"
        assert views["decode:0"].role == "decode"
        assert views["decode:0"].address == "hostB:4243"

    def test_cli_role_builds_heterogeneous_jobtypes(self, tmp_path):
        from tony_tpu_torch import cli
        from tony_tpu_torch import conf as conf_mod

        args = cli.make_parser().parse_args([
            "serve", "--model", "llama-tiny", "--ckpt_dir", str(tmp_path),
            "--role", "prefill=2,decode=3", "--prefill_chunk", "32",
            "--gpus", "1"])
        cfg = cli.serve_conf(args)
        assert cfg.get_int(conf_mod.instances_key("prefill"), 0) == 2
        assert cfg.get_int(conf_mod.instances_key("decode"), 0) == 3
        assert cfg.get(conf_mod.serve_role_key("prefill")) == "prefill"
        assert cfg.get(conf_mod.serve_role_key("decode")) == "decode"
        assert cfg.get(conf_mod.instances_key("serve")) is None
        for jt in ("prefill", "decode"):
            assert cfg.get(conf_mod.command_key(jt)) \
                == "python -m tony_tpu_torch.serve.replica"
            assert cfg.get(conf_mod.gpus_key(jt)) == "1"
        # Without --gpus: no card ask on either jobtype.
        args = cli.make_parser().parse_args([
            "serve", "--model", "m", "--ckpt_dir", str(tmp_path), "--role",
            "prefill=1,decode=1"])
        cfg = cli.serve_conf(args)
        assert cfg.get(conf_mod.gpus_key("prefill")) is None

    def test_cli_role_conf_equals_the_reference(self, tmp_path,
                                                monkeypatch):
        """The JAX CLI's conf for the same split, but for the replica
        command."""
        import tony_tpu.client as jclient
        from tony_tpu import cli as jcli
        from tony_tpu_torch import cli

        captured = {}

        class FakeClient:
            def __init__(self, cfg, **kw):
                captured["cfg"] = cfg

            def run(self, timeout=None):
                return 0

        monkeypatch.setattr(jclient, "TonyClient", FakeClient)
        argv = ["serve", "--model", "m", "--ckpt_dir", str(tmp_path),
                "--role", "prefill=1,decode=2"]
        assert jcli.main(argv) == 0
        want = dict(captured["cfg"].items())
        got = dict(cli.serve_conf(cli.make_parser().parse_args(argv))
                   .items())
        for jt in ("prefill", "decode"):
            assert got.pop(f"tony.{jt}.command") == \
                "python -m tony_tpu_torch.serve.replica"
            assert want.pop(f"tony.{jt}.command") == \
                "python -m tony_tpu.serve.replica"
        assert got == want

    @pytest.mark.parametrize("bad", ["warble=2", "prefill=0,decode=1",
                                     "prefill=2", "prefill=x,decode=1",
                                     "decode=1,decode=2"])
    def test_cli_role_validation(self, bad):
        from tony_tpu_torch import cli

        args = cli.make_parser().parse_args([
            "serve", "--model", "m", "--ckpt_dir", "/tmp/ck", "--role", bad])
        with pytest.raises(SystemExit, match="--role"):
            cli.serve_conf(args)


# ---------------------------------------------------------------------------
# The RPC wire end to end: one replica pair behind the port's RPC servers
# ---------------------------------------------------------------------------

class MiniReplica:
    """The request-path surface of ``serve.replica.Replica`` over an
    engine built here, without the checkpoint restore
    (tests/test_torch_replica.py holds that path)."""

    def __init__(self, eng):
        self.engine = eng
        self._front = EngineFront(eng)
        self._prefill_front = PrefillFront(self._front)
        self._decode_front = DecodeFront(self._front)

    def generate(self, tokens, max_new_tokens, rid=None, conv=None,
                 tenant=None):
        return self._front.generate(tokens, max_new_tokens, rid=rid,
                                    conv=conv, tenant=tenant)

    def prefill_handoff(self, tokens, max_new_tokens, rid=None,
                        decode=None, conv=None, tenant=None):
        return self._prefill_front.prefill_handoff(
            tokens, max_new_tokens, rid=rid, decode=decode, conv=conv,
            tenant=tenant)

    def kv_offer(self, keys):
        return self._decode_front.kv_offer(keys)

    def kv_import(self, payload):
        return self._decode_front.kv_import(payload)


@pytest.fixture(scope="module")
def rpc_pair(tiny):
    """A prefill (chunked) and a decode replica (:class:`MiniReplica`
    in the replica's RPC handler) behind the port's RPC servers, shared
    by the module's wire tests."""
    from tony_tpu_torch.rpc import RpcServer
    from tony_tpu_torch.serve.replica import _ReplicaRpcHandler

    engines = {"prefill:0": make_engine(tiny, role="prefill",
                                        prefill_chunk=16),
               "decode:0": make_engine(tiny, role="decode")}
    servers = {name: RpcServer(_ReplicaRpcHandler(MiniReplica(eng)),
                               host="127.0.0.1", port=0).start()
               for name, eng in engines.items()}
    try:
        yield engines, {n: s.address for n, s in servers.items()}
    finally:
        for srv in servers.values():
            srv.stop()


class TestDisaggOverRpc:
    def test_fleet_e2e_over_rpc_with_handoff(self, tiny, rpc_pair):
        """Router (RPC dial) -> prefill replica RPC -> replica-to-replica
        KV ship (kv_offer/kv_import) -> decode replica drives to
        completion: the colocated engine's tokens, the counters in
        serve_stats."""
        from tony_tpu_torch.rpc import RpcClient

        engines, addrs = rpc_pair
        pf_eng, dc_eng = engines["prefill:0"], engines["decode:0"]
        shipped0, in0 = pf_eng.blocks_shipped, dc_eng.handoffs_in
        router = RequestRouter(block_size=8, dial_timeout_s=5.0)
        for name, eng in engines.items():
            router.upsert_replica(name, address=addrs[name],
                                  stats=eng.stats())
        rng = np.random.RandomState(10)
        prompts = [[int(t) for t in rng.randint(0, 256, n)]
                   for n in (9, 17)]
        outs = [router.dispatch(p, 5, rid=f"w{i}")
                for i, p in enumerate(prompts)]
        ref = run_requests(make_engine(tiny, keep_logits=False), prompts,
                           max_new=5)
        for i, out in enumerate(outs):
            assert out["tokens"] == ref[i].tokens
            assert out["replica"] == "decode:0"
            assert out["prefill_replica"] == "prefill:0"
        assert pf_eng.blocks_shipped - shipped0 == 2 + 3
        assert dc_eng.handoffs_in - in0 == 2
        assert router.stats()["handoffs"] == 2
        with RpcClient(addrs["decode:0"], timeout=5.0) as client:
            assert client.call("serve_stats")["role"] == "decode"
            assert client.call("kv_offer", keys=["x"]) == 0
        assert pf_eng.cache.free_blocks == pf_eng.cache.n_blocks
        assert dc_eng.cache.free_blocks == dc_eng.cache.n_blocks

    def test_jax_client_drives_the_port_handoff_verb(self, tiny, rpc_pair):
        """The JAX package's RPC client calls the port replica's
        ``prefill_handoff`` with a decode address: one wire."""
        from tony_tpu.rpc import RpcClient as JRpcClient

        engines, addrs = rpc_pair
        rng = np.random.RandomState(16)
        p = [int(t) for t in rng.randint(0, 256, 20)]
        with JRpcClient(addrs["prefill:0"], timeout=10.0) as client:
            out = client.call("prefill_handoff", tokens=p,
                              max_new_tokens=4, rid="jax-1",
                              decode_address=addrs["decode:0"])
        ref = run_requests(make_engine(tiny, keep_logits=False), [p],
                           max_new=4)
        assert out["tokens"] == ref[0].tokens and out["rid"] == "jax-1"

    def test_slow_import_resend_falls_back_colocated(self, tiny, rpc_pair,
                                                     monkeypatch):
        """The reference's semantics past the per-operation socket
        timeout: a kv_import reply slower than it is re-sent as a
        transport fault, the re-send collides with the first import's
        live rid, and after the shipper's bounded attempts the router
        falls back to colocated prefill on the decode replica — the
        right answer with duplicated work, counted in ``rpc.RESENDS``.
        The fallback goes over the router's own dial, whose wait for a
        reply the shortened per-operation cap does not touch."""
        import time as time_mod

        engines, addrs = rpc_pair
        dc_eng = engines["decode:0"]

        def slow_import(self, payload):
            with self.front._drive:
                rid, done = self.front.engine.admit_handoff(payload)
            time_mod.sleep(0.8)             # live, past the per-op cap
            return done or self.front._drive_until(rid)

        monkeypatch.setattr(DecodeFront, "kv_import", slow_import)
        monkeypatch.setattr(rpc_mod.RpcClient, "SOCKET_TIMEOUT_S", 0.3)
        before = rpc_mod.RESENDS.get("kv_import", 0)
        failed0 = dc_eng.imports_failed
        pf_eng = make_engine(tiny, role="prefill")
        router = RequestRouter(block_size=8)
        router.upsert_replica("prefill:0",
                              client=PrefillFront(EngineFront(pf_eng)),
                              stats=pf_eng.stats())
        router.upsert_replica("decode:0", address=addrs["decode:0"],
                              stats=dc_eng.stats())
        rng = np.random.RandomState(17)
        p = [int(t) for t in rng.randint(0, 256, 11)]
        out = router.dispatch(p, 3, rid="slow")
        ref = run_requests(make_engine(tiny, keep_logits=False), [p],
                           max_new=3)
        assert out["tokens"] == ref[0].tokens and out["rid"] == "slow"
        assert rpc_mod.RESENDS.get("kv_import", 0) > before
        assert dc_eng.imports_failed > failed0, "the re-send collided"
        assert router.stats()["handoff_fallbacks"] == 1
        # The orphaned first generation ends on the receiver's thread.
        deadline = time_mod.monotonic() + 10
        while (dc_eng.running or dc_eng.queue_depth) \
                and time_mod.monotonic() < deadline:
            time_mod.sleep(0.05)
        assert dc_eng.cache.free_blocks == dc_eng.cache.n_blocks
