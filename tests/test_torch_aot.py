"""Port parity for the cold-start plane (tony_tpu_torch.ckpt.aot, the
engine's ``warm()``/``aot_cache=``/``promote()``, the replica's standby
and pad tuner, ``make_accum_train_step(aot_cache=)``), mirroring
tests/test_aot.py inside the port:

* the store: round trip and counters, fingerprint drift, byte flip,
  truncation and a tampered entry each a counted miss with the directory
  unchanged, a concurrent populate first-writer-wins, ``gc``; the kernel
  library payload and its install without ``nvcc`` on a hit;
* the engine: a cache-armed engine's tokens and logits bitwise the
  default engine's for the plain, route and speculative families, in
  f32 and bf16, a second engine on the populated cache resolving with no
  miss and no build; the default engine with no AOT surface;
  ``promote`` idempotent; the four stats keys as floats;
* the device-only step (the sink column and the pool's sink block)
  against PR 13's step, logits and pool contents equal, and its tokens
  against the JAX engine's on the same converted params;
* ``derive_prefill_pads`` against the JAX one, and ``tune_warm_pads``
  over a history directory the JAX events writer wrote;
* ``make_accum_train_step(aot_cache=)`` bitwise the uncached step, a
  changed state geometry a miss;
* the control plane: the JAX executor's heartbeat carrying a port
  standby's ``warm_standby`` and the session keeping it out of the
  endpoints until it flips; the JAX AM's promote RPC reaching a port
  replica's ``rpc_promote``, with the fallback to a cold grant.

The four reference AOT tests that fail on this image (ROADMAP.md queue
3) are not the oracle. llama-tiny, 2 layers, on the CPU, where a
resolved step is the eager step and the library payload is empty."""

from __future__ import annotations

import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn
import jax
import jax.numpy as jnp

from tony_tpu import constants as jconstants
from tony_tpu.am import ApplicationMaster
from tony_tpu.conf import TonyConfig as JTonyConfig
from tony_tpu.events import EventHandler
from tony_tpu.executor import TaskExecutor
from tony_tpu.models import get_model as jax_model
from tony_tpu.rpc import ApplicationRpcHandler
from tony_tpu.rpc import RpcServer as JRpcServer
from tony_tpu.serve import Request as JRequest
from tony_tpu.serve import ServeEngine as JServeEngine
from tony_tpu.serve.swap import derive_prefill_pads as jderive
from tony_tpu.session import TonySession
from tony_tpu.util import normalize_serve_telemetry
from tony_tpu_torch import ckpt, constants, publish
from tony_tpu_torch import train as ttrain
from tony_tpu_torch.ckpt import AOTCache, aot, make_fingerprint
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params
from tony_tpu_torch.ops import _build
from tony_tpu_torch.ops.fused_optim import FusedOptimizer
from tony_tpu_torch.rpc import RpcServer
from tony_tpu_torch.serve import (Replica, Request, ServeEngine, SpecEngine,
                                  build_step_fn)
from tony_tpu_torch.serve.swap import derive_prefill_pads

ENGINE_KW = dict(ctx_max=64, block_size=8, q_block=16, decode_buckets=(2, 4),
                 max_running=4, keep_logits=True, device="cpu")
PROMPTS = [[3, 5, 7, 11, 13], [2, 4, 6], [1, 2, 3, 4, 5, 6, 7, 8, 9],
           list(range(40, 60))]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _model(dtype=torch.float32, seed=0):
    return get_model("llama-tiny", device="cpu", dtype=dtype, seed=seed,
                     param_dtype=dtype)


def run_requests(eng, prompts=PROMPTS, max_new=4):
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=list(p), max_new_tokens=max_new))
    return {c.rid: c for c in eng.run()}


def assert_bitwise_equal(got, ref):
    """Token streams AND per-token logits of two completion maps."""
    assert sorted(got) == sorted(ref)
    for rid in ref:
        assert got[rid].tokens == ref[rid].tokens, rid
        assert len(got[rid].logits) == len(ref[rid].logits)
        for a, b in zip(got[rid].logits, ref[rid].logits):
            assert np.array_equal(a, b), rid


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

PAYLOAD = bytes(range(256)) * 4099        # two CRC32 chunks


class TestAOTCache:
    def test_round_trip_and_counters(self, tmp_path):
        cache = AOTCache(str(tmp_path))
        fp = make_fingerprint("unit", device="cpu", geometry={"n": 8})
        assert cache.get(fp) is None and cache.misses == 1
        assert cache.put(fp, PAYLOAD) and cache.puts == 1
        assert cache.get(fp) == PAYLOAD and cache.hits == 1
        # Idempotent second put: a counted race, the store unchanged.
        assert not cache.put(fp, b"other") and cache.put_races == 1
        assert len(cache.entries()) == 1 and cache.get(fp) == PAYLOAD
        # An empty payload (a CPU step family) is an entry like any other.
        empty = make_fingerprint("unit", device="cpu", geometry={"n": 0})
        assert cache.put(empty, b"") and cache.get(empty) == b""
        assert cache.hits == 3 and len(cache.entries()) == 2

    def test_fingerprint_drift_is_counted_miss(self, tmp_path):
        cache = AOTCache(str(tmp_path))
        fp = make_fingerprint("unit", device="cpu",
                              geometry={"b": 2, "t": 16})
        cache.put(fp, PAYLOAD)
        # Changed geometry: another key, so simply absent.
        drifted = make_fingerprint("unit", device="cpu",
                                   geometry={"b": 4, "t": 16})
        assert cache.get(drifted) is None and cache.misses == 1
        # Changed torch version under the SAME key (a forced address
        # collision): the stored full fingerprint must reject.
        skewed = dict(fp, torch="0.0.0-drifted")
        d = cache._dir(fp)
        entry = json.loads((d / "entry.json").read_text())
        entry["fingerprint"] = dict(entry["fingerprint"],
                                    torch="0.0.0-stored")
        (d / "entry.json").write_text(json.dumps(entry))
        assert cache.get(fp) is None and cache.misses == 2
        assert cache.get(skewed) is None and cache.misses == 3
        assert len(cache.entries()) == 1

    @pytest.mark.parametrize("how", ["flip", "truncate", "entry"])
    def test_corruption_is_counted_miss_state_unchanged(self, tmp_path,
                                                        how):
        cache = AOTCache(str(tmp_path))
        fp = make_fingerprint("unit", device="cpu", geometry={"case": how})
        cache.put(fp, PAYLOAD)
        d = cache._dir(fp)
        if how == "flip":
            raw = bytearray((d / "payload.bin").read_bytes())
            raw[len(raw) // 2] ^= 0xFF
            (d / "payload.bin").write_bytes(bytes(raw))
        elif how == "truncate":
            raw = (d / "payload.bin").read_bytes()
            (d / "payload.bin").write_bytes(raw[:len(raw) // 2])
        else:
            (d / "entry.json").write_text("{not json")
        before = sorted((p.name, p.read_bytes()) for p in d.iterdir())
        listing = sorted(os.listdir(tmp_path))
        assert cache.get(fp) is None
        assert cache.misses == 1 and cache.hits == 0
        # get never changes the store.
        assert sorted((p.name, p.read_bytes()) for p in d.iterdir()) \
            == before
        assert sorted(os.listdir(tmp_path)) == listing

    def test_concurrent_populate_first_writer_wins(self, tmp_path):
        fp = make_fingerprint("unit", device="cpu", geometry={"race": 1})
        caches = [AOTCache(str(tmp_path)) for _ in range(4)]
        barrier = threading.Barrier(4)
        results = [None] * 4

        def writer(i):
            barrier.wait()
            results[i] = caches[i].put(fp, PAYLOAD + bytes([i]))

        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sum(results) == 1            # exactly one commit
        assert sum(c.put_races for c in caches) == 3
        reader = AOTCache(str(tmp_path))
        assert len(reader.entries()) == 1
        assert sorted(os.listdir(tmp_path)) == [f"aot_{reader.entries()[0]}"]
        winner = results.index(True)
        assert reader.get(fp) == PAYLOAD + bytes([winner])

    def test_gc_drops_stale_and_orphans(self, tmp_path):
        cache = AOTCache(str(tmp_path))
        live = make_fingerprint("unit", device="cpu", geometry={"g": 1})
        stale = dict(make_fingerprint("unit", device="cpu",
                                      geometry={"g": 2}),
                     torch="0.0.0-old")
        cache.put(live, PAYLOAD)
        cache.put(stale, PAYLOAD)
        (tmp_path / "aot_deadbeef.tmp.1.2").mkdir()
        runtime = aot.runtime_fingerprint("cpu")
        dropped, kept, freed = cache.gc(dry_run=True, runtime=runtime)
        assert (dropped, kept) == (2, 1) and freed >= len(PAYLOAD)
        assert len(os.listdir(tmp_path)) == 3
        assert cache.gc(runtime=runtime)[:2] == (2, 1)
        assert cache.entries() == [aot.fingerprint_key(live)]
        assert cache.get(live) == PAYLOAD

    def test_tree_digest_sees_geometry_not_values(self):
        a, b = _model(seed=0), _model(seed=1)
        assert aot.tree_digest(a) == aot.tree_digest(b)
        assert aot.tree_digest(a) != aot.tree_digest(
            get_model("llama-tiny", device="cpu", n_layers=3))
        assert aot.tree_digest(a) != aot.tree_digest(
            _model(torch.bfloat16))
        assert aot.tree_digest({"x": torch.zeros(2, 3)}) != \
            aot.tree_digest({"x": torch.zeros(3, 2)})


class TestLibraryResolution:
    def test_payload_round_trip_and_framing(self):
        files = {"a-0123.so": b"\x00\x01abc", "b-4567.so": b"",
                 "c-89ab.so": PAYLOAD}
        assert _build.unpack_libraries(_build.pack_libraries(files)) \
            == files
        assert _build.unpack_libraries(_build.pack_libraries({})) == {}
        packed = _build.pack_libraries(files)
        for bad in (packed + b"x", packed[:-1], b"no table",
                    b'[["../x.so", 1]]\nx'):
            with pytest.raises(ValueError):
                _build.unpack_libraries(bad)

    def test_library_file_is_keyed_by_source_and_flags(self):
        name = _build.library_file("flash_decode")
        assert name.startswith("flash_decode-") and name.endswith(".so")
        assert name == _build.library_file("flash_decode")
        assert name != _build.library_file("int8_matmul")

    def test_cpu_family_resolves_with_no_library(self, tmp_path):
        cache = AOTCache(str(tmp_path / "aot"))
        first = _build.resolve((), cache=cache, build_dir=tmp_path / "k")
        again = _build.resolve((), cache=cache, build_dir=tmp_path / "k")
        assert (first.hit, first.built, first.libs) == (False, 0, {})
        assert (again.hit, again.built) == (True, 0)
        assert cache.entries() == [aot.fingerprint_key(
            aot.library_fingerprint(()))]
        # Without a cache nothing is consulted or written.
        assert _build.resolve((), build_dir=tmp_path / "k").hit is None
        assert len(cache.entries()) == 1

    def test_hit_installs_the_cached_bytes_without_nvcc(self, tmp_path,
                                                        monkeypatch):
        """A miss builds (here: a stand-in for nvcc) and puts the bytes;
        a hit into an empty directory writes exactly those bytes and
        runs no build. The libraries are not loaded (no card here)."""
        bound = []
        monkeypatch.setattr(_build, "_bind", lambda t: bound.append(t) or {
            n: None for n in t})
        built = []

        def fake_build(targets):
            for name, path in targets.items():
                if not path.is_file():
                    path.parent.mkdir(parents=True, exist_ok=True)
                    path.write_bytes(f"lib {name}".encode() * 99)
                    built.append(name)
            return len(built)

        monkeypatch.setattr(_build, "_build_missing", fake_build)
        # The card's half of the fingerprint, as this machine has none.
        monkeypatch.setattr(aot, "runtime_fingerprint",
                            lambda device=None: {"device_type": str(device)})
        names = ("flash_decode", "int8_matmul")
        cache = AOTCache(str(tmp_path / "aot"))
        cold = _build.resolve(names, cache=cache, build_dir=tmp_path / "k1")
        assert cold.hit is False and built == list(names)
        assert cache.puts == 1
        def no_build(targets):
            missing = [n for n, p in targets.items() if not p.is_file()]
            assert not missing, f"a hit would build {missing}"
            return 0

        monkeypatch.setattr(_build, "_build_missing", no_build)
        hot = _build.resolve(names, cache=cache, build_dir=tmp_path / "k2")
        assert hot.hit is True and hot.built == 0
        for n in names:
            f = _build.library_file(n)
            assert (tmp_path / "k2" / f).read_bytes() == \
                (tmp_path / "k1" / f).read_bytes()
        assert sorted(os.listdir(tmp_path / "k2")) == sorted(
            _build.library_file(n) for n in names)
        assert [sorted(t) for t in bound] == [sorted(names)] * 2
        # The entry names the libraries it holds; another set is
        # another entry.
        fp = aot.library_fingerprint(names)
        assert fp["extra"]["libraries"] == [_build.library_file(n)
                                            for n in names]
        assert cache.entries() == [aot.fingerprint_key(fp)]
        monkeypatch.setattr(_build, "_build_missing", fake_build)
        assert _build.resolve(names[:1], cache=cache,
                              build_dir=tmp_path / "k3").hit is False
        assert len(cache.entries()) == 2


# ---------------------------------------------------------------------------
# The engine: bitwise families and the zero-build pin
# ---------------------------------------------------------------------------

FAMILIES = {
    "plain": dict(),
    "route": dict(prefix_cache=True, prefill_chunk=16),
    "spec_ngram": dict(spec_k=3),
    "spec_draft": dict(spec_k=3, draft="model"),
}


def _family_engine(family, model, **kw):
    spec = dict(FAMILIES[family])
    if "spec_k" in spec:
        if spec.pop("draft", None) == "model":
            spec["draft_model"] = _model(model.cfg.dtype, seed=5)
        return SpecEngine(model, **spec, **ENGINE_KW, **kw)
    return ServeEngine(model, **spec, **ENGINE_KW, **kw)


class TestServeFamilyBitwise:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("family", FAMILIES)
    def test_cache_hit_engine_is_bitwise_and_builds_nothing(
            self, family, dtype, tmp_path):
        model = _model(DTYPES[dtype])
        ref = run_requests(_family_engine(family, model))
        root = str(tmp_path / "aot")
        e1 = _family_engine(family, model, aot_cache=AOTCache(root))
        n1 = e1.warm(prefill_pads=(16,))
        # One entry, the runner's library set: the first resolution puts
        # it (the draft's, after the target's, hits it).
        assert n1 > 1 and e1.aot_misses == 1 and e1.aot_hits > 0
        assert len(AOTCache(root).entries()) == 1
        assert_bitwise_equal(run_requests(e1), ref)
        c2 = AOTCache(root)
        e2 = _family_engine(family, model, aot_cache=c2)
        assert e2.warm(prefill_pads=(16,)) == n1
        assert_bitwise_equal(run_requests(e2), ref)
        assert e2.aot_misses == 0 and e2.fresh_compiles == 0
        assert e2.aot_hits > 0 and e2.compile_ms == 0.0
        assert c2.misses == 0 and c2.hits >= n1
        if family == "spec_draft":
            draft = e2.draft
            assert draft.aot_hits > 0 and draft.aot_misses == 0
            assert draft._aot_fns

    def test_first_launch_of_an_unwarmed_shape_resolves(self, tmp_path):
        model = _model()
        ref = run_requests(ServeEngine(model, **ENGINE_KW))
        eng = ServeEngine(model, aot_cache=AOTCache(str(tmp_path)),
                          **ENGINE_KW)
        assert_bitwise_equal(run_requests(eng), ref)
        # The prompt pads 16 and 32 and the decode bucket the four
        # sequences ride: each resolved at its first launch.
        assert {(1, 16), (1, 32), (4, 16)} <= set(eng._aot_fns)
        assert eng.aot_misses == 1
        assert eng.aot_hits == len(eng._aot_fns) - 1

    def test_corrupted_cache_degrades_to_a_build_bitwise(self, tmp_path):
        model = _model()
        root = tmp_path / "aot"
        e1 = ServeEngine(model, aot_cache=AOTCache(str(root)), **ENGINE_KW)
        e1.warm(prefill_pads=(16,))
        ref = run_requests(e1)
        for d in root.iterdir():
            (d / "entry.json").write_text("{torn")
        e2 = ServeEngine(model, aot_cache=AOTCache(str(root)), **ENGINE_KW)
        e2.warm(prefill_pads=(16,))
        assert_bitwise_equal(run_requests(e2), ref)
        assert e2.aot_hits == 0 and e2.aot_misses > 0

    def test_default_engine_has_no_aot_surface(self):
        eng = ServeEngine(_model(), **ENGINE_KW)
        run_requests(eng, PROMPTS[:1])
        assert eng.aot_cache is None and eng._aot_fns == {}
        assert (eng.aot_hits, eng.aot_misses, eng.fresh_compiles) == \
            (0, 0, 0)
        s = eng.stats()
        assert s["aot_hits"] == 0.0 and s["aot_misses"] == 0.0
        assert s["compile_ms"] == 0.0 and s["warm_standby"] == 0.0
        assert eng.graph_launches() == {} and eng.graph_replays() == 0

    def test_warm_without_a_cache_resolves_the_family(self):
        model = _model()
        ref = run_requests(ServeEngine(model, **ENGINE_KW))
        eng = ServeEngine(model, prefill_chunk=16, **ENGINE_KW)
        assert eng.warm(prefill_pads=(32, 16)) == 4
        assert set(eng._aot_fns) == {(2, 16), (4, 16), (1, 16), (1, 32)}
        assert eng.warm() == 0                          # idempotent
        assert eng.fresh_compiles == 0 and eng.aot_misses == 0
        assert_bitwise_equal(run_requests(ServeEngine(
            model, prefill_chunk=16, **ENGINE_KW)), ref)
        assert_bitwise_equal(run_requests(eng), ref)

    def test_engine_promote_is_idempotent(self):
        eng = ServeEngine(_model(), warm_standby=True, **ENGINE_KW)
        assert eng.stats()["warm_standby"] == 1.0
        assert eng.promote() is True
        assert eng.promote() is False
        assert eng.stats()["warm_standby"] == 0.0
        assert ServeEngine(_model(), **ENGINE_KW).promote() is False

    @pytest.mark.parametrize("armed", [False, True])
    def test_stats_carry_the_four_keys_as_floats(self, armed, tmp_path):
        from tony_tpu.executor import read_serve_stats

        kw = {"aot_cache": AOTCache(str(tmp_path / "aot")),
              "warm_standby": True} if armed else {}
        eng = ServeEngine(_model(), **ENGINE_KW, **kw)
        if armed:
            eng.warm()
        s = eng.stats()
        for k in ("aot_hits", "aot_misses", "compile_ms",
                  "warm_standby", "daemon_demotions"):
            assert isinstance(s[k], float), k
        assert s["aot_misses"] == (1.0 if armed else 0.0)
        assert s["aot_hits"] == (1.0 if armed else 0.0)
        assert s["warm_standby"] == (1.0 if armed else 0.0)
        assert s["daemon_demotions"] == 0.0
        path = tmp_path / "stats.json"
        eng.write_stats(str(path), extra={"rpc_port": 4321})
        read = read_serve_stats(path)
        assert read["warm_standby"] == s["warm_standby"]
        assert read["aot_misses"] == s["aot_misses"]


# ---------------------------------------------------------------------------
# The device-only step against PR 13's step
# ---------------------------------------------------------------------------

def _pr13_step_fn(model, *, n_layers, n_blocks, block_size, kv_dim,
                  ctx_pad, b, t):
    """PR 13's step, verbatim but for taking the pool views and the
    host inputs, and a zero sink column after the gathered buffers (the
    forward drops rows past ctx_pad there): clip the tables with numpy,
    gather exactly ctx_pad columns, commit the rows the host selected
    with np.nonzero."""
    L, nb, bs, kvd, ctx = n_layers, n_blocks, block_size, kv_dim, ctx_pad
    oob = nb * bs

    @torch.inference_mode()
    def fn(pool_k, pool_v, tokens, positions, tables, flat_idx):
        dev = pool_k.device
        tab = torch.as_tensor(np.clip(tables, 0, nb - 1).reshape(-1),
                              dtype=torch.long, device=dev)

        def layer_kv(i):
            return tuple(F.pad(pool[i].index_select(0, tab).view(
                b, ctx, kvd), (0, 0, 0, 1)) for pool in (pool_k, pool_v))

        logits, (knew, vnew) = model(
            torch.as_tensor(tokens, device=dev),
            positions=torch.as_tensor(positions, dtype=torch.int32,
                                      device=dev),
            kv=layer_kv, ctx=ctx)
        flat = np.asarray(flat_idx).reshape(-1)
        rows = np.nonzero(flat < oob)[0]
        if rows.size:
            dst = torch.as_tensor(flat[rows], dtype=torch.long, device=dev)
            src = torch.as_tensor(rows, dtype=torch.long, device=dev)
            pool_k.view(L, nb * bs, kvd)[:, dst] = \
                knew.reshape(L, b * t, kvd)[:, src].to(pool_k.dtype)
            pool_v.view(L, nb * bs, kvd)[:, dst] = \
                vnew.reshape(L, b * t, kvd)[:, src].to(pool_v.dtype)
        return logits

    return fn


class _PR13Engine(ServeEngine):
    """The engine with PR 13's step in place of the device-only one."""

    def _run_fn(self, b, t, tokens, positions, tables, flat_idx,
                row=None):
        key = ("pr13", b, t)
        if key not in self._fns:
            self._fns[key] = _pr13_step_fn(
                self.model, n_layers=self.n_layers,
                n_blocks=self.cache.n_blocks, block_size=self.block_size,
                kv_dim=self.kv_dim, ctx_pad=self.ctx_pad, b=b, t=t)
        self.forwards += 1
        logits = self._fns[key](self.cache.k, self.cache.v, tokens,
                                positions, tables, flat_idx)
        return logits if row is None else logits[:, row]


# Prompts that run past ctx_max with their padding rows (48 + 16 of
# ctx 64), share a prefix (copy-on-write) and join mid-flight.
STEP_PROMPTS = [list(range(1, 49)), [7, 7, 7], list(range(1, 30)),
                list(range(100, 147))]


class TestDeviceOnlyStep:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("lanes", [{}, {"prefix_cache": True,
                                             "prefill_chunk": 16}],
                             ids=["plain", "route"])
    def test_step_equals_pr13_step_logits_and_pool(self, dtype, lanes):
        model = _model(DTYPES[dtype])
        new = ServeEngine(model, **lanes, **ENGINE_KW)
        old = _PR13Engine(model, **lanes, **ENGINE_KW)
        got = run_requests(new, STEP_PROMPTS, max_new=15)
        ref = run_requests(old, STEP_PROMPTS, max_new=15)
        assert_bitwise_equal(got, ref)
        assert new.forwards == old.forwards
        assert np.array_equal(new.cache.k.float().numpy(),
                              old.cache.k.float().numpy())
        assert np.array_equal(new.cache.v.float().numpy(),
                              old.cache.v.float().numpy())

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_sink_column_equals_dropping_rows(self, dtype):
        """Rows past ctx land in the sink column and nowhere else: the
        columns below ctx hold exactly the in-range rows written over
        the old buffer (the JAX package's mode="drop"), columns past the
        sink are untouched, and the bits do not depend on how wide the
        buffer is past its sink."""
        model = _model(DTYPES[dtype])
        cfg = model.cfg
        rng = np.random.RandomState(3)
        b, t, ctx = 3, 16, 32
        kvd = cfg.n_kv_heads * cfg.head_dim
        tokens = torch.from_numpy(rng.randint(0, 256, (b, t)))
        pos = (np.array([0, 5, ctx - 4])[:, None] + np.arange(t)).astype(
            np.int32)
        positions = torch.from_numpy(pos)
        bufs = torch.from_numpy(rng.randn(2, cfg.n_layers, b, ctx + 8, kvd)
                                .astype(np.float32)).to(cfg.dtype)
        wide = bufs.clone()
        sink = bufs[:, :, :, :ctx + 1].clone()
        a, (ak, av) = model(tokens, positions=positions,
                            kv=(wide[0], wide[1]), ctx=ctx)
        r, (rk, rv) = model(tokens, positions=positions,
                            kv=(sink[0], sink[1]), ctx=ctx)
        assert torch.equal(a, r) and torch.equal(ak, rk) \
            and torch.equal(av, rv)
        dropped = bufs[:, :, :, :ctx].clone()
        for i, j in zip(*np.nonzero(pos < ctx)):
            dropped[0, :, i, pos[i, j]] = ak[:, i, j]
            dropped[1, :, i, pos[i, j]] = av[:, i, j]
        assert (pos >= ctx).any()
        assert torch.equal(wide[:, :, :, :ctx], dropped)
        assert torch.equal(sink[:, :, :, :ctx], dropped)
        # Columns past the sink are never written.
        assert torch.equal(wide[:, :, :, ctx + 1:], bufs[:, :, :, ctx + 1:])
        for bad in (ctx + 1, None):
            with pytest.raises(ValueError, match="sink"):
                model(tokens, positions=positions, kv=(sink[0], sink[1]),
                      ctx=bad)
        with pytest.raises(ValueError, match="kv="):
            model(tokens, ctx=ctx)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_long_prefill_step_returns_its_row_bitwise(self, dtype):
        """A step past q_block rows returns only the row its caller
        reads, [b, 1, vocab] (what a captured step keeps alive): the
        bits of that row of the full step, with the same pool written;
        the engine's launch hands back that row."""
        model = _model(DTYPES[dtype])
        eng = ServeEngine(model, **ENGINE_KW)
        c, vocab = eng.cache, model.cfg.vocab
        rng = np.random.RandomState(5)
        for t in (32, 48, 64):
            fns = [build_step_fn(
                model, n_layers=eng.n_layers, n_blocks=c.n_blocks,
                block_size=eng.block_size, kv_dim=eng.kv_dim,
                ctx_pad=eng.ctx_pad, b=1, t=t, last_row=last)
                for last in (False, True)]
            host = (rng.randint(0, 256, (1, t)).astype(np.int32),
                    np.arange(t, dtype=np.int32)[None],
                    np.arange(eng.nb_max, dtype=np.int32)[None],
                    np.arange(t, dtype=np.int32)[None])
            inputs = [torch.from_numpy(a) for a in host]
            pools = [(c.k_store.clone(), c.v_store.clone())
                     for _ in range(2)]
            ref = fns[0](*pools[0], *inputs)
            got = fns[1](*pools[1], *inputs,
                         torch.tensor([t - 5], dtype=torch.int32))
            assert got.shape == (1, 1, vocab)
            assert torch.equal(got[0, 0], ref[0, t - 5])
            assert all(torch.equal(a, b) for a, b in zip(*pools))
            assert eng._last_row(t)
            row = eng._run_fn(1, t, *host, row=t - 5)
            assert torch.equal(row, ref[:, t - 5])
            assert torch.equal(c.k_store, pools[0][0])
            c.k_store.zero_()
            c.v_store.zero_()
        assert not eng._last_row(eng.q_block)

    def test_step_commits_dropped_rows_to_the_sink_block(self):
        model = _model()
        eng = ServeEngine(model, **ENGINE_KW)
        c = eng.cache
        before = c.k_store.clone()
        L, nb, bs = eng.n_layers, c.n_blocks, eng.block_size
        fn = build_step_fn(model, n_layers=L, n_blocks=nb, block_size=bs,
                           kv_dim=eng.kv_dim, ctx_pad=eng.ctx_pad, b=2, t=16)
        tokens = torch.ones((2, 16), dtype=torch.int32)
        positions = torch.arange(16, dtype=torch.int32).repeat(2, 1)
        tables = torch.zeros((2, eng.nb_max), dtype=torch.int32)
        flat = torch.full((2, 16), c.oob_index, dtype=torch.int32)
        flat[0, 0] = 3
        fn(c.k_store, c.v_store, tokens, positions, tables, flat)
        changed = (c.k_store != before).any(-1)           # [L, nb+1, bs]
        assert changed[:, :nb].reshape(L, -1).nonzero()[:, 1].unique() \
            .tolist() == [3]
        assert changed[:, nb].any()                       # the sink

    def test_tokens_equal_the_jax_engine(self):
        jm = jax_model("llama-tiny", n_layers=2, dtype=jnp.float32)
        params = nn.unbox(jm.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 16), jnp.int32)))["params"]
        tm = get_model("llama-tiny", n_layers=2, dtype=torch.float32,
                       device="cpu")
        load_jax_params(tm, jax.tree.map(np.asarray, params))
        kw = {k: v for k, v in ENGINE_KW.items() if k != "device"}
        jeng = JServeEngine(jm, params, **kw)
        for i, p in enumerate(STEP_PROMPTS):
            jeng.submit(JRequest(rid=i, tokens=list(p), max_new_tokens=15))
        jout = {c.rid: c for c in jeng.run()}
        got = run_requests(ServeEngine(tm, **ENGINE_KW), STEP_PROMPTS,
                           max_new=15)
        for rid, c in jout.items():
            assert got[rid].tokens == list(c.tokens), rid
            for a, b in zip(got[rid].logits, c.logits):
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-4,
                                           rtol=1e-4)


# ---------------------------------------------------------------------------
# The pad tuner
# ---------------------------------------------------------------------------

RECORDS = [
    {"type": "SERVE_WINDOW", "payload": {"job_type": "serve", "index": 0,
                                         "stats": {"prompt_hist": {
                                             "16": 3.0, "32": 5.0,
                                             "48": 1.0, "7": 9.0}}}},
    {"payload": {"stats": {"prompt_hist": {"32": 1.0, "64": 4.0,
                                           "96": 9.0, "x": 2}}}},
    {"stats": {"prompt_hist": {"16": 2.0}}},
    {"prompt_hist": {"80": 2.0, "-16": 1.0}},
    {"payload": {"stats": {"qps": 1.0}}},
]


class TestPadTuner:
    @pytest.mark.parametrize("kw", [{}, {"limit": 2}, {"ctx_max": 64},
                                    {"q_block": 32, "limit": 9},
                                    {"limit": 0}])
    def test_derive_prefill_pads_equals_the_reference(self, kw):
        assert derive_prefill_pads(RECORDS, **kw) == jderive(RECORDS, **kw)
        assert derive_prefill_pads([], **kw) == jderive([], **kw) == []

    def test_tune_warm_pads_reads_the_jax_history(self, tmp_path):
        history = tmp_path / "history"
        for app, hists in (("app_a", [{"16": 4.0, "32": 1.0}]),
                           ("app_b", [{"48": 3.0}, {"32": 2.0}])):
            handler = EventHandler(history, app)
            for i, hist in enumerate(hists):
                handler.serve_window("serve", i, {"qps": 1.0,
                                                  "prompt_hist": hist})
            if app == "app_a":
                handler.close()         # one finished, one in progress
        root = tmp_path / "ckpt"
        state = ttrain.create_train_state(_model(), ttrain.adamw(1e-3))
        saver = ckpt.AsyncCheckpointer(root)
        saver.save(ckpt.encode_portable(state), step=1, block=True)
        saver.close()
        rep = Replica(model_name="llama-tiny",
                      model_kwargs={"device": "cpu", "dtype": torch.float32},
                      ckpt_dir=str(root), ctx_max=64, block_size=8,
                      q_block=16, max_running=4,
                      aot_cache=str(tmp_path / "aot"))
        assert rep.warmed == 2              # the decode buckets 4 and 16
        pads = rep.tune_warm_pads(str(history), limit=2)
        from tony_tpu import events as jevents
        records = [r for job in jevents.list_jobs(history)
                   for r in jevents.read_events(job["path"])
                   if r.get("type") == jevents.SERVE_WINDOW]
        assert pads == jderive(records, q_block=16, ctx_max=64,
                               limit=2) == [16, 32]
        assert {(1, 16), (1, 32)} <= set(rep.engine._aot_fns)
        assert rep.tune_warm_pads(str(tmp_path / "none")) == []


# ---------------------------------------------------------------------------
# make_accum_train_step(aot_cache=)
# ---------------------------------------------------------------------------

def _loss(logits, batch):
    return ttrain.next_token_loss(logits, batch["x"])


def _fused_state(seed=0, **kw):
    return ttrain.create_train_state(
        get_model("llama-tiny", device="cpu", dtype=torch.float32,
                  seed=seed, **kw),
        FusedOptimizer(rule="adamw", lr=1e-3, weight_decay=1e-4,
                       bucket_bytes=32768))


class TestTrainStep:
    @pytest.mark.parametrize("update", ["optax", "fused_bucket"])
    def test_cached_step_is_bitwise_the_uncached(self, update, tmp_path):
        x = torch.from_numpy(np.random.RandomState(0).randint(
            0, 256, (4, 16)))

        def state():
            if update == "fused_bucket":
                return _fused_state()
            return ttrain.create_train_state(_model(), ttrain.adamw(1e-3))

        def steps(st, cache):
            step = ttrain.make_accum_train_step(
                _loss, microbatches=2, update=update, aot_cache=cache)
            out = []
            for _ in range(2):
                st, m = step(st, {"x": x})
                out.append(float(m["loss"]))
            return st, out

        ref, ref_losses = steps(state(), None)
        cache = AOTCache(str(tmp_path))
        a, losses_a = steps(state(), cache)
        assert (cache.misses, cache.puts, cache.hits) == (1, 1, 0)
        b, losses_b = steps(state(), AOTCache(str(tmp_path)))
        assert losses_a == losses_b == ref_losses
        for (n, p), q, r in zip(ref.model.named_parameters(),
                                a.model.parameters(),
                                b.model.parameters()):
            assert torch.equal(p, q) and torch.equal(p, r), n
        reader = AOTCache(str(tmp_path))
        steps(state(), reader)
        assert (reader.hits, reader.misses) == (1, 0)

    def test_entry_is_the_library_set_not_the_geometry(self, tmp_path,
                                                       monkeypatch):
        """Another state or batch geometry launches the same libraries
        and hits the one entry; a step resolves once, at its first call;
        a toolchain drift misses."""
        x = torch.zeros((4, 16), dtype=torch.long)
        cache = AOTCache(str(tmp_path))
        for n_layers in (2, 2, 3):
            st = ttrain.create_train_state(
                get_model("llama-tiny", device="cpu", n_layers=n_layers),
                ttrain.adamw(1e-3))
            step = ttrain.make_accum_train_step(_loss, microbatches=2,
                                                aot_cache=cache)
            step(st, {"x": x})
        step(st, {"x": torch.zeros((2, 16), dtype=torch.long)})
        assert (cache.misses, cache.hits) == (1, 2)
        assert len(cache.entries()) == 1
        real = aot.runtime_fingerprint
        monkeypatch.setattr(aot, "runtime_fingerprint", lambda device=None:
                            dict(real(device), torch="0.0"))
        step = ttrain.make_accum_train_step(_loss, microbatches=2,
                                            aot_cache=cache)
        step(st, {"x": x})
        assert cache.misses == 2 and len(cache.entries()) == 2

    def test_shared_aot_cache_reads_the_env(self, tmp_path, monkeypatch):
        monkeypatch.delenv(constants.ENV_TRAIN_AOT_CACHE, raising=False)
        assert ttrain.shared_aot_cache() is None
        monkeypatch.setenv(constants.ENV_TRAIN_AOT_CACHE, str(tmp_path))
        cache = ttrain.shared_aot_cache()
        assert isinstance(cache, AOTCache) and cache.root == tmp_path
        assert ttrain.shared_aot_cache(str(tmp_path / "x")).root == \
            tmp_path / "x"

    def test_mesh_and_quant_still_raise(self, tmp_path):
        # A mesh is ported (tests/test_torch_zero3.py): anything but a
        # built Mesh is refused; the int8 gathers are ported
        # (tests/test_torch_quant_gather.py) and quantize the bucketed
        # gather's buckets only.
        with pytest.raises(TypeError, match="Mesh"):
            ttrain.make_accum_train_step(_loss, mesh=object(),
                                         microbatches=2,
                                         aot_cache=AOTCache(str(tmp_path)))
        with pytest.raises(ValueError, match="bucket boundary"):
            ttrain.make_accum_train_step(_loss, microbatches=2, quant=True,
                                         gather="per_leaf",
                                         aot_cache=AOTCache(str(tmp_path)))


# ---------------------------------------------------------------------------
# Through the JAX control plane
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("aot_ckpt") / "ckpt"
    state = ttrain.create_train_state(_model(), ttrain.adamw(1e-3))
    saver = ckpt.AsyncCheckpointer(root)
    saver.save(ckpt.encode_portable(state), step=1, block=True)
    saver.close()
    publish.publish_step(str(root), 1)
    return str(root)


def _standby(root, **kw):
    return Replica(model_name="llama-tiny",
                   model_kwargs={"device": "cpu", "dtype": torch.float32},
                   ckpt_dir=root, ctx_max=64, block_size=8, q_block=16,
                   max_running=4, **kw)


def _wire(rep, **extra):
    """The replica's stats as the executor's heartbeat carries them."""
    return normalize_serve_telemetry(json.loads(json.dumps(
        dict(rep.engine.stats(), **extra))))


class _FakeContainer:
    def __init__(self, cid):
        self.container_id = cid
        self.is_running = True


class _FakeScheduler:
    def __init__(self):
        self.launched = []

    def launch(self, req):
        self.launched.append(req)
        return _FakeContainer(f"c{len(self.launched)}")

    def stop_container(self, c):
        c.is_running = False

    def poll_completed(self):
        return []

    def stop(self):
        pass


def _make_am(conf_pairs, tmp_path, app_id):
    conf = JTonyConfig(conf_pairs)
    sched = _FakeScheduler()
    am = ApplicationMaster(conf, app_id, tmp_path, scheduler=sched)
    session = TonySession(conf, app_id)
    am.session = session
    am.handler = SimpleNamespace(_all_registered_fired=True)
    am.server = SimpleNamespace(port=1)
    return am, session, sched


class TestControlPlane:
    def test_replica_standby_promote_republishes(self, port_root, tmp_path):
        rep = _standby(port_root, warm_standby=True)
        assert rep.warmed == 2 and rep.engine.warm_standby
        stats = tmp_path / "stats.json"
        stop = threading.Event()
        th = threading.Thread(
            target=rep.serve_forever, daemon=True, kwargs=dict(
                host="127.0.0.1", stats_path=str(stats),
                stats_every_s=3600.0, stop=stop))
        th.start()
        try:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and not stats.exists():
                time.sleep(0.02)
            assert json.loads(stats.read_text())["warm_standby"] == 1.0
            handler = rep.rpc_handler()
            # The publisher ticks once an hour: only promote's own
            # republish can flip the file.
            assert handler.rpc_promote() is True
            assert json.loads(stats.read_text())["warm_standby"] == 0.0
            assert handler.rpc_promote() is False
        finally:
            stop.set()
            th.join(timeout=10)
        assert rep.generate(PROMPTS[0], 3).tokens == _standby(
            port_root).generate(PROMPTS[0], 3).tokens

    def test_heartbeat_keeps_the_standby_unrouted_until_promoted(
            self, port_root, tmp_path):
        rep = _standby(port_root, warm_standby=True)
        conf = JTonyConfig({"tony.serve.instances": "1",
                            "tony.serve.command": "x"})
        session = TonySession(conf, app_id="app_port_standby_hb")
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
            target=rep.serve_forever, daemon=True,
            kwargs=dict(host="127.0.0.1",
                        stats_path=str(executor.serve_stats_path()),
                        stats_every_s=0.05, stop=stop))
        serving.start()
        beat = threading.Thread(target=executor._heartbeat_loop,
                                args=(0.05,), daemon=True)
        beat.start()
        try:
            task = session.task("serve", 0)

            def wait_for(pred):
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline and not pred():
                    time.sleep(0.05)
                return pred()

            assert wait_for(lambda: task.serve_metrics.get("rpc_port"))
            assert task.serve_metrics["warm_standby"] == 1.0
            assert task.serve_metrics["aot_misses"] == 0.0
            assert session.serve_samples("serve")[0]["warm_standby"] == 1.0
            assert session.serve_endpoints("serve") == []
            assert rep.promote() is True
            assert wait_for(lambda: session.serve_endpoints("serve"))
            assert task.serve_metrics["warm_standby"] == 0.0
        finally:
            executor._hb_stop.set()
            beat.join(timeout=5)
            stop.set()
            serving.join(timeout=10)
            am.stop()

    def test_am_promote_rpc_reaches_the_port_replica(self, port_root,
                                                     tmp_path):
        rep = _standby(port_root, warm_standby=True)
        server = RpcServer(rep.rpc_handler(), host="127.0.0.1").start()
        try:
            am, session, sched = _make_am(
                {"tony.serve.instances": "1", "tony.serve.command": "x",
                 "tony.serve.replicas.max": "4",
                 "tony.serve.scale.cooldown-s": "0"},
                tmp_path, "app_port_promote")
            session.on_registered("serve", 0, "127.0.0.1", 1)
            session.on_heartbeat("serve", 0, serve={
                "qps": 1.0, "p99_ms": 5.0, "queue_depth": 50.0})
            standby = session.add_task("serve")
            session.on_registered("serve", standby.index, "127.0.0.1", 2)
            session.on_heartbeat("serve", standby.index, serve=_wire(
                rep, rpc_port=float(server.port)))
            assert len(session.serve_endpoints("serve")) == 1
            am._autoscale_serve(session)
            assert rep.engine.warm_standby is False   # promoted over RPC
            assert sched.launched == []               # not a grant
            assert standby.serve_metrics["warm_standby"] == 0.0
            assert len(session.serve_endpoints("serve")) == 2
        finally:
            server.stop()

    def test_promote_rpc_failure_falls_back_to_cold_grant(self, port_root,
                                                          tmp_path):
        rep = _standby(port_root, warm_standby=True)
        am, session, sched = _make_am(
            {"tony.serve.instances": "1", "tony.serve.command": "x",
             "tony.serve.replicas.max": "4",
             "tony.serve.scale.cooldown-s": "0"},
            tmp_path, "app_port_promote_fb")
        session.on_registered("serve", 0, "127.0.0.1", 1)
        session.on_heartbeat("serve", 0, serve={
            "qps": 1.0, "p99_ms": 5.0, "queue_depth": 50.0})
        standby = session.add_task("serve")
        session.on_registered("serve", standby.index, "127.0.0.1", 2)
        # The standby's stats, but a dead promote port: the dial fails
        # and the AM cold-grants instead.
        session.on_heartbeat("serve", standby.index, serve=_wire(
            rep, rpc_port=1.0))
        am._autoscale_serve(session)
        assert len(sched.launched) == 1
        assert standby.serve_metrics["warm_standby"] == 1.0
        assert rep.engine.warm_standby is True
