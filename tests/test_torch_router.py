"""Port parity for the fleet's request router (tony_tpu_torch.serve.router,
``tony_tpu_torch.cli route``): the reference's TestRouter and
TestRoutedServing (tests/test_route.py) rebuilt on the port's router and
engines; the router copy against the JAX one on a seeded random sequence
of membership, telemetry, ``route``, ``route_split`` and retirement
calls (the same choices, the same scores, the same counters); and the
``route`` subcommand as a process polling the port AM's
``serve_endpoints`` verb and dispatching to a port replica over the RPC
wire. llama-tiny, 2 layers, on the CPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tony_tpu.serve import prefix as jprefix
from tony_tpu.serve import router as jrouter
from tony_tpu_torch.rpc import RpcClient, RpcError, RpcServer
from tony_tpu_torch.serve import (AdmissionError, EngineFront, ServeEngine,
                                  prefix)
from tony_tpu_torch.serve.router import (NoReplicaError, ReplicaView,
                                         RequestRouter, RouterPolicy,
                                         RouterServer, score)

ROOT = Path(__file__).resolve().parent.parent
ENGINE_KW = dict(ctx_max=64, block_size=8, q_block=16, decode_buckets=(2, 4),
                 max_running=4, keep_logits=False, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    from tony_tpu_torch.models import get_model

    return get_model("llama-tiny", n_layers=2, dtype=torch.bfloat16,
                     param_dtype=torch.bfloat16, device="cpu", seed=0)


def make_engine(model, **kw):
    return ServeEngine(model, **{**ENGINE_KW, **kw})


class _Stub:
    """A replica transport answering ``generate`` with a fixed token."""

    def __init__(self, name, calls=None, token=0):
        self.name, self.calls, self.token = name, calls, token

    def generate(self, tokens, max_new_tokens, rid=None, conv=None):
        if self.calls is not None:
            self.calls.append((self.name, conv))
        return {"rid": rid, "tokens": [self.token], "latency_ms": 1.0}


# ---------------------------------------------------------------------------
# Router scoring / affinity / failover (pure + in-process)
# ---------------------------------------------------------------------------

class TestRouter:
    def _keys(self, toks):
        return prefix.chain_keys(toks, 16)

    def test_score_prefers_overlap_then_load(self):
        pol = RouterPolicy()
        keys = self._keys(list(range(48)))
        warm = ReplicaView(name="warm", address="x", digest=frozenset(keys))
        cold = ReplicaView(name="cold", address="x")
        busy = ReplicaView(name="busy", address="x", digest=frozenset(keys),
                           queue_depth=16.0)
        assert score(pol, warm, keys) > score(pol, cold, keys)
        assert score(pol, cold, keys) > score(pol, busy, keys), \
            "a deep queue must outweigh cache overlap"

    def test_policy_validation(self):
        with pytest.raises(ValueError):
            RouterPolicy(cache_weight=-1.0)

    def test_sticky_affinity_and_retirement_failover(self):
        calls = []
        rt = RequestRouter(block_size=16)
        rt.upsert_replica("a", client=_Stub("a", calls),
                          stats={"queue_depth": 0.0})
        rt.upsert_replica("b", client=_Stub("b", calls),
                          stats={"queue_depth": 5.0})
        first = rt.dispatch(list(range(16)), 2, session_id="s1")
        assert first["replica"] == "a"          # lighter load wins
        rt.upsert_replica("a", stats={"queue_depth": 50.0})
        again = rt.dispatch(list(range(16)), 2, session_id="s1")
        assert again["replica"] == "a", "affinity must out-pin load"
        assert rt.affinity_hits == 1
        rt.retire_replica("a")
        moved = rt.dispatch(list(range(16)), 2, session_id="s1")
        assert moved["replica"] == "b", "retirement must re-dispatch"
        assert [n for n, _ in calls] == ["a", "a", "b"]

    def test_parked_digest_repins_returning_conversation(self):
        seen = []
        rt = RequestRouter(block_size=16)
        rt.upsert_replica("cold", client=_Stub("cold", seen),
                          stats={"queue_depth": 0.0})
        rt.upsert_replica("warm", client=_Stub("warm", seen),
                          stats={"queue_depth": 5.0,
                                 "parked_digest": ["turnful"]})
        out = rt.dispatch(list(range(16)), 2, session_id="turnful")
        assert out["replica"] == "warm"
        assert rt.stats()["park_pins"] == 1.0
        assert seen == [("warm", "turnful")]
        rt.dispatch(list(range(16)), 2, session_id="turnful")
        assert rt.affinity_hits == 1 and rt.stats()["park_pins"] == 1.0

        class Legacy:
            def generate(self, tokens, max_new_tokens, rid=None):
                return {"rid": rid, "tokens": [1], "latency_ms": 1.0}

        rt.upsert_replica("cold", client=Legacy(),
                          stats={"queue_depth": 0.0})
        assert rt.dispatch([1, 2], 2)["tokens"] == [1], \
            "a sessionless dispatch ships no conv"

    def test_dead_replica_fails_over_and_revives_on_heartbeat(self):
        class Dead:
            def generate(self, *a, **k):
                raise ConnectionError("gone")

        rt = RequestRouter(block_size=16)
        rt.upsert_replica("x", client=Dead(), stats={"queue_depth": 0.0})
        rt.upsert_replica("y", client=_Stub("y"),
                          stats={"queue_depth": 1.0})
        out = rt.dispatch(list(range(16)), 2, session_id="s")
        assert out["replica"] == "y" and rt.failovers == 1
        rt.upsert_replica("x", stats={"queue_depth": 0.0})
        assert rt.route(list(range(16))) == "x"

    def test_no_replica_error(self):
        with pytest.raises(NoReplicaError):
            RequestRouter().route([1, 2, 3])

    def test_request_level_error_does_not_poison_fleet(self):
        class Healthy:
            def generate(self, tokens, max_new_tokens, rid=None):
                if len(tokens) > 4:
                    raise AdmissionError("too big", retryable=False)
                return {"rid": rid, "tokens": [0], "latency_ms": 1.0}

        rt = RequestRouter(block_size=16)
        rt.upsert_replica("a", client=Healthy(), stats={"queue_depth": 0.0})
        with pytest.raises(AdmissionError):
            rt.dispatch(list(range(10)), 2)
        assert rt.failovers == 0 and rt.replicas()[0].alive
        assert rt.dispatch([1, 2], 2)["tokens"] == [0]

    def test_cache_aware_routing_wins_on_digest(self, tiny):
        """The replica that served a conversation advertises its blocks
        and the follow-up routes there. In process and deterministic:
        the heartbeat here carries the digest and the queue, not the
        latency window whose timing made the reference's copy flaky."""
        e1 = make_engine(tiny, prefix_cache=True)
        e2 = make_engine(tiny, prefix_cache=True)
        rt = RequestRouter(block_size=8)
        rt.upsert_replica("r1", client=EngineFront(e1))
        rt.upsert_replica("r2", client=EngineFront(e2))
        rng = np.random.RandomState(8)
        convo = [int(t) for t in rng.randint(0, 256, 17)]
        first = rt.dispatch(convo, 4)
        served_by = first["replica"]

        def beat():
            for name, e in (("r1", e1), ("r2", e2)):
                rt.upsert_replica(name, stats={
                    "queue_depth": float(e.queue_depth),
                    "running": float(e.running),
                    "prefix_digest": e.prefix_digest()})

        beat()
        follow = convo + list(first["tokens"]) + [5, 6, 7]
        assert rt.route(follow) == served_by
        eng = e1 if served_by == "r1" else e2
        hits = eng.prefix_hit_blocks
        assert rt.dispatch(follow, 2)["replica"] == served_by
        assert eng.prefix_hit_blocks > hits, "the follow-up adopted"
        assert rt.cache_routed >= 1


# ---------------------------------------------------------------------------
# Routed multi-replica serving vs one unrouted replica
# ---------------------------------------------------------------------------

class _Replica:
    """The request surface of ``serve.replica.Replica`` over an engine
    built here (no checkpoint restore), for the replica's own RPC
    handler."""

    def __init__(self, eng):
        self.engine = eng
        self.front = EngineFront(eng)

    def generate(self, tokens, max_new_tokens, rid=None, conv=None,
                 tenant=None):
        return self.front.generate(tokens, max_new_tokens, rid=rid,
                                   conv=conv, tenant=tenant)


def _serve(eng):
    from tony_tpu_torch.serve.replica import _ReplicaRpcHandler

    return RpcServer(_ReplicaRpcHandler(_Replica(eng)),
                     host="127.0.0.1").start()


class TestRoutedServing:
    def test_two_replica_routed_bitwise_vs_single(self, tiny):
        """The same requests through the router over two prefix-cache
        replicas (shared prefixes cached, routed by the digests the
        heartbeats carry; sessions are refused until the host tier is
        ported) give one unrouted engine's token streams."""
        rng = np.random.RandomState(9)
        stems = [[int(t) for t in rng.randint(0, 256, 16)]
                 for _ in range(2)]
        requests = []
        for i in range(10):
            requests.append((f"sess{i % 3}", stems[i % 2] + [
                int(t) for t in rng.randint(0, 256, 1 + i % 5)], 3 + i % 3))
        ref_front = EngineFront(make_engine(tiny, max_running=8))
        ref = [ref_front.generate(p, n).tokens for (_, p, n) in requests]
        e1 = make_engine(tiny, max_running=8, prefix_cache=True)
        e2 = make_engine(tiny, max_running=8, prefix_cache=True)
        rt = RequestRouter(block_size=8)
        rt.upsert_replica("r1", client=EngineFront(e1))
        rt.upsert_replica("r2", client=EngineFront(e2))
        got = []
        for _, p, n in requests:
            got.append(rt.dispatch(p, n)["tokens"])
            for name, e in (("r1", e1), ("r2", e2)):
                rt.upsert_replica(name, stats={
                    **e.stats(), "prefix_digest": e.prefix_digest()})
        assert got == ref
        assert e1.forwards > 0 and e2.forwards > 0, \
            "the router must spread the fleet"
        assert rt.stats()["dispatched"] == len(requests)

    def test_router_server_over_rpc_with_failover(self, tiny):
        """Two port replicas over RPC behind a RouterServer; the chosen
        one dies and the request re-dispatches to the other with the
        same greedy stream."""
        s1, s2 = _serve(make_engine(tiny)), _serve(make_engine(tiny))
        router = RequestRouter(block_size=8, dial_timeout_s=2.0)
        router.upsert_replica("r1", address=s1.address,
                              stats={"queue_depth": 0.0})
        router.upsert_replica("r2", address=s2.address,
                              stats={"queue_depth": 1.0})
        try:
            with RouterServer(router, host="127.0.0.1") as front:
                with RpcClient(front.address, timeout=60.0) as client:
                    out = client.call("generate", tokens=[1, 2, 3, 4],
                                      max_new_tokens=3)
                    assert out["replica"] == "r1"
                    s1.stop()               # the chosen replica dies
                    out2 = client.call("generate", tokens=[1, 2, 3, 4],
                                       max_new_tokens=3)
                    assert out2["replica"] == "r2"
                    assert out2["tokens"] == out["tokens"]
                    assert client.call("router_stats")["failovers"] >= 1
        finally:
            s2.stop()

    def test_sessions_and_tenants_refused_before_a_port_replica(self,
                                                               tiny):
        """Sessions and tenants (refused before the host tier and QoS
        were ported) reach the port's replicas through the router's RPC
        front: two turns under one ``session_id`` land on the same
        host-tier replica, whose second turn resumes the parked first
        (``park_hits`` 1), and the ``tenant`` reaches the engine as the
        QoS class. The tokens are a plain engine's."""
        engines = [make_engine(tiny, host_blocks=32) for _ in range(2)]
        servers = [_serve(e) for e in engines]
        router = RequestRouter(block_size=8)
        for i, (e, srv) in enumerate(zip(engines, servers)):
            router.upsert_replica(f"r{i}", address=srv.address,
                                  stats=e.stats())
        plain = EngineFront(make_engine(tiny))
        rng = np.random.RandomState(12)
        turn1 = [int(t) for t in rng.randint(0, 256, 11)]
        try:
            with RouterServer(router, host="127.0.0.1") as front:
                with RpcClient(front.address, timeout=60.0) as client:
                    out1 = client.call("generate", tokens=turn1,
                                       max_new_tokens=3, session_id="s",
                                       tenant="gold")
                    turn2 = turn1 + out1["tokens"] + [5, 6, 7]
                    out2 = client.call("generate", tokens=turn2,
                                       max_new_tokens=3, session_id="s",
                                       tenant="gold")
                    stats = client.call("router_stats")
            assert out2["replica"] == out1["replica"]
            assert out1["tokens"] == plain.generate(turn1, 3).tokens
            assert out2["tokens"] == plain.generate(turn2, 3).tokens
            eng = engines[int(out1["replica"][1:])]
            assert eng.park_hits == 1 and eng.parked_digest() == ["s"]
            assert eng.stats()["tenants"]["gold"]["completed"] == 2.0
            assert stats["dispatched"] == 2 and stats["failovers"] == 0
        finally:
            for srv in servers:
                srv.stop()

    def test_live_rid_resent_is_refused(self, tiny):
        """A ``generate`` sent again over RPC under a rid that is still
        queued (a re-send after a transport fault) is refused with a
        ``ValueError`` before it reaches the loop; the first request
        completes untouched."""
        import threading

        from tony_tpu_torch.serve.replica import _ReplicaRpcHandler

        eng = make_engine(tiny)
        rep = _Replica(eng)
        srv = RpcServer(_ReplicaRpcHandler(rep), host="127.0.0.1").start()
        prompt = [1, 2, 3, 4, 5]
        want = EngineFront(make_engine(tiny)).generate(prompt, 6).tokens
        first = {}
        try:
            with rep.front._drive:          # the first request waits queued
                def send():
                    with RpcClient(srv.address, timeout=60.0) as client:
                        first.update(client.call(
                            "generate", tokens=prompt, max_new_tokens=6,
                            rid="dup"))

                t = threading.Thread(target=send)
                t.start()
                deadline = time.monotonic() + 30
                while eng.queue_depth == 0:
                    assert time.monotonic() < deadline, "never submitted"
                    time.sleep(0.01)
                with RpcClient(srv.address, timeout=60.0) as client:
                    with pytest.raises(RpcError,
                                       match=r"^ValueError: .*'dup' is live"):
                        client.call("generate", tokens=prompt,
                                    max_new_tokens=6, rid="dup")
                assert eng.queue_depth == 1
            t.join(timeout=60)
            assert first["tokens"] == want
            assert eng.stats()["completed"] == 1.0
        finally:
            srv.stop()

    @pytest.mark.parametrize("stage", ["prefilling", "running"])
    def test_live_rid_resent_mid_request_is_refused(self, tiny, stage):
        """A rid submitted again while its first request is in its first
        prefill (out of the queue, in no list yet) or running between
        decode steps is refused with a ``ValueError`` and queues
        nothing; the first request completes as a plain engine's."""
        from tony_tpu_torch.serve import Request

        eng = make_engine(tiny)
        prompt = [1, 2, 3, 4, 5]
        want = EngineFront(make_engine(tiny)).generate(prompt, 6).tokens
        refused = []

        def resend():
            with pytest.raises(ValueError, match=r"'dup' is live"):
                eng.submit(Request(rid="dup", tokens=prompt,
                                   max_new_tokens=6))
            refused.append(eng.queue_depth)

        name = "_prefill" if stage == "prefilling" else "_decode"
        inner = getattr(eng, name)

        def hooked(*args):
            if not refused:
                resend()
            return inner(*args)

        setattr(eng, name, hooked)
        got = EngineFront(eng).generate(prompt, 6, rid="dup")
        assert refused == [0]
        assert got.tokens == want
        assert eng.stats()["completed"] == 1.0

    def test_router_dial_waits_for_a_slow_reply(self, monkeypatch):
        """A replica's ``generate`` replies when its generation ends. The
        router's own dial waits for that reply past the RPC client's
        per-operation cap and sends the call once; a client with the
        cap alone (the reference's dial) sends it again under the same
        rid, counted in ``rpc.RESENDS``."""
        import threading

        from tony_tpu_torch import rpc as rpc_mod

        calls = []
        lock = threading.Lock()

        class Slow:
            def rpc_generate(self, tokens, max_new_tokens=16, rid=None,
                             conv=None, tenant=None):
                with lock:
                    calls.append(rid)
                time.sleep(0.6)
                return {"rid": rid, "tokens": [7], "latency_ms": 600.0}

        monkeypatch.setattr(rpc_mod.RpcClient, "SOCKET_TIMEOUT_S", 0.2)
        srv = RpcServer(Slow(), host="127.0.0.1").start()
        try:
            before = rpc_mod.RESENDS.get("generate", 0)
            router = RequestRouter(block_size=8)
            router.upsert_replica("r", address=srv.address)
            out = router.dispatch([1, 2, 3], 1, rid="once")
            assert out["tokens"] == [7] and calls == ["once"]
            assert rpc_mod.RESENDS.get("generate", 0) == before
            assert router.stats()["failovers"] == 0
            with pytest.raises(ConnectionError):
                with RpcClient(srv.address, timeout=0.5) as client:
                    client.call("generate", tokens=[1], rid="twice")
            assert calls.count("twice") >= 2
            assert rpc_mod.RESENDS.get("generate", 0) >= before + 2
        finally:
            srv.stop()

    def test_cli_route_parser_and_serve_flags(self, tmp_path):
        from tony_tpu_torch import cli

        args = cli.make_parser().parse_args([
            "route", "--am", "127.0.0.1:9999", "--block_size", "8"])
        assert args.fn.__name__ == "cmd_route"
        assert (args.cache_weight, args.queue_weight, args.p99_weight,
                args.poll_s, args.block_size) == (4.0, 1.0, 0.5, 2.0, 8)
        sv = cli.make_parser().parse_args([
            "serve", "--model", "llama-tiny", "--ckpt_dir", str(tmp_path),
            "--prefix_cache", "--prefill_chunk", "32"])
        assert sv.prefix_cache and sv.prefill_chunk == 32
        bad = cli.make_parser().parse_args([
            "serve", "--model", "llama-tiny", "--ckpt_dir", str(tmp_path),
            "--prefill_chunk", "12"])
        with pytest.raises(SystemExit, match="prefill_chunk"):
            cli.serve_conf(bad)
        bad_tier = cli.make_parser().parse_args([
            "serve", "--model", "llama-tiny", "--ckpt_dir", str(tmp_path),
            "--host_blocks", "-1"])
        with pytest.raises(SystemExit, match="host_blocks"):
            cli.serve_conf(bad_tier)


# ---------------------------------------------------------------------------
# The copy against the JAX router
# ---------------------------------------------------------------------------

class TestRouterParity:
    def test_policy_defaults_equal(self):
        assert RouterPolicy() == RouterPolicy(
            **{f: getattr(jrouter.RouterPolicy(), f)
               for f in ("cache_weight", "queue_weight", "p99_weight",
                         "stale_s")})
        assert ReplicaView(name="x").role == jrouter.ReplicaView(
            name="x").role == "colocated"

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_calls_make_the_same_choices(self, seed):
        """The same seeded sequence of upserts (with roles, queues,
        p99s and digests), retirements, ``route`` and ``route_split``
        calls (with and without sessions) on both routers: every choice,
        every score and every counter equal."""
        rng = np.random.RandomState(seed)
        bs = 4
        ours, ref = RequestRouter(block_size=bs), \
            jrouter.RequestRouter(block_size=bs)
        stems = [[int(t) for t in rng.randint(0, 64, 12)] for _ in range(3)]
        names = [f"{role}:{i}" for role in ("prefill", "decode", "serve")
                 for i in range(2)]
        for step in range(120):
            op = rng.randint(0, 5)
            name = names[rng.randint(len(names))]
            toks = stems[rng.randint(3)][:rng.randint(1, 13)] + \
                [int(t) for t in rng.randint(0, 64, rng.randint(0, 6))]
            session = f"s{rng.randint(4)}" if rng.rand() < 0.5 else None
            if op == 0:
                stats = {"queue_depth": float(rng.randint(4)),
                         "running": float(rng.randint(3)),
                         "p99_ms": float(rng.randint(0, 2000)),
                         "role": name.split(":")[0]
                         .replace("serve", "colocated"),
                         "prefix_digest": jprefix.chain_keys(
                             stems[rng.randint(3)], bs)[:rng.randint(4)]}
                for r in (ours, ref):
                    r.upsert_replica(name, address=f"h:{step}", stats=stats)
            elif op == 1:
                for r in (ours, ref):
                    r.retire_replica(name)
            elif op == 2:
                got = [None, None]
                for i, r in enumerate((ours, ref)):
                    try:
                        got[i] = r.route(toks, session_id=session)
                    except (NoReplicaError, jrouter.NoReplicaError) as e:
                        got[i] = type(e).__name__
                assert got[0] == got[1], step
            elif op == 3:
                assert ours.route_split(toks, session_id=session) == \
                    ref.route_split(toks, session_id=session), step
            else:
                keys = prefix.chain_keys(toks, bs)
                assert keys == jprefix.chain_keys(toks, bs)
                for v, w in zip(ours.replicas(), ref.replicas()):
                    assert (v.name, v.role, v.retired, v.digest) == \
                        (w.name, w.role, w.retired, w.digest)
                    assert score(ours.policy, v, keys) == \
                        jrouter.score(ref.policy, w, keys)
        assert ours.stats() == ref.stats()


# ---------------------------------------------------------------------------
# `tony_tpu_torch.cli route` as a process against the port's AM verb
# ---------------------------------------------------------------------------

class TestRouteCommand:
    def test_route_process_polls_the_am_and_dispatches(self, tiny,
                                                       tmp_path):
        """The port AM's ``serve_endpoints`` (a session with one serve
        replica that heartbeats its ``rpc_port``) behind the port's RPC
        server; ``python -m tony_tpu_torch.cli route --am`` polls it
        and forwards ``generate`` to the replica."""
        from tony_tpu_torch.conf import TonyConfig
        from tony_tpu_torch.rpc import ApplicationRpcHandler
        from tony_tpu_torch.session import TonySession

        eng = make_engine(tiny)
        front = EngineFront(eng)

        class Replica:
            def rpc_generate(self, tokens, max_new_tokens=16, rid=None,
                             conv=None, tenant=None):
                return front.generate(tokens, max_new_tokens,
                                      rid=rid).wire()

        replica = RpcServer(Replica(), host="127.0.0.1").start()
        session = TonySession(TonyConfig({"tony.serve.instances": "1",
                                          "tony.serve.command": "x"}),
                              "app_route")
        handler = ApplicationRpcHandler(session)
        session.on_registered("serve", 0, "127.0.0.1", 1)
        handler.rpc_heartbeat("serve", 0, serve={
            **eng.stats(), "rpc_port": replica.port})
        am = RpcServer(handler, host="127.0.0.1").start()
        proc = subprocess.Popen(
            [sys.executable, "-m", "tony_tpu_torch.cli", "route", "--am",
             am.address, "--block_size", "8", "--poll_s", "0.1"],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            line = proc.stdout.readline()
            assert "[tony-route] listening on" in line, line
            port = int(line.split(" listening on ")[1].split(",")[0]
                       .rsplit(":", 1)[1])
            with RpcClient(f"127.0.0.1:{port}", timeout=30.0) as client:
                deadline = time.monotonic() + 30
                while client.call("router_stats")["replicas_live"] < 1:
                    assert time.monotonic() < deadline, "no poll landed"
                    time.sleep(0.1)
                out = client.call("generate", tokens=[1, 2, 3, 4, 5],
                                  max_new_tokens=3, rid="via-route")
            ref = EngineFront(make_engine(tiny)).generate([1, 2, 3, 4, 5], 3)
            assert out["tokens"] == ref.tokens
            assert out["replica"] == "serve:0" and out["rid"] == "via-route"
        finally:
            proc.kill()
            proc.wait(timeout=10)
            proc.stdout.close()
            am.stop()
            replica.stop()

    def test_route_imports_no_tensor_library(self):
        """The router and the handoff's error type load on a gateway
        host without torch (or jax)."""
        code = ("import sys; import tony_tpu_torch.serve.router, "
                "tony_tpu_torch.cli; from tony_tpu_torch.serve import "
                "HandoffError, RequestRouter; print(json.dumps(sorted("
                "m for m in ('torch', 'jax', 'tony_tpu') if m in "
                "sys.modules)))")
        out = subprocess.run([sys.executable, "-c", "import json; " + code],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=60, env={**os.environ,
                                              "PYTHONPATH": str(ROOT)})
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout) == []
