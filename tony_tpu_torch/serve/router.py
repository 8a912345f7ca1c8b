"""Cross-replica request router: the counterpart of
:mod:`tony_tpu.serve.router` — the fleet, not a replica, is the unit of
serving throughput.

A gateway-side router over the live replica set that decides WHERE each
generation runs, by three scoring signals per replica that the fleet
already ships on the executor heartbeat:

* **prefix-cache overlap** — the router chain-hashes the prompt's KV
  blocks (:mod:`tony_tpu_torch.serve.prefix`, the key scheme the replica
  pool uses) and matches them against each replica's advertised block
  digest: a replica already holding the prefix skips that much prefill;
* **load** — queue depth and in-flight occupancy;
* **tail latency** — p99 over the replica's stats window.

Sticky session affinity rides on top: a ``session_id`` pins its
follow-up turns to the replica that served them, until that replica
retires or fails — then the router re-dispatches against the scores and
re-pins. A dead replica's request re-routes to the next-best candidate
and the replica is marked down until a fresh heartbeat revives it.

Role-aware dispatch (:mod:`tony_tpu_torch.serve.disagg`): a fleet with
live ``prefill`` and ``decode`` replicas sends the prompt to a prefill
replica, which ships the KV blocks to the decode replica the router
picked (:meth:`RequestRouter.route_split`); a colocated fleet runs the
plain path.

Free of any tensor library, like the reference: the router runs on a
gateway host (``tony_tpu_torch.cli route``) with no accelerator stack.
Transports are pluggable — tests drive in-process
:class:`~tony_tpu_torch.serve.engine.EngineFront` replicas, production
dials the replica RPC port carried on the heartbeat (``rpc_port``/host,
surfaced by the AM's ``serve_endpoints`` verb).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from tony_tpu_torch.serve import prefix as prefix_mod
from tony_tpu_torch.serve.disagg import HandoffError


def _wire_completion(out: Any, rid: Optional[Any]) -> Dict[str, Any]:
    """Duck-typed completion -> wire dict, ONE definition for every
    dispatch path (the router is jax-free, so it mirrors
    ``engine.Completion.wire`` by shape instead of importing it). RPC
    transports already return the dict."""
    if isinstance(out, dict):
        return out
    return {"rid": getattr(out, "rid", rid),
            "tokens": list(out.tokens),
            "latency_ms": round(1e3 * out.latency_s, 3)}


class NoReplicaError(RuntimeError):
    """Every known replica is retired or down — the fleet cannot take
    the request (surface to the caller as back-pressure, like an
    AdmissionError one level up)."""


@dataclasses.dataclass(frozen=True)
class RouterPolicy:
    """Scoring weights for one route decision. The score is
    ``cache_weight · overlap_fraction − queue_weight · queue_depth −
    p99_weight · p99_seconds`` — overlap is normalized to the prompt's
    block count (a whole-prompt hit is worth ``cache_weight`` no matter
    the prompt length), load terms are raw (one queued request offsets
    a ``1/queue_weight`` overlap fraction). Deliberately linear and
    jax-free: unit-testable like :class:`~tony_tpu.serve.scaling.
    ScalingPolicy`, and the AM glue stays a dumb applier."""
    cache_weight: float = 4.0
    queue_weight: float = 1.0
    p99_weight: float = 0.5
    # A replica whose last heartbeat is older than this is scored as
    # down (dispatch still tries it LAST rather than never — a stale
    # clock must not brick a one-replica fleet).
    stale_s: float = 30.0

    def __post_init__(self):
        if self.cache_weight < 0 or self.queue_weight < 0 \
                or self.p99_weight < 0:
            raise ValueError("router weights must be >= 0, got "
                             f"{self.cache_weight}/{self.queue_weight}/"
                             f"{self.p99_weight}")


@dataclasses.dataclass
class ReplicaView:
    """The router's picture of one replica: identity, transport, and
    the latest heartbeat-derived telemetry."""
    name: str
    address: Optional[str] = None        # host:port of the replica RPC
    client: Optional[Any] = None         # in-process transport override
    queue_depth: float = 0.0
    running: float = 0.0
    p99_ms: float = 0.0
    digest: frozenset = frozenset()
    # Parked-conversation handles: the conversations whose KV
    # this replica holds in its host-offload tier — a returning turn
    # re-pinned here resumes without a re-prefill, so the parked set
    # outranks the overlap score for its own conversations.
    parked: frozenset = frozenset()
    # Disaggregated-serving role (tony_tpu_torch.serve.disagg): "prefill" /
    # "decode" replicas split the request into a prefill dispatch and a
    # KV handoff target; "colocated" (a replica without a role) serves
    # whole requests.
    role: str = "colocated"
    last_seen: float = 0.0
    alive: bool = True
    retired: bool = False

    def update(self, stats: Dict[str, Any], *, now: float) -> None:
        self.queue_depth = float(stats.get("queue_depth", 0.0) or 0.0)
        self.running = float(stats.get("running", 0.0) or 0.0)
        self.p99_ms = float(stats.get("p99_ms", 0.0) or 0.0)
        digest = stats.get("prefix_digest")
        if digest is not None:
            self.digest = frozenset(str(k) for k in digest)
        parked = stats.get("parked_digest")
        if parked is not None:
            self.parked = frozenset(str(c) for c in parked)
        role = stats.get("role")
        if isinstance(role, str) and role:
            self.role = role
        self.last_seen = now
        self.alive = True


def score(policy: RouterPolicy, view: ReplicaView,
          prompt_keys: Sequence[str]) -> float:
    """One replica's score for one prompt (pure — the unit-test
    surface). Cache overlap counts the longest chain-key PREFIX present
    in the replica's digest: chain keys make an interior match without
    its ancestors useless, so intersection would overcount."""
    overlap = 0.0
    if prompt_keys and view.digest:
        overlap = prefix_mod.match_overlap(prompt_keys, view.digest) \
            / len(prompt_keys)
    return (policy.cache_weight * overlap
            - policy.queue_weight * (view.queue_depth + view.running)
            - policy.p99_weight * view.p99_ms / 1e3)


class RequestRouter:
    """Route + dispatch requests over the elastic replica set.

    Thread-safe. ``block_size`` must match the fleet's engine geometry
    (the chain keys are block-aligned); ``dial`` turns an address into
    a transport for RPC replicas — anything with
    ``generate(tokens, max_new_tokens, rid=...)`` returning an object
    or mapping with a ``tokens`` field works, so in-process
    :class:`~tony_tpu_torch.serve.engine.EngineFront` instances register
    directly via ``client=``.
    """

    def __init__(self, *, block_size: int = 16,
                 policy: Optional[RouterPolicy] = None,
                 dial: Optional[Any] = None,
                 dial_timeout_s: float = 15.0):
        if block_size <= 0:
            raise ValueError(f"need positive block_size, got {block_size}")
        self.block_size = int(block_size)
        self.policy = policy or RouterPolicy()
        # Short transport retry window ON PURPOSE: a dead replica must
        # fail the attempt fast so dispatch can fail over — the long
        # wait belongs to the generation itself, not to redialing a
        # refused connection.
        self.dial_timeout_s = float(dial_timeout_s)
        self._dial = dial or (lambda addr: _rpc_dial(
            addr, self.dial_timeout_s))
        self._lock = threading.Lock()
        self._replicas: Dict[str, ReplicaView] = {}
        self._affinity: Dict[Any, str] = {}
        # Lifetime counters (the router's own stats surface).
        self.dispatched = 0
        self.failovers = 0
        self.affinity_hits = 0
        self.cache_routed = 0            # decisions won on overlap > 0
        self.handoffs = 0                # disaggregated dispatches
        self.handoff_fallbacks = 0       # handoff failed -> colocated
        self.park_pins = 0               # re-pins onto parked KV

    # -- membership --------------------------------------------------------
    def upsert_replica(self, name: str, *, address: Optional[str] = None,
                       client: Optional[Any] = None,
                       stats: Optional[Dict[str, Any]] = None) -> None:
        """Add or refresh one replica (heartbeat ingestion path). A
        refresh revives a down-marked replica — the heartbeat is the
        liveness source of truth, a failed dispatch only a hint."""
        now = time.monotonic()
        with self._lock:
            view = self._replicas.get(name)
            if view is None:
                if address is None and client is None:
                    raise ValueError(f"new replica {name!r} needs an "
                                     f"address or an in-process client")
                view = ReplicaView(name=name)
                self._replicas[name] = view
            if address is not None:
                view.address = address
            if client is not None:
                view.client = client
            view.retired = False
            if stats:
                view.update(stats, now=now)
            else:
                view.last_seen = now
                view.alive = True

    def retire_replica(self, name: str) -> None:
        """Scale-down/teardown: the replica stops receiving new work;
        sessions pinned to it re-route (and re-pin) on their next
        turn."""
        with self._lock:
            view = self._replicas.get(name)
            if view is not None:
                view.retired = True

    def refresh_from_task_infos(self, infos: Sequence[Dict[str, Any]],
                                *, job_type: Optional[str] = None) -> None:
        """Ingest the AM's ``get_task_infos`` wire form (or the
        ``serve_endpoints`` verb's output): live serve tasks whose
        heartbeat carried an ``rpc_port`` become routable replicas at
        ``host:rpc_port``; terminal tasks retire. One call wires the
        router to the whole elastic fleet — scale-ups appear, retired
        replicas drain, no per-replica plumbing. ``job_type`` filters to
        one jobtype; the default ingests every entry — a disaggregated
        fleet's prefill and decode GANGS are separate jobtypes in one
        job (the heterogeneous-gang wiring), and ``serve_endpoints``
        already scopes its output to the serve-role jobtypes."""
        for info in infos:
            jt = info.get("job_type", job_type or "serve")
            if job_type is not None and jt != job_type:
                continue
            name = f"{jt}:{info['index']}"
            metrics = dict(info.get("serve_metrics") or {})
            terminal = info.get("status") in ("SUCCEEDED", "FAILED",
                                              "LOST", "KILLED")
            if terminal:
                self.retire_replica(name)
                continue
            port = metrics.get("rpc_port")
            host = info.get("host")
            if not port or not host:
                continue            # not serving yet (no stats file)
            # Hot-swap down-mark (tony_tpu_torch.serve.swap): a replica
            # inside its swap window advertises swapping=1.0 — retire
            # it for the window so new requests land on the rest of
            # the fleet (warm standbys cover the gap). The swap's
            # immediate post-flip stats republish clears the flag, and
            # the next refresh's upsert revives the replica
            # (retired=False) — no separate re-admit verb.
            if metrics.get("swapping"):
                self.retire_replica(name)
                continue
            self.upsert_replica(name, address=f"{host}:{int(port)}",
                                stats=metrics)

    def replicas(self) -> List[ReplicaView]:
        with self._lock:
            return list(self._replicas.values())

    # -- routing -----------------------------------------------------------
    def route(self, tokens: Sequence[int],
              session_id: Optional[Any] = None) -> str:
        """The replica name for one request — sticky affinity first
        (the session's history lives in that replica's prefix cache),
        then the policy score over live candidates."""
        keys = prefix_mod.chain_keys(tokens, self.block_size)
        with self._lock:
            if session_id is not None:
                pinned = self._replicas.get(
                    self._affinity.get(session_id, ""))
                if pinned is not None and pinned.alive \
                        and not pinned.retired:
                    self.affinity_hits += 1
                    return pinned.name
            live = self._live()
            if not live:
                raise NoReplicaError(
                    f"no live replica among {len(self._replicas)} known")
            if session_id is not None:
                # Affinity missed (router restart, pin dropped on a
                # failover) but a replica still HOLDS the conversation
                # parked in its host tier — re-pin there: a resume
                # skips the whole shared-history prefill, which beats
                # any overlap score the scoring below could produce.
                sid = str(session_id)
                for v in sorted(live, key=lambda v: v.name):
                    if sid in v.parked:
                        self.park_pins += 1
                        self._affinity[session_id] = v.name
                        return v.name
            best = max(live, key=lambda v: (score(self.policy, v, keys),
                                            v.name))
            if keys and best.digest \
                    and prefix_mod.match_overlap(keys, best.digest):
                self.cache_routed += 1
            if session_id is not None:
                self._affinity[session_id] = best.name
            return best.name

    # -- disaggregated routing (tony_tpu_torch.serve.disagg) ---------------------
    def _live(self) -> List[ReplicaView]:
        """THE liveness filter — the one definition :meth:`route`,
        :meth:`route_split`, and the split detection share, so the
        colocated and disaggregated paths can never disagree on which
        replicas are routable. Caller holds the lock."""
        now = time.monotonic()
        live = [v for v in self._replicas.values()
                if v.alive and not v.retired
                and now - v.last_seen <= self.policy.stale_s]
        if not live:
            live = [v for v in self._replicas.values()
                    if v.alive and not v.retired]
        return live

    def _unpin(self, session_id: Any, name: str) -> None:
        """Drop a session pin that references ``name`` (a plain sticky
        pin or either half of a disaggregated pair). Takes the router
        lock itself — call it OUTSIDE a held ``self._lock`` region (the
        lock is not reentrant; the concurrency lint holds this module
        to the discipline)."""
        if session_id is None:
            return
        with self._lock:
            pinned = self._affinity.get(session_id)
            if pinned == name or (isinstance(pinned, tuple)
                                  and name in pinned):
                del self._affinity[session_id]

    def route_split(self, tokens: Sequence[int],
                    session_id: Optional[Any] = None) -> tuple:
        """``(prefill_name, decode_name)`` for one disaggregated
        dispatch, or ``(None, None)`` when the fleet has no live
        prefill+decode split (the caller then runs the colocated
        path unchanged). Prompts go to the prefill gang scored by
        prefix overlap (the same policy score — a prefill replica's
        published stem blocks are worth skipped launches); the handoff
        target is the decode replica with the shallowest queue. Sticky
        affinity pins the PAIR: the conversation's generated KV lives
        on the decode replica, its prompt-stem blocks on the prefill
        replica that computed them."""
        with self._lock:
            live = self._live()
            if not (any(v.role == "prefill" for v in live)
                    and any(v.role == "decode" for v in live)):
                # The one split-detection site (dispatch relies on it):
                # answered BEFORE the prompt is hashed, so a colocated
                # fleet never pays chain_keys here.
                return None, None
        keys = prefix_mod.chain_keys(tokens, self.block_size)
        with self._lock:
            live = self._live()
            prefills = [v for v in live if v.role == "prefill"]
            decodes = [v for v in live if v.role == "decode"]
            if not prefills or not decodes:
                return None, None
            if session_id is not None:
                pinned = self._affinity.get(session_id)
                if isinstance(pinned, tuple) and len(pinned) == 2:
                    pf = self._replicas.get(pinned[0])
                    dc = self._replicas.get(pinned[1])
                    if pf in prefills and dc in decodes:
                        self.affinity_hits += 1
                        return pf.name, dc.name
            best_pf = max(prefills,
                          key=lambda v: (score(self.policy, v, keys),
                                         v.name))
            best_dc = min(decodes,
                          key=lambda v: (v.queue_depth + v.running,
                                         v.name))
            if keys and best_pf.digest \
                    and prefix_mod.match_overlap(keys, best_pf.digest):
                self.cache_routed += 1
            if session_id is not None:
                self._affinity[session_id] = (best_pf.name, best_dc.name)
            return best_pf.name, best_dc.name

    def _decode_target(self, name: str) -> Any:
        """What the prefill side ships to: the in-process client when
        one is registered, the dialable ``host:port`` otherwise."""
        with self._lock:
            view = self._replicas[name]
            return view.client if view.client is not None \
                else view.address

    def _dispatch_disagg(self, tokens: Sequence[int],
                         max_new_tokens: int, *,
                         session_id: Optional[Any],
                         rid: Optional[Any],
                         max_attempts: int,
                         tenant: Optional[str] = None) -> Dict[str, Any]:
        """Prefill-gang dispatch + KV handoff, with the colocated failover
        split kept intact: a TRANSPORT fault (``OSError`` family) marks
        the replica down and re-dispatches; a typed
        :class:`~tony_tpu_torch.serve.disagg.HandoffError` (the decode pool
        rejected the import after the shipper's bounded retries, or the
        PREFILL pool was under transient pressure — prefill_only has no
        queue to park the request in, so the shipper side re-types that
        pressure) falls back to COLOCATED prefill on the decode replica — its engine
        prefills for itself — so one slow importer costs this request a
        fallback, never the prefill gang its throughput. Request-level
        errors (AdmissionError/RpcError) still propagate untouched."""
        last_err: Optional[Exception] = None
        split_gone = False
        # conv rides the handoff payload to the decode engine (and the
        # fallback's colocated generate) — the decode replica is where
        # the conversation's generated KV lives, so it is the one that
        # parks and resumes it. tenant rides the same way (the decode
        # engine is where QoS budgets meter the request); tagless
        # requests ship no kwarg, so older replica stubs keep working.
        kw = {} if session_id is None else {"conv": str(session_id)}
        if tenant is not None:
            kw["tenant"] = str(tenant)
        for _ in range(max(1, int(max_attempts))):
            pf, dc = self.route_split(tokens, session_id)
            if pf is None:
                # The split dissolved (possibly mid-retry — failovers
                # drained a gang): the colocated path owns the rest,
                # whatever already failed; whoever still serves can
                # still take this request whole.
                split_gone = True
                break
            try:
                out = self._client_of(pf).prefill_handoff(
                    [int(t) for t in tokens], int(max_new_tokens),
                    rid=rid, decode=self._decode_target(dc), **kw)
                with self._lock:
                    self.handoffs += 1
            except OSError as e:        # prefill transport fault
                last_err = e
                with self._lock:
                    view = self._replicas.get(pf)
                    if view is not None:
                        view.alive = False
                    self.failovers += 1
                self._unpin(session_id, pf)
                continue
            except HandoffError as e:
                last_err = e
                with self._lock:
                    self.handoff_fallbacks += 1
                try:
                    # A DISTINCT rid for the fallback generation: the
                    # failed handoff may have half-landed (transport
                    # died after the decode side committed the import),
                    # and re-submitting the same rid to the same engine
                    # would collide with the live sequence. The
                    # caller's rid is restored on the response below.
                    out = self._client_of(dc).generate(
                        [int(t) for t in tokens], int(max_new_tokens),
                        rid=None if rid is None else f"{rid}~fallback",
                        **kw)
                except OSError as e2:   # decode transport fault
                    last_err = e2
                    with self._lock:
                        view = self._replicas.get(dc)
                        if view is not None:
                            view.alive = False
                        self.failovers += 1
                    self._unpin(session_id, dc)
                    continue
            with self._lock:
                self.dispatched += 1
            out = _wire_completion(out, rid)
            if rid is not None:
                out["rid"] = rid        # undo a ~fallback rewrite
            out["replica"] = dc
            out["prefill_replica"] = pf
            return out
        if split_gone:
            return self._dispatch_colocated(tokens, max_new_tokens,
                                            session_id=session_id,
                                            rid=rid,
                                            max_attempts=max_attempts,
                                            tenant=tenant)
        raise NoReplicaError(
            f"disaggregated dispatch failed after "
            f"{max_attempts} attempt(s): {last_err}") from last_err

    def _client_of(self, name: str) -> Any:
        with self._lock:
            view = self._replicas[name]
            if view.client is not None:
                return view.client
            return self._dial(view.address)

    def dispatch(self, tokens: Sequence[int], max_new_tokens: int, *,
                 session_id: Optional[Any] = None,
                 rid: Optional[Any] = None,
                 max_attempts: int = 3,
                 tenant: Optional[str] = None) -> Dict[str, Any]:
        """Route + generate with failover: a replica whose TRANSPORT
        fails (dead socket, refused dial — ``OSError`` family) is
        marked down (until its next heartbeat) and the request
        re-dispatches to the next-best candidate — retirement or a
        crash costs the caller a retry, never the request.
        Request-level errors (an ``AdmissionError`` for an oversized
        prompt, an application ``RpcError``) propagate to the caller
        untouched: the replica is healthy, the REQUEST is bad, and
        down-marking on it would let one misbehaving client poison the
        whole fleet.

        Role-aware: a fleet running the disaggregated
        prefill/decode split dispatches prompt → prefill gang → KV
        handoff → decode replica (:meth:`route_split`); a colocated
        fleet (or a split that lost a whole gang) runs the colocated path
        byte-for-byte unchanged."""
        # route_split itself answers "is there a live split" — (None,
        # None) sends _dispatch_disagg straight down the colocated
        # path — so no separate pre-scan of the fleet is needed here.
        return self._dispatch_disagg(
            tokens, max_new_tokens, session_id=session_id, rid=rid,
            max_attempts=max_attempts, tenant=tenant)

    def _dispatch_colocated(self, tokens: Sequence[int],
                            max_new_tokens: int, *,
                            session_id: Optional[Any] = None,
                            rid: Optional[Any] = None,
                            max_attempts: int = 3,
                            tenant: Optional[str] = None) -> Dict[str, Any]:
        last_err: Optional[Exception] = None
        # The session id doubles as the engine-side conversation handle
        # (conv): a host-tier replica parks the turn's KV under it and
        # the next turn — re-pinned here by affinity or the parked
        # digest — resumes instead of re-prefilling. Sessionless
        # requests ship no kwarg, so client stubs without it keep
        # working unchanged; tenant follows the same optional-kwarg
        # discipline for the QoS plane (tony_tpu.serve.qos).
        kw = {} if session_id is None else {"conv": str(session_id)}
        if tenant is not None:
            kw["tenant"] = str(tenant)
        for _ in range(max(1, int(max_attempts))):
            name = self.route(tokens, session_id)
            try:
                out = self._client_of(name).generate(
                    list(int(t) for t in tokens), int(max_new_tokens),
                    rid=rid, **kw)
            except OSError as e:    # transport fault (ConnectionError,
                last_err = e        # timeout, refused dial, ...)
                with self._lock:
                    view = self._replicas.get(name)
                    if view is not None:
                        view.alive = False
                    self.failovers += 1
                self._unpin(session_id, name)
                continue
            with self._lock:
                self.dispatched += 1
            out = _wire_completion(out, rid)
            out["replica"] = name
            return out
        raise NoReplicaError(
            f"dispatch failed after {max_attempts} attempt(s): "
            f"{last_err}") from last_err

    # -- telemetry ---------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        with self._lock:
            live = sum(1 for v in self._replicas.values()
                       if v.alive and not v.retired)
            return {
                "replicas": float(len(self._replicas)),
                "replicas_live": float(live),
                "dispatched": float(self.dispatched),
                "failovers": float(self.failovers),
                "affinity_hits": float(self.affinity_hits),
                "cache_routed": float(self.cache_routed),
                "handoffs": float(self.handoffs),
                "handoff_fallbacks": float(self.handoff_fallbacks),
                "park_pins": float(self.park_pins),
                "sessions": float(len(self._affinity)),
            }


# The longest a dispatch waits for a replica's reply. A replica's
# ``generate`` and ``prefill_handoff`` reply when the generation ends, so
# the wait belongs to the generation. The reference's router waits at
# most the RPC client's 10 s per-operation cap and then sends the call
# again under the same rid, and the engine refuses a re-sent ``generate``
# whose rid is still live: waiting for the reply avoids that refusal for
# a generation that is merely slow. The dial and a refused connection
# keep the short window.
REPLY_TIMEOUT_S = 600.0


def _rpc_dial(address: str, timeout: float) -> Any:
    """Default transport: the control-plane JSON-lines RPC client
    against a replica's ``generate``/``prefill_handoff`` verbs (lazy
    import — the RPC stack only loads when a network replica is
    actually dialed), with ``timeout`` as its retry window and
    :data:`REPLY_TIMEOUT_S` as its wait for a reply."""
    from tony_tpu_torch.rpc import RpcClient, RpcError

    def dial():
        return RpcClient(address, timeout=timeout,
                         reply_timeout=REPLY_TIMEOUT_S)

    class _Front:
        def generate(self, tokens, max_new_tokens, rid=None, conv=None,
                     tenant=None):
            with dial() as client:
                return client.call("generate", tokens=tokens,
                                   max_new_tokens=max_new_tokens,
                                   rid=rid, conv=conv, tenant=tenant)

        def prefill_handoff(self, tokens, max_new_tokens, rid=None,
                            decode=None, conv=None, tenant=None):
            # ``decode`` crosses the wire as an address — the prefill
            # REPLICA ships the fat KV payload replica-to-replica; the
            # router only orchestrates. A transported HandoffError
            # (the JSON-lines wire carries "<TypeName>: <message>")
            # re-types so the router's fallback split keeps working
            # over RPC exactly as in-process.
            try:
                with dial() as client:
                    return client.call("prefill_handoff", tokens=tokens,
                                       max_new_tokens=max_new_tokens,
                                       rid=rid, decode_address=decode,
                                       conv=conv, tenant=tenant)
            except RpcError as e:
                if str(e).startswith("HandoffError:"):
                    raise HandoffError(str(e), retryable=False) from e
                raise

    return _Front()


class RouterRpcHandler:
    """RPC verbs of one router front (JSON-lines wire, same as the
    AM's and the replica's) — ``generate`` forwards through
    :meth:`RequestRouter.dispatch`, so a gateway client speaks ONE verb
    whether it dials a replica or the fleet."""

    def __init__(self, router: RequestRouter):
        self.router = router

    def rpc_generate(self, tokens: List[int], max_new_tokens: int = 16,
                     rid: Optional[str] = None,
                     session_id: Optional[str] = None,
                     tenant: Optional[str] = None) -> Dict[str, Any]:
        """One request through :meth:`RequestRouter.dispatch`. A
        ``session_id`` pins the session to its replica and reaches it as
        ``conv``, the host tier's conversation handle; a ``tenant``
        reaches it as the QoS class."""
        return self.router.dispatch(tokens, max_new_tokens, rid=rid,
                                    session_id=session_id, tenant=tenant)

    def rpc_router_stats(self) -> Dict[str, float]:
        return self.router.stats()


class RouterServer:
    """The fleet's network front door: an RPC server around one
    :class:`RequestRouter`, optionally polling an AM for the live
    replica set (``am_address`` + ``poll_s``) so membership tracks the
    autoscaler with zero manual wiring. Front it with
    :class:`tony_tpu.proxy.ProxyServer` for gateway access, exactly
    like a replica."""

    def __init__(self, router: RequestRouter, *, host: str = "0.0.0.0",
                 port: int = 0, am_address: Optional[str] = None,
                 poll_s: float = 2.0):
        from tony_tpu_torch.rpc import RpcServer

        self.router = router
        self.am_address = am_address
        self.poll_s = float(poll_s)
        self._server = RpcServer(RouterRpcHandler(router), host=host,
                                 port=port)
        self._stop = threading.Event()
        self._stop_lock = threading.Lock()   # guards the stop transition
        self._poller: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def address(self) -> str:
        return self._server.address

    def start(self) -> "RouterServer":
        self._server.start()
        if self.am_address:
            # Under the stop lock (the concurrency lint holds this
            # module to its own discipline): a stop() overlapping
            # start() must either see no poller or the whole one — a
            # half-published thread would be joined never.
            with self._stop_lock:
                self._poller = threading.Thread(target=self._poll_loop,
                                                name="tony-router-poll",
                                                daemon=True)
                self._poller.start()
        return self

    def _poll_loop(self) -> None:
        from tony_tpu_torch.rpc import RpcClient

        while not self._stop.wait(self.poll_s):
            try:
                with RpcClient(self.am_address, timeout=5.0) as client:
                    infos = client.call("serve_endpoints")
                self.router.refresh_from_task_infos(infos)
            except Exception:  # noqa: BLE001 — AM mid-restart; re-poll
                pass

    def stop(self) -> None:
        """Deterministic teardown: stop the poller and JOIN it, then
        stop the RPC server (which joins its accept thread). Idempotent
        AND race-free — teardown paths (context exit, CLI finally,
        tests) may overlap, and the loser of the atomic test-and-set
        must no-op rather than shutdown() a closed server or join a
        poller the winner already cleared."""
        with self._stop_lock:
            if self._stop.is_set():
                return
            self._stop.set()
            poller, self._poller = self._poller, None
        if poller is not None:
            poller.join(timeout=2)
        self._server.stop()

    # The explicit-close spelling the shutdown-hygiene audit asks every
    # thread-owning front to have (DeviceIterator.close, RpcClient.close).
    close = stop

    def __enter__(self) -> "RouterServer":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()
