"""One serving replica: the counterpart of :mod:`tony_tpu.serve.replica`.

A replica is the serve job type's user process (``python -m
tony_tpu_torch.serve.replica``, launched by the executor like any other
workload). Startup:

1. build the registered model (``tony.serve.model`` + JSON kwargs) with
   its parameters stored in the serving dtype, on the replica's device
   (the card unless the kwargs name another);
2. restore ONLY the params subtree of the training checkpoint, in place
   into those parameters (:func:`tony_tpu_torch.ckpt.find_path_prefix`
   locates the subtree whatever the save's wrapping; ``dtype_policy=
   "bf16"`` casts the f32 master to bf16 on the way, rounding to nearest
   even as the reference's ``astype`` does; optimizer slots are never
   read). The step is the published pointer's (``published.json``), else
   the newest committed one;
3. run a :class:`~tony_tpu_torch.serve.engine.ServeEngine` behind the
   control-plane RPC wire (:mod:`tony_tpu_torch.rpc`, byte-compatible
   with the JAX package's);
4. publish the engine's telemetry, the RPC port and the weight version
   to the ``TONY_SERVE_STATS`` file the executor's heartbeat carries to
   the AM, where the router and the autoscaler read it.

Concurrent ``generate`` RPCs drive ONE shared engine through
:class:`~tony_tpu_torch.serve.engine.EngineFront`, so overlapping calls
join the continuous batch. :meth:`Replica.hot_swap` moves the replica
onto a newer publication without a restart or a dropped request.

The speculative lane (``spec_k`` > 0: a
:class:`~tony_tpu_torch.serve.spec.SpecEngine` drafting with a named
draft model restored through the same params-only path, else with
n-grams), the prefix cache and chunked prefill are armed as in the
reference's replica, and so is the cold-start plane: an AOT cache
directory (``tony.serve.aot-cache``) through which the engine's kernel
libraries resolve, ``warm()`` of the step family into CUDA graphs after
the restore, and the warm-standby pool (``tony.serve.warm-standby``):
a standby heartbeats ``warm_standby=1`` until the AM's ``promote`` RPC.
Disaggregated serving: every replica fronts both halves of the KV
handoff (:mod:`tony_tpu_torch.serve.disagg`), the ``prefill_handoff``,
``kv_offer`` and ``kv_import`` verbs; its role (``tony.serve.role.
<jobtype>``, written by ``tony_tpu_torch.cli serve --role``) is what it
advertises, and the router's dispatch decides which verbs see traffic.
The KV memory hierarchy and the tenants: ``tony.serve.host-blocks``
arms the host tier (conversations tagged ``conv`` park and resume, with
the encode on the offload thread), ``.demote-watermark`` and
``.demote-batch`` its demotion daemon, ``.prefix-store`` the persisted
stems (adopted at start, newly hot ones exported on the publish
cadence), and ``tony.serve.qos.tenants`` / ``.max-queue`` the tenant
budgets. A serve mesh (``tony.serve.mesh``) is not ported: the conf
that asks for one raises ``NotImplementedError`` naming its ROADMAP
item.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch

from tony_tpu_torch import chaos, ckpt, constants, events, resolve_device
from tony_tpu_torch.ckpt.format import torch_dtype
from tony_tpu_torch.ckpt.restore import _apply_dtype_policy
from tony_tpu_torch.conf import (CKPT_DIR, HISTORY_LOCATION,
                                 SERVE_AOT_CACHE, SERVE_BLOCK_SIZE,
                                 SERVE_CKPT_DIR, SERVE_CTX_MAX,
                                 SERVE_DEMOTE_BATCH, SERVE_DEMOTE_WATERMARK,
                                 SERVE_DRAFT_CKPT_DIR, SERVE_DRAFT_MODEL,
                                 SERVE_DRAFT_MODEL_KWARGS,
                                 SERVE_DRAFT_NGRAM_MAX, SERVE_DTYPE_POLICY,
                                 SERVE_HOST_BLOCKS, SERVE_MAX_RUNNING,
                                 SERVE_MESH, SERVE_MODEL, SERVE_MODEL_KWARGS,
                                 SERVE_PORT, SERVE_PREFILL_CHUNK,
                                 SERVE_PREFIX_CACHE, SERVE_PREFIX_STORE,
                                 SERVE_SPEC_K,
                                 SERVE_WARM_STANDBY, TonyConfig,
                                 serve_role_key, serve_warm_standby_key)
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import jax_param_tree
from tony_tpu_torch.publish import latest_publication
from tony_tpu_torch.serve.disagg import DecodeFront, PrefillFront
from tony_tpu_torch.serve.engine import Completion, EngineFront, ServeEngine
from tony_tpu_torch.serve.kvstore import PrefixStore
from tony_tpu_torch.serve.qos import QosPolicy
from tony_tpu_torch.serve.spec import SpecEngine
from tony_tpu_torch.serve.swap import (SwapError, derive_prefill_pads,
                                       resolve_target)

_ITEM = "ROADMAP.md, queue 1 item {}"


def _storage_dtype(dtype_policy: Optional[str]) -> torch.dtype:
    """The dtype a replica stores its parameters in: the policy's
    (``"bf16"`` → bfloat16, ``"f32"`` → float32), or float32, the
    trained master's, with no policy. An unknown policy raises
    ``ValueError``, as the restore does."""
    if dtype_policy is None:
        return torch.float32
    return torch_dtype(_apply_dtype_policy(dtype_policy, ".params",
                                           "float32"))


class Replica:
    """Build (restore + engine) and front one serving replica.

    ``model_kwargs`` are the registered model's: they must name the
    training job's ``xent_chunk`` and ``scan_layers``, which decide the
    checkpoint's param paths. Their ``"device"`` (absent: the card) is
    the replica's device, and ``"param_dtype"`` defaults to
    :func:`_storage_dtype` of the policy.

    ``spec_k`` > 0 arms the speculative lane: ``draft_model_name`` (with
    ``draft_model_kwargs``, on the replica's device) restores from
    ``draft_ckpt_dir`` (default: ``ckpt_dir``) through the same
    params-only path, else the lane drafts n-grams up to ``ngram_max``.
    ``prefix_cache`` and ``prefill_chunk`` arm the engine's admission
    lanes. ``aot_cache`` (a directory) arms the cold-start plane's cache
    and ``warm_standby`` starts the replica as a warm standby; with
    either, the engine's step family is warmed right after the restore
    (a standby must hold its captured steps before it is promoted).
    ``role`` (``"colocated"``, ``"prefill"`` or ``"decode"``) is the
    engine's disaggregated-serving role. ``host_blocks`` arms the host
    tier (with the offload thread), ``demote_watermark`` and
    ``demote_batch`` its demotion daemon, ``prefix_store`` (a
    directory) the persisted stems, adopted before the first request,
    and ``qos`` (a :class:`~tony_tpu_torch.serve.qos.QosPolicy`) the
    tenant budgets."""

    def __init__(self, *, model_name: str,
                 model_kwargs: Optional[Dict[str, Any]] = None,
                 ckpt_dir: str, dtype_policy: Optional[str] = "bf16",
                 ctx_max: int = 2048, block_size: int = 16,
                 q_block: int = 16, n_blocks: Optional[int] = None,
                 max_running: int = 16, keep_logits: bool = False,
                 tag: str = "serve", spec_k: int = 0,
                 draft_model_name: Optional[str] = None,
                 draft_model_kwargs: Optional[Dict[str, Any]] = None,
                 draft_ckpt_dir: Optional[str] = None, ngram_max: int = 3,
                 prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None,
                 aot_cache: Optional[str] = None,
                 warm_standby: bool = False, role: str = "colocated",
                 host_blocks: int = 0, prefix_store: Optional[str] = None,
                 demote_watermark: float = 0.0, demote_batch: int = 0,
                 qos: Optional[QosPolicy] = None):
        t0 = time.perf_counter()
        # Cold-start plane: a cache DIR becomes a live AOTCache shared by
        # every step family the engine resolves, built before the engine
        # so the first resolution can hit.
        self._aot = ckpt.AOTCache(aot_cache) if aot_cache else None
        kw = dict(model_kwargs or {})
        self.device = resolve_device(kw.pop("device", None))
        kw.setdefault("param_dtype", _storage_dtype(dtype_policy))
        self.model = get_model(model_name, device=self.device, **kw)
        self.model_name = model_name
        self.ckpt_dir = ckpt_dir
        self.dtype_policy = dtype_policy
        t1 = time.perf_counter()
        # A published pointer outranks "latest committed": it is the
        # train gang's statement of which step the fleet should serve.
        pub = latest_publication(ckpt_dir)
        step = self._restore_params(
            self.model, dict(self.model.named_parameters()),
            ckpt_dir, step=pub["step"] if pub else None)
        self.restored_step = step
        t2 = time.perf_counter()
        engine_kw = dict(ctx_max=ctx_max, block_size=block_size,
                         q_block=q_block, n_blocks=n_blocks,
                         max_running=max_running, keep_logits=keep_logits,
                         tag=tag, prefix_cache=prefix_cache,
                         prefill_chunk=prefill_chunk, aot_cache=self._aot,
                         warm_standby=warm_standby, role=role,
                         host_blocks=host_blocks,
                         async_offload=host_blocks > 0,
                         demote_watermark=demote_watermark,
                         demote_batch=demote_batch, qos=qos,
                         device=self.device)
        if spec_k:
            draft_kw: Dict[str, Any] = {"ngram_max": ngram_max}
            if draft_model_name:
                # A named draft restores through the same params-only
                # path as the target, from its own directory or the
                # target's; the hot swap leaves it alone (another
                # checkpoint lineage: roll the replica to change it).
                # The draft's pool lives beside the target's, so its
                # device defaults to the replica's (another one raises).
                dkw = dict(draft_model_kwargs or {})
                dkw.setdefault("param_dtype", _storage_dtype(dtype_policy))
                draft = get_model(
                    draft_model_name,
                    device=resolve_device(dkw.pop("device", self.device)),
                    **dkw)
                self.draft_restored_step = self._restore_params(
                    draft, dict(draft.named_parameters()),
                    draft_ckpt_dir or ckpt_dir)
                draft_kw["draft_model"] = draft
            self.engine: ServeEngine = SpecEngine(
                self.model, spec_k=spec_k, **draft_kw, **engine_kw)
        else:
            self.engine = ServeEngine(self.model, **engine_kw)
        # Seed the serving version: a replica restored from a published
        # step advertises it on its first heartbeat, so a rolling swap
        # never re-swaps a replica that came up on the target.
        self.engine.weight_step = int(step)
        if pub is not None and pub["step"] == step:
            self.engine.weight_version = pub["version"]
        t3 = time.perf_counter()
        self._attach(self.engine)
        # The persisted stems, adopted before the first request, so a
        # fresh replica serves a shared stem from disk instead of
        # recomputing it; the publisher exports newly hot stems back.
        self._store = PrefixStore(prefix_store) if prefix_store else None
        if self._store is not None:
            self._load_stems()
        # Resolve the step family now when the plane is on: a standby
        # must hold its captured steps before promotion, and a
        # cache-armed active replica pays its libraries and captures
        # before its first request (and its misses populate the cache
        # for every later grant of the family).
        self.warmed = 0
        if self._aot is not None or warm_standby:
            self.warmed = self.engine.warm()
            print(f"[tony-serve-replica] warmed {self.warmed} step "
                  f"program(s) (aot hits {self.engine.aot_hits}, misses "
                  f"{self.engine.aot_misses}, nvcc builds "
                  f"{self.engine.fresh_compiles})", flush=True)
        self.timings = {"build_s": t1 - t0, "restore_s": t2 - t1,
                        "engine_s": t3 - t2,
                        "warm_s": time.perf_counter() - t3}

    def _attach(self, engine: ServeEngine) -> None:
        """Front ``engine``: one :class:`EngineFront` carrying both
        handoff halves (the router's role-aware dispatch decides which
        verbs see traffic; a colocated replica answering a stray
        ``kv_offer`` is harmless)."""
        self.engine = engine
        self.role = engine.role
        self._front = EngineFront(engine)
        self._prefill_front = PrefillFront(self._front)
        self._decode_front = DecodeFront(self._front)
        self._publish: Optional[Any] = None
        self.port: Optional[int] = None

    def _load_stems(self) -> None:
        """Warm the engine's prefix tier from the store, best effort: a
        corrupt or geometry-skewed stem is skipped (that prefix
        recomputes), never a startup failure."""
        header = self.engine.cache.wire_header()
        adopted = 0
        for tip in self._store.stems():
            rec = self._store.get(tip)
            if rec is None or rec.get("header") != header:
                continue
            adopted += self.engine.adopt_stem(rec["keys"], rec["blocks"])
        if adopted:
            print(f"[tony-serve-replica] adopted {adopted} KV block(s) "
                  f"from the prefix store", flush=True)

    def _restore_params(self, model: Any,
                        tensors: Mapping[str, torch.Tensor], root: str, *,
                        step: Optional[int] = None):
        """Restore the params subtree of committed step ``step`` (default:
        the newest) under ``root`` in place into ``tensors`` (``model``'s
        parameters, or a second set of the same names, shapes and
        dtypes) through the model's JAX param layout. Returns the
        step."""
        template = jax_param_tree(model, tensors)
        if step is None:
            step = ckpt.latest_step(root)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {root} — a replica "
                f"serves a trained model, it does not initialize one")
        try:
            prefix = ckpt.find_path_prefix(root, template, step=step)
        except KeyError as exc:
            raise KeyError(
                f"{exc.args[0]} Check the served model's kwargs against "
                f"the training job's: xent_chunk puts the head at "
                f"lm_head_kernel (else lm_head.kernel), and scan_layers "
                f"decides layers.block.* against layer_{{i}}.") from exc
        ckpt.restore_pytree(root, template, step=step,
                            dtype_policy=self.dtype_policy,
                            path_prefix=prefix)
        return step

    # -- request path ------------------------------------------------------
    def generate(self, tokens: Sequence[int], max_new_tokens: int,
                 rid: Optional[Any] = None, conv: Optional[Any] = None,
                 tenant: Optional[str] = None) -> Completion:
        """Submit one request and drive the shared engine until it
        completes. Thread-safe: concurrent callers interleave on the
        front's drive lock, so their requests ride one continuous
        batch. ``conv`` is the conversation handle a host-tier engine
        parks and resumes under; ``tenant`` the QoS class its admission
        budgets meter."""
        return self._front.generate(tokens, max_new_tokens, rid=rid,
                                    conv=conv, tenant=tenant)

    # -- disaggregated handoff (tony_tpu_torch.serve.disagg) ---------------
    def prefill_handoff(self, tokens: Sequence[int], max_new_tokens: int,
                        rid: Optional[Any] = None, decode: Any = None,
                        conv: Optional[Any] = None,
                        tenant: Optional[str] = None) -> Completion:
        """Prefill-role request path: prefill ``tokens``, ship the KV
        blocks to ``decode`` (a ``host:port`` address or an in-process
        receiver), return the completion the decode side drove to the
        end."""
        return self._prefill_front.prefill_handoff(
            tokens, max_new_tokens, rid=rid, decode=decode, conv=conv,
            tenant=tenant)

    def kv_offer(self, keys: Sequence[str]) -> int:
        return self._decode_front.kv_offer(keys)

    def kv_import(self, payload: Dict[str, Any]) -> Completion:
        return self._decode_front.kv_import(payload)

    # -- warm-standby promotion --------------------------------------------
    def promote(self) -> bool:
        """The AM's scale-up path: leave warm standby and republish the
        stats AT ONCE — the session routes on warm_standby=0, and
        waiting a publish tick would hand back the latency the pool
        exists to hide. Returns whether the replica WAS a standby."""
        was = self.engine.promote()
        if was and self._publish is not None:
            self._publish()
        return was

    def tune_warm_pads(self, history_dir: str, *,
                       limit: int = 4) -> List[int]:
        """warm() pad self-tuning: read the prompt-length histograms that
        earlier serve windows logged under ``history_dir`` and resolve
        the prefill pads the traffic used (:func:`derive_prefill_pads`).
        Best-effort: an unreadable log warms nothing extra and never
        fails startup. Returns the pads."""
        records: List[Dict[str, Any]] = []
        try:
            for job in events.list_jobs(history_dir):
                try:
                    records += [r for r in events.read_events(job["path"])
                                if r.get("type") == events.SERVE_WINDOW]
                except (OSError, ValueError):
                    continue
        except OSError:
            return []
        pads = derive_prefill_pads(records, q_block=self.engine.q_block,
                                   ctx_max=self.engine.ctx_pad, limit=limit)
        if pads:
            n = self.engine.warm(prefill_pads=pads)
            print(f"[tony-serve-replica] self-tuned prefill pads {pads} "
                  f"from the serve history ({n} program(s) resolved)",
                  flush=True)
        return pads

    # -- hot weight swap ---------------------------------------------------
    def hot_swap(self, *, version: Optional[int] = None,
                 step: Optional[int] = None) -> Dict[str, Any]:
        """Swap this replica onto a published step IN PLACE: no restart,
        no dropped request, no step function rebuilt. The prefix tier is
        flushed at the flip; the speculative lane's draft model is not
        swapped (another checkpoint lineage: roll the replica).

        1. resolve the target (the published pointer, or an explicit
           ``step`` pin);
        2. restore its params into a SECOND parameter set of the same
           geometry while the engine keeps serving the old weights (its
           captured steps read the live parameters' addresses, which the
           flip keeps);
        3. quiesce to an iteration boundary under the front's drive lock
           and copy the new set into the live parameters
           (:meth:`EngineFront.quiesce_and_swap` →
           :meth:`ServeEngine.swap_params`).

        Any failure raises :class:`SwapError` with the old weights
        serving; success republishes the stats at once. Returns the
        versions, the step, the wall time, the restore's seconds and its
        window on the ``time.monotonic`` clock, the quiesce ms (lock wait
        + drain) and the flip ms (the copies, synchronized)."""
        t0 = time.monotonic()
        to_version, to_step = resolve_target(self.ckpt_dir,
                                             version=version, step=step)
        from_version = self.engine.weight_version
        chaos.crash_point("swap_before_restore")
        try:
            staged = {name: torch.empty_like(p)
                      for name, p in self.model.named_parameters()}
            rstep = self._restore_params(self.model, staged, self.ckpt_dir,
                                         step=to_step)
        except SwapError:
            raise
        except Exception as exc:   # noqa: BLE001 — typed rollback contract
            raise SwapError(f"restore of step {to_step} failed: "
                            f"{type(exc).__name__}: {exc}") from exc
        t1 = time.monotonic()
        chaos.crash_point("swap_after_restore")
        stamps: Dict[str, float] = {}

        def flip() -> None:
            stamps["flip"] = time.monotonic()
            chaos.crash_point("swap_before_flip")
            self.engine.swap_params(staged, version=to_version,
                                    step=to_step)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            stamps["flipped"] = time.monotonic()
            chaos.crash_point("swap_after_flip")

        t2 = time.monotonic()
        self._front.quiesce_and_swap(flip)
        del staged
        self.restored_step = rstep
        if self._publish is not None:
            self._publish()
        return {"ok": True, "from_version": from_version,
                "to_version": to_version, "step": to_step,
                "wall_s": time.monotonic() - t0, "restore_s": t1 - t0,
                "restore_window": [t0, t1],
                "quiesce_ms": 1e3 * (stamps["flip"] - t2),
                "flip_ms": 1e3 * (stamps["flipped"] - stamps["flip"])}

    # -- RPC front ---------------------------------------------------------
    def rpc_handler(self) -> "_ReplicaRpcHandler":
        return _ReplicaRpcHandler(self)

    def serve_forever(self, *, host: str = "0.0.0.0", port: int = 0,
                      stats_path: Optional[str] = None,
                      stats_every_s: float = 2.0,
                      stop: Optional[threading.Event] = None) -> None:
        """Run the RPC server and the stats publisher until ``stop``:
        a first publish before the first interval (the router can only
        dial a replica whose ``rpc_port`` reached the AM), then one every
        ``stats_every_s``; on the way out the server's threads are
        stopped and joined."""
        from tony_tpu_torch.rpc import RpcServer

        server = RpcServer(self.rpc_handler(), host=host, port=port)
        server.start()
        self.port = server.port
        print(f"[tony-serve-replica] listening on {server.address} "
              f"(ckpt step {self.restored_step})", flush=True)
        stop = stop or threading.Event()

        def publish() -> None:
            if not stats_path:
                return
            try:
                self.engine.write_stats(stats_path,
                                        extra={"rpc_port": server.port})
            except OSError:
                pass
            if self._store is not None:
                # Newly hot stems persist on the publish cadence; only
                # the pool's fetch takes the drive lock.
                try:
                    self.engine.export_stems(self._store,
                                             lock=self._front._drive)
                except OSError:
                    pass

        # hot_swap republishes through this hook, so the router's
        # swap-window down-mark lifts on the next heartbeat.
        self._publish = publish
        try:
            publish()
            while not stop.wait(stats_every_s):
                publish()
        finally:
            self._publish = None
            server.stop()


class _ReplicaRpcHandler:
    """RPC verbs of one replica (JSON-lines wire, same as the AM's)."""

    def __init__(self, replica: Replica):
        self.replica = replica

    @staticmethod
    def _wire(c: Any) -> Dict[str, Any]:
        return c if isinstance(c, dict) else c.wire()

    def rpc_generate(self, tokens: List[int], max_new_tokens: int = 16,
                     rid: Optional[str] = None,
                     conv: Optional[str] = None,
                     tenant: Optional[str] = None) -> Dict[str, Any]:
        return self._wire(self.replica.generate(tokens, max_new_tokens,
                                                rid=rid, conv=conv,
                                                tenant=tenant))

    def rpc_serve_stats(self) -> Dict[str, Any]:
        """The engine's stats, and under ``"launches"`` this process's
        kernel launches by wrapper (``ops.LAUNCHES``): which of the
        port's kernels served the requests, seen from outside the
        replica's process; under ``"visible_devices"`` the cards its
        job pinned it to (``CUDA_VISIBLE_DEVICES``, None where unset)."""
        from tony_tpu_torch.ops import LAUNCHES

        return {**self.replica.engine.stats(), "launches": dict(LAUNCHES),
                "visible_devices": os.environ.get(
                    constants.ENV_CUDA_VISIBLE_DEVICES)}

    def rpc_swap(self, version: Optional[int] = None,
                 step: Optional[int] = None) -> Dict[str, Any]:
        """The AM's rolling-fleet verb: hot-swap onto the published step
        (or an explicit ``step`` pin). A failure crosses the wire as
        ``"SwapError: ..."`` with the old weights still serving."""
        return self.replica.hot_swap(version=version, step=step)

    def rpc_promote(self) -> bool:
        """The AM's scale-up verb against a warm standby (idempotent: a
        duplicated call returns False)."""
        return self.replica.promote()

    # -- disaggregated handoff verbs (tony_tpu_torch.serve.disagg) --------
    def rpc_prefill_handoff(self, tokens: List[int],
                            max_new_tokens: int = 16,
                            rid: Optional[str] = None,
                            decode_address: Optional[str] = None,
                            conv: Optional[str] = None,
                            tenant: Optional[str] = None
                            ) -> Dict[str, Any]:
        """The router's disaggregated dispatch verb: prefill here, ship
        the KV replica to replica to ``decode_address``, return the
        decode side's completion. Typed failures cross the wire as
        ``"HandoffError: ..."``, which the router re-types for its
        fallback."""
        return self._wire(self.replica.prefill_handoff(
            tokens, max_new_tokens, rid=rid, decode=decode_address,
            conv=conv, tenant=tenant))

    def rpc_kv_offer(self, keys: List[str]) -> int:
        return self.replica.kv_offer(keys)

    def rpc_kv_import(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        return self._wire(self.replica.kv_import(payload))


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _model_kwargs_from_json(text: str) -> Dict[str, Any]:
    """``tony.serve.model-kwargs`` as model kwargs: the JSON object, with
    ``dtype``/``param_dtype`` names (``"bfloat16"``, ``"float32"``) as
    torch dtypes."""
    kw = json.loads(text or "{}")
    if not isinstance(kw, dict):
        raise ValueError(f"model kwargs must be a JSON object, got {text!r}")
    for key in ("dtype", "param_dtype"):
        if key in kw:
            if kw[key] not in _DTYPES:
                raise ValueError(f"model kwarg {key}={kw[key]!r}: one of "
                                 f"{sorted(_DTYPES)}")
            kw[key] = _DTYPES[kw[key]]
    return kw


def _warm_pool(conf: TonyConfig, job_type: str) -> int:
    """The jobtype's warm-standby pool size: its own key, else the
    serve-wide one."""
    warm = conf.get(serve_warm_standby_key(job_type))
    if warm is None:
        warm = conf.get(SERVE_WARM_STANDBY)
    return int(warm or 0)


def _refuse_unported(conf: TonyConfig) -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP item for every
    serving lane the conf arms that the port has not ported, so no such
    setting is silently ignored: a serve mesh (item 8)."""
    if conf.get(SERVE_MESH):
        raise NotImplementedError(
            f"{SERVE_MESH}={conf.get(SERVE_MESH)!r}: this serving lane is "
            f"not ported yet ({_ITEM.format(8)})")


def main() -> int:
    """``python -m tony_tpu_torch.serve.replica`` — the serve job type's
    user command. Config comes from the job conf (``TONY_CONF_PATH``);
    the stats file path from ``TONY_SERVE_STATS`` (both exported by the
    executor)."""
    conf_path = os.environ.get(constants.ENV_CONF_PATH)
    if not conf_path:
        print("[tony-serve-replica] no TONY_CONF_PATH; run under a tony "
              "serve job")
        return 1
    conf = TonyConfig.load(conf_path)
    model_name = conf.get(SERVE_MODEL)
    ckpt_dir = conf.get(SERVE_CKPT_DIR) or conf.get(CKPT_DIR)
    if not model_name or not ckpt_dir:
        print(f"[tony-serve-replica] need {SERVE_MODEL} and "
              f"{SERVE_CKPT_DIR} in the job conf")
        return 1
    job_type = os.environ.get(constants.ENV_JOB_NAME) or "serve"
    _refuse_unported(conf)
    # Disaggregated role: the executor exports the jobtype, the conf maps
    # jobtype -> role (what `cli serve --role` writes); a one-jobtype
    # serve job has no role key and runs colocated.
    role = conf.get(serve_role_key(job_type)) or "colocated"
    # Warm-standby membership is decided here, by position: the AM grants
    # elastic tasks above the jobtype's configured instance count, so an
    # index at or past that count with a warm pool configured came up as
    # a standby; it warms and waits for the promote RPC. The base gang
    # (index < instances) always starts active.
    task_index = int(os.environ.get(constants.ENV_TASK_INDEX) or 0)
    warm_standby = (_warm_pool(conf, job_type) > 0
                    and task_index >= conf.instances(job_type))
    aot_cache = conf.get(SERVE_AOT_CACHE) or None
    replica = Replica(
        model_name=model_name,
        model_kwargs=_model_kwargs_from_json(conf.get(SERVE_MODEL_KWARGS)),
        ckpt_dir=ckpt_dir,
        dtype_policy=conf.get(SERVE_DTYPE_POLICY, "bf16"),
        ctx_max=conf.get_int(SERVE_CTX_MAX, 2048),
        block_size=conf.get_int(SERVE_BLOCK_SIZE, 16),
        max_running=conf.get_int(SERVE_MAX_RUNNING, 16),
        spec_k=conf.get_int(SERVE_SPEC_K, 0),
        draft_model_name=conf.get(SERVE_DRAFT_MODEL) or None,
        draft_model_kwargs=_model_kwargs_from_json(
            conf.get(SERVE_DRAFT_MODEL_KWARGS)),
        draft_ckpt_dir=conf.get(SERVE_DRAFT_CKPT_DIR) or None,
        ngram_max=conf.get_int(SERVE_DRAFT_NGRAM_MAX, 3),
        prefix_cache=conf.get_bool(SERVE_PREFIX_CACHE, False),
        prefill_chunk=conf.get_int(SERVE_PREFILL_CHUNK, 0) or None,
        aot_cache=aot_cache, warm_standby=warm_standby, role=role,
        host_blocks=conf.get_int(SERVE_HOST_BLOCKS, 0),
        prefix_store=conf.get(SERVE_PREFIX_STORE) or None,
        demote_watermark=conf.get_float(SERVE_DEMOTE_WATERMARK, 0.0),
        demote_batch=conf.get_int(SERVE_DEMOTE_BATCH, 0),
        qos=QosPolicy.from_conf(conf))
    # warm() pad self-tuning: with the plane armed and a history root
    # configured, resolve the prefill pads earlier serve traffic used.
    history_dir = conf.get(HISTORY_LOCATION)
    if history_dir and (aot_cache or warm_standby):
        replica.tune_warm_pads(history_dir)
    replica.serve_forever(
        port=conf.get_int(SERVE_PORT, 0),
        stats_path=os.environ.get(constants.ENV_SERVE_STATS))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
