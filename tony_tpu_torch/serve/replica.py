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

Lanes of the reference's replica that are not ported (speculation,
prefix cache, chunked prefill, disaggregation, host tier, prefix store,
AOT cache, warm standby, demotion, QoS, a serve mesh) raise
``NotImplementedError`` naming their ROADMAP item when the job conf asks
for them.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch

from tony_tpu_torch import chaos, ckpt, constants, resolve_device
from tony_tpu_torch.ckpt.format import torch_dtype
from tony_tpu_torch.ckpt.restore import _apply_dtype_policy
from tony_tpu_torch.conf import (CKPT_DIR, SERVE_AOT_CACHE, SERVE_BLOCK_SIZE,
                                 SERVE_CKPT_DIR, SERVE_CTX_MAX,
                                 SERVE_DEMOTE_BATCH, SERVE_DEMOTE_WATERMARK,
                                 SERVE_DRAFT_MODEL, SERVE_DTYPE_POLICY,
                                 SERVE_HOST_BLOCKS, SERVE_MAX_RUNNING,
                                 SERVE_MESH, SERVE_MODEL, SERVE_MODEL_KWARGS,
                                 SERVE_PORT, SERVE_PREFILL_CHUNK,
                                 SERVE_PREFIX_CACHE, SERVE_PREFIX_STORE,
                                 SERVE_QOS_TENANTS, SERVE_SPEC_K,
                                 SERVE_WARM_STANDBY, TonyConfig,
                                 serve_role_key, serve_warm_standby_key)
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import jax_param_tree
from tony_tpu_torch.publish import latest_publication
from tony_tpu_torch.serve.engine import Completion, EngineFront, ServeEngine
from tony_tpu_torch.serve.swap import SwapError, resolve_target

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
    :func:`_storage_dtype` of the policy."""

    def __init__(self, *, model_name: str,
                 model_kwargs: Optional[Dict[str, Any]] = None,
                 ckpt_dir: str, dtype_policy: Optional[str] = "bf16",
                 ctx_max: int = 2048, block_size: int = 16,
                 q_block: int = 16, n_blocks: Optional[int] = None,
                 max_running: int = 16, keep_logits: bool = False,
                 tag: str = "serve"):
        t0 = time.perf_counter()
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
            dict(self.model.named_parameters()),
            step=pub["step"] if pub else None)
        self.restored_step = step
        t2 = time.perf_counter()
        self.engine = ServeEngine(
            self.model, ctx_max=ctx_max, block_size=block_size,
            q_block=q_block, n_blocks=n_blocks, max_running=max_running,
            keep_logits=keep_logits, tag=tag, device=self.device)
        # Seed the serving version: a replica restored from a published
        # step advertises it on its first heartbeat, so a rolling swap
        # never re-swaps a replica that came up on the target.
        self.engine.weight_step = int(step)
        if pub is not None and pub["step"] == step:
            self.engine.weight_version = pub["version"]
        self.timings = {"build_s": t1 - t0, "restore_s": t2 - t1,
                        "engine_s": time.perf_counter() - t2}
        self._front = EngineFront(self.engine)
        self._publish: Optional[Any] = None
        self.port: Optional[int] = None

    def _restore_params(self, tensors: Mapping[str, torch.Tensor], *,
                        step: Optional[int] = None):
        """Restore the params subtree of committed step ``step`` (default:
        the newest) in place into ``tensors`` (the model's parameters, or
        a second set of the same names, shapes and dtypes) through the
        model's JAX param layout. Returns the step."""
        template = jax_param_tree(self.model, tensors)
        if step is None:
            step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {self.ckpt_dir} — a "
                f"replica serves a trained model, it does not initialize "
                f"one")
        try:
            prefix = ckpt.find_path_prefix(self.ckpt_dir, template,
                                           step=step)
        except KeyError as exc:
            raise KeyError(
                f"{exc.args[0]} Check the served model's kwargs against "
                f"the training job's: xent_chunk puts the head at "
                f"lm_head_kernel (else lm_head.kernel), and scan_layers "
                f"decides layers.block.* against layer_{{i}}.") from exc
        ckpt.restore_pytree(self.ckpt_dir, template, step=step,
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
        batch. ``conv`` and ``tenant`` raise (lanes not ported)."""
        return self._front.generate(tokens, max_new_tokens, rid=rid,
                                    conv=conv, tenant=tenant)

    # -- hot weight swap ---------------------------------------------------
    def hot_swap(self, *, version: Optional[int] = None,
                 step: Optional[int] = None) -> Dict[str, Any]:
        """Swap this replica onto a published step IN PLACE: no restart,
        no dropped request, no step function rebuilt.

        1. resolve the target (the published pointer, or an explicit
           ``step`` pin);
        2. restore its params into a SECOND parameter set of the same
           geometry while the engine keeps serving the old weights;
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
            rstep = self._restore_params(staged, step=to_step)
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

    def rpc_generate(self, tokens: List[int], max_new_tokens: int = 16,
                     rid: Optional[str] = None,
                     conv: Optional[str] = None,
                     tenant: Optional[str] = None) -> Dict[str, Any]:
        return self.replica.generate(tokens, max_new_tokens, rid=rid,
                                     conv=conv, tenant=tenant).wire()

    def rpc_serve_stats(self) -> Dict[str, Any]:
        return self.replica.engine.stats()

    def rpc_swap(self, version: Optional[int] = None,
                 step: Optional[int] = None) -> Dict[str, Any]:
        """The AM's rolling-fleet verb: hot-swap onto the published step
        (or an explicit ``step`` pin). A failure crosses the wire as
        ``"SwapError: ..."`` with the old weights still serving."""
        return self.replica.hot_swap(version=version, step=step)

    # The disaggregated handoff verbs and the warm-standby promotion.
    def rpc_prefill_handoff(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError(
            f"prefill_handoff: disaggregated serving is not ported yet "
            f"({_ITEM.format(9)})")

    def rpc_kv_offer(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError(
            f"kv_offer: disaggregated serving is not ported yet "
            f"({_ITEM.format(9)})")

    def rpc_kv_import(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError(
            f"kv_import: disaggregated serving is not ported yet "
            f"({_ITEM.format(9)})")

    def rpc_promote(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError(
            f"promote: the warm-standby pool is not ported yet "
            f"({_ITEM.format(12)})")


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


def _refuse_unported(conf: TonyConfig, job_type: str) -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP item for every
    serving lane the conf arms that the port has not ported, so no such
    setting is silently ignored."""
    warm = conf.get(serve_warm_standby_key(job_type))
    if warm is None:
        warm = conf.get(SERVE_WARM_STANDBY)
    role = conf.get(serve_role_key(job_type)) or "colocated"
    lanes = (
        (SERVE_SPEC_K, conf.get_int(SERVE_SPEC_K, 0) > 0, 9),
        (SERVE_DRAFT_MODEL, bool(conf.get(SERVE_DRAFT_MODEL)), 9),
        (SERVE_PREFIX_CACHE, conf.get_bool(SERVE_PREFIX_CACHE, False), 9),
        (SERVE_PREFILL_CHUNK, conf.get_int(SERVE_PREFILL_CHUNK, 0) > 0, 9),
        (serve_role_key(job_type), role != "colocated", 9),
        (SERVE_HOST_BLOCKS, conf.get_int(SERVE_HOST_BLOCKS, 0) > 0, 9),
        (SERVE_PREFIX_STORE, bool(conf.get(SERVE_PREFIX_STORE)), 9),
        (SERVE_QOS_TENANTS, bool(conf.get(SERVE_QOS_TENANTS)), 9),
        (SERVE_AOT_CACHE, bool(conf.get(SERVE_AOT_CACHE)), 12),
        (SERVE_WARM_STANDBY, int(warm or 0) > 0, 12),
        (SERVE_DEMOTE_WATERMARK,
         conf.get_float(SERVE_DEMOTE_WATERMARK, 0.0) > 0, 12),
        (SERVE_DEMOTE_BATCH, conf.get_int(SERVE_DEMOTE_BATCH, 0) > 0, 12),
        (SERVE_MESH, bool(conf.get(SERVE_MESH)), 8),
    )
    for key, armed, item in lanes:
        if armed:
            raise NotImplementedError(
                f"{key}={conf.get(key)!r}: this serving lane is not ported "
                f"yet ({_ITEM.format(item)})")


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
    _refuse_unported(conf, os.environ.get(constants.ENV_JOB_NAME) or "serve")
    replica = Replica(
        model_name=model_name,
        model_kwargs=_model_kwargs_from_json(conf.get(SERVE_MODEL_KWARGS)),
        ckpt_dir=ckpt_dir,
        dtype_policy=conf.get(SERVE_DTYPE_POLICY, "bf16"),
        ctx_max=conf.get_int(SERVE_CTX_MAX, 2048),
        block_size=conf.get_int(SERVE_BLOCK_SIZE, 16),
        max_running=conf.get_int(SERVE_MAX_RUNNING, 16))
    replica.serve_forever(
        port=conf.get_int(SERVE_PORT, 0),
        stats_path=os.environ.get(constants.ENV_SERVE_STATS))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
