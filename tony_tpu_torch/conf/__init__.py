"""Job configuration: a copy of the part of :mod:`tony_tpu.conf` the
port's serve replica reads (the port imports nothing of the JAX
package).

The conf file the executor hands a task (``TONY_CONF_PATH``) is the
control plane's serialized :class:`TonyConfig`, a JSON object of every
effective key (the AM writes it as ``tony-job.json``). This copy loads
it and reads it with the same typed getters, and names every
``tony.serve.*`` key, the two per-jobtype serve keys and the instance
count the replica reads, the history root its ``warm()`` pad tuner
reads and the train plane's AOT cache key. ``tests/test_torch_purity.py`` holds each name, helper and getter
equal to the original. Defaults, overrides, job-type discovery,
serialization and validation stay in the control plane.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

# Checkpoint plane: the durable directory the train gang commits steps
# into; a replica with no tony.serve.ckpt-dir serves from it.
CKPT_DIR = "tony.ckpt.dir"
# The history plane's event-log root: a replica with the cold-start
# plane armed tunes its warm() prefill pads from the serve windows there.
HISTORY_LOCATION = "tony.history.location"
# Shared per-gang train-side AOT cache dir (the cold-start plane's train
# half); exported to tasks as TONY_TRAIN_AOT_CACHE.
TRAIN_AOT_CACHE = "tony.train.aot-cache"

# -- serving plane (the `tony serve` CLI writes these, the replica process
# and the AM's replica autoscaler read them) -------------------------------
SERVE_MODEL = "tony.serve.model"                # registered model name
SERVE_MODEL_KWARGS = "tony.serve.model-kwargs"  # JSON dict of model kwargs
SERVE_CKPT_DIR = "tony.serve.ckpt-dir"          # training ckpt to serve
SERVE_DTYPE_POLICY = "tony.serve.dtype-policy"  # bf16 (default) | f32
SERVE_CTX_MAX = "tony.serve.ctx-max"            # max positions per sequence
SERVE_BLOCK_SIZE = "tony.serve.block-size"      # KV pool block size
SERVE_MAX_RUNNING = "tony.serve.max-running"    # max joined batch
SERVE_MESH = "tony.serve.mesh"                  # JSON MeshSpec kwargs
SERVE_PORT = "tony.serve.port"                  # replica RPC port (0=any)
SERVE_REPLICAS_MIN = "tony.serve.replicas.min"  # autoscale floor
SERVE_REPLICAS_MAX = "tony.serve.replicas.max"  # autoscale ceiling
SERVE_QUEUE_HIGH = "tony.serve.scale.queue-high"
SERVE_QUEUE_LOW = "tony.serve.scale.queue-low"
SERVE_P99_HIGH_MS = "tony.serve.scale.p99-high-ms"
SERVE_COOLDOWN_S = "tony.serve.scale.cooldown-s"
# Speculative decoding lane: spec-k > 0 turns the engine into the
# draft-and-verify engine (a named draft model, or the n-gram fallback).
SERVE_SPEC_K = "tony.serve.spec-k"              # draft depth (0 = off)
# Prefix caching, chunked prefill and the router's replica scoring.
SERVE_PREFIX_CACHE = "tony.serve.prefix-cache"  # true arms block sharing
SERVE_PREFILL_CHUNK = "tony.serve.prefill-chunk"  # rows/chunk (0 = mono)
SERVE_ROUTE_CACHE_WEIGHT = "tony.serve.route.cache-weight"
SERVE_ROUTE_QUEUE_WEIGHT = "tony.serve.route.queue-weight"
SERVE_ROUTE_P99_WEIGHT = "tony.serve.route.p99-weight"
SERVE_DRAFT_MODEL = "tony.serve.draft.model"    # registered draft model
SERVE_DRAFT_MODEL_KWARGS = "tony.serve.draft.model-kwargs"  # JSON kwargs
SERVE_DRAFT_CKPT_DIR = "tony.serve.draft.ckpt-dir"  # draft training ckpt
SERVE_DRAFT_NGRAM_MAX = "tony.serve.draft.ngram-max"  # fallback n-gram n
# Disaggregated prefill/decode: tony.serve.role.<jobtype> =
# prefill|decode|colocated (absent: colocated).
SERVE_ROLE_PREFIX = "tony.serve.role."
# KV memory hierarchy: the host-offload tier and the on-disk prefix store.
SERVE_HOST_BLOCKS = "tony.serve.host-blocks"    # host tier size (0 = off)
SERVE_PREFIX_STORE = "tony.serve.prefix-store"  # stem store dir ("" = off)
# Replica cold-start plane: the AOT cache, the warm-standby pool and the
# demotion daemon.
SERVE_AOT_CACHE = "tony.serve.aot-cache"        # AOT cache dir ("" = off)
SERVE_WARM_STANDBY = "tony.serve.warm-standby"  # standby pool size (0=off)
SERVE_DEMOTE_WATERMARK = "tony.serve.demote-watermark"  # pool frac (0=off)
SERVE_DEMOTE_BATCH = "tony.serve.demote-batch"  # blocks/sweep (0=nb_max)
# Multi-tenant QoS and SLO autoscaling.
SERVE_QOS_TENANTS = "tony.serve.qos.tenants"    # "name:weight,.." ("" = off)
SERVE_QOS_MAX_QUEUE = "tony.serve.qos.max-queue"  # per-tenant cap (0 = inf)
SERVE_SLO_TARGET_MS = "tony.serve.scale.slo-target-ms"  # p99 target (0=off)
SERVE_SLO_TARGETS = "tony.serve.scale.slo-targets"


def serve_role_key(job_type: str) -> str:
    """Per-jobtype serving role: ``tony.serve.role.<jobtype>`` =
    prefill|decode|colocated."""
    return f"{SERVE_ROLE_PREFIX}{job_type}"


def instances_key(job_type: str) -> str:
    return f"tony.{job_type}.instances"


def serve_warm_standby_key(job_type: str) -> str:
    """Per-jobtype warm-standby pool override for a split fleet:
    ``tony.serve.warm-standby.<jobtype>``."""
    return f"{SERVE_WARM_STANDBY}.{job_type}"


class TonyConfig:
    """String-keyed job configuration, read with typed getters."""

    def __init__(self, initial: Optional[Dict[str, str]] = None):
        self._props: Dict[str, str] = {
            k: str(v) for k, v in (initial or {}).items()}

    @classmethod
    def load(cls, path: str | Path) -> "TonyConfig":
        """Load a serialized job conf: a JSON object of key → value."""
        data = json.loads(Path(path).read_text())
        if not isinstance(data, dict):
            raise ValueError(f"config file {path} must hold a JSON object")
        return cls({str(k): v for k, v in data.items()})

    # -- typed getters ------------------------------------------------------
    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._props.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._props.get(key)
        return int(v) if v not in (None, "") else default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self._props.get(key)
        return float(v) if v not in (None, "") else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._props.get(key)
        if v is None or v == "":
            return default
        return v.strip().lower() in ("true", "1", "yes", "on")

    def instances(self, job_type: str) -> int:
        return self.get_int(instances_key(job_type), 0)
