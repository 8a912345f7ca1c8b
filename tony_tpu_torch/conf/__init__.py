"""Layered job configuration with open per-jobtype templating: the port's
copy of :mod:`tony_tpu.conf` (the port imports nothing of the JAX
package).

Mirrors ``com.linkedin.tony.TonyConfigurationKeys`` +
``tony-core/src/main/resources/tony-default.xml`` (upstream paths, unverified —
SURVEY.md §0). The open per-jobtype key template::

    tony.<jobtype>.instances / .memory / .vcores / .gpus / .command

lets ``ps``/``worker``/``chief``/``evaluator``/``tensorboard``/``notebook``
— or any user-invented job type — work without code changes.

Layering (lowest to highest precedence), as in Hadoop ``Configuration``:

1. built-in defaults (:data:`DEFAULTS`, the ``tony-default.xml`` analogue)
2. a user config file — Hadoop-style ``tony.xml`` or JSON — via :meth:`TonyConfig.load`
3. explicit ``-D key=value`` overrides via :meth:`TonyConfig.set`

Where the port differs from the original: this is a GPU substrate, so
``tony.<jobtype>.gpus`` asks are scheduled (against the GPU census or
``tony.scheduler.total-gpus`` / ``host-gpus``) and ``tony.<jobtype>.tpus``
asks are refused; the default framework is ``pytorch`` and the known
ones are ``pytorch`` and ``standalone``; the multi-host backend is
``ssh`` (``tpu-vm`` is refused, naming it); the libtpu, multi-slice and
XLA-flag keys of the JAX runtime are left out.
``tests/test_torch_control.py`` and ``tests/test_torch_purity.py`` hold
every shared key, default and getter equal to the original.
"""

from __future__ import annotations

import json
import re
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

from tony_tpu_torch import constants

# --------------------------------------------------------------------------
# Key names (reference: TonyConfigurationKeys.*)
# --------------------------------------------------------------------------
TONY_PREFIX = "tony."

APPLICATION_NAME = "tony.application.name"
APPLICATION_FRAMEWORK = "tony.application.framework"          # pytorch|standalone
APPLICATION_UNTRACKED = "tony.application.untracked.jobtypes" # csv of untracked types
APPLICATION_STOP_ON_FAILURE = "tony.application.fail-fast"    # fail job on first task failure
APPLICATION_TIMEOUT = "tony.application.timeout-ms"           # 0 = no timeout
APPLICATION_NODE_BLACKLIST = "tony.application.node-blacklist"
# CSV of extra files/dirs/archives to localize into every container's cwd
# (reference: LocalizableResource / Utils.uploadFileAndSetConfResources —
# datasets, tokenizer files, certs). An entry suffixed "#archive" is
# unpacked in the container cwd instead of copied.
CONTAINERS_RESOURCES = "tony.containers.resources"
SECURITY_ENABLED = "tony.security.enabled"
DOCKER_ENABLED = "tony.docker.enabled"
DOCKER_IMAGE = "tony.docker.containers.image"

TASK_HEARTBEAT_INTERVAL_MS = "tony.task.heartbeat-interval-ms"
TASK_MAX_MISSED_HEARTBEATS = "tony.task.max-missed-heartbeats"
TASK_METRICS_INTERVAL_MS = "tony.task.metrics-interval-ms"
TASK_EXECUTOR_EXECUTION_TIMEOUT_MS = "tony.task.executor.execution-timeout-ms"

AM_RETRY_COUNT = "tony.am.retry-count"                        # gang-restart attempts
AM_MAX_ATTEMPTS = "tony.am.max-attempts"                      # AM-process relaunches (reference: yarn am max-attempts)
AM_MEMORY = "tony.am.memory"
AM_VCORES = "tony.am.vcores"
AM_GANG_TIMEOUT_MS = "tony.am.gang-allocation-timeout-ms"     # all-registered barrier timeout

PREEMPTION_MAX_RETRIES = "tony.container.preemption.max-retries"

HISTORY_LOCATION = "tony.history.location"                    # event-log root dir
SCHEDULER_TOTAL_GPUS = "tony.scheduler.total-gpus"            # GPU-census override
SCHEDULER_HOST_GPUS = "tony.scheduler.host-gpus"              # cards a host (ssh)
SCHEDULER_BACKEND = "tony.scheduler.backend"                  # local|ssh
PYTHON_VENV = "tony.application.python-venv"                  # venv dir/archive to ship
PYTHON_BINARY = "tony.application.python-binary"              # interpreter path (in venv)
# Checkpoint plane (tony_tpu_torch.ckpt). tony.ckpt.dir names the DURABLE
# shared directory (the HDFS-dir analogue that survives gang restarts) the
# async checkpointer commits steps into; setting it turns on the whole
# wiring: PyTorchRuntime exports TONY_CKPT_DIR/EVERY/KEEP to its tasks
# (train_loop's defaults), and the executor reports the last committed step found there
# over the heartbeat RPC so the AM logs what a gang restart resumes from.
CKPT_DIR = "tony.ckpt.dir"
CKPT_EVERY = "tony.ckpt.every"            # save every N steps (0 = final only)
CKPT_KEEP = "tony.ckpt.keep"              # committed steps retained (def. 3)
# Input-data plane (tony_tpu_torch.data): seed of the deterministic global
# example stream. Exported to pytorch tasks as TONY_DATA_SEED (Dataset's
# default seed) so every process in the gang — and every RESTART of the
# gang — derives the identical stream; the per-host shard comes from the
# rendezvous identity, not from conf.
DATA_SEED = "tony.data.seed"

# -- serving plane (tony_tpu_torch.serve; the `tony serve` CLI writes these,
# the replica process and the AM's replica autoscaler read them) --------
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
# Speculative decoding lane (tony_tpu_torch.serve.spec): spec-k > 0 turns the
# replica's engine into the draft-and-verify SpecEngine. With a draft
# model name it restores a second (smaller, optionally quant=-laned)
# transformer through the same elastic-restore path; without one the
# self-drafting n-gram fallback runs — no second checkpoint needed.
SERVE_SPEC_K = "tony.serve.spec-k"              # draft depth (0 = off)
# Prefix caching + chunked prefill + cross-replica routing: the
# engine's prefix tier shares block-hashed KV across admissions; chunked
# prefill interleaves long prompts with decode; the route weights feed
# the gateway router's replica scoring (prefix-digest overlap vs load).
SERVE_PREFIX_CACHE = "tony.serve.prefix-cache"  # true arms block sharing
SERVE_PREFILL_CHUNK = "tony.serve.prefill-chunk"  # rows/chunk (0 = mono)
SERVE_ROUTE_CACHE_WEIGHT = "tony.serve.route.cache-weight"
SERVE_ROUTE_QUEUE_WEIGHT = "tony.serve.route.queue-weight"
SERVE_ROUTE_P99_WEIGHT = "tony.serve.route.p99-weight"
SERVE_DRAFT_MODEL = "tony.serve.draft.model"    # registered draft model
SERVE_DRAFT_MODEL_KWARGS = "tony.serve.draft.model-kwargs"  # JSON kwargs
SERVE_DRAFT_CKPT_DIR = "tony.serve.draft.ckpt-dir"  # draft training ckpt
SERVE_DRAFT_NGRAM_MAX = "tony.serve.draft.ngram-max"  # fallback n-gram n
# Disaggregated prefill/decode: serve-role jobtypes. A jobtype
# carrying tony.serve.role.<jobtype> = prefill|decode|colocated is a
# serving gang of that role — the first heterogeneous-gang wiring: ONE
# job runs a prefill gang and a decode gang as separate jobtypes, each
# with its own instance count and autoscale floor, sharing the serve.*
# engine config. The AM's autoscaler and the serve_endpoints verb treat
# every role-keyed jobtype (plus the classic "serve") as serving.
SERVE_ROLE_PREFIX = "tony.serve.role."
# KV memory hierarchy: host-blocks > 0 arms the pool's host-
# offload tier (cold published stems demote to host RAM, finished
# conversation turns PARK there and resume without re-prefill); the
# prefix store names an on-disk directory of persisted hot stems —
# replicas load it at startup and scale-up grants inherit it, so a
# fresh replica warms its prefix tier from disk instead of recompute.
SERVE_HOST_BLOCKS = "tony.serve.host-blocks"    # host tier size (0 = off)
SERVE_PREFIX_STORE = "tony.serve.prefix-store"  # stem store dir ("" = off)
# Replica cold-start plane: the AOT cache dir persists compiled
# step executables next to the ckpt manifest (tony_tpu_torch.ckpt.aot) so a
# scale-up grant deserializes instead of re-tracing; warm-standby > 0
# holds that many compiled-and-idle replicas per serve jobtype ahead of
# the traffic curve (the AM promotes one on scale-up instead of a cold
# grant); the demote watermark arms the engine-loop demotion daemon
# that pre-drains the device pool into the host tier.
SERVE_AOT_CACHE = "tony.serve.aot-cache"        # AOT cache dir ("" = off)
SERVE_WARM_STANDBY = "tony.serve.warm-standby"  # standby pool size (0=off)
SERVE_DEMOTE_WATERMARK = "tony.serve.demote-watermark"  # pool frac (0=off)
SERVE_DEMOTE_BATCH = "tony.serve.demote-batch"  # blocks/sweep (0=nb_max)
# Multi-tenant QoS + SLO autoscaling: the tenants CSV declares
# the gang's QoS classes as "name:weight,..." — requests tagged with a
# tenant get a weighted-fair share of the paged KV pool at admission
# (work-conserving: an idle tenant's share redistributes), so one
# tenant's prefill burst queues behind its own budget instead of
# starving another tenant's decode floor. Untagged requests bypass
# budgets entirely; with the CSV empty the engine is byte-identical to
# an un-QoS'd one. The SLO target switches the autoscaler from raw
# queue depth to p99-vs-target per gang, computed from the same latency
# windows the history plane logs — a replayed event log reproduces the
# live scale decisions exactly.
SERVE_QOS_TENANTS = "tony.serve.qos.tenants"    # "name:weight,.." ("" = off)
SERVE_QOS_MAX_QUEUE = "tony.serve.qos.max-queue"  # per-tenant cap (0 = inf)
SERVE_SLO_TARGET_MS = "tony.serve.scale.slo-target-ms"  # p99 target (0=off)
# Per-tenant p99 targets ("gold:200,silver:800", same grammar as the QoS
# tenants CSV): SLO mode scales on the WORST tenant's p99-vs-target,
# read from the tenants breakdown riding every SERVE_WINDOW record.
# Composes with the single gang-wide target; "" = per-tenant mode off.
SERVE_SLO_TARGETS = "tony.serve.scale.slo-targets"

# Elastic gang resize (the reference AM's tony_tpu.am.resize; refused by
# the port's client): on worker preemption / lost
# heartbeat (or `tony resize N`), drain survivors through an atomic
# commit, re-gang at the new host count, and restore elastically —
# instead of the full gang restart. Off by default: the historical
# preemption-retry + gang-restart behavior is byte-unchanged unless
# armed.
RESIZE_ENABLED = "tony.resize.enabled"
RESIZE_JOB_TYPE = "tony.resize.job-type"            # the elastic train gang
RESIZE_MIN_WORKERS = "tony.resize.min-workers"      # floor after shrink
RESIZE_MAX_RESIZES = "tony.resize.max-resizes"      # per-job resize budget
RESIZE_DRAIN_TIMEOUT_MS = "tony.resize.drain-timeout-ms"
RESIZE_REGANG_TIMEOUT_MS = "tony.resize.regang-timeout-ms"
RESIZE_RESTORE_TIMEOUT_MS = "tony.resize.restore-timeout-ms"

# Continuous weight publication (tony_tpu_torch.publish / serve.swap):
# with publish.every > 0, PyTorchRuntime exports TONY_PUBLISH_EVERY and the train
# loop advances the ckpt root's published.json pointer every N committed
# saves (stage-and-rename, announced on the heartbeat). publish.follow
# = true arms the reference AM's rolling fleet swap (not in the port's AM): when a newer pointer version
# appears (heartbeat or a direct ckpt-dir read), serve replicas hot-swap
# to it one at a time, down-marked in the router for their swap window.
PUBLISH_EVERY = "tony.publish.every"                # saves/publication (0=off)
PUBLISH_FOLLOW = "tony.publish.follow"              # AM swaps the fleet
PUBLISH_SWAP_TIMEOUT_MS = "tony.publish.swap-timeout-ms"  # per-replica window
# Shared per-gang train-side AOT cache dir (the serve cold-start plane's
# train half): one worker pays the accum-step trace+compile per (mesh,
# geometry) fingerprint, the rest of the gang — and every post-resize
# re-gang — deserializes. Exported to pytorch tasks as TONY_TRAIN_AOT_CACHE.
TRAIN_AOT_CACHE = "tony.train.aot-cache"            # cache dir ("" = off)
# link (default): per-container venv localization hardlinks file content —
# metadata-only, but containers ALIAS the staged inodes, so a job that
# rewrites venv files IN PLACE (r+ open, forced reinstall reusing inodes)
# would mutate every sibling container's view. Such jobs set "copy".
VENV_LOCALIZATION = "tony.task.venv-localization"             # link|copy

# Per-jobtype templates (reference: tony.{jobtype}.{instances,memory,vcores,gpus})
def instances_key(job_type: str) -> str:
    return f"tony.{job_type}.instances"

def memory_key(job_type: str) -> str:
    return f"tony.{job_type}.memory"

def vcores_key(job_type: str) -> str:
    return f"tony.{job_type}.vcores"

def gpus_key(job_type: str) -> str:
    return f"tony.{job_type}.gpus"

def tpus_key(job_type: str) -> str:
    return f"tony.{job_type}.tpus"          # the JAX substrate's chip ask (refused)

def command_key(job_type: str) -> str:
    return f"tony.{job_type}.command"       # per-jobtype command override

def serve_role_key(job_type: str) -> str:
    """Per-jobtype serving role (tony_tpu.serve.disagg):
    ``tony.serve.role.<jobtype>`` = prefill|decode|colocated."""
    return f"{SERVE_ROLE_PREFIX}{job_type}"

def serve_replicas_max_key(job_type: str) -> str:
    """Per-GANG autoscale ceiling override for a split fleet:
    ``tony.serve.replicas.max.<jobtype>``. Without it, the global
    ``tony.serve.replicas.max`` is a FLEET ceiling that the AM
    apportions across the serve jobtypes (scaling.apportion_fleet_max)
    — two gangs must not each inflate to the whole budget."""
    return f"{SERVE_REPLICAS_MAX}.{job_type}"

def serve_warm_standby_key(job_type: str) -> str:
    """Per-jobtype warm-standby pool override for a split fleet:
    ``tony.serve.warm-standby.<jobtype>``. Without it the global
    ``tony.serve.warm-standby`` applies to every serve jobtype —
    a prefill gang and a decode gang usually want different pools
    (prefill compiles one chunk program; decode compiles a bucket
    ladder), so the per-gang key mirrors the replicas.max override."""
    return f"{SERVE_WARM_STANDBY}.{job_type}"

def env_key(job_type: str) -> str:
    return f"tony.{job_type}.env"           # csv KEY=VALUE extra env

_INSTANCES_RE = re.compile(r"^tony\.([A-Za-z0-9_\-]+)\.instances$")
# Keys of the form tony.<word>.instances that are NOT job types.
_RESERVED_SEGMENTS = {"application", "task", "am", "container", "history",
                      "docker", "security", "keytab"}

DEFAULTS: Dict[str, str] = {
    APPLICATION_NAME: "tony-tpu-job",
    APPLICATION_FRAMEWORK: "pytorch",
    APPLICATION_UNTRACKED: f"{constants.PS},{constants.TENSORBOARD},{constants.NOTEBOOK},{constants.DRIVER},{constants.SCHEDULER}",
    APPLICATION_STOP_ON_FAILURE: "true",
    APPLICATION_TIMEOUT: "0",
    SECURITY_ENABLED: "false",
    DOCKER_ENABLED: "false",
    TASK_HEARTBEAT_INTERVAL_MS: "1000",
    TASK_MAX_MISSED_HEARTBEATS: "25",
    TASK_METRICS_INTERVAL_MS: "5000",
    TASK_EXECUTOR_EXECUTION_TIMEOUT_MS: "0",
    AM_RETRY_COUNT: "0",
    AM_MAX_ATTEMPTS: "1",
    AM_MEMORY: "2g",
    AM_VCORES: "1",
    AM_GANG_TIMEOUT_MS: "120000",
    PREEMPTION_MAX_RETRIES: "3",
    HISTORY_LOCATION: "",
    RESIZE_ENABLED: "false",
    RESIZE_JOB_TYPE: constants.WORKER,
    RESIZE_MIN_WORKERS: "1",
    RESIZE_MAX_RESIZES: "8",
    RESIZE_DRAIN_TIMEOUT_MS: "60000",
    RESIZE_REGANG_TIMEOUT_MS: "120000",
    RESIZE_RESTORE_TIMEOUT_MS: "120000",
    PUBLISH_EVERY: "0",
    PUBLISH_FOLLOW: "false",
    PUBLISH_SWAP_TIMEOUT_MS: "120000",
    TRAIN_AOT_CACHE: "",
}


def _parse_memory(value: str) -> int:
    """Parse '2g'/'512m'/'1024' (MiB) into MiB, as the reference's resource parser does."""
    v = value.strip().lower()
    if v.endswith("g"):
        return int(float(v[:-1]) * 1024)
    if v.endswith("m"):
        return int(float(v[:-1]))
    return int(v)


class TonyConfig:
    """Layered string-keyed configuration (Hadoop ``Configuration`` analogue)."""

    def __init__(self, initial: Optional[Dict[str, str]] = None):
        self._props: Dict[str, str] = dict(DEFAULTS)
        if initial:
            for k, v in initial.items():
                self._props[k] = str(v)

    # -- loading ------------------------------------------------------------
    @classmethod
    def load(cls, path: str | Path) -> "TonyConfig":
        """Load a config file on top of defaults. ``.xml`` is parsed as a
        Hadoop-style ``<configuration><property><name>..<value>..`` document
        (``tony.xml`` compatibility); anything else is parsed as JSON."""
        cfg = cls()
        cfg.merge_file(path)
        return cfg

    def merge_file(self, path: str | Path) -> None:
        path = Path(path)
        if path.suffix == ".xml":
            root = ET.parse(path).getroot()
            for prop in root.iter("property"):
                name = prop.findtext("name")
                value = prop.findtext("value")
                if name is not None and value is not None:
                    self._props[name.strip()] = value.strip()
        else:
            data = json.loads(path.read_text())
            if not isinstance(data, dict):
                raise ValueError(f"config file {path} must hold a JSON object")
            for k, v in data.items():
                self._props[str(k)] = str(v)

    def merge_overrides(self, overrides: Dict[str, str]) -> None:
        """Apply ``-D key=value`` style overrides (highest precedence)."""
        for k, v in overrides.items():
            self._props[str(k)] = str(v)

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

    def get_list(self, key: str, default: Tuple[str, ...] = ()) -> List[str]:
        v = self._props.get(key)
        if not v:
            return list(default)
        return [item.strip() for item in v.split(",") if item.strip()]

    def get_memory_mb(self, key: str, default: str = "1g") -> int:
        return _parse_memory(self._props.get(key) or default)

    def set(self, key: str, value: Any) -> None:
        self._props[key] = str(value)

    def unset(self, key: str) -> None:
        self._props.pop(key, None)

    def __contains__(self, key: str) -> bool:
        return key in self._props

    def items(self) -> Iterator[Tuple[str, str]]:
        return iter(sorted(self._props.items()))

    # -- job-type discovery (the open templating) ---------------------------
    def job_types(self) -> List[str]:
        """All configured job types: every ``tony.<type>.instances`` key with a
        positive count, excluding reserved segments. Order is deterministic:
        chief-like first, then alphabetical (matches the reference's stable
        cluster-spec assembly)."""
        found = []
        for key in self._props:
            m = _INSTANCES_RE.match(key)
            if not m:
                continue
            jt = m.group(1)
            if jt in _RESERVED_SEGMENTS:
                continue
            if self.get_int(key, 0) > 0:
                found.append(jt)
        # Canonical chief-like order (CHIEF_LIKE_JOB_TYPES order, NOT dict
        # insertion order) so the AM and every executor — which load the
        # config from different serializations — agree on rank 0.
        chief_like = [t for t in constants.CHIEF_LIKE_JOB_TYPES if t in found]
        rest = sorted(t for t in found if t not in constants.CHIEF_LIKE_JOB_TYPES)
        return chief_like + rest

    def instances(self, job_type: str) -> int:
        return self.get_int(instances_key(job_type), 0)

    def total_tasks(self) -> int:
        return sum(self.instances(t) for t in self.job_types())

    def untracked_job_types(self) -> List[str]:
        return self.get_list(APPLICATION_UNTRACKED)

    def is_tracked(self, job_type: str) -> bool:
        return job_type not in self.untracked_job_types()

    def task_env(self, job_type: str) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for pair in self.get_list(env_key(job_type)):
            if "=" in pair:
                k, _, v = pair.partition("=")
                out[k] = v
        return out

    def container_request(self, job_type: str) -> "ContainerRequest":
        return ContainerRequest(
            job_type=job_type,
            instances=self.instances(job_type),
            memory_mb=self.get_memory_mb(memory_key(job_type), "1g"),
            vcores=self.get_int(vcores_key(job_type), 1),
            gpus=self.get_int(gpus_key(job_type), 0),
            tpus=self.get_int(tpus_key(job_type), 0),
        )

    # -- validation (reference: TonyClient#init sanity checks) -------------
    def validate(self) -> None:
        if not self.job_types():
            raise ValueError(
                "no job types configured: set at least one tony.<jobtype>.instances > 0")
        for jt in self.job_types():
            if self.get_int(vcores_key(jt), 1) <= 0:
                raise ValueError(f"{vcores_key(jt)} must be > 0")
            if self.get_int(gpus_key(jt), 0) < 0:
                raise ValueError(f"{gpus_key(jt)} must be >= 0")
            # This is a GPU substrate: a chip ask that scheduled on the
            # TPU substrate would otherwise silently no-op here — fail
            # loudly at submit instead (the mirror of the original's GPU
            # refusal).
            if self.get_int(tpus_key(jt), 0) > 0:
                raise ValueError(
                    f"{tpus_key(jt)}: TPU chips cannot be scheduled on the "
                    f"GPU substrate; ask for cards with {gpus_key(jt)} "
                    f"instead")
        backend = self.get(SCHEDULER_BACKEND, "local")
        if backend == "tpu-vm":
            raise ValueError(
                f"{SCHEDULER_BACKEND}=tpu-vm names a TPU-VM pod slice; the "
                f"port's multi-host backend is {SCHEDULER_BACKEND}=ssh")
        framework = self.get(APPLICATION_FRAMEWORK, "pytorch")
        from tony_tpu_torch.runtime import FRAMEWORKS  # late import: avoid cycle
        if framework not in FRAMEWORKS:
            raise ValueError(
                f"unknown {APPLICATION_FRAMEWORK}={framework!r}; "
                f"known: {sorted(FRAMEWORKS)}")

    # -- serialization (ship effective conf to AM / executors) -------------
    def to_json(self) -> str:
        return json.dumps(self._props, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TonyConfig":
        cfg = cls()
        cfg._props.update({str(k): str(v) for k, v in json.loads(text).items()})
        return cfg

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())


class ContainerRequest:
    """Resource ask for one job type (reference: ``JobContainerRequest``)."""

    __slots__ = ("job_type", "instances", "memory_mb", "vcores", "gpus", "tpus")

    def __init__(self, job_type: str, instances: int, memory_mb: int,
                 vcores: int, gpus: int, tpus: int):
        self.job_type = job_type
        self.instances = instances
        self.memory_mb = memory_mb
        self.vcores = vcores
        self.gpus = gpus
        self.tpus = tpus

    def __repr__(self) -> str:
        return (f"ContainerRequest({self.job_type}x{self.instances}, "
                f"{self.memory_mb}MiB, {self.vcores}c, gpus={self.gpus}, tpus={self.tpus})")

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ContainerRequest) and all(
            getattr(self, f) == getattr(other, f) for f in self.__slots__)
