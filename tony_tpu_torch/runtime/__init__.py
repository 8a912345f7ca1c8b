"""Framework-runtime SPI: the port's copy of :mod:`tony_tpu.runtime`.

Mirrors ``com.linkedin.tony.Framework`` (nested ``ApplicationMasterAdapter`` /
``TaskExecutorAdapter``) + ``FrameworkType`` (upstream ``tony-core/src/main/
java/com/linkedin/tony/Framework.java``, unverified — SURVEY.md §0).

Each supported framework contributes two adapters:

* an **AM-side adapter** — config validation, start gating, task callbacks;
* an **executor-side adapter** — builds the rendezvous env for the user
  process from the assembled cluster spec.

The port registers two: :class:`~tony_tpu_torch.runtime.pytorch_runtime.
PyTorchFramework` (``torch.distributed``'s c10d env plus the CUDA seams:
per-task ``CUDA_VISIBLE_DEVICES`` pinning, NCCL's error handling and the
checkpoint, publication, AOT-cache and data-seed settings) and
:class:`~tony_tpu_torch.runtime.standalone.StandaloneFramework` (the
serve replicas). The TensorFlow, Horovod, MXNet and JAX adapters are not
ported (ROADMAP queue 1, item 10). Standard library only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, TYPE_CHECKING

from tony_tpu_torch import constants

if TYPE_CHECKING:  # pragma: no cover
    from tony_tpu_torch.conf import TonyConfig
    from tony_tpu_torch.session import TonySession


@dataclass
class TaskContext:
    """Everything an executor-side adapter may need to build the user env
    (reference: the executor fields passed into ``buildTaskEnv``)."""
    conf: "TonyConfig"
    job_type: str
    index: int
    cluster_spec: Dict[str, List[str]]      # {job_type: ["host:port", ...]}
    am_address: str
    app_id: str
    attempt_id: int = 1
    tb_port: Optional[int] = None
    profiler_port: Optional[int] = None     # executor-reserved, ephemeral
    callback_info: Dict[str, str] = field(default_factory=dict)  # AM-pushed extras

    # -- derived helpers shared by adapters --------------------------------
    def job_types(self) -> List[str]:
        return self.conf.job_types()

    def ml_job_types(self) -> List[str]:
        """Job types that are part of the rendezvous world: everything except
        sidecars (tensorboard/notebook/driver). Rank assignment, world size
        and coordinator selection all run over these only — a configured
        sidecar must never become the coordinator or inflate WORLD_SIZE."""
        return [jt for jt in self.job_types()
                if jt not in constants.SIDECAR_JOB_TYPES]

    def is_sidecar(self) -> bool:
        return self.job_type in constants.SIDECAR_JOB_TYPES

    def num_tasks(self) -> int:
        """All tasks in the job, sidecars included (``TONY_NUM_TASKS``)."""
        return sum(len(v) for v in self.cluster_spec.values())

    def num_cluster_tasks(self) -> int:
        """World size for rendezvous purposes: sidecars excluded."""
        return sum(len(self.cluster_spec.get(jt, []))
                   for jt in self.ml_job_types())

    def global_rank(self) -> int:
        """Dense rank over (ml_job_types order, index) — must match
        ``TonySession.global_rank``. Raises for sidecar tasks and for
        out-of-range indices (mirroring ``TonySession.global_rank``)."""
        rank = 0
        for jt in self.ml_job_types():
            n = len(self.cluster_spec.get(jt, []))
            if jt == self.job_type:
                if not (0 <= self.index < n):
                    raise KeyError(f"unknown task {self.job_type}:{self.index}")
                return rank + self.index
            rank += n
        raise KeyError(f"job type {self.job_type} not in the rendezvous world")

    def spec_of(self, job_type: str, index: int) -> str:
        members = self.cluster_spec.get(job_type, [])
        if index >= len(members) or not members[index]:
            raise KeyError(f"no spec for {job_type}:{index}")
        return members[index]

    def rank0_spec(self) -> str:
        """host:port of the global-rank-0 task (the coordinator) — the first
        non-sidecar job type's task 0."""
        return self.spec_of(self.ml_job_types()[0], 0)

    def host_of(self, job_type: str, index: int) -> str:
        return self.spec_of(job_type, index).rsplit(":", 1)[0]

    def my_host(self) -> str:
        return self.host_of(self.job_type, self.index)

    def host_cohort(self) -> List[tuple[int, str]]:
        """(global_rank, job_type) of every rendezvous task sharing this
        task's host, ordered by global rank — the basis for local-rank and
        card-pinning math."""
        host = self.my_host()
        cohort = []
        rank = 0
        for jt in self.ml_job_types():
            for spec in self.cluster_spec.get(jt, []):
                if spec and spec.rsplit(":", 1)[0] == host:
                    cohort.append((rank, jt))
                rank += 1
        return cohort

    def local_rank(self) -> tuple[int, int]:
        """(local_rank, local_size) among rendezvous tasks sharing this task's
        host, ordered by global rank — Horovod/PyTorch local-rank semantics."""
        me = self.global_rank()
        cohort = [r for r, _jt in self.host_cohort()]
        return cohort.index(me), len(cohort)


class TaskExecutorAdapter:
    """Executor-side SPI (reference: ``Framework.TaskExecutorAdapter``)."""

    def need_reserve_tb_port(self, ctx: TaskContext) -> bool:
        """Whether this task should reserve a sidecar HTTP port: a dedicated
        ``tensorboard`` or ``notebook`` task, or the chief when no dedicated
        tensorboard task exists."""
        return ctx.job_type in (constants.TENSORBOARD, constants.NOTEBOOK) or (
            ctx.job_type in constants.CHIEF_LIKE_JOB_TYPES and
            constants.TENSORBOARD not in ctx.job_types())

    def need_reserve_profiler_port(self, ctx: TaskContext) -> bool:
        """Whether the executor should reserve an ephemeral profiler port
        for this task (no port runtime does: trace collection is not in
        the port's control plane yet)."""
        return False

    def build_task_env(self, ctx: TaskContext) -> Dict[str, str]:
        """Rendezvous env for the user process. Subclasses extend."""
        raise NotImplementedError

    def validate(self, ctx: TaskContext) -> None:
        """Pre-launch sanity hook (default: none)."""


class ApplicationMasterAdapter:
    """AM-side SPI (reference: ``Framework.ApplicationMasterAdapter``)."""

    def set_session(self, session: "TonySession") -> None:
        self.session = session

    def validate_and_update_config(self, conf: "TonyConfig") -> None:
        """Framework-specific config validation/defaulting (AM start)."""

    def can_start_task(self, job_type: str, index: int) -> bool:
        """Gate container launches (e.g. Horovod: driver must be ready)."""
        return True

    def on_all_registered(self) -> None:
        """Called once when the gang barrier passes — adapters that need a
        global view (Horovod slot assignment) compute it here."""

    def callback_info(self) -> Dict[str, str]:
        """Extra key/values shipped to every executor with the cluster spec
        (e.g. the Horovod rendezvous address)."""
        return {}

    def receive_task_callback_info(self, task_id: str, payload: str) -> None:
        """Executor-pushed framework-specific info (reference RPC of the
        same name)."""

    def stop(self) -> None:
        """Tear down AM-side resources (rendezvous drivers etc.)."""


class Framework:
    """One supported framework: a name plus its two adapter factories."""

    name: str = "abstract"

    def am_adapter(self) -> ApplicationMasterAdapter:
        return ApplicationMasterAdapter()

    def task_adapter(self) -> TaskExecutorAdapter:
        raise NotImplementedError


def _registry() -> Dict[str, Framework]:
    from tony_tpu_torch.runtime.pytorch_runtime import PyTorchFramework
    from tony_tpu_torch.runtime.standalone import StandaloneFramework
    fws = [PyTorchFramework(), StandaloneFramework()]
    return {f.name: f for f in fws}


FRAMEWORKS: Dict[str, "Framework"] = {}


def get_framework(name: str) -> Framework:
    """Look up a framework by ``tony.application.framework`` value
    (reference: ``Framework.of(FrameworkType)``)."""
    if not FRAMEWORKS:
        FRAMEWORKS.update(_registry())
    try:
        return FRAMEWORKS[name]
    except KeyError:
        raise ValueError(f"unknown framework {name!r}; known: {sorted(FRAMEWORKS)}")


# Populate eagerly so `name in FRAMEWORKS` works for conf.validate().
FRAMEWORKS.update(_registry())
