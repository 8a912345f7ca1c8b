"""StandaloneRuntime: no rendezvous env — single-task or embarrassingly
parallel jobs, and the notebook path (reference:
``runtime/StandaloneRuntime.java``) — the port's copy of
:mod:`tony_tpu.runtime.standalone`; ``tony serve`` runs its replicas
under it. The port adds the card pinning of a ``gpus`` ask
(:func:`~tony_tpu_torch.runtime.base.card_env`), so a replica sees only
its own cards."""

from __future__ import annotations

from typing import Dict

from tony_tpu_torch.runtime import Framework, TaskContext
from tony_tpu_torch.runtime.base import MLGenericTaskAdapter, card_env


class StandaloneTaskAdapter(MLGenericTaskAdapter):
    def framework_env(self, ctx: TaskContext) -> Dict[str, str]:
        return card_env(ctx)    # the common env, plus the task's cards


class StandaloneFramework(Framework):
    name = "standalone"

    def task_adapter(self) -> StandaloneTaskAdapter:
        return StandaloneTaskAdapter()
