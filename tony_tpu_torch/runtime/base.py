"""Shared adapter base (reference: ``runtime/MLGenericRuntime.java``) — the
port's copy of :mod:`tony_tpu.runtime.base`.

Provides the common env every runtime exports — job name, task index, the full
cluster spec, app metadata — plus per-jobtype extra env from
``tony.<jobtype>.env``; and the port's card pinning (:func:`card_env`),
which both of its runtimes export.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional

from tony_tpu_torch import conf as conf_mod
from tony_tpu_torch import constants
from tony_tpu_torch.runtime import TaskContext, TaskExecutorAdapter


def visible_cards(ctx: TaskContext,
                  host_env: Optional[Mapping[str, str]] = None
                  ) -> Optional[List[str]]:
    """The ``CUDA_VISIBLE_DEVICES`` entries of ``ctx``'s task, or None for
    a task that asks for no card (or a sidecar). The offset is the
    cumulative card ask of the lower-ranked rendezvous tasks on the same
    host — each sized by its OWN job type's ``gpus`` — so mixed cohorts
    neither overlap nor leave gaps; it indexes the host's own visible
    list where ``CUDA_VISIBLE_DEVICES`` restricts the host. A task whose
    cards lie past the host's raises: it must never fall back to another
    card or the CPU."""
    gpus = ctx.conf.get_int(conf_mod.gpus_key(ctx.job_type), 0)
    if gpus <= 0 or ctx.is_sidecar():
        return None
    rank = ctx.global_rank()
    first = sum(ctx.conf.get_int(conf_mod.gpus_key(jt), 0)
                for r, jt in ctx.host_cohort() if r < rank)
    env = os.environ if host_env is None else host_env
    host = env.get(constants.ENV_CUDA_VISIBLE_DEVICES)
    if host is None:
        return [str(first + i) for i in range(gpus)]
    cards = [c.strip() for c in host.split(",") if c.strip()]
    if first + gpus > len(cards):
        raise RuntimeError(
            f"task {ctx.job_type}:{ctx.index} needs cards "
            f"{first}..{first + gpus - 1} of its host, which sees only "
            f"{constants.ENV_CUDA_VISIBLE_DEVICES}={host!r}")
    return cards[first:first + gpus]


def card_env(ctx: TaskContext) -> Dict[str, str]:
    """``CUDA_VISIBLE_DEVICES`` (the task's cards, by nvidia-smi's index:
    ``CUDA_DEVICE_ORDER=PCI_BUS_ID``) and ``TONY_TASK_GPUS`` (their count:
    TonY pinned this task) for a task with a ``gpus`` ask; nothing
    otherwise."""
    cards = visible_cards(ctx)
    if cards is None:
        return {}
    return {constants.ENV_CUDA_VISIBLE_DEVICES: ",".join(cards),
            constants.ENV_CUDA_DEVICE_ORDER: "PCI_BUS_ID",
            constants.ENV_TASK_GPUS: str(len(cards))}


class MLGenericTaskAdapter(TaskExecutorAdapter):
    """Common env builder; framework adapters extend :meth:`framework_env`."""

    def build_task_env(self, ctx: TaskContext) -> Dict[str, str]:
        env: Dict[str, str] = {
            constants.ENV_JOB_TYPE: ctx.job_type,
            constants.ENV_TASK_INDEX_USER: str(ctx.index),
            constants.ENV_DIST_SPEC: json.dumps(ctx.cluster_spec, sort_keys=True),
            constants.ENV_JOB_NAME: ctx.job_type,
            constants.ENV_TASK_INDEX: str(ctx.index),
            constants.ENV_TASK_NUM: str(ctx.num_tasks()),
            constants.ENV_APP_ID: ctx.app_id,
            constants.ENV_ATTEMPT_ID: str(ctx.attempt_id),
            constants.ENV_AM_ADDRESS: ctx.am_address,
        }
        if ctx.tb_port is not None:
            env[constants.ENV_TB_PORT] = str(ctx.tb_port)
        env.update(ctx.conf.task_env(ctx.job_type))
        env.update(self.framework_env(ctx))
        return env

    def framework_env(self, ctx: TaskContext) -> Dict[str, str]:
        return {}
