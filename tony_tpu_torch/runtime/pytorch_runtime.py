"""PyTorchRuntime: c10d TCP-store rendezvous env for ``torch.distributed``
(reference: ``runtime/PyTorchRuntime.java`` — ``buildTaskEnv``), the
port's copy of :mod:`tony_tpu.runtime.pytorch_runtime` with the CUDA
seams.

Exports ``MASTER_ADDR``/``MASTER_PORT`` (the global-rank-0 task's registered
host/port), ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``INIT_METHOD`` so
:func:`tony_tpu_torch.distributed.initialize` (or a plain
``init_process_group``) comes up with no code changes, and adds:

* **card pinning** — a task with ``tony.<jobtype>.gpus = g > 0`` sees
  exactly ``g`` cards of its host in ``CUDA_VISIBLE_DEVICES``, at the
  offset the JAX runtime uses for ``TPU_VISIBLE_DEVICES`` (the cumulative
  ask of the lower-ranked co-hosted tasks), taken through the host's own
  ``CUDA_VISIBLE_DEVICES`` where the host is restricted; ``TONY_TASK_GPUS
  = g`` says that TonY pinned it. Sidecars get nothing;
* the settings the JAX runtime exports and the port reads:
  ``TONY_CKPT_DIR/EVERY/KEEP``, ``TONY_PUBLISH_EVERY``,
  ``TONY_TRAIN_AOT_CACHE`` and ``TONY_DATA_SEED``, from the same keys with
  the same defaults;
* ``TORCH_NCCL_ASYNC_ERROR_HANDLING=1``, so a dead peer ends the gang
  instead of hanging it (``tony.<jobtype>.env`` overrides it).
"""

from __future__ import annotations

from typing import Dict

from tony_tpu_torch import conf as conf_mod
from tony_tpu_torch import constants
from tony_tpu_torch.runtime import Framework, TaskContext
from tony_tpu_torch.runtime.base import MLGenericTaskAdapter, card_env


class PyTorchTaskAdapter(MLGenericTaskAdapter):
    def framework_env(self, ctx: TaskContext) -> Dict[str, str]:
        if ctx.is_sidecar():
            # Sidecars never join the process group: no RANK/WORLD_SIZE, or
            # init_process_group would wait on a process that never arrives.
            return {}
        master = ctx.rank0_spec()
        host, _, port = master.rpartition(":")
        local_rank, _local_size = ctx.local_rank()
        env = {
            constants.ENV_MASTER_ADDR: host,
            constants.ENV_MASTER_PORT: port,
            constants.ENV_RANK: str(ctx.global_rank()),
            constants.ENV_WORLD_SIZE: str(ctx.num_cluster_tasks()),
            constants.ENV_LOCAL_RANK: str(local_rank),
            constants.ENV_INIT_METHOD: f"tcp://{master}",
        }
        env.update(card_env(ctx))
        if constants.ENV_NCCL_ASYNC_ERROR_HANDLING not in \
                ctx.conf.task_env(ctx.job_type):
            env[constants.ENV_NCCL_ASYNC_ERROR_HANDLING] = "1"
        # Checkpoint plane: the conf-configured durable dir + cadence, so
        # train_loop's save_every/restore defaults light up without script
        # changes (the executor's heartbeat reports the committed step back
        # from the same directory); publication rides the same wiring.
        ckpt_dir = ctx.conf.get(conf_mod.CKPT_DIR)
        if ckpt_dir:
            env[constants.ENV_CKPT_DIR] = ckpt_dir
            env[constants.ENV_CKPT_EVERY] = str(
                ctx.conf.get_int(conf_mod.CKPT_EVERY, 0))
            env[constants.ENV_CKPT_KEEP] = str(
                ctx.conf.get_int(conf_mod.CKPT_KEEP, 3))
            publish_every = ctx.conf.get_int(conf_mod.PUBLISH_EVERY, 0)
            if publish_every > 0:
                env[constants.ENV_PUBLISH_EVERY] = str(publish_every)
        train_aot = ctx.conf.get(conf_mod.TRAIN_AOT_CACHE)
        if train_aot:
            env[constants.ENV_TRAIN_AOT_CACHE] = train_aot
        # Input-data plane: every process — and every gang restart —
        # builds the identical example stream (Dataset's default seed).
        data_seed = ctx.conf.get(conf_mod.DATA_SEED)
        if data_seed is not None:
            env[constants.ENV_DATA_SEED] = str(data_seed)
        return env


class PyTorchFramework(Framework):
    name = "pytorch"

    def task_adapter(self) -> PyTorchTaskAdapter:
        return PyTorchTaskAdapter()
