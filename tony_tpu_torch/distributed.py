"""Rendezvous for port jobs launched by TonY: the counterpart of
:mod:`tony_tpu.distributed`, fed by the PyTorchRuntime env
(``--framework pytorch`` exports ``MASTER_ADDR``/``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``INIT_METHOD``) instead of
the JAX coordinator triple. A user script calls::

    from tony_tpu_torch import distributed as dist
    dist.initialize()          # False outside a TonY job or for 1 process

which brings up ``torch.distributed``'s default process group: NCCL with
this task's card ``cuda:{LOCAL_RANK}`` pinned, or gloo for
``device="cpu"``. ``device=None`` means the card, and raises without a
GPU: a job never falls back to gloo or the CPU on its own.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as td

from tony_tpu_torch import constants, resolve_device


def env_spec() -> Optional[Tuple[str, int, int, int]]:
    """``(init_method, world_size, rank, local_rank)`` from the executor
    env, or None when not running under TonY. ``INIT_METHOD`` wins; else
    ``tcp://MASTER_ADDR:MASTER_PORT``."""
    world = os.environ.get(constants.ENV_WORLD_SIZE)
    rank = os.environ.get(constants.ENV_RANK)
    init = os.environ.get(constants.ENV_INIT_METHOD)
    if not init:
        addr = os.environ.get(constants.ENV_MASTER_ADDR)
        port = os.environ.get(constants.ENV_MASTER_PORT)
        init = f"tcp://{addr}:{port}" if addr and port else None
    if not init or world is None or rank is None:
        return None
    local = os.environ.get(constants.ENV_LOCAL_RANK) or "0"
    return init, int(world), int(rank), int(local)


def initialize(device: Optional[Union[str, torch.device]] = None) -> bool:
    """Join the job's process group from the TonY env. Returns True when a
    multi-process group came up, False outside a TonY job or for one
    process (as the reference). The device is resolved first, so
    ``device=None`` raises without a GPU even where no group is formed."""
    dev = resolve_device(device)
    spec = env_spec()
    if spec is None:
        return False
    init, world, rank, local = spec
    if world <= 1:
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    td.init_process_group(backend, init_method=init, rank=rank,
                          world_size=world)
    return True


def process_id() -> int:
    spec = env_spec()
    return spec[2] if spec else 0


def num_processes() -> int:
    spec = env_spec()
    return spec[1] if spec else 1
