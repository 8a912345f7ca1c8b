"""Gang-identity input sharding: which slice of every global batch is MINE
(a copy of :mod:`tony_tpu.data.sharding`).

The reference leaves input sharding to user scripts (each worker builds its
own ``tf.data`` pipeline from ``TASK_INDEX`` by hand — SURVEY.md §1 L7);
TF-Replicator's lesson (PAPERS 1902.00465) is that the framework must own
this or determinism and resume semantics become every user's bug. A
:class:`ShardSpec` is derived once from the executor env the runtimes
already export and threaded through the data plane:

* the **global** example stream (order, shuffling, batching) is computed
  identically on every host from the seed + iterator state alone — no
  host-count dependence anywhere in the index math;
* the ShardSpec then selects this host's CONTIGUOUS block of each global
  batch (block h of ``world_size`` equal blocks); under data parallelism
  each rank trains on its block, and the global batch — and therefore
  the training trajectory — is identical for ANY (host-count, shard)
  layout over the same world. That invariance is what
  makes elastic restore across a changed host count exact rather than
  approximate.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, TypeVar

from tony_tpu_torch import constants

_T = TypeVar("_T")


@dataclass(frozen=True)
class ShardSpec:
    """This process's position in the input gang: ``task_index`` of
    ``world_size``. Standalone (no TonY env) is ``ShardSpec(0, 1)``."""

    task_index: int = 0
    world_size: int = 1

    def __post_init__(self) -> None:
        if self.world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {self.world_size}")
        if not 0 <= self.task_index < self.world_size:
            raise ValueError(
                f"task_index {self.task_index} out of range for "
                f"world_size {self.world_size}")

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "ShardSpec":
        """Derive the shard from the executor env. The JAX rendezvous pair
        (``TONY_PROCESS_ID``/``TONY_NUM_PROCESSES``, exported by the
        JAXRuntime) wins over the generic executor pair
        (``TONY_TASK_INDEX``/``TONY_NUM_TASKS``): the rendezvous index is
        the GLOBAL rank across job types, which is what ``global_batch``'s
        process ordering uses — the per-jobtype task index only coincides
        with it in single-jobtype gangs. No env at all → standalone."""
        env = os.environ if env is None else env
        for idx_key, n_key in (
                (constants.ENV_PROCESS_ID, constants.ENV_NUM_PROCESSES),
                (constants.ENV_TASK_INDEX, constants.ENV_TASK_NUM)):
            idx, n = env.get(idx_key), env.get(n_key)
            if idx is not None and n is not None:
                return cls(int(idx), int(n))
        return cls(0, 1)

    def local_count(self, global_batch: int) -> int:
        """Examples of each global batch this host materializes."""
        if global_batch % self.world_size:
            raise ValueError(
                f"global batch {global_batch} not divisible by "
                f"world_size {self.world_size}")
        return global_batch // self.world_size

    def local_slice(self, global_batch: int) -> slice:
        """This host's contiguous block of a ``global_batch``-sized id
        vector — block ``task_index`` of ``world_size`` equal blocks, so
        concatenating the blocks in task order reproduces the global
        batch (the ``make_array_from_process_local_data`` contract)."""
        local = self.local_count(global_batch)
        return slice(self.task_index * local, (self.task_index + 1) * local)

    def shard_files(self, files: Sequence[_T], *,
                    pad: bool = False) -> List[_T]:
        """Static per-host FILE assignment (round-robin) for pipelines that
        shard at file granularity instead of example granularity — e.g.
        feeding :class:`~tony_tpu_torch.data.pipeline.FileListSource` a per-host
        subset. Note this trades away host-count elasticity: a file-sharded
        stream is only reproducible across runs with the SAME world size
        (example-granularity sharding — the default — has no such caveat).

        A file count that does not divide ``world_size`` is rejected:
        hosts would build sources of DIFFERENT lengths, so the gang
        desyncs at epoch end (the short host raises ``StopIteration``
        while the rest block in the collective) and the single saved
        gang cursor fails every other host's ``restore()`` source-length
        pin. ``pad=True`` wrap-pads the assignment with files from the
        front of the list to equal per-host counts (duplicating up to
        ``world_size - 1`` files per epoch) instead of raising.
        """
        files = list(files)
        short = (-len(files)) % self.world_size
        if short:
            if not pad:
                raise ValueError(
                    f"{len(files)} files not divisible by world_size "
                    f"{self.world_size}: hosts would see different source "
                    f"lengths, breaking gang epoch sync and checkpoint "
                    f"resume — drop the remainder, or pass pad=True to "
                    f"wrap-pad to equal per-host counts")
            files = files + files[:short]
        return files[self.task_index::self.world_size]
