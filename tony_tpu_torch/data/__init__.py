"""Deterministic sharded input-data plane: the counterpart of
:mod:`tony_tpu.data`.

* **deterministic sharding** (:mod:`~tony_tpu_torch.data.sharding`) — a
  :class:`ShardSpec` from the executor's gang identity; all index math is
  global and the shard selects a contiguous block of each global batch,
  so any (host-count, shard) layout yields the same global example order;
* **a composable pipeline** (:mod:`~tony_tpu_torch.data.pipeline`) —
  array/memmap/file :class:`Source`\\ s → shuffle (per-epoch Philox
  permutation or counter-based shuffle buffer) → repeat → batch → map,
  with the whole cursor exposed as a small JSON-able ``state()``; the
  Philox streams are numpy's, so the example-id stream equals the
  reference's;
* **double-buffered device prefetch** (:mod:`~tony_tpu_torch.data.prefetch`)
  — a background thread stages the next batches host→device through
  pinned memory and a side stream; the stall the step still pays is
  recorded per step in :func:`tony_tpu_torch.profiler.input_report`;
* **checkpointable iterator state** (:mod:`~tony_tpu_torch.data.ckptio`) —
  the cursor rides the checkpoint manifest in the same atomic commit as
  the train state (``train_loop(data=...)``), and restores across a
  changed host count.
"""

from __future__ import annotations

from tony_tpu_torch.data.ckptio import (DATA_ITER_KEY, MODEL_KEY,
                                        decode_state, encode_state,
                                        has_iter_state, load_iter_state,
                                        wrap_for_save)
from tony_tpu_torch.data.pipeline import (ArraySource, Dataset,
                                          FileListSource, MemmapSource,
                                          PipelineIterator, Source)
from tony_tpu_torch.data.prefetch import DeviceIterator
from tony_tpu_torch.data.sharding import ShardSpec

__all__ = [
    "ArraySource", "DATA_ITER_KEY", "Dataset", "DeviceIterator",
    "FileListSource", "MODEL_KEY", "MemmapSource", "PipelineIterator",
    "ShardSpec", "Source", "decode_state", "encode_state", "has_iter_state",
    "load_iter_state", "wrap_for_save",
]
