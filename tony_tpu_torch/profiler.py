"""Collective records of the port: the counterpart of the unified
collective registry of :mod:`tony_tpu.profiler`.

One record per scheduled collective, keyed by tag (the last plan per tag
wins), under the reference's schema:

* ``kind`` — all_gather | psum_scatter | all_reduce | all_to_all | ppermute
* ``plane`` — fwd_gather | grad_reduce | moe | pipeline
* ``axes`` — the mesh axes the collective runs over
* ``nbytes`` — per-issue payload bytes (list)

The data-parallel train step records its bucketed gradient all-reduce
here, and :func:`tony_tpu_torch.train.train_stats_writer` sums the bytes
into each step's ``collective_bytes``.
"""

from __future__ import annotations

import copy
from typing import Dict

COLLECTIVE_RECORDS: Dict[str, Dict[str, object]] = {}


def record_collective(tag: str, /, **fields) -> None:
    """Bank one collective schedule record under the unified schema."""
    COLLECTIVE_RECORDS[tag] = dict(fields)


def collective_report() -> Dict[str, Dict[str, object]]:
    """A deep copy of every record: callers serialize or mutate the
    report without touching the live registry."""
    return {k: copy.deepcopy(v) for k, v in COLLECTIVE_RECORDS.items()}


def reset_collective_records() -> None:
    COLLECTIVE_RECORDS.clear()
