"""Records of the port: the counterparts of the collective, checkpoint
and input registries of :mod:`tony_tpu.profiler`, each keyed by tag (the
last record per tag wins) and read back as a deep copy.

Collectives: one record per scheduled collective, under the reference's
schema:

* ``kind`` — all_gather | psum_scatter | all_reduce | all_to_all | ppermute
* ``plane`` — fwd_gather | grad_reduce | moe | pipeline
* ``axes`` — the mesh axes the collective runs over
* ``nbytes`` — per-issue payload bytes (list)

The data-parallel train step records its bucketed gradient all-reduce
here, and :func:`tony_tpu_torch.train.train_stats_writer` sums the bytes
into each step's ``collective_bytes``.

Checkpoints (:func:`record_ckpt`): the async checkpointer records each
save — the stall the train loop paid, the device→host extract, the
background write and commit, payload bytes and chunk count. Input
(:func:`record_input`): the prefetching device iterator records, per
delivered batch, the time the loop blocked on the feed. Serving
(:func:`record_serve`): the engine banks its geometry under its tag and
each :meth:`~tony_tpu_torch.serve.engine.ServeEngine.stats` reading
under ``"<tag>_stats"``, the latter through :func:`safe_record`, which
never sinks a request.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict

COLLECTIVE_RECORDS: Dict[str, Dict[str, object]] = {}
CKPT_RECORDS: Dict[str, Dict[str, object]] = {}
INPUT_RECORDS: Dict[str, Dict[str, object]] = {}
SERVE_RECORDS: Dict[str, Dict[str, object]] = {}


def _snapshot(store: Dict[str, Dict[str, object]]
              ) -> Dict[str, Dict[str, object]]:
    """A deep copy of every record: callers serialize or mutate a report
    without touching the live registry."""
    return {k: copy.deepcopy(v) for k, v in store.items()}


def record_collective(tag: str, /, **fields) -> None:
    """Bank one collective schedule record under the unified schema."""
    COLLECTIVE_RECORDS[tag] = dict(fields)


def collective_report() -> Dict[str, Dict[str, object]]:
    return _snapshot(COLLECTIVE_RECORDS)


def reset_collective_records() -> None:
    COLLECTIVE_RECORDS.clear()


def record_ckpt(tag: str, **fields) -> None:
    """Bank one checkpoint-save record (stall/extract/write seconds,
    payload bytes, chunk count...)."""
    CKPT_RECORDS[tag] = dict(fields)


def ckpt_report() -> Dict[str, Dict[str, object]]:
    return _snapshot(CKPT_RECORDS)


def reset_ckpt_records() -> None:
    CKPT_RECORDS.clear()


def record_input(tag: str, **fields) -> None:
    """Bank one input-feed record (prefetch depth, steps, last/total wait
    seconds, mean wait/placement ms...)."""
    INPUT_RECORDS[tag] = dict(fields)


def input_report() -> Dict[str, Dict[str, object]]:
    return _snapshot(INPUT_RECORDS)


def reset_input_records() -> None:
    INPUT_RECORDS.clear()


def record_serve(tag: str, /, **fields) -> None:
    """Bank one serving-plane record (engine geometry, qps/p50/p99/
    queue-depth telemetry, replica restore geometry...)."""
    SERVE_RECORDS[tag] = dict(fields)


def serve_report() -> Dict[str, Dict[str, object]]:
    return _snapshot(SERVE_RECORDS)


def reset_serve_records() -> None:
    SERVE_RECORDS.clear()


_log = logging.getLogger(__name__)


def safe_record(tag: str, /, **fields) -> None:
    """:func:`record_serve`, swallowing any failure: bookkeeping must
    never sink a request. The engine's heartbeat reading records through
    it; a failure is logged at DEBUG."""
    try:
        record_serve(tag, **fields)
    except Exception:  # noqa: BLE001
        _log.debug("serve profiler record %r failed", tag, exc_info=True)
