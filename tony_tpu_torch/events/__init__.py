"""Lifecycle event log: the jhist write/read path — a copy of
:mod:`tony_tpu.events` (the port imports nothing of the JAX package).

Mirrors ``com.linkedin.tony.events`` (``EventHandler`` + the Avro ``Event``
schema under ``tony-core/src/main/avro/``, unverified — SURVEY.md §0/§3.5).
The serialization is JSON-lines and the store a plain directory tree::

    <history>/intermediate/<appId>.jhist.inprogress   (while running)
    <history>/finished/<appId>.jhist                  (after completion)

The first line of every jhist file is a metadata record (user, app name,
started timestamp, config snapshot). The port's AM writes APPLICATION_
INITED, TASK_STARTED, TASK_METRICS, ALL_TASKS_RUNNING, TASK_FINISHED,
APPLICATION_FINISHED, and the SERVE_WINDOW / TRAIN_STEP records of each
task's stats file; the serve replica's ``warm()`` pad tuner reads the
SERVE_WINDOW records back. The rest of the vocabulary (SCALE_DECISION,
RESIZE, PUBLISH, SWAP) is kept so a port log and a JAX log read the same;
the port's AM emits none of them yet. With ``max_bytes`` armed the
writer compacts through stage-and-rename. Standard library only.
``tests/test_torch_purity.py`` holds the names and the reader equal to
the original.
"""

from __future__ import annotations

import getpass
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

from tony_tpu_torch import chaos, constants

APPLICATION_INITED = "APPLICATION_INITED"
TASK_STARTED = "TASK_STARTED"
TASK_METRICS = "TASK_METRICS"
ALL_TASKS_RUNNING = "ALL_TASKS_RUNNING"
TASK_FINISHED = "TASK_FINISHED"
APPLICATION_FINISHED = "APPLICATION_FINISHED"
SERVE_WINDOW = "SERVE_WINDOW"
TRAIN_STEP = "TRAIN_STEP"
SCALE_DECISION = "SCALE_DECISION"
RESIZE = "RESIZE"
# Continuous weight publication (publish / serve.swap): one
# PUBLISH per new manifest pointer the train gang stages, one SWAP per
# replica the AM rolls onto it — together the timeline `tony history`
# reconstructs (which version, which step, who swapped when, how long
# each swap window lasted). Low-rate lifecycle records: NEVER rotation
# victims.
PUBLISH = "PUBLISH"
SWAP = "SWAP"

_METADATA = "METADATA"

# Record types a long run emits continuously (one per task heartbeat /
# train step): rotation's compaction victims. Lifecycle events,
# SCALE_DECISION (low-rate, replay-bearing) and RESIZE (a handful per
# job, the recovery timeline) always survive whole.
_HIGH_RATE = frozenset({TASK_METRICS, SERVE_WINDOW, TRAIN_STEP})


class EventHandler:
    """Append-only jhist writer owned by the AM (reference: ``EventHandler``
    producer thread; here writes are cheap enough to do inline under a lock)."""

    def __init__(self, history_dir: str | Path, app_id: str,
                 conf_snapshot: Optional[Dict[str, str]] = None,
                 app_name: str = "", max_bytes: int = 0):
        self.history_dir = Path(history_dir)
        self.app_id = app_id
        # Bounded rotation (0 = unbounded): past max_bytes the writer
        # COMPACTS in place through stage-and-rename (lifecycle events
        # whole, newest half of the high-rate tail) — a week-long serve
        # job's log stays a bounded file, never an unbounded append.
        self.max_bytes = int(max_bytes)
        self.rotations = 0
        self._lock = threading.Lock()
        inter = self.history_dir / constants.EVENTS_DIR_INTERMEDIATE
        inter.mkdir(parents=True, exist_ok=True)
        self.inprogress_path = inter / (
            app_id + constants.JHIST_INPROGRESS_SUFFIX)
        self.finished_path = (self.history_dir / constants.EVENTS_DIR_FINISHED
                              / (app_id + constants.JHIST_SUFFIX))
        self._file = open(self.inprogress_path, "a", encoding="utf-8")
        self._closed = False
        self._write({
            "type": _METADATA,
            "timestamp": time.time(),
            "payload": {
                "app_id": app_id,
                "app_name": app_name,
                "user": getpass.getuser(),
                "started": time.time(),
                "config": dict(conf_snapshot or {}),
            },
        })

    def _write(self, record: Dict[str, Any]) -> None:
        with self._lock:
            if self._closed:
                return
            self._file.write(json.dumps(record, sort_keys=True) + "\n")
            self._file.flush()
            if self.max_bytes and self._file.tell() > self.max_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Compact the inprogress file past ``max_bytes`` (caller holds
        the lock): keep the metadata line, every lifecycle/scale record,
        and the newest half of the high-rate tail, staged to a sibling
        tmp and ``os.replace``d over the live path — the ckpt plane's
        atomic stage-and-rename idiom, so a concurrent reader sees the
        old file or the compacted one, never a torn half."""
        self._file.close()
        try:
            records = _parse_file(self.inprogress_path)
        except (OSError, ValueError):
            # Unreadable under external interference: keep appending —
            # rotation is a bound, never a reason to lose the log.
            self._file = open(self.inprogress_path, "a", encoding="utf-8")
            return
        keep = [r for r in records if r.get("type") not in _HIGH_RATE]
        high = [r for r in records if r.get("type") in _HIGH_RATE]
        keep += high[len(high) // 2:]
        keep.sort(key=lambda r: r.get("timestamp", 0.0))
        # Chaos crash sites (tony_tpu.chaos): a kill -9 anywhere in the
        # stage-and-rename must leave the OLD log (before the replace)
        # or the NEW compacted one (after) — never a torn file. The
        # fault-injection sweep pins all three boundaries.
        chaos.crash_point("rotate_before_stage")
        tmp = Path(f"{self.inprogress_path}.tmp.{os.getpid()}")
        with open(tmp, "w", encoding="utf-8") as fh:
            for r in keep:
                fh.write(json.dumps(r, sort_keys=True) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        chaos.crash_point("rotate_after_stage")
        os.replace(tmp, self.inprogress_path)
        chaos.crash_point("rotate_after_replace")
        self._file = open(self.inprogress_path, "a", encoding="utf-8")
        self.rotations += 1

    def emit(self, event_type: str, **payload: Any) -> None:
        self._write({"type": event_type, "timestamp": time.time(),
                     "payload": payload})

    # -- convenience emitters matching the reference's event vocabulary ----
    def application_inited(self, attempt_id: int, num_tasks: int) -> None:
        self.emit(APPLICATION_INITED, attempt_id=attempt_id,
                  num_tasks=num_tasks)

    def task_started(self, job_type: str, index: int, host: str) -> None:
        self.emit(TASK_STARTED, job_type=job_type, index=index, host=host)

    def task_metrics(self, job_type: str, index: int,
                     metrics: Dict[str, float]) -> None:
        """One TaskMonitor sample — the per-task metrics *timeline* the
        portal renders (reference: MetricsRpc history, not just the final
        snapshot in TASK_FINISHED)."""
        self.emit(TASK_METRICS, job_type=job_type, index=index,
                  metrics=dict(metrics))

    def all_running(self, attempt_id: int,
                    submit_to_running_s: Optional[float] = None) -> None:
        """Gang barrier passed: every task is RUNNING. Carries the
        submit→all-RUNNING latency when the client shipped its submit
        timestamp (BASELINE.md secondary metric)."""
        self.emit(ALL_TASKS_RUNNING, attempt_id=attempt_id,
                  submit_to_running_s=submit_to_running_s)

    def task_finished(self, job_type: str, index: int, status: str,
                      exit_code: Optional[int], diagnostics: str = "",
                      metrics: Optional[Dict[str, float]] = None) -> None:
        self.emit(TASK_FINISHED, job_type=job_type, index=index,
                  status=status, exit_code=exit_code,
                  diagnostics=diagnostics, metrics=metrics or {})

    def application_finished(self, status: str, message: str = "") -> None:
        self.emit(APPLICATION_FINISHED, status=status, message=message)

    # -- the load-bearing serve/train/scale records ------------------------
    def serve_window(self, job_type: str, index: int,
                     stats: Dict[str, Any]) -> None:
        """One per-heartbeat serve stats window for one task — the
        ALREADY-normalized heartbeat dict (session.Task.serve_metrics),
        verbatim: the log is a recording of the schema the fleet
        already speaks, never a second bookkeeping path."""
        self.emit(SERVE_WINDOW, job_type=job_type, index=index,
                  stats=dict(stats))

    def train_step(self, job_type: str, index: int, step: int,
                   step_time_s: float, collective_bytes: float = 0.0,
                   mfu: float = 0.0) -> None:
        """One training step's cost triple: wall time, collective bytes
        (``profiler.collective_report()``'s total for the step plane),
        and the caller's MFU estimate — the portal's per-step trend
        across BENCH rounds."""
        self.emit(TRAIN_STEP, job_type=job_type, index=index,
                  step=int(step), step_time_s=float(step_time_s),
                  collective_bytes=float(collective_bytes),
                  mfu=float(mfu))

    def scale_decision(self, job_type: str, delta: int, n_active: int,
                       samples: List[Dict[str, Any]], now: float,
                       last_action: Optional[float],
                       policy: Dict[str, Any]) -> None:
        """A SELF-VERIFYING autoscale record: everything
        ``scaling.decide`` consumed (policy fields, active count,
        samples, clock, last action) plus the delta the live AM took —
        ``scaling.replay_decisions`` recomputes the decision from these
        fields and must reproduce it exactly."""
        self.emit(SCALE_DECISION, job_type=job_type, delta=int(delta),
                  n_active=int(n_active),
                  samples=[dict(s) for s in samples], now=float(now),
                  last_action=last_action, policy=dict(policy))

    def resize(self, phase: str, trigger: str, job_type: str,
               old_workers: int, new_workers: int, wall_s: float,
               ok: bool, detail: str = "") -> None:
        """One resize-phase record (tony_tpu.am.resize): the phase name
        (DRAINING / RE-GANG / RESTORING, or DEGRADED when the machine
        fell back to the full gang restart), what triggered the resize,
        the old→new topology, and the phase's wall seconds — `tony
        history` renders these as the recovery timeline."""
        self.emit(RESIZE, phase=str(phase), trigger=str(trigger),
                  job_type=job_type, old_workers=int(old_workers),
                  new_workers=int(new_workers), wall_s=float(wall_s),
                  ok=bool(ok), detail=detail)

    def publish(self, version: int, step: int, note: str = "") -> None:
        """One new weight publication became the fleet's swap target
        (tony_tpu.publish): the version the pointer file minted and the
        committed checkpoint step it names. Emitted by the AM when its
        publication tick first observes the version — exactly once per
        version, however many heartbeats carry it."""
        self.emit(PUBLISH, version=int(version), step=int(step),
                  note=str(note))

    def swap(self, job_type: str, index: int, from_version: int,
             to_version: int, step: int, wall_s: float, ok: bool,
             detail: str = "") -> None:
        """One replica's hot-swap outcome (tony_tpu.serve.swap): which
        versions it rolled between, the step restored, and the wall
        seconds of the whole window (restore + quiesce + flip) — the
        number ROOFLINE §16's swap-window model predicts. ok=False
        records a rolled-back attempt: the replica kept serving
        from_version."""
        self.emit(SWAP, job_type=job_type, index=int(index),
                  from_version=int(from_version),
                  to_version=int(to_version), step=int(step),
                  wall_s=float(wall_s), ok=bool(ok), detail=detail)

    def close(self) -> None:
        """Finalize: move intermediate → finished (the reference's HDFS
        rename on job completion)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._file.close()
        self.finished_path.parent.mkdir(parents=True, exist_ok=True)
        os.replace(self.inprogress_path, self.finished_path)


# ---------------------------------------------------------------------------
# Read path (consumed by the history server and by tests)
# ---------------------------------------------------------------------------

# Parse cache keyed by (mtime_ns, size): finished jhists are immutable and
# in-progress ones only append, so an unchanged stat means an unchanged
# parse. The reference keeps an in-memory cache with a refresh thread in the
# history server (SURVEY.md §3.5); stat-on-read gives the same zero-reparse
# behavior without a thread, and TASK_METRICS growth (one record per task
# per 5s) makes re-parsing per page hit O(job runtime) without it.
_CACHE_MAX_FILES = 512
_parse_cache: Dict[str, tuple] = {}   # path -> (mtime_ns, size, records)
_meta_cache: Dict[str, tuple] = {}    # path -> (mtime_ns, metadata)
_parse_cache_lock = threading.Lock()


def _parse_file(path: str | Path) -> List[Dict[str, Any]]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _finished_sibling(path: str | Path) -> Optional[Path]:
    """The finished-dir path an intermediate jhist lands at when
    ``EventHandler.close()`` renames it — the retry target for the
    scan-vs-close race. None for paths that are not intermediates."""
    p = Path(path)
    if not p.name.endswith(constants.JHIST_INPROGRESS_SUFFIX):
        return None
    app_id = p.name[:-len(constants.JHIST_INPROGRESS_SUFFIX)]
    return (p.parent.parent / constants.EVENTS_DIR_FINISHED
            / (app_id + constants.JHIST_SUFFIX))


def read_events(path: str | Path) -> List[Dict[str, Any]]:
    """Parse one jhist (or .inprogress) file into its event records.
    Cached on (mtime, size); callers must not mutate the returned
    records. An intermediate path that vanished underneath us — the
    ``list_jobs`` scan racing ``EventHandler.close()``'s rename —
    retries at the finished path instead of raising: the records exist,
    they just moved."""
    key = str(path)
    try:
        st = os.stat(path)
    except OSError:
        # e.g. intermediate→finished rename raced the scan; no stale cache.
        with _parse_cache_lock:
            _parse_cache.pop(key, None)
        fin = _finished_sibling(path)
        if fin is not None and fin.exists():
            return read_events(fin)
        raise
    with _parse_cache_lock:
        hit = _parse_cache.get(key)
        if hit is not None and hit[0] == st.st_mtime_ns and hit[1] == st.st_size:
            # Shallow copy: the list is the mutation surface callers
            # actually touch (sort/filter/append); handing out the cached
            # list itself would let one caller poison every later read.
            return list(hit[2])
    try:
        records = _parse_file(path)
    except OSError:
        # stat won the race, open lost it: same rename, same retry.
        with _parse_cache_lock:
            _parse_cache.pop(key, None)
        fin = _finished_sibling(path)
        if fin is not None and fin.exists():
            return read_events(fin)
        raise
    with _parse_cache_lock:
        if len(_parse_cache) >= _CACHE_MAX_FILES:
            # Drop the oldest insertion — plain dicts iterate in insertion
            # order; good enough for a bound, no LRU bookkeeping needed.
            _parse_cache.pop(next(iter(_parse_cache)))
        _parse_cache[key] = (st.st_mtime_ns, st.st_size, records)
    return list(records)


def job_metadata(path: str | Path) -> Dict[str, Any]:
    """The metadata record (first line) of a jhist file. Served from the
    parse cache when the file is already cached; reads only the first line
    otherwise (the list page must not force full parses of every job)."""
    key = str(path)
    try:
        st = os.stat(path)
    except OSError:
        st = None
    if st is not None:
        with _parse_cache_lock:
            hit = _parse_cache.get(key)
            if hit is not None and hit[0] == st.st_mtime_ns \
                    and hit[1] == st.st_size:
                recs = hit[2]
                if recs and recs[0].get("type") == _METADATA:
                    return recs[0].get("payload", {})
                return {}
    if st is not None:
        with _parse_cache_lock:
            hit = _meta_cache.get(key)
            if hit is not None and hit[0] == st.st_mtime_ns:
                return hit[1]
    try:
        with open(path, encoding="utf-8") as f:
            first = f.readline().strip()
    except OSError:
        # Same scan-vs-close rename race as read_events: the metadata
        # line moved with the file — follow it.
        fin = _finished_sibling(path)
        if fin is not None and fin.exists():
            return job_metadata(fin)
        raise
    rec = json.loads(first) if first else {}
    meta = rec.get("payload", {}) if rec.get("type") == _METADATA else {}
    if st is not None:
        with _parse_cache_lock:
            if len(_meta_cache) >= _CACHE_MAX_FILES:
                _meta_cache.pop(next(iter(_meta_cache)))
            # mtime alone suffices: the metadata line is written once at
            # file creation and never rewritten.
            _meta_cache[key] = (st.st_mtime_ns, meta)
    return meta


def list_jobs(history_dir: str | Path) -> Iterator[Dict[str, Any]]:
    """All jobs under a history root, finished first then in-progress —
    the history server's scan (reference: HDFS scan in ParserUtils)."""
    root = Path(history_dir)
    for sub, suffix, state in (
            (constants.EVENTS_DIR_FINISHED, constants.JHIST_SUFFIX, "finished"),
            (constants.EVENTS_DIR_INTERMEDIATE,
             constants.JHIST_INPROGRESS_SUFFIX, "running")):
        d = root / sub
        if not d.is_dir():
            continue
        for p in sorted(d.iterdir()):
            if not p.name.endswith(suffix):
                continue
            app_id = p.name[:-len(suffix)]
            meta = job_metadata(p)
            yield {"app_id": app_id, "state": state, "path": str(p),
                   "metadata": meta}
