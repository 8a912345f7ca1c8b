"""The history plane's event-log reader: a copy of the read path of
:mod:`tony_tpu.events` (``SERVE_WINDOW``, :func:`read_events`,
:func:`list_jobs` and what they call), which the serve replica's
``warm()`` pad tuner reads.

The control plane writes one JSON-lines file per job under a history
root::

    <history>/intermediate/<appId>.jhist.inprogress   (while running)
    <history>/finished/<appId>.jhist                  (after completion)

whose first line is a metadata record and whose ``SERVE_WINDOW`` records
carry each serve task's per-heartbeat stats, the prompt-length histogram
among them. The writer stays in the control plane.
``tests/test_torch_purity.py`` holds this copy equal to the original.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

from tony_tpu_torch import constants

SERVE_WINDOW = "SERVE_WINDOW"

_METADATA = "METADATA"


# ---------------------------------------------------------------------------
# Read path
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
