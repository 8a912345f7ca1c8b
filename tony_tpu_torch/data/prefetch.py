"""Double-buffered device prefetch: the host→device feed off the step path
(the counterpart of :mod:`tony_tpu.data.prefetch`).

A daemon thread runs the host pipeline (fetch + map) and stages the next
``depth`` batches onto the rank's device via
:func:`tony_tpu_torch.train.global_batch`, so ``next()`` in the train
loop returns a device-resident batch immediately whenever the producer
is keeping up. On the card each host batch is staged in pinned memory and
copied host→device on a side stream; the consumer's stream waits on that
copy's event (and the batch's memory is marked as used by it), so the
copy overlaps the step without a host synchronisation. The time
``next()`` DOES block — the input stall the step actually pays — is
recorded per step in :func:`tony_tpu_torch.profiler.input_report`.

Checkpoint correctness under prefetch: each staged batch carries the
pipeline state taken AFTER producing it; :meth:`DeviceIterator.state`
returns the state of the last batch DELIVERED to the caller, never the
producer's read-ahead position — a checkpoint taken between steps resumes
exactly at the next undelivered example, regardless of depth.

Thread hygiene: the producer is daemon AND joined — daemon so an abandoned iterator can
never pin the interpreter, joined (``close()``, bounded) so the normal
teardown path is deterministic rather than relying on interpreter exit;
the weakref dance below covers the abandoned case in between.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from tony_tpu_torch import profiler
from tony_tpu_torch.data.pipeline import PipelineIterator


class _Stop:
    """End-of-stream sentinel (a class, not object(): survives queue
    identity checks across threads unambiguously)."""


def _q_put(q: "queue.Queue", stop: threading.Event,
           ref: "weakref.ref", item: Any) -> bool:
    """Put that keeps polling ``stop`` AND the iterator's liveness: a
    producer parked on a full queue must exit both on close() and when
    the consumer dropped the iterator without closing it."""
    while not stop.is_set():
        if ref() is None:
            return False
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _producer(ref: "weakref.ref", q: "queue.Queue",
              stop: threading.Event) -> None:
    """Prefetch loop, deliberately a module function over a WEAK
    reference: a bound-method target would make the running thread a GC
    root for the iterator, so a DeviceIterator dropped without close()
    could never be collected and its producer would spin for the process
    lifetime. Holding the iterator only within one loop iteration —
    never across a blocking put — lets the drop be observed and the
    thread exit within one put timeout."""
    while True:
        it = ref()
        if it is None or stop.is_set():
            return
        try:
            try:
                batch = it._next_host_batch()
            except StopIteration:
                del it
                break
            item = (batch, it._it.state())
        except BaseException as e:  # noqa: BLE001 — surfaced on next()
            it._err = e
            del it
            break
        del it, batch
        if not _q_put(q, stop, ref, item):
            return
        del item
    _q_put(q, stop, ref, _Stop)


class _OnSide:
    """A batch placed on a side stream: ``event`` marks its copy."""

    def __init__(self, batch: Any, tensors: List[torch.Tensor],
                 event: Any, device: torch.device):
        self.batch, self.tensors, self.event = batch, tensors, event
        self.device = device

    def take(self) -> Any:
        """The batch, ordered after its copy on the current stream."""
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(self.event)
        for t in self.tensors:
            t.record_stream(cur)
        return self.batch


class DeviceIterator:
    """Prefetching device-placement wrapper over a
    :class:`~tony_tpu_torch.data.pipeline.PipelineIterator`.

    * ``depth >= 1``: a background thread fetches, maps, and stages the
      next ``depth`` batches host→device; ``next()`` only blocks when the
      producer falls behind (the measured input stall).
    * ``depth == 0``: fully synchronous — the comparison leg the input
      bench measures the stall of.
    * ``mesh=None``: batches stay host-side (numpy); with a mesh each
      batch becomes this rank's tensors on the mesh's device via
      :func:`tony_tpu_torch.train.global_batch` (every rank contributing
      its ShardSpec block), through pinned memory and a side stream on
      the card. On a CPU mesh nothing is pinned.
    """

    def __init__(self, it: PipelineIterator, mesh=None, *, depth: int = 2,
                 seq_axis: Optional[bool] = None, tag: str = "input"):
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self._it = it
        self._mesh = mesh
        self.depth = depth
        self._seq_axis = seq_axis
        self._tag = tag
        # depth 0 never runs ahead of the consumer, so state() reads the
        # pipeline lazily instead of materializing the cursor (a full
        # shuffle-buffer copy) on every synchronous next(); depth >= 1
        # tracks the last-DELIVERED state eagerly because the producer
        # thread owns (and advances) the pipeline.
        self._state: Optional[Dict[str, Any]] = it.state() if depth else None
        self._started = False
        self._closed = False
        self._placed_once = False
        self._err: Optional[BaseException] = None
        # Running totals, not per-step lists: bookkeeping on the step path
        # must stay O(1) in steps for million-step runs.
        self.stats: Dict[str, Any] = {"steps": 0, "wait_s_last": 0.0,
                                      "wait_s_total": 0.0, "place_n": 0,
                                      "place_s_total": 0.0}
        self._pending: Optional[Any] = None
        self._side: Optional[Any] = None
        if depth > 0:
            self._q: "queue.Queue" = queue.Queue(maxsize=depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=_producer,
                args=(weakref.ref(self), self._q, self._stop),
                daemon=True, name="tony-data-prefetch")

    # -- producer side -----------------------------------------------------
    def _place(self, batch: Mapping[str, Any]) -> Any:
        t0 = time.perf_counter()
        if self._mesh is not None:
            from tony_tpu_torch import train
            # The shape contract is invariant per pipeline: pre-flight it
            # (leaf-naming ValueError) on the first batch only, then skip
            # the per-step re-validation on the feed path.
            check = not self._placed_once
            device = self._mesh.device
            if device.type == "cuda":
                if self._side is None:
                    self._side = torch.cuda.Stream(device)
                host = {k: torch.from_numpy(np.ascontiguousarray(v))
                        .pin_memory() for k, v in dict(batch).items()}
                with torch.cuda.stream(self._side):
                    placed = train.global_batch(self._mesh, host,
                                                seq_axis=self._seq_axis,
                                                check=check)
                    event = torch.cuda.Event()
                    event.record(self._side)
                batch = _OnSide(placed, list(placed.values()), event,
                                device)
            else:
                batch = train.global_batch(self._mesh, dict(batch),
                                           seq_axis=self._seq_axis,
                                           check=check)
            self._placed_once = True
        self.stats["place_n"] += 1
        self.stats["place_s_total"] += time.perf_counter() - t0
        return batch

    def _next_host_batch(self) -> Any:
        return self._place(next(self._it))

    # -- consumer side -----------------------------------------------------
    def __iter__(self) -> "DeviceIterator":
        return self

    def __next__(self) -> Any:
        if self._closed:
            raise RuntimeError("DeviceIterator is closed")
        t0 = time.perf_counter()
        if self.depth == 0:
            # A _place() failure (transient device transfer error) keeps
            # the already-pulled batch pending, so a caught-and-retried
            # next() re-places the SAME batch — the synchronous twin of
            # the pipeline's cursor rollback, for the stage past the
            # cursor's reach.
            if self._pending is None:
                self._pending = next(self._it)
            placed = self._place(self._pending)
            self._pending = None
            if isinstance(placed, _OnSide):
                placed = placed.take()
        else:
            if not self._started:
                self._started = True
                self._thread.start()
            item = self._q.get()
            if item is _Stop:
                # Leave a sentinel behind: repeated next() after
                # exhaustion must keep raising, not deadlock on get().
                self._q.put(_Stop)
                if self._err is not None:
                    # Stays latched: every subsequent next() must keep
                    # raising, or a caught-and-retried error turns into a
                    # clean StopIteration and the run silently truncates.
                    raise RuntimeError("data prefetch thread failed") \
                        from self._err
                raise StopIteration
            placed, self._state = item
        if isinstance(placed, _OnSide):
            placed = placed.take()
        wait_s = time.perf_counter() - t0
        self.stats["steps"] += 1
        self.stats["wait_s_last"] = wait_s
        self.stats["wait_s_total"] += wait_s
        profiler.record_input(
            self._tag, depth=self.depth, steps=self.stats["steps"],
            wait_s_last=wait_s,
            wait_s_total=float(self.stats["wait_s_total"]),
            wait_ms_mean=1e3 * self.stats["wait_s_total"]
            / self.stats["steps"],
            place_ms_mean=1e3 * self.stats["place_s_total"]
            / max(1, self.stats["place_n"]))
        return placed

    # -- checkpointable state ----------------------------------------------
    def state(self) -> Dict[str, Any]:
        """Pipeline cursor as of the last batch DELIVERED through
        ``next()`` (prefetched-but-undelivered batches are not consumed:
        a resume from this state replays them)."""
        if self.depth == 0:
            # A place-failed batch left pending was pulled but never
            # delivered — its pre-pull cursor is the delivered position.
            if self._pending is not None:
                return self._it.state_before_last()
            return self._it.state()
        return dict(self._state)

    def restore(self, state: Mapping[str, Any]) -> None:
        """Restore the underlying pipeline. Must happen before the first
        ``next()`` — the producer thread latches the cursor once started."""
        if self._started or self.stats["steps"]:
            raise RuntimeError(
                "DeviceIterator.restore() after iteration started: the "
                "prefetch thread has already advanced the pipeline")
        # A depth-0 next() that failed in _place() leaves its batch
        # pending for retry; that batch predates the restored cursor and
        # must not be delivered against it.
        self._pending = None
        self._it.restore(state)
        if self.depth:
            self._state = self._it.state()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.depth > 0 and self._started:
            self._stop.set()
            # Unblock a producer parked on a full queue.
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=30.0)

    def __enter__(self) -> "DeviceIterator":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()
