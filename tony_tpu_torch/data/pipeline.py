"""Composable deterministic pipeline: sources → shuffle/repeat/batch/map
(a copy of :mod:`tony_tpu.data.pipeline`: the same Philox streams, so the
port's example-id stream equals the reference's).

Design rules that everything here follows:

* **All index math is global.** The iterator computes the global id stream
  (epoch orders, shuffle-buffer draws, batch boundaries) identically on
  every host; the :class:`~tony_tpu.data.sharding.ShardSpec` only selects
  which contiguous block of each global batch this host fetches. Any
  (host-count, shard) layout therefore yields the same global example
  order — the invariant the elastic-resume pin tests.
* **Counter-based RNG only.** Epoch orders come from
  ``Philox(key=(seed, epoch))`` permutations and shuffle-buffer draws from
  ``Philox(key=(seed', draw_counter))`` — both regenerable from a handful
  of integers, so :meth:`PipelineIterator.state` is a small JSON-able dict
  (epoch, cursor, draw counter, buffered ids), not a pickled generator.
* **Stages expose state()/restore().** The whole pipeline's cursor rides
  checkpoint manifest next to the train state
  (:mod:`tony_tpu_torch.data.ckptio`), so an interrupted run's example stream is
  element-identical to an uninterrupted one — including across a changed
  host count.

Sources hand back host numpy batches; device placement (and the prefetch
thread that hides it) lives in :mod:`tony_tpu_torch.data.prefetch`.
"""

from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Union)

import numpy as np

from tony_tpu_torch import constants
from tony_tpu_torch.data.sharding import ShardSpec

STATE_VERSION = 1
# Domain separation between the two counter-based streams: the epoch
# permutation keys on (seed, epoch), buffer draws on (seed ^ SALT, block).
_BUFFER_SALT = 0x5D41402A
# Buffer draws are generated this many words at a time — a fresh
# Generator per example costs ~µs of construction on the producer path,
# the same order as the feed latency the prefetcher exists to hide.
_DRAW_BLOCK = 256

Batch = Dict[str, np.ndarray]


def _philox(*key: int) -> np.random.Generator:
    return np.random.Generator(
        np.random.Philox(key=np.array(key, dtype=np.uint64)))


# ---------------------------------------------------------------------------
# Sources: __len__ + fetch(global ids) -> dict of host arrays
# ---------------------------------------------------------------------------

class Source:
    """An indexable example store. Subclasses implement ``__len__`` and
    ``fetch(ids) -> {leaf: np.ndarray}`` (leading dim = ``len(ids)``);
    fetch must be a pure function of ``ids`` — all randomness lives in the
    iterator's index stream so the fetch side never carries RNG state."""

    def __len__(self) -> int:
        raise NotImplementedError

    def fetch(self, ids: np.ndarray) -> Batch:
        raise NotImplementedError


class ArraySource(Source):
    """In-memory dict-of-arrays source (the bench/test workhorse)."""

    def __init__(self, arrays: Mapping[str, Any]):
        if not arrays:
            raise ValueError("ArraySource needs at least one leaf")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        lengths = {k: v.shape[0] if v.ndim else None
                   for k, v in self.arrays.items()}
        sizes = set(lengths.values())
        if None in sizes or len(sizes) != 1:
            raise ValueError(
                f"ArraySource leaves must share a leading example dim, "
                f"got {lengths}")
        self._n = sizes.pop()

    def __len__(self) -> int:
        return self._n

    def fetch(self, ids: np.ndarray) -> Batch:
        return {k: v[ids] for k, v in self.arrays.items()}


class MemmapSource(Source):
    """``.npy``-backed source opened with ``mmap_mode="r"``: fetch reads
    only the pages the requested ids touch — datasets larger than host RAM
    stream without a loader process."""

    def __init__(self, paths: Mapping[str, Union[str, Path]]):
        if not paths:
            raise ValueError("MemmapSource needs at least one leaf")
        self.arrays = {k: np.load(p, mmap_mode="r")
                       for k, p in paths.items()}
        lengths = {k: v.shape[0] for k, v in self.arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(
                f"MemmapSource leaves must share a leading example dim, "
                f"got {lengths}")
        self._n = next(iter(lengths.values()))

    def __len__(self) -> int:
        return self._n

    def fetch(self, ids: np.ndarray) -> Batch:
        # Fancy indexing on a memmap materializes a real ndarray (a copy),
        # so the returned batch never aliases the mapped file.
        return {k: v[ids] for k, v in self.arrays.items()}


class FileListSource(Source):
    """One example per file: ``loader(path) -> {leaf: array}``; fetch
    loads the id-indexed files and stacks them. The id space is the FILE
    list, so the deterministic global order is over files — the per-host
    file assignment the tentpole names falls out of the same contiguous
    block selection every other source uses."""

    def __init__(self, files: Sequence[Union[str, Path]],
                 loader: Callable[[Union[str, Path]], Mapping[str, Any]]):
        if not files:
            raise ValueError("FileListSource needs at least one file")
        self.files = list(files)
        self.loader = loader

    def __len__(self) -> int:
        return len(self.files)

    def fetch(self, ids: np.ndarray) -> Batch:
        examples = [self.loader(self.files[int(i)]) for i in ids]
        keys = list(examples[0])
        for i, ex in zip(ids, examples):
            if set(ex) != set(keys):
                raise ValueError(
                    f"FileListSource: file {self.files[int(i)]} produced "
                    f"leaves {sorted(ex)} != {sorted(keys)}")
        return {k: np.stack([np.asarray(ex[k]) for ex in examples])
                for k in keys}


# ---------------------------------------------------------------------------
# Dataset builder
# ---------------------------------------------------------------------------

class Dataset:
    """Declarative pipeline spec; chain stages, then ``iterator()`` /
    ``device_iterator()`` instantiate it for a shard::

        ds = (Dataset.from_arrays({"x": X, "y": Y})
                .shuffle()            # per-epoch Philox permutation
                .repeat()             # epochs forever (or repeat(3))
                .batch(64)            # GLOBAL batch size
                .map(augment)
                .with_ids())          # attach the global example ids
        it = ds.device_iterator(mesh, prefetch=2)

    Builder methods return a copy — a Dataset can be re-instantiated (the
    resume tests rebuild the identical stream from the same spec). The
    default seed comes from ``TONY_DATA_SEED`` (``tony.data.seed`` through
    the runtime) so a tony-submitted gang agrees on the stream without the
    script threading a seed through."""

    def __init__(self, source: Source, *, seed: Optional[int] = None):
        self.source = source
        if seed is None:
            seed = int(os.environ.get(constants.ENV_DATA_SEED, "0") or 0)
        if seed < 0:
            raise ValueError(f"seed must be >= 0 (Philox key), got {seed}")
        self.seed = seed
        self._shuffle = False
        self._buffer_size = 0
        self._epochs: Optional[int] = 1
        self._global_batch: Optional[int] = None
        self._map_fn: Optional[Callable[[Batch], Batch]] = None
        self._id_leaf: Optional[str] = None

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_arrays(cls, arrays: Mapping[str, Any], *,
                    seed: Optional[int] = None) -> "Dataset":
        return cls(ArraySource(arrays), seed=seed)

    @classmethod
    def from_memmap(cls, paths: Mapping[str, Union[str, Path]], *,
                    seed: Optional[int] = None) -> "Dataset":
        return cls(MemmapSource(paths), seed=seed)

    @classmethod
    def from_files(cls, files: Sequence[Union[str, Path]],
                   loader: Callable[[Union[str, Path]], Mapping[str, Any]],
                   *, seed: Optional[int] = None) -> "Dataset":
        return cls(FileListSource(files, loader), seed=seed)

    # -- stages ------------------------------------------------------------
    def _copy(self) -> "Dataset":
        return copy.copy(self)

    def shuffle(self, buffer_size: Optional[int] = None) -> "Dataset":
        """No argument: full per-epoch permutation (counter-based, zero
        state beyond the cursor). ``buffer_size=k``: streaming k-deep
        shuffle buffer over the id stream — for sources too big to permute
        whole epochs of, at the cost of ``k`` ids in the iterator state."""
        ds = self._copy()
        if buffer_size is None:
            ds._shuffle = True
        else:
            if buffer_size < 2:
                raise ValueError(
                    f"shuffle buffer_size must be >= 2, got {buffer_size}")
            ds._buffer_size = buffer_size
        return ds

    def repeat(self, epochs: Optional[int] = None) -> "Dataset":
        """``None`` = forever. Each epoch gets its own permutation
        (``Philox(seed, epoch)``); batches may span epoch boundaries."""
        if epochs is not None and epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {epochs}")
        ds = self._copy()
        ds._epochs = epochs
        return ds

    def batch(self, global_batch: int) -> "Dataset":
        """GLOBAL batch size — the whole gang's, not this host's. A final
        partial batch is dropped (a ragged global batch has no stable
        sharding across world sizes)."""
        if global_batch < 1:
            raise ValueError(f"global_batch must be >= 1, got {global_batch}")
        ds = self._copy()
        ds._global_batch = global_batch
        return ds

    def map(self, fn: Callable[[Batch], Batch]) -> "Dataset":
        """Host-side per-LOCAL-batch transform (decode, augment, cast).
        Must be deterministic per batch — randomness belongs in the index
        stream, where it is counter-based and checkpointable."""
        ds = self._copy()
        ds._map_fn = fn
        return ds

    def with_ids(self, leaf: str = "id") -> "Dataset":
        """Attach each example's GLOBAL id as an extra int64 leaf (added
        after ``map``) — the observable the deterministic-resume pin
        asserts on, and a join key for eval bookkeeping."""
        ds = self._copy()
        ds._id_leaf = leaf
        return ds

    # -- instantiation -----------------------------------------------------
    def iterator(self, shard: Optional[ShardSpec] = None
                 ) -> "PipelineIterator":
        return PipelineIterator(
            self, ShardSpec.from_env() if shard is None else shard)

    def device_iterator(self, mesh=None, *, shard: Optional[ShardSpec] = None,
                        prefetch: int = 2, seq_axis: bool = False,
                        tag: str = "input"):
        from tony_tpu_torch.data.prefetch import DeviceIterator
        return DeviceIterator(self.iterator(shard), mesh,
                              depth=prefetch, seq_axis=seq_axis, tag=tag)


# ---------------------------------------------------------------------------
# The iterator: global index stream + shard-local fetch
# ---------------------------------------------------------------------------

class PipelineIterator:
    """Yields this shard's block of each global batch; ``state()`` /
    ``restore()`` round-trip the cursor exactly (and host-count
    independently — the state carries no shard identity)."""

    def __init__(self, ds: Dataset, shard: ShardSpec):
        if ds._global_batch is None:
            raise ValueError(
                "Dataset has no batch size: call .batch(global_batch) "
                "before building an iterator")
        if len(ds.source) == 0:
            # With repeat(), a zero-length epoch would spin the index
            # stream forever instead of raising — fail at construction.
            raise ValueError("Dataset source is empty")
        self._ds = ds
        self.shard = shard
        self.global_batch = ds._global_batch
        self._local_slice = shard.local_slice(self.global_batch)
        # Cursor state (the whole of it — everything else above is spec).
        self._epoch = 0
        self._pos = 0                 # ids consumed from the current epoch
        self._draws = 0               # shuffle-buffer draw counter
        self._buffer: List[int] = []  # shuffle-buffer contents (global ids)
        self._batches = 0             # global batches emitted
        # Cursor as of BEFORE the last emitted batch (the retained
        # rollback snapshot): lets a consumer holding that batch
        # undelivered (depth-0 DeviceIterator retry window) checkpoint
        # without the pipeline paying a second per-step state copy.
        self._committed_snap: Optional[tuple] = None
        self._order_cache: tuple = (-1, None)
        self._draw_cache: tuple = (-1, None)

    # -- global index stream ----------------------------------------------
    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self._order_cache[0] == epoch:
            return self._order_cache[1]
        n = len(self._ds.source)
        if self._ds._shuffle:
            order = _philox(self._ds.seed, epoch).permutation(n)
        else:
            order = np.arange(n)
        self._order_cache = (epoch, order)
        return order

    def _stream_next(self, k: int) -> List[int]:
        """Up to ``k`` ids from the epoch-concatenated stream, advancing
        (epoch, pos)."""
        out: List[int] = []
        epochs = self._ds._epochs
        while len(out) < k:
            if epochs is not None and self._epoch >= epochs:
                break
            order = self._epoch_order(self._epoch)
            take = min(k - len(out), len(order) - self._pos)
            out.extend(int(i) for i in order[self._pos:self._pos + take])
            self._pos += take
            if self._pos >= len(order):
                self._epoch += 1
                self._pos = 0
        return out

    def _draw(self, n: int) -> int:
        """Word ``draws`` of the Philox word stream, reduced mod ``n``
        (bias < n/2**62 — immaterial for any realistic buffer). The block
        cache is derived state: a restore just regenerates it from the
        draw counter."""
        blk, off = divmod(self._draws, _DRAW_BLOCK)
        if self._draw_cache[0] != blk:
            words = _philox(self._ds.seed ^ _BUFFER_SALT, blk).integers(
                0, 1 << 62, size=_DRAW_BLOCK, dtype=np.int64)
            self._draw_cache = (blk, words)
        self._draws += 1
        return int(self._draw_cache[1][off]) % n

    def _next_ids(self) -> np.ndarray:
        """The next GLOBAL batch's example ids — identical on every host."""
        b = self.global_batch
        if not self._ds._buffer_size:
            ids = self._stream_next(b)
            if len(ids) < b:
                raise StopIteration
            return np.asarray(ids, np.int64)
        out: List[int] = []
        while len(out) < b:
            want = self._ds._buffer_size - len(self._buffer)
            if want > 0:
                self._buffer.extend(self._stream_next(want))
            if not self._buffer:
                break                        # stream dry AND buffer drained
            j = self._draw(len(self._buffer))
            # Swap-pop: O(1) removal keeps the buffer a plain id list the
            # state dict can carry verbatim.
            self._buffer[j], self._buffer[-1] = \
                self._buffer[-1], self._buffer[j]
            out.append(self._buffer.pop())
        if len(out) < b:
            raise StopIteration
        return np.asarray(out, np.int64)

    # -- iteration ---------------------------------------------------------
    def __iter__(self) -> "PipelineIterator":
        return self

    def _snapshot(self) -> tuple:
        return (self._epoch, self._pos, self._draws,
                list(self._buffer), self._batches)

    def _rollback(self, snap: tuple) -> None:
        (self._epoch, self._pos, self._draws,
         self._buffer, self._batches) = snap

    def __next__(self) -> Batch:
        # Snapshot → advance → fetch → commit: a fetch/map failure rolls
        # the cursor back, so a caught-and-retried transient I/O error
        # re-reads the SAME global batch instead of silently skipping it —
        # and a state() taken after the failure doesn't bake the skip in.
        snap = self._snapshot()
        try:
            ids = self._next_ids()
        except StopIteration:
            # Exhaustion consumes (and drops) the final partial batch's
            # ids before raising; roll those back too, or a state() taken
            # after the end — restored into a pipeline with more epochs —
            # would silently skip them.
            self._rollback(snap)
            raise
        self._batches += 1
        local_ids = ids[self._local_slice]
        try:
            batch = dict(self._ds.source.fetch(local_ids))
            if self._ds._map_fn is not None:
                batch = self._ds._map_fn(batch)
        except StopIteration as e:
            # PEP-479 hazard: a StopIteration leaking out of a user map_fn
            # (e.g. next() on an exhausted side iterator) re-raised from
            # __next__ reads as clean end-of-stream and silently truncates
            # the run — surface it as an error instead.
            self._rollback(snap)
            raise RuntimeError(
                "Source.fetch/map_fn raised StopIteration — refusing to "
                "treat it as end-of-stream") from e
        except Exception:
            self._rollback(snap)
            raise
        if self._ds._id_leaf is not None:
            if self._ds._id_leaf in batch:
                self._rollback(snap)
                raise ValueError(
                    f"with_ids() leaf {self._ds._id_leaf!r} already exists "
                    f"in the batch (from the source or map_fn) and would be "
                    f"silently overwritten — pick another name via "
                    f"with_ids(leaf=...)")
            batch[self._ds._id_leaf] = local_ids
        self._committed_snap = snap
        return batch

    @property
    def batches_emitted(self) -> int:
        return self._batches

    # -- checkpointable state ----------------------------------------------
    def state(self) -> Dict[str, Any]:
        """JSON-able cursor: everything needed to resume the GLOBAL stream
        bit-exactly on any world size. The stream-defining spec
        (``seed``/``global_batch``/``source_len``/shuffle config) is
        pinned inside so a restore against a different spec — including a
        source that grew or shrank since the save — fails loudly instead
        of silently forking the stream."""
        return self._state_dict(self._epoch, self._pos, self._draws,
                                list(self._buffer), self._batches)

    def state_before_last(self) -> Dict[str, Any]:
        """Cursor as of BEFORE the last batch ``__next__`` emitted — what a
        consumer still holding that batch undelivered must save so a
        resume replays it. Equals :meth:`state` when nothing was emitted
        since construction/restore."""
        if self._committed_snap is None:
            return self.state()
        epoch, pos, draws, buffer, batches = self._committed_snap
        return self._state_dict(epoch, pos, draws, list(buffer), batches)

    def _state_dict(self, epoch: int, pos: int, draws: int,
                    buffer: List[int], batches: int) -> Dict[str, Any]:
        return {
            "version": STATE_VERSION,
            "seed": self._ds.seed,
            "global_batch": self.global_batch,
            "source_len": len(self._ds.source),
            "shuffle": int(bool(self._ds._shuffle)),
            "buffer_size": int(self._ds._buffer_size),
            "epoch": epoch,
            "pos": pos,
            "draws": draws,
            "buffer": buffer,
            "batches": batches,
        }

    def restore(self, state: Mapping[str, Any]) -> None:
        if state.get("version") != STATE_VERSION:
            raise ValueError(
                f"iterator state version {state.get('version')!r} != "
                f"{STATE_VERSION} — written by an incompatible data plane")
        for key, mine in (("seed", self._ds.seed),
                          ("global_batch", self.global_batch),
                          ("source_len", len(self._ds.source)),
                          ("shuffle", int(bool(self._ds._shuffle))),
                          ("buffer_size", int(self._ds._buffer_size))):
            if int(state[key]) != mine:
                raise ValueError(
                    f"iterator state {key}={state[key]} != this pipeline's "
                    f"{key}={mine} — restoring it would fork the example "
                    f"stream")
        self._epoch = int(state["epoch"])
        self._pos = int(state["pos"])
        self._draws = int(state["draws"])
        self._buffer = [int(i) for i in state["buffer"]]
        self._batches = int(state["batches"])
        self._committed_snap = None
        self._order_cache = (-1, None)
        self._draw_cache = (-1, None)
