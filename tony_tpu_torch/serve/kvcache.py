"""Paged KV cache: a fixed-size block pool with per-sequence block tables
(the core of :mod:`tony_tpu.serve.kvcache`).

The pool is two device tensors ``[n_layers, n_blocks, block_size,
kv_dim]`` (k and v, views of stores with one more block: the sink the
step's dropped rows land in); a sequence owns an ordered list of block ids (its
*block table*) covering positions ``[0, len)`` — position ``p`` lives at
row ``p % block_size`` of block ``table[p // block_size]``. Allocation
is host-side bookkeeping only (a LIFO free list of ids and per-block
refcounts); the engine's step writes the tensors in place through flat
indices the allocator hands out. Blocks are NOT zeroed on free/realloc:
every position is written before any query can attend it (the
flash-decode mask admits key ``j`` only for rows at position ``>= j``),
so stale bytes are never read.

Prefix tier (the engine's ``prefix_cache=True``): blocks are
refcounted, and a full block whose rows are all verified-written can be
*published* under its chain key (:mod:`tony_tpu_torch.serve.prefix`).
An admission whose prompt chain-matches published blocks *adopts* them
(refcount + 1) instead of recomputing them. Writes go through
:meth:`PagedKVCache.write_index`, which copies on write: a block with
refcount > 1 is never mutated, the writer gets a private copy first.
Freed blocks that carry a key retire to an LRU *cached tier* instead of
the LIFO free list: still adoptable, reclaimed least recently freed
first once the LIFO tier runs dry.

Speculative tier (:mod:`tony_tpu_torch.serve.spec`):
:meth:`~PagedKVCache.spec_reserve` grows a table over drafted positions
as a revocable extension, :meth:`~PagedKVCache.commit` advances the
write cursor to the accepted length, and :meth:`~PagedKVCache.rollback`
returns the rest of the extension in reverse allocation order.

Wire tier (:mod:`tony_tpu_torch.serve.disagg`):
:meth:`~PagedKVCache.export_blocks` snapshots a sequence's blocks as
CRC32-guarded payloads and :meth:`~PagedKVCache.import_blocks` is the
receiving admission path, atomic like :meth:`~PagedKVCache.admit_shared`
and composing with the prefix tier (a shipped stem the importer already
holds is adopted instead of rewritten). The payload is the JAX
package's, byte for byte: the same keys, the raw ``[n_layers,
block_size, kv_dim]`` bytes of each block and the same header, so a
block exported by either package imports into the other.

Host tier (``host_blocks > 0``): a host-RAM tier holding the same
CRC-guarded wire payloads, so everything that moves between device and
host re-enters through the import path's check-then-commit discipline
(a corrupt host byte never reaches the pool). Two populations live
there:

* **demoted stems** — when the LIFO tier runs dry, the cached tier's LRU
  eviction spills the victim's content to the host instead of dropping
  it, and :meth:`~PagedKVCache.demote` spills a batch ahead of need;
  :meth:`~PagedKVCache.promote` re-stages a chain-key run into device
  blocks (one scatter a pool) where the device index stops matching,
  refcount 0 in the cached tier, so the admission after it adopts them
  like any published block;
* **parked sequences** — :meth:`~PagedKVCache.park` snapshots a
  sequence's blocks (one device-to-host copy a pool) with its chain keys
  and frees the device reservation; :meth:`~PagedKVCache.resume`
  re-admits it under a new id through ``import_blocks``, adopting what
  is still on the device. The base64 and CRC encode can run off the
  drive thread (:class:`_OffloadWorker`); the record's ready event gates
  readers.

Every host-tier write lands IN PLACE in ``k_store``/``v_store``, as an
import does: the step and its captured graphs read the stores'
addresses. A payload of either tier is byte for byte the JAX package's
for the same pool contents.

Capacity failures are a typed :class:`AdmissionError` carrying the
needed/free block counts — back-pressure the engine acts on, not an
allocator OOM.

Threading contract: the allocator is not internally locked; the
engine's single drive thread (``EngineFront`` serializes callers)
performs every mutation.
"""

from __future__ import annotations

import base64
import queue
import threading
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tony_tpu_torch import resolve_device
from tony_tpu_torch.serve.disagg import HandoffError

# The wire's dtype names: numpy's names of the JAX pool's dtypes
# (``str(np.dtype(jnp.bfloat16))`` is "bfloat16").
_WIRE_DTYPES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32"}


def _encode_payload(kb: Union[bytes, memoryview],
                    vb: Union[bytes, memoryview]) -> Dict[str, Any]:
    """One block's wire payload from its raw k/v bytes: base64 of each
    and a CRC32 over both, the JAX package's encoding."""
    return {"k": base64.b64encode(kb).decode("ascii"),
            "v": base64.b64encode(vb).decode("ascii"),
            "crc": zlib.crc32(vb, zlib.crc32(kb)) & 0xFFFFFFFF}


def encode_blocks(raw: Sequence[Tuple[Any, Any]]) -> List[Dict[str, Any]]:
    """The wire payloads of raw host block bytes (pairs of k and v, as
    :meth:`PagedKVCache.fetch_keys` returns them)."""
    return [_encode_payload(kb, vb) for kb, vb in raw]


class _OffloadWorker:
    """The host tier's encode thread, double-buffered: the drive
    thread's batched device-to-host copy hands the host bytes over a
    queue, this daemon thread runs the base64 and CRC encode, and a
    bounded semaphore caps records in flight at two, so parking cannot
    outrun host RAM. The worker writes only into the record it was
    handed and publishes it by setting the record's ready event (readers
    wait on it first), so no pool bookkeeping is touched off the drive
    thread. The bytes it gets are a host copy, never a view of a pool
    block the next step may reuse."""

    def __init__(self, slots: int = 2):
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._slots = threading.BoundedSemaphore(slots)
        # A failed encode parks here and re-raises on the drive thread
        # at the next check().
        self._err: Optional[BaseException] = None
        self._err_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, name="tony-kv-offload", daemon=True)
        self._thread.start()

    def submit(self, rec: Dict[str, Any],
               raw: Sequence[Tuple[Any, Any]]) -> None:
        self._slots.acquire()
        self._q.put((rec, list(raw)))

    def check(self) -> None:
        """Re-raise (once) any encode failure on the caller's thread."""
        with self._err_lock:
            err, self._err = self._err, None
        if err is not None:
            raise err

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            rec, raw = item
            try:
                rec["blocks"] = encode_blocks(raw)
            except BaseException as e:  # noqa: BLE001 — re-raised by check()
                with self._err_lock:
                    self._err = e
            finally:
                rec["ready"].set()
                self._slots.release()

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=10)


class AdmissionError(RuntimeError):
    """The request cannot enter the engine NOW: the block pool cannot
    host it (or it can never fit). Retry/queue/shed upstream — this is
    back-pressure, not a crash."""

    def __init__(self, message: str, *, needed_blocks: int = 0,
                 free_blocks: int = 0, retryable: bool = True):
        super().__init__(message)
        self.needed_blocks = needed_blocks
        self.free_blocks = free_blocks
        # False: the request exceeds engine capacity outright and will
        # never fit, even on an idle engine.
        self.retryable = retryable


class PagedKVCache:
    """Host-managed block allocator over device-resident KV block pools."""

    def __init__(self, n_layers: int, kv_dim: int, *, n_blocks: int,
                 block_size: int, dtype: torch.dtype = torch.bfloat16,
                 host_blocks: int = 0, async_offload: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        if n_blocks <= 0 or block_size <= 0:
            raise ValueError(f"need positive n_blocks/block_size, got "
                             f"{n_blocks}/{block_size}")
        self.device = resolve_device(device)
        self.n_layers = int(n_layers)
        self.kv_dim = int(kv_dim)
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        # The pool and one sink block past it ([n_layers, n_blocks + 1,
        # block_size, kv_dim]): the step commits the rows it drops
        # (``oob_index``) into the sink, never into a live row, so it
        # needs no host-side selection of the rows it keeps. ``k``/``v``
        # are the pool's views without the sink.
        shape = (self.n_layers, self.n_blocks + 1, self.block_size,
                 self.kv_dim)
        self.k_store = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_store = torch.zeros(shape, dtype=dtype, device=self.device)
        self.k = self.k_store[:, :self.n_blocks]
        self.v = self.v_store[:, :self.n_blocks]
        # LIFO free list: a just-freed block is the next handed out, so
        # the reuse invariants get exercised constantly.
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._tables: Dict[Any, List[int]] = {}
        # Prefix tier: per-block refcount (present iff allocated), the
        # key -> block and block -> key index, and the LRU cached tier
        # (refcount-0 blocks that still hold published content, most
        # recently freed last).
        self._refs: Dict[int, int] = {}
        self._index: Dict[str, int] = {}
        self._key_of: Dict[int, str] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # Lifetime counters (the engine's stats read them).
        self.adopted_total = 0
        self.cow_total = 0
        self.lru_evicted_total = 0
        self.revived_total = 0
        self.imported_total = 0
        # Speculative tier: per-sequence blocks added by spec_reserve
        # and not yet promoted by a commit, and the write cursor (the
        # positions below it hold verified rows).
        self._spec: Dict[Any, List[int]] = {}
        self._committed: Dict[Any, int] = {}
        # Host tier (module docstring): demoted stems by chain key, least
        # recently demoted first (the order they are dropped in when the
        # tier fills), and parked sequences by id.
        self.host_blocks = int(host_blocks)
        self._host_index: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._parked: Dict[Any, Dict[str, Any]] = {}
        self.demoted_total = 0
        self.promoted_total = 0
        self.parked_total = 0
        self.resumed_total = 0
        self._offload = (_OffloadWorker()
                         if async_offload and self.host_blocks > 0 else None)

    # -- capacity ----------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Blocks available to a new reservation: the LIFO free tier
        plus the reclaimable LRU cached tier."""
        return len(self._free) + len(self._lru)

    def blocks_for(self, length: int) -> int:
        """Blocks covering ``length`` positions."""
        return -(-max(0, int(length)) // self.block_size)

    def _alloc_block(self) -> int:
        """One fresh block: the LIFO free list first; when it is dry,
        the least recently freed cached block, unindexed. With the host
        tier armed the evicted content spills to the host instead of
        being dropped (the LRU order is the demotion policy); a full
        host tier drops only stems, and degrades to the plain drop.
        Callers check capacity first."""
        if self._free:
            b = self._free.pop()
        else:
            b, _ = self._lru.popitem(last=False)
            key = self._key_of.pop(b, None)
            if key is not None:
                self._index.pop(key, None)
                if self.host_blocks > 0 and self._host_reclaim(1):
                    kb, vb = self._fetch_raw([b])[0]
                    self._host_index[key] = _encode_payload(kb, vb)
                    self._host_index.move_to_end(key)
                    self.demoted_total += 1
            self.lru_evicted_total += 1
        self._refs[b] = 1
        return b

    def _release_block(self, b: int) -> None:
        """Drop one reference; at zero the block retires to the cached
        tier when published (still adoptable), else to the free list."""
        self._refs[b] -= 1
        if self._refs[b] > 0:
            return
        del self._refs[b]
        if b in self._key_of:
            self._lru[b] = None
            self._lru.move_to_end(b)
        else:
            self._free.append(b)

    # -- allocation --------------------------------------------------------
    def reserve(self, seq_id: Any, length: int) -> List[int]:
        """Grow ``seq_id``'s table to cover ``length`` positions; raises
        :class:`AdmissionError` (state unchanged) when the pool can't
        supply the growth. The engine reserves a request's FULL extent
        (prompt + max new tokens) at admission, so decode can never hit
        pool exhaustion mid-flight."""
        if self._spec.get(seq_id):
            # A permanent grow would interleave with the revocable tail,
            # and rollback could no longer truncate by suffix.
            raise ValueError(
                f"sequence {seq_id!r} holds an uncommitted speculative "
                f"extension — commit() or rollback() it before a "
                f"permanent reserve")
        table = self._tables.setdefault(seq_id, [])
        needed = self.blocks_for(length) - len(table)
        if needed > self.free_blocks:
            raise AdmissionError(
                f"KV pool exhausted: sequence {seq_id!r} needs {needed} "
                f"more block(s) for {length} positions, "
                f"{self.free_blocks} free of {self.n_blocks} "
                f"({len(self._lru)} cached-reclaimable)",
                needed_blocks=needed, free_blocks=self.free_blocks)
        for _ in range(max(0, needed)):
            table.append(self._alloc_block())
        return list(table)

    # -- prefix sharing ----------------------------------------------------
    def match_prefix(self, keys: Sequence[str]) -> List[int]:
        """Block ids of the longest indexed chain-key prefix of
        ``keys`` (live or cached-tier blocks). Moves no refcount."""
        out: List[int] = []
        for key in keys:
            b = self._index.get(key)
            if b is None:
                break
            out.append(b)
        return out

    def admit_shared(self, seq_id: Any, length: int,
                     keys: Sequence[str] = ()) -> int:
        """Fresh-admission reserve with prefix adoption, atomically:
        adopt the matched chain of ``keys`` (refcount + 1, reviving
        cached-tier blocks) and allocate the rest of the
        ``length``-covering blocks fresh. Returns the blocks adopted.
        Raises :class:`AdmissionError` with NOTHING changed when the
        fresh growth cannot be supplied."""
        if self._tables.get(seq_id):
            raise ValueError(f"sequence {seq_id!r} already holds blocks "
                             f"— admit_shared is a fresh-admission path")
        matched = self.match_prefix(keys)
        needed = self.blocks_for(length) - len(matched)
        # Reviving a cached-tier block consumes reclaimable capacity.
        revive = sum(1 for b in matched if b in self._lru)
        if needed > self.free_blocks - revive:
            raise AdmissionError(
                f"KV pool exhausted: sequence {seq_id!r} needs {needed} "
                f"fresh block(s) beyond {len(matched)} shared for "
                f"{length} positions, {self.free_blocks - revive} "
                f"available of {self.n_blocks}",
                needed_blocks=needed,
                free_blocks=self.free_blocks - revive)
        for b in matched:
            if b in self._lru:
                del self._lru[b]
                self._refs[b] = 1
                self.revived_total += 1
            else:
                self._refs[b] += 1
            self._touch_key(b)
        self.adopted_total += len(matched)
        table = matched + [self._alloc_block()
                           for _ in range(max(0, needed))]
        self._tables[seq_id] = table
        return len(matched)

    def write_index(self, seq_id: Any, pos: int) -> int:
        """Flat index of position ``pos`` FOR WRITING. Every KV scatter
        target goes through here: when the covering block is shared
        (refcount > 1) the writer first gets a private copy (device rows
        copied, table repointed, donor untouched). Reads (the gather
        tables) stay on :meth:`flat_index`."""
        table = self._tables[seq_id]
        bi, r = divmod(int(pos), self.block_size)
        if bi >= len(table):
            raise IndexError(
                f"position {pos} beyond sequence {seq_id!r}'s "
                f"{len(table)}-block reservation")
        if self._refs[table[bi]] > 1:
            self.cow_block(seq_id, bi)
        return table[bi] * self.block_size + r

    def cow_block(self, seq_id: Any, block_i: int) -> int:
        """Copy-on-write of table slot ``block_i``: a private block, the
        shared block's rows copied into it across every layer on the
        device, one reference dropped on the donor. Raises
        :class:`AdmissionError` when no block can be supplied."""
        table = self._tables[seq_id]
        src = table[block_i]
        if self._refs[src] <= 1:
            return src
        if self.free_blocks < 1:
            raise AdmissionError(
                f"KV pool exhausted: sequence {seq_id!r} needs 1 block "
                f"for a copy-on-write of shared block {src}, 0 free",
                needed_blocks=1, free_blocks=0)
        dst = self._alloc_block()
        self.k[:, dst] = self.k[:, src]
        self.v[:, dst] = self.v[:, src]
        self._refs[src] -= 1
        table[block_i] = dst
        self.cow_total += 1
        return dst

    def _touch_key(self, block: int) -> None:
        """Move ``block``'s index entry to the recent end: the digest
        advertises the last keys, so recency means most recently USED
        (a shared system-prompt stem stays advertised)."""
        key = self._key_of.get(block)
        if key is not None:
            del self._index[key]
            self._index[key] = block

    def publish_block(self, seq_id: Any, block_i: int, key: str) -> bool:
        """Index table slot ``block_i`` under chain ``key`` so later
        admissions can adopt it. First publisher wins; a
        re-publication of an indexed key refreshes its recency. The
        CALLER guarantees every row of the block is verified-written."""
        b = self._tables[seq_id][block_i]
        # A device copy supersedes a demoted host copy of the same key
        # (the same bytes): the device and host key sets stay disjoint.
        self._host_index.pop(key, None)
        if key in self._index:
            self._touch_key(self._index[key])
            return False
        if b in self._key_of:
            return False
        self._index[key] = b
        self._key_of[b] = key
        return True

    def digest(self, limit: int = 256) -> List[str]:
        """Up to ``limit`` most recently used chain keys: what a
        replica advertises on its heartbeat for the router's overlap
        score."""
        return list(self._index)[-limit:]

    def shared_blocks(self) -> int:
        """Blocks currently referenced by more than one table."""
        return sum(1 for r in self._refs.values() if r > 1)

    def ref(self, block: int) -> int:
        """Current refcount of ``block`` (0 = free or cached tier)."""
        return self._refs.get(block, 0)

    def cached_blocks(self) -> List[int]:
        """The LRU cached tier, least recently freed first."""
        return list(self._lru)

    # -- wire tier (tony_tpu_torch.serve.disagg) ---------------------------
    def wire_header(self) -> Dict[str, Any]:
        """The geometry a block payload must match to be importable,
        shipped with every handoff so a mis-paired fleet fails typed
        instead of gathering garbage."""
        return {"n_layers": self.n_layers, "kv_dim": self.kv_dim,
                "block_size": self.block_size,
                "dtype": _WIRE_DTYPES[self.k.dtype]}

    def export_blocks(self, seq_id: Any, length: int) -> List[Dict[str, Any]]:
        """Wire payloads of the blocks covering ``length`` positions of
        ``seq_id``: per block, the raw ``[n_layers, block_size, kv_dim]``
        k and v bytes (base64 for the JSON-lines RPC) and a CRC32 over
        both. Rows past ``length`` in the tail block ship as they are:
        they are never read on the importer either (the same masking by
        position), so the CRC guards the wire, not content identity.
        Read-only: no bookkeeping moves."""
        table = self._tables[seq_id]
        nb = self.blocks_for(length)
        if nb > len(table):
            raise ValueError(
                f"cannot export {length} positions for {seq_id!r}: only "
                f"{len(table)} block(s) reserved")
        return encode_blocks(self._fetch_raw(table[:nb]))

    def _fetch_raw(self, ids: Sequence[int]
                   ) -> List[Tuple[memoryview, memoryview]]:
        """Raw host k/v bytes of pool blocks ``ids``: ONE batched gather
        and ONE device-to-host copy per pool, not one per block. The
        blocks come out ``[n, n_layers, block_size, kv_dim]`` and
        contiguous, each block's bytes a view of the host copy (numpy
        has no bfloat16, so the bytes are uint8)."""
        if not ids:
            return []
        idx = torch.as_tensor(list(ids), dtype=torch.long,
                              device=self.k.device)

        def host(pool: torch.Tensor) -> np.ndarray:
            blocks = pool.index_select(1, idx).transpose(0, 1).contiguous()
            return blocks.view(torch.uint8).cpu().numpy()

        kh, vh = host(self.k), host(self.v)
        return [(memoryview(kh[i]).cast("B"), memoryview(vh[i]).cast("B"))
                for i in range(len(ids))]

    def _decode_block(self, blk: Dict[str, Any]) -> Tuple[np.ndarray,
                                                          np.ndarray]:
        """Decode and CRC-check one wire block payload into host bytes
        ``[n_layers, block_size, kv_dim · itemsize]`` (uint8); raises
        :class:`~tony_tpu_torch.serve.disagg.HandoffError`
        (non-retryable: a resend of the same corrupt payload cannot heal
        it) on any mismatch."""
        try:
            kb = base64.b64decode(blk["k"])
            vb = base64.b64decode(blk["v"])
            crc = int(blk["crc"])
        except (KeyError, TypeError, ValueError) as e:
            raise HandoffError(f"malformed block payload: {e}",
                               retryable=False) from e
        got = zlib.crc32(vb, zlib.crc32(kb)) & 0xFFFFFFFF
        if got != crc:
            raise HandoffError(
                f"block payload CRC mismatch (got {got:#010x}, want "
                f"{crc:#010x})", retryable=False)
        shape = (self.n_layers, self.block_size, self.kv_dim)
        itemsize = self.k.element_size()
        want = int(np.prod(shape)) * itemsize
        if len(kb) != want or len(vb) != want:
            raise HandoffError(
                f"block payload geometry mismatch: {len(kb)}/{len(vb)} "
                f"bytes vs expected {want} for {shape} "
                f"{_WIRE_DTYPES[self.k.dtype]}", retryable=False)
        raw = shape[:2] + (shape[2] * itemsize,)
        return (np.frombuffer(kb, np.uint8).reshape(raw),
                np.frombuffer(vb, np.uint8).reshape(raw))

    def import_blocks(self, seq_id: Any, length: int,
                      blocks: Sequence[Dict[str, Any]], *,
                      keys: Sequence[str] = (), offset: int = 0) -> int:
        """Fresh-admission import of a shipped prefill: adopt the first
        ``offset`` blocks from the local prefix index through ``keys``
        (the receiver half of the offer/import handshake), write the
        shipped payloads into fresh pool blocks, and allocate the rest
        of the ``length``-covering reservation fresh. Returns the blocks
        adopted.

        Atomic like :meth:`admit_shared`: every raising check — payload
        CRC and geometry, the offered prefix still matching, pool
        capacity — runs BEFORE any bookkeeping or byte moves, so an
        :class:`AdmissionError` (pool pressure, retryable upstream) or a
        :class:`~tony_tpu_torch.serve.disagg.HandoffError` leaves the
        cache unchanged. The bytes land IN PLACE in ``k_store`` /
        ``v_store`` (one ``index_copy_`` per pool): the engine's step
        and its captured graphs read those stores' addresses. Imported
        blocks are private (refcount 1); adopted blocks keep the
        copy-on-write contract."""
        if self._tables.get(seq_id):
            raise ValueError(f"sequence {seq_id!r} already holds blocks "
                             f"— import_blocks is a fresh-admission path")
        offset = int(offset)
        nb = self.blocks_for(length)
        if offset < 0 or offset + len(blocks) > nb:
            raise HandoffError(
                f"import geometry mismatch: offset {offset} + "
                f"{len(blocks)} shipped block(s) exceed the "
                f"{nb}-block reservation for {length} positions",
                retryable=False)
        # 1. Decode and check every payload (raises, nothing changed).
        arrs = [self._decode_block(b) for b in blocks]
        # 2. The offered prefix must still match: it can evaporate
        #    between offer and import (LRU reclaim under pressure). The
        #    CURRENT match count rides the error so the shipper re-ships
        #    exactly the missing tail.
        matched = self.match_prefix(list(keys)[:offset])
        if len(matched) < offset:
            raise HandoffError(
                f"offered prefix evaporated: {len(matched)} of {offset} "
                f"block(s) still indexed", matched=len(matched))
        # 3. Capacity, counting revivals as admit_shared does.
        revive = sum(1 for b in matched if b in self._lru)
        needed = nb - offset
        if needed > self.free_blocks - revive:
            raise AdmissionError(
                f"KV pool exhausted: sequence {seq_id!r} needs {needed} "
                f"fresh block(s) beyond {offset} adopted for {length} "
                f"positions, {self.free_blocks - revive} available of "
                f"{self.n_blocks}",
                needed_blocks=needed,
                free_blocks=self.free_blocks - revive)
        # 4. Commit: adopt, write the shipped bytes into fresh blocks,
        #    cover the tail.
        for b in matched:
            if b in self._lru:
                del self._lru[b]
                self._refs[b] = 1
                self.revived_total += 1
            else:
                self._refs[b] += 1
            self._touch_key(b)
        self.adopted_total += len(matched)
        table = list(matched)
        if arrs:
            dsts = [self._alloc_block() for _ in arrs]
            self._scatter(dsts, arrs)
            table.extend(dsts)
        self.imported_total += len(arrs)
        while len(table) < nb:
            table.append(self._alloc_block())
        self._tables[seq_id] = table
        return len(matched)

    def flush_prefix(self) -> int:
        """Unindex every published block and drop every demoted host
        stem (the hot swap's hygiene: their rows were computed under the
        old weights). Cached-tier blocks move to the free list; a block
        still referenced keeps its rows for its sequence but can no
        longer be adopted. Parked records are KEPT: continuity is their
        contract. Returns the entries invalidated (device + host)."""
        n = len(self._index) + len(self._host_index)
        for b in list(self._lru):
            del self._lru[b]
            self._free.append(b)
        self._index.clear()
        self._key_of.clear()
        self._host_index.clear()
        return n

    # -- host tier ---------------------------------------------------------
    @property
    def host_blocks_used(self) -> int:
        """Host-tier occupancy in blocks: demoted stems and every parked
        record's payloads (an encode in flight counts: its extent is
        known at submit)."""
        return len(self._host_index) \
            + sum(r["n"] for r in self._parked.values())

    def _host_reclaim(self, need: int) -> bool:
        """Make room for ``need`` more host payloads by dropping the
        least recently demoted stems. Parked records are never victims:
        parking is a contract with the engine, demotion opportunistic.
        False when the tier cannot hold ``need`` with every stem
        dropped."""
        if need > self.host_blocks:
            return False
        while self.host_blocks_used + need > self.host_blocks \
                and self._host_index:
            self._host_index.popitem(last=False)
        return self.host_blocks_used + need <= self.host_blocks

    def _scatter(self, dsts: Sequence[int],
                 arrs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
        """Write decoded host blocks ``arrs`` into pool blocks ``dsts``:
        one host-to-device copy and one ``index_copy_`` a pool, IN PLACE
        in the stores (a captured step reads their addresses)."""
        idx = torch.as_tensor(list(dsts), dtype=torch.long,
                              device=self.k.device)
        for store, part in ((self.k_store, 0), (self.v_store, 1)):
            host = torch.from_numpy(np.stack([a[part] for a in arrs]))
            src = host.to(store.device).view(store.dtype)
            store.index_copy_(1, idx, src.transpose(0, 1))

    def demote(self, count: int = 1) -> int:
        """Demote up to ``count`` least recently freed cached-tier blocks
        to the host tier: one device-to-host copy a pool, the payloads
        kept under the blocks' chain keys, the device blocks to the LIFO
        free list. Only refcount-0 published blocks live in the cached
        tier, so a live sequence never loses a row. Returns the blocks
        demoted (0 with the tier off or nothing to demote)."""
        if self.host_blocks <= 0 or count <= 0:
            return 0
        victims = list(self._lru)[:count]
        if victims and not self._host_reclaim(len(victims)):
            victims = victims[:max(
                0, self.host_blocks - self.host_blocks_used)]
        if not victims:
            return 0
        raw = self._fetch_raw(victims)
        for b, (kb, vb) in zip(victims, raw):
            key = self._key_of.pop(b)
            self._index.pop(key, None)
            del self._lru[b]
            self._free.append(b)
            self._host_index[key] = _encode_payload(kb, vb)
            self._host_index.move_to_end(key)
        self.demoted_total += len(victims)
        return len(victims)

    def promote(self, keys: Sequence[str]) -> int:
        """Re-stage the host-tier run of ``keys`` that starts where the
        device index stops matching: every payload's CRC is checked
        FIRST (a corrupt host byte raises :class:`HandoffError` with the
        device and host tiers unchanged), then one scatter a pool into
        fresh blocks, indexed refcount 0 in the cached tier. Only the
        LIFO tier is consumed (an allocation through LRU eviction could
        evict, or demote again, the chain being promoted), so under pool
        pressure the run truncates to what fits. Returns the blocks
        promoted."""
        if self.host_blocks <= 0 or not self._host_index:
            return 0
        keys = list(keys)
        start = len(self.match_prefix(keys))
        run: List[str] = []
        for key in keys[start:]:
            if key not in self._host_index:
                break
            run.append(key)
        run = run[:len(self._free)]
        if not run:
            return 0
        arrs = [self._decode_block(self._host_index[k]) for k in run]
        dsts = [self._free.pop() for _ in run]
        self._scatter(dsts, arrs)
        for key, b in zip(run, dsts):
            del self._host_index[key]
            self._index[key] = b
            self._key_of[b] = key
            self._lru[b] = None
            self._lru.move_to_end(b)
        self.promoted_total += len(run)
        return len(run)

    def discard_host(self, keys: Sequence[str]) -> int:
        """Drop the host-tier stems of ``keys``: the recovery after a
        corrupt payload failed :meth:`promote` (the poison entry must not
        fail every later admission; the rows recompute). Returns the
        entries dropped."""
        return sum(self._host_index.pop(key, None) is not None
                   for key in keys)

    def host_keys(self) -> List[str]:
        """Demoted-stem chain keys, least recently demoted first."""
        return list(self._host_index)

    def export_keys(self, keys: Sequence[str]) -> List[Dict[str, Any]]:
        """Wire payloads of the device blocks indexed under ``keys``
        (every key must be indexed: the prefix store persists only
        chains wholly on the device). One batched fetch, read-only."""
        return encode_blocks(self.fetch_keys(keys))

    def fetch_keys(self, keys: Sequence[str]
                   ) -> List[Tuple[memoryview, memoryview]]:
        """Raw host k/v bytes of the device blocks indexed under
        ``keys``: one batched fetch, read-only. A host copy, so
        :func:`encode_blocks` may encode it after the pool moved on."""
        ids: List[int] = []
        for key in keys:
            b = self._index.get(key)
            if b is None:
                raise KeyError(f"chain key {key!r} not indexed")
            ids.append(b)
        return self._fetch_raw(ids)

    def park(self, seq_id: Any, length: int, *,
             keys: Sequence[str] = ()) -> int:
        """Park ``seq_id``: one device-to-host copy a pool of the blocks
        covering ``length`` positions, kept with the full blocks' chain
        ``keys`` (the resume's adoption probe) as a host-tier record,
        then the device reservation is freed. With the async worker
        armed the encode runs off the drive thread; the record's ready
        event gates readers. Raises :class:`AdmissionError` (state
        unchanged) when the tier is off or cannot hold the record: the
        engine then evicts plainly. Returns the blocks parked."""
        if seq_id in self._parked:
            raise ValueError(f"sequence {seq_id!r} is already parked")
        table = self._tables.get(seq_id)
        nb = self.blocks_for(length)
        if table is None or nb > len(table):
            raise ValueError(
                f"cannot park {length} positions for {seq_id!r}: "
                f"{0 if table is None else len(table)} block(s) held")
        keys = [str(k) for k in keys]
        if len(keys) != int(length) // self.block_size:
            raise ValueError(
                f"park needs one chain key per FULL block: got "
                f"{len(keys)} for {length} positions "
                f"(block_size {self.block_size})")
        if self.host_blocks <= 0 or not self._host_reclaim(nb):
            raise AdmissionError(
                f"host tier cannot hold {nb} block(s) for parked "
                f"sequence {seq_id!r} "
                f"({self.host_blocks_used}/{self.host_blocks} used)",
                needed_blocks=nb,
                free_blocks=max(0, self.host_blocks
                                - self.host_blocks_used))
        raw = self._fetch_raw(table[:nb])
        rec: Dict[str, Any] = {"length": int(length), "keys": keys,
                               "n": nb, "ready": threading.Event(),
                               "blocks": None}
        if self._offload is not None:
            self._offload.submit(rec, raw)
        else:
            rec["blocks"] = encode_blocks(raw)
            rec["ready"].set()
        self._parked[seq_id] = rec
        self.free_seq(seq_id)
        self.parked_total += 1
        return nb

    def resume(self, new_id: Any, length: int, parked_id: Any) -> int:
        """Re-admit parked ``parked_id`` as ``new_id`` covering
        ``length`` positions through :meth:`import_blocks`' atomic path:
        the chain-key prefix still on the device is adopted, the rest
        re-staged from the host payloads (CRC-checked before any
        bookkeeping moves), the remainder allocated fresh. The record is
        consumed only on success: a :class:`HandoffError` (host
        corruption) or an :class:`AdmissionError` (pool pressure) leaves
        pool and record unchanged, so the caller can fall back to a
        re-prefill. Returns the device blocks adopted."""
        rec = self._parked.get(parked_id)
        if rec is None:
            raise KeyError(f"no parked sequence {parked_id!r}")
        rec["ready"].wait()
        if self._offload is not None:
            self._offload.check()
        if rec["blocks"] is None:
            raise HandoffError(
                f"parked sequence {parked_id!r} lost its host payloads "
                f"(offload encode failed)", retryable=False)
        keys = rec["keys"]
        matched = len(self.match_prefix(keys))
        adopted = self.import_blocks(new_id, length,
                                     rec["blocks"][matched:], keys=keys,
                                     offset=matched)
        del self._parked[parked_id]
        self.resumed_total += 1
        return adopted

    def unpark(self, parked_id: Any) -> int:
        """Drop a parked record (a diverged conversation, a fallback to
        re-prefill, or a re-park). Idempotent; waits out an encode in
        flight so the record is never orphaned mid-write. Returns the
        host blocks released."""
        rec = self._parked.pop(parked_id, None)
        if rec is None:
            return 0
        rec["ready"].wait()
        return rec["n"]

    def parked_ids(self) -> List[Any]:
        """Parked sequence ids."""
        return list(self._parked)

    def close(self) -> None:
        """Join the async offload worker (whoever builds an async cache
        owns its teardown; a no-op without one)."""
        if self._offload is not None:
            self._offload.close()
            self._offload = None

    # -- speculative tier --------------------------------------------------
    def committed_len(self, seq_id: Any) -> int:
        """The write cursor: positions ``[0, committed_len)`` hold
        verified rows; anything above is a revocable draft."""
        return self._committed.get(seq_id, 0)

    def spec_reserve(self, seq_id: Any, length: int) -> List[int]:
        """Grow ``seq_id``'s table to cover ``length`` positions as a
        REVOCABLE extension that :meth:`rollback` returns. Raises
        :class:`AdmissionError` (state unchanged) on pool pressure. A
        table that already covers ``length`` grows nothing."""
        table = self._tables.setdefault(seq_id, [])
        needed = self.blocks_for(length) - len(table)
        if needed > self.free_blocks:
            raise AdmissionError(
                f"KV pool exhausted: sequence {seq_id!r} needs {needed} "
                f"more block(s) for a {length}-position speculative "
                f"extension, {self.free_blocks} free of {self.n_blocks}",
                needed_blocks=needed, free_blocks=self.free_blocks)
        if needed > 0:
            added = [self._alloc_block() for _ in range(needed)]
            table.extend(added)
            self._spec.setdefault(seq_id, []).extend(added)
        return list(table)

    def commit(self, seq_id: Any, length: int) -> None:
        """Advance the write cursor to ``length`` (never backwards),
        promoting the speculative blocks that cover it to permanent."""
        table = self._tables.get(seq_id, [])
        need = self.blocks_for(length)
        if need > len(table):
            raise ValueError(
                f"cannot commit {length} positions for {seq_id!r}: only "
                f"{len(table)} block(s) reserved "
                f"({len(table) * self.block_size} positions)")
        spec = self._spec.get(seq_id, [])
        promote = max(0, need - (len(table) - len(spec)))
        if promote:
            self._spec[seq_id] = spec[promote:]
        self._committed[seq_id] = max(self._committed.get(seq_id, 0),
                                      int(length))

    def rollback(self, seq_id: Any) -> int:
        """Truncate ``seq_id``'s table to its committed extent: every
        still-speculative block returns in reverse allocation order.
        Speculative blocks are fresh and never published, so a rollback
        never strands a shared block. Returns the blocks freed."""
        spec = self._spec.pop(seq_id, [])
        if spec:
            table = self._tables[seq_id]
            del table[len(table) - len(spec):]
            for b in reversed(spec):
                self._release_block(b)
        return len(spec)

    def free_seq(self, seq_id: Any) -> int:
        """Drop all of ``seq_id``'s references, the speculative tail
        included; returns the table length (0 for an unknown id —
        idempotent eviction). Published blocks whose last holder this
        was retire to the cached tier."""
        self._spec.pop(seq_id, None)
        self._committed.pop(seq_id, None)
        table = self._tables.pop(seq_id, [])
        for b in reversed(table):
            self._release_block(b)
        return len(table)

    def table(self, seq_id: Any) -> List[int]:
        return list(self._tables.get(seq_id, []))

    def owned_blocks(self) -> Dict[Any, List[int]]:
        """Live ownership snapshot (test surface for the alloc/free/reuse
        invariants; tables intersect exactly on shared prefix blocks)."""
        return {sid: list(t) for sid, t in self._tables.items()}

    # -- device-side addressing --------------------------------------------
    def table_array(self, seq_ids: Sequence[Any], nb_max: int) -> np.ndarray:
        """Padded int32 ``[len(seq_ids), nb_max]`` block tables for the
        step's gather (pad entries point at block 0 — gathered bytes
        there are masked by position before any row reads them)."""
        out = np.zeros((len(seq_ids), nb_max), np.int32)
        for i, sid in enumerate(seq_ids):
            t = self._tables.get(sid, [])
            if len(t) > nb_max:
                raise ValueError(
                    f"sequence {sid!r} holds {len(t)} blocks > nb_max="
                    f"{nb_max}")
            out[i, :len(t)] = t
        return out

    def flat_index(self, seq_id: Any, pos: int) -> int:
        """Flat index of position ``pos`` into the
        ``[n_blocks·block_size]``-flattened pool (read addressing; a
        WRITE target goes through :meth:`write_index`)."""
        table = self._tables[seq_id]
        b, r = divmod(int(pos), self.block_size)
        if b >= len(table):
            raise IndexError(
                f"position {pos} beyond sequence {seq_id!r}'s "
                f"{len(table)}-block reservation")
        return table[b] * self.block_size + r

    @property
    def oob_index(self) -> int:
        """One-past-the-pool flat index: rows routed here (padding rows,
        dummy batch slots) land in the sink block at commit and write no
        live row."""
        return self.n_blocks * self.block_size
