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

Capacity failures are a typed :class:`AdmissionError` carrying the
needed/free block counts — back-pressure the engine acts on, not an
allocator OOM. The host-offload tier (parking, demotion) and the wire
tier (``export_blocks``/``import_blocks``) of the JAX package come with
a later slice (ROADMAP.md, queue 1 item 9).

Threading contract: the allocator is not internally locked; the
engine's single drive thread (``EngineFront`` serializes callers)
performs every mutation.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from tony_tpu_torch import resolve_device


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
        # Speculative tier: per-sequence blocks added by spec_reserve
        # and not yet promoted by a commit, and the write cursor (the
        # positions below it hold verified rows).
        self._spec: Dict[Any, List[int]] = {}
        self._committed: Dict[Any, int] = {}

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
        the least recently freed cached block, unindexed. Callers check
        capacity first."""
        if self._free:
            b = self._free.pop()
        else:
            b, _ = self._lru.popitem(last=False)
            key = self._key_of.pop(b, None)
            if key is not None:
                self._index.pop(key, None)
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

    def flush_prefix(self) -> int:
        """Unindex every published block (the hot swap's hygiene: their
        rows were computed under the old weights). Cached-tier blocks
        move to the free list; a block still referenced keeps its rows
        for its sequence but can no longer be adopted. Returns the
        entries invalidated."""
        n = len(self._index)
        for b in list(self._lru):
            del self._lru[b]
            self._free.append(b)
        self._index.clear()
        self._key_of.clear()
        return n

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
