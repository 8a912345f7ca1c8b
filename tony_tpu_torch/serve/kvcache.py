"""Paged KV cache: a fixed-size block pool with per-sequence block tables
(the core of :mod:`tony_tpu.serve.kvcache`).

The pool is two device tensors ``[n_layers, n_blocks, block_size,
kv_dim]`` (k and v); a sequence owns an ordered list of block ids (its
*block table*) covering positions ``[0, len)`` — position ``p`` lives at
row ``p % block_size`` of block ``table[p // block_size]``. Allocation
is host-side bookkeeping only (a LIFO free list of ids and per-block
refcounts); the engine's step writes the tensors in place through flat
indices the allocator hands out. Blocks are NOT zeroed on free/realloc:
every position is written before any query can attend it (the
flash-decode mask admits key ``j`` only for rows at position ``>= j``),
so stale bytes are never read.

Capacity failures are a typed :class:`AdmissionError` carrying the
needed/free block counts — back-pressure the engine acts on, not an
allocator OOM. The prefix, speculative, host-offload and wire tiers of
the JAX package come with later slices.

Threading contract: the allocator is not internally locked; the
engine's single drive thread (``EngineFront`` serializes callers)
performs every mutation.
"""

from __future__ import annotations

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
        shape = (self.n_layers, self.n_blocks, self.block_size, self.kv_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        # LIFO free list: a just-freed block is the next handed out, so
        # the reuse invariants get exercised constantly.
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._tables: Dict[Any, List[int]] = {}
        self._refs: Dict[int, int] = {}

    # -- capacity ----------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Blocks available to a new reservation."""
        return len(self._free)

    def blocks_for(self, length: int) -> int:
        """Blocks covering ``length`` positions."""
        return -(-max(0, int(length)) // self.block_size)

    def _release_block(self, b: int) -> None:
        self._refs[b] -= 1
        if self._refs[b] == 0:
            del self._refs[b]
            self._free.append(b)

    # -- allocation --------------------------------------------------------
    def reserve(self, seq_id: Any, length: int) -> List[int]:
        """Grow ``seq_id``'s table to cover ``length`` positions; raises
        :class:`AdmissionError` (state unchanged) when the pool can't
        supply the growth. The engine reserves a request's FULL extent
        (prompt + max new tokens) at admission, so decode can never hit
        pool exhaustion mid-flight."""
        table = self._tables.setdefault(seq_id, [])
        needed = self.blocks_for(length) - len(table)
        if needed > self.free_blocks:
            raise AdmissionError(
                f"KV pool exhausted: sequence {seq_id!r} needs {needed} "
                f"more block(s) for {length} positions, "
                f"{self.free_blocks} free of {self.n_blocks}",
                needed_blocks=needed, free_blocks=self.free_blocks)
        for _ in range(max(0, needed)):
            b = self._free.pop()
            self._refs[b] = 1
            table.append(b)
        return list(table)

    def write_index(self, seq_id: Any, pos: int) -> int:
        """Flat index of position ``pos`` FOR WRITING. Every KV scatter
        target goes through here; without the prefix tier no block is
        shared, so it is the read address (the prefix tier adds
        copy-on-write for shared blocks here)."""
        return self.flat_index(seq_id, pos)

    def free_seq(self, seq_id: Any) -> int:
        """Drop all of ``seq_id``'s references; returns the table length
        (0 for an unknown id — idempotent eviction)."""
        table = self._tables.pop(seq_id, [])
        for b in reversed(table):
            self._release_block(b)
        return len(table)

    def table(self, seq_id: Any) -> List[int]:
        return list(self._tables.get(seq_id, []))

    def owned_blocks(self) -> Dict[Any, List[int]]:
        """Live ownership snapshot (test surface for the alloc/free/reuse
        invariants)."""
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
        dummy batch slots) write nothing at commit."""
        return self.n_blocks * self.block_size
