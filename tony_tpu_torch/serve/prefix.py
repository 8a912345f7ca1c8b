"""Block-level prefix hashing: the content-address scheme of the prefix
cache (:mod:`tony_tpu_torch.serve.kvcache`) and of the control plane's
cross-replica router. A copy of :mod:`tony_tpu.serve.prefix`: the router
hashes a prompt with its own ``chain_keys`` and matches the keys against
the digest a port replica publishes, so both must derive the identical
key from the identical tokens (``tests/test_torch_route.py`` holds the
copy to the original).

A KV row at position ``p`` depends on the ENTIRE token prefix
``tokens[0..p]``, so a cached block is only reusable when the whole
prefix up to its last position matches. The block key is therefore a
CHAIN hash: ``key_i = H(key_{i-1} || tokens of block i)``, over
block-aligned chunks only (a partial tail block is never addressable).
Deterministic across processes (blake2b over the token bytes, not
Python's randomized ``hash``).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

# 64-bit hex keys: short enough that a few hundred ride a JSON heartbeat
# as the replica digest, long enough that a collision (which would serve
# the WRONG cached prefix) is a non-event at pool scale (~2^-64 per
# pair; a pool holds thousands of blocks, not billions).
KEY_HEX = 16
_ROOT = "tony-prefix-v1"


def chain_keys(tokens: Sequence[int], block_size: int, *,
               prior: str = "") -> List[str]:
    """Chain keys of every FULL ``block_size``-aligned block of
    ``tokens``; ``prior`` continues an existing chain (the engine
    extends a sequence's chain incrementally as generation fills
    blocks, without rehashing the history)."""
    if block_size <= 0:
        raise ValueError(f"need positive block_size, got {block_size}")
    keys: List[str] = []
    h = prior or _ROOT
    for start in range(0, len(tokens) - block_size + 1, block_size):
        blk = tokens[start:start + block_size]
        m = hashlib.blake2b(digest_size=KEY_HEX // 2)
        m.update(h.encode())
        m.update(b"|")
        m.update(",".join(str(int(t)) for t in blk).encode())
        h = m.hexdigest()
        keys.append(h)
    return keys


def match_overlap(prompt_keys: Sequence[str], digest: Sequence[str]) -> int:
    """Longest PREFIX of ``prompt_keys`` present in ``digest`` (a
    replica's advertised block-key set) — the router's cache-overlap
    score, in blocks. Prefix, not intersection: chain keys make an
    interior hit without its ancestors impossible on the replica, so a
    gap means the digest aged the ancestor out and the chain below it
    is unusable."""
    have = set(digest)
    n = 0
    for k in prompt_keys:
        if k not in have:
            break
        n += 1
    return n
