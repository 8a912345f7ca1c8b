"""Async checkpoint and restore plane: the counterpart of
:mod:`tony_tpu.ckpt`, writing and reading the reference's on-disk format.

* :class:`AsyncCheckpointer` (:mod:`~tony_tpu_torch.ckpt.snapshot`) — a
  device-side staging copy of the state, a device→host copy into pinned
  host slots on a side stream, and a background writer, so a save costs
  the train loop only the staging copy;
* the crash-consistent on-disk format (:mod:`~tony_tpu_torch.ckpt.format`,
  a copy of the reference's) — per-process shard files and ONE manifest,
  committed by an atomic directory rename;
* the cold-start plane's AOT cache (:mod:`~tony_tpu_torch.ckpt.aot`) —
  the kernel libraries a step family launches, persisted under a
  fingerprint of the toolchain, card and geometry;
* restore (:mod:`~tony_tpu_torch.ckpt.restore`) — into the target's
  tensors in place, host → device from pinned memory, from a checkpoint
  written by the port or by the JAX package, on any world size (under
  data parallelism every rank reads every leaf).

The manifest keys leaves by the reference's ``jax.tree_util.keystr``
paths. The port's live state is an ``nn.Module`` with per-layer
``[out, in]`` weights; its portable form (:func:`encode_portable`) views
those tensors in the reference's paths, shapes and layout
(:class:`~tony_tpu_torch.ckpt.snapshot.LeafView`: stacked over layers,
flax's ``[in, out]``), so the files are the JAX package's files.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from tony_tpu_torch.ckpt.aot import (AOTCache, fingerprint_key,
                                     make_fingerprint, tree_digest)
from tony_tpu_torch.ckpt.format import (FORMAT_VERSION, ChunkReader,
                                        committed_steps, latest_step, prune,
                                        read_manifest, step_dir)
from tony_tpu_torch.ckpt.restore import (find_path_prefix, restore_latest,
                                         restore_pytree)
from tony_tpu_torch.ckpt.snapshot import (AsyncCheckpointer, Snapshot,
                                          extract_snapshot, write_snapshot)

# ---------------------------------------------------------------------------
# Portable-form codecs: a plane whose LIVE state layout differs from the
# manifest's registers an encode/decode pair here, so what the manifest
# records is the PORTABLE form (the reference's leaf paths and shapes).
# ``train_loop`` encodes every payload before save and decodes after
# restore; trees no codec claims pass through untouched.
# ---------------------------------------------------------------------------

PORTABLE_CODECS: List[Tuple[str, Callable[[Any], bool],
                            Callable[[Any], Any],
                            Callable[[Any, Any], Any]]] = []


def register_portable_codec(name: str, predicate: Callable[[Any], bool],
                            encode: Callable[[Any], Any],
                            decode: Callable[[Any, Any], Any], *,
                            prepend: bool = False) -> None:
    """Register ``(predicate, encode, decode)`` under ``name`` (replacing
    an earlier registration of the same name). ``encode(tree) -> portable
    tree``; ``decode(tree, mesh) -> live tree``. First matching codec
    wins; ``prepend`` puts this one first (a codec that composes with
    another one's trees, as the quantized-gather codec does)."""
    PORTABLE_CODECS[:] = [c for c in PORTABLE_CODECS if c[0] != name]
    entry = (name, predicate, encode, decode)
    if prepend:
        PORTABLE_CODECS.insert(0, entry)
    else:
        PORTABLE_CODECS.append(entry)


def encode_portable(tree: Any) -> Any:
    """Apply the first matching codec's encode; identity otherwise."""
    for _, predicate, encode, _ in PORTABLE_CODECS:
        if predicate(tree):
            return encode(tree)
    return tree


def decode_portable(tree: Any, mesh: Optional[Any] = None) -> Any:
    """Apply the first matching codec's decode; identity otherwise."""
    for _, predicate, _, decode in PORTABLE_CODECS:
        if predicate(tree):
            return decode(tree, mesh)
    return tree


__all__ = [
    "AOTCache", "FORMAT_VERSION", "AsyncCheckpointer", "ChunkReader", "Snapshot",
    "committed_steps", "decode_portable", "encode_portable",
    "extract_snapshot", "find_path_prefix", "fingerprint_key",
    "latest_step", "make_fingerprint", "prune",
    "read_manifest", "register_portable_codec", "restore_latest",
    "restore_pytree", "step_dir", "tree_digest", "write_snapshot",
]
