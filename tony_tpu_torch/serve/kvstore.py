"""Persistent prefix store: hot published KV stems on disk, keyed by
chain key (the port's copy of :mod:`tony_tpu.serve.kvstore`; standard
library only, so a store written by either package loads into the
other).

A fleet's hottest KV bytes are its shared prompt stems (system prompts,
few-shot preambles), content-addressed by the prefix tier's chain keys
(:mod:`tony_tpu_torch.serve.prefix`). The prefix tier dies with its
replica; this store persists stems so a fresh replica warms from disk
instead of recomputing them:

* one directory per stem, ``stem_<tip>/``, where ``<tip>`` is the
  chain's LAST key (the chain hash makes the tip name the whole chain);
* inside, ``blocks.bin`` (each block's raw k bytes then v bytes) and a
  ``stem.json`` manifest with the chain keys, the pool geometry header
  and a chunk table ``{offset, nbytes, k_nbytes, crc32}`` a block; the
  CRC equals the wire payload's ``crc32(k_bytes + v_bytes)``, so one
  checksum guards a block from the device fetch through disk and back;
* commit is stage and rename: both files are written (fsynced) into
  ``stem_<tip>.tmp`` and ``os.replace``d into place, so a crashed writer
  leaves a ``.tmp`` orphan, never half a stem (the checkpoint plane's
  writes, :mod:`tony_tpu_torch.ckpt_layout`), and
  :meth:`PrefixStore.get` checks every chunk's CRC on read.
"""

from __future__ import annotations

import base64
import json
import os
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from tony_tpu_torch.ckpt_layout import (TMP_SUFFIX, _atomic_write_json,
                                         _fsync_dir)

_PREFIX = "stem_"
FORMAT = "tony-kvstem-v1"


class PrefixStore:
    """One directory of persisted KV stems (module docstring).

    ``put`` and ``get`` speak the wire's block payload form, ``{"k": b64,
    "v": b64, "crc": int}``, so the cache's export
    (:meth:`~tony_tpu_torch.serve.kvcache.PagedKVCache.export_keys`) and
    the engine's import (:meth:`~tony_tpu_torch.serve.engine.ServeEngine.
    adopt_stem`) are the store's serialization, CRC check included."""

    def __init__(self, root: str) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _dir(self, tip: str) -> Path:
        return self.root / f"{_PREFIX}{tip}"

    def stems(self) -> List[str]:
        """Committed stem tips, sorted (``.tmp`` orphans excluded)."""
        return [e[len(_PREFIX):] for e in sorted(os.listdir(self.root))
                if e.startswith(_PREFIX) and not e.endswith(TMP_SUFFIX)]

    def put(self, keys: Sequence[str], blocks: Sequence[Dict[str, Any]],
            header: Dict[str, Any]) -> bool:
        """Persist one stem: ``keys`` the chain, ``blocks`` its wire
        payloads, ``header`` the pool geometry (:meth:`~tony_tpu_torch.
        serve.kvcache.PagedKVCache.wire_header`). Idempotent per tip: a
        committed stem is immutable and a second put returns False.
        Every payload's CRC is checked BEFORE any byte lands on disk; a
        corrupt payload raises ``ValueError`` with nothing written."""
        keys = [str(k) for k in keys]
        if not keys or len(keys) != len(blocks):
            raise ValueError(f"stem needs one payload per chain key: "
                             f"{len(keys)} key(s), {len(blocks)} block(s)")
        final = self._dir(keys[-1])
        if final.exists():
            return False
        raws: List[bytes] = []
        table: List[Dict[str, Any]] = []
        offset = 0
        for i, blk in enumerate(blocks):
            kb = base64.b64decode(blk["k"])
            vb = base64.b64decode(blk["v"])
            crc = zlib.crc32(kb + vb) & 0xFFFFFFFF
            if crc != int(blk["crc"]):
                raise ValueError(
                    f"stem block {i} CRC mismatch (got {crc:#010x}, "
                    f"payload claims {int(blk['crc']):#010x}) — "
                    f"refusing to persist corrupt KV")
            raws.append(kb + vb)
            table.append({"offset": offset, "nbytes": len(kb) + len(vb),
                          "k_nbytes": len(kb), "crc32": crc})
            offset += len(kb) + len(vb)
        staging = Path(f"{final}{TMP_SUFFIX}")
        staging.mkdir(parents=True, exist_ok=True)
        with open(staging / "blocks.bin", "wb") as f:
            for raw in raws:
                f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        _atomic_write_json(staging / "stem.json", {
            "format": FORMAT, "keys": keys,
            "header": dict(header), "chunks": table})
        os.replace(staging, final)
        _fsync_dir(self.root)
        return True

    def get(self, tip: str) -> Optional[Dict[str, Any]]:
        """One stem back in wire form, ``{"keys": [...], "header": {...},
        "blocks": [payloads]}``, ready for ``adopt_stem``. Every chunk's
        CRC is checked on read; a corrupt or missing stem returns
        ``None`` (the store is a warm-start cache: a bad entry means
        recompute, never a crash)."""
        d = self._dir(tip)
        try:
            with open(d / "stem.json") as f:
                manifest = json.load(f)
            if manifest.get("format") != FORMAT:
                return None
            blocks: List[Dict[str, Any]] = []
            with open(d / "blocks.bin", "rb") as f:
                for chunk in manifest["chunks"]:
                    f.seek(int(chunk["offset"]))
                    raw = f.read(int(chunk["nbytes"]))
                    if len(raw) != int(chunk["nbytes"]) or \
                            (zlib.crc32(raw) & 0xFFFFFFFF) \
                            != int(chunk["crc32"]):
                        return None
                    kn = int(chunk["k_nbytes"])
                    blocks.append({
                        "k": base64.b64encode(raw[:kn]).decode("ascii"),
                        "v": base64.b64encode(raw[kn:]).decode("ascii"),
                        "crc": int(chunk["crc32"])})
            return {"keys": list(manifest["keys"]),
                    "header": dict(manifest["header"]),
                    "blocks": blocks}
        except (OSError, ValueError, KeyError, TypeError):
            return None
