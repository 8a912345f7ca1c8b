"""Disaggregated prefill/decode: the counterpart of
:mod:`tony_tpu.serve.disagg`, split-role serving with KV-block handoff
over the RPC wire.

A prefill burst and the running decode batch contend for one card when
they share a replica. This module splits the two phases onto separate
replica ROLES:

* a **prefill replica** runs the prompt through the engine's normal
  admission and prefill launches and emits the FIRST token — its output
  is KV + one token, never a generation loop
  (:meth:`~tony_tpu_torch.serve.engine.ServeEngine.prefill_only`);
* the sequence's KV blocks ship over the wire — the paged pool's raw
  per-block bytes plus the prefix chain keys ARE the wire format
  (:meth:`~tony_tpu_torch.serve.kvcache.PagedKVCache.export_blocks`, a
  CRC32 per block), byte for byte the JAX package's, so a block exported
  by either package imports into the other;
* a **decode replica** imports them into its OWN pool
  (:meth:`~tony_tpu_torch.serve.kvcache.PagedKVCache.import_blocks` —
  typed and state-unchanged on failure, composing with the prefix tier
  so a shipped stem the receiver already holds is adopted, not
  re-transferred: the shipper first ``kv_offer``-s the chain keys and
  ships only the blocks past the receiver's match) and continues the
  generation in its continuous batch.

Bitwise contract: the imported bytes are exactly the bytes the prefill
wrote (device → host → wire → host → device is lossless in the pool
dtype, CRC-gated), and both engines launch the same programs at the
same shapes, so the split engines' tokens AND per-token logits equal the
colocated engine's (``tests/test_torch_disagg.py``).

Failure semantics: a decode pool under pressure rejects the import with
the cache untouched; :class:`KVShipper` retries with bounded backoff and
raises a typed :class:`HandoffError` when the budget is spent — the
router then falls back to COLOCATED prefill on the decode replica.

Free of any tensor library on purpose: the router imports
:class:`HandoffError` on a gateway host with no accelerator stack, and
the fronts only *hold* an engine-backed
:class:`~tony_tpu_torch.serve.engine.EngineFront`. Every pool mutation
of the handoff path (the prefill-side export, the decode-side import,
both arriving on RPC receiver threads) happens under the owning front's
drive lock, the lock that serializes ``generate`` callers.
"""

from __future__ import annotations

import base64
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class HandoffError(RuntimeError):
    """The KV handoff cannot complete: a CRC/geometry mismatch on the
    wire payload, an offered prefix that evaporated before import, or a
    shipping budget spent against a decode pool under pressure.
    ``retryable`` mirrors :class:`~tony_tpu_torch.serve.kvcache.
    AdmissionError`'s flag; ``matched`` (when set) is the receiver's
    CURRENT prefix-match count so a retry re-ships exactly the missing
    tail instead of starting a fresh offer round."""

    def __init__(self, message: str, *, retryable: bool = True,
                 matched: Optional[int] = None):
        super().__init__(message)
        self.retryable = retryable
        self.matched = matched


def encode_f32(row: np.ndarray) -> str:
    """Wire form of one f32 logits row (the prefill-side first-token
    row a ``keep_logits`` engine ships so the decode side's Completion
    carries every per-token row)."""
    return base64.b64encode(
        np.ascontiguousarray(row, np.float32).tobytes()).decode("ascii")


def decode_f32(data: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(data), np.float32).copy()


def _classify(exc: Exception) -> tuple:
    """``(retryable, matched)`` of one shipping failure. Typed errors
    carry their own flags; wire errors (an RpcError string from the
    decode replica) are recognized by the transported type prefix — the
    JSON-lines RPC wraps application errors as ``"<TypeName>:
    <message>"`` — and treated as retryable: the retry budget is bounded
    either way, and a request that never fits fails identically on the
    colocated fallback."""
    if isinstance(exc, HandoffError):
        return exc.retryable, exc.matched
    retryable = getattr(exc, "retryable", None)
    if retryable is not None:           # AdmissionError without the import
        return bool(retryable), None
    msg = str(exc)
    if msg.startswith(("AdmissionError:", "HandoffError:")):
        return True, None
    if isinstance(exc, OSError):
        # Transport fault mid-handoff: the import may or may not have
        # landed; re-offer from scratch (a landed import makes the
        # retry's fresh-admission check fail loudly).
        return True, None
    return False, None


class KVShipper:
    """The prefill-side half of the handoff protocol: offer the chain
    keys, ship only the unmatched block tail, retry with bounded
    backoff, and raise a typed :class:`HandoffError` when the budget is
    spent — one slow importer cannot wedge the prefill gang (its engine
    already freed the sequence's blocks before shipping begins)."""

    def __init__(self, *, max_attempts: int = 3, backoff_s: float = 0.05):
        if max_attempts < 1:
            raise ValueError(f"need max_attempts >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)

    def ship(self, handoff: Dict[str, Any], decode: Any) -> tuple:
        """Offer/import ``handoff`` against ``decode`` (anything with
        ``kv_offer(keys=...) -> int`` and ``kv_import(payload=...)``,
        an in-process :class:`DecodeFront` or an RPC dial). Returns
        ``(completion, shipped_blocks)`` — the decode side's completion
        (it drives its engine until the resumed generation finishes)
        and the block count that crossed the wire on the final attempt.
        Returned, not stashed on ``self``: one shipper serves concurrent
        ``prefill_handoff`` callers.

        Known edge: a transport fault AFTER the decode side committed
        the import leaves that sequence decoding on the receiver — the
        retry's rid-collision check rejects typed, the router falls
        back colocated, and the orphaned generation completes on the
        receiver's own handler thread and is dropped there: bounded
        duplicated decode work, never a wedge, a leak or a wrong
        answer."""
        keys: List[str] = list(handoff.get("keys") or ())
        blocks = list(handoff.get("blocks") or ())
        offset: Optional[int] = None
        last: Optional[Exception] = None
        attempts = 0
        for attempt in range(self.max_attempts):
            attempts = attempt + 1
            if attempt:
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            try:
                if offset is None:
                    offset = min(max(0, int(decode.kv_offer(keys=keys))),
                                 len(blocks))
                payload = dict(handoff, offset=offset,
                               blocks=blocks[offset:])
                out = decode.kv_import(payload=payload)
                return out, len(blocks) - offset
            except Exception as e:  # noqa: BLE001 — classified below
                last = e
                retryable, matched = _classify(e)
                if not retryable:
                    break
                # A stale offer re-ships the now-missing tail; anything
                # else re-offers from scratch.
                offset = matched if matched is not None \
                    and not isinstance(e, OSError) else None
        raise HandoffError(
            f"KV handoff failed after {attempts} attempt(s): "
            f"{last}", retryable=False) from last


class DecodeFront:
    """The decode replica's receiver half over one shared
    :class:`~tony_tpu_torch.serve.engine.EngineFront`: ``kv_offer``
    answers the shipper's prefix probe, ``kv_import`` admits the shipped
    sequence into the engine and drives the shared loop until its
    generation completes (the ``generate`` discipline — overlapping
    handoffs and colocated requests ride one continuous batch). Every
    cache mutation happens under the front's drive lock."""

    def __init__(self, front: Any):
        self.front = front

    def kv_offer(self, keys: Sequence[str]) -> int:
        with self.front._drive:
            return len(self.front.engine.cache.match_prefix(
                [str(k) for k in keys]))

    def kv_import(self, payload: Dict[str, Any]) -> Any:
        with self.front._drive:
            rid, done = self.front.engine.admit_handoff(payload)
        if done is not None:
            return done
        return self.front._drive_until(rid)

    def generate(self, tokens: Sequence[int], max_new_tokens: int,
                 rid: Optional[Any] = None,
                 conv: Optional[Any] = None,
                 tenant: Optional[str] = None) -> Any:
        """The colocated fallback path (the decode engine prefills for
        itself when a handoff could not be placed)."""
        return self.front.generate(tokens, max_new_tokens, rid=rid,
                                   conv=conv, tenant=tenant)


class PrefillFront:
    """The prefill replica's shipper half over one shared
    :class:`~tony_tpu_torch.serve.engine.EngineFront`: run the
    prefill-only engine mode under the drive lock, then ship the
    exported KV to the decode target OUTSIDE it — the prefill engine is
    free for the next prompt the moment its blocks are exported.
    ``decode`` is an in-process :class:`DecodeFront` or a ``host:port``
    address (dialed over the control-plane RPC)."""

    def __init__(self, front: Any, *, shipper: Optional[KVShipper] = None,
                 dial_timeout_s: float = 15.0):
        self.front = front
        self.shipper = shipper or KVShipper()
        self.dial_timeout_s = float(dial_timeout_s)

    def prefill_handoff(self, tokens: Sequence[int], max_new_tokens: int,
                        rid: Optional[Any] = None,
                        decode: Any = None,
                        conv: Optional[Any] = None,
                        tenant: Optional[str] = None) -> Any:
        if decode is None:
            raise ValueError("prefill_handoff needs a decode target "
                             "(a DecodeFront or a host:port address)")
        if isinstance(decode, str):
            decode = _dial_decode(decode, self.dial_timeout_s)
        from tony_tpu_torch.serve.engine import Request
        from tony_tpu_torch.serve.kvcache import AdmissionError

        if rid is None:
            rid = self.front.fresh_rid()
        eng = self.front.engine
        with self.front._drive:
            try:
                handoff = eng.prefill_only(Request(
                    rid=rid, tokens=[int(t) for t in tokens],
                    max_new_tokens=int(max_new_tokens), conv=conv,
                    tenant=tenant))
            except AdmissionError as e:
                if not getattr(e, "retryable", True):
                    raise               # never fits: same as colocated submit
                # Transient PREFILL-pool pressure: prefill_only has no
                # queue to park the request in — re-type as a
                # non-retryable HandoffError so the router's fallback
                # runs colocated prefill on the decode replica.
                raise HandoffError(
                    f"prefill pool pressure for {rid!r}: {e}",
                    retryable=False) from e
        # Counters bank on the ENGINE through a locked helper (concurrent
        # prefill_handoff callers would tear a bare `+=`). Failed ships
        # bank nothing here: the importer's rejections count as the
        # decode side's imports_failed.
        out, shipped = self.shipper.ship(handoff, decode)
        eng.note_handoff_shipped(shipped)
        return out

    def generate(self, tokens: Sequence[int], max_new_tokens: int,
                 rid: Optional[Any] = None,
                 conv: Optional[Any] = None,
                 tenant: Optional[str] = None) -> Any:
        return self.front.generate(tokens, max_new_tokens, rid=rid,
                                   conv=conv, tenant=tenant)


def _dial_decode(address: str, timeout: float) -> Any:
    """RPC transport to a decode replica's receiver verbs (imported
    lazily: the RPC stack loads only when a network decode target is
    dialed)."""
    from tony_tpu_torch.rpc import RpcClient

    class _Decode:
        def kv_offer(self, keys):
            with RpcClient(address, timeout=timeout) as client:
                return client.call("kv_offer", keys=list(keys))

        def kv_import(self, payload):
            with RpcClient(address, timeout=timeout) as client:
                return client.call("kv_import", payload=payload)

        def generate(self, tokens, max_new_tokens, rid=None, conv=None,
                     tenant=None):
            with RpcClient(address, timeout=timeout) as client:
                return client.call("generate", tokens=list(tokens),
                                   max_new_tokens=int(max_new_tokens),
                                   rid=rid, conv=conv, tenant=tenant)

    return _Decode()
