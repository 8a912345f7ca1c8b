"""Speculative decoding lane: draft and verify over the serving plane,
the counterpart of :mod:`tony_tpu.serve.spec`.

1. A **draft lane** proposes ``k`` tokens: a second model over its own
   paged pool (:class:`ModelDraft`, restored by the replica through the
   same params-only path as the target) or the self-drafting n-gram
   lookup (:class:`NgramDraft`, no second model, no forwards).
2. The **target verifies all k+1 positions in ONE launch**: the same
   ``(b, q_block)`` step the decode loop runs, with k+1 real rows a
   sequence instead of 1, so flash-decode (row 9) runs once a layer a
   verify forward.
3. **Greedy accept/reject**: draft token ``d_j`` is accepted iff it
   equals the target's argmax at the row before it; the first rejected
   row's own argmax is emitted as the bonus token. Every emitted token
   is the one sequential greedy decode would emit from the same rows.
4. **Rollback moves no byte**: the verify launch writes all k+1
   candidate rows into the pool, then the write cursor rolls back to the
   accepted length (:meth:`PagedKVCache.commit` /
   :meth:`~PagedKVCache.rollback`). Rejected rows sit above every
   committed position and are overwritten before any query reads them.

With per-token acceptance rate α and depth k, tokens per target launch
is ``(1 - α^{k+1}) / (1 - α)``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from tony_tpu_torch import profiler
from tony_tpu_torch.serve.engine import (Completion, PagedModelRunner,
                                         ServeEngine, _bucket_of, _Seq)
from tony_tpu_torch.serve.kvcache import AdmissionError


class NgramDraft:
    """Self-drafting n-gram proposer (prompt lookup): the continuation
    after the most recent earlier occurrence of the sequence's longest
    matched suffix, else the last token repeated. Host-side, zero
    forwards."""

    kind = "ngram"
    forwards = 0                       # never launches anything

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"{min_n}/{max_n}")
        self.max_n = int(max_n)
        self.min_n = int(min_n)
        # rid -> ([{ngram: next} per n], indexed length): the persistent
        # index over the REAL history, extended as verified tokens
        # arrive (most recent occurrence wins).
        self._index: Dict[Any, Any] = {}

    def _seq_index(self, s: _Seq):
        """The sequence's index, extended over tokens appended since the
        last round (drafted tokens never enter it)."""
        hist = s.tokens
        index, done = self._index.get(s.rid) or (
            [{} for _ in range(self.max_n + 1)], 0)
        for pos in range(done, len(hist)):
            nxt = hist[pos]
            for n in range(self.min_n, min(self.max_n, pos) + 1):
                index[n][tuple(hist[pos - n:pos])] = nxt
        self._index[s.rid] = (index, len(hist))
        return index

    def propose(self, seqs: Sequence[_Seq],
                ks: Sequence[int]) -> List[List[int]]:
        out: List[List[int]] = []
        for s, k in zip(seqs, ks):
            index = self._seq_index(s)
            hist = list(s.tokens)
            # This round's draft grams: newer than the persistent index
            # (they win lookups) but dropped with the round.
            overlay: List[Dict[tuple, int]] = [
                {} for _ in range(self.max_n + 1)]
            drafts: List[int] = []
            for _ in range(k):
                nxt = None
                for n in range(min(self.max_n, len(hist) - 1),
                               self.min_n - 1, -1):
                    gram = tuple(hist[-n:])
                    nxt = overlay[n].get(gram, index[n].get(gram))
                    if nxt is not None:
                        break
                if nxt is None:
                    nxt = hist[-1]     # no match: repeat the last token
                drafts.append(nxt)
                hist.append(nxt)
                m = len(hist) - 1
                for n in range(self.min_n, min(self.max_n, m) + 1):
                    overlay[n][tuple(hist[m - n:m])] = nxt
            out.append(drafts)
        return out

    def observe(self, seqs: Sequence[_Seq]) -> None:
        # Accepted tokens enter the index on the next propose.
        pass

    def evict(self, seq: _Seq) -> None:
        self._index.pop(seq.rid, None)


class ModelDraft(PagedModelRunner):
    """A second transformer as the draft lane, over its OWN paged pool
    through the same step functions as the target
    (:class:`~tony_tpu_torch.serve.engine.PagedModelRunner`, with the
    target's AOT cache: the draft resolves and warms its own family).
    The model must live on the engine's device; its pool is allocated
    there beside the target's.

    The draft pool is reserved lazily: the permanent reservation follows
    the verified extent, each proposal round rides a revocable
    :meth:`~PagedKVCache.spec_reserve` extension, and the post-verify
    commit/rollback truncates it to the accepted length. An accepted
    draft token equals the target's argmax, so the draft rows of
    accepted positions were fed true tokens and survive the rollback."""

    kind = "model"

    def __init__(self, model: Any, *, ctx_max: int, block_size: int = 16,
                 q_block: int = 16, decode_buckets: Sequence[int] = (4, 16),
                 max_running: int = 16, n_blocks: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 aot_cache: Optional[Any] = None,
                 kernel_dir: Optional[str] = None):
        self._init_paged(model, ctx_max=ctx_max, block_size=block_size,
                         q_block=q_block, decode_buckets=decode_buckets,
                         max_running=max_running, n_blocks=n_blocks,
                         device=device, aot_cache=aot_cache,
                         kernel_dir=kernel_dir)
        self._cursor: Dict[Any, int] = {}

    def _sync(self, seq: _Seq) -> bool:
        """Catch the draft pool up to the verified extent: feed
        ``tokens[cursor:p0]`` (all but the newest, not yet fed token) as
        one padded launch. False (the sequence drafts nothing this
        round) when the draft pool cannot hold the extent."""
        rid = seq.rid
        p0 = len(seq.tokens) - 1
        c = self._cursor.get(rid, 0)
        if c >= p0:
            return True
        try:
            self.cache.reserve(rid, p0)       # permanent: verified rows
        except AdmissionError:
            return False
        t_real = p0 - c
        t_pad = -(-t_real // self.q_block) * self.q_block
        tokens = np.zeros((1, t_pad), np.int32)
        tokens[0, :t_real] = seq.tokens[c:p0]
        positions = (c + np.arange(t_pad, dtype=np.int32))[None].copy()
        tables = self.cache.table_array([rid], self.nb_max)
        flat = np.full((1, t_pad), self.cache.oob_index, np.int32)
        for j in range(t_real):
            flat[0, j] = self.cache.flat_index(rid, c + j)
        self._run_fn(1, t_pad, tokens, positions, tables, flat)
        self._cursor[rid] = p0
        return True

    def propose(self, seqs: Sequence[_Seq],
                ks: Sequence[int]) -> List[List[int]]:
        """``k`` batched greedy decode steps over the draft pool; step 0
        feeds the target's newest token, each later step the previous
        step's argmax. Draft-pool pressure degrades per sequence to an
        empty proposal (a plain decode row that round), never raises."""
        ks = [k if self._sync(s) else 0 for s, k in zip(seqs, ks)]
        for i, (s, k) in enumerate(zip(seqs, ks)):
            if k:
                try:
                    # Revocable coverage of the k fed rows p0 .. p0+k-1.
                    self.cache.spec_reserve(s.rid, len(s.tokens) - 1 + k)
                except AdmissionError:
                    ks[i] = 0
        n = len(seqs)
        b = _bucket_of(self.decode_buckets, n)
        t = self.q_block
        drafts: List[List[int]] = [[] for _ in seqs]
        cur = [s.tokens[-1] for s in seqs]
        tables = np.zeros((b, self.nb_max), np.int32)
        tables[:n] = self.cache.table_array([s.rid for s in seqs],
                                            self.nb_max)
        for j in range(max(ks, default=0)):
            tokens = np.zeros((b, t), np.int32)
            positions = np.zeros((b, t), np.int32)
            flat = np.full((b, t), self.cache.oob_index, np.int32)
            for i, s in enumerate(seqs):
                pj = len(s.tokens) - 1 + j
                tokens[i, 0] = cur[i]
                positions[i] = pj + np.arange(t, dtype=np.int32)
                if j < ks[i]:
                    flat[i, 0] = self.cache.flat_index(s.rid, pj)
            logits = self._run_fn(b, t, tokens, positions, tables, flat)
            rows = logits[:n, 0].cpu().numpy()
            for i in range(n):
                if j < ks[i]:
                    nxt = int(np.argmax(rows[i]))
                    drafts[i].append(nxt)
                    cur[i] = nxt
        for s, k in zip(seqs, ks):
            if k:
                self._cursor[s.rid] = len(s.tokens) - 1 + k
        return drafts

    def observe(self, seqs: Sequence[_Seq]) -> None:
        """After the verify round appended the accepted prefix and the
        bonus token: roll the draft cursor back to the longest fed
        prefix still true, returning the rejected rows' blocks."""
        for s in seqs:
            rid = s.rid
            c = min(self._cursor.get(rid, 0), len(s.tokens) - 1)
            self.cache.commit(rid, c)
            self.cache.rollback(rid)
            self._cursor[rid] = c

    def evict(self, seq: _Seq) -> None:
        self.cache.free_seq(seq.rid)
        self._cursor.pop(seq.rid, None)


class SpecEngine(ServeEngine):
    """Draft-and-verify continuous batching: the admission, join and
    evict of :class:`~tony_tpu_torch.serve.engine.ServeEngine`, but each
    iteration advances every running sequence by the accepted draft
    prefix plus the target's bonus token, for one target forward.

    ``draft`` is a lane object (:class:`NgramDraft` by default,
    :class:`ModelDraft` through ``draft_model=``, a module holding its
    weights on the engine's device); ``spec_k`` the draft depth, in
    ``[1, q_block - 1]`` (the k+1 verify rows ride one row block)."""

    def __init__(self, model: Any, *, spec_k: int = 4,
                 draft: Optional[Any] = None,
                 draft_model: Optional[Any] = None, ngram_max: int = 3,
                 **kw):
        super().__init__(model, **kw)
        if not 1 <= int(spec_k) <= self.q_block - 1:
            raise ValueError(
                f"spec_k must be in [1, q_block-1={self.q_block - 1}] "
                f"(the k+1 verify rows ride one row block), got {spec_k}")
        self.spec_k = int(spec_k)
        if draft is None:
            if draft_model is not None:
                draft = ModelDraft(
                    draft_model, ctx_max=self.ctx_pad,
                    block_size=self.block_size, q_block=self.q_block,
                    decode_buckets=self.decode_buckets,
                    max_running=self.max_running, device=self.device,
                    aot_cache=self.aot_cache, kernel_dir=self.kernel_dir)
            else:
                draft = NgramDraft(max_n=ngram_max)
        elif draft_model is not None:
            raise ValueError("pass draft= OR draft_model=, not both")
        self.draft = draft
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.verify_launches = 0
        self.spec_rounds = 0           # (sequence, verify launch) pairs
        self.spec_tokens_out = 0
        profiler.record_serve(f"{self.tag}_spec", k=self.spec_k,
                              draft=self.draft.kind, q_block=self.q_block,
                              decode_buckets=list(self.decode_buckets))

    def _verify_round(self) -> None:
        seqs = list(self._running)
        ks = [min(self.spec_k, s.remaining) for s in seqs]
        drafts = self.draft.propose(seqs, ks)
        # The lane may have degraded a sequence's depth (draft-pool
        # pressure: an empty proposal verifies as a plain decode row).
        ks = [min(k, len(d)) for k, d in zip(ks, drafts)]
        b = _bucket_of(self.decode_buckets, len(seqs))
        t = self.q_block
        tokens = np.zeros((b, t), np.int32)
        positions = np.zeros((b, t), np.int32)
        tables = np.zeros((b, self.nb_max), np.int32)
        flat = np.full((b, t), self.cache.oob_index, np.int32)
        for i, s in enumerate(seqs):
            p0 = len(s.tokens) - 1
            # The full-extent admission covers the k+1 rows already, so
            # this grows nothing; it keeps the reserve -> commit ->
            # rollback cursor contract the draft pool uses.
            self.cache.spec_reserve(s.rid, p0 + 1 + ks[i])
            tokens[i, 0] = s.tokens[-1]
            tokens[i, 1:1 + ks[i]] = drafts[i]
            positions[i] = p0 + np.arange(t, dtype=np.int32)
            for j in range(ks[i] + 1):
                # write_index: a sequence's first verify rows can land in
                # an adopted prefix block, which is copied first.
                flat[i, j] = self.cache.write_index(s.rid, p0 + j)
        tables[:len(seqs)] = self.cache.table_array(
            [s.rid for s in seqs], self.nb_max)
        logits = self._run_fn(b, t, tokens, positions, tables, flat)
        self.verify_launches += 1
        # One copy to the host for the round, not one a row.
        rows = logits[:len(seqs), :max(ks, default=0) + 1].cpu().numpy()
        for i, s in enumerate(seqs):
            p0 = len(s.tokens) - 1
            k = ks[i]
            a = 0
            while a < k and int(np.argmax(rows[i, a])) == drafts[i][a]:
                self._emit_token(s, rows[i, a])   # the accepted draft
                a += 1
            if s.remaining > 0:
                # The first rejected row's own argmax: what sequential
                # greedy decode emits here.
                self._emit_token(s, rows[i, a])
            self.spec_proposed += k
            self.spec_accepted += a
            self.spec_rounds += 1
            self.spec_tokens_out += len(s.tokens) - 1 - p0
            # Verified rows cover [0, p0+a+1): roll the cursor back to
            # exactly there.
            self.cache.commit(s.rid, p0 + a + 1)
            self.cache.rollback(s.rid)
        self.draft.observe(seqs)

    def _decode(self) -> None:
        """The decode step of :meth:`ServeEngine.step`: one draft and
        verify round for the running batch."""
        self._verify_round()

    def warm(self, prefill_pads: Sequence[int] = ()) -> int:
        """The target's family (the verify rides the decode buckets),
        then a model draft's own: its decode buckets and the named pads
        (a first catch-up feeds a whole prompt)."""
        n = super().warm(prefill_pads)
        if isinstance(self.draft, PagedModelRunner):
            n += self.draft.warm(prefill_pads)
        return n

    def _evict(self, seq: _Seq, results: List[Completion]) -> None:
        self.draft.evict(seq)
        super()._evict(seq, results)

    def _extra_stats(self) -> Dict[str, float]:
        return {
            "acceptance_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0),
            "spec_proposed": float(self.spec_proposed),
            "spec_accepted": float(self.spec_accepted),
            "verify_launches": float(self.verify_launches),
            "draft_forwards": float(getattr(self.draft, "forwards", 0)),
            # Decode tokens per verify launch (batching folded in) and
            # per (sequence, launch): 1 + the mean accepted run.
            "tokens_per_verify": (self.spec_tokens_out
                                  / self.verify_launches
                                  if self.verify_launches else 0.0),
            "tokens_per_seq_round": (self.spec_tokens_out
                                     / self.spec_rounds
                                     if self.spec_rounds else 0.0),
        }
