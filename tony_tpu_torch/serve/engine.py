"""Continuous-batching inference engine over the paged KV cache: the
core of :mod:`tony_tpu.serve.engine`.

One engine owns one replica's decode loop. Callers queue requests and
the loop pulls them into the running batch at iteration granularity — a
request joins as soon as pool blocks and a batch slot are free, and
leaves (eviction) the step its generation completes. Shapes follow the
JAX engine so the same schedule runs:

* **row blocks** — every forward processes query rows in blocks of
  ``q_block``: prefill pads the prompt to a whole number of blocks,
  decode processes one block per sequence (1 real new token + padding
  rows whose cache writes are dropped);
* **decode buckets** — the joined batch pads up to the next bucket size;
* **one context extent** — the KV buffer gathered per step is always
  ``ctx_pad = nb_max · block_size`` positions; masking by absolute
  position does the rest.

Numerics: the JAX engine pins decode logits BITWISE against a
sequential full prefill. PyTorch's matmuls are not guaranteed
batch-invariant (CPU or cuBLAS), so the port holds decode against
:meth:`ServeEngine.full_prefill_logits` within a stated tolerance, with
greedy tokens equal. The attention kernel itself is row-independent.
Greedy sampling is ``np.argmax`` on the host f32 row, so ties resolve
as in the JAX package. Everything runs under ``torch.inference_mode``.

Hot swap (:meth:`PagedModelRunner.swap_params`,
:meth:`EngineFront.quiesce_and_swap`): new weights are copied INTO the
live parameters at a drained iteration boundary. The cached step
functions close over the model, so rebinding it would leave them on the
old weights; copying in place keeps every step function and every
parameter's address.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Union)

import numpy as np
import torch

from tony_tpu_torch import profiler, resolve_device
from tony_tpu_torch.serve.kvcache import AdmissionError, PagedKVCache
from tony_tpu_torch.serve.swap import SwapError

# Where the lanes of the reference's engine that the port has not ported
# yet are tracked.
_LANES_LATER = "ROADMAP.md, queue 1 item 9"


@dataclasses.dataclass
class Request:
    """One generation request. ``max_new_tokens`` is a hard cap; the
    engine reserves pool blocks for ``len(tokens) + max_new_tokens`` at
    admission so decode can never exhaust the pool mid-flight."""
    rid: Any
    tokens: List[int]
    max_new_tokens: int


@dataclasses.dataclass
class Completion:
    """One finished request: the generated tokens, per-position f32
    logits when the engine keeps them (``keep_logits=True``), and the
    request's wall latency."""
    rid: Any
    prompt: List[int]
    tokens: List[int]
    logits: Optional[List[np.ndarray]]
    latency_s: float

    def wire(self) -> Dict[str, Any]:
        """The serving wire form, in plain Python numbers (JSON)."""
        return {"rid": self.rid, "tokens": [int(t) for t in self.tokens],
                "latency_ms": round(1e3 * float(self.latency_s), 3)}


class _Seq:
    __slots__ = ("rid", "tokens", "n_prompt", "remaining", "logits",
                 "t_submit", "t_first")

    def __init__(self, req: Request, t_submit: float):
        self.rid = req.rid
        self.tokens: List[int] = list(req.tokens)
        self.n_prompt = len(req.tokens)
        self.remaining = int(req.max_new_tokens)
        self.logits: List[np.ndarray] = []
        self.t_submit = t_submit
        self.t_first: Optional[float] = None


def _bucket_of(buckets: Sequence[int], n: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch {n} exceeds the largest decode bucket "
                     f"{max(buckets)}")


def build_step_fn(model: Any, *, n_layers: int, n_blocks: int,
                  block_size: int, kv_dim: int, ctx_pad: int, b: int,
                  t: int) -> Callable:
    """The (b, t)-shaped serve step over a paged pool: gather each
    sequence's blocks into the fixed-extent KV buffer layer by layer,
    run the serve forward, commit the fresh rows back to the pool
    through the host-computed flat indices (rows at ``oob_index``
    drop). Host inputs are numpy arrays; the pools are updated IN PLACE
    (the counterpart of the JAX step's donated pools)."""
    L, nb, bs, kvd, ctx = n_layers, n_blocks, block_size, kv_dim, ctx_pad
    oob = nb * bs

    @torch.inference_mode()
    def fn(pool_k: torch.Tensor, pool_v: torch.Tensor, tokens: np.ndarray,
           positions: np.ndarray, tables: np.ndarray,
           flat_idx: np.ndarray) -> torch.Tensor:
        dev = pool_k.device
        # Clamped, as jnp.take(mode="clip"): table padding (and the
        # full-prefill reference's contiguous table on a small pool)
        # may point past the pool; those positions are masked by the
        # attention, and a gathered block is finite, so 0·x stays 0.
        tab = torch.as_tensor(np.clip(tables, 0, nb - 1).reshape(-1),
                              dtype=torch.long, device=dev)

        def layer_kv(i: int):
            # Layer i's [b, ctx, kvd] buffers, gathered just before
            # layer i (not all layers at once: at 7B, max_running=16
            # and ctx 2048 that would hold ~17 GB more).
            return (pool_k[i].index_select(0, tab).view(b, ctx, kvd),
                    pool_v[i].index_select(0, tab).view(b, ctx, kvd))

        logits, (knew, vnew) = model(
            torch.as_tensor(tokens, device=dev),
            positions=torch.as_tensor(positions, dtype=torch.int32,
                                      device=dev),
            kv=layer_kv)
        flat = np.asarray(flat_idx).reshape(-1)
        rows = np.nonzero(flat < oob)[0]        # mode="drop", on the host
        if rows.size:
            dst = torch.as_tensor(flat[rows], dtype=torch.long, device=dev)
            src = torch.as_tensor(rows, dtype=torch.long, device=dev)
            pool_k.view(L, nb * bs, kvd)[:, dst] = \
                knew.reshape(L, b * t, kvd)[:, src].to(pool_k.dtype)
            pool_v.view(L, nb * bs, kvd)[:, dst] = \
                vnew.reshape(L, b * t, kvd)[:, src].to(pool_v.dtype)
        return logits

    return fn


class PagedModelRunner:
    """Shared geometry + step plumbing over ONE model and ONE paged KV
    pool (the base the speculative lane's draft model will share)."""

    def _init_paged(self, model: Any, *, ctx_max: int, block_size: int,
                    q_block: int, decode_buckets: Sequence[int],
                    max_running: int, n_blocks: Optional[int],
                    device: Optional[Union[str, torch.device]]) -> None:
        cfg = model.cfg
        if q_block % 8:
            raise ValueError(f"q_block must be a multiple of 8, got "
                             f"{q_block}")
        self.device = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev.type != self.device.type or (
                self.device.index is not None
                and model_dev.index != self.device.index):
            raise ValueError(f"model lives on {model_dev}, engine device "
                             f"is {self.device}")
        if self.device.type == "cuda":
            # f32 serving means f32: no TF32 in f32 matmuls, and bf16
            # matmuls reduce in f32 (no reduced-precision split-K).
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
                = False
        self.model = model
        self.q_block = int(q_block)
        self.decode_buckets = tuple(sorted(set(
            list(decode_buckets) + [max_running])))
        self.max_running = int(max_running)
        self.n_layers = cfg.n_layers
        self.kv_dim = cfg.n_kv_heads * cfg.head_dim
        self.block_size = int(block_size)
        nb_max = -(-int(ctx_max) // self.block_size)
        self.nb_max = nb_max
        self.ctx_pad = nb_max * self.block_size
        if n_blocks is None:
            n_blocks = nb_max * self.max_running
        self.cache = PagedKVCache(self.n_layers, self.kv_dim,
                                  n_blocks=n_blocks,
                                  block_size=self.block_size,
                                  dtype=cfg.dtype, device=model_dev)
        self._fns: Dict[tuple, Callable] = {}
        # Forward-launch counter (prefills + decode steps).
        self.forwards = 0
        # Weight publication: the published pointer version and the
        # checkpoint step the live weights came from (0/0 until known),
        # the lifetime swap count, and the quiesce gate that holds
        # admission while a hot swap drains the batch.
        self.weight_version = 0
        self.weight_step = 0
        self.weight_swaps = 0
        self.swapping = False

    def _fn(self, b: int, t: int, n_blocks: Optional[int] = None
            ) -> Callable:
        nb = self.cache.n_blocks if n_blocks is None else n_blocks
        key = (b, t, nb)
        if key not in self._fns:
            self._fns[key] = build_step_fn(
                self.model, n_layers=self.n_layers, n_blocks=nb,
                block_size=self.block_size, kv_dim=self.kv_dim,
                ctx_pad=self.ctx_pad, b=b, t=t)
        return self._fns[key]

    def _run_fn(self, b, t, tokens, positions, tables, flat_idx):
        logits = self._fn(b, t)(self.cache.k, self.cache.v, tokens,
                                positions, tables, flat_idx)
        self.forwards += 1
        return logits

    @torch.no_grad()
    def swap_params(self, new: Mapping[str, torch.Tensor], *, version: int,
                    step: int) -> None:
        """Copy ``new`` (parameter name → tensor) into the live
        parameters in place: the hot swap's commit point. The CALLER
        owns the iteration-boundary contract (no forward in flight; the
        replica runs this under the front's drive lock after a
        quiesce), and the copies are ordered on the device before the
        next forward's kernels, so no forward sees a mix.

        Every name, shape, dtype and device is checked before any
        parameter is touched: any drift raises :class:`SwapError` with
        the old weights whole (a manifest of another geometry needs a
        restart, not a swap). The step functions and every parameter's
        address survive: a swap rebuilds nothing."""
        live = dict(self.model.named_parameters())
        if set(new) != set(live):
            missing = sorted(set(live) - set(new))[:4]
            extra = sorted(set(new) - set(live))[:4]
            raise SwapError(
                f"parameter set changed (missing {missing}, unexpected "
                f"{extra}) — the published manifest is not this engine's "
                f"geometry; old weights kept")
        for name, p in live.items():
            n = new[name]
            if tuple(n.shape) != tuple(p.shape) or n.dtype != p.dtype \
                    or n.device != p.device:
                raise SwapError(
                    f"parameter {name} changed: {tuple(p.shape)}/{p.dtype}"
                    f"/{p.device} -> {tuple(n.shape)}/{n.dtype}/{n.device}"
                    f"; old weights kept")
        for name, p in live.items():
            p.copy_(new[name])
        self.weight_version = int(version)
        self.weight_step = int(step)
        self.weight_swaps += 1


class ServeEngine(PagedModelRunner):
    """Continuous-batching loop for one replica.

    ``model`` is a serve-capable module holding its weights (today:
    :class:`tony_tpu_torch.models.transformer.Transformer` — its ``kv=``
    forward). ``device=None`` means the card; the model must live on
    the engine's device.
    """

    def __init__(self, model: Any, *, ctx_max: int, block_size: int = 16,
                 n_blocks: Optional[int] = None, q_block: int = 16,
                 decode_buckets: Sequence[int] = (4, 16),
                 max_running: int = 16, keep_logits: bool = False,
                 join_policy: str = "continuous",
                 stats_window_s: float = 60.0, tag: str = "serve",
                 device: Optional[Union[str, torch.device]] = None):
        if join_policy not in ("continuous", "static"):
            raise ValueError(f"unknown join_policy {join_policy!r} "
                             "(continuous|static)")
        self._init_paged(model, ctx_max=ctx_max, block_size=block_size,
                         q_block=q_block, decode_buckets=decode_buckets,
                         max_running=max_running, n_blocks=n_blocks,
                         device=device)
        self.keep_logits = keep_logits
        self.join_policy = join_policy
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._running: List[_Seq] = []
        # Telemetry over a time window: (t_done, latency_s, n_tokens,
        # ttft_s) per completion and (t_end, step_s) per step.
        self._events: deque = deque(maxlen=512)
        self._step_times: deque = deque(maxlen=512)
        self.stats_window_s = float(stats_window_s)
        self._completed = 0
        self._emitted = 0
        self._t0 = time.monotonic()
        self._steps = 0
        # Padded prefill length -> count: the histogram the reference's
        # warm() pad tuner reads from the heartbeat.
        self._prompt_hist: Dict[int, int] = {}
        self.tag = tag
        profiler.record_serve(tag, ctx_pad=self.ctx_pad,
                              block_size=self.block_size, nb_max=self.nb_max,
                              n_blocks=self.cache.n_blocks,
                              q_block=self.q_block,
                              decode_buckets=list(self.decode_buckets),
                              max_running=self.max_running,
                              join_policy=join_policy)

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request (thread-safe). Requests that can NEVER fit
        the context buffer or the pool are rejected now with a
        non-retryable :class:`AdmissionError`; pool pressure is handled
        at join time by leaving the request queued."""
        total = len(req.tokens) + req.max_new_tokens
        if not req.tokens:
            raise ValueError(f"request {req.rid!r}: empty prompt")
        needed = self.cache.blocks_for(total)
        if total > self.ctx_pad or needed > self.cache.n_blocks:
            raise AdmissionError(
                f"request {req.rid!r} needs {total} positions "
                f"({needed} blocks) > engine capacity (context "
                f"{self.ctx_pad}, pool {self.cache.n_blocks} blocks); "
                f"it can never be admitted",
                needed_blocks=needed,
                free_blocks=self.cache.free_blocks, retryable=False)
        with self._lock:
            self._queue.append((req, time.monotonic()))

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def running(self) -> int:
        return len(self._running)

    # -- prefill / decode --------------------------------------------------
    def _prefill(self, seq: _Seq) -> None:
        """One monolithic prefill launch over the prompt, padded to a
        ``q_block`` multiple; emits the first token."""
        n = len(seq.tokens)
        t_pad = -(-n // self.q_block) * self.q_block
        with self._lock:
            self._prompt_hist[t_pad] = self._prompt_hist.get(t_pad, 0) + 1
        tokens = np.zeros((1, t_pad), np.int32)
        tokens[0, :n] = seq.tokens
        positions = np.arange(t_pad, dtype=np.int32)[None].copy()
        flat = np.full((1, t_pad), self.cache.oob_index, np.int32)
        for j in range(n):
            flat[0, j] = self.cache.write_index(seq.rid, j)
        tables = self.cache.table_array([seq.rid], self.nb_max)
        logits = self._run_fn(1, t_pad, tokens, positions, tables, flat)
        self._emit_token(seq, logits[0, n - 1].cpu().numpy())

    def _decode(self) -> None:
        seqs = list(self._running)
        b = _bucket_of(self.decode_buckets, len(seqs))
        t = self.q_block
        tokens = np.zeros((b, t), np.int32)
        positions = np.zeros((b, t), np.int32)
        tables = np.zeros((b, self.nb_max), np.int32)
        flat = np.full((b, t), self.cache.oob_index, np.int32)
        for i, s in enumerate(seqs):
            p0 = len(s.tokens) - 1          # the newest, not-yet-fed token
            tokens[i, 0] = s.tokens[-1]
            positions[i] = p0 + np.arange(t, dtype=np.int32)
            flat[i, 0] = self.cache.write_index(s.rid, p0)
        tables[:len(seqs)] = self.cache.table_array(
            [s.rid for s in seqs], self.nb_max)
        logits = self._run_fn(b, t, tokens, positions, tables, flat)
        rows = logits[:len(seqs), 0].cpu().numpy()
        for i, s in enumerate(seqs):
            self._emit_token(s, rows[i])

    def _emit_token(self, seq: _Seq, row: np.ndarray) -> None:
        if seq.t_first is None:
            seq.t_first = time.monotonic()
        if self.keep_logits:
            seq.logits.append(np.array(row, np.float32))
        seq.tokens.append(int(np.argmax(row)))   # greedy: deterministic
        seq.remaining -= 1
        self._emitted += 1

    # -- scheduling --------------------------------------------------------
    def _join(self, results: List[Completion]) -> None:
        # Hot-swap quiesce: admission pauses while a swap drains the
        # batch, so in-flight sequences finish under the old weights and
        # the queue admits after the flip under the new ones.
        if self.swapping:
            return
        if self.join_policy == "static" and self._running:
            return
        while len(self._running) < self.max_running:
            with self._lock:
                if not self._queue:
                    return
                req, t_submit = self._queue[0]
            try:
                self.cache.reserve(req.rid,
                                   len(req.tokens) + req.max_new_tokens)
            except AdmissionError:
                return                      # pool pressure: stay queued
            with self._lock:
                self._queue.popleft()
            seq = _Seq(req, t_submit)
            self._prefill(seq)
            if seq.remaining <= 0:          # max_new_tokens == 1
                self._evict(seq, results)
            else:
                self._running.append(seq)

    def _evict(self, seq: _Seq, results: List[Completion]) -> None:
        self.cache.free_seq(seq.rid)
        now = time.monotonic()
        with self._lock:
            self._events.append((now, now - seq.t_submit,
                                 len(seq.tokens) - seq.n_prompt,
                                 seq.t_first - seq.t_submit))
        self._completed += 1
        results.append(Completion(
            rid=seq.rid, prompt=seq.tokens[:seq.n_prompt],
            tokens=seq.tokens[seq.n_prompt:],
            logits=seq.logits if self.keep_logits else None,
            latency_s=now - seq.t_submit))

    def step(self) -> List[Completion]:
        """One engine iteration: join what fits (prefilling each
        joiner), decode one token for every running sequence, evict what
        finished. Returns the completions this step produced."""
        t0 = time.monotonic()
        results: List[Completion] = []
        self._join(results)
        if self._running:
            self._decode()
            still = []
            for s in self._running:
                if s.remaining <= 0:
                    self._evict(s, results)
                else:
                    still.append(s)
            self._running = still
        t1 = time.monotonic()
        with self._lock:
            self._step_times.append((t1, t1 - t0))
        self._steps += 1
        return results

    def run(self, max_steps: Optional[int] = None) -> List[Completion]:
        """Drive :meth:`step` until queue and batch drain (or
        ``max_steps``)."""
        out: List[Completion] = []
        while (self.queue_depth or self._running) \
                and (max_steps is None or self._steps < max_steps):
            out.extend(self.step())
        return out

    # -- the sequential reference ------------------------------------------
    def full_prefill_logits(self, tokens: Sequence[int]) -> np.ndarray:
        """Sequential full-prefill reference: process ``tokens`` as ONE
        isolated prefill on a zeroed scratch pool and return the real
        rows' f32 logits ``[len, vocab]``. The scratch pool holds only
        the ``min(nb_max, n_blocks)`` blocks its contiguous table can
        reach (clamped, as in the JAX engine: tail positions are masked
        anyway), not a copy of the whole pool."""
        t_real = len(tokens)
        if t_real > self.ctx_pad:
            raise ValueError(f"{t_real} tokens > engine context "
                             f"{self.ctx_pad}")
        t_pad = -(-t_real // self.q_block) * self.q_block
        toks = np.zeros((1, t_pad), np.int32)
        toks[0, :t_real] = list(tokens)
        positions = np.arange(t_pad, dtype=np.int32)[None].copy()
        nb_s = min(self.nb_max, self.cache.n_blocks)
        tables = np.minimum(np.arange(self.nb_max, dtype=np.int32),
                            nb_s - 1)[None].copy()
        flat = np.full((1, t_pad), nb_s * self.block_size, np.int32)
        flat[0, :t_real] = np.arange(t_real)    # rows past the pool drop
        shape = (self.n_layers, nb_s, self.block_size, self.kv_dim)
        scratch_k = torch.zeros(shape, dtype=self.cache.k.dtype,
                                device=self.cache.k.device)
        scratch_v = torch.zeros_like(scratch_k)
        logits = self._fn(1, t_pad, nb_s)(scratch_k, scratch_v, toks,
                                          positions, tables, flat)
        return logits[0, :t_real].cpu().numpy()

    # -- telemetry ---------------------------------------------------------
    def stats(self, t0: Optional[float] = None,
              t1: Optional[float] = None) -> Dict[str, Any]:
        """The serve heartbeat numbers: qps, token rate, p50/p99 request
        latency, time-to-first-token and step-time p50 over the last
        ``stats_window_s`` (or, given ``t0`` and ``t1`` on the
        ``time.monotonic`` clock, over the requests and steps that
        finished between them, as far back as the engine keeps them);
        queue depth; ``completed``/``steps``/``forwards`` as lifetime
        counters; the weight version, step and swap count and the swap
        gate. Every key the control plane reads of the reference's engine
        is here, at its idle value where the lane is not ported (the
        uniform-schema rule). Recorded under ``"<tag>_stats"``."""
        if t0 is None or t1 is None:
            t1 = time.monotonic()
            t0 = max(self._t0, t1 - self.stats_window_s)
        with self._lock:
            events = [e for e in self._events if t0 <= e[0] <= t1]
            steps = sorted(s for t, s in self._step_times if t0 <= t <= t1)
            prompt_hist = dict(self._prompt_hist)
        lat = sorted(e[1] for e in events)
        ttft = sorted(e[3] for e in events)
        dt = max(1e-9, t1 - t0)

        def pct(vals: List[float], p: float) -> float:
            if not vals:
                return 0.0
            return vals[min(len(vals) - 1, int(p * (len(vals) - 1) + 0.5))]

        stats: Dict[str, Any] = {
            "qps": len(events) / dt,
            "tokens_per_s": sum(e[2] for e in events) / dt,
            "p50_ms": 1e3 * pct(lat, 0.50),
            "p99_ms": 1e3 * pct(lat, 0.99),
            "ttft_p50_ms": 1e3 * pct(ttft, 0.50),
            "step_p50_ms": 1e3 * pct(steps, 0.50),
            "queue_depth": float(self.queue_depth),
            "running": float(self.running),
            "completed": float(self._completed),
            "steps": float(self._steps),
            "forwards": float(self.forwards),
            "tokens_per_forward": (self._emitted / self.forwards
                                   if self.forwards else 0.0),
            # Lanes not ported (speculation, disaggregation, the warm
            # pool): their idle values.
            "acceptance_rate": 0.0,
            "role": "colocated",
            "warm_standby": 0.0,
            "weight_version": float(self.weight_version),
            "weight_step": float(self.weight_step),
            "weight_swaps": float(self.weight_swaps),
            "swapping": 1.0 if self.swapping else 0.0,
            "prompt_hist": {str(k): float(v)
                            for k, v in sorted(prompt_hist.items())},
        }
        profiler.safe_record(f"{self.tag}_stats", **stats)
        return stats

    def write_stats(self, path: str,
                    extra: Optional[Dict[str, Any]] = None) -> None:
        """Atomically publish :meth:`stats` (+ ``extra``: the replica adds
        its RPC port) as JSON: the file the executor's heartbeat carries
        to the AM."""
        payload: Dict[str, Any] = dict(self.stats())
        if extra:
            payload.update(extra)
        # One temp file per writer: the replica's publisher thread and a
        # hot swap's republish may write at once.
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)


class EngineFront:
    """Thread-safe request front over ONE shared engine: each caller
    submits and then takes turns advancing the loop until its own
    completion lands, so overlapping calls ride one continuous batch."""

    def __init__(self, engine: ServeEngine):
        self.engine = engine
        self._drive = threading.Lock()
        self._done: Dict[Any, Completion] = {}
        self._rid = 0
        self._rid_ns = uuid.uuid4().hex[:8]
        self._rid_lock = threading.Lock()

    def fresh_rid(self) -> str:
        with self._rid_lock:
            self._rid += 1
            return f"req-{self._rid_ns}-{self._rid}"

    def generate(self, tokens: Sequence[int], max_new_tokens: int,
                 rid: Optional[Any] = None, conv: Optional[Any] = None,
                 tenant: Optional[str] = None) -> Completion:
        """Submit one request and drive the shared engine until it
        completes. ``conv`` (the host tier's conversation handle) and
        ``tenant`` (the QoS class) belong to lanes not ported yet: a
        value other than ``None`` raises."""
        for name, value in (("conv", conv), ("tenant", tenant)):
            if value is not None:
                raise NotImplementedError(
                    f"generate({name}=...) needs a serving lane that is "
                    f"not ported yet ({_LANES_LATER})")
        if rid is None:
            rid = self.fresh_rid()
        self.engine.submit(Request(rid=rid, tokens=list(tokens),
                                   max_new_tokens=int(max_new_tokens)))
        return self._drive_until(rid)

    def _drive_until(self, rid: Any) -> Completion:
        """Take turns advancing the shared loop until ``rid``'s
        completion lands."""
        while True:
            with self._drive:
                if rid in self._done:
                    return self._done.pop(rid)
                for c in self.engine.step():
                    self._done[c.rid] = c
            # Another thread may own the completion we need next round;
            # yield so it can collect.
            time.sleep(0)

    def quiesce_and_swap(self, fn: Callable[[], None]) -> None:
        """Drain the engine to an iteration boundary and run ``fn`` (the
        weight flip) there, without dropping a request. Under the drive
        lock: set ``engine.swapping`` (the ``_join`` gate: queued
        requests stay queued), step the engine until every in-flight
        sequence completes under the OLD weights (completions stash into
        ``_done`` as a caller's own drive turn would), call ``fn`` at the
        drained boundary, then clear the gate: the queued backlog admits
        on the next step under the NEW weights. A failed flip propagates
        after the gate clears, the old weights serving."""
        with self._drive:
            self.engine.swapping = True
            try:
                while self.engine._running:
                    for c in self.engine.step():
                        self._done[c.rid] = c
                fn()
            finally:
                self.engine.swapping = False
