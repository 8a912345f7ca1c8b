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

Two admission lanes ride those shapes, both off by default (the engine
is then the plain one):

* ``prefix_cache=True`` — prompts chain-hash per full KV block and adopt
  published pool blocks (the prefix tier of
  :mod:`tony_tpu_torch.serve.kvcache`) instead of recomputing them;
  every KV write goes through the cache's copy-on-write ``write_index``;
* ``prefill_chunk=N`` — prompts prefill in ``N``-row chunks (a
  ``q_block`` multiple), one chunk per engine iteration, interleaved
  with decode.

Three more lanes ride admission and eviction, each off by default:

* ``host_blocks=N`` — the KV memory hierarchy: a host tier of ``N``
  blocks (:mod:`tony_tpu_torch.serve.kvcache`). A request tagged with a
  conversation handle (``conv``) is PARKED at eviction (its KV copied to
  the host, its device blocks freed), and the conversation's next turn
  resumes from the parked blocks, prefilling only its new tail. With the
  prefix cache on, a demoted stretch of a prompt's chain is promoted
  back before the match, and ``demote_watermark`` arms the demotion
  daemon: above that pool fraction each step demotes ``demote_batch``
  cold cached-tier blocks to the host ahead of need;
* :meth:`ServeEngine.export_stems` / :meth:`ServeEngine.adopt_stem` —
  the persisted prefix store (:mod:`tony_tpu_torch.serve.kvstore`);
* ``qos=`` — per-tenant weighted-fair block budgets
  (:mod:`tony_tpu_torch.serve.qos`): the admission scan defers a
  request whose tenant is over its budget, and admits later tenants'
  requests past it.

The speculative lane is :class:`tony_tpu_torch.serve.spec.SpecEngine`.
Disaggregated serving (:mod:`tony_tpu_torch.serve.disagg`) adds two
entry points beside :meth:`ServeEngine.submit`: a prefill-role engine's
:meth:`ServeEngine.prefill_only` (prefill, first token, export the KV
blocks) and a decode-role engine's :meth:`ServeEngine.admit_handoff`
(import them and decode on). ``role=`` is telemetry and router
semantics: every engine keeps every entry point.

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
functions close over the model, and a captured step reads the
parameters' addresses, so rebinding it would leave them on the old
weights; copying in place keeps every step function, every captured
graph and every parameter's address.

Cold start (:meth:`PagedModelRunner.warm`, ``aot_cache=``): the step is a
function of device tensors with no host sync, so it can be captured in
a CUDA graph and replayed; the kernel libraries it launches resolve
through the persisted cache of :mod:`tony_tpu_torch.ckpt.aot`. The
default engine runs it eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
import torch.nn.functional as F

from tony_tpu_torch import profiler, resolve_device
from tony_tpu_torch.serve import prefix as prefix_mod
from tony_tpu_torch.serve.disagg import HandoffError, decode_f32, encode_f32
from tony_tpu_torch.serve.kvcache import (AdmissionError, PagedKVCache,
                                          encode_blocks)
from tony_tpu_torch.serve.swap import SwapError


@dataclasses.dataclass
class Request:
    """One generation request. ``max_new_tokens`` is a hard cap; the
    engine reserves pool blocks for ``len(tokens) + max_new_tokens`` at
    admission so decode can never exhaust the pool mid-flight."""
    rid: Any
    tokens: List[int]
    max_new_tokens: int
    # Conversation handle: a host-tier engine parks the request's KV
    # under it at eviction and resumes the conversation's next turn from
    # it (ignored without a host tier).
    conv: Optional[Any] = None
    # Tenant tag: the request's QoS class on a budget-armed engine and
    # the key of the per-tenant heartbeat breakdown.
    tenant: Optional[str] = None


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
                 "t_submit", "t_first", "pf_pos", "published", "hkey",
                 "conv", "tenant", "qcharge")

    def __init__(self, req: Request, t_submit: float):
        self.rid = req.rid
        self.tokens: List[int] = list(req.tokens)
        self.n_prompt = len(req.tokens)
        self.remaining = int(req.max_new_tokens)
        self.logits: List[np.ndarray] = []
        self.t_submit = t_submit
        self.t_first: Optional[float] = None
        # Prefill cursor: the next prompt position whose row is not yet
        # in the pool (past an adopted prefix at admission).
        self.pf_pos = 0
        # Prefix publication: full blocks already indexed, and the chain
        # key of the last one (the next block's chain prior).
        self.published = 0
        self.hkey = ""
        self.conv = req.conv
        self.tenant = req.tenant
        # Device blocks charged to the tenant at admission (QoS armed),
        # released at eviction.
        self.qcharge = 0


def _bucket_of(buckets: Sequence[int], n: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch {n} exceeds the largest decode bucket "
                     f"{max(buckets)}")


def build_step_fn(model: Any, *, n_layers: int, n_blocks: int,
                  block_size: int, kv_dim: int, ctx_pad: int, b: int,
                  t: int, last_row: bool = False) -> Callable:
    """The (b, t)-shaped serve step over a paged pool, a function of
    device tensors only, with no host sync (what a CUDA graph captures):
    gather each sequence's blocks, and the pool's sink block after them,
    into a KV buffer one block wider than ``ctx_pad``, layer by layer;
    run the serve forward over the first ``ctx_pad`` columns (rows past
    them land in the sink column); commit every fresh row to the pool
    through the flat indices, rows at ``oob_index`` landing in the sink
    block. ``store_k``/``store_v`` are the cache's stores
    ``[n_layers, n_blocks + 1, block_size, kv_dim]``, updated IN PLACE
    (the counterpart of the JAX step's donated pools); ``tokens``,
    ``positions`` and ``flat_idx`` are int32 ``[b, t]``, ``tables``
    int32 ``[b, ctx_pad / block_size]``. Returns f32 logits
    ``[b, t, vocab]``; with ``last_row``, only row ``row[i]`` of each
    sequence, ``[b, 1, vocab]``, taken from the same logits (a prefill
    reads one row, and a captured step keeps its output alive for the
    life of its graph: a full output of every long prefill shape would
    pin ``t·vocab·4`` bytes a graph)."""
    L, nb, bs, kvd, ctx = n_layers, n_blocks, block_size, kv_dim, ctx_pad
    oob = nb * bs
    width = ctx + bs

    @torch.inference_mode()
    def fn(store_k: torch.Tensor, store_v: torch.Tensor,
           tokens: torch.Tensor, positions: torch.Tensor,
           tables: torch.Tensor, flat_idx: torch.Tensor,
           row: Optional[torch.Tensor] = None) -> torch.Tensor:
        # Clamped, as jnp.take(mode="clip"): table padding (and the
        # full-prefill reference's contiguous table on a small pool)
        # may point past the pool; those positions are masked by the
        # attention, and a gathered block is finite, so 0·x stays 0.
        # Then the sink block, the buffer's last block_size columns.
        tab = F.pad(tables.clamp(0, nb - 1), (0, 1),
                    value=nb).reshape(-1).long()

        def layer_kv(i: int):
            # Layer i's [b, ctx + bs, kvd] buffers, gathered just before
            # layer i (not all layers at once: at 7B, max_running=16
            # and ctx 2048 that would hold ~17 GB more).
            return (store_k[i].index_select(0, tab).view(b, width, kvd),
                    store_v[i].index_select(0, tab).view(b, width, kvd))

        logits, (knew, vnew) = model(tokens, positions=positions,
                                     kv=layer_kv, ctx=ctx)
        # mode="drop" on the device: a dropped row lands in the sink.
        dst = flat_idx.reshape(-1).long().clamp(0, oob)
        store_k.view(L, (nb + 1) * bs, kvd)[:, dst] = \
            knew.reshape(L, b * t, kvd).to(store_k.dtype)
        store_v.view(L, (nb + 1) * bs, kvd)[:, dst] = \
            vnew.reshape(L, b * t, kvd).to(store_v.dtype)
        if last_row:
            logits = logits.gather(1, row.long().view(b, 1, 1).expand(
                b, 1, logits.shape[-1]))
        return logits

    return fn


class _StepInputs:
    """One (b, t) step's device inputs — tokens, positions, block tables,
    flat write indices and, for a ``last_row`` step, the row it returns —
    as views of ONE int32 buffer, which the host fills with one copy
    before each launch: the static inputs a captured step reads, and the
    eager step's."""

    def __init__(self, b: int, t: int, nb_max: int, oob: int,
                 device: torch.device, last_row: bool):
        shapes = ((b, t), (b, t), (b, nb_max), (b, t)) + (
            ((b,),) if last_row else ())
        sizes = [int(np.prod(s)) for s in shapes]
        offs = np.cumsum([0] + sizes)
        self._host = np.zeros(offs[-1], np.int32)
        self._dev = torch.zeros(int(offs[-1]), dtype=torch.int32,
                                device=device)
        self._host_views = tuple(self._host[offs[i]:offs[i + 1]]
                                 .reshape(s) for i, s in enumerate(shapes))
        self.views = tuple(self._dev[offs[i]:offs[i + 1]].view(s)
                           for i, s in enumerate(shapes))
        self._oob = oob

    def fill(self, tokens: np.ndarray, positions: np.ndarray,
             tables: np.ndarray, flat_idx: np.ndarray,
             row: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
        srcs = (tokens, positions, tables, flat_idx, row or 0)
        for dst, src in zip(self._host_views, srcs):
            dst[...] = src
        self._dev.copy_(torch.from_numpy(self._host))
        return self.views

    def idle(self) -> Tuple[torch.Tensor, ...]:
        """Inputs whose every row lands in the sink: a launch of them
        writes no live row of the pool (capture's warm-up)."""
        for view in self._host_views:
            view[...] = 0
        self._host_views[3][...] = self._oob
        self._dev.copy_(torch.from_numpy(self._host))
        return self.views


class _GraphStep:
    """One (b, t) step captured in a CUDA graph over static inputs; a
    call fills them and replays. ``launches`` counts the kernel wrapper
    launches the graph holds (the wrappers count a captured launch once,
    at capture; a replay runs them all again) and ``replays`` the
    replays. The output is the graph's own tensor: it holds the last
    replay's logits until the next replay of any graph of the engine
    (they share one memory pool), so every caller consumes it first. It
    lives as long as the graph, which is why a long prefill step returns
    one row (:func:`build_step_fn`): a graph pins at most ``q_block``
    rows of logits a sequence, whatever its prompt pad."""

    def __init__(self, fn: Callable, stores: Tuple[torch.Tensor, ...],
                 inputs: _StepInputs, pool: Any, side: torch.cuda.Stream):
        from tony_tpu_torch.ops import LAUNCHES

        dev = stores[0].device
        # Warm-up outside the capture, on the engine's side stream (one
        # for all its graphs: cuBLAS keeps a workspace for every stream
        # it ran on), every row into the sink: cuBLAS workspaces, the
        # kernel libraries and their modules are loaded before capture
        # begins.
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*stores, *inputs.idle())
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: a replica restoring a hot swap's weights on
        # another thread may allocate while this thread captures.
        with torch.cuda.graph(self.graph, pool=pool,
                              capture_error_mode="thread_local"):
            self.out = fn(*stores, *inputs.views)
        self.launches = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                         if v != before.get(k, 0)}
        self.replays = 0
        self._inputs = inputs

    def __call__(self, tokens, positions, tables, flat_idx,
                 row=None) -> torch.Tensor:
        self._inputs.fill(tokens, positions, tables, flat_idx, row)
        self.graph.replay()
        self.replays += 1
        return self.out


class PagedModelRunner:
    """Shared geometry + step plumbing over ONE model and ONE paged KV
    pool (the base the speculative lane's draft model shares).

    Cold-start plane (the reference's :mod:`tony_tpu.ckpt.aot` half of
    the engine): ``aot_cache`` (a :class:`tony_tpu_torch.ckpt.AOTCache`)
    resolves the kernel libraries each step shape launches through the
    cache, into ``kernel_dir`` (default ``build/kernels``), and
    :meth:`warm` resolves the step family ahead of traffic. On the card
    a resolved step is its step function captured in a CUDA graph and
    replayed; on the CPU it is the eager step. The step function is the
    same either way: the cache changes who builds the libraries, never
    the program. With no cache and no :meth:`warm`, ``_aot_fns`` stays
    empty and every launch runs the step eagerly."""

    def _init_paged(self, model: Any, *, ctx_max: int, block_size: int,
                    q_block: int, decode_buckets: Sequence[int],
                    max_running: int, n_blocks: Optional[int],
                    device: Optional[Union[str, torch.device]],
                    aot_cache: Optional[Any] = None,
                    kernel_dir: Optional[str] = None,
                    host_blocks: int = 0,
                    async_offload: bool = False) -> None:
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
                                  dtype=cfg.dtype, host_blocks=host_blocks,
                                  async_offload=async_offload,
                                  device=model_dev)
        self._fns: Dict[tuple, Callable] = {}
        self._inputs: Dict[Tuple[int, int], _StepInputs] = {}
        # Cold-start plane (class docstring): the resolved steps, in a
        # dict beside _fns, the graphs' shared memory pool and warm-up
        # stream, and the counters. fresh_compiles counts nvcc builds;
        # compile_ms is build + capture time on a miss (or without a
        # cache), deserialize_ms library load + capture time on a hit.
        self.aot_cache = aot_cache
        self.kernel_dir = kernel_dir
        self._aot_fns: Dict[Tuple[int, int], Callable] = {}
        self._graph_pool: Any = None
        self.aot_hits = 0
        self.aot_misses = 0
        self.fresh_compiles = 0
        self.compile_ms = 0.0
        self.deserialize_ms = 0.0
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

    def _fn(self, b: int, t: int, n_blocks: Optional[int] = None,
            last_row: bool = False) -> Callable:
        nb = self.cache.n_blocks if n_blocks is None else n_blocks
        key = (b, t, nb, last_row)
        if key not in self._fns:
            self._fns[key] = build_step_fn(
                self.model, n_layers=self.n_layers, n_blocks=nb,
                block_size=self.block_size, kv_dim=self.kv_dim,
                ctx_pad=self.ctx_pad, b=b, t=t, last_row=last_row)
        return self._fns[key]

    def _last_row(self, t: int) -> bool:
        """Whether the (b, t) step returns one row a sequence: a prefill
        past ``q_block`` rows (whose caller reads only its last real
        row). Decode and verify steps (``q_block`` rows) return all."""
        return t > self.q_block

    def _step_inputs(self, b: int, t: int) -> _StepInputs:
        if (b, t) not in self._inputs:
            self._inputs[(b, t)] = _StepInputs(
                b, t, self.nb_max, self.cache.oob_index, self.cache.device,
                self._last_row(t))
        return self._inputs[(b, t)]

    def _eager(self, b: int, t: int) -> Callable:
        """The (b, t) step run eagerly over the static inputs."""
        fn = self._fn(b, t, last_row=self._last_row(t))
        inputs = self._step_inputs(b, t)
        stores = (self.cache.k_store, self.cache.v_store)

        def run(tokens, positions, tables, flat_idx, row=None
                ) -> torch.Tensor:
            return fn(*stores, *inputs.fill(tokens, positions, tables,
                                            flat_idx, row))

        return run

    def _kernel_names(self) -> Tuple[str, ...]:
        """The kernel libraries this runner's steps launch: flash-decode,
        and the int8 GEMM where the model has a quantized projection;
        none on the CPU."""
        if self.device.type != "cuda":
            return ()
        from tony_tpu_torch.ops.quant import QuantDense

        quant = any(isinstance(m, QuantDense) for m in self.model.modules())
        return ("flash_decode",) + (("int8_matmul",) if quant else ())

    def _capture(self, b: int, t: int) -> Callable:
        """The resolved (b, t) step: captured in a CUDA graph on the
        card (a failed capture raises), the eager step on the CPU."""
        if self.device.type != "cuda":
            return self._eager(b, t)
        if self._graph_pool is None:
            # One pool for every graph of this engine: at 7B a pool per
            # graph would hold each graph's gather scratch apart.
            self._graph_pool = (torch.cuda.graph_pool_handle(),
                                torch.cuda.Stream(self.device))
        return _GraphStep(self._fn(b, t, last_row=self._last_row(t)),
                          (self.cache.k_store, self.cache.v_store),
                          self._step_inputs(b, t), *self._graph_pool)

    def _resolve_aot(self, b: int, t: int) -> Callable:
        """One (b, t) step resolved now: its libraries through the cache
        when one is armed (the runner's library set is one entry: the
        first resolution on an empty cache misses, builds and puts it,
        every later one hits and loads it, no nvcc; drift or corruption
        is a counted miss that costs a build, never a wrong library),
        else built where missing; then the step is captured."""
        from tony_tpu_torch.ops import _build

        t0 = time.monotonic()
        res = _build.resolve(self._kernel_names(), cache=self.aot_cache,
                             build_dir=self.kernel_dir)
        fn = self._capture(b, t)
        ms = 1e3 * (time.monotonic() - t0)
        if res.hit:
            self.aot_hits += 1
            self.deserialize_ms += ms
        else:
            if res.hit is False:            # armed, and missed
                self.aot_misses += 1
            self.compile_ms += ms
        self.fresh_compiles += res.built
        return fn

    def _step_callable(self, b: int, t: int) -> Callable:
        """What :meth:`_run_fn` launches for shape (b, t): the eager step
        when nothing armed the plane (the default engine), else the
        resolved step — warmed, or resolved through the cache now, at
        its first launch."""
        fn = self._aot_fns.get((b, t))
        if fn is None:
            if self.aot_cache is None:
                return self._eager(b, t)
            fn = self._resolve_aot(b, t)
            self._aot_fns[(b, t)] = fn
        return fn

    def warm(self, prefill_pads: Sequence[int] = ()) -> int:
        """Resolve the enumerable step family NOW: every decode bucket
        (the speculative verify rides the same shapes), the chunk
        program ``(1, prefill_chunk)`` and the named prefill pads — so a
        warm standby holds its captured steps before its first request.
        Through the cache when one is armed (hits load the cached
        libraries, misses build and populate the cache for the fleet),
        else built here. Returns the programs resolved."""
        shapes = [(int(b), self.q_block) for b in self.decode_buckets]
        chunk = getattr(self, "prefill_chunk", None)
        if chunk:
            shapes.append((1, int(chunk)))
        shapes += [(1, int(p)) for p in prefill_pads]
        n = 0
        for key in dict.fromkeys(shapes):
            if key not in self._aot_fns:
                self._aot_fns[key] = self._resolve_aot(*key)
                n += 1
        return n

    def graph_launches(self) -> Dict[str, int]:
        """Kernel launches the replays of this runner's captured steps
        made: each graph's captured launches times its replays."""
        out: Dict[str, int] = {}
        for fn in self._aot_fns.values():
            for name, n in getattr(fn, "launches", {}).items():
                out[name] = out.get(name, 0) + n * fn.replays
        return out

    def graph_replays(self) -> int:
        """Replays of this runner's captured steps."""
        return sum(getattr(fn, "replays", 0)
                   for fn in self._aot_fns.values())

    def _run_fn(self, b, t, tokens, positions, tables, flat_idx, row=None):
        """One (b, t) launch. Returns logits ``[b, t, vocab]``, or with
        ``row`` (a prefill's last real row) that row's, ``[b, vocab]``."""
        logits = self._step_callable(b, t)(tokens, positions, tables,
                                           flat_idx, row)
        self.forwards += 1
        if row is None:
            return logits
        return logits[:, 0] if self._last_row(t) else logits[:, row]

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
    the engine's device. ``prefix_cache`` and ``prefill_chunk`` arm the
    admission lanes (module docstring). ``aot_cache``, ``kernel_dir``
    and :meth:`warm` arm the cold-start plane (:class:`PagedModelRunner`);
    ``warm_standby`` starts the engine as a warm standby, which
    :meth:`promote` ends. ``host_blocks``, ``async_offload``,
    ``demote_watermark``, ``demote_batch`` and ``qos`` arm the host tier,
    its encode thread, the demotion daemon and the tenant budgets (module
    docstring).
    """

    def __init__(self, model: Any, *, ctx_max: int, block_size: int = 16,
                 n_blocks: Optional[int] = None, q_block: int = 16,
                 decode_buckets: Sequence[int] = (4, 16),
                 max_running: int = 16, keep_logits: bool = False,
                 join_policy: str = "continuous",
                 stats_window_s: float = 60.0, tag: str = "serve",
                 prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None,
                 aot_cache: Optional[Any] = None,
                 warm_standby: bool = False,
                 kernel_dir: Optional[str] = None,
                 role: str = "colocated", host_blocks: int = 0,
                 async_offload: bool = False,
                 demote_watermark: float = 0.0, demote_batch: int = 0,
                 qos: Optional[Any] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if join_policy not in ("continuous", "static"):
            raise ValueError(f"unknown join_policy {join_policy!r} "
                             "(continuous|static)")
        if role not in ("colocated", "prefill", "decode"):
            raise ValueError(f"unknown role {role!r} "
                             "(colocated|prefill|decode)")
        if not 0.0 <= float(demote_watermark) <= 1.0:
            raise ValueError(f"demote_watermark must be a pool fraction "
                             f"in [0, 1], got {demote_watermark}")
        self._init_paged(model, ctx_max=ctx_max, block_size=block_size,
                         q_block=q_block, decode_buckets=decode_buckets,
                         max_running=max_running, n_blocks=n_blocks,
                         device=device, aot_cache=aot_cache,
                         kernel_dir=kernel_dir, host_blocks=host_blocks,
                         async_offload=async_offload)
        # Warm-standby membership (the cold-start plane's pool half): a
        # standby is resolved and idle; it heartbeats warm_standby=1 so
        # the session keeps it out of the routable endpoints until the
        # AM promotes it (rpc_promote -> promote()).
        self.warm_standby = bool(warm_standby)
        self.prefix_cache = bool(prefix_cache)
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if prefill_chunk <= 0 or prefill_chunk % self.q_block:
                raise ValueError(
                    f"prefill_chunk must be a positive q_block="
                    f"{self.q_block} multiple, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        # Disaggregated serving role (module docstring): telemetry and
        # the router's dispatch; a "decode" engine still prefills for
        # itself on the colocated fallback.
        self.role = role
        # Handoff counters (zeros on a colocated engine: one heartbeat
        # schema for the fleet). handoff_ms is the wall this engine
        # spent exporting or importing KV bytes.
        self.blocks_shipped = 0
        self.handoff_ms = 0.0
        self.imports_failed = 0
        self.handoffs_out = 0
        self.handoffs_in = 0
        # KV memory hierarchy (module docstring). _parked maps a
        # conversation handle to {"tokens": the parked token history,
        # "rid": the parked cache record's id}.
        self.host_offload = host_blocks > 0
        self.demote_watermark = float(demote_watermark)
        # One context extent a sweep by default: a demotion is one
        # batched device-to-host copy, so the batch sizes the transfer.
        self.demote_batch = int(demote_batch) or self.nb_max
        self.daemon_demotions = 0
        self._parked: Dict[Any, Dict[str, Any]] = {}
        self.park_hits = 0
        self.park_lookups = 0
        # Promotions and resumes that fell back to a re-prefill (pool
        # pressure or a corrupt host payload): the hierarchy may cost
        # recompute, never a wedge or a wrong byte.
        self.host_degraded = 0
        # Prefix-store bookkeeping: chain-parent links (to walk a hot tip
        # back to its root) and the most recently adopted tips (the
        # export candidates).
        self._chain_parent: "OrderedDict[str, str]" = OrderedDict()
        self._hot_tips: "OrderedDict[str, None]" = OrderedDict()
        self._stored_tips: set = set()
        self.store_adopted = 0
        # Tenant budgets (a QosPolicy; None = off, the untagged path).
        # The policy gates the admission scan only: the pool never sees
        # tenants. Device blocks reserved a tenant (released at
        # eviction) and lifetime completions a tenant.
        self.qos = qos
        self._tenant_blocks: Dict[str, int] = {}
        self._tenant_completed: Dict[str, int] = {}
        self._tenant_deferrals: Dict[str, int] = {}
        self.admission_rejections = 0
        self.qos_deferrals = 0
        self.keep_logits = keep_logits
        self.join_policy = join_policy
        self._queue: deque = deque()
        self._joining: Any = None     # the rid between queue and lists
        self._lock = threading.Lock()
        self._running: List[_Seq] = []
        # Chunk-prefilling sequences, oldest first.
        self._prefilling: List[_Seq] = []
        # Prefix and prefill counters (lifetime; zero with the lanes off).
        self.prefix_lookup_blocks = 0
        self.prefix_hit_blocks = 0
        self.prefill_launches = 0
        self.prefill_rows = 0
        self.prefill_chunks = 0
        # Telemetry over a time window: (t_done, latency_s, n_tokens,
        # ttft_s, tenant) per completion and (t_end, step_s) per step.
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
                              join_policy=join_policy,
                              prefix_cache=self.prefix_cache,
                              prefill_chunk=self.prefill_chunk, role=role)

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request (thread-safe). Requests that can NEVER fit
        the context buffer or the pool are rejected now with a
        non-retryable :class:`AdmissionError`; pool pressure is handled
        at join time by leaving the request queued. A rid that is live
        here (queued, prefilling or running) raises ``ValueError``: a
        second sequence under one rid would tear the front's rid-keyed
        completions. With a QoS queue cap, a tenant whose pending queue
        is full gets a retryable :class:`AdmissionError`."""
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
            if req.rid in self._live_rids():
                raise ValueError(
                    f"request rid {req.rid!r} is live on this engine — a "
                    f"rid names one request until it completes")
            tenant = req.tenant
            if self.qos is not None and tenant is not None \
                    and self.qos.max_queue:
                depth = sum(1 for r, _ in self._queue if r.tenant == tenant)
                if depth >= self.qos.max_queue:
                    # Back-pressure to the bursting tenant only.
                    self.admission_rejections += 1
                    raise AdmissionError(
                        f"request {req.rid!r}: tenant {tenant!r} queue "
                        f"full ({depth}/{self.qos.max_queue} pending)",
                        needed_blocks=needed,
                        free_blocks=self.cache.free_blocks)
            self._queue.append((req, time.monotonic()))

    def _live_rids(self) -> set:
        """Rids queued, joining (out of the queue, in its first
        prefill), prefilling or running (the caller holds the lock; the
        pool's tables are the drive thread's alone)."""
        return ({r.rid for r, _ in self._queue}
                | {s.rid for s in self._running}
                | {s.rid for s in self._prefilling}
                | ({self._joining} if self._joining is not None else set()))

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def running(self) -> int:
        # Chunk-prefilling sequences hold pool blocks and engine work.
        return len(self._running) + len(self._prefilling)

    # -- prefill -----------------------------------------------------------
    def _prefill_span(self, seq: _Seq, c1: int, t_pad: int) -> None:
        """One prefill launch over positions ``[seq.pf_pos, c1)`` padded
        to ``t_pad`` rows: the whole remaining prompt (monolithic), one
        chunk, or the tail after a prefix hit. The rows attend to earlier
        positions through the pool gather. Emits the first token when
        ``c1`` completes the prompt, else publishes what is written."""
        c0 = seq.pf_pos
        t_real = c1 - c0
        n = len(seq.tokens)
        tokens = np.zeros((1, t_pad), np.int32)
        tokens[0, :t_real] = seq.tokens[c0:c1]
        positions = (c0 + np.arange(t_pad, dtype=np.int32))[None].copy()
        flat = np.full((1, t_pad), self.cache.oob_index, np.int32)
        for j in range(t_real):
            # write_index: after a full-cover hit the tail row lands in
            # an adopted block, which must be copied first (taken at
            # admission).
            flat[0, j] = self.cache.write_index(seq.rid, c0 + j)
        tables = self.cache.table_array([seq.rid], self.nb_max)
        logits = self._run_fn(1, t_pad, tokens, positions, tables, flat,
                              row=t_real - 1)
        self.prefill_launches += 1
        self.prefill_rows += t_pad
        seq.pf_pos = c1
        if c1 >= n:
            self._emit_token(seq, logits[0].cpu().numpy())
        else:
            self._publish(seq)

    def _prefill(self, seq: _Seq) -> None:
        """Monolithic prefill of everything past the prefill cursor."""
        t_real = len(seq.tokens) - seq.pf_pos
        t_pad = -(-t_real // self.q_block) * self.q_block
        self._prefill_span(seq, len(seq.tokens), t_pad)

    def _prefill_chunk_step(self, seq: _Seq) -> bool:
        """Advance one chunk; True when the prompt completed (and the
        first token was emitted). Non-final chunks launch at
        ``(1, prefill_chunk)``; the final one pads its remainder to a
        ``q_block`` multiple."""
        n = len(seq.tokens)
        c1 = min(n, seq.pf_pos + self.prefill_chunk)
        t_real = c1 - seq.pf_pos
        t_pad = (self.prefill_chunk if c1 < n
                 else -(-t_real // self.q_block) * self.q_block)
        self._prefill_span(seq, c1, t_pad)
        self.prefill_chunks += 1
        return seq.pf_pos >= n

    def _publish(self, seq: _Seq) -> None:
        """Index every newly completed block under its chain key. The
        publishable extent is the prefill cursor until the prompt is
        done, then ``len(tokens) - 1``: every row below the newest token
        is verified-written (a verify round's accepted rows were computed
        from true tokens), so a published block never holds a draft
        row."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        limit = (len(seq.tokens) - 1 if seq.pf_pos >= seq.n_prompt
                 else seq.pf_pos)
        while (seq.published + 1) * bs <= limit:
            i = seq.published
            key = prefix_mod.chain_keys(
                seq.tokens[i * bs:(i + 1) * bs], bs, prior=seq.hkey)[0]
            self.cache.publish_block(seq.rid, i, key)
            self._note_parent(key, seq.hkey)
            seq.hkey = key
            seq.published += 1

    def _note_parent(self, key: str, prior: str) -> None:
        """Record one chain link (bounded), so a hot tip can be walked
        back to its root when the prefix store exports the stem."""
        self._chain_parent[key] = prior
        self._chain_parent.move_to_end(key)
        while len(self._chain_parent) > 4096:
            self._chain_parent.popitem(last=False)

    def _note_parents(self, keys: Sequence[str]) -> None:
        for i, key in enumerate(keys):
            self._note_parent(key, keys[i - 1] if i else "")

    def _note_chain(self, keys: Sequence[str], matched: int) -> None:
        """An adoption proved blocks shared: remember the links and mark
        the adopted tip hot (the prefix store exports the hottest tips,
        the stems a second prompt reused)."""
        self._note_parents(keys[:matched])
        tip = keys[matched - 1]
        self._hot_tips[tip] = None
        self._hot_tips.move_to_end(tip)
        while len(self._hot_tips) > 64:
            self._hot_tips.popitem(last=False)

    # -- decode ------------------------------------------------------------

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
        # Tables after the write indices: write_index may repoint a slot
        # (copy-on-write), and the gather must read the new table.
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
        self._publish(seq)

    # -- scheduling --------------------------------------------------------
    def _admit(self, req: Request, total: Optional[int] = None
               ) -> Tuple[int, int, Sequence[str]]:
        """Reserve the request's full extent (``total`` positions when
        given: the prefill-only mode reserves the prompt alone): resumed
        from its conversation's parked KV where it can be, else adopting
        published prefix blocks first. Returns ``(start, matched,
        keys)``: the prefill start (past the resumed or adopted extent),
        the blocks adopted and the prompt's chain keys (so publication
        never rehashes them). Raises :class:`AdmissionError` with the
        cache unchanged on pool pressure, so a queued request retries
        whole."""
        if total is None:
            total = len(req.tokens) + req.max_new_tokens
        if self.host_offload and req.conv is not None:
            res = self._try_resume(req, total)
            if res is not None:
                return res
        if not self.prefix_cache:
            self.cache.reserve(req.rid, total)
            return 0, 0, ()
        keys = prefix_mod.chain_keys(req.tokens, self.block_size)
        if self.host_offload:
            # Re-stage a demoted stretch of this chain before the match,
            # so the admission adopts it like any published stem. A
            # corrupt host payload falls back to recompute (the poison
            # entry dropped), never an error.
            try:
                self.cache.promote(keys)
            except HandoffError:
                self.cache.discard_host(keys)
                self.host_degraded += 1
        matched = self.cache.admit_shared(req.rid, total, keys)
        if matched * self.block_size >= len(req.tokens):
            # Full cover: the last prompt row still recomputes (its
            # logits seed generation) and its write lands in an adopted
            # block. Take that copy NOW, inside the admission; if even
            # one block cannot be supplied, drop the tail block from the
            # match (its rows compute fresh into the reservation).
            try:
                self.cache.cow_block(
                    req.rid, (len(req.tokens) - 1) // self.block_size)
            except AdmissionError:
                self.cache.free_seq(req.rid)
                matched = self.cache.admit_shared(req.rid, total,
                                                  keys[:-1])
        # Counted only once the admission succeeded: a retried request
        # must not skew the hit rate.
        self.prefix_lookup_blocks += len(keys)
        self.prefix_hit_blocks += matched
        if matched:
            self._note_chain(keys, matched)
        return (min(matched * self.block_size, len(req.tokens) - 1),
                matched, keys)

    def _park_keys(self, tokens: Sequence[int], length: int) -> List[str]:
        """Chain keys of the FULL blocks inside ``tokens[:length]``: a
        parked record's adoption probe at resume (a partial tail block
        is keyless, as on the wire)."""
        bs = self.block_size
        return prefix_mod.chain_keys(list(tokens)[:(int(length) // bs) * bs],
                                     bs)

    def _park(self, seq: _Seq) -> bool:
        """Park ``seq``'s KV under its conversation handle instead of
        freeing it. The parked extent is ``len(tokens) - 1``: every row
        below the newest token is verified-written (the last emitted
        token's row is never computed), the bound :meth:`_publish`
        trusts. A re-park of the conversation drops its stale turn
        first; a full host tier returns False (state unchanged) and the
        eviction frees plainly."""
        length = len(seq.tokens) - 1
        if length <= 0:
            return False
        old = self._parked.pop(seq.conv, None)
        if old is not None:
            self.cache.unpark(old["rid"])
        try:
            self.cache.park(seq.rid, length,
                            keys=self._park_keys(seq.tokens, length))
        except AdmissionError:
            return False
        self._parked[seq.conv] = {"tokens": list(seq.tokens),
                                  "rid": seq.rid}
        return True

    def _try_resume(self, req: Request, total: int
                    ) -> Optional[Tuple[int, int, Sequence[str]]]:
        """Resume ``req`` from its conversation's parked KV: adopt what
        is still on the device, re-stage the rest from the host
        payloads, and start the prefill cursor at the parked extent (the
        shared history's launches are never issued; the rows from the
        cursor on compute what a full prefill computes there, as a
        chunked prefill's split does). ``None`` falls through to a fresh
        admission: no parked record, a turn that does not extend the
        parked history (the record is dropped), or a typed resume
        failure (pool pressure or host corruption: counted in
        ``host_degraded``, the record dropped, the turn re-prefills)."""
        self.park_lookups += 1
        rec = self._parked.get(req.conv)
        if rec is None:
            return None
        ptoks = rec["tokens"]
        length = len(ptoks) - 1
        if list(req.tokens)[:len(ptoks)] != ptoks:
            # An edited or truncated conversation: no later turn can
            # resume this record either.
            self._parked.pop(req.conv, None)
            self.cache.unpark(rec["rid"])
            return None
        try:
            self.cache.resume(req.rid, total, rec["rid"])
        except (AdmissionError, HandoffError):
            self._parked.pop(req.conv, None)
            self.cache.unpark(rec["rid"])
            self.host_degraded += 1
            return None
        self._parked.pop(req.conv, None)
        self.park_hits += 1
        keys = self._park_keys(ptoks, length)
        if self.prefix_cache and keys:
            # The resumed blocks hold verified rows: index them so other
            # prompts adopt the shared history, and start publication
            # past them.
            for i, key in enumerate(keys):
                self.cache.publish_block(req.rid, i, key)
            self._note_parents(keys)
            self.prefix_lookup_blocks += len(keys)
            self.prefix_hit_blocks += len(keys)
            return length, len(keys), keys
        return length, 0, ()

    def _join(self, results: List[Completion]) -> None:
        # Hot-swap quiesce: admission pauses while a swap drains the
        # batch, so in-flight sequences finish under the old weights and
        # the queue admits after the flip under the new ones.
        if self.swapping:
            return
        if self.join_policy == "static" and (self._running
                                             or self._prefilling):
            return
        blocked: set = set()          # tenants deferred this join
        while len(self._running) + len(self._prefilling) \
                < self.max_running:
            with self._lock:
                if not self._queue:
                    return
                if self.qos is None:
                    i, (req, t_submit) = 0, self._queue[0]
                else:
                    picked = self._pick_qos(blocked)
                    if picked is None:
                        return             # every waiter is over budget
                    i, (req, t_submit) = picked
            try:
                admitted = self._admit(req)
            except AdmissionError:
                return                      # pool pressure: stay queued
            seq = self._start(req, t_submit, *admitted)
            with self._lock:
                # Slot i is still req's: submit only appends, and this
                # drive thread is the only popper. The rid stays live
                # (``_joining``) until the sequence is in a list.
                del self._queue[i]
                self._joining = req.rid
                if self.qos is not None and req.tenant is not None:
                    seq.qcharge = self.cache.blocks_for(
                        len(req.tokens) + req.max_new_tokens)
                    self._tenant_blocks[req.tenant] = \
                        self._tenant_blocks.get(req.tenant, 0) \
                        + seq.qcharge
            try:
                if self.prefill_chunk is not None:
                    self._prefilling.append(seq)
                    continue
                self._prefill(seq)
                if seq.remaining <= 0:          # max_new_tokens == 1
                    self._evict(seq, results)
                else:
                    self._running.append(seq)
            finally:
                self._joining = None

    def _qos_active(self) -> set:
        """The budget denominator's active tenants: those holding device
        blocks or waiting in the queue (the caller holds the lock). An
        idle tenant leaves the set and its share redistributes."""
        active = {t for t, n in self._tenant_blocks.items() if n > 0}
        active |= {r.tenant for r, _ in self._queue if r.tenant is not None}
        return active

    def _pick_qos(self, blocked: set
                  ) -> Optional[Tuple[int, Tuple[Request, float]]]:
        """The budget-armed admission scan (the caller holds the lock):
        walk the queue first in, first out, DEFER a request whose tenant
        is over its weighted-fair block budget (and, through ``blocked``,
        every later request of that tenant in this join: per-tenant
        order is kept), and return the first that fits with its slot.
        Untagged requests bypass budgets. None when every waiter is over
        budget."""
        active = self._qos_active()
        for i, (req, t_submit) in enumerate(self._queue):
            tenant = req.tenant
            if tenant is None:
                return i, (req, t_submit)
            if tenant in blocked:
                continue
            needed = self.cache.blocks_for(
                len(req.tokens) + req.max_new_tokens)
            budget = self.qos.budget(tenant, self.cache.n_blocks, active)
            if self._tenant_blocks.get(tenant, 0) + needed > budget:
                blocked.add(tenant)
                self.qos_deferrals += 1
                self._tenant_deferrals[tenant] = \
                    self._tenant_deferrals.get(tenant, 0) + 1
                continue
            return i, (req, t_submit)
        return None

    def _start(self, req: Request, t_submit: float, start: int,
               matched: int, keys: Sequence[str]) -> _Seq:
        """The admitted request's sequence: its padded prefill length
        counted in the histogram, the prefill cursor at ``start`` (past
        a resumed or adopted extent) and, past an adopted prefix, the
        publication cursor beyond the adopted blocks (indexed
        already)."""
        t_pad = -(-len(req.tokens) // self.q_block) * self.q_block
        with self._lock:
            self._prompt_hist[t_pad] = self._prompt_hist.get(t_pad, 0) + 1
        seq = _Seq(req, t_submit)
        seq.pf_pos = start
        if matched:
            seq.published = matched
            seq.hkey = keys[matched - 1]
        return seq

    def _advance_prefill(self, results: List[Completion]) -> None:
        """One chunk for the oldest prefilling sequence (first in, first
        out): a long prompt costs the running batch one extra launch a
        token step, not a whole-prompt stall."""
        if not self._prefilling:
            return
        seq = self._prefilling[0]
        if self._prefill_chunk_step(seq):
            self._prefilling.pop(0)
            if seq.remaining <= 0:          # max_new_tokens == 1
                self._evict(seq, results)
            else:
                self._running.append(seq)

    def _evict(self, seq: _Seq, results: List[Completion]) -> None:
        # A host-tier engine parks a conversation-tagged turn's KV
        # instead of dropping it (park frees the device blocks itself);
        # a full host tier falls back to the plain free.
        if not (self.host_offload and seq.conv is not None
                and self._park(seq)):
            self.cache.free_seq(seq.rid)
        now = time.monotonic()
        with self._lock:
            self._events.append((now, now - seq.t_submit,
                                 len(seq.tokens) - seq.n_prompt,
                                 seq.t_first - seq.t_submit, seq.tenant))
            if seq.tenant is not None:
                if seq.qcharge:
                    left = self._tenant_blocks.get(seq.tenant, 0) \
                        - seq.qcharge
                    if left > 0:
                        self._tenant_blocks[seq.tenant] = left
                    else:
                        self._tenant_blocks.pop(seq.tenant, None)
                self._tenant_completed[seq.tenant] = \
                    self._tenant_completed.get(seq.tenant, 0) + 1
        self._completed += 1
        results.append(Completion(
            rid=seq.rid, prompt=seq.tokens[:seq.n_prompt],
            tokens=seq.tokens[seq.n_prompt:],
            logits=seq.logits if self.keep_logits else None,
            latency_s=now - seq.t_submit))

    def step(self) -> List[Completion]:
        """One engine iteration: join what fits (prefilling each joiner,
        or queueing it for chunks), advance one prefill chunk, decode one
        token for every running sequence, evict what finished. Returns
        the completions this step produced."""
        t0 = time.monotonic()
        results: List[Completion] = []
        self._join(results)
        self._advance_prefill(results)
        if self._running:
            self._decode()
            still = []
            for s in self._running:
                if s.remaining <= 0:
                    self._evict(s, results)
                else:
                    still.append(s)
            self._running = still
        # The demotion daemon (off unless a watermark armed it): above
        # the watermark, demote one batch of cold cached-tier blocks to
        # the host before the next admission needs them. Only refcount-0
        # published blocks are taken, so no live sequence loses a row.
        if self.demote_watermark > 0.0 and self.host_offload:
            used = self.cache.n_blocks - self.cache.free_blocks
            if used >= self.demote_watermark * self.cache.n_blocks:
                self.daemon_demotions += self.cache.demote(self.demote_batch)
        t1 = time.monotonic()
        with self._lock:
            self._step_times.append((t1, t1 - t0))
        self._steps += 1
        return results

    def run(self, max_steps: Optional[int] = None) -> List[Completion]:
        """Drive :meth:`step` until queue and batch drain (or
        ``max_steps``)."""
        out: List[Completion] = []
        while (self.queue_depth or self._running or self._prefilling) \
                and (max_steps is None or self._steps < max_steps):
            out.extend(self.step())
        return out

    # -- disaggregated prefill/decode (tony_tpu_torch.serve.disagg) ---------
    def prefill_only(self, req: Request) -> Dict[str, Any]:
        """The prefill-role engine mode: run ``req``'s prompt through the
        normal admission and prefill (prefix adoption, the chunked
        ``(1, chunk)`` launches — the programs a colocated engine runs,
        so the handoff cannot change a bit), emit the FIRST token, then
        export the sequence's KV blocks as the handoff payload and free
        the sequence. The engine is free for the next prompt when this
        returns.

        The caller (:class:`~tony_tpu_torch.serve.disagg.PrefillFront`)
        holds the front's drive lock: every line here mutates the
        pool."""
        n = len(req.tokens)
        if not req.tokens:
            raise ValueError(f"request {req.rid!r}: empty prompt")
        needed = self.cache.blocks_for(n)
        if n > self.ctx_pad or needed > self.cache.n_blocks:
            raise AdmissionError(
                f"request {req.rid!r}: {n}-token prompt ({needed} "
                f"blocks) > engine capacity (context {self.ctx_pad}, "
                f"pool {self.cache.n_blocks} blocks)",
                needed_blocks=needed,
                free_blocks=self.cache.free_blocks, retryable=False)
        start, matched, keys = self._admit(req, total=n)
        seq = self._start(req, time.monotonic(), start, matched, keys)
        if self.prefill_chunk is not None:
            while not self._prefill_chunk_step(seq):
                pass
        else:
            self._prefill(seq)
        first = int(seq.tokens[n])
        # The full prompt blocks' chain keys: the decode side's adoption
        # probe and its publication seed (shipped even with this
        # engine's prefix cache off).
        wire_keys = (list(keys) if self.prefix_cache
                     else prefix_mod.chain_keys(req.tokens, self.block_size))
        t_export = time.monotonic()
        payload: Dict[str, Any] = {
            "rid": req.rid,
            "tokens": [int(t) for t in req.tokens],
            "first_token": first,
            "max_new_tokens": int(req.max_new_tokens),
            "length": n,
            "conv": req.conv,
            "tenant": req.tenant,
            "keys": wire_keys,
            "blocks": self.cache.export_blocks(req.rid, n),
            **self.cache.wire_header(),
        }
        if self.keep_logits:
            payload["logits_b64"] = encode_f32(seq.logits[0])
        self.handoff_ms += 1e3 * (time.monotonic() - t_export)
        self.cache.free_seq(req.rid)
        # The prefill replica's load telemetry: a handoff never queues
        # or joins the running batch, so without this event the replica
        # would report qps 0 and p99 0 through any burst.
        now = time.monotonic()
        with self._lock:
            self._events.append((now, now - seq.t_submit, 1,
                                 seq.t_first - seq.t_submit, seq.tenant))
        self._completed += 1
        return payload

    def admit_handoff(self, payload: Dict[str, Any]
                      ) -> Tuple[Any, Optional[Completion]]:
        """The decode-role admission path: import a shipped prefill's KV
        blocks into this engine's pool (:meth:`PagedKVCache.import_blocks`,
        adopting any offered stem) and join the sequence to the running
        batch with its prompt computed, so the next iteration decodes its
        second token where a colocated engine would. Returns ``(rid,
        completion)``; ``completion`` is set only for a ``max_new_tokens
        == 1`` handoff, whose one token the prefill side produced.

        Every rejection is typed and leaves the engine unchanged: a full
        decode batch or an exhausted pool raises :class:`AdmissionError`,
        a malformed or corrupt payload, a rid already live here or chain
        keys that do not match the tokens raise
        :class:`~tony_tpu_torch.serve.disagg.HandoffError`; each counts in
        ``imports_failed``. The payload's ``conv`` and ``tenant`` ride
        into the sequence: a host-tier decode engine parks a handed-off
        conversation at eviction. The caller
        (:class:`~tony_tpu_torch.serve.disagg.DecodeFront`) holds the
        front's drive lock."""
        try:
            try:
                rid = payload["rid"]
                tokens = [int(t) for t in payload["tokens"]]
                max_new = int(payload["max_new_tokens"])
                first = int(payload["first_token"])
                offset = int(payload.get("offset", 0))
            except (KeyError, TypeError, ValueError) as e:
                raise HandoffError(
                    f"malformed handoff payload: missing or mistyped "
                    f"field ({type(e).__name__}: {e})",
                    retryable=False) from e
            n = len(tokens)
            if n != int(payload.get("length", n)) or not tokens \
                    or max_new < 1:
                raise HandoffError(
                    f"malformed handoff for {rid!r}: length "
                    f"{payload.get('length')} vs {n} prompt token(s), "
                    f"max_new_tokens {max_new}", retryable=False)
            header = self.cache.wire_header()
            got = {k: payload.get(k) for k in header}
            if got != header:
                raise HandoffError(
                    f"handoff geometry mismatch for {rid!r}: {got} vs "
                    f"this pool's {header}", retryable=False)
            total = n + max_new
            needed = self.cache.blocks_for(total)
            if total > self.ctx_pad or needed > self.cache.n_blocks:
                raise AdmissionError(
                    f"handoff {rid!r} needs {total} positions "
                    f"({needed} blocks) > engine capacity (context "
                    f"{self.ctx_pad}, pool {self.cache.n_blocks} "
                    f"blocks); it can never be admitted",
                    needed_blocks=needed,
                    free_blocks=self.cache.free_blocks, retryable=False)
            if self.running >= self.max_running:
                raise AdmissionError(
                    f"handoff {rid!r} rejected: decode batch full "
                    f"({self.running}/{self.max_running} running)",
                    needed_blocks=needed,
                    free_blocks=self.cache.free_blocks)
            # A rid already live HERE would tear the front's rid-keyed
            # completion routing: reject typed before any import.
            live = {s.rid for s in self._running} \
                | {s.rid for s in self._prefilling} \
                | set(self.cache.owned_blocks())
            with self._lock:
                live |= {r.rid for r, _ in self._queue}
            if rid in live:
                raise HandoffError(
                    f"handoff rid {rid!r} collides with a live sequence "
                    f"on this engine — rids must be unique fleet-wide",
                    retryable=False)
            # The shipped blocks and the adopted stem must cover the
            # prompt exactly, or the uncovered extent would decode from
            # stale pool rows.
            shipped = list(payload.get("blocks") or ())
            if offset + len(shipped) != self.cache.blocks_for(n):
                raise HandoffError(
                    f"handoff {rid!r} blocks do not cover the prompt: "
                    f"{offset} adopted + {len(shipped)} shipped != "
                    f"{self.cache.blocks_for(n)} prompt block(s) for "
                    f"{n} token(s)", retryable=False)
            # The keys index imported blocks into the SHARED prefix
            # tier, so they must be the tokens' own.
            keys = [str(k) for k in payload.get("keys") or ()]
            true_keys = prefix_mod.chain_keys(tokens, self.block_size)
            if keys and keys != true_keys:
                raise HandoffError(
                    f"handoff chain keys for {rid!r} do not match the "
                    f"shipped tokens ({len(keys)} key(s) vs "
                    f"{len(true_keys)} derived) — key-scheme skew "
                    f"between the gangs", retryable=False)
            first_row: Optional[np.ndarray] = None
            if self.keep_logits and payload.get("logits_b64"):
                # Decoded before the import: the row rides outside the
                # per-block CRC, and a corrupt one must reject with the
                # pool unchanged.
                try:
                    first_row = decode_f32(payload["logits_b64"])
                except (ValueError, TypeError) as e:
                    raise HandoffError(
                        f"malformed handoff logits for {rid!r}: {e}",
                        retryable=False) from e
            t_import = time.monotonic()
            self.cache.import_blocks(rid, total, shipped, keys=keys,
                                     offset=offset)
            self.handoff_ms += 1e3 * (time.monotonic() - t_import)
        except (AdmissionError, HandoffError):
            self.imports_failed += 1
            raise
        now = time.monotonic()
        seq = _Seq(Request(rid=rid, tokens=tokens, max_new_tokens=max_new,
                           conv=payload.get("conv"),
                           tenant=payload.get("tenant")), now)
        seq.pf_pos = n                     # the prompt arrived computed
        seq.t_first = now                  # with its first token
        seq.tokens.append(first)
        seq.remaining -= 1
        if first_row is not None:
            seq.logits.append(first_row)
        if self.prefix_cache and keys:
            # The imported prompt blocks hold verified rows: index them
            # under the shipped keys (adopted ones are indexed already)
            # and publish only what decode computes from here.
            for i, key in enumerate(keys):
                self.cache.publish_block(rid, i, key)
            self._note_parents(keys)
            seq.published = len(keys)
            seq.hkey = keys[-1]
        self.handoffs_in += 1
        if seq.remaining <= 0:             # max_new_tokens == 1
            done: List[Completion] = []
            self._evict(seq, done)
            return rid, done[0]
        self._running.append(seq)
        return rid, None

    def note_handoff_shipped(self, blocks: int) -> None:
        """Bank one completed outbound handoff's shipped blocks. Called
        by :class:`~tony_tpu_torch.serve.disagg.PrefillFront`, possibly
        from concurrent RPC threads outside the drive lock, hence the
        engine lock."""
        with self._lock:
            self.blocks_shipped += int(blocks)
            self.handoffs_out += 1

    # -- persisted prefix store (tony_tpu_torch.serve.kvstore) --------------
    def adopt_stem(self, keys: Sequence[str],
                   blocks: Sequence[Dict[str, Any]]) -> int:
        """Seed the prefix tier from a persisted stem (replica start):
        import the chain's payloads through the check-then-commit path a
        handoff rides, publish them, and release the scratch
        reservation, so the blocks land refcount 0 in the cached tier
        where a local stem would sit. Best effort: a corrupt block or
        pool pressure adopts nothing (the replica warms by recompute),
        never an error. Returns the blocks newly indexed."""
        keys = [str(k) for k in keys]
        if not self.prefix_cache or not keys or len(keys) != len(blocks):
            return 0
        matched = len(self.cache.match_prefix(keys))
        if matched >= len(keys):
            return 0
        sid = ("stem", keys[-1])
        try:
            self.cache.import_blocks(sid, len(keys) * self.block_size,
                                     list(blocks)[matched:], keys=keys,
                                     offset=matched)
        except (AdmissionError, HandoffError):
            return 0
        for i, key in enumerate(keys):
            self.cache.publish_block(sid, i, key)
        self.cache.free_seq(sid)
        self._note_parents(keys)
        self.store_adopted += len(keys) - matched
        return len(keys) - matched

    def export_stems(self, store: Any, limit: int = 8, *,
                     lock: Any = None) -> int:
        """Persist the hottest adopted stems (chains a SECOND prompt
        proved shared) into ``store`` (a
        :class:`~tony_tpu_torch.serve.kvstore.PrefixStore`), once a tip,
        skipping chains whose blocks left the device index. Only the
        choice of a chain and its one device-to-host fetch run under
        ``lock`` (the front's drive lock; None when the caller holds
        it): the base64 and CRC encode and the store's write run on the
        fetched host copy after it is released, so serving stalls for
        the fetch alone. Returns the stems written."""
        guard = lock if lock is not None else contextlib.nullcontext()
        with guard:
            tips = [t for t in list(self._hot_tips)[-limit:]
                    if t not in self._stored_tips]
        wrote = 0
        for tip in tips:
            with guard:
                chain = self._stem_chain(tip)
                if chain is None:
                    continue
                raw = self.cache.fetch_keys(chain)
                header = self.cache.wire_header()
                swaps = self.weight_swaps
            store.put(chain, encode_blocks(raw), header)
            with guard:
                # A swap in between flushed the bookkeeping: the tip is
                # not this version's to mark.
                if self.weight_swaps == swaps:
                    self._stored_tips.add(tip)
            wrote += 1
        return wrote

    def _stem_chain(self, tip: str) -> Optional[List[str]]:
        """The chain of keys from the root to ``tip`` through the noted
        parents, when all of it is still on the device (None when a
        parent is unknown or a block aged out)."""
        chain: List[str] = []
        key = tip
        while key:
            chain.append(key)
            key = self._chain_parent.get(key)
            if key is None or len(chain) > self.cache.n_blocks:
                return None
        chain.reverse()
        if len(self.cache.match_prefix(chain)) < len(chain):
            return None                  # partly aged out: not exportable
        return chain

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
        # The scratch pool's blocks and its sink block.
        shape = (self.n_layers, nb_s + 1, self.block_size, self.kv_dim)
        scratch_k = torch.zeros(shape, dtype=self.cache.k.dtype,
                                device=self.cache.k.device)
        scratch_v = torch.zeros_like(scratch_k)
        dev = scratch_k.device
        logits = self._fn(1, t_pad, nb_s)(
            scratch_k, scratch_v,
            *(torch.as_tensor(a, device=dev)
              for a in (toks, positions, tables, flat)))
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
        gate; the host tier's, the prefix store's and the QoS counters,
        and ``tenants``, the per-tenant breakdown (qps, tokens/s, p99,
        queued, blocks, completed, deferred) over the same window. Every
        key the control plane reads of the reference's engine is here,
        at its idle value where a lane is off (the uniform-schema rule).
        Recorded under ``"<tag>_stats"``."""
        if t0 is None or t1 is None:
            t1 = time.monotonic()
            t0 = max(self._t0, t1 - self.stats_window_s)
        with self._lock:
            events = [e for e in self._events if t0 <= e[0] <= t1]
            steps = sorted(s for t, s in self._step_times if t0 <= t <= t1)
            prompt_hist = dict(self._prompt_hist)
            tenant_blocks = dict(self._tenant_blocks)
            tenant_completed = dict(self._tenant_completed)
            tenant_deferrals = dict(self._tenant_deferrals)
            tenant_queued: Dict[str, int] = {}
            for r, _ in self._queue:
                if r.tenant is not None:
                    tenant_queued[r.tenant] = \
                        tenant_queued.get(r.tenant, 0) + 1
            rejections = self.admission_rejections
        lat = sorted(e[1] for e in events)
        ttft = sorted(e[3] for e in events)
        dt = max(1e-9, t1 - t0)

        def pct(vals: List[float], p: float) -> float:
            if not vals:
                return 0.0
            return vals[min(len(vals) - 1, int(p * (len(vals) - 1) + 0.5))]

        per_lat: Dict[str, List[float]] = {}
        per_tok: Dict[str, float] = {}
        for e in events:
            if e[4] is not None:
                per_lat.setdefault(e[4], []).append(e[1])
                per_tok[e[4]] = per_tok.get(e[4], 0.0) + e[2]
        tenants: Dict[str, Dict[str, float]] = {}
        for ten in sorted(set(per_lat) | set(tenant_blocks)
                          | set(tenant_queued) | set(tenant_completed)
                          | set(tenant_deferrals)):
            lats = sorted(per_lat.get(ten, []))
            tenants[ten] = {
                "qps": len(lats) / dt,
                "tokens_per_s": per_tok.get(ten, 0.0) / dt,
                "p99_ms": 1e3 * pct(lats, 0.99),
                "queued": float(tenant_queued.get(ten, 0)),
                "blocks": float(tenant_blocks.get(ten, 0)),
                "completed": float(tenant_completed.get(ten, 0)),
                "deferred": float(tenant_deferrals.get(ten, 0)),
            }

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
            # Prefix cache and chunked prefill: zeros with the lanes off.
            "prefix_cache_hit_rate": (
                self.prefix_hit_blocks / self.prefix_lookup_blocks
                if self.prefix_lookup_blocks else 0.0),
            "blocks_shared": float(self.cache.adopted_total),
            "prefill_chunks": float(self.prefill_chunks),
            # The speculative lane's rate (SpecEngine overrides it).
            "acceptance_rate": 0.0,
            # Disaggregated serving: the role as a string, the handoff
            # counters (zeros on a colocated engine).
            "role": self.role,
            "blocks_shipped": float(self.blocks_shipped),
            "handoff_ms": float(self.handoff_ms),
            "imports_failed": float(self.imports_failed),
            # Cold-start plane: zeros when unarmed. warm_standby rides
            # the heartbeat so the session keeps a standby out of the
            # routable endpoints until the AM promotes it.
            "aot_hits": float(self.aot_hits),
            "aot_misses": float(self.aot_misses),
            "compile_ms": float(self.compile_ms),
            "warm_standby": 1.0 if self.warm_standby else 0.0,
            # The KV memory hierarchy: zeros without the host tier.
            # park_hit_rate is the share of conversation-tagged
            # admissions that resumed from parked KV.
            "host_blocks": float(self.cache.host_blocks_used),
            "parked_seqs": float(len(self._parked)),
            "demotions": float(self.cache.demoted_total),
            "promotions": float(self.cache.promoted_total),
            "park_hit_rate": (self.park_hits / self.park_lookups
                              if self.park_lookups else 0.0),
            "daemon_demotions": float(self.daemon_demotions),
            # Tenant budgets: zeros and an empty dict on an untagged
            # engine.
            "admission_rejections": float(rejections),
            "qos_deferrals": float(self.qos_deferrals),
            "tenants": tenants,
            "weight_version": float(self.weight_version),
            "weight_step": float(self.weight_step),
            "weight_swaps": float(self.weight_swaps),
            "swapping": 1.0 if self.swapping else 0.0,
            "prompt_hist": {str(k): float(v)
                            for k, v in sorted(prompt_hist.items())},
        }
        stats.update(self._extra_stats())
        profiler.safe_record(f"{self.tag}_stats", **stats)
        return stats

    def _extra_stats(self) -> Dict[str, float]:
        """Subclass hook (the speculative engine's counters), merged
        into :meth:`stats`."""
        return {}

    def prefix_digest(self, limit: int = 256) -> List[str]:
        """The most recently used published chain keys: the replica's
        content advertisement the router scores overlap against; empty
        with the prefix cache off."""
        if not self.prefix_cache:
            return []
        return self.cache.digest(limit)

    def parked_digest(self, limit: int = 256) -> List[str]:
        """The conversation handles whose KV this engine holds parked:
        advertised on the heartbeat beside the prefix digest, so the
        router pins a returning turn to the replica that can resume it.
        Empty without the host tier."""
        return [str(c) for c in list(self._parked)[-limit:]]

    def write_stats(self, path: str,
                    extra: Optional[Dict[str, Any]] = None) -> None:
        """Atomically publish :meth:`stats` (+ the prefix and parked
        digests when they are non-empty, + ``extra``: the replica adds
        its RPC port) as JSON: the file the executor's heartbeat carries
        to the AM."""
        payload: Dict[str, Any] = dict(self.stats())
        digest = self.prefix_digest()
        if digest:
            payload["prefix_digest"] = digest
        parked = self.parked_digest()
        if parked:
            payload["parked_digest"] = parked
        if extra:
            payload.update(extra)
        # One temp file per writer: the replica's publisher thread and a
        # hot swap's republish may write at once.
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)


    # -- warm-standby promotion --------------------------------------------
    def promote(self) -> bool:
        """Leave warm standby: the AM's scale-up path calls this (over
        the replica's ``promote`` RPC verb) instead of cold-granting a
        container; the next stats publish advertises warm_standby=0 and
        the session adds the replica to the routable endpoints. Returns
        whether the engine WAS a standby (idempotent: promoting an
        active engine is a no-op, so a duplicated RPC is harmless)."""
        with self._lock:
            was = self.warm_standby
            self.warm_standby = False
        return was

    def swap_params(self, new: Mapping[str, torch.Tensor], *, version: int,
                    step: int) -> None:
        """The base flip, then the prefix tier and the host stems
        flushed: every published block and demoted stem holds rows
        computed under the old weights, so a post-swap hit would serve a
        mixed-version answer. Parked conversations are KEPT: a resumed
        turn keeps its pre-swap history's KV (their continuity
        contract)."""
        super().swap_params(new, version=version, step=step)
        self.cache.flush_prefix()
        # The stem-export bookkeeping names flushed keys.
        self._chain_parent.clear()
        self._hot_tips.clear()
        self._stored_tips.clear()


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
        completes. ``conv`` tags the request with its conversation
        handle, so a host-tier engine parks and resumes it across turns;
        ``tenant`` names its QoS class on a budget-armed engine."""
        if rid is None:
            rid = self.fresh_rid()
        self.engine.submit(Request(rid=rid, tokens=list(tokens),
                                   max_new_tokens=int(max_new_tokens),
                                   conv=conv, tenant=tenant))
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
                while self.engine._running or self.engine._prefilling:
                    for c in self.engine.step():
                        self._done[c.rid] = c
                fn()
            finally:
                self.engine.swapping = False
