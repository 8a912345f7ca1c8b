"""Serving plane of the port: the counterpart of the core of
:mod:`tony_tpu.serve`.

* :mod:`~tony_tpu_torch.serve.kvcache` — the paged KV cache: a block
  pool with per-sequence block tables and typed admission errors;
* :mod:`~tony_tpu_torch.serve.engine` — the continuous-batching loop and
  its thread-safe :class:`EngineFront`, with attention in the
  hand-written flash-decode kernel, the stats heartbeat and the in-place
  weight swap;
* :mod:`~tony_tpu_torch.serve.replica` — the serve job's process
  (``python -m tony_tpu_torch.serve.replica``): the published training
  step restored into the engine, served behind the RPC wire, its stats
  written for the executor's heartbeat, hot-swapped onto a new
  publication;
* :mod:`~tony_tpu_torch.serve.swap` — :class:`SwapError` and
  :func:`resolve_target`, the replica's half of the hot swap.

Still to port (ROADMAP.md): the speculative, prefix-cache,
chunked-prefill, disaggregated (handoff verbs), host-tier, prefix-store
and QoS lanes (item 9); the AOT cache, ``warm()``, the warm-standby pool
with its ``promote`` verb, demotion and ``tune_warm_pads`` (item 12); a
serve mesh (item 8); the router, autoscaler and fleet swap controller,
which stay in the control plane.
"""

from tony_tpu_torch.serve.engine import (Completion, EngineFront,
                                         PagedModelRunner, Request,
                                         ServeEngine, build_step_fn)
from tony_tpu_torch.serve.kvcache import AdmissionError, PagedKVCache
from tony_tpu_torch.serve.replica import Replica
from tony_tpu_torch.serve.swap import SwapError, resolve_target

__all__ = ["AdmissionError", "Completion", "EngineFront",
           "PagedKVCache", "PagedModelRunner", "Replica", "Request",
           "ServeEngine", "SwapError", "build_step_fn", "resolve_target"]
