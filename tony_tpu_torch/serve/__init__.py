"""Serving plane of the port: the counterpart of the core of
:mod:`tony_tpu.serve`.

* :mod:`~tony_tpu_torch.serve.kvcache` — the paged KV cache: a block
  pool with per-sequence block tables and typed admission errors;
* :mod:`~tony_tpu_torch.serve.engine` — the continuous-batching loop and
  its thread-safe :class:`EngineFront`, with attention in the
  hand-written flash-decode kernel.

The replica process, RPC front, checkpoint restore, and the prefix,
chunked-prefill, speculative, disaggregated, host-tier, QoS and hot-swap
lanes come with later slices (ROADMAP.md).
"""

from tony_tpu_torch.serve.engine import (Completion, EngineFront,
                                         PagedModelRunner, Request,
                                         ServeEngine, build_step_fn)
from tony_tpu_torch.serve.kvcache import AdmissionError, PagedKVCache

__all__ = ["AdmissionError", "Completion", "EngineFront",
           "PagedKVCache", "PagedModelRunner", "Request", "ServeEngine",
           "build_step_fn"]
