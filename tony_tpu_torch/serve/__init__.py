"""Serving plane of the port: the counterpart of the core of
:mod:`tony_tpu.serve`.

* :mod:`~tony_tpu_torch.serve.kvcache` — the paged KV cache: a block
  pool with per-sequence block tables and typed admission errors, its
  wire tier (``export_blocks``/``import_blocks``) and its host tier
  (demotion and promotion of stems, parked conversations);
* :mod:`~tony_tpu_torch.serve.kvstore` — the persisted prefix store
  (standard library only): hot stems on disk by stage and rename;
* :mod:`~tony_tpu_torch.serve.qos` — tenant classes and their
  weighted-fair block budgets (standard library only);
* :mod:`~tony_tpu_torch.serve.prefix` — the chain keys of the prefix
  cache, byte-identical to the JAX package's;
* :mod:`~tony_tpu_torch.serve.engine` — the continuous-batching loop and
  its thread-safe :class:`EngineFront`, with attention in the
  hand-written flash-decode kernel, the prefix-cache and chunked-prefill
  lanes, conversation parking, the demotion daemon, the tenant budgets,
  the prefill-only and handoff-admission entry points, the stats
  heartbeat and the in-place weight swap;
* :mod:`~tony_tpu_torch.serve.spec` — speculative decoding: the n-gram
  and model drafts and :class:`SpecEngine`'s one-launch verify;
* :mod:`~tony_tpu_torch.serve.disagg` — disaggregated prefill/decode
  (no tensor library): the KV handoff's shipper and receiver fronts and
  :class:`HandoffError`;
* :mod:`~tony_tpu_torch.serve.router` — the fleet's request router (no
  tensor library): scoring, sticky affinity, failover, the role-aware
  split, and its RPC server polling the AM;
* :mod:`~tony_tpu_torch.serve.replica` — the serve job's process
  (``python -m tony_tpu_torch.serve.replica``): the published training
  step restored into the engine, served behind the RPC wire, its stats
  written for the executor's heartbeat, hot-swapped onto a new
  publication;
* :mod:`~tony_tpu_torch.serve.swap` — :class:`SwapError` and
  :func:`resolve_target`, the replica's half of the hot swap.

Still to port (ROADMAP.md): a serve mesh (item 8); the autoscaler, its
per-tenant SLO targets and the fleet swap controller (item 10).

A lazy facade (PEP 562, as the reference's): the engine imports torch,
and the router and the handoff's error type are imported on gateway
hosts without it.
"""

from typing import Any

# name -> owning submodule (None: the name is a submodule).
_LAZY = {
    "AdmissionError": "kvcache", "PagedKVCache": "kvcache",
    "PrefixStore": "kvstore", "QosPolicy": "qos",
    "parse_tenants": "qos",
    "Completion": "engine", "EngineFront": "engine",
    "PagedModelRunner": "engine", "Request": "engine",
    "ServeEngine": "engine", "build_step_fn": "engine",
    "ModelDraft": "spec", "NgramDraft": "spec", "SpecEngine": "spec",
    "NoReplicaError": "router", "RequestRouter": "router",
    "RouterPolicy": "router", "RouterServer": "router",
    "HandoffError": "disagg", "KVShipper": "disagg",
    "PrefillFront": "disagg", "DecodeFront": "disagg",
    "Replica": "replica", "SwapError": "swap", "resolve_target": "swap",
    "disagg": None, "engine": None, "kvcache": None, "kvstore": None,
    "prefix": None, "qos": None,
    "replica": None, "router": None, "spec": None, "swap": None,
}
__all__ = sorted(_LAZY)


def __getattr__(name: str) -> Any:
    import importlib

    owner = _LAZY.get(name, "<missing>")
    if owner == "<missing>":
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    if owner is None:
        return importlib.import_module(f"{__name__}.{name}")
    return getattr(importlib.import_module(f"{__name__}.{owner}"), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
