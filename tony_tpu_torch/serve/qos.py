"""Per-tenant QoS classes for the serving engine (the port's copy of
:mod:`tony_tpu.serve.qos`; standard library only).

Requests carry a ``tenant`` tag end to end (CLI → router → engine →
heartbeat); this module turns the ``tony.serve.qos.tenants`` CSV into a
weighted-fair KV-block budget the engine consults at admission:

* the **policy** is a frozen weight map ("gold:3,silver:1"). A tenant's
  budget over an ``n_blocks`` pool is its weight's share of the weights
  of the tenants *currently active* (holding blocks or queued): work
  conserving, so a lone tenant gets the whole pool and an idle tenant's
  share redistributes;
* the **enforcement point** is the engine's admission scan, not the
  paged pool: the engine defers a request whose tenant is over budget
  and lets later tenants' requests admit past it (per-tenant FIFO is
  kept: a deferred tenant's LATER requests also wait);
* **back-pressure** is the typed ``AdmissionError``: a tenant whose
  queue reaches ``max_queue`` (0 = unbounded) is refused, retryable, at
  submit — never the victim tenant, whose stream stays that of an
  unloaded engine.

Untagged requests bypass budgets, and with no policy armed the
admission path is the unarmed engine's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

__all__ = ["QosPolicy", "parse_tenants"]


def parse_tenants(spec: str) -> Dict[str, float]:
    """Parse the ``tony.serve.qos.tenants`` CSV: ``"gold:3,silver:1"``
    → ``{"gold": 3.0, "silver": 1.0}``. A bare name gets weight 1.
    Raises ``ValueError`` on empty names, non-positive or non-numeric
    weights, duplicate tenants and a spec that names none."""
    classes: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"empty tenant name in qos spec {spec!r}")
        if name in classes:
            raise ValueError(f"duplicate tenant {name!r} in qos spec")
        try:
            weight = float(w) if w.strip() else 1.0
        except ValueError:
            raise ValueError(
                f"tenant {name!r}: weight {w!r} is not a number") from None
        if weight <= 0 or weight != weight:  # reject <=0 and NaN
            raise ValueError(
                f"tenant {name!r}: weight must be > 0, got {w!r}")
        classes[name] = weight
    if not classes:
        raise ValueError(
            f"qos spec {spec!r} names no tenants (an empty spec means "
            f"QoS off — leave the conf key unset instead)")
    return classes


@dataclass(frozen=True)
class QosPolicy:
    """Weighted-fair tenant classes over a paged KV pool.

    ``classes`` maps tenant name → weight. A tenant not in the map is
    still admitted, at ``default_weight``: a policy never turns a
    request away for being unknown, only for being over budget or over
    its queue cap."""

    classes: Dict[str, float] = field(default_factory=dict)
    default_weight: float = 1.0
    # Per-tenant pending-queue cap enforced at submit (0 = unbounded).
    max_queue: int = 0

    def __post_init__(self) -> None:
        for name, w in self.classes.items():
            if not name or w <= 0:
                raise ValueError(
                    f"qos class {name!r}: weight must be > 0, got {w}")
        if self.default_weight <= 0:
            raise ValueError("default_weight must be > 0")
        if self.max_queue < 0:
            raise ValueError("max_queue must be >= 0")

    @classmethod
    def from_conf(cls, conf) -> Optional["QosPolicy"]:
        """Build from the ``tony.serve.qos.*`` conf keys; None when the
        tenants CSV is empty or absent (QoS off)."""
        from tony_tpu_torch import conf as conf_mod

        spec = conf.get(conf_mod.SERVE_QOS_TENANTS) or ""
        if not spec.strip():
            return None
        return cls(classes=parse_tenants(spec),
                   max_queue=conf.get_int(conf_mod.SERVE_QOS_MAX_QUEUE, 0))

    def weight(self, tenant: str) -> float:
        return self.classes.get(tenant, self.default_weight)

    def budget(self, tenant: str, n_blocks: int,
               active: Iterable[str]) -> int:
        """Fair-share block budget of ``tenant`` over an ``n_blocks``
        pool, given the *active* tenants (holding blocks or queued;
        ``tenant`` itself is added). The denominator is the active
        weights only, so a lone tenant's budget is the whole pool. A
        floor of one block: a positive-weight tenant can always make
        progress once the pool drains."""
        names = set(active)
        names.add(tenant)
        total = sum(self.weight(n) for n in names)
        if total <= 0:
            return n_blocks
        return max(1, int(n_blocks * self.weight(tenant) / total))
