"""Hot weight swap, the replica's half: a copy of :class:`SwapError` and
:func:`resolve_target` of :mod:`tony_tpu.serve.swap` over the port's
checkpoint format and publication pointer.

The train gang advances a versioned pointer over its committed steps
(:mod:`tony_tpu_torch.publish`); a replica swaps onto it in place
(:meth:`tony_tpu_torch.serve.replica.Replica.hot_swap`: restore beside
the live weights, quiesce, flip). The AM's rolling-swap pacing
(``FleetSwapController``) stays in the control plane.
"""

from __future__ import annotations

from typing import Optional, Tuple

from tony_tpu_torch.ckpt.format import committed_steps
from tony_tpu_torch.publish import latest_publication

__all__ = ["SwapError", "resolve_target"]


class SwapError(RuntimeError):
    """A hot swap that could not commit. The contract every raiser
    honors: the engine still holds the OLD params, whole — geometry
    mismatch, missing manifest, and restore failures all roll back to
    exactly the weights that were serving before the attempt."""


def resolve_target(ckpt_dir: str, *, version: Optional[int] = None,
                   step: Optional[int] = None) -> Tuple[int, int]:
    """What a swap should restore: ``(version, step)``.

    Default is the published pointer (:func:`latest_publication`); an
    explicit ``step`` overrides it (an operator pinning a roll-back
    target) and mints version 0 when no pointer names it. ``version``
    asserts the pointer still carries the version the caller saw — a
    publication racing past it is a :class:`SwapError`, not a silent
    swap onto weights nobody asked for."""
    rec = latest_publication(ckpt_dir)
    if step is not None:
        step = int(step)
        if step not in committed_steps(ckpt_dir):
            raise SwapError(f"step {step} has no committed manifest "
                            f"under {ckpt_dir}")
        if rec is not None and rec["step"] == step:
            return rec["version"], step
        return 0, step
    if rec is None:
        raise SwapError(f"no publication under {ckpt_dir} — nothing to "
                        f"swap to (run `tony publish` or arm "
                        f"publish_every on the train loop)")
    if version is not None and rec["version"] != int(version):
        raise SwapError(f"publication moved: wanted version {version}, "
                        f"pointer now names {rec['version']}")
    return rec["version"], rec["step"]
