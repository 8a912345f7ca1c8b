"""Parallelism plane of the port: the counterpart of
:mod:`tony_tpu.parallel`.

Only the one-device part is ported so far: the gradient-bucket planner
and microbatch accumulation of :mod:`~tony_tpu_torch.parallel.overlap`
(:class:`GradBuckets`, :func:`microbatch_grads`), which the accumulating
train step and the fused bucket optimizer run on. Meshes, ZeRO-3 scatter
buckets, collective scheduling and multi-slice reduction come with their
slice (ROADMAP.md, queue 1 item 8).
"""

from tony_tpu_torch.parallel.overlap import (DEFAULT_BUCKET_BYTES,
                                             GradBuckets, ResidentBuckets,
                                             microbatch_grads)

__all__ = ["DEFAULT_BUCKET_BYTES", "GradBuckets", "ResidentBuckets",
           "microbatch_grads"]
