"""Hot-path ops of the port: hand-written CUDA kernels for Hopper beside
their plain PyTorch versions.

A wrapper runs its plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel (built from ``csrc/`` at first use by
:mod:`tony_tpu_torch.ops._build`) or raises. ``LAUNCHES`` counts kernel
launches by wrapper name.
"""

from tony_tpu_torch.ops.attention import (LAUNCHES, flash_attention,
                                          flash_attention_packed,
                                          flash_attention_sharded,
                                          flash_decode, reference_attention)
from tony_tpu_torch.ops.batchnorm import fused_bn_act
from tony_tpu_torch.ops.fused_optim import (FusedOptimizer,
                                            fused_bucket_update)
from tony_tpu_torch.ops.quant import (QuantDense, int8_matmul, quant_dot,
                                      quant_dot_general)

__all__ = ["LAUNCHES", "FusedOptimizer", "QuantDense", "flash_attention",
           "flash_attention_packed", "flash_attention_sharded",
           "flash_decode", "fused_bn_act",
           "fused_bucket_update", "int8_matmul", "quant_dot",
           "quant_dot_general", "reference_attention"]
