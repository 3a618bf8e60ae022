"""Ops of the port: plain PyTorch versions and hand-written CUDA kernels.

``flash_attention`` and ``paged_attention`` share their modules' names, so
they are reached through their modules
(``ray_tpu_torch.ops.flash_attention.flash_attention``)."""

from ray_tpu_torch.ops.attention import causal_attention  # noqa: F401
from ray_tpu_torch.ops.flash_attention import FlashAttention  # noqa: F401
from ray_tpu_torch.ops.fused_ce import (  # noqa: F401
    fused_softmax_cross_entropy,
    fused_softmax_cross_entropy_bias,
)
