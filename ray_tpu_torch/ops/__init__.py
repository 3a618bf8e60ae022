"""Ops of the port: plain PyTorch versions and hand-written CUDA kernels.

The package exports what the reference's ``ops`` does, ``causal_attention``;
the rest is reached through its modules
(``ray_tpu_torch.ops.flash_attention.flash_attention``,
``ray_tpu_torch.ops.ring_attention.ring_attention_sharded``)."""

from ray_tpu_torch.ops.attention import causal_attention  # noqa: F401
