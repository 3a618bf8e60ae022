from ray_tpu_torch.accelerators import gpu  # noqa: F401
