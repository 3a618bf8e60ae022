"""Experimental runtime features (reference: ``python/ray/experimental/``)."""

from ray_tpu_torch.experimental.channel import Channel  # noqa: F401
