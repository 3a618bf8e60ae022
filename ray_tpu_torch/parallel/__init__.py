"""Training-step machinery of the port (one device; the mesh comes later)."""

from ray_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState,
    adamw,
    build_train_step,
    profile_step_fn,
)
