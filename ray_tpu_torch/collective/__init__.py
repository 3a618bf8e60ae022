"""ray_tpu_torch.collective — collectives among actors over the host plane
(copy of ``ray_tpu/collective/``). See ``collective.py`` for the backend
story; ``mesh_allreduce`` reduces a device tensor over a ``DeviceMesh``."""

from ray_tpu_torch.collective.collective import (  # noqa: F401
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    mesh_allreduce,
    recv,
    reducescatter,
    send,
)
from ray_tpu_torch.collective.types import ReduceOp  # noqa: F401
