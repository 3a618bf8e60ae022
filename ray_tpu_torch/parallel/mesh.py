"""Device-mesh construction (port of ``ray_tpu/parallel/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` over every chip its one process
owns. The port's unit is a rank of a ``torch.distributed`` process group,
one device each; ``make_mesh`` lays those ranks out as a
``torch.distributed.device_mesh.DeviceMesh`` in ``AXES`` order, factoring a
total rank count the reference's way (tp innermost, then sp, ep, fsdp, with
dp outermost: the axis that crosses hosts).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

# Axis order = rank-grid nesting, outermost → innermost: tp is the
# fastest-varying axis (adjacent ranks), then sp, then fsdp, with dp
# outermost (the axis that crosses hosts). Sharding specs refer to axes by
# NAME, so this ordering only affects which ranks form each axis group.
AXES = ("dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass
class MeshConfig:
    """Logical axis sizes. ``-1`` on one axis means "all remaining ranks"."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1  # expert parallelism (MoE experts sharded over this axis)

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {
            "dp": self.dp, "fsdp": self.fsdp, "ep": self.ep,
            "tp": self.tp, "sp": self.sp,
        }
        fixed = [a for a, s in sizes.items() if s != -1]
        free = [a for a, s in sizes.items() if s == -1]
        if len(free) > 1:
            raise ValueError("at most one mesh axis may be -1")
        prod = math.prod(sizes[a] for a in fixed)
        if free:
            if n_devices % prod:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[free[0]] = n_devices // prod
        elif prod != n_devices:
            raise ValueError(f"mesh {sizes} needs {prod} devices, have {n_devices}")
        return sizes


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name``; 1 for an axis it lacks (the
    reference's ``mesh.shape.get(name, 1)``)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def _device_and_ranks(devices) -> tuple[str, Optional[list[int]]]:
    """``devices``: None (the card), a device type (``"cuda"``, ``"cpu"``
    or a ``torch.device``), or ``(device type, ranks)``."""
    if isinstance(devices, tuple) and len(devices) == 2 and not isinstance(devices[1], int):
        kind, ranks = devices
        ranks = [int(r) for r in ranks]
    else:
        kind, ranks = devices, None
    kind = "cuda" if kind is None else str(getattr(kind, "type", kind))
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"a mesh's device type is 'cuda' or 'cpu', got {kind!r}")
    return kind, ranks


def ensure_group(device_type: str = "cuda") -> None:
    """Start a process group of one when none exists: NCCL for the card,
    gloo for ``"cpu"``. A CUDA group without a card raises; nothing falls
    back to the CPU."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device available (torch.cuda.is_available() is False); "
                "pass devices='cpu' for a gloo mesh on the CPU"
            )
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def mesh_from_ranks(device_type: str, ranks, axis_names: Sequence[str]):
    """A ``DeviceMesh`` over an explicit array of ranks (its shape is the
    mesh's) with ``axis_names``; every rank of the default group calls it."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.as_tensor(ranks, dtype=torch.int64),
                      mesh_dim_names=tuple(axis_names))


def make_mesh(
    config: Optional[MeshConfig] = None,
    *,
    devices=None,
    axis_names: Sequence[str] = AXES,
):
    """Build a ``DeviceMesh`` over the default process group's ranks.

    ``devices`` names the device type and, optionally, the ranks: None
    means the card (``"cuda"``) over every rank, ``"cpu"`` a gloo mesh over
    every rank, ``(device type, ranks)`` the given ranks in that order.
    Where no process group exists, a group of one is started (NCCL for the
    card, gloo for the CPU); asking for the card without one raises.

    Rank order: the ``AXES`` ordering makes ``tp`` the innermost
    (fastest-varying) position, then ``sp``, ``ep``, ``fsdp``, with ``dp``
    outermost, as the reference orders its devices.
    """
    import numpy as np
    import torch.distributed as dist

    kind, ranks = _device_and_ranks(devices)
    ensure_group(kind)
    if ranks is None:
        ranks = list(range(dist.get_world_size()))
    config = config or MeshConfig()
    sizes = config.resolve(len(ranks))
    arr = np.asarray(ranks).reshape([sizes[a] for a in axis_names])
    return mesh_from_ranks(kind, arr, axis_names)


def make_tp_mesh(
    tp: int,
    *,
    devices=None,
    axis_names: Sequence[str] = ("tp",),
):
    """Build the 1-axis ``("tp",)`` mesh a tensor-parallel engine runs on:
    the first ``tp`` ranks (``devices`` as for ``make_mesh``; an explicit
    rank list must hold exactly ``tp``)."""
    kind, ranks = _device_and_ranks(devices)
    ensure_group(kind)
    if ranks is None:
        import torch.distributed as dist

        ranks = list(range(min(tp, dist.get_world_size())))
    if len(ranks) != tp:
        raise ValueError(f"tp={tp} needs {tp} devices, have {len(ranks)}")
    return mesh_from_ranks(kind, ranks, axis_names)
