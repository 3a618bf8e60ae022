"""Multi-slice meshes: data parallelism across hosts, everything else
within one (port of ``ray_tpu/parallel/multislice.py``).

The reference builds a hybrid device mesh whose ``dp`` axis is SLICE-MAJOR:
its groups pair corresponding chips of different slices, so data-parallel
gradient reduction is the only traffic that crosses the datacenter network
(DCN), while tp/sp/fsdp stay on a slice's ICI. The port's unit is a rank:
a "slice" is a group of ranks (one host's cards, whose collectives ride
NVLink), and ``make_multislice_mesh`` lays an explicit rank array out so
that ``dp``'s major dimension enumerates slices. No new axis name is
introduced — the model and sharding code is unchanged.

Ranks (or any device objects) carrying a ``slice_index`` are grouped by it;
anything else is partitioned into ``num_slices`` contiguous groups, which
keeps the slice-major dp semantics for a CPU dryrun
(``launch_multislice_procs``: fresh gloo processes, one per rank).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from ray_tpu_torch.parallel.mesh import AXES, MeshConfig, _device_and_ranks, ensure_group, mesh_from_ranks


def slice_groups(devices: Sequence, num_slices: Optional[int] = None) -> list[list]:
    """Partition ranks (or devices) into slices: by their ``slice_index``
    when every one has it, else into ``num_slices`` contiguous groups."""
    by_idx: dict[int, list] = {}
    if all(getattr(d, "slice_index", None) is not None for d in devices):
        for d in devices:
            by_idx.setdefault(d.slice_index, []).append(d)
        groups = [by_idx[i] for i in sorted(by_idx)]
        if num_slices is None or len(groups) == num_slices:
            return groups
        if len(groups) > 1:
            # re-partitioning across REAL slice boundaries would put the
            # in-slice axes over the network — reject
            raise ValueError(f"hardware reports {len(groups)} slices, requested {num_slices}")
    if num_slices is None:
        return [list(devices)]
    if num_slices <= 0:
        raise ValueError(f"num_slices must be positive, got {num_slices}")
    n = len(devices)
    if n % num_slices:
        raise ValueError(f"{n} devices not divisible into {num_slices} slices")
    per = n // num_slices
    return [list(devices[i * per:(i + 1) * per]) for i in range(num_slices)]


def multislice_ranks(sizes: dict, groups: list, axis_names: Sequence[str] = AXES) -> np.ndarray:
    """The rank array of a hybrid mesh: ``(slice, dp_local, rest...)`` with
    ``(slice, dp_local)`` merged into a slice-major ``dp``, then put in
    ``axis_names`` order."""
    s = len(groups)
    if sizes["dp"] % s:
        raise ValueError(
            f"dp={sizes['dp']} must be a multiple of the slice count {s} "
            f"(data parallelism is the axis that crosses slices)"
        )
    non_dp = [a for a in axis_names if a != "dp"]
    per_slice_shape = [sizes["dp"] // s] + [sizes[a] for a in non_dp]
    arr = np.stack([np.asarray(g).reshape(per_slice_shape) for g in groups], axis=0)
    arr = arr.reshape([sizes["dp"]] + per_slice_shape[1:])
    order = ["dp"] + non_dp
    return np.transpose(arr, [order.index(a) for a in axis_names])


def make_multislice_mesh(
    config: Optional[MeshConfig] = None,
    *,
    num_slices: Optional[int] = None,
    devices=None,
    axis_names: Sequence[str] = AXES,
):
    """Build a ``DeviceMesh`` whose dp axis crosses slices while the other
    axes stay within one. ``devices`` as for ``make_mesh`` (None: the card
    over every rank; ``"cpu"``; ``(device type, ranks)``). ``config`` sizes
    are TOTALS; dp must be a multiple of the slice count — each slice
    contributes ``dp // num_slices`` local dp groups."""
    import torch.distributed as dist

    kind, ranks = _device_and_ranks(devices)
    ensure_group(kind)
    if ranks is None:
        ranks = list(range(dist.get_world_size()))
    groups = slice_groups(ranks, num_slices)
    sizes = (config or MeshConfig()).resolve(len(ranks))
    return mesh_from_ranks(kind, multislice_ranks(sizes, groups, axis_names), axis_names)


def launch_multislice_procs(
    num_procs: int = 2,
    local_devices: int = 4,
    steps: int = 2,
    timeout: float = 600.0,
) -> list[list[float]]:
    """Run the REAL multi-process multislice dryrun: ``num_procs`` slices of
    ``local_devices`` ranks each, every rank a fresh gloo process on the
    CPU (``_multislice_worker.py``), training the tiny GPT over one mesh
    whose dp axis crosses the slice boundary.

    Returns per-rank loss trajectories (all ranks must agree bit-for-bit:
    the update is a deterministic function of replicated inputs, so
    agreement proves the cross-process collectives ran correctly).
    """
    world = num_procs * local_devices
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"

    with tempfile.TemporaryDirectory(prefix="multislice_") as tmp:
        # output to files, not pipes: a crashed rank's log must survive the
        # kill path, and pipes deadlock if a worker fills one while we block
        # on a sibling
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
        procs = [
            subprocess.Popen(
                [
                    sys.executable, "-m", "ray_tpu_torch.parallel._multislice_worker",
                    "--rank", str(r), "--store", os.path.join(tmp, "store"),
                    "--procs", str(num_procs), "--local-devices", str(local_devices),
                    "--steps", str(steps),
                ],
                env=env, stdout=logs[r], stderr=subprocess.STDOUT, text=True,
            )
            for r in range(world)
        ]

        def read_log(r: int) -> str:
            logs[r].flush()
            logs[r].seek(0)
            return logs[r].read()

        try:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                rcs = [p.poll() for p in procs]
                # any rank dying early would leave the others waiting in
                # collectives until the full timeout: fail fast with the
                # crashed rank's log (the informative one)
                if any(rc is not None and rc != 0 for rc in rcs):
                    bad = next(r for r, rc in enumerate(rcs) if rc not in (None, 0))
                    raise RuntimeError(
                        f"multislice worker rank {bad} failed (rc={rcs[bad]}):\n{read_log(bad)[-4000:]}"
                    )
                if all(rc == 0 for rc in rcs):
                    break
                time.sleep(0.2)
            else:
                raise RuntimeError("multislice dryrun timed out; rank logs:\n"
                                   + "\n---\n".join(read_log(r)[-2000:] for r in range(world)))
            outs = [read_log(r) for r in range(world)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for f in logs:
                f.close()
    losses: list[list[float]] = [None] * world  # type: ignore[list-item]
    for out in outs:
        for line in out.splitlines():
            if line.startswith("MSPROC rank="):
                rank = int(line.split("rank=")[1].split()[0])
                losses[rank] = [float(x) for x in line.split("losses=")[1].strip("[]").split(",")]
    if any(l is None for l in losses):
        raise RuntimeError(f"missing MSPROC lines in worker output:\n{outs}")
    for r in range(1, world):
        if losses[r] != losses[0]:
            raise RuntimeError(
                f"rank {r} diverged from rank 0: {losses[r]} vs {losses[0]} — "
                "cross-process collective inconsistency"
            )
    return losses
