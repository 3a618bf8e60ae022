"""ray_tpu_torch.parallel.multislice against the reference, on the CPU — a
mirror of ``tests/test_multislice.py``: dp crosses slice boundaries
slice-major, every other axis stays within a slice. The mesh layouts are
built under a fake process group of 8 ranks in this process (destroyed by
each test) and compared with the reference's device arrays; the two-slice
dryrun runs fresh gloo processes, whose losses must be bit-equal across
ranks and fall."""

import jax
import numpy as np
import pytest
import torch.distributed as dist

from ray_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from ray_tpu.parallel.multislice import make_multislice_mesh as ref_make_multislice_mesh
from ray_tpu_torch.parallel.mesh import MeshConfig, axis_size
from ray_tpu_torch.parallel.multislice import make_multislice_mesh, slice_groups


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _ref_ranks(mesh):
    ids = {d: i for i, d in enumerate(jax.devices("cpu"))}
    return np.vectorize(lambda d: ids[d])(np.asarray(mesh.devices))


def test_slice_groups_contiguous():
    ranks = list(range(8))
    groups = slice_groups(ranks, 2)
    assert [len(g) for g in groups] == [4, 4]
    assert groups[0] == ranks[:4] and groups[1] == ranks[4:]
    with pytest.raises(ValueError, match="divisible"):
        slice_groups(ranks[:6], 4)


def test_dp_axis_is_slice_major(fake_group):
    mesh = make_multislice_mesh(MeshConfig(dp=4, fsdp=1, tp=2, sp=1), num_slices=2, devices="cpu")
    arr = mesh.mesh.numpy()  # axes (dp, fsdp, ep, sp, tp)
    assert axis_size(mesh, "dp") == 4 and axis_size(mesh, "tp") == 2
    ref = ref_make_multislice_mesh(RefMeshConfig(dp=4, fsdp=1, tp=2, sp=1), num_slices=2,
                                   devices=jax.devices("cpu")[:8])
    np.testing.assert_array_equal(arr, _ref_ranks(ref))
    flat_dp = arr.reshape(4, 2)  # (dp, tp)
    slice_of = {r: r // 4 for r in range(8)}
    # dp-major halves = slices; cross-slice traffic is dp-only
    assert [{slice_of[r] for r in row} for row in flat_dp] == [{0}, {0}, {1}, {1}]
    for row in flat_dp:  # tp groups never cross a slice
        assert len({slice_of[r] for r in row}) == 1


def test_dp_must_cover_slices(fake_group):
    with pytest.raises(ValueError, match="multiple of the slice count"):
        make_multislice_mesh(MeshConfig(dp=1, fsdp=1, tp=8, sp=1), num_slices=2, devices="cpu")


def test_single_slice_degenerates_to_plain_mesh(fake_group):
    mesh = make_multislice_mesh(MeshConfig(dp=2, fsdp=1, tp=2, sp=1), num_slices=1,
                                devices=("cpu", range(4)))
    assert axis_size(mesh, "dp") == 2 and axis_size(mesh, "tp") == 2
    assert mesh.mesh.flatten().tolist() == [0, 1, 2, 3]


def test_two_process_dcn_dp():
    """REAL multi-process multislice: two slices of two gloo processes each
    join one mesh (dp 2 across the slices, tp 2 within one); the dp
    gradient reduction crosses the slice boundary, all ranks must agree bit
    for bit and the loss must decrease. Reference counterpart: the
    cross-host process group built by python/ray/train/torch/config.py."""
    from ray_tpu_torch.parallel.multislice import launch_multislice_procs

    losses = launch_multislice_procs(num_procs=2, local_devices=2, steps=2)
    assert len(losses) == 4 and all(l == losses[0] for l in losses)
    assert losses[0][1] < losses[0][0]
