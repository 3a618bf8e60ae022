"""The port's host collectives against the reference's tests: a mirror of
``tests/test_collective.py`` run on ``ray_tpu_torch.collective`` (members
are actors; each joins a group and performs the same sequence of
collectives), plus CPU ``torch.Tensor``s in and out, the refusals (a
device tensor, the NCCL backend, ``mesh_allreduce`` of a host array
without a card) and ``mesh_allreduce`` on a CPU tensor. The ring is held
correct without the reference's wall-clock bar (ROADMAP.md §C)."""

import numpy as np
import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def _shared_cluster():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(num_cpus=0)
class Member:
    def __init__(self, rank, world, group="g"):
        from ray_tpu_torch import collective as col

        self.rank = rank
        self.world = world
        self.group = group
        col.init_collective_group(world, rank, group_name=group)

    def do_allreduce(self):
        from ray_tpu_torch import collective as col

        x = np.full((4,), float(self.rank + 1))
        out = col.allreduce(x, group_name=self.group)
        return out

    def do_allgather(self):
        from ray_tpu_torch import collective as col

        return col.allgather(np.array([self.rank]), group_name=self.group)

    def do_reducescatter(self):
        from ray_tpu_torch import collective as col

        x = np.arange(4, dtype=np.float64) + self.rank
        return col.reducescatter(x, group_name=self.group)

    def do_broadcast(self):
        from ray_tpu_torch import collective as col

        x = np.full((3,), float(self.rank * 100))
        return col.broadcast(x, src_rank=1, group_name=self.group)

    def do_sendrecv(self):
        from ray_tpu_torch import collective as col

        if self.rank == 0:
            col.send(np.array([42.0]), dst_rank=1, group_name=self.group)
            return None
        return col.recv(np.zeros(1), src_rank=0, group_name=self.group)

    def do_barrier(self):
        from ray_tpu_torch import collective as col

        col.barrier(group_name=self.group)
        return self.rank

    def rank_info(self):
        from ray_tpu_torch import collective as col

        return col.get_rank(self.group), col.get_collective_group_size(self.group)

    def do_torch(self):
        """Every collective on CPU tensors: each answer is a tensor, the
        in-place ones the very tensor given."""
        import torch

        from ray_tpu_torch import collective as col

        x = torch.full((4,), float(self.rank + 1))
        red = col.allreduce(x, group_name=self.group)
        half = torch.full((2,), float(self.rank + 1), dtype=torch.bfloat16)
        red16 = col.allreduce(half, group_name=self.group)
        gathered = col.allgather(torch.tensor([self.rank]), group_name=self.group)
        shard = col.reducescatter(torch.arange(4, dtype=torch.float64) + self.rank, group_name=self.group)
        b = torch.full((3,), float(self.rank * 100))
        bcast = col.broadcast(b, src_rank=1, group_name=self.group)
        if self.rank == 0:
            col.send(torch.tensor([42.0]), dst_rank=1, group_name=self.group)
            got = None
        else:
            got = col.recv(torch.zeros(1), src_rank=0, group_name=self.group)
        return {
            "allreduce": (red is x, type(red).__name__, red.tolist()),
            "bf16": (red16 is half, str(red16.dtype), red16.float().tolist()),
            "allgather": [(type(t).__name__, t.tolist()) for t in gathered],
            "reducescatter": (type(shard).__name__, str(shard.dtype), shard.tolist()),
            "broadcast": (bcast is b, bcast.tolist()),
            "recv": None if got is None else (type(got).__name__, got.tolist()),
        }

    def do_device_tensor(self):
        """A tensor off the CPU (a meta tensor stands in for a CUDA one
        where there is no card): every collective refuses it, naming the
        device mesh's way (``ray_tpu_torch.parallel``, ``mesh_allreduce``)."""
        import torch

        from ray_tpu_torch import collective as col

        t = torch.empty(4, device="meta")
        errors = []
        for call in (lambda: col.allreduce(t, group_name=self.group),
                     lambda: col.allgather(t, group_name=self.group),
                     lambda: col.reducescatter(t, group_name=self.group),
                     lambda: col.broadcast(t, src_rank=0, group_name=self.group),
                     lambda: col.send(t, dst_rank=1 - self.rank, group_name=self.group),
                     lambda: col.recv(t, src_rank=1 - self.rank, group_name=self.group)):
            try:
                call()
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        return errors


@pytest.fixture(scope="module")
def members(_shared_cluster):
    world = 2
    ms = [Member.remote(r, world) for r in range(world)]
    ray_tpu_torch.get([m.rank_info.remote() for m in ms])  # wait for init
    yield ms


def test_allreduce(members):
    outs = ray_tpu_torch.get([m.do_allreduce.remote() for m in members])
    for o in outs:
        np.testing.assert_allclose(o, np.full((4,), 3.0))


def test_allgather(members):
    outs = ray_tpu_torch.get([m.do_allgather.remote() for m in members])
    for o in outs:
        assert [int(x[0]) for x in o] == [0, 1]


def test_reducescatter(members):
    o0, o1 = ray_tpu_torch.get([m.do_reducescatter.remote() for m in members])
    # sum over ranks of arange(4)+r = [1,3,5,7]; rank0 gets [1,3], rank1 [5,7]
    np.testing.assert_allclose(o0, [1.0, 3.0])
    np.testing.assert_allclose(o1, [5.0, 7.0])


def test_broadcast(members):
    outs = ray_tpu_torch.get([m.do_broadcast.remote() for m in members])
    for o in outs:
        np.testing.assert_allclose(o, np.full((3,), 100.0))


def test_send_recv(members):
    outs = ray_tpu_torch.get([m.do_sendrecv.remote() for m in members])
    np.testing.assert_allclose(outs[1], [42.0])


def test_barrier_and_rank(members):
    assert sorted(ray_tpu_torch.get([m.do_barrier.remote() for m in members])) == [0, 1]
    infos = ray_tpu_torch.get([m.rank_info.remote() for m in members])
    assert infos == [(0, 2), (1, 2)]


def test_torch_tensors_in_and_out(members):
    r0, r1 = ray_tpu_torch.get([m.do_torch.remote() for m in members])
    for r in (r0, r1):
        assert r["allreduce"] == (True, "Tensor", [3.0] * 4)
        assert r["bf16"] == (True, "torch.bfloat16", [3.0, 3.0])
        assert r["allgather"] == [("Tensor", [0]), ("Tensor", [1])]
        assert r["broadcast"][1] == [100.0] * 3
    assert r0["reducescatter"] == ("Tensor", "torch.float64", [1.0, 3.0])
    assert r1["reducescatter"] == ("Tensor", "torch.float64", [5.0, 7.0])
    assert r1["broadcast"][0] is True  # written into the receiver's tensor
    assert r0["recv"] is None and r1["recv"] == ("Tensor", [42.0])


def test_a_device_tensor_raises(members):
    for errors in ray_tpu_torch.get([m.do_device_tensor.remote() for m in members]):
        assert all(e is not None and "ray_tpu_torch.parallel" in e and "mesh_allreduce" in e
                   for e in errors), errors
    # the group is still in step after the refusals
    test_allreduce(members)


@ray_tpu_torch.remote(num_cpus=0)
class RingMember:
    """Member driving LARGE allreduces (the chunked-ring path: bulk bytes
    peer-to-peer through the object plane, coordinator shuttles refs only)."""

    def __init__(self, rank, world, group="ring"):
        from ray_tpu_torch import collective as col

        self.rank = rank
        self.world = world
        self.group = group
        col.init_collective_group(world, rank, group_name=group)

    def big_allreduce(self, n, as_torch=False):
        from ray_tpu_torch import collective as col

        x = np.full((n,), float(self.rank + 1), dtype=np.float64)
        if as_torch:
            import torch

            x = torch.from_numpy(x)
        out = col.allreduce(x, group_name=self.group, timeout=120.0)
        return float(out[0]), float(out[-1]), type(out).__name__


def test_ring_allreduce_correct(_shared_cluster):
    """The chunked ring at 4 ranks and 8 MB each, with numpy and torch
    tensors: every element of every rank's result is the sum. No
    wall-clock bar (the reference's asserts 1 GB/s on 8+ cores)."""
    import ray_tpu_torch.collective.collective as cc

    world = 4
    n = (8 * 1024 * 1024) // 8
    assert n * 8 >= cc._ring_threshold()  # actually exercises the ring
    ms = [RingMember.remote(r, world, "ring") for r in range(world)]
    expect = float(sum(range(1, world + 1)))
    for as_torch in (False, True):
        results = ray_tpu_torch.get([m.big_allreduce.remote(n, as_torch) for m in ms], timeout=240)
        kind = "Tensor" if as_torch else "ndarray"
        assert all(r == (expect, expect, kind) for r in results), results


def test_ring_just_over_threshold(_shared_cluster):
    """The ring path is correct right at its activation boundary (bit-for-
    bit agreement with the direct path is NOT promised — float reduction
    order differs between the two decompositions, as it does in NCCL)."""
    import ray_tpu_torch.collective.collective as cc

    world = 4
    members = [RingMember.options(name=f"rm{r}").remote(r, world, "ring2") for r in range(world)]
    n = cc._ring_threshold() // 8 + 1024  # just over the ring threshold
    results = ray_tpu_torch.get([m.big_allreduce.remote(n) for m in members], timeout=120)
    expect = float(sum(range(1, world + 1)))
    assert all(first == expect and last == expect for first, last, _ in results)


def test_no_client_side_polling():
    """The coordinator is an async actor and every wait is an
    asyncio.Event park: no busy-poll helpers."""
    import inspect

    import ray_tpu_torch.collective.collective as cc
    import ray_tpu_torch.collective.coordinator as coord

    assert not hasattr(coord, "poll")
    src = inspect.getsource(coord) + inspect.getsource(cc)
    assert "time.sleep" not in src
    assert "try_collect" not in src


def test_nccl_and_mesh_allreduce_raise(_shared_cluster):
    """The reference has one backend, "host": ``backend="nccl"`` raises,
    naming ``mesh_allreduce``; ``mesh_allreduce`` of a host array means the
    card: without one it raises too and starts no group."""
    import torch.distributed as dist

    from ray_tpu_torch import collective as col

    with pytest.raises(RuntimeError, match="no CUDA device"):
        col.mesh_allreduce(np.ones(4))
    assert not dist.is_initialized()
    with pytest.raises(NotImplementedError, match="mesh_allreduce"):
        col.init_collective_group(2, 0, backend="nccl", group_name="nccl")
    assert not col.is_group_initialized("nccl")


def test_mesh_allreduce_reduces_a_cpu_tensor():
    """On a CPU tensor ``mesh_allreduce`` reduces over a gloo mesh of this
    process (a group of one, destroyed here): the reference's function,
    ``x`` reduced over axis 0 (many ranks: tests/test_torch_parallel.py)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import collective as col

    x = torch.tensor([[1.0, -2.0, 3.0], [4.0, 5.0, -6.0], [7.0, 1.0, 2.0]])
    try:
        got = {op: col.mesh_allreduce(x, op=op) for op in col.ReduceOp}
    finally:
        dist.destroy_process_group()
    assert torch.equal(got[col.ReduceOp.SUM], x.sum(0))
    assert torch.equal(got[col.ReduceOp.PRODUCT], x.prod(0))
    assert torch.equal(got[col.ReduceOp.MIN], x.amin(0))
    assert torch.equal(got[col.ReduceOp.MAX], x.amax(0))
