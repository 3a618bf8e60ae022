"""Collective communication among actors/tasks (copy of
``ray_tpu/collective/collective.py``).

API parity with the reference's ``ray.util.collective``
(``util/collective/collective.py``: ``init_collective_group`` :120,
``allreduce`` :258, ``barrier`` :298, ``broadcast`` :373, ``allgather`` :423,
``reducescatter`` :472, ``send``/``recv`` :531/:594):

* ``backend="host"`` (the only one): host tensors — numpy arrays or CPU
  ``torch.Tensor``s, each given back as the type it came in — move through a
  named coordinator actor + the shared-memory object plane. This replaces
  Gloo.
* CUDA tensors raise, as device arrays do in the reference
  (``ray_tpu/collective/collective.py:1-18``): collectives inside a step
  come from the sharding (``ray_tpu_torch.parallel``), and a one-off
  reduction of a device tensor is ``mesh_allreduce`` over a
  ``DeviceMesh`` (NCCL on the card, gloo on the CPU).

Each participating process keeps a per-group sequence counter; collectives on
a group must be called in the same order by all members (same contract as
NCCL/Gloo).
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Optional

import numpy as np

from ray_tpu_torch.collective.coordinator import CollectiveCoordinator
from ray_tpu_torch.collective.types import GroupInfo, ReduceOp

# Process-level registry (one membership per process, like an NCCL
# communicator): any thread of a member actor may issue collectives, but
# concurrent collectives on the same group must be externally ordered.
_registry: dict[str, dict] = {}
_registry_lock = threading.Lock()


def _groups() -> dict[str, dict]:
    return _registry


def _coordinator_handle(group_name: str, world_size: int):
    import ray_tpu_torch
    from ray_tpu_torch.actor import get_actor

    name = f"collective://{group_name}"
    try:
        return get_actor(name)
    except ValueError:
        pass
    Coordinator = ray_tpu_torch.remote(num_cpus=0)(CollectiveCoordinator)
    try:
        return Coordinator.options(
            name=name, lifetime="detached", get_if_exists=True
        ).remote(group_name, world_size)
    except ValueError:
        return get_actor(name)


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "host",
    group_name: str = "default",
) -> None:
    """Join this process to a collective group (call from inside each member
    actor/task). Reference: ``collective.py:120``."""
    if backend != "host":
        raise NotImplementedError(
            f"collective backend {backend!r} does not exist: the reference has only 'host'. "
            "Device tensors reduce through a device mesh: collectives inside a step come "
            "from ray_tpu_torch.parallel's sharding, a one-off reduction is mesh_allreduce"
        )
    if rank < 0 or rank >= world_size:
        raise ValueError(f"rank {rank} out of range for world_size {world_size}")
    with _registry_lock:
        if group_name in _registry:
            raise RuntimeError(f"collective group {group_name!r} already initialized")
        coord = _coordinator_handle(group_name, world_size)
        import ray_tpu_torch

        ray_tpu_torch.get(coord.join.remote(rank))
        _registry[group_name] = {
            "info": GroupInfo(group_name, world_size, rank, backend),
            "coord": coord,
            "seq": 0,
            "p2p_seq": {},
        }


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups()


def destroy_collective_group(group_name: str = "default") -> None:
    g = _groups().pop(group_name, None)
    if g is not None and g["info"].rank == 0:
        import ray_tpu_torch

        try:
            ray_tpu_torch.kill(g["coord"])
        except Exception:
            pass


def get_rank(group_name: str = "default") -> int:
    g = _groups().get(group_name)
    return g["info"].rank if g else -1


def get_collective_group_size(group_name: str = "default") -> int:
    g = _groups().get(group_name)
    return g["info"].world_size if g else -1


def _group(group_name: str) -> dict:
    g = _groups().get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this process; "
            f"call init_collective_group() first"
        )
    return g


def _host(tensor) -> "np.ndarray":
    """``tensor`` as a numpy array: a CPU ``torch.Tensor`` as a view of its
    storage (bf16, which numpy lacks, widened to fp32), anything else
    through ``np.asarray``. A CUDA tensor raises."""
    torch = sys.modules.get("torch")  # a tensor argument means torch is loaded
    if torch is not None and isinstance(tensor, torch.Tensor):
        if tensor.device.type != "cpu":
            raise ValueError(
                f"the host collective backend takes CPU tensors, got one on {tensor.device}: "
                "device tensors reduce through a device mesh (ray_tpu_torch.parallel; "
                "a one-off reduction is mesh_allreduce)"
            )
        if tensor.dtype == torch.bfloat16:
            return tensor.detach().float().numpy()
        return tensor.detach().numpy()
    return np.asarray(tensor)


def _as_type_of(tensor, result):
    """A fresh result (a gathered part, a scattered shard) in the type of
    the tensor the caller gave."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(tensor, torch.Tensor):
        return torch.from_numpy(np.array(result)).to(tensor.dtype)
    return result


def _give_back(tensor, result):
    """The collective's ``result`` in ``tensor``'s type: written into a
    writable numpy array or a CPU tensor in place (and that returned), else
    returned as it is."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(tensor, torch.Tensor):
        if tensor.requires_grad or tuple(np.shape(result)) != tuple(tensor.shape):
            return _as_type_of(tensor, result)
        if tensor.dtype == torch.bfloat16:
            tensor.copy_(torch.from_numpy(np.array(result)))
        else:
            np.copyto(tensor.detach().numpy(), result)
        return tensor
    if isinstance(tensor, np.ndarray) and tensor.flags.writeable:
        np.copyto(tensor, result)
        return tensor
    return result


def _next_seq(g: dict) -> int:
    s = g["seq"]
    g["seq"] = s + 1
    return s


def _fanin(g, kind: str, tensor, op: Optional[str], timeout: float):
    """One BLOCKING call on the async coordinator: the actor parks the call
    on an asyncio.Event until every rank contributed — pushed wakeups, no
    client-side polling anywhere (round 2 busy-polled try_* every 2ms)."""
    import ray_tpu_torch

    seq = _next_seq(g)
    rank = g["info"].rank
    return ray_tpu_torch.get(
        g["coord"].collect.remote(kind, seq, rank, tensor, op, timeout),
        timeout=timeout + 10.0,
    )


def _ring_threshold() -> int:
    """Tensors at or above this many bytes allreduce via the chunked ring
    (bulk bytes peer-to-peer through the object plane; the coordinator
    shuttles only refs) instead of riding the coordinator call itself.
    Tunable: ``collective_ring_threshold_bytes``."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return GLOBAL_CONFIG.collective_ring_threshold_bytes


def _combine(a, b, opname):
    return ReduceOp(opname or "sum").combine(a, b)


def _ring_allreduce(g, arr: "np.ndarray", opname: Optional[str], timeout: float):
    """Chunked ring allreduce (reduce-scatter + allgather), the gloo/NCCL
    decomposition: each rank moves 2·(N−1)/N of the tensor, bytes flow
    rank→rank through the object plane (shm locally, data plane across
    hosts), and NO single process — coordinator included — handles O(world)
    bytes. The coordinator only forwards ObjectRefs (mail_put/mail_take)."""
    import ray_tpu_torch

    rank, world = g["info"].rank, g["info"].world_size
    if world == 1:
        return arr.copy()
    seq = _next_seq(g)
    coord = g["coord"]
    flat = np.ascontiguousarray(arr).reshape(-1)
    # views, not copies: sends serialize them and _combine allocates fresh
    # arrays, so nothing ever mutates a chunk in place
    chunks = list(np.array_split(flat, world))
    right = (rank + 1) % world
    live_refs = []  # keep our outbound objects alive until the final barrier

    def exchange(step: int, payload) -> "np.ndarray":
        ref = ray_tpu_torch.put(payload)
        live_refs.append(ref)
        # nest the ref in a tuple so it travels AS a ref (top-level task
        # args materialize): the coordinator never touches the bytes.
        # put and take are issued TOGETHER — the async coordinator services
        # both concurrently, halving the per-step control latency.
        p = coord.mail_put.remote(("ring", seq, step, right), (ref,))
        t = coord.mail_take.remote(("ring", seq, step, rank), timeout)
        got = ray_tpu_torch.get(t, timeout=timeout + 10.0)
        ray_tpu_torch.get(p, timeout=timeout)
        return ray_tpu_torch.get(got[0], timeout=timeout)

    # phase 1: reduce-scatter — after N-1 steps, rank owns the fully reduced
    # chunk at index (rank+1) % world
    send_idx = rank
    for step in range(world - 1):
        recv_idx = (rank - 1 - step) % world
        part = exchange(step, chunks[send_idx])
        chunks[recv_idx] = _combine(chunks[recv_idx], part, opname)
        send_idx = recv_idx
    # phase 2: allgather — circulate the reduced chunks
    send_idx = (rank + 1) % world
    for step in range(world - 1):
        recv_idx = (rank - step) % world
        chunks[recv_idx] = exchange(world - 1 + step, chunks[send_idx])
        send_idx = recv_idx
    # trailing barrier: our right neighbor may not have fetched our last
    # chunk yet — don't let live_refs die under an in-flight fetch. Uses a
    # subkey of THIS op's seq (not a fresh seq): the ring consumes exactly
    # one sequence number like the direct path, so a per-rank path
    # divergence can't desynchronize the group's counters forever.
    ray_tpu_torch.get(
        coord.collect.remote("ring_done", seq, rank, None, None, timeout),
        timeout=timeout + 10.0,
    )
    del live_refs
    return np.concatenate(chunks).reshape(arr.shape).astype(arr.dtype, copy=False)


def allreduce(tensor, group_name: str = "default", op=ReduceOp.SUM, timeout: float = 60.0):
    """All-reduce a host tensor across the group; returns the reduced array
    (and writes in place when ``tensor`` is a writable numpy array).
    Reference semantics: ``collective.py:258``; large tensors take the
    chunked ring (``_ring_allreduce``)."""
    g = _group(group_name)
    opname = op.value if isinstance(op, ReduceOp) else str(op)
    arr = _host(tensor)
    if arr.nbytes >= _ring_threshold() and g["info"].world_size > 1:
        result = _ring_allreduce(g, arr, opname, timeout)
    else:
        result = _fanin(g, "allreduce", arr, opname, timeout)
    return _give_back(tensor, result)


def allgather(tensor, group_name: str = "default", timeout: float = 60.0) -> list:
    """Gather every rank's tensor; returns a list indexed by rank
    (reference ``collective.py:423``)."""
    g = _group(group_name)
    parts = _fanin(g, "allgather", _host(tensor), None, timeout)
    return [_as_type_of(tensor, p) for p in parts]


def reducescatter(tensor, group_name: str = "default", op=ReduceOp.SUM, timeout: float = 60.0):
    """Reduce across ranks, then return this rank's shard (row-split of the
    flattened leading axis; reference ``collective.py:472``)."""
    g = _group(group_name)
    opname = op.value if isinstance(op, ReduceOp) else str(op)
    shards = _fanin(g, "reducescatter", _host(tensor), opname, timeout)
    return _as_type_of(tensor, shards[g["info"].rank])


def barrier(group_name: str = "default", timeout: float = 60.0) -> None:
    """Block until every member arrives (reference ``collective.py:298``)."""
    g = _group(group_name)
    _fanin(g, "barrier", None, None, timeout)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default", timeout: float = 60.0):
    """Broadcast from ``src_rank`` to all (reference ``collective.py:373``).
    Receivers park on the coordinator's event — no polling."""
    import ray_tpu_torch

    g = _group(group_name)
    seq = _next_seq(g)
    rank = g["info"].rank
    payload = _host(tensor) if rank == src_rank else None
    if rank != src_rank:
        _host(tensor)  # refuse a device tensor before waiting on the root
    result = ray_tpu_torch.get(
        g["coord"].bcast.remote(seq, rank, src_rank, payload, timeout),
        timeout=timeout + 10.0,
    )
    if rank == src_rank:
        return tensor
    return _give_back(tensor, result)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """Point-to-point send (reference ``collective.py:531``)."""
    import ray_tpu_torch

    g = _group(group_name)
    rank = g["info"].rank
    if dst_rank == rank:
        raise ValueError("cannot send to self")
    key = (rank, dst_rank)
    seq = g["p2p_seq"].get(key, 0)
    g["p2p_seq"][key] = seq + 1
    ray_tpu_torch.get(g["coord"].p2p_put.remote(rank, dst_rank, seq, _host(tensor)))


def recv(tensor, src_rank: int, group_name: str = "default", timeout: float = 60.0):
    """Point-to-point receive; fills ``tensor`` in place when possible and
    returns the array (reference ``collective.py:594``). Blocks on the
    coordinator's mailbox event — no polling."""
    import ray_tpu_torch

    g = _group(group_name)
    rank = g["info"].rank
    if src_rank == rank:
        raise ValueError("cannot recv from self")
    _host(tensor)  # refuse a device tensor before taking a sequence number
    key = (src_rank, rank)
    seq = g["p2p_seq"].get(key, 0)
    g["p2p_seq"][key] = seq + 1
    result = ray_tpu_torch.get(
        g["coord"].p2p_get.remote(src_rank, rank, seq, timeout),
        timeout=timeout + 10.0,
    )
    return _give_back(tensor, result)


# ---------------------------------------------------------------- device side


def mesh_allreduce(x, mesh=None, op=ReduceOp.SUM):
    """Reduce ``x`` over its axis 0 with its rows spread over the devices of
    a mesh's first axis (reference ``collective.py:315``): each rank reduces
    its rows, then one collective over that axis (NCCL on the card, gloo on
    the CPU) combines them. Every rank passes the same ``x`` and gets the
    result. The default mesh is ``make_mesh(MeshConfig(dp=-1, fsdp=1, tp=1,
    sp=1))`` on ``x``'s device type (the card for a numpy array). For
    collectives *inside* a training step, shard the parameters instead
    (``ray_tpu_torch.parallel``)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.sharding import local_slices

    if mesh is None:
        kind = x.device.type if isinstance(x, torch.Tensor) else None
        mesh = make_mesh(MeshConfig(dp=-1, fsdp=1, tp=1, sp=1), devices=kind)
    op = ReduceOp(op) if not isinstance(op, ReduceOp) else op
    x = torch.as_tensor(x).to(mesh.device_type)
    first = mesh.mesh_dim_names[0]
    rows = x[local_slices(x.shape, (first,), mesh)]
    reduce = {ReduceOp.SUM: torch.sum, ReduceOp.PRODUCT: torch.prod, ReduceOp.MIN: torch.amin,
              ReduceOp.MAX: torch.amax}[op]
    part = reduce(rows, 0).contiguous()
    if mesh.size(0) > 1:
        dist.all_reduce(part, op=getattr(dist.ReduceOp, op.name), group=mesh.get_group(first))
    return part
