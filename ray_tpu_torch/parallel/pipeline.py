"""Pipeline parallelism over a ``pp`` mesh axis, GPipe-style (port of
``ray_tpu/parallel/pipeline.py``).

Stage ``s`` (the rank's coordinate on ``pp``) holds layers ``[s·L/pp,
(s+1)·L/pp)``. Microbatches stream through ``M + pp − 1`` ticks: each tick
every stage applies its layers to its resident microbatch and hands the
activations to its successor by a send and a receive (``_Shift``), whose
backward sends the gradients the other way, so the backward pipeline falls
out of autograd as the reference's falls out of scan + ppermute. The bubble
fraction is (pp−1)/(M+pp−1). The last stage's output reaches every stage
by a masked all-reduce (the reference's mask-and-psum), so what follows
the pipeline runs replicated over ``pp``.

``pipeline_apply`` is model-agnostic: any ``stage_fn(stage_params, x) ->
y`` whose stacked parameters carry a leading layer dimension works.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch.parallel.mesh import axis_size
from ray_tpu_torch.parallel.sharding import global_put, reduce_from


class _Shift(torch.autograd.Function):
    """``y`` sent to the next stage, the previous stage's ``y`` received
    (zeros on stage 0); the backward sends the received value's gradient
    back to the previous stage and receives ``y``'s from the next (zeros on
    the last stage)."""

    @staticmethod
    def forward(ctx, y, prev, nxt, group):
        ctx.prev, ctx.nxt, ctx.group = prev, nxt, group
        return _exchange(y.contiguous(), send_to=nxt, recv_from=prev, group=group)

    @staticmethod
    def backward(ctx, grad):
        got = _exchange(grad.contiguous(), send_to=ctx.prev, recv_from=ctx.nxt, group=ctx.group)
        return got, None, None, None


def _exchange(x: torch.Tensor, send_to, recv_from, group) -> torch.Tensor:
    """Send ``x`` to global rank ``send_to`` and receive a tensor like it
    from ``recv_from`` (either None: no peer, zeros received)."""
    import torch.distributed as dist

    got = torch.zeros_like(x)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, x, send_to, group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, got, recv_from, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return got


def _stage_params(tree: Any, stage: int, per: int):
    """This stage's ``(L/pp, ...)`` slice of each stacked parameter (a
    ``DTensor`` sharded over pp on the layer dim is its local shard)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _stage_params(v, stage, per) for k, v in tree.items()}
    if isinstance(tree, list | tuple):
        return type(tree)(_stage_params(v, stage, per) for v in tree)
    if isinstance(tree, DTensor):
        return tree.to_local()
    return tree[stage * per:(stage + 1) * per]


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x: torch.Tensor,
    mesh,
    n_layers: int,
    microbatches: int,
    axis_name: str = "pp",
    batch_axes: tuple = (("dp", "fsdp"),),
):
    """Run ``x`` (batch, ...) through ``n_layers`` stacked layers pipelined
    over the mesh's ``pp`` axis with GPipe microbatching.

    - ``stage_fn(stage_params, x_mb)`` applies ONE stage's layers to one
      microbatch (it typically loops over its local layers).
    - ``stacked_params``: a tree (dict, list, tuple) of tensors with a
      leading layer dim L; a plain tensor is the whole stack on every rank
      (only this stage's rows get gradients: sum ``.grad`` over pp for the
      whole), a ``DTensor`` sharded over pp on dim 0 its stage's shard.
    - ``x``: a plain tensor is the whole batch on every rank, and the result
      is too; a ``DTensor`` (batch over ``batch_axes``) comes back as one in
      its placements. Each rank runs its own slice of the batch.
    - ``microbatches`` must divide the rank's batch.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    pp = axis_size(mesh, axis_name)
    if pp == 1:
        return stage_fn(stacked_params, x)
    if n_layers % pp:
        raise ValueError(f"n_layers {n_layers} must divide by pp={pp}")
    spec = (batch_axes[0],) if batch_axes else ()
    whole = not isinstance(x, DTensor)
    xd = global_put(x, mesh, spec) if whole else x
    x_local = xd.to_local()
    stage = mesh.get_local_rank(axis_name)
    group = mesh.get_group(axis_name)
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) if stage < pp - 1 else None
    params_local = _stage_params(stacked_params, stage, n_layers // pp)

    b = x_local.shape[0]
    if b % microbatches:
        raise ValueError(f"local batch {b} must divide into microbatches={microbatches}")
    mb = b // microbatches
    xs = x_local.reshape((microbatches, mb) + x_local.shape[1:])
    first = torch.tensor(stage == 0, device=x_local.device)
    incoming = torch.zeros_like(xs[0])
    ys = []
    for t in range(microbatches + pp - 1):
        # drain ticks feed zeros, as the reference pads its scan
        x_t = xs[t] if t < microbatches else torch.zeros_like(xs[0])
        # where(), not a Python branch: every stage's graph then holds the
        # received value, so every stage runs each shift's backward and the
        # sends and receives of the backward pair up
        y = stage_fn(params_local, torch.where(first, x_t, incoming))
        ys.append(y)
        if t < microbatches + pp - 2:
            incoming = _Shift.apply(y, prev, nxt, group)
    # stage pp-1 emitted microbatch m at tick m + pp - 1: only the last
    # stage's outputs are real; mask and sum them onto every stage
    out = torch.stack(ys[pp - 1:]).reshape((b,) + ys[0].shape[1:])
    out = torch.where(torch.tensor(stage == pp - 1, device=out.device), out, torch.zeros_like(out))
    out = reduce_from(out, mesh, axis_name)
    out = DTensor.from_local(out, xd.device_mesh, xd.placements, run_check=False)
    return out.full_tensor() if whole else out
