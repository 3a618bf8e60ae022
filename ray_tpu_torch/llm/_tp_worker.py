"""The tensor-parallel engine's own half of its process group
(``llm.multichip``): the step protocol, the shard rules, the leader's
``TPGroup`` and the follower loop. The group itself (the followers'
processes, the private process group, the control channel, the watchers
and heartbeats) is ``_private.local_group``'s, shared with the
data-parallel learner.

The engine's process is rank 0, the leader, and starts ``tp - 1``
followers running this module's ``main``. The group carries the weights
(``scatter`` of the column/row slices, ``broadcast`` of the replicated
leaves) and the layers' reductions (``allreduce``), nothing else. Each
step the leader writes one command on every follower's pipe: the header's
fields hold the step's shapes (``start`` and ``n_valid`` too) and the
payload its host arrays as int64 (tokens, positions or ``base_pos``,
block tables; the fork's ``src``/``dst``). Replies (bytes resident after
the pool, a weight swap or a report) come back as JSON lines.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from ray_tpu_torch._private.local_group import Collectives, Follower, LocalGroup, traced

OP_PREFILL, OP_DECODE, OP_VERIFY, OP_FORK, OP_POOL, OP_SWAP, OP_REPORT, OP_TRACE = range(1, 9)
#: pool dtypes by the code the POOL command carries
DTYPES = ("float32", "bfloat16", "float16")


# -- shard rules ------------------------------------------------------------

#: parameters only the leader holds: it alone computes the final layernorm,
#: the lm head and the sampling (followers stop at the last layer's output)
LEADER_ONLY = re.compile(r"^(ln_f|lm_head)\.")
#: the Megatron split, by parameter path: column-parallel (output dim 0 of
#: an ``nn.Linear`` weight, and its bias) and row-parallel (input dim 1 of
#: the weight; its bias is replicated and added once, before the reduction,
#: by rank 0)
_COLUMN = re.compile(r"^blocks\.\d+\.(q|k|v|attn_qkv|mlp_in)\.(weight|bias)$")
_ROW = re.compile(r"^blocks\.\d+\.(attn_out|mlp_out)\.weight$")
_FUSED_QKV = re.compile(r"^blocks\.\d+\.attn_qkv\.(weight|bias)$")


def shard_dim(name: str) -> Optional[int]:
    """The dim of parameter ``name`` split over tp: 0 (column-parallel), 1
    (row-parallel) or None (replicated, or the leader's alone)."""
    if _COLUMN.match(name):
        return 0
    if _ROW.match(name):
        return 1
    return None


def local_shape(name: str, shape, tp: int) -> tuple:
    dim = shard_dim(name)
    shape = list(shape)
    if dim is not None:
        if shape[dim] % tp:
            raise ValueError(f"{name} of shape {tuple(shape)} does not split over tp={tp} at dim {dim}")
        shape[dim] //= tp
    return tuple(shape)


def local_slice(value, name: str, rank: int, tp: int):
    """Rank ``rank``'s part of the full parameter ``value`` (a view where it
    can be). GPT's fused qkv rows go in the mesh's tp-major order first
    (``parallel.sharding.qkv_order``), so each contiguous shard splits into
    its own heads' q, k and v."""
    dim = shard_dim(name)
    if dim is None or tp == 1:
        return value
    if _FUSED_QKV.match(name):
        from ray_tpu_torch.parallel.sharding import qkv_order

        value = value[qkv_order(value.shape[0], tp).to(value.device)]
    n = value.shape[dim] // tp
    return value.narrow(dim, rank * n, n)


def local_module(cfg, tp: int, device, leader: bool):
    """An empty model of ``cfg``'s class holding one rank's parameter
    shapes (``local_shape``), on ``device``; a follower's has no
    ``ln_f``/``lm_head``."""
    import torch
    from torch import nn

    from ray_tpu_torch.models.gptj import GPTJ, GPTJConfig

    if isinstance(cfg, GPTJConfig):
        model = GPTJ(cfg, device="meta")
    else:
        from ray_tpu_torch.models.gpt import GPT

        model = GPT(cfg, device="meta")
    if not leader:
        model.ln_f = None
        model.lm_head = None
    for path, p in list(model.named_parameters()):
        mod_path, _, leaf = path.rpartition(".")
        mod = model.get_submodule(mod_path) if mod_path else model
        t = torch.empty(local_shape(path, p.shape, tp), dtype=p.dtype, device=device)
        mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)
    return model.requires_grad_(False)


def storage_bytes(tensors) -> int:
    """Bytes of the tensors' storages, each counted once."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def place(coll: Optional["Collectives"], local, full, tp: int, device) -> None:
    """Fill ``local`` (this rank's ``local_module``) from the full
    parameters: on the leader ``full`` is a ``{name: tensor}`` of the whole
    model, on any device, sent one parameter at a time (the transient is at
    most one full leaf); on a follower ``full`` is None and each parameter
    is received in place. ``coll`` is None at tp 1."""
    import torch

    leader = full is not None
    params = dict(local.named_parameters())
    names = list(full) if leader else list(params)
    with torch.no_grad():
        for name in names:
            dst = params[name]
            if leader:
                src = full[name]
                if LEADER_ONLY.match(name) or shard_dim(name) is None or tp == 1:
                    if dst.data_ptr() != src.data_ptr():  # an adopted tensor is its own source
                        dst.copy_(src)
                    if coll is not None and not LEADER_ONLY.match(name):
                        coll.broadcast(dst)
                else:
                    parts = [local_slice(src, name, r, tp).to(device, dst.dtype).contiguous()
                             for r in range(tp)]
                    coll.scatter(dst, parts)
                    del parts
            elif shard_dim(name) is None:
                coll.broadcast(dst)
            else:
                coll.scatter(dst)


# -- the leader's side ---------------------------------------------------------


class TPGroup(LocalGroup):
    """The leader's side of the engine's group (``local_group.LocalGroup``):
    ``device`` is the leader's (``cuda:i`` or ``cpu``); ``cfg`` the model
    config the followers rebuild their shards from."""

    ROLE = "tp follower"

    def __init__(self, cfg, tp: int, device, block_size: int):
        import dataclasses

        from ray_tpu_torch.models.gptj import GPTJConfig

        self.tp = tp
        spec = dict(tp=tp, block_size=block_size, arch="gptj" if isinstance(cfg, GPTJConfig) else "gpt",
                    cfg=dataclasses.asdict(cfg))
        super().__init__(tp, device, "ray_tpu_torch.llm._tp_worker", spec, name="tp")


# -- the follower -------------------------------------------------------------


def main(argv=None) -> None:
    channel = Follower(argv)
    spec = channel.spec

    from ray_tpu_torch.llm.multichip import _Follower

    channel.set_device()
    channel.send("hello", pid=os.getpid())
    follower = _Follower(spec)
    trace = False
    for op, fields, body in channel.commands():
        if op == OP_TRACE:
            trace = True  # the next command runs under the profiler
            continue
        cmd = (op, fields, np.frombuffer(body, np.int64))
        if trace:
            out = "trace", traced(lambda: follower.run(*cmd), follower.device)
        else:
            out = follower.run(*cmd)
        trace = False
        if out is not None:
            kind, fields = out
            channel.send(kind, **fields)
