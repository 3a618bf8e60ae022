"""Sharding rule tables for transformer parameters (port of
``ray_tpu/parallel/sharding.py``).

Sharding is data, not wrappers: a rule table maps parameter-path regexes to
specs, and each parameter becomes a ``DTensor`` on the mesh with the
placements its spec names. A spec is the reference's ``PartitionSpec`` as a
tuple, one entry per tensor dim: ``None``, a mesh axis name, or a tuple of
names (sharded over their product, the first outermost). Conventions
(Megatron-style, the reference's):

* ``tp`` shards the *output* dim of QKV and MLP-in weights and the *input*
  dim of the attention-proj and MLP-out weights, so each block needs
  exactly one all-reduce (forward) per sublayer (``reduce_from``);
* ``fsdp`` shards the other (non-tp) dim of every large weight plus the
  embedding vocab dim — parameters and Adam state live scattered and are
  all-gathered per layer on use (``local``; ZeRO-3), their gradients
  reduce-scattered back;
* ``ep`` shards the experts' leading dim (``moe_in``, ``moe_out``): each
  ep rank computes its experts on the tokens its group shares;
* activations: batch over ``("dp", "fsdp")``, sequence over ``sp``.

``nn.Linear`` keeps its weight as (out, in) where the reference's kernels
are (in, out), so a weight rule's two dims are the reference's swapped, and
the port has no stacked leading layer dim. Under ``tp`` the fused qkv
weight's rows are stored in tp-major order (``qkv_order``): a contiguous
tp shard then holds its own heads' q, k and v, as the reference's tp engine
shuffles them (``ray_tpu/llm/multichip.py:250``). ``full_value`` undoes the
order wherever a weight leaves the mesh.
"""

from __future__ import annotations

import re
import sys
from typing import Optional

import torch

from ray_tpu_torch.parallel.mesh import axis_size

# (regex over a '.'-joined parameter path) -> spec, one entry per tensor dim.
# Matches the module paths of ray_tpu_torch.models.gpt (and models.gptj).
_RULES = [
    (r"^embed\.weight$", ("fsdp", "tp")),                     # (vocab, d_model)
    (r"^pos_embed\.weight$", (None, None)),                   # (seq, d_model)
    (r"blocks\.\d+\.attn_qkv\.weight$", ("tp", "fsdp")),      # (3h, d)
    (r"blocks\.\d+\.attn_qkv\.bias$", ("tp",)),
    (r"blocks\.\d+\.attn_out\.weight$", ("fsdp", "tp")),      # (d, h)
    (r"blocks\.\d+\.attn_out\.bias$", (None,)),
    (r"blocks\.\d+\.mlp_in\.weight$", ("tp", "fsdp")),        # (4d, d)
    (r"blocks\.\d+\.mlp_in\.bias$", ("tp",)),
    (r"blocks\.\d+\.mlp_out\.weight$", ("fsdp", "tp")),       # (d, 4d)
    (r"blocks\.\d+\.mlp_out\.bias$", (None,)),
    # MoE: kept in the reference's layouts (router (d, E), experts (E, d, 4d)
    # and (E, 4d, d)), so their specs are the reference's
    (r"blocks\.\d+\.router$", (None, None)),
    (r"blocks\.\d+\.moe_in$", ("ep", "fsdp", "tp")),
    (r"blocks\.\d+\.moe_out$", ("ep", "tp", "fsdp")),
    (r"blocks\.\d+\.ln\d\.(scale|bias)$", (None,)),
    # GPT-J (models.gptj): separate no-bias q/k/v, biased lm head
    (r"blocks\.\d+\.[qkv]\.weight$", ("tp", "fsdp")),         # (d, d)
    (r"^lm_head\.bias$", ("fsdp",)),                          # (vocab,)
    (r"^ln_f\.(scale|bias)$", ()),                            # rank-1 (d,): replicate
    (r"^lm_head\.weight$", ("fsdp", "tp")),                   # (vocab, d_model)
]

#: the axes a batch's rows are split over (``batch_spec``): an sp group
#: shares its rows, and each member takes its chunk of their positions
BATCH_AXES = ("dp", "fsdp")
#: the axes whose members hold different tokens (rows over dp and fsdp,
#: positions over sp): a parameter's gradient is a partial sum over them,
#: and a rank's loss a mean over its share (``train_step.make_step_fn``)
TOKEN_AXES = BATCH_AXES + ("sp",)
#: the axes every parameter mesh keeps, of one rank or more; any other
#: axis joins it when it has more than one rank (``param_mesh``): ep, where
#: the experts are sharded over it
PARAM_AXES = ("dp", "fsdp", "tp")


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor``, without importing DTensor's module
    (it imports sympy: seconds of a fresh process that never shards)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def spec_for_path(path: str) -> tuple:
    for pattern, spec in _RULES:
        if re.search(pattern, path):
            return spec
    return ()  # replicate by default (small tensors)


def param_sharding_rules(params: torch.nn.Module) -> dict:
    """``{parameter path: spec}`` for every parameter of ``params``."""
    return {name: spec_for_path(name) for name, _ in params.named_parameters()}


def batch_spec() -> tuple:
    """(batch, seq) token batches: batch sharded over dp+fsdp, seq whole
    (the model takes its sp chunk of the positions itself, as the
    reference's constraints do)."""
    return (BATCH_AXES,)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements on ``mesh`` for ``spec``: ``Shard(i)`` on each mesh
    axis that tensor dim ``i`` names, ``Replicate()`` elsewhere. Axes the
    mesh lacks are ignored (size 1)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for dim, entry in enumerate(spec):
        for name in _names(entry):
            if name in mesh.mesh_dim_names:
                out[mesh.mesh_dim_names.index(name)] = Shard(dim)
    return out


def local_slices(shape, spec: tuple, mesh) -> tuple:
    """This rank's slice of a tensor of ``shape`` under ``spec``: each
    sharded dim split evenly over the product of its axes, the first axis
    outermost (as JAX orders ``P(("dp", "fsdp"))``)."""
    coord = mesh.get_coordinate()
    slices = [slice(None)] * len(shape)
    for dim, entry in enumerate(spec):
        names = [n for n in _names(entry) if n in mesh.mesh_dim_names]
        if not names:
            continue
        n, idx = 1, 0
        for name in names:
            size = axis_size(mesh, name)
            idx = idx * size + coord[mesh.mesh_dim_names.index(name)]
            n *= size
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(shape)} ({shape[dim]}) does not divide "
                             f"over axes {names} ({n} shards)")
        per = shape[dim] // n
        slices[dim] = slice(idx * per, (idx + 1) * per)
    return tuple(slices)


def global_put(x: torch.Tensor, mesh, spec: tuple):
    """Place a host value onto ``mesh`` under ``spec``: a ``DTensor`` built
    from the shard this rank owns, with no communication — every rank must
    hold the same host value (true for seeded init and test batches), as
    the reference's ``global_put`` requires."""
    from torch.distributed.tensor import DTensor

    local = x[local_slices(x.shape, spec, mesh)]
    if not local.is_meta:  # a meta value (nothing allocated) stays on meta
        local = local.to(mesh.device_type)
    local = local.contiguous()
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


def qkv_order(rows: int, tp: int) -> torch.Tensor:
    """Row order of a fused (q; k; v) weight with ``rows`` = 3h rows under
    ``tp``: tp shard ``r`` holds ``[q_r; k_r; v_r]``, each ``h / tp`` rows."""
    h = rows // 3
    if rows % 3 or h % tp:
        raise ValueError(f"a fused qkv of {rows} rows does not split over tp={tp}")
    per = h // tp
    return torch.tensor([part * h + r * per + i for r in range(tp) for part in range(3)
                         for i in range(per)])


def _is_fused_qkv(path: str) -> bool:
    return re.search(r"attn_qkv\.(weight|bias)$", path) is not None


def param_mesh(mesh):
    """The part of ``mesh`` parameters live on: ``PARAM_AXES`` and any other
    axis of more than one rank (ep on an expert-parallel mesh; sp, over
    which parameters are whole). DTensor's sharding propagation enumerates
    placements over every mesh dim, so two more dims of size 1 made a
    process's first step on the CPU take 10.2 s instead of 0.6 s."""
    names = tuple(a for a in mesh.mesh_dim_names if a in PARAM_AXES or axis_size(mesh, a) > 1)
    return mesh if names == tuple(mesh.mesh_dim_names) else mesh[names]


def shard_params(params: torch.nn.Module, mesh, specs: Optional[dict] = None) -> torch.nn.Module:
    """Replace each parameter of ``params`` by a ``DTensor`` on
    ``param_mesh(mesh)`` under its spec (``param_sharding_rules`` unless
    ``specs`` are given), in place; returns the module. Under ``tp`` > 1
    the fused qkv rows go in ``qkv_order`` first."""
    specs = specs if specs is not None else param_sharding_rules(params)
    tp = axis_size(mesh, "tp")
    mesh = param_mesh(mesh)
    for path, p in list(params.named_parameters()):
        mod_path, _, name = path.rpartition(".")
        mod = params.get_submodule(mod_path) if mod_path else params
        value = p.detach()
        if tp > 1 and _is_fused_qkv(path):
            value = value[qkv_order(value.shape[0], tp).to(value.device)]
        mod._parameters[name] = torch.nn.Parameter(global_put(value, mesh, specs[path]),
                                                   p.requires_grad)
    return params


def full_value(p, fused_qkv: bool = False) -> torch.Tensor:
    """The whole value of a parameter as a plain tensor in the unsharded
    layout: a ``DTensor`` is gathered, and a fused qkv's (``fused_qkv``) tp
    order undone."""
    if not is_dtensor(p):
        return p.detach()
    value = p.detach().full_tensor()
    tp = axis_size(p.device_mesh, "tp")
    if tp > 1 and fused_qkv:
        value = value[torch.argsort(qkv_order(value.shape[0], tp)).to(value.device)]
    return value


def _all_gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    import torch.distributed as dist

    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((size * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    import torch.distributed as dist

    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // size,) + x.shape[1:])
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """A parameter's local shard made whole over some mesh axes. ``plan``
    holds, in mesh order, ``(kind, dim, group, size, rank)``: "gather"
    all-gathers along ``dim`` and reduce-scatters the gradient back (a
    token axis: each rank's gradient is a partial sum); "chunk" all-gathers
    and takes the rank's chunk of the gradient back (an axis whose members
    compute the same gradient); "reduce" moves nothing forward and
    all-reduces the gradient (a token axis holding the parameter whole).
    The backward undoes the gathers first, in mesh order, and all-reduces
    last, so a "reduce" axis (dp under dp x fsdp) moves the shard and not
    the whole gradient. The collectives are the process group's own:
    DTensor's redistribute did the same with enough host work a use to
    leave a 4-card step host-bound (``chip_mesh.py --profile``)."""

    @staticmethod
    def forward(ctx, shard, plan):
        ctx.plan = plan
        for kind, dim, group, size, _ in reversed(plan):
            if kind != "reduce":
                shard = _all_gather(shard, dim, group, size)
        return shard

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        for kind, dim, group, size, rank in ctx.plan:
            if kind == "gather":
                grad = _reduce_scatter(grad, dim, group, size)
            elif kind == "chunk":
                grad = grad.chunk(size, dim)[rank].contiguous()
        for kind, _, group, _, _ in ctx.plan:
            if kind == "reduce":
                grad = grad.contiguous()
                dist.all_reduce(grad, group=group)
        return grad, None


def local(p, keep: tuple = ("tp",)) -> torch.Tensor:
    """The value of parameter ``p`` a rank computes with: a ``DTensor``
    all-gathered over every axis but those in ``keep`` that shard it (by
    default tp: a block's tp-parallel products take their shard; the
    experts keep their ep shard too), as a plain tensor whose gradient is
    reduced, or reduce-scattered, over the token axes into ``p.grad`` in
    ``p``'s placements by the backward (ZeRO-3's gather and reduce-scatter,
    once a use). An axis of one rank moves nothing either way: a one-card
    mesh launches no collective for its parameters. A plain tensor passes
    through."""
    if not is_dtensor(p):
        return p
    mesh = p.device_mesh
    plan = []
    for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, p.placements)):
        size = mesh.size(i)
        if size == 1 or (pl.is_shard() and name in keep):
            continue
        if pl.is_shard():
            kind = "gather" if name in TOKEN_AXES else "chunk"
        elif name in TOKEN_AXES:
            kind = "reduce"
        else:
            continue  # whole on an axis whose members compute the same gradient
        plan.append((kind, pl.dim if pl.is_shard() else None, mesh.get_group(i), size,
                     mesh.get_local_rank(i)))
    shard = p.to_local()
    return _Gather.apply(shard, tuple(plan)) if plan else shard


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int = 0, grad: str = "chunk") -> torch.Tensor:
    """``x`` all-gathered over ``mesh``'s ``axis`` along ``dim``, the
    members' pieces in axis order. The backward hands each member its piece
    of the gradient: ``grad="chunk"`` takes it as it is (the members
    compute the same gradient of the whole), ``grad="sum"`` sums it over
    the members first (each holds a partial gradient)."""
    size = axis_size(mesh, axis)
    if size == 1:
        return x
    kind = {"chunk": "chunk", "sum": "gather"}[grad]
    return _Gather.apply(x, ((kind, dim, mesh.get_group(axis), size, mesh.get_local_rank(axis)),))


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient over a group
    (Megatron's ``f``: a column-parallel product's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (sum) over a group forward; identity backward (Megatron's
    ``g``: a row-parallel product's partial output, or a value every member
    then uses whole)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` summed over ``mesh``'s ``axes`` (those it has of more than one
    rank), its gradient summed over them too: every member puts the sum
    into its own loss, and the step averages the members' gradients, so
    each member's share of the sum gets the whole loss's gradient."""
    for a in axes:
        x = copy_to(reduce_from(x, mesh, a), mesh, a)
    return x


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``mesh``'s ``axis``."""
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyTo.apply(x, mesh.get_group(axis))


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` summed over ``mesh``'s ``axis``; its gradient passed through."""
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh.get_group(axis))


def constrain(x, mesh, spec: tuple):
    """Redistribute a ``DTensor`` to ``spec``'s placements on ``mesh``; a
    plain tensor (a rank's own shard) passes through, as the reference's
    constraint does nothing outside jit."""
    if not is_dtensor(x):
        return x
    return x.redistribute(mesh, placements(spec, mesh))


class _Apply(torch.nn.Module):
    def __init__(self, module: torch.nn.Module, fn):
        super().__init__()
        self.module, self.fn = module, fn

    def forward(self, *args, **kwargs):
        return self.fn(self.module, *args, **kwargs)


def apply_gathered(module: torch.nn.Module, fn, *args, **kwargs):
    """``fn(module, *args, **kwargs)`` with every parameter of ``module``
    gathered whole for the call (``local(p, keep=())``): any module,
    whatever its rule table, runs on a mesh, each rank computing with the
    whole weights on its batch slice; the gradients go back to the shards.
    The whole model is gathered at once (the GPT forward under ``mesh=``
    gathers one block at a time)."""
    values = {f"module.{name}": local(p, keep=()) for name, p in module.named_parameters()}
    return torch.func.functional_call(_Apply(module, fn), values, args, kwargs)
