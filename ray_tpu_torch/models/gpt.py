"""Decoder-only transformer (GPT family) for training and serving (port of
``ray_tpu/models/gpt.py``).

* Parameters live in an ``nn.Module`` (``GPT``) as **fp32 master weights**;
  every use casts them to the activation dtype (``cfg.dtype``), as the
  reference does, so gradients flow back through the casts into fp32
  parameters. ``nn.Linear`` keeps its weight as (out, in) where the
  reference's kernels are (in, out), and the reference stacks the layers in
  a leading L axis: ``params_from_jax`` and ``params_to_numpy`` convert.
* Layernorms normalize in fp32 with the population variance; the MLP uses
  the tanh-approximate gelu (JAX's default); the token embedding gathers
  fp32 rows, then casts.
* Attention goes through ``ops.attention.causal_attention`` with
  ``cfg.attn_impl``: on the card ``auto`` and ``flash`` run the flash
  kernels K3 (forward) and K4/K5 (backward).
* ``n_experts > 0`` puts a mixture of experts in every block's MLP
  (``_moe_mlp``): top-k routing with a capacity per expert, over-capacity
  assignments dropped in the reference's order, and the Switch
  load-balancing loss, which ``gpt_hidden`` returns beside the hidden state
  and ``gpt_loss`` adds with ``cfg.moe_aux_weight``. The experts' weights
  keep the reference's layouts: ``router`` (d, E), ``moe_in`` (E, d, 4d),
  ``moe_out`` (E, 4d, d), no biases.
* ``gpt_loss`` feeds the final hidden state to the fused cross-entropy
  (``ops.fused_ce``) when ``cfg.fused_loss``.
* ``gpt_decode`` is the dense KV-cached decoder (greedy or sampled per
  token), the oracle the paged engine (``llm.model_runner``) is tested
  against and the GPT draft model's proposer (``llm.drafter``).

Rematerialization (``cfg.remat``) checkpoints each block under one of the
reference's five policies (``models._remat``): ``"full"`` and ``"dots"``
run the flash forward (K3) again in the backward; ``"attn"``, ``"attn_qkv"``
and ``"big"`` keep its out and lse, and ``"attn_qkv"`` the qkv projection
(``kept_linear``), ``"big"`` the gelu output (``kept_gelu``) besides.

``mesh=`` (a ``parallel.mesh.make_mesh`` mesh; the parameters sharded onto
it by ``parallel.sharding.shard_params``) runs this rank's share of the
reference's SPMD program, every mesh axis of it:

* the tokens are this rank's batch slice (rows over ``(dp, fsdp)``, whole
  within an ``sp``, ``ep`` or ``tp`` group), and the rank takes its chunk
  ``[off, off + seq / sp)`` of the positions, which it keeps end to end;
* each block all-gathers its parameters on use (``sharding.local``);
* under ``tp`` each rank holds ``n_heads / tp`` heads: the qkv and MLP-in
  products are column-parallel, the out-projections row-parallel with one
  all-reduce each (``sharding.reduce_from``), and so are the experts' two
  products (their middle over tp, as the reference's ``P("ep", None,
  "tp")``);
* attention is ring attention over ``sp`` (``attn_impl="ring"``, or
  ``"auto"`` on a mesh with ``sp > 1``: ``ops.ring_attention``), else the
  flash kernels on each rank's shard
  (``ops.flash_attention.flash_attention_sharded``);
* under ``ep`` each rank computes its ``n_experts / ep`` experts on the
  tokens its group shares, and the experts' output rows are all-gathered
  over ep before the combine (``_moe_mlp``); routing is the reference's
  one-device routing over the global batch (``_moe_route``).

The activations are the local shards the reference's constraints name
(``ray_tpu/models/gpt.py:178-245``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_tpu_torch.device import materialize, resolve_device
from ray_tpu_torch.models._remat import check_policy, kept_gelu, kept_linear, remat_block
from ray_tpu_torch.models.gptj import LayerNorm, _attend_cached, _layernorm, embedding
from ray_tpu_torch.models.sampling import pick_tokens
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.flash_attention import flash_attention_sharded
from ray_tpu_torch.ops.fused_ce import fused_softmax_cross_entropy
from ray_tpu_torch.ops.ring_attention import ring_attention_sharded
from ray_tpu_torch.parallel.mesh import axis_size
from ray_tpu_torch.parallel.sharding import (TOKEN_AXES, copy_to, full_value, gather_from, local, psum,
                                             reduce_from)

#: ``moe_dispatch``: "index" moves each kept assignment's row by its
#: (expert, slot); "einsum" is the reference's one-hot dispatch and combine
MOE_DISPATCH = ("index", "einsum")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The reference's ``GPTConfig``, every field with its default.

    ``scan_unroll`` is accepted and has no effect: the reference unrolls its
    ``lax.scan`` over layers, and eager PyTorch runs the layers as a Python
    loop. ``attn_impl="ring"`` needs a mesh (``gpt_hidden``'s ``mesh=``)."""

    vocab_size: int = 50_304
    seq_len: int = 1024
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    dtype: str = "bfloat16"           # activation/compute dtype
    remat: bool = True
    #: what a block keeps for the backward: "full" (nothing), "dots",
    #: "attn", "attn_qkv" or "big" (``models._remat``)
    remat_policy: str = "full"
    fused_loss: bool = True
    #: vocab chunk count for the fused loss (None = auto)
    ce_chunks: Optional[int] = None
    attn_impl: str = "auto"           # auto|xla|flash|ring (see _attention)
    scan_unroll: int = 1
    #: mixture of experts (0 = dense MLP): top-``experts_per_token``
    #: routing, ``capacity_factor`` x the even share of assignments per
    #: expert, load-balancing loss weight ``moe_aux_weight``
    n_experts: int = 0
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def d_ff(self) -> int:
        return 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _check_supported(cfg: GPTConfig) -> None:
    check_policy(cfg)


def _check_mesh(cfg: GPTConfig, mesh) -> None:
    tp, ep = axis_size(mesh, "tp"), axis_size(mesh, "ep")
    if cfg.n_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads} does not divide over tp={tp}")
    if cfg.n_experts and cfg.n_experts % ep:
        raise ValueError(f"n_experts={cfg.n_experts} does not divide over ep={ep}")


def _coord(mesh, axis: str) -> int:
    """This rank's position on ``mesh``'s ``axis`` (0 on an axis of one)."""
    return mesh.get_local_rank(axis) if axis_size(mesh, axis) > 1 else 0


def _seq_chunk(mesh, s: int) -> tuple[int, int]:
    """This rank's chunk of ``s`` positions, ``(offset, length)``: the
    ``sp`` coordinate's contiguous ``s / sp`` of them (all of them off a
    mesh)."""
    sp = 1 if mesh is None else axis_size(mesh, "sp")
    if s % sp:
        raise ValueError(f"a sequence of {s} positions does not divide over sp={sp}")
    return (0 if mesh is None else _coord(mesh, "sp")) * (s // sp), s // sp


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        d, dff = cfg.d_model, cfg.d_ff
        self.ln1 = LayerNorm(d, device)
        self.attn_qkv = nn.Linear(d, 3 * d, device=device)
        self.attn_out = nn.Linear(d, d, device=device)
        self.ln2 = LayerNorm(d, device)
        if cfg.n_experts > 0:
            E = cfg.n_experts
            self.router = nn.Parameter(torch.empty(d, E, device=device))
            self.moe_in = nn.Parameter(torch.empty(E, d, dff, device=device))
            self.moe_out = nn.Parameter(torch.empty(E, dff, d, device=device))
        else:
            self.mlp_in = nn.Linear(d, dff, device=device)
            self.mlp_out = nn.Linear(dff, d, device=device)


class GPT(nn.Module):
    """GPT parameters, fp32. Build it with ``gpt_init`` or
    ``params_from_jax``."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        d = cfg.d_model
        self.embed = embedding(cfg.vocab_size, d, device)
        self.pos_embed = embedding(cfg.seq_len, d, device)
        self.blocks = nn.ModuleList(GPTBlock(cfg, device) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(d, device)
        self.lm_head = nn.Linear(d, cfg.vocab_size, bias=False, device=device)


def _empty_model(cfg: GPTConfig, device) -> GPT:
    # built on the meta device first: nn.Linear's own init would otherwise
    # draw and then discard every weight
    return materialize(GPT(cfg, device="meta"), device)


@torch.no_grad()
def gpt_init(cfg: GPTConfig, generator: torch.Generator, device=None) -> GPT:
    """Random init in the reference's distributions: embeddings normal with
    std 0.02, kernels (the experts' too) normal scaled by fan_in^-0.5, zero
    biases, unit/zero layernorms. ``device=None`` means the card
    (``resolve_device``); the draws are made there, so ``generator`` must
    live on that device type."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(
            f"generator is on {generator.device}, the model goes to {device}: "
            "give a generator on the model's device"
        )
    model = _empty_model(cfg, device)

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator, device=device) * std)

    for p in model.parameters():
        p.zero_()
    normal(model.embed.weight, 0.02)
    normal(model.pos_embed.weight, 0.02)
    for blk in model.blocks:
        blk.ln1.scale.fill_(1.0)
        blk.ln2.scale.fill_(1.0)
        for lin in (blk.attn_qkv, blk.attn_out) + (() if cfg.n_experts else (blk.mlp_in, blk.mlp_out)):
            normal(lin.weight, lin.in_features**-0.5)
        if cfg.n_experts:
            normal(blk.router, cfg.d_model**-0.5)
            normal(blk.moe_in, cfg.d_model**-0.5)
            normal(blk.moe_out, cfg.d_ff**-0.5)
    model.ln_f.scale.fill_(1.0)
    normal(model.lm_head.weight, cfg.d_model**-0.5)
    return model


def _param_map(model: GPT):
    """Yields (module parameter, reference tree path, layer index or None,
    transposed) for every parameter of ``model``."""
    yield model.embed.weight, ("embed", "tokens"), None, False
    yield model.pos_embed.weight, ("embed", "pos"), None, False
    for i, blk in enumerate(model.blocks):
        for ln in ("ln1", "ln2"):
            yield getattr(blk, ln).scale, ("blocks", ln, "scale"), i, False
            yield getattr(blk, ln).bias, ("blocks", ln, "bias"), i, False
        moe = hasattr(blk, "router")
        for name in ("attn_qkv", "attn_out") + (() if moe else ("mlp_in", "mlp_out")):
            lin = getattr(blk, name)
            yield lin.weight, ("blocks", name, "kernel"), i, True
            yield lin.bias, ("blocks", name, "bias"), i, False
        if moe:  # kept in the reference's layouts: nothing to transpose
            for name in ("router", "moe_in", "moe_out"):
                yield getattr(blk, name), ("blocks", name, "kernel"), i, False
    yield model.ln_f.scale, ("ln_f", "scale"), None, False
    yield model.ln_f.bias, ("ln_f", "bias"), None, False
    yield model.lm_head.weight, ("lm_head", "kernel"), None, True


@torch.no_grad()
def params_from_jax(tree: dict, cfg: GPTConfig, device=None) -> GPT:
    """Carry a reference parameter tree over: nested dicts of numpy arrays
    with the stacked leading ``L`` axis and kernels laid out (in, out), as
    ``ray_tpu.models.gpt.gpt_init`` returns them (after
    ``jax.device_get``), dense or mixture-of-experts. ``device=None`` means
    the card."""
    dev = resolve_device(device)
    model = _empty_model(cfg, dev)
    for param, path, layer, transposed in _param_map(model):
        a = tree
        for key in path:
            a = a[key]
        a = np.asarray(a if layer is None else a[layer])
        t = torch.tensor(a.T if transposed else a, dtype=torch.float32)
        param.copy_(t)
    return model


def params_to_numpy(model: GPT) -> dict:
    """The inverse of ``params_from_jax``: the reference's tree of fp32
    numpy arrays (layers stacked in a leading L axis, kernels (in, out)).
    Parameters sharded over a mesh are gathered (every rank calls it)."""
    tree: dict = {}
    stacks: dict = {}
    for param, path, layer, transposed in _param_map(model):
        a = full_value(param, fused_qkv=path[1:2] == ("attn_qkv",)).float().cpu().numpy()
        a = a.T if transposed else a
        if layer is None:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = np.array(a)  # a copy: a CPU parameter's numpy view would follow later steps
        else:
            stacks.setdefault(path, []).append(a)
    for path, per_layer in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(per_layer)
    return tree


def _linear(x, lin: nn.Linear):
    """``x @ kernel + bias`` with the fp32 master weights cast to x's dtype."""
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _row_linear(x, lin, mesh):
    """``_linear`` of a row-parallel product: under ``tp`` each rank's
    partial product is summed over the tp group before the bias."""
    if mesh is None or axis_size(mesh, "tp") == 1:
        return _linear(x, lin)
    return reduce_from(F.linear(x, lin.weight.to(x.dtype)), mesh, "tp") + lin.bias.to(x.dtype)


def _tp_input(h, mesh):
    """A column-parallel product's input: its gradient summed over tp."""
    return h if mesh is None else copy_to(h, mesh, "tp")


class _LocalLinear(NamedTuple):
    weight: torch.Tensor
    bias: torch.Tensor


class _LocalLayerNorm(NamedTuple):
    scale: torch.Tensor
    bias: torch.Tensor

    def __call__(self, x):
        return _layernorm(x, self.scale, self.bias)


def _on_mesh(layer: GPTBlock):
    """The block's parameters as this rank computes with them
    (``sharding.local``: gathered over every axis but tp, and the experts
    but ep and tp). Built inside the block, so a rematerialized block
    gathers them again in the backward (ZeRO-3)."""
    out = {name: _LocalLayerNorm(local(m.scale), local(m.bias))
           for name, m in (("ln1", layer.ln1), ("ln2", layer.ln2))}
    names = ("attn_qkv", "attn_out") + (() if hasattr(layer, "router") else ("mlp_in", "mlp_out"))
    out.update({name: _LocalLinear(local(getattr(layer, name).weight), local(getattr(layer, name).bias))
                for name in names})
    if hasattr(layer, "router"):  # the router whole; the rank's experts, their middle over tp
        out["router"] = local(layer.router, keep=())
        out.update({name: local(getattr(layer, name), keep=("ep", "tp")) for name in ("moe_in", "moe_out")})
    return SimpleNamespace(**out)


def _attn_in(cfg: GPTConfig, x, layer: GPTBlock, mesh=None):
    """ln1 and the qkv projection: (q, k, v), each (b, heads, s, head_dim)
    (the rank's ``n_heads / tp`` heads on a mesh)."""
    b, s, d = x.shape
    h = _tp_input(layer.ln1(x), mesh)
    lin = layer.attn_qkv
    qkv = kept_linear(h, lin.weight.to(h.dtype), lin.bias.to(h.dtype), "qkv")
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)

    def heads(t):
        return t.view(b, s, -1, cfg.head_dim).transpose(1, 2)

    return heads(q), heads(k), heads(v)


def _attn_out(x, att, layer: GPTBlock, mesh=None):
    """The out-projection's residual."""
    b, s, d = x.shape
    return x + _row_linear(att.transpose(1, 2).reshape(b, s, -1), layer.attn_out, mesh)


def _mlp(x, layer: GPTBlock, mesh=None):
    """The dense MLP's residual."""
    mid = kept_gelu(_linear(_tp_input(layer.ln2(x), mesh), layer.mlp_in), "mlp_mid")
    return x + _row_linear(mid, layer.mlp_out, mesh)


def _earlier_counts(counts, mesh):
    """The assignments to each expert before each of this rank's rows in
    the global token order. ``counts`` (rows, E): each local row's
    assignments to each expert (in the rank's chunk of positions). The
    global order is the reference's one-device order: the global batch's
    rows, split over ``(dp, fsdp)`` (dp outermost), then the positions,
    split over ``sp``. So a rank all-gathers every (row, chunk)'s counts and
    takes an exclusive prefix sum in that order. (rows, E) long."""
    if mesh is None or all(axis_size(mesh, a) == 1 for a in TOKEN_AXES):
        return counts.cumsum(0) - counts
    rows, E = counts.shape
    every = gather_from(counts[:, None], mesh, "sp", dim=1)            # (rows, sp, E)
    every = gather_from(gather_from(every, mesh, "fsdp"), mesh, "dp")  # (B, sp, E)
    flat = every.reshape(-1, E)
    before = (flat.cumsum(0) - flat).view(every.shape)
    row0 = (_coord(mesh, "dp") * axis_size(mesh, "fsdp") + _coord(mesh, "fsdp")) * rows
    return before[row0:row0 + rows, _coord(mesh, "sp")]


def _capacity(cfg: GPTConfig, n: int, mesh) -> tuple[int, int]:
    """(the global token count of ``n`` tokens a rank, the capacity per
    expert it gives)."""
    if mesh is not None:
        for a in TOKEN_AXES:
            n *= axis_size(mesh, a)
    return n, max(1, int(cfg.capacity_factor * cfg.experts_per_token * n / cfg.n_experts))


def _moe_route(cfg: GPTConfig, flat, router, rows: int = 1, mesh=None):
    """Top-k routing with a capacity per expert, as the reference's
    ``_moe_mlp`` (``ray_tpu/models/gpt.py:124-175``) routes on one device.
    ``flat`` (n, d): this rank's ``rows`` rows of tokens (all of them off a
    mesh). Returns ``(gate_w (n, k) fp32, expert (n*k,), slot (n*k,), keep
    (n*k,) bool, aux)``, assignments token-major. The capacity comes from
    the global token count (``_capacity``). Within an expert, slots go to
    assignments in the global token-major order (``_earlier_counts`` and a
    cumsum over each row), and those at or past the capacity drop. ``aux``
    is the Switch load-balancing loss over the global batch, ``E *
    sum(frac * mean_prob) * k``, where ``frac`` (kept assignments per
    expert) carries no gradient: both factors are summed over the token
    axes (``psum``) before their product, so every rank holds the
    reference's value."""
    n = flat.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    n_all, cap = _capacity(cfg, n, mesh)
    probs = torch.softmax((flat @ router.to(flat.dtype)).float(), dim=-1)  # (n, E)
    # a stable sort puts the lower expert first among equal probabilities,
    # as lax.top_k does (torch.topk promises no order of ties)
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_idx = gate_w[:, :k], gate_idx[:, :k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    expert = gate_idx.reshape(n * k)
    onehot = F.one_hot(expert, E)                               # (nk, E)
    per_row = onehot.view(rows, -1, E)
    within = per_row.cumsum(1)
    before = _earlier_counts(within[:, -1], mesh)
    slot = ((within - 1 + before[:, None]) * per_row).sum(-1).reshape(n * k)
    keep = slot < cap
    kept, prob_sum = (onehot * keep[:, None]).sum(0).float(), probs.sum(0)
    if mesh is not None:
        kept, prob_sum = psum(kept, mesh, TOKEN_AXES), psum(prob_sum, mesh, TOKEN_AXES)
    aux = E * torch.sum(kept / (n_all * k) * (prob_sum / n_all)) * k
    return gate_w, expert, slot, keep, aux


def _moe_mlp(cfg: GPTConfig, x, layer: GPTBlock, dispatch: str = "index", mesh=None):
    """Mixture-of-experts MLP: (out (b, s, d) in x's dtype, aux fp32).
    ``dispatch="index"`` gathers each expert's ``(E, cap, d)`` input by slot
    and sums each token's at most k gated expert outputs in fp32;
    ``"einsum"`` is the reference's one-hot form, an ``(n, E, cap)``
    dispatch and combine tensor (O(n·E·cap) memory, the plain version the
    index form is held against). Both cast the gate weights to x's dtype
    first, as the reference's combine does.

    On a mesh the slots are global (``_moe_route``), so a rank's inputs
    fill the rows its tokens own. An ep rank computes its ``E / ep``
    experts on the tokens its group shares (exact: an expert acts row by
    row); the output rows are all-gathered over ep and every member
    combines them whole, so the router, gates and aux stay replicated. The
    experts' input gradient is summed over ep (each rank's holds its own
    experts' part) and over tp (each rank's holds its middle's)."""
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    n = b * s
    dt = x.dtype
    flat = x.reshape(n, d)
    _, cap = _capacity(cfg, n, mesh)
    gate_w, expert, slot, keep, aux = _moe_route(cfg, flat, layer.router, b, mesh)
    ep = 1 if mesh is None else axis_size(mesh, "ep")
    n_local, e0 = E // ep, (0 if ep == 1 else _coord(mesh, "ep") * (E // ep))
    xin = flat if mesh is None else copy_to(copy_to(flat, mesh, "ep"), mesh, "tp")
    if dispatch == "index":
        # kept assignment -> row expert * cap + slot; the dropped ones (and
        # another ep rank's) all point at a last row that reads zeros and
        # is never read back
        row = torch.where(keep, expert * cap + slot, E * cap)
        mine = row if ep == 1 else torch.where(
            keep & (expert >= e0) & (expert < e0 + n_local), row - e0 * cap, n_local * cap)
        token = torch.arange(n * k, device=x.device) // k
        owner = torch.full((n_local * cap + 1,), n, dtype=torch.long, device=x.device)
        owner[mine] = token
        expert_in = F.pad(xin, (0, 0, 0, 1))[owner[: n_local * cap]].view(n_local, cap, d)
    elif dispatch == "einsum":
        pos_oh = F.one_hot(slot.clamp_max(cap - 1), cap).float() * keep[:, None]
        disp = (F.one_hot(expert, E).float()[:, :, None] * pos_oh[:, None, :]).view(n, k, E, cap)
        expert_in = torch.einsum("nec,nd->ecd", disp.sum(1)[:, e0:e0 + n_local].to(dt), xin)
    else:
        raise ValueError(f"moe dispatch must be one of {MOE_DISPATCH}, got {dispatch!r}")
    h = F.gelu(torch.bmm(expert_in, layer.moe_in.to(dt)), approximate="tanh")
    expert_out = torch.bmm(h, layer.moe_out.to(dt))              # (E / ep, cap, d)
    if mesh is not None:
        expert_out = gather_from(reduce_from(expert_out, mesh, "tp"), mesh, "ep")
    if dispatch == "index":
        rows = torch.cat([expert_out.reshape(E * cap, d), expert_out.new_zeros(1, d)])
        gates = gate_w.to(dt).float().reshape(n * k, 1) * keep[:, None]
        out = (rows[row].float() * gates).view(n, k, d).sum(1).to(dt)
    else:
        combine = (disp * gate_w[:, :, None, None]).sum(1)      # (n, E, cap)
        out = torch.einsum("nec,ecd->nd", combine.to(dt), expert_out)
    return out.reshape(b, s, d), aux


def _local_attention(cfg: GPTConfig, q, k, v, mesh):
    want_flash = cfg.attn_impl == "flash" or (cfg.attn_impl == "auto" and q.is_cuda)
    if mesh is not None and want_flash:
        return flash_attention_sharded(q, k, v, mesh)
    return causal_attention(q, k, v, impl=cfg.attn_impl)


def _attention(cfg: GPTConfig, q, k, v, mesh):
    """Causal attention of the block's heads, chosen as the reference
    chooses (``ray_tpu/models/gpt.py:205-243``): ring attention over sp for
    ``attn_impl="ring"``, or ``"auto"`` on a mesh with sp > 1; otherwise
    the flash kernels (the einsum for ``"xla"``, or ``"auto"`` on the CPU),
    on a mesh on this rank's shard (batch over dp x fsdp, heads over tp).
    With sp > 1 they take the sequence whole, as the reference's flash
    shard_map does: q, k and v are gathered over sp, and the rank keeps its
    chunk of the output."""
    sp = 1 if mesh is None else axis_size(mesh, "sp")
    if mesh is not None and (cfg.attn_impl == "ring" or (cfg.attn_impl == "auto" and sp > 1)):
        return ring_attention_sharded(q, k, v, mesh)
    if sp == 1:
        return _local_attention(cfg, q, k, v, mesh)
    s = q.shape[2]
    whole = (gather_from(t, mesh, "sp", dim=2, grad="sum") for t in (q, k, v))
    off = _coord(mesh, "sp") * s
    return _local_attention(cfg, *whole, mesh)[:, :, off:off + s]


def _block(cfg: GPTConfig, x, layer: GPTBlock, moe_dispatch: str = "index", mesh=None):
    """One block: (output, MoE aux loss, 0 for a dense block)."""
    if mesh is not None:
        layer = _on_mesh(layer)
    q, k, v = _attn_in(cfg, x, layer, mesh)
    x = _attn_out(x, _attention(cfg, q, k, v, mesh), layer, mesh)
    if cfg.n_experts > 0:
        out, aux = _moe_mlp(cfg, layer.ln2(x), layer, moe_dispatch, mesh)
        return x + out, aux
    return _mlp(x, layer, mesh), x.new_zeros((), dtype=torch.float32)


def gpt_hidden(cfg: GPTConfig, params: GPT, tokens: torch.Tensor, mesh=None, *,
               moe_dispatch: str = "index"):
    """tokens (batch, seq) int → (final hidden (batch, seq, d_model) in the
    activation dtype, the MoE aux loss averaged over the layers, fp32; 0
    for a dense model). The lm head is applied by the caller.
    ``moe_dispatch`` picks ``_moe_mlp``'s form. With ``mesh`` the tokens
    are this rank's batch slice, all of their positions, and the result the
    hidden state of the rank's chunk of the positions (``_seq_chunk``); the
    aux loss is the global batch's on every rank."""
    _check_supported(cfg)
    if cfg.attn_impl == "ring" and mesh is None:
        raise ValueError(
            "attn_impl='ring' needs a device mesh with an 'sp' axis; pass "
            "mesh= (or use attn_impl='auto', which picks ring only when the "
            "mesh shards sequence)"
        )
    if mesh is not None:
        _check_mesh(cfg, mesh)
    dt = cfg.torch_dtype
    off, s = _seq_chunk(mesh, tokens.shape[1])
    tokens = tokens[:, off:off + s]
    # gather fp32 rows, then cast
    x = F.embedding(tokens, local(params.embed.weight, keep=())).to(dt)
    x = x + local(params.pos_embed.weight)[off:off + s].to(dt)
    auxes = []
    for layer in params.blocks:
        x, aux = remat_block(cfg, x, partial(_block, cfg, layer=layer, moe_dispatch=moe_dispatch,
                                             mesh=mesh))
        auxes.append(aux)
    return _layernorm(x, local(params.ln_f.scale), local(params.ln_f.bias)), torch.stack(auxes).mean()


def gpt_forward(cfg: GPTConfig, params: GPT, tokens: torch.Tensor, mesh=None, *,
                return_aux: bool = False, moe_dispatch: str = "index"):
    """tokens (batch, seq) int → logits (batch, seq, vocab) fp32;
    ``return_aux=True`` also returns the mean MoE aux loss. With ``mesh``,
    this rank's batch slice, its chunk of the positions under sp."""
    hidden, aux = gpt_hidden(cfg, params, tokens, mesh, moe_dispatch=moe_dispatch)
    logits = hidden.float() @ local(params.lm_head.weight, keep=()).t()
    return (logits, aux) if return_aux else logits


def gpt_loss(cfg: GPTConfig, params: GPT, tokens: torch.Tensor, mesh=None, *,
             moe_dispatch: str = "index") -> torch.Tensor:
    """Next-token cross-entropy, mean over (batch, seq - 1), plus
    ``cfg.moe_aux_weight`` x the aux loss for a mixture of experts. With
    ``cfg.fused_loss`` the (tokens, vocab) logits go through the fused
    cross-entropy in ``cfg.ce_chunks`` vocab chunks. With ``mesh``, the
    mean over this rank's tokens: its batch slice, its chunk of the
    positions under sp (``parallel.build_train_step`` averages the ranks'
    means)."""
    hidden, aux = gpt_hidden(cfg, params, tokens[:, :-1], mesh, moe_dispatch=moe_dispatch)
    off, s = _seq_chunk(mesh, tokens.shape[1] - 1)
    targets = tokens[:, 1:][:, off:off + s]
    head = local(params.lm_head.weight, keep=())
    if cfg.fused_loss:
        b, s, d = hidden.shape
        losses = fused_softmax_cross_entropy(
            hidden.reshape(b * s, d), head.t(), targets.reshape(-1), cfg.ce_chunks
        )
        loss = losses.mean()
    else:
        logits = hidden.float() @ head.t()
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, targets.long()[..., None])[..., 0].mean()
    if cfg.n_experts > 0:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


# ---------------------------------------------------------------------------
# KV-cache decode (inference path; sampling shared with models.sampling)
# ---------------------------------------------------------------------------


@torch.no_grad()
def gpt_decode(cfg: GPTConfig, params: GPT, prompt: torch.Tensor, n_new: int, *, key=None,
               temperature=0.0, top_k=0, top_p=1.0) -> torch.Tensor:
    """Decode ``n_new`` tokens after ``prompt`` (b, s0) → (b, s0 + n_new):
    one dense forward captures each layer's k/v into a per-call cache, then
    each new token is a single-position pass over it. Its attention is
    plain (the reference's ``impl="xla"``). Greedy by default; with an int
    ``key``, per-token temperature/top-k/top-p sampling via
    ``models.sampling.sample_tokens`` (scalars or per-row tensors), step
    ``i`` keyed ``fold_in(key, i)``.

    Dense blocks only (``n_experts == 0``); the learned positional table
    caps ``s0 + n_new`` at ``cfg.seq_len``."""
    if cfg.n_experts > 0:
        raise NotImplementedError("gpt_decode supports dense (non-MoE) configs only")
    dt = cfg.torch_dtype
    b, s0 = prompt.shape
    max_len = s0 + n_new
    if max_len > cfg.seq_len:
        raise ValueError(
            f"prompt ({s0}) + n_new ({n_new}) exceeds the positional table (seq_len={cfg.seq_len})"
        )
    dev = prompt.device
    x = F.embedding(prompt, params.embed.weight).to(dt) + params.pos_embed.weight[:s0].to(dt)
    caches = []
    for layer in params.blocks:
        q, k, v = _attn_in(cfg, x, layer)
        x = _mlp(_attn_out(x, causal_attention(q, k, v, impl="xla"), layer), layer)
        kc = torch.zeros(b, cfg.n_heads, max_len, cfg.head_dim, dtype=dt, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :, :s0] = k
        vc[:, :, :s0] = v
        caches.append((kc, vc))

    def logits(h):  # (b, d) → fp32 (b, vocab)
        return params.ln_f(h).float() @ params.lm_head.weight.t()

    tokens = torch.cat([prompt, torch.zeros(b, n_new, dtype=prompt.dtype, device=dev)], dim=1)
    tokens[:, s0] = pick_tokens(logits(x[:, -1]), key, 0, temperature, top_k, top_p)
    for i in range(n_new - 1):
        pos = s0 + i  # position of the token being FED
        x1 = F.embedding(tokens[:, pos : pos + 1], params.embed.weight).to(dt)
        x1 = x1 + params.pos_embed.weight[pos].to(dt)  # (b, 1, d)
        for layer, (kc, vc) in zip(params.blocks, caches):
            q, k, v = _attn_in(cfg, x1, layer)  # (b, heads, 1, hd) each
            kc[:, :, pos] = k[:, :, 0]
            vc[:, :, pos] = v[:, :, 0]
            att = _attend_cached(q[:, :, 0], kc, vc, pos + 1).to(dt)[:, :, None]
            x1 = _mlp(_attn_out(x1, att, layer), layer)
        tokens[:, pos + 1] = pick_tokens(logits(x1[:, 0]), key, i + 1, temperature, top_k, top_p)
    return tokens
