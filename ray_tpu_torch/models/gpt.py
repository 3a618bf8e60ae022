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
(``kept_linear``), ``"big"`` the gelu output (``kept_gelu``) besides. Ring
attention (``attn_impl="ring"``) and the experts sharded over an ``ep``
mesh axis are not ported (ROADMAP.md, queue A8).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_tpu_torch.device import materialize, resolve_device
from ray_tpu_torch.models._remat import check_policy, kept_gelu, kept_linear, remat_block
from ray_tpu_torch.models.gptj import LayerNorm, _attend_cached, embedding
from ray_tpu_torch.models.sampling import pick_tokens
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.fused_ce import fused_softmax_cross_entropy

#: ``moe_dispatch``: "index" moves each kept assignment's row by its
#: (expert, slot); "einsum" is the reference's one-hot dispatch and combine
MOE_DISPATCH = ("index", "einsum")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The reference's ``GPTConfig``, every field with its default.

    ``scan_unroll`` is accepted and has no effect: the reference unrolls its
    ``lax.scan`` over layers, and eager PyTorch runs the layers as a Python
    loop. ``attn_impl="ring"`` raises (ROADMAP.md, queue A8)."""

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
    attn_impl: str = "auto"           # auto|xla|flash (ring: not ported)
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
    if cfg.attn_impl == "ring":
        raise NotImplementedError(
            "ring attention (attn_impl='ring') is not ported yet: ROADMAP.md, queue A8"
        )
    check_policy(cfg)


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
    numpy arrays (layers stacked in a leading L axis, kernels (in, out))."""
    tree: dict = {}
    stacks: dict = {}
    for param, path, layer, transposed in _param_map(model):
        a = param.detach().float().cpu().numpy()
        a = a.T if transposed else a
        if layer is None:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = np.ascontiguousarray(a)
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


def _attn_in(cfg: GPTConfig, x, layer: GPTBlock):
    """ln1 and the qkv projection: (q, k, v), each (b, heads, s, head_dim)."""
    b, s, d = x.shape
    h = layer.ln1(x)
    lin = layer.attn_qkv
    qkv = kept_linear(h, lin.weight.to(h.dtype), lin.bias.to(h.dtype), "qkv")
    q, k, v = qkv.split(d, dim=-1)

    def heads(t):
        return t.view(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)

    return heads(q), heads(k), heads(v)


def _attn_out(x, att, layer: GPTBlock):
    """The out-projection's residual."""
    b, s, d = x.shape
    return x + _linear(att.transpose(1, 2).reshape(b, s, d), layer.attn_out)


def _mlp(x, layer: GPTBlock):
    """The dense MLP's residual."""
    mid = kept_gelu(_linear(layer.ln2(x), layer.mlp_in), "mlp_mid")
    return x + _linear(mid, layer.mlp_out)


def _moe_route(cfg: GPTConfig, flat, router):
    """Top-k routing with a capacity per expert, as the reference's
    ``_moe_mlp`` (``ray_tpu/models/gpt.py:124-175``). ``flat`` (n, d).
    Returns ``(gate_w (n, k) fp32, expert (n*k,), slot (n*k,), keep (n*k,)
    bool, aux)``, assignments token-major. Within an expert, slots go to
    assignments in that order (a cumsum over it), and those at or past the
    capacity drop. ``aux`` is the Switch load-balancing loss, ``E *
    sum(frac * mean_prob) * k``, where ``frac`` (kept assignments per
    expert) carries no gradient."""
    n = flat.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    cap = max(1, int(cfg.capacity_factor * k * n / E))
    probs = torch.softmax((flat @ router.to(flat.dtype)).float(), dim=-1)  # (n, E)
    # a stable sort puts the lower expert first among equal probabilities,
    # as lax.top_k does (torch.topk promises no order of ties)
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_idx = gate_w[:, :k], gate_idx[:, :k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    expert = gate_idx.reshape(n * k)
    onehot = F.one_hot(expert, E).float()                       # (nk, E)
    slot = ((torch.cumsum(onehot, dim=0) - 1.0) * onehot).sum(-1)
    keep = slot < cap
    frac = (onehot * keep[:, None]).mean(0)
    aux = E * torch.sum(frac * probs.mean(0)) * k
    return gate_w, expert, slot.long(), keep, aux


def _moe_mlp(cfg: GPTConfig, x, layer: GPTBlock, dispatch: str = "index"):
    """Mixture-of-experts MLP: (out (b, s, d) in x's dtype, aux fp32).
    ``dispatch="index"`` gathers each expert's ``(E, cap, d)`` input by slot
    and sums each token's at most k gated expert outputs in fp32;
    ``"einsum"`` is the reference's one-hot form, an ``(n, E, cap)``
    dispatch and combine tensor (O(n·E·cap) memory, the plain version the
    index form is held against). Both cast the gate weights to x's dtype
    first, as the reference's combine does."""
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    n = b * s
    cap = max(1, int(cfg.capacity_factor * k * n / E))
    dt = x.dtype
    flat = x.reshape(n, d)
    gate_w, expert, slot, keep, aux = _moe_route(cfg, flat, layer.router)
    if dispatch == "index":
        # kept assignment -> row expert * cap + slot; the dropped ones all
        # point at a last row that reads zeros and is never read back
        row = torch.where(keep, expert * cap + slot, E * cap)
        token = torch.arange(n * k, device=x.device) // k
        owner = torch.full((E * cap + 1,), n, dtype=torch.long, device=x.device)
        owner[row] = token
        expert_in = F.pad(flat, (0, 0, 0, 1))[owner[: E * cap]].view(E, cap, d)
    elif dispatch == "einsum":
        pos_oh = F.one_hot(slot.clamp_max(cap - 1), cap).float() * keep[:, None]
        disp = (F.one_hot(expert, E).float()[:, :, None] * pos_oh[:, None, :]).view(n, k, E, cap)
        expert_in = torch.einsum("nec,nd->ecd", disp.sum(1).to(dt), flat)
    else:
        raise ValueError(f"moe dispatch must be one of {MOE_DISPATCH}, got {dispatch!r}")
    h = F.gelu(torch.bmm(expert_in, layer.moe_in.to(dt)), approximate="tanh")
    expert_out = torch.bmm(h, layer.moe_out.to(dt))              # (E, cap, d)
    if dispatch == "index":
        rows = torch.cat([expert_out.reshape(E * cap, d), expert_out.new_zeros(1, d)])
        gates = gate_w.to(dt).float().reshape(n * k, 1) * keep[:, None]
        out = (rows[row].float() * gates).view(n, k, d).sum(1).to(dt)
    else:
        combine = (disp * gate_w[:, :, None, None]).sum(1)      # (n, E, cap)
        out = torch.einsum("nec,ecd->nd", combine.to(dt), expert_out)
    return out.reshape(b, s, d), aux


def _block(cfg: GPTConfig, x, layer: GPTBlock, moe_dispatch: str = "index"):
    """One block: (output, MoE aux loss, 0 for a dense block)."""
    q, k, v = _attn_in(cfg, x, layer)
    x = _attn_out(x, causal_attention(q, k, v, impl=cfg.attn_impl), layer)
    if cfg.n_experts > 0:
        out, aux = _moe_mlp(cfg, layer.ln2(x), layer, moe_dispatch)
        return x + out, aux
    return _mlp(x, layer), x.new_zeros((), dtype=torch.float32)


def gpt_hidden(cfg: GPTConfig, params: GPT, tokens: torch.Tensor, *,
               moe_dispatch: str = "index"):
    """tokens (batch, seq) int → (final hidden (batch, seq, d_model) in the
    activation dtype, the MoE aux loss averaged over the layers, fp32; 0
    for a dense model). The lm head is applied by the caller.
    ``moe_dispatch`` picks ``_moe_mlp``'s form."""
    _check_supported(cfg)
    dt = cfg.torch_dtype
    s = tokens.shape[1]
    # gather fp32 rows, then cast
    x = F.embedding(tokens, params.embed.weight).to(dt)
    x = x + params.pos_embed.weight[:s].to(dt)
    auxes = []
    for layer in params.blocks:
        x, aux = remat_block(cfg, x, partial(_block, cfg, layer=layer, moe_dispatch=moe_dispatch))
        auxes.append(aux)
    return params.ln_f(x), torch.stack(auxes).mean()


def gpt_forward(cfg: GPTConfig, params: GPT, tokens: torch.Tensor, *,
                return_aux: bool = False, moe_dispatch: str = "index"):
    """tokens (batch, seq) int → logits (batch, seq, vocab) fp32;
    ``return_aux=True`` also returns the mean MoE aux loss."""
    hidden, aux = gpt_hidden(cfg, params, tokens, moe_dispatch=moe_dispatch)
    logits = hidden.float() @ params.lm_head.weight.t()
    return (logits, aux) if return_aux else logits


def gpt_loss(cfg: GPTConfig, params: GPT, tokens: torch.Tensor, *,
             moe_dispatch: str = "index") -> torch.Tensor:
    """Next-token cross-entropy, mean over (batch, seq - 1), plus
    ``cfg.moe_aux_weight`` x the aux loss for a mixture of experts. With
    ``cfg.fused_loss`` the (tokens, vocab) logits go through the fused
    cross-entropy in ``cfg.ce_chunks`` vocab chunks."""
    hidden, aux = gpt_hidden(cfg, params, tokens[:, :-1], moe_dispatch=moe_dispatch)
    targets = tokens[:, 1:]
    if cfg.fused_loss:
        b, s, d = hidden.shape
        losses = fused_softmax_cross_entropy(
            hidden.reshape(b * s, d), params.lm_head.weight.t(), targets.reshape(-1), cfg.ce_chunks
        )
        loss = losses.mean()
    else:
        logits = hidden.float() @ params.lm_head.weight.t()
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
