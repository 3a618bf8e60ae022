"""GPT-J decoder in PyTorch (port of ``ray_tpu/models/gptj.py``).

The architecture the serving engine runs:

* rotary position embeddings on the first ``rotary_dim`` dims of every
  head, GPT-J's INTERLEAVED (rotate-every-two) variant;
* parallel residual: ``x + attn(ln(x)) + mlp(ln(x))`` over one layernorm;
* no biases on q/k/v/out projections; an untied lm head WITH bias.

Parameters live in an ``nn.Module`` (``GPTJ``). The matmul weights and the
token embedding are stored in the activation dtype; the layernorms and the
lm head stay fp32, because the reference computes the lm head in fp32.
``nn.Linear`` keeps its weight as (out, in) where the reference's kernels
are (in, out): ``params_from_jax`` transposes when it carries weights over.

``gptj_forward`` and ``gptj_decode`` (greedy, or sampled per token) are the
dense oracles the engine is tested against; they attend with the plain
einsum. ``gptj_hidden`` and ``gptj_loss`` are the training path: attention
through ``ops.attention.causal_attention`` with ``cfg.attn_impl`` (on the
card ``auto`` takes the flash kernels K3-K5, which take head dims 64 and
128, so GPT-J-6B's 256 raises there as the kernels do), per-block
rematerialization through ``models._remat`` under the reference's three
policies (``"full"``, ``"dots"``, ``"attn"``), and the
fused cross-entropy with the lm head's bias (``ops.fused_ce``) when
``cfg.fused_loss``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_tpu_torch.device import materialize, resolve_device
from ray_tpu_torch.models._remat import check_policy, remat_block
from ray_tpu_torch.models.sampling import pick_tokens
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.fused_ce import fused_softmax_cross_entropy_bias
from ray_tpu_torch.parallel.sharding import local


@dataclasses.dataclass(frozen=True)
class GPTJConfig:
    vocab_size: int = 50400
    seq_len: int = 2048
    d_model: int = 4096
    n_layers: int = 28
    n_heads: int = 16
    rotary_dim: int = 64
    dtype: str = "bfloat16"
    #: the training path's options (``gptj_hidden``/``gptj_loss``), with the
    #: reference's defaults; serving ignores them
    remat: bool = True
    remat_policy: str = "full"
    attn_impl: str = "auto"
    fused_loss: bool = True
    ce_chunks: Optional[int] = None

    @property
    def d_ff(self) -> int:
        return 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


# GPT-J-6B checkpoint shape (HF ships vocab 50400)
GPTJ_6B = GPTJConfig()


def _layernorm(x, scale, bias):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    # jnp.var is the population variance
    var = x32.var(-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + 1e-5) * scale + bias
    return out.to(x.dtype)


class LayerNorm(nn.Module):
    """fp32 scale/bias; normalizes in fp32 and returns the input dtype."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        return _layernorm(x, self.scale, self.bias)


class GPTJBlock(nn.Module):
    def __init__(self, cfg: GPTJConfig, device=None):
        super().__init__()
        d, dff, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
        self.ln1 = LayerNorm(d, device)
        self.q = nn.Linear(d, d, bias=False, device=device, dtype=dt)
        self.k = nn.Linear(d, d, bias=False, device=device, dtype=dt)
        self.v = nn.Linear(d, d, bias=False, device=device, dtype=dt)
        self.attn_out = nn.Linear(d, d, bias=False, device=device, dtype=dt)
        self.mlp_in = nn.Linear(d, dff, device=device, dtype=dt)
        self.mlp_out = nn.Linear(dff, d, device=device, dtype=dt)

    def mlp(self, h):
        # jax.nn.gelu defaults to the tanh approximation
        return self.mlp_out(F.gelu(self.mlp_in(h), approximate="tanh"))


def embedding(num: int, dim: int, device=None, dtype=None) -> nn.Embedding:
    """An ``nn.Embedding`` whose weight is left uninitialised, as the model
    builders overwrite it. ``nn.Embedding``'s own N(0, 1) draw on the meta
    device goes through ``torch._refs``, whose first call imports
    ``torch._dynamo``: seconds in every fresh process that builds a model."""
    return nn.Embedding(num, dim, _weight=torch.empty(num, dim, device=device, dtype=dtype))


class GPTJ(nn.Module):
    """GPT-J parameters. Build it with ``gptj_init`` or ``params_from_jax``."""

    def __init__(self, cfg: GPTJConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.embed = embedding(cfg.vocab_size, d, device, cfg.torch_dtype)
        self.blocks = nn.ModuleList(GPTJBlock(cfg, device) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(d, device)
        self.lm_head = nn.Linear(d, cfg.vocab_size, device=device, dtype=torch.float32)

    def logits(self, h):
        """Final layernorm + fp32 lm head: (..., d) → (..., vocab) fp32."""
        return self.lm_head(self.ln_f(h).float())


def _empty_model(cfg: GPTJConfig, device) -> GPTJ:
    # built on the meta device first: nn.Linear's own init would otherwise
    # draw and then discard every weight of a multi-GB model
    return materialize(GPTJ(cfg, device="meta"), device).requires_grad_(False)


@torch.no_grad()
def gptj_init(cfg: GPTJConfig, generator: torch.Generator, device=None) -> GPTJ:
    """Random init in the reference's distribution (normal kernels scaled by
    fan_in^-0.5, embedding std 0.02, unit/zero layernorms, zero biases).
    ``device=None`` means the card (``resolve_device``); the draws are made
    there, so ``generator`` must live on that device type."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(
            f"generator is on {generator.device}, the model goes to {device}: "
            "give a generator on the model's device"
        )
    model = _empty_model(cfg, device)

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    for p in model.parameters():
        p.zero_()
    model.embed.weight.copy_(normal(model.embed.weight.shape, 0.02))
    for blk in model.blocks:
        blk.ln1.scale.fill_(1.0)
        for lin in (blk.q, blk.k, blk.v, blk.attn_out, blk.mlp_in, blk.mlp_out):
            out_f, in_f = lin.weight.shape
            lin.weight.copy_(normal((out_f, in_f), in_f**-0.5))
    model.ln_f.scale.fill_(1.0)
    model.lm_head.weight.copy_(normal(model.lm_head.weight.shape, cfg.d_model**-0.5))
    return model


@torch.no_grad()
def params_from_jax(tree: dict, cfg: GPTJConfig, device=None) -> GPTJ:
    """Carry a reference parameter tree over: nested dicts of numpy arrays
    with the stacked leading ``L`` axis and kernels laid out (in, out), as
    ``ray_tpu.models.gptj.gptj_init`` returns them (after
    ``jax.device_get``). ``device=None`` means the card
    (``resolve_device``)."""
    dev = resolve_device(device)
    model = _empty_model(cfg, dev)

    def put(dst, a, transpose=False):
        t = torch.tensor(np.asarray(a))
        dst.copy_((t.T if transpose else t).to(dev, dst.dtype))

    b = tree["blocks"]
    put(model.embed.weight, tree["embed"]["tokens"])
    for i, blk in enumerate(model.blocks):
        put(blk.ln1.scale, b["ln1"]["scale"][i])
        put(blk.ln1.bias, b["ln1"]["bias"][i])
        for name in ("q", "k", "v", "attn_out", "mlp_in", "mlp_out"):
            put(getattr(blk, name).weight, b[name]["kernel"][i], transpose=True)
        put(blk.mlp_in.bias, b["mlp_in"]["bias"][i])
        put(blk.mlp_out.bias, b["mlp_out"]["bias"][i])
    put(model.ln_f.scale, tree["ln_f"]["scale"])
    put(model.ln_f.bias, tree["ln_f"]["bias"])
    put(model.lm_head.weight, tree["lm_head"]["kernel"], transpose=True)
    put(model.lm_head.bias, tree["lm_head"]["bias"])
    return model


def _rotary_sincos(positions: torch.Tensor, rotary_dim: int):
    """GPT-J sinusoid table for given positions: (n, rotary_dim/2) each."""
    inv_freq = 1.0 / (
        10000.0
        ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=positions.device) / rotary_dim)
    )
    ang = positions.float()[:, None] * inv_freq[None, :]
    return torch.sin(ang), torch.cos(ang)


def _apply_rotary(x, sin, cos, rotary_dim: int):
    """Interleaved (rotate-every-two) rotary on the first ``rotary_dim``
    dims of ``x`` (..., hd), in fp32. ``sin``/``cos`` (…, rotary_dim/2)
    must broadcast against ``x``'s leading dims."""
    rot, pas = x[..., :rotary_dim], x[..., rotary_dim:]
    r = rot.float().unflatten(-1, (rotary_dim // 2, 2))
    x1, x2 = r[..., 0], r[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.flatten(-2).to(x.dtype)
    return torch.cat([out, pas], dim=-1) if pas.shape[-1] else out


def _project_qkv(cfg: GPTJConfig, h, layer: GPTJBlock, positions):
    """(q, k, v) heads with rotary applied: (b, heads, s, hd) each."""
    b, s, _ = h.shape

    def heads(t):
        return t.view(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)

    q, k, v = heads(layer.q(h)), heads(layer.k(h)), heads(layer.v(h))
    sin, cos = _rotary_sincos(positions, cfg.rotary_dim)
    return (
        _apply_rotary(q, sin, cos, cfg.rotary_dim),
        _apply_rotary(k, sin, cos, cfg.rotary_dim),
        v,
    )


def _block(cfg: GPTJConfig, x, layer: GPTJBlock, positions, impl: str = "xla"):
    """One GPT-J block: parallel attention + MLP over one layernorm.
    Returns the new hidden state and this block's rotated (k, v)."""
    b, s, d = x.shape
    h = layer.ln1(x)
    q, k, v = _project_qkv(cfg, h, layer, positions)
    att = causal_attention(q, k, v, impl=impl).transpose(1, 2).reshape(b, s, d)
    return x + layer.attn_out(att) + layer.mlp(h), k, v


@torch.no_grad()
def gptj_forward(cfg: GPTJConfig, params: GPTJ, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (b, s) int → logits (b, s, vocab) fp32."""
    x = params.embed(tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for layer in params.blocks:
        x, _, _ = _block(cfg, x, layer, positions)
    return params.logits(x)


# ---------------------------------------------------------------------------
# training path
# ---------------------------------------------------------------------------

#: the reference's GPT-J policies (``ray_tpu/models/gptj.py:168-174``)
REMAT_POLICIES = ("full", "dots", "attn")


def _whole(p):
    """A parameter gathered whole on every rank (``sharding.local`` over
    every axis); a plain tensor passes through."""
    return local(p, keep=())


def _on_mesh(layer: GPTJBlock):
    """The block's parameters gathered whole on this rank, as the block's
    calls see them. Built inside the block, so a rematerialized block
    gathers them again in the backward (ZeRO-3). GPT-J runs whole over tp
    in this slice (the tp-parallel block is ``models.gpt``'s)."""
    w = {n: _whole(getattr(layer, n).weight) for n in ("q", "k", "v", "attn_out", "mlp_in", "mlp_out")}
    scale, bias = _whole(layer.ln1.scale), _whole(layer.ln1.bias)
    b_in, b_out = _whole(layer.mlp_in.bias), _whole(layer.mlp_out.bias)
    return SimpleNamespace(
        ln1=lambda x: _layernorm(x, scale, bias),
        q=lambda h: F.linear(h, w["q"]), k=lambda h: F.linear(h, w["k"]), v=lambda h: F.linear(h, w["v"]),
        attn_out=lambda a: F.linear(a, w["attn_out"]),
        mlp=lambda h: F.linear(F.gelu(F.linear(h, w["mlp_in"], b_in), approximate="tanh"), w["mlp_out"], b_out),
    )


def _train_block(cfg: GPTJConfig, x, layer: GPTJBlock, positions, mesh=None):
    return _block(cfg, x, layer if mesh is None else _on_mesh(layer), positions, cfg.attn_impl)[0]


def gptj_hidden(cfg: GPTJConfig, params: GPTJ, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """tokens (b, s) int → final hidden (b, s, d) in the activation dtype,
    differentiable, each block checkpointed under ``cfg.remat_policy``
    (``models._remat``). With ``mesh`` (parameters sharded onto it by
    ``parallel.sharding.shard_params``) the tokens are this rank's batch
    slice, and each block gathers its parameters on use."""
    check_policy(cfg, REMAT_POLICIES)
    x = F.embedding(tokens, _whole(params.embed.weight))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for layer in params.blocks:
        x = remat_block(cfg, x, partial(_train_block, cfg, layer=layer, positions=positions, mesh=mesh))
    return _layernorm(x, _whole(params.ln_f.scale), _whole(params.ln_f.bias))


def gptj_loss(cfg: GPTJConfig, params: GPTJ, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy, mean over (b, s - 1). With
    ``cfg.fused_loss`` the (tokens, vocab) logits go through the fused
    cross-entropy with the lm head's bias, in ``cfg.ce_chunks`` chunks.
    With ``mesh``, the mean over this rank's batch slice."""
    hidden = gptj_hidden(cfg, params, tokens[:, :-1], mesh)
    targets = tokens[:, 1:]
    weight, bias = _whole(params.lm_head.weight), _whole(params.lm_head.bias)
    if cfg.fused_loss:
        b, s, d = hidden.shape
        losses = fused_softmax_cross_entropy_bias(
            hidden.reshape(b * s, d), weight.t(), bias, targets.reshape(-1), cfg.ce_chunks
        )
        return losses.mean()
    logits = hidden.float() @ weight.t() + bias
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


def _attend_cached(q1, k_cache, v_cache, length: int):
    """Single-position attention against a dense cache. q1: (b, h, hd);
    k/v_cache: (b, h, max, hd); ``length`` = valid prefix."""
    scale = q1.shape[-1] ** -0.5
    logits = torch.einsum("bhd,bhsd->bhs", q1.float(), k_cache.float()) * scale
    mask = torch.arange(k_cache.shape[2], device=q1.device)[None, None, :] < length
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", probs, v_cache.float())


@torch.no_grad()
def gptj_decode(cfg: GPTJConfig, params: GPTJ, prompt: torch.Tensor, n_new: int, *, key=None,
                temperature=0.0, top_k=0, top_p=1.0) -> torch.Tensor:
    """Decode ``n_new`` tokens after ``prompt`` (b, s0) → (b, s0 + n_new).
    The prompt's k/v come from one dense forward; each new token is a
    single-position pass over a dense per-call cache.

    Greedy by default (``key=None``). With an int ``key``, per-token
    temperature / top-k / top-p sampling via ``models.sampling.sample_tokens``
    (scalars or per-row tensors); step ``i`` keys off ``fold_in(key, i)``
    (``models.sampling.pick_tokens``)."""
    dt = cfg.torch_dtype
    b, s0 = prompt.shape
    dev = prompt.device
    max_len = s0 + n_new
    x = params.embed(prompt)
    caches = []
    for layer in params.blocks:
        x, k, v = _block(cfg, x, layer, torch.arange(s0, device=dev))
        kc = torch.zeros(b, cfg.n_heads, max_len, cfg.head_dim, dtype=dt, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :, :s0] = k
        vc[:, :, :s0] = v
        caches.append((kc, vc))
    tokens = torch.cat([prompt, torch.zeros(b, n_new, dtype=prompt.dtype, device=dev)], dim=1)
    tokens[:, s0] = pick_tokens(params.logits(x[:, -1]), key, 0, temperature, top_k, top_p)
    for i in range(n_new - 1):
        pos = s0 + i  # position of the token being FED
        x1 = params.embed(tokens[:, pos])  # (b, d)
        positions = torch.arange(pos, pos + 1, device=dev)
        for layer, (kc, vc) in zip(params.blocks, caches):
            h1 = layer.ln1(x1[:, None, :])
            q, k, v = _project_qkv(cfg, h1, layer, positions)
            kc[:, :, pos] = k[:, :, 0]
            vc[:, :, pos] = v[:, :, 0]
            att = _attend_cached(q[:, :, 0], kc, vc, pos + 1).to(dt)
            # (b, h, hd) merges h-major straight back to (b, d)
            x1 = x1 + layer.attn_out(att.reshape(b, cfg.d_model)) + layer.mlp(h1[:, 0])
        tokens[:, pos + 1] = pick_tokens(params.logits(x1), key, i + 1, temperature, top_k, top_p)
    return tokens
