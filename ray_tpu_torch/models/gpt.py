"""Decoder-only transformer (GPT family) for training and serving (port of
the dense path of ``ray_tpu/models/gpt.py``).

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
* ``gpt_loss`` feeds the final hidden state to the fused cross-entropy
  (``ops.fused_ce``) when ``cfg.fused_loss``.
* ``gpt_decode`` is the dense KV-cached decoder (greedy or sampled per
  token), the oracle the paged engine (``llm.model_runner``) is tested
  against and the GPT draft model's proposer (``llm.drafter``).

Rematerialization (``cfg.remat``) maps to ``torch.utils.checkpoint`` per
block: ``"full"`` recomputes the whole block in the backward (K3 runs again
there); ``"attn"`` checkpoints the pre-attention segment (ln1, qkv) and the
post-attention segment (out-projection, MLP) apart, with the flash op
between them, so K3 never runs again — it keeps q, k and v besides the
flash out and lse (the reference keeps only out and lse and recomputes the
qkv projection). The policies ``"dots"``, ``"attn_qkv"`` and ``"big"``,
mixture-of-experts (``n_experts > 0``) and ring attention are not ported
(ROADMAP.md) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models._remat import remat_block
from ray_tpu_torch.models.gptj import LayerNorm, _attend_cached
from ray_tpu_torch.models.sampling import pick_tokens
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.fused_ce import fused_softmax_cross_entropy

_PORTED_POLICIES = ("full", "attn")
_UNPORTED_POLICIES = ("dots", "attn_qkv", "big")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The reference's ``GPTConfig``, every field with its default.

    ``scan_unroll`` is accepted and has no effect: the reference unrolls its
    ``lax.scan`` over layers, and eager PyTorch runs the layers as a Python
    loop. ``n_experts > 0`` and ``attn_impl="ring"`` raise (ROADMAP.md)."""

    vocab_size: int = 50_304
    seq_len: int = 1024
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    dtype: str = "bfloat16"           # activation/compute dtype
    remat: bool = True
    #: "full" recomputes the whole block in the backward; "attn" keeps the
    #: flash op's inputs and outputs so the forward kernel never runs again
    remat_policy: str = "full"
    fused_loss: bool = True
    #: vocab chunk count for the fused loss (None = auto)
    ce_chunks: Optional[int] = None
    attn_impl: str = "auto"           # auto|xla|flash (ring: not ported)
    scan_unroll: int = 1
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
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "mixture-of-experts GPT (n_experts > 0) is not ported yet: ROADMAP.md, queue A"
        )
    if cfg.attn_impl == "ring":
        raise NotImplementedError(
            "ring attention (attn_impl='ring') is not ported yet: ROADMAP.md, queue A"
        )
    if cfg.remat and cfg.remat_policy not in _PORTED_POLICIES:
        if cfg.remat_policy in _UNPORTED_POLICIES:
            raise NotImplementedError(
                f"remat_policy={cfg.remat_policy!r} is not ported yet (ported: "
                f"{_PORTED_POLICIES}): ROADMAP.md, queue A"
            )
        raise ValueError(
            f"remat_policy must be one of {sorted(_PORTED_POLICIES + _UNPORTED_POLICIES)}, "
            f"got {cfg.remat_policy!r}"
        )


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        d, dff = cfg.d_model, cfg.d_ff
        self.ln1 = LayerNorm(d, device)
        self.attn_qkv = nn.Linear(d, 3 * d, device=device)
        self.attn_out = nn.Linear(d, d, device=device)
        self.ln2 = LayerNorm(d, device)
        self.mlp_in = nn.Linear(d, dff, device=device)
        self.mlp_out = nn.Linear(dff, d, device=device)


class GPT(nn.Module):
    """GPT parameters, fp32. Build it with ``gpt_init`` or
    ``params_from_jax``."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        d = cfg.d_model
        self.embed = nn.Embedding(cfg.vocab_size, d, device=device)
        self.pos_embed = nn.Embedding(cfg.seq_len, d, device=device)
        self.blocks = nn.ModuleList(GPTBlock(cfg, device) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(d, device)
        self.lm_head = nn.Linear(d, cfg.vocab_size, bias=False, device=device)


def _empty_model(cfg: GPTConfig, device) -> GPT:
    # built on the meta device first: nn.Linear's own init would otherwise
    # draw and then discard every weight
    return GPT(cfg, device="meta").to_empty(device=device)


@torch.no_grad()
def gpt_init(cfg: GPTConfig, generator: torch.Generator, device=None) -> GPT:
    """Random init in the reference's distributions: embeddings normal with
    std 0.02, kernels normal scaled by fan_in^-0.5, zero biases, unit/zero
    layernorms. ``device=None`` means the card (``resolve_device``); the
    draws are made there, so ``generator`` must live on that device type."""
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
        for lin in (blk.attn_qkv, blk.attn_out, blk.mlp_in, blk.mlp_out):
            normal(lin.weight, lin.in_features**-0.5)
    model.ln_f.scale.fill_(1.0)
    normal(model.lm_head.weight, cfg.d_model**-0.5)
    return model


_LINEARS = ("attn_qkv", "attn_out", "mlp_in", "mlp_out")


def _param_map(model: GPT):
    """Yields (module parameter, reference tree path, layer index or None,
    transposed) for every parameter of ``model``."""
    yield model.embed.weight, ("embed", "tokens"), None, False
    yield model.pos_embed.weight, ("embed", "pos"), None, False
    for i, blk in enumerate(model.blocks):
        for ln in ("ln1", "ln2"):
            yield getattr(blk, ln).scale, ("blocks", ln, "scale"), i, False
            yield getattr(blk, ln).bias, ("blocks", ln, "bias"), i, False
        for name in _LINEARS:
            lin = getattr(blk, name)
            yield lin.weight, ("blocks", name, "kernel"), i, True
            yield lin.bias, ("blocks", name, "bias"), i, False
    yield model.ln_f.scale, ("ln_f", "scale"), None, False
    yield model.ln_f.bias, ("ln_f", "bias"), None, False
    yield model.lm_head.weight, ("lm_head", "kernel"), None, True


@torch.no_grad()
def params_from_jax(tree: dict, cfg: GPTConfig, device=None) -> GPT:
    """Carry a reference parameter tree over: nested dicts of numpy arrays
    with the stacked leading ``L`` axis and kernels laid out (in, out), as
    ``ray_tpu.models.gpt.gpt_init`` returns them (after
    ``jax.device_get``). ``device=None`` means the card."""
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
    q, k, v = _linear(layer.ln1(x), layer.attn_qkv).split(d, dim=-1)

    def heads(t):
        return t.view(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)

    return heads(q), heads(k), heads(v)


def _attn_out_mlp(cfg: GPTConfig, x, att, layer: GPTBlock):
    """The out-projection's residual, then the MLP's."""
    b, s, d = x.shape
    x = x + _linear(att.transpose(1, 2).reshape(b, s, d), layer.attn_out)
    mid = F.gelu(_linear(layer.ln2(x), layer.mlp_in), approximate="tanh")
    return x + _linear(mid, layer.mlp_out)


def _block(cfg: GPTConfig, x, layer: GPTBlock):
    q, k, v = _attn_in(cfg, x, layer)
    att = causal_attention(q, k, v, impl=cfg.attn_impl)
    return _attn_out_mlp(cfg, x, att, layer)


def gpt_hidden(cfg: GPTConfig, params: GPT, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (batch, seq) int → final hidden (batch, seq, d_model) in the
    activation dtype. The lm head is applied by the caller."""
    _check_supported(cfg)
    dt = cfg.torch_dtype
    s = tokens.shape[1]
    # gather fp32 rows, then cast
    x = F.embedding(tokens, params.embed.weight).to(dt)
    x = x + params.pos_embed.weight[:s].to(dt)
    for layer in params.blocks:
        x = remat_block(
            cfg,
            x,
            partial(_block, cfg, layer=layer),
            partial(_attn_in, cfg, layer=layer),
            partial(_attn_out_mlp, cfg, layer=layer),
        )
    return params.ln_f(x)


def gpt_forward(cfg: GPTConfig, params: GPT, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (batch, seq) int → logits (batch, seq, vocab) fp32."""
    return gpt_hidden(cfg, params, tokens).float() @ params.lm_head.weight.t()


def gpt_loss(cfg: GPTConfig, params: GPT, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy, mean over (batch, seq - 1). With
    ``cfg.fused_loss`` the (tokens, vocab) logits go through the fused
    cross-entropy in ``cfg.ce_chunks`` vocab chunks."""
    hidden = gpt_hidden(cfg, params, tokens[:, :-1])
    targets = tokens[:, 1:]
    if cfg.fused_loss:
        b, s, d = hidden.shape
        losses = fused_softmax_cross_entropy(
            hidden.reshape(b * s, d), params.lm_head.weight.t(), targets.reshape(-1), cfg.ce_chunks
        )
        return losses.mean()
    logits = hidden.float() @ params.lm_head.weight.t()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


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
        x = _attn_out_mlp(cfg, x, causal_attention(q, k, v, impl="xla"), layer)
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
            x1 = _attn_out_mlp(cfg, x1, att, layer)
        tokens[:, pos + 1] = pick_tokens(logits(x1[:, 0]), key, i + 1, temperature, top_k, top_p)
    return tokens
