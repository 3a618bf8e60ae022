"""Per-block rematerialization, shared by the training paths of
``models.gpt`` and ``models.gptj``.

``cfg.remat`` checkpoints each block with ``torch.utils.checkpoint``, and
``cfg.remat_policy`` says what the block keeps for the backward, as the
reference's policies do (``ray_tpu/models/gpt.py:260-281``); the rest is
recomputed there:

* ``"full"`` keeps nothing: the whole block, the attention forward
  included, runs again in the backward;
* ``"dots"`` keeps the outputs of the matrix products (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``) and recomputes the rest, the attention forward
  included;
* ``"attn"`` keeps the flash forward's out and lse, so K3 never runs again,
  and recomputes ln1 and the qkv projection that the flash backward needs;
* ``"attn_qkv"`` keeps the qkv projection as well (the recompute runs ln1
  for the projection's weight gradient, not the product);
* ``"big"`` keeps the flash out and lse and the gelu output ``mlp_mid``.

``"dots"`` is a selective checkpoint: a policy sees every operator the
block dispatches, which costs host time on each. The other three keep
named outputs (``ops.flash_attention.KeptOutputs``): the producers the
reference names (``checkpoint_name``) — the flash forward, ``kept_linear``
for "qkv", ``kept_gelu`` for "mlp_mid" — keep their value on the block's
first run and hand it back on the recompute, which still runs every other
operator in order. On the einsum attention (``attn_impl="xla"``) no flash
op runs, so ``"attn"`` keeps nothing, as the reference's does there.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ray_tpu_torch.ops.flash_attention import KeptOutputs, keep_outputs, keeps, kept

_aten = torch.ops.aten
_MATMULS = frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                      _aten.baddbmm.default})
#: the named outputs each of the other policies keeps
_KEEPS = {
    "attn": ("flash",),
    "attn_qkv": ("flash", "qkv"),
    "big": ("flash", "mlp_mid"),
}
POLICIES = ("full", "dots", *_KEEPS)


def _keep_products(ctx, op, *args, **kwargs):
    """"dots": keep every matrix product's output."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def check_policy(cfg, allowed=POLICIES) -> None:
    if cfg.remat and cfg.remat_policy not in allowed:
        raise ValueError(f"remat_policy must be one of {sorted(allowed)}, got {cfg.remat_policy!r}")


def _keeping(store: KeptOutputs, block: Callable):
    def run(x):
        with keep_outputs(store):
            return block(x)

    return run


def remat_block(cfg, x, block: Callable):
    """``block(x)`` under ``cfg.remat`` and ``cfg.remat_policy`` (checked
    by the caller). ``block`` is bound to its layer already
    (``functools.partial``, not a closure over a loop variable: the
    backward calls it again after the loop). With grad off there is no
    backward to recompute for, so the block runs plain (and the first
    ``checkpoint`` call's import of ``torch._dynamo``, seconds in a fresh
    process, is not paid for a forward)."""
    if not cfg.remat or not torch.is_grad_enabled():
        return block(x)
    policy = cfg.remat_policy
    # the blocks draw no random numbers: no RNG state to stash and restore
    if policy == "full":
        return checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        context = functools.partial(create_selective_checkpoint_contexts, _keep_products)
        return checkpoint(block, x, use_reentrant=False, preserve_rng_state=False, context_fn=context)
    # a store for this call of the block only: its forward and recompute
    store = KeptOutputs(_KEEPS[policy])
    return checkpoint(_keeping(store, block), x, use_reentrant=False, preserve_rng_state=False)


class _KeptLinear(torch.autograd.Function):
    """``F.linear`` whose output a segment may keep: on the recompute the
    product is not computed again, and the backward is the linear's, from
    the input and weight the recompute saved."""

    @staticmethod
    def forward(ctx, x, w, b, name):
        out, replayed = kept(name, lambda: F.linear(x, w, b))
        ctx.save_for_backward(x, w)
        return out.detach() if replayed else out

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        # as aten's addmm backward: grad @ w, (x^T @ grad)^T, the rows' sum
        dx = g.mm(w).view(x.shape)
        dw = x.reshape(-1, x.shape[-1]).t().mm(g).t()
        return dx, dw, g.sum(0), None


class _KeptGelu(torch.autograd.Function):
    """The tanh-approximate gelu whose output a segment may keep: on the
    recompute the kept output stands in, and the backward reads the input
    the recompute produced."""

    @staticmethod
    def forward(ctx, pre, name):
        out, replayed = kept(name, lambda: F.gelu(pre, approximate="tanh"))
        ctx.save_for_backward(pre)
        return out.detach() if replayed else out

    @staticmethod
    def backward(ctx, grad):
        (pre,) = ctx.saved_tensors
        return _aten.gelu_backward(grad, pre, approximate="tanh"), None


def kept_linear(x, w, b, name: str):
    """``F.linear(x, w, b)``, kept under ``name`` when the current block's
    policy keeps it (the reference's ``checkpoint_name``)."""
    if keeps(name):
        return _KeptLinear.apply(x, w, b, name)
    return F.linear(x, w, b)


def kept_gelu(pre, name: str):
    """The tanh-approximate gelu of ``pre``, kept under ``name`` when the
    current block's policy keeps it."""
    if keeps(name):
        return _KeptGelu.apply(pre, name)
    return F.gelu(pre, approximate="tanh")
