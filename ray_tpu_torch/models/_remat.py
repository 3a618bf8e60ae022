"""Per-block rematerialization, shared by the training paths of
``models.gpt`` and ``models.gptj``.

``cfg.remat`` maps to ``torch.utils.checkpoint``: ``"full"`` recomputes the
whole block in the backward (the attention forward runs again there);
``"attn"`` checkpoints the pre-attention segment and the post-attention
segment apart, with the attention op between them, so its saved tensors
stand in for a second forward.
"""

from __future__ import annotations

from typing import Callable

from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import causal_attention


def _checkpoint(fn, *args):
    # the blocks draw no random numbers: no RNG state to stash and restore
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def remat_block(cfg, x, block: Callable, attn_in: Callable, attn_out_mlp: Callable):
    """One block's output under ``cfg.remat`` and ``cfg.remat_policy``
    (``"full"`` or ``"attn"``; the caller has refused the others).
    ``block(x)`` is the whole block, ``attn_in(x)`` gives ``(q, k, v)`` and
    ``attn_out_mlp(x, att)`` the block's output from the attention's. Each
    is bound to its layer already (``functools.partial``, not a closure over
    a loop variable: the backward calls them again after the loop)."""
    if not cfg.remat:
        return block(x)
    if cfg.remat_policy == "full":
        return _checkpoint(block, x)
    q, k, v = _checkpoint(attn_in, x)
    att = causal_attention(q, k, v, impl=cfg.attn_impl)
    return _checkpoint(attn_out_mlp, x, att)
