"""Plain causal multi-head attention (port of ``ray_tpu/ops/attention.py``).

Only the einsum path (the reference's ``_xla_attention``) is ported: the
dense GPT-J forward and its decode oracle use it, and serving prefill runs
paged attention instead. The flash kernel belongs to the training slice
(ROADMAP.md).
"""

from __future__ import annotations

import torch


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (batch, heads, seq, head_dim) → (batch, heads, seq, head_dim).

    fp32 logits and softmax; the probabilities are cast back to ``q.dtype``
    before the PV product, as the reference does."""
    seq, head_dim = q.shape[-2:]
    scale = 1.0 / (head_dim**0.5)
    # bf16 × bf16 products are exact in fp32, so upcasting first equals the
    # reference's preferred_element_type=float32 einsum
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
