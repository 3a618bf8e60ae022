"""Causal multi-head attention — impl dispatcher (port of
``ray_tpu/ops/attention.py``).

Two interchangeable paths behind one signature:

* ``xla``   — einsum + masked softmax (the reference's ``_xla_attention``);
  O(seq²) memory. The dense GPT-J forward and its decode oracle use it.
* ``flash`` — blockwise online softmax with the flash backward
  (``ops/flash_attention.py``): the hand-written kernels K3-K5 on the card,
  their plain versions on the CPU.

``auto`` takes flash for CUDA tensors and the einsum for CPU tensors, the
reference's own choice off the TPU. The flash kernels mask a ragged sequence
edge themselves, so on the card ``auto`` never falls back to the einsum: a
head dim the kernels lack raises. The reference's ``ring`` path
(sequence-parallel over a mesh) is not ported (ROADMAP.md).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.flash_attention import flash_attention


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 logits and softmax; the probabilities are cast back to
    ``q.dtype`` before the PV product, as the reference does."""
    seq, head_dim = q.shape[-2:]
    scale = 1.0 / (head_dim**0.5)
    # bf16 × bf16 products are exact in fp32, so upcasting first equals the
    # reference's preferred_element_type=float32 einsum
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, impl: str = "auto"
) -> torch.Tensor:
    """q, k, v: (batch, heads, seq, head_dim) → (batch, heads, seq,
    head_dim). ``impl``: auto | xla | flash."""
    if impl not in ("auto", "xla", "flash"):
        raise ValueError(
            f"unknown attention impl {impl!r}; expected 'auto', 'xla' or 'flash' "
            "(ring attention is not ported: ROADMAP.md)"
        )
    if impl == "xla" or (impl == "auto" and not q.is_cuda):
        return _xla_attention(q, k, v)
    return flash_attention(q, k, v)
