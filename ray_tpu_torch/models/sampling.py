"""Per-token sampling for the decode paths (port of ``ray_tpu/models/sampling.py``).

Greedy / temperature / top-k / top-p over a batch of next-token logit
rows, every knob a scalar or a per-row tensor (one continuous-batching
decode step mixes requests with different sampling params).
``temperature <= 0`` means greedy (argmax) for that row.

Randomness is keyed by (seed, absolute output index), as in the
reference: the token at output index ``i`` of a request depends only on
``(seed, i, prefix)`` — never on the slot, the step or a preemption — so
a preempted or failed-over request resumes token-identically. Each
sampled row gets its own CPU ``torch.Generator`` seeded from a 64-bit mix
of ``(seed & 0xFFFFFFFF, index)`` (``row_generator``); the row's Gumbel
noise is drawn from it on the host (``gumbel_noise``), so a given
(seed, index, logits) picks the same token on every device. The
reference's ``jax.random``
bits cannot be reproduced, so sampled tokens match the reference in
distribution, not token for token; greedy tokens match exactly.

Logprob convention (the reference's RLHF behavior-policy contract):
sampled rows report ``log_softmax`` of the filtered (temperature-scaled,
top-k/top-p masked) logits at the chosen id, greedy rows ``log_softmax``
of the raw logits at the argmax. ``token_logprobs`` scores given ids in
the same units.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_NEG_INF = -1e30
_MASK64 = (1 << 64) - 1


def _mix64(seed: int, counter: int) -> int:
    """splitmix64 finalizer over (seed32 << 32 | counter32)."""
    z = (((seed & 0xFFFFFFFF) << 32) | (counter & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def row_generator(seed: int, counter: int) -> torch.Generator:
    """The generator that draws output index ``counter`` of a request with
    sampling seed ``seed``."""
    return torch.Generator().manual_seed(_mix64(int(seed), int(counter)))


def _filtered_logits(logits, temp, kk, pp):
    """Temperature-scaled logits with top-k/top-p support masked to
    ``_NEG_INF``. logits: (b, v) fp32; temp/kk/pp: (b,) tensors."""
    b, v = logits.shape
    scaled = logits / temp.clamp_min(1e-6)[:, None]
    # one descending sort serves both truncations: rank < k for top-k,
    # exclusive cumulative mass < p for top-p (rank 0 always survives).
    # jnp.argsort is stable; torch's is only when asked
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_scaled = scaled.gather(-1, order)
    ranks = torch.arange(v, device=logits.device)[None, :]
    probs = torch.softmax(sorted_scaled, dim=-1)
    cum = probs.cumsum(-1)
    keep = (kk[:, None] <= 0) | (ranks < kk[:, None])
    keep &= (cum - probs) < pp[:, None]
    masked_sorted = torch.where(keep, sorted_scaled, _NEG_INF)
    # scatter the surviving logits back to vocab order
    return torch.full_like(scaled, _NEG_INF).scatter(-1, order, masked_sorted)


def _broadcast_knobs(b, temperature, top_k, top_p, device):
    def knob(x, dtype):
        return torch.broadcast_to(torch.as_tensor(x, dtype=dtype, device=device), (b,))

    return knob(temperature, torch.float32), knob(top_k, torch.int64), knob(top_p, torch.float32)


def _chosen_logprob(logits, masked, temp, tok):
    """Module-doc logprob convention: sampled rows score under the
    filtered distribution they drew from, greedy rows under the raw
    logits."""
    idx = tok[:, None]
    lp_sampled = torch.log_softmax(masked, dim=-1).gather(-1, idx)[:, 0]
    lp_greedy = torch.log_softmax(logits, dim=-1).gather(-1, idx)[:, 0]
    return torch.where(temp > 0.0, lp_sampled, lp_greedy)


def gumbel_noise(generators: Sequence[Optional[torch.Generator]], v: int, device) -> torch.Tensor:
    """(b, v) standard Gumbel noise on ``device``, row i drawn on the host
    from ``generators[i]`` (``row_generator``). A ``None`` generator (a
    greedy row) gets zeros made on the device, so an all-greedy batch does
    no host work and copies nothing. The sampled rows are copied from pinned
    memory without waiting for the device, so a decode step draws its noise
    before it queues its layers."""
    noise = torch.zeros(len(generators), v, device=device)
    rows = [i for i, g in enumerate(generators) if g is not None]
    if rows:
        tiny = torch.finfo(torch.float32).tiny
        u = torch.stack([torch.rand(v, generator=generators[i]) for i in rows]).clamp_(min=tiny)
        host = -torch.log(-torch.log(u))
        if noise.is_cuda:
            host = host.pin_memory()
        noise[rows] = host.to(noise.device, non_blocking=True)
    return noise


def sample_tokens_logprobs(
    logits: torch.Tensor,
    noise: torch.Tensor,
    temperature=0.0,
    top_k=0,
    top_p=1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample one token id per row and return its logprob (module doc).

    logits (b, v) → (tokens (b,) int64, logprobs (b,) fp32). ``noise`` is
    the rows' (b, v) Gumbel noise (``gumbel_noise``); greedy rows ignore
    theirs. ``top_k <= 0`` disables the k-truncation, ``top_p >= 1`` the
    nucleus truncation."""
    logits = logits.float()
    b, v = logits.shape
    temp, kk, pp = _broadcast_knobs(b, temperature, top_k, top_p, logits.device)
    greedy = logits.argmax(-1)
    masked = _filtered_logits(logits, temp, kk, pp)
    # Gumbel-max: argmax(masked + Gumbel) is a draw from softmax(masked),
    # the same construction jax.random.categorical uses
    sampled = (masked + noise).argmax(-1)
    tok = torch.where(temp > 0.0, sampled, greedy)
    return tok, _chosen_logprob(logits, masked, temp, tok)


def token_logprobs(
    logits: torch.Tensor, tokens: torch.Tensor, temperature=0.0, top_k=0, top_p=1.0
) -> torch.Tensor:
    """Score GIVEN token ids under the exact sampling distribution:
    (b, v) logits + (b,) ids → (b,) fp32 logprobs, same convention as
    ``sample_tokens_logprobs``."""
    logits = logits.float()
    b, _ = logits.shape
    temp, kk, pp = _broadcast_knobs(b, temperature, top_k, top_p, logits.device)
    masked = _filtered_logits(logits, temp, kk, pp)
    return _chosen_logprob(logits, masked, temp, tokens.long())
