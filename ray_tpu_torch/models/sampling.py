"""Per-token sampling for the decode paths (port of ``ray_tpu/models/sampling.py``).

Greedy / temperature / top-k / top-p over a batch of next-token logit
rows, every knob a scalar or a per-row tensor (one continuous-batching
decode step mixes requests with different sampling params), and the
speculative-decode verification of drafted windows
(``speculative_verify``). ``temperature <= 0`` means greedy (argmax) for
that row.

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


def fold_in(key: int, data: int) -> int:
    """A new 32-bit key from ``key`` and ``data`` (the role of
    ``jax.random.fold_in``): the dense decoders key step ``i`` of a call
    with ``fold_in(key, i)``."""
    return _mix64(int(key), int(data)) & 0xFFFFFFFF


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


def sample_tokens(logits: torch.Tensor, key: int, temperature=0.0, top_k=0, top_p=1.0) -> torch.Tensor:
    """Sample one token id per row: (b, v) logits → (b,) int64.

    ``temperature``/``top_k``/``top_p`` are scalars or (b,) tensors.
    ``top_k <= 0`` disables the k-truncation; ``top_p >= 1`` the nucleus
    truncation; ``temperature <= 0`` selects greedy argmax for that row.
    ``key`` is one int key for the whole call: row ``i`` draws from
    ``row_generator(key, i)``, so the same (key, row) pair always
    reproduces (the reference splits its one PRNG key per row). Reads the
    temperatures on the host to draw noise for the sampled rows only."""
    b, v = logits.shape
    temps = torch.broadcast_to(torch.as_tensor(temperature, dtype=torch.float32).cpu(), (b,))
    gens = [row_generator(key, i) if t > 0 else None for i, t in enumerate(temps.tolist())]
    noise = gumbel_noise(gens, v, logits.device)
    return sample_tokens_logprobs(logits, noise, temperature, top_k, top_p)[0]


def pick_tokens(logits: torch.Tensor, key, step: int, temperature=0.0, top_k=0, top_p=1.0) -> torch.Tensor:
    """The dense decoders' choice at ``step`` of a call: greedy argmax when
    ``key`` is None, else ``sample_tokens`` keyed ``fold_in(key, step)``, so
    a continuation from any prefix reproduces."""
    if key is None:
        return logits.argmax(-1)
    return sample_tokens(logits, fold_in(key, step), temperature, top_k, top_p)


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


def speculative_verify_logprobs(
    logits: torch.Tensor,
    draft: torch.Tensor,
    noise: torch.Tensor,
    temperature=0.0,
    top_k=0,
    top_p=1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``speculative_verify`` that also returns (slots, w) logprobs of the
    emitted tokens: window index ``i``'s entry scores ``out[:, i]`` under
    the exact per-index filtered distribution (the ``sample_tokens_logprobs``
    convention), so spec-decode output carries the same behavior logprobs
    as the plain decode path. Validity mirrors ``out``: entries past
    ``n_accepted`` are conditioned on a rejected prefix and are discarded
    with their tokens.

    Batched over slots (the reference vmaps its per-sequence version):
    logits (slots, w, v); draft (slots, w-1); noise (slots, w, v), window
    index ``i`` of a slot drawn from ``row_generator(seed, counter + i)``;
    the knobs are scalars or (slots,) tensors, shared by a slot's window.
    Returns (n_accepted (slots,), out (slots, w), logprobs (slots, w))."""
    logits = logits.float()
    s, w, v = logits.shape
    temp, kk, pp = _broadcast_knobs(s, temperature, top_k, top_p, logits.device)
    tok, logp = sample_tokens_logprobs(
        logits.reshape(s * w, v),
        noise.reshape(s * w, v),
        temp.repeat_interleave(w),
        kk.repeat_interleave(w),
        pp.repeat_interleave(w),
    )
    out, logp = tok.view(s, w), logp.view(s, w)
    # the accepted prefix: the leading run of draft[i] == out[i]; an empty
    # draft (w == 1) sums to 0, the window then being just the bonus position
    accept = draft.to(out.device, out.dtype) == out[:, : w - 1]
    n_acc = accept.long().cumprod(-1).sum(-1)
    return n_acc, out, logp


def speculative_verify(
    logits: torch.Tensor,
    draft: torch.Tensor,
    noise: torch.Tensor,
    temperature=0.0,
    top_k=0,
    top_p=1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Accept/reject each slot's drafted window against target logits.

    ``logits``: (slots, w, vocab), the target model's logits at each
    window's w positions (position i conditioned on the draft tokens
    before it); ``draft``: (slots, w-1), the drafter's proposals;
    ``noise``: (slots, w, vocab) Gumbel noise, window index i of a slot
    drawn from ``row_generator(seed, counter + i)`` where ``counter`` is
    the output index of the window's FIRST token.

    Sample-then-match (as in the reference): window index i draws
    ``out[i]`` with the same generator AND filtered distribution the plain
    decode path's per-row sampler uses at that output index, then the
    drafted prefix is accepted while ``draft[i] == out[i]``. ``out[i]`` is
    only CONDITIONALLY valid: its logits assumed the draft prefix before
    it, which holds exactly up through the first mismatch, so callers emit
    ``out[:n_accepted + 1]`` (accepted prefix + one correction/bonus token)
    and ignore the rest.

    Greedy (``temperature <= 0``) accepts while ``draft[i] == argmax``: the
    emitted chain is exactly the sequential argmax chain. Either way the
    emitted token at output index i depends only on (seed, i, prefix):
    identical to non-speculative decode, whatever the drafter proposed and
    wherever the window boundaries fell."""
    n_acc, out, _ = speculative_verify_logprobs(logits, draft, noise, temperature, top_k, top_p)
    return n_acc, out
