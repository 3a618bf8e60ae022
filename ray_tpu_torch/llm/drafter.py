"""Draft-token proposers for speculative decoding (port of
``ray_tpu/llm/drafter.py``).

A drafter guesses the next ``k`` tokens of every running sequence; the
engine verifies all of them (plus one bonus position) in ONE target-model
call (``model_runner.verify_step``). Drafters only affect THROUGHPUT, never
output: verification accepts exactly the tokens the target model would
have produced (greedy) or an exact sample from its distribution
(``models.sampling.speculative_verify``), so a bad draft just lowers the
acceptance rate.

Two built-ins:

* ``NGramDrafter`` — model-free prompt lookup: match the longest recent
  n-gram of (prompt + generated history) against an earlier occurrence
  and propose the tokens that followed it. Host-side numpy/lists, no
  device work; very effective on repetitive or structured text — code,
  templated output, and self-repeating greedy continuations — where the
  future literally already appeared. A copy of the reference's.
* ``SmallModelDrafter`` — a small GPT or GPT-J proposes greedily with the
  port's ``gpt_decode`` or ``gptj_decode`` on its parameters' device. Fixed
  shapes: ``(slots, ctx_window)`` prompts decoding ``k`` tokens. Contexts are truncated to
  the last ``ctx_window`` tokens and left-padded with 0 when shorter —
  padding skews short-context drafts (draft QUALITY only; verification
  keeps the output exact).

Both expose ``propose(contexts) -> (n, k) int32`` where ``contexts`` is
a list of token-id lists (prompt + generated so far, most recent last).
Proposals are deterministic functions of the context, so re-drafting
after recompute preemption reproduces.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ray_tpu_torch.models.gpt import GPTConfig, gpt_decode
from ray_tpu_torch.models.gptj import GPTJConfig, gptj_decode


class NGramDrafter:
    """Prompt-lookup drafting (model-free).

    For each context, the longest suffix n-gram (``max_ngram`` down to 1)
    is searched for a strictly-earlier occurrence; the ``k`` tokens that
    followed that occurrence become the proposal. When the continuation
    runs off the end of the context (a match near the tail — the periodic
    case this drafter shines on), the proposal extends itself, which
    continues the period. No match anywhere: propose the last token
    repeated (cheap, and correct for degenerate single-token loops).

    Cross-request prefix awareness: the engine points ``corpus`` at
    ``PrefixCache.paths`` — a bounded list of recently-used radix paths
    (other requests' cached prompt prefixes). A context whose local
    lookup finds no confident match re-runs the n-gram search over those
    shared paths: chat traffic repeats across requests at least as much
    as within one, so the future a local scan can't see often sits on a
    path some OTHER request already prefilled. Corpus matches require
    n >= 2 (a lone cross-request token is pure noise) and report
    confident; drafts remain throughput-only — verification keeps the
    output exact whatever the corpus proposes.

    ``last_matched`` records, per context of the latest ``propose`` call,
    whether a CONFIDENT match backed the proposal: an n-gram of length
    >= 2, or a single-token match immediately adjacent to the tail (the
    last two tokens equal — a genuine repeat loop). A lone token
    recurring somewhere far back is noise in anything resembling natural
    text (in a random-token stream it fires with probability ~len/vocab
    and its drafts essentially never verify), and the repeat-last
    fallback is a guess, not evidence — both report unmatched. The
    engine uses the flag as the drafter's confidence signal: when NO
    running slot has a confident proposal it skips the multi-token
    verification step entirely and plain-decodes — which bounds the
    regression on hostile (low-match) workloads at the drafting cost,
    host-side, instead of paying a doomed ``w``-wide verify to learn what
    the drafter already knew.
    """

    def __init__(self, k: int, max_ngram: int = 3, scan_window: int = 1024):
        if k < 1 or max_ngram < 1 or scan_window < 2:
            raise ValueError("k and max_ngram must be >= 1, scan_window >= 2")
        self.k = k
        self.max_ngram = max_ngram
        #: cap on how much recent context the per-step scan walks — the
        #: engine drafts EVERY step under its lock, so an unbounded scan
        #: would make per-step host work grow with sequence length
        #: (O(L^2) over a generation). Matches beyond the window are
        #: lost (acceptable: drafts are throughput-only) in exchange for
        #: a constant per-step bound.
        self.scan_window = scan_window
        self.last_matched = np.zeros(0, bool)
        #: optional zero-arg callable returning a list of token sequences
        #: to extend the lookup across requests (the engine wires
        #: ``PrefixCache.paths`` here)
        self.corpus = None

    def _local_match(self, ctx: list) -> tuple[list[int], bool]:
        n_ctx = len(ctx)
        for n in range(min(self.max_ngram, n_ctx - 1), 0, -1):
            pat = list(ctx[-n:])
            # rightmost occurrence strictly before the suffix itself
            for pos in range(n_ctx - n - 1, -1, -1):
                if list(ctx[pos : pos + n]) == pat:
                    ext = list(ctx)
                    out = []
                    cur = pos + n
                    for _ in range(self.k):
                        tok = ext[cur]
                        out.append(tok)
                        ext.append(tok)
                        cur += 1
                    confident = n >= 2 or pos == n_ctx - 2
                    return out, confident
        return [int(ctx[-1])] * self.k, False

    def _corpus_match(self, ctx: list, corpus: list) -> list:
        """Rightmost n-gram match (n >= 2 only — cross-request single
        tokens are noise) over the shared radix paths; returns the k-token
        continuation or None. Continuations running off a path's end
        self-extend periodically, same as the local scan."""
        n_ctx = len(ctx)
        for n in range(min(self.max_ngram, n_ctx), 1, -1):
            pat = list(ctx[-n:])
            for seq in corpus:
                seq = list(seq[-self.scan_window :])
                for pos in range(len(seq) - n - 1, -1, -1):
                    if seq[pos : pos + n] == pat:
                        ext = list(seq)
                        out = []
                        cur = pos + n
                        for _ in range(self.k):
                            tok = ext[cur]
                            out.append(int(tok))
                            ext.append(tok)
                            cur += 1
                        return out
        return None

    def _propose_one(self, ctx: Sequence[int], corpus_fn=None) -> tuple[list[int], bool]:
        ctx = list(ctx[-self.scan_window :])
        out, confident = self._local_match(ctx)
        if confident:
            return out, True
        if corpus_fn is not None:
            shared = self._corpus_match(ctx, corpus_fn())
            if shared is not None:
                return shared, True
        return out, confident

    def propose(self, contexts: list[Sequence[int]]) -> np.ndarray:
        # the corpus (PrefixCache.paths: lock + tree walk) is fetched
        # LAZILY, once, and only if some row's local match is
        # unconfident — propose runs every decode step under the engine
        # lock, and steady-state repetitive decode (all rows locally
        # confident) must not pay the cache walk at all
        fetched: list = []

        def corpus_fn():
            if not fetched:
                fetched.append(self.corpus() or [])
            return fetched[0]

        fn = corpus_fn if self.corpus is not None else None
        rows = [self._propose_one(c, fn) for c in contexts]
        self.last_matched = np.asarray([m for _, m in rows], bool)
        return np.asarray([p for p, _ in rows], np.int32).reshape(len(contexts), self.k)


class SmallModelDrafter:
    """Greedy ``k``-token proposals from a small KV-cached draft model.

    ``model_cfg``/``params`` are a ``models.gpt`` or ``models.gptj`` config
    and its parameters (``GPT`` or ``GPTJ``; typically a much smaller model
    than the target); the drafter runs on the parameters' device. ``slots``
    fixes the batch dimension — callers pass the engine's ``max_slots`` and
    may propose for fewer contexts (the batch is padded; padded rows cost
    compute only). A GPT draft model's positional table must hold
    ``ctx_window + k`` positions."""

    def __init__(self, model_cfg, params, k: int, slots: int, ctx_window: int = 16):
        if k < 1 or slots < 1 or ctx_window < 1:
            raise ValueError("k, slots and ctx_window must be >= 1")
        if isinstance(model_cfg, GPTJConfig):
            self._decode = gptj_decode
        elif isinstance(model_cfg, GPTConfig):
            self._decode = gpt_decode
            if ctx_window + k > model_cfg.seq_len:
                raise ValueError(
                    f"ctx_window ({ctx_window}) + k ({k}) exceeds the draft "
                    f"model's positional table (seq_len={model_cfg.seq_len})"
                )
        else:
            raise TypeError(f"unsupported draft model config {type(model_cfg).__name__}")
        self.cfg = model_cfg
        self.k = k
        self.slots = slots
        self.ctx_window = ctx_window
        self._params = params
        self.device = params.lm_head.weight.device

    def propose(self, contexts: list[Sequence[int]]) -> np.ndarray:
        if len(contexts) > self.slots:
            raise ValueError(f"{len(contexts)} contexts > drafter batch of {self.slots}")
        W = self.ctx_window
        batch = np.zeros((self.slots, W), np.int64)
        for i, ctx in enumerate(contexts):
            tail = list(ctx[-W:])
            batch[i, W - len(tail) :] = tail
        tokens = torch.from_numpy(batch).to(self.device)
        out = self._decode(self.cfg, self._params, tokens, self.k)  # (slots, W + k)
        return out[: len(contexts), W:].cpu().numpy().astype(np.int32)


def make_drafter(
    kind: str,
    k: int,
    slots: int,
    *,
    ngram_max: int = 3,
    draft_cfg=None,
    draft_params=None,
    draft_ctx: int = 16,
):
    """Engine-facing factory: ``kind`` is 'ngram' or 'model'."""
    if kind == "ngram":
        return NGramDrafter(k, max_ngram=ngram_max)
    if kind == "model":
        if draft_cfg is None or draft_params is None:
            raise ValueError(
                "drafter='model' needs draft_model_cfg and draft_params "
                "(a small gpt/gptj config + parameter pytree)"
            )
        return SmallModelDrafter(draft_cfg, draft_params, k, slots, ctx_window=draft_ctx)
    raise ValueError(f"unknown drafter {kind!r}; expected 'ngram' or 'model'")
