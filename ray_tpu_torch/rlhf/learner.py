"""The learning half of the async RLHF loop: a GPT policy hosted in the
existing ``rl.learner`` machinery (port of ``ray_tpu/rlhf/learner.py``).

Reuse, not reinvention: ``rl.learner.Learner`` already owns the
optimizer, grad clipping, the device, and the local-vs-remote-actor
placement (``LearnerGroup``). This module only supplies what RL-on-LLM
changes — the module (a decoder-only GPT whose ``init`` is exactly the
rollout engines' init, ``gpt_init`` from a generator seeded alike on the
same device type, so version 0 means the same weights everywhere) and the
loss (a PPO/GRPO-style clipped surrogate over TOKENS with off-policy
importance correction).

The correction is the heart of the async design: trajectories were
sampled by engines running version ``v_behind``, the learner is at
``v_now``. Each token carries the behavior logprob captured AT SAMPLE
TIME (``models.sampling`` logprob convention), the loss recomputes the
current-policy logprob of the same token through ``gpt_forward`` and
``token_logprobs`` under the SAME sampling knobs, and ``ratio = exp(cur -
behavior)`` is then an exact density ratio — clipped a la PPO so a
very-stale trajectory can pull, not yank. The staleness gate
(``rlhf.algorithm``) additionally drops/down-weights whole trajectories
via ``batch["weight"]``. On the card ``gpt_forward``'s attention is the
flash forward kernel K3 and its backward K4/K5.

Batch layout (all fixed shapes):

* ``tokens``        (B, T) int32 — prompt + generated, right-padded
* ``prompt_len``    (B,)  int32
* ``out_tokens``    (B, O) int32 — generated ids, right-padded
* ``out_len``       (B,)  int32
* ``behavior_logp`` (B, O) float32
* ``token_mask``    (B, O) float32 — 0 where the behavior density is
  unknown (failover-resumed tokens; excluded from the loss entirely)
* ``advantage``     (B,)  float32 — group-relative (GRPO) advantage
* ``weight``        (B,)  float32 — staleness gate output (0 = masked)
* ``temperature``/``top_k``/``top_p`` (B,) — the rollout's knobs

Nothing here imports torch at module import.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

from ray_tpu_torch.rl.learner import LearnerGroup


class GPTPolicyModule:
    """Adapter giving ``rl.learner.Learner`` the hook it needs. ``init``
    delegates to ``gpt_init`` — the same function rollout engines use
    (``serve.llm._build_model``), so a learner and a worker seeded alike on
    one device type start bit-identical at version 0."""

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, generator, device=None):
        from ray_tpu_torch.models.gpt import gpt_init

        return gpt_init(self.cfg, generator, device)


def policy_logprobs(cfg, params, batch: dict):
    """(B, O) fp32 logprobs of the generated tokens under ``params``:
    ``gpt_forward`` over the whole sequence, the logits at position
    ``prompt_len - 1 + j`` (the one that predicts generated token j) scored
    by ``token_logprobs`` under each row's sampling knobs."""
    import torch

    from ray_tpu_torch.models.gpt import gpt_forward
    from ray_tpu_torch.models.sampling import token_logprobs

    tokens = batch["tokens"].long()
    B, T = tokens.shape
    O = batch["out_tokens"].shape[1]
    logits = gpt_forward(cfg, params, tokens)  # (B, T, V) fp32
    ar = torch.arange(O, device=tokens.device)
    idx = (batch["prompt_len"].long()[:, None] - 1 + ar[None, :]).clamp(0, T - 1)
    pos_logits = logits.gather(1, idx[:, :, None].expand(B, O, logits.shape[-1]))
    return token_logprobs(
        pos_logits.reshape(B * O, -1),
        batch["out_tokens"].reshape(B * O).long(),
        batch["temperature"].float().repeat_interleave(O),
        batch["top_k"].long().repeat_interleave(O),
        batch["top_p"].float().repeat_interleave(O),
    ).reshape(B, O)


def rlhf_loss(clip_param: float = 0.2, kl_coeff: float = 0.0):
    """Token-level clipped surrogate with importance correction.

    ``advantage`` is per-trajectory (GRPO: reward standardized within
    the consumed batch — no value net), broadcast over that trajectory's
    tokens. ``kl_coeff > 0`` adds the standard approximate-KL penalty
    ``E[behavior_logp - cur_logp]`` pulling the policy back toward the
    behavior distribution.
    """

    def loss_fn(module: GPTPolicyModule, params, batch):
        import torch

        cur_lp = policy_logprobs(module.cfg, params, batch)
        O = cur_lp.shape[1]
        ar = torch.arange(O, device=cur_lp.device)
        mask = (ar[None, :] < batch["out_len"].long()[:, None]).float()
        # token_mask zeroes positions whose behavior density is UNKNOWN
        # (failover-resumed tokens carry NaN logprobs — they must be
        # excluded, not scored as probability 1)
        mask = mask * batch["token_mask"].float()
        w = batch["weight"].float()[:, None] * mask
        denom = torch.clamp(w.sum(), min=1.0)

        # masked positions are selected out (a NaN behavior logprob there
        # would survive a multiplication by 0)
        log_ratio = torch.where(mask > 0, cur_lp - batch["behavior_logp"], 0.0)
        ratio = torch.exp(log_ratio)
        adv = batch["advantage"].float()[:, None]
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param) * adv,
        )
        pi_loss = -(surr * w).sum() / denom
        # KL in clamped log space: a behavior token the CURRENT filter
        # masks out scores ~-1e30 (token_logprobs doc) — correct for the
        # ratio (exp -> 0, clipped) but it would blow the log-space KL
        # term (and a kl_coeff-weighted loss) to ~1e30 from one token
        approx_kl = -(torch.clamp(log_ratio, -20.0, 20.0) * w).sum() / denom
        clip_frac = (((ratio - 1.0).abs() > clip_param).float() * w).sum() / denom
        total = pi_loss + kl_coeff * approx_kl
        return total, {
            "policy_loss": pi_loss,
            "kl": approx_kl,
            "mean_ratio": (ratio * w).sum() / denom,
            "clip_frac": clip_frac,
        }

    return loss_fn


def make_learner_group(
    model_cfg,
    lr: float = 1e-2,
    grad_clip: Optional[float] = 1.0,
    clip_param: float = 0.2,
    kl_coeff: float = 0.0,
    seed: int = 0,
    remote: bool = False,
    device=None,
) -> LearnerGroup:
    """The async loop's learner: GPT policy + rlhf loss in the shared
    ``rl.learner`` machinery (``remote=True`` places it in its own actor,
    holding a share of a GPU on the card, so the update stream never
    contends with the driver's poll loop)."""
    return LearnerGroup(
        dict(
            module_factory=partial(GPTPolicyModule, model_cfg),
            loss_fn=rlhf_loss(clip_param, kl_coeff),
            lr=lr,
            grad_clip=grad_clip,
            seed=seed,
            device=device,
        ),
        remote=remote,
    )
