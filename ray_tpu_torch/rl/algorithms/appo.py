"""APPO — asynchronous PPO (port of ``ray_tpu/rl/algorithms/appo.py``).

Reference: ``rllib/algorithms/appo/appo.py`` — IMPALA's async architecture
(decoupled runner futures, V-trace off-policy correction, per-runner weight
broadcast) with PPO's clipped-surrogate policy objective instead of the
plain importance-weighted policy gradient, plus an optional KL penalty
toward the behavior policy. Inherits everything from the port's IMPALA —
only the loss differs.
"""

from __future__ import annotations

from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithm import register_algorithm
from ray_tpu_torch.rl.algorithms.impala import IMPALA, IMPALAConfig, vtrace
from ray_tpu_torch.rl.learner import batch_sum


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.3        # PPO surrogate clip
        self.use_kl_loss = False     # optional KL(behavior || target) penalty
        self.kl_coeff = 0.2

    algo_class = None  # set below


def appo_loss(gamma: float, rho_bar: float, c_bar: float, vf_coeff: float,
              ent_coeff: float, clip_param: float, use_kl: bool, kl_coeff: float):
    def loss_fn(module, params, batch):
        import torch

        logp, entropy, values = params.logp_entropy_value(batch[sb.OBS], batch[sb.ACTIONS])
        vs, pg_adv = vtrace(
            batch[sb.LOGP], logp.detach(), batch[sb.REWARDS], batch[sb.TERMINATEDS],
            values.detach(), batch["bootstrap_value"], gamma, rho_bar, c_bar,
        )
        # normalize advantages like synchronous PPO (jnp.std: the population
        # std), over the whole batch: a data-parallel update sums the count,
        # the sum and the squared deviations over its ranks (``batch_sum``)
        count, total = batch_sum(torch.stack([torch.tensor(float(pg_adv.numel()), device=pg_adv.device),
                                              pg_adv.sum()]))
        mean = total / count
        std = torch.sqrt(batch_sum(((pg_adv - mean) ** 2).sum()) / count)
        pg_adv = (pg_adv - mean) / (std + 1e-8)

        ratio = torch.exp(logp - batch[sb.LOGP])
        surr = torch.minimum(
            ratio * pg_adv,
            torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param) * pg_adv,
        )
        pi_loss = -torch.mean(surr)
        vf_loss = 0.5 * torch.mean((values - vs) ** 2)
        ent = torch.mean(entropy)
        total = pi_loss + vf_coeff * vf_loss - ent_coeff * ent
        metrics = {"policy_loss": pi_loss, "vf_loss": vf_loss, "entropy": ent}
        if use_kl:
            # k3 estimator of KL(behavior || target) from behavior samples:
            # r = target/behavior, E_b[r - 1 - log r] = KL(b||t), >= 0
            logr = logp - batch[sb.LOGP]
            kl = torch.mean(torch.exp(logr) - 1.0 - logr)
            total = total + kl_coeff * kl
            metrics["kl"] = kl
        return total, metrics

    return loss_fn


class APPO(IMPALA):
    @classmethod
    def get_default_config(cls) -> "APPOConfig":
        return APPOConfig()

    def _make_loss(self, cfg):
        return appo_loss(
            cfg.gamma, cfg.vtrace_clip_rho_threshold, cfg.vtrace_clip_c_threshold,
            cfg.vf_loss_coeff, cfg.entropy_coeff, cfg.clip_param,
            cfg.use_kl_loss, cfg.kl_coeff,
        )


APPOConfig.algo_class = APPO
register_algorithm("APPO", APPO)
