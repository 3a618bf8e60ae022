"""Dreamer — model-based RL: a learned world model trained from replayed
experience, with the actor-critic trained ON IMAGINED rollouts in latent
space, never on raw environment returns (port of
``ray_tpu/rl/algorithms/dreamer.py``).

Reference capability: ``rllib/algorithms/dreamerv3`` (world model + actor +
critic, imagination training), with the reference's documented departures
from the full DreamerV3:

* latents are deterministic Markov features ``z = enc(obs)`` (no RSSM
  recurrence / categorical posteriors);
* the world model is grounded by observation reconstruction + reward +
  continue heads (the Dreamer losses), with dynamics ``g(z, a) -> z'``
  trained against the online encoder's detached target;
* imagination: H-step rollouts under the current policy inside the latent
  space — TD(lambda) returns with an EMA target critic, REINFORCE-with-
  baseline actor gradient + entropy bonus, and DreamerV3's return
  normalization (scale by a percentile range, never amplify small
  returns).

Here the module (``rl_module.DreamerModule``) and three ``torch.optim.Adam``
(world model, actor, critic; no clip, as the reference's three
``optax.adam``) live on ``config.device`` (``None``: the card). An
iteration's updates queue on the device with no host sync: the metrics are
read once after the loop, as the reference reads its floats. Imagination
draws its actions by the Gumbel-max trick (``jax.random.categorical``'s
own), from a generator on the device or from ``gumbel`` when given.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, register_algorithm
from ray_tpu_torch.rl.learner import _to_tensor, host_weights, load_weights
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer


class DreamerConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4                 # world model
        self.actor_lr = 1e-4
        self.critic_lr = 3e-4
        self.latent_dim = 128
        self.buffer_size = 50_000
        self.learning_starts = 500
        self.sample_steps_per_iter = 400
        self.updates_per_iter = 16
        self.train_batch_size = 128
        self.imagination_horizon = 8
        self.gae_lambda = 0.95
        self.entropy_coeff = 3e-3
        self.critic_ema = 0.02         # target critic update rate
        self.return_percentile = 95.0  # DreamerV3 return-normalization range

    algo_class = None  # set below


_BATCH_KEYS = (sb.OBS, sb.NEXT_OBS, sb.ACTIONS, sb.REWARDS, sb.TERMINATEDS)


def wm_loss(mod, batch: dict):
    """The world-model loss (dynamics, reward, continue, 0.1 x
    reconstruction) and its parts, as tensors."""
    import torch
    import torch.nn.functional as F

    z = mod.encode(batch[sb.OBS])
    z_next = mod.encode(batch[sb.NEXT_OBS])
    pred_next = mod.dynamics(z, batch[sb.ACTIONS])
    pred_r = mod.reward(z, batch[sb.ACTIONS])
    pred_c = mod.cont_logit(z, batch[sb.ACTIONS])
    recon = mod.decode(z)
    flat = batch[sb.OBS].reshape(z.shape[0], -1)
    done = batch[sb.TERMINATEDS].float()
    l_dyn = torch.mean((pred_next - z_next.detach()) ** 2)
    l_rew = torch.mean((pred_r - batch[sb.REWARDS]) ** 2)
    l_cont = F.binary_cross_entropy_with_logits(pred_c, 1.0 - done)
    l_rec = torch.mean((recon - flat) ** 2)
    return l_dyn + l_rew + l_cont + 0.1 * l_rec, {
        "dyn": l_dyn, "rew": l_rew, "cont": l_cont, "recon": l_rec
    }


def imagine(mod, z0, gumbel):
    """Roll H steps under pi inside the model (no gradients): ``gumbel`` (H,
    B, A) picks each step's actions as ``argmax(logits + gumbel)``. Returns
    the last latent and the per-step (z, a, logp, entropy, r, cont) stacked
    [H, B, ...]."""
    import torch

    steps = []
    z = z0
    with torch.no_grad():
        for g in gumbel:
            logits = mod.pi_logits(z)
            a = torch.argmax(logits + g, dim=-1)
            logsm = torch.log_softmax(logits, dim=-1)
            logp = logsm.gather(-1, a[:, None])[:, 0]
            ent = -torch.sum(torch.exp(logsm) * logsm, dim=-1)
            r = mod.reward(z, a)
            cont = torch.sigmoid(mod.cont_logit(z, a))
            z_next = mod.dynamics(z, a)
            steps.append((z, a, logp, ent, r, cont))
            z = z_next
    return z, tuple(torch.stack(parts) for parts in zip(*steps))


def lambda_returns(mod, traj, z_last, gamma: float, lam: float):
    """TD(lambda) returns [H, B] of an imagined trajectory against the
    target critic, by a loop back over H (the reference's reversed scan)."""
    import torch

    zs, _a, _lp, _ent, rs, conts = traj
    H = rs.shape[0]
    with torch.no_grad():
        v_last = mod.value(z_last, target=True)
        vs_next = torch.cat(
            [mod.value(zs[1:].reshape(-1, zs.shape[-1]), target=True).reshape(H - 1, -1),
             v_last[None]], dim=0,
        )
        acc, rets = v_last, [None] * H
        for t in range(H - 1, -1, -1):
            acc = rs[t] + gamma * conts[t] * ((1 - lam) * vs_next[t] + lam * acc)
            rets[t] = acc
    return torch.stack(rets)


def ac_losses(mod, batch: dict, gumbel, cfg):
    """The critic and actor losses of one imagination: (critic loss, actor
    loss, mean imagined return), the losses with their graphs (critic over
    ``v``, actor over ``pi``)."""
    import torch

    with torch.no_grad():
        z0 = mod.encode(batch[sb.OBS])
    z_last, traj = imagine(mod, z0, gumbel)
    zs, acts, _logps, _ents, _rs, _conts = traj
    rets = lambda_returns(mod, traj, z_last, cfg.gamma, cfg.gae_lambda)
    # DreamerV3 return normalization: divide by the percentile range of
    # returns, floored at 1 (never AMPLIFY small returns)
    lo = torch.quantile(rets, (100 - cfg.return_percentile) / 100)
    hi = torch.quantile(rets, cfg.return_percentile / 100)
    scale = torch.clamp(hi - lo, min=1.0)
    flat_z = zs.reshape(-1, zs.shape[-1])
    critic_loss = torch.mean((mod.value(flat_z) - rets.reshape(-1)) ** 2)
    logsm = torch.log_softmax(mod.pi_logits(flat_z), dim=-1)
    logp = logsm.gather(-1, acts.reshape(-1)[:, None])[:, 0]
    ent = -torch.sum(torch.exp(logsm) * logsm, dim=-1)
    with torch.no_grad():
        adv = (rets.reshape(-1) - mod.value(flat_z, target=True)) / scale
    actor_loss = -torch.mean(logp * adv + cfg.entropy_coeff * ent)
    return critic_loss, actor_loss, torch.mean(rets)


class Dreamer(Algorithm):
    @classmethod
    def get_default_config(cls) -> "DreamerConfig":
        return DreamerConfig()

    def _module_cls(self):
        from ray_tpu_torch.rl.rl_module import DreamerModule

        return partial(DreamerModule, latent_dim=self.config.latent_dim)

    def _setup(self):
        import torch

        from ray_tpu_torch.device import resolve_device
        from ray_tpu_torch.rl.env import make_env
        from ray_tpu_torch.rl.rl_module import RLModuleSpec

        cfg = self.config
        runner = self._local_runner
        spec = runner.spec if runner is not None else None
        if spec is None:  # remote runners: rebuild the spec locally
            env = make_env(cfg.env)
            spec = RLModuleSpec(env.observation_space, env.action_space, hidden=tuple(cfg.hidden))
        self.device = resolve_device(cfg.device)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed or 0)
        self.module = self._module_cls()(spec).init(gen, self.device)
        self.buffer = ReplayBuffer(cfg.buffer_size)
        self._gen = torch.Generator(device=self.device).manual_seed((cfg.seed or 0) + 1)
        mod = self.module
        wm = [p for k in mod.WORLD_MODEL for p in getattr(mod, k).parameters()]
        adam = partial(torch.optim.Adam, betas=(0.9, 0.999), eps=1e-8)
        self._wm_opt = adam(wm, lr=cfg.lr)
        self._pi_opt = adam(mod.pi.parameters(), lr=cfg.actor_lr)
        self._v_opt = adam(mod.v.parameters(), lr=cfg.critic_lr)

    # -- the two updates ------------------------------------------------------

    def wm_update(self, batch: dict):
        """One world-model Adam step; returns (loss, parts) as tensors."""
        self._wm_opt.zero_grad(set_to_none=True)
        loss, parts = wm_loss(self.module, batch)
        loss.backward()
        self._wm_opt.step()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    def ac_update(self, batch: dict, gumbel=None):
        """One critic and one actor Adam step on an imagination from the
        batch's states, then the target critic's EMA; ``gumbel`` (H, B, A)
        defaults to draws from the device generator. Returns (actor loss,
        critic loss, mean imagined return) as tensors."""
        import torch

        cfg, mod = self.config, self.module
        if gumbel is None:
            shape = (cfg.imagination_horizon, batch[sb.OBS].shape[0], mod.act_dim)
            u = torch.rand(shape, generator=self._gen, device=self.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        self._v_opt.zero_grad(set_to_none=True)
        self._pi_opt.zero_grad(set_to_none=True)
        critic_loss, actor_loss, ret = ac_losses(mod, batch, gumbel, cfg)
        (critic_loss + actor_loss).backward()  # disjoint graphs: v, pi
        self._v_opt.step()
        self._pi_opt.step()
        tau = cfg.critic_ema
        with torch.no_grad():
            targets, online = list(mod.v_target.parameters()), list(mod.v.parameters())
            torch._foreach_mul_(targets, 1 - tau)
            torch._foreach_add_(targets, online, alpha=tau)
        return actor_loss.detach(), critic_loss.detach(), ret

    def training_step(self) -> dict:
        cfg = self.config
        self._sync_weights()
        batches = self.foreach_runner("sample_transitions", cfg.sample_steps_per_iter)
        for b in batches:
            self.buffer.add(b)
            self._timesteps_total += b.count
        if len(self.buffer) < cfg.learning_starts:
            return {"status": "warmup", "buffer": len(self.buffer)}
        import torch

        # every update's batch goes to the device in one copy per column
        # before the loop: a copy from pageable host memory would wait for
        # the updates queued before it
        host = [self.buffer.sample(cfg.train_batch_size) for _ in range(cfg.updates_per_iter)]
        rows = {k: _to_tensor(np.stack([b[k] for b in host]), self.device) for k in _BATCH_KEYS}
        for i in range(cfg.updates_per_iter):
            jb = {k: v[i] for k, v in rows.items()}
            wl, parts = self.wm_update(jb)
            al, vl, ret = self.ac_update(jb)
        # the iteration's one host sync, after the loop
        values = torch.stack([wl, al, vl, ret, parts["dyn"], parts["recon"]]).cpu().tolist()
        return dict(zip(("world_model_loss", "actor_loss", "critic_loss", "imagined_return_mean",
                         "dyn_loss", "recon_loss"), values))

    def _sync_weights(self):
        # runners sample with enc+pi (+v for logging): ship the full module
        weights = host_weights(self.module)
        if self._local_runner is not None:
            self._local_runner.set_weights(weights)
        else:
            ray_tpu_torch.get([a.set_weights.remote(weights) for a in self._runner_actors])

    def get_weights(self):
        """A snapshot (a clone): the updates write the module in place."""
        return {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    def set_weights(self, params):
        load_weights(self.module, params)
        self._sync_weights()


DreamerConfig.algo_class = Dreamer
register_algorithm("Dreamer", Dreamer)


def __getattr__(name):
    if name == "DreamerModule":  # a torch module: loaded on first use
        from ray_tpu_torch.rl.rl_module import DreamerModule

        return DreamerModule
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
