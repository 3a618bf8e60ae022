"""RLModule: the policy/value network abstraction (port of
``ray_tpu/rl/rl_module.py``).

Reference: ``rllib/core/rl_module/rl_module.py`` (framework-agnostic module
with forward_exploration / forward_train). The reference's module is a pair
of pure functions over a parameter pytree; here a module is an
``nn.Module`` that holds its parameters:

* ``init(generator, device)`` draws them in the reference's distributions
  from an explicit ``torch.Generator`` (on the generator's device, then
  copied to ``device``; ``None`` means the card) and returns the module —
  the ``params`` a ``Learner`` trains and its loss receives;
* ``sample_action(obs, generator)`` and ``logp_entropy_value(obs,
  actions)`` are the distribution ops runners and learners share.

Kernels keep the reference's (in, out) layout and convolutions its HWIO
filters over NHWC frames, so ``params_from_jax`` copies a reference tree
across without reshaping anything: a parameter named ``"pi.w.0"`` is the
reference's ``tree["pi"][0]["w"]``, ``"log_alpha"`` its
``tree["log_alpha"]`` (``tree_path``). Target networks are parameters of
their module (``target_q``, ``target_pi``, ``v_target``), as they are
leaves of the reference's tree, so an optimizer, ``host_weights`` and a
flat ES vector see the same tree on both sides.

The off-policy and model-based modules live here too (``SACModule``,
``TD3Module``, ``DreamerModule``; the reference keeps them in their
algorithms' files), so the algorithm modules import no torch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_tpu_torch.device import materialize, resolve_device
from ray_tpu_torch.rl.learner import tree_leaf
from ray_tpu_torch.rl.spaces import Box, Discrete, Space


class _MLP(nn.Module):
    """``x @ w + b`` layers with ``activation`` between them (the
    reference's ``_mlp_apply``); ``w`` (in, out) as the reference keeps it."""

    def __init__(self, sizes: list[int], final_scale: float, activation):
        super().__init__()
        self.sizes = list(sizes)
        self.final_scale = final_scale
        self.activation = activation
        self.w = nn.ParameterList(
            nn.Parameter(torch.empty(a, b, device="meta")) for a, b in zip(sizes, sizes[1:])
        )
        self.b = nn.ParameterList(nn.Parameter(torch.empty(b, device="meta")) for b in sizes[1:])

    @torch.no_grad()
    def draw(self, generator: torch.Generator) -> None:
        """The reference's ``_mlp_init``: normal kernels scaled by
        fan_in^-0.5 (and ``final_scale`` on the last), zero biases."""
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            scale = self.final_scale if i == n - 1 else 1.0
            draw = torch.randn(tuple(w.shape), generator=generator, device=generator.device)
            w.copy_(draw * scale * (w.shape[0] ** -0.5))
            b.zero_()

    def forward(self, x):
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1:
                x = self.activation(x)
        return x


@dataclasses.dataclass
class RLModuleSpec:
    """Reference: ``rllib/core/rl_module/rl_module.py`` SingleAgentRLModuleSpec."""

    observation_space: Space
    action_space: Space
    hidden: tuple = (64, 64)
    free_log_std: bool = True  # continuous: state-independent log-std
    #: (out_channels, kernel, stride) per conv layer — used automatically
    #: when the observation space is rank-3 (H, W, C) pixels (reference:
    #: rllib's Atari CNN defaults, scaled for small frames).
    conv_filters: tuple = ((16, 4, 2), (32, 4, 2))


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: the output is ceil(n / s)
    and the extra row goes after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class CNNEncoder(nn.Module):
    """NHWC conv stack → flat features (SAME padding, ReLU), the reference's
    ``_cnn_init``/``_cnn_apply``; filters kept HWIO."""

    def __init__(self, in_ch: int, filters):
        super().__init__()
        self.filters = tuple(tuple(f) for f in filters)
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        ch = in_ch
        for out_ch, ksz, _stride in self.filters:
            self.w.append(nn.Parameter(torch.empty(ksz, ksz, ch, out_ch, device="meta")))
            self.b.append(nn.Parameter(torch.empty(out_ch, device="meta")))
            ch = out_ch

    @torch.no_grad()
    def draw(self, generator: torch.Generator) -> None:
        for w, b in zip(self.w, self.b):
            ksz, _, ch, _ = w.shape
            draw = torch.randn(tuple(w.shape), generator=generator, device=generator.device)
            w.copy_(draw * np.sqrt(2.0 / (ksz * ksz * ch)))
            b.zero_()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW
        for w, b, (_out, ksz, stride) in zip(self.w, self.b, self.filters):
            ph, pw = _same_pad(x.shape[2], ksz, stride), _same_pad(x.shape[3], ksz, stride)
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            x = F.relu(F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=stride))
        # flatten in the reference's (H, W, C) order
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class ActorCriticModule(nn.Module):
    """Actor + critic heads; discrete (categorical) or continuous (diagonal
    gaussian). Rank-3 (pixel) observation spaces get a shared CNN encoder;
    flat spaces use shared-nothing MLPs. Built on the meta device: call
    ``init`` before use."""

    def __init__(self, spec: RLModuleSpec):
        super().__init__()
        self.spec = spec
        shape = tuple(spec.observation_space.shape)
        self._conv = len(shape) == 3
        self.discrete = isinstance(spec.action_space, Discrete)
        self.act_dim = (
            spec.action_space.n if self.discrete else int(np.prod(spec.action_space.shape))
        )
        if self._conv:
            h, w = shape[0], shape[1]
            for _out, _k, s in spec.conv_filters:
                h = -(-h // s)
                w = -(-w // s)
            self.obs_dim = h * w * spec.conv_filters[-1][0]  # encoder features
        else:
            self.obs_dim = int(np.prod(shape))
        h = list(spec.hidden)
        self.pi = _MLP([self.obs_dim] + h + [self.act_dim], 0.01, torch.tanh)
        self.v = _MLP([self.obs_dim] + h + [1], 1.0, torch.tanh)
        self.enc = CNNEncoder(shape[2], spec.conv_filters) if self._conv else None
        self.log_std = (
            None if self.discrete else nn.Parameter(torch.empty(self.act_dim, device="meta"))
        )

    @torch.no_grad()
    def init(self, generator: torch.Generator, device=None) -> "ActorCriticModule":
        """Draw the parameters from ``generator`` (pi, then v, then the
        encoder, as the reference splits its key) and place them on
        ``device`` (``None``: the card). Returns the module."""
        dev = resolve_device(device)
        materialize(self, generator.device)
        self.pi.draw(generator)
        self.v.draw(generator)
        if self.enc is not None:
            self.enc.draw(generator)
        if self.log_std is not None:
            self.log_std.zero_()
        return self.to(dev)

    def _features(self, obs):
        return self.enc(obs) if self.enc is not None else obs

    def forward(self, obs) -> dict:
        """obs (B, obs_dim) or (B, H, W, C) → {'logits'|'mean'+'log_std',
        'value' (B,)}."""
        feats = self._features(obs)
        pi_out = self.pi(feats)
        value = self.v(feats)[..., 0]
        if self.discrete:
            return {"logits": pi_out, "value": value}
        return {"mean": pi_out, "log_std": self.log_std, "value": value}

    # -- distribution ops (used by runners and learners) -------------------

    def sample_action(self, obs, generator: torch.Generator):
        out = self(obs)
        if self.discrete:
            probs = torch.softmax(out["logits"], dim=-1)
            action = torch.multinomial(probs, 1, generator=generator)[:, 0]
            logp = _categorical_logp(out["logits"], action)
        else:
            std = torch.exp(out["log_std"])
            eps = torch.randn(out["mean"].shape, generator=generator, device=out["mean"].device)
            action = out["mean"] + eps * std
            logp = _gaussian_logp(out["mean"], out["log_std"], action)
        return action, logp, out["value"]

    def logp_entropy_value(self, obs, actions):
        out = self(obs)
        if self.discrete:
            logp = _categorical_logp(out["logits"], actions)
            p = torch.softmax(out["logits"], dim=-1)
            entropy = -torch.sum(p * torch.log(p + 1e-8), dim=-1)
        else:
            logp = _gaussian_logp(out["mean"], out["log_std"], actions)
            entropy = torch.sum(
                out["log_std"] + 0.5 * math.log(2 * math.pi * math.e), dim=-1
            ) * torch.ones(out["mean"].shape[:-1], device=out["mean"].device)
        return logp, entropy, out["value"]


def _categorical_logp(logits, actions):
    logp_all = torch.log_softmax(logits, dim=-1)
    return logp_all.gather(-1, actions.long()[..., None])[..., 0]


def _gaussian_logp(mean, log_std, actions):
    std = torch.exp(log_std)
    return torch.sum(
        -0.5 * (((actions - mean) / std) ** 2 + 2 * log_std + math.log(2 * math.pi)), dim=-1
    )


class QModule(nn.Module):
    """Q-network (+ target) for DQN-family algorithms."""

    discrete = True

    def __init__(self, spec: RLModuleSpec):
        super().__init__()
        assert isinstance(spec.action_space, Discrete), "DQN requires a Discrete action space"
        self.spec = spec
        self.obs_dim = int(np.prod(spec.observation_space.shape))
        self.act_dim = spec.action_space.n
        sizes = [self.obs_dim] + list(spec.hidden) + [self.act_dim]
        self.q = _MLP(sizes, 1.0, torch.relu)
        self.target_q = _MLP(sizes, 1.0, torch.relu)

    @torch.no_grad()
    def init(self, generator: torch.Generator, device=None) -> "QModule":
        dev = resolve_device(device)
        materialize(self, generator.device)
        self.q.draw(generator)
        self.target_q.load_state_dict(self.q.state_dict())
        return self.to(dev)

    def q_values(self, obs, target: bool = False):
        return (self.target_q if target else self.q)(obs)

    def sample_action(self, obs, generator: torch.Generator):
        """Greedy argmax policy (runners layer ε-greedy on top via
        ``EnvRunner.set_epsilon``); logp/value slots are zeros for interface
        parity with ActorCriticModule."""
        action = torch.argmax(self.q_values(obs), dim=-1)
        zeros = torch.zeros(action.shape, dtype=torch.float32, device=action.device)
        return action, zeros, zeros


@torch.no_grad()
def params_from_jax(tree: dict, spec, device=None) -> nn.Module:
    """A module holding a reference parameter tree (after
    ``jax.device_get``): MLP layer lists (``{"w", "b"}`` each, kernels (in,
    out)), CNN filters (HWIO), ``log_std``/``log_alpha``. ``spec`` is an
    ``RLModuleSpec`` (an ``ActorCriticModule``) or a module built on the
    meta device (``QModule(spec)``, ``SACModule(spec)``, ...).
    ``device=None`` means the card."""
    dev = resolve_device(device)
    module = ActorCriticModule(spec) if isinstance(spec, RLModuleSpec) else spec
    materialize(module, "cpu")
    for name, p in module.named_parameters():
        p.copy_(torch.tensor(np.asarray(tree_leaf(tree, name), np.float32)))
    return module.to(dev)


def frozen(mlp: _MLP):
    """``mlp`` as a function of its detached parameters: gradients flow
    through the input only (the reference's ``stop_gradient(params)``)."""
    detached = {name: p.detach() for name, p in mlp.named_parameters()}
    return lambda x: torch.func.functional_call(mlp, detached, (x,))


class _BoxBounds:
    """A Box action space's bounds as float32 numpy (``act_low``/``act_high``)
    and, cached per device, as tensors."""

    def _init_bounds(self, space) -> None:
        self.act_low = np.asarray(space.low, np.float32).reshape(-1)
        self.act_high = np.asarray(space.high, np.float32).reshape(-1)
        self._bounds_on: dict = {}

    def bounds(self, device) -> tuple:
        if device not in self._bounds_on:
            self._bounds_on[device] = (torch.tensor(self.act_low, device=device),
                                       torch.tensor(self.act_high, device=device))
        return self._bounds_on[device]

    def _squash(self, u):
        low, high = self.bounds(u.device)
        return torch.tanh(u) * ((high - low) / 2.0) + (high + low) / 2.0


LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


class SACModule(_BoxBounds, nn.Module):
    """Squashed-gaussian policy + twin Q (+targets) + log_alpha (port of
    ``ray_tpu/rl/algorithms/sac.py``'s ``SACModule``). The gaussian's noise
    is an argument (``eps``), so a loss draws it in one place."""

    discrete = False

    def __init__(self, spec: RLModuleSpec):
        super().__init__()
        assert isinstance(spec.action_space, Box), "SAC needs a Box action space"
        self.spec = spec
        self.obs_dim = int(np.prod(spec.observation_space.shape))
        self.act_dim = int(np.prod(spec.action_space.shape))
        self._init_bounds(spec.action_space)
        h = list(spec.hidden)
        q_sizes = [self.obs_dim + self.act_dim] + h + [1]
        self.pi = _MLP([self.obs_dim] + h + [2 * self.act_dim], 0.01, torch.relu)
        self.q1 = _MLP(q_sizes, 1.0, torch.relu)
        self.q2 = _MLP(q_sizes, 1.0, torch.relu)
        self.target_q1 = _MLP(q_sizes, 1.0, torch.relu)
        self.target_q2 = _MLP(q_sizes, 1.0, torch.relu)
        self.log_alpha = nn.Parameter(torch.empty((), device="meta"))

    @torch.no_grad()
    def init(self, generator: torch.Generator, device=None) -> "SACModule":
        dev = resolve_device(device)
        materialize(self, generator.device)
        self.pi.draw(generator)
        self.q1.draw(generator)
        self.q2.draw(generator)
        self.target_q1.load_state_dict(self.q1.state_dict())
        self.target_q2.load_state_dict(self.q2.state_dict())
        self.log_alpha.fill_(math.log(0.1))
        return self.to(dev)

    def _pi(self, obs, frozen_params: bool = False):
        out = (frozen(self.pi) if frozen_params else self.pi)(obs)
        mean, log_std = torch.chunk(out, 2, dim=-1)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def sample_action_logp(self, obs, eps, frozen_params: bool = False):
        """(squashed action, logp) for standard-normal noise ``eps``."""
        mean, log_std = self._pi(obs, frozen_params)
        std = torch.exp(log_std)
        u = mean + std * eps
        logp_u = torch.sum(
            -0.5 * (((u - mean) / std) ** 2 + 2 * log_std + math.log(2 * math.pi)), dim=-1
        )
        logp = logp_u - torch.sum(2.0 * (math.log(2.0) - u - F.softplus(-2.0 * u)), dim=-1)
        return self._squash(u), logp

    def sample_action(self, obs, generator: torch.Generator):
        """EnvRunner interface: (action, logp, value placeholder)."""
        eps = torch.randn((obs.shape[0], self.act_dim), generator=generator, device=obs.device)
        a, logp = self.sample_action_logp(obs, eps)
        return a, logp, torch.zeros(a.shape[:-1], device=a.device)

    def q_values(self, obs, act, target: bool = False, frozen_params: bool = False):
        x = torch.cat([obs, act], dim=-1)
        q1, q2 = (self.target_q1, self.target_q2) if target else (self.q1, self.q2)
        if frozen_params:
            q1, q2 = frozen(q1), frozen(q2)
        return q1(x)[..., 0], q2(x)[..., 0]


class TD3Module(_BoxBounds, nn.Module):
    """Deterministic tanh policy + twin Q, each with target copies (port of
    ``ray_tpu/rl/algorithms/td3.py``'s ``TD3Module``); ``twin_q=False`` is
    DDPG's single critic."""

    discrete = False

    def __init__(self, spec: RLModuleSpec, exploration_noise: float = 0.1, twin_q: bool = True):
        super().__init__()
        assert isinstance(spec.action_space, Box), "TD3 needs a Box action space"
        self.spec = spec
        self.obs_dim = int(np.prod(spec.observation_space.shape))
        self.act_dim = int(np.prod(spec.action_space.shape))
        self._init_bounds(spec.action_space)
        self.exploration_noise = exploration_noise
        self.twin_q = twin_q
        h = list(spec.hidden)
        q_sizes = [self.obs_dim + self.act_dim] + h + [1]
        pi_sizes = [self.obs_dim] + h + [self.act_dim]
        self.pi = _MLP(pi_sizes, 0.01, torch.relu)
        self.q1 = _MLP(q_sizes, 1.0, torch.relu)
        self.target_pi = _MLP(pi_sizes, 0.01, torch.relu)
        self.target_q1 = _MLP(q_sizes, 1.0, torch.relu)
        self.q2 = _MLP(q_sizes, 1.0, torch.relu) if twin_q else None
        self.target_q2 = _MLP(q_sizes, 1.0, torch.relu) if twin_q else None

    @torch.no_grad()
    def init(self, generator: torch.Generator, device=None) -> "TD3Module":
        dev = resolve_device(device)
        materialize(self, generator.device)
        for src, dst in (("pi", "target_pi"), ("q1", "target_q1"), ("q2", "target_q2")):
            if getattr(self, src) is not None:
                getattr(self, src).draw(generator)
                getattr(self, dst).load_state_dict(getattr(self, src).state_dict())
        return self.to(dev)

    def policy(self, obs, target: bool = False):
        return self._squash((self.target_pi if target else self.pi)(obs))

    def sample_action(self, obs, generator: torch.Generator):
        """EnvRunner interface: deterministic action + exploration noise."""
        a = self.policy(obs)
        noise = self.exploration_noise * torch.randn(
            a.shape, generator=generator, device=a.device
        )
        low, high = self.bounds(a.device)
        a = torch.clamp(a + noise, low, high)
        zeros = torch.zeros(a.shape[:-1], device=a.device)
        return a, zeros, zeros

    def q_values(self, obs, act, target: bool = False, frozen_params: bool = False):
        x = torch.cat([obs, act], dim=-1)
        q1, q2 = (self.target_q1, self.target_q2) if target else (self.q1, self.q2)
        if frozen_params:
            q1 = frozen(q1)
            q2 = frozen(q2) if q2 is not None else None
        out1 = q1(x)[..., 0]
        if not self.twin_q:
            return out1, out1  # single critic: min() and the twin loss collapse
        return out1, q2(x)[..., 0]


class DreamerModule(nn.Module):
    """World model (encoder, dynamics, reward, continue, decoder) + actor +
    critic + EMA target critic (port of ``ray_tpu/rl/algorithms/
    dreamer.py``'s ``DreamerModule``; the reference adds ``v_target`` to its
    tree in ``Dreamer._setup``, here it is a parameter from the start). The
    policy acts on the encoder's latent. ``latent_dim`` is an argument (the
    reference reads ``spec.latent_dim``, 128 when unset)."""

    WORLD_MODEL = ("enc", "dyn", "rew", "cont", "dec")

    def __init__(self, spec: RLModuleSpec, latent_dim: Optional[int] = None):
        super().__init__()
        if not isinstance(spec.action_space, Discrete):
            raise ValueError("Dreamer (this build) supports discrete actions")
        self.spec = spec
        self.discrete = True  # EnvRunner protocol
        self.act_dim = spec.action_space.n
        self.obs_dim = int(np.prod(spec.observation_space.shape))
        self.latent = int(latent_dim or getattr(spec, "latent_dim", 128) or 128)
        z, h, a, o = self.latent, list(spec.hidden), self.act_dim, self.obs_dim
        self.enc = _MLP([o] + h + [z], 1.0, torch.tanh)
        self.dyn = _MLP([z + a] + h + [z], 1.0, torch.tanh)
        self.rew = _MLP([z + a] + h + [1], 1.0, torch.tanh)
        self.cont = _MLP([z + a] + h + [1], 1.0, torch.tanh)
        self.dec = _MLP([z] + h + [o], 1.0, torch.tanh)
        self.pi = _MLP([z] + h + [a], 0.01, torch.tanh)
        self.v = _MLP([z] + h + [1], 1.0, torch.tanh)
        self.v_target = _MLP([z] + h + [1], 1.0, torch.tanh)

    @torch.no_grad()
    def init(self, generator: torch.Generator, device=None) -> "DreamerModule":
        dev = resolve_device(device)
        materialize(self, generator.device)
        for name in self.WORLD_MODEL + ("pi", "v"):
            getattr(self, name).draw(generator)
        self.v_target.load_state_dict(self.v.state_dict())
        return self.to(dev)

    # -- world model pieces ------------------------------------------------
    def encode(self, obs):
        return torch.tanh(self.enc(obs.reshape(obs.shape[0], -1)))

    def _za(self, z, a):
        return torch.cat([z, F.one_hot(a.long(), self.act_dim).to(z.dtype)], dim=-1)

    def dynamics(self, z, a):
        return torch.tanh(self.dyn(self._za(z, a)))

    def reward(self, z, a):
        return self.rew(self._za(z, a))[..., 0]

    def cont_logit(self, z, a):
        return self.cont(self._za(z, a))[..., 0]

    def decode(self, z):
        return self.dec(z)

    # -- policy / value ----------------------------------------------------
    def pi_logits(self, z):
        return self.pi(z)

    def value(self, z, target: bool = False):
        return (self.v_target if target else self.v)(z)[..., 0]

    # -- EnvRunner protocol ------------------------------------------------
    def forward(self, obs) -> dict:
        z = self.encode(obs)
        return {"logits": self.pi_logits(z), "value": self.value(z)}

    def sample_action(self, obs, generator: torch.Generator):
        out = self(obs)
        probs = torch.softmax(out["logits"], dim=-1)
        action = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return action, _categorical_logp(out["logits"], action), out["value"]
