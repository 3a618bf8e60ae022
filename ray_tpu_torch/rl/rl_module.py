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
across without reshaping anything.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rl.spaces import Discrete, Space


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
        self.to_empty(device=generator.device)
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
        self.to_empty(device=generator.device)
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


def _mlp_from_jax(mlp: _MLP, layers: list) -> None:
    for w, b, layer in zip(mlp.w, mlp.b, layers):
        w.copy_(torch.tensor(np.asarray(layer["w"], np.float32)))
        b.copy_(torch.tensor(np.asarray(layer["b"], np.float32)))


@torch.no_grad()
def params_from_jax(tree: dict, spec: RLModuleSpec, device=None) -> ActorCriticModule:
    """An ``ActorCriticModule`` holding a reference parameter tree: the dict
    of MLP layer lists (``{"w", "b"}`` each, kernels (in, out)), CNN filters
    (HWIO) and ``log_std`` that ``ray_tpu.rl.rl_module``'s
    ``ActorCriticModule.init`` returns (after ``jax.device_get``).
    ``device=None`` means the card."""
    dev = resolve_device(device)
    module = ActorCriticModule(spec).to_empty(device="cpu")
    _mlp_from_jax(module.pi, tree["pi"])
    _mlp_from_jax(module.v, tree["v"])
    if module.enc is not None:
        _mlp_from_jax(module.enc, tree["enc"])
    if module.log_std is not None:
        module.log_std.copy_(torch.tensor(np.asarray(tree["log_std"], np.float32)))
    return module.to(dev)
