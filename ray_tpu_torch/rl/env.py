"""Environments: gymnasium-API base class, classic-control built-ins,
vectorization, and a registry (copy of ``ray_tpu/rl/env.py``).

Reference: RLlib consumes external gym envs (``rllib/env/``); this image has
no gym, so the classic-control dynamics used by the reference's smoke/learning
tests (CartPole for PPO/DQN/IMPALA, Pendulum for continuous control) are
implemented natively with the same physics constants as gymnasium's
``cartpole.py`` / ``pendulum.py`` public formulas. API:
``reset(seed) -> (obs, info)``, ``step(a) -> (obs, r, terminated, truncated,
info)``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from ray_tpu_torch.rl.spaces import Box, Discrete, Space


class Env:
    observation_space: Space
    action_space: Space
    spec_max_episode_steps: Optional[int] = None

    def reset(self, *, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError

    def close(self):
        pass


class CartPoleEnv(Env):
    """Pole balancing; reward 1 per step; terminates past ±12° / ±2.4m."""

    def __init__(self, max_episode_steps: int = 500):
        self.observation_space = Box(-np.inf, np.inf, shape=(4,))
        self.action_space = Discrete(2)
        self.spec_max_episode_steps = max_episode_steps
        self._rng = np.random.default_rng()
        self._state = None
        self._t = 0

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._t = 0
        return self._state.astype(np.float32), {}

    def step(self, action):
        x, x_dot, th, th_dot = self._state
        force = 10.0 if action == 1 else -10.0
        costh, sinth = np.cos(th), np.sin(th)
        # Standard cart-pole dynamics (masscart 1.0, masspole 0.1, len 0.5).
        temp = (force + 0.05 * th_dot**2 * sinth) / 1.1
        th_acc = (9.8 * sinth - costh * temp) / (0.5 * (4.0 / 3.0 - 0.1 * costh**2 / 1.1))
        x_acc = temp - 0.05 * th_acc * costh / 1.1
        tau = 0.02
        x, x_dot = x + tau * x_dot, x_dot + tau * x_acc
        th, th_dot = th + tau * th_dot, th_dot + tau * th_acc
        self._state = np.array([x, x_dot, th, th_dot])
        self._t += 1
        terminated = bool(abs(x) > 2.4 or abs(th) > 12 * np.pi / 180)
        truncated = self._t >= self.spec_max_episode_steps
        return self._state.astype(np.float32), 1.0, terminated, truncated, {}


class PendulumEnv(Env):
    """Continuous control: swing up; reward = -(angle² + .1ω² + .001u²)."""

    def __init__(self, max_episode_steps: int = 200):
        self.observation_space = Box(-np.inf, np.inf, shape=(3,))
        self.action_space = Box(-2.0, 2.0, shape=(1,))
        self.spec_max_episode_steps = max_episode_steps
        self._rng = np.random.default_rng()
        self._th = self._thdot = 0.0
        self._t = 0

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._th = self._rng.uniform(-np.pi, np.pi)
        self._thdot = self._rng.uniform(-1.0, 1.0)
        self._t = 0
        return self._obs(), {}

    def _obs(self):
        return np.array([np.cos(self._th), np.sin(self._th), self._thdot], dtype=np.float32)

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0], -2.0, 2.0))
        th, thdot = self._th, self._thdot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        reward = -(norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2)
        thdot = thdot + (3 * 9.81 / 2 * np.sin(th) + 3.0 * u) * 0.05
        thdot = float(np.clip(thdot, -8.0, 8.0))
        th = th + thdot * 0.05
        self._th, self._thdot = th, thdot
        self._t += 1
        return self._obs(), float(reward), False, self._t >= self.spec_max_episode_steps, {}


class GridWorldEnv(Env):
    """Tiny deterministic 1-D corridor (debug env; reference uses similar
    toy envs for unit tests)."""

    def __init__(self, n: int = 8):
        self.n = n
        self.observation_space = Box(0.0, float(n), shape=(1,))
        self.action_space = Discrete(2)
        self.spec_max_episode_steps = 4 * n
        self._pos = 0
        self._t = 0

    def reset(self, *, seed=None):
        self._pos, self._t = 0, 0
        return np.array([0.0], dtype=np.float32), {}

    def step(self, action):
        self._pos = max(0, min(self.n - 1, self._pos + (1 if action == 1 else -1)))
        self._t += 1
        done = self._pos == self.n - 1
        return (
            np.array([float(self._pos)], dtype=np.float32),
            1.0 if done else -0.01,
            done,
            self._t >= self.spec_max_episode_steps,
            {},
        )


class CatchPixelEnv(Env):
    """Atari-class pixel control without ALE (not installable here): the
    classic DeepMind "Catch" game rendered as 84x84x3 uint8 RGB frames —
    the agent sees raw pixels and must drive the frame-connector pipeline
    (grayscale → resize → scale → frame-stack) exactly like a Pong setup.

    A ball falls from a random top column; a 3-pixel paddle at the bottom
    moves {left, stay, right}; reward +1 on catch, -1 on miss; an episode is
    ``balls`` consecutive drops (score range [-balls, +balls]). Random play
    averages ≈ -0.6·balls; a solved policy ≈ +balls.
    """

    SIZE = 21  # logical grid; rendered 4x → 84x84
    SCALE = 4

    def __init__(self, balls: int = 3):
        px = self.SIZE * self.SCALE
        self.observation_space = Box(0, 255, shape=(px, px, 3))
        self.action_space = Discrete(3)
        self.spec_max_episode_steps = balls * self.SIZE + 1
        self.balls = balls
        self._rng = np.random.default_rng()
        self._t = 0

    def _render(self) -> np.ndarray:
        g = np.zeros((self.SIZE, self.SIZE, 3), np.uint8)
        g[self._ball_r, self._ball_c] = (255, 255, 255)
        lo = max(self._paddle - 1, 0)
        hi = min(self._paddle + 1, self.SIZE - 1)
        g[self.SIZE - 1, lo : hi + 1] = (0, 255, 0)
        return np.repeat(np.repeat(g, self.SCALE, 0), self.SCALE, 1)

    def _drop(self):
        self._ball_r = 0
        self._ball_c = int(self._rng.integers(0, self.SIZE))

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._paddle = self.SIZE // 2
        self._caught = 0
        self._t = 0
        self._drop()
        return self._render(), {}

    def step(self, action):
        self._paddle = int(np.clip(self._paddle + (int(action) - 1), 1, self.SIZE - 2))
        self._ball_r += 1
        self._t += 1
        reward = 0.0
        done = False
        if self._ball_r >= self.SIZE - 1:
            reward = 1.0 if abs(self._ball_c - self._paddle) <= 1 else -1.0
            self._caught += 1
            if self._caught >= self.balls:
                done = True
            else:
                self._drop()
        return (
            self._render(),
            reward,
            done,
            self._t >= self.spec_max_episode_steps,
            {},
        )


class MinAtarBreakoutEnv(Env):
    """MinAtar-style Breakout: 10x10 grid, 4 boolean channels (paddle,
    ball, ball-trail, bricks) — the miniaturized Atari family the
    reference's release learning tests graduate to (MinAtar is the public
    CPU-scale analog of the 30-60-min Atari criteria,
    ``release/rllib_tests/README.rst``). Dynamics follow the published
    MinAtar breakout rules: three brick rows, diagonal ball, paddle at the
    bottom row, +1 per brick, wall clears re-spawn, episode ends when the
    ball passes the paddle. Random play measures 0.14 mean return
    (200 episodes, seed 0) — the learning tests' baseline.
    """

    SIZE = 10

    def __init__(self, max_episode_steps: int = 400):
        self.observation_space = Box(0.0, 1.0, shape=(self.SIZE, self.SIZE, 4))
        self.action_space = Discrete(3)  # left, stay, right
        self.spec_max_episode_steps = max_episode_steps
        self._rng = np.random.default_rng()
        self._t = 0

    def _spawn_ball(self):
        side = int(self._rng.integers(0, 2))
        self._ball = [3, 0 if side == 0 else self.SIZE - 1]
        self._dy, self._dx = 1, (1 if side == 0 else -1)
        self._last = list(self._ball)

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._paddle = self.SIZE // 2
        self._bricks = np.zeros((self.SIZE, self.SIZE), bool)
        self._bricks[1:4, :] = True
        self._spawn_ball()
        self._t = 0
        return self._obs(), {}

    def _obs(self):
        g = np.zeros((self.SIZE, self.SIZE, 4), np.float32)
        g[self.SIZE - 1, self._paddle, 0] = 1.0
        g[self._ball[0], self._ball[1], 1] = 1.0
        g[self._last[0], self._last[1], 2] = 1.0
        g[:, :, 3] = self._bricks
        return g

    def step(self, action):
        self._paddle = int(np.clip(self._paddle + (int(action) - 1), 0, self.SIZE - 1))
        self._t += 1
        reward = 0.0
        terminated = False
        self._last = list(self._ball)
        ny, nx = self._ball[0] + self._dy, self._ball[1] + self._dx
        if nx < 0 or nx >= self.SIZE:  # side wall
            self._dx = -self._dx
            nx = self._ball[1] + self._dx
        if ny < 0:  # ceiling
            self._dy = 1
            ny = self._ball[0] + self._dy
        if 0 <= ny < self.SIZE and self._bricks[ny, nx]:
            self._bricks[ny, nx] = False
            reward = 1.0
            self._dy = -self._dy
            ny = self._ball[0] + self._dy
            ny = max(min(ny, self.SIZE - 1), 0)
        if ny == self.SIZE - 1:  # paddle row
            if nx == self._paddle:
                self._dy = -1
                ny = self._ball[0] - 1
            else:
                terminated = True
        if not self._bricks.any():
            self._bricks[1:4, :] = True  # wall cleared: respawn
        self._ball = [int(ny), int(nx)]
        truncated = self._t >= self.spec_max_episode_steps
        return self._obs(), reward, terminated, truncated, {}


_REGISTRY: dict[str, Callable[[], Env]] = {
    "CartPole-v1": CartPoleEnv,
    "Pendulum-v1": PendulumEnv,
    "GridWorld-v0": GridWorldEnv,
    "CatchPixel-v0": CatchPixelEnv,
    "MinAtarBreakout-v0": MinAtarBreakoutEnv,
}


def register_env(name: str, creator: Callable[[], Env]) -> None:
    """Reference: ``ray.tune.registry.register_env``."""
    _REGISTRY[name] = creator


def make_vector_env(spec, n_envs: int, seed: Optional[int] = None):
    """SyncVectorEnv for single-agent envs; MultiAgentVectorEnv (same
    interface, slots = env x agent) when the creator builds a MultiAgentEnv
    — shared-policy multi-agent training with unchanged algorithms."""
    from ray_tpu_torch.rl.multi_agent import MultiAgentEnv, MultiAgentVectorEnv

    probe = make_env(spec)
    if isinstance(probe, MultiAgentEnv):
        return MultiAgentVectorEnv(spec, n_envs, seed=seed)
    return SyncVectorEnv(spec, n_envs, seed=seed, _first=probe)


def make_env(spec) -> Env:
    if isinstance(spec, Env):
        return spec
    if isinstance(spec, str):
        if spec not in _REGISTRY:
            raise KeyError(f"Unknown env {spec!r}; registered: {sorted(_REGISTRY)}")
        return _REGISTRY[spec]()
    if callable(spec):
        return spec()
    raise TypeError(f"Cannot build env from {spec!r}")


class SyncVectorEnv:
    """N envs stepped in lockstep with auto-reset (reference:
    ``rllib/env/vector_env.py``). Obs/rewards/dones are stacked numpy arrays
    ready for one batched policy forward — the policy runs ONE forward
    per vector step regardless of N."""

    def __init__(self, creator: Callable[[], Env], n: int, seed: Optional[int] = None, _first=None):
        self.envs = ([_first] if _first is not None else []) + [
            make_env(creator) for _ in range(n - (1 if _first is not None else 0))
        ]
        self.n = n
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space
        self._seed = seed

    def reset(self):
        obs = []
        for i, e in enumerate(self.envs):
            o, _ = e.reset(seed=None if self._seed is None else self._seed + i)
            obs.append(o)
        return np.stack(obs)

    def step(self, actions):
        """Returns ``(obs, rewards, terminateds, truncateds, final_obs)``.

        ``obs`` is the post-auto-reset observation (what the policy acts on
        next); ``final_obs`` is the TRUE next observation of the transition —
        the pre-reset terminal obs for done envs (gymnasium's
        ``final_observation`` info field). Off-policy algorithms must
        bootstrap from ``final_obs``, never from a reset state.
        """
        obs, rews, terms, truncs, finals = [], [], [], [], []
        for e, a in zip(self.envs, actions):
            o, r, term, trunc, _info = e.step(a)
            final = o
            if term or trunc:
                o, _ = e.reset()
            obs.append(o)
            rews.append(r)
            terms.append(term)
            truncs.append(trunc)
            finals.append(final)
        return (
            np.stack(obs),
            np.asarray(rews, np.float32),
            np.asarray(terms, bool),
            np.asarray(truncs, bool),
            np.stack(finals),
        )
