"""Connectors: observation/action transform pipelines between env and module
(copy of ``ray_tpu/rl/connectors.py``).

Reference: ``rllib/connectors/`` — env-to-module pipelines transform raw
observations before the policy sees them; module-to-env pipelines transform
policy outputs before the env steps them. Connectors are pure numpy on
the (vectorized) host path — the policy module stays transform-free.

EnvRunner stores the TRANSFORMED observations in its sample batches, so the
learner trains on exactly what the policy consumed.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np


class Connector:
    """One transform stage. Subclasses override __call__; stateful stages
    (running normalizers) expose get_state/set_state for cross-runner sync."""

    def __call__(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, data: np.ndarray) -> np.ndarray:
        """Apply WITHOUT updating internal statistics (stateless stages:
        same as __call__). Used for bootstrap/terminal observations that
        duplicate already-counted data."""
        return self(data)

    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass


class ConnectorPipeline(Connector):
    """Compose stages left-to-right (reference: ConnectorPipelineV2)."""

    def __init__(self, stages: list[Connector]):
        self.stages = list(stages)

    def __call__(self, data):
        for s in self.stages:
            data = s(data)
        return data

    def transform(self, data):
        for s in self.stages:
            data = s.transform(data)
        return data

    def observe_dones(self, done) -> None:
        for s in self.stages:
            fn = getattr(s, "observe_dones", None)
            if fn is not None:
                fn(done)

    def transform_final(self, data):
        """Transform a transition's true NEXT_OBS: stateless stages use
        transform; stateful frame stages use their non-mutating ``peek``
        (the stack the slot would have) — call before the post-step
        __call__/observe_dones."""
        for s in self.stages:
            peek = getattr(s, "peek", None)
            data = peek(data) if peek is not None else s.transform(data)
        return data

    def get_state(self) -> dict:
        return {i: s.get_state() for i, s in enumerate(self.stages)}

    def set_state(self, state: dict) -> None:
        for i, s in enumerate(self.stages):
            if i in state:
                s.set_state(state[i])


# -- env -> module ----------------------------------------------------------


class FlattenObservations(Connector):
    """(N, *obs_shape) -> (N, prod(obs_shape)) (reference:
    connectors/env_to_module/flatten_observations.py)."""

    def __call__(self, obs):
        obs = np.asarray(obs)
        return obs.reshape(obs.shape[0], -1)


class ClipObservations(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, obs):
        return np.clip(obs, self.low, self.high)


class NormalizeObservations(Connector):
    """Running mean/var normalization (reference:
    connectors/env_to_module/mean_std_filter.py). Stats update on every
    call; get_state/set_state let an algorithm sync runners periodically."""

    def __init__(self, epsilon: float = 1e-8, clip: Optional[float] = 10.0):
        self.eps = epsilon
        self.clip = clip
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, obs):
        obs = np.asarray(obs, np.float64)
        if self._mean is None:
            self._mean = np.zeros(obs.shape[1:], np.float64)
            self._m2 = np.zeros(obs.shape[1:], np.float64)
        # Chan et al. parallel update with the incoming minibatch
        bn = float(obs.shape[0])
        bmean = obs.mean(axis=0)
        bvar = obs.var(axis=0)
        delta = bmean - self._mean
        total = self._count + bn
        self._mean = self._mean + delta * (bn / total)
        self._m2 = self._m2 + bvar * bn + (delta**2) * self._count * bn / total
        self._count = total
        return self.transform(obs)

    def transform(self, obs):
        obs = np.asarray(obs, np.float64)
        if self._mean is None:
            return obs.astype(np.float32)
        var = self._m2 / max(self._count, 1.0)
        out = (obs - self._mean) / np.sqrt(var + self.eps)
        if self.clip is not None:
            out = np.clip(out, -self.clip, self.clip)
        return out.astype(np.float32)

    def get_state(self) -> dict:
        return {"count": self._count, "mean": self._mean, "m2": self._m2}

    def set_state(self, state: dict) -> None:
        self._count = state["count"]
        self._mean = state["mean"]
        self._m2 = state["m2"]


# -- frame pipeline (Atari-style pixel preprocessing) ------------------------


class GrayscaleObservations(Connector):
    """(N, H, W, 3) RGB → (N, H, W) luma (reference: the Atari wrapper
    stack's grayscale stage; ITU-R 601 weights)."""

    _W = np.array([0.299, 0.587, 0.114], np.float32)

    def __call__(self, obs):
        return self.transform(obs)

    def transform(self, obs):
        obs = np.asarray(obs, np.float32)
        return obs @ self._W


class ResizeObservations(Connector):
    """Nearest-neighbor spatial resize of (N, H, W[, C]) frames — pure
    numpy (no cv2 in the image), exact enough for RL preprocessing."""

    def __init__(self, height: int, width: int):
        self.h, self.w = height, width

    def __call__(self, obs):
        return self.transform(obs)

    def transform(self, obs):
        obs = np.asarray(obs)
        H, W = obs.shape[1], obs.shape[2]
        rows = (np.arange(self.h) * H // self.h).clip(0, H - 1)
        cols = (np.arange(self.w) * W // self.w).clip(0, W - 1)
        return obs[:, rows][:, :, cols]


class ScaleObservations(Connector):
    """uint8 pixels → [0, 1] floats."""

    def __init__(self, scale: float = 1.0 / 255.0):
        self.scale = scale

    def __call__(self, obs):
        return self.transform(obs)

    def transform(self, obs):
        return np.asarray(obs, np.float32) * self.scale


class FrameStack(Connector):
    """Stack the last k frames per env slot along a trailing channel axis
    (reference: the Atari frame-stack wrapper, done connector-side so the
    module sees (N, H, W, k)).

    Stateful: the env runner notifies episode ends via ``observe_dones`` so
    a fresh episode's stack starts from its reset frame (replicated), never
    mixing frames across episodes. ``transform`` (the stateless path, used
    for shape probes and truncation-bootstrap observations) replicates the
    single frame k times — exact at episode starts, an approximation
    elsewhere (termination-style envs never consume it).
    """

    def __init__(self, k: int = 4):
        self.k = k
        self._stacks: Optional[np.ndarray] = None  # (N, H, W, k*C)
        self._c = 1  # channels per FRAME: the slide drops/appends C at a time
        self._pending_reset: Optional[np.ndarray] = None  # bool (N,)

    @staticmethod
    def _frames_of(obs):
        obs = np.asarray(obs, np.float32)
        return obs[..., None] if obs.ndim == 3 else obs  # (N, H, W) → (N,H,W,1)

    def _replicate(self, frames):
        # per-FRAME blocks, not interleaved channels: [f, f, ..., f]
        return np.concatenate([frames] * self.k, axis=-1)

    def __call__(self, obs):
        frames = self._frames_of(obs)
        n = frames.shape[0]
        self._c = frames.shape[-1]
        if self._stacks is None or len(self._stacks) != n:
            self._stacks = self._replicate(frames)
        else:
            if self._pending_reset is not None and self._pending_reset.any():
                idx = np.nonzero(self._pending_reset)[0]
                self._stacks[idx] = self._replicate(frames[idx])
                keep = ~self._pending_reset
            else:
                keep = np.ones(n, bool)
            idx = np.nonzero(keep)[0]
            if len(idx):
                self._stacks[idx] = np.concatenate(
                    [self._stacks[idx][..., self._c :], frames[idx]], axis=-1
                )
        self._pending_reset = None
        return self._stacks.copy()

    def observe_dones(self, done: np.ndarray) -> None:
        """Called by the env runner right after stepping: the NEXT observed
        frame for these slots is a reset frame — restart their stacks."""
        self._pending_reset = np.asarray(done, bool)

    def peek(self, obs):
        """The stack each slot WOULD have after observing ``obs``, without
        mutating state — used for a transition's true NEXT_OBS (the
        ``final`` buffer): current frames slid by one, new frame appended.
        Must be called BEFORE the post-step __call__ updates the stacks."""
        frames = self._frames_of(obs)
        if self._stacks is None or len(self._stacks) != frames.shape[0]:
            return self._replicate(frames)
        return np.concatenate([self._stacks[..., frames.shape[-1] :], frames], axis=-1)

    def transform(self, obs):
        return self._replicate(self._frames_of(obs))

    def get_state(self) -> dict:
        # per-env stacks are RUNNER-LOCAL episode state: syncing them into
        # a restarted runner would slide another runner's frames into its
        # fresh episodes (cross-episode mixing). Nothing to share.
        return {}

    def set_state(self, state: dict) -> None:
        pass


# -- module -> env ----------------------------------------------------------


class ClipActions(Connector):
    """Clip continuous actions into the env's Box bounds (reference:
    connectors/module_to_env ClipActions)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, actions):
        return np.clip(actions, self.low, self.high)


class GaussianActionNoise(Connector):
    """Additive exploration noise for deterministic policies (TD3/DDPG)."""

    def __init__(self, scale: float, low=None, high=None, seed: Optional[int] = None):
        self.scale = scale
        self.low, self.high = low, high
        self._rng = np.random.default_rng(seed)

    def __call__(self, actions):
        out = np.asarray(actions) + self._rng.normal(0.0, self.scale, np.shape(actions))
        if self.low is not None:
            out = np.clip(out, self.low, self.high)
        return out.astype(np.float32)
