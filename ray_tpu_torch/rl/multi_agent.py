"""Multi-agent environments with shared-policy training (copy of
``ray_tpu/rl/multi_agent.py``).

Reference: ``rllib/env/multi_agent_env.py`` — envs whose ``reset``/``step``
speak per-agent dicts (``{agent_id: obs}``, dones keyed per agent plus
``"__all__"``). ``MultiAgentVectorEnv`` flattens (env, agent) pairs into
vector SLOTS with the same stacked-array interface as ``SyncVectorEnv``,
so the policy sees one batched forward over all
agents of all envs and every single-agent algorithm (PPO/IMPALA/...) trains
a SHARED policy across agents with zero algorithm changes (the reference's
default when all agents map to one policy).

Scope: fixed agent sets (every agent steps every turn until ``__all__``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ray_tpu_torch.rl.spaces import Space


class MultiAgentEnv:
    """Per-agent-dict env API (reference: ``multi_agent_env.py``)."""

    #: fixed agent ids, e.g. ["agent_0", "agent_1"]
    agents: list
    observation_space: Space  # per-agent (homogeneous, shared policy)
    action_space: Space

    def reset(self, *, seed: Optional[int] = None) -> tuple[dict, dict]:
        raise NotImplementedError

    def step(self, action_dict: dict) -> tuple[dict, dict, dict, dict, dict]:
        """returns (obs, rewards, terminateds, truncateds, infos) — all
        per-agent dicts; terminateds/truncateds include '__all__'."""
        raise NotImplementedError

    def close(self):
        pass


class MultiAgentVectorEnv:
    """SyncVectorEnv-shaped view over N multi-agent envs: slot (i, a) is
    agent ``a`` of env ``i``; ``n = n_envs * n_agents``. Episodes reset when
    ``__all__`` is set; the pre-reset obs is reported as ``final_obs``."""

    def __init__(self, creator, n_envs: int, seed: Optional[int] = None):
        from ray_tpu_torch.rl.env import make_env

        self.envs = [make_env(creator) for _ in range(n_envs)]
        first = self.envs[0]
        assert isinstance(first, MultiAgentEnv), type(first)
        self.agents = list(first.agents)
        self.n_envs = n_envs
        self.n = n_envs * len(self.agents)
        self.observation_space = first.observation_space
        self.action_space = first.action_space
        self._seed = seed

    def _stack(self, dicts: list[dict], default=0.0):
        rows = []
        for d in dicts:
            for a in self.agents:
                rows.append(d.get(a, default))
        return rows

    def reset(self):
        obs = []
        for i, e in enumerate(self.envs):
            o, _ = e.reset(seed=None if self._seed is None else self._seed + i)
            obs.extend(o[a] for a in self.agents)
        return np.stack(obs)

    def step(self, actions):
        A = len(self.agents)
        obs_out, rew_out, term_out, trunc_out, final_out = [], [], [], [], []
        for i, e in enumerate(self.envs):
            act = {a: actions[i * A + j] for j, a in enumerate(self.agents)}
            o, r, term, trunc, _info = e.step(act)
            done_all = term.get("__all__", False) or trunc.get("__all__", False)
            finals = [o.get(a) for a in self.agents]
            if done_all:
                o, _ = e.reset()
            for j, a in enumerate(self.agents):
                obs_out.append(o[a])
                rew_out.append(r.get(a, 0.0))
                term_out.append(bool(term.get(a, term.get("__all__", False))))
                trunc_out.append(bool(trunc.get(a, trunc.get("__all__", False))))
                final_out.append(finals[j] if finals[j] is not None else o[a])
        return (
            np.stack(obs_out),
            np.asarray(rew_out, np.float32),
            np.asarray(term_out, bool),
            np.asarray(trunc_out, bool),
            np.stack(final_out),
        )


class EchoCoopEnv(MultiAgentEnv):
    """Tiny 2-agent cooperative debug env: each step both agents see the same
    random bit and are rewarded for choosing the action equal to it (and
    extra when BOTH match — coordination signal). Fixed-length episodes."""

    def __init__(self, episode_len: int = 32):
        from ray_tpu_torch.rl.spaces import Box, Discrete

        self.agents = ["agent_0", "agent_1"]
        self.observation_space = Box(0.0, 1.0, shape=(2,))
        self.action_space = Discrete(2)
        self.episode_len = episode_len
        self._rng = np.random.default_rng()
        self._bit = 0
        self._t = 0

    def _obs(self):
        o = np.array([self._bit, 1 - self._bit], np.float32)
        return {a: o for a in self.agents}

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._bit = int(self._rng.integers(0, 2))
        self._t = 0
        return self._obs(), {}

    def step(self, action_dict):
        correct = {a: int(action_dict[a]) == self._bit for a in self.agents}
        both = all(correct.values())
        rewards = {
            a: (1.0 if correct[a] else 0.0) + (0.5 if both else 0.0)
            for a in self.agents
        }
        self._t += 1
        self._bit = int(self._rng.integers(0, 2))
        trunc_all = self._t >= self.episode_len
        terms = {a: False for a in self.agents} | {"__all__": False}
        truncs = {a: trunc_all for a in self.agents} | {"__all__": trunc_all}
        return self._obs(), rewards, terms, truncs, {}
