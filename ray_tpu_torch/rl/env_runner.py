"""EnvRunner: rollout collection (the sampling half of the RL loop; port of
``ray_tpu/rl/env_runner.py``).

Reference: ``rllib/env/single_agent_env_runner.py`` + the older
``RolloutWorker`` (``rllib/evaluation/rollout_worker.py:159``). One runner
drives a vectorized env with ONE policy forward per vector step; N runners
are spawned as runtime actors by the algorithm and sampled in parallel
(``WorkerSet.foreach_worker`` equivalent is a list of futures).

The module lives on the runner's ``device`` (``None``: the card) and its
actions come from a ``torch.Generator`` there, seeded as the reference
seeds its key (``seed + 1000 * worker_index``). Each vector step makes one
device-to-host transfer (action, logp and value together). Nothing here
imports torch at module import: the runtime loads this module to place
runner actors.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.env import make_vector_env
from ray_tpu_torch.rl.sample_batch import SampleBatch


class EnvRunner:
    """Collects fixed-length rollout fragments with policy outputs attached.

    Used both in-process (local mode / unit tests) and as an actor body.
    """

    def __init__(
        self,
        env_spec: Any,
        num_envs: int = 1,
        rollout_fragment_length: int = 200,
        seed: Optional[int] = None,
        hidden: tuple = (64, 64),
        worker_index: int = 0,
        module_cls: Optional[Callable] = None,
        env_to_module_connector: Optional[Callable] = None,
        module_to_env_connector: Optional[Callable] = None,
        device=None,
    ):
        import torch

        from ray_tpu_torch.device import resolve_device
        from ray_tpu_torch.rl.rl_module import ActorCriticModule, RLModuleSpec
        from ray_tpu_torch.rl.spaces import Box

        self.device = resolve_device(device)
        self.vec = make_vector_env(env_spec, num_envs, seed=seed)
        self.fragment = rollout_fragment_length
        self._c_obs = env_to_module_connector() if env_to_module_connector else None
        self._c_act = module_to_env_connector() if module_to_env_connector else None
        obs_space = self.vec.observation_space
        if self._c_obs is not None:
            # the module consumes TRANSFORMED observations: derive its input
            # space (shape may change — flatten/stack connectors) so runner
            # and learner modules agree
            probe = self._c_obs.transform(
                np.zeros((1,) + tuple(obs_space.shape), np.float32)
            )
            obs_space = Box(-np.inf, np.inf, shape=tuple(np.asarray(probe).shape[1:]))
        self.spec = RLModuleSpec(obs_space, self.vec.action_space, hidden=hidden)
        self.module = (module_cls or ActorCriticModule)(self.spec)
        self._gen = torch.Generator(device=self.device).manual_seed(
            0 if seed is None else seed + 1000 * worker_index
        )
        self.params = self.module.init(self._gen, self.device)
        self._eps = None  # a device scalar once set_epsilon is called
        self._obs = self._obs_transform(self.vec.reset())
        # episode stats
        self._ep_ret = np.zeros(self.vec.n, np.float32)
        self._ep_len = np.zeros(self.vec.n, np.int64)
        self._completed: list[tuple[float, int]] = []

    # -- weights -----------------------------------------------------------

    def get_weights(self):
        from ray_tpu_torch.rl.learner import host_weights

        return host_weights(self.params)

    def set_weights(self, params) -> bool:
        from ray_tpu_torch.rl.learner import load_weights

        load_weights(self.params, params)
        return True

    def get_spaces(self):
        return self.spec.observation_space, self.spec.action_space

    # -- connectors --------------------------------------------------------

    def _obs_transform(self, obs, update: bool = True):
        if self._c_obs is None:
            return obs
        if update:
            return self._c_obs(obs)
        return self._c_obs.transform(obs)

    def _act_transform(self, act):
        return self._c_act(act) if self._c_act is not None else act

    def get_connector_state(self) -> dict:
        return {
            "env_to_module": self._c_obs.get_state() if self._c_obs else {},
            "module_to_env": self._c_act.get_state() if self._c_act else {},
        }

    def set_connector_state(self, state: dict) -> bool:
        if self._c_obs and state.get("env_to_module"):
            self._c_obs.set_state(state["env_to_module"])
        if self._c_act and state.get("module_to_env"):
            self._c_act.set_state(state["module_to_env"])
        return True

    # -- policy invocation -------------------------------------------------

    def _obs_tensor(self, obs):
        import torch

        return torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)

    def _policy(self, obs):
        """(action, logp, value) as numpy, ONE device-to-host transfer."""
        import torch

        with torch.no_grad():
            action, logp, value = self.module.sample_action(self._obs_tensor(obs), self._gen)
            if self._eps is not None:
                explore = torch.rand(action.shape, generator=self._gen, device=self.device) < self._eps
                rand_a = torch.randint(
                    0, self.module.act_dim, action.shape, generator=self._gen, device=self.device
                )
                action = torch.where(explore, rand_a, action)
            n = action.shape[0]
            host = torch.cat(
                [action.reshape(n, -1).double(), logp.reshape(n, 1).double(),
                 value.reshape(n, 1).double()], dim=1,
            ).cpu().numpy()
        act = host[:, :-2]
        act = act[:, 0].astype(np.int64) if self.module.discrete else act.astype(np.float32)
        return act, host[:, -2].astype(np.float32), host[:, -1].astype(np.float32)

    def _values_of(self, obs_batch: np.ndarray) -> np.ndarray:
        """Critic value of arbitrary observations (used to bootstrap at
        truncations from the TRUE final obs rather than the reset obs)."""
        import torch

        if not hasattr(self.module, "v"):  # a Q-module's value slot is zeros
            return np.zeros(len(obs_batch), np.float32)
        with torch.no_grad():
            out = self.module(self._obs_tensor(obs_batch))
        return out["value"].cpu().numpy()

    # -- sampling ----------------------------------------------------------

    def _rollout(self, T: int) -> dict[str, np.ndarray]:
        """Shared (T, N)-buffer rollout collector behind all three samplers.

        Steps the vector env T times with the current policy, maintaining
        episode-return bookkeeping. ``final`` holds each transition's TRUE
        next obs (pre-auto-reset for done envs).
        """
        N = self.vec.n
        # transformed shape: connectors may reshape observations
        obs_shape = tuple(np.asarray(self._obs).shape[1:])
        act_shape = () if self.module.discrete else self.vec.action_space.shape
        act_dtype = np.int64 if self.module.discrete else np.float32
        buf = {
            "obs": np.zeros((T, N) + obs_shape, np.float32),
            "act": np.zeros((T, N) + act_shape, act_dtype),
            # the action the ENV executed (post module_to_env transform) —
            # replay/off-policy batches must pair returns with THIS action;
            # the pre-transform module action is only for on-policy logp
            "env_act": np.zeros((T, N) + act_shape, act_dtype),
            "rew": np.zeros((T, N), np.float32),
            "term": np.zeros((T, N), bool),
            "trunc": np.zeros((T, N), bool),
            "logp": np.zeros((T, N), np.float32),
            "val": np.zeros((T, N), np.float32),
            "final": np.zeros((T, N) + obs_shape, np.float32),
        }
        for t in range(T):
            action, logp, value = self._policy(self._obs)
            buf["obs"][t] = self._obs
            buf["act"][t] = action
            buf["logp"][t] = logp
            buf["val"][t] = value
            env_action = self._act_transform(action)
            buf["env_act"][t] = env_action
            self._obs, rew, term, trunc, final = self.vec.step(env_action)
            # `final` (each transition's TRUE next obs) transforms FIRST,
            # against the PRE-step connector state: frame stacks peek the
            # stack the slot would have — correct NEXT_OBS for off-policy
            # targets even at episode ends
            tf = getattr(self._c_obs, "transform_final", None) or getattr(
                self._c_obs, "peek", None  # a bare FrameStack connector
            )
            if tf is not None:
                buf["final"][t] = tf(final)
            else:
                buf["final"][t] = self._obs_transform(final, update=False)
            # stateful frame connectors (FrameStack) must learn about
            # episode ends BEFORE transforming the post-step obs: done
            # slots' next frame is a reset frame and starts a fresh stack
            if self._c_obs is not None:
                fn = getattr(self._c_obs, "observe_dones", None)
                if fn is not None:
                    fn(term | trunc)
            # stats-updating transform runs ONCE per step (on the stepped
            # obs); `final` — the same raw data for non-done slots — applies
            # the transform without re-updating running statistics
            self._obs = self._obs_transform(self._obs)
            buf["rew"][t], buf["term"][t], buf["trunc"][t] = rew, term, trunc
            self._ep_ret += rew
            self._ep_len += 1
            for i in np.nonzero(term | trunc)[0]:
                self._completed.append((float(self._ep_ret[i]), int(self._ep_len[i])))
                self._ep_ret[i] = 0.0
                self._ep_len[i] = 0
        return buf

    def _truncation_values(self, buf) -> Optional[np.ndarray]:
        """Critic values of the true final obs, (T, N), where truncated."""
        if not buf["trunc"].any():
            return None
        T, N = buf["rew"].shape
        obs_shape = buf["final"].shape[2:]
        tv = self._values_of(buf["final"].reshape((T * N,) + tuple(obs_shape)))
        return tv.reshape(T, N)

    def sample(self, num_steps: Optional[int] = None) -> SampleBatch:
        """Returns a (T*N,)-flattened SampleBatch with advantages computed.

        Keeps (T, N) structure internally so GAE can bootstrap per-env.
        """
        T = num_steps or self.fragment
        N = self.vec.n
        buf = self._rollout(T)
        # Bootstrap values for the final obs.
        last_values = self._values_of(self._obs)
        # At truncated steps GAE must bootstrap from the critic's value of
        # the TRUE final obs (pre-reset), not the stored value of the reset
        # obs; one extra batched forward over the rollout supplies it.
        adv, targets = sb.compute_gae(
            buf["rew"], buf["val"], buf["term"], buf["trunc"], last_values,
            truncation_values=self._truncation_values(buf),
        )
        flat = lambda a: a.reshape((T * N,) + a.shape[2:])  # noqa: E731
        return SampleBatch(
            {
                sb.OBS: flat(buf["obs"]),
                sb.ACTIONS: flat(buf["act"]),
                sb.REWARDS: flat(buf["rew"]),
                sb.TERMINATEDS: flat(buf["term"]),
                sb.TRUNCATEDS: flat(buf["trunc"]),
                sb.LOGP: flat(buf["logp"]),
                sb.VF_PREDS: flat(buf["val"]),
                sb.ADVANTAGES: flat(adv),
                sb.VALUE_TARGETS: flat(targets),
            }
        )

    def sample_transitions(self, num_steps: int) -> SampleBatch:
        """(s, a, r, s', done) tuples for off-policy algos (DQN).

        NEXT_OBS is the TRUE next observation (the pre-reset terminal obs for
        done envs), so Q-targets never bootstrap from a reset state; TRUNCATEDS
        is stored so losses can distinguish time-limit cuts from termination.
        """
        T, N = num_steps, self.vec.n
        buf = self._rollout(T)
        flat = lambda a: a.reshape((T * N,) + a.shape[2:])  # noqa: E731
        return SampleBatch(
            {
                sb.OBS: flat(buf["obs"]),
                sb.ACTIONS: flat(buf["env_act"]),
                sb.REWARDS: flat(buf["rew"]),
                sb.NEXT_OBS: flat(buf["final"]),
                sb.TERMINATEDS: flat(buf["term"]),
                sb.TRUNCATEDS: flat(buf["trunc"]),
            }
        )

    def sample_sequences(self, num_steps: Optional[int] = None, gamma: float = 0.99) -> SampleBatch:
        """Time-major rollout kept as (N, T, ...) sequences for V-trace
        (IMPALA). Truncated steps fold the critic's value of the true final
        obs into the reward (the standard time-limit bootstrap trick), so the
        V-trace scan can treat every boundary as a hard cut.

        Extra keys: ``bootstrap_value`` (N,) — critic value of the obs after
        the last step of each slot.
        """
        T = num_steps or self.fragment
        buf = self._rollout(T)
        rew, done = buf["rew"], buf["term"]
        tv = self._truncation_values(buf)
        if tv is not None:
            rew = np.where(buf["trunc"], rew + gamma * tv, rew)
            done = done | buf["trunc"]
        boot = self._values_of(self._obs)
        tm = lambda a: np.swapaxes(a, 0, 1)  # (T,N,..) -> (N,T,..)  # noqa: E731
        return SampleBatch(
            {
                sb.OBS: tm(buf["obs"]),
                sb.ACTIONS: tm(buf["act"]),
                sb.REWARDS: tm(rew),
                sb.TERMINATEDS: tm(done),
                sb.LOGP: tm(buf["logp"]),
                "bootstrap_value": boot,
            }
        )

    def set_epsilon(self, eps: float) -> bool:
        """ε-greedy override used by DQN runners. ε is a device scalar the
        policy step reads, so decaying it costs one small copy."""
        import torch

        self._eps = torch.tensor(float(eps), device=self.device)
        return True

    def episode_stats(self, clear: bool = True) -> dict:
        eps = self._completed
        if clear:
            self._completed = []
        if not eps:
            return {"episodes": 0, "episode_return_mean": None, "episode_len_mean": None}
        rets = [r for r, _ in eps]
        lens = [l for _, l in eps]
        return {
            "episodes": len(eps),
            "episode_return_mean": float(np.mean(rets)),
            "episode_return_max": float(np.max(rets)),
            "episode_return_min": float(np.min(rets)),
            "episode_len_mean": float(np.mean(lens)),
        }

    def eval_return(
        self, params=None, episodes: int = 1, max_steps: int = 5000
    ) -> dict:
        """Roll COMPLETE episodes with the (optionally supplied) weights and
        report their mean return — the evaluation primitive evolution
        strategies are built on (reference: ``rllib/algorithms/es/``
        ``Worker.do_rollouts``). Consumes and clears the episode-stat
        buffer; ``max_steps`` bounds runaway non-terminating policies."""
        if params is not None:
            self.set_weights(params)
        # fresh episodes ONLY: without a reset, the first "episode" counted
        # here started under the PREVIOUS weights
        self._obs = self._obs_transform(self.vec.reset())
        self._ep_ret[:] = 0
        self._ep_len[:] = 0
        self.episode_stats(clear=True)
        chunk = max(1, min(self.fragment, 100))
        steps = 0
        while steps < max_steps and len(self._completed) < episodes:
            self._rollout(chunk)
            steps += chunk * self.vec.n
        s = self.episode_stats(clear=True)
        if s["episodes"]:
            ret = s["episode_return_mean"]
        else:
            # no episode finished within max_steps (non-terminating policy):
            # report the PARTIAL accumulated return
            ret = float(np.mean(self._ep_ret))
        return {"episodes": s["episodes"], "return_mean": ret, "steps": steps}

    def ping(self) -> bool:
        return True
