"""Algorithm + AlgorithmConfig: the RL training driver (port of
``ray_tpu/rl/algorithm.py``).

Reference: ``rllib/algorithms/algorithm.py:192`` (Algorithm(Trainable):
``step``/``training_step``, save/restore, evaluate) and
``algorithm_config.py`` (fluent builder: ``.environment().env_runners()
.training()``). An Algorithm owns N EnvRunner actors + a LearnerGroup;
``train()`` = one ``training_step`` plus result bookkeeping; algorithms
register themselves so ``tune.run("PPO")`` resolves by name.

Device adaptation (as ``device=`` is elsewhere in the port): ``device``
places the learner and the env runners (``None``: the card, ``"cpu"``: the
CPU); on the card a remote runner holds ``ENV_RUNNER_GPUS`` of a GPU and a
remote learner ``LearnerGroup``'s share, each bound to its share of its
node's cards by its index (``accelerators.gpu.card_share_options``).
Nothing here imports torch at module import.
"""

from __future__ import annotations

import copy
import os
import pickle
import time
from typing import Any, Callable, Optional, Type

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rl.env_runner import EnvRunner

_ALGORITHMS: dict[str, Type["Algorithm"]] = {}

#: the GPU share a remote env runner on the card holds (its module is small)
ENV_RUNNER_GPUS = 0.1


def register_algorithm(name: str, cls: Type["Algorithm"]) -> None:
    _ALGORITHMS[name] = cls


def get_algorithm_class(name: str) -> Type["Algorithm"]:
    import ray_tpu_torch.rl.algorithms  # noqa: F401  (each algorithm registers itself)

    if name not in _ALGORITHMS:
        raise KeyError(f"Unknown algorithm {name!r}; registered: {sorted(_ALGORITHMS)}")
    return _ALGORITHMS[name]


class AlgorithmConfig:
    """Fluent builder, ``.build()`` → Algorithm.

    Subset of the reference's surface that the algorithms here consume;
    unknown keys pass through ``.training(**kwargs)`` into ``self.extra``.
    """

    algo_class: Optional[Type["Algorithm"]] = None

    def __init__(self):
        self.env: Any = None
        self.num_env_runners = 0          # 0 = sample in-process (local mode)
        self.num_envs_per_env_runner = 1
        self.rollout_fragment_length = 200
        # Reference: AlgorithmConfig.fault_tolerance(restart_failed_env_runners=)
        # — a dead runner actor is replaced in-place and training continues.
        self.restart_failed_env_runners = True
        #: factories building connector pipelines per runner (reference:
        #: AlgorithmConfig.env_runners(env_to_module_connector=...))
        self.env_to_module_connector = None
        self.module_to_env_connector = None
        self.train_batch_size = 4000
        self.minibatch_size = 128
        self.num_epochs = 8
        self.lr = 3e-4
        self.gamma = 0.99
        self.seed: Optional[int] = 0
        self.hidden = (64, 64)
        self.remote_learner = False
        self.grad_clip: Optional[float] = 0.5
        #: the learner's and the env runners' device (None: the card)
        self.device: Optional[str] = None
        self.extra: dict[str, Any] = {}

    # builder steps (each returns self, reference style) --------------------

    def environment(self, env=None, **kwargs) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        self.extra.update(kwargs)
        return self

    def env_runners(
        self,
        num_env_runners: Optional[int] = None,
        num_envs_per_env_runner: Optional[int] = None,
        rollout_fragment_length: Optional[int] = None,
        env_to_module_connector=None,
        module_to_env_connector=None,
        **kwargs,
    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if env_to_module_connector is not None:
            self.env_to_module_connector = env_to_module_connector
        if module_to_env_connector is not None:
            self.module_to_env_connector = module_to_env_connector
        self.extra.update(kwargs)
        return self

    # reference alias
    rollouts = env_runners

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self.extra[k] = v
        return self

    def debugging(self, seed: Optional[int] = None, **kwargs) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        self.extra.update(kwargs)
        return self

    def framework(self, *_args, **_kwargs) -> "AlgorithmConfig":
        return self  # torch only — kept for call-site parity

    def resources(self, **kwargs) -> "AlgorithmConfig":
        """``device`` sets the placement; other keys pass through into
        ``extra``."""
        return self.training(**kwargs)

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        return {k: v for k, v in vars(self).items() if not k.startswith("_")}

    def update_from_dict(self, d: dict) -> "AlgorithmConfig":
        return self.training(**d)

    def build(self, env=None) -> "Algorithm":
        if env is not None:
            self.env = env
        assert self.algo_class is not None, "Use a concrete config (PPOConfig, DQNConfig)"
        return self.algo_class(self)


class Algorithm:
    """Base driver. Subclasses implement ``_setup()`` and ``training_step()``."""

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        self.iteration = 0
        self._timesteps_total = 0
        self._episode_return_mean: Optional[float] = None
        self._runner_actors: list = []
        self._local_runner: Optional[EnvRunner] = None
        self._make_runners()
        self._setup()

    # -- runner management (WorkerSet equivalent) ---------------------------

    def _runner_kwargs(self) -> dict:
        return dict(
            env_spec=self.config.env,
            num_envs=self.config.num_envs_per_env_runner,
            rollout_fragment_length=self.config.rollout_fragment_length,
            seed=self.config.seed,
            hidden=tuple(self.config.hidden),
            module_cls=self._module_cls(),
            env_to_module_connector=self.config.env_to_module_connector,
            module_to_env_connector=self.config.module_to_env_connector,
            device=self.config.device,
        )

    def _runner_cls(self, index: int):
        from ray_tpu_torch.accelerators.gpu import card_share_options
        from ray_tpu_torch.rl.learner import gpu_share

        gpus = gpu_share(self.config.device, ENV_RUNNER_GPUS)
        return ray_tpu_torch.remote(EnvRunner).options(**card_share_options(index, gpus))

    def _module_cls(self):
        from ray_tpu_torch.rl.rl_module import ActorCriticModule

        return ActorCriticModule

    def _make_runners(self):
        n = self.config.num_env_runners
        if n <= 0:
            self._local_runner = EnvRunner(**self._runner_kwargs())
            return
        for i in range(n):
            kw = self._runner_kwargs()
            kw["worker_index"] = i
            kw["seed"] = None if self.config.seed is None else self.config.seed + i
            self._runner_actors.append(self._runner_cls(i).remote(**kw))
        ray_tpu_torch.get([a.ping.remote() for a in self._runner_actors])

    def foreach_runner(self, method: str, *args) -> list:
        """Fan a method out to all runners (reference:
        ``WorkerSet.foreach_worker`` with fault-tolerant apply). A runner
        that died is restarted in-place (``restart_failed_env_runners``) and
        its result for this round is skipped — mirroring the reference's
        ``FaultAwareApply`` semantics."""
        from ray_tpu_torch.exceptions import RayActorError

        if self._local_runner is not None:
            return [getattr(self._local_runner, method)(*args)]
        futures = [getattr(a, method).remote(*args) for a in self._runner_actors]
        results = []
        for i, f in enumerate(futures):
            try:
                results.append(ray_tpu_torch.get(f))
            except RayActorError:
                if not self.config.restart_failed_env_runners:
                    raise
                self.restart_runner(i)
        if not results:
            raise RuntimeError(f"All {len(futures)} env runners failed in {method!r}")
        return results

    def restart_runner(self, index: int) -> None:
        """Replace a dead runner actor with a fresh one carrying the current
        weights (reference: EnvRunnerGroup._restored_workers path)."""
        try:
            ray_tpu_torch.kill(self._runner_actors[index])
        except Exception as e:
            from ray_tpu_torch._private.log_util import warn_throttled

            # usually already dead (that's why it's being replaced)
            warn_throttled("rl algorithm: runner kill", e)
        kw = self._runner_kwargs()
        kw["worker_index"] = index
        kw["seed"] = None if self.config.seed is None else self.config.seed + index
        actor = self._runner_cls(index).remote(**kw)
        try:
            weights = self.get_weights()
        except (AttributeError, NotImplementedError):
            weights = None  # during _setup, before the learner exists
        if weights is not None:
            from ray_tpu_torch.rl.learner import host_weights

            actor.set_weights.remote(host_weights(weights))
        # stateful connectors (running normalizers) must not restart cold:
        # clone state from any surviving runner
        if self.config.env_to_module_connector or self.config.module_to_env_connector:
            for j, other in enumerate(self._runner_actors):
                if j == index:
                    continue
                try:
                    state = ray_tpu_torch.get(other.get_connector_state.remote(), timeout=10)
                    actor.set_connector_state.remote(state)
                    break
                except Exception as e:
                    from ray_tpu_torch._private.log_util import warn_throttled

                    # this donor may be dead too — try the next survivor,
                    # but don't let every-donor-failing go unreported (the
                    # new runner would restart with cold normalizer state)
                    warn_throttled("rl algorithm: connector-state clone", e)
                    continue
        self._runner_actors[index] = actor

    def sync_weights(self, params) -> None:
        if self._runner_actors:  # host arrays travel; device tensors would not
            from ray_tpu_torch.rl.learner import host_weights

            params = host_weights(params)
        self.foreach_runner("set_weights", params)

    # -- Trainable surface --------------------------------------------------

    def _setup(self):
        raise NotImplementedError

    def training_step(self) -> dict:
        raise NotImplementedError

    def train(self) -> dict:
        t0 = time.time()
        result = self.training_step()
        self.iteration += 1
        stats = [s for s in self.foreach_runner("episode_stats") if s["episodes"]]
        if stats:
            self._episode_return_mean = float(
                np.average(
                    [s["episode_return_mean"] for s in stats],
                    weights=[s["episodes"] for s in stats],
                )
            )
        result.update(
            {
                "training_iteration": self.iteration,
                "episode_return_mean": self._episode_return_mean,
                # reference's legacy key name, used by its tuned examples
                "episode_reward_mean": self._episode_return_mean,
                "num_env_steps_sampled_lifetime": self._timesteps_total,
                "timesteps_total": self._timesteps_total,
                "time_this_iter_s": time.time() - t0,
            }
        )
        return result

    def stop(self):
        from ray_tpu_torch._private.log_util import warn_throttled

        for a in self._runner_actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception as e:
                # best-effort teardown, but leaking runner actors on every
                # stop must not be silent
                warn_throttled("rl algorithm: runner kill", e)
        lg = getattr(self, "learner_group", None)
        if lg is not None:
            lg.shutdown()

    # -- checkpointing ------------------------------------------------------

    def get_state(self) -> dict:
        from ray_tpu_torch.rl.learner import host_weights

        return {
            "weights": host_weights(self.get_weights()),
            "iteration": self.iteration,
            "timesteps": self._timesteps_total,
        }

    def set_state(self, state: dict) -> None:
        self.set_weights(state["weights"])
        self.iteration = state.get("iteration", 0)
        self._timesteps_total = state.get("timesteps", 0)

    def get_weights(self):
        raise NotImplementedError

    def set_weights(self, params):
        raise NotImplementedError

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "wb") as f:
            pickle.dump(self.get_state(), f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            self.set_state(pickle.load(f))

    @classmethod
    def as_trainable(cls, base_config: AlgorithmConfig) -> Callable:
        """Function trainable for the port's tune: loops train() forever,
        reporting each iteration with a checkpoint (reference: Algorithm IS
        a class Trainable; tune here runs function trainables)."""

        def trainable(config: dict):
            import tempfile

            from ray_tpu_torch import tune
            from ray_tpu_torch.train import Checkpoint

            cfg = base_config.copy().update_from_dict(config or {})
            algo = cfg.build()
            ckpt = tune.get_checkpoint()
            if ckpt:
                algo.restore(ckpt.path)
            try:
                while True:
                    result = algo.train()
                    d = tempfile.mkdtemp(prefix="rl_ckpt_")
                    algo.save(d)
                    tune.report(result, checkpoint=Checkpoint(d))
            finally:
                algo.stop()

        trainable.__name__ = cls.__name__
        return trainable
