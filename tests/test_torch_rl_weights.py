"""``get_weights()`` is a snapshot in the port, as in the reference.

The reference's ``Learner.get_weights`` hands out its tree of immutable jax
arrays, which every update replaces, so a held result keeps the values it
had. The port's optimizers and target syncs write the parameters in place,
so ``Learner.get_weights`` and ``Dreamer.get_weights`` return clones; a
caller that reads the weights at once takes ``weights_view()`` instead (no
copy), and that view follows the weights.
"""

import numpy as np
import pytest

from ray_tpu_torch.rl.algorithms.dqn import DQNConfig
from ray_tpu_torch.rl.algorithms.dreamer import DreamerConfig


def _dqn():
    return (
        DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=4, rollout_fragment_length=32)
        .training(train_batch_size=32, learning_starts=64, sample_steps_per_iter=128,
                  updates_per_iter=4, target_update_freq=64)
        .debugging(seed=0)
        .resources(device="cpu")
        .build()
    )


def _dreamer():
    return (
        DreamerConfig()
        .environment("CartPole-v1")
        .training(sample_steps_per_iter=64, learning_starts=64, updates_per_iter=2,
                  train_batch_size=16, imagination_horizon=3, latent_dim=16, hidden=(32, 32))
        .debugging(seed=0)
        .resources(device="cpu")
        .build()
    )


def _host(weights: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in weights.items()}


@pytest.mark.parametrize("build", [_dqn, _dreamer], ids=["DQN", "Dreamer"])
def test_held_weights_keep_their_values_across_train(build):
    algo = build()
    try:
        held = algo.get_weights()
        before = _host(held)
        for _ in range(2):
            algo.train()
        after = _host(algo.get_weights())
        # the updates moved the weights ...
        assert any(not np.array_equal(before[k], after[k]) for k in before)
        # ... and the dict held from before them did not follow
        for k, v in _host(held).items():
            np.testing.assert_array_equal(v, before[k], err_msg=k)
    finally:
        algo.stop()


def test_weights_view_follows_the_learner():
    algo = _dqn()
    try:
        view = algo.learner_group.weights_view()
        snap = algo.learner_group.get_weights()
        algo.train()
        live = _host(algo.learner_group.weights_view())
        assert all(np.array_equal(v, live[k]) for k, v in _host(view).items())
        assert any(not np.array_equal(v, live[k]) for k, v in _host(snap).items())
    finally:
        algo.stop()
