"""The port's async and gradient-free algorithms (IMPALA, APPO, ES) and
multi-agent envs (``ray_tpu_torch.rl``) against the reference's
``ray_tpu.rl``, on the CPU.

Parity (fp32, 1e-5 unless said): V-trace on random (N, T) sequences with
dones; the IMPALA and APPO losses (with and without the KL term) and every
gradient against ``jax.grad`` with the reference's weights carried across;
one ES ``training_step`` from the same theta given the same returns (the
flat vector in ``ravel_pytree``'s order, float64: 1e-12); multi-agent
vector slots under one seed and the same actions. Mirrors: the IMPALA,
V-trace and multi-agent tests of ``tests/test_rl.py``, ``tests/
test_rl_appo.py`` and ``tests/test_rl_es.py`` (the learning tests slow,
as in the reference).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_tpu_torch
from ray_tpu.rl.algorithms.appo import appo_loss as ref_appo_loss
from ray_tpu.rl.algorithms.es import ES as RefES
from ray_tpu.rl.algorithms.es import ESConfig as RefESConfig
from ray_tpu.rl.algorithms.impala import impala_loss as ref_impala_loss
from ray_tpu.rl.algorithms.impala import vtrace as ref_vtrace
from ray_tpu.rl.env import make_vector_env as ref_make_vector_env
from ray_tpu.rl.multi_agent import EchoCoopEnv as RefEchoCoopEnv
from ray_tpu.rl.rl_module import ActorCriticModule as RefAC
from ray_tpu.rl.rl_module import RLModuleSpec as RefSpec
from ray_tpu.rl.spaces import Box as RefBox
from ray_tpu.rl.spaces import Discrete as RefDiscrete
from ray_tpu_torch.rl import IMPALAConfig, MultiAgentVectorEnv, PPOConfig
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithms.appo import APPOConfig, appo_loss
from ray_tpu_torch.rl.algorithms.es import ES, ESConfig
from ray_tpu_torch.rl.algorithms.impala import impala_loss, vtrace
from ray_tpu_torch.rl.env import make_vector_env
from ray_tpu_torch.rl.learner import tree_leaf
from ray_tpu_torch.rl.multi_agent import EchoCoopEnv
from ray_tpu_torch.rl.rl_module import RLModuleSpec, params_from_jax
from ray_tpu_torch.rl.spaces import Box, Discrete

TOL = dict(rtol=1e-5, atol=1e-5)
N, T = 4, 12


def _vtrace_inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (0.5 * f(N, T), 0.5 * f(N, T), f(N, T), rng.random((N, T)) < 0.15, f(N, T), f(N))


@pytest.mark.parametrize("seed,gamma,rho,c", [(0, 0.99, 1.0, 1.0), (1, 0.9, 0.8, 1.2)])
def test_vtrace_matches_the_reference(seed, gamma, rho, c):
    args = _vtrace_inputs(seed)
    want = ref_vtrace(*[jnp.asarray(a) for a in args], gamma, rho, c)
    got = vtrace(*[torch.from_numpy(a) for a in args], gamma, rho, c)
    for g, w, name in zip(got, want, ("vs", "pg_adv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)


def test_vtrace_reduces_to_discounted_returns_on_policy():
    """With target==behavior logp (rho=1) and exact values=0, vs must equal
    discounted returns — the standard V-trace sanity identity."""
    logp = torch.zeros((1, 4))
    rewards = torch.ones((1, 4))
    dones = torch.zeros((1, 4))
    values = torch.zeros((1, 4))
    boot = torch.zeros((1,))
    vs, pg_adv = vtrace(logp, logp, rewards, dones, values, boot, 0.5, 1.0, 1.0)
    expect = [1 + 0.5 * (1 + 0.5 * (1 + 0.5 * 1)), 1 + 0.5 * (1 + 0.5 * 1), 1.5, 1.0]
    np.testing.assert_allclose(vs.numpy()[0], expect, rtol=1e-5)


def _sequence_batch(ref, tree, seed):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((N, T, 4)).astype(np.float32)
    actions = rng.integers(0, 3, (N, T))
    logp = np.asarray(ref.logp_entropy_value(tree, obs, actions)[0])
    return {
        sb.OBS: obs,
        sb.ACTIONS: actions,
        sb.REWARDS: rng.standard_normal((N, T)).astype(np.float32),
        sb.TERMINATEDS: rng.random((N, T)) < 0.15,
        # behavior logp off the target one, so rho and the surrogate clip
        sb.LOGP: (logp + 0.4 * rng.standard_normal((N, T))).astype(np.float32),
        "bootstrap_value": rng.standard_normal(N).astype(np.float32),
    }


LOSSES = {
    "impala": ((0.99, 1.0, 1.0, 0.5, 0.01), ref_impala_loss, impala_loss),
    "appo": ((0.99, 1.0, 1.0, 0.5, 0.01, 0.3, False, 0.2), ref_appo_loss, appo_loss),
    "appo_kl": ((0.99, 1.0, 1.0, 0.5, 0.01, 0.3, True, 0.2), ref_appo_loss, appo_loss),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_impala_and_appo_losses_and_gradients_match(name):
    args, ref_fn, fn = LOSSES[name]
    obs_space, act_space = Box(-1, 1, shape=(4,)), Discrete(3)
    ref = RefAC(RefSpec(RefBox(-1, 1, shape=(4,)), RefDiscrete(3), hidden=(32, 32)))
    tree = jax.device_get(ref.init(jax.random.PRNGKey(0)))
    port = params_from_jax(tree, RLModuleSpec(obs_space, act_space, hidden=(32, 32)), "cpu")
    batch = _sequence_batch(ref, tree, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, ref_m), ref_grads = jax.value_and_grad(
        lambda p: ref_fn(*args)(ref, p, jb), has_aux=True)(tree)
    loss, metrics = fn(*args)(port, port, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **TOL)
    assert set(metrics) == set(ref_m)
    for key, value in ref_m.items():
        np.testing.assert_allclose(metrics[key].item(), float(value), **TOL, err_msg=key)
    ref_grads = jax.device_get(ref_grads)
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), tree_leaf(ref_grads, n), **TOL, err_msg=n)


# ---------------------------------------------------------------------------
# ES
# ---------------------------------------------------------------------------


def _es_config(cls, num_env_runners=0, seed=0):
    cfg = cls()
    cfg.env = "CartPole-v1"
    cfg.seed = seed
    cfg.num_env_runners = num_env_runners
    cfg.num_rollouts = 8
    cfg.sigma = 0.3
    cfg.lr = 0.2
    cfg.top_frac = 0.5
    cfg.eval_max_steps = 1000
    cfg.hidden = [32]
    if cls is ESConfig:
        cfg.device = "cpu"
    return cfg


def _scripted_returns(algo, returns):
    """Make the algorithm's local runner report ``returns`` in call order."""
    it = iter(returns)
    algo._local_runner.eval_return = lambda params, episodes, max_steps: {
        "episodes": 1, "return_mean": float(next(it)), "steps": 10}


def test_es_step_matches_the_reference_given_the_same_returns():
    ref, port = RefES(_es_config(RefESConfig, seed=7)), ES(_es_config(ESConfig, seed=7))
    try:
        tree = jax.device_get(ref.get_weights())
        port.set_weights({n: tree_leaf(tree, n) for n in port.get_weights()})
        # the flat vectors agree: ravel_pytree's order on both sides
        np.testing.assert_array_equal(port._theta, ref._theta)
        returns = np.random.default_rng(3).normal(20, 8, 2 * 8 + 1)
        for algo in (ref, port):
            _scripted_returns(algo, returns)
        want, got = ref.training_step(), port.training_step()
        np.testing.assert_allclose(port._theta, ref._theta, rtol=1e-12, atol=1e-12)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12, err_msg=key)
        unravelled = port.get_weights()
        tree = jax.device_get(ref.get_weights())
        for n, v in unravelled.items():
            assert v.dtype == np.float32
            np.testing.assert_array_equal(v, tree_leaf(tree, n))
    finally:
        ref.stop()
        port.stop()


def test_es_learns_cartpole_local():
    algo = ES(_es_config(ESConfig))
    best = 0.0
    try:
        for _ in range(25):
            result = algo.train()
            ret = result.get("episode_return_mean") or 0.0
            best = max(best, ret)
            if best >= 100.0:
                break
    finally:
        algo.stop()
    assert best >= 100.0, f"ES did not learn: best return {best}"


def test_es_update_is_deterministic_given_seed():
    a = ES(_es_config(ESConfig, seed=7))
    b = ES(_es_config(ESConfig, seed=7))
    try:
        a.train()
        b.train()
        assert np.allclose(a._theta, b._theta)
    finally:
        a.stop()
        b.stop()


def test_es_registered_for_tune():
    from ray_tpu_torch.tune.registry import resolve_trainable

    assert resolve_trainable("ES") is not None
    assert resolve_trainable("ARS") is not None


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def test_es_distributed_runners(cluster):
    algo = ES(_es_config(ESConfig, num_env_runners=2))
    try:
        result = algo.train()
        assert result["training_iteration"] == 1
        assert result["timesteps_total"] > 0
        assert result.get("episode_return_mean") is not None
    finally:
        algo.stop()


# ---------------------------------------------------------------------------
# IMPALA / APPO mirrors
# ---------------------------------------------------------------------------


def test_impala_training_step_smoke_local():
    algo = (
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=4, rollout_fragment_length=16)
        .training(train_batch_size=64)
        .resources(device="cpu")
        .build()
    )
    try:
        result = algo.train()
        assert "learner/policy_loss" in result
        assert result["timesteps_total"] >= 64
    finally:
        algo.stop()


def test_impala_async_runners_train_and_receive_weights(cluster):
    """Two runner actors: the driver consumes whichever rollout lands first,
    updates, and pushes the learner's weights to that runner."""
    algo = (
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2, rollout_fragment_length=16)
        .training(train_batch_size=128)
        .resources(device="cpu")
        .build()
    )
    try:
        result = algo.train()
        assert result["num_env_steps_sampled"] >= 128
        assert np.isfinite(result["learner/policy_loss"])
        learner = {k: v.numpy() for k, v in algo.get_weights().items()}
        pushed = [ray_tpu_torch.get(a.get_weights.remote()) for a in algo._runner_actors]
        # the runner drained last holds the learner's latest weights
        assert any(all(np.array_equal(w[k], learner[k]) for k in learner) for w in pushed)
    finally:
        algo.stop()


@pytest.mark.slow
def test_impala_async_runners_learn(cluster):
    algo = (
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=64)
        .training(train_batch_size=1024, lr=5e-4, entropy_coeff=0.005)
        .debugging(seed=0)
        .resources(device="cpu")
        .build()
    )
    try:
        best = max(algo.train()["episode_return_mean"] or 0.0 for _ in range(25))
        assert best >= 100.0, f"IMPALA failed to improve on CartPole: best {best}"
    finally:
        algo.stop()


@pytest.mark.slow
def test_appo_learns_cartpole(cluster):
    algo = (
        APPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2, rollout_fragment_length=50)
        .training(train_batch_size=1200, lr=5e-4, entropy_coeff=0.01)
        .debugging(seed=0)
        .resources(device="cpu")
        .build()
    )
    best = 0.0
    try:
        for _ in range(25):
            ret = algo.train().get("episode_return_mean")
            if ret is not None:
                best = max(best, ret)
            if best >= 150.0:
                break
    finally:
        algo.stop()
    assert best >= 150.0, f"APPO failed to learn CartPole (best={best})"


def test_appo_kl_penalty_reported():
    algo = (
        APPOConfig()
        .environment("CartPole-v1")
        .training(train_batch_size=300, use_kl_loss=True)
        .debugging(seed=0)
        .resources(device="cpu")
        .build()
    )
    try:
        res = algo.train()
    finally:
        algo.stop()
    assert "learner/kl" in res and np.isfinite(res["learner/kl"])
    assert res["learner/kl"] >= -1e-6  # k3 estimator is non-negative


def test_appo_registered():
    from ray_tpu_torch.rl import get_algorithm_class

    assert get_algorithm_class("APPO") is not None


# ---------------------------------------------------------------------------
# multi-agent
# ---------------------------------------------------------------------------


def test_multi_agent_vector_env_matches_the_reference_under_one_seed():
    port = make_vector_env(lambda: EchoCoopEnv(episode_len=5), 3, seed=4)
    ref = ref_make_vector_env(lambda: RefEchoCoopEnv(episode_len=5), 3, seed=4)
    assert isinstance(port, MultiAgentVectorEnv) and port.n == ref.n == 6
    np.testing.assert_array_equal(port.reset(), ref.reset())
    actions = np.random.default_rng(0).integers(0, 2, (12, 6))
    for a in actions:  # episodes end at 5 steps and auto-reset on both sides
        for x, y in zip(port.step(a), ref.step(a)):
            np.testing.assert_array_equal(x, y)


def test_multi_agent_vector_env_slots():
    vec = make_vector_env(lambda: EchoCoopEnv(episode_len=4), 3, seed=0)
    assert vec.n == 6  # 3 envs x 2 agents
    obs = vec.reset()
    assert obs.shape == (6, 2)
    # both agents of one env see the same observation
    np.testing.assert_array_equal(obs[0], obs[1])
    # perfect play: the action is the bit, obs[0]
    obs2, rew, term, trunc, final = vec.step(1 - np.argmax(obs, -1))
    np.testing.assert_allclose(rew, 1.5)  # both correct -> 1 + 0.5 each
    # episodes truncate after 4 steps and auto-reset
    for _ in range(3):
        obs2, rew, term, trunc, final = vec.step(np.zeros(6, np.int64))
    assert trunc.all()


@pytest.mark.slow
def test_shared_policy_ppo_learns_multi_agent():
    """PPO trains ONE shared policy over all agents of a MultiAgentEnv via
    the slot-flattened vector view; coordination reward improves toward the
    1.5/step optimum."""
    algo = (
        PPOConfig()
        .environment(lambda: EchoCoopEnv(episode_len=16))
        .env_runners(num_env_runners=0, num_envs_per_env_runner=4, rollout_fragment_length=64)
        .training(train_batch_size=1024, minibatch_size=256, num_epochs=4, lr=1e-3)
        .debugging(seed=0)
        .resources(device="cpu")
        .build()
    )
    try:
        # per-slot episode return: optimum 16*1.5=24; random ~12
        best = 0.0
        for _ in range(25):
            best = max(best, algo.train()["episode_return_mean"] or 0.0)
            if best >= 20.0:
                break
        assert best >= 20.0, f"shared-policy PPO failed: best {best}"
    finally:
        algo.stop()
