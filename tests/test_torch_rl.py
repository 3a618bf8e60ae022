"""The port's ``rl`` core and PPO (``ray_tpu_torch.rl``) against the
reference's ``ray_tpu.rl``, on the CPU.

Parity: the same seeded numpy inputs, with the reference's weights carried
across (``rl_module.params_from_jax``), go through both packages — GAE,
CartPole trajectories under the same seed and actions, ``ActorCriticModule``
logp/entropy/value (MLP discrete and continuous, CNN on pixels), the PPO
loss and its gradients, and three ``Learner.update`` steps against the
reference's ``optax`` chain with the clip active and inactive (fp32, 1e-5).
Mirrors: the non-slow tests of ``tests/test_rl.py`` for the core and PPO,
the connector tests of ``tests/test_rl_connectors_td3.py`` and
``tests/test_rl_scale.py``, the learner-group DDP test (slow, as in the
reference), every name the reference's ``rl`` exports and every RL
algorithm name resolving to the port's, and ``tune.run("PPO")`` resolving
and running one iteration.
"""

import numpy as np
import pytest
import torch

import jax

import ray_tpu_torch
from ray_tpu.rl import sample_batch as ref_sb
from ray_tpu.rl.algorithms.ppo import ppo_loss as ref_ppo_loss
from ray_tpu.rl.env import SyncVectorEnv as RefSyncVectorEnv
from ray_tpu.rl.learner import Learner as RefLearner
from ray_tpu.rl.rl_module import ActorCriticModule as RefAC
from ray_tpu.rl.rl_module import RLModuleSpec as RefSpec
from ray_tpu.rl.sample_batch import compute_gae as ref_compute_gae
from ray_tpu.rl.spaces import Box as RefBox
from ray_tpu.rl.spaces import Discrete as RefDiscrete
from ray_tpu_torch.rl import PPOConfig, SampleBatch, SyncVectorEnv, compute_gae
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithms.ppo import ppo_loss
from ray_tpu_torch.rl.connectors import (
    ClipActions,
    ClipObservations,
    ConnectorPipeline,
    FlattenObservations,
    FrameStack,
    GaussianActionNoise,
    GrayscaleObservations,
    NormalizeObservations,
    ResizeObservations,
    ScaleObservations,
)
from ray_tpu_torch.rl.learner import Learner, LearnerGroup, host_weights
from ray_tpu_torch.rl.rl_module import ActorCriticModule, RLModuleSpec, params_from_jax
from ray_tpu_torch.rl.spaces import Box, Discrete

TOL = dict(rtol=1e-5, atol=1e-5)

SPECS = {
    "discrete": ((4,), None),
    "continuous": ((3,), (1,)),
    "pixels": ((21, 21, 2), None),
}


def _specs(kind, hidden=(32, 32)):
    obs_shape, act_shape = SPECS[kind]
    obs, ref_obs = Box(-1, 1, shape=obs_shape), RefBox(-1, 1, shape=obs_shape)
    if act_shape is None:
        act, ref_act = Discrete(3), RefDiscrete(3)
    else:
        act, ref_act = Box(-2, 2, shape=act_shape), RefBox(-2, 2, shape=act_shape)
    return RLModuleSpec(obs, act, hidden=hidden), RefSpec(ref_obs, ref_act, hidden=hidden)


def _ref_module(kind, seed=0):
    spec, ref_spec = _specs(kind)
    ref = RefAC(ref_spec)
    tree = jax.device_get(ref.init(jax.random.PRNGKey(seed)))
    return spec, ref, tree, params_from_jax(tree, spec, "cpu")


def _ref_leaf(tree, name):
    """The reference tree's leaf under a port parameter name ("pi.w.0")."""
    parts = name.split(".")
    if parts[0] == "log_std":
        return tree["log_std"]
    return tree[parts[0]][int(parts[2])][parts[1]]


def _inputs(kind, n=16, seed=1):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((n,) + SPECS[kind][0]).astype(np.float32)
    if SPECS[kind][1] is None:
        actions = rng.integers(0, 3, n)
    else:
        actions = rng.standard_normal((n,) + SPECS[kind][1]).astype(np.float32)
    return obs, actions


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def test_gae_matches_the_reference():
    rng = np.random.default_rng(0)
    T, N = 40, 5
    args = (
        rng.standard_normal((T, N)).astype(np.float32),
        rng.standard_normal((T, N)).astype(np.float32),
        rng.random((T, N)) < 0.05,
        rng.random((T, N)) < 0.05,
        rng.standard_normal(N).astype(np.float32),
    )
    tv = rng.standard_normal((T, N)).astype(np.float32)
    for kw in ({}, {"truncation_values": tv}, {"gamma": 0.9, "lam": 0.8}):
        for got, want in zip(compute_gae(*args, **kw), ref_compute_gae(*args, **kw)):
            np.testing.assert_array_equal(got, want)


def test_cartpole_trajectories_match_under_the_same_seed_and_actions():
    port = SyncVectorEnv("CartPole-v1", 3, seed=5)
    ref = RefSyncVectorEnv("CartPole-v1", 3, seed=5)
    np.testing.assert_array_equal(port.reset(), ref.reset())
    actions = np.random.default_rng(0).integers(0, 2, (300, 3))
    dones = 0
    for a in actions:
        got, want = port.step(a), ref.step(a)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
        dones += int((got[2] | got[3]).sum())
    assert dones > 3  # episodes ended and auto-reset on both sides


@pytest.mark.parametrize("kind", list(SPECS))
def test_actor_critic_logp_entropy_value_match(kind):
    spec, ref, tree, port = _ref_module(kind)
    obs, actions = _inputs(kind)
    want = [np.asarray(x) for x in ref.logp_entropy_value(tree, obs, actions)]
    got = port.logp_entropy_value(torch.from_numpy(obs), torch.from_numpy(actions))
    for name, g, w in zip(("logp", "entropy", "value"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL, err_msg=name)
    out, ref_out = port(torch.from_numpy(obs)), ref.apply(tree, obs)
    for key in ref_out:
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref_out[key]), **TOL)


def test_sampled_actions_score_their_own_logp():
    """``sample_action``'s logp is ``logp_entropy_value``'s for the drawn
    actions, and a fixed generator seed reproduces the draw."""
    for kind in ("discrete", "continuous"):
        spec, _, _, port = _ref_module(kind)
        obs = torch.from_numpy(_inputs(kind, n=64)[0])
        a1, lp1, v1 = port.sample_action(obs, torch.Generator().manual_seed(3))
        a2, _, _ = port.sample_action(obs, torch.Generator().manual_seed(3))
        assert torch.equal(a1, a2)
        lp, _, v = port.logp_entropy_value(obs, a1)
        torch.testing.assert_close(lp1, lp)
        torch.testing.assert_close(v1, v)


def _ppo_batch(kind, ref, tree, n=64, seed=2):
    obs, actions = _inputs(kind, n=n, seed=seed)
    rng = np.random.default_rng(seed + 10)
    logp = np.asarray(ref.logp_entropy_value(tree, obs, actions)[0])
    return SampleBatch({
        sb.OBS: obs,
        sb.ACTIONS: actions,
        # behavior logp off the current one, so the ratio clips somewhere
        sb.LOGP: (logp + 0.3 * rng.standard_normal(n)).astype(np.float32),
        sb.ADVANTAGES: rng.standard_normal(n).astype(np.float32),
        sb.VALUE_TARGETS: (3 * rng.standard_normal(n)).astype(np.float32),
    })


LOSS_ARGS = (0.2, 1.0, 0.5, 0.01)  # clip, vf clip (active on these targets), vf coeff, entropy coeff


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_ppo_loss_and_gradients_match(kind):
    spec, ref, tree, port = _ref_module(kind)
    batch = _ppo_batch(kind, ref, tree)
    ref_fn = ref_ppo_loss(*LOSS_ARGS)
    (ref_loss, ref_m), ref_grads = jax.value_and_grad(
        lambda p: ref_fn(ref, p, {k: jax.numpy.asarray(v) for k, v in batch.items()}), has_aux=True
    )(tree)
    loss, metrics = ppo_loss(*LOSS_ARGS)(port, port, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **TOL)
    for key, value in ref_m.items():
        np.testing.assert_allclose(metrics[key].item(), float(value), **TOL, err_msg=key)
    ref_grads = jax.device_get(ref_grads)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _ref_leaf(ref_grads, name), **TOL, err_msg=name)


@pytest.mark.parametrize("grad_clip", [0.05, 1e6], ids=["clip_active", "clip_inactive"])
def test_three_learner_updates_match_optax(grad_clip):
    kind = "discrete"
    spec, ref_spec = _specs(kind)
    ref = RefLearner(lambda: RefAC(ref_spec), ref_ppo_loss(*LOSS_ARGS), lr=1e-2,
                     grad_clip=grad_clip, seed=3, data_parallel=False)
    port = Learner(lambda: ActorCriticModule(spec), ppo_loss(*LOSS_ARGS), lr=1e-2,
                   grad_clip=grad_clip, seed=3, device="cpu")
    tree = jax.device_get(ref.params)
    port.set_weights(params_from_jax(tree, spec, "cpu").state_dict())
    for step in range(3):
        batch = _ppo_batch(kind, RefAC(ref_spec), jax.device_get(ref.params), seed=20 + step)
        want, got = ref.update(batch), port.update(batch)
        assert (got["grad_norm"] > grad_clip) == (grad_clip < 1)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=f"step {step} {key}")
        tree = jax.device_get(ref.params)
        for name, value in port.get_weights().items():
            np.testing.assert_allclose(value.numpy(), _ref_leaf(tree, name), **TOL,
                                       err_msg=f"step {step} {name}")


def test_host_weights_makes_numpy_views_of_one_transfer():
    spec, _, tree, port = _ref_module("pixels")
    host = host_weights(port)
    assert list(host) == list(port.state_dict())
    bases = {id(a.base if a.base is not None else a) for a in host.values()}
    assert len(bases) == 1  # every array views one buffer
    for name, a in host.items():
        np.testing.assert_array_equal(a, _ref_leaf(tree, name))


# ---------------------------------------------------------------------------
# mirrors of tests/test_rl.py (ported modules, non-slow)
# ---------------------------------------------------------------------------


def test_gae_terminated_zeroes_bootstrap():
    T, N = 3, 1
    rewards = np.ones((T, N), np.float32)
    values = np.zeros((T, N), np.float32)
    term = np.zeros((T, N), bool)
    term[-1] = True
    trunc = np.zeros((T, N), bool)
    last_values = np.full((N,), 100.0, np.float32)  # must be ignored: terminated
    adv, targets = compute_gae(rewards, values, term, trunc, last_values, gamma=1.0, lam=1.0)
    assert adv[-1, 0] == pytest.approx(1.0)
    assert adv[0, 0] == pytest.approx(3.0)  # 1+1+1, undiscounted


def test_gae_truncated_bootstraps_true_final_value():
    T, N = 2, 1
    rewards = np.zeros((T, N), np.float32)
    values = np.zeros((T, N), np.float32)
    term = np.zeros((T, N), bool)
    trunc = np.zeros((T, N), bool)
    trunc[0] = True  # episode cut at t=0
    last_values = np.zeros((N,), np.float32)
    tv = np.zeros((T, N), np.float32)
    tv[0] = 5.0
    adv, _ = compute_gae(
        rewards, values, term, trunc, last_values, gamma=0.5, lam=1.0, truncation_values=tv
    )
    assert adv[0, 0] == pytest.approx(0.5 * 5.0)
    adv2, _ = compute_gae(
        rewards + 1.0, values, term, trunc, last_values, gamma=1.0, lam=1.0, truncation_values=tv
    )
    assert adv2[0, 0] == pytest.approx(1.0 + 5.0)


def test_vector_env_returns_pre_reset_final_obs():
    from ray_tpu_torch.rl.env import GridWorldEnv

    vec = SyncVectorEnv(lambda: GridWorldEnv(n=3), 1, seed=0)
    vec.reset()
    obs, rew, term, trunc, final = vec.step(np.array([1]))
    assert not term[0]
    assert final[0, 0] == obs[0, 0] == 1.0
    obs, rew, term, trunc, final = vec.step(np.array([1]))
    assert term[0]
    assert final[0, 0] == 2.0      # the TRUE terminal obs
    assert obs[0, 0] == 0.0        # auto-reset obs the policy acts on next


def test_dqn_transitions_store_true_next_obs():
    from ray_tpu_torch.rl.env import GridWorldEnv
    from ray_tpu_torch.rl.env_runner import EnvRunner
    from ray_tpu_torch.rl.rl_module import QModule

    r = EnvRunner(lambda: GridWorldEnv(n=3), num_envs=1, seed=0, module_cls=QModule, device="cpu")
    r.set_epsilon(0.5)  # explore so some episodes actually terminate at goal
    batch = r.sample_transitions(200)
    term = batch[sb.TERMINATEDS]
    assert term.any()
    assert (batch[sb.NEXT_OBS][term][:, 0] == 2.0).all()
    assert sb.TRUNCATEDS in batch


def test_ppo_training_step_smoke():
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=4, rollout_fragment_length=32)
        .training(train_batch_size=128, minibatch_size=64, num_epochs=2)
        .resources(device="cpu")
        .build()
    )
    try:
        result = algo.train()
        assert result["training_iteration"] == 1
        assert result["timesteps_total"] >= 128
        assert "learner/policy_loss" in result
    finally:
        algo.stop()


def _run_until(algo, key, target, max_iters):
    best = -np.inf
    for _ in range(max_iters):
        r = algo.train()
        if r.get(key) is not None:
            best = max(best, r[key])
        if best >= target:
            break
    return best, algo.iteration


@pytest.mark.slow
def test_ppo_learns_cartpole():
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8, rollout_fragment_length=128)
        .training(train_batch_size=1024, minibatch_size=128, num_epochs=6, lr=1e-3)
        .debugging(seed=0)
        .resources(device="cpu")
        .build()
    )
    try:
        best, _ = _run_until(algo, "episode_return_mean", 150.0, max_iters=30)
        assert best >= 150.0, f"PPO failed to learn CartPole: best {best}"
    finally:
        algo.stop()


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=6, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def test_env_runner_fault_tolerance(cluster):
    """Kill an env-runner actor mid-training: training continues and the
    runner pool is healed (reference: restart_failed_env_runners)."""
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2, rollout_fragment_length=32)
        .training(train_batch_size=128, minibatch_size=64, num_epochs=1)
        .resources(device="cpu")
        .build()
    )
    try:
        algo.train()
        victim = algo._runner_actors[0]
        ray_tpu_torch.kill(victim)
        result = algo.train()  # must not raise; dead runner replaced
        assert result["training_iteration"] == 2
        assert algo._runner_actors[0] is not victim
        assert all(algo.foreach_runner("ping"))
    finally:
        algo.stop()


def test_runners_on_the_card_need_a_gpu(cluster):
    """Built for the card (the default device), remote env runners ask for a
    GPU share: on a cluster without one, building the algorithm raises at
    once instead of sampling on the CPU."""
    config = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=2, rollout_fragment_length=16)
    )
    with pytest.raises(Exception, match="GPU"):
        config.build()


@pytest.mark.slow
def test_learner_group_two_learners_match_single(cluster):
    """2 data-parallel learners must evolve weights IDENTICALLY to one
    learner on the full batch (grads averaged sample-weighted; every
    learner applies the same update — the DDP invariant)."""
    spec = RLModuleSpec(Box(-1, 1, shape=(4,)), Discrete(2))

    def loss_fn(module, params, batch):
        logp, entropy, value = params.logp_entropy_value(batch["obs"], batch["act"])
        loss = -(logp * batch["adv"]).mean() + ((value - batch["ret"]) ** 2).mean()
        return loss, {"policy_loss": loss}

    kwargs = dict(module_factory=lambda: ActorCriticModule(spec), loss_fn=loss_fn, lr=1e-2,
                  seed=7, device="cpu")
    rng = np.random.default_rng(0)

    def make_batch(n=64):
        return SampleBatch({
            "obs": rng.standard_normal((n, 4)).astype(np.float32),
            "act": rng.integers(0, 2, n),
            "adv": rng.standard_normal(n).astype(np.float32),
            "ret": rng.standard_normal(n).astype(np.float32),
        })

    batches = [make_batch() for _ in range(4)]
    single = Learner(**kwargs)
    for b in batches:
        single.update(b)
    group = LearnerGroup(dict(kwargs), num_learners=2)
    try:
        for b in batches:
            assert "policy_loss" in group.update(b)
        w_group, w_single = group.get_weights(), single.get_weights()
        for name, value in w_single.items():
            np.testing.assert_allclose(w_group[name], value.numpy(), rtol=1e-4, atol=1e-5)
        w0 = ray_tpu_torch.get(group._actors[0].get_host_weights.remote())
        w1 = ray_tpu_torch.get(group._actors[1].get_host_weights.remote())
        for name in w0:
            np.testing.assert_array_equal(w0[name], w1[name])
    finally:
        group.shutdown()


def test_tune_run_resolves_ppo_and_runs_it(cluster, tmp_path):
    """``tune.run("PPO")`` resolves through the rl registry (the algorithm's
    ``as_trainable``) and its trial trains and reports with a checkpoint."""
    from ray_tpu_torch import tune

    trainable = tune.resolve_trainable("PPO")
    assert trainable.__name__ == "PPO"
    grid = tune.run(
        "PPO",
        config={"env": "CartPole-v1", "device": "cpu", "num_envs_per_env_runner": 2,
                "rollout_fragment_length": 16,
                "train_batch_size": 32, "minibatch_size": 16, "num_epochs": 1},
        scheduler=tune.ASHAScheduler(metric="timesteps_total", mode="max", max_t=1, grace_period=1),
        metric="timesteps_total", mode="max", storage_path=str(tmp_path),
    )
    result = grid.get_best_result()
    assert result.metrics["training_iteration"] == 1
    assert result.metrics["timesteps_total"] >= 32
    assert result.checkpoint is not None


def _exported_names(package: str) -> list:
    """The names a reference ``__init__.py`` imports (its exports)."""
    import ast
    import importlib

    tree = ast.parse(open(importlib.import_module(package).__file__).read())
    return sorted({alias.asname or alias.name for node in ast.walk(tree)
                   if isinstance(node, ast.ImportFrom) for alias in node.names})


@pytest.mark.parametrize("package,name", [(p, n) for p in ("rl", "rl.algorithms")
                                          for n in _exported_names(f"ray_tpu.{p}")])
def test_every_reference_rl_export_resolves_to_the_ports(package, name):
    """Each name ``ray_tpu.rl`` and ``ray_tpu.rl.algorithms`` export is
    there in the port's package, as the same kind of thing under the same
    name, and comes from the port."""
    import importlib

    ref_pkg = importlib.import_module(f"ray_tpu.{package}")
    port, ref = getattr(importlib.import_module(f"ray_tpu_torch.{package}"), name), getattr(ref_pkg, name)
    assert type(port) is type(ref) or (isinstance(port, type) and isinstance(ref, type))
    leaf = lambda x: getattr(x, "__name__", name).rsplit(".", 1)[-1]  # noqa: E731  (modules too)
    assert leaf(port) == leaf(ref)
    assert getattr(port, "__module__", port.__name__).startswith("ray_tpu_torch.")


@pytest.mark.parametrize("name", sorted(__import__("ray_tpu_torch.tune.registry", fromlist=["x"])
                                        .RL_ALGORITHMS))
def test_every_rl_algorithm_name_resolves_in_tune(name):
    """``tune.resolve_trainable`` resolves each name the reference's rl
    registers (ARS to ES, as the reference does) to the port's algorithm."""
    from ray_tpu.rl import get_algorithm_class as ref_algorithm_class
    from ray_tpu_torch import tune
    from ray_tpu_torch.rl import get_algorithm_class

    cls = get_algorithm_class(name)
    assert cls.__module__.startswith("ray_tpu_torch.rl.algorithms.")
    assert cls.__name__ == ref_algorithm_class(name).__name__
    assert tune.resolve_trainable(name).__name__ == cls.__name__


def test_data_parallel_learner_over_several_cards_raises_citing_a8(monkeypatch):
    """The reference's ``data`` mesh over local devices is not ported: with
    two cards visible a data-parallel learner raises before it builds
    anything (the cards are faked); ``data_parallel=False`` gets past the
    check and stops only at the fake card."""
    spec = RLModuleSpec(Box(-1, 1, shape=(4,)), Discrete(2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="A8"):
        Learner(lambda: ActorCriticModule(spec), ppo_loss(*LOSS_ARGS))
    with pytest.raises(Exception) as err:
        Learner(lambda: ActorCriticModule(spec), ppo_loss(*LOSS_ARGS), data_parallel=False)
    assert not isinstance(err.value, NotImplementedError)


def test_multi_agent_env_makes_a_multi_agent_vector_env():
    from ray_tpu_torch.rl import MultiAgentVectorEnv
    from ray_tpu_torch.rl.env import make_vector_env
    from ray_tpu_torch.rl.multi_agent import EchoCoopEnv

    vec = make_vector_env(EchoCoopEnv, 2, seed=0)
    assert isinstance(vec, MultiAgentVectorEnv) and vec.n == 4


# ---------------------------------------------------------------------------
# connectors (mirrors of tests/test_rl_connectors_td3.py and test_rl_scale.py)
# ---------------------------------------------------------------------------


class TestConnectors:
    def test_flatten_and_clip(self):
        pipe = ConnectorPipeline([FlattenObservations(), ClipObservations(-1, 1)])
        out = pipe(np.full((4, 2, 3), 7.0))
        assert out.shape == (4, 6)
        assert (out == 1.0).all()

    def test_normalize_converges_to_unit_scale(self):
        norm = NormalizeObservations()
        rng = np.random.default_rng(0)
        out = None
        for _ in range(50):
            out = norm(rng.normal(5.0, 3.0, size=(64, 4)))
        assert abs(float(out.mean())) < 0.3
        assert 0.5 < float(out.std()) < 1.5

    def test_normalize_state_sync(self):
        a, b = NormalizeObservations(), NormalizeObservations()
        a(np.ones((32, 2)) * 5)
        b.set_state(a.get_state())
        np.testing.assert_allclose(b._mean, a._mean)
        assert b._count == a._count

    def test_clip_actions_and_noise(self):
        clip = ClipActions(low=[-1.0], high=[1.0])
        assert (clip(np.array([[3.0], [-3.0]])) == [[1.0], [-1.0]]).all()
        noise = GaussianActionNoise(0.5, low=-1.0, high=1.0, seed=0)
        out = noise(np.zeros((100, 1)))
        assert out.std() > 0.1 and (np.abs(out) <= 1.0).all()

    def test_runner_applies_connectors(self):
        from ray_tpu_torch.rl.env_runner import EnvRunner

        runner = EnvRunner(
            "Pendulum-v1",
            num_envs=2,
            rollout_fragment_length=10,
            seed=0,
            env_to_module_connector=lambda: NormalizeObservations(),
            module_to_env_connector=lambda: ClipActions(low=[-2.0], high=[2.0]),
            device="cpu",
        )
        batch = runner.sample_transitions(10)
        assert np.abs(batch["obs"]).max() <= 10.0
        state = runner.get_connector_state()
        assert state["env_to_module"]["count"] > 0
        assert runner.set_connector_state(state)


def _frame_pipeline():
    return ConnectorPipeline(
        [GrayscaleObservations(), ResizeObservations(21, 21), ScaleObservations(), FrameStack(2)]
    )


class TestFrameConnectors:
    def test_grayscale(self):
        rgb = np.zeros((2, 4, 4, 3), np.uint8)
        rgb[0, ..., 0] = 255  # pure red
        out = GrayscaleObservations()(rgb)
        assert out.shape == (2, 4, 4)
        assert abs(out[0, 0, 0] - 255 * 0.299) < 1e-3
        assert out[1].max() == 0

    def test_resize_nearest(self):
        x = np.arange(16, dtype=np.float32).reshape(1, 4, 4)
        out = ResizeObservations(2, 2)(x)
        assert out.shape == (1, 2, 2)
        assert out[0, 0, 0] == x[0, 0, 0]

    def test_scale(self):
        assert ScaleObservations()(np.array([[255]], np.uint8))[0, 0] == pytest.approx(1.0)

    def test_frame_stack_and_episode_reset(self):
        fs = FrameStack(3)
        f = lambda v: np.full((2, 2, 2), v, np.float32)  # noqa: E731
        s1 = fs(f(1.0))
        assert s1.shape == (2, 2, 2, 3)
        assert (s1 == 1.0).all()
        s2 = fs(f(2.0))
        assert list(s2[0, 0, 0]) == [1.0, 1.0, 2.0]
        fs.observe_dones(np.array([True, False]))
        s3 = fs(f(3.0))
        assert list(s3[0, 0, 0]) == [3.0, 3.0, 3.0]
        assert list(s3[1, 0, 0]) == [1.0, 2.0, 3.0]

    def test_peek_gives_true_next_stack(self):
        fs = FrameStack(2)
        fs(np.full((1, 2, 2), 1.0, np.float32))
        nxt = fs.peek(np.full((1, 2, 2), 5.0, np.float32))
        assert list(nxt[0, 0, 0]) == [1.0, 5.0]
        s = fs(np.full((1, 2, 2), 2.0, np.float32))
        assert list(s[0, 0, 0]) == [1.0, 2.0]

    def test_pipeline_shapes_end_to_end(self):
        pipe = _frame_pipeline()
        frames = np.random.randint(0, 255, (4, 84, 84, 3), np.uint8)
        out = pipe(frames)
        assert out.shape == (4, 21, 21, 2)
        assert out.dtype == np.float32
        assert 0.0 <= out.min() and out.max() <= 1.0


def test_cnn_module_on_pixels():
    spec = RLModuleSpec(Box(0, 1, shape=(21, 21, 2)), Discrete(3))
    mod = ActorCriticModule(spec).init(torch.Generator().manual_seed(0), "cpu")
    assert any(name.startswith("enc.") for name in mod.state_dict())
    out = mod(torch.rand(5, 21, 21, 2))
    assert out["logits"].shape == (5, 3)
    assert out["value"].shape == (5,)


def test_pixel_runner_samples_through_the_frame_pipeline():
    """An env runner over CatchPixel frames: the CNN module consumes the
    pipeline's (21, 21, 2) stacks, which is what the batch stores."""
    from ray_tpu_torch.rl.env_runner import EnvRunner

    runner = EnvRunner("CatchPixel-v0", num_envs=2, rollout_fragment_length=8, seed=0,
                       env_to_module_connector=_frame_pipeline, device="cpu")
    batch = runner.sample()
    assert batch[sb.OBS].shape == (16, 21, 21, 2)
    assert np.isfinite(batch[sb.ADVANTAGES]).all()


@pytest.mark.slow
def test_pixel_catch_learns_with_frame_pipeline():
    """Learning on raw pixels through the full frame pipeline, to a reward
    threshold within a bounded budget (random play averages ~-1.8 on
    3-ball Catch; solved is +3)."""
    algo = (
        PPOConfig()
        .environment("CatchPixel-v0")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=16, rollout_fragment_length=64,
                     env_to_module_connector=_frame_pipeline)
        .training(train_batch_size=1024, lr=1e-3, gamma=0.97)
        .resources(device="cpu")
        .build()
    )
    try:
        best = -3.0
        for _ in range(40):
            mean = algo.train().get("episode_reward_mean")
            if mean is not None:
                best = max(best, mean)
            if best >= 1.0:
                break
        assert best >= 1.0, f"best episode_reward_mean {best}"
    finally:
        algo.stop()
