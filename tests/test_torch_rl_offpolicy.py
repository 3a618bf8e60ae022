"""The port's replay buffers and off-policy algorithms (DQN, SAC, TD3,
DDPG; ``ray_tpu_torch.rl``) against the reference's ``ray_tpu.rl``, on the
CPU.

Parity (fp32, 1e-5): replay and prioritized sampling under one seed (the
same indices, weights and priorities); the DQN, SAC, TD3 and DDPG losses
and the gradient of every parameter group against ``jax.grad`` of the
reference loss, with the reference's weights carried across
(``rl_module.params_from_jax``) and its ``jax.random`` draws handed to the
port's loss (``"draw/<name>"`` batch keys); three or four ``Learner``
updates with Polyak averaging or a target sync against the reference's
optax ``Learner`` (TD3 at ``policy_delay=2``, so the actor's zero-gradient
steps are in it). Mirrors: the DQN and SAC tests of ``tests/test_rl.py``
and the TD3/DDPG tests of ``tests/test_rl_connectors_td3.py`` (the
learning tests slow, as in the reference).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rl.algorithms import dqn as ref_dqn
from ray_tpu.rl.algorithms import sac as ref_sac
from ray_tpu.rl.algorithms import td3 as ref_td3
from ray_tpu.rl.learner import Learner as RefLearner
from ray_tpu.rl.replay_buffer import PrioritizedReplayBuffer as RefPrioritized
from ray_tpu.rl.replay_buffer import ReplayBuffer as RefReplay
from ray_tpu.rl.rl_module import QModule as RefQModule
from ray_tpu.rl.rl_module import RLModuleSpec as RefSpec
from ray_tpu.rl.sample_batch import SampleBatch as RefSampleBatch
from ray_tpu.rl.spaces import Box as RefBox
from ray_tpu.rl.spaces import Discrete as RefDiscrete
from ray_tpu_torch.rl import DQNConfig, PrioritizedReplayBuffer, ReplayBuffer, SampleBatch
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithms.dqn import _sync_target, dqn_loss
from ray_tpu_torch.rl.algorithms.sac import _polyak, sac_loss
from ray_tpu_torch.rl.algorithms.td3 import _polyak_all, td3_loss
from ray_tpu_torch.rl.learner import Learner, tree_leaf
from ray_tpu_torch.rl.rl_module import QModule, RLModuleSpec, SACModule, TD3Module, params_from_jax
from ray_tpu_torch.rl.spaces import Box, Discrete

TOL = dict(rtol=1e-5, atol=1e-5)
B = 32


# ---------------------------------------------------------------------------
# replay buffers
# ---------------------------------------------------------------------------


def _rows(rng, n, base=0):
    return {
        sb.OBS: rng.standard_normal((n, 3)).astype(np.float32),
        sb.ACTIONS: rng.integers(0, 2, n),
        sb.REWARDS: np.arange(base, base + n, dtype=np.float32),
    }


@pytest.mark.parametrize("prioritized", [False, True], ids=["uniform", "prioritized"])
def test_replay_sampling_matches_the_reference_under_one_seed(prioritized):
    rng = np.random.default_rng(0)
    if prioritized:
        port, ref = PrioritizedReplayBuffer(64, seed=5), RefPrioritized(64, seed=5)
    else:
        port, ref = ReplayBuffer(64, seed=5), RefReplay(64, seed=5)
    for i in range(6):  # 6 x 20 rows through a ring of 64: it wraps
        rows = _rows(rng, 20, base=20 * i)
        port.add(SampleBatch(dict(rows)))
        ref.add(RefSampleBatch(dict(rows)))
        assert len(port) == len(ref)
        for _ in range(3):
            got, want = port.sample(16), ref.sample(16)
            assert list(got) == list(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            if prioritized:
                td = rng.standard_normal(16) * 3
                port.update_priorities(got["batch_indexes"], td)
                ref.update_priorities(want["batch_indexes"], td)
                np.testing.assert_array_equal(port._prio, ref._prio)
                assert port._max_prio == ref._max_prio


def _batch(n, base=0):
    return SampleBatch(
        {
            sb.OBS: np.arange(base, base + n, dtype=np.float32)[:, None],
            sb.ACTIONS: np.zeros(n, np.int64),
        }
    )


def test_replay_buffer_ring_overwrites_oldest():
    buf = ReplayBuffer(capacity=4, seed=0)
    buf.add(_batch(3))          # 0,1,2
    assert len(buf) == 3
    buf.add(_batch(3, base=10))  # 10,11,12 -> wraps, overwrites 0,1
    assert len(buf) == 4
    live = set(buf._store[sb.OBS][:, 0].tolist())
    assert live == {2.0, 10.0, 11.0, 12.0}


def test_prioritized_replay_uses_per_sample_priorities():
    buf = PrioritizedReplayBuffer(capacity=16, alpha=1.0, beta=1.0, seed=0)
    buf.add(_batch(8))
    # crank one index's priority way up
    buf.update_priorities(np.array([3]), np.array([1000.0]))
    counts = np.zeros(8)
    for _ in range(50):
        out = buf.sample(4)
        for i in out["batch_indexes"]:
            counts[i] += 1
    assert counts[3] == counts.max() and counts[3] > counts.sum() * 0.8
    # IS weights: the hot sample must get the SMALLEST weight
    out = buf.sample(8)
    w = {int(i): float(x) for i, x in zip(out["batch_indexes"], out["weights"])}
    if 3 in w and len(w) > 1:
        assert w[3] == min(w.values())


# ---------------------------------------------------------------------------
# losses and gradients against jax.grad
# ---------------------------------------------------------------------------


def _spaces(discrete: bool, hidden=(32, 32)):
    if discrete:
        obs, ref_obs = Box(-1, 1, shape=(4,)), RefBox(-1, 1, shape=(4,))
        act, ref_act = Discrete(3), RefDiscrete(3)
    else:  # Pendulum's shapes and bounds
        obs, ref_obs = Box(-8, 8, shape=(3,)), RefBox(-8, 8, shape=(3,))
        act, ref_act = Box(-2, 2, shape=(1,)), RefBox(-2, 2, shape=(1,))
    return RLModuleSpec(obs, act, hidden=hidden), RefSpec(ref_obs, ref_act, hidden=hidden)


def _transitions(discrete: bool, seed: int, n=B, weights=False) -> dict:
    rng = np.random.default_rng(seed)
    d_obs = 4 if discrete else 3
    out = {
        sb.OBS: rng.standard_normal((n, d_obs)).astype(np.float32),
        sb.ACTIONS: (rng.integers(0, 3, n) if discrete
                     else rng.uniform(-2, 2, (n, 1)).astype(np.float32)),
        # float64, as Pendulum's rewards are: both sides see float32
        sb.REWARDS: rng.standard_normal(n) * 2,
        sb.NEXT_OBS: rng.standard_normal((n, d_obs)).astype(np.float32),
        sb.TERMINATEDS: rng.random(n) < 0.2,
    }
    if weights:
        out["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return out


def _sac_draws(step: int, n_actions: int = 0, low=-2.0, high=2.0) -> dict:
    """The reference SAC loss's draws at ``step`` (``sac.py:117,122,129``)
    and, with ``n_actions``, CQL's (``cql.py:50-66``)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(0), step)
    out = {
        "draw/next": np.asarray(jax.random.normal(jax.random.fold_in(rng, 1), (B, 1))),
        "draw/pi": np.asarray(jax.random.normal(jax.random.fold_in(rng, 2), (B, 1))),
    }
    if n_actions:
        crng = jax.random.fold_in(jax.random.PRNGKey(1), step)
        out["draw/cql_random"] = np.asarray(jax.random.uniform(
            jax.random.fold_in(crng, 0), (n_actions, B, 1), minval=jnp.asarray([low]),
            maxval=jnp.asarray([high])))
        out["draw/cql_policy"] = np.asarray(
            jax.random.normal(jax.random.fold_in(crng, 1), (n_actions, B, 1)))
    return out


def _td3_draws(step: int) -> dict:
    rng = jax.random.fold_in(jax.random.PRNGKey(0), step)
    return {"draw/target": np.asarray(jax.random.normal(rng, (B, 1)))}


def _ref_grads(ref_module, ref_fn, tree, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: ref_fn(ref_module, p, jb), has_aux=True
    )(tree)
    return float(loss), jax.device_get(metrics), jax.device_get(grads)


def _port_grads(port, fn, batch, step=1):
    fn.step = step - 1  # a counting loss: this call is update `step`
    tb = {k: torch.tensor(np.asarray(v, np.float32) if np.asarray(v).dtype == np.float64
                          else np.asarray(v)) for k, v in batch.items()}
    loss, metrics = fn(port, port, tb)
    loss.backward()
    return loss.item(), metrics


def assert_loss_and_grads_match(port, loss, metrics, ref_loss, ref_metrics, ref_grads):
    np.testing.assert_allclose(loss, ref_loss, **TOL)
    for key, value in ref_metrics.items():
        np.testing.assert_allclose(metrics[key].detach().numpy(), np.asarray(value), **TOL,
                                   err_msg=key)
    for name, p in port.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32)
        np.testing.assert_allclose(got, tree_leaf(ref_grads, name), **TOL, err_msg=name)


@pytest.mark.parametrize("double_q", [True, False], ids=["double_q", "single_q"])
def test_dqn_loss_and_gradients_match(double_q):
    spec, ref_spec = _spaces(True)
    ref = RefQModule(ref_spec)
    tree = jax.device_get(ref.init(jax.random.PRNGKey(0)))
    # a target that differs from the online net, so the two argmaxes differ
    tree["target_q"] = jax.tree_util.tree_map(lambda x: x * 0.7 + 0.01, tree["q"])
    port = params_from_jax(tree, QModule(spec), "cpu")
    batch = _transitions(True, seed=1, weights=True)
    want = _ref_grads(ref, ref_dqn.dqn_loss(0.99, double_q), tree, batch)
    got = _port_grads(port, dqn_loss(0.99, double_q), batch)
    assert_loss_and_grads_match(port, *got, *want)
    assert all(p.grad is None for p in port.target_q.parameters())  # the reference's zeros


def test_sac_loss_and_gradients_match():
    spec, ref_spec = _spaces(False)
    ref = ref_sac.SACModule(ref_spec)
    tree = jax.device_get(ref.init(jax.random.PRNGKey(0)))
    port = params_from_jax(tree, SACModule(spec), "cpu")
    batch = _transitions(False, seed=2) | {"step": np.full(B, 3, np.int32)} | _sac_draws(3)
    want = _ref_grads(ref, ref_sac.sac_loss(0.99, -1.0), tree, batch)
    got = _port_grads(port, sac_loss(0.99, -1.0), batch, step=3)
    assert_loss_and_grads_match(port, *got, *want)
    for group in ("pi", "q1", "q2", "log_alpha"):  # every trained group has a gradient
        assert any(p.grad is not None and p.grad.abs().sum() > 0
                   for n, p in port.named_parameters() if n.split(".")[0] == group), group


@pytest.mark.parametrize("twin_q,delay,step", [(True, 2, 1), (True, 2, 2), (False, 1, 1)],
                         ids=["td3_off_step", "td3_actor_step", "ddpg"])
def test_td3_and_ddpg_losses_and_gradients_match(twin_q, delay, step):
    spec, ref_spec = _spaces(False)
    ref = ref_td3.TD3Module(ref_spec, 0.1, twin_q=twin_q)
    tree = jax.device_get(ref.init(jax.random.PRNGKey(0)))
    # targets off the online nets, as after some Polyak steps
    for src in ("pi", "q1", "q2"):
        if src in tree:
            tree[f"target_{src}"] = jax.tree_util.tree_map(lambda x: x * 0.9, tree[src])
    port = params_from_jax(tree, TD3Module(spec, 0.1, twin_q=twin_q), "cpu")
    noise = 0.2 if twin_q else 0.0
    batch = _transitions(False, seed=3) | {"step": np.full(B, step, np.int32)} | _td3_draws(step)
    want = _ref_grads(ref, ref_td3.td3_loss(0.99, noise, 0.5, delay), tree, batch)
    got = _port_grads(port, td3_loss(0.99, noise, 0.5, delay), batch, step=step)
    assert_loss_and_grads_match(port, *got, *want)
    actor_moves = port.pi.w[0].grad is not None and port.pi.w[0].grad.abs().sum() > 0
    assert actor_moves == (step % delay == 0)
    assert (port.q2 is not None) == twin_q


# ---------------------------------------------------------------------------
# learner updates against the reference's optax Learner
# ---------------------------------------------------------------------------


def _assert_weights_match(port, ref, msg):
    tree = jax.device_get(ref.params)
    for name, value in port.get_weights().items():
        np.testing.assert_allclose(value.numpy(), tree_leaf(tree, name), **TOL,
                                   err_msg=f"{msg} {name}")


def _learners(ref_factory, ref_fn, factory, fn, lr=3e-3, grad_clip=0.5):
    ref = RefLearner(ref_factory, ref_fn, lr=lr, grad_clip=grad_clip, seed=3, data_parallel=False)
    port = Learner(factory, fn, lr=lr, grad_clip=grad_clip, seed=3, device="cpu")
    port.set_weights(params_from_jax(jax.device_get(ref.params), factory(), "cpu").state_dict())
    return ref, port


def _check_update(ref, port, batch, msg):
    want, got = ref.update(batch), port.update(batch)
    assert set(got) == set(want), msg
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=f"{msg} {key}")


def test_dqn_learner_updates_with_a_target_sync_match_optax():
    spec, ref_spec = _spaces(True)
    ref, port = _learners(lambda: RefQModule(ref_spec), ref_dqn.dqn_loss(0.99, True),
                          lambda: QModule(spec), dqn_loss(0.99, True))
    for step in range(1, 5):
        batch = SampleBatch(_transitions(True, seed=10 + step, weights=True))
        _check_update(ref, port, batch, f"step {step}")
        if step == 2:
            ref.apply(ref_dqn._sync_target)
            port.apply(_sync_target)
        _assert_weights_match(port, ref, f"step {step}")


@pytest.mark.parametrize("algo", ["sac", "td3", "ddpg"])
def test_learner_updates_with_polyak_match_optax(algo):
    spec, ref_spec = _spaces(False)
    if algo == "sac":
        kw = dict(ref_factory=lambda: ref_sac.SACModule(ref_spec), ref_fn=ref_sac.sac_loss(0.99, -1.0),
                  factory=lambda: SACModule(spec), fn=sac_loss(0.99, -1.0))
        polyaks, draws, steps = (ref_sac._polyak(0.05), _polyak(0.05)), _sac_draws, 3
    else:
        twin, noise, delay = (True, 0.2, 2) if algo == "td3" else (False, 0.0, 1)
        kw = dict(ref_factory=lambda: ref_td3.TD3Module(ref_spec, 0.1, twin_q=twin),
                  ref_fn=ref_td3.td3_loss(0.99, noise, 0.5, delay),
                  factory=lambda: TD3Module(spec, 0.1, twin_q=twin),
                  fn=td3_loss(0.99, noise, 0.5, delay))
        polyaks, draws, steps = (ref_td3._polyak_all(0.05), _polyak_all(0.05)), _td3_draws, 4
    ref, port = _learners(**kw)
    for step in range(1, steps + 1):
        batch = SampleBatch(_transitions(False, seed=20 + step) | {"step": np.full(B, step, np.int32)}
                            | draws(step))
        _check_update(ref, port, batch, f"{algo} step {step}")
        ref.apply(polyaks[0])
        port.apply(polyaks[1])
        _assert_weights_match(port, ref, f"{algo} step {step}")


# ---------------------------------------------------------------------------
# mirrors of tests/test_rl.py and tests/test_rl_connectors_td3.py
# ---------------------------------------------------------------------------


def test_dqn_training_step_smoke_prioritized():
    algo = (
        DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=4, rollout_fragment_length=32)
        .training(
            train_batch_size=32,
            prioritized_replay=True,
            learning_starts=64,
            sample_steps_per_iter=128,
            updates_per_iter=4,
        )
        .resources(device="cpu")
        .build()
    )
    try:
        algo.train()
        result = algo.train()
        assert "learner/td_error_mean" in result
        # per-sample priorities: after updates the priority table must hold
        # MANY distinct values, not one batch-mean scalar
        prio = algo.buffer._prio[: len(algo.buffer)]
        touched = prio[prio != 1.0]
        assert len(np.unique(touched)) > 4
        # td_abs must not leak into reported metrics
        assert "learner/td_abs" not in result
    finally:
        algo.stop()


def test_dqn_target_sync_copies_the_online_net():
    algo = (
        DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_envs_per_env_runner=4)
        .training(train_batch_size=32, learning_starts=64, sample_steps_per_iter=128,
                  updates_per_iter=4, target_update_freq=256)
        .resources(device="cpu")
        .build()
    )
    try:
        algo.train()  # 128 steps: learns, no sync yet
        w = algo.get_weights()
        assert any(not torch.equal(w[f"q.w.{i}"], w[f"target_q.w.{i}"]) for i in range(3))
        algo.train()  # 256 steps since the start: the sync
        w = algo.get_weights()
        for name in [n for n in w if n.startswith("q.")]:
            assert torch.equal(w[name], w["target_" + name]), name
    finally:
        algo.stop()


@pytest.mark.slow
def test_dqn_learns_cartpole():
    """DQN (double-Q + prioritized replay) must clearly beat random play on
    CartPole within a small budget."""
    algo = (
        DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8, rollout_fragment_length=64)
        .training(
            train_batch_size=64,
            prioritized_replay=True,
            learning_starts=500,
            sample_steps_per_iter=512,
            updates_per_iter=64,
            target_update_freq=1000,
            epsilon_decay_steps=10000,
            lr=5e-4,
        )
        .debugging(seed=0)
        .resources(device="cpu")
        .build()
    )
    try:
        best = max(algo.train()["episode_return_mean"] or 0.0 for _ in range(40))
        assert best >= 100.0, f"DQN failed to learn CartPole: best return {best}"
    finally:
        algo.stop()


def _sac_config(**training):
    from ray_tpu_torch.rl.algorithms.sac import SACConfig

    return (
        SACConfig()
        .environment("Pendulum-v1")
        .training(**training)
        .resources(device="cpu")
    )


def test_sac_training_step_smoke():
    algo = (
        _sac_config(learning_starts=64, sample_steps_per_iter=128, updates_per_iter=4,
                    train_batch_size=64)
        .env_runners(num_env_runners=0, num_envs_per_env_runner=2, rollout_fragment_length=32)
        .build()
    )
    try:
        algo.train()
        result = algo.train()
        assert "learner/q_loss" in result
        assert result["learner/alpha"] > 0
    finally:
        algo.stop()


@pytest.mark.slow
def test_sac_learns_pendulum():
    """SAC must clearly improve on Pendulum-v1 (random play averages about
    -1200)."""
    algo = (
        _sac_config(learning_starts=800, sample_steps_per_iter=400, updates_per_iter=400,
                    train_batch_size=256, lr=3e-4)
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8)
        .debugging(seed=0)
        .build()
    )
    try:
        best = -np.inf
        for _ in range(40):
            r = algo.train()
            if r["episode_return_mean"] is not None:
                best = max(best, r["episode_return_mean"])
            if best >= -350.0:
                break
        assert best >= -350.0, f"SAC failed to learn Pendulum: best return {best}"
    finally:
        algo.stop()


def _td3_algo(config_cls, seed=0, **training):
    return (
        config_cls()
        .environment("Pendulum-v1")
        .training(**training)
        .debugging(seed=seed)
        .resources(device="cpu")
        .build()
    )


class TestTD3:
    @pytest.mark.slow
    def test_td3_trains_and_improves_q(self):
        from ray_tpu_torch.rl.algorithms.td3 import TD3Config

        algo = _td3_algo(TD3Config, learning_starts=300, sample_steps_per_iter=300,
                         updates_per_iter=50, train_batch_size=64)
        r1 = algo.train()
        r2 = algo.train()
        assert "learner/q_loss" in r2 and np.isfinite(r2["learner/q_loss"])
        assert r2["buffer_size"] > r1.get("buffer_size", 0) or r2["buffer_size"] > 0

    def test_td3_target_networks_lag(self):
        from ray_tpu_torch.rl.algorithms.td3 import TD3Config

        algo = _td3_algo(TD3Config, learning_starts=100, sample_steps_per_iter=150,
                         updates_per_iter=30, train_batch_size=32)
        algo.train()
        p = algo.get_weights()
        # targets must differ from live nets (tau << 1) but not be garbage
        mx = max(float((p[n] - p["target_" + n]).abs().max()) for n in p if n.startswith("pi."))
        assert 0 < mx < 10.0

    def test_td3_registered(self):
        from ray_tpu_torch.rl import get_algorithm_class

        assert get_algorithm_class("TD3") is not None


class TestDDPG:
    def test_ddpg_single_critic_trains(self):
        """DDPG = TD3 minus the three tricks: the module must carry ONE
        critic (no q2/target_q2) and still train to finite losses."""
        from ray_tpu_torch.rl.algorithms.ddpg import DDPGConfig

        algo = _td3_algo(DDPGConfig, learning_starts=200, sample_steps_per_iter=250,
                         updates_per_iter=40, train_batch_size=64)
        r = algo.train()
        r = algo.train()
        assert "learner/q_loss" in r and np.isfinite(r["learner/q_loss"])
        groups = {n.split(".")[0] for n in algo.get_weights()}
        assert "q1" in groups and "target_q1" in groups
        assert "q2" not in groups and "target_q2" not in groups

    def test_ddpg_actor_updates_every_step(self):
        """policy_delay=1: pi_loss must be non-zero on (virtually) every
        update, unlike TD3 where alternate steps gate it to 0."""
        from ray_tpu_torch.rl.algorithms.ddpg import DDPGConfig

        cfg = DDPGConfig()
        assert cfg.policy_delay == 1 and cfg.target_noise == 0.0
        algo = _td3_algo(DDPGConfig, seed=1, learning_starts=100, sample_steps_per_iter=150,
                         updates_per_iter=10, train_batch_size=32)
        r = algo.train()
        assert r["learner/pi_loss"] != 0.0


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def test_polyak_and_target_sync_ship_to_a_remote_learner(cluster):
    """With ``remote_learner=True`` the Polyak average and the target sync
    are functions ``learner_group.apply`` pickles to the learner actor:
    SAC's targets lag its critics there, and DQN's target equals its online
    net after a sync."""
    from ray_tpu_torch.rl.algorithms.sac import SACConfig

    sac = (SACConfig().environment("Pendulum-v1")
           .training(learning_starts=64, sample_steps_per_iter=128, updates_per_iter=4,
                     train_batch_size=32, remote_learner=True)
           .resources(device="cpu").build())
    dqn = (DQNConfig().environment("CartPole-v1")
           .training(learning_starts=64, sample_steps_per_iter=128, updates_per_iter=4,
                     train_batch_size=32, target_update_freq=128, remote_learner=True)
           .resources(device="cpu").build())
    try:
        for algo in (sac, dqn):
            algo.train()
        w = sac.get_weights()  # host arrays from the actor
        lag = max(float(np.abs(w[n] - w["target_" + n]).max()) for n in w if n.startswith("q1."))
        assert 0 < lag < 1.0
        w = dqn.get_weights()
        for name in [n for n in w if n.startswith("q.")]:
            np.testing.assert_array_equal(w[name], w["target_" + name])
    finally:
        sac.stop()
        dqn.stop()
