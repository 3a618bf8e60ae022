"""The port's offline RL (``OfflineDataset``, BC, CQL; ``ray_tpu_torch.rl``)
against the reference's ``ray_tpu.rl``, on the CPU.

Parity (fp32, 1e-5): recorded experience, ``.npz`` and JSONL round trips
give the same rows as the reference's; the BC loss (discrete and
continuous) and the CQL loss, with every gradient, against ``jax.grad`` of
the reference's, with its weights carried across and its ``jax.random``
draws handed to the port's loss; three CQL ``Learner`` updates with Polyak
averaging against the reference's optax ``Learner``. Mirrors: the tests of
``tests/test_rl_offline.py`` (the SAC-comparison learning test slow, as in
the reference).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rl.algorithms import bc as ref_bc
from ray_tpu.rl.algorithms import cql as ref_cql
from ray_tpu.rl.algorithms import sac as ref_sac
from ray_tpu.rl.learner import Learner as RefLearner
from ray_tpu.rl.offline import OfflineDataset as RefOfflineDataset
from ray_tpu.rl.offline import record_experience as ref_record_experience
from ray_tpu.rl.rl_module import ActorCriticModule as RefAC
from ray_tpu.rl.rl_module import RLModuleSpec as RefSpec
from ray_tpu.rl.spaces import Box as RefBox
from ray_tpu.rl.spaces import Discrete as RefDiscrete
from ray_tpu_torch.rl import SampleBatch
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithms.bc import bc_loss
from ray_tpu_torch.rl.algorithms.cql import cql_loss
from ray_tpu_torch.rl.algorithms.sac import _polyak
from ray_tpu_torch.rl.learner import Learner, tree_leaf
from ray_tpu_torch.rl.offline import OfflineDataset, record_experience
from ray_tpu_torch.rl.rl_module import RLModuleSpec, SACModule, params_from_jax
from ray_tpu_torch.rl.spaces import Box, Discrete

TOL = dict(rtol=1e-5, atol=1e-5)
B, N_ACTIONS = 32, 4


def _expert_cartpole(obs):
    """Scripted balancer: push in the direction the pole is falling."""
    angle, ang_vel = obs[2], obs[3]
    return 1 if (angle + 0.5 * ang_vel) > 0 else 0


def _assert_same_columns(got, want):
    assert sorted(got.columns) == sorted(want.columns)
    for key, value in want.columns.items():
        assert got.columns[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got.columns[key], value, err_msg=key)


# ---------------------------------------------------------------------------
# the dataset against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env,policy", [("CartPole-v1", _expert_cartpole), ("Pendulum-v1", None)])
def test_recorded_experience_matches_the_reference(env, policy):
    got = record_experience(env, 300, policy=policy, seed=5)
    want = ref_record_experience(env, 300, policy=policy, seed=5)
    _assert_same_columns(got, want)
    got, want = OfflineDataset(got.columns, seed=2), RefOfflineDataset(want.columns, seed=2)
    for _ in range(3):  # the same seed samples the same rows
        g, w = got.sample(16), want.sample(16)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])


def test_npz_round_trip_matches_the_reference(tmp_path):
    data = record_experience("Pendulum-v1", 120, seed=6)
    path = data.save_npz(str(tmp_path / "shards" / "part-0.npz"))
    data.save_npz(str(tmp_path / "shards" / "part-1.npz"))
    for source in (path, str(tmp_path / "shards" / "part-*.npz")):
        got = OfflineDataset.resolve(source)
        _assert_same_columns(got, RefOfflineDataset.resolve(source))
    _assert_same_columns(OfflineDataset.from_npz(path), data)


def test_jsonl_round_trip_matches_the_reference(tmp_path):
    data = record_experience("CartPole-v1", 40, policy=_expert_cartpole, seed=7)
    path = tmp_path / "exp.jsonl"
    with open(path, "w") as f:
        for i in range(len(data)):
            row = {k: np.asarray(v[i]).tolist() for k, v in data.columns.items()}
            f.write(json.dumps(row) + "\n")
    got, want = OfflineDataset.resolve(str(path)), RefOfflineDataset.resolve(str(path))
    _assert_same_columns(got, want)
    for key, value in data.columns.items():  # float64 columns, equal values
        np.testing.assert_array_equal(got.columns[key], value.astype(got.columns[key].dtype))


# ---------------------------------------------------------------------------
# BC and CQL against jax.grad
# ---------------------------------------------------------------------------


def _assert_grads(port, ref_grads):
    ref_grads = jax.device_get(ref_grads)
    for name, p in port.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32)
        np.testing.assert_allclose(got, tree_leaf(ref_grads, name), **TOL, err_msg=name)


def _tensors(batch):
    return {k: torch.tensor(np.asarray(v, np.float32) if np.asarray(v).dtype == np.float64 else v)
            for k, v in batch.items()}


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "continuous"])
def test_bc_loss_and_gradients_match(discrete):
    rng = np.random.default_rng(1)
    obs_space, ref_obs = Box(-1, 1, shape=(4,)), RefBox(-1, 1, shape=(4,))
    act_space, ref_act = (Discrete(2), RefDiscrete(2)) if discrete else (
        Box(-2, 2, shape=(1,)), RefBox(-2, 2, shape=(1,)))
    ref = RefAC(RefSpec(ref_obs, ref_act, hidden=(32, 32)))
    tree = jax.device_get(ref.init(jax.random.PRNGKey(0)))
    port = params_from_jax(tree, RLModuleSpec(obs_space, act_space, hidden=(32, 32)), "cpu")
    batch = {
        sb.OBS: rng.standard_normal((B, 4)).astype(np.float32),
        # JSONL-imported columns are float64 and int64: both sides cast them
        sb.ACTIONS: rng.integers(0, 2, B) if discrete else rng.uniform(-2, 2, (B, 1)),
    }
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, ref_m), ref_grads = jax.value_and_grad(
        lambda p: ref_bc.bc_loss(ref, p, jb), has_aux=True)(tree)
    loss, metrics = bc_loss(port, port, _tensors(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **TOL)
    for key, value in ref_m.items():
        np.testing.assert_allclose(metrics[key].item(), float(value), **TOL, err_msg=key)
    _assert_grads(port, ref_grads)


def _cql_spec():
    return (RLModuleSpec(Box(-8, 8, shape=(3,)), Box(-2, 2, shape=(1,)), hidden=(32, 32)),
            RefSpec(RefBox(-8, 8, shape=(3,)), RefBox(-2, 2, shape=(1,)), hidden=(32, 32)))


def _cql_batch(seed: int, step: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {
        sb.OBS: rng.standard_normal((B, 3)).astype(np.float32),
        sb.ACTIONS: rng.uniform(-2, 2, (B, 1)).astype(np.float32),
        sb.REWARDS: rng.standard_normal(B).astype(np.float32),
        sb.NEXT_OBS: rng.standard_normal((B, 3)).astype(np.float32),
        sb.TERMINATEDS: rng.random(B) < 0.2,
        "step": np.full(B, step, np.int32),
    }
    # the reference's draws at this step (sac.py:117,122,129, cql.py:50-66)
    key = jax.random.fold_in(jax.random.PRNGKey(0), step)
    ckey = jax.random.fold_in(jax.random.PRNGKey(1), step)
    out["draw/next"] = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (B, 1)))
    out["draw/pi"] = np.asarray(jax.random.normal(jax.random.fold_in(key, 2), (B, 1)))
    out["draw/cql_random"] = np.asarray(jax.random.uniform(
        jax.random.fold_in(ckey, 0), (N_ACTIONS, B, 1), minval=jnp.asarray([-2.0]),
        maxval=jnp.asarray([2.0])))
    out["draw/cql_policy"] = np.asarray(
        jax.random.normal(jax.random.fold_in(ckey, 1), (N_ACTIONS, B, 1)))
    return out


CQL_ARGS = (0.99, -1.0, 1.0, N_ACTIONS)


def test_cql_loss_and_gradients_match():
    spec, ref_spec = _cql_spec()
    ref = ref_sac.SACModule(ref_spec)
    tree = jax.device_get(ref.init(jax.random.PRNGKey(0)))
    port = params_from_jax(tree, SACModule(spec), "cpu")
    batch = _cql_batch(seed=2, step=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, ref_m), ref_grads = jax.value_and_grad(
        lambda p: ref_cql.cql_loss(*CQL_ARGS)(ref, p, jb), has_aux=True)(tree)
    fn = cql_loss(*CQL_ARGS)
    fn.step = 4
    loss, metrics = fn(port, port, _tensors(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **TOL)
    assert set(metrics) == set(ref_m)
    for key, value in ref_m.items():
        np.testing.assert_allclose(metrics[key].item(), float(value), **TOL, err_msg=key)
    _assert_grads(port, ref_grads)


def test_cql_learner_updates_with_polyak_match_optax():
    spec, ref_spec = _cql_spec()
    ref = RefLearner(lambda: ref_sac.SACModule(ref_spec), ref_cql.cql_loss(*CQL_ARGS), lr=3e-3,
                     grad_clip=0.5, seed=3, data_parallel=False)
    port = Learner(lambda: SACModule(spec), cql_loss(*CQL_ARGS), lr=3e-3, grad_clip=0.5, seed=3,
                   device="cpu")
    port.set_weights(params_from_jax(jax.device_get(ref.params), SACModule(spec), "cpu").state_dict())
    for step in range(1, 4):
        batch = SampleBatch(_cql_batch(seed=30 + step, step=step))
        want, got = ref.update(batch), port.update(batch)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=f"step {step} {key}")
        ref.apply(ref_sac._polyak(0.05))
        port.apply(_polyak(0.05))
        tree = jax.device_get(ref.params)
        for name, value in port.get_weights().items():
            np.testing.assert_allclose(value.numpy(), tree_leaf(tree, name), **TOL,
                                       err_msg=f"step {step} {name}")


# ---------------------------------------------------------------------------
# mirrors of tests/test_rl_offline.py
# ---------------------------------------------------------------------------


class TestOfflineDataset:
    def test_record_and_sample(self):
        ds = record_experience("CartPole-v1", 500, policy=_expert_cartpole, seed=1)
        assert len(ds) == 500
        b = ds.sample(64)
        assert b[sb.OBS].shape == (64, 4)
        assert set(np.unique(b[sb.ACTIONS])) <= {0, 1}

    def test_npz_roundtrip(self, tmp_path):
        ds = record_experience("CartPole-v1", 100, seed=2)
        p = ds.save_npz(str(tmp_path / "exp.npz"))
        back = OfflineDataset.from_npz(p)
        assert len(back) == 100
        np.testing.assert_array_equal(back.columns[sb.OBS], ds.columns[sb.OBS])

    def test_jsonl_import(self, tmp_path):
        p = tmp_path / "exp.jsonl"
        with open(p, "w") as f:
            for i in range(10):
                f.write(json.dumps({"obs": [float(i)] * 4, "actions": i % 2, "rewards": 1.0,
                                    "next_obs": [float(i + 1)] * 4, "terminateds": False}) + "\n")
        ds = OfflineDataset.from_jsonl(str(p))
        assert len(ds) == 10 and ds.columns[sb.OBS].shape == (10, 4)


class TestBC:
    def test_bc_clones_expert(self):
        """BC on scripted-expert CartPole data reaches good returns without
        ever training in the env."""
        from ray_tpu_torch.rl.algorithms.bc import BCConfig

        data = record_experience("CartPole-v1", 4000, policy=_expert_cartpole, seed=3)
        algo = (
            BCConfig()
            .environment("CartPole-v1")
            .training(offline_data=data, lr=3e-3, updates_per_iter=150, train_batch_size=256,
                      evaluation_steps=1200)
            .debugging(seed=0)
            .resources(device="cpu")
            .build()
        )
        best = 0.0
        try:
            for _ in range(8):
                ret = algo.train().get("episode_return_mean")
                if ret is not None:
                    best = max(best, ret)
                if best >= 120.0:
                    break
        finally:
            algo.stop()
        assert best >= 120.0, f"BC failed to clone the expert (best={best})"

    def test_bc_requires_data(self):
        from ray_tpu_torch.rl.algorithms.bc import BCConfig

        with pytest.raises(ValueError, match="offline_data"):
            BCConfig().environment("CartPole-v1").resources(device="cpu").build()


class TestCQL:
    def _pendulum_data(self, n=1500):
        return record_experience("Pendulum-v1", n, seed=4)

    def test_cql_runs_and_penalty_reported(self):
        from ray_tpu_torch.rl.algorithms.cql import CQLConfig

        algo = (
            CQLConfig()
            .environment("Pendulum-v1")
            .training(offline_data=self._pendulum_data(), updates_per_iter=20, train_batch_size=64,
                      cql_alpha=1.0)
            .debugging(seed=0)
            .resources(device="cpu")
            .build()
        )
        try:
            res = algo.train()
        finally:
            algo.stop()
        assert "learner/cql_penalty" in res
        assert np.isfinite(res["learner/cql_penalty"])

    @pytest.mark.slow
    def test_cql_is_more_conservative_than_sac(self):
        """The penalty shrinks the gap between Q on out-of-distribution
        (policy/random) actions and Q on dataset actions."""
        from ray_tpu_torch.rl.algorithms.cql import CQLConfig

        data = self._pendulum_data()
        obs = torch.from_numpy(data.columns[sb.OBS][:256])
        acts = torch.from_numpy(data.columns[sb.ACTIONS][:256]).reshape(256, -1)

        def ood_gap(cql_alpha):
            algo = (
                CQLConfig()
                .environment("Pendulum-v1")
                .training(offline_data=data, updates_per_iter=100, train_batch_size=128,
                          cql_alpha=cql_alpha)
                .debugging(seed=0)
                .resources(device="cpu")
                .build()
            )
            try:
                for _ in range(2):
                    algo.train()
                m = algo.learner_group._local.params
            finally:
                algo.stop()
            with torch.no_grad():
                eps = torch.randn((256, 1), generator=torch.Generator().manual_seed(9))
                a, _ = m.sample_action_logp(obs, eps)
                q1o, q2o = m.q_values(obs, a)
                q1d, q2d = m.q_values(obs, acts)
            return float((torch.minimum(q1o, q2o) - torch.minimum(q1d, q2d)).mean())

        assert ood_gap(10.0) < ood_gap(0.0), (
            "CQL penalty should depress OOD Q relative to dataset Q"
        )
