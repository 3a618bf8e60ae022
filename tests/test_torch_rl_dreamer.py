"""The port's Dreamer (``ray_tpu_torch.rl.algorithms.dreamer``) against the
reference's ``ray_tpu.rl.algorithms.dreamer``, on the CPU.

Parity (fp32, 1e-5): ``lambda_returns`` (the reference's own closure, read
from its jitted ``ac_update``) on random imagined trajectories with
continue probabilities that reach 0; one ``wm_update`` and one
``ac_update`` from the reference's weights and batch, given the
reference's imagination draws (``jax.random.categorical`` is the argmax of
logits plus ``jax.random.gumbel`` noise, which the port takes as
``gumbel``): losses, the imagined return and every parameter after both
updates, three Adam optimizers and the EMA target critic included.
Mirrors: ``tests/test_rl_dreamer.py`` (its learning tests slow, as in the
reference).
"""

import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rl.algorithms.dreamer import DreamerConfig as RefDreamerConfig
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithms import dreamer
from ray_tpu_torch.rl.algorithms.dreamer import DreamerConfig, lambda_returns
from ray_tpu_torch.rl.learner import tree_leaf
from ray_tpu_torch.rl.rl_module import DreamerModule, RLModuleSpec, params_from_jax
from ray_tpu_torch.rl.spaces import Box, Discrete

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(sample_steps_per_iter=100, learning_starts=100, updates_per_iter=1,
             train_batch_size=16, imagination_horizon=5, latent_dim=16, hidden=(32, 32))


def _cartpole_module(tree) -> DreamerModule:
    spec = RLModuleSpec(Box(-np.inf, np.inf, shape=(4,)), Discrete(2), hidden=SMALL["hidden"])
    return params_from_jax(tree, DreamerModule(spec, SMALL["latent_dim"]), "cpu")


def _closure_of(fn, name):
    """The value ``fn`` closes over under ``name`` (``fn`` jitted or not)."""
    fn = getattr(fn, "__wrapped__", fn)
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))[name]


@pytest.fixture(scope="module")
def ref_algo():
    algo = RefDreamerConfig().environment("CartPole-v1").training(**SMALL).debugging(seed=0).build()
    yield algo
    algo.stop()


def _port_algo(ref_algo):
    algo = (DreamerConfig().environment("CartPole-v1").training(**SMALL).debugging(seed=0)
            .resources(device="cpu").build())
    algo.module.load_state_dict(_cartpole_module(jax.device_get(ref_algo.params)).state_dict())
    return algo


def test_lambda_returns_match_the_reference(ref_algo):
    ref_fn = _closure_of(ref_algo._ac_update, "lambda_returns")
    H, Bn, Z = SMALL["imagination_horizon"], 8, SMALL["latent_dim"]
    rng = np.random.default_rng(0)
    zs = rng.standard_normal((H, Bn, Z)).astype(np.float32)
    rs = rng.standard_normal((H, Bn)).astype(np.float32)
    conts = rng.random((H, Bn)).astype(np.float32)
    conts[rng.random((H, Bn)) < 0.2] = 0.0  # episode ends inside the horizon
    z_last = rng.standard_normal((Bn, Z)).astype(np.float32)
    traj = (zs, None, None, None, rs, conts)
    tree = jax.device_get(ref_algo.params)
    want = ref_fn(tree, tuple(None if x is None else jnp.asarray(x) for x in traj), jnp.asarray(z_last))
    got = lambda_returns(_cartpole_module(tree), tuple(None if x is None else torch.from_numpy(x) for x in traj),
                         torch.from_numpy(z_last), 0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_world_model_and_actor_critic_updates_match(ref_algo):
    port = _port_algo(ref_algo)
    try:
        rng = np.random.default_rng(1)
        Bn = SMALL["train_batch_size"]
        batch = {
            sb.OBS: rng.standard_normal((Bn, 4)).astype(np.float32),
            sb.NEXT_OBS: rng.standard_normal((Bn, 4)).astype(np.float32),
            sb.ACTIONS: rng.integers(0, 2, Bn),
            sb.REWARDS: rng.standard_normal(Bn).astype(np.float32),
            sb.TERMINATEDS: rng.random(Bn) < 0.2,
        }
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        key = jax.random.PRNGKey(42)
        params, wm_state, wl, parts = ref_algo._wm_update(ref_algo.params, ref_algo._wm_state, jb)
        params, _pi, _v, al, vl, ret = ref_algo._ac_update(
            params, ref_algo._pi_state, ref_algo._v_state, jb, key)
        gumbel = np.stack([np.asarray(jax.random.gumbel(k, (Bn, 2)))
                           for k in jax.random.split(key, SMALL["imagination_horizon"])])

        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        got_wl, got_parts = port.wm_update(tb)
        got_al, got_vl, got_ret = port.ac_update(tb, torch.from_numpy(gumbel))
        for got, want, name in ((got_wl, wl, "world_model_loss"), (got_al, al, "actor_loss"),
                                (got_vl, vl, "critic_loss"), (got_ret, ret, "imagined_return")):
            np.testing.assert_allclose(got.item(), float(want), **TOL, err_msg=name)
        for k, v in parts.items():
            np.testing.assert_allclose(got_parts[k].item(), float(v), **TOL, err_msg=k)
        tree = jax.device_get(params)
        for name, value in port.get_weights().items():
            np.testing.assert_allclose(value.numpy(), tree_leaf(tree, name), **TOL, err_msg=name)
    finally:
        port.stop()


def test_an_iteration_reads_the_device_once_after_its_updates(monkeypatch):
    """An iteration's batches go to the device before its updates, which
    then queue with no read back (no ``.item()``, ``.cpu()``, ``bool()`` of
    a tensor by the port's code); the metrics come back in one transfer
    after the loop."""
    algo = (DreamerConfig().environment("CartPole-v1")
            .training(**(SMALL | {"updates_per_iter": 4})).resources(device="cpu").build())
    events = []

    def watch(name):
        real = getattr(torch.Tensor, name)

        def wrapped(self, *args, **kwargs):
            if "ray_tpu_torch" in sys._getframe(1).f_code.co_filename:
                events.append(name)
            return real(self, *args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, wrapped)

    for name in ("item", "cpu", "numpy", "tolist", "__float__", "__bool__"):
        watch(name)
    real_upload = dreamer._to_tensor
    monkeypatch.setattr(dreamer, "_to_tensor",
                        lambda v, device: events.append("upload") or real_upload(v, device))
    for name in ("wm_update", "ac_update"):
        real = getattr(algo, name)
        monkeypatch.setattr(algo, name, lambda *a, _real=real, _n=name: events.append(_n) or _real(*a))
    try:
        m = algo.train()
    finally:
        algo.stop()
    first = events.index("wm_update")
    assert events[first:] == ["wm_update", "ac_update"] * 4 + ["cpu", "tolist"], events
    assert events[first - 5:first] == ["upload"] * 5  # five columns, every update's rows
    assert np.isfinite(m["world_model_loss"]) and np.isfinite(m["actor_loss"])


def test_dreamer_world_model_learns():
    """Dynamics + reconstruction losses must fall as the world model fits
    replayed experience; imagination/ac metrics must be produced."""
    cfg = (
        DreamerConfig()
        .environment("CartPole-v1")
        .training(sample_steps_per_iter=200, learning_starts=200, updates_per_iter=8,
                  train_batch_size=64, imagination_horizon=5, latent_dim=32)
        .debugging(seed=0)
        .resources(device="cpu")
    )
    algo = cfg.build()
    first = last = None
    try:
        for _ in range(5):
            m = algo.train()
            if "world_model_loss" in m:
                first = first if first is not None else m["world_model_loss"]
                last = m["world_model_loss"]
    finally:
        algo.stop()
    assert first is not None and last is not None
    assert last < first, (first, last)
    for key in ("actor_loss", "critic_loss", "imagined_return_mean", "dyn_loss"):
        assert key in m


@pytest.mark.slow
def test_dreamer_learns_cartpole():
    cfg = (
        DreamerConfig()
        .environment("CartPole-v1")
        .training(sample_steps_per_iter=400, learning_starts=400, updates_per_iter=24,
                  train_batch_size=128, imagination_horizon=8, latent_dim=64)
        .debugging(seed=0)
        .resources(device="cpu")
    )
    algo = cfg.build()
    deadline = time.monotonic() + 300
    best = 0.0
    try:
        for _ in range(40):
            best = max(best, algo.train().get("episode_return_mean") or 0.0)
            if best >= 150 or time.monotonic() > deadline:
                break
    finally:
        algo.stop()
    assert best >= 150, f"best return {best}"


@pytest.mark.slow
def test_dreamer_minatar_breakout_beats_random():
    """>= 0.45 mean return (>3x random's 0.14) on MinAtar Breakout within
    12 minutes."""
    cfg = (
        DreamerConfig()
        .environment("MinAtarBreakout-v0")
        .training(sample_steps_per_iter=800, learning_starts=800, updates_per_iter=48,
                  train_batch_size=256, imagination_horizon=15, latent_dim=192,
                  entropy_coeff=1e-3, actor_lr=2e-4, gae_lambda=0.97)
        .debugging(seed=0)
        .resources(device="cpu")
    )
    algo = cfg.build()
    deadline = time.monotonic() + 12 * 60
    best = 0.0
    try:
        while time.monotonic() < deadline:
            best = max(best, algo.train().get("episode_return_mean") or 0.0)
            if best >= 0.45:
                break
    finally:
        algo.stop()
    assert best >= 0.45, f"best return {best} (random baseline 0.14)"
