"""The port's data-parallel ``Learner`` (``data_parallel=N``: a leader and
N - 1 gloo follower processes, ``rl._dp_worker``) against the reference's
``Learner``, whose default ``data_parallel=True`` shards the batch over
conftest's 8 virtual CPU devices.

Parity: 3 updates of PPO, APPO and ``rlhf_loss`` (a 2-layer GPT) at 2 and
4 ranks against the reference's 8-device learner within ``TOL``, on
batches of 64 rows (no padding on either side) whose halves differ in
advantages, rewards, masks and weights, so a loss normalizing per slice
would fail. Port-only: a 37-row batch against the one-device learner on
the same batch cycle-padded by hand; CQL's draws (rows on dim 0 and dim 1,
drawn or handed) against the one-device learner; DQN's per-sample ``|td|``
back in row order; ``apply`` and ``set_weights`` reaching every rank (a
digest of each rank's parameters).

Every data-parallel learner of the file starts at once in a module
fixture (each follower is a fresh interpreter importing torch); the
reference's updates run meanwhile.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax

from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.rl.algorithms.appo import appo_loss as ref_appo_loss
from ray_tpu.rl.algorithms.ppo import ppo_loss as ref_ppo_loss
from ray_tpu.rl.learner import Learner as RefLearner
from ray_tpu.rl.rl_module import ActorCriticModule as RefAC
from ray_tpu.rl.rl_module import RLModuleSpec as RefSpec
from ray_tpu.rl.spaces import Box as RefBox
from ray_tpu.rl.spaces import Discrete as RefDiscrete
from ray_tpu.rlhf.learner import GPTPolicyModule as RefPolicy
from ray_tpu.rlhf.learner import rlhf_loss as ref_rlhf_loss
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.models.gpt import params_from_jax as gpt_params_from_jax
from ray_tpu_torch.rl import SampleBatch
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithms.appo import appo_loss
from ray_tpu_torch.rl.algorithms.cql import cql_loss
from ray_tpu_torch.rl.algorithms.dqn import _sync_target, dqn_loss
from ray_tpu_torch.rl.algorithms.ppo import ppo_loss
from ray_tpu_torch.rl.algorithms.sac import _polyak
from ray_tpu_torch.rl.learner import Learner, host_weights
from ray_tpu_torch.rl.rl_module import ActorCriticModule, QModule, RLModuleSpec, SACModule, params_from_jax
from ray_tpu_torch.rl.spaces import Box, Discrete
from ray_tpu_torch.rlhf.learner import GPTPolicyModule, rlhf_loss

pytestmark = pytest.mark.skipif(
    len(jax.devices("cpu")) < 8,
    reason="the reference's data-parallel learner needs conftest's 8 virtual CPU devices",
)

TOL = dict(rtol=1e-5, atol=1e-5)
ROWS = 64  # a multiple of 2, 4 and the reference's 8: no padding anywhere
UPDATES = 3
PPO_ARGS = (0.2, 1.0, 0.5, 0.01)  # clip, vf clip, vf coeff, entropy coeff
APPO_ARGS = (0.99, 1.0, 1.0, 0.5, 0.01, 0.3, True, 0.2)  # with the KL term
SEQ_T = 8  # APPO's sequence length
GPT_KW = dict(vocab_size=64, seq_len=24, d_model=32, n_layers=2, n_heads=2, remat=False, fused_loss=False,
              dtype="float32")
RLHF_T, RLHF_O = 16, 6
#: Adam's first step moves an element by up to lr whatever its gradient's
#: size, so an element whose gradient is near 1e-8 (Adam's eps) moves by an
#: amount its rounding decides: at lr 1e-2 one element of the one-device
#: port learner lands 1.6e-5 from the reference's after step 0, as it does
#: over 2 and 4 ranks; at 1e-3 that is 1.6e-6
RLHF_LR = 1e-3
SPEC = RLModuleSpec(Box(-1, 1, shape=(4,)), Discrete(3), hidden=(32, 32))
REF_SPEC = RefSpec(RefBox(-1, 1, shape=(4,)), RefDiscrete(3), hidden=(32, 32))
PENDULUM = RLModuleSpec(Box(-8, 8, shape=(3,)), Box(-2, 2, shape=(1,)), hidden=(32, 32))


def _halves(a: np.ndarray, scale: float, shift: float) -> np.ndarray:
    """``a`` with its second half scaled and shifted (the ranks' slices then
    differ in mean and spread)."""
    a = a.copy()
    a[len(a) // 2:] = a[len(a) // 2:] * scale + shift
    return a


def ppo_batch(step: int, rows: int = ROWS) -> dict:
    rng = np.random.default_rng(100 + step)
    return {
        sb.OBS: rng.standard_normal((rows, 4)).astype(np.float32),
        sb.ACTIONS: rng.integers(0, 3, rows),
        sb.LOGP: (np.log(1 / 3) + 0.3 * rng.standard_normal(rows)).astype(np.float32),
        sb.ADVANTAGES: _halves(rng.standard_normal(rows).astype(np.float32), 3.0, 1.5),
        sb.VALUE_TARGETS: _halves((3 * rng.standard_normal(rows)).astype(np.float32), 0.5, -2.0),
    }


def appo_batch(step: int) -> dict:
    rng = np.random.default_rng(200 + step)
    n, t = ROWS, SEQ_T
    return {
        sb.OBS: rng.standard_normal((n, t, 4)).astype(np.float32),
        sb.ACTIONS: rng.integers(0, 3, (n, t)),
        sb.REWARDS: _halves(rng.standard_normal((n, t)).astype(np.float32), 4.0, 2.0),
        sb.TERMINATEDS: rng.random((n, t)) < 0.15,
        sb.LOGP: (np.log(1 / 3) + 0.4 * rng.standard_normal((n, t))).astype(np.float32),
        "bootstrap_value": rng.standard_normal(n).astype(np.float32),
    }


def rlhf_batch(step: int) -> dict:
    """``rlhf_loss``'s layout; the second half's rows carry lower weights,
    more masked tokens and larger advantages."""
    rng = np.random.default_rng(300 + step)
    B, T, O, V = ROWS, RLHF_T, RLHF_O, GPT_KW["vocab_size"]
    prompt_len = rng.integers(3, T - O + 1, B).astype(np.int32)
    out_len = rng.integers(2, O + 1, B).astype(np.int32)
    tokens = np.zeros((B, T), np.int32)
    out_tokens = np.zeros((B, O), np.int32)
    for i in range(B):
        seq = rng.integers(0, V, prompt_len[i] + out_len[i])
        tokens[i, : len(seq)] = seq
        out_tokens[i, : out_len[i]] = seq[prompt_len[i]:]
    mask = (rng.random((B, O)) > np.where(np.arange(B) < B // 2, 0.05, 0.4)[:, None]).astype(np.float32)
    return dict(
        tokens=tokens, prompt_len=prompt_len, out_tokens=out_tokens, out_len=out_len,
        behavior_logp=rng.normal(-4.0, 0.5, (B, O)).astype(np.float32), token_mask=mask,
        advantage=_halves(rng.standard_normal(B).astype(np.float32), 3.0, 1.0),
        weight=np.where(np.arange(B) < B // 2, 1.0, rng.choice([0.0, 0.25, 0.5], B)).astype(np.float32),
        temperature=rng.choice([1.0, 0.7, 1.3], B).astype(np.float32),
        top_k=rng.choice([0, 20], B).astype(np.int32),
        top_p=rng.choice([1.0, 0.9], B).astype(np.float32),
    )


def transitions(step: int, rows: int, discrete: bool) -> dict:
    rng = np.random.default_rng(400 + step)
    d = 4 if discrete else 3
    return {
        sb.OBS: rng.standard_normal((rows, d)).astype(np.float32),
        sb.ACTIONS: rng.integers(0, 3, rows) if discrete else rng.uniform(-2, 2, (rows, 1)).astype(np.float32),
        sb.REWARDS: rng.standard_normal(rows).astype(np.float32),
        sb.NEXT_OBS: rng.standard_normal((rows, d)).astype(np.float32),
        sb.TERMINATEDS: rng.random(rows) < 0.2,
    }


# -- the reference's side: its 8-device learner, 3 updates ---------------------

CASES = {
    "ppo": dict(
        ref=lambda: RefLearner(lambda: RefAC(REF_SPEC), ref_ppo_loss(*PPO_ARGS), lr=1e-2, grad_clip=0.5, seed=3),
        port=dict(module_factory=functools.partial(ActorCriticModule, SPEC), loss_fn=ppo_loss(*PPO_ARGS),
                  lr=1e-2, grad_clip=0.5, seed=3),
        weights=lambda tree: params_from_jax(tree, SPEC, "cpu").state_dict(),
        batch=ppo_batch),
    "appo": dict(
        ref=lambda: RefLearner(lambda: RefAC(REF_SPEC), ref_appo_loss(*APPO_ARGS), lr=1e-2, grad_clip=0.5,
                               seed=3),
        port=dict(module_factory=functools.partial(ActorCriticModule, SPEC), loss_fn=appo_loss(*APPO_ARGS),
                  lr=1e-2, grad_clip=0.5, seed=3),
        weights=lambda tree: params_from_jax(tree, SPEC, "cpu").state_dict(),
        batch=appo_batch),
    "rlhf": dict(
        ref=lambda: RefLearner(lambda: RefPolicy(RefGPTConfig(**GPT_KW, attn_impl="xla")),
                               ref_rlhf_loss(0.2, 0.1), lr=RLHF_LR, grad_clip=1.0, seed=0),
        port=dict(module_factory=functools.partial(GPTPolicyModule, GPTConfig(**GPT_KW)),
                  loss_fn=rlhf_loss(0.2, 0.1), lr=RLHF_LR, grad_clip=1.0, seed=0),
        weights=lambda tree: gpt_params_from_jax(tree, GPTConfig(**GPT_KW), "cpu").state_dict(),
        batch=rlhf_batch),
}


@functools.lru_cache(maxsize=None)
def reference_run(name: str):
    """(initial params tree, [(metrics, params tree) after each update])."""
    case = CASES[name]
    ref = case["ref"]()
    assert ref._sharding is not None and len(jax.devices()) == 8  # the batch over 8 devices
    tree = jax.device_get(ref.params)
    steps = []
    for step in range(UPDATES):
        metrics = ref.update(SampleBatch(case["batch"](step)))
        steps.append((metrics, jax.device_get(ref.params)))
    return tree, steps


def learner_kwargs(name: str) -> dict:
    if name == "cql":
        return dict(module_factory=functools.partial(SACModule, PENDULUM), loss_fn=cql_loss(0.99, -1.0, 1.0, 4),
                    lr=3e-3, grad_clip=0.5, seed=3)
    return dict(module_factory=functools.partial(QModule, SPEC), loss_fn=dqn_loss(0.99, True), lr=3e-3,
                grad_clip=0.5, seed=3)


@pytest.fixture(scope="module")
def learners():
    """Every data-parallel learner of the file, started at once; the
    reference's runs are made while they start."""
    specs = {(name, n): dict(CASES[name]["port"]) for name in CASES for n in (2, 4)}
    specs[("cql", 2)] = learner_kwargs("cql")
    specs[("dqn", 2)] = learner_kwargs("dqn")
    with ThreadPoolExecutor(len(specs)) as pool:
        started = {key: pool.submit(Learner, **kw, data_parallel=key[1], device="cpu")
                   for key, kw in specs.items()}
        for name in CASES:
            reference_run(name)
        out = {key: f.result() for key, f in started.items()}
    yield out
    for learner in out.values():
        learner.close()


def _digests(learner) -> list:
    return [r["params_sha256"] for r in learner.group.reports()]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_three_updates_match_the_reference_over_8_devices(learners, name, n):
    """3 updates at ``data_parallel=n`` equal the reference's 8-device
    learner's metrics and parameters within ``TOL``; every rank holds the
    same parameters."""
    tree, steps = reference_run(name)
    learner = learners[(name, n)]
    learner.set_weights(CASES[name]["weights"](tree))
    for step, (want, want_tree) in enumerate(steps):
        got = learner.update(SampleBatch(CASES[name]["batch"](step)))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=f"{name} n={n} step {step} {key}")
        host = host_weights(learner.weights_view())
        want_host = host_weights(CASES[name]["weights"](want_tree))
        for key, value in host.items():
            msg = f"{name} n={n} step {step} {key}"
            if key.endswith("attn_qkv.bias"):
                # the key slice's gradient is rounding noise (the softmax
                # ignores one shift of every key), which Adam turns into
                # steps of up to lr (tests/test_torch_train_step.py)
                d = GPT_KW["d_model"]
                bound = 2 * CASES[name]["port"]["lr"] * (step + 1)
                np.testing.assert_allclose(value[d:2 * d], want_host[key][d:2 * d], rtol=0, atol=bound, err_msg=msg)
                value, want_value = np.delete(value, np.s_[d:2 * d]), np.delete(want_host[key], np.s_[d:2 * d])
                np.testing.assert_allclose(value, want_value, **TOL, err_msg=msg)
                continue
            np.testing.assert_allclose(value, want_host[key], **TOL, err_msg=msg)
    assert len(set(_digests(learner))) == 1


def test_a_37_row_batch_is_the_one_device_learner_on_the_batch_padded_by_hand(learners):
    """37 rows over 4 ranks pad to 40 by cycling rows 0-2, as the
    reference pads: the group's gradient and metrics are the one-device
    learner's on those 40 rows."""
    learner = learners[("ppo", 4)]
    plain = Learner(**CASES["ppo"]["port"], data_parallel=False, device="cpu")
    learner.set_weights(plain.get_weights())
    batch = ppo_batch(7, rows=37)
    padded = {k: v[np.arange(40) % 37] for k, v in batch.items()}
    grads, metrics = learner.compute_grads(SampleBatch(batch))
    want_grads, want_metrics = plain.compute_grads(SampleBatch(padded))
    for key in want_metrics:
        np.testing.assert_allclose(metrics[key], want_metrics[key], **TOL, err_msg=key)
    for key in want_grads:
        np.testing.assert_allclose(grads[key], want_grads[key], **TOL, err_msg=key)


def test_cql_draws_are_the_one_device_learners_sliced(learners):
    """CQL (SAC's loss and its own): drawn at the whole padded batch's
    shape from the same seed, then each rank's rows (dim 0 for SAC's
    draws, dim 1 for CQL's); handed draws are padded and sliced alike. The
    group's updates equal the one-device learner's on the padded batch, and
    a Polyak ``apply`` reaches every rank."""
    learner = learners[("cql", 2)]
    plain = Learner(**learner_kwargs("cql"), data_parallel=False, device="cpu")
    learner.set_weights(plain.get_weights())
    rng = np.random.default_rng(5)
    for step, rows in enumerate((ROWS, 37)):
        batch = transitions(step, rows, discrete=False)
        padded = {k: v[np.arange(38 if rows == 37 else rows) % rows] for k, v in batch.items()}
        if rows == 37:  # handed draws on this update: the whole batch's rows
            draws = {"draw/next": rng.standard_normal((rows, 1)), "draw/pi": rng.standard_normal((rows, 1)),
                     "draw/cql_random": rng.uniform(-2, 2, (4, rows, 1)),
                     "draw/cql_policy": rng.standard_normal((4, rows, 1))}
            draws = {k: v.astype(np.float32) for k, v in draws.items()}
            batch |= draws
            padded |= {k: (v[:, np.arange(38) % rows] if v.ndim == 3 else v[np.arange(38) % rows])
                       for k, v in draws.items()}
        got, want = learner.update(SampleBatch(batch)), plain.update(SampleBatch(padded))
        for key in want:
            np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=f"step {step} {key}")
        learner.apply(_polyak(0.05))
        plain.apply(_polyak(0.05))
    for key, value in host_weights(plain.params).items():
        np.testing.assert_allclose(host_weights(learner.params)[key], value, **TOL, err_msg=key)
    assert len(set(_digests(learner))) == 1


def test_dqn_td_rows_in_order_and_apply_and_set_weights_reach_every_rank(learners):
    """DQN's per-sample ``|td|`` comes back gathered in row order and
    trimmed to the batch (37 rows padded to 38 over 2 ranks); a target sync
    and a function given to ``apply`` run on every rank; ``set_weights``
    reaches every rank."""
    learner = learners[("dqn", 2)]
    plain = Learner(**learner_kwargs("dqn"), data_parallel=False, device="cpu")
    learner.set_weights(plain.get_weights())
    assert len(set(_digests(learner))) == 1
    batch = transitions(9, 37, discrete=True)
    td = learner.update(SampleBatch(batch))["td_abs"]
    want = plain.update(SampleBatch({k: v[np.arange(38) % 37] for k, v in batch.items()}))["td_abs"]
    assert td.shape == (37,) and want.shape == (38,)
    np.testing.assert_allclose(td, want[:37], **TOL)

    learner.apply(_sync_target)
    assert len(set(_digests(learner))) == 1
    before = host_weights(learner.params)
    learner.apply(lambda lrn, f: [p.data.mul_(f) for p in lrn.params.parameters()], 0.5)
    for key, value in host_weights(learner.params).items():
        np.testing.assert_array_equal(value, before[key] * np.float32(0.5))
    assert len(set(_digests(learner))) == 1

    fresh = {k: np.full_like(v, 0.125) for k, v in before.items()}
    learner.set_weights(fresh)
    digests = _digests(learner)
    assert len(set(digests)) == 1
    probe = Learner(**learner_kwargs("dqn"), data_parallel=False, device="cpu")
    probe.set_weights(fresh)
    from ray_tpu_torch.rl._dp_worker import learner_report

    assert digests[0] == learner_report(probe)["params_sha256"]
