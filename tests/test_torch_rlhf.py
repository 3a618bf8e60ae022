"""The port's ``rlhf`` (``ray_tpu_torch.rlhf``) against the reference's
``ray_tpu.rlhf``, on the CPU.

Parity: the golden math (staleness gate, importance ratios, group
advantages) on the same seeded inputs; ``rlhf_loss`` and its gradients at a
2-layer GPT with the reference's weights carried across (fp32, 1e-5); the
same prompts, seeds and weights through both packages' ``RolloutWorker``
give equal greedy tokens and logprobs, and the port's sampled tokens carry
the behavior logprobs the reference's ``gpt_forward``/``token_logprobs``
give them; publish → fetch → apply through the port's object plane leaves
the port's engine generating what the reference's engine generates after
the same swap; the learner's recomputed logprobs equal the engine's behavior
logprobs at version 0, and an off-by-one index does not.

Mirrors: every test of ``tests/test_rlhf.py`` (its ``slow`` marks kept),
plus one local-mode loop of two iterations in tier 1. Entry points are
given ``device="cpu"``: without it they mean the card.
"""

import math
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_tpu_torch
from ray_tpu.llm.engine import EngineConfig as RefEngineConfig
from ray_tpu.llm.engine import LLMEngine as RefEngine
from ray_tpu.llm.scheduler import SamplingParams as RefSamplingParams
from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.models.gpt import gpt_forward as ref_gpt_forward
from ray_tpu.models.gpt import gpt_init as ref_gpt_init
from ray_tpu.models.sampling import token_logprobs as ref_token_logprobs
from ray_tpu.rlhf import algorithm as ref_algorithm
from ray_tpu.rlhf.learner import GPTPolicyModule as RefPolicy
from ray_tpu.rlhf.learner import rlhf_loss as ref_rlhf_loss
from ray_tpu.rlhf.rollout import RolloutWorker as RefRolloutWorker
from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine
from ray_tpu_torch.llm.scheduler import SamplingParams
from ray_tpu_torch.models.gpt import GPTConfig, params_from_jax, params_to_numpy
from ray_tpu_torch.rlhf import (
    Algorithm,
    RLHFConfig,
    RolloutWorker,
    TrajectoryBuffer,
    apply_weight_update,
    fetch_params,
    group_advantages,
    importance_ratios,
    publish_weights,
    staleness_weights,
)
from ray_tpu_torch.rlhf.learner import GPTPolicyModule, rlhf_loss

TINY_KW = dict(vocab_size=32, seq_len=64, d_model=32, n_layers=1, n_heads=2,
               remat=False, fused_loss=False, dtype="float32")
TINY = GPTConfig(**TINY_KW)
REF_TINY = RefGPTConfig(**TINY_KW, attn_impl="xla")
ENG_KW = dict(max_slots=4, num_blocks=64, block_size=4, max_blocks_per_seq=8, prefill_chunk=8)
ENG = EngineConfig(**ENG_KW)
REF_ENG = RefEngineConfig(**ENG_KW)
#: the 2-layer GPT of the loss and rollout parity checks
NARROW_KW = dict(vocab_size=128, seq_len=48, d_model=64, n_layers=2, n_heads=4,
                 remat=False, fused_loss=False, dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _warm_exp():
    # a process's first multi-threaded torch.exp can be off under load
    # (ROADMAP §C.1): make it here, before any fp32 comparison
    torch.exp(torch.linspace(-5, 5, 1 << 16))


@pytest.fixture(scope="module")
def ref_trees():
    """{seed: reference params (numpy tree)} for the tiny GPT."""
    return {s: jax.device_get(ref_gpt_init(jax.random.PRNGKey(s), REF_TINY)) for s in (0, 9)}


def _port(tree, cfg=TINY):
    """A fresh port module holding a reference tree (engines write into theirs)."""
    return params_from_jax(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def tiny_params(ref_trees):
    return _port(ref_trees[0])


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=6, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def _engine(tree):
    return LLMEngine(TINY, _port(tree), ENG, device="cpu")


# ---------------------------------------------------------------------------
# unit: staleness gate + importance correction (golden-pinned)
# ---------------------------------------------------------------------------


class TestStalenessGate:
    def test_drop_mode_version_k_boundary(self):
        w = staleness_weights([0, 1, 3, 4, 5, 9], max_staleness=4, mode="drop")
        np.testing.assert_array_equal(w, [1.0, 1.0, 1.0, 1.0, 0.0, 0.0])

    def test_downweight_mode_goldens(self):
        w = staleness_weights([0, 2, 3, 4, 6], max_staleness=2, mode="downweight", halflife=1.0)
        np.testing.assert_allclose(w, [1.0, 1.0, 0.5, 0.25, 0.0625], atol=1e-7)

    def test_downweight_halflife_scales(self):
        w = staleness_weights([4], max_staleness=0, mode="downweight", halflife=2.0)
        np.testing.assert_allclose(w, [0.25], atol=1e-7)

    def test_negative_age_counts_as_fresh(self):
        assert staleness_weights([-3], 0, "drop")[0] == 1.0

    def test_unknown_mode_raises(self):
        with pytest.raises(ValueError):
            staleness_weights([1], 1, mode="decay")


class TestImportanceCorrection:
    def test_ratio_goldens(self):
        behavior = np.log([0.5, 0.25, 0.1])
        current = np.log([0.25, 0.25, 0.2])
        np.testing.assert_allclose(importance_ratios(behavior, current), [0.5, 1.0, 2.0], atol=1e-6)

    def test_clip_golden(self):
        r = importance_ratios(np.log([0.5, 0.1, 0.4]), np.log([0.25, 0.9, 0.4]), clip=0.2)
        np.testing.assert_allclose(r, [0.8, 1.2, 1.0], atol=1e-6)

    def test_group_advantages_standardize(self):
        adv = group_advantages([1.0, 2.0, 3.0])
        np.testing.assert_allclose(adv.mean(), 0.0, atol=1e-6)
        np.testing.assert_allclose(adv.std(), 1.0, atol=1e-5)

    def test_group_advantages_zero_variance_is_zero(self):
        np.testing.assert_array_equal(group_advantages([0.3, 0.3, 0.3]), [0.0, 0.0, 0.0])


def test_golden_math_matches_the_reference():
    rng = np.random.default_rng(0)
    ages = rng.integers(-3, 12, 200)
    for mode, halflife in (("drop", 1.0), ("downweight", 1.0), ("downweight", 2.5)):
        np.testing.assert_array_equal(
            staleness_weights(ages, 4, mode, halflife),
            ref_algorithm.staleness_weights(ages, 4, mode, halflife),
        )
    behavior, current = rng.normal(-2, 1, 500), rng.normal(-2, 1, 500)
    for clip in (None, 0.2):
        np.testing.assert_array_equal(importance_ratios(behavior, current, clip),
                                      ref_algorithm.importance_ratios(behavior, current, clip))
    for rewards in (rng.random(32), np.full(8, 0.5)):
        np.testing.assert_array_equal(group_advantages(rewards), ref_algorithm.group_advantages(rewards))


class TestTrajectoryBuffer:
    def test_fifo_and_overflow_drops_oldest(self):
        buf = TrajectoryBuffer(capacity=3)
        buf.add([{"i": k} for k in range(5)])
        assert [t["i"] for t in buf.take(3, timeout=1)] == [2, 3, 4]
        assert buf.stats()["dropped_overflow"] == 2

    def test_take_blocks_until_staged(self):
        buf = TrajectoryBuffer(capacity=8)
        got = []

        def consumer():
            got.extend(buf.take(2, timeout=5))

        th = threading.Thread(target=consumer)
        th.start()
        time.sleep(0.05)
        buf.add([{"i": 1}, {"i": 2}])
        th.join(timeout=5)
        assert len(got) == 2

    def test_take_timeout_returns_partial(self):
        buf = TrajectoryBuffer(capacity=8)
        buf.add([{"i": 1}])
        assert len(buf.take(4, timeout=0.05)) == 1


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


class TestLoss:
    def _batch(self, **over):
        B, T, O = 2, 8, 4
        base = dict(
            tokens=np.tile(np.arange(T, dtype=np.int32), (B, 1)),
            prompt_len=np.full(B, 3, np.int32),
            out_tokens=np.tile(np.arange(3, 3 + O, dtype=np.int32), (B, 1)),
            out_len=np.full(B, O, np.int32),
            behavior_logp=np.full((B, O), -2.0, np.float32),
            token_mask=np.ones((B, O), np.float32),
            advantage=np.asarray([1.0, -1.0], np.float32),
            weight=np.ones(B, np.float32),
            temperature=np.ones(B, np.float32),
            top_k=np.zeros(B, np.int32),
            top_p=np.ones(B, np.float32),
        )
        base.update(over)
        return {k: torch.from_numpy(np.asarray(v)) for k, v in base.items()}

    def test_token_mask_excludes_unknown_behavior(self, tiny_params):
        """A masked token must contribute NOTHING: garbage (and NaN)
        behavior_logp under mask 0 leaves the loss bit-identical (the
        failover-resume NaN contract)."""
        module = GPTPolicyModule(TINY)
        loss_fn = rlhf_loss(clip_param=0.2)
        mask = np.ones((2, 4), np.float32)
        mask[0, 1] = 0.0
        blp = np.full((2, 4), -2.0, np.float32)
        l1, m1 = loss_fn(module, tiny_params, self._batch(token_mask=mask, behavior_logp=blp))
        for garbage in (123.0, np.nan):
            blp2 = blp.copy()
            blp2[0, 1] = garbage
            l2, m2 = loss_fn(module, tiny_params, self._batch(token_mask=mask, behavior_logp=blp2))
            assert l1.item() == l2.item()
            assert m1["kl"].item() == m2["kl"].item()

    def test_kl_finite_when_current_filter_masks_behavior_token(self, tiny_params):
        module = GPTPolicyModule(TINY)
        loss_fn = rlhf_loss(clip_param=0.2, kl_coeff=0.01)
        loss, metrics = loss_fn(module, tiny_params, self._batch(top_k=np.ones(2, np.int32)))
        assert np.isfinite(loss.item())
        assert abs(metrics["kl"].item()) <= 20.0 + 1e-6


def _loss_batch(seed=3, B=4, T=20, O=8, vocab=128):
    rng = np.random.default_rng(seed)
    prompt_len = rng.integers(4, T - O + 1, B).astype(np.int32)
    out_len = rng.integers(3, O + 1, B).astype(np.int32)
    tokens = np.zeros((B, T), np.int32)
    out_tokens = np.zeros((B, O), np.int32)
    for i in range(B):
        seq = rng.integers(0, vocab, prompt_len[i] + out_len[i])
        tokens[i, : len(seq)] = seq
        out_tokens[i, : out_len[i]] = seq[prompt_len[i]:]
    mask = np.ones((B, O), np.float32)
    mask[1, 2] = 0.0
    return dict(
        tokens=tokens, prompt_len=prompt_len, out_tokens=out_tokens, out_len=out_len,
        behavior_logp=rng.normal(-5.0, 0.5, (B, O)).astype(np.float32), token_mask=mask,
        advantage=rng.standard_normal(B).astype(np.float32),
        weight=np.asarray([1.0, 1.0, 0.5, 0.0], np.float32)[:B],
        temperature=np.asarray([1.0, 0.7, 1.3, 1.0], np.float32)[:B],
        top_k=np.asarray([0, 20, 0, 50], np.int32)[:B],
        top_p=np.asarray([1.0, 1.0, 0.9, 0.95], np.float32)[:B],
    )


@pytest.mark.parametrize("kl_coeff", [0.0, 0.1])
def test_rlhf_loss_and_gradients_match_the_reference(kl_coeff):
    ref_cfg, cfg = RefGPTConfig(**NARROW_KW, attn_impl="xla"), GPTConfig(**NARROW_KW)
    tree = jax.device_get(ref_gpt_init(jax.random.PRNGKey(4), ref_cfg))
    batch = _loss_batch()
    ref_fn = ref_rlhf_loss(clip_param=0.2, kl_coeff=kl_coeff)
    (ref_loss, ref_m), ref_grads = jax.value_and_grad(
        lambda p: ref_fn(RefPolicy(ref_cfg), p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True,
    )(tree)
    params = _port(tree, cfg)
    loss, metrics = rlhf_loss(clip_param=0.2, kl_coeff=kl_coeff)(
        GPTPolicyModule(cfg), params, {k: torch.from_numpy(v) for k, v in batch.items()}
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **TOL)
    for key, value in ref_m.items():
        np.testing.assert_allclose(metrics[key].item(), float(value), **TOL, err_msg=key)
    assert 0 < metrics["clip_frac"].item() < 1  # the clip is active on some tokens
    grads = params_from_jax(tree, cfg, "cpu")
    for g, p in zip(grads.parameters(), params.parameters()):
        g.data = p.grad
    got, want = params_to_numpy(grads), jax.device_get(ref_grads)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(g, flat_want[path], **TOL, err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# engine hot-swap (no cluster)
# ---------------------------------------------------------------------------


class TestEngineHotSwap:
    def test_swap_without_draining_in_flight(self, ref_trees):
        eng = _engine(ref_trees[0])
        req = eng.submit([1, 2, 3], SamplingParams(max_tokens=12, temperature=1.0, seed=1))
        for _ in range(4):
            eng.step()
        mid = len(req.out)
        assert 0 < mid < 12 and req.weights_version == 0
        assert eng.update_weights(_port(ref_trees[9]), 1) == 1
        while not req.finished:
            eng.step()
        assert len(req.out) == 12 and req.finish_reason == "length"
        assert req.weights_version == 0  # stamped at submit
        assert not any(math.isnan(x) for x in req.out_logprobs)
        req2 = eng.submit([1], SamplingParams(max_tokens=2))
        assert req2.weights_version == 1

    def test_swap_changes_future_tokens_deterministically(self, ref_trees):
        sp = SamplingParams(max_tokens=8, temperature=1.0, seed=4)

        def gen(engine):
            r = engine.submit([2, 3, 4], sp)
            while not r.finished:
                engine.step()
            return r.out

        e0 = _engine(ref_trees[0])
        base = gen(e0)
        e0.update_weights(_port(ref_trees[9]), 1)
        swapped = gen(e0)
        fresh = gen(_engine(ref_trees[9]))
        assert swapped == fresh
        assert swapped != base

    def test_structure_and_shape_mismatch_rejected(self, ref_trees):
        eng = _engine(ref_trees[0])
        with pytest.raises(ValueError, match="structure"):
            eng.update_weights({"not": torch.zeros(2)}, 1)
        bigger = GPTConfig(**{**TINY_KW, "d_model": 64})
        from ray_tpu_torch.models.gpt import gpt_init

        with pytest.raises(ValueError, match="mismatch"):
            eng.update_weights(gpt_init(bigger, torch.Generator().manual_seed(1), "cpu"), 1)

    def test_version_never_goes_backwards(self, ref_trees):
        eng = _engine(ref_trees[0])
        params = _port(ref_trees[0])
        eng.update_weights(params, 3)
        with pytest.raises(ValueError, match="backwards"):
            eng.update_weights(params, 2)
        assert eng.update_weights(params, 3) == 3
        assert eng.update_weights(params) == 4


# ---------------------------------------------------------------------------
# object-plane sync + rollout worker (cluster)
# ---------------------------------------------------------------------------


def _poll(worker, n, timeout=30.0):
    deadline = time.time() + timeout
    trajs = []
    while len(trajs) < n and time.time() < deadline:
        trajs += worker.poll()["trajs"]
        time.sleep(0.01)
    return trajs


class TestWeightSync:
    def test_publish_fetch_roundtrip_chunked(self, cluster, tiny_params):
        update = publish_weights(tiny_params, 7, chunk_bytes=16 << 10)
        assert update.version == 7
        assert len(update.chunk_refs) > 1  # actually chunked
        assert update.num_leaves == len(tiny_params.state_dict())
        assert update.names == list(tiny_params.state_dict())
        got = fetch_params(update)
        assert list(got) == update.names
        for name, value in tiny_params.state_dict().items():
            np.testing.assert_array_equal(got[name], value.numpy())

    def test_apply_weight_update_engine_path(self, cluster, ref_trees):
        eng = _engine(ref_trees[0])
        update = publish_weights(_port(ref_trees[9]), 2)
        assert apply_weight_update(eng, update) == 2
        assert eng.weights_version == 2

    def test_rollout_worker_trajectory_contract(self, cluster):
        w = RolloutWorker(model="gpt", model_cfg=TINY, engine_config=ENG, seed=0, warmup=False,
                          device="cpu")
        try:
            assert w.submit([[1, 2, 3], [3, 2, 1]], max_tokens=5, temperature=1.0) == 2
            trajs = _poll(w, 2)
            assert len(trajs) == 2
            for t in trajs:
                assert len(t["tokens"]) == 5
                assert len(t["logprobs"]) == 5
                assert all(np.isfinite(t["logprobs"]))
                assert t["weights_version"] == 0
                assert t["finish_reason"] == "length"
            from ray_tpu_torch.models.gpt import gpt_init

            other = gpt_init(TINY, torch.Generator().manual_seed(9), "cpu")
            assert w.update_weights(publish_weights(other, 1)) == 1
            w.submit([[1, 2]], max_tokens=2)
            out = _poll(w, 1)
            assert out and out[0]["weights_version"] == 1
        finally:
            w.stop()

    def test_distinct_seed_lanes_diverge(self, cluster):
        outs = []
        for base in (0, 1_000_003):
            w = RolloutWorker(model="gpt", model_cfg=TINY, engine_config=ENG, seed=0,
                              sample_seed_base=base, warmup=False, device="cpu")
            try:
                w.submit([[1, 2, 3]], max_tokens=8, temperature=1.0)
                outs.append(_poll(w, 1)[0]["tokens"])
            finally:
                w.stop()
        assert outs[0] != outs[1]


def test_manifest_push_leaves_port_engine_equal_to_reference_engine(cluster, ref_trees):
    """publish → fetch → apply through the port's object plane; the
    reference engine takes the same swap; both then generate the same
    greedy tokens with the same logprobs."""
    port_eng = _engine(ref_trees[0])
    ref_eng = RefEngine(REF_TINY, jax.tree_util.tree_map(jnp.asarray, ref_trees[0]), REF_ENG)
    assert apply_weight_update(port_eng, publish_weights(_port(ref_trees[9]), 1, chunk_bytes=4 << 10)) == 1
    ref_eng.update_weights(jax.tree_util.tree_map(jnp.asarray, ref_trees[9]), 1)
    prompts = [[1, 2, 3], [5, 9, 7, 5, 9], [30, 2]]
    got = [port_eng.submit(p, SamplingParams(max_tokens=10)) for p in prompts]
    want = [ref_eng.submit(p, RefSamplingParams(max_tokens=10)) for p in prompts]
    while not all(r.finished for r in got):
        port_eng.step()
    while not all(r.finished for r in want):
        ref_eng.step()
    for g, w in zip(got, want):
        assert g.out == w.out
        np.testing.assert_allclose(g.out_logprobs, w.out_logprobs, **TOL)


def _worker_pair(tree_seed=5, **kw):
    ref_cfg, cfg = RefGPTConfig(**NARROW_KW, attn_impl="xla"), GPTConfig(**NARROW_KW)
    tree = jax.device_get(ref_gpt_init(jax.random.PRNGKey(tree_seed), ref_cfg))
    eng = dict(max_slots=4, num_blocks=96, block_size=4, max_blocks_per_seq=12, prefill_chunk=8)
    port = RolloutWorker(model="gpt", model_cfg=cfg, engine_config=EngineConfig(**eng),
                         params=_port(tree, cfg), warmup=False, device="cpu", **kw)
    ref = RefRolloutWorker(model="gpt", model_cfg=ref_cfg, engine_config=RefEngineConfig(**eng),
                           params=jax.tree_util.tree_map(jnp.asarray, tree), warmup=False, **kw)
    return ref_cfg, tree, port, ref


PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(0, 128, n)] for s, n in ((0, 5), (1, 9), (2, 14))]


def test_rollout_workers_give_equal_greedy_trajectories():
    _, _, port, ref = _worker_pair()
    try:
        port.submit(PROMPTS, max_tokens=12, temperature=0.0)
        ref.submit(PROMPTS, max_tokens=12, temperature=0.0)
        got = sorted(_poll(port, 3), key=lambda t: t["prompt"])
        want = sorted(_poll(ref, 3), key=lambda t: t["prompt"])
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g["tokens"] == w["tokens"]
            np.testing.assert_allclose(g["logprobs"], w["logprobs"], **TOL)
            assert g["weights_version"] == w["weights_version"] == 0
    finally:
        port.stop()
        ref.stop()


def test_sampled_behavior_logprobs_equal_the_reference_scoring():
    """The port's sampled tokens differ from the reference's (its RNG is not
    JAX's), but each carries the logprob the reference's ``gpt_forward`` and
    ``token_logprobs`` give it under the same knobs."""
    ref_cfg, tree, port, ref = _worker_pair()
    ref.stop()
    knobs = dict(temperature=0.8, top_k=20, top_p=0.9)
    try:
        port.submit(PROMPTS, max_tokens=10, **knobs)
        trajs = _poll(port, 3)
    finally:
        port.stop()
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    for t in trajs:
        seq = jnp.asarray([t["prompt"] + t["tokens"]])
        logits = ref_gpt_forward(ref_cfg, params, seq)[0]
        p = len(t["prompt"])
        pos = logits[p - 1: p - 1 + len(t["tokens"])]
        n = len(t["tokens"])
        want = ref_token_logprobs(pos, jnp.asarray(t["tokens"]), jnp.full(n, 0.8),
                                  jnp.full(n, 20), jnp.full(n, 0.9))
        np.testing.assert_allclose(t["logprobs"], np.asarray(want), **TOL)


def test_learner_recomputes_behavior_logprobs_on_policy_and_off_by_one_does_not():
    """At version 0 the learner's logprobs (through ``gpt_forward`` at index
    prompt_len - 1 + j) equal the engine's behavior logprobs: ratio 1, KL 0.
    The same batch read one position late is far off."""
    from ray_tpu_torch.rlhf.algorithm import build_batch
    from ray_tpu_torch.rlhf.learner import policy_logprobs

    cfg = GPTConfig(**NARROW_KW)
    _, tree, port, ref = _worker_pair()
    ref.stop()
    try:
        port.submit(PROMPTS, max_tokens=10, temperature=0.8, top_k=20, top_p=0.9)
        trajs = _poll(port, 3)
    finally:
        port.stop()
    batch = build_batch([(t, 1.0, 0) for t in trajs], np.ones(len(trajs), np.float32),
                        max(map(len, PROMPTS)) + 10, 10, 0.8, 20, 0.9)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = _port(tree, cfg)
    mask = batch["token_mask"] * (np.arange(10)[None, :] < batch["out_len"][:, None])
    with torch.no_grad():
        _, m = rlhf_loss()(GPTPolicyModule(cfg), params, tensors)
        assert abs(m["mean_ratio"].item() - 1.0) < 1e-5 and abs(m["kl"].item()) < 1e-5
        gap = np.abs(policy_logprobs(cfg, params, tensors).numpy() - batch["behavior_logp"])
        late_batch = dict(tensors, prompt_len=tensors["prompt_len"] + 1)  # read one position late
        late = np.abs(policy_logprobs(cfg, params, late_batch).numpy() - batch["behavior_logp"])
    assert gap[mask > 0].max() < 1e-5
    assert late[mask > 0].mean() > 0.1


# ---------------------------------------------------------------------------
# serve-hosted engines accept the same push path
# ---------------------------------------------------------------------------


@pytest.fixture
def serve_instance(cluster):
    from ray_tpu_torch import serve

    yield
    serve.shutdown()


@pytest.mark.slow
def test_serve_deployment_update_weights(serve_instance, ref_trees):
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import build_llm_app

    handle = serve.run(
        build_llm_app(model="gpt", model_cfg=TINY, engine_config=ENG, warmup=False, device="cpu"),
        name="rlhf-push",
    )
    prompt = [1, 2, 3]
    before = handle.generate.remote(prompt, max_tokens=6).result(timeout=60)
    assert len(before) == 6
    assert handle.weights_version.remote().result(timeout=30) == 0
    other = _port(ref_trees[9])
    update = publish_weights(other, 1)
    assert handle.update_weights.remote(update).result(timeout=60) == 1
    assert handle.weights_version.remote().result(timeout=30) == 1
    after = handle.generate.remote(prompt, max_tokens=6).result(timeout=60)
    assert after == _engine(ref_trees[9]).generate(prompt, SamplingParams(max_tokens=6))


# ---------------------------------------------------------------------------
# the async loop end to end
# ---------------------------------------------------------------------------

TARGET = 7


def _reward(prompt, tokens):
    return sum(1 for t in tokens if t == TARGET) / max(len(tokens), 1)


def _local_loop(iterations):
    cfg = RLHFConfig(
        model_cfg=TINY, engine_config=ENG,
        prompts=[[1, 2, 3]], reward_fn=_reward,
        num_rollout_workers=1, remote_rollouts=False, rollout_inflight=4,
        max_tokens=4, temperature=1.0, train_batch=4,
        buffer_capacity=8, lr=0.05, max_staleness=8, warmup=False,
        batch_timeout_s=60.0, seed=0, device="cpu",
    )
    algo = Algorithm(cfg)
    try:
        out = algo.train(iterations)
        real = [o for o in out if not o.get("skipped")]
        assert len(real) == iterations
        assert algo.weights_version == iterations
        assert algo.rollouts.versions() == [iterations]
        if iterations >= 3:  # by then a batch was generated after a push
            assert any(v > 0 for v in algo.stats()["last_batch_versions"])
        for o in real:
            assert o["trajectories"] == 4
            assert "learner/loss" in o and np.isfinite(o["learner/loss"])
    finally:
        algo.shutdown()


def test_async_loop_local_mode_two_iterations(cluster):
    """The whole loop minus actors, in tier 1: poller stages, gate admits,
    learner updates, weights publish + apply, versions stamp."""
    _local_loop(2)


@pytest.mark.slow
def test_async_loop_local_mode(cluster):
    _local_loop(3)


@pytest.mark.slow
def test_async_rlhf_learns_with_overlap():
    """The port's smoke (the reference's config, on the CPU), run as
    ``python -m ray_tpu_torch.rlhf.smoke --device cpu`` in its own process
    (it starts its own runtime): reward improves while rollout and learner
    provably overlap, and consumed batches carry post-push version stamps."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.rlhf.smoke", "--device", "cpu"], cwd=repo,
        env={**os.environ, "PYTHONPATH": str(repo)}, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["iterations"] >= 8, rec
    assert rec["overlapped"], rec
    assert rec["versions_advanced"], rec
    assert rec["improved"], rec
