"""Weight hot-swap in the port's engine, on the CPU: ray_tpu_torch vs
ray_tpu.

``LLMEngine.update_weights`` writes the new values into the existing
parameter storage, so every runner entry point must read them at its next
call: after a swap, prefill, decode and verify give what a FRESH runner on
the new weights gives, and not what they gave before (the port's twin of
tests/test_llm_weight_swap.py); the parameters keep their storage
(``data_ptr``). Mismatched structures, shapes and dtypes and a version
going backwards raise; the prefix tree is flushed and its epoch bumped, so
a request whose prefill straddles the swap never re-inserts its old-weight
blocks (tests/test_llm_prefix.py's weight-swap flush cases); versions are
stamped on requests. A swap in the middle of traffic leaves the port and
reference engines token-identical. ``has_work``/``progress`` mirror the
reference's liveness beat.
"""

import time

import numpy as np
import pytest
import torch

import jax

from ray_tpu.llm import EngineConfig as RefEngineConfig
from ray_tpu.llm import LLMEngine as RefEngine
from ray_tpu.llm import SamplingParams as RefSamplingParams
from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.models.gpt import gpt_init as ref_gpt_init
from ray_tpu.models.gptj import GPTJConfig as RefGPTJConfig
from ray_tpu.models.gptj import gptj_init as ref_gptj_init
from ray_tpu_torch.llm import CacheConfig, EngineConfig, KVBlockPool, LLMEngine, SamplingParams
from ray_tpu_torch.llm.model_runner import PagedModelRunner
from ray_tpu_torch.models import gpt, gptj

GPT_NARROW = dict(vocab_size=320, seq_len=64, d_model=64, n_layers=2, n_heads=4, dtype="float32")
GPTJ_TINY = dict(vocab_size=128, seq_len=64, d_model=32, n_layers=2, n_heads=2, rotary_dim=8, dtype="float32")
ARCHS = {
    "gpt": (RefGPTConfig(**GPT_NARROW, remat=False, attn_impl="xla", fused_loss=False), ref_gpt_init,
            gpt.GPTConfig(**GPT_NARROW), gpt.params_from_jax),
    "gptj": (RefGPTJConfig(**GPTJ_TINY, remat=False, attn_impl="xla", fused_loss=False), ref_gptj_init,
             gptj.GPTJConfig(**GPTJ_TINY), gptj.params_from_jax),
}
GEOMETRY = dict(max_slots=3, num_blocks=32, block_size=4, max_blocks_per_seq=12, prefill_chunk=8)
BS = GEOMETRY["block_size"]
GREEDY = SamplingParams(max_tokens=6)


@pytest.fixture(scope="module", params=list(ARCHS))
def arch(request):
    """(name, reference config, port config, {seed: (reference params,
    port params)}) with two seeds' weights."""
    ref_cfg, init, cfg, from_jax = ARCHS[request.param]
    pairs = {}
    for seed in (0, 1):
        ref = init(jax.random.PRNGKey(seed), ref_cfg)
        pairs[seed] = (ref, from_jax(jax.device_get(ref), cfg, "cpu"))
    return request.param, ref_cfg, cfg, pairs


def _fresh(arch, seed):
    """A new port module holding ``seed``'s weights (engines write into
    theirs)."""
    name, ref_cfg, cfg, pairs = arch
    return ARCHS[name][3](jax.device_get(pairs[seed][0]), cfg, "cpu")


def _engine(arch, seed, **kw):
    return LLMEngine(arch[2], _fresh(arch, seed), EngineConfig(**{**GEOMETRY, **kw}), device="cpu")


def _prompt(n, seed=5, vocab=128):
    return [int(t) for t in np.random.RandomState(seed).randint(0, vocab, n)]


def _drain(eng, *reqs, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not all(r.finished for r in reqs):
        eng.step()
        assert time.monotonic() < deadline, "engine did not finish in time"


def _drive(runner, cfg):
    """One prefill chunk + one batched decode + one verify window against a
    fresh pool; returns every entry point's observable output."""
    pool = KVBlockPool(CacheConfig(num_blocks=16, block_size=BS, max_blocks_per_seq=8),
                       n_layers=cfg.n_layers, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                       dtype=torch.float32, device="cpu")
    prompt = np.random.RandomState(7).randint(1, 64, 8)
    pool.allocate("s0", 12)
    pool.allocate("s1", 12)
    last_logits = runner.prefill_chunk(pool.k, pool.v, prompt, 0, len(prompt), pool.table_row("s0"))
    tables = np.stack([pool.table_row("s0"), pool.table_row("s1")])
    knobs = (np.zeros(2, np.float32), np.zeros(2, np.int64), np.ones(2, np.float32),
             np.zeros(2, np.int64), np.zeros(2, np.int64))
    nxt, logp = runner.decode_step(pool.k, pool.v, np.array([prompt[-1], prompt[0]]),
                                   np.array([len(prompt), 0]), tables, *knobs)
    win = np.tile(prompt[:3], (2, 1))
    n_acc, out, out_lp = runner.verify_step(pool.k, pool.v, win, np.array([len(prompt) + 1, 1]), tables,
                                            *knobs)
    return {
        "prefill_logits": last_logits.numpy(), "decode_tokens": nxt.numpy(), "decode_logprobs": logp.numpy(),
        "verify_accepted": n_acc.numpy(), "verify_tokens": out.numpy(), "verify_logprobs": out_lp.numpy(),
        "pool": pool,
    }


def test_every_runner_entry_point_reflects_the_swap(arch):
    eng = _engine(arch, 0)
    cfg = arch[2]
    before = _drive(eng.runner, cfg)
    ptrs = {n: p.data_ptr() for n, p in eng.runner.params.named_parameters()}
    assert eng.update_weights(_fresh(arch, 1)) == 1
    after = _drive(eng.runner, cfg)
    fresh = _drive(PagedModelRunner(cfg, _fresh(arch, 1), BS), cfg)
    for key in ("prefill_logits", "decode_tokens", "decode_logprobs", "verify_accepted", "verify_tokens",
                "verify_logprobs"):
        np.testing.assert_allclose(after[key], fresh[key], rtol=1e-5, atol=1e-5,
                                   err_msg=f"{key}: the swapped runner diverges from a fresh one")
    # the swap must actually CHANGE the outputs, or the check above is vacuous
    assert not np.allclose(before["prefill_logits"], after["prefill_logits"])
    assert not np.allclose(before["decode_logprobs"], after["decode_logprobs"])
    # written in place: every parameter keeps its storage
    assert {n: p.data_ptr() for n, p in eng.runner.params.named_parameters()} == ptrs


def test_fork_blocks_is_params_independent(arch):
    eng = _engine(arch, 0)
    state = _drive(eng.runner, arch[2])
    pool = state["pool"]
    src, dst = pool.blocks_of("s0")[0], pool.blocks_of("s1")[-1]
    eng.update_weights(_fresh(arch, 1))  # swap BEFORE the fork: the copy must not care
    eng.runner.fork_blocks(pool.k, pool.v, np.array([src]), np.array([dst]))
    assert torch.equal(pool.k[:, dst], pool.k[:, src]) and torch.equal(pool.v[:, dst], pool.v[:, src])


def test_mismatches_and_backward_versions_raise(arch):
    name, ref_cfg, cfg, pairs = arch
    eng = _engine(arch, 0)
    params = eng.runner.params
    ptr = params.lm_head.weight.data_ptr()
    # structure: one layer fewer; shape: another width; dtype: a parameter cast
    fewer = type(params)(type(cfg)(**{**vars(cfg), "n_layers": 1}), device="cpu")
    wider = type(params)(type(cfg)(**{**vars(cfg), "d_model": 2 * cfg.d_model}), device="cpu")
    cast = _fresh(arch, 1)
    cast.ln_f.scale.data = cast.ln_f.scale.data.double()
    for bad, match in ((fewer, "structure"), (wider, "mismatch at"), (cast, "mismatch at ln_f.scale")):
        with pytest.raises(ValueError, match=match):
            eng.update_weights(bad)
    assert eng.weights_version == 0
    assert eng.update_weights(_fresh(arch, 1), version=5) == 5
    with pytest.raises(ValueError, match="backwards"):
        eng.update_weights(_fresh(arch, 1), version=4)
    assert eng.update_weights(_fresh(arch, 0)) == 6 == eng.weights_version == eng.stats()["weights_version"]
    assert params.lm_head.weight.data_ptr() == ptr and eng.runner.params is params


def test_update_weights_flushes_tree(arch):
    """Mirrors tests/test_llm_prefix.py's TestWeightSwapFlush: a swap to the
    same weights drops every cached block (reason "weights_update", epoch
    bumped, the pool back to all free) and the regeneration is recomputed,
    identical."""
    eng = _engine(arch, 0)
    flushes = []
    flush = eng.prefix_cache.flush
    eng.prefix_cache.flush = lambda reason="flush": flushes.append(reason) or flush(reason)
    prompt = _prompt(9)
    want = eng.generate(prompt, GREEDY)
    assert eng.prefix_cache.stats()["cached_blocks"] > 0
    epoch = eng.prefix_cache.epoch
    eng.update_weights(eng.runner.params)  # the same weights, a new version
    assert flushes == ["weights_update"] and eng.prefix_cache.epoch == epoch + 1
    assert eng.prefix_cache.stats()["cached_blocks"] == 0
    assert eng.pool.num_free_blocks == eng.pool.cfg.num_blocks - 1
    hits = eng.prefix_cache.stats()["hit_tokens"]
    assert eng.generate(prompt, GREEDY) == want
    assert eng.prefix_cache.stats()["hit_tokens"] == hits  # recomputed, not seeded from the flushed tree
    assert eng.pool.audit()["ok"] and eng.prefix_cache.audit()["ok"]


def test_mid_prefill_weight_swap_never_reinserts_stale_kv(arch):
    """The epoch guard: a request whose chunked prefill STRADDLES a swap
    computed some of its KV under the old weights; its later chunks must
    not register blocks into the flushed tree, or a follow-up request
    would seed stale KV and diverge from an engine on the new weights."""
    eng = _engine(arch, 0, prefill_chunk=4)
    prompt = _prompt(12)
    req = eng.submit(prompt, GREEDY)
    eng.step()  # admit + first chunk only
    assert req.prefill_pos < len(prompt) and req.cache_epoch == 0
    eng.update_weights(_fresh(arch, 1))  # flush mid-prefill
    _drain(eng, req)  # finishes under the new weights
    assert eng.prefix_cache.stats()["cached_blocks"] == 0
    want = _engine(arch, 1).generate(prompt, GREEDY)
    later = eng.submit(prompt, GREEDY)
    _drain(eng, later)
    assert later.out == want and later.cache_epoch == 1
    assert eng.prefix_cache.stats()["cached_blocks"] > 0  # a fresh request may populate the tree
    assert eng.generate(prompt, GREEDY) == want  # warm, still new-weight exact
    assert eng.pool.audit()["ok"] and eng.prefix_cache.audit()["ok"]


def test_swap_mid_traffic_matches_reference_and_stamps_versions(arch):
    """The same requests and the same swap at the same step on both sides:
    in-flight requests continue under the new weights, token-identical to
    the reference engine; each request carries the version it was
    submitted under."""
    name, ref_cfg, cfg, pairs = arch
    eng = _engine(arch, 0)
    ref = RefEngine(ref_cfg, pairs[0][0], RefEngineConfig(**GEOMETRY))
    prompts = [_prompt(7, seed=s) for s in (11, 12)]
    sides = []
    for e, sp_cls, new in ((eng, SamplingParams, lambda: _fresh(arch, 1)), (ref, RefSamplingParams,
                                                                          lambda: pairs[1][0])):
        early = [e.submit(p, sp_cls(max_tokens=10)) for p in prompts]
        for _ in range(5):
            e.step()
        assert not any(r.finished for r in early) and all(len(r.out) > 0 for r in early)
        assert e.update_weights(new()) == 1
        late = e.submit(_prompt(5, seed=13), sp_cls(max_tokens=6))
        _drain(e, *early, late)
        assert [r.weights_version for r in early] == [0, 0] and late.weights_version == 1
        sides.append([list(r.out) for r in (*early, late)])
    assert sides[0] == sides[1]
    assert eng.pool.audit()["ok"] and eng.prefix_cache.audit()["ok"]


def test_has_work_and_progress(arch):
    eng = _engine(arch, 0)
    assert eng.has_work() is False
    age, pending = eng.progress()
    assert age >= 0 and pending == 0
    req = eng.submit(_prompt(6), GREEDY)
    assert eng.has_work() is True
    assert eng.progress()[1] == 1
    time.sleep(0.01)
    assert eng.progress()[0] >= 0.01  # work waits; the clock runs from the submit
    eng.step()
    age, pending = eng.progress()
    assert age < 1.0 and pending == 1
    _drain(eng, req)
    eng.step()  # an idle tick beats too
    assert eng.has_work() is False and eng.progress()[1] == 0
