"""Speculative decoding in the port, on the CPU: ray_tpu_torch vs ray_tpu.

Drafters and the prefix cache's drafting corpus take the same inputs on
both sides and must propose the same tokens. The spec engine runs the
reference's TINY GPT-J weights (carried over with ``params_from_jax``):
greedy output must be identical to the reference engine and to the
reference's dense ``gptj_decode``, and fresh engines on both sides must
report the same proposed and accepted draft counts for the same request
sequence — through mixed prefill and decode, stop tokens inside the
window, preemption, the model drafter, the length cap inside the window,
backoff and the no-match gate (the cases of tests/test_llm_spec.py; its
GPT-arch cases are in tests/test_torch_gpt_serve.py). Sampled
spec output is checked within the port: it reproduces per seed and equals
the port's plain engine.
"""

import functools
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.llm import EngineConfig as RefEngineConfig
from ray_tpu.llm import LLMEngine as RefEngine
from ray_tpu.llm import SamplingParams as RefSamplingParams
from ray_tpu.llm.cache import CacheConfig as RefCacheConfig
from ray_tpu.llm.cache import KVBlockPool as RefKVBlockPool
from ray_tpu.llm.drafter import NGramDrafter as RefNGramDrafter
from ray_tpu.llm.drafter import SmallModelDrafter as RefSmallModelDrafter
from ray_tpu.llm.prefix_cache import PrefixCache as RefPrefixCache
from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.models.gptj import GPTJConfig as RefGPTJConfig
from ray_tpu.models.gptj import gptj_decode as ref_gptj_decode
from ray_tpu.models.gptj import gptj_init as ref_gptj_init
from ray_tpu_torch.llm import (
    CacheConfig,
    EngineConfig,
    KVBlockPool,
    LLMEngine,
    NGramDrafter,
    PrefixCache,
    SamplingParams,
    SmallModelDrafter,
    make_drafter,
)
from ray_tpu_torch.models.gpt import GPTConfig, gpt_init
from ray_tpu_torch.models.gptj import GPTJConfig, params_from_jax

TINY_REF = RefGPTJConfig(
    vocab_size=128, seq_len=64, d_model=32, n_layers=2, n_heads=2,
    rotary_dim=8, dtype="float32", remat=False, attn_impl="xla",
    fused_loss=False,
)
TINY = GPTJConfig(
    vocab_size=128, seq_len=64, d_model=32, n_layers=2, n_heads=2, rotary_dim=8, dtype="float32"
)
GEOMETRY = dict(max_slots=3, num_blocks=32, block_size=4, max_blocks_per_seq=12, prefill_chunk=8)
PERIODIC = [5, 9, 7, 5, 9, 7, 5, 9]


@pytest.fixture(scope="module")
def ref_params():
    return ref_gptj_init(jax.random.PRNGKey(0), TINY_REF)


@pytest.fixture(scope="module")
def port_params(ref_params):
    return params_from_jax(jax.device_get(ref_params), TINY, "cpu")


@pytest.fixture(scope="module")
def draft_params():
    """The reference's draft model (a DIFFERENT random model) on both sides."""
    ref = ref_gptj_init(jax.random.PRNGKey(42), TINY_REF)
    return ref, params_from_jax(jax.device_get(ref), TINY, "cpu")


@pytest.fixture(scope="module")
def spec_engine(port_params):
    """One warmed-up n-gram-drafted port engine shared by the tests that
    need no fresh counts; each leaves it drained."""
    eng = _engine(port_params, spec_k=3)
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def dense(ref_params):
    @functools.lru_cache(maxsize=None)
    def decode(prompt: tuple, n_new: int) -> list:
        out = ref_gptj_decode(TINY_REF, ref_params, jnp.asarray([prompt], jnp.int32), n_new)
        return [int(t) for t in np.asarray(out)[0, len(prompt):]]

    return lambda prompt, n_new: decode(tuple(int(t) for t in prompt), n_new)


def _engine(params, **kw):
    return LLMEngine(TINY, params, EngineConfig(**{**GEOMETRY, **kw}), device="cpu")


def _ref_engine(params, **kw):
    return RefEngine(TINY_REF, params, RefEngineConfig(**{**GEOMETRY, **kw}))


def _prompt(n, seed=1):
    return [int(t) for t in np.random.RandomState(seed).randint(0, TINY.vocab_size, n)]


def _drive(eng, reqs, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not all(r.finished for r in reqs):
        eng.step()
        assert time.monotonic() < deadline, "engine did not finish in time"


def _audits_clean(eng):
    assert eng.pool.audit()["ok"]
    assert eng.prefix_cache.audit()["ok"]


def _run_sequence(eng, sp_cls, prompts, max_tokens, staggered=False):
    """Submit ``prompts`` (the first one step ahead of the rest when
    ``staggered``) and drive them to the end; returns the outputs."""
    reqs = [eng.submit(prompts[0], sp_cls(max_tokens=max_tokens))]
    if staggered:
        eng.step()  # the first request is mid-flight before the others arrive
    reqs += [eng.submit(p, sp_cls(max_tokens=max_tokens)) for p in prompts[1:]]
    _drive(eng, reqs)
    return [list(r.out) for r in reqs]


def _spec_counts(stats):
    return stats["spec_proposed"], stats["spec_accepted"]


class _OracleDrafter:
    """Test double: proposes each request's dense continuation, always
    confident, so every decode step verifies."""

    def __init__(self, k, truth):
        self.k = k
        self.truth = truth  # prompt tuple -> dense continuation
        self.last_matched = np.zeros(0, bool)

    def propose(self, contexts):
        rows = []
        for ctx in contexts:
            prompt = next(p for p in self.truth if tuple(ctx[: len(p)]) == p)
            done = len(ctx) - len(prompt)
            rows.append((self.truth[prompt][done:] + [0] * self.k)[: self.k])
        self.last_matched = np.ones(len(contexts), bool)
        return np.asarray(rows, np.int32)


# ---------------------------------------------------------------------------
# drafters and the drafting corpus
# ---------------------------------------------------------------------------


def _ngram_contexts():
    rng = np.random.RandomState(3)
    return [
        PERIODIC,
        [1, 2, 1, 2],  # the match is the tail itself
        [4, 8, 15, 16, 23],  # no match: repeat the last token
        [7, 7],  # a single-token repeat loop
        [int(t) for t in rng.randint(0, 6, 40)],  # small alphabet: many matches
        [int(t) for t in rng.randint(0, 128, 30)],  # random: few
        [int(t) for t in rng.randint(0, 128, 1500)],  # longer than the scan window
    ]


@pytest.mark.parametrize("k,max_ngram", [(4, 3), (2, 1), (6, 2)])
def test_ngram_drafter_matches_reference(k, max_ngram):
    contexts = _ngram_contexts()
    port, ref = NGramDrafter(k, max_ngram=max_ngram), RefNGramDrafter(k, max_ngram=max_ngram)
    got, want = port.propose(contexts), ref.propose(contexts)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.last_matched, ref.last_matched)


def test_ngram_drafter_corpus_matches_reference():
    """A context with no confident local match falls back to the shared
    paths (n >= 2 only); the corpus is fetched once, lazily."""
    corpus = [[40, 41, 42, 43, 44, 45], [1, 2, 3, 50, 51, 52, 53, 1, 2]]
    contexts = [[9, 10, 50, 51], [7, 8, 42, 43], [1, 2, 1, 2], [99, 98, 97]]
    port, ref = NGramDrafter(3), RefNGramDrafter(3)
    fetches = []
    port.corpus = lambda: fetches.append(1) or corpus
    ref.corpus = lambda: corpus
    np.testing.assert_array_equal(port.propose(contexts), ref.propose(contexts))
    np.testing.assert_array_equal(port.last_matched, ref.last_matched)
    assert list(port.last_matched) == [True, True, True, False] and fetches == [1]


def test_small_model_drafter_matches_reference(draft_params):
    ref_p, port_p = draft_params
    port = SmallModelDrafter(TINY, port_p, k=2, slots=3, ctx_window=8)
    ref = RefSmallModelDrafter(TINY_REF, ref_p, k=2, slots=3, ctx_window=8)
    for contexts in ([[1, 2, 3]], [list(range(20)), [7] * 4, [1]], [PERIODIC, _prompt(12)]):
        got = port.propose(contexts)
        assert got.shape == (len(contexts), 2) and got.dtype == np.int32
        np.testing.assert_array_equal(got, ref.propose(contexts))
    with pytest.raises(ValueError, match="contexts"):
        port.propose([[1]] * 4)


def test_drafter_factory_and_gpt_draft_config(draft_params):
    """A GPT draft config is taken (its positional table must hold the
    context window and the drafts), a config of neither arch (here the
    reference's own) is refused; the factory keeps the reference's
    messages."""
    gpt_cfg = GPTConfig(vocab_size=96, seq_len=48, d_model=32, n_layers=2, n_heads=2, dtype="float32")
    gpt_params = gpt_init(gpt_cfg, torch.Generator().manual_seed(0), "cpu")
    drafter = make_drafter("model", 2, 3, draft_cfg=gpt_cfg, draft_params=gpt_params, draft_ctx=8)
    assert drafter.propose([[1, 2, 3]]).shape == (1, 2)
    with pytest.raises(ValueError, match="positional table"):
        SmallModelDrafter(gpt_cfg, gpt_params, k=2, slots=3, ctx_window=47)
    gpt = RefGPTConfig(vocab_size=96, seq_len=48, d_model=32, n_layers=2, n_heads=2)
    with pytest.raises(TypeError, match="unsupported draft model config"):
        SmallModelDrafter(gpt, draft_params[1], k=2, slots=3)
    assert isinstance(make_drafter("ngram", 3, 2, ngram_max=2), NGramDrafter)
    assert isinstance(make_drafter("model", 2, 3, draft_cfg=TINY, draft_params=draft_params[1]),
                      SmallModelDrafter)
    with pytest.raises(ValueError, match="needs draft_model_cfg and draft_params"):
        make_drafter("model", 2, 3)
    with pytest.raises(ValueError, match="unknown drafter"):
        make_drafter("oracle", 2, 3)


def test_prefix_cache_paths_match_reference():
    """The same inserts and matches on both sides leave the same
    most-recently-used root-to-leaf paths."""
    def build(cfg_cls, pool_cls, cache_cls, **device):
        pool = pool_cls(cfg_cls(num_blocks=24, block_size=4, max_blocks_per_seq=8),
                        n_layers=1, n_heads=1, head_dim=4, **device)
        return pool, cache_cls(pool)

    sides = [build(CacheConfig, KVBlockPool, PrefixCache, device="cpu"),
             build(RefCacheConfig, RefKVBlockPool, RefPrefixCache)]
    head = _prompt(8, seed=50)
    seqs = [head + _prompt(8, seed=51), head + _prompt(6, seed=52), _prompt(12, seed=53),
            head[:4] + _prompt(9, seed=54)]
    for pool, cache in sides:
        for i, toks in enumerate(seqs):
            blocks = pool.allocate(f"s{i}", len(toks))
            cache.insert(toks, blocks, limit=len(toks))
        cache.match(seqs[2])  # touches the third path: most recent now
    want = sides[1][1].paths()
    assert sides[0][1].paths() == want and len(want) == 4
    assert want[0] == seqs[2][:12]
    assert sides[0][1].paths(max_paths=2) == sides[1][1].paths(max_paths=2)


# ---------------------------------------------------------------------------
# the spec engine against the reference engine and dense decode
# ---------------------------------------------------------------------------


def test_spec_engine_matches_reference_engine(port_params, ref_params, dense):
    """Fresh engines on both sides, the same request sequence: identical
    greedy outputs, equal to dense decode, and equal draft counts."""
    port, ref = _engine(port_params, spec_k=3), _ref_engine(ref_params, spec_k=3)
    mixed = [_prompt(5, seed=2), PERIODIC + _prompt(3, seed=3), _prompt(13, seed=4)]
    for eng, sp in ((port, SamplingParams), (ref, RefSamplingParams)):
        outs = _run_sequence(eng, sp, [PERIODIC], 12)
        outs += _run_sequence(eng, sp, [_prompt(10)], 12)
        outs += _run_sequence(eng, sp, mixed, 10, staggered=True)
        eng.outs = outs
    assert port.outs == ref.outs
    prompts = [PERIODIC, _prompt(10)] + mixed
    assert port.outs == [dense(p, 12 if i < 2 else 10) for i, p in enumerate(prompts)]
    assert _spec_counts(port.stats()) == _spec_counts(ref.stats())
    assert port.stats()["spec_proposed"] > 0 and port.stats()["verify_steps"] > 0
    _audits_clean(port)


def test_preemption_under_pressure_matches_reference(port_params, ref_params, dense):
    """A pool too small for all three completions forces recompute
    preemption mid-speculation on both sides."""
    geometry = dict(num_blocks=13, max_blocks_per_seq=10, spec_k=3)
    port, ref = _engine(port_params, **geometry), _ref_engine(ref_params, **geometry)
    prompts = [_prompt(8, seed=s) for s in (5, 6, 7)]
    outs = _run_sequence(port, SamplingParams, prompts, 16)
    assert outs == _run_sequence(ref, RefSamplingParams, prompts, 16)
    assert outs == [dense(p, 16) for p in prompts]
    ps, rs = port.stats(), ref.stats()
    assert ps["preemptions"] == rs["preemptions"] > 0, "pool was sized to force preemption"
    assert _spec_counts(ps) == _spec_counts(rs)
    _audits_clean(port)


def test_warmup_drives_every_path(spec_engine):
    launches = spec_engine.runner.launches
    assert launches["verify"] >= 1 and launches["decode"] >= 1 and launches["fork"] >= 1
    assert spec_engine.stats()["running"] == 0
    _audits_clean(spec_engine)


def test_stop_token_inside_window(spec_engine, dense):
    """A stop token accepted mid-window ends the stream exactly there."""
    full = dense(PERIODIC, 12)
    stop = full[5]
    req = spec_engine.submit(PERIODIC, SamplingParams(max_tokens=12, stop_token_ids=(stop,)))
    _drive(spec_engine, [req])
    assert req.finish_reason == "stop"
    assert req.out == full[: full.index(stop) + 1]
    _audits_clean(spec_engine)


def test_model_drafter_matches_dense(port_params, draft_params, dense):
    """Small-model drafter: acceptance is whatever it is, output is
    identical — under preemption pressure too."""
    eng = LLMEngine(
        TINY, port_params,
        EngineConfig(max_slots=3, num_blocks=13, block_size=4, max_blocks_per_seq=10,
                     prefill_chunk=8, spec_k=2, spec_drafter="model", spec_draft_ctx=8),
        draft_model_cfg=TINY, draft_params=draft_params[1], device="cpu",
    )
    prompts = [_prompt(8, seed=s) for s in (5, 6, 7)]
    assert _run_sequence(eng, SamplingParams, prompts, 16) == [dense(p, 16) for p in prompts]
    s = eng.stats()
    assert s["preemptions"] > 0 and s["spec_proposed"] > 0
    _audits_clean(eng)


def test_length_cap_inside_window(port_params, dense):
    """A budget smaller than the window still ends exactly at max_tokens,
    and a window running past the table scatters its overflow to the trash
    block: with a confident drafter, the 45-token prompt's first window
    covers positions 45-48 of a 48-position table."""
    eng = _engine(port_params, spec_k=3)
    assert eng.generate(_prompt(10), SamplingParams(max_tokens=2)) == dense(_prompt(10), 2)
    prompt = _prompt(45, seed=80)
    eng._drafter = _OracleDrafter(3, {tuple(prompt): dense(prompt, 3)})
    assert eng.generate(prompt, SamplingParams(max_tokens=3)) == dense(prompt, 3)
    assert eng.runner.launches["verify"] == 1 and eng.stats()["spec_accepted"] == 2
    _audits_clean(eng)


def test_backoff_engages_on_low_acceptance(port_params, dense):
    """Random prompt (hostile): the confidence gate and the acceptance
    backoff keep the engine from speculating every step, and the output
    still matches through the mode switches."""
    eng = _engine(port_params, spec_k=3)
    prompt = _prompt(12, seed=11)
    assert eng.generate(prompt, SamplingParams(max_tokens=16)) == dense(prompt, 16)
    assert eng.stats()["spec_proposed"] < 3 * 16 * eng.cfg.spec_k


def test_no_match_gate_skips_verification(port_params, dense):
    """A context with no n-gram match must not pay a verify step at all
    (unless the generated tokens themselves create a match)."""
    eng = _engine(port_params, spec_k=3)
    prompt = list(range(1, 13))  # strictly increasing: no match
    out = eng.generate(prompt, SamplingParams(max_tokens=4))
    assert out == dense(prompt, 4)
    d = NGramDrafter(k=3)
    d.propose([prompt + out])
    if not d.last_matched[0]:
        assert eng.stats()["spec_proposed"] == 0 and eng.runner.launches["verify"] == 0


def test_sampled_spec_reproduces_per_seed_and_equals_plain(port_params, spec_engine):
    """temperature > 0: the same seed reproduces (even though leftover
    backoff state shifts the window boundaries between runs), another
    seed diverges, and the stream equals the port's plain engine's."""
    p = PERIODIC + _prompt(4, seed=60)
    sp = dict(max_tokens=12, temperature=1.5)
    a = spec_engine.generate(p, SamplingParams(seed=1, **sp))
    b = spec_engine.generate(p, SamplingParams(seed=1, **sp))
    c = spec_engine.generate(p, SamplingParams(seed=2, **sp))
    assert a == b and a != c
    assert a == _engine(port_params).generate(p, SamplingParams(seed=1, **sp))
    _audits_clean(spec_engine)


def test_submit_headroom_covers_a_window_wider_than_a_block(port_params, dense):
    """With spec_k > block_size, admission's headroom is the window: a
    request that fits with one block of headroom but not with k
    provisional positions is refused up front."""
    small = dict(num_blocks=5)  # 4 usable blocks = 16 positions
    plain, spec = _engine(port_params, **small), _engine(port_params, spec_k=6, **small)
    prompt = _prompt(6, seed=70)
    plain.submit(prompt, SamplingParams(max_tokens=6))  # 11 + 4 = 15 positions
    with pytest.raises(ValueError, match="usable blocks"):
        spec.submit(prompt, SamplingParams(max_tokens=6))  # 11 + 6 = 17
    out = spec.generate(PERIODIC[:5], SamplingParams(max_tokens=5))  # 9 + 6 = 15
    assert out == dense(PERIODIC[:5], 5)
    _audits_clean(spec)
