"""The GPT arch in the port's paged serving engine, on the CPU:
ray_tpu_torch vs ray_tpu.

Both sides get the reference's narrow fp32 GPT weights (``gpt_init``,
carried over with ``params_from_jax``): 2 layers, d 64, 4 heads of 16,
vocab 384, a positional table of 40 under a block table of 48 positions.
The runner's prefill, decode and verify logits must be within 1e-4 of the
reference runner's on the same pools; greedy engine output must equal the
reference engine's and its dense ``gpt_decode`` — plain, under preemption,
with a prefix hit and a copy-on-write fork, and speculating with the
n-gram drafter and a GPT draft model. Sampled decoding is checked within
the port and in distribution (its bits cannot match ``jax.random``):
reproducible per key, inside the top-k/top-p support, greedy at
temperature <= 0.
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
from ray_tpu.llm.drafter import SmallModelDrafter as RefSmallModelDrafter
from ray_tpu.llm.model_runner import PagedModelRunner as RefRunner
from ray_tpu.models import sampling as ref_sampling
from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.models.gpt import gpt_decode as ref_gpt_decode
from ray_tpu.models.gpt import gpt_init as ref_gpt_init
from ray_tpu.models.gptj import GPTJConfig as RefGPTJConfig
from ray_tpu.models.gptj import gptj_init as ref_gptj_init
from ray_tpu_torch.llm import CacheConfig, EngineConfig, KVBlockPool, LLMEngine, SamplingParams
from ray_tpu_torch.llm import SmallModelDrafter
from ray_tpu_torch.llm.model_runner import PagedModelRunner
from ray_tpu_torch.models import sampling
from ray_tpu_torch.models.gpt import GPTConfig, gpt_decode, gpt_forward, params_from_jax
from ray_tpu_torch.models.gptj import GPTJConfig, gptj_decode, gptj_forward
from ray_tpu_torch.models.gptj import params_from_jax as gptj_params_from_jax

NARROW = dict(vocab_size=384, seq_len=40, d_model=64, n_layers=2, n_heads=4, dtype="float32")
REF_CFG = RefGPTConfig(**NARROW, remat=False, attn_impl="xla", fused_loss=False)
CFG = GPTConfig(**NARROW)
# a different, smaller random GPT drafts (the reference's draft models are GPTs)
DRAFT_NARROW = dict(NARROW, n_layers=1, d_model=32, n_heads=2)
REF_DRAFT_CFG = RefGPTConfig(**DRAFT_NARROW, remat=False, attn_impl="xla", fused_loss=False)
DRAFT_CFG = GPTConfig(**DRAFT_NARROW)
# the block table reaches 48 positions, past the positional table's 40
GEOMETRY = dict(max_slots=3, num_blocks=32, block_size=4, max_blocks_per_seq=12, prefill_chunk=8)
BS = GEOMETRY["block_size"]


@pytest.fixture(scope="module")
def ref_params():
    return ref_gpt_init(jax.random.PRNGKey(0), REF_CFG)


@pytest.fixture(scope="module")
def port_params(ref_params):
    return params_from_jax(jax.device_get(ref_params), CFG, "cpu")


@pytest.fixture(scope="module")
def draft_params():
    ref = ref_gpt_init(jax.random.PRNGKey(42), REF_DRAFT_CFG)
    return ref, params_from_jax(jax.device_get(ref), DRAFT_CFG, "cpu")


@pytest.fixture(scope="module")
def ref_engine(ref_params):
    return RefEngine(REF_CFG, ref_params, RefEngineConfig(**GEOMETRY))


@pytest.fixture(scope="module")
def engine(port_params):
    """One port engine shared by the tests of the default geometry; each
    leaves it drained."""
    return _engine(port_params)


@pytest.fixture(scope="module")
def dense(ref_params):
    @functools.lru_cache(maxsize=None)
    def decode(prompt: tuple, n_new: int) -> list:
        out = ref_gpt_decode(REF_CFG, ref_params, jnp.asarray([prompt], jnp.int32), n_new)
        return [int(t) for t in np.asarray(out)[0, len(prompt):]]

    return lambda prompt, n_new: decode(tuple(int(t) for t in prompt), n_new)


def _engine(params, **kw):
    return LLMEngine(CFG, params, EngineConfig(**{**GEOMETRY, **kw}), device="cpu")


def _prompt(n, seed=1):
    return [int(t) for t in np.random.RandomState(seed).randint(0, CFG.vocab_size, n)]


def _drive(eng, reqs, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not all(r.finished for r in reqs):
        eng.step()
        assert time.monotonic() < deadline, "engine did not finish in time"


def _run(eng, sp_cls, prompts, max_tokens):
    reqs = [eng.submit(p, sp_cls(max_tokens=max_tokens)) for p in prompts]
    _drive(eng, reqs)
    return [list(r.out) for r in reqs]


def _audits_clean(eng):
    assert eng.pool.audit()["ok"]
    assert eng.prefix_cache.audit()["ok"]


# ---------------------------------------------------------------------------
# the runner against the reference runner, step by step on the same pools
# ---------------------------------------------------------------------------


def _captured(fn, store):
    def wrapped(*args):
        out = fn(*args)
        store.append(np.asarray(out))
        return out

    return wrapped


def _captured_in_jit(fn, store):
    """``fn``'s output handed to the host from inside the reference's jitted
    steps, as each step runs."""
    def wrapped(*args):
        out = fn(*args)
        jax.debug.callback(lambda a: store.append(np.asarray(a)), out)
        return out

    return wrapped


def test_runner_logits_match_reference_runner(ref_params, port_params):
    """Prefill chunks of 7 tokens for two sequences (the second one's last
    chunk has padded positions past the positional table, clamped at the
    embedding), a decode step over them plus an inactive slot, then a
    verify window (the second slot's last position past the table): every
    step's fp32 logits within 1e-4 of the reference runner's (its lm-head
    output read from inside its jitted steps); the pools agree after each
    step."""
    cache = dict(num_blocks=24, block_size=BS, max_blocks_per_seq=12)
    geo = dict(n_layers=CFG.n_layers, n_heads=CFG.n_heads, head_dim=CFG.head_dim)
    ref_pool = RefKVBlockPool(RefCacheConfig(**cache), **geo, dtype="float32")
    pool = KVBlockPool(CacheConfig(**cache), **geo, dtype=torch.float32, device="cpu")
    ref_runner = RefRunner(REF_CFG, ref_params, BS, attn_impl="xla")
    runner = PagedModelRunner(CFG, port_params, BS)
    ref_logits, logits = [], []
    ref_runner._lm_head = _captured_in_jit(ref_runner._lm_head, ref_logits)
    runner._logits = _captured(runner._logits, logits)
    lens = (13, 36)
    for sid, n in zip(("s0", "s1"), lens):
        ref_pool.allocate(sid, 44)
        pool.allocate(sid, 44)
    rng = np.random.RandomState(3)

    def both(ref_call, call):
        ref_out = jax.block_until_ready(ref_call())
        jax.effects_barrier()
        ref_pool.k, ref_pool.v = ref_out[0], ref_out[1]
        out = call()
        assert ref_logits[-1].size == logits[-1].size
        np.testing.assert_allclose(logits[-1], ref_logits[-1].reshape(logits[-1].shape), atol=1e-4, rtol=0)
        np.testing.assert_allclose(pool.k.numpy(), np.asarray(ref_pool.k), atol=1e-5, rtol=0)
        np.testing.assert_allclose(pool.v.numpy(), np.asarray(ref_pool.v), atol=1e-5, rtol=0)
        return ref_out[2:], out

    prompts = {sid: rng.randint(0, CFG.vocab_size, n).astype(np.int32) for sid, n in zip(("s0", "s1"), lens)}
    for sid, prompt in prompts.items():
        table = ref_pool.table_row(sid)
        assert np.array_equal(table, pool.table_row(sid))
        for start in range(0, len(prompt), 7):
            piece = prompt[start : start + 7]
            toks = np.zeros(7, np.int32)
            toks[: len(piece)] = piece
            (ref_last,), last = both(
                lambda: ref_runner.prefill_chunk(ref_pool.k, ref_pool.v, toks, start, len(piece), table),
                lambda: runner.prefill_chunk(pool.k, pool.v, toks, start, len(piece), table),
            )
            np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), atol=1e-4, rtol=0)

    S = 3
    tables = np.zeros((S, 12), np.int32)
    tables[0], tables[1] = pool.table_row("s0"), pool.table_row("s1")
    greedy = (np.zeros(S, np.float32), np.zeros(S, np.int32), np.ones(S, np.float32))
    keys = (np.zeros(S, np.uint32), np.zeros(S, np.int32))
    tokens = np.array([prompts["s0"][-1], prompts["s1"][-1], 0], np.int32)
    positions = np.array([lens[0], lens[1], 0], np.int32)
    (ref_tok, ref_lp), (tok, lp) = both(
        lambda: ref_runner.decode_step(ref_pool.k, ref_pool.v, tokens, positions, tables, *greedy, *keys),
        lambda: runner.decode_step(pool.k, pool.v, tokens, positions, tables, *greedy, *keys),
    )
    assert tok.tolist()[:2] == np.asarray(ref_tok).tolist()[:2]
    np.testing.assert_allclose(lp.numpy()[:2], np.asarray(ref_lp)[:2], atol=1e-4)

    window = np.stack([rng.randint(0, CFG.vocab_size, 4) for _ in range(S)]).astype(np.int32)
    base = np.array([lens[0] + 1, lens[1] + 1, 0], np.int32)  # s1's window runs past seq_len
    (ref_acc, ref_out, ref_olp), (acc, out, olp) = both(
        lambda: ref_runner.verify_step(ref_pool.k, ref_pool.v, window, base, tables, *greedy, *keys),
        lambda: runner.verify_step(pool.k, pool.v, window, base, tables, *greedy, *keys),
    )
    assert acc.tolist()[:2] == np.asarray(ref_acc).tolist()[:2]
    assert out.numpy()[:2].tolist() == np.asarray(ref_out)[:2].tolist()
    np.testing.assert_allclose(olp.numpy()[:2], np.asarray(ref_olp)[:2], atol=1e-4)
    assert len(logits) == len(ref_logits) == 2 + 6 + 1 + 1


def test_runner_hands_the_kernels_contiguous_queries(port_params, monkeypatch):
    """On the card the decode and verify kernels refuse a strided q; the
    fused qkv projection's split gives strided views, so the runner must
    hand its queries over contiguous (the plain versions here would take
    either)."""
    from ray_tpu_torch.llm import model_runner

    seen = []
    for name in ("paged_attention", "paged_verify_attention"):
        fn = getattr(model_runner, name)
        monkeypatch.setattr(model_runner, name,
                            lambda q, *a, fn=fn, name=name: seen.append((name, q.is_contiguous())) or fn(q, *a))
    eng = LLMEngine(CFG, port_params, EngineConfig(**GEOMETRY, spec_k=2), device="cpu")
    eng.warmup()
    assert {n for n, _ in seen} == {"paged_attention", "paged_verify_attention"}
    assert all(ok for _, ok in seen), seen


def test_runner_refuses_moe_and_foreign_configs(port_params):
    with pytest.raises(NotImplementedError, match="dense GPT only"):
        PagedModelRunner(GPTConfig(**NARROW, n_experts=4), port_params, BS)
    with pytest.raises(TypeError, match="unsupported model config"):
        PagedModelRunner(REF_CFG, port_params, BS)


# ---------------------------------------------------------------------------
# the engine against the reference engine and the dense decoder
# ---------------------------------------------------------------------------


def test_greedy_matches_reference_engine_and_decode(engine, ref_engine, dense):
    prompts = [_prompt(10), _prompt(5, seed=2), _prompt(14, seed=3)]
    got = _run(engine, SamplingParams, prompts, 9)
    assert got == _run(ref_engine, RefSamplingParams, prompts, 9)
    assert got == [dense(p, 9) for p in prompts]
    _audits_clean(engine)


def test_preemption_under_pressure_matches_reference(port_params, ref_params, dense):
    """A pool too small for all three completions forces recompute
    preemption on both sides."""
    geo = dict(num_blocks=13, max_blocks_per_seq=10)
    small = _engine(port_params, **geo)
    ref_small = RefEngine(REF_CFG, ref_params, RefEngineConfig(**{**GEOMETRY, **geo}))
    prompts = [_prompt(8, seed=s) for s in (5, 6, 7)]
    got = _run(small, SamplingParams, prompts, 16)
    assert small.stats()["preemptions"] > 0, "pool was sized to force preemption"
    assert got == _run(ref_small, RefSamplingParams, prompts, 16) == [dense(p, 16) for p in prompts]
    _audits_clean(small)


def test_prefix_cache_warm_hit_and_cow_fork(engine, ref_engine, dense):
    base = _prompt(10, seed=20)
    cold = engine.generate(base, SamplingParams(max_tokens=6))
    s0 = engine.stats()["prefix_cache"]
    warm = engine.generate(base, SamplingParams(max_tokens=6))
    s1 = engine.stats()["prefix_cache"]
    assert cold == warm == dense(base, 6)
    assert s1["hit_tokens"] > s0["hit_tokens"]
    # diverges inside the second block (block_size 4): a copy-on-write fork
    fork = base[:6] + _prompt(4, seed=21)
    out = engine.generate(fork, SamplingParams(max_tokens=6))
    assert engine.stats()["prefix_cache"]["cow_forks"] == s1["cow_forks"] + 1
    assert out == _run(ref_engine, RefSamplingParams, [fork], 6)[0] == dense(fork, 6)
    _audits_clean(engine)


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_engine_matches_reference(port_params, ref_params, draft_params, dense, drafter):
    """spec_k 4 with the n-gram drafter or the GPT draft model: greedy
    output equal to the reference's speculating engine and the dense
    decoder, with the same proposed and accepted counts."""
    kw = dict(spec_k=4, spec_drafter=drafter, spec_draft_ctx=8)
    drafts = dict(draft_model_cfg=DRAFT_CFG, draft_params=draft_params[1]) if drafter == "model" else {}
    ref_drafts = dict(draft_model_cfg=REF_DRAFT_CFG, draft_params=draft_params[0]) if drafter == "model" else {}
    eng = LLMEngine(CFG, port_params, EngineConfig(**GEOMETRY, **kw), device="cpu", **drafts)
    ref = RefEngine(REF_CFG, ref_params, RefEngineConfig(**GEOMETRY, **kw), **ref_drafts)
    periodic = [5, 9, 7, 5, 9, 7, 5, 9, 7, 5]
    prompts = [periodic, _prompt(9, seed=30), _prompt(6, seed=31)]
    got = _run(eng, SamplingParams, prompts, 14)
    assert got == _run(ref, RefSamplingParams, prompts, 14) == [dense(p, 14) for p in prompts]
    st, ref_st = eng.stats(), ref.stats()
    assert st["verify_steps"] > 0
    assert (st["spec_proposed"], st["spec_accepted"]) == (ref_st["spec_proposed"], ref_st["spec_accepted"])
    _audits_clean(eng)


def test_model_length_cap_is_the_positional_table(engine, ref_engine, dense):
    """GPT caps a sequence at min(table, seq_len) = 40 of the table's 48:
    both engines refuse a longer request the same way, and one that fills
    the table to seq_len equals the dense decoder, which refuses past it."""
    assert engine.max_model_len == ref_engine.max_model_len == CFG.seq_len < 12 * BS
    for eng in (engine, ref_engine):
        with pytest.raises(ValueError, match="max model length 40"):
            eng.submit(_prompt(30), (SamplingParams if eng is engine else RefSamplingParams)(max_tokens=11))
    prompt = _prompt(30, seed=40)
    out = engine.generate(prompt, SamplingParams(max_tokens=10))
    assert out == dense(prompt, 10)
    with pytest.raises(ValueError, match="positional table"):
        gpt_decode(CFG, engine.runner.params, torch.tensor([prompt]), 11)
    _audits_clean(engine)


# ---------------------------------------------------------------------------
# the dense decoders and sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,b,prompt_len,n_new", [(0, 1, 5, 12), (1, 3, 11, 8), (2, 2, 1, 20)])
def test_gpt_decode_greedy_matches_reference(ref_params, port_params, seed, b, prompt_len, n_new):
    prompt = np.random.RandomState(seed).randint(0, CFG.vocab_size, (b, prompt_len))
    want = np.asarray(ref_gpt_decode(REF_CFG, ref_params, jnp.asarray(prompt, jnp.int32), n_new))
    got = gpt_decode(CFG, port_params, torch.from_numpy(prompt), n_new)
    assert got.numpy().tolist() == want.tolist()


def test_gpt_decode_refuses_moe_and_past_seq_len(port_params):
    with pytest.raises(NotImplementedError, match="dense"):
        gpt_decode(GPTConfig(**NARROW, n_experts=2), port_params, torch.zeros(1, 4, dtype=torch.long), 2)
    with pytest.raises(ValueError, match="positional table"):
        gpt_decode(CFG, port_params, torch.zeros(1, 35, dtype=torch.long), 6)


@pytest.fixture(scope="module")
def gptj_pair():
    tiny = dict(vocab_size=128, seq_len=64, d_model=32, n_layers=2, n_heads=2, rotary_dim=8, dtype="float32")
    ref = ref_gptj_init(jax.random.PRNGKey(0), RefGPTJConfig(**tiny, remat=False, attn_impl="xla",
                                                             fused_loss=False))
    cfg = GPTJConfig(**tiny)
    return cfg, gptj_params_from_jax(jax.device_get(ref), cfg, "cpu")


def _decoders(port_params, gptj_pair):
    cfg, params = gptj_pair
    return {"gpt": (functools.partial(gpt_decode, CFG, port_params), CFG.vocab_size),
            "gptj": (functools.partial(gptj_decode, cfg, params), cfg.vocab_size)}


@pytest.mark.parametrize("arch", ["gpt", "gptj"])
def test_sampled_decode_reproduces_per_key_and_is_greedy_at_zero(port_params, gptj_pair, arch):
    decode, v = _decoders(port_params, gptj_pair)[arch]
    prompt = torch.from_numpy(np.random.RandomState(5).randint(0, v, (3, 6)))
    greedy = decode(prompt, 10)
    temps = torch.tensor([0.9, 0.0, 1.3])  # per-row knobs; row 1 greedy
    a = decode(prompt, 10, key=7, temperature=temps, top_k=torch.tensor([0, 5, 20]), top_p=0.95)
    b = decode(prompt, 10, key=7, temperature=temps, top_k=torch.tensor([0, 5, 20]), top_p=0.95)
    assert torch.equal(a, b)
    assert torch.equal(a[1], greedy[1])
    assert torch.equal(decode(prompt, 10, key=7, temperature=0.0), greedy)
    assert torch.equal(decode(prompt, 10, key=7, temperature=-1.0), greedy)
    other = decode(prompt, 10, key=8, temperature=temps)
    assert not torch.equal(other[[0, 2]], a[[0, 2]])


@pytest.mark.parametrize("arch", ["gpt", "gptj"])
@pytest.mark.parametrize("knobs", [dict(top_k=3), dict(top_p=0.3)])
def test_sampled_decode_stays_in_the_topk_topp_support(port_params, gptj_pair, arch, knobs):
    """Top-k 3 or top-p 0.3 at temperature 1.5: every sampled token lies in
    the support the dense forward's logits give at the position it was
    sampled after (the nucleus taken 1e-4 wider, for the two paths' fp32
    rounding)."""
    decode, v = _decoders(port_params, gptj_pair)[arch]
    prompt = torch.from_numpy(np.random.RandomState(6).randint(0, v, (2, 5)))
    out = decode(prompt, 8, key=11, temperature=1.5, **knobs)
    with torch.no_grad():
        if arch == "gpt":
            logits = gpt_forward(CFG, port_params, out[:, :-1])
        else:
            logits = gptj_forward(*gptj_pair, out[:, :-1])
    logits = logits[:, 4:]  # (2, 8, vocab): position 4 + j predicts token 5 + j
    if "top_k" in knobs:
        support = torch.zeros_like(logits, dtype=torch.bool).scatter(-1, logits.topk(3, dim=-1).indices, True)
    else:
        probs, order = torch.softmax(logits / 1.5, dim=-1).sort(dim=-1, descending=True)
        keep = (probs.cumsum(-1) - probs) < knobs["top_p"] + 1e-4
        support = torch.zeros_like(keep).scatter(-1, order, keep)
    assert support.gather(-1, out[:, 5:, None]).all()


def test_sample_tokens_matches_reference_in_distribution():
    """N rows of the same logits drawn in one call (row i from
    row_generator(key, i)): each token's frequency within 5 binomial
    standard deviations (+1e-3) of the reference's filtered softmax, masked
    tokens never; the call reproduces per key; greedy rows are argmax."""
    v, n = 12, 6000
    logits = np.random.RandomState(9).randn(1, v).astype(np.float32)
    masked = ref_sampling._filtered_logits(jnp.asarray(logits), jnp.float32([0.8]), jnp.int32([6]),
                                           jnp.float32([0.95]))
    p = np.asarray(jax.nn.softmax(masked, axis=-1))[0]
    rows = torch.from_numpy(np.repeat(logits, n, 0))
    tok = sampling.sample_tokens(rows, 123, 0.8, 6, 0.95)
    assert tok.shape == (n,) and torch.equal(tok, sampling.sample_tokens(rows, 123, 0.8, 6, 0.95))
    freq = np.bincount(tok.numpy(), minlength=v) / n
    bound = 5 * np.sqrt(p * (1 - p) / n) + 1e-3
    assert np.all(np.abs(freq - p) <= bound), (freq, p)
    assert np.all(freq[p == 0] == 0)
    mixed = sampling.sample_tokens(rows[:4], 5, torch.tensor([0.0, 1.0, -0.5, 1.0]))
    assert mixed[0] == mixed[2] == int(np.argmax(logits))
    ref_greedy = ref_sampling.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0), 0.0)
    assert int(mixed[0]) == int(ref_greedy[0])


def test_gpt_small_model_drafter_matches_reference(draft_params):
    ref_p, port_p = draft_params
    port = SmallModelDrafter(DRAFT_CFG, port_p, k=3, slots=3, ctx_window=8)
    ref = RefSmallModelDrafter(REF_DRAFT_CFG, ref_p, k=3, slots=3, ctx_window=8)
    for contexts in ([[1, 2, 3]], [list(range(20)), [7] * 4, [1]], [_prompt(12)]):
        got = port.propose(contexts)
        assert got.shape == (len(contexts), 3) and got.dtype == np.int32
        np.testing.assert_array_equal(got, ref.propose(contexts))
    with pytest.raises(ValueError, match="positional table"):
        SmallModelDrafter(DRAFT_CFG, port_p, k=5, slots=3, ctx_window=36)
    with pytest.raises(TypeError, match="unsupported draft model config"):
        SmallModelDrafter(REF_DRAFT_CFG, port_p, k=3, slots=3)
