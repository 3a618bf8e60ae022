"""The port's serving slice as a whole, on the CPU: ray_tpu_torch.llm vs
ray_tpu.llm.

Both engines get the reference's TINY GPT-J weights (carried over with
``params_from_jax``) and the same requests; greedy outputs must be
identical between the engines and equal to the reference's dense
``gptj_decode``, through concurrent admission, preemption under a small
pool, prefix-cache hits and copy-on-write forks, stop tokens,
cancellation, deadlines and resumed streams. Seeded sampling is checked
within the port (its bits cannot match ``jax.random``): a request's tokens
depend only on (seed, output index), so preemption and resumption leave
them unchanged.
"""

import functools
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ray_tpu.llm import EngineConfig as RefEngineConfig
from ray_tpu.llm import LLMEngine as RefEngine
from ray_tpu.llm import SamplingParams as RefSamplingParams
from ray_tpu.models.gptj import GPTJConfig as RefGPTJConfig
from ray_tpu.models.gptj import gptj_decode as ref_gptj_decode
from ray_tpu.models.gptj import gptj_init as ref_gptj_init
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
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


@pytest.fixture(scope="module")
def ref_params():
    return ref_gptj_init(jax.random.PRNGKey(0), TINY_REF)


@pytest.fixture(scope="module")
def port_params(ref_params):
    return params_from_jax(jax.device_get(ref_params), TINY, "cpu")


@pytest.fixture(scope="module")
def ref_engine(ref_params):
    return RefEngine(TINY_REF, ref_params, RefEngineConfig(**GEOMETRY))


@pytest.fixture(scope="module")
def engine(port_params):
    """One port engine shared by the tests that use the default geometry;
    each leaves it drained."""
    return _engine(port_params)


@pytest.fixture(scope="module")
def dense(ref_params):
    @functools.lru_cache(maxsize=None)
    def decode(prompt: tuple, n_new: int) -> list:
        out = ref_gptj_decode(TINY_REF, ref_params, jnp.asarray([prompt], jnp.int32), n_new)
        return [int(t) for t in np.asarray(out)[0, len(prompt):]]

    return lambda prompt, n_new: decode(tuple(int(t) for t in prompt), n_new)


def _engine(params, **kw):
    return LLMEngine(TINY, params, EngineConfig(**{**GEOMETRY, **kw}), device="cpu")


def _prompt(n, seed=1):
    return [int(t) for t in np.random.RandomState(seed).randint(0, TINY.vocab_size, n)]


def _drive(eng, reqs, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not all(r.finished for r in reqs):
        eng.step()
        assert time.monotonic() < deadline, "engine did not finish in time"


def _ref_outputs(ref_engine, prompts, max_tokens):
    reqs = [ref_engine.submit(p, RefSamplingParams(max_tokens=max_tokens)) for p in prompts]
    _drive(ref_engine, reqs)
    return [list(r.out) for r in reqs]


def _audits_clean(eng):
    assert eng.pool.audit()["ok"]
    assert eng.prefix_cache.audit()["ok"]


def test_greedy_matches_reference_engine_and_decode(engine, ref_engine, dense):
    prompt = _prompt(10)
    out = engine.generate(prompt, SamplingParams(max_tokens=8))
    assert out == _ref_outputs(ref_engine, [prompt], 8)[0] == dense(prompt, 8)
    _audits_clean(engine)


def test_concurrent_admission_matches_reference(engine, ref_engine, dense):
    prompts = [_prompt(5, seed=2), _prompt(9, seed=3), _prompt(13, seed=4)]
    reqs = [engine.submit(p, SamplingParams(max_tokens=10)) for p in prompts]
    _drive(engine, reqs)
    want = _ref_outputs(ref_engine, prompts, 10)
    for req, p, w in zip(reqs, prompts, want):
        assert req.finish_reason == "length"
        assert req.out == w == dense(p, 10)
    s = engine.stats()
    assert s["running"] == 0 and s["kv_utilization"] == 0.0
    _audits_clean(engine)


def test_preemption_under_pressure_matches_reference(port_params, engine, ref_engine, dense):
    """A pool too small for all three completions forces recompute
    preemption; greedy outputs still match, and a seeded-sampled request
    draws the same tokens preempted or not."""
    small = _engine(port_params, num_blocks=13, max_blocks_per_seq=10)
    prompts = [_prompt(8, seed=s) for s in (5, 6, 7)]
    sampled = SamplingParams(max_tokens=16, temperature=1.2, top_k=20, seed=99)
    params = [SamplingParams(max_tokens=16), SamplingParams(max_tokens=16), sampled]
    reqs = [small.submit(p, sp) for p, sp in zip(prompts, params)]
    _drive(small, reqs)
    assert small.stats()["preemptions"] > 0, "pool was sized to force preemption"
    want = _ref_outputs(ref_engine, prompts[:2], 16)
    for req, p, w in zip(reqs, prompts, want):
        assert req.out == w == dense(p, 16)
    assert reqs[2].out == engine.generate(prompts[2], sampled)
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
    assert out == _ref_outputs(ref_engine, [fork], 6)[0] == dense(fork, 6)
    _audits_clean(engine)


def test_stop_tokens(engine, dense):
    prompt = _prompt(10)
    full = dense(prompt, 8)
    stop = full[3]
    req = engine.submit(prompt, SamplingParams(max_tokens=8, stop_token_ids=(stop,)))
    _drive(engine, [req])
    assert req.finish_reason == "stop"
    assert req.out == full[: full.index(stop) + 1]  # stop token included
    _audits_clean(engine)


def test_cancellation_and_deadline(engine):
    req = engine.submit(_prompt(8), SamplingParams(max_tokens=30))
    for _ in range(6):
        engine.step()
    assert not req.finished and len(req.out) >= 1
    assert engine.cancel(req.id)
    engine.step()
    assert req.finished and req.finish_reason == "cancelled"
    assert list(engine.stream_tokens(req, timeout=5.0)) == req.out
    assert engine.cancel("req-unknown") is False
    late = engine.submit(_prompt(8), SamplingParams(max_tokens=30), deadline_s=0.0)
    engine.step()
    assert late.finished and late.finish_reason == "deadline"
    s = engine.stats()
    assert s["running"] == 0 and s["kv_utilization"] == 0.0
    _audits_clean(engine)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_resume_tokens_continue_identically(engine, temperature):
    """A stream resumed with the tokens an earlier engine delivered streams
    only the rest, and the whole output equals the uninterrupted run."""
    prompt = _prompt(9, seed=30)
    sp = SamplingParams(max_tokens=12, temperature=temperature, seed=7)
    full = engine.generate(prompt, sp)
    req = engine.submit(prompt, sp, resume_tokens=tuple(full[:5]))
    _drive(engine, [req])
    assert list(engine.stream_tokens(req, timeout=5.0)) == full[5:]
    assert req.out == full and req.resumed_from == 5
    # a resume that already ended (its stop token was delivered) finishes at once
    stop = SamplingParams(max_tokens=12, stop_token_ids=(full[4],), temperature=temperature, seed=7)
    done = engine.submit(prompt, stop, resume_tokens=tuple(full[:5]))
    assert done.finished and done.finish_reason == "stop"
    _audits_clean(engine)


def test_submit_validation(port_params, engine):
    with pytest.raises(ValueError, match="max model length"):
        engine.submit(_prompt(40), SamplingParams(max_tokens=40))
    with pytest.raises(ValueError, match="max_tokens"):
        engine.submit(_prompt(4), SamplingParams(max_tokens=0))
    with pytest.raises(ValueError, match="prompt"):
        engine.submit([], SamplingParams(max_tokens=4))
    with pytest.raises(ValueError, match="resume_tokens"):
        engine.submit(_prompt(4), SamplingParams(max_tokens=2), resume_tokens=(1, 2, 3))
    with pytest.raises(ValueError, match="finite"):
        engine.submit(_prompt(4), SamplingParams(max_tokens=2), deadline_s=float("nan"))
    tiny_pool = _engine(port_params, num_blocks=5)  # 4 usable blocks
    with pytest.raises(ValueError, match="usable blocks"):
        tiny_pool.submit(_prompt(20), SamplingParams(max_tokens=10))
    spec = _engine(port_params, spec_k=2)  # speculative decoding is ported
    assert spec.stats()["spec_proposed"] == 0 and spec._drafter.k == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(port_params, tp=2)
    assert engine.stats()["waiting"] == 0


def test_run_loop_serves_threads(engine, dense):
    """run_loop in a thread, requests submitted and streamed from others."""
    prompts = [_prompt(6, seed=40 + i) for i in range(4)]
    results = {}

    def client(i):
        req = engine.submit(prompts[i], SamplingParams(max_tokens=7))
        results[i] = list(engine.stream_tokens(req, timeout=60.0))

    stop = threading.Event()
    loop = threading.Thread(target=engine.run_loop, args=(stop,), daemon=True)
    loop.start()
    try:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in clients)
    finally:
        stop.set()
        loop.join(timeout=10)
    assert not loop.is_alive()
    for i, p in enumerate(prompts):
        assert results[i] == dense(p, 7)
    _audits_clean(engine)
