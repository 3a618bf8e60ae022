"""The tensor-parallel engine (``ray_tpu_torch.llm.multichip``) held against
the reference's (``ray_tpu.llm.multichip``) and against its own tp 1, on
the CPU: followers are gloo processes.

The reference's matrix (``tests/test_llm_multichip.py``) at tp in {2, 4},
on its ``TINY`` GPT-J (4 heads of 16, d_ff 256), whose weights reach the
port through ``params_from_jax``: greedy and seeded identity, speculative
decoding, the prefix cache off and warm, preemption-recompute, failover
``resume_tokens``, the pool's audit and the watchdog, the per-device HBM
ledger and the gauges' device tag, the sharded hot swap and the
divisibility checks. An ``EngineConfig(tp=N)`` port engine must emit
exactly its tp 1 tokens (the plain single-card engine's), with logprobs
within ``LOGPROB_TOL``; its greedy tokens must also be the reference
engine's at the same tp. Seeded tokens are held within the port only: its
Gumbel noise comes from ``torch.Generator``, not ``jax.random``. A GPT of
the same width (its fused qkv reordered per rank, two reductions a layer,
biases drawn nonzero) is held the same way at tp 2 and 4.

Port-only cases: the tp runner at tp 1 is the single-card arithmetic bit
for bit; a killed leader leaves no follower; a killed follower makes the
next step raise at once; a caller's default process group is untouched;
tp on the card with too few cards raises; and ``build_llm_app(tp=2)``'s
replica serves the tokens of the tp 1 engine.

The port has no switch for its prefix cache (it is always on): "off" here
is an engine whose cache is flushed before every step, so no request
seeds from it.
"""

import functools
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

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
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.models.gpt import params_from_jax as gpt_params_from_jax
from ray_tpu_torch.models.gptj import GPTJConfig, gptj_init, params_from_jax

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(
    len(jax.devices("cpu")) < 4,
    reason="the reference's engine needs a >=4-device CPU mesh "
    "(XLA_FLAGS=--xla_force_host_platform_device_count, set by conftest)",
)

# the reference's tp=4-divisible geometry: 4 heads x head_dim 16, d_ff 256
SHAPE = dict(vocab_size=128, seq_len=64, d_model=64, n_layers=2, n_heads=4, rotary_dim=8, dtype="float32")
TINY_REF = RefGPTJConfig(**SHAPE, remat=False, attn_impl="xla", fused_loss=False)
TINY = GPTJConfig(**SHAPE)
GEOMETRY = dict(max_slots=3, num_blocks=32, block_size=4, max_blocks_per_seq=12, prefill_chunk=8)
PROMPT = [1, 2, 3, 4, 5]
#: the standard request set: (prompt, sampling), the first greedy
REQUESTS = (
    (PROMPT, dict(max_tokens=8, temperature=0.0)),
    ([7, 8, 9], dict(max_tokens=8, temperature=0.8, seed=42)),
    (list(range(1, 13)), dict(max_tokens=6, temperature=0.6, seed=7, top_k=20)),
)
#: fp32: the two row-parallel reductions sum in another order (~1 ulp a layer)
LOGPROB_TOL = 1e-5
#: the GPT at the same tp-4-divisible width (d_ff 4 x 64): its fused qkv is
#: reordered per rank and each layer has two reductions
GPT_SHAPE = dict(vocab_size=128, seq_len=64, d_model=64, n_layers=2, n_heads=4, dtype="float32")
_ENGINES: list = []  # the cached engines, stopped when the module ends


@functools.lru_cache(maxsize=None)
def _ref_params(seed: int = 0):
    return ref_gptj_init(jax.random.PRNGKey(seed), TINY_REF)


@functools.lru_cache(maxsize=None)
def _params(seed: int = 0):
    return params_from_jax(jax.device_get(_ref_params(seed)), TINY, "cpu")


def _engine(tp=1, params=None, **kw):
    return LLMEngine(TINY, params or _params(), EngineConfig(tp=tp, **{**GEOMETRY, **kw}), device="cpu")


def _drive(eng, reqs, max_steps=500, before_step=lambda: None):
    for _ in range(max_steps):
        if all(r.finished for r in reqs):
            return [list(r.out) for r in reqs]
        before_step()
        eng.step()
    raise AssertionError("engine did not finish")


@functools.lru_cache(maxsize=None)
def _matrix(tp: int, spec_k: int, prefix_cache: bool):
    """The standard request set on a fresh port engine: (tokens, logprobs,
    engine). The engine stays alive for the audit and ledger tests."""
    eng = _engine(tp=tp, spec_k=spec_k)
    _ENGINES.append(eng)
    reqs = [eng.submit(list(p), SamplingParams(**sp)) for p, sp in REQUESTS]
    flush = (lambda: None) if prefix_cache else eng.prefix_cache.flush
    out = _drive(eng, reqs, before_step=flush)
    if not prefix_cache:
        assert eng.prefix_cache.stats()["hit_tokens"] == 0
    return tuple(map(tuple, out)), [list(r.out_logprobs) for r in reqs], eng


@functools.lru_cache(maxsize=None)
def _ref_matrix(tp: int, spec_k: int, prefix_cache: bool):
    """The reference engine's tokens for the standard request set at the
    same tp (greedy comparable; its seeded tokens come from jax.random)."""
    eng = RefEngine(TINY_REF, _ref_params(),
                    RefEngineConfig(tp=tp, spec_k=spec_k, prefix_cache=prefix_cache, **GEOMETRY))
    reqs = [eng.submit(list(p), RefSamplingParams(**sp)) for p, sp in REQUESTS]
    return tuple(map(tuple, _drive(eng, reqs)))


def _same_as_tp1(tp, spec_k=0, prefix_cache=True):
    ref, ref_lp, _ = _matrix(1, spec_k, prefix_cache)
    got, got_lp, eng = _matrix(tp, spec_k, prefix_cache)
    assert got == ref
    gap = max(abs(a - b) for x, y in zip(got_lp, ref_lp) for a, b in zip(x, y))
    assert gap <= LOGPROB_TOL, gap
    # the greedy request against the reference engine at the same tp
    assert got[0] == _ref_matrix(tp, spec_k, prefix_cache)[0]
    return eng


@pytest.fixture(scope="module", autouse=True)
def _stop_engines():
    """Stop the cached engines' followers when the module ends."""
    yield
    for eng in _ENGINES:
        eng.shutdown()
    _matrix.cache_clear()


# --------------------------------------------------------------- identity


@pytest.mark.parametrize("tp", [2, 4])
def test_greedy_and_seeded_token_identity(tp):
    _same_as_tp1(tp)


@functools.lru_cache(maxsize=None)
def _gpt_params():
    """The reference's GPT init with every bias (zero there) drawn from
    numpy seed 3, so a bias added on more than one rank, or on none, moves
    the logits: (reference tree, numpy tree)."""
    tree = jax.device_get(ref_gpt_init(jax.random.PRNGKey(0), RefGPTConfig(**GPT_SHAPE)))
    rng = np.random.RandomState(3)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        if path[-1].key == "bias" else a, tree)
    return jax.tree_util.tree_map(jax.numpy.asarray, tree), tree


@functools.lru_cache(maxsize=None)
def _gpt_run(tp: int):
    """The standard request set on a GPT port engine at ``tp``: (tokens,
    logprobs); the engine is stopped."""
    cfg = GPTConfig(**GPT_SHAPE)
    eng = LLMEngine(cfg, gpt_params_from_jax(_gpt_params()[1], cfg, "cpu"),
                    EngineConfig(tp=tp, **GEOMETRY), device="cpu")
    try:
        reqs = [eng.submit(list(p), SamplingParams(**sp)) for p, sp in REQUESTS]
        return tuple(map(tuple, _drive(eng, reqs))), [list(r.out_logprobs) for r in reqs]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("tp", [2, 4])
def test_gpt_token_identity(tp):
    """GPT under tp (the fused qkv in each rank's order, two reductions a
    layer, rank 0's biases, fp32 masters cast per use): the tp 1 engine's
    tokens, logprobs within ``LOGPROB_TOL``, and the reference engine's
    greedy tokens at the same tp (it shards GPT through ``_shuffle_qkv``)."""
    want, want_lp = _gpt_run(1)
    got, got_lp = _gpt_run(tp)
    assert got == want
    gap = max(abs(a - b) for x, y in zip(got_lp, want_lp) for a, b in zip(x, y))
    assert gap <= LOGPROB_TOL, gap
    ref = RefEngine(RefGPTConfig(**GPT_SHAPE, remat=False, attn_impl="xla", fused_loss=False), _gpt_params()[0],
                    RefEngineConfig(tp=tp, **GEOMETRY))
    p, sp = REQUESTS[0]
    assert list(got[0]) == list(ref.generate(list(p), RefSamplingParams(**sp)))


@pytest.mark.slow
@pytest.mark.parametrize("tp", [2, 4])
def test_spec_decode_token_identity(tp):
    """Speculative decoding under tp: drafting is host-side, the sharded
    verify step must accept/correct exactly like single-card."""
    eng = _same_as_tp1(tp, spec_k=2)
    assert eng.stats()["spec_proposed"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("tp", [2, 4])
def test_prefix_cache_off_token_identity(tp):
    _same_as_tp1(tp, prefix_cache=False)


@pytest.mark.parametrize("tp", [2, 4])
def test_prefix_cache_warm_path_identity(tp):
    """A warm request sharing PROMPT as its prefix seeds from cached blocks
    (a CoW fork on every rank underneath) — still token-identical."""
    warm = SamplingParams(max_tokens=6, temperature=0.0)
    _, _, ref_eng = _matrix(1, 0, True)
    _, _, eng = _matrix(tp, 0, True)  # same traffic -> same cache state
    prompt = list(PROMPT) + [21, 22]
    want = ref_eng.generate(prompt, warm)
    hits_before = eng.prefix_cache.stats()["hit_tokens"]
    assert eng.generate(prompt, warm) == want
    assert eng.prefix_cache.stats()["hit_tokens"] > hits_before


@pytest.mark.slow
@pytest.mark.parametrize("tp", [2, 4])
def test_preemption_recompute_identity(tp):
    """A pool too small for all completions forces recompute preemption;
    the sharded engine preempts and recovers to the same tokens, which are
    the reference engine's at the same tp."""
    prompts = [[int(t) for t in np.random.RandomState(s).randint(0, TINY.vocab_size, 8)] for s in (5, 6, 7)]
    small = dict(max_slots=3, num_blocks=13, block_size=4, max_blocks_per_seq=10)

    def run(tp_):
        eng = _engine(tp=tp_, **small)
        try:
            reqs = [eng.submit(p, SamplingParams(max_tokens=16)) for p in prompts]
            out = _drive(eng, reqs)
            assert eng.stats()["preemptions"] > 0, "pool sized to force preemption"
            assert eng.pool.audit()["ok"]
        finally:
            eng.shutdown()
        return out

    got = run(tp)
    assert got == run(1)
    ref = RefEngine(TINY_REF, _ref_params(), RefEngineConfig(tp=tp, **{**GEOMETRY, **small}))
    reqs = [ref.submit(p, RefSamplingParams(max_tokens=16)) for p in prompts]
    assert got == _drive(ref, reqs)


@pytest.mark.parametrize("tp", [2, 4])
def test_failover_resume_tokens_identity(tp):
    """Mid-stream failover onto a tp engine: resuming from a tp 1 engine's
    delivered prefix reproduces the unkilled run exactly."""
    (full, _seeded, _), _, _ = _matrix(1, 0, True)
    _, _, eng = _matrix(tp, 0, True)
    req = eng.submit(list(PROMPT), SamplingParams(max_tokens=8), resume_tokens=full[:3])
    assert _drive(eng, [req])[0] == list(full)


def test_tp1_runner_is_the_single_card_arithmetic():
    """The tp runner and pool at tp 1 (a one-rank gloo group, no
    followers, the caller's tensors adopted, the layer issuing no
    reduction) are the single-card engine: tokens and logprobs equal the
    plain engine's bit for bit, spec on too."""

    class TP1Engine(LLMEngine):
        def _substrate(self, model_cfg, params, cache_cfg):
            return self._tp_substrate(model_cfg, params, cache_cfg, 1)

    for spec_k in (0, 2):
        want, want_lp, _ = _matrix(1, spec_k, True)
        eng = TP1Engine(TINY, _params(), EngineConfig(spec_k=spec_k, **GEOMETRY), device="cpu")
        reqs = [eng.submit(list(p), SamplingParams(**sp)) for p, sp in REQUESTS]
        assert tuple(map(tuple, _drive(eng, reqs))) == want
        assert [list(r.out_logprobs) for r in reqs] == want_lp
        led = eng.hbm_ledger()
        assert led["per_device"] == {"0": {k: led[k] for k in (
            "params_bytes", "pool_bytes", "seq_bytes", "cache_bytes", "free_bytes", "drafter_bytes")}}
        eng.shutdown()


# ----------------------------------------------------- sharded invariants


@pytest.mark.parametrize("tp", [2, 4])
def test_audit_and_watchdog_pass_sharded(tp):
    from ray_tpu_torch.llm.watchdog import EngineWatchdog

    _, _, eng = _matrix(tp, 0, True)
    assert eng.pool.audit()["ok"]
    assert eng.prefix_cache.audit()["ok"]
    info = EngineWatchdog(eng, stall_deadline_s=30.0).check_once()
    assert info["audit"]["ok"]
    assert not info["stalled"]


@pytest.mark.parametrize("tp", [2, 4])
def test_per_device_hbm_ledger(tp):
    """Per-device attribution: the pool splits exactly 1/tp per rank, the
    kv partition scales with local block bytes, params per rank exceed the
    even split (replicated leaves are a full copy each), and the top-level
    (pool-wide) numbers match the tp 1 engine's."""
    _, _, ref_eng = _matrix(1, 0, True)
    _, _, eng = _matrix(tp, 0, True)
    led = eng.hbm_ledger()
    ref = ref_eng.hbm_ledger()
    assert led["pool_bytes"] == ref["pool_bytes"]
    assert led["params_bytes"] == ref["params_bytes"]
    per = led["per_device"]
    assert list(per) == [str(r) for r in range(tp)]  # by rank on the CPU
    assert sum(row["pool_bytes"] for row in per.values()) == led["pool_bytes"]
    for row in per.values():
        assert row["pool_bytes"] == led["pool_bytes"] // tp
        assert row["params_bytes"] > led["params_bytes"] // tp
        bb_local = row["pool_bytes"] // eng.pool.cfg.num_blocks
        usable = (eng.pool.cfg.num_blocks - 1) * bb_local
        assert row["seq_bytes"] + row["cache_bytes"] + row["free_bytes"] == usable
    # the leader alone holds the final layernorm and the lm head
    head = sum(p.numel() * p.element_size() for n, p in _params().named_parameters()
               if n.startswith(("ln_f.", "lm_head.")))
    rows = list(per.values())
    assert all(r["params_bytes"] == rows[1]["params_bytes"] for r in rows[1:])
    assert rows[0]["params_bytes"] == rows[1]["params_bytes"] + head
    assert "per_device" not in ref


def test_hbm_gauges_carry_device_tag():
    """tp > 1 publishes the same gauge NAMES split by a device tag; the
    untagged series stays pool-wide."""
    from ray_tpu_torch.llm.engine import _metrics

    _, _, eng = _matrix(2, 0, True)
    eng._publish_gauges()
    led = eng.hbm_ledger()
    data = _metrics()["hbm_pool"]._snapshot()["data"]
    assert data.get("") == led["pool_bytes"]  # untagged = pool-wide
    tagged = {k: v for k, v in data.items() if "device" in k}
    assert len(tagged) >= 2
    assert sum(v for v in tagged.values() if v == led["pool_bytes"] // 2) == led["pool_bytes"]


@pytest.mark.slow
@pytest.mark.parametrize("tp", [2, 4])
def test_update_weights_sharded_hot_swap(tp):
    """update_weights sends every rank its slice of the new weights: the
    engine continues token-identical to an engine born with them, and the
    per-rank bytes are unchanged."""
    eng = _engine(tp=tp)
    try:
        eng.warmup()
        def resident():
            return {d: (r["params_bytes"], r["pool_bytes"]) for d, r in eng.hbm_ledger()["per_device"].items()}

        before = resident()
        assert eng.update_weights(_params(1)) == 1
        want = _engine(params=_params(1)).generate(list(PROMPT), SamplingParams(max_tokens=8))
        assert eng.generate(list(PROMPT), SamplingParams(max_tokens=8)) == want
        ref = RefEngine(TINY_REF, _ref_params(1), RefEngineConfig(**GEOMETRY))
        assert want == ref.generate(list(PROMPT), RefSamplingParams(max_tokens=8))
        assert resident() == before
        with pytest.raises(ValueError, match="mismatch"):
            eng.update_weights({k: v[..., :1] for k, v in _params(1).state_dict().items()})
    finally:
        eng.shutdown()


def test_divisibility_validation():
    from ray_tpu_torch.llm.cache import CacheConfig
    from ray_tpu_torch.llm.multichip import ShardedKVBlockPool, TensorParallelPagedModelRunner

    cache = CacheConfig(num_blocks=8, block_size=4, max_blocks_per_seq=4)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedKVBlockPool(cache, n_layers=2, n_heads=4, head_dim=16, tp=3)
    with pytest.raises(ValueError, match="not divisible"):
        TensorParallelPagedModelRunner(TINY, _params(), 4, tp=3, device="cpu")
    with pytest.raises(ValueError, match="tp must be >= 1"):
        TensorParallelPagedModelRunner(TINY, _params(), 4, tp=0, device="cpu")
    with pytest.raises(ValueError, match="needs the runner's group"):
        ShardedKVBlockPool(cache, n_layers=2, n_heads=4, head_dim=16, tp=2, device="cpu")


# ----------------------------------------------------- the port's processes


def test_card_leader_needs_its_cards():
    """A leader on the card with fewer visible cards than tp raises,
    naming both counts, before it starts any follower (a follower never
    runs on the CPU for a leader on the card)."""
    from ray_tpu_torch.llm._tp_worker import TPGroup

    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"tp={visible + 1} needs {visible + 1} visible cards, {visible} visible"):
        TPGroup(TINY, visible + 1, torch.device("cuda:0"), 4)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:  # a zombie is dead (its parent has not reaped it yet)
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def _wait_dead(pids, timeout: float) -> list:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        alive = [p for p in pids if _alive(p)]
        if not alive:
            return []
        time.sleep(0.1)
    return [p for p in pids if _alive(p)]


def test_killed_leader_leaves_no_follower(tmp_path):
    """SIGKILL the leader (mid-idle, its followers blocked on their pipes):
    every follower exits within a few seconds."""
    script = textwrap.dedent(f"""
        import sys, time, torch
        sys.path.insert(0, {str(REPO)!r})
        from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
        from ray_tpu_torch.models.gptj import GPTJConfig, gptj_init
        cfg = GPTJConfig(**{SHAPE!r})
        eng = LLMEngine(cfg, gptj_init(cfg, torch.Generator().manual_seed(0), "cpu"),
                        EngineConfig(tp=4, **{GEOMETRY!r}), device="cpu")
        eng.generate([1, 2, 3], SamplingParams(max_tokens=2))
        print(" ".join(str(p.pid) for p in eng.runner.group.procs), flush=True)
        time.sleep(600)
    """)
    leader = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, text=True)
    try:
        pids = [int(p) for p in leader.stdout.readline().split()]
        assert len(pids) == 3 and all(_alive(p) for p in pids)
        leader.send_signal(signal.SIGKILL)
        leader.wait()
        assert _wait_dead(pids, 15.0) == []
    finally:
        leader.kill()


def test_killed_follower_raises_on_the_next_step():
    """A follower that died makes the leader's next step raise at once
    (never hang), naming the rank, and every later step too."""
    eng = _engine(tp=2)
    try:
        assert eng.generate([1, 2, 3], SamplingParams(max_tokens=3))
        proc = eng.runner.group.procs[0]
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        eng.submit([4, 5, 6], SamplingParams(max_tokens=3))
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match=r"tp follower rank 1 \(pid \d+\) exited with code -9"):
            eng.step()
        assert time.monotonic() - t0 < 5.0
        with pytest.raises(RuntimeError, match="rank 1"):
            eng.step()
    finally:
        eng.shutdown()
    assert not _alive(proc.pid)


def test_follower_killed_during_a_step_raises():
    """A follower stopped in the middle of the leader's step (the leader
    waits in its reduction) and then killed: the step raises within a few
    seconds of the kill instead of waiting out the group's timeout."""
    import threading

    eng = _engine(tp=2)
    try:
        eng.generate([1, 2, 3], SamplingParams(max_tokens=2))
        eng.submit([4, 5, 6], SamplingParams(max_tokens=8))
        proc = eng.runner.group.procs[0]
        proc.send_signal(signal.SIGSTOP)
        caught = []

        def step():
            try:
                eng.step()
            except RuntimeError as e:
                caught.append((time.monotonic(), e))

        t = threading.Thread(target=step, daemon=True)
        t.start()
        time.sleep(1.0)
        assert t.is_alive(), "the step did not wait for the stopped follower"
        killed = time.monotonic()
        proc.send_signal(signal.SIGKILL)
        t.join(30.0)
        assert not t.is_alive() and caught, "the step did not raise after the follower died"
        assert caught[0][0] - killed < 10.0
        with pytest.raises(RuntimeError, match="rank 1"):
            eng.step()
    finally:
        eng.shutdown()


def test_a_follower_exit_seen_late_is_still_named():
    """A collective can fail on a dead peer a moment before its exit can be
    reaped: the leader's check after a failed step waits for the exit and
    names the rank (a flake of the test above under load)."""
    from ray_tpu_torch.llm._tp_worker import TPGroup

    class Dying:
        pid, returncode, polls = 4242, None, 0

        def poll(self):
            self.polls += 1
            if self.polls > 3:
                self.returncode = -9
            return self.returncode

    group = object.__new__(TPGroup)
    group.broken, group.procs = None, [Dying()]
    group.check()  # nothing seen yet: no wait, no raise
    with pytest.raises(RuntimeError, match=r"tp follower rank 1 \(pid 4242\) exited with code -9"):
        group.check(wait_s=2.0)


def test_default_process_group_untouched(tmp_path):
    """With the caller's default gloo group up, a tp engine builds its own
    private group beside it: the default group, its world and its
    collectives are the same after the engine served and stopped."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        world = dist.group.WORLD
        eng = _engine(tp=2)
        try:
            assert eng.generate(list(PROMPT), SamplingParams(max_tokens=8)) == list(_matrix(1, 0, True)[0][0])
        finally:
            eng.shutdown()
        assert dist.group.WORLD is world and dist.get_world_size() == 1 and dist.get_rank() == 0
        t = torch.ones(3)
        dist.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------- Serve


def test_serve_replica_at_tp2_serves_the_tp1_tokens():
    """``build_llm_app(tp=2)`` on the CPU: the replica's engine starts its
    follower and streams the tokens of a tp 1 engine on the same seed's
    weights."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import build_llm_app

    params = gptj_init(TINY, torch.Generator().manual_seed(0), "cpu")
    want = [_engine(params=params).generate(list(p), SamplingParams(max_tokens=8)) for p, _ in REQUESTS]
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    try:
        handle = serve.run(build_llm_app(model="gptj", model_cfg=TINY, engine_config=EngineConfig(**GEOMETRY),
                                         seed=0, tp=2, device="cpu", name="LLMDeploymentTP2"))
        for (p, _), w in zip(REQUESTS, want):
            assert list(handle.options(stream=True).remote(list(p), max_tokens=8)) == w
        assert handle.stats.remote().result()["hbm"]["per_device"].keys() == {"0", "1"}
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
