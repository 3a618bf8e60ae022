"""The port engine's watchdog, deadline shedding and stall diagnosis on the
CPU: the reference's ``TestWatchdog``, ``TestShedding`` and
``TestEngineStalledError`` (``tests/test_llm_robustness.py``) mirrored on
``ray_tpu_torch.llm``, with the reference's tiny GPT-J weights carried
over by ``params_from_jax``.

* the watchdog reaps cancelled and deadline-blown requests with the engine
  lock when it can, and unblocks their stream consumers WITHOUT it when the
  step loop is wedged holding it; one stall event per episode; the KV-pool
  audit catches leaked, duplicated and orphaned blocks;
* deadline-aware admission sheds doomed work with ``OverloadedError``
  (``retry_after_s`` attached) instead of queueing it, and never sheds
  without rate evidence, without a deadline, or with shedding off;
* ``stream_tokens`` timeouts raise ``EngineStalledError`` with the
  diagnosis, and the error pickles with it.
"""

import pickle
import threading
import time

import pytest

import jax

from ray_tpu.models.gptj import GPTJConfig as RefGPTJConfig
from ray_tpu.models.gptj import gptj_init as ref_gptj_init
from ray_tpu_torch._private import events
from ray_tpu_torch.exceptions import OverloadedError
from ray_tpu_torch.llm import (
    EngineConfig,
    EngineStalledError,
    EngineWatchdog,
    LLMEngine,
    SamplingParams,
)
from ray_tpu_torch.llm import engine as engine_mod
from ray_tpu_torch.llm import watchdog as watchdog_mod
from ray_tpu_torch.models.gptj import GPTJConfig, params_from_jax

TINY_KW = dict(vocab_size=128, seq_len=64, d_model=32, n_layers=2, n_heads=2, rotary_dim=8,
               dtype="float32")
TINY = GPTJConfig(**TINY_KW)
PROMPT = [5, 6, 7, 5, 6, 7, 5, 6, 7]


@pytest.fixture(scope="module")
def tiny_params():
    ref = ref_gptj_init(jax.random.PRNGKey(0),
                        RefGPTJConfig(**TINY_KW, remat=False, attn_impl="xla", fused_loss=False))
    return params_from_jax(jax.device_get(ref), TINY, "cpu")


def _engine(params, **kw):
    defaults = dict(max_slots=3, num_blocks=32, block_size=4, max_blocks_per_seq=12, prefill_chunk=8)
    defaults.update(kw)
    return LLMEngine(TINY, params, EngineConfig(**defaults), device="cpu")


def _counter(key) -> float:
    return watchdog_mod._metrics()[key]._snapshot()["data"].get("", 0.0)


class TestWatchdog:
    def test_reaps_deadline_and_cancel_with_lock(self, tiny_params):
        """Nobody driving step(): the watchdog alone frees the slots and
        blocks of doomed requests through the scheduler."""
        eng = _engine(tiny_params)
        wd = EngineWatchdog(eng, stall_deadline_s=30.0)
        r1 = eng.submit(PROMPT, SamplingParams(max_tokens=4), deadline_s=0.0)
        r2 = eng.submit(PROMPT, SamplingParams(max_tokens=4))
        eng.cancel(r2.id)
        reaped = _counter("reaped")
        info = wd.check_once()
        assert info["reaped"] == 2 and info["unblocked"] == 0
        assert r1.finished and r1.finish_reason == "deadline"
        assert r2.finished and r2.finish_reason == "cancelled"
        assert info["audit"]["ok"]
        assert eng.pool.num_used_blocks == 0  # blocks came back
        assert _counter("reaped") == reaped + 2

    def test_wedged_step_unblocks_consumers(self, tiny_params):
        """The step loop is stuck holding the engine lock: the watchdog
        cannot touch scheduler state, but the stream consumer of a
        deadline-blown request still gets its done sentinel."""
        eng = _engine(tiny_params)
        wd = EngineWatchdog(eng, stall_deadline_s=0.2, lock_timeout_s=0.01)
        req = eng.submit(PROMPT, SamplingParams(max_tokens=4), deadline_s=0.05)
        time.sleep(0.3)
        eng._lock.acquire()  # the wedge
        try:
            info = wd.check_once()
        finally:
            eng._lock.release()
        assert info["stalled"] and info["unblocked"] == 1
        assert req.stream.get_nowait() == ("done", "deadline")
        assert not req.finished  # scheduler state untouched without the lock
        # a second tick must not double-unblock the same request
        eng._lock.acquire()
        try:
            assert wd.check_once()["unblocked"] == 0
        finally:
            eng._lock.release()
        # the revived loop finishes it with the same reason
        eng.step()
        assert req.finished and req.finish_reason == "deadline"

    def test_stall_detection_one_event_per_episode(self, tiny_params):
        eng = _engine(tiny_params)
        wd = EngineWatchdog(eng, stall_deadline_s=0.3)
        eng.submit(PROMPT, SamplingParams(max_tokens=4))
        stalls = _counter("stalls")
        events.clear()
        eng._beat = (time.monotonic() - 1.0, 1)  # fake a wedged step
        assert wd.check_once()["stalled"]
        assert wd.check_once()["stalled"]
        assert wd.stall_count == 1  # the episode counted once
        age = watchdog_mod._metrics()["step_age"]._snapshot()["data"][""]
        assert age >= 1.0
        # progress clears the episode; a NEW wedge counts again
        eng.step()
        assert not wd.check_once()["stalled"]
        eng._beat = (time.monotonic() - 1.0, 1)
        wd.check_once()
        assert wd.stall_count == 2 and _counter("stalls") == stalls + 2
        stall_events = [e for e in events.snapshot() if e["type"] == "llm.watchdog.stall"]
        assert [e["source"] for e in stall_events] == ["watchdog", "watchdog"]
        assert stall_events[0]["last_step_age_s"] >= 1.0 and stall_events[0]["queue_depth"] == 1

    def test_idle_engine_never_stalls(self, tiny_params):
        eng = _engine(tiny_params)
        wd = EngineWatchdog(eng, stall_deadline_s=0.0)
        info = wd.check_once()
        assert not info["stalled"] and info["pending"] == 0
        assert watchdog_mod._metrics()["step_age"]._snapshot()["data"][""] == 0.0

    def test_leak_audit_detects_orphans_and_duplicates(self, tiny_params):
        eng = _engine(tiny_params)
        wd = EngineWatchdog(eng)
        assert wd.check_once()["audit"]["ok"]
        # an owner with no live request = leaked blocks
        eng.pool.allocate("ghost", 8)
        audit = wd.check_once()["audit"]
        assert not audit["ok"] and audit["orphans"] == ["ghost"]
        assert wd.leak_count == 1
        assert watchdog_mod._metrics()["audit_ok"]._snapshot()["data"][""] == 0.0
        eng.pool.free("ghost")
        assert wd.check_once()["audit"]["ok"]
        # ledger corruption: the same block on the free list twice
        eng.pool._free.append(eng.pool._free[-1])
        audit = eng.pool.audit()
        assert audit["duplicates"] and audit["missing"] < 0 and not audit["ok"]

    def test_prefix_tree_audit_rides_the_watchdog(self, tiny_params):
        eng = _engine(tiny_params)
        eng.generate(PROMPT * 2, SamplingParams(max_tokens=2))
        wd = EngineWatchdog(eng)
        audit = wd.check_once()["audit"]
        assert audit["ok"] and audit["prefix_cache"]["nodes"] > 0
        blk = next(iter(eng.prefix_cache._by_block))
        eng.pool._cache_held.discard(blk)  # a tree node whose block the pool forgot
        audit = wd.check_once()["audit"]
        assert not audit["ok"] and audit["prefix_cache"]["dangling"] == [blk]

    def test_watchdog_thread_lifecycle(self, tiny_params):
        eng = _engine(tiny_params, watchdog_stall_s=0.5, watchdog_interval_s=0.05)
        wd = eng.start_watchdog()
        assert wd.is_alive() and wd.stall_deadline_s == 0.5 and wd.interval_s == 0.05
        assert eng.start_watchdog() is wd  # idempotent
        wd.stop()
        assert not wd.is_alive()

    def test_thread_reaps_a_deadline_behind_a_wedge(self, tiny_params):
        """The watchdog thread, not a test's direct call, ends a doomed
        stream while the engine lock is held for longer than the stall
        deadline, and reports the stall."""
        eng = _engine(tiny_params, watchdog_stall_s=0.2, watchdog_interval_s=0.02)
        wd = eng.start_watchdog()
        try:
            req = eng.submit(PROMPT, SamplingParams(max_tokens=4), deadline_s=0.1)
            t0 = time.monotonic()
            with eng._lock:  # the wedge
                toks = list(eng.stream_tokens(req, timeout=5))
                waited = time.monotonic() - t0
                assert toks == [] and 0.1 <= waited < 2.0
                deadline = time.monotonic() + 5
                while wd.stall_count == 0 and time.monotonic() < deadline:
                    time.sleep(0.02)
                assert wd.stall_count == 1
        finally:
            wd.stop()
        eng.step()
        assert req.finish_reason == "deadline"


class TestShedding:
    def test_doomed_deadline_is_shed_with_retry_after(self, tiny_params):
        eng = _engine(tiny_params)
        eng._rate = 50.0  # measured service rate: 50 tokens/s
        for _ in range(3):
            eng.submit(PROMPT, SamplingParams(max_tokens=20))
        events.clear()
        before = engine_mod._metrics()["shed"]._snapshot()["data"].get("", 0.0)
        # backlog is 60 promised tokens + 20 new at 50/s = 1.6 s; 0.1 s is doomed
        with pytest.raises(OverloadedError) as ei:
            eng.submit(PROMPT, SamplingParams(max_tokens=20), deadline_s=0.1)
        assert ei.value.retry_after_s == pytest.approx(1.5)
        assert engine_mod._metrics()["shed"]._snapshot()["data"][""] == before + 1
        (ev,) = [e for e in events.snapshot() if e["type"] == "llm.shed"]
        assert ev["estimate_s"] == pytest.approx(1.6) and ev["retry_after_s"] == ei.value.retry_after_s
        # ...but a generous deadline is admitted
        req = eng.submit(PROMPT, SamplingParams(max_tokens=20), deadline_s=60.0)
        assert req.state == "waiting"

    def test_no_rate_evidence_never_sheds(self, tiny_params):
        eng = _engine(tiny_params)
        assert eng._rate == 0.0
        req = eng.submit(PROMPT, SamplingParams(max_tokens=20), deadline_s=0.001)
        assert req in list(eng.scheduler.waiting)

    def test_no_deadline_never_sheds(self, tiny_params):
        eng = _engine(tiny_params)
        eng._rate = 1.0
        for _ in range(4):
            eng.submit(PROMPT, SamplingParams(max_tokens=20))
        assert eng.scheduler.num_waiting == 4

    def test_shed_disabled_by_config(self, tiny_params):
        eng = _engine(tiny_params, shed=False)
        eng._rate = 50.0
        for _ in range(3):
            eng.submit(PROMPT, SamplingParams(max_tokens=20))
        req = eng.submit(PROMPT, SamplingParams(max_tokens=20), deadline_s=0.01)
        assert not req.finished

    def test_service_rate_tracks_generation_and_resets_idle(self, tiny_params):
        eng = _engine(tiny_params)
        # sustained generation (> the 0.5 s sampling window) measures a rate
        deadline = time.time() + 30
        while eng.stats()["service_rate_tokens_per_s"] <= 0:
            eng.generate(PROMPT, SamplingParams(max_tokens=20))
            assert time.time() < deadline, "rate never measured"
        # going idle RESETS it (no evidence is not slowness): two idle
        # windows, the first still counting the burst's tail tokens
        for _ in range(2):
            time.sleep(0.6)
            eng.step()
        assert eng.stats()["service_rate_tokens_per_s"] == 0.0
        req = eng.submit(PROMPT, SamplingParams(max_tokens=4), deadline_s=0.5)
        assert not req.finished  # admitted, not shed

    def test_empty_engine_never_sheds_despite_stale_rate(self, tiny_params):
        eng = _engine(tiny_params)
        eng._rate = 0.001  # pathologically stale-low rate, zero backlog
        req = eng.submit(PROMPT, SamplingParams(max_tokens=20), deadline_s=0.5)
        assert not req.finished  # no backlog -> no shedding evidence


class TestEngineStalledError:
    def test_timeout_carries_diagnosis(self, tiny_params):
        eng = _engine(tiny_params)
        req = eng.submit(PROMPT, SamplingParams(max_tokens=4))
        with pytest.raises(EngineStalledError) as ei:
            list(eng.stream_tokens(req, timeout=0.2))
        err = ei.value
        assert isinstance(err, TimeoutError)  # old catch sites keep working
        assert err.queue_depth >= 1
        assert err.last_step_age_s >= 0.0
        assert 0.0 <= err.kv_utilization <= 1.0
        assert "queue_depth" in str(err)

    def test_pickles_with_diagnosis(self):
        err = EngineStalledError("x", last_step_age_s=1.5, queue_depth=3, kv_utilization=0.5)
        back = pickle.loads(pickle.dumps(err))
        assert isinstance(back, EngineStalledError)
        assert back.last_step_age_s == 1.5 and back.queue_depth == 3 and back.kv_utilization == 0.5

    def test_healthy_stream_unaffected(self, tiny_params):
        eng = _engine(tiny_params)
        stop = threading.Event()
        t = threading.Thread(target=eng.run_loop, args=(stop,), daemon=True)
        t.start()
        try:
            req = eng.submit(PROMPT, SamplingParams(max_tokens=8))
            toks = list(eng.stream_tokens(req, timeout=30))
            assert len(toks) == 8
        finally:
            stop.set()
            t.join(timeout=5)
