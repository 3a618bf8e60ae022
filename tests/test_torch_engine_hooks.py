"""The same traffic through the reference engine and the port engine, on the
CPU, with the production hooks on: ``ray_tpu_torch.llm.LLMEngine`` vs
``ray_tpu.llm.LLMEngine``.

Tiny fp32 GPT-J and GPT (the reference's weights, carried over with
``params_from_jax``), plain and speculating at ``spec_k=4``. One traffic
script drives both engines step by step: concurrent admission into a pool
too small for all of it (recompute preemption), a cancel, a request whose
deadline has passed, then a repeated prompt (a prefix hit) and one that
diverges inside a cached block (a copy-on-write fork). Both engines must
then agree on:

* the output tokens and finish reasons, and the counters
  ``llm_generated_tokens``, ``llm_prefill_tokens``, ``llm_preemptions``,
  ``llm_finished_requests``, the prefix cache's hit and miss tokens and,
  speculating, the draft and accepted tokens;
* every request's sequence of flight-recorder event types, and the prefix
  cache's event sequence;
* the phase ledger: each request's engine phases sum to finish − submit,
  preemption, copy-on-write and verify time land in their own phases;
* the HBM ledger: block bytes, pool bytes and the seq-owned / cache-only /
  free partition of the pool after every step.
"""

import time

import numpy as np
import pytest

import jax

from ray_tpu._private import events as ref_events
from ray_tpu.llm import EngineConfig as RefEngineConfig
from ray_tpu.llm import LLMEngine as RefEngine
from ray_tpu.llm import SamplingParams as RefSamplingParams
from ray_tpu.llm import engine as ref_engine_mod
from ray_tpu.llm import prefix_cache as ref_prefix_mod
from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.models.gpt import gpt_init as ref_gpt_init
from ray_tpu.models.gptj import GPTJConfig as RefGPTJConfig
from ray_tpu.models.gptj import gptj_init as ref_gptj_init
from ray_tpu_torch._private import events
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm import engine as engine_mod
from ray_tpu_torch.llm import prefix_cache as prefix_mod
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.models.gpt import params_from_jax as gpt_params_from_jax
from ray_tpu_torch.models.gptj import GPTJConfig
from ray_tpu_torch.models.gptj import params_from_jax as gptj_params_from_jax
from ray_tpu_torch.util import phases

GPTJ = dict(vocab_size=128, seq_len=64, d_model=32, n_layers=2, n_heads=2, rotary_dim=8, dtype="float32")
GPT = dict(vocab_size=128, seq_len=40, d_model=32, n_layers=2, n_heads=2, dtype="float32")
REF_EXTRA = dict(remat=False, attn_impl="xla", fused_loss=False)
# a pool too small for three whole requests at once: 12 usable blocks of 4
GEOMETRY = dict(max_slots=3, num_blocks=13, block_size=4, max_blocks_per_seq=10, prefill_chunk=8,
                shed=False)
PERIODIC = [5, 9, 7, 5, 9, 7, 5, 9]

COUNTERS = (
    (engine_mod, ref_engine_mod, "tokens"),
    (engine_mod, ref_engine_mod, "prefill_tokens"),
    (engine_mod, ref_engine_mod, "preempt"),
    (engine_mod, ref_engine_mod, "finished"),
    (engine_mod, ref_engine_mod, "spec_proposed"),
    (engine_mod, ref_engine_mod, "spec_accepted"),
    (prefix_mod, ref_prefix_mod, "hit_tokens"),
    (prefix_mod, ref_prefix_mod, "miss_tokens"),
)


def _counter(mod, key) -> float:
    return mod._metrics()[key]._snapshot()["data"].get("", 0.0)


def _prompt(n, seed):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 128, n)]


def _drive(eng, reqs, ledger, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not all(r.finished for r in reqs):
        _step(eng, ledger)
        assert time.monotonic() < deadline, "engine did not finish in time"


def _step(eng, ledger):
    eng.step()
    led = eng.hbm_ledger()
    ledger.append(tuple(led[k] for k in ("block_bytes", "pool_bytes", "seq_bytes", "cache_bytes",
                                         "free_bytes", "free_blocks")))


def _traffic(eng, sp_cls, spec: bool):
    """The script both engines run. Returns ({name: request}, ledger)."""
    ledger = []
    greedy = sp_cls(max_tokens=14)
    heads = [PERIODIC + PERIODIC[:1], PERIODIC[::-1] + [5], _prompt(9, 3)] if spec else \
        [_prompt(9, s) for s in (1, 2, 3)]
    reqs = {f"r{i}": eng.submit(p, greedy) for i, p in enumerate(heads)}  # concurrent admission
    for _ in range(3):
        _step(eng, ledger)
    reqs["cancelled"] = eng.submit(_prompt(6, 4), sp_cls(max_tokens=10))
    for _ in range(2):
        _step(eng, ledger)
    assert eng.cancel(reqs["cancelled"].id)
    reqs["late"] = eng.submit(_prompt(5, 5), sp_cls(max_tokens=10), deadline_s=0.0)
    _drive(eng, list(reqs.values()), ledger)
    # a repeated prompt (prefix hit), then one diverging inside its second
    # block (a copy-on-write fork)
    reqs["warm"] = eng.submit(heads[0], sp_cls(max_tokens=6))
    _drive(eng, [reqs["warm"]], ledger)
    reqs["fork"] = eng.submit(heads[0][:6] + _prompt(4, 6), sp_cls(max_tokens=6))
    _drive(eng, [reqs["fork"]], ledger)
    return reqs, ledger


def _run(eng, sp_cls, ev_mod, counter_side, spec):
    ev_mod.clear()
    before = {key: _counter(mods[counter_side], key) for *mods, key in COUNTERS}
    reqs, ledger = _traffic(eng, sp_cls, spec)
    counts = {key: _counter(mods[counter_side], key) - before[key] for *mods, key in COUNTERS}
    snap = ev_mod.snapshot()
    per_request = {
        name: [e["type"] for e in snap if e.get("request_id") == req.trace_id] for name, req in reqs.items()
    }
    prefix_events = [e["type"] for e in snap if e["type"].startswith("llm.prefix.")]
    ev_mod.clear()
    pool = eng.pool
    blocks = range(pool.cfg.num_blocks)
    residency = dict(cached=pool.num_cached_blocks, evictable=pool.num_evictable_blocks,
                     owners=pool.owner_count(), refs=[pool.ref(b) for b in blocks],
                     held=[pool.is_cache_held(b) for b in blocks], counts=pool.ledger_counts())
    return dict(reqs=reqs, ledger=ledger, counts=counts, events=per_request, prefix_events=prefix_events,
                hbm=eng.hbm_ledger(), stats=eng.stats(), residency=residency)


CASES = ["gptj-plain", "gptj-spec", "gpt-plain", "gpt-spec"]


@pytest.fixture(scope="module", params=CASES)
def runs(request):
    arch, mode = request.param.split("-")
    spec = mode == "spec"
    kw = GPTJ if arch == "gptj" else GPT
    if arch == "gptj":
        ref_cfg, cfg = RefGPTJConfig(**kw, **REF_EXTRA), GPTJConfig(**kw)
        ref_params = ref_gptj_init(jax.random.PRNGKey(0), ref_cfg)
        params = gptj_params_from_jax(jax.device_get(ref_params), cfg, "cpu")
    else:
        ref_cfg, cfg = RefGPTConfig(**kw, **REF_EXTRA), GPTConfig(**kw)
        ref_params = ref_gpt_init(jax.random.PRNGKey(0), ref_cfg)
        params = gpt_params_from_jax(jax.device_get(ref_params), cfg, "cpu")
    geometry = dict(GEOMETRY, spec_k=4 if spec else 0)
    ref = RefEngine(ref_cfg, ref_params, RefEngineConfig(**geometry))
    port = LLMEngine(cfg, params, EngineConfig(**geometry), device="cpu")
    return dict(spec=spec, ref=_run(ref, RefSamplingParams, ref_events, 1, spec),
                port=_run(port, SamplingParams, events, 0, spec))


def test_same_tokens_and_counters(runs):
    ref, port = runs["ref"], runs["port"]
    for name, req in port["reqs"].items():
        want = ref["reqs"][name]
        assert (req.out, req.finish_reason) == (list(want.out), want.finish_reason), name
    assert port["reqs"]["cancelled"].finish_reason == "cancelled"
    assert port["reqs"]["late"].finish_reason == "deadline"
    assert port["counts"] == ref["counts"]
    c = port["counts"]
    assert c["finished"] == len(port["reqs"]) and c["preempt"] > 0 and c["hit_tokens"] > 0
    assert c["tokens"] == sum(len(r.out) for r in port["reqs"].values())
    assert port["stats"]["prefix_cache"]["cow_forks"] == ref["stats"]["prefix_cache"]["cow_forks"] == 1
    if runs["spec"]:
        assert c["spec_proposed"] > 0 and c["spec_accepted"] > 0
        assert c["spec_proposed"] == port["stats"]["spec_proposed"]
    else:
        assert c["spec_proposed"] == 0


def test_same_event_sequences(runs):
    ref, port = runs["ref"], runs["port"]
    assert port["events"] == ref["events"]
    assert port["prefix_events"] == ref["prefix_events"]
    evs = port["events"]
    for name, types in evs.items():
        assert types[0] == "llm.submit" and types[-1] == "llm.finish", name
        assert types[-2] == "llm.phase.ledger", name
        if port["reqs"][name].finish_reason == "length":
            # a prefix hit is recorded inside admission, before its event
            assert types[1:3] in (["llm.admit", "llm.prefill_chunk"], ["llm.prefix.hit", "llm.admit"]), name
    assert evs["late"] == ["llm.submit", "llm.phase.ledger", "llm.finish"]
    assert "llm.preempt" in sum(evs.values(), [])
    assert "llm.prefix.hit" in evs["fork"]  # its copy-on-write fork needs a match
    step_kind = "llm.verify" if runs["spec"] else "llm.decode"
    assert any(step_kind in types for types in evs.values())


def _phase_ledgers(side):
    out = {}
    for name, req in side["reqs"].items():
        led = req.phase_led
        assert led is not None
        # Σ phases == finish − submit: the cursor sits at the finish stamp
        assert abs(sum(led[1:]) - (led[0] - req.arrival_t)) < 1e-9, name
        out[name] = dict(zip(phases.ENGINE_PHASES, led[1:]))
    return out


def test_phase_identity_and_attribution(runs):
    for side in ("ref", "port"):
        got = _phase_ledgers(runs[side])
        preempted = [n for n, t in runs[side]["events"].items() if "llm.preempt" in t]
        assert preempted and all(got[n]["preempt"] > 0 for n in preempted), side
        assert got["fork"]["cow_fork"] > 0, side
        verify = sum(p["spec_verify"] for p in got.values())
        assert (verify > 0) == runs["spec"], side
        # reaped while waiting: its whole life was the queue
        assert got["late"]["queue"] > 0 and sum(got["late"].values()) == got["late"]["queue"], side


def test_hbm_ledger_partition_matches_at_every_step(runs):
    ref, port = runs["ref"], runs["port"]
    assert port["ledger"] == ref["ledger"]
    hbm = port["hbm"]
    usable = GEOMETRY["num_blocks"] - 1
    for bb, pool, seq, cache, free, _nfree in port["ledger"]:
        assert seq + cache + free == usable * bb and pool == GEOMETRY["num_blocks"] * bb
    assert hbm["params_bytes"] == ref["hbm"]["params_bytes"] > 0
    assert hbm["drafter_bytes"] == ref["hbm"]["drafter_bytes"] == 0
    assert port["stats"]["hbm"]["pool_bytes"] == hbm["pool_bytes"]
    # the pool's residency accessors agree block by block
    assert port["residency"] == ref["residency"]
    res = port["residency"]
    assert res["cached"] == sum(res["held"]) > 0 and res["owners"] == 0
    assert res["counts"]["cache_only"] == res["evictable"] == res["cached"]
