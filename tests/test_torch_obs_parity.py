"""The port's operator tooling held against the reference on the same
inputs, made from a seed:

* every pure renderer of ``obs`` gives the reference's text byte for byte
  (``render_*``, ``sparkline``, ``hist_pcts_row``, ``waterfall_top_row``,
  ``core_batch_top_row``, ``core_data_plane_top_row``), the clock pinned;
* ``util.grafana.dashboard_json()``'s static rows are the reference's
  panels (every field but three descriptions, which word the device-step
  profiler's panels for step functions and name the card), and its
  dynamic loop skips exactly the names those rows chart;
* a small GPT engine (vocab 64, d 32, 2 layers, ``spec_k=2``, as
  ``tests/test_profiling_plane.py``'s steady-state case) reports the same
  per-site step counts, the same tokens and 0 retraces in both packages;
* every name of ``ray_tpu/obs.py`` resolves in the port's ``obs``, and the
  metric registries the CLI and Grafana read are the reference's."""

import json
import time

import numpy as np
import pytest

import jax
from ray_tpu import obs as ref_obs
from ray_tpu.util import grafana as ref_grafana
from ray_tpu_torch import obs
from ray_tpu_torch.util import grafana
from ray_tpu_torch.util import waterfall as wfl

SEEDS = [0, 1, 2]
NOW = 1_700_000_000.0


@pytest.fixture
def frozen_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


def _same(fn_name, *args, **kw):
    got = getattr(obs, fn_name)(*args, **kw)
    want = getattr(ref_obs, fn_name)(*args, **kw)
    assert got == want, (fn_name, got, want)
    return got


def _pcts(rng, n=None):
    p = sorted(rng.random(3) * 10 ** rng.uniform(-5, 0, 1)[0])
    return {"count": int(rng.integers(0, 6)) if n is None else n,
            "p50": float(p[0]), "p95": float(p[1]), "p99": float(p[2])}


def _legs(rng):
    return {name: _pcts(rng) for name, _i, _j in wfl.LEGS if rng.random() < 0.9}


def _counter_points(rng, n):
    t = NOW - 60 + np.cumsum(rng.random(n) * 3)
    return [(float(ts), float(v)) for ts, v in zip(t, np.cumsum(rng.random(n) * 50))]


def _hist_points(rng, n, nb=3):
    t = NOW - 60 + np.cumsum(rng.random(n) * 3)
    counts = np.cumsum(rng.integers(0, 5, (n, nb + 1)), axis=0)
    return [(float(ts), [int(x) for x in c] + [float(c.sum() * 0.01), int(c.sum())])
            for ts, c in zip(t, counts)]


@pytest.mark.parametrize("seed", SEEDS)
def test_row_renderers_match(seed):
    rng = np.random.default_rng(seed)
    vals = list(rng.random(int(rng.integers(1, 80))) * 100)
    _same("sparkline", vals)
    _same("sparkline", vals, width=int(rng.integers(1, 30)))
    _same("sparkline", [3.0] * 5)
    _same("sparkline", [])
    for n in (0, 1, 2, 7):
        _same("hist_pcts_row", _pcts(rng, n))
    _same("hist_pcts_row", None)
    _same("waterfall_top_row", {"legs": _legs(rng)})
    _same("render_waterfall", {"folded": int(rng.integers(0, 99)),
                               "incomplete": int(rng.integers(0, 9)), "legs": _legs(rng)})
    metrics = {
        "core_submit_batch_size": {"": float(rng.random())},
        "core_submit_credits": {"": float(rng.integers(0, 8192))},
        "core_shm_put_bytes": {"": float(rng.integers(0, 1 << 30))},
        "core_data_local_hits": {"": float(rng.integers(0, 99)), '{"node":"b"}': 3.0},
        "core_data_remote_pulls": {"": float(rng.integers(0, 99))},
        "core_arena_occupancy": {"": float(rng.random())},
    }
    pcts = {"core_submit_batch_size": {"": _pcts(rng)}, "core_reply_batch_size": {"": _pcts(rng)}}
    series = {"core_shm_put_bytes": {"kind": "counter",
                                     "series": {"": _counter_points(rng, int(rng.integers(1, 6)))}},
              "core_shm_get_bytes": {"kind": "counter", "series": {"": _counter_points(rng, 4)}}}
    _same("core_batch_top_row", metrics, pcts)
    _same("core_batch_top_row", {}, {})
    _same("core_data_plane_top_row", metrics, series)
    _same("core_data_plane_top_row", {"core_arena_occupancy": {"": 0.5}}, {})
    _same("core_data_plane_top_row", {}, {})


@pytest.mark.parametrize("seed", SEEDS)
def test_series_and_alerts_renderers_match(seed, frozen_clock):
    rng = np.random.default_rng(seed)
    tag = json.dumps({"site": "decode"})
    ents = {
        "c": {"kind": "counter", "boundaries": None,
              "series": {"": _counter_points(rng, int(rng.integers(1, 9))),
                         tag: _counter_points(rng, 1)}},
        "g": {"kind": "gauge", "boundaries": None,
              "series": {"": _counter_points(rng, int(rng.integers(1, 9))), tag: []}},
        "h": {"kind": "histogram", "boundaries": [0.001, 0.01, 0.1],
              "series": {tag: _hist_points(rng, int(rng.integers(1, 9))), "": _hist_points(rng, 1)}},
        "empty": {"kind": "counter", "boundaries": None, "series": {}},
    }
    for name, ent in ents.items():
        _same("render_series", name, ent, float(rng.integers(10, 120)))
    rules = ["ttft-p99", "retrace-storm", "request-errors", "arena-pressure"]
    alerts = [
        {"rule": r, "status": str(rng.choice(["FIRING", "OK", "RESOLVED"])),
         "value": float(rng.random() * 30),
         "since": (NOW - float(rng.random() * 500)) if rng.random() < 0.7 else None,
         "detail": ({"fast_burn": float(rng.random() * 20), "slow_burn": float(rng.random() * 9)}
                    if rng.random() < 0.6 else {"no_data": True}),
         "labels": {"serve": "upscale"} if rng.random() < 0.5 else {}}
        for r in rules
    ]
    _same("render_alerts", alerts)
    _same("render_alerts", [])


@pytest.mark.parametrize("seed", SEEDS)
def test_object_plane_renderers_match(seed):
    rng = np.random.default_rng(seed)
    hexes = lambda n: "".join(rng.choice(list("0123456789abcdef"), n))  # noqa: E731
    states = ["inline", "arena", "segment", "spilled"]
    rows = [
        {"object_id": hexes(40), "state": str(rng.choice(states)), "node": hexes(16),
         "size": int(rng.integers(0, 1 << 34)), "refcount": int(rng.integers(0, 4)),
         "pins": int(rng.integers(0, 3)), "age_s": float(rng.random() * 600),
         "spill_path": f"/spill/{hexes(8)}" if rng.random() < 0.3 else None,
         "seg": f"rta-{hexes(6)}" if rng.random() < 0.3 else None,
         "is_error": bool(rng.random() < 0.2)}
        for _ in range(int(rng.integers(0, 12)))
    ]
    ledger = {
        "objects": rows,
        "summary": {"objects": len(rows), "bytes": int(sum(r["size"] for r in rows)),
                    "by_state": {s: int(rng.integers(0, 5)) for s in states}},
        "poisoned": [{"object_id": hexes(40), "node": hexes(16), "pid": int(rng.integers(1, 9999))}],
        "freed": [{"object_id": hexes(40), "size": int(rng.integers(0, 1 << 20)),
                   "age_s": float(rng.random() * 9), "reason": "refcount"} for _ in range(7)],
    }
    for sort in ("size", "age"):
        for top in (0, 3):
            _same("render_objects", ledger, sort=sort, top=top)
    _same("render_objects", {})
    audit = {"checked": {"objects": int(rng.integers(0, 99)), "owned_allocations": 4,
                         "spill_files": 2, "pins": 1}, "pin_lease_s": 30.0,
             "findings": [{"kind": "stale_pin", "node": hexes(8), "object_id": hexes(16),
                           "age_s": float(rng.random()), "note": None}]}
    _same("render_audit", audit)
    _same("render_audit", dict(audit, findings=[]))
    nodes = {hexes(16): {"used": int(rng.integers(0, 1 << 30)), "capacity": 1 << 30,
                         "pinned_bytes": int(rng.integers(0, 1 << 20)), "pins": int(rng.integers(0, 4)),
                         "oldest_pin_age_s": float(rng.random() * 50) if rng.random() < 0.5 else 0.0,
                         "spill_bytes": int(rng.integers(0, 1 << 25)) if rng.random() < 0.5 else 0}
             for _ in range(3)}
    nodes["empty"] = {}
    _same("render_arena", nodes)
    _same("render_arena", {})


@pytest.mark.parametrize("seed", SEEDS)
def test_request_and_attribution_renderers_match(seed):
    rng = np.random.default_rng(seed)
    t0 = NOW + float(rng.random())
    rid = "abcd" * 4
    evs = [
        {"ts": t0, "seq": 0, "type": "proxy.request", "request_id": rid, "pid": 11, "node": "n0aa11bb22"},
        {"ts": t0 + 0.001, "seq": 1, "type": "llm.submit", "request_id": rid, "pid": 12, "prompt_len": 12},
        {"ts": t0 + 0.002, "seq": 2, "type": "llm.admit", "request_id": rid, "pid": 12, "slot": 1},
        {"ts": t0 + 0.01, "seq": 3, "type": "llm.first_token", "request_id": rid, "pid": 12,
         "ttft_s": float(rng.random() * 0.1)},
    ]
    for i in range(int(rng.integers(0, 5))):
        k = int(rng.integers(1, 5))
        evs.append({"ts": t0 + 0.02 + i * 0.01, "seq": 4 + i, "type": "llm.verify", "request_id": rid,
                    "pid": 12, "accepted": int(rng.integers(0, k + 1)), "proposed": k})
    evs.append({"ts": t0 + 0.2, "seq": 20, "type": "llm.finish", "request_id": rid, "pid": 12,
                "reason": "length", "tokens_out": 24, "dur_s": 0.19})

    def ledger(r, t, resumed=0):
        ph = {k: float(v) for k, v in zip(("queue", "prefill", "decode", "spec_verify"), rng.random(4) * 0.2)}
        return {"type": "llm.phase.ledger", "request_id": r, "engine_req": 1, "reason": "complete",
                "t_submit": t, "t_finish": t + sum(ph.values()) * float(rng.uniform(0.97, 1.03)),
                "resumed": resumed, "phases": ph}

    led = ledger(rid, t0 + 0.001)
    evs.append(led)
    evs.append({"type": "llm.phase.proxy", "request_id": rid, "t_recv": t0, "t_dispatch": t0 + 0.0005,
                "t_done": led["t_finish"] + 0.002})
    _same("render_request", rid, evs)
    _same("render_request", rid, [])
    many = [ledger(f"r{i:03d}", NOW + i, resumed=int(rng.random() < 0.2)) for i in range(int(rng.integers(1, 30)))]
    for e in many[: len(many) // 2]:
        many.append({"type": "llm.phase.proxy", "request_id": e["request_id"], "t_recv": e["t_submit"] - 0.01,
                     "t_dispatch": e["t_submit"] - 0.005, "t_done": e["t_finish"] + 0.003})
    rows = obs.attribute_rows(many)
    assert rows == ref_obs.attribute_rows(many)
    report = obs.attribution_report(rows, top=5)
    assert report == ref_obs.attribution_report(rows, top=5)
    _same("render_attribution", report)


def test_grafana_dashboard_matches_the_references_panels():
    """The static rows are the reference's panel for panel; the dynamic
    loop skips exactly the names those rows chart (``util.grafana``'s
    module doc), where the reference's list skips two names no row charts
    and misses the ``core_`` names."""
    extra = ["my_counter", "llm_generated_tokens", "llm_finished_requests", "core_tasks",
             "core_submit_credits", "user_gauge"]
    got = grafana.dashboard_json(extra_metric_names=extra)
    want = ref_grafana.dashboard_json(extra_metric_names=extra)
    n = len(grafana._static_rows())
    strip = lambda panels: [{k: v for k, v in p.items() if k != "description"} for p in panels]  # noqa: E731
    assert strip(got["panels"][:n]) == strip(want["panels"][:n])
    differ = [p["title"] for p, q in zip(got["panels"][:n], want["panels"][:n])
              if p["description"] != q["description"]]
    assert differ == ["Logical resource utilization", "Device step p99 by site", "Jit retraces/s"]
    assert [p["title"] for p in got["panels"][n:]] == [
        "my_counter", "llm_finished_requests", "core_submit_credits", "user_gauge"]
    assert [p["title"] for p in want["panels"][n:]] == [
        "my_counter", "core_tasks", "core_submit_credits", "user_gauge"]
    assert ref_grafana._LLM_NAMES - grafana._LLM_NAMES == {"llm_finished_requests", "llm_prefill_tokens"}
    assert {k: v for k, v in got.items() if k not in ("panels", "title", "tags")} == \
        {k: v for k, v in want.items() if k not in ("panels", "title", "tags")}
    assert got["title"] == "ray_tpu_torch" and got["tags"] == ["ray_tpu_torch", "generated"]


def test_every_reference_obs_name_resolves():
    names = [n for n in vars(ref_obs) if not n.startswith("__")
             and getattr(getattr(ref_obs, n), "__module__", "ray_tpu.obs") == "ray_tpu.obs"]
    assert "main" in names and "METRIC_NAMES" in names
    missing = [n for n in names if not hasattr(obs, n)]
    assert missing == []
    assert obs.METRIC_NAMES == ref_obs.METRIC_NAMES


def test_metric_registries_match_the_references():
    from ray_tpu.llm import engine as ref_engine
    from ray_tpu.llm import prefix_cache as ref_prefix
    from ray_tpu.util import device_prof as ref_dp
    from ray_tpu.util import phases as ref_phases
    from ray_tpu.util import waterfall as ref_wfl
    from ray_tpu_torch.llm import engine, prefix_cache
    from ray_tpu_torch.util import device_prof, phases

    for mine, ref in ((engine, ref_engine), (prefix_cache, ref_prefix), (device_prof, ref_dp),
                      (phases, ref_phases), (wfl, ref_wfl)):
        assert mine.METRIC_NAMES == ref.METRIC_NAMES, mine.__name__


def test_engine_step_sites_match_the_reference():
    """The same small GPT (the reference's weights carried over) served the
    same requests: equal tokens, equal calls per step site, 0 retraces."""
    from ray_tpu.llm.engine import EngineConfig as RefEngineConfig
    from ray_tpu.llm.engine import LLMEngine as RefEngine
    from ray_tpu.llm.scheduler import SamplingParams as RefSamplingParams
    from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
    from ray_tpu.models.gpt import gpt_init as ref_gpt_init
    from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine
    from ray_tpu_torch.llm.scheduler import SamplingParams
    from ray_tpu_torch.models.gpt import GPTConfig, params_from_jax

    tiny = dict(vocab_size=64, seq_len=64, d_model=32, n_layers=2, n_heads=2, dtype="float32")
    geometry = dict(max_slots=2, num_blocks=16, block_size=8, max_blocks_per_seq=8, spec_k=2)
    ref_cfg = RefGPTConfig(**tiny, remat=False, attn_impl="xla", fused_loss=False)
    tree = ref_gpt_init(jax.random.PRNGKey(0), ref_cfg)
    ref = RefEngine(ref_cfg, tree, RefEngineConfig(**geometry))
    cfg = GPTConfig(**tiny)
    eng = LLMEngine(cfg, params_from_jax(jax.device_get(tree), cfg, "cpu"), EngineConfig(**geometry),
                    device="cpu")
    prompts = ([1, 2, 3], [4, 5, 6, 7], [1, 2, 3], [9, 8, 9, 8, 9, 8])
    outs = {}
    for name, e, sp in (("ref", ref, RefSamplingParams), ("port", eng, SamplingParams)):
        e.warmup()
        outs[name] = [list(e.generate(p, sp(max_tokens=6))) for p in prompts]
    assert outs["port"] == outs["ref"]
    got, want = eng.runner.prof.stats(), ref.runner.prof.stats()
    assert {s: v["calls"] for s, v in got.items()} == {s: v["calls"] for s, v in want.items()}
    assert eng.stats()["retraces"] == ref.stats()["retraces"] == 0
    assert got["decode"]["calls"] == eng.runner.launches["decode"]
