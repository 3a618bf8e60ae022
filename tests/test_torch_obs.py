"""The port's ``obs`` CLI, device-step profiler and Grafana rows against the
reference's tests, run on ``ray_tpu_torch``: mirrors of the waterfall,
retrace, ``profile_step_fn``, retrace-SLO and registry cases of
``tests/test_profiling_plane.py``, and of the ``obs`` cases of
``tests/test_slo_alerts.py``, ``tests/test_flight_recorder.py``,
``tests/test_core_pipeline.py`` and ``tests/test_llm_phases.py``.

Where the reference drives a ``jax.jit`` function whose cache grows with
each new shape, the mirrors drive the port's paged runner (``decode_step``
at new slot counts): eager PyTorch has no jit cache, and the runner's step
functions count the shapes they have run (``util.device_prof``)."""

import json
import os
import signal
import time
import urllib.request

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import events
from ray_tpu_torch.util import metrics as um
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util import waterfall as wfl
from ray_tpu_torch.util.device_prof import JitProfiler

# a tiny dense GPT for the runner and engine cases (head dim 16: the CPU's
# plain attention takes any)
TINY = dict(vocab_size=64, seq_len=64, d_model=32, n_layers=2, n_heads=2, dtype="float32")


@pytest.fixture
def fresh_waterfall():
    wfl.clear()
    yield
    wfl.clear()


@pytest.fixture
def recorder_on():
    was = events.enabled()
    events.set_enabled(True)
    yield
    events.set_enabled(was)


def _runner():
    from ray_tpu_torch.llm.model_runner import PagedModelRunner
    from ray_tpu_torch.models.gpt import GPTConfig, gpt_init

    cfg = GPTConfig(**TINY)
    params = gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    runner = PagedModelRunner(cfg, params, block_size=4)
    pools = [torch.zeros(cfg.n_layers, 16, cfg.n_heads, 4, cfg.head_dim) for _ in range(2)]
    return runner, pools


def _decode(runner, pools, slots: int):
    """One decode step at ``slots`` slots (all on trash block 0)."""
    z = np.zeros(slots, np.int64)
    return runner.decode_step(*pools, z, z, np.zeros((slots, 4), np.int32),
                              np.zeros(slots, np.float32), z, np.ones(slots, np.float32), z, z)


# ---------------------------------------------------------------------------
# tests/test_profiling_plane.py
# ---------------------------------------------------------------------------


class TestWaterfallCLI:
    def test_obs_waterfall_probe_reports_8_phases(self, fresh_waterfall, capsys):
        from ray_tpu_torch.obs import main as obs_main

        rc = obs_main(["waterfall", "--probe", "25", "--json"])
        out = capsys.readouterr().out
        assert rc == 0
        s = json.loads(out)
        assert s["folded"] >= 25
        assert len(s["phases"]) == 8
        legs = s["legs"]
        assert len(legs) == 8  # 7 hop legs + total
        for name, _i, _j in wfl.LEGS:
            assert legs[name]["count"] >= 25
            assert legs[name]["p50"] >= 0.0
            assert legs[name]["p99"] >= legs[name]["p50"] - 1e-9

    def test_top_row_dash_below_two_samples(self):
        from ray_tpu_torch.obs import waterfall_top_row

        row = waterfall_top_row({"legs": {"submit": {"count": 1}}})
        # every leg below 2 samples renders the dash, never a number
        assert row.count("—") == len(wfl.LEGS)
        row2 = waterfall_top_row({
            "legs": {
                name: {"count": 5, "p50": 1e-4, "p99": 2e-3}
                for name, _i, _j in wfl.LEGS
            }
        })
        assert "—" not in row2
        assert "submit=100us/2.0ms" in row2

    def test_render_waterfall_table(self):
        from ray_tpu_torch.obs import render_waterfall

        s = {
            "folded": 3, "incomplete": 1,
            "legs": {
                name: {"count": 3, "p50": 1e-4, "p95": 1e-3, "p99": 2e-3}
                for name, _i, _j in wfl.LEGS
            },
        }
        txt = render_waterfall(s)
        for name, _i, _j in wfl.LEGS:
            assert name in txt
        assert "3 folded" in txt


class TestRetraceDetector:
    def test_shape_varying_step_fires_once_per_new_shape(self, recorder_on):
        runner, pools = _runner()
        prof = runner.prof
        before = [e for e in events.snapshot()
                  if e["type"] == "llm.retrace" and e.get("site") == "decode"]

        def call(slots):
            n = prof.retraces
            _decode(runner, pools, slots)
            return prof.retraces > n

        assert call(4) is False      # warmup: sets the baseline
        assert call(4) is False      # seen shape: no retrace
        assert call(8) is True       # NEW shape after warmup: fires
        assert call(8) is False      # that shape is warm now
        assert call(16) is True      # each new shape fires exactly once
        st = prof.stats()["decode"]
        assert st["retraces"] == 2 and st["calls"] == 5 and st["cache_size"] == 3
        evs = [e for e in events.snapshot()
               if e["type"] == "llm.retrace" and e.get("site") == "decode"]
        assert len(evs) - len(before) == 2
        assert [e["cache_size"] for e in evs[len(before):]] == [2, 3]

    def test_plain_callable_never_fires(self):
        prof = JitProfiler()

        def plain():
            return None

        for _ in range(5):
            assert prof.note("plain", plain, 1e-4) is False
        assert prof.retraces == 0

    def test_runner_notes_every_step_site(self):
        """Each of the four step functions notes its calls, with the host
        time going into ``device_step_seconds{site}``."""
        runner, pools = _runner()

        def count(site):
            h = next(m for m in um._registry if m.name == "device_step_seconds")
            return h._snapshot()["data"].get(um._tag_key({"site": site}), [0])[-1]

        before = {s: count(s) for s in ("decode", "prefill", "verify", "fork")}
        _decode(runner, pools, 2)
        runner.prefill_chunk(*pools, np.arange(8), 0, 5, np.zeros(4, np.int32))
        z = np.zeros(2, np.int64)
        runner.verify_step(*pools, np.zeros((2, 3), np.int64), z, np.zeros((2, 4), np.int32),
                           np.zeros(2, np.float32), z, np.ones(2, np.float32), z, z)
        runner.fork_blocks(*pools, z, z)
        stats = runner.prof.stats()
        for site in ("decode", "prefill", "verify", "fork"):
            assert stats[site] == {"cache_size": 1, "calls": 1, "retraces": 0}
            assert count(site) - before[site] == 1
        assert runner.launches == {"decode": 1, "prefill": 1, "fork": 1, "verify": 1}

    def test_engine_steady_state_zero_retraces(self):
        from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine
        from ray_tpu_torch.llm.scheduler import SamplingParams
        from ray_tpu_torch.models.gpt import GPTConfig, gpt_init

        cfg = GPTConfig(**TINY)
        params = gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
        eng = LLMEngine(
            cfg, params,
            EngineConfig(max_slots=2, num_blocks=16, block_size=8,
                         max_blocks_per_seq=8, spec_k=2),
            device="cpu",
        )
        eng.warmup()
        for prompt in ([1, 2, 3], [4, 5, 6, 7], [1, 2, 3]):
            eng.generate(prompt, SamplingParams(max_tokens=6))
        assert eng.runner.prof.retraces == 0, eng.runner.prof.stats()
        assert eng.stats()["retraces"] == 0

    def test_profiled_train_step_counts_and_detects(self):
        from ray_tpu_torch.parallel.train_step import build_train_step, profile_step_fn

        class W(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.w = torch.nn.Parameter(torch.ones(8))

        init_fn, raw_step = build_train_step(
            lambda p, b: ((p.w * b) ** 2).mean(), lambda ps: torch.optim.SGD(ps, lr=0.1)
        )
        step = profile_step_fn(raw_step)
        assert step.__wrapped__ is raw_step
        state = init_fn(W(), device="cpu")
        batch = torch.ones(8, 8)
        for _ in range(3):
            state, _loss = step(state, batch)
        st = step.profiler.stats()["train_step"]
        assert st["calls"] == 3
        assert st["retraces"] == 0


class TestRetraceSLO:
    def test_rule_golden_fires_on_any_retrace_window(self):
        from ray_tpu_torch.util import slo

        rule = next(
            r for r in slo.default_rules() if r.name == "retrace-storm"
        )
        assert rule.metric == "device_retraces"
        now = 1000.0
        merged = {
            "device_retraces": {
                "kind": "counter",
                "series": {
                    '{"site":"decode"}': [(now - 90, 0.0), (now - 30, 3.0)]
                },
            }
        }
        res = slo.evaluate_rule(rule, merged, now=now)
        assert res["breached"], res
        # zero retraces = no evidence, never a breach
        quiet = {
            "device_retraces": {
                "kind": "counter",
                "series": {'{"site":"decode"}': [(now - 90, 3.0), (now - 30, 3.0)]},
            }
        }
        assert not slo.evaluate_rule(rule, quiet, now=now)["breached"]
        assert not slo.evaluate_rule(rule, {}, now=now)["breached"]

    def test_retrace_trips_live_alerts_engine(self, monkeypatch):
        """A step site meeting new shapes after warmup → device_retraces
        increments → series ship → the retrace-storm rule FIRES through the
        same alerts surface ``obs alerts --eval-once`` reads."""
        monkeypatch.setenv("RAY_TPU_ALERTS_INTERVAL_S", "3600")  # manual ticks
        um._reset_series_for_tests()
        ray_tpu_torch.init(num_cpus=1, num_tpus=0)
        try:
            from ray_tpu_torch._private.runtime import get_ctx

            ctx = get_ctx()
            runner, pools = _runner()
            _decode(runner, pools, 2)  # warmup/baseline
            um.sample_series_now()
            um.flush()
            alerts = ctx.call("alerts", eval_now=True)
            by_rule = {a["rule"]: a for a in alerts}
            assert by_rule["retrace-storm"]["status"] != "FIRING"
            for slots in (3, 4, 5):  # the storm
                _decode(runner, pools, slots)
            assert runner.prof.stats()["decode"]["retraces"] == 3
            um.sample_series_now()
            um.flush()
            alerts = ctx.call("alerts", eval_now=True)
            by_rule = {a["rule"]: a for a in alerts}
            assert by_rule["retrace-storm"]["status"] == "FIRING", by_rule["retrace-storm"]
        finally:
            ray_tpu_torch.shutdown()
            um._reset_series_for_tests()


class TestRegistries:
    def test_grafana_profiling_row_tracks_registries(self):
        from ray_tpu_torch.util import device_prof
        from ray_tpu_torch.util.grafana import _profiling_panels

        exprs = " ".join(expr for _t, expr, _u, _d in _profiling_panels())
        for name in wfl.METRIC_NAMES[:1] + device_prof.METRIC_NAMES:
            assert name in exprs, f"profiling row lost {name}"
        for name in (
            "llm_hbm_params_bytes", "llm_hbm_kv_seq_bytes",
            "llm_hbm_kv_cache_bytes", "llm_hbm_kv_free_bytes",
            "llm_hbm_drafter_bytes", "llm_hbm_kv_pool_bytes",
        ):
            assert name in exprs, f"profiling row lost {name}"

    def test_metric_names_registered(self):
        from ray_tpu_torch.llm import engine as eng_mod
        from ray_tpu_torch.util import device_prof

        assert "core_task_phase_s" in wfl.METRIC_NAMES
        assert "device_retraces" in device_prof.METRIC_NAMES
        for n in (
            "llm_hbm_params_bytes", "llm_hbm_kv_pool_bytes",
            "llm_hbm_kv_seq_bytes", "llm_hbm_kv_cache_bytes",
            "llm_hbm_kv_free_bytes", "llm_hbm_drafter_bytes",
        ):
            assert n in eng_mod.METRIC_NAMES

    def test_grafana_rows_chart_only_series_the_port_exports(self):
        """Every series the static rows chart is one the port exports: a
        ``Counter``/``Gauge``/``Histogram`` (or ``safe_counter``) built under that name, or a
        ``METRIC_NAMES`` registry entry (raylint's RL012 in small)."""
        import ast
        from pathlib import Path

        from ray_tpu_torch.util.grafana import _LLM_NAMES

        exported = set()
        for path in (Path(__file__).resolve().parents[1] / "ray_tpu_torch").rglob("*.py"):
            for node in ast.walk(ast.parse(path.read_text())):
                if (isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", None))
                        in ("Counter", "Gauge", "Histogram", "safe_counter") and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    exported.add(node.args[0].value)
                elif (isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "METRIC_NAMES"
                                                           for t in node.targets)):
                    exported.update(ast.literal_eval(node.value))
        suffixed = {n for n in _LLM_NAMES if n.endswith(("_bucket", "_sum", "_count"))}
        assert _LLM_NAMES - suffixed <= exported, sorted(_LLM_NAMES - suffixed - exported)
        assert {"llm_generated_tokens", "core_tasks", "device_step_seconds"} <= _LLM_NAMES

    def test_dashboard_charts_metrics_of_worker_processes(self):
        """On a cluster, a metric registered only in a worker gets a panel."""
        from ray_tpu_torch.util.grafana import dashboard_json

        ray_tpu_torch.init(num_cpus=1, num_tpus=0)
        try:
            @ray_tpu_torch.remote
            def register():
                from ray_tpu_torch.util import metrics as wm

                wm.Counter("t_worker_only_total", "worker-side").inc()
                wm.Histogram("t_worker_only_s", "worker-side").observe(0.1)
                wm.flush()
                return True

            assert ray_tpu_torch.get(register.remote(), timeout=60)
            exprs = [p["targets"][0]["expr"] for p in dashboard_json()["panels"]]
            assert "ray_tpu_t_worker_only_total" in exprs
            assert "histogram_quantile(0.99, rate(ray_tpu_t_worker_only_s_bucket[5m]))" in exprs
        finally:
            ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# tests/test_slo_alerts.py (obs surfaces, and the e2e that renders alerts)
# ---------------------------------------------------------------------------


class TestObsSurfaces:
    def test_series_rate_text_dash_below_two_samples(self):
        from ray_tpu_torch.obs import _series_rate_text

        assert _series_rate_text({}, "x") == "—"
        one = {"x": {"kind": "counter", "series": {"": [(0, 5.0)]}}}
        assert _series_rate_text(one, "x") == "—"
        two = {"x": {"kind": "counter", "series": {"": [(0, 5.0), (2, 9.0)]}}}
        assert _series_rate_text(two, "x") == "2.0"

    def test_render_series_and_alerts_text(self):
        from ray_tpu_torch.obs import render_alerts, render_series

        ent = {"kind": "counter", "boundaries": None,
               "series": {"": [(0, 0.0), (1, 10.0), (2, 30.0)]}}
        text = render_series("c", ent, 60.0)
        assert "last=20.0/s" in text
        text = render_alerts([
            {"rule": "ttft-p99", "status": "FIRING", "value": 20.0,
             "since": time.time() - 5,
             "detail": {"fast_burn": 20.0, "slow_burn": 8.0},
             "labels": {"serve": "upscale"}},
        ])
        assert "FIRING" in text and "serve=upscale" in text


class TestAlertsE2E:
    def test_fire_and_resolve_on_live_head(self, monkeypatch):
        monkeypatch.setenv("RAY_TPU_SLO_FAST_WINDOW_S", "2.0")
        monkeypatch.setenv("RAY_TPU_SLO_SLOW_WINDOW_S", "4.0")
        monkeypatch.setenv("RAY_TPU_SLO_RESOLVE_AFTER_S", "0.5")
        monkeypatch.setenv("RAY_TPU_SLO_TTFT_THRESHOLD_S", "0.5")
        monkeypatch.setenv("RAY_TPU_ALERTS_INTERVAL_S", "3600")  # manual ticks
        um._reset_series_for_tests()
        ray_tpu_torch.init(num_cpus=2, num_tpus=0)
        try:
            from ray_tpu_torch._private.runtime import get_ctx
            from ray_tpu_torch.obs import render_alerts

            ctx = get_ctx()
            h = um.Histogram("llm_time_to_first_token_s", "ttft (e2e synthetic)")
            h.observe(0.01)
            um.sample_series_now()
            um.flush()
            for _ in range(50):
                h.observe(5.0)
            um.sample_series_now()
            um.flush()
            alerts = ctx.call("alerts", eval_now=True)
            by_rule = {a["rule"]: a for a in alerts}
            assert by_rule["ttft-p99"]["status"] == "FIRING"
            assert "FIRING" in render_alerts(alerts)
            evs = events.collect_cluster_events()
            fired = [e for e in evs if e.get("type") == "alert.fire"]
            assert any(e.get("rule") == "ttft-p99" for e in fired)
            deadline = time.time() + 20
            status = None
            while time.time() < deadline:
                time.sleep(0.5)
                um.sample_series_now()
                um.flush()
                alerts = ctx.call("alerts", eval_now=True)
                status = {a["rule"]: a["status"] for a in alerts}["ttft-p99"]
                if status == "RESOLVED":
                    break
            assert status == "RESOLVED"
            evs = events.collect_cluster_events()
            assert any(
                e.get("type") == "alert.resolve" and e.get("rule") == "ttft-p99"
                for e in evs
            )
        finally:
            ray_tpu_torch.shutdown()
            um._reset_series_for_tests()


# ---------------------------------------------------------------------------
# tests/test_flight_recorder.py (the obs cases)
# ---------------------------------------------------------------------------


def test_worker_killed_mid_stream_leaves_crash_flush(tmp_path, monkeypatch):
    """A worker streaming tokens is SIGTERM'd mid-stream; its flight-recorder
    ring survives on disk, and the offline trace renderer reads it back
    with the request lane."""
    monkeypatch.setenv("RAY_TPU_EVENTS_DIR", str(tmp_path))
    ray_tpu_torch.init(num_cpus=2, num_tpus=0)
    try:

        @ray_tpu_torch.remote(num_returns="streaming")
        def stream():
            from ray_tpu_torch._private import events as ev
            from ray_tpu_torch.util import tracing as tr

            ev.record("stream.begin", request_id=tr.current_request_id(),
                      pid_hint=os.getpid())
            yield os.getpid()
            for i in range(1000):
                ev.record("stream.tick", request_id=tr.current_request_id(), i=i)
                time.sleep(0.05)
                yield i

        with tracing.trace_context() as rid:
            g = stream.remote()
        it = iter(g)
        victim = ray_tpu_torch.get(next(it), timeout=30)
        ray_tpu_torch.get(next(it), timeout=30)  # producer is inside the loop
        os.kill(victim, signal.SIGTERM)

        deadline = time.time() + 30
        flushed = None
        while time.time() < deadline and flushed is None:
            for f in os.listdir(tmp_path):
                if f == f"events-{victim}.jsonl":
                    flushed = tmp_path / f
            time.sleep(0.2)
        assert flushed is not None, os.listdir(tmp_path)
        lines = [json.loads(x) for x in open(flushed)]
        assert lines[0]["reason"] == "sigterm"
        types = {x["type"] for x in lines[1:]}
        assert "stream.begin" in types and "stream.tick" in types
        assert any(x.get("request_id") == rid for x in lines[1:])

        # postmortem rendering with NO cluster involvement
        from ray_tpu_torch.obs import offline_trace

        out = str(tmp_path / "trace.json")
        entries = offline_trace(str(tmp_path), out)
        lanes = {e["tid"] for e in entries if e.get("pid") == "requests"}
        assert f"req:{rid}" in lanes
        assert json.load(open(out))  # valid chrome-trace JSON
    finally:
        ray_tpu_torch.shutdown()


def test_obs_req_from_served_llm_request(tmp_path):
    """HTTP request → proxy → replica → speculative engine: everything
    correlates under the proxy-minted request_id that comes back in the
    x-request-id response header, and ``obs req`` renders TTFT plus
    per-window accepted-token counts from it."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import EngineConfig
    from ray_tpu_torch.models.gptj import GPTJConfig
    from ray_tpu_torch.obs import render_request, request_events
    from ray_tpu_torch.serve.llm import build_llm_app

    tiny = GPTJConfig(vocab_size=128, seq_len=64, d_model=32, n_layers=2, n_heads=2,
                      rotary_dim=8, dtype="float32")
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    try:
        app = build_llm_app(
            model="gptj", model_cfg=tiny,
            engine_config=EngineConfig(max_slots=2, num_blocks=32, block_size=4,
                                       max_blocks_per_seq=12, prefill_chunk=8, spec_k=3),
            device="cpu",
        )
        serve.run(app, name="llm", http=True, http_port=0)
        controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
        port = ray_tpu_torch.get(controller.get_proxy_port.remote(), timeout=30)

        # periodic prompt: the n-gram drafter finds a match immediately,
        # so at least the first decode window goes through verification
        prompt = [5, 6, 7] * 4
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/llm", data=json.dumps(prompt).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=300) as resp:
            rid = resp.headers.get("x-request-id")
            resp.read()  # drain the stream to completion
        assert rid, "proxy did not return an x-request-id header"

        deadline = time.time() + 30
        have = set()
        want = {
            "proxy.request", "replica.request", "llm.submit", "llm.admit",
            "llm.prefill_chunk", "llm.first_token", "llm.verify", "llm.finish",
        }
        while time.time() < deadline and not want <= have:
            evs = request_events(rid)
            have = {e["type"] for e in evs}
            time.sleep(0.5)
        assert want <= have, f"missing event types: {want - have}"

        ttfts = [e for e in evs if e["type"] == "llm.first_token"]
        assert ttfts and ttfts[0]["ttft_s"] > 0
        verifies = [e for e in evs if e["type"] == "llm.verify"]
        assert verifies and all(0 <= e["accepted"] <= e["proposed"] for e in verifies)
        order = [e["type"] for e in evs]
        assert order.index("proxy.request") < order.index("llm.admit")
        assert order.index("llm.admit") < order.index("llm.finish")

        text = render_request(rid, evs)
        assert rid in text and "ttft=" in text and "spec:" in text
        assert "finished: stop" in text or "finished: length" in text

        # chrome trace: one lane per request in the "requests" group
        out = str(tmp_path / "fr_trace.json")
        entries = tracing.export_chrome_trace(out)
        lanes = {e["tid"] for e in entries if e.get("pid") == "requests"}
        assert f"req:{rid}" in lanes

        # `x-request-id` passthrough: a caller-supplied id is honored
        req2 = urllib.request.Request(
            f"http://127.0.0.1:{port}/llm", data=json.dumps(prompt).encode(),
            headers={"Content-Type": "application/json", "x-request-id": "caller-chain-0042"},
        )
        with urllib.request.urlopen(req2, timeout=300) as resp:
            assert resp.headers.get("x-request-id") == "caller-chain-0042"
            resp.read()
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# tests/test_core_pipeline.py, tests/test_llm_phases.py (the obs cases)
# ---------------------------------------------------------------------------


def test_core_batch_top_row_contract():
    """obs top's core-batch row: absent without the metrics, and a
    histogram below 2 samples renders the `—` placeholder."""
    from ray_tpu_torch.obs import core_batch_top_row

    assert core_batch_top_row({}, {}) is None
    metrics = {
        "core_submit_batch_size": {"": 1.0},
        "core_submit_credits": {"": 4096.0},
    }
    pcts = {"core_submit_batch_size": {"": {"count": 1, "p50": 1.0, "p99": 1.0}}}
    row = core_batch_top_row(metrics, pcts)
    assert row is not None
    assert "submit=—" in row and "reply=—" in row
    assert "credits=4096" in row
    pcts = {
        "core_submit_batch_size": {"": {"count": 9, "p50": 8.0, "p99": 32.0}},
        "core_reply_batch_size": {"": {"count": 4, "p50": 2.0, "p99": 4.0}},
    }
    row = core_batch_top_row(metrics, pcts)
    assert "submit=8/32" in row and "reply=2/4" in row


def test_hist_pcts_row_dash_below_two_samples():
    from ray_tpu_torch.obs import hist_pcts_row

    assert hist_pcts_row({"count": 0}) == "—"
    assert hist_pcts_row({"count": 1, "p50": 1.0, "p95": 1.0, "p99": 1.0}) == "—"
    row = hist_pcts_row({"count": 2, "p50": 0.5, "p95": 0.9, "p99": 0.99})
    assert row != "—" and "p50=500.0ms" in row


def test_attribution_table_dash_below_two_samples():
    from ray_tpu_torch.obs import attribute_rows, attribution_report, render_attribution

    def ledger(rid, t0):
        return {
            "type": "llm.phase.ledger", "request_id": rid, "engine_req": 1,
            "reason": "complete", "t_submit": t0, "t_finish": t0 + 1.0,
            "resumed": 0,
            "phases": {"queue": 0.1, "prefill": 0.4, "decode": 0.5},
        }

    one = attribution_report(attribute_rows([ledger("r1", 100.0)]))
    txt = render_attribution(one)
    assert "—" in txt  # N=1 rows refuse to print fake percentiles
    two = attribution_report(attribute_rows([ledger("r1", 100.0), ledger("r2", 200.0)]))
    txt2 = render_attribution(two)
    assert "decode" in txt2 and "p99 budget" in txt2
    assert two["within_eps_frac"] == 1.0


def test_charge_within_stamp_budget():
    """≤2µs per phase stamp: charge() is two float ops and two list stores
    — the generous bar catches a lock or an allocation creeping in."""
    from ray_tpu_torch.obs import measure_overhead

    res = measure_overhead(n=30_000)
    assert res["phase_charge_ns"] <= 2_000.0, res
