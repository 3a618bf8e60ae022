"""The port's OTLP-JSON export against the reference's: a mirror of
``tests/test_otlp.py`` run on ``ray_tpu_torch`` (its ``slow`` mark kept),
and parity cases — the same seeded spans, events and series through
``ray_tpu.util.otlp`` and ``ray_tpu_torch.util.otlp`` give the same
documents apart from the two names the port's module doc lists (the scope
name and ``service.name``)."""

import json

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.util import otlp as ref_otlp
from ray_tpu_torch.util import metrics as um
from ray_tpu_torch.util import otlp


def _roundtrip(doc):
    return json.loads(json.dumps(doc))


class TestOtlpMapping:
    def test_span_fields_and_trace_id_widening(self):
        rid = "abcd1234abcd1234"
        doc = _roundtrip(otlp.export(spans=[{
            "name": "llm_engine_step", "ph": "X", "ts": 2_000_000.0,
            "dur": 500_000.0, "pid": "proc-42", "tid": "thread-1",
            "args": {"request_id": rid, "step": 3},
        }]))
        rs = doc["resourceSpans"]
        assert len(rs) == 1
        res_attrs = {
            a["key"]: a["value"] for a in rs[0]["resource"]["attributes"]
        }
        assert res_attrs["service.name"] == {"stringValue": "ray_tpu_torch"}
        span = rs[0]["scopeSpans"][0]["spans"][0]
        assert span["name"] == "llm_engine_step"
        assert len(span["traceId"]) == 32 and span["traceId"].endswith(rid)
        assert len(span["spanId"]) == 16
        assert span["startTimeUnixNano"] == str(2_000_000 * 1000)
        assert span["endTimeUnixNano"] == str(2_500_000 * 1000)
        attrs = {a["key"]: a["value"] for a in span["attributes"]}
        assert attrs["step"] == {"intValue": "3"}

    def test_event_log_records(self):
        doc = _roundtrip(otlp.export(events=[
            {"ts": 1.5, "type": "llm.first_token", "pid": 7, "node": "ab12",
             "request_id": "abcd1234abcd1234", "ttft_s": 0.12},
            {"ts": 2.0, "type": "crash.sigterm", "pid": 7, "node": "ab12"},
            {"ts": 2.5, "type": "alert.fire", "pid": 1, "rule": "ttft-p99"},
        ]))
        logs = doc["resourceLogs"]
        all_recs = [r for rl in logs for r in rl["scopeLogs"][0]["logRecords"]]
        assert len(all_recs) == 3
        first = next(
            r for r in all_recs if r["body"]["stringValue"] == "llm.first_token"
        )
        assert first["timeUnixNano"] == "1500000000"
        assert first["severityText"] == "INFO"
        assert len(first["traceId"]) == 32
        crash = next(
            r for r in all_recs if r["body"]["stringValue"] == "crash.sigterm"
        )
        assert crash["severityText"] == "ERROR"
        fire = next(
            r for r in all_recs if r["body"]["stringValue"] == "alert.fire"
        )
        assert fire["severityText"] == "WARN"
        # node rides the resource, not each record
        nodes = {
            a["value"].get("stringValue")
            for rl in logs for a in rl["resource"]["attributes"]
            if a["key"] == "node.id"
        }
        assert "ab12" in nodes

    def test_metric_kinds_map_to_sum_gauge_histogram(self):
        series = {
            "llm_generated_tokens": {"kind": "counter", "boundaries": None,
                                     "series": {"": [(1.0, 5.0), (2.0, 9.0)]}},
            "llm_kv_block_utilization": {"kind": "gauge", "boundaries": None,
                                         "series": {"": [(1.0, 0.5)]}},
            "llm_time_to_first_token_s": {
                "kind": "histogram", "boundaries": [0.1, 1.0],
                "series": {"": [(1.0, [1, 2, 3, 4.5, 6])]},
            },
        }
        doc = _roundtrip(otlp.export(series=series))
        metrics = doc["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]
        assert len(metrics) >= 3
        by_name = {m["name"]: m for m in metrics}
        ctr = by_name["ray_tpu_llm_generated_tokens"]["sum"]
        assert ctr["isMonotonic"] is True
        assert ctr["aggregationTemporality"] == 2
        assert ctr["dataPoints"][0]["asDouble"] == 5.0
        assert ctr["dataPoints"][0]["timeUnixNano"] == "1000000000"
        gauge = by_name["ray_tpu_llm_kv_block_utilization"]["gauge"]
        assert gauge["dataPoints"][0]["asDouble"] == 0.5
        hist = by_name["ray_tpu_llm_time_to_first_token_s"]["histogram"]
        dp = hist["dataPoints"][0]
        assert dp["bucketCounts"] == ["1", "2", "3"]
        assert dp["explicitBounds"] == [0.1, 1.0]
        assert dp["count"] == "6"
        assert dp["sum"] == 4.5

    def test_tagged_series_become_datapoint_attributes(self):
        tag = json.dumps({"status": "5xx"})
        doc = _roundtrip(otlp.export(series={
            "serve_requests": {"kind": "counter", "boundaries": None,
                               "series": {tag: [(1.0, 3.0)]}},
        }))
        dp = doc["resourceMetrics"][0]["scopeMetrics"][0]["metrics"][0][
            "sum"]["dataPoints"][0]
        attrs = {a["key"]: a["value"] for a in dp["attributes"]}
        assert attrs["status"] == {"stringValue": "5xx"}

    def test_http_sink_is_best_effort(self, monkeypatch):
        # an unreachable collector reports, never raises
        monkeypatch.setenv("RAY_TPU_OTLP_ENDPOINT", "http://127.0.0.1:9")
        doc = otlp.export(events=[{"ts": 1.0, "type": "x", "pid": 1}])
        out = otlp.post(doc, timeout=0.5)
        assert "/v1/logs" in out
        assert str(out["/v1/logs"]).startswith("error:")


class TestObsExportCli:
    def test_offline_export_from_crash_files(self, tmp_path):
        from ray_tpu_torch.obs import main as obs_main

        d = tmp_path / "events"
        d.mkdir()
        with open(d / "events-1.jsonl", "w") as f:
            f.write(json.dumps({"_flight_recorder": 1, "pid": 1,
                                "node": "ab", "reason": "sigterm"}) + "\n")
            f.write(json.dumps({"seq": 0, "ts": 1.0, "type": "crash.sigterm",
                                "pid": 1}) + "\n")
        out = tmp_path / "otlp.json"
        rc = obs_main([
            "export", "--otlp", "--events-dir", str(d), "-o", str(out),
        ])
        assert rc == 0
        doc = json.loads(out.read_text())
        recs = doc["resourceLogs"][0]["scopeLogs"][0]["logRecords"]
        assert recs[0]["body"]["stringValue"] == "crash.sigterm"
        assert doc["resourceSpans"] == [] and doc["resourceMetrics"] == []

    # slow in the reference (it boots a cluster for one export); the mark is
    # mirrored, and phase 31 of chip_smoke.py exports a live cluster
    @pytest.mark.slow
    def test_live_export_has_spans_events_and_series(self, tmp_path):
        """A live cluster with engine-style metrics, spans, and events
        exports ≥3 metric series plus spans and events, all re-parsed under
        OTLP field names."""
        um._reset_series_for_tests()
        ray_tpu_torch.init(num_cpus=2, num_tpus=0)
        try:
            from ray_tpu_torch.util import tracing

            c = um.Counter("llm_generated_tokens", "tokens")
            g = um.Gauge("llm_kv_block_utilization", "kv")
            h = um.Histogram("llm_time_to_first_token_s", "ttft")
            with tracing.trace_context("feedbeef12345678"):
                with tracing.span("llm_engine_step", step=1):
                    c.inc(10)
                    g.set(0.4)
                    h.observe(0.05)
            from ray_tpu_torch._private import events as fr

            fr.record("llm.first_token", request_id="feedbeef12345678",
                      ttft_s=0.05)
            um.sample_series_now()
            um.flush()
            um.sample_series_now()
            um.flush()
            out = tmp_path / "otlp.json"
            doc, counts = otlp.export_cluster(path=str(out))
            assert counts["spans"] >= 1
            assert counts["events"] >= 1
            assert counts["metrics"] >= 3
            parsed = json.loads(out.read_text())
            span_names = {
                s["name"]
                for r in parsed["resourceSpans"]
                for ss in r["scopeSpans"] for s in ss["spans"]
            }
            assert "llm_engine_step" in span_names
            metric_names = {
                m["name"]
                for r in parsed["resourceMetrics"]
                for sm in r["scopeMetrics"] for m in sm["metrics"]
            }
            assert {"ray_tpu_llm_generated_tokens",
                    "ray_tpu_llm_kv_block_utilization",
                    "ray_tpu_llm_time_to_first_token_s"} <= metric_names
            # the span and the event share the request's 32-hex traceId
            tid = next(
                s["traceId"]
                for r in parsed["resourceSpans"]
                for ss in r["scopeSpans"] for s in ss["spans"]
                if s["name"] == "llm_engine_step"
            )
            log_tids = {
                rec.get("traceId")
                for r in parsed["resourceLogs"]
                for sl in r["scopeLogs"] for rec in sl["logRecords"]
            }
            assert tid in log_tids
        finally:
            ray_tpu_torch.shutdown()
            um._reset_series_for_tests()


# ---------------------------------------------------------------------------
# parity: the same inputs through both packages
# ---------------------------------------------------------------------------


def _seeded_spans(rng):
    names = ["llm_engine_step", "replica.request", "proxy.request", "task::f"]
    out = []
    for i in range(24):
        args = {"step": int(rng.integers(0, 100)), "ok": bool(rng.integers(0, 2)),
                "ratio": float(rng.random()), "tags": {"k": int(rng.integers(0, 9))}}
        if rng.random() < 0.6:
            args["request_id"] = "".join(rng.choice(list("0123456789abcdef"), 16))
        out.append({
            "name": names[i % len(names)], "ph": "X" if i % 7 else "i",
            "ts": float(rng.integers(1, 10**9)) + 0.25, "dur": float(rng.integers(0, 10**6)),
            "pid": f"proc-{int(rng.integers(0, 3))}", "tid": f"thread-{int(rng.integers(0, 2))}",
            "args": args,
        })
    return out


def _seeded_events(rng):
    types = ["llm.first_token", "crash.sigterm", "alert.fire", "ci.fail", "llm.finish",
             "llm.retrace"]
    out = []
    for i in range(30):
        e = {"ts": float(rng.random() * 1e6), "seq": i, "type": types[i % len(types)],
             "pid": int(rng.integers(1, 4)), "n": int(rng.integers(0, 50)),
             "dur_s": float(rng.random()), "note": None}
        if rng.random() < 0.5:
            e["node"] = f"node{int(rng.integers(0, 2))}"
        if rng.random() < 0.5:
            e["request_id"] = "".join(rng.choice(list("0123456789abcdef"), 16))
        out.append(e)
    return out


def _seeded_series(rng):
    def points(kind, n):
        t = np.cumsum(rng.random(n)) + 1000.0
        if kind == "histogram":
            return [(float(ts), [int(x) for x in rng.integers(0, 9, 3)] + [float(rng.random()), 9])
                    for ts in t]
        return [(float(ts), float(v)) for ts, v in zip(t, np.cumsum(rng.random(n)))]

    return {
        "llm_generated_tokens": {"kind": "counter", "boundaries": None,
                                 "series": {"": points("counter", 5)}},
        "serve_requests": {"kind": "counter", "boundaries": None,
                           "series": {json.dumps({"status": s}): points("counter", 3)
                                      for s in ("2xx", "5xx")}},
        "llm_kv_block_utilization": {"kind": "gauge", "boundaries": None,
                                     "series": {"": points("gauge", 4)}},
        "device_step_seconds": {"kind": "histogram", "boundaries": [0.001, 0.01],
                                "series": {json.dumps({"site": s}): points("histogram", 3)
                                           for s in ("decode", "prefill")}},
    }


def _port_names_to_reference(doc):
    """The port's document with the reference's two names put back."""
    text = json.dumps(doc)
    text = text.replace('"name": "ray_tpu_torch.obs"', '"name": "ray_tpu.obs"')
    text = text.replace('"key": "service.name", "value": {"stringValue": "ray_tpu_torch"}',
                        '"key": "service.name", "value": {"stringValue": "ray_tpu"}')
    return json.loads(text)


def test_port_names_differ_from_the_reference_only_where_documented():
    assert otlp._SCOPE == {"name": "ray_tpu_torch.obs", "version": "1"}
    assert ref_otlp._SCOPE == {"name": "ray_tpu.obs", "version": "1"}
    assert otlp._resource(1, "n") != ref_otlp._resource(1, "n")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_documents_equal_the_references(seed):
    spans = _seeded_spans(np.random.default_rng(seed))
    events = _seeded_events(np.random.default_rng(seed + 100))
    series = _seeded_series(np.random.default_rng(seed + 200))
    help_text = {"llm_generated_tokens": "tokens", "device_step_seconds": "step time"}
    assert _port_names_to_reference(otlp.spans_to_otlp(spans)) == ref_otlp.spans_to_otlp(spans)
    assert _port_names_to_reference(otlp.events_to_otlp(events)) == ref_otlp.events_to_otlp(events)
    assert (_port_names_to_reference(otlp.series_to_otlp(series, help_text))
            == ref_otlp.series_to_otlp(series, help_text))
    doc = otlp.export(spans=spans, events=events, series=series, help_text=help_text)
    ref = ref_otlp.export(spans=spans, events=events, series=series, help_text=help_text)
    assert _port_names_to_reference(doc) == ref
