"""The port's process-local observability modules against the reference's:
``ray_tpu_torch.util.metrics`` / ``tracing`` / ``phases`` and
``ray_tpu_torch._private.events`` vs their ``ray_tpu`` counterparts.

* the same sequence of counter, gauge and histogram updates gives the same
  ``collect()`` values and the same Prometheus text (the reference's
  ``collect()`` merges the snapshots processes publish to its head's KV; a
  stand-in KV in this process lets it run its own code over one process);
* events recorded from many threads come back with nothing lost,
  duplicated or reordered, and the drop count is exact on overflow;
* the hot paths (``events.record``/``emit``, the metric updates,
  ``tracing.span``, ``phases.new_ledger``/``charge``) reach no lock through
  the whole call graph — checked on the port's sources with the repo's
  lint index, as ``tests/test_obs_hotpath.py`` checks the reference's;
* spans carry their attributes and request id, an unsampled context
  records nothing, and sampling decisions, lanes and phase folds equal the
  reference's.
"""

import ast
import os
import pickle
import threading
import uuid

import pytest

from ray_tpu._private import events as ref_events
from ray_tpu._private import runtime as ref_runtime
from ray_tpu.exceptions import OverloadedError as RefOverloadedError
from ray_tpu.util import metrics as ref_metrics
from ray_tpu.util import phases as ref_phases
from ray_tpu.util import tracing as ref_tracing
from ray_tpu_torch._private import events
from ray_tpu_torch.exceptions import OverloadedError, RayTaskError
from ray_tpu_torch.util import metrics, phases, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _KVContext:
    """Stand-in for the reference runtime's context: the KV calls its
    metrics ``flush``/``collect`` make, served from a dict in this
    process."""

    def __init__(self):
        self.kv = {}

    def call(self, method, **kw):
        if method == "kv_put":
            self.kv[kw["key"]] = kw["value"]
        elif method == "kv_keys":
            return [k for k in self.kv if k.startswith(kw["prefix"])]
        elif method == "kv_get":
            return self.kv.get(kw["key"])
        return None


@pytest.fixture
def ref_collect(monkeypatch):
    """The reference's collect/prometheus_text over this process alone."""
    monkeypatch.setenv("RAY_TPU_METRICS_SERIES", "0")  # no series shipping
    prev = ref_runtime._ctx
    ref_runtime.set_ctx(_KVContext())
    try:
        yield
    finally:
        ref_runtime.set_ctx(prev)


def _updates(mod, tag: str, scenario: str):
    """One scenario's metric updates through module ``mod``; returns the
    metric names it created."""
    c = mod.Counter(f"{tag}_requests", "requests by route", tag_keys=("route", "code"))
    g = mod.Gauge(f"{tag}_depth", 'queue "depth"\nnow', tag_keys=("queue",))
    h = mod.Histogram(f"{tag}_latency_s", "latency", tag_keys=("route",))
    hb = mod.Histogram(f"{tag}_phase_s", "phase", boundaries=(1e-4, 1e-3, 0.01, 0.5, 2.0))
    if scenario == "untagged":
        c.inc()
        c.inc(2.5)
        g.set(7)
        g.set(3.25)
        for v in (0.001, 0.02, 0.3, 4.0, 40.0):
            h.observe(v)
            hb.observe(v)
    elif scenario == "tagged":
        for i in range(5):
            c.inc(i, tags={"route": "/v1/gen", "code": str(200 + i % 2)})
        c.set_default_tags({"route": "/health"}).inc(tags={"code": "200"})
        g.set(1, tags={"queue": 'we"ird\\name'})
        g.set(2, tags={"queue": "b"})
        g.set(5, tags={"queue": "b"})
        for v in (0.004, 0.005, 0.0051, 0.25, 1.0, 2.5, 11.0):
            h.observe(v, tags={"route": "a"})
        h.observe(0.1, tags={"route": "b"})
        hb.record(1e-4)
        hb.record(0.7)
    elif scenario == "threads":
        def work(k):
            for i in range(300):
                c.inc(tags={"route": f"r{k % 2}", "code": "200"})
                h.observe(i * 1e-3, tags={"route": f"r{k % 2}"})
                hb.observe(i * 1e-5)
            g.set(k, tags={"queue": "last"})

        threads = [threading.Thread(target=work, args=(k,)) for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        g.set(99, tags={"queue": "last"})
    return [c.name, g.name, h.name, hb.name]


def _families(text: str, names) -> list:
    keep = []
    for line in text.splitlines():
        body = line.split(" ", 2)[2] if line.startswith("# ") else line
        metric = body.split("{")[0].split(" ")[0]
        if any(metric in (f"ray_tpu_{n}", f"ray_tpu_{n}_bucket", f"ray_tpu_{n}_sum",
                          f"ray_tpu_{n}_count") for n in names):
            keep.append(line)
    return keep


@pytest.mark.parametrize("scenario", ["untagged", "tagged", "threads"])
def test_metrics_collect_and_prometheus_text_match_the_reference(ref_collect, scenario):
    tag = f"parity_{scenario}_{uuid.uuid4().hex[:8]}"
    names = _updates(metrics, tag, scenario)
    assert _updates(ref_metrics, tag, scenario) == names
    got, want = metrics.collect(), ref_metrics.collect()
    for section in ("kinds", "metrics", "boundaries", "help"):
        assert {n: got[section].get(n) for n in names} == {n: want[section].get(n) for n in names}, section
    text, ref_text = metrics.prometheus_text(), ref_metrics.prometheus_text()
    assert _families(text, names) == _families(ref_text, names)
    assert len(_families(text, names)) > 8
    pct = metrics.histogram_percentiles(names[2])
    assert pct == ref_metrics.histogram_percentiles(names[2])


def test_percentiles_and_local_series():
    for counts in ([0, 3, 1, 0, 6], [5, 0, 0, 0, 0], [0, 0, 0, 0, 2], [0, 0, 0, 0, 0]):
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            a = metrics.percentiles_from_buckets((0.1, 0.5, 1.0, 2.0), counts, q)
            b = ref_metrics.percentiles_from_buckets((0.1, 0.5, 1.0, 2.0), counts, q)
            assert a == b or (a != a and b != b)
    h = metrics.Histogram(f"series_{uuid.uuid4().hex[:8]}", "x", boundaries=(1.0, 2.0))
    h.observe(0.5)
    h.observe(1.5)
    assert h.percentiles((0.5,)) == {"p50": 1.0, "count": 2, "sum": 2.0}
    seq = metrics.sample_series_now()
    h.observe(3.0)
    assert metrics.sample_series_now() == seq + 1
    points = metrics.get_local_series(h.name)[h.name]["points"][""]
    assert [v for _ts, v in points[-2:]] == [[1, 1, 0, 2.0, 2], [1, 1, 1, 5.0, 3]]
    assert metrics.safe_counter(f"safe_{uuid.uuid4().hex[:8]}").kind == "counter"
    with pytest.raises(ValueError, match="Unknown tag"):
        metrics.Counter(f"bad_{uuid.uuid4().hex[:8]}").inc(tags={"x": 1})


@pytest.fixture
def fresh_rings():
    st = events.stats()
    events.clear()
    events.set_enabled(True)
    yield
    events.configure(capacity=st["capacity"])
    events.set_enabled(st["enabled"])
    events.clear()


def _emit(etype, thread_idx, n, hold=None, done=None):
    for i in range(n):
        events.record(etype, t=thread_idx, i=i)
    if hold is not None:
        # stay alive until the snapshot is taken: the collector folds a dead
        # thread's ring into the (capacity-bounded) retired store
        done.release()
        hold.wait(60)


@pytest.mark.parametrize("n_threads,per", [(8, 1500), (3, 4000)])
def test_events_from_threads_no_loss_duplicate_or_reorder(fresh_rings, n_threads, per):
    events.configure(capacity=8192)
    hold, done = threading.Event(), threading.Semaphore(0)
    threads = [threading.Thread(target=_emit, args=("port.stress", k, per, hold, done))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for _ in threads:
        assert done.acquire(timeout=60)
    evs = [e for e in events.snapshot() if e["type"] == "port.stress"]
    hold.set()
    for t in threads:
        t.join(timeout=60)
    assert len(evs) == n_threads * per
    seqs = [e["seq"] for e in evs]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    per_thread = {}
    for e in evs:
        per_thread.setdefault(e["t"], []).append(e["i"])
    assert all(idxs == list(range(per)) for idxs in per_thread.values())
    assert events.stats()["dropped"] == 0


def test_events_drop_count_exact_on_overflow(fresh_rings):
    events.configure(capacity=64)
    n_threads, per = 4, 500
    threads = [threading.Thread(target=_emit, args=("port.drop", k, per), name=f"port-drop-{k}")
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    rows = {r["thread"]: r for r in events.ring_stats() if r["thread"].startswith("port-drop-")}
    assert len(rows) == n_threads
    assert all(r["dropped"] == per - 64 and r["size"] == 64 for r in rows.values())
    per_thread = {}
    for e in events.snapshot():
        if e["type"] == "port.drop":
            per_thread.setdefault(e["t"], []).append(e["i"])
    assert all(idxs == list(range(per - 64, per)) for idxs in per_thread.values())
    assert events.stats()["dropped"] == n_threads * (per - 64)


def test_events_disable_emit_and_flush(fresh_rings, tmp_path):
    events.record("port.a", request_id="r1", x=1)
    events.emit("port.obj", obj_id=b"\x01\x02", size=5, request_id="r1")
    events.set_enabled(False)
    events.record("port.b")
    events.set_enabled(True)
    snap = events.snapshot("r1")
    assert [e["type"] for e in snap] == ["port.a", "port.obj"]
    assert snap[0]["x"] == 1 and snap[1]["oid"] == "0102" and snap[1]["size"] == 5
    path = events.flush(str(tmp_path / "ev.jsonl"))
    back = events.load_crash_files(str(tmp_path))
    assert path and [e["type"] for e in back] == ["port.a", "port.obj"]


HOT_PATHS = (
    ("ray_tpu_torch/_private/events.py", "record"),
    ("ray_tpu_torch/_private/events.py", "emit"),
    ("ray_tpu_torch/util/metrics.py", "Counter.inc"),
    ("ray_tpu_torch/util/metrics.py", "Gauge.set"),
    ("ray_tpu_torch/util/metrics.py", "Histogram.observe"),
    ("ray_tpu_torch/util/tracing.py", "span"),
    ("ray_tpu_torch/util/phases.py", "new_ledger"),
    ("ray_tpu_torch/util/phases.py", "charge"),
)


@pytest.fixture(scope="module")
def lint_index():
    from ray_tpu._lint.core import FileContext
    from ray_tpu._lint.index import build_index

    ctxs = []
    for rel in sorted({p for p, _q in HOT_PATHS}):
        text = open(os.path.join(REPO, rel)).read()
        ctxs.append(FileContext(os.path.join(REPO, rel), rel, text, ast.parse(text)))
    return build_index(ctxs, display_root=REPO)


@pytest.mark.parametrize("rel,qualname", HOT_PATHS, ids=[q for _r, q in HOT_PATHS])
def test_hot_path_takes_no_shared_lock(lint_index, rel, qualname):
    module = rel[:-3].replace("/", ".")
    info = lint_index.functions.get(f"{module}:{qualname}")
    assert info is not None, f"index lost {module}:{qualname}"
    assert not lint_index.trans_lock_acqs(info)
    # and the index does see a lock where there is one
    held = lint_index.functions.get("ray_tpu_torch.util.metrics:Histogram.percentiles")
    if rel.endswith("metrics.py"):
        assert lint_index.trans_lock_acqs(held)


def _span_view(spans):
    return [(s["name"], s["cat"], s["ph"], s["tid"].rsplit("-", 1)[1], s.get("args")) for s in spans]


def test_spans_record_attributes_and_match_the_reference():
    got = []
    for mod in (tracing, ref_tracing):
        mod.clear()
        with mod.span("outer", batch=3, obj=object):
            with mod.trace_context("00aa11bb22cc33dd") as rid:
                assert rid == "00aa11bb22cc33dd"
                with mod.span("inner", spec={"k": 4}):
                    pass
        got.append(_span_view(mod.get_spans()))
        mod.clear()
    assert got[0] == got[1]
    inner, outer = got[0]
    assert inner[4] == {"spec": {"k": 4}, "request_id": "00aa11bb22cc33dd"} and inner[3] == "d1"
    assert outer[4]["batch"] == 3 and outer[4]["obj"].startswith("<class")


@pytest.mark.parametrize("value", [3, -1.5, float("nan"), float("inf"), True, None, "s", b"raw", [1, {"a": 2}],
                                   {"k": object()}, (1, 2), {1, 2}, object, 10 ** 30])
def test_span_attributes_convert_like_the_reference(value):
    got, want = tracing._jsonable(value), ref_tracing._jsonable(value)
    assert type(got) is type(want) and (got == want or got != got or isinstance(got, str) and
                                        got.split(" at 0x")[0] == want.split(" at 0x")[0])


def test_unsampled_context_records_nothing(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE", "0")
    tracing.clear()
    with tracing.trace_context() as rid:
        assert isinstance(tracing.get_trace_context(), tracing.UnsampledContext)
        assert tracing.current_request_id() == rid
        with tracing.span("dropped", x=1) as sp:
            assert sp is None
    assert tracing.get_spans() == []
    with tracing.span("no context is always kept"):
        pass
    assert [s["name"] for s in tracing.get_spans()] == ["no context is always kept"]
    tracing.clear()
    ctx = tracing.UnsampledContext("abc")
    assert pickle.loads(pickle.dumps(ctx)).request_id == "abc"
    with pytest.raises(AttributeError):
        ctx.request_id = "x"


@pytest.mark.parametrize("rate", ["0", "0.25", "0.5", "1"])
def test_sampling_decisions_match_the_reference(monkeypatch, rate):
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE", rate)
    ids = [os.urandom(8).hex() for _ in range(400)] + ["not-hex", "", None]
    assert [tracing.trace_sampled(i) for i in ids] == [ref_tracing.trace_sampled(i) for i in ids]
    lazy = tracing.LazyTaskContext(b"\x12" * 8)
    assert lazy.request_id == ref_tracing.LazyTaskContext(b"\x12" * 8).request_id
    assert lazy.sampled == ref_tracing.trace_sampled(lazy.request_id)


def test_request_lanes_match_the_reference():
    spans = [
        {"name": "a", "ts": 1.0, "args": {"request_id": "r1"}},
        {"name": "b", "ts": 2.0, "args": {"request_id": "r2"}},
        {"name": "c", "ts": 3.0},
    ]
    recorded = [
        {"type": "llm.submit", "ts": 0.5, "seq": 0, "request_id": "r1", "pid": 1},
        {"type": "llm.finish", "ts": 4.0, "seq": 1, "request_id": "r1", "pid": 1, "reason": "stop"},
        {"type": "llm.other", "ts": 5.0, "seq": 2},
    ]
    lanes = tracing.request_lanes(spans, recorded)
    assert lanes == ref_tracing.request_lanes(spans, recorded)
    assert {lane["tid"] for lane in lanes} == {"req:r1"} and len(lanes) == 3


class _Req:
    def __init__(self, mod, t0):
        self.phase_led = mod.new_ledger(t0)
        self.trace_id, self.id, self.arrival_t = "trace-1", "req-1", t0
        self.resumed_from = 0
        self.phase_dispatch_s = None


def test_phase_ledger_folds_like_the_reference(fresh_rings):
    ref_events.clear()
    folds = []
    for mod, rec in ((phases, events), (ref_phases, ref_events)):
        req = _Req(mod, 100.0)
        mod.note_dispatch(req, {"request_id": "trace-1", "t_dispatch": 99.75})
        for idx, t in ((mod.QUEUE, 100.5), (mod.ADMIT, 100.625), (mod.PREFILL, 101.0),
                       (mod.SPEC_VERIFY, 101.5), (mod.PREEMPT, 102.0), (mod.DECODE, 103.25)):
            mod.charge(req.phase_led, idx, t)
        assert sum(req.phase_led[1:]) == req.phase_led[0] - req.arrival_t
        decomp = mod.fold_engine(req, 103.25, "length")
        mod.fold_proxy("trace-1", 99.5, 99.75, 100.7, 103.3, 103.5)
        evs = [{k: v for k, v in e.items() if k not in ("seq", "ts", "pid")}
               for e in rec.snapshot("trace-1")]
        folds.append((decomp, req.phase_dispatch_s, evs))
    assert folds[0] == folds[1]
    decomp, dispatch_s, evs = folds[0]
    assert dispatch_s == 0.25 and decomp["cow_fork"] == 0.0 and decomp["decode"] == 1.25
    assert [e["type"] for e in evs] == ["llm.phase.ledger", "llm.phase.proxy"]
    assert phases.ENGINE_PHASES == ref_phases.ENGINE_PHASES and phases.PHASES == ref_phases.PHASES
    prev = phases.set_enabled(False)
    assert not phases.enabled() and prev
    phases.set_enabled(prev)
    ref_events.clear()


def test_exceptions_pickle_like_the_reference():
    err = OverloadedError("busy", retry_after_s=2.5)
    back = pickle.loads(pickle.dumps(err))
    ref = pickle.loads(pickle.dumps(RefOverloadedError("busy", retry_after_s=2.5)))
    assert (type(back).__name__, back.args, back.retry_after_s) == (
        type(ref).__name__, ref.args, ref.retry_after_s)
    task = RayTaskError.from_exception("f", ValueError("bad"))
    again = pickle.loads(pickle.dumps(task))
    assert isinstance(again.as_instanceof_cause(), ValueError) and "bad" in again.traceback_str
