"""The port's job submission and dashboard against the reference's tests:
mirrors of ``tests/test_job.py`` and ``tests/test_dashboard.py`` run on
``ray_tpu_torch`` over one module cluster, and the port's dashboard pages
beside the reference's. The Grafana round trip goes through the port's
CLI (``python -m ray_tpu_torch grafana -o``), as the reference's goes
through ``python -m ray_tpu grafana``."""

import json
import os
import sys
import tempfile
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch import dashboard, job

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def _shared_cluster():
    ray_tpu_torch.init(num_cpus=4, num_tpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_regular(_shared_cluster):
    yield


# ---------------------------------------------------------------------------
# tests/test_dashboard.py
# ---------------------------------------------------------------------------


@pytest.fixture
def dash(ray_start_regular):
    url = dashboard.start(port=0)
    yield url
    dashboard.stop()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=10) as r:
        ctype = r.headers.get("Content-Type", "")
        body = r.read()
    return ctype, body


def test_index_and_version(dash):
    ctype, body = _get(dash, "/")
    assert "text/html" in ctype and b"ray_tpu_torch" in body
    _, body = _get(dash, "/api/version")
    version = json.loads(body)
    assert version["dashboard"] == 1 and version["ray_tpu_torch"] == ray_tpu_torch.__version__


def test_observability_endpoints(dash):
    """/api/percentiles, /api/events (+ filters), /api/request — the HTTP
    face of obs top / obs events / obs req. Before the tests that leave
    actors in the module's cluster: a drain that meets one waits out its
    deadline (the reference's runtime does the same), where the
    reference's per-test clusters have none."""
    from ray_tpu_torch._private import events
    from ray_tpu_torch.util import metrics as um
    from ray_tpu_torch.util.metrics import Histogram

    h = Histogram("dash_lat_s", "latency", boundaries=(0.1, 1.0))
    for v in (0.05, 0.5, 2.0):
        h.observe(v)
    um.flush()
    _, body = _get(dash, "/api/percentiles")
    pcts = json.loads(body)
    snap = next(iter(pcts["dash_lat_s"].values()))
    assert snap["count"] == 3 and snap["p50"] > 0

    events.record("dash.test_event", request_id="dash-rid-1", n=7)
    events.record("dash.other")
    _, body = _get(dash, "/api/events?tail=50")
    evs = json.loads(body)
    assert any(e["type"] == "dash.test_event" for e in evs)
    _, body = _get(dash, "/api/events?request_id=dash-rid-1")
    only = json.loads(body)
    assert only and all(e.get("request_id") == "dash-rid-1" for e in only)

    _, body = _get(dash, "/api/request?id=dash-rid-1")
    req = json.loads(body)
    assert any(e["type"] == "dash.test_event" and e["n"] == 7 for e in req)
    _, body = _get(dash, "/api/request")
    assert "error" in json.loads(body)


def test_cluster_state_endpoints(dash):
    @ray_tpu_torch.remote
    class Counter:
        def ping(self):
            return 1

    c = Counter.options(name="dash-counter").remote()
    ray_tpu_torch.get(c.ping.remote())

    _, body = _get(dash, "/api/nodes")
    nodes = json.loads(body)
    assert len(nodes) >= 1

    _, body = _get(dash, "/api/actors")
    actors = json.loads(body)
    assert any(a.get("name") == "dash-counter" for a in actors)

    # live task table may already be drained; the timeline keeps history
    _, body = _get(dash, "/api/timeline")
    events = json.loads(body)
    assert any("dash-counter" in str(e.get("name")) for e in events)

    _, body = _get(dash, "/api/cluster_resources")
    res = json.loads(body)
    assert res["total"].get("CPU", 0) > 0

    _, body = _get(dash, "/api/summary")
    assert json.loads(body)


def test_prometheus_metrics_endpoint(dash):
    from ray_tpu_torch.util.metrics import Counter as MCounter

    m = MCounter("dash_test_total", description="events")
    m.inc(3)
    from ray_tpu_torch.util import metrics as um

    um.flush()
    ctype, body = _get(dash, "/metrics")
    assert "text/plain" in ctype
    assert b"dash_test_total" in body


def test_unknown_route_404(dash):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(dash, "/api/nope")
    assert e.value.code == 404


def test_static_spa_assets(dash):
    """The SPA is served from the port's own _dashboard_static/."""
    ctype, body = _get(dash, "/")
    assert "text/html" in ctype and b"/app.js" in body
    ctype, body = _get(dash, "/app.js")
    assert "javascript" in ctype
    # every state-API entity has a view in the app
    for needle in (b"nodes", b"actors", b"tasks", b"objects", b"placement_groups",
                   b"jobs", b"timeline", b"flamegraph", b"metrics", b"worker_stacks",
                   b"filterState"):
        assert needle in body, needle
    ctype, body = _get(dash, "/style.css")
    assert "css" in ctype and b"--accent" in body


def test_core_metrics_sampled(dash):
    """dashboard.start() launches the core-series sampler; /metrics then
    carries the runtime gauges the Grafana board charts."""
    @ray_tpu_torch.remote
    def f():
        return 1

    ray_tpu_torch.get(f.remote())
    from ray_tpu_torch.util import metrics as um

    um.start_core_metrics(interval_s=0.2)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        um.flush()
        _, body = _get(dash, "/metrics")
        if b"ray_tpu_core_nodes" in body and b"ray_tpu_core_resource_total" in body:
            break
        time.sleep(0.3)
    assert b"ray_tpu_core_nodes" in body
    assert b"ray_tpu_core_resource_total" in body


def test_grafana_dashboard_json(dash, tmp_path):
    """Generated board imports cleanly: valid JSON with schemaVersion,
    templated prometheus datasource, and one panel per core series."""
    _, body = _get(dash, "/api/grafana")
    board = json.loads(body)
    assert board["uid"] and board["schemaVersion"] >= 30
    assert board["templating"]["list"][0]["type"] == "datasource"
    titles = [p["title"] for p in board["panels"]]
    assert "Tasks by state" in titles and "Alive nodes" in titles
    for p in board["panels"]:
        assert p["type"] == "timeseries"
        assert "ray_tpu_" in p["targets"][0]["expr"]
        assert "gridPos" in p and "id" in p

    # CLI writer round-trips
    import subprocess

    path = tmp_path / "board.json"
    r = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "grafana", "-o", str(path)],
        capture_output=True,
        text=True,
        timeout=60,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert r.returncode == 0, r.stderr
    with open(path) as f:
        assert json.load(f)["uid"] == board["uid"]


def test_logs_endpoint_shape(dash):
    _, body = _get(dash, "/api/logs?job_id=nope")
    data = json.loads(body)
    assert "logs" in data and data["job_id"] == "nope"


# ---------------------------------------------------------------------------
# tests/test_job.py
# ---------------------------------------------------------------------------


def test_submit_success_and_logs(ray_start_regular):
    jid = job.submit_job(f"{sys.executable} -c \"print('hello from job')\"")
    assert job.wait_job(jid, timeout=120) == job.SUCCEEDED
    assert "hello from job" in job.get_job_logs(jid)
    jobs = job.list_jobs()
    assert any(j["job_id"] == jid and j["status"] == job.SUCCEEDED for j in jobs)


def test_failed_job(ray_start_regular):
    jid = job.submit_job(f"{sys.executable} -c \"import sys; print('boom'); sys.exit(3)\"")
    assert job.wait_job(jid, timeout=120) == job.FAILED
    logs = job.get_job_logs(jid)
    assert "boom" in logs and "exit code 3" in logs


def test_stop_running_job(ray_start_regular):
    jid = job.submit_job(f"{sys.executable} -c \"import time; time.sleep(60)\"")
    deadline = time.time() + 30
    while job.get_job_status(jid) == job.PENDING and time.time() < deadline:
        time.sleep(0.1)
    assert job.stop_job(jid)
    assert job.wait_job(jid, timeout=60) == job.STOPPED


def test_env_vars_and_working_dir(ray_start_regular, tmp_path):
    jid = job.submit_job(
        f"{sys.executable} -c \"import os; print('V=' + os.environ['MY_JOB_VAR'], 'D=' + os.getcwd())\"",
        env_vars={"MY_JOB_VAR": "42"},
        working_dir=str(tmp_path),
    )
    assert job.wait_job(jid, timeout=120) == job.SUCCEEDED
    logs = job.get_job_logs(jid)
    assert "V=42" in logs
    assert f"D={tmp_path}" in logs


def test_entrypoint_attaches_to_cluster(ray_start_regular):
    """With a TCP listener up, the job's subprocess gets RAY_TPU_ADDRESS and
    can drive the SAME cluster that runs it."""
    from ray_tpu_torch._private.runtime import get_ctx

    get_ctx().head.listen_tcp("127.0.0.1", 0)
    script = (
        "import os, ray_tpu_torch\n"
        "ray_tpu_torch.init(address=os.environ['RAY_TPU_ADDRESS'])\n"
        "@ray_tpu_torch.remote\n"
        "def f(x):\n"
        "    return x + 1\n"
        "print('RESULT', ray_tpu_torch.get(f.remote(41), timeout=60))\n"
        "ray_tpu_torch.shutdown()\n"
    )
    fd, path = tempfile.mkstemp(suffix=".py")
    with os.fdopen(fd, "w") as f:
        f.write(script)
    try:
        env_path = str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")
        jid = job.submit_job(f"{sys.executable} {path}", env_vars={"PYTHONPATH": env_path})
        assert job.wait_job(jid, timeout=180) == job.SUCCEEDED, job.get_job_logs(jid)
        assert "RESULT 42" in job.get_job_logs(jid)
    finally:
        os.unlink(path)


def test_jobs_route_lists_a_submitted_job(dash):
    """/api/jobs and /api/logs over a job of this cluster (the dashboard's
    job view, which the reference's tests reach only through the CLI)."""
    jid = job.submit_job(f"{sys.executable} -c \"print('dash job line')\"")
    assert job.wait_job(jid, timeout=120) == job.SUCCEEDED
    _, body = _get(dash, "/api/jobs")
    assert any(j["job_id"] == jid and j["status"] == job.SUCCEEDED for j in json.loads(body))
    _, body = _get(dash, f"/api/logs?job_id={jid}")
    assert "dash job line" in json.loads(body)["logs"]


def test_static_pages_are_the_references_but_for_the_names():
    """The port's pages are its own copy of the reference's: the same
    markup and code, with the package's name and its commands in place of
    the reference's."""
    ref = REPO / "ray_tpu" / "_dashboard_static"
    port = REPO / "ray_tpu_torch" / "_dashboard_static"
    assert sorted(p.name for p in ref.iterdir()) == sorted(p.name for p in port.iterdir())
    for p in ref.iterdir():
        a, b = p.read_text().splitlines(), (port / p.name).read_text().splitlines()
        assert len(a) == len(b), p.name
        differ = [(x, y) for x, y in zip(a, b) if x != y]
        assert all("ray_tpu" in x and "ray_tpu_torch" in y for x, y in differ), differ
