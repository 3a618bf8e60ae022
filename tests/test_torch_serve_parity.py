"""One Serve workload through both packages: ``ray_tpu.serve`` and
``ray_tpu_torch.serve``, each in a fresh process of its own, must answer
alike — over HTTP (status codes, the headers that matter: ``x-request-id``,
``Retry-After``, the content type; and the bodies) and through handles.

The workload deploys a JSON echo, a stateful class, a bytes app, a
streaming generator, a failing app and a one-slot streaming app for the
proxy's capacity shed (429), plus a composed pair called through a handle,
and serves a tiny LLM app (the reference's JAX engine, the port's torch
engine, both on the CPU) whose proxy and engine phase events it returns.
``obs.attribute_rows`` and ``obs.attribution_report`` of both packages must
then agree on the same recorded events.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

WORKLOAD = r'''
import importlib, json, sys, threading, time, urllib.error, urllib.request

pkg = sys.argv[1]
rt = importlib.import_module(pkg)
serve = importlib.import_module(pkg + ".serve")
events = importlib.import_module(pkg + "._private.events")
if pkg == "ray_tpu":
    rt.init(num_cpus=6, num_tpus=0)
else:
    rt.init(num_cpus=6, num_gpus=0)
out = {}

def http(app, body, ctype="application/json", headers=None, timeout=60):
    data = json.dumps(body).encode() if ctype == "application/json" else body
    req = urllib.request.Request(f"http://127.0.0.1:{port}/{app}", data=data,
                                 headers={"Content-Type": ctype, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw, hdrs = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        status, raw, hdrs = e.code, e.read(), e.headers
    keep = {k: hdrs.get(k) for k in ("x-request-id", "Retry-After", "Content-Type", "Transfer-Encoding")}
    if "x-request-id" not in (headers or {}):
        keep["x-request-id"] = bool(keep["x-request-id"])  # minted: random in each run
    try:
        body = json.loads(raw)
    except Exception:
        body = raw.decode("latin-1")
    return [status, {k: v for k, v in keep.items() if v is not None}, body]

@serve.deployment
def echo(payload):
    return {"got": payload}

@serve.deployment
class Counter:
    def __init__(self, start):
        self.n = start
    def __call__(self, inc):
        self.n += inc if isinstance(inc, int) else 1
        return self.n

@serve.deployment
def rev(payload):
    return payload[::-1]

@serve.deployment
def tokens(payload):
    for i in range((payload or {}).get("n", 3)):
        yield {"token": i}

@serve.deployment
def fails(payload):
    raise ValueError("bad payload")

@serve.deployment(max_ongoing_requests=1)
def slow_stream(payload):
    for i in range(payload.get("n", 1)):
        time.sleep(0.05)
        yield i

@serve.deployment
class Upper:
    def __call__(self, s):
        return s.upper()

@serve.deployment
class Chain:
    def __init__(self, up):
        self.up = up
    def __call__(self, s):
        return "<" + self.up.remote(s).result() + ">"

serve.run(echo.bind(), name="echo", http=True, http_port=0)
controller = rt.get_actor("SERVE_CONTROLLER")
port = rt.get(controller.get_proxy_port.remote(), timeout=30)
h_counter = serve.run(Counter.bind(10), name="counter")
serve.run(rev.bind(), name="rev")
serve.run(tokens.bind(), name="tokens")
serve.run(fails.bind(), name="fails")
serve.run(slow_stream.bind(), name="slow")
h_chain = serve.run(Chain.bind(Upper.bind()), name="chain")

out["echo"] = http("echo", {"a": [1, 2]}, headers={"x-request-id": "rid-echo"})
out["echo_minted_id"] = http("echo", 5)[1].get("x-request-id")
out["counter_http"] = [http("counter", 2)[2], http("counter", 3)[2]]
out["counter_handle"] = [h_counter.remote(4).result(timeout=30), h_counter.remote(1).result(timeout=30)]
out["bytes"] = http("rev", b"\x00\x01abc", ctype="application/octet-stream")
out["text"] = http("rev", b"hello", ctype="text/plain")
status, hdrs, body = http("tokens", {"n": 4}, headers={"x-request-id": "rid-stream"})
out["stream_http"] = [status, hdrs, body if not isinstance(body, str) else body.splitlines()]
out["stream_handle"] = list(serve.get_app_handle("tokens").options(stream=True).remote({"n": 3}))
out["missing_app"] = http("nope", 1)[:2]
status, hdrs, body = http("fails", 1)
out["error"] = [status, hdrs.get("Content-Type"), "bad payload" in json.dumps(body)]
out["chain"] = h_chain.remote("abc").result(timeout=30)

# the proxy's capacity shed: the one slot held by a slow stream, then a
# request declaring a 0.2 s deadline
req = urllib.request.Request(f"http://127.0.0.1:{port}/slow", data=json.dumps({"n": 60}).encode(),
                             headers={"Content-Type": "application/json"})
occupier = urllib.request.urlopen(req, timeout=60)
occupier.read(2)
out["shed"] = http("slow", {"n": 1}, headers={"x-deadline-s": "0.2", "x-request-id": "rid-shed"})
occupier.read()
occupier.close()
out["after_shed"] = http("slow", {"n": 2})[::2]
out["status"] = sorted(serve.status())

# a tiny LLM app over HTTP: its phase events
llm = importlib.import_module(pkg + ".serve.llm")
eng_mod = importlib.import_module(pkg + ".llm.engine")
gptj = importlib.import_module(pkg + ".models.gptj")
kw = dict(vocab_size=128, seq_len=64, d_model=32, n_layers=2, n_heads=2, rotary_dim=8, dtype="float32")
if pkg == "ray_tpu":
    kw.update(remat=False, attn_impl="xla", fused_loss=False)
app_kw = dict(model="gptj", model_cfg=gptj.GPTJConfig(**kw),
              engine_config=eng_mod.EngineConfig(max_slots=2, num_blocks=32, block_size=4,
                                                 max_blocks_per_seq=12, prefill_chunk=8))
if pkg != "ray_tpu":
    app_kw["device"] = "cpu"
serve.run(llm.build_llm_app(**app_kw), name="llm")
rids = []
for i in range(3):
    st, hd, body = http("llm", {"prompt": [5, 6, 7, i], "max_tokens": 4}, headers={"x-request-id": f"rid-llm-{i}"})
    rids.append(hd.get("x-request-id"))
    out[f"llm_{i}"] = [st, hd.get("x-request-id"), len(body.splitlines()) if isinstance(body, str) else body]
deadline = time.time() + 30
while True:
    evs = [e for e in events.collect_cluster_events() if str(e.get("type", "")).startswith("llm.phase.")
           and e.get("request_id") in rids]
    kinds = {(e["type"], e["request_id"]) for e in evs}
    if len(kinds) >= 6 or time.time() > deadline:
        break
    time.sleep(0.2)
print("EVENTS " + json.dumps(evs, default=repr))
serve.shutdown()
rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
'''


def _run(package: str) -> tuple[dict, list]:
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", WORKLOAD, package], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    result = next(ln for ln in lines if ln.startswith("RESULT "))
    evs = next(ln for ln in lines if ln.startswith("EVENTS "))
    return json.loads(result[len("RESULT "):]), json.loads(evs[len("EVENTS "):])


@pytest.fixture(scope="module")
def results():
    return _run("ray_tpu"), _run("ray_tpu_torch")


SECTIONS = [
    "echo", "echo_minted_id", "counter_http", "counter_handle", "bytes", "text", "stream_http",
    "stream_handle", "missing_app", "error", "chain", "shed", "after_shed", "status",
    "llm_0", "llm_1", "llm_2",
]


@pytest.mark.parametrize("section", SECTIONS)
def test_same_answers_as_the_reference_serve(results, section):
    (ref, _), (port, _) = results
    assert section in ref and section in port
    assert port[section] == ref[section]


def test_the_workload_checked_what_it_meant_to(results):
    """The reference's own answers are the expected ones (so agreement is
    not agreement on a failure)."""
    (ref, _), _ = results
    assert ref["echo"] == [200, {"x-request-id": "rid-echo", "Content-Type": "application/json"},
                           {"got": {"a": [1, 2]}}]
    assert ref["echo_minted_id"] is True
    assert ref["counter_http"] == [12, 15] and ref["counter_handle"] == [19, 20]
    assert ref["bytes"][0] == 200 and ref["bytes"][1]["Content-Type"] == "application/octet-stream"
    assert ref["bytes"][1]["x-request-id"] is True
    assert ref["stream_http"][:2] == [200, {"x-request-id": "rid-stream", "Content-Type": "application/octet-stream",
                                            "Transfer-Encoding": "chunked"}]
    assert ref["stream_handle"] == [{"token": i} for i in range(3)]
    assert ref["missing_app"][0] == 404 and ref["error"] == [500, "application/json", True]
    assert ref["chain"] == "<ABC>"
    assert ref["shed"][0] == 429 and int(ref["shed"][1]["Retry-After"]) >= 1
    assert ref["shed"][1]["x-request-id"] == "rid-shed"
    assert ref["after_shed"] == [200, "0\n1\n"]
    assert [ref[f"llm_{i}"][:2] for i in range(3)] == [[200, f"rid-llm-{i}"] for i in range(3)]


@pytest.mark.parametrize("source", ["reference_events", "port_events"])
def test_attribution_agrees_on_the_same_events(results, source):
    """``attribute_rows`` and ``attribution_report`` of both packages over
    one run's recorded ``llm.phase.*`` events (each run's in turn): every
    request joins proxy and engine ledgers, and the two reports are equal."""
    from ray_tpu import obs as ref_obs
    from ray_tpu_torch import obs

    (_, ref_evs), (_, port_evs) = results
    evs = ref_evs if source == "reference_events" else port_evs
    rows = obs.attribute_rows(evs)
    assert rows == ref_obs.attribute_rows(evs)
    assert len(rows) == 3 and {r["scope"] for r in rows} == {"proxy"}
    report = obs.attribution_report(rows, top=3)
    assert report == ref_obs.attribution_report(rows, top=3)
    assert report["within_eps"] == 3
    assert obs.render_attribution(report) == ref_obs.render_attribution(report)
