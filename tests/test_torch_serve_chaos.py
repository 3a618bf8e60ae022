"""The port's Serve-plane chaos (``ray_tpu_torch.serve`` with
``ray_tpu_torch._private.chaos``), mirroring ``tests/test_serve_chaos.py``:
streaming LLM traffic vs SIGKILL (RESILIENCE.md). The replicas serve a
2-layer fp32 GPT-J on the CPU (``device="cpu"``), drawn from seed 0 by the
port's ``gptj_init``; the unkilled ground truth is a local port engine on
the same weights. The reference's ``slow`` marks are kept;
``test_midstream_kill_greedy_tier1`` holds failover in tier 1.

The acceptance scenarios for fault-tolerant serving:

* a streaming LLM request whose replica is SIGKILLed MID-GENERATION
  completes with a token sequence identical to an unkilled run — greedy
  and seeded sampling (resumable streams: the handle journals delivered
  tokens and re-submits ``resume_tokens`` to a fresh replica; per-token
  PRNG keys derive from (seed, absolute output index) so the failover
  boundary cannot change the sequence);
* a chaos soak — sustained concurrent streams while ``ServeReplicaKiller``
  SIGKILLs replicas on a timer — finishes EVERY stream token-identically
  (never hung, never truncated, never wrong);
* killing the serve CONTROLLER mid-stream (here: while a downscaled
  replica is draining) leaves the data plane serving — streams complete,
  and a fresh ``serve.run`` recovers the control plane;
* overload shedding: a doomed deadline gets ``429 Too Many Requests``
  with a ``Retry-After`` header — from the engine's backlog estimate
  (payload ``deadline_s``) and from the proxy's capacity probe
  (``x-deadline-s`` header) — instead of queueing or hanging.

Kills here are deliberate SIGKILL (no cleanup, no goodbye) — the same
brutality as ``_private/chaos.ResourceKiller``.
"""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch._private import chaos
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models.gptj import GPTJConfig, gptj_init

# seq_len must cover prompt + the longest generation; the paged table
# (max_blocks_per_seq * block_size = 256) is the binding cap
TINY = GPTJConfig(
    vocab_size=128, seq_len=260, d_model=32, n_layers=2, n_heads=2,
    rotary_dim=8, dtype="float32",
)
ECFG = EngineConfig(
    max_slots=2, num_blocks=128, block_size=4, max_blocks_per_seq=64,
    prefill_chunk=8,
)
PROMPT = [5, 6, 7] * 4
DEP = "llm_LLMDeployment"  # app "llm" + default deployment name


@pytest.fixture
def serve_instance():
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def reference():
    """Expected token sequences from a local engine with the SAME params
    the replicas build (model seed 0) — the unkilled ground truth."""
    params = gptj_init(TINY, torch.Generator().manual_seed(0), "cpu")
    eng = LLMEngine(TINY, params, ECFG, device="cpu")
    cache: dict = {}

    def ref(sp: SamplingParams) -> list:
        key = (sp.max_tokens, sp.temperature, sp.top_k, sp.top_p, sp.seed)
        if key not in cache:
            cache[key] = eng.generate(PROMPT, sp)
        return cache[key]

    return ref


def _deploy(n_replicas=2, http=False, engine_config=ECFG, max_ongoing=16,
            warmup=True):
    from ray_tpu_torch.serve.llm import build_llm_app

    app = build_llm_app(
        model="gptj", model_cfg=TINY, engine_config=engine_config,
        num_replicas=n_replicas, max_ongoing_requests=max_ongoing,
        warmup=warmup, device="cpu",
    )
    return serve.run(app, name="llm", http=http, http_port=0)


def _kill_serving_replica(stream) -> int:
    """SIGKILL the replica serving ``stream`` (a streaming response);
    returns its pid. Deterministic chaos: the kill is guaranteed to hit the
    replica serving the in-flight stream. The reference finds it by asking
    each replica's engine for its running count; the port's CPU engine
    holds its (unfair) step lock through a whole short stream, so such a
    ``stats()`` call would only be answered once the stream had ended
    (ROADMAP.md §C). The response knows its replica without asking it."""
    pid = chaos.pid_of_actor(stream._replica._actor_id.hex())
    assert pid is not None, "the serving replica has no live worker"
    os.kill(pid, signal.SIGKILL)
    return pid


# the reference's mark (tests/test_serve_chaos.py); the greedy case runs in
# tier 1 as test_midstream_kill_greedy_tier1
@pytest.mark.slow
@pytest.mark.parametrize(
    "kw",
    [dict(temperature=0.0),
     dict(temperature=0.8, top_k=5, top_p=0.9, seed=123)],
    ids=["greedy", "sampled"],
)
def test_midstream_kill_resumes_token_identical(serve_instance, reference, kw):
    """THE acceptance test: SIGKILL the serving replica mid-generation;
    the stream fails over and completes token-identically."""
    n = 200
    expected = reference(SamplingParams(max_tokens=n, **kw))
    handle = _deploy(n_replicas=2)

    got, killed = [], []
    stream = handle.options(stream=True).remote(PROMPT, max_tokens=n, **kw)
    for tok in stream:
        got.append(tok)
        if len(got) == 2 and not killed:
            killed.append(_kill_serving_replica(stream))
    assert killed, "kill never fired"
    assert len(got) == n
    assert got == expected, (
        f"diverged at {next(i for i, (a, b) in enumerate(zip(got, expected)) if a != b)}"
    )


def test_midstream_kill_greedy_tier1(serve_instance, reference):
    """The acceptance test's greedy case, unmarked: SIGKILL the replica
    that is generating a 200-token greedy stream after its second token;
    the handle resumes the stream on the other replica with the delivered
    tokens, and the whole stream equals the unkilled engine's."""
    n = 200
    expected = reference(SamplingParams(max_tokens=n))
    handle = _deploy(n_replicas=2)

    got, killed = [], []
    stream = handle.options(stream=True).remote(PROMPT, max_tokens=n)
    for tok in stream:
        got.append(tok)
        if len(got) == 2 and not killed:
            killed.append(_kill_serving_replica(stream))
    assert killed, "kill never fired"
    assert got == expected


# the reference's mark (tests/test_serve_chaos.py)
@pytest.mark.slow
def test_chaos_soak_concurrent_streams_survive_kills(serve_instance, reference):
    """Sustained concurrent streaming while ServeReplicaKiller SIGKILLs
    replicas on a timer: every stream finishes, every token matches."""
    n = 120
    expected = reference(SamplingParams(max_tokens=n))
    # warmup=False: replacement replicas become routable in seconds and
    # compile inside their first request — under churn, a failover must
    # find a successor before the router's pick deadline, and a
    # contended box can't warm a fresh process that fast
    handle = _deploy(n_replicas=2, warmup=False)

    results: list = [None] * 4
    errors: list = []

    def client(i):
        try:
            toks = list(
                handle.options(stream=True).remote(PROMPT, max_tokens=n)
            )
            results[i] = toks
        except Exception as e:  # noqa: BLE001 — the assertion IS "no error"
            errors.append((i, repr(e)))

    with chaos.ServeReplicaKiller(
        deployment=DEP, interval_s=1.5, seed=7, warmup_s=0.4, max_kills=2
    ) as killer:
        threads = [
            threading.Thread(target=client, args=(i,), daemon=True)
            for i in range(len(results))
        ]
        for i, t in enumerate(threads):
            t.start()
            if i == 1:
                time.sleep(0.5)  # spread arrivals across the kill window
        # join budget past the replica's 300s stream timeout: on a starved
        # box a stream parked behind replacement-replica jit warmup is
        # SLOW, not hung — a real hang (or stall) still fails, with the
        # EngineStalledError diagnosis in `errors` instead of a bare
        # "thread alive"
        deadline = time.time() + 420
        for t in threads:
            t.join(timeout=max(1.0, deadline - time.time()))
            assert not t.is_alive(), "a stream hung"
    assert killer.kills, "killer never fired — the soak exercised nothing"
    assert not errors, errors
    for i, toks in enumerate(results):
        assert toks == expected, f"stream {i} diverged/truncated"


# the reference's mark (tests/test_serve_chaos.py)
@pytest.mark.slow
def test_controller_kill_during_draining(serve_instance, reference):
    """Kill the CONTROLLER while a replica is draining from a downscale
    and a stream is in flight: the data plane keeps serving (streams
    complete token-identically), and a fresh serve.run recovers."""
    n = 200
    expected = reference(SamplingParams(max_tokens=n))
    handle = _deploy(n_replicas=2)

    # two concurrent streams so both replicas hold in-flight work
    streams = [
        iter(handle.options(stream=True).remote(PROMPT, max_tokens=n))
        for _ in range(2)
    ]
    firsts = [next(s) for s in streams]  # both generating
    # downscale to 1: the excess replica starts DRAINING its stream
    _deploy(n_replicas=1)
    pid = chaos.kill_serve_controller()
    assert pid is not None, "controller kill found no process"

    for first, s in zip(firsts, streams):
        assert [first] + list(s) == expected

    # control plane recovers: a fresh serve.run redeploys and serves
    serve.shutdown()
    handle = _deploy(n_replicas=1)
    assert list(
        handle.options(stream=True).remote(PROMPT, max_tokens=8)
    ) == expected[:8]


def _post(url, body, timeout=300, headers=()):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **dict(headers)},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read(), dict(resp.headers)


def test_http_deadline_shed_429(serve_instance):
    """Engine-level deadline-aware admission over HTTP: with a measured
    service rate and a deep backlog, a doomed ``deadline_s`` payload gets
    429 + Retry-After instead of queueing; the backlog itself completes."""
    handle = _deploy(
        n_replicas=1,
        engine_config=EngineConfig(
            max_slots=1, num_blocks=128, block_size=4, max_blocks_per_seq=64,
            prefill_chunk=8,
        ),
        http=True,
    )
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    port = ray_tpu_torch.get(controller.get_proxy_port.remote(), timeout=30)
    url = f"http://127.0.0.1:{port}/llm"

    # prime the engine's service-rate estimate
    st, _, _ = _post(url, {"prompt": PROMPT, "max_tokens": 16})
    assert st == 200
    # build a backlog of long generations
    backlog = [
        threading.Thread(
            target=_post, args=(url, {"prompt": PROMPT, "max_tokens": 200}),
            daemon=True,
        )
        for _ in range(4)
    ]
    for t in backlog:
        t.start()
    # the engine never sheds WITHOUT a backlog (an empty engine admits any
    # deadline), so wait until the backlog is actually submitted AND the
    # rate is measured before sending the doomed request
    deadline = time.time() + 30
    while True:
        st_ = handle.stats.remote().result(timeout=30)
        if (
            st_["running"] + st_["waiting"] >= 2
            and st_["service_rate_tokens_per_s"] > 0
        ):
            break
        assert time.time() < deadline, f"backlog never formed: {st_}"
        time.sleep(0.05)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, {"prompt": PROMPT, "max_tokens": 200, "deadline_s": 0.05})
    assert ei.value.code == 429
    assert int(ei.value.headers["Retry-After"]) >= 1
    for t in backlog:
        t.join(timeout=120)
        assert not t.is_alive(), "backlog request hung"


def test_http_proxy_capacity_shed_429(serve_instance):
    """Proxy-level deadline-aware admission: every replica at its
    admission cap + an ``x-deadline-s`` header = immediate 429, without
    queueing in the router; the same request WITHOUT the header queues
    and succeeds."""
    _deploy(n_replicas=1, max_ongoing=1, http=True)
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    port = ray_tpu_torch.get(controller.get_proxy_port.remote(), timeout=30)
    url = f"http://127.0.0.1:{port}/llm"

    # a slow-consumed stream occupies the single admission slot
    req = urllib.request.Request(
        url, data=json.dumps({"prompt": PROMPT, "max_tokens": 200}).encode(),
        headers={"Content-Type": "application/json"},
    )
    occupier = urllib.request.urlopen(req, timeout=120)
    occupier.read(2)  # headers + first chunk: the slot is held
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(
                url, {"prompt": PROMPT, "max_tokens": 4},
                headers=[("x-deadline-s", "0.2")],
            )
        assert ei.value.code == 429
        assert "Retry-After" in ei.value.headers
    finally:
        occupier.read()  # drain; the slot frees
        occupier.close()
    # no deadline header: the same request queues behind and succeeds
    st, data, _ = _post(url, {"prompt": PROMPT, "max_tokens": 4})
    assert st == 200 and len(data.splitlines()) == 4


# the reference's mark (tests/test_serve_chaos.py)
@pytest.mark.slow
def test_flight_recorder_sees_failover(serve_instance, reference, tmp_path,
                                       monkeypatch):
    """Observability contract: the failover leaves a forensic trail — the
    dead replica's crash-flushed ring on disk and a resumed llm.submit
    (resumed > 0) on the successor."""
    monkeypatch.setenv("RAY_TPU_EVENTS_DIR", str(tmp_path))
    n = 200
    expected = reference(SamplingParams(max_tokens=n))
    handle = _deploy(n_replicas=2)

    from ray_tpu_torch.util import tracing

    with tracing.trace_context() as rid:
        got, killed = [], []
        stream = handle.options(stream=True).remote(PROMPT, max_tokens=n)
        for tok in stream:
            got.append(tok)
            if len(got) == 2 and not killed:
                killed.append(_kill_serving_replica(stream))
    assert got == expected

    from ray_tpu_torch.obs import request_events

    deadline = time.time() + 30
    resumed = []
    while time.time() < deadline and not resumed:
        evs = request_events(rid)
        resumed = [
            e for e in evs
            if e["type"] == "llm.submit" and e.get("resumed", 0) > 0
        ]
        time.sleep(0.5)
    assert resumed, "no resumed llm.submit event under the request id"
    assert resumed[0]["resumed"] >= 2  # at least the delivered prefix
