"""The slice held against the reference: the port's ``serve.llm``
(``LLMDeployment`` in a replica of ``ray_tpu_torch.serve``) streams the
reference engine's tokens, on the CPU.

The same numpy weights, drawn from a seed by the reference's
``gptj_init``/``gpt_init``, go to the reference's ``LLMEngine`` (JAX on the
CPU) and, carried over with ``params_from_jax``, to a port replica bound
with ``params=`` and ``device="cpu"``. Greedy tokens streamed through a
handle and over the HTTP proxy must equal the reference engine's exactly,
for GPT-J and GPT, plain and at ``spec_k=3``, also across the SIGKILL of
the replica serving a stream. Around that: dict payloads,
``resume_tokens``, the deadline shed as 429, ``update_weights`` with a
module and a version (tokens then equal a reference engine born on seed
1) and with a port ``rlhf`` ``WeightUpdate`` manifest, the refusals (the
reference's manifest, a ``tp`` that does not divide the heads, a
GPU-asking app on a cluster without a GPU), the ``tp=`` overlay, a control plane that never
loads torch, an open-loop ``loadgen.run_curve`` through the proxy with its
latency attribution, and the Serve parts of ``tests/test_llm_engine.py``
(the streaming deployment, ``@serve.batch``'s gauges) and of
``tests/test_llm_spec.py`` (``TestAutoscalerSignals``).
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import ray_tpu_torch
from ray_tpu.llm import EngineConfig as RefEngineConfig
from ray_tpu.llm import LLMEngine as RefEngine
from ray_tpu.llm import SamplingParams as RefSamplingParams
from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.models.gpt import gpt_init as ref_gpt_init
from ray_tpu.models.gptj import GPTJConfig as RefGPTJConfig
from ray_tpu.models.gptj import gptj_init as ref_gptj_init
from ray_tpu_torch import serve
from ray_tpu_torch.exceptions import RayError
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.models.gpt import params_from_jax as gpt_params_from_jax
from ray_tpu_torch.models.gptj import GPTJConfig
from ray_tpu_torch.models.gptj import params_from_jax as gptj_params_from_jax
from ray_tpu_torch.serve.llm import LLMDeployment, build_llm_app

REPO = Path(__file__).resolve().parents[1]

ARCHS = {
    "gptj": dict(vocab_size=128, seq_len=64, d_model=32, n_layers=2, n_heads=2, rotary_dim=8,
                 dtype="float32"),
    "gpt": dict(vocab_size=128, seq_len=40, d_model=32, n_layers=2, n_heads=2, dtype="float32"),
}
PORT = {"gptj": (GPTJConfig, gptj_params_from_jax), "gpt": (GPTConfig, gpt_params_from_jax)}
REF = {"gptj": (RefGPTJConfig, ref_gptj_init), "gpt": (RefGPTConfig, ref_gpt_init)}
REF_EXTRA = dict(remat=False, attn_impl="xla", fused_loss=False)
GEOMETRY = dict(max_slots=3, num_blocks=40, block_size=4, max_blocks_per_seq=10, prefill_chunk=8)
PERIODIC = [5, 9, 7, 5, 9, 7, 5, 9, 7, 5]
N_NEW = 12


def _prompts():
    rng = np.random.RandomState(5)
    return [[int(t) for t in rng.randint(0, 128, n)] for n in (7, 13, 4, 19)]


@pytest.fixture(scope="module")
def weights():
    """{(arch, seed): (reference params, numpy tree)}, drawn once."""
    out = {}
    for arch, (cls, init) in REF.items():
        cfg = cls(**ARCHS[arch], **REF_EXTRA)
        for seed in (0, 1):
            ref = init(jax.random.PRNGKey(seed), cfg)
            out[arch, seed] = (ref, jax.device_get(ref))
    return out


def _port_params(weights, arch, seed=0):
    cls, from_jax = PORT[arch]
    return from_jax(weights[arch, seed][1], cls(**ARCHS[arch]), "cpu")


def _reference_tokens(weights, arch, prompts, spec_k=0, seed=0, max_tokens=N_NEW):
    cls, _ = REF[arch]
    eng = RefEngine(cls(**ARCHS[arch], **REF_EXTRA), weights[arch, seed][0],
                    RefEngineConfig(**GEOMETRY, spec_k=spec_k))
    return [list(eng.generate(p, RefSamplingParams(max_tokens=max_tokens))) for p in prompts]


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def serve_instance(cluster):
    yield
    serve.shutdown()


def _app(weights, arch, spec_k=0, name="LLMDeployment", **geometry):
    """A port LLMDeployment over the reference's seed-0 weights, with
    build_llm_app's stream contracts, on the CPU."""
    dep = serve.deployment(
        LLMDeployment, name=name, max_ongoing_requests=16,
        stream_resume_arg="resume_tokens", stream_deadline_arg="deadline_s",
    )
    return dep.bind(
        model=arch, model_cfg=PORT[arch][0](**ARCHS[arch]), params=_port_params(weights, arch),
        engine_config=EngineConfig(**{**GEOMETRY, **geometry}, spec_k=spec_k), device="cpu",
    )


def _proxy_port():
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    return ray_tpu_torch.get(controller.get_proxy_port.remote(), timeout=30)


def _post(url, body, timeout=120, headers=()):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **dict(headers)},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read(), dict(resp.headers)


@pytest.mark.parametrize("spec_k", [0, 3], ids=["plain", "spec_k3"])
@pytest.mark.parametrize("arch", ["gptj", "gpt"])
def test_handle_and_http_stream_the_reference_tokens(serve_instance, weights, arch, spec_k):
    prompts = _prompts() + ([PERIODIC] if spec_k else [])
    want = _reference_tokens(weights, arch, prompts, spec_k)
    handle = serve.run(_app(weights, arch, spec_k), name="llm", http=True, http_port=0)
    got = {}

    def stream(i, p):
        got[i] = list(handle.options(stream=True).remote(p, max_tokens=N_NEW))

    threads = [threading.Thread(target=stream, args=(i, p)) for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert [got[i] for i in range(len(prompts))] == want
    url = f"http://127.0.0.1:{_proxy_port()}/llm"
    for p, w in zip(prompts, want):
        status, body, headers = _post(url, {"prompt": p, "max_tokens": N_NEW},
                                      headers=[("x-request-id", f"req-{p[0]}")])
        assert status == 200 and headers["x-request-id"] == f"req-{p[0]}"
        assert headers["Transfer-Encoding"] == "chunked"
        assert [json.loads(line) for line in body.splitlines()] == w
    if spec_k:
        assert handle.stats.remote().result(timeout=30)["verify_steps"] > 0


KILL_GEOMETRY = dict(max_slots=2, num_blocks=128, block_size=4, max_blocks_per_seq=64, prefill_chunk=8)


@pytest.fixture(scope="module")
def long_weights():
    """{arch: (reference params, numpy tree)} at seq_len 260, for streams
    long enough that a kill lands in the middle of one."""
    out = {}
    for arch, (cls, init) in REF.items():
        cfg = cls(**{**ARCHS[arch], "seq_len": 260}, **REF_EXTRA)
        ref = init(jax.random.PRNGKey(0), cfg)
        out[arch] = (ref, jax.device_get(ref))
    return out


@pytest.mark.parametrize("spec_k", [0, 3], ids=["plain", "spec_k3"])
@pytest.mark.parametrize("arch", ["gptj", "gpt"])
def test_stream_across_a_replica_kill_is_the_reference_stream(serve_instance, long_weights, arch, spec_k):
    """Two replicas over the reference's weights; the replica serving a
    200-token greedy stream is SIGKILLed after its second token. The handle
    resumes the stream on the other replica with the delivered tokens, and
    the whole stream equals the reference engine's."""
    import signal

    from ray_tpu_torch._private import chaos

    ref_params, tree = long_weights[arch]
    ref_cls, _ = REF[arch]
    cls, from_jax = PORT[arch]
    cfg = cls(**{**ARCHS[arch], "seq_len": 260})
    prompt, n = [5, 6, 7] * 4, 200
    ref_eng = RefEngine(ref_cls(**{**ARCHS[arch], "seq_len": 260}, **REF_EXTRA), ref_params,
                        RefEngineConfig(**KILL_GEOMETRY, spec_k=spec_k))
    want = list(ref_eng.generate(prompt, RefSamplingParams(max_tokens=n)))
    dep = serve.deployment(LLMDeployment, num_replicas=2, max_ongoing_requests=16,
                           stream_resume_arg="resume_tokens", stream_deadline_arg="deadline_s")
    handle = serve.run(dep.bind(model=arch, model_cfg=cfg, params=from_jax(tree, cfg, "cpu"),
                                engine_config=EngineConfig(**KILL_GEOMETRY, spec_k=spec_k), device="cpu"),
                       name="llm")
    from ray_tpu_torch._private import events
    from ray_tpu_torch.util import tracing

    with tracing.trace_context() as rid:
        stream = handle.options(stream=True).remote(prompt, max_tokens=n)
        got, killed = [], None
        for tok in stream:
            got.append(tok)
            if len(got) == 2 and killed is None:
                killed = chaos.pid_of_actor(stream._replica._actor_id.hex())
                os.kill(killed, signal.SIGKILL)
    assert killed is not None
    assert got == want
    # the surviving replica took the stream over: its engine was handed the
    # delivered tokens (the dead replica's events died with it)
    deadline = time.time() + 30
    while not [e for e in events.collect_cluster_events(rid)
               if e["type"] == "llm.submit" and e.get("resumed", 0) >= 2]:
        assert time.time() < deadline, "no resumed llm.submit under the request id"
        time.sleep(0.2)


def test_dict_payloads_and_resume_tokens(serve_instance, weights):
    """Dict payloads carry the sampling knobs; ``resume_tokens`` continues
    a stream after the delivered prefix, token-identically (greedy against
    the reference, seeded sampling against a port engine on the same
    weights)."""
    prompt = _prompts()[1]
    want = _reference_tokens(weights, "gptj", [prompt])[0]
    handle = serve.run(_app(weights, "gptj"), name="llm")
    stream = handle.options(stream=True)
    assert list(stream.remote({"prompt": prompt, "max_tokens": N_NEW})) == want
    assert list(stream.remote({"prompt": prompt, "max_tokens": N_NEW, "resume_tokens": want[:5]})) == want[5:]
    # the handle's own journal (the failover contract's kwarg) concatenates
    # after a client-side resume
    assert list(stream.remote({"prompt": prompt, "max_tokens": N_NEW, "resume_tokens": want[:2]},
                              resume_tokens=want[2:6])) == want[6:]
    knobs = dict(max_tokens=N_NEW, temperature=0.8, top_k=20, top_p=0.9, seed=17)
    local = LLMEngine(GPTJConfig(**ARCHS["gptj"]), _port_params(weights, "gptj"),
                      EngineConfig(**GEOMETRY), device="cpu")
    sampled = list(local.generate(prompt, SamplingParams(**knobs)))
    assert list(stream.remote({"prompt": prompt, **knobs})) == sampled
    assert list(stream.remote({"prompt": prompt, **knobs, "resume_tokens": sampled[:4]})) == sampled[4:]
    assert handle.generate.remote(prompt, max_tokens=N_NEW).result(timeout=60) == want
    with pytest.raises(Exception, match="unknown payload keys"):
        list(stream.remote({"prompt": prompt, "bogus": 1}))


def test_deadline_shed_is_429_over_http(serve_instance, weights):
    """A doomed ``deadline_s`` behind a measured backlog is shed by the
    replica's engine as 429 + ``Retry-After``; the backlog completes."""
    handle = serve.run(_app(weights, "gptj", max_slots=1, num_blocks=64, max_blocks_per_seq=16),
                       name="llm", http=True, http_port=0)
    url = f"http://127.0.0.1:{_proxy_port()}/llm"
    prompt = _prompts()[0]
    assert _post(url, {"prompt": prompt, "max_tokens": 16})[0] == 200
    # a backlog deep enough to outlast the engine's 0.5 s rate window on a
    # fast CPU engine (the shed needs a measured rate AND a live backlog)
    backlog = [threading.Thread(target=_post, args=(url, {"prompt": prompt, "max_tokens": 56}), daemon=True)
               for _ in range(10)]
    for t in backlog:
        t.start()
    deadline = time.time() + 30
    while True:
        st = handle.stats.remote().result(timeout=30)
        if st["running"] + st["waiting"] >= 4 and st["service_rate_tokens_per_s"] > 0:
            break
        assert time.time() < deadline, f"backlog never formed: {st}"
        time.sleep(0.02)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, {"prompt": prompt, "max_tokens": 56, "deadline_s": 0.01})
    assert ei.value.code == 429
    assert int(ei.value.headers["Retry-After"]) >= 1
    for t in backlog:
        t.join(timeout=120)
        assert not t.is_alive()


@pytest.mark.parametrize("arch", ["gptj", "gpt"])
def test_update_weights_with_a_module_and_version(serve_instance, weights, arch):
    """A port parameter module and a version pushed through the handle:
    the replica's tokens become those of a reference engine born on seed
    1's weights."""
    prompts = _prompts()[:2]
    handle = serve.run(_app(weights, arch), name="llm")
    before = [handle.generate.remote(p, max_tokens=N_NEW).result(timeout=60) for p in prompts]
    assert before == _reference_tokens(weights, arch, prompts)
    assert handle.update_weights.remote(_port_params(weights, arch, seed=1), 5).result(timeout=60) == 5
    assert handle.weights_version.remote().result(timeout=30) == 5
    after = [handle.generate.remote(p, max_tokens=N_NEW).result(timeout=60) for p in prompts]
    assert after == _reference_tokens(weights, arch, prompts, seed=1)
    assert after != before


def test_weight_update_manifest_and_tp_raise(weights, cluster):
    """A port ``rlhf.sync.WeightUpdate`` manifest applies through
    ``rlhf.sync.apply_weight_update`` (the replica's weights become the
    pushed ones); the reference package's manifest, a dict and tensor
    parallelism raise, and none is half-done."""
    from ray_tpu.rlhf.sync import WeightUpdate as RefWeightUpdate
    from ray_tpu_torch.rlhf.sync import publish_weights

    dep = LLMDeployment(model="gptj", model_cfg=GPTJConfig(**ARCHS["gptj"]),
                        params=_port_params(weights, "gptj"), engine_config=EngineConfig(**GEOMETRY),
                        warmup=False, device="cpu")
    try:
        foreign = RefWeightUpdate(version=1, treedef=None, chunk_refs=[], chunk_sizes=[], nbytes=0,
                                  created_t=0.0)
        with pytest.raises(TypeError):
            dep.update_weights(foreign)
        with pytest.raises(TypeError):
            dep.update_weights({"embed": np.zeros(3)})
        assert dep.weights_version() == 0
        pushed = _port_params(weights, "gptj", seed=1)
        assert dep.update_weights(publish_weights(pushed, 3, chunk_bytes=64 << 10), timeout=30) == 3
        assert dep.weights_version() == 3
        for name, value in pushed.state_dict().items():
            assert torch.equal(dep._engine.runner.params.state_dict()[name], value), name
    finally:
        dep._stop.set()
        dep._engine._watchdog.stop()
    # tp is ported (llm.multichip): the overlay sets engine_config.tp, and a
    # replica on the card asks for a card per rank; a tp that does not
    # divide the heads raises before any follower starts
    app = build_llm_app(model="gptj", model_cfg=GPTJConfig(**ARCHS["gptj"]), tp=2, device="cpu")
    assert app.kwargs["tp"] == 2 and app.deployment.config.ray_actor_options == {}
    app = build_llm_app(model="gptj", engine_config=EngineConfig(**GEOMETRY, tp=2))
    assert app.deployment.config.ray_actor_options == {"num_gpus": 2}
    with pytest.raises(ValueError, match="not divisible"):
        LLMDeployment(model="gptj", model_cfg=GPTJConfig(**ARCHS["gptj"]),
                      engine_config=EngineConfig(**GEOMETRY, tp=3), device="cpu")


def test_gpu_app_without_a_gpu_fails_at_run(serve_instance):
    """Built for the card (the default), each replica asks for one GPU; on
    a cluster without one, ``serve.run`` raises the head's "has a GPU"
    refusal at once and no replica (no engine) is started."""
    app = build_llm_app(model="gptj", model_cfg=GPTJConfig(**ARCHS["gptj"]),
                        engine_config=EngineConfig(**GEOMETRY))
    assert app.deployment.config.ray_actor_options == {"num_gpus": 1}
    assert build_llm_app(device="cpu").deployment.config.ray_actor_options == {}
    t0 = time.monotonic()
    with pytest.raises(RayError, match="has a GPU"):
        serve.run(app, name="card")
    assert time.monotonic() - t0 < 30
    assert serve.status() == {}
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    assert ray_tpu_torch.get(controller.get_replica_actor_ids.remote(), timeout=30) == {}


def _pid_of(actor_id) -> int | None:
    """Worker pid of one live actor, by its id (bytes or hex)."""
    from ray_tpu_torch._private.chaos import pid_of_actor

    return pid_of_actor(actor_id.hex() if isinstance(actor_id, bytes) else str(actor_id))


def _listener_pids(port: int) -> list[int]:
    """Pids of the processes listening on a local TCP port."""
    import psutil

    return sorted({c.pid for c in psutil.net_connections("tcp")
                   if c.status == psutil.CONN_LISTEN and c.laddr.port == port})


def _actor_table() -> list[tuple]:
    """(class, state, pid) of every actor the head knows: the context of a
    failed process count."""
    from ray_tpu_torch._private.runtime import get_ctx

    head = get_ctx().head
    with head.lock:
        return [(a.create_spec.get("class_name"), a.state,
                 a.worker.proc.pid if a.worker is not None and a.worker.proc is not None else None)
                for a in head.actors.values()]


def _maps_torch(pid: int) -> list[str]:
    with open(f"/proc/{pid}/maps") as fh:
        return sorted({line.split()[-1] for line in fh
                       if "libtorch" in line or "libc10" in line or "libcuda" in line})


def test_control_plane_loads_no_torch(serve_instance, weights):
    """Importing ``ray_tpu_torch.serve`` (and ``serve.llm``) loads no torch,
    and with an LLM app serving over HTTP, the controller's and the
    proxy's processes have mapped no torch or CUDA library; the replica
    has."""
    code = ("import sys, ray_tpu_torch.serve, ray_tpu_torch.serve.llm, ray_tpu_torch.obs\n"
            "import ray_tpu_torch._private.chaos, ray_tpu_torch.serve._private.proxy\n"
            "import ray_tpu_torch.serve._private.grpc_proxy, ray_tpu_torch.serve._private.controller\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'ray_tpu'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    handle = serve.run(_app(weights, "gptj"), name="llm", http=True, http_port=0)
    assert len(list(handle.options(stream=True).remote(_prompts()[0], max_tokens=4))) == 4
    port = _proxy_port()
    _post(f"http://127.0.0.1:{port}/llm", {"prompt": [1, 2, 3], "max_tokens": 2})
    # this app's own processes, by the controller's name, the proxy's
    # listening socket and the controller's replica table
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    replica_ids = ray_tpu_torch.get(controller.get_replica_actor_ids.remote(), timeout=30)
    control = {"controller": [_pid_of(controller._actor_id)], "proxy": _listener_pids(port)}
    replicas = [_pid_of(a) for ids in replica_ids.values() for a in ids]
    assert all(len(p) == 1 and None not in p for p in control.values()), (control, _actor_table())
    assert len(replica_ids) == 1 and len(replicas) == 1 and None not in replicas, (replica_ids, replicas, _actor_table())
    assert {k: _maps_torch(p) for k, (p,) in control.items()} == {"controller": [], "proxy": []}, (
        control, _actor_table())
    assert _maps_torch(replicas[0]) != []


def test_loadgen_curve_through_the_proxy_is_attributed(serve_instance, weights):
    """``loadgen.run_curve`` drives the raw-socket open-loop client through
    the proxy into the replica: every request streams its tokens with an
    ``x-request-id``, and the phase ledgers of the proxy and the engine
    join into one decomposition per request whose phases sum to e2e."""
    from ray_tpu_torch.llm import loadgen

    serve.run(_app(weights, "gptj"), name="llm", http=True, http_port=0)
    prompts = _prompts()
    want = _reference_tokens(weights, "gptj", prompts, max_tokens=6)
    offsets = loadgen.arrivals("poisson", rate=40.0, duration_s=0.4, seed=1)[:8]
    assert len(offsets) >= 4
    recs = loadgen.run_curve(_proxy_port(), "llm", offsets,
                             lambda i: {"prompt": prompts[i % 4], "max_tokens": 6})
    assert all(r["status"] == 200 and r.get("request_id") for r in recs), recs
    summary = loadgen.summarize_client(recs, 1.0)
    assert summary["ok"] == len(offsets) and summary["ttft_s"]["count"] == len(offsets)
    rids = {r["request_id"] for r in recs}
    deadline = time.time() + 30
    while True:
        evs = loadgen._drain_phase_events()
        attr = loadgen._attribution_for(evs, rids, 0.05)
        if attr["n_requests"] == len(rids) and attr["scopes"]["proxy"] == len(rids):
            break
        assert time.time() < deadline, attr
        time.sleep(0.2)
    assert attr["within_eps"] == len(rids)
    # and the streams themselves
    url = f"http://127.0.0.1:{_proxy_port()}/llm"
    for p, w in zip(prompts, want):
        body = _post(url, {"prompt": p, "max_tokens": 6})[1]
        assert [json.loads(line) for line in body.splitlines()] == w


# ---------------------------------------------------------------------------
# the Serve parts of tests/test_llm_engine.py
# ---------------------------------------------------------------------------


def test_llm_deployment_streams_tokens(serve_instance, weights):
    """End-to-end through the serve stack with ``build_llm_app`` (weights
    from seed 0 in the replica, by the port's init): stream a completion,
    TTFT < total latency, ordering equal to a local port engine on the
    same draw, the blocking method path, and the autoscaling signals."""
    from ray_tpu_torch.models.gptj import gptj_init

    cfg = GPTJConfig(**ARCHS["gptj"])
    ecfg = EngineConfig(max_slots=2, num_blocks=32, block_size=4, max_blocks_per_seq=12, prefill_chunk=8)
    handle = serve.run(build_llm_app(model="gptj", model_cfg=cfg, engine_config=ecfg, device="cpu"),
                       name="llm")
    prompt = _prompts()[3][:10]
    n_new = 24
    t0 = time.monotonic()
    ttft = None
    streamed = []
    for tok in handle.options(stream=True).remote(prompt, max_tokens=n_new):
        if ttft is None:
            ttft = time.monotonic() - t0
        streamed.append(tok)
    total = time.monotonic() - t0
    assert ttft is not None and ttft < total, (ttft, total)
    local = LLMEngine(cfg, gptj_init(cfg, torch.Generator().manual_seed(0), "cpu"), ecfg, device="cpu")
    assert streamed == list(local.generate(prompt, SamplingParams(max_tokens=n_new)))
    assert handle.generate.remote(prompt, max_tokens=n_new).result(timeout=60) == streamed
    m = handle.autoscaling_metrics.remote().result(timeout=30)
    assert set(m) >= {"queue_depth", "kv_utilization", "running", "waiting"}
    assert m["running"] == 0 and m["queue_depth"] == 0


def test_batch_queue_exports_saturation_metrics():
    """@serve.batch queues expose depth + last-flush size (the signal
    surface replica autoscaling reads)."""
    from ray_tpu_torch.serve.batching import _BatchQueue

    class Model:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def predict(self, xs):
            time.sleep(0.02)
            return [x * 2 for x in xs]

    m = Model()
    results = []
    threads = [threading.Thread(target=lambda i=i: results.append(m.predict(i))) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(results) == [0, 2, 4, 6]
    q = getattr(m, "__serve_batch_queues_predict")[""]
    assert isinstance(q, _BatchQueue)
    assert q.last_flush_size >= 1
    assert q.queue_depth() == 0
    from ray_tpu_torch.util.metrics import collect

    data = collect()
    assert "serve_batch_queue_depth" in data["metrics"]
    assert "serve_batch_last_flush_size" in data["metrics"]


# ---------------------------------------------------------------------------
# TestAutoscalerSignals of tests/test_llm_spec.py
# ---------------------------------------------------------------------------


class TestAutoscalerSignals:
    def test_replica_exports_autoscaling_metrics(self):
        from ray_tpu_torch.serve._private.replica import Replica

        class Exporting:
            def __call__(self):
                return "ok"

            def autoscaling_metrics(self):
                return {"queue_depth": 7, "kv_utilization": 0.5}

        r = Replica("r#1", Exporting, (), {})
        m = r.get_metrics()
        assert m["autoscaling_metrics"] == {"queue_depth": 7, "kv_utilization": 0.5}

        class Plain:
            def __call__(self):
                return "ok"

        assert "autoscaling_metrics" not in Replica("r#2", Plain, (), {}).get_metrics()

    def test_desired_replicas_counts_queue_depth(self):
        from ray_tpu_torch.serve._private.common import AutoscalingConfig
        from ray_tpu_torch.serve._private.controller import desired_replicas

        cfg = AutoscalingConfig(min_replicas=1, max_replicas=8, target_ongoing_requests=2)
        base = [{"num_ongoing_requests": 2}]
        assert desired_replicas(cfg, base, current=1) == 1
        queued = [{"num_ongoing_requests": 2,
                   "autoscaling_metrics": {"queue_depth": 6, "kv_utilization": 0.2}}]
        assert desired_replicas(cfg, queued, current=1) == 4
        flood = [{"num_ongoing_requests": 2, "autoscaling_metrics": {"queue_depth": 100}}]
        assert desired_replicas(cfg, flood, current=1) == 8

    def test_desired_replicas_kv_pressure_scales_up(self):
        from ray_tpu_torch.serve._private.common import AutoscalingConfig
        from ray_tpu_torch.serve._private.controller import desired_replicas

        cfg = AutoscalingConfig(min_replicas=1, max_replicas=4, target_ongoing_requests=4,
                                kv_utilization_threshold=0.9)
        hot = [{"num_ongoing_requests": 1,
                "autoscaling_metrics": {"queue_depth": 0, "kv_utilization": 0.95}}]
        assert desired_replicas(cfg, hot, current=2) == 3
        cool = [{"num_ongoing_requests": 1,
                 "autoscaling_metrics": {"queue_depth": 0, "kv_utilization": 0.5}}]
        assert desired_replicas(cfg, cool, current=2) == 1

    def test_llm_deployment_signals_reach_the_decision(self, weights):
        """End-to-end minus actors: an LLMDeployment replica's exported
        metrics, fed through the controller's pure decision function."""
        from ray_tpu_torch.serve._private.common import AutoscalingConfig
        from ray_tpu_torch.serve._private.controller import desired_replicas
        from ray_tpu_torch.serve._private.replica import Replica

        r = Replica(
            "llm#1", LLMDeployment, (),
            dict(model="gptj", model_cfg=GPTJConfig(**ARCHS["gptj"]), params=_port_params(weights, "gptj"),
                 engine_config=EngineConfig(max_slots=1, num_blocks=16, block_size=4,
                                            max_blocks_per_seq=8, prefill_chunk=8),
                 warmup=False, device="cpu"),
        )
        eng = r._callable._engine
        try:
            # no loop thread drains the engine: the replica's is stopped
            # first, so the submitted requests pile up as queue depth
            # behind the single slot
            r._callable._stop.set()
            r._callable._loop.join(timeout=30)
            for _ in range(5):
                eng.submit([1, 2, 3], SamplingParams(max_tokens=4))
            m = r.get_metrics()
            am = m["autoscaling_metrics"]
            assert am["queue_depth"] >= 4
            cfg = AutoscalingConfig(min_replicas=1, max_replicas=4, target_ongoing_requests=2)
            assert desired_replicas(cfg, [m], current=1) > 1
        finally:
            eng._watchdog.stop()


# ---------------------------------------------------------------------------
# the engine lock's hand-off to callers (what a replica's request threads
# need from a busy step loop)
# ---------------------------------------------------------------------------


def test_busy_loop_hands_the_lock_to_waiting_callers(weights):
    """With ``run_loop`` busy on a long request, 12 caller threads (more than
    the cores a test worker gets) call ``stats()``, ``has_work()`` and
    ``submit()`` under a shortened switch interval: each gets the lock
    between two steps, long before the backlog ends, every submitted
    request completes, and the waiting count returns to 0."""
    cfg = GPTJConfig(**{**ARCHS["gptj"], "seq_len": 260})
    eng = LLMEngine(cfg, _port_params(weights, "gptj"),
                    EngineConfig(max_slots=2, num_blocks=140, block_size=4, max_blocks_per_seq=64,
                                 prefill_chunk=8), device="cpu")
    stop = threading.Event()
    loop = threading.Thread(target=eng.run_loop, args=(stop,), daemon=True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        loop.start()
        long = eng.submit(_prompts()[0], SamplingParams(max_tokens=240))
        while not long.out:
            time.sleep(0.001)
        seen, reqs, errors = [], [], []

        def caller(i):
            try:
                for _ in range(3):
                    st = eng.stats()
                    seen.append((long.finished, st["running"]))
                    eng.has_work()
                reqs.append(eng.submit([i + 1, 2, 3], SamplingParams(max_tokens=4)))
            except BaseException as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=caller, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not errors
        # every caller got the lock while the long request was still running
        assert len(seen) == 36 and not any(done for done, _ in seen)
        for r in reqs:
            assert len(list(eng.stream_tokens(r, timeout=60))) == 4
        assert len(list(eng.stream_tokens(long, timeout=120))) == 240
        assert eng._callers_waiting == 0
    finally:
        sys.setswitchinterval(old)
        stop.set()
        loop.join(timeout=30)
    assert not loop.is_alive()
