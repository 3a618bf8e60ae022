"""The port's Serve hardening (``ray_tpu_torch.serve``), mirroring
``tests/test_serve_hardening.py``: per-node proxies, streaming responses
over streaming-generator returns, long-poll config push (no router
polling), non-JSON bodies. One cluster per module; the per-node test adds
and removes its own node.

Reference: ``serve/_private/proxy.py:759`` (streaming ASGI responses, one
proxy per node), ``serve/_private/long_poll.py`` (LongPollHost pushing
config to routers)."""

import http.client
import json
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def _cluster():
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def serve_instance(_cluster):
    yield
    serve.shutdown()


def test_streaming_http_endpoint(serve_instance):
    @serve.deployment
    def tokens(payload):
        n = (payload or {}).get("n", 3)
        for i in range(n):
            time.sleep(0.5)
            yield {"token": i}

    serve.run(tokens.bind(), name="stream", http=True, http_port=0)
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    port = ray_tpu_torch.get(controller.get_proxy_port.remote(), timeout=30)

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    t0 = time.monotonic()
    conn.request(
        "POST", "/stream", body=json.dumps({"n": 4}),
        headers={"Content-Type": "application/json"},
    )
    resp = conn.getresponse()
    assert resp.status == 200
    first = resp.readline()  # HTTPResponse de-chunks transparently
    t_first = time.monotonic() - t0
    items = [json.loads(first)]
    for line in resp:
        if line.strip():
            items.append(json.loads(line))
    t_all = time.monotonic() - t0
    conn.close()
    assert items == [{"token": i} for i in range(4)]
    # the first chunk must arrive while the producer is still generating
    assert t_first < t_all - 1.0, (t_first, t_all)


def test_streaming_handle(serve_instance):
    @serve.deployment
    class Gen:
        def __call__(self, n):
            for i in range(n):
                yield i * 2

    handle = serve.run(Gen.bind(), name="genapp", http=False)
    out = list(handle.options(stream=True).remote(5))
    assert out == [0, 2, 4, 6, 8]


def test_non_json_bodies(serve_instance):
    @serve.deployment
    class Bytes:
        def __call__(self, payload):
            assert isinstance(payload, bytes)
            return payload[::-1]  # bytes in, bytes out

    serve.run(Bytes.bind(), name="raw", http=True, http_port=0)
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    port = ray_tpu_torch.get(controller.get_proxy_port.remote(), timeout=30)

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/raw",
        data=b"\x00\x01binary\xff",
        headers={"Content-Type": "application/octet-stream"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.headers.get("Content-Type") == "application/octet-stream"
        assert resp.read() == b"\x00\x01binary\xff"[::-1]


def test_no_steady_state_polling(serve_instance):
    """Routers get config PUSHED via the controller long-poll: after warmup,
    serving requests must not add a single get_replicas pull."""

    @serve.deployment
    def double(x):
        return x * 2

    handle = serve.run(double.bind(), name="lp", http=False)
    assert handle.remote(4).result(timeout=30) == 8  # warm the router
    time.sleep(1.0)  # let any startup pulls settle
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    before = ray_tpu_torch.get(controller.get_pull_count.remote(), timeout=30)
    for i in range(25):
        assert handle.remote(i).result(timeout=30) == 2 * i
    after = ray_tpu_torch.get(controller.get_pull_count.remote(), timeout=30)
    assert after == before, f"routers pulled {after - before} times in steady state"


def test_per_node_proxies_and_failover(serve_instance):
    """One proxy per alive node; with a node (and its proxy) gone, the
    surviving node's proxy still serves."""
    from ray_tpu_torch._private.runtime import get_ctx

    head = get_ctx().head
    node2 = head.add_node({"CPU": 4.0})

    @serve.deployment(num_replicas=2)
    def ping(x):
        return {"pong": x}

    serve.run(ping.bind(), name="ha", http=True, http_port=0)
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")

    deadline = time.monotonic() + 30
    ports = {}
    while time.monotonic() < deadline:
        ports = ray_tpu_torch.get(controller.get_proxy_ports.remote(), timeout=30)
        if len(ports) >= 2:
            break
        time.sleep(0.25)
    assert len(ports) >= 2, f"expected a proxy per node, got {ports}"

    def get_via(port, i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/ha",
            data=json.dumps(i).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    for port in ports.values():
        assert get_via(port, 7) == {"pong": 7}

    # kill node 2: its proxy (and any replicas there) die with it
    head.remove_node(node2)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        left = ray_tpu_torch.get(controller.get_proxy_ports.remote(), timeout=30)
        if node2.binary().hex() not in left:
            break
        time.sleep(0.25)
    survivor_ports = ray_tpu_torch.get(controller.get_proxy_ports.remote(), timeout=30)
    assert survivor_ports, "no proxy survived"
    deadline = time.monotonic() + 60
    while True:
        try:
            assert get_via(list(survivor_ports.values())[0], 9) == {"pong": 9}
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)
