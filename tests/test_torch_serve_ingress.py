"""The port's Serve ingress (``ray_tpu_torch.serve``), mirroring
``tests/test_serve_ingress.py``: asyncio+h11 proxy concurrency, declarative
config deploy, graceful replica drain on downscale. One cluster per module.

Reference: ``serve/_private/proxy.py:759`` (uvicorn/ASGI ingress — the
asyncio proxy is its stdlib counterpart), ``serve/schema.py`` (declarative
deploy), ``deployment_state.py`` graceful_shutdown_timeout_s drain.
"""

import asyncio
import json
import sys
import textwrap
import time

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


def _proxy_port():
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    return ray_tpu_torch.get(controller.get_proxy_port.remote(), timeout=30)


async def _one_request(port: int, app: str, body: bytes) -> tuple[int, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(
        f"POST /{app} HTTP/1.1\r\nhost: x\r\ncontent-type: application/json\r\n"
        f"content-length: {len(body)}\r\nconnection: close\r\n\r\n".encode() + body
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ")[1])
    return status, payload


def test_concurrent_load_500_inflight(serve_instance):
    """≥500 requests in flight at once: the asyncio proxy must hold them all
    concurrently (the old thread-per-request server pinned one OS thread
    each). Serial execution would take 500×0.5s≈250s; concurrent far less."""

    @serve.deployment(max_ongoing_requests=600)
    def slow(payload):
        time.sleep(0.5)
        return {"ok": payload["i"]}

    serve.run(slow.bind(), name="load", http=True, http_port=0)
    port = _proxy_port()

    async def fire():
        tasks = [
            _one_request(port, "load", json.dumps({"i": i}).encode())
            for i in range(500)
        ]
        return await asyncio.gather(*tasks)

    t0 = time.monotonic()
    results = asyncio.run(fire())
    wall = time.monotonic() - t0
    assert len(results) == 500
    assert all(status == 200 for status, _ in results), results[:3]
    got = sorted(json.loads(p)["ok"] for _, p in results)
    assert got == list(range(500))
    # generous bound for a 1-core CI box; serial would be ≥250s
    assert wall < 120, f"500 concurrent requests took {wall:.1f}s"


def test_keepalive_connection_reuse(serve_instance):
    """h11 cycle reuse: multiple requests over ONE connection."""

    @serve.deployment
    def echo(payload):
        return {"v": payload["v"]}

    serve.run(echo.bind(), name="ka", http=True, http_port=0)
    port = _proxy_port()

    async def run_two():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        out = []
        for v in (1, 2):
            body = json.dumps({"v": v}).encode()
            writer.write(
                f"POST /ka HTTP/1.1\r\nhost: x\r\ncontent-type: application/json\r\n"
                f"content-length: {len(body)}\r\n\r\n".encode() + body
            )
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            length = int(
                [l for l in head.lower().split(b"\r\n") if b"content-length" in l][0]
                .split(b":")[1]
            )
            out.append(json.loads(await reader.readexactly(length)))
        writer.close()
        return out

    assert asyncio.run(run_two()) == [{"v": 1}, {"v": 2}]


def test_run_config_yaml_e2e(serve_instance, tmp_path):
    """Declarative deploy: yaml → run_config → overrides applied → HTTP.
    The app module has a name of its own, and leaves ``sys.modules`` as it
    found it: the reference's mirror of this test writes a ``cfg_app``
    module of its own, and one pytest process may run both files."""
    mod_dir = tmp_path / "mods"
    mod_dir.mkdir()
    (mod_dir / "torch_cfg_app.py").write_text(
        textwrap.dedent(
            """
            from ray_tpu_torch import serve

            @serve.deployment
            def greeter(payload):
                return {"hello": (payload or {}).get("who", "world")}

            app = greeter.bind()
            """
        )
    )
    sys.path.insert(0, str(mod_dir))
    try:
        cfg = tmp_path / "serve.yaml"
        cfg.write_text(
            textwrap.dedent(
                """
                proxy:
                  port: 0
                applications:
                  - name: hello
                    import_path: torch_cfg_app:app
                    deployments:
                      - name: greeter
                        num_replicas: 2
                        max_ongoing_requests: 32
                """
            )
        )
        handles = serve.run_config(str(cfg))
        assert handles == {"hello": "hello_greeter"}
        # override applied?
        controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
        st = ray_tpu_torch.get(
            controller.get_deployment_status.remote("hello_greeter"), timeout=30
        )
        assert st["target_replicas"] == 2
        port = _proxy_port()
        status, payload = asyncio.run(
            _one_request(port, "hello", json.dumps({"who": "cfg"}).encode())
        )
        assert status == 200 and json.loads(payload) == {"hello": "cfg"}
    finally:
        sys.path.remove(str(mod_dir))
        sys.modules.pop("torch_cfg_app", None)


def test_graceful_drain_on_downscale(serve_instance):
    """In-flight requests on a downscale victim complete before the kill
    (the old path killed the actor immediately — mid-request errors)."""

    @serve.deployment(num_replicas=2, max_ongoing_requests=8,
                      graceful_shutdown_timeout_s=30)
    def slow(payload):
        time.sleep(3.0)
        return {"done": payload["i"]}

    handle = serve.run(slow.bind(), name="drain")
    # saturate BOTH replicas with in-flight work
    responses = [handle.remote({"i": i}) for i in range(4)]
    time.sleep(0.5)  # let them land on the replicas

    # downscale to 1 while those requests are running
    serve.run(slow.options(num_replicas=1).bind(), name="drain", _blocking=False)

    # every in-flight request must still complete
    results = sorted(r.result(timeout=60)["done"] for r in responses)
    assert results == [0, 1, 2, 3]

    # and the victim is eventually killed (drain completes)
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    deadline = time.time() + 30
    while time.time() < deadline:
        st = ray_tpu_torch.get(
            controller.get_deployment_status.remote("drain_slow"), timeout=30
        )
        if st["running_replicas"] == 1 and len(st["replica_ids"]) == 1:
            break
        time.sleep(0.25)
    else:
        raise AssertionError(f"victim replica never finished draining: {st}")

    # the survivor keeps serving
    assert handle.remote({"i": 9}).result(timeout=30) == {"done": 9}
