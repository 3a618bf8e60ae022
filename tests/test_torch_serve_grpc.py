"""The port's Serve gRPC ingress, mirroring ``tests/test_serve_grpc.py``
(reference: ``serve/_private/proxy.py:542`` gRPCProxy + ``tests/test_grpc.py``
themes — generic-service variant, no codegen).

Payload contract: raw-bytes passthrough by DEFAULT;
pickle/json are per-deployment opt-ins (``grpc_codec=``). A non-Python
client sending pickle-shaped bytes must receive them verbatim unless the
deployment opted in — unpickling untrusted ingress is an RCE surface.
"""

import json
import pickle

import pytest

pytest.importorskip("grpc")

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve._private.grpc_proxy import SERVICE, grpc_channel_call


@pytest.fixture(scope="module")
def _cluster():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_regular(_cluster):
    yield


@pytest.fixture
def serve_shutdown():
    yield
    serve.shutdown()


def _grpc_addr():
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    port = ray_tpu_torch.get(controller.get_grpc_proxy_port.remote(), timeout=30)
    return f"127.0.0.1:{port}"


def test_grpc_default_is_verbatim_bytes(ray_start_regular, serve_shutdown):
    """Pickle-SHAPED bytes from a non-Python client come back verbatim:
    the proxy must not probe-unpickle them."""
    seen = []

    @serve.deployment
    class Echo:
        def __call__(self, x):
            # the deployment sees raw bytes, exactly as sent
            return x

    serve.run(Echo.bind(), name="echo", grpc=True)
    addr = _grpc_addr()

    pickled = pickle.dumps({"cmd": "rm -rf"})  # a valid pickle on the wire
    out = grpc_channel_call(addr, "echo", pickled)  # default bytes codec
    assert out == pickled  # verbatim — NOT the unpickled dict

    assert grpc_channel_call(addr, "echo", b"\x00raw") == b"\x00raw"
    # str responses are utf-8 bytes on the wire
    assert grpc_channel_call(addr, "echo", "text") == b"text"


def test_grpc_pickle_codec_opt_in(ray_start_regular, serve_shutdown):
    @serve.deployment(grpc_codec="pickle")
    class Doubler:
        def __call__(self, x):
            return {"doubled": x * 2}

    serve.run(Doubler.bind(), name="double", grpc=True)
    addr = _grpc_addr()
    assert grpc_channel_call(addr, "double", 21, codec="pickle") == {"doubled": 42}

    # malformed pickle to an opted-in app is the client's error
    import grpc

    with grpc.insecure_channel(addr) as ch:
        fn = ch.unary_unary(f"/{SERVICE}/Predict")
        with pytest.raises(grpc.RpcError) as e:
            fn(b"\x00not-a-pickle", metadata=(("application", "double"),), timeout=10)
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_grpc_json_codec(ray_start_regular, serve_shutdown):
    @serve.deployment(grpc_codec="json")
    class Sum:
        def __call__(self, req):
            return {"sum": sum(req["values"])}

    serve.run(Sum.bind(), name="sum", grpc=True)
    addr = _grpc_addr()
    assert grpc_channel_call(addr, "sum", {"values": [1, 2, 3]}, codec="json") == {
        "sum": 6
    }

    # wire format really is JSON (interop: any language can call this)
    import grpc

    with grpc.insecure_channel(addr) as ch:
        fn = ch.unary_unary(f"/{SERVICE}/Predict")
        raw = fn(
            json.dumps({"values": [4, 5]}).encode(),
            metadata=(("application", "sum"),),
            timeout=10,
        )
        assert json.loads(raw.decode()) == {"sum": 9}
        with pytest.raises(grpc.RpcError) as e:
            fn(b"{nope", metadata=(("application", "sum"),), timeout=10)
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_grpc_bytes_codec_rejects_nonbytes_response(ray_start_regular, serve_shutdown):
    import grpc

    @serve.deployment  # default bytes codec, but returns a dict
    class Bad:
        def __call__(self, x):
            return {"oops": 1}

    serve.run(Bad.bind(), name="bad", grpc=True)
    with pytest.raises(grpc.RpcError) as e:
        grpc_channel_call(_grpc_addr(), "bad", b"x")
    assert e.value.code() == grpc.StatusCode.INTERNAL
    assert "grpc_codec" in e.value.details()


def test_grpc_errors_surface_as_status(ray_start_regular, serve_shutdown):
    import grpc

    @serve.deployment(grpc_codec="pickle")
    class Boom:
        def __call__(self, x):
            raise ValueError("kapow")

    serve.run(Boom.bind(), name="boom", grpc=True)
    addr = _grpc_addr()

    with pytest.raises(grpc.RpcError) as e:
        grpc_channel_call(addr, "boom", 1, codec="pickle")
    assert e.value.code() == grpc.StatusCode.INTERNAL
    assert "kapow" in e.value.details()

    with pytest.raises(grpc.RpcError) as e:
        grpc_channel_call(addr, "no-such-app", b"1")
    assert e.value.code() == grpc.StatusCode.NOT_FOUND

    # missing application metadata
    with grpc.insecure_channel(addr) as ch:
        fn = ch.unary_unary(f"/{SERVICE}/Predict")
        with pytest.raises(grpc.RpcError) as e:
            fn(b"1", timeout=10)
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_grpc_streaming(ray_start_regular, serve_shutdown):
    @serve.deployment(grpc_codec="pickle")
    class Counter:
        def __call__(self, n):
            for i in range(n):
                yield {"i": i}

    serve.run(Counter.bind(), name="count", grpc=True)
    items = grpc_channel_call(
        _grpc_addr(), "count", 4, stream=True, codec="pickle"
    )
    assert items == [{"i": i} for i in range(4)]
