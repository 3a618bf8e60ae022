"""gRPC ingress for Serve applications (copy of
``ray_tpu/serve/_private/grpc_proxy.py``; ``grpc`` is imported where it is
used, so importing this module needs no gRPC).

Reference: ``python/ray/serve/_private/proxy.py:542`` (``gRPCProxy``) — the
reference mounts user-supplied grpc servicer functions and routes by the
``application`` request metadata. Same routing contract here, behind a
GENERIC service so no proto compilation is required on either side:

* service: ``ray.serve.GenericService``
* methods: ``Predict`` (unary-unary), ``PredictStream`` (unary-stream)
* request/response payloads: raw bytes by default — they reach the
  deployment VERBATIM and the response must be bytes/str. Deserialization
  is a per-deployment opt-in (``@serve.deployment(grpc_codec="pickle")``
  for trusted intra-cluster Python clients, or ``"json"``): running
  ``pickle.loads`` on whatever an untrusted client sends is an RCE
  surface, so the proxy never probes payloads (the reference routes typed
  protos only, ``serve/_private/proxy.py:542`` — same trust posture).
* routing: ``application`` metadata key names the target app (its ingress
  deployment, per the controller's record).

A typed client stub can still be used against this surface by registering
its serialized request bytes — the reference's typed-proto mode is a
documented departure (COVERAGE.md): it needs user proto descriptors
shipped to the proxy, which the lite design trades for zero codegen.
"""

from __future__ import annotations

import json
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

SERVICE = "ray.serve.GenericService"
CODECS = ("bytes", "pickle", "json")


def _decode(data: bytes, codec: str, context):
    """Request bytes -> deployment argument, per the app's declared codec.
    Malformed opt-in payloads are the CLIENT's error (INVALID_ARGUMENT),
    never silently passed through."""
    import grpc

    if codec == "pickle":
        try:
            return pickle.loads(data)
        except Exception:  # noqa: BLE001
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, "request is not a valid pickle"
            )
    if codec == "json":
        try:
            return json.loads(data.decode("utf-8"))
        except Exception:  # noqa: BLE001
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, "request is not valid JSON"
            )
    return data  # bytes: verbatim


def _encode(value, codec: str, context) -> bytes:
    import grpc

    if codec == "pickle":
        return pickle.dumps(value)
    if codec == "json":
        try:
            return json.dumps(value).encode("utf-8")
        except (TypeError, ValueError) as e:
            context.abort(
                grpc.StatusCode.INTERNAL, f"response not JSON-serializable: {e}"
            )
    if isinstance(value, (bytes, bytearray, memoryview)):
        return bytes(value)
    if isinstance(value, str):
        return value.encode("utf-8")
    context.abort(
        grpc.StatusCode.INTERNAL,
        f"bytes-codec deployment returned {type(value).__name__}; return "
        f"bytes/str or declare grpc_codec='pickle'/'json' on the deployment",
    )


class GrpcProxyActor:
    """gRPC server routing GenericService calls to deployment handles
    (actor: lives in its own worker process, like the HTTP ProxyActor)."""

    def __init__(self, port: int = 0):
        import grpc

        self._handles: dict[str, tuple] = {}
        self._pool = ThreadPoolExecutor(max_workers=32, thread_name_prefix="grpc-proxy")
        self._server = grpc.server(self._pool, options=[("grpc.so_reuseport", 0)])
        self._server.add_generic_rpc_handlers((self._make_handler(),))
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")
        if self.port == 0:
            raise RuntimeError(f"gRPC proxy could not bind port {port}")
        self._server.start()

    # -- routing ------------------------------------------------------------

    def _handle_for(self, app: str):
        import ray_tpu_torch
        from ray_tpu_torch.serve._private.common import CONTROLLER_NAME
        from ray_tpu_torch.serve.handle import DeploymentHandle

        import time

        ttl = 10.0
        ent = self._handles.get(app)
        now = time.monotonic()
        if ent is not None and now < ent[3]:
            return ent[:3]
        # TTL refresh: a redeploy can CHANGE the codec/streaming contract —
        # a forever-cache would keep unpickling after an operator hardened
        # the app to bytes (the exact hole this codec design closes). One
        # control RPC per app per window is noise.
        try:
            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            info = ray_tpu_torch.get(
                controller.get_ingress_info.remote(app), timeout=10
            )
        except Exception:
            if ent is not None:
                # controller restarting: serve the STALE contract rather
                # than failing healthy replicas (re-check next window)
                self._handles[app] = (*ent[:3], now + ttl, ent[4])
                return ent[:3]
            raise
        if info is None:
            self._handles.pop(app, None)
            raise KeyError(f"no serve application {app!r}")
        if ent is not None and ent[4] == info["deployment"]:
            handle = ent[0]  # same target: keep the warm handle/router
        else:
            handle = DeploymentHandle(info["deployment"])
        ent = (
            handle,
            bool(info["streaming"]),
            info.get("codec", "bytes"),
            now + ttl,
            info["deployment"],
        )
        self._handles[app] = ent
        return ent[:3]

    def _app_of(self, context) -> str:
        md = dict(context.invocation_metadata())
        app = md.get("application")
        if not app:
            import grpc

            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "missing 'application' request metadata",
            )
        return app

    # -- grpc plumbing -------------------------------------------------------

    def _make_handler(self):
        import grpc

        actor = self

        # NB: context.abort() raises to unwind — it must NOT sit inside a
        # broad except, or every abort gets re-reported as INTERNAL

        def _resolve(context):
            app = actor._app_of(context)  # aborts INVALID_ARGUMENT itself
            try:
                return actor._handle_for(app)
            except KeyError as e:
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))

        def predict(request: bytes, context) -> bytes:
            handle, streaming, codec = _resolve(context)
            if streaming:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    "streaming app: call PredictStream",
                )
            payload = _decode(request, codec, context)
            try:
                result = handle.remote(payload).result(timeout=120)
            except Exception as e:  # noqa: BLE001 - deployment errors -> status
                context.abort(grpc.StatusCode.INTERNAL, repr(e))
            return _encode(result, codec, context)

        def predict_stream(request: bytes, context):
            handle, streaming, codec = _resolve(context)
            payload = _decode(request, codec, context)

            def items():
                if streaming:
                    yield from handle.options(stream=True).remote(payload)
                else:  # unary app: stream of one
                    yield handle.remote(payload).result(timeout=120)

            it = items()
            while True:
                try:
                    item = next(it)
                except StopIteration:
                    return
                except Exception as e:  # noqa: BLE001 - deployment errors
                    context.abort(grpc.StatusCode.INTERNAL, repr(e))
                # encode OUTSIDE the except: its aborts must not be
                # re-reported as INTERNAL deployment failures
                yield _encode(item, codec, context)

        handlers = {
            "Predict": grpc.unary_unary_rpc_method_handler(predict),
            "PredictStream": grpc.unary_stream_rpc_method_handler(predict_stream),
        }

        class _Generic(grpc.GenericRpcHandler):
            def service(self, call_details):
                _, _, method = call_details.method.rpartition("/")
                svc = call_details.method.rsplit("/", 2)[-2] if call_details.method.count("/") >= 2 else ""
                if svc != SERVICE:
                    return None
                return handlers.get(method)

        return _Generic()

    def get_port(self) -> int:
        return self.port

    def ready(self) -> bool:
        return True

    def shutdown(self) -> bool:
        self._server.stop(grace=1.0).wait(timeout=5)
        return True


def _client_pack(payload, codec: str) -> bytes:
    if codec == "pickle":
        return pickle.dumps(payload)
    if codec == "json":
        return json.dumps(payload).encode("utf-8")
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return bytes(payload)
    if isinstance(payload, str):
        return payload.encode("utf-8")
    raise TypeError(
        f"bytes codec needs bytes/str payload, got {type(payload).__name__}"
    )


def _client_unpack(data: bytes, codec: str):
    if codec == "pickle":
        return pickle.loads(data)
    if codec == "json":
        return json.loads(data.decode("utf-8"))
    return data


def grpc_channel_call(
    address: str,
    app: str,
    payload,
    timeout_s: float = 30.0,
    stream: bool = False,
    codec: str = "bytes",
):
    """Client-side convenience (tests + python callers without stubs): one
    Predict/PredictStream call against a running gRPC proxy. ``codec`` must
    match the target deployment's ``grpc_codec`` declaration."""
    import grpc

    with grpc.insecure_channel(address) as channel:
        md = (("application", app),)
        data = _client_pack(payload, codec)
        if stream:
            fn = channel.unary_stream(
                f"/{SERVICE}/PredictStream",
                request_serializer=None,
                response_deserializer=None,
            )
            return [
                _client_unpack(b, codec)
                for b in fn(data, metadata=md, timeout=timeout_s)
            ]
        fn = channel.unary_unary(
            f"/{SERVICE}/Predict",
            request_serializer=None,
            response_deserializer=None,
        )
        return _client_unpack(fn(data, metadata=md, timeout=timeout_s), codec)
