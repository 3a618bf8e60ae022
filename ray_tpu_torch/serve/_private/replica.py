"""Replica: the actor that hosts one copy of a deployment's user callable
(copy of ``ray_tpu/serve/_private/replica.py``).

Reference: ``serve/_private/replica.py:233`` (ReplicaActor wraps the user
callable via UserCallableWrapper, tracks ongoing requests, exposes
reconfigure/health hooks). A replica is the unit that owns a model on its
device — concurrent requests enter on the actor's thread pool
(``max_concurrency = max_ongoing_requests``) and meet the model through
``@serve.batch`` (or a continuous-batching engine) so the device sees one
large batched call instead of N singles. The replica is where a spec's
``Sealed`` class and arguments are opened.
"""

from __future__ import annotations

import threading
import time
from typing import Any


class Replica:
    """Actor body. Spawned by the controller with
    ``max_concurrency=max_ongoing_requests`` so requests execute in parallel
    threads up to the configured limit."""

    def __init__(self, replica_id: str, callable_cls, init_args, init_kwargs, user_config=None):
        self.replica_id = replica_id
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        from ray_tpu_torch.serve._private.common import unseal

        # always a class — function deployments are wrapped by the api layer
        self._callable = unseal(callable_cls)(*unseal(init_args), **unseal(init_kwargs))
        if user_config is not None:
            self.reconfigure(user_config)

    # -- request path ------------------------------------------------------

    def handle_request(self, method: str, args: tuple, kwargs: dict, model_id=None) -> Any:
        from ray_tpu_torch._private import events as _events
        from ray_tpu_torch.serve.multiplex import _set_request_model_id
        from ray_tpu_torch.util import tracing as _tracing

        with self._lock:
            self._ongoing += 1
            self._total += 1
        _set_request_model_id(model_id)
        # worker_main installed the proxy/submitter trace context on this
        # thread; the span + events below correlate under that request_id
        rid = _tracing.current_request_id()
        _events.record(
            "replica.request", request_id=rid,
            replica=self.replica_id, method=method,
        )
        try:
            with _tracing.span("replica_handle", replica=self.replica_id, method=method):
                target = self._callable if method == "__call__" else getattr(self._callable, method)
                if method == "__call__" and not callable(target):
                    raise TypeError(f"Deployment {type(self._callable).__name__} is not callable")
                return target(*args, **kwargs)
        finally:
            _events.record(
                "replica.done", request_id=rid, replica=self.replica_id
            )
            _set_request_model_id(None)
            with self._lock:
                self._ongoing -= 1

    def handle_request_streaming(self, method: str, args: tuple, kwargs: dict, model_id=None):
        """Generator variant: invoked with ``num_returns="streaming"`` so
        every yielded item becomes its own object as it is produced
        (reference: serve streaming responses over generator returns).
        Ongoing-count spans the WHOLE stream (admission control sees a
        streaming request as occupying its slot until exhausted)."""
        from ray_tpu_torch._private import events as _events
        from ray_tpu_torch.serve.multiplex import _set_request_model_id
        from ray_tpu_torch.util import tracing as _tracing

        with self._lock:
            self._ongoing += 1
            self._total += 1
        _set_request_model_id(model_id)
        rid = _tracing.current_request_id()
        _events.record(
            "replica.request", request_id=rid,
            replica=self.replica_id, method=method, streaming=True,
        )
        try:
            target = self._callable if method == "__call__" else getattr(self._callable, method)
            out = target(*args, **kwargs)
            import inspect

            if inspect.isasyncgen(out):
                # async-generator deployments stream too: drive the agen on
                # a private loop, yielding each item into the sync stream
                import asyncio

                loop = asyncio.new_event_loop()
                try:
                    while True:
                        try:
                            yield loop.run_until_complete(out.__anext__())
                        except StopAsyncIteration:
                            break
                finally:
                    loop.close()
            else:
                yield from out
        finally:
            _events.record(
                "replica.done", request_id=rid,
                replica=self.replica_id, streaming=True,
            )
            _set_request_model_id(None)
            with self._lock:
                self._ongoing -= 1

    # -- control plane -----------------------------------------------------

    def reconfigure(self, user_config) -> bool:
        """Reference: replicas forward user_config updates to the user
        class's ``reconfigure`` method without a restart."""
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return True

    def get_metrics(self) -> dict:
        m = {
            "replica_id": self.replica_id,
            "num_ongoing_requests": self._ongoing,
            "num_total_requests": self._total,
            "timestamp": time.time(),
        }
        # deployment-exported saturation signals (e.g. serve.llm's queue
        # depth / KV utilization): a continuous-batching replica absorbs
        # many requests per slot set, so ongoing counts alone under-report
        # load — the controller folds these into its scaling decision
        fn = getattr(self._callable, "autoscaling_metrics", None)
        if fn is not None:
            try:
                custom = fn()
                if isinstance(custom, dict):
                    m["autoscaling_metrics"] = custom
            except Exception:  # raylint: disable=RL007
                pass  # a broken exporter must not break health/metrics RPCs
        return m

    def check_health(self) -> bool:
        fn = getattr(self._callable, "check_health", None)
        if fn is not None:
            fn()
        return True
