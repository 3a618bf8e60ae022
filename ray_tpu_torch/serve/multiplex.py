"""Model multiplexing: many models behind one deployment (copy of
``ray_tpu/serve/multiplex.py``).

Reference: ``python/ray/serve/multiplex.py`` (``@serve.multiplexed`` LRU
model loader + ``serve.get_multiplexed_model_id()``) with model-aware
routing. A replica is a process holding models in device memory;
multiplexing keeps up to ``max_num_models_per_replica`` loaded per
replica and routes every request for a model id to the SAME replica
(rendezvous hashing over the live replica set), so each model's weights are
resident on exactly one replica's device and swaps only happen when the
replica set changes.

    @serve.deployment
    class Multi:
        @serve.multiplexed(max_num_models_per_replica=4)
        def get_model(self, model_id: str):
            return load_model(model_id)   # heavyweight, LRU-cached

        def __call__(self, payload):
            model = self.get_model(serve.get_multiplexed_model_id())
            return model(payload)

    handle.options(multiplexed_model_id="m7").remote(x)
"""

from __future__ import annotations

import collections
import functools
import threading
from typing import Callable, Optional

_request_ctx = threading.local()


def get_multiplexed_model_id() -> str:
    """The model id the CURRENT request was routed with ('' if none)."""
    return getattr(_request_ctx, "model_id", "")


def _set_request_model_id(model_id: Optional[str]):
    _request_ctx.model_id = model_id or ""


_CREATE_LOCK = threading.Lock()


class _LRUModels:
    def __init__(self, loader: Callable, capacity: int):
        self.loader = loader
        self.capacity = capacity
        self._models: "collections.OrderedDict" = collections.OrderedDict()
        self._inflight: dict = {}  # model_id -> Future (load dedup)
        self._lock = threading.Lock()

    def get(self, instance, model_id: str):
        from concurrent.futures import Future

        while True:
            with self._lock:
                if model_id in self._models:
                    self._models.move_to_end(model_id)
                    return self._models[model_id]
                fut = self._inflight.get(model_id)
                if fut is None:
                    fut = self._inflight[model_id] = Future()
                    leader = True
                else:
                    leader = False
            if not leader:
                # another request is loading this model — share ONE load
                # (N concurrent cold requests must not load N copies)
                return fut.result()
            try:
                model = self.loader(instance, model_id)  # load outside lock
            except BaseException as e:  # noqa: BLE001
                with self._lock:
                    self._inflight.pop(model_id, None)
                fut.set_exception(e)
                raise
            with self._lock:
                self._models[model_id] = model
                self._models.move_to_end(model_id)
                while len(self._models) > self.capacity:
                    self._models.popitem(last=False)  # LRU; GC frees it
                self._inflight.pop(model_id, None)
            fut.set_result(model)
            return model


def multiplexed(_fn: Optional[Callable] = None, *, max_num_models_per_replica: int = 3):
    """Decorate a model-loader method; concurrent calls share an LRU cache
    of at most ``max_num_models_per_replica`` loaded models per replica."""

    def wrap(fn):
        attr = f"__serve_multiplex_{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(self, model_id: str):
            # runtime import: referencing module globals (the LOCK) by name
            # would make cloudpickle serialize them with user classes
            import ray_tpu_torch.serve.multiplex as _m

            cache = getattr(self, attr, None)
            if cache is None:
                with _m._CREATE_LOCK:  # double-checked: one cache per instance
                    cache = getattr(self, attr, None)
                    if cache is None:
                        cache = _m._LRUModels(fn, max_num_models_per_replica)
                        setattr(self, attr, cache)
            return cache.get(self, model_id)

        wrapper._is_serve_multiplexed = True  # noqa: SLF001
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap


def rendezvous_pick(model_id: str, n: int) -> int:
    """Stable replica index for a model id over n replicas (highest-random-
    weight hashing): the same model keeps hitting the same replica while the
    replica set is unchanged, so its weights stay resident."""
    import hashlib

    best, best_idx = -1, 0
    for i in range(n):
        h = int.from_bytes(
            hashlib.sha1(f"{model_id}:{i}".encode()).digest()[:8], "little"
        )
        if h > best:
            best, best_idx = h, i
    return best_idx
