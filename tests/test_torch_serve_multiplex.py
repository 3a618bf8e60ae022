"""The port's Serve model multiplexing, mirroring
``tests/test_serve_multiplex.py`` (reference: ``serve/multiplex.py`` +
``tests/test_multiplex.py`` themes: LRU model cache, per-model routing
stickiness, get_multiplexed_model_id)."""

import threading

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


def test_multiplexed_lru_and_context(serve_instance):
    @serve.deployment(num_replicas=1, max_ongoing_requests=8)
    class Multi:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            self.loads.append(model_id)
            return lambda x: f"{model_id}:{x * 2}"

        def __call__(self, x):
            mid = serve.get_multiplexed_model_id()
            return self.get_model(mid)(x)

        def load_log(self):
            return list(self.loads)

    h = serve.run(Multi.bind(), name="mx")
    assert h.options(multiplexed_model_id="a").remote(3).result(timeout=30) == "a:6"
    assert h.options(multiplexed_model_id="b").remote(1).result(timeout=30) == "b:2"
    # cached: repeated model ids don't reload
    for _ in range(3):
        assert h.options(multiplexed_model_id="a").remote(1).result(timeout=30) == "a:2"
    assert h.load_log.remote().result(timeout=30) == ["a", "b"]
    # LRU capacity 2: a third model evicts the least-recently-used ("b")
    h.options(multiplexed_model_id="c").remote(0).result(timeout=30)
    h.options(multiplexed_model_id="b").remote(0).result(timeout=30)  # reload
    assert h.load_log.remote().result(timeout=30) == ["a", "b", "c", "b"]


def test_multiplexed_routing_is_sticky_per_model(serve_instance):
    @serve.deployment(num_replicas=2, max_ongoing_requests=8)
    class Who:
        def __init__(self):
            import os

            self.pid = os.getpid()
            self.loaded = []

        @serve.multiplexed(max_num_models_per_replica=8)
        def get_model(self, model_id):
            self.loaded.append(model_id)
            return model_id

        def __call__(self, _):
            mid = serve.get_multiplexed_model_id()
            self.get_model(mid)
            return (mid, self.pid)

    h = serve.run(Who.bind(), name="sticky")
    # Rendezvous hashing keys on replica ACTOR IDS (random per run), so the
    # model->replica assignment is an independent coin flip per model id:
    # with M models over 2 replicas, P(all land on one replica) = 2^(1-M).
    # The original M=4 flaked at that 12.5% rate in a full-suite run;
    # M=12 (~0.05%) keeps the both-replicas-used assertion meaningful
    # without betting the suite on hash luck.
    mids = tuple(f"m{i}" for i in range(12))
    seen = {}
    for _ in range(3):
        for mid in mids:
            got_mid, pid = h.options(multiplexed_model_id=mid).remote(0).result(timeout=30)
            assert got_mid == mid
            seen.setdefault(mid, set()).add(pid)
    # every model id consistently routed to ONE replica
    assert all(len(pids) == 1 for pids in seen.values()), seen
    # and with 12 models over 2 replicas, both replicas serve something
    assert len({next(iter(p)) for p in seen.values()}) == 2


def test_plain_requests_unaffected(serve_instance):
    @serve.deployment
    class Plain:
        def __call__(self, x):
            return (serve.get_multiplexed_model_id(), x + 1)

    h = serve.run(Plain.bind(), name="plain")
    assert h.remote(1).result(timeout=30) == ("", 2)
