"""The port's runtime against the reference's tests: a mirror of
``tests/test_streaming_generators.py`` run on ``ray_tpu_torch``, with no wall-clock bar
and without the tests of modules still to port.

Streaming generator returns: num_returns="streaming" yields per-item
ObjectRefs while the task runs.

Reference: ObjectRefGenerator + streaming-generator reporting
(``python/ray/_raylet.pyx:1230``) and the streaming return bookkeeping in
``src/ray/core_worker/task_manager.cc`` — items become objects as they are
produced, consumers iterate with backpressure, mid-stream errors surface at
the point of consumption."""

import time

import pytest

import ray_tpu_torch


# The port's counterparts of the reference's conftest fixtures. The tests
# that need no fresh cluster share one per module.
@pytest.fixture(scope="module")
def _shared_cluster():
    ray_tpu_torch.init(num_cpus=4, num_tpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_regular(_shared_cluster):
    yield


def test_roundtrip_and_laziness(ray_start_regular):
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * i

    g = gen.remote(5)
    assert isinstance(g, ray_tpu_torch.ObjectRefGenerator)
    vals = [ray_tpu_torch.get(ref, timeout=30) for ref in g]
    assert vals == [0, 1, 4, 9, 16]


def test_items_arrive_before_task_completes(ray_start_regular, tmp_path):
    """The producer yields its first item, then waits for the consumer to
    say it has that item: only a stream that delivers items before the
    task completes lets it reach "last" (no wall-clock bar)."""
    got_first = tmp_path / "got_first"

    @ray_tpu_torch.remote(num_returns="streaming")
    def slow_tail(flag):
        import os

        yield "first"
        deadline = time.monotonic() + 30.0
        while not os.path.exists(flag):
            if time.monotonic() > deadline:
                yield "never-acknowledged"
                return
            time.sleep(0.01)
        yield "last"

    g = slow_tail.remote(str(got_first))
    it = iter(g)
    first = ray_tpu_torch.get(next(it), timeout=30)
    assert first == "first"
    got_first.touch()
    assert ray_tpu_torch.get(next(it), timeout=60) == "last"


def test_error_mid_stream(ray_start_regular):
    @ray_tpu_torch.remote(num_returns="streaming")
    def boom():
        yield 1
        yield 2
        raise ValueError("stream exploded")

    g = boom.remote()
    it = iter(g)
    assert ray_tpu_torch.get(next(it), timeout=30) == 1
    assert ray_tpu_torch.get(next(it), timeout=30) == 2
    with pytest.raises(ValueError, match="stream exploded"):
        next(it)


def test_function_error_before_first_yield(ray_start_regular):
    @ray_tpu_torch.remote(num_returns="streaming")
    def notgen():
        return 42  # not an iterable -> typed error at consumption

    with pytest.raises(TypeError, match="streaming"):
        next(iter(notgen.remote()))


def test_backpressure_bounds_producer(ray_start_regular):
    @ray_tpu_torch.remote
    class Progress:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1

        def value(self):
            return self.n

    p = Progress.options(name="prog").remote()
    ray_tpu_torch.get(p.value.remote(), timeout=30)

    @ray_tpu_torch.remote(num_returns="streaming")
    def firehose():
        import ray_tpu_torch as rt

        prog = rt.get_actor("prog")
        for i in range(100):
            prog.bump.remote()
            yield i

    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    cap = GLOBAL_CONFIG.streaming_backpressure_items
    g = firehose.remote()
    it = iter(g)
    ray_tpu_torch.get(next(it), timeout=30)  # consume exactly one item
    time.sleep(1.0)  # give an unbounded producer time to run away
    produced = ray_tpu_torch.get(p.value.remote(), timeout=30)
    # consumed 1, so the producer must be paused within its window
    assert produced <= 1 + cap + 2, f"producer ran {produced} items ahead"
    # drain: everything still arrives in order
    rest = [ray_tpu_torch.get(r, timeout=30) for r in it]
    assert rest == list(range(1, 100))


def test_dispose_cancels_running_producer(ray_start_regular):
    @ray_tpu_torch.remote(num_returns="streaming")
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    g = endless.remote()
    it = iter(g)
    assert ray_tpu_torch.get(next(it), timeout=30) == 0
    g.close()  # consumer walks away -> producer must be cancelled
    from ray_tpu_torch._private.runtime import get_ctx

    head = get_ctx().head
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        with head.lock:
            if not head.tasks:
                break
        time.sleep(0.1)
    with head.lock:
        assert not head.tasks, "producer still running after dispose"


def test_sync_actor_method_streams(ray_start_regular):
    @ray_tpu_torch.remote
    class Chunker:
        def chunks(self, n):
            for i in range(n):
                yield f"chunk-{i}"

    c = Chunker.remote()
    g = c.chunks.options(num_returns="streaming").remote(3)
    assert [ray_tpu_torch.get(r, timeout=30) for r in g] == ["chunk-0", "chunk-1", "chunk-2"]


def test_async_actor_method_streams(ray_start_regular):
    @ray_tpu_torch.remote
    class AsyncChunker:
        async def chunks(self, n):
            import asyncio

            for i in range(n):
                await asyncio.sleep(0.01)
                yield i * 10

        async def ping(self):
            return "pong"

    c = AsyncChunker.remote()
    g = c.chunks.options(num_returns="streaming").remote(4)
    assert [ray_tpu_torch.get(r, timeout=30) for r in g] == [0, 10, 20, 30]
    # loop stayed serviceable while the stream ran
    assert ray_tpu_torch.get(c.ping.remote(), timeout=30) == "pong"
