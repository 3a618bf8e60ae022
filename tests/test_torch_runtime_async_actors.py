"""The port's runtime against the reference's tests: a mirror of
``tests/test_async_actors.py`` run on ``ray_tpu_torch``, with no wall-clock bar
and without the tests of modules still to port.

Asyncio actors + concurrency groups.

Reference behavior being matched: actors with ``async def`` methods run them
on a per-actor asyncio event loop with high default concurrency
(``python/ray/_raylet.pyx:2082-2084`` — per-concurrency-group asyncio event
loops; ``core_worker/transport/concurrency_group_manager.cc``). Concurrency
groups give named method sets their own concurrency limits
(``@ray.method(concurrency_group="io")``).
"""

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


def test_async_methods_run_concurrently(ray_start_regular):
    @ray_tpu_torch.remote
    class Gate:
        def __init__(self):
            self.opened = False

        def open(self):
            self.opened = True

        def is_open(self):
            return self.opened

    @ray_tpu_torch.remote
    class Waiter:
        def __init__(self, gate):
            self.gate = gate

        async def wait_for_gate(self):
            # Polls a second actor: only completes if other coroutines of
            # THIS actor (open_gate) can run while this one is suspended.
            import asyncio

            while not ray_tpu_torch.get(self.gate.is_open.remote()):
                await asyncio.sleep(0.02)
            return "opened"

        async def open_gate(self):
            ray_tpu_torch.get(self.gate.open.remote())
            return "done"

    gate = Gate.remote()
    w = Waiter.remote(gate)
    blocked = w.wait_for_gate.remote()
    opener = w.open_gate.remote()
    assert ray_tpu_torch.get(opener, timeout=10) == "done"
    assert ray_tpu_torch.get(blocked, timeout=10) == "opened"


def test_async_actor_many_overlapping_sleeps(ray_start_regular):
    @ray_tpu_torch.remote
    class A:
        def __init__(self):
            self.running = 0
            self.peak = 0

        async def nap(self, t):
            import asyncio

            self.running += 1
            self.peak = max(self.peak, self.running)
            await asyncio.sleep(t)
            self.running -= 1
            return t

        async def peak_seen(self):
            return self.peak

    a = A.remote()
    assert ray_tpu_torch.get(a.nap.remote(0.0), timeout=30) == 0.0  # actor warm
    refs = [a.nap.remote(0.5) for _ in range(10)]
    assert ray_tpu_torch.get(refs, timeout=30) == [0.5] * 10
    # overlapped on the actor's event loop (counted there, no wall-clock bar)
    assert ray_tpu_torch.get(a.peak_seen.remote(), timeout=30) >= 2


def test_async_max_concurrency_limits(ray_start_regular):
    @ray_tpu_torch.remote(max_concurrency=2)
    class A:
        def __init__(self):
            self.active = 0
            self.peak = 0

        async def work(self):
            import asyncio

            self.active += 1
            self.peak = max(self.peak, self.active)
            await asyncio.sleep(0.2)
            self.active -= 1
            return self.peak

    a = A.remote()
    peaks = ray_tpu_torch.get([a.work.remote() for _ in range(6)], timeout=30)
    assert max(peaks) == 2


def test_concurrency_groups(ray_start_regular):
    @ray_tpu_torch.remote(concurrency_groups={"io": 4, "compute": 1})
    class A:
        def __init__(self):
            self.io_active = 0
            self.io_peak = 0
            self.compute_active = 0
            self.compute_peak = 0

        @ray_tpu_torch.method(concurrency_group="io")
        async def io_task(self):
            import asyncio

            self.io_active += 1
            self.io_peak = max(self.io_peak, self.io_active)
            await asyncio.sleep(0.2)
            self.io_active -= 1

        @ray_tpu_torch.method(concurrency_group="compute")
        async def compute_task(self):
            import asyncio

            self.compute_active += 1
            self.compute_peak = max(self.compute_peak, self.compute_active)
            await asyncio.sleep(0.1)
            self.compute_active -= 1

        async def peaks(self):
            return self.io_peak, self.compute_peak

    a = A.remote()
    refs = [a.io_task.remote() for _ in range(8)]
    refs += [a.compute_task.remote() for _ in range(3)]
    ray_tpu_torch.get(refs, timeout=30)
    io_peak, compute_peak = ray_tpu_torch.get(a.peaks.remote(), timeout=10)
    assert io_peak > 1, "io group should overlap"
    assert io_peak <= 4
    assert compute_peak == 1, "compute group must stay serial"


def test_async_actor_exception_propagates(ray_start_regular):
    @ray_tpu_torch.remote
    class A:
        async def boom(self):
            raise ValueError("async-kaboom")

    a = A.remote()
    with pytest.raises(ValueError, match="async-kaboom"):
        ray_tpu_torch.get(a.boom.remote(), timeout=10)


def test_async_actor_cancel(ray_start_regular):
    @ray_tpu_torch.remote
    class A:
        async def forever(self):
            import asyncio

            while True:
                await asyncio.sleep(0.05)

        async def quick(self):
            return 42

    a = A.remote()
    ref = a.forever.remote()
    time.sleep(0.3)
    ray_tpu_torch.cancel(ref)
    with pytest.raises(ray_tpu_torch.exceptions.TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=10)
    # actor still alive and serving after the cancel
    assert ray_tpu_torch.get(a.quick.remote(), timeout=10) == 42


def test_sync_methods_on_async_actor(ray_start_regular):
    @ray_tpu_torch.remote
    class Mixed:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n

        async def abump(self):
            self.n += 1
            return self.n

    m = Mixed.remote()
    vals = ray_tpu_torch.get([m.bump.remote(), m.abump.remote(), m.bump.remote()], timeout=10)
    assert sorted(vals) == [1, 2, 3]
