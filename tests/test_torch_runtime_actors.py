"""The port's runtime against the reference's tests: a mirror of
``tests/test_actors.py`` run on ``ray_tpu_torch``, with no wall-clock bar
and without the tests of modules still to port.

Actor tests (modeled on the reference's ``python/ray/tests/test_actor.py``
family: ordering, state, named actors, restarts, kill)."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayActorError


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


@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.v = start

    def inc(self, by=1):
        self.v += by
        return self.v

    def value(self):
        return self.v

    def crash(self):
        import os

        os._exit(1)


def test_actor_basic(ray_start_regular):
    c = Counter.remote()
    assert ray_tpu_torch.get(c.inc.remote()) == 1
    assert ray_tpu_torch.get(c.inc.remote(5)) == 6
    assert ray_tpu_torch.get(c.value.remote()) == 6


def test_actor_init_args(ray_start_regular):
    c = Counter.remote(100)
    assert ray_tpu_torch.get(c.value.remote()) == 100


def test_actor_method_ordering(ray_start_regular):
    c = Counter.remote()
    refs = [c.inc.remote() for _ in range(50)]
    assert ray_tpu_torch.get(refs) == list(range(1, 51))


def test_actor_state_isolated(ray_start_regular):
    a, b = Counter.remote(), Counter.remote()
    ray_tpu_torch.get(a.inc.remote())
    assert ray_tpu_torch.get(b.value.remote()) == 0


def test_named_actor(ray_start_regular):
    # Keep the original handle alive: like the reference, a non-detached named
    # actor is killed once every handle goes out of scope.
    c = Counter.options(name="global_counter").remote()
    h = ray_tpu_torch.get_actor("global_counter")
    assert ray_tpu_torch.get(h.inc.remote()) == 1
    del c


def test_named_actor_missing(ray_start_regular):
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("no_such_actor")


def test_actor_init_error_propagates(ray_start_regular):
    @ray_tpu_torch.remote
    class Bad:
        def __init__(self):
            raise RuntimeError("init failed")

        def m(self):
            return 1

    b = Bad.remote()
    with pytest.raises((RuntimeError, RayActorError)):
        ray_tpu_torch.get(b.m.remote())


def test_actor_crash_no_restart(ray_start_regular):
    c = Counter.remote()
    ray_tpu_torch.get(c.inc.remote())
    c.crash.remote()
    with pytest.raises(RayActorError):
        ray_tpu_torch.get(c.value.remote(), timeout=30)


def test_actor_restart(ray_start_regular):
    c = Counter.options(max_restarts=1).remote()
    assert ray_tpu_torch.get(c.inc.remote()) == 1
    c.crash.remote()
    # wait for restart; state resets (fresh __init__)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            v = ray_tpu_torch.get(c.value.remote(), timeout=5)
            assert v == 0
            break
        except RayActorError:
            time.sleep(0.2)
    else:
        pytest.fail("actor did not restart")


def test_ray_kill(ray_start_regular):
    c = Counter.options(max_restarts=5).remote()
    ray_tpu_torch.get(c.inc.remote())
    ray_tpu_torch.kill(c)
    with pytest.raises(RayActorError):
        ray_tpu_torch.get(c.value.remote(), timeout=30)


def test_actor_handle_passed_to_task(ray_start_regular):
    c = Counter.remote()

    @ray_tpu_torch.remote
    def use(handle):
        return ray_tpu_torch.get(handle.inc.remote())

    assert ray_tpu_torch.get(use.remote(c)) == 1
    assert ray_tpu_torch.get(c.value.remote()) == 1


def test_max_concurrency(ray_start_regular):
    """Calls overlap inside a threaded actor: the actor itself counts how
    many run at once (no wall-clock bar)."""

    @ray_tpu_torch.remote(max_concurrency=4)
    class Parallel:
        def __init__(self):
            import threading

            self.lock = threading.Lock()
            self.running = 0
            self.peak = 0

        def block(self, t):
            with self.lock:
                self.running += 1
                self.peak = max(self.peak, self.running)
            time.sleep(t)
            with self.lock:
                self.running -= 1
            return 1

        def peak_seen(self):
            return self.peak

    p = Parallel.remote()
    ray_tpu_torch.get(p.block.remote(0.0))  # wait for actor bring-up
    refs = [p.block.remote(1.0) for _ in range(4)]
    assert ray_tpu_torch.get(refs) == [1] * 4
    assert ray_tpu_torch.get(p.peak_seen.remote()) >= 2  # 1 if serialized


def test_method_num_returns(ray_start_regular):
    @ray_tpu_torch.remote
    class M:
        @ray_tpu_torch.method(num_returns=2)
        def two(self):
            return 1, 2

    m = M.remote()
    a, b = m.two.remote()
    assert ray_tpu_torch.get([a, b]) == [1, 2]

