"""The port's ``util`` leaves on its runtime, against the reference's tests:
mirrors of ``tests/test_util_queue.py``, ``tests/test_util_shims.py``, the
``ActorPool`` case of ``tests/test_actors.py`` and the pubsub cases of
``tests/test_head_plane.py``, run on ``ray_tpu_torch`` over one module
cluster (a ``cluster_utils.Cluster`` head, so the nodes channel can watch a
node join). Plus the port's own cases: ``ActorPool`` and ``Queue`` resolve
through ``ray_tpu_torch.util``, and a tensor inside a closure inspects as
serializable (it crosses the object plane's tensor seam)."""

import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import pubsub
from ray_tpu_torch.util.queue import Empty, Full, Queue


@pytest.fixture(scope="module")
def _cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4, "num_gpus": 0})
    ray_tpu_torch.init(address=c.address)
    yield c
    ray_tpu_torch.shutdown()
    try:
        c.shutdown()
    except Exception:
        pass


@pytest.fixture
def ray_start_regular(_cluster):
    yield


# ---------------------------------------------------------------------------
# tests/test_util_queue.py
# ---------------------------------------------------------------------------


def test_fifo_and_sizes(ray_start_regular):
    q = Queue()
    assert q.empty()
    for i in range(5):
        q.put(i)
    assert q.qsize() == 5 and not q.empty()
    assert [q.get() for _ in range(5)] == [0, 1, 2, 3, 4]
    q.shutdown()


def test_nowait_and_bounds(ray_start_regular):
    q = Queue(maxsize=2)
    q.put_nowait(1)
    q.put_nowait(2)
    assert q.full()
    with pytest.raises(Full):
        q.put_nowait(3)
    assert q.get_nowait() == 1
    q.shutdown()
    q2 = Queue()
    with pytest.raises(Empty):
        q2.get_nowait()
    q2.shutdown()


def test_blocking_get_with_timeout(ray_start_regular):
    q = Queue()
    with pytest.raises(Empty):
        q.get(timeout=0.5)
    q.shutdown()


def test_cross_task_producer_consumer(ray_start_regular):
    q = Queue(maxsize=8)

    @ray_tpu_torch.remote
    def produce(q, n):
        for i in range(n):
            q.put(i)
        return n

    fut = produce.remote(q, 20)
    got = [q.get(timeout=30) for _ in range(20)]
    assert got == list(range(20))
    assert ray_tpu_torch.get(fut, timeout=30) == 20
    q.shutdown()


def test_batch_ops(ray_start_regular):
    q = Queue()
    q.put_nowait_batch([1, 2, 3, 4])
    assert q.get_nowait_batch(3) == [1, 2, 3]
    assert q.get_nowait_batch(10) == [4]
    q.shutdown()


# ---------------------------------------------------------------------------
# tests/test_util_shims.py
# ---------------------------------------------------------------------------


class TestPool:
    def test_apply_and_map(self, ray_start_regular):
        from ray_tpu_torch.util.multiprocessing import Pool

        with Pool(processes=2) as p:
            assert p.apply(pow, (2, 5)) == 32
            assert p.map(lambda x: x * x, range(8)) == [x * x for x in range(8)]

    def test_starmap_and_async(self, ray_start_regular):
        from ray_tpu_torch.util.multiprocessing import Pool

        with Pool(processes=2) as p:
            assert p.starmap(pow, [(2, 3), (3, 2)]) == [8, 9]
            ar = p.apply_async(pow, (2, 10))
            assert ar.get(timeout=30) == 1024
            assert ar.successful()

    def test_imap_unordered_completes(self, ray_start_regular):
        from ray_tpu_torch.util.multiprocessing import Pool

        with Pool(processes=2) as p:
            out = sorted(p.imap_unordered(lambda x: x + 1, range(6)))
        assert out == list(range(1, 7))

    def test_async_error_propagates(self, ray_start_regular):
        from ray_tpu_torch.util.multiprocessing import Pool

        def boom(x):
            raise RuntimeError("pool-kaboom")

        with Pool(processes=2) as p:
            ar = p.apply_async(boom, (1,))
            with pytest.raises(RuntimeError, match="pool-kaboom"):
                ar.get(timeout=30)
            assert not ar.successful()

    def test_initializer_runs_in_workers(self, ray_start_regular):
        from ray_tpu_torch.util.multiprocessing import Pool

        def setup(v):
            import os

            os.environ["POOL_INIT_FLAG"] = str(v)

        def read(_):
            import os

            return os.environ.get("POOL_INIT_FLAG")

        with Pool(processes=2, initializer=setup, initargs=(7,)) as p:
            assert set(p.map(read, range(4))) == {"7"}


class TestCheckSerialize:
    def test_serializable_object_passes(self):
        from ray_tpu_torch.util.check_serialize import inspect_serializability

        ok, failures = inspect_serializability({"a": [1, 2, 3]})
        assert ok and not failures

    def test_finds_offending_closure_var(self):
        from ray_tpu_torch.util.check_serialize import inspect_serializability

        lock = threading.Lock()  # classic unserializable

        def f():
            return lock

        ok, failures = inspect_serializability(f)
        assert not ok
        assert any(fail.obj is lock for fail in failures)

    def test_finds_offending_attribute(self):
        from ray_tpu_torch.util.check_serialize import inspect_serializability

        class Holder:
            def __init__(self):
                self.fine = 1
                self.bad = threading.Lock()

        ok, failures = inspect_serializability(Holder())
        assert not ok and failures

    def test_tensor_in_a_closure_is_serializable(self):
        """A tensor crosses the object plane (``_private.serialization``'s
        tensor reducer); beside a lock, only the lock is reported."""
        import torch

        from ray_tpu_torch.util.check_serialize import inspect_serializability

        t = torch.arange(6.0)
        lock = threading.Lock()

        def f():
            return t.sum()

        def g():
            return t, lock

        ok, failures = inspect_serializability(f)
        assert ok and not failures
        ok, failures = inspect_serializability(g)
        assert not ok and [fail.obj for fail in failures] == [lock]


# ---------------------------------------------------------------------------
# tests/test_actors.py::test_actor_pool
# ---------------------------------------------------------------------------


def test_actor_pool(ray_start_regular):
    from ray_tpu_torch.util.actor_pool import ActorPool

    @ray_tpu_torch.remote
    class W:
        def f(self, x):
            return x * 2

    pool = ActorPool([W.remote() for _ in range(2)])
    out = list(pool.map(lambda a, v: a.f.remote(v), [1, 2, 3, 4]))
    assert out == [2, 4, 6, 8]


def test_actor_pool_and_queue_resolve_through_util():
    import ray_tpu_torch.util as util
    from ray_tpu_torch.util.actor_pool import ActorPool

    assert util.ActorPool is ActorPool and util.Queue is Queue
    with pytest.raises(AttributeError):
        util.no_such_name  # noqa: B018


# ---------------------------------------------------------------------------
# tests/test_head_plane.py::TestPubsub
# ---------------------------------------------------------------------------


class TestPubsub:
    def test_user_channel_roundtrip(self, ray_start_regular):
        with pubsub.subscribe("my-channel") as sub:
            pubsub.publish("my-channel", {"hello": 1})
            msg = sub.get(timeout=10)
        assert msg == {"hello": 1}

    def test_worker_publishes_driver_receives(self, ray_start_regular):
        @ray_tpu_torch.remote
        def announce(i):
            from ray_tpu_torch.util import pubsub as ps

            ps.publish("events", {"i": i})
            return i

        with pubsub.subscribe("events") as sub:
            ray_tpu_torch.get([announce.remote(i) for i in range(3)])
            got = sorted(sub.get(timeout=10)["i"] for _ in range(3))
        assert got == [0, 1, 2]

    def test_worker_subscribes(self, ray_start_regular):
        @ray_tpu_torch.remote
        class Listener:
            def __init__(self):
                from ray_tpu_torch.util import pubsub as ps

                self.sub = ps.subscribe("to-worker")

            def ready(self):
                return True

            def recv(self):
                return self.sub.get(timeout=10)

        listener = Listener.remote()
        ray_tpu_torch.get(listener.ready.remote(), timeout=30)  # subscription live
        fut = listener.recv.remote()
        time.sleep(0.2)  # let recv start blocking before the publish
        pubsub.publish("to-worker", "ping")
        assert ray_tpu_torch.get(fut, timeout=15) == "ping"

    def test_builtin_actor_channel(self, ray_start_regular):
        with pubsub.subscribe("actors") as sub:

            @ray_tpu_torch.remote
            class A:
                def ping(self):
                    return 1

            a = A.options(name="pub-actor").remote()
            ray_tpu_torch.get(a.ping.remote())
            events = []
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                events += sub.poll()
                if any(e["event"] == "ALIVE" and e["name"] == "pub-actor" for e in events):
                    break
                time.sleep(0.05)
        assert any(e["event"] == "ALIVE" and e["name"] == "pub-actor" for e in events)

    def test_builtin_nodes_channel(self, _cluster):
        # last in the module: the node it adds stays in the module's cluster
        with pubsub.subscribe("nodes") as sub:
            _cluster.add_node(num_cpus=1)
            deadline = time.monotonic() + 10
            added = []
            while time.monotonic() < deadline:
                added += [e for e in sub.poll() if e["event"] == "added"]
                if added:
                    break
                time.sleep(0.05)
        assert added
