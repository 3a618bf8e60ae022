"""The port's runtime against the reference's tests: a mirror of
``tests/test_compiled_dag.py`` run on ``ray_tpu_torch``, with no wall-clock bar
and without the tests of modules still to port.

Compiled DAGs over reusable shm channels.

Reference: ``python/ray/dag/compiled_dag_node.py:141`` (accelerated DAGs),
``python/ray/experimental/channel.py:49`` (mutable channels).
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.experimental.channel import Channel, ChannelClosed


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


class TestChannel:
    def test_same_process_roundtrip(self):
        ch = Channel(1 << 16)
        ch.write({"a": 1})
        assert ch.read() == {"a": 1}
        ch.destroy()

    def test_rendezvous_blocks_second_write(self):
        ch = Channel(1 << 16)
        ch.write(1)
        with pytest.raises(TimeoutError):
            ch.write(2, timeout=0.2)  # first value unread
        assert ch.read() == 1
        ch.write(2, timeout=1.0)
        assert ch.read() == 2
        ch.destroy()

    def test_capacity_enforced(self):
        ch = Channel(128)
        with pytest.raises(ValueError, match="capacity"):
            ch.write(b"x" * 1024)
        ch.destroy()

    def test_close_wakes_reader(self):
        import threading

        ch = Channel(1 << 16)
        got = []

        def reader():
            try:
                ch.read(timeout=10)
            except ChannelClosed:
                got.append("closed")

        t = threading.Thread(target=reader)
        t.start()
        time.sleep(0.2)
        ch.close()
        t.join(timeout=10)
        assert got == ["closed"]
        ch.destroy()

    def test_cross_process_channel(self, ray_start_regular):
        ch = Channel(1 << 16)

        @ray_tpu_torch.remote
        def produce(c):
            for i in range(5):
                c.write(i * 10)
            return "done"

        ref = produce.remote(ch)
        assert [ch.read(timeout=30) for _ in range(5)] == [0, 10, 20, 30, 40]
        assert ray_tpu_torch.get(ref, timeout=30) == "done"
        ch.destroy()


@pytest.fixture
def two_stage_dag(ray_start_regular):
    @ray_tpu_torch.remote
    class Doubler:
        def double(self, x):
            return 2 * x

    @ray_tpu_torch.remote
    class Adder:
        def __init__(self):
            self.calls = 0

        def add_one(self, x):
            self.calls += 1
            return x + 1

        def ncalls(self):
            return self.calls

    d, a = Doubler.remote(), Adder.remote()
    with InputNode() as inp:
        dag = a.add_one.bind(d.double.bind(inp))
    compiled = dag.experimental_compile()
    yield compiled, d, a
    compiled.teardown()


class TestCompiledDAG:
    def test_pipeline_executes(self, two_stage_dag):
        compiled, _, _ = two_stage_dag
        assert compiled.execute(5).get() == 11
        assert compiled.execute(0).get() == 1

    def test_no_task_submissions_after_warmup(self, two_stage_dag):
        """The accelerated property: repeated executes run over channels,
        not the scheduler — the head sees no new tasks."""
        compiled, _, _ = two_stage_dag
        compiled.execute(1).get()
        from ray_tpu_torch._private.runtime import get_ctx

        head = get_ctx().head
        with head.lock:
            tasks_before = len(head.tasks) + len(head.task_events)
        for i in range(20):
            assert compiled.execute(i).get() == 2 * i + 1
        with head.lock:
            tasks_after = len(head.tasks) + len(head.task_events)
        assert tasks_after == tasks_before

    def test_errors_propagate_and_dag_survives(self, ray_start_regular):
        @ray_tpu_torch.remote
        class Fragile:
            def work(self, x):
                if x < 0:
                    raise ValueError("negative!")
                return x * 3

        f = Fragile.remote()
        with InputNode() as inp:
            dag = f.work.bind(inp)
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(2).get() == 6
            with pytest.raises(ValueError, match="negative"):
                compiled.execute(-1).get()
            assert compiled.execute(3).get() == 9  # loop survived the error
        finally:
            compiled.teardown()

    def test_multi_output(self, ray_start_regular):
        @ray_tpu_torch.remote
        class Sq:
            def sq(self, x):
                return x * x

        @ray_tpu_torch.remote
        class Neg:
            def neg(self, x):
                return -x

        s, n = Sq.remote(), Neg.remote()
        with InputNode() as inp:
            dag = MultiOutputNode([s.sq.bind(inp), n.neg.bind(inp)])
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(4).get(timeout=30) == [16, -4]
        finally:
            compiled.teardown()

    def test_async_actor_in_compiled_dag(self, ray_start_regular):
        """An actor with any async method runs its task loop on the asyncio
        engine; the compiled-DAG exec loop must still resolve and must not
        block the event loop (regression: _arun used getattr, so
        __dag_exec__ raised AttributeError into the void and execute().get()
        surfaced only as a channel timeout)."""

        @ray_tpu_torch.remote
        class A:
            async def poke(self):
                return "alive"

            def double(self, x):
                return 2 * x

        a = A.remote()
        with InputNode() as inp:
            dag = a.double.bind(inp)
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(21).get(timeout=30) == 42
            # other (async) methods stay serviceable while the DAG loop runs
            assert ray_tpu_torch.get(a.poke.remote(), timeout=30) == "alive"
            assert compiled.execute(5).get(timeout=30) == 10
        finally:
            compiled.teardown()

    def test_actor_usable_after_teardown(self, ray_start_regular):
        @ray_tpu_torch.remote
        class W:
            def f(self, x):
                return x + 100

        w = W.remote()
        with InputNode() as inp:
            dag = w.f.bind(inp)
        compiled = dag.experimental_compile()
        assert compiled.execute(1).get() == 101
        compiled.teardown()
        # the exec loop released the actor's dispatch queue
        assert ray_tpu_torch.get(w.f.remote(5), timeout=30) == 105
