"""The port's workflows against the reference's tests: a mirror of
``tests/test_workflow_depth.py`` run on ``ray_tpu_torch.workflow``.

Workflow depth: continuations (dynamic workflows), durable events,
virtual actors (reference: ``python/ray/workflow`` recursion/
``wait_for_event``/virtual-actor themes)."""

import os
import sys
import threading
import time

import cloudpickle
import pytest

import ray_tpu_torch
from ray_tpu_torch import workflow

# the module-level steps below travel by value: workers cannot import tests/
cloudpickle.register_pickle_by_value(sys.modules[__name__])


# The port's counterpart of the reference's ``ray_start_regular``: the tests
# need no fresh cluster, so they share one per module.
@pytest.fixture(scope="module")
def _shared_cluster():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_regular(_shared_cluster):
    yield


@ray_tpu_torch.remote
def add(a, b):
    return a + b


@ray_tpu_torch.remote
def fib_step(n, acc_prev, acc):
    """Returns a continuation until n hits 0 — recursion via dynamic DAGs."""
    if n == 0:
        return acc
    return workflow.continuation(fib_step.bind(n - 1, acc, acc_prev + acc))


def test_continuation_recursion(ray_start_regular, tmp_path):
    out = workflow.run(
        fib_step.bind(8, 0, 1), workflow_id="fib", storage=str(tmp_path)
    )
    assert out == 34  # fib(9)
    # sub-steps checkpointed under the parent step's namespace
    events = workflow.get_events("fib", str(tmp_path))
    assert any(e["type"] == "continuation_started" for e in events)


def test_continuation_resume_skips_done_rounds(ray_start_regular, tmp_path):
    marker = tmp_path / "ran"

    @ray_tpu_torch.remote
    def outer():
        return workflow.continuation(inner.bind())

    @ray_tpu_torch.remote
    def inner():
        with open(marker, "a") as f:
            f.write("x")
        return "done"

    assert workflow.run(outer.bind(), workflow_id="c1", storage=str(tmp_path)) == "done"
    assert workflow.resume("c1", storage=str(tmp_path)) == "done"
    assert marker.read_text() == "x"  # the inner step ran exactly once


def test_continuation_mid_dag_fails_loudly(ray_start_regular, tmp_path):
    """Continuations are tail-position only: a step with downstream
    consumers returning one must fail the workflow with a clear error, not
    feed the raw Continuation object onward."""

    @ray_tpu_torch.remote
    def sneaky():
        return workflow.continuation(add.bind(1, 2))

    dag = add.bind(sneaky.bind(), 10)
    with pytest.raises(Exception, match="tail-position|Continuation"):
        workflow.run(dag, workflow_id="midc", storage=str(tmp_path))


def test_wait_for_event_delivery(ray_start_regular, tmp_path):
    ev = workflow.wait_for_event("go", timeout_s=30)
    dag = add.bind(ev, 10)

    def deliver():
        time.sleep(0.5)
        workflow.send_event("evt1", "go", 32, storage=str(tmp_path))

    t = threading.Thread(target=deliver)
    t.start()
    out = workflow.run(dag, workflow_id="evt1", storage=str(tmp_path))
    t.join()
    assert out == 42
    # delivered payload is durable: a resume never waits again
    assert workflow.resume("evt1", storage=str(tmp_path)) == 42


def test_wait_for_event_timeout(ray_start_regular, tmp_path):
    dag = add.bind(workflow.wait_for_event("never", timeout_s=0.3), 1)
    with pytest.raises(Exception, match="never"):
        workflow.run(dag, workflow_id="evt2", storage=str(tmp_path))


def test_virtual_actor_durable_state(ray_start_regular, tmp_path):
    @workflow.virtual_actor
    class Counter:
        def __init__(self, start=0):
            self.value = start

        def incr(self, by=1):
            self.value += by
            return self.value

        @workflow.readonly
        def peek(self):
            return self.value

    c = Counter.get_or_create("c1", 5, storage=str(tmp_path))
    assert c.incr() == 6
    assert c.incr(4) == 10
    assert c.peek() == 10

    # a fresh handle (fresh process in real life) sees the committed state
    again = Counter.get_or_create("c1", 999, storage=str(tmp_path))
    assert again.peek() == 10  # get_or_create never re-inits an existing actor

    attached = workflow.get_actor("c1", Counter, storage=str(tmp_path))
    assert attached.incr() == 11

    with pytest.raises(ValueError):
        workflow.get_actor("missing", Counter, storage=str(tmp_path))


def test_virtual_actor_readonly_commits_nothing(ray_start_regular, tmp_path):
    @workflow.virtual_actor
    class Box:
        def __init__(self):
            self.v = 1

        @workflow.readonly
        def sneaky(self):
            self.v = 99  # mutation in a readonly method must NOT persist
            return self.v

        @workflow.readonly
        def peek(self):
            return self.v

    b = Box.get_or_create("b1", storage=str(tmp_path))
    assert b.sneaky() == 99
    assert b.peek() == 1


def test_virtual_actor_head_mutex(ray_start_regular, tmp_path):
    """Transactions serialize on the head-side named mutex (the fcntl lock
    degrades on networked storage); a crashed holder's lease expires
    instead of wedging the actor forever."""
    from ray_tpu_torch._private.runtime import get_ctx

    @workflow.virtual_actor
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n

    c = Counter.get_or_create("mtx", storage=str(tmp_path))
    assert c.bump() == 1

    ctx = get_ctx()
    # concurrent writers from threads interleave cleanly through the mutex
    import threading

    results = []

    def writer():
        h = workflow.get_actor("mtx", Counter, storage=str(tmp_path))
        results.append(h.bump())

    ts = [threading.Thread(target=writer) for _ in range(4)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    assert sorted(results) == [2, 3, 4, 5]  # no lost updates

    # crashed holder: acquire the actor's mutex with a short lease and
    # never release — the next transaction proceeds after expiry
    name = c._mutex_key()  # storage-independent UUID identity
    assert ctx.call("mutex_acquire", name=name, owner="dead-client", lease_s=0.5)
    t0 = time.monotonic()
    assert c.bump() == 6
    assert time.monotonic() - t0 >= 0.3  # actually waited for the lease
