"""The port's runtime against the reference's tests: a mirror of
``tests/test_dag.py`` run on ``ray_tpu_torch``, with no wall-clock bar
and without the tests of modules still to port.

Lazy DAG tests (reference: ``python/ray/dag/tests`` themes: bind/execute,
InputNode substitution, diamond graphs, MultiOutputNode)."""

import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode, MultiOutputNode


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


def test_bind_and_execute_chain(ray_start_regular):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    @ray_tpu_torch.remote
    def mul(a, b):
        return a * b

    dag = mul.bind(add.bind(1, 2), 10)
    assert ray_tpu_torch.get(dag.execute(), timeout=120) == 30


def test_input_node_threads_runtime_value(ray_start_regular):
    @ray_tpu_torch.remote
    def double(x):
        return 2 * x

    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    with InputNode() as inp:
        dag = inc.bind(double.bind(inp))
    assert ray_tpu_torch.get(dag.execute(5), timeout=120) == 11
    assert ray_tpu_torch.get(dag.execute(100), timeout=120) == 201  # reusable


def test_diamond_executes_shared_node_once(ray_start_regular):
    calls = []

    @ray_tpu_torch.remote
    class Tracker:
        def __init__(self):
            self.n = 0

        def hit(self):
            self.n += 1
            return self.n

        def count(self):
            return self.n

    t = Tracker.remote()

    @ray_tpu_torch.remote
    def source(tracker):
        return ray_tpu_torch.get(tracker.hit.remote())

    @ray_tpu_torch.remote
    def left(x):
        return x + 1

    @ray_tpu_torch.remote
    def right(x):
        return x + 2

    @ray_tpu_torch.remote
    def join(a, b):
        return (a, b)

    s = source.bind(t)
    dag = join.bind(left.bind(s), right.bind(s))
    out = ray_tpu_torch.get(dag.execute(), timeout=120)
    assert out == (2, 3)
    # the shared upstream ran exactly once
    assert ray_tpu_torch.get(t.count.remote(), timeout=120) == 1


def test_multi_output_node(ray_start_regular):
    @ray_tpu_torch.remote
    def f(x):
        return x * x

    with InputNode() as inp:
        dag = MultiOutputNode([f.bind(inp), f.bind(3)])
    refs = dag.execute(2)
    assert ray_tpu_torch.get(refs, timeout=120) == [4, 9]


def test_executing_input_node_directly_errors(ray_start_regular):
    inp = InputNode()
    with pytest.raises(RuntimeError, match="InputNode has no value"):
        inp.execute()
