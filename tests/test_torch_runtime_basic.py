"""The port's runtime against the reference's tests: a mirror of
``tests/test_basic.py`` run on ``ray_tpu_torch``, with no wall-clock bar
and without the tests of modules still to port.

Core task/object API tests (modeled on the reference's
``python/ray/tests/test_basic.py`` family)."""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import GetTimeoutError, RayTaskError


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


def test_put_get(ray_start_regular):
    ref = ray_tpu_torch.put(42)
    assert ray_tpu_torch.get(ref) == 42
    ref2 = ray_tpu_torch.put({"a": [1, 2, 3], "b": "x"})
    assert ray_tpu_torch.get(ref2) == {"a": [1, 2, 3], "b": "x"}


def test_put_get_large_numpy(ray_start_regular):
    arr = np.arange(1_000_000, dtype=np.float32)  # 4MB -> shm path
    ref = ray_tpu_torch.put(arr)
    out = ray_tpu_torch.get(ref)
    np.testing.assert_array_equal(arr, out)
    # zero-copy: the result should be backed by shared memory (not writeable)
    assert out.flags["WRITEABLE"] is False or out.base is not None


def test_simple_task(ray_start_regular):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    assert ray_tpu_torch.get(f.remote(1)) == 2
    refs = [f.remote(i) for i in range(20)]
    assert ray_tpu_torch.get(refs) == list(range(1, 21))


def test_task_with_ref_args(ray_start_regular):
    @ray_tpu_torch.remote
    def f(x, y):
        return x + y

    a = ray_tpu_torch.put(10)
    b = f.remote(a, 5)
    c = f.remote(b, a)
    assert ray_tpu_torch.get(c) == 25


def test_task_chain_dependencies(ray_start_regular):
    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    ref = ray_tpu_torch.put(0)
    for _ in range(10):
        ref = inc.remote(ref)
    assert ray_tpu_torch.get(ref) == 10


def test_task_error_propagation(ray_start_regular):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("kaboom")

    @ray_tpu_torch.remote
    def dependent(x):
        return x

    with pytest.raises(ValueError, match="kaboom"):
        ray_tpu_torch.get(boom.remote())
    # error poisons dependents
    with pytest.raises(ValueError, match="kaboom"):
        ray_tpu_torch.get(dependent.remote(boom.remote()))


def test_task_error_is_raytaskerror(ray_start_regular):
    @ray_tpu_torch.remote
    def boom():
        raise KeyError("k")

    with pytest.raises(RayTaskError):
        ray_tpu_torch.get(boom.remote())


def test_multiple_returns(ray_start_regular):
    @ray_tpu_torch.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert ray_tpu_torch.get([a, b, c]) == [1, 2, 3]


def test_num_cpus_options(ray_start_regular):
    @ray_tpu_torch.remote(num_cpus=2)
    def f():
        return 1

    assert ray_tpu_torch.get(f.remote()) == 1
    assert ray_tpu_torch.get(f.options(num_cpus=1).remote()) == 1


def test_get_timeout(ray_start_regular):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(30)

    ref = slow.remote()
    with pytest.raises(GetTimeoutError):
        ray_tpu_torch.get(ref, timeout=0.2)
    ray_tpu_torch.cancel(ref, force=True)


def test_wait(ray_start_regular):
    @ray_tpu_torch.remote
    def fast():
        return 1

    @ray_tpu_torch.remote
    def slow():
        time.sleep(60)
        return 2

    f, s = fast.remote(), slow.remote()
    ready, not_ready = ray_tpu_torch.wait([f, s], num_returns=1, timeout=10)
    assert ready == [f]
    assert not_ready == [s]
    ready, not_ready = ray_tpu_torch.wait([f, s], num_returns=2, timeout=0.2)
    assert ready == [f] and not_ready == [s]
    ray_tpu_torch.cancel(s, force=True)


def test_nested_tasks(ray_start_regular):
    @ray_tpu_torch.remote
    def inner(x):
        return x * 2

    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(inner.remote(x)) + 1

    assert ray_tpu_torch.get(outer.remote(10)) == 21


def test_task_returns_ref(ray_start_regular):
    @ray_tpu_torch.remote
    def make():
        return ray_tpu_torch.put(123)

    ref_of_ref = make.remote()
    inner_ref = ray_tpu_torch.get(ref_of_ref)
    assert ray_tpu_torch.get(inner_ref) == 123


def test_large_arg_promoted(ray_start_regular):
    big = np.ones(500_000, dtype=np.float64)  # 4MB by-value arg

    @ray_tpu_torch.remote
    def s(x):
        return float(x.sum())

    assert ray_tpu_torch.get(s.remote(big)) == 500_000.0


def test_cluster_resources(ray_start_regular):
    res = ray_tpu_torch.cluster_resources()
    assert res["CPU"] == 4.0


def test_cannot_call_remote_directly(ray_start_regular):
    @ray_tpu_torch.remote
    def f():
        return 1

    with pytest.raises(TypeError):
        f()


def test_put_objectref_rejected(ray_start_regular):
    ref = ray_tpu_torch.put(1)
    with pytest.raises(TypeError):
        ray_tpu_torch.put(ref)


def test_cancel_pending(ray_start_regular):
    @ray_tpu_torch.remote
    def blocker():
        time.sleep(60)

    @ray_tpu_torch.remote
    def victim():
        return 1

    # fill all 4 cpus
    blockers = [blocker.remote() for _ in range(4)]
    v = victim.remote()
    ray_tpu_torch.cancel(v)
    from ray_tpu_torch.exceptions import TaskCancelledError

    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(v, timeout=10)
    for b in blockers:
        ray_tpu_torch.cancel(b, force=True)


def test_dag_bind_execute(ray_start_regular):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    node = add.bind(add.bind(1, 2), 4)
    assert ray_tpu_torch.get(node.execute()) == 7


def test_config_flag_tiers(monkeypatch):
    """The three override tiers (default < RAY_TPU_ env < _system_config)
    apply to every dataclass field, including the later knobs that were
    previously hardcoded (reference: RAY_CONFIG flag system)."""
    from ray_tpu_torch._private.config import Config

    cfg = Config()
    assert cfg.object_transfer_chunk_bytes == 8 * 1024 * 1024
    assert cfg.collective_ring_threshold_bytes == 1 << 22
    assert cfg.serve_handle_max_retries == 4
    monkeypatch.setenv("RAY_TPU_OBJECT_TRANSFER_CHUNK_BYTES", "1048576")
    monkeypatch.setenv("RAY_TPU_DASHBOARD_PORT", "9999")
    cfg.apply_overrides({"serve_handle_max_retries": 7})
    assert cfg.object_transfer_chunk_bytes == 1048576  # env tier
    assert cfg.dashboard_port == 9999
    assert cfg.serve_handle_max_retries == 7  # _system_config tier wins
    with pytest.raises(ValueError, match="Unknown _system_config"):
        cfg.apply_overrides({"not_a_flag": 1})
