"""The port's runtime against the reference's tests: a mirror of
``tests/test_worker_forkserver.py`` run on ``ray_tpu_torch``, with no wall-clock bar
and without the tests of modules still to port.

Worker forkserver template + idle-worker adoption (VERDICT r4 #2).

Reference: the raylet's pre-started worker pool
(``src/ray/raylet/worker_pool.h:152``) exists so leases never pay
interpreter boot; the TPU build's answer is a per-node warm template every
worker forks from (``_private/worker_template.py``) plus actor adoption of
idle pool workers. The spawn-rate target comes from the 40k-actor
scalability envelope (``release/benchmarks/README.md:12``).
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.config import GLOBAL_CONFIG


@pytest.fixture
def cluster():
    ray_tpu_torch.init(num_cpus=4, num_tpus=0)
    yield
    ray_tpu_torch.shutdown()


def _head():
    from ray_tpu_torch._private.runtime import get_ctx

    return get_ctx().head


def test_template_forks_workers(cluster):
    @ray_tpu_torch.remote(num_cpus=0)
    class A:
        def pid(self):
            import os

            return os.getpid()

    actors = [A.remote() for _ in range(8)]
    pids = ray_tpu_torch.get([a.pid.remote() for a in actors], timeout=120)
    assert len(set(pids)) == 8
    h = _head()
    node = next(iter(h.nodes.values()))
    assert node.template is not None and node.template.alive()
    # every dedicated actor worker either forked from the template or was
    # adopted from the pool — no cold Popen spawns on the default env path
    forked = [w for w in node.all_workers if w.alive and w.actor_id is not None]
    assert forked and all(w.forked or w.proc is None or not hasattr(w.proc, "popen") for w in forked)
    for a in actors:
        ray_tpu_torch.kill(a)


def test_forked_worker_runs_plain_tasks(cluster):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    assert ray_tpu_torch.get([f.remote(i) for i in range(50)], timeout=120) == list(
        range(1, 51)
    )


def test_actor_adopts_idle_pool_worker(cluster):
    @ray_tpu_torch.remote
    def warm():
        import os

        return os.getpid()

    pool_pid = ray_tpu_torch.get(warm.remote(), timeout=60)
    h = _head()
    node = next(iter(h.nodes.values()))
    assert node.idle_workers, "expected an idle pool worker after the task"
    n_workers = len([w for w in node.all_workers if w.alive])

    @ray_tpu_torch.remote(num_cpus=0)
    class A:
        def pid(self):
            import os

            return os.getpid()

    a = A.remote()
    actor_pid = ray_tpu_torch.get(a.pid.remote(), timeout=60)
    # the actor took over the idle pool worker: same process, no new spawn
    assert actor_pid == pool_pid
    assert len([w for w in node.all_workers if w.alive]) == n_workers
    ray_tpu_torch.kill(a)


def test_forkserver_disabled_falls_back(cluster_off=None):
    old = GLOBAL_CONFIG.worker_forkserver_enabled
    GLOBAL_CONFIG.worker_forkserver_enabled = False
    try:
        ray_tpu_torch.init(num_cpus=2, num_tpus=0)

        @ray_tpu_torch.remote
        def f():
            return 42

        assert ray_tpu_torch.get(f.remote(), timeout=120) == 42
        from ray_tpu_torch._private.runtime import get_ctx

        node = next(iter(get_ctx().head.nodes.values()))
        assert node.template is None
        assert all(not w.forked for w in node.all_workers)
    finally:
        GLOBAL_CONFIG.worker_forkserver_enabled = old
        ray_tpu_torch.shutdown()

