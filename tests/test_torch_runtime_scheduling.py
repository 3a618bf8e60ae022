"""The port's runtime against the reference's tests: a mirror of
``tests/test_scheduling_policies.py`` run on ``ray_tpu_torch``, with no wall-clock bar
and without the tests of modules still to port.

Scheduling-policy residue (reference: raylet/scheduling/policy/): node
labels (hard + soft), label_selector, and the deep-queue envelope the
signature-bucketed scheduler is built for."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.runtime import get_ctx
from ray_tpu_torch.util.scheduling_strategies import NodeLabelSchedulingStrategy


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


def test_hard_label_selection(ray_start_regular):
    head = get_ctx().head
    gpuish = head.add_node({"CPU": 2.0}, labels={"accel": "v5e", "zone": "a"})
    head.add_node({"CPU": 2.0}, labels={"accel": "cpu", "zone": "b"})

    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        import ray_tpu_torch as rt

        return rt.get_runtime_context().get_node_id()

    strat = NodeLabelSchedulingStrategy(hard={"accel": "v5e"})
    nodes = set(
        ray_tpu_torch.get(
            [where.options(scheduling_strategy=strat).remote() for _ in range(4)],
            timeout=60,
        )
    )
    assert nodes == {gpuish.hex()}


def test_label_selector_option(ray_start_regular):
    head = get_ctx().head
    target = head.add_node({"CPU": 2.0}, labels={"pool": "inference"})

    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        import ray_tpu_torch as rt

        return rt.get_runtime_context().get_node_id()

    got = ray_tpu_torch.get(
        where.options(label_selector={"pool": "inference"}).remote(), timeout=60
    )
    assert got == target.hex()


def test_soft_labels_prefer_but_fall_back(ray_start_regular):
    head = get_ctx().head
    preferred = head.add_node({"CPU": 1.0}, labels={"tier": "fast"})
    head.add_node({"CPU": 8.0}, labels={"tier": "slow"})

    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        import ray_tpu_torch as rt

        return rt.get_runtime_context().get_node_id()

    strat = NodeLabelSchedulingStrategy(soft={"tier": "fast"})
    # first task lands on the preferred node...
    assert ray_tpu_torch.get(
        where.options(scheduling_strategy=strat).remote(), timeout=60
    ) == preferred.hex()
    # ...and an infeasible-preference task still runs somewhere (soft)
    strat2 = NodeLabelSchedulingStrategy(soft={"tier": "nonexistent"})
    assert ray_tpu_torch.get(
        where.options(scheduling_strategy=strat2).remote(), timeout=60
    )


def test_unsatisfiable_hard_labels_stay_pending(ray_start_regular):
    @ray_tpu_torch.remote
    def nope():
        return 1

    strat = NodeLabelSchedulingStrategy(hard={"planet": "mars"})
    ref = nope.options(scheduling_strategy=strat).remote()
    with pytest.raises(Exception):
        ray_tpu_torch.get(ref, timeout=1.5)  # GetTimeoutError: pending forever
    ray_tpu_torch.cancel(ref)

