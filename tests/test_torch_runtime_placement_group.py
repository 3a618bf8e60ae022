"""The port's runtime against the reference's tests: a mirror of
``tests/test_placement_group.py`` run on ``ray_tpu_torch``, with no wall-clock bar
and without the tests of modules still to port.

Placement-group tests (reference: gcs_placement_group_manager /
bundle_scheduling_policy.cc behaviors, python/ray/tests/test_placement_group*)."""

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.placement_group import (
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy


@pytest.fixture
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    ray_tpu_torch.init(address=c.address)
    yield c
    ray_tpu_torch.shutdown()
    try:
        c.shutdown()
    except Exception:
        pass


def test_pg_basic_ready(cluster):
    pg = placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.wait(timeout_seconds=10)


def test_pg_strict_spread_needs_nodes(cluster):
    cluster.add_node(num_cpus=2)
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    assert pg.wait(timeout_seconds=10)


def test_pg_pending_until_node_added(cluster):
    # Regression: a PG that is infeasible at creation must be placed when
    # capacity arrives later (reference: pending PG retry on node add).
    pg = placement_group([{"CPU": 4}], strategy="PACK")
    assert not pg.wait(timeout_seconds=0.5)
    cluster.add_node(num_cpus=4)
    assert pg.wait(timeout_seconds=10)


def test_pg_replace_after_node_death_no_leak(cluster):
    # Regression: after losing the node hosting one bundle, re-placement must
    # not double-allocate the surviving bundle's resources.
    n2 = cluster.add_node(num_cpus=2)
    n3 = cluster.add_node(num_cpus=2)
    pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="STRICT_SPREAD")
    assert pg.wait(timeout_seconds=10)
    before = ray_tpu_torch.available_resources().get("CPU", 0.0)
    cluster.remove_node(n3)
    # bundle from the dead node lands on the remaining free node
    assert pg.wait(timeout_seconds=10)
    after = ray_tpu_torch.available_resources().get("CPU", 0.0)
    # dead node removed 2 CPUs of capacity, but its bundle moved onto
    # previously-free CPUs: availability must not go negative/leak
    assert after >= 0.0
    total = ray_tpu_torch.cluster_resources().get("CPU", 0.0)
    assert total == 4.0  # head(2) + n2(2)
    # both bundles still usable: run a task in each
    @ray_tpu_torch.remote(num_cpus=1)
    def ping():
        return "ok"

    refs = [
        ping.options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=i
            )
        ).remote()
        for i in range(2)
    ]
    assert ray_tpu_torch.get(refs, timeout=30) == ["ok", "ok"]
    remove_placement_group(pg)


def test_pg_task_scheduling(cluster):
    cluster.add_node(num_cpus=2, resources={"TPU": 4})
    pg = placement_group([{"TPU": 2}], strategy="PACK")
    assert pg.wait(timeout_seconds=10)

    @ray_tpu_torch.remote(num_cpus=0, resources={"TPU": 1})
    def use_tpu():
        return "tpu"

    strat = PlacementGroupSchedulingStrategy(placement_group=pg, placement_group_bundle_index=0)
    assert ray_tpu_torch.get(use_tpu.options(scheduling_strategy=strat).remote(), timeout=30) == "tpu"


def test_pg_infeasible_bundle_task_fails_fast(cluster):
    # A task that can never fit its bundle must error, not hang.
    cluster.add_node(num_cpus=2, resources={"TPU": 4})
    pg = placement_group([{"TPU": 2}], strategy="PACK")
    assert pg.wait(timeout_seconds=10)

    @ray_tpu_torch.remote(resources={"TPU": 1})  # implicit num_cpus=1 won't fit
    def needs_cpu():
        return "nope"

    strat = PlacementGroupSchedulingStrategy(placement_group=pg, placement_group_bundle_index=0)
    with pytest.raises(ValueError, match="can never fit"):
        ray_tpu_torch.get(needs_cpu.options(scheduling_strategy=strat).remote(), timeout=30)
