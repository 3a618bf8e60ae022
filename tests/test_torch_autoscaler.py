"""The port's autoscaler (``ray_tpu_torch.autoscaler``) against the
reference's tests: ``tests/test_autoscaler.py`` (v1: ``StandardAutoscaler``,
``Monitor``, ``FakeNodeProvider``, ``GKETPUNodeProvider``) and
``tests/test_autoscaler_v2.py`` (the instance state machine and the
reconciler), one case each, with ``ray_tpu`` renamed. Each test gets a
fresh cluster, as the reference's fixtures give it, since an autoscaler
adds nodes to its cluster and offers its node types to the head.

Beyond the reference: a ``num_gpus=1`` actor on a cluster with no GPU node
waits for the GPU node an autoscaler offers and runs on it, where without
the offer it fails at once (the port's head refuses GPU work no node can
ever take)."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import FakeNodeProvider, GKETPUNodeProvider, Monitor, StandardAutoscaler
from ray_tpu_torch.autoscaler.v2 import (
    ALLOCATED,
    ALLOCATION_FAILED,
    QUEUED,
    RAY_RUNNING,
    REQUESTED,
    TERMINATED,
    TERMINATING,
    AutoscalerV2,
    FakeAsyncProvider,
    Instance,
)
from ray_tpu_torch.exceptions import RayError


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    c.connect()
    yield c
    c.shutdown()


# -- tests/test_autoscaler.py ------------------------------------------------


def test_scale_up_for_infeasible_task(cluster):
    provider = FakeNodeProvider(cluster)
    scaler = StandardAutoscaler(
        provider,
        node_types={"big": {"resources": {"CPU": 4}, "max_workers": 2}},
        idle_timeout_s=1.0,
        launch_grace_s=0.0,
        head=cluster.head,
    )

    @ray_tpu_torch.remote(num_cpus=4)
    def heavy():
        return 42

    ref = heavy.remote()  # infeasible on the 1-CPU head node
    time.sleep(0.2)
    result = scaler.update()
    assert len(result["launched"]) == 1, result
    assert ray_tpu_torch.get(ref, timeout=60) == 42

    # scale-down: node drains, goes idle past the timeout, gets reaped
    deadline = time.time() + 30
    terminated = []
    while time.time() < deadline and not terminated:
        time.sleep(0.3)
        terminated = scaler.update()["terminated"]
    assert terminated, "idle autoscaled node never reaped"
    assert provider.non_terminated_nodes() == []


def test_scale_respects_max_workers(cluster):
    provider = FakeNodeProvider(cluster)
    scaler = StandardAutoscaler(
        provider,
        node_types={"big": {"resources": {"CPU": 2}, "max_workers": 1}},
        idle_timeout_s=60.0,
        head=cluster.head,
    )

    @ray_tpu_torch.remote(num_cpus=2)
    def heavy(i):
        time.sleep(0.5)
        return i

    refs = [heavy.remote(i) for i in range(4)]
    time.sleep(0.2)
    r1 = scaler.update()
    r2 = scaler.update()
    assert len(r1["launched"]) == 1
    assert len(r2["launched"]) == 0  # capped at max_workers=1
    assert ray_tpu_torch.get(refs, timeout=120) == [0, 1, 2, 3]


def test_min_workers_and_monitor(cluster):
    provider = FakeNodeProvider(cluster)
    scaler = StandardAutoscaler(
        provider,
        node_types={"std": {"resources": {"CPU": 2}, "min_workers": 1, "max_workers": 2}},
        idle_timeout_s=60.0,
        head=cluster.head,
    )
    monitor = Monitor(scaler, interval_s=0.1).start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not provider.non_terminated_nodes():
            time.sleep(0.1)
        assert len(provider.non_terminated_nodes()) == 1  # min_workers satisfied
    finally:
        monitor.stop()


def test_pending_actor_demand_counts(cluster):
    provider = FakeNodeProvider(cluster)
    scaler = StandardAutoscaler(
        provider,
        node_types={"big": {"resources": {"CPU": 4}, "max_workers": 1}},
        idle_timeout_s=60.0,
        head=cluster.head,
    )

    @ray_tpu_torch.remote(num_cpus=4)
    class Big:
        def ping(self):
            return True

    a = Big.remote()  # pending: no node has 4 CPUs
    time.sleep(0.2)
    result = scaler.update()
    assert len(result["launched"]) == 1
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60)


def test_gke_provider_requires_client():
    p = GKETPUNodeProvider(project="p", zone="z", cluster_name="c")
    with pytest.raises(RuntimeError, match="needs a GKE client"):
        p.create_node("v5e-8", {"TPU": 8}, {})

    class FakeGKE:
        def __init__(self):
            self.n = 0

        def scale_up(self, node_pool, labels):
            self.n += 1
            return f"gke-{node_pool}-{self.n}"

        def delete(self, pid):
            self.n -= 1

    p2 = GKETPUNodeProvider(project="p", zone="z", cluster_name="c", client=FakeGKE())
    pid = p2.create_node("v5e-8", {"TPU": 8}, {})
    assert p2.non_terminated_nodes() == [pid]
    p2.terminate_node(pid)
    assert p2.non_terminated_nodes() == []


# -- tests/test_autoscaler_v2.py ---------------------------------------------


def test_fsm_rejects_invalid_transitions():
    inst = Instance("t")
    inst.set_status(REQUESTED)
    with pytest.raises(ValueError, match="invalid transition"):
        inst.set_status(RAY_RUNNING)  # must pass through ALLOCATED
    inst.set_status(ALLOCATED)
    inst.set_status(RAY_RUNNING)
    inst.set_status(TERMINATING)
    inst.set_status(TERMINATED)
    with pytest.raises(ValueError):
        inst.set_status(QUEUED)  # terminal
    assert [s for s, _t in inst.status_history] == [
        QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING, TERMINATING, TERMINATED,
    ]


def test_scale_up_full_lifecycle(ray_start_regular):
    """Unplaceable demand drives QUEUED→REQUESTED→ALLOCATED→RAY_RUNNING,
    and the task then actually schedules on the joined node."""
    from ray_tpu_torch._private.runtime import get_ctx

    head = get_ctx().head

    @ray_tpu_torch.remote(resources={"bignode": 1.0})
    def needs_big():
        return "ran"

    ref = needs_big.remote()  # infeasible until the autoscaler acts
    provider = FakeAsyncProvider(cluster=head, delay_polls=2)
    asv2 = AutoscalerV2(
        provider,
        {"big": {"resources": {"CPU": 4.0, "bignode": 4.0}, "max_workers": 2}},
        head=head,
    )
    statuses = []
    for _ in range(8):
        counts = asv2.update()
        statuses.append(dict(counts))
        if counts.get(RAY_RUNNING):
            break
        time.sleep(0.05)
    assert any(s.get(REQUESTED) for s in statuses), statuses  # passed through
    assert statuses[-1].get(RAY_RUNNING) == 1, statuses
    assert ray_tpu_torch.get(ref, timeout=60) == "ran"
    inst = next(iter(asv2.im.instances.values()))
    assert inst.ray_node_id and inst.provider_id in provider.created


def test_allocation_failure_retries_with_backoff(ray_start_regular):
    from ray_tpu_torch._private.runtime import get_ctx

    head = get_ctx().head
    provider = FakeAsyncProvider(cluster=head, delay_polls=1, fail_first=2)
    asv2 = AutoscalerV2(
        provider,
        {"w": {"resources": {"CPU": 1.0, "w": 1.0}, "min_workers": 1, "max_workers": 1}},
        head=head,
        retry_backoff_s=0.05,
    )
    deadline = time.monotonic() + 20
    saw_failed = False
    while time.monotonic() < deadline:
        counts = asv2.update()
        saw_failed = saw_failed or bool(counts.get(ALLOCATION_FAILED))
        if counts.get(RAY_RUNNING):
            break
        time.sleep(0.06)
    assert saw_failed, "failure injection never observed"
    inst = next(iter(asv2.im.instances.values()))
    assert inst.status == RAY_RUNNING and inst.retries == 2


def test_retry_budget_exhaustion(ray_start_regular):
    from ray_tpu_torch._private.runtime import get_ctx

    head = get_ctx().head
    provider = FakeAsyncProvider(cluster=head, delay_polls=1, fail_first=99)
    asv2 = AutoscalerV2(
        provider,
        {"w": {"resources": {"CPU": 1.0}, "min_workers": 1, "max_workers": 1}},
        head=head,
        max_allocation_retries=2,
        retry_backoff_s=0.01,
    )
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        asv2.update()
        insts = [
            i for i in asv2.im.instances.values()
            if i.status == TERMINATED and i.retries > 2
        ]
        if insts:
            break
        time.sleep(0.02)
    assert insts, "instance never gave up"


# the reference marks this one slow (real idle timers have to elapse); the
# mirror keeps its mark
@pytest.mark.slow
def test_idle_scale_down_respects_min_workers(ray_start_regular):
    from ray_tpu_torch._private.runtime import get_ctx

    head = get_ctx().head
    provider = FakeAsyncProvider(cluster=head, delay_polls=1)
    asv2 = AutoscalerV2(
        provider,
        {"w": {"resources": {"CPU": 1.0, "scaletest": 1.0}, "min_workers": 2, "max_workers": 4}},
        head=head,
        idle_timeout_s=0.2,
    )
    # reach 2 RAY_RUNNING (min_workers), then add demand-driven extras
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        counts = asv2.update()
        if counts.get(RAY_RUNNING, 0) >= 2:
            break
        time.sleep(0.05)
    assert counts.get(RAY_RUNNING, 0) == 2
    # idle nodes past timeout: min_workers floor must hold
    time.sleep(0.4)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        counts = asv2.update()
        time.sleep(0.05)
    running = asv2.im.with_status(RAY_RUNNING)
    assert len(running) == 2, counts  # floor held, nothing below min


def test_labeled_demand_launches_labeled_node(ray_start_regular):
    """A hard-label task must (a) pick the node type whose labels satisfy it
    and (b) actually run — i.e. the provider stamps the type's labels onto
    the launched node, not just instance_id."""
    from ray_tpu_torch._private.runtime import get_ctx
    from ray_tpu_torch.util.scheduling_strategies import NodeLabelSchedulingStrategy

    head = get_ctx().head

    @ray_tpu_torch.remote(scheduling_strategy=NodeLabelSchedulingStrategy(
        hard={"accel": "v5e"}), resources={"labnode": 1.0})
    def on_v5e():
        return "labeled"

    ref = on_v5e.remote()  # no node carries accel=v5e yet
    provider = FakeAsyncProvider(cluster=head, delay_polls=1)
    asv2 = AutoscalerV2(
        provider,
        {
            "plain": {"resources": {"CPU": 4.0, "labnode": 4.0}, "max_workers": 2},
            "lab": {"resources": {"CPU": 4.0, "labnode": 4.0},
                    "labels": {"accel": "v5e"}, "max_workers": 2},
        },
        head=head,
    )
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        counts = asv2.update()
        if counts.get(RAY_RUNNING):
            break
        time.sleep(0.05)
    # the plain type also fits the resource shape, but only 'lab' satisfies
    # the hard label — exactly one instance, of the labeled type
    types = [i.node_type for i in asv2.im.active()]
    assert types == ["lab"], types
    assert ray_tpu_torch.get(ref, timeout=60) == "labeled"


# -- the port's GPU offer ----------------------------------------------------


def gpu_actor():
    """A ``num_gpus=1`` actor class made in a function: workers cannot
    import ``tests/``, so the class travels by value."""

    class GPUActor:
        def node(self):
            import ray_tpu_torch as rt

            return rt.get_runtime_context().get_node_id()

    return ray_tpu_torch.remote(num_gpus=1)(GPUActor)


@pytest.mark.parametrize("v2", [True, False], ids=["v2", "v1"])
def test_gpu_actor_waits_for_the_gpu_node_an_autoscaler_offers(cluster, v2):
    """No node has a GPU, but the autoscaler's node type does: the
    ``num_gpus=1`` actor waits (as the reference's always waits), the
    autoscaler buys exactly one GPU node, and the actor runs there."""
    types = {"gpu_worker": {"resources": {"GPU": 1.0, "CPU": 4.0}, "min_workers": 0, "max_workers": 1}}
    if v2:
        scaler = AutoscalerV2(FakeAsyncProvider(cluster=cluster, delay_polls=1), types, head=cluster.head)
    else:
        scaler = StandardAutoscaler(FakeNodeProvider(cluster), types, launch_grace_s=0.0, head=cluster.head)
    scaler.update()  # offers the node types before any demand
    actor = gpu_actor().remote()
    ref = actor.node.remote()
    deadline = time.monotonic() + 30
    ready = []
    while time.monotonic() < deadline and not ready:
        scaler.update()
        assert ray_tpu_torch.cluster_resources().get("GPU", 0.0) <= 1.0
        ready, _ = ray_tpu_torch.wait([ref], timeout=0.1)
    node = ray_tpu_torch.get(ref, timeout=30)
    gpu_nodes = [n for n in ray_tpu_torch.nodes() if n["Resources"].get("GPU", 0) > 0]
    assert [n["NodeID"] for n in gpu_nodes] == [node]
    assert node != cluster.head_node.hex()
    ray_tpu_torch.kill(actor)


def test_node_of_a_killed_actor_scales_down(cluster):
    """After ``kill`` of the only actor on an autoscaled node, the node goes
    idle and autoscaler v2 terminates it. (The reference's feed keeps such
    a node busy for good: the killed actor's retired worker keeps its create
    task as ``current_task``; the port's feed counts live workers only.)"""
    types = {"gpu_worker": {"resources": {"GPU": 1.0, "CPU": 4.0}, "min_workers": 0, "max_workers": 1}}
    scaler = AutoscalerV2(FakeAsyncProvider(cluster=cluster, delay_polls=1), types, head=cluster.head,
                          idle_timeout_s=0.5)
    scaler.update()
    actor = gpu_actor().remote()
    ref = actor.node.remote()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not ray_tpu_torch.wait([ref], timeout=0.1)[0]:
        scaler.update()
    ray_tpu_torch.get(ref, timeout=30)
    ray_tpu_torch.kill(actor)
    deadline = time.monotonic() + 30
    counts = {}
    while time.monotonic() < deadline and counts.get(TERMINATED) != 1:
        counts = scaler.update()
        time.sleep(0.1)
    assert counts == {TERMINATED: 1}, counts
    assert ray_tpu_torch.cluster_resources().get("GPU", 0.0) == 0.0


def test_work_on_a_terminated_node_moves_to_another(cluster):
    """A provider's ``terminate_node`` removes the node from the head: the
    task running there is retried on another node and the actor there
    restarts on another, as ``remove_node`` promises. (In the reference both
    wait forever: its ``remove_node`` marks the node's workers dead before
    handing them to the death handler, which skips a worker already
    marked.)"""
    provider = FakeNodeProvider(cluster)
    first = provider.create_node("w", {"CPU": 1.0, "x": 1.0}, {})
    first_id = provider.head_node_id_of(first).hex()

    @ray_tpu_torch.remote(resources={"x": 1.0}, max_retries=1)
    def slow():
        import ray_tpu_torch as rt

        time.sleep(2.0)
        return rt.get_runtime_context().get_node_id()

    @ray_tpu_torch.remote(resources={"x": 0.5}, max_restarts=1)
    class Where:
        def node(self):
            import ray_tpu_torch as rt

            return rt.get_runtime_context().get_node_id()

    actor = Where.remote()
    on_first = ray_tpu_torch.get(actor.node.remote(), timeout=30)
    ref = slow.remote()
    time.sleep(1.0)  # the task is running on the first node
    provider.terminate_node(first)
    second = provider.create_node("w", {"CPU": 1.0, "x": 1.0}, {})
    second_id = provider.head_node_id_of(second).hex()
    assert on_first == first_id
    assert ray_tpu_torch.get(ref, timeout=30) == second_id
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            assert ray_tpu_torch.get(actor.node.remote(), timeout=30) == second_id
            break
        except ray_tpu_torch.exceptions.RayActorError:
            time.sleep(0.2)  # the restart is still in flight
    else:
        raise AssertionError("the actor never came back on the second node")


def test_gpu_actor_without_an_offer_fails_at_once(cluster):
    t0 = time.monotonic()
    actor = gpu_actor().remote()
    with pytest.raises(RayError, match="no node of this cluster has a GPU"):
        ray_tpu_torch.get(actor.node.remote(), timeout=30)
    assert time.monotonic() - t0 < 10
