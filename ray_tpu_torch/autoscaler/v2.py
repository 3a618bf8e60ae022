"""Autoscaler v2: explicit per-instance lifecycle driven by a reconciler.

Reference: ``python/ray/autoscaler/v2/`` — ``instance_manager/`` keeps one
state machine per INSTANCE (not per launch request) with validated
transitions and a status history, and a reconciler diffs desired state
against both the cloud provider and the ray cluster every tick. The v1
``StandardAutoscaler`` (autoscaler.py) launches fire-and-forget; this
module tracks each machine from QUEUED to TERMINATED, retries failed
allocations with backoff, and pairs cloud instances with the ray nodes
that eventually join.

Lite by design: in-memory instance table (the reference persists to the
GCS KV), cooperative AsyncNodeProvider interface (request/poll/terminate)
instead of cloud SDK threads. FakeAsyncProvider simulates slow allocation
and injected failures for tests; real providers implement the same three
methods.

Each ``update()`` first tells the head which resource shapes the node
types offer (``rpc_autoscaler_offer``), so that a GPU request waits for the
GPU node this autoscaler can buy instead of failing at once (the port's
head refuses a GPU request that no node can ever take; the reference's
always waits).
"""

from __future__ import annotations

import itertools
import time
from typing import Optional

# -- instance FSM ------------------------------------------------------------

QUEUED = "QUEUED"                      # wanted; not yet requested from the cloud
REQUESTED = "REQUESTED"                # create call issued; waiting on the cloud
ALLOCATED = "ALLOCATED"                # machine exists; ray not up yet
RAY_RUNNING = "RAY_RUNNING"            # its ray node registered with the head
TERMINATING = "TERMINATING"            # terminate call issued
TERMINATED = "TERMINATED"              # gone (terminal)
ALLOCATION_FAILED = "ALLOCATION_FAILED"  # cloud refused; retried with backoff

#: validated edges (reference: InstanceUtil.get_valid_transitions)
_TRANSITIONS: dict[str, set] = {
    QUEUED: {REQUESTED},
    REQUESTED: {ALLOCATED, ALLOCATION_FAILED},
    ALLOCATED: {RAY_RUNNING, TERMINATING},
    RAY_RUNNING: {TERMINATING},
    TERMINATING: {TERMINATED},
    ALLOCATION_FAILED: {QUEUED, TERMINATED},
    TERMINATED: set(),
}


class Instance:
    _ids = itertools.count(1)

    def __init__(self, node_type: str):
        self.instance_id = f"i-{next(Instance._ids):06d}"
        self.node_type = node_type
        self.status = QUEUED
        self.provider_id: Optional[str] = None
        self.ray_node_id: Optional[str] = None
        self.retries = 0
        self.next_retry_at = 0.0
        self.idle_since: Optional[float] = None
        self.status_history: list[tuple[str, float]] = [(QUEUED, time.time())]

    def set_status(self, status: str) -> None:
        if status not in _TRANSITIONS[self.status]:
            raise ValueError(
                f"invalid transition {self.status} -> {status} for {self.instance_id}"
            )
        self.status = status
        self.status_history.append((status, time.time()))


class InstanceManager:
    """The instance table + validated transitions (reference:
    instance_manager/instance_manager.py over instance_storage)."""

    def __init__(self):
        self.instances: dict[str, Instance] = {}

    def add(self, node_type: str) -> Instance:
        inst = Instance(node_type)
        self.instances[inst.instance_id] = inst
        return inst

    def with_status(self, *statuses: str) -> list[Instance]:
        return [i for i in self.instances.values() if i.status in statuses]

    def active(self) -> list[Instance]:
        return self.with_status(QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING, ALLOCATION_FAILED)


class AsyncNodeProvider:
    """Cooperative cloud interface: requests return immediately; progress
    is observed by polling (reference: v2 node provider abstraction)."""

    def request_create(self, instance: Instance, resources: dict, labels: dict) -> None:
        """``labels`` are the node type's labels: the provider must stamp
        them on the launched node (plus ``instance_id``) or label-gated
        demand would never match the machine bought for it."""
        raise NotImplementedError

    def poll(self, instance: Instance) -> str:
        """Return the PROVIDER's view: REQUESTED (still pending), ALLOCATED,
        or ALLOCATION_FAILED."""
        raise NotImplementedError

    def terminate(self, instance: Instance) -> None:
        raise NotImplementedError


class AutoscalerV2:
    """Reconciler: demand + min/max workers → desired instances; every
    ``update()`` advances each instance one legal step (reference:
    v2 Reconciler.sync in autoscaler/v2/instance_manager/reconciler.py)."""

    def __init__(
        self,
        provider: AsyncNodeProvider,
        node_types: dict,
        head=None,
        ctx=None,
        idle_timeout_s: float = 30.0,
        max_allocation_retries: int = 3,
        retry_backoff_s: float = 2.0,
    ):
        self.provider = provider
        self.node_types = node_types
        self.im = InstanceManager()
        self._head = head
        self._ctx = ctx
        self.idle_timeout_s = idle_timeout_s
        self.max_allocation_retries = max_allocation_retries
        self.retry_backoff_s = retry_backoff_s

    # -- cluster feeds -----------------------------------------------------

    def _offer(self) -> None:
        shapes = [self._capacity_of(t) for t in self.node_types]
        if self._ctx is not None:
            self._ctx.call("autoscaler_offer", shapes=shapes)
        elif self._head is not None:
            self._head.rpc_autoscaler_offer(shapes)

    def _demand(self) -> dict:
        if self._ctx is not None:
            return self._ctx.call("autoscaler_demand")
        if self._head is not None:
            return self._head.rpc_autoscaler_demand()
        return {"pending_demand": [], "nodes": []}

    # -- reconciliation ----------------------------------------------------

    def update(self) -> dict:
        now = time.time()
        self._offer()
        feed = self._demand()
        self._reconcile_ray_nodes(feed)
        self._scale_up(feed)
        self._drive_lifecycle(now)
        self._scale_down(feed, now)
        counts: dict[str, int] = {}
        for i in self.im.instances.values():
            counts[i.status] = counts.get(i.status, 0) + 1
        return counts

    def _capacity_of(self, node_type: str) -> dict:
        return dict(self.node_types[node_type].get("resources", {}))

    def _scale_up(self, feed: dict) -> None:
        """Bin-pack unplaceable demand + honor min_workers (reference:
        resource_demand_scheduler fitting pending shapes)."""
        active_by_type: dict[str, int] = {}
        for i in self.im.active():
            active_by_type[i.node_type] = active_by_type.get(i.node_type, 0) + 1
        # min workers first
        for t, spec in self.node_types.items():
            for _ in range(spec.get("min_workers", 0) - active_by_type.get(t, 0)):
                self.im.add(t)
                active_by_type[t] = active_by_type.get(t, 0) + 1
        # then demand: each unplaceable shape gets the first type that fits,
        # packing multiple shapes onto one pending instance's capacity —
        # but a hard-labeled shape only onto a type whose labels satisfy it
        pending_caps: list[tuple[dict, dict]] = [
            (self._capacity_of(i.node_type), self.node_types[i.node_type].get("labels", {}))
            for i in self.im.with_status(QUEUED, REQUESTED, ALLOCATED)
        ]
        label_reqs = feed.get("pending_demand_labels") or []
        for idx, shape in enumerate(feed.get("pending_demand", [])):
            hard_labels = label_reqs[idx] if idx < len(label_reqs) else {}
            shape = {k: v for k, v in shape.items() if v > 0}
            if not shape:
                continue
            if hard_labels and not any(
                all(spec.get("labels", {}).get(k) == v for k, v in hard_labels.items())
                for spec in self.node_types.values()
            ):
                continue  # no node type can ever satisfy these labels:
                # launching would ratchet useless instances to max_workers
            placed = False
            for cap, cap_labels in pending_caps:
                if any(cap_labels.get(k) != v for k, v in hard_labels.items()):
                    continue
                if all(cap.get(k, 0.0) >= v for k, v in shape.items()):
                    for k, v in shape.items():
                        cap[k] = cap.get(k, 0.0) - v
                    placed = True
                    break
            if placed:
                continue
            for t, spec in self.node_types.items():
                cap = self._capacity_of(t)
                if not all(cap.get(k, 0.0) >= v for k, v in shape.items()):
                    continue
                if active_by_type.get(t, 0) >= spec.get("max_workers", 2**31):
                    continue  # this type is full; a later type may still fit
                type_labels = spec.get("labels", {})
                if any(type_labels.get(k) != v for k, v in hard_labels.items()):
                    continue  # type can never satisfy the task's hard labels
                self.im.add(t)
                active_by_type[t] = active_by_type.get(t, 0) + 1
                for k, v in shape.items():
                    cap[k] -= v
                pending_caps.append((cap, type_labels))
                break

    def _drive_lifecycle(self, now: float) -> None:
        for inst in list(self.im.instances.values()):
            if inst.status == QUEUED:
                inst.set_status(REQUESTED)
                spec = self.node_types[inst.node_type]
                self.provider.request_create(
                    inst, self._capacity_of(inst.node_type), dict(spec.get("labels", {}))
                )
            elif inst.status == REQUESTED:
                seen = self.provider.poll(inst)
                if seen == ALLOCATED:
                    inst.set_status(ALLOCATED)
                elif seen == ALLOCATION_FAILED:
                    inst.set_status(ALLOCATION_FAILED)
                    inst.retries += 1
                    inst.next_retry_at = now + self.retry_backoff_s * inst.retries
            elif inst.status == ALLOCATION_FAILED:
                if inst.retries > self.max_allocation_retries:
                    inst.set_status(TERMINATED)
                elif now >= inst.next_retry_at:
                    inst.set_status(QUEUED)  # re-request next tick
            elif inst.status == TERMINATING:
                self.provider.terminate(inst)
                inst.set_status(TERMINATED)

    def _reconcile_ray_nodes(self, feed: dict) -> None:
        """Pair ALLOCATED instances with the ray nodes that joined, keyed by
        the provider's instance label on the node (reference: the
        reconciler's cloud-instance <-> ray-node matching)."""
        nodes = feed.get("nodes", [])
        by_label = {
            n.get("labels", {}).get("instance_id"): n for n in nodes if n.get("labels")
        }
        # cloud pools (GKE) can't stamp the autoscaler's instance_id on a VM
        # ahead of a resize — those nodes join labeled with their VM name
        # instead (the startup-script contract in autoscaler/gke.py)
        by_provider = {
            n.get("labels", {}).get("provider_node_id"): n
            for n in nodes
            if n.get("labels", {}).get("provider_node_id")
        }
        for inst in self.im.with_status(ALLOCATED):
            node = by_label.get(inst.instance_id) or by_provider.get(inst.provider_id)
            if node is not None:
                inst.ray_node_id = node.get("node_id")
                inst.set_status(RAY_RUNNING)

    def _scale_down(self, feed: dict, now: float) -> None:
        """Idle RAY_RUNNING instances beyond min_workers terminate after
        the idle timeout."""
        nodes = {n.get("node_id"): n for n in feed.get("nodes", [])}
        running_by_type: dict[str, list[Instance]] = {}
        for inst in self.im.with_status(RAY_RUNNING):
            running_by_type.setdefault(inst.node_type, []).append(inst)
            node = nodes.get(inst.ray_node_id)
            idle = bool(node) and not node.get("busy", False)
            if idle:
                if inst.idle_since is None:
                    inst.idle_since = now
            else:
                inst.idle_since = None
        for t, insts in running_by_type.items():
            floor = self.node_types[t].get("min_workers", 0)
            killable = sorted(
                (i for i in insts if i.idle_since is not None
                 and now - i.idle_since >= self.idle_timeout_s),
                key=lambda i: i.idle_since,
            )
            for inst in killable[: max(len(insts) - floor, 0)]:
                inst.set_status(TERMINATING)


class FakeAsyncProvider(AsyncNodeProvider):
    """Simulated cloud: allocation completes after ``delay_polls`` polls;
    ``fail_first`` injected failures before allocations succeed. On
    allocation the instance's ray node 'joins' the supplied cluster with an
    instance_id label, closing the reconcile loop like a real node would."""

    def __init__(self, cluster=None, delay_polls: int = 1, fail_first: int = 0):
        self.cluster = cluster
        self.delay_polls = delay_polls
        self.fail_first = fail_first
        self._polls: dict[str, int] = {}
        self._resources_by_id: dict[str, dict] = {}
        self._labels_by_id: dict[str, dict] = {}
        self.created: list[str] = []
        self.terminated: list[str] = []

    def request_create(self, instance: Instance, resources: dict, labels: dict) -> None:
        self._polls[instance.instance_id] = 0
        instance.provider_id = f"cloud-{instance.instance_id}"
        self._resources_by_id[instance.instance_id] = dict(resources)
        self._labels_by_id[instance.instance_id] = dict(labels)

    def poll(self, instance: Instance) -> str:
        self._polls[instance.instance_id] += 1
        if self._polls[instance.instance_id] < self.delay_polls:
            return REQUESTED
        if self.fail_first > 0:
            self.fail_first -= 1
            return ALLOCATION_FAILED
        self.created.append(instance.provider_id)
        if self.cluster is not None:
            node_id = self.cluster.add_node(
                resources=dict(self._resources_by_id[instance.instance_id]),
                labels={**self._labels_by_id[instance.instance_id],
                        "instance_id": instance.instance_id},
            )
            instance.ray_node_id = node_id.hex()
        return ALLOCATED

    def terminate(self, instance: Instance) -> None:
        self.terminated.append(instance.provider_id)
        if self.cluster is not None and instance.ray_node_id:
            from ray_tpu_torch._private.ids import NodeID

            try:
                self.cluster.remove_node(NodeID(bytes.fromhex(instance.ray_node_id)))
            except Exception:
                pass
