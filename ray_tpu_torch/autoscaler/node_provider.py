"""NodeProvider: the pluggable boundary between the autoscaler and whatever
actually creates machines.

Reference: ``python/ray/autoscaler/node_provider.py`` (create_node /
terminate_node / non_terminated_nodes / node_tags) and the in-process fake
(``autoscaler/_private/fake_multi_node/node_provider.py:237``). The fake
here registers virtual NodeStates against the live head via
``cluster_utils.Cluster.add_node`` — scheduling, worker spawn and task
execution on the "new machine" are all real; only the machine is virtual.

``GKETPUNodeProvider`` is the deployment-shaped stub: node types map to GKE
node pools of TPU slices (one provider "node" = one slice host group), and
create/terminate calls would go through the GKE API. It raises unless its
client is injected — keeping the control flow testable without egress.
"""

from __future__ import annotations

import uuid
from typing import Any, Optional


class NodeProvider:
    """Minimal provider surface the autoscaler drives."""

    def create_node(self, node_type: str, resources: dict, labels: dict) -> str:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> list[str]:
        raise NotImplementedError

    def node_resources(self, provider_node_id: str) -> dict:
        raise NotImplementedError


class FakeNodeProvider(NodeProvider):
    """In-process provider over a ``cluster_utils.Cluster``."""

    def __init__(self, cluster):
        self.cluster = cluster
        self._nodes: dict[str, Any] = {}   # provider id -> head NodeID
        self._meta: dict[str, dict] = {}

    def create_node(self, node_type: str, resources: dict, labels: dict) -> str:
        pid = f"fake-{node_type}-{uuid.uuid4().hex[:6]}"
        node_id = self.cluster.add_node(
            resources=dict(resources), labels={**labels, "node_type": node_type}
        )
        self._nodes[pid] = node_id
        self._meta[pid] = {"type": node_type, "resources": dict(resources)}
        return pid

    def terminate_node(self, provider_node_id: str) -> None:
        node_id = self._nodes.pop(provider_node_id, None)
        self._meta.pop(provider_node_id, None)
        if node_id is not None:
            self.cluster.remove_node(node_id)

    def non_terminated_nodes(self) -> list[str]:
        return list(self._nodes)

    def node_resources(self, provider_node_id: str) -> dict:
        return dict(self._meta[provider_node_id]["resources"])

    def head_node_id_of(self, provider_node_id: str):
        return self._nodes.get(provider_node_id)


class GKETPUNodeProvider(NodeProvider):
    """GKE TPU node-pool provider skeleton.

    Node types are TPU slice shapes (e.g. ``v5e-8``: one host of a v5e-8
    slice with resources ``{"TPU": 8, "CPU": 44, "tpu-v5e-8-head": 1}``).
    ``create_node`` scales the matching GKE node pool up by one;
    ``terminate_node`` deletes the VM. The GKE REST client must be injected
    (``client=``) — this image has no egress, so the default raises with the
    exact calls a deployment needs.
    """

    def __init__(
        self,
        project: str = "",
        zone: str = "",
        cluster_name: str = "",
        client: Optional[Any] = None,
    ):
        self.project = project
        self.zone = zone
        self.cluster_name = cluster_name
        self.client = client
        self._nodes: dict[str, dict] = {}

    def _require_client(self, op: str):
        if self.client is None:
            raise RuntimeError(
                f"GKETPUNodeProvider.{op} needs a GKE client: inject one "
                f"implementing setNodePoolSize/deleteNode against "
                f"projects/{self.project}/zones/{self.zone}/clusters/{self.cluster_name}"
            )

    def create_node(self, node_type: str, resources: dict, labels: dict) -> str:
        self._require_client("create_node")
        pid = self.client.scale_up(node_pool=node_type, labels=labels)
        self._nodes[pid] = {"type": node_type, "resources": dict(resources)}
        return pid

    def terminate_node(self, provider_node_id: str) -> None:
        self._require_client("terminate_node")
        self.client.delete(provider_node_id)
        self._nodes.pop(provider_node_id, None)

    def non_terminated_nodes(self) -> list[str]:
        return list(self._nodes)

    def node_resources(self, provider_node_id: str) -> dict:
        return dict(self._nodes[provider_node_id]["resources"])
