"""In-process multi-node test cluster.

Counterpart of the reference's ``python/ray/cluster_utils.py:108`` —
``Cluster().add_node(resources)`` registers extra virtual nodes against the
same head (the reference starts extra raylet processes; we register extra
NodeStates whose worker pools are real separate processes). This is the
workhorse fixture for scheduling, placement-group and fault-tolerance tests,
including ``remove_node`` as the node-kill fault injection.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

from ray_tpu_torch._private import api as _api
from ray_tpu_torch._private.head import Head
from ray_tpu_torch._private.ids import NodeID


_CLUSTERS: dict[str, "Cluster"] = {}  # address -> cluster, for init(address=...)


def resolve_address(address: str) -> "Cluster":
    c = _CLUSTERS.get(address)
    if c is None:
        raise ValueError(f"Unknown cluster address {address!r}")
    return c


class Cluster:
    def __init__(
        self,
        initialize_head: bool = True,
        head_node_args: Optional[dict] = None,
        head: Optional[Head] = None,
    ):
        """``head=`` wraps an ALREADY-RUNNING head (e.g. the one
        ``ray_tpu_torch up`` hosts) instead of creating a private one — virtual
        nodes then register against the live cluster."""
        self._owns_head = head is None
        if head is not None:
            self.head = head
            self.nodes: list[NodeID] = []
            self.head_node: Optional[NodeID] = None
            return
        self._session_dir = tempfile.mkdtemp(prefix="ray_tpu_cluster_")
        sock = os.path.join(self._session_dir, "head.sock")
        self.head = Head(sock, authkey=os.urandom(16))
        self.head.start()
        self.nodes = []
        self.head_node = None
        if initialize_head:
            args = dict(head_node_args or {})
            self.head_node = self.add_node(**args)

    def add_node(
        self,
        num_cpus: int = 1,
        num_tpus: int = 0,
        num_gpus: int = 0,
        resources: Optional[dict] = None,
        labels: Optional[dict] = None,
        **kwargs,
    ) -> NodeID:
        res = dict(resources or {})
        res.setdefault("CPU", float(num_cpus))
        if num_tpus:
            res.setdefault("TPU", float(num_tpus))
        if num_gpus:
            res.setdefault("GPU", float(num_gpus))
        node_id = self.head.add_node(res, labels=labels)
        self.nodes.append(node_id)
        return node_id

    @property
    def address(self) -> str:
        """Opaque attach address (reference: ``cluster.address`` passed to
        ``ray.init(address=...)``)."""
        addr = f"ray-tpu://{id(self):x}"
        _CLUSTERS[addr] = self
        return addr

    def remove_node(self, node_id: NodeID, allow_graceful: bool = True) -> None:
        """Simulated node failure (reference: cluster.remove_node /
        NodeKillerActor)."""
        self.head.remove_node(node_id)
        if node_id in self.nodes:
            self.nodes.remove(node_id)

    def connect(self):
        """Attach a driver to this cluster (reference: ray.init(address=cluster.address))."""
        if self.head_node is None:
            raise RuntimeError("Cluster has no head node")
        return _api.init(_head=self.head, _node_id=self.head_node)

    def shutdown(self):
        _api.shutdown()
        if not self._owns_head:
            return  # a borrowed head (ray_tpu_torch up) outlives this wrapper
        try:
            self.head.shutdown()
        except Exception:
            pass

    def wait_for_nodes(self, timeout: float = 30.0):
        return True
