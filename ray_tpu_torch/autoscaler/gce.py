"""Raw GCE / Cloud-TPU-VM provider: bare-metal TPU pods without GKE.

Reference: ``python/ray/autoscaler/_private/gcp/node_provider.py`` — the
reference's GCP provider creates instances directly (no Kubernetes); its
TPU support drives ``tpu.googleapis.com`` nodes next to plain compute VMs.
Same split here, dependency-free (urllib + the VM metadata server, both
shared with :mod:`ray_tpu_torch.autoscaler.gke`):

* :class:`GCEClient` — ``compute.googleapis.com`` ``instances``
  insert/get/delete/list for CPU hosts;
* :class:`TPUNodeClient` — ``tpu.googleapis.com/v2`` TPU-VM nodes
  (``queuedResources``-free direct create; an ``accelerator_type`` in the
  node-type spec routes a create here);
* :class:`GCEAsyncProvider` — :class:`~ray_tpu_torch.autoscaler.v2.AsyncNodeProvider`
  over both. Direct inserts let the provider choose the instance NAME and
  stamp labels up front, so pairing with ray nodes is exact (the GKE
  provider must instead diff managed-instance-group membership).

Transport is injectable (``http=`` callable) exactly like the GKE client,
so tests run against fakes and air-gapped CI never dials out.

The instance body is the reference's: it carries no ``guestAccelerators``,
so neither package launches a GCE GPU VM (ROADMAP, "Limits that stay").
"""

from __future__ import annotations

import re
from typing import Callable, Optional

from ray_tpu_torch.autoscaler.gke import GKEClient
from ray_tpu_torch.autoscaler.v2 import (
    ALLOCATED,
    ALLOCATION_FAILED,
    REQUESTED,
    AsyncNodeProvider,
    Instance,
)


def _is_404(e: Exception) -> bool:
    """Status-code-anchored not-found check: instance NAMES can contain
    '404' (ray-cpu-i-000404), so a bare substring match would classify a
    403/500 on such a name as not-found and swallow real failures."""
    return "failed: 404" in str(e)


def _sanitize(name: str) -> str:
    """GCE instance names: lowercase RFC-1035, <=63 chars."""
    out = re.sub(r"[^a-z0-9-]", "-", name.lower()).strip("-")
    return out[:63] or "node"


class GCEClient:
    """``compute.googleapis.com`` instances API (urllib; injectable)."""

    COMPUTE = "https://compute.googleapis.com/compute/v1"

    def __init__(
        self,
        project: str,
        zone: str,
        http: Optional[Callable[[str, str, Optional[dict]], dict]] = None,
        token_provider: Optional[Callable[[], str]] = None,
    ):
        self.project = project
        self.zone = zone
        # reuse the GKE client's urllib transport + token machinery: one
        # retry/auth/error-normalization implementation for all GCP APIs
        self._gke = GKEClient(
            project, zone, cluster="-", http=http, token_provider=token_provider
        )
        self._http = self._gke._http

    def _base(self) -> str:
        return f"{self.COMPUTE}/projects/{self.project}/zones/{self.zone}/instances"

    def insert_instance(self, name: str, config: dict, labels: dict) -> dict:
        body = {
            "name": name,
            "machineType": (
                f"zones/{self.zone}/machineTypes/"
                f"{config.get('machine_type', 'n2-standard-8')}"
            ),
            "disks": [
                {
                    "boot": True,
                    "autoDelete": True,
                    "initializeParams": {
                        "sourceImage": config.get(
                            "source_image",
                            "projects/debian-cloud/global/images/family/debian-12",
                        ),
                        "diskSizeGb": str(config.get("disk_size_gb", 100)),
                    },
                }
            ],
            "networkInterfaces": [
                {
                    "network": config.get("network", "global/networks/default"),
                    "accessConfigs": []
                    if config.get("internal_ip_only")
                    else [{"type": "ONE_TO_ONE_NAT"}],
                }
            ],
            "labels": {k: _sanitize(str(v)) for k, v in labels.items()},
            "metadata": {
                "items": [
                    {"key": "startup-script", "value": config["startup_script"]}
                ]
                if config.get("startup_script")
                else []
            },
        }
        return self._http("POST", self._base(), body)

    def get_instance(self, name: str) -> Optional[dict]:
        try:
            return self._http("GET", f"{self._base()}/{name}", None)
        except RuntimeError as e:
            if _is_404(e):
                return None
            raise

    def delete_instance(self, name: str) -> None:
        try:
            self._http("DELETE", f"{self._base()}/{name}", None)
        except RuntimeError as e:
            if not _is_404(e):
                raise

    def list_instances(self, label_filter: Optional[str] = None) -> list[dict]:
        from urllib.parse import quote

        out: list[dict] = []
        token = None
        while True:  # follow nextPageToken: a >1-page cluster must not
            params = []  # silently truncate (teardown would leak VMs)
            if label_filter:
                params.append(f"filter={quote(label_filter)}")
            if token:
                params.append(f"pageToken={quote(token)}")
            url = self._base() + ("?" + "&".join(params) if params else "")
            resp = self._http("GET", url, None)
            out.extend(resp.get("items", []))
            token = resp.get("nextPageToken")
            if not token:
                return out


class TPUNodeClient:
    """``tpu.googleapis.com/v2`` TPU-VM nodes (the bare-metal pod path)."""

    TPU = "https://tpu.googleapis.com/v2"

    def __init__(
        self,
        project: str,
        zone: str,
        http: Optional[Callable[[str, str, Optional[dict]], dict]] = None,
        token_provider: Optional[Callable[[], str]] = None,
    ):
        self.project = project
        self.zone = zone
        self._gke = GKEClient(
            project, zone, cluster="-", http=http, token_provider=token_provider
        )
        self._http = self._gke._http

    def _base(self) -> str:
        return f"{self.TPU}/projects/{self.project}/locations/{self.zone}/nodes"

    def create_node(self, name: str, config: dict, labels: dict) -> dict:
        body = {
            "acceleratorType": config["accelerator_type"],  # e.g. v5litepod-8
            "runtimeVersion": config.get("runtime_version", "tpu-ubuntu2204-base"),
            "labels": {k: _sanitize(str(v)) for k, v in labels.items()},
        }
        if config.get("startup_script"):
            body["metadata"] = {"startup-script": config["startup_script"]}
        return self._http("POST", f"{self._base()}?nodeId={name}", body)

    def get_node(self, name: str) -> Optional[dict]:
        try:
            return self._http("GET", f"{self._base()}/{name}", None)
        except RuntimeError as e:
            if _is_404(e):
                return None
            raise

    def delete_node(self, name: str) -> None:
        try:
            self._http("DELETE", f"{self._base()}/{name}", None)
        except RuntimeError as e:
            if not _is_404(e):
                raise

    def list_nodes(self) -> list[dict]:
        from urllib.parse import quote

        out: list[dict] = []
        token = None
        while True:
            url = self._base() + (f"?pageToken={quote(token)}" if token else "")
            resp = self._http("GET", url, None)
            out.extend(resp.get("nodes", []))
            token = resp.get("nextPageToken")
            if not token:
                return out


class GCEAsyncProvider(AsyncNodeProvider):
    """AsyncNodeProvider over direct GCE instances and/or TPU-VM nodes.

    ``node_types`` maps the autoscaler node-type name to its launch config;
    an ``accelerator_type`` key routes that type through the TPU API
    (bare-metal pods), anything else is a plain compute instance. The
    provider names instances after the autoscaler instance id and stamps
    ``provider_node_id`` both as a label and into the startup script's
    ``$RAY_TPU_NODE_ID`` substitution — the joining agent reports it via
    ``--labels`` and the reconciler pairs cloud and ray views exactly.
    """

    def __init__(
        self,
        project: str = "",
        zone: str = "",
        node_types: Optional[dict] = None,
        gce_client: Optional[GCEClient] = None,
        tpu_client: Optional[TPUNodeClient] = None,
        cluster_name: str = "",
    ):
        self.gce = gce_client or GCEClient(project, zone)
        self.tpu = tpu_client or TPUNodeClient(project, zone)
        self.node_types = dict(node_types or {})
        self.cluster_name = cluster_name
        self._kind: dict[str, str] = {}  # instance_id -> "tpu" | "gce"

    def _config_of(self, node_type: str) -> dict:
        return self.node_types.get(node_type, {})

    def request_create(self, instance: Instance, resources: dict, labels: dict) -> None:
        cfg = self._config_of(instance.node_type)
        name = _sanitize(f"ray-{instance.node_type}-{instance.instance_id}")
        stamped = dict(labels)
        stamped["provider_node_id"] = name
        if self.cluster_name:
            # teardown_cluster sweeps by this label — without it a
            # 'ray_tpu_torch down' would find (and bill-stop) nothing
            stamped["ray-cluster"] = self.cluster_name
        cfg = dict(cfg)
        if cfg.get("startup_script"):
            cfg["startup_script"] = cfg["startup_script"].replace(
                "$RAY_TPU_NODE_ID", name
            )
        if cfg.get("accelerator_type"):
            self._kind[instance.instance_id] = "tpu"
            self.tpu.create_node(name, cfg, stamped)
        else:
            self._kind[instance.instance_id] = "gce"
            self.gce.insert_instance(name, cfg, stamped)
        instance.provider_id = name

    def poll(self, instance: Instance) -> str:
        kind = self._kind.get(instance.instance_id)
        if kind is None or not instance.provider_id:
            return ALLOCATION_FAILED
        try:
            if kind == "tpu":
                node = self.tpu.get_node(instance.provider_id)
                status = (node or {}).get("state", "")
                ready, failed = ("READY",), ("PREEMPTED", "TERMINATED")
            else:
                node = self.gce.get_instance(instance.provider_id)
                status = (node or {}).get("status", "")
                ready, failed = ("RUNNING",), ("TERMINATED", "STOPPED")
        except RuntimeError:
            return REQUESTED  # transient API error: keep polling
        if node is None:
            # not yet visible right after the insert — or actually gone;
            # the autoscaler's allocation timeout bounds the wait either way
            return REQUESTED
        if status in ready:
            return ALLOCATED
        if status in failed:
            return ALLOCATION_FAILED
        return REQUESTED

    def terminate(self, instance: Instance) -> None:
        if not instance.provider_id:
            return
        if self._kind.get(instance.instance_id) == "tpu" or (
            self._config_of(instance.node_type).get("accelerator_type")
        ):
            self.tpu.delete_node(instance.provider_id)
        else:
            self.gce.delete_instance(instance.provider_id)
