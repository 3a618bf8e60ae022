"""GKE TPU node-pool provider: the real cloud path for autoscaler v2.

Reference: ``python/ray/autoscaler/_private/gcp/node_provider.py`` (+
``config.py`` bootstrap) — the reference drives raw GCP REST through
googleapiclient with retries and operation polling. Same shape here, with
zero dependencies: :class:`GKEClient` is a thin JSON-over-urllib client
for the two API families a TPU cluster needs —

* ``container.googleapis.com``: node-pool inspection + ``setSize`` (the
  only sanctioned way to grow a GKE node pool);
* ``compute.googleapis.com``: listing a pool's VMs via its managed
  instance group and precision scale-down with
  ``instanceGroupManagers.deleteInstances`` (resize-down alone picks an
  arbitrary victim; the autoscaler must kill the IDLE one).

Auth is the GCP VM metadata server (the standard on GKE/GCE; no SDK). For
tests and air-gapped CI the transport is injectable: ``http=`` is any
``callable(method, url, body_dict|None) -> dict``.

Node identity contract: a provider node is a VM NAME. The VM's startup
script must join the cluster with ``--labels '{"provider_node_id":
"<hostname>"}'`` (``python -m ray_tpu_torch start --address=head:port --labels
...``) — autoscaler v2 pairs cloud instances with ray nodes through that
label (``v2._reconcile_ray_nodes``), since a pool resize cannot stamp a
per-instance label ahead of time the way a direct instance insert could.

GPU nodes: the calls here never touch local hardware, and ``setSize`` and
``deleteInstances`` scale a node pool of GPU VMs (an H100 pool, say) exactly
as they scale one of TPU hosts; the names, URLs, bodies and the
``gke_tpu`` provider type stay the reference's.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Optional

from ray_tpu_torch.autoscaler.v2 import (
    ALLOCATED,
    ALLOCATION_FAILED,
    REQUESTED,
    AsyncNodeProvider,
    Instance,
)

_METADATA_TOKEN_URL = (
    "http://metadata.google.internal/computeMetadata/v1/"
    "instance/service-accounts/default/token"
)


class _MetadataToken:
    """Bearer token from the GCE metadata server, cached until ~expiry."""

    def __init__(self):
        self._token: Optional[str] = None
        self._expires_at = 0.0

    def __call__(self) -> str:
        if self._token is None or time.time() >= self._expires_at - 60:
            req = urllib.request.Request(
                _METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"}
            )
            with urllib.request.urlopen(req, timeout=5) as resp:
                payload = json.loads(resp.read().decode())
            self._token = payload["access_token"]
            self._expires_at = time.time() + float(payload.get("expires_in", 300))
        return self._token


class GKEClient:
    """Minimal GKE + Compute REST client (urllib; transport injectable)."""

    CONTAINER = "https://container.googleapis.com/v1"
    COMPUTE = "https://compute.googleapis.com/compute/v1"

    def __init__(
        self,
        project: str,
        zone: str,
        cluster: str,
        http: Optional[Callable[[str, str, Optional[dict]], dict]] = None,
        token_provider: Optional[Callable[[], str]] = None,
    ):
        self.project = project
        self.zone = zone
        self.cluster = cluster
        self._token = token_provider or _MetadataToken()
        self._http = http or self._urllib_http

    def _urllib_http(self, method: str, url: str, body: Optional[dict]) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url,
            data=data,
            method=method,
            headers={
                "Authorization": f"Bearer {self._token()}",
                "Content-Type": "application/json",
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                raw = resp.read().decode()
        except urllib.error.HTTPError as e:
            raise RuntimeError(
                f"GCP API {method} {url} failed: {e.code} {e.read().decode()[:500]}"
            ) from None
        except urllib.error.URLError as e:
            # connection refused / DNS / timeout — normalize so callers'
            # transient-error handling (poll keeps polling) sees one type
            raise RuntimeError(f"GCP API {method} {url} unreachable: {e}") from None
        return json.loads(raw) if raw else {}

    # -- container API ------------------------------------------------------

    def _pool_path(self, pool: str) -> str:
        return (
            f"{self.CONTAINER}/projects/{self.project}/zones/{self.zone}"
            f"/clusters/{self.cluster}/nodePools/{pool}"
        )

    def get_node_pool(self, pool: str) -> dict:
        return self._http("GET", self._pool_path(pool), None)

    def set_node_pool_size(self, pool: str, count: int) -> dict:
        return self._http(
            "POST", self._pool_path(pool) + ":setSize", {"nodeCount": int(count)}
        )

    # -- compute API (the pool's VMs live in managed instance groups) -------

    def _group_urls(self, pool: str) -> list[str]:
        return self.get_node_pool(pool).get("instanceGroupUrls", [])

    def list_pool_instances(self, pool: str) -> list[str]:
        """VM names currently in the pool's managed instance group(s)."""
        names: list[str] = []
        for group_url in self._group_urls(pool):
            # .../instanceGroupManagers/<name> — listManagedInstances works
            # on the manager resource
            out = self._http(
                "POST",
                group_url.replace("instanceGroups", "instanceGroupManagers")
                + "/listManagedInstances",
                None,
            )
            for mi in out.get("managedInstances", []):
                names.append(mi["instance"].rsplit("/", 1)[-1])
        return names

    def delete_instance(self, pool: str, name: str) -> None:
        """Precision scale-down: remove ONE named VM and shrink its group.
        Multi-location pools have one managed group per zone — the delete
        must target the group that actually CONTAINS the VM."""
        groups = self._group_urls(pool)
        if not groups:
            raise RuntimeError(f"node pool for instance {name!r} has no instance group")
        for group_url in groups:
            mgr = group_url.replace("instanceGroups", "instanceGroupManagers")
            listed = self._http("POST", mgr + "/listManagedInstances", None)
            members = {
                mi["instance"].rsplit("/", 1)[-1]: mi["instance"]
                for mi in listed.get("managedInstances", [])
            }
            if name in members:
                self._http(
                    "POST", mgr + "/deleteInstances", {"instances": [members[name]]}
                )
                return
        raise RuntimeError(f"instance {name!r} not found in node pool {pool!r}")


class GKETPUAsyncProvider(AsyncNodeProvider):
    """AsyncNodeProvider over GKE node pools of TPU hosts.

    ``pools`` maps autoscaler node-type name -> GKE node pool name; each
    create is a +1 resize of that pool, observed by polling the managed
    instance group for a VM name not seen before the request.
    """

    def __init__(
        self,
        project: str = "",
        zone: str = "",
        cluster_name: str = "",
        pools: Optional[dict[str, str]] = None,
        client: Optional[GKEClient] = None,
    ):
        self.client = client or GKEClient(project, zone, cluster_name)
        self.pools = dict(pools or {})
        # instance_id -> (pool, set of VM names preexisting at request time)
        self._pending: dict[str, tuple[str, set]] = {}
        # VM names this provider has already claimed for an instance, so two
        # concurrent creates in one pool can't both claim the same new VM
        self._claimed: set = set()
        # pool -> creates requested but not yet claimed: a resize target of
        # len(current)+1 alone is a no-op for the SECOND concurrent create
        # (real resizes are async, so the first +1 hasn't materialized yet)
        self._outstanding: dict[str, int] = {}

    def _pool_of(self, node_type: str) -> str:
        pool = self.pools.get(node_type, node_type)
        return pool

    def request_create(self, instance: Instance, resources: dict, labels: dict) -> None:
        pool = self._pool_of(instance.node_type)
        before = set(self.client.list_pool_instances(pool))
        outstanding = self._outstanding.get(pool, 0)
        self.client.set_node_pool_size(pool, len(before) + outstanding + 1)
        self._outstanding[pool] = outstanding + 1
        self._pending[instance.instance_id] = (pool, before | set(self._claimed))

    def poll(self, instance: Instance) -> str:
        rec = self._pending.get(instance.instance_id)
        if rec is None:
            return ALLOCATION_FAILED
        pool, before = rec
        try:
            now = set(self.client.list_pool_instances(pool))
        except RuntimeError:
            return REQUESTED  # transient API error: keep polling
        fresh = sorted(now - before - self._claimed)
        if not fresh:
            return REQUESTED
        name = fresh[0]
        self._claimed.add(name)
        instance.provider_id = name
        self._pending.pop(instance.instance_id, None)
        self._outstanding[pool] = max(0, self._outstanding.get(pool, 1) - 1)
        return ALLOCATED

    def terminate(self, instance: Instance) -> None:
        if not instance.provider_id:
            return
        pool = self._pool_of(instance.node_type)
        self.client.delete_instance(pool, instance.provider_id)
        self._claimed.discard(instance.provider_id)
