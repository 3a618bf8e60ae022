"""Cluster YAML: declarative launch config for ``ray_tpu_torch up / down``.

Reference: ``python/ray/autoscaler/ray-schema.json`` + the ``ray up``
flow in ``autoscaler/_private/commands.py`` — a YAML names the provider,
the node types (shapes, labels, min/max), and head settings; ``up``
bootstraps the head and runs the autoscaler against it; ``down`` tears
every provider instance down.

Schema (validated by :func:`load_cluster_config`)::

    cluster_name: demo                  # required
    provider:                           # required
      type: gke_tpu | gce_tpu | fake    # fake = in-process virtual nodes
      project: my-project               # gke_tpu / gce_tpu
      zone: us-central2-b               # gke_tpu / gce_tpu
      cluster: my-gke-cluster           # gke_tpu only (gce_tpu creates
                                        # instances / TPU-VM nodes directly)
    head:                               # optional
      host: 127.0.0.1                   # TCP bind for agents/drivers
      port: 0                           # 0 = ephemeral
      num_cpus: 8                       # head-node CPU resource
    node_types:                         # required, at least one
      v5e-8:
        pool: v5e-pool                  # gke_tpu: node-pool name (default:
                                        # the node-type name)
        resources: {TPU: 8, CPU: 44}    # required
        labels: {accelerator: v5e}
        min_workers: 0
        max_workers: 4
    idle_timeout_s: 60                  # scale-down idle threshold
    update_interval_s: 5                # reconcile cadence

A worker VM joins with::

    python -m ray_tpu_torch start --address=<head_host:port> \
        --labels '{"provider_node_id": "'$(hostname)'"}'

— the ``provider_node_id`` label is how the reconciler pairs the cloud
instance with the ray node it became (``v2._reconcile_ray_nodes``).
"""

from __future__ import annotations

import time

from typing import Any, Optional


def _sanitize_label(v: str) -> str:
    from ray_tpu_torch.autoscaler.gce import _sanitize

    return _sanitize(v)


def load_cluster_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    validate_cluster_config(cfg)
    return cfg


def validate_cluster_config(cfg: Any) -> None:
    if not isinstance(cfg, dict):
        raise ValueError("cluster config must be a mapping")
    for key in ("cluster_name", "provider", "node_types"):
        if key not in cfg:
            raise ValueError(f"cluster config missing required key {key!r}")
    unknown = set(cfg) - {
        "cluster_name", "provider", "head", "node_types",
        "idle_timeout_s", "update_interval_s",
    }
    if unknown:
        raise ValueError(f"unknown cluster config key(s) {sorted(unknown)}")
    prov = cfg["provider"]
    if not isinstance(prov, dict) or prov.get("type") not in (
        "gke_tpu", "gce_tpu", "fake"
    ):
        raise ValueError("provider.type must be 'gke_tpu', 'gce_tpu' or 'fake'")
    if prov["type"] == "gke_tpu":
        for key in ("project", "zone", "cluster"):
            if not prov.get(key):
                raise ValueError(f"provider.{key} is required for gke_tpu")
    if prov["type"] == "gce_tpu":
        for key in ("project", "zone"):
            if not prov.get(key):
                raise ValueError(f"provider.{key} is required for gce_tpu")
    if not isinstance(cfg["node_types"], dict) or not cfg["node_types"]:
        raise ValueError("node_types must be a non-empty mapping")
    for name, spec in cfg["node_types"].items():
        if not isinstance(spec, dict) or not isinstance(spec.get("resources"), dict):
            raise ValueError(f"node_types.{name}.resources is required")
        unknown_t = set(spec) - {
            "pool", "resources", "labels", "min_workers", "max_workers",
            # gce_tpu launch config (autoscaler/gce.py)
            "machine_type", "accelerator_type", "runtime_version",
            "source_image", "disk_size_gb", "network", "internal_ip_only",
            "startup_script",
        }
        if unknown_t:
            raise ValueError(f"unknown node_types.{name} key(s) {sorted(unknown_t)}")
        if spec.get("min_workers", 0) > spec.get("max_workers", 2**31):
            raise ValueError(f"node_types.{name}: min_workers > max_workers")


def build_provider(cfg: dict, cluster=None, client=None):
    """Provider from config. ``cluster`` backs the fake type; ``client``
    injects a transport into the GKE type (tests)."""
    prov = cfg["provider"]
    if prov["type"] == "fake":
        from ray_tpu_torch.autoscaler.v2 import FakeAsyncProvider

        return FakeAsyncProvider(cluster=cluster, delay_polls=1)
    if prov["type"] == "gce_tpu":
        from ray_tpu_torch.autoscaler.gce import GCEAsyncProvider

        kwargs = {}
        if client is not None:  # injected transport (tests)
            if isinstance(client, tuple):
                kwargs = {"gce_client": client[0], "tpu_client": client[1]}
            else:
                # single-client injection covers ONLY the compute path; a
                # TPU node type must fail loudly instead of falling back to
                # a REAL tpu.googleapis.com client under a fake
                class _RefuseTPU:
                    def __getattr__(self, name):
                        raise RuntimeError(
                            "TPU node types need a tpu client: inject "
                            "client=(gce_client, tpu_client)"
                        )

                kwargs = {"gce_client": client, "tpu_client": _RefuseTPU()}
        return GCEAsyncProvider(
            project=prov["project"],
            zone=prov["zone"],
            node_types=cfg["node_types"],
            cluster_name=cfg.get("cluster_name", ""),
            **kwargs,
        )
    from ray_tpu_torch.autoscaler.gke import GKEClient, GKETPUAsyncProvider

    pools = {
        name: spec.get("pool", name) for name, spec in cfg["node_types"].items()
    }
    return GKETPUAsyncProvider(
        project=prov["project"],
        zone=prov["zone"],
        cluster_name=prov["cluster"],
        pools=pools,
        client=client
        or GKEClient(prov["project"], prov["zone"], prov["cluster"]),
    )


def run_cluster(
    cfg: dict,
    head,
    provider,
    ctx=None,
    max_ticks: Optional[int] = None,
    stop_check=None,
) -> dict:
    """The ``up`` reconcile loop: AutoscalerV2 against a live head.
    ``max_ticks`` bounds the loop (tests / one-shot reconcile); otherwise
    runs until ``stop_check()`` is truthy. Returns the last status counts."""
    from ray_tpu_torch.autoscaler.v2 import AutoscalerV2

    scaler = AutoscalerV2(
        provider,
        cfg["node_types"],
        head=head,
        ctx=ctx,
        idle_timeout_s=float(cfg.get("idle_timeout_s", 60.0)),
    )
    interval = float(cfg.get("update_interval_s", 5.0))
    counts: dict = {}
    tick = 0
    errors = 0
    while True:
        try:
            counts = scaler.update()
            errors = 0
        except Exception as e:  # noqa: BLE001
            # a transient cloud 503 must not kill the control plane that
            # every worker and driver is connected to — log, back off, retry
            errors += 1
            print(f"[ray_tpu_torch up] reconcile error ({errors}): {e}")
            time.sleep(min(interval * errors, 60.0))
        tick += 1
        if max_ticks is not None and tick >= max_ticks:
            return counts
        if stop_check is not None and stop_check():
            return counts
        time.sleep(interval)


def teardown_cluster(cfg: dict, client=None) -> list[str]:
    """The ``down`` path: delete every VM in every configured pool.
    Returns the terminated instance names (empty for the fake provider,
    whose virtual nodes die with the head process)."""
    prov = cfg["provider"]
    if prov["type"] == "fake":
        return []
    if prov["type"] == "gce_tpu":
        from ray_tpu_torch.autoscaler.gce import GCEClient, TPUNodeClient

        if isinstance(client, tuple):
            gc, tc = client
        elif client is not None:
            # single injected client covers ONLY the compute sweep (the
            # tuple form injects both) — never dial a real TPU API from
            # under an injected fake
            gc, tc = client, None
        else:
            gc = GCEClient(prov["project"], prov["zone"])
            tc = TPUNodeClient(prov["project"], prov["zone"])
        # the label VALUE was sanitized at create time (GCE label charset);
        # the filter must compare the sanitized form or it matches nothing
        cluster = _sanitize_label(cfg.get("cluster_name", ""))
        gone = []
        # both API families: plain compute VMs AND tpu.googleapis.com
        # TPU-VM nodes (the expensive ones) carry the ray-cluster label
        for inst in gc.list_instances(f"labels.ray-cluster={cluster}"):
            gc.delete_instance(inst["name"])
            gone.append(inst["name"])
        for node in tc.list_nodes() if tc is not None else []:
            if node.get("labels", {}).get("ray-cluster") == cluster:
                name = node["name"].rsplit("/", 1)[-1]
                tc.delete_node(name)
                gone.append(name)
        return gone
    from ray_tpu_torch.autoscaler.gke import GKEClient

    client = client or GKEClient(prov["project"], prov["zone"], prov["cluster"])
    gone: list[str] = []
    pools = {spec.get("pool", name) for name, spec in cfg["node_types"].items()}
    for pool in sorted(pools):  # dedup: node types may share a pool
        for vm in client.list_pool_instances(pool):
            client.delete_instance(pool, vm)
            gone.append(vm)
    return gone
