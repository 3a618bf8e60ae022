"""The port's cloud providers and cluster config against the reference's
tests, one case each, with ``ray_tpu`` renamed: ``tests/test_cluster_yaml_gke.py``
(the GKE client and provider through autoscaler v2, the cluster YAML, ``up``
and ``down``) and ``tests/test_gce_provider.py`` (the raw GCE / TPU-VM
provider). Every client runs against a fake transport injected through
``http=``: no test dials out."""

import json
import textwrap

import pytest

from ray_tpu_torch.autoscaler.cluster_config import (
    build_provider,
    load_cluster_config,
    teardown_cluster,
    validate_cluster_config,
)
from ray_tpu_torch.autoscaler.gce import (
    GCEAsyncProvider,
    GCEClient,
    TPUNodeClient,
    _sanitize,
)
from ray_tpu_torch.autoscaler.gke import GKEClient, GKETPUAsyncProvider
from ray_tpu_torch.autoscaler.v2 import (
    ALLOCATED,
    ALLOCATION_FAILED,
    RAY_RUNNING,
    REQUESTED,
    TERMINATED,
    AutoscalerV2,
    Instance,
)


class FakeGCP:
    """An http-transport stand-in implementing just enough of the GKE +
    Compute REST surface: node pools with instance groups whose size
    follows setSize; deleteInstances removes named VMs. Every request is
    recorded for assertions."""

    def __init__(self, pools):
        self.pools = {p: [] for p in pools}  # pool -> [vm names]
        self._counter = 0
        self.requests = []
        self.alloc_delay = 0  # extra polls before a resize materializes
        self._pending = []  # (pool, remaining_polls)

    def __call__(self, method, url, body):
        self.requests.append((method, url, body))
        for pool in self.pools:
            if f"/nodePools/{pool}" in url:
                if url.endswith(":setSize"):
                    want = body["nodeCount"]
                    if want > len(self.pools[pool]):
                        for _ in range(want - len(self.pools[pool])):
                            self._pending.append([pool, self.alloc_delay])
                    return {"name": "op-1"}
                return {
                    "name": pool,
                    "initialNodeCount": len(self.pools[pool]),
                    "instanceGroupUrls": [
                        f"https://compute/zones/z/instanceGroups/{pool}-grp"
                    ],
                }
            if f"instanceGroupManagers/{pool}-grp" in url:
                if url.endswith("listManagedInstances"):
                    self._tick(pool)
                    return {
                        "managedInstances": [
                            {"instance": f"https://compute/zones/z/instances/{n}"}
                            for n in self.pools[pool]
                        ]
                    }
                if url.endswith("deleteInstances"):
                    for inst_url in body["instances"]:
                        name = inst_url.rsplit("/", 1)[-1]
                        if name in self.pools[pool]:
                            self.pools[pool].remove(name)
                    return {"name": "op-2"}
        raise AssertionError(f"unexpected request {method} {url}")

    def _tick(self, pool):
        for rec in self._pending:
            if rec[0] == pool:
                if rec[1] <= 0:
                    self._counter += 1
                    self.pools[pool].append(f"{pool}-vm-{self._counter:03d}")
                rec[1] -= 1
        self._pending = [r for r in self._pending if r[1] >= 0]


def _client(fake):
    return GKEClient("proj", "us-central2-b", "clus", http=fake, token_provider=lambda: "t")


def test_gke_client_rest_shapes():
    fake = FakeGCP(["v5e-pool"])
    c = _client(fake)
    c.set_node_pool_size("v5e-pool", 2)
    assert fake.requests[-1][0] == "POST"
    assert fake.requests[-1][1].endswith(
        "projects/proj/zones/us-central2-b/clusters/clus/nodePools/v5e-pool:setSize"
    )
    assert fake.requests[-1][2] == {"nodeCount": 2}
    names = c.list_pool_instances("v5e-pool")
    assert len(names) == 2 and all(n.startswith("v5e-pool-vm-") for n in names)
    c.delete_instance("v5e-pool", names[0])
    assert len(c.list_pool_instances("v5e-pool")) == 1


NODE_TYPES = {
    "v5e-8": {
        "pool": "v5e-pool",
        "resources": {"TPU": 8.0, "CPU": 44.0},
        "labels": {"accelerator": "v5e"},
        "min_workers": 0,
        "max_workers": 4,
    }
}


def _feed_with_nodes(fake, pool, busy=False):
    """Simulate the GKE contract: every VM in the pool has 'joined' ray
    labeled with its VM name as provider_node_id."""
    return {
        "pending_demand": [],
        "nodes": [
            {
                "node_id": f"ray-{n}",
                "labels": {"provider_node_id": n},
                "busy": busy,
            }
            for n in fake.pools[pool]
        ],
    }


def test_gke_provider_scale_up_down_through_v2():
    fake = FakeGCP(["v5e-pool"])
    provider = GKETPUAsyncProvider(pools={"v5e-8": "v5e-pool"}, client=_client(fake))
    feed = {"pending_demand": [{"TPU": 8.0}], "nodes": []}
    scaler = AutoscalerV2(provider, NODE_TYPES, idle_timeout_s=0.0)
    scaler._demand = lambda: feed

    counts = scaler.update()  # demand -> QUEUED -> REQUESTED (resize +1)
    assert counts.get(REQUESTED) == 1
    assert any(u.endswith(":setSize") for _, u, _ in fake.requests)

    counts = scaler.update()  # poll discovers the new VM
    assert counts.get(ALLOCATED) == 1
    inst = next(iter(scaler.im.instances.values()))
    assert inst.provider_id and inst.provider_id.startswith("v5e-pool-vm-")

    feed = _feed_with_nodes(fake, "v5e-pool", busy=True)
    counts = scaler.update()  # the VM's ray node pairs via provider_node_id
    assert counts.get(RAY_RUNNING) == 1
    assert inst.status == RAY_RUNNING and inst.ray_node_id == f"ray-{inst.provider_id}"

    # work done (idle) beyond the (zero) timeout -> precision deleteInstances
    feed = _feed_with_nodes(fake, "v5e-pool", busy=False)
    scaler.update()
    counts = scaler.update()
    assert counts.get(TERMINATED) == 1
    assert fake.pools["v5e-pool"] == []
    assert any(u.endswith("deleteInstances") for _, u, _ in fake.requests)


def test_gke_concurrent_creates_claim_distinct_vms():
    """Two creates in one tick, with ASYNC resizes (alloc_delay>0): the
    second resize must target len+outstanding+1, or it is a no-op and one
    instance polls REQUESTED forever."""
    fake = FakeGCP(["v5e-pool"])
    fake.alloc_delay = 2
    provider = GKETPUAsyncProvider(pools={"v5e-8": "v5e-pool"}, client=_client(fake))
    types = {"v5e-8": dict(NODE_TYPES["v5e-8"], min_workers=2)}
    scaler = AutoscalerV2(provider, types)
    scaler._demand = lambda: {"pending_demand": [], "nodes": []}
    for _ in range(6):
        scaler.update()
    ids = {
        i.provider_id
        for i in scaler.im.instances.values()
        if i.provider_id is not None
    }
    assert len(ids) == 2, f"instances did not claim two distinct VMs: {ids}"
    sizes = [b["nodeCount"] for _, u, b in fake.requests if u.endswith(":setSize")]
    assert sizes == [1, 2], sizes  # second resize accounts for the first


def _yaml(tmp_path, provider="fake", extra=""):
    cfg = textwrap.dedent(
        f"""
        cluster_name: t
        provider:
          type: {provider}
          {"project: p" if provider == "gke_tpu" else ""}
          {"zone: z" if provider == "gke_tpu" else ""}
          {"cluster: c" if provider == "gke_tpu" else ""}
        node_types:
          v5e-8:
            pool: v5e-pool
            resources: {{TPU: 8, CPU: 44}}
            min_workers: 1
            max_workers: 2
        idle_timeout_s: 60
        update_interval_s: 0
        {extra}
        """
    )
    path = tmp_path / "cluster.yaml"
    path.write_text(cfg)
    return str(path)


def test_yaml_schema_validation(tmp_path):
    cfg = load_cluster_config(_yaml(tmp_path))
    assert cfg["cluster_name"] == "t"
    with pytest.raises(ValueError, match="provider.type"):
        validate_cluster_config({"cluster_name": "x", "provider": {"type": "aws"},
                                 "node_types": {"a": {"resources": {}}}})
    with pytest.raises(ValueError, match="missing required"):
        validate_cluster_config({"cluster_name": "x"})
    with pytest.raises(ValueError, match="project"):
        validate_cluster_config(
            {"cluster_name": "x", "provider": {"type": "gke_tpu"},
             "node_types": {"a": {"resources": {"CPU": 1}}}}
        )
    with pytest.raises(ValueError, match="min_workers > max_workers"):
        validate_cluster_config(
            {"cluster_name": "x", "provider": {"type": "fake"},
             "node_types": {"a": {"resources": {"CPU": 1},
                                  "min_workers": 3, "max_workers": 1}}}
        )
    with pytest.raises(ValueError, match="unknown"):
        validate_cluster_config(
            {"cluster_name": "x", "provider": {"type": "fake"}, "typo_key": 1,
             "node_types": {"a": {"resources": {"CPU": 1}}}}
        )


def test_build_provider_gke_pools_map(tmp_path):
    cfg = load_cluster_config(_yaml(tmp_path, provider="gke_tpu"))
    fake = FakeGCP(["v5e-pool"])
    provider = build_provider(cfg, client=_client(fake))
    assert isinstance(provider, GKETPUAsyncProvider)
    assert provider.pools == {"v5e-8": "v5e-pool"}


def test_teardown_deletes_every_pool_vm(tmp_path):
    cfg = load_cluster_config(_yaml(tmp_path, provider="gke_tpu"))
    fake = FakeGCP(["v5e-pool"])
    client = _client(fake)
    client.set_node_pool_size("v5e-pool", 3)
    client.list_pool_instances("v5e-pool")  # materialize
    gone = teardown_cluster(cfg, client=client)
    assert len(gone) == 3
    assert fake.pools["v5e-pool"] == []


def test_up_cli_fake_provider_end_to_end(tmp_path, capsys):
    """`ray_tpu_torch up --ticks N` with the fake provider: head comes up, the
    autoscaler buys min_workers virtual nodes, they join and run."""
    from ray_tpu_torch.scripts import main

    rc = main(["up", _yaml(tmp_path), "--ticks", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "head listening on" in out
    assert "provider_node_id" in out  # the worker-join hint
    counts = json.loads(out.rsplit("instances: ", 1)[1].splitlines()[0])
    assert counts.get("RAY_RUNNING") == 1, counts


def test_down_cli_fake_provider(tmp_path, capsys):
    from ray_tpu_torch.scripts import main

    rc = main(["down", _yaml(tmp_path)])
    assert rc == 0
    assert "terminated 0 instance(s)" in capsys.readouterr().out


# -- tests/test_gce_provider.py ----------------------------------------------


class FakeHTTP:
    """Record requests; script responses per (method, url-substring)."""

    def __init__(self):
        self.calls = []
        self.instances = {}  # name -> status dict
        self.tpu_nodes = {}

    def __call__(self, method, url, body):
        self.calls.append((method, url, body))
        if "tpu.googleapis.com" in url:
            return self._tpu(method, url, body)
        return self._gce(method, url, body)

    def _gce(self, method, url, body):
        if method == "POST" and url.endswith("/instances"):
            self.instances[body["name"]] = {"name": body["name"], "status": "PROVISIONING", "body": body}
            return {"name": "op-1"}
        name = url.rsplit("/", 1)[-1].split("?")[0]
        if method == "GET" and "/instances/" in url:
            if name not in self.instances:
                raise RuntimeError(f"GCP API GET {url} failed: 404 not found")
            return self.instances[name]
        if method == "DELETE":
            if name not in self.instances:
                raise RuntimeError(f"GCP API DELETE {url} failed: 404 not found")
            del self.instances[name]
            return {}
        if method == "GET" and url.endswith("/instances") or "?filter=" in url:
            return {"items": list(self.instances.values())}
        raise AssertionError((method, url))

    def _tpu(self, method, url, body):
        if method == "POST" and "nodeId=" in url:
            name = url.split("nodeId=")[-1]
            self.tpu_nodes[name] = {"name": name, "state": "CREATING", "body": body}
            return {"name": "op-tpu"}
        name = url.rsplit("/", 1)[-1]
        if method == "GET" and url.endswith("/nodes"):
            return {"nodes": list(self.tpu_nodes.values())}
        if method == "GET":
            if name not in self.tpu_nodes:
                raise RuntimeError(f"GCP API GET {url} failed: 404 not found")
            return self.tpu_nodes[name]
        if method == "DELETE":
            self.tpu_nodes.pop(name, None)
            return {}
        raise AssertionError((method, url))


@pytest.fixture
def fake():
    return FakeHTTP()


def _provider(fake, node_types):
    return GCEAsyncProvider(
        node_types=node_types,
        gce_client=GCEClient("proj", "us-central2-b", http=fake),
        tpu_client=TPUNodeClient("proj", "us-central2-b", http=fake),
    )


def test_sanitize():
    assert _sanitize("Ray_Worker.1") == "ray-worker-1"
    assert len(_sanitize("x" * 100)) == 63


def test_gce_instance_lifecycle(fake):
    p = _provider(fake, {"cpu": {"machine_type": "n2-standard-4",
                                 "startup_script": "join $RAY_TPU_NODE_ID"}})
    inst = Instance(node_type="cpu")
    p.request_create(inst, {"CPU": 4}, {"ray-cluster": "c1"})
    assert inst.provider_id.startswith("ray-cpu-")
    body = fake.instances[inst.provider_id]["body"]
    assert "n2-standard-4" in body["machineType"]
    assert body["labels"]["provider_node_id"] == inst.provider_id
    # the startup script got the node id substituted for exact pairing
    assert body["metadata"]["items"][0]["value"] == f"join {inst.provider_id}"

    assert p.poll(inst) == REQUESTED  # PROVISIONING
    fake.instances[inst.provider_id]["status"] = "RUNNING"
    assert p.poll(inst) == ALLOCATED
    p.terminate(inst)
    assert inst.provider_id not in fake.instances


def test_tpu_node_lifecycle(fake):
    p = _provider(fake, {"v5e": {"accelerator_type": "v5litepod-8"}})
    inst = Instance(node_type="v5e")
    p.request_create(inst, {"TPU": 8}, {})
    assert inst.provider_id in fake.tpu_nodes
    assert fake.tpu_nodes[inst.provider_id]["body"]["acceleratorType"] == "v5litepod-8"

    assert p.poll(inst) == REQUESTED  # CREATING
    fake.tpu_nodes[inst.provider_id]["state"] = "READY"
    assert p.poll(inst) == ALLOCATED
    fake.tpu_nodes[inst.provider_id]["state"] = "PREEMPTED"
    assert p.poll(inst) == ALLOCATION_FAILED
    p.terminate(inst)
    assert inst.provider_id not in fake.tpu_nodes


def test_transient_errors_keep_polling(fake):
    p = _provider(fake, {"cpu": {}})
    inst = Instance(node_type="cpu")
    p.request_create(inst, {}, {})

    def boom(method, url, body):
        raise RuntimeError("GCP API unreachable: 503")

    p.gce._http = boom
    assert p.poll(inst) == REQUESTED  # transient, not FAILED


def test_cluster_config_gce(fake):
    from ray_tpu_torch.autoscaler.cluster_config import build_provider, validate_cluster_config

    cfg = {
        "cluster_name": "bare",
        "provider": {"type": "gce_tpu", "project": "proj", "zone": "us-central2-b"},
        "node_types": {
            "v5e": {
                "resources": {"TPU": 8},
                "accelerator_type": "v5litepod-8",
                "max_workers": 4,
            }
        },
    }
    validate_cluster_config(cfg)
    gce = GCEClient("proj", "us-central2-b", http=fake)
    tpu = TPUNodeClient("proj", "us-central2-b", http=fake)
    p = build_provider(cfg, client=(gce, tpu))
    inst = Instance(node_type="v5e")
    p.request_create(inst, {"TPU": 8}, {})
    assert inst.provider_id in fake.tpu_nodes

    with pytest.raises(ValueError):
        validate_cluster_config({**cfg, "provider": {"type": "gce_tpu", "project": "p"}})


def test_json_bodies_are_serializable(fake):
    """Every request body must survive the real urllib path's json.dumps."""
    p = _provider(fake, {"cpu": {"machine_type": "n2-standard-4"}})
    inst = Instance(node_type="cpu")
    p.request_create(inst, {}, {"a": "B!"})
    for _method, _url, body in fake.calls:
        if body is not None:
            json.dumps(body)


def test_teardown_sweeps_both_apis(fake):
    """'ray_tpu_torch down' must find VMs AND tpu.googleapis.com nodes by the
    ray-cluster label the launch path stamps — TPU pods are the expensive
    leak."""
    from ray_tpu_torch.autoscaler.cluster_config import build_provider, teardown_cluster

    cfg = {
        "cluster_name": "bare",
        "provider": {"type": "gce_tpu", "project": "proj", "zone": "z"},
        "node_types": {
            "v5e": {"resources": {"TPU": 8}, "accelerator_type": "v5litepod-8"},
            "cpu": {"resources": {"CPU": 8}},
        },
    }
    gce = GCEClient("proj", "z", http=fake)
    tpu = TPUNodeClient("proj", "z", http=fake)
    p = build_provider(cfg, client=(gce, tpu))
    i1, i2 = Instance(node_type="v5e"), Instance(node_type="cpu")
    p.request_create(i1, {"TPU": 8}, {})
    p.request_create(i2, {"CPU": 8}, {})
    # launch stamped the sweep label on both
    assert fake.tpu_nodes[i1.provider_id]["body"]["labels"]["ray-cluster"] == "bare"
    assert fake.instances[i2.provider_id]["body"]["labels"]["ray-cluster"] == "bare"
    # fake list: expose labels like the real APIs do
    for n in fake.tpu_nodes.values():
        n["labels"] = n["body"]["labels"]
    gone = teardown_cluster(cfg, client=(gce, tpu))
    assert sorted(gone) == sorted([i1.provider_id, i2.provider_id])
    assert not fake.tpu_nodes and not fake.instances
