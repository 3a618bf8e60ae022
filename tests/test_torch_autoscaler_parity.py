"""The port's autoscaler, cloud clients, cluster config and CLI parser held
against the reference's on the same inputs: the requests that fake GCE/GKE
transports record for the same create, poll, delete and teardown calls;
``validate_cluster_config``'s errors over a table of bad configs; the
per-tick decisions of ``AutoscalerV2`` and ``StandardAutoscaler`` for one
scripted demand; both CLIs' subcommands and options as their argparse
parsers hold them; and ``load_cluster_config`` of one ``.json`` file."""

import argparse
import itertools
import json

import pytest

import ray_tpu.autoscaler.autoscaler as ref_v1
import ray_tpu.autoscaler.cluster_config as ref_cc
import ray_tpu.autoscaler.gce as ref_gce
import ray_tpu.autoscaler.gke as ref_gke
import ray_tpu.autoscaler.v2 as ref_v2
import ray_tpu.scripts as ref_scripts
import ray_tpu_torch.autoscaler.autoscaler as port_v1
import ray_tpu_torch.autoscaler.cluster_config as port_cc
import ray_tpu_torch.autoscaler.gce as port_gce
import ray_tpu_torch.autoscaler.gke as port_gke
import ray_tpu_torch.autoscaler.v2 as port_v2
import ray_tpu_torch.scripts as port_scripts
from test_torch_cluster_yaml import FakeGCP, FakeHTTP

PACKAGES = {
    "reference": dict(v1=ref_v1, v2=ref_v2, gke=ref_gke, gce=ref_gce, cc=ref_cc, scripts=ref_scripts),
    "port": dict(v1=port_v1, v2=port_v2, gke=port_gke, gce=port_gce, cc=port_cc, scripts=port_scripts),
}


@pytest.fixture
def fresh_ids(monkeypatch):
    """Instance ids count from 1 in both packages (cloud names carry them);
    the process's counters come back after the test."""
    for mods in PACKAGES.values():
        monkeypatch.setattr(mods["v2"].Instance, "_ids", itertools.count(1))


def both(run):
    """``run(mods)`` for the reference and the port, after resetting the
    instance ids before each."""
    out = {}
    for name, mods in PACKAGES.items():
        mods["v2"].Instance._ids = itertools.count(1)
        out[name] = run(mods)
    return out["reference"], out["port"]


# -- recorded requests -------------------------------------------------------

GKE_TYPES = {"v5e-8": {"pool": "v5e-pool", "resources": {"TPU": 8.0, "CPU": 44.0},
                       "labels": {"accelerator": "v5e"}, "min_workers": 0, "max_workers": 4}}


def gke_run(mods) -> list:
    fake = FakeGCP(["v5e-pool"])
    client = mods["gke"].GKEClient("proj", "us-central2-b", "clus", http=fake, token_provider=lambda: "t")
    provider = mods["gke"].GKETPUAsyncProvider(pools={"v5e-8": "v5e-pool"}, client=client)
    scaler = mods["v2"].AutoscalerV2(provider, GKE_TYPES, idle_timeout_s=0.0)
    feed = {"pending_demand": [{"TPU": 8.0}, {"TPU": 8.0}], "nodes": []}
    scaler._demand = lambda: feed
    statuses = [scaler.update(), scaler.update()]  # create, poll
    for busy in (True, False, False):  # pair, then idle: terminate
        feed = {"pending_demand": [], "nodes": [
            {"node_id": f"ray-{n}", "labels": {"provider_node_id": n}, "busy": busy}
            for n in fake.pools["v5e-pool"]]}
        statuses.append(scaler.update())
    client.set_node_pool_size("v5e-pool", 2)
    client.list_pool_instances("v5e-pool")
    cfg = {"cluster_name": "t", "provider": {"type": "gke_tpu", "project": "proj", "zone": "us-central2-b",
                                             "cluster": "clus"}, "node_types": GKE_TYPES}
    gone = mods["cc"].teardown_cluster(cfg, client=client)
    return [fake.requests, statuses, gone]


def gce_run(mods) -> list:
    fake = FakeHTTP()
    gce = mods["gce"].GCEClient("proj", "z", http=fake)
    tpu = mods["gce"].TPUNodeClient("proj", "z", http=fake)
    types = {"cpu": {"resources": {"CPU": 8}, "machine_type": "n2-standard-4",
                     "startup_script": "join $RAY_TPU_NODE_ID", "internal_ip_only": True},
             "v5e": {"resources": {"TPU": 8}, "accelerator_type": "v5litepod-8",
                     "startup_script": "join $RAY_TPU_NODE_ID"}}
    cfg = {"cluster_name": "Bare_Cluster", "provider": {"type": "gce_tpu", "project": "proj", "zone": "z"},
           "node_types": types}
    p = mods["cc"].build_provider(cfg, client=(gce, tpu))
    insts = [mods["v2"].Instance(node_type=t) for t in ("cpu", "v5e", "cpu")]
    polls = []
    for inst in insts:
        p.request_create(inst, types[inst.node_type]["resources"], {"ray-user": "A b"})
        polls.append(p.poll(inst))
    fake.instances[insts[0].provider_id]["status"] = "RUNNING"
    fake.tpu_nodes[insts[1].provider_id]["state"] = "PREEMPTED"
    polls += [p.poll(i) for i in insts]
    p.terminate(insts[2])
    for n in fake.tpu_nodes.values():
        n["labels"] = n["body"]["labels"]
    gone = mods["cc"].teardown_cluster(cfg, client=(gce, tpu))
    return [fake.calls, polls, gone]


@pytest.mark.parametrize("run", [gke_run, gce_run], ids=["gke", "gce"])
def test_cloud_requests_equal_the_reference(fresh_ids, run):
    ref, port = both(run)
    assert port[0], "the scenario made no request"
    assert port == ref
    for _method, _url, body in port[0]:
        if body is not None:
            json.dumps(body)


def test_refused_tpu_client_equals_the_reference(fresh_ids):
    """A single injected client covers the compute path only: a TPU node
    type then raises instead of dialing a real TPU API."""
    cfg = {"cluster_name": "c", "provider": {"type": "gce_tpu", "project": "p", "zone": "z"},
           "node_types": {"v5e": {"resources": {"TPU": 8}, "accelerator_type": "v5litepod-8"}}}

    def run(mods):
        fake = FakeHTTP()
        p = mods["cc"].build_provider(cfg, client=mods["gce"].GCEClient("p", "z", http=fake))
        with pytest.raises(RuntimeError) as e:
            p.request_create(mods["v2"].Instance(node_type="v5e"), {"TPU": 8}, {})
        return str(e.value), fake.calls

    ref, port = both(run)
    assert port == ref and "inject client=(gce_client, tpu_client)" in port[0]


# -- validation --------------------------------------------------------------

GOOD = {"cluster_name": "x", "provider": {"type": "fake"}, "node_types": {"a": {"resources": {"CPU": 1}}}}
BAD = {
    "not_a_mapping": ["cluster_name"],
    "none": None,
    "no_cluster_name": {k: v for k, v in GOOD.items() if k != "cluster_name"},
    "no_provider": {k: v for k, v in GOOD.items() if k != "provider"},
    "no_node_types": {k: v for k, v in GOOD.items() if k != "node_types"},
    "unknown_key": {**GOOD, "typo_key": 1, "another": 2},
    "provider_not_mapping": {**GOOD, "provider": "fake"},
    "provider_aws": {**GOOD, "provider": {"type": "aws"}},
    "gke_no_project": {**GOOD, "provider": {"type": "gke_tpu", "zone": "z", "cluster": "c"}},
    "gke_no_cluster": {**GOOD, "provider": {"type": "gke_tpu", "project": "p", "zone": "z"}},
    "gce_no_zone": {**GOOD, "provider": {"type": "gce_tpu", "project": "p"}},
    "node_types_empty": {**GOOD, "node_types": {}},
    "node_types_list": {**GOOD, "node_types": [{"resources": {}}]},
    "no_resources": {**GOOD, "node_types": {"a": {"min_workers": 1}}},
    "resources_not_mapping": {**GOOD, "node_types": {"a": {"resources": [1]}}},
    "unknown_type_key": {**GOOD, "node_types": {"a": {"resources": {"CPU": 1}, "gpus": 1, "zone": "z"}}},
    "min_over_max": {**GOOD, "node_types": {"a": {"resources": {"CPU": 1}, "min_workers": 3,
                                                  "max_workers": 1}}},
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_validation_errors_equal_the_reference(name):
    errors = []
    for mods in PACKAGES.values():
        with pytest.raises(ValueError) as e:
            mods["cc"].validate_cluster_config(BAD[name])
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_valid_configs_pass_both():
    gce_type = {"resources": {"GPU": 1}, "machine_type": "a3-highgpu-1g", "source_image": "img",
                "disk_size_gb": 200, "network": "n", "internal_ip_only": True, "startup_script": "s",
                "labels": {"a": "b"}, "min_workers": 0, "max_workers": 2}
    for cfg in (GOOD, {**GOOD, "head": {"num_cpus": 2}, "idle_timeout_s": 5, "update_interval_s": 0.5},
                {**GOOD, "provider": {"type": "gce_tpu", "project": "p", "zone": "z"},
                 "node_types": {"gpu": gce_type}}):
        for mods in PACKAGES.values():
            mods["cc"].validate_cluster_config(cfg)


# -- decisions ---------------------------------------------------------------

V2_TYPES = {
    "small": {"resources": {"CPU": 2.0}, "max_workers": 2},
    "gpu_worker": {"resources": {"GPU": 1.0, "CPU": 4.0}, "min_workers": 0, "max_workers": 1},
    "lab": {"resources": {"CPU": 2.0}, "labels": {"accel": "v5e"}, "min_workers": 1, "max_workers": 1},
}
# tick -> (pending shapes, their hard labels); nodes are busy up to BUSY_UNTIL
DEMAND = {
    0: ([{"CPU": 1.0}, {"GPU": 1.0}, {"GPU": 1.0}], [{}, {}, {}]),
    1: ([{"CPU": 2.0}, {"CPU": 2.0}, {"CPU": 1.0, "x": 0.0}], [{}, {}, {"accel": "v5e"}]),
    2: ([{"CPU": 8.0}, {"GPU": 1.0}], [{}, {"accel": "gpu"}]),
    3: ([{"CPU": 2.0}] * 3, [{}] * 3),
}
BUSY_UNTIL = 5
TICKS = 9


class ScriptedCloud:
    """An ``AsyncNodeProvider`` (duck-typed for both packages): a create is
    allocated at its second poll, but the third instance's first create
    fails; allocated instances join as nodes labelled with their instance
    id."""

    def __init__(self):
        self.polls, self.created, self.terminated, self.joined = {}, [], [], []
        self.fail_once = {"i-000003"}

    def request_create(self, instance, resources, labels):
        instance.provider_id = f"vm-{instance.instance_id}"
        self.created.append((instance.instance_id, dict(resources), dict(labels)))

    def poll(self, instance):
        n = self.polls[instance.instance_id] = self.polls.get(instance.instance_id, 0) + 1
        if n < 2:
            return "REQUESTED"
        if instance.instance_id in self.fail_once:
            self.fail_once.discard(instance.instance_id)
            self.polls[instance.instance_id] = 0
            return "ALLOCATION_FAILED"
        self.joined.append(instance.instance_id)
        return "ALLOCATED"

    def terminate(self, instance):
        self.terminated.append(instance.instance_id)


def v2_run(mods) -> list:
    cloud = ScriptedCloud()
    scaler = mods["v2"].AutoscalerV2(cloud, V2_TYPES, idle_timeout_s=0.0, retry_backoff_s=0.0)
    ticks = []
    for t in range(TICKS):
        shapes, labels = DEMAND.get(t, ([], []))
        scaler._demand = lambda: {
            "pending_demand": shapes, "pending_demand_labels": labels,
            "nodes": [{"node_id": f"n-{i}", "labels": {"instance_id": i}, "busy": t < BUSY_UNTIL}
                      for i in cloud.joined if i not in cloud.terminated]}
        counts = scaler.update()
        ticks.append(dict(counts=counts, created=list(cloud.created), terminated=list(cloud.terminated),
                          types=sorted((i.instance_id, i.node_type, i.status) for i in scaler.im.instances.values())))
    return ticks


class _NodeId(str):
    def hex(self):
        return str(self)


class ScriptedNodes:
    """A ``NodeProvider`` (duck-typed for both packages) whose nodes are
    named by type and order."""

    def __init__(self):
        self.nodes, self.n = {}, 0

    def create_node(self, node_type, resources, labels):
        self.n += 1
        pid = f"{node_type}-{self.n}"
        self.nodes[pid] = dict(resources)
        return pid

    def terminate_node(self, pid):
        self.nodes.pop(pid, None)

    def non_terminated_nodes(self):
        return list(self.nodes)

    def node_resources(self, pid):
        return dict(self.nodes[pid])

    def head_node_id_of(self, pid):
        return _NodeId(f"node-{pid}")


class ScriptedHead:
    """The head's two autoscaler calls, from the script."""

    def __init__(self, provider):
        self.provider, self.tick, self.offers = provider, 0, []

    def rpc_autoscaler_offer(self, shapes):
        self.offers.append(shapes)

    def rpc_autoscaler_demand(self):
        shapes, _labels = DEMAND.get(self.tick, ([], []))
        busy = self.tick < BUSY_UNTIL
        nodes = [{"node_id": f"node-{pid}", "alive": True, "resources_available": {} if busy else dict(res),
                  "busy": busy, "idle_s": 0.0 if busy else 10.0} for pid, res in self.provider.nodes.items()]
        return {"pending_demand": shapes, "nodes": nodes}


def v1_run(mods) -> list:
    nodes = ScriptedNodes()
    head = ScriptedHead(nodes)
    types = {k: {kk: vv for kk, vv in v.items() if kk != "labels"} for k, v in V2_TYPES.items()}
    scaler = mods["v1"].StandardAutoscaler(nodes, types, idle_timeout_s=1.0, launch_grace_s=0.0, head=head)
    ticks = []
    for t in range(TICKS):
        head.tick = t
        ticks.append(scaler.update())
    return [ticks, head.offers]


def test_v2_decisions_equal_the_reference(fresh_ids):
    ref, port = both(v2_run)
    assert any(t["counts"].get("RAY_RUNNING") for t in port) and port[-1]["terminated"]
    assert any(t["counts"].get("ALLOCATION_FAILED") for t in port)
    assert port == ref


def test_v1_decisions_equal_the_reference(fresh_ids):
    (ref, ref_offers), (port, port_offers) = both(v1_run)
    assert sum(len(t["launched"]) for t in port) > 1 and sum(len(t["terminated"]) for t in port) > 0
    assert port == ref
    # the port's autoscaler tells the head its node types' shapes each pass
    # (a GPU request then waits for the GPU node); the reference's sends none
    assert ref_offers == [] and port_offers == [[t["resources"] for t in V2_TYPES.values()]] * TICKS


# -- the CLI's parsers -------------------------------------------------------


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def parser_surface(main) -> dict:
    """Every subcommand of ``main``'s parser with its arguments: option
    strings, destination, default, type, choices, nargs, required, action."""

    def capture(self, args=None, namespace=None):
        raise _Parsed(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as e:
            main(["status"])
    sub = next(a for a in e.value.parser._actions if isinstance(a, argparse._SubParsersAction))
    return {
        name: [(tuple(a.option_strings), a.dest, a.default, getattr(a.type, "__name__", a.type), a.choices,
                a.nargs, a.required, type(a).__name__, a.help)
               for a in p._actions]
        for name, p in sub.choices.items()
    }


def test_cli_parsers_equal_the_reference():
    ref = parser_surface(ref_scripts.main)
    port = parser_surface(port_scripts.main)
    assert sorted(port) == sorted(["start", "up", "down", "summary", "list", "timeline", "grafana", "status",
                                   "stacks", "profile", "node-stats", "job"])
    assert port == ref


# -- the config loader -------------------------------------------------------


def test_load_json_config_equals_the_reference(tmp_path):
    """One ``.json`` file (JSON is YAML too: phase 32 of ``chip_smoke.py``
    writes its config so) loads to the same config through both packages."""
    cfg = {"cluster_name": "p32", "provider": {"type": "fake"}, "head": {"num_cpus": 2},
           "node_types": {"gpu_worker": {"resources": {"GPU": 1, "CPU": 4}, "min_workers": 0,
                                         "max_workers": 1}},
           "idle_timeout_s": 5, "update_interval_s": 0.5}
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(cfg, indent=2))
    ref = ref_cc.load_cluster_config(str(path))
    assert port_cc.load_cluster_config(str(path)) == ref == cfg
