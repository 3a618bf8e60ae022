"""CLI: ``python -m ray_tpu_torch <command>``.

Reference: ``python/ray/scripts/scripts.py:566`` (``ray start --head`` /
``ray start --address=`` node launcher) and the state CLI
(``util/state/state_cli.py`` — ``ray summary``, ``ray list``, ``ray
timeline``). The head command hosts the cluster head in THIS process
(listening on unix socket + TCP); the node command joins this machine to a
remote head via the node agent.

The port's copy of ``ray_tpu/scripts.py``: the same subcommands, options
and printed lines. ``start --head`` registers the host's cards as ``GPU``
(``accelerators.gpu``, nvidia-smi and ``CUDA_VISIBLE_DEVICES``) where the
reference registers TPU chips. No command imports torch.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time


def _parse_resources(raw):
    res = json.loads(raw) if raw else {}
    if not isinstance(res, dict):
        raise SystemExit("--resources must be a JSON object")
    return res


def cmd_start(args) -> int:
    from ray_tpu_torch._private.config import resolve_authkey

    authkey = resolve_authkey()
    if args.head:
        from ray_tpu_torch._private.head import Head

        session = tempfile.mkdtemp(prefix="ray_tpu_head_")
        head = Head(os.path.join(session, "head.sock"), authkey=authkey)
        head.start()
        host, port = head.listen_tcp(args.host, args.port)
        res = _parse_resources(args.resources)
        res.setdefault("CPU", float(args.num_cpus or os.cpu_count() or 1))
        from ray_tpu_torch.accelerators import gpu as gpu_accel

        gpus = gpu_accel.detect_num_gpus()
        if gpus:
            res.setdefault("GPU", float(gpus))
            # the card-type key follows the GPU count in force: none under
            # --resources '{"GPU": 0}'
            for key, value in gpu_accel.extra_resources(int(res["GPU"])).items():
                res.setdefault(key, value)
        head.add_node(res)
        print(f"ray_tpu_torch head listening on {host}:{port}")
        print(f"  attach a node:   python -m ray_tpu_torch start --address={host}:{port}")
        print(f"  attach a driver: ray_tpu_torch.init(address=\"{host}:{port}\")")
        sys.stdout.flush()
        stop = []
        signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
        signal.signal(signal.SIGINT, lambda *a: stop.append(1))
        try:
            while not stop:
                time.sleep(0.2)
        finally:
            head.shutdown()
        return 0

    if not args.address:
        raise SystemExit("pass --head to start a head, or --address=HOST:PORT to join one")
    from ray_tpu_torch._private.node_agent import NodeAgent

    res = _parse_resources(args.resources)
    if args.num_cpus:
        res.setdefault("CPU", float(args.num_cpus))
    labels = json.loads(args.labels) if getattr(args, "labels", None) else None
    agent = NodeAgent(args.address, authkey, resources=res or None, labels=labels)
    print(f"ray_tpu_torch node joined {args.address} as {agent.node_id_bin.hex()[:12]}")
    sys.stdout.flush()
    agent.run()
    return 0


def _attached(address):
    import ray_tpu_torch

    ray_tpu_torch.init(address=address)
    return ray_tpu_torch


def cmd_summary(args) -> int:
    from ray_tpu_torch.util import state

    ray_tpu_torch = _attached(args.address)
    print(json.dumps(state.summary(), indent=2, default=str))
    ray_tpu_torch.shutdown()
    return 0


def cmd_list(args) -> int:
    from ray_tpu_torch.util import state

    ray_tpu_torch = _attached(args.address)
    fn = {
        "tasks": state.list_tasks,
        "actors": state.list_actors,
        "objects": state.list_objects,
        "nodes": state.list_nodes,
        "placement-groups": state.list_placement_groups,
    }[args.kind]
    print(json.dumps(fn(), indent=2, default=str))
    ray_tpu_torch.shutdown()
    return 0


def cmd_stacks(args) -> int:
    """Dump every worker's thread stacks (debugging stuck workers —
    reference: `ray stack` / dashboard py-spy dumps)."""
    from ray_tpu_torch.util import state

    ray_tpu_torch = _attached(args.address)
    stacks = state.get_worker_stacks()
    for node, per_pid in stacks.items():
        for pid, text in per_pid.items():
            print(f"==== node {node} worker {pid} ====")
            print(text)
    ray_tpu_torch.shutdown()
    return 0


def cmd_profile(args) -> int:
    """Sampling CPU profile of every worker; prints collapsed stacks
    (pipe a section into flamegraph.pl — reference: `ray timeline`-era
    dashboard py-spy cpu_profile)."""
    from ray_tpu_torch.util import state

    ray_tpu_torch = _attached(args.address)
    prof = state.profile_workers(
        duration_s=args.seconds, interval_ms=1000.0 / max(args.rate, 1.0)
    )
    for node, per_pid in prof.items():
        for err in per_pid.pop("_errors", []):
            print(f"==== node {node}: {err} ====", file=sys.stderr)
        for pid, text in per_pid.items():
            print(f"==== node {node} worker {pid} ====")
            print(text)
    ray_tpu_torch.shutdown()
    return 0


def cmd_nodestats(args) -> int:
    from ray_tpu_torch.util import state

    ray_tpu_torch = _attached(args.address)
    print(json.dumps(state.get_node_stats(), indent=2, default=str))
    ray_tpu_torch.shutdown()
    return 0


def cmd_timeline(args) -> int:
    from ray_tpu_torch.util import state

    ray_tpu_torch = _attached(args.address)
    trace = state.timeline(args.output)
    print(f"wrote {len(trace)} events to {args.output}")
    ray_tpu_torch.shutdown()
    return 0


def cmd_grafana(args) -> int:
    """Emit the generated Grafana dashboard JSON (util/grafana.py;
    reference: grafana_dashboard_factory.py). No cluster needed."""
    from ray_tpu_torch.util.grafana import dashboard_json

    text = json.dumps(dashboard_json(), indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def cmd_status(args) -> int:
    ray_tpu_torch = _attached(args.address)
    print(json.dumps(
        {
            "nodes": ray_tpu_torch.nodes(),
            "cluster_resources": ray_tpu_torch.cluster_resources(),
            "available_resources": ray_tpu_torch.available_resources(),
        },
        indent=2,
        default=str,
    ))
    ray_tpu_torch.shutdown()
    return 0


def cmd_job(args) -> int:
    from ray_tpu_torch import job as joblib

    ray_tpu_torch = _attached(args.address)
    try:
        if args.action == "submit":
            entry = list(args.entrypoint or [])
            if entry and entry[0] == "--":
                entry = entry[1:]  # strip only argparse's leading separator
            if not entry:
                raise SystemExit("job submit needs an entrypoint after --")
            import shlex

            jid = joblib.submit_job(" ".join(shlex.quote(a) for a in entry))
            print(jid)
        elif args.action == "list":
            print(json.dumps(joblib.list_jobs(), indent=2, default=str))
        else:
            if not args.job_id:
                raise SystemExit("--job-id required")
            if args.action == "status":
                print(joblib.get_job_status(args.job_id))
            elif args.action == "logs":
                sys.stdout.write(joblib.get_job_logs(args.job_id))
            elif args.action == "stop":
                print(joblib.stop_job(args.job_id))
    finally:
        ray_tpu_torch.shutdown()
    return 0


def cmd_up(args) -> int:
    """Launch a cluster from YAML: head in this process + autoscaler loop
    (reference: `ray up` in autoscaler/_private/commands.py)."""
    from ray_tpu_torch._private.config import resolve_authkey
    from ray_tpu_torch._private.head import Head
    from ray_tpu_torch.autoscaler.cluster_config import (
        build_provider,
        load_cluster_config,
        run_cluster,
    )

    cfg = load_cluster_config(args.config)
    head_cfg = cfg.get("head") or {}
    session = tempfile.mkdtemp(prefix="ray_tpu_head_")
    head = Head(os.path.join(session, "head.sock"), authkey=resolve_authkey())
    head.start()
    host, port = head.listen_tcp(
        head_cfg.get("host", "127.0.0.1"), int(head_cfg.get("port", 0))
    )
    head.add_node({"CPU": float(head_cfg.get("num_cpus", os.cpu_count() or 1))})
    print(f"[{cfg['cluster_name']}] head listening on {host}:{port}")
    print(
        "  worker join: python -m ray_tpu_torch start "
        f"--address={host}:{port} "
        "--labels '{\"provider_node_id\": \"'$(hostname)'\"}'"
    )
    sys.stdout.flush()
    cluster = None
    if cfg["provider"]["type"] == "fake":
        from ray_tpu_torch.cluster_utils import Cluster

        cluster = Cluster(head=head)
    provider = build_provider(cfg, cluster=cluster)
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    try:
        counts = run_cluster(
            cfg,
            head,
            provider,
            max_ticks=args.ticks,
            stop_check=lambda: bool(stop),
        )
        print(f"[{cfg['cluster_name']}] instances: {json.dumps(counts)}")
    finally:
        head.shutdown()
    return 0


def cmd_down(args) -> int:
    from ray_tpu_torch.autoscaler.cluster_config import load_cluster_config, teardown_cluster

    cfg = load_cluster_config(args.config)
    gone = teardown_cluster(cfg)
    print(f"[{cfg['cluster_name']}] terminated {len(gone)} instance(s)")
    for name in gone:
        print(f"  {name}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("start", help="start a head or join a cluster as a node")
    p.add_argument("--head", action="store_true")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--address", help="HOST:PORT of a running head (node mode)")
    p.add_argument("--num-cpus", type=int)
    p.add_argument("--resources", help="JSON resource dict")
    p.add_argument("--labels", help="JSON node labels (e.g. provider_node_id)")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("up", help="launch a cluster from a YAML config")
    p.add_argument("config", help="path to cluster YAML")
    p.add_argument(
        "--ticks",
        type=int,
        help="run N autoscaler reconcile ticks then exit (default: forever)",
    )
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("down", help="terminate every cluster VM from a YAML config")
    p.add_argument("config", help="path to cluster YAML")
    p.set_defaults(fn=cmd_down)

    p = sub.add_parser("summary", help="cluster state summary")
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("list", help="list tasks/actors/objects/nodes/placement-groups")
    p.add_argument("kind", choices=["tasks", "actors", "objects", "nodes", "placement-groups"])
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("timeline", help="export a chrome://tracing task timeline")
    p.add_argument("--address", required=True)
    p.add_argument("--output", default="ray_tpu_timeline.json")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("grafana", help="emit an importable Grafana dashboard JSON")
    p.add_argument("-o", "--output", default=None, help="write to file instead of stdout")
    p.set_defaults(fn=cmd_grafana)

    p = sub.add_parser("status", help="nodes + resource totals")
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("stacks", help="dump every worker's thread stacks (stuck-worker debugging)")
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_stacks)

    p = sub.add_parser(
        "profile",
        help="sampling CPU profile of every worker (collapsed stacks for flamegraph.pl)",
    )
    p.add_argument("--address", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--rate", type=float, default=100.0, help="samples per second")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("node-stats", help="per-node cpu/mem/disk stats")
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_nodestats)

    p = sub.add_parser("job", help="submit/inspect jobs on a running cluster")
    p.add_argument("action", choices=["submit", "status", "logs", "stop", "list"])
    p.add_argument("--address", required=True)
    p.add_argument("--job-id")
    p.add_argument("entrypoint", nargs=argparse.REMAINDER,
                   help="(submit) shell command, after --")
    p.set_defaults(fn=cmd_job)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
