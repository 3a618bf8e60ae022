"""State API: structured introspection of cluster state.

Reference: ``python/ray/util/state/api.py`` (``list_tasks``/``list_actors``/
``list_objects``/``list_nodes``/``list_placement_groups``, ``summarize_*``)
and ``_private/state.py:924`` (``ray timeline`` Chrome-trace export). The
head's live tables and its ``task_events`` feed (``_private/head.py:244``)
are the single source of truth; this module is the read-side.

Use from any driver/worker attached to a cluster::

    from ray_tpu_torch.util import state
    state.list_tasks()                  # [{'task_id':…,'state':…,'name':…}]
    state.summarize_tasks()             # counts by state
    state.timeline("/tmp/trace.json")   # chrome://tracing importable
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict
from typing import Any, Optional


def _ctx():
    from ray_tpu_torch._private.runtime import get_ctx

    ctx = get_ctx()
    if ctx is None:
        raise RuntimeError("ray_tpu_torch is not initialized; call ray_tpu_torch.init() first")
    return ctx


def list_tasks() -> list[dict]:
    """Live (not-yet-finished) tasks with their scheduling state."""
    return _ctx().call("list_tasks")


def list_actors() -> list[dict]:
    """All actors with lifecycle state, name, class and node."""
    return _ctx().call("list_actors")


def list_objects() -> list[dict]:
    """Objects in the store: size, readiness, refcount, pin count."""
    return _ctx().call("list_objects")


def list_nodes() -> list[dict]:
    """Cluster membership with total/available resources."""
    return _ctx().call("nodes")


def list_placement_groups() -> list[dict]:
    return _ctx().call("list_placement_groups")


def get_task_events() -> list[dict]:
    """The raw task state-transition feed (bounded ring, newest last)."""
    return _ctx().call("task_events")


def get_node_stats() -> dict:
    """Per-node /proc samples: cpu/mem/disk/load (reference: the
    dashboard reporter agent's psutil stats)."""
    return _ctx().call("node_stats")


def get_worker_stacks(timeout: float = 5.0) -> dict:
    """All-thread stack dumps of every worker (SIGUSR1 → faulthandler;
    works on wedged workers — reference: dashboard py-spy dumps).
    Returns {node: {pid: stacks_text}} with 'local' for the head host."""
    return _ctx().call("worker_stacks", timeout=timeout)


def profile_workers(duration_s: float = 2.0, interval_ms: float = 10.0) -> dict:
    """Sampling CPU profile of every live worker for ``duration_s``
    (reference: the dashboard's py-spy ``cpu_profile`` endpoint). Returns
    ``{node: {pid: collapsed_stacks}}`` — each value is flamegraph.pl /
    speedscope-ready collapsed-stack text, hottest stack first."""
    return _ctx().call(
        "worker_profile", duration_s=duration_s, interval_ms=interval_ms
    )


def get_alerts(eval_now: bool = False) -> list[dict]:
    """The head's SLO burn-rate engine state: one dict per rule with
    ``status`` (OK/FIRING/RESOLVED), current ``value``, ``since``, and
    ``labels``. ``eval_now`` forces an evaluation pass first."""
    return _ctx().call("alerts", eval_now=eval_now)


# ---------------------------------------------------------------------------
# summaries (reference: `ray summary tasks/actors/objects`)
# ---------------------------------------------------------------------------


def summarize_tasks() -> dict:
    events = get_task_events()
    per_task: dict[str, str] = {}
    names: dict[str, Optional[str]] = {}
    for ev in events:
        per_task[ev["task_id"]] = ev["state"]
        names[ev["task_id"]] = ev.get("name")
    for t in list_tasks():  # still-live tasks override their event state
        per_task[t["task_id"]] = t["state"]
        names[t["task_id"]] = t.get("name")
    by_state = Counter(per_task.values())
    by_func: dict[str, Counter] = defaultdict(Counter)
    for tid, st in per_task.items():
        by_func[names.get(tid) or "<unknown>"][st] += 1
    return {
        "total": len(per_task),
        "by_state": dict(by_state),
        "by_func": {k: dict(v) for k, v in sorted(by_func.items())},
    }


def summarize_actors() -> dict:
    actors = list_actors()
    return {
        "total": len(actors),
        "by_state": dict(Counter(a["state"] for a in actors)),
        "by_class": dict(Counter(a["class_name"] or "<unknown>" for a in actors)),
    }


def summarize_objects() -> dict:
    objs = list_objects()
    return {
        "total": len(objs),
        "total_bytes": sum(o["size"] or 0 for o in objs),
        "ready": sum(1 for o in objs if o["ready"]),
        "pinned": sum(1 for o in objs if o["pins"]),
        "spilled_bytes": sum(
            o["size"] or 0 for o in objs if o.get("where") == "spilled"
        ),
    }


def summary() -> dict:
    """One-call cluster overview (CLI: ``python -m ray_tpu_torch summary``)."""
    return {
        "nodes": list_nodes(),
        "tasks": summarize_tasks(),
        "actors": summarize_actors(),
        "objects": summarize_objects(),
    }


# ---------------------------------------------------------------------------
# timeline (reference: `ray timeline` -> chrome://tracing)
# ---------------------------------------------------------------------------


def timeline(path: Optional[str] = None) -> list[dict]:
    """Chrome-trace 'complete' events (ph=X) from RUNNING->FINISHED/FAILED
    pairs in the task-event feed. Load the file via chrome://tracing or
    https://ui.perfetto.dev."""
    events = get_task_events()
    open_ts: dict[str, dict] = {}
    trace: list[dict] = []
    for ev in events:
        tid = ev["task_id"]
        if ev["state"] == "RUNNING":
            open_ts[tid] = ev
        elif ev["state"] in ("FINISHED", "FAILED") and tid in open_ts:
            start = open_ts.pop(tid)
            args = {"state": ev["state"], "task_id": tid}
            rid = ev.get("request_id") or start.get("request_id")
            if rid:
                # one lane per request: tracing.export_chrome_trace mirrors
                # entries carrying a request_id into the "requests" group
                args["request_id"] = rid
            trace.append(
                {
                    "name": ev.get("name") or tid[:8],
                    "cat": ev.get("kind") or "task",
                    "ph": "X",
                    "ts": start["time"] * 1e6,
                    "dur": max(0.0, (ev["time"] - start["time"]) * 1e6),
                    "pid": "ray_tpu_torch",
                    "tid": tid[:8],
                    "args": args,
                }
            )
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace
