"""StandardAutoscaler: pending-demand bin-packing → node launches; idle
nodes reaped after a timeout.

Reference: ``autoscaler/_private/autoscaler.py:171`` (StandardAutoscaler,
``update`` :373) + ``resource_demand_scheduler.py`` (fit pending resource
shapes against node types, launch the minimal set). Driven either by
explicit ``update()`` calls (tests) or the ``Monitor`` thread (the
reference's monitor.py process).

Each pass first tells the head which resource shapes it can launch
(``rpc_autoscaler_offer``): the port's head fails a GPU request at once on
a cluster with no GPU node, and waits instead when an offered node type has
a ``GPU`` (where the reference's head always waits).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider


def _fits(shape: dict, capacity: dict) -> bool:
    return all(capacity.get(k, 0.0) >= v for k, v in shape.items() if v > 0)


def _sub(capacity: dict, shape: dict) -> dict:
    out = dict(capacity)
    for k, v in shape.items():
        out[k] = out.get(k, 0.0) - v
    return out


class StandardAutoscaler:
    """``node_types``: {name: {"resources": {...}, "max_workers": int,
    "min_workers": int}}. One provider node per launch."""

    def __init__(
        self,
        provider: NodeProvider,
        node_types: dict,
        idle_timeout_s: float = 30.0,
        launch_grace_s: float = 10.0,
        head=None,
        ctx=None,
    ):
        self.provider = provider
        self.node_types = node_types
        self.idle_timeout_s = idle_timeout_s
        self.launch_grace_s = launch_grace_s
        self._head = head
        self._ctx = ctx
        self._launch_times: dict[str, float] = {}
        self._types: dict[str, str] = {}  # provider node id -> node type
        self._counts: dict[str, int] = {t: 0 for t in node_types}

    # -- demand feed -------------------------------------------------------

    def _call(self, method: str, **payload):
        if self._ctx is not None:
            return self._ctx.call(method, **payload)
        if self._head is not None:
            return getattr(self._head, "rpc_" + method)(**payload)
        from ray_tpu_torch._private.runtime import get_ctx

        return get_ctx().call(method, **payload)

    def _offer(self) -> None:
        self._call("autoscaler_offer", shapes=[t["resources"] for t in self.node_types.values()])

    def _demand(self) -> dict:
        return self._call("autoscaler_demand")

    # -- one reconciliation pass ------------------------------------------

    def update(self) -> dict:
        """Returns {"launched": [...], "terminated": [...]} this pass."""
        self._offer()
        feed = self._demand()
        launched, terminated = [], []

        # 1) ensure min_workers
        for t, cfg in self.node_types.items():
            while self._counts[t] < cfg.get("min_workers", 0):
                launched.append(self._launch(t))

        # 2) unmet demand: shapes that fit no live node's availability and
        # no in-grace freshly-launched capacity
        avail: list[tuple] = [  # (head node_id | None, capacity)
            (n["node_id"], dict(n["resources_available"]))
            for n in feed["nodes"]
            if n["alive"]
        ]
        now = time.monotonic()
        for pid, t0 in self._launch_times.items():
            if now - t0 < self.launch_grace_s and pid in self.provider.non_terminated_nodes():
                # capacity that is still materializing — count it
                avail.append((None, self.provider.node_resources(pid)))
        placed_on: set[str] = set()  # nodes step 3 must not reap this pass
        for shape in feed["pending_demand"]:
            if not shape:
                continue
            placed = False
            for i, (nid, cap) in enumerate(avail):
                if _fits(shape, cap):
                    avail[i] = (nid, _sub(cap, shape))
                    if nid is not None:
                        placed_on.add(nid)
                    placed = True
                    break
            if placed:
                continue
            # launch the smallest node type that can hold the shape
            for t, cfg in sorted(
                self.node_types.items(), key=lambda kv: sum(kv[1]["resources"].values())
            ):
                if _fits(shape, cfg["resources"]) and self._counts[t] < cfg.get(
                    "max_workers", 1
                ):
                    pid = self._launch(t)
                    launched.append(pid)
                    avail.append((None, _sub(self.provider.node_resources(pid), shape)))
                    break

        # 3) idle scale-down (never below min_workers; grace after launch)
        by_head_id = {}
        for pid in self.provider.non_terminated_nodes():
            hid = getattr(self.provider, "head_node_id_of", lambda p: None)(pid)
            if hid is not None:
                by_head_id[hid.hex()] = pid
        for n in feed["nodes"]:
            pid = by_head_id.get(n["node_id"])
            if pid is None or n["busy"] or n["idle_s"] < self.idle_timeout_s:
                continue
            if n["node_id"] in placed_on:
                continue  # step 2 just bin-packed pending demand onto it
            if now - self._launch_times.get(pid, 0.0) < self.launch_grace_s:
                continue
            node_type = self._types.get(pid)
            min_w = self.node_types.get(node_type, {}).get("min_workers", 0)
            if node_type and self._counts.get(node_type, 0) <= min_w:
                continue
            self.provider.terminate_node(pid)
            if node_type:
                self._counts[node_type] -= 1
            self._launch_times.pop(pid, None)
            terminated.append(pid)

        return {"launched": launched, "terminated": terminated}

    def _launch(self, node_type: str) -> str:
        cfg = self.node_types[node_type]
        pid = self.provider.create_node(
            node_type, cfg["resources"], labels={"autoscaled": "1"}
        )
        self._counts[node_type] += 1
        self._types[pid] = node_type
        self._launch_times[pid] = time.monotonic()
        return pid


class Monitor:
    """Background loop calling ``autoscaler.update()`` (reference:
    ``autoscaler/_private/monitor.py``)."""

    def __init__(self, autoscaler: StandardAutoscaler, interval_s: float = 1.0):
        self.autoscaler = autoscaler
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        from ray_tpu_torch._private.log_util import warn_throttled

        while not self._stop.is_set():
            try:
                self.autoscaler.update()
            except Exception as e:
                warn_throttled("autoscaler monitor loop", e)
            self._stop.wait(self.interval_s)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
