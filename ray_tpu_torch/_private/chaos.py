"""Randomized fault injection for stress/chaos testing (copy of
``ray_tpu/_private/chaos.py``, over the port's in-process head).

Reference: ``python/ray/_private/test_utils.py:1396,1464``
(ResourceKillerActor / NodeKillerActor randomly SIGKILL worker and raylet
processes while workloads run) and ``python/ray/tests/test_chaos.py``. A GC
deadlock is exactly the class of bug that per-feature tests miss and
randomized pressure finds — this module is product code (not buried in a
test helper) so any deployment can soak-test its own workloads.

The killer runs inside the driver process of an in-process head (the test
topology) and SIGKILLs random live worker subprocesses; the head's existing
failure machinery — conn-EOF death detection, task retries, actor restart
FSM, lineage reconstruction — must absorb every kill.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Optional


class ResourceKiller:
    """Periodically SIGKILL a random live worker while a workload runs.

    Seeded for reproducibility (a failing seed is a regression test). Use as
    a context manager::

        with ResourceKiller(interval_s=0.4, seed=7):
            run_workload()
    """

    def __init__(
        self,
        interval_s: float = 0.5,
        seed: int = 0,
        warmup_s: float = 0.3,
        max_kills: Optional[int] = None,
        kill_actor_workers: bool = True,
    ):
        self.interval_s = interval_s
        self.rng = random.Random(seed)
        self.warmup_s = warmup_s
        self.max_kills = max_kills
        self.kill_actor_workers = kill_actor_workers
        self.kills: list[tuple[float, int, str]] = []  # (t, pid, kind)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- targets -----------------------------------------------------------
    def _candidates(self):
        from ray_tpu_torch._private.runtime import get_ctx

        head = getattr(get_ctx(), "head", None)
        if head is None:
            raise RuntimeError("ResourceKiller needs an in-process head (driver)")
        out = []
        with head.lock:
            for node in head.nodes.values():
                for wh in node.all_workers:
                    if not wh.alive or wh.proc is None or not wh.proc.is_alive():
                        continue
                    if wh.actor_id is not None and not self.kill_actor_workers:
                        continue
                    out.append(wh)
        return out

    def _kill_one(self) -> bool:
        victims = self._candidates()
        if not victims:
            return False
        wh = self.rng.choice(victims)
        kind = "actor-worker" if wh.actor_id is not None else "task-worker"
        pid = wh.proc.pid
        try:
            os.kill(pid, signal.SIGKILL)  # brutal, like the reference
        except (ProcessLookupError, OSError):
            return False
        self.kills.append((time.monotonic(), pid, kind))
        return True

    # -- lifecycle ---------------------------------------------------------
    def _run(self):
        time.sleep(self.warmup_s)
        while not self._stop.is_set():
            if self.max_kills is not None and len(self.kills) >= self.max_kills:
                return
            try:
                self._kill_one()
            except Exception:  # noqa: BLE001
                # the runtime may be torn down (shutdown() mid-chaos) while
                # this thread is live — that is "no candidates", not a crash
                return
            self._stop.wait(self.interval_s)

    def start(self) -> "ResourceKiller":
        self._thread = threading.Thread(
            target=self._run, name="resource-killer", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> list[tuple[float, int, str]]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        return self.kills

    def __enter__(self) -> "ResourceKiller":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


# ---------------------------------------------------------------------------
# serve-plane chaos: replica and controller killers
# ---------------------------------------------------------------------------


def _workers_by_actor_id(actor_ids: set[bytes]):
    """Live worker handles whose actor is one of ``actor_ids``."""
    from ray_tpu_torch._private.runtime import get_ctx

    head = getattr(get_ctx(), "head", None)
    if head is None:
        raise RuntimeError("serve chaos needs an in-process head (driver)")
    out = []
    with head.lock:
        for node in head.nodes.values():
            for wh in node.all_workers:
                if not wh.alive or wh.proc is None or not wh.proc.is_alive():
                    continue
                if wh.actor_id in actor_ids:
                    out.append(wh)
    return out


def pid_of_actor(actor_id_hex: str):
    """PID of the worker hosting an actor (None when not found/alive) —
    lets a test SIGKILL a SPECIFIC serve replica deterministically."""
    whs = _workers_by_actor_id({bytes.fromhex(actor_id_hex)})
    return whs[0].proc.pid if whs else None


def kill_serve_controller() -> Optional[int]:
    """SIGKILL the serve controller's worker process; returns the pid (None
    when no controller is running). The data plane — proxies, routers,
    replicas, in-flight streams — must keep serving without it; only
    control-plane actions (deploy, autoscale, replica replacement) pause
    until a new controller is started (``serve.run`` recreates it)."""
    from ray_tpu_torch._private.runtime import get_ctx
    from ray_tpu_torch.serve._private.common import CONTROLLER_NAME

    head = getattr(get_ctx(), "head", None)
    if head is None:
        raise RuntimeError("serve chaos needs an in-process head (driver)")
    with head.lock:
        # named_actors is keyed "<namespace>:<name>"; the detached
        # controller registers under whichever namespace created it
        aid = next(
            (
                v for k, v in head.named_actors.items()
                if k.rsplit(":", 1)[-1] == CONTROLLER_NAME
            ),
            None,
        )
    if aid is None:
        return None
    whs = _workers_by_actor_id({aid})
    if not whs:
        return None
    pid = whs[0].proc.pid
    try:
        os.kill(pid, signal.SIGKILL)
    except (ProcessLookupError, OSError):
        return None
    return pid


class ServeReplicaKiller(ResourceKiller):
    """Periodically SIGKILL a random live serve REPLICA while streaming
    traffic runs — the serve-plane analog of ResourceKiller. Every kill
    must be absorbed by mid-stream failover (resumable streams,
    RESILIENCE.md) and the controller's replica replacement; a truncated,
    wrong, or hung stream is a bug.

        with ServeReplicaKiller(deployment="llm_LLMDeployment",
                                interval_s=1.0, seed=7):
            run_streaming_workload()

    ``deployment=None`` targets every deployment's replicas.
    """

    def __init__(
        self,
        deployment: Optional[str] = None,
        interval_s: float = 1.0,
        seed: int = 0,
        warmup_s: float = 0.3,
        max_kills: Optional[int] = None,
    ):
        super().__init__(
            interval_s=interval_s, seed=seed, warmup_s=warmup_s,
            max_kills=max_kills,
        )
        self.deployment = deployment

    def _candidates(self):
        import ray_tpu_torch
        from ray_tpu_torch._private.log_util import warn_throttled
        from ray_tpu_torch.serve._private.common import CONTROLLER_NAME

        try:
            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            by_dep = ray_tpu_torch.get(
                controller.get_replica_actor_ids.remote(self.deployment),
                timeout=10,
            )
        except Exception as e:
            # transient by design: the controller may itself be mid-kill /
            # mid-restart in a combined chaos scenario. "No candidates this
            # tick" keeps the killer thread alive (the base _run treats an
            # ESCAPING exception as runtime teardown and stops for good,
            # which would silently end chaos injection mid-soak).
            warn_throttled("serve chaos: controller lookup", e)
            return []
        ids = {
            bytes.fromhex(h) for hs in by_dep.values() for h in hs
        }
        return _workers_by_actor_id(ids)

    def _kill_one(self) -> bool:
        victims = self._candidates()
        if not victims:
            return False
        wh = self.rng.choice(victims)
        pid = wh.proc.pid
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, OSError):
            return False
        self.kills.append((time.monotonic(), pid, "serve-replica"))
        return True
