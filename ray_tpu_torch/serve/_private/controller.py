"""ServeController: the control-plane actor reconciling target deployment
state into replica actors (copy of ``ray_tpu/serve/_private/controller.py``).

Reference: ``serve/_private/controller.py:91`` (ServeController run loop),
``_private/deployment_state.py:1221`` (DeploymentState reconciliation:
target replicas vs running, starting/stopping), ``autoscaling_policy.py``
(ongoing-request-driven replica counts). One controller actor per cluster
(named actor ``SERVE_CONTROLLER``); a background reconcile thread diffs
target vs actual every ``RECONCILE_PERIOD_S``, restarts dead replicas,
applies autoscaling decisions from replica metrics, and bumps a version
counter that handle-side routers long-poll to refresh their replica sets.

The port's addition: a deployment whose replicas ask for a GPU
(``ray_actor_options={"num_gpus": n}``) is refused at deploy time on a
cluster where no node has one, so ``serve.run`` raises at once instead of
restart-looping replicas the head cannot place (and a GPU replica never
comes up on the CPU). Specs arrive ``Sealed``: the controller forwards the
user class and its arguments to replicas without unpickling them.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Optional

from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private.log_util import warn_throttled
from ray_tpu_torch.serve._private.common import (
    AutoscalingConfig,
    DeploymentSpec,
    ReplicaInfo,
)

RECONCILE_PERIOD_S = 0.25
#: A replica that has not finished __init__ (answered its first health
#: check) within this window is declared failed and replaced.
REPLICA_INIT_TIMEOUT_S = 120.0


def desired_replicas(
    cfg: AutoscalingConfig, metrics: list[dict], current: int,
    alerts: tuple = (),
) -> int:
    """Pure scaling decision from one round of replica metrics.

    Load is ongoing requests PLUS replica-exported queue depth (a
    continuous-batching replica holds admitted streams in its engine
    queue, invisible to ongoing counts alone), divided by the per-replica
    target.  A replica at/above the KV-utilization threshold adds one
    replica of upscale pressure on top — a memory-bound engine preempts
    and thrashes long before its request count looks saturated.  A FIRING
    SLO alert labeled ``serve=upscale`` (the head's burn-rate engine —
    e.g. TTFT p99 burning its budget) does the same: latency degradation
    is upscale pressure even when request counts look fine.  Bounded by
    [min_replicas, max_replicas]; delay/hysteresis is the caller's
    (``_autoscale``'s) job."""
    total_load = 0.0
    kv_max = 0.0
    for m in metrics:
        total_load += m.get("num_ongoing_requests", 0)
        custom = m.get("autoscaling_metrics") or {}
        total_load += custom.get("queue_depth", 0)
        kv_max = max(kv_max, custom.get("kv_utilization", 0.0))
    desired = (
        -(-int(total_load) // max(int(cfg.target_ongoing_requests), 1))
        or cfg.min_replicas
    )
    if kv_max >= cfg.kv_utilization_threshold:
        desired = max(desired, current + 1)
    if any((a.get("labels") or {}).get("serve") == "upscale" for a in alerts):
        desired = max(desired, current + 1)
    return max(cfg.min_replicas, min(cfg.max_replicas, desired))


def _check_placeable(spec: DeploymentSpec) -> None:
    """Refuse a deployment whose replicas ask for a GPU when no node of the
    cluster has one (the head would fail every such replica at once)."""
    import ray_tpu_torch
    from ray_tpu_torch.exceptions import RayError

    gpus = float(spec.config.ray_actor_options.get("num_gpus") or 0)
    if gpus <= 0:
        return
    if ray_tpu_torch.cluster_resources().get("GPU", 0) <= 0:
        raise RayError(
            f"deployment {spec.name!r} asks for {{'GPU': {gpus:g}}} per replica, "
            "but no node of this cluster has a GPU (GPU: 0); a GPU replica is "
            "never run on the CPU instead"
        )


class _DeploymentState:
    def __init__(self, spec: DeploymentSpec):
        self.spec = spec
        self.replicas: list[ReplicaInfo] = []
        self.target_replicas = spec.config.num_replicas
        if spec.config.autoscaling_config:
            self.target_replicas = max(
                spec.config.autoscaling_config.min_replicas, 1
            )
        # downscale victims draining in-flight requests: (ReplicaInfo,
        # kill-deadline) — out of the routing set, not yet killed
        self.draining: list[tuple[ReplicaInfo, float]] = []
        # autoscaling bookkeeping
        self._scale_pressure_since: Optional[float] = None
        self._scale_direction = 0


class ServeController:
    def __init__(self):
        self._lock = threading.RLock()
        self._deployments: dict[str, _DeploymentState] = {}
        self._apps: dict[str, list[str]] = {}   # app -> deployment names
        self._ingress: dict[str, str] = {}      # app -> ingress deployment
        self._version = 0
        # long-poll push (reference: _private/long_poll.py LongPollHost):
        # routers park in poll_replicas on this condition and are woken by
        # every version bump — zero steady-state pulls
        self._version_cv = threading.Condition(self._lock)
        self.replica_pulls = 0  # get_replicas calls (tests assert no polling)
        self._proxy = None
        self._proxies: dict[str, tuple] = {}  # node_id hex -> (actor, port)
        self._proxy_req_port: Optional[int] = None
        self._grpc_proxy: Optional[tuple] = None  # (actor, port)
        # serializes _ensure_proxies: ensure_proxy (serve.run) racing the
        # reconcile thread once created TWO proxies for one node — the dict
        # overwrite dropped the first proxy's only handle, and the head
        # reaps handle-less actors, killing it mid-request
        self._proxy_mutex = threading.Lock()
        # firing-SLO-alert cache for the autoscale hook: the reconcile loop
        # runs every 0.25s and must not hammer the head's alert RPC
        self._alerts_cache: tuple[float, list] = (0.0, [])
        self._shutdown = False
        self._reconciler = threading.Thread(target=self._reconcile_loop, daemon=True)
        self._reconciler.start()

    def _bump_version_locked(self) -> None:
        self._version += 1
        self._version_cv.notify_all()

    # -- deploy API --------------------------------------------------------

    def deploy_application(self, app_name: str, specs: list[DeploymentSpec]) -> bool:
        """Set target state for an app (idempotent; re-deploy replaces)."""
        for spec in specs:
            _check_placeable(spec)
        with self._lock:
            old = self._apps.get(app_name, [])
            new_names = {s.name for s in specs}
            for name in old:
                if name not in new_names:
                    self._stop_deployment(name)
            self._apps[app_name] = [s.name for s in specs]
            for spec in specs:
                existing = self._deployments.get(spec.name)
                if existing is not None:
                    existing.spec = spec
                    if spec.config.autoscaling_config is None:
                        existing.target_replicas = spec.config.num_replicas
                    for r in existing.replicas:  # push new user_config live
                        if spec.config.user_config is not None:
                            r.actor.reconfigure.remote(spec.config.user_config)
                else:
                    self._deployments[spec.name] = _DeploymentState(spec)
                if spec.is_ingress:
                    self._ingress[app_name] = spec.name
            self._bump_version_locked()
        self._reconcile_once()
        return True

    def delete_application(self, app_name: str) -> bool:
        with self._lock:
            for name in self._apps.pop(app_name, []):
                self._stop_deployment(name)
            self._ingress.pop(app_name, None)
            self._bump_version_locked()
        return True

    def _stop_deployment(self, name: str):
        state = self._deployments.pop(name, None)
        if state is None:
            return
        import ray_tpu_torch

        # draining victims too: once the deployment is gone nothing else
        # would ever reap them (the reconcile loop only sees _deployments)
        victims = list(state.replicas) + [r for r, _ in state.draining]
        state.draining = []
        for r in victims:
            try:
                ray_tpu_torch.kill(r.actor)
            except Exception:  # raylint: disable=RL007
                pass  # best-effort teardown: the replica may already be dead

    # -- queries (handles / proxy / status) --------------------------------

    def get_replicas(self, deployment_name: str) -> tuple[int, list, int]:
        """(version, [actor handles], max_ongoing) — routers cache and
        re-pull on change; max_ongoing is the per-replica admission cap."""
        with self._lock:
            self.replica_pulls += 1
            return self._replicas_locked(deployment_name)

    def _replicas_locked(self, deployment_name: str) -> tuple[int, list, int]:
        state = self._deployments.get(deployment_name)
        if state is None:
            return self._version, [], 1
        return (
            self._version,
            # only initialized replicas route: a request queued on a replica
            # still loading its model would wait out the whole init inside
            # the actor's task queue
            [r.actor for r in state.replicas if r.healthy and r.initialized],
            max(state.spec.config.max_ongoing_requests, 1),
        )

    def poll_replicas(
        self, deployment_name: str, known_version: int, timeout: float = 25.0
    ) -> tuple[int, list, int]:
        """Long-poll push (reference: _private/long_poll.py): parks until
        the config version moves past ``known_version`` (or the timeout
        heartbeats), then returns the fresh replica set. Routers keep one
        of these outstanding instead of polling get_replicas — requires the
        controller actor's max_concurrency to cover the router count."""
        deadline = time.time() + timeout
        with self._lock:
            while self._version == known_version and not self._shutdown:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._version_cv.wait(remaining)
            return self._replicas_locked(deployment_name)

    def get_pull_count(self) -> int:
        return self.replica_pulls

    def get_stream_resume_arg(self, deployment_name: str) -> Optional[tuple]:
        """The deployment's mid-stream-failover contract —
        ``(stream_resume_arg, stream_deadline_arg)`` — or None when streams
        are not resumable. Routers cache this once per handle; it never
        changes for a deployed spec."""
        with self._lock:
            state = self._deployments.get(deployment_name)
            if state is None:
                return None
            cfg = state.spec.config
            if cfg.stream_resume_arg is None:
                return None
            return (cfg.stream_resume_arg, cfg.stream_deadline_arg)

    def get_replica_actor_ids(
        self, deployment_name: Optional[str] = None
    ) -> dict[str, list[str]]:
        """deployment -> [replica actor id hex, ...] for every (or one)
        deployment — the serve-plane chaos killer targets these."""
        with self._lock:
            out: dict[str, list[str]] = {}
            for name, state in self._deployments.items():
                if deployment_name is not None and name != deployment_name:
                    continue
                ids = []
                for r in state.replicas:
                    aid = getattr(r.actor, "_actor_id", None)
                    if aid is not None:
                        ids.append(aid.hex() if isinstance(aid, bytes) else str(aid))
                out[name] = ids
            return out

    def get_version(self) -> int:
        return self._version

    def get_ingress(self, app_name: str) -> Optional[str]:
        with self._lock:
            return self._ingress.get(app_name)

    def list_apps(self) -> dict:
        with self._lock:
            return {app: list(names) for app, names in self._apps.items()}

    def get_deployment_status(self, name: str) -> dict:
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                return {"exists": False}
            return {
                "exists": True,
                "target_replicas": state.target_replicas,
                "running_replicas": len([r for r in state.replicas if r.healthy]),
                "replica_ids": [r.replica_id for r in state.replicas],
            }

    def ready(self) -> bool:
        """True once every deployment has its target replica count healthy
        AND initialized (creation is async — counting replicas that are
        still running __init__ would return "ready" before a single
        request could be served)."""
        with self._lock:
            return all(
                len([r for r in s.replicas if r.healthy and r.initialized])
                >= s.target_replicas
                for s in self._deployments.values()
            )

    # -- HTTP proxy --------------------------------------------------------

    def ensure_proxy(self, port: int) -> int:
        """One ProxyActor per ALIVE node (reference: serve runs an HTTP
        proxy on every node; any proxy routes to any replica). The first
        node's proxy takes the requested port; the rest bind ephemeral
        ports (same-host test clusters can't share one). The reconcile loop
        keeps the set in sync as nodes come and go."""
        self._proxy_req_port = port
        self._ensure_proxies()
        with self._lock:
            ports = [p for _, p in self._proxies.values()]
            return ports[0] if ports else -1

    def _ensure_proxies(self) -> None:
        with self._proxy_mutex:
            self._ensure_proxies_serialized()

    def _ensure_proxies_serialized(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.serve._private.proxy import ProxyActor
        from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

        if self._proxy_req_port is None:
            return
        try:
            nodes = {n["NodeID"]: n for n in ray_tpu_torch.nodes() if n.get("Alive", True)}
        except Exception:
            return
        with self._lock:
            current = dict(self._proxies)
        # drop proxies on dead nodes
        for nid in list(current):
            if nid not in nodes:
                with self._lock:
                    self._proxies.pop(nid, None)
        # add proxies on new nodes
        for nid in nodes:
            if nid in current:
                continue
            want = self._proxy_req_port if not current and not self._proxies else 0
            cls = ray_tpu_torch.remote(num_cpus=0)(ProxyActor)
            try:
                actor = cls.options(
                    max_concurrency=128,
                    scheduling_strategy=NodeAffinitySchedulingStrategy(nid, soft=True),
                ).remote(want)
                p = ray_tpu_torch.get(actor.ready.remote(), timeout=60)
            except Exception as e:
                # the node may have died between listing and placement; the
                # next reconcile tick retries — but say so, a node that can
                # never host a proxy serves no traffic
                warn_throttled(f"serve controller: proxy start on {nid}", e)
                continue
            with self._lock:
                self._proxies[nid] = (actor, p)

    def get_proxy_port(self) -> Optional[int]:
        with self._lock:
            ports = [p for _, p in self._proxies.values()]
            return ports[0] if ports else None

    def ensure_grpc_proxy(self, port: int = 0) -> int:
        """ONE gRPC ingress for the cluster (reference runs a gRPC proxy
        beside each HTTP proxy; the lite design runs a single instance —
        gRPC clients hold long-lived channels, so per-node fan-out buys
        little on the pod-scale clusters this targets)."""
        import ray_tpu_torch
        from ray_tpu_torch.serve._private.grpc_proxy import GrpcProxyActor

        with self._proxy_mutex:
            if self._grpc_proxy is not None:
                return self._grpc_proxy[1]
            cls = ray_tpu_torch.remote(num_cpus=0)(GrpcProxyActor)
            actor = cls.options(max_concurrency=64).remote(port)
            p = ray_tpu_torch.get(actor.get_port.remote(), timeout=60)
            self._grpc_proxy = (actor, p)
            return p

    def get_grpc_proxy_port(self) -> Optional[int]:
        return self._grpc_proxy[1] if self._grpc_proxy is not None else None

    def get_proxy_ports(self) -> dict:
        """node_id hex -> port, one per alive node."""
        with self._lock:
            return {nid: p for nid, (_, p) in self._proxies.items()}

    def get_ingress_info(self, app_name: str) -> Optional[dict]:
        with self._lock:
            name = self._ingress.get(app_name)
            if name is None:
                return None
            state = self._deployments.get(name)
            return {
                "deployment": name,
                "streaming": bool(state and getattr(state.spec, "streaming", False)),
                "codec": getattr(
                    getattr(state.spec, "config", None), "grpc_codec", "bytes"
                )
                if state
                else "bytes",
            }

    # -- reconciliation ----------------------------------------------------

    def _reconcile_loop(self):
        while not self._shutdown:
            try:
                self._reconcile_once()
            except Exception as e:
                warn_throttled("serve controller: reconcile", e)
            try:
                self._ensure_proxies()  # nodes come and go; proxies follow
            except Exception as e:
                warn_throttled("serve controller: ensure proxies", e)
            time.sleep(RECONCILE_PERIOD_S)

    def _reconcile_once(self):
        import ray_tpu_torch

        with self._lock:
            states = list(self._deployments.values())
        for state in states:
            self._autoscale(state)
            with self._lock:
                spec = state.spec
                # health-check existing replicas. Replicas still running
                # __init__ (model load / jit warmup can take minutes) are
                # judged NON-BLOCKINGLY against their first check_health
                # call — pinging them with the steady-state timeout used to
                # mark every slow-init replica unhealthy and restart-loop
                # the deployment.
                for r in state.replicas:
                    if not r.initialized:
                        ready_refs, _ = ray_tpu_torch.wait([r.init_ref], timeout=0)
                        if ready_refs:
                            try:
                                ray_tpu_torch.get(r.init_ref, timeout=5.0)
                                r.initialized = True
                                _events.record(
                                    "serve.replica_initialized",
                                    replica=r.replica_id,
                                    init_s=round(time.time() - r.started_at, 3),
                                )
                                self._bump_version_locked()  # routers may now use it
                            except Exception as e:
                                r.healthy = False  # __init__ or first ping failed
                                _events.record(
                                    "serve.replica_unhealthy",
                                    replica=r.replica_id,
                                    reason=f"init_failed: {e!r}",
                                )
                        elif (
                            time.time() - r.started_at > REPLICA_INIT_TIMEOUT_S
                        ):
                            r.healthy = False  # wedged at init: replace it
                            _events.record(
                                "serve.replica_unhealthy",
                                replica=r.replica_id, reason="init_timeout",
                            )
                        continue
                    try:
                        ray_tpu_torch.get(r.actor.check_health.remote(), timeout=5.0)
                    except Exception as e:
                        r.healthy = False
                        _events.record(
                            "serve.replica_unhealthy",
                            replica=r.replica_id,
                            reason=f"health_check: {e!r}",
                        )
                dead = [r for r in state.replicas if not r.healthy]
                if dead:
                    state.replicas = [r for r in state.replicas if r.healthy]
                    self._bump_version_locked()
                # start missing
                missing = state.target_replicas - len(state.replicas)
                for _ in range(max(0, missing)):
                    self._start_replica(state)
                    self._bump_version_locked()
                # stop excess (highest-index first): GRACEFUL — the victim
                # leaves the routing set now (version bump pushes the new
                # replica list to routers), but is only killed once its
                # in-flight requests finish or the grace deadline passes
                # (reference: graceful_shutdown_timeout_s drain in
                # deployment_state.py)
                excess = len(state.replicas) - state.target_replicas
                for _ in range(max(0, excess)):
                    victim = state.replicas.pop()
                    deadline = (
                        time.time() + spec.config.graceful_shutdown_timeout_s
                    )
                    _events.record(
                        "serve.replica_draining", replica=victim.replica_id,
                        deployment=spec.name,
                    )
                    state.draining.append((victim, deadline))
                    self._bump_version_locked()
            self._process_draining(state)

    def _process_draining(self, state: _DeploymentState):
        """Kill draining victims whose in-flight count hit zero (or whose
        grace deadline passed / who stopped answering)."""
        import ray_tpu_torch

        with self._lock:
            draining = list(state.draining)
        still = []
        for victim, deadline in draining:
            done = time.time() >= deadline
            if not done:
                try:
                    m = ray_tpu_torch.get(victim.actor.get_metrics.remote(), timeout=5.0)
                    done = m["num_ongoing_requests"] <= 0
                except Exception:
                    done = True  # unreachable: nothing left to drain
            if done:
                _events.record(
                    "serve.replica_stopped", replica=victim.replica_id,
                )
                try:
                    ray_tpu_torch.kill(victim.actor)
                except Exception:  # raylint: disable=RL007
                    pass  # best-effort teardown: the replica may already be dead
            else:
                still.append((victim, deadline))
        with self._lock:
            state.draining = still

    def _start_replica(self, state: _DeploymentState):
        import ray_tpu_torch
        from ray_tpu_torch.serve._private.replica import Replica

        spec = state.spec
        rid = f"{spec.name}#{uuid.uuid4().hex[:6]}"
        cls = ray_tpu_torch.remote(Replica)
        opts = dict(spec.config.ray_actor_options)
        # +2 headroom threads so control-plane RPCs (health, metrics,
        # reconfigure) never starve behind a saturated request queue; the
        # router enforces the actual max_ongoing_requests admission limit.
        opts["max_concurrency"] = max(spec.config.max_ongoing_requests, 1) + 2
        actor = cls.options(**opts).remote(
            rid,
            spec.callable_factory,
            spec.init_args,
            spec.init_kwargs,
            spec.config.user_config,
        )
        _events.record(
            "serve.replica_starting", replica=rid, deployment=spec.name,
        )
        state.replicas.append(
            ReplicaInfo(
                replica_id=rid,
                actor=actor,
                started_at=time.time(),
                # queued behind __init__: resolves when the replica is
                # actually constructed — the reconcile loop polls it
                # non-blockingly to flip `initialized`
                init_ref=actor.check_health.remote(),
            )
        )

    # -- autoscaling -------------------------------------------------------

    _ALERTS_REFRESH_S = 5.0

    def _firing_alerts(self) -> list[dict]:
        """FIRING SLO alerts from the head's burn-rate engine, refreshed at
        most every few seconds (best-effort: no alerts beats no autoscale
        when the head is briefly unreachable)."""
        ts, cached = self._alerts_cache
        now = time.time()
        if now - ts < self._ALERTS_REFRESH_S:
            return cached
        firing: list[dict] = []
        try:
            from ray_tpu_torch._private.runtime import get_ctx

            firing = [
                a for a in get_ctx().call("alerts")
                if a.get("status") == "FIRING"
            ]
        except Exception as e:
            warn_throttled("serve controller: alert fetch", e)
        self._alerts_cache = (now, firing)
        return firing

    def _autoscale(self, state: _DeploymentState):
        import ray_tpu_torch

        cfg: Optional[AutoscalingConfig] = state.spec.config.autoscaling_config
        if cfg is None:
            return
        with self._lock:
            replicas = [r for r in state.replicas if r.healthy and r.initialized]
            current = state.target_replicas
        if not replicas:
            return
        metrics = []
        for r in replicas:
            try:
                metrics.append(
                    ray_tpu_torch.get(r.actor.get_metrics.remote(), timeout=5.0)
                )
            except Exception as e:
                # count an unreachable replica as zero load, but surface it:
                # persistently silent metrics skew autoscaling down
                warn_throttled("serve controller: replica metrics", e)
        desired = desired_replicas(
            cfg, metrics, current, alerts=tuple(self._firing_alerts())
        )
        now = time.time()
        with self._lock:
            current = state.target_replicas
            direction = (desired > current) - (desired < current)
            if direction == 0:
                state._scale_pressure_since = None
                state._scale_direction = 0
                return
            if state._scale_direction != direction:
                state._scale_direction = direction
                state._scale_pressure_since = now
                return
            delay = cfg.upscale_delay_s if direction > 0 else cfg.downscale_delay_s
            if now - (state._scale_pressure_since or now) >= delay:
                _events.record(
                    "serve.autoscale", deployment=state.spec.name,
                    from_replicas=current, to_replicas=desired,
                )
                state.target_replicas = desired
                state._scale_pressure_since = None
                state._scale_direction = 0

    # -- shutdown ----------------------------------------------------------

    def shutdown(self) -> bool:
        import ray_tpu_torch

        with self._lock:
            self._shutdown = True
            for app in list(self._apps):
                for name in self._apps[app]:
                    self._stop_deployment(name)
            self._apps.clear()
            proxies = list(self._proxies.values())
            self._proxies.clear()
            self._proxy_req_port = None
        for actor, _port in proxies:
            try:
                ray_tpu_torch.get(actor.stop.remote(), timeout=5)
            except Exception:  # raylint: disable=RL007
                pass  # best-effort teardown
            try:
                ray_tpu_torch.kill(actor)
            except Exception:  # raylint: disable=RL007
                pass  # best-effort teardown
        return True

    def check_health(self) -> bool:
        return True
