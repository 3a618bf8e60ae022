"""Runtime configuration flags.

TPU-native analogue of the reference's ``RAY_CONFIG(type, name, default)`` flag
system (``src/ray/common/ray_config_def.h`` — 218 flags, overridable via
``RAY_{name}`` env vars or a ``_system_config`` dict passed to ``ray.init``).

We keep the same three override tiers: compiled-in default < environment
variable ``RAY_TPU_{NAME}`` < explicit ``_system_config`` dict at ``init()``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


@dataclasses.dataclass
class Config:
    # -- object store ------------------------------------------------------
    #: Objects at or below this many serialized bytes live in the in-process
    #: store; larger ones go to a shared-memory segment (reference: core
    #: worker memory store promotes to plasma above ~100KB).
    max_direct_call_object_size: int = 100 * 1024
    #: Zero-copy data plane: a producer whose host has the native
    #: arena attached writes any value ABOVE this many serialized bytes into
    #: shared memory and ships only the locator over the control socket —
    #: payload bytes never transit the head. Below it, inlining wins (the
    #: locator + directory entry costs more than the bytes). Only applies
    #: when an arena is actually attached; without one the fallback cutoff
    #: is ``max_direct_call_object_size`` (a dedicated POSIX segment per
    #: mid-size object would pay shm_open+mmap+fault per put — a regression,
    #: not an optimisation). Set >= max_direct_call_object_size to restore
    #: the inline-only behavior.
    core_shm_inline_threshold: int = 8 * 1024
    #: Pipelined worker puts: ``ray.put`` from a worker ships
    #: fire-and-forget (seq-0, in-order on the conn) instead of blocking a
    #: round trip per object, so put bursts are bounded by head processing
    #: rather than N RTTs. ``False`` restores the blocking put (the
    #: BENCH_r09 "before" arm; ``ray://`` drivers always block — their
    #: reconnect window cannot detect a lost un-acked put).
    core_put_pipeline: bool = True
    #: Logical "memory" resource advertised by a node when ``ray.init`` is not
    #: given ``object_store_memory`` (reference: plasma store capacity).
    object_store_memory: int = 0  # 0 = auto (30% of system RAM)
    #: shm arena watermark: above this, least-recently-used unpinned objects
    #: spill to disk (reference: local_object_manager.h spill throttles).
    #: 0 = auto (object_store_memory, else 2 GiB).
    object_spilling_threshold_bytes: int = 0
    #: Size of the native shared-memory arena (the plasma-equivalent C++
    #: allocator in ``ray_tpu_torch/_native/arena.cc``) each head creates for its
    #: host. The segment is sparse — pages commit on first touch — so the
    #: default costs nothing until used. 0 disables the arena (every object
    #: gets a dedicated POSIX segment, the pure-Python fallback).
    object_store_arena_bytes: int = 4 * 1024 * 1024 * 1024
    #: Objects at or below this many serialized bytes are placed in the
    #: arena (one lock-protected pointer bump instead of a per-object
    #: shm_open+mmap+unlink syscall round-trip — and, critically for write
    #: throughput, arena pages are faulted once and then RECYCLED across
    #: objects, where a fresh POSIX segment pays a page fault + kernel zero
    #: per 4K on every put: ~1.6 GB/s faulting vs memcpy speed recycled).
    #: Larger objects use a dedicated segment whose mapping supports
    #: zero-copy reads for the lifetime of the value (arena reads copy out
    #: under a pin, so blocks can be recycled safely — see arena.cc
    #: pin/generation protocol).
    arena_max_object_bytes: int = 64 * 1024 * 1024

    #: Rebuild lost task-produced objects by resubmitting their creating
    #: task (reference: object_recovery_manager.h lineage reconstruction).
    enable_lineage_reconstruction: bool = True
    #: Total bytes of creating-task specs retained for reconstruction;
    #: beyond this the oldest objects silently lose reconstructability
    #: (reference: lineage total-size eviction in reference_count.h).
    max_lineage_bytes: int = 64 * 1024 * 1024
    #: Path for head-state snapshots (KV store, function table). Empty =
    #: no persistence. With a path set, a restarting head reloads the
    #: snapshot (reference: GCS Redis-backed table storage for HA).
    gcs_snapshot_path: str = ""
    #: Seconds between periodic snapshots (also written at shutdown).
    gcs_snapshot_interval_s: float = 10.0

    # -- scheduler ---------------------------------------------------------
    #: Hybrid scheduling policy: pack onto busiest feasible node until its
    #: critical-resource utilization exceeds this threshold, then prefer the
    #: least-utilized node (reference: hybrid_scheduling_policy.cc,
    #: ``scheduler_spread_threshold``).
    scheduler_spread_threshold: float = 0.5
    #: Max queued-but-infeasible warning interval.
    infeasible_warn_interval_s: float = 30.0

    # -- memory monitor ----------------------------------------------------
    #: Host memory usage fraction above which the OOM killer picks a victim
    #: worker (reference: memory_monitor.h usage threshold, default 0.95).
    memory_usage_threshold: float = 0.95
    #: Memory monitor sampling interval; 0 disables the monitor (the
    #: reference defaults to 250ms — conservative default here so co-tenant
    #: CI machines running hot don't see spurious kills; enable via
    #: _system_config or RAY_TPU env override).
    memory_monitor_refresh_ms: int = 0

    # -- workers -----------------------------------------------------------
    #: Idle (non-actor) workers are reaped by the health loop after this many
    #: seconds without a task, when nothing is queued (reference: worker_pool
    #: idle worker killing). 0 disables reaping.
    idle_worker_keep_alive_s: float = 60.0
    #: Default max_retries for normal tasks (reference:
    #: ``task_retry_delay_ms`` / default 3 retries).
    default_max_retries: int = 3
    #: A spawned worker process that has not registered with the head within
    #: this many seconds is killed and respawned (reference:
    #: ``worker_register_timeout_seconds``, ray_config_def.h) — turns an
    #: interpreter that wedges at startup into a logged hiccup instead of an
    #: indefinite hang of whatever is waiting on its task. 0 disables the
    #: kill/respawn (agent-side spawns that crash before connecting then
    #: fall back to a fixed 60s reap).
    worker_register_timeout_s: float = 30.0
    #: Max worker processes booting (spawned, not yet registered) per node
    #: at once; further spawns queue in the dispatcher. Interpreter boot is
    #: CPU-bound, so an unbounded spawn storm (e.g. 100 actor creations)
    #: makes EVERY boot exceed the registration timeout (reference:
    #: ``maximum_startup_concurrency`` ≈ num_cpus, ray_config_def.h).
    #: 0 = per-node CPU count (min 2).
    worker_startup_concurrency: int = 0
    #: How many times a registration-timed-out spawn is retried before the
    #: slot's work is failed (actor creation) or left to the scheduler
    #: (pool workers).
    worker_spawn_retries: int = 3
    #: Fork new workers from a per-node warm template process
    #: (worker_template.py) instead of cold interpreter boots: ~5-10ms per
    #: worker vs ~300ms+, the forkserver analog of the reference's
    #: pre-started worker pool (worker_pool.h:152). Containerised workers
    #: always cold-spawn. Disable to debug spawn-path issues.
    worker_forkserver_enabled: bool = True
    #: Comma-separated modules the forkserver template imports before it
    #: forks any worker (reference: ``preload_python_modules``), so every
    #: forked worker has them without paying their import: e.g.
    #: ``"torch,torch._dynamo"`` for GPU trial workers whose optimizer's
    #: first ``add_param_group`` imports ``torch._dynamo``. Nothing is
    #: initialised by an import (no CUDA context), so forks stay usable on a
    #: card. Empty: the template imports only the worker's own modules.
    #: ``init`` raises on a name it cannot find, and ``shutdown`` restores
    #: the value from before ``init``: a CPU cluster's workers stay free of
    #: torch unless that cluster asks for it.
    preload_python_modules: str = ""

    #: Pipeline up to this many plain tasks of identical scheduling
    #: signature onto one worker (followers ride the head task's resource
    #: lease; alloc transfers at completion). Hides the head<->worker
    #: round-trip entirely for small-task storms (reference:
    #: ``max_tasks_in_flight_per_worker``, direct task submitter). 1
    #: disables pipelining.
    max_tasks_in_flight_per_worker: int = 4

    #: Streaming-generator backpressure window: a producer pauses once this
    #: many yielded items are unconsumed (reference:
    #: ``_generator_backpressure_num_objects``). Consumer progress is pushed
    #: back to the worker as stream_ack messages.
    streaming_backpressure_items: int = 16

    # -- actors ------------------------------------------------------------
    default_max_restarts: int = 0
    default_max_task_retries: int = 0

    #: After a head crash/restart, node agents and detached-actor workers
    #: retry the head address this long before giving up (reference: the
    #: raylet reconnect window, ray_config_def.h:56-60
    #: ``gcs_rpc_server_reconnect_timeout_s``). The restarted head holds
    #: restored detached actors for the same window before re-creating
    #: them fresh.
    head_reconnect_grace_s: float = 30.0
    #: How long a disconnected ``ray://`` client session keeps its refs and
    #: actors alive waiting for a reconnect-with-token before the head
    #: releases them (reference: the client proxier's cleanup window,
    #: ``util/client/server/proxier.py``).
    client_reconnect_grace_s: float = 30.0

    # -- object data plane -------------------------------------------------
    #: Chunk size for node-to-node object transfers on the peer-to-peer
    #: data plane (reference: object_manager.h ``object_chunk_size``, 64MB
    #: there; smaller here because chunks also bound the sender's pin hold).
    object_transfer_chunk_bytes: int = 8 * 1024 * 1024
    #: A node that answered "I don't hold that object" is not re-asked for
    #: this long (reference: pull manager retry backoff) — bounds directory
    #: chatter while a producer is still writing.
    object_location_negative_cache_s: float = 5.0

    # -- collective --------------------------------------------------------
    #: Host-mediated allreduce switches from flat fan-in to the chunked
    #: ring algorithm at this tensor size (reference: collective group
    #: picks ring for large payloads).
    collective_ring_threshold_bytes: int = 1 << 22

    # -- health ------------------------------------------------------------
    #: Interval of the head's liveness sweep over worker processes
    #: (reference: GcsHealthCheckManager probing raylets).
    health_check_interval_s: float = 1.0
    #: Interval at which node agents push /proc-derived CPU/memory/disk
    #: stats to the head (reference: the per-node reporter agent's
    #: ``metrics_report_interval_ms``).
    node_stats_report_interval_s: float = 5.0

    # -- control-plane internals ------------------------------------------
    #: Backstop flush period of the head's outbound-message queue; normal
    #: sends flush immediately after the head lock releases — this poll
    #: bounds the tail when the enqueuing thread parks before flushing
    #: (enqueue deliberately never wakes the backstop; see _enqueue_send).
    outbox_flush_backstop_s: float = 0.05
    #: Task-event feed retention: when the in-memory feed exceeds this many
    #: records, the oldest half is dropped (reference:
    #: ``task_events_max_num_task_in_gcs``).
    task_events_max_entries: int = 100_000
    #: Pipelined submission (reference: lease-pipelined direct task
    #: submission + ``max_grpc_message_size`` batching): socket contexts
    #: buffer ``.remote()`` specs into one ``submit_batch`` message instead
    #: of paying a send+reply rendezvous per task. A buffer flushes at this
    #: many specs, before any other head RPC, or at the backstop below.
    core_submit_batch_max: int = 64
    #: Submit-window flow control: tasks allowed in un-acked submit windows
    #: before a flush blocks for acks (the head acks WINDOWS, not tasks).
    core_submit_window_tasks: int = 4096
    #: Backstop flush period for a fire-and-forget submit buffer whose
    #: owner never issues another head RPC (side-effect-only tasks).
    core_submit_flush_backstop_s: float = 0.005
    #: Worker completion coalescing: when the worker still has queued work,
    #: finished-task replies accumulate (drained off-path by the reply
    #: flusher thread) and ship as one ``tasks_done_batch``; an idle worker
    #: always ships inline. Caps one batch message.
    core_reply_batch_max: int = 64
    #: Driver-side dispatch coalescing: an in-process submit leaves its
    #: ``run_task`` in the head outbox unflushed until this many messages
    #: queue (or until any blocking call / the outbox backstop flushes), so
    #: an async submit burst ships as few ``run_task_batch`` socket writes.
    core_dispatch_coalesce: int = 16
    #: Hard cap on a submitted spec's total inline (by-value) argument
    #: bytes on the batched submit path; beyond it the task's refs resolve
    #: to an async error telling the caller to ``put()`` the argument.
    core_max_spec_inline_bytes: int = 8 * 1024 * 1024

    # -- serving / dashboards ---------------------------------------------
    #: Default port of ``serve.start`` HTTP ingress proxies (reference:
    #: serve's ``http_options.port``).
    serve_http_port: int = 8000
    #: Attempts per Serve handle call across replica failures before the
    #: error surfaces to the caller (reference: router retry policy).
    serve_handle_max_retries: int = 4
    #: Default port of ``ray_tpu_torch.dashboard.start`` (reference: 8265).
    dashboard_port: int = 8265

    # -- logging -----------------------------------------------------------
    log_to_driver: bool = True

    def apply_overrides(self, system_config: dict[str, Any] | None = None) -> None:
        for f in dataclasses.fields(self):
            env = os.environ.get(f"RAY_TPU_{f.name.upper()}")
            if env is not None:
                setattr(self, f.name, _coerce(env, f.type))
        for k, v in (system_config or {}).items():
            if not hasattr(self, k):
                raise ValueError(f"Unknown _system_config key: {k!r}")
            setattr(self, k, v)


def _coerce(raw: str, typ: Any) -> Any:
    typ = str(typ)
    if "bool" in typ:
        return raw.lower() in ("1", "true", "yes")
    if "int" in typ:
        return int(raw)
    if "float" in typ:
        return float(raw)
    return raw


GLOBAL_CONFIG = Config()
GLOBAL_CONFIG.apply_overrides()

_DEFAULTS = Config()


def config_overrides() -> dict[str, Any]:
    """The non-default fields of the live config — what a head ships to a
    joining node agent so the ``_system_config`` tier reaches remote
    agent/worker processes (reference: GCS serving system_config to
    raylets at registration)."""
    return {
        f.name: getattr(GLOBAL_CONFIG, f.name)
        for f in dataclasses.fields(GLOBAL_CONFIG)
        if getattr(GLOBAL_CONFIG, f.name) != getattr(_DEFAULTS, f.name)
    }


def apply_shipped(overrides: dict[str, Any]) -> None:
    """Apply head-shipped overrides in an agent process, LOSING to any
    explicit local env var (the operator set it on that host on purpose)."""
    for k, v in overrides.items():
        if hasattr(GLOBAL_CONFIG, k) and f"RAY_TPU_{k.upper()}" not in os.environ:
            setattr(GLOBAL_CONFIG, k, v)


# ---------------------------------------------------------------------------
# cluster auth (reference: the redis password / auth cookie the daemons share)
# ---------------------------------------------------------------------------

DEFAULT_AUTHKEY = b"ray-tpu-insecure-default"


def resolve_authkey() -> bytes:
    """Shared secret for the head's control-plane listeners. Set
    ``RAY_TPU_AUTHKEY`` (hex) on every host of a real deployment; the
    default only suits single-user/dev clusters (like the reference's
    default-open gRPC ports)."""
    import os

    raw = os.environ.get("RAY_TPU_AUTHKEY")
    return bytes.fromhex(raw) if raw else DEFAULT_AUTHKEY
