"""The head: control plane of a ray_tpu_torch "cluster".

The reference splits its control plane across three daemons — GCS (cluster
metadata, ``src/ray/gcs/gcs_server/gcs_server.cc:187``), per-node raylets
(scheduling + worker pools, ``src/ray/raylet/node_manager.cc``), and a plasma
store — talking gRPC. On a TPU pod the topology is static and every data-plane
byte that matters moves over ICI inside compiled XLA programs, so the
host-side control plane can be radically simpler: one Head object living in
the driver process, with worker processes attached over a unix socket.

It still implements the same *capabilities*, each tagged with its reference
counterpart:

* cluster membership + logical resources per node      (GcsNodeManager /
  ClusterResourceManager)
* hybrid pack/spread scheduling, spread + node-affinity + placement-group
  strategies                                           (cluster_task_manager.cc,
  scheduling/policy/*)
* worker pools with on-demand spawn + idle reuse       (worker_pool.h:152)
* dependency-gated dispatch                            (dependency_manager.h)
* object directory w/ inline + shm locations, waiters  (memory_store +
  plasma + ownership directory)
* task retries, worker-crash detection, actor restart
  state machine, named/detached actors                 (task_manager.cc,
  gcs_actor_manager.cc, gcs_health_check_manager.h)
* placement groups PACK/SPREAD/STRICT_*                (gcs_placement_group_*)
* function table, KV store                             (GCS internal KV)

Multi-"node" test clusters add virtual nodes to the same Head
(cluster_utils.Cluster mirrors the reference's ``cluster_utils.py:108``).
"""

from __future__ import annotations

import itertools
import os
import queue
import socket
import threading
import time
from collections import deque
from typing import Any, Optional

from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private import events
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private import config as _cfg
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.proc_handles import ForkedProc, TemplateProc, spawn_template
from ray_tpu_torch._private.ids import ActorID, NodeID, ObjectID, PlacementGroupID, TaskID
from ray_tpu_torch._private.log_util import warn_throttled
from ray_tpu_torch._private.shm_store import ShmLocation, ShmOwner
from ray_tpu_torch.util import waterfall as _waterfall

#: raylint RL012 registry — batch-plane telemetry the head folds:
#: one observation per submit window / reply batch, documented in
#: OBSERVABILITY.md beside the waterfall legs they shrink; plus the
#: locality-aware scheduler: fraction of ref-arg task placements
#: that landed on a node already holding the args' bytes
METRIC_NAMES = (
    "core_submit_batch_size",
    "core_reply_batch_size",
    "core_sched_locality_hit_rate",
    # object-plane ledger: per-node arena/spill residency, the
    # leak-audit verdict, object lifetime distribution, and spill churn
    "core_arena_used_bytes",
    "core_arena_capacity_bytes",
    "core_arena_pinned_bytes",
    "core_arena_occupancy",
    "core_spill_bytes",
    "core_object_leaks",
    "core_object_age_s",
    "core_object_spills",
)

#: flight-recorder events this module emits (raylint RL012 registry) — the
#: directory half of the ``core.object.*`` lifecycle family:
#: a driver put landing in head shm, a locator entering the directory,
#: spill/restore transitions, a backing reaped by loss handling, and a
#: directory entry freed (forensic tail also kept in ``_freed_ring``).
EVENT_NAMES = (
    "core.object.put",
    "core.object.locator",
    "core.object.spill",
    "core.object.restore",
    "core.object.reap",
    "core.object.free",
)

#: raylint RL017 registry — DELIBERATE lock-free shared state, verified by
#: the linter (':atomic' = every write is one GIL-atomic operation; see
#: LINTING.md "thread/ownership model"). Each entry is a design decision:
#:
#: - _io_conns: conn -> (handle, remote) registered by conn threads with a
#:   plain dict store and reaped by the selector owner; readers take an
#:   atomic dict() snapshot and re-sync off the generation counter — a
#:   lock here would put every worker registration in the pump corridor.
#: - _outbox: deque of worker-bound sends, appended under the head lock,
#:   drained by the single _flush_lock holder; deque append/popleft are
#:   GIL-atomic, which is exactly why the outbox is a deque.
#: - ClientSession.refs/.actors: written only by the session's OWN conn
#:   thread while connected (one thread per client conn — _session_track
#:   docstring); the health loop's expiry sweep runs only after the grace
#:   window, when that conn thread is gone.
LOCKFREE = (
    "Head._io_conns: atomic",
    "Head._outbox: atomic",
    "ClientSession.refs: atomic",
    "ClientSession.actors: atomic",
)

#: Canonical lock order of the head IO-drain plane,
#: outermost first — RL010 checks every acquisition edge against it.
#: ``_pump_mutex`` sits outside everything: whoever owns the pump (the IO
#: thread or a pumping getter) dispatches worker messages that take the
#: head lock; the reverse never happens (getters PARK the pump request
#: counter, they do not acquire the pump mutex under the head lock, and
#: the IO thread's own acquire is bounded). ``_flush_lock`` serializes the
#: single outbox drainer, which then takes per-worker send locks; the
#: head lock is never held across a flush's socket writes (the earlier
#: tasks/s ceiling this architecture removed).
LOCK_ORDER = (
    "Head._pump_mutex",        # pump ownership (IO thread / pumping getter)
    "Head.lock",               # cluster state critical section
    "Head._flush_lock",        # single active outbox drainer
    "WorkerHandle.send_lock",  # one writer per worker conn
    "ShmOwner._lock",          # object-store ledger; never calls back up
)

_BATCH_BOUNDARIES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
_BATCH_METRICS = None
_BATCH_METRICS_LOCK = threading.Lock()


def _batch_metrics() -> dict:
    global _BATCH_METRICS
    if _BATCH_METRICS is not None:
        return _BATCH_METRICS
    with _BATCH_METRICS_LOCK:
        if _BATCH_METRICS is None:
            from ray_tpu_torch.util.metrics import Histogram

            _BATCH_METRICS = {
                "submit": Histogram(
                    "core_submit_batch_size",
                    "tasks per pipelined submit window received by the head",
                    boundaries=_BATCH_BOUNDARIES,
                ),
                "reply": Histogram(
                    "core_reply_batch_size",
                    "completions per coalesced worker reply message",
                    boundaries=_BATCH_BOUNDARIES,
                ),
            }
    return _BATCH_METRICS


_LOCALITY_GAUGE = None


def _locality_gauge():
    # no init lock needed: only ever touched under the head lock (_pick_node)
    global _LOCALITY_GAUGE
    if _LOCALITY_GAUGE is None:
        from ray_tpu_torch.util.metrics import Gauge

        _LOCALITY_GAUGE = Gauge(
            "core_sched_locality_hit_rate",
            "fraction of ref-arg task placements that landed on a node "
            "already holding the args' shm bytes",
        )
    return _LOCALITY_GAUGE


#: object age buckets: sub-minute churn through multi-hour residents
_OBJECT_AGE_BOUNDARIES = (1, 5, 15, 60, 300, 900, 3600, 14400)
_OBJECT_METRICS = None


def _object_metrics() -> dict:
    # no init lock needed: only ever touched under the head lock (health
    # loop tick, spill path, ledger/audit RPCs)
    global _OBJECT_METRICS
    if _OBJECT_METRICS is None:
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        _OBJECT_METRICS = {
            "arena_used": Gauge(
                "core_arena_used_bytes",
                "bytes allocated in a node's native object arena",
                tag_keys=("node",),
            ),
            "arena_capacity": Gauge(
                "core_arena_capacity_bytes",
                "a node's native object arena capacity",
                tag_keys=("node",),
            ),
            "arena_pinned": Gauge(
                "core_arena_pinned_bytes",
                "arena bytes currently pinned by live readers on a node",
                tag_keys=("node",),
            ),
            "arena_occupancy": Gauge(
                "core_arena_occupancy",
                "worst-node arena used/capacity ratio (the arena-pressure "
                "SLO gauge)",
            ),
            "spill_bytes": Gauge(
                "core_spill_bytes",
                "bytes of directory objects currently spilled to a node's "
                "disk",
                tag_keys=("node",),
            ),
            "leaks": Gauge(
                "core_object_leaks",
                "findings of the last object-plane leak audit (orphaned "
                "arena bytes / stale pins / dangling locators / orphaned "
                "spill files)",
            ),
            "age": Histogram(
                "core_object_age_s",
                "lifetime of directory objects at free/evict",
                boundaries=_OBJECT_AGE_BOUNDARIES,
            ),
            "spills": Counter(
                "core_object_spills",
                "directory objects spilled to disk under arena pressure "
                "(the spill-burn SLO counter)",
            ),
        }
    return _OBJECT_METRICS


# --------------------------------------------------------------------------
# Object directory


class ObjectEntry:
    __slots__ = (
        "small", "shm", "is_error", "refcount", "pins", "size",
        "spill_path", "last_access", "last_read", "borrow_nonces", "lineage",
        "created",
    )

    def __init__(self):
        self.small: Optional[bytes] = None
        self.shm: Optional[ShmLocation] = None
        self.is_error = False
        self.refcount = 0  # driver-side ObjectRef count
        self.pins = 0  # pending-task dependency pins
        self.size = 0
        self.created = time.time()  # wall time: ledger ages are user-facing
        self.spill_path: Optional[str] = None  # on-disk copy (spilled)
        self.last_access = 0.0
        self.last_read = 0.0  # read lease: guards just-handed-out locators
        # in-transit borrow nonces: a serialized ref holds one count until
        # the (first) deserializer claims it (reference: borrower registration
        # in core_worker/reference_count.h:61)
        self.borrow_nonces: Optional[set] = None
        # creating-task spec for lineage reconstruction (reference:
        # object_recovery_manager.h:41 rebuilds lost objects by resubmitting
        # the task; task_manager.cc lineage). None for ray.put objects.
        self.lineage: Optional[dict] = None

    @property
    def ready(self) -> bool:
        return self.small is not None or self.shm is not None or self.spill_path is not None

    def locator(self):
        if self.small is not None:
            return ("inline", self.small, self.is_error)
        return ("shm", self.shm, self.is_error)


# --------------------------------------------------------------------------
# Nodes / workers


class _WorkerProc:
    """Subprocess handle with the process API the head expects
    (pid / is_alive / terminate / join)."""

    __slots__ = ("popen", "pid")

    def __init__(self, popen):
        self.popen = popen
        self.pid = popen.pid

    def is_alive(self) -> bool:
        return self.popen.poll() is None

    def terminate(self):
        try:
            self.popen.terminate()
        except OSError:
            pass

    def join(self, timeout=None):
        try:
            self.popen.wait(timeout=timeout)
        except Exception:
            pass


# forkserver process handles (ForkedProc / TemplateProc / spawn_template)
# live in proc_handles.py — shared with node_agent for remote hosts


class WorkerHandle:
    """A connected worker process (reference: raylet's WorkerInterface)."""

    _ids = itertools.count()

    def __init__(self, node: "NodeState", proc, conn=None):
        self.wid = next(WorkerHandle._ids)
        self.node = node
        self.proc = proc  # _WorkerProc (None for remote workers)
        self.conn = conn  # set at registration
        self.alive = True
        self.current_task: Optional[dict] = None
        # FIFO of dispatched-but-not-done task recs (the worker executes in
        # order; current_task mirrors the head). More than one entry means
        # the worker is PIPELINED: followers ride the head task's resource
        # lease and the alloc transfers down the chain at each completion
        # (reference: lease-based pipelined submission,
        # max_tasks_in_flight_per_worker in the direct task submitter).
        self.queued_recs: deque = deque()
        # (signature, func_id) the current pipeline accepts; None = worker
        # not leaseable (mixed queue, strategy task, or empty)
        self.lease_sig: Optional[tuple] = None
        # in-flight blocking get/wait RPCs from this worker: a worker parked
        # in ray.get must not receive lease followers (nested-submit deadlock)
        self.blocked_gets = 0
        self.actor_id: Optional[bytes] = None
        self.idle_since = time.monotonic()
        self.created_at = time.monotonic()
        self.send_lock = threading.Lock()
        # startup token: matches a spawned process to its pre-created handle
        # at registration (reference: worker_pool.h startup_token) — the only
        # correlation that works for workers spawned on REMOTE hosts, where
        # the head never sees a pid
        self.token: Optional[str] = None
        # spawned via the node's forkserver template: the pid (unknown until
        # registration) becomes a ForkedProc so kill/join paths work
        self.forked = False
        # which attempt of a spawn chain this handle is (0 = first); bounds
        # registration-timeout respawns (reference: worker_register_timeout_seconds)
        self.spawn_attempts = 0
        # spec-header ids this worker already holds (cheaper per-task bytes:
        # flush_outbox ships a function's static spec fields once per
        # worker, steady-state run_task bodies reference them by id). Only
        # the single active flush_outbox drainer mutates this.
        self.sent_hdrs: set = set()
        # spec headers THIS worker's submit_batch messages defined (the
        # submitter side of the same split, keyed per connection)
        self.submit_hdrs: dict = {}

    def send(self, msg) -> bool:
        try:
            with self.send_lock:
                ser.conn_send(self.conn, msg)
            return True
        except (OSError, ValueError, BrokenPipeError):
            return False


class AgentHandle:
    """Connection to a remote node's agent daemon (spawns workers there)."""

    def __init__(self, conn):
        self.conn = conn
        self.send_lock = threading.Lock()

    def send(self, msg) -> bool:
        try:
            with self.send_lock:
                self.conn.send(msg)
            return True
        except (OSError, ValueError, BrokenPipeError):
            return False


def _close_listener(listener) -> None:
    """Close an mp.connection Listener so its PORT is actually released.

    ``Listener.close()`` alone leaves the socket listening while another
    thread is blocked in ``accept()`` (the in-flight syscall pins the
    socket), so a restarted head could never rebind the address. A
    ``shutdown(SHUT_RDWR)`` first wakes the accepter, then close releases
    the fd."""
    import socket as _socket

    try:
        sock = listener._listener._socket
        sock.shutdown(_socket.SHUT_RDWR)
    except (OSError, AttributeError):
        pass
    try:
        listener.close()
    except Exception:
        pass


class NodeState:
    def __init__(self, node_id: NodeID, resources: dict[str, float], labels=None):
        self.node_id = node_id
        self.created_at = time.monotonic()
        self.agent: Optional[AgentHandle] = None  # set for remote nodes
        self.resources_total = dict(resources)
        self.resources_avail = dict(resources)
        self.labels = labels or {}
        self.alive = True
        self.dispatching = 0  # spawns handed to a thread, handle not yet visible
        # (host, port) of the node's data-plane server (agent nodes only;
        # head-host nodes are served by the head's own DataServer)
        self.data_address: Optional[tuple] = None
        # latest /proc sample for this node's host (reporter.node_stats)
        self.stats: dict = {}
        self.idle_workers: list[WorkerHandle] = []
        self.all_workers: set[WorkerHandle] = set()
        self.spawning = 0
        # forkserver template for this node (head-host nodes only; agent
        # hosts run their own template) — see worker_template.py
        self.template: Optional[TemplateProc] = None
        self.assigned: deque = deque()  # tasks waiting for a worker on this node
        # placement-group reservations: pg_id -> bundle_index -> avail dict
        self.pg_reserved: dict[bytes, dict[int, dict[str, float]]] = {}

    def can_fit(self, res: dict[str, float]) -> bool:
        return all(self.resources_avail.get(k, 0.0) + 1e-9 >= v for k, v in res.items() if v > 0)

    def allocate(self, res: dict[str, float]) -> None:
        for k, v in res.items():
            self.resources_avail[k] = self.resources_avail.get(k, 0.0) - v

    def release(self, res: dict[str, float]) -> None:
        for k, v in res.items():
            self.resources_avail[k] = min(
                self.resources_avail.get(k, 0.0) + v, self.resources_total.get(k, 0.0)
            )

    def utilization(self, res: dict[str, float]) -> float:
        """Max utilization over the resources this task needs (reference:
        hybrid policy's critical-resource utilization)."""
        u = 0.0
        for k, v in res.items():
            if v <= 0:
                continue
            total = self.resources_total.get(k, 0.0)
            if total <= 0:
                return 1.0
            u = max(u, 1.0 - (self.resources_avail.get(k, 0.0) - v) / total)
        return u


# --------------------------------------------------------------------------
# Actors


ACTOR_PENDING, ACTOR_RESTARTING, ACTOR_ALIVE, ACTOR_DEAD = range(4)


class ActorState:
    def __init__(self, actor_id: bytes, create_spec: dict):
        self.actor_id = actor_id
        self.create_spec = create_spec
        self.state = ACTOR_PENDING
        self.worker: Optional[WorkerHandle] = None
        self.node_id: Optional[NodeID] = None
        self.restarts_left = create_spec.get("max_restarts", 0)
        self.max_task_retries = create_spec.get("max_task_retries", 0)
        self.name = create_spec.get("name")
        # named actors are NAMESPACE-scoped (reference: ray namespaces —
        # each ray:// client session gets an anonymous namespace unless it
        # asks for one, so concurrent clients don't see each other's names)
        self.namespace = create_spec.get("namespace") or "default"
        self.detached = create_spec.get("lifetime") == "detached"
        self.pending_calls: deque = deque()  # method specs queued while not ALIVE
        self.inflight: dict[bytes, dict] = {}  # task_id -> spec sent to worker
        self.num_handles = 1
        self.death_cause: Optional[str] = None
        self.alloc = None  # lifetime resource allocation (held until death)

    @property
    def named_key(self) -> Optional[str]:
        return None if not self.name else f"{self.namespace}:{self.name}"


class ClientSession:
    """One ``ray://`` client's server-side state (reference: the client
    proxier's per-client SpecificServer, ``util/client/server/proxier.py``).
    Tracks what the client owns so a disconnect without reconnect releases
    it: object refcounts taken on the client's behalf and actors it created.
    ``disconnected_at`` arms the grace timer; a reconnect presenting the
    session token disarms it and resumes with every ref intact."""

    def __init__(self, token: str, namespace: str):
        self.token = token
        self.namespace = namespace
        self.refs: dict[bytes, int] = {}
        self.actors: set[bytes] = set()
        self.conn = None
        self.disconnected_at: Optional[float] = None
        self.created_at = time.monotonic()
        # spec headers this client's submit_batch messages defined (survives
        # a reconnect-with-token: the client's header ids stay valid)
        self.submit_hdrs: dict = {}


# --------------------------------------------------------------------------
# Placement groups

PG_PENDING, PG_CREATED, PG_REMOVED = range(3)


class PlacementGroupState:
    def __init__(self, pg_id: bytes, bundles: list[dict], strategy: str, name: str = ""):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.state = PG_PENDING
        self.bundle_nodes: list[Optional[NodeID]] = [None] * len(bundles)
        self.ready_event = threading.Event()


# --------------------------------------------------------------------------


class _PendingQueue:
    """Dep-free tasks awaiting a node, grouped by scheduling signature.

    The earlier scheduler kept one deque and rescanned it IN FULL on every
    submit and every completion — O(queue) per event, O(n²) across a burst,
    and the direct reason async task submission benchmarked SLOWER than
    sync round-trips. Tasks with identical (resources, strategy, labels)
    are interchangeable for placement, so they share one FIFO bucket and a
    scheduling pass visits each DISTINCT signature once: a 10k-deep
    homogeneous backlog costs one placement attempt per event, not 10k
    (reference: raylet groups tasks into scheduling classes the same way —
    SchedulingClass, common/task/task_spec.h).

    FIFO order holds within a signature; across signatures dispatch is
    round-robin (the reference makes no global-FIFO promise either).
    """

    def __init__(self):
        self._buckets: dict[tuple, deque] = {}
        self._order: list[tuple] = []
        self._len = 0
        # sig -> scheduling generation at which placement last failed: a
        # pass skips sigs that already failed in the CURRENT generation
        # (nothing freed since, so the answer cannot have changed) — this
        # makes submit-into-a-saturated-cluster O(1) instead of one doomed
        # placement probe per submit
        self._blocked: dict[tuple, int] = {}

    @staticmethod
    def _sig(spec: dict) -> tuple:
        sig = spec.get("_sig0")
        if sig is not None:
            return sig  # template-cached (resources/strategy are static)
        res = spec.get("resources") or {}
        strat = spec.get("strategy")
        lbl = spec.get("label_selector")
        return (
            tuple(sorted((k, v) for k, v in res.items() if v != 0)),
            tuple(strat) if strat else None,
            tuple(sorted(lbl.items())) if lbl else None,
            spec.get("kind") == "actor_create",
        )

    @staticmethod
    def sig_of(rec: dict) -> tuple:
        sig = rec.get("_sig")
        if sig is None:
            sig = rec["_sig"] = _PendingQueue._sig(rec["spec"])
        return sig

    def append(self, rec: dict) -> None:
        sig = self.sig_of(rec)
        q = self._buckets.get(sig)
        if q is None:
            q = self._buckets[sig] = deque()
            self._order.append(sig)
        q.append(rec)
        self._len += 1

    def schedule_pass(self, try_place, gen: int = -1) -> None:
        """``try_place(rec) -> bool``: True consumes the head of a bucket
        (placed, or dropped as cancelled); False blocks that signature until
        the scheduling generation advances (resources freed / nodes
        changed)."""
        for sig in list(self._order):
            if self._blocked.get(sig) == gen:
                continue
            q = self._buckets.get(sig)
            blocked = False
            while q:
                if try_place(q[0]):
                    q.popleft()
                    self._len -= 1
                else:
                    self._blocked[sig] = gen
                    blocked = True
                    break
            if not blocked:
                self._blocked.pop(sig, None)
            if not q:
                del self._buckets[sig]
                self._order.remove(sig)
                self._blocked.pop(sig, None)

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self):
        for sig in self._order:
            yield from self._buckets.get(sig, ())


class _DaemonPool:
    """Cached pool of DAEMON threads for blocking RPCs.

    ThreadPoolExecutor is unsuitable here: its non-daemon workers are joined
    at interpreter exit, so one ``get``/``wait``/``pg_ready`` parked forever
    (timeout=None on something never produced) would hang process exit —
    the per-call threads this replaces were daemons for exactly that reason.
    Threads spawn on demand up to ``max_workers``, reap after 30s idle, and
    print handler crashes (a submitted-and-forgotten Future would swallow
    them)."""

    _IDLE_REAP_S = 30.0

    def __init__(self, max_workers: int, name: str):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._threads = 0
        self._idle = 0
        # Items put but not yet claimed by a worker (claimed = the worker has
        # taken the lock after q.get returned). Spawning on
        # ``unclaimed > idle`` instead of ``idle == 0`` closes the window
        # where a worker has returned from q.get but not yet decremented
        # _idle: counting that item as still-unclaimed forces a spawn, so a
        # handler that then parks forever cannot strand the queued item.
        self._unclaimed = 0
        self._max = max_workers
        self._name = name

    def submit(self, fn, *args) -> None:
        with self._lock:
            self._unclaimed += 1
            self._q.put((fn, args))
            if self._unclaimed > self._idle and self._threads < self._max:
                self._threads += 1
                threading.Thread(target=self._run, name=self._name, daemon=True).start()

    def _run(self) -> None:
        import traceback as _tb

        while True:
            with self._lock:
                self._idle += 1
            try:
                item = self._q.get(timeout=self._IDLE_REAP_S)
            except queue.Empty:
                with self._lock:
                    self._idle -= 1
                    # a put may have raced the timeout: keep serving if work
                    # arrived (the lock orders this against submit's check).
                    # The loop top re-increments _idle — do NOT add it back
                    # here or the thread is counted idle twice forever.
                    if self._unclaimed > 0:
                        continue
                    self._threads -= 1
                return
            with self._lock:
                self._idle -= 1
                if item is not None:
                    self._unclaimed -= 1
                else:
                    self._threads -= 1
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 - must never kill the pool thread
                _tb.print_exc()

    def shutdown(self) -> None:
        with self._lock:
            n = self._threads
        for _ in range(n):
            self._q.put(None)


class Head:
    def __init__(self, socket_path: str, authkey: bytes):
        self.lock = threading.RLock()
        self.cv = threading.Condition(self.lock)  # object readiness + pg + actor events
        self.socket_path = socket_path
        self.authkey = authkey
        self.shm_owner = ShmOwner()
        self._snapshot_path = GLOBAL_CONFIG.gcs_snapshot_path or None
        # Native object arena (plasma equivalent, ray_tpu_torch/_native/arena.cc):
        # one shared segment for this host's small/medium objects. None when
        # disabled or the native build is unavailable (pure-Python fallback:
        # a dedicated segment per object).
        self.arena_name: Optional[str] = None
        if GLOBAL_CONFIG.object_store_arena_bytes > 0:
            from ray_tpu_torch._private import shm_store as _shm

            self.arena_name = _shm.create_arena(GLOBAL_CONFIG.object_store_arena_bytes)

        self.objects: dict[bytes, ObjectEntry] = {}
        # forensic tail of the object ledger: the newest freed
        # entries — (oid hex, size, age_s, freed wall time, reason) — so
        # ``obs objects`` can show what JUST left the directory. Appended
        # under the head lock; bounded.
        self._freed_ring: deque = deque(maxlen=256)
        self.functions: dict[bytes, bytes] = {}  # func table (reference: GCS fn table)
        self.kv: dict[str, bytes] = {}
        # pubsub: channel -> sinks; a sink is ("conn", conn) for socket
        # clients or ("fn", callable) for in-process subscribers (reference:
        # src/ray/pubsub/ long-poll channels, GCS actor/node update feeds)
        self._subs: dict[str, list] = {}
        self._pub_locks: dict[int, threading.Lock] = {}
        self._pub_queue: "queue.Queue" = queue.Queue()
        # cap >> any realistic concurrent-blocking-RPC count; parked gets
        # hold a thread each, so the cap must stay generous (a too-small
        # pool would queue NEW gets behind parked ones)
        self._blocking_pool = _DaemonPool(4096, "head-rpc")
        # worker-spawn dispatch: Thread.start() must NEVER run under the head
        # lock — start() blocks until the child's bootstrap sets _started, and
        # a GC tick in that bootstrap window used to re-enter the head lock
        # via ObjectRef.__del__, wedging the whole head. Spawn requests are
        # queued here and started by a dedicated dispatcher thread instead.
        self._spawn_q: "queue.SimpleQueue" = queue.SimpleQueue()
        threading.Thread(
            target=self._spawn_dispatch_loop, name="spawn-dispatch", daemon=True
        ).start()
        self._snapshot_due = 0.0
        # detached actors restored from a snapshot, waiting for their old
        # worker to reconnect; past the grace window they re-create fresh
        self._restored_actors: set[bytes] = set()
        self._restore_time = time.monotonic()
        self._lineage_fifo: deque = deque()
        self._lineage_total = 0
        self.nodes: dict[bytes, NodeState] = {}
        self.node_order: list[bytes] = []
        self.actors: dict[bytes, ActorState] = {}
        # named actors, keyed "namespace:name" (see ActorState.named_key)
        self.named_actors: dict[str, bytes] = {}
        # cluster-wide named mutexes: name -> (owner_token, lease_expiry)
        self._named_mutexes: dict[str, tuple] = {}
        # ray:// client sessions by token (ClientSession); cleanup of a
        # disconnected session happens in the health loop after the grace
        self.client_sessions: dict[str, ClientSession] = {}
        self.placement_groups: dict[bytes, PlacementGroupState] = {}
        if self._snapshot_path:
            self._load_snapshot()  # after the tables above exist

        # tasks waiting on deps: obj_id -> set of task records
        self.dep_waiters: dict[bytes, set] = {}
        # dispatch outbox: worker-bound messages enqueued under the head
        # lock, flushed by the enqueuing caller right after it releases it
        # (see flush_outbox) — a socket write + spec pickle inside the
        # critical section would serialize every conn thread behind each
        # dispatch (the old tasks/s ceiling)
        self._outbox: deque = deque()
        self._flush_lock = threading.Lock()
        self._flush_event = threading.Event()
        # selector-served worker connections: conn -> (WorkerHandle, remote)
        self._io_conns: dict = {}
        # bumped on every _io_conns mutation: drain callers re-sync their
        # selector only when this moved (the dict snapshot + key compare
        # were ~1.5us per pump — per sync task — with a stable conn set).
        # Bumps draw from an itertools.count and PUBLISH with a plain
        # store: two conns adopted/reaped concurrently (a registration
        # burst racing a reap) each land a DISTINCT generation, where the
        # old `+= 1` read-modify-write could collapse both bumps into one
        # value (found by raylint RL017)
        self._io_gen_src = itertools.count(1)
        self._io_conns_gen = 0
        # per-conn buffered framed readers (ser.ConnReader): one kernel
        # read per drain round instead of two syscalls per message; owned
        # by whoever holds _pump_mutex, reaped with the conn
        self._io_readers: dict = {}
        self._io_thread: Optional[threading.Thread] = None
        # worker-conn pump ownership (see _pump_or_wait): a blocked getter
        # may take over the IO thread's job so a completion wakes the getter
        # DIRECTLY instead of via IO-thread-handles-then-notifies — one
        # fewer thread handoff on the sync task round trip
        self._pump_mutex = threading.Lock()
        self._pump_count_lock = threading.Lock()
        self._pump_requests = 0
        self._last_pump = 0.0  # sticky grace: IO thread defers while fresh
        self._io_resume = threading.Event()
        self._io_wake_r, self._io_wake_w = os.pipe()
        os.set_blocking(self._io_wake_w, False)
        # progress signal TO pumpers: whoever processed worker messages
        # while getters were waiting writes here, so a pumper whose object
        # became ready in the handoff window doesn't sit out its select
        # timeout against conns that will stay silent
        self._io_prog_r, self._io_prog_w = os.pipe()
        os.set_blocking(self._io_prog_w, False)
        # persistent selector for pumpers (guarded by _pump_mutex):
        # multiprocessing.connection.wait builds+tears down a poll object
        # per call — real money at 1 call per sync task
        import selectors as _selectors

        self._pump_sel = _selectors.DefaultSelector()
        self._pump_sel.register(self._io_prog_r, _selectors.EVENT_READ)
        self._pump_registered: set = set()
        self._pump_reg_gen = [-1]  # _io_conns generation the pump last synced
        self.pending_sched = _PendingQueue()  # dep-free tasks awaiting node pick
        # bumped whenever placement capacity can have INCREASED (release,
        # node add, pg placement): lets _schedule skip signatures that
        # already failed in the current generation
        self._sched_gen = 0
        # locality-aware placement accounting: of the placements
        # whose ref args had bytes resident on some node, how many landed on
        # a byte-holding node (feeds core_sched_locality_hit_rate)
        self._loc_hits = 0
        self._loc_total = 0
        # actor_id -> actor_create rec awaiting its dedicated worker
        self._actor_create_recs: dict[bytes, dict] = {}
        self.tasks: dict[bytes, dict] = {}  # task_id -> record (pending/running)
        self.cancelled: set[bytes] = set()

        self._shutdown = False
        self._listener = None
        self._tcp_listener = None
        self.tcp_address: Optional[tuple] = None
        # data plane (peer-to-peer bulk object transfer, data_plane.py):
        # started alongside the TCP control plane; the head then acts as the
        # object DIRECTORY only — bytes move host-to-host directly
        # (reference: object_manager.h:117 + gcs object locations)
        self.data_server = None
        self.data_port: Optional[int] = None
        #: bytes the head itself shipped inline for remote readers — the
        #: legacy funnel path, kept as a fallback; the p2p test asserts this
        #: stays 0 when the data plane is healthy
        self.inline_bytes_served = 0
        self._threads: list[threading.Thread] = []
        self._conn_worker: dict[Any, WorkerHandle] = {}
        # startup tokens invalidated by a registration timeout: a late
        # registration bearing one is told to exit instead of joining the
        # pool (bounded; pruned oldest-first in _respawn_timed_out)
        self._revoked_tokens: dict[str, bool] = {}
        # agent worker-stack-dump rendezvous: req_id -> {pid: stacks}
        self._stacks_replies: dict[str, dict] = {}
        self._stacks_cv = threading.Condition()
        self.task_events: list[dict] = []  # observability feed (state API)
        # metric time-series store + SLO alert engine (both lazy: created on
        # first push/query so clusters that never look pay ~nothing)
        self._metric_series = None
        self._alerts = None
        self._infeasible_warned: dict[bytes, float] = {}
        # resource shapes an attached autoscaler can launch (rpc_autoscaler_offer):
        # a GPU request waits for a node it may buy instead of failing at once
        self._autoscaler_offer: list[dict] = []
        # streaming-generator returns: task_id -> {"items": {index: obj_id},
        # "count": Optional[int] (set at completion), "next": next index a
        # consumer will ask for} (reference: task_manager.cc streaming
        # generator bookkeeping, _raylet.pyx:1230)
        self.streams: dict[bytes, dict] = {}
        # disposed stream ids (bounded): late stream_items/task_done from a
        # producer that had not yet seen the cancel must NOT resurrect the
        # stream entry (it would leak the items forever — nobody consumes a
        # disposed stream); their objects are freed on arrival instead
        self._disposed_streams: dict[bytes, bool] = {}

    # ---------------------------------------------------------------- wiring

    def start(self):
        from multiprocessing.connection import Listener

        # multiprocessing's default backlog is 1: a burst of connects (CLI
        # commands or drivers started side by side) overflows it, and on TCP
        # a client whose ACK was dropped waits for the challenge forever.
        # The listeners take no authkey: the hmac handshake runs in each
        # connection's thread under a deadline (``_serve_conn``), so one
        # client that connects and stays silent holds up no other
        self._listener = Listener(self.socket_path, family="AF_UNIX", backlog=socket.SOMAXCONN)
        t = threading.Thread(
            target=self._accept_loop, args=(self._listener, False),
            name="head-accept", daemon=True,
        )
        t.start()
        self._threads.append(t)
        h = threading.Thread(target=self._health_loop, name="head-health", daemon=True)
        h.start()
        self._threads.append(h)
        pub = threading.Thread(target=self._publisher_loop, name="head-pub", daemon=True)
        pub.start()
        self._threads.append(pub)
        fb = threading.Thread(
            target=self._flush_backstop_loop, name="head-flush-backstop", daemon=True
        )
        fb.start()
        self._threads.append(fb)
        if os.environ.get("RAY_TPU_ALERTS", "1").lower() not in ("0", "false", "off"):
            al = threading.Thread(
                target=self._alerts_loop, name="head-alerts", daemon=True
            )
            al.start()
            self._threads.append(al)
        if GLOBAL_CONFIG.memory_monitor_refresh_ms > 0:
            m = threading.Thread(
                target=self._memory_monitor_loop, name="head-memmon", daemon=True
            )
            m.start()
            self._threads.append(m)

    def listen_tcp(self, host: str = "0.0.0.0", port: int = 0) -> tuple[str, int]:
        """Open the TCP control plane beside the unix socket (same message
        protocol; reference: the gRPC ports every daemon exposes,
        ``services.py:1421``). Connections arriving here are REMOTE: object
        locators are converted to inline payloads for them (no cross-host
        shm)."""
        from multiprocessing.connection import Listener

        self._tcp_listener = Listener((host, port), backlog=socket.SOMAXCONN)  # handshake: _serve_conn
        self.tcp_address = self._tcp_listener.address
        if self.data_server is None:
            from ray_tpu_torch._private.data_plane import DataServer

            self.data_server = DataServer(self.authkey, host)
            self.data_port = self.data_server.port
        t = threading.Thread(
            target=self._accept_loop, args=(self._tcp_listener, True),
            name="head-accept-tcp", daemon=True,
        )
        t.start()
        self._threads.append(t)
        return self.tcp_address

    def _accept_loop(self, listener, remote: bool):
        while not self._shutdown:
            try:
                conn = listener.accept()
            except (OSError, EOFError):
                return
            except Exception as e:
                # an accept error must not kill the accept loop — that would
                # silently stop ALL future worker registration
                warn_throttled("head accept loop", e)
                continue
            t = threading.Thread(
                target=self._serve_conn, args=(conn, remote), daemon=True
            )
            t.start()

    def _serve_conn(self, conn, remote: bool = False):
        """Per-connection thread for drivers and agents. A WORKER conn is
        handed to the shared selector loop at registration (one IO thread
        for all workers, like the reference raylet's single io_service) —
        a thread per worker makes every one of them a GIL competitor and
        measurably caps task throughput."""
        from ray_tpu_torch._private.data_plane import authenticate

        try:
            authenticate(conn, self.authkey)
        except Exception as e:  # noqa: BLE001 - a silent, slow or wrong client: drop it
            warn_throttled("head handshake", e)
            conn.close()
            return
        worker: Optional[WorkerHandle] = None
        agent_node: Optional[NodeID] = None
        session: Optional[ClientSession] = None
        handover = False
        try:
            while not self._shutdown:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    break
                kind = msg[0]
                if kind == "register":
                    worker = self._on_register(conn, msg[1], remote=remote)
                    self.flush_outbox()
                    if worker is None:
                        break  # rejected (unknown node): close so it retries
                    self._adopt_worker_conn(conn, worker, remote)
                    worker = None  # selector owns disconnect handling now
                    handover = True
                    return
                elif kind == "register_agent":
                    agent_node = self._on_register_agent(conn, msg[1])
                elif kind == "register_driver":
                    session = self._on_register_driver(conn, msg[1])
                elif kind == "agent_stats":
                    if agent_node is not None:
                        with self.lock:
                            n = self.nodes.get(agent_node.binary())
                            if n is not None:
                                n.stats = msg[1]
                elif kind == "worker_stacks":
                    self._mailbox_post(msg[1]["req_id"], msg[1]["stacks"])
                elif kind == "submit_batch":
                    # pipelined submission from a ray:// driver session
                    self._on_submit_batch(
                        msg[1],
                        session.submit_hdrs if session is not None else {},
                        session=session,
                    )
                    self.flush_outbox()
                    with self._conn_lock(conn):
                        conn.send(("submit_ack", {"wid": msg[1]["wid"]}))
                elif kind == "req":
                    _, seq, method, payload = msg
                    if session is not None:
                        self._session_track(session, method, payload)
                    self._dispatch_request(conn, worker, seq, method, payload, remote=remote)
        finally:
            # close OUR side whatever ended the loop (rejection, peer EOF,
            # handler exception): a conn left open but unserved would park
            # the peer in recv forever instead of letting it retry
            if not handover:
                from ray_tpu_torch._private.node_agent import shutdown_conn

                shutdown_conn(conn)
            if session is not None:
                self._on_client_disconnect(session, conn)
            if worker is not None:
                self._on_worker_disconnect(worker)
            if agent_node is not None:
                # agent death = node death (reference: raylet disconnect)
                try:
                    self.remove_node(agent_node)
                except Exception:
                    pass

    def _adopt_worker_conn(self, conn, wh: WorkerHandle, remote: bool) -> None:
        self._io_conns[conn] = (wh, remote)
        self._io_conns_gen = next(self._io_gen_src)
        try:
            os.write(self._io_wake_w, b"c")  # pick up the new conn now
        except OSError:
            pass
        with self.lock:
            if self._io_thread is None:
                self._io_thread = threading.Thread(
                    target=self._worker_io_loop, name="head-worker-io", daemon=True
                )
                self._io_thread.start()
                self._threads.append(self._io_thread)

    def _drain_io(
        self,
        sel,
        registered: set,
        special_fd: int,
        timeout: float,
        budget: int = 64,
        once: bool = False,
        reg_gen: Optional[list] = None,
    ) -> bool:
        """Shared selector-drain for the IO thread and pumping getters
        (caller must hold ``_pump_mutex``): sync ``registered`` with the
        live conn set on ``sel``, then drain ready messages — one recv per
        ready conn per select round, re-selecting at timeout 0 until quiet
        or ``budget`` messages (one chatty worker can't starve the rest). A
        readable ``special_fd`` (wake/progress pipe) is drained and ends
        the drain after the current event batch — the caller has a decision
        to make. Returns True when any worker message was handled."""
        # generation guard: with a stable conn set (every sync round trip)
        # the snapshot + key compare below are skipped entirely. A conn
        # adopted between the gen read and the snapshot is re-synced next
        # round (the stored gen is stale, and adopt writes the wake pipe so
        # the next select returns immediately).
        gen = self._io_conns_gen
        if reg_gen is not None and reg_gen[0] == gen:
            current = None
        else:
            # atomic C-level snapshot: _adopt_worker_conn inserts
            # concurrently, and iterating the live dict across threads can
            # raise "dictionary changed size during iteration" out of a
            # user's ray_tpu_torch.get().
            current = dict(self._io_conns)
            if reg_gen is not None:
                reg_gen[0] = gen
        if current is not None and registered != current.keys():
            live = set(current)
            for c in registered - live:
                try:
                    sel.unregister(c)
                except (KeyError, ValueError, OSError):
                    pass
            for c in live - registered:
                try:
                    sel.register(c, 1)  # EVENT_READ
                except (ValueError, OSError):
                    self._reap_io_conn(c)
                    live.discard(c)
            registered.clear()
            registered.update(live)
        progressed = False
        while budget > 0:
            try:
                events = sel.select(timeout=timeout)
            except OSError:
                # a conn died mid-wait: find and reap it
                for c in list(registered):
                    if c.closed or c.fileno() < 0:
                        try:
                            sel.unregister(c)
                        except (KeyError, ValueError, OSError):
                            pass
                        registered.discard(c)
                        self._reap_io_conn(c)
                break
            if not events:
                break
            timeout = 0
            for key, _mask in events:
                conn = key.fileobj
                if conn == special_fd:
                    try:
                        os.read(special_fd, 4096)
                    except OSError:
                        pass
                    budget = 0
                    continue
                ent = self._io_conns.get(conn)
                if ent is None:
                    continue
                wh, remote = ent
                reader = self._io_readers.get(conn)
                if reader is None:
                    reader = self._io_readers[conn] = ser.ConnReader(conn)
                try:
                    # one kernel read, every complete frame parsed — a
                    # burst of coalesced replies costs one syscall, not
                    # two per message (Connection.recv's header+body)
                    msgs = reader.read_available()
                except (EOFError, OSError):
                    try:
                        sel.unregister(conn)
                    except (KeyError, ValueError, OSError):
                        pass
                    registered.discard(conn)
                    self._reap_io_conn(conn)
                    continue
                for msg in msgs:
                    progressed = True
                    budget -= 1
                    self._handle_worker_msg(conn, wh, remote, msg)
            if once and progressed:
                # pumping getter: its completion most likely just landed —
                # return to the readiness re-check instead of paying a
                # second (usually empty) selector round per sync get
                break
        return progressed

    def _worker_io_loop(self) -> None:
        """One selector thread serves EVERY worker connection.

        The selector is PERSISTENT (epoll): `multiprocessing.connection.wait`
        builds, registers, and tears down a fresh poll object per call —
        measurable per-message overhead once every completion wakes it. The
        conn set is re-synced only when `_io_conns` changes, and each ready
        conn is drained (bounded) before re-polling so a burst of
        completions costs one selector wakeup, not one per message."""
        import selectors

        sel = selectors.DefaultSelector()
        sel.register(self._io_wake_r, selectors.EVENT_READ)
        registered: set = set()
        reg_gen = [-1]
        while not self._shutdown:
            if self._pump_requests or (time.monotonic() - self._last_pump) < 0.003:
                # a getter owns the pump (it is doing this loop's job) or
                # pumped within the last few ms (a sync get loop: the next
                # pump is imminent) — park instead of ping-ponging the
                # mutex, which costs two context switches per task
                self._io_resume.wait(timeout=0.01)
                self._io_resume.clear()
                continue
            if not self._pump_mutex.acquire(timeout=0.1):
                continue
            try:
                progressed = self._drain_io(
                    sel, registered, self._io_wake_r, 0.1, reg_gen=reg_gen
                )
                if progressed:
                    self.flush_outbox()
                    if self._pump_requests:
                        try:
                            os.write(self._io_prog_w, b"g")
                        except OSError:
                            pass
            finally:
                self._pump_mutex.release()

    def _reap_io_conn(self, conn) -> None:
        self._io_readers.pop(conn, None)
        ent = self._io_conns.pop(conn, None)
        self._io_conns_gen = next(self._io_gen_src)
        if ent is not None:
            self._on_worker_disconnect(ent[0])
            self.flush_outbox()

    def _handle_worker_msg(self, conn, wh: WorkerHandle, remote: bool, msg) -> None:
        kind = msg[0]
        if kind == "task_done":  # hottest message first (one per task)
            self._on_task_done(wh, msg[1])
        elif kind == "req":
            _, seq, method, payload = msg
            self._dispatch_request(conn, wh, seq, method, payload, remote=remote)
        elif kind == "tasks_done_batch":
            self._on_task_done_batch(wh, msg[1])
        elif kind == "submit_batch":
            # pipelined nested submission from a worker: the whole window
            # lands in one critical section; the ack returns window credits
            # (per-window, never per-task)
            self._on_submit_batch(msg[1], wh.submit_hdrs)
            wh.send(("submit_ack", {"wid": msg[1]["wid"]}))
        elif kind == "stream_item":
            self._on_stream_item(wh, msg[1])
        elif kind == "actor_ready":
            self._on_actor_ready(wh, msg[1])
        elif kind == "profile_result":
            # shared reply mailbox with stack dumps; workers of one node
            # merge under their node's req_id
            self._mailbox_post(msg[1]["req_id"], {msg[1]["pid"]: msg[1]["profile"]})
        elif kind == "events_result":
            # flight-recorder drain replies ride the same mailbox
            self._mailbox_post(msg[1]["req_id"], {msg[1]["pid"]: msg[1]["events"]})
        elif kind == "object_report_result":
            # object-plane residency replies (ledger/audit rendezvous)
            self._mailbox_post(msg[1]["req_id"], {msg[1]["pid"]: msg[1]["report"]})

    def _mailbox_post(self, req_id: str, update: dict) -> None:
        """Merge a reply into the stacks/profile rendezvous mailbox. Bounded:
        replies landing after their caller timed out are never consumed —
        don't accumulate blobs (64 req_ids, not 64 workers: multiple workers
        of one node merge under one id)."""
        with self._stacks_cv:
            self._stacks_replies.setdefault(req_id, {}).update(update)
            while len(self._stacks_replies) > 64:
                self._stacks_replies.pop(next(iter(self._stacks_replies)))
            self._stacks_cv.notify_all()

    def _on_register_driver(self, conn, info: dict) -> ClientSession:
        """A ``ray://`` client attached (reference: the proxier's per-client
        server, ``util/client/server/proxier.py``). A presented session
        token RESUMES that session — same namespace, every ref intact; a
        fresh client gets a new token and an anonymous namespace unless it
        asked for one (reference namespace semantics)."""
        import uuid as _uuid

        token = (info or {}).get("session_token")
        with self.lock:
            session = self.client_sessions.get(token) if token else None
            if session is None:
                token = _uuid.uuid4().hex
                namespace = (info or {}).get("namespace") or f"anon-{token[:12]}"
                session = ClientSession(token, namespace)
                self.client_sessions[token] = session
            session.conn = conn
            session.disconnected_at = None  # reconnect disarms cleanup
        conn.send(
            (
                "driver_ack",
                {
                    "node_id": self._any_node_id(),
                    "session_token": session.token,
                    "namespace": session.namespace,
                },
            )
        )
        return session

    def _session_track(self, session: ClientSession, method: str, payload) -> None:
        """Attribute ref/actor ownership to the client session so a dirty
        disconnect can release exactly what the client held. Mirrors the
        refcounts the handlers themselves will take — kept in the conn
        thread, racing nothing (one thread per client conn)."""
        try:
            if method in ("submit_task", "submit_actor_task", "create_actor"):
                spec = payload["spec"]
                for rid in spec.get("return_ids", ()):
                    session.refs[rid] = session.refs.get(rid, 0) + 1
                if method == "create_actor":
                    session.actors.add(spec["actor_id"])
                    if not spec.get("namespace"):
                        spec["namespace"] = (
                            "default"
                            if spec.get("lifetime") == "detached"
                            else session.namespace
                        )
            elif method == "put" and payload.get("take_ref"):
                session.refs[payload["obj_id"]] = (
                    session.refs.get(payload["obj_id"], 0) + 1
                )
            elif method in ("add_ref",):
                session.refs[payload["obj_id"]] = (
                    session.refs.get(payload["obj_id"], 0) + 1
                )
            elif method in ("free_ref", "free_ref_async"):
                oid = payload["obj_id"]
                n = session.refs.get(oid, 0) - 1
                if n <= 0:
                    session.refs.pop(oid, None)
                else:
                    session.refs[oid] = n
            elif method in ("free_refs", "free_refs_async"):
                # the gc drain's COALESCED free: mirror the
                # batched decrement or session expiry double-frees refs
                # the client already dropped
                for oid in payload["obj_ids"]:
                    n = session.refs.get(oid, 0) - 1
                    if n <= 0:
                        session.refs.pop(oid, None)
                    else:
                        session.refs[oid] = n
            elif method == "get_actor_named" and payload.get("namespace") is None:
                # safety net: clients normally send their namespace, but a
                # None (pre-handshake or legacy caller) defaults to the
                # session's, not the cluster-wide "default"
                payload["namespace"] = session.namespace
        except Exception:
            pass  # bookkeeping must never break the request path

    def _on_client_disconnect(self, session: ClientSession, conn) -> None:
        with self.lock:
            if session.conn is conn:  # a reconnect may already own the session
                session.conn = None
                session.disconnected_at = time.monotonic()

    def _reap_client_sessions(self) -> None:
        """Health-loop tick: release what clients that never came back held
        (reference: proxier cleanup when a client's channel dies)."""
        grace = GLOBAL_CONFIG.client_reconnect_grace_s
        now = time.monotonic()
        with self.lock:
            expired = [
                s
                for s in self.client_sessions.values()
                if s.disconnected_at is not None and now - s.disconnected_at > grace
            ]
            for s in expired:
                self.client_sessions.pop(s.token, None)
        for s in expired:
            for oid, count in s.refs.items():
                for _ in range(count):
                    self.remove_ref(oid)
            s.refs.clear()
            for aid in s.actors:
                with self.lock:
                    actor = self.actors.get(aid)
                    leaked = (
                        actor is not None
                        and not actor.detached
                        and actor.state != ACTOR_DEAD
                    )
                if leaked:
                    self.kill_actor(aid, no_restart=True)
            s.actors.clear()
            self.flush_outbox()

    def _any_node_id(self) -> bytes:
        with self.lock:
            for n in self.nodes.values():
                if n.alive:
                    return n.node_id.binary()
        raise rex.RayError("cluster has no alive nodes")

    def _on_register_agent(self, conn, info) -> NodeID:
        """A remote host's node agent attached: register its node; workers
        for it will be spawned THERE via spawn requests over this conn. An
        agent reattaching after a head restart presents its previous node
        id and keeps it (dead or unknown here — a LIVE id means a rogue
        duplicate and gets a fresh one)."""
        want = info.get("node_id")
        keep = None
        if want:
            with self.lock:
                old = self.nodes.get(want)
                if old is None or not old.alive:
                    keep = NodeID(want)
        node_id = self.add_node(
            info.get("resources") or {}, labels=info.get("labels"), node_id=keep
        )
        with self.lock:
            node = self.nodes[node_id.binary()]
            node.agent = AgentHandle(conn)
            if info.get("data_address"):
                node.data_address = tuple(info["data_address"])
        conn.send(("agent_ack", {
            "node_id": node_id.binary(),
            # ship the head's non-default config so the _system_config tier
            # reaches remote agent/worker processes too (reference: GCS
            # serves system_config to joining raylets), not just this host
            "config": _cfg.config_overrides(),
        }))
        with self.lock:
            self._schedule()  # queued-infeasible work may now fit
        return node_id

    def _dispatch_request(self, conn, worker, seq, method, payload, remote: bool = False):
        if method in ("subscribe", "unsubscribe"):
            import functools

            handler = functools.partial(getattr(self, "_rpc_" + method), conn)
        else:
            handler = getattr(self, "rpc_" + method)
        if remote and method == "get":
            handler = self._rpc_get_remote
        blocking = method in (
            "get", "wait", "pg_ready", "get_actor_named", "stream_next",
            "worker_stacks", "worker_profile", "mutex_acquire",
            "collect_events",
        )
        if blocking:
            # blocking RPCs park until objects/actors materialize; run them
            # on a cached high-cap pool so the hot path reuses threads
            # instead of spawning one per call (reference: the event-loop
            # pipelining in grpc_server.h — many-task workloads would
            # otherwise hit thread-spawn overhead and exhaustion)
            if worker is not None and method in ("get", "wait"):
                # the submitter is about to park in ray.get/wait: it must
                # not be handed lease followers meanwhile (_try_lease_dispatch)
                with self.lock:
                    worker.blocked_gets += 1
                wh0 = worker

                def handler(h=handler, wh0=wh0, **kw):  # noqa: B008
                    try:
                        return h(**kw)
                    finally:
                        with self.lock:
                            wh0.blocked_gets = max(0, wh0.blocked_gets - 1)

            self._blocking_pool.submit(
                self._run_request, conn, worker, seq, handler, payload
            )
        else:
            self._run_request(conn, worker, seq, handler, payload)

    def _rpc_get_remote(self, obj_ids, timeout=None):
        """get for TCP clients. With the data plane up, hand out the shm
        locators untouched — the client pulls the bytes straight from the
        owning host's data server (head = directory only; reference:
        object_manager.h peer-to-peer chunked transfer). Without it, fall
        back to the old behavior of shipping bytes inline."""
        if self.data_server is not None:
            return self.get_locators(obj_ids, timeout)
        return self.rpc_get_inline(obj_ids, timeout)

    def rpc_get_inline(self, obj_ids, timeout=None):
        """Head-mediated object fetch: read the bytes (locally, or pulled
        from the owning agent's data server) and ship them inline on the
        control socket. Fallback for clients that cannot reach a host's
        data server; ``inline_bytes_served`` counts this traffic so tests
        can assert the p2p path leaves it at zero."""
        from ray_tpu_torch._private import data_plane
        from ray_tpu_torch._private.shm_store import ShmReader

        out = []
        for loc in self.get_locators(obj_ids, timeout):
            kind, payload, is_err = loc
            if kind != "shm":
                out.append(loc)
                continue
            data = None
            try:
                reader = ShmReader(payload)
                try:
                    data = reader.read_serialized_bytes()
                finally:
                    reader.close()
            except FileNotFoundError:
                with self.lock:
                    node = self.nodes.get(payload.node) if payload.node else None
                addr = node.data_address if node is not None else None
                if addr is not None:
                    from ray_tpu_torch._private.shm_store import layout_views

                    mv = data_plane.fetch(addr, self.authkey, payload)
                    header, bufs = layout_views(
                        mv, payload.header_len, payload.buffer_lens
                    )
                    data = ser.SerializedValue(bytes(header), bufs).to_bytes()
            if data is None:
                raise FileNotFoundError("object backing unavailable")
            self.inline_bytes_served += len(data)
            out.append(("inline", data, is_err))
        return out

    def rpc_data_address(self, node_id=None):
        """Data-plane address for a node's host. Agent nodes advertise their
        own server; anything else (head host, simulated local nodes,
        unknown) maps to the head's server. host=None means "the host you
        already reach the control plane on"."""
        with self.lock:
            n = self.nodes.get(node_id) if node_id else None
            if n is not None and n.data_address is not None:
                return tuple(n.data_address)
        return (None, self.data_port) if self.data_port else None

    def _run_request(self, conn, worker, seq, handler, payload):
        if seq == 0:
            # fire-and-forget request (free_ref, pipelined put): client
            # seqs start at 1, so nobody waits on seq 0 — skip the dead
            # resp write (one fewer socket frame per put/free in a burst)
            try:
                handler(**payload)
            except BaseException as e:  # noqa: BLE001
                warn_throttled(f"fire-and-forget {getattr(handler, '__name__', '?')}", e)
            self.flush_outbox()
            return
        try:
            result = handler(**payload)
            out = ("resp", seq, True, result)
        except BaseException as e:  # noqa: BLE001 - errors cross the socket
            out = ("resp", seq, False, e if _picklable(e) else rex.RayError(repr(e)))
        self.flush_outbox()
        try:
            if worker is not None:
                with worker.send_lock:
                    ser.conn_send(conn, out)
            else:
                ser.conn_send(conn, out)
        except (OSError, ValueError, BrokenPipeError):
            pass

    # -------------------------------------------------------------- workers

    def _spawn_worker(
        self,
        node: NodeState,
        actor_id: Optional[bytes] = None,
        attempts: int = 0,
        container: Optional[dict] = None,
    ) -> None:
        # Workers are fresh interpreter processes running a dedicated entry
        # point (`python -m ray_tpu_torch._private.worker_main`), like the
        # reference's worker pool (worker_pool.h:152) execing default_worker.py
        # — NOT multiprocessing children, which would re-import the user's
        # __main__ module (fatal for unguarded driver scripts). Remote nodes
        # delegate the spawn to their agent daemon over TCP.
        import uuid as _uuid

        if actor_id is not None and container is None:
            # every actor spawn path (first spawn, registration-timeout
            # retry, restart FSM) funnels here; resolve the container spec
            # from the create rec so no caller can drop it
            with self.lock:
                rec = self._actor_create_recs.get(actor_id)
                if rec is not None:
                    container = (rec["spec"].get("runtime_env") or {}).get("container")
        token = _uuid.uuid4().hex
        if node.agent is not None:
            wh = WorkerHandle(node, None)
            wh.actor_id = actor_id
            wh.token = token
            wh.spawn_attempts = attempts
            with self.lock:
                node.all_workers.add(wh)
            msg: dict = {"token": token}
            if container:
                msg["container"] = container
            if not node.agent.send(("spawn_worker", msg)):
                self._on_worker_dead(wh)
            return

        if container is None and GLOBAL_CONFIG.worker_forkserver_enabled:
            # fast path: fork from the node's warm template (~5-10ms) instead
            # of a cold interpreter boot (reference: pre-started worker pool,
            # worker_pool.h:152 — same goal, one warm process instead of N).
            # The handle goes into all_workers BEFORE the fork request: the
            # template's token->pid report races the fork and must find the
            # handle, or a pre-registration wedge could never be killed.
            tmpl = self._ensure_template(node)
            if tmpl is not None:
                wh = WorkerHandle(node, None)
                wh.forked = True
                wh.actor_id = actor_id
                wh.token = token
                wh.spawn_attempts = attempts
                with self.lock:
                    node.all_workers.add(wh)
                if tmpl.fork(token):
                    return
                with self.lock:  # template died mid-request: cold-spawn
                    node.all_workers.discard(wh)

        import subprocess
        import sys

        pkg_root = self._pkg_root()
        env = self._worker_env(pkg_root)
        argv = [
            sys.executable,
            "-m",
            "ray_tpu_torch._private.worker_main",
            self.socket_path,
            self.authkey.hex(),
            node.node_id.binary().hex(),
            token,
        ]
        if container:
            from ray_tpu_torch._private import runtime_env as _renv

            argv, env = _renv.container_wrap(argv, env, pkg_root, container)
        popen = subprocess.Popen(argv, env=env, start_new_session=False)
        proc = _WorkerProc(popen)
        wh = WorkerHandle(node, proc)
        wh.actor_id = actor_id
        wh.token = token
        wh.spawn_attempts = attempts
        with self.lock:
            node.all_workers.add(wh)
        # registration arrives on its own connection; matched in _on_register

    def _pkg_root(self) -> str:
        import ray_tpu_torch

        return os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))

    def _worker_env(self, pkg_root: str) -> dict:
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        if GLOBAL_CONFIG.preload_python_modules:  # the template reads it (worker_template.py)
            env["RAY_TPU_PRELOAD_PYTHON_MODULES"] = GLOBAL_CONFIG.preload_python_modules
        if self.arena_name:
            env["RAY_TPU_ARENA"] = self.arena_name
        if self.tcp_address is not None:
            # detached-actor workers reconnect here after a head restart —
            # the unix socket dies with the old head process, the TCP
            # address is what a restarted head rebinds
            env["RAY_TPU_HEAD_TCP"] = f"{self.tcp_address[0]}:{self.tcp_address[1]}"
        return env

    def _ensure_template(self, node: NodeState) -> Optional[TemplateProc]:
        """Get (spawning if needed) the node's forkserver template. Returns
        None when templates are unusable on this platform (no fork) — the
        caller cold-spawns. A dead template (OOM-killed, crashed) is
        replaced; spawn requests buffered in its stdin pipe die with it, but
        those workers' registration timeouts already cover lost spawns."""
        tmpl = node.template
        if tmpl is not None and tmpl.alive():
            return tmpl
        # Popen OUTSIDE the head lock (it is multi-ms and the lock guards
        # the scheduling hot path); the re-check under the lock keeps one
        # template per node when two spawn threads race here.
        ours = spawn_template(
            self.socket_path,
            self.authkey,
            node.node_id.binary(),
            self._worker_env(self._pkg_root()),
            on_spawn=lambda token, proc: self._bind_forked_proc(node, token, proc),
        )
        if ours is None:
            return None
        with self.lock:
            cur = node.template
            if cur is not None and cur.alive():
                loser = ours
            else:
                node.template, loser = ours, cur
        if loser is not None:
            loser.shutdown()
        return node.template

    def _bind_forked_proc(self, node: NodeState, token: str, proc: ForkedProc) -> None:
        """Template reported a fork: give the pre-created handle a process
        object NOW so registration-timeout kills work before the worker
        ever connects (_on_register also binds, for the race where it wins)."""
        with self.lock:
            for wh in node.all_workers:
                if wh.token == token and wh.proc is None:
                    wh.proc = proc
                    return
            revoked = token in self._revoked_tokens
        if revoked:
            # the head already gave up on this spawn (_respawn_timed_out ran
            # before the pid report arrived, so it had nothing to kill) —
            # this report IS the kill opportunity for the wedged interpreter
            proc.terminate()

    def _on_register(self, conn, info, remote: bool = False) -> Optional[WorkerHandle]:
        node_id = info["node_id"]
        pid = info["pid"]
        token = info.get("token")
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None:
                # e.g. a detached-actor worker reconnecting after a head
                # restart BEFORE its node's agent has reattached: reject by
                # closing the conn (caller) — the worker's reconnect loop
                # retries until the node exists again
                return None
            wh = None
            if token:
                for cand in node.all_workers:
                    if cand.conn is None and cand.token == token:
                        wh = cand
                        break
            if wh is None:
                for cand in node.all_workers:
                    if cand.conn is None and cand.proc is not None and cand.proc.pid == pid:
                        wh = cand
                        break
            if wh is None and token and token in self._revoked_tokens:
                # timed out and already replaced: exit, don't join the pool
                self._revoked_tokens.pop(token, None)
                wh = WorkerHandle(node, None)
                wh.conn = conn
                wh.alive = False
                self._conn_worker[conn] = wh
                wh.send(("exit", None))
                return wh
            if wh is None:  # race-safe fallback
                wh = WorkerHandle(node, None)
                node.all_workers.add(wh)
            wh.conn = conn
            if wh.forked and wh.proc is None and not remote:
                # template-forked worker: first time we learn its pid —
                # kill/join paths need a process handle (head-host only;
                # a remote host's pid is meaningless here)
                wh.proc = ForkedProc(pid)
            claim = info.get("actor_id")
            if wh.actor_id is None and claim is None:
                # not a reconnect claim: this registration consumes a spawn
                # slot (a reconnecting worker never occupied one)
                node.spawning = max(0, node.spawning - 1)
            self._conn_worker[conn] = wh
            if claim is not None:
                # a detached actor's worker reconnecting after a head
                # restart: rebind it to the restored ActorState (its
                # actor_ready message completes the transition to ALIVE
                # through _on_actor_ready). Reject if the actor is gone OR
                # already re-bound/re-creating — two workers bound to one
                # actor id would split its state.
                actor = self.actors.get(claim)
                if (
                    actor is None
                    or actor.state == ACTOR_DEAD
                    or actor.worker is not None
                    or actor.create_spec["task_id"] in self.tasks
                ):
                    wh.alive = False
                    wh.send(("exit", None))
                    return wh
                wh.actor_id = claim
                actor.node_id = node.node_id
                self._restored_actors.discard(claim)
                return wh
            if wh.actor_id is not None:
                rec = self._actor_create_recs.pop(wh.actor_id, None)
                if rec is not None and rec["task_id"] in self.cancelled:
                    # creation cancelled while the worker was coming up:
                    # resolve the creation refs and mark the actor dead
                    self._finish_cancelled(rec)
                    actor = self.actors.get(wh.actor_id)
                    if actor is not None and actor.state != ACTOR_DEAD:
                        actor.restarts_left = 0
                        self._kill_actor_locked(actor, "creation cancelled", restart=False)
                    rec = None
                if rec is None:
                    # actor died/was cancelled before its worker came up
                    wh.alive = False
                    wh.send(("exit", None))
                else:
                    self._dispatch_to_worker(wh, rec)
            else:
                self._worker_idle(wh)
        return wh

    def _worker_idle(self, wh: WorkerHandle):
        """Called with lock held: worker drained its queue / just registered."""
        node = wh.node
        wh.current_task = None
        wh.lease_sig = None
        wh.idle_since = time.monotonic()
        if wh.actor_id is not None:
            # Dedicated actor worker (reference: actors own their worker
            # process for life) — it must never join the general pool, or a
            # blocking normal task could wedge the actor's serial queue.
            return
        while node.assigned and node.alive:
            rec = node.assigned.popleft()
            if rec["task_id"] in self.cancelled:
                self._finish_cancelled(rec)
                continue
            self._dispatch_to_worker(wh, rec)
            return
        if wh not in node.idle_workers:
            node.idle_workers.append(wh)

    def _dispatch_to_worker(self, wh: WorkerHandle, rec: dict) -> None:
        spec = rec["spec"]
        wh.queued_recs.append(rec)
        wh.current_task = wh.queued_recs[0]
        leaseable = not spec.get("strategy") and spec["kind"] == "task"
        # the lease key includes func_id on top of the scheduling signature:
        # queueing a DIFFERENT function behind a running task deadlocks when
        # the running task is its submitter blocked in ray.get on it (the
        # nested fan-out pattern: parent and leaf share {CPU: 1})
        sig = (
            (_PendingQueue.sig_of(rec), spec.get("func_id")) if leaseable else None
        )
        if len(wh.queued_recs) == 1:
            wh.lease_sig = sig
        elif wh.lease_sig != sig:
            wh.lease_sig = None  # mixed queue: stop leasing until it drains
        if wh in wh.node.idle_workers:
            wh.node.idle_workers.remove(wh)
        rec["worker"] = wh
        rec["state"] = "RUNNING"
        rec["started_at"] = time.monotonic()  # OOM policy: newest-first victim
        wf = spec.get("wf")
        if wf is not None:
            _waterfall.stamp(wf)  # head_dispatch: about to queue the send
        self._event(rec, "RUNNING")
        # send OUTSIDE the head lock (flush_outbox); a dead conn surfaces
        # there as worker death, which requeues the whole dispatch FIFO —
        # dispatch itself can no longer fail synchronously
        self._enqueue_send(wh, ("run_task", spec))

    def _enqueue_send(self, wh: WorkerHandle, msg) -> None:
        """Lock held: queue a worker-bound message. The socket write (plus
        its pickle) happens in flush_outbox AFTER the caller releases the
        head lock — a write inside the critical section serializes every
        conn thread behind each dispatch. The backstop thread catches any
        path that queued a send but parks before flushing (e.g. a driver
        get whose lineage reconstruction dispatched a rebuild, then blocked
        on the very result).

        Deliberately does NOT wake the backstop: Event.set with a waiter is
        a futex wake (~50us measured on a busy 1-core box, paid on EVERY
        dispatch), while every normal entry point already flushes in its
        own finally — the backstop only exists for the rare parked-enqueuer
        path, which its poll interval bounds."""
        self._outbox.append((wh, msg))

    def _wire_spec(self, wh: WorkerHandle, spec: dict) -> dict:
        """Header-split a dispatch (cheaper per-task bytes): a
        spec carrying ``_hdr`` (header id + the static per-function fields
        its submitter computed once) ships only its per-call body
        (ser.split_spec_body — the shared elision rule) plus a header
        reference; the first dispatch of a header to a worker inlines the
        definition (``_hdr_def``), so a worker never misses — the conn is
        FIFO and ``sent_hdrs`` is per-handle, so respawned or reassigned
        workers start from a fresh set."""
        hdr = spec.get("_hdr")
        if hdr is None:
            return spec
        hid, fields = hdr
        body = ser.split_spec_body(spec, fields)
        if hid in wh.sent_hdrs:
            body["_hdr_ref"] = hid
        else:
            wh.sent_hdrs.add(hid)
            body["_hdr_def"] = hdr
        return body

    def _flush_backstop_loop(self) -> None:
        while not self._shutdown:
            self._flush_event.wait(timeout=GLOBAL_CONFIG.outbox_flush_backstop_s)
            self._flush_event.clear()
            self.flush_outbox()

    def flush_outbox(self) -> None:
        """Drain queued worker sends. Called by every entry point right
        after it drops the head lock (RPC dispatch, conn message handlers,
        driver direct calls, the health loop). Exactly ONE thread drains at
        a time — per-worker message order is the dispatch order workers'
        FIFO execution depends on; the outer re-check catches items
        appended while the active drainer was releasing.

        run_task dispatches coalesce PER WORKER across the whole drain into
        one run_task_batch message (one pickle + one socket write for a
        burst of pipelined leases or a deferred submit storm). Only
        cross-worker order is relaxed — no ordering contract spans workers;
        each worker's own FIFO (including non-dispatch messages like exit,
        which flush that worker's pending batch first) is preserved. Each
        spec is header-split per worker at write time (_wire_spec): static
        per-function fields ship once, steady-state bodies reference them."""
        while self._outbox:
            if not self._flush_lock.acquire(blocking=False):
                return  # active drainer will pick ours up (or we re-enter)
            try:
                if len(self._outbox) == 1:
                    # sync round-trip fast path: one queued message, no
                    # batching machinery — pop, wire, write
                    try:
                        wh, msg = self._outbox.popleft()
                    except IndexError:
                        continue
                    if msg[0] == "run_task":
                        msg = ("run_task", self._wire_spec(wh, msg[1]))
                    if wh.alive and not wh.send(msg):
                        self._on_worker_dead(wh)
                    continue
                batches: dict = {}  # wh -> [spec, ...] in dispatch order

                def _flush_batch(wh0):
                    specs = batches.pop(wh0, None)
                    if not specs:
                        return
                    if not wh0.alive:
                        return
                    wire = [self._wire_spec(wh0, s) for s in specs]
                    out = ("run_task", wire[0]) if len(wire) == 1 else (
                        "run_task_batch", wire
                    )
                    if not wh0.send(out):
                        self._on_worker_dead(wh0)

                while True:
                    try:
                        wh, msg = self._outbox.popleft()
                    except IndexError:
                        break
                    if msg[0] == "run_task":
                        batches.setdefault(wh, []).append(msg[1])
                        continue
                    _flush_batch(wh)  # non-dispatch msg: keep per-wh FIFO
                    if wh.alive and not wh.send(msg):
                        self._on_worker_dead(wh)
                for wh in list(batches):
                    _flush_batch(wh)
            finally:
                self._flush_lock.release()

    def _try_lease_dispatch(self, rec: dict) -> bool:
        """No node has free capacity — pipeline the task onto a worker
        already running the same scheduling signature. The follower holds no
        allocation of its own; it inherits the chain head's at completion
        time (_on_task_done alloc transfer), so concurrent resource usage
        stays exact while the worker never idles waiting for a round-trip.
        """
        depth = GLOBAL_CONFIG.max_tasks_in_flight_per_worker
        if depth <= 1:
            return False
        spec = rec["spec"]
        if spec.get("strategy") or spec["kind"] != "task":
            return False
        sig = (_PendingQueue.sig_of(rec), spec.get("func_id"))
        for nid in self.node_order:
            node = self.nodes[nid]
            if not node.alive:
                continue
            for wh in node.all_workers:
                if (
                    wh.alive
                    and wh.conn is not None
                    and wh.actor_id is None
                    and wh.lease_sig == sig
                    and wh.blocked_gets == 0
                    and len(wh.queued_recs) < depth
                ):
                    rec["node"] = node.node_id
                    rec["state"] = "ASSIGNED"
                    self._dispatch_to_worker(wh, rec)
                    return True
        return False

    # ------------------------------------------------------------ node admin

    def add_node(self, resources: dict[str, float], labels=None, node_id=None) -> NodeID:
        """``node_id`` lets a reattaching agent keep its identity across a
        head restart, so restored object locators (loc.node) stay routable
        (reference: raylet re-registration after GCS failover)."""
        node_id = node_id or NodeID.from_random()
        with self.lock:
            self.nodes[node_id.binary()] = NodeState(node_id, resources, labels)
            if node_id.binary() not in self.node_order:
                self.node_order.append(node_id.binary())
            self._sched_gen += 1
            self._retry_pending_pgs()
            self._schedule()
        self.publish("nodes", {"event": "added", "node_id": node_id.hex(), "resources": dict(resources)})
        return node_id

    def remove_node(self, node_id: NodeID, graceful: bool = False) -> None:
        """Simulated node failure (reference: NodeKillerActor / node death in
        GCS). Kills all workers, fails or retries their tasks, restarts their
        actors elsewhere."""
        # One critical section for mark-dead + requeue: releasing the lock
        # mid-removal would let rpc_task_done/_schedule observe a dead node
        # whose tasks are not yet requeued. publish() is a non-blocking
        # Queue.put and terminate() just sends a signal, so neither can
        # block the lock.
        with self.lock:
            node = self.nodes.get(node_id.binary())
            if node is None or not node.alive:
                return
            node.alive = False
            workers = list(node.all_workers)
            self.publish("nodes", {"event": "removed", "node_id": node_id.hex()})
            assigned = list(node.assigned)
            node.assigned.clear()
            node.idle_workers.clear()
            # the handles stay alive until _handle_worker_death_locked below
            # retires them: it returns at once for a handle already marked
            # dead, and then a task running there was never retried or
            # failed, nor an actor there restarted
            for wh in workers:
                if wh.proc is not None and wh.proc.is_alive():
                    wh.proc.terminate()
            if node.template is not None:
                node.template.shutdown()
                node.template = None
            for rec in assigned:
                self._requeue_or_fail(rec, rex.WorkerCrashedError("node removed"))
            for wh in workers:
                self._handle_worker_death_locked(wh)
            for pg in self.placement_groups.values():
                if any(n == node_id for n in pg.bundle_nodes):
                    for i, n in enumerate(pg.bundle_nodes):
                        if n == node_id:
                            pg.bundle_nodes[i] = None
                    pg.state = PG_PENDING
                    pg.ready_event.clear()
                    self._try_place_pg(pg)
            # objects whose bytes lived on the dead host are gone: rebuild
            # via lineage or mark LOST now, so readers fail fast instead of
            # timing out against an unreachable data server (reference:
            # object directory location removal on node death). Skipped
            # during shutdown — resubmitting tasks into a dying cluster is
            # pure noise.
            nid = node_id.binary()
            if not self._shutdown:
                for oid, ent in list(self.objects.items()):
                    if ent.shm is not None and ent.shm.node == nid:
                        events.emit(
                            "core.object.reap",
                            obj_id=oid,
                            size=ent.size,
                            node=nid,
                            reason="node-removed",
                        )
                        self._reconstruct(oid, ent)
            self._schedule()
            self.cv.notify_all()

    # ----------------------------------------------------------- scheduling

    def _on_submit_batch(self, payload: dict, hdr_cache: dict, session=None) -> None:
        """Rehydrate one pipelined submit window — items are ``(kind,
        body)`` with bodies header-split against this connection's cache —
        and run it through ``submit_task_batch``. Submit-time failures
        (missing header after a protocol loss, oversized inline args)
        surface asynchronously on that task's return refs; the window
        always completes and always gets acked, so client credits can
        never wedge on a poison task."""
        hdrs = payload.get("hdrs")
        if hdrs:
            hdr_cache.update(hdrs)
        cap = GLOBAL_CONFIG.core_max_spec_inline_bytes
        items = []
        for kind, body in payload["items"]:
            if kind == "put":
                # pipelined ray.put riding the submit window:
                # process AT its window position — a later item in this
                # same window may consume the ref as a task argument.
                # rpc_put never raises (store failures land on the id),
                # so the window always completes and always acks.
                body.pop("return_ids", None)
                # rpc_put returns False only for an ignored replay
                # duplicate — tracking the session ref then would
                # double-count the take_ref applied by the original
                stored = self.rpc_put(**body)
                if stored and session is not None:
                    self._session_track(session, "put", body)
                continue
            hid = body.pop("_hdr_ref", None)
            if hid is None:
                spec = body
            else:
                fields = hdr_cache.get(hid)
                if fields is None:
                    with self.lock:
                        for rid in body.get("return_ids", ()):
                            self._store_error(
                                rid,
                                rex.RayError(
                                    "submit window referenced an unknown spec "
                                    "header (connection state lost); retry the task"
                                ),
                            )
                    continue
                spec = {**fields, **body}
                spec["_hdr"] = (hid, fields)
            size = 0
            for a in spec.get("args", ()):
                if a[0] == "v":
                    size += len(a[1])
            for a in spec.get("kwargs", {}).values():
                if a[0] == "v":
                    size += len(a[1])
            if size > cap:
                with self.lock:
                    for rid in spec.get("return_ids", ()):
                        self._store_error(
                            rid,
                            ValueError(
                                f"task {spec.get('name')!r} carries {size} inline "
                                f"argument bytes (cap {cap}); ray_tpu_torch.put() large "
                                f"arguments and pass the refs"
                            ),
                        )
                continue
            if session is not None:
                self._session_track(
                    session,
                    "submit_task" if kind == "task" else "submit_actor_task",
                    {"spec": spec},
                )
            items.append((kind, spec))
        if items:
            self.submit_task_batch(items)

    def submit_task(self, spec: dict) -> None:
        with self.lock:
            if self._submit_task_locked(spec):
                self._schedule()

    def submit_task_batch(self, items: list) -> None:
        """Pipelined-submission entry: a whole burst of specs —
        ``("task" | "actor_method", spec)`` in submission order — lands in
        ONE critical section with ONE scheduling pass, instead of a lock
        acquisition + schedule pass per ``.remote()``. Per-item failures
        surface asynchronously on that item's return refs (the submitter
        already holds them; there is no reply to raise into)."""
        _batch_metrics()["submit"].observe(len(items))
        with self.lock:
            need_sched = False
            for kind, spec in items:
                try:
                    if kind == "task":
                        need_sched = self._submit_task_locked(spec) or need_sched
                    else:
                        self._submit_actor_task_locked(spec)
                except Exception as e:  # noqa: BLE001 - surfaces on the refs
                    for rid in spec.get("return_ids", ()):
                        self._store_error(rid, e)
            if need_sched:
                self._schedule()

    def _submit_task_locked(self, spec: dict) -> bool:
        """Lock held. Returns True when the task joined ``pending_sched``
        (the caller owes a scheduling pass)."""
        rec = {
            "task_id": spec["task_id"],
            "spec": spec,
            "deps": set(),
            "state": "PENDING",
            "worker": None,
            "node": None,
            "retries_left": spec.get("max_retries", GLOBAL_CONFIG.default_max_retries),
        }
        # the submitter's refs on the return objects are taken HERE — at
        # receive time, before any dispatch — not by per-id add_ref RPCs
        # before the submit: for a worker submitting nested tasks that is
        # one control round trip instead of 1 + num_returns, and for a
        # batched window it means ownership exists the moment the head has
        # the bytes (reference: task returns are born owned by the
        # submitter, reference_count.h)
        for rid in spec["return_ids"]:
            ent = self.objects.get(rid)
            if ent is None:
                ent = self.objects[rid] = ObjectEntry()
            ent.refcount += 1
        strategy = spec.get("strategy")
        if strategy and strategy[0] == "pg":
            # Fail fast if the task can never fit its designated bundle
            # (reference: ValueError on infeasible bundle resources).
            _, pg_id, bundle_idx, _ = strategy
            pg = self.placement_groups.get(pg_id)
            if pg is None:
                for rid in spec["return_ids"]:
                    self._store_error(rid, ValueError("placement group removed"))
                return False
            res = self._effective_resources(spec)
            bundles = [pg.bundles[bundle_idx]] if bundle_idx >= 0 else pg.bundles
            if not any(
                all(b.get(k, 0.0) >= v for k, v in res.items()) for b in bundles
            ):
                for rid in spec["return_ids"]:
                    self._store_error(
                        rid,
                        ValueError(
                            f"Task {spec.get('name')} requires {res} which can never fit "
                            f"in placement group bundle(s) {bundles}; pass num_cpus=0 for "
                            f"tasks in accelerator-only bundles"
                        ),
                    )
                return False
        self.tasks[spec["task_id"]] = rec
        self._event(rec, "PENDING_ARGS_AVAIL")
        if spec.get("args") or spec.get("kwargs"):
            for kind, payload in _iter_arg_refs(spec):
                ent = self.objects.get(payload)
                if ent is None:
                    ent = self.objects[payload] = ObjectEntry()
                ent.pins += 1
                if not ent.ready:
                    rec["deps"].add(payload)
                    self.dep_waiters.setdefault(payload, set()).add(rec["task_id"])
        if rec["deps"]:
            rec["state"] = "WAITING_DEPS"
            return False
        if not self.pending_sched and self._try_place(rec):
            # direct placement: with nothing queued ahead policy order is
            # unchanged, and the _PendingQueue signature machinery
            # (append + schedule_pass) drops off the per-submit hot path
            return False
        self.pending_sched.append(rec)
        return True

    def _deps_ready(self, obj_id: bytes):
        """Lock held. An object became available; activate waiting tasks."""
        activated = False
        for tid in self.dep_waiters.pop(obj_id, ()):  # noqa: B020
            rec = self.tasks.get(tid)
            if rec is None:
                continue
            rec["deps"].discard(obj_id)
            if not rec["deps"] and rec["state"] == "WAITING_DEPS":
                rec["state"] = "PENDING"
                self.pending_sched.append(rec)
                activated = True
        if activated:
            self._schedule()

    def _try_place(self, rec: dict) -> bool:
        """Lock held. One placement attempt for a dep-free task record —
        the policy body shared by the scheduling pass and the direct
        fast path (_submit_task_locked)."""
        if self.cancelled and rec["task_id"] in self.cancelled:
            self._finish_cancelled(rec)
            return True
        res = self._effective_resources(rec["spec"])
        node = self._pick_node(rec["spec"], res)
        if node is None:
            if self._try_lease_dispatch(rec):
                return True
            if res.get("GPU", 0) > 0 and not self._any_node_has_gpu() and not self._gpu_offered():
                self._fail_without_gpu(rec, res)
                return True
            self._warn_infeasible(rec)
            return False
        self._allocate_for(rec, node, res)
        rec["node"] = node.node_id
        rec["state"] = "ASSIGNED"
        if rec["spec"]["kind"] == "actor_create":
            self._start_actor_on(rec, node)
        elif node.idle_workers:
            wh = node.idle_workers.pop()
            self._dispatch_to_worker(wh, rec)
        else:
            node.assigned.append(rec)
            self._maybe_spawn(node)
        return True

    def _schedule(self):
        """Lock held. Hybrid policy (reference hybrid_scheduling_policy.cc):
        prefer the first feasible node whose critical-resource utilization
        stays under the spread threshold (pack); otherwise the least-utilized
        feasible node (spread). Honors strategies: SPREAD, node affinity,
        placement-group bundles. One pass visits each distinct scheduling
        signature once (see _PendingQueue) — O(signatures), not O(tasks)."""
        if not self.pending_sched:
            return  # hot path: every completion triggers a pass
        self.pending_sched.schedule_pass(self._try_place, self._sched_gen)

    def _any_node_has_gpu(self) -> bool:
        """Lock held. Whether any live node offers the ``GPU`` resource."""
        return any(n.alive and n.resources_total.get("GPU", 0) > 0 for n in self.nodes.values())

    def _gpu_offered(self) -> bool:
        """Lock held. Whether an attached autoscaler can launch a node with
        the ``GPU`` resource (``rpc_autoscaler_offer``)."""
        return any(shape.get("GPU", 0) > 0 for shape in self._autoscaler_offer)

    def _fail_without_gpu(self, rec, res: dict) -> None:
        """Lock held. A GPU request on a cluster with no card fails at once
        (the reference warns and waits for a node that may join), unless an
        autoscaler offers a GPU node type: GPU work never runs on the CPU in
        its place, and never waits for a node that cannot come."""
        spec = rec["spec"]
        what = "actor" if spec["kind"] == "actor_create" else "task"
        err = rex.RayError(
            f"{what} requires {res}, but no node of this cluster has a GPU "
            "(GPU: 0); a GPU request is never run on the CPU instead"
        )
        if spec["kind"] == "actor_create":
            actor = self.actors.get(spec["actor_id"])
            if actor is not None:
                actor.restarts_left = 0
                self._kill_actor_locked(actor, err, restart=False)
                return
        self.tasks.pop(rec["task_id"], None)
        self._unpin_deps(spec)
        for rid in spec["return_ids"]:
            self._store_error(rid, err)
        self._fail_stream_locked(spec)
        self.cv.notify_all()

    def _warn_infeasible(self, rec):
        now = time.monotonic()
        tid = rec["task_id"]
        if now - self._infeasible_warned.get(tid, 0.0) > GLOBAL_CONFIG.infeasible_warn_interval_s:
            self._infeasible_warned[tid] = now
            res = self._effective_resources(rec["spec"])
            total = {}
            for n in self.nodes.values():
                if n.alive:
                    for k, v in n.resources_total.items():
                        total[k] = max(total.get(k, 0.0), v)
            if any(total.get(k, 0.0) < v for k, v in res.items() if v > 0):
                print(
                    f"[ray_tpu_torch] WARNING: task {rec['spec'].get('name')} requires {res} "
                    f"which no node can ever satisfy (per-node max {total})."
                )

    def _effective_resources(self, spec: dict) -> dict[str, float]:
        eres = spec.get("_eres")
        if eres is not None:
            return eres  # template-cached (read-only by contract)
        return {k: v for k, v in spec.get("resources", {}).items() if v != 0}

    def _locality_bytes(self, spec: dict) -> Optional[dict]:
        """Lock held. Bytes of this spec's ref args resident per owning node
       : the object directory already knows where every shm
        locator lives (``ent.shm.node``), so placement can move the task to
        its data instead of pulling bytes to an arbitrary worker. Head-host
        bytes (``node is None``) are reachable from every same-host node and
        carry no preference. Returns None when the spec has no args at all —
        the no-arg hot path stays allocation-free."""
        if not spec.get("args") and not spec.get("kwargs"):
            return None
        by_node = None
        for _kind, oid in _iter_arg_refs(spec):
            ent = self.objects.get(oid)
            if ent is None or ent.shm is None or ent.shm.node is None:
                continue
            if by_node is None:
                by_node = {}
            nid = ent.shm.node
            by_node[nid] = by_node.get(nid, 0) + (ent.size or 0)
        return by_node

    def _pick_node(self, spec: dict, res: Optional[dict] = None) -> Optional[NodeState]:
        if res is None:
            res = self._effective_resources(spec)
        strategy = spec.get("strategy")
        if strategy is None:
            # locality first: a task whose args' bytes already
            # sit on some node runs where its data lives — most bytes wins,
            # load breaks ties, infeasible byte-holders fall through to the
            # hybrid policy below
            loc_bytes = self._locality_bytes(spec)
            if loc_bytes:
                best = None
                best_key = None
                for nid, nbytes in loc_bytes.items():
                    n = self.nodes.get(nid)
                    if n is None or not n.alive or not n.can_fit(res):
                        continue
                    key = (-nbytes, n.utilization(res))
                    if best_key is None or key < best_key:
                        best, best_key = n, key
                self._loc_total += 1
                if best is not None:
                    self._loc_hits += 1
                _locality_gauge().set(self._loc_hits / self._loc_total)
                if best is not None:
                    return best
            # hot path (plain tasks, no placement constraint): first node in
            # stable order under the spread threshold — no alive-list or
            # feasible-list allocation, the common single/few-node case
            # resolves in one scan
            thr = GLOBAL_CONFIG.scheduler_spread_threshold
            best = None
            best_u = None
            for nid in self.node_order:
                n = self.nodes[nid]
                if not n.alive or not n.can_fit(res):
                    continue
                u = n.utilization(res)
                if u <= thr:
                    return n
                if best_u is None or u < best_u:
                    best, best_u = n, u
            return best
        alive = [self.nodes[nid] for nid in self.node_order if self.nodes[nid].alive]
        if not alive:
            return None
        if strategy and strategy[0] == "pg":
            _, pg_id, bundle_idx, _ = strategy
            pg = self.placement_groups.get(pg_id)
            if pg is None or pg.state != PG_CREATED:
                return None
            indices = [bundle_idx] if bundle_idx >= 0 else range(len(pg.bundles))
            for bi in indices:
                nid = pg.bundle_nodes[bi]
                if nid is None:
                    continue
                node = self.nodes[nid.binary()]
                avail = node.pg_reserved.get(pg_id, {}).get(bi, {})
                if node.alive and all(avail.get(k, 0.0) + 1e-9 >= v for k, v in res.items()):
                    spec["_pg_bundle"] = (pg_id, bi)
                    return node
            return None
        if strategy and strategy[0] == "node":
            _, node_hex, soft = strategy
            node = self.nodes.get(bytes.fromhex(node_hex))
            if node is not None and node.alive and node.can_fit(res):
                return node
            if not soft:
                return None
            # soft affinity falls through to default policy
        feasible = [n for n in alive if n.can_fit(res)]
        if not feasible:
            return None
        if strategy and strategy[0] == "labels":
            # node-label policy (reference: scheduling/policy node-label):
            # hard labels filter; soft labels prefer best-matching nodes
            _, hard, soft = strategy
            feasible = [
                n for n in feasible
                if all(n.labels.get(k) == v for k, v in hard)
            ]
            if not feasible:
                return None
            if soft:
                best = max(
                    sum(1 for k, v in soft if n.labels.get(k) == v) for n in feasible
                )
                feasible = [
                    n for n in feasible
                    if sum(1 for k, v in soft if n.labels.get(k) == v) == best
                ]
        if strategy and strategy[0] == "spread":
            return min(feasible, key=lambda n: (n.utilization(res), self.node_order.index(n.node_id.binary())))
        # hybrid: first node (stable order) under threshold, else least utilized
        thr = GLOBAL_CONFIG.scheduler_spread_threshold
        for n in feasible:
            if n.utilization(res) <= thr:
                return n
        return min(feasible, key=lambda n: n.utilization(res))

    def _allocate_for(self, rec, node: NodeState, res):
        bundle = rec["spec"].get("_pg_bundle")
        if bundle is not None:
            pg_id, bi = bundle
            avail = node.pg_reserved[pg_id][bi]
            for k, v in res.items():
                avail[k] = avail.get(k, 0.0) - v
        else:
            node.allocate(res)
        rec["alloc"] = (node.node_id.binary(), res, bundle)

    def _release_alloc(self, rec):
        alloc = rec.pop("alloc", None)
        if alloc is None:
            return
        self._sched_gen += 1  # capacity freed: blocked signatures may now fit
        nid, res, bundle = alloc
        node = self.nodes.get(nid)
        if node is None:
            return
        if bundle is not None:
            pg_id, bi = bundle
            reserved = node.pg_reserved.get(pg_id, {}).get(bi)
            if reserved is not None:
                for k, v in res.items():
                    reserved[k] = reserved.get(k, 0.0) + v
        else:
            node.release(res)
            self._retry_pending_pgs()

    def _startup_cap(self, node: NodeState) -> int:
        cap = GLOBAL_CONFIG.worker_startup_concurrency
        if cap > 0:
            return cap
        return max(int(node.resources_total.get("CPU", 1)), 2)

    def _booting_count(self, node: NodeState) -> int:
        """Workers booting on this node: handed to a spawn thread but not
        yet visible in all_workers (``node.dispatching``, counted
        SYNCHRONOUSLY by the dispatcher — the handle only appears after the
        multi-ms Popen, far too late to throttle a storm) plus spawned-but-
        unregistered handles."""
        with self.lock:
            return node.dispatching + len(
                [w for w in node.all_workers if w.alive and w.conn is None]
            )

    def _spawn_dispatch_loop(self):
        """Runs spawn thunks on fresh threads from OUTSIDE any lock (see
        _spawn_q comment in __init__). Throttles per-node startup
        concurrency: interpreter boot is CPU-bound, and an unbounded storm
        (100 actor creations at once) pushes every boot past the
        registration timeout (reference: maximum_startup_concurrency).
        Must never die: if the OS refuses a new thread, degrade to running
        the spawn inline (serialized but alive) rather than silently
        disabling all future spawning."""
        import traceback as _tb

        deferred: list = []
        while True:
            try:
                item = self._spawn_q.get(timeout=0.05 if deferred else None)
            except queue.Empty:
                item = False  # tick: only re-examine deferred spawns
            if item is None:
                return
            pending = deferred + ([item] if item is not False else [])
            deferred = []
            for fn, args, kwargs in pending:
                node = args[0]
                if not node.alive:
                    # node died while the spawn was queued: a dropped ACTOR
                    # spawn must still feed the actor FSM (its create rec is
                    # keyed in _actor_create_recs, invisible to node-death
                    # cleanup) or the actor's waiters hang forever
                    # NB: compare unbound functions — `fn is self._spawn_actor_worker`
                    # is always False (each attribute access builds a fresh
                    # bound-method object)
                    if getattr(fn, "__func__", None) is Head._spawn_actor_worker:
                        with self.lock:
                            self._on_actor_worker_death(args[1])
                            self._schedule()
                    else:
                        with self.lock:
                            node.spawning = max(0, node.spawning - 1)
                    continue
                if self._booting_count(node) >= self._startup_cap(node):
                    deferred.append((fn, args, kwargs))
                    continue
                with self.lock:
                    node.dispatching += 1  # released in _run_spawn_item
                try:
                    threading.Thread(
                        target=self._run_spawn_item,
                        args=(fn, node, args, kwargs),
                        daemon=True,
                    ).start()
                except RuntimeError:  # can't start new thread
                    try:
                        self._run_spawn_item(fn, node, args, kwargs)
                    except Exception:  # noqa: BLE001 - keep the dispatcher alive
                        _tb.print_exc()

    def _run_spawn_item(self, fn, node, args, kwargs):
        try:
            fn(*args, **kwargs)
        finally:
            # _spawn_worker returns right after the handle lands in
            # all_workers, so from here _booting_count sees the handle
            # instead of this counter
            with self.lock:
                node.dispatching = max(0, node.dispatching - 1)

    def _maybe_spawn(self, node: NodeState):
        cap = max(int(node.resources_total.get("CPU", 1)), 1)
        pool = (
            len([w for w in node.all_workers if w.alive and w.actor_id is None and w.conn is not None])
            + node.spawning
        )
        if node.assigned and pool < cap:
            node.spawning += 1
            self._spawn_q.put((self._spawn_worker, (node,), {}))

    # ------------------------------------------------------------ completion

    # ------------------------------------------------- streaming generators

    def _on_stream_item(self, wh: WorkerHandle, payload: dict):
        """A streaming task yielded one item: store its object and publish
        the index so blocked ``stream_next`` calls wake (reference:
        ReportGeneratorItemReturns, task_manager.cc)."""
        task_id = payload["task_id"]
        locator = self._normalize_locator(payload["locator"])
        with self.lock:
            self._store_locator(payload["obj_id"], locator)
            ent = self.objects.get(payload["obj_id"])
            if task_id in self._disposed_streams:
                # consumer walked away; the producer raced the cancel —
                # free the stored bytes immediately instead of leaking them
                if ent is not None:
                    self._maybe_evict(payload["obj_id"], ent)
                return
            st = self.streams.setdefault(
                task_id, {"items": {}, "count": None, "next": 0}
            )
            if ent is not None:
                ent.refcount += 1  # held by the stream until handed out/disposed
            st["items"][payload["index"]] = payload["obj_id"]
            self.cv.notify_all()

    def rpc_stream_next(self, task_id, index, timeout=None):
        """Blocking: ('item', obj_id) when the index exists; ('end', count)
        past the final item; ('error', completion_obj_id) when the task
        failed (the completion object holds the exception). Acks the
        consumed index to the producing worker for backpressure."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.lock:
            while True:
                if task_id in self._disposed_streams:
                    return ("end", 0)
                st = self.streams.get(task_id)
                if st is not None:
                    if index in st["items"]:
                        oid = st["items"][index]
                        st["next"] = max(st["next"], index + 1)
                        rec = self.tasks.get(task_id)
                        wh = rec.get("worker") if rec is not None else None
                        break
                    if st["count"] is not None and index >= st["count"]:
                        comp = st.get("completion")
                        if comp is not None:
                            ent = self.objects.get(comp)
                            if ent is not None and ent.is_error:
                                return ("error", comp)
                        return ("end", st["count"])
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise rex.GetTimeoutError(f"stream_next timed out on {TaskID(task_id)}")
                if self._shutdown:
                    raise rex.RayError("shutting down")
                self.cv.wait(timeout=min(remaining, 1.0) if remaining else 1.0)
        if wh is not None and wh.alive:
            wh.send(("stream_ack", {"task_id": task_id, "consumed": index + 1}))
        return ("item", oid)

    def rpc_stream_dispose(self, task_id):
        """Consumer dropped its generator: cancel the producer if it is
        still running and release items never handed out (reference:
        streaming generator cancellation + unconsumed-return GC)."""
        with self.lock:
            st = self.streams.pop(task_id, None)
            self._disposed_streams[task_id] = True
            while len(self._disposed_streams) > 4096:
                self._disposed_streams.pop(next(iter(self._disposed_streams)))
            running = task_id in self.tasks
            if st is not None:
                for idx, oid in st["items"].items():
                    if idx >= st["next"]:
                        ent = self.objects.get(oid)
                        if ent is not None:
                            ent.refcount -= 1
                            self._maybe_evict(oid, ent)
        if running:
            self.cancel_task(task_id, force=False)
        return True

    def _fail_stream_locked(self, spec: dict) -> None:
        """Lock held. A streaming task's producer died: cap the stream at
        what was produced and point completion at the stored error, so
        consumers drain then raise instead of blocking forever."""
        if spec.get("num_returns") != "streaming":
            return
        if spec["task_id"] in self._disposed_streams:
            return
        st = self.streams.setdefault(
            spec["task_id"], {"items": {}, "count": None, "next": 0}
        )
        if st["count"] is None:
            st["count"] = len(st["items"])
            st["completion"] = spec["return_ids"][0]

    def _finish_stream_locked(self, task_id: bytes, payload: dict):
        """task_done of a streaming task: record the final item count and
        where the completion object (error carrier) lives."""
        if task_id in self._disposed_streams:
            return
        st = self.streams.setdefault(task_id, {"items": {}, "count": None, "next": 0})
        st["count"] = payload.get("stream_count", len(st["items"]))
        results = payload.get("results") or []
        if results:
            st["completion"] = results[0][0]
        self.cv.notify_all()

    def _on_task_done(self, wh: WorkerHandle, payload: dict):
        # singular fast lane (the sync round trip): same receipt contract
        # as the batch path — reply_recv stamped before metrics/re-lay/
        # lock — without the list wrap and second scan
        wf = payload.get("wf")
        if wf is not None and len(wf) == len(_waterfall.PHASES) - 1:
            wf.append(time.time())
        _batch_metrics()["reply"].observe(1)
        results = payload.get("results")
        if results:
            for i, (rid, loc) in enumerate(results):
                nloc = self._normalize_locator(loc)
                if nloc is not loc:
                    results[i] = (rid, nloc)
        with self.lock:
            self._task_done_locked(wh, payload)
            self.cv.notify_all()
            self._schedule()

    def _on_task_done_batch(self, wh: WorkerHandle, payloads: list[dict]):
        """Workers batch completions when they have more queued work
        (worker_main _emit_done): one lock region, one wakeup, one
        scheduling pass per batch instead of per task."""
        now = None
        for payload in payloads:
            wf = payload.get("wf")
            if wf is not None and len(wf) == len(_waterfall.PHASES) - 1:
                # reply_recv stamps at RECEIPT — before metrics, the re-lay
                # scan, and the head lock — so the reply leg measures the
                # worker→head hop, not head-internal bookkeeping (fold
                # detects the already-closed list)
                if now is None:
                    now = time.time()
                wf.append(now)
        _batch_metrics()["reply"].observe(len(payloads))
        for payload in payloads:
            results = payload.get("results")
            if results:
                # big inline results re-lay into shm BEFORE taking the
                # lock; small locators pass through untouched (in-place —
                # no per-task list rebuild)
                for i, (rid, loc) in enumerate(results):
                    nloc = self._normalize_locator(loc)
                    if nloc is not loc:
                        results[i] = (rid, nloc)
        with self.lock:
            for payload in payloads:
                self._task_done_locked(wh, payload)
            self.cv.notify_all()
            self._schedule()

    def _task_done_locked(self, wh: WorkerHandle, payload: dict) -> None:
        task_id = payload["task_id"]
        if "stream_count" in payload:
            self._finish_stream_locked(task_id, payload)
        rec = self.tasks.pop(task_id, None)
        wf = payload.get("wf")
        if wf is not None:
            # reply_recv closes the waterfall: fold the sampled task's
            # stamps into the per-phase histograms + recent ring
            _waterfall.fold(wf, rec["spec"] if rec is not None else None)
        if wh is not None:
            self._worker_pop_done(wh, task_id)
        if rec is None:
            if wh is not None and not wh.queued_recs:
                self._worker_idle(wh)
            return
        # pipelined chain: the completed head's allocation passes to the
        # next leased follower instead of being released (it is now the
        # one running) — exact concurrent accounting, zero idle gap
        nxt = wh.queued_recs[0] if (wh is not None and wh.queued_recs) else None
        if nxt is not None and nxt.get("alloc") is None and rec.get("alloc") is not None:
            nxt["alloc"] = rec.pop("alloc")
            # a pipeline slot freed even though no resources released:
            # same-signature pending tasks can lease-dispatch now
            self._sched_gen += 1
        else:
            self._release_alloc(rec)
        self._unpin_deps(rec["spec"])
        for obj_id, locator in payload.get("results", []):
            self._store_locator(obj_id, locator)
            # remember how to recompute a lost copy (normal tasks only:
            # actor-method replay needs the actor's state at call time)
            if (
                not payload.get("results_error")
                and rec["spec"]["kind"] == "task"
                and GLOBAL_CONFIG.enable_lineage_reconstruction
            ):
                ent = self.objects.get(obj_id)
                if ent is not None:
                    ent.lineage = rec["spec"]
                    self._lineage_track(obj_id, rec["spec"])
        self._event(rec, "FINISHED" if not payload.get("results_error") else "FAILED")
        spec = rec["spec"]
        if spec.get("num_returns") == "streaming" and "stream_count" not in payload:
            # the task function itself failed before yielding anything:
            # close the stream so consumers surface the error
            self._finish_stream_locked(task_id, payload)
        if spec["kind"] == "actor_method":
            actor = self.actors.get(spec["actor_id"])
            if actor is not None:
                actor.inflight.pop(task_id, None)
        if wh is not None and wh.alive and not wh.queued_recs:
            self._worker_idle(wh)

    def _worker_pop_done(self, wh: WorkerHandle, task_id: bytes) -> None:
        """Lock held. Remove a completed task from the worker's dispatch
        FIFO (normally the head; out-of-order only after cancels)."""
        if wh.queued_recs and wh.queued_recs[0]["task_id"] == task_id:
            wh.queued_recs.popleft()
        elif wh.queued_recs:
            wh.queued_recs = deque(
                r for r in wh.queued_recs if r["task_id"] != task_id
            )
        wh.current_task = wh.queued_recs[0] if wh.queued_recs else None

    def _loc_is_local(self, loc) -> bool:
        """Does this shm locator live on the head's own host? (Simulated
        local nodes share the host; only agent nodes are truly remote.)"""
        if loc.node is None:
            return True
        n = self.nodes.get(loc.node)
        return n is None or n.agent is None

    def _release_loc(self, loc) -> None:
        """Free an object's backing wherever it lives: locally via the
        owner registry, or by routing a free_shm to the owning node's agent
        (reference: object directory + raylet-local frees)."""
        if self._loc_is_local(loc):
            self.shm_owner.unlink(loc)
            return
        node = self.nodes.get(loc.node)
        if node is not None and node.agent is not None and node.alive:
            node.agent.send(("free_shm", loc))

    def _store_locator(self, obj_id: bytes, locator, notify: bool = True):
        ent = self.objects.get(obj_id)
        if ent is None:
            ent = self.objects[obj_id] = ObjectEntry()
        kind, payload, is_err = locator
        if kind == "inline":
            ent.small = payload
            ent.size = len(payload)
        else:
            ent.shm = payload
            ent.size = payload.total_size
            events.emit(
                "core.object.locator",
                obj_id=obj_id,
                size=payload.total_size,
                node=payload.node,
                seg=payload.name,
            )
            if self._loc_is_local(payload):
                # only head-host bytes count toward this host's spill
                # watermark; agent-host objects live in THEIR arenas
                self._ensure_capacity(payload.total_size)
                self.shm_owner.register(payload)
        ent.last_access = time.monotonic()
        ent.is_error = is_err
        if notify:
            self._deps_ready(obj_id)
            self.cv.notify_all()

    def _unpin_deps(self, spec: dict):
        if not spec.get("args") and not spec.get("kwargs"):
            return
        for kind, obj_id in _iter_arg_refs(spec):
            ent = self.objects.get(obj_id)
            if ent is not None:
                ent.pins -= 1
                self._maybe_evict(obj_id, ent)

    def _store_error(self, obj_id: bytes, exc: Exception):
        sv = ser.serialize(exc)
        self._store_locator(obj_id, ("inline", sv.to_bytes(), True))

    def _finish_cancelled(self, rec):
        self._release_alloc(rec)
        self.tasks.pop(rec["task_id"], None)
        self._unpin_deps(rec["spec"])
        for rid in rec["spec"]["return_ids"]:
            self._store_error(rid, rex.TaskCancelledError())
        self.cv.notify_all()

    # --------------------------------------------------------------- failure

    def _health_loop(self):
        while not self._shutdown:
            time.sleep(GLOBAL_CONFIG.health_check_interval_s)
            if self._snapshot_path and time.monotonic() >= self._snapshot_due:
                self._snapshot_due = time.monotonic() + GLOBAL_CONFIG.gcs_snapshot_interval_s
                self._snapshot()
            try:
                self._reap_client_sessions()
            except Exception as e:
                # session cleanup must never kill the health loop
                warn_throttled("health loop: client session reap", e)
            with self.lock:
                # prune expired named-mutex leases (crashed holders whose
                # release never arrived) — unbounded growth otherwise
                now_m = time.monotonic()
                for mname in [
                    n for n, (_o, exp) in self._named_mutexes.items() if exp <= now_m
                ]:
                    del self._named_mutexes[mname]
            dead, reap, timed_out = [], [], []
            keep = GLOBAL_CONFIG.idle_worker_keep_alive_s
            reg_timeout = GLOBAL_CONFIG.worker_register_timeout_s
            now = time.monotonic()
            with self.lock:
                for node in self.nodes.values():
                    for wh in list(node.all_workers):
                        if (
                            wh.alive
                            and wh.proc is not None
                            and not wh.proc.is_alive()
                            and wh.conn is not None
                        ):
                            dead.append(wh)
                        elif (
                            wh.alive
                            and wh.conn is None
                            and reg_timeout > 0
                            and now - wh.created_at > reg_timeout
                        ):
                            # spawned but never registered: a process that
                            # wedged at interpreter start (or an agent-side
                            # spawn that crashed where we hold no handle).
                            # Kill + respawn instead of hanging its waiters
                            # forever (reference: worker_register_timeout_seconds,
                            # ray_config_def.h; worker_pool.h startup tokens).
                            timed_out.append(wh)
                        elif (
                            wh.alive
                            and wh.proc is not None
                            and not wh.proc.is_alive()
                            and wh.conn is None
                        ):
                            # local spawn died before registering: no point
                            # waiting out the registration deadline
                            timed_out.append(wh)
                        elif (
                            wh.alive
                            and wh.proc is None
                            and wh.conn is None
                            and reg_timeout <= 0
                            and now - wh.created_at > 60.0
                        ):
                            # registration timeout disabled: keep the legacy
                            # reap of agent-side spawns that crashed before
                            # connecting (no proc handle to poll)
                            dead.append(wh)
                    # Reap workers idle beyond the keep-alive (reference:
                    # worker_pool idle worker killing), but never while work
                    # is queued for the node.
                    if keep > 0 and not self.pending_sched and not node.assigned:
                        for wh in list(node.idle_workers):
                            if wh.actor_id is None and now - wh.idle_since > keep:
                                node.idle_workers.remove(wh)
                                node.all_workers.discard(wh)
                                wh.alive = False
                                reap.append(wh)
            for wh in reap:
                wh.send(("exit", None))
            for wh in dead:
                self._on_worker_dead(wh)
            for wh in timed_out:
                self._respawn_timed_out(wh)
            # refresh this host's /proc stats onto its (non-agent) nodes
            try:
                from ray_tpu_torch._private.reporter import node_stats

                stats = node_stats()
                with self.lock:
                    for n in self.nodes.values():
                        if n.agent is None:
                            n.stats = stats
            except Exception as e:
                warn_throttled("health loop: /proc stats refresh", e)
            # object-plane residency gauges: this host's arena /
            # spill bytes every tick; agent-node gauges refresh when a
            # ledger/audit rendezvous actually gathers their reports
            try:
                self._publish_object_gauges()
            except Exception as e:
                warn_throttled("health loop: object-plane gauges", e)
            # restored detached actors whose old workers never reconnected:
            # past the grace window, re-create them fresh (reference:
            # gcs_actor_manager restart of registered actors on failover)
            if (
                self._restored_actors
                and now - self._restore_time > GLOBAL_CONFIG.head_reconnect_grace_s
            ):
                with self.lock:
                    for aid in list(self._restored_actors):
                        self._restored_actors.discard(aid)
                        actor = self.actors.get(aid)
                        if (
                            actor is not None
                            and actor.state == ACTOR_RESTARTING
                            and actor.worker is None
                        ):
                            self._recreate_actor_locked(actor)
                    self._schedule()
            self.flush_outbox()

    def _respawn_timed_out(self, wh: WorkerHandle) -> None:
        """A spawned worker missed its registration deadline: kill it and
        retry the spawn (bounded), without charging the actor-restart budget
        — a wedge at interpreter start is an environment hiccup, not an
        application failure. On exhaustion an actor creation fails through
        the actor FSM; a pool slot's queued work goes back to the scheduler.
        Reference: worker_register_timeout_seconds (ray_config_def.h)
        + worker_pool.h startup-token accounting."""
        with self.lock:
            if wh.conn is not None or not wh.alive:
                return  # registered (or was reaped) before we acted
            wh.alive = False
            node = wh.node
            node.all_workers.discard(wh)
            if wh.token:
                # a racing late registration must match nothing and be told
                # to exit, not fall back to a fresh pool handle
                self._revoked_tokens[wh.token] = True
                while len(self._revoked_tokens) > 1024:
                    self._revoked_tokens.pop(next(iter(self._revoked_tokens)))
            actor_id = wh.actor_id
            attempts = wh.spawn_attempts + 1
            retry = node.alive and attempts <= GLOBAL_CONFIG.worker_spawn_retries
            if actor_id is None:
                # return the spawn slot; a retry re-claims it immediately so
                # _maybe_spawn doesn't double-spawn for the same queued work
                node.spawning = max(0, node.spawning - 1)
                if retry:
                    node.spawning += 1
        # kill only after the handle is dead and its token revoked (above):
        # registration can no longer win the race and then be shot
        if wh.proc is not None and wh.proc.is_alive():
            wh.proc.terminate()
        elif wh.proc is None and node.agent is not None and wh.token:
            node.agent.send(("kill_worker", {"token": wh.token}))
        print(
            f"[ray_tpu_torch] worker (attempt {attempts}) on node "
            f"{node.node_id.hex()[:8]} did not register within "
            f"{GLOBAL_CONFIG.worker_register_timeout_s}s; "
            + ("respawning" if retry else "giving up")
        )
        if retry:
            threading.Thread(
                target=self._spawn_worker,
                args=(node, actor_id),
                kwargs={"attempts": attempts},
                daemon=True,
            ).start()
        elif actor_id is not None:
            # exhausted: let the actor FSM decide (restart budget / fail refs)
            with self.lock:
                self._on_actor_worker_death(actor_id)
                self._schedule()
        else:
            # exhausted: hand this node's queued work back to the scheduler
            # so it can land on another node — or start a fresh spawn chain
            # here if this is the only one (never strand it in node.assigned,
            # which nothing re-examines)
            with self.lock:
                while node.assigned:
                    rec = node.assigned.popleft()
                    self._release_alloc(rec)
                    rec["state"] = "PENDING"
                    rec["node"] = None
                    self.pending_sched.append(rec)
                self._schedule()

    # ------------------------------------------------------- memory monitor

    def memory_usage_fraction(self) -> float:
        """Host memory usage in [0, 1]. Tests inject ``_memory_sampler``
        (reference: memory_monitor.h reads cgroup/proc the same way)."""
        sampler = getattr(self, "_memory_sampler", None)
        if sampler is not None:
            return sampler()
        try:
            with open("/proc/meminfo") as f:
                info = {}
                for line in f:
                    parts = line.split()
                    info[parts[0].rstrip(":")] = int(parts[1])
            total = info.get("MemTotal", 1)
            avail = info.get("MemAvailable", total)
            return 1.0 - avail / total
        except Exception:
            return 0.0

    def _memory_monitor_loop(self):
        """Kill a victim worker when host memory crosses the threshold
        (reference: ``memory_monitor.h:52`` + retriable-FIFO policy in
        ``worker_killing_policy_retriable_fifo.h:31``)."""
        interval = GLOBAL_CONFIG.memory_monitor_refresh_ms / 1000.0
        while not self._shutdown:
            time.sleep(interval)
            try:
                if self.memory_usage_fraction() < GLOBAL_CONFIG.memory_usage_threshold:
                    continue
                self._kill_for_memory()
                self.flush_outbox()  # requeued victims' redispatches
            except Exception as e:
                warn_throttled("memory monitor loop", e)

    def _kill_for_memory(self):
        with self.lock:
            candidates = [
                (wh, rec)
                for node in self.nodes.values()
                for wh in node.all_workers
                if wh.alive
                and (rec := wh.current_task) is not None
                and rec["spec"]["kind"] == "task"
            ]
            if not candidates:
                return
            # retriable-FIFO: prefer a victim whose task can retry; among
            # those, the most recently started (preserve older progress)
            def key(item):
                wh, rec = item
                retriable = rec.get("retries_left", 0) != 0
                return (retriable, rec.get("started_at", 0.0))

            wh, rec = max(candidates, key=key)
            rec["oom_killed"] = True
            self._event(rec, "OOM_KILLED")
        if wh.proc is not None:
            try:
                wh.proc.terminate()
            except Exception:
                pass
        else:
            wh.send(("exit", None))
        self._on_worker_dead(wh)

    def _on_worker_disconnect(self, wh: WorkerHandle):
        if wh.proc is not None and wh.proc.is_alive():
            # Graceful exit or crash; health loop would catch it, but react now.
            wh.proc.join(timeout=0.5)
        self._on_worker_dead(wh)

    def _on_worker_dead(self, wh: WorkerHandle):
        with self.lock:
            self._handle_worker_death_locked(wh)
            self._schedule()

    def _handle_worker_death_locked(self, wh: WorkerHandle):
        if not wh.alive:
            return
        wh.alive = False
        node = wh.node
        if wh.actor_id is None and wh.conn is None:
            # died before registering: return the spawn slot, or _maybe_spawn
            # under-counts the pool forever (worst case: node stops spawning)
            node.spawning = max(0, node.spawning - 1)
        node.all_workers.discard(wh)
        if wh in node.idle_workers:
            node.idle_workers.remove(wh)
        if wh.proc is not None:
            from ray_tpu_torch._private.reporter import reap_stack_file

            reap_stack_file(wh.proc.pid)
        # the whole dispatch FIFO dies with the worker. Only the HEAD of the
        # queue was executing — it is charged a retry (or failed). Pipelined
        # followers never ran an instruction: they requeue to the scheduler
        # free of charge (the reference likewise only charges attempts that
        # actually started).
        first = True
        for rec in list(wh.queued_recs):
            if rec["task_id"] in self.tasks and rec["spec"]["kind"] == "task":
                if first:
                    self.tasks.pop(rec["task_id"], None)
                    cause = (
                        rex.OutOfMemoryError(
                            f"Task {rec['spec'].get('name')} was killed by the memory "
                            f"monitor to relieve host memory pressure"
                        )
                        if rec.get("oom_killed")
                        else rex.WorkerCrashedError()
                    )
                    self._requeue_or_fail(rec, cause)
                else:
                    self._release_alloc(rec)
                    rec["state"] = "PENDING"
                    rec["worker"] = None
                    rec["spec"].pop("_pg_bundle", None)
                    self.pending_sched.append(rec)
            first = False
        wh.queued_recs.clear()
        wh.current_task = None
        if wh.actor_id is not None:
            self._on_actor_worker_death(wh.actor_id)

    def _requeue_or_fail(self, rec, error: Exception):
        """Lock held. Task retry semantics (reference task_manager.cc:
        ``max_retries`` for normal tasks; actor methods obey the actor's
        ``max_task_retries``)."""
        self._release_alloc(rec)
        spec = rec["spec"]
        if rec["task_id"] in self.cancelled:
            self._finish_cancelled(rec)
            return
        if spec["kind"] == "actor_method":
            # handled by the actor restart machinery
            return
        if rec["retries_left"] != 0:  # -1 = unlimited (reference max_retries)
            if rec["retries_left"] > 0:
                rec["retries_left"] -= 1
            rec["state"] = "PENDING"
            rec["worker"] = None
            rec.pop("oom_killed", None)  # fresh attempt, fresh failure cause
            spec.pop("_pg_bundle", None)
            self._event(rec, "RETRY")
            self.tasks[rec["task_id"]] = rec
            self.pending_sched.append(rec)
        else:
            self.tasks.pop(rec["task_id"], None)
            self._unpin_deps(spec)
            for rid in spec["return_ids"]:
                self._store_error(rid, error)
            self._fail_stream_locked(spec)
            self.cv.notify_all()

    # ---------------------------------------------------------------- actors

    def create_actor(self, spec: dict) -> None:
        with self.lock:
            actor = ActorState(spec["actor_id"], spec)
            key = actor.named_key
            if key and key in self.named_actors:
                # check BEFORE registering, so a duplicate name leaves no
                # orphan PENDING actor behind
                raise ValueError(
                    f"Actor name {actor.name!r} already taken in namespace "
                    f"{actor.namespace!r}"
                )
            self.actors[spec["actor_id"]] = actor
            if key:
                self.named_actors[key] = spec["actor_id"]
        self.submit_task(spec)

    def _start_actor_on(self, rec, node: NodeState):
        """Lock held. Actor creation got a node: adopt an idle pool worker
        when the env allows it, else spawn a dedicated worker.

        Adoption (reference: the raylet hands actor-creation leases to
        already-started pool workers — workers are generic processes there
        too) skips the whole spawn pipeline: the actor starts in one
        dispatch instead of interpreter boot + registration. Only a
        container env forces a dedicated cold spawn (the pool worker runs
        outside the requested image); conda/pip/env_vars apply in-worker at
        create time exactly as they would in a fresh process."""
        spec = rec["spec"]
        actor = self.actors[spec["actor_id"]]
        actor.node_id = node.node_id
        rec["state"] = "RUNNING"
        if not (spec.get("runtime_env") or {}).get("container"):
            while node.idle_workers:
                wh = node.idle_workers.pop()
                if (
                    wh.alive
                    and wh.conn is not None
                    and wh.actor_id is None
                    and not wh.queued_recs
                ):
                    wh.actor_id = spec["actor_id"]
                    self._dispatch_to_worker(wh, rec)
                    return
        # Keyed by actor id, NOT queued on node.assigned: only the dedicated
        # worker spawned for this actor may pick it up.
        self._actor_create_recs[spec["actor_id"]] = rec
        self._spawn_q.put((self._spawn_actor_worker, (node, spec["actor_id"]), {}))

    def _spawn_actor_worker(self, node: NodeState, actor_id: bytes):
        self._spawn_worker(node, actor_id=actor_id)

    def _on_actor_ready(self, wh: WorkerHandle, payload):
        actor_id = payload["actor_id"]
        with self.lock:
            actor = self.actors.get(actor_id)
            if actor is None:
                return
            if actor.state == ACTOR_DEAD:
                # killed while this spawn was in flight: NEVER resurrect —
                # the fallback re-reserve below would allocate resources no
                # kill will ever release. Tell the orphan worker to exit.
                self._enqueue_send(wh, ("exit",))
                return
            if payload.get("error") is not None:
                # __init__ raised: actor is DEAD, creation error propagates to
                # the creation "ready" object and all queued calls.
                self._kill_actor_locked(actor, payload["error"], restart=False)
                return
            actor.state = ACTOR_ALIVE
            self.publish("actors", {"event": "ALIVE", "actor_id": actor.actor_id.hex(), "name": actor.name})
            actor.worker = wh
            wh.actor_id = actor_id
            rec = self.tasks.pop(actor.create_spec["task_id"], None)
            if rec is not None:
                actor.alloc = rec.pop("alloc", None)
                self._event(rec, "FINISHED")
            elif actor.alloc is None:
                # reconnected after head restart: no create task carried an
                # allocation — re-reserve the actor's lifetime resources on
                # its node (may briefly oversubscribe right after failover)
                res = self._effective_resources(actor.create_spec)
                wh.node.allocate(res)
                actor.alloc = (wh.node.node_id.binary(), res, None)
            for rid in actor.create_spec["return_ids"]:
                sv = ser.serialize(None)
                self._store_locator(rid, ("inline", sv.to_bytes(), False))
            while actor.pending_calls:
                mspec = actor.pending_calls.popleft()
                self._send_actor_task(actor, mspec)
            self.cv.notify_all()

    def submit_actor_task(self, spec: dict) -> None:
        with self.lock:
            self._submit_actor_task_locked(spec)

    def _submit_actor_task_locked(self, spec: dict) -> None:
        for rid in spec["return_ids"]:  # submitter's refs (see submit_task)
            ent = self.objects.get(rid)
            if ent is None:
                ent = self.objects[rid] = ObjectEntry()
            ent.refcount += 1
        actor = self.actors.get(spec["actor_id"])
        if actor is None or actor.state == ACTOR_DEAD:
            cause = actor.death_cause if actor else "actor not found"
            for rid in spec["return_ids"]:
                self._store_error(rid, rex.ActorDiedError(msg=f"Actor is dead: {cause}"))
            return
        rec = {"task_id": spec["task_id"], "spec": spec, "state": "PENDING", "worker": None, "retries_left": actor.max_task_retries}
        self.tasks[spec["task_id"]] = rec
        # Pin ObjectRef args until completion (mirrors submit_task); the
        # actor worker fetches them at execution time.
        for _kind, payload in _iter_arg_refs(spec):
            ent = self.objects.get(payload)
            if ent is None:
                ent = self.objects[payload] = ObjectEntry()
            ent.pins += 1
        if actor.state == ACTOR_ALIVE:
            self._send_actor_task(actor, spec)
        else:
            actor.pending_calls.append(spec)

    def _send_actor_task(self, actor: ActorState, spec: dict):
        """Lock held. Actor calls reach the actor's worker in submission
        order: the outbox is per-worker FIFO and flush_outbox preserves it,
        so coalesced actor-call bursts ride one ``run_task_batch`` write
        (socket FIFO = the reference's sequential actor submit queue). A
        dead conn surfaces at flush as worker death, which runs the actor
        restart machinery — dispatch can no longer fail synchronously."""
        actor.inflight[spec["task_id"]] = spec
        rec = self.tasks.get(spec["task_id"])
        if rec is not None:
            rec["state"] = "RUNNING"
            rec["worker"] = actor.worker
        wf = spec.get("wf")
        if wf is not None:
            _waterfall.stamp(wf)  # head_dispatch: about to queue the send
        self._enqueue_send(actor.worker, ("run_task", spec))

    def _on_actor_worker_death(self, actor_id: bytes):
        """Lock held. Actor restart state machine (reference
        gcs_actor_manager.cc: restart if restarts remain, else mark DEAD and
        fail inflight + queued calls)."""
        actor = self.actors.get(actor_id)
        if actor is None or actor.state == ACTOR_DEAD:
            return
        inflight = list(actor.inflight.values())
        actor.inflight.clear()
        actor.worker = None
        self._actor_create_recs.pop(actor_id, None)
        self._release_alloc({"alloc": actor.alloc} if actor.alloc else {})
        actor.alloc = None
        if actor.restarts_left != 0:
            if actor.restarts_left > 0:
                actor.restarts_left -= 1
            actor.state = ACTOR_RESTARTING
            self.publish("actors", {"event": "RESTARTING", "actor_id": actor.actor_id.hex(), "name": actor.name})
            # inflight calls with retry budget left are re-queued ahead of new
            # calls; the rest fail (reference: max_task_retries per call,
            # -1 = unlimited)
            retry = []
            for s in inflight:
                rec = self.tasks.get(s["task_id"])
                left = rec["retries_left"] if rec is not None else 0
                if s.get("num_returns") == "streaming":
                    # never replay a stream: the consumer may have consumed
                    # items of the dead run already (same rule as tasks)
                    left = 0
                if left != 0:
                    if rec is not None and left > 0:
                        rec["retries_left"] -= 1
                    retry.append(s)
                else:
                    self.tasks.pop(s["task_id"], None)
                    self._unpin_deps(s)
                    for rid in s["return_ids"]:
                        self._store_error(rid, rex.RayActorError(msg="actor died; restarting"))
                    self._fail_stream_locked(s)
            for s in reversed(retry):
                actor.pending_calls.appendleft(s)
            self._recreate_actor_locked(actor)
        else:
            self._kill_actor_locked(actor, "worker died", restart=False, inflight=inflight)
        self.cv.notify_all()

    def _recreate_actor_locked(self, actor: ActorState) -> None:
        """Lock held. Queue a fresh creation task for a RESTARTING actor.

        If the worker died mid-creation, reap the in-flight create task:
        release its allocation and carry its return ids into the retry so
        they eventually resolve."""
        old_rec = self.tasks.pop(actor.create_spec["task_id"], None)
        if old_rec is not None:
            self._release_alloc(old_rec)
        cspec = dict(actor.create_spec)
        cspec["task_id"] = TaskID.from_random().binary()
        cspec["return_ids"] = actor.create_spec["return_ids"] if old_rec is not None else []
        # Future lookups (ready/kill) must see the re-creation task's id,
        # or its record + resource allocation leak forever.
        actor.create_spec = cspec
        rec = {"task_id": cspec["task_id"], "spec": cspec, "deps": set(), "state": "PENDING", "worker": None, "retries_left": 0}
        self.tasks[cspec["task_id"]] = rec
        self.pending_sched.append(rec)

    def _kill_actor_locked(self, actor: ActorState, cause, restart: bool, inflight=None):
        actor.state = ACTOR_DEAD
        self.publish("actors", {"event": "DEAD", "actor_id": actor.actor_id.hex(), "name": actor.name})
        actor.death_cause = str(cause)
        err = cause if isinstance(cause, Exception) else rex.ActorDiedError(msg=str(cause))
        for s in (inflight or []) + list(actor.inflight.values()) + list(actor.pending_calls):
            self.tasks.pop(s["task_id"], None)
            self._unpin_deps(s)
            for rid in s["return_ids"]:
                self._store_error(rid, err)
            self._fail_stream_locked(s)
        actor.inflight.clear()
        actor.pending_calls.clear()
        self._actor_create_recs.pop(actor.actor_id, None)
        self._release_alloc({"alloc": actor.alloc} if actor.alloc else {})
        actor.alloc = None
        rec = self.tasks.pop(actor.create_spec["task_id"], None)
        if rec is not None:
            self._release_alloc(rec)
            for rid in actor.create_spec["return_ids"]:
                self._store_error(rid, err)
        if actor.named_key and self.named_actors.get(actor.named_key) == actor.actor_id:
            del self.named_actors[actor.named_key]
        wh = actor.worker
        if wh is not None:
            wh.actor_id = None
            wh.alive = False
            if wh.proc is not None and wh.proc.is_alive():
                wh.proc.terminate()
        self.cv.notify_all()

    def kill_actor(self, actor_id: bytes, no_restart: bool = True):
        with self.lock:
            actor = self.actors.get(actor_id)
            if actor is None:
                return
            if no_restart:
                actor.restarts_left = 0
                self._kill_actor_locked(actor, "ray.kill", restart=False)
            else:
                wh = actor.worker
                if wh is not None and wh.proc is not None:
                    wh.proc.terminate()

    def remove_actor_handle(self, actor_id: bytes):
        """Driver-side handle count dropped; non-detached actors exit when the
        last handle dies (reference: actor GC via reference counting)."""
        with self.lock:
            actor = self.actors.get(actor_id)
            if actor is None:
                return
            actor.num_handles -= 1
            if actor.num_handles <= 0 and not actor.detached and actor.state != ACTOR_DEAD:
                actor.restarts_left = 0
                self._kill_actor_locked(actor, "all handles out of scope", restart=False)

    # -------------------------------------------------------------- objects

    def put_serialized(
        self, sv: ser.SerializedValue, is_error=False, take_ref=False
    ) -> bytes:
        obj_id = ObjectID.for_put().binary()
        self.put_at(obj_id, sv, is_error, take_ref=take_ref)
        return obj_id

    def put_at(
        self, obj_id: bytes, sv: ser.SerializedValue, is_error=False, take_ref=False
    ):
        # same zero-copy cutoff as runtime.store_value: with the
        # native arena up, driver puts above core_shm_inline_threshold go
        # straight to shm — consumers map them instead of copying them off
        # the control socket. Without the arena the old 100KB cutoff stands
        # (a dedicated segment per mid-size object costs more than inlining).
        threshold = (
            GLOBAL_CONFIG.core_shm_inline_threshold
            if self.arena_name is not None
            else GLOBAL_CONFIG.max_direct_call_object_size
        )
        if sv.total_size <= threshold:
            locator = ("inline", sv.to_bytes(), is_error)
        else:
            from ray_tpu_torch._private.runtime import _data_counters
            from ray_tpu_torch._private.shm_store import write_shm

            locator = ("shm", write_shm(sv), is_error)
            _data_counters()[0].inc(sv.total_size)
            events.emit(
                "core.object.put",
                obj_id=obj_id,
                size=sv.total_size,
                seg=locator[1].name,
            )
        with self.lock:
            # fresh put ids have no waiters (see rpc_put): skip the wakeup
            fresh = obj_id not in self.objects
            self._store_locator(obj_id, locator, notify=not fresh)
            if take_ref:
                self.objects[obj_id].refcount += 1

    def _pump_or_wait(self, t: float) -> None:
        """A getter with nothing to do yet either takes over the worker-IO
        pump (processing completions on ITS thread — the message that makes
        its object ready wakes no one else first) or, when another thread
        already pumps, parks on the condition variable. Single pump at a
        time via _pump_mutex; the IO thread defers while _pump_requests>0.
        Never called with the head lock held."""
        if self._outbox:
            # deferred dispatches (coalesced submits, lineage rebuilds) must
            # ride out BEFORE this thread parks waiting on their results
            self.flush_outbox()
        with self._pump_count_lock:
            self._pump_requests += 1
            self._last_pump = time.monotonic()
        try:
            # fast path: mutex free (IO thread parked in its sticky-grace
            # window) — no kick, no handoff, straight to the select
            acquired = self._pump_mutex.acquire(blocking=False)
            if not acquired:
                try:
                    os.write(self._io_wake_w, b"p")  # kick IO out of its select
                except OSError:
                    pass
                acquired = self._pump_mutex.acquire(timeout=min(t, 0.005))
            if not acquired:
                with self.lock:
                    self.cv.wait(timeout=t)
                return
            try:
                if self._shutdown:
                    return
                if not self._io_conns:
                    with self.lock:
                        self.cv.wait(timeout=min(t, 0.01))
                    return
                progressed = self._drain_io(
                    self._pump_sel, self._pump_registered, self._io_prog_r, t,
                    once=True, reg_gen=self._pump_reg_gen,
                )
                if progressed:
                    self.flush_outbox()
                    if self._pump_requests > 1:
                        # other getters wait behind the mutex/cv: what we
                        # just handled may be THEIR completion
                        try:
                            os.write(self._io_prog_w, b"g")
                        except OSError:
                            pass
            finally:
                self._pump_mutex.release()
        finally:
            with self._pump_count_lock:
                self._pump_requests -= 1
            # No _io_resume.set() here: waking the IO thread's waiter is a
            # futex wake (~50us) paid once per get. The IO thread self-wakes
            # from its 10ms park (_worker_io_loop), so the pump hand-back is
            # bounded-latency instead of immediate — a sync get loop pumps
            # its own completions and never needs the IO thread anyway.

    def get_locators(self, obj_ids: list[bytes], timeout: Optional[float]) -> list:
        if len(obj_ids) == 1:
            # single-ref get (the sync round-trip pattern): no index
            # machinery, one dict probe per readiness check
            oid = obj_ids[0]
            deadline = None if timeout is None else time.monotonic() + timeout
            objects = self.objects
            while True:
                with self.lock:
                    ent = objects.get(oid)
                    if ent is not None and ent.ready:
                        if ent.small is None and ent.shm is None:
                            self._restore_spilled(oid, ent)
                        if ent.ready:  # restore may fail INTO lineage rebuild
                            ent.last_access = ent.last_read = time.monotonic()
                            return [ent.locator()]
                    if self._shutdown:
                        raise rex.RayError("shutting down")
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise rex.GetTimeoutError(f"Get timed out on {ObjectID(oid)}")
                self._pump_or_wait(min(remaining, 0.05) if remaining else 0.05)
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        i = 0
        while True:
            with self.lock:
                while i < len(obj_ids):
                    oid = obj_ids[i]
                    ent = self.objects.get(oid)
                    if ent is not None and ent.ready:
                        if ent.small is None and ent.shm is None:
                            self._restore_spilled(oid, ent)  # transparent
                        if ent.ready:  # restore may fail INTO lineage
                            # reconstruction, which empties the entry — then
                            # keep waiting for the recomputed value instead
                            ent.last_access = ent.last_read = time.monotonic()
                            out.append(ent.locator())
                            i += 1
                            continue
                    break
                if i >= len(obj_ids):
                    return out
                if self._shutdown:
                    raise rex.RayError("shutting down")
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise rex.GetTimeoutError(f"Get timed out on {ObjectID(obj_ids[i])}")
            self._pump_or_wait(min(remaining, 0.05) if remaining else 0.05)

    def wait_objects(self, obj_ids: list[bytes], num_returns: int, timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self.lock:
                ready = [oid for oid in obj_ids if (e := self.objects.get(oid)) and e.ready]
                if len(ready) >= num_returns:
                    return ready
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return ready
            self._pump_or_wait(min(remaining, 0.05) if remaining else 0.05)

    def add_ref(self, obj_id: bytes):
        with self.lock:
            ent = self.objects.get(obj_id)
            if ent is None:
                ent = self.objects[obj_id] = ObjectEntry()
            ent.refcount += 1

    def remove_ref(self, obj_id: bytes):
        with self.lock:
            ent = self.objects.get(obj_id)
            if ent is None:
                return
            ent.refcount -= 1
            self._maybe_evict(obj_id, ent)

    def remove_refs(self, obj_ids: list) -> None:
        """Batched decrement (GC drains coalesce ref drops): one lock
        region for a whole burst of ``ObjectRef.__del__`` frees instead of
        a head round trip per dead ref."""
        with self.lock:
            for obj_id in obj_ids:
                ent = self.objects.get(obj_id)
                if ent is not None:
                    ent.refcount -= 1
                    self._maybe_evict(obj_id, ent)

    def _note_freed(self, obj_id: bytes, ent: ObjectEntry, reason: str) -> None:
        """Lock held. Forensic trail for an entry leaving the directory:
        the ``core.object.free`` event, the lifetime histogram observation,
        and the bounded freed ring ``obs objects`` shows."""
        age = max(0.0, time.time() - ent.created)
        _object_metrics()["age"].observe(age)
        self._freed_ring.append(
            (ObjectID(obj_id).hex(), ent.size, age, time.time(), reason)
        )
        events.emit(
            "core.object.free",
            obj_id=obj_id,
            size=ent.size,
            reason=reason,
        )

    def _maybe_evict(self, obj_id: bytes, ent: ObjectEntry):
        if ent.refcount <= 0 and ent.pins <= 0 and ent.ready:
            self.objects.pop(obj_id, None)
            self._note_freed(obj_id, ent, "refcount")
            if ent.shm is not None:
                self._release_loc(ent.shm)
            if ent.spill_path is not None:
                try:
                    os.unlink(ent.spill_path)
                except OSError:
                    pass

    # ------------------------------------------------------------- spilling

    def _spill_threshold(self) -> int:
        t = GLOBAL_CONFIG.object_spilling_threshold_bytes
        if t:
            return t
        return GLOBAL_CONFIG.object_store_memory or (2 << 30)

    def _spill_dir(self) -> str:
        d = os.path.join(os.path.dirname(self.socket_path), "spill")
        os.makedirs(d, exist_ok=True)
        return d

    def _ensure_capacity(self, incoming: int) -> None:
        """Lock held. Spill LRU shm objects to disk until ``incoming`` more
        bytes fit under the watermark (reference:
        ``raylet/local_object_manager.h:41-76`` spill-to-external-storage).
        Pinned objects (in-flight task args) are exempt; existing reader
        mappings survive the unlink — restore creates a fresh segment."""
        limit = self._spill_threshold()
        if self.shm_owner.bytes_used + incoming <= limit:
            return
        now = time.monotonic()
        victims = sorted(
            (
                (oid, e)
                for oid, e in self.objects.items()
                # grace window: a locator handed out moments ago may not be
                # attached yet — unlinking it would FileNotFoundError the
                # reader (clients also re-fetch on that error as a backstop)
                if e.shm is not None
                and e.pins <= 0
                and now - e.last_read > 5.0
                # agent-host objects can't be spilled from here (their bytes
                # live in another host's arena)
                and self._loc_is_local(e.shm)
            ),
            key=lambda kv: kv[1].last_access,
        )
        for oid, ent in victims:
            if self.shm_owner.bytes_used + incoming <= limit:
                break
            self._spill_one(oid, ent)

    def _spill_one(self, obj_id: bytes, ent: ObjectEntry) -> None:
        from ray_tpu_torch._private.shm_store import ShmReader

        try:
            reader = ShmReader(ent.shm)
            try:
                data = reader.read_serialized_bytes()
            finally:
                reader.close()
            path = os.path.join(self._spill_dir(), ObjectID(obj_id).hex())
            with open(path, "wb") as f:
                f.write(data)
        except Exception:
            return  # spill is best-effort; the object stays in shm
        events.emit(
            "core.object.spill", obj_id=obj_id, size=ent.size, path=path
        )
        _object_metrics()["spills"].inc()
        self.shm_owner.unlink(ent.shm)
        ent.shm = None
        ent.spill_path = path

    def _restore_spilled(self, obj_id: bytes, ent: ObjectEntry) -> None:
        """Lock held. Transparent restore on access (reference:
        ``local_object_manager`` restore path). A lost/corrupt spill file
        marks the object LOST (callers get ObjectLostError) instead of
        raising an opaque I/O error on every get forever."""
        from ray_tpu_torch._private.shm_store import write_shm

        try:
            with open(ent.spill_path, "rb") as f:
                data = f.read()
            sv = ser.SerializedValue.from_bytes(data)
        except Exception:
            ent.spill_path = None
            # rebuild via lineage; failure stores ObjectLostError on the entry
            self._reconstruct(obj_id, ent)
            return
        self._ensure_capacity(sv.total_size)
        ent.shm = write_shm(sv)
        self.shm_owner.register(ent.shm)
        events.emit(
            "core.object.restore",
            obj_id=obj_id,
            size=sv.total_size,
            seg=ent.shm.name,
        )
        try:
            os.unlink(ent.spill_path)
        except OSError:
            pass
        ent.spill_path = None

    def _lineage_spec_size(self, spec: dict) -> int:
        n = 512
        args = spec.get("args")
        kwargs = spec.get("kwargs")
        if not args and not kwargs:
            return n
        for a in list(args or ()) + list(kwargs.values() if kwargs else ()):
            if a[0] != "r":
                n += len(a[1])
        return n

    def _lineage_track(self, obj_id: bytes, spec: dict) -> None:
        """Lock held. Bound total retained lineage (reference: lineage
        total-size eviction, reference_count.h lineage pinning budget):
        over the cap, the oldest objects silently lose reconstructability."""
        size = self._lineage_spec_size(spec)
        self._lineage_fifo.append((obj_id, size))
        self._lineage_total += size
        cap = GLOBAL_CONFIG.max_lineage_bytes
        while self._lineage_total > cap and self._lineage_fifo:
            old_id, old_size = self._lineage_fifo.popleft()
            self._lineage_total -= old_size
            old = self.objects.get(old_id)
            if old is not None:
                old.lineage = None

    def _reconstruct(self, obj_id: bytes, ent: ObjectEntry) -> bool:
        """Lock held. Resubmit the creating task to rebuild a lost object
        (reference: ObjectRecoveryManager::RecoverObject,
        core_worker/object_recovery_manager.h:41). Returns True when a
        resubmission is queued/running — getters then block until the task
        stores fresh results. Fails (False) when an input of the creating
        task is itself gone without lineage."""
        spec = ent.lineage
        ent.small = None
        ent.shm = None
        ent.spill_path = None
        if spec is not None and spec["task_id"] in self.tasks:
            return True  # already being recomputed (another lost return)
        pinned: list = []
        failed = spec is None  # e.g. ray.put objects: no creating task
        for _kind, arg_id in (() if spec is None else _iter_arg_refs(spec)):
            arg = self.objects.get(arg_id)
            if arg is None:
                failed = True  # input gone without a record: unrecoverable
                break
            in_flight = any(
                arg_id in t["spec"]["return_ids"] for t in self.tasks.values()
            )
            if not arg.ready and not in_flight and not self._reconstruct(arg_id, arg):
                # recursive rebuild impossible (marked LOST below): this
                # task would wait on its arg forever — fail instead of hang
                failed = True
                break
            arg.pins += 1
            pinned.append(arg)
        if failed:
            for arg in pinned:  # no task queued: release this loop's pins
                arg.pins -= 1
            err = ser.serialize(
                rex.ObjectLostError(
                    ObjectID(obj_id).hex(), "object lost and not reconstructable"
                )
            )
            ent.small = err.to_bytes()
            ent.is_error = True
            ent.lineage = None
            return False
        rec = {
            "task_id": spec["task_id"],
            "spec": spec,
            "state": "PENDING",
            "worker": None,
            "retries_left": 0,
            "reconstruction": True,
        }
        self.tasks[spec["task_id"]] = rec
        self.pending_sched.append(rec)
        self._event(rec, "PENDING_ARGS_AVAIL")
        self._schedule()
        return True

    def rpc_report_lost(self, obj_ids):
        """A reader found an object's shm backing gone (segment unlinked /
        arena block recycled): verify, then reconstruct via lineage or mark
        LOST. The caller re-issues its get, which blocks until ready."""
        from ray_tpu_torch._private.shm_store import ShmReader

        # Verify before destroying anything: a report can also mean the
        # CALLER had a transient problem (unreachable data server, auth,
        # network) — freeing a healthy object on hearsay would turn a
        # blip into permanent loss for no-lineage (ray.put) objects.
        from ray_tpu_torch._private import data_plane

        foreign: list[tuple] = []
        with self.lock:
            lost: list[bytes] = []
            for oid in obj_ids:
                ent = self.objects.get(oid)
                if ent is None or ent.small is not None or ent.shm is None:
                    continue  # inline data or already being handled
                if self._loc_is_local(ent.shm):
                    try:
                        ShmReader(ent.shm).close()
                        continue  # backing is actually fine (caller raced)
                    except FileNotFoundError:
                        lost.append(oid)
                else:
                    node = self.nodes.get(ent.shm.node)
                    addr = node.data_address if node is not None else None
                    foreign.append((oid, addr, ent.shm))
            for oid in lost:
                ent = self.objects.get(oid)
                if ent is not None and ent.shm is not None:
                    events.emit(
                        "core.object.reap",
                        obj_id=oid,
                        size=ent.size,
                        node=ent.shm.node,
                        reason="backing-lost",
                    )
                    self._release_loc(ent.shm)
                    self._reconstruct(oid, ent)  # failure stores ObjectLostError
            self.cv.notify_all()
        if not foreign:
            return
        # probe owners OUTSIDE the lock (network), then act
        verdicts = []
        for oid, addr, loc in foreign:
            gone = (
                data_plane.stat(addr, self.authkey, loc) is False
                if addr is not None
                else False
            )
            # unreachable (None) or no address: leave it — if the node is
            # actually dead the health loop's remove_node purges its objects
            verdicts.append((oid, gone))
        with self.lock:
            for oid, gone in verdicts:
                if not gone:
                    continue
                ent = self.objects.get(oid)
                if ent is not None and ent.shm is not None:
                    events.emit(
                        "core.object.reap",
                        obj_id=oid,
                        size=ent.size,
                        node=ent.shm.node,
                        reason="owner-dropped",
                    )
                    self._release_loc(ent.shm)
                    self._reconstruct(oid, ent)
            self.cv.notify_all()

    def free_objects(self, obj_ids: list[bytes]):
        with self.lock:
            for oid in obj_ids:
                ent = self.objects.pop(oid, None)
                if ent is not None:
                    self._note_freed(oid, ent, "explicit-free")
                    if ent.shm is not None:
                        self._release_loc(ent.shm)

    # -------------------------------------------------------- task cancel

    def cancel_task(self, task_id: bytes, force: bool):
        with self.lock:
            rec = self.tasks.get(task_id)
            if rec is None:
                return
            self.cancelled.add(task_id)
            if rec["state"] in ("PENDING", "WAITING_DEPS"):
                self.tasks.pop(task_id, None)
                self._finish_cancelled(rec)
            elif rec["state"] in ("RUNNING", "ASSIGNED") and rec.get("worker") is not None:
                wh = rec["worker"]
                if force and wh.proc is not None:
                    wh.proc.terminate()
                else:
                    wh.send(("cancel", task_id))

    # ------------------------------------------------------------- functions

    def put_function(self, func_id: bytes, blob: bytes):
        with self.lock:
            self.functions[func_id] = blob

    def get_function(self, func_id: bytes) -> bytes:
        with self.lock:
            return self.functions[func_id]

    # ------------------------------------------------------- placement groups

    def create_pg(self, bundles: list[dict], strategy: str, name: str = "") -> bytes:
        pg_id = PlacementGroupID.from_random().binary()
        pg = PlacementGroupState(pg_id, bundles, strategy, name)
        with self.lock:
            self.placement_groups[pg_id] = pg
            self._try_place_pg(pg)
        return pg_id

    def _try_place_pg(self, pg: PlacementGroupState):
        """Lock held. Bundle placement (reference
        bundle_scheduling_policy.cc): STRICT_PACK = all bundles on one node;
        PACK = minimize nodes (greedy best-fit); SPREAD = prefer distinct
        nodes; STRICT_SPREAD = require distinct nodes. Placement is
        incremental: bundles still placed on alive nodes (after a partial node
        failure) keep their existing allocation; only unplaced bundles are
        assigned, all-or-nothing."""
        # bundles whose node is gone are unplaced; the rest keep their commit
        todo = [i for i, nid in enumerate(pg.bundle_nodes) if nid is None]
        if not todo:
            if pg.state != PG_CREATED:
                pg.state = PG_CREATED
                pg.ready_event.set()
                self._sched_gen += 1  # pg-strategy tasks may now place
                self.cv.notify_all()
            return
        alive = [self.nodes[nid] for nid in self.node_order if self.nodes[nid].alive]
        if not alive:
            return
        shadow = {n.node_id.binary(): dict(n.resources_avail) for n in alive}
        placed_nodes = {pg.bundle_nodes[i].binary() for i in range(len(pg.bundles)) if pg.bundle_nodes[i] is not None}

        def fits(nid, bundle):
            return all(shadow[nid].get(k, 0.0) + 1e-9 >= v for k, v in bundle.items() if v > 0)

        def take(nid, bundle):
            for k, v in bundle.items():
                shadow[nid][k] = shadow[nid].get(k, 0.0) - v

        assign: dict[int, bytes] = {}
        strategy = pg.strategy
        if strategy == "STRICT_PACK":
            # all bundles must share one node; surviving bundles pin it
            cands = (
                [n for n in alive if n.node_id.binary() in placed_nodes]
                if placed_nodes
                else alive
            )
            for n in cands:
                nid = n.node_id.binary()
                snap = dict(shadow[nid])
                ok = True
                for i in todo:
                    if fits(nid, pg.bundles[i]):
                        take(nid, pg.bundles[i])
                    else:
                        ok = False
                        break
                if ok:
                    assign = {i: nid for i in todo}
                    break
                shadow[nid] = snap
        else:
            used_nodes: set[bytes] = set(placed_nodes)
            order = sorted(todo, key=lambda i: -sum(pg.bundles[i].values()))
            for i in order:
                b = pg.bundles[i]
                cands = [n.node_id.binary() for n in alive if fits(n.node_id.binary(), b)]
                if strategy == "STRICT_SPREAD":
                    cands = [c for c in cands if c not in used_nodes]
                elif strategy == "SPREAD":
                    fresh = [c for c in cands if c not in used_nodes]
                    cands = fresh or cands
                elif strategy == "PACK":
                    packed = [c for c in cands if c in used_nodes]
                    cands = packed or cands
                if not cands:
                    assign = {}
                    break
                nid = cands[0]
                take(nid, b)
                used_nodes.add(nid)
                assign[i] = nid
        if len(assign) != len(todo):
            return  # stays PENDING; retried on node add / resource release
        # commit only the newly placed bundles
        for i in todo:
            node = self.nodes[assign[i]]
            b = pg.bundles[i]
            node.allocate(b)
            node.pg_reserved.setdefault(pg.pg_id, {})[i] = dict(b)
            pg.bundle_nodes[i] = node.node_id
        pg.state = PG_CREATED
        pg.ready_event.set()
        self.cv.notify_all()

    def _retry_pending_pgs(self):
        """Lock held. Re-attempt placement of PENDING groups when capacity
        appears (node added, resources released)."""
        for pg in self.placement_groups.values():
            if pg.state == PG_PENDING:
                self._try_place_pg(pg)

    def remove_pg(self, pg_id: bytes):
        with self.lock:
            pg = self.placement_groups.pop(pg_id, None)
            if pg is None:
                return
            pg.state = PG_REMOVED
            for i, nid in enumerate(pg.bundle_nodes):
                if nid is None:
                    continue
                node = self.nodes.get(nid.binary())
                if node is None:
                    continue
                node.pg_reserved.get(pg_id, {}).pop(i, None)
                if not node.pg_reserved.get(pg_id):
                    node.pg_reserved.pop(pg_id, None)
                node.release(pg.bundles[i])
            self._sched_gen += 1
            self._retry_pending_pgs()
            self._schedule()

    def pg_ready_wait(self, pg_id: bytes, timeout: Optional[float]) -> bool:
        with self.lock:
            pg = self.placement_groups.get(pg_id)
        if pg is None:
            raise ValueError("placement group removed")
        return pg.ready_event.wait(timeout)

    # ------------------------------------------------------------------ rpcs
    # Thin adapters so worker processes hit the same logic over the socket.

    def _normalize_locator(self, locator):
        """Big inline payloads (remote worker puts/results over the socket)
        re-lay into this node's shm so local readers stay zero-copy and the
        head's heap doesn't hold object data. Runs OUTSIDE the head lock —
        it's a full memcpy of the object."""
        kind, payload, is_err = locator
        if kind == "inline" and len(payload) > GLOBAL_CONFIG.max_direct_call_object_size:
            from ray_tpu_torch._private.shm_store import write_shm

            sv = ser.SerializedValue.from_bytes(payload)
            return ("shm", write_shm(sv), is_err)
        return locator

    # ---------------------------------------------------------------- pubsub

    def _conn_lock(self, conn) -> threading.Lock:
        wh = self._conn_worker.get(conn)
        if wh is not None:
            return wh.send_lock
        lock = self._pub_locks.get(id(conn))
        if lock is None:
            lock = self._pub_locks.setdefault(id(conn), threading.Lock())
        return lock

    def _rpc_subscribe(self, conn, channel):
        with self.lock:
            self._subs.setdefault(channel, []).append(("conn", conn))

    def _rpc_unsubscribe(self, conn, channel):
        with self.lock:
            sinks = self._subs.get(channel, [])
            self._subs[channel] = [s for s in sinks if s != ("conn", conn)]

    def subscribe_local(self, channel: str, fn) -> None:
        """In-process subscription (the driver shares this process)."""
        with self.lock:
            self._subs.setdefault(channel, []).append(("fn", fn))

    def unsubscribe_local(self, channel: str, fn) -> None:
        with self.lock:
            sinks = self._subs.get(channel, [])
            self._subs[channel] = [s for s in sinks if s != ("fn", fn)]

    def publish(self, channel: str, payload) -> None:
        """Queue a message for every subscriber of ``channel`` (reference:
        src/ray/pubsub/publisher.h — GCS-push counterpart). Delivery happens
        on a dedicated publisher thread: callers frequently hold the head
        lock, and a blocking send to one slow subscriber must never stall
        the control plane."""
        self._pub_queue.put((channel, payload))

    rpc_publish = publish

    def _publisher_loop(self) -> None:
        while True:
            item = self._pub_queue.get()
            if item is None:
                return
            channel, payload = item
            with self.lock:
                sinks = list(self._subs.get(channel, ()))
            dead = []
            for kind, sink in sinks:
                if kind == "fn":
                    try:
                        sink(channel, payload)
                    except Exception as e:
                        warn_throttled(f"publisher loop: subscriber on {channel}", e)
                    continue
                try:
                    with self._conn_lock(sink):
                        sink.send(("pub", channel, payload))
                except Exception:
                    dead.append((kind, sink))
            if dead:
                with self.lock:
                    self._subs[channel] = [
                        s for s in self._subs.get(channel, []) if s not in dead
                    ]

    # ------------------------------------------------------------- snapshot

    def _snapshot(self) -> None:
        """Persist restartable head state (reference: GCS table storage —
        gcs_table_storage.cc + gcs_init_data.cc reloading every table on
        failover). Scope:

        * KV (carries the job table) + function table,
        * DETACHED actors (create spec + restart budget — their workers
          outlive the head and reconnect; non-detached actors die with
          their driver anyway),
        * placement groups (re-placed as nodes reattach),
        * the object directory for entries whose BYTES survive a head
          crash: spilled files, agent-host objects, and head-host shm
          (/dev/shm persists across a head process crash; only a clean
          shutdown unlinks it) plus the arena name for re-attach.
        """
        path = self._snapshot_path
        if not path:
            return
        import pickle as _pickle

        with self.lock:
            actors = {
                aid: {
                    "create_spec": a.create_spec,
                    "restarts_left": a.restarts_left,
                    "max_task_retries": a.max_task_retries,
                    "num_handles": a.num_handles,
                }
                for aid, a in self.actors.items()
                if a.detached and a.state != ACTOR_DEAD
            }
            pgs = {
                pg_id: {"bundles": pg.bundles, "strategy": pg.strategy, "name": pg.name}
                for pg_id, pg in self.placement_groups.items()
                if pg.state != PG_REMOVED
            }
            objects = {}
            for oid, e in self.objects.items():
                if not e.ready:
                    continue
                rec = {"refcount": e.refcount, "size": e.size, "is_error": e.is_error}
                if e.spill_path is not None:
                    rec["spill_path"] = e.spill_path
                elif e.shm is not None:
                    rec["shm"] = e.shm
                elif e.small is not None and len(e.small) <= 65536:
                    rec["small"] = e.small
                else:
                    continue
                objects[oid] = rec
            blob = _pickle.dumps(
                {
                    "version": 2,
                    "kv": dict(self.kv),
                    "functions": dict(self.functions),
                    "actors": actors,
                    "placement_groups": pgs,
                    "objects": objects,
                    "arena_name": self.arena_name,
                }
            )
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _load_snapshot(self) -> None:
        path = self._snapshot_path
        if not path or not os.path.exists(path):
            return
        import pickle as _pickle

        try:
            with open(path, "rb") as f:
                data = _pickle.loads(f.read())
        except Exception:
            return  # a torn snapshot must not block cluster start
        try:
            self.kv.update(data.get("kv", {}))
            self.functions.update(data.get("functions", {}))
            # detached actors come back RESTARTING: a surviving worker
            # reconnects and rebinds (state preserved); otherwise the next
            # node registration triggers a fresh create (state lost, like a
            # reference actor restart)
            for aid, rec in data.get("actors", {}).items():
                actor = ActorState(aid, rec["create_spec"])
                actor.restarts_left = rec.get("restarts_left", 0)
                actor.max_task_retries = rec.get("max_task_retries", 0)
                actor.num_handles = rec.get("num_handles", 1)
                actor.state = ACTOR_RESTARTING
                self.actors[aid] = actor
                if actor.named_key:
                    self.named_actors[actor.named_key] = aid
                self._restored_actors.add(aid)
            for pg_id, rec in data.get("placement_groups", {}).items():
                pg = PlacementGroupState(
                    pg_id, rec["bundles"], rec["strategy"], rec["name"]
                )
                pg.bundle_nodes = [None] * len(rec["bundles"])
                self.placement_groups[pg_id] = pg
            from ray_tpu_torch._private.shm_store import ShmReader as _ShmReader

            for oid, rec in data.get("objects", {}).items():
                ent = ObjectEntry()
                ent.refcount = max(rec.get("refcount", 0), 1)
                ent.size = rec.get("size", 0)
                ent.is_error = rec.get("is_error", False)
                ent.spill_path = rec.get("spill_path")
                ent.shm = rec.get("shm")
                ent.small = rec.get("small")
                if ent.spill_path or ent.shm is not None or ent.small is not None:
                    self.objects[oid] = ent
                    if ent.shm is not None:
                        # node table is empty at restore time, so locality
                        # can't be judged from loc.node — probe instead:
                        # only segments attachable on THIS host count
                        # toward its spill accounting
                        try:
                            _ShmReader(ent.shm).close()
                            self.shm_owner.register(ent.shm)
                        except FileNotFoundError:
                            pass  # foreign host's bytes (or gone)
            prev_arena = data.get("arena_name")
            if prev_arena and self.arena_name is None:
                from ray_tpu_torch._private import shm_store as _shm

                if _shm.attach_arena(prev_arena) is not None:
                    self.arena_name = prev_arena
                    _shm.set_write_arena(prev_arena)
        except Exception:
            import traceback as _tb

            _tb.print_exc()  # partial restore is better than none

    def rpc_put(self, obj_id, small, shm, is_error=False, take_ref=False, replay=False):
        """Store a put. Returns True when the delivery was APPLIED (stored,
        or its failure stored as an error on the id) and False when a
        replay-flagged redelivery was ignored as a duplicate — callers use
        that to track side effects (session refs) exactly once."""
        try:
            if replay:
                # redelivery after a client reconnect: the original window
                # may have been processed before the conn dropped (only the
                # ack was lost). Put ids are minted once per op, so a value
                # already on the id means THIS put landed — applying again
                # would double-count take_ref.
                with self.lock:
                    ent0 = self.objects.get(obj_id)
                    if ent0 is not None and (
                        ent0.small is not None or ent0.shm is not None or ent0.spill_path
                    ):
                        return False
            locator = ("inline", small, is_error) if small is not None else ("shm", shm, is_error)
            locator = self._normalize_locator(locator)  # big memcpy outside lock
            with self.lock:
                # a FIRST-time put id can have no waiters or queued deps: the
                # head reads each conn in order, so no other party can have
                # learned the id before the put itself landed — skip the
                # notify_all, which otherwise wakes every parked get once
                # per put in a burst (1-core ping-pong). Re-puts (lineage
                # restore, retry) keep the wakeup.
                fresh = obj_id not in self.objects
                self._store_locator(obj_id, locator, notify=not fresh)
                if take_ref:
                    # the caller's ObjectRef refcount, folded into the put
                    # itself: one head round trip per ray.put, not two
                    self.objects[obj_id].refcount += 1
            return True
        except Exception as e:  # noqa: BLE001
            # never raise: async (fire-and-forget) putters have no reply to
            # carry the error, and a raise would strand their get() in the
            # not-yet-arrived wait — the failure lands ON the object id
            with self.lock:
                self._store_error(obj_id, e)
                if take_ref:
                    self.objects[obj_id].refcount += 1
            return True

    def rpc_get(self, obj_ids, timeout=None):
        return self.get_locators(obj_ids, timeout)

    def rpc_wait(self, obj_ids, num_returns, timeout=None):
        return self.wait_objects(obj_ids, num_returns, timeout)

    def rpc_submit_task(self, spec):
        self.submit_task(spec)
        return True

    def rpc_create_actor(self, spec):
        self.create_actor(spec)
        return True

    def rpc_submit_actor_task(self, spec):
        self.submit_actor_task(spec)
        return True

    def rpc_kill_actor(self, actor_id, no_restart=True):
        self.kill_actor(actor_id, no_restart)
        return True

    def rpc_cancel_task(self, task_id, force=False):
        self.cancel_task(task_id, force)
        return True

    def rpc_put_function(self, func_id, blob):
        self.put_function(func_id, blob)
        return True

    def rpc_get_function(self, func_id):
        return self.get_function(func_id)

    def rpc_get_actor_named(self, name, timeout=0.0, namespace=None):
        """Namespace-scoped lookup. Falls back to the "default" namespace
        ONLY for detached actors: detached = cluster-scoped services (serve
        controller, job supervisors, collective stores) that every client
        session must find, while regular named actors stay invisible across
        session namespaces (reference: namespaces + detached lifetimes)."""
        ns = namespace or "default"
        deadline = time.monotonic() + (timeout or 0.0)
        with self.lock:
            while True:
                aid = self.named_actors.get(f"{ns}:{name}")
                if aid is None and ns != "default":
                    cand = self.named_actors.get(f"default:{name}")
                    if cand is not None and self.actors[cand].detached:
                        aid = cand
                if aid is not None:
                    return aid, self.actors[aid].create_spec.get("methods", {})
                if time.monotonic() >= deadline:
                    raise ValueError(
                        f"Failed to look up actor with name '{name}'"
                    )
                self.cv.wait(timeout=0.1)

    def rpc_actor_state(self, actor_id):
        with self.lock:
            a = self.actors.get(actor_id)
            return None if a is None else a.state

    def rpc_actor_inc_handle(self, actor_id):
        with self.lock:
            a = self.actors.get(actor_id)
            if a is not None:
                a.num_handles += 1
        return True

    def rpc_actor_dec_handle(self, actor_id):
        self.remove_actor_handle(actor_id)
        return True

    def rpc_mutex_acquire(self, name, owner, timeout=None, lease_s=300.0):
        """Cluster-wide named mutex with a LEASE (reference capability:
        workflow storage coordination; here the primitive virtual actors
        serialize their read-modify-write transactions on, replacing the
        fcntl file lock that silently degrades on NFS/cloud storage).
        A crashed holder's lease expires instead of wedging the name
        forever; re-acquiring with the same owner token renews."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.lock:
            while True:
                now = time.monotonic()
                cur = self._named_mutexes.get(name)
                if cur is None or cur[1] <= now or cur[0] == owner:
                    self._named_mutexes[name] = (owner, now + float(lease_s))
                    return True
                if deadline is not None and now >= deadline:
                    return False
                # wait until the holder's lease would expire (release
                # notifies sooner) — a fixed poll would wake every waiter
                # 20x/s on the head's global lock for nothing
                bound = cur[1] - now
                if deadline is not None:
                    bound = min(bound, deadline - now)
                self.cv.wait(timeout=max(bound, 0.01))

    def rpc_mutex_release(self, name, owner):
        with self.lock:
            cur = self._named_mutexes.get(name)
            if cur is not None and cur[0] == owner:
                del self._named_mutexes[name]
                self.cv.notify_all()
                return True
            return False

    # -- metric time series + SLO alerts (observability plane) -------------

    def _series_store(self):
        """Lazy SeriesStore: bounded per-process metric history, fed by
        every process's metrics flusher (``series_push``) alongside the KV
        snapshot mailbox. Guarded by its own lock — the hot scheduling path
        must never contend with observability pushes."""
        store = self._metric_series
        if store is None:
            from ray_tpu_torch.util.metrics import SeriesStore

            with self.lock:
                if self._metric_series is None:
                    self._metric_series = SeriesStore()
                store = self._metric_series
        return store

    def _alert_manager(self):
        mgr = self._alerts
        if mgr is None:
            from ray_tpu_torch._private.alerts import AlertManager

            with self.lock:
                if self._alerts is None:
                    self._alerts = AlertManager()
                mgr = self._alerts
        return mgr

    def rpc_series_push(self, proc, interval, series):
        self._series_store().push(proc, interval, series)
        return True

    def rpc_series_get(self, name=None):
        """Raw per-process series (the drain format);
        ``util.metrics.collect_series`` merges client-side with the same
        function the head's own alert evaluator uses."""
        return self._series_store().raw(name)

    def rpc_alerts(self, eval_now=False):
        """The SLO rule engine's current state. ``eval_now`` forces one
        evaluation pass against the freshly merged series (obs alerts
        --eval-once; tests) instead of waiting for the evaluator tick."""
        mgr = self._alert_manager()
        if eval_now:
            mgr.evaluate(self._series_store().merged())
        return mgr.state()

    def _alerts_loop(self):
        import os as _os

        try:
            interval = max(
                1.0, float(_os.environ.get("RAY_TPU_ALERTS_INTERVAL_S", "15"))
            )
        except ValueError:
            interval = 15.0
        while not self._shutdown:
            time.sleep(interval)
            try:
                self._alert_manager().evaluate(self._series_store().merged())
            except Exception as e:
                # the evaluator must never die with the cluster still up —
                # a broken rule would otherwise silently end all alerting
                warn_throttled("head alert evaluator", e)

    def rpc_kv_put(self, key, value):
        with self.lock:
            self.kv[key] = value
        return True

    def rpc_kv_get(self, key):
        with self.lock:
            return self.kv.get(key)

    def rpc_kv_del(self, key):
        with self.lock:
            return self.kv.pop(key, None) is not None

    def rpc_kv_keys(self, prefix=""):
        with self.lock:
            return [k for k in self.kv if k.startswith(prefix)]

    def rpc_create_pg(self, bundles, strategy, name=""):
        return self.create_pg(bundles, strategy, name)

    def rpc_remove_pg(self, pg_id):
        self.remove_pg(pg_id)
        return True

    def rpc_pg_ready(self, pg_id, timeout=None):
        return self.pg_ready_wait(pg_id, timeout)

    def rpc_add_ref(self, obj_id):
        self.add_ref(obj_id)
        return True

    def rpc_free_ref(self, obj_id):
        self.remove_ref(obj_id)
        return True

    def rpc_free_refs(self, obj_ids):
        self.remove_refs(obj_ids)
        return True

    def rpc_tcp_address(self):
        return self.tcp_address

    def rpc_auth_info(self):
        """Authkey (hex) for attach-back flows (job entrypoints). Callers of
        this RPC already authenticated with the same key — no escalation."""
        return self.authkey.hex()

    def rpc_borrow_begin(self, obj_id, nonce):
        """A ref is being serialized: hold one count for the transit window,
        tagged so the deserializer can claim (not double-count) it
        (reference: borrower bookkeeping, ``reference_count.h:61-115``)."""
        with self.lock:
            ent = self.objects.get(obj_id)
            if ent is None:
                ent = self.objects[obj_id] = ObjectEntry()
            ent.refcount += 1
            if ent.borrow_nonces is None:
                ent.borrow_nonces = set()
            ent.borrow_nonces.add(nonce)
        return True

    def rpc_borrow_claim(self, obj_id, nonce):
        """A deserialized ref came alive. First claim of a nonce inherits
        the transit count; later claims of the same nonce (the same pickle
        deserialized again, e.g. a retried task's args) each add their own
        count. Every claimed holder releases via free_ref on GC."""
        with self.lock:
            ent = self.objects.get(obj_id)
            if ent is None:
                ent = self.objects[obj_id] = ObjectEntry()
            if ent.borrow_nonces and nonce in ent.borrow_nonces:
                ent.borrow_nonces.discard(nonce)  # transit count transfers
            else:
                ent.refcount += 1
        return True

    def rpc_free(self, obj_ids):
        self.free_objects(obj_ids)
        return True

    def rpc_cluster_resources(self):
        with self.lock:
            out: dict[str, float] = {}
            for n in self.nodes.values():
                if n.alive:
                    for k, v in n.resources_total.items():
                        out[k] = out.get(k, 0.0) + v
            return out

    def rpc_available_resources(self):
        with self.lock:
            out = {}
            for n in self.nodes.values():
                if n.alive:
                    for k, v in n.resources_avail.items():
                        out[k] = out.get(k, 0.0) + v
            return out

    def rpc_nodes(self):
        with self.lock:
            return [
                {
                    "NodeID": n.node_id.hex(),
                    "Alive": n.alive,
                    "Resources": dict(n.resources_total),
                    "Available": dict(n.resources_avail),
                    "Labels": dict(n.labels),
                }
                for n in self.nodes.values()
            ]

    def rpc_list_tasks(self):
        with self.lock:
            return [
                {"task_id": ObjectID(r["task_id"]).hex() if len(r["task_id"]) == 16 else r["task_id"].hex(), "name": r["spec"].get("name"), "state": r["state"]}
                for r in self.tasks.values()
            ]

    def rpc_list_actors(self):
        with self.lock:
            names = {0: "PENDING", 1: "RESTARTING", 2: "ALIVE", 3: "DEAD"}
            return [
                {
                    "actor_id": ActorID(a.actor_id).hex(),
                    "state": names[a.state],
                    "name": a.name,
                    "class_name": a.create_spec.get("class_name"),
                    "node_id": a.node_id.hex() if a.node_id else None,
                }
                for a in self.actors.values()
            ]

    def rpc_list_objects(self):
        def where(e):
            if e.small is not None:
                return "inline"
            if e.shm is not None:
                return "shm"
            if e.spill_path is not None:
                return "spilled"
            return "pending"

        with self.lock:
            return [
                {
                    "object_id": ObjectID(oid).hex(),
                    "size": e.size,
                    "ready": e.ready,
                    "where": where(e),
                    "refcount": e.refcount,
                    "pins": e.pins,
                }
                for oid, e in self.objects.items()
            ]

    def rpc_node_stats(self):
        """Per-node /proc stats (reporter.node_stats samples — the head's
        health loop covers its host; agents push theirs)."""
        with self.lock:
            return {
                n.node_id.hex(): dict(n.stats) for n in self.nodes.values() if n.alive
            }

    def rpc_worker_stacks(self, timeout: float = 5.0):
        """All-thread stack dumps of every worker in the cluster (SIGUSR1 →
        faulthandler; reference: the dashboard's py-spy stack dumps). Works
        on wedged workers — the handler is C-level and needs no GIL."""
        import uuid as _uuid

        from ray_tpu_torch._private.reporter import dump_pids

        deadline = time.monotonic() + timeout
        local_pids: list[int] = []
        agents = []
        with self.lock:
            for node in self.nodes.values():
                if not node.alive:
                    continue
                if node.agent is not None:
                    agents.append((node.node_id.hex(), node.agent))
                else:
                    local_pids.extend(
                        wh.proc.pid
                        for wh in node.all_workers
                        # registered only: pre-registration processes may not
                        # have armed the handler yet (dump_pids also refuses
                        # to signal unarmed pids as a second guard)
                        if wh.proc is not None and wh.proc.is_alive() and wh.conn is not None
                    )
        out: dict[str, dict] = {}
        req_ids = {}
        for node_hex, agent in agents:
            rid = _uuid.uuid4().hex
            if agent.send(("dump_workers", {"req_id": rid})):
                req_ids[rid] = node_hex
            else:
                out[node_hex] = {"error": "agent unreachable"}
        local = dump_pids(
            sorted(set(local_pids)),
            timeout=max(min(3.0, deadline - time.monotonic()), 0.1),
        )
        out["local"] = {str(pid): text for pid, text in local.items()}
        with self._stacks_cv:
            while req_ids and time.monotonic() < deadline:
                done = [r for r in req_ids if r in self._stacks_replies]
                for rid in done:
                    node_hex = req_ids.pop(rid)
                    out[node_hex] = {
                        str(p): t for p, t in self._stacks_replies.pop(rid).items()
                    }
                if req_ids:
                    self._stacks_cv.wait(timeout=0.2)
        for rid, node_hex in req_ids.items():
            out[node_hex] = {"error": "no reply within timeout"}
        return out

    def _broadcast_rendezvous(self, msg_kind: str, payload: dict,
                              deadline: float) -> dict:
        """Fan ``(msg_kind, payload + req_id)`` out to every live
        registered worker and gather the replies posted to the stacks
        mailbox until ``deadline``.  One req_id per NODE (its workers
        merge into one mailbox entry), which keeps the 64-entry mailbox
        bound a per-node bound, not per-worker.  Returns ``{node_hex:
        {pid: reply}}``; nodes with missing workers additionally carry an
        ``_errors`` list (a distinct key shape from pids, so callers
        iterating pids never trip on it) — partial coverage is reported,
        never silently assumed total.  Shared by ``rpc_worker_profile``
        and ``rpc_collect_events``."""
        import uuid as _uuid

        req_ids: dict[str, tuple[str, int]] = {}  # rid -> (node_hex, expected)
        with self.lock:
            for node in self.nodes.values():
                if not node.alive:
                    continue
                whs = [wh for wh in node.all_workers if wh.conn is not None]
                if not whs:
                    continue
                rid = _uuid.uuid4().hex
                for wh in whs:
                    self._enqueue_send(wh, (msg_kind, dict(payload, req_id=rid)))
                req_ids[rid] = (node.node_id.hex(), len(whs))
        self.flush_outbox()
        out: dict[str, dict] = {}

        def _take(rid: str, node_hex: str, expected: int) -> None:
            got = self._stacks_replies.pop(rid, None) or {}
            dest = out.setdefault(node_hex, {})
            dest.update({str(p): v for p, v in got.items()})
            if len(got) < expected:
                dest["_errors"] = [
                    f"{expected - len(got)} worker(s) did not reply within timeout"
                ]

        with self._stacks_cv:
            while req_ids and time.monotonic() < deadline:
                for rid in list(req_ids):
                    node_hex, expected = req_ids[rid]
                    if len(self._stacks_replies.get(rid) or {}) >= expected:
                        _take(rid, node_hex, expected)
                        req_ids.pop(rid)
                if req_ids:
                    self._stacks_cv.wait(timeout=0.2)
            for rid, (node_hex, expected) in req_ids.items():
                _take(rid, node_hex, expected)  # deadline: keep partials
        return out

    def rpc_worker_profile(self, duration_s: float = 2.0, interval_ms: float = 10.0,
                           timeout: float = 0.0):
        """Sampling CPU profile of every live worker (reference: the
        dashboard's py-spy ``cpu_profile`` endpoint). Each worker samples
        itself (``reporter.sample_profile``) and posts collapsed stacks
        back; returns ``{node_hex: {pid: collapsed_text}}`` — feed a value
        straight to flamegraph.pl or speedscope."""
        duration_s = min(max(float(duration_s), 0.05), 60.0)  # bound GIL cost
        timeout = timeout or duration_s + 5.0
        req = {"duration_s": duration_s, "interval_s": interval_ms / 1000.0}
        return self._broadcast_rendezvous(
            "profile", req, time.monotonic() + timeout
        )

    def rpc_collect_events(self, timeout: float = 5.0):
        """Drain every live worker's flight-recorder ring (plus this
        process's own) — ``{node_hex: {pid: [event, ...]}}``. Same
        broadcast/mailbox rendezvous as ``rpc_worker_profile``; workers
        that miss the deadline are reported under ``_errors`` so callers
        see partial coverage instead of assuming it was total."""
        from ray_tpu_torch._private import events as _ev

        timeout = min(max(float(timeout), 0.2), 30.0)
        out = self._broadcast_rendezvous(
            "events_drain", {}, time.monotonic() + timeout
        )
        # the head process's own ring (the in-process driver's, usually)
        out.setdefault("head", {})[str(os.getpid())] = _ev.snapshot()
        return out

    # ------------------------------------------------- object-plane ledger

    @staticmethod
    def _object_state(ent: ObjectEntry) -> str:
        """A directory entry's position in the object state machine
        (inline → arena/segment → spilled; ``poisoned`` lives client-side
        and is folded into the ledger from worker reports)."""
        if ent.shm is not None:
            return "arena" if ent.shm.offset is not None else "segment"
        if ent.spill_path is not None:
            return "spilled"
        if ent.small is not None:
            return "inline"
        return "pending"

    def _node_object_stats(self) -> dict:
        """Lock held. This host's object-plane residency: arena occupancy
        (owner-registry bytes when no native arena), this process's live
        pins, and directory bytes spilled to this host's disk."""
        from ray_tpu_torch._private import shm_store as _shm

        spill = sum(
            ent.size for ent in self.objects.values()
            if ent.spill_path is not None
        )
        arena = _shm.attach_arena(self.arena_name) if self.arena_name else None
        pins = _shm.pin_stats()
        return {
            "arena": self.arena_name,
            "used": (
                arena.used if arena is not None else self.shm_owner.bytes_used
            ),
            "capacity": (
                arena.capacity if arena is not None else self._spill_threshold()
            ),
            "n_objects": (
                arena.n_objects if arena is not None
                else len(self.shm_owner.snapshot())
            ),
            "pinned_bytes": pins["pinned_bytes"],
            "pins": pins["count"],
            "oldest_pin_age_s": pins["oldest_age_s"],
            "spill_bytes": spill,
            "owner_bytes": self.shm_owner.bytes_used,
        }

    def _publish_object_gauges(self, node_stats: Optional[dict] = None) -> None:
        """Publish the per-node residency gauges. ``node_stats`` maps a
        node tag to a ``_node_object_stats``-shaped dict (agent nodes,
        from a ledger/audit rendezvous); None = just this host, the
        health-loop tick. The untagged occupancy gauge carries the WORST
        node's used/capacity ratio so the arena-pressure SLO rule watches
        cluster-wide pressure in one series."""
        m = _object_metrics()
        stats = dict(node_stats or {})
        with self.lock:
            stats["head"] = self._node_object_stats()
        worst = 0.0
        for tag, s in stats.items():
            used = s.get("used") or 0
            cap = s.get("capacity") or 0
            m["arena_used"].set(used, tags={"node": tag})
            m["arena_capacity"].set(cap, tags={"node": tag})
            m["arena_pinned"].set(s.get("pinned_bytes") or 0, tags={"node": tag})
            m["spill_bytes"].set(s.get("spill_bytes") or 0, tags={"node": tag})
            if cap:
                worst = max(worst, used / cap)
        m["arena_occupancy"].set(worst)

    def _gather_object_reports(self, timeout: float) -> dict:
        """Cluster object-plane residency — ``{node_hex: {pid: report}}``:
        every live worker's arena pins / locally-poisoned ids / arena
        occupancy (``object_report`` rendezvous, same broadcast/mailbox as
        stacks and events), plus this process's own report."""
        from ray_tpu_torch._private import runtime as _rt
        from ray_tpu_torch._private import shm_store as _shm

        out: dict = {}
        if timeout > 0:
            out = self._broadcast_rendezvous(
                "object_report", {}, time.monotonic() + timeout
            )
        report = _shm.pin_stats()
        ctx = _rt._ctx  # the in-process driver, when this head is local
        report["poisoned"] = [
            oid.hex() for oid in list(getattr(ctx, "_poisoned", None) or {})
        ]
        arena = _shm.attach_arena(self.arena_name) if self.arena_name else None
        if arena is not None:
            report["arena"] = {
                "name": arena.name,
                "used": arena.used,
                "capacity": arena.capacity,
                "n_objects": arena.n_objects,
            }
        out.setdefault("head", {})[str(os.getpid())] = report
        return out

    @staticmethod
    def _fold_node_reports(reports: dict) -> tuple[dict, list]:
        """Fold per-pid object reports into per-node residency stats and
        the cluster poisoned-ref list. Simulated local nodes share the
        head host's arena, so their entries mirror its occupancy."""
        node_stats: dict[str, dict] = {}
        poisoned: list[dict] = []
        for node_hex, pids in reports.items():
            agg = {
                "pinned_bytes": 0, "pins": 0,
                "oldest_pin_age_s": 0.0, "spill_bytes": 0,
            }
            for pid, rep in pids.items():
                if pid == "_errors" or not isinstance(rep, dict):
                    continue
                agg["pinned_bytes"] += rep.get("pinned_bytes") or 0
                agg["pins"] += rep.get("count") or 0
                agg["oldest_pin_age_s"] = max(
                    agg["oldest_pin_age_s"], rep.get("oldest_age_s") or 0.0
                )
                for oh in rep.get("poisoned", ()):
                    poisoned.append(
                        {"object_id": oh, "state": "poisoned",
                         "node": node_hex, "pid": pid}
                    )
                ar = rep.get("arena")
                if ar:
                    agg["arena"] = ar.get("name")
                    agg["used"] = ar.get("used")
                    agg["capacity"] = ar.get("capacity")
                    agg["n_objects"] = ar.get("n_objects")
            node_stats[node_hex] = agg
        return node_stats, poisoned

    def rpc_object_ledger(self, top_n: int = 20, node: Optional[str] = None,
                          state: Optional[str] = None, timeout: float = 2.0):
        """The object ledger: every directory entry's state,
        owner node, size, ref/pin counts, and age; client-side poisoned
        refs folded in from the ``object_report`` rendezvous; the freed
        forensics tail; and per-node arena/spill residency. ``top_n``
        bounds the object rows (largest first; 0 = all) AFTER the
        ``node``/``state`` filters. Also refreshes the per-node residency
        gauges with whatever the rendezvous gathered."""
        reports = self._gather_object_reports(timeout)
        folded, poisoned = self._fold_node_reports(reports)
        now = time.time()
        with self.lock:
            rows = []
            by_state: dict[str, int] = {}
            total_bytes = 0
            for oid, ent in self.objects.items():
                st = self._object_state(ent)
                by_state[st] = by_state.get(st, 0) + 1
                total_bytes += ent.size
                owner = (
                    ent.shm.node.hex()
                    if ent.shm is not None and ent.shm.node is not None
                    else "head"
                )
                if node is not None and owner != node:
                    continue
                if state is not None and st != state:
                    continue
                rows.append({
                    "object_id": ObjectID(oid).hex(),
                    "state": st,
                    "node": owner,
                    "size": ent.size,
                    "refcount": ent.refcount,
                    "pins": ent.pins,
                    "age_s": now - ent.created,
                    "seg": ent.shm.name if ent.shm is not None else None,
                    "spill_path": ent.spill_path,
                    "is_error": ent.is_error,
                })
            freed = [
                {"object_id": o, "size": s, "age_s": a,
                 "freed_at": t, "reason": r}
                for o, s, a, t, r in list(self._freed_ring)
            ]
            node_stats = {"head": self._node_object_stats()}
        for tag, s in folded.items():
            if tag == "head":
                # the directory-side head stats are authoritative; keep
                # only the worker-pin fold the head process can't see
                node_stats["head"]["worker_pinned_bytes"] = s["pinned_bytes"]
                continue
            node_stats[tag] = s
        rows.sort(key=lambda r: r["size"], reverse=True)
        if top_n:
            rows = rows[: int(top_n)]
        try:
            self._publish_object_gauges(
                {t: s for t, s in node_stats.items()
                 if t != "head" and s.get("capacity")}
            )
        except Exception as e:  # gauges must never fail the ledger read
            warn_throttled("object ledger: gauge refresh", e)
        return {
            "objects": rows,
            "poisoned": poisoned,
            "freed": freed,
            "summary": {
                "objects": sum(by_state.values()),
                "bytes": total_bytes,
                "by_state": by_state,
                "poisoned": len(poisoned),
            },
            "nodes": node_stats,
        }

    def rpc_object_audit(self, timeout: float = 2.0,
                         pin_lease_s: Optional[float] = None):
        """Cluster-wide leak audit (the core-plane analogue of
        ``KVBlockPool.audit()``). Invariants checked, each violation a
        finding with node/object provenance:

        * every owner-registered allocation (arena block or dedicated
          segment) is owned by a live directory locator — orphaned bytes
          are what a producer SIGKILLed after its put landed leaves;
        * every live LOCAL locator's backing is still owner-registered
          (dangling locator: a free raced a hand-out);
        * every spill file belongs to a spilled entry, and every spilled
          entry's file exists;
        * every arena pin (cluster-wide, from the rendezvous reports) is
          younger than the read lease ``pin_lease_s`` (default env
          ``RAY_TPU_PIN_LEASE_S``, 300s) — pinned-forever readers block
          block reuse.

        Publishes the verdict as the ``core_object_leaks`` gauge."""
        if pin_lease_s is None:
            try:
                pin_lease_s = float(os.environ.get("RAY_TPU_PIN_LEASE_S", "300"))
            except ValueError:
                pin_lease_s = 300.0
        reports = self._gather_object_reports(timeout)
        findings: list[dict] = []
        with self.lock:
            owned = self.shm_owner.snapshot()
            live: dict[tuple, str] = {}
            spill_by_path: dict[str, str] = {}
            for oid, ent in self.objects.items():
                if ent.shm is not None and self._loc_is_local(ent.shm):
                    live[(ent.shm.name, ent.shm.offset)] = ObjectID(oid).hex()
                if ent.spill_path is not None:
                    spill_by_path[ent.spill_path] = ObjectID(oid).hex()
            for key, (size, _gen) in owned.items():
                if key not in live:
                    findings.append({
                        "kind": "orphaned-bytes", "node": "head",
                        "seg": key[0], "offset": key[1], "size": size,
                    })
            for key, oid_hex in live.items():
                if key not in owned:
                    findings.append({
                        "kind": "dangling-locator", "node": "head",
                        "object_id": oid_hex,
                        "seg": key[0], "offset": key[1],
                    })
            spill_dir = os.path.join(
                os.path.dirname(self.socket_path), "spill"
            )
            try:
                names = os.listdir(spill_dir)
            except OSError:
                names = []
            for fn in names:
                path = os.path.join(spill_dir, fn)
                if path not in spill_by_path:
                    try:
                        size = os.path.getsize(path)
                    except OSError:
                        size = 0
                    findings.append({
                        "kind": "orphaned-spill-file", "node": "head",
                        "path": path, "size": size,
                    })
            for path, oid_hex in spill_by_path.items():
                if not os.path.exists(path):
                    findings.append({
                        "kind": "missing-spill-file", "node": "head",
                        "object_id": oid_hex, "path": path,
                    })
            checked = {
                "objects": len(self.objects),
                "owned_allocations": len(owned),
                "spill_files": len(names),
            }
        pins_checked = 0
        for node_hex, pids in reports.items():
            for pid, rep in pids.items():
                if pid == "_errors" or not isinstance(rep, dict):
                    continue
                for p in rep.get("pins", ()):
                    pins_checked += 1
                    if (p.get("age_s") or 0) > pin_lease_s:
                        findings.append({
                            "kind": "stale-pin", "node": node_hex,
                            "pid": pid, "seg": p.get("seg"),
                            "offset": p.get("offset"),
                            "size": p.get("size"), "age_s": p.get("age_s"),
                        })
        checked["pins"] = pins_checked
        _object_metrics()["leaks"].set(len(findings))
        return {
            "findings": findings,
            "checked": checked,
            "pin_lease_s": pin_lease_s,
        }

    def rpc_inject_orphan_for_tests(self, size: int = 4096) -> dict:
        """TEST-ONLY leak injection: lay real bytes
        out in this host's store and register them with the owner ledger
        WITHOUT a directory entry — what a producer SIGKILLed between its
        put landing and any ref existing leaves behind. Returns the
        provenance ``rpc_object_audit`` must then report."""
        from ray_tpu_torch._private.shm_store import write_shm

        sv = ser.serialize(b"\x00" * max(1, int(size)))
        loc = write_shm(sv)
        with self.lock:
            self.shm_owner.register(loc)
        return {"seg": loc.name, "offset": loc.offset,
                "size": loc.total_size, "node": "head"}

    def rpc_waterfall(self, recent: int = 0):
        """Task-hop waterfall summary (``obs waterfall`` / the ``obs top``
        row): per-phase percentile summaries folded from sampled tasks'
        stamp lists, plus optionally the newest raw records (the chrome
        trace nests them as slices)."""
        return _waterfall.summary(recent=int(recent))

    def rpc_task_events(self):
        with self.lock:
            # rid None = a rootless submission (specs no longer ship a
            # per-task minted context — zero-cost tracing): derive
            # the task-rooted id LAZILY here, matching what the worker's
            # LazyTaskContext materializes, so the state-API contract
            # (every task row carries a request_id) is unchanged
            return [
                {"task_id": tid.hex(), "name": name, "state": state,
                 "time": t, "kind": kind,
                 "request_id": rid if rid is not None else tid.hex()[:16]}
                for tid, name, state, t, kind, rid in self.task_events
            ]

    def rpc_autoscaler_offer(self, shapes: list) -> None:
        """An autoscaler's node types, as the resource shapes it can launch
        (each autoscaler sends them before it reads the demand). A GPU
        request on a cluster with no GPU node then waits for the node the
        autoscaler buys, as the reference's request always waits."""
        with self.lock:
            self._autoscaler_offer = [dict(shape) for shape in shapes]

    def rpc_autoscaler_demand(self):
        """Autoscaler feed: unplaceable resource demand + per-node load.

        Reference: the GCS load report consumed by
        ``autoscaler/_private/autoscaler.py:373`` (resource_demand_scheduler
        bin-packs pending shapes against node types).
        """
        with self.lock:
            demand = []
            demand_labels = []

            def _labels_of(spec):
                st = spec.get("strategy")
                return dict(st[1]) if st and st[0] == "labels" else {}

            for rec in self.pending_sched:
                demand.append(dict(rec["spec"].get("resources") or {}))
                demand_labels.append(_labels_of(rec["spec"]))
            # actor creations waiting for resources count too
            for a in self.actors.values():
                if a.state == ACTOR_PENDING and a.worker is None:
                    demand.append(dict(a.create_spec.get("resources") or {}))
                    demand_labels.append(_labels_of(a.create_spec))
            nodes = []
            now = time.monotonic()
            for n in self.nodes.values():
                # only a live worker keeps its node busy: a killed actor's
                # worker is retired (alive False) before its process exits,
                # and its handle keeps the create task as current_task
                busy = bool(n.assigned) or any(
                    w.alive and (w.current_task is not None or w.actor_id is not None)
                    for w in n.all_workers
                )
                idle_s = 0.0
                if not busy:
                    # a node with no workers yet is "idle since registration",
                    # never infinitely idle (workers spawn lazily on first
                    # task — inf would get fresh nodes reaped instantly)
                    last = max(
                        (w.idle_since for w in n.all_workers), default=n.created_at
                    )
                    idle_s = now - last
                nodes.append(
                    {
                        "node_id": n.node_id.hex(),
                        "alive": n.alive,
                        "resources_total": dict(n.resources_total),
                        "resources_available": dict(n.resources_avail),
                        "busy": busy,
                        "idle_s": idle_s,
                        "labels": dict(n.labels),
                    }
                )
            return {
                "pending_demand": demand,
                "pending_demand_labels": demand_labels,
                "nodes": nodes,
            }

    def rpc_list_placement_groups(self):
        with self.lock:
            names = {0: "PENDING", 1: "CREATED", 2: "REMOVED"}
            return [
                {
                    "placement_group_id": pg.pg_id.hex(),
                    "name": pg.name,
                    "strategy": pg.strategy,
                    "state": names.get(pg.state, str(pg.state)),
                    "bundles": list(pg.bundles),
                    "bundle_nodes": [
                        n.hex() if n is not None else None for n in pg.bundle_nodes
                    ],
                }
                for pg in self.placement_groups.values()
            ]

    # -------------------------------------------------------------- shutdown

    def shutdown(self):
        with self.lock:
            self._shutdown = True
            workers = [w for n in self.nodes.values() for w in n.all_workers]
            # route frees of agent-host objects while agent conns are still
            # up — their dedicated segments would otherwise outlive the
            # cluster (arenas die with their agents; segments don't)
            for ent in self.objects.values():
                if ent.shm is not None and not self._loc_is_local(ent.shm):
                    self._release_loc(ent.shm)
            self.cv.notify_all()
        for wh in workers:
            wh.alive = False
            try:
                wh.send(("exit",))
            except Exception:  # raylint: disable=RL007
                pass  # best-effort teardown: the worker may already be gone
        for node in self.nodes.values():
            if node.template is not None:
                node.template.shutdown()
                node.template = None
        deadline = time.monotonic() + 2.0
        for wh in workers:
            if wh.proc is not None:
                wh.proc.join(timeout=max(0.0, deadline - time.monotonic()))
                if wh.proc.is_alive():
                    wh.proc.terminate()
        _close_listener(self._listener)
        if self._tcp_listener is not None:
            _close_listener(self._tcp_listener)
        if self.data_server is not None:
            self.data_server.shutdown()
        self._pub_queue.put(None)
        self._spawn_q.put(None)
        self._blocking_pool.shutdown()
        try:
            os.write(self._io_wake_w, b"x")  # unblock the IO selector
        except OSError:
            pass
        self._io_resume.set()
        self._flush_event.set()  # backstop exits now, not at its next poll
        self._snapshot()
        self.shm_owner.shutdown()
        if self.arena_name:
            from ray_tpu_torch._private import shm_store as _shm

            _shm.unlink_arena(self.arena_name)
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        # release the pump plumbing (pipes are raw fds: without this every
        # Head — one per test — leaks 4 fds + an epoll fd)
        try:
            self._pump_sel.close()
        except OSError:
            pass
        for fd in (self._io_wake_r, self._io_wake_w, self._io_prog_r, self._io_prog_w):
            try:
                os.close(fd)
            except OSError:
                pass

    # --------------------------------------------------------- observability

    def _event(self, rec, state):
        # hot path (3 events per task): store a compact tuple; consumers
        # (rpc_task_events -> state API / timeline) expand to dicts lazily.
        # The static fields are resolved once per rec, not per event
        pre = rec.get("_ev")
        if pre is None:
            spec = rec["spec"]
            tctx = spec.get("trace_ctx")
            pre = rec["_ev"] = (
                rec["task_id"], spec.get("name"), spec.get("kind"),
                tctx.get("request_id") if tctx else None,
            )
        self.task_events.append(
            (pre[0], pre[1], state, time.time(), pre[2], pre[3])
        )
        if len(self.task_events) > GLOBAL_CONFIG.task_events_max_entries:
            # floor of 1 so tiny settings still trim instead of growing forever
            del self.task_events[: max(1, GLOBAL_CONFIG.task_events_max_entries // 2)]



def _iter_arg_refs(spec: dict):
    for a in spec.get("args", ()):  # ('v', bytes) | ('r', obj_id)
        if a[0] == "r":
            yield a
    for a in spec.get("kwargs", {}).values():
        if a[0] == "r":
            yield a


def _picklable(e) -> bool:
    try:
        import cloudpickle

        cloudpickle.dumps(e)
        return True
    except Exception:
        return False
