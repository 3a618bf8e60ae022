"""Per-process runtime context: driver or worker.

TPU-native counterpart of the reference's core worker (``src/ray/core_worker/
core_worker.h:290`` + the Cython bridge ``python/ray/_raylet.pyx``): every
process participating in the cluster holds exactly one context object through
which ``put/get/wait/submit_task/create_actor/...`` flow. The driver context
calls the in-process Head directly; worker contexts speak the same method
names over the unix-socket control plane, so the API layer above is written
once.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import queue
import threading
import time
from collections import deque
from typing import Any, Optional

from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private import events
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.log_util import warn_throttled
from ray_tpu_torch._private.shm_store import ShmReader

_ctx: Optional["BaseContext"] = None
_ctx_lock = threading.Lock()

#: raylint RL012 registry — the submitter side of the pipelined task plane
#:: window credits left before a submit flush blocks for acks;
#: plus the zero-copy data plane: bytes written to / read from
#: shared memory by this process, and whether each shm read was served by a
#: same-host arena map (local hit) or a cross-host data-plane pull
METRIC_NAMES = (
    "core_submit_credits",
    "core_shm_put_bytes",
    "core_shm_get_bytes",
    "core_data_local_hits",
    "core_data_remote_pulls",
)

#: flight-recorder events this module emits (raylint RL012 registry) — the
#: consumer/producer half of the ``core.object.*`` lifecycle family
#:: a put entering the shm plane, a cross-host pull, and a ref
#: poisoned by window loss (its get will raise a retriable error).
EVENT_NAMES = (
    "core.object.put",
    "core.object.p2p_pull",
    "core.object.poison",
)

#: Canonical lock order of the client-side submit plane, outermost
#: first — raylint RL010 checks every acquisition edge against it and
#: RL017 resolves these locks to their owners. ``_flush_submits`` is the
#: shape that fixes the order: the window is built under ``_submit_send``
#: (FIFO end to end) with ``_submit_cv`` taken inside it for buffer/credit
#: state, and the wire write happens under ``_send_lock`` with the cv
#: RELEASED (the recv thread must be able to process submit_acks while a
#: send blocks on a full socket — a deadlock found in review).
LOCK_ORDER = (
    "WorkerContext._submit_send",   # window build+send serialization
    "WorkerContext._submit_cv",     # submit buffer / credit window state
    "WorkerContext._send_lock",     # one writer on the conn at a time
    "WorkerContext._pending_lock",  # blocking-call reply slots
)

_CREDIT_GAUGE = None
_DATA_COUNTERS = None

#: gc-queue wake sent by ObjectRef.__del__ on the free buffer's
#: empty→non-empty edge (one futex wake per quiescent burst, never per ref)
_FREE_TICK = object()

#: shared no-arg spec constants (see serialize_args): identity-elided
#: against spec headers so the steady-state no-arg body ships without them
EMPTY_ARGS: tuple = ()
EMPTY_KWARGS: dict = {}


def _credit_gauge():
    global _CREDIT_GAUGE
    if _CREDIT_GAUGE is None:
        from ray_tpu_torch.util.metrics import Gauge

        _CREDIT_GAUGE = Gauge(
            "core_submit_credits",
            "remaining pipelined-submission window credits (tasks) in this process",
        )
    return _CREDIT_GAUGE


def _data_counters():
    """Data-plane counters, lazy like _credit_gauge: only
    processes that actually move shm bytes pay the metric objects. Returns
    (put_bytes, get_bytes, local_hits, remote_pulls)."""
    global _DATA_COUNTERS
    if _DATA_COUNTERS is None:
        from ray_tpu_torch.util.metrics import Counter

        _DATA_COUNTERS = (
            Counter(
                "core_shm_put_bytes",
                "serialized bytes this process wrote into shared memory "
                "(locator-only socket traffic)",
            ),
            Counter(
                "core_shm_get_bytes",
                "serialized bytes this process read out of shared memory",
            ),
            Counter(
                "core_data_local_hits",
                "shm reads served zero-copy from a same-host arena/segment map",
            ),
            Counter(
                "core_data_remote_pulls",
                "shm reads that crossed hosts via the p2p data plane",
            ),
        )
    return _DATA_COUNTERS


def _split_for_wire(spec: dict, sent: set, hdrs_out: dict) -> dict:
    """Header-split one spec for a submit window (cheaper per-task bytes):
    static per-function fields already known to the receiver are elided
    (ser.split_spec_body), new headers ride the window's ``hdrs`` map
    exactly once per connection."""
    hdr = spec.get("_hdr")
    if hdr is None:
        return spec
    hid, fields = hdr
    body = ser.split_spec_body(spec, fields)
    body["_hdr_ref"] = hid
    if hid not in sent:
        sent.add(hid)
        hdrs_out[hid] = fields
    return body


def get_ctx() -> "BaseContext":
    if _ctx is None:
        raise rex.RayError("ray_tpu_torch.init() has not been called in this process")
    return _ctx


def set_ctx(ctx: Optional["BaseContext"]):
    global _ctx
    _ctx = ctx


def is_initialized() -> bool:
    return _ctx is not None


# --------------------------------------------------------------------------


class ObjectRef:
    """Handle to a (possibly pending) object (reference: ObjectRef /
    ``ObjectID`` + distributed refcount in ``reference_count.h``).

    GC model: every live ObjectRef instance — including ones that crossed a
    serialization boundary — holds one count at the owner, released on GC.
    Serialization uses a borrow protocol (``reference_count.h:61-115``
    borrower bookkeeping, simplified): ``__reduce__`` takes a nonce-tagged
    transit count (``borrow_begin``); the first deserialization claims it
    (``borrow_claim`` — no double count), later deserializations of the same
    pickle (e.g. a retried task's args) each add their own. A serialized ref
    that is never deserialized leaks its transit count — bounded by dropped
    messages, vs. the reference's full borrower-death tracking.
    """

    __slots__ = ("_id", "_owned", "__weakref__")

    def __init__(self, id_bytes: bytes, owned: bool = False):
        self._id = id_bytes
        self._owned = owned

    def binary(self) -> bytes:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __del__(self):
        # GC-safety: __del__ can fire at ANY allocation point, including in a
        # thread that holds (or is awaited by a holder of) the head lock or a
        # connection send lock. The only safe operations here are a reentrant,
        # lock-free deque append and a reentrant SimpleQueue.put; the gc
        # drain thread ships the buffered ids as coalesced free batches
        # (reference: reference_count.h posts decrements to the io_context
        # for the same reason — never block in a destructor). Only the
        # empty→non-empty EDGE wakes the drain: at task rates one futex
        # wake per dead ref was a measurable share of the sync round trip,
        # and a busy drain coalesces every append that lands meanwhile.
        ctx = _ctx
        if self._owned and ctx is not None and not ctx.closed:
            if ctx._poisoned:
                # a poisoned (failed fire-and-forget) ref's error entry
                # lives exactly as long as the ref: dropping the last
                # handle drops the entry, so repeated reconnect storms
                # cannot grow the dict forever (dict.pop is reentrant-safe)
                ctx._poisoned.pop(self._id, None)
            buf = ctx._free_buf
            buf.append(self._id)
            if len(buf) == 1:
                try:
                    ctx._gc_q.put(_FREE_TICK)
                except Exception:
                    pass

    def __reduce__(self):
        nonce = None
        if _ctx is not None and not _ctx.closed:
            try:
                import os as _os

                nonce = _os.urandom(8)
                _ctx.call("borrow_begin", obj_id=self._id, nonce=nonce)
            except Exception:
                nonce = None
        return (_deserialized_ref, (self._id, nonce))

    def future(self):
        """concurrent.futures.Future view of this ref."""
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _poll():
            try:
                fut.set_result(get_ctx().get([self], timeout=None)[0])
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=_poll, daemon=True).start()
        return fut


def _deserialized_ref(id_bytes: bytes, nonce: bytes = None) -> ObjectRef:
    if nonce is None:
        return ObjectRef(id_bytes, owned=False)  # pre-borrow pickles / no ctx
    ref = ObjectRef(id_bytes, owned=True)  # this holder releases on GC
    if _ctx is not None and not _ctx.closed:
        try:
            _ctx.call("borrow_claim", obj_id=id_bytes, nonce=nonce)
        except Exception:
            ref._owned = False
    else:
        ref._owned = False
    return ref


# --------------------------------------------------------------------------


class ObjectRefGenerator:
    """Iterator over a streaming task's per-item ObjectRefs
    (``num_returns="streaming"``; reference: ``ObjectRefGenerator`` in
    _raylet.pyx:1230 + streaming bookkeeping in task_manager.cc).

    Each ``next()`` blocks until the producer has yielded that item, then
    returns an owned ObjectRef resolving to the yielded value — items arrive
    while the task is still running, with a consumer-acked backpressure
    window on the producer. A mid-stream producer exception is raised from
    ``next()`` once the already-produced items are drained. Dropping the
    generator cancels a still-running producer and frees unconsumed items.
    """

    def __init__(self, task_id: bytes, completion_ref: "ObjectRef", ctx):
        self._task_id = task_id
        self._completion_ref = completion_ref  # holds the error carrier alive
        self._ctx = ctx
        self._i = 0
        self._done = False
        self._disposed = False

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        return self._next(timeout=None)

    def _next(self, timeout: Optional[float]) -> "ObjectRef":
        if self._done or self._disposed:
            raise StopIteration
        kind, payload = self._ctx.call(
            "stream_next", task_id=self._task_id, index=self._i, timeout=timeout
        )
        if kind == "end":
            self._done = True
            raise StopIteration
        if kind == "error":
            self._done = True
            # the completion object carries the producer's exception;
            # resolving it raises with proper cause chaining
            self._ctx.get([ObjectRef(payload)], timeout=30)
            raise rex.RayError("stream failed but completion held no error")
        self._i += 1
        return ObjectRef(payload, owned=True)

    def close(self) -> None:
        self._dispose(blocking=True)

    def _dispose(self, blocking: bool) -> None:
        """Single dispose path: explicit close() blocks; the GC path may only
        enqueue (a blocking RPC from a GC tick can deadlock against a thread
        holding the head lock — see ObjectRef.__del__)."""
        if self._disposed:
            return
        self._disposed = True
        try:
            if blocking:
                self._ctx.call("stream_dispose", task_id=self._task_id)
            elif not self._ctx.closed:
                self._ctx.enqueue_gc(
                    "call", ("stream_dispose", {"task_id": self._task_id})
                )
        except Exception:
            pass

    def __del__(self):
        self._dispose(blocking=False)

    def __repr__(self):
        return f"ObjectRefGenerator({self._task_id.hex()[:8]}, next={self._i})"


class BaseContext:
    def __init__(self):
        self.closed = False
        self.remote = False  # True = different host than the head (no shm)
        # test hook, read once per context (not per get): skip the same-host
        # shm shortcut so same-machine tests exercise the real network path
        self._force_dp = os.environ.get("RAY_TPU_FORCE_DATA_PLANE") == "1"
        self.authkey: Optional[bytes] = None  # data-plane auth (set by subclasses)
        self.head_host: str = "127.0.0.1"  # host we reach the control plane on
        self._data_addrs: dict = {}  # node bin -> (host, port) cache
        # func_id -> the INTERNED id bytes: returning one object per id lets
        # spec headers elide func_id by identity (_split_for_wire)
        self._uploaded_funcs: dict[bytes, bytes] = {}
        self._readers: dict[bytes, ShmReader] = {}
        self._readers_lock = threading.Lock()
        # task-id source (see new_task_returns): nonce drawn once per context
        self._task_nonce = os.urandom(6)
        self._task_seq = itertools.count(1)
        self.current_actor = None  # set in actor workers
        self.node_id_bin: Optional[bytes] = None
        self.task_depth = 0
        # named-actor namespace this context creates/looks up in ("default"
        # for local drivers and workers; ray:// clients get their session's
        # — usually anonymous — namespace from the driver_ack handshake)
        self.namespace: str = "default"
        # pubsub: channel -> local callbacks fed by head "pub" pushes
        # (reference: src/ray/pubsub subscriber channels)
        self._pub_sinks: dict[str, list] = {}
        self._pub_lock = threading.Lock()
        # GC drain: __del__ methods (ObjectRef, generators, actor handles,
        # compiled DAGs) may ONLY touch this queue — SimpleQueue.put is
        # C-implemented and reentrant-safe, so a GC tick inside a lock-held
        # critical section can never re-enter head/connection locks. The
        # drain thread performs the real (possibly blocking) calls.
        self._gc_q: "queue.SimpleQueue" = queue.SimpleQueue()
        # dead ObjectRef ids awaiting a coalesced free (ObjectRef.__del__
        # appends, the gc drain tick ships): a C-level deque, so the
        # destructor path is one append — no lock, no wake, no allocation
        self._free_buf: deque = deque()
        # refs whose fire-and-forget submission died with the connection
        # (un-acked window / unsent outbox at a reconnect): obj_id -> the
        # retriable error get() raises. The head may never learn these ids,
        # so resolving them locally is what keeps a ref from hanging.
        self._poisoned: dict[bytes, Exception] = {}
        self._thunk_threads: list[threading.Thread] = []
        self._gc_thread = threading.Thread(
            target=self._gc_drain_loop, name="gc-drain", daemon=True
        )
        self._gc_thread.start()

    def enqueue_gc(self, kind: str, payload) -> None:
        """The ONLY operation a __del__ may perform against the runtime.
        kind: "call" -> (method, kwargs) executed via self.call;
        "thunk" -> zero-arg callable run on the drain thread."""
        self._gc_q.put((kind, payload))

    def _gc_drain_loop(self) -> None:
        free_buf = self._free_buf

        def flush_free() -> None:
            # ref drops dominate GC work at high task rates (one per
            # consumed result): ship whatever __del__ buffered as chunked
            # free batches — one head call / one socket write per chunk
            # instead of a lock round trip per dead ref
            while free_buf:
                ids: list[bytes] = []
                try:
                    while len(ids) < 8192:
                        ids.append(free_buf.popleft())
                except IndexError:
                    pass
                if not ids:
                    return
                try:
                    self._free_refs_rpc(ids)
                except Exception as e:
                    # transient failure (reconnect blip): put the popped
                    # chunk BACK so the next tick retries — dropping it
                    # would pin these objects' head refcounts (and their
                    # shm bytes) for the session's life
                    free_buf.extendleft(reversed(ids))
                    warn_throttled("gc drain loop", e)
                    return

        while True:
            try:
                # near-IDLE when the free buffer is empty (0.5Hz fallback —
                # 1000 workers polling at 100Hz once saturated a 1-core box,
                # test_envelope_1k_actors); while ids are buffered, the 5ms
                # timeout is the coalescing tick: refs dropped since the
                # last pass ship a few ms late, and a busy submit loop never
                # pays a gc wakeup per dead ref. __del__'s empty→non-empty
                # edge tick wakes us promptly; the 2s fallback covers the
                # tick's benign race (two concurrent appends can both see
                # len==2 and neither tick) so a lost wake self-heals
                item = self._gc_q.get(timeout=0.005 if free_buf else 2.0)
            except queue.Empty:
                if not self.closed:
                    flush_free()
                continue
            if item is None:
                flush_free()  # shutdown drains queued work BEFORE closing
                return
            if self.closed:
                continue  # keep draining so shutdown's sentinel is reached
            if item is _FREE_TICK:
                continue  # buffer went non-empty: re-enter the timed get
            kind, payload = item
            if kind == "call" and payload[0] == "free_ref_async":
                free_buf.append(payload[1]["obj_id"])
                continue
            flush_free()  # non-free work: frees precede blocking thunks
            try:
                if kind == "call":
                    method, kwargs = payload
                    self.call(method, **kwargs)
                elif kind == "thunk":
                    # thunks may block for seconds (e.g. CompiledDAG teardown
                    # joins its exec loops): run off-thread so queued ref
                    # frees aren't stalled behind them; tracked so shutdown's
                    # drain can join them (they unlink shm channels)
                    try:
                        t = threading.Thread(target=payload, daemon=True)
                        self._thunk_threads = [
                            x for x in self._thunk_threads if x.is_alive()
                        ]
                        self._thunk_threads.append(t)
                        t.start()
                    except RuntimeError:
                        payload()
            except Exception as e:
                # best-effort: the process may be tearing down
                warn_throttled("gc drain loop", e)

    # -- transport: subclasses implement call() --------------------------------
    def call(self, method: str, **payload) -> Any:
        raise NotImplementedError

    # -- pubsub ------------------------------------------------------------
    def on_pub(self, channel: str, payload) -> None:
        with self._pub_lock:
            sinks = list(self._pub_sinks.get(channel, ()))
        for fn in sinks:
            try:
                fn(channel, payload)
            except Exception as e:
                warn_throttled(f"pubsub callback on {channel}", e)

    def pub_register(self, channel: str, fn) -> None:
        with self._pub_lock:
            first = not self._pub_sinks.get(channel)  # missing OR emptied
            self._pub_sinks.setdefault(channel, []).append(fn)
        if first:
            self.call("subscribe", channel=channel)

    def pub_unregister(self, channel: str, fn) -> None:
        with self._pub_lock:
            sinks = self._pub_sinks.get(channel, [])
            if fn in sinks:
                sinks.remove(fn)
            empty = not sinks
        if empty:
            try:
                self.call("unsubscribe", channel=channel)
            except Exception:
                pass

    # -- objects ----------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("Calling put() on an ObjectRef is not allowed.")
        sv = ser.serialize(value)
        # take_ref: the returned ObjectRef holds one refcount, taken inside
        # the put itself (one head round trip, not put + add_ref — without
        # the count, a single use as a task arg would unpin and evict).
        obj_id = self.put_serialized(sv, take_ref=True)
        return ObjectRef(obj_id, owned=True)

    def put_serialized(
        self, sv: ser.SerializedValue, is_error=False, take_ref=False
    ) -> bytes:
        raise NotImplementedError

    def _free_refs_rpc(self, ids: list) -> None:
        """Ship a coalesced ref-free batch, RAISING on transport failure —
        the gc drain's re-queue-and-retry path depends on seeing the error
        (the generic ``call`` fire-and-forget branches swallow it, which
        would silently drop up to a whole chunk of decrements and pin those
        objects' head refcounts for the session's life)."""
        if len(ids) == 1:
            self.call("free_ref_async", obj_id=ids[0])
        else:
            self.call("free_refs_async", obj_ids=ids)

    def get(self, refs: list[ObjectRef], timeout: Optional[float]) -> list[Any]:
        if self._poisoned:
            for r in refs:
                err = self._poisoned.get(r.binary())
                if err is not None:
                    # asking the head would hang forever: it may never have
                    # seen this id (failed fire-and-forget submission).
                    # Raise a FRESH instance: raising the stored one would
                    # attach a traceback whose frames pin this refs list,
                    # so the entry (cleared by the ref's __del__) could
                    # never drop — a poison-dict leak the audit would flag
                    raise err.__class__(*err.args)
        deadline = None if timeout is None else time.monotonic() + timeout
        locators = self.call("get", obj_ids=[r.binary() for r in refs], timeout=timeout)
        out = []
        for r, loc in zip(refs, locators):
            value = self._materialize(r.binary(), loc, deadline=deadline)
            kind, payload, is_err = loc
            if is_err:
                if isinstance(value, rex.RayTaskError):
                    raise value.as_instanceof_cause()
                raise value
            out.append(value)
        return out

    def store_value(self, sv: "ser.SerializedValue", is_error: bool = False):
        """Locator for a freshly serialized value. Large payloads go into
        THIS host's shared memory (arena or dedicated segment) and only the
        locator travels — on agent hosts the bytes are then served
        peer-to-peer by the agent's data server (data_plane.py). A remote
        process without a local store (a ``ray://`` driver) ships inline."""
        from ray_tpu_torch._private.shm_store import _current_write_arena, write_shm

        arena = _current_write_arena()
        # zero-copy plane: with an arena attached the inline cutoff
        # drops to core_shm_inline_threshold — mid-size values (the
        # (threshold, 100KB] band that used to ride the socket twice: reply
        # in, get out) become one arena write plus a locator. Without an
        # arena the old 100KB cutoff stands: a dedicated POSIX segment per
        # mid-size object would cost more than the copy it saves.
        threshold = (
            GLOBAL_CONFIG.core_shm_inline_threshold
            if arena is not None
            else GLOBAL_CONFIG.max_direct_call_object_size
        )
        if sv.total_size <= threshold:
            return ("inline", sv.to_bytes(), is_error)
        if self.remote:
            if arena is None:
                # no host-local store to serve from (remote driver, or agent
                # without the native arena): the head re-lays these into its
                # shm and its spill watermark owns the lifetime
                return ("inline", sv.to_bytes(), is_error)
            if (
                sv.total_size <= GLOBAL_CONFIG.arena_max_object_bytes
                and arena.used + sv.total_size > 0.9 * arena.capacity
            ):
                # agent arena under pressure: agents have no spill of their
                # own (the head owns object lifetimes), so degrade to the
                # head-mediated path where the spill machinery applies
                # instead of running the agent host out of /dev/shm
                return ("inline", sv.to_bytes(), is_error)
        loc = write_shm(sv)
        loc.node = self.node_id_bin
        _data_counters()[0].inc(sv.total_size)
        return ("shm", loc, is_error)

    def _data_address_for(self, node_bin) -> Optional[tuple]:
        cached = self._data_addrs.get(node_bin)
        now = time.monotonic()
        if cached is not None and (cached[0] is not None or now < cached[1]):
            addr = cached[0]
        else:
            try:
                addr = self.call("data_address", node_id=node_bin)
            except Exception:
                addr = None
            # a negative result is transient (control hiccup, node still
            # registering): cache it briefly only, or one bad lookup would
            # disable the data plane for this node forever
            self._data_addrs[node_bin] = (
                addr, now + GLOBAL_CONFIG.object_location_negative_cache_s
            )
        if addr is None:
            return None
        host, port = addr
        return (host or self.head_host, port)

    def _fetch_via_data_plane(self, obj_id: bytes, payload, deadline=None):
        """Pull an object's bytes straight from its owning host (reference:
        pull_manager.cc chunked pulls). Returns (True, value) or (False,
        None) when the object is gone / the data plane can't serve it —
        callers then run the lost-object recovery path. ``deadline``
        (monotonic) bounds the head-mediated fallback; None = the caller
        had no timeout, so the fallback may block like get does."""
        from ray_tpu_torch._private import data_plane

        if self.authkey is None:
            return False, None
        addr = self._data_address_for(payload.node)
        if addr is None:
            return False, None
        try:
            mv = data_plane.fetch(addr, self.authkey, payload)
        except data_plane.ObjectGone:
            return False, None
        except OSError:
            # owner unreachable (died? network?): drop the cached address
            # and try the head-mediated inline fallback before declaring
            # loss. The fallback honors the caller's REMAINING budget — a
            # timeout=0 poll here used to declare loss on a locator the
            # head was still re-laying (spill restore, lineage rebuild)
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
            try:
                loc = self.call(
                    "get_inline", obj_ids=[obj_id], timeout=remaining
                )[0]
            except Exception:
                return False, None
            if loc[0] == "inline":
                return True, ser.deserialize_value(
                    ser.SerializedValue.from_bytes(loc[1])
                )
            return False, None
        _data_counters()[3].inc()
        events.emit(
            "core.object.p2p_pull",
            obj_id=obj_id,
            size=payload.total_size,
            node=payload.node,
        )
        return True, data_plane.read_layout(mv, payload)

    def _materialize(self, obj_id: bytes, locator, _retry: bool = True,
                     deadline=None):
        kind, payload, is_err = locator
        if kind == "inline":
            if payload == ser.NONE_BYTES:
                return None  # one bytes compare beats a full deserialize
            return ser.deserialize_value(ser.SerializedValue.from_bytes(payload))
        force_dp = (
            self._force_dp
            and payload.node is not None
            and payload.node != self.node_id_bin
        )
        reader = None
        if not force_dp:
            with self._readers_lock:
                reader = self._readers.get(obj_id)
                if reader is None:
                    try:
                        # local-first: on the owning host (or any same-host
                        # simulated node) the shm attaches by name, zero-copy
                        reader = ShmReader(payload)
                    except FileNotFoundError:
                        # not on this host — or spilled/unlinked under us
                        reader = None
        if reader is None:
            # the data plane must get its shot even on the recovery retry:
            # a lineage rebuild can land the fresh copy on a REMOTE host
            ok, value = self._fetch_via_data_plane(obj_id, payload, deadline)
            if ok:
                return value
            if not _retry:
                raise FileNotFoundError(f"object {obj_id.hex()} unavailable")
        if reader is None:
            # tell the head the backing is gone so it can restore from spill
            # or rebuild via lineage (reference: object recovery manager),
            # then block in get until a fresh copy lands
            try:
                self.call("report_lost", obj_ids=[obj_id])
            except Exception:
                pass
            fresh = self.call("get", obj_ids=[obj_id], timeout=None)[0]
            value = self._materialize(obj_id, fresh, _retry=False)
            if fresh[2]:
                # the object resolved to an error AFTER the caller already
                # checked its (stale) locator — raise here, matching the
                # caller-side error semantics
                if isinstance(value, rex.RayTaskError):
                    raise value.as_instanceof_cause()
                raise value
            return value
        value = reader.read()
        ctrs = _data_counters()
        ctrs[1].inc(payload.total_size)
        ctrs[2].inc()
        self._sweep_readers()
        return value

    def _sweep_readers(self, limit: int = 256):
        if len(self._readers) <= limit:
            return
        with self._readers_lock:
            for oid in list(self._readers)[: len(self._readers) - limit]:
                self._readers.pop(oid).close()

    def wait(self, refs, num_returns, timeout, fetch_local=True):
        ids = [r.binary() for r in refs]
        # a poisoned ref is RESOLVED (get raises its retriable error): count
        # it ready UP FRONT and only ask the head about the rest — the head
        # never learned these ids, so including them would park the wait for
        # its whole timeout even when poisoned refs already make the count
        ready_ids = {i for i in ids if i in self._poisoned} if self._poisoned else set()
        remaining = [i for i in ids if i not in ready_ids]
        need = min(num_returns - len(ready_ids), len(remaining))
        if need > 0:
            ready_ids.update(
                self.call("wait", obj_ids=remaining, num_returns=need, timeout=timeout)
            )
        ready, not_ready = [], []
        for r in refs:
            (ready if r.binary() in ready_ids and len(ready) < num_returns else not_ready).append(r)
        return ready, not_ready

    # -- functions --------------------------------------------------------
    def upload_function(self, blob: bytes, func_id: Optional[bytes] = None) -> bytes:
        if func_id is None:
            func_id = hashlib.sha1(blob).digest()[:16]
        cached = self._uploaded_funcs.get(func_id)
        if cached is not None:
            return cached
        self.call("put_function", func_id=func_id, blob=blob)
        self._uploaded_funcs[func_id] = func_id
        return func_id

    # -- spec building ----------------------------------------------------
    def serialize_args(self, args, kwargs):
        if not args and not kwargs:
            # SHARED empty constants (never mutated downstream — all spec
            # arg access is read-only): a no-arg call's args/kwargs then
            # match its spec header by IDENTITY and drop off the wire
            # entirely (_split_for_wire / _wire_spec)
            return EMPTY_ARGS, EMPTY_KWARGS

        def one(v):
            if isinstance(v, ObjectRef):
                return ("r", v.binary())
            sv = ser.serialize(v)
            if sv.total_size > GLOBAL_CONFIG.max_direct_call_object_size:
                # big by-value arg: implicit put (reference: dependency
                # resolver promotes >100KB args to plasma)
                return ("r", self.put_serialized(sv))
            return ("v", sv.to_bytes())

        return [one(a) for a in args], {k: one(v) for k, v in kwargs.items()}

    def submit_task(self, spec: dict) -> list[ObjectRef]:
        # the head takes the submitter's refs on the return ids at receive
        # time — one message (or one SHARE of a batched window), never
        # 1 + num_returns round trips. Submission is fire-and-forget: the
        # refs are minted client-side and submit-time errors surface on
        # them asynchronously (_enqueue_submit per context).
        refs = [ObjectRef(rid, owned=True) for rid in spec["return_ids"]]
        self._enqueue_submit("task", spec)
        return refs

    def submit_actor_task(self, spec: dict) -> list[ObjectRef]:
        refs = [ObjectRef(rid, owned=True) for rid in spec["return_ids"]]
        self._enqueue_submit("actor_method", spec)
        return refs

    def _enqueue_submit(self, kind: str, spec: dict) -> None:
        raise NotImplementedError

    def new_task_returns(self, num_returns: int):
        # Task ids end in 4 zero bytes so a return ObjectID's 12-byte prefix
        # uniquely reconstructs its task id (used by ray_tpu_torch.cancel()).
        # 6-byte per-process nonce + 6-byte counter instead of a per-task
        # urandom syscall: uniqueness across submitters comes from the nonce
        # (48 bits — birthday-safe for any realistic process count), and the
        # counter never wraps in practice (2^48 submissions).
        prefix = self._task_nonce + next(self._task_seq).to_bytes(6, "big")
        # raw bytes on purpose: this runs once per .remote() and the
        # TaskID/ObjectID wrappers would be built only to call .binary()
        # (layout must match ObjectID.for_task_return: prefix + LE index)
        return prefix + b"\x00\x00\x00\x00", [
            prefix + i.to_bytes(4, "little") for i in range(num_returns)
        ]

    def shutdown(self):
        # drain already-queued GC work (ref frees, stream disposes, DAG
        # teardowns) while the control plane is still up, THEN mark closed —
        # the reverse order would silently discard them. Bounded join: a
        # drain item wedged on a dying head must not hang shutdown.
        self._gc_q.put(None)
        if threading.current_thread() is not self._gc_thread:
            self._gc_thread.join(timeout=5.0)
        for t in self._thunk_threads:  # DAG teardowns must finish their
            if t is not threading.current_thread():  # channel unlinks
                t.join(timeout=5.0)
        self.closed = True
        with self._readers_lock:
            for reader in self._readers.values():
                reader.close()
            self._readers.clear()


class DriverContext(BaseContext):
    """Runs in the driver process; owns the Head."""

    def __init__(self, head, node_id_bin: bytes):
        super().__init__()
        self.head = head
        self.node_id_bin = node_id_bin
        self.authkey = head.authkey

    def _enqueue_submit(self, kind: str, spec: dict) -> None:
        """In-process submission: the head call IS the 'socket write' (no
        round trip exists to pipeline away), but the worker-bound dispatch
        it queued stays in the head outbox until ``core_dispatch_coalesce``
        messages gather — an async submit burst then ships per worker as
        one ``run_task_batch`` write. Any blocking call (get/wait flush at
        entry, ``_pump_or_wait`` re-checks) or the outbox backstop bounds
        how long a dispatch can sit."""
        wf = spec.get("wf")
        if wf is not None:
            # deferred import (util package ↔ runtime cycle); only the
            # sampled-and-stamped path pays the sys.modules lookup
            from ray_tpu_torch.util import waterfall as _waterfall

            _waterfall.stamp(wf)  # socket_write: entering the head
        head = self.head
        was_idle = not head._outbox
        try:
            if kind == "task":
                head.submit_task(spec)
            else:
                head.submit_actor_task(spec)
        finally:
            if (was_idle and head._outbox) or len(
                head._outbox
            ) >= GLOBAL_CONFIG.core_dispatch_coalesce:
                # idle-plane submit (the sync round-trip pattern): the
                # dispatch rides out NOW — deferring it to the caller's
                # next head RPC charges that RPC's entry path to the
                # head_dispatch leg. A burst (outbox already non-empty)
                # keeps coalescing until the batch fills.
                head.flush_outbox()

    def get(self, refs, timeout: Optional[float]) -> list:
        if len(refs) == 1 and not self._poisoned:
            # sync round-trip fast path: the call() indirection and the
            # id-list/zip machinery drop out of the reply-side corridor
            head = self.head
            if head._outbox:
                head.flush_outbox()
            oid = refs[0]._id
            deadline = None if timeout is None else time.monotonic() + timeout
            loc = head.get_locators([oid], timeout)[0]
            value = self._materialize(oid, loc, deadline=deadline)
            if loc[2]:  # error locator: raise, never return
                if isinstance(value, rex.RayTaskError):
                    raise value.as_instanceof_cause()
                raise value
            return [value]
        return super().get(refs, timeout)

    def call(self, method: str, **payload):
        if self.head._outbox:
            # deferred dispatches (coalesced submits) ride out before any
            # other head interaction — get/wait must never park behind an
            # unflushed run_task they are waiting on
            self.head.flush_outbox()
        if method == "get":  # hottest two first (once per ray.get/wait)
            return self.head.get_locators(payload["obj_ids"], payload.get("timeout"))
        if method == "wait":
            return self.head.wait_objects(payload["obj_ids"], payload["num_returns"], payload.get("timeout"))
        if method == "subscribe":
            return self.head.subscribe_local(payload["channel"], self.on_pub)
        if method == "unsubscribe":
            return self.head.unsubscribe_local(payload["channel"], self.on_pub)
        if method == "free_ref_async":
            # runs on the gc-drain thread (never from __del__ directly):
            # blocking on the head lock here is safe, and eviction may queue
            # agent sends that need flushing like any other in-process call
            try:
                return self.head.remove_ref(payload["obj_id"])
            finally:
                self.head.flush_outbox()
        if method == "free_refs_async":
            try:
                return self.head.remove_refs(payload["obj_ids"])
            finally:
                self.head.flush_outbox()
        if method == "add_ref":
            return self.head.add_ref(payload["obj_id"])
        try:
            return getattr(self.head, "rpc_" + method)(**payload)
        finally:
            # in-process calls bypass _run_request: drain any worker sends
            # this call queued (head.flush_outbox docstring)
            self.head.flush_outbox()

    def put_serialized(self, sv, is_error=False, take_ref=False) -> bytes:
        try:
            return self.head.put_serialized(sv, is_error, take_ref=take_ref)
        finally:
            self.head.flush_outbox()


class WorkerContext(BaseContext):
    """Runs in worker processes; control plane over the head socket.

    ``remote=True`` marks a process on a DIFFERENT host than the head: all
    object payloads travel inline over the socket (the head's shm segments
    are unreachable), and the head converts in both directions.
    """

    def __init__(
        self,
        conn,
        node_id_bin: bytes,
        remote: bool = False,
        authkey: Optional[bytes] = None,
        head_host: Optional[str] = None,
    ):
        super().__init__()
        self.conn = conn
        self.node_id_bin = node_id_bin
        self.remote = remote
        self.authkey = authkey
        if head_host:
            self.head_host = head_host
        self._seq = itertools.count(1)
        self._send_lock = threading.Lock()
        self._pending: dict[int, list] = {}
        self._pending_lock = threading.Lock()
        # pipelined submission: .remote() buffers here and a
        # whole burst ships as ONE submit_batch message — no send+reply
        # rendezvous per task. The head acks WINDOWS; _submit_inflight
        # counts tasks in un-acked windows against the credit limit.
        # _submit_send serializes window build+send end to end (FIFO);
        # the cv itself is never held across a socket write.
        self._submit_send = threading.Lock()
        self._submit_cv = threading.Condition()
        # the thread that processes submit_acks (worker recv loop / driver
        # pump): it must NEVER park in _flush_submits — it is the only
        # thread that can replenish credits, and an exec thread in the
        # credit wait holds _submit_send, so blocking here is a self-
        # deadlock. send_raw/call skip the flush on this thread.
        self._recv_ident: Optional[int] = None
        self._submit_buf: list = []  # (kind, spec) in submission order
        self._submit_wid = 0
        self._submit_unacked: dict[int, tuple] = {}  # wid -> (ids, conn)
        self._submit_inflight = 0
        self._submit_last_flush = 0.0
        self._submit_backstop: Optional[threading.Event] = None
        self._sent_hdrs: set = set()

    # message pump (run by worker_main's receiver thread)
    def on_response(self, seq, ok, payload):
        with self._pending_lock:
            slot = self._pending.get(seq)
        if slot is not None:
            slot[1] = (ok, payload)
            slot[0].set()

    # ---------------------------------------------------------- submission
    def _enqueue_submit(self, kind: str, spec: dict) -> None:
        """Fire-and-forget submission with burst coalescing: the first
        submit after a quiet period flushes immediately (a lone nested
        task must not sit in the buffer), while submits arriving on the
        heels of a flush are a burst — they buffer and ship as one window
        when the batch fills, before the next head RPC (every call()/
        send_raw flushes first), or at the 5ms backstop."""
        now = time.monotonic()
        with self._submit_cv:
            self._submit_buf.append((kind, spec))
            defer = (
                now - self._submit_last_flush
                < GLOBAL_CONFIG.core_submit_flush_backstop_s / 8
                and len(self._submit_buf) < GLOBAL_CONFIG.core_submit_batch_max
            )
        if defer:
            evt = self._submit_backstop
            if evt is None:
                evt = self._ensure_submit_backstop()
            evt.set()  # backstop bounds the burst tail's sit time
            return
        self._flush_submits()

    def _ensure_submit_backstop(self) -> threading.Event:
        with self._submit_cv:
            if self._submit_backstop is not None:
                return self._submit_backstop
            evt = self._submit_backstop = threading.Event()

        def loop():
            period = GLOBAL_CONFIG.core_submit_flush_backstop_s
            while not self.closed:
                evt.wait()
                evt.clear()
                while not self.closed:
                    time.sleep(period)
                    if not self._submit_buf:
                        break  # quiet again: park on the event
                    try:
                        self._flush_submits()
                    except Exception as e:
                        warn_throttled("submit backstop flush", e)

        threading.Thread(target=loop, name="submit-backstop", daemon=True).start()
        return evt

    def _flush_submits(self) -> None:
        """Ship every buffered spec as one submit_batch window. Window
        ORDER is the FIFO contract (per-actor FIFO is submission order):
        the outer ``_submit_send`` lock serializes build+send end to end.
        The wire write itself happens OUTSIDE ``_submit_cv`` — the recv
        thread must be able to process submit_acks (which take the cv)
        even while a send is blocked on a full socket, or head and worker
        wedge against each other's full buffers (each blocked writing,
        neither reading)."""
        while True:
            with self._submit_send:
                with self._submit_cv:
                    if not self._submit_buf or self.closed:
                        return
                    while (
                        self._submit_inflight
                        >= GLOBAL_CONFIG.core_submit_window_tasks
                    ):
                        # window credits exhausted: the head is behind —
                        # park until acks return credits (recv loop fills
                        # them; a reconnect sweep resets them)
                        if self.closed:
                            return
                        self._submit_cv.wait(timeout=0.1)
                    if not self._submit_buf:
                        continue  # a reconnect sweep drained it while we waited
                    items = self._submit_buf
                    self._submit_buf = []
                    self._submit_wid += 1
                    wid = self._submit_wid
                    ids = [rid for _k, s in items for rid in s["return_ids"]]
                    # capture the conn the window will ACTUALLY ride: the
                    # send below must use this same object, or a reconnect
                    # between build and send makes _fail_submits(not_on=
                    # fresh) poison a window that was delivered on the
                    # fresh conn — and the caller's retry double-submits
                    conn0 = self.conn
                    puts = [s for k, s in items if k == "put"]
                    self._submit_unacked[wid] = (ids, conn0, puts)
                    self._submit_inflight += len(ids)
                    self._submit_last_flush = time.monotonic()
                    self._set_credit_gauge()
                    hdrs: dict = {}
                    wire = []
                    stamped = False
                    for kind, spec in items:
                        wf = spec.get("wf")
                        if wf is not None:
                            if not stamped:
                                from ray_tpu_torch.util import waterfall as _waterfall

                                stamped = True
                            _waterfall.stamp(wf)  # socket_write: batch write begins
                        wire.append((kind, _split_for_wire(spec, self._sent_hdrs, hdrs)))
                    payload = {"wid": wid, "items": wire}
                    if hdrs:
                        payload["hdrs"] = hdrs
                try:
                    with self._send_lock:
                        ser.conn_send(conn0, ("submit_batch", payload))
                except Exception as e:
                    # the window never reached the head: resolve its TASK
                    # refs locally with a retriable error (fail, never
                    # replay — at-most-once is the pinned reconnect
                    # semantic for tasks). Puts are idempotent (id minted
                    # once per op; head dedupes replays) so they re-queue
                    # for the next connection instead.
                    with self._submit_cv:
                        ent = self._submit_unacked.pop(wid, None)
                        if ent is not None:
                            # a reconnect sweep may have raced us here and
                            # already failed this window — decrementing
                            # again would drive the credit counter negative
                            # and quietly widen the flow-control window
                            self._submit_inflight -= len(ids)
                            # header definitions riding this (or any
                            # earlier) window may be lost with the conn:
                            # future windows must re-ship them (idempotent
                            # receiver-side)
                            self._sent_hdrs.clear()
                            err = rex.RayError(
                                "connection to the cluster was lost while "
                                "submitting a task window; the tasks did "
                                f"not run — retry ({e})"
                            )
                            put_ids = {s["obj_id"] for s in puts}
                            for rid in ids:
                                if rid not in put_ids:
                                    self._poisoned[rid] = err
                                    events.emit(
                                        "core.object.poison",
                                        obj_id=rid,
                                        reason="submit-window-lost",
                                    )
                            if puts:
                                self._submit_buf = [
                                    ("put", {**s, "replay": True})
                                    for s in puts
                                ] + self._submit_buf
                            self._set_credit_gauge()
                    return

    def _on_submit_ack(self, wid: int) -> None:
        with self._submit_cv:
            ent = self._submit_unacked.pop(wid, None)
            if ent is not None:
                self._submit_inflight -= len(ent[0])
                self._set_credit_gauge()
                self._submit_cv.notify_all()

    def _set_credit_gauge(self) -> None:
        _credit_gauge().set(
            max(0, GLOBAL_CONFIG.core_submit_window_tasks - self._submit_inflight)
        )

    def _fail_submits(self, not_on=None, replay_puts=True) -> None:
        """Connection died: resolve every TASK ref in un-acked windows (the
        head may or may not have processed them — the ack was lost with
        the socket) and every unsent buffered task spec to a retriable
        error. FAIL, never replay, is the pinned choice for tasks: blind
        replay of a window the head DID process would double-submit them.
        PUTS are the exception: a put id is minted exactly once
        per op, so redelivery is idempotent — the head dedupes
        replay-flagged puts — and un-acked/unsent put items re-queue for
        the fresh connection instead of poisoning their refs.
        ``replay_puts=False`` is the give-up sweep (reconnect failed or
        the context is closing): poison puts too, or their refs would
        hang. ``not_on`` spares windows already sent on the fresh
        post-reconnect conn."""
        err = rex.RayError(
            "connection to the cluster was lost before this submit window "
            "was acknowledged; it may not have run — retry the call"
        )
        with self._submit_cv:
            doomed: list[bytes] = []
            requeue: list = []
            for wid, ent in list(self._submit_unacked.items()):
                ids, conn0 = ent[0], ent[1]
                puts = ent[2] if len(ent) > 2 else []
                if not_on is None or conn0 is not not_on:
                    self._submit_unacked.pop(wid, None)
                    self._submit_inflight -= len(ids)
                    if replay_puts and puts:
                        put_ids = {s["obj_id"] for s in puts}
                        doomed.extend(i for i in ids if i not in put_ids)
                        requeue.extend(
                            ("put", {**s, "replay": True}) for s in puts
                        )
                    else:
                        doomed.extend(ids)
            if not_on is None:
                # full-failure sweep (reconnect not yet attempted or gave
                # up): unsent buffered task specs would otherwise sit
                # forever — fail them too. A post-reconnect sweep
                # (not_on=fresh) KEEPS the buffer: those specs never
                # touched any conn (shipping them on the fresh one cannot
                # double-submit), and some may postdate the reconnect.
                kept: list = []
                for _kind, spec in self._submit_buf:
                    if _kind == "put" and replay_puts:
                        kept.append((_kind, spec))  # never sent: no flag
                    else:
                        doomed.extend(spec["return_ids"])
                self._submit_buf = requeue + kept
            else:
                # replayed puts go to the FRONT: they predate everything
                # currently buffered
                self._submit_buf = requeue + self._submit_buf
            # header defs sent on the dead conn may not have survived
            # receiver-side (a fresh WorkerHandle starts with empty
            # submit_hdrs): re-ship every header on the next window —
            # idempotent for receivers that did keep them
            self._sent_hdrs.clear()
            for rid in doomed:
                self._poisoned[rid] = err
                # give-up sweeps (replay_puts=False) poison PUT ids too —
                # the forensic trail test_zero_copy_plane reads back
                events.emit(
                    "core.object.poison", obj_id=rid, reason="conn-lost"
                )
            self._set_credit_gauge()
            self._submit_cv.notify_all()

    def call(self, method: str, **payload):
        if self._submit_buf and threading.get_ident() != self._recv_ident:
            # buffered fire-and-forget submits precede every other RPC —
            # a get on their refs must find the head already owning them.
            # Never from the ack-processing thread: it parks in the credit
            # wait that only it can un-park (see _recv_ident)
            self._flush_submits()
        if method == "free_ref_async":
            # fire-and-forget decrement; workers never block on GC
            try:
                self._send(("req", 0, "free_ref", {"obj_id": payload["obj_id"]}))
            except Exception:
                pass
            return None
        if method == "free_refs_async":
            try:
                self._send(("req", 0, "free_refs", {"obj_ids": payload["obj_ids"]}))
            except Exception:
                pass
            return None
        return self._call_blocking(method, payload)

    def _free_refs_rpc(self, ids: list) -> None:
        # seq-0 send WITHOUT the fire-and-forget swallow: the gc drain
        # re-queues the chunk on failure (a raise means the kernel never
        # took the bytes — no double-decrement on retry). Routed through
        # send_raw, which flushes buffered submits first: a free racing
        # ahead of the submit window that CREATES its ref would be
        # consumed as a no-op and leave the ref pinned forever.
        if len(ids) == 1:
            self.send_raw(("req", 0, "free_ref", {"obj_id": ids[0]}))
        else:
            self.send_raw(("req", 0, "free_refs", {"obj_ids": ids}))

    def _call_blocking(self, method: str, payload: dict):
        seq = next(self._seq)
        ev = threading.Event()
        # slot[2] records the conn this call actually went out on (set by
        # _send UNDER the send lock): after a reconnect swap, slots tied to
        # the OLD conn are failed retriably — a send into a dying socket
        # can land in the kernel buffer without error, and without this the
        # caller would wait forever for a reply the head never saw
        slot = [ev, None, None]
        with self._pending_lock:
            self._pending[seq] = slot
        try:
            self._send(("req", seq, method, payload), slot=slot)
        except Exception as e:
            # reap the slot (seqs never repeat — a leaked slot lives
            # forever) and surface a retriable error: send failures are
            # ROUTINE during a client reconnect window
            with self._pending_lock:
                self._pending.pop(seq, None)
            raise rex.RayError(
                f"connection to the cluster lost while sending {method!r}; "
                f"retry the call ({e})"
            ) from e
        ev.wait()
        with self._pending_lock:
            self._pending.pop(seq, None)
        ok, result = slot[1]
        if not ok:
            raise result
        return result

    def _send(self, msg, slot=None):
        with self._send_lock:
            if slot is not None:
                if slot[1] is not None:
                    # a reconnect sweep failed this call BEFORE its send:
                    # transmitting now would execute a request whose caller
                    # was already told "retry" (double-submit). Surface the
                    # recorded error instead.
                    ok, err = slot[1]
                    if not ok:
                        raise err
                slot[2] = self.conn  # the conn the bytes actually ride
            ser.conn_send(self.conn, msg)

    def send_raw(self, msg):
        if self._submit_buf and threading.get_ident() != self._recv_ident:
            # completions/stream items must not overtake the submits that
            # preceded them (nested fan-out: parent's task_done after its
            # children's submit window). The recv thread is exempt (see
            # _recv_ident): its sends — exit-flush, header-miss errors —
            # have no causal order against exec threads' buffered submits,
            # and parking it wedges the worker permanently
            self._flush_submits()
        self._send(msg)

    # Pipelined put: puts ride the submit_batch window plane
    # instead of blocking a round trip each — a put burst coalesces into
    # one socket frame (bytes, or just the locator for arena-resident
    # values) and is bounded by head processing, not N RTTs. Ordering is
    # the window FIFO + the head consuming each connection in order: any
    # later use of the ref (submit, get, task_done carrying it out) rides
    # the same conn after the put. The window machinery supplies the
    # failure contract for free: an un-acked or unsendable window poisons
    # its ids (put ids included, via ``return_ids``) with a retriable
    # error — which also makes async puts safe across a ray:// driver's
    # reconnect — and head-side store failures land ON the object id as
    # an error locator (rpc_put never raises), so get() raises either way
    # instead of parking in the not-yet-arrived wait. Window credits
    # double as put backpressure: a burst cannot buffer unbounded bytes.
    _put_async = True

    def put_serialized(self, sv, is_error=False, take_ref=False) -> bytes:
        obj_id = ObjectID.for_put().binary()
        kind, payload, err = self.store_value(sv, is_error)
        if kind == "shm":
            events.emit(
                "core.object.put",
                obj_id=obj_id,
                size=payload.total_size,
                node=payload.node,
                seg=payload.name,
            )
        small, shm = (payload, None) if kind == "inline" else (None, payload)
        req = {
            "obj_id": obj_id, "small": small, "shm": shm, "is_error": err,
            "take_ref": take_ref,
        }
        if self._put_async and GLOBAL_CONFIG.core_put_pipeline:
            # return_ids: the window plane's unit of accounting — credits,
            # acks, and loss-poisoning all key off it
            req["return_ids"] = [obj_id]
            self._enqueue_submit("put", req)
            return obj_id
        self.call("put", **req)
        return obj_id


class RemoteDriverContext(WorkerContext):
    """A driver attached to a head in ANOTHER process/host over TCP
    (reference: ``ray.init(address=...)`` connecting to a running cluster;
    with a session token this is the ``ray://`` client protocol —
    reference ``util/client/``). Same RPC surface as a worker, plus its own
    response pump (workers get theirs from worker_main's recv loop).

    Reconnect-with-resume: on connection loss the pump redials the head
    presenting ``session_token`` for up to the reconnect grace. The head
    resumes the session (same namespace, refs intact — ClientSession in
    head.py); calls in flight AT the drop fail with a retriable RayError
    (resending them blindly could double-submit tasks), later calls ride
    the new connection transparently. Pipelined puts survive the
    reconnect: unlike tasks, a put id is minted exactly once per op, so a
    put in an un-acked window at the drop is REPLAYED on the fresh conn
    (the head dedupes replay-flagged puts) and unsent buffered puts ship
    there too; only when the reconnect itself gives up are put refs
    poisoned, so gets raise instead of hanging."""

    def __init__(
        self,
        conn,
        node_id_bin: bytes,
        authkey: Optional[bytes] = None,
        head_host: Optional[str] = None,
        address: Optional[str] = None,
        session_token: Optional[str] = None,
    ):
        super().__init__(conn, node_id_bin, remote=True, authkey=authkey, head_host=head_host)
        self.address = address
        self.session_token = session_token
        self._pump = threading.Thread(
            target=self._pump_loop, name="driver-pump", daemon=True
        )
        self._pump.start()

    def _fail_pending(self, not_on=None):
        """Fail pending calls retriably. ``not_on``: spare slots already
        sent on that (fresh) connection — used by the post-reconnect sweep
        so a call that raced onto the new conn keeps waiting for its real
        reply.

        The whole sweep holds ``_send_lock``: collection reads slot[2] and
        writes slot[1], which _send's pre-send guard reads/writes under the
        same lock — without it, a caller could pass the guard while the
        sweep dooms its (unsent) slot, then transmit a request whose caller
        was told to retry (double-submit)."""
        with self._send_lock:
            with self._pending_lock:
                doomed = [
                    (seq, s)
                    for seq, s in self._pending.items()
                    if not_on is None or s[2] is not not_on
                ]
                for seq, _ in doomed:
                    self._pending.pop(seq, None)
            for _seq, slot in doomed:
                slot[1] = (
                    False,
                    rex.RayError(
                        "connection to the cluster was lost mid-call; the "
                        "session was resumed — retry the call"
                    ),
                )
        for _seq, slot in doomed:
            slot[0].set()

    def _try_reconnect(self) -> bool:
        if self.address is None or self.session_token is None:
            return False
        import time as _time

        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.worker_main import connect_head

        deadline = _time.monotonic() + GLOBAL_CONFIG.client_reconnect_grace_s
        while _time.monotonic() < deadline and not self.closed:
            try:
                conn = connect_head(self.address, self.authkey, retries=1)
                conn.send(
                    ("register_driver", {"session_token": self.session_token})
                )
                kind, info = conn.recv()
                if kind != "driver_ack" or info.get("session_token") != self.session_token:
                    raise OSError("session not resumed")
                with self._send_lock:
                    self.conn = conn
                # calls that raced into the dying socket's kernel buffer
                # produced no error yet got no reply: fail everything not
                # already sent on the FRESH conn (they retry; a silent hang
                # would be the alternative). Same contract for submit
                # windows: un-acked ones fail retriably — their acks died
                # with the old socket and a blind replay could double-submit
                self._fail_pending(not_on=conn)
                self._fail_submits(not_on=conn)
                # head-side pubsub routing died with the old conn: re-send
                # subscribes for every channel with live sinks. Raw seq-0
                # requests — a blocking call() here would deadlock (this IS
                # the pump thread that processes replies).
                with self._pub_lock:
                    channels = [c for c, sinks in self._pub_sinks.items() if sinks]
                for channel in channels:
                    try:
                        self._send(("req", 0, "subscribe", {"channel": channel}))
                    except Exception:
                        break  # fresh conn died already: next loop retries
                return True
            except Exception:
                _time.sleep(0.5)
        return False

    def _pump_loop(self):
        # this thread processes submit_acks (see _recv_ident): the
        # send_raw/call flush guards exempt it from the credit wait
        self._recv_ident = threading.get_ident()
        while not self.closed:
            try:
                msg = self.conn.recv()
            # TypeError: a concurrent local close (chaos shutdown_conn, a
            # reconnect swap losing the race) nulls the Connection's handle
            # mid-_recv and CPython raises it instead of OSError — without
            # catching it here the pump thread dies silently and the session
            # never redials (every later call fails for the session's life)
            except (EOFError, OSError, ValueError, TypeError):
                # fail in-flight calls FIRST (they will never get replies;
                # failing after the swap could catch a call already sent on
                # the fresh connection), then redial with the session token
                self._fail_pending()
                self._fail_submits()
                if self.closed or not self._try_reconnect():
                    # giving up for good: re-queued puts will never ship —
                    # poison them so pending gets raise instead of hanging
                    self._fail_submits(replay_puts=False)
                    return
                continue
            if msg[0] == "resp":
                _, seq, ok, payload = msg
                self.on_response(seq, ok, payload)
            elif msg[0] == "pub":
                self.on_pub(msg[1], msg[2])
            elif msg[0] == "submit_ack":
                self._on_submit_ack(msg[1]["wid"])

    def shutdown(self):
        super().shutdown()
        from ray_tpu_torch._private.node_agent import shutdown_conn

        shutdown_conn(self.conn)  # interrupts the pump thread's recv too
