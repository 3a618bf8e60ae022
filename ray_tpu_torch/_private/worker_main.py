"""Worker process entry point and task executor (copy of
``ray_tpu/_private/worker_main.py`` without its JAX platform pin).

TPU-native counterpart of the reference's worker side: ``CoreWorkerProcess::
RunTaskExecutionLoop`` (``core_worker_process.cc:63``) plus the Cython task
executor (``_raylet.pyx:2177`` ``task_execution_handler``). One process, one
context; normal workers run tasks one at a time, actor workers hold the actor
instance and execute its methods in arrival order (= submission order, since
the head forwards over a FIFO socket), or on a thread pool when
``max_concurrency > 1`` (reference: threaded actors / concurrency groups).

Workers deliberately import no torch at startup: the heavy libraries load
lazily inside user functions, keeping worker spawn ~100ms, and the forkserver
template (``worker_template.py``), which imports this module, never
initialises CUDA, so every forked worker can still open the card.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
import traceback
from typing import Optional

from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private import events
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.log_util import warn_throttled
from ray_tpu_torch._private.runtime import ObjectRef, WorkerContext, set_ctx

#: flight-recorder events this module emits (raylint RL012 registry): a
#: task result / stream item entering the shm object plane from this
#: worker (the producer half of ``core.object.*`` for non-put objects).
EVENT_NAMES = ("core.object.put",)

#: raylint RL017 — the worker's recv/exec/cancel hand-off state is
#: deliberately lock-free (':atomic' = every write is one GIL-atomic
#: operation, verified by the linter):
#:
#: - cancel_requested: set.add from the recv thread, membership tests +
#:   discard from the executing thread — a cancel landing one bytecode
#:   after the test is simply delivered on the next check point, which is
#:   the documented best-effort cancel contract.
#: - task_threads: task_id -> executing-thread ident, dict store/pop by
#:   the executor, read by the recv thread to target the async interrupt;
#:   a miss means the task already finished (cancel is then a no-op).
#: - async_tasks: task_id -> asyncio.Task, stored on the loop thread,
#:   read by the recv thread for call_soon_threadsafe cancellation.
#: - group_sems: written ONCE at actor create, before actor_ready ships —
#:   every method dispatch happens-after by protocol order.
LOCKFREE = (
    "WorkerState.cancel_requested: atomic",
    "WorkerState.task_threads: atomic",
    "WorkerState.async_tasks: atomic",
    "WorkerState.group_sems: atomic",
)


class WorkerState:
    def __init__(self, ctx: WorkerContext):
        self.ctx = ctx
        # SimpleQueue: the recv->exec handoff runs once per dispatched task
        # and the C implementation shaves the pure-Python Condition dance
        # off the head_dispatch leg
        self.task_queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self.func_cache: dict[bytes, object] = {}
        # spec headers (cheaper per-task bytes): the head ships a
        # function's static spec fields once per worker; steady-state
        # run_task bodies reference them by id and rehydrate here
        self.hdr_cache: dict = {}
        # reply coalescing: finished-task payloads buffer here
        # while more work is queued and ship as ONE tasks_done_batch —
        # drained off-path by the reply flusher so a slow follower can
        # never withhold a finished result (an idle worker ships inline)
        self.reply_buf: list = []
        self.reply_lock = threading.Lock()  # guards reply_buf
        self.reply_send = threading.Lock()  # serializes drain+send (FIFO)
        self.reply_evt: Optional[threading.Event] = None
        self.actor_instance = None
        self.actor_id: Optional[bytes] = None
        self.actor_pool = None  # ThreadPoolExecutor for max_concurrency > 1
        # asyncio actors (any ``async def`` method): a dedicated event loop
        # thread runs every method (single-thread state semantics, like the
        # reference's per-concurrency-group asyncio loops, _raylet.pyx:2082);
        # concurrency bounded per group by asyncio.Semaphore.
        self.async_loop = None
        self.group_sems: dict[str, object] = {}
        self.group_pools: dict[str, object] = {}  # threaded actors w/ groups
        self.async_tasks: dict[bytes, object] = {}  # task_id -> asyncio.Task
        self.async_io_pool = None    # ThreadPoolExecutor: blocking arg fetches
        self.async_done_pool = None  # ThreadPoolExecutor: result store/send
        self.running = True
        self.exec_thread_id: Optional[int] = None
        self.cancel_requested: set[bytes] = set()
        self.current_task_id: Optional[bytes] = None
        # task_id -> ident of the thread executing it (the exec loop, or a
        # pool thread for max_concurrency>1 actors) — cancel targets THAT
        # thread, never the dispatch loop.
        self.task_threads: dict[bytes, int] = {}
        # streaming-generator backpressure: task_id -> highest consumer-acked
        # index+1, fed by the head's stream_ack pushes (_recv_loop)
        self.stream_acked: dict[bytes, int] = {}
        self.stream_cv = threading.Condition()


def connect_head(address: str, authkey: bytes, retries: int = 3):
    """Open the head control socket: ``host:port`` → TCP, else AF_UNIX.

    The hmac challenge handshake can spuriously fail under heavy concurrent
    connect churn (observed rarely in CI as ``digest sent was rejected``);
    retry a few times before giving up (reference: worker registration
    retries in worker_pool).
    """
    import time as _time
    from multiprocessing.connection import Client

    last: Exception = RuntimeError("unreachable")
    for attempt in range(retries):
        try:
            if ":" in address and not address.startswith("/"):
                host, port = address.rsplit(":", 1)
                return Client((host, int(port)), authkey=authkey)
            return Client(address, family="AF_UNIX", authkey=authkey)
        except Exception as e:  # noqa: BLE001 - auth/conn races
            last = e
            _time.sleep(0.1 * (attempt + 1))
    raise last


def main(
    socket_path: str,
    authkey: bytes,
    node_id_bin: bytes,
    token: str = "",
    remote: bool = False,
):
    # Fault injection for the registration-timeout path (tests): the FIRST
    # process to claim the sentinel wedges pre-registration, like an
    # interpreter that hangs at startup; respawns find the sentinel taken
    # and come up normally. Lives HERE (not _cli_main) so template-forked
    # workers are covered too — the wedge tests exercise the pidfd kill path.
    wedge = os.environ.get("RAY_TPU_TEST_WEDGE_ONCE")
    if wedge:
        try:
            fd = os.open(wedge, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            import time as _time

            _time.sleep(600.0)
        except FileExistsError:
            pass
    try:
        conn = connect_head(socket_path, authkey)
    except (FileNotFoundError, ConnectionError, EOFError):
        # cluster shut down while this worker was spawning — exit quietly
        # (a traceback here is pure teardown noise on every fast driver
        # exit; the reference's worker teardown is silent by design).
        # Other OSErrors (ENOSPC, EMFILE) stay loud: real faults.
        os._exit(0)
    head_host = socket_path.rsplit(":", 1)[0] if remote and ":" in socket_path else None
    ctx = WorkerContext(
        conn, node_id_bin, remote=remote, authkey=authkey, head_host=head_host
    )
    set_ctx(ctx)
    state = WorkerState(ctx)
    state.head_address = socket_path  # for detached-actor reconnect
    state.detached = False
    # SIGUSR1 → all-thread stack dump (C-level handler: fires even when the
    # GIL is held or the process is wedged mid-syscall) — the profiling
    # story for stuck workers (reporter.py; reference: py-spy dumps via
    # dashboard profile_manager)
    from ray_tpu_torch._private.reporter import arm_stack_dumps

    arm_stack_dumps()
    # flight recorder: flush the event ring to JSONL when this worker dies
    # by SIGTERM (how proc_handles kills us) or an unhandled exception —
    # the postmortem story for a replica shot mid-stream (events.py)
    from ray_tpu_torch._private import events as _events

    # in-band node origin: crash-flush files and OTLP resources keep their
    # node attribution even when the head never sees this process again
    _events.set_node(node_id_bin.hex()[:12])
    _events.record("worker.start", node=node_id_bin.hex()[:12])
    _events.install_crash_handlers()
    try:
        ctx.send_raw(
            ("register", {"pid": os.getpid(), "node_id": node_id_bin, "token": token})
        )
    except (ConnectionError, EOFError):
        os._exit(0)  # head died between connect and register: quiet exit

    recv = threading.Thread(target=_recv_loop, args=(conn, ctx, state), daemon=True)
    recv.start()
    prof_dir = os.environ.get("RAY_TPU_WORKER_CPROFILE")
    if prof_dir:
        # debugging hook (reference: py-spy / memray endpoints in
        # dashboard/modules/reporter/profile_manager.py): cProfile this
        # worker's exec loop, dump stats on exit for offline analysis
        import cProfile
        import signal

        pr = cProfile.Profile()

        def _dump(*_a):
            pr.disable()
            pr.dump_stats(os.path.join(prof_dir, f"worker-{os.getpid()}.prof"))
            # this handler REPLACES the flight recorder's SIGTERM hook —
            # flush the event ring here so a profiled worker still leaves
            # its postmortem JSONL (flush never raises)
            _events.flush(reason="sigterm")
            os._exit(0)

        global _prof_exit
        _prof_exit = _dump
        signal.signal(signal.SIGTERM, _dump)  # workers die by SIGTERM
        pr.enable()
        try:
            _exec_loop(state)
        finally:
            _dump()
    else:
        _exec_loop(state)
    os._exit(0)


def _try_reconnect(state: WorkerState, ctx: WorkerContext):
    """Detached-actor worker lost the head: retry the address for the
    reconnect grace window, re-register claiming our actor id, and
    re-announce readiness so the restored head rebinds us (state intact)."""
    import time

    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    addresses = [state.head_address]
    tcp = os.environ.get("RAY_TPU_HEAD_TCP")
    if tcp and tcp not in addresses:
        # a restarted head rebinds its TCP address; the old unix socket
        # died with the old process
        addresses.append(tcp)
    deadline = time.monotonic() + GLOBAL_CONFIG.head_reconnect_grace_s
    attempt = 0
    while time.monotonic() < deadline and state.running:
        address = addresses[attempt % len(addresses)]
        attempt += 1
        try:
            conn = connect_head(address, ctx.authkey, retries=1)
            conn.send(
                (
                    "register",
                    {
                        "pid": os.getpid(),
                        "node_id": ctx.node_id_bin,
                        "token": "",
                        "actor_id": state.actor_id,
                    },
                )
            )
            conn.send(("actor_ready", {"actor_id": state.actor_id, "error": None}))
            ctx.conn = conn
            # un-acked submit windows died with the OLD conn (their acks
            # are unrecoverable and the restored head may never have seen
            # them): fail them retriably and re-ship header definitions on
            # the next window (fail-not-replay, the pinned semantic).
            # not_on=conn spares a window a concurrent exec thread already
            # delivered on the FRESH conn — poisoning that one would make
            # the caller's retry a double-submit
            ctx._fail_submits(not_on=conn)
            return conn
        except Exception:
            time.sleep(0.5)
    return None


def _recv_loop(conn, ctx: WorkerContext, state: WorkerState):
    # this thread processes submit_acks: it must never park in the submit
    # credit wait (runtime._recv_ident — send_raw/call skip the flush here)
    ctx._recv_ident = threading.get_ident()
    # buffered framed reads (ser.ConnReader): one syscall per kernel batch
    # instead of two per message; this loop is the conn's only reader
    reader = ser.ConnReader(conn)
    while state.running:
        try:
            msg = reader.recv()
        # ValueError/TypeError: a concurrent local close nulls the conn's
        # handle mid-read (same contract as the driver pump loop)
        except (EOFError, OSError, ValueError, TypeError):
            if state.actor_id is not None and getattr(state, "detached", False):
                newconn = _try_reconnect(state, ctx)
                if newconn is not None:
                    conn = newconn
                    reader = ser.ConnReader(conn)
                    continue
            # the head is gone (its driver died): no result of a task here
            # can reach anyone, so the process ends now, not after a
            # running task — a task on the card would hold it for nothing
            if _prof_exit is not None:
                _prof_exit()
            os._exit(0)
        kind = msg[0]
        if kind == "run_task":  # hottest message first (one per task)
            spec = _rehydrate_spec(state, msg[1])
            if spec is not None:  # None = header miss, already failed
                _stamp_deserialized(spec)
                state.task_queue.put(spec)
        elif kind == "resp":
            _, seq, ok, payload = msg
            ctx.on_response(seq, ok, payload)
        elif kind == "pub":
            ctx.on_pub(msg[1], msg[2])
        elif kind == "run_task_batch":
            # head coalesced dispatches (flush_outbox); FIFO order within
            # the batch is the dispatch order
            for spec in msg[1]:
                spec = _rehydrate_spec(state, spec)
                if spec is not None:
                    _stamp_deserialized(spec)
                    state.task_queue.put(spec)
        elif kind == "submit_ack":
            # window credits for this worker's own pipelined submissions
            ctx._on_submit_ack(msg[1]["wid"])
        elif kind == "cancel":
            _handle_cancel(state, msg[1])
        elif kind == "stream_ack":
            with state.stream_cv:
                tid = msg[1]["task_id"]
                state.stream_acked[tid] = max(
                    state.stream_acked.get(tid, 0), msg[1]["consumed"]
                )
                state.stream_cv.notify_all()
        elif kind == "profile":
            _start_profile(ctx, msg[1])
        elif kind == "events_drain":
            _drain_events(ctx, msg[1])
        elif kind == "object_report":
            _object_report(ctx, msg[1])
        elif kind == "exit":
            state.running = False
            state.task_queue.put(None)
            try:
                _flush_done(state)  # deferred completions must not die with us
            except Exception as e:
                # conn already dead: nothing left to ship them on
                warn_throttled("exit-flush deferred completions", e)
            if _prof_exit is not None:
                _prof_exit()
            os._exit(0)


def _stamp_deserialized(spec: dict) -> None:
    """worker_deserialize stamp, taken in the RECV loop where the spec's
    bytes were actually parsed (ConnReader) and its header rehydrated —
    not at ``_run_task`` entry on the exec thread. The distinction is the
    honest-attribution contract under batching: task #64 of a
    ``run_task_batch`` waits its whole queue depth for the exec thread,
    and that wait belongs to the worker_deserialize→exec_start leg (the
    worker's own backlog), not to ``head_dispatch`` (the head+wire hop)."""
    wf = spec.get("wf")
    if wf is not None:
        if _waterfall is None:
            _bind_task_mods()
        _waterfall.stamp(wf)  # worker_deserialize


def _rehydrate_spec(state: WorkerState, spec: dict) -> dict:
    """Expand a header-split run_task body back into a full spec. Header
    definitions ride the same FIFO conn before any reference to them, so a
    miss means connection-state loss — fail the task's refs instead of
    crashing the recv loop."""
    hd = spec.pop("_hdr_def", None)
    if hd is not None:
        state.hdr_cache[hd[0]] = hd[1]
        return {**hd[1], **spec}
    hid = spec.pop("_hdr_ref", None)
    if hid is None:
        return spec
    fields = state.hdr_cache.get(hid)
    if fields is None:
        err = rex.RayTaskError.from_exception(
            spec.get("name", "task"),
            rex.RayError("run_task referenced a spec header this worker never saw"),
        )
        results = [
            (rid, ("inline", ser.serialize(err).to_bytes(), True))
            for rid in spec.get("return_ids", ())
        ]
        try:
            state.ctx.send_raw(
                ("task_done",
                 {"task_id": spec["task_id"], "results": results, "results_error": True})
            )
        except Exception:
            pass
        return None
    return {**fields, **spec}


_profile_gate = threading.Lock()
_prof_exit = None  # set by main() when RAY_TPU_WORKER_CPROFILE is on

# lazily-bound task-path modules: imported on the FIRST task (workers
# deliberately keep startup import-light), then the per-task path pays
# module-global loads instead of sys.modules lookups
_renv = None
_tracing = None
_waterfall = None


def _bind_task_mods() -> None:
    global _renv, _tracing, _waterfall
    from ray_tpu_torch._private import runtime_env as renv
    from ray_tpu_torch.util import tracing, waterfall

    _renv, _tracing, _waterfall = renv, tracing, waterfall


def _start_profile(ctx, req: dict) -> None:
    """On-demand sampling CPU profile (reference: the dashboard's py-spy
    endpoint): sample this worker's threads off the recv loop, then post
    the collapsed stacks back to the head's reply mailbox. Single-flight
    with a bounded duration: samplers burn GIL time, so overlapping
    requests (a dashboard poller in a retry loop) must not stack."""

    def _run():
        from ray_tpu_torch._private.reporter import sample_profile

        if not _profile_gate.acquire(blocking=False):
            text = "<profile already in progress>"
        else:
            try:
                text = sample_profile(
                    min(float(req.get("duration_s", 2.0)), 60.0),
                    float(req.get("interval_s", 0.01)),
                )
            except Exception as e:
                text = f"<profile failed: {e!r}>"
            finally:
                _profile_gate.release()
        try:
            ctx.send_raw(
                ("profile_result",
                 {"req_id": req["req_id"], "pid": os.getpid(), "profile": text})
            )
        except Exception:
            pass  # head gone: nothing to report to

    threading.Thread(target=_run, daemon=True, name="rt-profiler").start()


def _drain_events(ctx, req: dict) -> None:
    """Reply with this worker's flight-recorder ring (head rendezvous:
    ``rpc_collect_events``). Snapshot off the recv loop — the ring can be
    large and serialization must not stall task dispatch."""

    def _run():
        from ray_tpu_torch._private import events as _ev

        try:
            evs = _ev.snapshot()
        except Exception as e:  # noqa: BLE001 — drain is best-effort
            evs = [{"type": "events.drain_failed", "error": repr(e)}]
        try:
            ctx.send_raw(
                ("events_result",
                 {"req_id": req["req_id"], "pid": os.getpid(), "events": evs})
            )
        except Exception:
            pass  # head gone: nothing to report to

    threading.Thread(target=_run, daemon=True, name="rt-events-drain").start()


def _object_report(ctx, req: dict) -> None:
    """Reply with this process's object-plane residency (head rendezvous:
    ``rpc_object_ledger``/``rpc_object_audit``): live arena pins with
    ages (leak-audit input — every pin must map to a live reader), ids
    this context has poisoned locally, and the attached arena's
    occupancy. Off the recv loop like the events drain."""

    def _run():
        from ray_tpu_torch._private import shm_store

        report: dict = {}
        try:
            report = shm_store.pin_stats()
            report["poisoned"] = [
                oid.hex() for oid in list(getattr(ctx, "_poisoned", {}))
            ]
            arena = shm_store._current_write_arena()
            if arena is not None:
                report["arena"] = {
                    "name": arena.name,
                    "used": arena.used,
                    "capacity": arena.capacity,
                    "n_objects": arena.n_objects,
                }
        except Exception as e:  # noqa: BLE001 — report is best-effort
            report = {"error": repr(e)}
        try:
            ctx.send_raw(
                ("object_report_result",
                 {"req_id": req["req_id"], "pid": os.getpid(),
                  "report": report})
            )
        except Exception:
            pass  # head gone: nothing to report to

    threading.Thread(target=_run, daemon=True, name="rt-object-report").start()


def _handle_cancel(state: WorkerState, task_id: bytes):
    state.cancel_requested.add(task_id)
    atask = state.async_tasks.get(task_id)
    if atask is not None and state.async_loop is not None:
        state.async_loop.call_soon_threadsafe(atask.cancel)
        return
    tid = state.task_threads.get(task_id)
    if tid is not None:
        # best-effort async interrupt (reference: SIGINT into the worker),
        # into the thread running this task only
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(tid), ctypes.py_object(rex.TaskCancelledError)
        )


def _exec_loop(state: WorkerState):
    state.exec_thread_id = threading.get_ident()
    while state.running:
        spec = state.task_queue.get()
        if spec is None:
            break
        try:
            _exec_one(state, spec)
        except (BrokenPipeError, ConnectionResetError, EOFError):
            # the head vanished mid-result-send (driver exited): nothing
            # left to report to — exit without a traceback
            os._exit(0)


def _exec_one(state: WorkerState, spec: dict):
    if spec["kind"] == "actor_method" and state.async_loop is not None:
        _dispatch_async(state, spec)
    elif spec["kind"] == "actor_method" and state.group_pools:
        group = spec.get("concurrency_group") or "_default"
        pool = state.group_pools.get(group)
        if pool is None:
            err = rex.RayTaskError.from_exception(
                spec.get("name", "task"),
                ValueError(
                    f"Unknown concurrency group {group!r}; declared: "
                    f"{sorted(g for g in state.group_pools if g != '_default')}"
                ),
            )
            _finish_task(state, spec, err, is_error=True)
        else:
            pool.submit(_run_spec, state, spec)
    elif spec["kind"] == "actor_method" and state.actor_pool is not None:
        state.actor_pool.submit(_run_spec, state, spec)
    else:
        _run_spec(state, spec)


def _run_spec(state: WorkerState, spec: dict):
    kind = spec["kind"]
    if kind == "actor_create":
        _run_actor_create(state, spec)
    else:
        _run_task(state, spec)


def _resolve_function(state: WorkerState, func_id: bytes):
    fn = state.func_cache.get(func_id)
    if fn is None:
        blob = state.ctx.call("get_function", func_id=func_id)
        fn = ser.loads(blob)
        state.func_cache[func_id] = fn
    return fn


def _load_args(state: WorkerState, spec: dict):
    """Deserialize by-value args; fetch by-ref args from the store. Errors in
    dependencies propagate (reference: RayTaskError poisoning dependents)."""
    s_args = spec.get("args", ())
    s_kwargs = spec.get("kwargs")
    if not s_args and not s_kwargs:
        return [], {}  # hot path: no-arg calls skip the fetch machinery
    ref_ids = []
    for a in list(s_args) + list(s_kwargs.values() if s_kwargs else ()):
        if a[0] == "r":
            ref_ids.append(a[1])
    fetched = {}
    if ref_ids:
        locators = state.ctx.call("get", obj_ids=ref_ids, timeout=None)
        for oid, loc in zip(ref_ids, locators):
            value = state.ctx._materialize(oid, loc)
            if loc[2]:  # dependency failed
                if isinstance(value, rex.RayTaskError):
                    raise value.as_instanceof_cause()
                raise value
            fetched[oid] = value

    def one(a):
        if a[0] == "r":
            return fetched[a[1]]
        return ser.deserialize_value(ser.SerializedValue.from_bytes(a[1]))

    args = [one(a) for a in spec.get("args", ())]
    kwargs = {k: one(v) for k, v in spec.get("kwargs", {}).items()}
    return args, kwargs


def _store_results(state: WorkerState, spec: dict, value, is_error=False):
    """Serialize returns; small ones ride the task_done message, large ones go
    straight to shm from this process (zero extra copies)."""
    return_ids = spec["return_ids"]
    n = len(return_ids)
    if value is None and not is_error and n == 1:
        # the most common result: ship the precomputed constant, skip the
        # whole cloudpickle + SerializedValue round per task
        return [(return_ids[0], ("inline", ser.NONE_BYTES, False))]
    if is_error or n == 1:
        values = [value] * n if n else []
    else:
        try:
            values = list(value)
        except TypeError:
            values = [value]
        if len(values) != n:
            err = rex.RayTaskError.from_exception(
                spec.get("name", "task"),
                ValueError(f"Task declared num_returns={n} but returned {type(value)}"),
            )
            return _store_results(state, spec, err, is_error=True)
    results = []
    for rid, v in zip(return_ids, values):
        try:
            sv = ser.serialize(v)
        except Exception as e:  # unserializable return
            sv = ser.serialize(rex.RayTaskError.from_exception(spec.get("name", "task"), e))
            is_error = True
        # large results land in THIS host's shm and only the locator travels
        # (agent hosts serve the bytes peer-to-peer; see data_plane.py) —
        # remote processes without a local store fall back to inline
        locator = state.ctx.store_value(sv, is_error)
        if locator[0] == "shm":
            events.emit(
                "core.object.put",
                obj_id=rid,
                size=locator[1].total_size,
                node=locator[1].node,
                seg=locator[1].name,
            )
        results.append((rid, locator))
    return results


def _stream_results(state: WorkerState, spec: dict, gen) -> None:
    """Drive a streaming-generator task (num_returns="streaming"): each
    yielded item becomes its own object, reported to the head as it is
    produced (reference: ReportGeneratorItemReturns, _raylet.pyx:1230),
    with a consumer-acked backpressure window
    (``streaming_backpressure_items``). The task's single declared return
    becomes the completion object: None on success, the exception on a
    mid-stream failure.

    The generator BODY runs during this drive (not at creation), possibly
    on an async actor's done-pool thread — (re-)install the submitter's
    trace context here so spans/events inside streaming bodies (the serve
    LLM path) keep their request_id for the stream's whole life."""
    if _tracing is None:
        _bind_task_mods()

    prev_trace = _tracing.set_trace_context(
        _tracing.task_context(spec.get("trace_ctx"), spec["task_id"])
    )
    try:
        _stream_results_inner(state, spec, gen)
    finally:
        _tracing.set_trace_context(prev_trace)


def _stream_results_inner(state: WorkerState, spec: dict, gen) -> None:
    from ray_tpu_torch._private.ids import ObjectID, TaskID

    task_id = spec["task_id"]
    cap = max(1, GLOBAL_CONFIG.streaming_backpressure_items)
    idx = 0
    err = None
    try:
        it = iter(gen)
    except TypeError:
        err = rex.RayTaskError.from_exception(
            spec.get("name", "task"),
            TypeError(
                f'num_returns="streaming" requires the task to return an '
                f"iterable/generator, got {type(gen).__name__}"
            ),
        )
        it = iter(())
    while err is None:
        if task_id in state.cancel_requested:
            err = rex.TaskCancelledError()
            break
        try:
            item = next(it)
        except StopIteration:
            break
        except BaseException as e:  # noqa: BLE001 - ships to consumer
            err = e if isinstance(e, rex.RayTaskError) else rex.RayTaskError.from_exception(
                spec.get("name", "task"), e
            )
            break
        try:
            sv = ser.serialize(item)
        except Exception as e:  # unserializable item
            err = rex.RayTaskError.from_exception(spec.get("name", "task"), e)
            break
        locator = state.ctx.store_value(sv)
        if locator[0] == "shm":
            events.emit(
                "core.object.put",
                size=locator[1].total_size,
                node=locator[1].node,
                seg=locator[1].name,
            )
        with state.stream_cv:
            while (
                idx - state.stream_acked.get(task_id, 0) >= cap
                and task_id not in state.cancel_requested
            ):
                state.stream_cv.wait(timeout=0.5)
        if task_id in state.cancel_requested:
            err = rex.TaskCancelledError()
            break
        oid = ObjectID.for_task_return(TaskID(task_id), 1 + idx).binary()
        state.ctx.send_raw(
            ("stream_item", {"task_id": task_id, "index": idx, "obj_id": oid, "locator": locator})
        )
        idx += 1
    with state.stream_cv:
        state.stream_acked.pop(task_id, None)
    is_error = err is not None
    try:
        results = _store_results(state, spec, err if is_error else None, is_error)
    except BaseException:  # noqa: BLE001
        traceback.print_exc()
        results = []
    _emit_done(
        state,
        {
            "task_id": task_id,
            "results": results,
            "results_error": is_error,
            "stream_count": idx,
        },
    )


def _sync_over_asyncgen(agen, loop):
    """Bridge an async generator to a plain iterator: every ``__anext__``
    is marshalled onto the actor's event loop thread (state invariant),
    while the consuming ``_stream_results`` loop runs on a pool thread."""
    import asyncio

    while True:
        try:
            yield asyncio.run_coroutine_threadsafe(agen.__anext__(), loop).result()
        except StopAsyncIteration:
            return


def _run_task(state: WorkerState, spec: dict):
    if _renv is None:
        _bind_task_mods()
    renv = _renv

    task_id = spec["task_id"]
    state.current_task_id = task_id
    state.task_threads[task_id] = threading.get_ident()
    # task-hop waterfall: a sampled spec arrives with the submitter's,
    # head's, and recv loop's stamps (worker_deserialize is taken at
    # receipt — _stamp_deserialized); exec_start/exec_end bracket the
    # body, and the list rides the task_done payload back so the head
    # can fold reply_recv
    wf = spec.get("wf")
    # re-install the submitter's trace context on the executing thread:
    # spans/events inside the task body (and any nested .remote() hops)
    # carry the same request_id end-to-end (util.tracing module doc).
    # A spec with no context gets a LAZY task-rooted one — the id (and
    # its sampling decision) materialize only if something observes it
    prev_trace = _tracing.set_trace_context(
        _tracing.task_context(spec.get("trace_ctx"), task_id)
    )
    if spec["kind"] != "actor_method":
        # a plain task runs in its SUBMITTER's namespace (client sessions):
        # named-actor ops inside the function resolve where the submitter's
        # would. Actor methods keep the ACTOR's namespace (set at create) —
        # reference semantics: an actor belongs to its job's namespace.
        state.ctx.namespace = spec.get("namespace") or "default"
    is_error = False
    try:
        if task_id in state.cancel_requested:
            raise rex.TaskCancelledError()
        if spec["kind"] == "actor_method":
            method = _resolve_actor_method(state, spec["method_name"])
            args, kwargs = _load_args(state, spec)
            if wf is not None:
                _waterfall.stamp(wf)  # exec_start
            value = method(*args, **kwargs)
        else:
            fn = _resolve_function(state, spec["func_id"])
            args, kwargs = _load_args(state, spec)
            if wf is not None:
                _waterfall.stamp(wf)  # exec_start
            env = spec.get("runtime_env")
            if not env:
                # no runtime env: skip the contextmanager protocol — its
                # enter/exit generator dance is pure overhead per task
                value = fn(*args, **kwargs)
            else:
                with renv.applied(env, state.ctx):
                    value = fn(*args, **kwargs)
        if wf is not None:
            _waterfall.stamp(wf)  # exec_end
    except BaseException as e:  # noqa: BLE001
        if isinstance(e, rex.TaskCancelledError):
            value = e
        elif isinstance(e, rex.RayTaskError):
            value = e
        else:
            value = rex.RayTaskError.from_exception(spec.get("name", "task"), e)
        is_error = True
    finally:
        _tracing.set_trace_context(prev_trace)
        state.current_task_id = None
        state.task_threads.pop(task_id, None)
        state.cancel_requested.discard(task_id)
    if spec.get("num_returns") == "streaming" and not is_error:
        # the function returned a generator: drive it item by item
        # (_stream_results re-installs the trace context for the drive)
        _stream_results(state, spec, value)
        return
    try:
        results = _store_results(state, spec, value, is_error)
    except BaseException:  # noqa: BLE001
        traceback.print_exc()
        results = []
    payload = {"task_id": task_id, "results": results, "results_error": is_error}
    if wf is not None:
        payload["wf"] = wf
    _emit_done(state, payload)


def _emit_done(state: WorkerState, payload: dict) -> None:
    """Ship a completion — coalescing a burst into one reply message.

    An idle worker (nothing else queued) ships INLINE: the sync round trip
    pays zero added latency and no thread handoff. With more work queued,
    the payload joins the reply buffer and the off-path flusher thread
    drains whatever accumulated into ONE tasks_done_batch pickle+write —
    unlike the defer-until-queue-empty idea (tried and reverted pre-PR
    13), a finished result is only ever withheld for the flusher's wakeup,
    never for the DURATION of the next pipelined task."""
    if not state.reply_buf and state.task_queue.empty():
        # idle fast path (the sync round trip): nothing buffered, nothing
        # queued — one send under the drain lock, no buffer round trip.
        # Out-of-order risk is nil: completions are per-task keyed and the
        # in-lock re-check keeps us behind any concurrently buffered batch
        with state.reply_send:
            if not state.reply_buf:
                state.ctx.send_raw(("task_done", payload))
                return
    with state.reply_lock:
        state.reply_buf.append(payload)
        n = len(state.reply_buf)
    if (
        n < GLOBAL_CONFIG.core_reply_batch_max
        and state.running
        and not state.task_queue.empty()
    ):
        _reply_flusher_evt(state).set()
        return
    try:
        _flush_done(state)
    except Exception:
        # conn churn: the batch is back on the buffer — hand it to the
        # flusher's retry loop instead of crashing the exec thread (a
        # detached actor survives the reconnect and re-ships)
        _reply_flusher_evt(state).set()


def _flush_done(state: WorkerState) -> None:
    with state.reply_send:  # one drainer at a time = completion-order FIFO
        with state.reply_lock:
            batch = state.reply_buf
            state.reply_buf = []
        if not batch:
            return
        msg = ("task_done", batch[0]) if len(batch) == 1 else (
            "tasks_done_batch", batch
        )
        try:
            state.ctx.send_raw(msg)
        except Exception:
            # conn died mid-flush: put the batch BACK (front, order kept)
            # so the post-reconnect flush re-ships it — a raise here means
            # the kernel never accepted the bytes, so re-sending on the
            # fresh conn cannot double-deliver
            with state.reply_lock:
                state.reply_buf = batch + state.reply_buf
            raise


def _reply_flusher_evt(state: WorkerState) -> threading.Event:
    evt = state.reply_evt
    if evt is not None:
        return evt
    with state.reply_send:  # double-checked: one flusher per worker
        evt = state.reply_evt
        if evt is not None:
            return evt
        evt = threading.Event()

        def loop():
            import time

            while state.running:
                evt.wait()
                evt.clear()
                while state.running:
                    try:
                        _flush_done(state)
                        break
                    except (BrokenPipeError, ConnectionResetError, EOFError,
                            OSError, ValueError, TypeError):
                        # conn churn (head gone, or a detached-actor
                        # reconnect mid-swap): the batch went back on the
                        # buffer — retry until the fresh conn lands or the
                        # worker exits. NEVER return: a dead flusher with
                        # a live event would silently withhold buffered
                        # completions for up to core_reply_batch_max tasks
                        time.sleep(0.1)
                    except Exception:  # noqa: BLE001 - flusher must survive
                        traceback.print_exc()
                        time.sleep(0.1)

        threading.Thread(target=loop, name="reply-flusher", daemon=True).start()
        state.reply_evt = evt
    return evt


def _resolve_actor_method(state: WorkerState, name: str):
    if name == "__dag_exec__":
        import functools

        return functools.partial(_dag_exec_loop, state.actor_instance)
    return getattr(state.actor_instance, name)


def _dag_exec_loop(instance, method_name: str, in_specs, out_channels, call_on_loop=None):
    """Compiled-DAG executor (reference: compiled_dag_node.py executors).

    Owns this actor's dispatch queue until teardown: block on the input
    channels, invoke the bound method, push the result to every consumer
    edge. Exceptions travel through the channels as wrapped errors so the
    driver's CompiledDAGRef.get re-raises them; channel close ends the loop.

    For async actors the channel loop runs on a daemon thread, and
    ``call_on_loop`` (the actor's event loop) is set: each invocation is
    marshalled onto the loop thread so actor state is still only ever
    touched from that one thread.
    """
    from ray_tpu_torch.dag.compiled import _WrappedError
    from ray_tpu_torch.experimental.channel import ChannelClosed

    method = getattr(instance, method_name)
    if call_on_loop is not None:
        import asyncio
        import concurrent.futures
        import inspect

        inner = method
        if inspect.iscoroutinefunction(inner):
            def method(*a, **k):  # noqa: F811
                return asyncio.run_coroutine_threadsafe(inner(*a, **k), call_on_loop).result()
        else:
            def method(*a, **k):  # noqa: F811
                cfut = concurrent.futures.Future()

                def _run():
                    try:
                        cfut.set_result(inner(*a, **k))
                    except BaseException as e:  # noqa: BLE001
                        cfut.set_exception(e)

                call_on_loop.call_soon_threadsafe(_run)
                return cfut.result()
    while True:
        try:
            # drain EVERY input channel each round, even when one carries an
            # upstream error — skipping reads would desynchronize multi-input
            # nodes (later rounds pairing values from different executions)
            args = []
            upstream_err = None
            for kind, v in in_specs:
                if kind == "chan":
                    v = v.read()
                    if isinstance(v, _WrappedError) and upstream_err is None:
                        upstream_err = v
                args.append(v)
            if upstream_err is not None:
                value = upstream_err
            else:
                try:
                    value = method(*args)
                except BaseException as e:  # noqa: BLE001 - ships to driver
                    value = _WrappedError(e)
            for out in out_channels:
                out.write(value)
        except ChannelClosed:
            return "closed"


def _setup_actor_concurrency(state: WorkerState, spec: dict) -> None:
    """Pick the actor's execution engine (reference: async actors on asyncio
    event loops, _raylet.pyx:2082-2084; threaded actors + concurrency groups,
    core_worker/transport/concurrency_group_manager.cc).

    * any ``async def`` method -> one event-loop thread runs ALL methods
      (so actor state is only ever touched from one thread); per-group
      semaphores bound concurrency. Async actors default to a high limit
      (1000, like the reference) unless max_concurrency says otherwise.
    * plain class + concurrency_groups -> one thread pool per group.
    * plain class + max_concurrency>1 -> single thread pool (legacy path).
    """
    import asyncio
    import inspect

    cls = type(state.actor_instance)
    is_async = any(
        inspect.iscoroutinefunction(getattr(cls, n, None))
        or inspect.isasyncgenfunction(getattr(cls, n, None))
        for n in dir(cls)
        if not n.startswith("__")
    )
    groups = dict(spec.get("concurrency_groups") or {})
    mc = spec.get("max_concurrency")  # None = not set by the user
    if is_async:
        from concurrent.futures import ThreadPoolExecutor

        state.async_loop = asyncio.new_event_loop()
        threading.Thread(
            target=state.async_loop.run_forever, name="actor-asyncio", daemon=True
        ).start()
        # async actors default to high concurrency (reference: 1000); an
        # EXPLICIT max_concurrency=1 genuinely serializes the actor.
        default_limit = 1000 if mc is None else max(int(mc), 1)
        state.group_sems = {"_default": asyncio.Semaphore(default_limit)}
        for g, n in groups.items():
            state.group_sems[g] = asyncio.Semaphore(max(int(n), 1))
        # Blocking head I/O runs on these, never on the loop thread. Arg
        # fetches (which can wait indefinitely on unready ObjectRefs) and
        # result completions get SEPARATE pools: if they shared one, enough
        # blocked loads would starve the _finish_task that produces the very
        # object those loads wait for (deadlock).
        state.async_io_pool = ThreadPoolExecutor(
            max_workers=min(32, max(4, len(groups) * 2 + 4)),
            thread_name_prefix="actor-io",
        )
        state.async_done_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="actor-done"
        )
    elif groups:
        from concurrent.futures import ThreadPoolExecutor

        state.group_pools = {
            "_default": ThreadPoolExecutor(max_workers=max(int(mc or 1), 1))
        }
        for g, n in groups.items():
            state.group_pools[g] = ThreadPoolExecutor(max_workers=max(int(n), 1))
    elif mc is not None and int(mc) > 1:
        from concurrent.futures import ThreadPoolExecutor

        state.actor_pool = ThreadPoolExecutor(max_workers=int(mc))


def _dispatch_async(state: WorkerState, spec: dict) -> None:
    """Schedule an actor method onto the actor's event loop immediately.

    All blocking head I/O — arg fetch at the start, result store/send at the
    end — runs on ``state.async_io_pool`` threads, never on the dispatch
    thread (one unready ObjectRef arg must not block dispatch of the later
    method that produces it) and never on the loop thread."""
    import asyncio

    asyncio.run_coroutine_threadsafe(_arun(state, spec), state.async_loop)


async def _arun(state: WorkerState, spec: dict):
    import asyncio
    import functools
    import inspect

    if _tracing is None:
        _bind_task_mods()

    loop = asyncio.get_running_loop()
    task_id = spec["task_id"]
    state.async_tasks[task_id] = asyncio.current_task()
    is_error = False
    # task-hop waterfall (sampled specs only; see _run_task — the
    # worker_deserialize stamp was taken at receipt in the recv loop).
    # exec_start is stamped after the arg fetch below; exec_end after
    # the method.
    wf = spec.get("wf")
    # best-effort trace context for async actors: the loop thread is shared,
    # so interleaved coroutines can momentarily see each other's context —
    # spans inside async methods still tag correctly in the common
    # one-request-at-a-time case (sync actors get exact scoping in _run_task).
    # On exit the context is CLEARED (if still ours) rather than restored:
    # under interleaving, a saved "previous" context can belong to a request
    # that already finished, and restoring it would tag the loop thread's
    # later events with a dead request's id indefinitely.
    my_trace = _tracing.task_context(spec.get("trace_ctx"), task_id)
    _tracing.set_trace_context(my_trace)
    try:
        group = spec.get("concurrency_group")
        if group and group not in state.group_sems:
            raise ValueError(
                f"Unknown concurrency group {group!r}; declared groups: "
                f"{sorted(g for g in state.group_sems if g != '_default')}"
            )
        sem = state.group_sems[group or "_default"]
        if task_id in state.cancel_requested:
            raise rex.TaskCancelledError()
        args, kwargs = await loop.run_in_executor(
            state.async_io_pool, functools.partial(_load_args, state, spec)
        )
        async with sem:
            if task_id in state.cancel_requested:
                raise rex.TaskCancelledError()
            method = _resolve_actor_method(state, spec["method_name"])
            if wf is not None:
                _waterfall.stamp(wf)  # exec_start
            if inspect.iscoroutinefunction(method):
                value = await method(*args, **kwargs)
            elif spec["method_name"] == "__dag_exec__":
                # The compiled-DAG executor loop blocks on channels until
                # teardown; parking it on the event loop (or a shared
                # executor) would wedge every other method of this actor.
                # Run the channel loop on a dedicated daemon thread, but
                # marshal each bound-method invocation back onto the event
                # loop (via call_on_loop) so actor state keeps its
                # single-thread invariant (_setup_actor_concurrency).
                method = functools.partial(method, call_on_loop=loop)
                fut = loop.create_future()

                def _dag_runner():
                    try:
                        r = method(*args, **kwargs)
                    except BaseException as e:  # noqa: BLE001
                        res, err = None, e
                    else:
                        res, err = r, None

                    def _complete():
                        if fut.cancelled():
                            return
                        if err is not None:
                            fut.set_exception(err)
                        else:
                            fut.set_result(res)

                    try:
                        loop.call_soon_threadsafe(_complete)
                    except RuntimeError:
                        pass  # loop already closed (worker shutdown)

                threading.Thread(target=_dag_runner, daemon=True, name="dag-exec").start()
                value = await fut
            else:
                value = method(*args, **kwargs)
        if wf is not None:
            _waterfall.stamp(wf)  # exec_end
    except BaseException as e:  # noqa: BLE001
        if isinstance(e, asyncio.CancelledError):
            value = rex.TaskCancelledError()
        elif isinstance(e, (rex.TaskCancelledError, rex.RayTaskError)):
            value = e
        else:
            value = rex.RayTaskError.from_exception(spec.get("name", "task"), e)
        is_error = True
    finally:
        if _tracing.get_trace_context() is my_trace:
            _tracing.set_trace_context(None)
        state.async_tasks.pop(task_id, None)
        state.cancel_requested.discard(task_id)
    if spec.get("num_returns") == "streaming" and not is_error:
        # drive the generator off the loop thread; async generators are
        # bridged so each __anext__ still runs ON the loop (single-thread
        # actor-state invariant)
        if inspect.isasyncgen(value):
            value = _sync_over_asyncgen(value, loop)
        state.async_done_pool.submit(_stream_results, state, spec, value)
        return
    # fire-and-forget onto the dedicated completion pool: must not be
    # cancellable, must not serialize on the loop thread, and must not queue
    # behind blocked arg fetches (see _setup_actor_concurrency)
    state.async_done_pool.submit(_finish_task, state, spec, value, is_error)


def _finish_task(state: WorkerState, spec: dict, value, is_error: bool) -> None:
    try:
        results = _store_results(state, spec, value, is_error)
    except BaseException:  # noqa: BLE001
        traceback.print_exc()
        results = []
    payload = {"task_id": spec["task_id"], "results": results, "results_error": is_error}
    wf = spec.get("wf")
    if wf is not None:
        payload["wf"] = wf  # waterfall stamps ride the reply (head folds)
    state.ctx.send_raw(("task_done", payload))


def _cli_main():
    """Entry point for ``python -m ray_tpu_torch._private.worker_main`` — workers
    are exec'd fresh (reference: worker_pool spawning default_worker.py), so
    they never re-import the driver's __main__ module."""
    import sys

    socket_path, authkey_hex, node_id_hex = sys.argv[1], sys.argv[2], sys.argv[3]
    token = sys.argv[4] if len(sys.argv) > 4 else ""
    remote = len(sys.argv) > 5 and sys.argv[5] == "--remote"
    main(
        socket_path,
        bytes.fromhex(authkey_hex),
        bytes.fromhex(node_id_hex),
        token=token,
        remote=remote,
    )


def _run_actor_create(state: WorkerState, spec: dict):
    from ray_tpu_torch._private import runtime_env as renv
    from ray_tpu_torch.accelerators import gpu

    try:
        cls = _resolve_function(state, spec["func_id"])
        args, kwargs = _load_args(state, spec)
        # permanent: the actor owns this worker process for life, so its
        # runtime env applies to every subsequent method call too
        with renv.applied(spec.get("runtime_env"), state.ctx, permanent=True):
            gpu.bind_from_env()  # an actor's card share, before it touches CUDA
            state.actor_instance = cls(*args, **kwargs)
        state.actor_id = spec["actor_id"]
        # detached actors outlive the head: on conn loss they retry the
        # head address and rebind instead of dying (reference: raylet
        # reconnect window; gcs_actor_manager re-registration on failover)
        state.detached = spec.get("lifetime") == "detached"
        state.ctx.current_actor = spec["actor_id"].hex()  # for get_runtime_context()
        # the actor lives in its namespace for good (worker is dedicated)
        state.ctx.namespace = spec.get("namespace") or "default"
        _setup_actor_concurrency(state, spec)
        state.ctx.send_raw(("actor_ready", {"actor_id": spec["actor_id"], "error": None}))
    except BaseException as e:  # noqa: BLE001
        err = rex.RayTaskError.from_exception(spec.get("name", "actor"), e)
        state.ctx.send_raw(("actor_ready", {"actor_id": spec["actor_id"], "error": err}))


if __name__ == "__main__":
    _cli_main()
