"""HTTP ingress proxy — asyncio + h11 (copy of
``ray_tpu/serve/_private/proxy.py``).

Reference: ``serve/_private/proxy.py:1115`` (ProxyActor per node wrapping an
HTTP server that resolves routes to app ingress deployments and awaits the
handle response; ``proxy.py:759`` runs uvicorn/ASGI). A ``ThreadingHTTPServer``
holds one OS thread per in-flight request and collapses under
concurrency; this proxy is a single asyncio event loop
(h11 for HTTP/1.1 parsing/framing — the same state machine family the
reference's uvicorn uses) with:

* a bounded dispatch executor for the blocking control-plane touches
  (first-route lookup, router admission/pick, result fetches, failover
  re-picks) — never occupied for a request's full lifetime;
* ONE resolver thread that watches ALL in-flight unary ObjectRefs via a
  single batched ``ray_tpu_torch.wait`` — hundreds of concurrent requests cost
  hundreds of parked coroutines, not hundreds of threads;
* router semantics preserved end-to-end: the handle slot is held until the
  response settles (admission caps + pow-2 balancing stay live) and replica
  death re-routes through ``DeploymentResponse._async_failed`` exactly like
  the blocking ``result()`` path;
* streaming responses on a dedicated thread per stream with a bounded
  in-flight chunk window and client-disconnect cancellation (the generator
  is closed, which disposes the remote stream).

Routes: ``POST/GET /<app_name>`` → the app's ingress deployment, invoked as
``__call__(payload)``. Bodies: JSON stays JSON, ``text/*`` arrives as str,
anything else as raw bytes; responses mirror (bytes → octet-stream, str →
text/plain, else JSON). Generator ingress deployments stream chunked
(one chunk per yielded item, via ``num_returns="streaming"``).
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import h11

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.serve._private.common import CONTROLLER_NAME
from ray_tpu_torch.util import phases as _phases
from ray_tpu_torch.util import tracing as _tracing

_READ_CHUNK = 1 << 16
_DISPATCH_THREADS = 32  # blocking picks/lookups/fetches — never held per-request
_STREAM_WINDOW = 64  # max un-consumed chunks in flight per stream
_UNARY_TIMEOUT_S = 60.0

_request_counter = None
_request_counter_lock = threading.Lock()


def _count_request(status: int) -> None:
    """Bump the ``serve_requests`` counter by status class. Feeds the
    request-errors SLO (``util.slo.default_rules``) and the request-rate
    line in ``obs top`` — the flight-recorder events alone can't, their
    ring wraps."""
    global _request_counter
    if _request_counter is None:
        with _request_counter_lock:
            if _request_counter is None:
                from ray_tpu_torch.util.metrics import Counter

                _request_counter = Counter(
                    "serve_requests",
                    "proxied HTTP requests by status class",
                    tag_keys=("status",),
                )
    _request_counter.inc(tags={"status": f"{int(status) // 100}xx"})


class _Resolution:
    """One in-flight unary request: its asyncio future plus the CURRENT
    response being awaited (failover swaps in a re-routed response)."""

    __slots__ = ("loop", "future", "resp")

    def __init__(self, loop, resp):
        self.loop = loop
        self.future = loop.create_future()
        self.resp = resp


class _RefResolver:
    """Settles every in-flight unary request with one watcher thread.

    The thread batches all outstanding refs into a single ``ray_tpu_torch.wait``;
    ready refs are handed to the dispatch pool to fetch + settle (a big
    payload fetch must not head-of-line-block other settlements), post the
    result to the owning event loop, and — on replica death — re-route via
    ``DeploymentResponse._async_failed`` and re-register the fresh ref.
    """

    def __init__(self):
        # OWN pool, never shared with dispatch: dispatch threads block in
        # pick() waiting for router slots that only _finish (settle) frees —
        # sharing one pool deadlocks the proxy at max_ongoing saturation
        self._pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="proxy-finish"
        )
        self._lock = threading.Lock()
        self._pending: dict = {}  # ObjectRef -> _Resolution
        self._wake = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="proxy-resolver", daemon=True
        )
        self._thread.start()

    def register(self, resp, loop) -> _Resolution:
        res = _Resolution(loop, resp)
        with self._lock:
            self._pending[resp._async_ref()] = res
        self._wake.set()
        return res

    def _rearm(self, res: _Resolution, resp) -> None:
        res.resp = resp
        with self._lock:
            self._pending[resp._async_ref()] = res
        self._wake.set()

    def discard(self, res: _Resolution) -> None:
        """Caller timed out / disconnected: stop tracking (and free the
        router slot so abandoned requests don't eat the admission cap)."""
        with self._lock:
            ref = res.resp._async_ref()
            if self._pending.get(ref) is res:
                self._pending.pop(ref, None)
        try:
            res.resp._async_done()
        except Exception:
            pass

    def close(self):
        self._closed = True
        self._wake.set()
        self._pool.shutdown(wait=False)

    def _run(self):
        import ray_tpu_torch

        while not self._closed:
            with self._lock:
                refs = list(self._pending.keys())
            if not refs:
                self._wake.wait(timeout=1.0)
                self._wake.clear()
                continue
            try:
                ready, _ = ray_tpu_torch.wait(
                    refs, num_returns=len(refs), timeout=0.05, fetch_local=False
                )
            except Exception:
                ready = []
            for ref in ready:
                with self._lock:
                    res = self._pending.pop(ref, None)
                if res is not None:
                    self._pool.submit(self._finish, ref, res)

    def _finish(self, ref, res: _Resolution):
        """Dispatch-pool side: fetch the value, settle the router slot, post
        to the event loop; on failure mirror result()'s failover."""
        import ray_tpu_torch

        try:
            value = ray_tpu_torch.get(ref)  # ready: no artificial timeout
            res.resp._async_done()
            err = None
        except BaseException as e:  # noqa: BLE001
            try:
                nxt = res.resp._async_failed(e)  # may block in pick(): pool thread
            except BaseException as pick_err:  # noqa: BLE001
                nxt = None
                e = pick_err
            if nxt is not None:
                self._rearm(res, nxt)
                return
            value, err = None, e
        def _post():
            if res.future.cancelled():
                return
            if err is not None:
                res.future.set_exception(err)
            else:
                res.future.set_result(value)
        try:
            res.loop.call_soon_threadsafe(_post)
        except RuntimeError:
            pass  # loop already closed (proxy stopping)


def _error_status(exc) -> tuple[int, list[tuple[str, str]]]:
    """HTTP status + extra headers for a request-path failure. 429 carries
    ``Retry-After`` (seconds, ceil'd — the header is integer-valued) from
    the shedding layer's estimate of when capacity frees up."""
    from ray_tpu_torch.exceptions import OverloadedError

    import math

    cause = getattr(exc, "cause", None)
    if isinstance(exc, OverloadedError) or isinstance(cause, OverloadedError):
        # the shedding layer's estimate rides retry_after_s — on the raw
        # error directly, or on .cause when the error crossed an actor
        # boundary (RayTaskError's as_instanceof_cause carries the original
        # in .cause but not its attributes)
        retry_s = getattr(exc, "retry_after_s", None)
        if retry_s is None:
            retry_s = getattr(cause, "retry_after_s", 1.0)
        retry_after = max(1, math.ceil(retry_s))
        return 429, [("retry-after", str(retry_after))]
    if isinstance(exc, KeyError):
        return 404, []
    return 500, []


def _parse_payload(body: bytes, ctype: str):
    """JSON stays JSON; anything else arrives as raw bytes (reference: the
    ASGI proxy hands the body through; JSON is a convenience)."""
    if not body:
        return None
    ctype = (ctype or "").split(";")[0].strip()
    if ctype in ("", "application/json"):
        return json.loads(body)
    if ctype.startswith("text/"):
        return body.decode()
    return body


def _encode_body(body) -> tuple[bytes, str]:
    if isinstance(body, (bytes, bytearray, memoryview)):
        return bytes(body), "application/octet-stream"
    if isinstance(body, str):
        return body.encode(), "text/plain; charset=utf-8"
    return json.dumps(body).encode(), "application/json"


class _StreamCancelled(BaseException):
    pass


#: raylint RL017 — _handles is a per-app handle cache: dict get/store are
#: GIL-atomic, and two request threads racing the first touch at worst
#: both build a handle (idempotent — last store wins, both work)
LOCKFREE = ("ProxyActor._handles: atomic",)


class ProxyActor:
    def __init__(self, port: int):
        self.port = port
        self._handles: dict[str, object] = {}
        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=_DISPATCH_THREADS, thread_name_prefix="proxy-dispatch"
        )
        self._resolver = _RefResolver()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server = None
        started = threading.Event()
        boot_err: list = []

        def run_loop():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop

            async def boot():
                try:
                    self._server = await asyncio.start_server(
                        self._handle_conn, "127.0.0.1", port, backlog=1024
                    )
                    self.port = self._server.sockets[0].getsockname()[1]
                except BaseException as e:  # noqa: BLE001
                    boot_err.append(e)
                finally:
                    started.set()

            loop.run_until_complete(boot())
            if not boot_err:
                loop.run_forever()
            # drain callbacks after stop() so close() completes cleanly
            loop.run_until_complete(asyncio.sleep(0))
            loop.close()

        self._thread = threading.Thread(target=run_loop, name="proxy-loop", daemon=True)
        self._thread.start()
        started.wait(timeout=30)
        if boot_err:
            raise boot_err[0]

    # ------------------------------------------------------------- routing

    def _handle_for(self, app: str):
        """Blocking (controller RPC) on first touch — always called from a
        worker thread, never the event loop."""
        import ray_tpu_torch
        from ray_tpu_torch.serve.handle import DeploymentHandle

        ent = self._handles.get(app)
        if ent is None:
            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            info = ray_tpu_torch.get(controller.get_ingress_info.remote(app), timeout=30)
            if info is None:
                raise KeyError(f"no app {app!r}")
            ent = (DeploymentHandle(info["deployment"]), bool(info["streaming"]))
            self._handles[app] = ent
        return ent

    #: longest the capacity probe will wait for a slot before declaring
    #: overload, however generous the deadline — a capacity drought this
    #: long with every replica at its admission cap IS overload, and
    #: backpressuring the patient client (429 + Retry-After, they retry)
    #: beats silently parking unbounded queue depth in the router
    _SHED_PROBE_MAX_S = 2.0

    def _shed_if_doomed(self, handle, app: str, deadline_s, request_id: str):
        """Proxy-side deadline-aware admission (RESILIENCE.md): a request
        that declares a deadline (``x-deadline-s`` header) and cannot get
        an admission slot within a probe window scaled to that deadline
        (half of it, capped at ``_SHED_PROBE_MAX_S``) is rejected with
        429/Retry-After instead of parking in pick() behind work that
        outlives it. A momentary full house at steady load clears within
        the probe and admits normally — only a sustained drought sheds.
        Requests without a deadline queue as before; an unknown replica
        set (cold router) never sheds."""
        if deadline_s is None:
            return
        budget = min(max(deadline_s, 0.0) * 0.5, self._SHED_PROBE_MAX_S)
        deadline = time.monotonic() + budget
        while True:
            free = handle.free_capacity()
            if free is None or free > 0:
                return
            if time.monotonic() >= deadline:
                break
            time.sleep(0.02)
        from ray_tpu_torch.exceptions import OverloadedError

        _events.record(
            "proxy.shed", request_id=request_id, app=app,
            deadline_s=deadline_s, probe_s=round(budget, 3),
        )
        raise OverloadedError(
            f"all {app!r} replicas held their admission caps for "
            f"{budget:.2f}s and the request carries a {deadline_s}s "
            "deadline",
            retry_after_s=1.0,
        )

    def _route(self, app: str, payload, request_id: str, deadline_s=None):
        """Dispatch pool (ONE hop per request): route lookup + admission/
        pick may block. Returns ("stream", None) for streaming apps, else
        ("unary", un-settled DeploymentResponse) — the slot stays held until
        resolution so admission caps and pow-2 balancing see async requests
        exactly like blocking callers. The request's trace context is
        installed on this dispatch thread so the replica submission (an
        actor-method hop) carries the request_id downstream."""
        with _tracing.trace_context(request_id):
            handle, streaming = self._handle_for(app)
            if streaming:
                return "stream", None
            self._shed_if_doomed(handle, app, deadline_s, request_id)
            with _tracing.span("proxy_route", app=app):
                return "unary", handle.remote(payload)

    def _run_stream(self, app: str, payload, loop, q: "asyncio.Queue",
                    cancel: threading.Event, window: threading.Semaphore,
                    request_id: str = "", deadline_s=None, stamps=None):
        """Dedicated thread per stream (long-lived by nature — must not
        occupy the dispatch pool): iterates the streaming generator with a
        bounded chunk window and stops (disposing the remote stream) when
        the client disconnects. Sentinels: ("end", None) | ("error", exc)."""

        def post(item):
            loop.call_soon_threadsafe(q.put_nowait, item)

        gen = None
        try:
            # trace context on the stream thread: the streaming replica hop
            # inherits the proxy-minted request_id (mint_context makes the
            # head-sampling decision once; an unsampled stream ships no
            # context downstream and records no spans)
            ctx = _tracing.mint_context(request_id) if request_id else None
            _tracing.set_trace_context(ctx)
            handle, _ = self._handle_for(app)
            self._shed_if_doomed(handle, app, deadline_s, request_id)
            if stamps is not None:
                # phase-ledger dispatch anchor: kept proxy-side for the
                # fold AND ridden downstream on the sampled trace-ctx dict
                # so the engine can observe the cross-process dispatch leg
                # (phases.note_dispatch)
                t_disp = time.time()
                stamps["t_dispatch"] = t_disp
                if type(ctx) is dict:
                    ctx["t_dispatch"] = t_disp
            gen = handle.options(stream=True).remote(payload)
            for item in gen:
                if isinstance(item, (bytes, bytearray, memoryview)):
                    data = bytes(item)
                else:
                    data = (json.dumps(item) + "\n").encode()
                while not window.acquire(timeout=0.25):
                    if cancel.is_set():
                        raise _StreamCancelled
                if cancel.is_set():
                    raise _StreamCancelled
                post(("chunk", data))
            if stamps is not None:
                # done-sentinel receipt ≈ engine finish + one hop; the
                # `stream` phase (delivery tail) starts here
                stamps["t_finish"] = time.time()
            post(("end", None))
        except _StreamCancelled:
            pass
        except BaseException as e:  # noqa: BLE001
            post(("error", e))
        finally:
            if gen is not None and cancel.is_set():
                try:
                    gen.close()  # disposes the remote stream + producer
                except Exception:
                    pass

    # ------------------------------------------------------- http plumbing

    async def _read_request(self, conn: h11.Connection, reader, writer):
        """Collect one (Request, body) off the connection; None on close.
        Answers ``Expect: 100-continue`` with the interim response so
        clients that wait for it (curl on >1KB bodies) don't stall."""
        request = None
        body = b""
        while True:
            event = conn.next_event()
            if event is h11.NEED_DATA:
                data = await reader.read(_READ_CHUNK)
                conn.receive_data(data)
                if data == b"" and request is None:
                    return None  # clean close between requests
                continue
            if isinstance(event, h11.Request):
                request = event
                expect = next(
                    (v for k, v in request.headers if k == b"expect"), b""
                )
                if expect.lower() == b"100-continue":
                    await self._send(
                        writer, conn, h11.InformationalResponse(status_code=100)
                    )
            elif isinstance(event, h11.Data):
                body += event.data
            elif isinstance(event, h11.EndOfMessage):
                return request, body
            elif isinstance(event, (h11.ConnectionClosed,)):
                return None

    async def _send(self, writer, conn, event):
        data = conn.send(event)
        if data:
            writer.write(data)
            await writer.drain()

    async def _respond(self, writer, conn, code: int, body, ctype=None,
                       request_id: str = "", extra_headers=()):
        data, default_ctype = _encode_body(body)
        headers = [
            ("content-type", ctype or default_ctype),
            ("content-length", str(len(data))),
            *extra_headers,
        ]
        if request_id:
            # clients correlate their response with `obs req <id>` by this
            headers.append(("x-request-id", request_id))
        await self._send(writer, conn, h11.Response(status_code=code, headers=headers))
        await self._send(writer, conn, h11.Data(data=data))
        await self._send(writer, conn, h11.EndOfMessage())

    async def _respond_stream(self, writer, conn, app: str, payload, loop,
                              request_id: str = "", deadline_s=None,
                              t_recv=None):
        """Chunked transfer: h11 frames chunks automatically when no
        content-length is declared. Errors after the header cannot become a
        second response — truncate the stream (close) like the reference."""
        q: asyncio.Queue = asyncio.Queue()
        cancel = threading.Event()
        window = threading.Semaphore(_STREAM_WINDOW)
        # phase-ledger anchors for this request (util.phases): the stream
        # thread writes dispatch/finish, this coroutine first-chunk, and
        # the successful-completion branch folds them
        stamps = {} if _phases.enabled() else None
        if t_recv is None:
            t_recv = time.time()
        threading.Thread(
            target=self._run_stream,
            args=(app, payload, loop, q, cancel, window, request_id,
                  deadline_s, stamps),
            name="proxy-stream",
            daemon=True,
        ).start()
        try:
            first_kind, first_val = await q.get()
            window.release()
            if first_kind == "error":
                code, extra = _error_status(first_val)
                _count_request(code)
                _events.record(
                    "proxy.response", request_id=request_id, status=code,
                    error=repr(first_val), streaming=True,
                )
                await self._respond(
                    writer, conn, code, {"error": repr(first_val)},
                    request_id=request_id, extra_headers=extra,
                )
                return False
            headers = [
                ("content-type", "application/octet-stream"),
                ("transfer-encoding", "chunked"),
            ]
            if request_id:
                headers.append(("x-request-id", request_id))
            await self._send(
                writer, conn, h11.Response(status_code=200, headers=headers)
            )
            kind, val = first_kind, first_val
            while True:
                if kind == "chunk":
                    if stamps is not None and "t_first" not in stamps:
                        stamps["t_first"] = time.time()
                    await self._send(writer, conn, h11.Data(data=val))
                elif kind == "end":
                    await self._send(writer, conn, h11.EndOfMessage())
                    _count_request(200)
                    if stamps is not None:
                        _phases.fold_proxy(
                            request_id, t_recv,
                            stamps.get("t_dispatch"),
                            stamps.get("t_first"),
                            stamps.get("t_finish"),
                            time.time(),
                        )
                    return True
                else:  # mid-stream error: truncate
                    import traceback

                    _count_request(500)
                    _events.record(
                        "proxy.stream_error", request_id=request_id,
                        error=repr(val),
                    )
                    print("[serve-proxy] streaming response failed:", flush=True)
                    traceback.print_exception(val)
                    writer.close()
                    return False
                kind, val = await q.get()
                window.release()
        finally:
            cancel.set()  # stops (and disposes) the producer on disconnect

    async def _handle_conn(self, reader, writer):
        loop = asyncio.get_running_loop()
        conn = h11.Connection(h11.SERVER)
        try:
            while True:
                try:
                    req = await self._read_request(conn, reader, writer)
                except h11.RemoteProtocolError:
                    await self._send(
                        writer, conn,
                        h11.Response(status_code=400, headers=[("content-length", "0")]),
                    )
                    await self._send(writer, conn, h11.EndOfMessage())
                    return
                if req is None:
                    return
                request, body = req
                target = request.target.decode()
                headers = {k.decode().lower(): v.decode() for k, v in request.headers}
                app = target.strip("/").split("/")[0] or "default"
                # trace root: honor a caller-supplied x-request-id (gateway
                # chains) or mint one; it rides the task specs downstream
                # and echoes back in the response header
                rid = headers.get("x-request-id") or _tracing.new_request_id()
                # deadline-aware shedding opt-in: a client that can't use a
                # late response declares how long it will wait. Hostile
                # values (nan/inf/negative — float() accepts them all) are
                # ignored rather than fed into probe-loop arithmetic.
                import math

                try:
                    deadline_s = float(headers["x-deadline-s"])
                    if not math.isfinite(deadline_s) or deadline_s <= 0:
                        deadline_s = None
                except (KeyError, ValueError):
                    deadline_s = None
                t_req = time.time()
                _events.record(
                    "proxy.request", request_id=rid, app=app,
                    method=request.method.decode(), bytes_in=len(body),
                )
                try:
                    payload = _parse_payload(body, headers.get("content-type", ""))
                    kind, resp = await loop.run_in_executor(
                        self._dispatch_pool, self._route, app, payload, rid,
                        deadline_s,
                    )
                    if kind == "stream":
                        ok = await self._respond_stream(
                            writer, conn, app, payload, loop, request_id=rid,
                            deadline_s=deadline_s, t_recv=t_req,
                        )
                        if ok:
                            # failures already recorded proxy.response /
                            # proxy.stream_error inside _respond_stream
                            _events.record(
                                "proxy.stream_done", request_id=rid,
                                dur_s=round(time.time() - t_req, 6),
                            )
                    else:
                        res = self._resolver.register(resp, loop)
                        try:
                            result = await asyncio.wait_for(
                                res.future, timeout=_UNARY_TIMEOUT_S
                            )
                        except (asyncio.TimeoutError, asyncio.CancelledError):
                            self._resolver.discard(res)  # free slot + tracking
                            raise
                        _count_request(200)
                        _events.record(
                            "proxy.response", request_id=rid, status=200,
                            dur_s=round(time.time() - t_req, 6),
                        )
                        await self._respond(writer, conn, 200, result, request_id=rid)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001
                    code, extra = _error_status(e)
                    _count_request(code)
                    _events.record(
                        "proxy.response", request_id=rid, status=code,
                        error=repr(e) if code != 404 else str(e),
                    )
                    try:
                        await self._respond(
                            writer, conn, code,
                            {"error": str(e) if code == 404 else repr(e)},
                            request_id=rid, extra_headers=extra,
                        )
                    except h11.LocalProtocolError:
                        return  # headers already sent (stream): just close
                # keep-alive
                if conn.our_state is h11.MUST_CLOSE or conn.their_state is h11.MUST_CLOSE:
                    return
                try:
                    conn.start_next_cycle()
                except h11.LocalProtocolError:
                    return
        except (ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    # ------------------------------------------------------------ lifecycle

    def ready(self) -> int:
        return self.port

    def get_port(self) -> int:
        return self.port

    def stop(self) -> bool:
        self._resolver.close()
        loop = self._loop
        if loop is not None and loop.is_running():
            def _shut():
                if self._server is not None:
                    self._server.close()
                loop.stop()
            loop.call_soon_threadsafe(_shut)
        self._dispatch_pool.shutdown(wait=False)
        return True

    def check_health(self) -> bool:
        return True
