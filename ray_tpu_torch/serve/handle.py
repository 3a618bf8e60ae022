"""DeploymentHandle: the client-side request path (copy of
``ray_tpu/serve/handle.py``).

Reference: ``serve/handle.py:830`` (DeploymentHandle / DeploymentResponse),
``_private/router.py:36,326`` (Router.assign_request) and
``_private/replica_scheduler/pow_2_scheduler.py:44`` (power-of-two-choices:
sample two replicas, pick the one with the shorter queue). The router keeps
a local in-flight count per replica (updated at submit/complete) and
refreshes its replica set from the controller when the controller's version
counter moves — the long-poll-lite equivalent of the reference's
LongPollHost.

Handles pickle cleanly (they carry only the deployment name): deployment
composition passes handles through replica init args, and any process that
can reach the named controller actor can route.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Optional

from ray_tpu_torch.serve._private.common import CONTROLLER_NAME


class DeploymentResponse:
    """Future-like wrapper over the underlying ObjectRef.

    If the backing replica died before producing a result, ``result()``
    re-routes the request once through a fresh replica (the reference
    router's retry-on-replica-failure semantics).
    """

    def __init__(self, ref, router: "_Router", replica_idx: int, retry=None, replica=None):
        self._ref = ref
        self._router = router
        self._replica_idx = replica_idx
        self._replica = replica
        self._retry = retry  # zero-arg callable re-submitting the request
        self._done = False

    @staticmethod
    def max_retries() -> int:  # tunable: serve_handle_max_retries
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        return GLOBAL_CONFIG.serve_handle_max_retries

    def result(self, timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import RayActorError

        try:
            return ray_tpu_torch.get(self._ref, timeout=timeout)
        except RayActorError:
            self._settle()
            if self._replica is not None:
                # fail over immediately: this router stops routing to the
                # dead replica without waiting for the controller's health
                # check to notice
                self._router.mark_failed(self._replica)
            else:
                self._router.drop()
            if self._retry is None:
                raise  # retry budget exhausted — surface the failure
            # no sleep: pick() itself waits (with deadline) when no live
            # replica is available; with others alive the retry is instant
            return self._retry().result(timeout)
        finally:
            self._settle()

    def _to_object_ref(self):
        """Pass-through so responses can feed other task/actor calls."""
        self._settle()
        return self._ref

    # -- async completion protocol (used by the HTTP proxy resolver) -------
    # The slot stays held until _async_done/_async_failed so admission
    # accounting and pow-2 balancing see async requests exactly like
    # blocking result() callers.

    def _async_ref(self):
        """The ref to await WITHOUT settling the router slot."""
        return self._ref

    def _async_done(self) -> None:
        self._settle()

    def _async_failed(self, exc) -> "Optional[DeploymentResponse]":
        """Mirror ``result()``'s failover: on replica death, mark it failed
        and return a freshly-routed response to keep awaiting (may block in
        pick() — call from a worker thread, not an event loop). Returns None
        when ``exc`` should surface to the caller."""
        from ray_tpu_torch.exceptions import RayActorError

        self._settle()
        if not isinstance(exc, RayActorError):
            return None
        if self._replica is not None:
            self._router.mark_failed(self._replica)
        else:
            self._router.drop()
        if self._retry is None:
            return None
        return self._retry()

    def _settle(self):
        if not self._done:
            self._done = True
            self._router._complete(self._replica_idx)


class _Router:
    """Per-handle replica set + pow-2 picker."""

    def __init__(self, deployment_name: str):
        self.deployment_name = deployment_name
        self._lock = threading.Lock()
        self._replicas: list = []
        self._inflight: list[int] = []
        self._max_ongoing = 1
        self._version = -1
        self._poll_thread: Optional[threading.Thread] = None
        self._closed = False
        # replicas observed dead by THIS router, excluded until the
        # controller publishes a new replica set — immediate failover
        # instead of waiting out the controller's health-check window
        self._excluded: set = set()
        self._excluded_version = -1
        self._real_version = -1  # last version actually seen from the
        # controller — unlike _version it is never reset by drop(), so
        # exclusion bookkeeping survives cache invalidation
        # mid-stream failover contract, fetched from the controller once
        # per router (False = not yet fetched; None = deployment has none)
        self._resume_arg: "object" = False

    def _controller(self):
        import ray_tpu_torch

        return ray_tpu_torch.get_actor(CONTROLLER_NAME)

    def _apply(self, version, replicas, max_ongoing) -> None:
        with self._lock:
            self._max_ongoing = max_ongoing
            if version != self._version:
                self._version = version
                self._replicas = replicas
                self._inflight = [0] * len(replicas)
            self._real_version = version
            if self._excluded and version != self._excluded_version:
                # the controller published a NEW replica set since the
                # exclusions were recorded — they no longer apply
                self._excluded.clear()

    def _refresh(self, force: bool = False):
        """One synchronous pull — used at router birth and after drop()
        (observed replica death). Steady-state updates arrive PUSHED via
        the long-poll thread; nothing here runs per request."""
        import ray_tpu_torch

        with self._lock:
            if not force and self._replicas:
                return
        version, replicas, max_ongoing = ray_tpu_torch.get(
            self._controller().get_replicas.remote(self.deployment_name), timeout=30
        )
        self._apply(version, replicas, max_ongoing)
        with self._lock:
            start = self._poll_thread is None
            if start:  # under the lock: concurrent first requests must not
                # each park a long-poll on the controller's thread budget
                self._poll_thread = threading.Thread(
                    target=self._poll_loop, name="serve-router-longpoll", daemon=True
                )
        if start:
            self._poll_thread.start()

    def _poll_loop(self):
        """Long-poll push (reference: _private/long_poll.py client): one
        outstanding poll_replicas call parks on the controller until the
        config version moves — router updates arrive without any periodic
        version polling."""
        import ray_tpu_torch

        while not self._closed:
            try:
                version, replicas, max_ongoing = ray_tpu_torch.get(
                    self._controller().poll_replicas.remote(
                        self.deployment_name, self._real_version, 25.0
                    ),
                    timeout=40,
                )
                self._apply(version, replicas, max_ongoing)
            except Exception:
                if self._closed:
                    return
                time.sleep(0.5)  # controller briefly unreachable: back off

    def _sticky_pick(self, model_id: str, live: list) -> int:
        """Highest-random-weight over STABLE replica identities: a model's
        home replica doesn't move when unrelated replicas join/die/exclude
        (positional hashing would remap models on every live-set change)."""
        import hashlib

        def weight(i):
            key = str(self._replica_key(self._replicas[i]))
            return int.from_bytes(
                hashlib.sha1(f"{model_id}:{key}".encode()).digest()[:8], "little"
            )

        return max(live, key=weight)

    def pick(self, model_id: Optional[str] = None) -> tuple[Any, int]:
        """Power-of-two-choices over local in-flight counts, honoring the
        per-replica max_ongoing_requests admission cap (backpressure —
        reference: pow_2_scheduler queue-length caps). Multiplexed requests
        route by rendezvous hash so a model id sticks to one replica
        (reference: model-aware multiplex routing)."""
        deadline = time.time() + 30.0
        while True:
            self._refresh()
            with self._lock:
                live = [
                    i
                    for i in range(len(self._replicas))
                    if self._replica_key(self._replicas[i]) not in self._excluded
                ]
                n = len(live)
                if n:
                    if model_id:
                        # sticky: wait for THE model's replica rather than
                        # spilling onto others (a spill would duplicate the
                        # model's weights in another replica's HBM)
                        idx = self._sticky_pick(model_id, live)
                        if self._inflight[idx] < self._max_ongoing:
                            self._inflight[idx] += 1
                            return self._replicas[idx], idx
                        idx = None
                    elif n == 1:
                        idx = live[0]
                    else:
                        i, j = random.sample(live, 2)
                        idx = i if self._inflight[i] <= self._inflight[j] else j
                    if idx is not None and self._inflight[idx] < self._max_ongoing:
                        self._inflight[idx] += 1
                        return self._replicas[idx], idx
                    if idx is not None:
                        # chosen replica at capacity: try the live minimum
                        idx = min(live, key=self._inflight.__getitem__)
                        if self._inflight[idx] < self._max_ongoing:
                            self._inflight[idx] += 1
                            return self._replicas[idx], idx
            if time.time() > deadline:
                raise RuntimeError(
                    f"No replica capacity for deployment {self.deployment_name!r}"
                )
            time.sleep(0.02)

    @staticmethod
    def _replica_key(handle):
        return getattr(handle, "_actor_id", None) or id(handle)

    def stream_contract(self):
        """The deployment's mid-stream-failover contract —
        ``(resume_arg, deadline_arg)`` or None (RESILIENCE.md) — cached
        after one controller RPC."""
        if self._resume_arg is False:
            import ray_tpu_torch

            try:
                got = ray_tpu_torch.get(
                    self._controller().get_stream_resume_arg.remote(
                        self.deployment_name
                    ),
                    timeout=30,
                )
                self._resume_arg = tuple(got) if got is not None else None
            except Exception:
                return None  # controller briefly unreachable: retry next call
        return self._resume_arg

    def free_capacity(self) -> Optional[int]:
        """Admission slots open across live replicas right now — the
        proxy's deadline-aware shed probe. None when the replica set is
        unknown (never shed on no evidence)."""
        with self._lock:
            if not self._replicas:
                return None
            live = [
                i
                for i in range(len(self._replicas))
                if self._replica_key(self._replicas[i]) not in self._excluded
            ]
            if not live:
                return None
            return sum(
                max(0, self._max_ongoing - self._inflight[i]) for i in live
            )

    def mark_failed(self, replica):
        """Exclude a replica this router saw die — routing fails over NOW,
        before the controller's health check notices."""
        with self._lock:
            self._excluded.add(self._replica_key(replica))
            self._excluded_version = self._real_version
        self.drop()

    def _complete(self, idx: int):
        with self._lock:
            if 0 <= idx < len(self._inflight) and self._inflight[idx] > 0:
                self._inflight[idx] -= 1

    def drop(self):
        """Force-refresh after a replica failure."""
        with self._lock:
            self._version = -1
            self._replicas = []


class StreamingDeploymentResponse:
    """Iterates a streaming deployment call's items as they are produced
    (reference: serve's streaming DeploymentResponse over ASGI). Wraps the
    ObjectRefGenerator from ``num_returns="streaming"``; the router's
    in-flight slot is held until the stream is exhausted or closed.

    Mid-stream failover (RESILIENCE.md): when the deployment declares a
    ``stream_resume_arg``, ``resume`` is a callable re-submitting the
    request to a fresh replica with the items delivered so far — on
    replica death the iterator journals what it already yielded, fails
    over, and CONTINUES yielding from the successor stream in place, so
    the consumer sees one uninterrupted, token-exact stream. Without a
    resume contract, replica death raises (the pre-existing behavior)."""

    def __init__(self, gen, router: "_Router", replica_idx: int, replica=None,
                 resume=None):
        self._gen = gen
        self._router = router
        self._replica_idx = replica_idx
        self._replica = replica
        self._resume = resume  # callable(items so far) -> successor response
        self._done = False

    def __iter__(self):
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import RayActorError

        cur = self
        # items yielded since the CURRENT attempt began; the journal of
        # earlier attempts lives in the resume closure's kwargs (each
        # failover bakes its prefix into the next call's resume kwarg, so
        # re-journaling it here would double-count)
        emitted: list = []
        try:
            while True:
                try:
                    for ref in cur._gen:
                        item = ray_tpu_torch.get(ref, timeout=60)
                        emitted.append(item)
                        yield item
                    return
                except RayActorError:
                    # replica died mid-stream: tell the router NOW so new
                    # requests fail over immediately (mirrors
                    # DeploymentResponse.result)
                    if cur._replica is not None:
                        cur._router.mark_failed(cur._replica)
                    else:
                        cur._router.drop()
                    if cur._resume is None:
                        raise  # no resume contract / budget exhausted
                    nxt = cur._resume(list(emitted))
                    cur.close()
                    cur = nxt
                    emitted = []
        finally:
            cur.close()

    def close(self) -> None:
        if not self._done:
            self._done = True
            self._router._complete(self._replica_idx)
            try:
                self._gen.close()
            except Exception:
                pass


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle._remote(self._method, args, kwargs)


class DeploymentHandle:
    def __init__(
        self,
        deployment_name: str,
        _model_id: Optional[str] = None,
        _stream: bool = False,
        _resume: bool = True,
    ):
        self.deployment_name = deployment_name
        self._router: Optional[_Router] = None
        self._model_id = _model_id
        self._stream = _stream
        self._resume = _resume

    def options(
        self,
        *,
        multiplexed_model_id: Optional[str] = None,
        stream: Optional[bool] = None,
        resume: Optional[bool] = None,
    ) -> "DeploymentHandle":
        """A view of this handle with request options (reference:
        ``handle.options(multiplexed_model_id=..., stream=...)``). The view
        SHARES the router (in-flight accounting stays coherent).
        ``stream=True`` makes ``.remote()`` return a
        StreamingDeploymentResponse yielding items as the replica's
        generator produces them. ``resume=False`` opts a streaming call out
        of mid-stream failover even when the deployment declares a
        ``stream_resume_arg`` (replica death then raises, the pre-resume
        behavior)."""
        view = DeploymentHandle(
            self.deployment_name,
            _model_id=multiplexed_model_id if multiplexed_model_id is not None else self._model_id,
            _stream=self._stream if stream is None else stream,
            _resume=self._resume if resume is None else resume,
        )
        view._router = self._get_router()
        return view

    # picklability: the router (with live actor handles) stays local
    def __getstate__(self):
        return {
            "deployment_name": self.deployment_name,
            "_model_id": self._model_id,
            "_stream": self._stream,
            "_resume": self._resume,
        }

    def __setstate__(self, state):
        self.deployment_name = state["deployment_name"]
        self._model_id = state.get("_model_id")
        self._stream = state.get("_stream", False)
        self._resume = state.get("_resume", True)
        self._router = None

    def _get_router(self) -> _Router:
        if self._router is None:
            self._router = _Router(self.deployment_name)
        return self._router

    def free_capacity(self) -> Optional[int]:
        """Open admission slots across live replicas (None = replica set
        unknown) — the proxy's deadline-aware shed probe."""
        return self._get_router().free_capacity()

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._remote("__call__", args, kwargs)

    def __getattr__(self, name: str) -> _MethodCaller:
        if name.startswith("_") or name in ("deployment_name", "options"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def _remote(
        self, method: str, args: tuple, kwargs: dict, _retries: Optional[int] = None
    ) -> DeploymentResponse:
        from ray_tpu_torch.exceptions import RayActorError

        if _retries is None:
            _retries = DeploymentResponse.max_retries()
        router = self._get_router()
        # unwrap nested responses so composition chains pass values not refs
        args = tuple(a.result() if isinstance(a, DeploymentResponse) else a for a in args)
        kwargs = {
            k: (v.result() if isinstance(v, DeploymentResponse) else v)
            for k, v in kwargs.items()
        }
        # bounded budget: a request that kills every replica it touches must
        # eventually surface its RayActorError, not loop forever
        retry = (
            (lambda: self._remote(method, args, kwargs, _retries - 1))
            if _retries > 0
            else None
        )
        # mid-stream failover: when the deployment declares a resume kwarg,
        # the streaming response journals delivered items and re-submits to
        # a fresh replica on death — the next attempt's resume kwarg carries
        # this attempt's kwarg prefix plus everything newly delivered, so
        # repeated failovers chain without re-sending or double-counting
        resume = None
        if self._stream and self._resume and _retries > 0:
            contract = router.stream_contract()
            if contract is not None:
                resume_arg, deadline_arg = contract
                prior = list(kwargs.get(resume_arg) or ())
                t_attempt = time.monotonic()

                def resume(emitted, _r=_retries):
                    kw = dict(kwargs)
                    kw[resume_arg] = prior + list(emitted)
                    # the client's deadline budget spans the WHOLE request:
                    # hand the successor only what remains of this
                    # attempt's relative deadline (chained failovers each
                    # decrement their own attempt's spend, so the budget
                    # composes instead of resetting per replica death)
                    if deadline_arg is not None:
                        d = kw.get(deadline_arg)
                        if isinstance(d, (int, float)) and d > 0:
                            spent = time.monotonic() - t_attempt
                            kw[deadline_arg] = max(0.05, d - spent)
                    return self._remote(method, args, kw, _r - 1)

        for attempt in range(3):
            replica, idx = router.pick(model_id=self._model_id)
            try:
                if self._stream:
                    gen = replica.handle_request_streaming.options(
                        num_returns="streaming"
                    ).remote(method, args, kwargs, self._model_id)
                    return StreamingDeploymentResponse(
                        gen, router, idx, replica=replica, resume=resume
                    )
                if self._model_id:
                    ref = replica.handle_request.remote(
                        method, args, kwargs, self._model_id
                    )
                else:
                    ref = replica.handle_request.remote(method, args, kwargs)
                return DeploymentResponse(ref, router, idx, retry=retry, replica=replica)
            except RayActorError:
                router._complete(idx)
                router.mark_failed(replica)
        raise RuntimeError(f"Could not submit to deployment {self.deployment_name!r}")
