"""Actors: stateful workers with ordered method calls.

Counterpart of the reference's ``python/ray/actor.py`` (``ActorClass._remote``
:830, ``ActorHandle``, ``ActorMethod``). An actor is a dedicated worker
process holding a class instance; method calls are pushed in submission order
over the head→worker FIFO socket (= the reference's sequential actor submit
queue), with ``max_concurrency`` switching to a thread pool. Restart-on-death
follows ``max_restarts`` / ``max_task_retries``
(reference: gcs_actor_manager.cc state machine).
"""

from __future__ import annotations

import functools
from typing import Any, Optional

from ray_tpu_torch._private import options as opt
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.runtime import get_ctx


class ActorMethod:
    def __init__(
        self,
        handle: "ActorHandle",
        name: str,
        num_returns: int = 1,
        concurrency_group: Optional[str] = None,
    ):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    _SUPPORTED_OPTIONS = frozenset({"num_returns", "concurrency_group"})

    def options(self, **options) -> "ActorMethod":
        unknown = set(options) - self._SUPPORTED_OPTIONS
        if unknown:
            raise ValueError(
                f"Unsupported actor-method options: {sorted(unknown)} "
                f"(supported: {sorted(self._SUPPORTED_OPTIONS)})"
            )
        return ActorMethod(
            self._handle,
            self._name,
            options.get("num_returns", self._num_returns),
            options.get("concurrency_group", self._concurrency_group),
        )

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(
            self._name, args, kwargs, self._num_returns, self._concurrency_group
        )

    def bind(self, *args, **kwargs):
        """DAG node for this actor method (reference: dag ClassMethodNode);
        compiled DAGs bind methods on live actor handles."""
        from ray_tpu_torch.dag.compiled import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args, kwargs)

    def __call__(self, *a, **k):
        raise TypeError(
            f"Actor method {self._name}() cannot be called directly; use .remote()."
        )


class ActorHandle:
    def __init__(self, actor_id: bytes, methods: dict[str, dict], class_name: str, owned: bool):
        self._actor_id = actor_id
        self._methods = methods
        self._class_name = class_name
        self._owned = owned
        # spec headers per (method, num_returns): the static call fields
        # ship once per connection/worker, bodies reference them by id
        # (cheaper per-task bytes); rebuilt fresh after
        # deserialization — header ids are connection-lifetime cheap
        self._hdr_cache: dict = {}

    @property
    def _actor_id_hex(self) -> str:
        return self._actor_id.hex()

    @property
    def __dag_exec__(self) -> ActorMethod:
        """Internal: the compiled-DAG executor loop entry (worker builtin)."""
        return ActorMethod(self, "__dag_exec__")

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        meta = self._methods.get(name)
        if meta is None:
            raise AttributeError(f"Actor {self._class_name} has no method {name!r}")
        return ActorMethod(
            self, name, meta.get("num_returns", 1), meta.get("concurrency_group")
        )

    def _submit_method(self, name, args, kwargs, num_returns, concurrency_group=None):
        # trace-context propagation: the submitter's context rides the
        # spec by reference (sampled dict, or the shared unsampled token
        # that keeps forensics correlated while spans stay free); with no
        # active context the worker roots a lazy trace at the task id
        from ray_tpu_torch.util import tracing as _tracing
        from ray_tpu_torch.util import waterfall as _waterfall

        ctx = get_ctx()
        streaming = num_returns == "streaming"
        tctx = _tracing.get_trace_context()
        sp_ctx = _tracing.context_for_spec(tctx) if tctx is not None else None
        # task-hop waterfall: sampled request/reply calls stamp phases
        # (streaming replies arrive long after exec — no waterfall)
        wf = None if streaming else _waterfall.maybe_start(sp_ctx)
        s_args, s_kwargs = ctx.serialize_args(args, kwargs)
        if wf is not None:
            _waterfall.stamp(wf)  # serialize: args done, spec build next
        task_id, return_ids = ctx.new_task_returns(
            1 if streaming else max(num_returns, 1)
        )
        hdr = self._hdr_cache.get((name, num_returns))
        if hdr is None:
            from ray_tpu_torch._private.runtime import EMPTY_ARGS, EMPTY_KWARGS

            fields = {
                "kind": "actor_method",
                "actor_id": self._actor_id,
                "method_name": name,
                "num_returns": num_returns,
                "name": f"{self._class_name}.{name}",
                # no-arg calls elide these by identity (serialize_args
                # returns the same constants)
                "args": EMPTY_ARGS,
                "kwargs": EMPTY_KWARGS,
            }
            # CONTENT-derived id (ser.spec_header_id), not per-instance
            # urandom: every deserialized copy of this handle
            # (handle-per-task serve patterns mint thousands) produces the
            # SAME id for the same fields, so receiver-side header caches
            # dedupe instead of growing one entry per handle copy forever
            hid = ser.spec_header_id(
                b"actor_method", self._actor_id, name, num_returns
            )
            hdr = self._hdr_cache[(name, num_returns)] = (hid, fields)
        spec = {
            **hdr[1],
            "task_id": task_id,
            "args": s_args,
            "kwargs": s_kwargs,
            "return_ids": return_ids,
            "_hdr": hdr,
        }
        if sp_ctx is not None:
            spec["trace_ctx"] = sp_ctx
        if wf is not None:
            spec["wf"] = wf
        if concurrency_group:
            spec["concurrency_group"] = concurrency_group
        refs = ctx.submit_actor_task(spec)
        if streaming:
            from ray_tpu_torch._private.runtime import ObjectRefGenerator

            return ObjectRefGenerator(task_id, refs[0], ctx)
        return refs[0] if num_returns == 1 else refs

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:8]})"

    def __reduce__(self):
        # A handle crossing a serialization boundary pins the actor for the
        # session (conservative GC; see ObjectRef.__reduce__).
        try:
            get_ctx().call("actor_inc_handle", actor_id=self._actor_id)
        except Exception:
            pass
        return (_deserialize_handle, (self._actor_id, self._methods, self._class_name))

    def __del__(self):
        # GC-safe: a blocking RPC from a GC tick can deadlock against a
        # thread that holds the head lock (see ObjectRef.__del__); only a
        # reentrant queue put is allowed here.
        if self._owned:
            try:
                ctx = get_ctx()
                if not ctx.closed:
                    ctx.enqueue_gc(
                        "call", ("actor_dec_handle", {"actor_id": self._actor_id})
                    )
            except Exception:
                pass


def _deserialize_handle(actor_id, methods, class_name):
    return ActorHandle(actor_id, methods, class_name, owned=False)


class ActorClass:
    def __init__(self, cls: type, default_options: dict[str, Any]):
        self._cls = cls
        self._options = default_options
        opt.validate(self._options, is_actor=True)
        self._blob: Optional[bytes] = None
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *a, **k):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()."
        )

    def options(self, **new_options) -> "ActorClass":
        merged = {**self._options, **new_options}
        ac = ActorClass(self._cls, merged)
        ac._blob = self._blob
        return ac

    def method_table(self) -> dict[str, dict]:
        methods = {}
        for name in dir(self._cls):
            if name.startswith("__"):
                continue
            m = getattr(self._cls, name, None)
            if callable(m):
                methods[name] = {"num_returns": getattr(m, "_num_returns", 1)}
                group = getattr(m, "_concurrency_group", None)
                if group:
                    methods[name]["concurrency_group"] = group
        return methods

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    def _remote(self, args, kwargs, options):
        ctx = get_ctx()
        name = options.get("name")
        if name and options.get("get_if_exists"):
            try:
                # look where the CREATE would register (explicit namespace,
                # or "default" for detached) — the bare ctx namespace would
                # miss and then collide in create_actor
                ns = options.get("namespace") or (
                    "default" if options.get("lifetime") == "detached" else None
                )
                return get_actor(name, namespace=ns)
            except ValueError:
                pass
        if self._blob is None:
            self._blob = ser.dumps(self._cls)
        func_id = ctx.upload_function(self._blob)
        s_args, s_kwargs = ctx.serialize_args(args, kwargs)
        actor_id = ActorID.from_random().binary()
        task_id, return_ids = ctx.new_task_returns(1)
        methods = self.method_table()
        spec = {
            "task_id": task_id,
            "kind": "actor_create",
            "actor_id": actor_id,
            "func_id": func_id,
            "args": s_args,
            "kwargs": s_kwargs,
            "num_returns": 1,
            "return_ids": return_ids,
            "resources": opt.to_resources(options, is_actor=True),
            "strategy": opt.to_strategy(options),
            "max_restarts": options.get("max_restarts", 0),
            "max_task_retries": options.get("max_task_retries", 0),
            # None = "not set": async actors then default to high concurrency
            # (1000, reference semantics) while an explicit 1 serializes them
            "max_concurrency": options.get("max_concurrency"),
            "concurrency_groups": options.get("concurrency_groups"),
            "name": options.get("name") or self._cls.__name__,
            "lifetime": options.get("lifetime"),
            # detached actors are cluster-scoped services: they register in
            # the shared "default" namespace so every client session can
            # find them; regular named actors scope to the creator's
            # session namespace (reference: namespaces + detached lifetime)
            "namespace": options.get("namespace")
            or (
                "default"
                if options.get("lifetime") == "detached"
                else getattr(ctx, "namespace", "default")
            ),
            "methods": methods,
        }
        if not options.get("name"):
            spec["name"] = None  # anonymous actors are not registered by name
        spec["class_name"] = self._cls.__name__
        if options.get("runtime_env"):
            from ray_tpu_torch._private import runtime_env as renv

            spec["runtime_env"] = renv.package(options["runtime_env"], ctx, kind="actor")
        # head.submit_task takes the submitter's refs on return_ids; the
        # except-free below is a no-op when the failure preceded the submit
        # (remove_ref on a missing entry does nothing)
        try:
            ctx.call("create_actor", spec=spec)
        except Exception:
            for rid in return_ids:
                ctx.call("free_ref_async", obj_id=rid)
            raise
        return ActorHandle(actor_id, methods, self._cls.__name__, owned=True)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self, args, kwargs)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    """Look up a named actor (reference: ``ray.get_actor``). Scoped to the
    caller's namespace; detached actors in "default" are cluster-visible."""
    ctx = get_ctx()
    actor_id, methods = ctx.call(
        "get_actor_named",
        name=name,
        namespace=namespace or getattr(ctx, "namespace", None),
        timeout=0.0,
    )
    spec_methods = methods or {}
    return ActorHandle(actor_id, spec_methods, name, owned=False)


def method(**kwargs):
    """Decorator to override per-method defaults, e.g.
    ``@ray_tpu_torch.method(num_returns=2)`` or
    ``@ray_tpu_torch.method(concurrency_group="io")`` (reference: ``ray.method``,
    concurrency groups in ``core_worker/transport/concurrency_group_manager.cc``)."""

    def wrap(fn):
        if "num_returns" in kwargs:
            fn._num_returns = kwargs["num_returns"]
        if "concurrency_group" in kwargs:
            fn._concurrency_group = kwargs["concurrency_group"]
        return fn

    return wrap
