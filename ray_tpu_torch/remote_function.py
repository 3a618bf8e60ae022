"""Remote functions: ``@ray_tpu_torch.remote`` on a plain function.

Counterpart of the reference's ``python/ray/remote_function.py`` —
``RemoteFunction._remote`` (:262) pickles the function once into the cluster
function table, resolves options, and submits a task spec; ``.options(...)``
returns a shallow override copy.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

from ray_tpu_torch._private import options as opt
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.runtime import get_ctx
from ray_tpu_torch.util import tracing as _tracing
from ray_tpu_torch.util import waterfall as _waterfall


class RemoteFunction:
    def __init__(self, fn, default_options: Optional[dict] = None):
        if not callable(fn):
            raise TypeError("@remote must decorate a callable")
        self._fn = fn
        self._options = default_options or {}
        opt.validate(self._options, is_actor=False)
        self._blob: Optional[bytes] = None
        self._func_id: Optional[bytes] = None  # sha1(blob), hashed once
        self._spec_template: Optional[dict] = None
        functools.update_wrapper(self, fn)

    def _template(self) -> dict:
        """Static per-(fn, options) spec fields, computed once — option
        resolution (resource folding, strategy validation) off the
        per-.remote() hot path. Values are shared by reference across
        submissions; the head treats spec contents as read-only (the only
        per-dispatch key, _pg_bundle, is set on the per-call spec copy)."""
        tpl = self._spec_template
        if tpl is None:
            o = self._options
            num_returns = o.get("num_returns", 1)
            tpl = self._spec_template = {
                "kind": "task",
                "num_returns": num_returns,
                "resources": opt.to_resources(o, is_actor=False),
                "strategy": opt.to_strategy(o),
                # streaming tasks never retry: items already handed to the
                # consumer cannot be un-consumed (reference disables lineage
                # reconstruction for streaming generators the same way).
                # None = not pinned by options: resolved against the LIVE
                # config at each submission (the config is mutable).
                "max_retries": 0
                if num_returns == "streaming"
                else o.get("max_retries"),
                "name": o.get("name") or getattr(self._fn, "__qualname__", "task"),
            }
            # head-side hot-path caches, template-constant so computed once
            # per (fn, options) instead of per submit: effective (non-zero)
            # resources and the scheduling signature. Must mirror
            # _PendingQueue._sig(spec) exactly — label_selector is folded
            # into strategy by to_strategy and never a spec key, so the
            # label slot is always None for template-built specs
            tpl["_eres"] = {k: v for k, v in tpl["resources"].items() if v != 0}
            tpl["_sig0"] = (
                tuple(sorted((k, v) for k, v in tpl["resources"].items() if v != 0)),
                tuple(tpl["strategy"]) if tpl["strategy"] else None,
                None,
                False,
            )
            # no-arg calls resolve to these SAME constants in
            # serialize_args, so the header identity-elision drops
            # args/kwargs from the steady-state wire body entirely
            from ray_tpu_torch._private.runtime import EMPTY_ARGS, EMPTY_KWARGS

            tpl["args"] = EMPTY_ARGS
            tpl["kwargs"] = EMPTY_KWARGS
        return tpl

    def __call__(self, *a, **k):
        raise TypeError(
            f"Remote function {self._fn.__name__}() cannot be called directly; "
            f"use {self._fn.__name__}.remote()."
        )

    def options(self, **new_options) -> "RemoteFunction":
        merged = {**self._options, **new_options}
        rf = RemoteFunction(self._fn, merged)
        rf._blob = self._blob
        return rf

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    def _remote(self, args, kwargs, options):
        ctx = get_ctx()
        if self._blob is None:
            self._blob = ser.dumps(self._fn)
        # the sha1 is per-(fn) constant: hash once here, let the context
        # intern the id (upload_function's per-ctx cache still decides
        # whether THIS cluster has seen the blob)
        func_id = ctx.upload_function(self._blob, self._func_id)
        self._func_id = func_id
        if options is self._options:
            tpl = self._template()
        else:  # explicit options dict (DAG execution paths)
            tpl = RemoteFunction(self._fn, options)._template()
        if "_hdr" not in tpl and tpl is self._spec_template:
            # spec header (cheaper per-task bytes): the static
            # per-(fn, options) fields ship once per connection/worker and
            # steady-state submissions reference them by id. func_id is
            # interned by upload_function, so identity-elision holds. Only
            # the CACHED template gets one — a throwaway options-override
            # template would mint a fresh header id per call and bloat
            # every receiver's header cache. The id is CONTENT-derived
            # (func_id + the stable option fields), so every process that
            # deserializes this function mints the SAME id and receiver
            # caches dedupe; racing first calls build identical headers.
            fields = dict(tpl)
            fields.pop("_hdr", None)  # racing first calls must not nest
            fields["func_id"] = func_id
            hid = ser.spec_header_id(
                b"task",
                func_id,
                sorted(
                    (k, v)
                    for k, v in fields.items()
                    if k in ("resources", "strategy", "num_returns",
                             "max_retries", "name", "kind")
                ),
            )
            tpl["_hdr"] = (hid, fields)
        num_returns = tpl["num_returns"]
        streaming = num_returns == "streaming"
        # trace-context propagation (util.tracing): a submission under an
        # active context ships it BY REFERENCE (sampled dict or shared
        # unsampled token — the token keeps request-id forensics intact
        # downstream while spans stay free); with no context at all the
        # executing worker roots a lazy trace at the task's own id, so
        # every task tree stays traceable without the submitter paying a
        # per-task id mint
        tctx = _tracing.get_trace_context()
        sp_ctx = _tracing.context_for_spec(tctx) if tctx is not None else None
        # task-hop waterfall (util.waterfall): SAMPLED request/reply tasks
        # carry phase stamps; everything else ships nothing and pays one
        # type check (streaming tasks reply long after exec — no waterfall)
        wf = None if streaming else _waterfall.maybe_start(sp_ctx)
        s_args, s_kwargs = ctx.serialize_args(args, kwargs)
        if wf is not None:
            _waterfall.stamp(wf)  # serialize: args done, spec build next
        task_id, return_ids = ctx.new_task_returns(
            1 if streaming else max(num_returns, 1)
        )
        spec = {
            **tpl,
            "task_id": task_id,
            "func_id": func_id,
            "args": s_args,
            "kwargs": s_kwargs,
            "return_ids": return_ids,
        }
        if sp_ctx is not None:
            spec["trace_ctx"] = sp_ctx
        if wf is not None:
            spec["wf"] = wf
        ns = getattr(ctx, "namespace", "default")
        if ns != "default":
            # tasks inherit the submitter's namespace (reference: job-scoped
            # namespaces): get_actor / named-actor creation inside the task
            # resolves in the client session's namespace, not "default"
            spec["namespace"] = ns
        if spec["max_retries"] is None:
            spec["max_retries"] = GLOBAL_CONFIG.default_max_retries
        if options.get("runtime_env"):
            from ray_tpu_torch._private import runtime_env as renv

            spec["runtime_env"] = renv.package(options["runtime_env"], ctx)
        refs = ctx.submit_task(spec)
        if streaming:
            from ray_tpu_torch._private.runtime import ObjectRefGenerator

            return ObjectRefGenerator(task_id, refs[0], ctx)
        if num_returns == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """Lazy DAG-node construction (reference: dag/dag_node.py)."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)


def remote_decorator(args: tuple, kwargs: dict[str, Any]):
    """Implements both ``@remote`` and ``@remote(**opts)`` for functions and
    classes (dispatch mirrors reference ``python/ray/_private/worker.py`` remote)."""
    from ray_tpu_torch.actor import ActorClass

    if len(args) == 1 and not kwargs and callable(args[0]):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target, {})
        return RemoteFunction(target)
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")

    def wrap(target):
        if isinstance(target, type):
            return ActorClass(target, dict(kwargs))
        return RemoteFunction(target, dict(kwargs))

    return wrap
