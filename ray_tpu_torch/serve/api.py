"""Serve public API: ``@serve.deployment``, ``bind``, ``serve.run`` (copy of
``ray_tpu/serve/api.py``; specs carry the user class and bind arguments
``Sealed``, so the controller never unpickles them).

Reference: ``python/ray/serve/api.py:246`` (deployment decorator), ``:439``
(serve.run). An ``Application`` is a bound deployment graph — ``.bind()``
arguments may themselves be Applications, and ``serve.run`` materializes the
graph bottom-up, injecting DeploymentHandles where child apps appear
(model-composition, reference ``serve/handle.py``).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Optional, Union

import ray_tpu_torch
from ray_tpu_torch.serve._private.common import (
    CONTROLLER_NAME,
    AutoscalingConfig,
    DeploymentConfig,
    DeploymentSpec,
    Sealed,
)
from ray_tpu_torch.serve.handle import DeploymentHandle

def _default_http_port() -> int:  # tunable: serve_http_port
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return GLOBAL_CONFIG.serve_http_port


def _wrap_function(fn: Callable) -> type:
    """Function deployments become single-method callables. A generator
    function keeps its generator-ness (the wrapper yields from it) so
    streaming detection in _collect_specs sees through the wrapper."""
    if inspect.isgeneratorfunction(fn):

        class _GenFuncDeployment:
            def __call__(self, *args, **kwargs):
                yield from fn(*args, **kwargs)

        _GenFuncDeployment.__name__ = getattr(fn, "__name__", "func")
        return _GenFuncDeployment

    class _FuncDeployment:
        def __call__(self, *args, **kwargs):
            return fn(*args, **kwargs)

    _FuncDeployment.__name__ = getattr(fn, "__name__", "func")
    return _FuncDeployment


@dataclasses.dataclass
class Deployment:
    """The decorated (not yet bound) deployment."""

    callable_cls: type
    name: str
    config: DeploymentConfig

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def options(self, **kwargs) -> "Deployment":
        new_cfg = dataclasses.replace(self.config)
        name = kwargs.pop("name", self.name)
        for k, v in kwargs.items():
            if k == "autoscaling_config" and isinstance(v, dict):
                v = AutoscalingConfig(**v)
            if not hasattr(new_cfg, k):
                raise TypeError(f"Unknown deployment option {k!r}")
            setattr(new_cfg, k, v)
        return Deployment(self.callable_cls, name, new_cfg)


class Application:
    """A deployment bound to init args; args may nest other Applications."""

    def __init__(self, deployment: Deployment, args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


def deployment(
    _cls: Optional[Union[type, Callable]] = None,
    *,
    name: Optional[str] = None,
    num_replicas: Optional[Union[int, str]] = None,
    max_ongoing_requests: int = 8,
    user_config: Any = None,
    autoscaling_config: Optional[Union[dict, AutoscalingConfig]] = None,
    ray_actor_options: Optional[dict] = None,
    health_check_period_s: float = 1.0,
    graceful_shutdown_timeout_s: float = 10.0,
    grpc_codec: str = "bytes",
    stream_resume_arg: Optional[str] = None,
    stream_deadline_arg: Optional[str] = None,
) -> Union[Deployment, Callable[..., Deployment]]:
    """Reference: ``serve/api.py:246``. ``num_replicas="auto"`` enables
    autoscaling with defaults. ``grpc_codec`` sets the gRPC ingress payload
    contract: "bytes" (verbatim passthrough, default), "pickle" (opt-in for
    trusted Python clients), or "json". ``stream_resume_arg`` names the
    kwarg that makes streaming calls RESUMABLE across replica death
    (``DeploymentConfig.stream_resume_arg``; serve.llm sets
    ``"resume_tokens"``)."""
    from ray_tpu_torch.serve._private.grpc_proxy import CODECS

    if grpc_codec not in CODECS:
        raise ValueError(f"grpc_codec must be one of {CODECS}, got {grpc_codec!r}")

    def build(target) -> Deployment:
        cls = target if inspect.isclass(target) else _wrap_function(target)
        nonlocal autoscaling_config, num_replicas
        if num_replicas == "auto" and autoscaling_config is None:
            autoscaling_config = AutoscalingConfig()
        asc = (
            AutoscalingConfig(**autoscaling_config)
            if isinstance(autoscaling_config, dict)
            else autoscaling_config
        )
        cfg = DeploymentConfig(
            num_replicas=num_replicas if isinstance(num_replicas, int) else 1,
            max_ongoing_requests=max_ongoing_requests,
            user_config=user_config,
            autoscaling_config=asc,
            health_check_period_s=health_check_period_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            ray_actor_options=ray_actor_options or {},
            grpc_codec=grpc_codec,
            stream_resume_arg=stream_resume_arg,
            stream_deadline_arg=stream_deadline_arg,
        )
        return Deployment(cls, name or getattr(target, "__name__", "deployment"), cfg)

    if _cls is not None:
        return build(_cls)
    return build


# ---------------------------------------------------------------------------
# controller lifecycle + run
# ---------------------------------------------------------------------------


def _get_or_start_controller():
    from ray_tpu_torch.serve._private.controller import ServeController

    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        cls = ray_tpu_torch.remote(ServeController)
        # detached: the controller outlives any one handle (reference:
        # serve's controller is a detached named actor)
        controller = cls.options(
            name=CONTROLLER_NAME, get_if_exists=True, lifetime="detached",
            # generous: every router parks ONE long-poll here (long_poll
            # push, controller.poll_replicas) on top of regular control calls
            max_concurrency=256,
        ).remote()
        ray_tpu_torch.get(controller.check_health.remote(), timeout=60)
        return controller


def _collect_specs(app: Application, app_name: str) -> tuple[list[DeploymentSpec], str]:
    """DFS the bind graph; nested Applications in args become handles."""
    specs: dict[int, DeploymentSpec] = {}
    names_used: dict[str, int] = {}

    def visit(node: Application) -> DeploymentHandle:
        key = id(node)
        if key in specs:
            return DeploymentHandle(specs[key].name)
        base = node.deployment.name
        n = names_used.get(base, 0)
        names_used[base] = n + 1
        dep_name = f"{app_name}_{base}" if n == 0 else f"{app_name}_{base}_{n}"

        def resolve(v):
            return visit(v) if isinstance(v, Application) else v

        args = tuple(resolve(a) for a in node.args)
        kwargs = {k: resolve(v) for k, v in node.kwargs.items()}
        cls = node.deployment.callable_cls
        call = getattr(cls, "__call__", None) if inspect.isclass(cls) else cls
        streaming = inspect.isgeneratorfunction(call) or inspect.isasyncgenfunction(call)
        specs[key] = DeploymentSpec(
            name=dep_name,
            app_name=app_name,
            # opened only in the replica: the controller stays free of
            # whatever the class and its arguments import
            callable_factory=Sealed(cls),
            init_args=Sealed(args),
            init_kwargs=Sealed(kwargs),
            config=node.deployment.config,
            streaming=streaming,
        )
        return DeploymentHandle(dep_name)

    ingress_handle = visit(app)
    ordered = list(specs.values())
    # the root (first visited) is the ingress
    for s in ordered:
        s.is_ingress = s.name == ingress_handle.deployment_name
    return ordered, ingress_handle.deployment_name


def run(
    app: Application,
    name: str = "default",
    route_prefix: Optional[str] = None,
    http: bool = False,
    http_port: Optional[int] = None,
    grpc: bool = False,
    grpc_port: Optional[int] = None,
    _blocking: bool = True,
) -> DeploymentHandle:
    """Deploy an application; returns the ingress DeploymentHandle.

    Reference: ``serve/api.py:439``. ``http=True`` also ensures the HTTP
    proxy ingress is up (``GET/POST /<name>`` with a JSON body);
    ``grpc=True`` the gRPC ingress (``ray.serve.GenericService/Predict``
    with ``application`` metadata — see _private/grpc_proxy.py)."""
    import time

    controller = _get_or_start_controller()
    specs, ingress = _collect_specs(app, name)
    ray_tpu_torch.get(controller.deploy_application.remote(name, specs), timeout=120)
    if http:
        if http_port is None:
            http_port = _default_http_port()
        ray_tpu_torch.get(controller.ensure_proxy.remote(http_port), timeout=120)
    if grpc:
        ray_tpu_torch.get(
            controller.ensure_grpc_proxy.remote(int(grpc_port or 0)), timeout=120
        )
    if _blocking:
        deadline = time.time() + 120
        while not ray_tpu_torch.get(controller.ready.remote(), timeout=30):
            if time.time() > deadline:
                raise TimeoutError("Serve application failed to become ready")
            time.sleep(0.1)
    return DeploymentHandle(ingress)


def run_config(config: "dict | str", _blocking: bool = True) -> dict:
    """Declarative deploy from a config file/dict (reference:
    ``serve/schema.py`` ServeDeploySchema + ``serve deploy`` CLI).

    Schema::

        proxy:
          port: 8000                  # optional: enables the HTTP ingress
        applications:
          - name: app1
            import_path: pkg.mod:obj  # Application, Deployment, or builder
            args: {...}               # builder kwargs / Deployment.bind kwargs
            deployments:              # per-deployment config overrides
              - name: MyDeployment    # the @serve.deployment name
                num_replicas: 2
                max_ongoing_requests: 16

    ``config`` may be the dict itself, a path to a YAML/JSON file, or a YAML
    string. Returns ``{app_name: ingress_deployment_name}``.
    """
    import dataclasses as _dc
    import importlib
    import os

    if isinstance(config, str):
        text = None
        if os.path.exists(config):
            with open(config) as f:
                text = f.read()
        else:
            text = config
        try:
            import yaml

            config = yaml.safe_load(text)
        except ImportError:
            import json as _json

            config = _json.loads(text)
    if not isinstance(config, dict) or "applications" not in config:
        raise ValueError("serve config must be a mapping with an 'applications' list")

    handles: dict[str, str] = {}
    http_port = (config.get("proxy") or {}).get("port")
    for app_cfg in config["applications"]:
        app_name = app_cfg.get("name", "default")
        import_path = app_cfg["import_path"]
        mod_name, _, attr = import_path.partition(":")
        if not attr:
            raise ValueError(
                f"import_path {import_path!r} must be 'module.sub:attribute'"
            )
        obj = importlib.import_module(mod_name)
        for part in attr.split("."):
            obj = getattr(obj, part)
        args = app_cfg.get("args") or {}
        if isinstance(obj, Application):
            app = obj
        elif isinstance(obj, Deployment):
            app = obj.bind(**args)
        elif callable(obj):
            app = obj(**args)  # builder (reference: app builders with args)
            if isinstance(app, Deployment):
                app = app.bind()
        else:
            raise TypeError(
                f"{import_path!r} resolved to {type(obj).__name__}; expected an "
                "Application, Deployment, or builder callable"
            )
        if not isinstance(app, Application):
            raise TypeError(f"{import_path!r} did not produce an Application")

        controller = _get_or_start_controller()
        specs, ingress = _collect_specs(app, app_name)
        overrides = {
            d["name"]: d for d in app_cfg.get("deployments", []) if "name" in d
        }
        for spec in specs:
            base = spec.name[len(app_name) + 1 :]
            ov = overrides.get(base)
            if not ov:
                continue
            cfg = _dc.replace(spec.config)  # never mutate the shared Deployment config
            for k, v in ov.items():
                if k == "name":
                    continue
                if k == "autoscaling_config" and isinstance(v, dict):
                    v = AutoscalingConfig(**v)
                if not hasattr(cfg, k):
                    raise TypeError(f"Unknown deployment option {k!r} for {base!r}")
                setattr(cfg, k, v)
            spec.config = cfg
        ray_tpu_torch.get(controller.deploy_application.remote(app_name, specs), timeout=120)
        handles[app_name] = ingress
    if http_port is not None:
        controller = _get_or_start_controller()
        ray_tpu_torch.get(controller.ensure_proxy.remote(int(http_port)), timeout=120)
    if _blocking:
        import time

        controller = _get_or_start_controller()
        deadline = time.time() + 120
        while not ray_tpu_torch.get(controller.ready.remote(), timeout=30):
            if time.time() > deadline:
                raise TimeoutError("Serve applications failed to become ready")
            time.sleep(0.1)
    return handles


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    ingress = ray_tpu_torch.get(controller.get_ingress.remote(name), timeout=30)
    if ingress is None:
        raise KeyError(f"No serve application named {name!r}")
    return DeploymentHandle(ingress)


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(f"{app_name}_{deployment_name}")


def status() -> dict:
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    apps = ray_tpu_torch.get(controller.list_apps.remote(), timeout=30)
    return {
        app: {
            d: ray_tpu_torch.get(controller.get_deployment_status.remote(d), timeout=30)
            for d in deps
        }
        for app, deps in apps.items()
    }


def delete(name: str) -> None:
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    ray_tpu_torch.get(controller.delete_application.remote(name), timeout=60)


def shutdown() -> None:
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=60)
        ray_tpu_torch.kill(controller)
    except Exception:
        pass
