"""Serve config/data types (copy of ``ray_tpu/serve/_private/common.py``).

Reference: ``python/ray/serve/config.py`` (DeploymentConfig pydantic schemas)
and ``serve/_private/common.py`` (DeploymentID, ReplicaState). Plain
dataclasses here — configs travel through actor boundaries constantly, so
they stay cheap to pickle.

``Sealed`` is the port's addition: a spec's user class and bind arguments
travel through the controller as pickled bytes that only a replica opens,
so the controller never imports what they need (torch, for ``serve.llm``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

CONTROLLER_NAME = "SERVE_CONTROLLER"


class Sealed:
    """A value pickled where the deployment is bound and unpickled only in
    a replica (``Replica.__init__``). The controller stores and forwards it
    as bytes: unpickling a ``serve.llm`` spec would import the engine's
    config classes and, with them, torch, into a process forked from a
    template that must never map torch or CUDA."""

    __slots__ = ("blob",)

    def __init__(self, value: Any):
        import cloudpickle

        self.blob = cloudpickle.dumps(value)

    def open(self) -> Any:
        import pickle

        return pickle.loads(self.blob)


def unseal(value: Any) -> Any:
    """``value`` opened if it is ``Sealed``, else as it is."""
    return value.open() if isinstance(value, Sealed) else value


@dataclasses.dataclass
class AutoscalingConfig:
    """Reference: ``serve/config.py`` AutoscalingConfig /
    ``_private/autoscaling_policy.py`` (decisions from ongoing-request
    telemetry vs a per-replica target).

    Beyond ongoing counts, the controller folds in replica-exported
    ``autoscaling_metrics`` (see ``serve.llm.LLMDeployment``): queued
    requests (``queue_depth``) count toward load the same as ongoing
    ones, and any replica whose KV-cache utilization reaches
    ``kv_utilization_threshold`` adds upscale pressure even when request
    counts look calm (a memory-bound engine preempts long before its
    request count saturates)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    kv_utilization_threshold: float = 0.9


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    user_config: Optional[Any] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 1.0
    #: downscale grace: a victim replica leaves the routing set immediately
    #: but is only killed once its in-flight requests finish (or this
    #: deadline passes) — reference: graceful_shutdown_timeout_s
    graceful_shutdown_timeout_s: float = 10.0
    ray_actor_options: dict = dataclasses.field(default_factory=dict)
    #: gRPC ingress payload contract for this deployment: "bytes" (default —
    #: request/response bytes pass through VERBATIM; unpickling untrusted
    #: ingress bytes is an RCE surface, so deserialization is opt-in),
    #: "pickle" (trusted intra-cluster Python clients), or "json".
    #: Reference: the reference proxy routes typed protos only
    #: (serve/_private/proxy.py:542); this is the no-codegen analog.
    grpc_codec: str = "bytes"
    #: mid-stream failover contract (RESILIENCE.md): the name of a keyword
    #: argument the deployment's streaming methods accept that carries the
    #: items a previous replica already produced. When set, a streaming
    #: call whose replica dies is re-submitted to a fresh replica with
    #: ``<stream_resume_arg>=[items delivered so far]`` and the stream
    #: RESUMES in place instead of erroring — the deployment must continue
    #: from (not re-emit) the resumed prefix. None = streams fail over by
    #: erroring (callers retry whole requests).
    stream_resume_arg: Optional[str] = None
    #: companion to ``stream_resume_arg``: the name of a RELATIVE-seconds
    #: deadline kwarg. On failover the handle re-submits with this kwarg
    #: REDUCED by the time already spent, so the client's declared wait
    #: budget spans the whole request, not each attempt (a deadline that
    #: reset on every replica death would let failovers extend it
    #: indefinitely).
    stream_deadline_arg: Optional[str] = None


@dataclasses.dataclass
class DeploymentSpec:
    """What the controller needs to materialize one deployment."""

    name: str
    app_name: str
    callable_factory: Any      # the user class, Sealed by serve.run
    init_args: tuple = ()      # Sealed by serve.run
    init_kwargs: dict = dataclasses.field(default_factory=dict)  # Sealed by serve.run
    config: DeploymentConfig = dataclasses.field(default_factory=DeploymentConfig)
    is_ingress: bool = False
    #: the user callable (or its __call__) is a generator function: HTTP
    #: responses stream chunk-by-chunk over the streaming-generator return
    #: path (reference: serve StreamingResponse over ASGI)
    streaming: bool = False


@dataclasses.dataclass
class ReplicaInfo:
    replica_id: str
    actor: Any                 # ray_tpu_torch actor handle
    healthy: bool = True
    #: False until the replica answers its first check_health — i.e. its
    #: __init__ (model load, jit warmup) finished. Uninitialized replicas
    #: are not routed to, not counted by ready(), and not health-checked
    #: with the steady-state 5s timeout (a heavy model's init is MINUTES;
    #: judging it against the ping timeout restart-looped every slow-init
    #: replica).
    initialized: bool = False
    started_at: float = 0.0
    init_ref: Any = None       # in-flight first check_health call
