"""User-visible exception types (copy of ``ray_tpu/exceptions.py``).

The same failure taxonomy as the JAX package (RayError, RayTaskError,
RayActorError, GetTimeoutError, ObjectLostError, TaskCancelledError, ...,
and ``OverloadedError`` from the serving engine's deadline-aware
shedding), each pickling as the reference's does.
"""

from __future__ import annotations

import traceback


class RayError(Exception):
    """Base class for all framework errors."""


class RayTaskError(RayError):
    """Wraps an exception raised inside a remote task/actor method.

    Like the reference (``python/ray/exceptions.py`` RayTaskError), getting an
    object whose producing task failed re-raises the error on the caller, with
    the remote traceback attached, and the error propagates through dependent
    tasks.
    """

    def __init__(self, function_name: str, traceback_str: str, cause: Exception):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"{function_name} failed:\n{traceback_str}")

    def __reduce__(self):
        return (RayTaskError, (self.function_name, self.traceback_str, self.cause))

    @classmethod
    def from_exception(cls, function_name: str, exc: Exception) -> "RayTaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        try:  # keep the original exception if it is picklable
            import cloudpickle

            cloudpickle.dumps(exc)
            cause = exc
        except Exception:
            cause = RayError(repr(exc))
        return cls(function_name, tb, cause)

    def as_instanceof_cause(self) -> Exception:
        """Return an exception that is also an instance of the cause's type so
        ``except UserError`` works across the task boundary."""
        cause = self.cause
        if isinstance(cause, RayTaskError):
            return cause.as_instanceof_cause()
        cls = type(cause)
        if cls in (RayError,) or issubclass(cls, RayTaskError):
            return self
        try:
            derived = type(
                "RayTaskError(" + cls.__name__ + ")",
                (RayTaskError, cls),
                {"__init__": lambda s: None},
            )()
            derived.__dict__.update(self.__dict__)
            derived.args = self.args
            return derived
        except TypeError:
            return self


class RayActorError(RayError):
    """The actor died before or during this method call."""

    def __init__(self, actor_id=None, msg="The actor died unexpectedly before finishing this task."):
        self.actor_id = actor_id
        super().__init__(msg)


class ActorDiedError(RayActorError):
    pass


class ActorUnavailableError(RayActorError):
    """The actor is temporarily unavailable (e.g. restarting)."""


class GetTimeoutError(RayError, TimeoutError):
    pass


class ObjectLostError(RayError):
    def __init__(self, object_id_hex: str, msg: str | None = None):
        self.object_id_hex = object_id_hex
        super().__init__(msg or f"Object {object_id_hex} was lost (node died) and could not be reconstructed.")


class ObjectStoreFullError(RayError):
    pass


class TaskCancelledError(RayError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__("This task or its dependency was cancelled")


class WorkerCrashedError(RayError):
    def __init__(self, msg="The worker died unexpectedly while executing this task."):
        super().__init__(msg)


class RuntimeEnvSetupError(RayError):
    pass


class PlacementGroupSchedulingError(RayError):
    pass


class OutOfMemoryError(RayError):
    """The memory monitor killed this task's worker to relieve host memory
    pressure (reference: ``worker_killing_policy.h`` + OOM-killed task
    errors)."""


class OverloadedError(RayError):
    """The request was shed by deadline-aware admission control instead of
    queued as doomed work (RESILIENCE.md): the serving engine's backlog ÷
    service rate said the deadline could not be met.  The serve HTTP proxy
    maps this to ``429 Too Many Requests`` with a ``Retry-After`` header
    from ``retry_after_s``."""

    def __init__(self, msg: str = "server overloaded", retry_after_s: float = 1.0):
        self.retry_after_s = retry_after_s
        super().__init__(msg)

    def __reduce__(self):
        return (OverloadedError, (self.args[0] if self.args else "", self.retry_after_s))
