"""Top-level API: init/shutdown/remote/get/put/wait/kill/cancel/...

Counterpart of the reference's ``python/ray/_private/worker.py`` public
surface (``ray.init`` :1225, ``get`` :2553, ``put`` :2685, ``wait`` :2750)
minus the daemon zoo: ``init()`` stands up the in-driver Head, registers this
host as the first node (auto-detecting CPUs and GPUs, ``accelerators/gpu.py``),
and installs the driver context.
"""

from __future__ import annotations

import atexit
import os
import tempfile
import time
from typing import Any, Optional, Sequence, Union

from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private import runtime
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.head import Head
from ray_tpu_torch._private.runtime import DriverContext, ObjectRef

_head: Optional[Head] = None
_session_dir: Optional[str] = None
#: ``preload_python_modules`` as it stood before ``init``: the option is one
#: cluster's, so ``shutdown`` puts it back and the next cluster's workers
#: import only what that cluster asks for
_preload_outside = GLOBAL_CONFIG.preload_python_modules


def _check_preload(names: str) -> None:
    """Every module ``preload_python_modules`` names must exist: the
    forkserver template imports them in a process whose errors no caller
    reads, so a misspelt name raises here instead of silently preloading
    nothing. (A dotted name's parents are imported to find it.)"""
    import importlib.util

    for name in filter(None, (n.strip() for n in names.split(","))):
        try:
            found = importlib.util.find_spec(name) is not None
        except ImportError:  # a parent package is missing
            found = False
        if not found:
            raise ValueError(f"preload_python_modules: no module named {name!r}")


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_tpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[dict[str, float]] = None,
    labels: Optional[dict[str, str]] = None,
    object_store_memory: Optional[int] = None,
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
    namespace: Optional[str] = None,
    _system_config: Optional[dict[str, Any]] = None,
    _head: Optional[Head] = None,
    _node_id=None,
):
    """Start (or attach to) a cluster and install the driver context.

    With no arguments this host becomes a single-node cluster, like the
    reference's ``ray.init()`` auto-start path. ``_head``/``_node_id`` are the
    attach path used by cluster_utils test clusters.
    """
    global _session_dir
    if runtime.is_initialized():
        if ignore_reinit_error:
            return _context_info()
        raise rex.RayError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True to ignore")
    global _preload_outside
    _preload_outside = GLOBAL_CONFIG.preload_python_modules
    GLOBAL_CONFIG.apply_overrides(_system_config)
    try:
        _check_preload(GLOBAL_CONFIG.preload_python_modules)
    except ValueError:
        GLOBAL_CONFIG.preload_python_modules = _preload_outside
        raise
    if object_store_memory:
        # sizes both the node "memory" resource and the spill watermark
        GLOBAL_CONFIG.object_store_memory = int(object_store_memory)
    if address is not None and address.startswith("ray://"):
        # client mode (reference: ray:// gRPC proxy, util/client/) — here the
        # remote-driver TCP attach IS the client protocol, so the scheme is
        # an alias for it
        address = address[len("ray://"):]
    if (
        address is not None
        and _head is None
        and ":" in address
        and not address.startswith("ray-tpu://")
    ):
        # remote attach over TCP (reference: ray.init(address="host:port"))
        from ray_tpu_torch._private.config import resolve_authkey
        from ray_tpu_torch._private.runtime import RemoteDriverContext
        from ray_tpu_torch._private.worker_main import connect_head

        authkey = resolve_authkey()
        conn = connect_head(address, authkey)
        conn.send(
            (
                "register_driver",
                {
                    "namespace": namespace,
                    "session_token": os.environ.get("RAY_TPU_SESSION_TOKEN"),
                },
            )
        )
        kind, info = conn.recv()
        if kind != "driver_ack":
            raise rex.RayError(f"unexpected handshake reply {kind!r}")
        ctx = RemoteDriverContext(
            conn,
            info["node_id"],
            authkey=authkey,
            head_host=address.rsplit(":", 1)[0],
            address=address,
            session_token=info.get("session_token"),
        )
        resumed_ns = info.get("namespace")
        if namespace and resumed_ns and resumed_ns != namespace:
            # a stale RAY_TPU_SESSION_TOKEN must not silently put the
            # driver's named actors in the wrong namespace
            ctx.shutdown()
            raise rex.RayError(
                f"session token resumed namespace {resumed_ns!r} but "
                f"namespace={namespace!r} was requested; unset "
                f"RAY_TPU_SESSION_TOKEN or drop the namespace argument"
            )
        ctx.namespace = resumed_ns or namespace or "default"
        runtime.set_ctx(ctx)
        from ray_tpu_torch._private import events as _events

        _events.install_crash_handlers()
        atexit.register(_atexit_shutdown)
        return _context_info()
    if address is not None and _head is None:
        from ray_tpu_torch.cluster_utils import resolve_address

        cluster = resolve_address(address)
        if cluster.head_node is None:
            raise rex.RayError("Cluster has no head node")
        _head, _node_id = cluster.head, cluster.head_node
    if _head is not None:
        head = _head
        node_id = _node_id
    else:
        _session_dir = tempfile.mkdtemp(prefix="ray_tpu_session_")
        sock = os.path.join(_session_dir, "head.sock")
        # RAY_TPU_AUTHKEY makes this cluster attachable from other
        # processes/hosts (scripts.py head path uses the same secret);
        # without it, a fresh random key isolates the session
        from ray_tpu_torch._private.config import resolve_authkey as _rk

        head = Head(
            sock,
            authkey=_rk() if os.environ.get("RAY_TPU_AUTHKEY") else os.urandom(16),
        )
        head.start()
        res = dict(resources or {})
        res.setdefault("CPU", float(num_cpus if num_cpus is not None else os.cpu_count() or 1))
        from ray_tpu_torch.accelerators import gpu as gpu_accel

        if num_gpus is not None:
            res.setdefault("GPU", float(num_gpus))
        elif "GPU" not in res:
            gpus = gpu_accel.detect_num_gpus()
            if gpus:
                res["GPU"] = float(gpus)
                for k, v in gpu_accel.extra_resources(gpus).items():
                    res.setdefault(k, v)
        if num_tpus:
            # a logical resource only: the port drives no TPU
            res.setdefault("TPU", float(num_tpus))
        res.setdefault("memory", _default_memory(object_store_memory))
        node_id = head.add_node(res, labels=labels)
    ctx = DriverContext(head, node_id.binary())
    if namespace:
        ctx.namespace = namespace
    runtime.set_ctx(ctx)
    _set_head(head)
    # flight recorder: the driver's event ring flushes to JSONL on
    # unhandled exceptions / SIGTERM too (events.py; workers arm theirs
    # in worker_main) — postmortems cover the whole process tree
    from ray_tpu_torch._private import events as _events

    _events.install_crash_handlers()
    atexit.register(_atexit_shutdown)
    return _context_info()


def _set_head(head):
    global _head
    _head = head


def _default_memory(object_store_memory):
    if object_store_memory:
        return float(object_store_memory)
    if GLOBAL_CONFIG.object_store_memory:
        return float(GLOBAL_CONFIG.object_store_memory)
    try:
        import psutil

        return float(psutil.virtual_memory().total * 0.3)
    except Exception:
        return float(8 << 30)


def _context_info():
    return {"node_id": runtime.get_ctx().node_id_bin.hex(), "session_dir": _session_dir}


def _atexit_shutdown():
    try:
        shutdown()
    except Exception:
        pass


def is_initialized() -> bool:
    return runtime.is_initialized()


def shutdown():
    global _head
    if not runtime.is_initialized():
        return
    ctx = runtime.get_ctx()
    ctx.shutdown()
    runtime.set_ctx(None)
    if _head is not None:
        _head.shutdown()
        _head = None
    GLOBAL_CONFIG.preload_python_modules = _preload_outside


def put(value: Any) -> ObjectRef:
    return runtime.get_ctx().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    ctx = runtime.get_ctx()
    if isinstance(refs, ObjectRef):
        return ctx.get([refs], timeout)[0]
    if isinstance(refs, (list, tuple)):
        for r in refs:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"ray_tpu_torch.get() takes ObjectRefs, got {type(r)}")
        return ctx.get(list(refs), timeout)
    raise TypeError(f"ray_tpu_torch.get() takes an ObjectRef or a list, got {type(refs)}")


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("ray_tpu_torch.wait() takes a list of ObjectRefs")
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("wait() got duplicate ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns > number of refs")
    if num_returns <= 0:
        raise ValueError("num_returns must be > 0")
    return runtime.get_ctx().wait(refs, num_returns, timeout, fetch_local)


def remote(*args, **kwargs):
    from ray_tpu_torch.remote_function import remote_decorator

    return remote_decorator(args, kwargs)


def kill(actor, *, no_restart: bool = True):
    from ray_tpu_torch.actor import ActorHandle

    if not isinstance(actor, ActorHandle):
        raise TypeError("ray_tpu_torch.kill() takes an actor handle")
    runtime.get_ctx().call("kill_actor", actor_id=actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    if not isinstance(ref, ObjectRef):
        raise TypeError("ray_tpu_torch.cancel() takes an ObjectRef")
    # task id = first 12 bytes of a return object id + index; the head keys
    # tasks by full task_id, so reconstruct it
    from ray_tpu_torch._private.ids import TaskID

    task_id = ref.binary()[:12] + b"\x00\x00\x00\x00"
    runtime.get_ctx().call("cancel_task", task_id=task_id, force=force)


def nodes():
    return runtime.get_ctx().call("nodes")


def cluster_resources() -> dict[str, float]:
    return runtime.get_ctx().call("cluster_resources")


def available_resources() -> dict[str, float]:
    return runtime.get_ctx().call("available_resources")


class RuntimeContext:
    """Reference: ``ray.runtime_context.RuntimeContext``."""

    def __init__(self, ctx):
        self._ctx = ctx

    def get_node_id(self) -> str:
        return self._ctx.node_id_bin.hex()

    def get_actor_id(self) -> Optional[str]:
        inst = getattr(self._ctx, "current_actor", None)
        return None if inst is None else inst

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False

    def get_assigned_resources(self) -> dict:
        return {}


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(runtime.get_ctx())


def timeline() -> list[dict]:
    """Task state-transition events (reference: ``ray.timeline`` Chrome trace
    from the GCS task-event table)."""
    return runtime.get_ctx().call("task_events")
