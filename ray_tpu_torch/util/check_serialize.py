"""Serializability inspection.

Counterpart of the reference's ``ray.util.check_serialize
.inspect_serializability`` — walks a failing object's closure/attributes to
point at the exact leaf that cloudpickle chokes on, instead of surfacing one
opaque ``TypeError`` from deep inside a task submission.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, List, Optional

# AST-level table shared with raylint's RL003 (unserializable closure
# capture): dotted constructor name -> why instances of it cannot cross a
# task boundary. Kept here, next to the runtime-side inspector, so the two
# views of "what cloudpickle chokes on" stay in one place. This module must
# stay import-side-effect free (the serializer import is lazy, below) so the
# linter can use it without dragging in the runtime.
KNOWN_UNSERIALIZABLE_CALLS: dict[str, str] = {
    "threading.Lock": "holds OS lock state",
    "threading.RLock": "holds OS lock state",
    "threading.Condition": "wraps an OS lock",
    "threading.Event": "wraps an OS lock",
    "threading.Semaphore": "wraps an OS lock",
    "threading.BoundedSemaphore": "wraps an OS lock",
    "threading.local": "thread-local storage",
    "_thread.allocate_lock": "holds OS lock state",
    "multiprocessing.Lock": "holds OS lock state",
    "multiprocessing.Queue": "backed by an OS pipe",
    "queue.Queue": "contains locks/conditions",
    "queue.LifoQueue": "contains locks/conditions",
    "queue.PriorityQueue": "contains locks/conditions",
    "socket.socket": "OS socket handle",
    "socket.create_connection": "OS socket handle",
    "open": "open file handle",
    "io.open": "open file handle",
    "subprocess.Popen": "live child process",
    "sqlite3.connect": "database connection handle",
    "mmap.mmap": "memory-mapped OS handle",
    "concurrent.futures.ThreadPoolExecutor": "live thread pool",
    "concurrent.futures.ProcessPoolExecutor": "live process pool",
}


@dataclasses.dataclass
class FailureTuple:
    """One unserializable leaf. ``obj`` is the failing object, ``name`` its
    best-known label, ``parent`` the container it was reached from."""

    obj: Any
    name: str
    parent: Any

    def __repr__(self):
        return f"FailTuple({self.name} [obj={self.obj!r}, parent={self.parent!r}])"


def _try_pickle(obj: Any) -> Optional[Exception]:
    # Lazy so that importing this module (e.g. from the linter) never pulls
    # in the runtime serializer and its cloudpickle dependency.
    from ray_tpu_torch._private import serialization as ser

    try:
        ser.dumps(obj)
        return None
    except Exception as e:  # noqa: BLE001 - any serializer failure counts
        return e


def inspect_serializability(
    obj: Any, name: Optional[str] = None, depth: int = 3, _failures=None, _seen=None
) -> tuple[bool, List[FailureTuple]]:
    """Check whether ``obj`` cloudpickles; on failure, descend into closures,
    attributes and containers to locate root causes.

    Returns ``(serializable, failures)`` where ``failures`` holds the deepest
    offending leaves found (the reference prints a tree; we return the data
    and let the caller format it).
    """
    name = name or getattr(obj, "__qualname__", None) or repr(obj)[:60]
    failures: List[FailureTuple] = [] if _failures is None else _failures
    seen = set() if _seen is None else _seen

    err = _try_pickle(obj)
    if err is None:
        return True, failures
    if id(obj) in seen or depth < 0:
        return False, failures
    seen.add(id(obj))

    found_deeper = False
    children: list[tuple[str, Any]] = []
    if inspect.isfunction(obj) or inspect.ismethod(obj):
        closure = inspect.getclosurevars(obj)
        children += [(f"nonlocal {k}", v) for k, v in closure.nonlocals.items()]
        children += [(f"global {k}", v) for k, v in closure.globals.items()]
    elif isinstance(obj, dict):
        children += [(str(k), v) for k, v in obj.items()]
    elif isinstance(obj, (list, tuple, set)):
        children += [(f"[{i}]", v) for i, v in enumerate(obj)]
    elif hasattr(obj, "__dict__") and not inspect.isclass(obj):
        children += list(vars(obj).items())

    for child_name, child in children:
        if _try_pickle(child) is not None:
            found_deeper = True
            ok, _ = inspect_serializability(
                child, name=child_name, depth=depth - 1, _failures=failures, _seen=seen
            )

    if not found_deeper and not any(f.obj is obj for f in failures):
        failures.append(FailureTuple(obj=obj, name=name, parent=None))
    return False, failures
