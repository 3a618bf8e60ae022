"""Virtual actors: durable named entities whose method calls are
storage-backed transactions (copy of ``ray_tpu/workflow/virtual_actor.py``).

Reference: ``python/ray/workflow/`` virtual actors (``workflow.get_actor``
/ ``@workflow.virtual_actor``) — an "actor" that outlives any process:
its state lives in workflow storage, each method call loads the state,
runs the method as a cluster task, and atomically commits (new state,
result). A crashed caller re-issues the call; a committed call never
re-runs (calls are keyed, like workflow steps).

Per-actor sequential consistency: with a cluster attached, transactions
serialize on a HEAD-SIDE named mutex (``rpc_mutex_acquire`` — leased, so
a crashed holder recovers instead of wedging the actor; works no matter
where the storage directory lives, including NFS/cloud mounts where file
locks degrade to advisory). Without a cluster the fcntl file lock remains
as the single-host fallback. Methods marked ``@readonly`` skip the commit
and the lock entirely.

The state file is written as workflow checkpoints are, so tensors in an
actor's state follow the rule the package doc states.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import pickle
import time
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch._private import serialization as ser

_DEFAULT_STORAGE = os.path.expanduser("~/ray_tpu_torch_workflows")


def readonly(method):
    """Mark a virtual-actor method as state-free: no commit, no write lock."""
    method.__workflow_readonly__ = True
    return method


@ray_tpu_torch.remote
def _apply_method(cls_blob: bytes, state: dict, method_name: str, args, kwargs):
    """Run one actor method on the cluster: rebuild the instance from its
    durable state, apply, return (result, new state)."""
    import cloudpickle

    cls = cloudpickle.loads(cls_blob)
    obj = cls.__new__(cls)
    obj.__dict__.update(state)
    result = getattr(obj, method_name)(*args, **kwargs)
    return result, dict(obj.__dict__)


class VirtualActorHandle:
    def __init__(
        self, actor_cls, actor_id: str, storage: str, txn_lease_s: float = 300.0
    ):
        self._cls = actor_cls
        self._id = actor_id
        self._dir = os.path.join(storage, "virtual_actors", actor_id)
        self._blob: Optional[bytes] = None
        self._lease_s = float(txn_lease_s)

    # -- storage ------------------------------------------------------------

    def _state_path(self) -> str:
        return os.path.join(self._dir, "state.pkl")

    @contextlib.contextmanager
    def _file_lock(self):
        with open(os.path.join(self._dir, ".lock"), "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def _mutex_key(self) -> str:
        """Storage-INDEPENDENT mutex identity: a UUID persisted inside the
        actor directory (O_EXCL creation — first writer wins, racers read).
        Two hosts mounting the same storage at different paths therefore
        contend on the same head mutex; a path-derived name would not."""
        path = os.path.join(self._dir, ".mutex_id")
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            with os.fdopen(fd, "w") as f:
                f.write(os.urandom(16).hex())
        except FileExistsError:
            pass
        with open(path) as f:
            return f"va:{f.read().strip()}"

    @contextlib.contextmanager
    def _txn_lock(self):
        """Yields a ``verify()`` callable the write path MUST call before
        committing: it re-asserts mutex ownership (same-owner acquire
        renews; returns False if the lease expired and someone stole it),
        turning a silently lost update into a loud error."""
        os.makedirs(self._dir, exist_ok=True)
        if not ray_tpu_torch.is_initialized():
            with self._file_lock():
                yield lambda: True
            return
        # Head-side named mutex: correct across hosts and storage backends
        # (identity from _mutex_key, not the caller's local path); the
        # lease (txn_lease_s) bounds crashed-holder recovery. The local
        # file lock is held AS WELL, so a clusterless process on the same
        # host still mutually excludes.
        from ray_tpu_torch._private.runtime import get_ctx

        ctx = get_ctx()
        name = self._mutex_key()
        owner = os.urandom(8).hex()
        ctx.call(
            "mutex_acquire", name=name, owner=owner, lease_s=self._lease_s
        )

        def verify() -> bool:
            return bool(
                ctx.call(
                    "mutex_acquire",
                    name=name,
                    owner=owner,
                    timeout=0,
                    lease_s=self._lease_s,
                )
            )

        try:
            with self._file_lock():
                yield verify
        finally:
            try:
                ctx.call("mutex_release", name=name, owner=owner)
            except Exception:
                pass  # lease expiry reclaims it

    def _load_state(self) -> dict:
        with open(self._state_path(), "rb") as f:
            return pickle.load(f)

    def _commit(self, state: dict, method: str) -> None:
        tmp = self._state_path() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(ser.dumps_with_tensors(state))
        os.replace(tmp, self._state_path())  # atomic
        with open(os.path.join(self._dir, "log.jsonl"), "a") as f:
            import json

            f.write(json.dumps({"method": method, "time": time.time()}) + "\n")

    def _class_blob(self) -> bytes:
        if self._blob is None:
            import cloudpickle

            self._blob = cloudpickle.dumps(self._cls)
        return self._blob

    # -- calls --------------------------------------------------------------

    def exists(self) -> bool:
        return os.path.exists(self._state_path())

    def _init(self, args, kwargs) -> None:
        with self._txn_lock() as verify:
            if self.exists():
                return  # get_or_create: an existing actor keeps its state
            obj = self._cls(*args, **kwargs)
            if not verify():
                raise RuntimeError(
                    f"virtual actor {self._id!r}: transaction lease expired "
                    f"before commit (raise txn_lease_s for slow __init__)"
                )
            self._commit(dict(obj.__dict__), "__init__")

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        method = getattr(self._cls, name, None)
        if method is None or not callable(method):
            raise AttributeError(f"{self._cls.__name__} has no method {name!r}")
        is_readonly = getattr(method, "__workflow_readonly__", False)

        def call(*args, **kwargs):
            if is_readonly:
                state = self._load_state()
                result, _ = ray_tpu_torch.get(
                    _apply_method.remote(self._class_blob(), state, name, args, kwargs)
                )
                return result
            with self._txn_lock() as verify:  # serialize read-modify-write
                state = self._load_state()
                result, new_state = ray_tpu_torch.get(
                    _apply_method.remote(self._class_blob(), state, name, args, kwargs)
                )
                if not verify():
                    # the lease expired mid-transaction and another writer
                    # took over: committing now would silently overwrite its
                    # update — fail loudly instead (reference semantics: a
                    # lost transaction is retried by the caller)
                    raise RuntimeError(
                        f"virtual actor {self._id!r}: transaction exceeded "
                        f"its lease ({self._lease_s}s) and lost the mutex; "
                        f"retry, or pass txn_lease_s= for long methods"
                    )
                self._commit(new_state, name)
            return result

        return call


class VirtualActorClass:
    def __init__(self, cls):
        self._cls = cls

    def get_or_create(
        self,
        actor_id: str,
        *args,
        storage: Optional[str] = None,
        txn_lease_s: float = 300.0,
        **kwargs,
    ) -> VirtualActorHandle:
        handle = VirtualActorHandle(
            self._cls, actor_id, storage or _DEFAULT_STORAGE, txn_lease_s
        )
        handle._init(args, kwargs)
        return handle

    def get(
        self,
        actor_id: str,
        storage: Optional[str] = None,
        txn_lease_s: float = 300.0,
    ) -> VirtualActorHandle:
        handle = VirtualActorHandle(
            self._cls, actor_id, storage or _DEFAULT_STORAGE, txn_lease_s
        )
        if not handle.exists():
            raise ValueError(f"virtual actor {actor_id!r} does not exist")
        return handle


def virtual_actor(cls) -> VirtualActorClass:
    """Class decorator: ``@workflow.virtual_actor`` (reference name)."""
    return VirtualActorClass(cls)


def get_actor(
    actor_id: str,
    cls,
    storage: Optional[str] = None,
    txn_lease_s: float = 300.0,
) -> VirtualActorHandle:
    """Attach to an existing virtual actor (reference: workflow.get_actor;
    the class travels with the caller here — no cluster-global class
    registry in the lite design)."""
    inner = cls._cls if isinstance(cls, VirtualActorClass) else cls
    return VirtualActorClass(inner).get(
        actor_id, storage=storage, txn_lease_s=txn_lease_s
    )
