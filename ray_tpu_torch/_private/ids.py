"""Binary IDs for objects, tasks, actors, nodes, placement groups.

TPU-native counterpart of the reference's ``src/ray/common/id.h`` (28-byte
TaskID/ObjectID with embedded owner+index). We keep the essential properties —
globally unique, cheaply hashable, order-stamped so an object id encodes its
producing task and return index — with a simpler 16-byte layout since our
control plane is centralized rather than fully decentralized.
"""

from __future__ import annotations

import os
import threading

_ID_SIZE = 16


class BaseID:
    __slots__ = ("_bin",)
    _kind = "ID"

    def __init__(self, binary: bytes):
        if len(binary) != _ID_SIZE:
            raise ValueError(f"{self._kind} must be {_ID_SIZE} bytes, got {len(binary)}")
        self._bin = binary

    @classmethod
    def from_random(cls):
        return cls(os.urandom(_ID_SIZE))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * _ID_SIZE)

    def is_nil(self) -> bool:
        return self._bin == b"\x00" * _ID_SIZE

    def binary(self) -> bytes:
        return self._bin

    def hex(self) -> str:
        return self._bin.hex()

    def __hash__(self):
        return hash(self._bin)

    def __eq__(self, other):
        return type(other) is type(self) and other._bin == self._bin

    def __repr__(self):
        return f"{self._kind}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bin,))


class TaskID(BaseID):
    _kind = "TaskID"


class ActorID(BaseID):
    _kind = "ActorID"


class NodeID(BaseID):
    _kind = "NodeID"


class JobID(BaseID):
    _kind = "JobID"


class PlacementGroupID(BaseID):
    _kind = "PlacementGroupID"


class ObjectID(BaseID):
    """Object ids embed (task id prefix, return index) like the reference's
    ObjectID::FromIndex (id.h), so lineage can map an object back to the task
    that produced it."""

    _kind = "ObjectID"

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        if not 0 <= index < (1 << 32):
            raise ValueError("return index out of range")
        return cls(task_id.binary()[:12] + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls) -> "ObjectID":
        return cls.from_random()

    def task_prefix(self) -> bytes:
        return self._bin[:12]

    def return_index(self) -> int:
        return int.from_bytes(self._bin[12:], "little")


class _Counter:
    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._v += 1
            return self._v
