"""Mutable shared-memory channels (reference: ``python/ray/experimental/
channel.py:49`` — the reusable plasma channels under compiled DAGs).

A Channel is one POSIX shm segment reused for every message between a fixed
writer and a fixed reader — after setup, sending a value is a serialize +
memcpy + counter bump with no task submission, no socket round-trip, and no
allocation. That makes actor-to-actor pipelines (compiled DAGs, pipeline
parallelism across hosts' driver processes) run at memory bandwidth instead
of control-plane latency.

Protocol: single-slot rendezvous (matching the reference's channel
semantics, where a write blocks until the previous value was read):

    [ wseq : 8 bytes ][ rack : 8 bytes ][ len : 8 bytes ][ payload ... ]

* writer: wait until ``wseq == rack`` (previous value consumed), write
  payload + len, then publish ``wseq += 1``;
* reader: wait until ``wseq > rack``, copy payload out, ack ``rack = wseq``.

One writer and one reader per channel (fan-out = one channel per edge).
Both sides poll with escalating sleeps — at pipeline rates the hot path
spins only microseconds.
"""

from __future__ import annotations

import struct
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Optional

from ray_tpu_torch._private import serialization as ser

_HDR = 24  # wseq, rack, len


class ChannelClosed(Exception):
    pass


_CLOSED_LEN = (1 << 63) - 1  # len sentinel: channel torn down


def _untrack(shm) -> None:
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:
        pass


class Channel:
    """One fixed-size, reusable message slot in shared memory."""

    def __init__(self, capacity: int = 1 << 20, _name: Optional[str] = None):
        if _name is None:
            shm = shared_memory.SharedMemory(create=True, size=_HDR + capacity)
            shm.buf[:_HDR] = b"\x00" * _HDR
            self._creator = True
        else:
            shm = shared_memory.SharedMemory(name=_name)
            self._creator = False
        _untrack(shm)
        self._shm = shm
        self.capacity = capacity
        self.name = shm.name

    # channels travel inside task args/plans; attach by name on arrival
    def __reduce__(self):
        return (Channel, (self.capacity, self.name))

    # -- counters ----------------------------------------------------------

    def _get(self, off: int) -> int:
        return struct.unpack_from("<q", self._shm.buf, off)[0]

    def _set(self, off: int, v: int) -> None:
        struct.pack_into("<q", self._shm.buf, off, v)

    @staticmethod
    def _spin(start: float, deadline: Optional[float]) -> None:
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError("channel wait timed out")
        waited = time.monotonic() - start
        time.sleep(0.0 if waited < 0.001 else (0.0001 if waited < 0.1 else 0.001))

    # -- data path ---------------------------------------------------------

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        data = ser.serialize(value).to_bytes()
        if len(data) > self.capacity:
            raise ValueError(
                f"serialized value ({len(data)}B) exceeds channel capacity "
                f"({self.capacity}B); create the Channel with a larger capacity"
            )
        deadline = None if timeout is None else time.monotonic() + timeout
        start = time.monotonic()
        while self._get(0) != self._get(8):  # previous message unread
            if self._get(16) == _CLOSED_LEN:
                raise ChannelClosed()
            self._spin(start, deadline)
        self._shm.buf[_HDR : _HDR + len(data)] = data
        self._set(16, len(data))
        self._set(0, self._get(0) + 1)

    def read(self, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        start = time.monotonic()
        while True:
            wseq, rack = self._get(0), self._get(8)
            if wseq > rack:
                break
            if self._get(16) == _CLOSED_LEN:
                raise ChannelClosed()
            self._spin(start, deadline)
        n = self._get(16)
        if n == _CLOSED_LEN:
            raise ChannelClosed()
        data = bytes(self._shm.buf[_HDR : _HDR + n])
        self._set(8, wseq)
        return ser.deserialize_value(ser.SerializedValue.from_bytes(data))

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Mark closed: blocked/future readers and writers raise
        ChannelClosed (compiled-DAG teardown)."""
        try:
            self._set(16, _CLOSED_LEN)
            self._set(0, self._get(0) + 1)
        except Exception:
            pass

    def destroy(self) -> None:
        self.close()
        if self._creator:
            try:
                # creation untracked the segment (lifetime is ours, not the
                # resource_tracker's); re-register right before unlink so the
                # tracker's unregister message balances and stays quiet
                resource_tracker.register(self._shm._name, "shared_memory")  # type: ignore[attr-defined]
            except Exception:
                pass
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
        try:
            self._shm.close()
        except BufferError:
            self._shm._buf = None  # type: ignore[attr-defined]
            self._shm._mmap = None  # type: ignore[attr-defined]
