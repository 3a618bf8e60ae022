"""Shared-memory object store (plasma equivalent).

The reference runs a plasma store inside each raylet: an mmap + dlmalloc arena
with a unix-socket flatbuffer protocol, LRU eviction and create-backpressure
(``src/ray/object_manager/plasma/store.h:55``). On a TPU host the picture is
simpler: every process that needs zero-copy access is on the same machine, and
device-resident arrays live in HBM addressed by sharding specs — the host
store only carries host-side payloads (batches, checkpending state, small
tensors, control data). So instead of a separate daemon we use one POSIX shm
segment per large object, created by whichever process produced the value and
owned (for unlink purposes) by the head:

* producer lays out [header][buffer0][buffer1...] with 64-byte alignment,
* consumers attach by name and reconstruct the pickled value with pickle-5
  out-of-band buffers pointing straight into the mapping (zero copy),
* the head records {object_id -> ShmLocation} and unlinks on free/shutdown.

Small objects (<= max_direct_call_object_size) never touch shm; they ride the
control-plane socket inline, like the reference's in-process memory store
(``store_provider/memory_store/memory_store.cc``).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import pickle
import sys
import threading
import time
import uuid
from multiprocessing import resource_tracker, shared_memory
from typing import Optional

from ray_tpu_torch._private import events
from ray_tpu_torch._private.serialization import SerializedValue

_ALIGN = 64

# flight-recorder events this module emits (raylint RL012 registry): a
# consumer attaching to an object's bytes and releasing them again. Both
# carry segment/offset provenance (this layer doesn't know object ids —
# the put/locator events tie object id to segment).
EVENT_NAMES = (
    "core.object.map",
    "core.object.unmap",
)

#: raylint RL017 registry — the pin ledger is written only via the two
#: GIL-atomic helpers below (dict store / dict pop), so arena pin/unpin
#: stays on the zero-lock hot path:
#:
#: - _pins: token -> (segment, offset, size, ts); note_pin is a plain
#:   dict store from the pinning thread, drop_pin a plain pop (either the
#:   same thread or the GC finalizer thread — one writer per token, so no
#:   read-modify-write race). pin_stats() reads an atomic list() copy.
LOCKFREE = ("_pins: atomic",)

# Process-local arena pin ledger: every live ``_PinnedBlock`` (= one
# arena pin) registers here so the cluster leak audit can prove "every
# pin is held by a live reader" and flag pinned-forever consumers by age
# (``head.rpc_object_audit`` read-lease threshold). Token is a process
# counter; store/pop are single GIL-atomic dict ops (no lock — __del__
# may run from any thread).
_pins: dict[int, tuple[str, int, int, float]] = {}
_pin_ids = itertools.count(1)


def note_pin(token: int, name: str, offset: int, size: int) -> None:
    """Register a live arena pin (hot path: one atomic dict store)."""
    _pins[token] = (name, offset, size, time.time())


def drop_pin(token: int) -> None:
    """Release a pin's ledger entry (hot path: one atomic dict pop)."""
    _pins.pop(token, None)


def pin_stats() -> dict:
    """This process's live arena pins (leak-audit input): total pinned
    bytes, count, and per-pin provenance with age. Lock-free snapshot."""
    now = time.time()
    rows = [
        {"seg": name, "offset": off, "size": size, "age_s": now - ts}
        for name, off, size, ts in list(_pins.values())
    ]
    return {
        "pinned_bytes": sum(r["size"] for r in rows),
        "count": len(rows),
        "oldest_age_s": max((r["age_s"] for r in rows), default=0.0),
        "pins": rows,
    }


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


@dataclasses.dataclass
class ShmLocation:
    name: str
    header_len: int
    buffer_lens: list[int]
    total_size: int
    #: Set for objects living in the native arena (``_native/arena.cc``):
    #: ``name`` is then the arena segment and ``offset``/``gen`` identify the
    #: allocation for pin/free. None = dedicated POSIX segment (legacy path).
    offset: Optional[int] = None
    gen: int = 0
    #: Binary NodeID of the node whose host holds the bytes (object
    #: directory role — reference: object_manager's object location). The
    #: head routes frees to the owning host and consumers on other hosts
    #: pull via the data plane (``data_plane.py``). None = pre-directory
    #: writer (treated as head-host).
    node: Optional[bytes] = None


# ---------------------------------------------------------------------------
# native arena (plasma-equivalent allocator; see ray_tpu_torch/_native/arena.cc)
# ---------------------------------------------------------------------------

_ARENA_ENV = "RAY_TPU_ARENA"
_arena_lock = threading.Lock()
_arenas: dict[str, "object"] = {}  # name -> Arena (attached mappings, cached)
_write_arena_name: Optional[str] = None


def create_arena(size: int) -> Optional[str]:
    """Head-side: create this host's arena. Returns its name (for worker env
    + later unlink) or None when the native library is unavailable.

    The requested size is clamped to 80% of the shm filesystem's FREE space:
    the segment is sparse, so ftruncate would happily "succeed" past the
    tmpfs limit and the first write into an uncommittable page then SIGBUSes
    the writer (common in containers with a small --shm-size). Clamping
    keeps the 90%-of-capacity degrade watermark (runtime.store_value)
    meaningful."""
    global _write_arena_name
    from ray_tpu_torch import _native

    try:
        st = os.statvfs("/dev/shm")
        free = st.f_bavail * st.f_frsize
        size = max(min(size, int(free * 0.8)), 1024 * 1024)
    except OSError:
        pass
    name = f"/rta-{os.getpid():x}-{uuid.uuid4().hex[:8]}"
    arena = _native.Arena.create(name, size)
    if arena is None:
        return None
    with _arena_lock:
        _arenas[name] = arena
        _write_arena_name = name
    return name


def attach_arena(name: str) -> Optional["object"]:
    """Attach (once per process, cached) to an arena by segment name."""
    with _arena_lock:
        a = _arenas.get(name)
    if a is not None:
        return a
    from ray_tpu_torch import _native

    a = _native.Arena.attach(name)
    if a is not None:
        with _arena_lock:
            _arenas.setdefault(name, a)
            a = _arenas[name]
    return a


def set_write_arena(name: Optional[str]) -> None:
    """Select the arena new objects are written into (worker startup reads
    the head-provided ``RAY_TPU_ARENA`` env; the head/driver sets directly)."""
    global _write_arena_name
    _write_arena_name = name


def _current_write_arena():
    global _write_arena_name
    name = _write_arena_name
    if name is None:
        name = os.environ.get(_ARENA_ENV) or None
        if name is None:
            return None
        _write_arena_name = name
    return attach_arena(name)


def shm_mapping_of(address: int) -> Optional[str]:
    """The ``/dev/shm`` file whose mapping in this process holds
    ``address`` (a tensor's ``data_ptr()``, an array's buffer address), or
    None when the address lies elsewhere: what a zero-copy check holds a
    value read from the store against. Linux only (``/proc/self/maps``)."""
    try:
        with open("/proc/self/maps") as f:
            for line in f:
                parts = line.split(None, 5)
                lo, hi = (int(x, 16) for x in parts[0].split("-"))
                if lo <= address < hi:
                    path = parts[5].strip() if len(parts) > 5 else ""
                    return path if path.startswith("/dev/shm/") else None
    except OSError:
        return None
    return None


def unlink_arena(name: str) -> None:
    with _arena_lock:
        arena = _arenas.pop(name, None)
    if arena is not None:
        arena.unlink()
    global _write_arena_name
    if _write_arena_name == name:
        _write_arena_name = None


def _untrack(shm: shared_memory.SharedMemory) -> None:
    # Python's resource_tracker unlinks segments created by a process when
    # that process exits, which would tear objects out from under other
    # readers. Lifetime is owned by the head instead (explicit unlink).
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:
        pass


def write_shm(sv: SerializedValue) -> ShmLocation:
    """Lay a serialized value out in shared memory.

    Small/medium values go into the native arena when one is attached (a
    single allocation under the arena lock — no per-object syscalls); large
    values, or everything when the native path is unavailable, get a
    dedicated POSIX segment (zero-copy reads, mapping outlives unlink)."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    if sv.total_size <= GLOBAL_CONFIG.arena_max_object_bytes:
        arena = _current_write_arena()
        if arena is not None:
            loc = _write_arena(arena, sv)
            if loc is not None:
                return loc  # else: arena full — fall through to a segment
    return _write_segment(sv)


def layout_views(mv, header_len: int, buffer_lens: list[int]):
    """Split a laid-out object ([header][buf0][buf1...], 64-byte aligned —
    the inverse of ``_layout``) into (header view, [PickleBuffer views]).
    THE one place the layout walk lives; shm readers, the data plane, and
    the head's inline fallback all deserialize through it."""
    header = mv[:header_len]
    bufs = []
    off = _align(header_len)
    for n in buffer_lens:
        bufs.append(pickle.PickleBuffer(mv[off : off + n]))
        off = _align(off + n)
    return header, bufs


def _layout(sv: SerializedValue) -> tuple[list[int], int]:
    """Aligned buffer offsets + total size for [header][buf0][buf1...]."""
    hlen = len(sv.header)
    offs = [_align(hlen)]
    for b in sv.buffers[:-1] if sv.buffers else []:
        offs.append(_align(offs[-1] + b.raw().nbytes))
    total = (offs[-1] + sv.buffers[-1].raw().nbytes) if sv.buffers else hlen
    return offs, max(total, 1)


def _copy_into(mv, sv: SerializedValue, offs: list[int]) -> list[int]:
    """Lay the serialized value out in ``mv``; returns buffer lengths."""
    mv[: len(sv.header)] = sv.header
    lens = []
    for off, b in zip(offs, sv.buffers):
        raw = b.raw()
        n = raw.nbytes
        mv[off : off + n] = raw.cast("B") if raw.format != "B" or raw.ndim != 1 else raw
        lens.append(n)
    return lens


def _write_arena(arena, sv: SerializedValue) -> Optional[ShmLocation]:
    offs, total = _layout(sv)
    r = arena.alloc(total)
    if r is None:
        return None
    base, gen = r
    lens = _copy_into(arena.view(base, total), sv, offs)
    return ShmLocation(arena.name, len(sv.header), lens, total, offset=base, gen=gen)


def _write_segment(sv: SerializedValue) -> ShmLocation:
    offs, total = _layout(sv)
    # On agent hosts, segments carry a per-agent prefix so the agent can
    # sweep orphans at shutdown (segment names are otherwise random and
    # unattributable; the head only frees objects it was told about).
    prefix = os.environ.get("RAY_TPU_SEG_PREFIX")
    if prefix:
        shm = shared_memory.SharedMemory(
            name=f"{prefix}{uuid.uuid4().hex[:12]}", create=True, size=total
        )
    else:
        shm = shared_memory.SharedMemory(create=True, size=total)
    _untrack(shm)
    try:
        lens = _copy_into(shm.buf, sv, offs)
        loc = ShmLocation(shm.name, len(sv.header), lens, total)
    finally:
        shm.close()
    return loc


def _quiet_close(shm: shared_memory.SharedMemory) -> None:
    try:
        shm.close()
    except BufferError:
        shm._buf = None
        shm._mmap = None


class _PinnedBlock:
    """Zero-copy buffer exporter over a pinned arena block (PEP 688).

    Every view a deserialized value holds (numpy bases, PickleBuffers)
    keeps this exporter — and therefore the arena pin — alive; the pin
    drops when the last view dies, letting the allocator recycle the block.
    This is plasma's client-side release semantics
    (``plasma/client.cc`` Release on buffer destruction) done with the
    buffer protocol instead of client bookkeeping: a free racing a live
    reader defers to the last unpin (arena.cc zombie protocol), so reads
    are safe without copying out.
    """

    def __init__(self, arena, offset: int, size: int, rid=None):
        self._arena = arena  # also keeps the mapping alive until released
        self._offset = offset
        self._size = size
        self._rid = rid  # request that mapped us; unmap pairs with it
        self._mv = arena.view(offset, size)
        self._token = next(_pin_ids)
        note_pin(self._token, arena.name, offset, size)

    def __buffer__(self, flags):
        return self._mv

    def __del__(self):
        try:
            self._arena.unpin(self._offset)
        except Exception:  # noqa: BLE001 - interpreter-exit teardown
            pass
        try:
            drop_pin(self._token)
            if self._rid is not None:
                events.emit(
                    "core.object.unmap",
                    size=self._size,
                    seg=self._arena.name,
                    offset=self._offset,
                    request_id=self._rid,
                )
        except Exception:  # noqa: BLE001 - interpreter-exit teardown
            pass


class ShmReader:
    """Read a stored object back.

    Dedicated segments expose zero-copy out-of-band buffers: the mapping must
    outlive any views handed to the deserialized value, so we keep the
    SharedMemory open and let a weak registry close it when the value is
    garbage collected. Arena objects are zero-copy too: views go through a
    ``_PinnedBlock`` exporter whose arena pin lives exactly as long as the
    views do. A vanished object (freed, spilled, or arena gone) raises
    FileNotFoundError, which callers treat as "re-fetch from the head"
    (see runtime._materialize).
    """

    def __init__(self, loc: ShmLocation):
        self.loc = loc
        self.shm = None
        self._block = None
        # map/unmap ride EVERY zero-copy read, so they fire only inside a
        # traced request (mint-time sampling alignment, like spans) — the
        # pin ledger below stays unconditional, so the leak audit never
        # depends on this gate. Unmap reuses the rid captured here: the
        # exporter's __del__ runs under whatever request GC interrupts.
        rid = events.active_request_id()
        if loc.offset is not None:
            arena = attach_arena(loc.name)
            if arena is None or not arena.pin(loc.offset, loc.gen):
                raise FileNotFoundError(f"arena object gone: {loc.name}+{loc.offset}")
            if rid is not None:
                events.emit(
                    "core.object.map",
                    size=loc.total_size,
                    seg=loc.name,
                    offset=loc.offset,
                    request_id=rid,
                )
            if sys.version_info >= (3, 12):
                self._block = _PinnedBlock(arena, loc.offset, loc.total_size, rid)
            else:
                # pre-PEP 688 interpreters can't export a buffer from a
                # Python class, so views could not keep the pin alive —
                # copy the block out and release the pin immediately.
                # Correct (views reference the private copy), not zero-copy.
                try:
                    self._block = bytes(arena.view(loc.offset, loc.total_size))
                finally:
                    arena.unpin(loc.offset)
                if rid is not None:
                    events.emit(
                        "core.object.unmap",
                        size=loc.total_size,
                        seg=loc.name,
                        offset=loc.offset,
                        request_id=rid,
                    )
            return
        self._rid = rid
        self.shm = shared_memory.SharedMemory(name=loc.name)
        _untrack(self.shm)
        if rid is not None:
            events.emit(
                "core.object.map", size=loc.total_size, seg=loc.name,
                request_id=rid,
            )
        # If this reader is GC'd while deserialized values still hold views
        # into the mapping, SharedMemory.__del__ would raise BufferError as
        # an unraisable error (noisy at exit; pytest's unraisable capture
        # even retains the raising frame, pinning ObjectRefs). Close quietly
        # first, disarming on failure — the segment is unlinked by the head,
        # so a leaked mapping dies with the last process.
        import weakref

        weakref.finalize(self, _quiet_close, self.shm)

    def _mv(self):
        return memoryview(self._block) if self.shm is None else self.shm.buf

    def read(self):
        loc = self.loc
        header, bufs = layout_views(self._mv(), loc.header_len, loc.buffer_lens)
        return pickle.loads(header, buffers=bufs)

    def read_serialized_bytes(self) -> bytes:
        """Copy back into wire format (for shipping an object to a REMOTE
        node over the control socket — no shm across hosts)."""
        from ray_tpu_torch._private.serialization import SerializedValue

        loc = self.loc
        header, bufs = layout_views(self._mv(), loc.header_len, loc.buffer_lens)
        return SerializedValue(bytes(header), bufs).to_bytes()

    def close(self):
        if self.shm is None:
            # drop our reference; the pin releases when the last value view
            # over the block dies (PEP 688 exporter lifetime — the exporter
            # emits the unmap event when it finally lets go)
            self._block = None
            return
        if self._rid is not None:
            events.emit(
                "core.object.unmap", size=self.loc.total_size,
                seg=self.loc.name, request_id=self._rid,
            )
        try:
            self.shm.close()
        except BufferError:
            # Views into the mapping are still alive; leak the mapping (it is
            # unlinked by the head, so it dies with the last process). Disarm
            # SharedMemory.__del__ so it doesn't retry and print at exit.
            self.shm._buf = None
            self.shm._mmap = None


def free_location(loc: ShmLocation) -> None:
    """Free a stored object's backing on THIS host: arena blocks go back to
    the allocator (deferred to last unpin if readers are active), dedicated
    segments are unlinked. Used by node agents when the head routes a free
    of an agent-host object (``head._release_loc``)."""
    if loc.offset is not None:
        arena = attach_arena(loc.name)
        if arena is not None:
            arena.free(loc.offset, loc.gen)
        return
    try:
        shm = shared_memory.SharedMemory(name=loc.name)
        shm.close()
        shm.unlink()
    except FileNotFoundError:
        pass


class ShmOwner:
    """Head-side registry of live objects; frees on release/shutdown.

    Dedicated segments are unlinked; arena blocks are freed back to the
    native allocator (a free racing a pinned reader defers to the last
    unpin — arena.cc zombie protocol)."""

    def __init__(self):
        self._lock = threading.Lock()
        # (segment name, arena offset or None) -> (size, gen)
        self._objects: dict[tuple[str, Optional[int]], tuple[int, int]] = {}
        self.bytes_used = 0

    def register(self, loc: ShmLocation) -> None:
        key = (loc.name, loc.offset)
        with self._lock:
            if key not in self._objects:
                self._objects[key] = (loc.total_size, loc.gen)
                self.bytes_used += loc.total_size

    def snapshot(self) -> dict:
        """Atomic copy of the ledger — ``(name, offset) -> (size, gen)`` —
        for the head's leak audit (every registered byte must be owned by
        a live directory locator)."""
        with self._lock:
            return dict(self._objects)

    def unlink(self, loc: ShmLocation) -> None:
        key = (loc.name, loc.offset)
        with self._lock:
            ent = self._objects.pop(key, None)
            if ent is not None:
                self.bytes_used -= ent[0]
        if loc.offset is not None:
            arena = attach_arena(loc.name)
            if arena is not None:
                arena.free(loc.offset, loc.gen)
            return
        try:
            # attach registers with the resource tracker; unlink() unregisters
            # again, so no explicit _untrack here (it would double-unregister).
            shm = shared_memory.SharedMemory(name=loc.name)
            shm.close()
            shm.unlink()
        except FileNotFoundError:
            pass

    def shutdown(self) -> None:
        with self._lock:
            keys = list(self._objects)
            self._objects.clear()
            self.bytes_used = 0
        for name, offset in keys:
            if offset is not None:
                continue  # the arena segment itself is unlinked by its owner
            try:
                shm = shared_memory.SharedMemory(name=name)
                shm.close()
                shm.unlink()
            except FileNotFoundError:
                pass
