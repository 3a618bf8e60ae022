"""Peer-to-peer bulk object transfer (the data plane).

The reference moves objects node→node directly: each raylet's object manager
serves chunks over gRPC with push/pull managers
(``src/ray/object_manager/object_manager.h:117``, ``push_manager.h:30``,
``pull_manager.cc:48``) and the GCS holds only the directory. A later revision of
this build funneled every remote byte through the head as one inline RPC —
two hops, head bandwidth = cluster bandwidth. This module is the fix:

* every host (head and node agents) runs a ``DataServer`` — an
  hmac-authenticated TCP listener that serves the host's shared-memory
  objects (arena blocks pinned for the duration of the send; dedicated
  segments attached read-only) in bounded chunks, zero-copy out of the
  mapping via ``send_bytes(memoryview)``;
* consumers ``fetch()`` straight from the owning host — the head hands out
  only the locator (object directory role) and its data socket address;
* receivers write into one preallocated buffer via ``recv_bytes_into``
  (single copy off the socket), then deserialize with out-of-band buffer
  views into it (no further copies).

Connections are pooled per address and reused; a vanished object (freed or
spilled between locator and fetch) answers ("gone", reason) and the caller
falls back to the head's restore path, mirroring the reference's pull-retry.

Known limitation (vs the reference's per-raylet spill): agent hosts do not
spill to disk. The arena is bounded by a watermark — workers degrade to the
head-mediated inline path (whose spill machinery applies) when their arena
passes 90% — but over-arena-cap dedicated segments are bounded only by
object lifetimes (the head frees them promptly, and agents sweep orphans by
name prefix at shutdown).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from multiprocessing.connection import Client, Listener
from typing import Optional

from ray_tpu_torch._private import events

#: flight-recorder events this module emits (raylint RL012 registry): the
#: serving half of a cross-host pull (``role="serve"``; the consumer half
#: is emitted by runtime._fetch_via_data_plane).
EVENT_NAMES = ("core.object.p2p_pull",)


#: seconds a client that connected has to answer the hmac challenge
HANDSHAKE_TIMEOUT_S = 20.0


def authenticate(conn, authkey: bytes) -> None:
    """The server's half of multiprocessing's hmac handshake on an accepted
    connection, as ``Listener.accept`` runs it, within
    ``HANDSHAKE_TIMEOUT_S``. The listeners accept without it
    (``authkey=None``) and each connection's own thread runs it, so one
    client that connects and stays silent holds up no other connect. The
    deadline covers the whole handshake: when it passes, a watchdog shuts
    the socket down, so a client that stops mid-message fails the read
    too. Raises (``AuthenticationError``, ``OSError``, ``EOFError``) for a
    client to drop."""
    from multiprocessing.connection import answer_challenge, deliver_challenge

    sock = socket.socket(fileno=os.dup(conn.fileno()))
    lock, done = threading.Lock(), False

    def expire() -> None:
        with lock:
            if not done:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:  # the client has gone already
                    pass

    watchdog = threading.Timer(HANDSHAKE_TIMEOUT_S, expire)
    watchdog.daemon = True
    watchdog.start()
    try:
        deliver_challenge(conn, authkey)
        answer_challenge(conn, authkey)
    finally:
        with lock:
            done = True
        watchdog.cancel()
        sock.close()


def _chunk_bytes() -> int:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    # floor, not validation error: a zero/negative override would make the
    # sender's while loop emit empty messages forever
    return max(4096, GLOBAL_CONFIG.object_transfer_chunk_bytes)


class DataServer:
    """Serves this host's shm objects to remote pullers."""

    def __init__(self, authkey: bytes, host: str = "0.0.0.0"):
        # a large backlog, as the head's listeners have (head.start); the
        # handshake runs in each connection's thread (``authenticate``)
        self._authkey = authkey
        self._listener = Listener((host, 0), backlog=socket.SOMAXCONN)
        self.port = self._listener.address[1]
        self.bytes_served = 0
        self._shutdown = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="data-server", daemon=True
        )
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._shutdown:
            try:
                conn = self._listener.accept()
            except Exception:  # noqa: BLE001 - auth failures, fd exhaustion
                if self._shutdown:
                    return
                # don't hot-spin on a persistent accept error (e.g. EMFILE)
                time.sleep(0.05)
                continue
            threading.Thread(
                target=self._serve, args=(conn,), name="data-serve", daemon=True
            ).start()

    def _serve(self, conn) -> None:
        from ray_tpu_torch._private.shm_store import ShmReader

        try:
            try:
                authenticate(conn, self._authkey)
            except Exception:  # noqa: BLE001 - a silent, slow or wrong client: drop it
                return
            while True:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    return
                if msg[0] == "stat":
                    # liveness probe: does this host still hold the object?
                    # (head uses it to verify a report_lost before freeing)
                    try:
                        ShmReader(msg[1]).close()
                        conn.send(("ok_stat", True))
                    except FileNotFoundError:
                        conn.send(("ok_stat", False))
                    continue
                if msg[0] != "fetch":
                    conn.send(("err", f"unknown request {msg[0]!r}"))
                    continue
                loc = msg[1]
                try:
                    reader = ShmReader(loc)
                except FileNotFoundError as e:
                    conn.send(("gone", str(e)))
                    continue
                try:
                    mv = reader._mv()
                    total = loc.total_size
                    conn.send(("ok", total))
                    off = 0
                    chunk = _chunk_bytes()
                    while off < total:
                        n = min(chunk, total - off)
                        conn.send_bytes(mv[off : off + n])
                        off += n
                    self.bytes_served += total
                    events.emit(
                        "core.object.p2p_pull",
                        size=total,
                        seg=loc.name,
                        role="serve",
                    )
                finally:
                    reader.close()
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def shutdown(self) -> None:
        self._shutdown = True
        try:
            self._listener.close()
        except OSError:
            pass


class _Pool:
    """Per-address client connection pool (one cached conn per (addr, thread)
    would over-connect; a small free-list with a lock is plenty — fetches are
    bulk transfers, not latency-bound RPCs)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: dict[tuple, list] = {}

    def take(self, address: tuple, authkey: bytes):
        with self._lock:
            conns = self._free.get(address)
            if conns:
                return conns.pop()
        return Client(address, authkey=authkey)

    def give(self, address: tuple, conn) -> None:
        with self._lock:
            self._free.setdefault(address, []).append(conn)

    def clear(self) -> None:
        with self._lock:
            for conns in self._free.values():
                for c in conns:
                    try:
                        c.close()
                    except OSError:
                        pass
            self._free.clear()


_pool = _Pool()


class ObjectGone(Exception):
    """The owning host no longer has the object (freed/spilled/evicted)."""


def fetch(address: tuple[str, int], authkey: bytes, loc) -> memoryview:
    """Pull one object's laid-out bytes from its owning host.

    Returns a memoryview over a freshly received buffer in the shm layout
    ([header][buf0][buf1...], see shm_store._layout) — deserialize with
    ``read_layout``. Raises ObjectGone when the owner dropped it, OSError
    when the host is unreachable.
    """
    conn = _pool.take(address, authkey)
    ok = False
    try:
        conn.send(("fetch", loc))
        resp = conn.recv()
        if resp[0] == "gone":
            ok = True  # connection still healthy — pool it
            raise ObjectGone(resp[1])
        if resp[0] == "err":
            # the server's explicit error reply (unknown request): the
            # connection is still healthy and carries the reason — name
            # the kind instead of folding it into the catch-all below
            # (raylint RL019: every sent kind has a named handler)
            ok = True
            raise OSError(f"data server error: {resp[1]}")
        if resp[0] != "ok":
            raise OSError(f"data server error: {resp!r}")
        total = resp[1]
        buf = bytearray(total)
        mv = memoryview(buf)
        off = 0
        while off < total:
            n = conn.recv_bytes_into(mv[off:])
            off += n
        ok = True
        return mv
    finally:
        if ok:
            _pool.give(address, conn)
        else:
            try:
                conn.close()
            except OSError:
                pass


def read_layout(mv: memoryview, loc):
    """Deserialize a value from fetched layout bytes (zero further copies:
    out-of-band buffers are views into ``mv``)."""
    import pickle

    from ray_tpu_torch._private.shm_store import layout_views

    header, bufs = layout_views(mv, loc.header_len, loc.buffer_lens)
    return pickle.loads(header, buffers=bufs)


def stat(address: tuple[str, int], authkey: bytes, loc) -> Optional[bool]:
    """Ask the owning host whether it still holds ``loc``. True/False from
    the server; None when the host is unreachable (let node-death handling
    decide — do NOT treat unreachable as gone)."""
    try:
        conn = _pool.take(address, authkey)
    except OSError:
        return None
    ok = False
    try:
        conn.send(("stat", loc))
        resp = conn.recv()
        ok = True
        return bool(resp[1]) if resp[0] == "ok_stat" else None
    except (OSError, EOFError):
        return None
    finally:
        if ok:
            _pool.give(address, conn)
        else:
            try:
                conn.close()
            except OSError:
                pass


def shutdown_pool() -> None:
    _pool.clear()
