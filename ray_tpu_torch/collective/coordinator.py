"""Rendezvous + host-side collective coordinator, EVENT-driven (copy of
``ray_tpu/collective/coordinator.py``).

The reference rendezvouses NCCL communicators through a named actor holding
the unique id (``util/collective/collective_group/nccl_collective_group.py:
28-77`` NCCLUniqueIDStore) and moves host-side payloads over gloo
(``gloo_collective_group.py``). Host-side collectives here flow through
this named ASYNC actor; device tensors reduce over a device mesh instead
(``collective.mesh_allreduce``, ``ray_tpu_torch.parallel``).

Round 2 had members busy-polling ``try_*`` methods every 2ms and funneling
every byte through the coordinator. Now:

* every operation is one BLOCKING call on an asyncio actor — the awaiting
  side parks on an ``asyncio.Event`` and is woken by the arriving peer
  (pushed notification, zero polling anywhere);
* small payloads ride the call itself; bulk payloads travel as ObjectRefs
  whose bytes move peer-to-peer through the object plane (shm locally, the
  data plane across hosts) — the coordinator shuttles only refs, so no
  single process handles O(world) bytes (see collective._ring_allreduce).
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional


class CollectiveCoordinator:
    """Async state machine for one collective group's host-side ops.

    Runs on the asyncio actor engine (single loop thread): state mutations
    are loop-serialized, waits are real ``asyncio.Event`` parks."""

    def __init__(self, group_name: str, world_size: int):
        self.group_name = group_name
        self.world_size = world_size
        self.joined: set[int] = set()
        # (kind, seq) -> {"parts": {rank: payload}, "result": Any,
        #                 "taken": set, "event": asyncio.Event}
        self.slots: dict[tuple, dict] = {}
        # arbitrary-key mailboxes: key -> payload, with a waker per key
        self.mail: dict[tuple, Any] = {}
        self._mail_events: dict[tuple, asyncio.Event] = {}
        # keys whose taker timed out: a late put is dropped, not stored
        self._mail_dead: set[tuple] = set()

    async def join(self, rank: int) -> int:
        self.joined.add(rank)
        return self.world_size

    async def ready(self) -> bool:
        return len(self.joined) >= self.world_size

    # ------------------------------------------------------------- fan-in ops

    def _slot(self, key: tuple) -> dict:
        s = self.slots.get(key)
        if s is None:
            s = self.slots[key] = {
                "parts": {},
                "result": None,
                "taken": set(),
                "event": asyncio.Event(),
            }
        return s

    async def collect(
        self, kind: str, seq: int, rank: int, payload, op: Optional[str] = None,
        timeout: float = 60.0,
    ):
        """Contribute this rank's part and block until every rank has
        contributed; returns the combined result. The last arriver computes
        the result once and wakes the rest."""
        key = (kind, seq)
        s = self._slot(key)
        s["parts"][rank] = payload
        if len(s["parts"]) >= self.world_size:
            s["result"] = self._reduce(kind, s["parts"], op)
            s["event"].set()
        else:
            try:
                await asyncio.wait_for(s["event"].wait(), timeout=timeout)
            except asyncio.TimeoutError:
                # withdraw: this rank won't take the result, and a slot of
                # orphaned payloads must not outlive the op on a DETACHED
                # actor (it would leak for the life of the cluster)
                s["parts"].pop(rank, None)
                if not s["parts"]:
                    self.slots.pop(key, None)
                raise
        s["taken"].add(rank)
        result = s["result"]
        if len(s["taken"]) >= self.world_size:
            del self.slots[key]
        return result

    def _reduce(self, kind: str, parts: dict[int, Any], op: Optional[str]):
        from ray_tpu_torch.collective.types import ReduceOp

        ordered = [parts[r] for r in range(self.world_size)]
        if kind == "allgather":
            return ordered
        if kind in ("barrier", "ring_done"):
            return True
        if kind in ("allreduce", "reducescatter"):
            rop = ReduceOp(op or "sum")
            acc = ordered[0]
            for p in ordered[1:]:
                acc = rop.combine(acc, p)
            if kind == "reducescatter":
                import numpy as np

                return np.array_split(np.asarray(acc), self.world_size)
            return acc
        raise ValueError(f"unknown collective kind {kind!r}")

    # ------------------------------------------------------------- mailboxes

    def _mail_event(self, key: tuple) -> asyncio.Event:
        ev = self._mail_events.get(key)
        if ev is None:
            ev = self._mail_events[key] = asyncio.Event()
        return ev

    async def mail_put(self, key: tuple, payload) -> None:
        key = tuple(key)
        if key in self._mail_dead:
            # the taker already timed out and tombstoned this key: drop the
            # payload, or it (and any ObjectRef it pins) would leak on the
            # detached actor forever
            self._mail_dead.discard(key)
            return
        self.mail[key] = payload
        self._mail_event(key).set()

    async def mail_take(self, key: tuple, timeout: float = 60.0):
        key = tuple(key)
        try:
            await asyncio.wait_for(self._mail_event(key).wait(), timeout=timeout)
        except asyncio.TimeoutError:
            # nobody will ever take this mailbox: drop the event, drop any
            # payload that landed in the race, and tombstone the key so a
            # LATE put is discarded instead of recreating the entry
            self._mail_events.pop(key, None)
            self.mail.pop(key, None)
            self._mail_dead.add(key)
            while len(self._mail_dead) > 4096:
                self._mail_dead.pop()
            raise
        self._mail_events.pop(key, None)
        return self.mail.pop(key)

    # ----------------------------------------------------------- broadcast

    async def bcast(self, seq: int, rank: int, src: int, payload=None,
                    timeout: float = 60.0):
        key = ("broadcast", seq)
        s = self._slot(key)
        if rank == src:
            s["result"] = payload
            s["event"].set()
            taken_target = self.world_size - 1  # root doesn't fetch
            if len(s["taken"]) >= taken_target:
                del self.slots[key]
            return None
        try:
            await asyncio.wait_for(s["event"].wait(), timeout=timeout)
        except asyncio.TimeoutError:
            s["taken"].add(rank)  # won't fetch; let the slot drain
            if len(s["taken"]) >= self.world_size - 1:
                self.slots.pop(key, None)
            raise
        s["taken"].add(rank)
        result = s["result"]
        if len(s["taken"]) >= self.world_size - 1:
            self.slots.pop(key, None)
        return result

    # -------------------------------------------------------- point-to-point

    async def p2p_put(self, src: int, dst: int, seq: int, payload) -> None:
        await self.mail_put(("p2p", src, dst, seq), payload)

    async def p2p_get(self, src: int, dst: int, seq: int, timeout: float = 60.0):
        return await self.mail_take(("p2p", src, dst, seq), timeout=timeout)
