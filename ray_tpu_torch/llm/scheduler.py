"""Continuous-batching scheduler: request lifecycle + slot/block policy
(copy of ``ray_tpu/llm/scheduler.py``).

The engine has a FIXED number of decode slots; the scheduler keeps them
full:

* **admission** — FIFO: a waiting request takes a free slot when the pool
  can cover its prompt plus one generated block. Admission is CACHE-AWARE
  (``llm.prefix_cache``): the longest cached prefix is matched, its blocks are shared into the new table, only the
  uncached suffix is charged to chunked prefill (``prefill_pos`` starts at
  the match), and an intra-block divergence queues a copy-on-write fork
  (``pending_cow``) the engine applies before the first prefill chunk.
* **cache eviction before preemption** — when the pool is dry, capacity
  held only by the prefix tree is reclaimed LRU-first; live requests are
  preempted only when the cache has nothing left to give.
* **chunked prefill** — an admitted request prefills ``prefill_chunk``
  pieces, one per engine step, interleaved with decode for the running
  slots.
* **preemption** — when a running sequence needs a block and the pool is
  dry, the YOUNGEST running request is evicted: blocks freed, request
  requeued at the FRONT of the waiting queue, its generated tokens
  replayed by re-prefill on re-admission (recompute-style).

Observability, as in the reference: every request carries its trace id
and a phase ledger (``util.phases``) that admission, preemption and finish
charge; ``llm.admit``, ``llm.preempt`` and ``llm.finish`` go to the flight
recorder (``_private.events``).

All state transitions happen under the engine's lock; this module holds
no thread of its own.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from collections import deque
from typing import Optional

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.llm.cache import KVBlockPool
from ray_tpu_torch.llm.prefix_cache import PrefixCache
from ray_tpu_torch.util import phases as _phases
from ray_tpu_torch.util import tracing as _tracing

_req_counter = itertools.count()

# request states
WAITING = "waiting"
PREFILL = "prefill"     # owns a slot + blocks; prompt partially processed
RUNNING = "running"     # decode steps produce tokens
FINISHED = "finished"

# finish reasons
FINISH_LENGTH = "length"
FINISH_STOP = "stop"
FINISH_CANCELLED = "cancelled"
FINISH_DEADLINE = "deadline"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (see ``models.sampling``).
    ``temperature <= 0`` is greedy; ``stop_token_ids`` ends generation
    AFTER emitting a listed token (the stop token is included in the
    output, HF-eos style)."""

    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_token_ids: tuple = ()
    seed: int = 0


class Request:
    """One generation request; carries its own stream queue so a consumer
    thread can iterate tokens while the engine thread steps.

    ``resume_tokens``: tokens a previous engine already generated and
    delivered for this request. They pre-fold into ``out`` exactly like a
    preemption's recompute — the re-prefill replays prompt + out, and
    generation continues at output index ``len(out)`` with the same
    per-index sampling keys, token-identical to the uninterrupted run.
    Only NEW tokens are streamed; the resumed prefix counts toward
    ``max_tokens``."""

    def __init__(
        self,
        prompt: list[int],
        params: SamplingParams,
        deadline: Optional[float] = None,  # absolute time.time() cutoff
        resume_tokens: tuple = (),
    ):
        if not prompt:
            raise ValueError("prompt must contain at least one token")
        self.id = f"req-{next(_req_counter)}"
        # end-to-end correlation id: the submitting thread's trace context
        # (set via tracing.trace_context); falls back to the engine-local id
        # so every request is traceable either way
        self.trace_id = _tracing.current_request_id() or self.id
        self.prompt = list(prompt)
        self.params = params
        self.deadline = deadline
        self.arrival_t = time.time()
        self.state = WAITING
        self.finish_reason: Optional[str] = None
        self.out: list[int] = [int(t) for t in resume_tokens]
        # behavior logprob of out[i] (models.sampling convention), aligned
        # 1:1 with ``out``; resumed tokens were sampled elsewhere — NaN
        self.out_logprobs: list[float] = [float("nan")] * len(self.out)
        # engine weights_version at submit (staleness accounting for
        # learner-to-engine weight sync; None until the engine stamps it)
        self.weights_version: Optional[int] = None
        self.resumed_from = len(self.out)  # output index generation restarts at
        self.prefill_pos = 0          # prompt tokens already in the cache
        # prefix-cache flush epoch at admission: a weight swap mid-prefill
        # bumps the cache's epoch, and this request's (partly old-weight)
        # blocks then must not enter the tree (prefix_cache.insert)
        self.cache_epoch = 0
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        # phase-attribution ledger (util.phases): cursor + per-phase
        # accumulators, anchored at submit. A resumed request gets a FRESH
        # ledger — only THIS attempt's time is attributed. None when
        # RAY_TPU_PHASES=0.
        self.phase_led: Optional[list] = (
            _phases.new_ledger(self.arrival_t) if _phases.enabled() else None
        )
        # True from preemption until the recompute's prefill completes:
        # queue/admit/prefill charges reroute to the `preempt` phase so
        # recompute cost is attributed, not lumped into first-time phases
        self.phase_recompute = False
        # cross-process dispatch leg (engine submit − dispatch anchor),
        # stamped by phases.note_dispatch when the trace context carries it
        self.phase_dispatch_s: Optional[float] = None
        self.cancelled = threading.Event()
        # stream events: ("token", id) ... ("done", reason)
        self.stream: queue.SimpleQueue = queue.SimpleQueue()

    @property
    def seq_len(self) -> int:
        """Tokens currently in (or destined for) the cache."""
        return len(self.prompt) + len(self.out)

    @property
    def finished(self) -> bool:
        return self.state == FINISHED


class Scheduler:
    """Slot + block bookkeeping. NOT thread-safe on its own — the engine
    serializes access under its step lock."""

    def __init__(self, pool: KVBlockPool, max_slots: int, prefix_cache: PrefixCache):
        self.pool = pool
        self.max_slots = max_slots
        self.prefix_cache = prefix_cache
        self.waiting: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * max_slots
        self._admit_seq = itertools.count()
        self._admitted_at: dict[str, int] = {}  # request id -> admission tick
        self.preempt_count = 0
        self.finish_count = 0  # lifetime finishes (engine rates this per step)
        # copy-on-write forks queued by cache-aware admission:
        # (src_block, dst_block, request_id) — the engine drains these
        # right after admit() (same lock, same step), device-copying
        # src→dst before any prefill chunk reads the forked block
        self.pending_cow: list[tuple[int, int, str]] = []

    # -- queries -----------------------------------------------------------

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def running(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def num_running(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.num_running > 0

    # -- lifecycle ---------------------------------------------------------

    def add(self, req: Request) -> None:
        self.waiting.append(req)

    def admit(self) -> list[Request]:
        """Move waiting → slots while a slot is free and the pool can cover
        prompt + one generation block. Returns the newly admitted.

        The longest cached prefix of the replay sequence (prompt + already-generated tokens) is shared into the
        table and ``prefill_pos`` starts past it; a pool shortfall first
        reclaims cache-only blocks (LRU), protecting the blocks this very
        admission is about to share."""
        admitted = []
        while self.waiting:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                break
            req = self.waiting[0]
            if req.phase_led is not None:
                # close the queue leg HERE so the admission work that
                # follows (prefix match, evict-to-fit, allocate, install)
                # lands in `admit`; a failed attempt (break below) merges
                # back into queue at the next inspection
                _phases.charge(
                    req.phase_led,
                    _phases.PREEMPT if req.phase_recompute else _phases.QUEUE,
                    time.time(),
                )
            # prompt (+ recomputed tokens after preempt) + one generation
            # block of headroom, capped at the table width
            need_tokens = min(req.seq_len + self.pool.cfg.block_size, self.pool.cfg.max_seq_len)
            match = self.prefix_cache.match(req.prompt + req.out)
            shared = list(match.blocks)
            if not self.pool.can_allocate(need_tokens, shared=len(shared)):
                # reclaim cache-only residents before declaring pressure;
                # the matched blocks (and CoW source) must survive the sweep
                deficit = (
                    self.pool.blocks_for(need_tokens) - len(shared) - self.pool.num_free_blocks
                )
                if deficit > 0:
                    protect = set(shared)
                    if match.cow_src is not None:
                        protect.add(match.cow_src)
                    self.prefix_cache.evict(deficit, protect=frozenset(protect))
                if not self.pool.can_allocate(need_tokens, shared=len(shared)):
                    break  # FIFO head blocked on memory: don't starve it
            self.waiting.popleft()
            slot = free[0]
            blocks = self.pool.allocate(req.id, need_tokens, shared=shared)
            try:
                self.slots[slot] = req
                req.state = PREFILL
                req.prefill_pos = match.matched
                req.cache_epoch = self.prefix_cache.epoch
                if match.cow_src is not None:
                    # the forked block sits right after the shared prefix;
                    # its first cow_tokens positions become valid at copy time
                    self.pending_cow.append((match.cow_src, blocks[len(shared)], req.id))
                self.prefix_cache.record(req, match, len(req.prompt) + len(req.out))
                self._admitted_at[req.id] = next(self._admit_seq)
            except BaseException:
                # an admission that fails after taking blocks must not
                # leave them owned by a request in no slot and no queue:
                # roll the whole admission back and let the error surface
                self.slots[slot] = None
                self.pool.free(req.id)
                self._admitted_at.pop(req.id, None)
                self._drop_pending_cow(req.id)
                req.state = WAITING
                req.prefill_pos = 0
                self.waiting.appendleft(req)
                raise
            if req.phase_led is not None:
                _phases.charge(
                    req.phase_led,
                    _phases.PREEMPT if req.phase_recompute else _phases.ADMIT,
                    time.time(),
                )
            admitted.append(req)
            _events.record(
                "llm.admit", request_id=req.trace_id, engine_req=req.id,
                slot=slot, seq_len=req.seq_len,
                cached_tokens=req.prefill_pos,
                wait_s=round(time.time() - req.arrival_t, 6),
            )
        return admitted

    def grow_for_decode(self, req: Request, extra: int = 0) -> bool:
        """Ensure the positions the next step writes have cache slots,
        preempting younger requests if the pool is dry. Returns False when
        ``req`` itself had to be preempted (nobody younger to evict)."""
        target = min(req.seq_len + extra, self.pool.cfg.max_seq_len)
        while not self.pool.grow_to(req.id, target):
            # cheapest capacity first: cached blocks nobody is running on
            if self.prefix_cache.evict(1) > 0:
                continue
            victim = self._youngest_running(exclude=req.id)
            if victim is None:
                self.preempt(req)
                return False
            self.preempt(victim)
        return True

    def _youngest_running(self, exclude: str) -> Optional[Request]:
        cands = [r for r in self.slots if r is not None and r.id != exclude]
        if not cands:
            return None
        return max(cands, key=lambda r: self._admitted_at.get(r.id, -1))

    def preempt(self, req: Request) -> None:
        """Evict a running/prefilling request: free its blocks and requeue
        it at the FRONT of the waiting queue. ``req.out`` is untouched —
        the re-prefill replays prompt + out, then generation continues."""
        slot = self._slot_of(req)
        if slot is not None:
            self.slots[slot] = None
        self.pool.free(req.id)
        self._admitted_at.pop(req.id, None)
        self._drop_pending_cow(req.id)
        self.preempt_count += 1
        if req.phase_led is not None:
            # the evicted step's partial work is lost to the recompute —
            # charge it to `preempt` and reroute everything until the
            # re-prefill completes (the engine clears the flag at RUNNING)
            _phases.charge(req.phase_led, _phases.PREEMPT, time.time())
            req.phase_recompute = True
        req.prefill_pos = 0
        req.state = WAITING
        self.waiting.appendleft(req)
        _events.record(
            "llm.preempt", request_id=req.trace_id, engine_req=req.id,
            tokens_out=len(req.out), recompute_len=req.seq_len,
        )

    def finish(self, req: Request, reason: str) -> None:
        if req.phase_led is not None:
            # tail charge: attribute the interval since the last stamp by
            # what the request was doing, then fold — Σ phases now equals
            # finish − submit exactly
            now = time.time()
            if req.phase_recompute:
                idx = _phases.PREEMPT
            elif req.state == RUNNING:
                idx = _phases.DECODE
            elif req.state == PREFILL:
                idx = _phases.PREFILL
            else:
                idx = _phases.QUEUE
            _phases.charge(req.phase_led, idx, now)
            _phases.fold_engine(req, now, reason)
        slot = self._slot_of(req)
        if slot is not None:
            self.slots[slot] = None
        try:
            self.waiting.remove(req)
        except ValueError:
            pass
        self.pool.free(req.id)
        self._admitted_at.pop(req.id, None)
        self._drop_pending_cow(req.id)
        req.state = FINISHED
        req.finish_reason = reason
        self.finish_count += 1
        _events.record(
            "llm.finish", request_id=req.trace_id, engine_req=req.id,
            reason=reason, tokens_out=len(req.out),
            dur_s=round(time.time() - req.arrival_t, 6),
        )
        req.stream.put(("done", reason))

    def _drop_pending_cow(self, req_id: str) -> None:
        """A request leaving its slot before the engine drained its fork:
        the dst block just went back to the pool, the copy must not happen."""
        if self.pending_cow:
            self.pending_cow = [c for c in self.pending_cow if c[2] != req_id]

    def _slot_of(self, req: Request) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is not None and r.id == req.id:
                return i
        return None
