"""LLMEngine: the continuous-batching step loop (port of
``ray_tpu/llm/engine.py``).

One engine owns one GPT or GPT-J model, one paged KV pool on one device,
and one scheduler. ``step()`` is the whole design:

1. reap cancellations and blown deadlines;
2. admit waiting requests into free decode slots (FIFO, memory-gated, and
   — with the prefix cache on — CACHE-AWARE: the longest cached prefix is
   shared into the new block table, LRU cache eviction runs before anyone
   is preempted, and queued copy-on-write forks are applied as one block
   copy);
3. run ONE chunked-prefill piece for the oldest still-prefilling
   admission; completed prompt blocks enter the prefix tree as they fill;
4. run ONE batched decode step across every running slot, sample per-slot
   tokens (per-request temperature/top-k/top-p/seed), stream them out,
   finish requests that hit ``max_tokens``/stop tokens, preempting the
   youngest when the block pool runs dry. With ``spec_k > 0`` the decode
   step is speculative: a drafter proposes ``spec_k`` tokens per slot, ONE
   verify call (``model_runner.verify_step``) scores all ``spec_k + 1``
   window positions, and each slot emits its accepted prefix plus one
   correction/bonus token — greedy output stays token-identical to plain
   decode.

Threading: ``step()`` serializes on an internal lock — any number of
submitter threads can feed the engine while one loop thread
(``run_loop``) turns the crank, and ``update_weights`` hot-swaps the
parameters between two steps without draining in-flight requests.

Not ported yet (ROADMAP.md): tensor parallelism (``tp > 1``), overload
shedding, the watchdog, and the metrics/events/phase/tracing hooks (the
speculative path's included).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.llm.cache import CacheConfig, KVBlockPool
from ray_tpu_torch.llm.drafter import make_drafter
from ray_tpu_torch.llm.model_runner import PagedModelRunner, _row_noise, _sample_rows
from ray_tpu_torch.llm.prefix_cache import PrefixCache
from ray_tpu_torch.llm.scheduler import (
    FINISH_CANCELLED,
    FINISH_DEADLINE,
    FINISH_LENGTH,
    FINISH_STOP,
    FINISHED,
    PREFILL,
    RUNNING,
    Request,
    SamplingParams,
    Scheduler,
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine geometry. ``num_blocks`` includes the reserved trash block;
    ``max_blocks_per_seq * block_size`` caps a sequence (prompt + output).

    Decode and verify attention run the CUDA kernels on the card and their
    plain versions on the CPU (``ops.paged_attention``). The prefix cache is
    always on: KV blocks are shared across requests through a radix tree
    over block contents. ``tp`` exists so a reference configuration is
    refused loudly: only 1 is ported.

    Speculative decoding: ``spec_k > 0`` turns it on — each step a drafter
    proposes ``spec_k`` tokens per running slot and the target model
    verifies all of them plus a bonus position in ONE call (``llm.drafter``
    module doc). ``spec_drafter`` is ``"ngram"`` (model-free prompt lookup;
    ``NGRAM_MAX`` caps the matched n-gram) or ``"model"`` (a small draft
    model passed to ``LLMEngine`` as ``draft_model_cfg``/``draft_params``;
    ``spec_draft_ctx`` fixes its context window). Greedy output is
    token-identical either way. Adversarial (low-acceptance) workloads are
    bounded by backoff: when a verify step accepts less than ``MIN_ACCEPT``
    of its drafts, the engine plain-decodes for exponentially more steps
    (doubling up to ``BACKOFF_MAX``) before probing speculation again."""

    max_slots: int = 4
    num_blocks: int = 128
    block_size: int = 16
    max_blocks_per_seq: int = 32
    prefill_chunk: int = 32
    tp: int = 1
    spec_k: int = 0
    spec_drafter: str = "ngram"
    spec_draft_ctx: int = 16


# Speculation constants, the reference's EngineConfig defaults: the longest
# n-gram the drafter matches, the acceptance share below which the engine
# backs off to plain decode, and the longest backoff in plain-decode steps.
NGRAM_MAX = 3
MIN_ACCEPT = 0.3
BACKOFF_MAX = 32


class LLMEngine:
    def __init__(
        self,
        model_cfg,
        params,
        engine_cfg: Optional[EngineConfig] = None,
        draft_model_cfg=None,
        draft_params=None,
        device=None,
    ):
        self.cfg = engine_cfg or EngineConfig()
        if self.cfg.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if self.cfg.tp > 1:
            raise NotImplementedError(
                "tensor parallelism (tp > 1) is not ported yet: ROADMAP.md, queue A"
            )
        self.device = resolve_device(device)
        pdev = params.lm_head.weight.device
        if pdev != self.device:
            raise ValueError(f"params are on {pdev}, the engine runs on {self.device}")
        self.model_cfg = model_cfg
        cache_cfg = CacheConfig(
            num_blocks=self.cfg.num_blocks,
            block_size=self.cfg.block_size,
            max_blocks_per_seq=self.cfg.max_blocks_per_seq,
        )
        self.runner = PagedModelRunner(model_cfg, params, self.cfg.block_size)
        self.pool = KVBlockPool(
            cache_cfg,
            n_layers=model_cfg.n_layers,
            n_heads=model_cfg.n_heads,
            head_dim=model_cfg.head_dim,
            dtype=model_cfg.torch_dtype,
            device=self.device,
        )
        self.prefix_cache = PrefixCache(self.pool)
        self.scheduler = Scheduler(self.pool, self.cfg.max_slots, prefix_cache=self.prefix_cache)
        self._drafter = None
        if self.cfg.spec_k > 0:
            self._drafter = make_drafter(
                self.cfg.spec_drafter,
                self.cfg.spec_k,
                self.cfg.max_slots,
                ngram_max=NGRAM_MAX,
                draft_cfg=draft_model_cfg,
                draft_params=draft_params,
                draft_ctx=self.cfg.spec_draft_ctx,
            )
            # prefix-aware drafting: the n-gram drafter extends its lookup
            # past the local context into the shared radix paths (drafts
            # affect throughput only; verification keeps output exact)
            if hasattr(self._drafter, "corpus"):
                self._drafter.corpus = self.prefix_cache.paths
        self._lock = threading.Lock()
        self._requests: dict[str, Request] = {}
        self._step_n = 0
        self._tokens_generated = 0
        self._prefill_tokens = 0
        self._preemptions = 0
        self._decode_steps = 0
        self._decode_s = 0.0  # wall time of decode steps, host sync included
        self._verify_steps = 0
        self._verify_s = 0.0  # wall time of verify steps, host sync included
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_emitted = 0  # tokens emitted by verify steps
        self._spec_draft_s = 0.0
        self._spec_skip = 0  # plain-decode steps left before re-probing
        self._spec_backoff = 0  # current backoff length (0 = speculating)
        # liveness beat, read LOCK-FREE by ``progress`` (a wedged step holds
        # the engine lock, so an observer must never need it): (monotonic t
        # of the last completed step — idle ticks count, a wedge does not —,
        # pending work then). One-tuple assignment keeps the read torn-free
        # under the GIL.
        self._beat: tuple[float, int] = (time.monotonic(), 0)
        # learner-to-engine weight sync: monotonic version of the parameters
        # the steps currently read; update_weights swaps them between steps
        # and every submit stamps the version onto its Request
        self._weights_version = 0
        # model-length cap: the paged table width, and the learned
        # positional table for GPT (rotary GPT-J has no absolute cap of its
        # own)
        self.max_model_len = cache_cfg.max_seq_len
        if self.runner.arch == "gpt":
            self.max_model_len = min(self.max_model_len, model_cfg.seq_len)

    # -- public API --------------------------------------------------------

    def submit(
        self,
        prompt: list[int],
        params: Optional[SamplingParams] = None,
        deadline_s: Optional[float] = None,
        resume_tokens: tuple = (),
    ) -> Request:
        """Queue a request; returns immediately (drive with ``step()`` or
        ``run_loop``; consume with ``stream_tokens``).

        ``resume_tokens`` — tokens an earlier engine already generated for
        this request: the cache is rebuilt by re-prefilling prompt +
        resumed tokens, generation continues at output index
        ``len(resume_tokens)`` with the same per-index sampling keys, and
        only NEW tokens are streamed. ``deadline_s`` — seconds from now
        after which the request is reaped with finish reason "deadline"."""
        params = params or SamplingParams()
        if params.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if deadline_s is not None and not math.isfinite(deadline_s):
            # a non-finite deadline would make every "now >= deadline" check
            # False forever
            raise ValueError(f"deadline_s must be finite, got {deadline_s}")
        if len(resume_tokens) > params.max_tokens:
            raise ValueError(
                f"resume_tokens ({len(resume_tokens)}) exceeds max_tokens ({params.max_tokens})"
            )
        total = len(prompt) + params.max_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_tokens ({params.max_tokens}) "
                f"exceeds max model length {self.max_model_len}"
            )
        # the request must be able to COMPLETE with the pool to itself —
        # admission's worst case is a re-admission one token before the end
        # plus one block of headroom (or, speculating, plus the window's k
        # provisional positions); an oversized request would otherwise pass
        # validation, never be admitted, and livelock the FIFO head
        headroom = max(self.pool.cfg.block_size, self.cfg.spec_k)
        worst = min(total - 1 + headroom, self.pool.cfg.max_seq_len)
        usable = self.pool.cfg.num_blocks - 1
        if self.pool.blocks_for(worst) > usable:
            raise ValueError(
                f"request needs up to {self.pool.blocks_for(worst)} KV blocks "
                f"but the pool has only {usable} usable blocks "
                f"(num_blocks={self.pool.cfg.num_blocks}, block 0 reserved)"
            )
        deadline = time.time() + deadline_s if deadline_s is not None else None
        req = Request(prompt, params, deadline=deadline, resume_tokens=resume_tokens)
        # staleness stamp: the weights version this request STARTS under (a
        # swap mid-generation is fine — per-token behavior logprobs stay
        # exact either way)
        req.weights_version = self._weights_version
        # a resume that already satisfies its stopping condition finishes
        # without touching the scheduler (the earlier engine died between
        # delivering the final token and the stream's "done")
        done_reason = None
        if req.out and req.out[-1] in params.stop_token_ids:
            done_reason = FINISH_STOP
        elif len(req.out) >= params.max_tokens:
            done_reason = FINISH_LENGTH
        if done_reason is not None:
            req.state = FINISHED
            req.finish_reason = done_reason
            req.stream.put(("done", done_reason))
            return req
        with self._lock:
            # re-stamp under the lock: a swap that landed between the
            # Request's construction and here is the version it decodes under
            req.weights_version = self._weights_version
            self._requests[req.id] = req
            self.scheduler.add(req)
            # liveness beat: raise the pending count, and if the engine was
            # idle until now restart the age clock — the age must measure
            # how long work waited, not how long the engine idled before it
            t, prev_pending = self._beat
            self._beat = (
                time.monotonic() if prev_pending == 0 else t,
                self.scheduler.num_running + self.scheduler.num_waiting,
            )
        return req

    def cancel(self, req_id: str) -> bool:
        """Flag a request for cancellation; the next step reaps it."""
        req = self._requests.get(req_id)
        if req is None:
            return False
        req.cancelled.set()
        return True

    def has_work(self) -> bool:
        with self._lock:
            return self.scheduler.has_work()

    def progress(self) -> tuple[float, int]:
        """(seconds since the last completed step tick, pending work at that
        tick) — lock-free, safe to call while a step is wedged."""
        t, pending = self._beat
        return time.monotonic() - t, pending

    @property
    def weights_version(self) -> int:
        """Version of the parameters the engine currently decodes with."""
        return self._weights_version

    def update_weights(self, params, version: Optional[int] = None) -> int:
        """Hot-swap the model parameters between two ``step()`` calls
        WITHOUT draining in-flight requests (the learner-to-engine weight
        sync of RLHF rollouts).

        ``params`` is a module like the engine's (``GPT`` or ``GPTJ``, on
        any device): the same parameter names, shapes and dtypes, or
        ``ValueError``. Each new value is written INTO the existing
        parameter storage with ``copy_``, under the engine lock, on the
        current stream (the steps' stream: the engine never switches
        streams), so the next step reads it; no tensor is rebound, so
        nothing that captured the storage can keep stale weights. In-flight
        requests continue under the new weights from their next step (their
        per-token behavior logprobs were captured at sample time). The
        prefix cache is flushed: its k/v was computed under the old weights.

        ``version`` must not go backwards (default: current + 1). Returns
        the installed version."""
        new = params.state_dict()
        with self._lock:
            old = self.runner.params.state_dict(keep_vars=True)
            if list(new) != list(old):
                raise ValueError(
                    f"update_weights parameter structure mismatch: {list(new)} != {list(old)}"
                )
            for name, dst in old.items():
                src = new[name]
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError(
                        f"update_weights mismatch at {name}: {tuple(src.shape)}/{src.dtype} != "
                        f"{tuple(dst.shape)}/{dst.dtype}"
                    )
            if version is None:
                version = self._weights_version + 1
            if version < self._weights_version:
                raise ValueError(
                    f"weights_version must not go backwards: {version} < {self._weights_version}"
                )
            with torch.no_grad():
                for name, dst in old.items():
                    dst.copy_(new[name])
            self._weights_version = version
            # cached prefix KV was computed under the OLD weights: no new
            # request may seed from it (in-flight requests keep their own
            # references, and their epoch stamp keeps a prefill that
            # straddled the swap out of the tree)
            self.prefix_cache.flush(reason="weights_update")
        return version

    def stream_tokens(self, req: Request, timeout: float = 60.0) -> Iterator[int]:
        """Yield the request's tokens as the engine produces them; raises
        ``TimeoutError`` when no event arrives within ``timeout`` seconds."""
        import queue as _q

        while True:
            try:
                kind, val = req.stream.get(timeout=timeout)
            except _q.Empty:
                raise TimeoutError(
                    f"no token from {req.id} within {timeout}s (state={req.state}, "
                    f"{len(req.out)} tokens so far)"
                ) from None
            if kind == "token":
                yield val
            else:
                return

    def generate(
        self,
        prompt: list[int],
        params: Optional[SamplingParams] = None,
        deadline_s: Optional[float] = None,
    ) -> list[int]:
        """Blocking convenience: submit and drive until finished. Safe to
        call while a loop thread is also stepping (steps serialize)."""
        req = self.submit(prompt, params, deadline_s)
        while not req.finished:
            if not self.step():
                time.sleep(0.001)
        return list(req.out)

    def warmup(self) -> None:
        """Drive every step path once — prefill, decode, the block fork
        (trash block onto itself) and, speculating, verify — so kernels are
        built and libraries initialized before the first real request. A
        speculating engine decodes through ``verify_step`` whenever its
        drafter is confident, so the plain decode path (the gate's and the
        backoff's) is driven with the backoff forced on, and ``verify_step``
        directly on a dummy batch: whether a generate ever verifies depends
        on the drafter finding a match in the warmup output. The dummy
        batch's all-zero block tables send every provisional write to the
        reserved trash block — real pool contents are untouched."""
        self.generate([0], SamplingParams(max_tokens=2))
        with self._lock:
            z = np.zeros(1, np.int64)
            self.runner.fork_blocks(self.pool.k, self.pool.v, z, z)
        if self._drafter is None:
            return
        with self._lock:
            self._spec_skip = 1 << 30  # force the plain-decode path
        self.generate([0], SamplingParams(max_tokens=2))
        with self._lock:
            self._spec_skip = 0
            self._spec_backoff = 0
            S, W = self.cfg.max_slots, self.cfg.spec_k + 1
            self.runner.verify_step(
                self.pool.k, self.pool.v,
                np.zeros((S, W), np.int64),
                np.zeros(S, np.int64),
                np.zeros((S, self.pool.cfg.max_blocks_per_seq), np.int32),
                np.zeros(S, np.float32),
                np.zeros(S, np.int64),
                np.ones(S, np.float32),
                np.zeros(S, np.int64),
                np.zeros(S, np.int64),
            )

    def stats(self) -> dict:
        with self._lock:
            s = {
                "running": self.scheduler.num_running,
                "waiting": self.scheduler.num_waiting,
                "kv_utilization": self.pool.utilization(),
                "free_blocks": self.pool.num_free_blocks,
                "steps": self._step_n,
                "tokens_generated": self._tokens_generated,
                "prefill_tokens_computed": self._prefill_tokens,
                "preemptions": self._preemptions,
                "decode_steps": self._decode_steps,
                "decode_s": self._decode_s,
                "weights_version": self._weights_version,
                "prefix_cache": self.prefix_cache.stats(),
            }
            if self._drafter is not None:
                s["spec_proposed"] = self._spec_proposed
                s["spec_accepted"] = self._spec_accepted
                s["spec_acceptance_rate"] = self._spec_accepted / max(self._spec_proposed, 1)
                s["spec_emitted"] = self._spec_emitted
                s["spec_draft_seconds"] = self._spec_draft_s
                s["verify_steps"] = self._verify_steps
                s["verify_s"] = self._verify_s
            return s

    def run_loop(self, stop: threading.Event, idle_sleep_s: float = 0.002) -> None:
        """Drive ``step()`` until ``stop`` is set (run it in a thread)."""
        while not stop.is_set():
            if not self.step():
                stop.wait(idle_sleep_s)

    # -- the step ----------------------------------------------------------

    def step(self) -> bool:
        """One engine iteration; returns True when any work was done."""
        with self._lock:
            sched = self.scheduler
            if not sched.has_work():
                self._beat = (time.monotonic(), 0)
                return False
            self._step_n += 1
            self._reap()
            sched.admit()
            self._apply_cow()
            did = self._prefill_one()
            if self._drafter is not None and self._spec_skip == 0:
                did = self._spec_decode_all() or did
            else:
                did_decode = self._decode_all()
                if did_decode and self._spec_skip > 0:
                    self._spec_skip -= 1  # backoff ticks on real decodes
                did = did_decode or did
            # prune finished requests: callers keep their own references;
            # cancel() of a pruned id is a no-op, correct for finished work
            self._requests = {k: r for k, r in self._requests.items() if not r.finished}
            self._beat = (time.monotonic(), sched.num_running + sched.num_waiting)
            return did or sched.has_work()

    # -- internals (all called under the lock) -----------------------------

    def _reap(self) -> None:
        """Finish cancelled and deadline-blown requests."""
        now = time.time()
        for req in list(self.scheduler.waiting) + self.scheduler.running:
            if req.cancelled.is_set():
                self.scheduler.finish(req, FINISH_CANCELLED)
            elif req.deadline is not None and now >= req.deadline:
                self.scheduler.finish(req, FINISH_DEADLINE)

    def _apply_cow(self) -> None:
        """Drain the scheduler's queued copy-on-write forks: one block copy
        duplicates each src block into the request's fresh dst block BEFORE
        any prefill chunk attends through it."""
        pend = self.scheduler.pending_cow
        if not pend:
            return
        self.scheduler.pending_cow = []
        src = np.asarray([s for s, _, _ in pend], np.int64)
        dst = np.asarray([d for _, d, _ in pend], np.int64)
        self.runner.fork_blocks(self.pool.k, self.pool.v, src, dst)

    def _prefill_one(self) -> bool:
        """One chunk for the oldest admission still prefilling."""
        pre = [r for r in self.scheduler.slots if r is not None and r.state == PREFILL]
        if not pre:
            return False
        req = min(pre, key=lambda r: self.scheduler._admitted_at.get(r.id, 0))
        chunk = self.cfg.prefill_chunk
        # a preempted request replays prompt + already-generated tokens; a
        # prefix-cache hit starts past the matched prefix either way
        full = req.prompt + req.out
        piece = full[req.prefill_pos : req.prefill_pos + chunk]
        n_valid = len(piece)
        tokens = np.zeros(chunk, np.int64)
        tokens[:n_valid] = piece
        table = self.pool.table_row(req.id)
        last_logits = self.runner.prefill_chunk(
            self.pool.k, self.pool.v, tokens, req.prefill_pos, n_valid, table
        )
        req.prefill_pos += n_valid
        self._prefill_tokens += n_valid
        # register the now-complete PROMPT blocks (generated tokens never
        # enter the tree); the admission epoch keeps a request whose prefill
        # straddled a weight-swap flush from re-inserting old-weight KV
        self.prefix_cache.insert(
            req.prompt, self.pool.blocks_of(req.id), limit=min(req.prefill_pos, len(req.prompt)),
            epoch=req.cache_epoch,
        )
        if req.prefill_pos >= len(full):
            # final chunk: its last position's logits seed generation
            p = req.params
            seeds, counters, temp = [p.seed & 0xFFFFFFFF], [len(req.out)], [p.temperature]
            noise = _row_noise(seeds, counters, temp, self.model_cfg.vocab_size, self.device)
            tok, lp = _sample_rows(last_logits[None, :], noise, temp, [p.top_k], [p.top_p])
            req.state = RUNNING
            self._emit(req, int(tok[0]), float(lp[0]))
        return True

    def _grow_all(self, extra: int = 0) -> None:
        """Ensure every RUNNING slot has cache room for the position(s) the
        next step writes (plus ``extra`` provisional speculative ones),
        evicting the youngest when the pool is dry."""
        sched = self.scheduler
        for req in list(sched.running):
            if req.state != RUNNING:
                continue
            before = sched.preempt_count
            sched.grow_for_decode(req, extra=extra)  # False: req itself was preempted
            self._preemptions += sched.preempt_count - before

    def _decode_all(self) -> bool:
        """One batched decode step over every RUNNING slot."""
        sched = self.scheduler
        # memory first: every runner needs space for the token it is about
        # to write; the youngest gets evicted when the pool is dry
        self._grow_all()
        active = [(i, r) for i, r in enumerate(sched.slots) if r is not None and r.state == RUNNING]
        if not active:
            return False
        t0 = time.perf_counter()
        S = self.cfg.max_slots
        tokens = np.zeros(S, np.int64)
        positions = np.zeros(S, np.int64)
        tables = np.zeros((S, self.pool.cfg.max_blocks_per_seq), np.int32)
        temp = np.zeros(S, np.float32)
        top_k = np.zeros(S, np.int64)
        top_p = np.ones(S, np.float32)
        seeds = np.zeros(S, np.int64)
        counters = np.zeros(S, np.int64)
        for i, req in active:
            tokens[i] = req.out[-1] if req.out else req.prompt[-1]
            positions[i] = req.seq_len - 1  # the fed token's position
            tables[i] = self.pool.table_row(req.id)
            p = req.params
            temp[i] = p.temperature
            top_k[i] = p.top_k
            top_p[i] = p.top_p
            # mask, don't assign raw: a negative seed keys like its uint32
            seeds[i] = p.seed & 0xFFFFFFFF
            counters[i] = len(req.out)
        nxt, logp = self.runner.decode_step(
            self.pool.k, self.pool.v, tokens, positions, tables,
            temp, top_k, top_p, seeds, counters,
        )
        # ONE host sync for the batch: tokens (< 2^53) ride in float64
        host = torch.stack([nxt.double(), logp.double()]).cpu().numpy()
        self._decode_steps += 1
        self._decode_s += time.perf_counter() - t0
        for i, req in active:
            self._emit(req, int(host[0, i]), float(host[1, i]))
        return True

    def _spec_decode_all(self) -> bool:
        """One speculative step over every RUNNING slot: draft k tokens per
        slot, verify k+1 positions in one call, emit the accepted prefix +
        correction/bonus, roll the ledger back."""
        sched = self.scheduler
        kd = self.cfg.spec_k
        active = [(i, r) for i, r in enumerate(sched.slots) if r is not None and r.state == RUNNING]
        if not active:
            return False
        # pure-Python n-gram search over up to scan_window tokens per slot,
        # every step, under the engine lock (as in the reference); its time
        # is reported as spec_draft_seconds
        t0 = time.perf_counter()
        draft = self._drafter.propose([r.prompt + r.out for _, r in active])
        self._spec_draft_s += time.perf_counter() - t0
        # drafter confidence gate: when NO slot's proposal is backed by a
        # real match (NGramDrafter.last_matched), the whole window would be
        # a doomed probe — plain-decode this step instead of paying a w-wide
        # verify to learn it. Model drafters have no such signal and rely
        # on the acceptance backoff alone.
        matched = getattr(self._drafter, "last_matched", None)
        if matched is not None and not bool(matched.any()):
            return self._decode_all()
        draft_by_id = {r.id: draft[row] for row, (_, r) in enumerate(active)}
        # memory next: the window provisionally writes positions
        # seq_len-1 .. seq_len-1+k; the youngest gets evicted when dry
        self._grow_all(extra=kd)
        active = [(i, r) for i, r in active if r.state == RUNNING]
        if not active:
            return False
        t0 = time.perf_counter()
        S, W = self.cfg.max_slots, kd + 1
        tokens = np.zeros((S, W), np.int64)
        base_pos = np.zeros(S, np.int64)
        tables = np.zeros((S, self.pool.cfg.max_blocks_per_seq), np.int32)
        temp = np.zeros(S, np.float32)
        top_k = np.zeros(S, np.int64)
        top_p = np.ones(S, np.float32)
        seeds = np.zeros(S, np.int64)
        counters = np.zeros(S, np.int64)
        for i, req in active:
            tokens[i, 0] = req.out[-1] if req.out else req.prompt[-1]
            tokens[i, 1:] = draft_by_id[req.id]
            base_pos[i] = req.seq_len - 1  # the fed token's position
            tables[i] = self.pool.table_row(req.id)
            p = req.params
            temp[i] = p.temperature
            top_k[i] = p.top_k
            top_p[i] = p.top_p
            seeds[i] = p.seed & 0xFFFFFFFF
            counters[i] = len(req.out)
        n_acc, out, out_lp = self.runner.verify_step(
            self.pool.k, self.pool.v, tokens, base_pos, tables,
            temp, top_k, top_p, seeds, counters,
        )
        # ONE host sync for the batch: counts and tokens (< 2^53) ride in
        # float64 beside the logprobs
        host = torch.cat([n_acc.double()[:, None], out.double(), out_lp.double()], 1).cpu().numpy()
        self._verify_steps += 1
        self._verify_s += time.perf_counter() - t0
        accepted = 0
        for i, req in active:
            n = int(host[i, 0])
            accepted += n
            for j in range(n + 1):
                self._emit(req, int(host[i, 1 + j]), float(host[i, 1 + W + j]))
                self._spec_emitted += 1
                if req.finished:
                    # stop token / length cap hit inside the window: the
                    # rest of the acceptance is after-the-end, discard it
                    break
            if not req.finished:
                # ledger rollback: return the rejected tail's provisional
                # blocks (device k/v needs none — see cache.shrink_to)
                self.pool.shrink_to(req.id, req.seq_len)
        proposed = kd * len(active)
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        if accepted / proposed < MIN_ACCEPT:
            # low acceptance: back off to plain decode, doubling the pause
            # while probes keep failing (EngineConfig docstring)
            self._spec_backoff = min(max(self._spec_backoff * 2, 2), BACKOFF_MAX)
            self._spec_skip = self._spec_backoff
        else:
            self._spec_backoff = 0
        return True

    def _emit(self, req: Request, tok: int, logp: float = float("nan")) -> None:
        """Record one sampled token: stream it, capture its behavior
        logprob, finish on stop token / max_tokens / model-length cap."""
        if req.first_token_t is None:
            req.first_token_t = time.time()
        req.out.append(tok)
        req.out_logprobs.append(logp)
        req.stream.put(("token", tok))
        self._tokens_generated += 1
        p = req.params
        if tok in p.stop_token_ids:
            self.scheduler.finish(req, FINISH_STOP)
        elif len(req.out) >= p.max_tokens or req.seq_len >= self.max_model_len:
            self.scheduler.finish(req, FINISH_LENGTH)
