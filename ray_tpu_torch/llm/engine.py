"""LLMEngine: the continuous-batching step loop (port of
``ray_tpu/llm/engine.py``).

One engine owns one GPT or GPT-J model, one paged KV pool on one device
(or, at ``EngineConfig(tp=N)``, on N cards: ``llm.multichip``), and one
scheduler. ``step()`` is the whole design:

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

Production half, as in the reference:

* **watchdog** (``start_watchdog``, ``llm.watchdog``) — stall detection
  from a lock-free liveness beat, reaping of cancelled and deadline-blown
  requests that works around a wedged step, and the KV leak audit;
  ``stream_tokens`` raises ``EngineStalledError`` with the lock-free
  diagnosis on a timeout;
* **deadline-aware shedding** — a ``submit`` whose deadline the backlog ÷
  observed service rate (an EWMA over 0.5 s windows) cannot meet raises
  ``OverloadedError`` with ``retry_after_s``;
* **HBM ledger** (``hbm_ledger``) — parameter, pool and drafter bytes,
  and the pool's seq-owned / cache-only / free partition, published as
  gauges once a step;
* **metrics, events, phases, tracing** — the ``llm_*`` metric families
  (``util.metrics``), a flight-recorder event at every request transition
  (``_private.events``), the per-request phase ledger (``util.phases``)
  and one ``llm_engine_step`` span a step (``util.tracing``). The hooks
  take no shared lock on the per-token path.

Threading: ``step()`` serializes on an internal lock — any number of
submitter threads can feed the engine while one loop thread
(``run_loop``) turns the crank, and ``update_weights`` hot-swaps the
parameters between two steps without draining in-flight requests.

Tensor parallelism: ``tp > 1`` builds ``llm.multichip``'s runner and
head-sharded pool instead of the single-card pair; this process is the
leader and starts ``tp - 1`` follower processes, one a card
(``shutdown()`` or the engine's collection stops them). Everything above
the runner — scheduler, prefix cache, drafter, watchdog, hot swap — is
unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from collections.abc import Mapping
from typing import Iterator, Optional

import numpy as np
import torch

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.llm._tp_worker import storage_bytes
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
from ray_tpu_torch.util import phases as _phases
from ray_tpu_torch.util import tracing as _tracing

#: every metric the engine exports (the reference's names)
METRIC_NAMES = (
    "llm_generated_tokens",
    "llm_prefill_tokens",
    "llm_engine_steps",
    "llm_finished_requests",
    "llm_preemptions",
    "llm_running_requests",
    "llm_waiting_requests",
    "llm_kv_block_utilization",
    "llm_time_to_first_token_s",
    "llm_inter_token_latency_s",
    "llm_spec_draft_tokens",
    "llm_spec_accepted_tokens",
    "llm_spec_acceptance_rate",
    "llm_spec_draft_seconds",
    "llm_tokens_per_step",
    "llm_shed_requests",
    # HBM ledger: who holds device memory — parameters, pool blocks split
    # seq-owned vs cache-only resident vs free, drafter state
    "llm_hbm_params_bytes",
    "llm_hbm_kv_pool_bytes",
    "llm_hbm_kv_seq_bytes",
    "llm_hbm_kv_cache_bytes",
    "llm_hbm_kv_free_bytes",
    "llm_hbm_drafter_bytes",
)

_METRICS = None
_METRICS_LOCK = threading.Lock()


def _metrics() -> dict:
    """Engine metric set, created once per process (util.metrics registers
    globally; duplicates would fight in collect())."""
    global _METRICS
    if _METRICS is not None:
        return _METRICS  # lock-free fast path: called per token in _emit
    with _METRICS_LOCK:
        if _METRICS is not None:
            return _METRICS
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        _METRICS = {
            "tokens": Counter("llm_generated_tokens", "tokens sampled by the engine"),
            "prefill_tokens": Counter(
                "llm_prefill_tokens",
                "prompt tokens actually computed by prefill (a prefix-cache "
                "hit skips the matched head, so this is the MISS work)",
            ),
            "steps": Counter("llm_engine_steps", "engine step-loop iterations"),
            "finished": Counter(
                "llm_finished_requests", "requests finished for any reason"
            ),
            "preempt": Counter("llm_preemptions", "requests evicted under KV pressure"),
            "running": Gauge("llm_running_requests", "requests holding decode slots"),
            "waiting": Gauge("llm_waiting_requests", "requests queued for admission"),
            "kv_util": Gauge("llm_kv_block_utilization", "fraction of KV blocks in use"),
            "ttft": Histogram("llm_time_to_first_token_s", "submit → first token"),
            "itl": Histogram(
                "llm_inter_token_latency_s",
                "gap between consecutive streamed tokens",
                boundaries=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0),
            ),
            # speculative decode: drafted vs accepted counters give the
            # lifetime acceptance rate; the gauges give the latest step's
            "spec_proposed": Counter(
                "llm_spec_draft_tokens", "draft tokens proposed for verification"
            ),
            "spec_accepted": Counter(
                "llm_spec_accepted_tokens", "draft tokens accepted by verification"
            ),
            "spec_accept_rate": Gauge(
                "llm_spec_acceptance_rate", "accepted/proposed of the last step"
            ),
            "spec_draft_s": Counter(
                "llm_spec_draft_seconds", "cumulative wall time inside the drafter"
            ),
            "tokens_per_step": Gauge(
                "llm_tokens_per_step", "tokens emitted by the last decode step"
            ),
            "shed": Counter(
                "llm_shed_requests",
                "requests rejected by deadline-aware admission (429 upstream)",
            ),
            # HBM ledger gauges: params + pool + drafter is (about) the
            # resident footprint; the three kv_* gauges PARTITION the
            # pool's usable blocks (seq-owned + cache-only + free). Under
            # tp > 1 the device tag splits each per card (hbm_ledger's
            # per_device); the untagged series is the pool-wide truth.
            "hbm_params": Gauge(
                "llm_hbm_params_bytes", "device bytes held by model params",
                tag_keys=("device",),
            ),
            "hbm_pool": Gauge(
                "llm_hbm_kv_pool_bytes",
                "total device bytes of the KV pool arrays (fixed at start)",
                tag_keys=("device",),
            ),
            "hbm_seq": Gauge(
                "llm_hbm_kv_seq_bytes",
                "bytes of KV blocks owned by at least one live sequence",
                tag_keys=("device",),
            ),
            "hbm_cache": Gauge(
                "llm_hbm_kv_cache_bytes",
                "bytes of KV blocks resident ONLY in the prefix cache "
                "(reclaimable without preempting anyone)",
                tag_keys=("device",),
            ),
            "hbm_free": Gauge(
                "llm_hbm_kv_free_bytes", "bytes of free-list KV blocks",
                tag_keys=("device",),
            ),
            "hbm_drafter": Gauge(
                "llm_hbm_drafter_bytes",
                "device bytes held by the speculative drafter's params",
                tag_keys=("device",),
            ),
        }
    return _METRICS


def _tree_device_bytes(params) -> int:
    """Bytes of a module's parameter storages, each storage counted once
    (keyed by ``untyped_storage().data_ptr()``), so a tied or aliased
    tensor is not counted twice; 0 for None (the n-gram drafter holds no
    device state). These are the fp32 masters the GPT runner casts at each
    use, not the step's bf16 temporaries."""
    return 0 if params is None else storage_bytes(params.parameters())


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine geometry. ``num_blocks`` includes the reserved trash block;
    ``max_blocks_per_seq * block_size`` caps a sequence (prompt + output).

    Decode and verify attention run the CUDA kernels on the card and their
    plain versions on the CPU (``ops.paged_attention``). The prefix cache is
    always on: KV blocks are shared across requests through a radix tree
    over block contents. ``tp`` splits the model's heads and MLP over that
    many cards, one process each (``llm.multichip``); ``n_heads`` must
    divide by it, and a card engine needs ``tp`` visible cards.

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
    #: deadline-aware overload shedding: a submit carrying ``deadline_s`` is
    #: REJECTED with ``OverloadedError`` when backlog ÷ observed service
    #: rate says the deadline cannot be met — queueing doomed work only
    #: steals KV blocks and decode slots from requests that could still
    #: make theirs. Requests without a deadline are never shed.
    shed: bool = True
    #: engine watchdog (``llm.watchdog``): stall-detection deadline and
    #: check cadence. The owner starts the thread (``start_watchdog()``).
    watchdog_stall_s: float = 30.0
    watchdog_interval_s: float = 1.0


# Speculation constants, the reference's EngineConfig defaults: the longest
# n-gram the drafter matches, the acceptance share below which the engine
# backs off to plain decode, and the longest backoff in plain-decode steps.
NGRAM_MAX = 3
MIN_ACCEPT = 0.3
BACKOFF_MAX = 32
#: how long ``run_loop`` pauses after a step while another thread waits for
#: the engine lock (``_caller_lock``): long enough for the woken waiter to
#: take the lock before the loop's next step does
HANDOFF_S = 2e-4


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
        self.device = resolve_device(device)
        pdev = params.lm_head.weight.device
        if pdev != self.device and not (self.cfg.tp > 1 and pdev.type == "cpu"):
            raise ValueError(
                f"params are on {pdev}, the engine runs on {self.device}"
                + (" (under tp > 1 they may also be on the CPU)" if self.cfg.tp > 1 else "")
            )
        self.model_cfg = model_cfg
        cache_cfg = CacheConfig(
            num_blocks=self.cfg.num_blocks,
            block_size=self.cfg.block_size,
            max_blocks_per_seq=self.cfg.max_blocks_per_seq,
        )
        self.runner, self.pool = self._substrate(model_cfg, params, cache_cfg)
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
        # HBM ledger inputs fixed at init: parameter and drafter storage
        # never changes size (update_weights writes in place), and the pool
        # tensors are allocated once
        self._params_bytes = _tree_device_bytes(params)
        self._drafter_bytes = _tree_device_bytes(getattr(self._drafter, "_params", None))
        self._lock = threading.Lock()
        # callers other than the step loop (submit, stats, update_weights,
        # has_work) count themselves here while they wait for the lock, and
        # run_loop pauses HANDOFF_S after a step while any does: Python's
        # locks are not fair, and a loop that takes the lock again right
        # after releasing it kept a replica's stats() and submit() waiting
        # through whole backlogs (seconds) on the CPU
        self._callers_waiting = 0
        self._callers_lock = threading.Lock()
        self._requests: dict[str, Request] = {}
        self._step_n = 0
        self._finished_published = 0  # scheduler.finish_count already counted
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
        # liveness beat, read LOCK-FREE by the watchdog and stream_tokens'
        # stall diagnosis (a wedged step holds the engine lock, so an
        # observer must never need it): (monotonic t of the last completed
        # step — idle ticks count, a wedge does not —, pending work then).
        # One-tuple assignment keeps the read torn-free under the GIL.
        self._beat: tuple[float, int] = (time.monotonic(), 0)
        self._watchdog = None
        # observed decode throughput (EWMA tokens/s) for deadline-aware
        # admission: backlog ÷ rate estimates a new request's completion
        self._rate = 0.0
        self._rate_mark = (time.monotonic(), 0)  # (t, tokens_generated)
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

    def _substrate(self, model_cfg, params, cache_cfg: CacheConfig):
        """The runner and the pool: a single-card pair at tp 1, the
        tensor-parallel pair of ``llm.multichip`` over the same group
        otherwise (everything above them — scheduler, prefix cache,
        drafter, watchdog — is blind to tp)."""
        if self.cfg.tp > 1:
            return self._tp_substrate(model_cfg, params, cache_cfg, self.cfg.tp)
        runner = PagedModelRunner(model_cfg, params, self.cfg.block_size)
        pool = KVBlockPool(
            cache_cfg,
            n_layers=model_cfg.n_layers,
            n_heads=model_cfg.n_heads,
            head_dim=model_cfg.head_dim,
            dtype=model_cfg.torch_dtype,
            device=self.device,
        )
        return runner, pool

    def _tp_substrate(self, model_cfg, params, cache_cfg: CacheConfig, tp: int):
        """``TensorParallelPagedModelRunner`` (which starts the followers)
        and ``ShardedKVBlockPool`` over its group, at ``tp``."""
        from ray_tpu_torch.llm.multichip import ShardedKVBlockPool, TensorParallelPagedModelRunner

        runner = TensorParallelPagedModelRunner(
            model_cfg, params, self.cfg.block_size, tp=tp, device=self.device
        )
        try:
            pool = ShardedKVBlockPool(
                cache_cfg,
                n_layers=model_cfg.n_layers,
                n_heads=model_cfg.n_heads,
                head_dim=model_cfg.head_dim,
                dtype=model_cfg.torch_dtype,
                device=self.device,
                tp=tp,
                group=runner.group,
            )
        except BaseException:
            runner.close()
            raise
        return runner, pool

    def shutdown(self) -> None:
        """Stop what the engine started outside this process: the follower
        processes of a tp engine (collection stops them too). The engine
        takes no step after this."""
        self.runner.close()

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
        after which the request is reaped with finish reason "deadline".

        With a ``deadline_s`` and ``EngineConfig.shed`` on, admission is
        deadline-aware: when queue backlog ÷ observed service rate says the
        deadline cannot be met, the request is REJECTED with
        ``ray_tpu_torch.exceptions.OverloadedError`` (``retry_after_s``
        attached) instead of queued as doomed work."""
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
        if req.phase_led is not None:
            # cross-process dispatch leg: a dispatcher that stamped its
            # anchor into the sampled trace-context dict it minted
            _phases.note_dispatch(req, _tracing.get_trace_context())
        # staleness stamp: the weights version this request STARTS under (a
        # swap mid-generation is fine — per-token behavior logprobs stay
        # exact either way)
        req.weights_version = self._weights_version
        _events.record(
            "llm.submit", request_id=req.trace_id, engine_req=req.id,
            prompt_len=len(prompt), max_tokens=params.max_tokens,
            resumed=len(req.out),
        )
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
            if req.phase_led is not None:
                # fold the (near-empty) ledger so this attempt is still
                # attributed — its whole life was the submit check
                now = time.time()
                _phases.charge(req.phase_led, _phases.QUEUE, now)
                _phases.fold_engine(req, now, done_reason)
            _events.record(
                "llm.finish", request_id=req.trace_id, engine_req=req.id,
                reason=done_reason, tokens_out=len(req.out),
            )
            req.stream.put(("done", done_reason))
            return req
        with self._caller_lock():
            if self.cfg.shed and deadline_s is not None:
                est = self._estimate_completion_s_locked(params.max_tokens - len(req.out))
                if est is not None and est > deadline_s:
                    from ray_tpu_torch.exceptions import OverloadedError

                    retry_after = max(0.1, round(est - deadline_s, 2))
                    _events.record(
                        "llm.shed", request_id=req.trace_id,
                        engine_req=req.id, estimate_s=round(est, 3),
                        deadline_s=deadline_s, retry_after_s=retry_after,
                    )
                    _metrics()["shed"].inc()
                    raise OverloadedError(
                        f"engine overloaded: estimated completion in "
                        f"{est:.2f}s exceeds the {deadline_s:.2f}s deadline "
                        f"(backlog at {self._rate:.1f} tokens/s)",
                        retry_after_s=retry_after,
                    )
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

    def _estimate_completion_s_locked(self, new_tokens: int) -> Optional[float]:
        """Seconds until a request needing ``new_tokens`` more tokens would
        finish, from the backlog of promised-but-ungenerated tokens and the
        observed service rate. None (no shedding evidence) when there is no
        backlog or no measured rate — an EMPTY engine never sheds, whatever
        a stale rate says (the estimate only means something when the
        request must wait behind real work that keeps the rate fresh)."""
        rate = self._rate
        if rate <= 1e-6:
            return None
        backlog = sum(
            max(r.params.max_tokens - len(r.out), 0)
            for r in list(self.scheduler.waiting) + self.scheduler.running
        )
        if backlog <= 0:
            return None
        return (backlog + new_tokens) / rate

    def cancel(self, req_id: str) -> bool:
        """Flag a request for cancellation; the next step reaps it."""
        req = self._requests.get(req_id)
        if req is None:
            return False
        req.cancelled.set()
        return True

    def has_work(self) -> bool:
        with self._caller_lock():
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
        any device), or its ``state_dict`` as a ``{name: tensor}`` mapping
        (what ``rlhf.sync.apply_weight_update`` rebuilds from a pushed
        manifest): the same parameter names, shapes and dtypes, or
        ``ValueError``. Each new value is written INTO the existing
        parameter storage with ``copy_`` (under tp, each rank's slice into
        its own: ``runner.load_weights``), under the engine lock, on the
        current stream (the steps' stream: the engine never switches
        streams), so the next step reads it; no tensor is rebound, so
        nothing that captured the storage can keep stale weights. In-flight
        requests continue under the new weights from their next step (their
        per-token behavior logprobs were captured at sample time). The
        prefix cache is flushed: its k/v was computed under the old weights.

        ``version`` must not go backwards (default: current + 1). Returns
        the installed version."""
        new = params if isinstance(params, Mapping) else params.state_dict()
        t0 = time.perf_counter()
        with self._caller_lock():
            old = self.runner.weight_specs()
            if list(new) != list(old):
                raise ValueError(
                    f"update_weights parameter structure mismatch: {list(new)} != {list(old)}"
                )
            for name, (shape, dtype) in old.items():
                src = new[name]
                if tuple(src.shape) != shape or src.dtype != dtype:
                    raise ValueError(
                        f"update_weights mismatch at {name}: {tuple(src.shape)}/{src.dtype} != "
                        f"{shape}/{dtype}"
                    )
            if version is None:
                version = self._weights_version + 1
            if version < self._weights_version:
                raise ValueError(
                    f"weights_version must not go backwards: {version} < {self._weights_version}"
                )
            self.runner.load_weights(new)
            self._weights_version = version
            # cached prefix KV was computed under the OLD weights: no new
            # request may seed from it (in-flight requests keep their own
            # references, and their epoch stamp keeps a prefill that
            # straddled the swap out of the tree)
            self.prefix_cache.flush(reason="weights_update")
            in_flight = self.scheduler.num_running + self.scheduler.num_waiting
        _events.record(
            "llm.weights_update", version=version,
            apply_s=round(time.perf_counter() - t0, 6), in_flight=in_flight,
        )
        return version

    def stream_tokens(self, req: Request, timeout: float = 60.0) -> Iterator[int]:
        """Yield the request's tokens as the engine produces them.

        A timeout raises ``EngineStalledError`` (a ``TimeoutError``
        subclass) carrying the stall diagnosis — last-step age, queue
        depth, and KV utilization — gathered WITHOUT the engine lock, so
        the diagnosis works precisely when the step loop is wedged holding
        it."""
        import queue as _q

        while True:
            try:
                kind, val = req.stream.get(timeout=timeout)
            except _q.Empty:
                from ray_tpu_torch.llm.watchdog import EngineStalledError

                age, pending = self.progress()
                kv = self.pool.utilization()
                _events.record(
                    "llm.watchdog.stall", request_id=req.trace_id,
                    engine_req=req.id, source="stream_tokens",
                    last_step_age_s=round(age, 3), queue_depth=pending,
                    kv_utilization=round(kv, 4), timeout_s=timeout,
                )
                raise EngineStalledError(
                    f"no token from {req.id} within {timeout}s "
                    f"(state={req.state})",
                    last_step_age_s=age,
                    queue_depth=pending,
                    kv_utilization=kv,
                ) from None
            if kind == "token":
                yield val
            else:
                return

    def start_watchdog(self):
        """Start (once) the engine watchdog thread — stall detection,
        deadline/cancel reaping that works around a wedged step loop, and
        the KV-pool leak audit (``llm.watchdog`` module doc)."""
        if self._watchdog is None:
            from ray_tpu_torch.llm.watchdog import EngineWatchdog

            self._watchdog = EngineWatchdog(
                self,
                stall_deadline_s=self.cfg.watchdog_stall_s,
                interval_s=self.cfg.watchdog_interval_s,
            ).start()
        return self._watchdog

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
            z = np.zeros(self.cfg.max_slots, np.int64)  # the fork's one shape (``_apply_cow``)
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
        with self._caller_lock():
            # ONE pool-ledger snapshot feeds utilization, free_blocks and the
            # hbm section — separate property reads could each interleave
            # with an allocation and disagree in one response
            led = self.hbm_ledger()
            s = {
                "running": self.scheduler.num_running,
                "waiting": self.scheduler.num_waiting,
                "queue_depth": self.scheduler.num_waiting,
                "kv_utilization": led["utilization"],
                "free_blocks": led["free_blocks"],
                "steps": self._step_n,
                "tokens_generated": self._tokens_generated,
                "prefill_tokens_computed": self._prefill_tokens,
                "preemptions": self._preemptions,
                "service_rate_tokens_per_s": self._rate,
                "decode_steps": self._decode_steps,
                "decode_s": self._decode_s,
                "weights_version": self._weights_version,
                "prefix_cache": self.prefix_cache.stats(),
                "hbm": led,
                "retraces": self.runner.prof.retraces,
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
        """Drive ``step()`` until ``stop`` is set (run it in a thread).
        While another thread waits for the engine lock, each busy step is
        followed by a ``HANDOFF_S`` pause, so the waiter gets the lock
        between two steps instead of after the backlog."""
        while not stop.is_set():
            if not self.step():
                stop.wait(idle_sleep_s)
            elif self._callers_waiting:
                time.sleep(HANDOFF_S)

    @contextlib.contextmanager
    def _caller_lock(self):
        """The engine lock, taken by a thread other than the step loop's;
        counted in ``_callers_waiting`` while it waits (``run_loop``)."""
        with self._callers_lock:
            self._callers_waiting += 1
        try:
            self._lock.acquire()
        finally:
            with self._callers_lock:
                self._callers_waiting -= 1
        try:
            yield
        finally:
            self._lock.release()

    # -- the step ----------------------------------------------------------

    def step(self) -> bool:
        """One engine iteration; returns True when any work was done."""
        with self._lock:
            sched = self.scheduler
            if not sched.has_work():
                self._publish_gauges()
                self._beat = (time.monotonic(), 0)
                return False
            self._step_n += 1
            m = _metrics()
            m["steps"].inc()
            # spec stats fill in during the step; span attributes serialize
            # at span EXIT, so the dict lands populated in the trace
            spec_info: dict = {}
            attrs = dict(step=self._step_n, running=sched.num_running, waiting=sched.num_waiting)
            if self._drafter is not None:
                attrs["spec"] = spec_info
            with _tracing.span("llm_engine_step", **attrs):
                self._reap()
                sched.admit()
                self._apply_cow()
                did = self._prefill_one()
                if self._drafter is not None and self._spec_skip == 0:
                    did = self._spec_decode_all(spec_info) or did
                else:
                    did_decode = self._decode_all()
                    if did_decode and self._spec_skip > 0:
                        self._spec_skip -= 1  # backoff ticks on real decodes
                    did = did_decode or did
            # prune finished requests: callers keep their own references;
            # cancel() of a pruned id is a no-op, correct for finished work
            self._requests = {k: r for k, r in self._requests.items() if not r.finished}
            self._publish_gauges()
            self._beat = (time.monotonic(), sched.num_running + sched.num_waiting)
            return did or sched.has_work()

    # -- internals (all called under the lock) -----------------------------

    def _reap(self) -> int:
        """Finish cancelled and deadline-blown requests (lock held). Also
        the watchdog's locked reap path — ONE copy of the doomed-request
        predicate. Returns how many were finished."""
        now = time.time()
        n = 0
        for req in list(self.scheduler.waiting) + self.scheduler.running:
            if req.cancelled.is_set():
                self.scheduler.finish(req, FINISH_CANCELLED)
                n += 1
            elif req.deadline is not None and now >= req.deadline:
                self.scheduler.finish(req, FINISH_DEADLINE)
                n += 1
        return n

    def _apply_cow(self) -> None:
        """Drain the scheduler's queued copy-on-write forks: one block copy
        duplicates each src block into the request's fresh dst block BEFORE
        any prefill chunk attends through it. The copies go in batches of
        ``max_slots`` lanes, the unused lanes copying the trash block onto
        itself, as the reference pads them: the fork keeps one shape, so
        the runner's step profiler never sees it retrace."""
        pend = self.scheduler.pending_cow
        if not pend:
            return
        self.scheduler.pending_cow = []
        F = self.cfg.max_slots
        for start in range(0, len(pend), F):
            src = np.zeros(F, np.int64)
            dst = np.zeros(F, np.int64)
            for j, (s_, d_, _rid) in enumerate(pend[start : start + F]):
                src[j], dst[j] = s_, d_
            self.runner.fork_blocks(self.pool.k, self.pool.v, src, dst)
        now = time.time()
        for _s, _d, rid in pend:
            req = self._requests.get(rid)
            if req is not None and req.phase_led is not None:
                _phases.charge(req.phase_led, _phases.COW_FORK, now)

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
        if req.phase_led is not None:
            # a recompute's re-prefill is preemption cost, not prefill
            _phases.charge(
                req.phase_led,
                _phases.PREEMPT if req.phase_recompute else _phases.PREFILL,
                time.time(),
            )
        _metrics()["prefill_tokens"].inc(n_valid)
        _events.record(
            "llm.prefill_chunk", request_id=req.trace_id, engine_req=req.id,
            pos=req.prefill_pos, of=len(full), n=n_valid,
        )
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
            req.phase_recompute = False  # recompute ends where decode resumes
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
            _metrics()["preempt"].inc(sched.preempt_count - before)

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
        now = time.time()
        for i, req in active:
            if req.phase_led is not None:
                _phases.charge(req.phase_led, _phases.DECODE, now)
        for i, req in active:
            tok = int(host[0, i])
            _events.record(
                "llm.decode", request_id=req.trace_id, engine_req=req.id,
                step=self._step_n, token=tok,
            )
            self._emit(req, tok, float(host[1, i]))
        _metrics()["tokens_per_step"].set(len(active))
        return True

    def _spec_decode_all(self, spec_info: dict) -> bool:
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
        draft_s = time.perf_counter() - t0
        self._spec_draft_s += draft_s
        _metrics()["spec_draft_s"].inc(draft_s)
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
        now = time.time()
        for i, req in active:
            if req.phase_led is not None:
                _phases.charge(req.phase_led, _phases.SPEC_VERIFY, now)
        emitted = 0
        accepted = 0
        for i, req in active:
            n = int(host[i, 0])
            accepted += n
            _events.record(
                "llm.verify", request_id=req.trace_id, engine_req=req.id,
                step=self._step_n, proposed=kd, accepted=n,
            )
            for j in range(n + 1):
                self._emit(req, int(host[i, 1 + j]), float(host[i, 1 + W + j]))
                emitted += 1
                if req.finished:
                    # stop token / length cap hit inside the window: the
                    # rest of the acceptance is after-the-end, discard it
                    break
            if not req.finished:
                # ledger rollback: return the rejected tail's provisional
                # blocks (device k/v needs none — see cache.shrink_to)
                self.pool.shrink_to(req.id, req.seq_len)
        self._spec_emitted += emitted
        proposed = kd * len(active)
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        step_rate = accepted / proposed
        if step_rate < MIN_ACCEPT:
            # low acceptance: back off to plain decode, doubling the pause
            # while probes keep failing (EngineConfig docstring)
            self._spec_backoff = min(max(self._spec_backoff * 2, 2), BACKOFF_MAX)
            self._spec_skip = self._spec_backoff
        else:
            self._spec_backoff = 0
        m = _metrics()
        m["spec_proposed"].inc(proposed)
        m["spec_accepted"].inc(accepted)
        m["spec_accept_rate"].set(step_rate)
        m["tokens_per_step"].set(emitted)
        spec_info.update(
            k=kd,
            slots=len(active),
            proposed=proposed,
            accepted=accepted,
            emitted=emitted,
            draft_s=round(draft_s, 6),
            backoff=self._spec_backoff,
        )
        return True

    def _emit(self, req: Request, tok: int, logp: float = float("nan")) -> None:
        """Record one sampled token: stream it, capture its behavior
        logprob, update the latency metrics, finish on stop token /
        max_tokens / model-length cap."""
        now = time.time()
        m = _metrics()
        if req.first_token_t is None:
            req.first_token_t = now
            m["ttft"].observe(now - req.arrival_t)
            _events.record(
                "llm.first_token", request_id=req.trace_id,
                engine_req=req.id, ttft_s=round(now - req.arrival_t, 6),
            )
        elif req.last_token_t is not None:
            m["itl"].observe(now - req.last_token_t)
        req.last_token_t = now
        req.out.append(tok)
        req.out_logprobs.append(logp)
        req.stream.put(("token", tok))
        self._tokens_generated += 1
        m["tokens"].inc()
        p = req.params
        if tok in p.stop_token_ids:
            self.scheduler.finish(req, FINISH_STOP)
        elif len(req.out) >= p.max_tokens or req.seq_len >= self.max_model_len:
            self.scheduler.finish(req, FINISH_LENGTH)

    def hbm_ledger(self) -> dict:
        """Live device-memory byte accounting (the gauges' source of truth,
        also read by ``stats()``): parameters, the pool's total, and the
        seq-owned / cache-only / free partition of its usable blocks x
        block bytes, from ONE pool-lock snapshot.

        Over a tensor-parallel pool a ``per_device`` section attributes the
        same families per card (keyed by card index; by rank on the CPU):
        pool and params from what each rank holds (head shards and its copy
        of every replicated parameter — params per device EXCEED
        ``params_bytes / tp`` — and the leader's head), the block partition
        scaled by each rank's local block bytes, the drafter on the leader's
        card. The top-level numbers stay pool-wide — the ledger is
        host-global, block ids are not per-shard."""
        bb = self.pool.block_bytes
        counts = self.pool.ledger_counts()
        led = {
            "params_bytes": self._params_bytes,
            "pool_bytes": self.pool.device_bytes,
            "block_bytes": bb,
            "seq_bytes": counts["seq_owned"] * bb,
            "cache_bytes": counts["cache_only"] * bb,
            "free_bytes": counts["free"] * bb,
            "drafter_bytes": self._drafter_bytes,
            # utilization/free_blocks derived from the SAME snapshot, so the
            # numbers cannot disagree within one response
            "free_blocks": counts["free"],
            "utilization": counts["seq_owned"] / max(self.pool.cfg.num_blocks - 1, 1),
        }
        if hasattr(self.pool, "per_device_bytes"):
            pool_dev = self.pool.per_device_bytes()
            par_dev = self.runner.per_device_param_bytes()
            nb = self.pool.cfg.num_blocks
            first = next(iter(pool_dev))
            led["per_device"] = {
                dev: {
                    "params_bytes": par_dev.get(dev, 0),
                    "pool_bytes": pool_b,
                    "seq_bytes": counts["seq_owned"] * (pool_b // nb),
                    "cache_bytes": counts["cache_only"] * (pool_b // nb),
                    "free_bytes": counts["free"] * (pool_b // nb),
                    "drafter_bytes": self._drafter_bytes if dev == first else 0,
                }
                for dev, pool_b in pool_dev.items()
            }
        return led

    def _publish_gauges(self) -> None:
        m = _metrics()
        m["running"].set(self.scheduler.num_running)
        m["waiting"].set(self.scheduler.num_waiting)
        led = self.hbm_ledger()
        m["kv_util"].set(led["utilization"])
        m["hbm_params"].set(led["params_bytes"])
        m["hbm_pool"].set(led["pool_bytes"])
        m["hbm_seq"].set(led["seq_bytes"])
        m["hbm_cache"].set(led["cache_bytes"])
        m["hbm_free"].set(led["free_bytes"])
        m["hbm_drafter"].set(led["drafter_bytes"])
        # tensor parallel: the same gauge NAMES split by a device tag; the
        # untagged series above stays pool-wide for every existing consumer
        for dev, row in led.get("per_device", {}).items():
            tags = {"device": dev}
            m["hbm_params"].set(row["params_bytes"], tags=tags)
            m["hbm_pool"].set(row["pool_bytes"], tags=tags)
            m["hbm_seq"].set(row["seq_bytes"], tags=tags)
            m["hbm_cache"].set(row["cache_bytes"], tags=tags)
            m["hbm_free"].set(row["free_bytes"], tags=tags)
            m["hbm_drafter"].set(row["drafter_bytes"], tags=tags)
        done = self.scheduler.finish_count
        if done > self._finished_published:
            m["finished"].inc(done - self._finished_published)
            self._finished_published = done
        # service-rate EWMA for deadline-aware admission: sampled at most
        # twice a second so one burst step doesn't whipsaw the estimate.
        # Only GENERATING windows update the average — an idle window is no
        # evidence at all, so going idle RESETS the rate (a decayed stale
        # rate would inflate estimates and shed the next burst's first
        # requests)
        now = time.monotonic()
        t0, n0 = self._rate_mark
        if now - t0 >= 0.5:
            new_tokens = self._tokens_generated - n0
            if new_tokens > 0:
                inst = new_tokens / (now - t0)
                self._rate = inst if self._rate <= 0 else 0.7 * self._rate + 0.3 * inst
            elif not self.scheduler.has_work():
                self._rate = 0.0
            # work pending but zero tokens this window (a long prefill):
            # keep the last measured rate
            self._rate_mark = (now, self._tokens_generated)
