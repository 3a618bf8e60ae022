"""Async disaggregated RLHF: the driver that wires rollouts, sync, and
learning together, plus the pure staleness/importance math (port of
``ray_tpu/rlhf/algorithm.py``).

The loop (LlamaRL / MindSpeed RL shape, on this repo's substrate):

* N ``RolloutWorker`` actors generate CONTINUOUSLY — a driver-side
  poller thread harvests finished trajectories, scores them with the
  user's ``reward_fn``, stages them in a bounded ``TrajectoryBuffer``,
  and refills each worker back to its in-flight target;
* the learner (``rlhf.learner`` in the shared ``rl.learner`` machinery)
  consumes batches from the buffer: staleness admission gate →
  group-relative (GRPO) advantages → clipped-surrogate update with
  importance correction from the captured behavior logprobs;
* after every update the new weights PUBLISH through the object plane
  (``rlhf.sync.publish_weights``) and fan out to the workers
  asynchronously — generation never drains, trajectories submitted
  before the swap complete under mixed weights with exact per-token
  behavior logprobs, and their version stamps let the gate decide.

Off-policy correction is layered: the importance ratio corrects WITHIN
the trust region (clipped), the staleness gate bounds how far outside it
a trajectory may originate — ``drop`` discards anything more than
``max_staleness`` versions old, ``downweight`` decays its sample weight
instead (both unit-pinned in tests/test_rlhf.py).

Device adaptation (as ``device=`` is elsewhere in the port): ``device``
places the learner and the rollout engines (``None``: the card). On the
card each rollout actor holds ``num_gpus_per_worker`` of a GPU (default
``rl.learner.GPU_SHARE``, a quarter) and a remote learner
``LearnerGroup``'s quarter: three rollout workers and a remote learner fit
one card, or more workers beside the driver's own learner. Each actor is
bound to its share of its node's cards by its index in its group.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np

from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private.log_util import warn_throttled
from ray_tpu_torch.rl.learner import GPU_SHARE
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.rlhf.buffer import TrajectoryBuffer
from ray_tpu_torch.rlhf.learner import make_learner_group
from ray_tpu_torch.rlhf.metrics import rlhf_metrics
from ray_tpu_torch.rlhf.rollout import RolloutGroup
from ray_tpu_torch.rlhf.sync import publish_weights


# ---------------------------------------------------------------------------
# pure math (golden-testable without a cluster)
# ---------------------------------------------------------------------------


def staleness_weights(
    ages,
    max_staleness: int,
    mode: str = "drop",
    halflife: float = 1.0,
) -> np.ndarray:
    """Per-trajectory sample weight from version age (learner version
    minus the trajectory's ``weights_version`` stamp).

    * ``drop`` — weight 1 while ``age <= max_staleness``, else 0.
    * ``downweight`` — weight 1 while ``age <= max_staleness``, then
      ``0.5 ** ((age - max_staleness) / halflife)``: every ``halflife``
      versions past the gate halves the trajectory's influence instead
      of discarding the sample outright (the LlamaRL-style soft gate for
      scarce data).

    Negative ages (a trajectory stamped by a NEWER engine than the
    learner — possible when an apply lands before the learner's publish
    bookkeeping) count as age 0.
    """
    ages = np.maximum(np.asarray(ages, np.float64), 0.0)
    if mode == "drop":
        w = (ages <= max_staleness).astype(np.float32)
    elif mode == "downweight":
        over = np.maximum(ages - max_staleness, 0.0)
        w = np.power(0.5, over / max(halflife, 1e-9)).astype(np.float32)
    else:
        raise ValueError(f"unknown staleness mode {mode!r}")
    return w


def importance_ratios(behavior_logp, current_logp, clip: Optional[float] = None):
    """``exp(current - behavior)`` per token, optionally clipped into
    ``[1-clip, 1+clip]`` (the PPO trust region). Pure numpy — the golden
    tests pin this against hand-computed values; the learner loss
    computes the same quantity on device."""
    r = np.exp(np.asarray(current_logp, np.float64) - np.asarray(behavior_logp, np.float64))
    if clip is not None:
        r = np.clip(r, 1.0 - clip, 1.0 + clip)
    return r.astype(np.float32)


def group_advantages(rewards) -> np.ndarray:
    """GRPO group-relative advantage: standardize rewards within the
    consumed batch (no value net). A zero-variance batch yields zero
    advantages — no evidence, no update."""
    r = np.asarray(rewards, np.float64)
    std = r.std()
    if std < 1e-8:
        return np.zeros(len(r), np.float32)
    return ((r - r.mean()) / std).astype(np.float32)


def build_batch(kept: list, advantages: np.ndarray, T: int, O: int,
                temperature: float, top_k: int, top_p: float) -> SampleBatch:
    """Fixed-shape (B, T/O) arrays from variable-length trajectories:
    ``kept`` holds (trajectory, staleness weight, age) triples, as the
    driver's gate leaves them."""
    B = len(kept)
    tokens = np.zeros((B, T), np.int32)
    prompt_len = np.zeros(B, np.int32)
    out_tokens = np.zeros((B, O), np.int32)
    out_len = np.zeros(B, np.int32)
    behavior = np.zeros((B, O), np.float32)
    weight = np.zeros(B, np.float32)
    for i, (t, w, _a) in enumerate(kept):
        p, o = t["prompt"], t["tokens"][:O]
        lp = t["logprobs"][: len(o)]
        tokens[i, : len(p)] = p
        tokens[i, len(p) : len(p) + len(o)] = o
        prompt_len[i] = len(p)
        out_tokens[i, : len(o)] = o
        out_len[i] = len(o)
        behavior[i, : len(lp)] = lp
        weight[i] = w
    # a NaN behavior logprob marks a token whose sampling density is
    # UNKNOWN (failover-resumed prefix, scheduler.py contract): such
    # tokens are EXCLUDED from the loss via token_mask — zero-filling
    # alone would score them as behavior-probability 1
    token_mask = np.isfinite(behavior).astype(np.float32)
    return SampleBatch(
        tokens=tokens,
        prompt_len=prompt_len,
        out_tokens=out_tokens,
        out_len=out_len,
        behavior_logp=np.nan_to_num(behavior, nan=0.0),
        token_mask=token_mask,
        advantage=advantages.astype(np.float32),
        weight=weight,
        temperature=np.full(B, temperature, np.float32),
        top_k=np.full(B, top_k, np.int32),
        top_p=np.full(B, top_p, np.float32),
    )


# ---------------------------------------------------------------------------
# config + driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RLHFConfig:
    """Knobs for one async RLHF run. ``model_cfg`` is the policy's
    ``GPTConfig`` (shared by learner and rollout engines); ``prompts``
    cycle round-robin onto workers; ``reward_fn(prompt, tokens) ->
    float`` scores a finished trajectory on the driver."""

    model_cfg: object = None
    engine_config: object = None
    prompts: list = None
    reward_fn: Callable = None
    # rollout plane
    num_rollout_workers: int = 1
    remote_rollouts: bool = True
    rollout_inflight: int = 8      # in-flight requests to hold per worker
    max_tokens: int = 8
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    num_cpus_per_worker: float = 1
    num_gpus_per_worker: float = GPU_SHARE   # on the card (device None)
    warmup: bool = True
    # learner plane
    train_batch: int = 16          # trajectories per update
    lr: float = 1e-2
    grad_clip: Optional[float] = 1.0
    clip_param: float = 0.2
    kl_coeff: float = 0.0
    remote_learner: bool = False
    # staleness policy
    max_staleness: int = 4
    staleness_mode: str = "drop"   # "drop" | "downweight"
    staleness_halflife: float = 1.0
    # plumbing
    buffer_capacity: int = 512
    chunk_bytes: int = 8 << 20
    batch_timeout_s: float = 120.0
    poll_interval_s: float = 0.005
    sync_ack_timeout_s: float = 60.0
    seed: int = 0
    #: learner and rollout engines (None: the card; "cpu": the CPU)
    device: Optional[str] = None

    def validate(self) -> "RLHFConfig":
        if self.model_cfg is None:
            raise ValueError("model_cfg is required")
        if not self.prompts:
            raise ValueError("prompts must be a non-empty list of token lists")
        if self.reward_fn is None:
            raise ValueError("reward_fn is required")
        if self.max_tokens < 1 or self.train_batch < 1:
            raise ValueError("max_tokens and train_batch must be >= 1")
        if self.staleness_mode not in ("drop", "downweight"):
            raise ValueError(f"unknown staleness mode {self.staleness_mode!r}")
        return self


class Algorithm:
    """``rlhf.Algorithm`` — build once, ``train(n)`` for n async
    iterations, ``shutdown()``. See the module doc for the loop shape."""

    def __init__(self, config: RLHFConfig):
        self.config = config.validate()
        cfg = self.config
        self._version = 0
        self._stop = threading.Event()
        self._buffer = TrajectoryBuffer(cfg.buffer_capacity)
        self._prompt_i = 0
        self._pending_acks: list = []   # (version, ack refs) awaiting harvest
        self._last_batch_versions: list[int] = []
        # fixed learner shapes: every batch is padded to these
        self._T = max(len(p) for p in cfg.prompts) + cfg.max_tokens
        self._O = cfg.max_tokens
        if getattr(cfg.model_cfg, "seq_len", self._T) < self._T:
            raise ValueError(
                f"model seq_len {cfg.model_cfg.seq_len} < prompt+max_tokens "
                f"{self._T}"
            )

        self.learner_group = make_learner_group(
            cfg.model_cfg, lr=cfg.lr, grad_clip=cfg.grad_clip,
            clip_param=cfg.clip_param, kl_coeff=cfg.kl_coeff,
            seed=cfg.seed, remote=cfg.remote_learner,
            device=cfg.device,
        )
        self.rollouts = RolloutGroup(
            num_workers=cfg.num_rollout_workers,
            worker_kwargs=dict(
                model="gpt", model_cfg=cfg.model_cfg,
                engine_config=cfg.engine_config, seed=cfg.seed,
                sample_seed_base=cfg.seed, warmup=cfg.warmup,
                device=cfg.device,
            ),
            remote=cfg.remote_rollouts,
            num_cpus=cfg.num_cpus_per_worker,
            num_gpus=cfg.num_gpus_per_worker,
        )
        try:
            # version 0 = the learner's init, everywhere: push synchronously
            # ONCE before any trajectory exists (startup is the one moment
            # draining is free), then never block on a push again
            update0 = publish_weights(
                self.learner_group.weights_view(), 0, chunk_bytes=cfg.chunk_bytes
            )
            self._await_acks(self.rollouts.push_weights(update0), 0)
            # prime every worker to its in-flight target, then keep it
            # there from the poller
            for i in range(self.rollouts.num_workers):
                self._refill(i, cfg.rollout_inflight)
        except BaseException:
            # a failed bring-up must not orphan N rollout actors (the
            # caller never gets a handle to shutdown())
            self.rollouts.shutdown()
            self.learner_group.shutdown()
            raise
        self._poller = threading.Thread(
            target=self._poll_loop, name="rlhf-poller", daemon=True
        )
        self._poller.start()

    # -- rollout-side plumbing (poller thread) ------------------------------

    def _next_prompts(self, n: int) -> list:
        ps = []
        for _ in range(n):
            ps.append(self.config.prompts[self._prompt_i % len(self.config.prompts)])
            self._prompt_i += 1
        return ps

    def _refill(self, worker_idx: int, missing: int) -> None:
        if missing <= 0:
            return
        cfg = self.config
        self.rollouts.submit_to(
            worker_idx, self._next_prompts(missing),
            max_tokens=cfg.max_tokens, temperature=cfg.temperature,
            top_k=cfg.top_k, top_p=cfg.top_p,
        )

    def _harvest_acks(self) -> None:
        """Reap weight-push acks that are ALREADY done (zero timeout —
        the overlap contract means the learner NEVER blocks on a push; a
        hung worker's ack simply stays pending until the >4 backlog cap
        drops it with a warning, and the staleness gauge/SLO rule is the
        systemic alarm). Called ONLY from the train_step caller thread
        (pushes originate there too) — keeping every ``_pending_acks``
        mutation on one thread is what makes the bookkeeping race-free;
        a poller-side reap would let a wholesale reassignment here drop
        an entry train_step just appended."""
        if not self._pending_acks or not self.config.remote_rollouts:
            self._pending_acks = []
            return
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import GetTimeoutError

        remaining = []
        for version, refs in self._pending_acks:
            try:
                ray_tpu_torch.get(refs, timeout=0)
            except GetTimeoutError:
                remaining.append((version, refs))  # still applying
            except Exception as e:
                # resolved WITH an error (dead worker, version mismatch):
                # surface it and retire the entry — retrying a settled
                # failure would never succeed
                warn_throttled("rlhf sync ack", e)
        self._pending_acks = remaining

    def _poll_loop(self) -> None:
        cfg = self.config
        while not self._stop.is_set():
            try:
                trajs, pending = self.rollouts.poll()
                scored = []
                for t in trajs:
                    # poll() is destructive (the worker already forgot
                    # these), so one bad trajectory must cost ONLY itself
                    # — a raising reward_fn (0-token deadline finish, a
                    # tokenizer hiccup) never discards the whole harvest
                    try:
                        t["reward"] = float(cfg.reward_fn(t["prompt"], t["tokens"]))
                        scored.append(t)
                    except Exception as e:
                        warn_throttled("rlhf reward_fn", e)
                if scored:
                    self._buffer.add(scored)
                for i, p in enumerate(pending):
                    self._refill(i, cfg.rollout_inflight - p)
            except Exception as e:
                if self._stop.is_set():
                    return
                # a dead worker or a flaky poll must be VISIBLE, and must
                # not kill the loop that would otherwise starve training
                warn_throttled("rlhf poll loop", e)
            self._stop.wait(cfg.poll_interval_s)

    # -- learner side (caller thread) ---------------------------------------

    def train_step(self) -> dict:
        """One async iteration: consume a batch (blocking until staged),
        gate staleness, update, publish version+1, fan out. Generation
        continues throughout on the rollout actors."""
        cfg = self.config
        m = rlhf_metrics()
        t0 = time.perf_counter()
        trajs = self._buffer.take(cfg.train_batch, timeout=cfg.batch_timeout_s)
        if not trajs:
            return {"skipped": True, "reason": "no trajectories staged",
                    "weights_version": self._version}
        ages = [self._version - (t["weights_version"] or 0) for t in trajs]
        weights = staleness_weights(
            ages, cfg.max_staleness, cfg.staleness_mode, cfg.staleness_halflife
        )
        kept = [(t, w, a) for t, w, a in zip(trajs, weights, ages) if w > 0]
        dropped = len(trajs) - len(kept)
        if dropped:
            m["stale_dropped"].inc(dropped)
        if not kept:
            m["staleness"].set(float(np.mean(ages)))
            return {"skipped": True, "reason": "all trajectories stale",
                    "dropped_stale": dropped, "weights_version": self._version}
        mean_age = float(np.mean([a for _, _, a in kept]))
        m["staleness"].set(mean_age)
        self._last_batch_versions = [
            t["weights_version"] or 0 for t, _, _ in kept
        ]

        rewards = np.asarray([t["reward"] for t, _, _ in kept], np.float32)
        m["reward"].set(float(rewards.mean()))
        batch = self._build_batch(kept, group_advantages(rewards))
        metrics = self.learner_group.update(batch)
        self._version += 1
        m["learner_steps"].inc()

        # publish + fan out WITHOUT waiting (overlap contract); settled
        # acks are reaped non-blockingly, the backlog cap bounds the rest
        self._harvest_acks()
        update = publish_weights(
            self.learner_group.weights_view(), self._version,
            chunk_bytes=cfg.chunk_bytes,
        )
        self._pending_acks.append(
            (self._version, self.rollouts.push_weights(update))
        )
        if len(self._pending_acks) > 4:
            # a dead worker's ack never resolves; dropping the oldest
            # bounds the debt (the push itself is idempotent per version
            # and the next one supersedes it) — visibly, not silently
            stale_v, _ = self._pending_acks.pop(0)
            warn_throttled(
                "rlhf sync ack backlog",
                RuntimeError(f"dropping unharvested ack for v{stale_v}"),
            )

        out = {
            "weights_version": self._version,
            "mean_reward": float(rewards.mean()),
            "trajectories": len(kept),
            "dropped_stale": dropped,
            "mean_staleness": mean_age,
            "step_s": round(time.perf_counter() - t0, 4),
            **{f"learner/{k}": v for k, v in metrics.items()},
        }
        _events.record(
            "rlhf.learner.step", version=self._version,
            trajectories=len(kept), dropped_stale=dropped,
            mean_reward=round(float(rewards.mean()), 5),
            mean_staleness=round(mean_age, 3),
            loss=round(float(metrics.get("loss", 0.0)), 6),
            step_s=out["step_s"],
        )
        return out

    def _build_batch(self, kept: list, advantages: np.ndarray) -> SampleBatch:
        cfg = self.config
        return build_batch(kept, advantages, self._T, self._O,
                           cfg.temperature, cfg.top_k, cfg.top_p)

    def train(self, iterations: int) -> list[dict]:
        return [self.train_step() for _ in range(iterations)]

    # -- bookkeeping --------------------------------------------------------

    @property
    def weights_version(self) -> int:
        return self._version

    def _await_acks(self, acks, version: int) -> None:
        if self.config.remote_rollouts:
            import ray_tpu_torch

            got = ray_tpu_torch.get(list(acks), timeout=self.config.sync_ack_timeout_s)
        else:
            got = list(acks)  # local push already applied synchronously
        for v in got:
            if v != version:
                raise RuntimeError(
                    f"worker acked weight version {v}, pushed {version}"
                )

    def stats(self) -> dict:
        return {
            "weights_version": self._version,
            "buffer": self._buffer.stats(),
            "pending_acks": len(self._pending_acks),
            "last_batch_versions": list(self._last_batch_versions),
        }

    def shutdown(self) -> None:
        self._stop.set()
        if self._poller.is_alive():
            self._poller.join(timeout=5.0)
        self.rollouts.shutdown()
        self.learner_group.shutdown()
