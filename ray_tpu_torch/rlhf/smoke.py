"""End-to-end async RLHF smoke (port of ``ray_tpu/rlhf/smoke.py``):
``python -m ray_tpu_torch.rlhf.smoke --device cpu``.

A tiny GPT policy trained against a synthetic reward (fraction of
generated tokens equal to a target id) for a few async iterations, with
the reference's config. Prints ONE JSON line and exits non-zero when any of the
subsystem's contracts fails to hold live:

* ``improved``        — mean reward of the last iterations beats the
  first (the loop actually learns);
* ``overlapped``      — at least one ``rlhf.rollout.finish`` recorder
  event timestamp falls strictly BETWEEN two ``rlhf.learner.step``
  events (generation demonstrably ran while the learner trained);
* ``versions_advanced`` — late consumed batches carry non-zero
  ``weights_version`` stamps (pushes landed on live engines without a
  drain).

The config's GPT has 2 heads of 16: on the card (``device`` None) the
rollout engines' decode kernel K1 and the learner's flash kernels K3-K5
raise their head-dim error, as the port's kernels take head dims 64 and up
(ROADMAP.md §B), so the smoke runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


TARGET = 7


def reward_fn(prompt, tokens) -> float:
    if not tokens:
        return 0.0
    return sum(1 for t in tokens if t == TARGET) / len(tokens)


def run_smoke(
    iterations: int = 12,
    num_workers: int = 2,
    train_batch: int = 16,
    device=None,
) -> dict:
    import ray_tpu_torch
    from ray_tpu_torch._private import events as _events
    from ray_tpu_torch.llm.engine import EngineConfig
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.rlhf import Algorithm, RLHFConfig

    cfg = RLHFConfig(
        model_cfg=GPTConfig(
            vocab_size=32, seq_len=64, d_model=32, n_layers=1, n_heads=2,
            remat=False, fused_loss=False, dtype="float32",
        ),
        engine_config=EngineConfig(
            max_slots=4, num_blocks=64, block_size=4, max_blocks_per_seq=8,
            prefill_chunk=8,
        ),
        prompts=[[1, 2, 3], [3, 2, 1], [2, 2, 2]],
        reward_fn=reward_fn,
        num_rollout_workers=num_workers,
        rollout_inflight=8,
        max_tokens=8,
        temperature=1.0,
        train_batch=train_batch,
        lr=0.1,
        max_staleness=8,
        # freshness over hoarding: generation far outpaces the learner on
        # a tiny model, and a deep buffer would feed it ancient v0 data —
        # drop-oldest at 2 batches keeps consumed staleness ~1 version
        buffer_capacity=2 * train_batch,
        seed=0,
        device=device,
    )
    t0 = time.time()
    from ray_tpu_torch.rl.learner import gpu_share

    # the card's GPUs are found by init() itself; on the CPU there are none
    ray_tpu_torch.init(num_cpus=max(4, num_workers + 2), num_gpus=None if gpu_share(device, 1) else 0)
    algo = Algorithm(cfg)
    try:
        iters = algo.train(iterations)
        stats = algo.stats()
    finally:
        algo.shutdown()

    real = [it for it in iters if not it.get("skipped")]
    rewards = [it["mean_reward"] for it in real]
    first = rewards[0] if rewards else 0.0
    tail = rewards[-3:] if len(rewards) >= 3 else rewards
    improved = bool(tail) and (sum(tail) / len(tail)) > first

    evs = _events.snapshot()
    finishes = [e["ts"] for e in evs if e["type"] == "rlhf.rollout.finish"]
    steps = sorted(e["ts"] for e in evs if e["type"] == "rlhf.learner.step")
    overlapped = (
        len(steps) >= 2
        and any(steps[0] < ts < steps[-1] for ts in finishes)
    )
    versions_advanced = any(v > 0 for v in stats["last_batch_versions"])

    ray_tpu_torch.shutdown()
    return {
        "metric": "rlhf_async_smoke",
        "iterations": len(real),
        "reward_first": round(first, 4),
        "reward_last": round(rewards[-1], 4) if rewards else 0.0,
        "reward_tail_mean": round(sum(tail) / len(tail), 4) if tail else 0.0,
        "improved": improved,
        "overlapped": overlapped,
        "versions_advanced": versions_advanced,
        "final_weights_version": stats["weights_version"],
        "wall_s": round(time.time() - t0, 1),
        "ok": improved and overlapped and versions_advanced,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help='"cpu", or omit for the card')
    rec = run_smoke(device=ap.parse_args(argv).device)
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
