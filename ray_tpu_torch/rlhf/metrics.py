"""rlhf.* metric set (one registration per process; copy of
``ray_tpu/rlhf/metrics.py``).

Same lazy-singleton pattern as ``llm.engine._metrics``: ``util.metrics``
registers globally and duplicate Metric objects for one name would fight
in ``collect()``, so every rlhf module shares this dict.

The staleness gauge is the subsystem's headline health signal: it is the
age (in learner weight versions) of the trajectories the learner is
actually consuming. A healthy async loop hovers at 1-2 (rollouts run one
push behind); a climbing value means weight pushes are not landing
(object-plane backlog, dead rollout actor, learner outrunning
generation) and feeds the ``rlhf-staleness`` default SLO rule
(``util.slo``).
"""

from __future__ import annotations

import threading

#: rlhf metric family — RL012 cross-checks this registry against the
#: constructors in ``rlhf_metrics()`` and the observability docs
METRIC_NAMES = (
    "rlhf_rollout_tokens",
    "rlhf_rollout_trajectories",
    "rlhf_mean_reward",
    "rlhf_sync_seconds",
    "rlhf_sync_bytes",
    "rlhf_weights_version",
    "rlhf_learner_steps",
    "rlhf_weights_staleness",
    "rlhf_stale_dropped_trajectories",
)

_METRICS = None
_LOCK = threading.Lock()


def rlhf_metrics() -> dict:
    global _METRICS
    if _METRICS is not None:
        return _METRICS
    with _LOCK:
        if _METRICS is not None:
            return _METRICS
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        _METRICS = {
            # rollout plane
            "rollout_tokens": Counter(
                "rlhf_rollout_tokens", "tokens generated by rollout engines"
            ),
            "rollout_trajs": Counter(
                "rlhf_rollout_trajectories", "trajectories harvested by the driver"
            ),
            "reward": Gauge(
                "rlhf_mean_reward", "mean reward of the last consumed batch"
            ),
            # weight sync
            "sync_s": Histogram(
                "rlhf_sync_seconds",
                "weight sync latency (phase=push: publish to the object "
                "plane; phase=apply: fetch + engine hot-swap)",
                boundaries=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                            2.5, 5.0, 10.0),
                tag_keys=("phase",),
            ),
            "sync_bytes": Counter(
                "rlhf_sync_bytes", "parameter bytes published to the object plane"
            ),
            "version": Gauge(
                "rlhf_weights_version", "latest version the learner published"
            ),
            # learner plane
            "learner_steps": Counter(
                "rlhf_learner_steps", "async learner update steps"
            ),
            "staleness": Gauge(
                "rlhf_weights_staleness",
                "mean version-age of the trajectories in the last consumed "
                "batch (feeds the rlhf-staleness SLO rule)",
            ),
            "stale_dropped": Counter(
                "rlhf_stale_dropped_trajectories",
                "trajectories rejected by the max-staleness admission gate",
            ),
        }
    return _METRICS
