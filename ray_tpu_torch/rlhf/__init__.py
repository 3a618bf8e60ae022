"""ray_tpu_torch.rlhf: disaggregated async RL-on-LLM (port of
``ray_tpu/rlhf/__init__.py``).

The flagship end-to-end scenario the ROADMAP asked for: the
port's ``llm`` continuous-batching engine becomes the ROLLOUT backend
of an RL loop whose learner lives in the ``rl``/``train``
machinery — generation and learning on separate resources, weight sync
overlapped with generation, staleness-corrected learning (LlamaRL
arXiv:2505.24034, MindSpeed RL arXiv:2507.19017 shapes).

    from ray_tpu_torch import rlhf

    algo = rlhf.Algorithm(rlhf.RLHFConfig(
        model_cfg=tiny_gpt_cfg,
        prompts=[[1, 2, 3]],
        reward_fn=lambda prompt, tokens: tokens.count(7) / len(tokens),
        num_rollout_workers=2,
        temperature=1.0,
        device=None,   # the card; "cpu" for the CPU
    ))
    for it in algo.train(10):
        print(it["weights_version"], it["mean_reward"])
    algo.shutdown()

Pieces (each its own module doc):

* ``rollout``   — actor-hosted engine replicas generating continuously,
  per-token behavior-logprob capture, version-stamped trajectories;
* ``sync``      — versioned weight publication (chunked object-plane
  puts) + between-step engine hot-swap, one code path shared with
  ``serve.llm.LLMDeployment.update_weights``;
* ``learner``   — GPT policy + PPO/GRPO clipped surrogate with exact
  importance correction, hosted in ``rl.learner.LearnerGroup``;
* ``algorithm`` — the async driver, the staleness admission gate, and
  the pure correction math;
* ``buffer``    — the bounded staging buffer between the two planes;
* ``metrics``   — the ``rlhf_*`` metric family (the staleness gauge
  feeds the ``rlhf-staleness`` default SLO rule).

Observability: ``rlhf.rollout.submit/finish``, ``rlhf.sync.push/apply``,
``rlhf.learner.step`` flight-recorder events; ``python -m
ray_tpu_torch.rlhf.smoke --device cpu`` runs the tiny-model async loop end
to end (its head dim of 16 is one the card's kernels do not take, so on the
card it raises their head-dim error).

Importing this package loads no torch: rollout actors and learners import
it where they run, and the runtime's control plane loads it to place them.
"""

from ray_tpu_torch.rlhf.algorithm import (  # noqa: F401
    Algorithm,
    RLHFConfig,
    group_advantages,
    importance_ratios,
    staleness_weights,
)
from ray_tpu_torch.rlhf.buffer import TrajectoryBuffer  # noqa: F401
from ray_tpu_torch.rlhf.learner import (  # noqa: F401
    GPTPolicyModule,
    make_learner_group,
    rlhf_loss,
)
from ray_tpu_torch.rlhf.metrics import rlhf_metrics  # noqa: F401
from ray_tpu_torch.rlhf.rollout import RolloutGroup, RolloutWorker  # noqa: F401
from ray_tpu_torch.rlhf.sync import (  # noqa: F401
    WeightUpdate,
    apply_weight_update,
    fetch_params,
    publish_weights,
)
