"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, beside the JAX package.

The JAX package (``ray_tpu``) is the reference; this package imports
nothing from it and nothing of JAX. Module paths mirror the reference so
each port sits next to its counterpart by name
(``ray_tpu_torch/llm/engine.py`` ↔ ``ray_tpu/llm/engine.py``).

Ported so far:

- the runtime core — ``init, remote, get, put, wait, kill, cancel,
  get_actor, method, nodes, cluster_resources, available_resources,
  shutdown`` over the head, forked workers, the shared-memory object plane
  with its native arena (``_private``, ``_native``), actors, remote
  functions, placement groups and scheduling strategies, ``cluster_utils``,
  ``dag`` and ``experimental.channel``; ``torch.Tensor`` values travel
  out-of-band through the object plane (``_private.serialization``) and
  the card is a ``GPU`` resource (``accelerators.gpu``);
- the paged-KV LLM serving path for GPT and GPT-J — the models
  (``models.gpt``, ``models.gptj``) with their dense decoders, sampling
  (``models.sampling``), paged decode/verify/prefill attention with
  hand-written Hopper kernels for decode and speculative verification
  (``ops.paged_attention``), and the engine with its drafters, weight
  hot-swap, watchdog, deadline-aware shedding and HBM ledger (``llm``);
- Serve (``serve``): deployments, the controller, replicas, handles with
  power-of-two routing and mid-stream failover, ``@serve.batch``,
  multiplexing, the HTTP (asyncio + h11) and gRPC ingresses, and
  ``serve.llm``, which serves the paged engine from ``num_gpus=1``
  replicas; ``_private.chaos`` (worker, replica and controller killers)
  and ``llm.loadgen`` (the open-loop HTTP load harness);
- observability: ``util.metrics``, ``util.tracing``, ``util.phases``,
  ``util.waterfall``, ``util.slo``, ``util.state`` and ``_private.events``,
  their cluster halves included;
- GPT training — the model (``models.gpt``), causal attention with
  hand-written flash forward and backward kernels (``ops.attention``,
  ``ops.flash_attention``), the fused cross-entropy (``ops.fused_ce``) and
  the AdamW train step (``parallel``), on one device or sharded over a
  ``DeviceMesh`` (``parallel``: data, ZeRO-3 and tensor parallelism under a
  rule table, a GPipe pipeline, multislice meshes, the fit proof); GPT-J's
  training loss (``models.gptj.gptj_loss``);
- Train (``train``): ``TorchTrainer`` over a worker group of actors (one
  card each with ``use_gpu``), sessions with ``report``, checkpoints of
  train states, restart from the latest checkpoint after a worker dies,
  ``torch.distributed`` bring-up, and the HuggingFace weight loaders
  (``train.integrations``); host collectives among actors
  (``collective``);
- Data (``data``): lazy datasets on numpy-dict blocks — reads, maps,
  global shuffles, sorts, groupbys, splits and writes run as tasks of the
  runtime, and ``iter_torch_batches`` hands batches to the card; a trainer
  given ``datasets=`` splits a Dataset among its workers;
- Tune (``tune``): ``Tuner``/``tune.run`` over trial actors of the runtime
  — search spaces, searchers (TPE, Optuna), ASHA, the median rule, PBT and
  PB2, checkpoints and experiment state — with trials holding fractional
  GPU shares, and a trainer run as a trial (``as_trainable``).
- RL and RLHF: all of ``rl`` (envs, connectors, RL modules, env runners,
  learners, replay buffers, offline data, multi-agent, and its twelve
  algorithms) and all of ``rlhf`` — rollout engines in actors holding GPU
  shares, versioned weight pushes over the object plane, the GPT learner
  and the async driver;
- operator tooling: ``util.actor_pool``, ``util.queue``, ``util.pubsub``,
  ``util.multiprocessing`` and ``util.check_serialize`` on the runtime; the
  device-step profiler (``util.device_prof``) in the serving runner and
  ``parallel.profile_step_fn``; ``util.grafana`` and ``util.otlp``; the
  ``python -m ray_tpu_torch.obs`` CLI (top, req, series, alerts,
  waterfall, overhead, events, timeline, objects, arena, export,
  attribute); job submission (``job``) and the dashboard (``dashboard``,
  with its static pages). None of them imports torch.
- the autoscaler and the CLI: ``autoscaler`` (``StandardAutoscaler`` and
  ``Monitor``, autoscaler v2's instance state machine and reconciler, the
  fake, GKE and GCE providers over injectable REST transports, the cluster
  config with ``up``/``down``) and ``python -m ray_tpu_torch``
  (``scripts``, ``__main__``: start, up, down, summary, list, timeline,
  grafana, status, stacks, profile, node-stats, job), where ``start
  --head`` registers the host's cards as ``GPU``. None of them imports
  torch.
- durable workflows (``workflow``): ``run``/``resume`` of a ``dag`` graph
  with every finished step checkpointed to storage, continuations, durable
  events and virtual actors (transactions on the head's leased mutex). It
  imports no torch.

ROADMAP.md lists what is still to port.

The runtime API loads eagerly and imports no torch, so a bare runtime
worker (and the forkserver template every worker is forked from) never
imports torch or initialises CUDA; the heavy subpackages (``llm``,
``models``, ``ops``, ``parallel``) and the names they export here load on
first use. Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a missing GPU raises instead of falling back.
"""

from ray_tpu_torch._private.api import (  # noqa: F401
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from ray_tpu_torch._private.runtime import ObjectRef, ObjectRefGenerator  # noqa: F401
from ray_tpu_torch.actor import get_actor, method  # noqa: F401
from ray_tpu_torch import exceptions  # noqa: F401
from ray_tpu_torch.exceptions import OverloadedError  # noqa: F401

__version__ = "0.1.0"

_LAZY_SUBMODULES = {
    "llm", "models", "ops", "parallel", "util", "accelerators",
    "cluster_utils", "dag", "experimental", "serve", "obs", "train", "collective", "data",
    "tune", "rl", "rlhf", "job", "dashboard", "workflow",
}

#: names exported from the heavy subpackages, loaded on first access
_LAZY_NAMES = {
    **dict.fromkeys(
        ("LOCK_ORDER", "CacheConfig", "EngineConfig", "EngineStalledError",
         "EngineWatchdog", "KVBlockPool", "LLMEngine", "NGramDrafter",
         "SamplingParams", "SmallModelDrafter", "make_drafter"),
        "ray_tpu_torch.llm",
    ),
    **dict.fromkeys(
        ("GPTJ_6B", "GPTJConfig", "gptj_decode", "gptj_forward", "gptj_init",
         "params_from_jax"),
        "ray_tpu_torch.models.gptj",
    ),
    **dict.fromkeys(
        ("GPTConfig", "gpt_decode", "gpt_init", "gpt_loss"), "ray_tpu_torch.models.gpt"
    ),
    "sample_tokens": "ray_tpu_torch.models.sampling",
    **dict.fromkeys(("adamw", "build_train_step"), "ray_tpu_torch.parallel"),
}


def __getattr__(name):
    import importlib

    if name in _LAZY_SUBMODULES:
        mod = importlib.import_module(f"ray_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    if name in _LAZY_NAMES:
        value = getattr(importlib.import_module(_LAZY_NAMES[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | _LAZY_SUBMODULES | set(_LAZY_NAMES))
