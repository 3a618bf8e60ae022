"""ray_tpu_torch.llm: continuous-batching GPT and GPT-J serving over a
paged KV cache, on one CUDA device, with speculative decoding, weight
hot-swap, the watchdog, deadline-aware shedding and the metrics, events,
phase and tracing hooks (port of ``ray_tpu.llm``).

    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams

    engine = LLMEngine(model_cfg, params, EngineConfig(max_slots=8, spec_k=4))
    req = engine.submit(prompt_ids, SamplingParams(max_tokens=64,
                                                   temperature=0.8))
    for tok in engine.stream_tokens(req):   # a loop thread drives step()
        ...
    engine.update_weights(new_params)       # between steps, mid-traffic
    engine.start_watchdog()                 # stall detection, reaping, leak audit
"""

#: Canonical lock order of the serving plane, outermost first. Any code path
#: that holds one of these may only acquire locks FURTHER RIGHT. The
#: watchdog deliberately sits outside the order: it only ever takes the
#: engine lock with a bounded ``acquire(timeout=)`` (which cannot deadlock)
#: and diagnoses wedges through the lock-free liveness beat instead.
LOCK_ORDER = (
    "LLMEngine._lock",       # the step/admission lock
    "PrefixCache._lock",     # radix tree over shared KV blocks
    "KVBlockPool._lock",     # free-list ledger; never calls back up
)

from ray_tpu_torch.llm.cache import CacheConfig, KVBlockPool  # noqa: F401
from ray_tpu_torch.llm.drafter import NGramDrafter, SmallModelDrafter, make_drafter  # noqa: F401
from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine  # noqa: F401
from ray_tpu_torch.llm.prefix_cache import PrefixCache, PrefixMatch  # noqa: F401
from ray_tpu_torch.llm.scheduler import Request, SamplingParams, Scheduler  # noqa: F401
from ray_tpu_torch.llm.watchdog import EngineStalledError, EngineWatchdog  # noqa: F401
