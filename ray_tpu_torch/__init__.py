"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, beside the JAX package.

The JAX package (``ray_tpu``) is the reference; this package imports
nothing from it and nothing of JAX. Module paths mirror the reference so
each port sits next to its counterpart by name
(``ray_tpu_torch/llm/engine.py`` ↔ ``ray_tpu/llm/engine.py``).

Ported so far: the paged-KV LLM serving path for GPT and GPT-J — the models
(``models.gpt``, ``models.gptj``) with their dense decoders, sampling
(``models.sampling``), paged decode/verify/prefill attention with
hand-written Hopper kernels for decode and speculative verification
(``ops.paged_attention``), and the engine with its drafters, weight
hot-swap, watchdog, deadline-aware shedding and HBM ledger (``llm``) and
its process-local observability (``util.metrics``, ``util.tracing``,
``util.phases``, ``_private.events``); and GPT training on one device — the model (``models.gpt``),
causal attention with hand-written flash forward and backward kernels
(``ops.attention``, ``ops.flash_attention``), the fused cross-entropy
(``ops.fused_ce``) and the AdamW train step (``parallel``). ROADMAP.md lists
what is still to port.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; a missing GPU raises instead of falling back.
"""

from ray_tpu_torch.exceptions import OverloadedError  # noqa: F401
from ray_tpu_torch.llm import (  # noqa: F401
    LOCK_ORDER,
    CacheConfig,
    EngineConfig,
    EngineStalledError,
    EngineWatchdog,
    KVBlockPool,
    LLMEngine,
    NGramDrafter,
    SamplingParams,
    SmallModelDrafter,
    make_drafter,
)
from ray_tpu_torch.models.gptj import (  # noqa: F401
    GPTJ_6B,
    GPTJConfig,
    gptj_decode,
    gptj_forward,
    gptj_init,
    params_from_jax,
)
from ray_tpu_torch.models.gpt import GPTConfig, gpt_decode, gpt_init, gpt_loss  # noqa: F401
from ray_tpu_torch.models.sampling import sample_tokens  # noqa: F401
from ray_tpu_torch.parallel import adamw, build_train_step  # noqa: F401
