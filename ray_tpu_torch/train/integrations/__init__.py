"""Framework integrations for ray_tpu_torch.train (copy of
``ray_tpu/train/integrations/``): the HuggingFace weight loaders.

The reference's ``orbax`` (sharded, async pytree checkpoints) and
``flax_bridge`` (any linen module on the sharded step) wrap JAX libraries.
Their counterparts need the multichip slice's sharding
(``torch.distributed.checkpoint``; an ``nn.Module`` step over FSDP2), so
reaching one of their names raises ``NotImplementedError`` (ROADMAP.md,
queue A8). ``train.save_pytree``/``save_state`` keep one worker's state.
"""

from ray_tpu_torch.train.integrations.huggingface import (  # noqa: F401
    gpt_config_from_hf,
    gptj_config_from_hf,
    load_hf_gpt2,
    load_hf_gptj,
)

#: the reference's names from ``orbax.py`` and ``flax_bridge.py``
_NOT_PORTED = (
    "save_pytree_checkpoint", "load_pytree_checkpoint", "orbax",
    "build_flax_train_step", "flax_sharding_rules", "flax_bridge",
)


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"ray_tpu_torch.train.integrations.{name} is not ported yet (ROADMAP.md, "
            "queue A8: it needs the multichip slice's sharded checkpoints and steps)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
