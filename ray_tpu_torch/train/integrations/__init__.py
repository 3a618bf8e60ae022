"""Framework integrations for ray_tpu_torch.train (port of
``ray_tpu/train/integrations/``): the HuggingFace weight loaders, sharded
checkpoints through ``torch.distributed.checkpoint`` (``orbax.py``, named
after the reference's module) and any ``nn.Module`` on the sharded step
(``module_bridge.py``, the reference's ``flax_bridge``).

The reference's flax names belong to a JAX library; reaching one here
raises ``AttributeError`` naming its counterpart.
"""

from ray_tpu_torch.train.integrations.huggingface import (  # noqa: F401
    gpt_config_from_hf,
    gptj_config_from_hf,
    load_hf_gpt2,
    load_hf_gptj,
)
from ray_tpu_torch.train.integrations.module_bridge import (  # noqa: F401
    build_module_train_step,
    module_sharding_rules,
)
from ray_tpu_torch.train.integrations.orbax import (  # noqa: F401
    load_pytree_checkpoint,
    save_pytree_checkpoint,
)

#: the reference's flax names and their counterparts here
_RENAMED = {
    "build_flax_train_step": "build_module_train_step",
    "flax_sharding_rules": "module_sharding_rules",
    "flax_bridge": "module_bridge",
}


def __getattr__(name):
    if name in _RENAMED:
        raise AttributeError(
            f"ray_tpu_torch.train.integrations has no {name!r}: the reference's flax bridge is "
            f"ported for torch modules as {_RENAMED[name]!r}"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
