"""Model zoo of the port: GPT-J (``gptj``, serving), GPT (``gpt``, training
and serving) and per-token sampling."""

from ray_tpu_torch.models.gpt import (  # noqa: F401
    GPT,
    GPTConfig,
    gpt_decode,
    gpt_forward,
    gpt_hidden,
    gpt_init,
    gpt_loss,
    params_to_numpy,
)
from ray_tpu_torch.models.gptj import GPTJ, GPTJ_6B, GPTJConfig, gptj_decode, gptj_forward, gptj_init  # noqa: F401
from ray_tpu_torch.models.sampling import sample_tokens  # noqa: F401
