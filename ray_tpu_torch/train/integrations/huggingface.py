"""HuggingFace transformers interop (copy of
``ray_tpu/train/integrations/huggingface.py``).

Weight-level, as the reference does it: a transformers GPT-2 or GPT-J model
(or its state dict) becomes the port's ``models.gpt.GPT`` or
``models.gptj.GPTJ``. The state dict is first laid out as the reference's
stacked-layer tree of numpy arrays (kernels (in, out)), which the models'
``params_from_jax`` then carries into their modules on ``device`` (the card
unless the caller asks for the CPU). ``transformers`` itself is never
imported here: the caller builds the model.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ray_tpu_torch.models.gpt import GPTConfig, params_from_jax


def gpt_config_from_hf(hf_config: Any, **overrides) -> GPTConfig:
    """Build a ``GPTConfig`` from a ``transformers.GPT2Config``."""
    fields = dict(
        vocab_size=int(hf_config.vocab_size),
        seq_len=int(hf_config.n_positions),
        d_model=int(hf_config.n_embd),
        n_layers=int(hf_config.n_layer),
        n_heads=int(hf_config.n_head),
    )
    fields.update(overrides)
    return GPTConfig(**fields)


def _np(t) -> np.ndarray:
    """torch tensor / array-like -> float32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def load_hf_gpt2(
    model_or_state_dict: Any,
    cfg: Optional[GPTConfig] = None,
    pad_vocab_to_multiple: int = 1,
    device=None,
):
    """Convert a ``transformers`` GPT-2 model (or its state dict) into
    ``(GPTConfig, GPT)`` for ``ray_tpu_torch.models.gpt``, the module on
    ``device``.

    ``pad_vocab_to_multiple=128`` pads the embedding/vocab dimension with
    zero rows (padded ids are never produced by a tokenizer, so logits for
    them are inert).

    Works fully offline: pass ``GPT2LMHeadModel(GPT2Config(...))`` built
    locally, or any mapping of GPT-2 state-dict names to arrays.
    """
    if hasattr(model_or_state_dict, "state_dict"):
        sd = model_or_state_dict.state_dict()
        if cfg is None and hasattr(model_or_state_dict, "config"):
            cfg = gpt_config_from_hf(model_or_state_dict.config)
    else:
        sd = dict(model_or_state_dict)
    # accept both bare GPT2Model ("h.0...") and LMHead ("transformer.h.0...")
    prefix = "transformer." if any(k.startswith("transformer.") for k in sd) else ""

    def get(name):
        return _np(sd[prefix + name])

    wte = get("wte.weight")
    wpe = get("wpe.weight")
    vocab, d = wte.shape
    if cfg is None:
        n_layers = 1 + max(
            int(k.split(".")[1 if not prefix else 2])
            for k in sd
            if ".h." in ("." + k) or k.startswith("h.")
        )
        raise ValueError(
            "pass cfg= or a model with .config (cannot infer n_heads from a "
            f"state dict; saw {n_layers} layers)"
        )
    if pad_vocab_to_multiple > 1:
        target = -(-vocab // pad_vocab_to_multiple) * pad_vocab_to_multiple
        if target != vocab:
            wte = np.concatenate([wte, np.zeros((target - vocab, d), np.float32)])
            import dataclasses

            cfg = dataclasses.replace(cfg, vocab_size=target)
    L = cfg.n_layers

    def stack(name):
        return np.stack([get(f"h.{i}.{name}") for i in range(L)])

    blocks = {
        "ln1": {"scale": stack("ln_1.weight"), "bias": stack("ln_1.bias")},
        "attn_qkv": {"kernel": stack("attn.c_attn.weight"), "bias": stack("attn.c_attn.bias")},
        "attn_out": {"kernel": stack("attn.c_proj.weight"), "bias": stack("attn.c_proj.bias")},
        "ln2": {"scale": stack("ln_2.weight"), "bias": stack("ln_2.bias")},
        "mlp_in": {"kernel": stack("mlp.c_fc.weight"), "bias": stack("mlp.c_fc.bias")},
        "mlp_out": {"kernel": stack("mlp.c_proj.weight"), "bias": stack("mlp.c_proj.bias")},
    }
    params = {
        "embed": {"tokens": wte, "pos": wpe},
        "blocks": blocks,
        "ln_f": {"scale": get("ln_f.weight"), "bias": get("ln_f.bias")},
        # HF ties lm_head to wte (vocab, d); our head is (d, vocab)
        "lm_head": {"kernel": np.ascontiguousarray(wte.T)},
    }
    return cfg, params_from_jax(params, cfg, device)


# ---------------------------------------------------------------------------
# GPT-J (the reference's north-star model: release/air_examples/
# gptj_deepspeed_finetuning). HF GPTJForCausalLM -> models.gptj.GPTJ.
# ---------------------------------------------------------------------------


def gptj_config_from_hf(hf_config: Any, **overrides):
    """Build a ``GPTJConfig`` from a ``transformers.GPTJConfig``."""
    from ray_tpu_torch.models.gptj import GPTJConfig

    fields = dict(
        vocab_size=int(hf_config.vocab_size),
        seq_len=int(hf_config.n_positions),
        d_model=int(hf_config.n_embd),
        n_layers=int(hf_config.n_layer),
        n_heads=int(hf_config.n_head),
        # HF's fallback for rotary_dim=None is rotary over the FULL head —
        # the per-head dim, never n_embd (which would crash _apply_rotary)
        rotary_dim=int(
            getattr(hf_config, "rotary_dim", None)
            or hf_config.n_embd // hf_config.n_head
        ),
    )
    fields.update(overrides)
    return GPTJConfig(**fields)


def load_hf_gptj(
    model_or_state_dict: Any,
    cfg=None,
    pad_vocab_to_multiple: int = 1,
    device=None,
):
    """Convert a ``transformers`` GPT-J model (or state dict) into
    ``(GPTJConfig, GPTJ)`` for ``ray_tpu_torch.models.gptj``, the module on
    ``device``.

    Orientation: HF GPT-J projections are ``nn.Linear`` storing (out, in) —
    the tree's kernels take the reference's (in, out) layout (GPT-2's
    Conv1D did not need this), and ``params_from_jax`` turns them back. No
    q/k/v/out biases (GPT-J has none); the untied lm_head keeps its bias.
    ``pad_vocab_to_multiple=128`` zero-pads vocab rows (50400 -> 50432);
    padded logits get a -1e9 head bias so greedy decode can never emit a
    padded id.
    """
    from ray_tpu_torch.models.gptj import params_from_jax as gptj_params_from_jax

    if hasattr(model_or_state_dict, "state_dict"):
        sd = model_or_state_dict.state_dict()
        if cfg is None and hasattr(model_or_state_dict, "config"):
            cfg = gptj_config_from_hf(model_or_state_dict.config)
    else:
        sd = dict(model_or_state_dict)
    if cfg is None:
        raise ValueError("pass cfg= or a model with .config")
    prefix = "transformer." if any(k.startswith("transformer.") for k in sd) else ""

    def get(name):
        return _np(sd[prefix + name])

    wte = get("wte.weight")
    vocab, d = wte.shape
    lm_w = _np(sd["lm_head.weight"]).T          # (vocab, d) -> (d, vocab)
    lm_b = _np(sd["lm_head.bias"]) if "lm_head.bias" in sd else np.zeros(
        (vocab,), np.float32
    )
    if pad_vocab_to_multiple > 1:
        target = -(-vocab // pad_vocab_to_multiple) * pad_vocab_to_multiple
        if target != vocab:
            import dataclasses

            pad = target - vocab
            wte = np.concatenate([wte, np.zeros((pad, d), np.float32)])
            lm_w = np.concatenate([lm_w, np.zeros((d, pad), np.float32)], axis=1)
            lm_b = np.concatenate([lm_b, np.full((pad,), -1e9, np.float32)])
            cfg = dataclasses.replace(cfg, vocab_size=target)
    L = cfg.n_layers

    def stack(name, transpose=False):
        mats = [_np(sd[f"{prefix}h.{i}.{name}"]) for i in range(L)]
        if transpose:
            mats = [m.T for m in mats]
        return np.stack(mats)

    blocks = {
        "ln1": {"scale": stack("ln_1.weight"), "bias": stack("ln_1.bias")},
        "q": {"kernel": stack("attn.q_proj.weight", transpose=True)},
        "k": {"kernel": stack("attn.k_proj.weight", transpose=True)},
        "v": {"kernel": stack("attn.v_proj.weight", transpose=True)},
        "attn_out": {"kernel": stack("attn.out_proj.weight", transpose=True)},
        "mlp_in": {
            "kernel": stack("mlp.fc_in.weight", transpose=True),
            "bias": stack("mlp.fc_in.bias"),
        },
        "mlp_out": {
            "kernel": stack("mlp.fc_out.weight", transpose=True),
            "bias": stack("mlp.fc_out.bias"),
        },
    }
    params = {
        "embed": {"tokens": wte},
        "blocks": blocks,
        "ln_f": {"scale": get("ln_f.weight"), "bias": get("ln_f.bias")},
        "lm_head": {"kernel": lm_w, "bias": lm_b},
    }
    return cfg, gptj_params_from_jax(params, cfg, device)
