"""The port stands alone: ray_tpu_torch and the chip scripts (chip_smoke.py,
chip_mutants.py, chip_flash_probe.py) import nothing of JAX or of the JAX package, and the port's entry points never fall back to
the CPU when the card is missing."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ray_tpu"}


def _port_files():
    chip = ("chip_smoke.py", "chip_mutants.py", "chip_flash_probe.py")
    return sorted((REPO / "ray_tpu_torch").rglob("*.py")) + [REPO / name for name in chip]


def _imported_top_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = [
        f"{p.relative_to(REPO)}:{line} imports {name}"
        for p in files
        for line, name in _imported_top_names(p)
        if name in FORBIDDEN
    ]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, ray_tpu_torch, ray_tpu_torch.llm.engine, ray_tpu_torch.ops._kernels\n"
        "import ray_tpu_torch.models.gpt, ray_tpu_torch.parallel\n"
        "import ray_tpu_torch.llm.watchdog, ray_tpu_torch.util.metrics, ray_tpu_torch.util.phases\n"
        "import ray_tpu_torch.util.tracing, ray_tpu_torch._private.events, ray_tpu_torch.exceptions\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_engine_without_device_needs_cuda(monkeypatch):
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models.gptj import GPTJConfig, gptj_init, params_from_jax

    cfg = GPTJConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2, rotary_dim=2, dtype="float32")
    params = gptj_init(cfg, torch.Generator().manual_seed(0), "cpu")
    # the reference's tree layout: stacked L axis, kernels (in, out)
    tree = {
        "embed": {"tokens": params.embed.weight.numpy()},
        "blocks": {
            "ln1": {"scale": params.blocks[0].ln1.scale[None].numpy(),
                    "bias": params.blocks[0].ln1.bias[None].numpy()},
            **{n: {"kernel": getattr(params.blocks[0], n).weight.T[None].numpy()}
               for n in ("q", "k", "v", "attn_out")},
            **{n: {"kernel": getattr(params.blocks[0], n).weight.T[None].numpy(),
                   "bias": getattr(params.blocks[0], n).bias[None].numpy()}
               for n in ("mlp_in", "mlp_out")},
        },
        "ln_f": {"scale": params.ln_f.scale.numpy(), "bias": params.ln_f.bias.numpy()},
        "lm_head": {"kernel": params.lm_head.weight.T.numpy(), "bias": params.lm_head.bias.numpy()},
    }
    if not torch.cuda.is_available():
        for make in (lambda: LLMEngine(cfg, params),
                     lambda: gptj_init(cfg, torch.Generator()),
                     lambda: params_from_jax(tree, cfg)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(cfg, params, device="cuda:0")
    # a speculating engine is ported: it too needs the card, and says so
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(cfg, params, EngineConfig(spec_k=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gptj_init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree, cfg)
    assert LLMEngine(cfg, params, device="cpu").device == torch.device("cpu")
    # asked for the CPU, both entry points build real weights there
    again = params_from_jax(tree, cfg, "cpu")
    for (name, a), b in zip(params.named_parameters(), again.parameters()):
        assert b.device.type == "cpu" and torch.equal(a, b), name


def test_gptj_init_refuses_a_generator_on_another_device(monkeypatch):
    """A CPU generator for a model on the card is refused before anything
    is allocated (the card itself is faked: the check comes first)."""
    from ray_tpu_torch.models.gptj import GPTJConfig, gptj_init

    cfg = GPTJConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2, rotary_dim=2, dtype="float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="generator is on cpu"):
        gptj_init(cfg, torch.Generator().manual_seed(0))


def test_spec_engine_on_the_card_refuses_windows_the_kernel_lacks(monkeypatch):
    """The verify kernel takes its window at run time, so on the card no
    spec_k is refused for its window: spec_k = 15 (a window of 16, past the
    first kernel's widest of 8) and 16 (past one 16-row query tile) pass the
    window checks and stop only at the CPU weights (the card is faked: the
    device check comes before anything is allocated). The CPU path takes
    them too."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models.gptj import GPTJConfig, gptj_init

    cfg = GPTJConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2, rotary_dim=2, dtype="float32")
    params = gptj_init(cfg, torch.Generator().manual_seed(0), "cpu")
    for k in (15, 16):
        assert LLMEngine(cfg, params, EngineConfig(spec_k=k), device="cpu")._drafter is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for k in (15, 16):
        with pytest.raises(ValueError, match="params are on cpu"):
            LLMEngine(cfg, params, EngineConfig(spec_k=k))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from ray_tpu_torch.ops import _kernels

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.nvcc_path()


def test_training_entry_points_without_device_need_cuda(monkeypatch):
    from ray_tpu_torch.models.gpt import GPTConfig, gpt_init
    from ray_tpu_torch.parallel import adamw, build_train_step

    cfg = GPTConfig(vocab_size=16, seq_len=8, d_model=8, n_layers=1, n_heads=2, dtype="float32")
    params = gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    init_fn, _ = build_train_step(lambda p, t: p.embed.weight.sum(), adamw(1e-4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt_init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_fn(params)
    state = init_fn(params, "cpu")
    assert state.step == 0 and all(p.device.type == "cpu" for p in state.params.parameters())


def test_flash_on_a_card_raises_for_a_head_dim_the_kernels_lack(monkeypatch):
    """Tensors that say they are on the card take the kernel path: a head dim
    of 256 raises there and never falls back to the plain version."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.attention import causal_attention

    q = torch.zeros(1, 2, 16, 256)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for run in (lambda: fa.flash_attention(q, q, q), lambda: causal_attention(q, q, q),
                lambda: causal_attention(q, q, q, impl="flash")):
        with pytest.raises(ValueError, match="head_dim in"):
            run()
    assert fa.flash_fwd_cuda.launches == 0


def test_engine_refuses_the_training_gpt():
    """The engine serves the dense GPT (capped at its positional table) and
    refuses a mixture-of-experts one, as the reference's runner does."""
    import dataclasses

    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.models.gpt import GPTConfig, gpt_init

    cfg = GPTConfig(vocab_size=16, seq_len=8, d_model=8, n_layers=1, n_heads=2, dtype="float32")
    params = gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert LLMEngine(cfg, params, device="cpu").max_model_len == cfg.seq_len
    with pytest.raises(NotImplementedError, match="dense GPT only"):
        LLMEngine(dataclasses.replace(cfg, n_experts=4), params, device="cpu")
