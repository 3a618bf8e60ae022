"""A bf16 greedy stream cut and resumed by re-prefill, through both
packages' engines: is a resume token-exact in bf16?

Both engines get the reference's GPT-124M weights (``gpt_init``, seed 0;
vocab 50304, seq 1024, d 768, 12 heads of 64) narrowed to 2 layers, in
bf16, with the same two 16-token prompts (numpy seeds 1 and 2). Each
engine generates 32 greedy tokens uninterrupted, then the same request is
submitted again with its first 8 tokens as ``resume_tokens`` (what Serve's
failover sends a fresh replica) and generates the rest from a re-prefill.

Finding (this CPU run): neither package is token-exact in bf16. The
reference's stream for prompt 1 departs from its uninterrupted stream at
output index 19, the port's for prompt 2 at index 28. A re-prefilled
resume computes the resumed tokens' keys and values in one prefill pass,
where the uninterrupted stream computed them one decode step at a time;
bf16 rounds the two differently, and a near-tie in the greedy argmax
flips. So the limit is shared, not a fault of the port, and resume is
token-exact in fp32 only (``tests/test_serve_chaos.py:48`` and
``tests/test_torch_serve_chaos.py:53`` run fp32), which README.md and
ROADMAP.md now say.
"""

import time

import numpy as np
import pytest
import torch

import jax

from ray_tpu.llm import EngineConfig as RefEngineConfig
from ray_tpu.llm import LLMEngine as RefEngine
from ray_tpu.llm import SamplingParams as RefSamplingParams
from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.models.gpt import gpt_init as ref_gpt_init
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models.gpt import GPTConfig, params_from_jax

SHAPE = dict(vocab_size=50304, seq_len=1024, d_model=768, n_layers=2, n_heads=12, dtype="bfloat16")
GEOMETRY = dict(max_slots=2, num_blocks=33, block_size=16, max_blocks_per_seq=16, prefill_chunk=64)
NEW, CUT = 32, 8
PROMPTS = [[int(t) for t in np.random.RandomState(seed).randint(0, SHAPE["vocab_size"], 16)]
           for seed in (1, 2)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Four intra-op threads: the suite runs files in parallel workers. One
    ``torch.exp`` call first: a process's first multi-threaded one can be
    off by up to 1.5e-4 relative on a loaded CPU (ROADMAP.md §C.1), which
    would move the port's near-ties."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    torch.exp(torch.zeros(4, 128, 128))
    yield
    torch.set_num_threads(before)


def _drive(eng, req) -> list:
    while not req.finished:
        if not eng.step():
            time.sleep(0.001)
    return [int(t) for t in req.out]


@pytest.fixture(scope="module")
def streams():
    """package -> [(uninterrupted, resumed) per prompt]."""
    ref_cfg = RefGPTConfig(**SHAPE, remat=False, attn_impl="xla", fused_loss=False)
    tree = jax.device_get(ref_gpt_init(jax.random.PRNGKey(0), ref_cfg))
    engines = {
        "ray_tpu": (RefEngine(ref_cfg, tree, RefEngineConfig(**GEOMETRY)), RefSamplingParams),
        "ray_tpu_torch": (LLMEngine(GPTConfig(**SHAPE), params_from_jax(tree, GPTConfig(**SHAPE), "cpu"),
                                    EngineConfig(**GEOMETRY), device="cpu"), SamplingParams),
    }
    out = {}
    for pkg, (eng, sp) in engines.items():
        out[pkg] = []
        for prompt in PROMPTS:
            full = _drive(eng, eng.submit(prompt, sp(max_tokens=NEW)))
            resumed = _drive(eng, eng.submit(prompt, sp(max_tokens=NEW), resume_tokens=tuple(full[:CUT])))
            out[pkg].append((full, resumed))
    return out


def _first_flip(full, resumed):
    return next((i for i, (a, b) in enumerate(zip(full, resumed)) if a != b), None)


@pytest.mark.parametrize("package", ["ray_tpu", "ray_tpu_torch"])
def test_resume_continues_the_stream(streams, package):
    """What holds in bf16 in both packages: the resumed request finishes at
    the same length, keeps the resumed tokens, and its first new token (the
    argmax of the re-prefill's last logits) is the uninterrupted one's."""
    for full, resumed in streams[package]:
        assert len(full) == len(resumed) == NEW
        assert resumed[:CUT] == full[:CUT]
        flip = _first_flip(full, resumed)
        assert flip is None or flip > CUT


def test_bf16_resume_is_not_token_exact_in_either_package(streams):
    """The finding this file records: each package's resumed streams depart
    from its uninterrupted ones somewhere after the cut (the reference's on
    prompt 1, the port's on prompt 2), so bf16 resume is not token-exact in
    the reference either, and the port's flips are the same limit."""
    flips = {pkg: [_first_flip(full, resumed) for full, resumed in runs]
             for pkg, runs in streams.items()}
    assert any(f is not None for f in flips["ray_tpu"]), flips
    assert any(f is not None for f in flips["ray_tpu_torch"]), flips
