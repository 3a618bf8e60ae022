#!/usr/bin/env python3
"""Mutation check of chip_smoke.py phase 17's gradient limit, on one GPU.

    python3 chip_mutants.py      # from the repository root, one NVIDIA H100

Phase 17 holds step 0's qkv weight gradients through K3-K5 against the
einsum attention's at the 406M training shape, within ``QKV_GRAD_GAP``.
This script shows that the limit separates right kernels from broken ones:
it builds three copies of ``ray_tpu_torch/ops/csrc/flash_attention.cu``, each
with one kernel's causal mask removed (K3, K4, K5 in turn), into
``ray_tpu_torch/_build/mutants/``, and prints the gap and the step-0 loss
difference for the real kernels and for each copy. Exits non-zero when the
real kernels are outside the limit or a copy is inside it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs
from ray_tpu_torch.models.gpt import gpt_init
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops import flash_attention as fa

# each copy: the line that masks the diagonal tile of the bf16 kernel the
# 406M step runs, and what replaces it
MUTANTS = {
    "K3 without its causal mask": (
        "if (8 * (i >> 2) + 2 * t + (i & 1) > r0 + g + 8 * ((i >> 1) & 1)) s[i] = -INFINITY;", ""),
    "K4 without its causal mask": (
        "if (8 * (i >> 2) + 2 * t + (i & 1) > r0 + g + 8 * ((i >> 1) & 1)) p[i] = 0.f;  // key > query", ""),
    "K5 without its causal mask": (
        "if ((diag && key > qc) || q0 + qc >= seq) pt[e] = 0.f;",
        "if (q0 + qc >= seq) pt[e] = 0.f;"),
}


def edited_source(edits, name: str = "flash_attention") -> str:
    """``csrc/<name>.cu`` with each (old, new) of ``edits`` replaced; each
    old text must occur exactly once."""
    text = (_kernels.CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise AssertionError(f"{old!r} is not in {name}.cu once")
        text = text.replace(old, new)
    return text


def build_sources(sources: dict, subdir: str) -> dict:
    """One nvcc per CUDA source text, all started together, into
    ``ray_tpu_torch/_build/<subdir>/``: {name: (library path, the
    compiler's output with its -Xptxas -v report)}."""
    out = _kernels.BUILD_DIR / subdir
    out.mkdir(parents=True, exist_ok=True)

    def build(item):
        i, (name, text) = item
        cu, so = out / f"{subdir}_{i}.cu", out / f"{subdir}_{i}.so"
        cu.write_text(text)
        cmd = [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(so), str(cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{proc.stdout}{proc.stderr}")
        return name, (so, proc.stdout + proc.stderr)

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(build, enumerate(sources.items())))


def build_mutants() -> dict:
    """{name: library path} of each copy."""
    built = build_sources({name: edited_source([edit]) for name, edit in MUTANTS.items()}, "mutants")
    return {name: so for name, (so, _) in built.items()}


def use_library(path) -> None:
    """Route the flash wrappers to the library at ``path``."""
    fa._kernel_fn.cache_clear()
    _kernels._loaded["flash_attention"] = ctypes.CDLL(str(path))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libraries = {"real kernels": _kernels.build("flash_attention"), **build_mutants()}
    cfg = cs.TRAIN_406M
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.from_numpy(
        np.random.RandomState(13).randint(0, cfg.vocab_size, (cs.TRAIN_B, cfg.seq_len + 1))).cuda()
    xla_loss, xla_grads = cs.qkv_grads(
        dataclasses.replace(cfg, attn_impl="xla", remat_policy="full"), params, tokens)
    print(f"card: {cs.card_line()}; 406M step 0, batch {cs.TRAIN_B}, bf16; limit {cs.QKV_GRAD_GAP}")
    ok = True
    for name, path in libraries.items():
        use_library(path)
        loss, grads = cs.qkv_grads(cfg, params, tokens)
        gaps = cs.qkv_grad_gaps(grads, xla_grads, cfg.d_model)
        inside = all(g <= cs.QKV_GRAD_GAP for g in gaps.values())
        ok &= inside == (name == "real kernels")
        print(f"{name}: largest relative qkv gradient gap over layers "
              + ", ".join(f"{n} {g:.4g}" for n, g in gaps.items())
              + f" ({'inside' if inside else 'outside'} the limit); loss {loss:.6f} vs xla "
              f"{xla_loss:.6f} (difference {abs(loss - xla_loss):.3g})")
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
