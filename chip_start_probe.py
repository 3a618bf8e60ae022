#!/usr/bin/env python3
"""What a fresh process pays before it reaches the card, on one GPU.

    python3 chip_start_probe.py      # from the repository root

Each measurement runs in fresh subprocesses, in turns:

1. ``import torch`` and ``import torch, torch._dynamo`` as the environment
   has them (where ``PYTHONDONTWRITEBYTECODE`` is set and the installed
   packages ship no bytecode, every process compiles them from source),
   then with a bytecode cache in a temporary directory: the first process
   writes it, the next ones read it;
2. an empty GPT-124M (``GPTConfig()``, fp32 masters) put on the card the
   way ``nn.Module.to_empty`` does it, against ``device.materialize`` with
   ``models.gptj.embedding`` (``models.gpt._empty_model``), each with the
   modules the step imported (``torch._dynamo``, sympy).

Prints one line per measurement and the card's name and power limit.
Exits non-zero when there is no CUDA device.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time

IMPORTS = {"torch": "import torch", "torch + torch._dynamo": "import torch, torch._dynamo"}

BUILD = r'''
import sys, time, torch
sys.path.insert(0, sys.argv[2])
from torch import nn
from ray_tpu_torch.models.gpt import GPT, GPTConfig, _empty_model
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
heavy = lambda: sorted({m.split(".")[0] if m.startswith("sympy") else m for m in sys.modules
                        if m == "torch._dynamo" or m.startswith("sympy")})
before = heavy()
t0 = time.perf_counter()
if sys.argv[1] == "to_empty":
    with torch.device("meta"):  # nn.Embedding's own init as GPT built it before materialize
        m = GPT(GPTConfig(), device="meta")
        m.embed = nn.Embedding(m.embed.num_embeddings, m.embed.embedding_dim)
        m.pos_embed = nn.Embedding(m.pos_embed.num_embeddings, m.pos_embed.embedding_dim)
    m.to_empty(device="cuda")
else:
    m = _empty_model(GPTConfig(), torch.device("cuda"))
torch.cuda.synchronize()
print(f"{time.perf_counter() - t0:.3f}", ",".join(sorted(set(heavy()) - set(before))) or "-")
'''


def seconds(cmd: list[str], env: dict) -> float:
    t0 = time.perf_counter()
    subprocess.run(cmd, env=env, check=True, capture_output=True)
    return time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_start_probe: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    plain = dict(os.environ)
    cache = tempfile.mkdtemp(prefix="pycache_")
    cached = {k: v for k, v in os.environ.items() if k != "PYTHONDONTWRITEBYTECODE"}
    cached["PYTHONPYCACHEPREFIX"] = cache
    print(f"PYTHONDONTWRITEBYTECODE={os.environ.get('PYTHONDONTWRITEBYTECODE')!r}; torch's package holds "
          f"__pycache__: {os.path.isdir(os.path.join(os.path.dirname(torch.__file__), '__pycache__'))}")
    try:
        for label, code in IMPORTS.items():
            cmd = [sys.executable, "-c", code]
            as_is = [seconds(cmd, plain) for _ in range(2)]
            first = seconds(cmd, cached)
            again = [seconds(cmd, cached) for _ in range(2)]
            print(f"import {label} [{card}]: as the environment has it {as_is[0]:.2f}, {as_is[1]:.2f} s; with a "
                  f"bytecode cache {first:.2f} s writing it, then {again[0]:.2f}, {again[1]:.2f} s reading it")
        for way in ("to_empty", "materialize", "materialize", "to_empty"):
            out = subprocess.run([sys.executable, "-c", BUILD, way, root], env=cached, check=True,
                                 capture_output=True, text=True).stdout.split()
            print(f"empty GPT-124M on the card by {way} [{card}]: {out[0]} s, imported {out[1]}")
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
