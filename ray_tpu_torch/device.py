"""Device choice for the port's entry points: the card unless the caller
asks for the CPU."""

from __future__ import annotations

import torch
from torch import nn


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device. Asking for CUDA without one raises —
    an entry point never carries on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device available for {dev}: torch.cuda.is_available() is "
                "False (pass device='cpu' to run on the CPU)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def materialize(module: nn.Module, device) -> nn.Module:
    """``module.to_empty(device=device)`` for a module built on the meta
    device: every parameter and buffer becomes an uninitialised tensor on
    ``device``, registered in its place (order, dtype and ``requires_grad``
    kept). ``to_empty`` calls ``torch.empty_like`` on each meta tensor,
    which goes through ``torch._refs`` and, in torch 2.11 with a CUDA
    target, imports sympy: seconds in every fresh process that builds a
    model."""
    for mod in module.modules():
        for name, p in mod._parameters.items():
            if p is not None:
                mod._parameters[name] = nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device=device), p.requires_grad
                )
        for name, b in mod._buffers.items():
            if b is not None:
                mod._buffers[name] = torch.empty(b.shape, dtype=b.dtype, device=device)
    return module
