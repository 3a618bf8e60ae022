"""Causal flash attention with a blockwise-recompute backward (port of
``ray_tpu/ops/flash_attention.py``).

The forward keeps only ``out`` and the per-row logsumexp ``lse``; the
backward recomputes the scores from them, with ``delta = rowsum(dO * out)``
computed once in fp32. Three hand-written Hopper kernels
(``csrc/flash_attention.cu``) do the work on the card:

* K3 ``flash_fwd_cuda``     — out and lse (the reference's ``_flash_fwd``);
* K4 ``flash_bwd_dq_cuda``  — dq (its ``_dq_kernel``);
* K5 ``flash_bwd_dkv_cuda`` — dk and dv (its ``_dkv_kernel``, no atomics).

``flash_fwd_reference`` and ``flash_bwd_reference`` are their plain PyTorch
versions: the CPU path, and what the kernels are held against on the card.
``FlashAttention`` (the reference's custom-VJP ``_flash_core``) launches the
kernels for CUDA tensors and runs the plain versions for CPU tensors; on the
card there is no fallback, and a head dim or dtype the kernels lack raises.

Kernel operands are ``(bh, seq, head_dim)`` with ``lse`` and ``delta``
``(bh, seq)`` fp32 (the reference's ``(bh, 8, seq)`` lse is a Mosaic tiling
artifact). The reference's block-size sweep knobs (``RAY_TPU_FLASH_*``) tune
the TPU grid and are not ported (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch.ops import _kernels

NEG_INF = -1e30

#: head dims the kernels are compiled for, and their dtypes (code passed to C)
KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: rows of a kernel tile; the grid's second axis counts tiles (at most 65535)
_TILE = 64


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _causal_mask(seq: int, device) -> torch.Tensor:
    return torch.ones(seq, seq, dtype=torch.bool, device=device).tril()


def flash_fwd_reference(q, k, v):
    """q, k, v: (bh, seq, d) → (out (bh, seq, d) in q's dtype, lse (bh, seq)
    fp32). As ``_fwd_kernel``: q scaled in fp32 before the product, scores
    and accumulation in fp32, masked scores at NEG_INF."""
    d = q.shape[-1]
    scale = 1.0 / (d**0.5)
    s = (q.float() * scale) @ k.float().transpose(1, 2)
    s = s.masked_fill(~_causal_mask(q.shape[1], q.device), NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1).clamp_min(1e-30)
    out = (p @ v.float()) / l[..., None]
    return out.to(q.dtype), m + torch.log(l)


def flash_bwd_reference(q, k, v, out, lse, do):
    """Gradients of ``flash_fwd_reference``'s out: (dq, dk, dv) in the
    inputs' dtypes. As ``_flash_bwd``: ``delta = rowsum(do * out)`` in fp32
    from the stored out, ``p = exp(scale * qk - lse)`` under the causal mask,
    ``ds = p * (dp - delta) * scale``."""
    d = q.shape[-1]
    scale = 1.0 / (d**0.5)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    delta = (do32 * out.float()).sum(-1)
    s = scale * (q32 @ k32.transpose(1, 2))
    p = torch.where(_causal_mask(q.shape[1], q.device), torch.exp(s - lse[..., None]), 0.0)
    dp = do32 @ v32.transpose(1, 2)
    ds = p * (dp - delta[..., None]) * scale
    dq = ds @ k32
    dk = ds.transpose(1, 2) @ q32
    dv = p.transpose(1, 2) @ do32
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

_N_POINTERS = {"flash_fwd": 5, "flash_bwd_dq": 7, "flash_bwd_dkv": 8}


@functools.cache
def _kernel_fn(name: str):
    """A kernel's C entry point; ``_kernels.load`` serializes the build."""
    fn = getattr(_kernels.load("flash_attention"), name)
    fn.argtypes = [ctypes.c_void_p] * _N_POINTERS[name] + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def kernel_smem_bytes(name: str, head_dim: int, dtype: torch.dtype) -> int:
    """The dynamic shared memory a launch of kernel ``name`` (``flash_fwd``,
    ``flash_bwd_dq`` or ``flash_bwd_dkv``) requests, as the source computes
    it; builds the library on first use."""
    fn = _kernels.load("flash_attention").flash_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    kind = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv").index(name)
    nbytes = fn(kind, head_dim, _DTYPE_CODE[dtype])
    if nbytes < 0:
        raise ValueError(f"no {name} kernel for head_dim {head_dim}, {dtype}")
    return nbytes


def _check_kernel_args(kernel: str, q, tensors: dict, rows: dict) -> None:
    """q and the other ``tensors`` are (bh, seq, d) of one float dtype and
    start at a 16-byte-aligned address (the kernels copy their rows in
    16-byte pieces), ``rows`` (lse, delta) are (bh, seq) fp32; all
    contiguous on q's CUDA device; d is a compiled head dim. The head dim,
    dtype and alignment are checked first: they are what the kernels lack,
    whatever the device."""
    if q.dim() != 3:
        raise ValueError(f"{kernel} takes (bh, seq, head_dim) operands, got q {tuple(q.shape)}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} takes head_dim in {KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{kernel} takes float32 or bfloat16, got {q.dtype}")
    operands = {"q": q, **tensors, **rows}
    for name, t in operands.items():
        want = (q.shape, q.dtype) if name not in rows else (q.shape[:2], torch.float32)
        if (t.shape, t.dtype) != want:
            raise ValueError(f"{kernel}: {name} is {tuple(t.shape)} {t.dtype}, expected {want}")
        if name not in rows and t.data_ptr() % 16:
            raise ValueError(f"{kernel} needs {name} at a 16-byte-aligned address, got "
                             f"{t.data_ptr():#x}")
    for name, t in operands.items():
        if not t.is_cuda:
            raise ValueError(f"{kernel} needs CUDA tensors; {name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} needs contiguous {name}")
    if -(-q.shape[1] // _TILE) > 65535:
        raise ValueError(f"{kernel} takes seq up to {65535 * _TILE}, got {q.shape[1]}")


def _launch(name: str, *pointers, q) -> None:
    bh, seq, d = q.shape
    with torch.cuda.device(q.device):
        err = _kernel_fn(name)(
            *pointers, bh, seq, d, d**-0.5, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def flash_fwd_cuda(q, k, v):
    """K3: same contract as ``flash_fwd_reference``. Builds the kernel on
    first use and launches on the current stream;
    ``flash_fwd_cuda.launches`` counts launches."""
    _check_kernel_args("flash forward kernel", q, {"k": k, "v": v}, {})
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    _launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), q=q)
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0


def flash_bwd_dq_cuda(q, k, v, do, lse, delta):
    """K4: dq of ``flash_bwd_reference``, given ``delta = rowsum(do * out)``
    (bh, seq) fp32. ``flash_bwd_dq_cuda.launches`` counts launches."""
    _check_kernel_args("flash dq kernel", q, {"k": k, "v": v, "do": do},
                       {"lse": lse, "delta": delta})
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    _launch("flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), q=q)
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta):
    """K5: (dk, dv) of ``flash_bwd_reference``, given delta as for K4.
    ``flash_bwd_dkv_cuda.launches`` counts launches."""
    _check_kernel_args("flash dk/dv kernel", q, {"k": k, "v": v, "do": do},
                       {"lse": lse, "delta": delta})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    _launch("flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), q=q)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


# ---------------------------------------------------------------------------
# autograd and the public op
# ---------------------------------------------------------------------------


class FlashAttention(torch.autograd.Function):
    """Causal attention on (bh, seq, d) with the flash backward. Saves
    ``(q, k, v, out, lse)``; the backward runs K4 then K5 (the plain
    ``flash_bwd_reference`` for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.is_cuda:
            out, lse = flash_fwd_cuda(q, k, v)
        else:
            out, lse = flash_fwd_reference(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if not q.is_cuda:
            return flash_bwd_reference(q, k, v, out, lse, do)
        delta = (do.float() * out.float()).sum(-1)
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal flash attention. q, k, v: (batch, heads, seq, head_dim) →
    (batch, heads, seq, head_dim) in q's dtype; differentiable. On the card
    any seq >= 1 runs through the kernels (they mask the ragged edge
    themselves); a head dim outside ``KERNEL_HEAD_DIMS`` raises."""
    b, h, s, d = q.shape

    def merge(t):
        return t.reshape(b * h, s, d).contiguous()

    out = FlashAttention.apply(merge(q), merge(k), merge(v))
    return out.view(b, h, s, d)
