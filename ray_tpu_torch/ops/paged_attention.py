"""Paged attention over a block-table KV cache (port of
``ray_tpu/ops/paged_attention.py``): decode and chunked prefill.

The engine's KV cache is a fixed pool of physical blocks per layer

    k_pool, v_pool : (num_blocks, heads, block_size, head_dim)

and each decode slot owns a block table mapping its logical block index
to a physical block id.

Two entry points:

* ``paged_attention`` — one query per slot (the decode step), dispatching
  between the hand-written CUDA kernel (``csrc/paged_attention.cu``) and
  the plain PyTorch version ``paged_attention_torch``:

  - ``impl="auto"``: the kernel for a CUDA tensor (raising for a dtype or
    shape it does not take), the plain version for a CPU tensor;
  - ``impl="cuda"``: the kernel, whatever the device (a CPU tensor raises);
  - ``impl="torch"``: the plain version (tests and the chip check use it
    as the reference).

* ``paged_prefill_attention_torch`` — chunked prefill for ONE sequence.
  The reference computes it in XLA outside any Pallas kernel, so it has no
  kernel here either.

Padding contract: table entries past a sequence's allocation must point
at a valid physical block (the engine pads with block 0, its reserved
trash block); masking by ``lengths``/``positions`` makes their values
irrelevant. A slot with ``length == 0`` produces finite output (never
NaN) that callers discard.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch.ops import _kernels

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def paged_attention_torch(q, k_pool, v_pool, block_tables, lengths):
    """q: (slots, heads, d); pools: (num_blocks, heads, block, d);
    block_tables: (slots, tmax) int32; lengths: (slots,) int32 — valid
    cache positions per slot (new token's k/v already written).
    Returns (slots, heads, d) in q.dtype, fp32 softmax accumulation."""
    s, h, d = q.shape
    scale = d**-0.5
    idx = block_tables.long()
    k = k_pool[idx].transpose(1, 2).reshape(s, h, -1, d)  # (slots, heads, tmax*block, d)
    v = v_pool[idx].transpose(1, 2).reshape(s, h, -1, d)
    logits = torch.einsum("shd,shkd->shk", q.float(), k.float()) * scale
    mask = torch.arange(k.shape[2], device=q.device)[None, None, :] < lengths.long()[:, None, None]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("shk,shkd->shd", probs, v.float()).to(q.dtype)


def paged_prefill_attention_torch(q, k_pool, v_pool, block_table, positions):
    """Chunked-prefill attention for ONE sequence: each chunk query at
    ``positions[i]`` attends causally over the sequence's paged cache
    (chunk k/v already scattered in). q: (chunk, heads, d); block_table:
    (tmax,) int32; positions: (chunk,) int. Returns (chunk, heads, d)."""
    c, h, d = q.shape
    scale = d**-0.5
    idx = block_table.long()
    k = k_pool[idx].transpose(0, 1).reshape(h, -1, d)  # (heads, tmax*block, d)
    v = v_pool[idx].transpose(0, 1).reshape(h, -1, d)
    logits = torch.einsum("chd,hkd->chk", q.float(), k.float()) * scale
    mask = torch.arange(k.shape[1], device=q.device)[None, None, :] <= positions.long()[:, None, None]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("chk,hkd->chd", probs, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/paged_attention.cu)
# ---------------------------------------------------------------------------

#: head dims the kernel is compiled for (GPT-J's 256), and its dtypes
#: (code passed to C)
KERNEL_HEAD_DIMS = (256,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _decode_fn():
    """The kernel's C entry point; ``_kernels.load`` serializes the build."""
    fn = _kernels.load("paged_attention").paged_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_args(q, k_pool, v_pool, block_tables, lengths):
    tensors = dict(q=q, k_pool=k_pool, v_pool=v_pool, block_tables=block_tables, lengths=lengths)
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"paged decode kernel needs CUDA tensors; {name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged decode kernel needs contiguous {name}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged decode kernel takes float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} differ from q {q.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    s, h, d = q.shape
    _, ph, _, pd = k_pool.shape
    if (ph, pd) != (h, d):
        raise ValueError(f"pool heads/head_dim {(ph, pd)} differ from q {(h, d)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged decode kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    if block_tables.dim() != 2 or block_tables.shape[0] != s or tuple(lengths.shape) != (s,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / lengths {tuple(lengths.shape)} "
            f"do not match {s} slots"
        )


def paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths):
    """The hand-written decode kernel; same contract as
    ``paged_attention_torch``. Builds the kernel on first use. Launches on
    the current stream; ``paged_attention_cuda.launches`` counts launches."""
    _check_kernel_args(q, k_pool, v_pool, block_tables, lengths)
    s, h, d = q.shape
    num_blocks, _, block_size, _ = k_pool.shape
    out = torch.empty_like(q)
    if s == 0:
        return out
    fn = _decode_fn()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            s, h, d, num_blocks, block_size, block_tables.shape[1],
            d**-0.5, _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed with CUDA error {err}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def paged_attention(q, k_pool, v_pool, block_tables, lengths, impl: str = "auto"):
    """Single-position attention over a paged KV cache (module doc).

    q: (slots, heads, head_dim); k_pool/v_pool: (num_blocks, heads,
    block_size, head_dim); block_tables: (slots, tmax) int32; lengths:
    (slots,) int32. ``impl``: auto | cuda | torch."""
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(
            f"unknown paged attention impl {impl!r}; expected 'auto', 'cuda' or 'torch'"
        )
    if impl == "torch" or (impl == "auto" and not q.is_cuda):
        return paged_attention_torch(q, k_pool, v_pool, block_tables, lengths)
    return paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths)
