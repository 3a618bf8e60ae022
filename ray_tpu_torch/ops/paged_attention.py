"""Paged attention over a block-table KV cache (port of
``ray_tpu/ops/paged_attention.py``): decode, speculative verification and
chunked prefill.

The engine's KV cache is a fixed pool of physical blocks per layer

    k_pool, v_pool : (num_blocks, heads, block_size, head_dim)

and each decode slot owns a block table mapping its logical block index
to a physical block id.

Three entry points:

* ``paged_attention`` — one query per slot (the decode step), dispatching
  between the hand-written CUDA kernel (``csrc/paged_attention.cu``) and
  the plain PyTorch version ``paged_attention_torch``:

  - ``impl="auto"``: the kernel for a CUDA tensor (raising for a dtype or
    shape it does not take), the plain version for a CPU tensor;
  - ``impl="cuda"``: the kernel, whatever the device (a CPU tensor raises);
  - ``impl="torch"``: the plain version (tests and the chip check use it
    as the reference).

* ``paged_verify_attention`` — ``w`` consecutive queries per slot (the
  speculative-decode verify step), query ``(s, i)`` attending every cache
  position ``<= positions[s, i]``; the same dispatch between the kernel
  ``csrc/paged_verify_attention.cu`` and ``paged_verify_attention_torch``.

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
import torch.nn.functional as F

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


def decode_partials_torch(q, k_pool, v_pool, block_tables, lengths, split_tokens):
    """The decode kernel's first pass in plain PyTorch: for each (slot,
    head) and each run of ``split_tokens`` cache positions (a split), the
    online-softmax state of the split's live positions. Returns (slots,
    heads, splits, d + 2) fp32: the unnormalised ``sum p v`` in ``[..., :d]``,
    the max logit ``m`` at ``d`` and ``l = sum p`` at ``d + 1``, with
    ``p = exp(logit - m)``. A split with no live position holds m = NEG_INF,
    l = 0 and zeros."""
    s, h, d = q.shape
    scale = d**-0.5
    idx = block_tables.long()
    k = k_pool[idx].transpose(1, 2).reshape(s, h, -1, d).float()  # (slots, heads, tmax*block, d)
    v = v_pool[idx].transpose(1, 2).reshape(s, h, -1, d).float()
    n = k.shape[2]
    splits = -(-n // split_tokens)
    pad = splits * split_tokens - n
    logits = torch.einsum("shd,shkd->shk", q.float(), k) * scale
    live = torch.arange(splits * split_tokens, device=q.device)[None, :] < lengths.long()[:, None]
    live = live[:, None, :].expand(s, h, -1).reshape(s, h, splits, split_tokens)
    logits = F.pad(logits, (0, pad)).reshape(s, h, splits, split_tokens).masked_fill(~live, NEG_INF)
    m = logits.amax(-1)
    p = torch.where(live, torch.exp(logits - m[..., None]), 0.0)
    v = F.pad(v, (0, 0, 0, pad)).reshape(s, h, splits, split_tokens, d)
    acc = torch.einsum("shcn,shcnd->shcd", p, v)
    return torch.cat([acc, m[..., None], p.sum(-1)[..., None]], dim=-1)


def merge_decode_partials_torch(partials, lengths, split_tokens, dtype):
    """The decode kernel's merge in plain PyTorch: combines each (slot,
    head)'s splits that hold a live position (``split * split_tokens <
    length``; the others are never read, whatever they hold) into the
    attention output, (slots, heads, d) in ``dtype``. A slot with length 0
    gives zeros."""
    d = partials.shape[-1] - 2
    splits = partials.shape[2]
    live = torch.arange(splits, device=partials.device)[None, :] * split_tokens < lengths.long()[:, None]
    live = live[:, None, :]  # (slots, 1, splits)
    m = torch.where(live, partials[..., d], NEG_INF)
    w = torch.where(live, torch.exp(m - m.amax(-1, keepdim=True)), 0.0)
    num = (torch.where(live[..., None], partials[..., :d], 0.0) * w[..., None]).sum(-2)
    den = (torch.where(live, partials[..., d + 1], 0.0) * w).sum(-1, keepdim=True)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0).to(dtype)


def paged_verify_attention_torch(q, k_pool, v_pool, block_tables, positions):
    """Multi-query verification attention. q: (slots, w, heads, d); pools:
    (num_blocks, heads, block, d); block_tables: (slots, tmax) int32;
    positions: (slots, w) int32 — the absolute cache position of each query
    (its own k/v already written). Query (s, i) attends every cache
    position ``<= positions[s, i]``, causal across the window because the
    window's positions are consecutive. Returns (slots, w, heads, d) in
    q.dtype, fp32 softmax accumulation."""
    s, w, h, d = q.shape
    scale = d**-0.5
    idx = block_tables.long()
    k = k_pool[idx].transpose(1, 2).reshape(s, h, -1, d)  # (slots, heads, tmax*block, d)
    v = v_pool[idx].transpose(1, 2).reshape(s, h, -1, d)
    logits = torch.einsum("swhd,shkd->swhk", q.float(), k.float()) * scale
    cache_pos = torch.arange(k.shape[2], device=q.device)
    mask = cache_pos[None, None, None, :] <= positions.long()[:, :, None, None]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("swhk,shkd->swhd", probs, v.float()).to(q.dtype)


def verify_partials_torch(q, k_pool, v_pool, block_tables, positions, split_tokens):
    """The verify kernel's first pass in plain PyTorch: for each (slot,
    head), each run of ``split_tokens`` cache positions (a split) and each
    query of the window, the online-softmax state of the split's positions
    that query attends (at or before its position, within the table).
    Returns (slots, heads, splits, w, d + 2) fp32: the unnormalised
    ``sum p v`` in ``[..., :d]``, the max logit ``m`` at ``d`` and ``l = sum
    p`` at ``d + 1``, with ``p = exp(logit - m)``. A query with no attended
    position in a split holds m = NEG_INF, l = 0 and zeros there."""
    s, w, h, d = q.shape
    scale = d**-0.5
    idx = block_tables.long()
    k = k_pool[idx].transpose(1, 2).reshape(s, h, -1, d).float()  # (slots, heads, tmax*block, d)
    v = v_pool[idx].transpose(1, 2).reshape(s, h, -1, d).float()
    n = k.shape[2]
    splits = -(-n // split_tokens)
    pad = splits * split_tokens - n
    logits = torch.einsum("swhd,shkd->shwk", q.float(), k) * scale
    cache_pos = torch.arange(splits * split_tokens, device=q.device)
    live = (cache_pos[None, None, :] <= positions.long()[:, :, None]) & (cache_pos < n)[None, None, :]
    live = live[:, None].expand(s, h, w, -1).reshape(s, h, w, splits, split_tokens).transpose(2, 3)
    logits = F.pad(logits, (0, pad)).reshape(s, h, w, splits, split_tokens).transpose(2, 3)
    logits = logits.masked_fill(~live, NEG_INF)  # (slots, heads, splits, w, split_tokens)
    m = logits.amax(-1)
    p = torch.where(live, torch.exp(logits - m[..., None]), 0.0)
    v = F.pad(v, (0, 0, 0, pad)).reshape(s, h, splits, split_tokens, d)
    acc = torch.einsum("shcwn,shcnd->shcwd", p, v)
    return torch.cat([acc, m[..., None], p.sum(-1)[..., None]], dim=-1)


def merge_verify_partials_torch(partials, positions, split_tokens, dtype):
    """The verify kernel's merge in plain PyTorch: combines each (slot,
    head)'s splits that hold a live position (``split * split_tokens`` below
    the slot's live length ``positions[:, -1] + 1``, capped at the table's
    reach; the others are never read, whatever they hold) into the
    attention output, (slots, w, heads, d) in ``dtype``. A query that
    attends no position gives zeros."""
    d = partials.shape[-1] - 2
    splits = partials.shape[2]
    length = (positions.long()[:, -1] + 1).clamp(max=splits * split_tokens)
    live = torch.arange(splits, device=partials.device)[None, :] * split_tokens < length[:, None]
    live = live[:, None, :, None]  # (slots, 1, splits, 1)
    m = torch.where(live, partials[..., d], NEG_INF)
    wgt = torch.where(live, torch.exp(m - m.amax(2, keepdim=True)), 0.0)
    num = (torch.where(live[..., None], partials[..., :d], 0.0) * wgt[..., None]).sum(2)
    den = (torch.where(live, partials[..., d + 1], 0.0) * wgt).sum(2)[..., None]
    out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return out.transpose(1, 2).to(dtype)  # (slots, heads, w, d) -> (slots, w, heads, d)


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
# CUDA kernels (csrc/paged_attention.cu, csrc/paged_verify_attention.cu)
# ---------------------------------------------------------------------------

#: head dims each kernel is compiled for: the decode kernel 64, 128 and
#: 256 (a row read four elements a lane at a time, by the whole warp at 128
#: and 256, by each half-warp at 64), the verify kernel 64, 128 and 256
#: (each of its four warps owns D/4 columns, whole k16 steps)
DECODE_HEAD_DIMS = (64, 128, 256)
VERIFY_HEAD_DIMS = (64, 128, 256)
#: cache positions either kernel gives one CTA, rounded down to whole
#: blocks (chip_flash_probe.py times 64, 128 and 256 in turns for both, the
#: verify kernel at the verify step's context too; PERF.md)
SPLIT_TOKENS = 128
#: largest (block, head) page either kernel's shared-memory ring takes
#: (``kMaxPageBytes`` in their sources): it holds at least two K/V page pairs
MAX_PAGE_BYTES = 32 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def decode_splits(tmax: int, block_size: int) -> tuple[int, int]:
    """(split_tokens, splits) of the split-context kernels for block tables
    of ``tmax`` entries of ``block_size`` positions: a split is the whole
    number of blocks nearest ``SPLIT_TOKENS`` from below (at least one),
    and the splits cover the whole table. Host-known shapes alone size the
    grid: no length is read on the host, and the launch shape is fixed."""
    pages = max(1, SPLIT_TOKENS // block_size)
    return pages * block_size, -(-tmax // pages)


@functools.cache
def _decode_fn():
    """K1's C entry point; ``_kernels.load`` serializes the build."""
    fn = _kernels.load("paged_attention").paged_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _verify_fn():
    """K2's C entry point."""
    fn = _kernels.load("paged_verify_attention").paged_verify_attention
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_args(kernel, q, k_pool, v_pool, block_tables, per_query, per_query_name, head_dims):
    """Device, dtype, shape and contiguity checks shared by both kernels:
    q is (slots, [w,] heads, d) with d in ``head_dims`` and ``per_query``
    (lengths or positions) is int32 of q's leading shape, (slots,) or
    (slots, w)."""
    tensors = {
        "q": q, "k_pool": k_pool, "v_pool": v_pool, "block_tables": block_tables,
        per_query_name: per_query,
    }
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{kernel} needs CUDA tensors; {name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} needs contiguous {name}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{kernel} takes float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} differ from q {q.dtype}")
    if block_tables.dtype != torch.int32 or per_query.dtype != torch.int32:
        raise TypeError(f"block_tables and {per_query_name} must be int32")
    if q.dim() < 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    h, d = q.shape[-2:]
    _, ph, _, pd = k_pool.shape
    if (ph, pd) != (h, d):
        raise ValueError(f"pool heads/head_dim {(ph, pd)} differ from q {(h, d)}")
    if d not in head_dims:
        raise ValueError(f"{kernel} takes head_dim in {head_dims}, got {d}")
    s = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != s or per_query.shape != q.shape[:-2]:
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / {per_query_name} "
            f"{tuple(per_query.shape)} do not match q {tuple(q.shape)}"
        )


#: the split kernels' workspace, one per (device, stream), shared by K1 and
#: K2: fp32 scratch for the split partials and int32 merge tickets.
#: Launches on one stream run in order, so a launch's partials are merged
#: before the next launch writes its own, and each launch leaves its
#: tickets at zero: both are allocated once (again when a call needs
#: more), not per call
_workspaces: dict = {}


def _workspace(device, stream, partials: int, tickets: int):
    key = (device, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < partials or ws[1].numel() < tickets:
        ws = _workspaces[key] = (
            torch.empty(partials, dtype=torch.float32, device=device),
            torch.zeros(tickets, dtype=torch.int32, device=device),
        )
    return ws


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _refused(kernel: str, entry: str, err: int, q, k_pool, v_pool) -> None:
    """Raises for a split-kernel launch that returned ``err``. The
    launchers themselves refuse a page over ``MAX_PAGE_BYTES`` and a pool
    off a 16-byte boundary, so the 28 calls of a step check neither on the
    host; this names the reason after the fact."""
    _, _, block_size, d = k_pool.shape
    if block_size * d * q.element_size() > MAX_PAGE_BYTES:
        raise ValueError(
            f"{kernel} takes (block, head) pages of at most {MAX_PAGE_BYTES} bytes, "
            f"got block_size {block_size} x head_dim {d} x {q.element_size()} bytes"
        )
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel} needs {name} on a 16-byte boundary (bulk copies)")
    _launched(entry, err)


def paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths):
    """K1, the hand-written decode kernel; same contract as
    ``paged_attention_torch``. Builds the kernel on first use. Launches on
    the current stream with that stream's workspace: fp32 scratch for
    (slots, heads, splits, d + 2) split partials (``decode_splits``) and
    the merge tickets. Reads no device value on the host;
    ``paged_attention_cuda.launches`` counts launches."""
    if q.dim() != 3:
        raise ValueError(f"paged decode kernel takes q (slots, heads, d), got {tuple(q.shape)}")
    _check_kernel_args("paged decode kernel", q, k_pool, v_pool, block_tables, lengths, "lengths",
                       DECODE_HEAD_DIMS)
    s, h, d = q.shape
    num_blocks, _, block_size, _ = k_pool.shape
    out = torch.empty_like(q)
    if s == 0:
        return out
    tmax = block_tables.shape[1]
    split_tokens, splits = decode_splits(tmax, block_size)
    fn = _decode_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch, tickets = _workspace(q.device, stream, s * h * splits * (d + 2), s * h)
        err = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            tickets.data_ptr(),
            s, h, d, num_blocks, block_size, tmax, split_tokens // block_size,
            d**-0.5, _DTYPE_CODE[q.dtype], stream,
        )
    if err != 0:
        _refused("paged decode kernel", "paged_decode_attention", err, q, k_pool, v_pool)
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def paged_verify_attention_cuda(q, k_pool, v_pool, block_tables, positions):
    """K2, the hand-written verify kernel; same contract as
    ``paged_verify_attention_torch`` for windows of any width of
    consecutive positions (the kernel takes the last query's position as
    the slot's live length). Builds the kernel on first use. Launches on
    the current stream with that stream's workspace (shared with K1): fp32
    scratch for (slots, heads, splits, w, d + 2) split partials
    (``decode_splits``) and the merge tickets.
    Reads no device value on the host; ``paged_verify_attention_cuda.launches``
    counts launches."""
    if q.dim() != 4:
        raise ValueError(f"paged verify kernel takes q (slots, w, heads, d), got {tuple(q.shape)}")
    _check_kernel_args("paged verify kernel", q, k_pool, v_pool, block_tables, positions, "positions",
                       VERIFY_HEAD_DIMS)
    s, w, h, d = q.shape
    num_blocks, _, block_size, _ = k_pool.shape
    out = torch.empty_like(q)
    if s == 0 or w == 0:
        return out
    tmax = block_tables.shape[1]
    split_tokens, splits = decode_splits(tmax, block_size)
    fn = _verify_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch, tickets = _workspace(q.device, stream, s * h * splits * w * (d + 2), s * h)
        err = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            tickets.data_ptr(),
            s, w, h, d, num_blocks, block_size, tmax, split_tokens // block_size,
            d**-0.5, _DTYPE_CODE[q.dtype], stream,
        )
    if err != 0:
        _refused("paged verify kernel", "paged_verify_attention", err, q, k_pool, v_pool)
    paged_verify_attention_cuda.launches += 1
    return out


paged_verify_attention_cuda.launches = 0


# ---------------------------------------------------------------------------
# dispatchers
# ---------------------------------------------------------------------------


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(
            f"unknown paged attention impl {impl!r}; expected 'auto', 'cuda' or 'torch'"
        )


def paged_attention(q, k_pool, v_pool, block_tables, lengths, impl: str = "auto"):
    """Single-position attention over a paged KV cache (module doc).

    q: (slots, heads, head_dim); k_pool/v_pool: (num_blocks, heads,
    block_size, head_dim); block_tables: (slots, tmax) int32; lengths:
    (slots,) int32. ``impl``: auto | cuda | torch."""
    _check_impl(impl)
    if impl == "torch" or (impl == "auto" and not q.is_cuda):
        return paged_attention_torch(q, k_pool, v_pool, block_tables, lengths)
    return paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths)


def paged_verify_attention(q, k_pool, v_pool, block_tables, positions, impl: str = "auto"):
    """Multi-query verification attention over a paged KV cache (module
    doc): ``w`` consecutive queries per slot, causal by absolute position.

    q: (slots, w, heads, head_dim); k_pool/v_pool: (num_blocks, heads,
    block_size, head_dim); block_tables: (slots, tmax) int32; positions:
    (slots, w) int32. ``impl``: auto | cuda | torch."""
    _check_impl(impl)
    if impl == "torch" or (impl == "auto" and not q.is_cuda):
        return paged_verify_attention_torch(q, k_pool, v_pool, block_tables, positions)
    return paged_verify_attention_cuda(q, k_pool, v_pool, block_tables, positions)
