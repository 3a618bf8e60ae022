#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one NVIDIA H100

Builds the port's CUDA kernels from the sources in the checkout, holds each
against its plain PyTorch version at its path's shapes, times it, and drives
the port's main paths through the entry points a user calls: the paged-KV
serving engine at the full GPT-J-6B width (28 layers, bf16, random weights
from a seed), plain and speculating; GPT training at bench.py's 406M shape
(24 layers, bf16, random weights from a seed); and the serving engine at
GPT-124M (the reference's default GPTConfig, 12 layers, bf16 over fp32
master weights), plain, speculating and across a weight hot-swap. Phases,
each of which raises on failure:

1. device: name, compute capability, power limit;
2. build: the three kernel sources, in parallel, and their ``-Xptxas -v`` register /
   shared-memory reports;
3. K1 (paged decode attention) vs its plain version, fp32 and bf16, head
   dims 64 (GPT's 12 heads), 128 and 256, at lengths on the block and split
   edges, and its live split partials vs ``decode_partials_torch``;
4. K1 timing beside the plain version, the library call and the bound,
   with its split size and CTA count, at GPT-J-6B's and GPT-124M's decode
   shapes;
5. fp32 identity: a full-width, 2-layer GPT-J engine is token-identical to
   the dense ``gptj_decode``;
6. GPT-J-6B serve: ``run_loop`` in a thread, requests from several threads
   through ``stream_tokens``, prefix-cache hits, a copy-on-write fork,
   greedy and seeded-sampled requests; checks the pool audit, the kernel's
   launch count and every greedy token against the dense forward;
7. decode profile: device busy time of a steady 8-slot decode step by
   kernel, against its wall time without the profiler, and the host time
   of the step's Gumbel noise;
8. K2 (paged verify attention) vs its plain version, fp32 and bf16, head
   dims 64, 128 and 256, windows 1-9, 16, 17 and 33 (an inactive slot, a
   window straddling a block edge, one straddling a split edge, one past
   the table), window index by window index vs K1, and its live split
   partials vs ``verify_partials_torch``;
9. K2 timing beside the plain version, the library call (in turns), the
   bound and K1, at GPT-J-6B's verify shape and at GPT-124M's (12 heads of
   64), and across windows 1-16 and 32 (in turns);
10. fp32 spec identity: a full-width, 2-layer speculating GPT-J engine is
    token-identical to dense ``gptj_decode`` — with a test-double drafter
    that makes full, partial and zero acceptance happen (spec_k 4 and 9),
    and with the n-gram drafter;
11. GPT-J-6B spec serve: the phase-6 weights behind a speculating engine
    (spec_k=4, n-gram drafter) serving client threads; checks the audits,
    both kernels' launch counts against the verify and plain decode steps,
    and every greedy token against the dense forward;
12. verify profile: device busy time of a steady 8-slot verify step by
    kernel, against its wall time without the profiler, and the host time
    of the step's Gumbel noise;
13. library times (SDPA forward, forward+backward) and bounds for the
    training slice's flash-attention kernels K3-K5;
14. K3-K5 (flash forward, dQ, dK/dV) vs their plain versions, fp32 and
    bf16, head dims 64 and 128, seq 1024, a ragged 1000 and 1001 (lse and
    delta rows then start off 16-byte boundaries); an operand off a
    16-byte boundary is refused;
15. K3-K5 at the training shape: vs their plain versions there (the
    kernels line's errors), their timing beside the plain versions, the
    library calls and the bounds, their achieved TFLOP/s and ratio to the
    library call, K4 + K5 against SDPA's backward, and their ``-Xptxas -v``
    reports;
16. fp32 training identity: a narrow GPT takes 3 AdamW steps through K3-K5
    and 3 through the einsum attention, under remat "full" and "attn";
    losses and parameters agree;
17. 406M training: bench.py's training shape (24 layers, d 1024, vocab
    50304, batch 26, bf16, remat "attn") through ``build_train_step``:
    step 0's qkv weight gradients and loss against the einsum path; step
    time, tokens/s, MFU, losses, peak memory, K3-K5 launches against the
    expected per-step counts, and a profile of two steps;
18. GPT fp32 identity: a full-width (d 768, 12 heads of 64, vocab 50304),
    2-layer fp32 GPT engine is token-identical to the dense ``gpt_decode``,
    plain and speculating at spec_k 4 (test-double and n-gram drafters);
19. GPT-124M serve: phase 6's traffic, then phase 11's on a speculating
    engine, at full depth in bf16; checks the audits, K1 at 12 launches a
    decode step, K2 at 12 a verify step, and every greedy token against the
    dense forward;
20. GPT-124M decode and verify profile: phases 7 and 12 on those engines;
21. GPT-124M hot swap: ``update_weights`` to a second seed's weights while
    requests are in flight; checks that parameter storage stays in place,
    the version is stamped, the prefix tree is flushed, and every greedy
    token submitted after the swap against the dense forward under the new
    weights; times the swap;
22. GPT-124M production engine: phase 19's engines with the production
    half on. (a) phase 19's traffic, plain and at spec_k=4: the metric
    counters against the tokens streamed and the engines' own counts, the
    inter-token latency histogram against the tokens, each request's
    flight-recorder events in order and its phases summing to finish -
    submit; (b) the HBM ledger against ``torch.cuda.memory_allocated`` and
    the pool tensors; (c) the watchdog under a real device wedge (a ~4 s
    spin in front of one decode step): the stall event and counter, the
    step-age gauge, a deadline request's stream ended and
    ``EngineStalledError`` raised while the device still spins, then a
    clean recovery; (d) deadline shedding at the card's measured service
    rate; (e) the hooks' cost per decode and verify step, on and off in
    turns; K1 and K2 at 12 launches a step throughout.

The last line is ``{"ok": true, "device": {...}}``; the line before it has
the card's name and power limit, the one before that the kernels' record.
Exits non-zero, printing no result, when there is no CUDA device.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch._private import events
from ray_tpu_torch.exceptions import OverloadedError
from ray_tpu_torch.llm import EngineConfig, EngineStalledError, LLMEngine, SamplingParams
from ray_tpu_torch.llm import engine as engine_mod
from ray_tpu_torch.llm import prefix_cache as prefix_mod
from ray_tpu_torch.llm import watchdog as watchdog_mod
from ray_tpu_torch.llm.model_runner import _row_noise, _window_noise
from ray_tpu_torch.llm.scheduler import RUNNING
from ray_tpu_torch.models.gpt import GPTConfig, gpt_decode, gpt_forward, gpt_init, gpt_loss
from ray_tpu_torch.models.gptj import GPTJ_6B, GPTJConfig, gptj_decode, gptj_forward, gptj_init
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    flash_attention,
    flash_bwd_dkv_cuda,
    flash_bwd_dq_cuda,
    flash_bwd_reference,
    flash_fwd_cuda,
    flash_fwd_reference,
    kernel_smem_bytes,
)
from ray_tpu_torch.ops.fused_ce import fused_softmax_cross_entropy
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.ops.paged_attention import (
    DECODE_HEAD_DIMS,
    VERIFY_HEAD_DIMS,
    decode_splits,
    paged_attention,
    paged_attention_cuda,
    paged_verify_attention,
    paged_verify_attention_cuda,
    verify_partials_torch,
)
from ray_tpu_torch.parallel import adamw, build_train_step
from ray_tpu_torch.util import metrics, phases, tracing

# H100 SXM data-sheet peaks (dense): HBM bytes/s and operations/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the kernels' sources, ray_tpu_torch/ops/csrc/<name>.cu
KERNELS = ("paged_attention", "paged_verify_attention", "flash_attention")

# slice shapes: GPT-J-6B decode at 8 slots, block 16, 128-entry tables; the
# verify window of spec_k = 4
S, H, D, BS, T = 8, 16, 256, 16, 128
W = 5
NB = S * T + 1  # the serve phase's pool: 1025 blocks, block 0 the trash block
# phase 8's windows: every width up to 9 (past the first design's widest, 8), one and
# two 16-row query tiles and one past them (a second walk of the pages);
# phase 9's sweep
K2_WINDOWS = (*range(1, 10), 16, 17, 33)
K2_SWEEP = (*range(1, 17), 32)

# the training slice: bench.py's 406M shape at batch 26 (attention operands
# (26 x 16, 1024, 64))
TRAIN_406M = GPTConfig(vocab_size=50_304, seq_len=1024, d_model=1024, n_layers=24, n_heads=16,
                       remat_policy="attn", ce_chunks=1)
TRAIN_B, TRAIN_H, TRAIN_S, TRAIN_D = 26, 16, 1024, 64

# the GPT serving slice: the reference's default GPTConfig, what its
# serve/llm.py serves for model="gpt" and every RLHF rollout engine runs
# (vocab 50304, seq 1024, d 768, 12 layers, 12 heads of 64; bf16 over fp32
# master weights)
GPT_124M = GPTConfig()

# K1 vs plain: the fp32 pair differs only in summation order (the
# reference's Pallas-vs-XLA tolerance); in bf16 both round one fp32 result
# to bf16, and a different summation order can move it by one bf16 step
# (2^-8 relative) at magnitudes up to ~1
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}

# greedy check of the bf16 serve: an engine token must be the dense
# forward's argmax unless the dense forward's top-2 logits lie within this
# margin of each other (bf16 rounding at other places in the two paths
# moves logits by a few hundredths after 28 layers)
BF16_TOP2_MARGIN = 0.1

# phase 17: the largest relative gap allowed between step 0's qkv weight
# gradients through K3-K5 and through the einsum attention, at the 406M
# shape in bf16 (set between the measured gap and the gaps of kernels with
# their causal mask removed; PERF.md)
QKV_GRAD_GAP = 0.15


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. A spin
    kernel holds the device while the host queues the timed calls, so the
    events time the device's work even where the host takes longer to
    issue a call than the device to run it (a fast kernel behind a Python
    wrapper, on a slow host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # one call's issue time (or more, if it syncs)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * iters * host_s + 0.01) * 2e9))  # cycles at up to 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: dict, iters: int) -> dict:
    """``cuda_ms`` of each callable, after a warm-up of every one (a card
    coming out of idle times its first calls slow), in turns: the order of
    ``fns``, then reversed. Returns {name: [first turn, second turn]}."""
    for fn in fns.values():
        cuda_ms(fn, iters)
    times = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        times[name].append(cuda_ms(fns[name], iters))
    return times


def k1_inputs(dtype, lengths, seed, d=D, h=H):
    """Random q/pools and per-slot tables of distinct live blocks, padded
    with the trash block past each slot's length."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lengths = lengths.cuda()
    q = torch.randn(S, h, d, device="cuda", generator=g).to(dtype)
    kp = torch.randn(NB, h, BS, d, device="cuda", generator=g).to(dtype)
    vp = torch.randn(NB, h, BS, d, device="cuda", generator=g).to(dtype)
    tables = (torch.randperm(NB - 1, device="cuda", generator=g)[: S * T] + 1).view(S, T)
    live = torch.arange(T, device="cuda")[None, :] < ((lengths + BS - 1) // BS)[:, None]
    tables = torch.where(live, tables, 0).int().contiguous()
    return q, kp, vp, tables, lengths.int()


def k1_bound_ms(dtype, lengths, d=D, h=H) -> float:
    """Least time for one call: each live K/V row, q, the live table entries
    and the lengths read once, out written once; 4*d operations per row."""
    esize = torch.finfo(dtype).bits // 8
    n = int(lengths.sum())
    live_entries = int(((lengths + BS - 1) // BS).sum())
    nbytes = 2 * n * h * d * esize + 2 * S * h * d * esize + 4 * (live_entries + S)
    ops = 4 * n * h * d
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]) * 1e3


def k1_heads(d: int) -> int:
    """Heads of K1's checks at head dim ``d``: GPT-124M's 12 at 64, GPT-J-6B's
    16 otherwise."""
    return GPT_124M.n_heads if d == GPT_124M.head_dim else H


# K1's live split partials against decode_partials_torch: both sum exact
# fp32 products in another order (the inputs are rounded to bf16 before
# either sees them), so the gap is fp32 rounding at the largest partial
K1_PARTIALS_TOL = 1e-4


def k1_partials_gap(q, kp, vp, tables, lengths) -> float:
    """K1's live split partials after one launch (read from the stream's
    workspace, which holds the last launch's) against
    ``decode_partials_torch``: the largest difference over acc, m and l,
    relative to max(1, the largest plain value)."""
    split_tokens, splits = decode_splits(T, BS)
    s, h, d = q.shape
    paged_attention(q, kp, vp, tables, lengths, impl="cuda")
    torch.cuda.synchronize()
    ws = pa._workspaces[(q.device, torch.cuda.current_stream().cuda_stream)][0]
    got = ws[: s * h * splits * (d + 2)].view(s, h, splits, d + 2)
    want = pa.decode_partials_torch(q, kp, vp, tables, lengths, split_tokens)
    live = torch.arange(splits, device="cuda")[None, :] * split_tokens < lengths.long()[:, None]
    live = live[:, None, :].expand(s, h, splits)
    return ((got[live] - want[live]).abs().max() / want[live].abs().max().clamp_min(1)).item()


def check_k1() -> float:
    """Phase 3, at every head dim of ``DECODE_HEAD_DIMS`` (64 with GPT's 12
    heads): two batches of 8 slots, lengths on the block edges (15, 16, 17),
    on and next to the split edges (split - 1, split, split + 1, two splits
    and one more), within a single split (1, 100), the full table (2048),
    random ones and 0; then the live split partials of each batch against
    ``decode_partials_torch``. Returns the bf16 max abs error over the
    compared rows."""
    rng = np.random.RandomState(0)
    sp = decode_splits(T, BS)[0]
    batches = (torch.tensor([1, 15, 16, 17, T * BS, *rng.randint(1, T * BS + 1, 2), 0]),
               torch.tensor([sp - 1, sp, sp + 1, 2 * sp, 2 * sp + 1, 100, rng.randint(1, T * BS + 1), 0]))
    err_bf16 = 0.0
    for d in DECODE_HEAD_DIMS:
        h = k1_heads(d)
        for dtype in (torch.float32, torch.bfloat16):
            for lens in batches:
                compared = lens > 0  # a 0-length row is only required to be finite
                args = k1_inputs(dtype, lens, seed=1, d=d, h=h)
                ref = paged_attention(*args, impl="torch")
                out = paged_attention(*args, impl="cuda")
                torch.cuda.synchronize()
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"K1 {dtype} d={d}: non-finite output")
                err = (out.float() - ref.float()).abs()[compared.cuda()].max().item()
                gap = k1_partials_gap(*args)
                print(f"K1 {dtype} d={d} heads={h} split {sp} lengths={lens.tolist()} max_abs_err={err:.3g} "
                      f"tol={TOL[dtype]}; live split partials vs decode_partials_torch {gap:.3g} of "
                      f"max(1, largest value) (limit {K1_PARTIALS_TOL})")
                if not err <= TOL[dtype]:
                    raise AssertionError(f"K1 {dtype} d={d}: max abs error {err} > {TOL[dtype]}")
                if not gap <= K1_PARTIALS_TOL:
                    raise AssertionError(f"K1 {dtype} d={d}: split partials differ by {gap}")
                if dtype == torch.bfloat16:
                    err_bf16 = max(err_bf16, err)
                del args, ref, out
        torch.cuda.empty_cache()
    return err_bf16


def time_k1(d: int = D) -> dict:
    """Phase 4 at a decode shape: 8 slots x 1024 context, bf16, head dim
    ``d`` (GPT-J-6B's 16 heads of 256, GPT-124M's 12 of 64); the kernel and
    the library call in turns (``in_turns``), each the mean of its two
    turns."""
    dtype = torch.bfloat16
    h = k1_heads(d)
    lens = torch.full((S,), 1024)
    q, kp, vp, tables, lengths = k1_inputs(dtype, lens, seed=2, d=d, h=h)
    plain_ms = cuda_ms(lambda: paged_attention(q, kp, vp, tables, lengths, impl="torch"), 20)
    # library yardstick: SDPA over K/V gathered to dense beforehand (the
    # gather is NOT timed) with the length mask
    live = int(((lens.max() + BS - 1) // BS).item())
    idx = tables[:, :live].long()
    kd = kp[idx].transpose(1, 2).reshape(S, h, live * BS, d)
    vd = vp[idx].transpose(1, 2).reshape(S, h, live * BS, d)
    mask = (torch.arange(live * BS, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    turns = in_turns({"kernel": lambda: paged_attention(q, kp, vp, tables, lengths, impl="cuda"),
                      "library": lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask)}, 200)
    ms, library_ms = (sum(turns[n]) / 2 for n in ("kernel", "library"))
    rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=k1_bound_ms(dtype, lens, d, h))
    split_tokens, splits = decode_splits(T, BS)
    live_ctas = S * h * -(-1024 // split_tokens)
    print(
        f"K1 timing bf16 S={S} H={h} D={d} BS={BS} len=1024: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (SDPA on pre-gathered K/V, gather excluded) "
        f"{library_ms:.4f} ms (kernel/library {ms / library_ms:.3f}x; turns "
        f"{' / '.join(f'{t:.4f}' for t in turns['kernel'])} and "
        f"{' / '.join(f'{t:.4f}' for t in turns['library'])}), bound {rec['bound_ms']:.4f} ms "
        f"(bytes, {ms / rec['bound_ms']:.2f}x); split {split_tokens} positions, {splits * h * S} CTAs "
        f"({live_ctas} with a live position)"
    )
    return rec


def k2_inputs(dtype, base, seed, inactive=(), w=W, d=D, h=H):
    """Random q/pools, window positions ``base[s] + arange(w)`` and per-slot
    tables of distinct live blocks (the live length capped at T*BS), padded
    with the trash block; slots in ``inactive`` get an all-trash table, as
    the engine gives an empty slot."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    positions = (base[:, None] + torch.arange(w)[None, :]).int().cuda()
    q = torch.randn(S, w, h, d, device="cuda", generator=g).to(dtype)
    kp = torch.randn(NB, h, BS, d, device="cuda", generator=g).to(dtype)
    vp = torch.randn(NB, h, BS, d, device="cuda", generator=g).to(dtype)
    tables = (torch.randperm(NB - 1, device="cuda", generator=g)[: S * T] + 1).view(S, T)
    n_live = (positions[:, -1] + 1).clamp(max=T * BS)
    live = torch.arange(T, device="cuda")[None, :] < ((n_live + BS - 1) // BS)[:, None]
    for s in inactive:
        live[s] = False
    tables = torch.where(live, tables, 0).int().contiguous()
    return q, kp, vp, tables, positions.contiguous()


def k2_bound_ms(dtype, positions, d=D, h=H) -> float:
    """Least time for one call: each slot's live K/V rows (up to its last
    query, capped at T*BS), q, the live table entries and the positions
    read once, out written once; 4*d operations per (query, attended
    row, head)."""
    esize = torch.finfo(dtype).bits // 8
    pos = positions.long().cpu()
    w = pos.shape[1]
    n_live = (pos[:, -1] + 1).clamp(max=T * BS)
    live_entries = int(((n_live + BS - 1) // BS).sum())
    nbytes = (2 * int(n_live.sum()) * h * d * esize + 2 * S * w * h * d * esize
              + 4 * (live_entries + S * w))
    ops = 4 * int((pos + 1).clamp(max=T * BS).sum()) * h * d
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]) * 1e3


def k2_bases(w: int, rng) -> torch.Tensor:
    """Phase 8's first positions: slot 0 inactive (base 0, all-trash table:
    only required finite), a window straddling a block edge, one whose last
    position is past T*BS, one at 1019, one straddling the split edge, and
    random ones."""
    split = decode_splits(T, BS)[0]
    return torch.tensor([0, 13, T * BS - 2, 1019, split - w // 2 - 1,
                         *rng.randint(0, T * BS - w, S - 5)])


# K2's live split partials against verify_partials_torch: in fp32 both sum
# exact products in another order; in bf16 the kernel rounds P to bf16
# (2^-9 relative) before its P V product, so its acc may differ by about
# one bf16 step of the largest partial
K2_PARTIALS_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def k2_partials_gap(q, kp, vp, tables, positions) -> float:
    """K2's live split partials after one launch (read from the stream's
    workspace, which holds the last launch's) against
    ``verify_partials_torch``: the largest difference over acc, m and l,
    relative to max(1, the largest plain value)."""
    split_tokens, splits = decode_splits(T, BS)
    s, w, h, d = q.shape
    paged_verify_attention(q, kp, vp, tables, positions, impl="cuda")
    torch.cuda.synchronize()
    ws = pa._workspaces[(q.device, torch.cuda.current_stream().cuda_stream)][0]
    got = ws[: s * h * splits * w * (d + 2)].view(s, h, splits, w, d + 2)
    want = verify_partials_torch(q, kp, vp, tables, positions, split_tokens)
    length = (positions[:, -1].long() + 1).clamp(max=T * BS)
    live = torch.arange(splits, device="cuda")[None, :] * split_tokens < length[:, None]
    live = live[:, None, :].expand(s, h, splits)
    return ((got[live] - want[live]).abs().max() / want[live].abs().max().clamp_min(1)).item()


def check_k2() -> float:
    """Phase 8: K2 vs its plain version at every window of ``K2_WINDOWS``
    and head dim of ``VERIFY_HEAD_DIMS``, in fp32 and bf16 (``k2_bases``),
    and at head dim 256 window index by window index vs K1; then its live
    split partials at phase 9's shape. Each element within ``TOL`` x max(1,
    |reference|): in bf16 both sides round an fp32 value to bf16, one step
    of which is 2^-8 of its magnitude, and K2 also rounds P to bf16 before
    its P V product (2^-9 relative), which moves its fp32 value across a
    rounding boundary more often; outputs of a window over a few tokens
    reach magnitudes 2-4. Returns the bf16 max abs error against the plain
    version."""
    rng = np.random.RandomState(4)
    compared = (torch.arange(S) != 0).cuda()
    err_bf16 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for d in VERIFY_HEAD_DIMS:
            errs, errs_k1, ok = [], [], True
            for w in K2_WINDOWS:
                err_k1 = 0.0
                q, kp, vp, tables, positions = k2_inputs(dtype, k2_bases(w, rng), seed=5 + w, inactive=(0,),
                                                         w=w, d=d)
                ref = paged_verify_attention(q, kp, vp, tables, positions, impl="torch")
                out = paged_verify_attention(q, kp, vp, tables, positions, impl="cuda")
                torch.cuda.synchronize()
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"K2 {dtype} d={d} W={w}: non-finite output")
                err = (out.float() - ref.float()).abs()[compared]
                errs.append(err.max().item())
                ok &= bool((err <= TOL[dtype] * ref[compared].float().abs().clamp_min(1)).all())
                if d == D:
                    # each window index is a decode step at that position: K1
                    # at lengths positions[:, i] + 1 on the same cache
                    for i in range(w):
                        one = paged_attention(q[:, i].contiguous(), kp, vp, tables, positions[:, i] + 1,
                                              impl="cuda").float()
                        err = (out[:, i].float() - one).abs()
                        ok &= bool((err <= TOL[dtype] * one.abs().clamp_min(1)).all())
                        err_k1 = max(err_k1, err.max().item())
                    errs_k1.append(err_k1)
                del q, kp, vp, ref, out
            print(f"K2 {dtype} d={d} windows {list(K2_WINDOWS)} vs plain: max_abs_err "
                  f"{[f'{e:.3g}' for e in errs]}"
                  + (f"; vs K1 per window index {[f'{e:.3g}' for e in errs_k1]}" if errs_k1 else "")
                  + f" (tol {TOL[dtype]} x max(1, |reference|))")
            if not ok:
                raise AssertionError(f"K2 {dtype} d={d}: an error above {TOL[dtype]} x max(1, |reference|)")
            if dtype == torch.bfloat16:
                err_bf16 = max(err_bf16, *errs)
        torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        args = k2_inputs(dtype, torch.tensor([0, 13, T * BS - 2, *[1019] * (S - 3)]), seed=7, inactive=(0,))
        gap = k2_partials_gap(*args)
        print(f"K2 {dtype} W={W}: live split partials (acc, m, l) vs verify_partials_torch, largest "
              f"difference {gap:.3g} of max(1, largest value) (limit {K2_PARTIALS_TOL[dtype]})")
        if not gap <= K2_PARTIALS_TOL[dtype]:
            raise AssertionError(f"K2 {dtype}: split partials differ from verify_partials_torch by {gap}")
    return err_bf16


def time_k2(k1_ms: float, d: int = D) -> dict:
    """Phase 9 at a verify shape: 8 slots, windows at 1019-1023, bf16, head
    dim ``d`` (GPT-J-6B's 16 heads of 256, GPT-124M's 12 of 64); the kernel
    and the library call in turns (``in_turns``), each the mean of its two
    turns; then, at GPT-J-6B's shape, the kernel across ``K2_SWEEP`` with
    the last query at 1023, in turns. ``k1_ms`` is K1's time at the same
    shape."""
    dtype = torch.bfloat16
    h = k1_heads(d)
    base = torch.full((S,), 1019)
    q, kp, vp, tables, positions = k2_inputs(dtype, base, seed=7, d=d, h=h)
    plain_ms = cuda_ms(
        lambda: paged_verify_attention(q, kp, vp, tables, positions, impl="torch"), 20)
    # library yardstick: SDPA with q (S, H, W, D) over K/V gathered to dense
    # beforehand (the gather is NOT timed) with the per-query position mask
    n = int(positions[:, -1].max().item()) + 1
    live = (n + BS - 1) // BS
    idx = tables[:, :live].long()
    kd = kp[idx].transpose(1, 2).reshape(S, h, live * BS, d)
    vd = vp[idx].transpose(1, 2).reshape(S, h, live * BS, d)
    key_pos = torch.arange(live * BS, device="cuda")
    mask = (key_pos[None, None, :] <= positions[:, :, None])[:, None]  # (S, 1, W, keys)
    qh = q.transpose(1, 2)  # (S, H, W, D)
    turns = in_turns({"kernel": lambda: paged_verify_attention(q, kp, vp, tables, positions, impl="cuda"),
                      "library": lambda: F.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask)}, 200)
    ms, library_ms = (sum(turns[n]) / 2 for n in ("kernel", "library"))
    rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=k2_bound_ms(dtype, positions, d, h))
    split_tokens, splits = decode_splits(T, BS)
    print(
        f"K2 timing bf16 S={S} W={W} H={h} D={d} BS={BS} positions 1019-1023: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (SDPA on pre-gathered K/V with the position mask, "
        f"gather excluded) {library_ms:.4f} ms (kernel/library {ms / library_ms:.3f}x; turns "
        f"{' / '.join(f'{t:.4f}' for t in turns['kernel'])} and "
        f"{' / '.join(f'{t:.4f}' for t in turns['library'])}), bound {rec['bound_ms']:.4f} ms "
        f"(bytes, {ms / rec['bound_ms']:.2f}x); K2 / K1 at the same context {ms / k1_ms:.3f}; split "
        f"{split_tokens} positions, {splits * h * S} CTAs ({S * h * -(-1024 // split_tokens)} with a "
        f"live position)"
    )
    del kd, vd, q, kp, vp
    if d != D:
        return rec
    # the window swept at one context: a kernel held to its byte bound takes
    # about the same time at every W (K/V is read once per window); one held
    # by its per-query work grows with W
    fns, bounds = {}, {}
    for w in K2_SWEEP:
        args = k2_inputs(dtype, torch.full((S,), 1024 - w), seed=7, w=w)
        fns[w] = lambda args=args: paged_verify_attention(*args, impl="cuda")
        bounds[w] = k2_bound_ms(dtype, args[4])
    sweep = {w: sum(ts) / 2 for w, ts in in_turns(fns, 200).items()}
    fastest = min(sweep.values())
    print("K2 by window, bf16, last query at 1023, in turns: " + "; ".join(
        f"W={w} {t:.4f} ms ({t / fastest:.2f}x fastest, {t / k1_ms:.2f}x K1, {t / bounds[w]:.2f}x bound)"
        for w, t in sweep.items()) + f"; slowest/fastest {max(sweep.values()) / fastest:.3f}")
    return rec


def engine_identity(cfg, params, decode, label: str) -> None:
    """A 4-slot engine's greedy output equals the dense ``decode`` token for
    token: four requests, one after another's prompt is cached (a prefix
    hit), one diverging inside a cached block (a copy-on-write fork)."""
    eng = LLMEngine(
        cfg, params,
        EngineConfig(max_slots=4, block_size=16, max_blocks_per_seq=32, num_blocks=129,
                     prefill_chunk=64),
    )
    rng = np.random.RandomState(1)
    head = list(rng.randint(0, cfg.vocab_size, 40))
    prompts = [
        head + list(rng.randint(0, cfg.vocab_size, 37)),
        list(rng.randint(0, cfg.vocab_size, 130)),
        head[:36] + list(rng.randint(0, cfg.vocab_size, 20)),  # diverges mid-block
        list(rng.randint(0, cfg.vocab_size, 9)),
    ]
    n_new = 16
    first = eng.submit(prompts[0], SamplingParams(max_tokens=n_new))
    while not first.finished:
        eng.step()
    reqs = [first] + [eng.submit(p, SamplingParams(max_tokens=n_new)) for p in prompts[1:]]
    while not all(r.finished for r in reqs):
        eng.step()
    for p, r in zip(prompts, reqs):
        ref = decode(cfg, params, torch.tensor([p], device="cuda"), n_new)[0, len(p):]
        if r.out != ref.tolist():
            raise AssertionError(f"fp32 engine {r.out} != dense {label} {ref.tolist()}")
    pc = eng.prefix_cache.stats()
    if not (eng.pool.audit()["ok"] and eng.prefix_cache.audit()["ok"]):
        raise AssertionError("fp32 engine: pool or prefix-cache audit failed")
    if pc["hit_tokens"] <= 0 or pc["cow_forks"] < 1:
        raise AssertionError(f"fp32 engine: expected prefix hits and a CoW fork, got {pc}")
    print(
        f"fp32 identity: {len(reqs)} requests x {n_new} tokens equal dense {label} "
        f"(prefix hit tokens {pc['hit_tokens']}, cow forks {pc['cow_forks']})"
    )


def fp32_identity() -> None:
    """Phase 5: GPT-J at full width, 2 layers, fp32 — engine greedy == dense
    decode."""
    cfg = GPTJConfig(n_layers=2, dtype="float32")
    params = gptj_init(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    engine_identity(cfg, params, gptj_decode, "gptj_decode")


def serve_threads(eng: LLMEngine, first, make_rest, first_to_end: bool = False):
    """``run_loop`` in a thread; ``first`` (prompt, params) is submitted
    alone and its first token (with ``first_to_end``, all of it) streamed
    before the others arrive, so its prompt blocks are in the prefix tree;
    then every request of ``make_rest(first's tokens so far)`` is submitted
    and streamed from its own thread. Every kernel's launch count and the
    runner's step counts are set to 0 just before the loop starts. Returns
    ({index: (prompt, params, request, streamed tokens)}, wall seconds)."""
    results: dict[int, tuple] = {}
    errors: list[BaseException] = []

    def client(idx, prompt, sp):
        try:
            req = eng.submit(prompt, sp)
            results[idx] = (prompt, sp, req, list(eng.stream_tokens(req, timeout=600)))
        except BaseException as e:  # surfaced by the main thread below
            errors.append(e)

    # the main path's run starts here: every count from 0
    paged_attention_cuda.launches = 0
    paged_verify_attention_cuda.launches = 0
    eng.runner.launches = dict.fromkeys(eng.runner.launches, 0)
    stop = threading.Event()
    loop = threading.Thread(target=eng.run_loop, args=(stop,), daemon=True)
    t_start = time.perf_counter()
    loop.start()
    try:
        req0 = eng.submit(*first)
        stream0 = eng.stream_tokens(req0, timeout=600)
        tok0 = list(stream0) if first_to_end else [next(stream0)]
        rest = make_rest(tok0)
        threads = [threading.Thread(target=lambda: results.__setitem__(0, (*first, req0, tok0 + list(stream0))))]
        threads += [
            threading.Thread(target=client, args=(idx, *item))
            for idx, item in enumerate(rest, start=1)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if any(t.is_alive() for t in threads):
            raise AssertionError("serve: a client thread did not finish")
        wall = time.perf_counter() - t_start
    finally:
        stop.set()
        loop.join(timeout=60)
    if errors:
        raise errors[0]
    if len(results) != 1 + len(rest):
        raise AssertionError(f"serve: {len(results)} of {1 + len(rest)} requests returned")
    return results, wall


def check_served(eng: LLMEngine, results: dict, label: str) -> None:
    """Every request ran to max_tokens, streamed what it recorded, with
    in-range tokens and finite logprobs; both ledgers audit clean."""
    V = eng.model_cfg.vocab_size
    for idx, (prompt, sp, req, streamed) in sorted(results.items()):
        if req.finish_reason != "length" or len(req.out) != sp.max_tokens or streamed != req.out:
            raise AssertionError(f"{label}: request {idx} ended {req.finish_reason} with {len(req.out)} tokens")
        if not all(0 <= t < V for t in req.out) or not np.isfinite(req.out_logprobs).all():
            raise AssertionError(f"{label}: request {idx} has out-of-range tokens or non-finite logprobs")
    audit, pc_audit = eng.pool.audit(), eng.prefix_cache.audit()
    if not (audit["ok"] and pc_audit["ok"]):
        raise AssertionError(f"{label}: audit failed {audit} {pc_audit}")


def gpt_forward_plain(cfg: GPTConfig, params, tokens):
    """The dense GPT forward as an oracle: plain attention (the reference's
    ``impl="xla"``, no kernel), no remat, fp32 logits."""
    with torch.no_grad():
        return gpt_forward(dataclasses.replace(cfg, attn_impl="xla", remat=False), params, tokens)


def check_greedy(cfg, params, results: dict, label: str, forward=gptj_forward, indices=None) -> None:
    """Every greedy token (of the requests in ``indices``, default all)
    against the dense ``forward`` over prompt + output."""
    checked = excused = 0
    for idx, (prompt, sp, req, _) in sorted(results.items()):
        if sp.temperature > 0 or (indices is not None and idx not in indices):
            continue
        seq = torch.tensor([prompt + req.out[:-1]], device="cuda")
        logits = forward(cfg, params, seq)[0, len(prompt) - 1 :]  # predicts out[j]
        top2 = logits.topk(2, dim=-1).values
        for j, tok in enumerate(req.out):
            checked += 1
            if tok == int(logits[j].argmax()):
                continue
            gap = float(top2[j, 0] - top2[j, 1])
            behind = float(top2[j, 0] - logits[j, tok])
            if gap >= BF16_TOP2_MARGIN or behind >= BF16_TOP2_MARGIN:
                raise AssertionError(
                    f"{label}: request {idx} token {j} = {tok} is {behind:.4f} behind the dense "
                    f"argmax (top-2 gap {gap:.4f}, margin {BF16_TOP2_MARGIN})"
                )
            excused += 1
    if checked == 0:
        raise AssertionError(f"{label}: no greedy token to check")
    print(
        f"{label} greedy check: {checked} tokens against the dense bf16 forward, {excused} "
        f"differ within the top-2 margin {BF16_TOP2_MARGIN}"
    )


def ttft_ms(results: dict) -> str:
    ttft = sorted(r[2].first_token_t - r[2].arrival_t for r in results.values())
    return f"{ttft[0] * 1e3:.1f}/{ttft[len(ttft) // 2] * 1e3:.1f}/{ttft[-1] * 1e3:.1f} ms"


def serve_mix(eng: LLMEngine, params, label: str, card: str, forward, longest: int = 1024) -> dict:
    """Phase 6's traffic on a warmed-up engine: 9 requests from client
    threads (``serve_threads``), prompts 64 to ``longest`` tokens, shared
    256-token heads (prefix hits), one diverging inside a cached block (a
    CoW fork), greedy and seeded-sampled, 32 new tokens each. Checks every
    request, both audits, K1's launches per decode step and every greedy
    token against the dense ``forward``. Returns the K1 launches, the
    engine, and the requests."""
    cfg = eng.model_cfg
    V = cfg.vocab_size
    rng = np.random.RandomState(2)

    def toks(n):
        return [int(t) for t in rng.randint(0, V, n)]

    greedy = SamplingParams(max_tokens=32)
    head = toks(256)  # shared head: 16 full blocks
    first = (head + toks(192), greedy)
    rest = [
        (head + toks(64), greedy),
        (head + toks(512), SamplingParams(max_tokens=32, temperature=0.8, top_k=50, top_p=0.95, seed=7)),
        (head[:200] + toks(300), greedy),  # diverges inside block 12: a CoW fork
        (toks(64), greedy),
        (toks(longest), SamplingParams(max_tokens=32, temperature=1.0, seed=11)),
        (toks(100), greedy),
        (head + toks(32), greedy),
        (toks(700), SamplingParams(max_tokens=32, temperature=0.7, top_p=0.9, seed=5)),
    ]
    base = eng.stats()
    results, wall = serve_threads(eng, first, lambda _: rest)
    st = eng.stats()
    k1_launches = paged_attention_cuda.launches
    decode_steps = eng.runner.launches["decode"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check_served(eng, results, label)
    pc = st["prefix_cache"]
    if pc["hit_tokens"] <= 0 or pc["cow_forks"] < 1:
        raise AssertionError(f"{label}: expected prefix hits and a CoW fork, got {pc}")
    if decode_steps < 1 or k1_launches != cfg.n_layers * decode_steps:
        raise AssertionError(
            f"{label}: K1 launched {k1_launches} times over {decode_steps} decode steps "
            f"(expected {cfg.n_layers} per step)"
        )
    check_greedy(cfg, params, results, label, forward)

    n_tok = st["tokens_generated"] - base["tokens_generated"]
    d_steps = st["decode_steps"] - base["decode_steps"]
    step_ms = (st["decode_s"] - base["decode_s"]) / max(d_steps, 1) * 1e3
    print(
        f"{label} [{card}]: {len(results)} requests, {n_tok} tokens in {wall:.3f} s "
        f"= {n_tok / wall:.2f} tokens/s; TTFT min/median/max {ttft_ms(results)}; "
        f"decode step {step_ms:.3f} ms over {d_steps} steps; K1 launches {k1_launches} = "
        f"{cfg.n_layers} x {decode_steps}; prefix hit tokens {pc['hit_tokens']}, cow forks "
        f"{pc['cow_forks']}, preemptions {st['preemptions']}; peak memory {peak_gb:.2f} GB"
    )
    return dict(launches=k1_launches, engine=eng, results=results)


def serve_6b(card: str) -> dict:
    """Phase 6: GPT-J-6B, bf16, served by run_loop to several client threads."""
    cfg = GPTJ_6B
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = gptj_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    print(f"GPT-J-6B random init on the card: {time.perf_counter() - t0:.1f} s")
    eng = LLMEngine(
        cfg, params,
        EngineConfig(max_slots=8, block_size=16, max_blocks_per_seq=128, num_blocks=1025,
                     prefill_chunk=256),
    )
    eng.warmup()
    return dict(serve_mix(eng, params, "GPT-J-6B serve", card, gptj_forward), params=params)


def noise_host_ms(eng: LLMEngine, reqs) -> tuple[float, float]:
    """Host time of one decode step's Gumbel noise for ``reqs``' batch, and
    for the same batch made all greedy (mean of 20 calls, device synced)."""
    seeds = [r.params.seed & 0xFFFFFFFF for r in reqs]
    counters = [len(r.out) for r in reqs]
    temp = [r.params.temperature for r in reqs]
    V = eng.model_cfg.vocab_size

    def ms(temps) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            _row_noise(seeds, counters, temps, V, eng.device)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 20

    return ms(temp), ms([0.0] * len(reqs))


def profile_steps(eng: LLMEngine, steps: int, before_step=lambda: None):
    """``steps`` engine steps timed without the profiler (the wall time an
    idle share is read against: the profiler slows the host), then ``steps``
    more under torch.profiler. Returns (wall ms/step, profiled wall ms/step,
    the device kernels' averages)."""

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            before_step()
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    wall_ms = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = run()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return wall_ms, prof_wall_ms, kernels


def print_device_split(kernels, steps: int, wall_ms: float, attn: str, attn_key: str) -> None:
    """Device busy per step against the unprofiled wall, split into cuBLAS
    GEMMs, the attention kernel (``attn_key`` in its name) and the rest,
    with the six longest kernels."""

    def dev_ms(events) -> float:
        return sum(e.self_device_time_total for e in events) / 1e3 / steps

    busy = dev_ms(kernels)
    if busy == 0:
        print("  device time not measured (the profiler saw no device activity)")
        return
    k = dev_ms([e for e in kernels if attn_key in e.key])
    # cuBLAS names its GEMM kernels nvjet_*, *gemm*, *xmma* or cutlass_*
    gemm_words = ("gemm", "nvjet", "xmma", "cutlass")
    gemm = dev_ms([e for e in kernels if any(w in e.key.lower() for w in gemm_words)])
    n_launch = sum(e.count for e in kernels) / steps
    print(
        f"  device busy {busy:.3f} ms/step (idle share {1 - busy / wall_ms:.3f} of the "
        f"unprofiled step), {n_launch:.0f} device ops/step; GEMM {gemm:.3f} ms, "
        f"{attn} {k:.3f} ms ({k / busy:.3f} of busy), other {busy - gemm - k:.3f} ms per step"
    )
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {dev_ms([e]):8.3f} ms/step  {e.count // steps:5d}/step  {e.key[:90]}")


def steady_batch(eng: LLMEngine, max_tokens: int):
    """Phase 7's traffic: every slot running after a 512-token prompt, even
    slots greedy, odd slots sampled."""
    rng = np.random.RandomState(3)
    V = eng.model_cfg.vocab_size
    params = [
        SamplingParams(max_tokens=max_tokens) if i % 2 == 0
        else SamplingParams(max_tokens=max_tokens, temperature=0.8, top_k=50, top_p=0.95, seed=i)
        for i in range(eng.cfg.max_slots)
    ]
    reqs = [eng.submit([int(t) for t in rng.randint(0, V, 512)], p) for p in params]
    while not all(r.state == RUNNING for r in reqs):
        eng.step()
    return reqs


def profile_decode(eng: LLMEngine, card: str, label: str = "decode profile") -> None:
    """Phase 7: where a steady decode step's time goes — every slot decoding
    after a 512-token prompt (half greedy, half sampled); device time by
    kernel against the step's wall time without the profiler."""
    reqs = steady_batch(eng, 64)
    steps = 10
    wall_ms, prof_wall_ms, kernels = profile_steps(eng, steps)
    if not all(r.state == RUNNING for r in reqs):
        raise AssertionError("decode profile: a request finished inside the timed steps")
    noise_ms, noise_greedy_ms = noise_host_ms(eng, reqs)
    n_sampled = sum(r.params.temperature > 0 for r in reqs)
    print(
        f"{label} [{card}]: {len(reqs)} slots ({n_sampled} sampled) at context "
        f"~{reqs[0].seq_len}: {wall_ms:.3f} ms/step wall without the profiler, "
        f"{prof_wall_ms:.3f} ms/step with it; host Gumbel noise {noise_ms:.3f} ms/step "
        f"for this batch, {noise_greedy_ms:.3f} ms/step all greedy"
    )
    print_device_split(kernels, steps, wall_ms, "K1", "paged_decode_")
    for r in reqs:
        eng.cancel(r.id)
    eng.step()


class DenseDrafter:
    """Test double for phases 10 and 18: proposes each request's dense greedy
    continuation, always confident, with one token deliberately wrong in
    every row on every third call (at index (call // 3 + row) % k), so
    full, partial and zero acceptance all run whatever the random model
    does. ``designed`` counts the windows by the acceptance the double
    built in."""

    def __init__(self, k: int, truth: dict, vocab: int):
        self.k = k
        self.truth = truth  # prompt tuple -> dense continuation
        self.vocab = vocab
        self.calls = 0
        self.designed = {"full": 0, "partial": 0, "zero": 0}
        self.last_matched = np.zeros(0, bool)

    def propose(self, contexts):
        rows = []
        for r, ctx in enumerate(contexts):
            prompt = next(p for p in self.truth if tuple(ctx[: len(p)]) == p)
            done = len(ctx) - len(prompt)
            row = (self.truth[prompt][done:] + [0] * self.k)[: self.k]
            if self.calls % 3 == 2:
                j = (self.calls // 3 + r) % self.k
                row[j] = (row[j] + 1) % self.vocab
                self.designed["zero" if j == 0 else "partial"] += 1
            else:
                self.designed["full"] += 1
            rows.append(row)
        self.calls += 1
        self.last_matched = np.ones(len(contexts), bool)
        return np.asarray(rows, np.int32)


def fp32_spec_identity() -> None:
    """Phase 10: GPT-J at full width, 2 layers, fp32 — the speculating
    engine's greedy output equals dense decode token for token
    (``spec_identity``) at spec_k 4 and 9 (a window of 10, past the first
    design's widest)."""
    cfg = GPTJConfig(n_layers=2, dtype="float32")
    params = gptj_init(cfg, torch.Generator(device="cuda").manual_seed(3), "cuda")
    spec_identity(cfg, params, gptj_decode, "gptj_decode", (4, 9))


def spec_identity(cfg, params, decode, label: str, ks) -> None:
    """A speculating 4-slot engine's greedy output equals the dense
    ``decode`` token for token, first with the test-double drafter (full,
    partial and zero acceptance) at each spec_k of ``ks``, then with the
    real n-gram drafter on a prompt with a periodic tail at spec_k 4."""
    ecfg = EngineConfig(max_slots=4, block_size=16, max_blocks_per_seq=32, num_blocks=129,
                        prefill_chunk=64, spec_k=4)
    rng = np.random.RandomState(5)

    def toks(n):
        return [int(t) for t in rng.randint(0, cfg.vocab_size, n)]

    def dense(prompt, n):
        out = decode(cfg, params, torch.tensor([prompt], device="cuda"), n)
        return out[0, len(prompt):].tolist()

    n_new = 32
    prompts = [toks(40), toks(77), toks(130), toks(9)]
    truth = {tuple(p): dense(p, n_new) for p in prompts}
    for k in ks:
        eng = LLMEngine(cfg, params, dataclasses.replace(ecfg, spec_k=k))
        double = DenseDrafter(k, truth, cfg.vocab_size)
        eng._drafter = double
        launches = paged_verify_attention_cuda.launches
        reqs = [eng.submit(p, SamplingParams(max_tokens=n_new)) for p in prompts]
        while not all(r.finished for r in reqs):
            eng.step()
        for p, r in zip(prompts, reqs):
            if r.out != truth[tuple(p)]:
                raise AssertionError(f"fp32 spec engine (spec_k={k}) {r.out} != dense decode {truth[tuple(p)]}")
        st = eng.stats()
        if not (0 < st["spec_accepted"] < st["spec_proposed"]) or min(double.designed.values()) < 1:
            raise AssertionError(f"fp32 spec (spec_k={k}): acceptance not exercised: {st}, {double.designed}")
        if paged_verify_attention_cuda.launches - launches != cfg.n_layers * st["verify_steps"]:
            raise AssertionError(f"fp32 spec (spec_k={k}): K2 launches do not match the verify steps")
        if not (eng.pool.audit()["ok"] and eng.prefix_cache.audit()["ok"]):
            raise AssertionError(f"fp32 spec engine (spec_k={k}): pool or prefix-cache audit failed")
        print(
            f"fp32 spec identity (test-double drafter, spec_k={k}, window {k + 1}): {len(reqs)} requests x "
            f"{n_new} tokens equal dense {label}; {st['verify_steps']} verify steps, windows designed "
            f"{double.designed}, accepted {st['spec_accepted']} of {st['spec_proposed']}"
        )
    pattern = toks(7)
    prompt = toks(30) + pattern * 6  # a periodic tail
    want = dense(prompt, n_new)
    eng = LLMEngine(cfg, params, ecfg)
    out = eng.generate(prompt, SamplingParams(max_tokens=n_new))
    st = eng.stats()
    if out != want:
        raise AssertionError(f"fp32 spec engine (n-gram) {out} != dense decode {want}")
    if st["verify_steps"] < 1:
        raise AssertionError(f"fp32 spec (n-gram): no verify step ran: {st}")
    print(
        f"fp32 spec identity (n-gram drafter, periodic tail): {n_new} tokens equal dense "
        f"{label}; {st['verify_steps']} verify steps, accepted {st['spec_accepted']} of "
        f"{st['spec_proposed']}"
    )


def spec_serve_6b(params, card: str) -> dict:
    """Phase 11: GPT-J-6B, bf16, phase 6's weights, speculating (spec_k=4,
    n-gram drafter), served by run_loop to client threads."""
    torch.cuda.reset_peak_memory_stats()
    eng = LLMEngine(
        GPTJ_6B, params,
        EngineConfig(max_slots=8, block_size=16, max_blocks_per_seq=128, num_blocks=1025,
                     prefill_chunk=256, spec_k=4),
    )
    eng.warmup()
    return spec_serve(eng, params, "GPT-J-6B spec serve", card, gptj_forward)


def spec_serve(eng: LLMEngine, params, label: str, card: str, forward) -> dict:
    """Phase 11's traffic on a warmed-up speculating engine: a first request
    to its end, then 9 from client threads — a regeneration, periodic
    tails, shared heads, greedy and seeded-sampled, 48 new tokens each.
    Checks every request, both audits, K2's launches per verify step, K1's
    per plain decode step and every greedy token against the dense
    ``forward``. Returns the K2 and K1 launches and the engine."""
    cfg = eng.model_cfg
    V = cfg.vocab_size
    rng = np.random.RandomState(6)

    def toks(n):
        return [int(t) for t in rng.randint(0, V, n)]

    n_new = 48
    greedy = SamplingParams(max_tokens=n_new)
    head = toks(256)  # shared head: 16 full blocks
    pat = [toks(12), toks(9), toks(5)]
    first_prompt = head + toks(100)
    first = (first_prompt, greedy)

    def make_rest(first_out):
        # the first request has finished: one client sends its prompt again
        # (a regeneration) after another sent prompt + its output, so the
        # regeneration drafts from that request's cached path
        # (PrefixCache.paths); the others have periodic tails, shared heads,
        # or neither, greedy and seeded-sampled mixed
        return [
            (first_prompt + first_out[:40], greedy),
            (first_prompt, greedy),
            (head + pat[0] * 8, greedy),
            (head + toks(128) + pat[1] * 6,
             SamplingParams(max_tokens=n_new, temperature=0.8, top_k=50, top_p=0.95, seed=7)),
            (toks(300) + pat[2] * 10, greedy),
            (toks(64), greedy),
            (head[:200] + toks(100) + pat[0] * 5,
             SamplingParams(max_tokens=n_new, temperature=1.0, seed=11)),
            (toks(512) + pat[1] * 6, greedy),
            (head + toks(32), SamplingParams(max_tokens=n_new, temperature=0.7, top_p=0.9, seed=5)),
        ]

    base = eng.stats()
    results, wall = serve_threads(eng, first, make_rest, first_to_end=True)
    st = eng.stats()
    k1_launches = paged_attention_cuda.launches
    k2_launches = paged_verify_attention_cuda.launches
    decode_steps = eng.runner.launches["decode"]
    verify_steps = eng.runner.launches["verify"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check_served(eng, results, label)
    if verify_steps < 1 or k2_launches != cfg.n_layers * verify_steps:
        raise AssertionError(
            f"{label}: K2 launched {k2_launches} times over {verify_steps} verify steps "
            f"(expected {cfg.n_layers} per step)"
        )
    if k1_launches != cfg.n_layers * decode_steps:
        raise AssertionError(
            f"{label}: K1 launched {k1_launches} times over {decode_steps} plain decode "
            f"steps (expected {cfg.n_layers} per step)"
        )
    check_greedy(cfg, params, results, label, forward)

    def delta(key):
        return st[key] - base[key]

    n_tok = delta("tokens_generated")
    v_steps, d_steps = delta("verify_steps"), delta("decode_steps")
    proposed, accepted = delta("spec_proposed"), delta("spec_accepted")
    cfg_k = eng.cfg.spec_k
    # host noise of a verify step at this traffic's mix: 8 slots, window 5,
    # the sampled slots' share of the requests
    sampled = [sp for _, sp, _, _ in results.values() if sp.temperature > 0]
    temps = [sp.temperature for sp in sampled] + [0.0] * (S - len(sampled))
    seeds, counters = list(range(S)), [n_new // 2] * S
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        _window_noise(seeds, counters, temps[:S], W, V, eng.device)
    torch.cuda.synchronize()
    noise_ms = (time.perf_counter() - t0) * 1e3 / 20
    print(
        f"{label} [{card}]: {len(results)} requests, {n_tok} tokens in {wall:.3f} s "
        f"= {n_tok / wall:.2f} tokens/s; TTFT min/median/max {ttft_ms(results)}; "
        f"{v_steps} verify steps at {delta('verify_s') / max(v_steps, 1) * 1e3:.3f} ms, "
        f"{d_steps} plain decode steps at {delta('decode_s') / max(d_steps, 1) * 1e3:.3f} ms; "
        f"acceptance {accepted}/{proposed} = {accepted / max(proposed, 1):.3f}, "
        f"{delta('spec_emitted') / max(v_steps, 1):.2f} tokens per verify step "
        f"({delta('spec_emitted') * cfg_k / max(proposed, 1):.2f} per slot window); drafting "
        f"{delta('spec_draft_seconds') / max(v_steps, 1) * 1e3:.3f} ms per verify step "
        f"({delta('spec_draft_seconds') * 1e3:.1f} ms in all); host noise "
        f"{noise_ms:.3f} ms per verify step ({len(sampled[:S])} of {S} slots sampled, W={W}); "
        f"K2 launches {k2_launches} = {cfg.n_layers} x {verify_steps}, K1 launches "
        f"{k1_launches} = {cfg.n_layers} x {decode_steps}; prefix hit tokens "
        f"{st['prefix_cache']['hit_tokens']}, preemptions {st['preemptions']}; peak memory "
        f"{peak_gb:.2f} GB"
    )
    return dict(launches=k2_launches, k1_launches=k1_launches, engine=eng, results=results)


class ConfidentDrafter:
    """Test double for phase 12: proposes each context's last token k times,
    always confident, so the gate opens for every slot."""

    def __init__(self, k: int):
        self.k = k
        self.last_matched = np.zeros(0, bool)

    def propose(self, contexts):
        self.last_matched = np.ones(len(contexts), bool)
        return np.asarray([[ctx[-1]] * self.k for ctx in contexts], np.int32)


def profile_verify(eng: LLMEngine, card: str, label: str = "verify profile") -> None:
    """Phase 12: where a steady verify step's time goes — phase 7's traffic
    on phase 11's speculating engine. The test-double drafter is always
    confident and the acceptance backoff is held off before each step, so
    every timed step is a verify step over all 8 slots (W = spec_k + 1);
    the double's drafting costs nothing, so the wall time holds no n-gram
    search (phase 11 reports that). Device time by kernel against the
    step's wall time without the profiler."""
    eng._drafter = ConfidentDrafter(eng.cfg.spec_k)
    reqs = steady_batch(eng, 256)
    steps = 10
    before = dict(eng.runner.launches)

    def hold_off_backoff():
        eng._spec_skip = 0

    wall_ms, prof_wall_ms, kernels = profile_steps(eng, steps, hold_off_backoff)
    verified = eng.runner.launches["verify"] - before["verify"]
    decoded = eng.runner.launches["decode"] - before["decode"]
    if verified != 2 * steps or decoded != 0:
        raise AssertionError(f"verify profile: {verified} verify and {decoded} decode steps, "
                             f"expected {2 * steps} and 0")
    if not all(r.state == RUNNING for r in reqs):
        raise AssertionError("verify profile: a request finished inside the timed steps")
    w = eng.cfg.spec_k + 1
    seeds = [r.params.seed & 0xFFFFFFFF for r in reqs]
    counters = [len(r.out) for r in reqs]
    temps = [r.params.temperature for r in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        _window_noise(seeds, counters, temps, w, eng.model_cfg.vocab_size, eng.device)
    torch.cuda.synchronize()
    noise_ms = (time.perf_counter() - t0) * 1e3 / 20
    n_sampled = sum(t > 0 for t in temps)
    print(
        f"{label} [{card}]: {len(reqs)} slots ({n_sampled} sampled), W={w}, at context "
        f"~{reqs[0].seq_len}: {wall_ms:.3f} ms/step wall without the profiler, "
        f"{prof_wall_ms:.3f} ms/step with it; host Gumbel noise {noise_ms:.3f} ms/step "
        f"for this batch"
    )
    print_device_split(kernels, steps, wall_ms, "K2", "paged_verify_kernel")
    for r in reqs:
        eng.cancel(r.id)
    eng.step()


# GPT-124M's serving engine: 8 slots, block 16, tables of 64 blocks (the
# positional table's 1024 positions), a pool that holds every slot's table
GPT_ENGINE = EngineConfig(max_slots=8, block_size=16, max_blocks_per_seq=64, num_blocks=513,
                          prefill_chunk=256)


def gpt_fp32_identity() -> None:
    """Phase 18: GPT at full width (vocab 50304, d 768, 12 heads of 64), 2
    layers, fp32 — the engine's greedy output equals the dense
    ``gpt_decode`` token for token, plain (``engine_identity``) and
    speculating at spec_k 4 (``spec_identity``)."""
    cfg = dataclasses.replace(GPT_124M, n_layers=2, dtype="float32")
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(21), "cuda")
    engine_identity(cfg, params, gpt_decode, "gpt_decode")
    spec_identity(cfg, params, gpt_decode, "gpt_decode", (4,))


def serve_gpt(card: str) -> dict:
    """Phase 19: GPT-124M, bf16 over fp32 master weights, full depth: phase
    6's traffic (``serve_mix``, the longest prompt cut to 960 so prompt +
    32 fits the 1024 positions), then phase 11's on a speculating engine
    over the same weights (``spec_serve``)."""
    cfg = GPT_124M
    torch.cuda.reset_peak_memory_stats()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = LLMEngine(cfg, params, GPT_ENGINE)
    eng.warmup()
    served = serve_mix(eng, params, "GPT-124M serve", card, gpt_forward_plain, longest=960)
    torch.cuda.reset_peak_memory_stats()
    spec_eng = LLMEngine(cfg, params, dataclasses.replace(GPT_ENGINE, spec_k=4))
    spec_eng.warmup()
    spec = spec_serve(spec_eng, params, "GPT-124M spec serve", card, gpt_forward_plain)
    return dict(k1=served["launches"], k2=spec["launches"], engine=eng, spec_engine=spec_eng)


def start_loop(eng: LLMEngine):
    """``run_loop`` in a daemon thread; returns (stop event, thread)."""
    stop = threading.Event()
    loop = threading.Thread(target=eng.run_loop, args=(stop,), daemon=True)
    loop.start()
    return stop, loop


def stop_loop(stop, loop) -> None:
    stop.set()
    loop.join(timeout=60)
    if loop.is_alive():
        raise AssertionError("run_loop did not stop")


def hot_swap_gpt(eng: LLMEngine, card: str) -> dict:
    """Phase 21: ``update_weights`` to a second seed's weights in the middle
    of traffic. Four requests of 256 tokens (greedy and sampled, two with a
    cached 256-token head) stream under ``run_loop`` until each has 8
    tokens; the loop pauses, the swap lands between two steps with the four
    in flight, the loop resumes; four more requests of 48 tokens follow,
    and the same weights are swapped in once more with the loop busy (the
    time a swap waits for the engine lock under traffic). Checks that every parameter keeps
    its storage, the version moves by one and is stamped on each request,
    the prefix tree is emptied and its epoch bumped, every request is served
    (the early ones continue under the new weights) with K1 at 12 launches
    a decode step, and every greedy token of the later requests against the
    dense forward under the NEW weights. Times the swap (host clock, device
    synced)."""
    cfg = eng.model_cfg
    new = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    ptrs = {n: p.data_ptr() for n, p in eng.runner.params.named_parameters()}
    version0, epoch0 = eng.weights_version, eng.prefix_cache.epoch
    rng = np.random.RandomState(9)

    def toks(n):
        return [int(t) for t in rng.randint(0, cfg.vocab_size, n)]

    greedy = SamplingParams(max_tokens=48)
    sampled = SamplingParams(max_tokens=48, temperature=0.9, top_k=40, seed=3)
    # the early requests run long enough that none can end before the swap
    long_greedy, long_sampled = (dataclasses.replace(sp, max_tokens=256) for sp in (greedy, sampled))
    head = toks(256)
    eng.generate(head + toks(16), SamplingParams(max_tokens=2))  # the head's blocks in the tree
    early = [(head + toks(64), long_greedy), (toks(300), long_sampled), (head + toks(200), long_greedy),
             (toks(90), long_greedy)]
    late = [(head + toks(32), greedy), (toks(100), greedy), (head[:100] + toks(50), greedy), (toks(60), sampled)]
    results = {}

    def wait(cond, what):
        deadline = time.monotonic() + 300
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"hot swap: {what}")
            time.sleep(0.002)

    # the path's run starts here: every count from 0
    paged_attention_cuda.launches = 0
    paged_verify_attention_cuda.launches = 0
    eng.runner.launches = dict.fromkeys(eng.runner.launches, 0)
    loop = start_loop(eng)
    try:
        reqs = [eng.submit(p, sp) for p, sp in early]
        wait(lambda: all(len(r.out) >= 8 for r in reqs), "the early requests did not start")
        # the loop pauses for the swap: a thread blocked on the engine lock
        # can wait many steps behind a busy run_loop, whose next step takes
        # the lock again at once (Python's locks are not fair)
        stop_loop(*loop)
        cached = eng.prefix_cache.stats()["cached_blocks"]
        in_flight = sum(not r.finished for r in reqs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        version = eng.update_weights(new)
        torch.cuda.synchronize()
        swap_ms = (time.perf_counter() - t0) * 1e3
        after = eng.prefix_cache.stats()["cached_blocks"]
        loop = start_loop(eng)
        reqs += [eng.submit(p, sp) for p, sp in late]
        # the same weights again with the loop busy: how long a swap waits
        # for the engine lock under traffic (the values do not change)
        t0 = time.perf_counter()
        busy_version = eng.update_weights(new)
        torch.cuda.synchronize()
        busy_swap_ms = (time.perf_counter() - t0) * 1e3
        busy_steps = eng.stats()["steps"]
        wait(lambda: all(r.finished for r in reqs), "a request did not finish")
    finally:
        stop_loop(*loop)
    k1_launches = paged_attention_cuda.launches
    decode_steps = eng.runner.launches["decode"]
    for idx, ((prompt, sp), req) in enumerate(zip(early + late, reqs)):
        results[idx] = (prompt, sp, req, list(eng.stream_tokens(req, timeout=5)))
    check_served(eng, results, "hot swap")
    if {n: p.data_ptr() for n, p in eng.runner.params.named_parameters()} != ptrs:
        raise AssertionError("hot swap: a parameter moved to new storage")
    if version != version0 + 1 or busy_version != version + 1 or eng.weights_version != busy_version:
        raise AssertionError(f"hot swap: version {version0} -> {version} -> {busy_version}")
    stamps = [r.weights_version for r in reqs]
    if stamps != [version0] * len(early) + [version] * len(late):
        raise AssertionError(f"hot swap: request versions {stamps}")
    if not (cached > 0 and after == 0 and eng.prefix_cache.epoch == epoch0 + 2):
        raise AssertionError(f"hot swap: prefix tree {cached} -> {after} blocks, epoch {epoch0} -> "
                             f"{eng.prefix_cache.epoch}")
    if in_flight != len(early):
        raise AssertionError(f"hot swap: {len(early) - in_flight} early requests ended before the swap")
    if decode_steps < 1 or k1_launches != cfg.n_layers * decode_steps:
        raise AssertionError(f"hot swap: K1 launched {k1_launches} times over {decode_steps} decode steps")
    check_greedy(cfg, new, results, "hot swap (requests after the swap, new weights)", gpt_forward_plain,
                 indices=range(len(early), len(reqs)))
    print(
        f"GPT-124M hot swap [{card}]: update_weights {swap_ms:.3f} ms (host clock, device synced; "
        f"{sum(p.numel() for p in new.parameters()) / 1e6:.1f}M fp32 parameters copied in place), version "
        f"{version0} -> {version}; with run_loop busy {busy_swap_ms:.3f} ms (lock wait included; "
        f"{busy_steps} engine steps so far); {in_flight} requests in flight across it; prefix tree {cached} -> "
        f"{after} cached blocks, epoch {epoch0} -> {eng.prefix_cache.epoch} (two swaps); {len(reqs)} requests served, "
        f"K1 launches {k1_launches} = {cfg.n_layers} x {decode_steps}"
    )
    return dict(swap_ms=swap_ms, busy_swap_ms=busy_swap_ms, launches=k1_launches)


# phase 22: GPT-124M's engine with the production half on — phase 19's
# engines (watchdog deadlines cut to 1 s and 0.1 s so a wedge of a few
# seconds reads as a stall)
GPT_PROD_ENGINE = dataclasses.replace(GPT_ENGINE, watchdog_stall_s=1.0, watchdog_interval_s=0.1)
WEDGE_S = 4.0  # the device spin phase 22 (c) puts in front of one decode step
HOOK_PAIRS = {"decode": 100, "verify": 40}  # phase 22 (e): on/off pairs of steps
HOOK_STEPS = 10  # phase 22 (e): warm-up steps, which also count an on step's records


def metric_value(metric, tags: str = ""):
    """A metric's merged value in this process (a float, or a histogram's
    buckets + sum + count)."""
    return metric._snapshot()["data"].get(tags, 0.0)


def hist_delta(metric, before) -> list:
    """A histogram's buckets + sum + count gained since ``before``."""
    now = metric_value(metric)
    if not isinstance(now, list):
        return [0] * (len(metric.boundaries) + 3)
    if not isinstance(before, list):
        return list(now)
    return [a - b for a, b in zip(now, before)]


def reset_counts(*engines) -> None:
    """Every kernel launch count and the engines' step counts to 0: a part
    of phase 22 starts here."""
    paged_attention_cuda.launches = 0
    paged_verify_attention_cuda.launches = 0
    for eng in engines:
        eng.runner.launches = dict.fromkeys(eng.runner.launches, 0)


def check_counts(label: str, *engines) -> tuple[int, int]:
    """K1 at n_layers launches a decode step and K2 at n_layers a verify
    step of ``engines`` since ``reset_counts``; returns (K1, K2) launches."""
    layers = engines[0].model_cfg.n_layers
    decode = sum(e.runner.launches["decode"] for e in engines)
    verify = sum(e.runner.launches["verify"] for e in engines)
    k1, k2 = paged_attention_cuda.launches, paged_verify_attention_cuda.launches
    if k1 != layers * decode or k2 != layers * verify:
        raise AssertionError(f"{label}: K1 {k1} launches over {decode} decode steps, K2 {k2} over "
                             f"{verify} verify steps (expected {layers} a step)")
    return k1, k2


def check_request_hooks(eng: LLMEngine, results: dict, label: str) -> dict:
    """Per request of ``results``: its flight-recorder events run submit →
    admit → first token → ... → finish; its engine phases sum to finish −
    submit within 1e-6 s (the ledger's cursor ends at the finish stamp);
    verify time lands in ``spec_verify`` (a request with verify steps has
    some, one without has none) and a request with no plain decode step
    has no more than its finish tail in ``decode``. Returns the phase
    totals over the requests."""
    totals = dict.fromkeys(phases.ENGINE_PHASES, 0.0)
    worst = 0.0
    for idx, (_prompt, _sp, req, _) in sorted(results.items()):
        types = [e["type"] for e in events.snapshot(req.trace_id)]
        order = [types.index(t) if t in types else -1
                 for t in ("llm.submit", "llm.admit", "llm.first_token", "llm.phase.ledger", "llm.finish")]
        if order != sorted(order) or order[0] != 0 or -1 in order or types[-1] != "llm.finish":
            raise AssertionError(f"{label}: request {idx} events out of order: {types[:6]} ... {types[-3:]}")
        led = req.phase_led
        gap = abs(sum(led[1:]) - (led[0] - req.arrival_t))
        worst = max(worst, gap)
        if gap > 1e-6:
            raise AssertionError(f"{label}: request {idx} phases sum {sum(led[1:])} s, finish - submit "
                                 f"{led[0] - req.arrival_t} s")
        got = dict(zip(phases.ENGINE_PHASES, led[1:]))
        if (got["spec_verify"] > 0) != ("llm.verify" in types):
            raise AssertionError(f"{label}: request {idx} spec_verify {got['spec_verify']} with "
                                 f"{types.count('llm.verify')} verify steps")
        if "llm.decode" not in types and got["decode"] > 1e-3:
            raise AssertionError(f"{label}: request {idx} has no plain decode step but {got['decode']} s "
                                 f"in decode")
        for k, v in got.items():
            totals[k] += v
    print(f"  {label}: {len(results)} requests' events in order; phases sum to finish - submit within "
          f"{worst:.3g} s; phase totals " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in totals.items()))
    return totals


def hooks_under_traffic(eng: LLMEngine, spec_eng: LLMEngine, params, card: str) -> tuple[int, int]:
    """Phase 22 (a): phase 19's traffic, plain (``serve_mix``) and at
    spec_k=4 (``spec_serve``), with every hook on; the counters against
    what was streamed and the engines' own counts, the inter-token latency
    histogram against the tokens, each request's events and phases."""
    m = engine_mod._metrics()
    k1 = k2 = 0
    for label, engine in (("plain", eng), ("spec_k=4", spec_eng)):
        keys = ("tokens", "finished", "spec_proposed", "spec_accepted")
        before = {k: metric_value(m[k]) for k in keys}
        itl0, ttft0 = metric_value(m["itl"]), metric_value(m["ttft"])
        base = engine.stats()
        events.clear()
        if engine is eng:
            served = serve_mix(engine, params, "GPT-124M serve, hooks on", card, gpt_forward_plain, longest=960)
        else:
            served = spec_serve(engine, params, "GPT-124M spec serve, hooks on", card, gpt_forward_plain)
        results = served["results"]
        a, b = check_counts(f"hooks ({label})", engine)
        k1, k2 = k1 + a, k2 + b
        st = engine.stats()
        got = {k: metric_value(m[k]) - before[k] for k in keys}
        streamed = sum(len(r[3]) for r in results.values())
        if got["tokens"] != streamed or got["finished"] != len(results):
            raise AssertionError(f"hooks ({label}): llm_generated_tokens +{got['tokens']} for {streamed} "
                                 f"streamed, llm_finished_requests +{got['finished']} for {len(results)}")
        spec = (st.get("spec_proposed", 0) - base.get("spec_proposed", 0),
                st.get("spec_accepted", 0) - base.get("spec_accepted", 0))
        if (got["spec_proposed"], got["spec_accepted"]) != spec:
            raise AssertionError(f"hooks ({label}): spec counters {got} against the engine's {spec}")
        itl, ttft = hist_delta(m["itl"], itl0), hist_delta(m["ttft"], ttft0)
        if itl[-1] != streamed - len(results) or ttft[-1] != len(results):
            raise AssertionError(f"hooks ({label}): {itl[-1]} inter-token gaps and {ttft[-1]} first tokens "
                                 f"for {streamed} tokens of {len(results)} requests")
        itl_median = metrics.percentiles_from_buckets(m["itl"].boundaries, itl[:-2], 0.5)
        steps = st["decode_steps"] - base["decode_steps"]
        step_ms = (st["decode_s"] - base["decode_s"]) / max(steps, 1) * 1e3
        if engine is spec_eng:
            v_steps = st["verify_steps"] - base["verify_steps"]
            step_ms = (st["verify_s"] - base["verify_s"] + st["decode_s"] - base["decode_s"]) / max(
                steps + v_steps, 1) * 1e3
        print(f"  hooks ({label}) [{card}]: llm_generated_tokens +{got['tokens']:.0f} = streamed, "
              f"llm_finished_requests +{got['finished']:.0f}, spec draft/accepted +{got['spec_proposed']:.0f}/"
              f"+{got['spec_accepted']:.0f} = the engine's; inter-token latency: {itl[-1]} gaps (tokens - "
              f"requests), median {itl_median * 1e3:.3f} ms (bucket interpolation) against the host-clock "
              f"decode{'/verify' if engine is spec_eng else ''} step of this run {step_ms:.3f} ms; mean "
              f"{itl[-2] / max(itl[-1], 1) * 1e3:.3f} ms")
        totals = check_request_hooks(engine, results, f"hooks ({label})")
        if (totals["spec_verify"] > 0) != (engine is spec_eng):
            raise AssertionError(f"hooks ({label}): spec_verify total {totals['spec_verify']}")
    return k1, k2


def ledger_against_card(eng: LLMEngine, spec_eng: LLMEngine, params, swap_bytes) -> None:
    """Phase 22 (b): the HBM ledger against the card's own accounting, and
    (``swap_bytes``, when phase 21 ran) phase 21's engine's params_bytes
    before and after its ``update_weights``."""
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    unique = {p.untyped_storage().data_ptr(): p.untyped_storage().nbytes() for p in params.parameters()}
    n_values = sum(p.numel() for p in params.parameters())
    total = 0
    for label, engine in (("plain", eng), ("spec_k=4", spec_eng)):
        led = engine.hbm_ledger()
        usable = engine.pool.cfg.num_blocks - 1
        if led["params_bytes"] != sum(unique.values()):
            raise AssertionError(f"ledger ({label}): params_bytes {led['params_bytes']} != "
                                 f"{sum(unique.values())} of unique storage")
        if led["pool_bytes"] != engine.pool.k.nbytes + engine.pool.v.nbytes:
            raise AssertionError(f"ledger ({label}): pool_bytes {led['pool_bytes']}")
        if led["seq_bytes"] + led["cache_bytes"] + led["free_bytes"] != usable * led["block_bytes"]:
            raise AssertionError(f"ledger ({label}): partition {led} != {usable} x block_bytes")
        held = led["params_bytes"] + led["pool_bytes"] + led["drafter_bytes"]
        if held > allocated:
            raise AssertionError(f"ledger ({label}): {held} bytes held > memory_allocated {allocated}")
        total += led["pool_bytes"] + led["drafter_bytes"]
        print(f"  ledger ({label}): params {led['params_bytes']} B ({n_values / 1e6:.1f}M fp32 values, "
              f"{len(unique)} storages), pool {led['pool_bytes']} B = k + v, block {led['block_bytes']} B, "
              f"seq {led['seq_bytes']} + cache {led['cache_bytes']} + free {led['free_bytes']} = {usable} "
              f"usable blocks; params + pool + drafter {held} B <= memory_allocated {allocated} B")
    total += sum(unique.values())
    print(f"  ledger: both engines (params shared) hold {total} B of memory_allocated {allocated} B; the "
          f"rest, {allocated - total} B ({(allocated - total) / 1e6:.1f} MB), is activations, workspace "
          f"and the kernels' per-stream workspace")
    if swap_bytes is None:
        return
    if swap_bytes[0] != swap_bytes[1]:
        raise AssertionError(f"ledger: params_bytes {swap_bytes[0]} before phase 21's update_weights, "
                             f"{swap_bytes[1]} after")
    print(f"  ledger: phase 21's engine params_bytes {swap_bytes[0]} before update_weights, {swap_bytes[1]} "
          f"after (written in place)")


def spin_cycles(seconds: float) -> int:
    """Clock cycles of ``torch.cuda._sleep`` that spin the device about
    ``seconds``, calibrated with CUDA events on a 50 ms spin."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    n = 100_000_000
    for _ in range(2):  # the first spin pays the launch's setup
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(n)
        end.record()
        torch.cuda.synchronize()
        per_ms = n / start.elapsed_time(end)
        n = int(per_ms * 50)
    return int(per_ms * seconds * 1e3)


def device_spin(cycles: int):
    """Spin the current stream for ``cycles``; returns an event that is
    complete once the spin has ended (``query()`` is False until then)."""
    torch.cuda._sleep(cycles)
    done = torch.cuda.Event()
    done.record()
    return done


def watchdog_wedge(eng: LLMEngine, params, card: str) -> tuple[int, int]:
    """Phase 22 (c): the watchdog under a real device wedge. A test double
    wraps ``runner.decode_step`` for one call and puts a ~4 s device spin in
    front of the real call; the step's one host sync then waits on the
    device while the step holds the engine lock. While the device spins:
    one stall event, the stall counter +1, the step-age gauge >= 1 s, a
    1.5 s-deadline request's stream ended by the watchdog's lockless
    unblock, and ``stream_tokens(timeout=2.0)`` raising
    ``EngineStalledError``. After: the engine resumes, the step age returns
    to 0, the audits are clean, and the surviving requests' greedy tokens
    match the dense forward. None of this can happen unless the step
    thread's device wait releases the GIL: then the phase fails."""
    wm = watchdog_mod._metrics()
    cycles = spin_cycles(WEDGE_S)
    rng = np.random.RandomState(12)

    def toks(n):
        return [int(t) for t in rng.randint(0, eng.model_cfg.vocab_size, n)]

    real_decode = eng.runner.decode_step
    wedge: dict = {}

    def wedged_decode(*args, **kw):
        eng.runner.decode_step = real_decode  # one call only
        wedge["t0"] = time.monotonic()
        wedge["done"] = device_spin(cycles)
        return real_decode(*args, **kw)

    def spinning() -> bool:
        return "done" in wedge and not wedge["done"].query()

    outcome: dict = {}

    def consume(name, req, timeout):
        got = []
        try:
            for t in eng.stream_tokens(req, timeout=timeout):
                got.append(t)
            outcome[name] = ("ended", time.monotonic(), spinning(), got)
        except EngineStalledError as err:
            outcome[name] = ("stalled", time.monotonic(), spinning(), err)
        except BaseException as err:  # surfaced below
            outcome[name] = ("error", time.monotonic(), False, err)

    wd = eng.start_watchdog()  # after warmup(): kernel builds are not stalls
    stalls0, leaks0, wd_stalls0 = metric_value(wm["stalls"]), metric_value(wm["leaks"]), wd.stall_count
    reset_counts(eng)
    events.clear()
    greedy = SamplingParams(max_tokens=48)
    # every request is in before the loop starts (a submit from another
    # thread can wait several steps for the engine lock): the doomed one
    # first, into an empty engine (no backlog: never shed), then the
    # survivors and the probe; the wedge is armed, and the loop's first
    # step prefills the doomed request and decodes it behind the spin
    doomed = eng.submit(toks(32), SamplingParams(max_tokens=200), deadline_s=1.5)
    survivors = [(p, greedy) for p in (toks(64), toks(150), toks(200))]
    reqs = [eng.submit(p, sp) for p, sp in survivors]
    probe = eng.submit(toks(40), SamplingParams(max_tokens=16))
    eng.runner.decode_step = wedged_decode
    consumers = [threading.Thread(target=consume, args=("doomed", doomed, 60)),
                 threading.Thread(target=consume, args=("probe", probe, 2.0))]
    consumers += [threading.Thread(target=consume, args=(i, r, 60)) for i, r in enumerate(reqs)]
    for t in consumers:
        t.start()
    loop = start_loop(eng)
    try:
        age_max = 0.0
        t_arm = time.monotonic()
        while "done" not in wedge or spinning():
            age_max = max(age_max, metric_value(wm["step_age"]))
            time.sleep(0.02)
            if time.monotonic() - t_arm > 60:
                raise AssertionError("wedge: the spin did not start or did not end")
        spin_s = time.monotonic() - wedge["t0"]
        for t in consumers:
            t.join(timeout=120)
        if any(t.is_alive() for t in consumers):
            raise AssertionError("wedge: a consumer did not finish")
        # the engine has resumed: let the loop drain, then the watchdog tick
        deadline = time.monotonic() + 60
        while eng.has_work() or metric_value(wm["step_age"]) != 0.0:
            if time.monotonic() > deadline:
                raise AssertionError(f"wedge: step age {metric_value(wm['step_age'])} after the spin")
            time.sleep(0.02)
    finally:
        eng.runner.decode_step = real_decode
        stop_loop(*loop)
    stall_events = [e for e in events.snapshot() if e["type"] == "llm.watchdog.stall"]
    by_watchdog = [e for e in stall_events if e.get("source") == "watchdog"]
    reap_events = [e for e in events.snapshot() if e["type"] == "llm.watchdog.reap"]
    leak_events = [e for e in events.snapshot() if e["type"] == "llm.watchdog.leak"]
    kind, t_doomed, doomed_spinning, _ = outcome["doomed"]
    pkind, t_probe, probe_spinning, err = outcome["probe"]
    if len(by_watchdog) != 1 or metric_value(wm["stalls"]) - stalls0 != 1 or wd.stall_count - wd_stalls0 != 1:
        raise AssertionError(f"wedge: {len(by_watchdog)} watchdog stall events, counter "
                             f"+{metric_value(wm['stalls']) - stalls0}")
    if age_max < 1.0 or by_watchdog[0]["last_step_age_s"] < 1.0:
        raise AssertionError(f"wedge: step age gauge peaked at {age_max} s")
    if kind != "ended" or not doomed_spinning or doomed.finish_reason != "deadline":
        raise AssertionError(f"wedge: the doomed stream {kind}, device spinning then: {doomed_spinning}, "
                             f"finish {doomed.finish_reason}")
    if not any(e["mode"] == "emergency" for e in reap_events):
        raise AssertionError(f"wedge: no lockless reap: {reap_events}")
    if pkind != "stalled" or not probe_spinning or err.last_step_age_s < 1.0 or err.queue_depth < 1:
        raise AssertionError(f"wedge: the probe {pkind} ({err!r}), device spinning then: {probe_spinning}")
    audit = wd.check_once()["audit"]
    if not audit["ok"] or leak_events or metric_value(wm["leaks"]) != leaks0 or metric_value(wm["audit_ok"]) != 1.0:
        raise AssertionError(f"wedge: audit {audit}, leak events {leak_events}")
    results = {i: (p, sp, r, outcome[i][3]) for i, ((p, sp), r) in enumerate(zip(survivors, reqs))}
    check_served(eng, results, "wedge survivors")
    check_greedy(eng.model_cfg, params, results, "wedge survivors", gpt_forward_plain)
    k1, k2 = check_counts("wedge", eng)
    print(
        f"  wedge [{card}]: device spin {spin_s:.2f} s ({cycles} cycles) in front of one decode step; "
        f"watchdog stall event at step age {by_watchdog[0]['last_step_age_s']:.3f} s, gauge peak "
        f"{age_max:.3f} s; the 1.5 s-deadline stream ended {t_doomed - wedge['t0']:.3f} s into the spin "
        f"(lockless reap); the probe's stream_tokens(timeout=2.0) raised EngineStalledError "
        f"{t_probe - wedge['t0']:.3f} s into it (last_step_age_s {err.last_step_age_s:.3f}, queue_depth "
        f"{err.queue_depth}, kv_utilization {err.kv_utilization:.3f}); after: step age 0, audit ok, no leak "
        f"event, {len(reqs)} survivors served; K1 launches {k1}"
    )
    return k1, k2


def shed_at_service_rate(eng: LLMEngine, card: str) -> tuple[int, int]:
    """Phase 22 (d): deadline shedding at the card's own service rate. Eight
    slots of 256-token requests serve for more than one 0.5 s rate window;
    a request whose deadline is below backlog / rate is refused with
    ``OverloadedError`` (``retry_after_s`` = estimate - deadline), an
    ``llm.shed`` event and ``llm_shed_requests`` + 1; one with ten times the
    estimate is admitted and finishes inside it."""
    m = engine_mod._metrics()
    rng = np.random.RandomState(13)
    V = eng.model_cfg.vocab_size
    reset_counts(eng)
    events.clear()
    shed0 = metric_value(m["shed"])
    loop = start_loop(eng)
    try:
        fill = [eng.submit([int(t) for t in rng.randint(0, V, 128)], SamplingParams(max_tokens=256))
                for _ in range(eng.cfg.max_slots)]
        t0 = time.monotonic()
        # the rate is read without the engine lock: a thread waiting for it
        # can wait many steps behind the busy loop (Python's locks are not fair)
        while time.monotonic() - t0 < 0.6 or eng._rate <= 0:
            if time.monotonic() - t0 > 60:
                raise AssertionError("shed: no service rate measured")
            time.sleep(0.05)
        # the loop pauses for the two submits, as phase 21 pauses it for its
        # swap: a submit blocked on the engine lock can wait out the backlog
        stop_loop(*loop)
        rate = eng._rate
        n_new = 64
        backlog = sum(max(r.params.max_tokens - len(r.out), 0) for r in fill)
        est = (backlog + n_new) / rate
        deadline = est / 4
        try:
            eng.submit([int(t) for t in rng.randint(0, V, 64)], SamplingParams(max_tokens=n_new),
                       deadline_s=deadline)
            raise AssertionError(f"shed: a {deadline:.3f} s deadline against a {est:.3f} s estimate was admitted")
        except OverloadedError as err:
            refused = err
        (ev,) = [e for e in events.snapshot() if e["type"] == "llm.shed"]
        loose_s = 10 * est
        loose = eng.submit([int(t) for t in rng.randint(0, V, 64)], SamplingParams(max_tokens=n_new),
                           deadline_s=loose_s)
        loop = start_loop(eng)
        streamed = list(eng.stream_tokens(loose, timeout=loose_s + 30))
        took = time.time() - loose.arrival_t
        for r in fill:
            eng.cancel(r.id)
        while eng.has_work():
            time.sleep(0.01)
    finally:
        stop_loop(*loop)
    if refused.retry_after_s != max(0.1, round(ev["estimate_s"] - deadline, 2)):
        raise AssertionError(f"shed: retry_after_s {refused.retry_after_s} against the event's {ev}")
    if abs(ev["estimate_s"] - est) > 0.2 * est or metric_value(m["shed"]) - shed0 != 1:
        raise AssertionError(f"shed: engine estimate {ev['estimate_s']} s against {est:.3f} s, counter "
                             f"+{metric_value(m['shed']) - shed0}")
    if loose.finish_reason != "length" or len(streamed) != n_new or took > loose_s:
        raise AssertionError(f"shed: the loose request ended {loose.finish_reason} after {took:.3f} s "
                             f"(deadline {loose_s:.3f} s)")
    k1, k2 = check_counts("shed", eng)
    print(
        f"  shed [{card}]: service rate {rate:.1f} tokens/s with {len(fill)} slots of 256-token requests; "
        f"backlog {backlog} + {n_new} tokens -> estimate {est:.3f} s (engine's {ev['estimate_s']:.3f} s); a "
        f"{deadline:.3f} s deadline refused with OverloadedError, retry_after_s {refused.retry_after_s} "
        f"(estimate - deadline {ev['estimate_s'] - deadline:.3f} s), llm_shed_requests +1; a {loose_s:.3f} s "
        f"deadline admitted, finished in {took:.3f} s"
    )
    return k1, k2


def hooks_off(reqs) -> dict:
    """Everything the hooks cost turned off: the flight recorder, the phase
    gate, and tracing at sample rate 0 on the stepping thread (an unsampled
    context, so the step span is the shared null span). A request carries
    its phase ledger from submit; requests submitted with the gate off
    carry none, as ``reqs`` do while it is off. Returns what ``hooks_on``
    restores."""
    saved = dict(env=os.environ.get("RAY_TPU_TRACE_SAMPLE"), led={r.id: r.phase_led for r in reqs})
    events.set_enabled(False)
    phases.set_enabled(False)
    for r in reqs:
        r.phase_led = None
    os.environ["RAY_TPU_TRACE_SAMPLE"] = "0"
    saved["ctx"] = tracing.set_trace_context(tracing.mint_context())
    return saved


def hooks_on(reqs, saved: dict) -> None:
    events.set_enabled(True)
    phases.set_enabled(True)
    for r in reqs:
        r.phase_led = saved["led"][r.id]
    if saved["env"] is None:
        os.environ.pop("RAY_TPU_TRACE_SAMPLE", None)
    else:
        os.environ["RAY_TPU_TRACE_SAMPLE"] = saved["env"]
    tracing.set_trace_context(saved["ctx"])


def host_us(fn, n: int = 20000) -> float:
    """Host time of one call of ``fn``, µs (mean of ``n`` after a warm-up)."""
    for _ in range(100):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def hook_call_us(eng: LLMEngine) -> dict:
    """Each hook's host time per call in this process, µs: the toggled hooks
    (a flight-recorder event with a step's fields, the step span with its
    attributes, a phase charge) and the metrics on in both arms (a counter,
    the inter-token histogram, ``_publish_gauges`` with its pool-lock
    snapshot)."""
    m = engine_mod._metrics()
    led = phases.new_ledger(time.time())

    def span():
        with tracing.span("llm_engine_step", step=1, running=8, waiting=0, spec={"k": 4}):
            pass

    def publish():
        with eng._lock:
            eng._publish_gauges()

    out = dict(
        record=host_us(lambda: events.record("llm.decode", request_id="req-0", engine_req="req-0",
                                             step=1, token=5)),
        span=host_us(span),
        charge=host_us(lambda: phases.charge(led, phases.DECODE, time.time())),
        counter=host_us(lambda: m["tokens"].inc()),
        histogram=host_us(lambda: m["itl"].observe(0.02)),
        publish=host_us(publish, 2000),
    )
    events.clear()
    tracing.clear()
    return out


def hooks_cost(eng: LLMEngine, spec_eng: LLMEngine, card: str) -> tuple[int, int]:
    """Phase 22 (e): what the hooks cost a steady step. Phase 20's steady
    decode steps (8 slots after 512-token prompts, half sampled) and verify
    steps (the confident test-double drafter, W 5), with the arms in turns
    of one step: pairs of steps, one on and one off, the order alternating
    from pair to pair, each step's wall ending in its own host sync. A
    step's host noise (the sampled slots' Gumbel draws, Python dispatch,
    other threads) moves it by milliseconds from one step to the next, so
    the estimate is the median of the pairs' differences; the hooks' own
    host time per step is printed beside it: the events, spans and charges
    an on step makes times each one's host time per call in this process
    (``hook_call_us``)."""
    k1 = k2 = 0
    for label, engine in (("decode", eng), ("verify", spec_eng)):
        pairs = HOOK_PAIRS[label]
        if engine is spec_eng:
            engine._drafter = ConfidentDrafter(engine.cfg.spec_k)
        # 512 + 500 positions fit the table; a verify step emits at most 5
        # tokens a slot, so no request can finish inside the timed steps
        reqs = steady_batch(engine, 500)
        reset_counts(engine)

        def step(arm) -> float:
            saved = hooks_off(reqs) if arm == "off" else None
            try:
                engine._spec_skip = 0  # every speculating step a verify step
                t0 = time.perf_counter()
                engine.step()
                return (time.perf_counter() - t0) * 1e3
            finally:
                if saved is not None:
                    hooks_on(reqs, saved)

        # warm-up steps that also count what an on step records
        events.clear()
        tracing.clear()
        for _ in range(HOOK_STEPS):
            step("on")
        evs = events.snapshot()
        per_step = dict(
            record=len(evs) / HOOK_STEPS,
            span=len(tracing.get_spans()) / HOOK_STEPS,
            # one charge per active request per step, beside its llm.decode/llm.verify
            charge=sum(e["type"] in ("llm.decode", "llm.verify") for e in evs) / HOOK_STEPS,
        )
        # tokens emitted per step: one per llm.decode, accepted + 1 per llm.verify
        tokens = sum(e.get("accepted", 0) + 1 for e in evs
                     if e["type"] in ("llm.decode", "llm.verify")) / HOOK_STEPS
        walls = {"on": [], "off": []}
        diffs = []
        for i in range(pairs):
            got = {arm: step(arm) for arm in (("on", "off") if i % 2 == 0 else ("off", "on"))}
            for arm, ms in got.items():
                walls[arm].append(ms)
            diffs.append(got["on"] - got["off"])
        if not all(r.state == RUNNING for r in reqs):
            raise AssertionError(f"hooks cost ({label}): a request finished inside the timed steps")
        step_kind = "verify" if engine is spec_eng else "decode"
        other = "decode" if step_kind == "verify" else "verify"
        if engine.runner.launches[step_kind] != HOOK_STEPS + 2 * pairs or engine.runner.launches[other]:
            raise AssertionError(f"hooks cost ({label}): {engine.runner.launches}")
        a, b = check_counts(f"hooks cost ({label})", engine)
        k1, k2 = k1 + a, k2 + b
        us = hook_call_us(engine)
        hooks_us = sum(per_step[k] * us[k] for k in per_step)
        metrics_us = us["publish"] + (us["counter"] + us["histogram"]) * tokens
        on, off = (float(np.median(walls[arm])) for arm in ("on", "off"))
        diff = float(np.median(diffs))
        q1, q3 = (float(np.percentile(diffs, q)) for q in (25, 75))
        print(f"  hooks cost, {label} step [{card}]: {pairs} pairs of steps, on and off in turns: hooks on "
              f"median {on:.3f} ms/step, off {off:.3f} ms/step; median paired difference on - off "
              f"{diff * 1e3:.1f} us/step = {diff / on * 100:.2f}% of the step (quartiles {q1 * 1e3:.1f} / "
              f"{q3 * 1e3:.1f} us; on slower in {sum(d > 0 for d in diffs)} of {pairs} pairs)")
        print(f"  hooks cost, {label} step, host time of the hooks themselves [{card}]: per step "
              f"{per_step['record']:.1f} events x {us['record']:.3f} us + {per_step['span']:.1f} span x "
              f"{us['span']:.3f} us + {per_step['charge']:.1f} phase charges x {us['charge']:.3f} us = "
              f"{hooks_us:.1f} us ({hooks_us / 1e3 / on * 100:.2f}% of the on step); the metrics, on in both "
              f"arms: _publish_gauges {us['publish']:.3f} us + {tokens:.1f} tokens x (counter "
              f"{us['counter']:.3f} + histogram {us['histogram']:.3f}) us = {metrics_us:.1f} us")
        for r in reqs:
            engine.cancel(r.id)
        engine.step()
    return k1, k2


def production_engine(card: str, swap_bytes=None) -> dict:
    """Phase 22: phase 19's GPT-124M engines (seed 0, bf16 over fp32
    masters, plain and spec_k=4) with the production half on: (a) metrics,
    events and phases under phase 19's traffic; (b) the HBM ledger against
    the card; (c) the watchdog under a real device wedge; (d) deadline
    shedding at the card's own service rate; (e) what the hooks cost a
    steady step, in turns. Every metric family the engine, watchdog,
    prefix cache and phase ledger name is in ``prometheus_text()``."""
    cfg = GPT_124M
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = LLMEngine(cfg, params, GPT_PROD_ENGINE)
    eng.warmup()
    spec_eng = LLMEngine(cfg, params, dataclasses.replace(GPT_PROD_ENGINE, spec_k=4))
    spec_eng.warmup()
    launches = {}
    print("(a) metrics, events and phases under phase 19's traffic")
    launches["a"] = hooks_under_traffic(eng, spec_eng, params, card)
    print("(b) the HBM ledger against the card")
    ledger_against_card(eng, spec_eng, params, swap_bytes)
    print("(c) the watchdog under a device wedge")
    launches["c"] = watchdog_wedge(eng, params, card)
    print("(d) deadline shedding at the card's service rate")
    launches["d"] = shed_at_service_rate(eng, card)
    eng._watchdog.stop()  # (e) times the hooks alone
    text = metrics.prometheus_text()
    names = (*engine_mod.METRIC_NAMES, *watchdog_mod.METRIC_NAMES, *prefix_mod.METRIC_NAMES,
             *phases.METRIC_NAMES)
    missing = [n for n in names if f"# TYPE ray_tpu_{n} " not in text]
    if missing:
        raise AssertionError(f"prometheus_text lacks {missing}")
    print(f"  prometheus_text: all {len(names)} families of the engine, watchdog, prefix cache and phase "
          f"ledger ({len(text.splitlines())} lines)")
    print("(e) what the hooks cost, in turns")
    launches["e"] = hooks_cost(eng, spec_eng, card)
    return dict(k1=sum(v[0] for v in launches.values()), k2=sum(v[1] for v in launches.values()))


def flash_bound(nbytes: int, ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for bf16 work on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_yardsticks() -> dict:
    """Phase 13: library times for K3-K5 at bench.py's training shape: batch
    26, 16 heads, seq 1024, head dim 64, bf16, causal. One SDPA backward
    computes dq, dk and dv together, so it stands for K4 and K5 at once.
    Bounds: K3 reads q, k, v and writes out and the fp32 lse; K4 (dq) reads
    q, k, v, dO, lse and delta and writes dq; K5 (dk, dv) reads the same and
    writes dk and dv. Causal operations: 2*S*S*D per head per matmul,
    halved; K3 does 2 matmuls, K4 3 (S, dP, dQ), K5 4 (S, dV, dP, dK).
    Returns the library times, each kernel's (bound ms, bound by) and its
    operations."""
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, do = (torch.randn(TRAIN_B, TRAIN_H, TRAIN_S, TRAIN_D, device="cuda", generator=g,
                               dtype=torch.bfloat16) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_(True)
    fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 50)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        torch.autograd.grad(out, (q, k, v), do)

    fwd_bwd_ms = cuda_ms(fwd_bwd, 50)
    tensor = TRAIN_B * TRAIN_H * TRAIN_S * TRAIN_D * 2  # bytes of one bf16 (B, H, S, D) tensor
    row = TRAIN_B * TRAIN_H * TRAIN_S * 4  # bytes of one fp32 (B, H, S) lse or delta
    matmul = 2 * TRAIN_B * TRAIN_H * TRAIN_S * TRAIN_S * TRAIN_D / 2  # one causal matmul
    work = {"K3": (4 * tensor + row, 2 * matmul), "K4": (5 * tensor + 2 * row, 3 * matmul),
            "K5": (6 * tensor + 2 * row, 4 * matmul)}
    print(f"flash yardsticks bf16 B={TRAIN_B} H={TRAIN_H} S={TRAIN_S} D={TRAIN_D} causal: SDPA "
          f"forward {fwd_ms:.4f} ms, forward+backward {fwd_bwd_ms:.4f} ms (backward ~"
          f"{fwd_bwd_ms - fwd_ms:.4f} ms, one call for dq, dk and dv)")
    bounds = {}
    for name, (nbytes, ops) in work.items():
        bounds[name] = flash_bound(nbytes, ops)
        print(f"  {name} bound {bounds[name][0]:.4f} ms ({bounds[name][1]}: {nbytes / 1e6:.1f} MB "
              f"= {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, {ops / 1e9:.1f} GFLOP = "
              f"{ops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3:.4f} ms)")
    return dict(fwd_ms=fwd_ms, bwd_ms=fwd_bwd_ms - fwd_ms, bounds=bounds,
                ops={name: ops for name, (_, ops) in work.items()})


def flash_kernels_run(q, k, v, do):
    """K3, then K4 and K5 on delta from K3's out, as FlashAttention's
    backward runs them: (out, lse, dq, dk, dv)."""
    out, lse = flash_fwd_cuda(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
    return out, lse, dq, dk, dv


def flash_errors(q, k, v, do) -> dict:
    """K3-K5 on (bh, seq, d) inputs against their plain versions on the same
    card; raises on a miss. fp32: out within 2e-5, lse 1e-4 and grads 1e-4
    (summation order only). bf16: out within 1e-2 x max(1, |plain|)
    elementwise (both round one fp32 value to bf16; a different summation
    order moves it by one bf16 step, 2^-7 of its magnitude, and outputs reach
    magnitudes 2-4 on early rows); lse 1e-4; the grads against the plain
    version run in fp32 on the same bf16 inputs and the kernels' out and
    lse, within 1e-2 x max(1, max |plain|): the kernels round P and dS to
    bf16 (2^-9 relative) before their second product and their results to
    bf16. Returns the max abs errors per kernel (K5: the larger of dk's and
    dv's)."""
    dtype, (bh, seq, d) = q.dtype, q.shape
    what = f"flash {dtype} bh={bh} d={d} seq={seq}"
    out, lse, dq, dk, dv = flash_kernels_run(q, k, v, do)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t).all()) for t in (out, lse, dq, dk, dv)):
        raise AssertionError(f"{what}: non-finite output")
    ref_out, ref_lse = flash_fwd_reference(q, k, v)
    err_out = (out.float() - ref_out.float()).abs()
    err_lse = (lse - ref_lse).abs().max().item()
    if dtype == torch.float32:
        refs = flash_bwd_reference(q, k, v, out, lse, do)
        ok_out = err_out.max().item() <= TOL[dtype]
        grad_tol = [1e-4] * 3
    else:
        refs = flash_bwd_reference(q.float(), k.float(), v.float(), out.float(), lse, do.float())
        ok_out = bool((err_out <= TOL[dtype] * ref_out.float().abs().clamp_min(1)).all())
        grad_tol = [1e-2 * max(1.0, r.abs().max().item()) for r in refs]
    err_g = [(a.float() - r.float()).abs().max().item() for a, r in zip((dq, dk, dv), refs)]
    print(f"{what}: max_abs_err out {err_out.max().item():.3g}, lse {err_lse:.3g}, dq "
          f"{err_g[0]:.3g}, dk {err_g[1]:.3g}, dv {err_g[2]:.3g} "
          f"(grad tol {', '.join(f'{t:.3g}' for t in grad_tol)})")
    if not (ok_out and err_lse <= 1e-4 and all(e <= t for e, t in zip(err_g, grad_tol))):
        raise AssertionError(f"{what}: kernels disagree with plain")
    return dict(K3=err_out.max().item(), K4=err_g[0], K5=max(err_g[1:]))


def check_flash() -> None:
    """Phase 14: K3-K5 vs their plain versions (``flash_errors``) at d 64
    and 128, fp32 and bf16, at seq 1024, a ragged 1000 and 1001 (the lse
    and delta rows of head bh start at bh x 1001 x 4 bytes, off 16-byte
    boundaries) (bh = 2 x 16). Phase 15 checks the training shape itself.
    An operand that starts off a 16-byte boundary is refused."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in KERNEL_HEAD_DIMS:
            for seq in (1024, 1000, 1001):
                g = torch.Generator(device="cuda").manual_seed(seq + d)
                flash_errors(*(torch.randn(32, seq, d, device="cuda", generator=g).to(dtype)
                               for _ in range(4)))
    q = torch.zeros(2 * 64 * 64 + 1, device="cuda", dtype=torch.bfloat16)[1:].view(2, 64, 64)
    try:
        flash_fwd_cuda(q, q, q)
    except ValueError as e:
        print(f"flash operand off a 16-byte boundary refused: {e}")
    else:
        raise AssertionError("flash forward took an operand off a 16-byte boundary")
    # a head dim the kernels lack raises on the card
    try:
        flash_attention(*(torch.zeros(1, 2, 16, 256, device="cuda"),) * 3)
    except ValueError as e:
        print(f"flash head_dim 256 refused: {e}")
    else:
        raise AssertionError("flash attention took head_dim 256")


def flash_build_report() -> None:
    """Registers and spills of each flash kernel instance, from the
    ``-Xptxas -v`` report of the build, and the dynamic shared memory its
    launch requests (``kernel_smem_bytes``, from the source)."""
    current = None
    for line in _kernels.build_log("flash_attention").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            kind = next(k for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if f"{k}_kernel" in name)
            dtype = torch.bfloat16 if "nv_bfloat16" in name else torch.float32
            d = 128 if "Li128E" in name else 64
            current = (f"{kind}{' (wgmma)' if 'wgmma' in name else ''} "
                       f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} d={d}: "
                       f"{kernel_smem_bytes(kind, d, dtype)} B dynamic shared memory")
        elif current and "spill stores" in line:
            current += ", " + line.split(",", 1)[1].strip()
        elif current and "Used" in line and "registers" in line:
            print(f"  {current}, {line.split(':', 1)[1].strip()}")
            current = None


def time_flash(yard: dict) -> dict:
    """Phase 15 at the training shape (bh 416, seq 1024, d 64, bf16): the
    kernels against their plain versions there (``flash_errors``), then
    each kernel, after an idle second, 200 launches between CUDA events,
    beside its bound, its plain version (``flash_bwd_reference`` computes
    dq, dk and dv in one call, so K4 and K5 share that time) and the
    library call (SDPA forward for K3; SDPA's backward, one call for dq,
    dk and dv, for K4 and K5).
    Prints each kernel's achieved TFLOP/s (phase 13's operations over its
    time) and its time over the library call's. Returns each kernel's
    record for the kernels line, its max abs error the one at this shape."""
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(TRAIN_B * TRAIN_H, TRAIN_S, TRAIN_D, device="cuda", generator=g,
                               dtype=torch.bfloat16) for _ in range(4))
    errs = flash_errors(q, k, v, do)
    torch.cuda.empty_cache()
    out, lse = flash_fwd_cuda(q, k, v)
    delta = (do.float() * out.float()).sum(-1)

    def idle_then_ms(fn) -> float:
        # each kernel from an idle card: right after 200 launches of K3 or
        # K5, K4 times 1-7% slower than after an idle second, the mma.sync
        # design and the wgmma one alike, and the cause is not measured
        # (chip_flash_probe.py)
        torch.cuda.synchronize()
        time.sleep(1.0)
        return cuda_ms(fn, 200)

    ms = {
        "K3": idle_then_ms(lambda: flash_fwd_cuda(q, k, v)),
        "K4": idle_then_ms(lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta)),
        "K5": idle_then_ms(lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta)),
    }
    plain_fwd = cuda_ms(lambda: flash_fwd_reference(q, k, v), 10, warmup=1)
    plain_bwd = cuda_ms(lambda: flash_bwd_reference(q, k, v, out, lse, do), 5, warmup=1)
    plain = {"K3": plain_fwd, "K4": plain_bwd, "K5": plain_bwd}
    library = {"K3": yard["fwd_ms"], "K4": yard["bwd_ms"], "K5": yard["bwd_ms"]}
    recs = {}
    for name in ms:
        bound_ms, bound_by = yard["bounds"][name]
        recs[name] = dict(max_abs_err=errs[name], ms=ms[name], plain_ms=plain[name],
                          library_ms=library[name], bound_ms=bound_ms, bound_by=bound_by)
        print(f"{name} timing bf16 bh={TRAIN_B * TRAIN_H} S={TRAIN_S} D={TRAIN_D}: kernel "
              f"{ms[name]:.4f} ms ({yard['ops'][name] / ms[name] / 1e9:.1f} TFLOP/s), bound "
              f"{bound_ms:.4f} ms ({bound_by}, {ms[name] / bound_ms:.2f}x), plain {plain[name]:.4f} ms, "
              f"library {library[name]:.4f} ms (kernel/library {ms[name] / library[name]:.3f}x)")
    print(f"K4 + K5 {ms['K4'] + ms['K5']:.4f} ms against SDPA's backward {yard['bwd_ms']:.4f} ms: "
          f"{(ms['K4'] + ms['K5']) / yard['bwd_ms']:.3f}x")
    print("flash build report (-Xptxas -v):")
    flash_build_report()
    return recs


def flash_launches() -> tuple[int, int, int]:
    return flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches


def reset_flash_launches() -> None:
    flash_fwd_cuda.launches = flash_bwd_dq_cuda.launches = flash_bwd_dkv_cuda.launches = 0


def expected_flash_launches(cfg: GPTConfig, steps: int) -> tuple[int, int, int]:
    """K3, K4, K5 launches for ``steps`` training steps: one of each per
    layer, and K3 once more per layer under full remat (the backward
    recomputes the block)."""
    k3 = (2 if cfg.remat and cfg.remat_policy == "full" else 1) * cfg.n_layers * steps
    return k3, cfg.n_layers * steps, cfg.n_layers * steps


def train_steps(cfg: GPTConfig, params, batches, lr: float):
    """``build_train_step`` with ``adamw(lr)`` over ``batches``: (losses,
    the state after the last step)."""
    init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(cfg, p, t), adamw(lr))
    state = init_fn(params)
    losses = []
    for b in batches:
        state, loss = step_fn(state, b)
        losses.append(loss.item())
    return losses, state


def fp32_training_identity() -> None:
    """Phase 16: a narrow fp32 GPT (vocab 4096, seq 256, d 256, 4 heads of
    64, 2 layers) takes 3 AdamW steps (lr 1e-4) through K3-K5
    (``attn_impl="flash"``) and 3 through the einsum path (``"xla"``) from
    the same params and tokens, under remat "full" and "attn". Losses agree
    within 1e-5 relative at every step; parameters within 1e-4 after the
    last, except the key slice of the qkv bias: its gradient is zero in
    exact arithmetic (the softmax ignores a constant added to a query's
    scores), so both paths compute rounding noise there, which AdamW's
    normalised update turns into steps of up to lr; it is held within
    2 x lr x steps."""
    lr, steps = 1e-4, 3
    rng = np.random.RandomState(12)
    base = GPTConfig(vocab_size=4096, seq_len=256, d_model=256, n_layers=2, n_heads=4,
                     dtype="float32")
    batches = [torch.from_numpy(rng.randint(0, base.vocab_size, (4, base.seq_len + 1))).cuda()
               for _ in range(steps)]
    init = gpt_init(base, torch.Generator(device="cuda").manual_seed(4))
    d = base.d_model
    for policy in ("full", "attn"):
        runs = {}
        for impl in ("flash", "xla"):
            cfg = dataclasses.replace(base, remat_policy=policy, attn_impl=impl)
            params = copy.deepcopy(init)
            reset_flash_launches()
            losses, state = train_steps(cfg, params, batches, lr)
            runs[impl] = (losses, list(state.params.named_parameters()), flash_launches())
        (lf, pf, nf), (lx, px, nx) = runs["flash"], runs["xla"]
        want = expected_flash_launches(dataclasses.replace(base, remat_policy=policy), steps)
        if nf != want or nx != (0, 0, 0):
            raise AssertionError(f"fp32 training {policy}: flash launches {nf} (expected {want}), "
                                 f"xla run {nx}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(lf, lx))
        worst, worst_key = 0.0, 0.0
        for (name, a), (_, b) in zip(pf, px):
            diff = (a.detach() - b.detach()).abs()
            if name.endswith("attn_qkv.bias"):
                worst_key = max(worst_key, diff[d:2 * d].max().item())
                diff = torch.cat([diff[:d], diff[2 * d:]])
            worst = max(worst, diff.max().item())
        print(f"fp32 training identity remat={policy}: losses flash {[f'{x:.6f}' for x in lf]} vs "
              f"xla {[f'{x:.6f}' for x in lx]} (max rel {rel:.3g}); params max abs diff {worst:.3g} "
              f"(key bias {worst_key:.3g}); K3/K4/K5 launches {nf}")
        if not (rel <= 1e-5 and worst <= 1e-4 and worst_key <= 2 * lr * steps):
            raise AssertionError(f"fp32 training {policy}: flash and xla paths disagree")


def qkv_grads(cfg: GPTConfig, params, tokens):
    """``gpt_loss`` and its gradient for each layer's qkv weight: (loss,
    [(3 d, d) fp32 per layer])."""
    loss = gpt_loss(cfg, params, tokens)
    return loss.item(), torch.autograd.grad(loss, [b.attn_qkv.weight for b in params.blocks])


def qkv_grad_gaps(got, want, d: int) -> dict:
    """The largest relative gap over layers, ||got - want|| / ||want||, of
    the q, k and v rows of the qkv weight gradients. The q rows take their
    gradient from K4's dq, the k and v rows from K5's dk and dv, and all
    three from K3's out and lse."""
    return {name: max(((g[i * d:(i + 1) * d] - w[i * d:(i + 1) * d]).norm()
                       / w[i * d:(i + 1) * d].norm()).item() for g, w in zip(got, want))
            for i, name in enumerate("qkv")}


def train_406m(card: str) -> dict:
    """Phase 17: the 406M training shape of bench.py (vocab 50304, seq 1024,
    d 1024, 24 layers, 16 heads, remat "attn", one CE chunk), bf16, random
    weights from seed 0, random tokens (26, 1025) from numpy. Step 0's
    gradients of every layer's qkv weight are held against the einsum
    attention path's (``QKV_GRAD_GAP``), and its loss too; then one warmup
    step, 5 timed steps through ``build_train_step`` and ``adamw(1e-4)``
    with the launch counts from 0, then 2 unprofiled and 2 profiled
    steps."""
    cfg = TRAIN_406M
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.RandomState(13)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (TRAIN_B, cfg.seq_len + 1))).cuda()
    # the einsum path under remat "full": the same values, with one block's
    # (26, 16, 1024, 1024) probabilities alive at a time
    _, flash_grads = qkv_grads(cfg, params, tokens)
    xla_loss, xla_grads = qkv_grads(dataclasses.replace(cfg, attn_impl="xla", remat_policy="full"),
                                    params, tokens)
    gaps = qkv_grad_gaps(flash_grads, xla_grads, cfg.d_model)
    del flash_grads, xla_grads
    print(f"406M step 0 qkv weight gradients, flash vs xla, largest relative gap over layers: "
          + ", ".join(f"{n} {g:.3g}" for n, g in gaps.items()) + f" (limit {QKV_GRAD_GAP})")
    if not all(g <= QKV_GRAD_GAP for g in gaps.values()):
        raise AssertionError(f"406M step 0: qkv gradients through K3-K5 differ from xla's: {gaps}")

    init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(cfg, p, t), adamw(1e-4))
    state = init_fn(params)
    t0 = time.perf_counter()
    state, loss = step_fn(state, tokens)
    losses = [loss.item()]
    warm_s = time.perf_counter() - t0
    # the two attention paths round at other places (the kernels' P in bf16,
    # the einsum's probabilities in bf16), which moves the mean loss (~11.33)
    # by well under 1e-2. At random init the loss is about ln V + 1/2 whatever
    # attention computes, so this checks the step's plumbing; the gradients
    # above check attention.
    if not abs(losses[0] - xla_loss) <= 1e-2:
        raise AssertionError(f"406M step 0: flash loss {losses[0]} vs xla {xla_loss}")

    # the main path's run: every count from 0
    reset_flash_launches()
    steps = 5
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens)
        losses.append(loss.item())  # ends in a host sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = flash_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expected_flash_launches(cfg, steps)
    if launches != want:
        raise AssertionError(f"406M: K3/K4/K5 launched {launches} times over {steps} steps, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"406M: non-finite loss {losses}")
    ms = float(np.mean(step_ms))
    tok_s = TRAIN_B * cfg.seq_len / (ms / 1e3)
    L, d, V, s = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.seq_len
    flops_per_token = 6 * (12 * L * d * d + d * V) + 6 * L * s * d
    mfu = flops_per_token * tok_s / PEAK_OPS_PER_S[torch.bfloat16]
    print(
        f"406M training [{card}]: {n_params / 1e6:.1f}M params, batch {TRAIN_B} x {s}; warmup step "
        f"{warm_s:.3f} s; step {ms:.3f} ms (steps {[f'{x:.1f}' for x in step_ms]}), "
        f"{tok_s:.0f} tokens/s, MFU {mfu:.4f} (6*(12*L*d^2 + d*V) + 6*L*s*d = "
        f"{flops_per_token / 1e9:.3f} GFLOP per token, no remat recompute, over 989 TFLOP/s); "
        f"losses {[f'{x:.6f}' for x in losses]} (step 0 xla {xla_loss:.6f}, tolerance 1e-2); peak memory "
        f"{peak_gb:.2f} GB; K3/K4/K5 launches {launches} = {want} expected"
    )

    # where the step's time goes: 2 steps without the profiler, 2 with it
    def run(n) -> float:
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, loss = step_fn(state, tokens)
        loss.item()
        return (time.perf_counter() - t0) * 1e3 / n

    wall_ms = run(2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = run(2)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_ms(events) -> float:
        return sum(e.self_device_time_total for e in events) / 1e3 / 2

    busy = dev_ms(kernels)
    print(f"  profile: {wall_ms:.3f} ms/step without the profiler, {prof_wall_ms:.3f} with it")
    if busy == 0:
        print("  device time not measured (the profiler saw no device activity)")
    else:
        gemm_words = ("gemm", "nvjet", "xmma", "cutlass")
        gemm = dev_ms([e for e in kernels if any(w in e.key.lower() for w in gemm_words)])
        flash = {n: dev_ms([e for e in kernels if f"{key}_kernel" in e.key])
                 for n, key in (("K3", "flash_fwd"), ("K4", "flash_bwd_dq"), ("K5", "flash_bwd_dkv"))}
        n_launch = sum(e.count for e in kernels) / 2
        print(f"  device busy {busy:.3f} ms/step (idle share {1 - busy / wall_ms:.3f} of the "
              f"unprofiled step), {n_launch:.0f} device ops/step; GEMM {gemm:.3f} ms, K3 "
              f"{flash['K3']:.3f} ms, K4 {flash['K4']:.3f} ms, K5 {flash['K5']:.3f} ms, other "
              f"{busy - gemm - sum(flash.values()):.3f} ms per step")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {dev_ms([e]):8.3f} ms/step  {e.count // 2:5d}/step  {e.key[:90]}")
        # the same device time by the host op that launched each kernel
        ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU
               and e.self_device_time_total > 0]
        print("  by launching op: " + "; ".join(
            f"{e.key} {dev_ms([e]):.3f} ms ({e.count // 2}/step)"
            for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]))

    # the fused CE's share: its forward and backward alone at this step's
    # shape (its three products are in the GEMM figure above as well)
    x = torch.randn(TRAIN_B * s, d, device=tokens.device, dtype=cfg.torch_dtype,
                    requires_grad=True)
    w = state.params.lm_head.weight
    targets = tokens[:, 1:].reshape(-1)

    def ce_step():
        losses = fused_softmax_cross_entropy(x, w.t(), targets, cfg.ce_chunks)
        torch.autograd.grad(losses.mean(), (x, w))

    print(f"  fused CE forward + backward {cuda_ms(ce_step, 5, warmup=1):.3f} ms per step "
          f"({TRAIN_B * s} tokens x vocab {V}, {cfg.ce_chunks} chunk; CUDA events, alone)")
    return dict(launches=dict(zip(("K3", "K4", "K5"), launches)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, compute capability {torch.cuda.get_device_capability(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {card}")

    phase("2 build")
    # one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_kernels.build, KERNELS))
    print(f"built {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for src in KERNELS:
        print(_kernels.build_log(src).strip())

    phase("3 K1 vs plain")
    err = check_k1()

    phase("4 K1 timing")
    timing = time_k1()
    timing64 = time_k1(GPT_124M.head_dim)

    phase("5 fp32 identity")
    fp32_identity()
    torch.cuda.empty_cache()

    phase("6 GPT-J-6B serve")
    served = serve_6b(card)

    phase("7 decode profile")
    profile_decode(served.pop("engine"), card)
    torch.cuda.empty_cache()

    phase("8 K2 vs plain")
    err2 = check_k2()

    phase("9 K2 timing")
    timing2 = time_k2(timing["ms"])
    timing2_64 = time_k2(timing64["ms"], GPT_124M.head_dim)

    phase("10 fp32 spec identity")
    fp32_spec_identity()
    torch.cuda.empty_cache()

    phase("11 GPT-J-6B spec serve")
    spec = spec_serve_6b(served.pop("params"), card)

    phase("12 verify profile")
    profile_verify(spec.pop("engine"), card)
    torch.cuda.empty_cache()

    phase("13 flash-attention yardsticks (K3-K5)")
    yard = flash_yardsticks()
    torch.cuda.empty_cache()

    phase("14 K3-K5 vs plain")
    check_flash()
    torch.cuda.empty_cache()

    phase("15 K3-K5 timing")
    flash_timing = time_flash(yard)
    torch.cuda.empty_cache()

    phase("16 fp32 training identity")
    fp32_training_identity()
    torch.cuda.empty_cache()

    phase("17 406M training")
    trained = train_406m(card)
    torch.cuda.empty_cache()

    phase("18 GPT fp32 identity")
    gpt_fp32_identity()
    torch.cuda.empty_cache()

    phase("19 GPT-124M serve")
    gpt_served = serve_gpt(card)

    phase("20 GPT-124M decode and verify profile")
    profile_decode(gpt_served["engine"], card, "GPT-124M decode profile")
    profile_verify(gpt_served.pop("spec_engine"), card, "GPT-124M verify profile")
    torch.cuda.empty_cache()

    phase("21 GPT-124M hot swap")
    swap_engine = gpt_served.pop("engine")
    params_bytes = swap_engine.hbm_ledger()["params_bytes"]
    swapped = hot_swap_gpt(swap_engine, card)
    swap_bytes = (params_bytes, swap_engine.hbm_ledger()["params_bytes"])
    del swap_engine
    gc.collect()
    torch.cuda.empty_cache()

    phase("22 GPT-124M production engine")
    production = production_engine(card, swap_bytes)

    kernels = [
        dict(
            name="paged_decode_attention",
            route="cuda",
            source="ray_tpu_torch/ops/csrc/paged_attention.cu",
            replaces="ray_tpu/ops/paged_attention.py:203",
            launches=served["launches"] + gpt_served["k1"] + swapped["launches"] + production["k1"],
            max_abs_err=err,
            ms=timing["ms"],
            plain_ms=timing["plain_ms"],
            bound_ms=timing["bound_ms"],
            bound_by="bytes",
            library_ms=timing["library_ms"],
            head_dims=list(DECODE_HEAD_DIMS),
            launches_by_path={"gptj_6b_serve": served["launches"], "gpt_124m_serve": gpt_served["k1"],
                              "gpt_124m_hot_swap": swapped["launches"],
                              "gpt_124m_production": production["k1"]},
            at_head_dim_64=dict(timing64, bound_by="bytes"),
        ),
        dict(
            name="paged_verify_attention",
            route="cuda",
            source="ray_tpu_torch/ops/csrc/paged_verify_attention.cu",
            replaces="ray_tpu/ops/paged_attention.py:304",
            launches=spec["launches"] + gpt_served["k2"] + production["k2"],
            launches_by_path={"gptj_6b_spec_serve": spec["launches"], "gpt_124m_spec_serve": gpt_served["k2"],
                              "gpt_124m_production": production["k2"]},
            max_abs_err=err2,
            ms=timing2["ms"],
            plain_ms=timing2["plain_ms"],
            bound_ms=timing2["bound_ms"],
            bound_by="bytes",
            library_ms=timing2["library_ms"],
            at_head_dim_64=dict(timing2_64, bound_by="bytes"),
        ),
    ]
    for kernel_name, kernel, line in (("flash_fwd", "K3", 57), ("flash_bwd_dq", "K4", 137),
                                      ("flash_bwd_dkv", "K5", 177)):
        kernels.append(dict(
            name=kernel_name,
            route="cuda",
            source="ray_tpu_torch/ops/csrc/flash_attention.cu",
            replaces=f"ray_tpu/ops/flash_attention.py:{line}",
            launches=trained["launches"][kernel],
            **flash_timing[kernel],
        ))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
