#!/usr/bin/env python3
"""Probes of the Hopper designs of the bf16 flash kernels (K3-K5) and of
the paged decode and verify kernels (K1, K2), on one GPU.

    python3 chip_flash_probe.py      # from the repository root, one NVIDIA H100
    python3 chip_flash_probe.py --old-k1 OLD.cu   # and phase 6, against an older K1
    python3 chip_flash_probe.py --old-k2 OLD.cu   # and phase 8, against an older K2
    python3 chip_flash_probe.py --k2-only [--old-k2 OLD.cu]   # phases 7 and 8 alone
    python3 chip_flash_probe.py --k1-same OLD.cu   # phase 9 alone

``--old-k1`` takes an earlier ``paged_attention.cu`` with the one-pass C
entry point ``paged_decode_attention(q, k_pool, v_pool, tables, lengths,
out, slots, heads, head_dim, num_blocks, block_size, tmax, scale, dtype,
stream)``, for example ``git show <commit>:ray_tpu_torch/ops/csrc/
paged_attention.cu`` of a commit before the split-context design;
``--old-k2`` an earlier ``paged_verify_attention.cu`` with the one-pass
entry point ``paged_verify_attention(q, k_pool, v_pool, tables, positions,
out, slots, window, heads, head_dim, num_blocks, block_size, tmax, scale,
dtype, stream)`` (windows 2-8), for example that file from the commit that
first added it (``git log --diff-filter=A``). ``--k1-same`` takes an earlier
``paged_attention.cu`` with the current split entry point, for example
``git show <parent>:ray_tpu_torch/ops/csrc/paged_attention.cu`` before a
change that must leave a head dim's arithmetic as it was.

1. helpers: one product of each ``wgmma`` form the flash kernels use, on
   one 64-row tile, against a torch matmul: S = A B^T with both operands
   K-major in shared memory (SS), and O = P V with P from registers and V
   MN-major through the transpose bit (RS), at d 64 and 128. A wrong
   descriptor gives wrong numbers, not a fault; this names the product.
2. flash variants: copies of ``flash_attention.cu`` with one change each,
   built into ``ray_tpu_torch/_build/probe/`` and timed in turns with the
   real K3, K4 and K5 at the training shape (bh 416, seq 1024, d 64,
   bf16): bf16 K4 on the first design's ``mma.sync`` kernel, bh on the
   grid's fastest axis (the first design's order), and register caps that
   would fit more CTAs on an SM.
3. K1 variants at the decode timing shape (8 slots x 1024, bf16): the real
   kernel at splits of 64, 128 and 256 positions, and copies of
   ``paged_attention.cu`` with 16-byte ``cp.async`` copies in place of the
   bulk page copies, another ring size, four warps of four tokens a page
   in place of eight of two, no L2 evict-first hint, or the merge as a
   second kernel in place of the last split's, and the real kernel with
   its tickets zeroed by a memset each call (with ``--old-k1``, the older
   kernel too); each checked against the plain version, the real kernel's
   split partials against ``decode_partials_torch``, then timed in turns
   beside a plain torch read of as many bytes.
4. K4 after other kernels: K4 (dQ) from an idle card, and right after
   200 launches of K3 or K5, with the SM clock and power read after each.
5. the 406M training step (chip_smoke.py phase 17's shape) with the
   ``wgmma`` K4 and with the ``mma.sync`` copy of phase 2, swapped in the
   same process, in turns.
6. with ``--old-k1``: K1's wrapper and the older kernel behind the older
   wrapper (the one-pass call: checks, ``empty_like``, the launch), host
   time per call in turns at phase 7's context; then the GPT-J-6B decode
   step (chip_smoke.py phase 7's engine and traffic) with each swapped
   into the model runner in the same process, in turns: wall time per
   step without the profiler, and K1's device time per step under it.
7. K2 at chip_smoke.py phase 9's shape (8 slots, W 5 at positions
   1019-1023, bf16): the real kernel at splits of 64, 128 and 256
   positions, copies of ``paged_verify_attention.cu`` with a 64 KB ring,
   rows without padding (ldmatrix bank conflicts), K1's two bulk copies a
   page into unpadded rows, and with ``--old-k2`` the older kernel; each
   checked against the plain version, the real kernel's live split partials
   against ``verify_partials_torch``, then timed in turns beside SDPA on
   pre-gathered K/V; then the split sizes again at phase 12's context
   (positions 543-547).
8. with ``--old-k2``: the same as phase 6 for K2: both wrappers' host time
   per call, then the GPT-J-6B verify step (chip_smoke.py phase 12's
   engine, traffic and test-double drafter, W 5) with each K2 swapped into
   the model runner, in turns: wall time per step, and K2's device time
   per step under the profiler.
9. with ``--k1-same``: the earlier K1 and the current one on chip_smoke.py
   phase 3's inputs at every head dim both compile, fp32 and bf16: their
   outputs and live split partials compared bit for bit, then both timed
   in turns at phase 4's shape (8 slots x 1024, bf16) at each such head
   dim.

Exits non-zero when a build fails, a helper product disagrees, a flash
copy's dq disagrees with the real K4's or a K1 or K2 variant with the
plain version, or (phase 9) the two K1 sources differ in a bit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs
from chip_mutants import build_sources, edited_source, use_library
from ray_tpu_torch.llm import model_runner
from ray_tpu_torch.models.gpt import gpt_init, gpt_loss
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.parallel import adamw, build_train_step

SOURCE = _kernels.CSRC / "flash_attention.cu"

# one SS and one RS product on one tile, through the real source's helpers
HELPERS_CU = """#include "{source}"
namespace {{
template <int D>
__global__ void ss_kernel(const void* a, const void* b, void* out) {{
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sa = aligned_smem(smem_raw).addr, sb = sa + kBlock * D * 2;
  float* c = static_cast<float*>(out);
  load_tile_async<D>(sa, static_cast<const bf16*>(a), 0, kBlock);
  load_tile_async<D>(sb, static_cast<const bf16*>(b), 0, kBlock);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
  float s[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, desc_k(sa, kk), desc_k(sb, kk), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, r0 = (threadIdx.x >> 5) * 16;
#pragma unroll
  for (int i = 0; i < 32; ++i) c[(r0 + g + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * t + (i & 1)] = s[i];
}}
template <int D>
__global__ void rs_kernel(const void* pin, const void* v, void* out) {{
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sv = aligned_smem(smem_raw).addr;
  const float* p = static_cast<const float*>(pin);
  float* o = static_cast<float*>(out);
  load_tile_async<D>(sv, static_cast<const bf16*>(v), 0, kBlock);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, r0 = (threadIdx.x >> 5) * 16;
  float x[32], acc[D / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = p[(r0 + g + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * t + (i & 1)];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t pa[16];
  to_a_frags(x, pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) wgmma_rs_mn<D>(acc, pa + 4 * kk, desc_mn(sv, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pa);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[(r0 + g + 8 * ((i >> 1) & 1)) * D + 8 * (i >> 2) + 2 * t + (i & 1)] = acc[i];
}}
template <typename K>
int run(K kernel, size_t smem, const void* x, const void* y, void* z) {{
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<1, kThreads, smem>>>(x, y, z);
  return (int)cudaGetLastError();
}}
}}  // namespace
extern "C" int probe_ss(const void* a, const void* b, void* c, int d) {{
  auto k = d == 64 ? ss_kernel<64> : ss_kernel<128>;
  return run(k, 2 * kBlock * d * 2 + 1024, a, b, c);
}}
extern "C" int probe_rs(const void* p, const void* v, void* o, int d) {{
  auto k = d == 64 ? rs_kernel<64> : rs_kernel<128>;
  return run(k, kBlock * d * 2 + 1024, p, v, o);
}}
"""

# each variant: replacements in flash_attention.cu (``edited_source``)
VARIANTS = {
    "K4 on mma.sync (the first design)": [
        ("  if constexpr (kIsF32<T>) {\n    auto kernel = flash_bwd_dq_kernel<T, D>;",
         "  if constexpr (true) {\n    auto kernel = flash_bwd_dq_kernel<T, D>;")],
    "bh fastest (the first design's grid order)": [
        ("  const int bh = blockIdx.x / nq;\n  const int qi = nq - 1 - blockIdx.x % nq;",
         "  const int nbh = gridDim.x / nq;\n  const int bh = blockIdx.x % nbh;\n"
         "  const int qi = nq - 1 - blockIdx.x / nbh;"),
        ("  const int qi = tiles - 1 - blockIdx.x % tiles;  // within a head, the longest rows first\n"
         "  const int bh = blockIdx.x / tiles;",
         "  const int nbh = gridDim.x / tiles;\n  const int bh = blockIdx.x % nbh;\n"
         "  const int qi = tiles - 1 - blockIdx.x / nbh;"),
        ("  const int bh = blockIdx.x / nq;\n  const int kj = blockIdx.x % nq;",
         "  const int nbh = gridDim.x / nq;\n  const int bh = blockIdx.x % nbh;\n"
         "  const int kj = blockIdx.x / nbh;")],
    "K3 capped for 5 CTAs per SM": [
        ("__launch_bounds__(kThreads)\nflash_fwd_kernel_wgmma", "__launch_bounds__(kThreads, 5)\nflash_fwd_kernel_wgmma")],
    "K5 capped for 3 CTAs per SM": [
        ("__launch_bounds__(kThreads)\nflash_bwd_dkv_kernel_wgmma",
         "__launch_bounds__(kThreads, 3)\nflash_bwd_dkv_kernel_wgmma")],
}


# the merge as a second kernel, grid (heads, slots), after the split kernel
# (whose CTAs then never take the merge)
K1_MERGE_KERNEL = """template <typename T, int D>
__global__ void __launch_bounds__(D)
merge_kernel(const float* __restrict__ scratch, const int* __restrict__ lengths, T* __restrict__ out,
             int heads, int block_size, int tmax, int split_tokens, int splits) {
  const int h = blockIdx.x, s = blockIdx.y, d = threadIdx.x;
  const int length = max(0, min(lengths[s], tmax * block_size));
  const int live = (length + split_tokens - 1) / split_tokens;
  const float* part = scratch + ((int64_t)s * heads + h) * splits * (D + 2);
  float mx = kNegInf;
  for (int i = 0; i < live; ++i) mx = fmaxf(mx, part[i * (D + 2) + D]);
  float num = 0.f, den = 0.f;
  for (int i = 0; i < live; ++i) {
    const float w = expf(part[i * (D + 2) + D] - mx);
    num += part[i * (D + 2) + d] * w;
    den += part[i * (D + 2) + D + 1] * w;
  }
  out[((int64_t)s * heads + h) * D + d] = Quad<T>::narrow(live > 0 ? num / den : 0.f);
}

template <typename T, int D>
cudaError_t launch("""

# load_page with 16-byte cp.async copies by every thread in place of thread
# 0's two bulk copies; each thread's copies land as one arrival on the
# stage's barrier, which then counts every thread
K1_CP_ASYNC_LOAD = """  const char* kp = reinterpret_cast<const char*>(k_pool + src);
  const char* vp = reinterpret_cast<const char*>(v_pool + src);
  for (uint32_t c = threadIdx.x * 16; c < bytes; c += kThreads * 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst + c), "l"(kp + c) : "memory");
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst + bytes + c), "l"(vp + c) : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n" ::"r"(bar) : "memory");
}"""

# each K1 variant: replacements in paged_attention.cu
K1_VARIANTS = {
    "cp.async copies in place of bulk copies": [
        ("  if (threadIdx.x == 0) {\n    const uint64_t policy = evict_first_policy();\n"
         "    mbar_expect_tx(bar, 2 * bytes);\n    bulk_copy(dst, k_pool + src, bytes, bar, policy);\n"
         "    bulk_copy(dst + bytes, v_pool + src, bytes, bar, policy);\n  }\n}", K1_CP_ASYNC_LOAD),
        ("mbar_init(smem_addr(bars + i), 1);", "mbar_init(smem_addr(bars + i), kThreads);")],
    "ring of 64 KB": [("constexpr int kRingBytes = 32 * 1024;", "constexpr int kRingBytes = 64 * 1024;")],
    "4 warps of 4 tokens a page": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;"),
                                   ("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
    "no L2 evict-first hint": [("createpolicy.fractional.L2::evict_first", "createpolicy.fractional.L2::evict_normal")],
    "merge in a second kernel": [
        ("sm_last = atomicAdd(tickets + (int64_t)s * heads + h, 1) == live_splits - 1;", "sm_last = false;"),
        ("template <typename T, int D>\ncudaError_t launch(", K1_MERGE_KERNEL),
        ("      pages_per_split, stages, scale);\n  return cudaGetLastError();",
         "      pages_per_split, stages, scale);\n"
         "  merge_kernel<T, D><<<dim3(heads, slots), D, 0, stream>>>(\n"
         "      static_cast<const float*>(scratch), static_cast<const int*>(lengths), static_cast<T*>(out),\n"
         "      heads, block_size, tmax, pages_per_split * block_size, std::max(splits, 1));\n"
         "  return cudaGetLastError();")],
}
# the real K1 at these split sizes (positions)
K1_SPLITS = (64, 128, 256)

# each K2 variant: replacements in paged_verify_attention.cu
K2_VARIANTS = {
    "ring of 64 KB": [("constexpr int kRingBytes = 32 * 1024;", "constexpr int kRingBytes = 64 * 1024;")],
    "rows without padding": [("constexpr int kRowPad = 16;", "constexpr int kRowPad = 0;")],
    "two bulk copies a page (K1's), rows without padding": [
        ("constexpr int kRowPad = 16;", "constexpr int kRowPad = 0;"),
        ("  for (int r = threadIdx.x; r < 2 * block_size; r += 32) {\n"
         "    const bool is_v = r >= block_size;\n"
         "    const int row = is_v ? r - block_size : r;\n"
         "    bulk_copy(dst + (is_v ? ring.v_off : 0) + row * ring.stride, (is_v ? v_pool : k_pool) + src + "
         "(int64_t)row * D,\n"
         "              kRow, bar, policy);\n  }",
         "  if (threadIdx.x == 0) {\n"
         "    bulk_copy(dst, k_pool + src, block_size * kRow, bar, policy);\n"
         "    bulk_copy(dst + ring.v_off, v_pool + src, block_size * kRow, bar, policy);\n  }")],
}
# the real K2 at these split sizes (positions)
K2_SPLITS = (64, 128, 256)


def build_all(old_k1: str | None, old_k2: str | None, k2_only: bool = False) -> dict:
    """The real libraries, the helper probe, every variant and the older K1
    and K2 sources (under "old K1", "old K2") if given, one nvcc each, all
    started together: {name: (library path, -Xptxas -v report)}. With
    ``k2_only``, the K2 variants and sources alone."""
    sources = {}
    if not k2_only:
        sources["helpers"] = HELPERS_CU.format(source=SOURCE)
        sources.update({name: edited_source(edits) for name, edits in VARIANTS.items()})
        sources.update({name: edited_source(edits, "paged_attention") for name, edits in K1_VARIANTS.items()})
    sources.update({name: edited_source(edits, "paged_verify_attention") for name, edits in K2_VARIANTS.items()})
    for name, path in (("old K1", old_k1), ("old K2", old_k2)):
        if path:
            with open(path) as f:
                sources[name] = f.read()
    reals = ("paged_attention", "paged_verify_attention") + (() if k2_only else ("flash_attention",))
    with ThreadPoolExecutor(len(reals)) as pool:
        reals = [pool.submit(_kernels.build, name) for name in reals]
        built = build_sources(sources, "probe")
        for real in reals:
            real.result()
    return built


def check_helpers(path) -> bool:
    """Phase 1: each product against a torch matmul of the same bf16
    operands in fp32; both sum exact products in fp32, so they differ by
    summation order only (limit 1e-4)."""
    lib = ctypes.CDLL(str(path))
    for fn in (lib.probe_ss, lib.probe_rs):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
        fn.restype = ctypes.c_int
    g = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for d in (64, 128):
        a, b = (torch.randn(64, d, device="cuda", generator=g).bfloat16() for _ in range(2))
        p = torch.randn(64, 64, device="cuda", generator=g)
        v = torch.randn(64, d, device="cuda", generator=g).bfloat16()
        c, o = torch.zeros(64, 64, device="cuda"), torch.zeros(64, d, device="cuda")
        errs = (lib.probe_ss(a.data_ptr(), b.data_ptr(), c.data_ptr(), d),
                lib.probe_rs(p.data_ptr(), v.data_ptr(), o.data_ptr(), d))
        torch.cuda.synchronize()
        for form, got, want, err in (("SS  S = A B^T", c, a.float() @ b.float().t(), errs[0]),
                                     ("RS  O = P V", o, p.bfloat16().float() @ v.float(), errs[1])):
            gap = (got - want).abs().max().item()
            ok &= err == 0 and gap <= 1e-4
            print(f"helper {form}, d {d}: launch {err}, max abs error {gap:.3g} "
                  f"(largest value {want.abs().max().item():.3g})")
    return ok


def bf16_report(log: str) -> list:
    """'K3 d=64: 117 registers, 0 bytes spill stores' for each bf16 kernel
    instance in an -Xptxas -v report (K1's bf16 kernels, or the flash
    kernels: wgmma, or mma.sync when marked so)."""
    out, current, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            current = None
            if ("paged_decode" in name or "merge_kernel" in name) and "nv_bfloat16" in name:
                current = f"K1 {'split' if 'split' in name else 'merge'}"
            elif "nv_bfloat16" in name:
                kernel = "K3" if "flash_fwd" in name else "K4" if "flash_bwd_dq" in name else "K5"
                current = (f"{kernel}{'' if 'wgmma' in name else ' (mma.sync)'} "
                           f"d={128 if 'Li128E' in name else 64}")
        elif current and "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif current and "Used" in line and "registers" in line:
            out.append(f"{current}: {line.split('Used')[1].split(',')[0].strip()}, {spill}")
            current = None
    return sorted(out)


def time_variants(built: dict) -> bool:
    """Phase 2: the real K3, K4 and K5 and each variant's, in turns
    (forward order then reverse), 100 launches each between CUDA events.
    Returns whether every copy's dq agrees with the real K4's."""
    bh, seq, d = cs.TRAIN_B * cs.TRAIN_H, cs.TRAIN_S, cs.TRAIN_D
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(bh, seq, d, device="cuda", generator=g, dtype=torch.bfloat16)
                   for _ in range(4))
    out, lse = fa.flash_fwd_cuda(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    o2, l2, dk2, dv2 = torch.empty_like(q), torch.empty_like(lse), torch.empty_like(q), torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    dq2 = torch.empty_like(q)
    fns = {"real": {"K3": lambda: fa.flash_fwd_cuda(q, k, v),
                    "K4": lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta),
                    "K5": lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)}}
    ok = True
    for name in VARIANTS:
        path, log = built[name]
        lib = ctypes.CDLL(str(path))
        f, a, b = lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        a.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        b.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fns[name] = {
            "K3": lambda f=f: f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(), l2.data_ptr(),
                                bh, seq, d, d ** -0.5, 1, stream),
            "K4": lambda a=a: a(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dq2.data_ptr(), bh, seq, d, d ** -0.5, 1, stream),
            "K5": lambda b=b: b(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dk2.data_ptr(), dv2.data_ptr(), bh, seq, d, d ** -0.5, 1,
                                stream),
        }
        print(f"variant {name}, -Xptxas -v of the bf16 kernels: " + "; ".join(bf16_report(log)))
    # every copy's dq against the real K4's: the copies change the schedule
    # or the kernel, not what it computes (the mma.sync K4 rounds the same
    # products in another order)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta)
    limit = 1e-2 * max(1.0, dq.float().abs().max().item())
    for name in VARIANTS:
        fns[name]["K4"]()
        torch.cuda.synchronize()
        gap = (dq2.float() - dq.float()).abs().max().item()
        ok &= gap <= limit
        print(f"variant {name}: dq max abs difference from the real K4 {gap:.3g} (limit {limit:.3g})")
    print(f"variants at bh {bh}, seq {seq}, d {d}, bf16 (ms per launch, in turns):")
    for kernel in ("K3", "K4", "K5"):
        times = cs.in_turns({name: kernels[kernel] for name, kernels in fns.items()}, 100)
        print(f"  {kernel}: " + "; ".join(f"{n} {' / '.join(f'{t:.4f}' for t in ts)}"
                                         for n, ts in times.items()))
    return ok


def old_k1_fn(built: dict):
    """The older K1's one-pass C entry point (``--old-k1``), or None."""
    if "old K1" not in built:
        return None
    fn = ctypes.CDLL(str(built["old K1"][0])).paged_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def old_k1_wrapper(fn):
    """The older kernel behind the wrapper it had (the one-pass call: the
    same argument checks, ``empty_like``, the launch, the count), for
    phase 6's host-time and decode-step comparisons."""

    def call(q, k_pool, v_pool, block_tables, lengths):
        if q.dim() != 3:
            raise ValueError(f"paged decode kernel takes q (slots, heads, d), got {tuple(q.shape)}")
        pa._check_kernel_args("paged decode kernel", q, k_pool, v_pool, block_tables, lengths, "lengths")
        s, h, d = q.shape
        num_blocks, _, block_size, _ = k_pool.shape
        out = torch.empty_like(q)
        if s == 0:
            return out
        with torch.cuda.device(q.device):
            err = fn(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                s, h, d, num_blocks, block_size, block_tables.shape[1],
                d**-0.5, pa._DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream,
            )
        pa._launched("paged_decode_attention", err)
        call.launches += 1
        return out

    call.launches = 0
    return call


# the real K1's split partials against decode_partials_torch: both sum
# exact fp32 products of the same bf16 inputs, in another order
PARTIALS_TOL = 1e-3


def time_k1_variants(built: dict) -> bool:
    """Phase 3: the real K1 at each of ``K1_SPLITS``, each copy of
    ``K1_VARIANTS`` (at the wrapper's split) and the older K1 if built, on
    phase 4's inputs (8 slots x 1024, bf16): each against the plain version
    (phase 3's bf16 tolerance), the real K1's live split partials against
    ``decode_partials_torch`` (``PARTIALS_TOL``), then 200 launches each in
    turns (forward order, then reverse). Returns whether all agree."""
    dtype = torch.bfloat16
    lens = torch.full((cs.S,), 1024)
    q, kp, vp, tables, lengths = cs.k1_inputs(dtype, lens, seed=2)
    ref = pa.paged_attention_torch(q, kp, vp, tables, lengths).float()
    real = pa._decode_fn()
    stream = torch.cuda.current_stream().cuda_stream
    wrapper_split = pa.decode_splits(cs.T, cs.BS)[0]

    def call(fn, split_tokens, zero_tickets=False):
        # as the wrapper calls it: scratch allocated once, tickets zeroed
        # once (each launch leaves them at zero), or by a memset each call
        pps = split_tokens // cs.BS
        splits = -(-cs.T // pps)
        out = torch.empty_like(q)
        scratch = torch.empty((cs.S, cs.H, splits, cs.D + 2), device="cuda")
        tickets = torch.zeros((cs.S, cs.H), dtype=torch.int32, device="cuda")

        def run():
            if zero_tickets:
                tickets.zero_()
            return fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
                      out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), cs.S, cs.H, cs.D, cs.NB, cs.BS,
                      cs.T, pps, cs.D ** -0.5, 1, stream)

        run.scratch = scratch  # the last call's partials
        return out, run

    runs = {f"split {n}": call(real, n) for n in K1_SPLITS}
    old = old_k1_fn(built)
    if old is not None:
        old_out = torch.empty_like(q)
        runs["old K1 (--old-k1)"] = (old_out, lambda: old(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
            old_out.data_ptr(), cs.S, cs.H, cs.D, cs.NB, cs.BS, cs.T, cs.D ** -0.5, 1, stream))
    runs[f"split {wrapper_split}, tickets zeroed by a memset each call"] = call(real, wrapper_split, True)
    for name in K1_VARIANTS:
        path, log = built[name]
        fn = ctypes.CDLL(str(path)).paged_decode_attention
        fn.argtypes, fn.restype = real.argtypes, real.restype
        runs[f"{name}, split {wrapper_split}"] = call(fn, wrapper_split)
        print(f"K1 variant {name}, -Xptxas -v: " + "; ".join(bf16_report(log)))
    ok = True
    for name, (out, fn) in runs.items():
        err = fn()
        torch.cuda.synchronize()
        gap = (out.float() - ref).abs().max().item()
        ok &= err == 0 and gap <= cs.TOL[dtype]
        print(f"K1 {name}: launch {err}, max abs error {gap:.3g} (tol {cs.TOL[dtype]})")
    for n in K1_SPLITS:
        want = pa.decode_partials_torch(q, kp, vp, tables, lengths, n)
        live = torch.arange(want.shape[2], device="cuda") * n < 1024  # the splits the kernel writes
        got = runs[f"split {n}"][1].scratch
        gap = (got[:, :, live] - want[:, :, live]).abs().max().item()
        ok &= gap <= PARTIALS_TOL
        print(f"K1 split {n}: {int(live.sum())} live split partials (acc, m, l) against "
              f"decode_partials_torch, max abs difference {gap:.3g} (limit {PARTIALS_TOL}; largest value "
              f"{want[:, :, live].abs().max().item():.3g})")
    bound = cs.k1_bound_ms(dtype, lens)
    # the card's practical streaming read: one torch reduction over as many
    # contiguous bytes as K1's live K and V
    kv = torch.randn(2 * cs.S * cs.H * 1024 * cs.D, device="cuda").to(dtype)
    fns = {name: fn for name, (_, fn) in runs.items()}
    fns["a plain read of as many bytes (torch.sum, contiguous)"] = lambda: kv.sum(dtype=torch.float32)
    times = cs.in_turns(fns, 200)
    print(f"K1 at {cs.S} slots x 1024, bf16 (ms per call, in turns; bound {bound:.4f} ms):")
    for name, ts in times.items():
        print(f"  {name}: {' / '.join(f'{t:.4f}' for t in ts)} ({min(ts) / bound:.2f}x bound)")
    # each output again, from the last of its ~800 calls: a merge ticket
    # left off zero by one launch would break the ones after it
    for name, (out, _) in runs.items():
        gap = (out.float() - ref).abs().max().item()
        ok &= gap <= cs.TOL[dtype]
        if gap > cs.TOL[dtype]:
            print(f"K1 {name}: max abs error {gap:.3g} after the timed calls (tol {cs.TOL[dtype]})")
    return ok


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def k4_after_others() -> None:
    """Phase 4: K4's 200-launch time from an idle second, and right after
    200 launches of K3 or K5, twice each."""
    bh, seq, d = cs.TRAIN_B * cs.TRAIN_H, cs.TRAIN_S, cs.TRAIN_D
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(bh, seq, d, device="cuda", generator=g, dtype=torch.bfloat16)
                   for _ in range(4))
    out, lse = fa.flash_fwd_cuda(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    fns = {"K3": lambda: fa.flash_fwd_cuda(q, k, v),
           "K4": lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta),
           "K5": lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)}
    for _ in range(2):
        for before in (None, "K3", "K5"):
            torch.cuda.synchronize()
            time.sleep(1.0)
            lead = f"{before} {cs.cuda_ms(fns[before], 200):.4f} ms, then " if before else "idle, then "
            print(f"K4 after {lead}K4 {cs.cuda_ms(fns['K4'], 200):.4f} ms "
                  f"(SM clock, power after: {smi()})")


def step_with_each_k4(built: dict) -> None:
    """Phase 5: ``build_train_step`` at the 406M shape (batch 26, bf16,
    remat "attn", random weights from seed 0) with the real library and
    with the "K4 on mma.sync" copy, which differ in bf16 K4 alone, in
    turns (real, copy, copy, real): one warm-up step, then 3 steps on the
    host clock ending in a sync (the step is device-bound, PERF.md)."""
    cfg = cs.TRAIN_406M
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.from_numpy(
        np.random.RandomState(13).randint(0, cfg.vocab_size, (cs.TRAIN_B, cfg.seq_len + 1))).cuda()
    init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(cfg, p, t), adamw(1e-4))
    state = init_fn(params)
    libs = {"wgmma K4": _kernels.build("flash_attention"),
            "mma.sync K4": built["K4 on mma.sync (the first design)"][0]}
    times: dict = {name: [] for name in libs}
    for name in ("wgmma K4", "mma.sync K4", "mma.sync K4", "wgmma K4"):
        use_library(libs[name])
        state, loss = step_fn(state, tokens)
        loss.item()
        t0 = time.perf_counter()
        for _ in range(3):
            state, loss = step_fn(state, tokens)
        loss.item()
        times[name].append((time.perf_counter() - t0) * 1e3 / 3)
    use_library(libs["wgmma K4"])
    print(f"406M step, batch {cs.TRAIN_B}, in turns (ms per step, 3 steps a turn): " + "; ".join(
        f"{n} {' / '.join(f'{t:.3f}' for t in ts)}" for n, ts in times.items()))


def host_us(fns: dict, calls: int = 200) -> dict:
    """Host time per call of each callable (µs): ``calls`` calls between
    two host clock reads, the device synced before and after, after a
    warm-up turn of each, in turns (forward order, then reverse). The
    device runs behind the host and the launch queue holds all the calls,
    so the host clock reads the calls' issue alone."""
    times: dict = {name: [] for name in fns}
    for name in [*fns, *fns, *reversed(fns)]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fns[name]()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        times[name].append((t1 - t0) * 1e6 / calls)
    return {name: ts[1:] for name, ts in times.items()}


def k1_in_decode_step(built: dict, card: str) -> None:
    """Phase 6 (``--old-k1``): this K1 behind its wrapper and the older K1
    behind the older wrapper (``old_k1_wrapper``). First each wrapper's host
    time per call, and this kernel's C entry point called alone, at phase
    7's context (8 slots x 548, bf16). Then chip_smoke.py phase 7's
    GPT-J-6B engine and traffic (8 slots after 512-token prompts, half
    sampled), each wrapper in turn as the model runner's decode attention
    (this, old, old, this, twice): 2 steps, then 10 timed on the host clock
    ending in a sync; in each arm's first turn 10 more under
    torch.profiler, for K1's device time per step."""
    old = old_k1_wrapper(old_k1_fn(built))
    new = pa.paged_attention_cuda
    q, kp, vp, tables, lengths = cs.k1_inputs(torch.bfloat16, torch.full((cs.S,), 548), seed=2)
    split_tokens, splits = pa.decode_splits(cs.T, cs.BS)
    scratch = torch.empty((cs.S, cs.H, splits, cs.D + 2), device="cuda")
    tickets = torch.zeros(cs.S * cs.H, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    real, stream = pa._decode_fn(), torch.cuda.current_stream().cuda_stream
    args = (q, kp, vp, tables, lengths)
    host = host_us({
        "this wrapper": lambda: new(*args),
        "older wrapper and kernel": lambda: old(*args),
        "this kernel's C entry point alone": lambda: real(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), tickets.data_ptr(), cs.S, cs.H, cs.D, cs.NB, cs.BS, cs.T,
            split_tokens // cs.BS, cs.D ** -0.5, 1, stream)})
    print(f"K1 host time per call at {cs.S} slots x 548, bf16 (µs, in turns, 200 calls a turn): " + "; ".join(
        f"{n} {' / '.join(f'{t:.2f}' for t in ts)}" for n, ts in host.items()))
    del q, kp, vp, tables, lengths, scratch, tickets, out
    torch.cuda.empty_cache()

    cfg = cs.GPTJ_6B
    params = cs.gptj_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = cs.LLMEngine(cfg, params, cs.EngineConfig(max_slots=8, block_size=16, max_blocks_per_seq=128,
                                                    num_blocks=1025, prefill_chunk=256))
    eng.warmup()
    reqs = cs.steady_batch(eng, 160)
    fns = {"this K1": new, "older K1": old}
    wall: dict = {name: [] for name in fns}
    k1_dev: dict = {}
    steps = 10
    try:
        for name in ("this K1", "older K1", "older K1", "this K1") * 2:
            model_runner.paged_attention = fns[name]
            for _ in range(2):
                eng.step()
            if name in k1_dev:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    eng.step()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / steps
            else:
                wall_ms, _, kernels = cs.profile_steps(eng, steps)
                k1_dev[name] = sum(e.self_device_time_total for e in kernels if "paged_decode" in e.key) / 1e3 / steps
            wall[name].append(wall_ms)
    finally:
        model_runner.paged_attention = pa.paged_attention
    if not all(r.state == cs.RUNNING for r in reqs):
        raise AssertionError("phase 6: a request finished inside the timed steps")
    print(f"GPT-J-6B decode step [{card}], 8 slots at context ~{reqs[0].seq_len}, in turns (this, older, "
          f"older, this, twice; {steps} steps a turn): " + "; ".join(
              f"{n} wall {' / '.join(f'{t:.3f}' for t in wall[n])} ms (median {np.median(wall[n]):.3f}), "
              f"K1 device {k1_dev[n]:.3f} ms per step" for n in fns))
    for r in reqs:
        eng.cancel(r.id)
    eng.step()


def old_k2_fn(built: dict):
    """The older K2's one-pass C entry point (``--old-k2``), or None."""
    if "old K2" not in built:
        return None
    fn = ctypes.CDLL(str(built["old K2"][0])).paged_verify_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def old_k2_wrapper(fn):
    """The older kernel behind the wrapper it had (the one-pass call: the
    same argument checks, its window check, ``empty_like``, the launch, the
    count), for phase 8."""

    def call(q, k_pool, v_pool, block_tables, positions):
        if q.dim() != 4:
            raise ValueError(f"paged verify kernel takes q (slots, w, heads, d), got {tuple(q.shape)}")
        pa._check_kernel_args("paged verify kernel", q, k_pool, v_pool, block_tables, positions, "positions",
                              (256,))
        s, w, h, d = q.shape
        if w not in range(2, 9):
            raise ValueError(f"the older verify kernel takes windows of 2-8 queries, got {w}")
        num_blocks, _, block_size, _ = k_pool.shape
        out = torch.empty_like(q)
        if s == 0:
            return out
        with torch.cuda.device(q.device):
            err = fn(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
                s, w, h, d, num_blocks, block_size, block_tables.shape[1],
                d**-0.5, pa._DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream,
            )
        pa._launched("paged_verify_attention", err)
        call.launches += 1
        return out

    call.launches = 0
    return call


def time_k2_variants(built: dict) -> bool:
    """Phase 7: the real K2 at each of ``K2_SPLITS``, each copy of
    ``K2_VARIANTS`` (at the wrapper's split) and the older K2 if built, on
    chip_smoke.py phase 9's inputs: each against the plain version (phase
    8's bf16 tolerance, relative), the real K2's live split partials
    against ``verify_partials_torch`` (``cs.K2_PARTIALS_TOL``), then 200
    launches each in turns beside SDPA on pre-gathered K/V. Returns whether
    all agree."""
    dtype = torch.bfloat16
    q, kp, vp, tables, positions = cs.k2_inputs(dtype, torch.full((cs.S,), 1019), seed=7)
    s, w, h, d = q.shape
    ref = pa.paged_verify_attention_torch(q, kp, vp, tables, positions).float()
    real = pa._verify_fn()
    stream = torch.cuda.current_stream().cuda_stream
    wrapper_split = pa.decode_splits(cs.T, cs.BS)[0]

    def call(fn, split_tokens):
        pps = split_tokens // cs.BS
        splits = -(-cs.T // pps)
        out = torch.empty_like(q)
        scratch = torch.empty((s, h, splits, w, d + 2), device="cuda")
        tickets = torch.zeros((s, h), dtype=torch.int32, device="cuda")

        def run():
            return fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(), positions.data_ptr(),
                      out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), s, w, h, d, cs.NB, cs.BS, cs.T,
                      pps, d ** -0.5, 1, stream)

        run.scratch = scratch  # the last call's partials
        return out, run

    runs = {f"split {n}": call(real, n) for n in K2_SPLITS}
    old = old_k2_fn(built)
    if old is not None:
        old_out = torch.empty_like(q)
        runs["old K2 (--old-k2)"] = (old_out, lambda: old(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(), positions.data_ptr(),
            old_out.data_ptr(), s, w, h, d, cs.NB, cs.BS, cs.T, d ** -0.5, 1, stream))
    for name in K2_VARIANTS:
        path, log = built[name]
        fn = ctypes.CDLL(str(path)).paged_verify_attention
        fn.argtypes, fn.restype = real.argtypes, real.restype
        runs[f"{name}, split {wrapper_split}"] = call(fn, wrapper_split)
        print(f"K2 variant {name}, -Xptxas -v: " + "; ".join(k2_report(log)))
    print("K2, -Xptxas -v: " + "; ".join(k2_report(_kernels.build_log("paged_verify_attention"))))

    def agrees(out) -> tuple[bool, float]:
        err = (out.float() - ref).abs()
        return bool((err <= cs.TOL[dtype] * ref.abs().clamp_min(1)).all()), err.max().item()

    ok = True
    for name, (out, fn) in runs.items():
        err = fn()
        torch.cuda.synchronize()
        good, gap = agrees(out)
        ok &= err == 0 and good
        print(f"K2 {name}: launch {err}, max abs error {gap:.3g} (tol {cs.TOL[dtype]} x max(1, |plain|))")
    length = (positions[:, -1].long() + 1).clamp(max=cs.T * cs.BS)
    for n in K2_SPLITS:
        want = pa.verify_partials_torch(q, kp, vp, tables, positions, n)
        live = torch.arange(want.shape[2], device="cuda")[None, :] * n < length[:, None]
        live = live[:, None, :].expand(s, h, -1)
        got = runs[f"split {n}"][1].scratch
        gap = ((got[live] - want[live]).abs().max() / want[live].abs().max().clamp_min(1)).item()
        ok &= gap <= cs.K2_PARTIALS_TOL[dtype]
        print(f"K2 split {n}: {int(live[0, 0].sum())} live split partials a (slot, head) against "
              f"verify_partials_torch, largest difference {gap:.3g} of max(1, largest value) (limit "
              f"{cs.K2_PARTIALS_TOL[dtype]})")
    # the library yardstick of chip_smoke.py phase 9
    n_live = (int(positions[:, -1].max().item()) + 1 + cs.BS - 1) // cs.BS
    idx = tables[:, :n_live].long()
    kd = kp[idx].transpose(1, 2).reshape(s, h, n_live * cs.BS, d)
    vd = vp[idx].transpose(1, 2).reshape(s, h, n_live * cs.BS, d)
    mask = (torch.arange(n_live * cs.BS, device="cuda")[None, None, :] <= positions[:, :, None])[:, None]
    qh = q.transpose(1, 2)
    fns = {name: fn for name, (_, fn) in runs.items()}
    fns["SDPA on pre-gathered K/V"] = lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=mask)
    bound = cs.k2_bound_ms(dtype, positions)
    times = cs.in_turns(fns, 200)
    print(f"K2 at {cs.S} slots, W {w} at 1019-1023, bf16 (ms per call, in turns; bound {bound:.4f} ms):")
    for name, ts in times.items():
        print(f"  {name}: {' / '.join(f'{t:.4f}' for t in ts)} ({min(ts) / bound:.2f}x bound)")
    # each output again, from the last of its ~800 calls: a merge ticket
    # left off zero by one launch would break the ones after it
    for name, (out, _) in runs.items():
        good, gap = agrees(out)
        ok &= good
        if not good:
            print(f"K2 {name}: max abs error {gap:.3g} after the timed calls")
    # the split sizes again at chip_smoke.py phase 12's context (~548): the
    # split is sized from the table width alone, so it serves every context
    q, kp, vp, tables, positions = cs.k2_inputs(dtype, torch.full((cs.S,), 543), seed=8)
    ref = pa.paged_verify_attention_torch(q, kp, vp, tables, positions).float()
    runs = {f"split {n}": call(real, n) for n in K2_SPLITS}
    for name, (out, fn) in runs.items():
        err = fn()
        torch.cuda.synchronize()
        good, gap = agrees(out)
        ok &= err == 0 and good
    bound = cs.k2_bound_ms(dtype, positions)
    times = cs.in_turns({name: fn for name, (_, fn) in runs.items()}, 200)
    print(f"K2 at {cs.S} slots, W {w} at 543-547, bf16 (ms per call, in turns; bound {bound:.4f} ms): " + "; ".join(
        f"{name} {' / '.join(f'{t:.4f}' for t in ts)} ({min(ts) / bound:.2f}x bound)" for name, ts in times.items()))
    return ok


def k2_report(log: str) -> list:
    """'bf16 d=256 QT=1: 128 registers, 0 bytes spill stores' for each bf16
    instance of the verify kernel in an -Xptxas -v report."""
    out, current, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            current = None
            if "paged_verify_kernel" in name and "nv_bfloat16" in name:
                dims = name.split("nv_bfloat16")[1]
                current = f"bf16 d={dims.split('Li')[1].split('E')[0]}"
                if "ELi" in dims:
                    current += f" QT={dims.split('ELi')[1].split('E')[0]}"
        elif current and "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif current and "Used" in line and "registers" in line:
            out.append(f"{current}: {line.split('Used')[1].split(',')[0].strip()}, {spill}")
            current = None
    return sorted(out)


def k2_in_verify_step(built: dict, card: str) -> None:
    """Phase 8 (``--old-k2``): this K2 behind its wrapper and the older K2
    behind the older wrapper (``old_k2_wrapper``). First each wrapper's host
    time per call, and this kernel's C entry point called alone, at 8
    slots, W 5 ending at position 547. Then chip_smoke.py phase 12's
    GPT-J-6B speculating engine (spec_k 4), traffic and always-confident
    test-double drafter, each wrapper in turn as the model runner's verify
    attention (this, old, old, this, twice): 2 steps, then 10 timed on the
    host clock ending in a sync, the acceptance backoff held off before
    each step; in each arm's first turn 10 more under torch.profiler, for
    K2's device time per step."""
    old = old_k2_wrapper(old_k2_fn(built))
    new = pa.paged_verify_attention_cuda
    q, kp, vp, tables, positions = cs.k2_inputs(torch.bfloat16, torch.full((cs.S,), 543), seed=2)
    s, w, h, d = q.shape
    split_tokens, splits = pa.decode_splits(cs.T, cs.BS)
    scratch = torch.empty((s, h, splits, w, d + 2), device="cuda")
    tickets = torch.zeros(s * h, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    real, stream = pa._verify_fn(), torch.cuda.current_stream().cuda_stream
    args = (q, kp, vp, tables, positions)
    host = host_us({
        "this wrapper": lambda: new(*args),
        "older wrapper and kernel": lambda: old(*args),
        "this kernel's C entry point alone": lambda: real(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), tickets.data_ptr(), s, w, h, d, cs.NB, cs.BS, cs.T, split_tokens // cs.BS,
            d ** -0.5, 1, stream)})
    print(f"K2 host time per call at {cs.S} slots, W {w} ending at 547, bf16 (µs, in turns, 200 calls a "
          "turn): " + "; ".join(f"{n} {' / '.join(f'{t:.2f}' for t in ts)}" for n, ts in host.items()))
    del q, kp, vp, tables, positions, scratch, tickets, out
    torch.cuda.empty_cache()

    cfg = cs.GPTJ_6B
    params = cs.gptj_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = cs.LLMEngine(cfg, params, cs.EngineConfig(max_slots=8, block_size=16, max_blocks_per_seq=128,
                                                    num_blocks=1025, prefill_chunk=256, spec_k=4))
    eng.warmup()
    eng._drafter = cs.ConfidentDrafter(eng.cfg.spec_k)
    reqs = cs.steady_batch(eng, 1024)  # ~116 verify steps of up to 5 tokens
    fns = {"this K2": new, "older K2": old}
    wall: dict = {name: [] for name in fns}
    k2_dev: dict = {}
    steps = 10

    def hold_off_backoff():
        eng._spec_skip = 0

    try:
        for name in ("this K2", "older K2", "older K2", "this K2") * 2:
            model_runner.paged_verify_attention = fns[name]
            for _ in range(2):
                hold_off_backoff()
                eng.step()
            if name in k2_dev:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    hold_off_backoff()
                    eng.step()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / steps
            else:
                wall_ms, _, kernels = cs.profile_steps(eng, steps, hold_off_backoff)
                k2_dev[name] = sum(e.self_device_time_total for e in kernels
                                   if "paged_verify_kernel" in e.key) / 1e3 / steps
            wall[name].append(wall_ms)
    finally:
        model_runner.paged_verify_attention = pa.paged_verify_attention
    if not all(r.state == cs.RUNNING for r in reqs):
        raise AssertionError("phase 8: a request finished inside the timed steps")
    print(f"GPT-J-6B verify step [{card}], 8 slots, W 5, at context ~{reqs[0].seq_len}, in turns (this, older, "
          f"older, this, twice; {steps} steps a turn): " + "; ".join(
              f"{n} wall {' / '.join(f'{t:.3f}' for t in wall[n])} ms (median {np.median(wall[n]):.3f}), "
              f"K2 device {k2_dev[n]:.3f} ms per step" for n in fns))
    for r in reqs:
        eng.cancel(r.id)
    eng.step()


def k1_same(old_src: str) -> bool:
    """Phase 9 (``--k1-same``): the current K1 against an earlier source with
    the same split entry point, at the head dims both take (the earlier
    one returns an error for the rest, so it is asked at each of
    ``DECODE_HEAD_DIMS`` and skipped where it refuses). Returns whether
    every output and live partial is equal bit for bit."""
    path, log = build_sources({"earlier K1": old_src}, "probe")["earlier K1"]
    real = pa._decode_fn()
    old = ctypes.CDLL(str(path)).paged_decode_attention
    old.argtypes, old.restype = real.argtypes, real.restype
    print("earlier K1, -Xptxas -v: " + "; ".join(bf16_report(log)))
    stream = torch.cuda.current_stream().cuda_stream
    split_tokens, splits = pa.decode_splits(cs.T, cs.BS)
    rng = np.random.RandomState(0)
    sp = split_tokens
    batches = (torch.tensor([1, 15, 16, 17, cs.T * cs.BS, *rng.randint(1, cs.T * cs.BS + 1, 2), 0]),
               torch.tensor([sp - 1, sp, sp + 1, 2 * sp, 2 * sp + 1, 100, rng.randint(1, cs.T * cs.BS + 1), 0]))

    def launcher(fn, q, kp, vp, tables, lengths):
        s, h, d = q.shape
        out = torch.empty_like(q)
        scratch = torch.empty((s, h, splits, d + 2), device="cuda")
        tickets = torch.zeros((s, h), dtype=torch.int32, device="cuda")

        def run():
            return fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
                      out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), s, h, d, cs.NB, cs.BS, cs.T,
                      split_tokens // cs.BS, d ** -0.5, pa._DTYPE_CODE[q.dtype], stream)

        return run, out, scratch

    def takes(d) -> bool:  # the earlier source refuses a head dim it was not compiled for
        args = cs.k1_inputs(torch.float32, torch.ones(cs.S, dtype=torch.int64), seed=1, d=d, h=1)
        return launcher(old, *args)[0]() == 0

    dims = [d for d in pa.DECODE_HEAD_DIMS if takes(d)]
    ok = True
    for d in dims:
        h = cs.k1_heads(d)
        for dtype in (torch.float32, torch.bfloat16):
            for lens in batches:
                args = cs.k1_inputs(dtype, lens, seed=1, d=d, h=h)
                runs = [launcher(fn, *args) for fn in (old, real)]
                if any(run() != 0 for run, _, _ in runs):
                    raise RuntimeError(f"K1 d={d}: launch failed")
                torch.cuda.synchronize()
                live = torch.arange(splits, device="cuda")[None, :] * split_tokens < args[4].long()[:, None]
                live = live[:, None, :].expand(-1, h, -1)
                (_, out_old, part_old), (_, out_new, part_new) = runs
                same = torch.equal(out_old, out_new) and torch.equal(part_old[live], part_new[live])
                ok &= same
                print(f"K1 d={d} {dtype} lengths={lens.tolist()}: earlier and current "
                      f"{'equal bit for bit' if same else 'DIFFER'} (outputs and live split partials)")
    for d in dims:
        h = cs.k1_heads(d)
        args = cs.k1_inputs(torch.bfloat16, torch.full((cs.S,), 1024), seed=2, d=d, h=h)
        fns = {"earlier": launcher(old, *args)[0], "current": launcher(real, *args)[0]}
        times = cs.in_turns(fns, 200)
        print(f"K1 d={d} at {cs.S} slots x 1024, bf16, in turns: " + "; ".join(
            f"{name} {' / '.join(f'{t:.4f}' for t in ts)} ms" for name, ts in times.items()))
    print(f"earlier K1 takes head dims {dims}")
    return ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old-k1", help="an earlier paged_attention.cu with the one-pass C entry point "
                        "(phase 6, and a row of phase 3)")
    parser.add_argument("--old-k2", help="an earlier paged_verify_attention.cu with the one-pass C entry "
                        "point (phase 8, and a row of phase 7)")
    parser.add_argument("--k2-only", action="store_true", help="run phases 7 and 8 alone")
    parser.add_argument("--k1-same", help="an earlier paged_attention.cu with the current split entry "
                        "point: run phase 9 alone")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_flash_probe: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}")
    if args.k1_same:
        with open(args.k1_same) as f:
            same = k1_same(f.read())
        print(f"K1 earlier and current {'equal bit for bit' if same else 'DIFFER'}")
        return 0 if same else 1
    built = build_all(args.old_k1, args.old_k2, args.k2_only)
    ok = variants_ok = k1_ok = True
    if not args.k2_only:
        ok = check_helpers(built["helpers"][0])
        print(f"helpers {'agree' if ok else 'DISAGREE'} with torch")
        variants_ok = time_variants(built)
        k1_ok = time_k1_variants(built)
        k4_after_others()
        torch.cuda.empty_cache()
        step_with_each_k4(built)
        torch.cuda.empty_cache()
        if args.old_k1:
            k1_in_decode_step(built, card)
            torch.cuda.empty_cache()
        else:
            print("phase 6 skipped: no --old-k1 source")
    k2_ok = time_k2_variants(built)
    torch.cuda.empty_cache()
    if args.old_k2:
        k2_in_verify_step(built, card)
    else:
        print("phase 8 skipped: no --old-k2 source")
    print(f"flash variants {'agree' if variants_ok else 'DISAGREE'}; "
          f"K1 variants {'agree' if k1_ok else 'DISAGREE'}; K2 variants {'agree' if k2_ok else 'DISAGREE'} "
          "with the plain version")
    return 0 if ok and variants_ok and k1_ok and k2_ok else 1


if __name__ == "__main__":
    sys.exit(main())
