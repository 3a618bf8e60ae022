#!/usr/bin/env python3
"""Probes of the bf16 flash kernels' Hopper design (K3 and K5), on one GPU.

    python3 chip_flash_probe.py      # from the repository root, one NVIDIA H100

1. helpers: one product of each ``wgmma`` form the kernels use, on one
   64-row tile, against a torch matmul: S = A B^T with both operands
   K-major in shared memory (SS), and O = P V with P from registers and V
   MN-major through the transpose bit (RS), at d 64 and 128. A wrong
   descriptor gives wrong numbers, not a fault; this names the product.
2. variants: copies of ``flash_attention.cu`` with one change each, built
   into ``ray_tpu_torch/_build/probe/`` and timed in turns with the real
   K3 and K5 at the training shape (bh 416, seq 1024, d 64, bf16): bh on
   the grid's fastest axis (the first design's order), and register caps
   that would fit more CTAs on an SM.
3. K4 after other kernels: K4 (dQ) from an idle card, and right after
   200 launches of K3 or K5, with the SM clock and power read after each.

Exits non-zero when a build fails or a helper product disagrees.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs
from chip_mutants import build_sources, edited_source
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops import flash_attention as fa

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
    "bh fastest (the first design's grid order)": [
        ("  const int bh = blockIdx.x / nq;\n  const int qi = nq - 1 - blockIdx.x % nq;",
         "  const int nbh = gridDim.x / nq;\n  const int bh = blockIdx.x % nbh;\n"
         "  const int qi = nq - 1 - blockIdx.x / nbh;"),
        ("  const int bh = blockIdx.x / nq;\n  const int kj = blockIdx.x % nq;",
         "  const int nbh = gridDim.x / nq;\n  const int bh = blockIdx.x % nbh;\n"
         "  const int kj = blockIdx.x / nbh;")],
    "K3 capped for 5 CTAs per SM": [
        ("__launch_bounds__(kThreads)\nflash_fwd_kernel_wgmma", "__launch_bounds__(kThreads, 5)\nflash_fwd_kernel_wgmma")],
    "K5 capped for 3 CTAs per SM": [
        ("__launch_bounds__(kThreads)\nflash_bwd_dkv_kernel_wgmma",
         "__launch_bounds__(kThreads, 3)\nflash_bwd_dkv_kernel_wgmma")],
}


def build_all() -> dict:
    """The real library, the helper probe and every variant, one nvcc each,
    all started together: {name: (library path, -Xptxas -v report)}."""
    sources = {"helpers": HELPERS_CU.format(source=SOURCE)}
    sources.update({name: edited_source(edits) for name, edits in VARIANTS.items()})
    with ThreadPoolExecutor(1) as pool:
        real = pool.submit(_kernels.build, "flash_attention")
        built = build_sources(sources, "probe")
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


def wgmma_report(log: str) -> list:
    """'K3 d=64: 117 registers, 0 bytes spill stores' for each wgmma kernel
    instance in an -Xptxas -v report."""
    out, current, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            current = None
            if "wgmma" in name:
                current = f"{'K3' if 'flash_fwd' in name else 'K5'} d={128 if 'Li128E' in name else 64}"
        elif current and "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif current and "Used" in line and "registers" in line:
            out.append(f"{current}: {line.split('Used')[1].split(',')[0].strip()}, {spill}")
            current = None
    return sorted(out)


def time_variants(built: dict) -> None:
    """Phase 2: the real K3 and K5 and each variant's, in turns (forward
    order then reverse), 100 launches each between CUDA events."""
    bh, seq, d = cs.TRAIN_B * cs.TRAIN_H, cs.TRAIN_S, cs.TRAIN_D
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(bh, seq, d, device="cuda", generator=g, dtype=torch.bfloat16)
                   for _ in range(4))
    out, lse = fa.flash_fwd_cuda(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    o2, l2, dk2, dv2 = torch.empty_like(q), torch.empty_like(lse), torch.empty_like(q), torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    fns = {"real": {"K3": lambda: fa.flash_fwd_cuda(q, k, v),
                    "K5": lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)}}
    for name in VARIANTS:
        path, log = built[name]
        lib = ctypes.CDLL(str(path))
        f, b = lib.flash_fwd, lib.flash_bwd_dkv
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        b.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fns[name] = {
            "K3": lambda f=f: f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(), l2.data_ptr(),
                                bh, seq, d, d ** -0.5, 1, stream),
            "K5": lambda b=b: b(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dk2.data_ptr(), dv2.data_ptr(), bh, seq, d, d ** -0.5, 1,
                                stream),
        }
        print(f"variant {name}, -Xptxas -v of the wgmma kernels: " + "; ".join(wgmma_report(log)))
    print(f"variants at bh {bh}, seq {seq}, d {d}, bf16 (ms per launch, in turns):")
    for kernel in ("K3", "K5"):
        times: dict = {}
        for name in [*fns, *reversed(fns)]:
            times.setdefault(name, []).append(cs.cuda_ms(fns[name][kernel], 100))
        print(f"  {kernel}: " + "; ".join(f"{n} {' / '.join(f'{t:.4f}' for t in ts)}"
                                         for n, ts in times.items()))


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def k4_after_others() -> None:
    """Phase 3: K4's 200-launch time from an idle second, and right after
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_flash_probe: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}")
    built = build_all()
    ok = check_helpers(built["helpers"][0])
    time_variants(built)
    k4_after_others()
    print(f"helpers {'agree' if ok else 'DISAGREE'} with torch")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
