// Causal flash attention for Hopper (sm_90a): the forward (K3) and the two
// backward kernels, dQ (K4) and dK/dV (K5).
//
// Replaces ray_tpu/ops/flash_attention.py:
//   K3 flash_fwd      <- _flash_fwd (pallas_call :106, body _fwd_kernel :57)
//   K4 flash_bwd_dq   <- _flash_bwd's dq call (:233, body _dq_kernel :137)
//   K5 flash_bwd_dkv  <- _flash_bwd's dk/dv call (:250, body _dkv_kernel :177)
// Same contract as the plain PyTorch versions in
// ray_tpu_torch/ops/flash_attention.py (flash_fwd_reference,
// flash_bwd_reference):
//   q, k, v, dO       (bh, seq, D)  fp32 or bf16, D in {64, 128}
//   out, dq, dk, dv   (bh, seq, D)  q's dtype
//   lse, delta        (bh, seq)     fp32 (the reference's (bh, 8, seq) is a
//                                   Mosaic tiling artifact)
// K3 scales q in fp32 before the QK product, as _fwd_kernel does (in bf16 the
// product runs on the tensor cores from the unscaled bf16 q and the fp32
// scores are scaled after it: the same number up to one fp32 rounding). K4
// and K5 apply the scale after the product, as the reference does. delta =
// rowsum(dO * out) is computed outside the kernels, in fp32.
//
// What bounds them at the training shape (bh = 26 x 16 = 416, seq 1024,
// D 64, bf16; chip_smoke.py phase 13 computes these from the inputs): K3 its
// bytes (219.8 MB, 0.0656 ms at 3.35 TB/s, against 55.8 GFLOP = 0.0565 ms),
// K4 its operations (83.8 GFLOP = 0.0847 ms at 989 TFLOP/s, against 276.0 MB
// = 0.0824 ms), K5 its operations (111.7 GFLOP = 0.1129 ms). All three sit
// near the card's ridge, so a fast version needs both the tensor cores at
// wgmma's rate and loads that overlap the products.
//
// Design: the TPU grid's sequential minor axis becomes a loop inside one CTA.
// Tiles are 64 rows on both sides; a CTA has 4 warps, each owning 16 rows of
// the CTA's own tile, so the online-softmax state and the accumulators of a
// row live in registers of one warp (lane g*4+t holds rows g and g+8,
// columns 2t and 2t+1 of each 8-column slice: the mma.sync m16n8 layout,
// which is also each warp's part of the wgmma m64nN accumulator), and row
// reductions are two quad shuffles.
//   K3, K4: one CTA per (bh, Q tile), looping over the KV tiles up to the
//   diagonal; only the diagonal tile is masked.
//   K5: one CTA per (bh, KV tile), looping over the Q tiles from the diagonal
//   (i_first in the reference) to the end; it computes S^T = K Q^T so the
//   row-owned layout holds the tile's keys, and writes dK and dV once, with
//   no atomics.
// Rows past seq load as zeros, are masked (keys past a valid query are
// causally dead; queries past seq are masked explicitly in K5) and are never
// written. Offsets into (bh, seq, D) tensors are 64-bit.
//
// The bf16 kernels (flash_fwd_kernel_wgmma, flash_bwd_dq_kernel_wgmma,
// flash_bwd_dkv_kernel_wgmma) are built for Hopper: the CTA is one
// warpgroup; its stationary tiles (Q in K3, Q and dO in K4, K and V in K5)
// are loaded once and the moving tiles (K/V in K3 and K4; Q, dO and their
// lse/delta rows in K5) come through a 2-stage ring of cp.async copies
// (zero-filled past seq), the next tile in flight while one computes. K4
// reads its rows' lse and delta once, into registers. Tiles sit in shared
// memory in the wgmma 128-byte-swizzle layout. Every product is a wgmma
// with fp32 accumulation: the score products (S, and dP or dP^T in K4 and
// K5) take both operands from shared memory, K-major, and are issued back
// to back, so the second runs while P is built from the first; the second
// products (O += P V; dQ += dS K; dV += P^T dO, dK += dS^T Q) take P or dS
// from registers, rounded to bf16 straight from the accumulator layout (two
// adjacent 8-column slices are one k16 A fragment), and B from shared
// memory through the transpose bit. No P or dS tile goes through shared
// memory. The softmax runs in log2 units (exp2 of one FMA per score).
// Their grid is 1-D and head-major: the CTAs of one head run side by side,
// so each K/V (K3, K4) or Q/dO (K5) tile, which 1-16 CTAs of the head read,
// comes from L2 after its first read. With bh on the fastest axis instead,
// the CTAs in flight together belong to different heads, and their tile
// reads (905 MB per launch at the training shape, 8.3x the two tensors they
// come from) find little in L2: on an H100, K3 takes about 1.8x as long
// that way, K4 about 1.6x and K5 about 1.2x (chip_flash_probe.py times
// both orders; PERF.md).
// The fp32 kernels keep the first design: plain fp32 FMA chains (no TF32,
// so the fp32 results differ from the plain version by summation order
// only), operands read from padded shared memory (8 elements of padding per
// row), tiles loaded synchronously with 16-byte vector loads. The bf16
// branch of the same templates (mma.sync m16n8k16, P and dS rounded to
// bf16 through padded shared memory) is the first bf16 design; no launch
// instantiates it now, and chip_flash_probe.py builds bf16 K4 through it as
// the baseline the wgmma K4 is timed against.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlock = 64;              // rows of a Q tile and of a KV tile
constexpr int kWarps = 4;               // each owns 16 rows of the CTA's tile
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                 // shared-memory row padding, elements
constexpr int kLdp = kBlock + kPad;     // leading dim of a (64, 64) P/dS tile
constexpr float kNegInf = -1e30f;       // the reference's NEG_INF

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// two consecutive elements (the first at an even offset) from fp32 values
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows [row0, row0 + 64) of a row-major (seq, D) matrix into a shared tile
// [64][D + kPad]; rows at or past seq are zeros. fp32 values are multiplied
// by ``mul`` on the way (K3's pre-scaled q).
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int row0, int seq,
                                          float mul = 1.f) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kChunks = D / kVec;     // loads per row
  constexpr int ld = D + kPad;
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq) val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * D + c);
    if constexpr (kIsF32<T>) {
      float4 f = *reinterpret_cast<float4*>(&val);
      f.x *= mul; f.y *= mul; f.z *= mul; f.w *= mul;
      *reinterpret_cast<float4*>(dst + r * ld + c) = f;
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  }
}

// 64 per-row fp32 statistics (lse or delta) starting at row0; 0 past seq
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int seq) {
  for (int r = threadIdx.x; r < kBlock; r += kThreads) dst[r] = row0 + r < seq ? src[row0 + r] : 0.f;
}

// the mma.sync path of bf16 warp_gemm (the first bf16 design, built only by
// chip_flash_probe.py)
[[maybe_unused]] __device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
[[maybe_unused]] __device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
[[maybe_unused]] __device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[nt][e] += sum over k < KD of A(row, k) * B(k, col), for one warp's
// 16-row strip, where row = g + 8 * (e >> 1) and col = 8 * nt + 2 * t + (e & 1)
// (g = lane / 4, t = lane % 4: the mma.sync m16n8 accumulator layout). A is
// row-major with leading dim lda, starting at the strip's first row.
// B(k, n) = B[n * ldb + k] when BT (a transposed operand: K in Q K^T), else
// B[k * ldb + n].
template <typename T, int NT, int KD, bool BT>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4], const T* A, int lda, const T* B,
                                          int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kIsF32<T>) {
    // full fp32: one FMA chain per output element, k in order
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1);
        const int col = 8 * nt + 2 * t + (e & 1);
        const float* a = A + row * lda;
        float acc = c[nt][e];
#pragma unroll 8
        for (int k = 0; k < KD; ++k) acc = fmaf(a[k], BT ? B[col * ldb + k] : B[k * ldb + col], acc);
        c[nt][e] = acc;
      }
    }
  } else {
#pragma unroll
    for (int k0 = 0; k0 < KD; k0 += 16) {
      uint32_t a[4];
      a[0] = ld_pair(A + g * lda + k0 + 2 * t);
      a[1] = ld_pair(A + (g + 8) * lda + k0 + 2 * t);
      a[2] = ld_pair(A + g * lda + k0 + 2 * t + 8);
      a[3] = ld_pair(A + (g + 8) * lda + k0 + 2 * t + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = 8 * nt + g;
        uint32_t b0, b1;
        if constexpr (BT) {
          b0 = ld_pair(B + n * ldb + k0 + 2 * t);
          b1 = ld_pair(B + n * ldb + k0 + 2 * t + 8);
        } else {
          b0 = pack2(B[(k0 + 2 * t) * ldb + n], B[(k0 + 2 * t + 1) * ldb + n]);
          b1 = pack2(B[(k0 + 2 * t + 8) * ldb + n], B[(k0 + 2 * t + 9) * ldb + n]);
        }
        mma_bf16(c[nt], a, b0, b1);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// K3: forward. Grid (bh, Q tiles); the longest rows (last Q tiles) first.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int seq, float scale) {
  constexpr int ld = D + kPad;
  constexpr int NTD = D / 8, NTK = kBlock / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + kBlock * ld;
  T* sv = sk + kBlock * ld;
  T* sp = sv + kBlock * ld;  // P, [64][kLdp]

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int q0 = qi * kBlock;
  const int64_t base = (int64_t)bh * seq * D;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's first row in the tile

  // fp32 scales q before the product, as the reference; bf16 after it
  load_tile<T, D>(sq, q + base, q0, seq, kIsF32<T> ? scale : 1.f);
  const float s_mul = kIsF32<T> ? 1.f : scale;

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NTD][4] = {};
  for (int j = 0; j <= qi; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(sk, k + base, k0, seq);
    load_tile<T, D>(sv, v + base, k0, seq);
    __syncthreads();

    float s[NTK][4] = {};
    warp_gemm<T, NTK, D, true>(s, sq + r0 * ld, ld, sk, ld);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = s[nt][e] * s_mul;
        if (j == qi && 8 * nt + 2 * t + (e & 1) > r0 + g + 8 * h) x = kNegInf;  // col > row
        s[nt][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float corr[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      corr[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - mx[e >> 1]);
        s[nt][e] = p;
        rowsum[e >> 1] += p;
      }
      store2(sp + (r0 + g) * kLdp + 8 * nt + 2 * t, s[nt][0], s[nt][1]);
      store2(sp + (r0 + g + 8) * kLdp + 8 * nt + 2 * t, s[nt][2], s[nt][3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(rowsum[h]);
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= corr[e >> 1];
    }
    __syncwarp();  // the warp's P rows are in shared memory
    warp_gemm<T, NTD, kBlock, false>(acc, sp + r0 * kLdp, kLdp, sv, ld);
    __syncwarp();  // P is read before the next tile overwrites it
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row >= seq) continue;
    const float lh = fmaxf(l[h], 1e-30f);
    T* o = out + base + (int64_t)row * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) store2(o + 8 * nt, acc[nt][2 * h] / lh, acc[nt][2 * h + 1] / lh);
    if (t == 0) lse[(int64_t)bh * seq + row] = m[h] + logf(lh);
  }
}

// ---------------------------------------------------------------------------
// K4: dQ, fp32 (and the first bf16 design). Grid (bh, Q tiles); the longest
// rows first.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int seq, float scale) {
  constexpr int ld = D + kPad;
  constexpr int NTD = D / 8, NTK = kBlock / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sdo = sq + kBlock * ld;
  T* sk = sdo + kBlock * ld;
  T* sv = sk + kBlock * ld;
  T* sds = sv + kBlock * ld;  // dS, [64][kLdp]

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int q0 = qi * kBlock;
  const int64_t base = (int64_t)bh * seq * D;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;

  load_tile<T, D>(sq, q + base, q0, seq);
  load_tile<T, D>(sdo, dout + base, q0, seq);
  // rows past seq read 0 (never -inf): their p stays finite and is not written
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    lse_r[h] = row < seq ? lse[(int64_t)bh * seq + row] : 0.f;
    delta_r[h] = row < seq ? delta[(int64_t)bh * seq + row] : 0.f;
  }

  float dqa[NTD][4] = {};
  for (int j = 0; j <= qi; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();
    load_tile<T, D>(sk, k + base, k0, seq);
    load_tile<T, D>(sv, v + base, k0, seq);
    __syncthreads();

    float s[NTK][4] = {};
    float dp[NTK][4] = {};
    warp_gemm<T, NTK, D, true>(s, sq + r0 * ld, ld, sk, ld);
    warp_gemm<T, NTK, D, true>(dp, sdo + r0 * ld, ld, sv, ld);
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool dead = j == qi && 8 * nt + 2 * t + (e & 1) > r0 + g + 8 * h;
        const float p = dead ? 0.f : expf(scale * s[nt][e] - lse_r[h]);
        ds[e] = p * (dp[nt][e] - delta_r[h]) * scale;
      }
      store2(sds + (r0 + g) * kLdp + 8 * nt + 2 * t, ds[0], ds[1]);
      store2(sds + (r0 + g + 8) * kLdp + 8 * nt + 2 * t, ds[2], ds[3]);
    }
    __syncwarp();
    warp_gemm<T, NTD, kBlock, false>(dqa, sds + r0 * kLdp, kLdp, sk, ld);
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row >= seq) continue;
    T* o = dq + base + (int64_t)row * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) store2(o + 8 * nt, dqa[nt][2 * h], dqa[nt][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// K5: dK and dV. Grid (bh, KV tiles); the first KV tiles (the most live Q
// tiles) first.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int seq, float scale) {
  constexpr int ld = D + kPad;
  constexpr int NTD = D / 8, NTK = kBlock / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + kBlock * ld;
  T* sq = sv + kBlock * ld;
  T* sdo = sq + kBlock * ld;
  T* spt = sdo + kBlock * ld;   // P^T, [64 keys][kLdp]
  T* sdst = spt + kBlock * kLdp;  // dS^T
  float* slse = reinterpret_cast<float*>(sdst + kBlock * kLdp);
  float* sdelta = slse + kBlock;

  const int bh = blockIdx.x;
  const int kj = blockIdx.y;
  const int k0 = kj * kBlock;
  const int nq = gridDim.y;
  const int64_t base = (int64_t)bh * seq * D;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's first key row in the tile

  load_tile<T, D>(sk, k + base, k0, seq);
  load_tile<T, D>(sv, v + base, k0, seq);

  float dka[NTD][4] = {};
  float dva[NTD][4] = {};
  for (int i = kj; i < nq; ++i) {  // i_first = kj: the diagonal tile
    const int q0 = i * kBlock;
    __syncthreads();
    load_tile<T, D>(sq, q + base, q0, seq);
    load_tile<T, D>(sdo, dout + base, q0, seq);
    load_rows(slse, lse + (int64_t)bh * seq, q0, seq);
    load_rows(sdelta, delta + (int64_t)bh * seq, q0, seq);
    __syncthreads();

    float pt[NTK][4] = {};  // S^T, then P^T: rows keys, columns queries
    warp_gemm<T, NTK, D, true>(pt, sk + r0 * ld, ld, sq, ld);
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = r0 + g + 8 * (e >> 1);  // within the tile
        const int qc = 8 * nt + 2 * t + (e & 1);
        const bool live = q0 + qc < seq && (i != kj || key <= qc);
        pt[nt][e] = live ? expf(scale * pt[nt][e] - slse[qc]) : 0.f;
      }
      store2(spt + (r0 + g) * kLdp + 8 * nt + 2 * t, pt[nt][0], pt[nt][1]);
      store2(spt + (r0 + g + 8) * kLdp + 8 * nt + 2 * t, pt[nt][2], pt[nt][3]);
    }
    __syncwarp();
    warp_gemm<T, NTD, kBlock, false>(dva, spt + r0 * kLdp, kLdp, sdo, ld);  // dV += P^T dO

    float dpt[NTK][4] = {};  // dP^T = V dO^T
    warp_gemm<T, NTK, D, true>(dpt, sv + r0 * ld, ld, sdo, ld);
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * nt + 2 * t + (e & 1);
        ds[e] = pt[nt][e] * (dpt[nt][e] - sdelta[qc]) * scale;
      }
      store2(sdst + (r0 + g) * kLdp + 8 * nt + 2 * t, ds[0], ds[1]);
      store2(sdst + (r0 + g + 8) * kLdp + 8 * nt + 2 * t, ds[2], ds[3]);
    }
    __syncwarp();
    warp_gemm<T, NTD, kBlock, false>(dka, sdst + r0 * kLdp, kLdp, sq, ld);  // dK += dS^T Q
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + r0 + g + 8 * h;
    if (row >= seq) continue;
    T* ok = dk + base + (int64_t)row * D + 2 * t;
    T* ov = dv + base + (int64_t)row * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      store2(ok + 8 * nt, dka[nt][2 * h], dka[nt][2 * h + 1]);
      store2(ov + 8 * nt, dva[nt][2 * h], dva[nt][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Hopper building blocks of the bf16 K3 and K5: cp.async tile loads into the
// wgmma 128-byte-swizzle layout, shared-memory matrix descriptors, and wgmma
// with both operands in shared memory (SS) or A in registers (RS).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kSwzCols = kBlock * 128;  // bytes of one 64-row x 128-byte swizzle column
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A swizzled tile holds 64 rows of D bf16 as D / 64 columns of 64 rows x
// 128 bytes (one swizzle atom is 8 rows x 128 bytes, 1024-byte aligned);
// 16-byte chunk c of row r sits at chunk (c ^ r) & 7 of its 128-byte row,
// the layout the hardware's 128-byte swizzle expects.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 3) * kSwzCols + r * 128 + (((c ^ r) & 7) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// makes this thread's landed copies visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of a row-major (seq, D) bf16 matrix into the
// swizzled tile at dst, as 16-byte cp.async copies; rows past seq are
// zero-filled (src-size 0, from a valid address).
template <int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* __restrict__ src, int row0,
                                                int seq) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int n = 0; n < kBlock * kChunks / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < seq;
    cp_async16(dst + swizzled(r, c), src + (int64_t)(valid ? row0 + r : 0) * D + c * 8, valid);
  }
}

// 64 fp32 row statistics from row0: lse by threads 0-63, delta by 64-127,
// as 4-byte copies (a row's base bh * seq * 4 bytes is 16-byte aligned only
// when seq % 4 == 0); rows past seq read 0
__device__ __forceinline__ void load_rows_async(uint32_t dst, const float* __restrict__ lse,
                                                const float* __restrict__ delta, int row0, int seq) {
  const int r = threadIdx.x & (kBlock - 1);
  const bool valid = row0 + r < seq;
  const float* src = threadIdx.x < kBlock ? lse : delta;
  cp_async4(dst + (threadIdx.x < kBlock ? 0 : kBlock * 4) + 4 * r, src + (valid ? row0 + r : 0), valid);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (64 rows x 16 k, k contiguous): k slice kk of a swizzled
// tile; 8-row groups 1024 bytes apart, the slice 32 bytes into its column
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * kSwzCols + (kk & 3) * 32, 16, 1024);
}
// MN-major operand (16 k rows x all D columns, the columns contiguous; used
// with the transpose bit): rows 16 kk .. 16 kk + 15 of a swizzled tile;
// 8-row groups 1024 bytes apart, 64-column blocks kSwzCols apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, kSwzCols, 1024);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching registers an in-flight wgmma reads or
// writes: reads of an accumulator stay after the wait, and an A fragment
// stays allocated until it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define RT_F8(d, i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A B for a 64 x 64 x 16 product, A and B K-major in shared memory;
// d[4 * nt + e] is row 16 w + g + 8 (e >> 1), column 8 nt + 2 t + (e & 1)
// for warp w, lane 4 g + t
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : RT_F8(d, 0), RT_F8(d, 8), RT_F8(d, 16), RT_F8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B for a 64 x N x 16 product, A (4 bf16x2 registers: the mma.sync
// m16n8k16 A fragment of each warp's 16 rows) from registers, B MN-major in
// shared memory (the transpose bit)
template <int N>
__device__ void wgmma_rs_mn(float (&d)[N / 2], const uint32_t* a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs_mn<64>(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RT_F8(d, 0), RT_F8(d, 8), RT_F8(d, 16), RT_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_mn<128>(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RT_F8(d, 0), RT_F8(d, 8), RT_F8(d, 16), RT_F8(d, 24), RT_F8(d, 32), RT_F8(d, 40),
        RT_F8(d, 48), RT_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef RT_F8

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A 64 x 64 tile held in the accumulator layout as bf16 A fragments: k
// slice kk (columns 16 kk .. 16 kk + 15) is 8-column slices 2 kk and
// 2 kk + 1, i.e. x[8 kk .. 8 kk + 7]
__device__ __forceinline__ void to_a_frags(const float (&x)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    a[i] = *reinterpret_cast<uint32_t*>(&v);
  }
}

// the generic pointer and shared address of dynamic shared memory rounded
// up to 1024 bytes (swizzle atoms must be 1024-byte aligned)
struct AlignedSmem {
  unsigned char* ptr;
  uint32_t addr;
};
__device__ __forceinline__ AlignedSmem aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_addr(raw);
  const uint32_t pad = ((a + 1023u) & ~1023u) - a;
  return {raw + pad, a + pad};
}

// ---------------------------------------------------------------------------
// K3, bf16 on Hopper. A 1-D grid of bh x Q tiles, head-major so that the
// CTAs of one head run together and its K/V tiles come from L2; within a
// head the longest rows first. Shared memory: Q, then the two stages' K and
// V tiles.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                       int seq, float scale) {
  constexpr int kTile = kBlock * D * 2;  // bytes of a (64, D) bf16 tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = aligned_smem(smem_raw).addr;

  const int nq = (seq + kBlock - 1) / kBlock;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - blockIdx.x % nq;
  const int q0 = qi * kBlock;
  const int64_t base = (int64_t)bh * seq * D;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's first row in the tile
  const float sl2 = scale * kLog2e;        // scores to log2 units

  load_tile_async<D>(sq, q + base, q0, seq);
  load_tile_async<D>(sq + kTile, k + base, 0, seq);
  load_tile_async<D>(sq + 2 * kTile, v + base, 0, seq);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the row sums
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  for (int j = 0; j <= qi; ++j) {
    const uint32_t sk = sq + (1 + 2 * (j & 1)) * kTile, sv = sk + kTile;
    if (j < qi) {  // tile j + 1 into the other stage, in flight while j computes
      const uint32_t nk = sq + (1 + 2 * ((j + 1) & 1)) * kTile;
      load_tile_async<D>(nk, k + base, (j + 1) * kBlock, seq);
      load_tile_async<D>(nk + kTile, v + base, (j + 1) * kBlock, seq);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile j have landed
    fence_async_smem();
    __syncthreads();

    float s[32];  // S = Q K^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, desc_k(sq, kk), desc_k(sk, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    if (j == qi) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (8 * (i >> 2) + 2 * t + (i & 1) > r0 + g + 8 * ((i >> 1) & 1)) s[i] = -INFINITY;  // key > query
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mnew = fmaxf(m[h], quad_max(mx[h]) * sl2);  // finite: key 0 of a row is live
      corr[h] = fast_exp2(m[h] - mnew);
      m[h] = mnew;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = fast_exp2(fmaf(s[i], sl2, -m[h]));
      l[h] += s[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    uint32_t pa[16];  // P, bf16, as A fragments
    to_a_frags(s, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) wgmma_rs_mn<D>(o, pa + 4 * kk, desc_mn(sv, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    const float lh = fmaxf(quad_sum(l[h]), 1e-30f);
    if (row >= seq) continue;
    const float inv = 1.f / lh;
    bf16* dst = out + base + (int64_t)row * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) store2(dst + 8 * nt, o[4 * nt + 2 * h] * inv, o[4 * nt + 2 * h + 1] * inv);
    if (t == 0) lse[(int64_t)bh * seq + row] = (m[h] + log2f(lh)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// K4, bf16 on Hopper. A 1-D grid of bh x Q tiles, head-major as K3's; within
// a head the longest rows first. Shared memory: Q, dO, then the two stages'
// K and V tiles.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dq, int seq, float scale) {
  constexpr int kTile = kBlock * D * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = aligned_smem(smem_raw).addr, sdo = sq + kTile;
  // stage s: K at sq + (2 + 2 s) kTile, V after it

  const int tiles = (seq + kBlock - 1) / kBlock;
  const int qi = tiles - 1 - blockIdx.x % tiles;  // within a head, the longest rows first
  const int bh = blockIdx.x / tiles;
  const int q0 = qi * kBlock;
  const int64_t base = (int64_t)bh * seq * D;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's first row in the tile
  const float sl2 = scale * kLog2e;

  load_tile_async<D>(sq, q + base, q0, seq);
  load_tile_async<D>(sdo, dout + base, q0, seq);
  load_tile_async<D>(sq + 2 * kTile, k + base, 0, seq);
  load_tile_async<D>(sq + 3 * kTile, v + base, 0, seq);
  cp_async_commit();
  // this thread's two rows of lse (in log2 units) and delta; rows past seq
  // read 0 (never -inf): their p stays finite and is never written
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    lse2[h] = row < seq ? lse[(int64_t)bh * seq + row] * kLog2e : 0.f;
    dl[h] = row < seq ? delta[(int64_t)bh * seq + row] : 0.f;
  }

  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  for (int j = 0; j <= qi; ++j) {
    const uint32_t sk = sq + (2 + 2 * (j & 1)) * kTile, sv = sk + kTile;
    if (j < qi) {  // K/V tile j + 1 into the other stage, in flight while j computes
      const uint32_t nk = sq + (2 + 2 * ((j + 1) & 1)) * kTile;
      load_tile_async<D>(nk, k + base, (j + 1) * kBlock, seq);
      load_tile_async<D>(nk + kTile, v + base, (j + 1) * kBlock, seq);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and tile j have landed
    fence_async_smem();
    __syncthreads();

    float p[32], ds[32];  // S = Q K^T, then P; dP = dO V^T, then dS
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(p, desc_k(sq, kk), desc_k(sk, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(ds, desc_k(sdo, kk), desc_k(sv, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();  // S has landed; dP runs on
    fence_regs(p);

    // P = exp(scale S - lse), in log2 units
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = fast_exp2(fmaf(p[i], sl2, -lse2[(i >> 1) & 1]));
    if (j == qi) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (8 * (i >> 2) + 2 * t + (i & 1) > r0 + g + 8 * ((i >> 1) & 1)) p[i] = 0.f;  // key > query
      }
    }
    wgmma_wait<0>();  // dP has landed
    fence_regs(ds);

    // dS = P (dP - delta) scale
#pragma unroll
    for (int i = 0; i < 32; ++i) ds[i] = p[i] * (ds[i] - dl[(i >> 1) & 1]) * scale;
    uint32_t dsa[16];  // dS, bf16, as A fragments
    to_a_frags(ds, dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) wgmma_rs_mn<D>(dqa, dsa + 4 * kk, desc_mn(sk, kk));  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(dsa);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row >= seq) continue;
    bf16* dst = dq + base + (int64_t)row * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) store2(dst + 8 * nt, dqa[4 * nt + 2 * h], dqa[4 * nt + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// K5, bf16 on Hopper. A 1-D grid of bh x KV tiles, head-major as K3's;
// within a head the first KV tiles (the most live Q tiles) first. Shared
// memory: K, V, the two stages' Q and dO tiles, then the two stages' lse
// and delta rows.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, float scale) {
  constexpr int kTile = kBlock * D * 2;
  constexpr int kRows = 2 * kBlock * 4;  // bytes of a stage's lse and delta rows
  extern __shared__ unsigned char smem_raw[];
  const AlignedSmem smem = aligned_smem(smem_raw);
  const uint32_t sk = smem.addr, sv = sk + kTile;
  // stage s: Q at sk + (2 + 2 s) kTile, dO after it; rows at sk + 6 kTile + s kRows

  const int nq = (seq + kBlock - 1) / kBlock;
  const int bh = blockIdx.x / nq;
  const int kj = blockIdx.x % nq;
  const int k0 = kj * kBlock;
  const int64_t base = (int64_t)bh * seq * D;
  const float* lse_bh = lse + (int64_t)bh * seq;
  const float* delta_bh = delta + (int64_t)bh * seq;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's first key row in the tile
  const float sl2 = scale * kLog2e;

  load_tile_async<D>(sk, k + base, k0, seq);
  load_tile_async<D>(sv, v + base, k0, seq);
  load_tile_async<D>(sk + 2 * kTile, q + base, k0, seq);
  load_tile_async<D>(sk + 3 * kTile, dout + base, k0, seq);
  load_rows_async(sk + 6 * kTile, lse_bh, delta_bh, k0, seq);
  cp_async_commit();

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  for (int i = kj; i < nq; ++i) {  // i_first = kj: the diagonal tile
    const int st = (i - kj) & 1;
    const int q0 = i * kBlock;
    if (i + 1 < nq) {  // Q tile i + 1 into the other stage
      const uint32_t nq_tile = sk + (2 + 2 * (st ^ 1)) * kTile;
      load_tile_async<D>(nq_tile, q + base, q0 + kBlock, seq);
      load_tile_async<D>(nq_tile + kTile, dout + base, q0 + kBlock, seq);
      load_rows_async(sk + 6 * kTile + (st ^ 1) * kRows, lse_bh, delta_bh, q0 + kBlock, seq);
    }
    cp_async_commit();
    cp_async_wait<1>();  // K, V and stage st have landed
    fence_async_smem();
    __syncthreads();
    const uint32_t sq = sk + (2 + 2 * st) * kTile, sdo = sq + kTile;
    const float* slse = reinterpret_cast<const float*>(smem.ptr + 6 * kTile + st * kRows);
    const float* sdelta = slse + kBlock;

    float pt[32], dpt[32];  // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(pt, desc_k(sk, kk), desc_k(sq, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(dpt, desc_k(sv, kk), desc_k(sdo, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();  // S^T has landed
    fence_regs(pt);

    // P^T = exp(scale S^T - lse), in log2 units
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 lq = *reinterpret_cast<const float2*>(slse + 8 * nt + 2 * t);
      pt[4 * nt] = fast_exp2(fmaf(pt[4 * nt], sl2, -lq.x * kLog2e));
      pt[4 * nt + 1] = fast_exp2(fmaf(pt[4 * nt + 1], sl2, -lq.y * kLog2e));
      pt[4 * nt + 2] = fast_exp2(fmaf(pt[4 * nt + 2], sl2, -lq.x * kLog2e));
      pt[4 * nt + 3] = fast_exp2(fmaf(pt[4 * nt + 3], sl2, -lq.y * kLog2e));
    }
    if (i == kj || q0 + kBlock > seq) {
      const bool diag = i == kj;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = r0 + g + 8 * ((e >> 1) & 1), qc = 8 * (e >> 2) + 2 * t + (e & 1);
        if ((diag && key > qc) || q0 + qc >= seq) pt[e] = 0.f;  // causally dead or past seq
      }
    }

    uint32_t pa[16];  // P^T, bf16, as A fragments
    to_a_frags(pt, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) wgmma_rs_mn<D>(dva, pa + 4 * kk, desc_mn(sdo, kk));  // dV += P^T dO
    wgmma_commit();
    // dP^T has landed; at d 128 the dV product is waited for too, which
    // frees P^T's fragments before dS^T's are built
    wgmma_wait<(D == 64 ? 1 : 0)>();
    fence_regs(dpt);
    if constexpr (D != 64) fence_regs(pa);

    // dS^T = P^T (dP^T - delta) scale
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 dl = *reinterpret_cast<const float2*>(sdelta + 8 * nt + 2 * t);
      dpt[4 * nt] = pt[4 * nt] * (dpt[4 * nt] - dl.x) * scale;
      dpt[4 * nt + 1] = pt[4 * nt + 1] * (dpt[4 * nt + 1] - dl.y) * scale;
      dpt[4 * nt + 2] = pt[4 * nt + 2] * (dpt[4 * nt + 2] - dl.x) * scale;
      dpt[4 * nt + 3] = pt[4 * nt + 3] * (dpt[4 * nt + 3] - dl.y) * scale;
    }
    uint32_t dsa[16];
    to_a_frags(dpt, dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) wgmma_rs_mn<D>(dka, dsa + 4 * kk, desc_mn(sq, kk));  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    if constexpr (D == 64) fence_regs(pa);
    fence_regs(dsa);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + r0 + g + 8 * h;
    if (row >= seq) continue;
    bf16* ok = dk + base + (int64_t)row * D + 2 * t;
    bf16* ov = dv + base + (int64_t)row * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      store2(ok + 8 * nt, dka[4 * nt + 2 * h], dka[4 * nt + 2 * h + 1]);
      store2(ov + 8 * nt, dva[4 * nt + 2 * h], dva[4 * nt + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// dynamic shared memory of a kernel (kind 0 = K3, 1 = K4, 2 = K5).
// The wgmma kernels: their swizzled bf16 (64, D) tiles (K3 Q and two stages
// of K and V; K4 Q, dO and two stages of K and V; K5 K, V and two stages of
// Q and dO), K5's two stages of lse and delta rows, and 1024 bytes to align
// the tiles.
constexpr size_t wgmma_smem_bytes(int kind, int d) {
  const size_t tile = kBlock * d * sizeof(bf16);
  return kind == 0 ? 5 * tile + 1024 : kind == 1 ? 6 * tile + 1024 : 6 * tile + 2 * 2 * kBlock * sizeof(float) + 1024;
}
// The first design's kernels: their padded (64, D) tiles, their (64, 64)
// P/dS tiles and K5's lse/delta rows.
constexpr size_t padded_smem_bytes(int kind, int d, size_t esize) {
  return kind == 0   ? kBlock * (3 * (d + kPad) + kLdp) * esize
         : kind == 1 ? kBlock * (4 * (d + kPad) + kLdp) * esize
                     : kBlock * (4 * (d + kPad) + 2 * kLdp) * esize + 2 * kBlock * sizeof(float);
}
// what a launch requests: the wgmma kernels run bf16, the first design fp32
constexpr size_t smem_bytes(int kind, int d, size_t esize) {
  return esize == sizeof(bf16) ? wgmma_smem_bytes(kind, d) : padded_smem_bytes(kind, d, esize);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
                       int seq, float scale, cudaStream_t st) {
  const int tiles = (seq + kBlock - 1) / kBlock;
  cudaError_t err;
  if constexpr (kIsF32<T>) {
    auto kernel = flash_fwd_kernel<T, D>;
    const size_t smem = padded_smem_bytes(0, D, sizeof(T));
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(bh, tiles), kThreads, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(out),
                                         static_cast<float*>(lse), seq, scale);
  } else {
    auto kernel = flash_fwd_kernel_wgmma<D>;
    const size_t smem = wgmma_smem_bytes(0, D);
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)bh * tiles, kThreads, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(out),
                                         static_cast<float*>(lse), seq, scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int seq, float scale,
                      cudaStream_t st) {
  const int tiles = (seq + kBlock - 1) / kBlock;
  cudaError_t err;
  if constexpr (kIsF32<T>) {
    auto kernel = flash_bwd_dq_kernel<T, D>;
    const size_t smem = padded_smem_bytes(1, D, sizeof(T));
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(bh, tiles), kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq), seq, scale);
  } else {
    auto kernel = flash_bwd_dq_kernel_wgmma<D>;
    const size_t smem = wgmma_smem_bytes(1, D);
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)bh * tiles, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq), seq, scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int seq,
                       float scale, cudaStream_t st) {
  const int tiles = (seq + kBlock - 1) / kBlock;
  cudaError_t err;
  if constexpr (kIsF32<T>) {
    auto kernel = flash_bwd_dkv_kernel<T, D>;
    const size_t smem = padded_smem_bytes(2, D, sizeof(T));
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(bh, tiles), kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), seq, scale);
  } else {
    auto kernel = flash_bwd_dkv_kernel_wgmma<D>;
    const size_t smem = wgmma_smem_bytes(2, D);
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)bh * tiles, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), seq, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Each returns the
// launch's cudaGetLastError() (cudaErrorInvalidValue for a dtype or head_dim
// not compiled here). The wrapper checks shapes and skips empty inputs.
#define RT_DISPATCH(CALL)                                                  \
  if (dtype == 0 && head_dim == 64) return static_cast<int>(CALL(float, 64));           \
  if (dtype == 0 && head_dim == 128) return static_cast<int>(CALL(float, 128));         \
  if (dtype == 1 && head_dim == 64) return static_cast<int>(CALL(__nv_bfloat16, 64));   \
  if (dtype == 1 && head_dim == 128) return static_cast<int>(CALL(__nv_bfloat16, 128)); \
  return static_cast<int>(cudaErrorInvalidValue)

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         int bh, int seq, int head_dim, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_FWD(T, D) launch_fwd<T, D>(q, k, v, out, lse, bh, seq, scale, st)
  RT_DISPATCH(RT_FWD);
#undef RT_FWD
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int seq,
                            int head_dim, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_DQ(T, D) launch_dq<T, D>(q, k, v, dout, lse, delta, dq, bh, seq, scale, st)
  RT_DISPATCH(RT_DQ);
#undef RT_DQ
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int seq, int head_dim, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_DKV(T, D) launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, st)
  RT_DISPATCH(RT_DKV);
#undef RT_DKV
}
#undef RT_DISPATCH

// the dynamic shared memory the launches above request, in bytes (kind 0 =
// flash_fwd, 1 = flash_bwd_dq, 2 = flash_bwd_dkv); -1 for an argument not
// compiled here
extern "C" int flash_smem(int kind, int head_dim, int dtype) {
  if (kind < 0 || kind > 2 || (head_dim != 64 && head_dim != 128) || (dtype != 0 && dtype != 1))
    return -1;
  return static_cast<int>(smem_bytes(kind, head_dim, dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16)));
}
