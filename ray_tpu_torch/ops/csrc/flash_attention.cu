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
// K4 its operations (83.8 GFLOP = 0.0847 ms at 989 TFLOP/s), K5 its
// operations (111.7 GFLOP = 0.1129 ms). All three sit near the card's ridge,
// so a fast version needs both the tensor cores and overlapped loads.
//
// Design: the TPU grid's sequential minor axis becomes a loop inside one CTA.
// Tiles are 64 rows on both sides; a CTA has 4 warps, each owning 16 rows of
// the CTA's own tile, so the online-softmax state and the accumulators of a
// row live in registers of one warp (the mma.sync m16n8 accumulator layout:
// lane g*4+t holds rows g and g+8, columns 2t and 2t+1 of each 8-column
// slice), and row reductions are two quad shuffles.
//   K3, K4: one CTA per (bh, Q tile), looping over the KV tiles up to the
//   diagonal; only the diagonal tile is masked.
//   K5: one CTA per (bh, KV tile), looping over the Q tiles from the diagonal
//   (i_first in the reference) to the end; it computes S^T = K Q^T so the
//   row-owned layout holds the tile's keys, and writes dK and dV once, with
//   no atomics.
// Products: in bf16, mma.sync m16n8k16 with fp32 accumulation, the operand
// fragments read from padded shared memory (8 elements of padding per row
// spread a fragment's rows over the banks); P and dS are rounded to bf16
// before the second product of a kernel, as tensor cores require. In fp32,
// plain fp32 FMA chains (no TF32), so the fp32 results differ from the plain
// version by summation order only. Tiles are loaded synchronously with
// 16-byte vector loads; rows past seq load as zeros, are masked (keys past a
// valid query are causally dead; queries past seq are masked explicitly in
// K5) and are never written. Offsets into (bh, seq, D) tensors are 64-bit.
// Not done yet (later PRs): cp.async/TMA double buffering, ldmatrix, wgmma
// and warp specialisation.

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

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
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
// K4: dQ. Grid (bh, Q tiles); the longest rows first.
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
// launches
// ---------------------------------------------------------------------------

// dynamic shared memory of a kernel (kind 0 = K3, 1 = K4, 2 = K5): its
// padded (64, D) tiles, its (64, 64) P/dS tiles and K5's lse/delta rows
constexpr size_t smem_bytes(int kind, int d, size_t esize) {
  return kind == 0   ? kBlock * (3 * (d + kPad) + kLdp) * esize
         : kind == 1 ? kBlock * (4 * (d + kPad) + kLdp) * esize
                     : kBlock * (4 * (d + kPad) + 2 * kLdp) * esize + 2 * kBlock * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
                       int seq, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(0, D, sizeof(T));
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), static_cast<T*>(out),
                                       static_cast<float*>(lse), seq, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int seq, float scale,
                      cudaStream_t st) {
  const size_t smem = smem_bytes(1, D, sizeof(T));
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), seq, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int seq,
                       float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(2, D, sizeof(T));
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), seq, scale);
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
