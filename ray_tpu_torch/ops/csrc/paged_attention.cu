// Paged decode attention for Hopper (sm_90a): one query per slot against
// that slot's paged KV cache.
//
// Replaces ray_tpu/ops/paged_attention.py::_paged_kernel (launched by
// _paged_pallas). Same contract as the plain PyTorch version
// ray_tpu_torch/ops/paged_attention.py::paged_attention_torch:
//   q        (slots, heads, D)                      fp32 or bf16
//   k/v_pool (num_blocks, heads, block_size, D)     same dtype, one layer
//   tables   (slots, tmax) int32, lengths (slots,) int32
//   out      (slots, heads, D)                      q's dtype
// Positions >= lengths[s] are masked; softmax and accumulation are fp32; a
// slot with length 0 writes zeros (finite, never NaN). The wrapper also
// hands in fp32 scratch (slots, heads, splits, D + 2) for the partial
// states (below); the kernels allocate nothing.
//
// What bounds it: memory bytes. Each (slot, head) reads its live K and V
// rows once and does 4*D flops per row, far below the card's ~295 flops
// per byte. At 8 slots x 1024 context, 16 heads, D=256 in bf16, K+V is
// 134.2 MB per layer call: about 40 us at 3.35 TB/s, against 0.13 GFLOP;
// at GPT's 12 heads of 64 it is 25.2 MB, about 7.5 us, where the start of
// the CTAs and the merge tail weigh more. Reaching it needs many bytes in
// flight on every SM at once.
//
// Design: split context, then merge (flash-decoding). The TPU kernel walks
// a slot's blocks in grid order with the online-softmax state carried in
// VMEM scratch. That walk as a loop in one CTA per (head, slot) gives 128
// CTAs for 132 SMs at 8 slots, too few bytes in flight to near the bound,
// so the walk is cut into pieces. One kernel, paged_decode_split_kernel,
// grid (splits, heads, slots):
//   - Each CTA takes pages_per_split consecutive table entries of one
//     (slot, head), split_tokens = pages_per_split * block_size positions
//     (128 at GPT-J's block 16: 1024 CTAs with a live position at 8 slots x
//     1024, ~7.8 per SM). The wrapper sizes the grid from tmax, a host-known
//     shape, so it never reads a length on the host and the launch shape is
//     fixed; a CTA whose split starts at or past its slot's length exits at
//     once.
//   - A (block, head) page of the pool is block_size x D contiguous
//     elements (8 KB in bf16 at 16 x 256, 2 KB at 16 x 64). One thread
//     brings each K page and V page into shared memory with one 1-D bulk
//     copy (cp.async.bulk, no tensor map) into a ring of kRingBytes (two
//     page pairs at D 256, the whole 8-page split in bf16 at 16 x 64), each
//     stage completing on its own mbarrier, so the next pages
//     are in flight while the warps compute on the landed one, and five
//     CTAs fit on an SM. The split's table entries are read once, clamped to
//     [0, num_blocks) as the reference's XLA gather clamps a bad entry.
//   - Warp w takes kUnroll consecutive tokens of each page. A row is read
//     by kLanes lanes, each owning D/kLanes consecutive elements loaded four
//     at a time (one 8-byte bf16 or 16-byte fp32 vector): at D 128 and 256
//     the whole warp reads one row (kLanes 32, five shuffles reduce a
//     score); at GPT's D 64 each half-warp reads its own row (kLanes 16,
//     four shuffles within the half), so a warp takes its two tokens at
//     once and every load is a full vector. Each group of kLanes lanes keeps
//     its own (max, sum, acc) online-softmax state in registers; the groups
//     merge through shared memory and the CTA writes its partial (acc, m, l)
//     in fp32 to scratch.
//   - The merge: every CTA then takes a ticket from its (slot, head)'s
//     counter; the last of the live splits to finish combines them all
//     into out and sets the counter back to zero, so the wrapper zeroes a
//     stream's counters once, not per call (its scratch too is allocated
//     once per stream). The merge thus runs inside the
//     kernel's own tail, not as a second launch. Splits past the length are
//     never read, and an empty slot's first split writes zeros.
//   - The bulk copies tag their lines evict-first in L2: the pages are
//     read once.
// chip_flash_probe.py times the split size, the ring size, the warp
// shape, cp.async in place of the bulk copies, the L2 hint, and a merge
// kernel or a memset of the tickets per call, in turns (PERF.md).
// Every pool offset is 64-bit (a full-width pool has more than 2^31
// elements). The launcher itself refuses a page over kMaxPageBytes and a
// pool off a 16-byte boundary (the bulk copies need it), so the wrapper
// spends no host time per call on either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 2;                // consecutive tokens of a page per warp
constexpr int kRingBytes = 32 * 1024;     // shared memory of a CTA's page ring
constexpr int kMaxStages = 8;
constexpr int kMaxPageBytes = 32 * 1024;  // two stages of the largest page: 128 KB of ring
constexpr float kNegInf = -1e30f;

// Four consecutive elements of T, loaded as one vector and widened to fp32.
template <typename T>
struct Quad;

template <>
struct Quad<float> {
  using V = float4;
  static __device__ __forceinline__ void widen(const V& v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ float narrow(float x) { return x; }
};

template <>
struct Quad<__nv_bfloat16> {
  using V = uint2;
  static __device__ __forceinline__ void widen(const V& v, float* o) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
    const float2 a = __bfloat1622float2(p[0]);
    const float2 b = __bfloat1622float2(p[1]);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float x) { return __float2bfloat16(x); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// the barrier's current phase completes when its arrivals are in and the
// announced bytes have landed
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait for the completion of the barrier's phase of this parity; a phase
// that never completes (a copy that never lands) traps, failing the launch,
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}
// an L2 policy that evicts the lines it tags first: the pages are read
// once, so they should not push out what is read again (the partials, the
// tables)
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
// global -> shared, bytes a multiple of 16 at 16-byte-aligned addresses,
// completing on the barrier, its lines tagged with the L2 policy
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], "
      "%4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}
// Page pair i of the split (K then V, page_elems each) into ring stage
// i % stages, completing on that stage's barrier: thread 0 announces both
// pages' bytes and issues one bulk copy each. Every thread calls it.
template <typename T>
__device__ __forceinline__ void load_page(int i, int stages, const int* phys, const T* __restrict__ k_pool,
                                          const T* __restrict__ v_pool, int64_t block_stride,
                                          int64_t head_off, int page_elems, T* ring,
                                          const uint64_t* bars) {
  const int st = i % stages;
  const int64_t src = (int64_t)phys[i] * block_stride + head_off;
  const uint32_t dst = smem_addr(ring + (int64_t)2 * st * page_elems);
  const uint32_t bar = smem_addr(bars + st);
  const uint32_t bytes = page_elems * sizeof(T);
  if (threadIdx.x == 0) {
    const uint64_t policy = evict_first_policy();
    mbar_expect_tx(bar, 2 * bytes);
    bulk_copy(dst, k_pool + src, bytes, bar, policy);
    bulk_copy(dst + bytes, v_pool + src, bytes, bar, policy);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool, const int* __restrict__ tables,
                          const int* __restrict__ lengths, float* __restrict__ scratch,
                          int* __restrict__ tickets, T* __restrict__ out, int heads, int num_blocks,
                          int block_size, int tmax, int pages_per_split, int stages, float scale) {
  constexpr int kLanes = D >= 128 ? 32 : D / 4;  // lanes that read one row
  constexpr int kRows = 32 / kLanes;             // rows a warp reads at once
  constexpr int kPerLane = D / kLanes;           // elements of a row each lane owns
  constexpr int kQuads = kPerLane / 4;           // vector loads per lane per row
  constexpr int kSteps = kUnroll / kRows;        // passes over a warp's kUnroll tokens
  constexpr int kGroups = kWarps * kRows;        // lane groups, each with its own softmax state
  static_assert(D % 4 == 0 && kLanes * kPerLane == D && kQuads * 4 == kPerLane, "row layout");
  static_assert(kRows * kSteps == kUnroll, "a warp's tokens split evenly over its rows");
  using Q = Quad<T>;
  using V = typename Q::V;

  const int split = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = lane / kLanes;  // which of the warp's kRows rows this lane reads
  const int col = lane % kLanes;  // which kPerLane elements of it
  const int group = warp * kRows + row;
  const int length = max(0, min(lengths[s], tmax * block_size));
  const int tok0 = split * pages_per_split * block_size;
  if (tok0 >= length) {  // no live position: the merge skips this split
    if (length == 0 && split == 0) {  // an empty slot writes zeros
      for (int d = threadIdx.x; d < D; d += kThreads) out[((int64_t)s * heads + h) * D + d] = Q::narrow(0.f);
    }
    return;
  }
  const int n_pages = min(pages_per_split, (length - tok0 + block_size - 1) / block_size);

  // shared memory: the ring (stages x (K page, V page)), a barrier per
  // stage, then the split's physical block ids
  extern __shared__ __align__(128) unsigned char smem[];
  const int page_elems = block_size * D;
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)2 * stages * page_elems * sizeof(T));
  int* phys = reinterpret_cast<int*>(bars + kMaxStages);
  const int64_t head_stride = (int64_t)block_size * D;
  const int64_t block_stride = (int64_t)heads * head_stride;
  const int64_t head_off = (int64_t)h * head_stride;

  const int* table = tables + (int64_t)s * tmax + split * pages_per_split;
  for (int i = threadIdx.x; i < n_pages; i += kThreads) phys[i] = min(max(table[i], 0), num_blocks - 1);
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(smem_addr(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = 0; i < min(stages, n_pages); ++i)
    load_page(i, stages, phys, k_pool, v_pool, block_stride, head_off, page_elems, ring, bars);

  float qv[kPerLane];
  {
    const V* qp = reinterpret_cast<const V*>(q + ((int64_t)s * heads + h) * D + col * kPerLane);
#pragma unroll
    for (int c = 0; c < kQuads; ++c) Q::widen(qp[c], qv + 4 * c);
  }

  float m = kNegInf;
  float l = 0.f;
  float acc[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) acc[e] = 0.f;

  for (int i = 0; i < n_pages; ++i) {
    const int st = i % stages;
    mbar_wait(smem_addr(bars + st), (i / stages) & 1);
    const T* kp = ring + (int64_t)2 * st * page_elems;
    const T* vp = kp + page_elems;
    const int live = min(block_size, length - (tok0 + i * block_size));  // live tokens of the page
    // the loop bound is uniform across the warp, so every lane reaches the
    // shuffles; token base + u * kRows + row is this lane's at step u
    for (int base = warp * kUnroll; base < live; base += kWarps * kUnroll) {
      float score[kSteps];
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int t = base + u * kRows + row;
        float dot = 0.f;
        if (t < live) {
          const V* kr = reinterpret_cast<const V*>(kp + t * D + col * kPerLane);
#pragma unroll
          for (int c = 0; c < kQuads; ++c) {
            float kf[4];
            Q::widen(kr[c], kf);
#pragma unroll
            for (int e = 0; e < 4; ++e) dot += qv[4 * c + e] * kf[e];
          }
        }
        score[u] = dot;
      }
      // reduce within each group of kLanes lanes (the whole warp, or a half)
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kSteps; ++u) score[u] += __shfl_xor_sync(0xffffffffu, score[u], off);
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        score[u] = base + u * kRows + row < live ? score[u] * scale : kNegInf;
        m_new = fmaxf(m_new, score[u]);
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int t = base + u * kRows + row;
        if (t < live) {
          const float p = expf(score[u] - m_new);
          l += p;
          const V* vr = reinterpret_cast<const V*>(vp + t * D + col * kPerLane);
#pragma unroll
          for (int c = 0; c < kQuads; ++c) {
            float vf[4];
            Q::widen(vr[c], vf);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[4 * c + e] += p * vf[e];
          }
        }
      }
      m = m_new;
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
    if (i + stages < n_pages)
      load_page(i + stages, stages, phys, k_pool, v_pool, block_stride, head_off, page_elems, ring, bars);
  }

  // merge the groups' online-softmax states into the split's partial
  __shared__ float sm_m[kGroups];
  __shared__ float sm_l[kGroups];
  __shared__ float sm_acc[kGroups][D];
  if (col == 0) {
    sm_m[group] = m;
    sm_l[group] = l;
  }
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) sm_acc[group][col * kPerLane + e] = acc[e];
  __syncthreads();

  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kGroups; ++w) mx = fmaxf(mx, sm_m[w]);
  float wgt[kGroups];
  float denom = 0.f;
#pragma unroll
  for (int w = 0; w < kGroups; ++w) {
    wgt[w] = expf(sm_m[w] - mx);  // 0 for a group that saw no live token
    denom += sm_l[w] * wgt[w];
  }
  float* parts = scratch + ((int64_t)s * heads + h) * gridDim.x * (D + 2);  // this (slot, head)'s
  float* part = parts + split * (D + 2);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kGroups; ++w) x += sm_acc[w][d] * wgt[w];
    part[d] = x;
  }
  if (threadIdx.x == 0) {
    part[D] = mx;
    part[D + 1] = denom;
  }

  // The last of the (slot, head)'s live splits to finish merges them all:
  // each CTA makes its partial visible, then takes a ticket.
  __shared__ bool sm_last;
  const int live_splits = (length + pages_per_split * block_size - 1) / (pages_per_split * block_size);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sm_last = atomicAdd(tickets + (int64_t)s * heads + h, 1) == live_splits - 1;
  __syncthreads();
  if (!sm_last) return;
  if (threadIdx.x == 0) tickets[(int64_t)s * heads + h] = 0;  // every live split has taken its ticket
  __threadfence();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float m_all = kNegInf;
    for (int i = 0; i < live_splits; ++i) m_all = fmaxf(m_all, __ldcg(parts + i * (D + 2) + D));
    float num = 0.f, den = 0.f;
    for (int i = 0; i < live_splits; ++i) {
      const float w = expf(__ldcg(parts + i * (D + 2) + D) - m_all);
      num += __ldcg(parts + i * (D + 2) + d) * w;
      den += __ldcg(parts + i * (D + 2) + D + 1) * w;
    }
    out[((int64_t)s * heads + h) * D + d] = Q::narrow(num / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                   const void* lengths, void* out, void* scratch, void* tickets, int slots, int heads,
                   int num_blocks, int block_size, int tmax, int pages_per_split, float scale,
                   cudaStream_t stream) {
  const int page_bytes = block_size * D * (int)sizeof(T);
  if (page_bytes > kMaxPageBytes) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(k_pool) % 16 || reinterpret_cast<uintptr_t>(v_pool) % 16)
    return cudaErrorMisalignedAddress;
  const int splits = (tmax + pages_per_split - 1) / pages_per_split;
  const int stages = std::max(2, std::min({kMaxStages, pages_per_split, kRingBytes / (2 * page_bytes)}));
  const size_t smem = (size_t)2 * stages * page_bytes + kMaxStages * sizeof(uint64_t) +
                      pages_per_split * sizeof(int);
  auto kernel = paged_decode_split_kernel<T, D>;
  // always: beside the static shared memory, even a ring under 48 KB can
  // pass the default limit
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(std::max(splits, 1), heads, slots), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), static_cast<float*>(scratch),
      static_cast<int*>(tickets), static_cast<T*>(out), heads, num_blocks, block_size, tmax,
      pages_per_split, stages, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. scratch: fp32 (slots, heads,
// ceil(tmax / pages_per_split), head_dim + 2); tickets: int32 (slots,
// heads), zeros, and zeros again when the launch ends (each merging CTA
// resets its own). Returns cudaGetLastError() after the launch, or without
// launching cudaErrorInvalidValue for a dtype or head_dim not compiled here
// or a (block, head) page over kMaxPageBytes, cudaErrorMisalignedAddress
// for a pool off a 16-byte boundary.
extern "C" int paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* tables, const void* lengths, void* out,
                                      void* scratch, void* tickets, int slots, int heads, int head_dim,
                                      int num_blocks, int block_size, int tmax,
                                      int pages_per_split, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_LAUNCH(T, D)                                                                     \
  launch<T, D>(q, k_pool, v_pool, tables, lengths, out, scratch, tickets, slots, heads, num_blocks, \
               block_size, tmax, pages_per_split, scale, st)
  // GPT's 64, 128, and GPT-J's 256
  if (dtype == 0 && head_dim == 64) return static_cast<int>(RT_LAUNCH(float, 64));
  if (dtype == 1 && head_dim == 64) return static_cast<int>(RT_LAUNCH(__nv_bfloat16, 64));
  if (dtype == 0 && head_dim == 128) return static_cast<int>(RT_LAUNCH(float, 128));
  if (dtype == 1 && head_dim == 128) return static_cast<int>(RT_LAUNCH(__nv_bfloat16, 128));
  if (dtype == 0 && head_dim == 256) return static_cast<int>(RT_LAUNCH(float, 256));
  if (dtype == 1 && head_dim == 256) return static_cast<int>(RT_LAUNCH(__nv_bfloat16, 256));
#undef RT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
