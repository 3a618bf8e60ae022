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
// slot with length 0 writes zeros (finite, never NaN).
//
// What bounds it: memory bytes. Each (slot, head) reads its live K and V
// rows once and does 4*D flops per row, far below the card's ~295 flops
// per byte. At 8 slots x 1024 context, 16 heads, D=256 in bf16, K+V is
// 134.2 MB per layer call: about 40 us at 3.35 TB/s, against 0.13 GFLOP.
//
// Design: one CTA per (head, slot), kWarps warps. The TPU kernel walks the
// slot's logical blocks in grid order with the online-softmax state carried
// in VMEM scratch; here blocks run in parallel, so the sequential walk
// becomes a loop inside the CTA. Warp w takes tokens [w*kUnroll,
// (w+1)*kUnroll), then steps by kWarps*kUnroll. A token's K (or V) row of D
// elements is read by the whole warp, each lane loading D/32 consecutive
// elements as 4-element vectors, so neighbouring lanes read neighbouring
// addresses. Each warp keeps kUnroll tokens' K and V loads in flight before
// it uses them, keeps its own (max, sum, acc) online-softmax state in
// registers, and the warps merge through shared memory at the end. Only the
// ceil(length/block_size) live table entries are read, and every pool
// offset is 64-bit (a full-width pool has more than 2^31 elements).
// Split-context parallelism, TMA and cp.async pipelining are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
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

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int heads,
                    int num_blocks, int block_size, int tmax, float scale) {
  constexpr int kPerLane = D / 32;       // elements of a row each lane owns
  constexpr int kQuads = kPerLane / 4;   // vector loads per lane per row
  using Q = Quad<T>;
  using V = typename Q::V;

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int length = max(0, min(lengths[s], tmax * block_size));

  float qv[kPerLane];
  {
    const V* qp = reinterpret_cast<const V*>(q + ((int64_t)s * heads + h) * D + lane * kPerLane);
#pragma unroll
    for (int c = 0; c < kQuads; ++c) Q::widen(qp[c], qv + 4 * c);
  }

  const int64_t head_stride = (int64_t)block_size * D;
  const int64_t block_stride = (int64_t)heads * head_stride;
  const int* table = tables + (int64_t)s * tmax;

  float m = kNegInf;
  float l = 0.f;
  float acc[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) acc[e] = 0.f;

  for (int base = warp * kUnroll; base < length; base += kWarps * kUnroll) {
    V kr[kUnroll][kQuads];
    V vr[kUnroll][kQuads];
    // issue every load of the group before any of them is used
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u;
      if (t < length) {
        const int j = t / block_size;
        // the reference's XLA gather clamps indices; a bad table entry
        // reads a wrong block instead of faulting
        const int phys = min(max(table[j], 0), num_blocks - 1);
        const int64_t o = (int64_t)phys * block_stride + (int64_t)h * head_stride +
                          (int64_t)(t - j * block_size) * D + lane * kPerLane;
        const V* kp = reinterpret_cast<const V*>(k_pool + o);
        const V* vp = reinterpret_cast<const V*>(v_pool + o);
#pragma unroll
        for (int c = 0; c < kQuads; ++c) {
          kr[u][c] = kp[c];
          vr[u][c] = vp[c];
        }
      }
    }
    float score[kUnroll];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
      if (base + u < length) {
#pragma unroll
        for (int c = 0; c < kQuads; ++c) {
          float kf[4];
          Q::widen(kr[u][c], kf);
#pragma unroll
          for (int e = 0; e < 4; ++e) dot += qv[4 * c + e] * kf[e];
        }
      }
      // the branch above is uniform across the warp, so every lane joins
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      score[u] = base + u < length ? dot * scale : kNegInf;
      m_new = fmaxf(m_new, score[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u < length) {
        const float p = expf(score[u] - m_new);
        l += p;
#pragma unroll
        for (int c = 0; c < kQuads; ++c) {
          float vf[4];
          Q::widen(vr[u][c], vf);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * c + e] += p * vf[e];
        }
      }
    }
    m = m_new;
  }

  // merge the warps' online-softmax states
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) sm_acc[warp][lane * kPerLane + e] = acc[e];
  __syncthreads();

  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float wgt[kWarps];
  float denom = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wgt[w] = expf(sm_m[w] - mx);
    denom += sm_l[w] * wgt[w];
  }
  const float inv = 1.f / fmaxf(denom, 1e-30f);
  T* o = out + ((int64_t)s * heads + h) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += sm_acc[w][d] * wgt[w];
    o[d] = Q::narrow(x * inv);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
            const void* lengths, void* out, int slots, int heads, int num_blocks,
            int block_size, int tmax, float scale, cudaStream_t stream) {
  const dim3 grid(heads, slots);
  paged_decode_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), static_cast<T*>(out),
      heads, num_blocks, block_size, tmax, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a dtype or head_dim not compiled here).
extern "C" int paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* tables, const void* lengths, void* out,
                                      int slots, int heads, int head_dim, int num_blocks,
                                      int block_size, int tmax, float scale, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_LAUNCH(T, D)                                                                   \
  launch<T, D>(q, k_pool, v_pool, tables, lengths, out, slots, heads, num_blocks,         \
               block_size, tmax, scale, st)
  // GPT-J's head_dim only; another width comes with the model that needs it
  if (dtype == 0 && head_dim == 256) {
    RT_LAUNCH(float, 256);
  } else if (dtype == 1 && head_dim == 256) {
    RT_LAUNCH(__nv_bfloat16, 256);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
