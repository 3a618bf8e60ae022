// Paged verify attention for Hopper (sm_90a): W consecutive queries per slot
// (the speculative-decode window) against that slot's paged KV cache.
//
// Replaces ray_tpu/ops/paged_attention.py::_paged_verify_kernel (launched by
// _paged_verify_pallas). Same contract as the plain PyTorch version
// ray_tpu_torch/ops/paged_attention.py::paged_verify_attention_torch:
//   q         (slots, W, heads, D)                   fp32 or bf16
//   k/v_pool  (num_blocks, heads, block_size, D)     same dtype, one layer
//   tables    (slots, tmax) int32
//   positions (slots, W) int32, consecutive within a slot
//   out       (slots, W, heads, D)                   q's dtype
// Query (s, i) attends every cache position <= positions[s, i]; softmax and
// accumulation are fp32. A query with no live position writes zeros (finite).
//
// What bounds it: memory bytes. The design requirement is that each live K
// and V row is read from HBM once per (slot, head) and used for all W
// queries. At 8 slots, W = 5, 16 heads, D = 256, bf16, with queries at
// positions 1019-1023, K+V is 2*8*1024*16*256*2 B = 134.2 MB, plus 0.66 MB
// of q/out: about 0.040 ms at 3.35 TB/s, the same as the decode kernel at
// the same context. The work is about 0.67 GFLOP, which is negligible.
//
// Design: the decode kernel's (csrc/paged_attention.cu), widened to W
// queries. One CTA per (head, slot), kWarps warps; warp w takes tokens
// [w*kUnroll, (w+1)*kUnroll), then steps by kWarps*kUnroll. Each lane loads
// D/32 consecutive elements of a token's K and V row once, and every lane
// keeps its slice of all W queries and W online-softmax states
// (max, sum, acc) in registers, so one load serves the whole window. The
// causal mask is per query (token t counts for query i iff t <=
// positions[s, i]); the window is consecutive, so the last query's position
// bounds the live tokens, as in the TPU kernel. The live length is also
// bounded by tmax*block_size: a slot one emit away from the length cap
// feeds positions past its table, and those tokens are never read. The
// warps' states merge through shared memory one query at a time at the end
// (a W x kWarps x D buffer would pass the 48 KB static limit at W = 8).
// Table entries are clamped as in the decode kernel, and every pool offset
// is 64-bit. Split-context, cp.async, TMA and tensor-core designs are left
// for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
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

template <typename T, int D, int W>
__global__ void __launch_bounds__(kWarps * 32)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ positions, T* __restrict__ out, int heads,
                    int num_blocks, int block_size, int tmax, float scale) {
  constexpr int kPerLane = D / 32;       // elements of a row each lane owns
  constexpr int kQuads = kPerLane / 4;   // vector loads per lane per row
  // tokens in flight per warp: fewer for wide windows, whose W states
  // already hold 2*W*kPerLane registers per lane (4 tokens spill there).
  // 4 tokens in flight instead of 2 cut the W = 5 time by under a tenth on
  // an H100 (PERF.md), so loads in flight are not what holds it most
  constexpr int kUnroll = W <= 5 ? 4 : 2;
  using Q = Quad<T>;
  using V = typename Q::V;

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  int qpos[W];
#pragma unroll
  for (int i = 0; i < W; ++i) qpos[i] = positions[(int64_t)s * W + i];
  // the window is consecutive: its last query bounds the live tokens
  const int length = max(0, min(qpos[W - 1] + 1, tmax * block_size));

  float qv[W][kPerLane];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const V* qp = reinterpret_cast<const V*>(q + (((int64_t)s * W + i) * heads + h) * D +
                                             lane * kPerLane);
#pragma unroll
    for (int c = 0; c < kQuads; ++c) Q::widen(qp[c], qv[i] + 4 * c);
  }

  const int64_t head_stride = (int64_t)block_size * D;
  const int64_t block_stride = (int64_t)heads * head_stride;
  const int* table = tables + (int64_t)s * tmax;

  float m[W];
  float l[W];
  float acc[W][kPerLane];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) acc[i][e] = 0.f;
  }

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
    float score[kUnroll][W];
    float m_new[W];
#pragma unroll
    for (int i = 0; i < W; ++i) m_new[i] = m[i];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u;
      float dot[W];
#pragma unroll
      for (int i = 0; i < W; ++i) dot[i] = 0.f;
      // t and the positions are the same in every lane: each branch below
      // is uniform across the warp, so every lane joins the shuffles
      if (t < length) {
#pragma unroll
        for (int c = 0; c < kQuads; ++c) {
          float kf[4];
          Q::widen(kr[u][c], kf);
#pragma unroll
          for (int i = 0; i < W; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) dot[i] += qv[i][4 * c + e] * kf[e];
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < W; ++i) dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], off);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        score[u][i] = (t < length && t <= qpos[i]) ? dot[i] * scale : kNegInf;
        m_new[i] = fmaxf(m_new[i], score[u][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float alpha = expf(m[i] - m_new[i]);
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u;
      if (t < length) {
        float p[W];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          // a masked token must add nothing: exp(kNegInf - kNegInf) is 1
          p[i] = t <= qpos[i] ? expf(score[u][i] - m_new[i]) : 0.f;
          l[i] += p[i];
        }
#pragma unroll
        for (int c = 0; c < kQuads; ++c) {
          float vf[4];
          Q::widen(vr[u][c], vf);
#pragma unroll
          for (int i = 0; i < W; ++i) {
            if (t <= qpos[i]) {
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][4 * c + e] += p[i] * vf[e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < W; ++i) m[i] = m_new[i];
  }

  // merge the warps' online-softmax states, one query at a time
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (lane == 0) {
      sm_m[warp] = m[i];
      sm_l[warp] = l[i];
    }
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) sm_acc[warp][lane * kPerLane + e] = acc[i][e];
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
    T* o = out + (((int64_t)s * W + i) * heads + h) * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x += sm_acc[w][d] * wgt[w];
      o[d] = Q::narrow(x * inv);
    }
    __syncthreads();  // the buffer is reused for the next query
  }
}

template <typename T, int D, int W>
void launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
            const void* positions, void* out, int slots, int heads, int num_blocks,
            int block_size, int tmax, float scale, cudaStream_t stream) {
  const dim3 grid(heads, slots);
  paged_verify_kernel<T, D, W><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(positions), static_cast<T*>(out),
      heads, num_blocks, block_size, tmax, scale);
}

template <typename T, int D>
bool launch_window(int window, const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* positions, void* out, int slots, int heads,
                   int num_blocks, int block_size, int tmax, float scale, cudaStream_t stream) {
#define RT_CASE(W)                                                                        \
  case W:                                                                                 \
    launch<T, D, W>(q, k_pool, v_pool, tables, positions, out, slots, heads, num_blocks,  \
                    block_size, tmax, scale, stream);                                     \
    return true
  switch (window) {
    RT_CASE(2);
    RT_CASE(3);
    RT_CASE(4);
    RT_CASE(5);
    RT_CASE(6);
    RT_CASE(7);
    RT_CASE(8);
    default:
      return false;
  }
#undef RT_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a dtype, head_dim or window not
// compiled here: head_dim 256, windows 2-8).
extern "C" int paged_verify_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* tables, const void* positions, void* out,
                                      int slots, int window, int heads, int head_dim,
                                      int num_blocks, int block_size, int tmax, float scale,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  // GPT-J's head_dim only; another width comes with the model that needs it
  if (dtype == 0 && head_dim == 256) {
    ok = launch_window<float, 256>(window, q, k_pool, v_pool, tables, positions, out, slots,
                                   heads, num_blocks, block_size, tmax, scale, st);
  } else if (dtype == 1 && head_dim == 256) {
    ok = launch_window<__nv_bfloat16, 256>(window, q, k_pool, v_pool, tables, positions, out,
                                           slots, heads, num_blocks, block_size, tmax, scale,
                                           st);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
