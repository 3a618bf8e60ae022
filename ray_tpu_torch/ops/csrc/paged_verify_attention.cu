// Paged verify attention for Hopper (sm_90a): W consecutive queries per slot
// (the speculative-decode window) against that slot's paged KV cache.
//
// Replaces ray_tpu/ops/paged_attention.py::_paged_verify_kernel (launched by
// _paged_verify_pallas). Same contract as the plain PyTorch version
// ray_tpu_torch/ops/paged_attention.py::paged_verify_attention_torch:
//   q         (slots, W, heads, D)                   fp32 or bf16, D 64, 128 or 256
//   k/v_pool  (num_blocks, heads, block_size, D)     same dtype, one layer
//   tables    (slots, tmax) int32
//   positions (slots, W) int32, consecutive within a slot; any W >= 1
//   out       (slots, W, heads, D)                   q's dtype
// Query (s, i) attends every cache position <= positions[s, i]; softmax and
// accumulation are fp32. The live length of a slot is min(positions[s, W-1]
// + 1, tmax * block_size). The wrapper also hands in fp32 scratch (slots,
// heads, splits, W, D + 2) for the split partials and int32 merge tickets
// (slots, heads); the kernel allocates nothing.
//
// What bounds it: memory bytes. Each (slot, head) must read its live K and V
// rows once and use them for all W queries. At 8 slots, W = 5 at positions
// 1019-1023, 16 heads, D = 256, bf16 that is 134.2 MB of K/V plus 0.66 MB of
// q and out: 0.0403 ms at 3.35 TB/s, the same bytes as the decode kernel at
// the same context, against 0.67 GFLOP. The first design (one CTA per (head,
// slot), W online softmaxes per lane on the FMA pipes) took 2.9x that, and
// its time grew with W: too few CTAs in flight, and per-query arithmetic.
//
// Design: the decode kernel's split context (csrc/paged_attention.cu), with
// the window scored on the tensor cores. One kernel, grid (splits, heads,
// slots), sized from the table width (no length read on the host):
//   - A CTA takes pages_per_split consecutive table entries of one (slot,
//     head); a CTA whose split starts at or past the slot's live length exits
//     at once. Its pages come through a ring of shared-memory stages, each
//     completing on its own mbarrier. A page's rows are brought in by bulk
//     copies (cp.async.bulk) issued by the lanes of warp 0, one per K or V
//     row, each row followed by 16 bytes of padding: with rows 528 bytes
//     apart (bf16, D 256) the eight rows an ldmatrix reads fall on eight
//     different bank groups, where a contiguous page (K1's one copy per
//     page) puts them all on the same banks. Table entries are clamped to
//     [0, num_blocks) as the reference's XLA gather clamps a bad entry.
//   - Four warps. The queries are the M side of mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate): a tile of 16 query rows (rows past W are masked) and
//     chunks of 16 cached tokens. Warp w owns columns [w D/4, (w+1) D/4) of
//     the head dim: it computes that slice of S = Q K^T for the chunk (its Q
//     fragments stay in registers), the four slices are summed through
//     shared memory in the same order by every warp (one __syncthreads per
//     chunk, and one per page before its stage is refilled), and each warp then runs
//     the same online softmax (log2 units, masked per query by its own
//     position) on the whole 16 x 16 score. P stays in registers: two
//     adjacent 8-column slices of the m16n8 accumulator are one k16 A
//     fragment. P is rounded to bf16, and O += P V covers the warp's own
//     columns of O, V fragments through ldmatrix.trans. K and V thus come
//     from shared memory once per chunk, whatever W is.
//   - The window is taken at run time: a CTA walks its pages once for each
//     group of QT query tiles (QT = 1 for W <= 16, 2 up to W = 32), so every
//     K/V byte is read once per (slot, head) up to W = 32; wider windows walk
//     the split again for each further 32 queries.
//   - fp32 runs the same skeleton with FMA chains in the same fragment
//     layout (Q and P through shared memory): no fp32 form of the tensor
//     cores, and TF32 would miss the fp32 tolerance.
//   - Every CTA writes its fp32 partial (acc, m, l) for every query of the
//     window; the last of the (slot, head)'s live splits to take a ticket
//     merges them into out and sets the ticket back to zero, as in K1.
// chip_flash_probe.py times the split size, the ring size, the row
// padding, whole-page copies and the first design in turns (PERF.md). On an
// H100 at 8 slots, W 5 at positions 1019-1023: 0.063 ms, 1.56x the bound;
// unpadded rows cost 20%, K1's two copies a page into unpadded rows 4%, a
// 64 KB ring (fewer CTAs an SM) 37%; 256-position splits are 27% slower at
// the verify step's context (~548), where they leave too few CTAs. Every pool offset is 64-bit. The launcher itself
// refuses a page over kMaxPageBytes and a pool off a 16-byte boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kWarps = 4;                 // each owns D/4 columns of the head dim
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;                 // query rows of a tile; cached tokens of a chunk
constexpr int kRowPad = 16;               // bytes of padding after each cached row
constexpr int kRingBytes = 32 * 1024;     // shared memory of a CTA's page ring
constexpr int kMaxStages = 8;
constexpr int kMaxPageBytes = 32 * 1024;  // a (block, head) page, as in K1
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

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
// an L2 policy that evicts the lines it tags first: the pages are read once
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c += a b for one m16n8k16 product, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two fp32 values as one bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// Where a CTA's pages sit in its ring. A stage holds a K page and then a V
// page of rows_pad rows each (block_size rounded up to whole chunks), rows
// `stride` bytes apart (the row's bytes and kRowPad).
struct Ring {
  unsigned char* base;
  const uint64_t* bars;
  int stages, stride, v_off, stage_bytes;
};

// Walk step idx (page idx % n_pages of the split) into ring stage idx %
// stages: lane 0 of warp 0 announces the page pair's bytes on the stage's
// barrier, then the lanes of warp 0 copy one row each, K rows then V rows.
// Every thread calls it.
template <typename T, int D>
__device__ __forceinline__ void load_page(int idx, int n_pages, const int* phys, const T* __restrict__ k_pool,
                                          const T* __restrict__ v_pool, int64_t block_stride, int64_t head_off,
                                          int block_size, const Ring& ring) {
  if (threadIdx.x >= 32) return;
  constexpr uint32_t kRow = D * sizeof(T);
  const int st = idx % ring.stages;
  const uint32_t bar = smem_addr(ring.bars + st);
  const uint32_t dst = smem_addr(ring.base + (size_t)st * ring.stage_bytes);
  const int64_t src = (int64_t)phys[idx % n_pages] * block_stride + head_off;
  if (threadIdx.x == 0) mbar_expect_tx(bar, 2 * block_size * kRow);
  __syncwarp();
  const uint64_t policy = evict_first_policy();
  for (int r = threadIdx.x; r < 2 * block_size; r += 32) {
    const bool is_v = r >= block_size;
    const int row = is_v ? r - block_size : r;
    bulk_copy(dst + (is_v ? ring.v_off : 0) + row * ring.stride, (is_v ? v_pool : k_pool) + src + (int64_t)row * D,
              kRow, bar, policy);
  }
}

template <typename T, int D, int QT>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
                    const int* __restrict__ tables, const int* __restrict__ positions,
                    float* __restrict__ scratch, int* __restrict__ tickets, T* __restrict__ out, int window,
                    int heads, int num_blocks, int block_size, int tmax, int pages_per_split, int stages,
                    float scale) {
  constexpr int DW = D / kWarps;  // head-dim columns a warp owns
  constexpr int KS = DW / 16;     // k16 steps of a warp's slice of S
  constexpr int NT = DW / 8;      // n8 tiles of a warp's slice of O
  static_assert(DW % 16 == 0, "head_dim must be a multiple of 64");

  const int split = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int* pos_s = positions + (int64_t)s * window;
  // the window is consecutive: its last query bounds the live tokens
  const int length = max(0, min(pos_s[window - 1] + 1, tmax * block_size));
  const int split_tokens = pages_per_split * block_size;
  const int tok0 = split * split_tokens;
  const int64_t row_stride = (int64_t)heads * D;  // between queries of a slot in q and out
  if (tok0 >= length) {  // no live position: the merge skips this split
    if (length == 0 && split == 0) {  // an empty slot writes zeros
      for (int e = threadIdx.x; e < window * D; e += kThreads)
        out[((int64_t)s * window + e / D) * row_stride + (int64_t)h * D + e % D] = from_float<T>(0.f);
    }
    return;
  }
  const int n_pages = min(pages_per_split, (length - tok0 + block_size - 1) / block_size);
  const int passes = ((window + kTile - 1) / kTile + QT - 1) / QT;

  // shared memory: the ring, the score exchange [2][kWarps][QT][8][32], for
  // fp32 the pass's Q tiles [QT][16][D] and each warp's P [kWarps][QT][16][16],
  // a barrier per stage, the split's physical block ids
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring;
  ring.base = smem;
  ring.stages = stages;
  ring.stride = D * (int)sizeof(T) + kRowPad;
  ring.v_off = (block_size + kTile - 1) / kTile * kTile * ring.stride;
  ring.stage_bytes = 2 * ring.v_off;
  float* xch = reinterpret_cast<float*>(smem + (size_t)stages * ring.stage_bytes);
  float* qs = xch + 2 * kWarps * QT * 8 * 32;
  float* ps = qs + (kIsF32<T> ? QT * kTile * D : 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ps + (kIsF32<T> ? kWarps * QT * kTile * kTile : 0));
  int* phys = reinterpret_cast<int*>(bars + kMaxStages);
  ring.bars = bars;
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
  const int walk = passes * n_pages;  // the split's pages, once per pass
  for (int i = 0; i < min(stages, walk); ++i)
    load_page<T, D>(i, n_pages, phys, k_pool, v_pool, block_stride, head_off, block_size, ring);

  const float scale_log2 = scale * kLog2e;
  const int col0 = warp * DW;  // the warp's first head-dim column
  float* part_base = scratch + (((int64_t)s * heads + h) * gridDim.x + split) * window * (D + 2);
  int chunk = 0;  // chunks walked: the exchange buffer's parity

  for (int pass = 0; pass < passes; ++pass) {
    const int row0 = pass * QT * kTile;  // the pass's first query
    // the positions of the lane's rows g and g + 8 of each tile; a row past
    // the window gets -1 and attends nothing
    int qpos[QT][2];
#pragma unroll
    for (int qt = 0; qt < QT; ++qt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + qt * kTile + g + 8 * hf;
        qpos[qt][hf] = row < window ? pos_s[row] : -1;
      }
    // bf16: the warp's Q columns as A fragments, kept in registers
    uint32_t qa[QT][KS][4];
    if constexpr (!kIsF32<T>) {
#pragma unroll
      for (int qt = 0; qt < QT; ++qt)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int row = row0 + qt * kTile + g + 8 * (f & 1);
            const int col = col0 + ks * 16 + 2 * t + 8 * (f >> 1);
            qa[qt][ks][f] = row < window ? *reinterpret_cast<const uint32_t*>(
                                               q + ((int64_t)s * window + row) * row_stride + (int64_t)h * D + col)
                                         : 0u;
          }
    } else {
      // fp32: the pass's Q tiles in shared memory (no warp reads the previous
      // pass's tiles past the last chunk's exchange)
      for (int e = threadIdx.x; e < QT * kTile * D; e += kThreads) {
        const int row = row0 + e / D;
        qs[e] = row < window ? q[((int64_t)s * window + row) * row_stride + (int64_t)h * D + e % D] : 0.f;
      }
      __syncthreads();
    }

    float o[QT][NT][4];
    float m[QT][2], l[QT][2];
#pragma unroll
    for (int qt = 0; qt < QT; ++qt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[qt][nt][e] = 0.f;
      m[qt][0] = m[qt][1] = kNegInf;
      l[qt][0] = l[qt][1] = 0.f;
    }

    for (int i = 0; i < n_pages; ++i) {
      const int idx = pass * n_pages + i;
      const int st = idx % stages;
      mbar_wait(smem_addr(bars + st), (idx / stages) & 1);
      const unsigned char* kst = ring.base + (size_t)st * ring.stage_bytes;
      const unsigned char* vst = kst + ring.v_off;
      const int page_pos = tok0 + i * block_size;
      const int page_live = min(block_size, length - page_pos);
      for (int c0 = 0; c0 < page_live; c0 += kTile, ++chunk) {
        const int live = min(kTile, page_live - c0);  // live tokens of the chunk
        // 1. the warp's slice of S = Q K^T over the chunk's 16 tokens, in
        // the m16n8 layout: sc[qt][nt][e] is row g + 8 (e >> 1), token
        // 8 nt + 2 t + (e & 1). Rows past the live tokens hold whatever the
        // ring held (masked below).
        float sc[QT][2][4];
#pragma unroll
        for (int qt = 0; qt < QT; ++qt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[qt][nt][e] = 0.f;
        if constexpr (!kIsF32<T>) {
          // matrix j of the x4 load: tokens 8 (j >> 1) + row, columns
          // 8 (j & 1): the b0, b1 of n-tile 0, then of n-tile 1
          const int j = lane / 8;
          const uint32_t kaddr = smem_addr(kst + (c0 + 8 * (j >> 1) + lane % 8) * ring.stride) +
                                 (col0 + 8 * (j & 1)) * 2;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            uint32_t kb[4];
            ldmatrix_x4(kb, kaddr + ks * 32);
#pragma unroll
            for (int qt = 0; qt < QT; ++qt) {
              mma_bf16(sc[qt][0], qa[qt][ks], kb[0], kb[1]);
              mma_bf16(sc[qt][1], qa[qt][ks], kb[2], kb[3]);
            }
          }
        } else {
#pragma unroll
          for (int qt = 0; qt < QT; ++qt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float* qr = qs + (qt * kTile + g + 8 * (e >> 1)) * D + col0;
                const float* kr = reinterpret_cast<const float*>(kst + (c0 + 8 * nt + 2 * t + (e & 1)) * ring.stride) + col0;
                float acc = 0.f;
#pragma unroll 8
                for (int d = 0; d < DW; ++d) acc = fmaf(qr[d], kr[d], acc);
                sc[qt][nt][e] = acc;
              }
        }

        // 2. the four slices summed through shared memory, by every warp in
        // the same order, so every warp holds the same S
        float* xw = xch + ((chunk & 1) * kWarps + warp) * QT * 256;
#pragma unroll
        for (int qt = 0; qt < QT; ++qt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) xw[(qt * 8 + nt * 4 + e) * 32 + lane] = sc[qt][nt][e];
        __syncthreads();
#pragma unroll
        for (int qt = 0; qt < QT; ++qt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float x = 0.f;
#pragma unroll
              for (int w = 0; w < kWarps; ++w)
                x += xch[(((chunk & 1) * kWarps + w) * QT) * 256 + (qt * 8 + nt * 4 + e) * 32 + lane];
              sc[qt][nt][e] = x;
            }

        // 3. the online softmax of rows g and g + 8, in log2 units: a token
        // counts for a row iff it is live and at or before the row's position
        const int pos0 = page_pos + c0;
#pragma unroll
        for (int qt = 0; qt < QT; ++qt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float mx = m[qt][hf];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int tok = 8 * nt + 2 * t + e;
                float& x = sc[qt][nt][2 * hf + e];
                x = (tok < live && pos0 + tok <= qpos[qt][hf]) ? x * scale_log2 : kNegInf;
                mx = fmaxf(mx, x);
              }
            mx = quad_max(mx);
            const float alpha = exp2f(m[qt][hf] - mx);
            m[qt][hf] = mx;
            l[qt][hf] *= alpha;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              o[qt][nt][2 * hf] *= alpha;
              o[qt][nt][2 * hf + 1] *= alpha;
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& x = sc[qt][nt][2 * hf + e];
                x = x <= kNegInf ? 0.f : exp2f(x - mx);  // a masked token adds nothing
                l[qt][hf] += x;
              }
          }

        // 4. O += P V over the warp's columns
        if constexpr (!kIsF32<T>) {
          // P rounded to bf16, straight from the accumulator layout
          uint32_t pa[QT][4];
#pragma unroll
          for (int qt = 0; qt < QT; ++qt) {
            pa[qt][0] = pack_bf16(sc[qt][0][0], sc[qt][0][1]);
            pa[qt][1] = pack_bf16(sc[qt][0][2], sc[qt][0][3]);
            pa[qt][2] = pack_bf16(sc[qt][1][0], sc[qt][1][1]);
            pa[qt][3] = pack_bf16(sc[qt][1][2], sc[qt][1][3]);
          }
          // matrix j of the x4 transposed load: tokens 8 (j & 1) + row,
          // columns 8 (nt + (j >> 1)): the b0, b1 of n-tile nt, then nt + 1
          const int j = lane / 8;
          const uint32_t vaddr = smem_addr(vst + (c0 + 8 * (j & 1) + lane % 8) * ring.stride) +
                                 (col0 + 8 * (j >> 1)) * 2;
#pragma unroll
          for (int nt = 0; nt < NT; nt += 2) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, vaddr + nt * 16);
            if (live < kTile) {
              // rows past the live tokens hold whatever the ring held: zero
              // them, since 0 x NaN is NaN (the lane's halves are tokens
              // 8 (r & 1) + 2 t and one more)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int tok = 8 * (r & 1) + 2 * t;
                if (tok >= live) vb[r] = 0u;
                else if (tok + 1 >= live) vb[r] &= 0xffffu;
              }
            }
#pragma unroll
            for (int qt = 0; qt < QT; ++qt) {
              mma_bf16(o[qt][nt], pa[qt], vb[0], vb[1]);
              mma_bf16(o[qt][nt + 1], pa[qt], vb[2], vb[3]);
            }
          }
        } else {
          // P through the warp's own shared-memory rows, then FMA chains over
          // the live tokens in order
          float* pw = ps + warp * QT * kTile * kTile;
#pragma unroll
          for (int qt = 0; qt < QT; ++qt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                pw[(qt * kTile + g + 8 * (e >> 1)) * kTile + 8 * nt + 2 * t + (e & 1)] = sc[qt][nt][e];
          __syncwarp();
#pragma unroll
          for (int qt = 0; qt < QT; ++qt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float* pr = pw + (qt * kTile + g + 8 * (e >> 1)) * kTile;
                const int col = col0 + 8 * nt + 2 * t + (e & 1);
                float acc = o[qt][nt][e];
                for (int tok = 0; tok < live; ++tok)
                  acc = fmaf(pr[tok], reinterpret_cast<const float*>(vst + (c0 + tok) * ring.stride)[col], acc);
                o[qt][nt][e] = acc;
              }
        }
      }
      __syncthreads();  // every warp is done with stage st before it is refilled
      if (idx + stages < walk)
        load_page<T, D>(idx + stages, n_pages, phys, k_pool, v_pool, block_stride, head_off, block_size, ring);
    }

    // the pass's partial (acc, m, l) of each of its query rows; m in
    // natural units (a row with no live token keeps kNegInf)
#pragma unroll
    for (int qt = 0; qt < QT; ++qt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float l_row = quad_sum(l[qt][hf]);
        const int row = row0 + qt * kTile + g + 8 * hf;
        if (row < window) {
          float* pr = part_base + (int64_t)row * (D + 2);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            *reinterpret_cast<float2*>(pr + col0 + 8 * nt + 2 * t) = make_float2(o[qt][nt][2 * hf], o[qt][nt][2 * hf + 1]);
          if (warp == 0 && t == 0) {
            pr[D] = m[qt][hf] <= kNegInf ? kNegInf : m[qt][hf] * kLn2;
            pr[D + 1] = l_row;
          }
        }
      }
  }

  // The last of the (slot, head)'s live splits to finish merges them all:
  // each CTA makes its partials visible, then takes a ticket.
  __shared__ bool sm_last;
  const int live_splits = (length + split_tokens - 1) / split_tokens;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sm_last = atomicAdd(tickets + (int64_t)s * heads + h, 1) == live_splits - 1;
  __syncthreads();
  if (!sm_last) return;
  if (threadIdx.x == 0) tickets[(int64_t)s * heads + h] = 0;  // every live split has taken its ticket
  __threadfence();
  // Warp w merges queries w, w + kWarps, ...: its lanes reduce the query's
  // max and denominator over the live splits, then lane c sums columns c,
  // c + 32, ... over the splits, one load per split and column.
  const float* parts = scratch + ((int64_t)s * heads + h) * gridDim.x * window * (D + 2);
  const int64_t split_stride = (int64_t)window * (D + 2);
  for (int i = warp; i < window; i += kWarps) {
    const float* pi = parts + (int64_t)i * (D + 2);
    float m_all = kNegInf;
    for (int j = lane; j < live_splits; j += 32) m_all = fmaxf(m_all, __ldcg(pi + j * split_stride + D));
    m_all = warp_max(m_all);
    float den = 0.f;
    for (int j = lane; j < live_splits; j += 32)  // a split where the query saw no token weighs 0
      den += __ldcg(pi + j * split_stride + D + 1) * expf(__ldcg(pi + j * split_stride + D) - m_all);
    den = warp_sum(den);
    float num[D / 32];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) num[c] = 0.f;
    // four splits' loads in flight at once: the merge is the tail of the
    // (slot, head), and a chain of dependent L2 reads per split was its cost
    constexpr int kU = 4;
    for (int j0 = 0; j0 < live_splits; j0 += kU) {
      float mj[kU], x[kU][D / 32];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float* pj = pi + min(j0 + u, live_splits - 1) * split_stride;
        mj[u] = __ldcg(pj + D);
#pragma unroll
        for (int c = 0; c < D / 32; ++c) x[u][c] = __ldcg(pj + lane + 32 * c);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float w = j0 + u < live_splits ? expf(mj[u] - m_all) : 0.f;
#pragma unroll
        for (int c = 0; c < D / 32; ++c) num[c] += x[u][c] * w;
      }
    }
    const float inv = den > 0.f ? 1.f / den : 0.f;
    T* o = out + ((int64_t)s * window + i) * row_stride + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) o[lane + 32 * c] = from_float<T>(num[c] * inv);
  }
}

template <typename T, int D, int QT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                   const void* positions, void* out, void* scratch, void* tickets, int slots, int window,
                   int heads, int num_blocks, int block_size, int tmax, int pages_per_split, float scale,
                   cudaStream_t stream) {
  const int row_bytes = D * (int)sizeof(T);
  if (block_size < 1 || block_size * row_bytes > kMaxPageBytes) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(k_pool) % 16 || reinterpret_cast<uintptr_t>(v_pool) % 16)
    return cudaErrorMisalignedAddress;
  const int splits = (tmax + pages_per_split - 1) / pages_per_split;
  const int stage_bytes = 2 * ((block_size + kTile - 1) / kTile * kTile) * (row_bytes + kRowPad);
  const int stages = std::max(2, std::min({kMaxStages, pages_per_split, kRingBytes / stage_bytes}));
  const size_t extra = kIsF32<T> ? (size_t)(QT * kTile * D + kWarps * QT * kTile * kTile) * sizeof(float) : 0;
  const size_t smem = (size_t)stages * stage_bytes + (size_t)2 * kWarps * QT * 8 * 32 * sizeof(float) + extra +
                      kMaxStages * sizeof(uint64_t) + pages_per_split * sizeof(int);
  auto kernel = paged_verify_kernel<T, D, QT>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(std::max(splits, 1), heads, slots), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(positions), static_cast<float*>(scratch),
      static_cast<int*>(tickets), static_cast<T*>(out), window, heads, num_blocks, block_size, tmax,
      pages_per_split, stages, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int head_dim, int window, const void* q, const void* k_pool, const void* v_pool,
                       const void* tables, const void* positions, void* out, void* scratch, void* tickets,
                       int slots, int heads, int num_blocks, int block_size, int tmax, int pages_per_split,
                       float scale, cudaStream_t stream) {
#define RT_LAUNCH(D, QT)                                                                                   \
  launch<T, D, QT>(q, k_pool, v_pool, tables, positions, out, scratch, tickets, slots, window, heads,      \
                   num_blocks, block_size, tmax, pages_per_split, scale, stream)
  // one query tile a pass up to W = 16, two beyond
  const bool one = window <= kTile;
  switch (head_dim) {
    case 64:
      return one ? RT_LAUNCH(64, 1) : RT_LAUNCH(64, 2);
    case 128:
      return one ? RT_LAUNCH(128, 1) : RT_LAUNCH(128, 2);
    case 256:
      return one ? RT_LAUNCH(256, 1) : RT_LAUNCH(256, 2);
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. scratch: fp32 (slots, heads,
// ceil(tmax / pages_per_split), window, head_dim + 2); tickets: int32
// (slots, heads), zeros, and zeros again when the launch ends (each merging
// CTA resets its own). Returns cudaGetLastError() after the launch, or
// without launching cudaErrorInvalidValue for a dtype or head_dim not
// compiled here (64, 128, 256), a window under 1 or a (block, head) page
// over kMaxPageBytes, cudaErrorMisalignedAddress for a pool off a 16-byte
// boundary.
extern "C" int paged_verify_attention(const void* q, const void* k_pool, const void* v_pool,
                                      const void* tables, const void* positions, void* out, void* scratch,
                                      void* tickets, int slots, int window, int heads, int head_dim,
                                      int num_blocks, int block_size, int tmax, int pages_per_split,
                                      float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (window < 1 || pages_per_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_dim<float>(head_dim, window, q, k_pool, v_pool, tables, positions, out, scratch,
                                              tickets, slots, heads, num_blocks, block_size, tmax,
                                              pages_per_split, scale, st));
  if (dtype == 1)
    return static_cast<int>(launch_dim<__nv_bfloat16>(head_dim, window, q, k_pool, v_pool, tables, positions, out,
                                                      scratch, tickets, slots, heads, num_blocks, block_size,
                                                      tmax, pages_per_split, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
