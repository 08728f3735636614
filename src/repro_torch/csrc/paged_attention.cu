// Paged-attention decode/verify kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (`paged_attention`, body `_kernel`): attention for K >= 1 query tokens
// per batch row over a paged KV pool, the pools kept in the JAX layout
// (P+1, bs, Hkv, D) with the last page the null page, q as (B, K, H, D).
//
// Semantics (identical to the Pallas kernel and to the plain version
// repro_torch.kernels.ref.paged_attention_ref):
//   * GQA folds the K query tokens and the g = H / Hkv grouped heads of
//     one kv head into R = K * g accumulator rows; row r = t * g + j is
//     query token t, q head h * g + j;
//   * row r reaches `lengths[b] + r / g` tokens (the causal staircase of a
//     K-token verify); positions past a row's reach get zero weight (the
//     Pallas kernel's NEG_INF = -1e30 scores);
//   * pages with p * bs >= lengths[b] + K - 1 lie past every row's reach
//     and are skipped, so null-page table tails are never read;
//   * online softmax with running (m, l) and the accumulator in f32; the
//     output is written in q's dtype.
//
// Design.  The TPU grid (batch, kv_head, page) ran in order on one core,
// carrying the accumulator in VMEM across the page axis.  On Hopper a
// lone block sweeping its pages behind a barrier per page is bound by that
// chain's latency, so here the sweep is split inside the block instead:
//   * one block per (b, kv_head, group of ROWS accumulator rows); it reads
//     tables[b, p] and lengths[b] itself (no scalar prefetch);
//   * each of its NW warps takes every NW-th page of the row and keeps, in
//     registers, its rows' q, accumulator and running (m, l); lane l holds
//     dims l, l + 32, ... of each row, so one token's K (or V) is one
//     coalesced load per 32 dims, and a dot product is E fmas plus a
//     5-step shuffle reduction;
//   * a page is read in groups of TG tokens whose loads are all issued
//     before any is used, so a group costs about one memory round trip;
//   * no barrier inside the sweep: the NW partial softmax states merge once
//     at the end through shared memory (m = max, l and acc rescaled).
// head_dim D is a template parameter, built for the head dims of the
// ported configs (16: qwen3 smoke, 64, 128: qwen3), so every D loop
// unrolls.
//
// What bounds it on the H100: bytes.  Every K and V element of each row's
// reach is read once from device memory (sum_b (lengths[b] + K - 1) * Hkv
// * D * 2 * sizeof(T)); the arithmetic is ~4 flops per byte.  Known gaps,
// left for later work:
//   * at B = 8, Hkv = 8, K = 1 only 64 blocks are in flight on 132 SMs;
//     the sweep is not split across blocks (flash-decoding);
//   * more than ROWS accumulator rows (K * g > 4, e.g. K = 5 with g = 2)
//     take one block per group of ROWS rows, each re-reading the K/V;
//   * no TMA or cp.async pipelining: a group's loads wait for the previous
//     group's math; the loads are 2- or 4-byte scalars, not 16-byte
//     vectors;
//   * no tensor cores for the (K*g x D) products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARP = 32;
constexpr int NW = 8;                 // warps per block
constexpr int THREADS = NW * WARP;
constexpr int ROWS = 4;               // accumulator rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = WARP / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// shared memory of the final merge: NW warps' (m, l, acc[ROWS][D])
constexpr size_t merge_bytes(int D) {
  return sizeof(float) * (size_t)NW * ROWS * (D + 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int K, int H, int Hkv, int bs, int W, float scale) {
  constexpr int E = (D + WARP - 1) / WARP;  // dims per lane
  constexpr int TG = WARP / E;              // tokens per load group
  const int h = blockIdx.x;                 // kv head
  const int b = blockIdx.y;                 // batch row
  const int r0 = blockIdx.z * ROWS;         // first accumulator row
  const int g = H / Hkv;
  const int rows = min(ROWS, K * g - r0);
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const int len = lengths[b];

  float qr[ROWS][E], acc[ROWS][E], m[ROWS], l[ROWS];
  int reach[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i;
    const int t = r / g, j = r % g;
    reach[i] = i < rows ? len + t : 0;  // rows past K * g reach nothing
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + e * WARP;
      acc[i][e] = 0.f;
      qr[i][e] = (i < rows && d < D)
                     ? to_f32(q[(((size_t)b * K + t) * H + h * g + j) * D +
                                d]) * scale
                     : 0.f;
    }
  }
  const int last = len + (r0 + rows - 1) / g;  // widest reach of the block
  int n_pages = (last + bs - 1) / bs;
  if (n_pages > W) n_pages = W;
  const size_t token_stride = (size_t)Hkv * D;

  for (int p = warp; p < n_pages; p += NW) {
    const size_t base =
        ((size_t)tables[(size_t)b * W + p] * bs * Hkv + h) * D;
    for (int t0 = 0; t0 < bs; t0 += TG) {
      float kv[TG][E], vv[TG][E];
#pragma unroll
      for (int u = 0; u < TG; ++u) {
        const bool ok = t0 + u < bs && p * bs + t0 + u < last;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane + e * WARP;
          const size_t src = base + (size_t)(t0 + u) * token_stride + d;
          kv[u][e] = ok && d < D ? to_f32(k_pages[src]) : 0.f;
          vv[u][e] = ok && d < D ? to_f32(v_pages[src]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < TG; ++u) {
        const int pos = p * bs + t0 + u;
        if (t0 + u >= bs || pos >= last) break;  // warp-uniform
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          if (pos >= reach[i]) continue;          // warp-uniform
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) s += qr[i][e] * kv[u][e];
          s = warp_sum(s);
          const float m_new = fmaxf(m[i], s);
          const float corr = expf(m[i] - m_new);
          const float w = expf(s - m_new);
          l[i] = l[i] * corr + w;
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[i][e] = acc[i][e] * corr + w * vv[u][e];
          m[i] = m_new;
        }
      }
    }
  }

  // merge the NW warps' partial softmax states
  extern __shared__ float smem[];
  float* m_w = smem;                 // NW * ROWS
  float* l_w = m_w + NW * ROWS;      // NW * ROWS
  float* a_w = l_w + NW * ROWS;      // NW * ROWS * D
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (lane == 0) {
      m_w[warp * ROWS + i] = m[i];
      l_w[warp * ROWS + i] = l[i];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + e * WARP;
      if (d < D) a_w[(warp * ROWS + i) * D + d] = acc[i][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * D; idx += THREADS) {
    const int i = idx / D, d = idx % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, m_w[w * ROWS + i]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(m_w[w * ROWS + i] - M);
      L += l_w[w * ROWS + i] * c;
      A += a_w[(w * ROWS + i) * D + d] * c;
    }
    const int r = r0 + i, t = r / g, j = r % g;
    out[(((size_t)b * K + t) * H + h * g + j) * D + d] =
        from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k_pages, const void* v_pages,
                     const void* tables, const void* lengths, void* out,
                     int B, int K, int H, int Hkv, int bs, int W,
                     cudaStream_t stream) {
  const int row_blocks = (K * (H / Hkv) + ROWS - 1) / ROWS;
  const dim3 grid(Hkv, B, row_blocks);
  paged_attention_kernel<T, D><<<grid, THREADS, merge_bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), K, H, Hkv, bs,
      W, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* tables, const void* lengths, void* out, int B,
                   int K, int H, int Hkv, int D, int bs, int W,
                   cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k_pages, v_pages, tables, lengths, out, B, K,
                             H, Hkv, bs, W, stream);
    case 64:
      return launch_d<T, 64>(q, k_pages, v_pages, tables, lengths, out, B, K,
                             H, Hkv, bs, W, stream);
    case 128:
      return launch_d<T, 128>(q, k_pages, v_pages, tables, lengths, out, B,
                              K, H, Hkv, bs, W, stream);
    default:
      return cudaErrorInvalidValue;  // the wrapper refuses other head dims
  }
}

}  // namespace

// C entry point, loaded with ctypes by repro_torch.kernels.paged_attention.
// Shapes: q/out (B, K, H, D); k_pages/v_pages (P+1, bs, Hkv, D); tables
// (B, W) int32; lengths (B,) int32; all contiguous, on the current device;
// D in {16, 64, 128}.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages, const void* tables,
                                     const void* lengths, void* out, int B,
                                     int K, int H, int Hkv, int D, int bs,
                                     int W, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k_pages, v_pages, tables, lengths,
                                      out, B, K, H, Hkv, D, bs, W, s)
              : launch<float>(q, k_pages, v_pages, tables, lengths, out, B,
                              K, H, Hkv, D, bs, W, s);
  return static_cast<int>(err);
}
