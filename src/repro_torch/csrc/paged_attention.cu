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
//     K-token verify); positions past a row's reach get zero weight;
//   * tokens at or past lengths[b] + K - 1 lie past every row's reach and
//     are never read, so null-page table tails are never touched;
//   * online softmax with running (m, l) and the accumulator in f32; the
//     output is written in q's dtype.
//
// What bounds it on the H100: bytes.  Every K and V element of each row's
// reach is read once from device memory (sum_b (lengths[b] + K - 1) * Hkv
// * D * 2 * sizeof(T)); the arithmetic is ~4 flops per byte at g = 2, far
// below the ~295 the card needs before its tensor cores are the limit.
// At the serve shape (B = 8, Hkv = 8, D = 128, bf16, ~400 tokens a row)
// that is 12.7 MB, ~4 us at 3.35 TB/s.  What keeps a decode kernel from it
// is latency: too few blocks, too few bytes in flight, and chains of
// dependent loads and shuffles.
//
// Design (flash-decoding; the TPU grid's sequential page axis becomes a
// split across blocks plus a merge):
//   * grid (splits, Hkv, B): block (s, h, b) sweeps the contiguous page
//     range [s * pps, (s + 1) * pps) of row b's table for kv head h, for
//     ALL R rows of that kv head at once, so K/V is read once per kv head
//     whatever K * g is.  The wrapper picks `splits` from the table width
//     and the SM count (kernels/paged_attention.py `split_plan`: two
//     blocks per SM, at most MAX_SPLITS);
//   * the block reads its split's page ids beside lengths[b] (they need no
//     reach), then gathers its pages into a shared-memory ring of slots of
//     16 tokens (K and V; 8 slots in bf16, 4 in f32), each thread issuing
//     16-byte `cp.async.cg` copies (a slot may span pages: any page size
//     works); tokens past the block's reach are zero-filled, not read.  All
//     but one slot are in flight while a slot's math runs;
//   * warp w owns rows [w * RT, (w + 1) * RT) and keeps their running
//     (m, l, acc) in registers.  bf16: RT = 16 rows (padded), S = Q K^T
//     and P V as `mma.sync m16n8k16` on the tensor cores, K and V read
//     with `ldmatrix` (V transposed) from an XOR-swizzled slot, P rounded
//     to bf16 in registers as FA2 does.  f32: RT = 4 rows on CUDA cores in
//     f32 (TF32 would not meet the f32 tolerance); lane l holds dims l,
//     l + 32, ... of each row.  A block has at least MIN_WARPS warps: the
//     ones past the rows help with the copies and the merge;
//   * each block writes its partial (m, l, acc[D]) to an f32 workspace; a
//     block whose range lies wholly past the reach writes an empty partial
//     (m = -1e30, l = 0) without reading K/V.  The last block of each
//     (b, kv head) to finish -- an atomic ticket -- merges the `splits`
//     partials with all its threads (every (m, l) into shared memory at
//     once, a weight per split and row, acc summed as float4) and writes
//     the output, then resets its ticket to 0 for the next launch on the
//     stream: one launch per call.
// head_dim D is a template parameter, built for the head dims of the
// ported configs (16: qwen3 smoke, 64, 128: qwen3), so every D loop
// unrolls.
//
// What is left: a fixed chain of dependent memory trips (lengths and page
// ids, K/V, the partials' fence and the ticket, the merge's reads) that
// the bytes do not set: on an H100 80GB HBM3 at 700 W, chip_smoke.py's
// batch of idle rows takes ~0.011 ms against ~0.018 ms at the serve
// shape.  The f32 path keeps per-token shuffle reductions (it serves the
// card tests and checks only).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARP = 32;
constexpr int ST = 16;         // tokens per ring slot
constexpr int MAX_ROWS = 64;   // accumulator rows K * g
constexpr int MAX_SPLITS = 64;
constexpr int MIN_WARPS = 4;   // the loads and the merge use every warp
constexpr int PG = 64;         // page ids of a split read up front

template <typename T>
struct Rows;  // accumulator rows per warp
template <>
struct Rows<__nv_bfloat16> {
  static constexpr int RT = 16;      // one m16n8k16 A tile
  static constexpr int STAGES = 8;   // ring slots: 64 KB at D = 128
  static constexpr int MAX_WARPS = MAX_ROWS / RT;
};
template <>
struct Rows<float> {
  static constexpr int RT = 4;
  static constexpr int STAGES = 4;   // 64 KB at D = 128
  static constexpr int MAX_WARPS = MAX_ROWS / RT;
};
template <typename T>
__host__ __device__ constexpr int max_threads() {
  return (Rows<T>::MAX_WARPS > MIN_WARPS ? Rows<T>::MAX_WARPS : MIN_WARPS) *
         WARP;
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; `ok` false zero-fills the
// destination and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A slot holds ST token rows of D elements for K and for V, in 16-byte
// chunks; chunk c of token row u sits at u * CPR + (c ^ (u & SW)), so the
// eight rows an `ldmatrix` reads fall in eight different bank groups.
template <typename T, int D>
struct Slot {
  static constexpr int VEC = 16 / sizeof(T);    // elements per chunk
  static constexpr int CPR = D / VEC;           // chunks per token row
  static constexpr int SW = (CPR < 8 ? CPR : 8) - 1;
  static constexpr int CHUNKS = ST * CPR;       // per pool
  __device__ static __forceinline__ int chunk(int u, int c) {
    return u * CPR + (c ^ (u & SW));
  }
  __device__ static __forceinline__ int elem(int u, int d) {
    return chunk(u, d / VEC) * VEC + d % VEC;
  }
};

// Issue the copies of one slot: block tokens [tok, tok + ST) of row b's
// pages for kv head h; tokens at or past `tok_end` are zero-filled.  The
// split's first PG page ids are in `pg` (from table column p0 on).
template <typename T, int D>
__device__ __forceinline__ void load_slot(uint4* ks, uint4* vs,
                                          const T* __restrict__ k_pages,
                                          const T* __restrict__ v_pages,
                                          const int* __restrict__ table,
                                          const int* pg, int p0, int tok,
                                          int tok_end, int bs, int Hkv,
                                          int h) {
  using SL = Slot<T, D>;
  for (int idx = threadIdx.x; idx < SL::CHUNKS; idx += blockDim.x) {
    const int u = idx / SL::CPR, c = idx % SL::CPR;
    const int pos = tok + u;
    const bool ok = pos < tok_end;
    size_t off = 0;
    if (ok) {
      const int pi = pos / bs;
      const int page = pi - p0 < PG ? pg[pi - p0] : __ldg(table + pi);
      off = (((size_t)page * bs + pos % bs) * Hkv + h) * D + c * SL::VEC;
    }
    const int s = SL::chunk(u, c);
    cp_async16(ks + s, k_pages + off, ok);
    cp_async16(vs + s, v_pages + off, ok);
  }
}

// ---------------------------------------------------------------------------
// per-warp softmax state and the math of one slot
// ---------------------------------------------------------------------------

// bf16: one 16-row tile on the tensor cores.  Lane (gq = lane / 4,
// tq = lane % 4) holds rows gq and gq + 8 of the m16n8k16 fragments.
template <int D>
struct WarpTC {
  static constexpr int KT = D / 16;  // k-steps of Q K^T
  static constexpr int NT = D / 8;   // n-tiles of P V
  uint32_t qf[KT][4];
  float acc[NT][4];
  float m[2], l[2];
  int lim[2];  // a row's reach, capped at the block's token end

  __device__ __forceinline__ void init(const __nv_bfloat16* __restrict__ q,
                                       int b, int K, int H, int h, int g,
                                       int R, int row0, int len,
                                       int tok_end) {
    const int lane = threadIdx.x % WARP, gq = lane / 4, tq = lane % 4;
    const __nv_bfloat16* qrow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + gq + 8 * i;
      const int t = r / g, j = r % g;
      qrow[i] = r < R ? q + (((size_t)b * K + t) * H + h * g + j) * D
                      : nullptr;
      lim[i] = r < R ? min(len + t, tok_end) : 0;
      m[i] = NEG_INF;
      l[i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        // x: 0 row gq cols 2tq; 1 row gq+8; 2 row gq cols 2tq+8; 3 row gq+8
        const __nv_bfloat16* p = qrow[x & 1];
        qf[kk][x] = p ? *reinterpret_cast<const uint32_t*>(
                            p + kk * 16 + (x >> 1) * 8 + 2 * tq)
                      : 0u;
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[n][x] = 0.f;
  }

  __device__ static __forceinline__ void mma(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }

  __device__ static __forceinline__ void ldsm4(uint32_t* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
  }
  __device__ static __forceinline__ void ldsm4t(uint32_t* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
  }

  // one slot: tokens tok .. tok + 15 in ks / vs
  __device__ __forceinline__ void slot(const uint4* ks, const uint4* vs,
                                       int tok, float scale_log2) {
    using SL = Slot<__nv_bfloat16, D>;
    const int lane = threadIdx.x % WARP, tq = lane % 4;
    const int mi = lane / 8, rr = lane % 8;
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      // matrices: tokens 0-7 / 8-15 (mi >> 1) x dims 16kk / 16kk+8 (mi & 1)
      uint32_t kb[4];
      ldsm4(kb, ks + SL::chunk((mi >> 1) * 8 + rr, 2 * kk + (mi & 1)));
      mma(s[0], qf[kk], kb[0], kb[1]);
      mma(s[1], qf[kk], kb[2], kb[3]);
    }
    // mask, scale into the log2 domain, online softmax per row
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = x >> 1;
        const int pos = tok + n * 8 + 2 * tq + (x & 1);
        s[n][x] = pos < lim[i] ? s[n][x] * scale_log2 : NEG_INF;
        mx[i] = fmaxf(mx[i], s[n][x]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float p[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = x >> 1;
        p[x] = s[n][x] > 0.5f * NEG_INF ? exp2f(s[n][x] - m[i]) : 0.f;
        l[i] += p[x];
      }
      // A fragment of P (16 rows x 16 tokens): n-tile n is cols 8n..8n+7
      __nv_bfloat162 lo = __floats2bfloat162_rn(p[0], p[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(p[2], p[3]);
      pa[2 * n] = *reinterpret_cast<uint32_t*>(&lo);
      pa[2 * n + 1] = *reinterpret_cast<uint32_t*>(&hi);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      // matrices: tokens 0-7 / 8-15 (mi & 1) x dims 16np / 16np+8 (mi >> 1)
      uint32_t vb[4];
      ldsm4t(vb, vs + SL::chunk((mi & 1) * 8 + rr, 2 * np + (mi >> 1)));
      mma(acc[2 * np], pa, vb[0], vb[1]);
      mma(acc[2 * np + 1], pa, vb[2], vb[3]);
    }
  }

  __device__ __forceinline__ void store(float* ml, float* pacc, int R,
                                        int row0) {
    const int lane = threadIdx.x % WARP, gq = lane / 4, tq = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int r = row0 + gq + 8 * i;
      if (r >= R) continue;
      if (tq == 0) {
        ml[2 * r] = m[i];
        ml[2 * r + 1] = l[i];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(pacc + (size_t)r * D + n * 8 + 2 * tq) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
};

// f32: RT = 4 rows on CUDA cores; lane l holds dims l, l + 32, ...
template <int D>
struct WarpF32 {
  static constexpr int RT = Rows<float>::RT;
  static constexpr int E = (D + WARP - 1) / WARP;
  float qr[RT][E], acc[RT][E], m[RT], l[RT];
  int lim[RT];

  __device__ __forceinline__ void init(const float* __restrict__ q, int b,
                                       int K, int H, int h, int g, int R,
                                       int row0, int len, int tok_end,
                                       float scale_log2) {
    const int lane = threadIdx.x % WARP;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = row0 + i;
      const int t = r / g, j = r % g;
      lim[i] = r < R ? min(len + t, tok_end) : 0;
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lane + e * WARP;
        acc[i][e] = 0.f;
        qr[i][e] = (r < R && d < D)
                       ? q[(((size_t)b * K + t) * H + h * g + j) * D + d] *
                             scale_log2
                       : 0.f;
      }
    }
  }

  __device__ __forceinline__ void slot(const uint4* ks, const uint4* vs,
                                       int tok, int tok_end) {
    using SL = Slot<float, D>;
    const float* kf = reinterpret_cast<const float*>(ks);
    const float* vf = reinterpret_cast<const float*>(vs);
    const int lane = threadIdx.x % WARP;
    for (int u = 0; u < ST && tok + u < tok_end; ++u) {
      float kv[E], vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lane + e * WARP;
        kv[e] = d < D ? kf[SL::elem(u, d)] : 0.f;
        vv[e] = d < D ? vf[SL::elem(u, d)] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        if (tok + u >= lim[i]) continue;  // warp-uniform
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s += qr[i][e] * kv[e];
        s = warp_sum(s);
        const float m_new = fmaxf(m[i], s);
        const float corr = exp2f(m[i] - m_new);
        const float w = exp2f(s - m_new);
        l[i] = l[i] * corr + w;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = acc[i][e] * corr + w * vv[e];
        m[i] = m_new;
      }
    }
  }

  __device__ __forceinline__ void store(float* ml, float* pacc, int R,
                                        int row0) {
    const int lane = threadIdx.x % WARP;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = row0 + i;
      if (r >= R) continue;
      if (lane == 0) {
        ml[2 * r] = m[i];
        ml[2 * r + 1] = l[i];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lane + e * WARP;
        if (d < D) pacc[(size_t)r * D + d] = acc[i][e];
      }
    }
  }
};

template <typename T, int D>
struct Warp;
template <int D>
struct Warp<__nv_bfloat16, D> {
  using type = WarpTC<D>;
};
template <int D>
struct Warp<float, D> {
  using type = WarpF32<D>;
};

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// `ml` holds (m, l) per (b, kv head, split, row) and `pacc` acc[D] per
// (b, kv head, split, row), both f32, m in the log2 domain; `tickets` one
// int per (b, kv head), 0 on entry and left 0 on exit.
template <typename T, int D>
__global__ void __launch_bounds__(max_threads<T>())
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       float* __restrict__ ml, float* __restrict__ pacc,
                       int* __restrict__ tickets, int K, int H, int Hkv,
                       int bs, int W, int pps, float scale_log2) {
  using SL = Slot<T, D>;
  constexpr int RT = Rows<T>::RT, STAGES = Rows<T>::STAGES;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int g = H / Hkv, R = K * g;
  const int warp = threadIdx.x / WARP;
  const int row0 = warp * RT;
  const bool rows = row0 < R;  // warps past the rows only load and merge
  const int p0 = split * pps;
  const int* table = tables + (size_t)b * W;

  // the split's page ids, read beside lengths[b] (they need no reach)
  __shared__ int pg[PG];
  const int len = lengths[b];
  for (int i = threadIdx.x; i < min(min(pps, W - p0), PG); i += blockDim.x)
    pg[i] = __ldg(table + p0 + i);
  const int last = len + K - 1;  // the widest reach: tokens [0, last)
  const int p1 = min(min(p0 + pps, W), (last + bs - 1) / bs);
  const int tok0 = p0 * bs;
  const int tok_end = min(p1 * bs, last);
  const size_t bh = (size_t)b * Hkv + h;
  float* my_ml = ml + (bh * splits + split) * R * 2;
  float* my_acc = pacc + (bh * splits + split) * R * D;
  __syncthreads();

  extern __shared__ __align__(128) uint4 ring[];  // STAGES x (K, V) slots
  if (tok0 < tok_end) {  // block-uniform
    typename Warp<T, D>::type st;
    if (rows) {
      if constexpr (sizeof(T) == 2)
        st.init(q, b, K, H, h, g, R, row0, len, tok_end);
      else
        st.init(q, b, K, H, h, g, R, row0, len, tok_end, scale_log2);
    }
    const int n_slots = (tok_end - tok0 + ST - 1) / ST;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_slots)
        load_slot<T, D>(ring + 2 * s * SL::CHUNKS,
                        ring + (2 * s + 1) * SL::CHUNKS, k_pages, v_pages,
                        table, pg, p0, tok0 + s * ST, tok_end, bs, Hkv, h);
      cp_commit();
    }
    for (int i = 0; i < n_slots; ++i) {
      cp_wait<STAGES - 2>();
      __syncthreads();  // slot i landed; slot i - 1 is free again
      const int nx = i + STAGES - 1;
      if (nx < n_slots) {
        const int sl = nx % STAGES;
        load_slot<T, D>(ring + 2 * sl * SL::CHUNKS,
                        ring + (2 * sl + 1) * SL::CHUNKS, k_pages, v_pages,
                        table, pg, p0, tok0 + nx * ST, tok_end, bs, Hkv, h);
      }
      cp_commit();
      const int sl = i % STAGES;
      if (!rows) continue;
      if constexpr (sizeof(T) == 2)
        st.slot(ring + 2 * sl * SL::CHUNKS, ring + (2 * sl + 1) * SL::CHUNKS,
                tok0 + i * ST, scale_log2);
      else
        st.slot(ring + 2 * sl * SL::CHUNKS, ring + (2 * sl + 1) * SL::CHUNKS,
                tok0 + i * ST, tok_end);
    }
    cp_wait<0>();
    if (rows) st.store(my_ml, my_acc, R, row0);
  } else {
    // an empty partial: the range lies past every row's reach
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      my_ml[2 * r] = NEG_INF;
      my_ml[2 * r + 1] = 0.f;
    }
  }

  // the last block of (b, kv head) to arrive merges the partials
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(tickets + bh, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // every split's (m, l) into shared memory at once; then per row the
  // weight of each split, e^(m - M) / L (0 where the split holds none of
  // the row's tokens), in place of its m
  float* mls = reinterpret_cast<float*>(ring);
  const float* all_ml = ml + bh * splits * R * 2;
  const float* all_acc = pacc + bh * splits * R * D;
  for (int i = threadIdx.x; i < splits * R * 2; i += blockDim.x)
    mls[i] = __ldcg(all_ml + i);
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float M = NEG_INF, L = 0.f;
    for (int s = 0; s < splits; ++s)
      if (mls[(s * R + r) * 2 + 1] > 0.f)
        M = fmaxf(M, mls[(s * R + r) * 2]);
    for (int s = 0; s < splits; ++s) {
      float* w = mls + (s * R + r) * 2;
      w[0] = w[1] > 0.f ? exp2f(w[0] - M) : 0.f;
      L += w[1] * w[0];
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int s = 0; s < splits; ++s) mls[(s * R + r) * 2] *= inv;
  }
  __syncthreads();
  constexpr int D4 = D / 4;
  for (int idx = threadIdx.x; idx < R * D4; idx += blockDim.x) {
    const int r = idx / D4, d4 = idx % D4;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float w = mls[(s * R + r) * 2];
      if (w == 0.f) continue;
      const float4 a = __ldcg(
          reinterpret_cast<const float4*>(all_acc + ((size_t)s * R + r) * D) +
          d4);
      A.x += w * a.x;
      A.y += w * a.y;
      A.z += w * a.z;
      A.w += w * a.w;
    }
    const int t = r / g, j = r % g;
    T* o = out + (((size_t)b * K + t) * H + h * g + j) * D + 4 * d4;
    o[0] = from_f32<T>(A.x);
    o[1] = from_f32<T>(A.y);
    o[2] = from_f32<T>(A.z);
    o[3] = from_f32<T>(A.w);
  }
  if (threadIdx.x == 0) tickets[bh] = 0;  // ready for the next launch
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k_pages, const void* v_pages,
                     const void* tables, const void* lengths, void* out,
                     void* work, void* tickets, int B, int K, int H, int Hkv,
                     int bs, int W, int splits, int pps,
                     cudaStream_t stream) {
  using SL = Slot<T, D>;
  constexpr int RT = Rows<T>::RT, STAGES = Rows<T>::STAGES;
  const int R = K * (H / Hkv);
  if (R > MAX_ROWS || splits < 1 || splits > MAX_SPLITS || pps < 1 ||
      (splits - 1) * pps >= W)
    return cudaErrorInvalidValue;
  const int warps = (R + RT - 1) / RT;
  const int threads = (warps > MIN_WARPS ? warps : MIN_WARPS) * WARP;
  // the ring, reused by the merge for every split's (m, l)
  size_t smem = sizeof(uint4) * 2 * STAGES * SL::CHUNKS;
  if (smem < sizeof(float) * 2 * splits * R)
    smem = sizeof(float) * 2 * splits * R;
  if (smem > 48 * 1024) {  // D = 128: 64 KB
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  float* ml = static_cast<float*>(work);
  float* pacc = ml + ((size_t)B * Hkv * splits * R * 2 + 3) / 4 * 4;
  const dim3 grid(splits, Hkv, B);
  paged_attention_kernel<T, D><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), ml, pacc,
      static_cast<int*>(tickets), K, H, Hkv, bs, W, pps,
      LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* tables, const void* lengths, void* out,
                   void* work, void* tickets, int B, int K, int H, int Hkv,
                   int D, int bs, int W, int splits, int pps,
                   cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k_pages, v_pages, tables, lengths, out, work,
                             tickets, B, K, H, Hkv, bs, W, splits, pps,
                             stream);
    case 64:
      return launch_d<T, 64>(q, k_pages, v_pages, tables, lengths, out, work,
                             tickets, B, K, H, Hkv, bs, W, splits, pps,
                             stream);
    case 128:
      return launch_d<T, 128>(q, k_pages, v_pages, tables, lengths, out,
                              work, tickets, B, K, H, Hkv, bs, W, splits,
                              pps, stream);
    default:
      return cudaErrorInvalidValue;  // the wrapper refuses other head dims
  }
}

}  // namespace

// C entry point, loaded with ctypes by repro_torch.kernels.paged_attention.
// Shapes: q/out (B, K, H, D); k_pages/v_pages (P+1, bs, Hkv, D); tables
// (B, W) int32; lengths (B,) int32; all contiguous, on the current device;
// D in {16, 64, 128}; K * H / Hkv <= 64.  `work` is an f32 workspace of
// B * Hkv * splits * R * (D + 2) + 4 floats (R = K * H / Hkv), `tickets` B
// * Hkv int32 zeros (left zero); the sweep is cut into `splits` <= 64
// ranges of `pps` pages, (splits - 1) * pps < W.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages, const void* tables,
                                     const void* lengths, void* out,
                                     void* work, void* tickets, int B, int K,
                                     int H, int Hkv, int D, int bs, int W,
                                     int splits, int pps, int is_bf16,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k_pages, v_pages, tables, lengths,
                                      out, work, tickets, B, K, H, Hkv, D,
                                      bs, W, splits, pps, s)
              : launch<float>(q, k_pages, v_pages, tables, lengths, out,
                              work, tickets, B, K, H, Hkv, D, bs, W, splits,
                              pps, s);
  return static_cast<int>(err);
}
