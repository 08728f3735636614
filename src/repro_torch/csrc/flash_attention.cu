// Flash-attention forward and backward kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_kernel`) and its model twin with the
// hand-written backward, src/repro/models/layers.py (`flash_attention_jax`,
// `_flash_fwd_scan`, `_flash_vjp_bwd`): causal (or full) grouped-query
// attention over q (B, S, H, D) and k/v (B, S, Hkv, D) in the model's own
// layout, q head h reading kv head h / (H / Hkv).
//
// Semantics (those of the plain versions repro_torch.kernels.ref.
// flash_attention_fwd_ref / flash_attention_bwd_ref):
//   * forward: online softmax over key tiles with the running (m, l) and
//     the accumulator in f32; writes out (q's dtype) and
//     lse = m + log(max(l, 1e-30)) (f32, (B, S, H)) for the backward;
//   * backward: delta = rowsum(out * dout); P is recomputed from lse;
//     dV = P^T dO, dS = P * (dO V^T - delta) * scale, dK = dS^T Q and
//     dQ = dS K, every sum in f32, each result cast once to its input's
//     dtype at the end.
//
// Design.  The TPU grid (batch, head, q block, kv block) ran in order on
// one core, carrying the accumulator in VMEM across the kv axis.  On Hopper
// a block owns one output tile and sweeps the other axis in a loop:
//   * forward: one block per (64-row query tile, q head, batch row),
//     heaviest (last) query tiles first; Q stays on chip while 64-key K/V
//     tiles of the kv head stream through shared memory; tiles strictly
//     above the diagonal are never loaded;
//   * dK/dV: one block per (64-key tile, kv head, batch row); it sweeps the
//     query tiles at and below the diagonal of EVERY q head of its group,
//     so the g heads' contributions sum in f32 registers and dK/dV are
//     written once, with no atomics and no bf16 round trip;
//   * dQ: one block per (query tile, q head, batch row) sweeping the key
//     tiles up to the diagonal (a pass of its own: deterministic, no
//     atomics); delta comes from a one-warp-per-row pre-pass;
//   * a sequence length that is not a multiple of the tile is masked in the
//     last tile (rows and keys past S load as zero and get zero weight).
// Two sets of kernels share that structure:
//   * bf16 (the training path): tensor cores through warp-level mma.sync
//     m16n8k16 (bf16 operands, f32 sums), 4 warps a block, each warp owning
//     16 rows of the output tile; operands come from shared-memory tiles
//     (rows padded by 16 bytes, so ldmatrix is conflict-free) by ldmatrix,
//     transposed where the product needs it; the softmax runs in f32 on the
//     accumulator fragments, and P and dS are rounded to bf16 only as the
//     operands of the next product, as FlashAttention-2 does;
//   * f32 (the parity runs): CUDA cores, exact f32 products; 256 threads a
//     block, each holding a 4 x 4 score micro-tile and a 4 x (D / 16) slice
//     of its accumulator; tile rows are padded to an odd number of floats
//     so 16 lanes reading one column hit 16 banks.
// head_dim D is a template parameter, built for the head dims of the ported
// configs (16: qwen3 smoke, 64, 128: qwen3).
//
// What bounds it on the H100: operations.  Causal attention is
// 2 * B * H * S^2 * D flops forward (~2.5x that backward) against
// (3 + 1) * B * S * H * D elements moved, hundreds of flops per byte; the
// bound is the tensor cores' 989 TFLOP/s (bf16).  Known gaps, left for
// later work: wgmma (warpgroup) products and TMA / cp.async double-buffered
// K/V tiles (a tile's loads now wait behind a barrier, and mma.sync reaches
// only part of Hopper's tensor-core rate), larger query tiles per block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA-core kernels (and the delta pre-pass both sets share)
// ---------------------------------------------------------------------------

constexpr int BM = 64;                  // query rows per tile
constexpr int BN = 64;                  // keys per tile
constexpr int TX = 16;                  // threads along keys / head dims
constexpr int TY = 16;                  // threads along query rows
constexpr int THREADS = TX * TY;
constexpr int RI = BM / TY;             // score rows per thread
constexpr int CJ = BN / TX;             // score keys per thread
constexpr int PS = BN + 1;              // row stride of a P / dS tile (f32)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Row stride (in floats) of a D-wide f32 tile: odd, so 16 rows read at
// one column fall in 16 banks.
template <int D>
__host__ __device__ constexpr int sw() {
  return D + 1;
}

// Copy rows [r0, r0 + rows) of head h, batch row b of a (B, S, Hx, D) f32
// tensor into a padded tile; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int b, int r0, int h, int S,
                                          int Hx, int rows) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, d = i % D, s = r0 + r;
    dst[r * sw<D>() + d] =
        s < S ? src[(((size_t)b * S + s) * Hx + h) * D + d] : 0.f;
  }
}

__device__ __forceinline__ bool finite(float x) {
  return x > -INFINITY && x < INFINITY;   // false for +-inf and NaN
}

// Reductions over the 16 lanes (tx = 0..15) that share a score row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a[i][j] += rowA(ty + TY i) . rowB(tx + TX j) over the D dims of two
// padded tiles (the score micro-tile of a thread).
template <int D>
__device__ __forceinline__ void dot_tiles(float (&a)[RI][CJ], const float* A,
                                          const float* Bt, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = A[(ty + TY * i) * sw<D>() + d];
#pragma unroll
    for (int j = 0; j < CJ; ++j) bv[j] = Bt[(tx + TX * j) * sw<D>() + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) a[i][j] = fmaf(av[i], bv[j], a[i][j]);
  }
}

// delta[b, s, h] = sum_d out * dout, one warp per row.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, size_t rows) {
  const size_t row =
      (size_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc += to_f32(out[row * D + d]) * to_f32(dout[row * D + d]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (size_t)(BM + 2 * BN) * sw<D>() +
         sizeof(float) * (size_t)BM * PS;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int Hkv, int causal,
                 float scale) {
  constexpr int SW = sw<D>();
  constexpr int DJ = D / TX;            // head dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // BM x SW
  float* Ks = Qs + BM * SW;             // BN x SW
  float* Vs = Ks + BN * SW;             // BN x SW
  float* Ps = Vs + BN * SW;             // BM x PS

  const int n_qt = (S + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BM;   // longest sweeps first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  load_tile<D>(Qs, q, b, q0, h, S, H, BM);

  float acc[RI][DJ], m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }

  int n_kt = (S + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);  // skip above diag
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();                    // the last tile's readers are done
    load_tile<D>(Ks, k, b, k0, hk, S, Hkv, BN);
    load_tile<D>(Vs, v, b, k0, hk, S, Hkv, BN);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    dot_tiles<D>(s, Qs, Ks, ty, tx);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qr = q0 + ty + TY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kc = k0 + tx + TX * j;
        const bool ok = kc < S && (!causal || kc <= qr);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        Ps[(ty + TY * i) * PS + tx + TX * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) acc[i][jd] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + TY * i) * PS + c];
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) vv[jd] = Vs[c * SW + tx + TX * jd];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd)
          acc[i][jd] = fmaf(pv[i], vv[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    const size_t base = (((size_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd)
      out[base + tx + TX * jd] = acc[i][jd] * inv;
    if (tx == 0)
      lse[((size_t)b * S + row) * H + h] =
          m[i] == -INFINITY ? -INFINITY : m[i] + logf(lc);
  }
}

// P and dS of one (query tile, key tile) pair into shared memory: rows
// ty + TY i of the query tile, keys tx + TX j.  lse_r / delta_r are the
// thread's rows' values (0 for rows past S, whose weights are masked).
template <int D>
__device__ __forceinline__ void p_ds_tile(
    float* Ps, float* dSs, const float* Qs, const float* dOs,
    const float* Ks, const float* Vs, const float (&lse_r)[RI],
    const float (&delta_r)[RI], int q0, int k0, int S, int causal,
    float scale, int ty, int tx) {
  float s[RI][CJ], dp[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
  dot_tiles<D>(s, Qs, Ks, ty, tx);
  dot_tiles<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qr = q0 + ty + TY * i;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int kc = k0 + tx + TX * j;
      const bool ok = qr < S && kc < S && (!causal || kc <= qr);
      const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
      const int at = (ty + TY * i) * PS + tx + TX * j;
      if (Ps) Ps[at] = p;
      dSs[at] = p * (dp[i][j] - delta_r[i]) * scale;
    }
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (size_t)(2 * BM + 2 * BN) * sw<D>() +
         sizeof(float) * (size_t)(2 * BM * PS + 2 * BM);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int S, int H, int Hkv, int causal,
                      float scale) {
  constexpr int SW = sw<D>();
  constexpr int DJ = D / TX;
  extern __shared__ float smem[];
  float* Ks = smem;                     // BN x SW
  float* Vs = Ks + BN * SW;             // BN x SW
  float* Qs = Vs + BN * SW;             // BM x SW
  float* dOs = Qs + BM * SW;            // BM x SW
  float* Ps = dOs + BM * SW;            // BM x PS
  float* dSs = Ps + BM * PS;            // BM x PS
  float* lse_s = dSs + BM * PS;         // BM
  float* delta_s = lse_s + BM;          // BM

  const int k0 = blockIdx.x * BN;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  load_tile<D>(Ks, k, b, k0, hk, S, Hkv, BN);
  load_tile<D>(Vs, v, b, k0, hk, S, Hkv, BN);

  // rows of these accumulators are keys k0 + ty + TY i, columns head dims
  float dk_acc[RI][DJ], dv_acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) dk_acc[i][jd] = dv_acc[i][jd] = 0.f;

  const int n_qt = (S + BM - 1) / BM;
  const int qt0 = causal ? k0 / BM : 0;   // query tiles below the diagonal
  for (int j = 0; j < g; ++j) {
    const int h = hk * g + j;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();
      load_tile<D>(Qs, q, b, q0, h, S, H, BM);
      load_tile<D>(dOs, dout, b, q0, h, S, H, BM);
      for (int r = threadIdx.x; r < BM; r += THREADS) {
        const int row = q0 + r;
        float ls = 0.f, dl = 0.f;
        if (row < S) {
          ls = lse[((size_t)b * S + row) * H + h];
          dl = delta[((size_t)b * S + row) * H + h];
        }
        lse_s[r] = finite(ls) ? ls : 0.f;
        delta_s[r] = dl;
      }
      __syncthreads();
      float lse_r[RI], delta_r[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        lse_r[i] = lse_s[ty + TY * i];
        delta_r[i] = delta_s[ty + TY * i];
      }
      p_ds_tile<D>(Ps, dSs, Qs, dOs, Ks, Vs, lse_r, delta_r, q0, k0, S,
                   causal, scale, ty, tx);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BM; ++r) {
        float pr[RI], dsr[RI], dov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pr[i] = Ps[r * PS + ty + TY * i];
          dsr[i] = dSs[r * PS + ty + TY * i];
        }
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd) {
          dov[jd] = dOs[r * SW + tx + TX * jd];
          qv[jd] = Qs[r * SW + tx + TX * jd];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int jd = 0; jd < DJ; ++jd) {
            dv_acc[i][jd] = fmaf(pr[i], dov[jd], dv_acc[i][jd]);
            dk_acc[i][jd] = fmaf(dsr[i], qv[jd], dk_acc[i][jd]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty + TY * i;
    if (key >= S) continue;
    const size_t base = (((size_t)b * S + key) * Hkv + hk) * D;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) {
      dk[base + tx + TX * jd] = dk_acc[i][jd];
      dv[base + tx + TX * jd] = dv_acc[i][jd];
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t)(2 * BM + 2 * BN) * sw<D>() +
         sizeof(float) * (size_t)BM * PS;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int H, int Hkv, int causal, float scale) {
  constexpr int SW = sw<D>();
  constexpr int DJ = D / TX;
  extern __shared__ float smem[];
  float* Qs = smem;                     // BM x SW
  float* dOs = Qs + BM * SW;            // BM x SW
  float* Ks = dOs + BM * SW;            // BN x SW
  float* Vs = Ks + BN * SW;             // BN x SW
  float* dSs = Vs + BN * SW;            // BM x PS

  const int n_qt = (S + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  load_tile<D>(Qs, q, b, q0, h, S, H, BM);
  load_tile<D>(dOs, dout, b, q0, h, S, H, BM);
  float lse_r[RI], delta_r[RI], dq_acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    float ls = 0.f, dl = 0.f;
    if (row < S) {
      ls = lse[((size_t)b * S + row) * H + h];
      dl = delta[((size_t)b * S + row) * H + h];
    }
    lse_r[i] = finite(ls) ? ls : 0.f;
    delta_r[i] = dl;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) dq_acc[i][jd] = 0.f;
  }

  int n_kt = (S + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<D>(Ks, k, b, k0, hk, S, Hkv, BN);
    load_tile<D>(Vs, v, b, k0, hk, S, Hkv, BN);
    __syncthreads();
    p_ds_tile<D>(nullptr, dSs, Qs, dOs, Ks, Vs, lse_r, delta_r, q0, k0, S,
                 causal, scale, ty, tx);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float dsv[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = dSs[(ty + TY * i) * PS + c];
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) kv[jd] = Ks[c * SW + tx + TX * jd];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd)
          dq_acc[i][jd] = fmaf(dsv[i], kv[jd], dq_acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= S) continue;
    const size_t base = (((size_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd)
      dq[base + tx + TX * jd] = dq_acc[i][jd];
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels (mma.sync m16n8k16, bf16 operands, f32 sums)
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int TC_THREADS = 128;         // 4 warps
constexpr int TQ = 64;                  // forward / dQ: query rows per block
constexpr int TK = 64;                  // keys per tile; dK/dV: per block
constexpr int TQB = 32;                 // dK/dV: query rows per inner tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives its fragment of each
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of a 16-key k-step from two 8-key accumulator tiles.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack2(lo[0], lo[1]);
  a[1] = pack2(lo[2], lo[3]);
  a[2] = pack2(hi[0], hi[1]);
  a[3] = pack2(hi[2], hi[3]);
}

// Rows [r0, r0 + rows) of head h, batch row b of a (B, S, Hx, D) bf16
// tensor into a tile with row stride D + 8, 16 bytes at a time; rows at or
// past S are zero.
template <int D>
__device__ __forceinline__ void tc_load(bf16* dst, const bf16* src, int b,
                                        int r0, int h, int S, int Hx,
                                        int rows) {
  constexpr int C = D / 8, DP = D + 8;
  for (int i = threadIdx.x; i < rows * C; i += TC_THREADS) {
    const int r = i / C, c = i % C, s = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      val = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * S + s) * Hx + h) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * DP + c * 8) = val;
  }
}

// Fragment addresses (lane l: li = l / 8 picks the matrix, lr = l % 8 the
// row).  An A operand (16 rows x 16 cols) from row-major rows; a pair of B
// operands (two 8-col n tiles x 16 k) from rows that hold n (k contiguous:
// "nk"); and from rows that hold k (n contiguous: "kn", transposed load).
template <int DP>
__device__ __forceinline__ const bf16* frag_a(const bf16* tile, int row0,
                                              int col0, int li, int lr) {
  return tile + (row0 + (li % 2) * 8 + lr) * DP + col0 + (li / 2) * 8;
}
template <int DP>
__device__ __forceinline__ const bf16* frag_b_nk(const bf16* tile, int n0,
                                                 int k0, int li, int lr) {
  return tile + (n0 + (li / 2) * 8 + lr) * DP + k0 + (li % 2) * 8;
}
template <int DP>
__device__ __forceinline__ const bf16* frag_b_kn(const bf16* tile, int k0,
                                                 int n0, int li, int lr) {
  return tile + (k0 + (li % 2) * 8 + lr) * DP + n0 + (li / 2) * 8;
}

template <int D>
constexpr size_t fwd_tc_smem() {
  return sizeof(bf16) * (size_t)(TQ + 2 * TK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int S, int H, int Hkv,
                    int causal, float scale) {
  constexpr int DP = D + 8, KS = D / 16, DT = D / 8;
  extern __shared__ uint4 tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);   // TQ x DP
  bf16* Ks = Qs + TQ * DP;                        // TK x DP
  bf16* Vs = Ks + TK * DP;                        // TK x DP

  const int n_qt = (S + TQ - 1) / TQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * TQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, li = lane / 8, lr = lane % 8;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  tc_load<D>(Qs, q, b, q0, h, S, H, TQ);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm4(qf[kk], frag_a<DP>(Qs, warp * 16, kk * 16, li, lr));

  float acc[DT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  int n_kt = (S + TK - 1) / TK;
  if (causal) n_kt = min(n_kt, (q0 + TQ - 1) / TK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TK;
    __syncthreads();
    tc_load<D>(Ks, k, b, k0, hk, S, Hkv, TK);
    tc_load<D>(Vs, v, b, k0, hk, S, Hkv, TK);
    __syncthreads();

    float s[TK / 8][4];
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        uint32_t r[4];
        ldsm4(r, frag_b_nk<DP>(Ks, np * 16, kk * 16, li, lr));
        mma(s[2 * np], qf[kk], r[0], r[1]);
        mma(s[2 * np + 1], qf[kk], r[2], r[3]);
      }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = key < S && (!causal || key <= row[e / 2]);
        s[nt][e] = ok ? s[nt][e] * scale : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    float m_safe[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      m_safe[i] = m_new == -INFINITY ? 0.f : m_new;
      corr[i] = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[nt][e] == -INFINITY ? 0.f : expf(s[nt][e] - m_safe[e / 2]);
        s[nt][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] *= corr[e / 2];

#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldsm4t(r, frag_b_kn<DP>(Vs, kk * 16, dp * 16, li, lr));
        mma(acc[2 * dp], pa, r[0], r[1]);
        mma(acc[2 * dp + 1], pa, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f), inv = 1.f / lc;
    bf16* o = out + (((size_t)b * S + row[i]) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(o + dt * 8) =
          pack2(acc[dt][2 * i] * inv, acc[dt][2 * i + 1] * inv);
    if (t == 0)
      lse[((size_t)b * S + row[i]) * H + h] =
          m[i] == -INFINITY ? -INFINITY : m[i] + logf(lc);
  }
}

template <int D>
constexpr size_t dkdv_tc_smem() {
  return sizeof(bf16) * (size_t)(2 * TK + 2 * TQB) * (D + 8) +
         sizeof(float) * 2 * TQB;
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                         int H, int Hkv, int causal, float scale) {
  constexpr int DP = D + 8, KS = D / 16, DT = D / 8, NT = TQB / 8;
  extern __shared__ uint4 tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);    // TK x DP
  bf16* Vs = Ks + TK * DP;                         // TK x DP
  bf16* Qs = Vs + TK * DP;                         // TQB x DP
  bf16* dOs = Qs + TQB * DP;                       // TQB x DP
  float* lse_s = reinterpret_cast<float*>(dOs + TQB * DP);  // TQB
  float* delta_s = lse_s + TQB;                              // TQB

  const int k0 = blockIdx.x * TK;
  const int hk = blockIdx.y, b = blockIdx.z, gq = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, li = lane / 8, lr = lane % 8;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  tc_load<D>(Ks, k, b, k0, hk, S, Hkv, TK);
  tc_load<D>(Vs, v, b, k0, hk, S, Hkv, TK);

  // rows: this warp's 16 keys; columns: head dims
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  const int n_qt = (S + TQB - 1) / TQB;
  const int qt0 = causal ? k0 / TQB : 0;
  for (int j = 0; j < gq; ++j) {
    const int h = hk * gq + j;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * TQB;
      __syncthreads();
      tc_load<D>(Qs, q, b, q0, h, S, H, TQB);
      tc_load<D>(dOs, dout, b, q0, h, S, H, TQB);
      for (int r = threadIdx.x; r < TQB; r += TC_THREADS) {
        const int qr = q0 + r;
        float ls = 0.f, dl = 0.f;
        if (qr < S) {
          ls = lse[((size_t)b * S + qr) * H + h];
          dl = delta[((size_t)b * S + qr) * H + h];
        }
        lse_s[r] = finite(ls) ? ls : 0.f;
        delta_s[r] = dl;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x TQB queries per warp
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        ldsm4(ka, frag_a<DP>(Ks, warp * 16, kk * 16, li, lr));
        ldsm4(va, frag_a<DP>(Vs, warp * 16, kk * 16, li, lr));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldsm4(r, frag_b_nk<DP>(Qs, np * 16, kk * 16, li, lr));
          mma(s[2 * np], ka, r[0], r[1]);
          mma(s[2 * np + 1], ka, r[2], r[3]);
          ldsm4(r, frag_b_nk<DP>(dOs, np * 16, kk * 16, li, lr));
          mma(dp[2 * np], va, r[0], r[1]);
          mma(dp[2 * np + 1], va, r[2], r[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + 2 * t + (e & 1), qr = q0 + qc;
          const int kr = key[e / 2];
          const bool ok = qr < S && kr < S && (!causal || kr <= qr);
          const float p = ok ? expf(s[nt][e] * scale - lse_s[qc]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - delta_s[qc]) * scale;
        }

      // dV += P^T dO and dK += dS^T Q over the TQB queries
#pragma unroll
      for (int kq = 0; kq < NT / 2; ++kq) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, s[2 * kq], s[2 * kq + 1]);
        acc_to_a(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int dpp = 0; dpp < D / 16; ++dpp) {
          uint32_t r[4];
          ldsm4t(r, frag_b_kn<DP>(dOs, kq * 16, dpp * 16, li, lr));
          mma(dv_acc[2 * dpp], pa, r[0], r[1]);
          mma(dv_acc[2 * dpp + 1], pa, r[2], r[3]);
          ldsm4t(r, frag_b_kn<DP>(Qs, kq * 16, dpp * 16, li, lr));
          mma(dk_acc[2 * dpp], da, r[0], r[1]);
          mma(dk_acc[2 * dpp + 1], da, r[2], r[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= S) continue;
    const size_t base = (((size_t)b * S + key[i]) * Hkv + hk) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + base + dt * 8) =
          pack2(dk_acc[dt][2 * i], dk_acc[dt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + dt * 8) =
          pack2(dv_acc[dt][2 * i], dv_acc[dt][2 * i + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_tc_smem() {
  return sizeof(bf16) * (size_t)(2 * TQ + 2 * TK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int S, int H, int Hkv, int causal, float scale) {
  constexpr int DP = D + 8, KS = D / 16, DT = D / 8;
  extern __shared__ uint4 tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);    // TQ x DP
  bf16* dOs = Qs + TQ * DP;                        // TQ x DP
  bf16* Ks = dOs + TQ * DP;                        // TK x DP
  bf16* Vs = Ks + TK * DP;                         // TK x DP

  const int n_qt = (S + TQ - 1) / TQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * TQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, li = lane / 8, lr = lane % 8;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  tc_load<D>(Qs, q, b, q0, h, S, H, TQ);
  tc_load<D>(dOs, dout, b, q0, h, S, H, TQ);
  float lse_r[2], delta_r[2], dq_acc[DT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float ls = 0.f, dl = 0.f;
    if (row[i] < S) {
      ls = lse[((size_t)b * S + row[i]) * H + h];
      dl = delta[((size_t)b * S + row[i]) * H + h];
    }
    lse_r[i] = finite(ls) ? ls : 0.f;
    delta_r[i] = dl;
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[dt][e] = 0.f;

  int n_kt = (S + TK - 1) / TK;
  if (causal) n_kt = min(n_kt, (q0 + TQ - 1) / TK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TK;
    __syncthreads();
    tc_load<D>(Ks, k, b, k0, hk, S, Hkv, TK);
    tc_load<D>(Vs, v, b, k0, hk, S, Hkv, TK);
    __syncthreads();

    float s[TK / 8][4], dp[TK / 8][4];
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm4(qa, frag_a<DP>(Qs, warp * 16, kk * 16, li, lr));
      ldsm4(oa, frag_a<DP>(dOs, warp * 16, kk * 16, li, lr));
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        uint32_t r[4];
        ldsm4(r, frag_b_nk<DP>(Ks, np * 16, kk * 16, li, lr));
        mma(s[2 * np], qa, r[0], r[1]);
        mma(s[2 * np + 1], qa, r[2], r[3]);
        ldsm4(r, frag_b_nk<DP>(Vs, np * 16, kk * 16, li, lr));
        mma(dp[2 * np], oa, r[0], r[1]);
        mma(dp[2 * np + 1], oa, r[2], r[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = k0 + nt * 8 + 2 * t + (e & 1), i = e / 2;
        const bool ok = row[i] < S && kc < S && (!causal || kc <= row[i]);
        const float p = ok ? expf(s[nt][e] * scale - lse_r[i]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - delta_r[i]) * scale;
      }
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dpp = 0; dpp < D / 16; ++dpp) {
        uint32_t r[4];
        ldsm4t(r, frag_b_kn<DP>(Ks, kk * 16, dpp * 16, li, lr));
        mma(dq_acc[2 * dpp], da, r[0], r[1]);
        mma(dq_acc[2 * dpp + 1], da, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    bf16* o = dq + (((size_t)b * S + row[i]) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(o + dt * 8) =
          pack2(dq_acc[dt][2 * i], dq_acc[dt][2 * i + 1]);
  }
}

// Raise a kernel's dynamic shared-memory cap to what it uses (above 48 KB
// a launch is refused without it).  The attribute is per device, so it is
// set before every launch (a host-side call of about a microsecond).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t fwd_d(const void* q, const void* k, const void* v, void* out,
                  void* lse, int B, int S, int H, int Hkv, int causal,
                  cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = fwd_tc_smem<D>();
    const cudaError_t set = allow_smem(flash_fwd_tc_kernel<D>, smem);
    if (set != cudaSuccess) return set;
    flash_fwd_tc_kernel<D>
        <<<dim3((S + TQ - 1) / TQ, H, B), TC_THREADS, smem, stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(out),
            static_cast<float*>(lse), S, H, Hkv, causal, scale);
  } else {
    constexpr size_t smem = fwd_smem<D>();
    const cudaError_t set = allow_smem(flash_fwd_kernel<D>, smem);
    if (set != cudaSuccess) return set;
    flash_fwd_kernel<D>
        <<<dim3((S + BM - 1) / BM, H, B), THREADS, smem, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<T*>(out),
            static_cast<float*>(lse), S, H, Hkv, causal, scale);
  }
  return cudaGetLastError();
}

// The delta pre-pass, then dK/dV, then dQ: tensor-core kernels for bf16,
// CUDA-core kernels for f32.
template <typename T, int D>
cudaError_t bwd_d(const void* q, const void* k, const void* v,
                  const void* out, const void* dout, const void* lse,
                  void* delta, void* dq, void* dk, void* dv, int B, int S,
                  int H, int Hkv, int causal, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const size_t rows = (size_t)B * S * H;
  const unsigned delta_blocks =
      (unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32));
  flash_bwd_delta_kernel<T, D><<<delta_blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem_kv = dkdv_tc_smem<D>(), smem_q = dq_tc_smem<D>();
    err = allow_smem(flash_bwd_dkdv_tc_kernel<D>, smem_kv);
    if (err != cudaSuccess) return err;
    err = allow_smem(flash_bwd_dq_tc_kernel<D>, smem_q);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_tc_kernel<D>
        <<<dim3((S + TK - 1) / TK, Hkv, B), TC_THREADS, smem_kv, stream>>>(
            q_, k_, v_, do_, lse_, delta_, static_cast<T*>(dk),
            static_cast<T*>(dv), S, H, Hkv, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_tc_kernel<D>
        <<<dim3((S + TQ - 1) / TQ, H, B), TC_THREADS, smem_q, stream>>>(
            q_, k_, v_, do_, lse_, delta_, static_cast<T*>(dq), S, H, Hkv,
            causal, scale);
  } else {
    constexpr size_t smem_kv = dkdv_smem<D>(), smem_q = dq_smem<D>();
    err = allow_smem(flash_bwd_dkdv_kernel<D>, smem_kv);
    if (err != cudaSuccess) return err;
    err = allow_smem(flash_bwd_dq_kernel<D>, smem_q);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<D>
        <<<dim3((S + BN - 1) / BN, Hkv, B), THREADS, smem_kv, stream>>>(
            q_, k_, v_, do_, lse_, delta_, static_cast<T*>(dk),
            static_cast<T*>(dv), S, H, Hkv, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<D>
        <<<dim3((S + BM - 1) / BM, H, B), THREADS, smem_q, stream>>>(
            q_, k_, v_, do_, lse_, delta_, static_cast<T*>(dq), S, H, Hkv,
            causal, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int S, int H, int Hkv, int D, int causal,
                cudaStream_t stream) {
  switch (D) {
    case 16:
      return fwd_d<T, 16>(q, k, v, out, lse, B, S, H, Hkv, causal, stream);
    case 64:
      return fwd_d<T, 64>(q, k, v, out, lse, B, S, H, Hkv, causal, stream);
    case 128:
      return fwd_d<T, 128>(q, k, v, out, lse, B, S, H, Hkv, causal, stream);
    default:
      return cudaErrorInvalidValue;  // the wrapper refuses other head dims
  }
}

template <typename T>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, int B, int S, int H, int Hkv, int D,
                int causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return bwd_d<T, 16>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S,
                          H, Hkv, causal, stream);
    case 64:
      return bwd_d<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S,
                          H, Hkv, causal, stream);
    case 128:
      return bwd_d<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S,
                           H, Hkv, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points, loaded with ctypes by repro_torch.kernels.flash_attention.
// Shapes: q/out/dout/dq (B, S, H, D); k/v/dk/dv (B, S, Hkv, D); lse and the
// delta scratch (B, S, H) f32; all contiguous, 4-byte aligned, on the
// current device; D in {16, 64, 128}, H a multiple of Hkv.  Each launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int B, int S, int H, int Hkv, int D,
                                         int causal, int is_bf16,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? fwd<__nv_bfloat16>(q, k, v, out, lse, B, S, H, Hkv, D,
                                   causal, s)
              : fwd<float>(q, k, v, out, lse, B, S, H, Hkv, D, causal, s);
  return static_cast<int>(err);
}

extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* out,
                                         const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk,
                                         void* dv, int B, int S, int H,
                                         int Hkv, int D, int causal,
                                         int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? bwd<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk,
                                   dv, B, S, H, Hkv, D, causal, s)
              : bwd<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S,
                           H, Hkv, D, causal, s);
  return static_cast<int>(err);
}
