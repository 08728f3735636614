// Flash-attention forward and backward kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:85
// (`flash_attention`, body `_kernel`) and the backward its model twin writes
// by hand, src/repro/models/layers.py:328 (`_flash_vjp_bwd`, with
// `flash_attention_jax` and `_flash_fwd_scan`): causal (or full)
// grouped-query attention over q (B, S, H, D) and k/v (B, S, Hkv, D) in the
// model's own layout, q head h reading kv head h / (H / Hkv).
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
// What bounds it on the H100: operations.  Causal attention is
// 2 * B * H * S^2 * D flops forward (2.5x that backward) against
// (3 + 1) * B * S * H * D elements moved, hundreds of flops per byte, so
// the bound is the tensor cores' 989 TFLOP/s (bf16).  The TPU grid (batch,
// head, q block, kv block) ran in order on one core, carrying the
// accumulator in VMEM across the kv axis; here a block owns one output tile
// and sweeps the other axis in a loop.
//
// bf16 (the training path): warp-specialised, TMA + wgmma, after
// FlashAttention-3 without its FP8 parts.  A block is three warpgroups:
// two consumers of 64 rows each and one producer, whose one thread issues
// every copy; `setmaxnreg` gives the producer's registers to the consumers
// (24 / 240 a thread).  What the design does about each limit of the
// mma.sync kernels it replaced:
//   * tensor-core rate: every product is a warpgroup `wgmma` (m64, bf16
//     operands, f32 sums in registers); `mma.sync` reaches only part of
//     Hopper's rate;
//   * copies that stall the products: tiles arrive by TMA into a ring of
//     STAGES buffers guarded by full/empty `mbarrier` pairs, so the next
//     tile is in flight while the consumers multiply; no thread spends
//     registers or instructions on loads;
//   * small tiles: the forward block holds 128 query rows and sweeps
//     128-key tiles (K/V re-read from L2 by half as many blocks); the
//     backward block holds 128 keys and sweeps 64-row query tiles;
//   * a separate dQ pass: the backward is one pass (5 products, not 7).
// The tensor maps are 4-D over (B, S, Hx, D) (dims {D, Hx, S, B}), boxes of
// 64 columns with 128-byte swizzle for D >= 64 (two boxes a row at D = 128)
// and of 16 columns with 32-byte swizzle at D = 16; the `wgmma` shared-
// memory descriptors name the same swizzle.  TMA's zero fill past S
// replaces masked loads at a ragged S; scores of keys past S are masked.
// They are encoded on the host with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__
// parameters.
//   * forward: one block per (128-row query tile, q head, batch row),
//     launched longest causal sweeps first across all heads and batch rows
//     (the short ones fill the last wave).  The producer loads the Q tile
//     once, then the kv head's K and V tiles up to the diagonal (tiles
//     above it are never loaded).  S = Q K^T is wgmma m64n128k16 with both
//     operands in shared memory (K-major); the softmax runs in f32 on the
//     accumulator fragments (in base 2, the scale folded in), only the
//     tiles that cross the diagonal or S are masked; O += P V takes P,
//     rounded to bf16, as a register A operand and V from shared memory
//     through the descriptor's transpose bit.  O is stored from registers,
//     lse as above.  The two consumer warpgroups share the tensor cores:
//     one's softmax runs while the other's products do (overlapping a
//     warpgroup's softmax with its own previous P V, or taking turns by
//     named barrier as FA3's "ping-pong" does, measured slower here).
//   * backward: a pre-pass writes lse (base 2) and delta as (B, H, S)
//     rows; then one block per (128-key tile, kv head, batch row) loads K
//     and V once and streams Q, dO, lse and delta tiles of every q head of
//     its group, at and below the diagonal.  Per tile each consumer
//     warpgroup (64 keys) computes S^T = K Q^T and dP^T = V dO^T, then
//     P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale in
//     registers, dV += P^T dO and dK += dS^T Q with P^T and dS^T as
//     register operands (dK/dV summed over the group in registers and
//     written once: no atomics, deterministic), and dQ = dS K from dS^T
//     staged in shared memory, each warpgroup taking half of D.  Each
//     warpgroup's 64 x D / 2 block of dQ goes through shared memory into
//     an f32 (B, S, H, D) workspace by a TMA bulk reduce-add
//     (cp.reduce.async.bulk.tensor; the wrapper zeroes the workspace, 128
//     MB at the train cell's B = 4, freed after the call), and a cast pass
//     writes the bf16 dq.  Blocks launch key tile 0 (the longest causal
//     sweep) of every kv head and batch row first.  The order of the dQ
//     additions varies, so dq's bits vary from run to run (within
//     tolerance); dk and dv are written once and are bit-identical.
//
// f32 (the parity runs): CUDA cores, exact f32 products; 256 threads a
// block, each holding a 4 x 4 score micro-tile and a 4 x (D / 16) slice of
// its accumulator; 64-row tiles, rows padded to an odd number of floats so
// 16 lanes reading one column hit 16 banks.  The forward: one block per
// query tile sweeping 64-key tiles; dK/dV: one block per key tile over the
// group's heads; dQ: a pass of its own; delta: a one-warp-per-row
// pre-pass.  Rows and keys past S load as zero and get zero weight.
//
// head_dim D is a template parameter, built for the head dims of the ported
// configs (16: qwen3 smoke, 64, 128: qwen3).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA-core kernels and their delta pre-pass
// ---------------------------------------------------------------------------

constexpr int BM = 64;                  // query rows per tile
constexpr int BN = 64;                  // keys per tile
constexpr int TX = 16;                  // threads along keys / head dims
constexpr int TY = 16;                  // threads along query rows
constexpr int THREADS = TX * TY;
constexpr int RI = BM / TY;             // score rows per thread
constexpr int CJ = BN / TX;             // score keys per thread
constexpr int PS = BN + 1;              // row stride of a P / dS tile (f32)


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
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const float* __restrict__ out,
                       const float* __restrict__ dout,
                       float* __restrict__ delta, size_t rows) {
  const size_t row =
      (size_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc += out[row * D + d] * dout[row * D + d];
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
// bf16: warp-specialised TMA + wgmma kernels
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int WG = 128;                 // threads of a warpgroup
constexpr int TC_THREADS = 3 * WG;      // consumers 0 and 1, producer 2
constexpr int STAGES = 2;               // ring of K/V (fwd), Q/dO (bwd) tiles
constexpr int FQ = 128;                 // forward: query rows per block
constexpr int FK = 128;                 // forward: keys per tile
constexpr int BK = 128;                 // backward: keys per block
constexpr int BQ = 64;                  // backward: query rows per tile
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A tile of `rows` x D bf16 as TMA lays it into shared memory: NCB column
// blocks of CB columns, each `rows` rows of RB bytes, swizzled over atoms
// of 8 rows (SBO bytes): 128-byte swizzle for D >= 64, 32-byte at D = 16.
template <int D>
struct Geo {
  static constexpr int CB = D >= 64 ? 64 : D;
  static constexpr int NCB = D / CB;
  static constexpr int RB = CB * 2;
  static constexpr int SBO = 8 * RB;
  static constexpr int LAYOUT = D >= 64 ? 1 : 3;   // descriptor swizzle code
  static_assert(D == 16 || D % 64 == 0, "head dim");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x in one MUFU instruction (flushes denormal results to 0; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The dynamic shared memory, 1024-byte aligned (the 128-byte swizzle's
// atom); each kernel asks for 1024 bytes of slack.
__device__ __forceinline__ uint8_t* smem_1k(uint8_t* raw) {
  const uint32_t pad = (1024u - smem_u32(raw) % 1024u) % 1024u;
  return raw + pad;
}

// --- mbarriers, TMA, named barriers, register hand-over -------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map ({d, head, row, batch} coordinates).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Rows [row0, row0 + rows) of head h, batch row b: one box per column block.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int row0,
                                          int h, int b) {
#pragma unroll
  for (int cb = 0; cb < Geo<D>::NCB; ++cb)
    tma_load(dst + cb * rows * Geo<D>::RB, map, bar, cb * Geo<D>::CB, h,
             row0, b);
}

// Add a 4-D box of f32 from shared memory into device memory.
__device__ __forceinline__ void tma_reduce_add(const void* src,
                                               const CUtensorMap* map, int c0,
                                               int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait for this thread's bulk copies: until their shared-memory source has
// been read (READ) or until they are complete.
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void wg_sync(int wg) {      // one consumer WG
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(WG) : "memory");
}
__device__ __forceinline__ void consumers_sync() {   // both consumer WGs
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * WG) : "memory");
}
// generic-proxy shared-memory writes made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// --- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle layout (1: 128-byte, 3: 32-byte).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)layout << 62;
}
// K-major operand (the product's K runs along the tile's D columns): rows
// [row0, row0 + 64 or N) of a `rows`-row tile at `tile`, k-step kk.
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0,
                                           int kk) {
  using G = Geo<D>;
  const int col = kk * 16;
  return desc(tile + (col / G::CB) * rows * G::RB + row0 * G::RB +
                  (col % G::CB) * 2,
              16, G::SBO, G::LAYOUT);
}
// MN-major B operand (the product's K runs along the tile's rows, its N
// along the D columns from n0): k-step kk of a `rows`-row tile.
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk,
                                            int n0) {
  using G = Geo<D>;
  return desc(tile + (n0 / G::CB) * rows * G::RB + kk * 16 * G::RB +
                  (n0 % G::CB) * 2,
              rows * G::RB, G::SBO, G::LAYOUT);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {   // every committed group
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin registers an in-flight wgmma reads or writes until its wait: the
// compiler sees them used here, so it neither moves nor reuses them before.
template <int R>
__device__ __forceinline__ void keep(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void keep(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// The A operands of the k-steps of a product from an f32 accumulator: k-step
// kk (16 columns) is n8 tiles 2 kk and 2 kk + 1, in A's fragment order.
template <int K>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[K][4],
                                         const float (&d)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack2(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
}

// m64nNk16, f32 += bf16 x bf16.  wgmma_ss: A and B from shared memory
// (TA / TB: 0 K-major, 1 MN-major); wgmma_rs: A from registers.  d holds
// the thread's N / 2 accumulators: d[4 n + e] is row 16 warp + lane / 4 +
// 8 (e / 2), column 8 n + 2 (lane % 4) + e % 2 of the 64 x N tile.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, %7, %8;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// Forward shared memory (bytes from the 1024-aligned base): the Q tile,
// STAGES K tiles, STAGES V tiles, then the barriers.
template <int D>
struct FwdSmem {
  static constexpr int TILE = FK * D * 2;
  static constexpr int Q = 0, K = FQ * D * 2, V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;
  static constexpr size_t BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// Scale, mask and exponentiate one 64 x FK score tile in place (base 2):
// updates the running max m and this thread's share of the row sum l, and
// returns in corr the factor the accumulator must be rescaled by.  Only a
// tile that reaches past S or crosses the diagonal is masked.
__device__ __forceinline__ void softmax_tile(float (&s)[FK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int S, int causal,
                                             int wg_row0, int row0, int lane,
                                             float sl2) {
  const bool edge = k0 + FK > S || (causal && k0 + FK - 1 > wg_row0);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < FK / 2; ++e) {
    if (edge) {
      const int key = k0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
      if (key >= S || (causal && key > row0 + 8 * ((e / 2) % 2)))
        s[e] = -INFINITY;
    }
    mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], s[e]);
  }
  float m_safe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * sl2);
    m_safe[i] = m_new == -INFINITY ? 0.f : m_new;
    corr[i] = m[i] == -INFINITY ? 0.f : fast_exp2(m[i] - m_safe[i]);
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int e = 0; e < FK / 2; ++e) {
    // 0 where masked; one FFMA and one MUFU an element
    const float p = fast_exp2(fmaf(s[e], sl2, -m_safe[(e / 2) % 2]));
    s[e] = p;
    l[(e / 2) % 2] += p;
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ out, float* __restrict__ lse,
                       int B, int S, int H, int Hkv, int causal,
                       float scale) {
  using L = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1k(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  // blocks in launch order: every (head, batch row) of the last (longest)
  // query tile first, then the tile before it, ...: the light causal
  // sweeps fill the last wave
  const int n_qt = (S + FQ - 1) / FQ;
  const int h = blockIdx.x % H, b = blockIdx.x / H % B;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / H / B)) * FQ;
  const int hk = h / (H / Hkv);
  int n_kt = (S + FK - 1) / FK;
  if (causal) n_kt = min(n_kt, (q0 + FQ - 1) / FK + 1);   // skip above diag
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2 * WG / 32);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every copy
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(qbar, FQ * D * 2);
      load_tile<D>(smem + L::Q, &tq, qbar, FQ, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % STAGES;
        mbar_wait(empty + st, ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + st, 2 * L::TILE);
        load_tile<D>(smem + L::K + st * L::TILE, &tk, full + st, FK, kt * FK,
                     hk, b);
        load_tile<D>(smem + L::V + st * L::TILE, &tv, full + st, FK, kt * FK,
                     hk, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 64
    regs_inc<CONSUMER_REGS>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % WG) / 32;
    const int wg_row0 = q0 + 64 * wg;
    const int row0 = wg_row0 + 16 * warp + lane / 4;   // and row0 + 8
    const float sl2 = scale * LOG2E;     // scores in base 2
    const uint32_t qs = smem_u32(smem + L::Q);
    float o[D / 2], s[FK / 2], corr[2];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    uint32_t pa[FK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < FK / 2; ++i) s[i] = 0.f;
    mbar_wait(qbar, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % STAGES;
      mbar_wait(full + st, (kt / STAGES) & 1);
      // S = Q K^T: this warpgroup's 64 rows x FK keys
      const uint32_t ks = smem_u32(smem + L::K + st * L::TILE);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0, 0>(s, kmajor<D>(qs, FQ, 64 * wg, kk),
                       kmajor<D>(ks, FK, 0, kk), kk > 0);
      wg_commit();
      wg_wait();
      keep(s);
      softmax_tile(s, m, l, corr, kt * FK, S, causal, wg_row0, row0, lane,
                   sl2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];
      acc_to_a(pa, s);

      // O += P V, P (bf16) as the register A operand
      const uint32_t vs = smem_u32(smem + L::V + st * L::TILE);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk)
        wgmma_rs<1>(o, pa[kk], mnmajor<D>(vs, FK, kk, 0), 1);
      wg_commit();
      wg_wait();
      keep(o);
      keep(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);   // K/V stage free again
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = row0 + 8 * i;
      if (row >= S) continue;
      const float lc = fmaxf(l[i], 1e-30f), inv = 1.f / lc;
      bf16* dst = out + (((size_t)b * S + row) * H + h) * D + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            pack2(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
      if (lane % 4 == 0)
        lse[((size_t)b * S + row) * H + h] =
            m[i] == -INFINITY ? -INFINITY : m[i] * LN2 + logf(lc);
    }
  }
}

// lse in base 2 (0 where it is not finite) and delta = rowsum(out * dout)
// into (B, H, Sp) f32 rows, Sp = S rounded up to BQ, so the backward's
// producer copies a query tile's values as 256 contiguous bytes.  One warp
// per (b, s, h) row; the Sp - S padding stays at the wrapper's zeros.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_prep_kernel(const bf16* __restrict__ out,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, int S, int H, int Sp,
                      size_t rows) {
  const size_t row =
      (size_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc += __bfloat162float(out[row * D + d]) *
           __bfloat162float(dout[row * D + d]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H), s = (int)(row / H % S);
    const size_t b = row / H / S;
    const size_t at = (b * H + h) * Sp + s;
    const float ls = lse[row];
    lse2[at] = finite(ls) ? ls * LOG2E : 0.f;
    delta[at] = acc;
  }
}

// dq = bf16(the f32 workspace), four elements a thread.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_cast_kernel(const float4* __restrict__ acc,
                         uint2* __restrict__ dq, size_t n4) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n4) return;
  const float4 v = acc[i];
  dq[i] = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
}

// Backward shared memory (bytes from the 1024-aligned base): K and V
// tiles, STAGES Q and dO tiles, two dS^T buffers, STAGES lse and delta
// rows, the dQ tile on its way to device memory, then the barriers.
template <int D>
struct BwdSmem {
  static constexpr int KV = BK * D * 2, QT = BQ * D * 2, DS = BK * BQ * 2;
  static constexpr int K = 0, V = KV, Q = 2 * KV, DO = Q + STAGES * QT;
  static constexpr int DSB = DO + STAGES * QT, LSE = DSB + 2 * DS;
  static constexpr int DELTA = LSE + STAGES * BQ * 4;
  static constexpr int DQ = DELTA + STAGES * BQ * 4;
  static constexpr int BAR = DQ + BQ * D * 4;
  static constexpr size_t BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tdq,
                       const float* __restrict__ lse2,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int B,
                       int S, int H, int Hkv, int Sp, int causal,
                       float scale) {
  using L = BwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1k(smem_raw);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + STAGES;

  // blocks in launch order: every (kv head, batch row) of key tile 0 (the
  // longest causal sweep) first, then key tile 1, ...
  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv % B;
  const int k0 = (int)(blockIdx.x / Hkv / B) * BK, g = H / Hkv;
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;     // query tiles below the diagonal
  const int per_head = n_qt - qt0, n_it = g * per_head;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2 * WG / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(kvbar, 2 * L::KV);
      load_tile<D>(smem + L::K, &tk, kvbar, BK, k0, hk, b);
      load_tile<D>(smem + L::V, &tv, kvbar, BK, k0, hk, b);
      for (int it = 0; it < n_it; ++it) {
        const int st = it % STAGES;
        const int h = hk * g + it / per_head;
        const int q0 = (qt0 + it % per_head) * BQ;
        const size_t row = ((size_t)b * H + h) * Sp + q0;
        mbar_wait(empty + st, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + st, 2 * L::QT + 2 * BQ * 4);
        load_tile<D>(smem + L::Q + st * L::QT, &tq, full + st, BQ, q0, h, b);
        load_tile<D>(smem + L::DO + st * L::QT, &tdo, full + st, BQ, q0, h,
                     b);
        bulk_load(smem + L::LSE + st * BQ * 4, lse2 + row, BQ * 4, full + st);
        bulk_load(smem + L::DELTA + st * BQ * 4, delta + row, BQ * 4,
                  full + st);
      }
    }
  } else {
    // consumers: warpgroup wg owns keys k0 + 64 wg .. + 64, and columns
    // D / 2 wg .. + D / 2 of each dQ tile
    regs_inc<CONSUMER_REGS>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % WG) / 32;
    const int kl = 64 * wg + 16 * warp + lane / 4;   // local keys kl, kl + 8
    const float sl2 = scale * LOG2E;
    const uint32_t ks = smem_u32(smem + L::K), vs = smem_u32(smem + L::V);
    const bool leader = threadIdx.x % WG == 0;
    float* dq_stage = reinterpret_cast<float*>(smem + L::DQ) + wg * BQ * D / 2;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kvbar, 0);

    for (int it = 0; it < n_it; ++it) {
      const int st = it % STAGES;
      const int h = hk * g + it / per_head;
      const int q0 = (qt0 + it % per_head) * BQ;
      const uint32_t qs = smem_u32(smem + L::Q + st * L::QT);
      const uint32_t dos = smem_u32(smem + L::DO + st * L::QT);
      const float* lse_s =
          reinterpret_cast<const float*>(smem + L::LSE + st * BQ * 4);
      const float* delta_s =
          reinterpret_cast<const float*>(smem + L::DELTA + st * BQ * 4);
      uint8_t* dsb = smem + L::DSB + (it % 2) * L::DS;
      mbar_wait(full + st, (it / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
      float s[BQ / 2], dp[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0, 0>(s, kmajor<D>(ks, BK, 64 * wg, kk),
                       kmajor<D>(qs, BQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0, 0>(dp, kmajor<D>(vs, BK, 64 * wg, kk),
                       kmajor<D>(dos, BQ, 0, kk), kk > 0);
      wg_commit();
      wg_wait();
      keep(s);
      keep(dp);

      // P^T and dS^T in registers; only tiles at S or the diagonal masked
      const bool edge = q0 + BQ > S || k0 + BK > S || (causal && q0 < k0 + BK);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int col = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
        const int key = k0 + kl + 8 * ((e / 2) % 2), query = q0 + col;
        const bool ok =
            !edge || (query < S && key < S && (!causal || key <= query));
        const float p = ok ? fast_exp2(s[e] * sl2 - lse_s[col]) : 0.f;
        s[e] = p;
        dp[e] = p * (dp[e] - delta_s[col]) * scale;
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      acc_to_a(pa, s);
      acc_to_a(da, dp);

      // dS^T to shared memory as 128 key rows of 64 queries (128 bytes,
      // 128-byte swizzle): the MN-major A operand of dQ = dS K
#pragma unroll
      for (int e = 0; e < BQ / 2; e += 2) {
        const int r = kl + 8 * ((e / 2) % 2);
        const int col = 8 * (e / 4) + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(
            dsb + r * 128 + (((col / 8) ^ (r % 8)) * 16) + (col % 8) * 2) =
            pack2(dp[e], dp[e + 1]);
      }
      fence_async_smem();

      // dV += P^T dO and dK += dS^T Q (the tiles' rows are the K of both)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<1>(dv_acc, pa[kk], mnmajor<D>(dos, BQ, kk, 0), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<1>(dk_acc, da[kk], mnmajor<D>(qs, BQ, kk, 0), 1);
      wg_commit();

      // dQ (64 queries x this warpgroup's D / 2 columns) = dS K over all
      // 128 keys, once both warpgroups' dS^T rows are in place
      consumers_sync();
      const uint32_t dss = smem_u32(dsb);
      float dq[D / 4];
#pragma unroll
      for (int i = 0; i < D / 4; ++i) dq[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<1, 1>(dq, desc(dss + kk * 16 * 128, 8192, 1024, 1),
                       mnmajor<D>(ks, BK, kk, wg * D / 2), kk > 0);
      wg_commit();
      wg_wait();
      keep(dv_acc);
      keep(dk_acc);
      keep(pa);
      keep(da);
      keep(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);   // Q/dO stage free again

      // this warpgroup's 64 x D / 2 block of dQ into its half of the
      // staging tile, then one thread adds it into the f32 workspace with
      // a TMA reduce (rows past S are dropped)
      if (leader) bulk_wait<true>();   // the last tile's reduce has read it
      wg_sync(wg);
#pragma unroll
      for (int e = 0; e < D / 4; e += 2) {
        const int r = 16 * warp + lane / 4 + 8 * ((e / 2) % 2);
        *reinterpret_cast<float2*>(
            dq_stage + r * (D / 2) + 8 * (e / 4) + 2 * (lane % 4)) =
            make_float2(dq[e], dq[e + 1]);
      }
      fence_async_smem();
      wg_sync(wg);
      if (leader) {
        tma_reduce_add(dq_stage, &tdq, wg * D / 2, h, q0, b);
        bulk_commit();
      }
    }
    if (leader) bulk_wait<false>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + kl + 8 * i;
      if (key >= S) continue;
      const size_t at =
          (((size_t)b * S + key) * Hkv + hk) * D + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * n) =
            pack2(dk_acc[4 * n + 2 * i], dk_acc[4 * n + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * n) =
            pack2(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
      }
    }
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

// cuTensorMapEncodeTiled, from the CUDA driver API via the runtime (so the
// library needs no -lcuda at link time); looked up once.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The 4-D map of a (B, S, Hx, D) tensor, dims {D, Hx, S, B}, boxes of
// `cols` columns x 1 head x `rows` rows x 1 batch row; rows past S read as
// zeros and are dropped on a store.
cudaError_t make_map(CUtensorMap* map, const void* ptr, bool f32, int D,
                     int B, int S, int Hx, int cols, int rows,
                     CUtensorMapSwizzle swizzle) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hx, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {es * D, es * Hx * D, es * S * Hx * D};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map,
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 operand's map: one column block a box, swizzled as Geo<D> says.
template <int D>
cudaError_t tile_map(CUtensorMap* map, const void* ptr, int B, int S, int Hx,
                     int rows) {
  return make_map(map, ptr, false, D, B, S, Hx, Geo<D>::CB, rows,
                  D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int D>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int S, int H, int Hkv, int causal,
                     float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = tile_map<D>(&tq, q, B, S, H, FQ);
  if (err == cudaSuccess) err = tile_map<D>(&tk, k, B, S, Hkv, FK);
  if (err == cudaSuccess) err = tile_map<D>(&tv, v, B, S, Hkv, FK);
  constexpr size_t smem = FwdSmem<D>::BYTES;
  if (err == cudaSuccess) err = allow_smem(flash_fwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<D>
      <<<(unsigned)((S + FQ - 1) / FQ * H * B), TC_THREADS, smem, stream>>>(
          tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), B,
          S, H, Hkv, causal, scale);
  return cudaGetLastError();
}

// The pre-pass, the one-pass backward, then the dq cast.  `scratch` holds
// 2 B H Sp zeroed floats (lse in base 2, then delta), `dq_acc` B S H D.
template <int D>
cudaError_t bwd_bf16(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const void* lse,
                     void* scratch, void* dq, void* dk, void* dv,
                     void* dq_acc, int B, int S, int H, int Hkv, int causal,
                     float scale, cudaStream_t stream) {
  const int Sp = (S + BQ - 1) / BQ * BQ;
  float* lse2 = static_cast<float*>(scratch);
  float* delta = lse2 + (size_t)B * H * Sp;
  const size_t rows = (size_t)B * S * H;
  flash_bwd_prep_kernel<D><<<(unsigned)((rows + THREADS / 32 - 1) /
                                        (THREADS / 32)),
                             THREADS, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), lse2, delta, S, H, Sp, rows);
  cudaError_t err = cudaGetLastError();
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (err == cudaSuccess) err = tile_map<D>(&tq, q, B, S, H, BQ);
  if (err == cudaSuccess) err = tile_map<D>(&tk, k, B, S, Hkv, BK);
  if (err == cudaSuccess) err = tile_map<D>(&tv, v, B, S, Hkv, BK);
  if (err == cudaSuccess) err = tile_map<D>(&tdo, dout, B, S, H, BQ);
  if (err == cudaSuccess)
    err = make_map(&tdq, dq_acc, true, D, B, S, H, D / 2, BQ,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  constexpr size_t smem = BwdSmem<D>::BYTES;
  if (err == cudaSuccess) err = allow_smem(flash_bwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_wgmma_kernel<D>
      <<<(unsigned)((S + BK - 1) / BK * Hkv * B), TC_THREADS, smem, stream>>>(
          tq, tk, tv, tdo, tdq, lse2, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), B, S, H, Hkv, Sp, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n4 = rows * D / 4;
  flash_bwd_dq_cast_kernel<<<(unsigned)((n4 + THREADS - 1) / THREADS),
                             THREADS, 0, stream>>>(
      static_cast<const float4*>(dq_acc), static_cast<uint2*>(dq), n4);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd_d(const void* q, const void* k, const void* v, void* out,
                  void* lse, int B, int S, int H, int Hkv, int causal,
                  cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (std::is_same<T, bf16>::value) {
    return fwd_bf16<D>(q, k, v, out, lse, B, S, H, Hkv, causal, scale,
                       stream);
  } else {
    constexpr size_t smem = fwd_smem<D>();
    const cudaError_t set = allow_smem(flash_fwd_kernel<D>, smem);
    if (set != cudaSuccess) return set;
    flash_fwd_kernel<D>
        <<<dim3((S + BM - 1) / BM, H, B), THREADS, smem, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<T*>(out),
            static_cast<float*>(lse), S, H, Hkv, causal, scale);
    return cudaGetLastError();
  }
}

// bf16: the pre-pass, the one-pass backward and the dq cast; f32: the delta
// pre-pass, then dK/dV, then dQ on CUDA cores.
template <typename T, int D>
cudaError_t bwd_d(const void* q, const void* k, const void* v,
                  const void* out, const void* dout, const void* lse,
                  void* delta, void* dq, void* dk, void* dv, void* dq_acc,
                  int B, int S, int H, int Hkv, int causal,
                  cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (std::is_same<T, bf16>::value) {
    return bwd_bf16<D>(q, k, v, out, dout, lse, delta, dq, dk, dv, dq_acc, B,
                       S, H, Hkv, causal, scale, stream);
  } else {
    const size_t rows = (size_t)B * S * H;
    const unsigned delta_blocks =
        (unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32));
    flash_bwd_delta_kernel<D><<<delta_blocks, THREADS, 0, stream>>>(
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
    return cudaGetLastError();
  }
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
                void* dk, void* dv, void* dq_acc, int B, int S, int H,
                int Hkv, int D, int causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return bwd_d<T, 16>(q, k, v, out, dout, lse, delta, dq, dk, dv, dq_acc,
                          B, S, H, Hkv, causal, stream);
    case 64:
      return bwd_d<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, dq_acc,
                          B, S, H, Hkv, causal, stream);
    case 128:
      return bwd_d<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                           dq_acc, B, S, H, Hkv, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points, loaded with ctypes by repro_torch.kernels.flash_attention.
// Shapes: q/out/dout/dq (B, S, H, D); k/v/dk/dv (B, S, Hkv, D); lse (B, S,
// H) f32; all contiguous, 16-byte aligned, on the current device; D in
// {16, 64, 128}, H a multiple of Hkv.  The backward's scratch: `delta`
// holds B S H floats for f32, and 2 B H Sp zeroed floats for bf16 (Sp = S
// rounded up to 64); `dq_acc` is a zeroed f32 (B, S, H, D) workspace for
// bf16 (unused, may be null, for f32).  Each launches on `stream` and
// returns cudaGetLastError() (0 on success).
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
                                         void* dv, void* dq_acc, int B,
                                         int S, int H, int Hkv, int D,
                                         int causal, int is_bf16,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? bwd<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk,
                                   dv, dq_acc, B, S, H, Hkv, D, causal, s)
              : bwd<float>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                           dq_acc, B, S, H, Hkv, D, causal, s);
  return static_cast<int>(err);
}
