// Selective-scan (Mamba) kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py
// (`mamba_scan`, body `_kernel`): for every batch row b and channel d,
//   h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * xc_t) * B_t      (N states)
//   y_t = C_t . h_t
// over t = 0 .. S-1 from h_{-1} = 0, all in f32.  dt and xc are
// (B, S, d_in), B_t and C_t rows of (B, S, N), A (d_in, N).  Besides y
// (B, S, d_in) the kernel writes the state after the last step, h_last
// (B, d_in, N): the TPU kernel keeps it only in VMEM scratch, but serving
// needs it for the request's slot row.  Semantics are those of the plain
// version repro_torch.kernels.ref.mamba_scan_ref.
//
// What bounds it on the H100: the exponentials, then bytes.  Every (step,
// channel, state) needs one exponential, and exponentials run on the
// special-function units at 16 results per clock per SM (~4.2e12/s): at
// jamba's prefill (B 1, S 500, d_in 16384, N 16) 131M of them take
// 0.031 ms.  The bytes (dt, xc, y: B*S*d_in f32 each; B, C, A, h_last)
// take 0.030 ms at 3.35 TB/s.  Besides the exponential, a (step, channel,
// state) costs four f32 instructions (dt*A, dtx*B_t, the update's fma,
// y's fma) and two shared-memory reads (B_t and C_t), which is what the
// design has to thin out.
//
// Design.  The TPU grid (batch, channel block, sequence chunk) ran the
// chunk axis in order, carrying the (block_d, N) state in VMEM.  Here:
//   * a channel's N states are split over L = 4 adjacent lanes of a warp,
//     N/L states each, in registers with their slice of A for the whole
//     sweep, and each thread runs K = 2 adjacent channels: a B_t / C_t
//     value read from shared memory serves two channels.  A block of 128
//     threads owns CH = 128 / L * K = 64 channels of one row, so at B = 1,
//     d_in = 16384 there are 1024 warps in flight (the first design, one
//     thread per channel with all N states, had 512);
//   * y_t: each lane sums its states' terms; the L lanes' partial sums of
//     L consecutive steps are then added by a transposed butterfly
//     (sum_lanes: L - 1 shuffles for L steps, lane j ends with step j), and
//     each lane stages its step's y in shared memory;
//   * one special-function op per exponential: A is pre-scaled by log2(e)
//     once, and exp(dt*A) is ex2.approx.ftz of dt*A' (expf is a ~10
//     instruction sequence around the same op);
//   * the sequence is walked in tiles of T = 32 steps.  A tile's dt and xc
//     (T x CH, row stride d_in) and its B_t / C_t rows (T x N, contiguous)
//     are copied into shared memory with cp.async, STAGES - 1 = 2 tiles
//     ahead, so the next tiles load while this one's steps run; the tile's
//     y goes back as T rows of CH channels with 16-byte stores.
// The time axis is not split: a chunked scan with a carry fix-up needs a
// second exponential per (step, channel, state) to carry the chunk's
// start state forward, and the exponentials are the bound.  d_in not a
// multiple of CH and S not a multiple of T are masked (zero-filled copies,
// no stores); a d_in that is not a multiple of 4, or an operand not on a
// 16-byte boundary, takes 4-byte copies and stores.  N (8 or 16) and L are
// template parameters; repro_torch.kernels.mamba_scan.scan_plan passes L
// (4, the fastest of 2, 4 and 8 at both N on an H100; PERF.md).
// Left: the kernel runs at about half its bound.  On the H100 it is held
// by the instructions around the exponentials, not by the special-function
// units: a variant with the exponentials replaced by an add was barely
// faster, one that read B_t / C_t of fixed rows clearly faster.  Sharing
// B_t / C_t across more channels per thread lost occupancy (K = 4 was
// slower); moving part of the exponentials to the FMA pipes (a polynomial,
// as FlashAttention-4 does) would only pay once those instructions are
// thinned.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // 4 warps a block
constexpr int K = 2;          // adjacent channels a thread
constexpr int T = 32;         // time steps per staged tile
constexpr int STAGES = 3;     // tiles in shared memory: 1 computing, 2 loading
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// async copies global -> shared; `ok` false zero-fills the destination and
// reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int G>  // at most G groups still in flight
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(G) : "memory");
}

// NL consecutive floats of shared memory into registers, 16 or 8 bytes a
// load where NL allows (the offsets passed are multiples of NL floats)
template <int NL>
__device__ __forceinline__ void lds(float (&v)[NL], const float* p) {
  if constexpr (NL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NL; i += 4) {
      const float4 q = reinterpret_cast<const float4*>(p)[i / 4];
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else if constexpr (NL % 2 == 0) {
#pragma unroll
    for (int i = 0; i < NL; i += 2) {
      const float2 q = reinterpret_cast<const float2*>(p)[i / 2];
      v[i] = q.x, v[i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NL; ++i) v[i] = p[i];
  }
}

// The L lanes of a channel hold partial sums of y for L consecutive steps;
// returns, in lane j of the group, step j's sum over the L lanes.  Each of
// the log2(L) butterfly rounds halves the values a lane keeps (the upper
// half where the round's lane bit is set) and adds its partner's other
// half: L - 1 shuffles for L steps.
template <int L>
__device__ __forceinline__ float sum_lanes(float (&v)[L], int j) {
#pragma unroll
  for (int n = L; n > 1; n /= 2) {
    const bool up = j & (n / 2);
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, n / 2);
    }
  }
  return v[0];
}

// 2^x on the special-function unit, one instruction
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N, int L>
struct Tile {
  static constexpr int CH = THREADS / L * K;  // channels per block
  static constexpr int NL = N / L;            // states per lane
  // floats of one stage: dt and xc (T x CH), then B_t and C_t (T x N)
  static constexpr int STAGE = 2 * T * CH + 2 * T * N;
  static constexpr size_t SMEM = sizeof(float) * (STAGES * STAGE + T * CH);
  static_assert(N % L == 0 && T % L == 0 && CH % 4 == 0 && (T * N) % 4 == 0,
                "tiling");
  static_assert(K == 2, "a thread stages its channels' y as one float2");
};

// Start the copies of the tile of steps t0 .. t0+T-1 into stage `st`.
template <int N, int L>
__device__ __forceinline__ void load_tile(
    float* st, const float* __restrict__ dt, const float* __restrict__ xc,
    const float* __restrict__ bm, const float* __restrict__ cm, size_t row,
    int t0, int S, int D, int d0, bool vec) {
  using TL = Tile<N, L>;
  constexpr int CH = TL::CH;
  float* s_dt = st;
  float* s_xc = st + T * CH;
  float* s_b = st + 2 * T * CH;
  float* s_c = s_b + T * N;
  const int tid = threadIdx.x;
  if (vec) {  // rows of CH channels in 16-byte chunks
    constexpr int Q = CH / 4;
#pragma unroll
    for (int i = tid; i < T * Q; i += THREADS) {
      const int t = i / Q, ch = d0 + 4 * (i % Q);
      const bool ok = t0 + t < S && ch < D;
      const size_t src = ok ? (row + t0 + t) * D + ch : 0;
      cp_async16(s_dt + 4 * i, dt + src, ok);
      cp_async16(s_xc + 4 * i, xc + src, ok);
    }
  } else {
    for (int i = tid; i < T * CH; i += THREADS) {
      const int t = i / CH, ch = d0 + i % CH;
      const bool ok = t0 + t < S && ch < D;
      const size_t src = ok ? (row + t0 + t) * D + ch : 0;
      cp_async4(s_dt + i, dt + src, ok);
      cp_async4(s_xc + i, xc + src, ok);
    }
  }
  // B_t / C_t of the tile are T consecutive rows of N: one contiguous run
  if (vec) {
    for (int i = tid; i < T * N / 4; i += THREADS) {
      const bool ok = t0 + 4 * i / N < S;
      const size_t src = ok ? (row + t0) * N + 4 * i : 0;
      cp_async16(s_b + 4 * i, bm + src, ok);
      cp_async16(s_c + 4 * i, cm + src, ok);
    }
  } else {
    for (int i = tid; i < T * N; i += THREADS) {
      const bool ok = t0 + i / N < S;
      const size_t src = ok ? (row + t0) * N + i : 0;
      cp_async4(s_b + i, bm + src, ok);
      cp_async4(s_c + i, cm + src, ok);
    }
  }
}

// Run the L-step groups of one staged tile `st` that reach into [0,
// steps) and stage their y in s_y: past S the copies zero-filled dt, xc
// and B_t, and a step with dt = 0 leaves h as it was.  Lane j of a
// channel's group stages y of steps g * L + j.
template <int N, int L>
__device__ __forceinline__ void scan_tile(const float* st, float* s_y,
                                          float (&h)[K][N / L],
                                          const float (&a2)[K][N / L],
                                          int c, int j, int steps) {
  constexpr int CH = Tile<N, L>::CH, NL = N / L;
  const float* s_dt = st;
  const float* s_xc = st + T * CH;
  const float* s_b = st + 2 * T * CH + j * NL;
  const float* s_c = s_b + T * N;
  const int groups = (steps + L - 1) / L;
#pragma unroll 4
  for (int g = 0; g < groups; ++g) {
    float part[K][L];
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int t = g * L + u;
      float dtv[K], xv[K], bt[NL], ct[NL];
      lds<K>(dtv, s_dt + t * CH + c);
      lds<K>(xv, s_xc + t * CH + c);
      lds<NL>(bt, s_b + t * N);
      lds<NL>(ct, s_c + t * N);
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const float dtx = dtv[q] * xv[q];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NL; ++n) {
          h[q][n] = fmaf(ex2(dtv[q] * a2[q][n]), h[q][n], dtx * bt[n]);
          acc = fmaf(h[q][n], ct[n], acc);
        }
        part[q][u] = acc;
      }
    }
    float yv[K];
#pragma unroll
    for (int q = 0; q < K; ++q) yv[q] = sum_lanes<L>(part[q], j);
    *reinterpret_cast<float2*>(s_y + (g * L + j) * CH + c) =
        make_float2(yv[0], yv[1]);
  }
}

// CKPT: the training instantiation, which also writes the state before
// every tile into h_ckpt; serving runs the one without
template <int N, int L, bool CKPT>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ xc,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ a, float* __restrict__ y,
                  float* __restrict__ h_last, float* __restrict__ h_ckpt,
                  int S, int D, bool vec) {
  using TL = Tile<N, L>;
  constexpr int CH = TL::CH, NL = TL::NL;
  extern __shared__ __align__(16) float smem[];
  float* s_y = smem + STAGES * TL::STAGE;  // T x CH
  const int tid = threadIdx.x;
  const int c = tid / L * K;  // the thread's first channel in the block
  const int j = tid % L;      // lane within the channel group
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const size_t row = (size_t)b * S;

  float h[K][NL], a2[K][NL];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int d = d0 + c + q;
#pragma unroll
    for (int n = 0; n < NL; ++n) {
      h[q][n] = 0.f;
      a2[q][n] = d < D ? a[(size_t)d * N + j * NL + n] * LOG2E : 0.f;
    }
  }

  const int tiles = (S + T - 1) / T;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < tiles)
      load_tile<N, L>(smem + k * TL::STAGE, dt, xc, bm, cm, row, k * T, S,
                      D, d0, vec);
    cp_commit();
  }
  for (int k = 0; k < tiles; ++k) {
    cp_wait<STAGES - 2>();  // this thread's copies of tile k have landed
    __syncthreads();        // everyone's; stage (k-1) and s_y are free
    const int nk = k + STAGES - 1;
    if (nk < tiles)
      load_tile<N, L>(smem + (nk % STAGES) * TL::STAGE, dt, xc, bm, cm, row,
                      nk * T, S, D, d0, vec);
    cp_commit();  // possibly empty: keeps the group count uniform

    if constexpr (CKPT) {  // training: the state before the tile
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int d = d0 + c + q;
        if (d < D) {
#pragma unroll
          for (int n = 0; n < NL; ++n)
            h_ckpt[(((size_t)b * tiles + k) * D + d) * N + j * NL + n] =
                h[q][n];
        }
      }
    }
    const float* st = smem + (k % STAGES) * TL::STAGE;
    const int t0 = k * T;
    const int steps = min(T, S - t0);
    scan_tile<N, L>(st, s_y, h, a2, c, j, steps);
    __syncthreads();  // the tile's y is staged
    if (vec) {
      constexpr int Q = CH / 4;
      for (int i = tid; i < steps * Q; i += THREADS) {
        const int t = i / Q, ch = d0 + 4 * (i % Q);
        if (ch < D)
          *reinterpret_cast<float4*>(y + (row + t0 + t) * D + ch) =
              reinterpret_cast<const float4*>(s_y)[i];
      }
    } else {
      for (int i = tid; i < steps * CH; i += THREADS) {
        const int t = i / CH, ch = d0 + i % CH;
        if (ch < D) y[(row + t0 + t) * D + ch] = s_y[i];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int d = d0 + c + q;
    if (d < D) {
#pragma unroll
      for (int n = 0; n < NL; ++n)
        h_last[((size_t)b * D + d) * N + j * NL + n] = h[q][n];
    }
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <int N, int L, bool CKPT>
cudaError_t launch_fwd(const void* dt, const void* xc, const void* bm,
                       const void* cm, const void* a, void* y, void* h_last,
                       void* h_ckpt, int B, int S, int D,
                       cudaStream_t stream) {
  using TL = Tile<N, L>;
  const cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel<N, L, CKPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TL::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + TL::CH - 1) / TL::CH, B);
  const bool vec = D % 4 == 0 && aligned16(dt) && aligned16(xc) &&
                   aligned16(bm) && aligned16(cm) && aligned16(y);
  mamba_scan_kernel<N, L, CKPT><<<grid, THREADS, TL::SMEM, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(xc),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<float*>(y),
      static_cast<float*>(h_last), static_cast<float*>(h_ckpt), S, D, vec);
  return cudaGetLastError();
}

template <int N, int L>
cudaError_t launch(const void* dt, const void* xc, const void* bm,
                   const void* cm, const void* a, void* y, void* h_last,
                   void* h_ckpt, int B, int S, int D, cudaStream_t stream) {
  return h_ckpt != nullptr
             ? launch_fwd<N, L, true>(dt, xc, bm, cm, a, y, h_last, h_ckpt,
                                      B, S, D, stream)
             : launch_fwd<N, L, false>(dt, xc, bm, cm, a, y, h_last, h_ckpt,
                                       B, S, D, stream);
}

// ---------------------------------------------------------------------------
// Backward: repro_mamba_scan_bwd
// ---------------------------------------------------------------------------
// No TPU kernel is its counterpart: the TPU kernel is forward only, and the
// JAX model gets these gradients from the autodiff of its `lax.scan` twin
// (repro/models/ssm.py `_mamba_core`).  Semantics are those of the plain
// version repro_torch.kernels.ref.mamba_scan_bwd_ref.  With e_t =
// exp(dt_t A) and the state's cotangent g running backwards from
// g = dh_last:
//   g_t    = dy_t C_t + e_{t+1} g_{t+1}
//   d_xc_t = dt_t sum_n g_t B_t
//   d_dt_t = sum_n g_t (A e_t h_{t-1} + xc_t B_t)
//   d_B_t  = sum_d g_t dt_t xc_t          (over the channels)
//   d_C_t  = sum_d dy_t h_t               (over the channels)
//   d_A    = sum_{b,t} g_t dt_t e_t h_{t-1}
// What bounds it on the H100: bytes, then the exponentials.  It reads dt,
// xc, dy and the checkpoints and writes d_dt and d_xc: at jamba's train
// shape (B 2, S 4096, d_in 16384, N 16) five B*S*d_in f32 tensors of 537 MB
// and 268 MB of checkpoints, 0.88 ms at 3.35 TB/s.  The sweep needs h_{t-1}
// in reverse order, and keeping every state would take 8.6 GB a layer: the
// training forward writes the state before every tile of T = 32 steps
// (h_ckpt) and the backward recomputes from it, so each (step, channel,
// state) costs a second exponential beside the sweep's own.
// Design (the forward's lane split kept: a channel's N states on L = 4
// adjacent lanes, K = 2 channels a thread, 64 channels a block):
//   * States in registers, two blocks an SM.  A tile's 32 states took 128
//     KB of shared memory a block in the first design, so one block of 4
//     warps ran an SM, latency-bound.  Now a tile is walked in sub-tiles of
//     SUB = 8 steps: one pass from the checkpoint leaves the states before
//     steps 8, 16 and 24 in shared memory (each thread its own), then, last
//     sub-tile first, the 8 states of a sub-tile are recomputed into
//     registers (fully unrolled, 64 of them) and swept backwards.  That is
//     2.75 exponentials per (step, channel, state) instead of 2, and 84 KB
//     of shared memory a block: two blocks (8 warps) an SM, 255 registers
//     a thread at most (`ptxas -v`: no spills).
//   * Pipelined loads.  A tile's dt, xc, dy, B_t, C_t and its checkpoint
//     are copied with cp.async into one of two stages while the other
//     tile's sub-tiles run; d_dt and d_xc go straight from the lanes to
//     device memory (a warp writes 64 contiguous bytes of each a step).
//   * Reduce-scatters, not all-reduces.  A channel's d_dt and d_xc partials
//     over its L lanes (2K = 4 values) are summed by the forward's
//     transposed butterfly (sum_lanes: 3 shuffles, lane j ends with one
//     value); d_B and d_C over the warp's 8 channel groups (2 * N/L = 8
//     values a lane at N = 16) by the same butterfly over lane bits 4, 3
//     and 2 (sum_groups: 7 shuffles, the first design's all-reduce took
//     24).  Each lane of a warp then holds one of its 2N d_B / d_C sums.
//   * Reductions without atomics, so that two runs give equal bits: the
//     four warps' d_B / d_C are added in shared memory, a sub-tile at a
//     time, into per-block partials (one row per channel block); d_A is a
//     per-row partial; a second small kernel sums the partials in a fixed
//     order.
// Left: the partials of d_B and d_C (268 MB at the train shape, written
// once and read once) and the 0.75 extra exponential per element; a
// cluster that sums its blocks' partials through distributed shared memory
// would cut the first, a ring of (e_t, h_{t-1}) pairs the second.

constexpr int SUB = 8;         // steps of a sub-tile (its states in registers)
constexpr int BWD_BLOCKS = 2;  // blocks an SM the backward is built for

template <int N, int L>
struct BwdTile {
  static constexpr int CH = THREADS / L * K;  // channels per block
  static constexpr int NL = N / L;            // states per lane
  static constexpr int KN = K * NL;           // states a thread holds
  static constexpr int WARPS = THREADS / 32;
  static constexpr int P = 2 * NL;            // d_B / d_C sums of a lane
  // float offsets in a stage: dt, xc, dy (T x CH); B_t, C_t (T x N); the
  // tile's checkpoint (THREADS x KN, thread-major)
  static constexpr int DT = 0, XC = T * CH, DY = 2 * T * CH;
  static constexpr int BM = 3 * T * CH, CM = BM + T * N, CK = CM + T * N;
  static constexpr int STAGE = CK + THREADS * KN;
  // after the two stages: the states before sub-tiles 1.. of the tile
  // ((T / SUB - 1) x THREADS x KN), then the warps' d_B / d_C of a
  // sub-tile, double-buffered (2 x SUB x WARPS x 2N)
  static constexpr int SS = 2 * STAGE;
  static constexpr int RED = SS + (T / SUB - 1) * THREADS * KN;
  static constexpr int FLOATS = RED + 2 * SUB * WARPS * 2 * N;
  static constexpr size_t SMEM = sizeof(float) * FLOATS;
  static_assert(T % SUB == 0 && 2 * K == L && (P == 4 || P == 8),
                "the reductions' layouts");
  static_assert(BWD_BLOCKS * (SMEM + 1024) <= 233472, "blocks an SM");
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// Copy the tile k of steps t0 .. t0+T-1 of dt, xc, dy and B_t, C_t into
// the stage `sm` (zero past S and past D), with this thread's K * N/L
// states of the tile's checkpoint.
template <int N, int L>
__device__ __forceinline__ void load_bwd_tile(
    float* sm, const float* __restrict__ dt, const float* __restrict__ xc,
    const float* __restrict__ dy, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ h_ckpt,
    size_t row, int b, int k, int tiles, int S, int D, int d0, bool vec) {
  using BT = BwdTile<N, L>;
  constexpr int CH = BT::CH, NL = BT::NL;
  const int tid = threadIdx.x;
  const int t0 = k * T;
  if (vec) {
    constexpr int Q = CH / 4;
    for (int i = tid; i < T * Q; i += THREADS) {
      const int t = i / Q, ch = d0 + 4 * (i % Q);
      const bool ok = t0 + t < S && ch < D;
      const size_t src = ok ? (row + t0 + t) * D + ch : 0;
      cp_async16(sm + BT::DT + 4 * i, dt + src, ok);
      cp_async16(sm + BT::XC + 4 * i, xc + src, ok);
      cp_async16(sm + BT::DY + 4 * i, dy + src, ok);
    }
    for (int i = tid; i < T * N / 4; i += THREADS) {
      const bool ok = t0 + 4 * i / N < S;
      const size_t src = ok ? (row + t0) * N + 4 * i : 0;
      cp_async16(sm + BT::BM + 4 * i, bm + src, ok);
      cp_async16(sm + BT::CM + 4 * i, cm + src, ok);
    }
  } else {
    for (int i = tid; i < T * CH; i += THREADS) {
      const int t = i / CH, ch = d0 + i % CH;
      const bool ok = t0 + t < S && ch < D;
      const size_t src = ok ? (row + t0 + t) * D + ch : 0;
      cp_async4(sm + BT::DT + i, dt + src, ok);
      cp_async4(sm + BT::XC + i, xc + src, ok);
      cp_async4(sm + BT::DY + i, dy + src, ok);
    }
    for (int i = tid; i < T * N; i += THREADS) {
      const bool ok = t0 + i / N < S;
      const size_t src = ok ? (row + t0) * N + i : 0;
      cp_async4(sm + BT::BM + i, bm + src, ok);
      cp_async4(sm + BT::CM + i, cm + src, ok);
    }
  }
  const int c = tid / L * K, j = tid % L;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int d = d0 + c + q;
    const bool ok = d < D;
    const float* src =
        h_ckpt + (ok ? (((size_t)b * tiles + k) * D + d) * N + j * NL : 0);
    float* dst = sm + BT::CK + tid * BT::KN + q * NL;
    if (!vec) {
#pragma unroll
      for (int n = 0; n < NL; ++n) cp_async4(dst + n, src + n, ok);
    } else if constexpr (NL == 4) {
      cp_async16(dst, src, ok);
    } else {
      cp_async8(dst, src, ok);
    }
  }
}

// One step of the forward again: h <- exp(dt A) h + dt xc B_t, for the
// thread's K channels and N/L states, from the staged tile's step u.
template <int N, int L>
__device__ __forceinline__ void step_again(const float* st, int u, int c,
                                           int j, float (&h)[K][N / L],
                                           const float (&a2)[K][N / L]) {
  using BT = BwdTile<N, L>;
  constexpr int NL = BT::NL;
  float dtv[K], xv[K], bt[NL];
  lds<K>(dtv, st + BT::DT + u * BT::CH + c);
  lds<K>(xv, st + BT::XC + u * BT::CH + c);
  lds<NL>(bt, st + BT::BM + u * N + j * NL);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const float dtx = dtv[q] * xv[q];
#pragma unroll
    for (int n = 0; n < NL; ++n)
      h[q][n] = fmaf(ex2(dtv[q] * a2[q][n]), h[q][n], dtx * bt[n]);
  }
}

// One transposed-butterfly round over lane bit `o` (a power of two): the
// lanes with the bit set keep the upper half of the n values, the others
// the lower half, each adding its partner's copy of the half it keeps.
template <int n, int P>
__device__ __forceinline__ void fold(float (&v)[P], int lane, int o) {
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const float send = up ? v[i] : v[i + n / 2];
    const float keep = up ? v[i + n / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// The warp's 8 channel groups (lane bits 4, 3, 2; L = 4 lanes a group)
// each hold P partial sums; returns the sum over the groups of value
// (lane >> 2) (P = 8) or (lane >> 3) (P = 4, the pairs of groups that
// differ in lane bit 2 ending with the same sum): P - 1 shuffles, plus
// one at P = 4.
template <int P>
__device__ __forceinline__ float sum_groups(float (&v)[P], int lane) {
  fold<P>(v, lane, 16);
  fold<P / 2>(v, lane, 8);
  if constexpr (P == 8) {
    fold<2>(v, lane, 4);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 4);
  }
  return v[0];
}

template <int N, int L>
__global__ void __launch_bounds__(THREADS, BWD_BLOCKS) mamba_scan_bwd_kernel(
    const float* __restrict__ dt, const float* __restrict__ xc,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ h_ckpt,
    const float* __restrict__ dy, const float* __restrict__ dh_last,
    float* __restrict__ d_dt, float* __restrict__ d_xc,
    float* __restrict__ part_b, float* __restrict__ part_c,
    float* __restrict__ part_a, int B, int S, int D, bool vec) {
  using BT = BwdTile<N, L>;
  constexpr int CH = BT::CH, NL = BT::NL, KN = BT::KN, WARPS = BT::WARPS;
  constexpr int P = BT::P;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int c = tid / L * K;  // the thread's first channel in the block
  const int j = tid % L;      // lane within the channel group
  const int lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const size_t row = (size_t)b * S;
  const int tiles = (S + T - 1) / T;
  // the d_B / d_C sum this lane ends a step with (sum_groups): value v of
  // the lane's P, n = j * NL + v % NL of d_B (v < NL) or d_C; at P = 4
  // only the lanes with bit 2 clear store it
  const int v_idx = P == 8 ? lane >> 2 : lane >> 3;
  const int slot = (v_idx < NL ? 0 : N) + j * NL + v_idx % NL;
  const bool stores_bc = P == 8 || !(lane & 4);
  // this lane's d_dt / d_xc sum (sum_lanes): d_dt (j < 2) or d_xc of
  // channel d0 + c + (j & 1)
  float* d_out = (j < 2 ? d_dt : d_xc) + d0 + c + (j & 1);
  const bool out_live = d0 + c + (j & 1) < D;

  float a1[K][NL], a2[K][NL], g[K][NL], da[K][NL];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int d = d0 + c + q;
#pragma unroll
    for (int n = 0; n < NL; ++n) {
      a1[q][n] = d < D ? a[(size_t)d * N + j * NL + n] : 0.f;
      a2[q][n] = a1[q][n] * LOG2E;
      g[q][n] = d < D ? dh_last[((size_t)b * D + d) * N + j * NL + n] : 0.f;
      da[q][n] = 0.f;
    }
  }

  load_bwd_tile<N, L>(sm + ((tiles - 1) & 1) * BT::STAGE, dt, xc, dy, bm, cm,
                      h_ckpt, row, b, tiles - 1, tiles, S, D, d0, vec);
  cp_commit();
  int sub = 0;  // sub-tiles swept so far: the parity of the d_B / d_C buffer
  for (int k = tiles - 1; k >= 0; --k) {
    __syncthreads();  // every thread is done with tile k + 1's stage
    if (k > 0)
      load_bwd_tile<N, L>(sm + ((k - 1) & 1) * BT::STAGE, dt, xc, dy, bm, cm,
                          h_ckpt, row, b, k - 1, tiles, S, D, d0, vec);
    cp_commit();  // possibly empty: keeps the group count uniform
    cp_wait<1>();     // this thread's copies of tile k have landed
    __syncthreads();  // everyone's
    const float* st = sm + (k & 1) * BT::STAGE;
    const int t0 = k * T;
    const int nsub = (min(T, S - t0) + SUB - 1) / SUB;
    float* ss = sm + BT::SS + tid * KN;  // this thread's sub-tile starts

    // the states before sub-tiles 1 .. nsub-1, from the checkpoint
    float h[K][NL];
    lds<KN>(reinterpret_cast<float(&)[KN]>(h), st + BT::CK + tid * KN);
    for (int s = 0; s + 1 < nsub; ++s) {
#pragma unroll
      for (int i = 0; i < SUB; ++i)
        step_again<N, L>(st, s * SUB + i, c, j, h, a2);
#pragma unroll
      for (int q = 0; q < K; ++q)
#pragma unroll
        for (int n = 0; n < NL; ++n)
          ss[s * THREADS * KN + q * NL + n] = h[q][n];
    }

    for (int s = nsub - 1; s >= 0; --s, ++sub) {
      // the sub-tile's states: hs[i] before step s * SUB + i, h after it
      const float* start =
          s == 0 ? st + BT::CK + tid * KN : ss + (s - 1) * THREADS * KN;
      lds<KN>(reinterpret_cast<float(&)[KN]>(h), start);
      float hs[SUB][K][NL];
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
#pragma unroll
        for (int q = 0; q < K; ++q)
#pragma unroll
          for (int n = 0; n < NL; ++n) hs[i][q][n] = h[q][n];
        step_again<N, L>(st, s * SUB + i, c, j, h, a2);
      }

      float* red = sm + BT::RED + (sub & 1) * SUB * WARPS * 2 * N;
#pragma unroll
      for (int i = SUB - 1; i >= 0; --i) {
        const int u = s * SUB + i;
        float dtv[K], xv[K], dyv[K], bt[NL], ct[NL];
        lds<K>(dtv, st + BT::DT + u * CH + c);
        lds<K>(xv, st + BT::XC + u * CH + c);
        lds<K>(dyv, st + BT::DY + u * CH + c);
        lds<NL>(bt, st + BT::BM + u * N + j * NL);
        lds<NL>(ct, st + BT::CM + u * N + j * NL);
        float gb[K], sa[K], pv[P];
#pragma unroll
        for (int v = 0; v < P; ++v) pv[v] = 0.f;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const float dtx = dtv[q] * xv[q];
          gb[q] = sa[q] = 0.f;
#pragma unroll
          for (int n = 0; n < NL; ++n) {
            const float hp = hs[i][q][n];  // the states before and after
            const float hc = i + 1 < SUB ? hs[min(i + 1, SUB - 1)][q][n]
                                         : h[q][n];
            const float e = ex2(dtv[q] * a2[q][n]);
            g[q][n] = fmaf(dyv[q], ct[n], g[q][n]);
            gb[q] = fmaf(g[q][n], bt[n], gb[q]);
            const float w = g[q][n] * e * hp;
            sa[q] = fmaf(a1[q][n], w, sa[q]);
            da[q][n] = fmaf(dtv[q], w, da[q][n]);
            pv[n] = fmaf(g[q][n], dtx, pv[n]);
            pv[NL + n] = fmaf(dyv[q], hc, pv[NL + n]);
            g[q][n] *= e;
          }
        }
        // d_dt = xc sum gb + sum sa and d_xc = dt sum gb over the L lanes
        float o[L] = {fmaf(xv[0], gb[0], sa[0]), fmaf(xv[1], gb[1], sa[1]),
                      dtv[0] * gb[0], dtv[1] * gb[1]};
        const float r = sum_lanes<L>(o, j);
        const int t = t0 + u;
        if (t < S && out_live) d_out[(row + t) * D] = r;
        const float rb = sum_groups<P>(pv, lane);
        if (stores_bc) red[(i * WARPS + warp) * 2 * N + slot] = rb;
      }
      __syncthreads();  // the sub-tile's warp sums of d_B / d_C are staged
      for (int x = tid; x < SUB * 2 * N; x += THREADS) {
        const int i = x / (2 * N), v = x % (2 * N);
        const int t = t0 + s * SUB + i;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += red[(i * WARPS + w) * 2 * N + v];
        if (t < S)
          (v < N ? part_b : part_c)[(((size_t)blockIdx.x * B + b) * S + t) *
                                        N +
                                    v % N] = sum;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int d = d0 + c + q;
    if (d < D) {
#pragma unroll
      for (int n = 0; n < NL; ++n)
        part_a[((size_t)b * D + d) * N + j * NL + n] = da[q][n];
    }
  }
}

// out[i] = sum over k < P of part[k * M + i], k in order: the fixed-order
// second pass of the backward's reductions
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int P, size_t M) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < M;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < P; ++k) s += part[k * M + i];
    out[i] = s;
  }
}

cudaError_t sum_parts(const float* part, float* out, int P, size_t M,
                      cudaStream_t stream) {
  const size_t blocks = (M + 255) / 256;
  sum_parts_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0,
                     stream>>>(part, out, P, M);
  return cudaGetLastError();
}

template <int N, int L>
cudaError_t prepare_bwd() {
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<N, L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BwdTile<N, L>::SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(mamba_scan_bwd_kernel<N, L>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int N, int L>
cudaError_t launch_bwd(const float* dt, const float* xc, const float* bm,
                       const float* cm, const float* a, const float* h_ckpt,
                       const float* dy, const float* dh_last, float* d_dt,
                       float* d_xc, float* d_bm, float* d_cm, float* d_a,
                       float* part_b, float* part_c, float* part_a, int B,
                       int S, int D, cudaStream_t stream) {
  using BT = BwdTile<N, L>;
  cudaError_t err = prepare_bwd<N, L>();
  if (err != cudaSuccess) return err;
  const int blocks = (D + BT::CH - 1) / BT::CH;
  const bool vec = D % 4 == 0 && aligned16(dt) && aligned16(xc) &&
                   aligned16(dy) && aligned16(bm) && aligned16(cm) &&
                   aligned16(h_ckpt);
  mamba_scan_bwd_kernel<N, L><<<dim3(blocks, B), THREADS, BT::SMEM,
                                stream>>>(
      dt, xc, bm, cm, a, h_ckpt, dy, dh_last, d_dt, d_xc, part_b, part_c,
      part_a, B, S, D, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t bsn = (size_t)B * S * N;
  if ((err = sum_parts(part_b, d_bm, blocks, bsn, stream)) != cudaSuccess)
    return err;
  if ((err = sum_parts(part_c, d_cm, blocks, bsn, stream)) != cudaSuccess)
    return err;
  return sum_parts(part_a, d_a, B, (size_t)D * N, stream);
}

template <int N, int L>
cudaError_t occupancy_bwd(int* blocks, int* smem) {
  cudaError_t err = prepare_bwd<N, L>();
  if (err != cudaSuccess) return err;
  *smem = (int)BwdTile<N, L>::SMEM;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mamba_scan_bwd_kernel<N, L>, THREADS, BwdTile<N, L>::SMEM);
}

}  // namespace

// C entry point, loaded with ctypes by repro_torch.kernels.mamba_scan.
// Shapes: dt/xc/y (B, S, D); bm/cm (B, S, N); a (D, N); h_last (B, D, N);
// h_ckpt null (serving) or (B, ceil(S / T), D, N), the state before every
// tile of T steps (training: the backward's checkpoints); all float32,
// contiguous, on the current device; S >= 1; N in {8, 16}; L (lanes per
// channel) 4.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int repro_mamba_scan(const void* dt, const void* xc,
                                const void* bm, const void* cm,
                                const void* a, void* y, void* h_last,
                                void* h_ckpt, int B, int S, int D, int N,
                                int L, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (L != 4) return static_cast<int>(cudaErrorInvalidValue);  // one split
  switch (N) {
    case 8:
      err = launch<8, 4>(dt, xc, bm, cm, a, y, h_last, h_ckpt, B, S, D, s);
      break;
    case 16:
      err = launch<16, 4>(dt, xc, bm, cm, a, y, h_last, h_ckpt, B, S, D,
                        s);
      break;
    default:
      err = cudaErrorInvalidValue;  // the wrapper refuses other state sizes
  }
  return static_cast<int>(err);
}


// C entry point of the backward, loaded with ctypes by
// repro_torch.kernels.mamba_scan.  Shapes: dt/xc/dy/d_dt/d_xc (B, S, D);
// bm/cm/d_bm/d_cm (B, S, N); a/d_a (D, N); h_ckpt (B, ceil(S / 32), D, N),
// as the forward wrote it; dh_last (B, D, N); scratch part_b/part_c
// (ceil(D / 64), B, S, N) and part_a (B, D, N); all float32, contiguous, on
// the current device; S >= 1; N in {8, 16}; L 4.  Launches the sweep and
// three fixed-order sums on `stream` and returns the first CUDA error (0
// on success).
extern "C" int repro_mamba_scan_bwd(
    const void* dt, const void* xc, const void* bm, const void* cm,
    const void* a, const void* h_ckpt, const void* dy, const void* dh_last,
    void* d_dt, void* d_xc, void* d_bm, void* d_cm, void* d_a, void* part_b,
    void* part_c, void* part_a, int B, int S, int D, int N, int L,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L != 4) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_BWD_ARGS                                                     \
  static_cast<const float*>(dt), static_cast<const float*>(xc),            \
      static_cast<const float*>(bm), static_cast<const float*>(cm),        \
      static_cast<const float*>(a), static_cast<const float*>(h_ckpt),     \
      static_cast<const float*>(dy), static_cast<const float*>(dh_last),   \
      static_cast<float*>(d_dt), static_cast<float*>(d_xc),                \
      static_cast<float*>(d_bm), static_cast<float*>(d_cm),                \
      static_cast<float*>(d_a), static_cast<float*>(part_b),               \
      static_cast<float*>(part_c), static_cast<float*>(part_a), B, S, D, s
  cudaError_t err;
  switch (N) {
    case 8:
      err = launch_bwd<8, 4>(REPRO_BWD_ARGS);
      break;
    case 16:
      err = launch_bwd<16, 4>(REPRO_BWD_ARGS);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
#undef REPRO_BWD_ARGS
  return static_cast<int>(err);
}


// Occupancy of the backward's sweep on the current device: the blocks an
// SM holds (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`) and its
// dynamic shared memory in bytes, for N in {8, 16}; returns the CUDA error
// (0 on success).  Launches nothing.
extern "C" int repro_mamba_scan_bwd_occupancy(int N, int* blocks,
                                              int* smem) {
  switch (N) {
    case 8:
      return static_cast<int>(occupancy_bwd<8, 4>(blocks, smem));
    case 16:
      return static_cast<int>(occupancy_bwd<16, 4>(blocks, smem));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
