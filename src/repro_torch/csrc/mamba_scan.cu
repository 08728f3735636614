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

template <int N, int L>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ xc,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ a, float* __restrict__ y,
                  float* __restrict__ h_last, int S, int D, bool vec) {
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

template <int N, int L>
cudaError_t launch(const void* dt, const void* xc, const void* bm,
                   const void* cm, const void* a, void* y, void* h_last,
                   int B, int S, int D, cudaStream_t stream) {
  using TL = Tile<N, L>;
  const cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel<N, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TL::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + TL::CH - 1) / TL::CH, B);
  const bool vec = D % 4 == 0 && aligned16(dt) && aligned16(xc) &&
                   aligned16(bm) && aligned16(cm) && aligned16(y);
  mamba_scan_kernel<N, L><<<grid, THREADS, TL::SMEM, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(xc),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<float*>(y),
      static_cast<float*>(h_last), S, D, vec);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes by repro_torch.kernels.mamba_scan.
// Shapes: dt/xc/y (B, S, D); bm/cm (B, S, N); a (D, N); h_last (B, D, N);
// all float32, contiguous, on the current device; S >= 1; N in {8, 16};
// L (lanes per channel) 4.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int repro_mamba_scan(const void* dt, const void* xc,
                                const void* bm, const void* cm,
                                const void* a, void* y, void* h_last, int B,
                                int S, int D, int N, int L, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (L != 4) return static_cast<int>(cudaErrorInvalidValue);  // one split
  switch (N) {
    case 8:
      err = launch<8, 4>(dt, xc, bm, cm, a, y, h_last, B, S, D, s);
      break;
    case 16:
      err = launch<16, 4>(dt, xc, bm, cm, a, y, h_last, B, S, D, s);
      break;
    default:
      err = cudaErrorInvalidValue;  // the wrapper refuses other state sizes
  }
  return static_cast<int>(err);
}
