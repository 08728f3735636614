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
// Design.  The TPU grid (batch, channel block, sequence chunk) ran the
// chunk axis in order, carrying the (block_d, N) state in VMEM.  Here the
// sequence is a loop inside the block:
//   * one thread per (row, channel): its N states and its row of A live in
//     registers for the whole sweep, so the state never touches memory;
//   * a block owns CH = 128 consecutive channels of one row and walks the
//     sequence in tiles of T = 32 steps.  Each tile's dt and xc (T x CH,
//     loaded coalesced across channels) and its B_t / C_t rows (T x N,
//     shared by every channel of the block) are staged in shared memory
//     with all loads issued before any is used, so a tile costs about one
//     memory round trip; then the T steps run from shared memory;
//   * y is stored per step, coalesced across the block's channels.
// N is a template parameter (8: jamba smoke, 16: jamba), so the state loop
// unrolls into registers.
//
// What bounds it on the H100: bytes.  The function reads dt, xc (B*S*d_in
// each), B, C (B*S*N each) and A once and writes y and h_last once:
// 4 * (3*B*S*d_in + 2*B*S*N + d_in*N + B*d_in*N) bytes, against ~5*N flops
// per (step, channel).  Known gaps, left for later work:
//   * at B = 1 and d_in = 16384 (jamba) only 128 blocks of 4 warps are in
//     flight on 132 SMs, one warp per SM partition, so each step's chain of
//     N exponentials and the serial sum of y is exposed latency; splitting
//     the N states of a channel over lanes (a shuffle reduction for y)
//     would put 4x the warps in flight;
//   * a tile's loads wait behind a barrier instead of being double-buffered
//     (cp.async) under the previous tile's steps.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int CH = 128;  // channels (threads) per block
constexpr int T = 32;    // time steps per staged tile

template <int N>
__global__ void __launch_bounds__(CH)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ xc,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ a, float* __restrict__ y,
                  float* __restrict__ h_last, int S, int D) {
  __shared__ float s_dt[T][CH];
  __shared__ float s_xc[T][CH];
  __shared__ float s_b[T][N];
  __shared__ float s_c[T][N];
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int c = threadIdx.x;
  const int d = d0 + c;
  const bool live = d < D;

  float h[N], an[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = 0.f;
    an[n] = live ? a[(size_t)d * N + n] : 0.f;
  }
  const size_t row = (size_t)b * S;

  for (int t0 = 0; t0 < S; t0 += T) {
    const int steps = min(T, S - t0);
#pragma unroll 4
    for (int i = c; i < T * CH; i += CH) {
      const int t = i / CH, cc = i % CH;
      const bool ok = t < steps && d0 + cc < D;
      const size_t src = (row + t0 + t) * D + d0 + cc;
      s_dt[t][cc] = ok ? dt[src] : 0.f;
      s_xc[t][cc] = ok ? xc[src] : 0.f;
    }
    for (int i = c; i < T * N; i += CH) {
      const int t = i / N, n = i % N;
      const bool ok = t < steps;
      const size_t src = (row + t0 + t) * N + n;
      s_b[t][n] = ok ? bm[src] : 0.f;
      s_c[t][n] = ok ? cm[src] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float dtv = s_dt[t][c];
      const float dtx = dtv * s_xc[t][c];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtv * an[n]) * h[n] + dtx * s_b[t][n];
        acc += h[n] * s_c[t][n];
      }
      if (live) y[(row + t0 + t) * D + d] = acc;
    }
    __syncthreads();  // the next tile overwrites the staged rows
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[((size_t)b * D + d) * N + n] = h[n];
  }
}

template <int N>
cudaError_t launch(const void* dt, const void* xc, const void* bm,
                   const void* cm, const void* a, void* y, void* h_last,
                   int B, int S, int D, cudaStream_t stream) {
  const dim3 grid((D + CH - 1) / CH, B);
  mamba_scan_kernel<N><<<grid, CH, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(xc),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<float*>(y),
      static_cast<float*>(h_last), S, D);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes by repro_torch.kernels.mamba_scan.
// Shapes: dt/xc/y (B, S, D); bm/cm (B, S, N); a (D, N); h_last (B, D, N);
// all float32, contiguous, on the current device; S >= 1; N in {8, 16}.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int repro_mamba_scan(const void* dt, const void* xc,
                                const void* bm, const void* cm,
                                const void* a, void* y, void* h_last, int B,
                                int S, int D, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 8:
      err = launch<8>(dt, xc, bm, cm, a, y, h_last, B, S, D, s);
      break;
    case 16:
      err = launch<16>(dt, xc, bm, cm, a, y, h_last, B, S, D, s);
      break;
    default:
      err = cudaErrorInvalidValue;  // the wrapper refuses other state sizes
  }
  return static_cast<int>(err);
}
