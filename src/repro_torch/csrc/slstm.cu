// sLSTM recurrence kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/slstm.py (`slstm_scan`,
// body `_kernel`): the sLSTM of xLSTM with stabilised exponential gating
// and a block-diagonal recurrence.  Per batch row, from h = c = n = 0 and
// m = -1e9 (not -inf: the first step's lf + m stays finite), for each t:
//   pre  = gx_t + regroup(h_{t-1} @ r_h)      gate layout [i|f|z|o], 4 x d
//   lf   = log sigmoid(f) = -softplus(-f)
//   m_t  = max(lf + m_{t-1}, i)
//   c_t  = exp(lf + m_{t-1} - m_t) * c_{t-1} + exp(i - m_t) * tanh(z)
//   n_t  = max(exp(lf + m_{t-1} - m_t) * n_{t-1} + exp(i - m_t), 1e-6)
//   h_t  = sigmoid(o) * c_t / n_t
// where head k's recurrent part is h_{t-1}[k*dh:(k+1)*dh] @ r_h[k]
// ((dh, 4*dh), columns g*dh + j for gate g and channel k*dh + j).  gx is
// (B, S, 4d), r_h (H, dh, 4dh), all f32.  The kernel writes h (B, S, d)
// and the final (h, c, n, m), (B, d) each: the TPU kernel keeps the state
// only in VMEM scratch, serving needs it for the request's slot row.
// Semantics are those of the plain version repro_torch.kernels.ref.slstm_ref.
//
// Design.  The TPU grid (batch block, sequence chunk) ran the chunk axis in
// order with r_h resident in VMEM.  Here the recurrence is block-diagonal,
// so heads never interact and one block per (row, head) runs the whole
// sequence with no synchronisation across blocks:
//   * thread j of the block owns channel j of the head: its c, n, m live in
//     registers, its h_{t-1} in shared memory (the whole head's h, which
//     every thread's dot products read);
//   * each step, thread j computes its four gate pre-activations as four
//     dot products of h_{t-1} with columns j, dh + j, 2dh + j, 3dh + j of
//     r_h[head], reading a row of r_h coalesced across the block's threads;
//     then the gate math and the state update in registers; two barriers a
//     step (h read, h written);
//   * the step's four gx values are loaded before the dot products, so
//     their latency hides behind them.
//
// What bounds it on the H100: at the function level, operations at
// xlstm-125m's widths (the recurrent products, 8*d*dh flops a step, on
// CUDA cores in f32) or bytes at small d (gx read once, h written once,
// r_h read once: 4 * (4*B*S*d + B*S*d + H*dh*4dh + 4*B*d)).  The kernel is
// far from either: r_h[head] is dh x 4dh f32 (590 KB at dh = 192), more
// than a block's 227 KB of shared memory, so every step re-reads it from
// L2 through one SM per (row, head) -- only B*H blocks (4 at B = 1) are in
// flight, and each step waits for its 590 KB.  Splitting the dot products
// over more thread groups of the same block (more loads in flight) did not
// help: the step is held by the one SM's path to L2, not by load latency.
// Holding r_h across a cluster of blocks in distributed shared memory,
// each block owning a slice of the channels and broadcasting its h_t to
// the others, is later work.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int WARP = 32;

__global__ void slstm_scan_kernel(const float* __restrict__ gx,
                                  const float* __restrict__ r_h,
                                  float* __restrict__ out,
                                  float* __restrict__ h_last,
                                  float* __restrict__ c_last,
                                  float* __restrict__ n_last,
                                  float* __restrict__ m_last, int S, int d,
                                  int dh) {
  extern __shared__ float h_s[];  // dh: the head's h_{t-1}
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const bool live = j < dh;
  const int ch = head * dh + j;  // this thread's channel
  const int e4 = 4 * dh;
  const float* r = r_h + (size_t)head * dh * e4 + j;

  float c = 0.f, n = 0.f, m = -1e9f, h = 0.f;
  if (live) h_s[j] = 0.f;
  for (int t = 0; t < S; ++t) {
    const float* g = gx + ((size_t)b * S + t) * 4 * d + ch;
    float gi = 0.f, gf = 0.f, gz = 0.f, go = 0.f;
    if (live) {
      gi = g[0];
      gf = g[d];
      gz = g[2 * d];
      go = g[3 * d];
    }
    __syncthreads();  // h_s holds h_{t-1}
    if (live) {
      float ri = 0.f, rf = 0.f, rz = 0.f, ro = 0.f;
#pragma unroll 8
      for (int k = 0; k < dh; ++k) {
        const float hk = h_s[k];
        const float* rk = r + (size_t)k * e4;
        ri += hk * rk[0];
        rf += hk * rk[dh];
        rz += hk * rk[2 * dh];
        ro += hk * rk[3 * dh];
      }
      const float it = gi + ri, ft = gf + rf, zt = gz + rz, ot = go + ro;
      // log sigmoid(f) = -softplus(-f), softplus(x) = log1p(exp(-|x|)) +
      // max(x, 0), as jax.nn.softplus computes it
      const float lf = -(log1pf(expf(-fabsf(ft))) + fmaxf(-ft, 0.f));
      const float m1 = fmaxf(lf + m, it);
      const float ip = expf(it - m1);
      const float fp = expf(lf + m - m1);
      c = fp * c + ip * tanhf(zt);
      n = fmaxf(fp * n + ip, 1e-6f);
      m = m1;
      h = 1.f / (1.f + expf(-ot)) * c / n;
    }
    __syncthreads();  // every thread has read h_{t-1}
    if (live) {
      h_s[j] = h;
      out[((size_t)b * S + t) * d + ch] = h;
    }
  }
  if (live) {
    const size_t o = (size_t)b * d + ch;
    h_last[o] = h;
    c_last[o] = c;
    n_last[o] = n;
    m_last[o] = m;
  }
}

}  // namespace

// C entry point, loaded with ctypes by repro_torch.kernels.slstm.
// Shapes: gx (B, S, 4d); r_h (H, dh, 4dh) with dh = d / H <= 1024; out
// (B, S, d); h_last/c_last/n_last/m_last (B, d); all float32, contiguous,
// on the current device; S >= 1.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int repro_slstm_scan(const void* gx, const void* r_h, void* out,
                                void* h_last, void* c_last, void* n_last,
                                void* m_last, int B, int S, int d, int H,
                                void* stream) {
  const int dh = d / H;
  const int threads = (dh + WARP - 1) / WARP * WARP;
  const dim3 grid(H, B);
  slstm_scan_kernel<<<grid, threads, dh * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gx), static_cast<const float*>(r_h),
      static_cast<float*>(out), static_cast<float*>(h_last),
      static_cast<float*>(c_last), static_cast<float*>(n_last),
      static_cast<float*>(m_last), S, d, dh);
  return static_cast<int>(cudaGetLastError());
}
