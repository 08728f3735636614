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
// What bounds it on the H100.  At the function level, operations at
// xlstm-125m's widths (the recurrent products, 8*d*dh flops a step, on
// CUDA cores in f32: ~9 us for B = 1, S = 500, d = 768, H = 4) or bytes at
// small d (gx read once, h written once, r_h read once: 4 * (4*B*S*d +
// B*S*d + H*dh*4dh + 4*B*d)).  Neither is reachable: step t needs all of
// h_{t-1}, so the S steps run one after another, and the real floor is S
// times one step's critical path -- a dh-long dot product, the gate math
// and one exchange of h_t among the blocks that share a head, a few
// hundred ns each.
//
// Design.  The TPU grid (batch block, sequence chunk) ran the chunk axis in
// order with r_h resident in VMEM.  r_h[head] is dh x 4dh f32 (590 KB at
// dh = 192), more than one SM's 227 KB of shared memory, so one cluster of
// C blocks (on C neighbouring SMs) runs each (row, head):
//   * grid (C, H, B), cluster (C, 1, 1).  Block c owns channels
//     [c*cb, (c+1)*cb) of the head (cb = ceil(dh / C), the tail masked) and
//     loads their 4*cb columns of r_h[head] into its registers once (74 KB
//     at dh = 192, C = 8: thread (k-slice, column) holds at most KMAX
//     weights of one column); the wrapper picks C (kernels/slstm.py
//     `cluster_plan`);
//   * every block holds the whole head's h_{t-1} in its own shared memory,
//     double-buffered by the step's parity.  Each step, thread (k-slice,
//     column) sums its slice of one column's dot product, the slices are
//     added through shared memory, and thread j < cb runs the gate math of
//     channel c*cb + j (c, n, m and h in registers) and writes h_t into
//     every block of the cluster (distributed shared memory); one cluster
//     barrier (arrive.release / wait.acquire) a step publishes it;
//   * gx for the coming steps streams into a shared-memory ring by 4-byte
//     `cp.async`, GXR steps ahead, off the critical path;
//   * the h outputs are staged in shared memory and written in tiles of OT
//     steps.
//
// What is left: B > 1 runs one cluster per (row, head) rather than packing
// rows into a cluster's products; each step's critical path (the sum of
// the slices, the gate math on one warp, the exchange) is latency; the
// mLSTM prefill stays plain PyTorch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int WARP = 32;
constexpr int GXR = 8;       // gx ring depth, steps
constexpr int OT = 32;       // steps of h staged per output tile
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_THREADS = 512;
constexpr int KMAX = 80;     // r_h weights a thread holds in registers

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 4-byte async copy global -> shared; `ok` false zero-fills
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The block's layout, shared by the host (threads, shared-memory size)
// and the kernel.  Columns are gate * cb + j (j < cb), padded to whole
// warps; the k axis (dh) is cut into ks slices of kl <= KMAX rows (kl a
// multiple of 4), so thread (slice, column) holds kl weights in registers.
struct Layout {
  int dh, cb, nc, cw, ks, kl, hp;
  __host__ __device__ Layout(int dh_, int cb_) : dh(dh_), cb(cb_) {
    nc = 4 * cb;
    cw = (nc + WARP - 1) / WARP * WARP;
    const int by_threads = MAX_THREADS / cw;
    const int by_regs = (dh + KMAX - 1) / KMAX;
    ks = by_threads > by_regs ? by_threads : by_regs;
    if (ks < 1) ks = 1;
    kl = ((dh + ks - 1) / ks + 3) / 4 * 4;
    hp = ks * kl;  // h rows, zero past dh
  }
  __host__ __device__ int threads() const { return cw * ks; }
  // floats: h double buffer, partial sums, gx ring, out tile
  __host__ __device__ int h_off() const { return 0; }
  __host__ __device__ int red_off() const { return 2 * hp; }
  __host__ __device__ int gx_off() const { return red_off() + ks * cw; }
  __host__ __device__ int out_off() const { return gx_off() + GXR * nc; }
  __host__ __device__ int floats() const { return out_off() + OT * cb; }
};

__global__ void __launch_bounds__(MAX_THREADS)
slstm_cluster_kernel(const float* __restrict__ gx,
                     const float* __restrict__ r_h, float* __restrict__ out,
                     float* __restrict__ h_last, float* __restrict__ c_last,
                     float* __restrict__ n_last, float* __restrict__ m_last,
                     int S, int d, int dh, int cb) {
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L(dh, cb);
  const int C = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int col = tid % L.cw, ks = tid / L.cw;
  const int ch0 = rank * cb;  // the block's first channel in the head
  const int k0 = ks * L.kl;

  extern __shared__ __align__(16) float sm[];
  float* hb = sm + L.h_off();       // [2][hp]
  float* red = sm + L.red_off();    // [ks][cw]
  float* gxr = sm + L.gx_off();     // [GXR][nc]
  float* os = sm + L.out_off();     // [OT][cb]

  // this thread's kl weights of column `col` of the block's r_h slice,
  // rows k0 .. k0 + kl - 1, once; zero past dh and past the channels
  float rr[KMAX];
  {
    const int gate = col / cb, ch = ch0 + col % cb;
    const bool ok = col < L.nc && ch < dh;
    const float* rc = r_h + (size_t)head * dh * 4 * dh + gate * dh + ch;
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      rr[i] = ok && i < L.kl && k0 + i < dh
                  ? rc[(size_t)(k0 + i) * 4 * dh]
                  : 0.f;
  }
  for (int idx = tid; idx < 2 * L.hp; idx += blockDim.x) hb[idx] = 0.f;

  // gx of step t for column tid (gate tid / cb, channel ch0 + tid % cb)
  const bool gx_live = tid < L.nc && ch0 + tid % cb < dh;
  const float* gx_col = gx + (size_t)b * S * 4 * d + (tid / cb) * d +
                        head * dh + ch0 + tid % cb;
  auto issue_gx = [&](int t) {
    if (tid < L.nc)
      cp_async4(gxr + (t % GXR) * L.nc + tid,
                gx_live ? gx_col + (size_t)t * 4 * d : gx, gx_live);
  };
#pragma unroll
  for (int t = 0; t < GXR - 1; ++t) {
    if (t < S) issue_gx(t);
    cp_commit();
  }

  const int j = tid;  // the channel thread's index in the block
  const bool live = j < cb && ch0 + j < dh;
  float c = 0.f, n = 0.f, m = -1e9f, h = 0.f;
  cluster.sync();  // every block's h_{-1} = 0 is in place

  for (int t = 0; t < S; ++t) {
    const float* hprev = hb + (t & 1) * L.hp + k0;
    float* hnext = hb + ((t + 1) & 1) * L.hp;
    cp_wait<GXR - 2>();  // this thread's copy of step t's gx has landed
    if (t + GXR - 1 < S) issue_gx(t + GXR - 1);
    cp_commit();

    // this thread's slice of one column's dot product with h_{t-1}, in
    // four independent sums (a short dependency chain)
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int i = 0; i < KMAX; i += 4) {
      if (i < L.kl) {  // kl is a multiple of 4
        const float4 hk = *reinterpret_cast<const float4*>(hprev + i);
        a0 += hk.x * rr[i];
        a1 += hk.y * rr[i + 1];
        a2 += hk.z * rr[i + 2];
        a3 += hk.w * rr[i + 3];
      }
    }
    red[ks * L.cw + col] = (a0 + a1) + (a2 + a3);
    __syncthreads();  // partial sums and step t's gx are visible

    if (live) {
      const float* g = gxr + (t % GXR) * L.nc + j;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = g[q * cb];
        for (int x = 0; x < L.ks; ++x) s += red[x * L.cw + q * cb + j];
        pre[q] = s;
      }
      // log sigmoid(f) = -softplus(-f), softplus(x) = log1p(exp(-|x|)) +
      // max(x, 0), as jax.nn.softplus computes it
      const float lf = -(log1pf(expf(-fabsf(pre[1]))) + fmaxf(-pre[1], 0.f));
      const float m1 = fmaxf(lf + m, pre[0]);
      const float ip = expf(pre[0] - m1);
      const float fp = expf(lf + m - m1);
      c = fp * c + ip * tanhf(pre[2]);
      n = fmaxf(fp * n + ip, 1e-6f);
      m = m1;
      h = 1.f / (1.f + expf(-pre[3])) * c / n;
      os[(t % OT) * cb + j] = h;
      for (int r = 0; r < C; ++r)
        cluster.map_shared_rank(hnext, r)[ch0 + j] = h;
    }
    cluster_barrier();  // h_t is in every block; hprev may be rewritten

    if ((t + 1) % OT == 0 || t == S - 1) {  // write the staged tile
      const int t0 = t - t % OT;
      const int rows = t - t0 + 1;
      for (int idx = tid; idx < rows * cb; idx += blockDim.x) {
        const int row = idx / cb, jj = idx % cb;
        if (ch0 + jj < dh)
          out[((size_t)b * S + t0 + row) * d + head * dh + ch0 + jj] =
              os[row * cb + jj];
      }
    }
  }
  cp_wait<0>();
  if (live) {
    const size_t o = (size_t)b * d + head * dh + ch0 + j;
    h_last[o] = h;
    c_last[o] = c;
    n_last[o] = n;
    m_last[o] = m;
  }
}

}  // namespace

// C entry point, loaded with ctypes by repro_torch.kernels.slstm.
// Shapes: gx (B, S, 4d); r_h (H, dh, 4dh) with dh = d / H; out (B, S, d);
// h_last/c_last/n_last/m_last (B, d); all float32, contiguous, on the
// current device; S >= 1.  C blocks per (row, head), each owning cb
// channels (the last ones may own fewer, or none): C in {1, 2, 4, 8, 16},
// dh <= C * cb (the wrapper's cluster_plan).  Launches on `stream` and returns the launch's
// CUDA error (0 on success).
extern "C" int repro_slstm_scan(const void* gx, const void* r_h, void* out,
                                void* h_last, void* c_last, void* n_last,
                                void* m_last, int B, int S, int d, int H,
                                int C, int cb, void* stream) {
  const int dh = d / H;
  if (C < 1 || C > MAX_CLUSTER || (C & (C - 1)) || cb < 1 || C * cb < dh)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(dh, cb);
  if (L.threads() > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * L.floats();
  cudaError_t err = cudaFuncSetAttribute(
      slstm_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(slstm_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, H, B);
  cfg.blockDim = dim3(L.threads());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, slstm_cluster_kernel, static_cast<const float*>(gx),
      static_cast<const float*>(r_h), static_cast<float*>(out),
      static_cast<float*>(h_last), static_cast<float*>(c_last),
      static_cast<float*>(n_last), static_cast<float*>(m_last), S, d, dh, cb);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
