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
                     float* __restrict__ pre_out, float* __restrict__ c_out,
                     float* __restrict__ n_out, float* __restrict__ m_out,
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
      if (pre_out != nullptr) {  // training: what the backward reads
        const size_t o = ((size_t)b * S + t) * d + head * dh + ch0 + j;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pre_out[((size_t)b * S + t) * 4 * d + q * d + head * dh + ch0 +
                  j] = pre[q];
        c_out[o] = c;
        n_out[o] = n;
        m_out[o] = m;
      }
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

// ---------------------------------------------------------------------------
// Backward: repro_slstm_scan_bwd
// ---------------------------------------------------------------------------
// No TPU kernel is its counterpart: the TPU kernel is forward only, and the
// JAX model gets these gradients from the autodiff of its `lax.scan` twin
// (repro/models/xlstm.py `slstm_block`, `_slstm_cell`).  Semantics are those
// of the plain version repro_torch.kernels.ref.slstm_bwd_ref (term by term
// JAX's: the stabiliser m carries a gradient, and max(lf + m, i) and the
// 1e-6 clamp of n split theirs 1/2 : 1/2 at a tie).  The reverse
// recurrence, per row and channel, from the final state's cotangents:
//   dh_t     = dy_t + r_h[head] @ dpre_{t+1}[head]   (the forward's product,
//              transposed)
//   dpre_t, (dc, dn, dm)_{t-1} = the cell's backward from dh_t and the
//              carried (dc, dn, dm)_t, reading the step's gate
//              pre-activations and the state before and after it
// The kernel writes d_gx = dpre (B, S, 4d).  d_r_h[head] = sum_{b,t}
// h_{t-1}^T dpre_t is not part of the recurrence: given h and dpre for all
// steps it is one batched product, which the wrapper computes after the
// kernel (as the forward's gx = x @ w_x is computed before it).
// What the forward saves, called for training: the gate pre-activations
// (B, S, 4d) and the state (c, n, m) after every step (B, S, d each), 352
// MB at xlstm-125m's train shape (B 4, S 4096, d 768).
// What bounds it on the H100: as the forward, the S sequential steps.  Each
// step's critical path is a 4dh-long dot product split over the block's
// threads, the sum of their slices, the cell's backward on one warp and one
// cluster-wide exchange of dpre_t.
// Design: the forward's cluster plan.  Grid (C, H, B), cluster (C, 1, 1),
// block c owns channels [c*cb, (c+1)*cb) of the head and holds their rows
// of r_h[head] (cb x 4dh f32, as many weights as the forward's columns) in
// registers: thread (slice, row) holds kl weights of one row.  Every block
// keeps the head's whole dpre_t in shared memory, double-buffered by the
// step's parity; each step the owning thread of a channel writes its 4
// gates' dpre into every block of the cluster (distributed shared memory)
// and one cluster barrier publishes them.  The step's inputs (dy, the
// gates, the state before the step) stream into a shared-memory ring by
// `cp.async`, GXR steps ahead.
// Left: as the forward, one cluster per (row, head), latency per step.

// The backward block's layout: thread `tid` holds row tid % cb of the
// block's r_h rows, entries [slice * kl, slice * kl + kl) of its 4dh
// (slice = tid / cb, kl a multiple of 4, zero past 4dh).
struct BwdLayout {
  int dh, cb, ks, kl, ep;
  __host__ __device__ BwdLayout(int dh_, int cb_) : dh(dh_), cb(cb_) {
    ks = MAX_THREADS / cb;
    if (ks < 1) ks = 1;
    kl = ((4 * dh + ks - 1) / ks + 3) / 4 * 4;
    ep = ks * kl;  // dpre entries held, zero past 4dh
  }
  __host__ __device__ int threads() const { return cb * ks; }
  // floats: dpre double buffer, partial sums, the step ring (8 per channel)
  __host__ __device__ int red_off() const { return 2 * ep; }
  __host__ __device__ int ring_off() const { return red_off() + ks * cb; }
  __host__ __device__ int floats() const { return ring_off() + GXR * 8 * cb; }
};

// JAX's share of max(x, y)'s cotangent that reaches x
__device__ __forceinline__ float max_share(float x, float y) {
  return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

__global__ void __launch_bounds__(MAX_THREADS)
slstm_bwd_cluster_kernel(const float* __restrict__ pre,
                         const float* __restrict__ c_out,
                         const float* __restrict__ n_out,
                         const float* __restrict__ m_out,
                         const float* __restrict__ r_h,
                         const float* __restrict__ dy,
                         const float* __restrict__ dh_T,
                         const float* __restrict__ dc_T,
                         const float* __restrict__ dn_T,
                         const float* __restrict__ dm_T,
                         float* __restrict__ d_gx, int S, int d, int dh,
                         int cb) {
  cg::cluster_group cluster = cg::this_cluster();
  const BwdLayout L(dh, cb);
  const int C = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid % cb, sl = tid / cb;
  const int ch0 = rank * cb;  // the block's first channel in the head
  const int e0 = sl * L.kl;

  extern __shared__ __align__(16) float sm[];
  float* dpb = sm;                    // [2][ep]
  float* red = sm + L.red_off();      // [ks][cb]
  float* ring = sm + L.ring_off();    // [GXR][8][cb]

  float rr[KMAX];
  {
    const bool ok = ch0 + row < dh;
    const float* rrow = r_h + ((size_t)head * dh + ch0 + row) * 4 * dh;
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      rr[i] = ok && i < L.kl && e0 + i < 4 * dh ? rrow[e0 + i] : 0.f;
  }
  for (int idx = tid; idx < 2 * L.ep; idx += blockDim.x) dpb[idx] = 0.f;

  // step t's fields for channel jj: dy, the 4 gates and the state (c, n, m)
  // before the step (zero-filled at t = 0; m is set there)
  auto issue = [&](int t) {
    for (int i = tid; i < 8 * cb; i += blockDim.x) {
      const int f = i / cb, jj = i % cb;
      const size_t ch = (size_t)head * dh + ch0 + jj;
      const size_t bt = (size_t)b * S + t;
      bool ok = ch0 + jj < dh;
      const float* src;
      if (f == 0) {
        src = dy + bt * d + ch;
      } else if (f < 5) {
        src = pre + bt * 4 * d + (size_t)(f - 1) * d + ch;
      } else {
        ok = ok && t > 0;
        const float* st = f == 5 ? c_out : f == 6 ? n_out : m_out;
        src = st + (bt - (t > 0)) * d + ch;
      }
      cp_async4(ring + ((t % GXR) * 8 + f) * cb + jj, ok ? src : dy, ok);
    }
  };
#pragma unroll
  for (int k = 0; k < GXR - 1; ++k) {
    if (S - 1 - k >= 0) issue(S - 1 - k);
    cp_commit();
  }

  const int j = tid;  // the channel thread's index in the block
  const bool live = j < cb && ch0 + j < dh;
  // the state after the step and the carried cotangents of (c, n, m)
  float c1 = 0.f, n1 = 1.f, m1 = 0.f, dc = 0.f, dn = 0.f, dm = 0.f;
  float dhT = 0.f;
  if (live) {
    const size_t ch = (size_t)head * dh + ch0 + j;
    const size_t o = ((size_t)b * S + S - 1) * d + ch;
    c1 = c_out[o];
    n1 = n_out[o];
    m1 = m_out[o];
    const size_t f = (size_t)b * d + ch;
    dhT = dh_T[f];
    dc = dc_T[f];
    dn = dn_T[f];
    dm = dm_T[f];
  }
  cluster.sync();  // every block's dpre_S = 0 is in place

  for (int t = S - 1; t >= 0; --t) {
    const float* dnext = dpb + ((t + 1) & 1) * L.ep + e0;  // dpre_{t+1}
    float* dcur = dpb + (t & 1) * L.ep;
    cp_wait<GXR - 2>();  // this thread's copies of step t have landed
    if (t - (GXR - 1) >= 0) issue(t - (GXR - 1));
    cp_commit();

    // this thread's slice of one row's product with dpre_{t+1}
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int i = 0; i < KMAX; i += 4) {
      if (i < L.kl) {  // kl is a multiple of 4
        const float4 v = *reinterpret_cast<const float4*>(dnext + i);
        a0 += v.x * rr[i];
        a1 += v.y * rr[i + 1];
        a2 += v.z * rr[i + 2];
        a3 += v.w * rr[i + 3];
      }
    }
    red[sl * cb + row] = (a0 + a1) + (a2 + a3);
    __syncthreads();  // partial sums and step t's fields are visible

    if (live) {
      const float* rg = ring + (t % GXR) * 8 * cb + j;
      float gh = rg[0] + dhT;
      dhT = 0.f;
      for (int x = 0; x < L.ks; ++x) gh += red[x * cb + j];
      const float gi = rg[cb], gf = rg[2 * cb], gz = rg[3 * cb],
                  go = rg[4 * cb];
      const float c0 = rg[5 * cb], n0 = rg[6 * cb];
      const float m0 = t > 0 ? rg[7 * cb] : -1e9f;
      // the forward's cell again (log sigmoid as it computes it)
      const float lf = -(log1pf(expf(-fabsf(gf))) + fmaxf(-gf, 0.f));
      const float u = lf + m0;
      const float ip = expf(gi - m1);
      const float fp = expf(u - m1);
      const float tz = tanhf(gz);
      const float so = 1.f / (1.f + expf(-go));
      // h1 = (so * c1) / n1
      const float dq = gh / n1;
      const float dn1 = dn - gh * (so * c1) / (n1 * n1);
      const float dc1 = dc + dq * so;
      const float dnn = dn1 * max_share(fp * n0 + ip, 1e-6f);
      const float dfp = dc1 * c0 + dnn * n0;
      const float dip = dc1 * tz + dnn;
      const float dm1 = dm - dfp * fp - dip * ip;
      const float wu = max_share(u, gi);
      const float du = dfp * fp + dm1 * wu;
      float dp[4];
      dp[0] = dip * ip + dm1 * (1.f - wu);
      dp[1] = du / (1.f + expf(gf));  // d log sigmoid(f) = sigmoid(-f)
      dp[2] = dc1 * ip * (1.f - tz * tz);
      dp[3] = dq * c1 * so * (1.f - so);
      dc = dc1 * fp;
      dn = dnn * fp;
      dm = du;
      c1 = c0;
      n1 = n0;
      m1 = m0;
      float* gout = d_gx + ((size_t)b * S + t) * 4 * d + head * dh + ch0 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) gout[(size_t)q * d] = dp[q];
      for (int r = 0; r < C; ++r) {
        float* dst = cluster.map_shared_rank(dcur, r);
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[q * dh + ch0 + j] = dp[q];
      }
    }
    cluster_barrier();  // dpre_t is in every block; dnext may be rewritten
  }
  cp_wait<0>();
}

}  // namespace

namespace {

// Launch `kernel` on a (C, H, B) grid of clusters of C blocks
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), int C, int H, int B,
                           int threads, size_t smem, void* stream,
                           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, H, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes by repro_torch.kernels.slstm.
// Shapes: gx (B, S, 4d); r_h (H, dh, 4dh) with dh = d / H; out (B, S, d);
// h_last/c_last/n_last/m_last (B, d); pre_out (B, S, 4d) and c_out/n_out/
// m_out (B, S, d) null (serving) or, for training, the gate pre-activations
// and the state after every step, which the backward reads; all float32,
// contiguous, on the current device; S >= 1.  C blocks per (row, head), each owning cb
// channels (the last ones may own fewer, or none): C in {1, 2, 4, 8, 16},
// dh <= C * cb (the wrapper's cluster_plan).  Launches on `stream` and returns the launch's
// CUDA error (0 on success).
extern "C" int repro_slstm_scan(const void* gx, const void* r_h, void* out,
                                void* h_last, void* c_last, void* n_last,
                                void* m_last, void* pre_out, void* c_out,
                                void* n_out, void* m_out, int B, int S,
                                int d, int H, int C, int cb, void* stream) {
  const int dh = d / H;
  if (C < 1 || C > MAX_CLUSTER || (C & (C - 1)) || cb < 1 || C * cb < dh)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(dh, cb);
  if (L.threads() > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_cluster(
      slstm_cluster_kernel, C, H, B, L.threads(), sizeof(float) * L.floats(),
      stream, static_cast<const float*>(gx), static_cast<const float*>(r_h),
      static_cast<float*>(out), static_cast<float*>(h_last),
      static_cast<float*>(c_last), static_cast<float*>(n_last),
      static_cast<float*>(m_last), static_cast<float*>(pre_out),
      static_cast<float*>(c_out), static_cast<float*>(n_out),
      static_cast<float*>(m_out), S, d, dh, cb));
}

// C entry point of the backward.  Shapes: pre (B, S, 4d) and c_out/n_out/
// m_out (B, S, d) as the forward wrote them for training; r_h (H, dh, 4dh);
// dy (B, S, d), the outputs' cotangent; dh_T/dc_T/dn_T/dm_T (B, d), the
// final state's; d_gx (B, S, 4d), written; all float32, contiguous, on the
// current device; S >= 1; C and cb as for the forward (the wrapper's
// cluster_plan).  Launches on `stream` and returns the launch's CUDA error
// (0 on success).
extern "C" int repro_slstm_scan_bwd(const void* pre, const void* c_out,
                                    const void* n_out, const void* m_out,
                                    const void* r_h, const void* dy,
                                    const void* dh_T, const void* dc_T,
                                    const void* dn_T, const void* dm_T,
                                    void* d_gx, int B, int S, int d, int H,
                                    int C, int cb, void* stream) {
  const int dh = d / H;
  if (C < 1 || C > MAX_CLUSTER || (C & (C - 1)) || cb < 1 || C * cb < dh)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdLayout L(dh, cb);
  if (L.threads() > MAX_THREADS || L.kl > KMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_cluster(
      slstm_bwd_cluster_kernel, C, H, B, L.threads(),
      sizeof(float) * L.floats(), stream, static_cast<const float*>(pre),
      static_cast<const float*>(c_out), static_cast<const float*>(n_out),
      static_cast<const float*>(m_out), static_cast<const float*>(r_h),
      static_cast<const float*>(dy), static_cast<const float*>(dh_T),
      static_cast<const float*>(dc_T), static_cast<const float*>(dn_T),
      static_cast<const float*>(dm_T), static_cast<float*>(d_gx), S, d, dh,
      cb));
}
