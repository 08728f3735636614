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
// What bounds it on the H100: as the forward, the S sequential steps, so
// the design shortens one step's critical path: dpre_{t+1} complete in the
// block -> a 4dh-long dot product per channel -> the cell's backward ->
// dpre_t in every block of the cluster.
// Design: the forward's cluster plan.  Grid (C, H, B), cluster (C, 1, 1),
// block c owns channels [c*cb, (c+1)*cb) of the head and holds their rows
// of r_h[head] (cb x 4dh f32) in registers.
//   * Rows on adjacent lanes.  A row is run by ks adjacent lanes of one
//     warp (8 at xlstm-125m's dh = 192; BwdLayout), each holding kl = 4
//     ceil(dh / ks) of its weights; dpre is kept channel-major (the 4
//     gates of channel jj at 4 jj), and slice s takes the channels s, s +
//     ks, ..., so the lanes read adjacent float4s.  The slices are summed
//     by a log2(ks)-round shuffle tree, and every lane of the row then has
//     dh_t: no block barrier, no serial sum of slices on one thread.
//   * Two blocks an SM.  A block of 192 threads holding 96 weights each
//     (166 registers, no spills) leaves room for a second, so all 16
//     clusters of a B = 4 call are resident at once.
//   * The cell's coefficients off the critical path.  Given what the
//     forward saved, the cell's backward is linear in (dh_t, dc, dn, dm):
//     every factor (ip, fp, tanh z, sigma(o), sigma(-f), 1/n1, the two
//     1/2-at-a-tie shares of the max and the clamp, read from the forward's
//     values as before) depends on the saved gates and states only.  Each
//     lane of a row computes the factors of one of the row's next ks steps
//     (the fields streamed in by cp.async a batch of ks steps ahead) into
//     shared memory, once per batch; on the critical path remain the
//     linear update of (dh, dc, dn, dm) and the four dpre, a dozen FMAs.
//   * Point-to-point exchange.  Each block has an mbarrier per dpre buffer
//     parity.  The row's lane r sends the channel's 4 dpre to block r with
//     one st.async of 16 bytes, which also completes 16 bytes of that
//     block's barrier; a block's barrier phase expects 16 dh bytes (one
//     thread arms it), and a warp waits only on its own block's barrier.
//     The double buffer is safe with that wait alone: dpre_{t-1} reaches a
//     block's buffer (t-1) & 1 only from a block that saw dpre_t complete,
//     that is after every channel of the head sent dpre_t, and each warp
//     sends dpre_t only after its last read of dpre_{t+1} in that buffer.
//     A warp with no live channel, and a block with none, leave right after
//     the start (no dpre is sent to such a block).
// Left: B > 1 runs one cluster per (row, head), and at B = 4 two blocks
// share an SM (a step 1.27 us against 0.85 us at B <= 2, PERF.md); a step
// is still a chain of latencies (the barrier's wait, the dot product,
// three shuffle rounds, the remote stores' flight).

// fields a lane streams in for one step: dy, the 4 gates, (c, n, m) after
// and before the step
constexpr int RAW = 12;  // 11 used
// the step's factors: dy, 1/n1, sigma(o), h1 = sigma(o) c1 / n1, the clamp's
// share, c0, n0, tanh z, fp, ip, the max's share wu and 1 - wu, sigma(-f),
// ip (1 - tanh^2 z), c1 sigma(o) (1 - sigma(o))
constexpr int COEF = 16;  // 15 used
enum { F_DY, F_RN, F_SO, F_HQ, F_SN, F_C0, F_N0, F_TZ, F_FP, F_IP, F_WU,
       F_WC, F_SF, F_KZ, F_PO };

// The backward's limits: threads a block, and r_h weights a lane
constexpr int BWD_THREADS = 448;
constexpr int BWD_KMAX = 96;

// The backward block's layout, shared by the host (threads, shared-memory
// size) and the kernel: thread tid runs slice tid % ks of row tid / ks
// (rows past cb idle).  ks is the fewest of 4, 8, 16 lanes whose slices
// hold at most BWD_KMAX weights: fewer threads a block, so that at
// xlstm-125m's dh = 192 (ks = 8, 96 weights a lane, 192 threads) two
// blocks fit an SM and the H100 holds 30 clusters of 8 at once: all 16 of
// a B = 4 call (with 16 lanes a row, 384 threads of 128 registers, one
// block an SM, it holds 15, and the 16th ran as a second wave).  The
// repro_torch.kernels.slstm `bwd_plan` mirrors it.
struct BwdLayout {
  int dh, cb, ks, kl, ep;
  __host__ __device__ BwdLayout(int dh_, int cb_) : dh(dh_), cb(cb_) {
    ks = 4;
    while (ks < 16 && 4 * ((dh + ks - 1) / ks) > BWD_KMAX) ks *= 2;
    kl = 4 * ((dh + ks - 1) / ks);
    ep = ks * kl;  // floats of one dpre buffer, zero past 4dh
  }
  __host__ __device__ int threads() const {
    return (cb * ks + WARP - 1) / WARP * WARP;
  }
  __host__ __device__ int rows() const { return threads() / ks; }
  // floats: two mbarriers (4), the dpre double buffer, each row's raw
  // fields ([2][ks][RAW]) and factors ([ks][COEF]), idle rows included
  __host__ __device__ int dp_off() const { return 4; }
  __host__ __device__ int raw_off() const { return dp_off() + 2 * ep; }
  __host__ __device__ int coef_off() const {
    return raw_off() + rows() * 2 * ks * RAW;
  }
  __host__ __device__ int floats() const {
    return coef_off() + rows() * ks * COEF;
  }
};

// JAX's share of max(x, y)'s cotangent that reaches x
__device__ __forceinline__ float max_share(float x, float y) {
  return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// one arrival, and `bytes` more of asynchronous writes to expect
__device__ __forceinline__ void bar_arm(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// until the phase of the given parity has completed; acquire at cluster
// scope: the st.async writes it counted are visible after it
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// the address of the same shared-memory location in block `rank`
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
// 16 bytes into another block's shared memory, completing 16 bytes of the
// transactions its barrier `bar` expects
__device__ __forceinline__ void st_async4(unsigned addr, unsigned bar,
                                          float a, float b, float c,
                                          float d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(a)), "r"(__float_as_uint(b)),
      "r"(__float_as_uint(c)), "r"(__float_as_uint(d)), "r"(bar)
      : "memory");
}

// KS: lanes a row (BwdLayout's ks, a constant: with ks read at run time
// the step took twice as long); KL: the weights a lane holds (registers);
// LB: the most threads a block
template <int KS, int KL, int LB>
__global__ void __launch_bounds__(LB)
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
  const BwdLayout L(dh, cb);  // L.ks == KS
  constexpr int ks = KS;
  const int C = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int ranks = min(C, (dh + cb - 1) / cb);  // blocks owning a channel
  const int head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / ks, s = tid % ks;  // the row and its slice
  const int ch0 = rank * cb;  // the block's first channel in the head
  const int ch = ch0 + row;   // the row's channel in the head
  const bool live = row < cb && ch < dh;
  const int wrow = (tid & ~(WARP - 1)) / ks;  // the warp's first row
  const bool warp_live = wrow < cb && ch0 + wrow < dh && rank < ranks;

  extern __shared__ __align__(16) float sm[];
  const unsigned bar0 = smem_u32(sm);  // two mbarriers, 8 bytes each
  float* dpb = sm + L.dp_off();        // [2][ep]
  float* raw = sm + L.raw_off() + row * 2 * ks * RAW;  // [2][ks][RAW]
  float* coef = sm + L.coef_off() + row * ks * COEF;   // [ks][COEF]

  // this lane's weights of its row: rr[4m + g] = r_h[head][ch][g dh + jj]
  // for channel jj = m ks + s of the head (zero past dh)
  float rr[KL];
  {
    const float* rrow = r_h + ((size_t)head * dh + (live ? ch : 0)) * 4 * dh;
#pragma unroll
    for (int i = 0; i < KL; ++i) {
      const int jj = (i / 4) * ks + s;
      rr[i] = live && i < L.kl && jj < dh ? rrow[(i % 4) * dh + jj] : 0.f;
    }
  }
  for (int idx = tid; idx < 2 * L.ep; idx += blockDim.x) dpb[idx] = 0.f;
  if (tid == 0) {
    bar_init(bar0, 1);
    bar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first phases: dpre_{S-1} and dpre_{S-2}
    bar_arm(bar0 + 8 * ((S - 1) & 1), 16 * dh);
    if (S >= 2) bar_arm(bar0 + 8 * (S & 1), 16 * dh);
  }
  cluster.sync();  // barriers and zeroed buffers are in place everywhere
  if (!warp_live) return;  // no live row: nothing to send or to wait for

  // lane s of a row streams in the fields of step tb - s of the batch
  // starting at tb (zero-filled before step 0; m is set there)
  const size_t cho = (size_t)head * dh + (live ? ch : 0);
  auto issue = [&](int tb, int buf) {
    const int t = tb - s;
    const bool ok = live && t >= 0;
    const size_t bt = (size_t)b * S + (ok ? t : 0);
    const float* src[11] = {
        dy + bt * d + cho,
        pre + bt * 4 * d + cho,
        pre + bt * 4 * d + d + cho,
        pre + bt * 4 * d + 2 * (size_t)d + cho,
        pre + bt * 4 * d + 3 * (size_t)d + cho,
        c_out + bt * d + cho,
        n_out + bt * d + cho,
        m_out + bt * d + cho,
        c_out + (bt - (t > 0)) * d + cho,
        n_out + (bt - (t > 0)) * d + cho,
        m_out + (bt - (t > 0)) * d + cho};
    float* dst = raw + (buf * ks + s) * RAW;
#pragma unroll
    for (int f = 0; f < 11; ++f)
      cp_async4(dst + f, src[f], f < 8 ? ok : ok && t > 0);
  };
  const int batches = (S + ks - 1) / ks;
  issue(S - 1, 0);
  cp_commit();
  if (batches > 1) issue(S - 1 - ks, 1);
  cp_commit();

  // the carried cotangents of the state after the step
  float dc = 0.f, dn = 0.f, dm = 0.f, dhT = 0.f;
  if (live) {
    const size_t f = (size_t)b * d + cho;
    dhT = dh_T[f];
    dc = dc_T[f];
    dn = dn_T[f];
    dm = dm_T[f];
  }
  unsigned phase = 0;  // bit p: the parity of barrier p's next phase
  for (int k = 0; k < batches; ++k) {
    const int tb = S - 1 - k * ks;
    cp_wait<1>();  // this lane's fields of batch k have landed
    {
      const float* rw = raw + ((k & 1) * ks + s) * RAW;
      const int t = tb - s;
      const float gi = rw[1], gf = rw[2], gz = rw[3], go = rw[4];
      const float c1 = rw[5], n1 = rw[6], m1 = rw[7], c0 = rw[8], n0 = rw[9];
      const float m0 = t > 0 ? rw[10] : -1e9f;
      // the forward's cell again (log sigmoid as it computes it)
      const float lf = -(log1pf(expf(-fabsf(gf))) + fmaxf(-gf, 0.f));
      const float u = lf + m0;
      const float ip = expf(gi - m1);
      const float fp = expf(u - m1);
      const float tz = tanhf(gz);
      const float so = 1.f / (1.f + expf(-go));
      const float rn = 1.f / n1;
      const float wu = max_share(u, gi);
      float* cf = coef + s * COEF;
      cf[F_DY] = rw[0];
      cf[F_RN] = rn;
      cf[F_SO] = so;
      cf[F_HQ] = so * c1 * rn;
      cf[F_SN] = max_share(fp * n0 + ip, 1e-6f);
      cf[F_C0] = c0;
      cf[F_N0] = n0;
      cf[F_TZ] = tz;
      cf[F_FP] = fp;
      cf[F_IP] = ip;
      cf[F_WU] = wu;
      cf[F_WC] = 1.f - wu;
      cf[F_SF] = 1.f / (1.f + expf(gf));  // d log sigmoid(f) = sigmoid(-f)
      cf[F_KZ] = ip * (1.f - tz * tz);
      cf[F_PO] = c1 * so * (1.f - so);
    }
    if (k + 2 < batches) issue(tb - 2 * ks, k & 1);
    cp_commit();
    __syncwarp();  // the row's factors of the batch are in place

    const int steps = min(ks, tb + 1);
    for (int i = 0; i < steps; ++i) {
      const int t = tb - i;
      float cf[COEF];
#pragma unroll
      for (int x = 0; x < COEF / 4; ++x) {
        const float4 v = reinterpret_cast<const float4*>(coef + i * COEF)[x];
        cf[4 * x] = v.x, cf[4 * x + 1] = v.y, cf[4 * x + 2] = v.z,
                cf[4 * x + 3] = v.w;
      }
      float dot = 0.f;
      if (t < S - 1) {
        const int p = (t + 1) & 1;  // dpre_{t+1}'s buffer and barrier
        bar_wait(bar0 + 8 * p, (phase >> p) & 1);
        phase ^= 1u << p;
        if (tid == 0 && t >= 1) bar_arm(bar0 + 8 * p, 16 * dh);  // dpre_{t-1}
        // this slice's part of the row's product with dpre_{t+1}, in four
        // independent sums (a short dependency chain)
        const float4* dnext =
            reinterpret_cast<const float4*>(dpb + p * L.ep) + s;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int m = 0; m < KL / 4; ++m) {
          if (4 * m < L.kl) {
            const float4 v = dnext[m * ks];
            a0 = fmaf(v.x, rr[4 * m], a0);
            a1 = fmaf(v.y, rr[4 * m + 1], a1);
            a2 = fmaf(v.z, rr[4 * m + 2], a2);
            a3 = fmaf(v.w, rr[4 * m + 3], a3);
          }
        }
        dot = (a0 + a1) + (a2 + a3);
#pragma unroll
        for (int o = ks / 2; o > 0; o /= 2)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      // the cell's backward, linear in (gh, dc, dn, dm); h1 = (so c1) / n1
      const float gh = dot + cf[F_DY] + dhT;
      dhT = 0.f;
      const float dq = gh * cf[F_RN];
      const float dc1 = fmaf(dq, cf[F_SO], dc);
      const float dn1 = fmaf(-dq, cf[F_HQ], dn);
      const float dnn = dn1 * cf[F_SN];
      const float dfp = fmaf(dc1, cf[F_C0], dnn * cf[F_N0]);
      const float dip = fmaf(dc1, cf[F_TZ], dnn);
      const float dm1 = dm - dfp * cf[F_FP] - dip * cf[F_IP];
      const float du = fmaf(dfp, cf[F_FP], dm1 * cf[F_WU]);
      const float di = fmaf(dip, cf[F_IP], dm1 * cf[F_WC]);
      const float df = du * cf[F_SF];
      const float dz = dc1 * cf[F_KZ];
      const float dov = dq * cf[F_PO];
      dc = dc1 * cf[F_FP];
      dn = dnn * cf[F_FP];
      dm = du;
      if (live) {
        if (s < ranks) {  // dpre_t into block s's buffer t & 1
          const int q = t & 1;
          st_async4(map_rank(smem_u32(dpb + q * L.ep + 4 * ch), s),
                    map_rank(bar0 + 8 * q, s), di, df, dz, dov);
        }
        if (s < 4)
          d_gx[((size_t)b * S + t) * 4 * d + (size_t)s * d + cho] =
              s == 0 ? di : s == 1 ? df : s == 2 ? dz : dov;
      }
    }
    __syncwarp();  // the batch's factors are read before they are rewritten
  }
  // dpre_0's phase: no write into this block is still in flight at exit
  bar_wait(bar0, phase & 1);
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
  if (L.threads() > BWD_THREADS || L.kl > BWD_KMAX || C > L.ks)
    return static_cast<int>(cudaErrorInvalidValue);  // lane r sends to r
  auto run = [&](auto kernel) {
    return static_cast<int>(launch_cluster(
        kernel, C, H, B, L.threads(), sizeof(float) * L.floats(), stream,
        static_cast<const float*>(pre), static_cast<const float*>(c_out),
        static_cast<const float*>(n_out), static_cast<const float*>(m_out),
        static_cast<const float*>(r_h), static_cast<const float*>(dy),
        static_cast<const float*>(dh_T), static_cast<const float*>(dc_T),
        static_cast<const float*>(dn_T), static_cast<const float*>(dm_T),
        static_cast<float*>(d_gx), S, d, dh, cb));
  };
  // xlstm-125m's dh = 192: 8 lanes a row, 96 weights a lane, 192 threads,
  // bounded at 256 threads so that ptxas may give a thread the registers
  // it needs (bounded at 448 it spills); two blocks then share an SM
  switch (L.ks) {
    case 4:
      return L.kl <= 48 ? run(slstm_bwd_cluster_kernel<4, 48, BWD_THREADS>)
                        : run(slstm_bwd_cluster_kernel<4, 96, BWD_THREADS>);
    case 8:
      return L.threads() <= 256
                 ? run(slstm_bwd_cluster_kernel<8, 96, 256>)
                 : run(slstm_bwd_cluster_kernel<8, 96, BWD_THREADS>);
    default:  // dh <= MAX_HEAD_DIM = 307 keeps kl <= 80
      if (L.kl > 80) return static_cast<int>(cudaErrorInvalidValue);
      return run(slstm_bwd_cluster_kernel<16, 80, BWD_THREADS>);
  }
}
