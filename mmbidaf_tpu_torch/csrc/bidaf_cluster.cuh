// What K2 and K7 (csrc/bidaf.cu, bidaf_fwd_cluster_kernel and
// bidaf_drop_fwd_cluster_kernel) and K8 (csrc/bidaf_bwd.cu,
// bidaf_drop_bwd_cluster_kernel) share: the split of one example over T_q
// across a thread-block cluster, the host-side plan that sizes it, the
// shared-memory layouts, the register-blocked products over shared memory,
// and the launch.
//
// Split. One cluster of C blocks serves one example (grid (C, B), clusters
// along x, so a block's rank is blockIdx.x). Rank r owns the q columns
// [r·tq, min((r+1)·tq, T_q)): the last tile is shorter, none is empty, and
// no column is padded. Every tile holds all T_c rows, so the column softmax
// over T_c is exact inside a block; the row softmax over T_q is combined
// from each tile's row maximum m_J and row sum l_J as K9 does (weights
// w_J = exp(m_J - M) / Σ_J exp(m_J - M)·l_J, M the largest m_J). Rank r also
// owns the D columns [r·D/C, (r+1)·D/C) of every [T_c, D] result that is a
// sum over the tiles: it reads the C partials through distributed shared
// memory (cluster.map_shared_rank) and adds them in rank order, so there are
// no atomics and two runs agree bit for bit.
//
// Plan. C = ceil(T_q / kTargetTile) up to kMaxCluster, tq = ceil(T_q / C),
// then C = ceil(T_q / tq) (so no tile is empty). Past C = 16 the tiles grow
// instead; where the block's shared memory no longer fits 227 KB K7 and K8
// raise C (up to 16) before there is no plan. K7 and K8 take the same plan,
// sized by K8's layout (at T_c=32, D=256: none past T_q = 1088; at T_c >= 48
// none at all), and their wrappers hand what it refuses to the tiled route
// (csrc/bidaf_tiled.cu's walk for K7, csrc/bidaf_tiled_bwd.cu for K8);
// 64-column tiles would make K8 faster and K7 slower
// (tools/bidaf_variants.py, `tile64`). K2, the serving forward, needs only
// the forward section of the layout (fwd_floats), so its plan holds further
// (at T_c=32, D=256: to T_q = 2048); its wrapper hands longer T_q to K9.
// ops/cuda/bidaf_kernel.py::drop_plan and ::fused_plan mirror this function.
// K9 (csrc/bidaf_tiled.cu) takes the launch and combine_rows with a plan
// and layout of its own.
//
// Row strides in shared memory are odd (D | 1, tq | 1, T_c | 1 floats): a
// warp's threads walk neighbouring rows or neighbouring columns of every
// operand, and an odd stride puts either on 32 distinct banks.
#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace mmb {
namespace bidafc {

namespace cg = cooperative_groups;

// Threads a block: K8 has more latency to hide (more copies and exchanges a
// block) and gains from 16 warps, K7 loses (tools/bidaf_variants.py on an
// H100 at T_q=512: K8 at 256 took 1.22x as long, K7 at 512 1.20x).
constexpr int kThreadsFwd = 256;
constexpr int kThreadsBwd = 512;
constexpr int kTargetTile = 32;   // q columns a block, where T_q allows
constexpr int kMaxCluster = 16;

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~size_t(3); }

// The offset of a new section of n floats at o; o moves past it.
__host__ __device__ inline size_t take(size_t& o, size_t n) {
  const size_t at = o;
  o += round4(n);
  return at;
}

// Shared-memory layout of a block, in floats; every section starts on a
// 16-byte boundary. K2 and K7 use the first part (tile … cs); K8 all of it.
struct Layout {
  int LD, LQ, LT;  // odd row strides of [*, D], [*, tq] and [*, T_c] arrays
  int ND;          // odd row stride of [*, D columns of the widest rank]
  size_t tile, cw, sr, sc, ss, pp, pf, s0, m, l, s1, wts, lw, cs;  // K7 and K8
  size_t da, x, dsc, e, ep, rsq, rs, ds0p, ds0, ds1, wq;   // K8 only
  size_t fwd_floats, bwd_floats;

  __host__ __device__ Layout(int Tc, int tq, int D, int C) {
    LD = D | 1, LQ = tq | 1, LT = Tc | 1, ND = ((D + C - 1) / C) | 1;
    size_t o = 0;
    tile = take(o, (size_t)tq * LD);  // [tq][LD]  the qd tile, then q's (K2: q's)
    cw = take(o, (size_t)Tc * LD);    // [Tc][LD]  cd∘w_cq (K2, K7: then a_J)
    sr = take(o, (size_t)Tc * LQ);    // [Tc][LQ]  p, then (K8) s_row
    sc = take(o, (size_t)Tc * LQ);    // [Tc][LQ]  s_col
    ss = take(o, (size_t)Tc * LQ);    // [Tc][LQ]  S, then (K8) dS
    pp = take(o, (size_t)Tc * LT);    // [Tc][LT]  P_J = p·s_colᵀ (read by the cluster)
    pf = take(o, (size_t)Tc * LT);    // [Tc][LT]  P, combined
    s0 = take(o, Tc);                 // cd·w_c
    m = take(o, Tc);                  // the tile's row maxima (read by the cluster)
    l = take(o, Tc);                  // the tile's row sums (read by the cluster)
    s1 = take(o, tq);                 // qd·w_q of the tile
    wts = take(o, (size_t)C * Tc);    // [C][Tc]   every tile's m, then w_J
    lw = take(o, (size_t)C * Tc);     // [C][Tc]   every tile's l
    cs = take(o, 2 * (size_t)Tc * ND);  // [2][Tc][ND] this rank's D columns of c, (K8) of d_b
    fwd_floats = o;
    da = take(o, (size_t)Tc * LD);    // [Tc][LD]  c, then d_a = g1 + g2∘c, then dS·qd summed
    x = take(o, (size_t)Tc * LD);     // [Tc][LD]  g2, then a_J, then dS_J·qd_J
    dsc = take(o, (size_t)Tc * LQ);   // [Tc][LQ]  d_s_col = Eᵀ·s_row
    e = take(o, (size_t)Tc * LT);     // [Tc][LT]  E = d_b·cᵀ
    ep = take(o, (size_t)Tc * LT);    // [Tc][LT]  E_r over this rank's D columns (read by the cluster)
    rsq = take(o, Tc);                // rowsum(d_s_row∘s_row) over the tile (read by the cluster)
    rs = take(o, Tc);                 // rowsum(d_s_row∘s_row)
    ds0p = take(o, Tc);               // rowsum(dS_J) (read by the cluster)
    ds0 = take(o, Tc);                // rowsum(dS)
    ds1 = take(o, tq);                // colsum(dS_J)
    wq = take(o, D);                  // Σ_j qd_j·colsum(dS)_j over the tile
    bwd_floats = o;
  }
};

struct Plan {
  int C;   // blocks a cluster (tiles of an example)
  int tq;  // q columns of the widest tile
  int smem_fwd, smem_bwd;  // dynamic shared memory of a K2 or K7 / K8 block, bytes
};

// The plan for one example of T_c x T_q at width D; false if the block does
// not fit (K8's, or with fwd_only K2's forward section) or the shape is
// empty. K7 / K8 first take the split above; where K8's block does not fit
// it they ask for one more block at a time, up to kMaxCluster (and T_q),
// before they refuse: narrower tiles shrink the [T_c, tq] sections and
// every rank's share of the D columns (at T_c=32, T_q=32, D=256 one tile
// of 32 needs 233,600 bytes, two of 16 fit). K2 keeps the first split: its
// wrapper hands what that does not hold to K9.
inline bool plan(int Tc, int Tq, int D, Plan* p, bool fwd_only = false) {
  if (Tc <= 0 || Tq <= 0 || D <= 0) return false;
  int C0 = (Tq + kTargetTile - 1) / kTargetTile;
  if (C0 > kMaxCluster) C0 = kMaxCluster;
  const int c_max = fwd_only ? C0 : (Tq < kMaxCluster ? Tq : kMaxCluster);
  for (int asked = C0; asked <= c_max; ++asked) {
    const int tq = (Tq + asked - 1) / asked;
    const int C = (Tq + tq - 1) / tq;
    const Layout lay(Tc, tq, D, C);
    if (4 * (fwd_only ? lay.fwd_floats : lay.bwd_floats) <= (size_t)kMaxSmemBytes) {
      *p = {C, tq, (int)(4 * lay.fwd_floats), (int)(4 * lay.bwd_floats)};
      return true;
    }
  }
  return false;
}

// The launch configuration: grid (C, B), clusters of C blocks along x.
struct LaunchConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

template <typename Kernel>
cudaError_t configure(Kernel kernel, const Plan& p, int B, int threads, int smem,
                      cudaStream_t stream, LaunchConfig* lc) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && p.C > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  lc->cfg = cudaLaunchConfig_t{};
  lc->cfg.gridDim = dim3(p.C, B, 1);
  lc->cfg.blockDim = dim3(threads);
  lc->cfg.dynamicSmemBytes = smem;
  lc->cfg.stream = stream;
  lc->attr[0].id = cudaLaunchAttributeClusterDimension;
  lc->attr[0].val.clusterDim.x = p.C;
  lc->attr[0].val.clusterDim.y = 1;
  lc->attr[0].val.clusterDim.z = 1;
  lc->cfg.attrs = lc->attr;
  lc->cfg.numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of this plan the card holds at once (0: none); a
// negative cudaError_t on failure.
template <typename Kernel>
int max_active_clusters(Kernel kernel, const Plan& p, int threads, int smem) {
  LaunchConfig lc;
  cudaError_t e = configure(kernel, p, 1, threads, smem, nullptr, &lc);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &lc.cfg);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, const Plan& p, int B, int threads, int smem, cudaStream_t stream,
                   Args... args) {
  LaunchConfig lc;
  cudaError_t e = configure(kernel, p, B, threads, smem, stream, &lc);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&lc.cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Device side.
// ---------------------------------------------------------------------------

// An [M, N] result over the block in register micro-tiles of TM x TN: thread
// t takes rows tm + ii·ntm and columns tn + jj·ntn (interleaved, so a warp's
// threads touch neighbouring rows and columns), ``body(ms, ns, acc)``
// accumulates the tile (ms / ns clamped into range, so loads need no guard),
// and ``epi(m, n, v)`` stores each entry inside [M, N).
template <int TM, int TN, typename Body, typename Epi>
__device__ __forceinline__ void block_tiles(int M, int N, Body body, Epi epi) {
  const int ntm = (M + TM - 1) / TM, ntn = (N + TN - 1) / TN;
  for (int t = threadIdx.x; t < ntm * ntn; t += blockDim.x) {
    const int tm = t / ntn, tn = t - tm * ntn;
    int ms[TM], ns[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) ms[i] = min(tm + i * ntm, M - 1);
#pragma unroll
    for (int j = 0; j < TN; ++j) ns[j] = min(tn + j * ntn, N - 1);
    float acc[TM][TN] = {};
    body(ms, ns, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int m = tm + i * ntm, n = tn + j * ntn;
        if (m < M && n < N) epi(m, n, acc[i][j]);
      }
  }
}

// acc[i][j] += Σ_{k < K} a(ms[i], k)·b(ns[j], k), k in order.
template <int TM, int TN, typename A, typename Bf>
__device__ __forceinline__ void accumulate(float (&acc)[TM][TN], const int (&ms)[TM],
                                           const int (&ns)[TN], int K, A a, Bf b) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a(ms[i], k);
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b(ns[j], k);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// 4 bytes global -> shared without a register round trip (rows of odd
// stride are not 16-byte aligned); many stay in flight a thread.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `rows` rows of D floats, src_ld apart in global memory, into dst [rows][LD]
// by cp.async (the caller waits).
__device__ __forceinline__ void copy_rows_async(float* dst, const float* __restrict__ src,
                                                int rows, int D, int LD, int src_ld) {
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    cp_async4(dst + r * LD + d, src + (size_t)r * src_ld + d);
  }
}

// The operands of S, shared by K2, K7 and K8, once the caller's copies of cd
// (into cw) and of qd's tile (into tile) are in flight: waits for every
// copy, then s0 = cd·w_c, s1 = qd_J·w_q (a warp a row) and cw = cd∘w_cq.
// Ends with the block synchronised.
__device__ __forceinline__ void s_operands(float* smem, const Layout& L, int Tc, int nj, int D,
                                           const float* __restrict__ w_c,
                                           const float* __restrict__ w_q,
                                           const float* __restrict__ w_cq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int LD = L.LD;
  float *cw = smem + L.cw, *s0 = smem + L.s0, *s1 = smem + L.s1;
  const float* tile = smem + L.tile;
  cp_async_wait_all();
  __syncthreads();
  for (int r = warp; r < Tc + nj; r += nwarps) {
    const float* row = r < Tc ? cw + r * LD : tile + (r - Tc) * LD;
    const float* w = r < Tc ? w_c : w_q;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s = fmaf(row[d], w[d], s);
    s = warp_sum(s);
    if (lane == 0) (r < Tc ? s0[r] : s1[r - Tc]) = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < Tc * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D;
    cw[i * LD + d] *= w_cq[d];
  }
  __syncthreads();
}

// The tile's part of the forward, shared by K2, K7 and K8 (s_operands done):
//   S_J = s0·1ᵀ + 1·s1ᵀ + cw·qd_Jᵀ + bias into ss;
//   s_col_J (exact, a warp a column) into sc;
//   the masked row maxima m, p = exp(v − m) into sr and l = Σ p (a warp a
//   row).
// Ends with the block synchronised.
__device__ __forceinline__ void tile_softmaxes(float* smem, const Layout& L, int Tc, int nj, int D,
                                               const float* __restrict__ cm,
                                               const float* __restrict__ qm, float bias) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const float *tile = smem + L.tile, *cw = smem + L.cw;
  const float *s0 = smem + L.s0, *s1 = smem + L.s1;
  float *sr = smem + L.sr, *sc = smem + L.sc, *ss = smem + L.ss;
  const int LD = L.LD, LQ = L.LQ;
  block_tiles<2, 2>(
      Tc, nj,
      [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
        accumulate(acc, ms, ns, D, [&](int i, int d) { return cw[i * LD + d]; },
                   [&](int j, int d) { return tile[j * LD + d]; });
      },
      [&](int i, int j, float v) { ss[i * LQ + j] = s0[i] + s1[j] + v + bias; });
  __syncthreads();
  for (int j = warp; j < nj; j += nwarps) {
    float mx = -INFINITY;
    for (int i = lane; i < Tc; i += 32) {
      const float mk = cm[i];
      const float v = mk * ss[i * LQ + j] + (1.0f - mk) * kNegInf;
      sc[i * LQ + j] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int i = lane; i < Tc; i += 32) {
      const float e = expf(sc[i * LQ + j] - mx);
      sc[i * LQ + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int i = lane; i < Tc; i += 32) sc[i * LQ + j] = sc[i * LQ + j] / sum;
  }
  float *mrow = smem + L.m, *lrow = smem + L.l;
  for (int i = warp; i < Tc; i += nwarps) {
    float mx = -INFINITY;
    for (int j = lane; j < nj; j += 32) {
      const float mk = qm[j];
      const float v = mk * ss[i * LQ + j] + (1.0f - mk) * kNegInf;
      sr[i * LQ + j] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < nj; j += 32) {
      const float e = expf(sr[i * LQ + j] - mx);
      sr[i * LQ + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      mrow[i] = mx;
      lrow[i] = sum;
    }
  }
  __syncthreads();
}

// After the tile's partials are in place and the cluster has synchronised:
// every rank's row maxima and sums copied in (a thread a value), the
// weights w_J of every tile into wts [C][Tc], then the combined
// P = Σ_J w_J·P_J in rank order into pf. Ends with the block synchronised.
// Lay is Layout, or K9's walk layout (csrc/bidaf_tiled.cu), with the same
// sections m, l, pp, wts, lw, pf and stride LT. With stat_m / stat_l, each
// row's combined maximum M and sum Σ_J exp(m_J − M)·l_J are written there
// too (K7's tiled route keeps them for its backward).
template <typename Lay>
__device__ __forceinline__ void combine_rows(float* smem, const Lay& L, int Tc, int C,
                                             cg::cluster_group& cluster,
                                             float* stat_m = nullptr, float* stat_l = nullptr) {
  float *wts = smem + L.wts, *lw = smem + L.lw;
  for (int e = threadIdx.x; e < C * Tc; e += blockDim.x) {
    const int J = e / Tc, i = e - J * Tc;
    wts[e] = cluster.map_shared_rank(smem + L.m, J)[i];
    lw[e] = cluster.map_shared_rank(smem + L.l, J)[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Tc; i += blockDim.x) {
    float M = -INFINITY;
    for (int J = 0; J < C; ++J) M = fmaxf(M, wts[J * Tc + i]);
    float tot = 0.0f;
    for (int J = 0; J < C; ++J) {
      const float s = expf(wts[J * Tc + i] - M);
      wts[J * Tc + i] = s;
      tot = fmaf(s, lw[J * Tc + i], tot);
    }
    for (int J = 0; J < C; ++J) wts[J * Tc + i] = wts[J * Tc + i] / tot;
    if (stat_m) stat_m[i] = M, stat_l[i] = tot;
  }
  __syncthreads();
  const int LT = L.LT;
  float* pf = smem + L.pf;
  for (int e = threadIdx.x; e < Tc * Tc; e += blockDim.x) {
    const int i = e / Tc, k = e - i * Tc;
    float v = 0.0f;
#pragma unroll 4
    for (int J = 0; J < C; ++J)
      v = fmaf(wts[J * Tc + i], cluster.map_shared_rank(smem + L.pp, J)[i * LT + k], v);
    pf[i * LT + k] = v;
  }
  __syncthreads();
}

// The parameter grads of K8's routes: out = Σ_b partial[b] ([B, n]), in
// batch order.
template <typename T>
__global__ void sum_over_batch_kernel(const T* __restrict__ partial, T* __restrict__ out, int B,
                                      int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  T acc = 0;
  for (int b = 0; b < B; ++b) acc += partial[(size_t)b * n + e];
  out[e] = acc;
}

}  // namespace bidafc
}  // namespace mmb
