// K8's tiled route — the BiDAF backward with dropped similarity operands for
// the shapes K8's cluster plan refuses (T_c >= 48 at D=256, T_q past 1088
// at T_c=32: the capability configs' 64-sentence blocks, long audio).
//
// Replaces: mmbidaf_tpu/ops/pallas/bidaf_kernel.py::_bidaf_drop_bwd_kernel
// (entry _drop_bwd, the custom VJP of bidaf_attention_fused_dropout), as
// K8 (csrc/bidaf_bwd.cu) does, with K8's contract and formulas (E = d_b·cᵀ
// and P = s_row·s_colᵀ are [T_c, T_c]):
//   d_a = g1 + g2∘c,  d_b = g3∘c
//   d_c  = g0 + g2∘a + g3∘b + Pᵀ·d_b,   a = s_row·q,  b = P·c
//   d_q  = s_rowᵀ·d_a
//   d_s_row = E·s_col + d_a·qᵀ,   d_s_col = Eᵀ·s_row
//   dS = qm∘s_row∘(d_s_row − rs) + cm∘s_col∘(d_s_col − colsum(d_s_col∘s_col)),
//   rs = rowsum(d_s_row∘s_row)
//   d_cd = rowsum(dS)∘w_c + (dS·qd)∘w_cq,   d_qd = colsum(dS)∘w_q + dSᵀ·(cd∘w_cq)
//   dw_c, dw_q, dw_cq, dbias summed over the batch.
// s_row is rebuilt as p / L, p = exp(v − M) with the row maximum M that
// K7's tiled route saved, and L = Σ_j p summed here over this kernel's own
// p: then each row of s_row sums to one in the rounding of the rs it is
// held against, and rowsum(dS) cancels as the plain version's does. (With
// the forward's L, dbias drifted 8.6e-4 from the plain version at T_c=64,
// T_q=64, D=256, B=32, drop 0.2 on an H100, past K8's bound; the cluster
// route's own p and weights never had that gap.)
//
// Why a second route: K8's cluster block holds every [T_c, D] operand and
// accumulator of an example in shared memory (cd∘w_cq, c then d_a, g2 then
// the partials, c's and d_b's columns: at T_c=64, D=256 three of them are
// 197 KB alone), so no cluster of any size fits past T_c=40 at D=256.
// Design: the [T_c, D] arrays go to device memory, where every tile reads
// them through L1/L2, and only [T_c, tq] tiles live in shared memory (tq <=
// 32: 154 KB a block at T_c=128, D=256). Spilling was chosen over splitting
// the D columns across a cluster (Layout::cs) because a split needs an
// exchange of the [T_c, tq] partial products of S and d_s_row at every
// tile, and the spill keeps every block independent: no cluster, no
// occupancy limit from clusters, any T_c whose tile fits. Each example's
// q tiles are dealt to C <= 8 independent blocks (grid (C, B)) in runs of
// `per` consecutive tiles; a block accumulates into its own slice of the
// workspace, so no two blocks write one float and there are no atomics.
// Five launches a call, in stream order:
//   1. prep (grid (ceil(T_c/8), B)): cw = cd∘w_cq, d_a, d_b, s0 = cd·w_c into
//      the workspace, and E = d_b·cᵀ (a warp an entry, its loads coalesced).
//   2. pass 1 (grid (C, B)), per tile J: S_J (from cd, qd_J), p_J = exp(v −
//      M), s_col_J (exact: a tile holds all T_c rows), d_s_row_J =
//      E·s_col_J + d_a·q_Jᵀ; the block's row sums of p and of p∘d_s_row,
//      and its partials a_r += p_J·q_J, P_r += p_J·s_col_Jᵀ.
//   3. pass 2 (grid (C, B)): L = Σ_r l_r and rs = Σ_r (p∘d_s_row)_r / L in
//      rank order; per tile J again S_J, s_row_J = p_J / L, s_col_J,
//      d_s_row_J, then d_s_col_J = Eᵀ·s_row_J, dS_J, d_q_J and d_qd_J out,
//      and the partials (dS·qd)_r, rowsum(dS)_r, Σ_j qd_j·colsum(dS)_j and
//      Σ dS.
//   4. finish (grid (ceil(T_c/8), B)): for 8 rows of c each, the C
//      partials summed in rank order, a and P divided by L, b = P·c, d_c,
//      d_cd, and the rows' dw_c, dw_cq (and on the first, dw_q and dbias)
//      into a row of [B·ceil(T_c/8), 3D+1] partials.
//   5. the sum of those rows, in order (K8's batch-sum kernel).
// Every sum runs in a fixed order: two runs give the same bits.
// What bounds it on the H100: the f32 operations (~10 T_c·T_q·D a call,
// 0.34 GFLOP an example at T_c=64, T_q=512, D=256), at the CUDA cores'
// 67 TFLOP/s. This first design forms every product as 2x2 register tiles
// from scalar loads (the cluster route's products), reads the [T_c, D]
// operands from device memory through the caches and recomputes S, s_row,
// s_col and d_s_row in pass 2: simple first, not near that bound.
#include "bidaf_cluster.cuh"
#include "common.cuh"

#include <math.h>

namespace {

namespace bc = mmb::bidafc;

constexpr int kThreads = 256;
constexpr int kMaxTile = 32;   // q columns a tile, at most
constexpr int kMaxRanks = 8;   // blocks an example, at most
constexpr int kPrepRows = 8;   // rows of c a prep block
constexpr int kFinishRows = 8; // rows of c a finish block

// Shared memory of a pass block, in floats (sections rounded up to four).
struct BwdLayout {
  int LD, LQ;  // odd row strides of [*, D] and [*, tq] arrays
  size_t qt, qdt, sr, sc, dsr, dsc, ss, s0, s1, mr, lr, rs, cm, qm, ds0, ds1, csum, wq, sb;
  size_t floats;

  __host__ __device__ BwdLayout(int Tc, int tq, int D) {
    LD = D | 1, LQ = tq | 1;
    size_t o = 0;
    qt = bc::take(o, (size_t)tq * LD);   // [tq][LD] q's tile
    qdt = bc::take(o, (size_t)tq * LD);  // [tq][LD] qd's tile
    sr = bc::take(o, (size_t)Tc * LQ);   // [Tc][LQ] s_row
    sc = bc::take(o, (size_t)Tc * LQ);   // [Tc][LQ] s_col
    dsr = bc::take(o, (size_t)Tc * LQ);  // [Tc][LQ] d_s_row
    dsc = bc::take(o, (size_t)Tc * LQ);  // [Tc][LQ] d_s_col (pass 2)
    ss = bc::take(o, (size_t)Tc * LQ);   // [Tc][LQ] S, then dS
    s0 = bc::take(o, Tc);                // cd·w_c
    s1 = bc::take(o, tq);                // qd_j·w_q
    mr = bc::take(o, Tc);                // the forward's row maxima M
    lr = bc::take(o, Tc);                // pass 1: this block's Σ p; pass 2: L
    rs = bc::take(o, Tc);                // pass 1: this block's Σ p∘d_s_row; pass 2: rs
    cm = bc::take(o, Tc);                // c's mask
    qm = bc::take(o, tq);                // the tile's q mask
    ds0 = bc::take(o, Tc);               // rowsum(dS) over this block's tiles
    ds1 = bc::take(o, tq);               // colsum(dS) of the tile
    csum = bc::take(o, tq);              // colsum(d_s_col∘s_col) of the tile
    wq = bc::take(o, D);                 // Σ_j qd_j·colsum(dS)_j over this block's tiles
    sb = bc::take(o, 1);                 // Σ dS over this block's tiles
    floats = o;
  }
};

// The workspace of one example in device memory, in floats.
struct BwdWork {
  size_t cw, da, db, s0, e, l, pd, a, p, dsq, ds0, wq, bs, floats;

  __host__ __device__ BwdWork(int Tc, int D, int C) {
    size_t o = 0;
    const size_t TD = (size_t)Tc * D, TT = (size_t)Tc * Tc;
    cw = bc::take(o, TD);           // [Tc][D] cd∘w_cq
    da = bc::take(o, TD);           // [Tc][D] d_a = g1 + g2∘c
    db = bc::take(o, TD);           // [Tc][D] d_b = g3∘c
    s0 = bc::take(o, Tc);           // cd·w_c
    e = bc::take(o, TT);            // [Tc][Tc] E = d_b·cᵀ
    l = bc::take(o, (size_t)C * Tc);    // [C][Tc] each block's Σ_j p
    pd = bc::take(o, (size_t)C * Tc);   // [C][Tc] each block's Σ_j p∘d_s_row
    a = bc::take(o, C * TD);        // [C][Tc][D] each block's Σ p_J·q_J
    p = bc::take(o, C * TT);        // [C][Tc][Tc] each block's Σ p_J·s_col_Jᵀ
    dsq = bc::take(o, C * TD);      // [C][Tc][D] each block's Σ dS_J·qd_J
    ds0 = bc::take(o, (size_t)C * Tc);  // [C][Tc] each block's rowsum(dS)
    wq = bc::take(o, (size_t)C * D);    // [C][D] each block's Σ_j qd_j·colsum(dS)_j
    bs = bc::take(o, C);            // [C] each block's Σ dS
    floats = o;
  }
};

// The finish block's shared memory in floats: its rows of P and of Pᵀ
// ([kFinishRows][Tc] each), their rowsum(dS), and L of every row.
__host__ __device__ inline size_t finish_floats(int Tc) {
  return 2 * bc::round4((size_t)kFinishRows * Tc) + bc::round4(kFinishRows) + bc::round4(Tc);
}

struct BwdPlan {
  int C;     // blocks an example
  int per;   // q tiles a block (the last block's may be fewer)
  int tq;    // q columns a tile (the last tile's may be fewer)
  int smem;  // dynamic shared memory of a pass block, bytes
  int smem_finish;  // of the finish block, bytes
  int finish_blocks;  // finish blocks an example (rows of partial parameter grads)
  long long work;   // floats of device memory an example
};

// The plan for one example of T_c x T_q at width D: the widest tile (32,
// 16, …, 1 columns) whose pass block fits, ceil(T_q / tq) tiles dealt to C
// = min(tiles, 8) blocks in runs of per = ceil(tiles / C) (then C =
// ceil(tiles / per), so none is idle); false if no tile fits or the
// finish block does not. ops/cuda/bidaf_kernel.py::tiled_bwd_plan mirrors
// it.
inline bool bwd_plan(int Tc, int Tq, int D, BwdPlan* p) {
  if (Tc <= 0 || Tq <= 0 || D <= 0) return false;
  if (4 * finish_floats(Tc) > (size_t)mmb::kMaxSmemBytes) return false;
  for (int tq = Tq < kMaxTile ? Tq : kMaxTile; tq >= 1; tq /= 2) {
    const BwdLayout L(Tc, tq, D);
    if (4 * L.floats > (size_t)mmb::kMaxSmemBytes) continue;
    const int nt = (Tq + tq - 1) / tq;
    int C = nt < kMaxRanks ? nt : kMaxRanks;
    const int per = (nt + C - 1) / C;
    C = (nt + per - 1) / per;
    *p = {C, per, tq, (int)(4 * L.floats), (int)(4 * finish_floats(Tc)),
          (Tc + kFinishRows - 1) / kFinishRows, (long long)BwdWork(Tc, D, C).floats};
    return true;
  }
  return false;
}

// 1. cw = cd∘w_cq, d_a = g1 + g2∘c, d_b = g3∘c and s0 = cd·w_c (a warp a
// row) for this block's rows, and their rows of E = d_b·cᵀ (a warp an
// entry: lanes over d, then the warp's sum).
__global__ void __launch_bounds__(kThreads) bidaf_tiled_bwd_prep_kernel(
    const float* __restrict__ c, const float* __restrict__ cd, const float* __restrict__ w_c,
    const float* __restrict__ w_cq, const float* __restrict__ g, float* __restrict__ work,
    int Tc, int D, int C) {
  const BwdWork W(Tc, D, C);
  const int b = blockIdx.y, i0 = blockIdx.x * kPrepRows;
  const int nr = min(kPrepRows, Tc - i0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const float* cb = c + (size_t)b * Tc * D;
  const float* cdb = cd + (size_t)b * Tc * D;
  const float* gb = g + (size_t)b * Tc * 4 * D;
  float* wb = work + (size_t)b * W.floats;
  for (int e = tid; e < nr * D; e += blockDim.x) {
    const int i = i0 + e / D, d = e % D;
    const float* gi = gb + (size_t)i * 4 * D;
    wb[W.cw + (size_t)i * D + d] = cdb[(size_t)i * D + d] * w_cq[d];
    wb[W.da + (size_t)i * D + d] = fmaf(gi[2 * D + d], cb[(size_t)i * D + d], gi[D + d]);
    wb[W.db + (size_t)i * D + d] = gi[3 * D + d] * cb[(size_t)i * D + d];
  }
  for (int ii = warp; ii < nr; ii += nwarps) {
    const int i = i0 + ii;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s = fmaf(cdb[(size_t)i * D + d], w_c[d], s);
    s = mmb::warp_sum(s);
    if (lane == 0) wb[W.s0 + i] = s;
  }
  for (int e = warp; e < nr * Tc; e += nwarps) {
    const int i = i0 + e / Tc, k = e % Tc;
    const float* gi = gb + (size_t)i * 4 * D + 3 * D;
    const float* ci = cb + (size_t)i * D;
    const float* ck = cb + (size_t)k * D;
    float v = 0.0f;
    for (int d = lane; d < D; d += 32) v = fmaf(gi[d] * ci[d], ck[d], v);
    v = mmb::warp_sum(v);
    if (lane == 0) wb[W.e + (size_t)i * Tc + k] = v;
  }
}

// 2. and 3.: the two walks over this block's q tiles.
template <bool kPass2>
__global__ void __launch_bounds__(kThreads) bidaf_tiled_bwd_pass_kernel(
    const float* __restrict__ q, const float* __restrict__ qd,            // [B,Tq,D]
    const float* __restrict__ c_mask, const float* __restrict__ q_mask,   // [B,Tc], [B,Tq]
    const float* __restrict__ w_q, const float* __restrict__ bias,       // [D], [1]
    const float* __restrict__ stats,                                      // [B,2,Tc]
    float* __restrict__ d_q, float* __restrict__ d_qd,                    // [B,Tq,D]
    float* __restrict__ work, int Tc, int Tq, int D, int tq, int per) {
  extern __shared__ __align__(16) float smem[];
  const int C = gridDim.x, r = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const BwdLayout L(Tc, tq, D);
  const BwdWork W(Tc, D, C);
  const int LD = L.LD, LQ = L.LQ;
  const int nt = (Tq + tq - 1) / tq, t0 = r * per, t1 = min(t0 + per, nt);
  float* wb = work + (size_t)b * W.floats;
  const float* cw = wb + W.cw;
  const float* da = wb + W.da;
  const float* E = wb + W.e;
  float *qt = smem + L.qt, *qdt = smem + L.qdt, *sr = smem + L.sr, *sc = smem + L.sc;
  float *dsr = smem + L.dsr, *dsc = smem + L.dsc, *ss = smem + L.ss;
  float *s0 = smem + L.s0, *s1 = smem + L.s1, *mr = smem + L.mr, *lr = smem + L.lr;
  float *rs = smem + L.rs, *cm = smem + L.cm, *qm = smem + L.qm, *ds0 = smem + L.ds0;
  float *ds1 = smem + L.ds1, *csum = smem + L.csum, *wq = smem + L.wq, *sb = smem + L.sb;
  const float bias_v = *bias;
  // this block's accumulators in the workspace
  float* acc_a = wb + W.a + (size_t)r * Tc * D;     // pass 1
  float* acc_p = wb + W.p + (size_t)r * Tc * Tc;    // pass 1
  float* acc_dsq = wb + W.dsq + (size_t)r * Tc * D;  // pass 2

  for (int i = tid; i < Tc; i += blockDim.x) {
    s0[i] = wb[W.s0 + i];
    mr[i] = stats[(size_t)b * 2 * Tc + i];
    cm[i] = c_mask[(size_t)b * Tc + i];
    ds0[i] = 0.0f;
    float l = 0.0f, pd = 0.0f;
    if (kPass2) {
      for (int J = 0; J < C; ++J) {  // rank order
        l += wb[W.l + (size_t)J * Tc + i];
        pd += wb[W.pd + (size_t)J * Tc + i];
      }
      pd = pd / l;
    }
    lr[i] = l;
    rs[i] = pd;
  }
  for (int d = tid; d < D; d += blockDim.x) wq[d] = 0.0f;
  if (tid == 0) sb[0] = 0.0f;
  if (!kPass2) {
    for (size_t e = tid; e < (size_t)Tc * D; e += blockDim.x) acc_a[e] = 0.0f;
    for (size_t e = tid; e < (size_t)Tc * Tc; e += blockDim.x) acc_p[e] = 0.0f;
  } else {
    for (size_t e = tid; e < (size_t)Tc * D; e += blockDim.x) acc_dsq[e] = 0.0f;
  }
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const int j0 = t * tq, nj = min(tq, Tq - j0);
    const float* qb = q + ((size_t)b * Tq + j0) * D;
    const float* qdb = qd + ((size_t)b * Tq + j0) * D;
    for (int e = tid; e < nj * D; e += blockDim.x) {
      const int j = e / D, d = e - j * D;
      qt[j * LD + d] = qb[(size_t)j * D + d];
      qdt[j * LD + d] = qdb[(size_t)j * D + d];
    }
    for (int j = tid; j < nj; j += blockDim.x) qm[j] = q_mask[(size_t)b * Tq + j0 + j];
    __syncthreads();
    for (int j = warp; j < nj; j += nwarps) {  // s1 = qd_j·w_q, a warp a column
      float s = 0.0f;
      for (int d = lane; d < D; d += 32) s = fmaf(qdt[j * LD + d], w_q[d], s);
      s = mmb::warp_sum(s);
      if (lane == 0) s1[j] = s;
    }
    __syncthreads();
    // S_J = s0 + s1 + (cd∘w_cq)·qd_Jᵀ + bias
    bc::block_tiles<2, 2>(
        Tc, nj,
        [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
          bc::accumulate(acc, ms, ns, D, [&](int i, int d) { return cw[(size_t)i * D + d]; },
                         [&](int j, int d) { return qdt[j * LD + d]; });
        },
        [&](int i, int j, float v) { ss[i * LQ + j] = s0[i] + s1[j] + v + bias_v; });
    __syncthreads();
    // p = exp(v − M) (pass 1), s_row = p / L (pass 2); s_col exact over T_c
    // (a warp a column)
    for (int e = tid; e < Tc * nj; e += blockDim.x) {
      const int i = e / nj, j = e - i * nj;
      const float mk = qm[j];
      const float p = expf(mk * ss[i * LQ + j] + (1.0f - mk) * mmb::kNegInf - mr[i]);
      sr[i * LQ + j] = kPass2 ? p / lr[i] : p;
    }
    for (int j = warp; j < nj; j += nwarps) {
      float mx = -INFINITY;
      for (int i = lane; i < Tc; i += 32) {
        const float mk = cm[i];
        const float v = mk * ss[i * LQ + j] + (1.0f - mk) * mmb::kNegInf;
        sc[i * LQ + j] = v;
        mx = fmaxf(mx, v);
      }
      mx = mmb::warp_max(mx);
      float sum = 0.0f;
      for (int i = lane; i < Tc; i += 32) {
        const float e = expf(sc[i * LQ + j] - mx);
        sc[i * LQ + j] = e;
        sum += e;
      }
      sum = mmb::warp_sum(sum);
      for (int i = lane; i < Tc; i += 32) sc[i * LQ + j] = sc[i * LQ + j] / sum;
    }
    __syncthreads();
    // d_s_row_J = E·s_col_J + d_a·q_Jᵀ
    bc::block_tiles<2, 2>(
        Tc, nj,
        [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
          bc::accumulate(acc, ms, ns, Tc, [&](int i, int k) { return E[(size_t)i * Tc + k]; },
                         [&](int j, int k) { return sc[k * LQ + j]; });
          bc::accumulate(acc, ms, ns, D, [&](int i, int d) { return da[(size_t)i * D + d]; },
                         [&](int j, int d) { return qt[j * LD + d]; });
        },
        [&](int i, int j, float v) { dsr[i * LQ + j] = v; });
    __syncthreads();
    if (!kPass2) {
      for (int i = tid; i < Tc; i += blockDim.x) {  // Σ p and Σ p∘d_s_row, j in order
        float l = lr[i], v = rs[i];
        for (int j = 0; j < nj; ++j) {
          l += sr[i * LQ + j];
          v = fmaf(dsr[i * LQ + j], sr[i * LQ + j], v);
        }
        lr[i] = l;
        rs[i] = v;
      }
      // a_r += p_J·q_J;  P_r += p_J·s_col_Jᵀ
      bc::block_tiles<2, 2>(
          Tc, D,
          [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
            bc::accumulate(acc, ms, ns, nj, [&](int i, int j) { return sr[i * LQ + j]; },
                           [&](int d, int j) { return qt[j * LD + d]; });
          },
          [&](int i, int d, float v) { acc_a[(size_t)i * D + d] += v; });
      bc::block_tiles<2, 2>(
          Tc, Tc,
          [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
            bc::accumulate(acc, ms, ns, nj, [&](int i, int j) { return sr[i * LQ + j]; },
                           [&](int k, int j) { return sc[k * LQ + j]; });
          },
          [&](int i, int k, float v) { acc_p[(size_t)i * Tc + k] += v; });
    } else {
      // d_q_J = s_row_Jᵀ·d_a
      bc::block_tiles<2, 2>(
          nj, D,
          [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
            bc::accumulate(acc, ms, ns, Tc, [&](int j, int i) { return sr[i * LQ + j]; },
                           [&](int d, int i) { return da[(size_t)i * D + d]; });
          },
          [&](int j, int d, float v) { d_q[((size_t)b * Tq + j0 + j) * D + d] = v; });
      // d_s_col_J = Eᵀ·s_row_J, then its column sums with s_col
      bc::block_tiles<2, 2>(
          Tc, nj,
          [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
            bc::accumulate(acc, ms, ns, Tc, [&](int i, int k) { return E[(size_t)k * Tc + i]; },
                           [&](int j, int k) { return sr[k * LQ + j]; });
          },
          [&](int i, int j, float v) { dsc[i * LQ + j] = v; });
      __syncthreads();
      for (int j = tid; j < nj; j += blockDim.x) {
        float v = 0.0f;
        for (int i = 0; i < Tc; ++i) v = fmaf(dsc[i * LQ + j], sc[i * LQ + j], v);
        csum[j] = v;
      }
      __syncthreads();
      for (int e = tid; e < Tc * nj; e += blockDim.x) {
        const int i = e / nj, j = e - i * nj;
        const float a = qm[j] * (sr[i * LQ + j] * (dsr[i * LQ + j] - rs[i]));
        ss[i * LQ + j] = a + cm[i] * (sc[i * LQ + j] * (dsc[i * LQ + j] - csum[j]));
      }
      __syncthreads();
      for (int j = tid; j < nj; j += blockDim.x) {  // colsum(dS), i in order
        float v = 0.0f;
        for (int i = 0; i < Tc; ++i) v += ss[i * LQ + j];
        ds1[j] = v;
      }
      for (int i = tid; i < Tc; i += blockDim.x) {  // rowsum(dS), j in order
        float v = ds0[i];
        for (int j = 0; j < nj; ++j) v += ss[i * LQ + j];
        ds0[i] = v;
      }
      __syncthreads();
      if (tid == 0) {
        float v = sb[0];
        for (int j = 0; j < nj; ++j) v += ds1[j];
        sb[0] = v;
      }
      for (int d = tid; d < D; d += blockDim.x) {
        float v = wq[d];
        for (int j = 0; j < nj; ++j) v = fmaf(qdt[j * LD + d], ds1[j], v);
        wq[d] = v;
      }
      // d_qd_J = colsum(dS)∘w_q + dS_Jᵀ·(cd∘w_cq);  (dS·qd)_r += dS_J·qd_J
      bc::block_tiles<2, 2>(
          nj, D,
          [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
            bc::accumulate(acc, ms, ns, Tc, [&](int j, int i) { return ss[i * LQ + j]; },
                           [&](int d, int i) { return cw[(size_t)i * D + d]; });
          },
          [&](int j, int d, float v) {
            d_qd[((size_t)b * Tq + j0 + j) * D + d] = fmaf(ds1[j], w_q[d], v);
          });
      bc::block_tiles<2, 2>(
          Tc, D,
          [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
            bc::accumulate(acc, ms, ns, nj, [&](int i, int j) { return ss[i * LQ + j]; },
                           [&](int d, int j) { return qdt[j * LD + d]; });
          },
          [&](int i, int d, float v) { acc_dsq[(size_t)i * D + d] += v; });
    }
    __syncthreads();  // the tile's sections are free
  }

  if (!kPass2) {
    for (int i = tid; i < Tc; i += blockDim.x) {
      wb[W.l + (size_t)r * Tc + i] = lr[i];
      wb[W.pd + (size_t)r * Tc + i] = rs[i];
    }
  } else {
    for (int i = tid; i < Tc; i += blockDim.x) wb[W.ds0 + (size_t)r * Tc + i] = ds0[i];
    for (int d = tid; d < D; d += blockDim.x) wb[W.wq + (size_t)r * D + d] = wq[d];
    if (tid == 0) wb[W.bs + r] = sb[0];
  }
}

// 4. For this block's rows: the blocks' partials summed in rank order (a
// and P over L), b = P·c, d_c, d_cd and the rows' share of the parameter
// grads.
__global__ void __launch_bounds__(kThreads) bidaf_tiled_bwd_finish_kernel(
    const float* __restrict__ c, const float* __restrict__ cd, const float* __restrict__ w_c,
    const float* __restrict__ w_cq, const float* __restrict__ g, const float* __restrict__ work,
    float* __restrict__ d_c, float* __restrict__ d_cd,
    float* __restrict__ partial,  // [B·gridDim.x, 3D+1]: dw_c | dw_q | dw_cq | dbias
    int Tc, int D, int C) {
  extern __shared__ __align__(16) float smem[];
  const BwdWork W(Tc, D, C);
  const int b = blockIdx.y, tid = threadIdx.x, R = kFinishRows;
  const int i0 = blockIdx.x * R, nr = min(R, Tc - i0);
  const float* wb = work + (size_t)b * W.floats;
  const float* cb = c + (size_t)b * Tc * D;
  const float* cdb = cd + (size_t)b * Tc * D;
  const float* gb = g + (size_t)b * Tc * 4 * D;
  float* Pr = smem;                                    // [R][Tc] P's rows i0 …
  float* Pc = Pr + bc::round4((size_t)R * Tc);         // [R][Tc] P's columns i0 …: Pc[ii][k] = P[k][i]
  float* ds0 = Pc + bc::round4((size_t)R * Tc);        // [R]
  float* L = ds0 + bc::round4(R);                      // [Tc]
  for (int k = tid; k < Tc; k += blockDim.x) {
    float l = 0.0f;
    for (int J = 0; J < C; ++J) l += wb[W.l + (size_t)J * Tc + k];
    L[k] = l;
  }
  for (int ii = tid; ii < nr; ii += blockDim.x) {
    float v = 0.0f;
    for (int J = 0; J < C; ++J) v += wb[W.ds0 + (size_t)J * Tc + i0 + ii];
    ds0[ii] = v;
  }
  __syncthreads();
  const auto p_sum = [&](int i, int k) {
    float v = 0.0f;
    for (int J = 0; J < C; ++J) v += wb[W.p + ((size_t)J * Tc + i) * Tc + k];
    return v / L[i];
  };
  for (int e = tid; e < nr * Tc; e += blockDim.x) {
    const int ii = e / Tc, k = e - ii * Tc;
    Pr[ii * Tc + k] = p_sum(i0 + ii, k);
    Pc[ii * Tc + k] = p_sum(k, i0 + ii);
  }
  __syncthreads();
  const auto sum_ranks = [&](size_t at, size_t e) {
    float v = 0.0f;
    for (int J = 0; J < C; ++J) v += wb[at + (size_t)J * Tc * D + e];
    return v;
  };
  for (int e = tid; e < nr * D; e += blockDim.x) {
    const int ii = e / D, d = e - ii * D, i = i0 + ii;
    const size_t at = (size_t)i * D + d;
    const float* gi = gb + (size_t)i * 4 * D;
    const float a = sum_ranks(W.a, at) / L[i], dsq = sum_ranks(W.dsq, at);
    float bv = 0.0f, q2c = 0.0f;
    for (int k = 0; k < Tc; ++k) {
      bv = fmaf(Pr[ii * Tc + k], cb[(size_t)k * D + d], bv);
      q2c = fmaf(Pc[ii * Tc + k], wb[W.db + (size_t)k * D + d], q2c);
    }
    d_c[(size_t)b * Tc * D + at] = gi[d] + gi[2 * D + d] * a + gi[3 * D + d] * bv + q2c;
    d_cd[(size_t)b * Tc * D + at] = fmaf(ds0[ii], w_c[d], dsq * w_cq[d]);
  }
  float* pb = partial + ((size_t)b * gridDim.x + blockIdx.x) * (3 * D + 1);
  for (int d = tid; d < D; d += blockDim.x) {
    float dwc = 0.0f, dwcq = 0.0f, dwq = 0.0f;
    for (int ii = 0; ii < nr; ++ii) {
      const size_t at = (size_t)(i0 + ii) * D + d;
      dwc = fmaf(cdb[at], ds0[ii], dwc);
      dwcq = fmaf(sum_ranks(W.dsq, at), cdb[at], dwcq);
    }
    if (blockIdx.x == 0)
      for (int J = 0; J < C; ++J) dwq += wb[W.wq + (size_t)J * D + d];
    pb[d] = dwc, pb[D + d] = dwq, pb[2 * D + d] = dwcq;
  }
  if (tid == 0) {
    float v = 0.0f;
    if (blockIdx.x == 0)
      for (int J = 0; J < C; ++J) v += wb[W.bs + J];
    pb[3 * D] = v;
  }
}

}  // namespace

// K8's tiled route: five launches on `stream`. stats: K7's tiled route's
// [B][2][T_c] row statistics; work: B·plan.work floats; partial:
// [B·plan.finish_blocks, 3D+1].
MMB_API int mmb_bidaf_tiled_backward(const void* c, const void* q, const void* cd, const void* qd,
                                     const void* c_mask, const void* q_mask, const void* w_c,
                                     const void* w_q, const void* w_cq, const void* bias,
                                     const void* g, const void* stats, void* d_c, void* d_q,
                                     void* d_cd, void* d_qd, void* work, void* partial,
                                     void* d_params, int B, int Tc, int Tq, int D, void* stream) {
  BwdPlan p;
  if (B <= 0 || B > 65535 || !stats || !work || !bwd_plan(Tc, Tq, D, &p))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  const auto o = [](void* v) { return static_cast<float*>(v); };
  bidaf_tiled_bwd_prep_kernel<<<dim3((Tc + kPrepRows - 1) / kPrepRows, B), kThreads, 0, s>>>(
      f(c), f(cd), f(w_c), f(w_cq), f(g), o(work), Tc, D, p.C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaFuncSetAttribute(bidaf_tiled_bwd_pass_kernel<false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bidaf_tiled_bwd_pass_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bidaf_tiled_bwd_finish_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_finish)) !=
          cudaSuccess)
    return (int)e;
  bidaf_tiled_bwd_pass_kernel<false><<<dim3(p.C, B), kThreads, p.smem, s>>>(
      f(q), f(qd), f(c_mask), f(q_mask), f(w_q), f(bias), f(stats), o(d_q), o(d_qd), o(work), Tc,
      Tq, D, p.tq, p.per);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bidaf_tiled_bwd_pass_kernel<true><<<dim3(p.C, B), kThreads, p.smem, s>>>(
      f(q), f(qd), f(c_mask), f(q_mask), f(w_q), f(bias), f(stats), o(d_q), o(d_qd), o(work), Tc,
      Tq, D, p.tq, p.per);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bidaf_tiled_bwd_finish_kernel<<<dim3(p.finish_blocks, B), kThreads, p.smem_finish, s>>>(
      f(c), f(cd), f(w_c), f(w_cq), f(g), f(work), o(d_c), o(d_cd), o(partial), Tc, D, p.C);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int n = 3 * D + 1;
  bc::sum_over_batch_kernel<float><<<(n + 255) / 256, 256, 0, s>>>(f(partial), o(d_params),
                                                                   B * p.finish_blocks, n);
  return (int)cudaGetLastError();
}

// K8's tiled plan into out[6]: C, tiles a block, tq, the pass block's and
// the finish block's dynamic shared memory (bytes), finish blocks an
// example; and (out64[0]) the workspace's floats an example. 0, or
// cudaErrorInvalidValue if none.
MMB_API int mmb_bidaf_tiled_bwd_plan(int Tc, int Tq, int D, int* out, long long* out64) {
  BwdPlan p;
  if (!bwd_plan(Tc, Tq, D, &p)) return (int)cudaErrorInvalidValue;
  const int v[6] = {p.C, p.per, p.tq, p.smem, p.smem_finish, p.finish_blocks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  out64[0] = p.work;
  return 0;
}
