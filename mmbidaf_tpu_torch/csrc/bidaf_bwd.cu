// K8 — fused BiDAF backward with dropped similarity operands, each example
// split over T_q across a thread-block cluster, and the deterministic sum of
// the parameter grads.
//
// Replaces: mmbidaf_tpu/ops/pallas/bidaf_kernel.py::_bidaf_drop_bwd_kernel
// (entry _drop_bwd, the custom VJP of bidaf_attention_fused_dropout). Given
// the forward's inputs and the cotangent g = [g0; g1; g2; g3] of
// out = [c; a; c∘a; c∘b], recompute S (from cd, qd) and both softmaxes, then,
// all in f32 (E = d_b·cᵀ and P = s_row·s_colᵀ are [T_c, T_c]):
//   d_a = g1 + g2∘c,  d_b = g3∘c
//   d_c  = g0 + g2∘a + g3∘b + Pᵀ·d_b          (= … + s_col·(s_rowᵀ·d_b))
//   d_q  = s_rowᵀ·d_a
//   d_s_row = E·s_col + d_a·qᵀ,   d_s_col = Eᵀ·s_row
//   dS = qm∘s_row∘(d_s_row − rs) + cm∘s_col∘(d_s_col − colsum(d_s_col∘s_col)),
//   rs = rowsum(d_s_row∘s_row)
//   d_cd = rowsum(dS)∘w_c + (dS·qd)∘w_cq,   d_qd = colsum(dS)∘w_q + dSᵀ·(cd∘w_cq)
//   dw_c = Σ_b Σ_i cd∘rowsum(dS),  dw_q = Σ_b Σ_j qd∘colsum(dS),
//   dw_cq = Σ_b Σ_i (dS·qd)∘cd,   dbias = Σ dS
// The TPU kernel forms qc = s_colᵀ·c and d_qc = s_rowᵀ·d_b ([T_q, D]); here
// both are reassociated through E and P, so no [T_q, D] intermediate
// exists. The order of the sums differs from the reference's accordingly
// (ops/cuda/bidaf_kernel.py states the bound).
//
// What bounds it on the H100: the f32 operations (~1.8 GFLOP a call at the
// audio shape B=32, T_c=32, T_q=512, D=256: ~26 µs at the CUDA cores' 67
// TFLOP/s), once the work is spread over the card and kept out of device
// memory. The first port ran one block an example (32 of 132 SMs), with
// scalar products and s_row, s_col, dS in a global scratch.
// Design (the split, the plan and the products: csrc/bidaf_cluster.cuh):
// one cluster of C blocks an example, rank r owning the q tile J (tq <= 32
// columns up to T_q = 512: C = 16 and 512 blocks at the audio shape) and
// the D columns [r·D/C, (r+1)·D/C). Each block keeps in shared memory
// cd∘w_cq, c (then d_a), g2 (then the exchanged partials), its q/qd tile,
// its columns of c and d_b, and its [T_c, tq] S, s_row, s_col, d_s_col and
// dS, and forms every product as register micro-tiles. Every bulk copy is a
// cp.async issued ahead of the work that does not need it.
//   1. The copies; K7's first step (S_J, the exact s_col_J, the tile's row
//      max m_J and sum l_J); d_b on its columns; d_a = g1 + g2∘c.
//   2. The partials E_r = d_b·cᵀ over its D columns, P_J = p·s_col_Jᵀ and
//      a_J = p·q_J.                                          cluster barrier
//   3. Exchange 1: every rank forms the weights w_J, P and E = Σ_r E_r in
//      full, and on its D columns a, b = P·c and d_c (written out); its
//      tile's exact s_row = p·w_J; d_s_row = E·s_col + d_a·q_Jᵀ and its row
//      sums with s_row over the tile.                        cluster barrier
//   4. rs from the C row sums in rank order; on the tile dS and colsum(dS).
//      (rs also equals rowsum(d_a∘a) + rowsum(E∘P), which needs no sum over
//      T_q; but dS's row sums cancel only against the rs of the same
//      d_s_row: tools/bidaf_variants.py on an H100 measured dbias 3.7e-4
//      and 1.4e-4 from the plain version's at T_q=16 and 512 that way,
//      2.4e-5 and 7.0e-6 with the tiles' own row sums.)
//   5. d_q_J and d_qd_J straight out; rowsum(dS_J).
//   6. The partials dS_J·qd_J and Σ_j qd_j·colsum(dS)_j.     cluster barrier
//   7. Exchange 2: rowsum(dS), and on the rank's D columns dS·qd, d_cd and
//      the example's dw_c, dw_q, dw_cq (and dbias on rank 0) into a row of
//      [B, 3D+1] partials.                                  cluster barrier
// A second kernel sums the partials over b in order. No atomics: two runs
// give the same bits. Two launches a call; 512 threads a block (16 warps
// hide the copies' and the exchanges' latency; bidaf_cluster.cuh).
//
#include "bidaf_cluster.cuh"
#include "common.cuh"

#include <math.h>

namespace {

namespace bc = mmb::bidafc;

__global__ void __launch_bounds__(bc::kThreadsBwd) bidaf_drop_bwd_cluster_kernel(
    const float* __restrict__ c, const float* __restrict__ q,            // [B,Tc,D], [B,Tq,D]
    const float* __restrict__ cd, const float* __restrict__ qd,          // dropped operands
    const float* __restrict__ c_mask, const float* __restrict__ q_mask,  // [B,Tc], [B,Tq]
    const float* __restrict__ w_c, const float* __restrict__ w_q,
    const float* __restrict__ w_cq, const float* __restrict__ bias,      // [D] x3, [1]
    const float* __restrict__ g,                                         // [B,Tc,4D]
    float* __restrict__ d_c, float* __restrict__ d_q,                    // [B,Tc,D], [B,Tq,D]
    float* __restrict__ d_cd, float* __restrict__ d_qd,                  // [B,Tc,D], [B,Tq,D]
    float* __restrict__ partial,  // [B, 3D+1]: dw_c | dw_q | dw_cq | dbias
    int Tc, int Tq, int D, int tq) {
  bc::cg::cluster_group cluster = bc::cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int C = gridDim.x, r = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const bc::Layout L(Tc, tq, D, C);
  const int LD = L.LD, LQ = L.LQ, LT = L.LT, D4 = 4 * D;
  const int j0 = r * tq, nj = min(tq, Tq - j0);
  const size_t TcD = (size_t)Tc * D;
  const float* cb = c + b * TcD;
  const float* cdb = cd + b * TcD;
  const float* gb = g + b * TcD * 4;
  const float* qb = q + ((size_t)b * Tq + j0) * D;  // this tile's first q row
  const float* qdb = qd + ((size_t)b * Tq + j0) * D;
  const float* cm = c_mask + (size_t)b * Tc;
  const float* qm = q_mask + (size_t)b * Tq + j0;
  float* tile = smem + L.tile;
  float* cw = smem + L.cw;    // cd∘w_cq
  float* sr = smem + L.sr;    // p, then s_row
  float* sc = smem + L.sc;    // s_col
  float* ss = smem + L.ss;    // S, then dS
  float* pp = smem + L.pp;    // P_J
  float* pf = smem + L.pf;    // P
  float* wts = smem + L.wts;
  float* da = smem + L.da;    // c, then d_a, then this rank's columns of dS·qd
  float* x = smem + L.x;      // d_b, then a_J, then dS_J·qd_J
  float* dsc = smem + L.dsc;  // d_s_col
  float* e_s = smem + L.e;    // E = d_b·cᵀ
  float* ep = smem + L.ep;    // E_r, over this rank's D columns
  float* rsq = smem + L.rsq;
  float* rs = smem + L.rs;
  float* ds0p = smem + L.ds0p;
  float* ds0 = smem + L.ds0;
  float* ds1 = smem + L.ds1;
  float* wq_s = smem + L.wq;

  const int d0 = r * D / C, nd = (r + 1) * D / C - d0, ND = L.ND;
  float* cs = smem + L.cs;    // [Tc][ND] this rank's D columns of c
  float* dbs = cs + Tc * ND;  // [Tc][ND] ... of d_b

  // 1. By cp.async: cd (into cw), c (into da), g2 (into x), qd's tile and
  // this rank's D columns of c and g3; then s0, s1 and cd∘w_cq; d_b = g3∘c
  // on those columns and d_a = g1 + g2∘c (g1 in batches of loads); S_J,
  // s_col_J and the row statistics (K7's first step).
  bc::copy_rows_async(cw, cdb, Tc, D, LD, D);
  bc::copy_rows_async(da, cb, Tc, D, LD, D);
  bc::copy_rows_async(x, gb + 2 * D, Tc, D, LD, D4);
  bc::copy_rows_async(tile, qdb, nj, D, LD, D);
  bc::copy_rows_async(cs, cb + d0, Tc, nd, ND, D);
  bc::copy_rows_async(dbs, gb + 3 * D + d0, Tc, nd, ND, D4);
  bc::s_operands(smem, L, Tc, nj, D, w_c, w_q, w_cq);
  for (int e = tid; e < Tc * nd; e += blockDim.x) {
    const int i = e / nd, dd = e - i * nd;
    dbs[i * ND + dd] *= cs[i * ND + dd];
  }
  constexpr int kBatch = 8;
  for (int e0 = tid; e0 < Tc * D; e0 += kBatch * blockDim.x) {
    float g1v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = min(e0 + u * (int)blockDim.x, Tc * D - 1), i = e / D, d = e - i * D;
      g1v[u] = gb[(size_t)i * D4 + D + d];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * (int)blockDim.x, i = e / D, d = e - i * D;
      if (e < Tc * D) da[i * LD + d] = g1v[u] + x[i * LD + d] * da[i * LD + d];
    }
  }
  bc::tile_softmaxes(smem, L, Tc, nj, D, cm, qm, *bias);

  // 2. q's tile in qd's place, in flight during the partials E_r = d_b·cᵀ
  // over this rank's D columns and P_J = p·s_colᵀ; then a_J = p·q_J (in
  // g2's place).
  bc::copy_rows_async(tile, qb, nj, D, LD, D);
  bc::block_tiles<2, 2>(
      Tc, Tc,
      [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
        bc::accumulate(acc, ms, ns, nd, [&](int i, int dd) { return dbs[i * ND + dd]; },
                       [&](int k, int dd) { return cs[k * ND + dd]; });
      },
      [&](int i, int k, float v) { ep[i * LT + k] = v; });
  bc::block_tiles<2, 2>(
      Tc, Tc,
      [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
        bc::accumulate(acc, ms, ns, nj, [&](int i, int j) { return sr[i * LQ + j]; },
                       [&](int k, int j) { return sc[k * LQ + j]; });
      },
      [&](int i, int k, float v) { pp[i * LT + k] = v; });
  bc::cp_async_wait_all();
  __syncthreads();
  bc::block_tiles<4, 4>(
      Tc, D,
      [&](const int(&ms)[4], const int(&ns)[4], float(&acc)[4][4]) {
        bc::accumulate(acc, ms, ns, nj, [&](int i, int j) { return sr[i * LQ + j]; },
                       [&](int d, int j) { return tile[j * LD + d]; });
      },
      [&](int i, int d, float v) { x[i * LD + d] = v; });
  cluster.sync();  // exchange 1: every rank's m, l, a_J, P_J and E_r are in place

  // 3. The weights w_J, P and E = Σ_r E_r; on this rank's D columns a,
  // b = P·c and d_c = g0 + g2∘a + g3∘b + Pᵀ·d_b, written out; the tile's
  // exact s_row = p·w_J; d_s_row = E·s_col + d_a·q_Jᵀ (into ss) and its
  // row sums with s_row over the tile, a warp a row.
  bc::combine_rows(smem, L, Tc, C, cluster);
  for (int e = tid; e < Tc * Tc; e += blockDim.x) {
    const int i = e / Tc, k = e - i * Tc;
    float v = 0.0f;
#pragma unroll 4
    for (int J = 0; J < C; ++J) v += cluster.map_shared_rank(ep, J)[i * LT + k];
    e_s[i * LT + k] = v;
  }
  for (int e = tid; e < Tc * nd; e += blockDim.x) {
    const int i = e / nd, dd = e - i * nd, d = d0 + dd;
    float a = 0.0f;
#pragma unroll 4
    for (int J = 0; J < C; ++J)
      a = fmaf(wts[J * Tc + i], cluster.map_shared_rank(x, J)[i * LD + d], a);
    float bv = 0.0f, pt = 0.0f;
    for (int k = 0; k < Tc; ++k) {
      bv = fmaf(pf[i * LT + k], cs[k * ND + dd], bv);
      pt = fmaf(pf[k * LT + i], dbs[k * ND + dd], pt);
    }
    const float* gi = gb + (size_t)i * D4;
    d_c[b * TcD + (size_t)i * D + d] = gi[d] + gi[2 * D + d] * a + gi[3 * D + d] * bv + pt;
  }
  for (int e = tid; e < Tc * nj; e += blockDim.x) {
    const int i = e / nj, j = e - i * nj;
    sr[i * LQ + j] *= wts[r * Tc + i];
  }
  __syncthreads();
  bc::block_tiles<2, 2>(
      Tc, nj,
      [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
        bc::accumulate(acc, ms, ns, Tc, [&](int i, int k) { return e_s[i * LT + k]; },
                       [&](int j, int k) { return sc[k * LQ + j]; });
        bc::accumulate(acc, ms, ns, D, [&](int i, int d) { return da[i * LD + d]; },
                       [&](int j, int d) { return tile[j * LD + d]; });
      },
      [&](int i, int j, float v) { ss[i * LQ + j] = v; });
  __syncthreads();
  for (int i = warp; i < Tc; i += nwarps) {
    float v = 0.0f;
    for (int j = lane; j < nj; j += 32) v = fmaf(ss[i * LQ + j], sr[i * LQ + j], v);
    v = mmb::warp_sum(v);
    if (lane == 0) rsq[i] = v;
  }
  cluster.sync();  // the cluster is done with m, l, a_J, P_J and E_r; every tile's row sums are in place

  // 4. rs = rowsum(d_s_row∘s_row), the tiles' row sums in rank order; dS's
  // row term in place of d_s_row; d_s_col = Eᵀ·s_row; then dS and
  // colsum(dS), a warp a column.
  for (int i = tid; i < Tc; i += blockDim.x) {
    float v = 0.0f;
    for (int J = 0; J < C; ++J) v += cluster.map_shared_rank(rsq, J)[i];
    rs[i] = v;
  }
  bc::block_tiles<2, 2>(
      Tc, nj,
      [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
        bc::accumulate(acc, ms, ns, Tc, [&](int i, int k) { return e_s[k * LT + i]; },
                       [&](int j, int k) { return sr[k * LQ + j]; });
      },
      [&](int i, int j, float v) { dsc[i * LQ + j] = v; });
  __syncthreads();
  for (int e = tid; e < Tc * nj; e += blockDim.x) {
    const int i = e / nj, j = e - i * nj;
    ss[i * LQ + j] = qm[j] * (sr[i * LQ + j] * (ss[i * LQ + j] - rs[i]));
  }
  __syncthreads();
  for (int j = warp; j < nj; j += nwarps) {
    float colsum = 0.0f;
    for (int i = lane; i < Tc; i += 32) colsum = fmaf(dsc[i * LQ + j], sc[i * LQ + j], colsum);
    colsum = mmb::warp_sum(colsum);
    float col = 0.0f;
    for (int i = lane; i < Tc; i += 32) {
      const float v = ss[i * LQ + j] + cm[i] * (sc[i * LQ + j] * (dsc[i * LQ + j] - colsum));
      ss[i * LQ + j] = v;
      col += v;
    }
    col = mmb::warp_sum(col);
    if (lane == 0) ds1[j] = col;
  }
  __syncthreads();

  // 5. Out of the tile: d_q = s_rowᵀ·d_a and d_qd = colsum(dS)∘w_q +
  // dSᵀ·(cd∘w_cq); rowsum(dS_J); qd's tile again, in flight meanwhile.
  float* dqb = d_q + ((size_t)b * Tq + j0) * D;
  float* dqdb = d_qd + ((size_t)b * Tq + j0) * D;
  bc::copy_rows_async(tile, qdb, nj, D, LD, D);
  bc::block_tiles<4, 4>(
      nj, D,
      [&](const int(&ms)[4], const int(&ns)[4], float(&acc)[4][4]) {
        bc::accumulate(acc, ms, ns, Tc, [&](int j, int i) { return sr[i * LQ + j]; },
                       [&](int d, int i) { return da[i * LD + d]; });
      },
      [&](int j, int d, float v) { dqb[(size_t)j * D + d] = v; });
  bc::block_tiles<4, 4>(
      nj, D,
      [&](const int(&ms)[4], const int(&ns)[4], float(&acc)[4][4]) {
        bc::accumulate(acc, ms, ns, Tc, [&](int j, int i) { return ss[i * LQ + j]; },
                       [&](int d, int i) { return cw[i * LD + d]; });
      },
      [&](int j, int d, float v) { dqdb[(size_t)j * D + d] = ds1[j] * w_q[d] + v; });
  for (int i = warp; i < Tc; i += nwarps) {
    float s = 0.0f;
    for (int j = lane; j < nj; j += 32) s += ss[i * LQ + j];
    s = mmb::warp_sum(s);
    if (lane == 0) ds0p[i] = s;
  }
  bc::cp_async_wait_all();
  __syncthreads();

  // 6. The partials dS_J·qd_J (in x's place) and Σ_j qd_j·colsum(dS)_j.
  bc::block_tiles<4, 4>(
      Tc, D,
      [&](const int(&ms)[4], const int(&ns)[4], float(&acc)[4][4]) {
        bc::accumulate(acc, ms, ns, nj, [&](int i, int j) { return ss[i * LQ + j]; },
                       [&](int d, int j) { return tile[j * LD + d]; });
      },
      [&](int i, int d, float v) { x[i * LD + d] = v; });
  for (int d = tid; d < D; d += blockDim.x) {
    float v = 0.0f;
    for (int j = 0; j < nj; ++j) v = fmaf(tile[j * LD + d], ds1[j], v);
    wq_s[d] = v;
  }
  cluster.sync();  // exchange 2: every tile's rowsum(dS_J), dS_J·qd_J and dw_q part

  // 7. rowsum(dS) and this rank's D columns of dS·qd, summed in rank order;
  // d_cd = rowsum(dS)∘w_c + (dS·qd)∘w_cq on them; the example's dw_c, dw_q,
  // dw_cq on them and (rank 0) dbias into its row of the partials.
  for (int i = tid; i < Tc; i += blockDim.x) {
    float v = 0.0f;
    for (int J = 0; J < C; ++J) v += cluster.map_shared_rank(ds0p, J)[i];
    ds0[i] = v;
  }
  for (int e = tid; e < Tc * nd; e += blockDim.x) {
    const int i = e / nd, d = d0 + e - i * nd;
    float v = 0.0f;
#pragma unroll 4
    for (int J = 0; J < C; ++J) v += cluster.map_shared_rank(x, J)[i * LD + d];
    da[i * LD + d] = v;
  }
  __syncthreads();
  float* part = partial + (size_t)b * (3 * D + 1);
  for (int dd = tid; dd < nd; dd += blockDim.x) {
    const int d = d0 + dd;
    float pwc = 0.0f, pwcq = 0.0f, pwq = 0.0f;
#pragma unroll 4
    for (int i = 0; i < Tc; ++i) {
      const float cdv = cdb[(size_t)i * D + d], dsq = da[i * LD + d];
      d_cd[b * TcD + (size_t)i * D + d] = ds0[i] * w_c[d] + dsq * w_cq[d];
      pwcq = fmaf(dsq, cdv, pwcq);
      pwc = fmaf(cdv, ds0[i], pwc);
    }
    for (int J = 0; J < C; ++J) pwq += cluster.map_shared_rank(wq_s, J)[d];
    part[d] = pwc;
    part[D + d] = pwq;
    part[2 * D + d] = pwcq;
  }
  if (r == 0 && tid == 0) {
    float pb = 0.0f;
    for (int i = 0; i < Tc; ++i) pb += ds0[i];
    part[3 * D] = pb;
  }
  cluster.sync();  // no block leaves while the cluster still reads its shared memory
}

}  // namespace

MMB_API int mmb_bidaf_backward(const void* c, const void* q, const void* cd, const void* qd,
                               const void* c_mask, const void* q_mask, const void* w_c,
                               const void* w_q, const void* w_cq, const void* bias,
                               const void* g, void* d_c, void* d_q, void* d_cd, void* d_qd,
                               void* partial, void* d_params, int B, int Tc, int Tq, int D,
                               void* stream) {
  bc::Plan p;
  if (B <= 0 || !bc::plan(Tc, Tq, D, &p)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  const auto o = [](void* v) { return static_cast<float*>(v); };
  cudaError_t e = bc::launch(bidaf_drop_bwd_cluster_kernel, p, B, bc::kThreadsBwd, p.smem_bwd, s,
                             f(c), f(q), f(cd),
                             f(qd), f(c_mask), f(q_mask), f(w_c), f(w_q), f(w_cq), f(bias), f(g),
                             o(d_c), o(d_q), o(d_cd), o(d_qd), o(partial), Tc, Tq, D, p.tq);
  if (e != cudaSuccess) return (int)e;
  const int n = 3 * D + 1;
  bc::sum_over_batch_kernel<float><<<(n + 255) / 256, 256, 0, s>>>(f(partial), o(d_params), B, n);
  return (int)cudaGetLastError();
}

// The cluster plan of K7 and K8 for one T_c x T_q example at width D into
// out[4]: C, tq, K7's and K8's dynamic shared memory a block (bytes).
// Returns 0, or cudaErrorInvalidValue if there is none.
MMB_API int mmb_bidaf_drop_plan(int Tc, int Tq, int D, int* out) {
  bc::Plan p;
  if (!bc::plan(Tc, Tq, D, &p)) return (int)cudaErrorInvalidValue;
  const int v[4] = {p.C, p.tq, p.smem_fwd, p.smem_bwd};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}

// How many of K8's clusters the card holds at once for this shape (0: the
// launch cannot run); a negative cudaError_t on failure.
MMB_API int mmb_bidaf_backward_occupancy(int Tc, int Tq, int D) {
  bc::Plan p;
  if (!bc::plan(Tc, Tq, D, &p)) return -(int)cudaErrorInvalidValue;
  return bc::max_active_clusters(bidaf_drop_bwd_cluster_kernel, p, bc::kThreadsBwd, p.smem_bwd);
}
