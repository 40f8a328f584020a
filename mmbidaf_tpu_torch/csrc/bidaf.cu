// K2 — the fused BiDAF attention block for serving — and K7, the same block
// for training with dropped operands in the similarity; both on one
// thread-block cluster an example, split over T_q.
//
// Replaces: mmbidaf_tpu/ops/pallas/bidaf_kernel.py::_bidaf_kernel (K2, entry
// point bidaf_attention_fused) and ::_bidaf_drop_kernel (K7, entry
// bidaf_attention_fused_dropout, also reached through
// bidaf_attention_fused_trainable with cd = c, qd = q). Contract, all in f32:
//   S     = c·w_c 1ᵀ + 1 (q·w_q)ᵀ + (c∘w_cq)·qᵀ + bias          [T_c, T_q]
//   s_row = softmax over T_q of  qm*S + (1-qm)*(-1e30)
//   s_col = softmax over T_c of  cm*S + (1-cm)*(-1e30)
//   a = s_row·q;   b = s_row·s_colᵀ·c;   out = [c; a; c∘a; c∘b]   [T_c, 4D]
// A fully masked q row or c column softmaxes to the uniform distribution,
// as the -1e30 fill does in the reference. K7 forms S from the dropped cd,
// qd (c·w_c, q·w_q and (c∘w_cq)·qᵀ all take the dropped operands) and
// everything after S from the undropped c, q.
//
// What bounds them on the H100: the f32 operations (~0.1 GFLOP a call at
// the serving audio tower, B=64, T_c=32, T_q=512, D=256) once they are
// spread over the card. The TPU kernel held q and s_colᵀ·c ([T_q, D] = 512
// KB each in f32) in VMEM; a block has 227 KB, and one block an example
// (the first port of both) left most of the 132 SMs idle and walked q twice.
// Design (the split, the plan and the products: csrc/bidaf_cluster.cuh):
// one cluster of C blocks an example, rank r owning the q tile J.
//   1. cd (K2: c), qd's tile (K2: q's) and the rank's D columns of c by
//      cp.async; cd∘w_cq; S_J as register micro-tiles; the exact s_col_J;
//      the tile's row max m_J, p = exp(S_J − m_J) and l_J.
//   2. K7: q's tile in qd's place (K2 keeps the tile it has); the partials
//      a_J = p·q_J and P_J = p·s_col_Jᵀ ([T_c, D] and [T_c, T_c]).
//                                                          cluster barrier
//   3. Every rank forms the weights w_J and P = Σ_J w_J·P_J in full, and on
//      its D columns a = Σ_J w_J·a_J (rank order, through distributed shared
//      memory), b = P·c and out.                           cluster barrier
// Q2C is reassociated as P = s_row·s_colᵀ ([T_c, T_c]) then b = P·c, so the
// [T_q, D] s_colᵀ·c product never exists; this changes the order of the
// sums against the reference's s_row·(s_colᵀ·c) (the tolerance in
// ops/cuda/bidaf_kernel.py says so). One launch a call, no global scratch;
// bit for bit the same twice, and K2 gives K7's bits at cd = c, qd = q (the
// same sums in the same order). 95,872 bytes of shared memory a block at
// the audio shape (T_c=32, tq=32, D=256); 256 threads a block
// (bidaf_cluster.cuh). K2's plan is judged on the forward section of the
// layout alone; past it (T_q > 2048 at T_c=32, D=256) the wrapper launches
// K9 (csrc/bidaf_tiled.cu).
#include "bidaf_cluster.cuh"
#include "common.cuh"

#include <math.h>

namespace {

namespace bc = mmb::bidafc;

// The forward of one example on its cluster: K7 (kDrop) forms S from cd
// and qd, K2 from c and q themselves (cd and qd unused).
template <bool kDrop>
__device__ __forceinline__ void fwd_cluster_body(
    const float* __restrict__ c, const float* __restrict__ q,            // [B,Tc,D], [B,Tq,D]
    const float* __restrict__ cd, const float* __restrict__ qd,          // dropped operands
    const float* __restrict__ c_mask, const float* __restrict__ q_mask,  // [B,Tc], [B,Tq]
    const float* __restrict__ w_c, const float* __restrict__ w_q,
    const float* __restrict__ w_cq, const float* __restrict__ bias,      // [D] x3, [1]
    float* __restrict__ out,                                             // [B,Tc,4D]
    int Tc, int Tq, int D, int tq) {
  bc::cg::cluster_group cluster = bc::cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int C = gridDim.x, r = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const bc::Layout L(Tc, tq, D, C);
  const int LD = L.LD, LQ = L.LQ, LT = L.LT;
  const int j0 = r * tq, nj = min(tq, Tq - j0);
  const float* cb = c + (size_t)b * Tc * D;
  const float* cdb = (kDrop ? cd : c) + (size_t)b * Tc * D;
  const float* qb = q + ((size_t)b * Tq + j0) * D;    // this tile's first q row
  const float* qdb = (kDrop ? qd : q) + ((size_t)b * Tq + j0) * D;
  float* tile = smem + L.tile;
  float* cw = smem + L.cw;  // cd∘w_cq, then a_J = p·q_J
  float* sr = smem + L.sr;
  const float* sc = smem + L.sc;
  float* pp = smem + L.pp;
  const float* pf = smem + L.pf;
  const float* wts = smem + L.wts;
  const int d0 = r * D / C, nd = (r + 1) * D / C - d0, ND = L.ND;
  float* cs = smem + L.cs;  // [Tc][ND] this rank's D columns of c

  // 1. cd (into cw; K2: c), qd's tile (K2: q's) and this rank's D columns
  // of c by cp.async; s0, s1 and cd∘w_cq; S_J, s_col_J and the row
  // statistics.
  bc::copy_rows_async(cw, cdb, Tc, D, LD, D);
  bc::copy_rows_async(tile, qdb, nj, D, LD, D);
  bc::copy_rows_async(cs, cb + d0, Tc, nd, ND, D);
  bc::s_operands(smem, L, Tc, nj, D, w_c, w_q, w_cq);
  bc::tile_softmaxes(smem, L, Tc, nj, D, c_mask + (size_t)b * Tc, q_mask + (size_t)b * Tq + j0,
                     *bias);

  // 2. K7: q's tile in qd's place, in flight during P_J = p·s_colᵀ (K2's
  // tile holds q's already); then a_J = p·q_J in cw's place.
  if (kDrop) bc::copy_rows_async(tile, qb, nj, D, LD, D);
  bc::block_tiles<2, 2>(
      Tc, Tc,
      [&](const int(&ms)[2], const int(&ns)[2], float(&acc)[2][2]) {
        bc::accumulate(acc, ms, ns, nj, [&](int i, int j) { return sr[i * LQ + j]; },
                       [&](int k, int j) { return sc[k * LQ + j]; });
      },
      [&](int i, int k, float v) { pp[i * LT + k] = v; });
  if (kDrop) {  // K2: nothing in flight, and a_J reads nothing P_J writes
    bc::cp_async_wait_all();
    __syncthreads();
  }
  bc::block_tiles<4, 4>(
      Tc, D,
      [&](const int(&ms)[4], const int(&ns)[4], float(&acc)[4][4]) {
        bc::accumulate(acc, ms, ns, nj, [&](int i, int j) { return sr[i * LQ + j]; },
                       [&](int d, int j) { return tile[j * LD + d]; });
      },
      [&](int i, int d, float v) { cw[i * LD + d] = v; });
  cluster.sync();  // every tile's m, l, a_J and P_J are in place

  // 3. The weights w_J and P; this rank's D columns of a, b = P·c and
  // out = [c; a; c∘a; c∘b].
  bc::combine_rows(smem, L, Tc, C, cluster);
  for (int e = tid; e < Tc * nd; e += blockDim.x) {
    const int i = e / nd, dd = e - i * nd, d = d0 + dd;
    float a = 0.0f;
#pragma unroll 4
    for (int J = 0; J < C; ++J)
      a = fmaf(wts[J * Tc + i], cluster.map_shared_rank(cw, J)[i * LD + d], a);
    float bv = 0.0f;
    for (int k = 0; k < Tc; ++k) bv = fmaf(pf[i * LT + k], cs[k * ND + dd], bv);
    const float cv = cs[i * ND + dd];
    float* o = out + ((size_t)b * Tc + i) * 4 * D;
    o[d] = cv;
    o[D + d] = a;
    o[2 * D + d] = cv * a;
    o[3 * D + d] = cv * bv;
  }
  cluster.sync();  // no block leaves while the cluster still reads its shared memory
}

__global__ void __launch_bounds__(bc::kThreadsFwd) bidaf_fwd_cluster_kernel(
    const float* __restrict__ c, const float* __restrict__ q, const float* __restrict__ c_mask,
    const float* __restrict__ q_mask, const float* __restrict__ w_c, const float* __restrict__ w_q,
    const float* __restrict__ w_cq, const float* __restrict__ bias, float* __restrict__ out,
    int Tc, int Tq, int D, int tq) {
  fwd_cluster_body<false>(c, q, nullptr, nullptr, c_mask, q_mask, w_c, w_q, w_cq, bias, out, Tc,
                          Tq, D, tq);
}

__global__ void __launch_bounds__(bc::kThreadsFwd) bidaf_drop_fwd_cluster_kernel(
    const float* __restrict__ c, const float* __restrict__ q, const float* __restrict__ cd,
    const float* __restrict__ qd, const float* __restrict__ c_mask,
    const float* __restrict__ q_mask, const float* __restrict__ w_c, const float* __restrict__ w_q,
    const float* __restrict__ w_cq, const float* __restrict__ bias, float* __restrict__ out,
    int Tc, int Tq, int D, int tq) {
  fwd_cluster_body<true>(c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias, out, Tc, Tq, D, tq);
}

}  // namespace

// K2: inference, on a cluster an example (K2's plan: the forward section).
MMB_API int mmb_bidaf_forward(const void* c, const void* q, const void* c_mask,
                              const void* q_mask, const void* w_c, const void* w_q,
                              const void* w_cq, const void* bias, void* out, int B, int Tc,
                              int Tq, int D, void* stream) {
  bc::Plan p;
  if (B <= 0 || !bc::plan(Tc, Tq, D, &p, /*fwd_only=*/true)) return (int)cudaErrorInvalidValue;
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  return (int)bc::launch(bidaf_fwd_cluster_kernel, p, B, bc::kThreadsFwd, p.smem_fwd,
                         static_cast<cudaStream_t>(stream), f(c), f(q), f(c_mask), f(q_mask),
                         f(w_c), f(w_q), f(w_cq), f(bias), static_cast<float*>(out), Tc, Tq, D,
                         p.tq);
}

// K2's cluster plan: out[4] = C, tq, the dynamic shared memory of a K2
// block, and of a K8 block at this split (bytes).
MMB_API int mmb_bidaf_fused_plan(int Tc, int Tq, int D, int* out) {
  bc::Plan p;
  if (!bc::plan(Tc, Tq, D, &p, /*fwd_only=*/true)) return (int)cudaErrorInvalidValue;
  const int v[4] = {p.C, p.tq, p.smem_fwd, p.smem_bwd};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}

// How many of K2's clusters the card holds at once for this shape (0: the
// launch cannot run); a negative cudaError_t on failure.
MMB_API int mmb_bidaf_forward_occupancy(int Tc, int Tq, int D) {
  bc::Plan p;
  if (!bc::plan(Tc, Tq, D, &p, /*fwd_only=*/true)) return -(int)cudaErrorInvalidValue;
  return bc::max_active_clusters(bidaf_fwd_cluster_kernel, p, bc::kThreadsFwd, p.smem_fwd);
}

// K7: training, S from the dropped cd / qd, on a cluster an example.
MMB_API int mmb_bidaf_forward_dropout(const void* c, const void* q, const void* cd,
                                      const void* qd, const void* c_mask, const void* q_mask,
                                      const void* w_c, const void* w_q, const void* w_cq,
                                      const void* bias, void* out, int B, int Tc, int Tq, int D,
                                      void* stream) {
  bc::Plan p;
  if (B <= 0 || !bc::plan(Tc, Tq, D, &p)) return (int)cudaErrorInvalidValue;
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  return (int)bc::launch(bidaf_drop_fwd_cluster_kernel, p, B, bc::kThreadsFwd, p.smem_fwd,
                         static_cast<cudaStream_t>(stream), f(c), f(q), f(cd), f(qd), f(c_mask),
                         f(q_mask), f(w_c), f(w_q), f(w_cq), f(bias), static_cast<float*>(out),
                         Tc, Tq, D, p.tq);
}

// How many of K7's clusters the card holds at once for this shape (0: the
// launch cannot run); a negative cudaError_t on failure.
MMB_API int mmb_bidaf_forward_dropout_occupancy(int Tc, int Tq, int D) {
  bc::Plan p;
  if (!bc::plan(Tc, Tq, D, &p)) return -(int)cudaErrorInvalidValue;
  return bc::max_active_clusters(bidaf_drop_fwd_cluster_kernel, p, bc::kThreadsFwd, p.smem_fwd);
}
