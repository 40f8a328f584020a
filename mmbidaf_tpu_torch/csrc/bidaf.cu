// K2 — fused BiDAF attention block, one block per batch element — and K7,
// the same block for training with dropped operands in the similarity, one
// thread-block cluster per batch element.
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
// K2 (bidaf_kernel<false>). What bounds it on the H100: shared memory, not
// FLOPs (~0.1 GFLOP per call at the audio tower's T_c=32, T_q=512, D=256).
// The TPU kernel held q and s_colᵀ·c ([T_q, D] = 512 KB each in f32) in
// VMEM; a block has 227 KB. Design:
// - q streams through shared memory in tiles of kTQ rows, twice: once to
//   build S, once for a = s_row·q. c ([T_c, D] = 32 KB) stays resident.
// - S ([T_c, T_q] = 64 KB at the bench shape) stays resident, so the
//   column softmax is local to each column; s_row overwrites S in place
//   after s_col has been taken from it.
// - Q2C is reassociated as P = s_row·s_colᵀ ([T_c, T_c]) then b = P·c, so
//   the [T_q, D] s_colᵀ·c product never exists. This changes the order of
//   the sums against the reference's s_row·(s_colᵀ·c); the tolerance in
//   ops/cuda/bidaf_kernel.py says so.
// - Row strides of the q tile and of S are padded by one float so that
//   the column walks of the dot products hit 32 distinct banks.
// The kernel's kDrop branches were K7's first port; K7 no longer takes
// them, and they stay so that K2's statements stay as measured until K2
// takes K7's design.
//
// K7 (bidaf_drop_fwd_cluster_kernel). What bounds it: the f32 operations
// (~0.6 GFLOP a call at the training audio shape, B=32) once they are spread
// over the card; one block an example left 100 of 132 SMs idle at B=32.
// Design (the split, the plan and the products: csrc/bidaf_cluster.cuh):
// one cluster of C blocks an example, rank r owning the q tile J.
//   1. cd, qd's tile and the rank's D columns of c by cp.async; cd∘w_cq;
//      S_J as register micro-tiles; the exact s_col_J; the tile's row max
//      m_J, p = exp(S_J − m_J) and l_J.
//   2. q's tile in qd's place; the partials a_J = p·q_J and P_J = p·s_col_Jᵀ
//      ([T_c, D] and [T_c, T_c]).                          cluster barrier
//   3. Every rank forms the weights w_J and P = Σ_J w_J·P_J in full, and on
//      its D columns a = Σ_J w_J·a_J (rank order, through distributed shared
//      memory), b = P·c and out.                           cluster barrier
// One launch a call, no global scratch; bit for bit the same twice. 95,872
// bytes of shared memory a block at the audio shape (T_c=32, tq=32,
// D=256); 256 threads a block (bidaf_cluster.cuh).
#include "bidaf_cluster.cuh"
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 32;  // q rows per streamed tile
constexpr int kRC = 32;  // context rows whose C2Q sums one pass keeps in registers

// Shared floats: c, q tile, S/s_row, s_col, P, s0, s1, w_cq (bidaf_kernel.py
// computes the same size to refuse shapes that do not fit).
size_t smem_floats(int Tc, int Tq, int D) {
  return (size_t)Tc * D + (size_t)kTQ * (D + 1) + 2 * (size_t)Tc * (Tq + 1) +
         (size_t)Tc * Tc + Tc + kTQ + D;
}

__device__ void load_q_tile(float* q_s, const float* qb, int j0, int nq, int D, int LD) {
  for (int e = threadIdx.x; e < nq * D; e += blockDim.x) {
    const int jj = e / D, d = e - jj * D;
    q_s[jj * LD + d] = qb[(size_t)(j0 + jj) * D + d];
  }
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads) bidaf_kernel(
    const float* __restrict__ c, const float* __restrict__ q,           // [B,Tc,D], [B,Tq,D]
    const float* __restrict__ cd, const float* __restrict__ qd,         // dropped (kDrop only)
    const float* __restrict__ c_mask, const float* __restrict__ q_mask,  // [B,Tc], [B,Tq]
    const float* __restrict__ w_c, const float* __restrict__ w_q,
    const float* __restrict__ w_cq, const float* __restrict__ bias,      // [D] x3, [1]
    float* __restrict__ out,                                             // [B,Tc,4D]
    int Tc, int Tq, int D) {
  extern __shared__ float smem[];
  const int LD = D + 1, LQ = Tq + 1;
  float* c_s = smem;               // [Tc][D]
  float* q_s = c_s + Tc * D;       // [kTQ][LD]
  float* srow = q_s + kTQ * LD;    // [Tc][LQ]  S, then s_row
  float* scol = srow + Tc * LQ;    // [Tc][LQ]  s_col
  float* p_s = scol + Tc * LQ;     // [Tc][Tc]  s_row·s_colᵀ
  float* s0 = p_s + Tc * Tc;       // [Tc]      c·w_c
  float* s1 = s0 + Tc;             // [kTQ]     q·w_q of the tile
  float* wcq_s = s1 + kTQ;         // [D]
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const float* cb = c + (size_t)b * Tc * D;
  const float* qb = q + (size_t)b * Tq * D;
  // the operands of S: the dropped ones under kDrop
  const float* cs = kDrop ? cd + (size_t)b * Tc * D : cb;
  const float* qs = kDrop ? qd + (size_t)b * Tq * D : qb;
  const float* cm = c_mask + (size_t)b * Tc;
  const float* qm = q_mask + (size_t)b * Tq;
  const float bias_v = *bias;

  for (int e = tid; e < Tc * D; e += blockDim.x) c_s[e] = cs[e];
  for (int d = tid; d < D; d += blockDim.x) wcq_s[d] = w_cq[d];
  __syncthreads();
  for (int i = warp; i < Tc; i += nwarps) {
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s = fmaf(c_s[i * D + d], w_c[d], s);
    s = mmb::warp_sum(s);
    if (lane == 0) s0[i] = s;
  }

  // 1. S, one q tile at a time.
  for (int j0 = 0; j0 < Tq; j0 += kTQ) {
    const int nq = min(kTQ, Tq - j0);
    __syncthreads();  // the previous tile's readers are done
    load_q_tile(q_s, qs, j0, nq, D, LD);
    __syncthreads();
    for (int jj = warp; jj < nq; jj += nwarps) {
      float s = 0.0f;
      for (int d = lane; d < D; d += 32) s = fmaf(q_s[jj * LD + d], w_q[d], s);
      s = mmb::warp_sum(s);
      if (lane == 0) s1[jj] = s;
    }
    __syncthreads();
    for (int e = tid; e < Tc * nq; e += blockDim.x) {
      const int i = e / nq, jj = e - i * nq;
      const float* ci = c_s + i * D;
      const float* qj = q_s + jj * LD;
      float acc = 0.0f;
      for (int d = 0; d < D; ++d) acc = fmaf(ci[d] * wcq_s[d], qj[d], acc);
      srow[i * LQ + j0 + jj] = s0[i] + s1[jj] + acc + bias_v;
    }
  }
  __syncthreads();
  if (kDrop) {  // the undropped c for everything after S
    for (int e = tid; e < Tc * D; e += blockDim.x) c_s[e] = cb[e];
    __syncthreads();
  }

  // 2. Column softmax over T_c (a thread per column) into s_col ...
  for (int j = tid; j < Tq; j += blockDim.x) {
    float mx = -INFINITY;
    for (int i = 0; i < Tc; ++i) {
      const float m = cm[i];
      const float v = m * srow[i * LQ + j] + (1.0f - m) * mmb::kNegInf;
      scol[i * LQ + j] = v;
      mx = fmaxf(mx, v);
    }
    float sum = 0.0f;
    for (int i = 0; i < Tc; ++i) {
      const float e = expf(scol[i * LQ + j] - mx);
      scol[i * LQ + j] = e;
      sum += e;
    }
    for (int i = 0; i < Tc; ++i) scol[i * LQ + j] = scol[i * LQ + j] / sum;
  }
  __syncthreads();
  // ... then the row softmax over T_q (a warp per row) in place of S.
  for (int i = warp; i < Tc; i += nwarps) {
    float* row = srow + i * LQ;
    float mx = -INFINITY;
    for (int j = lane; j < Tq; j += 32) {
      const float m = qm[j];
      const float v = m * row[j] + (1.0f - m) * mmb::kNegInf;
      row[j] = v;
      mx = fmaxf(mx, v);
    }
    mx = mmb::warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < Tq; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = mmb::warp_sum(sum);
    for (int j = lane; j < Tq; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  // 3. P = s_row·s_colᵀ.
  for (int e = tid; e < Tc * Tc; e += blockDim.x) {
    const int i = e / Tc, k = e - i * Tc;
    const float* ri = srow + i * LQ;
    const float* ck = scol + k * LQ;
    float acc = 0.0f;
    for (int j = 0; j < Tq; ++j) acc = fmaf(ri[j], ck[j], acc);
    p_s[e] = acc;
  }

  // 4. a = s_row·q (q streamed again), b = P·c, and the output rows.
  for (int d0 = 0; d0 < D; d0 += blockDim.x) {
    const int d = d0 + tid;
    for (int i0 = 0; i0 < Tc; i0 += kRC) {
      float acc[kRC];
#pragma unroll
      for (int r = 0; r < kRC; ++r) acc[r] = 0.0f;
      for (int j0 = 0; j0 < Tq; j0 += kTQ) {
        const int nq = min(kTQ, Tq - j0);
        __syncthreads();  // also orders step 3's P before its readers below
        load_q_tile(q_s, qb, j0, nq, D, LD);
        __syncthreads();
        if (d < D) {
          for (int jj = 0; jj < nq; ++jj) {
            const float qv = q_s[jj * LD + d];
#pragma unroll
            for (int r = 0; r < kRC; ++r)
              if (i0 + r < Tc) acc[r] = fmaf(srow[(i0 + r) * LQ + j0 + jj], qv, acc[r]);
          }
        }
      }
      if (d < D) {
#pragma unroll
        for (int r = 0; r < kRC; ++r) {
          const int i = i0 + r;
          if (i < Tc) {
            float bsum = 0.0f;
            for (int k = 0; k < Tc; ++k) bsum = fmaf(p_s[i * Tc + k], c_s[k * D + d], bsum);
            const float cv = c_s[i * D + d];
            float* o = out + ((size_t)b * Tc + i) * 4 * D;
            o[d] = cv;
            o[D + d] = acc[r];
            o[2 * D + d] = cv * acc[r];
            o[3 * D + d] = cv * bsum;
          }
        }
      }
    }
  }
}

template <bool kDrop>
int bidaf_forward(const void* c, const void* q, const void* cd, const void* qd,
                  const void* c_mask, const void* q_mask, const void* w_c, const void* w_q,
                  const void* w_cq, const void* bias, void* out, int B, int Tc, int Tq, int D,
                  void* stream) {
  if (B <= 0 || Tc <= 0 || Tq <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(Tc, Tq, D);
  if (smem > (size_t)mmb::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(bidaf_kernel<kDrop>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  bidaf_kernel<kDrop><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c), static_cast<const float*>(q),
      static_cast<const float*>(cd), static_cast<const float*>(qd),
      static_cast<const float*>(c_mask), static_cast<const float*>(q_mask),
      static_cast<const float*>(w_c), static_cast<const float*>(w_q),
      static_cast<const float*>(w_cq), static_cast<const float*>(bias),
      static_cast<float*>(out), Tc, Tq, D);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K7: the training block on a thread-block cluster (csrc/bidaf_cluster.cuh).
// ---------------------------------------------------------------------------

namespace bc = mmb::bidafc;

__global__ void __launch_bounds__(bc::kThreadsFwd) bidaf_drop_fwd_cluster_kernel(
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
  const float* cdb = cd + (size_t)b * Tc * D;
  const float* qb = q + ((size_t)b * Tq + j0) * D;    // this tile's first q row
  const float* qdb = qd + ((size_t)b * Tq + j0) * D;
  float* tile = smem + L.tile;
  float* cw = smem + L.cw;  // cd∘w_cq, then a_J = p·q_J
  float* sr = smem + L.sr;
  const float* sc = smem + L.sc;
  float* pp = smem + L.pp;
  const float* pf = smem + L.pf;
  const float* wts = smem + L.wts;
  const int d0 = r * D / C, nd = (r + 1) * D / C - d0, ND = L.ND;
  float* cs = smem + L.cs;  // [Tc][ND] this rank's D columns of c

  // 1. cd (into cw), qd's tile and this rank's D columns of c by cp.async;
  // s0, s1 and cd∘w_cq; S_J, s_col_J and the row statistics.
  bc::copy_rows_async(cw, cdb, Tc, D, LD, D);
  bc::copy_rows_async(tile, qdb, nj, D, LD, D);
  bc::copy_rows_async(cs, cb + d0, Tc, nd, ND, D);
  bc::s_operands(smem, L, Tc, nj, D, w_c, w_q, w_cq);
  bc::tile_softmaxes(smem, L, Tc, nj, D, c_mask + (size_t)b * Tc, q_mask + (size_t)b * Tq + j0,
                     *bias);

  // 2. q's tile in qd's place, in flight during P_J = p·s_colᵀ; then
  // a_J = p·q_J in cw's place.
  bc::copy_rows_async(tile, qb, nj, D, LD, D);
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

}  // namespace

// K2: inference.
MMB_API int mmb_bidaf_forward(const void* c, const void* q, const void* c_mask,
                              const void* q_mask, const void* w_c, const void* w_q,
                              const void* w_cq, const void* bias, void* out, int B, int Tc,
                              int Tq, int D, void* stream) {
  return bidaf_forward<false>(c, q, nullptr, nullptr, c_mask, q_mask, w_c, w_q, w_cq, bias, out,
                              B, Tc, Tq, D, stream);
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
