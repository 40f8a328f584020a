// K8 — fused BiDAF backward with dropped similarity operands, one block per
// batch element, and the deterministic sum of the parameter grads.
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
//   dS = qm∘s_row∘(d_s_row − rowsum(d_s_row∘s_row))
//      + cm∘s_col∘(d_s_col − colsum(d_s_col∘s_col))
//   d_cd = rowsum(dS)∘w_c + (dS·qd)∘w_cq,   d_qd = colsum(dS)∘w_q + dSᵀ·(cd∘w_cq)
//   dw_c = Σ_b Σ_i cd∘rowsum(dS),  dw_q = Σ_b Σ_j qd∘colsum(dS),
//   dw_cq = Σ_b Σ_i (dS·qd)∘cd,   dbias = Σ dS
// The TPU kernel forms qc = s_colᵀ·c and d_qc = s_rowᵀ·d_b ([T_q, D]); here
// both are reassociated through the [T_c, T_c] products E and P, so no
// [T_q, D] intermediate exists. The order of the sums differs from the
// reference's accordingly (ops/cuda/bidaf_kernel.py states the bound).
//
// What bounds it on the H100: memory per block, as in K2. At the audio
// shape (T_c=32, T_q=512, D=256) S, s_row, s_col and dS are 64 KB each in
// f32 and q, qd 512 KB each; a block has 227 KB. c, cd and d_a ([T_c, D],
// 32 KB each) stay in shared memory with E and P; q and qd stream through
// in tiles of kTQ rows; s_row, s_col and dS live in a global scratch
// [B, T_c, T_q] (2 MB each at B=32, resident in the 50 MB L2). Every row
// sum over T_q and column sum over T_c is taken after the full row or
// column is in that scratch. The parameter grads are per-block partials
// [B, 3D+1] that a second kernel sums over b in order: no atomics, two runs
// give the same bits. One block per batch element leaves most of the 132
// SMs idle at B=32; the batch is the only independent axis at this size.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 32;  // q / qd rows per streamed tile
constexpr int kRC = 32;  // context rows one thread keeps in registers

// Shared floats: c, cd, d_a, the q tile, E, P, s0, s1, w_cq, row sums, d_s0,
// d_s1 (ops/cuda/bidaf_kernel.py computes the same size to refuse shapes
// that do not fit).
size_t smem_floats(int Tc, int Tq, int D) {
  return 3 * (size_t)Tc * D + (size_t)kTQ * (D + 1) + 2 * (size_t)Tc * Tc + 3 * (size_t)Tc +
         kTQ + D + Tq;
}

__device__ void load_tile(float* t_s, const float* src, int j0, int nq, int D, int LD) {
  for (int e = threadIdx.x; e < nq * D; e += blockDim.x) {
    const int jj = e / D, d = e - jj * D;
    t_s[jj * LD + d] = src[(size_t)(j0 + jj) * D + d];
  }
}

__global__ void __launch_bounds__(kThreads) bidaf_bwd_kernel(
    const float* __restrict__ c, const float* __restrict__ q,            // [B,Tc,D], [B,Tq,D]
    const float* __restrict__ cd, const float* __restrict__ qd,          // dropped operands
    const float* __restrict__ c_mask, const float* __restrict__ q_mask,  // [B,Tc], [B,Tq]
    const float* __restrict__ w_c, const float* __restrict__ w_q,
    const float* __restrict__ w_cq, const float* __restrict__ bias,      // [D] x3, [1]
    const float* __restrict__ g,                                         // [B,Tc,4D]
    float* __restrict__ d_c, float* __restrict__ d_q,                    // [B,Tc,D], [B,Tq,D]
    float* __restrict__ d_cd, float* __restrict__ d_qd,                  // [B,Tc,D], [B,Tq,D]
    float* SR, float* SC, float* DS,  // scratch [B,Tc,Tq]: s_row, s_col, d_s_row then dS
    float* __restrict__ partial,      // [B, 3D+1]: dw_c | dw_q | dw_cq | dbias
    int Tc, int Tq, int D) {
  extern __shared__ float smem[];
  const int LD = D + 1;
  float* c_s = smem;              // [Tc][D]  c
  float* cd_s = c_s + Tc * D;     // [Tc][D]  cd
  float* da_s = cd_s + Tc * D;    // [Tc][D]  d_a
  float* t_s = da_s + Tc * D;     // [kTQ][LD] a q or qd tile
  float* E_s = t_s + kTQ * LD;    // [Tc][Tc] d_b·cᵀ
  float* P_s = E_s + Tc * Tc;     // [Tc][Tc] s_row·s_colᵀ
  float* s0 = P_s + Tc * Tc;      // [Tc] cd·w_c
  float* rs = s0 + Tc;            // [Tc] rowsum(d_s_row∘s_row)
  float* ds0 = rs + Tc;           // [Tc] rowsum(dS)
  float* s1 = ds0 + Tc;           // [kTQ] qd·w_q of the tile
  float* wcq_s = s1 + kTQ;        // [D]
  float* ds1 = wcq_s + D;         // [Tq] colsum(dS)
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const size_t TcD = (size_t)Tc * D, TqD = (size_t)Tq * D, TcTq = (size_t)Tc * Tq;
  const float* cb = c + b * TcD;
  const float* qb = q + b * TqD;
  const float* cdb = cd + b * TcD;
  const float* qdb = qd + b * TqD;
  const float* gb = g + b * TcD * 4;
  const float* cm = c_mask + (size_t)b * Tc;
  const float* qm = q_mask + (size_t)b * Tq;
  float* sr = SR + b * TcTq;
  float* sc = SC + b * TcTq;
  float* ds = DS + b * TcTq;
  const float bias_v = *bias;

  for (int e = tid; e < Tc * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D;
    const float cv = cb[e];
    c_s[e] = cv;
    cd_s[e] = cdb[e];
    da_s[e] = gb[(size_t)i * 4 * D + D + d] + gb[(size_t)i * 4 * D + 2 * D + d] * cv;
  }
  for (int d = tid; d < D; d += blockDim.x) wcq_s[d] = w_cq[d];
  __syncthreads();
  for (int i = warp; i < Tc; i += nwarps) {
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s = fmaf(cd_s[i * D + d], w_c[d], s);
    s = mmb::warp_sum(s);
    if (lane == 0) s0[i] = s;
  }

  // 1. S from cd, qd into sr, one qd tile at a time.
  for (int j0 = 0; j0 < Tq; j0 += kTQ) {
    const int nq = min(kTQ, Tq - j0);
    __syncthreads();
    load_tile(t_s, qdb, j0, nq, D, LD);
    __syncthreads();
    for (int jj = warp; jj < nq; jj += nwarps) {
      float s = 0.0f;
      for (int d = lane; d < D; d += 32) s = fmaf(t_s[jj * LD + d], w_q[d], s);
      s = mmb::warp_sum(s);
      if (lane == 0) s1[jj] = s;
    }
    __syncthreads();
    for (int e = tid; e < Tc * nq; e += blockDim.x) {
      const int i = e / nq, jj = e - i * nq;
      const float* ci = cd_s + i * D;
      const float* qj = t_s + jj * LD;
      float acc = 0.0f;
      for (int d = 0; d < D; ++d) acc = fmaf(ci[d] * wcq_s[d], qj[d], acc);
      sr[(size_t)i * Tq + j0 + jj] = s0[i] + s1[jj] + acc + bias_v;
    }
  }
  __syncthreads();

  // 2. Column softmax over T_c into sc, then the row softmax over T_q in place.
  for (int j = tid; j < Tq; j += blockDim.x) {
    float mx = -INFINITY;
    for (int i = 0; i < Tc; ++i) {
      const float m = cm[i];
      const float v = m * sr[(size_t)i * Tq + j] + (1.0f - m) * mmb::kNegInf;
      sc[(size_t)i * Tq + j] = v;
      mx = fmaxf(mx, v);
    }
    float sum = 0.0f;
    for (int i = 0; i < Tc; ++i) {
      const float e = expf(sc[(size_t)i * Tq + j] - mx);
      sc[(size_t)i * Tq + j] = e;
      sum += e;
    }
    for (int i = 0; i < Tc; ++i) sc[(size_t)i * Tq + j] = sc[(size_t)i * Tq + j] / sum;
  }
  __syncthreads();
  for (int i = warp; i < Tc; i += nwarps) {
    float* row = sr + (size_t)i * Tq;
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

  // 3. P = s_row·s_colᵀ and E = d_b·cᵀ (d_b = g3∘c), a warp per entry.
  for (int e = warp; e < Tc * Tc; e += nwarps) {
    const int i = e / Tc, k = e - i * Tc;
    float p = 0.0f;
    for (int j = lane; j < Tq; j += 32)
      p = fmaf(sr[(size_t)i * Tq + j], sc[(size_t)k * Tq + j], p);
    float x = 0.0f;
    for (int d = lane; d < D; d += 32)
      x = fmaf(gb[(size_t)i * 4 * D + 3 * D + d] * c_s[i * D + d], c_s[k * D + d], x);
    p = mmb::warp_sum(p);
    x = mmb::warp_sum(x);
    if (lane == 0) {
      P_s[e] = p;
      E_s[e] = x;
    }
  }

  // 4. a = s_row·q (q streamed), b = P·c, and d_c.
  for (int d0 = 0; d0 < D; d0 += blockDim.x) {
    const int d = d0 + tid;
    for (int i0 = 0; i0 < Tc; i0 += kRC) {
      float acc[kRC];
#pragma unroll
      for (int r = 0; r < kRC; ++r) acc[r] = 0.0f;
      for (int j0 = 0; j0 < Tq; j0 += kTQ) {
        const int nq = min(kTQ, Tq - j0);
        __syncthreads();  // also orders step 3's P and E before their readers
        load_tile(t_s, qb, j0, nq, D, LD);
        __syncthreads();
        if (d < D) {
          for (int jj = 0; jj < nq; ++jj) {
            const float qv = t_s[jj * LD + d];
#pragma unroll
            for (int r = 0; r < kRC; ++r)
              if (i0 + r < Tc) acc[r] = fmaf(sr[(size_t)(i0 + r) * Tq + j0 + jj], qv, acc[r]);
          }
        }
      }
      if (d < D) {
#pragma unroll
        for (int r = 0; r < kRC; ++r) {
          const int i = i0 + r;
          if (i >= Tc) continue;
          float bv = 0.0f, pt = 0.0f;
          for (int k = 0; k < Tc; ++k) {
            const float ck = c_s[k * D + d];
            bv = fmaf(P_s[i * Tc + k], ck, bv);
            pt = fmaf(P_s[k * Tc + i], gb[(size_t)k * 4 * D + 3 * D + d] * ck, pt);
          }
          const float* gi = gb + (size_t)i * 4 * D;
          d_c[b * TcD + (size_t)i * D + d] = gi[d] + gi[2 * D + d] * acc[r] + gi[3 * D + d] * bv + pt;
        }
      }
    }
  }
  __syncthreads();

  // 5a. d_s_row = E·s_col + d_a·qᵀ into ds, one q tile at a time.
  for (int j0 = 0; j0 < Tq; j0 += kTQ) {
    const int nq = min(kTQ, Tq - j0);
    __syncthreads();
    load_tile(t_s, qb, j0, nq, D, LD);
    __syncthreads();
    for (int e = tid; e < Tc * nq; e += blockDim.x) {
      const int i = e / nq, jj = e - i * nq;
      const int j = j0 + jj;
      float v = 0.0f;
      for (int k = 0; k < Tc; ++k) v = fmaf(E_s[i * Tc + k], sc[(size_t)k * Tq + j], v);
      const float* ai = da_s + i * D;
      const float* qj = t_s + jj * LD;
      for (int d = 0; d < D; ++d) v = fmaf(ai[d], qj[d], v);
      ds[(size_t)i * Tq + j] = v;
    }
  }
  __syncthreads();
  // 5b. rowsum(d_s_row∘s_row), a warp per row.
  for (int i = warp; i < Tc; i += nwarps) {
    float s = 0.0f;
    for (int j = lane; j < Tq; j += 32) s = fmaf(ds[(size_t)i * Tq + j], sr[(size_t)i * Tq + j], s);
    s = mmb::warp_sum(s);
    if (lane == 0) rs[i] = s;
  }
  __syncthreads();
  // 5c. dS, a thread per column: d_s_col = Eᵀ·s_row and its column sum,
  // then dS in place of d_s_row and colsum(dS).
  for (int j = tid; j < Tq; j += blockDim.x) {
    float cs = 0.0f;
    for (int i = 0; i < Tc; ++i) {
      float v = 0.0f;
      for (int k = 0; k < Tc; ++k) v = fmaf(E_s[k * Tc + i], sr[(size_t)k * Tq + j], v);
      cs = fmaf(v, sc[(size_t)i * Tq + j], cs);
    }
    const float qmj = qm[j];
    float col = 0.0f;
    for (int i = 0; i < Tc; ++i) {
      float v = 0.0f;
      for (int k = 0; k < Tc; ++k) v = fmaf(E_s[k * Tc + i], sr[(size_t)k * Tq + j], v);
      const size_t ij = (size_t)i * Tq + j;
      const float x = qmj * (sr[ij] * (ds[ij] - rs[i])) + cm[i] * (sc[ij] * (v - cs));
      ds[ij] = x;
      col += x;
    }
    ds1[j] = col;
  }
  __syncthreads();
  // 6. rowsum(dS), a warp per row.
  for (int i = warp; i < Tc; i += nwarps) {
    float s = 0.0f;
    for (int j = lane; j < Tq; j += 32) s += ds[(size_t)i * Tq + j];
    s = mmb::warp_sum(s);
    if (lane == 0) ds0[i] = s;
  }

  // 7. dS·qd (qd streamed), d_cd, and the dw_c / dw_cq partials.
  float* part = partial + (size_t)b * (3 * D + 1);
  for (int d0 = 0; d0 < D; d0 += blockDim.x) {
    const int d = d0 + tid;
    float pwc = 0.0f, pwcq = 0.0f;
    for (int i0 = 0; i0 < Tc; i0 += kRC) {
      float acc[kRC];
#pragma unroll
      for (int r = 0; r < kRC; ++r) acc[r] = 0.0f;
      for (int j0 = 0; j0 < Tq; j0 += kTQ) {
        const int nq = min(kTQ, Tq - j0);
        __syncthreads();  // also orders step 6's d_s0 before its readers
        load_tile(t_s, qdb, j0, nq, D, LD);
        __syncthreads();
        if (d < D) {
          for (int jj = 0; jj < nq; ++jj) {
            const float qv = t_s[jj * LD + d];
#pragma unroll
            for (int r = 0; r < kRC; ++r)
              if (i0 + r < Tc) acc[r] = fmaf(ds[(size_t)(i0 + r) * Tq + j0 + jj], qv, acc[r]);
          }
        }
      }
      if (d < D) {
#pragma unroll
        for (int r = 0; r < kRC; ++r) {
          const int i = i0 + r;
          if (i >= Tc) continue;
          const float cdv = cd_s[i * D + d];
          d_cd[b * TcD + (size_t)i * D + d] = ds0[i] * w_c[d] + acc[r] * wcq_s[d];
          pwcq = fmaf(acc[r], cdv, pwcq);
          pwc = fmaf(cdv, ds0[i], pwc);
        }
      }
    }
    if (d < D) {
      part[d] = pwc;
      part[2 * D + d] = pwcq;
    }
  }

  // 8. d_q = s_rowᵀ·d_a and d_qd = colsum(dS)∘w_q + dSᵀ·(cd∘w_cq), a thread
  // per (j, d); then the dw_q partial and the dbias partial.
  for (size_t e = tid; e < TqD; e += blockDim.x) {
    const int j = (int)(e / D), d = (int)(e - (size_t)j * D);
    float vq = 0.0f, vqd = 0.0f;
    for (int i = 0; i < Tc; ++i) {
      vq = fmaf(sr[(size_t)i * Tq + j], da_s[i * D + d], vq);
      vqd = fmaf(ds[(size_t)i * Tq + j], cd_s[i * D + d] * wcq_s[d], vqd);
    }
    d_q[b * TqD + e] = vq;
    d_qd[b * TqD + e] = ds1[j] * w_q[d] + vqd;
  }
  for (int d = tid; d < D; d += blockDim.x) {
    float pwq = 0.0f;
    for (int j = 0; j < Tq; ++j) pwq = fmaf(qdb[(size_t)j * D + d], ds1[j], pwq);
    part[D + d] = pwq;
  }
  if (tid == 0) {
    float pb = 0.0f;
    for (int i = 0; i < Tc; ++i) pb += ds0[i];
    part[3 * D] = pb;
  }
}

// The parameter grads: Σ_b partial[b], in batch order.
__global__ void sum_over_batch_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                      int B, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) acc += partial[(size_t)b * n + e];
  out[e] = acc;
}

}  // namespace

MMB_API int mmb_bidaf_backward(const void* c, const void* q, const void* cd, const void* qd,
                               const void* c_mask, const void* q_mask, const void* w_c,
                               const void* w_q, const void* w_cq, const void* bias,
                               const void* g, void* d_c, void* d_q, void* d_cd, void* d_qd,
                               void* scratch, void* partial, void* d_params, int B, int Tc,
                               int Tq, int D, void* stream) {
  if (B <= 0 || Tc <= 0 || Tq <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(Tc, Tq, D);
  if (smem > (size_t)mmb::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(bidaf_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const auto s = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);  // 3 x [B, Tc, Tq]
  const size_t plane = (size_t)B * Tc * Tq;
  bidaf_bwd_kernel<<<B, kThreads, smem, s>>>(
      static_cast<const float*>(c), static_cast<const float*>(q),
      static_cast<const float*>(cd), static_cast<const float*>(qd),
      static_cast<const float*>(c_mask), static_cast<const float*>(q_mask),
      static_cast<const float*>(w_c), static_cast<const float*>(w_q),
      static_cast<const float*>(w_cq), static_cast<const float*>(bias),
      static_cast<const float*>(g), static_cast<float*>(d_c), static_cast<float*>(d_q),
      static_cast<float*>(d_cd), static_cast<float*>(d_qd), scr, scr + plane, scr + 2 * plane,
      static_cast<float*>(partial), Tc, Tq, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = 3 * D + 1;
  sum_over_batch_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial),
                                                        static_cast<float*>(d_params), B, n);
  return (int)cudaGetLastError();
}
