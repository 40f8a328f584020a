// K9 — blockwise BiDAF attention: the long-T_q mode of K2.
//
// Replaces: mmbidaf_tpu/ops/pallas/bidaf_tiled_kernel.py::_tiled_kernel
// (entry point bidaf_attention_tiled). Contract: K2's (csrc/bidaf.cu), all
// in f32, for any T_q:
//   S     = c·w_c 1ᵀ + 1 (q·w_q)ᵀ + (c∘w_cq)·qᵀ + bias          [T_c, T_q]
//   s_row = softmax over T_q of  qm*S + (1-qm)*(-1e30)
//   s_col = softmax over T_c of  cm*S + (1-cm)*(-1e30)
//   a = s_row·q;   b = s_row·s_colᵀ·c;   out = [c; a; c∘a; c∘b]   [T_c, 4D]
// A fully masked row or column softmaxes to the uniform distribution over
// the true length (the TPU kernel pads both axes to block multiples, so
// there the uniform spreads over the padding too; here the last blocks are
// masked instead, which keeps K2's function).
//
// What bounds it on the H100: the operations (~0.14 GFLOP per example at
// the long-audio shape T_c=32, T_q=4096, D=256, in f32 on the CUDA cores),
// once the work is spread over the card. The TPU kernel runs one program per
// example and walks both block loops in order inside it; on the GPU that
// would leave 16 of 132 SMs busy at B=16, and K2's design (S resident in
// shared memory) stops at T_q ~ 700 at that width.
// Design — split the T_q axis across blocks, flash-decoding style:
// 1. grid (q blocks of tq columns, examples): c streams through shared
//    memory in tiles of tc rows and q in sub-tiles of kTQ rows to form the
//    block's S columns [T_c, tq] for ALL T_c rows, which stay in shared
//    memory. Each column is then complete, so the column softmax s_col is
//    exact inside the block. The row softmax is not: the block keeps its
//    own row maximum m and p = exp(S_r - m), writes m and l = Σp, and the
//    partial products a_J = p·q ([T_c, D]) and P_J = p·s_colᵀ ([T_c, T_c],
//    K2's reassociation of Q2C) to global scratch.
// 2. grid (context rows, examples): the combine. M = max over blocks of m,
//    w_J = exp(m_J - M) / Σ_J exp(m_J - M)·l_J; a = Σ_J w_J a_J and
//    P = Σ_J w_J P_J in block order; b = P·c; the output row.
// No atomics: every sum runs in a fixed order, so two runs agree bit for
// bit. The sums differ in order from the plain version (and Q2C is
// reassociated as in K2); ops/cuda/bidaf_kernel.py states the tolerance.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 32;  // q rows per streamed sub-tile
constexpr int kRC = 32;  // context rows whose C2Q sums one pass keeps in registers

// Shared floats of pass 1: c tile, q sub-tile (rows padded by one), S/p and
// s_col (rows padded by one), s0, s1, w_cq (ops/cuda/bidaf_kernel.py
// computes the same size to choose the block sizes).
size_t smem_floats(int Tc, int tc, int tq, int D) {
  return (size_t)tc * D + (size_t)kTQ * (D + 1) + 2 * (size_t)Tc * (tq + 1) + Tc + tq + D;
}

__device__ void load_rows(float* dst, const float* src, int r0, int nr, int D, int LD) {
  for (int e = threadIdx.x; e < nr * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    dst[r * LD + d] = src[(size_t)(r0 + r) * D + d];
  }
}

__global__ void __launch_bounds__(kThreads) tiled_block_kernel(
    const float* __restrict__ c, const float* __restrict__ q,            // [B,Tc,D], [B,Tq,D]
    const float* __restrict__ c_mask, const float* __restrict__ q_mask,  // [B,Tc], [B,Tq]
    const float* __restrict__ w_c, const float* __restrict__ w_q,
    const float* __restrict__ w_cq, const float* __restrict__ bias,      // [D] x3, [1]
    float* __restrict__ row_max, float* __restrict__ row_sum,            // [B,nqb,Tc]
    float* __restrict__ p_part, float* __restrict__ a_part,              // [B,nqb,Tc,Tc|D]
    int Tc, int Tq, int D, int tc, int tq) {
  extern __shared__ float smem[];
  const int LD = D + 1, LQ = tq + 1;
  float* c_s = smem;               // [tc][D]   c tile, then c∘w_cq
  float* q_s = c_s + tc * D;       // [kTQ][LD] q sub-tile
  float* s_s = q_s + kTQ * LD;     // [Tc][LQ]  S, then p
  float* col_s = s_s + Tc * LQ;    // [Tc][LQ]  s_col
  float* s0 = col_s + Tc * LQ;     // [Tc]      c·w_c
  float* s1 = s0 + Tc;             // [tq]      q·w_q
  float* wcq_s = s1 + tq;          // [D]
  const int J = blockIdx.x, nqb = gridDim.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int j0 = J * tq, nj = min(tq, Tq - j0);
  const float* cb = c + (size_t)b * Tc * D;
  const float* qb = q + ((size_t)b * Tq + j0) * D;  // this block's first q row
  const float* cm = c_mask + (size_t)b * Tc;
  const float* qm = q_mask + (size_t)b * Tq + j0;
  const size_t part = (size_t)b * nqb + J;            // this block's slot in the scratch
  const float bias_v = *bias;

  for (int d = tid; d < D; d += blockDim.x) wcq_s[d] = w_cq[d];
  for (int jj = warp; jj < nj; jj += nwarps) {
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s = fmaf(qb[(size_t)jj * D + d], w_q[d], s);
    s = mmb::warp_sum(s);
    if (lane == 0) s1[jj] = s;
  }

  // 1. The block's S columns, a c tile at a time, q streamed in sub-tiles.
  for (int i0 = 0; i0 < Tc; i0 += tc) {
    const int ni = min(tc, Tc - i0);
    __syncthreads();  // the previous tile's readers are done
    load_rows(c_s, cb, i0, ni, D, D);
    __syncthreads();
    for (int ii = warp; ii < ni; ii += nwarps) {
      float s = 0.0f;
      for (int d = lane; d < D; d += 32) s = fmaf(c_s[ii * D + d], w_c[d], s);
      s = mmb::warp_sum(s);
      if (lane == 0) s0[i0 + ii] = s;
    }
    __syncthreads();
    // c∘w_cq, rounded as the reference rounds (c * w_cq) before the product with q
    for (int e = tid; e < ni * D; e += blockDim.x) c_s[e] *= wcq_s[e % D];
    for (int jq0 = 0; jq0 < nj; jq0 += kTQ) {
      const int nq = min(kTQ, nj - jq0);
      __syncthreads();
      load_rows(q_s, qb, jq0, nq, D, LD);
      __syncthreads();
      for (int e = tid; e < ni * nq; e += blockDim.x) {
        const int ii = e / nq, jj = e - ii * nq;
        const float* ci = c_s + ii * D;
        const float* qj = q_s + jj * LD;
        float acc = 0.0f;
        for (int d = 0; d < D; ++d) acc = fmaf(ci[d], qj[d], acc);
        s_s[(i0 + ii) * LQ + jq0 + jj] = s0[i0 + ii] + s1[jq0 + jj] + acc + bias_v;
      }
    }
  }
  __syncthreads();

  // 2. Column softmax over all T_c (a thread per column): exact in the block.
  for (int jj = tid; jj < nj; jj += blockDim.x) {
    float mx = -INFINITY;
    for (int i = 0; i < Tc; ++i) {
      const float m = cm[i];
      const float v = m * s_s[i * LQ + jj] + (1.0f - m) * mmb::kNegInf;
      col_s[i * LQ + jj] = v;
      mx = fmaxf(mx, v);
    }
    float sum = 0.0f;
    for (int i = 0; i < Tc; ++i) {
      const float e = expf(col_s[i * LQ + jj] - mx);
      col_s[i * LQ + jj] = e;
      sum += e;
    }
    for (int i = 0; i < Tc; ++i) col_s[i * LQ + jj] = col_s[i * LQ + jj] / sum;
  }
  __syncthreads();
  // ... and the block's share of the row softmax (a warp per row): its own
  // maximum m, p = exp(S_r - m) in place of S, l = Σ p.
  for (int i = warp; i < Tc; i += nwarps) {
    float* row = s_s + i * LQ;
    float mx = -INFINITY;
    for (int jj = lane; jj < nj; jj += 32) {
      const float m = qm[jj];
      const float v = m * row[jj] + (1.0f - m) * mmb::kNegInf;
      row[jj] = v;
      mx = fmaxf(mx, v);
    }
    mx = mmb::warp_max(mx);
    float sum = 0.0f;
    for (int jj = lane; jj < nj; jj += 32) {
      const float e = expf(row[jj] - mx);
      row[jj] = e;
      sum += e;
    }
    sum = mmb::warp_sum(sum);
    if (lane == 0) {
      row_max[part * Tc + i] = mx;
      row_sum[part * Tc + i] = sum;
    }
  }
  __syncthreads();

  // 3. P_J = p·s_colᵀ [Tc, Tc].
  for (int e = tid; e < Tc * Tc; e += blockDim.x) {
    const int i = e / Tc, k = e - i * Tc;
    const float* pi = s_s + i * LQ;
    const float* ck = col_s + k * LQ;
    float acc = 0.0f;
    for (int jj = 0; jj < nj; ++jj) acc = fmaf(pi[jj], ck[jj], acc);
    p_part[part * Tc * Tc + e] = acc;
  }

  // 4. a_J = p·q (q streamed again): a thread per feature, kRC rows in registers.
  for (int d0 = 0; d0 < D; d0 += blockDim.x) {
    const int d = d0 + tid;
    for (int r0 = 0; r0 < Tc; r0 += kRC) {
      float acc[kRC];
#pragma unroll
      for (int r = 0; r < kRC; ++r) acc[r] = 0.0f;
      for (int jq0 = 0; jq0 < nj; jq0 += kTQ) {
        const int nq = min(kTQ, nj - jq0);
        __syncthreads();
        load_rows(q_s, qb, jq0, nq, D, LD);
        __syncthreads();
        if (d < D) {
          for (int jj = 0; jj < nq; ++jj) {
            const float qv = q_s[jj * LD + d];
#pragma unroll
            for (int r = 0; r < kRC; ++r)
              if (r0 + r < Tc) acc[r] = fmaf(s_s[(r0 + r) * LQ + jq0 + jj], qv, acc[r]);
          }
        }
      }
      if (d < D) {
#pragma unroll
        for (int r = 0; r < kRC; ++r)
          if (r0 + r < Tc) a_part[(part * Tc + r0 + r) * D + d] = acc[r];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) tiled_combine_kernel(
    const float* __restrict__ c, const float* __restrict__ row_max,
    const float* __restrict__ row_sum, const float* __restrict__ p_part,
    const float* __restrict__ a_part, float* __restrict__ out, int nqb, int Tc, int D) {
  extern __shared__ float smem[];
  float* w_s = smem;       // [nqb] the blocks' weights w_J
  float* p_s = w_s + nqb;  // [Tc]  row i of P = Σ_J w_J P_J
  const int i = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t first = (size_t)b * nqb;  // slot of (b, J=0)
  if (tid < 32) {
    float mx = -INFINITY;
    for (int J = tid; J < nqb; J += 32) mx = fmaxf(mx, row_max[(first + J) * Tc + i]);
    mx = mmb::warp_max(mx);
    float l = 0.0f;
    for (int J = tid; J < nqb; J += 32) {
      const float w = expf(row_max[(first + J) * Tc + i] - mx);
      w_s[J] = w;
      l = fmaf(w, row_sum[(first + J) * Tc + i], l);
    }
    l = mmb::warp_sum(l);
    for (int J = tid; J < nqb; J += 32) w_s[J] = w_s[J] / l;
  }
  __syncthreads();
  for (int k = tid; k < Tc; k += blockDim.x) {
    float acc = 0.0f;
    for (int J = 0; J < nqb; ++J) acc = fmaf(w_s[J], p_part[((first + J) * Tc + i) * Tc + k], acc);
    p_s[k] = acc;
  }
  __syncthreads();
  const float* cb = c + (size_t)b * Tc * D;
  float* o = out + ((size_t)b * Tc + i) * 4 * D;
  for (int d = tid; d < D; d += blockDim.x) {
    float a = 0.0f;
    for (int J = 0; J < nqb; ++J) a = fmaf(w_s[J], a_part[((first + J) * Tc + i) * D + d], a);
    float bsum = 0.0f;
    for (int k = 0; k < Tc; ++k) bsum = fmaf(p_s[k], cb[(size_t)k * D + d], bsum);
    const float cv = cb[(size_t)i * D + d];
    o[d] = cv;
    o[D + d] = a;
    o[2 * D + d] = cv * a;
    o[3 * D + d] = cv * bsum;
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// K9: scratch row_max/row_sum [B, nqb, Tc], p_part [B, nqb, Tc, Tc], a_part
// [B, nqb, Tc, D] with nqb = ceil(Tq / tq); tc <= Tc rows of c per tile.
MMB_API int mmb_bidaf_tiled_forward(const void* c, const void* q, const void* c_mask,
                                    const void* q_mask, const void* w_c, const void* w_q,
                                    const void* w_cq, const void* bias, void* out, void* row_max,
                                    void* row_sum, void* p_part, void* a_part, int B, int Tc,
                                    int Tq, int D, int tc, int tq, void* stream) {
  if (B <= 0 || Tc <= 0 || Tq <= 0 || D <= 0 || tc <= 0 || tc > Tc || tq <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int nqb = (Tq + tq - 1) / tq;
  const size_t smem1 = sizeof(float) * smem_floats(Tc, tc, tq, D);
  const size_t smem2 = sizeof(float) * ((size_t)nqb + Tc);
  if (smem1 > (size_t)mmb::kMaxSmemBytes || smem2 > (size_t)mmb::kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem((const void*)tiled_block_kernel, smem1);
  if (e != cudaSuccess) return (int)e;
  tiled_block_kernel<<<dim3(nqb, B), kThreads, smem1, s>>>(
      static_cast<const float*>(c), static_cast<const float*>(q),
      static_cast<const float*>(c_mask), static_cast<const float*>(q_mask),
      static_cast<const float*>(w_c), static_cast<const float*>(w_q),
      static_cast<const float*>(w_cq), static_cast<const float*>(bias),
      static_cast<float*>(row_max), static_cast<float*>(row_sum), static_cast<float*>(p_part),
      static_cast<float*>(a_part), Tc, Tq, D, tc, tq);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = set_smem((const void*)tiled_combine_kernel, smem2);
  if (e != cudaSuccess) return (int)e;
  tiled_combine_kernel<<<dim3(Tc, B), kThreads, smem2, s>>>(
      static_cast<const float*>(c), static_cast<const float*>(row_max),
      static_cast<const float*>(row_sum), static_cast<const float*>(p_part),
      static_cast<const float*>(a_part), static_cast<float*>(out), nqb, Tc, D);
  return (int)cudaGetLastError();
}
