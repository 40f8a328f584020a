// K6 — BiLSTM backward through time (BPTT), both directions in one launch,
// and the dW_h reduction over the residuals.
//
// Replaces: mmbidaf_tpu/ops/pallas/lstm_kernel.py::_lstm_bwd_kernel (entry
// _trainable_bwd, the custom VJP of lstm_pallas_trainable). Contract, per
// direction, walking the processing steps s = T-1 … 0 (position
// tt = s, or T-1-s in the reverse direction), all in f32:
//   h_prev, c_prev = the carried state after step s-1 (zero at s = 0),
//     read back from the residuals h_seq / c_seq [2, T, B, H] that K5 wrote
//   z = gates_tt + h_prev @ W_h;  i,f,g,o = σ,σ,tanh,σ;  c_new = f*c_prev + i*g
//   dh_new = m*(dout_tt + dh);  do = dh_new*tanh(c_new)
//   dc_new = dh_new*o*(1 - tanh(c_new)^2) + m*dc
//   dz = [dc_new*g*i(1-i), dc_new*c_prev*f(1-f), dc_new*i*(1-g^2), do*o(1-o)]
//   dh <- (1-m)*dh + dz @ W_h^T;   dc <- f*dc_new + (1-m)*dc
// with dh, dc seeded from the cotangents of (h_last, c_last), which are not
// zero (the word tower's final h is pooled). Outputs: dgates in the layout
// of the gates ([B, T, 2, 4H], so the input projection's backward reads it
// as it is) and dW_h = Σ_s Σ_rows h_prevᵀ·dz [2, H, 4H]. dx, dW_x and db
// stay GEMMs outside the kernel, as on the TPU.
//
// What bounds it on the H100: as K1, the walk is sequential in T and reads
// all of W_h (256 KB in f32, over a block's 227 KB) twice a step, as W_h for
// the recomputed z and as W_hᵀ for dz @ W_hᵀ. Both are read from L2 with
// each read reused for the block's R rows; the wrapper passes W_hᵀ as a
// transposed copy so that both reads are coalesced. The TPU kernel summed
// dW_h in VMEM across its sequential grid; here blocks run in parallel, so
// dW_h is not formed in the walk. A second kernel computes it from the
// residuals after the walk: a tiled [H x N]·[N x 4H] product over
// N = (T-1)·rows (h_seq against dgates), split over N into per-block
// partials that a third pass sums in a fixed order. No atomics: two runs
// give the same bits.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The BPTT walk.
// ---------------------------------------------------------------------------

constexpr int kRC = 4;  // rows of dz @ W_hᵀ one thread keeps in registers

template <int R>
__global__ void __launch_bounds__(512) bilstm_bptt_kernel(
    const float* __restrict__ gates,    // [B, T, 2, 4H]
    const float* __restrict__ mask,     // [B, T]
    const float* __restrict__ w_h,      // [2, H, 4H]
    const float* __restrict__ w_hT,     // [2, 4H, H]
    const float* __restrict__ h_seq,    // [2, T, B, H]
    const float* __restrict__ c_seq,    // [2, T, B, H]
    const float* __restrict__ dout,     // [B, T, 2H]
    const float* __restrict__ dh_last,  // [B, 2H]
    const float* __restrict__ dc_last,  // [B, 2H]
    float* __restrict__ dgates,         // [B, T, 2, 4H]
    int B, int T, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* hp_s = smem;          // [R][H] h_prev
  float* cp_s = hp_s + R * H;  // [R][H] c_prev
  float* dh_s = cp_s + R * H;  // [R][H] carried dh
  float* dc_s = dh_s + R * H;  // [R][H] carried dc
  float* z_s = dc_s + R * H;   // [R][G] z, then dz in place
  const int dir = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const float* wh = w_h + (size_t)dir * H * G;
  const float* whT = w_hT + (size_t)dir * G * H;

  for (int p = threadIdx.x; p < R * H; p += blockDim.x) {
    const int r = p / H, u = p - r * H;
    const int row = row0 + r;
    dh_s[p] = row < B ? dh_last[(size_t)row * 2 * H + (size_t)dir * H + u] : 0.0f;
    dc_s[p] = row < B ? dc_last[(size_t)row * 2 * H + (size_t)dir * H + u] : 0.0f;
  }

  for (int s = T - 1; s >= 0; --s) {
    const int tt = dir ? T - 1 - s : s;
    for (int p = threadIdx.x; p < R * H; p += blockDim.x) {
      const int r = p / H, u = p - r * H;
      const int row = row0 + r;
      float hv = 0.0f, cv = 0.0f;
      if (row < B && s > 0) {
        const size_t q = (((size_t)dir * T + (s - 1)) * B + row) * H + u;
        hv = h_seq[q];
        cv = c_seq[q];
      }
      hp_s[p] = hv;
      cp_s[p] = cv;
    }
    __syncthreads();
    // z = gates + h_prev @ W_h (the forward's product, recomputed)
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = __ldg(wh + (size_t)k * G + j);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(hp_s[r * H + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        const float g =
            row < B ? gates[((size_t)row * T + tt) * 2 * G + (size_t)dir * G + j] : 0.0f;
        z_s[r * G + j] = g + acc[r];
      }
    }
    __syncthreads();
    // the gate math, dz, and the carried dc
    for (int p = threadIdx.x; p < R * H; p += blockDim.x) {
      const int r = p / H, u = p - r * H;
      const int row = row0 + r;
      float* z = z_s + r * G;
      if (row >= B) {
        z[u] = z[H + u] = z[2 * H + u] = z[3 * H + u] = 0.0f;
        continue;
      }
      const float ig = mmb::sigmoid(z[u]);
      const float fg = mmb::sigmoid(z[H + u]);
      const float gg = tanhf(z[2 * H + u]);
      const float og = mmb::sigmoid(z[3 * H + u]);
      const float c_prev = cp_s[p];
      const float c_new = fg * c_prev + ig * gg;
      const float tc = tanhf(c_new);
      const float m = mask[(size_t)row * T + tt];
      const float dh_carry = dh_s[p], dc_carry = dc_s[p];
      const float dh_new =
          m * (dout[((size_t)row * T + tt) * 2 * H + (size_t)dir * H + u] + dh_carry);
      const float d_o = dh_new * tc;
      const float dc_new = dh_new * og * (1.0f - tc * tc) + m * dc_carry;
      const float dzi = dc_new * gg * ig * (1.0f - ig);
      const float dzf = dc_new * c_prev * fg * (1.0f - fg);
      const float dzg = dc_new * ig * (1.0f - gg * gg);
      const float dzo = d_o * og * (1.0f - og);
      z[u] = dzi;
      z[H + u] = dzf;
      z[2 * H + u] = dzg;
      z[3 * H + u] = dzo;
      float* dg = dgates + ((size_t)row * T + tt) * 2 * G + (size_t)dir * G;
      dg[u] = dzi;
      dg[H + u] = dzf;
      dg[2 * H + u] = dzg;
      dg[3 * H + u] = dzo;
      dc_s[p] = fg * dc_new + (1.0f - m) * dc_carry;
      dh_s[p] = (1.0f - m) * dh_carry;
    }
    __syncthreads();
    // dh += dz @ W_hᵀ: a thread per (unit k, chunk of kRC rows)
    for (int q = threadIdx.x; q < H * (R / kRC); q += blockDim.x) {
      const int k = q % H, r0 = (q / H) * kRC;
      float acc[kRC];
#pragma unroll
      for (int r = 0; r < kRC; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < G; ++j) {
        const float w = __ldg(whT + (size_t)j * H + k);
#pragma unroll
        for (int r = 0; r < kRC; ++r) acc[r] = fmaf(z_s[(r0 + r) * G + j], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRC; ++r) dh_s[(r0 + r) * H + k] += acc[r];
    }
    __syncthreads();
  }
}

template <int R>
cudaError_t launch_bptt(const float* gates, const float* mask, const float* w_h,
                        const float* w_hT, const float* h_seq, const float* c_seq,
                        const float* dout, const float* dh_last, const float* dc_last,
                        float* dgates, int B, int T, int H, cudaStream_t stream) {
  static_assert(R % kRC == 0, "rows per block must be a multiple of kRC");
  const size_t smem = sizeof(float) * (size_t)R * 8 * H;
  if (smem > (size_t)mmb::kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(bilstm_bptt_kernel<R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + R - 1) / R, 2);
  bilstm_bptt_kernel<R><<<grid, mmb::threads_for(4 * H, 512), smem, stream>>>(
      gates, mask, w_h, w_hT, h_seq, c_seq, dout, dh_last, dc_last, dgates, B, T, H);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dW_h[dir] = Σ_{s=1..T-1} Σ_rows h_seq[dir][s-1][row]ᵀ · dz[row][tt(s)][dir]
// as a [H x N]·[N x 4H] product with n = (s-1)·B + row, so that the h rows
// are h_seq[dir] read in order. Tiles of 64 x 64 outputs, 256 threads with
// 4 x 4 outputs each, the reduction in chunks of kBN; the N axis is split
// into kSplitN-long slices whose partial sums go to a scratch buffer.
// ---------------------------------------------------------------------------

constexpr int kBK = 64, kBJ = 64, kBN = 16;

__global__ void __launch_bounds__(256) lstm_dwh_partial_kernel(
    const float* __restrict__ h_seq,   // [2, T, B, H]
    const float* __restrict__ dgates,  // [B, T, 2, 4H]
    float* __restrict__ partial,       // [S, 2, H, 4H]
    int B, int T, int H, int split_n) {
  __shared__ float a_s[kBN][kBK];
  __shared__ float b_s[kBN][kBJ];
  const int G = 4 * H;
  const int j0 = blockIdx.x * kBJ, k0 = blockIdx.y * kBK;
  const int dir = blockIdx.z & 1, split = blockIdx.z >> 1;
  const long long N = (long long)(T - 1) * B;
  const long long n_begin = (long long)split * split_n;
  const long long n_end = min(N, n_begin + split_n);
  const float* hs = h_seq + (size_t)dir * T * B * H;
  const int tid = threadIdx.x;
  const int tk = (tid / 16) * 4, tj = (tid % 16) * 4;  // this thread's 4 x 4 outputs
  float acc[4][4] = {};

  for (long long n0 = n_begin; n0 < n_end; n0 += kBN) {
    for (int e = tid; e < kBN * kBK; e += blockDim.x) {
      const int nn = e / kBK, kk = e - nn * kBK;
      const long long n = n0 + nn;
      const int k = k0 + kk;
      a_s[nn][kk] = (n < n_end && k < H) ? hs[(size_t)n * H + k] : 0.0f;
    }
    for (int e = tid; e < kBN * kBJ; e += blockDim.x) {
      const int nn = e / kBJ, jj = e - nn * kBJ;
      const long long n = n0 + nn;
      const int j = j0 + jj;
      float v = 0.0f;
      if (n < n_end && j < G) {
        const int s = (int)(n / B) + 1, row = (int)(n - (long long)(s - 1) * B);
        const int tt = dir ? T - 1 - s : s;
        v = dgates[((size_t)row * T + tt) * 2 * G + (size_t)dir * G + j];
      }
      b_s[nn][jj] = v;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < kBN; ++nn) {
      float a[4], b[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) a[x] = a_s[nn][tk + x];
#pragma unroll
      for (int y = 0; y < 4; ++y) b[y] = b_s[nn][tj + y];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
    }
    __syncthreads();
  }
  float* out = partial + ((size_t)split * 2 + dir) * H * G;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int k = k0 + tk + x;
    if (k >= H) continue;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int j = j0 + tj + y;
      if (j < G) out[(size_t)k * G + j] = acc[x][y];
    }
  }
}

// dW_h = Σ over the S slices, in slice order.
__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int S, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += partial[(size_t)s * n + e];
  out[e] = acc;
}

}  // namespace

// Length of the N slices of the dW_h product (the wrapper sizes the
// partials buffer as ceil((T-1)·B / split) slices, at least one).
MMB_API int mmb_lstm_dwh_split() { return 2048; }

MMB_API int mmb_bilstm_backward(const void* gates, const void* mask, const void* w_h,
                                const void* w_hT, const void* h_seq, const void* c_seq,
                                const void* dout, const void* dh_last, const void* dc_last,
                                void* dgates, void* dwh_partial, void* dw_h, int num_splits,
                                int B, int T, int H, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || num_splits <= 0) return (int)cudaErrorInvalidValue;
  const long long N = (long long)(T - 1) * B;
  const int split = mmb_lstm_dwh_split();
  if ((long long)num_splits * split < N) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gates);
  const auto* m = static_cast<const float*>(mask);
  const auto* w = static_cast<const float*>(w_h);
  const auto* wt = static_cast<const float*>(w_hT);
  const auto* hs = static_cast<const float*>(h_seq);
  const auto* cs = static_cast<const float*>(c_seq);
  const auto* d = static_cast<const float*>(dout);
  const auto* dh = static_cast<const float*>(dh_last);
  const auto* dc = static_cast<const float*>(dc_last);
  auto* dg = static_cast<float*>(dgates);
  cudaError_t e = B >= 1024 ? launch_bptt<16>(g, m, w, wt, hs, cs, d, dh, dc, dg, B, T, H, s)
                            : launch_bptt<4>(g, m, w, wt, hs, cs, d, dh, dc, dg, B, T, H, s);
  if (e != cudaSuccess) return (int)e;
  const int G = 4 * H;
  const dim3 grid((G + kBJ - 1) / kBJ, (H + kBK - 1) / kBK, 2 * num_splits);
  lstm_dwh_partial_kernel<<<grid, 256, 0, s>>>(hs, dg, static_cast<float*>(dwh_partial), B, T,
                                               H, split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = 2 * H * G;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(dwh_partial),
                                                      static_cast<float*>(dw_h), num_splits, n);
  return (int)cudaGetLastError();
}
