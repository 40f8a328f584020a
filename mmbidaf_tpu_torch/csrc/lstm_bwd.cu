// K6 — BiLSTM backward through time (BPTT), both directions, in three
// phases: the gate pre-activations of every step at once, the walk, and the
// dW_h reduction over the residuals.
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
// (a) lstm_z_kernel: z does not depend on the walk (h_prev comes from the
//     residuals), so z for every step s >= 1 is one tiled f32 product
//     gates + h_seq[s-1]·W_h over N = (T-1)·B rows, written into dgates in
//     place (dgates has the gates' layout, so it needs no scratch); the walk
//     reads step 0's z straight from gates. The TPU kernel forms the same
//     product inside each grid step (_lstm_bwd_kernel:279).
// (b) bilstm_bptt_cluster_kernel: the walk on a thread-block cluster
//     (csrc/lstm_cluster.cuh), which keeps W_h on chip: block c holds the
//     four gate columns of its ~H/C units. Per step it runs the gate math
//     of its units from the prefetched z, c_prev, dout and mask and its
//     carried dh/dc, writes dz over z in dgates, forms the partial
//     P_c = dz[:, its 4U columns]·W_h[:, those columns]ᵀ [R x H], pushes
//     each unit's share into the owning block's exchange buffer, passes the
//     cluster barrier, and sets dh <- (1-m)·dh + Σ_c P_c, summing the C
//     partials in rank order 0 … C-1. The next step's operands come by
//     cp.async while the step runs.
// (b') bilstm_bptt_l2_kernel, the walk for the widths with no cluster plan
//     (lstm_cluster.cuh: H past 448, 432 or 384 at 4, 8 or 16 rows a
//     cluster): one block a group of R rows (lstm_cluster.cuh::l2_rows) in
//     one direction, dh, dc and the step's dz [R x 4H] in shared memory
//     (6H floats a row). Per step its threads run the gate math of every
//     (row, unit) from z, c_prev, dout and the mask read straight from
//     device memory, write dz over z, then a warp per unit k forms
//     dh[:, k] += dz · W_h[k, :]ᵀ with its lanes along W_h's row k, four
//     columns a lane (16-byte loads from L2 every step, each serving the
//     block's R rows), and sums the lanes' partials by shuffles in a fixed
//     order.
// (c) lstm_dwh_partial_kernel + sum_partials_kernel: dW_h as a tiled
//     [H x N]·[N x 4H] product over N = (T-1)·rows (h_seq against dgates),
//     split over N into per-slice partials that a second pass sums in a
//     fixed order.
// No atomics anywhere and every sum in a fixed order: two runs give the
// same bits.
//
// What bounds it on the H100: the walk is sequential in T; per step, one
// cluster barrier and the [R x 4U]·[4U x H] product a block; for the whole
// kernel, the three products' 3·2·2·B·T·H·4H FLOPs at the 67 TFLOP/s f32
// rate. Phases (a) and (c) run at the card's width; the walk's step is one
// barrier and ~R·H·4U FMAs a block, with W_h read from device memory once
// per block instead of twice a step from L2. Phases (a) and (c) need no
// cluster plan and run the same on both routes; on the L2 route the walk's
// step is R·H·4H FMAs a block and a read of W_h (4 MB at H = 512) from L2.
#include "common.cuh"
#include "lstm_cluster.cuh"

namespace {

namespace lc = mmb::lstmc;

// Tiles of the two products over the residuals: 64 x 64 outputs, 256
// threads with 4 x 4 outputs each, the reduction in chunks of 16.
constexpr int kBK = 64, kBJ = 64, kBN = 16;

// acc[x][y] += a[x]·b[y] for one step of the reduction.
__device__ __forceinline__ void fma_4x4(const float* a_row, const float* b_row, float acc[4][4]) {
  float a[4], b[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) a[x] = a_row[x];
#pragma unroll
  for (int y = 0; y < 4; ++y) b[y] = b_row[y];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
}

// ---------------------------------------------------------------------------
// (a) z[dir][n] = gates + h_seq[dir][n]·W_h[dir] for n = (s-1)·B + row,
// s = 1 … T-1, into dgates at (row, tt(s), dir): a [N x H]·[H x 4H] product
// whose rows are h_seq[dir] read in order.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) lstm_z_kernel(
    const float* __restrict__ gates,  // [B, T, 2, 4H]
    const float* __restrict__ w_h,    // [2, H, 4H]
    const float* __restrict__ h_seq,  // [2, T, B, H]
    float* __restrict__ dgates,       // [B, T, 2, 4H]: z out
    int B, int T, int H) {
  __shared__ float a_s[kBN][kBK + 1];  // [k][n], padded: the loads run along k
  __shared__ float b_s[kBN][kBJ];      // [k][j]
  const int G = 4 * H;
  const int j0 = blockIdx.x * kBJ, dir = blockIdx.z;
  const int n0 = blockIdx.y * kBK, N = (T - 1) * B;  // N < 65536·kBK (the entry point checks)
  const float* hs = h_seq + (size_t)dir * T * B * H;
  const float* wh = w_h + (size_t)dir * H * G;
  const int tid = threadIdx.x;
  const int tn = (tid / 16) * 4, tj = (tid % 16) * 4;  // this thread's 4 x 4 outputs
  float acc[4][4] = {};

  for (int k0 = 0; k0 < H; k0 += kBN) {
    for (int e = tid; e < kBN * kBK; e += blockDim.x) {
      const int nn = e / kBN, kk = e - nn * kBN;
      const int n = n0 + nn, k = k0 + kk;
      a_s[kk][nn] = (n < N && k < H) ? hs[(size_t)n * H + k] : 0.0f;
    }
    for (int e = tid; e < kBN * kBJ; e += blockDim.x) {
      const int kk = e / kBJ, jj = e - kk * kBJ;
      const int k = k0 + kk, j = j0 + jj;
      b_s[kk][jj] = (k < H && j < G) ? wh[(size_t)k * G + j] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBN; ++kk) fma_4x4(&a_s[kk][tn], &b_s[kk][tj], acc);
    __syncthreads();
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int n = n0 + tn + x;
    if (n >= N) continue;
    const int s = n / B + 1, row = n - (s - 1) * B;
    const int tt = dir ? T - 1 - s : s;
    const size_t base = ((size_t)row * T + tt) * 2 * G + (size_t)dir * G;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int j = j0 + tj + y;
      if (j < G) dgates[base + j] = gates[base + j] + acc[x][y];
    }
  }
}

// ---------------------------------------------------------------------------
// (b) The walk on a cluster.
// ---------------------------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(lc::kThreads) bilstm_bptt_cluster_kernel(
    const float* __restrict__ gates,    // [B, T, 2, 4H]: step 0's z
    const float* __restrict__ mask,     // [B, T]
    const float* __restrict__ w_h,      // [2, H, 4H]
    const float* __restrict__ c_seq,    // [2, T, B, H]
    const float* __restrict__ dout,     // [B, T, 2H]
    const float* __restrict__ dh_last,  // [B, 2H]
    const float* __restrict__ dc_last,  // [B, 2H]
    float* __restrict__ dgates,         // [B, T, 2, 4H]: z of steps >= 1 in, dz out
    int B, int T, int H) {
  static_assert(R % lc::kRC == 0, "rows a cluster must be a multiple of kRC");
  lc::cg::cluster_group cluster = lc::cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int C = gridDim.x, c = blockIdx.x;
  const int U = lc::units_max(H, C), G4 = 4 * U, ldw = G4 + 1, G = 4 * H;
  const int u0 = lc::unit_begin(c, H, C), nu = lc::unit_begin(c + 1, H, C) - u0;
  const int row0 = blockIdx.y * R, dir = blockIdx.z;
  float* dz_s = smem;                                   // [4U][R] this step's dz
  float* w_s = dz_s + lc::round4(G4 * R);               // [H][4U+1]
  float* x_b = w_s + lc::round4((size_t)H * ldw);       // [2][C][U][R] partials, by parity
  float* dh_s = x_b + lc::round4(2 * (size_t)C * U * R);  // [R][U] carried dh
  float* dc_s = dh_s + lc::round4(R * U);               // [R][U] carried dc
  float* z_st = dc_s + lc::round4(R * U);               // [2][R][4U] z stage
  float* cp_st = z_st + lc::round4(2 * R * G4);         // [2][R][U] c_prev stage
  float* do_st = cp_st + lc::round4(2 * R * U);         // [2][R][U] dout stage
  float* m_st = do_st + lc::round4(2 * R * U);          // [2][R] mask stage

  // z, c_prev, dout and the mask of step s into stage s & 1.
  auto prefetch = [&](int s) {
    const int tt = dir ? T - 1 - s : s, st = s & 1;
    const float* zsrc = s > 0 ? dgates : gates;
    for (int e = threadIdx.x; e < R * G4 + 2 * R * U + R; e += blockDim.x) {
      if (e < R * G4) {
        const int r = e / G4, jl = e - r * G4, g = jl / U, ul = jl - g * U, row = row0 + r;
        const bool ok = row < B && ul < nu;
        lc::cp_async4(z_st + st * R * G4 + e,
                      ok ? zsrc + ((size_t)row * T + tt) * 2 * G + (size_t)dir * G + g * H + u0 + ul
                         : gates,
                      ok);
      } else if (e < R * G4 + 2 * R * U) {
        const int f = e - R * G4, which = f / (R * U), ru = f - which * R * U;
        const int r = ru / U, ul = ru - r * U, row = row0 + r;
        if (which == 0) {
          const bool ok = row < B && ul < nu && s > 0;
          lc::cp_async4(cp_st + st * R * U + ru,
                        ok ? c_seq + (((size_t)dir * T + (s - 1)) * B + row) * H + u0 + ul : c_seq,
                        ok);
        } else {
          const bool ok = row < B && ul < nu;
          lc::cp_async4(do_st + st * R * U + ru,
                        ok ? dout + ((size_t)row * T + tt) * 2 * H + (size_t)dir * H + u0 + ul : dout,
                        ok);
        }
      } else {
        const int r = e - R * G4 - 2 * R * U, row = row0 + r;
        lc::cp_async4(m_st + st * R + r, row < B ? mask + (size_t)row * T + tt : mask, row < B);
      }
    }
  };

  lc::load_w_slice(w_s, w_h + (size_t)dir * H * G, H, U, u0, nu);
  for (int e = threadIdx.x; e < G4 * R; e += blockDim.x) dz_s[e] = 0.0f;  // past nu: stays 0
  for (int p = threadIdx.x; p < R * U; p += blockDim.x) {
    const int r = p / U, ul = p - r * U, row = row0 + r;
    const bool ok = row < B && ul < nu;
    const size_t q = (size_t)row * 2 * H + (size_t)dir * H + u0 + ul;
    dh_s[p] = ok ? dh_last[q] : 0.0f;
    dc_s[p] = ok ? dc_last[q] : 0.0f;
  }
  prefetch(T - 1);
  lc::cp_async_wait_all();
  cluster.sync();  // every block of the cluster has started and is initialised

  for (int s = T - 1; s >= 0; --s) {
    const int par = s & 1, tt = dir ? T - 1 - s : s;
    if (s > 0) prefetch(s - 1);
    const float* zs = z_st + par * R * G4;
    // the gate math of this block's units, dz, and the carried dc
    for (int p = threadIdx.x; p < R * nu; p += blockDim.x) {
      const int r = p / nu, ul = p - r * nu, row = row0 + r;
      const float* z = zs + r * G4;
      const float ig = mmb::sigmoid(z[ul]);
      const float fg = mmb::sigmoid(z[U + ul]);
      const float gg = tanhf(z[2 * U + ul]);
      const float og = mmb::sigmoid(z[3 * U + ul]);
      const float c_prev = cp_st[par * R * U + r * U + ul];
      const float c_new = fg * c_prev + ig * gg;
      const float tc = tanhf(c_new);
      const float m = m_st[par * R + r];
      const float dh_carry = dh_s[r * U + ul], dc_carry = dc_s[r * U + ul];
      const float dh_new = m * (do_st[par * R * U + r * U + ul] + dh_carry);
      const float d_o = dh_new * tc;
      const float dc_new = dh_new * og * (1.0f - tc * tc) + m * dc_carry;
      const float dz[4] = {dc_new * gg * ig * (1.0f - ig), dc_new * c_prev * fg * (1.0f - fg),
                           dc_new * ig * (1.0f - gg * gg), d_o * og * (1.0f - og)};
#pragma unroll
      for (int g = 0; g < 4; ++g) dz_s[(g * U + ul) * R + r] = dz[g];
      if (row < B) {
        float* dg = dgates + ((size_t)row * T + tt) * 2 * G + (size_t)dir * G + u0 + ul;
#pragma unroll
        for (int g = 0; g < 4; ++g) dg[g * H] = dz[g];
      }
      dc_s[r * U + ul] = fg * dc_new + (1.0f - m) * dc_carry;
      dh_s[r * U + ul] = (1.0f - m) * dh_carry;
    }
    __syncthreads();
    // P_c = dz[:, this block's columns]·W_h[:, those columns]ᵀ, each unit's
    // share pushed to the block that owns the unit.
    float* xb = x_b + par * C * U * R;
    for (int q = threadIdx.x; q < H * (R / lc::kRC); q += blockDim.x) {
      const int k = q % H, r0 = (q / H) * lc::kRC;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int jl = 0; jl < G4; ++jl) {
        const float w = w_s[k * ldw + jl];
        const float4 d = *reinterpret_cast<const float4*>(dz_s + jl * R + r0);
        acc.x = fmaf(d.x, w, acc.x);
        acc.y = fmaf(d.y, w, acc.y);
        acc.z = fmaf(d.z, w, acc.z);
        acc.w = fmaf(d.w, w, acc.w);
      }
      const int o = lc::owner_of(k, H, C);
      float* dst = cluster.map_shared_rank(xb, o);
      *reinterpret_cast<float4*>(dst + ((size_t)c * U + (k - lc::unit_begin(o, H, C))) * R + r0) =
          acc;
    }
    lc::cp_async_wait_all();
    cluster.sync();
    // dh <- (1-m)·dh + Σ_c P_c, the partials in rank order
    for (int p = threadIdx.x; p < R * nu; p += blockDim.x) {
      const int r = p / nu, ul = p - r * nu;
      float acc = 0.0f;
      for (int cc = 0; cc < C; ++cc) acc += xb[((size_t)cc * U + ul) * R + r];
      dh_s[r * U + ul] += acc;
    }
  }
}

// ---------------------------------------------------------------------------
// (b') The walk by L2, for the widths with no cluster plan.
// ---------------------------------------------------------------------------

constexpr int kL2Threads = 512;

template <int R>
__global__ void __launch_bounds__(kL2Threads) bilstm_bptt_l2_kernel(
    const float* __restrict__ gates,    // [B, T, 2, 4H]: step 0's z
    const float* __restrict__ mask,     // [B, T]
    const float* __restrict__ w_h,      // [2, H, 4H]
    const float* __restrict__ c_seq,    // [2, T, B, H]
    const float* __restrict__ dout,     // [B, T, 2H]
    const float* __restrict__ dh_last,  // [B, 2H]
    const float* __restrict__ dc_last,  // [B, 2H]
    float* __restrict__ dgates,         // [B, T, 2, 4H]: z of steps >= 1 in, dz out
    int B, int T, int H) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  float* dz_s = smem;          // [R][4H] this step's dz (zero in rows past B), 16-byte rows
  float* dh_s = dz_s + R * G;  // [R][H] carried dh
  float* dc_s = dh_s + R * H;  // [R][H] carried dc
  const int dir = blockIdx.y, row0 = blockIdx.x * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const float* wh = w_h + (size_t)dir * H * G;

  for (int p = threadIdx.x; p < R * H; p += blockDim.x) {
    const int r = p / H, u = p - r * H, row = row0 + r;
    const size_t q = (size_t)row * 2 * H + (size_t)dir * H + u;
    dh_s[p] = row < B ? dh_last[q] : 0.0f;
    dc_s[p] = row < B ? dc_last[q] : 0.0f;
  }
  for (int e = threadIdx.x; e < R * G; e += blockDim.x) dz_s[e] = 0.0f;
  __syncthreads();

  for (int s = T - 1; s >= 0; --s) {
    const int tt = dir ? T - 1 - s : s;
    const float* zsrc = s > 0 ? dgates : gates;
    // the gate math of every (row, unit), dz, and the carried dc
    for (int p = threadIdx.x; p < R * H; p += blockDim.x) {
      const int r = p / H, u = p - r * H, row = row0 + r;
      if (row >= B) continue;
      const size_t zq = ((size_t)row * T + tt) * 2 * G + (size_t)dir * G + u;
      const float* z = zsrc + zq;
      const float ig = mmb::sigmoid(z[0]);
      const float fg = mmb::sigmoid(z[H]);
      const float gg = tanhf(z[2 * H]);
      const float og = mmb::sigmoid(z[3 * H]);
      const float c_prev = s > 0 ? c_seq[(((size_t)dir * T + (s - 1)) * B + row) * H + u] : 0.0f;
      const float c_new = fg * c_prev + ig * gg;
      const float tc = tanhf(c_new);
      const float m = mask[(size_t)row * T + tt];
      const float dh_carry = dh_s[p], dc_carry = dc_s[p];
      const float dh_new = m * (dout[((size_t)row * T + tt) * 2 * H + (size_t)dir * H + u] + dh_carry);
      const float d_o = dh_new * tc;
      const float dc_new = dh_new * og * (1.0f - tc * tc) + m * dc_carry;
      const float dz[4] = {dc_new * gg * ig * (1.0f - ig), dc_new * c_prev * fg * (1.0f - fg),
                           dc_new * ig * (1.0f - gg * gg), d_o * og * (1.0f - og)};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dz_s[r * G + g * H + u] = dz[g];
        dgates[zq + (size_t)g * H] = dz[g];
      }
      dc_s[p] = fg * dc_new + (1.0f - m) * dc_carry;
      dh_s[p] = (1.0f - m) * dh_carry;
    }
    __syncthreads();
    // dh[:, k] += dz · W_h[k, :]ᵀ: a warp a unit, its lanes along the row
    // four columns at a time (16-byte loads of W_h and dz; several in
    // flight: the step waits on L2's latency)
    for (int k = warp; k < H; k += warps) {
      const float4* wk = reinterpret_cast<const float4*>(wh + (size_t)k * G);
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 8
      for (int q = lane; q < H; q += 32) {  // G / 4 = H column quads
        const float4 w = __ldg(wk + q);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 d = *reinterpret_cast<const float4*>(dz_s + r * G + 4 * q);
          acc[r] = fmaf(d.x, w.x, fmaf(d.y, w.y, fmaf(d.z, w.z, fmaf(d.w, w.w, acc[r]))));
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = mmb::warp_sum(acc[r]);
        if (lane == 0) dh_s[r * H + k] += v;
      }
    }
    __syncthreads();
  }
}

// f(the L2 walk instantiated for R rows a block).
template <typename F>
auto with_bptt_l2_kernel(int R, F f) {
  return R == 16  ? f(bilstm_bptt_l2_kernel<16>)
         : R == 8 ? f(bilstm_bptt_l2_kernel<8>)
         : R == 4 ? f(bilstm_bptt_l2_kernel<4>)
         : R == 2 ? f(bilstm_bptt_l2_kernel<2>)
                  : f(bilstm_bptt_l2_kernel<1>);
}

// f(the walk instantiated for a plan's R).
template <typename F>
auto with_bptt_kernel(int R, F f) {
  return R == 16 ? f(bilstm_bptt_cluster_kernel<16>)
                 : R == 8 ? f(bilstm_bptt_cluster_kernel<8>) : f(bilstm_bptt_cluster_kernel<4>);
}

// ---------------------------------------------------------------------------
// (c) dW_h[dir] = Σ_{s=1..T-1} Σ_rows h_seq[dir][s-1][row]ᵀ · dz[row][tt(s)][dir]
// as a [H x N]·[N x 4H] product with n = (s-1)·B + row, so that the h rows
// are h_seq[dir] read in order. The N axis is split into split_n-long
// slices whose partial sums go to a scratch buffer: short slices give the
// card enough blocks to hide each chunk's load latency (the loop has no
// second stage).
// ---------------------------------------------------------------------------

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
  const int N = (T - 1) * B;  // N < 65536·kBK (the entry point checks)
  const int n_begin = split * split_n, n_end = min(N, n_begin + split_n);
  const float* hs = h_seq + (size_t)dir * T * B * H;
  const int tid = threadIdx.x;
  const int tk = (tid / 16) * 4, tj = (tid % 16) * 4;  // this thread's 4 x 4 outputs
  float acc[4][4] = {};

  for (int n0 = n_begin; n0 < n_end; n0 += kBN) {
    for (int e = tid; e < kBN * kBK; e += blockDim.x) {
      const int nn = e / kBK, kk = e - nn * kBK;
      const int n = n0 + nn, k = k0 + kk;
      a_s[nn][kk] = (n < n_end && k < H) ? hs[(size_t)n * H + k] : 0.0f;
    }
    for (int e = tid; e < kBN * kBJ; e += blockDim.x) {
      const int nn = e / kBJ, jj = e - nn * kBJ;
      const int n = n0 + nn, j = j0 + jj;
      float v = 0.0f;
      if (n < n_end && j < G) {
        const int s = n / B + 1, row = n - (s - 1) * B;
        const int tt = dir ? T - 1 - s : s;
        v = dgates[((size_t)row * T + tt) * 2 * G + (size_t)dir * G + j];
      }
      b_s[nn][jj] = v;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < kBN; ++nn) fma_4x4(&a_s[nn][tk], &b_s[nn][tj], acc);
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

// Length of the N slices of the dW_h product over N = (T-1)·B: 512, or
// longer where that would give more than 256 slices (the wrapper sizes the
// partials buffer as ceil(N / split) slices, at least one).
MMB_API int mmb_lstm_dwh_split(int B, int T) {
  const long long N = (long long)(T - 1) * B, per = ((N + 255) / 256 + kBN - 1) / kBN * kBN;
  return per > 512 ? (int)per : 512;
}

// K6: (a), the walk on a cluster where the shape has a plan (else by the
// L2 route), then (c).
MMB_API int mmb_bilstm_backward(const void* gates, const void* mask, const void* w_h,
                                const void* h_seq, const void* c_seq, const void* dout,
                                const void* dh_last, const void* dc_last, void* dgates,
                                void* dwh_partial, void* dw_h, int num_splits, int B, int T,
                                int H, void* stream) {
  lc::Plan p;
  const bool cluster = lc::plan(B, H, &p);
  const int R = cluster ? 0 : lc::l2_rows(B, H);
  if (T <= 0 || num_splits <= 0 || (!cluster && R == 0)) return (int)cudaErrorInvalidValue;
  const long long N = (long long)(T - 1) * B;
  const int split = mmb_lstm_dwh_split(B, T);
  if ((long long)num_splits * split < N || (N + kBK - 1) / kBK > 65535)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gates);
  const auto* w = static_cast<const float*>(w_h);
  const auto* hs = static_cast<const float*>(h_seq);
  auto* dg = static_cast<float*>(dgates);
  const int G = 4 * H;
  cudaError_t e;
  if (N > 0) {  // (a) z of steps 1 … T-1 into dgates
    lstm_z_kernel<<<dim3((G + kBJ - 1) / kBJ, (unsigned)((N + kBK - 1) / kBK), 2), 256, 0, s>>>(
        g, w, hs, dg, B, T, H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const auto* m = static_cast<const float*>(mask);
  const auto* cs = static_cast<const float*>(c_seq);
  const auto* dout_ = static_cast<const float*>(dout);
  const auto* dhl = static_cast<const float*>(dh_last);
  const auto* dcl = static_cast<const float*>(dc_last);
  if (cluster) {  // (b) the walk on a cluster
    e = with_bptt_kernel(p.R, [&](auto kernel) {
      return lc::launch(kernel, p, p.smem_bwd, s, g, m, w, cs, dout_, dhl, dcl, dg, B, T, H);
    });
  } else {  // (b') the walk by L2
    const size_t smem = lc::l2_smem(H, R);
    e = with_bptt_l2_kernel(R, [&](auto kernel) {
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kernel<<<dim3((B + R - 1) / R, 2), kL2Threads, smem, s>>>(g, m, w, cs, dout_, dhl, dcl, dg,
                                                                  B, T, H);
      return cudaGetLastError();
    });
  }
  if (e != cudaSuccess) return (int)e;
  // (c) dW_h
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

// How many of the walk's clusters the card holds at once for this shape
// (0: the launch cannot run); a negative cudaError_t on failure.
MMB_API int mmb_bilstm_backward_occupancy(int B, int H) {
  lc::Plan p;
  if (!lc::plan(B, H, &p)) return -(int)cudaErrorInvalidValue;
  return with_bptt_kernel(p.R, [&](auto kernel) {
    return lc::max_active_clusters(kernel, p, p.smem_bwd);
  });
}

// How many blocks of the L2 walk an SM holds for this shape (0: the launch
// cannot run); a negative cudaError_t on failure.
MMB_API int mmb_bilstm_backward_l2_occupancy(int B, int H) {
  const int R = lc::l2_rows(B, H);
  if (R == 0) return -(int)cudaErrorInvalidValue;
  const size_t smem = lc::l2_smem(H, R);
  return with_bptt_l2_kernel(R, [&](auto kernel) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int n = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kL2Threads, smem);
    return e == cudaSuccess ? n : -(int)e;
  });
}
