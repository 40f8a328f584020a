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
// (b'') bilstm_bptt_cluster_kernel_grid, the walk at few rows past the
//     cluster plan (lstm_cluster.cuh::grid_plan: at most 64 rows, W_h's
//     slice of 12 units a block or fewer), where the L2 walk would run on
//     16 blocks of the card's 132 SMs, each reading all of W_h (4 MB at
//     H = 512) from L2 every step. Here W_h is resident across the card:
//     per direction P blocks (64, or the most the card holds at once: 56 on
//     an H100 whose 132 SMs hold 15 clusters of 8), one an SM, each keeping
//     the four gate columns of its H/P units for every row in registers,
//     two rows k of W_h a thread. Per step a block runs its units' gate math,
//     forms its partial dz·W_h[:, its columns]ᵀ [rows x H] (8 rows x 2
//     outputs a thread at a time), pushes each output into the buffer of the
//     cluster rank that owns it, passes the cluster barrier, sums its chunk
//     over the 8 ranks in rank order and stores it to an exchange in device
//     memory as 8-byte words that carry the step's number beside the sum;
//     every block then reads its units' words of every cluster, again until
//     they carry the step, and adds them in cluster order. The exchange is
//     double-buffered by the step's parity: a block writes a buffer again
//     only after reading the next step's words of every cluster, which each
//     cluster writes only after all its blocks have read this step's.
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
// cluster plan and run the same on every route; on the L2 route the walk's
// step is R·H·4H FMAs a block and a read of W_h (4 MB at H = 512) from L2;
// on the grid walk it is rows·H·4H/P FMAs a block, a cluster barrier and
// one round trip through L2.
#include <array>
#include <map>
#include <mutex>

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

// ---------------------------------------------------------------------------
// (b'') The walk with W_h resident across the card.
// ---------------------------------------------------------------------------

// The cluster barrier in two halves: arrive (releasing this thread's writes
// to the cluster) and wait (acquiring everyone's), so that work can run
// between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The exchange's words: a partial sum in the low 32 bits, the step that
// wrote it in the high 32, stored and read whole (an aligned 8-byte access
// is single-copy atomic) at the card's scope, so a reader that sees the
// step sees the sum: no flag, fence or barrier between the grid's blocks.
__device__ __forceinline__ void word_store(unsigned long long* p, float v, int step) {
  const unsigned long long w =
      (unsigned long long)(unsigned)step << 32 | (unsigned long long)__float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ unsigned long long word_load(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
  return w;
}

template <int UT>
__global__ void __launch_bounds__(32 * UT, 1) bilstm_bptt_cluster_kernel_grid(
    const float* __restrict__ gates,    // [B, T, 2, 4H]: step 0's z
    const float* __restrict__ mask,     // [B, T]
    const float* __restrict__ w_h,      // [2, H, 4H]
    const float* __restrict__ c_seq,    // [2, T, B, H]
    const float* __restrict__ dout,     // [B, T, 2H]
    const float* __restrict__ dh_last,  // [B, 2H]
    const float* __restrict__ dc_last,  // [B, 2H]
    float* __restrict__ dgates,         // [B, T, 2, 4H]: z of steps >= 1 in, dz out
    unsigned long long* __restrict__ xg,  // [2 parities][2][NQ][H][Rp]: the clusters' partials, zeroed
    int B, int T, int H) {
  constexpr int G4 = 4 * UT, RG = lc::kGridRowGroup, CS = lc::kGridCluster;
  constexpr int NQM = lc::kGridBlocks / lc::kGridCluster, EPT = lc::kGridPairs;
  lc::cg::cluster_group cluster = lc::cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int NQ = gridDim.y, P = CS * NQ;
  const int rank = blockIdx.x, q = blockIdx.y, dir = blockIdx.z, b = q * CS + rank;
  const int G = 4 * H, Rp = (B + RG - 1) / RG * RG, KC = lc::units_max(H, CS);
  const int ub = lc::unit_begin(b, H, P), nu = lc::unit_begin(b + 1, H, P) - ub;
  const int kb = lc::unit_begin(rank, H, CS), nk = lc::unit_begin(rank + 1, H, CS) - kb;
  float* dz_s = smem;                              // [4UT][Rp] this step's dz
  float* xbuf = dz_s + G4 * Rp;                    // [CS][KC][Rp] partials received
  float* dh_s = xbuf + (size_t)CS * KC * Rp;       // [UT][Rp] carried dh
  float* dc_s = dh_s + UT * Rp;                    // [UT][Rp] carried dc
  float* z_st = dc_s + UT * Rp;                    // [2][4UT][Rp] z stage
  float* cp_st = z_st + 2 * G4 * Rp;               // [2][UT][Rp] c_prev stage
  float* do_st = cp_st + 2 * UT * Rp;              // [2][UT][Rp] dout stage
  float* m_st = do_st + 2 * UT * Rp;               // [2][Rp] mask stage
  const int nz = G4 * Rp, nc = UT * Rp;

  // z, c_prev, dout and the mask of step s into stage s & 1.
  auto prefetch = [&](int s) {
    const int tt = dir ? T - 1 - s : s, st = s & 1;
    const float* zsrc = s > 0 ? dgates : gates;
    for (int e = threadIdx.x; e < nz + 2 * nc + Rp; e += blockDim.x) {
      if (e < nz) {
        const int jl = e / Rp, r = e - jl * Rp, g = jl / UT, ul = jl - g * UT;
        const bool ok = r < B && ul < nu;
        lc::cp_async4(z_st + st * nz + e,
                      ok ? zsrc + ((size_t)r * T + tt) * 2 * G + (size_t)dir * G + g * H + ub + ul
                         : gates,
                      ok);
      } else if (e < nz + 2 * nc) {
        const int f = e - nz, which = f / nc, ur = f - which * nc;
        const int ul = ur / Rp, r = ur - ul * Rp;
        if (which == 0) {
          const bool ok = r < B && ul < nu && s > 0;
          lc::cp_async4(cp_st + st * nc + ur,
                        ok ? c_seq + (((size_t)dir * T + (s - 1)) * B + r) * H + ub + ul : c_seq,
                        ok);
        } else {
          const bool ok = r < B && ul < nu;
          lc::cp_async4(do_st + st * nc + ur,
                        ok ? dout + ((size_t)r * T + tt) * 2 * H + (size_t)dir * H + ub + ul : dout,
                        ok);
        }
      } else {
        const int r = e - nz - 2 * nc;
        lc::cp_async4(m_st + st * Rp + r, r < B ? mask + (size_t)r * T + tt : mask, r < B);
      }
    }
  };

  // This thread's rows k0, k0+1 of W_h over the block's gate columns (zero
  // past the slice's units and past H), and where their partials go: the
  // rank of the cluster that owns each output k.
  const int k0 = 2 * threadIdx.x;
  float w[2][G4];
  float* dst[2] = {nullptr, nullptr};
  {
    const float* wh = w_h + (size_t)dir * H * G;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int k = k0 + kk;
#pragma unroll
      for (int jl = 0; jl < G4; ++jl) {
        const int g = jl / UT, ul = jl % UT;
        w[kk][jl] = k < H && ul < nu ? wh[(size_t)k * G + (size_t)g * H + ub + ul] : 0.0f;
      }
      if (k < H) {
        const int o = lc::owner_of(k, H, CS);
        dst[kk] = cluster.map_shared_rank(xbuf, o) +
                  ((size_t)rank * KC + (k - lc::unit_begin(o, H, CS))) * Rp;
      }
    }
  }
  for (int e = threadIdx.x; e < nz; e += blockDim.x) dz_s[e] = 0.0f;  // past B and nu: stays 0
  for (int e = threadIdx.x; e < nc; e += blockDim.x) {
    const int ul = e / Rp, r = e - ul * Rp;
    const bool ok = r < B && ul < nu;
    const size_t qd = (size_t)r * 2 * H + (size_t)dir * H + ub + ul;
    dh_s[e] = ok ? dh_last[qd] : 0.0f;
    dc_s[e] = ok ? dc_last[qd] : 0.0f;
  }
  prefetch(T - 1);
  lc::cp_async_wait_all();
  cluster_arrive();  // every block of the cluster has started and is initialised
  cluster_wait();

  const int npairs = nu * Rp;  // this block's (unit, row) pairs, EPT at most a thread
  for (int s = T - 1; s >= 0; --s) {
    const int st = s & 1, tt = dir ? T - 1 - s : s;
    // the clusters' partials of step s+1 for this thread's pairs, summed in
    // cluster order: every word loaded at once, each read again until it
    // holds step s+1
    float part[EPT] = {};
    if (s < T - 1) {
      const unsigned long long* xs = xg + (((size_t)((s + 1) & 1) * 2 + dir) * NQ * H + ub) * Rp;
      unsigned long long v[EPT][NQM];
#pragma unroll
      for (int i = 0; i < EPT; ++i)
#pragma unroll
        for (int qq = 0; qq < NQM; ++qq) {
          const int e = threadIdx.x + i * blockDim.x;
          if (e < npairs && qq < NQ) v[i][qq] = word_load(xs + (size_t)qq * H * Rp + e);
        }
      const long long t0 = clock64();
#pragma unroll
      for (int i = 0; i < EPT; ++i)
#pragma unroll
        for (int qq = 0; qq < NQM; ++qq) {
          const int e = threadIdx.x + i * blockDim.x;
          if (e >= npairs || qq >= NQ) continue;
          while ((unsigned)(v[i][qq] >> 32) != (unsigned)(s + 1)) {
            if (clock64() - t0 > (1ll << 36)) __trap();  // ~30 s: a block never ran; fail, not hang
            v[i][qq] = word_load(xs + (size_t)qq * H * Rp + e);
          }
          part[i] += __uint_as_float((unsigned)v[i][qq]);
        }
    }
    // the gate math of this block's units: dz, and the carried dh and dc
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = threadIdx.x + i * blockDim.x, ul = e / Rp, r = e - ul * Rp;
      if (e >= npairs || r >= B) continue;
      const float dh_carry = dh_s[e] + part[i];
      const float* z = z_st + st * nz + ul * Rp + r;
      const float ig = mmb::sigmoid(z[0]);
      const float fg = mmb::sigmoid(z[UT * Rp]);
      const float gg = tanhf(z[2 * UT * Rp]);
      const float og = mmb::sigmoid(z[3 * UT * Rp]);
      const float c_prev = cp_st[st * nc + e];
      const float c_new = fg * c_prev + ig * gg;
      const float tc = tanhf(c_new);
      const float m = m_st[st * Rp + r];
      const float dc_carry = dc_s[e];
      const float dh_new = m * (do_st[st * nc + e] + dh_carry);
      const float d_o = dh_new * tc;
      const float dc_new = dh_new * og * (1.0f - tc * tc) + m * dc_carry;
      const float dz[4] = {dc_new * gg * ig * (1.0f - ig), dc_new * c_prev * fg * (1.0f - fg),
                           dc_new * ig * (1.0f - gg * gg), d_o * og * (1.0f - og)};
      float* dg = dgates + ((size_t)r * T + tt) * 2 * G + (size_t)dir * G + ub + ul;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dz_s[g * UT * Rp + e] = dz[g];
        dg[(size_t)g * H] = dz[g];
      }
      dc_s[e] = fg * dc_new + (1.0f - m) * dc_carry;
      dh_s[e] = (1.0f - m) * dh_carry;
    }
    __syncthreads();
    if (s == 0) break;  // the state before step 0 is no output
    prefetch(s - 1);
    if (s < T - 1) cluster_wait();  // the cluster has summed what it received at step s+1
    // this block's partial dz·W_hᵀ, 8 rows x 2 outputs k a thread at a time,
    // pushed into the owning rank's buffer
    for (int rg = 0; rg < Rp; rg += RG) {
      float acc[2][RG];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < RG; ++i) acc[kk][i] = 0.0f;
#pragma unroll
      for (int jl = 0; jl < G4; ++jl) {
        const float4 d0 = *reinterpret_cast<const float4*>(dz_s + jl * Rp + rg);
        const float4 d1 = *reinterpret_cast<const float4*>(dz_s + jl * Rp + rg + 4);
        const float d[RG] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int i = 0; i < RG; ++i) acc[kk][i] = fmaf(d[i], w[kk][jl], acc[kk][i]);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        if (dst[kk]) {
          float4* out = reinterpret_cast<float4*>(dst[kk] + rg);
          out[0] = make_float4(acc[kk][0], acc[kk][1], acc[kk][2], acc[kk][3]);
          out[1] = make_float4(acc[kk][4], acc[kk][5], acc[kk][6], acc[kk][7]);
        }
    }
    lc::cp_async_wait_all();
    cluster_arrive();  // every rank's partials are in place
    cluster_wait();
    // this rank's chunk of the cluster's partial, summed over the ranks in
    // rank order, out to the exchange with this step's number
    unsigned long long* xo = xg + (((size_t)st * 2 + dir) * NQ * H + (size_t)q * H + kb) * Rp;
    for (int e = threadIdx.x; e < nk * Rp; e += blockDim.x) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < CS; ++c) acc += xbuf[(size_t)c * KC * Rp + e];
      word_store(xo + e, acc, s);
    }
    cluster_arrive();  // this block is done with its buffer
  }
  if (T > 1) cluster_wait();  // pairs the last arrive: no peer reads this block's memory now
}

// f(the grid walk instantiated for UT units a block).
template <typename F>
auto with_bptt_grid_kernel(int UT, F f) {
  return UT == 8    ? f(bilstm_bptt_cluster_kernel_grid<8>)
         : UT == 10 ? f(bilstm_bptt_cluster_kernel_grid<10>)
                    : f(bilstm_bptt_cluster_kernel_grid<12>);
}

// The grid walk's launch: grid (CS, NQ, 2 directions), clusters of CS along x.
template <typename Kernel>
cudaError_t configure_grid(Kernel kernel, const lc::GridPlan& g, cudaStream_t stream,
                           lc::LaunchConfig* lc_) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return e;
  lc_->cfg = cudaLaunchConfig_t{};
  lc_->cfg.gridDim = dim3(g.CS, g.NQ, 2);
  lc_->cfg.blockDim = dim3(g.threads);
  lc_->cfg.dynamicSmemBytes = g.smem;
  lc_->cfg.stream = stream;
  lc_->attr[0].id = cudaLaunchAttributeClusterDimension;
  lc_->attr[0].val.clusterDim.x = g.CS;
  lc_->attr[0].val.clusterDim.y = 1;
  lc_->attr[0].val.clusterDim.z = 1;
  lc_->cfg.attrs = lc_->attr;
  lc_->cfg.numAttrs = 1;
  return cudaSuccess;
}

// How many of plan g's clusters the card holds at once; a negative
// cudaError_t on failure (its error is cleared).
int grid_occupancy(const lc::GridPlan& g) {
  return with_bptt_grid_kernel(g.UT, [&](auto kernel) {
    lc::LaunchConfig lc_;
    cudaError_t e = configure_grid(kernel, g, nullptr, &lc_);
    int n = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, &lc_.cfg);
    if (e != cudaSuccess) cudaGetLastError();
    return e == cudaSuccess ? n : -(int)e;
  });
}

// The grid walk's plan on this card: the shape's plan at the most clusters
// a direction (kGridBlocks / kGridCluster down to 4) whose 2·NQ clusters
// the card holds at once, since the walk's blocks wait on each other's
// words and none may wait for a free SM; false where none holds. Kept per
// shape: the answer is the card's.
bool grid_plan_on_card(int B, int H, lc::GridPlan* g) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> known;  // (B, H) -> P, 0: none
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find({B, H});
  if (it == known.end()) {
    int P = 0;
    for (int nq = lc::kGridBlocks / lc::kGridCluster; nq >= 4 && !P; --nq) {
      lc::GridPlan cand;
      if (lc::grid_plan(B, H, nq * lc::kGridCluster, &cand) &&
          grid_occupancy(cand) >= 2 * nq)
        P = nq * lc::kGridCluster;
    }
    it = known.emplace(std::make_pair(B, H), P).first;
  }
  return it->second > 0 && lc::grid_plan(B, H, it->second, g);
}

// The route the walk takes for B rows of width H on this card: the shape's
// (lc::bptt_route), but the L2 walk where the card holds no grid plan's
// blocks at once. *g gets the grid plan where it is taken.
int bptt_route_on_card(int B, int H, lc::GridPlan* g) {
  const int route = lc::bptt_route(B, H);
  if (route != lc::kRouteGrid) return route;
  return grid_plan_on_card(B, H, g) ? lc::kRouteGrid : lc::kRouteL2;
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

// K6: (a), the walk, then (c). The walk takes `route` (lc::BpttRoute), or
// with kRouteNone the route bptt_route_on_card names: on a cluster where
// the shape has a plan, across the card at few rows, else by L2. The grid
// walk's exchange lives in dwh_partial, which (c) fills only after the walk:
// it holds num_splits·2·H·4H floats, and on the grid route at least the
// shape's grid plan's work words (mmb_lstm_grid_plan with card 0).
MMB_API int mmb_bilstm_backward(const void* gates, const void* mask, const void* w_h,
                                const void* h_seq, const void* c_seq, const void* dout,
                                const void* dh_last, const void* dc_last, void* dgates,
                                void* dwh_partial, void* dw_h, int num_splits, int B, int T,
                                int H, int route, void* stream) {
  lc::Plan p;
  lc::GridPlan gp;
  if (route == lc::kRouteNone) route = bptt_route_on_card(B, H, &gp);
  const bool ok = route == lc::kRouteCluster ? lc::plan(B, H, &p)
                  : route == lc::kRouteGrid ? grid_plan_on_card(B, H, &gp)
                  : route == lc::kRouteL2 ? lc::l2_rows(B, H) > 0
                                          : false;
  if (T <= 0 || num_splits <= 0 || !ok) return (int)cudaErrorInvalidValue;
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
  if (route == lc::kRouteCluster) {  // (b) the walk on a cluster
    e = with_bptt_kernel(p.R, [&](auto kernel) {
      return lc::launch(kernel, p, p.smem_bwd, s, g, m, w, cs, dout_, dhl, dcl, dg, B, T, H);
    });
  } else if (route == lc::kRouteGrid) {  // (b'') the walk across the card
    auto* xg = static_cast<unsigned long long*>(dwh_partial);
    e = cudaMemsetAsync(xg, 0, 4 * (size_t)gp.work, s);  // no word holds a step yet
    if (e == cudaSuccess)
      e = with_bptt_grid_kernel(gp.UT, [&](auto kernel) {
        lc::LaunchConfig lc_;
        cudaError_t err = configure_grid(kernel, gp, s, &lc_);
        if (err != cudaSuccess) return err;
        err = cudaLaunchKernelEx(&lc_.cfg, kernel, g, m, w, cs, dout_, dhl, dcl, dg, xg, B, T, H);
        return err != cudaSuccess ? err : cudaGetLastError();
      });
  } else {  // (b') the walk by L2
    const int R = lc::l2_rows(B, H);
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

// K6's walk for B rows of width H (lc::BpttRoute): by the shape alone
// (card == 0), or the route mmb_bilstm_backward takes on this card.
MMB_API int mmb_lstm_bptt_route(int B, int H, int card) {
  lc::GridPlan g;
  return card ? bptt_route_on_card(B, H, &g) : lc::bptt_route(B, H);
}

// The grid walk's plan for B rows of width H into out[10]: P, CS, NQ, U,
// UT, Rp, KC, threads, dynamic shared memory a block (bytes), words of
// device memory: the shape's (card == 0) or the one this card runs (card
// == 1). Returns 0, or cudaErrorInvalidValue if there is none.
MMB_API int mmb_lstm_grid_plan(int B, int H, int card, int* out) {
  lc::GridPlan g;
  if (card ? !grid_plan_on_card(B, H, &g)
           : !lc::grid_plan(B, H, lc::kGridBlocks, &g))
    return (int)cudaErrorInvalidValue;
  const int v[10] = {g.P, g.CS, g.NQ, g.U, g.UT, g.Rp, g.KC, g.threads, g.smem, g.work};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// How many clusters of the grid walk at P blocks a direction the card
// holds at once for this shape (it needs 2·P/8); a negative cudaError_t on
// failure.
MMB_API int mmb_bilstm_backward_grid_occupancy(int B, int H, int P) {
  lc::GridPlan g;
  if (!lc::grid_plan(B, H, P, &g)) return -(int)cudaErrorInvalidValue;
  return grid_occupancy(g);
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
