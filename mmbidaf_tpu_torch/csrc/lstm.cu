// K1 — BiLSTM recurrence, both directions in one launch — and K5, the same
// recurrence for training, which also writes the carried h and c of every
// step as the BPTT residuals.
//
// Replaces: mmbidaf_tpu/ops/pallas/lstm_kernel.py::_lstm_kernel (K1, entry
// points lstm_pallas / bilstm_pallas) and ::_lstm_fwd_train_kernel (K5,
// entry _lstm_train_fwd_impl via lstm_pallas_trainable /
// bilstm_pallas_trainable). Contract: given gates = x@W_x + b for all
// steps (one GEMM outside the kernel, as on the TPU), run per step
//   z = gates_t + h @ W_h;  i,f,g,o = σ,σ,tanh,σ of z's four quarters
//   c' = f*c + i*g;  h' = o*tanh(c')
//   carry h = m*h' + (1-m)*h, c likewise;  out_t = h'*m
// with pack_padded semantics from the mask (masked steps freeze the state
// and emit zeros; the reverse direction runs step t at position T-1-t for
// the gates, the mask and the output), and return the carried h and c after
// the last step. Everything in f32 (the TPU kernel computes in f32 even
// under a bf16 model). K5 also writes h_seq/c_seq [2, T, B, H]: per
// direction, the carried state after processing step t (step t runs at
// position T-1-t in the reverse direction), which csrc/lstm_bwd.cu (K6)
// reads back.
//
// Both run on a thread-block cluster that keeps W_h on chip
// (bilstm_cluster_kernel<R, kTrain>, csrc/lstm_cluster.cuh): K5 is kTrain
// = true, K1 kTrain = false, which writes no residuals and issues its
// product's loads 8 k ahead of their FMAs (the step is latency: clock64
// stamps put most of it in the product's dependent shared-memory loads,
// tools/lstm_variants.py); the sums are the same, so at equal gates K1 and
// K5 give the same bits. Block c of a cluster holds the four gate columns
// of its ~H/C units for the cluster's R rows. Per step it computes
// z[:, its columns] = gates + h_prev · W_h[:, its columns] from the full
// h_prev [H][R] it holds, runs the gate math of its units, writes out (and,
// in K5, h_seq and c_seq), pushes its h slice into every block's h buffer
// of the next parity, and passes the cluster barrier: one barrier a step.
// The next step's gates and mask come by cp.async while the step runs.
// What bounds it: per step, one cluster barrier and the [R x H]·[H x 4U]
// product a block (U = ceil(H/C)): T dependent steps of on-chip latency;
// for the whole kernel, the recurrent product's 2·2·B·T·H·4H FLOPs at the
// H100's 67 TFLOP/s f32 rate (K5's residual writes are its bytes). W_h is
// read from device memory once per block, not once per step.
//
// K1's and K5's second route (bilstm_kernel<R, kTrain>, as the cluster body:
// K5 also writes h_seq / c_seq, with the same sums, so at equal gates K1 and
// K5 give the same bits here too) serves the widths with no cluster plan (H
// past 448, 432 or 384 at 4, 8 or 16 rows a cluster, where no 16-block
// cluster holds W_h's slice and the h buffers in shared memory): grid
// (ceil(B/R), 2 directions), R from lstm_cluster.cuh::l2_rows; W_h (H x 4H
// f32, 4 MB a direction at H = 512) is read from L2 every step, each read
// reused for the block's R rows; a thread accumulates z of four neighbouring
// gate columns for the R rows (16-byte loads, each h from shared memory
// serving four FMAs: with one column a thread, the h loads bound the step),
// then one thread per (row, unit) runs the gate math. Its time is T
// dependent steps, each bound by the block's R·H·4H FMAs and its read of
// W_h from L2. The wrappers (ops/cuda/lstm_kernel.py::bilstm_cuda,
// bilstm_train_forward) and the entry points pick the route from the same
// plan before any launch.
#include "common.cuh"
#include "lstm_cluster.cuh"

namespace {

// Threads a block of the L2 route: a thread four gate columns.
inline int l2_threads(int H) { return mmb::threads_for(H, 512); }

template <int R, bool kTrain>
__global__ void __launch_bounds__(512) bilstm_kernel(
    const float* __restrict__ gates,  // [B, T, 2, 4H]: fwd gates, then bwd gates
    const float* __restrict__ mask,   // [B, T]
    const float* __restrict__ w_h,    // [2, H, 4H]
    float* __restrict__ out,          // [B, T, 2H]: fwd | bwd
    float* __restrict__ h_last,       // [B, 2H]
    float* __restrict__ c_last,       // [B, 2H]
    float* __restrict__ h_seq,        // [2, T, B, H] (kTrain only)
    float* __restrict__ c_seq,        // [2, T, B, H] (kTrain only)
    int B, int T, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* h_s = smem;         // [R][H] carried h
  float* c_s = h_s + R * H;  // [R][H] carried c
  float* z_s = c_s + R * H;  // [R][G] this step's gate pre-activations
  const int dir = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const float* wh = w_h + (size_t)dir * H * G;

  for (int p = threadIdx.x; p < R * H; p += blockDim.x) {
    h_s[p] = 0.0f;
    c_s[p] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int tt = dir ? T - 1 - t : t;
    // a thread four neighbouring gate columns (16-byte W_h loads, each h
    // read from shared memory serving four FMAs), W_h's loads of kAhead k
    // issued before their FMAs (the step waits on L2's latency; fewer at
    // more rows, whose sums take the registers); each sum runs k ascending
    constexpr int kAhead = R >= 8 ? 4 : 8;
    for (int j = 4 * threadIdx.x; j < G; j += 4 * blockDim.x) {
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
      const auto fma4 = [&](float h, float4 w, float* a) {
        a[0] = fmaf(h, w.x, a[0]);
        a[1] = fmaf(h, w.y, a[1]);
        a[2] = fmaf(h, w.z, a[2]);
        a[3] = fmaf(h, w.w, a[3]);
      };
      int k = 0;
      for (; k + kAhead <= H; k += kAhead) {
        float4 w[kAhead];
#pragma unroll
        for (int i = 0; i < kAhead; ++i)
          w[i] = __ldg(reinterpret_cast<const float4*>(wh + (size_t)(k + i) * G + j));
#pragma unroll
        for (int i = 0; i < kAhead; ++i)
#pragma unroll
          for (int r = 0; r < R; ++r) fma4(h_s[r * H + k + i], w[i], acc[r]);
      }
      for (; k < H; ++k) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(wh + (size_t)k * G + j));
#pragma unroll
        for (int r = 0; r < R; ++r) fma4(h_s[r * H + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        const float4 g =
            row < B ? *reinterpret_cast<const float4*>(
                          gates + ((size_t)row * T + tt) * 2 * G + (size_t)dir * G + j)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        z_s[r * G + j] = g.x + acc[r][0];
        z_s[r * G + j + 1] = g.y + acc[r][1];
        z_s[r * G + j + 2] = g.z + acc[r][2];
        z_s[r * G + j + 3] = g.w + acc[r][3];
      }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < R * H; p += blockDim.x) {
      const int r = p / H, u = p - r * H;
      const int row = row0 + r;
      if (row >= B) continue;
      const float* z = z_s + r * G;
      const float ig = mmb::sigmoid(z[u]);
      const float fg = mmb::sigmoid(z[H + u]);
      const float gg = tanhf(z[2 * H + u]);
      const float og = mmb::sigmoid(z[3 * H + u]);
      const float c_old = c_s[p], h_old = h_s[p];
      const float c_new = fg * c_old + ig * gg;
      const float h_new = og * tanhf(c_new);
      const float m = mask[(size_t)row * T + tt];
      const float c_carry = m * c_new + (1.0f - m) * c_old;
      const float h_carry = m * h_new + (1.0f - m) * h_old;
      c_s[p] = c_carry;
      h_s[p] = h_carry;
      out[((size_t)row * T + tt) * 2 * H + (size_t)dir * H + u] = h_new * m;
      if (kTrain) {
        const size_t q = (((size_t)dir * T + t) * B + row) * H + u;
        h_seq[q] = h_carry;
        c_seq[q] = c_carry;
      }
    }
    __syncthreads();
  }

  for (int p = threadIdx.x; p < R * H; p += blockDim.x) {
    const int r = p / H, u = p - r * H;
    const int row = row0 + r;
    if (row < B) {
      h_last[(size_t)row * 2 * H + (size_t)dir * H + u] = h_s[p];
      c_last[(size_t)row * 2 * H + (size_t)dir * H + u] = c_s[p];
    }
  }
}

namespace lc = mmb::lstmc;

// f(the L2 body instantiated for R rows a block).
template <bool kTrain, typename F>
auto with_l2_kernel(int R, F f) {
  return R == 16  ? f(bilstm_kernel<16, kTrain>)
         : R == 8 ? f(bilstm_kernel<8, kTrain>)
         : R == 4 ? f(bilstm_kernel<4, kTrain>)
         : R == 2 ? f(bilstm_kernel<2, kTrain>)
                  : f(bilstm_kernel<1, kTrain>);
}

// The L2 route of K1 (kTrain = false) or K5: R rows a block by
// lstm_cluster.cuh::l2_rows.
template <bool kTrain>
cudaError_t bilstm_l2(const void* gates, const void* mask, const void* w_h, void* out,
                      void* h_last, void* c_last, void* h_seq, void* c_seq, int B, int T, int H,
                      void* stream) {
  const int R = lc::l2_rows(B, H);
  if (R == 0) return cudaErrorInvalidValue;
  const size_t smem = lc::l2_smem(H, R);
  return with_l2_kernel<kTrain>(R, [&](auto kernel) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((B + R - 1) / R, 2), l2_threads(H), smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(gates), static_cast<const float*>(mask),
        static_cast<const float*>(w_h), static_cast<float*>(out), static_cast<float*>(h_last),
        static_cast<float*>(c_last), static_cast<float*>(h_seq), static_cast<float*>(c_seq), B, T,
        H);
    return cudaGetLastError();
  });
}

// Blocks of K1's (kTrain = false) or K5's L2 route an SM holds (0: the launch
// cannot run); a negative cudaError_t on failure.
template <bool kTrain>
int l2_occupancy(int B, int H) {
  const int R = lc::l2_rows(B, H);
  if (R == 0) return -(int)cudaErrorInvalidValue;
  const size_t smem = lc::l2_smem(H, R);
  return with_l2_kernel<kTrain>(R, [&](auto kernel) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int n = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, l2_threads(H), smem);
    return e == cudaSuccess ? n : -(int)e;
  });
}

// ---------------------------------------------------------------------------
// K1 and K5: the recurrence on a thread-block cluster.
// ---------------------------------------------------------------------------

template <int R, bool kTrain>
__global__ void __launch_bounds__(lc::kThreads) bilstm_cluster_kernel(
    const float* __restrict__ gates,  // [B, T, 2, 4H]
    const float* __restrict__ mask,   // [B, T]
    const float* __restrict__ w_h,    // [2, H, 4H]
    float* __restrict__ out,          // [B, T, 2H]
    float* __restrict__ h_last,       // [B, 2H]
    float* __restrict__ c_last,       // [B, 2H]
    float* __restrict__ h_seq,        // [2, T, B, H] (kTrain only)
    float* __restrict__ c_seq,        // [2, T, B, H] (kTrain only)
    int B, int T, int H) {
  static_assert(R % lc::kRC == 0, "rows a cluster must be a multiple of kRC");
  lc::cg::cluster_group cluster = lc::cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int C = gridDim.x, c = blockIdx.x;
  const int U = lc::units_max(H, C), G4 = 4 * U, ldw = G4 + 1, G = 4 * H;
  const int u0 = lc::unit_begin(c, H, C), nu = lc::unit_begin(c + 1, H, C) - u0;
  const int row0 = blockIdx.y * R, dir = blockIdx.z;
  float* h_b = smem;                                  // [2][H][R] full h, by parity
  float* w_s = h_b + lc::round4(2 * (size_t)H * R);   // [H][4U+1]
  float* z_s = w_s + lc::round4((size_t)H * ldw);     // [R][4U]
  float* g_st = z_s + lc::round4(R * G4);             // [2][R][4U] gates stage
  float* c_s = g_st + lc::round4(2 * R * G4);         // [R][U] carried c
  float* m_st = c_s + lc::round4(R * U);              // [2][R] mask stage

  // The gates and mask of step t into stage t & 1.
  auto prefetch = [&](int t) {
    const int tt = dir ? T - 1 - t : t;
    float* gs = g_st + (t & 1) * R * G4;
    for (int e = threadIdx.x; e < R * G4 + R; e += blockDim.x) {
      if (e < R * G4) {
        const int r = e / G4, jl = e - r * G4, g = jl / U, ul = jl - g * U;
        const int row = row0 + r;
        const bool ok = row < B && ul < nu;
        lc::cp_async4(gs + e,
                      ok ? gates + ((size_t)row * T + tt) * 2 * G + (size_t)dir * G + g * H + u0 + ul
                         : gates,
                      ok);
      } else {
        const int r = e - R * G4, row = row0 + r;
        lc::cp_async4(m_st + (t & 1) * R + r, row < B ? mask + (size_t)row * T + tt : mask,
                      row < B);
      }
    }
  };

  lc::load_w_slice(w_s, w_h + (size_t)dir * H * G, H, U, u0, nu);
  for (int e = threadIdx.x; e < H * R; e += blockDim.x) h_b[e] = 0.0f;
  for (int e = threadIdx.x; e < R * U; e += blockDim.x) c_s[e] = 0.0f;
  prefetch(0);
  lc::cp_async_wait_all();
  cluster.sync();  // every block of the cluster has started and is initialised

  for (int t = 0; t < T; ++t) {
    const int par = t & 1, tt = dir ? T - 1 - t : t;
    if (t + 1 < T) prefetch(t + 1);
    const float* hb = h_b + par * H * R;
    const float* gs = g_st + par * R * G4;
    // z[:, this block's columns] = gates + h_prev · W_h[:, those columns],
    // k ascending. K1 first issues the loads of 8 k at a time ahead of
    // their FMAs (one shared-memory latency per 8 k, not per k or two); the
    // sums are K5's, so are the bits.
    for (int q = threadIdx.x; q < G4 * (R / lc::kRC); q += blockDim.x) {
      const int jl = q % G4, r0 = (q / G4) * lc::kRC;
      float acc[lc::kRC] = {};
      int k = 0;
      if constexpr (!kTrain) {
        for (; k + 8 <= H; k += 8) {
          float w[8];
          float4 hv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            w[i] = w_s[(k + i) * ldw + jl];
            hv[i] = *reinterpret_cast<const float4*>(hb + (k + i) * R + r0);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[0] = fmaf(hv[i].x, w[i], acc[0]);
            acc[1] = fmaf(hv[i].y, w[i], acc[1]);
            acc[2] = fmaf(hv[i].z, w[i], acc[2]);
            acc[3] = fmaf(hv[i].w, w[i], acc[3]);
          }
        }
      }
#pragma unroll 4
      for (; k < H; ++k) {
        const float w = w_s[k * ldw + jl];
        const float4 hv = *reinterpret_cast<const float4*>(hb + k * R + r0);
        acc[0] = fmaf(hv.x, w, acc[0]);
        acc[1] = fmaf(hv.y, w, acc[1]);
        acc[2] = fmaf(hv.z, w, acc[2]);
        acc[3] = fmaf(hv.w, w, acc[3]);
      }
#pragma unroll
      for (int i = 0; i < lc::kRC; ++i) z_s[(r0 + i) * G4 + jl] = gs[(r0 + i) * G4 + jl] + acc[i];
    }
    __syncthreads();
    // The gate math of this block's units; h goes to every block's buffer
    // of the next parity.
    float* hn = h_b + (par ^ 1) * H * R;
    for (int p = threadIdx.x; p < R * nu; p += blockDim.x) {
      const int r = p / nu, ul = p - r * nu, u = u0 + ul, row = row0 + r;
      const float* z = z_s + r * G4;
      const float ig = mmb::sigmoid(z[ul]);
      const float fg = mmb::sigmoid(z[U + ul]);
      const float gg = tanhf(z[2 * U + ul]);
      const float og = mmb::sigmoid(z[3 * U + ul]);
      const float c_old = c_s[r * U + ul], h_old = hb[u * R + r];
      const float c_new = fg * c_old + ig * gg;
      const float h_new = og * tanhf(c_new);
      const float m = m_st[par * R + r];
      const float c_carry = m * c_new + (1.0f - m) * c_old;
      const float h_carry = m * h_new + (1.0f - m) * h_old;
      c_s[r * U + ul] = c_carry;
      for (int cc = 0; cc < C; ++cc) cluster.map_shared_rank(hn, cc)[u * R + r] = h_carry;
      if (row < B) {
        out[((size_t)row * T + tt) * 2 * H + (size_t)dir * H + u] = h_new * m;
        if (kTrain) {
          const size_t q = (((size_t)dir * T + t) * B + row) * H + u;
          h_seq[q] = h_carry;
          c_seq[q] = c_carry;
        }
      }
    }
    lc::cp_async_wait_all();
    cluster.sync();
  }

  const float* hb = h_b + (T & 1) * H * R;
  for (int p = threadIdx.x; p < R * nu; p += blockDim.x) {
    const int r = p / nu, ul = p - r * nu, u = u0 + ul, row = row0 + r;
    if (row < B) {
      h_last[(size_t)row * 2 * H + (size_t)dir * H + u] = hb[u * R + r];
      c_last[(size_t)row * 2 * H + (size_t)dir * H + u] = c_s[r * U + ul];
    }
  }
}

// f(the cluster kernel instantiated for a plan's R).
template <bool kTrain, typename F>
auto with_cluster_kernel(int R, F f) {
  return R == 16  ? f(bilstm_cluster_kernel<16, kTrain>)
         : R == 8 ? f(bilstm_cluster_kernel<8, kTrain>)
                  : f(bilstm_cluster_kernel<4, kTrain>);
}

template <bool kTrain>
int bilstm_cluster(const lc::Plan& p, const void* gates, const void* mask, const void* w_h,
                   void* out, void* h_last, void* c_last, void* h_seq, void* c_seq, int B, int T,
                   int H, void* stream) {
  return (int)with_cluster_kernel<kTrain>(p.R, [&](auto kernel) {
    return lc::launch(kernel, p, p.smem_fwd, static_cast<cudaStream_t>(stream),
                      static_cast<const float*>(gates), static_cast<const float*>(mask),
                      static_cast<const float*>(w_h), static_cast<float*>(out),
                      static_cast<float*>(h_last), static_cast<float*>(c_last),
                      static_cast<float*>(h_seq), static_cast<float*>(c_seq), B, T, H);
  });
}

template <bool kTrain>
int cluster_occupancy(int B, int H) {
  lc::Plan p;
  if (!lc::plan(B, H, &p)) return -(int)cudaErrorInvalidValue;
  return with_cluster_kernel<kTrain>(
      p.R, [&](auto kernel) { return lc::max_active_clusters(kernel, p, p.smem_fwd); });
}

}  // namespace

// K1: the inference recurrence: on a cluster where the shape has a plan,
// else by the L2 route.
MMB_API int mmb_bilstm_forward(const void* gates, const void* mask, const void* w_h, void* out,
                               void* h_last, void* c_last, int B, int T, int H,
                               void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  lc::Plan p;
  if (lc::plan(B, H, &p))
    return bilstm_cluster<false>(p, gates, mask, w_h, out, h_last, c_last, nullptr, nullptr, B,
                                 T, H, stream);
  return (int)bilstm_l2<false>(gates, mask, w_h, out, h_last, c_last, nullptr, nullptr, B, T, H,
                               stream);
}

// K5: the training recurrence, which also writes h_seq / c_seq: on a
// cluster where the shape has a plan, else by the L2 route.
MMB_API int mmb_bilstm_forward_train(const void* gates, const void* mask, const void* w_h,
                                     void* out, void* h_last, void* c_last, void* h_seq,
                                     void* c_seq, int B, int T, int H, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  lc::Plan p;
  if (lc::plan(B, H, &p))
    return bilstm_cluster<true>(p, gates, mask, w_h, out, h_last, c_last, h_seq, c_seq, B, T, H,
                                stream);
  return (int)bilstm_l2<true>(gates, mask, w_h, out, h_last, c_last, h_seq, c_seq, B, T, H,
                              stream);
}

// The cluster plan of K1, K5 and K6 for B rows of width H into out[7]: C,
// R, U, clusters a direction, blocks, K1/K5's and K6's dynamic shared
// memory a block (bytes). Returns 0, or cudaErrorInvalidValue if there is
// none.
MMB_API int mmb_lstm_cluster_plan(int B, int H, int* out) {
  lc::Plan p;
  if (!lc::plan(B, H, &p)) return (int)cudaErrorInvalidValue;
  const int v[7] = {p.C, p.R, p.U, p.groups, 2 * p.groups * p.C, p.smem_fwd, p.smem_bwd};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// How many of K1's / K5's clusters the card holds at once for this shape
// (0: the launch cannot run); a negative cudaError_t on failure.
MMB_API int mmb_bilstm_forward_occupancy(int B, int H) { return cluster_occupancy<false>(B, H); }
MMB_API int mmb_bilstm_forward_train_occupancy(int B, int H) {
  return cluster_occupancy<true>(B, H);
}

// The L2 routes' rows a block for B rows of width H (0: no L2 route), and
// how many blocks of K1's / K5's L2 route an SM holds (0: the launch cannot
// run; a negative cudaError_t on failure).
MMB_API int mmb_lstm_l2_rows(int B, int H) { return lc::l2_rows(B, H); }
MMB_API int mmb_bilstm_forward_l2_occupancy(int B, int H) { return l2_occupancy<false>(B, H); }
MMB_API int mmb_bilstm_forward_train_l2_occupancy(int B, int H) {
  return l2_occupancy<true>(B, H);
}

// Message for a code returned by any mmb_* entry point.
MMB_API const char* mmb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
