// K11, K12, K13 — 3x3/stride-1/SAME conv + bias + ReLU, NHWC x HWIO, as
// three schedules of one implicit GEMM [pixels x 9·Cin] · [9·Cin x Cout].
//
// Replaces: mmbidaf_tpu/ops/pallas/conv_kernel.py::_conv3x3_kernel (K11,
// entry point conv3x3_same), ::_conv3x3_acc_kernel (K12, conv3x3_same_acc)
// and ::_conv3x3_db_kernel (K13, conv3x3_same_db). Contract, per output pixel
// (h, w) and channel k:
//   out = ReLU(bias[k] + sum over (dy, dx, c) of x[h+dy-1, w+dx-1, c] * w[dy, dx, c, k])
// (zero outside the image), operands in T (float or __nv_bfloat16), products
// and sums in f32, one cast to T.
//
// What bounds it on the H100: 2·9·Cin·Cout operations per output pixel
// against (Cin + Cout)·sizeof(T) bytes, far above the card's ridge point at
// every VGG-16 layer: operations, at the tensor cores' rate for bf16
// operands.
//
// K11 in bf16 (kIm2col, its own kernel): the TPU kernel's im2col patch and
// one product, on the tensor cores. One block of 8 warps per (8x16 output
// pixels of one image, 64 output channels); loop over chunks of 16 input
// channels, two stages in flight:
//   - the chunk's patch matrix [9 taps][128 pixels][16 ch] (the A operand)
//     is gathered by cp.async in 16-byte granules of 8 channels, zero-filled
//     outside the image and past Cin, and its weights [9 taps][16 ch][64 out]
//     (the B operand, K-major) likewise; rows are swizzled so that ldmatrix
//     reads them without bank conflicts;
//   - warp (m, n) of a 4 x 2 grid multiplies 32 pixels by 32 output
//     channels: per tap 2 ldmatrix.x4 of A, 2 ldmatrix.x4.trans of B and 8
//     mma.sync m16n8k16 (bf16 operands, f32 accumulators; mma.cuh), its sums
//     in 32 registers a thread across the whole C loop.
// mma.sync and not wgmma: the block is a small 128 x 64 tile whose A is a
// gather, not a tile TMA or a wgmma descriptor can address. What bounds
// this design: 256 bytes of ldmatrix per mma (above the SM's 128 bytes a
// clock at the tensor cores' peak), two blocks an SM, and the 9x copy of
// the input the im2col patch makes. Where Cin or Cout is not a multiple of
// 8 (or a pointer is not 16-byte aligned), the same kernel loads that
// operand element by element.
// K11 in f32, K12 and K13: one block per (8x16 output pixels, 64 output
// channels), 256 threads, each owning 8 pixels of one row x 4 output
// channels (32 f32 accumulators) as f32 FMAs on the CUDA cores. Loop over
// chunks of 16 input channels; per chunk the weights [9 taps][16][64] sit in
// shared memory, and the schedules differ in how the input reaches it:
//   K11 (kIm2col, f32): the chunk's patch matrix [128 pixels][9 taps x 16]
//       is gathered from global memory and multiplied by the [9 x 16][64]
//       weights;
//   K12 (kTaps): the haloed input slab [10][18][16] is loaded once and the
//       nine taps read it shifted: nine accumulated products, no 9x copy;
//   K13 (kDoubleBuffer): K12 with two slab and weight buffers filled by
//       cp.async, so chunk i+1 is in flight while chunk i computes. The TPU
//       kernel prefetched the next grid step's H tile; blocks run in
//       parallel here, so the block's own chunk loop is what it overlaps.
//       cp.async copies 4-byte granules, so in bf16 it needs even Cin and
//       Cout (the wrapper checks).
// The epilogue adds the bias, applies the ReLU and writes NHWC once; the
// image edge and the last channel block are masked (the TPU's H % tile_h
// and W % 8 rules are layout rules of its own and are not carried over).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTH = 8, kTW = 16;  // output pixels per block
constexpr int kKB = 64;           // output channels per block
constexpr int kCC = 16;           // input channels per chunk
constexpr int kThreads = 256;
constexpr int kSH = kTH + 2, kSW = kTW + 2;
constexpr int kSlab = kSH * kSW * kCC;          // elements of a haloed slab
constexpr int kWts = 9 * kCC * kKB;             // elements of a weight chunk
constexpr int kPatch = kTH * kTW * 9 * kCC;     // elements of a patch matrix

enum Schedule { kIm2col = 0, kTaps = 1, kDoubleBuffer = 2 };

template <typename T>
size_t smem_bytes(int sched) {
  const int elems = sched == kIm2col ? kPatch + kWts
                    : sched == kTaps ? kSlab + kWts
                                     : 2 * (kSlab + kWts);
  return sizeof(T) * (size_t)elems;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

struct Geometry {
  int n, h0, w0, k_base;  // image, top-left output pixel, first output channel
  int H, W, Cin, Cout;
};

// Slab element e = ((sh * kSW) + sw) * kCC + c: input pixel (h0+sh-1, w0+sw-1).
template <typename T>
__device__ __forceinline__ bool slab_src(const Geometry& g, const T* x, int c_base, int e,
                                         const T** src) {
  const int c = e % kCC, sw = (e / kCC) % kSW, sh = e / (kCC * kSW);
  const int h = g.h0 + sh - 1, w = g.w0 + sw - 1, ch = c_base + c;
  const bool in = h >= 0 && h < g.H && w >= 0 && w < g.W && ch < g.Cin;
  *src = in ? x + (((size_t)g.n * g.H + h) * g.W + w) * g.Cin + ch : x;
  return in;
}

// Weight element e = (tap * kCC + c) * kKB + k: w[tap, c_base + c, k_base + k].
template <typename T>
__device__ __forceinline__ bool wts_src(const Geometry& g, const T* wt, int c_base, int e,
                                        const T** src) {
  const int k = e % kKB, c = (e / kKB) % kCC, tap = e / (kKB * kCC);
  const int ch = c_base + c, ko = g.k_base + k;
  const bool in = ch < g.Cin && ko < g.Cout;
  *src = in ? wt + ((size_t)tap * g.Cin + ch) * g.Cout + ko : wt;
  return in;
}

template <typename T>
__device__ __forceinline__ void load_slab(const Geometry& g, const T* x, int c_base, T* slab) {
  for (int e = threadIdx.x; e < kSlab; e += kThreads) {
    const T* src;
    slab[e] = slab_src(g, x, c_base, e, &src) ? *src : T(0.0f);
  }
}

template <typename T>
__device__ __forceinline__ void load_wts(const Geometry& g, const T* wt, int c_base, T* w_s) {
  for (int e = threadIdx.x; e < kWts; e += kThreads) {
    const T* src;
    w_s[e] = wts_src(g, wt, c_base, e, &src) ? *src : T(0.0f);
  }
}

// K13: the same copies as 4-byte cp.async granules (zero-filled outside).
template <typename T>
__device__ __forceinline__ void issue_chunk(const Geometry& g, const T* x, const T* wt, int c_base,
                                            T* slab, T* w_s) {
  constexpr int kPer = 4 / sizeof(T);
  for (int e = threadIdx.x * kPer; e < kSlab; e += kThreads * kPer) {
    const T* src;
    const bool in = slab_src(g, x, c_base, e, &src);
    cp_async4(slab + e, src, in);
  }
  for (int e = threadIdx.x * kPer; e < kWts; e += kThreads * kPer) {
    const T* src;
    const bool in = wts_src(g, wt, c_base, e, &src);
    cp_async4(w_s + e, src, in);
  }
}

// The chunk's products: acc[i][j] += A[pixel i] · w_s[:, k0 + j], A read from
// the patch matrix (kIm2col) or from the slab shifted by the tap.
template <typename T, int kSched>
__device__ __forceinline__ void chunk_products(const T* a_s, const T* w_s, int ph, int pw0, int k0,
                                               float acc[8][4]) {
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll 4
    for (int c = 0; c < kCC; ++c) {
      float wv[4];
      mmb::load4(w_s + (tap * kCC + c) * kKB + k0, wv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a =
            kSched == kIm2col
                ? mmb::to_f32(a_s[(ph * kTW + pw0 + i) * (9 * kCC) + tap * kCC + c])
                : mmb::to_f32(a_s[((ph + dy) * kSW + pw0 + i + dx) * kCC + c]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
      }
    }
  }
}

template <typename T, int kSched>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(
    const T* __restrict__ x,         // [N, H, W, Cin]
    const T* __restrict__ wt,        // [3, 3, Cin, Cout]
    const float* __restrict__ bias,  // [Cout]
    T* __restrict__ out,             // [N, H, W, Cout]
    int H, int W, int Cin, int Cout, int relu) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int tiles_w = (W + kTW - 1) / kTW;
  Geometry g;
  g.n = blockIdx.y;
  g.h0 = (blockIdx.x / tiles_w) * kTH;
  g.w0 = (blockIdx.x % tiles_w) * kTW;
  g.k_base = blockIdx.z * kKB;
  g.H = H, g.W = W, g.Cin = Cin, g.Cout = Cout;
  const int tid = threadIdx.x;
  const int ph = tid >> 5, pw0 = ((tid >> 4) & 1) * 8, k0 = (tid & 15) * 4;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  if (kSched == kIm2col) {
    T* patch = smem;
    T* w_s = smem + kPatch;
    for (int c_base = 0; c_base < Cin; c_base += kCC) {
      __syncthreads();
      for (int e = tid; e < kPatch; e += kThreads) {
        const int c = e % kCC, tap = (e / kCC) % 9, pix = e / (kCC * 9);
        const int h = g.h0 + pix / kTW + tap / 3 - 1, w = g.w0 + pix % kTW + tap % 3 - 1;
        const int ch = c_base + c;
        patch[e] = (h >= 0 && h < H && w >= 0 && w < W && ch < Cin)
                       ? x[(((size_t)g.n * H + h) * W + w) * Cin + ch]
                       : T(0.0f);
      }
      load_wts(g, wt, c_base, w_s);
      __syncthreads();
      chunk_products<T, kIm2col>(patch, w_s, ph, pw0, k0, acc);
    }
  } else if (kSched == kTaps) {
    T* slab = smem;
    T* w_s = smem + kSlab;
    for (int c_base = 0; c_base < Cin; c_base += kCC) {
      __syncthreads();
      load_slab(g, x, c_base, slab);
      load_wts(g, wt, c_base, w_s);
      __syncthreads();
      chunk_products<T, kTaps>(slab, w_s, ph, pw0, k0, acc);
    }
  } else {
    T* slab[2] = {smem, smem + kSlab};
    T* w_s[2] = {smem + 2 * kSlab, smem + 2 * kSlab + kWts};
    const int nchunks = (Cin + kCC - 1) / kCC;
    issue_chunk(g, x, wt, 0, slab[0], w_s[0]);
    cp_async_commit();
    for (int i = 0; i < nchunks; ++i) {
      // buffer (i+1)&1 was last read in iteration i-1, which ended in a barrier
      if (i + 1 < nchunks) issue_chunk(g, x, wt, (i + 1) * kCC, slab[(i + 1) & 1], w_s[(i + 1) & 1]);
      cp_async_commit();
      cp_async_wait_one();  // every group but the newest has landed: chunk i
      __syncthreads();
      chunk_products<T, kTaps>(slab[i & 1], w_s[i & 1], ph, pw0, k0, acc);
      __syncthreads();
    }
  }

  const int h = g.h0 + ph;
  if (h >= H) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int w = g.w0 + pw0 + i;
    if (w >= W) break;
    T* o = out + (((size_t)g.n * H + h) * W + w) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ko = g.k_base + k0 + j;
      if (ko >= Cout) break;
      float v = acc[i][j] + bias[ko];
      if (relu) v = fmaxf(v, 0.0f);
      mmb::store_f32(o + ko, v);
    }
  }
}

template <typename T, int kSched>
int launch(const void* x, const void* w, const void* bias, void* out, int N, int H, int W, int Cin,
           int Cout, int relu, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(kSched);
  cudaError_t e = cudaFuncSetAttribute(conv3x3_kernel<T, kSched>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), N, (Cout + kKB - 1) / kKB);
  conv3x3_kernel<T, kSched><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(out), H, W, Cin, Cout, relu);
  return (int)cudaGetLastError();
}

// ---- K11 in bf16: the tensor-core body ----
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kPix = kTH * kTW;        // 128 pixels: 8 m-tiles of 16
constexpr int kA = 9 * kPix * kCC;     // patch matrix [9 taps][kPix][kCC], swizzled
constexpr int kB = 9 * kCC * kKB;      // weights [9 taps][kCC][kKB], swizzled
constexpr size_t kSmemBytes = 2 * sizeof(bf16) * (kA + kB);  // two stages
static_assert(kCC == 16 && kKB == 64 && kThreads == 256 && kPix == 128, "the warp grid below");

// Element (tap, pixel p, channel c) of the patch matrix: 32-byte rows, the
// granule XOR-ed with (p / 4) % 2, so the 8 rows an ldmatrix reads fall in
// distinct banks.
__device__ __forceinline__ int a_index(int tap, int p, int c) {
  return (tap * kPix + p) * kCC + ((((c >> 3) ^ (p >> 2)) & 1) << 3) + (c & 7);
}

// Element (tap, channel c, output channel k) of the weights: 128-byte rows,
// the granule XOR-ed with c % 8.
__device__ __forceinline__ int b_index(int tap, int c, int k) {
  return (tap * kCC + c) * kKB + ((((k >> 3) ^ c) & 7) << 3) + (k & 7);
}

// Chunk c_base of the patch matrix and the weights into one stage.
__device__ __forceinline__ void load_chunk(const Geometry& g, const bf16* x, const bf16* wt,
                                           int c_base, bool vec_x, bool vec_w, bf16* a_s,
                                           bf16* b_s) {
  const int tid = threadIdx.x;
  const bf16 zero = __float2bfloat16(0.0f);
  if (vec_x) {  // thread = (pixel p, granule of 8 channels)
    const int p = tid >> 1, gc = (tid & 1) * 8, ch = c_base + gc;
    const int ph = g.h0 + (p / kTW), pw = g.w0 + (p % kTW);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int h = ph + tap / 3 - 1, w = pw + tap % 3 - 1;
      const bool in = h >= 0 && h < g.H && w >= 0 && w < g.W && ch < g.Cin;
      const bf16* src = in ? x + (((size_t)g.n * g.H + h) * g.W + w) * g.Cin + ch : x;
      mmb::cp_async16(mmb::smem_u32(a_s + a_index(tap, p, gc)), src, in);
    }
  } else {
    for (int e = tid; e < kA; e += kThreads) {
      const int c = e & (kCC - 1), p = (e >> 4) & (kPix - 1), tap = e >> 11;
      const int h = g.h0 + p / kTW + tap / 3 - 1, w = g.w0 + p % kTW + tap % 3 - 1;
      const int ch = c_base + c;
      a_s[a_index(tap, p, c)] = h >= 0 && h < g.H && w >= 0 && w < g.W && ch < g.Cin
                                    ? x[(((size_t)g.n * g.H + h) * g.W + w) * g.Cin + ch]
                                    : zero;
    }
  }
  if (vec_w) {
    for (int e = tid; e < kB / 8; e += kThreads) {
      const int gk = (e & 7) * 8, c = (e >> 3) & (kCC - 1), tap = e >> 7;
      const int ch = c_base + c, ko = g.k_base + gk;
      const bool in = ch < g.Cin && ko < g.Cout;
      const bf16* src = in ? wt + ((size_t)tap * g.Cin + ch) * g.Cout + ko : wt;
      mmb::cp_async16(mmb::smem_u32(b_s + b_index(tap, c, gk)), src, in);
    }
  } else {
    for (int e = tid; e < kB; e += kThreads) {
      const int k = e & (kKB - 1), c = (e >> 6) & (kCC - 1), tap = e >> 10;
      const int ch = c_base + c, ko = g.k_base + k;
      b_s[b_index(tap, c, k)] =
          ch < g.Cin && ko < g.Cout ? wt[((size_t)tap * g.Cin + ch) * g.Cout + ko] : zero;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) conv3x3_im2col_mma_kernel(
    const bf16* __restrict__ x,      // [N, H, W, Cin]
    const bf16* __restrict__ wt,     // [3, 3, Cin, Cout]
    const float* __restrict__ bias,  // [Cout]
    bf16* __restrict__ out,          // [N, H, W, Cout]
    int H, int W, int Cin, int Cout, int relu, int vec_x, int vec_w) {
  extern __shared__ float4 smem4[];
  bf16* a_s = reinterpret_cast<bf16*>(smem4);  // 2 stages of kA
  bf16* b_s = a_s + 2 * kA;                    // 2 stages of kB
  const int tiles_w = (W + kTW - 1) / kTW;
  Geometry g;
  g.n = blockIdx.y;
  g.h0 = (blockIdx.x / tiles_w) * kTH;
  g.w0 = (blockIdx.x % tiles_w) * kTW;
  g.k_base = blockIdx.z * kKB;
  g.H = H, g.W = W, g.Cin = Cin, g.Cout = Cout;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // pixels wm*32.., output channels wn*32..

  float acc[2][4][4];  // [m-tile][n-tile][fragment]
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[m][n][f] = 0.0f;

  const int nchunks = (Cin + kCC - 1) / kCC;
  load_chunk(g, x, wt, 0, vec_x, vec_w, a_s, b_s);
  mmb::cp_async_commit_group();
  for (int i = 0; i < nchunks; ++i) {
    const int st = i & 1;
    mmb::cp_async_wait_group<0>();
    __syncthreads();  // chunk i has landed; every warp is done with chunk i-1's stage
    if (i + 1 < nchunks)
      load_chunk(g, x, wt, (i + 1) * kCC, vec_x, vec_w, a_s + (st ^ 1) * kA, b_s + (st ^ 1) * kB);
    mmb::cp_async_commit_group();
    const unsigned a_base = mmb::smem_u32(a_s + st * kA);
    const unsigned b_base = mmb::smem_u32(b_s + st * kB);
#pragma unroll 3
    for (int tap = 0; tap < 9; ++tap) {
      // Every fragment of the tap first, then its 8 products.
      unsigned a[2][4], b[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int p = wm * 32 + m * 16 + (lane & 15);
        mmb::ldmatrix_x4(a[m], a_base + 2 * a_index(tap, p, (lane >> 4) * 8));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np)
        mmb::ldmatrix_x4_trans(
            b[np], b_base + 2 * b_index(tap, lane & 15, wn * 32 + np * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < 2; ++np)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mmb::mma_bf16_16816(acc[m][2 * np], a[m], b[np][0], b[np][1]);
          mmb::mma_bf16_16816(acc[m][2 * np + 1], a[m], b[np][2], b[np][3]);
        }
    }
  }

  // Bias, ReLU, one cast, NHWC: each thread writes channel pairs of 4 pixels.
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = wm * 32 + m * 16 + (lane >> 2) + half * 8;
      const int h = g.h0 + p / kTW, w = g.w0 + p % kTW;
      if (h >= H || w >= W) continue;
      bf16* o = out + (((size_t)g.n * H + h) * W + w) * Cout;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int ko = g.k_base + wn * 32 + n * 8 + (lane & 3) * 2;
        if (ko >= Cout) continue;
        float v0 = acc[m][n][half * 2] + bias[ko];
        if (relu) v0 = fmaxf(v0, 0.0f);
        if (ko + 1 < Cout) {
          float v1 = acc[m][n][half * 2 + 1] + bias[ko + 1];
          if (relu) v1 = fmaxf(v1, 0.0f);
          if (Cout % 2 == 0) {
            *reinterpret_cast<unsigned*>(o + ko) = mmb::pack_bf16x2(v0, v1);
            continue;
          }
          o[ko + 1] = __float2bfloat16(v1);
        }
        o[ko] = __float2bfloat16(v0);
      }
    }
}

int launch(const void* x, const void* w, const void* bias, void* out, int N, int H, int W, int Cin,
           int Cout, int relu, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(conv3x3_im2col_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const bool vec_x = Cin % 8 == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  const bool vec_w = Cout % 8 == 0 && reinterpret_cast<size_t>(w) % 16 == 0;
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), N, (Cout + kKB - 1) / kKB);
  conv3x3_im2col_mma_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), H, W, Cin, Cout, relu, vec_x, vec_w);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename T>
int dispatch(int sched, const void* x, const void* w, const void* bias, void* out, int N, int H,
             int W, int Cin, int Cout, int relu, cudaStream_t s) {
  switch (sched) {
    case kIm2col:
      if constexpr (sizeof(T) == 2)
        return tc::launch(x, w, bias, out, N, H, W, Cin, Cout, relu, s);
      else
        return launch<T, kIm2col>(x, w, bias, out, N, H, W, Cin, Cout, relu, s);
    case kTaps: return launch<T, kTaps>(x, w, bias, out, N, H, W, Cin, Cout, relu, s);
    case kDoubleBuffer:
      if (sizeof(T) == 2 && (Cin % 2 || Cout % 2)) return (int)cudaErrorInvalidValue;
      return launch<T, kDoubleBuffer>(x, w, bias, out, N, H, W, Cin, Cout, relu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [N, H, W, Cin], w [3, 3, Cin, Cout] (T = bf16 if bf16 else f32), bias
// [Cout] f32 -> out [N, H, W, Cout] T; schedule 0 = K11 (bf16 on the tensor
// cores), 1 = K12, 2 = K13.
MMB_API int mmb_conv3x3(const void* x, const void* w, const void* bias, void* out, int N, int H,
                        int W, int Cin, int Cout, int relu, int bf16, int schedule, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || N > 65535 ||
      (Cout + kKB - 1) / kKB > 65535)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(schedule, x, w, bias, out, N, H, W, Cin, Cout, relu, s)
              : dispatch<float>(schedule, x, w, bias, out, N, H, W, Cin, Cout, relu, s);
}

// Dynamic shared memory of a block of K11's bf16 (tensor-core) body, in bytes.
MMB_API int mmb_conv3x3_mma_smem_bytes() { return (int)tc::kSmemBytes; }
