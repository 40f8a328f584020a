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
// operands. In bf16 the three run on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 accumulators; mma.cuh). Each block owns 8x16 output
// pixels of one image x 64 output channels, 8 warps in a 4 x 2 grid of 32
// pixels (two output rows) x 32 channels, its sums in 32 registers a thread
// across the whole Cin loop; the epilogue (store_tile) adds the bias,
// applies the ReLU and writes packed bf16 NHWC once, masking the image edge
// and the last channel block (the TPU's H % tile_h and W % 8 rules are
// layout rules of its own and are not carried over). mma.sync and not
// wgmma: K11's A is a gather, and a tap's A (below) is the slab read at a
// shifted row, 18 rows apart between output rows, which no wgmma
// descriptor (a uniform stride over 8-row groups) addresses.
//
// K11 in bf16 (kIm2col, conv3x3_im2col_mma_kernel): the TPU kernel's im2col
// patch and one product. Per chunk of 16 input channels, the patch
// [9 taps][128 pixels][16 ch] and its weights [9][16][64] are gathered by
// 16-byte cp.async (two stages in flight) into swizzled rows; per tap 2
// ldmatrix.x4 of A, 2 ldmatrix.x4.trans of B and 8 mma.sync. Bounded by 256
// bytes of ldmatrix per mma (above the SM's 128 bytes a clock at the tensor
// cores' peak), two blocks an SM, and the 9x copy of the input the patch
// makes.
//
// K12 in bf16 (kTaps, conv3x3_taps_mma_kernel): nine shifted tap products
// over a haloed slab, no 9x copy. Per chunk of 32 input channels the slab
// [10][18][32] (11.5 KB) and the weights [9][32][64] (36.9 KB) arrive by
// 16-byte cp.async with zero fill, then cp.async.wait_group 0 and a barrier
// (one stage: the TPU kernel waits on its DMA with no overlap). A block asks
// for 50,176 bytes of shared memory and ptxas gives it 123 registers a
// thread, no spills (sm_90a, CUDA 12.8), so two blocks fit an SM and the SM
// hides one block's loads behind the other's products. An m16 tile is
// one output row of 16 pixels, so tap (dy, dx)'s A rows are the 16
// consecutive slab rows (ph+dy)·18 + dx + 0..15: ldmatrix takes one row
// address a lane, and the shift is address arithmetic. Slab rows are 64
// bytes with the 16-byte granule XOR-ed with (row / 2) % 4, so the 8 rows of
// an ldmatrix matrix fall in distinct banks at any start row (a tap's view
// starts at row dx). Per k16 step and tap column dx a warp loads the four
// slab rows its two output rows meet (each serves up to three taps dy) and
// the three taps' B: 4 + 6 ldmatrix.x4 for 24 mma.sync, 213 bytes a product
// against K11's 256. Two k16 steps a tap halve the barriers per product.
//
// K13 in bf16 (kDoubleBuffer, conv3x3_ring_mma_kernel): K12's products and
// epilogue, the slab and weights in flight ahead of the products. The TPU
// kernel prefetched the next grid step's H tile; here a ring of three stages
// (48 KB each; 148,480 bytes a block with the alignment, so one block an SM;
// ptxas: 138 registers, no spills) with one mbarrier per stage: thread 0 issues
// the loads of step i+2 while the warps compute step i, and a stage is
// refilled only after the barrier that ends its use. The block is persistent
// (one per SM, output tiles blockIdx.x, + gridDim.x, ...; its steps are
// (tile, chunk) pairs), so the ring runs on across tiles and a tile's
// epilogue overlaps the next tile's loads. Routes, by shape:
//   - TMA, where Cin and Cout are multiples of 8 and x and w are 16-byte
//     aligned (TMA needs 16-byte global strides): the slab is one box
//     {32, 18, 10, 1} of a 4-D tiled map over x [N, H, W, Cin] at
//     (c_base, w0-1, h0-1, n), the weights one box {64, 32, 9} of a 3-D map
//     over w [9, Cin, Cout]; TMA zero-fills the halo and the ragged Cin and
//     Cout edges, and writes 64- and 128-byte swizzles that are the slab and
//     weight layouts above; completion arrives on the stage's mbarrier;
//   - cp.async, elsewhere: K12's loaders in a two-stage ring, 16-byte
//     granules where an operand allows them, else element by element.
// Where Cin or Cout is not a multiple of 8, or a pointer is not 16-byte
// aligned, K11 and K12 likewise load that operand element by element.
//
// K11, K12 and K13 in f32 (conv3x3_kernel<schedule>): the parity
// runs' bodies, scalar f32 FMAs on the CUDA cores; 256 threads, each owning
// 8 pixels of one row x 4 output channels, 16-channel chunks with the
// weights [9][16][64] in shared memory: the patch matrix (K11), the slab read
// at nine shifts (K12), the slab double-buffered by 4-byte cp.async (K13).
#include <climits>

#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"

namespace {

constexpr int kTH = 8, kTW = 16;  // output pixels per block
constexpr int kKB = 64;           // output channels per block
constexpr int kCC = 16;           // input channels per chunk (f32 bodies, K11 in bf16)
constexpr int kThreads = 256;
constexpr int kSH = kTH + 2, kSW = kTW + 2;
constexpr int kSlab = kSH * kSW * kCC;          // elements of a haloed slab
constexpr int kWts = 9 * kCC * kKB;             // elements of a weight chunk
constexpr int kPatch = kTH * kTW * 9 * kCC;     // elements of a patch matrix

enum Schedule { kIm2col = 0, kTaps = 1, kDoubleBuffer = 2 };

size_t smem_bytes(int sched) {
  const int elems = sched == kIm2col ? kPatch + kWts
                    : sched == kTaps ? kSlab + kWts
                                     : 2 * (kSlab + kWts);
  return sizeof(float) * (size_t)elems;
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

// ---- the f32 bodies ----

// Slab element e = ((sh * kSW) + sw) * kCC + c: input pixel (h0+sh-1, w0+sw-1).
__device__ __forceinline__ bool slab_src(const Geometry& g, const float* x, int c_base, int e,
                                         const float** src) {
  const int c = e % kCC, sw = (e / kCC) % kSW, sh = e / (kCC * kSW);
  const int h = g.h0 + sh - 1, w = g.w0 + sw - 1, ch = c_base + c;
  const bool in = h >= 0 && h < g.H && w >= 0 && w < g.W && ch < g.Cin;
  *src = in ? x + (((size_t)g.n * g.H + h) * g.W + w) * g.Cin + ch : x;
  return in;
}

// Weight element e = (tap * kCC + c) * kKB + k: w[tap, c_base + c, k_base + k].
__device__ __forceinline__ bool wts_src(const Geometry& g, const float* wt, int c_base, int e,
                                        const float** src) {
  const int k = e % kKB, c = (e / kKB) % kCC, tap = e / (kKB * kCC);
  const int ch = c_base + c, ko = g.k_base + k;
  const bool in = ch < g.Cin && ko < g.Cout;
  *src = in ? wt + ((size_t)tap * g.Cin + ch) * g.Cout + ko : wt;
  return in;
}

__device__ __forceinline__ void load_slab(const Geometry& g, const float* x, int c_base, float* slab) {
  for (int e = threadIdx.x; e < kSlab; e += kThreads) {
    const float* src;
    slab[e] = slab_src(g, x, c_base, e, &src) ? *src : 0.0f;
  }
}

__device__ __forceinline__ void load_wts(const Geometry& g, const float* wt, int c_base, float* w_s) {
  for (int e = threadIdx.x; e < kWts; e += kThreads) {
    const float* src;
    w_s[e] = wts_src(g, wt, c_base, e, &src) ? *src : 0.0f;
  }
}

// K13: the same copies as 4-byte cp.async granules (zero-filled outside).
__device__ __forceinline__ void issue_chunk(const Geometry& g, const float* x, const float* wt,
                                            int c_base, float* slab, float* w_s) {
  for (int e = threadIdx.x; e < kSlab; e += kThreads) {
    const float* src;
    const bool in = slab_src(g, x, c_base, e, &src);
    cp_async4(slab + e, src, in);
  }
  for (int e = threadIdx.x; e < kWts; e += kThreads) {
    const float* src;
    const bool in = wts_src(g, wt, c_base, e, &src);
    cp_async4(w_s + e, src, in);
  }
}

// The chunk's products: acc[i][j] += A[pixel i] · w_s[:, k0 + j], A read from
// the patch matrix (kIm2col) or from the slab shifted by the tap.
template <int kSched>
__device__ __forceinline__ void chunk_products(const float* a_s, const float* w_s, int ph, int pw0,
                                               int k0, float acc[8][4]) {
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll 4
    for (int c = 0; c < kCC; ++c) {
      float wv[4];
      mmb::load4(w_s + (tap * kCC + c) * kKB + k0, wv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = kSched == kIm2col ? a_s[(ph * kTW + pw0 + i) * (9 * kCC) + tap * kCC + c]
                                          : a_s[((ph + dy) * kSW + pw0 + i + dx) * kCC + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
      }
    }
  }
}

template <int kSched>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(
    const float* __restrict__ x,     // [N, H, W, Cin]
    const float* __restrict__ wt,    // [3, 3, Cin, Cout]
    const float* __restrict__ bias,  // [Cout]
    float* __restrict__ out,         // [N, H, W, Cout]
    int H, int W, int Cin, int Cout, int relu) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
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
    float* patch = smem;
    float* w_s = smem + kPatch;
    for (int c_base = 0; c_base < Cin; c_base += kCC) {
      __syncthreads();
      for (int e = tid; e < kPatch; e += kThreads) {
        const int c = e % kCC, tap = (e / kCC) % 9, pix = e / (kCC * 9);
        const int h = g.h0 + pix / kTW + tap / 3 - 1, w = g.w0 + pix % kTW + tap % 3 - 1;
        const int ch = c_base + c;
        patch[e] = (h >= 0 && h < H && w >= 0 && w < W && ch < Cin)
                       ? x[(((size_t)g.n * H + h) * W + w) * Cin + ch]
                       : 0.0f;
      }
      load_wts(g, wt, c_base, w_s);
      __syncthreads();
      chunk_products<kIm2col>(patch, w_s, ph, pw0, k0, acc);
    }
  } else if (kSched == kTaps) {
    float* slab = smem;
    float* w_s = smem + kSlab;
    for (int c_base = 0; c_base < Cin; c_base += kCC) {
      __syncthreads();
      load_slab(g, x, c_base, slab);
      load_wts(g, wt, c_base, w_s);
      __syncthreads();
      chunk_products<kTaps>(slab, w_s, ph, pw0, k0, acc);
    }
  } else {
    float* slab[2] = {smem, smem + kSlab};
    float* w_s[2] = {smem + 2 * kSlab, smem + 2 * kSlab + kWts};
    const int nchunks = (Cin + kCC - 1) / kCC;
    issue_chunk(g, x, wt, 0, slab[0], w_s[0]);
    cp_async_commit();
    for (int i = 0; i < nchunks; ++i) {
      // buffer (i+1)&1 was last read in iteration i-1, which ended in a barrier
      if (i + 1 < nchunks) issue_chunk(g, x, wt, (i + 1) * kCC, slab[(i + 1) & 1], w_s[(i + 1) & 1]);
      cp_async_commit();
      cp_async_wait_one();  // every group but the newest has landed: chunk i
      __syncthreads();
      chunk_products<kTaps>(slab[i & 1], w_s[i & 1], ph, pw0, k0, acc);
      __syncthreads();
    }
  }

  const int h = g.h0 + ph;
  if (h >= H) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int w = g.w0 + pw0 + i;
    if (w >= W) break;
    float* o = out + (((size_t)g.n * H + h) * W + w) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ko = g.k_base + k0 + j;
      if (ko >= Cout) break;
      float v = acc[i][j] + bias[ko];
      if (relu) v = fmaxf(v, 0.0f);
      o[ko] = v;
    }
  }
}

template <int kSched>
int launch_f32(const void* x, const void* w, const void* bias, void* out, int N, int H, int W,
               int Cin, int Cout, int relu, cudaStream_t s) {
  const size_t smem = smem_bytes(kSched);
  cudaError_t e = cudaFuncSetAttribute(conv3x3_kernel<kSched>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), N, (Cout + kKB - 1) / kKB);
  conv3x3_kernel<kSched><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), H, W, Cin, Cout, relu);
  return (int)cudaGetLastError();
}

// ---- the bf16 bodies, on the tensor cores ----
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kPix = kTH * kTW;        // 128 pixels: 8 m-tiles of 16
static_assert(kKB == 64 && kThreads == 256 && kPix == 128 && kTW == 16, "the warp grid below");

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[m][n][f] = 0.0f;
}

// Bias, ReLU, one cast, NHWC: warp (wm, wn) holds pixels wm*32 + m*16 + 0..15
// (pixel p is tile row p / 16, column p % 16) x output channels wn*32..+32;
// each thread writes channel pairs of 4 pixels.
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4], const Geometry& g,
                                           const float* __restrict__ bias, bf16* __restrict__ out,
                                           int wm, int wn, int lane, int relu) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = wm * 32 + m * 16 + (lane >> 2) + half * 8;
      const int h = g.h0 + p / kTW, w = g.w0 + p % kTW;
      if (h >= g.H || w >= g.W) continue;
      bf16* o = out + (((size_t)g.n * g.H + h) * g.W + w) * g.Cout;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int ko = g.k_base + wn * 32 + n * 8 + (lane & 3) * 2;
        if (ko >= g.Cout) continue;
        float v0 = acc[m][n][half * 2] + bias[ko];
        if (relu) v0 = fmaxf(v0, 0.0f);
        if (ko + 1 < g.Cout) {
          float v1 = acc[m][n][half * 2 + 1] + bias[ko + 1];
          if (relu) v1 = fmaxf(v1, 0.0f);
          if (g.Cout % 2 == 0) {
            *reinterpret_cast<unsigned*>(o + ko) = mmb::pack_bf16x2(v0, v1);
            continue;
          }
          o[ko + 1] = __float2bfloat16(v1);
        }
        o[ko] = __float2bfloat16(v0);
      }
    }
}

// ---- K11: the im2col patch ----
constexpr int kA = 9 * kPix * kCC;     // patch matrix [9 taps][kPix][kCC], swizzled
constexpr int kB = 9 * kCC * kKB;      // weights [9 taps][kCC][kKB], swizzled
constexpr size_t kSmemBytes = 2 * sizeof(bf16) * (kA + kB);  // two stages
static_assert(kCC == 16, "K11's chunk");

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
  zero(acc);

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
  store_tile(acc, g, bias, out, wm, wn, lane, relu);
}

// ---- K12 and K13: nine tap products over a haloed slab ----
constexpr int kTC = 32;                             // input channels per chunk
constexpr int kSlabRows = kSH * kSW;                // 180 rows of kTC channels (64 bytes)
constexpr int kSlabBytes = kSlabRows * kTC * 2;     // 11,520: one TMA box
constexpr int kWtsBytes = 9 * kTC * kKB * 2;        // 36,864: one TMA box
constexpr int kSlabSlot = 12 * 1024;                // the slab's room, whole 1024-byte units
constexpr int kStageBytes = kSlabSlot + kWtsBytes;  // 49,152; stages start 1024-aligned
constexpr int kRing = 3;                            // K13's stages
// Dynamic shared memory: the stages plus room to align the first to 1024
// bytes (the period of TMA's 128-byte swizzle, which it reads off the address).
constexpr size_t kTapsSmemBytes = 1024 + kStageBytes;
constexpr size_t kRingSmemBytes = 1024 + kRing * kStageBytes;
static_assert(kSlabBytes <= kSlabSlot && kWtsBytes % 1024 == 0, "stage layout");

// Slab element (row r = sh * kSW + sw, channel c): 64-byte rows, the 16-byte
// granule c / 8 XOR-ed with (r / 2) % 4 — TMA's 64-byte swizzle, under which
// any 8 consecutive rows of one granule fall in distinct banks.
__device__ __forceinline__ int slab_index(int r, int c) {
  return r * kTC + ((((c >> 3) ^ (r >> 1)) & 3) << 3) + (c & 7);
}

// Weight element (tap, channel c, output channel k): 128-byte rows, the
// granule k / 8 XOR-ed with c % 8 — TMA's 128-byte swizzle.
__device__ __forceinline__ int wts_index(int tap, int c, int k) {
  return (tap * kTC + c) * kKB + ((((k >> 3) ^ c) & 7) << 3) + (k & 7);
}

__device__ __forceinline__ bf16* align_1024(float4* p) {
  const unsigned s = mmb::smem_u32(p);
  return reinterpret_cast<bf16*>(reinterpret_cast<char*>(p) + (((s + 1023u) & ~1023u) - s));
}

// Output tile t: the output-channel block fastest, then the 8x16 pixel tile,
// then the image.
__device__ __forceinline__ Geometry tile_geometry(int t, int H, int W, int Cin, int Cout) {
  const int kblocks = (Cout + kKB - 1) / kKB, tiles_w = (W + kTW - 1) / kTW;
  const int tiles = ((H + kTH - 1) / kTH) * tiles_w;
  Geometry g;
  g.k_base = (t % kblocks) * kKB;
  t /= kblocks;
  g.n = t / tiles;
  g.h0 = ((t % tiles) / tiles_w) * kTH;
  g.w0 = ((t % tiles) % tiles_w) * kTW;
  g.H = H, g.W = W, g.Cin = Cin, g.Cout = Cout;
  return g;
}

// Chunk c_base of the slab and the weights into one stage by cp.async
// (16-byte granules, zero-filled outside the image and past Cin / Cout) or,
// for an operand that cannot take them, element by element.
__device__ __forceinline__ void load_taps_chunk(const Geometry& g, const bf16* x, const bf16* wt,
                                                int c_base, bool vec_x, bool vec_w, bf16* slab,
                                                bf16* w_s) {
  const int tid = threadIdx.x;
  const bf16 zero = __float2bfloat16(0.0f);
  if (vec_x) {
    for (int e = tid; e < kSlabRows * (kTC / 8); e += kThreads) {
      const int r = e >> 2, gc = (e & 3) * 8;
      const int h = g.h0 + r / kSW - 1, w = g.w0 + r % kSW - 1, ch = c_base + gc;
      const bool in = h >= 0 && h < g.H && w >= 0 && w < g.W && ch < g.Cin;
      const bf16* src = in ? x + (((size_t)g.n * g.H + h) * g.W + w) * g.Cin + ch : x;
      mmb::cp_async16(mmb::smem_u32(slab + slab_index(r, gc)), src, in);
    }
  } else {
    for (int e = tid; e < kSlabRows * kTC; e += kThreads) {
      const int r = e >> 5, c = e & (kTC - 1);
      const int h = g.h0 + r / kSW - 1, w = g.w0 + r % kSW - 1, ch = c_base + c;
      slab[slab_index(r, c)] = h >= 0 && h < g.H && w >= 0 && w < g.W && ch < g.Cin
                                   ? x[(((size_t)g.n * g.H + h) * g.W + w) * g.Cin + ch]
                                   : zero;
    }
  }
  if (vec_w) {
    for (int e = tid; e < 9 * kTC * (kKB / 8); e += kThreads) {
      const int gk = (e & 7) * 8, c = (e >> 3) & (kTC - 1), tap = e >> 8;
      const int ch = c_base + c, ko = g.k_base + gk;
      const bool in = ch < g.Cin && ko < g.Cout;
      const bf16* src = in ? wt + ((size_t)tap * g.Cin + ch) * g.Cout + ko : wt;
      mmb::cp_async16(mmb::smem_u32(w_s + wts_index(tap, c, gk)), src, in);
    }
  } else {
    for (int e = tid; e < 9 * kTC * kKB; e += kThreads) {
      const int k = e & (kKB - 1), c = (e >> 6) & (kTC - 1), tap = e >> 11;
      const int ch = c_base + c, ko = g.k_base + k;
      w_s[wts_index(tap, c, k)] =
          ch < g.Cin && ko < g.Cout ? wt[((size_t)tap * g.Cin + ch) * g.Cout + ko] : zero;
    }
  }
}

// One chunk's products for warp (wm, wn): output rows 2wm + m (m-tiles m =
// 0, 1) x output channels wn*32..+32. Tap (dy, dx) of m-tile m reads slab
// rows (2wm + m + dy)·kSW + dx + 0..15; per k16 step and dx, the A fragments
// of the four slab rows 2wm + 0..3 are loaded once and serve every (m, dy)
// with m + dy = their index.
__device__ __forceinline__ void taps_products(unsigned slab_base, unsigned w_base, int wm, int wn,
                                              int lane, float (&acc)[2][4][4]) {
#pragma unroll
  for (int ks = 0; ks < kTC / 16; ++ks)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      unsigned a[4][4], b[3][2][4];
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const int r = (2 * wm + r4) * kSW + dx + (lane & 15);
        mmb::ldmatrix_x4(a[r4], slab_base + 2 * slab_index(r, ks * 16 + (lane >> 4) * 8));
      }
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int np = 0; np < 2; ++np)
          mmb::ldmatrix_x4_trans(
              b[dy][np], w_base + 2 * wts_index(dy * 3 + dx, ks * 16 + (lane & 15),
                                                wn * 32 + np * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mmb::mma_bf16_16816(acc[m][2 * np], a[m + dy], b[dy][np][0], b[dy][np][1]);
            mmb::mma_bf16_16816(acc[m][2 * np + 1], a[m + dy], b[dy][np][2], b[dy][np][3]);
          }
    }
}

// K12: one tile a block, one stage.
__global__ void __launch_bounds__(kThreads, 2) conv3x3_taps_mma_kernel(
    const bf16* __restrict__ x,      // [N, H, W, Cin]
    const bf16* __restrict__ wt,     // [3, 3, Cin, Cout]
    const float* __restrict__ bias,  // [Cout]
    bf16* __restrict__ out,          // [N, H, W, Cout]
    int H, int W, int Cin, int Cout, int relu, int vec_x, int vec_w) {
  extern __shared__ float4 smem4[];
  bf16* slab = align_1024(smem4);
  bf16* w_s = slab + kSlabSlot / 2;
  const Geometry g = tile_geometry(blockIdx.x, H, W, Cin, Cout);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  float acc[2][4][4];
  zero(acc);
  for (int c_base = 0; c_base < Cin; c_base += kTC) {
    __syncthreads();  // every warp is done with the previous chunk
    load_taps_chunk(g, x, wt, c_base, vec_x, vec_w, slab, w_s);
    mmb::cp_async_commit_group();
    mmb::cp_async_wait_group<0>();
    __syncthreads();
    taps_products(mmb::smem_u32(slab), mmb::smem_u32(w_s), wm, wn, lane, acc);
  }
  store_tile(acc, g, bias, out, wm, wn, lane, relu);
}

// K13, thread 0: arm stage s's barrier with its bytes and load chunk c_base
// of tile g into the stage by TMA.
__device__ __forceinline__ void issue_tma(const CUtensorMap* x_map, const CUtensorMap* w_map,
                                          const Geometry& g, int c_base, bf16* slab, bf16* w_s,
                                          unsigned bar) {
  mmb::fence_proxy_async();
  mmb::mbar_arrive_expect_tx(bar, kSlabBytes + kWtsBytes);
  mmb::tma_load_4d(mmb::smem_u32(slab), x_map, bar, c_base, g.w0 - 1, g.h0 - 1, g.n);
  mmb::tma_load_3d(mmb::smem_u32(w_s), w_map, bar, g.k_base, c_base, 0);
}

// K13: persistent, a ring of kRing stages fed by TMA (use_tma) or of two
// stages fed by cp.async; step j of the block is chunk j % nchunks of its
// tile j / nchunks.
__global__ void __launch_bounds__(kThreads, 1) conv3x3_ring_mma_kernel(
    const __grid_constant__ CUtensorMap x_map,  // x [N, H, W, Cin]: box {kTC, kSW, kSH, 1}, 64B swizzle
    const __grid_constant__ CUtensorMap w_map,  // w [9, Cin, Cout]: box {kKB, kTC, 9}, 128B swizzle
    const bf16* __restrict__ x, const bf16* __restrict__ wt, const float* __restrict__ bias,
    bf16* __restrict__ out, int H, int W, int Cin, int Cout, int relu, int ntiles, int use_tma,
    int vec_x, int vec_w) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long full[kRing];  // one mbarrier a stage
  bf16* ring = align_1024(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int nchunks = (Cin + kTC - 1) / kTC;
  const int nsteps = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * nchunks;
  auto slab = [&](int s) { return ring + s * (kStageBytes / 2); };
  auto wts = [&](int s) { return ring + s * (kStageBytes / 2) + kSlabSlot / 2; };
  auto geometry = [&](int j) {
    return tile_geometry((int)blockIdx.x + (j / nchunks) * (int)gridDim.x, H, W, Cin, Cout);
  };
  auto issue = [&](int j) {
    const int s = j % kRing;
    issue_tma(&x_map, &w_map, geometry(j), (j % nchunks) * kTC, slab(s), wts(s),
              mmb::smem_u32(&full[s]));
  };

  if (use_tma) {
    if (tid == 0) {
      for (int s = 0; s < kRing; ++s) mmb::mbar_init(mmb::smem_u32(&full[s]), 1);
      mmb::fence_mbarrier_init();
    }
    __syncthreads();
    if (tid == 0)
      for (int j = 0; j < kRing - 1 && j < nsteps; ++j) issue(j);
  } else {
    load_taps_chunk(geometry(0), x, wt, 0, vec_x, vec_w, slab(0), wts(0));
    mmb::cp_async_commit_group();
  }
  float acc[2][4][4];
  zero(acc);
  for (int j = 0; j < nsteps; ++j) {
    int s;
    if (use_tma) {
      s = j % kRing;
      __syncthreads();  // every warp is done with step j-1, whose stage step j+2 refills
      if (tid == 0 && j + kRing - 1 < nsteps) issue(j + kRing - 1);
      mmb::mbar_wait(mmb::smem_u32(&full[s]), (j / kRing) & 1);
    } else {
      s = j & 1;
      mmb::cp_async_wait_group<0>();
      __syncthreads();  // step j has landed; every warp is done with step j-1's stage
      if (j + 1 < nsteps)
        load_taps_chunk(geometry(j + 1), x, wt, ((j + 1) % nchunks) * kTC, vec_x, vec_w,
                        slab(s ^ 1), wts(s ^ 1));
      mmb::cp_async_commit_group();
    }
    taps_products(mmb::smem_u32(slab(s)), mmb::smem_u32(wts(s)), wm, wn, lane, acc);
    if (j % nchunks == nchunks - 1) {
      store_tile(acc, geometry(j), bias, out, wm, wn, lane, relu);
      zero(acc);
    }
  }
}

// 16-byte cp.async granules (and TMA's 16-byte global strides) need a
// dimension that is a multiple of 8 and a 16-byte aligned base.
bool vec_ok(const void* p, int inner) {
  return inner % 8 == 0 && reinterpret_cast<size_t>(p) % 16 == 0;
}

// K13's route: TMA where both operands allow it, else the cp.async ring.
bool tma_route(const void* x, const void* w, int Cin, int Cout) {
  return vec_ok(x, Cin) && vec_ok(w, Cout);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tiled bf16 map over `base` (dims and box innermost first, strides of
// dims 1.. in bytes); false if cuTensorMapEncodeTiled refuses it.
bool encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  static const EncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) ==
                       cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(fn)
               : nullptr;
  }();
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_im2col(const void* x, const void* w, const void* bias, void* out, int N, int H, int W,
                  int Cin, int Cout, int relu, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(conv3x3_im2col_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), N, (Cout + kKB - 1) / kKB);
  conv3x3_im2col_mma_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), H, W, Cin, Cout, relu, vec_ok(x, Cin), vec_ok(w, Cout));
  return (int)cudaGetLastError();
}

int launch_taps(const void* x, const void* w, const void* bias, void* out, int H, int W, int Cin,
                int Cout, int relu, int ntiles, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(conv3x3_taps_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kTapsSmemBytes);
  if (e != cudaSuccess) return (int)e;
  conv3x3_taps_mma_kernel<<<ntiles, kThreads, kTapsSmemBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), H, W, Cin, Cout, relu, vec_ok(x, Cin), vec_ok(w, Cout));
  return (int)cudaGetLastError();
}

int launch_ring(const void* x, const void* w, const void* bias, void* out, int N, int H, int W,
                int Cin, int Cout, int relu, int ntiles, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(conv3x3_ring_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kRingSmemBytes);
  if (e != cudaSuccess) return (int)e;
  int dev, sms, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_ring_mma_kernel, kThreads,
                                                         kRingSmemBytes)) != cudaSuccess)
    return (int)e;
  const int grid = ntiles < sms * per_sm ? ntiles : sms * per_sm;
  CUtensorMap x_map{}, w_map{};
  const bool use_tma = tma_route(x, w, Cin, Cout);
  if (use_tma) {
    const cuuint64_t es = sizeof(bf16);
    const cuuint64_t x_dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t x_strides[3] = {es * Cin, es * Cin * W, es * Cin * W * H};
    const cuuint32_t x_box[4] = {kTC, kSW, kSH, 1};
    const cuuint64_t w_dims[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9};
    const cuuint64_t w_strides[2] = {es * Cout, es * Cout * Cin};
    const cuuint32_t w_box[3] = {kKB, kTC, 9};
    if (!encode_map(&x_map, x, 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_64B) ||
        !encode_map(&w_map, w, 3, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  }
  conv3x3_ring_mma_kernel<<<grid, kThreads, kRingSmemBytes, s>>>(
      x_map, w_map, static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W, Cin, Cout, relu, ntiles,
      use_tma, vec_ok(x, Cin), vec_ok(w, Cout));
  return (int)cudaGetLastError();
}

}  // namespace tc

int dispatch_bf16(int sched, const void* x, const void* w, const void* bias, void* out, int N,
                  int H, int W, int Cin, int Cout, int relu, cudaStream_t s) {
  if (sched == kIm2col) return tc::launch_im2col(x, w, bias, out, N, H, W, Cin, Cout, relu, s);
  const long long ntiles = (long long)N * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW) *
                           ((Cout + kKB - 1) / kKB);
  if (ntiles > INT_MAX) return (int)cudaErrorInvalidValue;
  if (sched == kTaps) return tc::launch_taps(x, w, bias, out, H, W, Cin, Cout, relu, (int)ntiles, s);
  if (sched == kDoubleBuffer)
    return tc::launch_ring(x, w, bias, out, N, H, W, Cin, Cout, relu, (int)ntiles, s);
  return (int)cudaErrorInvalidValue;
}

int dispatch_f32(int sched, const void* x, const void* w, const void* bias, void* out, int N, int H,
                 int W, int Cin, int Cout, int relu, cudaStream_t s) {
  switch (sched) {
    case kIm2col: return launch_f32<kIm2col>(x, w, bias, out, N, H, W, Cin, Cout, relu, s);
    case kTaps: return launch_f32<kTaps>(x, w, bias, out, N, H, W, Cin, Cout, relu, s);
    case kDoubleBuffer: return launch_f32<kDoubleBuffer>(x, w, bias, out, N, H, W, Cin, Cout, relu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [N, H, W, Cin], w [3, 3, Cin, Cout] (T = bf16 if bf16 else f32), bias
// [Cout] f32 -> out [N, H, W, Cout] T; schedule 0 = K11, 1 = K12, 2 = K13.
MMB_API int mmb_conv3x3(const void* x, const void* w, const void* bias, void* out, int N, int H,
                        int W, int Cin, int Cout, int relu, int bf16, int schedule, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || N > 65535 ||
      (Cout + kKB - 1) / kKB > 65535)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_bf16(schedule, x, w, bias, out, N, H, W, Cin, Cout, relu, s)
              : dispatch_f32(schedule, x, w, bias, out, N, H, W, Cin, Cout, relu, s);
}

// 1 if K13 in bf16 takes its TMA route for these operands, 0 if the cp.async one.
MMB_API int mmb_conv3x3_tma_route(const void* x, const void* w, int Cin, int Cout) {
  return tc::tma_route(x, w, Cin, Cout) ? 1 : 0;
}

// Dynamic shared memory of a block of each bf16 (tensor-core) body, in bytes:
// K11's, K12's and K13's.
MMB_API int mmb_conv3x3_mma_smem_bytes() { return (int)tc::kSmemBytes; }
MMB_API int mmb_conv3x3_taps_smem_bytes() { return (int)tc::kTapsSmemBytes; }
MMB_API int mmb_conv3x3_ring_smem_bytes() { return (int)tc::kRingSmemBytes; }
