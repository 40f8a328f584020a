// K14 — Winograd F(2x2,3x3) 3x3/stride-1/SAME conv + bias (+ ReLU), NHWC.
//
// Replaces: mmbidaf_tpu/ops/pallas/winograd_kernel.py::_wino_kernel (entry
// point winograd_conv3x3_fused). Contract (ops/winograd.py), for each 2x2
// output tile and its 4x4 input patch d (zero outside the image):
//   V[p][q] = (Bᵀ d B)[p][q] in f32, along W then H, rounded to T
//   M[p][q] = sum over C of V[p][q] * U[p][q]  (U = G g Gᵀ, rounded to T by
//             the wrapper), products and sums in f32
//   Y = Aᵀ M A (along W then H) + bias, ReLU, one cast to T.
// T is float or __nv_bfloat16, the compute dtype.
//
// What bounds it on the H100: the 16 transform-point products, 16/36 of the
// direct conv's multiply-adds (6.8 GMAC a 224² frame over VGG-16's twelve
// convs with C_in >= 32): operations, at the tensor cores' 989 TFLOP/s for
// the bf16 operands of the serving path. Bytes: x and the output once, U
// (at most 8 MB) from L2.
//
// bf16 (the serving path): 16 GEMMs M[pq] = V[pq] · U[pq] on the tensor
// cores, mma.sync m16n8k16 (bf16 operands, f32 accumulators; mma.cuh).
// mma.sync and not wgmma: each warp owns one transform point, so the 16
// products of a block are 16 independent warp-sized GEMMs whose A operand
// the block forms itself each chunk; wgmma's 64-row warpgroup tiles would
// put four warps on one point and need V in its swizzled descriptor layout.
// One block of 16 warps per (group of 32 output tiles, 64 output channels);
// tiles are numbered over N x ceil(H/2) x ceil(W/2), so a group may span
// rows and images and no block idles on a 14x14 layer. Loop over chunks of
// 32 input channels, two stages:
//   1. cp.async brings the next chunk's 4x4 patches ([16 pixels][32 tiles]
//      [32 ch], 16-byte granules of 8 channels, zero fill at the halo and
//      the C edge) and U's chunk ([16 points][32 ch][64 out], rows swizzled
//      so ldmatrix reads them without bank conflicts) while this chunk runs;
//   2. each thread forms V for one tile and two channels in f32 on the CUDA
//      cores, in the JAX order, rounds it to bf16 and stores it as the A
//      operand [16 points][32 tiles][32 ch] (swizzled); V is formed once per
//      64 output channels (the scalar body formed it once per 32);
//   3. warp w multiplies V[w] [32 x 32] by U[w] [32 x 64]: per 16 channels
//      2 ldmatrix.x4 of A, 4 ldmatrix.x4.trans of B, 16 mma; its [32 x 64]
//      f32 sums stay in 64 registers a thread across the whole C loop.
// The output-channel blocks of a tile group are neighbours in the grid, so
// its patches come from L2 after the first. What bounds this design: the
// accumulators. 16 points x 32 tiles x 64 channels of f32 sums are half an
// SM's registers, so one block of 512 threads (128 registers each) fills
// an SM, and nothing hides its two barriers a chunk, its wait for the next
// chunk's loads and its epilogue: the CUDA-core transform and the products
// of a chunk run between barriers rather than beside each other. B
// fragments cost 192 bytes of ldmatrix per m16n8k16, above the SM's 128
// bytes a clock at the tensor cores' peak. Three alternatives were no
// faster on the H100: U shared across a 2-block cluster through distributed
// shared memory (half its L2 traffic, but a cluster barrier a chunk), the
// patches' overlapping columns loaded once, and 16-channel chunks with
// three or four stages in flight and V double-buffered (one barrier a
// chunk). The kernel is held by latency, not by bytes. Epilogue: the 16 points' sums meet in shared memory (f32);
// A along W, then along H, the bias, the ReLU and the cast are applied as
// each output pixel is written, once, NHWC, coalesced over output channels.
// Where C or K is not a multiple of 8 (or a pointer is not 16-byte
// aligned), the same kernel loads that operand element by element.
//
// f32 (the parity runs only): the scalar body of the first port. One block
// per (32 output tiles, 32 output channels), 16-channel chunks; V to shared
// memory in f32, each of 256 threads owns one H point p, 4 tiles and 4
// output channels and keeps its 4 W points' sums in 64 f32 registers (8
// float4 loads feed 64 FMAs a channel); A along W in registers, the partial
// rows meet in shared memory, A along H, bias, ReLU as each pixel is
// written. Both bodies mask the image edge and the last channel block;
// nothing is padded or copied around the kernel.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTT = 32;       // output tiles (2x2 pixels) per block
constexpr int kKB = 32;       // output channels per block
constexpr int kCC = 16;       // input channels per chunk
constexpr int kVS = kTT + 4;  // V row stride: float4-aligned, fewer bank conflicts on the stores
constexpr int kPS = kKB + 1;  // epilogue row stride
constexpr int kThreads = 256;
constexpr size_t kSmemBytes = sizeof(float) * 16 * kCC * (kKB + kVS);
static_assert(sizeof(float) * 4 * 2 * kTT * kPS <= kSmemBytes, "epilogue reuses the chunk buffers");

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) winograd_kernel(
    const T* __restrict__ x,         // [N, H, W, C]
    const T* __restrict__ u,         // [16, C, K], point p*4+q
    const float* __restrict__ bias,  // [K]
    T* __restrict__ out,             // [N, H, W, K]
    int N, int H, int W, int C, int K, int relu) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* u_s = smem;                  // [16][kCC][kKB]
  float* v_s = u_s + 16 * kCC * kKB;  // [16][kCC][kVS]
  const int tid = threadIdx.x;
  const int nh = (H + 1) / 2, nw = (W + 1) / 2;
  const long long per_image = (long long)nh * nw;
  const long long ntiles = (long long)N * per_image;
  const long long tile0 = (long long)blockIdx.x * kTT;
  const int k_base = blockIdx.y * kKB;

  // Product role: H point p, tiles t0..t0+3, output channels k0..k0+3.
  const int p = tid >> 6;
  const int t0 = ((tid >> 3) & 7) * 4;
  const int k0 = (tid & 7) * 4;

  float acc[4][4][4];  // [W point q][tile][output channel]
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.0f;

  for (int c_base = 0; c_base < C; c_base += kCC) {
    __syncthreads();  // the previous chunk's products are done with u_s / v_s
    for (int e = tid; e < kTT * kCC; e += kThreads) {
      const int c = e % kCC, t = e / kCC;
      const long long g = tile0 + t;
      const int ch = c_base + c;
      float d[4][4];
      if (g < ntiles && ch < C) {
        const int n = (int)(g / per_image);
        const int r = (int)(g - n * per_image);
        const int h0 = 2 * (r / nw) - 1, w0 = 2 * (r % nw) - 1;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int h = h0 + i, w = w0 + j;
            d[i][j] = (h >= 0 && h < H && w >= 0 && w < W)
                          ? mmb::to_f32(x[(((size_t)n * H + h) * W + w) * C + ch])
                          : 0.0f;
          }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) d[i][j] = 0.0f;
      }
      float tq[4][4];  // Bᵀ along W: [row i][W point q]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tq[i][0] = d[i][0] - d[i][2];
        tq[i][1] = d[i][1] + d[i][2];
        tq[i][2] = d[i][2] - d[i][1];
        tq[i][3] = d[i][1] - d[i][3];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // Bᵀ along H, then the rounding to T
        float* vq = v_s + (size_t)q * kCC * kVS + c * kVS + t;
        vq[(0 * 4) * kCC * kVS] = mmb::round_to<T>(tq[0][q] - tq[2][q]);
        vq[(1 * 4) * kCC * kVS] = mmb::round_to<T>(tq[1][q] + tq[2][q]);
        vq[(2 * 4) * kCC * kVS] = mmb::round_to<T>(tq[2][q] - tq[1][q]);
        vq[(3 * 4) * kCC * kVS] = mmb::round_to<T>(tq[1][q] - tq[3][q]);
      }
    }
    for (int e = tid; e < 16 * kCC * kKB; e += kThreads) {
      const int k = e % kKB, c = (e / kKB) % kCC, pq = e / (kKB * kCC);
      const int ch = c_base + c, ko = k_base + k;
      u_s[e] = (ch < C && ko < K) ? mmb::to_f32(u[((size_t)pq * C + ch) * K + ko]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kCC; ++c) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[4], w[4];
        mmb::load4(v_s + ((p * 4 + q) * kCC + c) * kVS + t0, v);
        mmb::load4(u_s + ((p * 4 + q) * kCC + c) * kKB + k0, w);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[q][i][j] = fmaf(v[i], w[j], acc[q][i][j]);
      }
    }
  }

  // A along W (the q axis) in registers: P[p][y1] rows to shared memory.
  __syncthreads();
  float* p_s = smem;  // [4 p][2 y1][kTT][kPS]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float m0 = acc[0][i][j], m1 = acc[1][i][j], m2 = acc[2][i][j], m3 = acc[3][i][j];
      p_s[((p * 2 + 0) * kTT + t0 + i) * kPS + k0 + j] = (m0 + m1) + m2;
      p_s[((p * 2 + 1) * kTT + t0 + i) * kPS + k0 + j] = (m1 - m2) - m3;
    }
  __syncthreads();
  // A along H, bias, ReLU, cast: one write of each output pixel.
  for (int e = tid; e < kTT * 4 * kKB; e += kThreads) {
    const int k = e % kKB, y = (e / kKB) & 3, t = e / (4 * kKB);
    const int y0 = y >> 1, y1 = y & 1;
    const long long g = tile0 + t;
    const int ko = k_base + k;
    if (g >= ntiles || ko >= K) continue;
    const int n = (int)(g / per_image);
    const int r = (int)(g - n * per_image);
    const int h = 2 * (r / nw) + y0, w = 2 * (r % nw) + y1;
    if (h >= H || w >= W) continue;
    const float* pc = p_s + (y1 * kTT + t) * kPS + k;  // + p * 2 * kTT * kPS
    const int ps = 2 * kTT * kPS;
    float val = y0 == 0 ? (pc[0] + pc[ps]) + pc[2 * ps] : (pc[ps] - pc[2 * ps]) - pc[3 * ps];
    val += bias[ko];
    if (relu) val = fmaxf(val, 0.0f);
    mmb::store_f32(out + (((size_t)n * H + h) * W + w) * K + ko, val);
  }
}

template <typename T>
int launch(const void* x, const void* u, const void* bias, void* out, int N, int H, int W, int C,
           int K, int relu, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(winograd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (long long)N * ((H + 1) / 2) * ((W + 1) / 2);
  const dim3 grid((unsigned)((ntiles + kTT - 1) / kTT), (K + kKB - 1) / kKB);
  winograd_kernel<T><<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(u), static_cast<const float*>(bias),
      static_cast<T*>(out), N, H, W, C, K, relu);
  return (int)cudaGetLastError();
}

// ---- bf16: the tensor-core body ----
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kTT = 32;        // output tiles per block: 2 m-tiles of 16
constexpr int kKB = 64;        // output channels per block: 8 n-tiles of 8
constexpr int kCC = 32;        // input channels per chunk: 2 k-steps of 16
constexpr int kThreads = 512;  // 16 warps; warp w owns transform point w
constexpr int kRaw = 16 * kTT * kCC;  // patches [16 pixels][kTT][kCC]
constexpr int kU = 16 * kCC * kKB;    // U chunk [16 points][kCC][kKB], swizzled
constexpr int kV = 16 * kTT * kCC;    // V chunk [16 points][kTT][kCC], swizzled
constexpr int kMS = kKB + 8;          // epilogue row stride (f32): no bank conflicts
constexpr size_t kBufBytes = sizeof(bf16) * (2 * kRaw + 2 * kU + kV);
constexpr size_t kSmemBytes = kBufBytes + sizeof(int) * (16 * kTT + kTT);
static_assert(kSmemBytes <= mmb::kMaxSmemBytes, "two stages fit one SM");
static_assert(sizeof(float) * 16 * kTT * kMS <= kBufBytes, "epilogue reuses the chunk buffers");

// Element (point pq, tile t, channel c) of V: 64-byte rows, the 16-byte
// granule XOR-ed with (t / 2) % 4, so the 8 rows an ldmatrix reads and the
// two rows a warp stores fall in distinct banks.
__device__ __forceinline__ int v_index(int pq, int t, int c) {
  return (pq * kTT + t) * kCC + ((((c >> 3) ^ (t >> 1)) & 3) << 3) + (c & 7);
}

// Element (point pq, channel c, output channel k) of U: 128-byte rows, the
// granule XOR-ed with c % 8.
__device__ __forceinline__ int u_index(int pq, int c, int k) {
  return (pq * kCC + c) * kKB + ((((k >> 3) ^ c) & 7) << 3) + (k & 7);
}

// Chunk c_base of the patches (element (pixel j, tile t, channel c) at
// (j * kTT + t) * kCC + c) and of U into one stage. hw_s / n_s: the
// in-image pixel (h * W + w, or -1 in the halo) of each patch pixel and the
// image of each tile.
__device__ __forceinline__ void load_chunk(const bf16* x, const bf16* u, const int* hw_s,
                                           const int* n_s, int H, int W, int C, int K, int k_base,
                                           int c_base, bool vec_x, bool vec_u, bf16* raw, bf16* us) {
  const int tid = threadIdx.x;
  const bf16 zero = __float2bfloat16(0.0f);
  if (vec_x) {  // granule e = tid + i * kThreads: 8 channels of pixel j of tile t
    const int g = tid & 3, t = (tid >> 2) & (kTT - 1), ch = c_base + g * 8;
    const bf16* xt = x + (size_t)max(n_s[t], 0) * H * W * C + ch;
#pragma unroll
    for (int i = 0; i < kRaw / 8 / kThreads; ++i) {
      const int j = (tid >> 7) + i * (kThreads >> 7);
      const int hw = hw_s[t * 16 + j];
      const bool in = hw >= 0 && ch < C;
      mmb::cp_async16(mmb::smem_u32(raw + (j * kTT + t) * kCC + g * 8),
                      in ? xt + (size_t)hw * C : x, in);
    }
  } else {
    for (int e = tid; e < kRaw; e += kThreads) {
      const int c = e & (kCC - 1), t = (e >> 5) & (kTT - 1), j = e >> 10;
      const int hw = hw_s[t * 16 + j], ch = c_base + c;
      raw[e] = hw >= 0 && ch < C ? x[((size_t)n_s[t] * H * W + hw) * C + ch] : zero;
    }
  }
  if (vec_u) {  // granule e = tid + i * kThreads: 8 output channels of (point pq, channel c)
    const int g = tid & 7, c = (tid >> 3) & (kCC - 1), ch = c_base + c, ko = k_base + g * 8;
    const bool in = ch < C && ko < K;
    const size_t pq_stride = (size_t)(kThreads >> 8) * C * K;
    const bf16* src = u + ((size_t)(tid >> 8) * C + ch) * K + ko;
#pragma unroll
    for (int i = 0; i < kU / 8 / kThreads; ++i) {
      const int pq = (tid >> 8) + i * (kThreads >> 8);
      mmb::cp_async16(mmb::smem_u32(us + u_index(pq, c, g * 8)), in ? src + i * pq_stride : u, in);
    }
  } else {
    for (int e = tid; e < kU; e += kThreads) {
      const int k = e & (kKB - 1), c = (e >> 6) & (kCC - 1), pq = e >> 11;
      const int ch = c_base + c, ko = k_base + k;
      us[u_index(pq, c, k)] = ch < C && ko < K ? u[((size_t)pq * C + ch) * K + ko] : zero;
    }
  }
}

// V = Bᵀ d B for one tile and two channels, in f32 as the JAX code forms it
// (along W, then along H), rounded to bf16, into the A operand. One W point
// q at a time, so that few values are live beside the accumulators.
__device__ __forceinline__ void input_transform(const bf16* raw, bf16* vs) {
  const int t = threadIdx.x >> 4, c = (threadIdx.x & 15) * 2;
  unsigned* v = reinterpret_cast<unsigned*>(vs);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // Bᵀ along W: W point q is column j0 + column j1 (q = 1) or j0 - j1.
    const int j0 = q == 0 ? 0 : q == 2 ? 2 : 1;
    const int j1 = q == 0 || q == 1 ? 2 : q == 2 ? 1 : 3;
    float2 tq[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 d0 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(raw + ((i * 4 + j0) * kTT + t) * kCC + c));
      const float2 d1 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(raw + ((i * 4 + j1) * kTT + t) * kCC + c));
      tq[i] = q == 1 ? make_float2(d0.x + d1.x, d0.y + d1.y) : make_float2(d0.x - d1.x, d0.y - d1.y);
    }
    // Bᵀ along H, the rounding to bf16, the store.
    v[v_index(0 * 4 + q, t, c) >> 1] = mmb::pack_bf16x2(tq[0].x - tq[2].x, tq[0].y - tq[2].y);
    v[v_index(1 * 4 + q, t, c) >> 1] = mmb::pack_bf16x2(tq[1].x + tq[2].x, tq[1].y + tq[2].y);
    v[v_index(2 * 4 + q, t, c) >> 1] = mmb::pack_bf16x2(tq[2].x - tq[1].x, tq[2].y - tq[1].y);
    v[v_index(3 * 4 + q, t, c) >> 1] = mmb::pack_bf16x2(tq[1].x - tq[3].x, tq[1].y - tq[3].y);
  }
}

__global__ void __launch_bounds__(kThreads, 1) winograd_mma_kernel(
    const bf16* __restrict__ x,      // [N, H, W, C]
    const bf16* __restrict__ u,      // [16, C, K], point p*4+q
    const float* __restrict__ bias,  // [K]
    bf16* __restrict__ out,          // [N, H, W, K]
    int N, int H, int W, int C, int K, int relu, int vec_x, int vec_u) {
  extern __shared__ float4 smem4[];
  bf16* raw_s = reinterpret_cast<bf16*>(smem4);  // 2 stages of kRaw
  bf16* u_s = raw_s + 2 * kRaw;                  // 2 stages of kU
  bf16* v_s = u_s + 2 * kU;
  int* hw_s = reinterpret_cast<int*>(v_s + kV);  // [kTT][16 pixels]
  int* n_s = hw_s + 16 * kTT;                    // [kTT]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nh = (H + 1) / 2, nw = (W + 1) / 2;
  const long long per_image = (long long)nh * nw;
  const long long ntiles = (long long)N * per_image;
  // Output-channel blocks are the fast grid index, so the blocks that share
  // a tile group run together and read its patches from L2, not DRAM.
  const int nkb = (K + kKB - 1) / kKB;
  const long long tile0 = (long long)(blockIdx.x / nkb) * kTT;
  const int k_base = (blockIdx.x % nkb) * kKB;

  {  // the patch table: thread = (tile t, pixel j)
    const int t = tid >> 4, j = tid & 15;
    const long long g = tile0 + t;
    int hw = -1, n = -1;
    if (g < ntiles) {
      n = (int)(g / per_image);
      const int r = (int)(g - n * per_image);
      const int h = 2 * (r / nw) - 1 + (j >> 2), w = 2 * (r % nw) - 1 + (j & 3);
      if (h >= 0 && h < H && w >= 0 && w < W) hw = h * W + w;
    }
    hw_s[tid] = hw;
    if (j == 0) n_s[t] = n;
  }
  __syncthreads();

  float acc[2][8][4];  // [m-tile][n-tile][fragment]: point `warp`, 32 tiles x 64 channels
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[m][n][f] = 0.0f;

  const int nchunks = (C + kCC - 1) / kCC;
  load_chunk(x, u, hw_s, n_s, H, W, C, K, k_base, 0, vec_x, vec_u, raw_s, u_s);
  mmb::cp_async_commit_group();
  const unsigned v_base = mmb::smem_u32(v_s + warp * kTT * kCC);
  for (int i = 0; i < nchunks; ++i) {
    const int st = i & 1;
    mmb::cp_async_wait_group<0>();
    // chunk i has landed; every thread is done with chunk i-1's V and stage
    __syncthreads();
    if (i + 1 < nchunks)
      load_chunk(x, u, hw_s, n_s, H, W, C, K, k_base, (i + 1) * kCC, vec_x, vec_u,
                 raw_s + (st ^ 1) * kRaw, u_s + (st ^ 1) * kU);
    mmb::cp_async_commit_group();
    input_transform(raw_s + st * kRaw, v_s);
    __syncthreads();
    const unsigned u_base = mmb::smem_u32(u_s + st * kU + warp * kCC * kKB);
#pragma unroll
    for (int ks = 0; ks < kCC / 16; ++ks) {
      // Every fragment of the k-step first, then its 16 products: the
      // loads are in flight together rather than one before each pair.
      unsigned a[2][4], b[4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int row = m * 16 + (lane & 15), gr = ks * 2 + (lane >> 4);
        mmb::ldmatrix_x4(a[m], v_base + row * (kCC * 2) + (((gr ^ (row >> 1)) & 3) << 4));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int row = ks * 16 + (lane & 15), gr = np * 2 + (lane >> 4);
        mmb::ldmatrix_x4_trans(b[np], u_base + row * (kKB * 2) + (((gr ^ row) & 7) << 4));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mmb::mma_bf16_16816(acc[m][2 * np], a[m], b[np][0], b[np][1]);
          mmb::mma_bf16_16816(acc[m][2 * np + 1], a[m], b[np][2], b[np][3]);
        }
    }
  }

  // The 16 points' sums meet in shared memory: M[pq][tile][k] in f32.
  __syncthreads();
  float* m_s = reinterpret_cast<float*>(smem4);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int r = m * 16 + (lane >> 2), col = n * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(m_s + (warp * kTT + r) * kMS + col) =
          make_float2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<float2*>(m_s + (warp * kTT + r + 8) * kMS + col) =
          make_float2(acc[m][n][2], acc[m][n][3]);
    }
  __syncthreads();
  // A along W, then along H, bias, ReLU, cast: one write of each output pixel.
  for (int e = tid; e < kTT * kKB; e += kThreads) {
    const int k = e & (kKB - 1), t = e / kKB;
    const long long g = tile0 + t;
    const int ko = k_base + k;
    if (g >= ntiles || ko >= K) continue;
    float pr[4][2];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float* mp = m_s + (p * 4 * kTT + t) * kMS + k;
      const float m0 = mp[0], m1 = mp[kTT * kMS], m2 = mp[2 * kTT * kMS], m3 = mp[3 * kTT * kMS];
      pr[p][0] = (m0 + m1) + m2;
      pr[p][1] = (m1 - m2) - m3;
    }
    const int n = n_s[t];
    const int r = (int)(g - n * per_image);
    const int h0 = 2 * (r / nw), w0 = 2 * (r % nw);
    const float bk = bias[ko];
#pragma unroll
    for (int y0 = 0; y0 < 2; ++y0)
#pragma unroll
      for (int y1 = 0; y1 < 2; ++y1) {
        const int h = h0 + y0, w = w0 + y1;
        if (h >= H || w >= W) continue;
        float val = y0 == 0 ? (pr[0][y1] + pr[1][y1]) + pr[2][y1]
                            : (pr[1][y1] - pr[2][y1]) - pr[3][y1];
        val += bk;
        if (relu) val = fmaxf(val, 0.0f);
        out[(((size_t)n * H + h) * W + w) * K + ko] = __float2bfloat16(val);
      }
  }
}

int launch(const void* x, const void* u, const void* bias, void* out, int N, int H, int W, int C,
           int K, int relu, cudaStream_t s) {
  if ((long long)H * W >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(winograd_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const bool vec_x = C % 8 == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  const bool vec_u = K % 8 == 0 && reinterpret_cast<size_t>(u) % 16 == 0;
  const long long ntiles = (long long)N * ((H + 1) / 2) * ((W + 1) / 2);
  const long long blocks = (ntiles + kTT - 1) / kTT * ((K + kKB - 1) / kKB);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  winograd_mma_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(u), static_cast<const float*>(bias),
      static_cast<bf16*>(out), N, H, W, C, K, relu, vec_x, vec_u);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x [N, H, W, C], u [16, C, K] (T = bf16 if bf16 else f32), bias [K] f32 ->
// out [N, H, W, K] T. bf16 runs the tensor-core body, f32 the scalar one.
MMB_API int mmb_winograd_conv3x3(const void* x, const void* u, const void* bias, void* out, int N,
                                 int H, int W, int C, int K, int relu, int bf16, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)N * ((H + 1) / 2) * ((W + 1) / 2) / kTT >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? tc::launch(x, u, bias, out, N, H, W, C, K, relu, s)
              : launch<float>(x, u, bias, out, N, H, W, C, K, relu, s);
}

// Dynamic shared memory of a block of the bf16 (tensor-core) body, in bytes.
MMB_API int mmb_winograd_mma_smem_bytes() { return (int)tc::kSmemBytes; }
