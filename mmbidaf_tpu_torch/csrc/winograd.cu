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
// convs with C_in >= 32): operations. Their operands are bf16 on the serving
// path, so the bound counts the tensor cores' rate; this first kernel runs
// them as f32 FMAs on the CUDA cores (67 TFLOP/s), and moving them to
// mma/wgmma is its later work. Bytes: x read once per output-channel block,
// the output written once, U (at most 8 MB) from L2.
// Design: one block per (group of 32 output tiles, 32 output channels).
// Tiles are numbered over N x ceil(H/2) x ceil(W/2), so a group may span
// rows and images and no block idles on a 14x14 layer. Loop over chunks of
// 16 input channels:
//   1. each (tile, channel) pair reads its 4x4 patch (coalesced over
//      channels), forms V as the JAX code does, rounds it to T and stores it
//      to shared memory as [16 points][16 ch][32 tiles]; U's chunk goes to
//      shared memory as [16 points][16 ch][32 output channels];
//   2. each of 256 threads owns one H point p, 4 tiles and 4 output
//      channels, and keeps its 4 W points' sums in 64 f32 registers: per
//      channel, 8 float4 loads from shared memory feed 64 FMAs.
// Epilogue: each thread applies A along W in registers, the partial rows
// meet in shared memory, and A along H, the bias, the ReLU and the cast are
// applied as each output pixel is written, once, NHWC, coalesced over output
// channels. The image edge and the last channel block are masked; nothing
// is padded or copied around the kernel.
#include "common.cuh"

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

}  // namespace

// x [N, H, W, C], u [16, C, K] (T = bf16 if bf16 else f32), bias [K] f32 ->
// out [N, H, W, K] T.
MMB_API int mmb_winograd_conv3x3(const void* x, const void* u, const void* bias, void* out, int N,
                                 int H, int W, int C, int K, int relu, int bf16, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)N * ((H + 1) / 2) * ((W + 1) / 2) / kTT >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, u, bias, out, N, H, W, C, K, relu, s)
              : launch<float>(x, u, bias, out, N, H, W, C, K, relu, s);
}
