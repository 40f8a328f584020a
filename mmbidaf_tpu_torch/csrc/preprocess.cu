// K10 — raw u8 keyframes -> resized, ImageNet-normalized [N, S, S, 3] in one pass.
//
// Replaces: mmbidaf_tpu/ops/pallas/preprocess_kernel.py::_preprocess_kernel
// (entry point preprocess_frames_fused). Contract, per frame, in f32 with one
// cast to T (float or __nv_bfloat16) at the end:
//   t[s, w, c]   = sum over h of rh[s, h] * x[h, w, c]      (u8 widened)
//   out[s, k, c] = sum over w of t[s, w, c] * rw3[c, w, k] - bias[c]
// with rw3[c, w, k] = rw[k, w] / (255·std_c) and bias = mean/std, the
// wrapper's constants from the port's numpy resize_matrix.
//
// What bounds it on the H100: its bytes (15 MB of u8 in, 38 MB of f32 out
// for 64 frames of 240x320 -> 224: 0.016 ms at 3.35 TB/s). A bilinear
// downscale by less than 2x has at most three taps a row, so the least work
// is the two matrices' nonzeros, 0.12 GFLOP there (0.002 ms at the f32
// peak). The TPU ran both contractions as dense MXU GEMMs with a
// kron-expanded [3W, 3S] matrix, a lane-layout device. Here the H pass walks
// only rh's band (step 1), and the W pass still runs the dense [S, W]
// matrix per channel, about 110x the least work of that pass; skipping its
// zeros as step 1 does is the first step to the bound.
// Design: one block per (8 output rows, frame), 256 threads.
//   1. rh's 8 rows go to shared memory. A bilinear downscale's rows are
//      banded, so the block finds the band [h_lo, h_hi] where any of them is
//      nonzero and walks only it: the terms outside add exact zeros, so the
//      sum equals the dense one, bit for bit.
//   2. t[8][3W] = rh_rows · x lands in shared memory; each thread owns
//      columns of the interleaved (w, c) axis, so the u8 reads are
//      coalesced and each x value feeds 8 FMAs.
//   3. each thread owns (channel, output column k) pairs and sums over w
//      for all 8 rows: rw3[c][w][k] is read coalesced over k from L2 (860 KB
//      at 320 -> 224) and reused 8 times; t is a shared-memory broadcast.
//      The bias is subtracted and each output written once.
#include "common.cuh"

namespace {

constexpr int kR = 8;  // output rows per block
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) preprocess_kernel(
    const unsigned char* __restrict__ x,  // [N, H, W, 3]
    const float* __restrict__ rh,         // [S, H]
    const float* __restrict__ rw3,        // [3, W, S]
    const float* __restrict__ bias,       // [3]
    T* __restrict__ out,                  // [N, S, S, 3]
    int H, int W, int S) {
  extern __shared__ float smem[];
  float* rh_s = smem;          // [kR][H]
  float* t_s = rh_s + kR * H;  // [kR][3W]
  __shared__ int band[2];
  const int n = blockIdx.y, s0 = blockIdx.x * kR, tid = threadIdx.x;
  const int W3 = 3 * W;
  if (tid == 0) band[0] = H, band[1] = -1;
  __syncthreads();
  for (int e = tid; e < kR * H; e += kThreads) {
    const int r = e / H, h = e - r * H;
    const float v = s0 + r < S ? rh[(size_t)(s0 + r) * H + h] : 0.0f;
    rh_s[e] = v;
    if (v != 0.0f) {
      atomicMin(&band[0], h);
      atomicMax(&band[1], h);
    }
  }
  __syncthreads();
  const int h_lo = band[0], h_hi = band[1];
  const unsigned char* xn = x + (size_t)n * H * W3;
  for (int j = tid; j < W3; j += kThreads) {
    float acc[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
    for (int h = h_lo; h <= h_hi; ++h) {
      const float v = mmb::to_f32(xn[(size_t)h * W3 + j]);
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = fmaf(rh_s[r * H + h], v, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) t_s[r * W3 + j] = acc[r];
  }
  __syncthreads();
  const int nr = min(kR, S - s0);
  for (int e = tid; e < 3 * S; e += kThreads) {
    const int c = e / S, k = e - c * S;
    const float* wc = rw3 + (size_t)c * W * S + k;
    float acc[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
    for (int w = 0; w < W; ++w) {
      const float wt = __ldg(wc + (size_t)w * S);
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = fmaf(t_s[r * W3 + 3 * w + c], wt, acc[r]);
    }
    const float b = bias[c];
    for (int r = 0; r < nr; ++r)
      mmb::store_f32(out + (((size_t)n * S + s0 + r) * S + k) * 3 + c, acc[r] - b);
  }
}

template <typename T>
int launch(const void* x, const void* rh, const void* rw3, const void* bias, void* out, int N, int H,
           int W, int S, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)kR * (H + 3 * W);
  if (smem > (size_t)mmb::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(preprocess_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  preprocess_kernel<T><<<dim3((S + kR - 1) / kR, N), kThreads, smem, s>>>(
      static_cast<const unsigned char*>(x), static_cast<const float*>(rh),
      static_cast<const float*>(rw3), static_cast<const float*>(bias), static_cast<T*>(out), H, W,
      S);
  return (int)cudaGetLastError();
}

}  // namespace

// frames [N, H, W, 3] u8, rh [S, H], rw3 [3, W, S], bias [3] f32 -> out
// [N, S, S, 3] (bf16 if bf16 else f32).
MMB_API int mmb_preprocess_frames(const void* frames, const void* rh, const void* rw3,
                                  const void* bias, void* out, int N, int H, int W, int S, int bf16,
                                  void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || S <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(frames, rh, rw3, bias, out, N, H, W, S, s)
              : launch<float>(frames, rh, rw3, bias, out, N, H, W, S, s);
}
