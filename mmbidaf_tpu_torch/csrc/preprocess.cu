// K10 — raw u8 keyframes -> resized, ImageNet-normalized [N, S, S, 3] in one pass.
//
// Replaces: mmbidaf_tpu/ops/pallas/preprocess_kernel.py::_preprocess_kernel
// (entry point preprocess_frames_fused). Contract, per frame, in f32 with one
// cast to T (float or __nv_bfloat16) at the end:
//   t[s, w, c]   = sum over h of rh[s, h] * x[h, w, c]      (u8 widened)
//   out[s, k, c] = sum over w of t[s, w, c] * rw[k, w] / (255·std_c) - bias[c]
// with rh, rw the port's numpy resize_matrix and bias = mean/std.
//
// What bounds it on the H100: its bytes (15 MB of u8 in, 38 MB of f32 out
// for 64 frames of 240x320 -> 224: 0.016 ms at 3.35 TB/s). A bilinear
// resize is banded: a row of rh or rw has at most T nonzeros in a row
// (T = 3 when downscaling by less than 2x, 2 when upscaling, 1 for the
// identity), so the least work is 0.12 GFLOP there (0.002 ms at the f32
// peak). The TPU ran both contractions as dense MXU GEMMs with a
// kron-expanded [3W, 3S] matrix, a lane-layout device; the first port here
// ran the W pass as the dense [S, W] matrix from L2 (~110x that pass's
// least work, every block re-reading 860 KB).
// Design: a streaming kernel over the band. The host gives each output row
// its first input row / column and its T weights (band_taps in
// ops/cuda/preprocess_kernel.py; the W weights per channel, 1/(255·std_c)
// folded in), so no block searches for its band. One block a (tile of
// `rows` output rows, frame), 256 threads:
//   1. the input rows the tile reads (first_h of its first row to the last
//      row's last tap) are one contiguous byte range of the frame: 16-byte
//      cp.async from the 16-byte boundary below it into shared memory;
//   2. the H pass: t[rows][3W] in shared memory, each thread four
//      consecutive (w, c) columns of a row from at most T taps (u8 read four
//      at a time where the rows are 4-byte aligned, widened exactly by a
//      byte permute and a subtract);
//   3. the W pass: each thread owns four consecutive elements j = 3k + c of
//      the interleaved output row, holds their taps' weights and columns in
//      registers, and sums every row of the tile from t; the bias is
//      subtracted and the four values stored together (16 bytes in f32,
//      streaming).
// The sums run in the first port's order (H, then W, each over increasing
// input index, fmaf from 0) and only exact zeros are skipped, so the output
// is the first port's, bit for bit. `rows` is 8 where the block fits (four
// blocks an SM at 240x320 -> 224, 64 registers a thread), fewer for wide
// frames (1080p: 2);
// ops/cuda/preprocess_kernel.py::preprocess_plan picks it and the band's
// rows.
#include "common.cuh"
#include "mma.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;  // output rows a block, at most

// Byte k of w as a float, exactly: the bits 0x4B0000bb are 2^23 + bb
// (two full-rate integer/float operations in place of a quarter-rate
// conversion).
__device__ __forceinline__ float byte_f32(unsigned w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | k)) - 8388608.0f;
}

// Four consecutive outputs of row `o` from element j; `vec`: j is a multiple
// of 4 and all four exist, so one 16-byte (f32) or 8-byte (bf16) streaming
// store (the output is not read again here).
__device__ __forceinline__ void store4(float* o, const float v[4], bool vec, int valid) {
  if (vec) {
    __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    for (int e = 0; e < valid; ++e) o[e] = v[e];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, const float v[4], bool vec, int valid) {
  if (vec) {
    __stcs(reinterpret_cast<uint2*>(o),
           make_uint2(mmb::pack_bf16x2(v[0], v[1]), mmb::pack_bf16x2(v[2], v[3])));
  } else {
    for (int e = 0; e < valid; ++e) o[e] = __float2bfloat16(v[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4) preprocess_band_kernel(
    const unsigned char* __restrict__ x,  // [N, H, W, 3]
    const int* __restrict__ first_h,      // [S]      first input row of output row s
    const float* __restrict__ wh,         // [S, Th]  its weights
    const int* __restrict__ first_w,      // [S]      first input column of output column k
    const float* __restrict__ ww,         // [3, S, Tw] its weights / (255·std_c)
    const float* __restrict__ bias,       // [3]
    T* __restrict__ out,                  // [N, S, S, 3]
    int N, int H, int W, int S, int Th, int Tw, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W3 = 3 * W, O = 3 * S;
  float* t_s = reinterpret_cast<float*>(smem);  // [rows][W3]
  unsigned char* band = smem + ((sizeof(float) * rows * W3 + 15) & ~size_t(15));
  const int n = blockIdx.y, s0 = blockIdx.x * rows, tid = threadIdx.x;
  const int nr = min(rows, S - s0);

  // 1. The input rows of this tile: one contiguous byte range of frame n.
  int h_lo = H, h_hi = 0;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < nr) {
      const int f = __ldg(first_h + s0 + r);
      h_lo = min(h_lo, f);
      h_hi = max(h_hi, f + Th - 1);
    }
  }
  const size_t start = ((size_t)n * H + h_lo) * W3;
  const int len = (h_hi - h_lo + 1) * W3;
  int lead = 0;  // the band's first byte in shared memory
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const size_t total = (size_t)N * H * W3, a0 = start & ~size_t(15);
    lead = (int)(start - a0);
    const int chunks = (lead + len + 15) / 16;
    for (int k = tid; k < chunks; k += blockDim.x) {
      const size_t g = a0 + 16 * (size_t)k, rest = total - g;  // g < start + len <= total
      if (rest >= 16) {
        mmb::cp_async16(mmb::smem_u32(band + 16 * k), x + g, true);
      } else {  // the frames' last bytes
        for (size_t e = 0; e < rest; ++e) band[16 * k + e] = x[g + e];
      }
    }
    mmb::cp_async_wait_all();
  } else {
    for (int k = tid; k < len; k += blockDim.x) band[k] = x[start + k];
  }
  __syncthreads();

  // 2. H pass: t[r][j] = sum over the row's taps of wh · x, four j a thread.
  const unsigned char* xb = band + lead;  // input row h at xb + (h - h_lo)·W3
  const bool u4 = ((lead | W3) & 3) == 0;
  const int G = (W3 + 3) / 4;
  for (int e = tid; e < nr * G; e += blockDim.x) {
    const int r = e / G, j = 4 * (e - r * G);
    const int f = __ldg(first_h + s0 + r) - h_lo;
    const float* w = wh + (size_t)(s0 + r) * Th;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < Th; ++i) {
      const float wt = __ldg(w + i);
      const unsigned char* p = xb + (size_t)(f + i) * W3 + j;
      float v[4];
      if (u4) {
        const unsigned u = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = byte_f32(u, c);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = j + c < W3 ? mmb::to_f32(p[c]) : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = fmaf(wt, v[c], acc[c]);
    }
    float* tr = t_s + (size_t)r * W3 + j;
    if (u4) {
      *reinterpret_cast<float4*>(tr) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      for (int c = 0; c < 4 && j + c < W3; ++c) tr[c] = acc[c];
    }
  }
  __syncthreads();

  // 3. W pass: elements j..j+3 of every output row of the tile.
  const bool vec = (O & 3) == 0;
  for (int j = 4 * tid; j < O; j += 4 * blockDim.x) {
    const int valid = min(4, O - j);
    int col[4], wo[4];
    float b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int je = min(j + e, O - 1), k = je / 3, c = je - 3 * k;
      col[e] = 3 * __ldg(first_w + k) + c;
      wo[e] = (c * S + k) * Tw;
      b[e] = __ldg(bias + c);
    }
    float acc[kMaxRows][4] = {};
    for (int i = 0; i < Tw; ++i) {
      float wt[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) wt[e] = __ldg(ww + wo[e] + i);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nr) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][e] = fmaf(t_s[(size_t)r * W3 + col[e] + 3 * i], wt[e], acc[r][e]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < nr) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[r][e] - b[e];
        store4(out + ((size_t)n * S + s0 + r) * O + j, v, vec, valid);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* first_h, const void* wh, const void* first_w,
           const void* ww, const void* bias, void* out, int N, int H, int W, int S, int Th,
           int Tw, int rows, int band_rows, cudaStream_t s) {
  const size_t W3 = 3 * (size_t)W;
  const size_t smem = ((sizeof(float) * rows * W3 + 15) & ~size_t(15)) + band_rows * W3 + 32;
  if (smem > (size_t)mmb::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(preprocess_band_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  const auto i = [](const void* v) { return static_cast<const int*>(v); };
  preprocess_band_kernel<T><<<dim3((S + rows - 1) / rows, N), kThreads, smem, s>>>(
      static_cast<const unsigned char*>(x), i(first_h), f(wh), i(first_w), f(ww), f(bias),
      static_cast<T*>(out), N, H, W, S, Th, Tw, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// frames [N, H, W, 3] u8; first_h [S] int32, wh [S, Th], first_w [S] int32,
// ww [3, S, Tw], bias [3] f32 -> out [N, S, S, 3] (bf16 if bf16 else f32);
// `rows` output rows a block (<= 8), `band_rows` the most input rows a tile
// of them reads (ops/cuda/preprocess_kernel.py::preprocess_plan).
MMB_API int mmb_preprocess_frames(const void* frames, const void* first_h, const void* wh,
                                  const void* first_w, const void* ww, const void* bias,
                                  void* out, int N, int H, int W, int S, int Th, int Tw, int rows,
                                  int band_rows, int bf16, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || S <= 0 || N > 65535 || Th <= 0 || Th > H || Tw <= 0 ||
      Tw > W || rows <= 0 || rows > kMaxRows || band_rows < Th || band_rows > H)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(frames, first_h, wh, first_w, ww, bias, out, N, H, W, S, Th,
                                      Tw, rows, band_rows, s)
              : launch<float>(frames, first_h, wh, first_w, ww, bias, out, N, H, W, S, Th, Tw,
                              rows, band_rows, s);
}
