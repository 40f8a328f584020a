// The VGG convs' epilogue — bias, ReLU and, after a block's last conv, the
// 2x2 max pool, in one pass over the conv's NHWC output.
//
// Replaces no TPU kernel: the JAX package's direct convs are XLA convs,
// whose bias, ReLU and pool XLA fuses. The port runs each direct conv as
// cuDNN's GEMM without a bias (ops/vgg.py) and this pass does the rest.
// Contract, y [N, H, W, C] (T = float or __nv_bfloat16, NHWC contiguous),
// b [C] (float or bf16, widened exactly):
//   pool = 0: y[n, h, w, c] <- relu(round_T(y + b[c])), in place;
//   pool = 1: out [N, H/2, W/2, C] (floor sizes, as F.max_pool2d) =
//             the max over the window (2i..2i+1, 2j..2j+1) of
//             relu(round_T(y + b[c])); y is read, not written.
// The bias is added in f32 to the stored conv output and rounded once to T,
// as PyTorch's separate `output.add_(bias)` after cuDNN does; ReLU is
// `isnan(v) ? v : fmaxf(v, 0)` (clamp_min's), and the max takes the window
// row by row, keeping a later value only if it is larger or NaN
// (max_pool2d's). So, given the same conv output, the result is the
// separate add -> ReLU -> max_pool2d's, bit for bit.
//
// What bounds it on the H100: bytes. At B=64 serving (1,024 frames at 224²,
// bf16) the 13 VGG-16 convs write 27.8 GB; this pass reads them once and
// writes 15.2 GB in place plus 3.1 GB pooled: 46 GB, 14 ms at 3.35 TB/s.
// Design: one thread a 16-byte vector of channels (8 bf16 or 4 f32) of a
// pixel, over a grid-stride loop whose stride is a multiple of the vectors
// a pixel holds (G = C / 8 or C / 4), so each thread keeps one channel
// group for the whole loop and its bias in registers. In place, a thread
// loads four pixels' vectors before it stores any (four 16-byte loads in
// flight a thread); pooled, it loads a window's four vectors together.
// Offsets are 64-bit (block 1 at 1,024 frames holds 3.29e9 elements).
// C not a multiple of the vector, or a pointer off 16 bytes: a scalar loop
// with the same arithmetic (the 3-channel images never reach it: the stem's
// output has 64 channels).
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // pixels a thread loads before it stores, in place

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// ReLU then the pool's comparison, as PyTorch's kernels make them.
__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }
__device__ __forceinline__ float pool_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

template <typename T>
__device__ __forceinline__ float act(T y, float b) {
  return relu(mmb::round_to<T>(mmb::to_f32(y) + b));
}

// 16 bytes of T <-> f32 lanes (bf16 widened exactly; stored with round to
// nearest even, as torch's casts).
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kLanes = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kLanes = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* v) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ unsigned pack2(float lo, float hi) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&t);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
  }
};

__device__ __forceinline__ float bias_at(const void* b, int bf16, int c) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(b)[c])
              : static_cast<const float*>(b)[c];
}

// relu(round_T(v + b)) on a vector's lanes, in place.
template <typename T>
__device__ __forceinline__ void act_lanes(float* v, const float* b) {
#pragma unroll
  for (int e = 0; e < Vec<T>::kLanes; ++e) v[e] = relu(mmb::round_to<T>(v[e] + b[e]));
}

// `lanes` threads (a multiple of G) walk the pixels; thread t owns channel
// group t % G. In place: `pixels` = N·H·W. Pooled: `pixels` = N·Ho·Wo.
template <typename T, bool kPool>
__global__ void __launch_bounds__(kThreads) conv_epilogue_vec_kernel(
    T* y, T* out, const void* bias, int bias_bf16, long long pixels, int H, int W, int Ho,
    int Wo, int G, long long lanes) {
  constexpr int L = Vec<T>::kLanes;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (tid >= lanes) return;
  const int g = (int)(tid % G);
  const long long step = lanes / G;
  const long long C = (long long)G * L;
  float b[L];
#pragma unroll
  for (int e = 0; e < L; ++e) b[e] = bias_at(bias, bias_bf16, g * L + e);

  if constexpr (!kPool) {
    for (long long p = tid / G; p < pixels; p += kUnroll * step) {
      uint4 u[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long q = p + k * step;
        if (q < pixels) u[k] = *reinterpret_cast<const uint4*>(y + q * C + g * L);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long q = p + k * step;
        if (q < pixels) {
          float v[L];
          Vec<T>::unpack(u[k], v);
          act_lanes<T>(v, b);
          *reinterpret_cast<uint4*>(y + q * C + g * L) = Vec<T>::pack(v);
        }
      }
    }
  } else {
    const long long plane = (long long)Ho * Wo;
    for (long long p = tid / G; p < pixels; p += step) {
      const long long n = p / plane;
      const int r = (int)(p - n * plane), i = r / Wo, j = r - i * Wo;
      const T* src = y + ((n * H + 2 * i) * W + 2 * j) * C + g * L;
      // the window row by row: (2i, 2j), (2i, 2j+1), (2i+1, 2j), (2i+1, 2j+1)
      const uint4 u[4] = {*reinterpret_cast<const uint4*>(src),
                          *reinterpret_cast<const uint4*>(src + C),
                          *reinterpret_cast<const uint4*>(src + W * C),
                          *reinterpret_cast<const uint4*>(src + W * C + C)};
      float m[L];
#pragma unroll
      for (int e = 0; e < L; ++e) m[e] = neg_inf();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[L];
        Vec<T>::unpack(u[k], v);
        act_lanes<T>(v, b);
#pragma unroll
        for (int e = 0; e < L; ++e) m[e] = pool_max(m[e], v[e]);
      }
      *reinterpret_cast<uint4*>(out + p * C + g * L) = Vec<T>::pack(m);
    }
  }
}

// The same per element: `total` = the output's elements.
template <typename T, bool kPool>
__global__ void __launch_bounds__(kThreads) conv_epilogue_scalar_kernel(
    T* y, T* out, const void* bias, int bias_bf16, long long total, int H, int W, int Ho, int Wo,
    int C) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < total; e += stride) {
    const long long p = e / C;
    const int c = (int)(e - p * C);
    const float b = bias_at(bias, bias_bf16, c);
    if constexpr (!kPool) {
      mmb::store_f32(y + e, act(y[e], b));
    } else {
      const long long plane = (long long)Ho * Wo, n = p / plane;
      const int r = (int)(p - n * plane), i = r / Wo, j = r - i * Wo;
      const T* src = y + ((n * H + 2 * i) * W + 2 * j) * C + c;
      float m = neg_inf();
      m = pool_max(m, act(src[0], b));
      m = pool_max(m, act(src[C], b));
      m = pool_max(m, act(src[(long long)W * C], b));
      m = pool_max(m, act(src[(long long)W * C + C], b));
      mmb::store_f32(out + e, m);
    }
  }
}

template <typename T, bool kPool>
int launch(void* y, void* out, const void* bias, int bias_bf16, int N, int H, int W, int C,
           cudaStream_t s) {
  constexpr int L = Vec<T>::kLanes;
  const int Ho = kPool ? H / 2 : H, Wo = kPool ? W / 2 : W;
  const long long pixels = (long long)N * Ho * Wo;
  if (pixels == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long resident = (long long)sms * 2048;  // threads the card holds at once
  T* yt = static_cast<T*>(y);
  T* ot = static_cast<T*>(out);
  const bool vec = C % L == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (vec) {
    const int G = C / L;
    const long long want = pixels * G < resident ? pixels * G : resident;
    const long long lanes = (want / G > 0 ? want / G : 1) * G;
    conv_epilogue_vec_kernel<T, kPool><<<(unsigned)((lanes + kThreads - 1) / kThreads), kThreads,
                                         0, s>>>(yt, ot, bias, bias_bf16, pixels, H, W, Ho, Wo,
                                                 G, lanes);
  } else {
    const long long total = pixels * C;
    const long long want = total < resident ? total : resident;
    conv_epilogue_scalar_kernel<T, kPool><<<(unsigned)((want + kThreads - 1) / kThreads),
                                            kThreads, 0, s>>>(yt, ot, bias, bias_bf16, total, H,
                                                              W, Ho, Wo, C);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(void* y, void* out, const void* bias, int bias_bf16, int N, int H, int W, int C,
             int pool, cudaStream_t s) {
  return pool ? launch<T, true>(y, out, bias, bias_bf16, N, H, W, C, s)
              : launch<T, false>(y, y, bias, bias_bf16, N, H, W, C, s);
}

}  // namespace

// y [N, H, W, C] (bf16 if bf16 else f32), bias [C] (bf16 if bias_bf16 else
// f32); pool = 0: relu(y + bias) into y (out unused); pool = 1: the 2x2 max
// of it into out [N, H/2, W/2, C].
MMB_API int mmb_conv_epilogue(void* y, const void* bias, void* out, int N, int H, int W, int C,
                              int pool, int bf16, int bias_bf16, void* stream) {
  if (N < 0 || H < 0 || W < 0 || C <= 0 || (pool && (H < 2 || W < 2)))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(y, out, bias, bias_bf16, N, H, W, C, pool, s)
              : dispatch<float>(y, out, bias, bias_bf16, N, H, W, C, pool, s);
}
