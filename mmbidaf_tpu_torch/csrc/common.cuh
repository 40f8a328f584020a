// Shared helpers of the hand-written Hopper kernels (built for sm_90a by
// mmbidaf_tpu_torch/ops/cuda/build.py into one library with a C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MMB_API extern "C" __attribute__((visibility("default")))

namespace mmb {

// Element types of the kernels that take the compute dtype (f32 or bf16) or
// raw u8 frames: widen to f32, store an f32 value as T (round to nearest
// even, as torch's .to(bfloat16)), and round an f32 value to T and back.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(unsigned char v) { return static_cast<float>(v); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  T t;
  store_f32(&t, v);
  return to_f32(t);
}

// Four consecutive values from a 4-element-aligned address, widened to f32.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// The reference's masked-softmax fill: mask*x + (1-mask)*(-1e30), not -inf.
constexpr float kNegInf = -1e30f;

// Hopper's opt-in shared-memory limit per block (227 KB).
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 4 bytes global -> shared without a register round trip; with !pred
// nothing is read and the 4 bytes are zero-filled (src must still be a
// valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Threads per block for a loop over n items: n rounded up to a warp, capped.
inline int threads_for(int n, int cap) {
  int t = ((n + 31) / 32) * 32;
  return t < cap ? t : cap;
}

}  // namespace mmb
