// Shared helpers of the hand-written Hopper kernels (built for sm_90a by
// mmbidaf_tpu_torch/ops/cuda/build.py into one library with a C interface).
#pragma once

#include <cuda_runtime.h>

#define MMB_API extern "C" __attribute__((visibility("default")))

namespace mmb {

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

// Threads per block for a loop over n items: n rounded up to a warp, capped.
inline int threads_for(int n, int cap) {
  int t = ((n + 31) / 32) * 32;
  return t < cap ? t : cap;
}

}  // namespace mmb
