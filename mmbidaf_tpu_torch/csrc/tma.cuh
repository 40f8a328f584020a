// Tensor Memory Accelerator (TMA) and mbarrier helpers of the bf16 kernels
// (K13 in conv3x3.cu): tiled tensor loads global -> shared that complete on
// an mbarrier in shared memory, and the barrier's init, expect and wait.
// Inline PTX for sm_90a; the tensor maps are encoded on the host with
// cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, so the
// library needs no -lcuda) and passed as __grid_constant__ parameters.
//
// One use of a stage: a thread arms the stage's barrier with the bytes it
// will receive (mbar_arrive_expect_tx, the barrier's one arrival), issues
// the loads (each box counts its full size, zero-filled parts included), and
// every consumer waits on the barrier's phase parity (mbar_wait): use u = 0,
// 1, 2, ... of a barrier waits for the completion of its phase u, parity u & 1.
#pragma once

#include <cuda.h>

namespace mmb {

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

// Makes barrier inits visible to the async proxy (TMA) and the other threads
// (with the __syncthreads that follows).
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this CTA's earlier generic-proxy accesses to shared memory (the
// ldmatrix reads of a stage) before later async-proxy ones (a TMA write to it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Box of the 4-D map at coordinates (c0 innermost .. c3) into shared `dst`,
// completing on `bar`. Coordinates may be negative or past the tensor: those
// elements are zero-filled.
__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

}  // namespace mmb
