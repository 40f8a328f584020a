// K1 — BiLSTM recurrence, both directions in one launch — and K5, the same
// recurrence for training, which also writes the carried h and c of every
// step as the BPTT residuals (kTrain = true).
//
// Replaces: mmbidaf_tpu/ops/pallas/lstm_kernel.py::_lstm_kernel (K1, entry
// points lstm_pallas / bilstm_pallas) and ::_lstm_fwd_train_kernel (K5,
// entry _lstm_train_fwd_impl via lstm_pallas_trainable /
// bilstm_pallas_trainable). Contract: given gates = x@W_x + b for all
// steps (one GEMM outside the kernel, as on the TPU), run per step
//   z = gates_t + h @ W_h;  i,f,g,o = σ,σ,tanh,σ of z's four quarters
//   c' = f*c + i*g;  h' = o*tanh(c')
//   carry h = m*h' + (1-m)*h, c likewise;  out_t = h'*m
// with pack_padded semantics from the mask (masked steps freeze the state
// and emit zeros; the reverse direction runs step t at position T-1-t for
// the gates, the mask and the output), and return the carried h and c after
// the last step. Everything in f32 (the TPU kernel computes in f32 even
// under a bf16 model). K5 also writes h_seq/c_seq [2, T, B, H]: per
// direction, the carried state after processing step t (step t runs at
// position T-1-t in the reverse direction), which csrc/lstm_bwd.cu (K6)
// reads back.
//
// What bounds it on the H100: the recurrence is sequential in T, so the
// parallelism is rows x directions only, and every step must read all of
// W_h (128 x 512 f32 = 256 KB per direction) — more than a block's 227 KB
// of shared memory. The TPU kept W_h resident in VMEM; here it is read each
// step from L2 (50 MB, it stays resident), and each W_h element read is
// reused for R rows held by the block, so L2 traffic per step is
// 256 KB x blocks / R. The word tower (2048 rows x 16 steps) runs R=16 ->
// 256 blocks; the audio tower (64 rows x 512 steps) runs R=4 -> 32 blocks,
// which leaves most SMs idle: its time is 512 dependent steps of latency,
// the occupancy problem named for a later PR (split W_h over a cluster and
// keep it in distributed shared memory).
//
// Design: grid (ceil(B/R), 2 directions); one thread per gate column j of
// 4H accumulates z[r][j] for the block's R rows in registers (the W_h
// column read is coalesced across the warp, h is a shared-memory
// broadcast); the gate math then runs one thread per (row, unit) with the
// carried h and c in shared memory. Two barriers per step, no
// synchronisation between blocks (rows are independent).
#include "common.cuh"

namespace {

template <int R, bool kTrain>
__global__ void __launch_bounds__(512) bilstm_kernel(
    const float* __restrict__ gates,  // [B, T, 2, 4H]: fwd gates, then bwd gates
    const float* __restrict__ mask,   // [B, T]
    const float* __restrict__ w_h,    // [2, H, 4H]
    float* __restrict__ out,          // [B, T, 2H]: fwd | bwd
    float* __restrict__ h_last,       // [B, 2H]
    float* __restrict__ c_last,       // [B, 2H]
    float* __restrict__ h_seq,        // [2, T, B, H] (kTrain only)
    float* __restrict__ c_seq,        // [2, T, B, H] (kTrain only)
    int B, int T, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* h_s = smem;         // [R][H] carried h
  float* c_s = h_s + R * H;  // [R][H] carried c
  float* z_s = c_s + R * H;  // [R][G] this step's gate pre-activations
  const int dir = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const float* wh = w_h + (size_t)dir * H * G;

  for (int p = threadIdx.x; p < R * H; p += blockDim.x) {
    h_s[p] = 0.0f;
    c_s[p] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int tt = dir ? T - 1 - t : t;
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = __ldg(wh + (size_t)k * G + j);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(h_s[r * H + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        const float g =
            row < B ? gates[((size_t)row * T + tt) * 2 * G + (size_t)dir * G + j] : 0.0f;
        z_s[r * G + j] = g + acc[r];
      }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < R * H; p += blockDim.x) {
      const int r = p / H, u = p - r * H;
      const int row = row0 + r;
      if (row >= B) continue;
      const float* z = z_s + r * G;
      const float ig = mmb::sigmoid(z[u]);
      const float fg = mmb::sigmoid(z[H + u]);
      const float gg = tanhf(z[2 * H + u]);
      const float og = mmb::sigmoid(z[3 * H + u]);
      const float c_old = c_s[p], h_old = h_s[p];
      const float c_new = fg * c_old + ig * gg;
      const float h_new = og * tanhf(c_new);
      const float m = mask[(size_t)row * T + tt];
      const float c_carry = m * c_new + (1.0f - m) * c_old;
      const float h_carry = m * h_new + (1.0f - m) * h_old;
      c_s[p] = c_carry;
      h_s[p] = h_carry;
      out[((size_t)row * T + tt) * 2 * H + (size_t)dir * H + u] = h_new * m;
      if (kTrain) {
        const size_t q = (((size_t)dir * T + t) * B + row) * H + u;
        h_seq[q] = h_carry;
        c_seq[q] = c_carry;
      }
    }
    __syncthreads();
  }

  for (int p = threadIdx.x; p < R * H; p += blockDim.x) {
    const int r = p / H, u = p - r * H;
    const int row = row0 + r;
    if (row < B) {
      h_last[(size_t)row * 2 * H + (size_t)dir * H + u] = h_s[p];
      c_last[(size_t)row * 2 * H + (size_t)dir * H + u] = c_s[p];
    }
  }
}

template <int R, bool kTrain>
cudaError_t launch_bilstm(const float* gates, const float* mask, const float* w_h, float* out,
                          float* h_last, float* c_last, float* h_seq, float* c_seq, int B,
                          int T, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)R * 6 * H;
  if (smem > (size_t)mmb::kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(bilstm_kernel<R, kTrain>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + R - 1) / R, 2);
  bilstm_kernel<R, kTrain><<<grid, mmb::threads_for(4 * H, 512), smem, stream>>>(
      gates, mask, w_h, out, h_last, c_last, h_seq, c_seq, B, T, H);
  return cudaGetLastError();
}

template <bool kTrain>
int bilstm_forward(const void* gates, const void* mask, const void* w_h, void* out,
                   void* h_last, void* c_last, void* h_seq, void* c_seq, int B, int T, int H,
                   void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(gates);
  const auto* m = static_cast<const float*>(mask);
  const auto* w = static_cast<const float*>(w_h);
  auto* o = static_cast<float*>(out);
  auto* h = static_cast<float*>(h_last);
  auto* c = static_cast<float*>(c_last);
  auto* hs = static_cast<float*>(h_seq);
  auto* cs = static_cast<float*>(c_seq);
  const auto s = static_cast<cudaStream_t>(stream);
  // Many rows (the word tower): 16 rows a block reuse each W_h read 16x and
  // still give 2*B/16 >= 128 blocks; few rows: 4 a block, for more blocks.
  const cudaError_t e =
      B >= 1024 ? launch_bilstm<16, kTrain>(g, m, w, o, h, c, hs, cs, B, T, H, s)
                : launch_bilstm<4, kTrain>(g, m, w, o, h, c, hs, cs, B, T, H, s);
  return (int)e;
}

}  // namespace

// K1: the inference recurrence.
MMB_API int mmb_bilstm_forward(const void* gates, const void* mask, const void* w_h, void* out,
                               void* h_last, void* c_last, int B, int T, int H,
                               void* stream) {
  return bilstm_forward<false>(gates, mask, w_h, out, h_last, c_last, nullptr, nullptr, B, T,
                               H, stream);
}

// K5: the training recurrence, which also writes h_seq / c_seq.
MMB_API int mmb_bilstm_forward_train(const void* gates, const void* mask, const void* w_h,
                                     void* out, void* h_last, void* c_last, void* h_seq,
                                     void* c_seq, int B, int T, int H, void* stream) {
  return bilstm_forward<true>(gates, mask, w_h, out, h_last, c_last, h_seq, c_seq, B, T, H,
                              stream);
}

// Message for a code returned by any mmb_* entry point.
MMB_API const char* mmb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
