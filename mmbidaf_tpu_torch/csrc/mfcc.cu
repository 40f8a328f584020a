// K3 — MFCC: windowed DFT -> |.|^2 -> mel -> dB (per-example max) -> DCT,
// and K4 — the frame-tiled mel spectrogram, log or raw, on the same tile pass.
//
// Replaces: mmbidaf_tpu/ops/pallas/melspec_kernel.py::_mfcc_kernel (K3, entry
// point mfcc_fused) and ::_melspec_kernel (K4, entry point log_mel_fused).
// K3's contract, per example, all in f32:
//   P   = (frames@cos)^2 + (frames@sin)^2      (Hann window folded in cos/sin)
//   L   = 10*log10(max(P@mel, 1e-10))
//   out = max(L - max(L over the whole example), -80) @ dct
// An all-zero (silent) example gives L = -100 everywhere, so the output is 0.
// K4's contract, per frame: out = log(P@mel + 1e-6) (log) or P@mel (raw).
// The raw mel is what the MFCC path takes past the whole-example bound
// (the 4096-frame long-audio configuration): its dB and DCT tail is plain
// tensor code in ops/audio.py.
//
// What bounds it on the H100: the two DFT products (2 x T x win x bins
// multiply-adds: 0.42 GFLOP per example at T=512, win=400, bins=257) in
// f32 on the CUDA cores, and shared memory: one example's frames
// ([512, 400] = 800 KB) and each DFT basis ([400, 257] = 411 KB) do not fit
// a block, where the TPU held a whole example in VMEM. The dB reference is
// the maximum over the WHOLE example, which is why the TPU ran one example
// per program.
// Design — the tile pass, then (K3 only) a second pass:
// 1. grid (frame tiles of kTF, examples): a tile of kTF frames sits in
//    shared memory; one thread per frequency bin reads its cos/sin column
//    entries from L2 (coalesced over bins) and keeps kTF real and imaginary
//    sums in registers, each basis value reused kTF times. The power
//    spectrum [kTF, bins] stays in shared memory for the mel product. The
//    epilogue is a template parameter: K3 writes log-mel rows in dB and the
//    tile's own maximum to global scratch; K4 writes log(mel + 1e-6) or the
//    raw mel as its output, and nothing else.
// 2. (K3) grid (frame tiles, examples): each block takes the example's
//    maximum over the tile maxima, clamps at -80 dB and applies the DCT.
// The frames are read through their strides, so the framing of the
// waveform stays a strided view and is never copied.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kTF = 32;  // frames per tile

// ln(10) rounded to f32: log10 as log(x)/log(10), the way jnp.log10 computes it.
constexpr float kLn10 = 2.302585093f;

// Epilogues of the tile pass.
enum Epilogue { kDb = 0, kLogMel = 1, kMelPower = 2 };

template <int kEpi>
__global__ void __launch_bounds__(512) logmel_tile_kernel(
    const float* __restrict__ frames, long long stride_b, long long stride_t,
    const float* __restrict__ cos_b, const float* __restrict__ sin_b,  // [win, bins]
    const float* __restrict__ mel,                                     // [bins, n_mels]
    float* __restrict__ logmel,                                        // [B, T, n_mels]
    float* __restrict__ tile_max,                                      // [B, T] (kDb only)
    int T, int win, int bins, int n_mels) {
  extern __shared__ float smem[];
  float* fr_s = smem;              // [kTF][win]
  float* pw_s = fr_s + kTF * win;  // [kTF][bins]
  float* red = pw_s + kTF * bins;  // [32] per-warp maxima
  const int b = blockIdx.y, tile = blockIdx.x, t0 = tile * kTF, tid = threadIdx.x;
  const int nf = min(kTF, T - t0);
  const float* fb = frames + (size_t)b * stride_b;

  for (int e = tid; e < kTF * win; e += blockDim.x) {
    const int f = e / win, n = e - f * win;
    fr_s[e] = f < nf ? fb[(size_t)(t0 + f) * stride_t + n] : 0.0f;
  }
  __syncthreads();

  for (int k = tid; k < bins; k += blockDim.x) {
    float re[kTF], im[kTF];
#pragma unroll
    for (int f = 0; f < kTF; ++f) re[f] = im[f] = 0.0f;
    for (int n = 0; n < win; ++n) {
      const float cv = __ldg(cos_b + (size_t)n * bins + k);
      const float sv = __ldg(sin_b + (size_t)n * bins + k);
#pragma unroll
      for (int f = 0; f < kTF; ++f) {
        const float x = fr_s[f * win + n];
        re[f] = fmaf(x, cv, re[f]);
        im[f] = fmaf(x, sv, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kTF; ++f) pw_s[f * bins + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  float local_max = -INFINITY;
  for (int e = tid; e < nf * n_mels; e += blockDim.x) {
    const int f = e / n_mels, m = e - f * n_mels;
    const float* pw = pw_s + f * bins;
    float acc = 0.0f;
    for (int k = 0; k < bins; ++k) acc = fmaf(pw[k], __ldg(mel + (size_t)k * n_mels + m), acc);
    float l = acc;
    if (kEpi == kDb) l = 10.0f * (logf(fmaxf(acc, 1e-10f)) / kLn10);
    if (kEpi == kLogMel) l = logf(acc + 1e-6f);
    logmel[((size_t)b * T + t0 + f) * n_mels + m] = l;
    local_max = fmaxf(local_max, l);
  }
  if (kEpi != kDb) return;
  local_max = mmb::warp_max(local_max);
  if ((tid & 31) == 0) red[tid >> 5] = local_max;
  __syncthreads();
  if (tid < 32) {
    float v = tid < (int)(blockDim.x >> 5) ? red[tid] : -INFINITY;
    v = mmb::warp_max(v);
    if (tid == 0) tile_max[(size_t)b * T + tile] = v;
  }
}

__global__ void __launch_bounds__(256) mfcc_dct_kernel(
    const float* __restrict__ logmel, const float* __restrict__ tile_max, int ntiles,
    const float* __restrict__ dct,  // [n_mels, n_mfcc]
    float* __restrict__ out,        // [B, T, n_mfcc]
    int T, int n_mels, int n_mfcc) {
  extern __shared__ float db_s[];  // [kTF][n_mels]
  __shared__ float ref_s;
  const int b = blockIdx.y, t0 = blockIdx.x * kTF, tid = threadIdx.x;
  const int nf = min(kTF, T - t0);
  if (tid < 32) {
    float mx = -INFINITY;
    for (int i = tid; i < ntiles; i += 32) mx = fmaxf(mx, tile_max[(size_t)b * T + i]);
    mx = mmb::warp_max(mx);
    if (tid == 0) ref_s = mx;
  }
  __syncthreads();
  const float ref = ref_s;
  const float* lb = logmel + ((size_t)b * T + t0) * n_mels;
  for (int e = tid; e < nf * n_mels; e += blockDim.x) db_s[e] = fmaxf(lb[e] - ref, -80.0f);
  __syncthreads();
  for (int e = tid; e < nf * n_mfcc; e += blockDim.x) {
    const int f = e / n_mfcc, j = e - f * n_mfcc;
    const float* dbf = db_s + f * n_mels;
    float acc = 0.0f;
    for (int m = 0; m < n_mels; ++m) acc = fmaf(dbf[m], __ldg(dct + (size_t)m * n_mfcc + j), acc);
    out[((size_t)b * T + t0 + f) * n_mfcc + j] = acc;
  }
}

}  // namespace

MMB_API int mmb_mfcc_forward(const void* frames, long long stride_b, long long stride_t,
                             const void* cos_b, const void* sin_b, const void* mel,
                             const void* dct, void* logmel, void* tile_max, void* out, int B,
                             int T, int win, int bins, int n_mels, int n_mfcc, void* stream) {
  if (B <= 0 || T <= 0 || win <= 0 || bins <= 0 || n_mels <= 0 || n_mfcc <= 0)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int ntiles = (T + kTF - 1) / kTF;
  const size_t smem1 = sizeof(float) * ((size_t)kTF * (win + bins) + 32);
  if (smem1 > (size_t)mmb::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      logmel_tile_kernel<kDb>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (e != cudaSuccess) return (int)e;
  logmel_tile_kernel<kDb><<<dim3(ntiles, B), mmb::threads_for(bins, 512), smem1, s>>>(
      static_cast<const float*>(frames), stride_b, stride_t, static_cast<const float*>(cos_b),
      static_cast<const float*>(sin_b), static_cast<const float*>(mel),
      static_cast<float*>(logmel), static_cast<float*>(tile_max), T, win, bins, n_mels);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem2 = sizeof(float) * (size_t)kTF * n_mels;
  if (smem2 > 48 * 1024) return (int)cudaErrorInvalidValue;
  mfcc_dct_kernel<<<dim3(ntiles, B), 256, smem2, s>>>(
      static_cast<const float*>(logmel), static_cast<const float*>(tile_max), ntiles,
      static_cast<const float*>(dct), static_cast<float*>(out), T, n_mels, n_mfcc);
  return (int)cudaGetLastError();
}

// K4: the tile pass alone; out [B, T, n_mels] = log(mel + 1e-6) (log != 0) or the raw mel.
MMB_API int mmb_log_mel_forward(const void* frames, long long stride_b, long long stride_t,
                                const void* cos_b, const void* sin_b, const void* mel,
                                void* out, int B, int T, int win, int bins, int n_mels, int log,
                                void* stream) {
  if (B <= 0 || T <= 0 || win <= 0 || bins <= 0 || n_mels <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kTF * (win + bins) + 32);
  if (smem > (size_t)mmb::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const auto kernel = log ? logmel_tile_kernel<kLogMel> : logmel_tile_kernel<kMelPower>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((T + kTF - 1) / kTF, B), mmb::threads_for(bins, 512), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), stride_b, stride_t, static_cast<const float*>(cos_b),
      static_cast<const float*>(sin_b), static_cast<const float*>(mel), static_cast<float*>(out),
      nullptr, T, win, bins, n_mels);
  return (int)cudaGetLastError();
}
