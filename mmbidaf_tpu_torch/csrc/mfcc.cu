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
//
// K4's FFT route (logmel_fft_kernel), for a power-of-two n_fft from 16 to
// 2048 and win <= n_fft (the configurations' 512; the wrapper checks once
// per consts that cos/sin are the window's DFT basis of n_fft): the bases
// fold a periodic window and a zero pad at the end into the DFT, so
// frames@cos and frames@sin are the real and imaginary parts of
// rfft(window · frame, n = n_fft). A block takes kFftFrames consecutive
// frames of one example, one warp a frame:
// 1. cp.async stages the waveform span the frames cover ((F-1)·hop + win
//    samples, read once where the dense pass reads the overlap 2.5 times),
//    the window and the twiddles (computed in f64 on the host; one table
//    a stage, read by consecutive lanes);
// 2. frame_power_fft: z[n] = x[2n] + i·x[2n+1] (windowed, zero past win)
//    into shared memory in bit-reversed order (padded against bank
//    conflicts), log2(N/2) radix-2 stages of the N/2-point complex FFT (a
//    butterfly a lane, __syncwarp between stages), then the real-FFT split
//    X_k = E_k + W_N^k·O_k to the N/2 + 1 bins and |X_k|² into shared memory;
// 3. the mel product over each mel column's nonzero bins [lo_m, hi_m]
//    (from the wrapper, with the weights packed and staged in shared memory;
//    each bin lies in at most two triangles, ~490 weights at n_fft = 512,
//    64 mels), summed in ascending k as the dense pass sums all bins
//    (fmaf(p, 0, acc) == acc), and the log or raw epilogue, rows written
//    coalesced.
// What bounds it: the bytes (each sample read once, each mel written
// once): 2.5·N·log2 N operations a frame are ~1/27 of the dense DFT's at
// N = 512. K3's first pass can take frame_power_fft in place of its DFT.
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

constexpr int kFftFrames = 8;  // frames a block of the FFT route, a warp each

// Where z[i] sits in a warp's FFT scratch: one float2 of padding every
// M/16 entries, so that the bit-reversed stores of a half-warp (16 lanes,
// 8 bytes each) land in 16 distinct bank pairs, as do the butterflies.
__device__ __forceinline__ int zpad(int i, int sh) { return i + (i >> sh); }
__host__ __device__ inline int zpad_shift(int log2m) { return log2m > 4 ? log2m - 4 : 0; }
__host__ __device__ inline int zstride(int log2m) {
  return (1 << log2m) + ((1 << log2m) >> zpad_shift(log2m));
}

// One warp: the power spectrum |rfft(window · x, n = 2M)|² of one frame into
// pw[0..M]. x and wnd hold win samples (zero past win); tw[half + pos] =
// W_{2·half}^pos for the stage of butterfly span 2·half (half < M), tw[M + k]
// = W_{2M}^k for the split (k < M), W = e^{-2πi/n}; z is the warp's
// [zstride] scratch; M = 2^log2m >= 8.
__device__ __forceinline__ void frame_power_fft(const float* x, const float* wnd, int win,
                                                const float2* tw, int log2m, float2* z,
                                                float* pw, int lane) {
  const int M = 1 << log2m, sh = zpad_shift(log2m);
  for (int n = lane; n < M; n += 32) {
    const int a = 2 * n, b = a + 1;
    z[zpad(__brev(n) >> (32 - log2m), sh)] =
        make_float2(a < win ? x[a] * wnd[a] : 0.0f, b < win ? x[b] * wnd[b] : 0.0f);
  }
  __syncwarp();
  for (int s = 0; s < log2m; ++s) {
    const int half = 1 << s;
    for (int j = lane; j < M / 2; j += 32) {
      const int pos = j & (half - 1);
      const int i = ((j >> s) << (s + 1)) + pos;
      const int i0 = zpad(i, sh), i1 = zpad(i + half, sh);
      const float2 w = tw[half + pos];
      const float2 p = z[i0], q = z[i1];
      const float qr = q.x * w.x - q.y * w.y, qi = q.x * w.y + q.y * w.x;
      z[i0] = make_float2(p.x + qr, p.y + qi);
      z[i1] = make_float2(p.x - qr, p.y - qi);
    }
    __syncwarp();
  }
  // Z = E + i·O with E, O the spectra of the even and odd samples:
  // E_k = (Z_k + conj Z_{M-k}) / 2, O_k = (Z_k - conj Z_{M-k}) / 2i,
  // X_k = E_k + W_{2M}^k·O_k for k = 0..M (W_{2M}^M = -1).
  for (int k = lane; k <= M; k += 32) {
    const float2 p = z[zpad(k & (M - 1), sh)], q = z[zpad((M - k) & (M - 1), sh)];
    const float er = 0.5f * (p.x + q.x), ei = 0.5f * (p.y - q.y);
    const float orr = 0.5f * (p.y + q.y), oi = -0.5f * (p.x - q.x);
    const float2 w = k < M ? tw[M + k] : make_float2(-1.0f, 0.0f);
    const float xr = er + w.x * orr - w.y * oi, xi = ei + w.x * oi + w.y * orr;
    pw[k] = xr * xr + xi * xi;
  }
}

// Dynamic shared memory of logmel_fft_kernel: twiddles [2M] and the warps'
// scratch [F][zstride] (float2), the mel ranges [n_mels] (int4), then the
// window [win], the powers [F][M+1], the packed mel weights [nnz] (if
// staged) and the frame span [(F-1)·ld + win] (floats), each a multiple of
// 16 bytes.
inline size_t fft_smem_bytes(int M, int win, int ld, int n_mels, int nnz_staged) {
  const size_t r4 = 3;
  const int log2m = __builtin_ctz(M);
  return 8 * ((size_t)2 * M + (size_t)kFftFrames * zstride(log2m)) + 16 * (size_t)n_mels +
         4 * (((size_t)win + r4) & ~r4) + 4 * (((size_t)kFftFrames * (M + 1) + r4) & ~r4) +
         4 * (((size_t)nnz_staged + r4) & ~r4) + 4 * (size_t)((kFftFrames - 1) * ld + win);
}

// The mel weights go to shared memory when they fit beside the rest (a
// filterbank of triangles has about two weights a bin; a dense one may not).
inline int fft_staged_weights(int M, int win, int ld, int n_mels, int nnz) {
  return fft_smem_bytes(M, win, ld, n_mels, nnz) <= (size_t)mmb::kMaxSmemBytes ? nnz : 0;
}

template <int kEpi>
__global__ void __launch_bounds__(32 * kFftFrames) logmel_fft_kernel(
    const float* __restrict__ frames, long long stride_b, long long stride_t,
    int ld,                               // frame f of the block starts at span[f * ld]
    const float* __restrict__ window,     // [win]
    const float2* __restrict__ twiddle,   // [n_fft]: the stages', then the split's
    const float* __restrict__ mel_w,      // [nnz]: each mel column's weights lo..hi, packed
    const int4* __restrict__ mel_range,   // [n_mels]: lo, hi, offset into mel_w, 0
    float* __restrict__ out,              // [B, T, n_mels]
    int T, int win, int log2m, int n_mels, int nnz_staged) {
  extern __shared__ __align__(16) float smem[];
  const int M = 1 << log2m, bins = M + 1, zs = zstride(log2m);
  float2* tw_s = reinterpret_cast<float2*>(smem);  // [2M]
  float2* z_s = tw_s + 2 * M;                       // [F][zs]
  int4* mr_s = reinterpret_cast<int4*>(z_s + kFftFrames * zs);  // [n_mels]
  float* w_s = reinterpret_cast<float*>(mr_s + n_mels);         // [win]
  float* pw_s = w_s + ((win + 3) & ~3);                          // [F][bins]
  float* mw_s = pw_s + ((kFftFrames * bins + 3) & ~3);           // [nnz_staged]
  float* x_s = mw_s + ((nnz_staged + 3) & ~3);                   // the frames' span
  const int b = blockIdx.y, t0 = blockIdx.x * kFftFrames, tid = threadIdx.x;
  const int nf = min(kFftFrames, T - t0), lane = tid & 31, warp = tid >> 5;
  const float* fb = frames + (size_t)b * stride_b + (size_t)t0 * stride_t;

  // 1. the span (contiguous where the frames overlap or abut, frame by frame
  // otherwise), the window, the twiddles and the mel ranges and weights
  const int span = (nf - 1) * ld + win;
  if (ld == stride_t) {
    for (int e = tid; e < span; e += blockDim.x) mmb::cp_async4(x_s + e, fb + e, true);
  } else {
    for (int e = tid; e < span; e += blockDim.x)
      mmb::cp_async4(x_s + e, fb + (size_t)(e / win) * stride_t + e % win, true);
  }
  for (int e = tid; e < win; e += blockDim.x) mmb::cp_async4(w_s + e, window + e, true);
  const auto copy = [&](void* dst, const void* src, int n) {
    for (int e = tid; e < n; e += blockDim.x)
      mmb::cp_async4(static_cast<float*>(dst) + e, static_cast<const float*>(src) + e, true);
  };
  copy(tw_s, twiddle, 4 * M);
  copy(mr_s, mel_range, 4 * n_mels);
  copy(mw_s, mel_w, nnz_staged);
  mmb::cp_async_wait_all();
  __syncthreads();

  // 2. a warp a frame
  if (warp < nf)
    frame_power_fft(x_s + warp * ld, w_s, win, tw_s, log2m, z_s + warp * zs, pw_s + warp * bins,
                    lane);
  __syncthreads();

  // 3. the mel product over each column's nonzero bins in ascending k, then
  // the epilogue
  const float* mw = nnz_staged ? mw_s : mel_w;
  for (int e = tid; e < nf * n_mels; e += blockDim.x) {
    const int f = e / n_mels, m = e - f * n_mels;
    const float* pw = pw_s + f * bins;
    const int4 r = mr_s[m];
    const float* w = mw + r.z - r.x;
    float acc = 0.0f;
    for (int k = r.x; k <= r.y; ++k) acc = fmaf(pw[k], w[k], acc);
    out[((size_t)b * T + t0 + f) * n_mels + m] = kEpi == kLogMel ? logf(acc + 1e-6f) : acc;
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

// K4's FFT route: out [B, T, n_mels] as mmb_log_mel_forward, from the
// window [win], the twiddles [n_fft] (float2: W_{2·half}^pos at half + pos
// for each stage, then W_{n_fft}^k at n_fft/2 + k), and the
// filterbank's nonzeros: each mel column's first and last nonzero bin and
// the offset of its weights in mel_w (int4 [n_mels]), and the weights
// (mel_w [nnz]). n_fft a power of two from 16 to 2048, win <= n_fft.
MMB_API int mmb_log_mel_fft_forward(const void* frames, long long stride_b, long long stride_t,
                                    const void* window, const void* twiddle, const void* mel_w,
                                    const void* mel_range, void* out, int B, int T, int win,
                                    int n_fft, int n_mels, int nnz, int log, void* stream) {
  if (B <= 0 || T <= 0 || win <= 0 || n_mels <= 0 || nnz < 0 || n_fft < 16 || n_fft > 2048 ||
      (n_fft & (n_fft - 1)) != 0 || win > n_fft)
    return (int)cudaErrorInvalidValue;
  const int M = n_fft / 2, log2m = __builtin_ctz(M);
  // overlapping or abutting frames are staged as their span, others one by one
  const int ld = stride_t > 0 && stride_t <= win ? (int)stride_t : win;
  const int staged = fft_staged_weights(M, win, ld, n_mels, nnz);
  const size_t smem = fft_smem_bytes(M, win, ld, n_mels, staged);
  if (smem > (size_t)mmb::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const auto kernel = log ? logmel_fft_kernel<kLogMel> : logmel_fft_kernel<kMelPower>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((T + kFftFrames - 1) / kFftFrames, B), 32 * kFftFrames, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), stride_b, stride_t, ld,
      static_cast<const float*>(window), static_cast<const float2*>(twiddle),
      static_cast<const float*>(mel_w), static_cast<const int4*>(mel_range),
      static_cast<float*>(out), T, win, log2m, n_mels, staged);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of K4's FFT route asks for, in bytes (ld:
// the distance between frames in the staged span, stride_t or win).
MMB_API int mmb_log_mel_fft_smem_bytes(int n_fft, int win, int ld, int n_mels, int nnz) {
  const int M = n_fft / 2;
  return (int)fft_smem_bytes(M, win, ld, n_mels, fft_staged_weights(M, win, ld, n_mels, nnz));
}
