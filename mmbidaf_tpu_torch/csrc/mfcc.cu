// K3 — MFCC: windowed DFT -> |.|^2 -> mel -> dB (per-example max) -> DCT,
// and K4 — the frame-tiled mel spectrogram, log or raw, on the same passes.
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
// What bounds them on the H100: the bytes (each waveform sample read once,
// each output written once) once the DFT is an FFT (2.5·N·log2 N operations
// a frame, ~1/27 of the dense DFT's 2 x win x bins multiply-adds at N = 512).
// The TPU held a whole example in VMEM; on the card one example's frames
// ([512, 400] = 800 KB) and each dense DFT basis ([400, 257] = 411 KB) do
// not fit a block, and the dB reference is the maximum over the WHOLE
// example. So K3 runs two passes: a pass over frame tiles that writes the
// dB log-mel rows and each tile's maximum, then a DCT pass that takes the
// example's maximum over the tile maxima, clamps at -80 dB and applies the
// DCT (mfcc_dct_kernel).
//
// The FFT route (logmel_fft_kernel), for a power-of-two n_fft from 16 to
// 8192 (K4) or 4096 (K3) and win <= n_fft (the configurations' 512; the
// wrapper checks once per consts that cos/sin are the window's DFT basis of
// n_fft): the bases fold a periodic window and a zero pad at the end into
// the DFT, so frames@cos and frames@sin are the real and imaginary parts of
// rfft(window · frame, n = n_fft). A block takes F consecutive frames of
// one example, one warp a frame, F the most of 8, 4, 2, 1 whose block fits
// its shared memory (fft_geometry: 8 to n_fft 2048; at 4096, 4 for K4 and
// 2 for K3's f64; at 8192, K4 only, 2 or 1):
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
//    (fmaf(p, 0, acc) == acc), and the epilogue, rows written coalesced:
//    K4's log or raw mel, or K3's dB and the block's maximum.
// K3's FFT runs in f64 (K4's in f32). Its dB turns a relative power error ε
// into ≈ 4.3·ε dB, and an FFT's rounding is relative to the frame's own
// energy, so weak mel bands far below a frame's peak carry the largest
// errors. On a loud sine over weak noise with a quiet stretch (mel bands
// more than 60 dB apart) at B=64, T=512, tools/mfcc_variants.py measured on
// an H100 this body in f32 8.4e-4 from an f64 MFCC, the dense f32 DFT (the
// plain version) 5.5e-4 and this body in f64 2.8e-4; the f64 body takes
// 0.22 ms a call against the f32 body's 0.15 (its complex values take
// twice the shared-memory bytes: 61,936 B a block against 40,432, three
// blocks an SM against five).
// The dense route (logmel_tile_kernel<kEpi, F>) takes every other n_fft: a
// tile of F frames in shared memory, a thread a frequency bin with F real
// and imaginary sums in registers, cos/sin read from L2 (or, past its 50 MB,
// device memory). F is chosen at launch (dense_frames): the most of 32, 16,
// …, 1 whose frames and spectra, 4·(F·(win + bins) + 32) bytes, fit a
// block's 227 KB: 32 to win + bins = 1,815, 1 to ~58,000 (n_fft 32,768). It
// is O(win·bins) a frame, ~1,600x the FFT's operations at n_fft 16,384, and
// each block reads both bases once: slow by design past the FFT route.
// K3's DCT pass tiles the frames on its own (kDctFrames a block) and reads
// the first pass's block maxima, however many frames those blocks took.
// The frames are read through their strides, so the framing of the
// waveform stays a strided view and is never copied.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kDctFrames = 32;  // frames a block of K3's DCT pass

// ln(10) rounded to f32: log10 as log(x)/log(10), the way jnp.log10 computes it.
constexpr float kLn10 = 2.302585093f;

// Epilogues of the tile pass.
enum Epilogue { kDb = 0, kLogMel = 1, kMelPower = 2 };

template <int kEpi, int kTF>
__global__ void __launch_bounds__(512) logmel_tile_kernel(
    const float* __restrict__ frames, long long stride_b, long long stride_t,
    const float* __restrict__ cos_b, const float* __restrict__ sin_b,  // [win, bins]
    const float* __restrict__ mel,                                     // [bins, n_mels]
    float* __restrict__ logmel,                                        // [B, T, n_mels]
    float* __restrict__ tile_max,                                      // [B, tiles] (kDb only)
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
    if (tid == 0) tile_max[(size_t)b * gridDim.x + tile] = v;
  }
}

// The dense route's dynamic shared memory a block for F frames a tile.
inline size_t dense_smem_bytes(int F, int win, int bins) {
  return sizeof(float) * ((size_t)F * ((size_t)win + bins) + 32);
}

// The dense route's frames a tile: the most of 32, 16, …, 1 that fits a
// block's shared memory; 0 if not even one frame does.
inline int dense_frames(int win, int bins) {
  for (int F = 32; F >= 1; F /= 2)
    if (dense_smem_bytes(F, win, bins) <= (size_t)mmb::kMaxSmemBytes) return F;
  return 0;
}

// f(the tile pass instantiated for F frames a tile).
template <int kEpi, typename Fn>
auto with_dense_kernel(int F, Fn f) {
  return F == 32   ? f(logmel_tile_kernel<kEpi, 32>)
         : F == 16 ? f(logmel_tile_kernel<kEpi, 16>)
         : F == 8  ? f(logmel_tile_kernel<kEpi, 8>)
         : F == 4  ? f(logmel_tile_kernel<kEpi, 4>)
         : F == 2  ? f(logmel_tile_kernel<kEpi, 2>)
                   : f(logmel_tile_kernel<kEpi, 1>);
}

// The tile pass with the epilogue kEpi at dense_frames(win, bins) frames a
// tile; tile_max [B, ceil(T / F)] (kDb only). *tiles gets ceil(T / F).
template <int kEpi>
cudaError_t launch_dense(const void* frames, long long stride_b, long long stride_t,
                         const void* cos_b, const void* sin_b, const void* mel, float* out,
                         float* tile_max, int B, int T, int win, int bins, int n_mels,
                         cudaStream_t s, int* tiles) {
  const int F = dense_frames(win, bins);
  if (F == 0) return cudaErrorInvalidValue;
  const size_t smem = dense_smem_bytes(F, win, bins);
  *tiles = (T + F - 1) / F;
  return with_dense_kernel<kEpi>(F, [&](auto kernel) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(*tiles, B), mmb::threads_for(bins, 512), smem, s>>>(
        static_cast<const float*>(frames), stride_b, stride_t, static_cast<const float*>(cos_b),
        static_cast<const float*>(sin_b), static_cast<const float*>(mel), out, tile_max, T, win,
        bins, n_mels);
    return cudaGetLastError();
  });
}

// K3's second pass: grid (tiles of kDctFrames frames, examples); the
// example's maximum over the first pass's ntiles block maxima, then the
// clamp and the DCT of the tile's rows.
__global__ void __launch_bounds__(256) mfcc_dct_kernel(
    const float* __restrict__ logmel, const float* __restrict__ tile_max,  // [B, ntiles]
    int ntiles,
    const float* __restrict__ dct,  // [n_mels, n_mfcc]
    float* __restrict__ out,        // [B, T, n_mfcc]
    int T, int n_mels, int n_mfcc) {
  extern __shared__ float db_s[];  // [kDctFrames][n_mels]
  __shared__ float ref_s;
  const int b = blockIdx.y, t0 = blockIdx.x * kDctFrames, tid = threadIdx.x;
  const int nf = min(kDctFrames, T - t0);
  if (tid < 32) {
    float mx = -INFINITY;
    for (int i = tid; i < ntiles; i += 32) mx = fmaxf(mx, tile_max[(size_t)b * ntiles + i]);
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

constexpr int kFftFrames = 8;  // the most frames a block of the FFT route, a warp each
// The FFT route's largest n_fft: K4's (f32), K3's (f64 scratch and twiddles).
constexpr int kFftMaxN = 8192, kFftMaxN64 = 4096;

// Where z[i] sits in a warp's FFT scratch: one float2 of padding every
// M/16 entries, so that the bit-reversed stores of a half-warp (16 lanes,
// 8 bytes each) land in 16 distinct bank pairs, as do the butterflies.
__device__ __forceinline__ int zpad(int i, int sh) { return i + (i >> sh); }
__host__ __device__ inline int zpad_shift(int log2m) { return log2m > 4 ? log2m - 4 : 0; }
__host__ __device__ inline int zstride(int log2m) {
  return (1 << log2m) + ((1 << log2m) >> zpad_shift(log2m));
}

// The FFT's working precision by epilogue: f64 for K3's dB (see the
// header), f32 for K4. Cplx<R> is its complex type.
template <int kEpi> struct FftReal { using T = float; };
template <> struct FftReal<kDb> { using T = double; };
template <typename R> struct Cplx;
template <> struct Cplx<float> { using T = float2; };
template <> struct Cplx<double> { using T = double2; };

// One warp: the power spectrum |rfft(window · x, n = 2M)|² of one frame into
// pw[0..M], computed in R. x and wnd hold win samples (zero past win);
// tw[half + pos] = W_{2·half}^pos for the stage of butterfly span 2·half
// (half < M), tw[M + k] = W_{2M}^k for the split (k < M), W = e^{-2πi/n};
// z is the warp's [zstride] scratch; M = 2^log2m >= 8.
template <typename R>
__device__ __forceinline__ void frame_power_fft(const float* x, const float* wnd, int win,
                                                const typename Cplx<R>::T* tw, int log2m,
                                                typename Cplx<R>::T* z, float* pw, int lane) {
  using C2 = typename Cplx<R>::T;
  const int M = 1 << log2m, sh = zpad_shift(log2m);
  for (int n = lane; n < M; n += 32) {
    const int a = 2 * n, b = a + 1;
    z[zpad(__brev(n) >> (32 - log2m), sh)] =
        C2{a < win ? R(x[a]) * R(wnd[a]) : R(0), b < win ? R(x[b]) * R(wnd[b]) : R(0)};
  }
  __syncwarp();
  for (int s = 0; s < log2m; ++s) {
    const int half = 1 << s;
    for (int j = lane; j < M / 2; j += 32) {
      const int pos = j & (half - 1);
      const int i = ((j >> s) << (s + 1)) + pos;
      const int i0 = zpad(i, sh), i1 = zpad(i + half, sh);
      const C2 w = tw[half + pos];
      const C2 p = z[i0], q = z[i1];
      const R qr = q.x * w.x - q.y * w.y, qi = q.x * w.y + q.y * w.x;
      z[i0] = C2{p.x + qr, p.y + qi};
      z[i1] = C2{p.x - qr, p.y - qi};
    }
    __syncwarp();
  }
  // Z = E + i·O with E, O the spectra of the even and odd samples:
  // E_k = (Z_k + conj Z_{M-k}) / 2, O_k = (Z_k - conj Z_{M-k}) / 2i,
  // X_k = E_k + W_{2M}^k·O_k for k = 0..M (W_{2M}^M = -1).
  for (int k = lane; k <= M; k += 32) {
    const C2 p = z[zpad(k & (M - 1), sh)], q = z[zpad((M - k) & (M - 1), sh)];
    const R er = R(0.5) * (p.x + q.x), ei = R(0.5) * (p.y - q.y);
    const R orr = R(0.5) * (p.y + q.y), oi = R(-0.5) * (p.x - q.x);
    const C2 w = k < M ? tw[M + k] : C2{R(-1), R(0)};
    const R xr = er + w.x * orr - w.y * oi, xi = ei + w.x * oi + w.y * orr;
    pw[k] = static_cast<float>(xr * xr + xi * xi);
  }
}

// Dynamic shared memory of logmel_fft_kernel at F frames a block: twiddles
// [2M] and the warps' scratch [F][zstride] (complex of cbytes: 8 for f32, 16
// for f64), the mel ranges [n_mels] (int4), then the window [win], the
// powers [F][M+1], the packed mel weights [nnz] (if staged) and the frame
// span [(F-1)·ld + win] (floats), each a multiple of 16 bytes.
inline size_t fft_smem_bytes(int M, int win, int ld, int n_mels, int nnz_staged, int cbytes,
                             int F) {
  const size_t r4 = 3;
  const int log2m = __builtin_ctz(M);
  return cbytes * ((size_t)2 * M + (size_t)F * zstride(log2m)) + 16 * (size_t)n_mels +
         4 * (((size_t)win + r4) & ~r4) + 4 * (((size_t)F * (M + 1) + r4) & ~r4) +
         4 * (((size_t)nnz_staged + r4) & ~r4) + 4 * (size_t)((size_t)(F - 1) * ld + win);
}

// The mel weights go to shared memory when they fit beside the rest (a
// filterbank of triangles has about two weights a bin; a dense one may not).
inline int fft_staged_weights(int M, int win, int ld, int n_mels, int nnz, int cbytes, int F) {
  return fft_smem_bytes(M, win, ld, n_mels, nnz, cbytes, F) <= (size_t)mmb::kMaxSmemBytes ? nnz
                                                                                          : 0;
}

// A block of blockDim.x / 32 frames (at most kFftFrames).
template <int kEpi>
__global__ void __launch_bounds__(32 * kFftFrames) logmel_fft_kernel(
    const float* __restrict__ frames, long long stride_b, long long stride_t,
    int ld,                               // frame f of the block starts at span[f * ld]
    const float* __restrict__ window,     // [win]
    const typename Cplx<typename FftReal<kEpi>::T>::T* __restrict__ twiddle,
                                          // [n_fft]: the stages', then the split's
    const float* __restrict__ mel_w,      // [nnz]: each mel column's weights lo..hi, packed
    const int4* __restrict__ mel_range,   // [n_mels]: lo, hi, offset into mel_w, 0
    float* __restrict__ out,              // [B, T, n_mels]
    float* __restrict__ tile_max,         // [B, blocks along x] (kDb only)
    int T, int win, int log2m, int n_mels, int nnz_staged) {
  using R = typename FftReal<kEpi>::T;
  using C2 = typename Cplx<R>::T;
  extern __shared__ __align__(16) float smem[];
  const int M = 1 << log2m, bins = M + 1, zs = zstride(log2m), F = blockDim.x >> 5;
  C2* tw_s = reinterpret_cast<C2*>(smem);  // [2M]
  C2* z_s = tw_s + 2 * M;                   // [F][zs]
  int4* mr_s = reinterpret_cast<int4*>(z_s + F * zs);   // [n_mels]
  float* w_s = reinterpret_cast<float*>(mr_s + n_mels);  // [win]
  float* pw_s = w_s + ((win + 3) & ~3);                   // [F][bins]
  float* mw_s = pw_s + ((F * bins + 3) & ~3);             // [nnz_staged]
  float* x_s = mw_s + ((nnz_staged + 3) & ~3);            // the frames' span
  const int b = blockIdx.y, t0 = blockIdx.x * F, tid = threadIdx.x;
  const int nf = min(F, T - t0), lane = tid & 31, warp = tid >> 5;
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
  copy(tw_s, twiddle, 2 * M * (int)(sizeof(C2) / sizeof(float)));
  copy(mr_s, mel_range, 4 * n_mels);
  copy(mw_s, mel_w, nnz_staged);
  mmb::cp_async_wait_all();
  __syncthreads();

  // 2. a warp a frame
  if (warp < nf)
    frame_power_fft<R>(x_s + warp * ld, w_s, win, tw_s, log2m, z_s + warp * zs,
                       pw_s + warp * bins, lane);
  __syncthreads();

  // 3. the mel product over each column's nonzero bins in ascending k, then
  // the epilogue (K3: dB, as the dense pass, and the block's maximum)
  const float* mw = nnz_staged ? mw_s : mel_w;
  float local_max = -INFINITY;
  for (int e = tid; e < nf * n_mels; e += blockDim.x) {
    const int f = e / n_mels, m = e - f * n_mels;
    const float* pw = pw_s + f * bins;
    const int4 r = mr_s[m];
    const float* w = mw + r.z - r.x;
    float acc = 0.0f;
    for (int k = r.x; k <= r.y; ++k) acc = fmaf(pw[k], w[k], acc);
    float v = acc;
    if (kEpi == kLogMel) v = logf(acc + 1e-6f);
    if (kEpi == kDb) v = 10.0f * (logf(fmaxf(acc, 1e-10f)) / kLn10);
    out[((size_t)b * T + t0 + f) * n_mels + m] = v;
    local_max = fmaxf(local_max, v);
  }
  if constexpr (kEpi == kDb) {
    __shared__ float red[kFftFrames];
    local_max = mmb::warp_max(local_max);
    if (lane == 0) red[warp] = local_max;
    __syncthreads();
    if (warp == 0) {
      float v = lane < F ? red[lane] : -INFINITY;
      v = mmb::warp_max(v);
      if (lane == 0) tile_max[(size_t)b * gridDim.x + blockIdx.x] = v;
    }
  }
}

// K3's second pass, on the first pass's dB rows and ntiles block maxima an
// example; past 48 KB (n_mels > 384) its block opts in to more shared
// memory, to n_mels = 1,815.
int launch_dct(const float* logmel, const float* tile_max, int ntiles, const void* dct, void* out,
               int B, int T, int n_mels, int n_mfcc, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)kDctFrames * n_mels;
  if (smem + sizeof(float) > (size_t)mmb::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      mfcc_dct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  mfcc_dct_kernel<<<dim3((T + kDctFrames - 1) / kDctFrames, B), 256, smem, s>>>(
      logmel, tile_max, ntiles, static_cast<const float*>(dct), static_cast<float*>(out), T,
      n_mels, n_mfcc);
  return (int)cudaGetLastError();
}

// The FFT route's validity and block geometry (shared by K3 and K4):
// overlapping or abutting frames are staged as their span, others one by
// one; F frames a block, the most of 8, 4, 2, 1 whose block fits, and at
// that F the mel weights are staged when they fit beside the rest.
struct FftGeometry {
  int M, log2m, ld, staged, frames;
  size_t smem;
};

bool fft_geometry(int B, int T, int win, int n_fft, int n_mels, int nnz, long long stride_t,
                  int cbytes, FftGeometry* g) {
  const int max_n = cbytes > (int)sizeof(float2) ? kFftMaxN64 : kFftMaxN;
  if (B <= 0 || T <= 0 || win <= 0 || n_mels <= 0 || nnz < 0 || n_fft < 16 || n_fft > max_n ||
      (n_fft & (n_fft - 1)) != 0 || win > n_fft)
    return false;
  g->M = n_fft / 2;
  g->log2m = __builtin_ctz(g->M);
  g->ld = stride_t > 0 && stride_t <= win ? (int)stride_t : win;
  for (int F = kFftFrames; F >= 1; F /= 2) {
    g->staged = fft_staged_weights(g->M, win, g->ld, n_mels, nnz, cbytes, F);
    g->smem = fft_smem_bytes(g->M, win, g->ld, n_mels, g->staged, cbytes, F);
    g->frames = F;
    if (g->smem <= (size_t)mmb::kMaxSmemBytes) return true;
  }
  return false;
}

}  // namespace

// K3's dense route: logmel [B, T, n_mels] and tile_max [B, ceil(T / F)]
// (F = dense_frames(win, bins); [B, T] always suffices) are scratch.
MMB_API int mmb_mfcc_forward(const void* frames, long long stride_b, long long stride_t,
                             const void* cos_b, const void* sin_b, const void* mel,
                             const void* dct, void* logmel, void* tile_max, void* out, int B,
                             int T, int win, int bins, int n_mels, int n_mfcc, void* stream) {
  if (B <= 0 || T <= 0 || win <= 0 || bins <= 0 || n_mels <= 0 || n_mfcc <= 0)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  int ntiles = 0;
  const cudaError_t e = launch_dense<kDb>(frames, stride_b, stride_t, cos_b, sin_b, mel,
                                          static_cast<float*>(logmel),
                                          static_cast<float*>(tile_max), B, T, win, bins, n_mels,
                                          s, &ntiles);
  if (e != cudaSuccess) return (int)e;
  return launch_dct(static_cast<const float*>(logmel), static_cast<const float*>(tile_max), ntiles,
                    dct, out, B, T, n_mels, n_mfcc, s);
}

// K3's FFT route: out [B, T, n_mfcc] as mmb_mfcc_forward, from the window,
// the f64 twiddles (double2 [n_fft], laid out as K4's), the filterbank's
// nonzeros (as for mmb_log_mel_fft_forward) and the DCT; logmel [B, T,
// n_mels] and tile_max [B, ceil(T / F)] (F the geometry's frames a block,
// 8 to n_fft 2048; [B, T] always suffices) are scratch. n_fft a power of
// two from 16 to 4096, win <= n_fft.
MMB_API int mmb_mfcc_fft_forward(const void* frames, long long stride_b, long long stride_t,
                                 const void* window, const void* twiddle, const void* mel_w,
                                 const void* mel_range, const void* dct, void* logmel,
                                 void* tile_max, void* out, int B, int T, int win, int n_fft,
                                 int n_mels, int nnz, int n_mfcc, void* stream) {
  using C2 = Cplx<FftReal<kDb>::T>::T;
  FftGeometry g;
  if (n_mfcc <= 0 || !fft_geometry(B, T, win, n_fft, n_mels, nnz, stride_t, sizeof(C2), &g))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int ntiles = (T + g.frames - 1) / g.frames;
  cudaError_t e = cudaFuncSetAttribute(logmel_fft_kernel<kDb>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (e != cudaSuccess) return (int)e;
  logmel_fft_kernel<kDb><<<dim3(ntiles, B), 32 * g.frames, g.smem, s>>>(
      static_cast<const float*>(frames), stride_b, stride_t, g.ld,
      static_cast<const float*>(window), static_cast<const C2*>(twiddle),
      static_cast<const float*>(mel_w), static_cast<const int4*>(mel_range),
      static_cast<float*>(logmel), static_cast<float*>(tile_max), T, win, g.log2m, n_mels,
      g.staged);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_dct(static_cast<const float*>(logmel), static_cast<const float*>(tile_max), ntiles,
                    dct, out, B, T, n_mels, n_mfcc, s);
}

// K4: the tile pass alone; out [B, T, n_mels] = log(mel + 1e-6) (log != 0) or the raw mel.
MMB_API int mmb_log_mel_forward(const void* frames, long long stride_b, long long stride_t,
                                const void* cos_b, const void* sin_b, const void* mel,
                                void* out, int B, int T, int win, int bins, int n_mels, int log,
                                void* stream) {
  if (B <= 0 || T <= 0 || win <= 0 || bins <= 0 || n_mels <= 0) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  int tiles = 0;
  return (int)(log ? launch_dense<kLogMel>(frames, stride_b, stride_t, cos_b, sin_b, mel, o,
                                           nullptr, B, T, win, bins, n_mels, s, &tiles)
                   : launch_dense<kMelPower>(frames, stride_b, stride_t, cos_b, sin_b, mel, o,
                                             nullptr, B, T, win, bins, n_mels, s, &tiles));
}

// K4's FFT route: out [B, T, n_mels] as mmb_log_mel_forward, from the
// window [win], the twiddles [n_fft] (float2: W_{2·half}^pos at half + pos
// for each stage, then W_{n_fft}^k at n_fft/2 + k), and the
// filterbank's nonzeros: each mel column's first and last nonzero bin and
// the offset of its weights in mel_w (int4 [n_mels]), and the weights
// (mel_w [nnz]). n_fft a power of two from 16 to 8192, win <= n_fft.
MMB_API int mmb_log_mel_fft_forward(const void* frames, long long stride_b, long long stride_t,
                                    const void* window, const void* twiddle, const void* mel_w,
                                    const void* mel_range, void* out, int B, int T, int win,
                                    int n_fft, int n_mels, int nnz, int log, void* stream) {
  FftGeometry g;
  if (!fft_geometry(B, T, win, n_fft, n_mels, nnz, stride_t, sizeof(float2), &g))
    return (int)cudaErrorInvalidValue;
  const auto kernel = log ? logmel_fft_kernel<kLogMel> : logmel_fft_kernel<kMelPower>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)g.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((T + g.frames - 1) / g.frames, B), 32 * g.frames, g.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), stride_b, stride_t, g.ld,
      static_cast<const float*>(window), static_cast<const float2*>(twiddle),
      static_cast<const float*>(mel_w), static_cast<const int4*>(mel_range),
      static_cast<float*>(out), nullptr, T, win, g.log2m, n_mels, g.staged);
  return (int)cudaGetLastError();
}

// K4's FFT route's block (f64 != 0: K3's) for these operands (ld: the
// distance between frames in the staged span, stride_t or win) into out[3]:
// frames a block, mel weights staged, dynamic shared memory in bytes.
// Returns 0, or cudaErrorInvalidValue where the route does not take them.
MMB_API int mmb_log_mel_fft_plan(int n_fft, int win, int ld, int n_mels, int nnz, int f64,
                                 int* out) {
  const int cbytes = f64 ? sizeof(Cplx<FftReal<kDb>::T>::T) : sizeof(float2);
  FftGeometry g;
  if (!fft_geometry(1, 1, win, n_fft, n_mels, nnz, ld, cbytes, &g))
    return (int)cudaErrorInvalidValue;
  out[0] = g.frames, out[1] = g.staged, out[2] = (int)g.smem;
  return 0;
}

// Dynamic shared memory a block of K4's FFT route (f64 != 0: K3's) asks
// for, in bytes, at the plan's frames a block (mmb_log_mel_fft_plan); 0
// where the route does not take the operands.
MMB_API int mmb_log_mel_fft_smem_bytes(int n_fft, int win, int ld, int n_mels, int nnz, int f64) {
  int out[3];
  return mmb_log_mel_fft_plan(n_fft, win, ld, n_mels, nnz, f64, out) == 0 ? out[2] : 0;
}

// The dense route's frames a block for [win, bins] bases (0: no route).
MMB_API int mmb_mel_dense_frames(int win, int bins) { return dense_frames(win, bins); }
