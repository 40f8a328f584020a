// mmbidaf_native: host-side decode + batch-assembly runtime in C++, the
// PyTorch port's copy of the JAX package's native/mmbidaf_native.cpp.
//
// PNG and JPEG keyframes (libpng / libjpeg), WAV and PPM decode, waveform
// padding and keyframe sampling run in an in-process thread pool off the
// GIL, feeding the card's frontend. Exposed as a plain C ABI consumed via
// ctypes (mmbidaf_tpu_torch/native/loader.py, which builds this file with
// g++ at first use into mmbidaf_tpu_torch/_build/).
//
// Differences from the JAX package's copy: no mmb_version (the loader keys
// the library's file name on a hash of this source and its flags), and
// mmb_codecs reports which codecs the build linked.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// Codec availability is decided by the loader's link probes (-DMMB_HAVE_*
// + -lpng/-ljpeg together) so the compile-time gates can never disagree
// with what the linker actually provides — a header-only __has_include
// gate here once produced a .so with undefined codec symbols that failed
// dlopen and silently disabled the whole native runtime.
#ifdef MMB_HAVE_PNG
#include <png.h>
#endif
#ifdef MMB_HAVE_JPEG
#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode (PCM 8/16/32-bit, mono-mixed) → float32 in [-1, 1].
// Returns number of samples written, or -1 on parse error.
// ---------------------------------------------------------------------------
long mmb_wav_decode(const uint8_t* data, long n, float* out, long out_cap,
                    int* sample_rate_out) {
  if (n < 44 || std::memcmp(data, "RIFF", 4) != 0 ||
      std::memcmp(data + 8, "WAVE", 4) != 0)
    return -1;

  long pos = 12;
  int channels = 0, bits = 0, sample_rate = 0;
  const uint8_t* pcm = nullptr;
  long pcm_bytes = 0;

  while (pos + 8 <= n) {
    const uint8_t* hdr = data + pos;
    uint32_t chunk_size;
    std::memcpy(&chunk_size, hdr + 4, 4);
    if (std::memcmp(hdr, "fmt ", 4) == 0 && pos + 8 + 16 <= n) {
      uint16_t ch, bps;
      uint32_t sr;
      std::memcpy(&ch, hdr + 10, 2);
      std::memcpy(&sr, hdr + 12, 4);
      std::memcpy(&bps, hdr + 22, 2);
      channels = ch;
      sample_rate = (int)sr;
      bits = bps;
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      pcm = hdr + 8;
      pcm_bytes = std::min((long)chunk_size, n - pos - 8);
    }
    pos += 8 + chunk_size + (chunk_size & 1);
  }
  if (!pcm || channels <= 0 || bits <= 0) return -1;

  long bytes_per_frame = channels * bits / 8;
  long frames = pcm_bytes / bytes_per_frame;
  long out_n = std::min(frames, out_cap);
  for (long i = 0; i < out_n; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* p = pcm + i * bytes_per_frame + c * bits / 8;
      double v = 0.0;
      if (bits == 16) {
        int16_t s;
        std::memcpy(&s, p, 2);
        v = s / 32768.0;
      } else if (bits == 32) {
        int32_t s;
        std::memcpy(&s, p, 4);
        v = s / 2147483648.0;
      } else if (bits == 8) {
        v = ((int)p[0] - 128) / 128.0;
      }
      acc += v;
    }
    out[i] = (float)(acc / channels);
  }
  if (sample_rate_out) *sample_rate_out = sample_rate;
  return out_n;
}

// ---------------------------------------------------------------------------
// Binary PPM (P6, maxval 255) decode → uint8 HWC. Returns 0 on success.
// ---------------------------------------------------------------------------
static long ppm_token(const uint8_t* d, long n, long pos, long* value) {
  // skip whitespace + comments
  while (pos < n) {
    if (d[pos] == '#') {
      while (pos < n && d[pos] != '\n') ++pos;
    } else if (d[pos] == ' ' || d[pos] == '\t' || d[pos] == '\n' ||
               d[pos] == '\r') {
      ++pos;
    } else {
      break;
    }
  }
  long v = 0;
  bool any = false;
  while (pos < n && d[pos] >= '0' && d[pos] <= '9') {
    v = v * 10 + (d[pos] - '0');
    ++pos;
    any = true;
  }
  if (!any) return -1;
  *value = v;
  return pos;
}

int mmb_ppm_header(const uint8_t* data, long n, long* width, long* height) {
  if (n < 2 || data[0] != 'P' || data[1] != '6') return -1;
  long pos = 2, w, h, maxval;
  pos = ppm_token(data, n, pos, &w);
  if (pos < 0) return -1;
  pos = ppm_token(data, n, pos, &h);
  if (pos < 0) return -1;
  pos = ppm_token(data, n, pos, &maxval);
  if (pos < 0 || maxval != 255) return -1;
  *width = w;
  *height = h;
  return 0;
}

int mmb_ppm_decode(const uint8_t* data, long n, uint8_t* out, long out_cap) {
  if (n < 2 || data[0] != 'P' || data[1] != '6') return -1;
  long pos = 2, w, h, maxval;
  pos = ppm_token(data, n, pos, &w);
  if (pos < 0) return -1;
  pos = ppm_token(data, n, pos, &h);
  if (pos < 0) return -1;
  pos = ppm_token(data, n, pos, &maxval);
  if (pos < 0 || maxval != 255) return -1;
  ++pos;  // single whitespace after maxval
  long need = w * h * 3;
  if (n - pos < need || out_cap < need) return -1;
  std::memcpy(out, data + pos, need);
  return 0;
}

// ---------------------------------------------------------------------------
// Parallel waveform pad/normalize: scatter many variable-length float32
// waveforms into one zero-padded [batch, num_samples] buffer with a thread
// pool (the collate hot loop, off the GIL).
// ---------------------------------------------------------------------------
void mmb_pad_waveforms(const float** waves, const long* lengths, long batch,
                       long num_samples, float* out, int num_threads) {
  std::memset(out, 0, sizeof(float) * batch * num_samples);
  if (num_threads < 1) num_threads = 1;
  std::atomic<long> next(0);
  auto worker = [&]() {
    long i;
    while ((i = next.fetch_add(1)) < batch) {
      long n = std::min(lengths[i], num_samples);
      std::memcpy(out + i * num_samples, waves[i], sizeof(float) * n);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Parallel every-N keyframe sampling: gather rows from [T, frame_bytes]
// sources into padded [batch, max_k, frame_bytes] uint8 output + masks.
// ---------------------------------------------------------------------------
void mmb_sample_keyframes(const uint8_t** videos, const long* num_frames,
                          long frame_bytes, long batch, long max_k,
                          uint8_t* out, float* mask, int num_threads) {
  std::memset(out, 0, (size_t)batch * max_k * frame_bytes);
  std::memset(mask, 0, sizeof(float) * batch * max_k);
  if (num_threads < 1) num_threads = 1;
  std::atomic<long> next(0);
  auto worker = [&]() {
    long b;
    while ((b = next.fetch_add(1)) < batch) {
      long T = num_frames[b];
      long n = std::min(T, max_k);
      for (long j = 0; j < n; ++j) {
        // linspace(0, T-1, n) rounded — matches data/video.py sampling
        long src = (n == 1) ? 0 : (long)((double)j * (T - 1) / (n - 1) + 0.5);
        std::memcpy(out + (b * max_k + j) * frame_bytes,
                    videos[b] + src * frame_bytes, frame_bytes);
        mask[b * max_k + j] = 1.0f;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// PNG decode (libpng, in-memory) → RGB8 [H, W, 3]. Palette/gray/16-bit/alpha
// inputs are normalized to 8-bit RGB. Returns bytes written, -1 on error,
// -2 when built without libpng. The batch variant decodes with a thread
// pool off the GIL (keyframe dirs are the serving host-decode hot path).
// ---------------------------------------------------------------------------
#ifdef MMB_HAVE_PNG

namespace {
struct MemCursor {
  const uint8_t* data;
  long size;
  long pos;
};

void mem_read(png_structp p, png_bytep out, png_size_t count) {
  MemCursor* c = (MemCursor*)png_get_io_ptr(p);
  if (c->pos + (long)count > c->size) {
    png_error(p, "unexpected end of PNG stream");
    return;
  }
  std::memcpy(out, c->data + c->pos, count);
  c->pos += (long)count;
}

// Open + normalize-to-RGB8; on success the caller must destroy the structs.
int png_open_rgb8(const uint8_t* data, long n, png_structp* png_out,
                  png_infop* info_out, png_uint_32* w, png_uint_32* h,
                  MemCursor* cur) {
  if (n < 8 || png_sig_cmp((png_const_bytep)data, 0, 8)) return -1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return -1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  cur->data = data;
  cur->size = n;
  cur->pos = 0;
  png_set_read_fn(png, cur, mem_read);
  png_read_info(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  *png_out = png;
  *info_out = info;
  return 0;
}
}  // namespace

int mmb_png_header(const uint8_t* data, long n, long* width, long* height) {
  png_structp png;
  png_infop info;
  png_uint_32 w, h;
  MemCursor cur;
  if (png_open_rgb8(data, n, &png, &info, &w, &h, &cur) != 0) return -1;
  *width = (long)w;
  *height = (long)h;
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

long mmb_png_decode(const uint8_t* data, long n, uint8_t* out, long out_cap) {
  png_structp png;
  png_infop info;
  png_uint_32 w, h;
  MemCursor cur;
  if (png_open_rgb8(data, n, &png, &info, &w, &h, &cur) != 0) return -1;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  long rowbytes = (long)png_get_rowbytes(png, info);
  if (rowbytes != (long)w * 3 || (long)h * rowbytes > out_cap) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  std::vector<png_bytep> rows(h);
  for (png_uint_32 i = 0; i < h; ++i) rows[i] = out + (long)i * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return (long)h * rowbytes;
}

#else  // !MMB_HAVE_PNG — keep the ABI; loader falls back to PIL.

int mmb_png_header(const uint8_t*, long, long*, long*) { return -2; }
long mmb_png_decode(const uint8_t*, long, uint8_t*, long) { return -2; }

#endif  // MMB_HAVE_PNG

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg, in-memory) → RGB8 [H, W, 3]. Same conventions as
// the PNG path: bytes written, -1 on error, -2 without the library.
// ---------------------------------------------------------------------------
#ifdef MMB_HAVE_JPEG

namespace {
struct JpegErr {
  jpeg_error_mgr pub;
  std::jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  std::longjmp(((JpegErr*)cinfo->err)->jmp, 1);
}
}  // namespace

int mmb_jpeg_header(const uint8_t* data, long n, long* width, long* height) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)n);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *width = cinfo.image_width;
  *height = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

long mmb_jpeg_decode(const uint8_t* data, long n, uint8_t* out, long out_cap) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)n);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // gray/CMYK normalize to RGB8
  jpeg_start_decompress(&cinfo);
  long rowbytes = (long)cinfo.output_width * cinfo.output_components;
  if (cinfo.output_components != 3 ||
      (long)cinfo.output_height * rowbytes > out_cap) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (long)cinfo.output_scanline * rowbytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return (long)cinfo.output_height * rowbytes;
}

#else  // !MMB_HAVE_JPEG

int mmb_jpeg_header(const uint8_t*, long, long*, long*) { return -2; }
long mmb_jpeg_decode(const uint8_t*, long, uint8_t*, long) { return -2; }

#endif  // MMB_HAVE_JPEG

// Format-sniffing single-image decode + threaded batch (PNG signature /
// JPEG SOI marker); same return conventions as the per-format calls.
long mmb_image_decode(const uint8_t* data, long n, uint8_t* out, long out_cap) {
  if (n >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return mmb_jpeg_decode(data, n, out, out_cap);
  return mmb_png_decode(data, n, out, out_cap);
}

int mmb_image_header(const uint8_t* data, long n, long* width, long* height) {
  if (n >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return mmb_jpeg_header(data, n, width, height);
#ifdef MMB_HAVE_PNG
  return mmb_png_header(data, n, width, height);
#else
  return -2;
#endif
}

void mmb_image_decode_batch(const uint8_t** datas, const long* lens, long batch,
                            uint8_t** outs, const long* caps, long* written,
                            int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<long> next(0);
  auto worker = [&]() {
    long i;
    while ((i = next.fetch_add(1)) < batch)
      written[i] = mmb_image_decode(datas[i], lens[i], outs[i], caps[i]);
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Codecs this build linked: bit 0 PNG, bit 1 JPEG.
int mmb_codecs() {
  int codecs = 0;
#ifdef MMB_HAVE_PNG
  codecs |= 1;
#endif
#ifdef MMB_HAVE_JPEG
  codecs |= 2;
#endif
  return codecs;
}

}  // extern "C"
