// Native image decode + resample for the ingest hot path.
//
// The reference decodes with the Rust `image` crate inside 4 worker
// threads (src/crawler.rs:68-119, src/indexed_image.rs:53); the PIL path
// here measured ~21.5 ms/image/core end-to-end (PERF.md) — far from the
// 5k images/s/chip north star.  This file provides:
//
//   px_sniff / px_decode_header / px_decode_rgb
//     JPEG (libjpeg), PNG (libpng), WEBP (libwebp) → RGB8, with
//     decode-time downscaling (JPEG DCT scaling / WEBP fancy scaler)
//     to the smallest size keeping min(w,h) >= min_dim — every ingest
//     consumer (256 thumbnail, 224 embed frame, 16x16 phash) needs far
//     less than full resolution, so most of the decode cost vanishes.
//
//   px_resize
//     Separable scale-aware resample (triangle / gaussian kernels with
//     the image crate's weight definition, see ops/resample.py), f32
//     accumulation, round-half-away-from-zero back to u8.
//
// Callers run in the Python decode pool; ctypes releases the GIL during
// calls, so thread-level parallelism comes from the pool (like the
// reference's PARALLEL_FILE_PROCESSORS).  No global state.

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <unordered_map>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <webp/decode.h>

extern "C" {

// ------------------------------------------------------------------ //
// Format sniffing

int px_sniff(const uint8_t* data, size_t len) {
  if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF)
    return 1;  // JPEG
  static const uint8_t png_magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A,
                                       '\n'};
  if (len >= 8 && memcmp(data, png_magic, 8) == 0) return 2;  // PNG
  if (len >= 12 && memcmp(data, "RIFF", 4) == 0 &&
      memcmp(data + 8, "WEBP", 4) == 0)
    return 3;  // WEBP
  return 0;
}

// ------------------------------------------------------------------ //
// JPEG (with custom error handler: the default calls exit())

struct PxJpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

static void px_jpeg_error_exit(j_common_ptr cinfo) {
  PxJpegErr* err = reinterpret_cast<PxJpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

static int px_choose_denom(uint32_t w, uint32_t h, int min_dim) {
  if (min_dim <= 0) return 1;
  uint32_t m = std::min(w, h);
  int denom = 1;
  while (denom < 8 && m / (denom * 2) >= (uint32_t)min_dim) denom *= 2;
  return denom;
}

static int px_jpeg_header(const uint8_t* data, size_t len, uint32_t* w,
                          uint32_t* h) {
  jpeg_decompress_struct cinfo;
  PxJpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = px_jpeg_error_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

static int px_jpeg_decode(const uint8_t* data, size_t len, int denom,
                          uint8_t* out, size_t out_cap, uint32_t* ow,
                          uint32_t* oh) {
  jpeg_decompress_struct cinfo;
  PxJpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = px_jpeg_error_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  uint32_t w = cinfo.output_width, h = cinfo.output_height;
  size_t stride = (size_t)w * cinfo.output_components;
  if (cinfo.output_components != 3 || out_cap < stride * h) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  while (cinfo.output_scanline < h) {
    JSAMPROW row = out + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *ow = w;
  *oh = h;
  return 0;
}

// ------------------------------------------------------------------ //
// PNG (memory reader; gray/palette/alpha all expanded to RGB8)

struct PxPngReader {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

static void px_png_read(png_structp png, png_bytep out, png_size_t n) {
  PxPngReader* r = static_cast<PxPngReader*>(png_get_io_ptr(png));
  if (r->pos + n > r->len) png_error(png, "short read");
  memcpy(out, r->data + r->pos, n);
  r->pos += n;
}

static int px_png_header(const uint8_t* data, size_t len, uint32_t* w,
                         uint32_t* h) {
  if (len < 24) return -1;
  // IHDR is always the first chunk: width/height at offsets 16/20.
  *w = ((uint32_t)data[16] << 24) | (data[17] << 16) | (data[18] << 8) |
       data[19];
  *h = ((uint32_t)data[20] << 24) | (data[21] << 16) | (data[22] << 8) |
       data[23];
  return (*w && *h) ? 0 : -1;
}

static int px_png_decode(const uint8_t* data, size_t len, uint8_t* out,
                         size_t out_cap, uint32_t* ow, uint32_t* oh) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -1;
  }
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  PxPngReader reader{data, len, 0};
  png_set_read_fn(png, &reader, px_png_read);
  png_read_info(png, info);
  uint32_t w = png_get_image_width(png, info);
  uint32_t h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  // Composite alpha over black? The PIL path keeps RGB of RGBA as-is
  // (convert("RGB") drops alpha); match that: strip alpha.
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  size_t stride = png_get_rowbytes(png, info);
  if (stride != (size_t)w * 3 || out_cap < stride * h) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  rows.resize(h);
  for (uint32_t y = 0; y < h; y++) rows[y] = out + (size_t)y * stride;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  *ow = w;
  *oh = h;
  return 0;
}

// ------------------------------------------------------------------ //
// WEBP

static int px_webp_header(const uint8_t* data, size_t len, uint32_t* w,
                          uint32_t* h) {
  int ww, hh;
  if (!WebPGetInfo(data, len, &ww, &hh)) return -1;
  *w = (uint32_t)ww;
  *h = (uint32_t)hh;
  return 0;
}

static int px_webp_decode(const uint8_t* data, size_t len, int denom,
                          uint8_t* out, size_t out_cap, uint32_t* ow,
                          uint32_t* oh) {
  WebPDecoderConfig config;
  if (!WebPInitDecoderConfig(&config)) return -1;
  if (WebPGetFeatures(data, len, &config.input) != VP8_STATUS_OK) return -1;
  uint32_t w = config.input.width, h = config.input.height;
  if (denom > 1) {
    config.options.use_scaling = 1;
    config.options.scaled_width = (w + denom - 1) / denom;
    config.options.scaled_height = (h + denom - 1) / denom;
    w = config.options.scaled_width;
    h = config.options.scaled_height;
  }
  if (out_cap < (size_t)w * h * 3) return -1;
  config.output.colorspace = MODE_RGB;
  config.output.is_external_memory = 1;
  config.output.u.RGBA.rgba = out;
  config.output.u.RGBA.stride = w * 3;
  config.output.u.RGBA.size = (size_t)w * h * 3;
  if (WebPDecode(data, len, &config) != VP8_STATUS_OK) return -1;
  *ow = w;
  *oh = h;
  return 0;
}

// ------------------------------------------------------------------ //
// Public decode API

// Fills full (original) dims and the dims a px_decode_rgb call with the
// same min_dim will produce.  Returns 0 on success.
int px_decode_header(const uint8_t* data, size_t len, int min_dim,
                     uint32_t* full_w, uint32_t* full_h, uint32_t* scaled_w,
                     uint32_t* scaled_h) {
  uint32_t w = 0, h = 0;
  int fmt = px_sniff(data, len);
  int rc = -1;
  if (fmt == 1) rc = px_jpeg_header(data, len, &w, &h);
  else if (fmt == 2) rc = px_png_header(data, len, &w, &h);
  else if (fmt == 3) rc = px_webp_header(data, len, &w, &h);
  if (rc != 0) return -1;
  *full_w = w;
  *full_h = h;
  if (fmt == 1) {
    // Only JPEG scales at decode time: libjpeg's DCT scaling is what
    // PIL's draft() uses too, so native and PIL-fallback hosts produce
    // IDENTICAL pixels for the same file + min_dim (hashes must not
    // depend on which decoder a host happened to build).
    int denom = px_choose_denom(w, h, min_dim);
    *scaled_w = (w + denom - 1) / denom;
    *scaled_h = (h + denom - 1) / denom;
  } else {
    *scaled_w = w;
    *scaled_h = h;
  }
  return 0;
}

// Decode into caller buffer sized for the scaled dims from
// px_decode_header (same min_dim).  Returns 0 on success.
int px_decode_rgb(const uint8_t* data, size_t len, int min_dim, uint8_t* out,
                  size_t out_cap, uint32_t* out_w, uint32_t* out_h) {
  uint32_t w = 0, h = 0;
  int fmt = px_sniff(data, len);
  if (fmt == 1) {
    if (px_jpeg_header(data, len, &w, &h) != 0) return -1;
    return px_jpeg_decode(data, len, px_choose_denom(w, h, min_dim), out,
                          out_cap, out_w, out_h);
  }
  if (fmt == 2) return px_png_decode(data, len, out, out_cap, out_w, out_h);
  if (fmt == 3) {
    // Full resolution: PIL has no WEBP scaling, and pixels must match
    // across native/fallback hosts (see px_decode_header).
    return px_webp_decode(data, len, 1, out, out_cap, out_w, out_h);
  }
  return -1;
}

// ------------------------------------------------------------------ //
// Separable resample (image crate weight definition; ops/resample.py)

struct PxWeights {
  std::vector<int> start;   // per output coord: first contributing input
  std::vector<int> count;   // per output coord: number of taps
  std::vector<float> w;     // taps, normalized, [out][max_count] packed
  int max_count = 0;
};

static void px_build_weights(int n_in, int n_out, int filter, PxWeights* pw) {
  // filter: 0 = triangle (support 1), 1 = gaussian (support 3, sigma 0.5)
  double support = filter == 0 ? 1.0 : 3.0;
  double scale = (double)n_in / n_out;
  double fscale = std::max(scale, 1.0);
  double src_support = support * fscale;
  int max_count = (int)std::ceil(2.0 * src_support) + 2;
  pw->start.resize(n_out);
  pw->count.resize(n_out);
  pw->w.assign((size_t)n_out * max_count, 0.0f);
  pw->max_count = max_count;
  for (int o = 0; o < n_out; o++) {
    double center = (o + 0.5) * scale;
    int left = std::max((int)std::floor(center - src_support), 0);
    int right = std::min((int)std::ceil(center + src_support), n_in);
    int cnt = right - left;
    double sum = 0.0;
    std::vector<double> vals(cnt);
    for (int i = 0; i < cnt; i++) {
      double x = (left + i + 0.5 - center) / fscale;
      double v;
      if (filter == 0) {
        v = std::max(0.0, 1.0 - std::fabs(x));
      } else {
        const double r = 0.5;
        v = std::exp(-(x * x) / (2.0 * r * r)) / (std::sqrt(2.0 * M_PI) * r);
      }
      vals[i] = v;
      sum += v;
    }
    if (sum == 0.0) {  // degenerate window — nearest neighbor
      int best = 0;
      double bd = 1e30;
      for (int i = 0; i < cnt; i++) {
        double d = std::fabs(left + i + 0.5 - center);
        if (d < bd) { bd = d; best = i; }
      }
      vals.assign(cnt, 0.0);
      vals[best] = 1.0;
      sum = 1.0;
    }
    pw->start[o] = left;
    pw->count[o] = cnt;
    for (int i = 0; i < cnt; i++)
      pw->w[(size_t)o * max_count + i] = (float)(vals[i] / sum);
  }
}

// Weight tables depend only on (n_in, n_out, filter) — ingest resizes the
// same shapes millions of times, so cache them (small, thread-safe).
// SAFETY: cached entries are NEVER evicted or mutated once inserted (an
// eviction would free weights a concurrent — or even the same — px_resize
// call still holds a pointer to).  Growth is bounded instead by refusing
// to insert past the cap: overflow shapes build into the caller's local
// buffer and skip the cache.  256 entries ≈ a few KB each.
static const PxWeights* px_cached_weights(int n_in, int n_out, int filter,
                                          PxWeights* local) {
  struct Key {
    int a, b, f;
    bool operator==(const Key& o) const {
      return a == o.a && b == o.b && f == o.f;
    }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      return ((size_t)k.a * 1000003u) ^ ((size_t)k.b << 20) ^ (size_t)k.f;
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, std::unique_ptr<PxWeights>, KeyHash> cache;
  Key key{n_in, n_out, filter};
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it != cache.end()) return it->second.get();
  }
  // Build outside the lock (it's the expensive part).
  auto pw = std::make_unique<PxWeights>();
  px_build_weights(n_in, n_out, filter, pw.get());
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it != cache.end()) return it->second.get();  // raced: reuse theirs
    if (cache.size() < 256) {
      it = cache.emplace(key, std::move(pw)).first;
      return it->second.get();
    }
  }
  *local = std::move(*pw);  // cache full: caller-owned, uncached
  return local;
}

// src: u8 [sh, sw, ch] → dst: u8 [dh, dw, ch].  filter 0=triangle 1=gaussian.
void px_resize(const uint8_t* src, uint32_t sw, uint32_t sh, uint32_t ch,
               uint8_t* dst, uint32_t dw, uint32_t dh, int filter) {
  PxWeights wv_local, wh_local;
  const PxWeights& wv = *px_cached_weights((int)sh, (int)dh, filter, &wv_local);
  const PxWeights& wh = *px_cached_weights((int)sw, (int)dw, filter, &wh_local);
  // Vertical pass first (matches ops/resample.resize_np order): f32 tmp.
  std::vector<float> tmp((size_t)dh * sw * ch);
  size_t sstride = (size_t)sw * ch;
  for (uint32_t oy = 0; oy < dh; oy++) {
    // __restrict__ is load-bearing: uint8_t is a char type, so without it
    // the compiler must assume srow aliases trow and cannot vectorize the
    // accumulation (measured 2.3 GMAC/s → ~10 GMAC/s with it).
    float* __restrict__ trow = tmp.data() + (size_t)oy * sstride;
    std::fill(trow, trow + sstride, 0.0f);
    int s = wv.start[oy], c = wv.count[oy];
    const float* wrow = wv.w.data() + (size_t)oy * wv.max_count;
    for (int i = 0; i < c; i++) {
      float wgt = wrow[i];
      const uint8_t* __restrict__ srow = src + (size_t)(s + i) * sstride;
      for (size_t x = 0; x < sstride; x++) trow[x] += wgt * srow[x];
    }
  }
  // Horizontal pass to f32 (three independent accumulator chains per RGB
  // pixel — the tap loop is too short and gather-strided for SIMD; a
  // blocked-transpose formulation measured SLOWER at ingest shapes), then
  // one vectorizable round-half-away clamp pass to u8.
  std::vector<float> outf((size_t)dh * dw * ch);
  for (uint32_t oy = 0; oy < dh; oy++) {
    const float* trow = tmp.data() + (size_t)oy * sstride;
    float* __restrict__ orow = outf.data() + (size_t)oy * dw * ch;
    if (ch == 3) {
      for (uint32_t ox = 0; ox < dw; ox++) {
        int s = wh.start[ox], c = wh.count[ox];
        const float* wrow = wh.w.data() + (size_t)ox * wh.max_count;
        const float* base = trow + (size_t)s * 3;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
        for (int i = 0; i < c; i++) {
          float wgt = wrow[i];
          a0 += wgt * base[3 * i];
          a1 += wgt * base[3 * i + 1];
          a2 += wgt * base[3 * i + 2];
        }
        orow[3 * ox] = a0;
        orow[3 * ox + 1] = a1;
        orow[3 * ox + 2] = a2;
      }
      continue;
    }
    for (uint32_t ox = 0; ox < dw; ox++) {
      int s = wh.start[ox], c = wh.count[ox];
      const float* wrow = wh.w.data() + (size_t)ox * wh.max_count;
      for (uint32_t k = 0; k < ch; k++) {
        float acc = 0.0f;
        for (int i = 0; i < c; i++) acc += wrow[i] * trow[(size_t)(s + i) * ch + k];
        orow[(size_t)ox * ch + k] = acc;
      }
    }
  }
  const float* __restrict__ ff = outf.data();
  uint8_t* __restrict__ dd = dst;
  size_t ntot = (size_t)dh * dw * ch;
  for (size_t x = 0; x < ntot; x++) {
    float r = std::floor(ff[x] + 0.5f);
    dd[x] = (uint8_t)std::min(255.0f, std::max(0.0f, r));
  }
}

}  // extern "C"
