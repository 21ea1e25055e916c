// QOI (Quite OK Image) codec — native thumbnail compression.
//
// The reference compresses 256x256 RGB thumbnails to QOI before storing
// them in SQLite (reference src/indexed_image.rs:54-57 via the Rust `qoi`
// crate; README.md:25 "2x Compression for No Loss in Speed").  This is the
// ingest pipeline's per-image hot host op, so it is native C++ (a pure
// Python QOI would bottleneck the 5k images/s/chip ingest target).
//
// Implements the public QOI specification (qoiformat.org, CC0):
//   header: "qoif" | width u32be | height u32be | channels u8 | colorspace u8
//   stream of ops: RUN / INDEX / DIFF / LUMA / RGB / RGBA
//   end marker: seven 0x00 bytes then 0x01.
//
// Exposed via ctypes (see pixelbox_tpu/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr uint8_t OP_INDEX = 0x00;  // 00xxxxxx
constexpr uint8_t OP_DIFF = 0x40;   // 01xxxxxx
constexpr uint8_t OP_LUMA = 0x80;   // 10xxxxxx
constexpr uint8_t OP_RUN = 0xC0;    // 11xxxxxx
constexpr uint8_t OP_RGB = 0xFE;
constexpr uint8_t OP_RGBA = 0xFF;
constexpr uint8_t MASK_2 = 0xC0;

struct Px {
  uint8_t r, g, b, a;
  bool operator==(const Px& o) const {
    return r == o.r && g == o.g && b == o.b && a == o.a;
  }
};

inline int color_hash(const Px& p) {
  return (p.r * 3 + p.g * 5 + p.b * 7 + p.a * 11) % 64;
}

inline void write_u32be(uint8_t* out, uint32_t v) {
  out[0] = (v >> 24) & 0xFF;
  out[1] = (v >> 16) & 0xFF;
  out[2] = (v >> 8) & 0xFF;
  out[3] = v & 0xFF;
}

inline uint32_t read_u32be(const uint8_t* in) {
  return (uint32_t(in[0]) << 24) | (uint32_t(in[1]) << 16) |
         (uint32_t(in[2]) << 8) | uint32_t(in[3]);
}

}  // namespace

extern "C" {

// Worst case: 1 RGBA op (5 bytes) per pixel + header(14) + end(8).
size_t qoi_encode_bound(uint32_t w, uint32_t h) {
  return size_t(w) * h * 5 + 14 + 8;
}

// Encode `pixels` (w*h*channels bytes, channels 3 or 4, row-major) into
// `out` (capacity out_cap).  Returns bytes written, or 0 on error.
size_t qoi_encode(const uint8_t* pixels, uint32_t w, uint32_t h,
                  uint32_t channels, uint8_t* out, size_t out_cap) {
  if (w == 0 || h == 0 || (channels != 3 && channels != 4)) return 0;
  if (out_cap < qoi_encode_bound(w, h)) return 0;

  size_t p = 0;
  std::memcpy(out, "qoif", 4);
  p += 4;
  write_u32be(out + p, w);
  p += 4;
  write_u32be(out + p, h);
  p += 4;
  out[p++] = uint8_t(channels);
  out[p++] = 0;  // colorspace: sRGB with linear alpha

  Px index[64] = {};
  Px prev = {0, 0, 0, 255};
  int run = 0;
  const size_t n_px = size_t(w) * h;

  for (size_t i = 0; i < n_px; ++i) {
    Px px;
    const uint8_t* s = pixels + i * channels;
    px.r = s[0];
    px.g = s[1];
    px.b = s[2];
    px.a = channels == 4 ? s[3] : 255;

    if (px == prev) {
      if (++run == 62) {
        out[p++] = OP_RUN | uint8_t(run - 1);
        run = 0;
      }
    } else {
      if (run > 0) {
        out[p++] = OP_RUN | uint8_t(run - 1);
        run = 0;
      }
      int h_idx = color_hash(px);
      if (index[h_idx] == px) {
        out[p++] = OP_INDEX | uint8_t(h_idx);
      } else {
        index[h_idx] = px;
        if (px.a == prev.a) {
          int8_t dr = int8_t(px.r - prev.r);
          int8_t dg = int8_t(px.g - prev.g);
          int8_t db = int8_t(px.b - prev.b);
          int8_t dg_r = int8_t(dr - dg);
          int8_t dg_b = int8_t(db - dg);
          if (dr >= -2 && dr <= 1 && dg >= -2 && dg <= 1 && db >= -2 &&
              db <= 1) {
            out[p++] = OP_DIFF | uint8_t((dr + 2) << 4) |
                       uint8_t((dg + 2) << 2) | uint8_t(db + 2);
          } else if (dg >= -32 && dg <= 31 && dg_r >= -8 && dg_r <= 7 &&
                     dg_b >= -8 && dg_b <= 7) {
            out[p++] = OP_LUMA | uint8_t(dg + 32);
            out[p++] = uint8_t((dg_r + 8) << 4) | uint8_t(dg_b + 8);
          } else {
            out[p++] = OP_RGB;
            out[p++] = px.r;
            out[p++] = px.g;
            out[p++] = px.b;
          }
        } else {
          out[p++] = OP_RGBA;
          out[p++] = px.r;
          out[p++] = px.g;
          out[p++] = px.b;
          out[p++] = px.a;
        }
      }
    }
    prev = px;
  }
  if (run > 0) out[p++] = OP_RUN | uint8_t(run - 1);

  for (int i = 0; i < 7; ++i) out[p++] = 0;
  out[p++] = 1;
  return p;
}

// Read header only: returns 1 on success, fills w/h/channels.
int qoi_decode_header(const uint8_t* data, size_t len, uint32_t* w,
                      uint32_t* h, uint32_t* channels) {
  if (len < 14 || std::memcmp(data, "qoif", 4) != 0) return 0;
  *w = read_u32be(data + 4);
  *h = read_u32be(data + 8);
  *channels = data[12];
  if (*channels != 3 && *channels != 4) return 0;
  return 1;
}

// Decode into `out` with `out_channels` (3 or 4) interleaving.  Returns
// bytes written (w*h*out_channels), or 0 on error.
size_t qoi_decode(const uint8_t* data, size_t len, uint8_t* out,
                  size_t out_cap, uint32_t out_channels) {
  uint32_t w, h, channels;
  if (!qoi_decode_header(data, len, &w, &h, &channels)) return 0;
  if (out_channels != 3 && out_channels != 4) return 0;
  const size_t n_px = size_t(w) * h;
  if (out_cap < n_px * out_channels) return 0;

  Px index[64] = {};
  Px px = {0, 0, 0, 255};
  size_t p = 14;
  const size_t chunks_end = len - 8;  // exclude end marker
  int run = 0;

  for (size_t i = 0; i < n_px; ++i) {
    if (run > 0) {
      --run;
    } else if (p < chunks_end) {
      uint8_t b1 = data[p++];
      if (b1 == OP_RGB) {
        px.r = data[p++];
        px.g = data[p++];
        px.b = data[p++];
      } else if (b1 == OP_RGBA) {
        px.r = data[p++];
        px.g = data[p++];
        px.b = data[p++];
        px.a = data[p++];
      } else if ((b1 & MASK_2) == OP_INDEX) {
        px = index[b1 & 0x3F];
      } else if ((b1 & MASK_2) == OP_DIFF) {
        px.r += ((b1 >> 4) & 0x03) - 2;
        px.g += ((b1 >> 2) & 0x03) - 2;
        px.b += (b1 & 0x03) - 2;
      } else if ((b1 & MASK_2) == OP_LUMA) {
        uint8_t b2 = data[p++];
        int dg = (b1 & 0x3F) - 32;
        px.r += dg - 8 + ((b2 >> 4) & 0x0F);
        px.g += dg;
        px.b += dg - 8 + (b2 & 0x0F);
      } else {  // OP_RUN
        run = (b1 & 0x3F);
      }
      index[color_hash(px)] = px;
    }
    uint8_t* d = out + i * out_channels;
    d[0] = px.r;
    d[1] = px.g;
    d[2] = px.b;
    if (out_channels == 4) d[3] = px.a;
  }
  return n_px * out_channels;
}

}  // extern "C"
