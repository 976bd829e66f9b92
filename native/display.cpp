// Native display bridge for spt_tpu — host-side output conversion + PNG.
//
// Role: the equivalent of the reference's display path.  The
// reference resolves its float accumulation buffer to packed RGBA8888 on
// the CPU every frame (CPUPathTracer.cpp:87-117: mean over frame count,
// clamp to [0,1], pack u32 with R in the high byte via Color.h:7-10) and
// streams it into an SDL texture (src/renderer/Texture2D.cpp:61-68,
// src/App.cpp:236-239).  Headless equivalent here: gather the device
// accumulation tile to host, then this native code does the per-pixel
// resolve loop (mean / exposure / tonemap / gamma / quantize / pack) and
// PNG encoding — the hot host-side loops, in C++ as the reference's are.
//
// Python loads this via ctypes (spt_tpu/io/native_display.py) and falls
// back to the numpy/pure-Python implementations when the library cannot
// be built (it is built from this file into native/build/ at first use).
// Semantics match spt_tpu/core/color.py::finalize_image + pack_rgba8
// exactly (tested in tests/test_native_display.py).
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC, links zlib).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

inline float clamp01(float v) {
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

inline float tonemap_reinhard(float c) { return c / (1.0f + c); }

inline float tonemap_aces(float c) {
  // Narkowicz ACES filmic fit (same constants as core/color.py).
  const float a = 2.51f, b = 0.03f, cc = 2.43f, d = 0.59f, e = 0.14f;
  return clamp01((c * (a * c + b)) / (c * (cc * c + d) + e));
}

}  // namespace

extern "C" {

// Resolve an (n,3) float32 radiance-sum buffer to display pixels.
//   tonemap: 0 = none (reference semantics), 1 = reinhard, 2 = aces
//   out_rgba (n u32, RGBA8888 R-high) and out_u8 (n*3) may each be null.
//   out_f32 (n*3, display floats in [0,1]) may be null.
// Returns 0 on success.
int spt_resolve_pack(const float* accum, int n, float n_samples,
                     float exposure, int auto_exposure,
                     float target_exposure, int tonemap, float gamma,
                     float* out_f32, uint32_t* out_rgba, uint8_t* out_u8) {
  if (n <= 0 || accum == nullptr) return 1;
  const float inv = 1.0f / std::max(n_samples, 1.0f);

  float scale = exposure;
  if (auto_exposure) {
    // exp(mean(log(luminance + 1e-6))) — matches color.finalize_image.
    double sum_log = 0.0;
    for (int i = 0; i < n; ++i) {
      const float r = accum[3 * i + 0] * inv;
      const float g = accum[3 * i + 1] * inv;
      const float b = accum[3 * i + 2] * inv;
      const float lum = 0.2126f * r + 0.7152f * g + 0.0722f * b;
      sum_log += std::log(lum + 1e-6f);
    }
    const float avg = std::exp(static_cast<float>(sum_log / n));
    scale = target_exposure / std::max(avg, 1e-6f);
  }

  const float inv_gamma = (gamma != 1.0f) ? (1.0f / gamma) : 1.0f;
  for (int i = 0; i < n; ++i) {
    float px[3];
    for (int c = 0; c < 3; ++c) {
      float v = accum[3 * i + c] * inv * scale;
      if (tonemap == 1) v = tonemap_reinhard(v);
      else if (tonemap == 2) v = tonemap_aces(v);
      if (gamma != 1.0f) v = std::pow(clamp01(v), inv_gamma);
      px[c] = clamp01(v);
    }
    if (out_f32 != nullptr) {
      out_f32[3 * i + 0] = px[0];
      out_f32[3 * i + 1] = px[1];
      out_f32[3 * i + 2] = px[2];
    }
    // u8 quantize by truncation of v*255 — the reference's cast
    // (CPUPathTracer.cpp:112) and color.quantize_u8.
    const uint32_t r8 = static_cast<uint32_t>(px[0] * 255.0f);
    const uint32_t g8 = static_cast<uint32_t>(px[1] * 255.0f);
    const uint32_t b8 = static_cast<uint32_t>(px[2] * 255.0f);
    if (out_rgba != nullptr)
      out_rgba[i] = (r8 << 24) | (g8 << 16) | (b8 << 8) | 0xFFu;
    if (out_u8 != nullptr) {
      out_u8[3 * i + 0] = static_cast<uint8_t>(r8);
      out_u8[3 * i + 1] = static_cast<uint8_t>(g8);
      out_u8[3 * i + 2] = static_cast<uint8_t>(b8);
    }
  }
  return 0;
}

// Upper bound on spt_encode_png output size for a w x h RGB8 image.
long spt_png_bound(int w, int h) {
  const unsigned long raw = static_cast<unsigned long>(h) * (1 + 3ul * w);
  return static_cast<long>(compressBound(raw)) + 128;  // headers + chunks
}

// Encode (h, w, 3) uint8 RGB into an in-memory PNG (one IDAT, filter 0 per
// row — the same layout as io/image.py's pure-Python writer).  Returns the
// byte length written to `out`, or -1 if out_cap is too small / zlib fails.
long spt_encode_png(const uint8_t* rgb, int w, int h, int compress_level,
                    uint8_t* out, long out_cap) {
  if (w <= 0 || h <= 0 || rgb == nullptr || out == nullptr) return -1;
  const unsigned long stride = 3ul * w;
  std::vector<uint8_t> raw(static_cast<size_t>(h) * (1 + stride));
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw.data() + static_cast<size_t>(y) * (1 + stride);
    row[0] = 0;  // filter type 0 (None)
    std::memcpy(row + 1, rgb + static_cast<size_t>(y) * stride, stride);
  }
  unsigned long comp_cap = compressBound(raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), raw.size(),
                compress_level) != Z_OK)
    return -1;

  auto put_u32 = [](uint8_t* p, uint32_t v) {
    p[0] = static_cast<uint8_t>(v >> 24);
    p[1] = static_cast<uint8_t>(v >> 16);
    p[2] = static_cast<uint8_t>(v >> 8);
    p[3] = static_cast<uint8_t>(v);
  };
  auto write_chunk = [&](uint8_t* p, const char tag[4], const uint8_t* data,
                         uint32_t len) -> long {
    put_u32(p, len);
    std::memcpy(p + 4, tag, 4);
    if (len) std::memcpy(p + 8, data, len);
    uint32_t crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, p + 4, 4 + len);
    put_u32(p + 8 + len, crc);
    return 12 + static_cast<long>(len);
  };

  const long total = 8 + 12 + 13 + 12 + static_cast<long>(comp_cap) + 12;
  if (total > out_cap) return -1;
  long off = 0;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  std::memcpy(out, sig, 8);
  off += 8;
  uint8_t ihdr[13];
  put_u32(ihdr, static_cast<uint32_t>(w));
  put_u32(ihdr + 4, static_cast<uint32_t>(h));
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type: truecolor RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  off += write_chunk(out + off, "IHDR", ihdr, 13);
  off += write_chunk(out + off, "IDAT", comp.data(),
                     static_cast<uint32_t>(comp_cap));
  off += write_chunk(out + off, "IEND", nullptr, 0);
  return off;
}

}  // extern "C"
