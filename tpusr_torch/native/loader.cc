// tpusr_torch native data loader: PNG decode + Pillow-exact bicubic resize
// chain, on the host.
//
// The reference's dataset prep is PIL decode + a chain of BICUBIC resizes
// per sample on the host (dataset.py:9-62, utils/degradation.py:19-20).
// This file reproduces that chain byte-exactly in C++ (the port's own copy
// of the JAX package's loader.cc, the same functions and C ABI), so the
// host side of dataset prep is not bound by Python and PIL.
//
// Byte-exactness contract (same as ops/bicubic.py's fixed-point resize):
//   * Keys cubic a=-0.5, support 2.0, filter scale max(in/out, 1),
//     half-pixel centers, edge-clamped taps, weights normalized to sum 1;
//   * weights quantized to round(w * 2^22) int32;
//   * horizontal pass first with a uint8 intermediate, then vertical;
//   * accumulate int32 seeded with 2^21, emit clip8(acc >> 22).
// Golden tests: tests/test_torch_native_loader.py (against PIL and the JAX
// package's loader).
//
// C ABI only, consumed through ctypes (tpusr_torch/native/__init__.py).

#include <png.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 22;  // 32 - 8 - 2, Pillow's u8 path

inline double cubic_filter(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return a * (((x - 5.0) * x + 8.0) * x - 4.0);
  return 0.0;
}

struct Taps {
  std::vector<int32_t> coeffs;  // ksize per output index, quantized
  std::vector<int> xmin;
  int ksize = 0;
};

// Pillow precompute_coeffs (Resample.c) with int32 quantization.
Taps make_taps(int in_size, int out_size) {
  Taps t;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  t.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.coeffs.assign(static_cast<size_t>(out_size) * t.ksize, 0);
  t.xmin.assign(out_size, 0);

  std::vector<double> w(t.ksize);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(std::floor(center - support));
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(std::ceil(center + support));
    if (xmax > in_size) xmax = in_size;
    const int n = xmax - xmin;
    double ws = 0.0;
    for (int j = 0; j < n; ++j) {
      w[j] = cubic_filter((xmin + j + 0.5 - center) / filterscale);
      ws += w[j];
    }
    for (int j = 0; j < n; ++j) {
      const double v = ws != 0.0 ? w[j] / ws : w[j];
      const double q = v * (1 << kPrecisionBits);
      t.coeffs[static_cast<size_t>(i) * t.ksize + j] =
          static_cast<int32_t>(q < 0 ? q - 0.5 : q + 0.5);
    }
    t.xmin[i] = xmin;
  }
  return t;
}

inline uint8_t clip8(int32_t acc) {
  acc >>= kPrecisionBits;
  return static_cast<uint8_t>(acc < 0 ? 0 : (acc > 255 ? 255 : acc));
}

// Horizontal-then-vertical two-pass resize of interleaved RGB8,
// uint8 intermediate — Pillow's exact pass order and rounding.
void resize_u8(const uint8_t* src, int h, int w, uint8_t* dst, int oh,
               int ow, int ch) {
  std::vector<uint8_t> mid;
  const uint8_t* hsrc = src;
  int hh = h, hw = w;
  if (ow != w) {
    const Taps t = make_taps(w, ow);
    mid.resize(static_cast<size_t>(h) * ow * ch);
    for (int y = 0; y < h; ++y) {
      const uint8_t* row = src + static_cast<size_t>(y) * w * ch;
      uint8_t* out = mid.data() + static_cast<size_t>(y) * ow * ch;
      for (int x = 0; x < ow; ++x) {
        const int32_t* k = &t.coeffs[static_cast<size_t>(x) * t.ksize];
        const uint8_t* px = row + static_cast<size_t>(t.xmin[x]) * ch;
        // clamp the tap count at the right edge (unwritten trailing
        // coeffs are zero, but the pixel reads must stay in bounds)
        int n = t.ksize;
        if (t.xmin[x] + n > w) n = w - t.xmin[x];
        if (ch == 3) {  // RGB fast path: one tap loop, 3 accumulators
          int32_t a0 = 1 << (kPrecisionBits - 1), a1 = a0, a2 = a0;
          for (int j = 0; j < n; ++j) {
            const int32_t kj = k[j];
            const uint8_t* p = px + static_cast<size_t>(j) * 3;
            a0 += kj * p[0];
            a1 += kj * p[1];
            a2 += kj * p[2];
          }
          uint8_t* o = out + static_cast<size_t>(x) * 3;
          o[0] = clip8(a0);
          o[1] = clip8(a1);
          o[2] = clip8(a2);
        } else {
          for (int c = 0; c < ch; ++c) {
            int32_t acc = 1 << (kPrecisionBits - 1);
            for (int j = 0; j < n; ++j)
              acc += k[j] * static_cast<int32_t>(px[static_cast<size_t>(j) * ch + c]);
            out[static_cast<size_t>(x) * ch + c] = clip8(acc);
          }
        }
      }
    }
    hsrc = mid.data();
    hw = ow;
  }
  if (oh != h) {
    const Taps t = make_taps(h, oh);
    for (int y = 0; y < oh; ++y) {
      const int32_t* k = &t.coeffs[static_cast<size_t>(y) * t.ksize];
      int n = t.ksize;
      if (t.xmin[y] + n > h) n = h - t.xmin[y];
      uint8_t* out = dst + static_cast<size_t>(y) * hw * ch;
      const uint8_t* base =
          hsrc + static_cast<size_t>(t.xmin[y]) * hw * ch;
      for (int x = 0; x < hw * ch; ++x) {
        int32_t acc = 1 << (kPrecisionBits - 1);
        for (int j = 0; j < n; ++j)
          acc += k[j] * static_cast<int32_t>(base[static_cast<size_t>(j) * hw * ch + x]);
        out[x] = clip8(acc);
      }
    }
    hh = oh;
  } else if (hsrc != dst) {
    std::memcpy(dst, hsrc, static_cast<size_t>(hh) * hw * ch);
  }
}

// PNG decode to interleaved RGB8 (palette/gray/16-bit/alpha normalized,
// matching PIL .convert("RGB") for the common cases).
int decode_png_rgb(const char* path, std::vector<uint8_t>* out, int* h,
                   int* w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_gray_to_rgb(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  *w = static_cast<int>(png_get_image_width(png, info));
  *h = static_cast<int>(png_get_image_height(png, info));
  const size_t rowbytes = png_get_rowbytes(png, info);
  if (rowbytes != static_cast<size_t>(*w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -4;
  }
  out->resize(static_cast<size_t>(*h) * *w * 3);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; ++y)
    rows[y] = out->data() + static_cast<size_t>(y) * *w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

}  // namespace

extern "C" {

// Decode a PNG into a malloc'd RGB8 buffer. Returns 0 on success.
int tpusr_decode_png(const char* path, uint8_t** data, int* h, int* w) {
  std::vector<uint8_t> vec;
  int rc = decode_png_rgb(path, &vec, h, w);
  if (rc != 0) return rc;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(vec.size()));
  if (buf == nullptr) return 100;  // OOM: ctypes wrapper raises, PIL fallback
  std::memcpy(buf, vec.data(), vec.size());
  *data = buf;
  return 0;
}

// Pillow-exact BICUBIC resize of interleaved u8 (h, w, ch) -> (oh, ow, ch).
void tpusr_resize_bicubic_u8(const uint8_t* src, int h, int w, int ch,
                             uint8_t* dst, int oh, int ow) {
  resize_u8(src, h, w, dst, oh, ow, ch);
}

// The reference's get_image_pair resize chain (dataset.py:9-46), u8 RGB out.
// Caller passes decoded images; outputs are malloc'd here.
// Returns 0 on success.
int tpusr_prepare_pair(const uint8_t* hr_in, int hr_h, int hr_w,
                       const uint8_t* lr_in, int lr_h, int lr_w,
                       int scale_factor, int downsample,
                       uint8_t** lr_out, int* lr_oh, int* lr_ow,
                       uint8_t** hr_out, int* hr_oh, int* hr_ow) {
  // mandatory /2 shrink of both (floor-div sizes), optional extra /2 on LR
  int lh = lr_h / 2, lw = lr_w / 2;
  std::vector<uint8_t> lr1(static_cast<size_t>(lh) * lw * 3);
  resize_u8(lr_in, lr_h, lr_w, lr1.data(), lh, lw, 3);
  int hh = hr_h / 2, hw = hr_w / 2;
  std::vector<uint8_t> hr1(static_cast<size_t>(hh) * hw * 3);
  resize_u8(hr_in, hr_h, hr_w, hr1.data(), hh, hw, 3);
  if (downsample) {
    int lh2 = lh / 2, lw2 = lw / 2;
    std::vector<uint8_t> lr2(static_cast<size_t>(lh2) * lw2 * 3);
    resize_u8(lr1.data(), lh, lw, lr2.data(), lh2, lw2, 3);
    lr1.swap(lr2);
    lh = lh2;
    lw = lw2;
  }

  int want_hw = scale_factor * lw;
  int want_hh = scale_factor * lh;
  if (want_hw > hw && want_hh > hh) {
    // shrink both to the largest multiple instead (dataset.py:37-44)
    want_hw = (hw / scale_factor) * scale_factor;
    want_hh = (hh / scale_factor) * scale_factor;
    const int new_lw = want_hw / scale_factor;
    const int new_lh = want_hh / scale_factor;
    std::vector<uint8_t> lr2(static_cast<size_t>(new_lh) * new_lw * 3);
    resize_u8(lr1.data(), lh, lw, lr2.data(), new_lh, new_lw, 3);
    lr1.swap(lr2);
    lh = new_lh;
    lw = new_lw;
  }
  auto* hr2 = static_cast<uint8_t*>(
      std::malloc(static_cast<size_t>(want_hh) * want_hw * 3));
  if (hr2 == nullptr) return 100;  // OOM: wrapper raises, PIL fallback
  resize_u8(hr1.data(), hh, hw, hr2, want_hh, want_hw, 3);

  auto* lrb = static_cast<uint8_t*>(std::malloc(lr1.size()));
  if (lrb == nullptr) {
    std::free(hr2);
    return 100;
  }
  std::memcpy(lrb, lr1.data(), lr1.size());
  *lr_out = lrb;
  *lr_oh = lh;
  *lr_ow = lw;
  *hr_out = hr2;
  *hr_oh = want_hh;
  *hr_ow = want_hw;
  return 0;
}

// Full pipeline: decode both PNGs + prepare_pair. Returns 0 on success.
int tpusr_load_pair(const char* hr_path, const char* lr_path,
                    int scale_factor, int downsample, uint8_t** lr_out,
                    int* lr_oh, int* lr_ow, uint8_t** hr_out, int* hr_oh,
                    int* hr_ow) {
  std::vector<uint8_t> hr, lr;
  int hh = 0, hw = 0, lh = 0, lw = 0;
  int rc = decode_png_rgb(hr_path, &hr, &hh, &hw);
  if (rc != 0) return rc;
  rc = decode_png_rgb(lr_path, &lr, &lh, &lw);
  if (rc != 0) return rc;
  return tpusr_prepare_pair(hr.data(), hh, hw, lr.data(), lh, lw,
                            scale_factor, downsample, lr_out, lr_oh, lr_ow,
                            hr_out, hr_oh, hr_ow);
}

void tpusr_free(uint8_t* p) { std::free(p); }

}  // extern "C"
