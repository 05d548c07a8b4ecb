// yoloq_image: native image decode + training augmentation pipeline.
//
// The reference does all image IO and augmentation in native code on loader
// pthreads (vendored stb decode in src/stb_image.h via src/image.c:1270-1316
// load_image, and the per-pixel augmentation chain of src/data.c:1036-1088
// load_data_detection: resize -> place -> HSV distort -> flip).  This file is
// the framework's native equivalent: libjpeg/libpng decode plus one fused
// augmentation kernel, called from the Python loader's thread pool via ctypes
// (the GIL is released during the call, so decode+augment parallelize across
// loader threads).  Random parameters are drawn host-side in Python
// (data/voc.py) and passed in explicitly — keeps all RNG in one place and the
// numpy implementation as the golden reference.
//
// Build: make -C native (links -ljpeg -lpng; if the headers are missing the
// library falls back to the host-only target and Python uses PIL/numpy).

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------- JPEG ----

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// mode 0: header only (dims). mode 1: full decode into dst (h*w*3 float RGB
// in [0,1]). Returns 0 on success.
int jpeg_read(FILE* f, int* h, int* w, float* dst, int mode) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (mode == 0) {
    *h = static_cast<int>(cinfo.image_height);
    *w = static_cast<int>(cinfo.image_width);
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_start_decompress(&cinfo);
  const int oh = static_cast<int>(cinfo.output_height);
  const int ow = static_cast<int>(cinfo.output_width);
  if (oh != *h || ow != *w || cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  std::vector<uint8_t> row(static_cast<size_t>(ow) * 3);
  uint8_t* rp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    const int y = static_cast<int>(cinfo.output_scanline);
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* out = dst + static_cast<size_t>(y) * ow * 3;
    for (int i = 0; i < ow * 3; ++i) out[i] = row[i] * (1.0f / 255.0f);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ----------------------------------------------------------------- PNG ----

int png_read_file(FILE* f, int* h, int* w, float* dst, int mode) {
  uint8_t sig[8];
  if (fread(sig, 1, 8, f) != 8 || png_sig_cmp(sig, 0, 8)) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
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
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  const int ih = static_cast<int>(png_get_image_height(png, info));
  const int iw = static_cast<int>(png_get_image_width(png, info));
  if (mode == 0) {
    *h = ih;
    *w = iw;
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
  }
  if (ih != *h || iw != *w) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  // normalize every layout to 8-bit RGB
  const png_byte color = png_get_color_type(png, info);
  if (png_get_bit_depth(png, info) == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA) {
    png_set_expand_gray_1_2_4_to_8(png);
    png_set_gray_to_rgb(png);
  }
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  if (png_get_rowbytes(png, info) != static_cast<size_t>(iw) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -1;
  }
  std::vector<uint8_t> row(static_cast<size_t>(iw) * 3);
  for (int y = 0; y < ih; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* out = dst + static_cast<size_t>(y) * iw * 3;
    for (int i = 0; i < iw * 3; ++i) out[i] = row[i] * (1.0f / 255.0f);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

int dispatch(const char* path, int* h, int* w, float* dst, int mode) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  int rc = -1;
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    rc = jpeg_read(f, h, w, dst, mode);
  } else if (n >= 8 && !png_sig_cmp(magic, 0, 8)) {
    rc = png_read_file(f, h, w, dst, mode);
  }
  fclose(f);
  return rc;
}

// darknet align-corners bilinear (duplicated from yoloq_host.cc's
// yq_resize_bilinear signature to keep this TU self-contained)
void resize_bilinear(const float* src, int sh, int sw, float* dst, int dh,
                     int dw, int ch) {
  std::vector<float> part(static_cast<size_t>(sh) * dw * ch);
  const float wscale = (dw > 1 && sw > 1)
                           ? static_cast<float>(sw - 1) / (dw - 1)
                           : 0.f;
  const float hscale = (dh > 1 && sh > 1)
                           ? static_cast<float>(sh - 1) / (dh - 1)
                           : 0.f;
  for (int y = 0; y < sh; ++y) {
    const float* srow = src + static_cast<size_t>(y) * sw * ch;
    float* prow = part.data() + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x) {
      float sx = x * wscale;
      int ix = std::min(static_cast<int>(sx), sw > 1 ? sw - 2 : 0);
      float fx = sx - ix;
      for (int c = 0; c < ch; ++c) {
        prow[x * ch + c] = (1.f - fx) * srow[ix * ch + c] +
                           fx * srow[std::min(ix + 1, sw - 1) * ch + c];
      }
    }
  }
  for (int y = 0; y < dh; ++y) {
    float sy = y * hscale;
    int iy = std::min(static_cast<int>(sy), sh > 1 ? sh - 2 : 0);
    float fy = sy - iy;
    const float* r0 = part.data() + static_cast<size_t>(iy) * dw * ch;
    const float* r1 =
        part.data() + static_cast<size_t>(std::min(iy + 1, sh - 1)) * dw * ch;
    float* drow = dst + static_cast<size_t>(y) * dw * ch;
    for (int i = 0; i < dw * ch; ++i) drow[i] = (1.f - fy) * r0[i] + fy * r1[i];
  }
}

// HSV distortion matching data/voc.py::distort_hsv (itself darknet's
// rgb_to_hsv / scale / hsv_to_rgb chain, src/image.c random_distort_image).
inline void distort_pixel(float* p, float dhue, float dsat, float dexp) {
  const float r = p[0], g = p[1], b = p[2];
  const float mx = std::max(r, std::max(g, b));
  const float mn = std::min(r, std::min(g, b));
  const float delta = mx - mn;
  float v = mx;
  float s = mx > 0.f ? delta / std::max(mx, 1e-12f) : 0.f;
  float h = 0.f;
  if (delta > 0.f) {
    const float d = std::max(delta, 1e-12f);
    if (mx == r) {
      h = std::fmod((g - b) / d, 6.f);
      if (h < 0.f) h += 6.f;
    } else if (mx == g) {
      h = (b - r) / d + 2.f;
    } else {
      h = (r - g) / d + 4.f;
    }
  }
  h = h / 6.f + dhue;
  h = h - std::floor(h);  // python: (h + dhue) % 1.0
  s = std::min(std::max(s * dsat, 0.f), 1.f);
  v = std::min(std::max(v * dexp, 0.f), 1.f);
  const float h6 = h * 6.f;
  const int i = static_cast<int>(std::floor(h6)) % 6;
  const float f = h6 - std::floor(h6);
  const float pp = v * (1.f - s);
  const float q = v * (1.f - f * s);
  const float t = v * (1.f - (1.f - f) * s);
  switch (i) {
    case 0: p[0] = v;  p[1] = t;  p[2] = pp; break;
    case 1: p[0] = q;  p[1] = v;  p[2] = pp; break;
    case 2: p[0] = pp; p[1] = v;  p[2] = t;  break;
    case 3: p[0] = pp; p[1] = q;  p[2] = v;  break;
    case 4: p[0] = t;  p[1] = pp; p[2] = v;  break;
    default: p[0] = v; p[1] = pp; p[2] = q;  break;
  }
}

}  // namespace

extern "C" {

// Header-only dims probe. Returns 0 and fills (h, w) for JPEG/PNG; -1 for
// anything else (caller falls back to PIL).
int yq_image_size(const char* path, int* h, int* w) {
  return dispatch(path, h, w, nullptr, 0);
}

// Full decode into caller-allocated (h, w, 3) float32 RGB in [0,1]
// (the reference's load_image semantics, src/image.c:1270-1316).
int yq_decode_image(const char* path, float* dst, int h, int w) {
  return dispatch(path, &h, &w, dst, 1);
}

// Fused detection-training augmentation (load_data_detection per-pixel chain,
// src/data.c:1036-1088): darknet-bilinear resize of src (sh, sw, 3) to
// (nh, nw), placement at (dx, dy) on a 0.5-gray (oh, ow, 3) canvas, HSV
// distortion of the whole canvas, optional horizontal flip.  All random
// parameters are inputs; dst is caller-allocated (oh, ow, 3).
void yq_augment_place(const float* src, int sh, int sw, float* dst, int oh,
                      int ow, int nw, int nh, int dx, int dy, float dhue,
                      float dsat, float dexp, int flip) {
  std::vector<float> resized(static_cast<size_t>(nh) * nw * 3);
  resize_bilinear(src, sh, sw, resized.data(), nh, nw, 3);
  std::fill(dst, dst + static_cast<size_t>(oh) * ow * 3, 0.5f);
  const int sy0 = std::max(0, -dy), sy1 = std::min(nh, oh - dy);
  const int sx0 = std::max(0, -dx), sx1 = std::min(nw, ow - dx);
  for (int y = sy0; y < sy1; ++y) {
    std::memcpy(dst + (static_cast<size_t>(dy + y) * ow + dx + sx0) * 3,
                resized.data() + (static_cast<size_t>(y) * nw + sx0) * 3,
                static_cast<size_t>(sx1 - sx0) * 3 * sizeof(float));
  }
  const size_t npix = static_cast<size_t>(oh) * ow;
  for (size_t i = 0; i < npix; ++i) distort_pixel(dst + i * 3, dhue, dsat, dexp);
  if (flip) {
    for (int y = 0; y < oh; ++y) {
      float* row = dst + static_cast<size_t>(y) * ow * 3;
      for (int x = 0; x < ow / 2; ++x) {
        for (int c = 0; c < 3; ++c)
          std::swap(row[x * 3 + c], row[(ow - 1 - x) * 3 + c]);
      }
    }
  }
}

}  // extern "C"
