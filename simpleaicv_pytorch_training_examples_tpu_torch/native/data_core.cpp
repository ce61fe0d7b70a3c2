// Native data-loading core.
//
// TPU-native analogue of the reference's C++/CUDA-side input path (the
// reference leans on torch/DALI-style native decode under its DataLoader;
// here the hot host-side ops are implemented directly): libjpeg decode
// with DCT-domain prescaling, bilinear resize, and a fused
// uint8 -> float32 normalize+pad-to-canvas pass. Exposed over a C ABI and
// bound via ctypes (pybind11 is not in this image); every entry point
// releases the GIL by construction (ctypes does that for us).
//
// Build: g++ -O3 -fPIC -shared -std=c++17 data_core.cpp -ljpeg
//        -o libsimpleaicv_data.so   (see native/__init__.py)

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void on_jpeg_error(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Bilinear resize HWC uint8 RGB.
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  const float fy = static_cast<float>(sh) / dh;
  const float fx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float syf = (y + 0.5f) * fy - 0.5f;
    int sy = static_cast<int>(syf);
    sy = std::max(0, std::min(sy, sh - 1));
    const int sy1 = std::min(sy + 1, sh - 1);  // degenerate-height safe
    float wy = syf - sy;
    wy = std::max(0.0f, std::min(wy, 1.0f));
    const uint8_t* row0 = src + static_cast<size_t>(sy) * sw * 3;
    const uint8_t* row1 = src + static_cast<size_t>(sy1) * sw * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float sxf = (x + 0.5f) * fx - 0.5f;
      int sx = static_cast<int>(sxf);
      sx = std::max(0, std::min(sx, sw - 1));
      const int sx1 = std::min(sx + 1, sw - 1);  // degenerate-width safe
      float wx = sxf - sx;
      wx = std::max(0.0f, std::min(wx, 1.0f));
      for (int c = 0; c < 3; ++c) {
        float v00 = row0[sx * 3 + c], v01 = row0[sx1 * 3 + c];
        float v10 = row1[sx * 3 + c], v11 = row1[sx1 * 3 + c];
        float v = (v00 * (1 - wx) + v01 * wx) * (1 - wy) +
                  (v10 * (1 - wx) + v11 * wx) * wy;
        out[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode a JPEG from memory into RGB uint8. If max_side > 0 the image is
// downscaled so max(h, w) == max_side (libjpeg 1/2,1/4,1/8 DCT prescale
// gets close; bilinear finishes). Returns a malloc'd buffer the caller
// frees with saicv_free; fills out_h/out_w. NULL on decode error.
uint8_t* saicv_decode_jpeg(const uint8_t* buf, size_t len, int max_side,
                           int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = on_jpeg_error;
  // volatile: modified between setjmp and longjmp, then read in the error
  // path — without it the compiler may keep a stale copy in a register
  uint8_t* volatile pixels = nullptr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(pixels);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  if (max_side > 0) {
    // pick the largest DCT denominator that keeps max(h,w) >= max_side
    int full = std::max<int>(cinfo.image_width, cinfo.image_height);
    int denom = 1;
    while (denom < 8 && full / (denom * 2) >= max_side) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height, w = cinfo.output_width;
  const int stride = w * cinfo.output_components;
  pixels = static_cast<uint8_t*>(
      std::malloc(static_cast<size_t>(h) * stride));
  if (!pixels) longjmp(jerr.jump, 1);
  while (static_cast<int>(cinfo.output_scanline) < h) {
    uint8_t* row = pixels + static_cast<size_t>(cinfo.output_scanline) *
                                stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  if (max_side > 0 && std::max(h, w) != max_side) {
    const float factor = static_cast<float>(max_side) / std::max(h, w);
    const int rh = std::max(1, static_cast<int>(h * factor + 0.5f));
    const int rw = std::max(1, static_cast<int>(w * factor + 0.5f));
    uint8_t* resized = static_cast<uint8_t*>(
        std::malloc(static_cast<size_t>(rh) * rw * 3));
    if (!resized) {
      std::free(pixels);
      return nullptr;
    }
    resize_bilinear(pixels, h, w, resized, rh, rw);
    std::free(pixels);
    *out_h = rh;
    *out_w = rw;
    return resized;
  }
  *out_h = h;
  *out_w = w;
  return pixels;
}

void saicv_free(void* p) { std::free(p); }

// Fused normalize + pad-to-canvas: uint8 HWC RGB [h,w] is written into a
// float32 canvas [canvas_h, canvas_w, 3] at the top-left corner as
// (px * scale - mean[c]) / std[c]; the rest of the canvas is untouched
// (callers pass zeroed batch buffers). One pass instead of python-side
// astype + subtract + divide + slice-assign.
void saicv_normalize_into_canvas(const uint8_t* src, int h, int w,
                                 float* canvas, int canvas_h, int canvas_w,
                                 float scale, const float* mean,
                                 const float* stdv) {
  const float inv0 = 1.0f / stdv[0], inv1 = 1.0f / stdv[1],
              inv2 = 1.0f / stdv[2];
  const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = src + static_cast<size_t>(y) * w * 3;
    float* out = canvas + (static_cast<size_t>(y) * canvas_w) * 3;
    for (int x = 0; x < w; ++x) {
      out[x * 3 + 0] = (in[x * 3 + 0] * scale - m0) * inv0;
      out[x * 3 + 1] = (in[x * 3 + 1] * scale - m1) * inv1;
      out[x * 3 + 2] = (in[x * 3 + 2] * scale - m2) * inv2;
    }
  }
}

// Batched file decode: n JPEG files -> per-image malloc'd RGB buffers,
// decoded across native threads (no GIL, no python thread overhead).
// outs/out_hs/out_ws are caller arrays of length n; a failed decode
// leaves outs[i] == NULL. Returns the number decoded successfully.
int saicv_decode_jpeg_batch(const uint8_t** bufs, const size_t* lens,
                            int n, int max_side, uint8_t** outs,
                            int* out_hs, int* out_ws, int n_threads) {
  std::atomic<int> next(0), ok(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      outs[i] = saicv_decode_jpeg(bufs[i], lens[i], max_side, &out_hs[i],
                                  &out_ws[i]);
      if (outs[i]) ok.fetch_add(1);
    }
  };
  int t = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int k = 0; k < t; ++k) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok.load();
}

}  // extern "C"
