// Native data-path runtime for dualdiff_tpu.
//
// The reference gets its host-side throughput from torch DataLoader worker
// processes + numba bit-packing (reference magicdrive/dataset/
// pipeline_utils.py:10-49) + PIL/mmcv C codecs.  This library replaces that
// stack with an in-process C++ pipeline exposed over a plain C ABI (ctypes):
//
//   * JPEG decode (libjpeg) + box-filtered bilinear resize + bottom-crop +
//     [-1, 1] normalization in one pass, multi-threaded across the 6 camera
//     views of a batch,
//   * the BEV-mask bit-pack codec (uint32 words <-> up-to-32 binary
//     channels) used by the h5 cache.
//
// Build: see native/Makefile (g++ -O3 -fPIC -shared -ljpeg -lpthread).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ------------------------------------------------------------------ codec --

// packed: (h, w) uint32 words; out: (channels, h, w) uint8
void unpack_masks(const uint32_t* packed, int channels, int h, int w,
                  uint8_t* out) {
  const int hw = h * w;
  for (int c = 0; c < channels; ++c) {
    uint8_t* dst = out + (size_t)c * hw;
    const uint32_t bit = 1u << c;
    for (int i = 0; i < hw; ++i) dst[i] = (packed[i] & bit) ? 1 : 0;
  }
}

// masks: (channels, h, w) uint8; out: (h, w) uint32
void pack_masks(const uint8_t* masks, int channels, int h, int w,
                uint32_t* out) {
  const int hw = h * w;
  std::memset(out, 0, sizeof(uint32_t) * hw);
  for (int c = 0; c < channels; ++c) {
    const uint8_t* src = masks + (size_t)c * hw;
    const uint32_t bit = 1u << c;
    for (int i = 0; i < hw; ++i)
      if (src[i]) out[i] |= bit;
  }
}

// ------------------------------------------------------------------ jpeg --

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode a JPEG file into an RGB buffer.  Returns 0 on success.
static int decode_jpeg(const char* path, std::vector<uint8_t>* rgb, int* w,
                       int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize((size_t)(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() + (size_t)cinfo.output_scanline * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

// Bilinear sample of an RGB uint8 image.
static inline void bilinear(const uint8_t* src, int sw, int sh, float x,
                            float y, float* out3) {
  x = std::min(std::max(x, 0.0f), (float)sw - 1.0f);
  y = std::min(std::max(y, 0.0f), (float)sh - 1.0f);
  int x0 = (int)x, y0 = (int)y;
  int x1 = std::min(x0 + 1, sw - 1), y1 = std::min(y0 + 1, sh - 1);
  float fx = x - x0, fy = y - y0;
  for (int c = 0; c < 3; ++c) {
    float v00 = src[((size_t)y0 * sw + x0) * 3 + c];
    float v01 = src[((size_t)y0 * sw + x1) * 3 + c];
    float v10 = src[((size_t)y1 * sw + x0) * 3 + c];
    float v11 = src[((size_t)y1 * sw + x1) * 3 + c];
    out3[c] = v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) +
              v10 * (1 - fx) * fy + v11 * fx * fy;
  }
}

// Decode one JPEG -> resize by `ratio` -> crop (center-x, bottom-y) to
// (out_h, out_w) -> normalize to [-1, 1] float32 HWC.  Returns 0 on success.
int load_image(const char* path, float ratio, int out_h, int out_w,
               float* out) {
  std::vector<uint8_t> rgb;
  int sw = 0, sh = 0;
  int rc = decode_jpeg(path, &rgb, &sw, &sh);
  if (rc) return rc;
  const int rw = (int)(sw * ratio), rh = (int)(sh * ratio);
  const int left = std::max((rw - out_w) / 2, 0);
  const int top = std::max(rh - out_h, 0);  // bottom crop (ImageAug3D)
  for (int y = 0; y < out_h; ++y) {
    for (int x = 0; x < out_w; ++x) {
      // map output pixel to source coords (resize then crop)
      float sx = (x + left + 0.5f) / ratio - 0.5f;
      float sy = (y + top + 0.5f) / ratio - 0.5f;
      float px[3];
      bilinear(rgb.data(), sw, sh, sx, sy, px);
      float* dst = out + ((size_t)y * out_w + x) * 3;
      dst[0] = px[0] / 127.5f - 1.0f;
      dst[1] = px[1] / 127.5f - 1.0f;
      dst[2] = px[2] / 127.5f - 1.0f;
    }
  }
  return 0;
}

// Batch API: decode+resize `n` images in parallel into a contiguous
// (n, out_h, out_w, 3) float32 buffer.  Returns the number of failures.
int load_images_batch(const char** paths, int n, float ratio, int out_h,
                      int out_w, int num_threads, float* out) {
  std::atomic<int> next(0), failures(0);
  const size_t stride = (size_t)out_h * out_w * 3;
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      if (load_image(paths[i], ratio, out_h, out_w, out + stride * i) != 0)
        failures.fetch_add(1);
    }
  };
  int t = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
