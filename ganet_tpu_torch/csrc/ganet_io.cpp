// ganet_io — native data-loading core of ganet_tpu_torch.
//
// The port's own copy of the C++ decode core: PFM + PNG decode, random-crop
// and per-channel normalization run in C++ worker threads and write
// straight into caller-provided (numpy) buffers, so the Python side does no
// per-pixel work and the host input pipeline keeps up with the device step.
//
// Exposed C ABI (consumed via ctypes from ganet_tpu_torch/data/native_io.py,
// which builds this file with g++ into build/native/ at the checkout's root):
//   ganet_decode_sample  — one (left, right, disparity) triplet
//   ganet_decode_batch   — N triplets on a thread pool
//
// Layouts: images are HWC float32 normalized as (x/255 - mean)/std;
// disparity is HW float32 (PFM absolute value, or uint16 PNG / 256).
// Crop offsets are caller-chosen (the Python side owns RNG/determinism);
// crop_y = -1 selects test-mode padding (top/right pad to the crop size).

#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ImageF32 {
  int h = 0, w = 0, c = 0;
  std::vector<float> data;  // HWC
};

// ---------------------------------------------------------------- PFM ----
bool read_pfm(const char* path, ImageF32* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char header[3] = {0};
  if (std::fscanf(f, "%2s", header) != 1) { std::fclose(f); return false; }
  int channels;
  if (std::strcmp(header, "PF") == 0) channels = 3;
  else if (std::strcmp(header, "Pf") == 0) channels = 1;
  else { std::fclose(f); return false; }
  int w = 0, h = 0;
  double scale = 0.0;
  if (std::fscanf(f, "%d %d %lf", &w, &h, &scale) != 3 || w <= 0 || h <= 0) {
    std::fclose(f);
    return false;
  }
  std::fgetc(f);  // single whitespace before payload
  const bool little_endian = scale < 0;
  out->h = h; out->w = w; out->c = channels;
  out->data.resize(static_cast<size_t>(h) * w * channels);
  std::vector<float> row(static_cast<size_t>(w) * channels);
  // PFM rows are stored bottom-to-top.
  for (int y = h - 1; y >= 0; --y) {
    if (std::fread(row.data(), 4, row.size(), f) != row.size()) {
      std::fclose(f);
      return false;
    }
    if (!little_endian) {
      for (float& v : row) {
        uint32_t u;
        std::memcpy(&u, &v, 4);
        u = __builtin_bswap32(u);
        std::memcpy(&v, &u, 4);
      }
    }
    std::memcpy(&out->data[static_cast<size_t>(y) * w * channels], row.data(),
                row.size() * 4);
  }
  std::fclose(f);
  return true;
}

// ---------------------------------------------------------------- PNG ----
// Full libpng API: 8-bit RGB images (camera frames) and 16-bit grayscale
// (KITTI disparity, raw value = disparity * 256 — no gamma handling).
bool read_png(const char* path, ImageF32* out, bool* is_16bit_gray) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) { std::fclose(f); return false; }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(f);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  const int w = png_get_image_width(png, info);
  const int h = png_get_image_height(png, info);
  const int depth = png_get_bit_depth(png, info);
  const int color = png_get_color_type(png, info);

  const bool gray16 = (depth == 16 && (color == PNG_COLOR_TYPE_GRAY));
  *is_16bit_gray = gray16;
  if (gray16) {
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    png_set_swap(png);  // PNG is big-endian; we want host (LE) uint16
  } else {
    // Normalize everything else to 8-bit RGB.
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
    if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  }
  png_read_update_info(png, info);

  const size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<uint8_t> raw(static_cast<size_t>(h) * rowbytes);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = raw.data() + static_cast<size_t>(y) * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(f);

  if (gray16) {
    out->h = h; out->w = w; out->c = 1;
    out->data.resize(static_cast<size_t>(h) * w);
    for (int y = 0; y < h; ++y) {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(rows[y]);
      for (int x = 0; x < w; ++x)
        out->data[static_cast<size_t>(y) * w + x] = src[x] / 256.0f;
    }
  } else {
    out->h = h; out->w = w; out->c = 3;
    out->data.resize(static_cast<size_t>(h) * w * 3);
    for (int y = 0; y < h; ++y) {
      const uint8_t* src = rows[y];
      float* dst = &out->data[static_cast<size_t>(y) * w * 3];
      for (int x = 0; x < w * 3; ++x) dst[x] = static_cast<float>(src[x]);
    }
  }
  return true;
}

// --------------------------------------------------------- crop/normalize
// dst (ch, cw, C); src (h, w, C); (y0, x0) top-left of the crop in src.
// Pad mode (y0 < 0): pad top/right like the reference's test transform.
void crop_or_pad(const ImageF32& src, int ch, int cw, int y0, int x0,
                 const float* mean, const float* stdv, bool normalize,
                 float* dst) {
  const int C = src.c;
  std::fill(dst, dst + static_cast<size_t>(ch) * cw * C, 0.0f);
  int dy0 = 0, sy0 = y0, copy_h = ch, dx0 = 0, sx0 = x0, copy_w = cw;
  if (y0 < 0) {  // pad mode: image sits at bottom-left
    copy_h = std::min(ch, src.h);
    copy_w = std::min(cw, src.w);
    dy0 = ch - copy_h;
    sy0 = src.h - copy_h;
    dx0 = 0;
    sx0 = 0;
  }
  for (int y = 0; y < copy_h; ++y) {
    const float* srow =
        &src.data[(static_cast<size_t>(sy0 + y) * src.w + sx0) * C];
    float* drow = &dst[(static_cast<size_t>(dy0 + y) * cw + dx0) * C];
    if (!normalize) {
      std::memcpy(drow, srow, static_cast<size_t>(copy_w) * C * 4);
    } else {
      for (int x = 0; x < copy_w; ++x)
        for (int c = 0; c < C; ++c)
          drow[x * C + c] =
              (srow[x * C + c] / 255.0f - mean[c]) / stdv[c];
    }
  }
}

int decode_one(const char* left_path, const char* right_path,
               const char* disp_path, int disp_is_pfm, int crop_h, int crop_w,
               int crop_y, int crop_x, const float* mean, const float* stdv,
               float* left_out, float* right_out, float* disp_out) {
  ImageF32 left, right, disp;
  bool g16 = false;
  if (!read_png(left_path, &left, &g16) || left.c != 3) return 1;
  if (!read_png(right_path, &right, &g16) || right.c != 3) return 2;
  if (disp_is_pfm) {
    if (!read_pfm(disp_path, &disp)) return 3;
    if (disp.c == 3) {  // some PFMs are 3-channel; keep channel 0
      ImageF32 mono;
      mono.h = disp.h; mono.w = disp.w; mono.c = 1;
      mono.data.resize(static_cast<size_t>(disp.h) * disp.w);
      for (size_t i = 0; i < mono.data.size(); ++i)
        mono.data[i] = disp.data[i * 3];
      disp = std::move(mono);
    }
    for (float& v : disp.data) v = std::fabs(v);
  } else {
    if (!read_png(disp_path, &disp, &g16) || !g16) return 3;
  }
  if (left.h != right.h || left.w != right.w || left.h != disp.h ||
      left.w != disp.w)
    return 4;
  crop_or_pad(left, crop_h, crop_w, crop_y, crop_x, mean, stdv, true, left_out);
  crop_or_pad(right, crop_h, crop_w, crop_y, crop_x, mean, stdv, true,
              right_out);
  crop_or_pad(disp, crop_h, crop_w, crop_y, crop_x, nullptr, nullptr, false,
              disp_out);
  return 0;
}

}  // namespace

extern "C" {

int ganet_decode_sample(const char* left_path, const char* right_path,
                        const char* disp_path, int disp_is_pfm, int crop_h,
                        int crop_w, int crop_y, int crop_x, const float* mean,
                        const float* stdv, float* left_out, float* right_out,
                        float* disp_out) {
  return decode_one(left_path, right_path, disp_path, disp_is_pfm, crop_h,
                    crop_w, crop_y, crop_x, mean, stdv, left_out, right_out,
                    disp_out);
}

// Batched decode on a thread pool.  Buffers are dense:
// left/right (n, crop_h, crop_w, 3), disp (n, crop_h, crop_w).
// Returns 0 on success, else 100 + index of the first failing sample.
int ganet_decode_batch(int n, const char** lefts, const char** rights,
                       const char** disps, int disp_is_pfm, int crop_h,
                       int crop_w, const int* crop_ys, const int* crop_xs,
                       const float* mean, const float* stdv, float* left_out,
                       float* right_out, float* disp_out, int num_threads) {
  const size_t img_stride = static_cast<size_t>(crop_h) * crop_w * 3;
  const size_t disp_stride = static_cast<size_t>(crop_h) * crop_w;
  std::atomic<int> next(0);
  std::atomic<int> failed(-1);
  const int workers = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      int i;
      while ((i = next.fetch_add(1)) < n) {
        if (failed.load() >= 0) return;
        int rc = decode_one(lefts[i], rights[i], disps[i], disp_is_pfm, crop_h,
                            crop_w, crop_ys[i], crop_xs[i], mean, stdv,
                            left_out + i * img_stride,
                            right_out + i * img_stride,
                            disp_out + i * disp_stride);
        if (rc != 0) failed.store(i);
      }
    });
  }
  for (auto& th : pool) th.join();
  return failed.load() >= 0 ? 100 + failed.load() : 0;
}

}  // extern "C"
