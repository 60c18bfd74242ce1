// image_pipe.cc — native JPEG decode + augmentation pipeline for the data
// loader. The reference feeds its trainers through torch DataLoader's C++
// worker pool + PIL/timm transforms (TinyViT/data/build.py, every project's
// loader); this is the port's equivalent heavy path: a threaded
// decode -> crop -> antialiased separable resample -> flip -> normalize
// pipeline behind a C ABI (driven from python via ctypes,
// cream_tpu_torch/data/native_pipe.py). A copy of the JAX package's
// native/image_pipe.cc; only this comment and the version check after the
// include differ.
//
// Division of labour (parity by construction): python keeps every *decision*
// (sample order, per-sample seeds, RandomResizedCrop boxes, flip coins —
// data/det_aug.py) so the aug semantics are identical to the PIL path; C++
// only executes the pixel work. The resampler mirrors Pillow's algorithm
// (separable convolution with filter support scaled by the downscale ratio,
// bicubic a=-0.5 — Pillow src/libImaging/Resample.c) in fp32, so outputs
// match PIL within ~1/255 per channel rather than bit-exactly; loaders keep
// PIL as the default and golden/distill paths pin it (see native_pipe.py).
//
// Build: cream_tpu_torch/data/native_pipe.py compiles this file at first use
// with g++ -O3 -march=native -std=c++17 -fPIC -shared -I<this directory>
// ... <libjpeg.so.62> -lpthread into build/image_pipe-<hash>.so at the root of the checkout, the hash
// covering the source, the flags, the host's CPU and the libjpeg it links.
// It includes the libjpeg-turbo 2.1.5 headers copied beside it (version-62
// API; see LICENSE.libjpeg-turbo) and links the host's libjpeg.so.62: the
// system's, else the one Pillow's wheel bundles.
#include <cstdio>  // jpeglib.h uses FILE without including stdio itself

#include <jpeglib.h>

#if JPEG_LIB_VERSION != 62
#error "image_pipe.cc takes libjpeg's version-62 API, the ABI of libjpeg.so.62"
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------- //
// JPEG decode (libjpeg, longjmp error trap)                               //
// ---------------------------------------------------------------------- //

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode a JPEG buffer to tightly-packed RGB8. Returns 0 on success.
// scale_num/8 pre-scaling (libjpeg DCT-domain) is requested by the caller
// when the target is much smaller than the source — the decoded size comes
// back in (w, h).
int decode_jpeg(const uint8_t* buf, int64_t len, int scale_num,
                std::vector<uint8_t>& rgb, int& w, int& h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.scale_num = scale_num;
  cinfo.scale_denom = 8;
  bool cmyk = cinfo.jpeg_color_space == JCS_CMYK ||
              cinfo.jpeg_color_space == JCS_YCCK;
  cinfo.out_color_space = cmyk ? JCS_CMYK : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = static_cast<int>(cinfo.output_width);
  h = static_cast<int>(cinfo.output_height);
  int comps = cinfo.output_components;  // 3 (RGB) or 4 (CMYK)
  std::vector<uint8_t> row(static_cast<size_t>(w) * comps);
  rgb.resize(static_cast<size_t>(w) * h * 3);
  JSAMPROW rows[1] = {row.data()};
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = static_cast<int>(cinfo.output_scanline);
    jpeg_read_scanlines(&cinfo, rows, 1);
    uint8_t* dst = rgb.data() + static_cast<size_t>(y) * w * 3;
    if (!cmyk) {
      std::memcpy(dst, row.data(), static_cast<size_t>(w) * 3);
    } else {
      // Adobe-style inverted CMYK -> RGB (what PIL produces for these files)
      for (int x = 0; x < w; ++x) {
        int c = row[4 * x], m = row[4 * x + 1], yy = row[4 * x + 2],
            k = row[4 * x + 3];
        dst[3 * x] = static_cast<uint8_t>(c * k / 255);
        dst[3 * x + 1] = static_cast<uint8_t>(m * k / 255);
        dst[3 * x + 2] = static_cast<uint8_t>(yy * k / 255);
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------------- //
// Pillow-style antialiased separable resampling (fp32)                    //
// ---------------------------------------------------------------------- //

inline double bicubic(double x) {  // Pillow's bicubic, a = -0.5
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

inline double bilinear(double x) {
  x = std::fabs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

struct Coeffs {
  std::vector<int> bounds;     // 2 per out pixel: (first src idx, count)
  std::vector<float> values;   // ksize per out pixel
  int ksize = 0;
};

// Pillow precompute_coeffs: out pixel i draws from src window
// [center - support, center + support], filter stretched by max(1, scale).
// NOTE the window clamps to the FULL image extent [0, in_size], not to the
// box — Pillow's resize(box=...) lets the filter support read pixels just
// outside the crop box (src/libImaging/Resample.c precompute_coeffs), and
// matching that keeps box-edge pixels identical to the PIL path.
Coeffs precompute(int in0, int in1, int in_size, int out, int filter) {
  double support0 = filter == 1 ? 1.0 : 2.0;
  double scale = static_cast<double>(in1 - in0) / out;
  double filterscale = std::max(scale, 1.0);
  double support = support0 * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  Coeffs c;
  c.ksize = ksize;
  c.bounds.resize(static_cast<size_t>(out) * 2);
  c.values.assign(static_cast<size_t>(out) * ksize, 0.0f);
  std::vector<double> k(ksize);  // hoisted: one alloc per axis, not per pixel
  for (int xx = 0; xx < out; ++xx) {
    double center = in0 + (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ss = 1.0 / filterscale;
    double wsum = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double wgt = (filter == 1 ? bilinear((x + xmin - center + 0.5) * ss)
                                : bicubic((x + xmin - center + 0.5) * ss));
      k[x] = wgt;
      wsum += wgt;
    }
    for (int x = 0; x < xmax; ++x)
      c.values[static_cast<size_t>(xx) * ksize + x] =
          static_cast<float>(wsum != 0.0 ? k[x] / wsum : 0.0);
    c.bounds[2 * xx] = xmin;
    c.bounds[2 * xx + 1] = xmax;
  }
  return c;
}

// 4-wide float vector (gcc/clang extension; lowers to SSE/NEON). Loads are
// done with memcpy so alignment never matters.
typedef float v4f __attribute__((vector_size(16)));

// Per-worker scratch so the hot path never re-allocates between images.
struct Scratch {
  std::vector<float> tmp;   // horizontal-pass output rows
  std::vector<float> frow;  // one source row expanded u8 -> fp32 (padded)
};

// Resample the box (bx0..bx1, by0..by1) of src (W x H RGB8) to rw x rh fp32.
// The horizontal pass expands each source row to fp32 once, then accumulates
// RGB(+1 slack lane) per tap with a single 4-wide FMA — bit-identical to the
// scalar r/g/b form but ~3x faster; the per-thread deficit vs Pillow's
// fixed-point SIMD resampler was the round-3 loader loss.
void resample(const uint8_t* src, int W, int H, int bx0, int bx1, int by0,
              int by1, int rw, int rh, int filter, Scratch& ws,
              std::vector<float>& out) {
  Coeffs ch = precompute(bx0, bx1, W, rw, filter);
  Coeffs cv = precompute(by0, by1, H, rh, filter);
  // horizontal pass over the rows the vertical pass needs
  int ymin = cv.bounds[0];
  int ymax = cv.bounds[2 * (rh - 1)] + cv.bounds[2 * (rh - 1) + 1];
  int nrows = ymax - ymin;
  ws.tmp.resize(static_cast<size_t>(nrows) * rw * 3);
  // +8 pad: the v4f load at the last tap of the last pixel reads one float
  // past 3*W.
  ws.frow.assign(static_cast<size_t>(W) * 3 + 8, 0.0f);
  float* frow = ws.frow.data();
  for (int y = 0; y < nrows; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y + ymin) * W * 3;
    for (int i = 0; i < W * 3; ++i) frow[i] = srow[i];
    float* trow = ws.tmp.data() + static_cast<size_t>(y) * rw * 3;
    for (int xx = 0; xx < rw; ++xx) {
      int xmin = ch.bounds[2 * xx], cnt = ch.bounds[2 * xx + 1];
      const float* k = &ch.values[static_cast<size_t>(xx) * ch.ksize];
      const float* p = frow + static_cast<size_t>(xmin) * 3;
      v4f acc = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int x = 0; x < cnt; ++x) {
        v4f px;
        std::memcpy(&px, p + 3 * x, sizeof(px));
        acc += k[x] * px;
      }
      trow[3 * xx] = acc[0];
      trow[3 * xx + 1] = acc[1];
      trow[3 * xx + 2] = acc[2];
    }
  }
  // vertical pass (contiguous rows: autovectorizes; first tap assigns so the
  // zero-fill pass over out is skipped)
  out.resize(static_cast<size_t>(rh) * rw * 3);
  for (int yy = 0; yy < rh; ++yy) {
    int smin = cv.bounds[2 * yy] - ymin, cnt = cv.bounds[2 * yy + 1];
    const float* k = &cv.values[static_cast<size_t>(yy) * cv.ksize];
    float* orow = out.data() + static_cast<size_t>(yy) * rw * 3;
    for (int y = 0; y < cnt; ++y) {
      const float* trow =
          ws.tmp.data() + static_cast<size_t>(smin + y) * rw * 3;
      float kv = k[y];
      if (y == 0) {
        for (int x = 0; x < rw * 3; ++x) orow[x] = kv * trow[x];
      } else {
        for (int x = 0; x < rw * 3; ++x) orow[x] += kv * trow[x];
      }
    }
    if (cnt == 0) std::fill(orow, orow + static_cast<size_t>(rw) * 3, 0.0f);
  }
}

struct Job {
  // per-image params: src crop box, resample target, crop window, flip
  int x0, y0, bw, bh;  // source box (bw/bh <= 0 -> full image)
  int rw, rh;          // resample size
  int cx, cy;          // window offset into the resampled image
  int flip;
};

}  // namespace

extern "C" {

// Header-only size probe: fills wh[2*i] = width, wh[2*i+1] = height
// (0, 0) on parse failure. Cheap (no pixel decode).
int ip_sizes(const uint8_t* const* bufs, const int64_t* lens, int n,
             int32_t* wh) {
  for (int i = 0; i < n; ++i) {
    jpeg_decompress_struct cinfo;
    ErrMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    wh[2 * i] = wh[2 * i + 1] = 0;
    if (setjmp(jerr.jump)) {
      jpeg_destroy_decompress(&cinfo);
      continue;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, bufs[i], static_cast<unsigned long>(lens[i]));
    if (jpeg_read_header(&cinfo, TRUE) == JPEG_HEADER_OK) {
      wh[2 * i] = static_cast<int32_t>(cinfo.image_width);
      wh[2 * i + 1] = static_cast<int32_t>(cinfo.image_height);
    }
    jpeg_destroy_decompress(&cinfo);
  }
  return 0;
}

// Batch decode + geometry + normalize.
//   params: 9 int32 per image (x0 y0 bw bh rw rh cx cy flip), coordinates in
//     FULL-RESOLUTION pixels (the pipeline rescales them if it decodes at a
//     reduced DCT scale).
//   out: n * out_h * out_w * 3 float32 NHWC.
//   status: per-image 0 = ok (non-zero rows are left zeroed; caller falls
//     back to the PIL path for those).
// Antialiased resampling means decoding at >= 2x the target then filtering
// is visually and numerically indistinguishable from filtering the full
// image (the filter sees >= Nyquist), so DCT-scaled decode is used when the
// box is >= 3x the resample target: the dominant cost of the whole loader is
// full-resolution IDCT.
int ip_batch(const uint8_t* const* bufs, const int64_t* lens, int n,
             const int32_t* params, int out_w, int out_h, int filter,
             int allow_prescale, const float* mean, const float* stdv,
             int n_threads, float* out, int32_t* status) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    std::vector<float> res;
    Scratch ws;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const int32_t* p = params + 9 * i;
      int x0 = p[0], y0 = p[1], bw = p[2], bh = p[3];
      int rw = p[4], rh = p[5], cx = p[6], cy = p[7], flip = p[8];
      float* dst = out + static_cast<size_t>(i) * out_h * out_w * 3;
      // DCT-scaled decode: smallest s/8 in 1/8..8/8 keeping the decoded box
      // >= 1.5x the resample target on both axes (filter support still spans
      // the remaining downscale, so antialiasing quality is preserved)
      int scale = 8;
      if (allow_prescale && bw > 0 && bh > 0 && rw > 0 && rh > 0) {
        while (scale > 1 && bw * (scale - 1) >= 12 * rw &&
               bh * (scale - 1) >= 12 * rh)
          --scale;
      }
      int W, H;
      if (decode_jpeg(bufs[i], lens[i], scale, rgb, W, H)) {
        status[i] = 1;
        std::memset(dst, 0, sizeof(float) * out_h * out_w * 3);
        continue;
      }
      double sc = scale / 8.0;
      int bx0, by0, bx1, by1;
      if (bw <= 0 || bh <= 0) {
        bx0 = by0 = 0;
        bx1 = W;
        by1 = H;
      } else {
        bx0 = std::min(static_cast<int>(std::lround(x0 * sc)), W - 1);
        by0 = std::min(static_cast<int>(std::lround(y0 * sc)), H - 1);
        bx1 = std::max(bx0 + 1,
                       std::min(static_cast<int>(std::lround((x0 + bw) * sc)), W));
        by1 = std::max(by0 + 1,
                       std::min(static_cast<int>(std::lround((y0 + bh) * sc)), H));
      }
      if (rw <= 0 || rh <= 0 || cx < 0 || cy < 0 || cx + out_w > rw ||
          cy + out_h > rh) {
        status[i] = 2;
        std::memset(dst, 0, sizeof(float) * out_h * out_w * 3);
        continue;
      }
      resample(rgb.data(), W, H, bx0, bx1, by0, by1, rw, rh, filter, ws, res);
      const float inv255 = 1.0f / 255.0f;
      float m0 = mean[0], m1 = mean[1], m2 = mean[2];
      float s0 = 1.0f / stdv[0], s1 = 1.0f / stdv[1], s2 = 1.0f / stdv[2];
      for (int y = 0; y < out_h; ++y) {
        const float* srow =
            res.data() + (static_cast<size_t>(y + cy) * rw + cx) * 3;
        float* drow = dst + static_cast<size_t>(y) * out_w * 3;
        for (int x = 0; x < out_w; ++x) {
          int sx = flip ? (out_w - 1 - x) : x;
          // PIL clips + rounds to uint8 after resampling; mirror that so the
          // native path matches the PIL-path quantization.
          float r = std::min(255.0f, std::max(0.0f, srow[3 * sx]));
          float g = std::min(255.0f, std::max(0.0f, srow[3 * sx + 1]));
          float b = std::min(255.0f, std::max(0.0f, srow[3 * sx + 2]));
          r = std::nearbyint(r);
          g = std::nearbyint(g);
          b = std::nearbyint(b);
          drow[3 * x] = (r * inv255 - m0) * s0;
          drow[3 * x + 1] = (g * inv255 - m1) * s1;
          drow[3 * x + 2] = (b * inv255 - m2) * s2;
        }
      }
      status[i] = 0;
    }
  };
  int nt = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
