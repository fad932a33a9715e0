// Native batch-assembly core for the glom_tpu data pipeline.
//
// The reference delegates data loading to torch's DataLoader (C++ under the
// hood); this is the equivalent runtime piece here: multithreaded gather +
// dtype conversion + nearest-neighbor resize from a resident dataset buffer
// into a ready NCHW float32 batch, plus (when libjpeg is present at build
// time) a multithreaded JPEG file decoder fusing decode -> shorter-side
// resize -> center crop -> [-1,1] NCHW normalize with no Python in the
// loop, so host-side batch prep never blocks the TPU dispatch thread and
// scales with cores instead of saturating on GIL overhead.  Exposed as a
// plain C ABI consumed via ctypes (glom_tpu/native/__init__.py); built on
// demand with g++ -O3 (with -ljpeg -DGLOM_WITH_JPEG when available).
//
// Layout contracts match glom_tpu/training/data.py exactly:
//   * uint8 inputs are NHWC (the common dump format), normalized x/127.5-1
//   * float32 inputs are NCHW, passed through
//   * resize is per-axis nearest neighbor: src = floor(dst * src_dim / dst_dim)
// The JPEG path matches glom_tpu/training/image_stream.py::_decode's
// geometry (shorter-side resize to `size`, center crop, x/127.5-1) with
// bilinear interpolation; pixel values may differ from the cv2/PIL path at
// the interpolation level only.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Number of worker threads: hardware concurrency (capped for the
// memory-bound gather kernels, uncapped for CPU-bound JPEG decode), min 1.
int worker_count(int64_t batch, int64_t cap) {
  unsigned hc = std::thread::hardware_concurrency();
  int64_t n = hc == 0 ? 1 : static_cast<int64_t>(hc);
  if (cap > 0 && n > cap) n = cap;
  if (n > batch) n = batch;
  return static_cast<int>(n);
}

template <typename Fn>
void parallel_for(int64_t count, Fn fn, int64_t cap = 16) {
  int workers = worker_count(count, cap);
  if (workers <= 1) {
    for (int64_t i = 0; i < count; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (int64_t i = next.fetch_add(1); i < count; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

inline void resize_indices(int64_t dst, int64_t src, std::vector<int64_t>& out) {
  out.resize(dst);
  for (int64_t i = 0; i < dst; ++i) out[i] = i * src / dst;
}

}  // namespace

extern "C" {

// Gather float32 NCHW samples `data[idx[b]]` into `out` (bs, c, size, size)
// with nearest-neighbor resize from (h, w).
void glom_batch_f32(const float* data, int64_t n, int64_t c, int64_t h, int64_t w,
                    const int64_t* idx, int64_t bs, int64_t size, float* out) {
  std::vector<int64_t> ri, ci;
  resize_indices(size, h, ri);
  resize_indices(size, w, ci);
  const int64_t src_img = c * h * w;
  const int64_t dst_img = c * size * size;
  parallel_for(bs, [&](int64_t b) {
    const float* src = data + idx[b] * src_img;
    float* dst = out + b * dst_img;
    for (int64_t ch = 0; ch < c; ++ch) {
      const float* sc = src + ch * h * w;
      float* dc = dst + ch * size * size;
      for (int64_t y = 0; y < size; ++y) {
        const float* srow = sc + ri[y] * w;
        float* drow = dc + y * size;
        for (int64_t x = 0; x < size; ++x) drow[x] = srow[ci[x]];
      }
    }
  });
}

// Gather uint8 NHWC samples, normalize to [-1, 1], emit float32 NCHW with
// nearest-neighbor resize.
void glom_batch_u8_nhwc(const uint8_t* data, int64_t n, int64_t h, int64_t w, int64_t c,
                        const int64_t* idx, int64_t bs, int64_t size, float* out) {
  std::vector<int64_t> ri, ci;
  resize_indices(size, h, ri);
  resize_indices(size, w, ci);
  const int64_t src_img = h * w * c;
  const int64_t dst_img = c * size * size;
  parallel_for(bs, [&](int64_t b) {
    const uint8_t* src = data + idx[b] * src_img;
    float* dst = out + b * dst_img;
    for (int64_t y = 0; y < size; ++y) {
      const uint8_t* srow = src + ri[y] * w * c;
      for (int64_t x = 0; x < size; ++x) {
        const uint8_t* spx = srow + ci[x] * c;
        for (int64_t ch = 0; ch < c; ++ch) {
          dst[ch * size * size + y * size + x] =
              static_cast<float>(spx[ch]) / 127.5f - 1.0f;
        }
      }
    }
  });
}

// ---------------------------------------------------------------------------
// JPEG batch decoder (compiled only when libjpeg is available at build time;
// glom_tpu/native/__init__.py retries the build without it on link failure).
// ---------------------------------------------------------------------------

int glom_has_jpeg(void);

#ifdef GLOM_WITH_JPEG
}  // extern "C" (jpeglib.h must not be wrapped in it twice)

#include <csetjmp>
#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
  char msg[JMSG_LENGTH_MAX];
};

void jpeg_error_trap(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, e->msg);
  longjmp(e->jb, 1);
}

// Decode one JPEG into dst (3, size, size) float32 NCHW in [-1, 1]:
// libjpeg DCT-domain prescale (cheapest possible downscale), then bilinear
// shorter-side resize + center crop sampled directly into the output (the
// fully resized image is never materialized).
bool decode_jpeg_one(const char* path, int64_t size, float* dst, std::string& err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    err = "cannot open file";
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (len <= 0) {
    std::fclose(f);
    err = "empty file";
    return false;
  }
  std::vector<unsigned char> buf(static_cast<size_t>(len));
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (got != buf.size()) {
    err = "short read";
    return false;
  }

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_trap;
  std::vector<unsigned char> img;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    err = jerr.msg;
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf.data(), static_cast<unsigned long>(buf.size()));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // smallest num/8 prescale keeping the shorter side >= size (never DCT-
  // upscale: bilinear below handles sub-`size` sources)
  {
    int64_t mind = std::min<int64_t>(cinfo.image_width, cinfo.image_height);
    int num = 8;
    for (int cand = 1; cand <= 8; ++cand) {
      if (mind * cand / 8 >= size) {
        num = cand;
        break;
      }
    }
    cinfo.scale_num = static_cast<unsigned>(num);
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  const int64_t W = cinfo.output_width, H = cinfo.output_height;
  const int64_t C = cinfo.output_components;  // 3 (JCS_RGB forced)
  img.resize(static_cast<size_t>(W * H * C));
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = img.data() + static_cast<int64_t>(cinfo.output_scanline) * W * C;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (C != 3) {
    err = "unexpected component count";
    return false;
  }

  // shorter-side scale to exactly `size`, center crop, bilinear sample
  const double scale = static_cast<double>(size) / static_cast<double>(std::min(W, H));
  const int64_t OW = std::max<int64_t>(size, llround(W * scale));
  const int64_t OH = std::max<int64_t>(size, llround(H * scale));
  const int64_t x0 = (OW - size) / 2, y0 = (OH - size) / 2;
  const float inv = 1.0f / 127.5f;
  for (int64_t y = 0; y < size; ++y) {
    // align centers: src = (dst + 0.5) * (S / D) - 0.5
    double ys = (static_cast<double>(y + y0) + 0.5) * H / OH - 0.5;
    ys = std::min(std::max(ys, 0.0), static_cast<double>(H - 1));
    const int64_t yi = static_cast<int64_t>(ys);
    const int64_t yj = std::min<int64_t>(yi + 1, H - 1);
    const float fy = static_cast<float>(ys - yi);
    for (int64_t x = 0; x < size; ++x) {
      double xs = (static_cast<double>(x + x0) + 0.5) * W / OW - 0.5;
      xs = std::min(std::max(xs, 0.0), static_cast<double>(W - 1));
      const int64_t xi = static_cast<int64_t>(xs);
      const int64_t xj = std::min<int64_t>(xi + 1, W - 1);
      const float fx = static_cast<float>(xs - xi);
      const unsigned char* p00 = img.data() + (yi * W + xi) * 3;
      const unsigned char* p01 = img.data() + (yi * W + xj) * 3;
      const unsigned char* p10 = img.data() + (yj * W + xi) * 3;
      const unsigned char* p11 = img.data() + (yj * W + xj) * 3;
      for (int64_t ch = 0; ch < 3; ++ch) {
        const float top = p00[ch] + (p01[ch] - p00[ch]) * fx;
        const float bot = p10[ch] + (p11[ch] - p10[ch]) * fx;
        dst[ch * size * size + y * size + x] = (top + (bot - top) * fy) * inv - 1.0f;
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

int glom_has_jpeg(void) { return 1; }

// Decode `bs` JPEG files into out (bs, 3, size, size) float32 NCHW.
// `max_workers` caps the decode threads (0 = every core — decode is
// CPU-bound; callers bound it to their configured worker budget so decode
// never oversubscribes the host against the TPU dispatch thread).
// Returns 0 on success; on failure, 1 + the LOWEST index among failing
// files, with that file's message copied into err (NUL-terminated, errlen
// cap).  Every file is decoded even once a failure is seen — failures are
// exceptional, and skipping would make the reported index depend on thread
// timing instead of the batch contents.
int64_t glom_decode_jpeg_batch(const char* const* paths, int64_t bs, int64_t size,
                               int64_t max_workers, float* out, char* err,
                               int64_t errlen) {
  std::atomic<int64_t> bad(-1);
  std::mutex bad_mu;
  const int64_t img_elems = 3 * size * size;
  parallel_for(bs, [&](int64_t b) {
    std::string msg;
    if (!decode_jpeg_one(paths[b], size, out + b * img_elems, msg)) {
      std::lock_guard<std::mutex> g(bad_mu);
      int64_t cur = bad.load(std::memory_order_relaxed);
      if (cur < 0 || b < cur) {
        bad.store(b, std::memory_order_relaxed);
        if (err && errlen > 0) {
          std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
        }
      }
    }
  }, /*cap=*/max_workers);
  return bad.load() + 1;
}

#else   // !GLOM_WITH_JPEG

int glom_has_jpeg(void) { return 0; }

int64_t glom_decode_jpeg_batch(const char* const*, int64_t, int64_t, int64_t,
                               float*, char*, int64_t) {
  return -1;
}

#endif  // GLOM_WITH_JPEG

}  // extern "C"
