// JPEG loader: libjpeg decode, shorter-side bilinear resize and center
// crop of a list of image files, fanned out over a persistent worker pool,
// writing straight into a caller-provided uint8 NHWC buffer.
//
// The port's own copy of the JPEG half of native/dataloader.cc (the JAX
// package's loader), without its raw-cache half, which
// convnet_tpu_torch/native/raw_cache.cc holds; convnet_tpu_torch/data/
// native.py builds it with g++ -ljpeg at first use (NativeImageLoader).
// The decode takes libjpeg's power-of-2 DCT scaling, as PIL's Image.draft
// does, and the resize PIL BILINEAR's triangle taps, so the two decode
// paths stay in parity.
//
// C ABI:
//   void* loader_create(const char** paths, int n, int raw_size,
//                       int colors, int threads);
//   int   loader_load(void* h, const int64_t* indices, int count,
//                     uint8_t* out);   // out: count*raw*raw*colors
//   void  loader_destroy(void* h);

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>  // requires <cstdio>/<cstddef> first (stdio-free header)

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to packed RGB (or grayscale). When min_side > 0,
// uses libjpeg's fractional DCT scaling to decode directly at the
// smallest scale whose shorter side still covers min_side — the big
// cost saver when shrinking large photos to training resolution.
bool DecodeJpeg(const std::string& path, int want_colors,
                std::vector<uint8_t>* pixels, int* width, int* height,
                int min_side = 0) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = want_colors == 1 ? JCS_GRAYSCALE : JCS_RGB;
  if (min_side > 0) {
    // power-of-2 DCT scaling only (1/1, 1/2, 1/4, 1/8) — exactly what
    // PIL's Image.draft does, keeping the two decode paths in parity
    const int shorter = cinfo.image_width < cinfo.image_height
                            ? cinfo.image_width
                            : cinfo.image_height;
    int denom = 1;
    while (denom < 8 && shorter / (denom * 2) >= min_side) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  const int ch = cinfo.output_components;
  pixels->resize(static_cast<size_t>(*width) * *height * ch);
  std::vector<uint8_t*> rows(cinfo.output_height);
  for (unsigned r = 0; r < cinfo.output_height; ++r)
    rows[r] = pixels->data() + static_cast<size_t>(r) * *width * ch;
  while (cinfo.output_scanline < cinfo.output_height) {
    jpeg_read_scanlines(&cinfo, rows.data() + cinfo.output_scanline,
                        cinfo.output_height - cinfo.output_scanline);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Precomputed normalized triangle-filter taps for one resample axis
// (PIL BILINEAR semantics: support scales with the reduction factor, so
// the native path stays numerically close to the PIL fallback).
struct ResampleTaps {
  std::vector<int> lo;           // first source index per output index
  std::vector<int> len;          // tap count per output index
  std::vector<float> w;          // taps, packed [out][tap]
  std::vector<int> off;          // start into w per output index
};

ResampleTaps BuildTaps(int n_in, int n_out) {
  ResampleTaps t;
  t.lo.resize(n_out);
  t.len.resize(n_out);
  t.off.resize(n_out);
  const double scale = static_cast<double>(n_in) / n_out;
  const double filterscale = scale > 1.0 ? scale : 1.0;
  const double support = filterscale;  // triangle radius
  for (int i = 0; i < n_out; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    int hi = static_cast<int>(center + support + 0.5);
    if (lo < 0) lo = 0;
    if (hi > n_in) hi = n_in;
    t.lo[i] = lo;
    t.len[i] = hi - lo;
    t.off[i] = static_cast<int>(t.w.size());
    double wsum = 0.0;
    for (int j = lo; j < hi; ++j) {
      const double d = (j - center + 0.5) / filterscale;
      const double wj = d > -1.0 && d < 1.0 ? 1.0 - (d < 0 ? -d : d) : 0.0;
      t.w.push_back(static_cast<float>(wj));
      wsum += wj;
    }
    if (wsum > 0.0) {
      const float inv = static_cast<float>(1.0 / wsum);
      for (int k = t.off[i]; k < static_cast<int>(t.w.size()); ++k) t.w[k] *= inv;
    }
  }
  return t;
}

// One separable pass along the leading dimension: (n_in, stride) ->
// (n_out, stride) float rows, weights precomputed; inner loops are
// flat float MACs the compiler vectorizes. Src may be uint8 (first
// pass: folds the int->float conversion in) or float.
template <typename SrcT>
void ResamplePass(const SrcT* src, const ResampleTaps& t, int n_out,
                  size_t stride, float* dst) {
  for (int i = 0; i < n_out; ++i) {
    float* drow = dst + static_cast<size_t>(i) * stride;
    std::memset(drow, 0, stride * sizeof(float));
    const float* wp = t.w.data() + t.off[i];
    for (int k = 0; k < t.len[i]; ++k) {
      const float wk = wp[k];
      const SrcT* srow = src + static_cast<size_t>(t.lo[i] + k) * stride;
      for (size_t x = 0; x < stride; ++x)
        drow[x] += wk * static_cast<float>(srow[x]);
    }
  }
}

// Antialiased resize (shorter side -> raw) + center crop into out
// (raw*raw*colors), matching the PIL reader (PIL BILINEAR).
void ResizeCrop(const uint8_t* src, int sw, int sh, int colors, int raw,
                uint8_t* out) {
  const double scale = static_cast<double>(raw) / (sw < sh ? sw : sh);
  int nw = static_cast<int>(sw * scale + 0.5);
  int nh = static_cast<int>(sh * scale + 0.5);
  if (nw < raw) nw = raw;
  if (nh < raw) nh = raw;

  // vertical pass: (sh, sw*colors) -> (nh, sw*colors), uint8 in
  std::vector<float> tmp(static_cast<size_t>(nh) * sw * colors);
  const ResampleTaps vtaps = BuildTaps(sh, nh);
  ResamplePass(src, vtaps, nh, static_cast<size_t>(sw) * colors, tmp.data());
  // horizontal pass per row: treat each row as (sw, colors) -> (nw, colors)
  std::vector<float> resized(static_cast<size_t>(nh) * nw * colors);
  const ResampleTaps htaps = BuildTaps(sw, nw);
  for (int y = 0; y < nh; ++y) {
    ResamplePass(tmp.data() + static_cast<size_t>(y) * sw * colors, htaps, nw,
                 colors, resized.data() + static_cast<size_t>(y) * nw * colors);
  }
  const int left = (nw - raw) / 2;
  const int top = (nh - raw) / 2;
  for (int y = 0; y < raw; ++y) {
    for (int x = 0; x < raw; ++x) {
      for (int c = 0; c < colors; ++c) {
        float v = resized[((static_cast<size_t>(y + top)) * nw + (x + left)) *
                              colors +
                          c];
        if (v < 0) v = 0;
        if (v > 255) v = 255;
        out[(static_cast<size_t>(y) * raw + x) * colors + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// Persistent worker pool. Batch state lives in members (never in a
// caller stack frame) and batches are generation-stamped: a worker that
// wakes late sees count_ == 0 and goes back to sleep, so no thread can
// ever touch a completed batch's buffers (the use-after-return a
// queue-of-closures design invites).
class Loader {
 public:
  Loader(std::vector<std::string> paths, int raw, int colors, int threads)
      : paths_(std::move(paths)), raw_(raw), colors_(colors) {
    if (threads < 1) threads = 1;
    for (int i = 0; i < threads; ++i)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_worker_.notify_all();
    for (auto& t : workers_) t.join();
  }

  int Load(const int64_t* indices, int count, uint8_t* out) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      idx_ = indices;
      out_ = out;
      count_ = count;
      next_.store(0);
      errors_.store(0);
      ++gen_;
    }
    cv_worker_.notify_all();
    Work();  // caller participates
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [this] { return inflight_ == 0; });
    idx_ = nullptr;
    out_ = nullptr;
    count_ = 0;
    const int errs = errors_.load();
    return errs ? -errs : 0;
  }

 private:
  void Work() {
    const size_t row = static_cast<size_t>(raw_) * raw_ * colors_;
    for (;;) {
      const int k = next_.fetch_add(1);
      if (k >= count_) break;
      const int64_t idx = idx_[k];
      if (idx < 0 || idx >= static_cast<int64_t>(paths_.size())) {
        errors_.fetch_add(1);
        std::memset(out_ + row * k, 0, row);
        continue;
      }
      std::vector<uint8_t> pix;
      int w = 0, h = 0;
      if (DecodeJpeg(paths_[idx], colors_, &pix, &w, &h, raw_)) {
        ResizeCrop(pix.data(), w, h, colors_, raw_, out_ + row * k);
      } else {
        std::memset(out_ + row * k, 0, row);
        errors_.fetch_add(1);
      }
    }
  }

  void WorkerLoop() {
    uint64_t seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_worker_.wait(lk, [&] {
          return stop_ || (gen_ != seen && next_.load() < count_);
        });
        if (stop_) return;
        seen = gen_;
        ++inflight_;
      }
      Work();
      {
        std::lock_guard<std::mutex> lk(mu_);
        --inflight_;
      }
      cv_done_.notify_all();
    }
  }

  std::vector<std::string> paths_;
  const int raw_;
  const int colors_;
  std::vector<std::thread> workers_;

  std::mutex mu_;
  std::condition_variable cv_worker_, cv_done_;
  bool stop_ = false;
  uint64_t gen_ = 0;
  int inflight_ = 0;
  const int64_t* idx_ = nullptr;
  uint8_t* out_ = nullptr;
  int count_ = 0;
  std::atomic<int> next_{0}, errors_{0};
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n, int raw_size, int colors,
                    int threads) {
  if (n <= 0 || raw_size <= 0 || (colors != 1 && colors != 3)) return nullptr;
  std::vector<std::string> p(paths, paths + n);
  return new Loader(std::move(p), raw_size, colors, threads);
}

int loader_load(void* h, const int64_t* indices, int count, uint8_t* out) {
  if (!h || !indices || !out || count < 0) return -1;
  return static_cast<Loader*>(h)->Load(indices, count, out);
}

void loader_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
