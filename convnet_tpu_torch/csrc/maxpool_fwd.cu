// Max pooling forward over NHWC activations, cuda-convnet's ceil-mode
// geometry: output size 1 + ceil((in + 2*pad - k) / s) (capped so the last
// window still overlaps the input); taps outside the input are -inf.
//
// Replaces the TPU kernel convnet_tpu/ops/pool.py:87 _maxpool_kernel
// (launched by _pallas_maxpool_local, pool.py:130), which takes the k row
// taps of each output row as k shifted block views and the column taps as
// an s-phase reshape. It needs (H, W, lanes) views of relaid activations;
// here the kernel reads the NHWC bytes cuDNN writes, and any geometry,
// not only the exact-cover pools that kernel accepts.
//
// Bound: device-memory bytes. Each input element is read about (k/s)^2
// times, from L2 after the first; at AlexNet's pool5, batch 128, bf16,
// the function moves 11.1 MB in and 2.4 MB out, about 4 us at 3.35 TB/s.
// Design: one thread per output element, neighbouring threads on
// neighbouring channels, so every tap's loads are coalesced. The window is
// scanned row by row, left to right, keeping the first of equal maxima and
// letting a NaN through, as ATen's max pool does: the result equals the
// plain version (convnet_tpu_torch/ops/pool.py:maxpool_reference) exactly.

#include <math_constants.h>

#include "dtype.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t total, int h, int w,
                   int c, int oh, int ow, int k, int s, int pad) {
  for (int64_t o = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; o < total;
       o += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(o % c);
    int64_t rest = o / c;
    const int ox = static_cast<int>(rest % ow);
    rest /= ow;
    const int oy = static_cast<int>(rest % oh);
    const int64_t b = rest / oh;
    const int64_t img = b * h;
    float m = -CUDART_INF_F;
    for (int i = 0; i < k; ++i) {
      const int r = oy * s - pad + i;
      if (r < 0 || r >= h) continue;
      for (int j = 0; j < k; ++j) {
        const int col = ox * s - pad + j;
        if (col < 0 || col >= w) continue;
        const float v = load_f32(x, ((img + r) * w + col) * c + ch);
        if (v > m || v != v) m = v;  // v != v: a NaN
        if (m != m) break;
      }
      if (m != m) break;
    }
    store_f32(y, o, m);  // exact: m is one of the inputs
  }
}

}  // namespace

// x: (b, h, w, c) contiguous; y: (b, oh, ow, c) contiguous; both bf16 when
// is_bf16 else f32. Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int cn_maxpool_fwd(const void* x, void* y, int b, int h, int w, int c, int oh,
                              int ow, int k, int s, int pad, int is_bf16, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0 || k <= 0 || s <= 0 ||
      pad < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(b) * oh * ow * c;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    maxpool_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), total, h, w, c,
        oh, ow, k, s, pad);
  } else {
    maxpool_fwd_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), total, h, w, c, oh, ow, k, s,
        pad);
  }
  return static_cast<int>(cudaGetLastError());
}
