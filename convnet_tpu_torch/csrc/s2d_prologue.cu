// Input prologue of the serving path: raw uint8 images -> the first
// conv's space-to-depth input, in one pass.
//
// Replaces the TPU kernel convnet_tpu/ops/s2d_relayout.py:200
// _relayout_kernel and the XLA one-hot crop einsums that feed it
// (jitter_crop_phased, s2d_relayout.py:79). On the TPU a per-image gather
// had to be written as batched one-hot matmuls into a phase-major
// intermediate, which the Pallas kernel then transposed. A GPU thread
// gathers its own pixel, so neither the contraction nor the intermediate
// exists here.
//
// For x uint8 (B, H, W, C), per-image crop origins oy, ox and optional
// flips, the output is bf16 (B, P, P, s*s*C), channel order (row-phase,
// col-phase, cin) -- the S2DInput that conv1 reads as channels_last.
// Output element (b, p, q, (rp*s + cp)*C + ci) holds cropped pixel
// (t_r, t_c) = (s*p + rp, s*q + cp) of channel ci, or exactly 0 where
// t_r or t_c lies past the crop (the ceil-mode pad). The pixel is
// normalised in f32 as v*scale, then -mean[ci], then /std[ci], in that
// order and each step rounded on its own (no FMA contraction, a true
// division), which is what the JAX package's jitter_s2d computes
// (s2d_relayout.py:171-181), so the result is bit-exact with it.
//
// Bound: device-memory bytes, a few integer ops per element. At AlexNet,
// batch 128, it reads 25 MB of uint8 and writes 40 MB of bf16. Design: one
// thread per output element, consecutive threads on consecutive output
// addresses (coalesced stores); the reads of one warp fall in a few rows of
// a few images and are served from L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
s2d_prologue_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ oy,
                    const int32_t* __restrict__ ox, const uint8_t* __restrict__ flip,
                    const float* __restrict__ mean, const float* __restrict__ stdev,
                    __nv_bfloat16* __restrict__ out, int h, int w, int c, int crop,
                    int s, int p, float scale, int64_t total) {
  const int k = s * s * c;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int64_t t = idx;
    const int kk = static_cast<int>(t % k);
    t /= k;
    const int q = static_cast<int>(t % p);
    t /= p;
    const int pr = static_cast<int>(t % p);
    const int b = static_cast<int>(t / p);
    const int ci = kk % c;
    const int phase = kk / c;  // rp*s + cp
    const int tr = s * pr + phase / s;
    const int tc = s * q + phase % s;
    float v = 0.0f;
    if (tr < crop && tc < crop) {
      const int row = oy[b] + tr;
      const int col = ox[b] + ((flip && flip[b]) ? crop - 1 - tc : tc);
      if (row < 0 || row >= h || col < 0 || col >= w) {
        v = NAN;  // crop origin outside the image: the caller broke its contract
      } else {
        v = static_cast<float>(x[((static_cast<int64_t>(b) * h + row) * w + col) * c + ci]);
        if (scale != 1.0f) v = __fmul_rn(v, scale);
        if (mean) v = __fsub_rn(v, mean[ci]);
        if (stdev) v = __fdiv_rn(v, stdev[ci]);
      }
    }
    out[idx] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// x: uint8 (b, h, w, c) contiguous; oy, ox: int32 (b,); flip: uint8 (b,) or
// null; mean, stdev: f32 (c,) or null; out: bf16 (b, p, p, s*s*c)
// contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int cn_s2d_prologue(const void* x, const void* oy, const void* ox,
                               const void* flip, const void* mean, const void* stdev,
                               void* out, int b, int h, int w, int c, int crop, int s,
                               int p, float scale, void* stream) {
  if (b <= 0 || c <= 0 || s <= 0 || p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(b) * p * p * s * s * c;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
  s2d_prologue_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int32_t*>(oy),
      static_cast<const int32_t*>(ox), static_cast<const uint8_t*>(flip),
      static_cast<const float*>(mean), static_cast<const float*>(stdev),
      static_cast<__nv_bfloat16*>(out), h, w, c, crop, s, p, scale, total);
  return static_cast<int>(cudaGetLastError());
}
