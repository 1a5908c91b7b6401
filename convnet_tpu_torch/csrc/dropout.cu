// Inverted dropout with a counter-based mask: y = x * scale where kept,
// 0 where dropped, the mask drawn from (key, element index) alone.
//
// Replaces the TPU kernel convnet_tpu/ops/dropout.py:58 _mask_kernel,
// which draws the TPU's hardware random bits per tile. Its keep rule and
// scaling are kept: keep = bits >= threshold, threshold =
// min(floor(rate * 2^32), 2^32 - 1); y = x * scale in x's dtype, scale =
// 1/(1 - rate) rounded to x's dtype. The bits are not the TPU's: they are
// Philox4x32-10 (Salmon et al., SC'11), keyed by two 32-bit words that the
// caller derives from (seed, step, layer), with element i's bits the word
// (group0*4 + i) % 4 of Philox at counter (group0 + i/4, 0, 0) in the low
// 64 bits. So the forward (on x) and the backward (on the cotangent) draw
// the same mask and store none, and the plain PyTorch version in
// convnet_tpu_torch/ops/dropout.py draws the same bits on any device.
//
// Bound: device-memory bytes, 2 in and 2 out per bf16 element (at AlexNet's
// fc6/fc7, batch 128: 1 MB each way); one Philox call (10 rounds of two
// 32x32->64 multiplies) serves 4 elements. Design: one thread per group of
// 4 consecutive elements, grid-strided.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
  for (int round = 0; round < 10; ++round) {
    if (round) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__device__ __forceinline__ float load_f32(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// For bf16, x and scale are bf16 values: their f32 product is exact and
// rounds once to bf16, which is the bf16 multiply.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n, uint32_t threshold,
               float scale, uint32_t k0, uint32_t k1, uint64_t group0) {
  const int64_t groups = (n + 3) / 4;
  for (int64_t grp = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       grp < groups; grp += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uint64_t ctr = group0 + static_cast<uint64_t>(grp);
    uint32_t bits[4] = {static_cast<uint32_t>(ctr), static_cast<uint32_t>(ctr >> 32), 0u, 0u};
    philox4x32_10(bits, k0, k1);
    for (int j = 0; j < 4; ++j) {
      const int64_t i = grp * 4 + j;
      if (i >= n) break;
      store_f32(y, i, bits[j] >= threshold ? __fmul_rn(load_f32(x, i), scale) : 0.0f);
    }
  }
}

}  // namespace

// x, y: n contiguous elements each, bf16 when is_bf16 else f32, not
// overlapping. scale: 1/(1 - rate) already rounded to x's dtype. The
// element offset of x[0] in the mask's counter space is 4 * group0.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int cn_dropout(const void* x, void* y, int64_t n, int is_bf16, uint32_t threshold,
                          float scale, uint32_t k0, uint32_t k1, uint64_t group0,
                          void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t groups = (n + 3) / 4;
  const int64_t want = (groups + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 16) ? want : (1 << 16));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dropout_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n, threshold,
        scale, k0, k1, group0);
  } else {
    dropout_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, threshold, scale, k0, k1,
        group0);
  }
  return static_cast<int>(cudaGetLastError());
}
