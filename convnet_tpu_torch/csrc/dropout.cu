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
// i % 4 of Philox at counter (group0 + i/4, 0, 0) in the low 64 bits. So
// the forward (on x) and the backward (on the cotangent) draw the same mask
// and store none, and the plain PyTorch version in
// convnet_tpu_torch/ops/dropout.py draws the same bits on any device.
//
// Bound: device-memory bytes, 2 in and 2 out per bf16 element (at AlexNet's
// fc6/fc7, batch 128: 1 MB each way, 0.0006 ms at 3.35 TB/s); one Philox
// call (10 rounds of two 32x32->64 multiplies) serves 4 elements. At that
// size a call is a few microseconds of launch and latency, so the design
// cuts instructions and memory transactions per element: a thread takes 8
// consecutive elements, two Philox calls (counters group0 + 2t and group0 +
// 2t + 1), one 16-byte load and one 16-byte store in bf16 (two each in
// f32). Pointers not 16-byte aligned, and the last partial group of 8,
// take element-wise accesses with the same bits.

#include "dtype.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

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

// For bf16, x and scale are bf16 values: their f32 product is exact and
// rounds once to bf16, which is the bf16 multiply.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n, uint32_t threshold,
               float scale, uint32_t k0, uint32_t k1, uint64_t group0) {
  const int64_t threads = (n + kPerThread - 1) / kPerThread;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < threads;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    uint32_t bits[kPerThread];
#pragma unroll
    for (int h = 0; h < kPerThread / 4; ++h) {
      const uint64_t ctr = group0 + static_cast<uint64_t>(t) * (kPerThread / 4) + h;
      uint32_t* c = bits + 4 * h;
      c[0] = static_cast<uint32_t>(ctr);
      c[1] = static_cast<uint32_t>(ctr >> 32);
      c[2] = c[3] = 0u;
      philox4x32_10(c, k0, k1);
    }
    const int64_t i0 = t * kPerThread;
    if (VEC && i0 + kPerThread <= n) {
      float v[kPerThread];
      load_vec<kPerThread>(x + i0, v);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) v[j] = bits[j] >= threshold ? __fmul_rn(v[j], scale) : 0.0f;
      store_vec<kPerThread>(y + i0, v);
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (i0 + j < n) {
          store_f32(y, i0 + j, bits[j] >= threshold ? __fmul_rn(load_f32(x, i0 + j), scale) : 0.0f);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* y, int64_t n, uint32_t threshold, float scale, uint32_t k0,
           uint32_t k1, uint64_t group0, cudaStream_t s) {
  const int64_t threads = (n + kPerThread - 1) / kPerThread;
  const int64_t want = (threads + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 16) ? want : (1 << 16));
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (vec) {
    dropout_kernel<T, true><<<blocks, kThreads, 0, s>>>(xs, ys, n, threshold, scale, k0, k1, group0);
  } else {
    dropout_kernel<T, false><<<blocks, kThreads, 0, s>>>(xs, ys, n, threshold, scale, k0, k1, group0);
  }
  return static_cast<int>(cudaGetLastError());
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, y, n, threshold, scale, k0, k1, group0, s)
                 : launch<float>(x, y, n, threshold, scale, k0, k1, group0, s);
}
