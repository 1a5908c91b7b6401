// Cross-map response normalization (LRN) forward, with the producing
// conv's bias and the ReLU optionally fused in.
//
// Replaces two TPU kernels of the JAX package, which compute one function
// in two TPU memory layouts:
//   convnet_tpu/ops/lrn.py:212 _lrn_fwd_kernel   (folded-2D, C-minor rows;
//                                                 AlexNet rnorm2, C=256)
//   convnet_tpu/ops/lrn.py:535 _lrn_fwd_kernel_r (batch-minor r2d form;
//                                                 AlexNet rnorm1, C=96)
// This kernel computes the function, not either layout: it reads the
// channels_last bytes cuDNN's conv writes, M = B*H*W rows of C contiguous
// channels, so neither side of it needs a transpose.
//
//   x   = relu(z + b)                    (bias and relu optional)
//   s_i = sum over window(i) of x_j^2    window: [i - n/2, i + (n-1)/2]
//                                        clipped, or the size-n block of i
//   y   = x * (1 + alpha * s)^(-beta)
//
// Math is f32, in lrn_math.cuh (shared with the fused LRN -> pool kernels
// of pool_lrn.cu, which must reproduce this y bit for bit); the output has
// the input's dtype (bf16 or f32).
//
// Bound: device-memory bytes. Per element it does a few flops and an
// n-term window sum, against 2 bytes read and 2 written in bf16; at AlexNet
// rnorm1, batch 128, that is 74 MB in and 74 MB out. Design: a block stages
// a tile of whole rows in shared memory (f32, after bias and ReLU) with
// coalesced loads, then each thread sums its window out of shared memory
// and stores its output element, again coalesced.

#include "lrn_math.cuh"

namespace {

constexpr int kThreads = 256;
// f32 elements staged per block: whole rows, at least one.
constexpr int kTileElems = 4096;
constexpr int kMaxSharedBytes = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const T* __restrict__ z, const float* __restrict__ bias,
               T* __restrict__ y, int64_t m, int c, int rows_per_block,
               int relu, int blocked, int n, float alpha, float beta, int q) {
  extern __shared__ float tile[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(min(static_cast<int64_t>(rows_per_block), m - row0));
  const int elems = rows * c;
  const int64_t base = row0 * c;

  for (int i = threadIdx.x; i < elems; i += blockDim.x) {
    tile[i] = lrn_input(load_f32(z, base + i), bias, i % c, relu);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < elems; i += blockDim.x) {
    const int r = i / c;
    const int ch = i - r * c;
    store_f32(y, base + i, lrn_y(tile + r * c, ch, c, n, blocked, alpha, beta, q));
  }
}

}  // namespace

// z, y: (m, c) contiguous, bf16 when is_bf16 else f32. bias: f32 (c,) or
// null. Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int cn_lrn_fwd(const void* z, const void* bias, void* y, int64_t m,
                          int c, int is_bf16, int relu, int blocked, int n,
                          float alpha, float beta, int q, void* stream) {
  if (m <= 0 || c <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = c >= kTileElems ? 1 : kTileElems / c;
  const size_t smem = static_cast<size_t>(rows_per_block) * c * sizeof(float);
  const int64_t blocks = (m + rows_per_block - 1) / rows_per_block;
  if (smem > kMaxSharedBytes || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    lrn_fwd_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(z), b, static_cast<__nv_bfloat16*>(y), m, c,
        rows_per_block, relu, blocked, n, alpha, beta, q);
  } else {
    lrn_fwd_kernel<float><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        static_cast<const float*>(z), b, static_cast<float*>(y), m, c, rows_per_block,
        relu, blocked, n, alpha, beta, q);
  }
  return static_cast<int>(cudaGetLastError());
}
