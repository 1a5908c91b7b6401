// Cross-map response normalization (LRN) backward, with the producing
// conv's bias gradient (db) and the fused ReLU's mask.
//
// Replaces the TPU kernels of the JAX package that compute one function in
// three TPU memory layouts:
//   convnet_tpu/ops/lrn.py:230 _lrn_bwd_kernel   (folded-2D, C-minor rows;
//                                                 AlexNet rnorm2, C=256)
//   convnet_tpu/ops/lrn.py:558 _lrn_bwd_kernel_r (batch-minor r2d form;
//                                                 AlexNet rnorm1, C=96)
//   convnet_tpu/ops/lrn.py:455 _lrn_bwd_kernel_t (opt-in t-form)
// Like lrn_fwd.cu it reads the channels_last bytes cuDNN writes: M rows of
// C contiguous channels, for both shapes.
//
// With z the conv output without its bias, g the cotangent of y:
//   x   = relu(z + b)                       (bias and relu optional)
//   d_i = 1 + alpha * sum over window(i) of x_j^2
//   u_j = g_j * x_j * d_j^-(beta+1)
//   t_i = sum over the transposed window of i of u_j, i.e. over the j
//         whose window holds i: [i - (n-1)/2, i + n/2] clipped, or i's
//         block when windows are blocked
//   dx  = g * d^-beta - 2*alpha*beta * x * t, and 0 where z + b <= 0 if relu
//   db  = column sums of the f32 dx, when a bias is given
// d is recomputed from z, as the reference's custom VJP does, so the
// forward stores no residual beyond z. Math is f32 (lrn_math.cuh); dx has
// z's dtype.
// d^-beta and d^-(beta+1) come from qr = sqrt(rsqrt(d)) raised by squaring
// (lrn.py:128 _neg_pow_pair) for quarter-integer beta.
//
// Bound: device-memory bytes. Per element it reads g and z and writes dx
// (2 bytes each in bf16: 222 MB at AlexNet rnorm1, batch 128) and does two
// n-term window sums. Design: a block stages a tile of whole rows in shared
// memory (x, then u, then g*d^-beta), with coalesced loads and stores. db
// must not cost another pass over dx and must come out the same on every
// run: each block walks a fixed, strided set of tiles and keeps per-channel
// sums of its tiles' f32 dx in shared memory, added in a fixed order; it
// writes one row of partial sums, and a second small kernel adds the rows
// in a fixed tree order. No float atomics.

#include "lrn_math.cuh"

namespace {

constexpr int kThreads = 256;
// f32 elements per staged tile: whole rows, at least one.
constexpr int kTileElems = 2048;
constexpr int kMaxSharedBytes = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const T* __restrict__ g, const T* __restrict__ z,
               const float* __restrict__ bias, T* __restrict__ dx,
               float* __restrict__ partial, int64_t m, int c, int rows_per_tile,
               int64_t tiles, int relu, int blocked, int n, float alpha, float beta,
               float coef, int q) {
  extern __shared__ float smem[];
  const int tile_cap = rows_per_tile * c;
  float* sx = smem;              // x = relu(z + b)
  float* su = sx + tile_cap;     // u = g * x * d^-(beta+1)
  float* sv = su + tile_cap;     // g * d^-beta, then the f32 dx
  float* sacc = sv + tile_cap;   // this block's db sums, (c,)
  const bool want_db = partial != nullptr;
  if (want_db) {
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) sacc[ch] = 0.0f;
  }
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * rows_per_tile;
    const int rows = static_cast<int>(min(static_cast<int64_t>(rows_per_tile), m - row0));
    const int elems = rows * c;
    const int64_t base = row0 * c;

    for (int i = threadIdx.x; i < elems; i += blockDim.x) {
      sx[i] = lrn_input(load_f32(z, base + i), bias, i % c, relu);
    }
    __syncthreads();

    for (int i = threadIdx.x; i < elems; i += blockDim.x) {
      const int r = i / c;
      const int ch = i - r * c;
      const float* row = sx + r * c;
      float pb, dpow;
      neg_pow_pair(lrn_d(row, ch, c, n, blocked, alpha), beta, q, &pb, &dpow);
      const float gv = load_f32(g, base + i);
      su[i] = gv * row[ch] * dpow;
      sv[i] = gv * pb;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < elems; i += blockDim.x) {
      const int r = i / c;
      const int ch = i - r * c;
      int lo, hi;
      lrn_window(ch, c, n, blocked, true, &lo, &hi);
      const float* urow = su + r * c;
      float t = 0.0f;
      for (int j = lo; j <= hi; ++j) t += urow[j];
      const float x = sx[i];
      float d = sv[i] - coef * x * t;
      // x > 0 exactly where z + b > 0 (a NaN fails both)
      if (relu && !(x > 0.0f)) d = 0.0f;
      store_f32(dx, base + i, d);
      if (want_db) sv[i] = d;
    }
    __syncthreads();

    if (want_db) {
      // the next tile writes sv only after its first barrier, which every
      // thread reaches after finishing this loop
      for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
        float acc = 0.0f;
        for (int r = 0; r < rows; ++r) acc += sv[r * c + ch];
        sacc[ch] += acc;
      }
    }
  }
  if (want_db) {
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      partial[static_cast<int64_t>(blockIdx.x) * c + ch] = sacc[ch];
    }
  }
}

}  // namespace

// g, z, dx: (m, c) contiguous, bf16 when is_bf16 else f32. bias: f32 (c,)
// or null; with a bias, db (c,) f32 and partial (max_blocks, c) f32 scratch
// must be given. coef = 2*alpha*beta, rounded once from the caller's double.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int cn_lrn_bwd(const void* g, const void* z, const void* bias, void* dx,
                          void* db, void* partial, int max_blocks, int64_t m, int c,
                          int is_bf16, int relu, int blocked, int n, float alpha,
                          float beta, float coef, int q, void* stream) {
  if (m <= 0 || c <= 0 || n <= 0 || max_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bias && (!db || !partial)) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_tile = c >= kTileElems ? 1 : kTileElems / c;
  const size_t smem = (3 * static_cast<size_t>(rows_per_tile) * c + c) * sizeof(float);
  const int64_t tiles = (m + rows_per_tile - 1) / rows_per_tile;
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(tiles < max_blocks ? tiles : max_blocks);
  const float* b = static_cast<const float*>(bias);
  float* part = bias ? static_cast<float*>(partial) : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    lrn_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(z), b,
        static_cast<__nv_bfloat16*>(dx), part, m, c, rows_per_tile, tiles, relu, blocked,
        n, alpha, beta, coef, q);
  } else {
    lrn_bwd_kernel<float><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(z), b,
        static_cast<float*>(dx), part, m, c, rows_per_tile, tiles, relu, blocked, n, alpha,
        beta, coef, q);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !bias) return static_cast<int>(err);
  db_reduce_kernel<<<c, kReduceThreads, 0, s>>>(part, static_cast<float*>(db), blocks, c);
  return static_cast<int>(cudaGetLastError());
}
