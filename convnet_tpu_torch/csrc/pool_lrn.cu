// Response norm (LRN, with the producing conv's bias and the ReLU
// optionally fused) followed by a max pool, forward and backward, with the
// LRN output y kept out of device memory in both directions.
//
// Replaces the TPU kernels of convnet_tpu/ops/fused_pool_lrn.py:
//   :388 _fused_fwd_kernel (launched at :480)  m = maxpool(LRN(relu(z + b)))
//   :134 _fused_bwd_kernel (launched at :340)  pool-undo + LRN backward + db
// The pool has padding 0 and cuda-convnet's ceil-mode geometry (taps past
// the bottom or right edge are ignored). Its gradient is upstream
// cuda-convnet's MaxPoolUndo: every input whose y EQUALS its window's max
// receives that window's cotangent (ties credit all winners), not one
// winner as the unfused path's ATen backward does.
//
// The backward recomputes y from z and compares it with the stored maxima,
// so its y must be the forward's bit for bit: both take it from lrn_y /
// lrn_y_from_d in lrn_math.cuh, whose chain lrn_fwd.cu repeats operation
// for operation. m from the forward is therefore exactly
// maxpool(lrn_fwd(z)).
//
// Bound: device-memory bytes. At AlexNet, batch 128, bf16, the forward
// moves z once in and m once out (rnorm1 (128,55,55,96): 74.3 + 17.9 MB,
// about 27 us at 3.35 TB/s; rnorm2 (128,27,27,256): 47.8 + 11.1 MB, about
// 18 us), the backward g and m in, z in and dz out (rnorm1 2 x 17.9 +
// 2 x 74.3 MB, about 55 us; rnorm2 2 x 11.1 + 2 x 47.8 MB, about 35 us).
//
// Design, forward: a block owns a run of output columns of one output row
// and walks the k input rows under it; for each it stages the input
// columns its windows cover (f32, after bias and ReLU) in shared memory,
// computes y per tap from the staged channel window, and keeps the running
// maxima of its outputs in shared memory. Overlapping windows recompute
// the y of shared taps (k/s times per element) rather than store it.
// Backward: a block walks a fixed strided set of tiles, each a run of
// positions of one input row; per element it recomputes d and y, sums the
// cotangents g of every covering window whose stored max equals y (read
// from device memory, where g and m are small and L2-resident), then runs
// the LRN backward on that f32 sum in shared memory (the scheme of
// lrn_bwd.cu) and writes dz. db: each block sums its tiles' f32 dz per
// channel in a fixed order into one partial row; db_reduce_kernel adds the
// rows in a fixed order, so db is the same on every run.

#include <math_constants.h>

#include "lrn_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedBytes = 48 * 1024;

struct Geometry {
  int b, h, w, c, oh, ow, k, s;
};

struct Lrn {
  int relu, blocked, n, q;
  float alpha, beta;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_lrn_fwd_kernel(const T* __restrict__ z, const float* __restrict__ bias, T* __restrict__ m,
                    Geometry g, Lrn p, int ow_tile, int chunks) {
  extern __shared__ float smem[];
  const int max_cols = g.s * (ow_tile - 1) + g.k;
  float* sx = smem;                        // staged x, (max_cols, c)
  float* sacc = sx + max_cols * g.c;       // running maxima, (ow_tile, c)
  const int chunk = blockIdx.x % chunks;
  const int oi = (blockIdx.x / chunks) % g.oh;
  const int64_t bi = blockIdx.x / (chunks * g.oh);
  const int ow0 = chunk * ow_tile;
  const int nout = min(ow_tile, g.ow - ow0);
  if (nout <= 0) return;  // uniform across the block
  const int col0 = g.s * ow0;
  const int ncols = min(g.w, g.s * (ow0 + nout - 1) + g.k) - col0;
  const int outs = nout * g.c;

  for (int v = 0; v < g.k; ++v) {
    const int r = oi * g.s + v;
    if (r >= g.h) break;  // the ceil-mode overhang: no taps
    const int64_t base = ((bi * g.h + r) * g.w + col0) * g.c;
    if (v) __syncthreads();  // the previous row's taps are read
    for (int i = threadIdx.x; i < ncols * g.c; i += blockDim.x) {
      sx[i] = lrn_input(load_f32(z, base + i), bias, i % g.c, p.relu);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < outs; e += blockDim.x) {
      const int j = e / g.c;
      const int ch = e - j * g.c;
      float cur = -CUDART_INF_F;
      for (int t = 0; t < g.k; ++t) {
        const int col = g.s * j + t;  // relative to col0
        if (col >= ncols) break;
        const float y = round_to(
            lrn_y(sx + col * g.c, ch, g.c, p.n, p.blocked, p.alpha, p.beta, p.q), z);
        // the first of equal maxima, a NaN kept: ATen's max pool scan
        if (y > cur || y != y) cur = y;
      }
      if (v == 0 || cur > sacc[e] || cur != cur) sacc[e] = cur;
    }
  }
  const int64_t out0 = ((bi * g.oh + oi) * g.ow + ow0) * g.c;
  for (int e = threadIdx.x; e < outs; e += blockDim.x) store_f32(m, out0 + e, sacc[e]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_lrn_bwd_kernel(const T* __restrict__ gm, const T* __restrict__ m, const T* __restrict__ z,
                    const float* __restrict__ bias, T* __restrict__ dz,
                    float* __restrict__ partial, Geometry g, Lrn p, float coef, int tile_w,
                    int chunks, int64_t tiles) {
  extern __shared__ float smem[];
  const int cap = tile_w * g.c;
  float* sx = smem;         // x = relu(z + b)
  float* su = sx + cap;     // u = glrn * x * d^-(beta+1)
  float* sv = su + cap;     // glrn * d^-beta, then the f32 dz
  float* sacc = sv + cap;   // this block's db sums, (c,)
  const bool want_db = partial != nullptr;
  if (want_db) {
    for (int ch = threadIdx.x; ch < g.c; ch += blockDim.x) sacc[ch] = 0.0f;
  }
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int chunk = static_cast<int>(tile % chunks);
    const int r = static_cast<int>((tile / chunks) % g.h);
    const int64_t bi = tile / (static_cast<int64_t>(chunks) * g.h);
    const int w0 = chunk * tile_w;
    const int npos = min(tile_w, g.w - w0);
    const int elems = npos * g.c;
    const int64_t base = ((bi * g.h + r) * g.w + w0) * g.c;
    // the output rows whose windows hold input row r
    const int lo_r = r - g.k + 1;
    const int oi_lo = lo_r <= 0 ? 0 : (lo_r + g.s - 1) / g.s;
    const int oi_hi = min(g.oh - 1, r / g.s);

    for (int i = threadIdx.x; i < elems; i += blockDim.x) {
      sx[i] = lrn_input(load_f32(z, base + i), bias, i % g.c, p.relu);
    }
    __syncthreads();

    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int pos = e / g.c;
      const int ch = e - pos * g.c;
      const float* row = sx + pos * g.c;
      const float d = lrn_d(row, ch, g.c, p.n, p.blocked, p.alpha);
      const float y = round_to(lrn_y_from_d(row[ch], d, p.beta, p.q), z);
      // pool-undo, comparison form: the cotangent of every covering window
      // whose max equals y
      const int col = w0 + pos;
      const int lo_c = col - g.k + 1;
      const int oj_lo = lo_c <= 0 ? 0 : (lo_c + g.s - 1) / g.s;
      const int oj_hi = min(g.ow - 1, col / g.s);
      float glrn = 0.0f;
      for (int oi = oi_lo; oi <= oi_hi; ++oi) {
        for (int oj = oj_lo; oj <= oj_hi; ++oj) {
          const int64_t o = ((bi * g.oh + oi) * g.ow + oj) * g.c + ch;
          if (load_f32(m, o) == y) glrn += load_f32(gm, o);
        }
      }
      float pb, dpow;
      neg_pow_pair(d, p.beta, p.q, &pb, &dpow);
      su[e] = glrn * row[ch] * dpow;
      sv[e] = glrn * pb;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int pos = e / g.c;
      const int ch = e - pos * g.c;
      int lo, hi;
      lrn_window(ch, g.c, p.n, p.blocked, true, &lo, &hi);
      const float* urow = su + pos * g.c;
      float t = 0.0f;
      for (int j = lo; j <= hi; ++j) t += urow[j];
      const float x = sx[e];
      float dv = sv[e] - coef * x * t;
      // x > 0 exactly where z + b > 0 (a NaN fails both)
      if (p.relu && !(x > 0.0f)) dv = 0.0f;
      store_f32(dz, base + e, dv);
      if (want_db) sv[e] = dv;
    }
    __syncthreads();

    if (want_db) {
      // the next tile writes sv only after its first barrier, which every
      // thread reaches after finishing this loop
      for (int ch = threadIdx.x; ch < g.c; ch += blockDim.x) {
        float acc = 0.0f;
        for (int pos = 0; pos < npos; ++pos) acc += sv[pos * g.c + ch];
        sacc[ch] += acc;
      }
    }
  }
  if (want_db) {
    for (int ch = threadIdx.x; ch < g.c; ch += blockDim.x) {
      partial[static_cast<int64_t>(blockIdx.x) * g.c + ch] = sacc[ch];
    }
  }
}

// Split `count` items into the fewest equal runs of at most `most`:
// returns the run length, and the number of runs in *runs.
int split(int count, int most, int* runs) {
  *runs = (count + most - 1) / most;
  return (count + *runs - 1) / *runs;
}

bool valid(const Geometry& g, const Lrn& p) {
  return g.b > 0 && g.h > 0 && g.w > 0 && g.c > 0 && g.k > 0 && g.s > 0 && g.oh > 0 &&
         g.ow > 0 && p.n > 0 && g.s * (g.oh - 1) < g.h && g.s * (g.ow - 1) < g.w;
}

}  // namespace

// z: (b, h, w, c); m: (b, oh, ow, c); contiguous, bf16 when is_bf16 else
// f32. bias: f32 (c,) or null. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int cn_pool_lrn_fwd(const void* z, const void* bias, void* m, int b, int h, int w,
                               int c, int oh, int ow, int k, int s, int is_bf16, int relu,
                               int blocked, int n, float alpha, float beta, int q,
                               void* stream) {
  const Geometry g{b, h, w, c, oh, ow, k, s};
  const Lrn p{relu, blocked, n, q, alpha, beta};
  if (!valid(g, p)) return static_cast<int>(cudaErrorInvalidValue);
  // about 4096 staged x values a block: (s * (tile - 1) + k) columns
  const int most = max(1, (max(4096 / c, k) - k) / s + 1);
  int chunks;
  const int ow_tile = split(ow, most, &chunks);
  const size_t smem =
      (static_cast<size_t>(s * (ow_tile - 1) + k) * c + static_cast<size_t>(ow_tile) * c) *
      sizeof(float);
  const int64_t blocks = static_cast<int64_t>(b) * oh * chunks;
  if (smem > kMaxSharedBytes || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bs = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    pool_lrn_fwd_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(z), bs, static_cast<__nv_bfloat16*>(m), g, p,
        ow_tile, chunks);
  } else {
    pool_lrn_fwd_kernel<float><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
        static_cast<const float*>(z), bs, static_cast<float*>(m), g, p, ow_tile, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// g, m: (b, oh, ow, c); z, dz: (b, h, w, c); contiguous, bf16 when is_bf16
// else f32. bias: f32 (c,) or null; with a bias, db (c,) f32 and partial
// (max_blocks, c) f32 scratch must be given. coef = 2*alpha*beta, rounded
// once from the caller's double. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int cn_pool_lrn_bwd(const void* gm, const void* m, const void* z, const void* bias,
                               void* dz, void* db, void* partial, int max_blocks, int b, int h,
                               int w, int c, int oh, int ow, int k, int s, int is_bf16,
                               int relu, int blocked, int n, float alpha, float beta,
                               float coef, int q, void* stream) {
  const Geometry g{b, h, w, c, oh, ow, k, s};
  const Lrn p{relu, blocked, n, q, alpha, beta};
  if (!valid(g, p) || max_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bias && (!db || !partial)) return static_cast<int>(cudaErrorInvalidValue);
  // about 2048 f32 values per staged buffer, whole positions
  int chunks;
  const int tile_w = split(w, max(1, 2048 / c), &chunks);
  const size_t smem = (3 * static_cast<size_t>(tile_w) * c + c) * sizeof(float);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = static_cast<int64_t>(b) * h * chunks;
  const int blocks = static_cast<int>(tiles < max_blocks ? tiles : max_blocks);
  const float* bs = static_cast<const float*>(bias);
  float* part = bias ? static_cast<float*>(partial) : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    pool_lrn_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(gm), static_cast<const __nv_bfloat16*>(m),
        static_cast<const __nv_bfloat16*>(z), bs, static_cast<__nv_bfloat16*>(dz), part, g, p,
        coef, tile_w, chunks, tiles);
  } else {
    pool_lrn_bwd_kernel<float><<<blocks, kThreads, smem, st>>>(
        static_cast<const float*>(gm), static_cast<const float*>(m),
        static_cast<const float*>(z), bs, static_cast<float*>(dz), part, g, p, coef, tile_w,
        chunks, tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !bias) return static_cast<int>(err);
  db_reduce_kernel<<<c, kReduceThreads, 0, st>>>(part, static_cast<float*>(db), blocks, c);
  return static_cast<int>(cudaGetLastError());
}
