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
// forward stores no residual beyond z. Math is f32 (lrn_math.cuh): d by
// lrn_fwd.cu's window chain, d^-beta and d^-(beta+1) from qr =
// sqrt(rsqrt(d)) raised by squaring (lrn.py:128 _neg_pow_pair) for
// quarter-integer beta, coef = 2*alpha*beta rounded once by the caller;
// dx has z's dtype. Its d is, bit for bit, the d of lrn_fwd.cu and of
// pool_lrn.cu's fused kernels (the same lrn_input and __fmaf_rn chain over
// ascending j), whose y the fused backward must reproduce to find ties;
// the register path (lrn_d_regs, lrn_input_b, neg_pow_pair_c) repeats
// those chains operation for operation.
//
// Bound: device-memory bytes. Per element it reads g and z and writes dx
// (2 bytes each in bf16: 222.9 MB at AlexNet rnorm1, batch 128, 0.0666 ms
// at 3.35 TB/s; rnorm2 0.0428 ms) and does two n-term window sums, with
// two SFU operations and about 60 other instructions an element.
//
// Design for Hopper:
// - Persistent grid: as many blocks as fit on the card at once (the
//   occupancy API times the SM count); block b takes tiles b, b + grid,
//   ... A tile is `tile_rows` whole rows, one contiguous byte range per
//   tensor, so a channel window never leaves it.
// - Double-buffered staging of the z tile and the g tile, in their own
//   dtype: right after the barrier that opens tile k every thread issues
//   16-byte cp.async.cg copies of tile k + 1 into the other buffers, so its
//   bytes are in flight while tile k is computed.
// - Thread map fixed per launch: a row is C / V chunks of V consecutive
//   channels (V = 8 in bf16, 4 in f32: 16-byte accesses). A block of
//   rows_per_pass * chunks threads gives each thread one chunk and row
//   slot, rows r0, r0 + rows_per_pass, ... of every tile: no division per
//   element. Rows of more than kThreads chunks take one row per pass, each
//   thread walking chunks t, t + kThreads, ...
// - Per tile a thread computes x, d, d^-beta, d^-(beta+1) and u = g x
//   d^-(beta+1) in registers for its V channels (the window's halo, n/2
//   channels each side, read from the staged row) and writes u and g
//   d^-beta to two f32 row buffers; after a barrier it reads the
//   transposed window of u, computes dx in registers and stores it with
//   16-byte stores. AlexNet's n = 5 and beta = 0.75 keep the windows in
//   registers, the bias values of the thread's chunk too, with the powers'
//   chains unrolled (N = 5, Q = 3); other windows and exponents take the
//   generic path (N = 0, Q = 0). Rows whose bytes or pointers are not
//   16-byte aligned take V = 1 and plain copies.
// - db, deterministic and without another pass: a thread owns the same
//   chunk of the same row slot in every tile, so it adds its f32 dx into V
//   sums of its own (registers, or shared memory when it walks several
//   chunks) in an order fixed by the launch geometry; the block then adds
//   its row slots in a fixed order into one partial row, and
//   db_reduce_kernel adds the blocks' rows in a fixed order. No atomics.

#include "lrn_math.cuh"
#include "stage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kStageBytes = 8 * 1024;  // one staged tile of one tensor

// Values of channels ch0 - B .. ch0 + V - 1 + A of a row into w[0 .. V +
// B + A): own[] for the thread's V channels, load(j) for the halo, 0
// outside [0, c).
template <int V, int B, int A, typename Load>
__device__ __forceinline__ void halo(int ch0, int c, const float* own, Load load, float* w) {
#pragma unroll
  for (int v = 0; v < V; ++v) w[B + v] = own[v];
#pragma unroll
  for (int i = 0; i < B; ++i) w[i] = ch0 - B + i >= 0 ? load(ch0 - B + i, i) : 0.0f;
#pragma unroll
  for (int i = 0; i < A; ++i) w[B + V + i] = ch0 + V + i < c ? load(ch0 + V + i, B + V + i) : 0.0f;
}

template <typename T, int V, int N, int Q>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const T* __restrict__ g, const T* __restrict__ z, const float* __restrict__ bias,
               T* __restrict__ dx, float* __restrict__ partial, int64_t m, int c, int tile_rows,
               int relu, int blocked, int n, float alpha, float beta, float coef, int q) {
  constexpr bool kVec = V * sizeof(T) == 16;
  constexpr int B = N / 2;         // the window's channels before its own (N > 0)
  constexpr int W = V + N - 1;     // a chunk's window span
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_elems = tile_rows * c;
  const size_t stage = align_up16(static_cast<size_t>(tile_elems) * sizeof(T));
  T* sz[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem + stage)};
  T* sg[2] = {reinterpret_cast<T*>(smem + 2 * stage), reinterpret_cast<T*>(smem + 3 * stage)};
  float* su = reinterpret_cast<float*>(smem + 4 * stage);  // u, (tile_rows, c)
  float* sv = su + tile_elems;                              // g * d^-beta
  float* sacc = sv + tile_elems;                            // db sums, (rows_per_pass, c)

  // the thread map (see the header comment)
  const int chunks = c / V;
  const int threads = static_cast<int>(blockDim.x);
  const int rpp = max(1, threads / chunks);
  const int col_step = min(chunks, threads);
  const int r0 = static_cast<int>(threadIdx.x) / chunks;
  const int chunk0 = static_cast<int>(threadIdx.x) % chunks;
  const bool one_chunk = col_step == chunks;  // the thread's chunk is chunk0 throughout

  const bool want_db = partial != nullptr;
  const bool has_bias = bias != nullptr;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  if (want_db && !one_chunk) {
    for (int i = threadIdx.x; i < c; i += blockDim.x) sacc[i] = 0.0f;  // rpp is 1
  }
  // the bias values of chunk bw_chunk's window span (N > 0)
  constexpr int kBw = N > 0 ? W : 1;
  float bw[kBw];
  int bw_chunk = -1;
  auto load_bias = [&](int cc) {
    if (cc == bw_chunk) return;
    bw_chunk = cc;
#pragma unroll
    for (int i = 0; i < kBw; ++i) {
      const int j = cc * V - B + i;
      bw[i] = has_bias && j >= 0 && j < c ? bias[j] : 0.0f;
    }
  };

  const int64_t tiles = (m + tile_rows - 1) / tile_rows;
  auto rows_of = [&](int64_t t) {
    return static_cast<int>(min(static_cast<int64_t>(tile_rows), m - t * tile_rows));
  };
  auto stage_tile = [&](int buf, int64_t t) {
    stage_rows<kVec>(sz[buf], z + t * tile_rows * c, rows_of(t) * c);
    stage_rows<kVec>(sg[buf], g + t * tile_rows * c, rows_of(t) * c);
  };

  int64_t tile = blockIdx.x;
  stage_tile(0, tile);
  for (int k = 0; tile < tiles; tile += gridDim.x, ++k) {
    cp_async_wait_all();
    __syncthreads();  // tile k staged; every thread is done with tile k - 1
    const int64_t next = tile + gridDim.x;
    if (next < tiles) stage_tile((k + 1) & 1, next);
    const T* zt = sz[k & 1];
    const T* gt = sg[k & 1];
    const int rows = rows_of(tile);

    // u and g * d^-beta of the thread's chunks, into su and sv
    for (int r = r0; r < rows; r += rpp) {
      const T* zrow = zt + r * c;
      for (int cc = chunk0; cc < chunks; cc += col_step) {
        const int ch0 = cc * V;
        float zv[V], gv[V], x[V], u[V], gpb[V];
        load_vec<V>(zrow + ch0, zv);
        load_vec<V>(gt + r * c + ch0, gv);
        if constexpr (N > 0) {
          load_bias(cc);
#pragma unroll
          for (int v = 0; v < V; ++v) x[v] = lrn_input_b(zv[v], bw[B + v], has_bias, relu);
          float xw[W];
          halo<V, B, (N - 1) / 2>(ch0, c, x, [&](int j, int i) {
            return lrn_input_b(load_f32(zrow, j), bw[i], has_bias, relu);
          }, xw);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            float pb, dpow;
            neg_pow_pair_c<Q>(lrn_d_regs<N>(xw + v, alpha), &pb, &dpow);
            u[v] = gv[v] * x[v] * dpow;
            gpb[v] = gv[v] * pb;
          }
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            x[v] = lrn_input(zv[v], bias, ch0 + v, relu);
            float pb, dpow;
            neg_pow_pair(lrn_d_raw(zrow, ch0 + v, c, n, blocked, alpha, bias, relu), beta, q,
                         &pb, &dpow);
            u[v] = gv[v] * x[v] * dpow;
            gpb[v] = gv[v] * pb;
          }
        }
        store_vec<V>(su + r * c + ch0, u);
        store_vec<V>(sv + r * c + ch0, gpb);
      }
    }
    __syncthreads();  // u of every channel of the tile written

    // dx from the transposed window of u
    for (int r = r0; r < rows; r += rpp) {
      const float* urow = su + r * c;
      for (int cc = chunk0; cc < chunks; cc += col_step) {
        const int ch0 = cc * V;
        float zv[V], gpb[V], t[V], out[V];
        load_vec<V>(zt + r * c + ch0, zv);
        load_vec<V>(sv + r * c + ch0, gpb);
        if constexpr (N > 0) {
          load_bias(cc);
          float own[V], uw[W];
          load_vec<V>(urow + ch0, own);
          halo<V, (N - 1) / 2, B>(ch0, c, own, [&](int j, int) { return urow[j]; }, uw);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            t[v] = 0.0f;
#pragma unroll
            for (int i = 0; i < N; ++i) t[v] += uw[v + i];
          }
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            int lo, hi;
            lrn_window(ch0 + v, c, n, blocked, true, &lo, &hi);
            t[v] = 0.0f;
            for (int j = lo; j <= hi; ++j) t[v] += urow[j];
          }
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float x;
          if constexpr (N > 0) {
            x = lrn_input_b(zv[v], bw[B + v], has_bias, relu);
          } else {
            x = lrn_input(zv[v], bias, ch0 + v, relu);
          }
          float dv = gpb[v] - coef * x * t[v];
          // x > 0 exactly where z + b > 0 (a NaN fails both)
          if (relu && !(x > 0.0f)) dv = 0.0f;
          out[v] = dv;
        }
        store_vec<V>(dx + (tile * tile_rows + r) * c + ch0, out);
        if (want_db) {
          if (one_chunk) {
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] += out[v];
          } else {
            float sum[V];
            load_vec<V>(sacc + ch0, sum);
#pragma unroll
            for (int v = 0; v < V; ++v) sum[v] += out[v];
            store_vec<V>(sacc + ch0, sum);
          }
        }
      }
    }
  }
  if (want_db) {
    if (one_chunk) store_vec<V>(sacc + r0 * c + chunk0 * V, acc);
    __syncthreads();
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      float s = 0.0f;
      for (int r = 0; r < rpp; ++r) s += sacc[r * c + ch];
      partial[static_cast<int64_t>(blockIdx.x) * c + ch] = s;
    }
  }
}

// Launch geometry: threads and rows per pass from the thread map, tile
// rows from kStageBytes, the grid from the occupancy API (capped at
// max_blocks, the rows of the caller's db scratch).
template <typename T, int V, int N, int Q>
int launch(const void* g, const void* z, const float* bias, void* dx, float* db, float* partial,
           int max_blocks, int64_t m, int c, int relu, int blocked, int n, float alpha,
           float beta, float coef, int q, cudaStream_t s) {
  auto kernel = lrn_bwd_kernel<T, V, N, Q>;
  const bool want_db = bias != nullptr;
  const int chunks = c / V;
  const int rpp = chunks <= kThreads ? kThreads / chunks : 1;
  const int threads = chunks <= kThreads ? rpp * chunks : kThreads;
  int passes = static_cast<int>(kStageBytes / (static_cast<size_t>(rpp) * c * sizeof(T)));
  if (passes < 1) passes = 1;
  const int64_t tall = (m + rpp - 1) / rpp * rpp;  // no taller tile than M needs
  const int tile_rows = static_cast<int>(static_cast<int64_t>(rpp) * passes < tall
                                             ? static_cast<int64_t>(rpp) * passes : tall);
  const size_t elems = static_cast<size_t>(tile_rows) * c;
  const size_t smem = 4 * align_up16(elems * sizeof(T)) + 2 * elems * sizeof(float) +
                      (want_db ? static_cast<size_t>(rpp) * c * sizeof(float) : 0);
  if (smem > static_cast<size_t>(kMaxSmemPerBlock)) return static_cast<int>(cudaErrorInvalidValue);
  // once per process: allow the dynamic shared memory and ask for the
  // largest shared-memory carveout, so the occupancy below holds
  static const cudaError_t configured = [&] {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kMaxSmemPerBlock);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (m + tile_rows - 1) / tile_rows;
  int64_t blocks = static_cast<int64_t>(per_sm) * sms;
  if (blocks > tiles) blocks = tiles;
  if (blocks > max_blocks) blocks = max_blocks;
  kernel<<<static_cast<int>(blocks), threads, smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(z), bias, static_cast<T*>(dx),
      want_db ? partial : nullptr, m, c, tile_rows, relu, blocked, n, alpha, beta, coef, q);
  err = cudaGetLastError();
  if (err != cudaSuccess || !want_db) return static_cast<int>(err);
  db_reduce_kernel<<<c, kReduceThreads, 0, s>>>(partial, db, static_cast<int>(blocks), c);
  return static_cast<int>(cudaGetLastError());
}

// The vector path when a row is a whole number of 16-byte words and the
// three tensors are 16-byte aligned; the register path for AlexNet's
// sliding n = 5 and beta = 0.75 (q = 3).
template <typename T>
int dispatch(const void* g, const void* z, const float* bias, void* dx, float* db,
             float* partial, int max_blocks, int64_t m, int c, int relu, int blocked, int n,
             float alpha, float beta, float coef, int q, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  const bool vec = (c * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const bool alexnet = !blocked && n == 5 && q == 3;
  auto run = [&](auto kernel_launch) {
    return kernel_launch(g, z, bias, dx, db, partial, max_blocks, m, c, relu, blocked, n, alpha,
                         beta, coef, q, s);
  };
  if (vec) return alexnet ? run(launch<T, kV, 5, 3>) : run(launch<T, kV, 0, 0>);
  return alexnet ? run(launch<T, 1, 5, 3>) : run(launch<T, 1, 0, 0>);
}

}  // namespace

// g, z, dx: (m, c) contiguous, bf16 when is_bf16 else f32. bias: f32 (c,)
// or null; with a bias, db (c,) f32 and partial (max_blocks, c) f32 scratch
// must be given: the persistent grid is capped at max_blocks, so each
// block's partial row fits. coef = 2*alpha*beta, rounded once from the
// caller's double. Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int cn_lrn_bwd(const void* g, const void* z, const void* bias, void* dx,
                          void* db, void* partial, int max_blocks, int64_t m, int c,
                          int is_bf16, int relu, int blocked, int n, float alpha,
                          float beta, float coef, int q, void* stream) {
  if (m <= 0 || c <= 0 || n <= 0 || max_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bias && (!db || !partial)) return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  float* dbf = static_cast<float*>(db);
  float* part = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(g, z, b, dx, dbf, part, max_blocks, m, c, relu,
                                           blocked, n, alpha, beta, coef, q, s)
                 : dispatch<float>(g, z, b, dx, dbf, part, max_blocks, m, c, relu, blocked, n,
                                   alpha, beta, coef, q, s);
}
