// Cross-map response normalization (LRN) forward, with the producing
// conv's bias and the ReLU optionally fused in.
//
// Replaces two TPU kernels of the JAX package, which compute one function
// in two TPU memory layouts:
//   convnet_tpu/ops/lrn.py:212 _lrn_fwd_kernel   (folded-2D, C-minor rows;
//                                                 AlexNet rnorm2, C=256)
//   convnet_tpu/ops/lrn.py:535 _lrn_fwd_kernel_r (batch-minor r2d form;
//                                                 AlexNet rnorm1, C=96)
// and the opt-in t-form convnet_tpu/ops/lrn.py:447 _lrn_fwd_kernel_t.
// This kernel computes the function, not either layout: it reads the
// channels_last bytes cuDNN's conv writes, M = B*H*W rows of C contiguous
// channels, so neither side of it needs a transpose.
//
//   x   = relu(z + b)                    (bias and relu optional)
//   s_i = sum over window(i) of x_j^2    window: [i - n/2, i + (n-1)/2]
//                                        clipped, or the size-n block of i
//   y   = x * (1 + alpha * s)^(-beta)
//
// Math is f32, in lrn_math.cuh; the output has the input's dtype (bf16 or
// f32). y is, bit for bit, lrn_y's: the fused LRN -> max pool kernels of
// pool_lrn.cu recompute it with lrn_y and must find the same maxima.
//
// Bound: device-memory bytes, with the instructions close behind. Per
// element it reads 2 bytes and writes 2 in bf16 (rnorm1, batch 128: 74 MB
// each way, 0.0444 ms at 3.35 TB/s; rnorm2 0.0285 ms), and does about 20
// instructions: the bias add and ReLU, a 5-term fma chain, one fma for d,
// rsqrt and an IEEE sqrt for d^-0.75 (two SFU operations), two multiplies
// and the conversions. The first version (one f32 tile a block staged in
// shared memory, 2-byte accesses, two integer divisions and a runtime
// window loop an element, the exponent's loops and the bias re-read per
// element) ran at 18% of the bytes bound.
//
// Design for Hopper:
// - Persistent grid: as many 256-thread blocks as fit on the card at once,
//   sized once per kernel by the occupancy API and cached; block k takes
//   passes k, k + grid, ... A pass is rpp whole rows.
// - Thread map of lrn_bwd.cu: a row is C / V chunks of V consecutive
//   channels (V = 8 in bf16, 4 in f32: 16-byte loads and stores); thread t
//   owns chunk t % chunks of row slot t / chunks in every pass, so there
//   is no division per element, and the bias values of its chunk and halo
//   are loaded into registers once.
// - Bytes in flight: each thread loads its chunk of the next pass before it
//   computes the current one (two 16-byte loads in flight a thread).
// - AlexNet's n = 5 and beta = 0.75 (q = 3) are template parameters: the
//   window sum is lrn_d_regs<5> over registers and d^-0.75 the unrolled
//   neg_pow_c<3>. The window's halo (n/2 channels each side) is loaded
//   with the chunk, from the neighbouring threads' bytes (L1 hits); halo
//   values by warp shuffles instead ran 1.4% to 2.0% slower. Other windows
//   and exponents, blocked windows and rows of more than 256 chunks take
//   the generic path (lrn_d_raw and neg_pow over the row in device memory,
//   L1-resident); rows whose bytes or pointers are not 16-byte aligned
//   take V = 1.

#include "lrn_math.cuh"

namespace {

constexpr int kThreads = 256;

// A thread's chunk of V channels and its halo, as loaded (raw T, converted
// to f32 where used): own at channels ch0 .. ch0 + V - 1, lo[B] before
// them and hi[A] after, 0 outside the row.
template <typename T, int V, int B, int A>
struct Chunk {
  alignas(16) T own[V];
  T lo[B];
  T hi[A];
};

template <typename T, int V, int B, int A>
__device__ __forceinline__ void load_chunk(const T* __restrict__ zrow, int ch0, int c,
                                           Chunk<T, V, B, A>& k) {
  if constexpr ((V * sizeof(T)) % 16 == 0) {
#pragma unroll
    for (int w = 0; w < V * static_cast<int>(sizeof(T)) / 16; ++w) {
      reinterpret_cast<uint4*>(k.own)[w] = reinterpret_cast<const uint4*>(zrow + ch0)[w];
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) k.own[v] = zrow[ch0 + v];
  }
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int j = ch0 - B + i;
    k.lo[i] = j >= 0 ? zrow[j] : T(0.0f);
  }
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const int j = ch0 + V + i;
    k.hi[i] = j < c ? zrow[j] : T(0.0f);
  }
}

// Register path: chunks of V channels, window N, exponent q = Q (N, Q > 0),
// sliding windows, at most kThreads chunks a row.
template <typename T, int V, int N, int Q>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_regs(const T* __restrict__ z, const float* __restrict__ bias, T* __restrict__ y,
             int64_t m, int c, int relu, float alpha) {
  constexpr int B = N / 2;        // the window's channels before its own
  constexpr int A = (N - 1) / 2;  // and after
  constexpr int W = V + N - 1;    // a chunk's window span
  static_assert(B > 0 && A > 0, "a window of at least 3 channels");
  const int chunks = c / V;
  const int rpp = kThreads / chunks;
  const int r0 = static_cast<int>(threadIdx.x) / chunks;
  const int ch0 = (static_cast<int>(threadIdx.x) - r0 * chunks) * V;
  if (r0 >= rpp) return;  // threads past rpp * chunks own no chunk
  const bool has_bias = bias != nullptr;
  float bw[W];  // the bias values of the chunk's window span
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int j = ch0 - B + i;
    bw[i] = has_bias && j >= 0 && j < c ? bias[j] : 0.0f;
  }
  const int64_t passes = (m + rpp - 1) / rpp;
  auto fetch = [&](int64_t p, Chunk<T, V, B, A>& k) {
    const int64_t row = p * rpp + r0;
    if (p < passes && row < m) load_chunk(z + row * c, ch0, c, k);
  };

  Chunk<T, V, B, A> cur, nxt;
  fetch(blockIdx.x, cur);
  for (int64_t p = blockIdx.x; p < passes; p += gridDim.x) {
    fetch(p + gridDim.x, nxt);  // in flight while this pass is computed
    const int64_t row = p * rpp + r0;
    if (row < m) {
      // x of channels ch0 - B .. ch0 + V - 1 + A; channels outside [0, c)
      // count as 0 (lrn_d_regs), whatever relu(b) would be
      float xw[W];
#pragma unroll
      for (int i = 0; i < B; ++i) {
        xw[i] = ch0 - B + i >= 0 ? lrn_input_b(load_f32(cur.lo, i), bw[i], has_bias, relu) : 0.0f;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        xw[B + v] = lrn_input_b(load_f32(cur.own, v), bw[B + v], has_bias, relu);
      }
#pragma unroll
      for (int i = 0; i < A; ++i) {
        xw[B + V + i] = ch0 + V + i < c
                            ? lrn_input_b(load_f32(cur.hi, i), bw[B + V + i], has_bias, relu)
                            : 0.0f;
      }
      float out[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        out[v] = __fmul_rn(xw[B + v], neg_pow_c<Q>(lrn_d_regs<N>(xw + v, alpha)));
      }
      store_vec<V>(y + row * c + ch0, out);
    }
    cur = nxt;
  }
}

// Generic path: any window and exponent, blocked windows, any row width;
// each channel's window read from the row in device memory (lrn_d_raw,
// lrn_d's chain), d^-beta by neg_pow.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_generic(const T* __restrict__ z, const float* __restrict__ bias, T* __restrict__ y,
                int64_t m, int c, int relu, int blocked, int n, float alpha, float beta, int q) {
  const int chunks = c / V;
  const int col_step = min(chunks, kThreads);
  const int rpp = kThreads / col_step;
  const int tid = static_cast<int>(threadIdx.x);
  const int r0 = tid / col_step;
  const int chunk0 = tid - r0 * col_step;
  if (r0 >= rpp) return;  // threads past rpp * chunks own no chunk
  for (int64_t p = blockIdx.x;; p += gridDim.x) {
    const int64_t row = p * rpp + r0;
    if (row >= m) break;
    const T* zrow = z + row * c;
    for (int cc = chunk0; cc < chunks; cc += col_step) {
      const int ch0 = cc * V;
      float zv[V], out[V];
      load_vec<V>(zrow + ch0, zv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float d = lrn_d_raw(zrow, ch0 + v, c, n, blocked, alpha, bias, relu);
        out[v] = lrn_y_from_d(lrn_input(zv[v], bias, ch0 + v, relu), d, beta, q);
      }
      store_vec<V>(y + row * c + ch0, out);
    }
  }
}

// Launch `kernel` on a persistent grid: as many blocks of kThreads as fit
// on the card at once, at most one a pass of rpp rows. The occupancy API is
// asked once per kernel (T, V, N, Q name it) and its answer cached; the grid
// only spreads the passes, so any size gives the same y.
template <typename T, int V, int N, int Q, typename Kernel, typename... Args>
int launch(Kernel kernel, int64_t m, int rpp, cudaStream_t s, Args... args) {
  static const int resident = [kernel] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
            cudaSuccess) {
      return 0;
    }
    return per_sm * sms;
  }();
  if (resident < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t passes = (m + rpp - 1) / rpp;
  kernel<<<static_cast<int>(passes < resident ? passes : resident), kThreads, 0, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The register path for AlexNet's sliding n = 5 and beta = 0.75 (q = 3)
// when a row is at most kThreads chunks, else the generic path; V = 16
// bytes of T when a row is a whole number of 16-byte words and both
// pointers are 16-byte aligned, else V = 1.
template <typename T>
int dispatch(const T* z, const float* bias, T* y, int64_t m, int c, int relu, int blocked,
             int n, float alpha, float beta, int q, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  const bool vec = (c * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int chunks = vec ? c / kV : c;
  const int rpp = chunks <= kThreads ? kThreads / chunks : 1;
  if (!blocked && n == 5 && q == 3 && chunks <= kThreads) {
    return vec ? launch<T, kV, 5, 3>(lrn_fwd_regs<T, kV, 5, 3>, m, rpp, s, z, bias, y, m, c,
                                     relu, alpha)
               : launch<T, 1, 5, 3>(lrn_fwd_regs<T, 1, 5, 3>, m, rpp, s, z, bias, y, m, c, relu,
                                    alpha);
  }
  return vec ? launch<T, kV, 0, 0>(lrn_fwd_generic<T, kV>, m, rpp, s, z, bias, y, m, c, relu,
                                   blocked, n, alpha, beta, q)
             : launch<T, 1, 0, 0>(lrn_fwd_generic<T, 1>, m, rpp, s, z, bias, y, m, c, relu,
                                  blocked, n, alpha, beta, q);
}

}  // namespace

// z, y: (m, c) contiguous, bf16 when is_bf16 else f32. bias: f32 (c,) or
// null. Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int cn_lrn_fwd(const void* z, const void* bias, void* y, int64_t m, int c,
                          int is_bf16, int relu, int blocked, int n, float alpha, float beta,
                          int q, void* stream) {
  if (m <= 0 || c <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch(static_cast<const __nv_bfloat16*>(z), b,
                            static_cast<__nv_bfloat16*>(y), m, c, relu, blocked, n, alpha, beta,
                            q, s)
                 : dispatch(static_cast<const float*>(z), b, static_cast<float*>(y), m, c, relu,
                            blocked, n, alpha, beta, q, s);
}
