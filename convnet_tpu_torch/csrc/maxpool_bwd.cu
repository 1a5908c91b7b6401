// Max pooling backward over NHWC activations: dx from dy and the forward's
// taps (csrc/maxpool_fwd.cu), in cuda-convnet's ceil-mode geometry. Each
// window's gradient goes to the one input its scan kept (XLA's
// select-and-scatter and ATen's max-pool backward credit one winner too).
//
// Replaces ATen's max_pool_backward_nhwc on the train path; the TPU's
// backward of convnet_tpu/ops/pool.py:87 _maxpool_kernel is XLA's
// select-and-scatter (pool.py:173-181), with no Pallas kernel of its own.
// ATen reads an int64 index an output value and zero-fills dx before it
// scatters; here the index is the forward's one-byte tap and dx is written
// once, so dy and the taps are read and dx written, and nothing else.
//
// Bound: device-memory bytes. At AlexNet's pools, batch 128, bf16, the
// function moves 2 bytes of dy and 1 of taps an output value and 2 of dx
// an input value: 101.2 MB (pool1), 64.4 MB (pool2) and 14.6 MB (pool5),
// 30, 19 and 4 us at 3.35 TB/s.
//
// Design:
// - Gather, not scatter: a thread owns one word of dx channels, 16 bytes
//   (8 bf16 or 4 f32 values) when the channel row is a whole number of
//   16-byte words and the tensors are aligned, else one value, as the
//   forward, at the input positions of a tile. It reads the dy word and
//   the taps of each window that covers the tile and adds dy where the tap
//   names a position. No zero fill, no atomics, one write; deterministic.
//   Neighbouring threads read neighbouring words.
// - At s = 2 and k = 3 or 2 (every pool of the example models) the tile is
//   2 x 2 positions, with the window geometry compiled (maxpool_bwd_tiles):
//   at k = 3 a tile's 4 windows serve its 4 positions, where one thread a
//   position would read 9, and each tap's position is a constant. Measured
//   at batch 1024 on an NVIDIA H100 80GB HBM3: a thread a position took
//   1.33 ms a step for AlexNet's three pools, a third of the bound.
// - Other geometries take one position a thread (maxpool_bwd_kernel): the
//   windows of a column from one division at thread start, those of a row
//   from one a row of the block's y loop.
// - Sums as ATen's max_pool_backward_nhwc takes them, so dx is its bits:
//   in f32 from +0, windows in order of output row and then column, rounded
//   once to the dtype; and where one window alone covers a position, dy's
//   bits or +0, as ATen copies them there (so -0 stays -0).
// - The taps are compared four a 32-bit word (__vcmpeq4), and each hit
//   byte widened to a bit mask over its dy value (__byte_perm): the
//   masked word is dy where the tap names this position, else +0.
// The result equals the plain version (convnet_tpu_torch/ops/pool.py:
// maxpool_bwd_reference) bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dtype.cuh"

namespace {

constexpr int kMaxThreads = 512;

// N 32-bit words of raw bits: N = 4 is a 16-byte word of channels; N = 1
// one value (a bf16 value in the low half, +0 in the high half).
template <int N>
struct Word {
  uint32_t v[N];
};

// The pointer type a word is loaded through.
template <typename T, int N>
struct Access;
template <typename T>
struct Access<T, 4> {
  using type = uint4;
};
template <>
struct Access<float, 1> {
  using type = unsigned int;
};
template <>
struct Access<__nv_bfloat16, 1> {
  using type = unsigned short;
};

template <typename T, int N>
__device__ __forceinline__ Word<N> load_word(const typename Access<T, N>::type* p) {
  Word<N> out;
  if constexpr (N == 4) {
    const uint4 raw = __ldg(p);
    out.v[0] = raw.x, out.v[1] = raw.y, out.v[2] = raw.z, out.v[3] = raw.w;
  } else {
    out.v[0] = __ldg(p);
  }
  return out;
}

template <typename T, int N>
__device__ __forceinline__ void store_word(typename Access<T, N>::type* p, const Word<N>& w) {
  if constexpr (N == 4) {
    *p = make_uint4(w.v[0], w.v[1], w.v[2], w.v[3]);
  } else if constexpr (sizeof(T) == 2) {
    *p = static_cast<unsigned short>(w.v[0]);
  } else {
    *p = w.v[0];
  }
}

// A word's taps: one byte a value, four to a 32-bit word (N = 4: bf16 two
// words, f32 one); N = 1 the tap itself.
template <typename T, int N>
struct Taps {
  static constexpr int kWords = N == 1 ? 1 : N / static_cast<int>(sizeof(T));
  uint32_t v[kWords];
};

template <typename T, int N, typename Ix>
__device__ __forceinline__ Taps<T, N> load_taps(const Ix* p) {
  Taps<T, N> out;
  if constexpr (N == 1) {
    out.v[0] = static_cast<uint32_t>(__ldg(p));
  } else if constexpr (sizeof(T) == 2) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    out.v[0] = raw.x, out.v[1] = raw.y;
  } else {
    out.v[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  return out;
}

// 0xff in each byte of the taps equal to tap (N = 1: all ones or 0).
template <typename T, int N>
__device__ __forceinline__ Taps<T, N> hits(const Taps<T, N>& t, int tap) {
  Taps<T, N> out;
#pragma unroll
  for (int w = 0; w < Taps<T, N>::kWords; ++w) {
    out.v[w] = N == 1 ? (t.v[w] == static_cast<uint32_t>(tap) ? ~0u : 0u)
                      : __vcmpeq4(t.v[w], static_cast<uint32_t>(tap) * 0x01010101u);
  }
  return out;
}

// The bits of dy word i that hit: each value's hit byte over its bits.
template <typename T, int N>
__device__ __forceinline__ uint32_t hit_mask(const Taps<T, N>& h, int i) {
  if constexpr (N == 1) {
    return h.v[0];
  } else if constexpr (sizeof(T) == 2) {
    return __byte_perm(h.v[i / 2], 0, i % 2 ? 0x3322 : 0x1100);
  } else {
    return __byte_perm(h.v[0], 0, 0x1111 * i);
  }
}

// The bits of dy word i (its hit values, else +0) as f32 values, added to
// acc (kValues of them).
template <typename T, int N>
__device__ __forceinline__ void add_hits(float* acc, uint32_t m, int i) {
  if constexpr (sizeof(T) == 2) {
    acc[2 * i] += __uint_as_float(m << 16);
    if constexpr (N > 1) acc[2 * i + 1] += __uint_as_float(m & 0xffff0000u);
  } else {
    acc[i] += __uint_as_float(m);
  }
}

// acc rounded to T as a word.
template <typename T, int N>
__device__ __forceinline__ Word<N> pack(const float* acc) {
  Word<N> out;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (sizeof(T) == 2) {
      out.v[i] = N > 1 ? pack_bf16x2(acc[2 * i], acc[2 * i + 1]) : pack_bf16x2(acc[0], 0.0f);
    } else {
      out.v[i] = __float_as_uint(acc[i]);
    }
  }
  return out;
}

struct Geometry {
  int b, h, w, cu, oh, ow, k, s, pad;
};

// Block: (ix, word) pairs of one input row of one image; blockIdx.y over
// (image, input row). dy: (b, oh, ow, cu) words; taps: (b, oh, ow, cu *
// values a word); dx: (b, h, w, cu) words.
template <typename T, int N, typename Ix>
__global__ void __launch_bounds__(kMaxThreads)
maxpool_bwd_kernel(const typename Access<T, N>::type* __restrict__ dy,
                   const Ix* __restrict__ taps, typename Access<T, N>::type* __restrict__ dx,
                   Geometry g) {
  constexpr int kValues = N == 1 ? 1 : 16 / static_cast<int>(sizeof(T));
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g.w * g.cu) return;
  const int ix = t / g.cu;
  const int u = t - ix * g.cu;
  // the windows [ox0, ox1) whose columns hold input column ix (cw padded)
  const int cw = ix + g.pad;
  const int ox0 = cw < g.k ? 0 : (cw - g.k) / g.s + 1;
  const int ox1 = min(cw / g.s + 1, g.ow);
  for (int by = blockIdx.y; by < g.b * g.h; by += gridDim.y) {
    const int img = by / g.h;
    const int ch = by - img * g.h + g.pad;
    const int oy0 = ch < g.k ? 0 : (ch - g.k) / g.s + 1;
    const int oy1 = min(ch / g.s + 1, g.oh);
    const int64_t rows = static_cast<int64_t>(img) * g.oh;
    Word<N> out;
    if (oy1 - oy0 == 1 && ox1 - ox0 == 1) {
      const int64_t word = ((rows + oy0) * g.ow + ox0) * g.cu + u;
      const Word<N> d = load_word<T, N>(dy + word);
      const Taps<T, N> h = hits<T, N>(load_taps<T, N>(taps + word * kValues),
                                      (ch - oy0 * g.s) * g.k + cw - ox0 * g.s);
#pragma unroll
      for (int i = 0; i < N; ++i) out.v[i] = d.v[i] & hit_mask<T, N>(h, i);
    } else {
      float acc[kValues];
#pragma unroll
      for (int v = 0; v < kValues; ++v) acc[v] = 0.0f;
      for (int oy = oy0; oy < oy1; ++oy) {
        for (int ox = ox0; ox < ox1; ++ox) {
          const int64_t word = ((rows + oy) * g.ow + ox) * g.cu + u;
          const Word<N> d = load_word<T, N>(dy + word);
          const Taps<T, N> h = hits<T, N>(load_taps<T, N>(taps + word * kValues),
                                          (ch - oy * g.s) * g.k + cw - ox * g.s);
#pragma unroll
          for (int i = 0; i < N; ++i) add_hits<T, N>(acc, d.v[i] & hit_mask<T, N>(h, i), i);
        }
      }
      out = pack<T, N>(acc);
    }
    store_word<T, N>(dx + (static_cast<int64_t>(by) * g.w + ix) * g.cu + u, out);
  }
}

// The compiled geometries (k = 3 and 2 at s = 2: AlexNet's, cifar10's and
// mnist_lenet's pools): a thread owns an S x S tile of padded input
// positions (rows S*ta .. S*ta + S - 1, columns alike) for one word. The
// windows over the tile are oy = ta - kBack .. ta and ox alike, (kBack +
// 1)^2 of them (4 at k = 3, 1 at k = 2), each read once for the S^2
// positions, where one thread a position reads about 2.25 at k = 3. A
// position's tap in a window is a compile-time constant, so the visits
// unroll without bounds tests; windows are taken in order of row, then
// column, as ATen sums them. Positions that lie in the padding are not
// written.
template <typename T, int N, typename Ix, int K, int S>
__global__ void __launch_bounds__(kMaxThreads)
maxpool_bwd_tiles(const typename Access<T, N>::type* __restrict__ dy,
                  const Ix* __restrict__ taps, typename Access<T, N>::type* __restrict__ dx,
                  Geometry g, int tiles_h, int tiles_w) {
  constexpr int kValues = N == 1 ? 1 : 16 / static_cast<int>(sizeof(T));
  constexpr int kBack = (K - 1) / S;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= tiles_w * g.cu) return;
  const int tb = t / g.cu;
  const int u = t - tb * g.cu;
  for (int by = blockIdx.y; by < g.b * tiles_h; by += gridDim.y) {
    const int img = by / tiles_h;
    const int ta = by - img * tiles_h;
    float acc[S][S][kValues];
    Word<N> one[S][S];  // dy's bits where a single window covers the position
    int visits[S][S];
#pragma unroll
    for (int dr = 0; dr < S; ++dr) {
#pragma unroll
      for (int dc = 0; dc < S; ++dc) {
        visits[dr][dc] = 0;
#pragma unroll
        for (int v = 0; v < kValues; ++v) acc[dr][dc][v] = 0.0f;
#pragma unroll
        for (int i = 0; i < N; ++i) one[dr][dc].v[i] = 0u;
      }
    }
#pragma unroll
    for (int i = 0; i <= kBack; ++i) {
      const int oy = ta - kBack + i;
      if (oy < 0 || oy >= g.oh) continue;
#pragma unroll
      for (int j = 0; j <= kBack; ++j) {
        const int ox = tb - kBack + j;
        if (ox < 0 || ox >= g.ow) continue;
        const int64_t word = ((static_cast<int64_t>(img) * g.oh + oy) * g.ow + ox) * g.cu + u;
        const Word<N> d = load_word<T, N>(dy + word);
        const Taps<T, N> tp = load_taps<T, N>(taps + word * kValues);
#pragma unroll
        for (int dr = 0; dr < S; ++dr) {
          constexpr int kRow0 = S * kBack;
          const int tr = kRow0 - S * i + dr;  // compile-time after unrolling
          if (tr >= K) continue;
#pragma unroll
          for (int dc = 0; dc < S; ++dc) {
            const int tc = kRow0 - S * j + dc;
            if (tc >= K) continue;
            const Taps<T, N> h = hits<T, N>(tp, tr * K + tc);
            ++visits[dr][dc];
#pragma unroll
            for (int q = 0; q < N; ++q) {
              const uint32_t m = d.v[q] & hit_mask<T, N>(h, q);
              one[dr][dc].v[q] |= m;
              add_hits<T, N>(acc[dr][dc], m, q);
            }
          }
        }
      }
    }
#pragma unroll
    for (int dr = 0; dr < S; ++dr) {
      const int r = S * ta + dr - g.pad;
      if (r < 0 || r >= g.h) continue;
#pragma unroll
      for (int dc = 0; dc < S; ++dc) {
        const int c = S * tb + dc - g.pad;
        if (c < 0 || c >= g.w) continue;
        const Word<N> out = visits[dr][dc] == 1 ? one[dr][dc] : pack<T, N>(acc[dr][dc]);
        store_word<T, N>(dx + ((static_cast<int64_t>(img) * g.h + r) * g.w + c) * g.cu + u, out);
      }
    }
  }
}

template <typename T, int N, typename Ix>
int launch_n(const void* dy, const void* taps, void* dx, const Geometry& g, cudaStream_t st) {
  using A = typename Access<T, N>::type;
  const auto* d = static_cast<const A*>(dy);
  const auto* t = static_cast<const Ix*>(taps);
  auto* o = static_cast<A*>(dx);
  // tiles of s x s positions where the geometry is compiled, else one
  const bool tiled = g.s == 2 && (g.k == 2 || g.k == 3);
  const int tiles_h = tiled ? (g.h + g.pad + 1) / 2 : g.h;
  const int tiles_w = tiled ? (g.w + g.pad + 1) / 2 : g.w;
  const int cols = tiles_w * g.cu;
  const int blocks_x = (cols + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((cols + blocks_x - 1) / blocks_x + 31) / 32 * 32;
  const int64_t rows = static_cast<int64_t>(g.b) * tiles_h;
  const dim3 grid(blocks_x, static_cast<unsigned>(rows < 65535 ? rows : 65535));
  if (tiled && g.k == 3) {
    maxpool_bwd_tiles<T, N, Ix, 3, 2><<<grid, threads, 0, st>>>(d, t, o, g, tiles_h, tiles_w);
  } else if (tiled) {
    maxpool_bwd_tiles<T, N, Ix, 2, 2><<<grid, threads, 0, st>>>(d, t, o, g, tiles_h, tiles_w);
  } else {
    maxpool_bwd_kernel<T, N, Ix><<<grid, threads, 0, st>>>(d, t, o, g);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* dy, const void* taps, void* dx, Geometry g, cudaStream_t st) {
  const bool byte_taps = g.k * g.k <= 256;
  const bool vec = byte_taps && (static_cast<int64_t>(g.cu) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(taps) % (16 / sizeof(T)) == 0;
  if (vec) {
    g.cu = static_cast<int>(g.cu * sizeof(T) / 16);
    return launch_n<T, 4, uint8_t>(dy, taps, dx, g, st);
  }
  return byte_taps ? launch_n<T, 1, uint8_t>(dy, taps, dx, g, st)
                   : launch_n<T, 1, int32_t>(dy, taps, dx, g, st);
}

}  // namespace

// dy: (b, oh, ow, c) contiguous; taps: (b, oh, ow, c) contiguous, as
// cn_maxpool_fwd writes them (uint8 where k * k <= 256, else int32); dx:
// (b, h, w, c) contiguous, every value written. dy and dx bf16 when is_bf16
// else f32. Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" int cn_maxpool_bwd(const void* dy, const void* taps, void* dx, int b, int h, int w,
                              int c, int oh, int ow, int k, int s, int pad, int is_bf16,
                              void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0 || k <= 0 || s <= 0 ||
      pad < 0 || static_cast<int64_t>(h) * w * c >= (int64_t{1} << 31) ||
      static_cast<int64_t>(oh) * ow * c >= (int64_t{1} << 31) ||
      static_cast<int64_t>(k) * k >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{b, h, w, c, oh, ow, k, s, pad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(dy, taps, dx, g, st)
                 : launch<float>(dy, taps, dx, g, st);
}
