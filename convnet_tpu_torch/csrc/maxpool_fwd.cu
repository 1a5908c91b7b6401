// Max pooling forward over NHWC activations, cuda-convnet's ceil-mode
// geometry: output size 1 + ceil((in + 2*pad - k) / s) (capped so the last
// window still overlaps the input); taps outside the input are -inf. Where
// autograd will need the gradient it also writes the argmax ("taps"), the
// one input the train step's backward reads (csrc/maxpool_bwd.cu).
//
// Replaces the TPU kernel convnet_tpu/ops/pool.py:87 _maxpool_kernel
// (launched by _pallas_maxpool_local, pool.py:130), which takes the k row
// taps of each output row as k shifted block views and the column taps as
// an s-phase reshape. It needs (H, W, lanes) views of relaid activations;
// here the kernel reads the NHWC bytes cuDNN writes, and any geometry,
// not only the exact-cover pools that kernel accepts.
//
// Bound: device-memory bytes. At AlexNet's pools, batch 128, bf16, the
// function moves 92.3 MB (pool1), 58.9 MB (pool2) and 13.4 MB (pool5):
// 28, 18 and 4 us at 3.35 TB/s; the taps add one byte an output value
// (9.0, 5.5 and 1.2 MB: 9.7%, 9.4% and 8.8% more).
//
// Design:
// - A thread owns one word of channels at one output position: 16 bytes
//   (8 bf16 or 4 f32 values) when the channel row is a whole number of
//   16-byte words and both tensors are 16-byte aligned, else one value (the
//   same kernel body, instantiated for a 1-value word). Its column and word
//   come from one 32-bit division at thread start, its image and output row
//   from the block's y index. Neighbouring threads read neighbouring words,
//   so every load is coalesced; windows that share a row or column share
//   its bytes through L1 and L2.
// - k = 3 (AlexNet's pools) is compile-time, so a window's nine loads are
//   all issued before its first compare; windows inside the input take a
//   path with no bounds tests, border windows (padding, the ceil-mode last
//   window) test each tap. Other k loop over the taps.
// - Measured and dropped (NVIDIA H100 80GB HBM3): a thread walking a strip
//   of output rows with the row two windows share kept in registers. It
//   loads each input row once instead of 1.5 times, and gained 2% at pool1
//   and nothing at pool2 and pool5, whose re-read rows come from L2.
// - The max is ATen's scan (`if (v > m || isnan(v)) m = v`, row-major
//   order): the first of equal values is kept, so -0 and +0 keep the one
//   that comes first, and the last NaN of a window is the result, bits and
//   all. That scan is associative (keep below), so a max over rows of
//   row maxima gives the same bits. bf16 words are compared two values an
//   instruction (__hgt2_mask, __hneu2_mask) and selected bitwise, without
//   widening; __hmax2 and __hmax2_nan are not used: neither keeps the
//   first of -0 and +0 nor a NaN's payload.
// - Taps: the tap i * k + j (window row i, column j, padding counted) of
//   the value the scan kept, so the first of equal maxima, the last NaN,
//   and tap 0 where no value beats -inf (ATen's start). One byte a value
//   where k * k <= 256, moved with the same take masks as the values: a
//   16-byte word's taps are one 8-byte (bf16) or 4-byte (f32) store. Larger
//   windows take the one-value word and an int32 tap. Without taps (no
//   gradient wanted: serving, extract) the taps are dead code.
// The result equals the plain version (convnet_tpu_torch/ops/pool.py:
// maxpool_reference; with taps maxpool_argmax_reference) bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

template <typename T, int N>
__device__ __forceinline__ Word<N> neg_inf() {
  Word<N> out;
#pragma unroll
  for (int i = 0; i < N; ++i) out.v[i] = sizeof(T) == 2 ? 0xff80ff80u : 0xff800000u;
  return out;
}

// The running max of a word and its taps: one byte a value, four to a
// 32-bit word (N = 4: bf16 two words, f32 one); N = 1 the tap itself.
template <typename T, int N>
struct Best {
  static constexpr int kTapWords = N == 1 ? 1 : N / static_cast<int>(sizeof(T));
  Word<N> m;
  uint32_t tap[kTapWords];
};

// tap in every byte of a word's taps (one value: the tap itself)
template <typename T, int N>
__device__ __forceinline__ Best<T, N> at_tap(const Word<N>& v, int tap) {
  Best<T, N> out;
  out.m = v;
#pragma unroll
  for (int w = 0; w < Best<T, N>::kTapWords; ++w) {
    out.tap[w] = N == 1 ? static_cast<uint32_t>(tap) : static_cast<uint32_t>(tap) * 0x01010101u;
  }
  return out;
}

// The scan's step for b, which comes after a: b where b > a or b is a NaN,
// else a; value and tap alike. Associative, and -inf is its identity bit
// for bit.
template <typename T, int N>
__device__ __forceinline__ void keep(Best<T, N>& a, const Best<T, N>& b) {
  uint32_t bytes[Best<T, N>::kTapWords] = {};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint32_t take;
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162 av = *reinterpret_cast<const __nv_bfloat162*>(&a.m.v[i]);
      const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(&b.m.v[i]);
      take = __hgt2_mask(bv, av) | __hneu2_mask(bv, bv);
    } else {
      const float af = __uint_as_float(a.m.v[i]), bf = __uint_as_float(b.m.v[i]);
      take = bf > af || bf != bf ? ~0u : 0u;
    }
    a.m.v[i] = (b.m.v[i] & take) | (a.m.v[i] & ~take);
    if constexpr (N == 1) {
      // one bf16 value sits in the low half
      bytes[0] = (sizeof(T) == 2 ? take & 0xffffu : take) ? ~0u : 0u;
    } else if constexpr (sizeof(T) == 2) {
      bytes[i / 2] |= ((take & 0xffu) | ((take >> 8) & 0xff00u)) << (16 * (i % 2));
    } else {
      bytes[0] |= (take & 0xffu) << (8 * i);
    }
  }
#pragma unroll
  for (int w = 0; w < Best<T, N>::kTapWords; ++w) {
    a.tap[w] = (b.tap[w] & bytes[w]) | (a.tap[w] & ~bytes[w]);
  }
}

// The max over the window's columns of its row i: tap j is word
// x[row + j * cu]; taps [jlo, jhi) lie inside the input. Inside: all K
// taps do, and they are loaded before the first compare.
template <typename T, int N, int K, bool Inside>
__device__ __forceinline__ Best<T, N> row_max(const typename Access<T, N>::type* x, int row,
                                              int cu, int k, int i, int jlo, int jhi) {
  if constexpr (K > 0) {
    Word<N> v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = Inside || (j >= jlo && j < jhi) ? load_word<T, N>(x + row + j * cu)
                                             : neg_inf<T, N>();
    }
    Best<T, N> m = at_tap<T, N>(v[0], i * K);
#pragma unroll
    for (int j = 1; j < K; ++j) keep<T, N>(m, at_tap<T, N>(v[j], i * K + j));
    return m;
  } else {
    Best<T, N> m = at_tap<T, N>(neg_inf<T, N>(), i * k);
#pragma unroll 4
    for (int j = jlo; j < jhi; ++j) {
      keep<T, N>(m, at_tap<T, N>(load_word<T, N>(x + row + j * cu), i * k + j));
    }
    return m;
  }
}

// The max over the window's rows [ilo, ihi) (of k, from input row r0) of
// the row maxima; the window's first column is word x[col]. It starts at
// -inf with tap 0, as ATen's scan does.
template <typename T, int N, int K, bool Inside>
__device__ __forceinline__ Best<T, N> window_max(const typename Access<T, N>::type* x, int col,
                                                 int r0, int ilo, int ihi, int row_stride,
                                                 int cu, int k, int jlo, int jhi) {
  Best<T, N> acc = at_tap<T, N>(neg_inf<T, N>(), 0);
  const int kk = K > 0 ? K : k;
#pragma unroll
  for (int i = 0; i < kk; ++i) {
    if (!Inside && (i < ilo || i >= ihi)) continue;
    const Best<T, N> h =
        row_max<T, N, K, Inside>(x, (r0 + i) * row_stride + col, cu, k, i, jlo, jhi);
    if (Inside && i == 0) {
      acc = h;
    } else {
      keep<T, N>(acc, h);  // -inf is keep's identity
    }
  }
  return acc;
}

// A word's taps at taps[at] (at: the word's first value).
template <typename T, int N, typename Ix>
__device__ __forceinline__ void store_taps(Ix* taps, int64_t at, const Best<T, N>& b) {
  if constexpr (N == 1) {
    taps[at] = static_cast<Ix>(b.tap[0]);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint2*>(taps + at) = make_uint2(b.tap[0], b.tap[1]);
  } else {
    *reinterpret_cast<uint32_t*>(taps + at) = b.tap[0];
  }
}

struct Geometry {
  int b, h, w, cu, oh, ow, k, s, pad;
};

// Block: (ox, word) pairs of one output row of one image; blockIdx.y over
// (image, output row). x: (b, h, w, cu) words; y: (b, oh, ow, cu) words;
// taps (Ix other than void): (b, oh, ow, cu * values a word), or none.
template <typename T, int N, int K, typename Ix>
__global__ void __launch_bounds__(kMaxThreads)
maxpool_fwd_kernel(const typename Access<T, N>::type* __restrict__ x,
                   typename Access<T, N>::type* __restrict__ y, Ix* __restrict__ taps,
                   Geometry g) {
  constexpr int kValues = N == 1 ? 1 : 16 / static_cast<int>(sizeof(T));
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g.ow * g.cu) return;
  const int ox = t / g.cu;
  const int u = t - ox * g.cu;
  const int k = K > 0 ? K : g.k;
  const int c0 = ox * g.s - g.pad;
  const int jlo = max(0, -c0), jhi = min(k, g.w - c0);
  const bool cols_inside = jlo == 0 && jhi == k;
  const int row_stride = g.w * g.cu;
  // the window's first column c0 may be negative, so it goes into each
  // tap's offset from the image's word u, not into a pointer
  const int col = c0 * g.cu;
  for (int by = blockIdx.y; by < g.b * g.oh; by += gridDim.y) {
    const int img = by / g.oh;
    const int oy = by - img * g.oh;
    const auto* xi = x + static_cast<int64_t>(img) * g.h * row_stride + u;
    const int r0 = oy * g.s - g.pad;
    const int ilo = max(0, -r0), ihi = min(k, g.h - r0);
    const Best<T, N> m =
        cols_inside && ilo == 0 && ihi == k
            ? window_max<T, N, K, true>(xi, col, r0, ilo, ihi, row_stride, g.cu, k, jlo, jhi)
            : window_max<T, N, K, false>(xi, col, r0, ilo, ihi, row_stride, g.cu, k, jlo, jhi);
    const int64_t word = (static_cast<int64_t>(by) * g.ow + ox) * g.cu + u;
    store_word<T, N>(y + word, m.m);
    if constexpr (!std::is_void_v<Ix>) store_taps<T, N>(taps, word * kValues, m);
  }
}

template <typename T, int N, typename Ix>
int launch_n(const void* x, void* y, void* taps, const Geometry& g, cudaStream_t st) {
  using A = typename Access<T, N>::type;
  const int cols = g.ow * g.cu;
  const int blocks_x = (cols + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((cols + blocks_x - 1) / blocks_x + 31) / 32 * 32;
  const int64_t rows = static_cast<int64_t>(g.b) * g.oh;
  const dim3 grid(blocks_x, static_cast<unsigned>(rows < 65535 ? rows : 65535));
  const auto* xs = static_cast<const A*>(x);
  auto* yd = static_cast<A*>(y);
  auto* td = static_cast<Ix*>(taps);
  if (g.k == 3) {
    maxpool_fwd_kernel<T, N, 3, Ix><<<grid, threads, 0, st>>>(xs, yd, td, g);
  } else {
    maxpool_fwd_kernel<T, N, 0, Ix><<<grid, threads, 0, st>>>(xs, yd, td, g);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, void* y, void* taps, Geometry g, cudaStream_t st) {
  // a 16-byte word's taps are one 8- or 4-byte store, so need that alignment
  const bool byte_taps = g.k * g.k <= 256;
  const bool vec = (static_cast<int64_t>(g.cu) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   (taps == nullptr ||
                    (byte_taps && reinterpret_cast<uintptr_t>(taps) % (16 / sizeof(T)) == 0));
  if (vec) {
    g.cu = static_cast<int>(g.cu * sizeof(T) / 16);
    return taps == nullptr ? launch_n<T, 4, void>(x, y, taps, g, st)
                           : launch_n<T, 4, uint8_t>(x, y, taps, g, st);
  }
  if (taps == nullptr) return launch_n<T, 1, void>(x, y, taps, g, st);
  return byte_taps ? launch_n<T, 1, uint8_t>(x, y, taps, g, st)
                   : launch_n<T, 1, int32_t>(x, y, taps, g, st);
}

}  // namespace

// x: (b, h, w, c) contiguous; y: (b, oh, ow, c) contiguous; both bf16 when
// is_bf16 else f32. taps: null, or (b, oh, ow, c) contiguous, uint8 where
// k * k <= 256 else int32: each value's window tap i * k + j. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int cn_maxpool_fwd(const void* x, void* y, void* taps, int b, int h, int w, int c,
                              int oh, int ow, int k, int s, int pad, int is_bf16,
                              void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0 || k <= 0 || s <= 0 ||
      pad < 0 || static_cast<int64_t>(h) * w * c >= (int64_t{1} << 31) ||
      static_cast<int64_t>(oh) * ow * c >= (int64_t{1} << 31) ||
      static_cast<int64_t>(k) * k >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{b, h, w, c, oh, ow, k, s, pad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, y, taps, g, st) : launch<float>(x, y, taps, g, st);
}
