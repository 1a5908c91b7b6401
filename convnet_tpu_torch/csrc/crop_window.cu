// A per-image window of each image: o[b, r, c] = x[b, r0[b] + r, c0[b] + c]
// over row-major (B, H, W) elements of 1 or 2 bytes (u8, bf16), with
//
//   r0[b] = row_base + row_mult * off_r[b],  c0[b] = col_base + col_mult * off_c[b]
//
// and off_r, off_c int32 (B,) on the device (absent: 0), the counterpart of
// a prefetched scalar, so no launch waits for the host. With select >= 0 an
// offset counts only where it equals select (else 0): the two-way switch of
// tools/r5_probe_gather4.py:141 p26 (x[3:227] if s[0] == 3, else x[0:224]).
//
// Replaces the gather probes' window copies (ROADMAP Queue B rows 15, 17,
// 18, 21, 22, 27, 28 and parts of 16 and 19): the element-offset row DMA
// (tools/r5_probe_gather.py:86 p1, r5_probe_gather2.py:73 p1_fix,
// r5_probe_gather3.py:78 p1c), the block row index (r5_probe_gather3.py:101
// p23, rows 8 * a[b]), the element-offset column DMA (r5_probe_gather2.py:104
// p13b, columns 3 * ox[b]), the dynamic, hinted and static sublane and lane
// slices of one block (r5_probe_gather.py:107 p7-p10), the 33-way where of
// lane slices (r5_probe_gather2.py:126 p18: bf16 -> f32 -> bf16 is exact, so
// a copy) and the pl.when slice switches (r5_probe_gather4.py:141 p26, :157
// p27, p28).
//
// Bounds: an image whose window leaves its input (r0 < 0, r0 + OH > H,
// c0 < 0 or c0 + OW > W) reads nothing and is written as zeros, whole. That
// is p18's own function (zeros when s[0] is not in 0..32); for every other
// probe the offset lies outside the probe's range, which the wrapper refuses
// for a CPU tensor and cannot check on the card without waiting for it.
//
// Bound: device-memory bytes, the window read once and written once; no
// arithmetic. (4096, 224, 768) bf16 out of (4096, 256, 768): 1.41 GB each
// way, 0.8414 ms at 3.35 TB/s (0.91 ms at the 3.09 TB/s that copy_add.cu
// attains). One block of 224 rows (0.34 MB each way) takes 0.0002 ms of
// bytes: it is bound by the launch and one round trip to device memory.
//
// Design: one warp an output row, over a persistent grid of four-warp CTAs
// (the CTAs that fit on the card, from the occupancy API once, cached). One
// block's 224 rows are 56 CTAs, each lane with its row's three words in
// flight at once, so the call is one round trip; at 4096 images each warp
// walks about a hundred rows. (On the card, one-warp CTAs spread over all
// 132 SMs, and rows cut into one-word-a-lane segments over three times the
// warps, were both slower at one block: a CTA costs more to start than a
// warp's second and third word.) The warp writes its row's span of the
// output as aligned 16-byte words, up to four a lane a pass. A column origin
// of 3 * ox elements, an input off a 16-byte boundary or a row width that
// is no multiple of 16 bytes leaves the input's words at another byte
// offset than the output's: lane i loads the aligned input word i of the
// row's span, takes word i + 1 from the next lane (__shfl_down_sync; the
// last lane and the row's last word load their own), and joins the two by
// the offset with a funnel shift (span.cuh). So every load and store is 16
// bytes whatever the origin, and each input word is loaded once. The
// bytes of an output row before its first aligned word and after its last
// are written element by element. An image whose window leaves its input
// stores zero words.

#include <cuda_runtime.h>

#include <cstdint>

#include "span.cuh"

namespace {

constexpr int kThreads = 128;  // four warps, a row each
constexpr int kUnroll = 4;  // aligned words a lane has in flight a pass

// One output row of `bytes` bytes at dst from src (null: zeros), by the 32
// lanes of a warp: 16-byte words inside dst's whole aligned words, their
// loads issued first; element by element before and after them.
template <typename T>
__device__ __forceinline__ void copy_row(unsigned char* dst, const unsigned char* src, int bytes,
                                         int lane) {
  constexpr int kEs = sizeof(T);
  const uintptr_t d0 = reinterpret_cast<uintptr_t>(dst), d1 = d0 + bytes;
  const uintptr_t a0 = (d0 + 15) & ~uintptr_t{15}, a1 = d1 & ~uintptr_t{15};
  const int n = a0 < a1 ? static_cast<int>((a1 - a0) >> 4) : 0;
  const int head = n ? static_cast<int>(a0 - d0) : bytes;  // bytes before the words
  const int tail = n ? static_cast<int>(a1 - d0) : bytes;  // and where the rest starts
  uint4* out = reinterpret_cast<uint4*>(a0);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const uintptr_t s0 = reinterpret_cast<uintptr_t>(src) + (a0 - d0);
  const int off = static_cast<int>(s0 & 15);
  const uint4* in = reinterpret_cast<const uint4*>(s0 & ~uintptr_t{15});
  if (!src) {
    for (int i = lane; i < n; i += 32) out[i] = zero;
  } else if (off == 0) {  // the input's words line up with the output's
    for (int base = 0; base < n; base += 32 * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + 32 * u + lane;
        v[u] = i < n ? __ldg(in + i) : zero;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + 32 * u + lane;
        if (i < n) out[i] = v[u];
      }
    }
  } else {
    for (int base = 0; base < n; base += 32 * kUnroll) {
      uint4 lo[kUnroll], own[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + 32 * u + lane;
        lo[u] = i < n ? __ldg(in + i) : zero;
        // the word after: the next lane's, but the last lane's and the row's last word's
        own[u] = i < n && (lane == 31 || i + 1 == n) ? __ldg(in + i + 1) : zero;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + 32 * u + lane;
        uint4 hi;
        hi.x = __shfl_down_sync(0xffffffffu, lo[u].x, 1);
        hi.y = __shfl_down_sync(0xffffffffu, lo[u].y, 1);
        hi.z = __shfl_down_sync(0xffffffffu, lo[u].z, 1);
        hi.w = __shfl_down_sync(0xffffffffu, lo[u].w, 1);
        if (lane == 31 || i + 1 == n) hi = own[u];
        if (i < n) out[i] = join16(lo[u], hi, off);
      }
    }
  }
  for (int e = lane * kEs; e < head; e += 32 * kEs) {
    *reinterpret_cast<T*>(dst + e) = src ? *reinterpret_cast<const T*>(src + e) : T(0);
  }
  for (int e = tail + lane * kEs; e < bytes; e += 32 * kEs) {
    *reinterpret_cast<T*>(dst + e) = src ? *reinterpret_cast<const T*>(src + e) : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
crop_window_kernel(const T* __restrict__ x, const int* __restrict__ off_r,
                   const int* __restrict__ off_c, T* __restrict__ o, int rows, FastDiv by_oh,
                   int h, int w, int oh, int ow, int row_base, int row_mult, int col_base,
                   int col_mult, int select) {
  const int lane = threadIdx.x & 31;
  const int warps = static_cast<int>(gridDim.x * blockDim.x) >> 5;
  for (int row = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x) >> 5; row < rows;
       row += warps) {
    const int b = quotient(row, by_oh);
    const int r = row - b * oh;
    int orow = off_r ? __ldg(off_r + b) : 0;
    int ocol = off_c ? __ldg(off_c + b) : 0;
    if (select >= 0) {
      orow = orow == select ? orow : 0;
      ocol = ocol == select ? ocol : 0;
    }
    const int64_t r0 = row_base + static_cast<int64_t>(row_mult) * orow;
    const int64_t c0 = col_base + static_cast<int64_t>(col_mult) * ocol;
    const bool inside = r0 >= 0 && r0 + oh <= h && c0 >= 0 && c0 + ow <= w;
    const T* src = inside ? x + (static_cast<int64_t>(b) * h + r0 + r) * w + c0 : nullptr;
    copy_row<T>(reinterpret_cast<unsigned char*>(o + static_cast<int64_t>(row) * ow),
                reinterpret_cast<const unsigned char*>(src), ow * static_cast<int>(sizeof(T)),
                lane);
  }
}

// The CTAs that fit on the card at once, asked of the occupancy API once an
// instance and cached (0: the query failed).
template <typename T>
int resident() {
  static const int blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crop_window_kernel<T>, kThreads,
                                                      0) != cudaSuccess) {
      return 0;
    }
    return per_sm * sms;
  }();
  return blocks;
}

template <typename T>
int launch(const void* x, const void* off_r, const void* off_c, void* o, int rows, int h, int w,
           int oh, int ow, int row_base, int row_mult, int col_base, int col_mult, int select,
           cudaStream_t stream) {
  constexpr int kWarps = kThreads / 32;
  const int cap = resident<T>();
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int want = (rows + kWarps - 1) / kWarps;
  crop_window_kernel<T><<<want < cap ? want : cap, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(off_r), static_cast<const int*>(off_c),
      static_cast<T*>(o), rows, fast_div(static_cast<uint32_t>(oh)), h, w, oh, ow, row_base,
      row_mult, col_base, col_mult, select);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, h, w) elements of esize bytes (1 or 2) on the device, any
// alignment; off_r, off_c: int32 (b,) on the device or null; o: (b, oh, ow)
// of the same element, not overlapping x, any alignment. Launches on
// `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for arguments outside those (b * oh rows at most
// 2^31 - 1).
extern "C" int cn_crop_window(const void* x, const void* off_r, const void* off_c, void* o,
                              int b, int h, int w, int oh, int ow, int esize, int row_base,
                              int row_mult, int col_base, int col_mult, int select,
                              void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0 ||
      static_cast<int64_t>(b) * oh > INT32_MAX || static_cast<int64_t>(ow) * esize > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = b * oh;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (esize) {
    case 1:
      return launch<uint8_t>(x, off_r, off_c, o, rows, h, w, oh, ow, row_base, row_mult, col_base,
                             col_mult, select, s);
    case 2:
      return launch<uint16_t>(x, off_r, off_c, o, rows, h, w, oh, ow, row_base, row_mult,
                              col_base, col_mult, select, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
