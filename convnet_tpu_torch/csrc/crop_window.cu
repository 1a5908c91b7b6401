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
// way, 0.84 ms at 3.35 TB/s.
//
// Design, simple first: one CTA of 256 threads a tile of 8 output rows of
// one image (grid: row tiles x images), threads along the row, one element
// a thread a step. A column origin of 3 * ox elements is not 16-byte
// aligned, nor is an input view off a 16-byte boundary, so the kernel
// assumes no vector alignment: every access is one element, and a warp's
// accesses are neighbouring elements of one row.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
crop_window_kernel(const T* __restrict__ x, const int* __restrict__ off_r,
                   const int* __restrict__ off_c, T* __restrict__ o, int h, int w, int oh, int ow,
                   int row_base, int row_mult, int col_base, int col_mult, int select) {
  const int b = blockIdx.y;
  int orow = off_r ? off_r[b] : 0;
  int ocol = off_c ? off_c[b] : 0;
  if (select >= 0) {
    orow = orow == select ? orow : 0;
    ocol = ocol == select ? ocol : 0;
  }
  const int64_t r0 = row_base + static_cast<int64_t>(row_mult) * orow;
  const int64_t c0 = col_base + static_cast<int64_t>(col_mult) * ocol;
  const bool inside = r0 >= 0 && r0 + oh <= h && c0 >= 0 && c0 + ow <= w;
  const int lo = blockIdx.x * kRowsPerCta;
  const int hi = min(lo + kRowsPerCta, oh);
  T* dst = o + static_cast<int64_t>(b) * oh * ow;
  if (!inside) {
    for (int r = lo; r < hi; ++r)
      for (int c = threadIdx.x; c < ow; c += kThreads) dst[static_cast<int64_t>(r) * ow + c] = T(0);
    return;
  }
  const T* src = x + (static_cast<int64_t>(b) * h + r0) * w + c0;
  for (int r = lo; r < hi; ++r)
    for (int c = threadIdx.x; c < ow; c += kThreads)
      dst[static_cast<int64_t>(r) * ow + c] = src[static_cast<int64_t>(r) * w + c];
}

template <typename T>
void launch(const void* x, const void* off_r, const void* off_c, void* o, int b, int h, int w,
            int oh, int ow, int row_base, int row_mult, int col_base, int col_mult, int select,
            cudaStream_t stream) {
  const dim3 grid((oh + kRowsPerCta - 1) / kRowsPerCta, b);
  crop_window_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(off_r), static_cast<const int*>(off_c),
      static_cast<T*>(o), h, w, oh, ow, row_base, row_mult, col_base, col_mult, select);
}

}  // namespace

// x: (b, h, w) elements of esize bytes (1 or 2) on the device, any
// alignment; off_r, off_c: int32 (b,) on the device or null; o: (b, oh, ow)
// of the same element, not overlapping x. Launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for
// arguments outside those (b above 65535: the grid's second dimension).
extern "C" int cn_crop_window(const void* x, const void* off_r, const void* off_c, void* o,
                              int b, int h, int w, int oh, int ow, int esize, int row_base,
                              int row_mult, int col_base, int col_mult, int select,
                              void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (esize) {
    case 1:
      launch<uint8_t>(x, off_r, off_c, o, b, h, w, oh, ow, row_base, row_mult, col_base, col_mult,
                      select, s);
      break;
    case 2:
      launch<uint16_t>(x, off_r, off_c, o, b, h, w, oh, ow, row_base, row_mult, col_base,
                       col_mult, select, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
