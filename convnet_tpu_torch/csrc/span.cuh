// Index splitting without a divide, and 16-byte words read at any byte
// offset, shared by crop_window.cu and relayout.cu.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// n / d for 0 <= n < 2^31 as (n * mul) >> shr, with shr = 31 + ceil(log2 d)
// and mul = ceil(2^shr / d) < 2^32 (Granlund and Montgomery): the error of
// n * mul / 2^shr against n / d is below 1 / d, so the floor is exact.
// Computed once on the host for each divisor.
struct FastDiv {
  uint32_t mul;
  uint32_t shr;
};

inline FastDiv fast_div(uint32_t d) {
  uint32_t l = 0;
  while ((uint64_t{1} << l) < d) ++l;
  const uint32_t shr = 31 + l;
  return {static_cast<uint32_t>(((uint64_t{1} << shr) + d - 1) / d), shr};
}

__device__ __forceinline__ int quotient(int n, FastDiv f) {
  return static_cast<int>((static_cast<uint64_t>(static_cast<uint32_t>(n)) * f.mul) >> f.shr);
}

// The 16 bytes from byte `off` (0..15) of the 32 bytes lo, hi, as four
// words: two word selects, then a funnel shift by the bytes left over.
__device__ __forceinline__ uint4 join16(uint4 lo, uint4 hi, int off) {
  uint32_t c0 = lo.x, c1 = lo.y, c2 = lo.z, c3 = lo.w, c4 = hi.x, c5 = hi.y;
  const uint32_t c6 = hi.z, c7 = hi.w;
  if (off & 8) {
    c0 = c2, c1 = c3, c2 = c4, c3 = c5, c4 = c6, c5 = c7;
  }
  if (off & 4) {
    c0 = c1, c1 = c2, c2 = c3, c3 = c4, c4 = c5;
  }
  const uint32_t sh = 8 * (off & 3);
  return make_uint4(__funnelshift_r(c0, c1, sh), __funnelshift_r(c1, c2, sh),
                    __funnelshift_r(c2, c3, sh), __funnelshift_r(c3, c4, sh));
}

// The `bytes` (at most 16) bytes from p, at any alignment, in the low bytes
// of a 16-byte word: one aligned 16-byte load, and a second where they
// cross into the next aligned word. No aligned word that holds none of
// them is read.
__device__ __forceinline__ uint4 load_span(const void* p, int bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* w = reinterpret_cast<const uint4*>(a & ~uintptr_t{15});
  const int off = static_cast<int>(a & 15);
  const uint4 lo = __ldg(w);
  if (off == 0) return lo;
  const uint4 hi = off + bytes > 16 ? __ldg(w + 1) : make_uint4(0, 0, 0, 0);
  return join16(lo, hi, off);
}

}  // namespace
