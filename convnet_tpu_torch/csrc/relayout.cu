// An output-indexed gather over a view of up to four dims: element
// (i_0, ..., i_{n-1}) of the row-major output reads the input at
//
//   base + sum_d stride_d * c_d,   c_d = ((m_d(i_d) - shift_d) mod size_d)
//
// where m_d mirrors the index (size_d - 1 - i) when the dim's flag bit 1
// is set and s[0] > 0, and shift_d is the dim's static roll plus s[0]
// where its flag bit 0 is set (jnp.roll's direction: out[i] = in[i -
// shift]). A stride may be negative (a static flip, base at the far end).
// s is int32 on the device (s[0] is the probes' prefetched scalar), so
// no launch waits for the host. Rolls and mirrors permute each dim's
// coordinates, so every read stays in the box that the host checked
// against the input.
//
// Epilogues:
//   0 copy, of elements of 1 or 2 bytes;
//   1 u8 -> f32 * scale -> bf16 (round to nearest even);
//   2 bf16 v -> v where the input element at (c_0, 0, ..., 0) is > 0, else
//     2v (a row's flag from its first column);
//   3 bf16 v -> v where i_0 < s[0], else 2v;
//   4 no input: 1 where i_0 + i_{n-1} == k - 1 with both below k, else 0
//     (bf16; the k x k anti-diagonal one-hot, zero-padded).
//
// Replaces the gather probes' single-block value ops (ROADMAP Queue B rows
// 16, 19, 20, 23, 24, 26): the dynamic and static sublane and lane rolls,
// the strided sublane slice, the leading-dims transpose and the middle
// index (tools/r5_probe_gather.py:107 value_probe: p2-p6, p2b, p3b); the
// u8 casts, the static flips, the minor-dims transpose, the per-row
// select and the q flip of the one-hot contraction
// (r5_probe_gather2.py:126: p14a/b, p15a/b/c, p16, p19, p20); the rank-4
// input block (r5_probe_gather2.py:181 p17a); the q and cp flip of the
// one-hot contractions and the iota select (r5_probe_gather3.py:122: p20b,
// p19b); the flip under pl.when (r5_probe_gather3.py:178 p22); the
// one-hot, the contractions and transposes of a rank-3 value and the 2D
// transpose (r5_probe_gather4.py:69: p25a-d, p30). A one-hot contraction
// of a finite input is exact, so each is the permutation it encodes.
//
// Bound: device-memory bytes, each output element written once and the
// input element it needs read once (epilogue 4 reads none); one multiply
// or compare an element at most. The probes' blocks are 0.3-1.2 MB: a
// call is launch-bound.
//
// Design, simple first: a grid-stride loop, one output element a thread a
// step, so writes are coalesced; the index is split into the view's dims
// by division, and reads follow the map (a transpose reads with a stride
// of a row: uncoalesced).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 4;
constexpr int kRollByS = 1, kMirrorIfS = 2;
enum Epilogue { kCopy = 0, kScaleU8 = 1, kRowFlagCol0 = 2, kRowBelowS = 3, kAntidiagonal = 4 };

struct Map {
  int ndim;
  int size[kMaxDims];
  int shift[kMaxDims];  // the static roll; s[0] is added on the card where flagged
  int flags[kMaxDims];
  int64_t stride[kMaxDims];
  int64_t base;
};

__device__ __forceinline__ float to_f32(uint16_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}
__device__ __forceinline__ uint16_t to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int kEpilogue, typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
relayout_kernel(const Tin* __restrict__ x, const int* __restrict__ s, Tout* __restrict__ o,
                Map m, int n, float scale, int k) {
  const int s0 = s ? s[0] : 0;
  int shift[kMaxDims];
  bool mirror[kMaxDims];
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d >= m.ndim) break;
    const int64_t sh = (m.shift[d] + ((m.flags[d] & kRollByS) ? int64_t{s0} : 0)) % m.size[d];
    shift[d] = static_cast<int>(sh < 0 ? sh + m.size[d] : sh);
    mirror[d] = (m.flags[d] & kMirrorIfS) && s0 > 0;
  }
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < n; e += gridDim.x * kThreads) {
    int idx[kMaxDims];
    int rest = e;
    for (int d = m.ndim - 1; d >= 0; --d) {
      const int q = rest / m.size[d];
      idx[d] = rest - q * m.size[d];
      rest = q;
    }
    if constexpr (kEpilogue == kAntidiagonal) {
      const int a = idx[0], z = idx[m.ndim - 1];
      o[e] = to_bf16(a < k && z < k && a + z == k - 1 ? 1.f : 0.f);
    } else {
      int64_t off = m.base, row = m.base;
      for (int d = 0; d < m.ndim; ++d) {
        int c = mirror[d] ? m.size[d] - 1 - idx[d] : idx[d];
        c -= shift[d];
        if (c < 0) c += m.size[d];
        off += m.stride[d] * c;
        if (d == 0) row += m.stride[0] * c;
      }
      if constexpr (kEpilogue == kCopy) {
        o[e] = x[off];
      } else if constexpr (kEpilogue == kScaleU8) {
        o[e] = to_bf16(__fmul_rn(static_cast<float>(x[off]), scale));
      } else {
        const float v = to_f32(x[off]);
        const bool keep = kEpilogue == kRowFlagCol0 ? to_f32(x[row]) > 0.f : idx[0] < s0;
        o[e] = keep ? x[off] : to_bf16(__fmul_rn(v, 2.f));
      }
    }
  }
}

template <int kEpilogue, typename Tin, typename Tout>
void launch(const void* x, const void* s, void* o, const Map& m, int n, float scale, int k,
            cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads < 65536 ? (n + kThreads - 1) / kThreads : 65536;
  relayout_kernel<kEpilogue, Tin, Tout><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const int*>(s), static_cast<Tout*>(o), m, n, scale,
      k);
}

}  // namespace

// x: the input's elements (in_esize bytes each: 1 or 2; bf16 for
// epilogues 2 and 3, u8 for 1; unread by 4) on the device, in_numel of
// them; s: int32 on the device, or null (s[0] taken as 0); o: the output
// (the map's elements, row-major; bf16, or x's element for a copy), not
// overlapping x. map (host memory): ndim (1..4), base, then for each dim
// its size, stride, static roll and flags. Launches on `stream` and
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for
// arguments outside those or a map whose reads leave [0, in_numel).
extern "C" int cn_relayout(const void* x, const void* s, void* o, const int64_t* map,
                           int64_t in_numel, int in_esize, int epilogue, float scale, int k,
                           void* stream) {
  Map m{};
  m.ndim = static_cast<int>(map[0]);
  m.base = map[1];
  if (m.ndim < 1 || m.ndim > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  int64_t n = 1, lo = m.base, hi = m.base;
  for (int d = 0; d < m.ndim; ++d) {
    const int64_t size = map[2 + 4 * d], stride = map[3 + 4 * d];
    if (size < 1 || size > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    m.size[d] = static_cast<int>(size);
    m.stride[d] = stride;
    m.shift[d] = static_cast<int>(map[4 + 4 * d] % size);
    m.flags[d] = static_cast<int>(map[5 + 4 * d]);
    n *= size;
    if (n > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    (stride < 0 ? lo : hi) += stride * (size - 1);
  }
  if (epilogue != kAntidiagonal && (lo < 0 || hi >= in_numel)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int count = static_cast<int>(n);
  switch (epilogue) {
    case kCopy:
      if (in_esize == 1) launch<kCopy, uint8_t, uint8_t>(x, s, o, m, count, scale, k, st);
      else if (in_esize == 2) launch<kCopy, uint16_t, uint16_t>(x, s, o, m, count, scale, k, st);
      else return static_cast<int>(cudaErrorInvalidValue);
      break;
    case kScaleU8:
      if (in_esize != 1) return static_cast<int>(cudaErrorInvalidValue);
      launch<kScaleU8, uint8_t, uint16_t>(x, s, o, m, count, scale, k, st);
      break;
    case kRowFlagCol0:
      if (in_esize != 2) return static_cast<int>(cudaErrorInvalidValue);
      launch<kRowFlagCol0, uint16_t, uint16_t>(x, s, o, m, count, scale, k, st);
      break;
    case kRowBelowS:
      if (in_esize != 2) return static_cast<int>(cudaErrorInvalidValue);
      launch<kRowBelowS, uint16_t, uint16_t>(x, s, o, m, count, scale, k, st);
      break;
    case kAntidiagonal:
      launch<kAntidiagonal, uint16_t, uint16_t>(nullptr, s, o, m, count, scale, k, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
