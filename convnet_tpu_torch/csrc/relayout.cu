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
// or compare an element at most. The probes' blocks are 0.3-1.2 MB, whose
// bytes take 0.00004-0.00062 ms at 3.35 TB/s: a call is bound by its
// launch and one round trip to device memory (a load, then a store that
// waits for it), whatever the route. The design keeps each thread to that
// one round trip and spreads the block over every SM.
//
// Design. The host (ops/gather.py _relayout_plan) reduces the map before
// the launch: it drops dims of size 1, merges neighbours that neither roll
// nor mirror where stride_d == size_{d+1} * stride_{d+1} (p14, p17a become
// one dim), keeps dim 0 whole for the row epilogues, and picks a route.
// The reduced rank R (1-4) is a template parameter: coordinates, shifts
// and mirrors live in registers, and each split of an index by a dim's
// size is a multiply-high and a shift (FastDiv, span.cuh), computed on the
// host. nvcc -Xptxas -v: 0 bytes stack frame, 0 bytes spill stores, 0 bytes
// spill loads for every instance (NVIDIA H100 build, sm_90a).
//
//   run (the innermost dim steps by +-1, or no dim does): one thread a
//     16-byte output word, 256 threads a CTA (a probe block is 74-252
//     CTAs; on the card, 64-thread CTAs, two or more an SM, were slower:
//     a CTA costs more to start than its threads' work). A word inside
//     one run of the innermost dim, and on one side of the split that a
//     roll makes in it, reads its input as one contiguous span, forward
//     (run copy) or backward (run reverse: the span's elements reversed
//     in registers by __byte_perm); a mirrored innermost dim picks the
//     direction by s[0] on the card. The span is one or two aligned
//     16-byte loads joined by a funnel shift at the input's byte offset,
//     so no address needs any alignment. A word that straddles a run's end
//     or a roll's split, the output's last partial word, and every word of
//     a map whose innermost dim does not step by +-1, go element by
//     element (inside one run only the innermost coordinate moves). p20 is
//     5,376 runs of 192 bytes; the anti-diagonal writes its words from the
//     indices.
//   tile (the innermost dim has another stride, and a dim J reads with
//     stride +-1: p16, p25d, p30): a 16 x 32 shared-memory tile (innermost
//     x J) per step of a 128-thread CTA, four elements a thread, one word
//     of padding a tile row: a warp loads 32 neighbouring input elements
//     along J, a half-warp stores 16 neighbouring output elements, and
//     neither conflicts on a bank. The other dims index the tiles (p16 384
//     tiles, p30 294, p25d 448: two or more CTAs an SM).
//
// The epilogues run per element inside the route that reads it. s[0] is
// loaded only where a dim rolls or mirrors by it or the epilogue compares
// with it: every address would wait for that load, a second round trip.
// A persistent grid: each instance's resident CTAs are asked of the
// occupancy API once and cached; a larger call loops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "span.cuh"

namespace {

constexpr int kMaxDims = 4;
constexpr int kRunThreads = 256;
constexpr int kTileThreads = 128;
constexpr int kTileJ = 32;            // the unit-stride dim: a warp's loads
constexpr int kTileI = 16;            // the innermost output dim: a half-warp's stores
constexpr int kTileRow = kTileJ + 2;  // halfwords a tile row: one word of padding
constexpr int kRollByS = 1, kMirrorIfS = 2;
constexpr uint32_t kBf16One = 0x3F80;
enum Epilogue { kCopy = 0, kScaleU8 = 1, kRowFlagCol0 = 2, kRowBelowS = 3, kAntidiagonal = 4 };
enum Route { kRun = 0, kTile = 1 };

struct Map {
  int64_t stride[kMaxDims];
  int64_t ostride[kMaxDims];  // output elements a step (row-major)
  int64_t base;
  int size[kMaxDims];
  int roll[kMaxDims];  // the static roll, in [0, size)
  int flags[kMaxDims];
  FastDiv by_size[kMaxDims];
  int n;                          // output elements
  int unit;                       // tile: the dim read with stride +-1
  int tiles_i, tiles_j, tiles;    // tile: along the innermost dim, along unit, in all
  FastDiv by_tiles_i, by_tiles_j;
};

__device__ __forceinline__ float to_f32(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<uint16_t>(bits)));
}
__device__ __forceinline__ uint32_t to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// v mod size in [0, size) for any int32 v (a negative v = -(t + 1) has
// residue size - 1 - (t mod size)), without a divide.
__device__ __forceinline__ int residue(int v, int size, FastDiv by) {
  const bool neg = v < 0;
  const int t = neg ? -(v + 1) : v;
  const int r = t - quotient(t, by) * size;
  return neg ? size - 1 - r : r;
}

__device__ __forceinline__ int coord(int i, int size, int shift, bool mirror) {
  const int c = (mirror ? size - 1 - i : i) - shift;
  return c < 0 ? c + size : c;
}

// Each dim's shift in [0, size) and mirror, from s[0].
template <int R>
__device__ __forceinline__ void shifts(const Map& m, int s0, int (&shift)[R], bool (&mirror)[R]) {
#pragma unroll
  for (int d = 0; d < R; ++d) {
    int sh = m.roll[d] + ((m.flags[d] & kRollByS) ? residue(s0, m.size[d], m.by_size[d]) : 0);
    shift[d] = sh >= m.size[d] ? sh - m.size[d] : sh;
    mirror[d] = (m.flags[d] & kMirrorIfS) && s0 > 0;
  }
}

template <int kEp>
__device__ __forceinline__ uint32_t apply(uint32_t v, bool keep, float scale) {
  if constexpr (kEp == kCopy) {
    return v;
  } else if constexpr (kEp == kScaleU8) {
    return to_bf16(__fmul_rn(static_cast<float>(v), scale));
  } else {
    return keep ? v : to_bf16(__fmul_rn(to_f32(v), 2.f));
  }
}

// Run r of the innermost dim: the input offset of its coordinate 0 in
// that dim, and dim 0's output and input coordinates (R >= 2).
template <int R>
__device__ __forceinline__ int64_t run_row(int r, const Map& m, const int (&shift)[R],
                                           const bool (&mirror)[R], int& i0, int& c0) {
  int64_t row = m.base;
#pragma unroll
  for (int d = R - 2; d >= 0; --d) {
    const int q = d > 0 ? quotient(r, m.by_size[d]) : 0;
    const int id = r - q * m.size[d];
    r = q;
    const int c = coord(id, m.size[d], shift[d], mirror[d]);
    row += m.stride[d] * c;
    if (d == 0) i0 = id, c0 = c;
  }
  return row;
}

// Element e of the output, on its own.
template <int kEp, int R, typename Tin>
__device__ __forceinline__ uint32_t element(const Tin* __restrict__ x, const Map& m,
                                            const int (&shift)[R], const bool (&mirror)[R],
                                            int s0, int e, float scale, int k) {
  constexpr int L = R - 1;
  const int r = quotient(e, m.by_size[L]);
  const int i = e - r * m.size[L];
  const int ci = coord(i, m.size[L], shift[L], mirror[L]);
  int i0 = i, c0 = ci;  // R == 1: dim 0 is the innermost
  const int64_t row = run_row<R>(r, m, shift, mirror, i0, c0);
  if constexpr (kEp == kAntidiagonal) {
    return i0 < k && i < k && i0 + i == k - 1 ? kBf16One : 0u;
  } else {
    const uint32_t v = x[row + m.stride[L] * ci];
    bool keep = true;
    if constexpr (kEp == kRowBelowS) keep = i0 < s0;
    if constexpr (kEp == kRowFlagCol0) keep = to_f32(x[m.base + m.stride[0] * c0]) > 0.f;
    return apply<kEp>(v, keep, scale);
  }
}

// Element j of a word of 1- or 2-byte elements.
template <int kBytes>
__device__ __forceinline__ uint32_t lane_of(uint4 w, int j) {
  const uint32_t word[4] = {w.x, w.y, w.z, w.w};
  if constexpr (kBytes == 1) return (word[j / 4] >> (8 * (j % 4))) & 0xffu;
  else return (word[j / 2] >> (16 * (j % 2))) & 0xffffu;
}

// The first `kBytes * kCount` bytes' elements of w in reverse order.
template <int kBytes, int kCount>
__device__ __forceinline__ uint4 reversed(uint4 w) {
  constexpr uint32_t kSel = kBytes == 1 ? 0x0123 : 0x1032;
  if constexpr (kBytes * kCount == 16) {
    return make_uint4(__byte_perm(w.w, 0, kSel), __byte_perm(w.z, 0, kSel),
                      __byte_perm(w.y, 0, kSel), __byte_perm(w.x, 0, kSel));
  } else {  // 8 bytes
    return make_uint4(__byte_perm(w.y, 0, kSel), __byte_perm(w.x, 0, kSel), 0, 0);
  }
}

// Element j of a word's elements, packed as T: bits to OR into word j * sizeof(T) / 4.
template <typename T>
__device__ __forceinline__ void pack(uint32_t (&out)[4], int j, uint32_t v) {
  constexpr int kPer = 4 / sizeof(T);
  out[j / kPer] |= v << (8 * sizeof(T) * (j % kPer));
}

template <int kEp, int R, typename Tin, typename Tout>
__global__ void __launch_bounds__(kRunThreads)
relayout_run_kernel(const Tin* __restrict__ x, const int* __restrict__ s, Tout* __restrict__ o,
                    const Map m, float scale, int k) {
  constexpr int E = 16 / sizeof(Tout);  // output elements a word
  constexpr int L = R - 1;
  const int s0 = s ? __ldg(s) : 0;
  int shift[R];
  bool mirror[R];
  shifts<R>(m, s0, shift, mirror);
  const int n_in = m.size[L];
  const int words = (m.n + E - 1) / E;
  for (int w = blockIdx.x * kRunThreads + threadIdx.x; w < words; w += gridDim.x * kRunThreads) {
    const int e0 = w * E;
    const int r = quotient(e0, m.by_size[L]);
    const int i = e0 - r * n_in;
    uint32_t out[4] = {0, 0, 0, 0};
    if (e0 + E <= m.n && i + E <= n_in) {  // a whole word inside one run
      int i0 = i, c0 = 0;
      const int64_t row = run_row<R>(r, m, shift, mirror, i0, c0);
      if constexpr (kEp == kAntidiagonal) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int a = R == 1 ? i + j : i0, z = i + j;
          pack<Tout>(out, j, a < k && z < k && a + z == k - 1 ? kBf16One : 0u);
        }
      } else {
        bool keep = true;
        if constexpr (R > 1 && kEp == kRowBelowS) keep = i0 < s0;
        if constexpr (R > 1 && kEp == kRowFlagCol0) {
          keep = to_f32(x[m.base + m.stride[0] * c0]) > 0.f;
        }
        const int64_t st = m.stride[L];
        const int step = mirror[L] ? -1 : 1;
        const int cf = coord(i, n_in, shift[L], mirror[L]);
        const int cl = cf + step * (E - 1);
        if ((st == 1 || st == -1) && cl >= 0 && cl < n_in) {
          // one side of a roll's split: a contiguous span, forward or backward
          const bool forward = (st > 0) == (step > 0);
          uint4 in = load_span(x + row + st * (forward ? cf : cl), E * sizeof(Tin));
          if (!forward) in = reversed<sizeof(Tin), E>(in);
          if constexpr (kEp == kCopy) {
            *reinterpret_cast<uint4*>(o + e0) = in;
            continue;
          }
#pragma unroll
          for (int j = 0; j < E; ++j) {
            const uint32_t v = lane_of<sizeof(Tin)>(in, j);
            bool kj = keep;
            if constexpr (R == 1 && kEp == kRowBelowS) kj = i + j < s0;
            if constexpr (R == 1 && kEp == kRowFlagCol0) kj = to_f32(v) > 0.f;
            pack<Tout>(out, j, apply<kEp>(v, kj, scale));
          }
        } else {
          // across a roll's split, or no unit stride: one run's elements,
          // only the innermost coordinate moving
#pragma unroll
          for (int j = 0; j < E; ++j) {
            const uint32_t v = x[row + st * coord(i + j, n_in, shift[L], mirror[L])];
            bool kj = keep;
            if constexpr (R == 1 && kEp == kRowBelowS) kj = i + j < s0;
            if constexpr (R == 1 && kEp == kRowFlagCol0) kj = to_f32(v) > 0.f;
            pack<Tout>(out, j, apply<kEp>(v, kj, scale));
          }
        }
      }
      *reinterpret_cast<uint4*>(o + e0) = make_uint4(out[0], out[1], out[2], out[3]);
      continue;
    }
    // a word across runs, or the output's last partial word
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (e0 + j < m.n) {
        o[e0 + j] = static_cast<Tout>(element<kEp, R>(x, m, shift, mirror, s0, e0 + j, scale, k));
      }
    }
  }
}

template <int kEp, int R, typename Tin, typename Tout>
__global__ void __launch_bounds__(kTileThreads)
relayout_tile_kernel(const Tin* __restrict__ x, const int* __restrict__ s, Tout* __restrict__ o,
                     const Map m, float scale) {
  constexpr int L = R - 1;
  constexpr int kSteps = kTileI * kTileJ / kTileThreads;
  __shared__ uint16_t tile[kTileI * kTileRow];
  const int s0 = s ? __ldg(s) : 0;
  int shift[R];
  bool mirror[R];
  shifts<R>(m, s0, shift, mirror);
  const int J = m.unit;
  int nj = 1, shj = 0;
  bool mj = false;
  int64_t sj = 0, oj = 0;
#pragma unroll
  for (int d = 0; d < L; ++d) {
    if (d == J) nj = m.size[d], shj = shift[d], mj = mirror[d], sj = m.stride[d], oj = m.ostride[d];
  }
  const int ni = m.size[L];
  const int load_j = threadIdx.x % kTileJ, load_i = threadIdx.x / kTileJ;
  const int store_i = threadIdx.x % kTileI, store_j = threadIdx.x / kTileI;
  for (int t = blockIdx.x; t < m.tiles; t += gridDim.x) {
    const int q = quotient(t, m.by_tiles_i);
    const int it = t - q * m.tiles_i;
    int rest = quotient(q, m.by_tiles_j);
    const int jt = q - rest * m.tiles_j;
    int64_t row = m.base, orow = 0;
    int i0 = 0, c0 = 0;
#pragma unroll
    for (int d = L - 1; d >= 0; --d) {  // the other dims, from the tile's index
      if (d == J) continue;
      const int qd = quotient(rest, m.by_size[d]);
      const int id = rest - qd * m.size[d];
      rest = qd;
      const int c = coord(id, m.size[d], shift[d], mirror[d]);
      row += m.stride[d] * c;
      orow += m.ostride[d] * id;
      if (d == 0) i0 = id, c0 = c;
    }
    const int j0 = jt * kTileJ, ii0 = it * kTileI;
    {
      const int j = j0 + load_j;
      const bool j_in = j < nj;
      const int cj = j_in ? coord(j, nj, shj, mj) : 0;
      bool keep = true;
      if constexpr (kEp == kRowBelowS) keep = (J == 0 ? j : i0) < s0;
      if constexpr (kEp == kRowFlagCol0) {
        if (j_in) keep = to_f32(x[m.base + m.stride[0] * (J == 0 ? cj : c0)]) > 0.f;
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int ii = load_i + u * (kTileThreads / kTileJ);
        const int i = ii0 + ii;
        if (j_in && i < ni) {
          const int ci = coord(i, ni, shift[L], mirror[L]);
          tile[ii * kTileRow + load_j] =
              static_cast<uint16_t>(apply<kEp>(x[row + sj * cj + m.stride[L] * ci], keep, scale));
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int jj = store_j + u * (kTileThreads / kTileI);
      const int j = j0 + jj, i = ii0 + store_i;
      if (j < nj && i < ni) o[orow + oj * j + i] = static_cast<Tout>(tile[store_i * kTileRow + jj]);
    }
    __syncthreads();
  }
}

// The CTAs of kKernel that fit on the card at once, asked of the occupancy
// API once an instance and cached (0: the query failed).
template <auto kKernel, int kThreads>
int resident() {
  static const int blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads, 0) !=
            cudaSuccess) {
      return 0;
    }
    return per_sm * sms;
  }();
  return blocks;
}

template <int kEp, int R, typename Tin, typename Tout>
int launch_rank(int route, const void* x, const void* s, void* o, const Map& m, float scale,
                int k, cudaStream_t stream) {
  const auto* xi = static_cast<const Tin*>(x);
  const auto* si = static_cast<const int*>(s);
  auto* oi = static_cast<Tout*>(o);
  if (route == kTile) {
    if constexpr (R >= 2 && kEp != kAntidiagonal) {
      constexpr auto kernel = relayout_tile_kernel<kEp, R, Tin, Tout>;
      const int cap = resident<kernel, kTileThreads>();
      if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
      kernel<<<m.tiles < cap ? m.tiles : cap, kTileThreads, 0, stream>>>(xi, si, oi, m, scale);
      return static_cast<int>(cudaGetLastError());
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int E = 16 / sizeof(Tout);
  constexpr auto kernel = relayout_run_kernel<kEp, R, Tin, Tout>;
  const int cap = resident<kernel, kRunThreads>();
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (m.n + E - 1) / E;
  const int blocks = (words + kRunThreads - 1) / kRunThreads;
  kernel<<<blocks < cap ? blocks : cap, kRunThreads, 0, stream>>>(xi, si, oi, m, scale, k);
  return static_cast<int>(cudaGetLastError());
}

template <int kEp, typename Tin, typename Tout>
int launch(int rank, int route, const void* x, const void* s, void* o, const Map& m, float scale,
           int k, cudaStream_t stream) {
  switch (rank) {
    case 1: return launch_rank<kEp, 1, Tin, Tout>(route, x, s, o, m, scale, k, stream);
    case 2: return launch_rank<kEp, 2, Tin, Tout>(route, x, s, o, m, scale, k, stream);
    case 3: return launch_rank<kEp, 3, Tin, Tout>(route, x, s, o, m, scale, k, stream);
    default: return launch_rank<kEp, 4, Tin, Tout>(route, x, s, o, m, scale, k, stream);
  }
}

}  // namespace

// x: the input's elements (in_esize bytes each: 1 or 2; bf16 for
// epilogues 2 and 3, u8 for 1; unread by 4) on the device, in_numel of
// them, any alignment; s: int32 on the device, or null (s[0] taken as 0);
// o: the output (the map's elements, row-major; bf16, or x's element for
// a copy), 16-byte aligned, not overlapping x. plan (host memory, from
// ops/gather.py _relayout_plan): rank (1..4), route (0 run, 1 tile), base,
// the tile's unit-stride dim, then for each dim its size, stride, static
// roll and flags. Launches on `stream` and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for arguments outside those or a
// map whose reads leave [0, in_numel).
extern "C" int cn_relayout(const void* x, const void* s, void* o, const int64_t* plan,
                           int64_t in_numel, int in_esize, int epilogue, float scale, int k,
                           void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  Map m{};
  const int64_t rank = plan[0], route = plan[1];
  m.base = plan[2];
  if (rank < 1 || rank > kMaxDims || (route != kRun && route != kTile)) return kInvalid;
  int64_t n = 1, lo = m.base, hi = m.base;
  for (int d = 0; d < rank; ++d) {
    const int64_t size = plan[4 + 4 * d], stride = plan[5 + 4 * d];
    if (size < 1 || size > INT32_MAX) return kInvalid;
    m.size[d] = static_cast<int>(size);
    m.stride[d] = stride;
    m.roll[d] = static_cast<int>(((plan[6 + 4 * d] % size) + size) % size);
    m.flags[d] = static_cast<int>(plan[7 + 4 * d] & (kRollByS | kMirrorIfS));
    m.by_size[d] = fast_div(static_cast<uint32_t>(size));
    n *= size;
    if (n > INT32_MAX - 16) return kInvalid;  // every index and word start stays below 2^31
    (stride < 0 ? lo : hi) += stride * (size - 1);
  }
  if (epilogue != kAntidiagonal && (lo < 0 || hi >= in_numel)) return kInvalid;
  // s[0] is read only where a dim rolls or mirrors by it, or an epilogue
  // compares with it: a load that every address would wait for
  bool reads_s = epilogue == kRowBelowS;
  for (int d = 0; d < rank; ++d) reads_s = reads_s || m.flags[d] != 0;
  if (!reads_s) s = nullptr;
  if (reinterpret_cast<uintptr_t>(o) % 16 != 0) return kInvalid;
  m.n = static_cast<int>(n);
  for (int64_t d = rank - 1, step = 1; d >= 0; step *= m.size[d], --d) m.ostride[d] = step;
  if (route == kTile) {
    const int64_t unit = plan[3], last = rank - 1;
    if (rank < 2 || unit < 0 || unit >= last || epilogue == kAntidiagonal) return kInvalid;
    m.unit = static_cast<int>(unit);
    m.tiles_i = (m.size[last] + kTileI - 1) / kTileI;
    m.tiles_j = (m.size[unit] + kTileJ - 1) / kTileJ;
    m.tiles = static_cast<int>(n / m.size[last] / m.size[unit]) * m.tiles_i * m.tiles_j;
    m.by_tiles_i = fast_div(static_cast<uint32_t>(m.tiles_i));
    m.by_tiles_j = fast_div(static_cast<uint32_t>(m.tiles_j));
  }
  const int r = static_cast<int>(rank), rt = static_cast<int>(route);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kCopy:
      if (in_esize == 1) return launch<kCopy, uint8_t, uint8_t>(r, rt, x, s, o, m, scale, k, st);
      if (in_esize == 2) return launch<kCopy, uint16_t, uint16_t>(r, rt, x, s, o, m, scale, k, st);
      return kInvalid;
    case kScaleU8:
      if (in_esize != 1) return kInvalid;
      return launch<kScaleU8, uint8_t, uint16_t>(r, rt, x, s, o, m, scale, k, st);
    case kRowFlagCol0:
      if (in_esize != 2) return kInvalid;
      return launch<kRowFlagCol0, uint16_t, uint16_t>(r, rt, x, s, o, m, scale, k, st);
    case kRowBelowS:
      if (in_esize != 2) return kInvalid;
      return launch<kRowBelowS, uint16_t, uint16_t>(r, rt, x, s, o, m, scale, k, st);
    case kAntidiagonal:
      return launch<kAntidiagonal, uint16_t, uint16_t>(r, rt, nullptr, s, o, m, scale, k, st);
    default:
      return kInvalid;
  }
}
