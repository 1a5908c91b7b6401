// Stage 1 of the gather design of the per-image crop: crop, normalize and
// deinterleave each image into its K-major (rp, p) x (cpc, q) layout, and
// flip it horizontally where asked. For an image b of a row-major
// (B, H, L) input (L = 3 * width, channels interleaved) and a crop of
// 4P rows and 12Q elements (P = Q = 56: 224 x 224 pixels):
//
//   out[b, rp * P + p, cpc * Q + q] = f(x[b, oy[b] + 4p + rp, 3 * ox[b] + 12q' + cpc'])
//
// with cpc = 3 * cp + c, and q' = Q - 1 - q, cp' = 3 - cp where fl[b] > 0
// (pixel 4q + cp mirrored to 4Q - 1 - (4q + cp)), else q' = q, cp' = cp.
// f is bf16(__fsub_rn(__fmul_rn(f32(u8), scale), shift)) for a u8 input:
// the interpreter's order, a multiply and then a subtract, each rounded,
// no FMA; for a bf16 input (the probe p21) f is the identity. oy, ox and
// fl are int32 (B,) on the device (fl may be absent), so no launch waits
// for the host.
//
// Replaces tools/r5_probe_gather2.py:126 p21 (the stage-1 deinterleave
// chain on a bf16 (224, 672) crop), tools/r5_probe_gather3.py:229 p24 (the
// composite: u8 rows, normalize, the ox crop, the deinterleaves, the flip
// by fl[b]) and tools/r5_probe_gather4.py:219 p31 (composite v2: the whole
// image, the oy and ox crops, normalize, deinterleave, no flip); ROADMAP
// Queue B rows 19, 25 and 29. p24's input BlockSpec is Blocked, so its
// index map's oy counts 224-row blocks and only oy = 0 lies inside a
// 256-row image; the kernel takes oy in rows, as p31 and the design do.
// So it is held to p24's interpreter run at oy = 0, and to p31's at oy
// and ox in 0..32.
//
// Bounds: an image whose crop leaves its input (oy < 0, oy + 4P > H, ox <
// 0 or 3 * ox + 12Q > L) reads nothing and is written as NaN, whole, as
// the input prologue kernel (s2d_prologue.cu) does.
//
// Bound: device-memory bytes, the crop read once (1 byte an element) and
// the bf16 output written once; two f32 operations an element. At the
// bench's batch of 4096: 617 MB in, 1.23 GB out, 0.55 ms at 3.35 TB/s.
//
// What held the first version back (one 256-thread CTA an output row,
// grid (4P, B): 0.21 of the bound at 4096): 917,504 CTAs of 672 bytes in
// and 1,344 out, each paying a start-up, a barrier and a tail (672
// elements over 256 threads is 2.6 passes); byte loads, one in flight a
// thread, about 270 KB in flight on the card where 3.35 TB/s over a
// round trip of about 0.7 us needs about 2.3 MB; 2-byte stores, and two
// integer divides an element (c / q with q known only at run time).
//
// Design for Hopper:
// - A work item is kItemRows consecutive crop rows of one image (crop row
//   j = 4pp + rp feeds output row rp * P + pp), halved while the items are
//   fewer than the SMs (a single block: one row an item, 224 CTAs). A
//   persistent grid (the CTAs that fit on the card with the item's shared
//   memory, from the occupancy API, cached) walks the items.
// - Staging: each crop row goes into shared memory as the aligned 16-byte
//   words that cover it (none that holds none of its bytes), by cp.async,
//   double-buffered: the next item's words are in flight while the current
//   one is built. 3 * ox puts a row at any byte of its first word; the
//   build reads from that byte on, so nothing is shifted.
// - Build and write: a thread takes one 16-byte output word, 8 consecutive
//   elements of one output row. Where q % 8 == 0 (the probes' 56) they
//   share one cpc: 8 staged elements at a stride of 12 (-12 flipped), the
//   chain in f32 registers, and one 16-byte store. Each index is split once
//   a word by a multiply-high (FastDiv, span.cuh), never per element. For
//   another even q a word may cross from one cpc to the next, and steps qq
//   and cpc element by element; an odd q (rows off a 16-byte boundary) or
//   an output off one writes element by element. An image whose crop
//   leaves its input stages nothing and its rows are NaN words.
// - Shared memory: two buffers of `rows` slots, a slot the row's bytes plus
//   15, rounded up to 16 (22 KB at the probes' u8 rows). The item narrows
//   until both buffers fit 227 KB.
//
// Alternatives measured on the card (PERF.md, PR 16): at batch 4096 items
// of 4 crop rows took 0.73-0.77 ms, of 8 0.708-0.723, of 16 and 32
// 0.695-0.709 whatever the CTA (128 to 1024 threads); a copy that skips
// the build (no shared-memory reads, no arithmetic) took 0.686-0.691, so
// the build is not what bounds the kernel. At one block, more and smaller
// CTAs won: one row an item (224 CTAs of 256 threads) 0.0031 ms, against
// 0.0032-0.0044 for 4 to 16 rows or 512 threads; at 8 images, more items
// than the CTAs that fit at once (a second wave) lost 1.7x. Hence 256
// threads and 16 rows, halved while the items are fewer than the SMs.
// This design: 0.70-0.71 ms at 4096, 0.78 of the bound.
//
// nvcc -Xptxas -v (sm_90a, NVIDIA H100 build): 29-32 registers, 0 bytes
// stack frame, 0 bytes spill stores and loads, one barrier in each of the
// four instances (u8 and bf16, whole words or not). Shared memory is
// dynamic only: 22,016 bytes a CTA at the probes' u8 rows (2 x 16 slots
// of 688), 2,720 at P21 (2 x 1 bf16 slot of 1,360).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

#include "span.cuh"
#include "stage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItemRows = 16;                   // crop rows of an item, at most
constexpr int kRowPhases = 4, kColPhases = 12;  // stride 4, 3 channels
constexpr int kWord = 8;                        // bf16 output elements a 16-byte word
constexpr uint32_t kNanPair = 0x7fc07fc0u;      // two bf16 NaN, as the plain version writes

struct Shape {
  const unsigned char* x;
  const int* oy;
  const int* ox;
  const int* fl;  // null: no flips
  uint16_t* o;    // bf16 bits
  int h, l, p, q;
  int64_t pitch;   // bytes of an input row
  int row_bytes;   // bytes of a crop row: 12q elements
  int item_rows;   // crop rows of an item
  int per_image;   // items of an image: ceil(4p / item_rows)
  int items;       // b * per_image
  int slot_bytes;  // staged bytes of a crop row, a multiple of 16
  int slot_words;  // slot_bytes / 16
  int row_words;   // 16-byte words of an output row: ceil(12q / 8)
  int vec;         // 16-byte stores: q even and o on a 16-byte boundary
  int normalize;
  float scale, shift;
  FastDiv by_per_image, by_slot_words, by_row_words, by_q, by_qw;  // by_qw: q / 8
};

// Work item `it`: image b, crop rows [j0, j0 + rows) (crop row j = 4pp + rp
// feeds output row rp * p + pp), the flip, and the address of crop row
// j0's first element (0: the crop leaves x).
struct Item {
  int b, j0, rows, flip;
  uintptr_t src;
};

template <int kEs>
__device__ __forceinline__ Item item_of(const Shape& s, int it) {
  Item t;
  t.b = quotient(it, s.by_per_image);
  t.j0 = (it - t.b * s.per_image) * s.item_rows;
  t.rows = min(s.item_rows, kRowPhases * s.p - t.j0);
  t.flip = s.fl != nullptr && __ldg(s.fl + t.b) > 0;
  const int64_t y0 = __ldg(s.oy + t.b), x0 = 3 * static_cast<int64_t>(__ldg(s.ox + t.b));
  const bool inside = y0 >= 0 && y0 + kRowPhases * s.p <= s.h && x0 >= 0 &&
                      x0 + kColPhases * s.q <= s.l;
  const int64_t first = (static_cast<int64_t>(t.b) * s.h + y0 + t.j0) * s.l + x0;
  t.src = inside ? reinterpret_cast<uintptr_t>(s.x) + static_cast<uintptr_t>(first * kEs) : 0;
  return t;
}

// Start copying item t's crop rows into buf, crop row j0 + j into slot j
// as the aligned 16-byte words that cover it, by cp.async in one commit
// group (nothing for a crop outside x). Visible to the block after
// cp_async_wait_all and the next __syncthreads.
__device__ __forceinline__ void stage_item(const Shape& s, const Item& t, unsigned char* buf) {
  if (t.src) {
    const int n = t.rows * s.slot_words;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int j = quotient(i, s.by_slot_words);
      const int w = i - j * s.slot_words;
      const uintptr_t a = t.src + static_cast<uintptr_t>(j * s.pitch);
      const uintptr_t word = (a & ~uintptr_t{15}) + 16 * static_cast<uintptr_t>(w);
      if (word < a + s.row_bytes) {
        cp_async16(buf + j * s.slot_bytes + 16 * w, reinterpret_cast<const void*>(word));
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Staged element e of a row, as f32: a byte placed under 2^23's exponent,
// minus 2^23 (exact for 0..255, as static_cast<float> of the byte), or a
// bf16 widened.
template <typename Tin>
__device__ __forceinline__ float staged(const unsigned char* row, int e);

template <>
__device__ __forceinline__ float staged<uint8_t>(const unsigned char* row, int e) {
  return __fsub_rn(__uint_as_float(0x4b000000u | row[e]), 8388608.0f);
}

template <>
__device__ __forceinline__ float staged<__nv_bfloat16>(const unsigned char* row, int e) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[e]);
}

// f: (v * scale) - shift, each rounded, where the input is normalized.
__device__ __forceinline__ float chain(float v, const Shape& s) {
  return s.normalize ? __fsub_rn(__fmul_rn(v, s.scale), s.shift) : v;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 8 elements e0 + k * kStep (k = 0..7) of a staged row through f, as
// four bf16 pairs.
template <typename Tin, int kStep>
__device__ __forceinline__ void run8(const Shape& s, const unsigned char* row, int e0,
                                     uint32_t* pk) {
#pragma unroll
  for (int k = 0; k < kWord; k += 2) {
    pk[k / 2] = bf16_pair(chain(staged<Tin>(row, e0 + k * kStep), s),
                          chain(staged<Tin>(row, e0 + (k + 1) * kStep), s));
  }
}

// Build item t from buf and write it: a thread a 16-byte output word (from
// slot j, elements 8w .. 8w + 7 of its output row). kWhole: q % 8 == 0
// and o on a 16-byte boundary, so a word lies in one cpc and is stored
// whole.
template <typename Tin, bool kWhole>
__device__ __forceinline__ void build_item(const Shape& s, const Item& t,
                                           const unsigned char* buf) {
  const int cw = kColPhases * s.q;
  const int n = t.rows * s.row_words;
  for (int u = threadIdx.x; u < n; u += blockDim.x) {
    const int j = quotient(u, s.by_row_words);
    const int c0 = kWord * (u - j * s.row_words);
    const int jc = t.j0 + j;  // 4pp + rp
    uint16_t* dst = s.o + (static_cast<int64_t>(t.b) * kRowPhases * s.p + (jc & 3) * s.p +
                           (jc >> 2)) * cw + c0;
    uint32_t pk[kWord / 2] = {kNanPair, kNanPair, kNanPair, kNanPair};
    if (t.src) {
      const uintptr_t a = t.src + static_cast<uintptr_t>(j * s.pitch);
      const unsigned char* row = buf + j * s.slot_bytes + (a & 15);
      if constexpr (kWhole) {
        const int cpc = quotient(c0 / kWord, s.by_qw);
        const int qq = c0 - cpc * s.q;
        const int cp = cpc / 3, ch = cpc - 3 * cp;
        if (t.flip) {
          run8<Tin, -kColPhases>(s, row, kColPhases * (s.q - 1 - qq) + 3 * (3 - cp) + ch, pk);
        } else {
          run8<Tin, kColPhases>(s, row, kColPhases * qq + cpc, pk);
        }
      } else {
        int cpc = quotient(c0, s.by_q);
        int qq = c0 - cpc * s.q;
        float v[kWord];
#pragma unroll
        for (int k = 0; k < kWord; ++k) {
          v[k] = 0.0f;
          if (c0 + k < cw) {
            const int cp = cpc / 3, ch = cpc - 3 * cp;
            const int e = t.flip ? kColPhases * (s.q - 1 - qq) + 3 * (3 - cp) + ch
                                 : kColPhases * qq + cpc;
            v[k] = chain(staged<Tin>(row, e), s);
          }
          if (++qq == s.q) qq = 0, ++cpc;
        }
#pragma unroll
        for (int k = 0; k < kWord; k += 2) pk[k / 2] = bf16_pair(v[k], v[k + 1]);
      }
    }
    if (kWhole || (s.vec && c0 + kWord <= cw)) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kWord; ++k) {
        if (c0 + k < cw) dst[k] = static_cast<uint16_t>(pk[k / 2] >> (16 * (k & 1)));
      }
    }
  }
}

template <typename Tin, bool kWhole>
__global__ void __launch_bounds__(kThreads) crop_deinterleave_kernel(Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kEs = sizeof(Tin);
  const int buf_bytes = s.item_rows * s.slot_bytes;
  int it = blockIdx.x;
  Item cur = item_of<kEs>(s, it);
  stage_item(s, cur, smem);
  for (int k = 0; it < s.items; it += gridDim.x, ++k) {
    cp_async_wait_all();
    __syncthreads();  // item k staged; item k - 1 built, so its buffer is free
    const int next = it + gridDim.x;
    const Item nxt = next < s.items ? item_of<kEs>(s, next) : Item{0, 0, 0, 0, 0};
    stage_item(s, nxt, smem + ((k + 1) & 1) * buf_bytes);
    build_item<Tin, kWhole>(s, cur, smem + (k & 1) * buf_bytes);
    cur = nxt;
  }
}

// Launch one instance on a persistent grid: as many CTAs as fit on the card
// at once with this shared memory (the occupancy API, asked again only
// when the shared memory changes), at most one an item.
template <typename Tin, bool kWhole>
int launch(const Shape& s, int smem, cudaStream_t stream) {
  auto kernel = crop_deinterleave_kernel<Tin, kWhole>;
  static std::mutex mu;
  static int cached_smem = -1;
  static int resident = 0;
  int blocks = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (cached_smem != smem) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      }
      if (err == cudaSuccess && smem > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      }
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
      cached_smem = smem;
      resident = per_sm * sms;
    }
    blocks = s.items < resident ? s.items : resident;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(s);
  return static_cast<int>(cudaGetLastError());
}

// The card's SMs (0 where the query fails), asked once.
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      return 0;
    }
    return n;
  }();
  return sms;
}

template <typename Tin>
int launch_for(const Shape& s, int whole, int smem, cudaStream_t stream) {
  return whole ? launch<Tin, true>(s, smem, stream) : launch<Tin, false>(s, smem, stream);
}

}  // namespace

// x: (b, h, l) u8 (is_bf16 0) or bf16 (is_bf16 1) on the device, any
// alignment; oy, ox: int32 (b,) on the device; fl: int32 (b,) or null; o:
// bf16 (b, 4p, 12q), not overlapping x. normalize applies (v * scale) -
// shift. Launches on `stream` and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for arguments outside those (b
// above 65535 or 4p above 65535, as the first version's grid took; a crop
// row too long for two buffers in 227 KB: q above 4842 in bf16, 9684 in
// u8, where the first version took 2048 and 4096).
extern "C" int cn_crop_deinterleave(const void* x, const void* oy, const void* ox, const void* fl,
                                    void* o, int b, int h, int l, int p, int q, int is_bf16,
                                    int normalize, float scale, float shift, void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || l <= 0 || p <= 0 || q <= 0 || kRowPhases * p > 65535 ||
      oy == nullptr || ox == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int es = is_bf16 ? 2 : 1;
  const int64_t row_bytes = static_cast<int64_t>(kColPhases) * q * es;
  const int64_t slot = static_cast<int64_t>(align_up16(static_cast<size_t>(row_bytes + 15)));
  // kItemRows crop rows an item, fewer where two buffers of them would not
  // fit, and halved while there are fewer items than SMs
  const int crop_rows = kRowPhases * p;
  int rows = static_cast<int>(std::min<int64_t>(std::min(kItemRows, crop_rows),
                                                kMaxSmemPerBlock / (2 * slot)));
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  while (rows > 1 && static_cast<int64_t>(b) * ((crop_rows + rows - 1) / rows) < sm_count()) {
    rows /= 2;
  }
  const int64_t smem = 2 * rows * slot;

  Shape s;
  s.x = static_cast<const unsigned char*>(x);
  s.oy = static_cast<const int*>(oy);
  s.ox = static_cast<const int*>(ox);
  s.fl = static_cast<const int*>(fl);
  s.o = static_cast<uint16_t*>(o);
  s.h = h, s.l = l, s.p = p, s.q = q;
  s.pitch = static_cast<int64_t>(l) * es;
  s.row_bytes = static_cast<int>(row_bytes);
  s.item_rows = rows;
  s.per_image = (crop_rows + rows - 1) / rows;
  s.items = b * s.per_image;
  s.slot_bytes = static_cast<int>(slot);
  s.slot_words = s.slot_bytes / 16;
  s.row_words = (kColPhases * q + kWord - 1) / kWord;
  const bool aligned_o = reinterpret_cast<uintptr_t>(o) % 16 == 0;
  s.vec = aligned_o && q % 2 == 0;
  s.normalize = normalize != 0;
  s.scale = scale, s.shift = shift;
  s.by_per_image = fast_div(static_cast<uint32_t>(s.per_image));
  s.by_slot_words = fast_div(static_cast<uint32_t>(s.slot_words));
  s.by_row_words = fast_div(static_cast<uint32_t>(s.row_words));
  s.by_q = fast_div(static_cast<uint32_t>(q));
  s.by_qw = fast_div(static_cast<uint32_t>(q >= kWord ? q / kWord : 1));
  const int whole = aligned_o && q % kWord == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const int bytes = static_cast<int>(smem);
  return is_bf16 ? launch_for<__nv_bfloat16>(s, whole, bytes, st)
                 : launch_for<uint8_t>(s, whole, bytes, st);
}
