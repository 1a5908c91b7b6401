// Input prologue of the serving and train paths: raw uint8 images -> the
// first conv's space-to-depth input, in one pass.
//
// Replaces the TPU kernel convnet_tpu/ops/s2d_relayout.py:200
// _relayout_kernel and the XLA one-hot crop einsums that feed it
// (jitter_crop_phased, s2d_relayout.py:79), and the train prologue's two
// other forms, convnet_tpu/ops/prologue.py:93 _prologue_kernel and
// convnet_tpu/ops/jitter_gather.py:96 _gather_kernel. On the TPU a
// per-image gather had to be written as batched one-hot matmuls into a
// phase-major intermediate, which the Pallas kernel then transposed. Here
// a block gathers its own rows, so neither the contraction nor the
// intermediate exists.
//
// For x uint8 (B, H, W, C), per-image crop origins oy, ox and optional
// flips, the output is bf16 (B, P, P, s*s*C), channel order (row-phase,
// col-phase, cin) -- the S2DInput that conv1 reads as channels_last.
// Output element (b, p, q, (rp*s + cp)*C + ci) holds cropped pixel
// (t_r, t_c) = (s*p + rp, s*q + cp) of channel ci, or exactly 0 where
// t_r or t_c lies past the crop (the ceil-mode pad). The pixel is
// normalised in f32 as v*scale, then -mean[ci], then /std[ci], in that
// order and each step rounded on its own (no FMA contraction, a true
// division), which is what the JAX package's jitter_s2d computes
// (s2d_relayout.py:171-181), so the result is bit-exact with it. A crop
// that leaves the image (the caller broke its contract) gives NaN there.
//
// Bound: device-memory bytes. At AlexNet, batch 128, crop 224, stride 4,
// it reads the 19.3 MB of the crops and writes 40 MB of bf16 (0.0177 ms at
// 3.35 TB/s). The first version (one thread per output element, seven
// integer divisions, a 1-byte gather and a 2-byte store an element, a true
// division per element with a std) ran at 9% of that.
//
// Design for Hopper:
// - A work item is 4 output rows (b, p) -- P*s*s*C contiguous bf16 each,
//   5,472 bytes at AlexNet -- or a run of one row's columns where its crop
//   rows would not fit the staging budget. A persistent grid, sized by the
//   occupancy API, walks the items.
// - Read: the s crop rows that feed each output row (4 x 224 x 3 = 2,688
//   bytes at AlexNet) are staged in shared memory as the aligned 16-byte
//   words that cover them (a row starts at any byte), by cp.async, a warp a
//   crop row, double-buffered: the next item's words are in flight while
//   the current one is built.
// - Build, then write: a thread takes one run, the s*C output elements of
//   one column q and row-phase rp, which come from s consecutive pixels of
//   staged row rp, and writes them into the item's output rows in shared
//   memory; after a barrier the block writes those rows out with 16-byte
//   stores (element-wise where the output is not aligned). One division a
//   run, none an element.
// - AlexNet's stride 4 and 3 channels are compile-time: a run is 12
//   contiguous staged bytes (in reverse pixel order when flipped), brought
//   into registers by four 4-byte loads and a funnel shift, and normalised
//   by the exact chain in f32 registers (a byte becomes its f32 value by a
//   byte permute and one subtraction), two bf16 a 4-byte store.
// - With a std the chain has a division: the bf16 of every (value,
//   channel) pair, computed once per block by the exact chain, is a 256 x C
//   table in shared memory (768 entries at C = 3), so each element is one
//   lookup and bit-exact by construction. Without one, a lookup (a byte
//   and a table entry read from shared memory an element, with bank
//   conflicts) costs more than the three operations it saves: the versions
//   measured are in PERF.md.
// - A run that the crop or the image cuts (the ceil-mode pad, a crop outside
//   the image), and any other stride or channel count, goes element by
//   element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kItemRows = 4;           // output rows of one work item
constexpr int kStageBytes = 8 * 1024;  // staging budget of one output row (one buffer)
constexpr int kMaxTableC = 64;         // channels up to which values go through a table
constexpr int kMaxSmemPerBlock = 227 * 1024;

__host__ __device__ constexpr int64_t align_up16(int64_t bytes) {
  return (bytes + 15) & ~int64_t{15};
}

struct Geometry {
  int b, h, w, c, crop, s, p;
  int k;           // s*s*c, the output's channels
  int seg_cols;    // output columns of one work item
  int segs;        // column segments of one output row
  int item_rows;   // output rows of one work item (1 when segs > 1)
  int slot_bytes;  // staged bytes of one crop row of an item, a multiple of 16
  int table;       // entries of the value table (0: no table)
  int rows;        // b*p output rows
  int items;       // ceil(rows / item_rows) * segs
  int64_t x_bytes;
};

struct Args {
  const uint8_t* x;
  const int32_t* oy;
  const int32_t* ox;
  const uint8_t* flip;
  const float* mean;
  const float* stdev;
  uint16_t* out;  // bf16 bits
  float scale;
  int aligned_out;
};

// Where a staged crop row lies: the in-image source columns [c_lo, c_hi)
// its item needs, the byte offset of c_lo in the first staged word (lead)
// and whether the source row is inside the image.
struct SlotInfo {
  int c_lo, c_hi, lead, row_ok;
};

// An output row (b, pr) of an item, with its image's crop column origin
// and flip.
struct RowInfo {
  int pr, ox, flip, pad;
};

struct Span {
  SlotInfo info;
  uintptr_t first_word;  // the aligned address of the first staged word
  int words;
};

// Work item `it`: output rows [row0, row0 + nrows), their columns
// [q0, q1), and the crop columns [t0, t1) those read.
struct Item {
  int row0, nrows, q0, q1, t0, t1;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The exact chain: v*scale, -mean, /std, each rounded on its own.
__device__ __forceinline__ float normalise(int v, int ci, const Args& a) {
  float f = static_cast<float>(v);
  if (a.scale != 1.0f) f = __fmul_rn(f, a.scale);
  if (a.mean) f = __fsub_rn(f, a.mean[ci]);
  if (a.stdev) f = __fdiv_rn(f, a.stdev[ci]);
  return f;
}

__device__ __forceinline__ Item item_of(const Geometry& g, int it) {
  Item t;
  const int group = it / g.segs;
  t.row0 = group * g.item_rows;
  t.nrows = min(g.item_rows, g.rows - t.row0);
  t.q0 = (it - group * g.segs) * g.seg_cols;
  t.q1 = min(t.q0 + g.seg_cols, g.p);
  t.t0 = g.s * t.q0;
  t.t1 = min(g.s * t.q1, g.crop);
  return t;
}

// The span of crop row t_r = s*pr + rp of output row `row` that item t
// reads.
__device__ __forceinline__ Span span_of(const Geometry& g, const Args& a, const Item& t, int row,
                                        int rp) {
  Span sp{{0, 0, 0, 0}, 0, 0};
  const int b = row / g.p;
  const int tr = g.s * (row - b * g.p) + rp;
  if (tr >= g.crop || t.t0 >= t.t1) return sp;  // only zeros come from it
  const int src_row = a.oy[b] + tr;
  const int ox = a.ox[b];
  const bool flip = a.flip && a.flip[b];
  const int lo = flip ? ox + g.crop - t.t1 : ox + t.t0;
  const int hi = flip ? ox + g.crop - t.t0 : ox + t.t1;
  sp.info.c_lo = max(lo, 0);
  sp.info.c_hi = min(hi, g.w);
  sp.info.row_ok = src_row >= 0 && src_row < g.h;
  if (!sp.info.row_ok || sp.info.c_lo >= sp.info.c_hi) return sp;
  const int64_t start = ((static_cast<int64_t>(b) * g.h + src_row) * g.w + sp.info.c_lo) * g.c;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.x + start);
  sp.first_word = addr & ~uintptr_t{15};
  sp.info.lead = static_cast<int>(addr - sp.first_word);
  sp.words = (sp.info.lead + (sp.info.c_hi - sp.info.c_lo) * g.c + 15) / 16;
  return sp;
}

// Start staging item `it`: its nrows*s crop rows into `stage` (slot r*s +
// rp of slot_bytes each) by 16-byte cp.async copies in one commit group
// (plain byte copies for a word that reaches past either end of x), and
// the slots' and rows' infos. A warp takes a slot, so each span is found
// once a warp. Visible to the block after cp.async.wait_group 0 and the
// next __syncthreads.
__device__ __forceinline__ void stage_item(const Geometry& g, const Args& a, int it,
                                           unsigned char* stage, SlotInfo* slots,
                                           RowInfo* rows) {
  const Item t = item_of(g, it);
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  for (int r = tid; r < t.nrows; r += blockDim.x) {
    const int row = t.row0 + r;
    const int b = row / g.p;
    rows[r] = RowInfo{row - b * g.p, a.ox[b], a.flip && a.flip[b], 0};
  }
  const uintptr_t x0 = reinterpret_cast<uintptr_t>(a.x);
  const uintptr_t x1 = x0 + static_cast<uintptr_t>(g.x_bytes);
  for (int slot = tid >> 5; slot < t.nrows * g.s; slot += blockDim.x >> 5) {
    const int r = slot / g.s;
    const Span sp = span_of(g, a, t, t.row0 + r, slot - r * g.s);
    if (lane == 0) slots[slot] = sp.info;
    for (int w = lane; w < sp.words; w += 32) {
      const uintptr_t src = sp.first_word + 16 * static_cast<uintptr_t>(w);
      unsigned char* dst = stage + slot * g.slot_bytes + 16 * w;
      if (src >= x0 && src + 16 <= x1) {
        cp_async16(dst, reinterpret_cast<const void*>(src));
      } else {
        for (int i = 0; i < 16; ++i) {
          if (src + i >= x0 && src + i < x1) dst[i] = *reinterpret_cast<const uint8_t*>(src + i);
        }
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Byte j of the 12 bytes u[0..2] hold, as the f32 value it is: its bits
// placed under 2^23's exponent, minus 2^23 (exact for 0..255, as
// static_cast<float> of the byte). j is a constant wherever it is called
// (unrolled loops), so u stays in registers.
__device__ __forceinline__ float byte_value(const uint32_t* u, int j) {
  return __fsub_rn(__int_as_float(__byte_perm(u[j >> 2], 0x4b000000u, 0x7650 | (j & 3))),
                   8388608.0f);
}

// Build item t's output elements in shared memory (row r's element j of
// the item at outbuf[r * (q1 - q0) * K + j]) from its staged rows. A
// thread takes one run: output row r, column q and row-phase rp, the s*C
// elements (col-phase, channel) that come from s consecutive pixels of
// staged row (r, rp). S and C: the stride and channels at compile time
// (only without a std, which goes through the table), or 0 to read them
// from g. mean_c: the mean at compile-time C (0 without).
template <bool TABLE, int S, int C>
__device__ __forceinline__ void build_item(const Geometry& g, const Args& a, const Item& t,
                                           const unsigned char* stage, const SlotInfo* slots,
                                           const RowInfo* rows, const uint16_t* table,
                                           const float* mean_c, uint16_t* outbuf) {
  const int s = S > 0 ? S : g.s;
  const int c = C > 0 ? C : g.c;
  const int run = s * c;
  const int row_runs = (t.q1 - t.q0) * s;
  const uint16_t nan_bits = bf16_bits(NAN);
  for (int u = threadIdx.x; u < t.nrows * row_runs; u += blockDim.x) {
    const int r = u / row_runs;
    const int qq = (u - r * row_runs) / s;
    const int rp = u - r * row_runs - qq * s;
    const RowInfo ri = rows[r];
    const int tr = s * ri.pr + rp;
    const SlotInfo si = slots[r * s + rp];
    const unsigned char* slot = stage + (r * s + rp) * g.slot_bytes;
    uint16_t* dst = outbuf + u * run;  // r*(q1 - q0)*K + (q - q0)*K + rp*s*C
    const int tc0 = s * (t.q0 + qq);
    if constexpr (S > 0 && C > 0 && (S * C) % 2 == 0 && S * C <= 12) {
      // the run's S pixels all inside the crop and the image: their S*C
      // bytes are contiguous in the staged row (in reverse pixel order
      // when flipped); four 4-byte loads and a funnel shift bring them
      // into registers, and the chain runs in f32 arithmetic
      const int col_lo = ri.flip ? ri.ox + g.crop - tc0 - S : ri.ox + tc0;
      if (tr < g.crop && tc0 + S <= g.crop && si.row_ok && col_lo >= si.c_lo &&
          col_lo + S <= si.c_hi) {
        const int base = si.lead + (col_lo - si.c_lo) * C;
        const uint32_t* w = reinterpret_cast<const uint32_t*>(slot + (base & ~3));
        const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
        const int sh = 8 * (base & 3);
        const uint32_t bytes[3] = {__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                                   __funnelshift_r(w2, w3, sh)};
        float v[S * C];
#pragma unroll
        for (int cp = 0; cp < S; ++cp) {
#pragma unroll
          for (int ci = 0; ci < C; ++ci) {
            const float in = ri.flip ? byte_value(bytes, (S - 1 - cp) * C + ci)
                                     : byte_value(bytes, cp * C + ci);
            // v*scale, then -mean: a scale of 1 and a mean of 0 change
            // nothing, so no branch on either
            v[cp * C + ci] = __fsub_rn(__fmul_rn(in, a.scale), mean_c[ci]);
          }
        }
#pragma unroll
        for (int e = 0; e < S * C; e += 2) {
          const __nv_bfloat162 pair = __floats2bfloat162_rn(v[e], v[e + 1]);
          reinterpret_cast<uint32_t*>(dst)[e / 2] = *reinterpret_cast<const uint32_t*>(&pair);
        }
        continue;
      }
    }
    // element by element: a run that the crop or the image cuts, a std
    // (through the table), any stride and channels
    const unsigned char* srow = slot + si.lead;
    for (int cp = 0; cp < s; ++cp) {
      const int tc = tc0 + cp;
      const int col = ri.flip ? ri.ox + g.crop - 1 - tc : ri.ox + tc;
      const bool inside = tr < g.crop && tc < g.crop;
      const bool in_image = si.row_ok && col >= si.c_lo && col < si.c_hi;
      for (int ci = 0; ci < c; ++ci) {
        uint16_t out = 0;
        if (inside) {
          if (!in_image) {
            out = nan_bits;
          } else {
            const int byte = srow[(col - si.c_lo) * c + ci];
            if constexpr (TABLE) {
              out = table[byte * c + ci];
            } else {
              out = bf16_bits(normalise(byte, ci, a));
            }
          }
        }
        dst[cp * c + ci] = out;
      }
    }
  }
}

// Copy item t's built elements from outbuf to the output (one contiguous
// range: an item of several rows spans whole rows), with 16-byte stores
// where the output allows them.
__device__ __forceinline__ void flush_item(const Geometry& g, const Args& a, const Item& t,
                                           const uint16_t* outbuf) {
  const int n = t.nrows * (t.q1 - t.q0) * g.k;
  uint16_t* dst = a.out + (static_cast<int64_t>(t.row0) * g.p + t.q0) * g.k;
  int done = 0;
  if (a.aligned_out && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    const int words = n / 8;
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(outbuf)[i];
    }
    done = 8 * words;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = outbuf[i];
}

template <bool TABLE, int S, int C>
__global__ void __launch_bounds__(kThreads)
s2d_prologue_kernel(Geometry g, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [table][stage 0][stage 1][slots 0][slots 1][rows 0][rows 1][outbuf],
  // each 16-byte aligned
  uint16_t* table = reinterpret_cast<uint16_t*>(smem);
  unsigned char* stage0 = smem + align_up16(static_cast<int64_t>(g.table) * 2);
  const int nslots = g.item_rows * g.s;
  const int stage_bytes = nslots * g.slot_bytes;
  SlotInfo* slots0 = reinterpret_cast<SlotInfo*>(stage0 + 2 * stage_bytes);
  RowInfo* rows0 = reinterpret_cast<RowInfo*>(slots0 + 2 * nslots);
  uint16_t* outbuf = reinterpret_cast<uint16_t*>(rows0 + 2 * g.item_rows);
  // buffer k & 1 of the double-buffered staging
  auto stage = [&](int k) { return stage0 + (k & 1) * stage_bytes; };
  auto slots = [&](int k) { return slots0 + (k & 1) * nslots; };
  auto rows = [&](int k) { return rows0 + (k & 1) * g.item_rows; };
  if constexpr (TABLE) {
    for (int i = threadIdx.x; i < g.table; i += blockDim.x) {
      const int v = i / g.c;
      table[i] = bf16_bits(normalise(v, i - v * g.c, a));
    }
  }
  float mean_c[C > 0 ? C : 1];
#pragma unroll
  for (int ci = 0; ci < (C > 0 ? C : 1); ++ci) mean_c[ci] = C > 0 && a.mean ? a.mean[ci] : 0.0f;
  int it = blockIdx.x;
  if (it < g.items) stage_item(g, a, it, stage(0), slots(0), rows(0));
  for (int k = 0; it < g.items; it += gridDim.x, ++k) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // item k staged (the table filled); item k - 1 flushed
    const int next = it + gridDim.x;
    if (next < g.items) stage_item(g, a, next, stage(k + 1), slots(k + 1), rows(k + 1));
    const Item t = item_of(g, it);
    build_item<TABLE, S, C>(g, a, t, stage(k), slots(k), rows(k), table, mean_c, outbuf);
    __syncthreads();  // item k built
    flush_item(g, a, t, outbuf);
  }
}

// Launch one instantiation on a persistent grid: as many blocks as fit on
// the card at once with this shared memory (the occupancy API, asked again
// only when the shared memory changes), at most one an item.
template <bool TABLE, int S, int C>
int launch(const Geometry& g, const Args& a, int64_t smem, cudaStream_t stream) {
  auto kernel = s2d_prologue_kernel<TABLE, S, C>;
  static std::mutex mu;
  static int64_t cached_smem = -1;
  static int resident = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (cached_smem != smem) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess && smem > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
      }
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                            static_cast<size_t>(smem));
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
      cached_smem = smem;
      resident = per_sm * sms;
    }
  }
  const int blocks = g.items < resident ? g.items : resident;
  kernel<<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(g, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: uint8 (b, h, w, c) contiguous; oy, ox: int32 (b,); flip: uint8 (b,) or
// null; mean, stdev: f32 (c,) or null; out: bf16 (b, p, p, s*s*c)
// contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int cn_s2d_prologue(const void* x, const void* oy, const void* ox,
                               const void* flip, const void* mean, const void* stdev,
                               void* out, int b, int h, int w, int c, int crop, int s,
                               int p, float scale, void* stream) {
  if (b <= 0 || c <= 0 || s <= 0 || p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.b = b, g.h = h, g.w = w, g.c = c, g.crop = crop, g.s = s, g.p = p;
  g.k = s * s * c;
  // as many output columns an item as keep an output row's s staged crop
  // rows (each s*C bytes a column, plus up to 15 bytes of lead) within
  // kStageBytes; kItemRows whole rows an item when one segment covers a row
  const int64_t per_slot = kStageBytes / s;
  int64_t cols = (per_slot - 16) / (static_cast<int64_t>(s) * c);
  cols = cols < 1 ? 1 : (cols > p ? p : cols);
  g.seg_cols = static_cast<int>(cols);
  g.segs = (p + g.seg_cols - 1) / g.seg_cols;
  g.item_rows = g.segs == 1 ? kItemRows : 1;
  const int64_t span = (s * cols < crop ? s * cols : crop) * static_cast<int64_t>(c);
  g.slot_bytes = static_cast<int>(align_up16(span + 15));
  // a table only where the chain has a division: with a std
  g.table = stdev && c <= kMaxTableC ? 256 * c : 0;
  g.x_bytes = static_cast<int64_t>(b) * h * w * c;
  const int64_t rows = static_cast<int64_t>(b) * p;
  const int64_t items = (rows + g.item_rows - 1) / g.item_rows * g.segs;
  if (rows > 0x7fffffff || items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  g.rows = static_cast<int>(rows);
  g.items = static_cast<int>(items);
  const int64_t nslots = static_cast<int64_t>(g.item_rows) * s;
  const int64_t smem = align_up16(static_cast<int64_t>(g.table) * 2) +
                       2 * nslots * g.slot_bytes +
                       2 * nslots * static_cast<int64_t>(sizeof(SlotInfo)) +
                       2 * g.item_rows * static_cast<int64_t>(sizeof(RowInfo)) +
                       align_up16(g.item_rows * cols * g.k * 2);
  if (smem > kMaxSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);

  Args a;
  a.x = static_cast<const uint8_t*>(x);
  a.oy = static_cast<const int32_t*>(oy);
  a.ox = static_cast<const int32_t*>(ox);
  a.flip = static_cast<const uint8_t*>(flip);
  a.mean = static_cast<const float*>(mean);
  a.stdev = static_cast<const float*>(stdev);
  a.out = static_cast<uint16_t*>(out);
  a.scale = scale;
  a.aligned_out = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.table) return launch<true, 0, 0>(g, a, smem, st);
  // AlexNet's stride 4 over 3 channels, with the run's shape at compile time
  if (s == 4 && c == 3) return launch<false, 4, 3>(g, a, smem, st);
  return launch<false, 0, 0>(g, a, smem, st);
}
