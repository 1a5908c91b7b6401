// Response norm (LRN, with the producing conv's bias and the ReLU
// optionally fused) followed by a max pool, forward and backward, with the
// LRN output y kept out of device memory in both directions.
//
// Replaces the TPU kernels of convnet_tpu/ops/fused_pool_lrn.py:
//   :388 _fused_fwd_kernel (launched at :480)  m = maxpool(LRN(relu(z + b)))
//   :134 _fused_bwd_kernel (launched at :340)  pool-undo + LRN backward + db
// The pool has padding 0 and cuda-convnet's ceil-mode geometry (taps past
// the bottom or right edge are ignored). Its gradient is upstream
// cuda-convnet's MaxPoolUndo: every input whose y EQUALS its window's max
// receives that window's cotangent (ties credit all winners), not one
// winner as the unfused path's ATen backward does.
//
// The backward recomputes y from z and compares it with the stored maxima,
// so its y must be the forward's bit for bit, and both the y lrn_fwd.cu
// writes: every path takes it from the chains of lrn_math.cuh (lrn_y and
// lrn_y_from_d, or their register forms lrn_d_regs, lrn_input_b, lrn_roots
// and neg_pow_roots, which repeat them operation for operation). m from
// the forward is therefore exactly maxpool(lrn_fwd(z)).
//
// Bound: device-memory bytes. At AlexNet, batch 128, bf16, the forward
// moves z once in and m once out (rnorm1 (128,55,55,96): 74.3 + 17.9 MB,
// about 27 us at 3.35 TB/s; rnorm2 (128,27,27,256): 47.8 + 11.1 MB, about
// 18 us), the backward g and m in, z in and dz out (rnorm1 2 x 17.9 +
// 2 x 74.3 MB, about 55 us; rnorm2 2 x 11.1 + 2 x 47.8 MB, about 35 us).
// The arithmetic is close behind: about 28 operations an element for one y
// (two of them special-function operations), so a kernel that recomputed y for
// every tap of every overlapping window (k^2/s^2 = 2.25 times an element at
// pool 3/2) could not reach the byte bound. Each y is computed once here,
// and nothing in the loops over positions divides by a run-time number.
//
// Design for Hopper, the fast path (sliding window n = 5, beta = 0.75,
// rows that are whole 16-byte words, 16-byte aligned tensors, a row of at
// most kFwdMaxThreads or kBwdMaxThreads chunks, at most kMaxOuts output
// rows and columns, buffers within 227 KB):
// - Thread map of lrn_fwd.cu and lrn_bwd.cu: a position is C / V chunks of
//   V consecutive channels (V = 8 in bf16, 4 in f32: 16-byte accesses); a
//   block is `slots` position slots times the chunks, thread t owning chunk
//   t % chunks of positions slot, slot + slots, ... of every row, so the
//   bias values of its chunk and halo sit in registers. The window's halo
//   is read as one 4- or 8-byte word each side.
// - A tile is a band of consecutive rows of one image, walked from top to
//   bottom, on a persistent grid: as many blocks as fit on the card at
//   once (the occupancy API, asked once per block shape and cached), the
//   band count chosen so that the tiles fill those blocks.
// - Every row of z is staged in its own dtype by 16-byte cp.async copies
//   into a double buffer: row r + 1 is in flight while row r is computed.
// - Which output rows and columns cover an input row or column (covering)
//   is worked out once a block into a table in shared memory, with each
//   row's slot in the ring of open or staged output rows: a position costs
//   one table read, no division and no modulo.
// - y: d by lrn_d_regs, then both roots of d for all V channels by
//   lrn_roots (lrn_math.cuh): the operations rsqrtf and sqrtf perform on a
//   positive normal d, without their branches, so the V chains interleave;
//   any other d takes rsqrtf and sqrtf. The products are neg_pow_c's.
// - Forward: the block writes a row's y, rounded once to z's dtype, to
//   shared memory as 16-byte words; each thread then takes the max over
//   the k columns of its output columns and folds it into the running
//   maxima of the at most ceil(k / s) output rows still open (kept in
//   shared memory, each entry touched by one thread only); a finished
//   output row leaves with 16-byte stores. bf16 maxima are taken two
//   values an instruction, on the packed words. y has two buffers, so a
//   row's pooling runs in the iteration that computes the next row's y: one
//   barrier a row. A max over columns, then rows, any NaN kept, is the
//   value the row-major scan keeps. With R output rows a band the block
//   reads sR + k - s input rows: rows read twice are 1 / (2R + 1) of them
//   at pool 3/2, not a half.
// - Backward: the rows of m and of g that cover an input row are staged
//   once by cp.async into a ring of as many slots as a row and its
//   successor need together (2 at pool 3/2) and reused by the rows under
//   them. Per position a thread recomputes x, d and y in registers, rounds
//   y to z's dtype as one 16-byte word, adds the cotangents of the covering
//   windows whose stored max equals it (output rows ascending, then
//   columns: 16-byte shared-memory loads, bf16 compared two values an
//   instruction), and writes u = g x d^-(beta+1) and g d^-beta to two f32
//   row buffers; after a barrier (of the warp alone where a warp holds
//   whole positions) it sums the transposed window of u and stores dz with
//   16-byte stores. The roots feed both power chains.
// - db, deterministic: a thread adds its f32 dz into V sums of its own in
//   an order fixed by the launch geometry (the grid is a function of the
//   shapes and of the card), the block adds its slots in order into one
//   partial row, and db_reduce_kernel adds the rows in order. No atomics.
// Other windows and exponents, blocked windows, rows that are no whole
// number of 16-byte words and unaligned tensors take the generic kernels
// below (one f32 tile a block, y recomputed per tap, scalar accesses). The
// path is chosen from shapes, dtype and alignment alone, before the launch.

#include <math_constants.h>

#include <mutex>
#include <vector>

#include "lrn_math.cuh"
#include "stage.cuh"

namespace {

constexpr int kThreads = 256;                  // the generic kernels' block
constexpr int kMaxSharedBytes = 48 * 1024;     // and their shared memory
// The fast kernels' largest blocks: of the sizes tried (128 to 512 threads)
// the fastest over AlexNet's two chains together, on an H100.
constexpr int kFwdMaxThreads = 384;
constexpr int kBwdMaxThreads = 288;

struct Geometry {
  int b, h, w, c, oh, ow, k, s;
};

struct Lrn {
  int relu, blocked, n, q;
  float alpha, beta;
};

// The output rows (or columns) [lo, hi] whose k/s windows hold input row
// (or column) r; empty (lo > hi) when none does.
__host__ __device__ __forceinline__ void covering(int r, int k, int s, int outs, int* lo, int* hi) {
  const int first = r - k + 1;
  *lo = first <= 0 ? 0 : (first + s - 1) / s;
  *hi = min(outs - 1, r / s);
}

// covering() of every input row (or column) 0 .. n - 1, worked out once a
// block and packed a word each, so that the loops over positions divide by
// nothing: lo | hi << 12 | (lo % ring) << 24, where output row `oi` of a
// tile sits in slot oi % ring of a ring of staged rows. outs <= kMaxOuts.
constexpr int kMaxOuts = 4095;

struct Cover {
  int lo, hi, slot;
};

__device__ __forceinline__ void fill_cover_table(int* tab, int n, int k, int s, int outs,
                                                 int ring) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    int lo, hi;
    covering(r, k, s, outs, &lo, &hi);
    tab[r] = lo | hi << 12 | (lo % ring) << 24;
  }
}

__device__ __forceinline__ Cover unpack_cover(int word) {
  return Cover{word & 0xfff, (word >> 12) & 0xfff, word >> 24};
}

// The ring slot of output row `to`, c.lo <= to <= c.lo + ring.
__device__ __forceinline__ int ring_slot(const Cover& c, int to, int ring) {
  const int slot = c.slot + (to - c.lo);
  return slot >= ring ? slot - ring : slot;
}

// The slot after `slot` in a ring of `ring`.
__device__ __forceinline__ int next_slot(int slot, int ring) {
  return slot + 1 == ring ? 0 : slot + 1;
}

// B consecutive values at p as f32, by one 4- or 8-byte load when B values
// are that wide (p then aligned to it).
template <int B, typename T>
__device__ __forceinline__ void load_pair(const T* p, float* out) {
  if constexpr (B * sizeof(T) == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < B; ++i) out[i] = load_f32(e, i);
  } else if constexpr (B * sizeof(T) == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < B; ++i) out[i] = load_f32(e, i);
  } else {
#pragma unroll
    for (int i = 0; i < B; ++i) out[i] = load_f32(p, i);
  }
}

// Values of channels ch0 - B .. ch0 + V - 1 + A of the row at `row` into
// w[0 .. B + V + A), 0 outside [0, c). ch0 and c are multiples of V >= B,
// A, so each side's halo lies wholly inside the row or wholly outside.
template <int V, int B, int A, typename T>
__device__ __forceinline__ void load_window(const T* row, int ch0, int c, float* w) {
  static_assert(B <= V && A <= V, "a halo within the neighbouring chunk");
  load_vec<V>(row + ch0, w + B);
#pragma unroll
  for (int i = 0; i < B; ++i) w[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < A; ++i) w[B + V + i] = 0.0f;
  if (ch0 > 0) load_pair<B>(row + ch0 - B, w);
  if (ch0 + V < c) load_pair<A>(row + ch0 + V, w + B + V);
}

// x = relu(z + b) of a thread's chunk and its LRN halo from a staged row of
// raw z: the values lrn_fwd.cu's register path feeds lrn_d_regs (channels
// outside [0, c) count as 0, whatever relu(b) would be).
template <int V, int N, typename T>
__device__ __forceinline__ void x_window(const T* zrow, int ch0, int c, const float* bw,
                                         bool has_bias, int relu, float* xw) {
  constexpr int B = N / 2, A = (N - 1) / 2;
  load_window<V, B, A>(zrow, ch0, c, xw);
#pragma unroll
  for (int i = 0; i < V + N - 1; ++i) {
    const int j = ch0 - B + i;
    xw[i] = j >= 0 && j < c ? lrn_input_b(xw[i], bw[i], has_bias, relu) : 0.0f;
  }
}

// The bias values of the window span of the chunk at ch0, 0 outside [0, c)
// or without a bias.
template <int V, int N>
__device__ __forceinline__ void bias_window(const float* bias, int ch0, int c, float* bw) {
#pragma unroll
  for (int i = 0; i < V + N - 1; ++i) {
    const int j = ch0 - N / 2 + i;
    bw[i] = bias != nullptr && j >= 0 && j < c ? bias[j] : 0.0f;
  }
}

// The step of ATen's max pool scan (`if (y > cur || y != y) cur = y`) for
// the word b that comes after a, elementwise over two 16-byte words of T: b
// where b > a or b is a NaN, else a, bit for bit (the first of -0 and +0,
// the last NaN with its payload). Associative, so a max over columns and
// then rows is the row-major scan's. bf16 words are compared two values an
// instruction, without widening them, and selected by the comparison's
// masks: __hmax2_nan keeps neither the first zero nor a NaN's payload.
template <typename T>
__device__ __forceinline__ uint4 max_keep(uint4 a, uint4 b) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
    const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
    uint4 out;
    uint32_t* po = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 av = *reinterpret_cast<const __nv_bfloat162*>(pa + i);
      const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(pb + i);
      const uint32_t take = __hgt2_mask(bv, av) | __hneu2_mask(bv, bv);
      po[i] = (pb[i] & take) | (pa[i] & ~take);
    }
    return out;
  } else {
    const float* pa = reinterpret_cast<const float*>(&a);
    const float* pb = reinterpret_cast<const float*>(&b);
    uint4 out;
    float* po = reinterpret_cast<float*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) po[i] = pb[i] > pa[i] || pb[i] != pb[i] ? pb[i] : pa[i];
    return out;
  }
}

// acc[v] += g[v] where m[v] == y[v], over the 16 / sizeof(T) values of
// three 16-byte words of T (a NaN equals nothing, -0 equals +0). bf16 words
// are compared two values an instruction, and a cotangent that is not
// credited is added as +0.
template <typename T>
__device__ __forceinline__ void add_where_equal(uint4 m, uint4 y, uint4 g, float* acc) {
  const uint32_t* pm = reinterpret_cast<const uint32_t*>(&m);
  const uint32_t* py = reinterpret_cast<const uint32_t*>(&y);
  const uint32_t* pg = reinterpret_cast<const uint32_t*>(&g);
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t credited =
          pg[i] & __heq2_mask(*reinterpret_cast<const __nv_bfloat162*>(pm + i),
                              *reinterpret_cast<const __nv_bfloat162*>(py + i));
      acc[2 * i] += __uint_as_float(credited << 16);
      acc[2 * i + 1] += __uint_as_float(credited & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (__uint_as_float(pm[i]) == __uint_as_float(py[i])) acc[i] += __uint_as_float(pg[i]);
    }
  }
}

// The fast forward. Block: slots * (c / V) threads. Dynamic shared memory:
// z rows [2], y rows [2] (w * c of T each), running maxima (ceil(k / s),
// ow, c) of T, the rows' cover table (h words). A tile is output rows
// [band * j, band * (j + 1)) of one image.
template <typename T, int N, int Q>
__global__ void __launch_bounds__(kFwdMaxThreads)
pool_lrn_fwd_fast(const T* __restrict__ z, const float* __restrict__ bias, T* __restrict__ m,
                  Geometry g, int relu, float alpha, int band, int bands, int slots) {
  constexpr int V = 16 / sizeof(T);
  constexpr int B = N / 2;
  constexpr int W = V + N - 1;
  extern __shared__ __align__(16) unsigned char fast_smem[];
  const int row_elems = g.w * g.c;
  const int out_elems = g.ow * g.c;
  const int nopen = (g.k + g.s - 1) / g.s;
  T* sz = reinterpret_cast<T*>(fast_smem);  // [2][row_elems]
  T* sy = sz + 2 * row_elems;           // [2][row_elems]
  T* sacc = sy + 2 * row_elems;         // [nopen][out_elems]
  int* srow = reinterpret_cast<int*>(sacc + nopen * out_elems);  // [h], fill_cover_table
  const int cpp = g.c / V;
  const int slot = static_cast<int>(threadIdx.x) / cpp;
  const int ch0 = (static_cast<int>(threadIdx.x) - slot * cpp) * V;
  const bool has_bias = bias != nullptr;
  float bw[W];
  bias_window<V, N>(bias, ch0, g.c, bw);
  fill_cover_table(srow, g.h, g.k, g.s, g.oh, nopen);  // read after the loop's first barrier

  const int64_t tiles = static_cast<int64_t>(g.b) * bands;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t bi = tile / bands;
    const int oi0 = static_cast<int>(tile - bi * bands) * band;
    const int oi1 = min(g.oh, oi0 + band);
    const int r0 = g.s * oi0;
    const int nrows = min(g.h, g.s * (oi1 - 1) + g.k) - r0;
    const T* zrows = z + (bi * g.h + r0) * row_elems;
    T* mimg = m + bi * g.oh * out_elems;
    // the last tile's final iteration reads y alone: z's buffers are free
    stage_rows<true>(sz, zrows, row_elems);
    for (int i = 0; i <= nrows; ++i) {
      cp_async_wait_all();
      __syncthreads();  // row i of z staged, row i - 1 of y written, row i - 2 of y read
      if (i + 1 < nrows) {
        stage_rows<true>(sz + ((i + 1) & 1) * row_elems,
                         zrows + static_cast<int64_t>(i + 1) * row_elems, row_elems);
      }
      if (i < nrows) {
        const T* zb = sz + (i & 1) * row_elems;
        T* yb = sy + (i & 1) * row_elems;
        for (int pos = slot; pos < g.w; pos += slots) {
          float xw[W], d[V], rs[V], qr[V], out[V];
          x_window<V, N>(zb + pos * g.c, ch0, g.c, bw, has_bias, relu, xw);
#pragma unroll
          for (int v = 0; v < V; ++v) d[v] = lrn_d_regs<N>(xw + v, alpha);
          lrn_roots<V>(d, rs, qr);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            out[v] = __fmul_rn(xw[B + v], neg_pow_roots<Q>(d[v], rs[v], qr[v]));
          }
          // rounded once to T
          *reinterpret_cast<uint4*>(yb + pos * g.c + ch0) = pack_word(out, z);
        }
      }
      if (i > 0) {
        // pool row r of y into the output rows of the band whose windows
        // hold it
        const int r = r0 + i - 1;
        const T* yb = sy + ((i - 1) & 1) * row_elems;
        const Cover rows = unpack_cover(srow[r]);
        const int oi_lo = max(rows.lo, oi0);
        const int oi_hi = min(rows.hi, oi1 - 1);
        const int slot_lo = ring_slot(rows, oi_lo, nopen);
        for (int oj = slot; oj < g.ow && oi_lo <= oi_hi; oj += slots) {
          const int col0 = g.s * oj;
          uint4 cm = *reinterpret_cast<const uint4*>(yb + col0 * g.c + ch0);
          for (int t = 1; t < g.k && col0 + t < g.w; ++t) {
            cm = max_keep<T>(cm, *reinterpret_cast<const uint4*>(yb + (col0 + t) * g.c + ch0));
          }
          int open = slot_lo;
          for (int oi = oi_lo; oi <= oi_hi; ++oi, open = next_slot(open, nopen)) {
            uint4* acc = reinterpret_cast<uint4*>(sacc + (open * g.ow + oj) * g.c + ch0);
            const uint4 cur = r == g.s * oi ? cm : max_keep<T>(*acc, cm);
            // the window's last row: past it lies the ceil-mode overhang
            if (r == min(g.s * oi + g.k, g.h) - 1) {
              *reinterpret_cast<uint4*>(mimg + (oi * g.ow + oj) * g.c + ch0) = cur;
            } else {
              *acc = cur;
            }
          }
        }
      }
    }
  }
}

// The fast backward. Block: slots * (c / V) threads. Dynamic shared
// memory: z rows [2] (w * c of T), rings of m rows and of g rows [nring]
// (ow * c of T each), u and g * d^-beta rows (w * c of f32 each; the db
// sums (slots, c) reuse u's at the end), the rows' and the columns' cover
// tables (h + w words). A tile is input rows [band * j, band * (j + 1)) of
// one image.
template <typename T, int N, int Q>
__global__ void __launch_bounds__(kBwdMaxThreads)
pool_lrn_bwd_fast(const T* __restrict__ gm, const T* __restrict__ m, const T* __restrict__ z,
                  const float* __restrict__ bias, T* __restrict__ dz,
                  float* __restrict__ partial, Geometry g, int relu, float alpha, float coef,
                  int band, int bands, int slots, int nring) {
  constexpr int V = 16 / sizeof(T);
  constexpr int B = N / 2;
  constexpr int W = V + N - 1;
  extern __shared__ __align__(16) unsigned char fast_smem[];
  const int row_elems = g.w * g.c;
  const int out_elems = g.ow * g.c;
  T* sz = reinterpret_cast<T*>(fast_smem);         // [2][row_elems]
  T* sm = sz + 2 * row_elems;                  // [nring][out_elems]
  T* sg = sm + nring * out_elems;              // [nring][out_elems]
  float* su = reinterpret_cast<float*>(sg + nring * out_elems);  // u
  float* sv = su + row_elems;                                    // g * d^-beta
  int* srow = reinterpret_cast<int*>(sv + row_elems);            // [h], fill_cover_table
  int* scol = srow + g.h;                                        // [w]
  const int cpp = g.c / V;
  const int slot = static_cast<int>(threadIdx.x) / cpp;
  const int ch0 = (static_cast<int>(threadIdx.x) - slot * cpp) * V;
  const bool has_bias = bias != nullptr;
  const bool want_db = partial != nullptr;
  const bool warp_holds_positions = 32 % cpp == 0;
  float bw[W];
  bias_window<V, N>(bias, ch0, g.c, bw);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  fill_cover_table(srow, g.h, g.k, g.s, g.oh, nring);  // read after the tile's first barrier
  fill_cover_table(scol, g.w, g.k, g.s, g.ow, 1);

  const int64_t tiles = static_cast<int64_t>(g.b) * bands;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t bi = tile / bands;
    const int r0 = static_cast<int>(tile - bi * bands) * band;
    const int r1 = min(g.h, r0 + band);
    const T* zimg = z + bi * g.h * row_elems;
    T* dzimg = dz + bi * g.h * row_elems;
    const T* mimg = m + bi * g.oh * out_elems;
    const T* gimg = gm + bi * g.oh * out_elems;
    // output rows up to `staged` lie in the rings, row oi in slot oi % nring
    auto stage_out = [&](int lo, int hi, int slot_lo) {
      int at = slot_lo;
      for (int oi = lo; oi <= hi; ++oi, at = next_slot(at, nring)) {
        stage_rows<true>(sm + at * out_elems, mimg + static_cast<int64_t>(oi) * out_elems,
                         out_elems);
        stage_rows<true>(sg + at * out_elems, gimg + static_cast<int64_t>(oi) * out_elems,
                         out_elems);
      }
    };
    __syncthreads();  // the tables are filled; every thread is done with the tile before
    Cover rows = unpack_cover(srow[r0]);
    int staged = rows.hi;
    stage_rows<true>(sz, zimg + static_cast<int64_t>(r0) * row_elems, row_elems);
    stage_out(rows.lo, rows.hi, rows.slot);
    for (int r = r0; r < r1; ++r) {
      const int buf = (r - r0) & 1;
      cp_async_wait_all();
      __syncthreads();  // row r of z and its rows of m and g staged; row r - 1 is done
      if (r + 1 < r1) {
        stage_rows<true>(sz + (buf ^ 1) * row_elems,
                         zimg + static_cast<int64_t>(r + 1) * row_elems, row_elems);
        const Cover next = unpack_cover(srow[r + 1]);
        const int from = max(next.lo, staged + 1);
        stage_out(from, next.hi, ring_slot(next, from, nring));
        staged = max(staged, next.hi);
      }
      const T* zb = sz + buf * row_elems;
      rows = unpack_cover(srow[r]);

      // u and g * d^-beta of the thread's chunks, into su and sv
      for (int pos = slot; pos < g.w; pos += slots) {
        float xw[W], d[V], rs[V], qr[V], y[V], glrn[V], u[V], gpb[V];
        x_window<V, N>(zb + pos * g.c, ch0, g.c, bw, has_bias, relu, xw);
#pragma unroll
        for (int v = 0; v < V; ++v) d[v] = lrn_d_regs<N>(xw + v, alpha);
        lrn_roots<V>(d, rs, qr);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          y[v] = __fmul_rn(xw[B + v], neg_pow_roots<Q>(d[v], rs[v], qr[v]));
          glrn[v] = 0.0f;
        }
        // pool-undo, comparison form: the cotangent of every covering
        // window whose max equals y rounded to T, output rows then columns
        // ascending
        const uint4 yw = pack_word(y, z);
        const Cover cols = unpack_cover(scol[pos]);
        int ring = rows.slot;
        for (int oi = rows.lo; oi <= rows.hi; ++oi, ring = next_slot(ring, nring)) {
          const int at = ring * out_elems + ch0;
          for (int oj = cols.lo; oj <= cols.hi; ++oj) {
            add_where_equal<T>(*reinterpret_cast<const uint4*>(sm + at + oj * g.c), yw,
                               *reinterpret_cast<const uint4*>(sg + at + oj * g.c), glrn);
          }
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float pb, dpow;
          neg_pow_pair_roots<Q>(qr[v], &pb, &dpow);
          u[v] = glrn[v] * xw[B + v] * dpow;
          gpb[v] = glrn[v] * pb;
        }
        store_vec<V>(su + pos * g.c + ch0, u);
        store_vec<V>(sv + pos * g.c + ch0, gpb);
      }
      // u of every channel of a position written: by the thread's own warp
      // when a warp holds whole positions, else somewhere in the block
      if (warp_holds_positions) {
        __syncwarp();
      } else {
        __syncthreads();
      }

      // dz from the transposed window of u
      for (int pos = slot; pos < g.w; pos += slots) {
        float zv[V], gpb[V], uw[W], out[V];
        load_vec<V>(zb + pos * g.c + ch0, zv);
        load_vec<V>(sv + pos * g.c + ch0, gpb);
        load_window<V, (N - 1) / 2, B>(su + pos * g.c, ch0, g.c, uw);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float t = 0.0f;
#pragma unroll
          for (int i = 0; i < N; ++i) t += uw[v + i];
          const float x = lrn_input_b(zv[v], bw[B + v], has_bias, relu);
          float dv = gpb[v] - coef * x * t;
          // x > 0 exactly where z + b > 0 (a NaN fails both)
          if (relu && !(x > 0.0f)) dv = 0.0f;
          out[v] = dv;
          acc[v] += dv;
        }
        store_vec<V>(dzimg + (static_cast<int64_t>(r) * g.w + pos) * g.c + ch0, out);
      }
    }
  }
  if (want_db) {
    float* sacc = su;  // (slots, c)
    __syncthreads();   // the last row's u is read
    store_vec<V>(sacc + slot * g.c + ch0, acc);
    __syncthreads();
    for (int ch = threadIdx.x; ch < g.c; ch += blockDim.x) {
      float s = 0.0f;
      for (int k = 0; k < slots; ++k) s += sacc[k * g.c + ch];
      partial[static_cast<int64_t>(blockIdx.x) * g.c + ch] = s;
    }
  }
}

// The generic kernels: any window, exponent, pool and alignment.

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_lrn_fwd_generic(const T* __restrict__ z, const float* __restrict__ bias, T* __restrict__ m,
                    Geometry g, Lrn p, int ow_tile, int chunks) {
  extern __shared__ float smem[];
  const int max_cols = g.s * (ow_tile - 1) + g.k;
  float* sx = smem;                        // staged x, (max_cols, c)
  float* sacc = sx + max_cols * g.c;       // running maxima, (ow_tile, c)
  const int chunk = blockIdx.x % chunks;
  const int oi = (blockIdx.x / chunks) % g.oh;
  const int64_t bi = blockIdx.x / (chunks * g.oh);
  const int ow0 = chunk * ow_tile;
  const int nout = min(ow_tile, g.ow - ow0);
  if (nout <= 0) return;  // uniform across the block
  const int col0 = g.s * ow0;
  const int ncols = min(g.w, g.s * (ow0 + nout - 1) + g.k) - col0;
  const int outs = nout * g.c;

  for (int v = 0; v < g.k; ++v) {
    const int r = oi * g.s + v;
    if (r >= g.h) break;  // the ceil-mode overhang: no taps
    const int64_t base = ((bi * g.h + r) * g.w + col0) * g.c;
    if (v) __syncthreads();  // the previous row's taps are read
    for (int i = threadIdx.x; i < ncols * g.c; i += blockDim.x) {
      sx[i] = lrn_input(load_f32(z, base + i), bias, i % g.c, p.relu);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < outs; e += blockDim.x) {
      const int j = e / g.c;
      const int ch = e - j * g.c;
      float cur = -CUDART_INF_F;
      for (int t = 0; t < g.k; ++t) {
        const int col = g.s * j + t;  // relative to col0
        if (col >= ncols) break;
        const float y = round_to(
            lrn_y(sx + col * g.c, ch, g.c, p.n, p.blocked, p.alpha, p.beta, p.q), z);
        // the first of equal maxima, a NaN kept: ATen's max pool scan
        if (y > cur || y != y) cur = y;
      }
      if (v == 0 || cur > sacc[e] || cur != cur) sacc[e] = cur;
    }
  }
  const int64_t out0 = ((bi * g.oh + oi) * g.ow + ow0) * g.c;
  for (int e = threadIdx.x; e < outs; e += blockDim.x) store_f32(m, out0 + e, sacc[e]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_lrn_bwd_generic(const T* __restrict__ gm, const T* __restrict__ m, const T* __restrict__ z,
                    const float* __restrict__ bias, T* __restrict__ dz,
                    float* __restrict__ partial, Geometry g, Lrn p, float coef, int tile_w,
                    int chunks, int64_t tiles) {
  extern __shared__ float smem[];
  const int cap = tile_w * g.c;
  float* sx = smem;         // x = relu(z + b)
  float* su = sx + cap;     // u = glrn * x * d^-(beta+1)
  float* sv = su + cap;     // glrn * d^-beta, then the f32 dz
  float* sacc = sv + cap;   // this block's db sums, (c,)
  const bool want_db = partial != nullptr;
  if (want_db) {
    for (int ch = threadIdx.x; ch < g.c; ch += blockDim.x) sacc[ch] = 0.0f;
  }
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int chunk = static_cast<int>(tile % chunks);
    const int r = static_cast<int>((tile / chunks) % g.h);
    const int64_t bi = tile / (static_cast<int64_t>(chunks) * g.h);
    const int w0 = chunk * tile_w;
    const int npos = min(tile_w, g.w - w0);
    const int elems = npos * g.c;
    const int64_t base = ((bi * g.h + r) * g.w + w0) * g.c;
    // the output rows whose windows hold input row r
    const int lo_r = r - g.k + 1;
    const int oi_lo = lo_r <= 0 ? 0 : (lo_r + g.s - 1) / g.s;
    const int oi_hi = min(g.oh - 1, r / g.s);

    for (int i = threadIdx.x; i < elems; i += blockDim.x) {
      sx[i] = lrn_input(load_f32(z, base + i), bias, i % g.c, p.relu);
    }
    __syncthreads();

    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int pos = e / g.c;
      const int ch = e - pos * g.c;
      const float* row = sx + pos * g.c;
      const float d = lrn_d(row, ch, g.c, p.n, p.blocked, p.alpha);
      const float y = round_to(lrn_y_from_d(row[ch], d, p.beta, p.q), z);
      // pool-undo, comparison form: the cotangent of every covering window
      // whose max equals y
      const int col = w0 + pos;
      const int lo_c = col - g.k + 1;
      const int oj_lo = lo_c <= 0 ? 0 : (lo_c + g.s - 1) / g.s;
      const int oj_hi = min(g.ow - 1, col / g.s);
      float glrn = 0.0f;
      for (int oi = oi_lo; oi <= oi_hi; ++oi) {
        for (int oj = oj_lo; oj <= oj_hi; ++oj) {
          const int64_t o = ((bi * g.oh + oi) * g.ow + oj) * g.c + ch;
          if (load_f32(m, o) == y) glrn += load_f32(gm, o);
        }
      }
      float pb, dpow;
      neg_pow_pair(d, p.beta, p.q, &pb, &dpow);
      su[e] = glrn * row[ch] * dpow;
      sv[e] = glrn * pb;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int pos = e / g.c;
      const int ch = e - pos * g.c;
      int lo, hi;
      lrn_window(ch, g.c, p.n, p.blocked, true, &lo, &hi);
      const float* urow = su + pos * g.c;
      float t = 0.0f;
      for (int j = lo; j <= hi; ++j) t += urow[j];
      const float x = sx[e];
      float dv = sv[e] - coef * x * t;
      // x > 0 exactly where z + b > 0 (a NaN fails both)
      if (p.relu && !(x > 0.0f)) dv = 0.0f;
      store_f32(dz, base + e, dv);
      if (want_db) sv[e] = dv;
    }
    __syncthreads();

    if (want_db) {
      // the next tile writes sv only after its first barrier, which every
      // thread reaches after finishing this loop
      for (int ch = threadIdx.x; ch < g.c; ch += blockDim.x) {
        float acc = 0.0f;
        for (int pos = 0; pos < npos; ++pos) acc += sv[pos * g.c + ch];
        sacc[ch] += acc;
      }
    }
  }
  if (want_db) {
    for (int ch = threadIdx.x; ch < g.c; ch += blockDim.x) {
      partial[static_cast<int64_t>(blockIdx.x) * g.c + ch] = sacc[ch];
    }
  }
}

// Split `count` items into the fewest equal runs of at most `most`:
// returns the run length, and the number of runs in *runs.
int split(int count, int most, int* runs) {
  *runs = (count + most - 1) / most;
  return (count + *runs - 1) / *runs;
}

bool valid(const Geometry& g, const Lrn& p) {
  return g.b > 0 && g.h > 0 && g.w > 0 && g.c > 0 && g.k > 0 && g.s > 0 && g.oh > 0 &&
         g.ow > 0 && p.n > 0 && g.s * (g.oh - 1) < g.h && g.s * (g.ow - 1) < g.w;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether the fast kernels' arithmetic and accesses fit: AlexNet's sliding
// n = 5 and beta = 0.75 (q = 3), rows of whole 16-byte words, at most
// `max_threads` chunks a position.
template <typename T>
bool fast_shape(const Geometry& g, const Lrn& p, int max_threads) {
  constexpr int kV = 16 / sizeof(T);
  return !p.blocked && p.n == 5 && p.q == 3 && g.c % kV == 0 && g.c / kV <= max_threads &&
         g.oh <= kMaxOuts && g.ow <= kMaxOuts &&
         static_cast<int64_t>(g.h) * g.w * g.c <= 0x7fffffff;
}

// The fast kernels' block: the fewest passes over a row's w positions that
// `max_threads` allow, and the fewest slots that make those passes.
int position_slots(int w, int chunks, int max_threads) {
  int passes;
  return split(w, max_threads / chunks, &passes);
}

// Blocks of `kernel` the card holds at once at this block size and dynamic
// shared memory (0: none, or a CUDA call failed). The kernel is configured
// and the occupancy API asked once per (threads, smem) of a kernel (T and
// FWD name it); later launches read the cached answer, so the grid of a
// shape is the same on every call.
template <typename T, bool FWD, typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem) {
  struct Entry {
    int threads;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.threads == threads && e.smem == smem) return e.blocks;
  }
  static const cudaError_t configured = [kernel] {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kMaxSmemPerBlock);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  int dev = 0, sms = 0, per_sm = 0;
  if (configured != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess) {
    return 0;
  }
  cache.push_back({threads, smem, per_sm * sms});
  return per_sm * sms;
}

// Cut each image's `rows` into bands so that b * bands tiles about fill
// `resident` blocks: the rows a band (the band count follows).
int band_rows(int rows, int b, int resident) {
  const int bands = max(1, min(rows, resident / b));
  return (rows + bands - 1) / bands;
}

// The most output rows an input row and its successor need together: the
// backward's ring of staged m and g rows.
int ring_slots(const Geometry& g) {
  int most = 1;
  for (int r = 0; r < g.h; ++r) {
    int lo, hi, lo1, hi1;
    covering(r, g.k, g.s, g.oh, &lo, &hi);
    covering(min(r + 1, g.h - 1), g.k, g.s, g.oh, &lo1, &hi1);
    most = max(most, max(hi, hi1) - lo + 1);
  }
  return most;
}

template <typename T>
int fwd_dispatch(const T* z, const float* bias, T* m, const Geometry& g, const Lrn& p,
                 cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  if (fast_shape<T>(g, p, kFwdMaxThreads) && aligned16(z) && aligned16(m)) {
    const int chunks = g.c / kV;
    const int slots = position_slots(g.w, chunks, kFwdMaxThreads);
    const size_t smem = (4 * static_cast<size_t>(g.w) +
                         static_cast<size_t>((g.k + g.s - 1) / g.s) * g.ow) * g.c * sizeof(T) +
                        g.h * sizeof(int);
    if (smem <= static_cast<size_t>(kMaxSmemPerBlock)) {
      auto kernel = pool_lrn_fwd_fast<T, 5, 3>;
      const int resident = resident_blocks<T, true>(kernel, slots * chunks, smem);
      if (resident < 1) return static_cast<int>(cudaErrorInvalidValue);
      const int band = band_rows(g.oh, g.b, resident);
      const int bands = (g.oh + band - 1) / band;
      const int64_t tiles = static_cast<int64_t>(g.b) * bands;
      kernel<<<static_cast<int>(tiles < resident ? tiles : resident), slots * chunks, smem, st>>>(
          z, bias, m, g, p.relu, p.alpha, band, bands, slots);
      return static_cast<int>(cudaGetLastError());
    }
  }
  // about 4096 staged x values a block: (s * (tile - 1) + k) columns
  const int most = max(1, (max(4096 / g.c, g.k) - g.k) / g.s + 1);
  int chunks;
  const int ow_tile = split(g.ow, most, &chunks);
  const size_t smem = (static_cast<size_t>(g.s * (ow_tile - 1) + g.k) * g.c +
                       static_cast<size_t>(ow_tile) * g.c) * sizeof(float);
  const int64_t blocks = static_cast<int64_t>(g.b) * g.oh * chunks;
  if (smem > kMaxSharedBytes || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pool_lrn_fwd_generic<T><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      z, bias, m, g, p, ow_tile, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dispatch(const T* gm, const T* m, const T* z, const float* bias, T* dz, float* db,
                 float* partial, int max_blocks, const Geometry& g, const Lrn& p, float coef,
                 cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  float* part = bias ? partial : nullptr;
  int blocks = 0;
  bool launched = false;
  if (fast_shape<T>(g, p, kBwdMaxThreads) && aligned16(gm) && aligned16(m) && aligned16(z) &&
      aligned16(dz)) {
    const int chunks = g.c / kV;
    const int slots = position_slots(g.w, chunks, kBwdMaxThreads);
    const int nring = ring_slots(g);
    const size_t smem = (2 * static_cast<size_t>(g.w) + 2 * static_cast<size_t>(nring) * g.ow) *
                            g.c * sizeof(T) +
                        2 * static_cast<size_t>(g.w) * g.c * sizeof(float) +
                        (g.h + g.w) * sizeof(int);
    if (smem <= static_cast<size_t>(kMaxSmemPerBlock)) {
      auto kernel = pool_lrn_bwd_fast<T, 5, 3>;
      const int resident = resident_blocks<T, false>(kernel, slots * chunks, smem);
      if (resident < 1) return static_cast<int>(cudaErrorInvalidValue);
      const int band = band_rows(g.h, g.b, resident);
      const int bands = (g.h + band - 1) / band;
      const int64_t tiles = static_cast<int64_t>(g.b) * bands;
      blocks = resident < max_blocks ? resident : max_blocks;
      if (tiles < blocks) blocks = static_cast<int>(tiles);
      kernel<<<blocks, slots * chunks, smem, st>>>(gm, m, z, bias, dz, part, g, p.relu, p.alpha,
                                                   coef, band, bands, slots, nring);
      launched = true;
    }
  }
  if (!launched) {
    // about 2048 f32 values per staged buffer, whole positions
    int chunks;
    const int tile_w = split(g.w, max(1, 2048 / g.c), &chunks);
    const size_t smem = (3 * static_cast<size_t>(tile_w) * g.c + g.c) * sizeof(float);
    if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t tiles = static_cast<int64_t>(g.b) * g.h * chunks;
    blocks = static_cast<int>(tiles < max_blocks ? tiles : max_blocks);
    pool_lrn_bwd_generic<T><<<blocks, kThreads, smem, st>>>(gm, m, z, bias, dz, part, g, p, coef,
                                                           tile_w, chunks, tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !bias) return static_cast<int>(err);
  db_reduce_kernel<<<g.c, kReduceThreads, 0, st>>>(part, db, blocks, g.c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z: (b, h, w, c); m: (b, oh, ow, c); contiguous, bf16 when is_bf16 else
// f32. bias: f32 (c,) or null. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int cn_pool_lrn_fwd(const void* z, const void* bias, void* m, int b, int h, int w,
                               int c, int oh, int ow, int k, int s, int is_bf16, int relu,
                               int blocked, int n, float alpha, float beta, int q,
                               void* stream) {
  const Geometry g{b, h, w, c, oh, ow, k, s};
  const Lrn p{relu, blocked, n, q, alpha, beta};
  if (!valid(g, p)) return static_cast<int>(cudaErrorInvalidValue);
  const float* bs = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd_dispatch(static_cast<const __nv_bfloat16*>(z), bs,
                                static_cast<__nv_bfloat16*>(m), g, p, st)
                 : fwd_dispatch(static_cast<const float*>(z), bs, static_cast<float*>(m), g, p,
                                st);
}

// g, m: (b, oh, ow, c); z, dz: (b, h, w, c); contiguous, bf16 when is_bf16
// else f32. bias: f32 (c,) or null; with a bias, db (c,) f32 and partial
// (max_blocks, c) f32 scratch must be given: the grid is capped at
// max_blocks, so each block's partial row fits. coef = 2*alpha*beta,
// rounded once from the caller's double. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int cn_pool_lrn_bwd(const void* gm, const void* m, const void* z, const void* bias,
                               void* dz, void* db, void* partial, int max_blocks, int b, int h,
                               int w, int c, int oh, int ow, int k, int s, int is_bf16,
                               int relu, int blocked, int n, float alpha, float beta,
                               float coef, int q, void* stream) {
  const Geometry g{b, h, w, c, oh, ow, k, s};
  const Lrn p{relu, blocked, n, q, alpha, beta};
  if (!valid(g, p) || max_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bias && (!db || !partial)) return static_cast<int>(cudaErrorInvalidValue);
  const float* bs = static_cast<const float*>(bias);
  float* dbf = static_cast<float*>(db);
  float* part = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B16 = __nv_bfloat16;
    return bwd_dispatch(static_cast<const B16*>(gm), static_cast<const B16*>(m),
                        static_cast<const B16*>(z), bs, static_cast<B16*>(dz), dbf, part,
                        max_blocks, g, p, coef, st);
  }
  return bwd_dispatch(static_cast<const float*>(gm), static_cast<const float*>(m),
                      static_cast<const float*>(z), bs, static_cast<float*>(dz), dbf, part,
                      max_blocks, g, p, coef, st);
}
