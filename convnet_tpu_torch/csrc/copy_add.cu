// Two inputs in, one out: o = a + b over row-major (m, n) bf16, each CTA
// one tile_rows x tile_cols tile. The card's streaming probe: what share of
// the device-memory rate a kernel that only streams attains, and whether a
// tile of column blocks (tile_cols = 128: 256-byte pieces of rows 2 * n
// bytes apart) reads slower than a tile of whole rows (tile_cols = n: 2 KB
// contiguous a row at n = 1024).
//
// Replaces the TPU kernel tools/r3_chip2.py:56 copy_kernel (the same body
// at tools/r3_chip4.py:192 and tools/r3_warm4.py:104), which run_copy
// launches over (rows, lanes) BlockSpec tilings of a (290400, 1024) bf16
// pair, rnorm1 at batch 1024 in the r2d view. The tile is the BlockSpec's
// block, scaled to a CTA (convnet_tpu_torch/tools/copy_probe.py says how).
// Unlike run_copy's grid of m // rows, the tiles cover every row: the last
// row and column tiles are cut short.
//
// Bound: device-memory bytes, 2 read and 1 written a value: 6 * m * n
// bytes, 1,784,217,600 at (290400, 1024), 0.5326 ms at 3.35 TB/s; one add
// a value, far below any compute limit.
//
// Design: a thread takes one 16-byte word (8 values) of a, of b and of o
// at a time, neighbouring threads neighbouring words of a tile row, so
// every access is a whole 32-byte sector. The add is f32 and rounds to
// nearest even, as torch.add rounds bf16 (the f32 sum of two bf16 values
// is exact, so the result is also the exactly rounded sum): the kernel is
// array-equal to a + b. Element offsets are 64-bit. The loop is unrolled
// by 4 so that a thread has several words' loads in flight.

#include "dtype.cuh"

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kPerWord = 8;  // bf16 values in a 16-byte word

__global__ void __launch_bounds__(kThreads)
copy_add_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                __nv_bfloat16* __restrict__ o, int64_t m, int64_t n, int tile_rows,
                int tile_cols, int col_tiles) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x / col_tiles) * tile_rows;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x % col_tiles) * tile_cols;
  const int rows = static_cast<int>(m - r0 < tile_rows ? m - r0 : tile_rows);
  const int words = static_cast<int>((n - c0 < tile_cols ? n - c0 : tile_cols) / kPerWord);
  const int total = rows * words;
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / words;
    const int64_t e = (r0 + r) * n + c0 + static_cast<int64_t>(i - r * words) * kPerWord;
    float x[kPerWord], y[kPerWord];
    load_vec<kPerWord>(a + e, x);
    load_vec<kPerWord>(b + e, y);
#pragma unroll
    for (int v = 0; v < kPerWord; ++v) x[v] = __fadd_rn(x[v], y[v]);
    store_vec<kPerWord>(o + e, x);
  }
}

}  // namespace

// a, b, o: row-major (m, n) bf16 on the device, 16-byte aligned, o not
// overlapping a or b; n and tile_cols multiples of 8, tile_cols <= n,
// tile_rows >= 1. Launches on `stream` and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for arguments outside those.
extern "C" int cn_copy_add(const void* a, const void* b, void* o, int64_t m, int64_t n,
                           int tile_rows, int tile_cols, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(o) % 16 == 0;
  if (!aligned || m <= 0 || n <= 0 || n % kPerWord || tile_rows <= 0 || tile_cols <= 0 ||
      tile_cols % kPerWord || tile_cols > n ||
      static_cast<int64_t>(tile_rows) * (tile_cols / kPerWord) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t row_tiles = (m + tile_rows - 1) / tile_rows;
  const int64_t col_tiles = (n + tile_cols - 1) / tile_cols;
  if (row_tiles * col_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  copy_add_kernel<<<static_cast<unsigned>(row_tiles * col_tiles), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(o), m, n, tile_rows, tile_cols, static_cast<int>(col_tiles));
  return static_cast<int>(cudaGetLastError());
}
