// Inverted dropout with a counter-based mask: y = x * scale where kept,
// 0 where dropped, the mask drawn from (key, element index) alone.
//
// Replaces the TPU kernel convnet_tpu/ops/dropout.py:58 _mask_kernel,
// which draws the TPU's hardware random bits per tile. Its keep rule and
// scaling are kept: keep = bits >= threshold, threshold =
// min(floor(rate * 2^32), 2^32 - 1); y = x * scale in x's dtype, scale =
// 1/(1 - rate) rounded to x's dtype. The bits are not the TPU's: they are
// Philox4x32-10 (Salmon et al., SC'11), keyed by two 32-bit words that the
// caller derives from (seed, step, layer), with element i's bits the word
// i % 4 of Philox at counter (group0 + i/4, 0, 0) in the low 64 bits. So
// the forward (on x) and the backward (on the cotangent) draw the same mask
// and store none, and the plain PyTorch version in
// convnet_tpu_torch/ops/dropout.py draws the same bits on any device. The
// key is read from device memory, as the TPU kernel reads its seed as a
// prefetched scalar: a train step derives it on the card from the (seed,
// step) that the card holds (cn_step_draws below), so a CUDA graph of the
// step draws a new mask at every replay. Each thread issues the key's load
// and its x load together, so the key adds no round trip to memory.
//
// Bound: device-memory bytes, 2 in and 2 out per bf16 element (at AlexNet's
// fc6/fc7, batch 128: 1 MB each way, 0.0006 ms at 3.35 TB/s); one Philox
// call (10 rounds of two 32x32->64 multiplies) serves 4 elements. At that
// size a call is a few microseconds of launch and latency, so the design
// cuts instructions and memory transactions per element: a thread takes 8
// consecutive elements, two Philox calls (counters group0 + 2t and group0 +
// 2t + 1), one 16-byte load and one 16-byte store in bf16 (two each in
// f32). Pointers not 16-byte aligned, and the last partial group of 8,
// take element-wise accesses with the same bits.

#include "dtype.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
  for (int round = 0; round < 10; ++round) {
    if (round) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// For bf16, x and scale are bf16 values: their f32 product is exact and
// rounds once to bf16, which is the bf16 multiply.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n, uint32_t threshold,
               float scale, const int64_t* __restrict__ key, uint64_t group0) {
  const int64_t threads = (n + kPerThread - 1) / kPerThread;
  const auto* key_words = reinterpret_cast<const long long*>(key);
  const uint32_t k0 = static_cast<uint32_t>(__ldg(key_words));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(key_words + 1));
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < threads;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i0 = t * kPerThread;
    const bool full = VEC && i0 + kPerThread <= n;
    float v[kPerThread];
    if (full) load_vec<kPerThread>(x + i0, v);  // in flight while Philox runs
    uint32_t bits[kPerThread];
#pragma unroll
    for (int h = 0; h < kPerThread / 4; ++h) {
      const uint64_t ctr = group0 + static_cast<uint64_t>(t) * (kPerThread / 4) + h;
      uint32_t* c = bits + 4 * h;
      c[0] = static_cast<uint32_t>(ctr);
      c[1] = static_cast<uint32_t>(ctr >> 32);
      c[2] = c[3] = 0u;
      philox4x32_10(c, k0, k1);
    }
    if (full) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) v[j] = bits[j] >= threshold ? __fmul_rn(v[j], scale) : 0.0f;
      store_vec<kPerThread>(y + i0, v);
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (i0 + j < n) {
          store_f32(y, i0 + j, bits[j] >= threshold ? __fmul_rn(load_f32(x, i0 + j), scale) : 0.0f);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* y, int64_t n, uint32_t threshold, float scale, const int64_t* key,
           uint64_t group0, cudaStream_t s) {
  const int64_t threads = (n + kPerThread - 1) / kPerThread;
  const int64_t want = (threads + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 16) ? want : (1 << 16));
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (vec) {
    dropout_kernel<T, true><<<blocks, kThreads, 0, s>>>(xs, ys, n, threshold, scale, key, group0);
  } else {
    dropout_kernel<T, false><<<blocks, kThreads, 0, s>>>(xs, ys, n, threshold, scale, key, group0);
  }
  return static_cast<int>(cudaGetLastError());
}

// A train step's random words, from the (seed, step) that the card holds.
// Key i is derive_key(seed, step, step >> 32, words[2i], words[2i + 1]):
// Philox keyed by (seed lo, seed hi) at that counter, its first two output
// words. With crops (b > 0), image t of one input field, row row0 + t of
// the global batch, takes Philox, keyed by that field's key (counter words
// crop_w2, crop_w3), at counter (row0 + t, 0, 0, 0): a rank that holds rows
// row0 .. row0 + b - 1 of a batch split over ranks draws what one device
// draws for them. oy = base_y + (bits0 * range_y) >> 32, ox likewise from
// bits1, a flip from the top bit of bits2. The scaling by a multiply-high is the
// plain version's; range <= 2^31 gives each origin a share within 2^-31 of
// uniform. One thread a key and one an image: a few microseconds, once a
// step.
constexpr int kMaxKeys = 16;
struct KeyWords {
  uint32_t w[2 * kMaxKeys];
};
struct CropDraw {
  uint32_t w2, w3;
  int row0, b, base_y, range_y, base_x, range_x;
};

__device__ __forceinline__ void derive_key(uint32_t out[2], uint64_t seed, uint64_t step,
                                           uint32_t w2, uint32_t w3) {
  uint32_t c[4] = {static_cast<uint32_t>(step), static_cast<uint32_t>(step >> 32), w2, w3};
  philox4x32_10(c, static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  out[0] = c[0];
  out[1] = c[1];
}

__global__ void step_draws_kernel(const int64_t* __restrict__ state, KeyWords words, int n_keys,
                                  int64_t* __restrict__ keys, CropDraw crop,
                                  int32_t* __restrict__ oy, int32_t* __restrict__ ox,
                                  uint8_t* __restrict__ flips) {
  const uint64_t seed = static_cast<uint64_t>(state[0]);
  const uint64_t step = static_cast<uint64_t>(state[1]);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_keys) {
    uint32_t k[2];
    derive_key(k, seed, step, words.w[2 * t], words.w[2 * t + 1]);
    keys[2 * t] = k[0];
    keys[2 * t + 1] = k[1];
  }
  if (t < crop.b) {
    uint32_t k[2];
    derive_key(k, seed, step, crop.w2, crop.w3);
    uint32_t c[4] = {static_cast<uint32_t>(crop.row0 + t), 0u, 0u, 0u};
    philox4x32_10(c, k[0], k[1]);
    oy[t] = crop.base_y + static_cast<int32_t>((static_cast<uint64_t>(c[0]) * crop.range_y) >> 32);
    ox[t] = crop.base_x + static_cast<int32_t>((static_cast<uint64_t>(c[1]) * crop.range_x) >> 32);
    if (flips) flips[t] = static_cast<uint8_t>(c[2] >> 31);
  }
}

}  // namespace

// x, y: n contiguous elements each, bf16 when is_bf16 else f32, not
// overlapping. scale: 1/(1 - rate) already rounded to x's dtype. key: two
// int64 words on the device, each in [0, 2^32). The element offset of x[0]
// in the mask's counter space is 4 * group0. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int cn_dropout(const void* x, void* y, int64_t n, int is_bf16, uint32_t threshold,
                          float scale, const int64_t* key, uint64_t group0, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, y, n, threshold, scale, key, group0, s)
                 : launch<float>(x, y, n, threshold, scale, key, group0, s);
}

// state: int64 (seed, step) on the device. words: 2 * n_keys host words
// (n_keys <= 16). keys: int64 (n_keys, 2) on the device, or null when
// n_keys is 0. b > 0 draws one field's crops for global rows row0 ..
// row0 + b - 1: oy, ox int32 (b,), flips uint8 (b,) or null for no flips;
// range_y, range_x in [1, 2^31); row0 >= 0 and row0 + b <= 2^31.
extern "C" int cn_step_draws(const int64_t* state, const uint32_t* words, int n_keys,
                             int64_t* keys, uint32_t crop_w2, uint32_t crop_w3, int row0, int b,
                             int base_y, int range_y, int base_x, int range_x, int32_t* oy,
                             int32_t* ox, uint8_t* flips, void* stream) {
  if (n_keys < 0 || n_keys > kMaxKeys || b < 0 || (n_keys == 0 && b == 0) || row0 < 0 ||
      b > 2147483647 - row0 || (b > 0 && (range_y < 1 || range_x < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  KeyWords kw{};
  for (int i = 0; i < 2 * n_keys; ++i) kw.w[i] = words[i];
  const CropDraw crop{crop_w2, crop_w3, row0, b, base_y, range_y, base_x, range_x};
  const int work = n_keys > b ? n_keys : b;
  const int threads = work < kThreads ? ((work + 31) / 32) * 32 : kThreads;
  const unsigned blocks = static_cast<unsigned>((work + threads - 1) / threads);
  step_draws_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      state, kw, n_keys, keys, crop, oy, ox, flips);
  return static_cast<int>(cudaGetLastError());
}
