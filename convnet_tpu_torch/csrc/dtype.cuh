// Loads and stores of the kernels' two activation dtypes as f32, shared by
// the kernels under csrc/ that take bf16 or f32 tensors.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float load_f32(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
// V elements of T at p as f32, with 16-byte loads when V elements are a
// whole number of 16-byte words (p then 16-byte aligned).
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr ((V * sizeof(T)) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int w = 0; w < V / kPer; ++w) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[w];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int v = 0; v < kPer; ++v) out[w * kPer + v] = load_f32(e, v);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = load_f32(p, v);
  }
}

// V f32 values rounded to T and stored at p, with 16-byte stores when V
// elements are a whole number of 16-byte words (p then 16-byte aligned).
template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  if constexpr ((V * sizeof(T)) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int w = 0; w < V / kPer; ++w) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int v = 0; v < kPer; ++v) store_f32(e, v, in[w * kPer + v]);
      reinterpret_cast<uint4*>(p)[w] = raw;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) store_f32(p, v, in[v]);
  }
}

// Two f32 values rounded to bf16 (to nearest even, as store_f32 rounds) in
// one word, `lo` in the low half: one instruction for the pair.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// 16 / sizeof(T) f32 values rounded to T as one 16-byte word: what
// store_vec writes, kept in registers.
__device__ __forceinline__ uint4 pack_word(const float* in, const float*) {
  return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]), __float_as_uint(in[2]),
                    __float_as_uint(in[3]));
}
__device__ __forceinline__ uint4 pack_word(const float* in, const __nv_bfloat16*) {
  return make_uint4(pack_bf16x2(in[0], in[1]), pack_bf16x2(in[2], in[3]),
                    pack_bf16x2(in[4], in[5]), pack_bf16x2(in[6], in[7]));
}

// v rounded to T and back: the value a T tensor holds.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

}  // namespace
