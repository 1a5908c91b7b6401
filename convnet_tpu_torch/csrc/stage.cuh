// Staging of whole rows from device memory into shared memory with
// cp.async, shared by lrn_bwd.cu and pool_lrn.cu: a block starts the copy
// of its next rows, computes the current ones, and waits for the copy
// (cp.async.wait_group 0, then __syncthreads) only when it needs them.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// The most dynamic shared memory a block may ask for on sm_90.
constexpr int kMaxSmemPerBlock = 227 * 1024;

__host__ __device__ constexpr size_t align_up16(size_t bytes) { return (bytes + 15) & ~size_t{15}; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Every cp.async this thread has issued is complete; visible to the block
// after the next __syncthreads.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying `elems` elements from src (device memory) to dst (shared):
// with VEC, 16-byte cp.async copies in one commit group (complete after
// cp_async_wait_all), else plain copies. Visible to the block after the
// next __syncthreads.
template <bool VEC, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int elems) {
  if constexpr (VEC) {
    const int words = static_cast<int>(elems * sizeof(T) / 16);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < words; i += blockDim.x) cp_async16(d + i, s + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < elems; i += blockDim.x) dst[i] = src[i];
  }
}

}  // namespace
