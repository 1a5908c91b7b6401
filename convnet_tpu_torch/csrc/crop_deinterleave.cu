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
// Design, simple first: one CTA of 256 threads an (image, output row),
// grid (4P, B). The CTA copies the 12Q input elements of its crop row
// (oy + 4p + rp, from column 3 * ox: no alignment assumed) into shared
// memory with neighbouring threads on neighbouring bytes, then writes the
// output row in order, each thread reading its element's (q', cpc') from
// shared memory: the strided deinterleave happens in shared memory, and
// both device-memory passes are coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowPhases = 4, kColPhases = 12;  // stride 4, 3 channels

__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
crop_deinterleave_kernel(const Tin* __restrict__ x, const int* __restrict__ oy,
                         const int* __restrict__ ox, const int* __restrict__ fl,
                         __nv_bfloat16* __restrict__ o, int h, int l, int p, int q,
                         bool normalize, float scale, float shift) {
  extern __shared__ unsigned char smem[];
  Tin* row = reinterpret_cast<Tin*>(smem);
  const int b = blockIdx.y, r = blockIdx.x;  // r = rp * p + pp
  const int rp = r / p, pp = r - rp * p;
  const int cw = kColPhases * q;
  const int64_t y0 = oy[b], x0 = 3 * static_cast<int64_t>(ox[b]);
  __nv_bfloat16* dst = o + (static_cast<int64_t>(b) * kRowPhases * p + r) * cw;
  if (y0 < 0 || y0 + kRowPhases * p > h || x0 < 0 || x0 + cw > l) {
    for (int c = threadIdx.x; c < cw; c += kThreads) dst[c] = __ushort_as_bfloat16(0x7fc0);
    return;
  }
  const bool flip = fl != nullptr && fl[b] > 0;
  const Tin* src = x + (static_cast<int64_t>(b) * h + y0 + kRowPhases * pp + rp) * l + x0;
  for (int c = threadIdx.x; c < cw; c += kThreads) row[c] = src[c];
  __syncthreads();
  for (int c = threadIdx.x; c < cw; c += kThreads) {
    const int cpc = c / q;
    int qq = c - cpc * q;
    int cp = cpc / 3;
    const int ch = cpc - 3 * cp;
    if (flip) {
      qq = q - 1 - qq;
      cp = 3 - cp;
    }
    float v = to_f32(row[kColPhases * qq + 3 * cp + ch]);
    if (normalize) v = __fsub_rn(__fmul_rn(v, scale), shift);
    dst[c] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// x: (b, h, l) u8 (is_bf16 0) or bf16 (is_bf16 1) on the device, any
// alignment; oy, ox: int32 (b,) on the device; fl: int32 (b,) or null; o:
// bf16 (b, 4p, 12q), not overlapping x. normalize applies (v * scale) -
// shift. Launches on `stream` and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for arguments outside those (b
// above 65535: the grid's second dimension).
extern "C" int cn_crop_deinterleave(const void* x, const void* oy, const void* ox, const void* fl,
                                    void* o, int b, int h, int l, int p, int q, int is_bf16,
                                    int normalize, float scale, float shift, void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || l <= 0 || p <= 0 || q <= 0 || kRowPhases * p > 65535 ||
      oy == nullptr || ox == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(kRowPhases * p, b);
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    crop_deinterleave_kernel<__nv_bfloat16><<<grid, kThreads, kColPhases * q * 2, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(oy),
        static_cast<const int*>(ox), static_cast<const int*>(fl),
        static_cast<__nv_bfloat16*>(o), h, l, p, q, normalize != 0, scale, shift);
  } else {
    crop_deinterleave_kernel<uint8_t><<<grid, kThreads, kColPhases * q, st>>>(
        static_cast<const uint8_t*>(x), static_cast<const int*>(oy), static_cast<const int*>(ox),
        static_cast<const int*>(fl), static_cast<__nv_bfloat16*>(o), h, l, p, q, normalize != 0,
        scale, shift);
  }
  return static_cast<int>(cudaGetLastError());
}
