// Shared device code of the rotate -> quantize kernels (K2 and K3 in
// fused_quant.cu; K4, K5, K6 and K6s in quant_dot.cu): K1's passes on a
// block of rows plus the per-row absmax, and the epilogue math of
// repro/kernels/registry.py::_quantize_rows on the compute-dtype-rounded row
// in f32:
//   s = max(absmax(y), 1e-8) * f32(1 / qmax)   (what XLA compiles the
//                                               reference's `/ qmax` to)
//   q = y / s                                   (IEEE division)
//   int8: q = clamp(rint(q), -127, 127)         (half to even, like jnp.round)
//   fp8:  q = q rounded to the e4m3 / e5m2 grid (the cast, with no
//         saturation: e4m3 overflow gives NaN, e5m2 overflow inf)
#pragma once

#include <stdint.h>

#include "hadacore.cuh"

namespace quant {

// mode codes shared with repro_torch/kernels/fused_quant.py (MODE_CODES)
enum Mode : int { kInt8 = 0, kE4M3 = 1, kE5M2 = 2 };

__device__ __forceinline__ float qmax(int mode) {
  return mode == kInt8 ? 127.0f : (mode == kE4M3 ? 448.0f : 57344.0f);
}

// 2^k as an f32 value, for k in [-126, 127] (a normal number).
__device__ __forceinline__ float pow2(int k) { return __int_as_float((127 + k) << 23); }

// Round q to the fp8 grid (3 or 2 mantissa bits, smallest normal exponent
// emin, subnormal spacing 2^(emin - mbits)), nearest even, no saturation.
// e is ilogb(a) for a normal a >= 2^emin (its exponent field less the
// bias), else emin; then a * 2^(mbits - e) and rint(...) * 2^(e - mbits) are
// exact products by powers of 2 within [-125, 125] (ldexpf's values, or
// inf where the rounding overflows f32, as ldexpf), without its calls.
__device__ __forceinline__ float round_fp8(float q, int mbits, int emin, float maxv,
                                           bool nan_on_overflow) {
  if (isnan(q)) return q;
  const float a = fabsf(q);
  float rq;
  if (isinf(a)) {
    rq = a;
  } else {
    const int e = a >= pow2(emin) ? (__float_as_int(a) >> 23) - 127 : emin;
    rq = __fmul_rn(rintf(__fmul_rn(a, pow2(mbits - e))), pow2(e - mbits));
  }
  if (rq > maxv) rq = nan_on_overflow ? __int_as_float(0x7fc00000) : INFINITY;
  return copysignf(rq, q);
}

// The row's scale from its absmax (a NaN absmax propagates).
__device__ __forceinline__ float row_scale(float amax, int mode) {
  return isnan(amax) ? amax : __fmul_rn(fmaxf(amax, 1e-8f), __frcp_rn(qmax(mode)));
}

// y / s on the mode's grid, as an f32 value.
__device__ __forceinline__ float to_grid(float y, float s, int mode) {
  float q = __fdiv_rn(y, s);
  if (mode == kInt8) {
    q = rintf(q);
    if (!isnan(q)) q = fminf(fmaxf(q, -127.0f), 127.0f);
    return q;
  }
  if (mode == kE4M3) return round_fp8(q, 3, -6, 448.0f, true);
  return round_fp8(q, 2, -14, 57344.0f, false);
}

// The storage byte of a grid value: int8 two's complement, e4m3fn
// (NaN 0x7f), or e5m2 (the high byte of the fp16 encoding, which holds
// every e5m2 value and inf exactly).
__device__ __forceinline__ uint8_t encode(float q, int mode) {
  if (mode == kInt8) return (uint8_t)(int8_t)(int)q;
  if (mode == kE5M2) return (uint8_t)(__half_as_ushort(__float2half_rn(q)) >> 8);
  const uint8_t sign = signbit(q) ? 0x80 : 0;
  const float a = fabsf(q);
  if (isnan(a)) return sign | 0x7f;
  if (a < 0.015625f) return sign | (uint8_t)(int)(a * 512.0f);  // subnormal: m * 2^-9
  const int e = ilogbf(a);
  return sign | (uint8_t)(((e + 7) << 3) | ((int)ldexpf(a, 3 - e) - 8));
}

// Load `nrows` rows of n values into buf (rounded to the compute dtype):
// row i starts at row(i), a callable returning a const T*. Then run the
// plan's passes, and leave each row's absmax in amax[] as f32 bits. |y| >= 0,
// so the bit patterns order like the values, and a NaN (0x7fc00000 after
// fabsf) beats every finite value, propagating as jnp.max does. For n >= 32
// the 32 lanes of a warp read 32 values of one row (blockDim and n are
// multiples of 32), so they reduce among themselves and one lane updates
// the row: one shared atomic per warp instead of one per value, which would
// serialise on the row's address. Ends synchronised.
template <typename T, typename RowPtr>
__device__ __forceinline__ void rotate_rows_absmax_at(RowPtr row, float* buf, int* amax,
                                                      int nrows, int n, int r, int cd,
                                                      float scale) {
  const int total = nrows * n;
  const int lg = __ffs(n) - 1;  // n is a power of 2
  for (int i = threadIdx.x; i < total; i += blockDim.x)
    buf[i] = hadacore::round_to(hadacore::to_float(row(i >> lg)[i & (n - 1)]), cd);
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) amax[i] = 0;
  __syncthreads();
  hadacore::run_passes(buf, total, n, r, cd, scale);
  if (n >= 32) {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int v = __reduce_max_sync(0xffffffffu, __float_as_int(fabsf(buf[i])));
      if ((threadIdx.x & 31) == 0) atomicMax(&amax[i >> lg], v);
    }
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x)
      atomicMax(&amax[i >> lg], __float_as_int(fabsf(buf[i])));
  }
  __syncthreads();
}

// rotate_rows_absmax_at on `nrows` contiguous rows starting at x.
template <typename T>
__device__ __forceinline__ void rotate_rows_absmax(const T* x, float* buf, int* amax,
                                                   int nrows, int n, int r, int cd,
                                                   float scale) {
  rotate_rows_absmax_at<T>([=](int i) { return x + (size_t)i * n; }, buf, amax, nrows, n, r,
                           cd, scale);
}

}  // namespace quant
