// Shared device code of the HadaCore transform kernels (K1 hadacore.cu;
// through quant.cuh, K2 and K3 in fused_quant.cu and K4-K6s in quant_dot.cuh):
// dtype conversions and the plan's passes on a block of rows held in
// shared memory.
//
// The passes follow the reference plan (repro/core/hadamard.py
// _apply_passes): n = 128^k * r, pass 0 is the minor factor (H_n for
// n < 128, I_{128/r} (x) H_r for r > 1, else H_128 on contiguous
// 128-chunks) with the scale folded in, then one pass per major 128-factor,
// most significant first. Each pass is computed as the butterfly stages of
// its factor (stage h pairs element i with i + h) in f32 on CUDA cores --
// never TF32 -- and rounded to the compute dtype at the pass boundary,
// which is where the reference rounds its f32-accumulated products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace hadacore {

// dtype codes shared with repro_torch/kernels/hadacore.py (DTYPE_CODES)
enum Dtype : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// Round an f32 value to the compute dtype (round to nearest even) and back.
__device__ __forceinline__ float round_to(float v, int cd) {
  if (cd == kBF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (cd == kF16) return __half2float(__float2half_rn(v));
  return v;
}

// Butterfly stages h = lo, 2 lo, ..., < hi over every row of buf (rows of
// n floats, contiguous). 2h divides n, so a pair never crosses a row.
__device__ __forceinline__ void run_stages(float* buf, int total, int lo, int hi) {
  const int half = total >> 1;
  for (int h = lo; h < hi; h <<= 1) {
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int i = ((p & ~(h - 1)) << 1) | (p & (h - 1));  // h is a power of 2
      const float a = buf[i];
      const float b = buf[i + h];
      buf[i] = __fadd_rn(a, b);
      buf[i + h] = __fsub_rn(a, b);
    }
    __syncthreads();
  }
}

// End of a pass: (pass 0 only) multiply by the compute-dtype-rounded scale,
// then round every element to the compute dtype.
__device__ __forceinline__ void end_pass(float* buf, int total, int cd, float scale,
                                         bool scaled) {
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const float v = scaled ? __fmul_rn(buf[i], scale) : buf[i];
    buf[i] = round_to(v, cd);
  }
  __syncthreads();
}

// All passes of the plan on `total` floats (whole rows of n) in shared
// memory. Expects the caller to have synchronised after filling buf.
__device__ __forceinline__ void run_passes(float* buf, int total, int n, int r, int cd,
                                           float scale) {
  const int first_hi = (n < 128) ? n : (r > 1 ? r : 128);
  run_stages(buf, total, 1, first_hi);
  end_pass(buf, total, cd, scale, true);
  if (n >= 128) {
    const int last_post = (r > 1) ? r : 128;
    for (int post = n / 128; post >= last_post; post /= 128) {
      run_stages(buf, total, post, post * 128);
      end_pass(buf, total, cd, 1.0f, false);
    }
  }
}

// Rows per block: small rows share a block so a block holds up to ~4096
// values, but never so many that fewer than ~264 blocks (two per SM of
// the H100's 132) run when the rows allow more; rows of 4096 and more take
// a block each (up to 32768 f32 = 128 KB). Rows are independent, so this
// choice changes no result.
inline int rows_per_block(int n, long long rows) {
  long long rpb = n >= 4096 ? 1 : 4096 / n;
  const long long spread = (rows + 263) / 264;
  if (rpb > spread) rpb = spread;
  return rpb < 1 ? 1 : (int)rpb;
}

constexpr int kThreads = 256;

}  // namespace hadacore
