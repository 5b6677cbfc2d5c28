// K2: rotate -> per-row absmax fake-quant (quantize, then dequantize
// through the storage grid) in one pass, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/registry.py::_fused_dequant_kernel
// (launched by _pallas_fused_dequant). Same function: K1's passes on the
// row (hadacore.cuh), then on the compute-dtype-rounded y in f32
//   s = max(absmax(y), 1e-8) * f32(1 / qmax) (what XLA compiles the
//                                              reference's `/ qmax` to)
//   q = y / s                                  (IEEE division)
//   int8: q = clamp(rint(q), -127, 127)        (half to even, like jnp.round)
//   fp8:  q = q rounded to the e4m3 / e5m2 grid (the cast round trip, with
//         no saturation: e4m3 overflow gives NaN, e5m2 overflow inf)
//   out = q * s rounded to the io dtype.
// This is the attention Q/K site of the serving path (n = head_dim = 128).
//
// Bound on an H100: bytes, as K1 -- one read and one write of the io row
// per element; the quantize epilogue adds a handful of f32 operations and
// one shared-memory reduction per row. The rotated row never leaves shared
// memory between the transform and the epilogue, so the fusion saves the
// HBM round trip of y that a transform kernel plus a separate quantize
// pass would pay.
#include "hadacore.cuh"

namespace {

// mode codes shared with repro_torch/kernels/fused_quant.py (MODE_CODES)
enum Mode : int { kInt8 = 0, kE4M3 = 1, kE5M2 = 2 };

// Round q to the fp8 grid (3 or 2 mantissa bits, smallest normal exponent
// emin, subnormal spacing 2^(emin - mbits)), nearest even, no saturation.
__device__ __forceinline__ float round_fp8(float q, int mbits, int emin, float maxv,
                                           bool nan_on_overflow) {
  if (isnan(q)) return q;
  const float a = fabsf(q);
  float rq;
  if (isinf(a)) {
    rq = a;
  } else {
    const int e = a >= ldexpf(1.0f, emin) ? ilogbf(a) : emin;
    rq = ldexpf(rintf(ldexpf(a, mbits - e)), e - mbits);
  }
  if (rq > maxv) rq = nan_on_overflow ? __int_as_float(0x7fc00000) : INFINITY;
  return copysignf(rq, q);
}

template <typename T>
__global__ void fused_dequant_kernel(const T* x, T* out, long long rows, int n, int r,
                                     int cd, float scale, int mode, int rpb) {
  extern __shared__ float smem[];
  float* buf = smem;
  int* amax = reinterpret_cast<int*>(smem + (size_t)rpb * n);
  const long long row0 = (long long)blockIdx.x * rpb;
  const long long left = rows - row0;
  const int nrows = left < rpb ? (int)left : rpb;
  const int total = nrows * n;
  const size_t base = (size_t)row0 * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x)
    buf[i] = hadacore::round_to(hadacore::to_float(x[base + i]), cd);
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) amax[i] = 0;
  __syncthreads();
  hadacore::run_passes(buf, total, n, r, cd, scale);

  // per-row absmax: |y| >= 0, so the f32 bit patterns order like the
  // values and a NaN (0x7fc00000 after fabsf) beats every finite value,
  // propagating like jnp.max does
  for (int i = threadIdx.x; i < total; i += blockDim.x)
    atomicMax(&amax[i / n], __float_as_int(fabsf(buf[i])));
  __syncthreads();

  const float qmax = mode == kInt8 ? 127.0f : (mode == kE4M3 ? 448.0f : 57344.0f);
  const float rqmax = __frcp_rn(qmax);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const float a = __int_as_float(amax[i / n]);
    const float s = isnan(a) ? a : __fmul_rn(fmaxf(a, 1e-8f), rqmax);
    float q = __fdiv_rn(buf[i], s);
    if (mode == kInt8) {
      q = rintf(q);
      if (!isnan(q)) q = fminf(fmaxf(q, -qmax), qmax);
    } else if (mode == kE4M3) {
      q = round_fp8(q, 3, -6, 448.0f, true);
    } else {
      q = round_fp8(q, 2, -14, 57344.0f, false);
    }
    out[base + i] = hadacore::from_float<T>(__fmul_rn(q, s));
  }
}

template <typename T>
int launch(const void* x, void* out, long long rows, int n, int r, int cd, float scale,
           int mode, cudaStream_t stream) {
  const int rpb = hadacore::rows_per_block(n, rows);
  const size_t smem = (size_t)rpb * n * sizeof(float) + (size_t)rpb * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fused_dequant_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + rpb - 1) / rpb;
  fused_dequant_kernel<T><<<(unsigned)blocks, hadacore::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, n, r, cd, scale, mode, rpb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_dequant_launch(const void* x, void* out, long long rows, int n, int r,
                                    int io, int cd, float scale, int mode, void* stream) {
  if (rows <= 0) return 0;
  if (mode < kInt8 || mode > kE5M2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case hadacore::kF32: return launch<float>(x, out, rows, n, r, cd, scale, mode, s);
    case hadacore::kBF16:
      return launch<__nv_bfloat16>(x, out, rows, n, r, cd, scale, mode, s);
    case hadacore::kF16: return launch<__half>(x, out, rows, n, r, cd, scale, mode, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
