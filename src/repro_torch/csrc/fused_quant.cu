// K2 and K3: rotate -> per-row absmax quantize in one pass, for sm_90a.
//
// K2 replaces the TPU kernel repro/kernels/registry.py::_fused_dequant_kernel
// (launched by _pallas_fused_dequant): K1's passes on the row
// (hadacore.cuh), the epilogue math of quant.cuh on the compute-dtype-
// rounded y, then out = q * s rounded to the io dtype (fake quant). This is
// the attention Q/K site of the serving path (n = head_dim = 128).
//
// K3 replaces repro/kernels/registry.py::_fused_kernel (launched by
// _pallas_fused): the same body, writing q in the mode's storage dtype
// (int8, or the e4m3 / e5m2 byte) and the f32 per-row scales instead of
// dequantizing. It serves hadamard(x, epilogue=QuantEpilogue(mode)).
//
// Bound on an H100: bytes, as K1 -- one read of the io row and one write
// (of the io row for K2; of one byte per element plus one f32 per row for
// K3); the quantize epilogue adds a handful of f32 operations and one
// shared-memory reduction per row. The rotated row never leaves shared
// memory between the transform and the epilogue, so the fusion saves the
// HBM round trip of y that a transform kernel plus a separate quantize
// pass would pay.
#include "quant.cuh"

namespace {

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
  quant::rotate_rows_absmax(x + base, buf, amax, nrows, n, r, cd, scale);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const float s = quant::row_scale(__int_as_float(amax[i / n]), mode);
    const float q = quant::to_grid(buf[i], s, mode);
    out[base + i] = hadacore::from_float<T>(__fmul_rn(q, s));
  }
}

template <typename T>
__global__ void fused_kernel(const T* x, uint8_t* q_out, float* s_out, long long rows,
                             int n, int r, int cd, float scale, int mode, int rpb) {
  extern __shared__ float smem[];
  float* buf = smem;
  int* amax = reinterpret_cast<int*>(smem + (size_t)rpb * n);
  const long long row0 = (long long)blockIdx.x * rpb;
  const long long left = rows - row0;
  const int nrows = left < rpb ? (int)left : rpb;
  const int total = nrows * n;
  const size_t base = (size_t)row0 * n;
  quant::rotate_rows_absmax(x + base, buf, amax, nrows, n, r, cd, scale);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const float s = quant::row_scale(__int_as_float(amax[i / n]), mode);
    q_out[base + i] = quant::encode(quant::to_grid(buf[i], s, mode), mode);
  }
  for (int i = threadIdx.x; i < nrows; i += blockDim.x)
    s_out[row0 + i] = quant::row_scale(__int_as_float(amax[i]), mode);
}

// One block per `rows_per_block` rows; dynamic shared memory for the rows'
// f32 values and their absmax.
template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, long long rows, int n, cudaStream_t stream, Args... args) {
  const int rpb = hadacore::rows_per_block(n, rows);
  const size_t smem = (size_t)rpb * n * sizeof(float) + (size_t)rpb * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + rpb - 1) / rpb;
  kernel<<<(unsigned)blocks, hadacore::kThreads, smem, stream>>>(args..., rpb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dequant(const void* x, void* out, long long rows, int n, int r, int cd,
                   float scale, int mode, cudaStream_t stream) {
  return launch_rows(fused_dequant_kernel<T>, rows, n, stream, static_cast<const T*>(x),
                     static_cast<T*>(out), rows, n, r, cd, scale, mode);
}

template <typename T>
int launch_fused(const void* x, void* q, void* s, long long rows, int n, int r, int cd,
                 float scale, int mode, cudaStream_t stream) {
  return launch_rows(fused_kernel<T>, rows, n, stream, static_cast<const T*>(x),
                     static_cast<uint8_t*>(q), static_cast<float*>(s), rows, n, r, cd, scale,
                     mode);
}

}  // namespace

extern "C" int fused_dequant_launch(const void* x, void* out, long long rows, int n, int r,
                                    int io, int cd, float scale, int mode, void* stream) {
  if (rows <= 0) return 0;
  if (mode < quant::kInt8 || mode > quant::kE5M2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case hadacore::kF32: return launch_dequant<float>(x, out, rows, n, r, cd, scale, mode, s);
    case hadacore::kBF16:
      return launch_dequant<__nv_bfloat16>(x, out, rows, n, r, cd, scale, mode, s);
    case hadacore::kF16: return launch_dequant<__half>(x, out, rows, n, r, cd, scale, mode, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3: q (rows, n) one storage byte per element, s (rows) f32.
extern "C" int fused_launch(const void* x, void* q, void* s_out, long long rows, int n,
                            int r, int io, int cd, float scale, int mode, void* stream) {
  if (rows <= 0) return 0;
  if (mode < quant::kInt8 || mode > quant::kE5M2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case hadacore::kF32: return launch_fused<float>(x, q, s_out, rows, n, r, cd, scale, mode, s);
    case hadacore::kBF16:
      return launch_fused<__nv_bfloat16>(x, q, s_out, rows, n, r, cd, scale, mode, s);
    case hadacore::kF16: return launch_fused<__half>(x, q, s_out, rows, n, r, cd, scale, mode, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
