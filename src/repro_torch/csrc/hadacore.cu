// K1: HadaCore Walsh-Hadamard transform of the last axis, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/registry.py::_hadacore_kernel
// (launched by _pallas_transform; entry point repro/kernels/hadacore.py::
// hadacore). Same function: the WHT of each row of n <= 32768 points (n a
// power of 2) through the plan's passes, f32 accumulation, a rounding to
// the compute dtype after every pass, the compute-dtype-rounded scale
// folded into pass 0; io f32 / bf16 / fp16.
//
// Bound on an H100: bytes. Each element is read once and written once
// (2 x io bytes), against log2(n) adds -- at n = 2048 bf16 that is 4 bytes
// for 11 adds, about 7x under the card's f32 CUDA-core rate per byte of
// HBM bandwidth. The design keeps the rows in shared memory between the
// passes (a row of up to 32768 f32 values is 128 KB of dynamic shared
// memory), so HBM sees exactly one read and one write per element. What
// this first version leaves on the table is shared-memory traffic: every
// butterfly stage reads and writes the row once, which costs more than the
// HBM transfer at large n. The paper's design -- a 16x16 tensor-core base
// with the data exchanged in registers -- is the later step.
//
// Launch: one block of hadacore::kThreads threads per `rows_per_block` rows;
// the rows are contiguous (the wrapper checks). `out` may alias `x` (the
// in-place form of the paper's Appendix B): a block reads all its rows
// into shared memory before writing any of them, and blocks own disjoint
// rows.
#include "hadacore.cuh"

namespace {

template <typename T>
__global__ void hadacore_kernel(const T* x, T* out, long long rows, int n, int r, int cd,
                                float scale, int rpb) {
  extern __shared__ float buf[];
  const long long row0 = (long long)blockIdx.x * rpb;
  const long long left = rows - row0;
  const int nrows = left < rpb ? (int)left : rpb;
  const int total = nrows * n;
  const size_t base = (size_t)row0 * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x)
    buf[i] = hadacore::round_to(hadacore::to_float(x[base + i]), cd);
  __syncthreads();
  hadacore::run_passes(buf, total, n, r, cd, scale);
  for (int i = threadIdx.x; i < total; i += blockDim.x)
    out[base + i] = hadacore::from_float<T>(buf[i]);
}

template <typename T>
int launch(const void* x, void* out, long long rows, int n, int r, int cd, float scale,
           cudaStream_t stream) {
  const int rpb = hadacore::rows_per_block(n, rows);
  const size_t smem = (size_t)rpb * n * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(hadacore_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + rpb - 1) / rpb;
  hadacore_kernel<T><<<(unsigned)blocks, hadacore::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, n, r, cd, scale, rpb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hadacore_launch(const void* x, void* out, long long rows, int n, int r,
                               int io, int cd, float scale, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case hadacore::kF32: return launch<float>(x, out, rows, n, r, cd, scale, s);
    case hadacore::kBF16: return launch<__nv_bfloat16>(x, out, rows, n, r, cd, scale, s);
    case hadacore::kF16: return launch<__half>(x, out, rows, n, r, cd, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
