// K1: HadaCore Walsh-Hadamard transform of the last axis, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/registry.py::_hadacore_kernel
// (launched by _pallas_transform; entry point repro/kernels/hadacore.py::
// hadacore). Same function: the WHT of each row of n <= 32768 points (n a
// power of 2) through the plan's passes, f32 accumulation, a rounding to
// the compute dtype after every pass, the compute-dtype-rounded scale
// folded into pass 0; io f32 / bf16 / fp16.
//
// Two bodies, one entry point (hadacore_launch):
//   * a 16-bit compute dtype (bf16, fp16) runs the paper's form on the
//     tensor cores, hadacore_tc_kernel (hadacore_tc.cuh: one mma.sync stage
//     plus register butterflies per pass, one barrier per pass);
//   * f32 compute runs fwht_kernel, the CUDA-core butterflies
//     (hadacore.cuh run_passes): the reference's f32 passes are full f32,
//     and the tensor cores would take f32 operands only as TF32.
// fwht_launch runs fwht_kernel for any compute dtype: it is K1's first
// body (the port's first slice), kept as the in-repo stand-in for the FWHT
// the paper compares against, and the rotation the quant_dot family still
// runs inside its kernels.
//
// Bound on an H100: bytes. Each element is read once and written once
// (2 x io bytes), against log2(n) adds. Both bodies keep the rows in shared
// memory between the passes, so HBM sees one read and one write per
// element. The FWHT makes one pass over shared memory per butterfly stage
// (log2 n of them, a barrier after each, plus a rounding sweep per pass);
// the tensor-core body one per reference pass (at most 3).
//
// `out` may alias `x` (the in-place form of the paper's Appendix B): a
// block reads all its rows into shared memory before writing any of them,
// and blocks own disjoint rows.
#include "hadacore_tc.cuh"

namespace {

template <typename T>
__global__ void fwht_kernel(const T* x, T* out, long long rows, int n, int r, int cd,
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

template <typename T, typename C>
__global__ void __launch_bounds__(256)
    hadacore_tc_kernel(const T* x, T* out, long long rows, float scale, bool vec,
                       const __grid_constant__ hadacore_tc::Plan plan) {
  extern __shared__ __align__(16) uint16_t sm[];
  const long long row0 = (long long)blockIdx.x << (plan.lg_block - plan.lg_pitch);
  const hadacore_tc::Plan& sp = hadacore_tc::stage_plan(plan);
  const hadacore_tc::Lane first =
      hadacore_tc::load_block<T, C>(x, sm, rows, row0, plan, sp, vec, scale);
  __syncthreads();
  hadacore_tc::rotate<C, false>(sm, sp, scale, nullptr, first);
  hadacore_tc::store_rows<T, C>(out, sm, rows, row0, plan, vec);
}

template <typename T>
int launch_fwht(const void* x, void* out, long long rows, int n, int r, int cd, float scale,
                cudaStream_t stream) {
  const int rpb = hadacore::rows_per_block(n, rows);
  const size_t smem = (size_t)rpb * n * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fwht_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + rpb - 1) / rpb;
  fwht_kernel<T><<<(unsigned)blocks, hadacore::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, n, r, cd, scale, rpb);
  return (int)cudaGetLastError();
}

template <typename T, typename C>
int launch_tc(const void* x, void* out, long long rows, int n, float scale,
              const hadacore_tc::Plan* plan, cudaStream_t stream) {
  long long blocks = 0;
  const size_t smem = plan ? hadacore_tc::shared_bytes(*plan) : 0;
  const int rc = hadacore_tc::prepare(hadacore_tc_kernel<T, C>, plan, n, rows, smem, &blocks);
  if (rc != 0) return rc;
  hadacore_tc_kernel<T, C><<<(unsigned)blocks, plan->threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, scale,
      hadacore_tc::vec_ok(x, out, n), *plan);
  return (int)cudaGetLastError();
}

template <typename C>
int launch_tc_io(const void* x, void* out, long long rows, int n, int io, float scale,
                 const hadacore_tc::Plan* plan, cudaStream_t s) {
  switch (io) {
    case hadacore::kF32: return launch_tc<float, C>(x, out, rows, n, scale, plan, s);
    case hadacore::kBF16: return launch_tc<__nv_bfloat16, C>(x, out, rows, n, scale, plan, s);
    case hadacore::kF16: return launch_tc<__half, C>(x, out, rows, n, scale, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The CUDA-core FWHT (the baseline), any compute dtype.
extern "C" int fwht_launch(const void* x, void* out, long long rows, int n, int r, int io,
                           int cd, float scale, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case hadacore::kF32: return launch_fwht<float>(x, out, rows, n, r, cd, scale, s);
    case hadacore::kBF16: return launch_fwht<__nv_bfloat16>(x, out, rows, n, r, cd, scale, s);
    case hadacore::kF16: return launch_fwht<__half>(x, out, rows, n, r, cd, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1: the tensor cores for a bf16 / fp16 compute dtype (plan: the host's
// layout, repro_torch/kernels/hadacore.py tc_launch), the FWHT for f32
// compute (plan unused).
extern "C" int hadacore_launch(const void* x, void* out, long long rows, int n, int r, int io,
                               int cd, float scale, const hadacore_tc::Plan* plan,
                               void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cd) {
    case hadacore::kF32: return fwht_launch(x, out, rows, n, r, io, cd, scale, stream);
    case hadacore::kBF16:
      return launch_tc_io<__nv_bfloat16>(x, out, rows, n, io, scale, plan, s);
    case hadacore::kF16: return launch_tc_io<__half>(x, out, rows, n, io, scale, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
