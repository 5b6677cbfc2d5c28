// K2 and K3: rotate -> per-row absmax quantize in one pass, for sm_90a.
//
// K2 replaces the TPU kernel repro/kernels/registry.py::_fused_dequant_kernel
// (launched by _pallas_fused_dequant): K1's passes on the row, the epilogue
// math of quant.cuh on the compute-dtype-rounded y, then out = q * s
// rounded to the io dtype (fake quant). This is the attention Q/K site of
// the serving path (n = head_dim = 128).
//
// The rotation is K1's own, bitwise: for a bf16 / fp16 compute dtype the
// tensor-core routine of hadacore_tc.cuh with the same host layout
// (fused_dequant_tc_kernel, fused_tc_kernel), which also leaves each row's
// absmax from the last pass's fragments (a shuffle reduction, one atomic
// per row and warp task); for f32 compute the CUDA-core passes of
// hadacore.cuh (fused_dequant_kernel, fused_kernel), as K1's f32 plans.
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
//
// Compiled with -DREPRO_STAMP_PHASES (kernels/build.py STAMP_DEFINE) the
// library also records where each K2 block spends its time (hadacore_tc.cuh
// stamp) and exports fused_dequant_stamps; the transform harness
// (repro_torch/bench/hadamard.py phases) reads it. The main build has none
// of it.
#include "hadacore_tc.cuh"
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

// The tensor-core bodies: the block's rows rotated in shared memory
// (compute-dtype bits), the absmax per row, then the epilogue per value.
template <typename T, typename C>
__device__ __forceinline__ void tc_rotate_absmax(const T* x, uint16_t* sm, int* amax,
                                                 long long rows, long long row0,
                                                 const hadacore_tc::Plan& plan, float scale,
                                                 bool vec) {
  const hadacore_tc::Plan& sp = hadacore_tc::stage_plan(plan);
  const hadacore_tc::Lane first =
      hadacore_tc::load_block<T, C>(x, sm, rows, row0, plan, sp, vec, scale);
  hadacore_tc::stamp(1);
  for (int i = threadIdx.x; i < (1 << (plan.lg_block - plan.lg_pitch)); i += blockDim.x)
    amax[i] = 0;
  __syncthreads();
  hadacore_tc::stamp(2);
  hadacore_tc::rotate<C, true>(sm, sp, scale, amax, first);
  hadacore_tc::stamp(6);
}

// The epilogues over the block's valid values (row i / n, column i % n),
// the mode a compile-time constant: quant.cuh's functions, specialised. A
// value's chain (IEEE division, rounding to the grid) is long and a thread
// has little else to do, so where a thread has more than one value it
// takes kBatch at a time, blockDim apart, loaded first and stored last,
// their chains interleaved.
constexpr int kBatch = 4;

template <typename C, typename Store>
__device__ __forceinline__ void for_values(const uint16_t* sm, const int* amax, int nrows,
                                           const hadacore_tc::Plan& plan, int mode,
                                           Store store) {
  const int lp = plan.lg_pitch, lg = __ffs(plan.n) - 1, total = nrows << lg;
  if (total <= (int)blockDim.x) {      // one value a thread (decode)
    const int i = threadIdx.x, row = i >> lg;
    if (i < total) {
      const float y = hadacore_tc::bits_to_float<C>(
          sm[hadacore_tc::phys((row << lp) | (i & (plan.n - 1)))]);
      const float s = quant::row_scale(__int_as_float(amax[row]), mode);
      store(i, quant::to_grid(y, s, mode), s);
    }
    return;
  }
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
    float y[kBatch], a[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = min(i0 + u * (int)blockDim.x, total - 1), row = i >> lg;
      y[u] = hadacore_tc::bits_to_float<C>(
          sm[hadacore_tc::phys((row << lp) | (i & (plan.n - 1)))]);
      a[u] = __int_as_float(amax[row]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * (int)blockDim.x;
      const float s = quant::row_scale(a[u], mode);
      const float q = quant::to_grid(y[u], s, mode);
      if (i < total) store(i, q, s);
    }
  }
}

// K2's: out = q * s in the io dtype.
template <typename T, typename C, int kMode>
__device__ __forceinline__ void dequant_values(T* out, const uint16_t* sm, const int* amax,
                                               int nrows, const hadacore_tc::Plan& plan) {
  for_values<C>(sm, amax, nrows, plan, kMode, [&](int i, float q, float s) {
    out[i] = hadacore::from_float<T>(__fmul_rn(q, s));
  });
}

// K3's: q in storage bytes, then the row scales.
template <typename C, int kMode>
__device__ __forceinline__ void encode_values(uint8_t* q_out, float* s_out, const uint16_t* sm,
                                              const int* amax, int nrows,
                                              const hadacore_tc::Plan& plan) {
  for_values<C>(sm, amax, nrows, plan, kMode, [&](int i, float q, float) {
    q_out[i] = quant::encode(q, kMode);
  });
  for (int i = threadIdx.x; i < nrows; i += blockDim.x)
    s_out[i] = quant::row_scale(__int_as_float(amax[i]), kMode);
}

template <typename T, typename C>
__global__ void __launch_bounds__(256)
    fused_dequant_tc_kernel(const T* x, T* out, long long rows, float scale, int mode,
                            bool vec, const __grid_constant__ hadacore_tc::Plan plan) {
  extern __shared__ __align__(16) uint16_t sm[];
  hadacore_tc::stamp(0);
  int* amax = reinterpret_cast<int*>(sm + hadacore_tc::phys(1 << plan.lg_block));
  const int rpb = 1 << (plan.lg_block - plan.lg_pitch);
  const long long row0 = (long long)blockIdx.x * rpb;
  tc_rotate_absmax<T, C>(x, sm, amax, rows, row0, plan, scale, vec);
  const int nrows = rows - row0 < rpb ? (int)(rows - row0) : rpb;
  T* o = out + row0 * plan.n;
  if (mode == quant::kInt8)
    dequant_values<T, C, quant::kInt8>(o, sm, amax, nrows, plan);
  else if (mode == quant::kE4M3)
    dequant_values<T, C, quant::kE4M3>(o, sm, amax, nrows, plan);
  else
    dequant_values<T, C, quant::kE5M2>(o, sm, amax, nrows, plan);
#ifdef REPRO_STAMP_PHASES
  __syncthreads();
#endif
  hadacore_tc::stamp(7);
}

template <typename T, typename C>
__global__ void __launch_bounds__(256)
    fused_tc_kernel(const T* x, uint8_t* q_out, float* s_out, long long rows, float scale,
                    int mode, bool vec, const __grid_constant__ hadacore_tc::Plan plan) {
  extern __shared__ __align__(16) uint16_t sm[];
  int* amax = reinterpret_cast<int*>(sm + hadacore_tc::phys(1 << plan.lg_block));
  const int rpb = 1 << (plan.lg_block - plan.lg_pitch);
  const long long row0 = (long long)blockIdx.x * rpb;
  tc_rotate_absmax<T, C>(x, sm, amax, rows, row0, plan, scale, vec);
  const int nrows = rows - row0 < rpb ? (int)(rows - row0) : rpb;
  uint8_t* q = q_out + row0 * plan.n;
  if (mode == quant::kInt8)
    encode_values<C, quant::kInt8>(q, s_out + row0, sm, amax, nrows, plan);
  else if (mode == quant::kE4M3)
    encode_values<C, quant::kE4M3>(q, s_out + row0, sm, amax, nrows, plan);
  else
    encode_values<C, quant::kE5M2>(q, s_out + row0, sm, amax, nrows, plan);
}

template <typename Kernel, typename... Args>
int launch_tc(Kernel kernel, const hadacore_tc::Plan* plan, int n, long long rows,
              cudaStream_t stream, Args... args) {
  long long blocks = 0;
  const size_t smem = plan ? hadacore_tc::shared_bytes(*plan) : 0;
  const int rc = hadacore_tc::prepare(kernel, plan, n, rows, smem, &blocks);
  if (rc != 0) return rc;
  kernel<<<(unsigned)blocks, plan->threads, smem, stream>>>(args..., *plan);
  return (int)cudaGetLastError();
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
                   float scale, int mode, const hadacore_tc::Plan* plan, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const bool vec = hadacore_tc::vec_ok(x, x, n);
  switch (cd) {
    case hadacore::kF32:
      return launch_rows(fused_dequant_kernel<T>, rows, n, stream, xt, ot, rows, n, r, cd,
                         scale, mode);
    case hadacore::kBF16:
      return launch_tc(fused_dequant_tc_kernel<T, __nv_bfloat16>, plan, n, rows, stream, xt,
                       ot, rows, scale, mode, vec);
    case hadacore::kF16:
      return launch_tc(fused_dequant_tc_kernel<T, __half>, plan, n, rows, stream, xt, ot, rows,
                       scale, mode, vec);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_fused(const void* x, void* q, void* s, long long rows, int n, int r, int cd,
                 float scale, int mode, const hadacore_tc::Plan* plan, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  uint8_t* qt = static_cast<uint8_t*>(q);
  float* st = static_cast<float*>(s);
  const bool vec = hadacore_tc::vec_ok(x, x, n);
  switch (cd) {
    case hadacore::kF32:
      return launch_rows(fused_kernel<T>, rows, n, stream, xt, qt, st, rows, n, r, cd, scale,
                         mode);
    case hadacore::kBF16:
      return launch_tc(fused_tc_kernel<T, __nv_bfloat16>, plan, n, rows, stream, xt, qt, st,
                       rows, scale, mode, vec);
    case hadacore::kF16:
      return launch_tc(fused_tc_kernel<T, __half>, plan, n, rows, stream, xt, qt, st, rows,
                       scale, mode, vec);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K2. plan: the tensor-core layout (repro_torch/kernels/hadacore.py
// tc_launch) for a bf16 / fp16 compute dtype; unused for f32 compute.
extern "C" int fused_dequant_launch(const void* x, void* out, long long rows, int n, int r,
                                    int io, int cd, float scale, int mode,
                                    const hadacore_tc::Plan* plan, void* stream) {
  if (rows <= 0) return 0;
  if (mode < quant::kInt8 || mode > quant::kE5M2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case hadacore::kF32:
      return launch_dequant<float>(x, out, rows, n, r, cd, scale, mode, plan, s);
    case hadacore::kBF16:
      return launch_dequant<__nv_bfloat16>(x, out, rows, n, r, cd, scale, mode, plan, s);
    case hadacore::kF16:
      return launch_dequant<__half>(x, out, rows, n, r, cd, scale, mode, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3: q (rows, n) one storage byte per element, s (rows) f32.
extern "C" int fused_launch(const void* x, void* q, void* s_out, long long rows, int n,
                            int r, int io, int cd, float scale, int mode,
                            const hadacore_tc::Plan* plan, void* stream) {
  if (rows <= 0) return 0;
  if (mode < quant::kInt8 || mode > quant::kE5M2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case hadacore::kF32:
      return launch_fused<float>(x, q, s_out, rows, n, r, cd, scale, mode, plan, s);
    case hadacore::kBF16:
      return launch_fused<__nv_bfloat16>(x, q, s_out, rows, n, r, cd, scale, mode, plan, s);
    case hadacore::kF16:
      return launch_fused<__half>(x, q, s_out, rows, n, r, cd, scale, mode, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef REPRO_STAMP_PHASES
// The phase-stamping build (hadacore_tc.cuh stamp): the stamps of the
// first `blocks` blocks of the last K2 launch, kStamps per block, into host
// memory.
extern "C" int fused_dequant_stamps(long long* host, int blocks) {
  using hadacore_tc::kStampBlocks;
  using hadacore_tc::kStamps;
  if (blocks < 0 || blocks > kStampBlocks) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, hadacore_tc::g_stamps,
                                   sizeof(long long) * kStamps * blocks);
}
#endif
