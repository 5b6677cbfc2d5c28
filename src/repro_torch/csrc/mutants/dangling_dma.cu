// M2: a deliberately broken K5 for the linter's dma-safety rule, the Hopper
// twin of repro/analysis/mutations.py::_mutant_dangling_dma (launched
// there through the pallas_call of _launch). It is K5 -- the dense streamed
// body of ../quant_dot.cuh, kStreamed = true -- with the ring's final
// drain (cp.async.wait_group 0 before the block ends) removed: nothing in
// the code any longer makes the block's copies land before it ends, the
// reference mutant's "a start dangles at the end of every row block". Each
// k-step still waits for its own stage before reading it, so the output is
// K5's, bitwise; the rule catches the fault from the PTX alone. Its plain
// version is K5's (kernels/quant_dot.py::quant_dot_plain).
//
// Built only by the linter (repro_torch/kernels/build.py, lint targets); no
// dispatch reaches it. bf16 activations, int8 / fp8 weights.
#define REPRO_MUTANT_DANGLING_DMA 1
#include "quant_dot.cuh"

// The arguments of mutant_unguarded_rotate_launch.
extern "C" int mutant_dangling_dma_launch(const void* x, const void* wq, const void* sw,
                                          void* out, long long m, int n, int d, int r, int io,
                                          int cd, float scale, int mode, void* stream) {
  if (io != hadacore::kBF16) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0) return 0;
  if (n < 2 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (mode < quant::kInt8 || mode > quant::kE5M2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == quant::kInt8)
    return launch<__nv_bfloat16, true, true, false, false, false>(x, wq, sw, out, m, n, d, 1, 1,
                                                                  0, r, cd, scale, mode, Abft{}, s);
  return launch<__nv_bfloat16, false, true, false, false, false>(x, wq, sw, out, m, n, d, 1, 1, 0,
                                                                 r, cd, scale, mode, Abft{}, s);
}

// K5's launch geometry.
extern "C" int mutant_dangling_dma_grid(long long m, int n, int d, int mode, long long* out) {
  return launch_grid(m, n, d, 1, kStreamedSchedule, 0, mode, false, out);
}

extern "C" int mutant_dangling_dma_attributes(long long m, int n, int mode, long long* out) {
  const bool is_int = mode == quant::kInt8;
  const int bm = pick_bm(m, n, true, false);
  return func_attributes(is_int ? kernel_for_bm<__nv_bfloat16, true, true, false, false, false>(bm)
                                : kernel_for_bm<__nv_bfloat16, false, true, false, false, false>(bm),
                         bm, out);
}

QUANT_DOT_COUNT_EXPORTS(mutant_dangling_dma)
