// M1: a deliberately broken K4 for the linter's rotate-once rule, the
// Hopper twin of repro/analysis/mutations.py::_mutant_unguarded_rotate
// (launched there through the pallas_call of _launch). It is K4 -- the
// dense rotate-once body of ../quant_dot.cuh with kStreamed = kRevisit =
// false -- with the rotate + quantize phase moved inside the loop over the
// block's rounds of column tiles, so every block's row block is rotated
// and quantized again before each round (each 32-column tile where the
// block's tiles are split across its warps, as at the linter's 64-row
// site). The rotation is deterministic, so the output
// is bitwise K4's: only a count of rotations tells the two apart
// (repro_torch/analysis/rules.py, rotate-once-contract). Its plain version
// is K4's (kernels/quant_dot.py::quant_dot_plain).
//
// Built only by the linter (repro_torch/kernels/build.py, lint targets),
// with the rotation counter; no dispatch reaches it. bf16 activations,
// int8 / fp8 weights: the lint sites' types.
#define REPRO_MUTANT_UNGUARDED_ROTATE 1
#include "quant_dot.cuh"

// x (m, n) bf16, wq (n, d) one storage byte per element, sw (d) f32, out
// (m, d) bf16; all contiguous. The arguments of quant_dot_launch, without
// the schedule.
extern "C" int mutant_unguarded_rotate_launch(const void* x, const void* wq, const void* sw,
                                              void* out, long long m, int n, int d, int r,
                                              int io, int cd, float scale, int mode,
                                              void* stream) {
  if (io != hadacore::kBF16) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0) return 0;
  if (n < 2 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (mode < quant::kInt8 || mode > quant::kE5M2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == quant::kInt8)
    return launch<__nv_bfloat16, true, false, false, false, false>(x, wq, sw, out, m, n, d, 1, 1,
                                                                   0, r, cd, scale, mode, Abft{}, s);
  return launch<__nv_bfloat16, false, false, false, false, false>(x, wq, sw, out, m, n, d, 1, 1,
                                                                  0, r, cd, scale, mode, Abft{}, s);
}

// K4's launch geometry (the mutant launches as K4 does).
extern "C" int mutant_unguarded_rotate_grid(long long m, int n, int d, int mode, long long* out) {
  return launch_grid(m, n, d, 1, kRotateOnce, 0, mode, false, out);
}

extern "C" int mutant_unguarded_rotate_attributes(long long m, int n, int mode, long long* out) {
  const bool is_int = mode == quant::kInt8;
  const int bm = pick_bm(m, n, false, false);
  return func_attributes(is_int ? kernel_for_bm<__nv_bfloat16, true, false, false, false, false>(bm)
                                : kernel_for_bm<__nv_bfloat16, false, false, false, false, false>(bm),
                         bm, out);
}

QUANT_DOT_COUNT_EXPORTS(mutant_unguarded_rotate)
