// K7a-ro, K7a-s and K7a-rv: the checksum-verified (ABFT) twins of K4, K5
// and K8. Replace repro/kernels/quant_dot.py::_quant_dot_kernel_rotate_once_abft,
// ::_quant_dot_kernel_streamed_abft (with _abft_check_col) and
// ::_quant_dot_kernel_revisit_abft: the same outputs, bitwise, plus each
// row's f32 residual r = sum_d y_f32 - s * (op . cw), in the same launch
// (quant_dot.cuh).
#include "quant_dot.cuh"

// As quant_dot_launch, plus cw (n) f32 the weight's column checksum, resid
// (m) f32, part (at least the launch's blocks x rows-per-block floats) the
// partial-sum workspace, count (at least ceil(m / rows-per-block) zeroed
// unsigned ints, left zeroed) the arrival counters.
extern "C" int quant_dot_abft_launch(const void* x, const void* wq, const void* sw,
                                     const void* cw, void* out, void* resid, void* part,
                                     void* count, long long m, int n, int d, int schedule,
                                     int block_n, int r, int io, int cd, float scale, int mode,
                                     void* stream) {
  const Abft ab{static_cast<const float*>(cw), static_cast<float*>(resid),
                static_cast<float*>(part), static_cast<unsigned int*>(count)};
  return launch_checked<false, true>(x, wq, sw, out, m, n, d, 1, 1, schedule, block_n, r, io,
                                     cd, scale, mode, ab, stream);
}

// The launch geometry and the linter's queries (quant_dot.cuh): *_grid,
// *_attributes and, built with REPRO_COUNT_ROTATIONS, *_rotations and
// *_rotations_reset.
QUANT_DOT_LINT_EXPORTS(quant_dot_abft, false, true)
