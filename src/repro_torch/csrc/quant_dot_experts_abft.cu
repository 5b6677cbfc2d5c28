// K7b and K7b-s: the checksum-verified (ABFT) twins of K6 and K6s.
// Replace repro/kernels/quant_dot.py::_quant_dot_experts_kernel_abft and
// ::_quant_dot_experts_kernel_streamed_abft: the same outputs, bitwise,
// plus a residual per (expert, row) against that expert's column checksum,
// in the same launch (quant_dot.cuh).
#include "quant_dot.cuh"

// As quant_dot_experts_launch, plus cw (E, n) f32 the experts' column
// checksums, resid (m / cap, E, cap) f32, part (at least the launch's
// blocks x rows-per-block floats) and count (at least E x ceil(m /
// rows-per-block) zeroed unsigned ints, left zeroed).
extern "C" int quant_dot_experts_abft_launch(const void* x, const void* wq, const void* sw,
                                             const void* cw, void* out, void* resid,
                                             void* part, void* count, long long m, int n,
                                             int d, int experts, int cap, int streamed, int r,
                                             int io, int cd, float scale, int mode,
                                             void* stream) {
  const Abft ab{static_cast<const float*>(cw), static_cast<float*>(resid),
                static_cast<float*>(part), static_cast<unsigned int*>(count)};
  return launch_checked<true, true>(x, wq, sw, out, m, n, d, experts, cap, streamed, 0, r, io,
                                    cd, scale, mode, ab, stream);
}

// The launch geometry and the linter's queries (quant_dot.cuh): *_grid,
// *_attributes and, built with REPRO_COUNT_ROTATIONS, *_rotations and
// *_rotations_reset.
QUANT_DOT_LINT_EXPORTS(quant_dot_experts_abft, true, true)
