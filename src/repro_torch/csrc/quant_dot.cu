// K4, K5 and K8: the dense fused rotate -> quantize -> GEMM, rotate-once,
// streamed and revisit. Replace
// repro/kernels/quant_dot.py::_quant_dot_kernel_rotate_once,
// ::_quant_dot_kernel_streamed (with _ring_dmas) and
// ::_quant_dot_kernel_revisit; the design, shared with K6 and K6s and the
// ABFT twins, is described in quant_dot.cuh.
#include "quant_dot.cuh"

// x (m, n) io dtype, wq (n, d) one storage byte per element (int8 / e4m3 /
// e5m2 by mode), sw (d) f32, out (m, d) io dtype; all contiguous.
// schedule: 0 rotate-once (K4), 1 streamed (K5), 2 revisit (K8: one block
// per row block and weight tile of block_n columns, a multiple of 32;
// block_n is read only by revisit).
extern "C" int quant_dot_launch(const void* x, const void* wq, const void* sw, void* out,
                                long long m, int n, int d, int schedule, int block_n, int r,
                                int io, int cd, float scale, int mode, void* stream) {
  return launch_checked<false, false>(x, wq, sw, out, m, n, d, 1, 1, schedule, block_n, r, io,
                                      cd, scale, mode, Abft{}, stream);
}

// The launch geometry and the linter's queries (quant_dot.cuh): *_grid,
// *_attributes and, built with REPRO_COUNT_ROTATIONS, *_rotations and
// *_rotations_reset.
QUANT_DOT_LINT_EXPORTS(quant_dot, false, false)
