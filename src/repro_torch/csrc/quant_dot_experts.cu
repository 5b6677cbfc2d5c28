// K6 and K6s: the fused rotate -> quantize -> GEMM over stacked expert
// weights, rotate-once and streamed. Replace
// repro/kernels/quant_dot.py::_quant_dot_experts_kernel and
// ::_quant_dot_experts_kernel_streamed; the design, shared with K4 and K5
// and the ABFT twins, is described in quant_dot.cuh.
#include "quant_dot.cuh"

// x (m / cap, E, cap, n) io dtype, wq (E, n, d) one storage byte per
// element (int8 / e4m3 / e5m2 by mode), sw (E, d) f32, out (m / cap, E,
// cap, d) io dtype, m the rows of one expert; all contiguous. streamed = 1
// takes the streamed schedule (K6s).
extern "C" int quant_dot_experts_launch(const void* x, const void* wq, const void* sw,
                                        void* out, long long m, int n, int d, int experts,
                                        int cap, int streamed, int r, int io, int cd,
                                        float scale, int mode, void* stream) {
  return launch_checked<true, false>(x, wq, sw, out, m, n, d, experts, cap, streamed, 0, r,
                                     io, cd, scale, mode, Abft{}, stream);
}

// The launch geometry and the linter's queries (quant_dot.cuh): *_grid,
// *_attributes and, built with REPRO_COUNT_ROTATIONS, *_rotations and
// *_rotations_reset.
QUANT_DOT_LINT_EXPORTS(quant_dot_experts, true, false)
