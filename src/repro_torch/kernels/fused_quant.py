"""K2 and K3, rotate -> per-row absmax quantize in one kernel: the CUDA
kernels' wrappers and their plain PyTorch versions (twin of the
``_pallas_fused_dequant`` and ``_pallas_fused`` launchers in
``repro.kernels.registry``, and of ``repro.kernels.fused_quant``).

Both kernels (``repro_torch/csrc/fused_quant.cu``) run K1's rotation on
each row in shared memory -- for a 16-bit compute dtype the tensor-core
routine with K1's own layout (``hadacore.tc_launch``), bitwise K1's --
then quantize the compute-dtype-rounded row on the int8 / fp8 grid, so the
rotated row never round trips through HBM. On an H100 they are bound by
bytes, as K1.

  * K2 ``fused_dequant`` replaces ``repro/kernels/registry.py::
    _fused_dequant_kernel``: it dequantizes again (fake quant). It is the
    attention Q/K site of the serving path (``core.api.RotationSpec`` with a
    dequant epilogue, n = head_dim).
  * K3 ``fused`` replaces ``repro/kernels/registry.py::_fused_kernel``: it
    writes ``q`` in the mode's storage dtype and the f32 per-row scales,
    the ``hadamard(x, epilogue=QuantEpilogue(mode))`` entry point.

``fused_dequant`` and ``fused`` are what the ``cuda`` backend calls: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel.
``fused_dequant_cuda.launches`` and ``fused_cuda.launches`` count the
kernels' launches. ``ref_fused`` is the scalar-FWHT oracle and
``fused_hadamard_quantize`` the reference's deprecated shim.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.hadamard import resolve_scale, torch_dtype
from repro_torch.kernels.hadacore import (DTYPE_CODES, MAX_KERNEL_SIZE,
                                          check_rows, scale_in_compute_dtype,
                                          tc_geometry, tc_launch_arg, transform_plain)
from repro_torch.kernels.ref import fwht, is_pow2
from repro_torch.kernels.registry import (QSPECS, _dequantize,
                                          _quantize_rows, cast_to, warn_once)

__all__ = ["fused_dequant", "fused_dequant_cuda", "fused_dequant_plain",
           "fused_dequant_phases", "PHASES",
           "fused", "fused_cuda", "fused_plain", "ref_fused",
           "fused_hadamard_quantize", "MODE_CODES"]

# quantization mode codes of csrc/fused_quant.cu (Mode)
MODE_CODES = {"int8": 0, "fp8_e4m3": 1, "fp8_e5m2": 2}

_PTR = ctypes.c_void_p


def _lib(stamped: bool = False):
    """The main build of csrc/fused_quant.cu, or (``stamped``) its
    phase-stamping build."""
    from repro_torch.kernels import build

    lib = (build.load_target(build.Target("fused_quant.cu", (build.STAMP_DEFINE,)))
           if stamped else build.load("fused_quant"))
    fn = lib.fused_dequant_launch
    if fn.argtypes is None:
        fn.argtypes = [_PTR, _PTR, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       _PTR, _PTR]
        fn.restype = ctypes.c_int
        k3 = lib.fused_launch
        k3.argtypes = [_PTR, _PTR, _PTR, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, _PTR, _PTR]
        k3.restype = ctypes.c_int
    return lib


def _launch_dequant(x2: torch.Tensor, out: torch.Tensor, plan, stamped: bool = False):
    """K2's launch from the main build or (``stamped``) the phase-stamping
    one; returns that library."""
    check_rows(x2, out, plan)
    epi = plan.epilogue
    if epi is None or not epi.dequant or not epi.per_token or plan.grouped:
        raise ValueError("fused_dequant kernel takes per-token dequant plans "
                         f"of a power-of-2 size, got {epi!r} n={plan.n}")
    if stamped and plan.compute_dtype == "float32":
        raise ValueError("fused_dequant_phases stamps the tensor-core kernel only")
    lib = _lib(stamped)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    rc = lib.fused_dequant_launch(
        x2.data_ptr(), out.data_ptr(), x2.shape[0], plan.p, plan.r,
        DTYPE_CODES[x2.dtype], DTYPE_CODES[torch_dtype(plan.compute_dtype)],
        scale_in_compute_dtype(plan), MODE_CODES[epi.mode],
        tc_launch_arg(x2.shape[0], plan, True), stream)
    if rc != 0:
        raise RuntimeError(f"fused_dequant kernel launch failed: CUDA error {rc}")
    return lib


def fused_dequant_cuda(x2: torch.Tensor, out: torch.Tensor, plan) -> torch.Tensor:
    """Launch K2 on contiguous (m, p) CUDA rows into ``out`` on the
    current stream; the plan carries the per-token dequant epilogue."""
    _launch_dequant(x2, out, plan)
    fused_dequant_cuda.launches += 1
    return out


fused_dequant_cuda.launches = 0


# the phase-stamping build's clock readings per block (csrc/hadacore_tc.cuh
# stamp): the block's start, then the end of each phase
PHASES = ("prologue", "load", "passes", "pass", "absmax", "barrier", "epilogue")


def fused_dequant_phases(x2: torch.Tensor, plan) -> torch.Tensor:
    """K2 once on contiguous (m, p) CUDA rows from its phase-stamping build
    (a measurement aid; no path calls it): per block of the launch (at
    most 4096), the SM clock in cycles at its start and at the end of each
    of the ``PHASES`` -- the prologue (the plan staged, the first pass's
    lane constants derived under the rows' loads, the thread's rows
    stored), the load's barrier, the passes before the last and its lane
    constants, its mmas, butterflies and stores, its absmax, its barrier,
    the quantize epilogue -- as a (blocks, 8) int64 tensor on the host. Tensor-core (bf16 / fp16 compute) plans only."""
    lib = _launch_dequant(x2, torch.empty_like(x2), plan, stamped=True)
    torch.cuda.synchronize(x2.device)
    geom = tc_geometry(plan.p, x2.shape[0], True)
    blocks = min(-(-x2.shape[0] // geom.rows_per_block), 4096)
    host = torch.zeros(blocks, len(PHASES) + 1, dtype=torch.int64)
    fn = lib.fused_dequant_stamps
    fn.argtypes, fn.restype = [_PTR, ctypes.c_int], ctypes.c_int
    rc = fn(host.data_ptr(), blocks)
    if rc != 0:
        raise RuntimeError(f"fused_dequant_stamps failed: CUDA error {rc}")
    return host


def fused_dequant_plain(x: torch.Tensor, plan) -> torch.Tensor:
    """K2's plain PyTorch version: K1's plain passes, then the shared
    epilogue math on the compute-dtype-rounded row in f32."""
    mode = plan.epilogue.mode
    y = transform_plain(x.to(torch_dtype(plan.compute_dtype)), plan)
    q, s = _quantize_rows(y.to(torch.float32), mode)
    return _dequantize(q, s, mode).to(x.dtype)


def fused_dequant(x: torch.Tensor, plan) -> torch.Tensor:
    """Rotate + fake-quantize the last axis (== plan.p): the plain version
    for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return fused_dequant_plain(x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dequant runs on CPU or CUDA tensors, got {x.device}")
    x2 = x.contiguous().view(-1, plan.p)
    out = torch.empty_like(x2)
    return fused_dequant_cuda(x2, out, plan).view(x.shape)


# ------------------------------------------------------------------- K3
def fused_cuda(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor, plan):
    """Launch K3 on contiguous (m, p) CUDA rows into ``q`` ((m, p), the
    mode's storage dtype) and ``s`` ((m, 1) f32) on the current stream; the
    plan carries the per-token (q, scales) epilogue."""
    epi = plan.epilogue
    if epi is None or epi.dequant or not epi.per_token or plan.grouped:
        raise ValueError("fused kernel takes per-token (q, scales) plans of a "
                         f"power-of-2 size, got {epi!r} n={plan.n}")
    check_rows(x2, x2, plan)
    m = x2.shape[0]
    if not (q.is_cuda and s.is_cuda and q.is_contiguous() and s.is_contiguous()):
        raise ValueError("fused kernel outputs must be contiguous CUDA tensors")
    if q.shape != x2.shape or q.dtype != QSPECS[epi.mode][1]:
        raise ValueError(f"q must be {tuple(x2.shape)} {QSPECS[epi.mode][1]}, got "
                         f"{tuple(q.shape)} {q.dtype}")
    if s.shape != (m, 1) or s.dtype != torch.float32:
        raise ValueError(f"s must be ({m}, 1) float32, got {tuple(s.shape)} {s.dtype}")
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    rc = _lib().fused_launch(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), m, plan.p, plan.r,
        DTYPE_CODES[x2.dtype], DTYPE_CODES[torch_dtype(plan.compute_dtype)],
        scale_in_compute_dtype(plan), MODE_CODES[epi.mode], tc_launch_arg(m, plan, True), stream)
    if rc != 0:
        raise RuntimeError(f"fused kernel launch failed: CUDA error {rc}")
    fused_cuda.launches += 1
    return q, s


fused_cuda.launches = 0


def fused_plain(x: torch.Tensor, plan):
    """K3's plain PyTorch version: K1's plain passes, the shared epilogue
    math on the compute-dtype-rounded row in f32, then the cast of q to the
    storage dtype. Returns ``(q, s)`` with s of shape (..., 1)."""
    mode = plan.epilogue.mode
    y = transform_plain(x.to(torch_dtype(plan.compute_dtype)), plan)
    q, s = _quantize_rows(y.to(torch.float32), mode)
    return cast_to(q, QSPECS[mode][1]), s


def fused(x: torch.Tensor, plan):
    """Rotate + quantize the last axis (== plan.p) to ``(q, scales)``: the
    plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return fused_plain(x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"fused runs on CPU or CUDA tensors, got {x.device}")
    x2 = x.contiguous().view(-1, plan.p)
    q = torch.empty(x2.shape, dtype=QSPECS[plan.epilogue.mode][1], device=x.device)
    s = torch.empty((x2.shape[0], 1), dtype=torch.float32, device=x.device)
    fused_cuda(x2, q, s, plan)
    return q.view(x.shape), s.view(*x.shape[:-1], 1)


def ref_fused(x: torch.Tensor, scale: Optional[str] = "ortho", mode: str = "int8"):
    """Oracle: the scalar FWHT in f32, then per-row symmetric quantization
    on the mode's grid, q cast to the storage dtype."""
    y = fwht(x.to(torch.float32), resolve_scale(scale, x.shape[-1]))
    q, s = _quantize_rows(y, mode)
    return cast_to(q, QSPECS[mode][1]), s


# warn-once key: one DeprecationWarning per process, a TRACE_COUNTS tick on
# every call (the reference's idiom)
WARN_KEY = ("deprecated", "kernels.fused_quant.fused_hadamard_quantize")


def fused_hadamard_quantize(x: torch.Tensor, scale: Optional[str] = "ortho", *,
                            mode: str = "int8"):
    """Deprecated: use ``repro_torch.core.api.hadamard`` with a
    ``QuantEpilogue`` (which this calls, on the ``cuda`` backend). Returns
    ``(q, scales)``."""
    from repro_torch.core.api import QuantEpilogue, hadamard

    warn_once(WARN_KEY,
              "repro_torch.kernels.fused_quant.fused_hadamard_quantize is "
              "deprecated; use repro_torch.core.api.hadamard with a "
              "QuantEpilogue (or repro_torch.core.api.quant_dot for the "
              "fused GEMM consumer)",
              category=DeprecationWarning, stacklevel=3)
    n = x.shape[-1]
    if n > MAX_KERNEL_SIZE:
        raise ValueError(f"fused kernel supports n <= {MAX_KERNEL_SIZE}, got {n}")
    if not is_pow2(n):
        raise ValueError(f"Hadamard size must be a power of 2, got {n}")
    return hadamard(x, scale=scale, backend="cuda", epilogue=QuantEpilogue(mode))
