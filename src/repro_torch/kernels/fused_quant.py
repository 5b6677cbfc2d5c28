"""K2, rotate -> per-row absmax fake-quant in one kernel: the CUDA
kernel's wrapper and its plain PyTorch version (twin of the
``_pallas_fused_dequant`` launcher in ``repro.kernels.registry``).

The kernel (``repro_torch/csrc/fused_quant.cu``) replaces the TPU kernel
``repro/kernels/registry.py::_fused_dequant_kernel``. It runs K1's passes
on each row in shared memory, then quantizes the compute-dtype-rounded row
on the int8 / fp8 grid and dequantizes it, so the rotated row never round
trips through HBM. On an H100 it is bound by bytes, as K1. It is the
attention Q/K site of the serving path (``core.api.RotationSpec`` with a
dequant epilogue, n = head_dim).

``fused_dequant`` is what the ``cuda`` backend calls: a CPU tensor goes to
``fused_dequant_plain``, a CUDA tensor to the kernel.
``fused_dequant_cuda.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hadamard import torch_dtype
from repro_torch.kernels.hadacore import (DTYPE_CODES, check_rows,
                                          scale_in_compute_dtype,
                                          transform_plain)
from repro_torch.kernels.registry import _dequantize, _quantize_rows

__all__ = ["fused_dequant", "fused_dequant_cuda", "fused_dequant_plain",
           "MODE_CODES"]

# quantization mode codes of csrc/fused_quant.cu (Mode)
MODE_CODES = {"int8": 0, "fp8_e4m3": 1, "fp8_e5m2": 2}

_PTR = ctypes.c_void_p


def _lib():
    from repro_torch.kernels import build

    lib = build.load("fused_quant")
    fn = lib.fused_dequant_launch
    if fn.argtypes is None:
        fn.argtypes = [_PTR, _PTR, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       _PTR]
        fn.restype = ctypes.c_int
    return lib


def fused_dequant_cuda(x2: torch.Tensor, out: torch.Tensor, plan) -> torch.Tensor:
    """Launch K2 on contiguous (m, p) CUDA rows into ``out`` on the
    current stream; the plan carries the per-token dequant epilogue."""
    check_rows(x2, out, plan)
    epi = plan.epilogue
    if epi is None or not epi.dequant or not epi.per_token or plan.grouped:
        raise ValueError("fused_dequant kernel takes per-token dequant plans "
                         f"of a power-of-2 size, got {epi!r} n={plan.n}")
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    rc = _lib().fused_dequant_launch(
        x2.data_ptr(), out.data_ptr(), x2.shape[0], plan.p, plan.r,
        DTYPE_CODES[x2.dtype], DTYPE_CODES[torch_dtype(plan.compute_dtype)],
        scale_in_compute_dtype(plan), MODE_CODES[epi.mode], stream)
    if rc != 0:
        raise RuntimeError(f"fused_dequant kernel launch failed: CUDA error {rc}")
    fused_dequant_cuda.launches += 1
    return out


fused_dequant_cuda.launches = 0


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
