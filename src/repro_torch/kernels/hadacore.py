"""K1, the HadaCore Walsh-Hadamard transform: the CUDA kernel's wrapper,
its plain PyTorch version, and the direct ``hadacore`` entry point (twin
of ``repro.kernels.hadacore`` and of the ``_pallas_transform`` launcher in
``repro.kernels.registry``).

The kernel (``repro_torch/csrc/hadacore.cu``) replaces the TPU kernel
``repro/kernels/registry.py::_hadacore_kernel``. On an H100 it is bound by
bytes (one read and one write of each element); it keeps each row in
shared memory across the plan's passes so HBM sees nothing else. See the
source for the design and what is left for later.

``transform`` is what the ``cuda`` backend calls: a CPU tensor goes to the
plain version (``transform_plain``, the reference's ``_xla_transform``
math), a CUDA tensor to the kernel. ``hadacore_cuda.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.hadamard import _apply_passes, torch_dtype
from repro_torch.kernels.ref import is_pow2
from repro_torch.kernels.registry import MAX_KERNEL_SIZE, _rows

__all__ = ["hadacore", "hadacore_cuda", "transform", "transform_plain",
           "MAX_KERNEL_SIZE", "DTYPE_CODES"]

# io / compute dtype codes of csrc/hadacore.cuh (hadacore::Dtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_PTR = ctypes.c_void_p


def _lib():
    from repro_torch.kernels import build

    lib = build.load("hadacore")
    fn = lib.hadacore_launch
    if fn.argtypes is None:
        fn.argtypes = [_PTR, _PTR, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, _PTR]
        fn.restype = ctypes.c_int
    return lib


def scale_in_compute_dtype(plan) -> float:
    """The scale folded into pass 0 as the plan's base matrices carry it:
    the f32 scale rounded to the compute dtype (for n = 128 or 2048 in
    bf16 that is not exactly 1/sqrt(n))."""
    return _rounded_scale(plan.scale, plan.compute_dtype)


@functools.lru_cache(maxsize=None)
def _rounded_scale(scale: Optional[float], compute_dtype: str) -> float:
    if scale is None:
        return 1.0
    cd = torch_dtype(compute_dtype)
    return float(torch.tensor(np.float32(scale)).to(cd).to(torch.float32))


def check_rows(x2: torch.Tensor, out: torch.Tensor, plan) -> None:
    """What the transform kernels take: contiguous (m, p) CUDA rows of the
    plan's io dtype (f32 / bf16 / fp16), p a power of 2 <= 32768, and an
    output of the same shape, dtype and device."""
    if not (x2.is_cuda and out.is_cuda and x2.device == out.device):
        raise ValueError("kernel inputs must be CUDA tensors on one device")
    if x2.dtype not in DTYPE_CODES or out.dtype != x2.dtype:
        raise ValueError(f"kernel takes f32/bf16/fp16 rows, got {x2.dtype} "
                         f"-> {out.dtype}")
    if x2.ndim != 2 or x2.shape != out.shape or x2.shape[1] != plan.p:
        raise ValueError(f"kernel takes (m, {plan.p}) rows, got "
                         f"{tuple(x2.shape)} -> {tuple(out.shape)}")
    if not (x2.is_contiguous() and out.is_contiguous()):
        raise ValueError("kernel takes contiguous rows")
    if not is_pow2(plan.p) or plan.p > MAX_KERNEL_SIZE:
        raise ValueError(f"kernel takes a power of 2 <= {MAX_KERNEL_SIZE}, "
                         f"got {plan.p}")
    if torch_dtype(plan.dtype) != x2.dtype:
        raise ValueError(f"plan was built for {plan.dtype}, rows are {x2.dtype}")


def hadacore_cuda(x2: torch.Tensor, out: torch.Tensor, plan) -> torch.Tensor:
    """Launch K1 on contiguous (m, p) CUDA rows into ``out`` (which may be
    ``x2`` itself: the in-place form) on the current stream."""
    check_rows(x2, out, plan)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    rc = _lib().hadacore_launch(
        x2.data_ptr(), out.data_ptr(), x2.shape[0], plan.p, plan.r,
        DTYPE_CODES[x2.dtype], DTYPE_CODES[torch_dtype(plan.compute_dtype)],
        scale_in_compute_dtype(plan), stream)
    if rc != 0:
        raise RuntimeError(f"hadacore kernel launch failed: CUDA error {rc}")
    hadacore_cuda.launches += 1
    return out


hadacore_cuda.launches = 0


def transform_plain(x: torch.Tensor, plan) -> torch.Tensor:
    """K1's plain PyTorch version: cast to the compute dtype, run the
    plan's passes (``core.hadamard._apply_passes``), cast back."""
    cd = torch_dtype(plan.compute_dtype)
    x2, _ = _rows(x.to(cd), plan.p)
    return _apply_passes(x2, plan.p, _plan_mats(plan, x.device)).reshape(
        x.shape).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _plan_mats(plan, device: torch.device):
    """The plan's f32 base matrices on ``device``, copied there once."""
    return [torch.from_numpy(m).to(device) for m in plan.mats]


def transform(x: torch.Tensor, plan, in_place: bool = False) -> torch.Tensor:
    """Rotate the last axis (== plan.p): the plain version for a CPU
    tensor, the kernel for a CUDA tensor. ``in_place`` writes the result
    into ``x`` (contiguous ``x`` only on the card)."""
    if x.device.type == "cpu":
        y = transform_plain(x, plan)
        return x.copy_(y) if in_place else y
    if x.device.type != "cuda":
        raise ValueError(f"hadacore runs on CPU or CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        if in_place:
            raise ValueError("in-place hadacore needs a contiguous tensor")
        x = x.contiguous()
    x2 = x.view(-1, plan.p)
    out = x2 if in_place else torch.empty_like(x2)
    return hadacore_cuda(x2, out, plan).view(x.shape)


def hadacore(x: torch.Tensor, scale: Optional[str] = "ortho", *,
             in_place: bool = False) -> torch.Tensor:
    """HadaCore Walsh-Hadamard transform of the last axis with the kernel
    backend: the CUDA kernel on a CUDA tensor, its plain version on a CPU
    tensor. n must be a power of 2 <= 32768; ``scale`` is "ortho"
    (1/sqrt(n)), None (+-1) or a number; ``in_place`` writes the result
    into ``x`` (the paper's Appendix B). The out-of-place form is
    differentiable (the transform is self-adjoint: its backward is the
    transform); the in-place form refuses a tensor that requires grad
    rather than drop its graph."""
    from repro_torch.core.api import _Transform, plan_for

    n = x.shape[-1]
    if n > MAX_KERNEL_SIZE:
        raise ValueError(
            f"hadacore kernel supports n <= {MAX_KERNEL_SIZE} (paper cap); "
            f"got {n}. Use repro_torch.core.hadamard.hadamard_transform.")
    if not is_pow2(n):
        raise ValueError(f"Hadamard size must be a power of 2, got {n}")
    plan = plan_for(n, dtype=x.dtype, scale=scale, backend="cuda",
                    device_type=x.device.type)
    if not in_place:
        return _Transform.apply(x, plan)
    if x.requires_grad:
        raise ValueError("hadacore(in_place=True) got a tensor that requires grad: "
                         "an in-place transform would drop its graph; call it "
                         "with in_place=False to differentiate through it")
    return transform(x, plan, in_place=True)
