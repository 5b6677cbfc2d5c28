"""Backend registry and the shared quantize epilogue math (twin of
``repro.kernels.registry``).

A backend is a transform implementation registered with
``@register_backend``; ``select_backend`` resolves one per plan:

  cuda  -- the hand-written Hopper kernels (``repro_torch/csrc``): K1
           ``hadacore`` (transform), K2 ``fused_dequant``, K3 ``fused``, K4 /
           K5 ``quant_dot`` (rotate-once / streamed) and K6 / K6s
           ``quant_dot_experts``, with their ABFT twins K7a-ro / K7a-s and
           K7b / K7b-s (``check=``), up to ``MAX_KERNEL_SIZE`` points.
           Auto-selected for CUDA tensors. Its wrappers run the plain
           PyTorch versions on CPU tensors and launch the kernels on CUDA
           tensors.
  torch -- the plain PyTorch versions (the twin of the reference's ``xla``
           backend): the transform, and ``quant_dot`` / ``quant_dot_experts``
           (and, with ``check=``, their ABFT residuals) as the unfused math;
           auto-selected for CPU tensors only; a CUDA tensor runs it only
           when it is asked for by name (the serving ladder's last rung).
  ref   -- the paper's Listing-1 scalar FWHT oracle (never auto-picked).

An explicit request wins; otherwise the ``REPRO_HADAMARD_BACKEND``
environment variable; otherwise the highest-priority backend that is
auto-selectable on the tensor's device type. Nothing falls back: a named
backend that cannot take the size, or a CUDA transform larger than the
kernels take with no backend named, raises.
"""
from __future__ import annotations

import collections
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import fwht

__all__ = [
    "Backend",
    "register_backend",
    "get_backend",
    "available_backends",
    "select_backend",
    "BACKEND_ENV_VAR",
    "MAX_KERNEL_SIZE",
    "QSPECS",
    "TRACE_COUNTS",
    "warn_once",
    "WARN_ONCE_SEEN",
    "cast_to",
    "f32_reciprocal",
]

BACKEND_ENV_VAR = "REPRO_HADAMARD_BACKEND"

# Largest transform one kernel launch takes (the paper's cap, 2^15): a row
# of 32768 f32 values is 128 KB, within a block's shared memory.
MAX_KERNEL_SIZE = 32768

# mode -> (grid max, storage dtype, integer grid?). Shared by the kernels'
# plain versions, the epilogue fallback and the weight quantizer.
QSPECS = {
    "int8": (127.0, torch.int8, True),
    "fp8_e4m3": (448.0, torch.float8_e4m3fn, False),
    "fp8_e5m2": (57344.0, torch.float8_e5m2, False),
}

# Event counters (serving transitions, ABFT sites and trips, warn-once
# occurrences), keyed (subsystem, event), e.g. ("abft", "quant_dot_site"),
# ("abft", "kv_trip"), ("serving", "step_retry"). Kernel launches are
# counted on the wrappers instead.
TRACE_COUNTS: collections.Counter = collections.Counter()

WARN_ONCE_SEEN: set = set()


def warn_once(key: Tuple[str, str], msg: str, *,
              category=RuntimeWarning, stacklevel: int = 3,
              count: bool = True) -> None:
    """Warn once per process per ``key``; tick ``TRACE_COUNTS[key]`` on
    every call so the event stays observable after the warning goes quiet."""
    if count:
        TRACE_COUNTS[key] += 1
    if key not in WARN_ONCE_SEEN:
        WARN_ONCE_SEEN.add(key)
        warnings.warn(msg, category, stacklevel=stacklevel)


# e4m3fn has no infinity: jax/ml_dtypes turn |x| > 464 (beyond the rounding
# midpoint of 448 and the NaN code) into NaN, while torch's cast saturates
# to 448. The port keeps the reference's NaN.
_E4M3_OVERFLOW = 464.0


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)`` with the reference's fp8 overflow rule: for
    float8_e4m3fn, |x| > 464 (and +-inf) becomes NaN instead of +-448.
    e5m2 and every other dtype cast as torch casts (they already agree)."""
    if dtype == torch.float8_e4m3fn:
        x = torch.where(x.abs() > _E4M3_OVERFLOW,
                        torch.full_like(x, float("nan")), x)
    return x.to(dtype)


def _quantize_rows(y: torch.Tensor, mode: str, axis=-1):
    """The symmetric-absmax epilogue math: (q on the mode's grid, f32
    scales); ``q`` is returned pre-cast (f32 integers for int8, raw
    quotients for fp8) and ``axis=None`` gives one per-tensor scale.

    The reference writes ``max(absmax, 1e-8) / qmax``, but XLA compiles a
    division by a constant into a multiplication by its f32 reciprocal, so
    every compiled reference path (the Pallas kernels, jitted steps, scan
    bodies) computes ``max(absmax, 1e-8) * f32(1 / qmax)``; the port
    mirrors that. ``y / s`` stays a true division."""
    qmax, _, is_int = QSPECS[mode]
    a = y.abs()
    if axis is None:
        a = a.amax().reshape((1,) * y.ndim)
    else:
        a = a.amax(dim=axis, keepdim=True)
    s = torch.clamp_min(a, 1e-8) * f32_reciprocal(qmax)
    q = y / s
    if is_int:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q, s


def f32_reciprocal(c: float) -> float:
    """1/c rounded to f32, as XLA folds the reciprocal of a constant."""
    return float(np.float32(1.0) / np.float32(c))


def _dequantize(q: torch.Tensor, s: torch.Tensor, mode: str) -> torch.Tensor:
    """Back through the storage grid (fp8 round-trips through the real
    dtype); f32 in, f32 out."""
    _, qdt, is_int = QSPECS[mode]
    if not is_int:
        q = cast_to(q, qdt).to(torch.float32)
    return q * s


def _rows(x: torch.Tensor, n: int):
    m = 1
    for d in x.shape[:-1]:
        m *= d
    return x.reshape(m, n), m


# ---------------------------------------------------------------- registry
_REGISTRY: Dict[str, "Backend"] = {}


def register_backend(cls):
    """Class decorator: instantiate and register a backend under its name."""
    inst = cls()
    _REGISTRY[inst.name] = inst
    return cls


def get_backend(name: str) -> "Backend":
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown Hadamard backend {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def available_backends() -> Tuple[str, ...]:
    """Registered backend names, highest selection priority first."""
    return tuple(sorted(_REGISTRY, key=lambda k: -_REGISTRY[k].priority))


def select_backend(p: int, requested: Optional[str] = None,
                   device_type: str = "cuda") -> str:
    """Resolve the backend for a p-point transform on ``device_type``
    ('cuda' or 'cpu'): explicit request > ``REPRO_HADAMARD_BACKEND`` >
    auto. Raises when the resolved choice cannot run the size."""
    if requested in (None, "auto"):
        requested = os.environ.get(BACKEND_ENV_VAR) or None
    if requested is not None:
        be = get_backend(requested)
        if not be.supports(p):
            raise ValueError(
                f"Hadamard backend {requested!r} does not take a {p}-point "
                f"transform (its kernels stop at {MAX_KERNEL_SIZE})")
        return be.name
    for name in available_backends():
        be = _REGISTRY[name]
        if be.auto_on(device_type) and be.supports(p):
            return name
    raise ValueError(
        f"no backend is auto-selected for a {p}-point transform on "
        f"{device_type!r} tensors (the kernels stop at {MAX_KERNEL_SIZE}); "
        "name backend='torch' to run the plain version")


class Backend:
    """A named transform implementation with optional single-kernel paths
    (None = the dispatcher runs transform + the plain epilogue, or the
    unfused quantized GEMM): ``fused`` (rotate + quantize to
    ``(q, scales)``), ``fused_dequant`` (rotate + fake quant),
    ``quant_dot`` (rotate + quantize + GEMM) and ``quant_dot_experts``
    (the same over stacked expert weights); the two quant_dot forms take
    ``check=`` (the weight's ABFT column checksum) and then return ``(y,
    resid)``. ``quant_dot_fused``: is ``quant_dot`` the single kernel (the
    sharded quant_dot counts the other kind as ``unfused_local``)?"""

    name: str = "?"
    priority: int = 0
    quant_dot_fused: bool = False

    def auto_on(self, device_type: str) -> bool:
        return True

    def supports(self, p: int) -> bool:
        raise NotImplementedError

    def transform(self, x, plan, in_place: bool = False):
        raise NotImplementedError

    fused = None
    fused_dequant = None
    quant_dot = None
    quant_dot_experts = None


@register_backend
class CudaBackend(Backend):
    name = "cuda"
    priority = 20
    quant_dot_fused = True

    def auto_on(self, device_type: str) -> bool:
        return device_type == "cuda"

    def supports(self, p: int) -> bool:
        return p <= MAX_KERNEL_SIZE

    def transform(self, x, plan, in_place: bool = False):
        from repro_torch.kernels.hadacore import transform

        return transform(x, plan, in_place)

    def fused(self, x, plan):
        from repro_torch.kernels.fused_quant import fused

        return fused(x, plan)

    def fused_dequant(self, x, plan):
        from repro_torch.kernels.fused_quant import fused_dequant

        return fused_dequant(x, plan)

    def quant_dot(self, x, wq, sw, plan, schedule=None, check=None):
        from repro_torch.kernels.quant_dot import quant_dot

        return quant_dot(x, wq, sw, plan, schedule, check)

    def quant_dot_experts(self, x, wq, sw, plan, schedule=None, check=None):
        from repro_torch.kernels.quant_dot import quant_dot_experts

        return quant_dot_experts(x, wq, sw, plan, schedule, check)


@register_backend
class TorchBackend(Backend):
    name = "torch"
    priority = 10

    def auto_on(self, device_type: str) -> bool:
        return device_type == "cpu"

    def supports(self, p: int) -> bool:
        return True

    def transform(self, x, plan, in_place: bool = False):
        from repro_torch.kernels.hadacore import transform_plain

        y = transform_plain(x, plan)
        return x.copy_(y) if in_place else y

    def quant_dot(self, x, wq, sw, plan, schedule=None, check=None):
        # the unfused math, as the reference's xla backend hosts it
        from repro_torch.kernels import quant_dot as qd

        qd._resolve_schedule(schedule)
        if check is not None:
            return qd.quant_dot_abft_plain(x, wq, sw, check, plan)
        return qd.quant_dot_plain(x, wq, sw, plan)

    def quant_dot_experts(self, x, wq, sw, plan, schedule=None, check=None):
        from repro_torch.kernels import quant_dot as qd

        qd._resolve_schedule(schedule, experts=True)
        if check is not None:
            return qd.quant_dot_experts_abft_plain(x, wq, sw, check, plan)
        return qd.quant_dot_experts_plain(x, wq, sw, plan)


@register_backend
class RefBackend(Backend):
    name = "ref"
    priority = 0

    def auto_on(self, device_type: str) -> bool:
        return False  # oracle: explicit selection only

    def supports(self, p: int) -> bool:
        return True

    def transform(self, x, plan, in_place: bool = False):
        y = fwht(x.to(torch.float32), plan.scale).to(x.dtype)
        return x.copy_(y) if in_place else y
