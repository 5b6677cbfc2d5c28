"""Quantized-GEMM host math (twin of the host half of
``repro.kernels.quant_dot``): ``epilogue_dot`` and its helpers.

The reference contracts the grouped down-projection (llama3-8b's d_ff =
14336 is no power of 2) outside any kernel with this math, so it stays a
PyTorch matmul here too:

  * int8: exact int32 accumulation (``torch._int_mm``), or above
    ``_INT32_SAFE_K`` an f32 accumulation of the exact grid products;
  * fp8: both operands cast exactly to f32 (every fp8 value and every
    product of two is exact there), f32 accumulation with TF32 off;

then ``acc * s * sw`` in that order. The fused rotate -> quantize -> GEMM
kernels of the reference (K4 and its schedules) are later slices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.registry import QSPECS, cast_to

__all__ = ["epilogue_dot"]

# Largest contraction whose worst-case int8 x int8 row sum stays in int32:
# 127 * 127 * 2^17 ~= 2.11e9 < 2^31 - 1.
_INT32_SAFE_K = 1 << 17


def _operand_from_q(q: torch.Tensor, mode: str) -> torch.Tensor:
    """``_quantize_rows`` output on the grid the contraction runs on: int8
    for the int path, the fp8 storage grid otherwise (the reference embeds
    it in bf16 for the TPU's matrix unit; the values are the same)."""
    if QSPECS[mode][2]:
        return q.to(torch.int8)
    return cast_to(q, QSPECS[mode][1])


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 (m, k) @ (k, d). ``torch._int_mm`` on the
    card wants more than 16 rows and k, d multiples of 8: zero padding
    changes no sum."""
    m, k = a.shape
    d = b.shape[1]
    mp = max(32, -(-m // 8) * 8)
    kp, dp = -(-k // 8) * 8, -(-d // 8) * 8
    if (mp, kp, dp) != (m, k, d):
        a = F.pad(a, (0, kp - k, 0, mp - m))
        b = F.pad(b, (0, dp - d, 0, kp - k))
    return torch._int_mm(a, b)[:m, :d]


def _low_precision_dot(q: torch.Tensor, wq: torch.Tensor, mode: str) -> torch.Tensor:
    """The quantized contraction on the mode's exact arithmetic; ``q`` is
    (m, n) f32 grid values, ``wq`` (n, d) storage dtype. Returns f32."""
    is_int = QSPECS[mode][2]
    if is_int and q.shape[-1] > _INT32_SAFE_K:
        return torch.matmul(q.to(torch.float32), wq.to(torch.float32))
    a = _operand_from_q(q, mode)
    if is_int:
        return _int8_mm(a, wq.to(torch.int8)).to(torch.float32)
    return torch.matmul(a.to(torch.float32), wq.to(torch.float32))


def epilogue_dot(q, s, wq, sw, mode: str, out_dtype) -> torch.Tensor:
    """``(q * s) @ (wq * sw)`` with the scales factored out of the matmul:
    ``(q @ wq) * s * sw``. q: (..., n) grid values, s per-token (or per-
    tensor) scales, wq: (n, d) storage dtype, sw: (1, d)."""
    lead = q.shape[:-1]
    n, d = q.shape[-1], wq.shape[-1]
    acc = _low_precision_dot(q.reshape(-1, n), wq, mode).reshape(*lead, d)
    return (acc * s * sw.reshape((1,) * len(lead) + (d,))).to(out_dtype)
