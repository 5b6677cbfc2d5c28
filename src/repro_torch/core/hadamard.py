"""Kronecker-factored Walsh-Hadamard transform in plain PyTorch (twin of
``repro.core.hadamard``).

n = 128^k * r with r = 2^m < 128, and

    H_n = H_128 (x) ... (x) H_128 (x) H_r        (Kronecker, r minor)

so the transform runs as ceil(log_128 n) passes: a minor pass against the
block-diagonal tiling I_{128/r} (x) H_r on contiguous 128-chunks, then one
128-wide pass per major factor with a transpose in and out. Every pass
accumulates in f32 and rounds to the compute dtype; the scale is folded
into pass 0. ``_apply_passes`` is the plain version of the HadaCore kernel
(``repro_torch/csrc/hadacore.cuh`` runs the same passes on the card).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import hadamard_matrix, is_pow2

__all__ = [
    "MXU_TILE",
    "COMPUTE_DTYPES",
    "dtype_name",
    "torch_dtype",
    "factorize",
    "base_matrices_np",
    "hadamard_transform",
    "grouped_hadamard",
    "largest_pow2_divisor",
    "resolve_scale",
    "resolve_compute_dtype",
    "hadamard_check",
]

# Width of one pass (the reference's TPU matrix-unit tile). The port keeps
# it: the plan's pass structure, and so its rounding points, depend on it.
MXU_TILE = 128

COMPUTE_DTYPES = ("float32", "bfloat16", "float16")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_name(dt) -> str:
    """Canonical name of a torch dtype or dtype name: 'float32', ..."""
    if isinstance(dt, str):
        if dt not in _DTYPES:
            raise ValueError(f"unknown dtype name {dt!r}")
        return dt
    return str(dt).replace("torch.", "")


def torch_dtype(name) -> torch.dtype:
    return _DTYPES[dtype_name(name)]


def resolve_compute_dtype(input_dtype, requested=None) -> str:
    """The dtype the passes run in: 16-bit inputs run natively (f32
    accumulation), everything else in f32; an explicit request (one of
    ``COMPUTE_DTYPES``) overrides the rule."""
    if requested is not None:
        name = dtype_name(requested)
        if name not in COMPUTE_DTYPES:
            raise ValueError(
                f"unsupported compute dtype {requested!r}; expected one of "
                f"{COMPUTE_DTYPES}")
        return name
    name = dtype_name(input_dtype)
    return name if name in ("bfloat16", "float16") else "float32"


def resolve_scale(scale, n: int) -> Optional[float]:
    """``"ortho"`` -> 1/sqrt(n), ``None`` -> the +-1 transform, a number ->
    itself; anything else (e.g. the typo ``"orth"``) raises."""
    if scale is None:
        return None
    if isinstance(scale, str):
        if scale == "ortho":
            return 1.0 / math.sqrt(n)
        raise ValueError(
            f"unknown Hadamard scale {scale!r}: expected 'ortho', None, "
            "or an explicit numeric scale")
    if isinstance(scale, (int, float)) and not isinstance(scale, bool):
        return float(scale)
    raise ValueError(f"unknown Hadamard scale {scale!r}")


def factorize(n: int) -> Tuple[int, int]:
    """n = 128^k * r with r = 2^m < 128. Returns (k, r)."""
    if not is_pow2(n):
        raise ValueError(f"Hadamard size must be a power of 2, got {n}")
    k = 0
    while n % MXU_TILE == 0 and n > MXU_TILE:
        n //= MXU_TILE
        k += 1
    if n == MXU_TILE:
        return k + 1, 1
    return k, n


def base_matrices_np(n: int, scale: Optional[float]) -> List[np.ndarray]:
    """Per-pass base matrices (numpy f32), minor pass first: 128x128 when
    n >= 128 (the r-pass is I_{128/r} (x) H_r), one n x n matrix for
    n < 128. ``scale`` is folded into the first matrix."""
    k, r = factorize(n)
    mats: List[np.ndarray] = []
    if n < MXU_TILE:
        mats.append(hadamard_matrix(n))
    else:
        if r > 1:
            mats.append(np.kron(np.eye(MXU_TILE // r, dtype=np.float32),
                                hadamard_matrix(r)))
        else:
            mats.append(hadamard_matrix(MXU_TILE))
            k -= 1
        mats.extend(hadamard_matrix(MXU_TILE) for _ in range(k))
    if scale is not None:
        mats[0] = mats[0] * np.float32(scale)
    return mats


def _apply_passes(x: torch.Tensor, n: int, mats: List[torch.Tensor]) -> torch.Tensor:
    """The plan's passes on ``x`` (M, n), already in the compute dtype:
    the minor-axis pass, then one 128-wide pass per major factor with a
    transpose in and out. Each pass multiplies in f32 (products of 16-bit
    values are exact there), accumulates in f32 and rounds to the compute
    dtype, as the reference's ``preferred_element_type=f32`` dots do. The
    operands are the compute dtype's values, widened exactly: on the card a
    16-bit product with an f32 result (``torch.mm(..., out_dtype=float32)``)
    runs on tensor cores, whose accumulator is not IEEE f32 (PERF.md), and
    the CPU has no such product."""
    m = x.shape[0]
    cd = x.dtype
    mats = [mt.to(cd).to(torch.float32) for mt in mats]

    def mm(a, b):
        return torch.matmul(a.to(torch.float32), b).to(cd)

    if n < MXU_TILE:
        return mm(x, mats[0])
    x = mm(x.reshape(m * (n // MXU_TILE), MXU_TILE), mats[0]).reshape(m, n)
    post, pre = n // MXU_TILE, 1
    for i in range(len(mats) - 1):
        xv = x.reshape(m * pre, MXU_TILE, post).transpose(-1, -2)
        xv = mm(xv.reshape(m * pre * post, MXU_TILE), mats[i + 1])
        x = xv.reshape(m * pre, post, MXU_TILE).transpose(-1, -2).reshape(m, n)
        pre *= MXU_TILE
        post //= MXU_TILE
    return x


def hadamard_transform(x: torch.Tensor, scale="ortho") -> torch.Tensor:
    """Right Hadamard transform of the last axis, factored, in f32."""
    n = x.shape[-1]
    s = resolve_scale(scale, max(n, 1))
    mats = [torch.from_numpy(m).to(x.device) for m in base_matrices_np(n, s)]
    y = _apply_passes(x.to(torch.float32).reshape(-1, n), n, mats)
    return y.reshape(x.shape).to(x.dtype)


def hadamard_check(x: torch.Tensor, y: torch.Tensor, *, scale="ortho",
                   compute_dtype=None) -> torch.Tensor:
    """Linearity invariant of a pure-rotation site (ABFT; the reference's
    ``hadamard_check``): the column sum of the outputs must equal the
    transform of the column sum of the inputs,

        sum_i H(x)[i, :]  ==  H(sum_i x[i, :]),

    the right side recomputed here in f32 on the one summed row. The
    tolerance, per column, is the reference's: 8 x (the compute / output
    dtype's eps x (column mass / sqrt(m) + the largest |y|) + f32 eps x
    sqrt(m + n) x column mass). Returns a 0-d bool tensor, True = the site
    verified; a non-finite output fails (NaN compares false)."""
    n = x.shape[-1]
    xr = x.reshape(-1, n).to(torch.float32)
    yr = y.reshape(-1, n).to(torch.float32)
    m = max(xr.shape[0], 1)
    cd = resolve_compute_dtype(x.dtype, compute_dtype)
    eps = torch.finfo(torch_dtype(cd)).eps
    if y.dtype.is_floating_point:
        eps = max(eps, torch.finfo(y.dtype).eps)
    eps32 = torch.finfo(torch.float32).eps
    mats = [torch.from_numpy(mt).to(x.device)
            for mt in base_matrices_np(n, resolve_scale(scale, n))]
    ref = _apply_passes(xr.sum(0, keepdim=True), n, mats)
    got = yr.sum(0, keepdim=True)
    colmass = yr.abs().sum(0, keepdim=True)
    tol = 8.0 * (eps * (colmass / math.sqrt(m) + yr.abs().amax())
                 + eps32 * math.sqrt(m + n) * colmass) + 1e-30
    return ((got - ref).abs() <= tol).all()


def largest_pow2_divisor(n: int) -> int:
    return n & (-n)


def grouped_hadamard(x: torch.Tensor, group: Optional[int] = None,
                     scale="ortho") -> torch.Tensor:
    """Hadamard on contiguous groups of the last axis: y = x (I_g (x) H_p),
    ``group`` defaulting to the largest power-of-2 divisor of the axis."""
    n = x.shape[-1]
    p = group if group is not None else largest_pow2_divisor(n)
    if n % p != 0 or not is_pow2(p):
        raise ValueError(f"group {p} must be a power-of-2 divisor of {n}")
    if p == 1:
        return x
    xg = x.reshape(*x.shape[:-1], n // p, p)
    return hadamard_transform(xg, scale=scale).reshape(x.shape)
