"""Scalar oracle for the Fast Walsh-Hadamard Transform (twin of
``repro.kernels.ref``): the paper's Listing 1 butterfly, vectorized over
leading axes, plus the explicit Sylvester matrix the tests check against."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["fwht", "hadamard_matrix", "is_pow2", "ortho_scale"]


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def fwht(x: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Right Walsh-Hadamard transform of the last axis, ``x @ H_n * scale``,
    as log2(n) butterfly stages in f32 (stage h pairs j with j+h)."""
    n = x.shape[-1]
    if not is_pow2(n):
        raise ValueError(f"FWHT size must be a power of 2, got {n}")
    orig_shape, orig_dtype = x.shape, x.dtype
    y = x.to(torch.float32).reshape(-1, n)
    h = 1
    while h < n:
        y = y.reshape(-1, n // (2 * h), 2, h)
        a, b = y[:, :, 0, :], y[:, :, 1, :]
        y = torch.stack([a + b, a - b], dim=2)
        h *= 2
    y = y.reshape(orig_shape)
    if scale is not None:
        y = y * scale
    return y.to(orig_dtype)


def hadamard_matrix(n: int, scale: Optional[float] = None) -> np.ndarray:
    """Explicit Sylvester-construction Walsh-Hadamard matrix (numpy, f32)."""
    if not is_pow2(n):
        raise ValueError(f"Hadamard size must be a power of 2, got {n}")
    H = np.array([[1.0]], dtype=np.float32)
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    if scale is not None:
        H = H * scale
    return H.astype(np.float32)


def ortho_scale(n: int) -> float:
    """The orthonormal scale 1/sqrt(n)."""
    return 1.0 / math.sqrt(n)
