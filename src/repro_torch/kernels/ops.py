"""DEPRECATED shim: the differentiable Hadamard op (twin of
``repro.kernels.ops``).

``kernels.ops.hadamard`` predates the plan-based API and is kept only for
backward compatibility: a thin wrapper over ``repro_torch.core.api.hadamard``
(the same self-adjoint autograd Function and the registry's dispatch). New
code should use::

    from repro_torch.core.api import hadamard, plan_for

Each call ticks ``TRACE_COUNTS[WARN_KEY]``, which the linter's
``deprecated-shim-in-trace`` rule reads; the warning itself fires once.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.api import hadamard as _hadamard
from repro_torch.kernels.ref import is_pow2
from repro_torch.kernels.registry import warn_once

__all__ = ["hadamard", "WARN_KEY"]

# warn-once key: one DeprecationWarning per process, with a
# TRACE_COUNTS[WARN_KEY] tick on every call (the registry's idiom)
WARN_KEY = ("deprecated", "kernels.ops.hadamard")


def hadamard(x: torch.Tensor, scale: Optional[str] = "ortho",
             backend: str = "cuda") -> torch.Tensor:
    """Differentiable right Hadamard transform of the last axis.

    Deprecated: use ``repro_torch.core.api.hadamard``. ``backend="cuda"``
    runs K1 on a CUDA tensor and its plain version on a CPU tensor.
    Sizes that are not powers of 2 are rejected as before (the plan API's
    grouped transform is an explicit opt-in)."""
    warn_once(WARN_KEY,
              "repro_torch.kernels.ops.hadamard is deprecated; use "
              "repro_torch.core.api.hadamard (optionally with a prebuilt "
              "plan_for plan for the hot path)",
              category=DeprecationWarning, stacklevel=3)
    if not is_pow2(x.shape[-1]):
        raise ValueError(f"Hadamard size must be a power of 2, got {x.shape[-1]}")
    return _hadamard(x, scale=scale, backend=backend)
