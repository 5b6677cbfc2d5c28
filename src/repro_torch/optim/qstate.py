"""Blockwise-int8 optimizer state (8-bit Adam; twin of
``repro.optim.qstate``): each moment tensor is flattened to (rows, last
dim), padded to whole blocks of 256 along the last dim, and stored as int8
with one f32 absmax scale per block. Stacking the states of the layers of a
group row-wise gives the reference's state of the stacked parameter.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels.registry import f32_reciprocal

__all__ = ["quantize_state", "dequantize_state", "zeros_like_qstate", "is_qstate",
           "qstate_specs"]

_BLOCK = 256


def is_qstate(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def quantize_state(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """f32 tensor -> {'q': int8 (rows, padded), 's': f32 (rows, blocks)}.
    The reference's ``max(absmax, 1e-12) / 127`` compiles to a product with
    f32(1 / 127); so does this."""
    shape = x.shape
    last = shape[-1] if len(shape) else 1
    pad = (-last) % _BLOCK
    xf = x.to(torch.float32).reshape(-1, last)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    xb = xf.reshape(xf.shape[0], -1, _BLOCK)
    s = torch.clamp_min(xb.abs().amax(-1, keepdim=True), 1e-12) * f32_reciprocal(127.0)
    q = torch.clamp(torch.round(xb / s), -127, 127).to(torch.int8)
    return {"q": q.reshape(xf.shape[0], -1), "s": s[..., 0].reshape(xf.shape[0], -1)}


def dequantize_state(t: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    q = t["q"].to(torch.float32).reshape(t["q"].shape[0], -1, _BLOCK)
    x = (q * t["s"][..., None]).reshape(t["q"].shape[0], -1)
    last = shape[-1] if len(shape) else 1
    return x[:, :last].reshape(shape)


def zeros_like_qstate(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    return quantize_state(torch.zeros(x.shape, dtype=torch.float32, device=x.device))


def qstate_specs(param_spec: tuple) -> Dict[str, Any]:
    """Logical sharding of a blockwise-int8 moment of a parameter with
    logical axes ``param_spec``: the (rows, cols) storage takes rows on the
    first named leading axis and cols on the parameter's last axis (a 1-D
    parameter's one axis goes to the rows), for both "q" and "s" -- the
    reference's rule, name for name."""
    lead = next((a for a in param_spec[:-1] if a is not None), None)
    last = param_spec[-1] if len(param_spec) > 1 else None
    if lead is None and param_spec and len(param_spec) == 1:
        lead = param_spec[-1]
        last = None
    return {"q": (lead, last), "s": (lead, last)}
