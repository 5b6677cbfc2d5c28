"""Numeric guardrails for the serving hot path (twin of
``repro.core.guards``; switched on by ``REPRO_NUMERIC_GUARDS``).

A non-finite scale or activation poisons a slot's logits and every later
token; these guards make that failure loud and local:

  * ``rows_ok(x, batch)`` -- per-slot ``isfinite`` over the step's logits
    (the engine reads the (slots,) bool vector and retires a tripped slot
    as ``nan_guard`` instead of emitting its token);
  * ``scale_rows_ok(s, batch)`` -- per-token quant scales finite and
    strictly positive;
  * ``guard_dequant(y, s)`` -- the scale check at ``core.quant.quantize``:
    rows whose scale is non-finite or non-positive become NaN, so the
    logits guard attributes the failure to the right slot. An exact
    select: the identity on healthy scales.

Scales inside the fused kernels are covered transitively (a non-finite
kernel scale gives non-finite outputs, which the logits guard catches).
With the switch off nothing here runs, and the guarded step's tokens are
bitwise the unguarded step's.
"""
from __future__ import annotations

import os

import torch

__all__ = ["GUARDS_ENV", "guards_enabled", "rows_ok", "scale_rows_ok",
           "guard_dequant"]

GUARDS_ENV = "REPRO_NUMERIC_GUARDS"


def guards_enabled() -> bool:
    """The opt-in switch, read when a step is built or a site runs."""
    return os.environ.get(GUARDS_ENV, "").lower() in ("1", "true", "on")


def _per_row(ok: torch.Tensor, batch: int) -> torch.Tensor:
    """Reduce an elementwise bool tensor to (batch,): per row when the
    leading axis is the slot axis, else one all() for every slot (a
    poisoned tensor the guard cannot attribute flags every slot)."""
    if ok.ndim >= 1 and ok.shape[0] == batch:
        return ok.reshape(batch, -1).all(-1)
    return ok.all().expand(batch)


def rows_ok(x: torch.Tensor, batch: int) -> torch.Tensor:
    """(batch,) bool: every element of slot b's row of ``x`` is finite."""
    return _per_row(torch.isfinite(x.to(torch.float32)), batch)


def scale_rows_ok(s: torch.Tensor, batch: int) -> torch.Tensor:
    """(batch,) bool: slot b's per-token quant scales are finite and > 0."""
    f = s.to(torch.float32)
    return _per_row(torch.isfinite(f) & (f > 0), batch)


def guard_dequant(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """NaN where the (keepdim) scale ``s`` is non-finite or non-positive;
    ``y`` bitwise elsewhere."""
    f = s.to(torch.float32)
    bad = ~(torch.isfinite(f) & (f > 0))
    return torch.where(bad, torch.full((), float("nan"), dtype=y.dtype,
                                       device=y.device), y)
