"""Simulated low-precision quantization (INT8 / FP8) for rotation-quantized
inference (twin of ``repro.core.quant``).

Fake quant: values are quantized and immediately dequantized, reproducing
the INT8/FP8 numerics with symmetric per-token or per-channel scales. The
math is ``kernels.registry._quantize_rows`` / ``_dequantize``, shared with
the K2 kernel's plain version. With ``REPRO_NUMERIC_GUARDS`` on,
``quantize`` NaN-poisons the rows of a non-finite or non-positive scale
(``core.guards.guard_dequant``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import guards

__all__ = ["QuantConfig", "quantize", "quant_dot", "kv_quantize"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization + rotation switches carried by every model config.

    mode:     'none' | 'int8' | 'fp8_e4m3' | 'fp8_e5m2'
    rotate:   'none' | 'hadamard'  (online Hadamard at the QuaRot points)
    backend:  'cuda' (the hand-written kernels) | 'torch' (their plain
              versions) | 'ref' (scalar FWHT oracle) | 'auto' (registry:
              REPRO_HADAMARD_BACKEND, then the kernels for CUDA tensors and
              the plain versions for CPU tensors)
    kv_quant: quantize the KV cache (the paper's FP8-attention case)
    schedule: the fused quant_dot kernels' schedule at every consumer site
              ('rotate_once' | 'revisit' | 'streamed'; None defers to
              REPRO_QUANT_DOT_SCHEDULE, then rotate-once). The serving
              engine's degradation ladder pins it one rung down.
    abft:     store ABFT column checksums on the quantized weights and
              verify the fused quant_dot outputs and the serving KV cache
              at run time (``repro_torch.verify``); ``REPRO_ABFT=1``
              switches it on without a config edit.
    """
    mode: str = "none"
    rotate: str = "none"
    backend: str = "auto"
    kv_quant: bool = False
    per_token: bool = True
    schedule: Optional[str] = None
    abft: bool = False

    _MODES = ("none", "int8", "fp8_e4m3", "fp8_e5m2")
    _ROTATES = ("none", "hadamard")
    _BACKENDS = ("cuda", "torch", "ref", "auto")

    def __post_init__(self):
        if self.mode not in self._MODES:
            raise ValueError(f"unknown quant mode {self.mode!r}; expected one of {self._MODES}")
        if self.rotate not in self._ROTATES:
            raise ValueError(f"unknown rotate {self.rotate!r}; expected one of {self._ROTATES}")
        if self.backend not in self._BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected one of {self._BACKENDS}")
        if self.schedule is not None:
            from repro_torch.kernels.quant_dot import SCHEDULES

            if self.schedule not in SCHEDULES:
                raise ValueError(f"unknown quant_dot schedule {self.schedule!r}; "
                                 f"expected None or one of {SCHEDULES}")

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    @property
    def rotating(self) -> bool:
        return self.rotate != "none"

    def kv_cache_dtype(self, model_dtype: torch.dtype) -> torch.dtype:
        """Storage dtype of the KV cache: real fp8 when fp8 KV quant is on."""
        if self.kv_quant and self.mode == "fp8_e4m3":
            return torch.float8_e4m3fn
        if self.kv_quant and self.mode == "fp8_e5m2":
            return torch.float8_e5m2
        return model_dtype


def quantize(x: torch.Tensor, mode: str, axis: Optional[int] = -1) -> torch.Tensor:
    """Symmetric fake-quantize along ``axis`` (None = per-tensor): int8
    rounds half to even onto [-127, 127]; fp8 scales to the format's max
    and casts through the real fp8 dtype."""
    if mode == "none":
        return x
    from repro_torch.kernels.registry import QSPECS, _dequantize, _quantize_rows

    if mode not in QSPECS:
        raise ValueError(f"unknown quant mode {mode!r}")
    q, s = _quantize_rows(x.to(torch.float32), mode, axis=axis)
    y = _dequantize(q, s, mode).to(x.dtype)
    if guards.guards_enabled():
        y = guards.guard_dequant(y, s)
    return y


def quant_dot(x: torch.Tensor, w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """x @ w with fake-quantized operands: per-token scales on the
    activation, per-out-channel scales on the weight."""
    if not cfg.enabled:
        return x @ w
    xq = quantize(x, cfg.mode, axis=-1 if cfg.per_token else None)
    wq = quantize(w, cfg.mode, axis=0)
    return xq @ wq


def kv_quantize(k: torch.Tensor, v: torch.Tensor, cfg: QuantConfig):
    """Quantize K/V on the head dim before the cache write."""
    if not (cfg.enabled and cfg.kv_quant):
        return k, v
    return quantize(k, cfg.mode, axis=-1), quantize(v, cfg.mode, axis=-1)
