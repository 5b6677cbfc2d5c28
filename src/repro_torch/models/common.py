"""Shared building blocks: initializers, RMSNorm and LayerNorm, RoPE (twin
of ``repro.models.common``)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.hadamard import torch_dtype


def dtype_of(cfg) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """N(0, 1) * scale (default 1/sqrt(d_in)) drawn in f32 from ``gen`` on
    ``device`` (the generator's device by default), cast to ``dtype``."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device if device is not None else gen.device)
    return w.mul_(s).to(dtype)


def init_norm(cfg, d: int, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm (eps 1e-6) or LayerNorm (eps 1e-5, with a bias) in f32, cast
    back to the io dtype. LayerNorm's variance is ``jnp.var``'s: the mean
    of the squared centred values (population form), computed from the
    mean over the row as the reference computes it."""
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"]
    return y.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope_angles(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd), ang: (B, S, half) -> split-half rotated x."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
