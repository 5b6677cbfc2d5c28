"""Shared building blocks: initializers, RMSNorm and LayerNorm, RoPE and
M-RoPE, sinusoidal positions (twin of ``repro.models.common``)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

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


def mrope_angles(positions: torch.Tensor, hd: int, theta: float,
                 sections: Tuple[int, ...]) -> torch.Tensor:
    """(3, B, S) positions -> (B, S, half) f32 angles, each rotary
    frequency taking its angle from one of the temporal / height / width
    streams (Qwen2-VL: the first ``sections[0]`` frequencies from t, the
    next ``sections[1]`` from h, the rest from w; frequencies past the
    sections from t). The reference selects with a one-hot f32 einsum,
    whose sums add exact zeros to the chosen product: an index gather gives
    the same bits."""
    half = hd // 2
    ang = positions[..., None].to(torch.float32) * rope_freqs(
        hd, theta, device=positions.device)                     # (3, B, S, half)
    idx = [i for i, s in enumerate(sections) for _ in range(s)]
    idx = torch.tensor((idx + [0] * half)[:half], device=positions.device)
    return ang[idx, :, :, torch.arange(half, device=positions.device)].permute(1, 2, 0)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style (seq, d) f32 sinusoidal embeddings: sin of pos x
    10000^(-2i/d) in the first half of the columns, cos in the second (any
    length: the reference's 448 -> 32k decode-context adaptation,
    DESIGN.md). The exponent and the angles are the reference's f32 values;
    the exp, sin and cos are computed in f64 and rounded once to f32. XLA's
    f32 exp gives those values (torch's f32 exp is 1 ulp off in a few
    entries, which the angles of late positions multiply); its sin and cos
    are within 1 f32 ulp of them."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp((-math.log(10000.0) * dim / d).double()).float()
    ang = (pos * inv).double()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()
