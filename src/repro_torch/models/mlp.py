"""Dense SwiGLU MLP with the QuaRot online Hadamard on the
down-projection input (twin of the dense half of ``repro.models.mlp``).

The down projection is a ``QuantDotSpec`` site: rotate (K1 on the card;
grouped 2048-point transforms for llama3-8b's d_ff = 14336 = 7 * 2048),
per-token quantize, and contract against the pre-quantized weight.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.api import QuantDotSpec
from repro_torch.models.common import dense_init, dtype_of


def init_mlp(gen: torch.Generator, cfg, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    return {"w_gate": dense_init(gen, d, f, dt, device=device),
            "w_up": dense_init(gen, d, f, dt, device=device),
            "w_down": dense_init(gen, f, d, dt, scale=1.0 / math.sqrt(f),
                                 device=device)}


def apply_mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    # jax.nn.silu lowers to g * (1 / (1 + exp(-g))) with every op rounded
    # to the io dtype; torch.sigmoid rounds once and differs from it in about
    # a third of bf16 values
    h = g * (1.0 / (1.0 + torch.exp(-g))) * (x @ p["w_up"])
    spec = QuantDotSpec.for_config(h.shape[-1], cfg.quant)
    return spec.bind(p["w_down"])(h)
