"""Analytic MODEL_FLOPS per (architecture, shape) -- the 'useful work'
denominator for utilization readings (twin of ``repro.launch.flops``).

Conventions (PaLM-style MFU accounting), as the reference's:
  * matmul params count 2 FLOPs/param/token forward; train = 3x forward
    (activation grads + weight grads).
  * MoE counts only routed-active experts (6 * N_active * D).
  * attention scores/context add 4*B*S^2*H*hd per full-attention layer
    forward (the full square); sliding-window uses S*W.
  * decode counts one token against the full KV cache.

Parameter counts come from the port's own parameter shapes: ``init_lm`` on
the meta device, which allocates and draws nothing. A pre-quantized leaf
counts its values and its scales, as the reference counts a QTensor's
leaves.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.launch import shapes as shp
from repro_torch.models.config import ModelConfig

__all__ = ["count_params", "model_flops"]


def _leaves(tree, keys: Tuple[str, ...] = ()):
    """(keys, shape) of every array of a parameter tree (a QTensor's values
    and scales, and its checksum when it has one)."""
    from repro_torch.core.wquant import QTensor

    if isinstance(tree, QTensor):
        for name in ("q", "scale", "check"):
            t = getattr(tree, name)
            if t is not None:
                yield keys, tuple(t.shape)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, keys + (k,))
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v, keys)
    else:
        yield keys, tuple(tree.shape)


def _param_sizes(cfg: ModelConfig) -> Dict[str, float]:
    from repro_torch.models.lm import init_lm

    total = emb = experts = 0.0
    for keys, shape in _leaves(init_lm(cfg, device="meta")):
        sz = 1.0
        for d in shape:
            sz *= d
        total += sz
        if "experts" in keys:
            experts += sz
        if keys and keys[-1] == "emb":
            emb += sz
    return {"total": total, "emb": emb, "experts": experts}


def count_params(cfg: ModelConfig) -> Dict[str, float]:
    """{"total", "active" (the experts a token is routed to), "emb",
    "experts"} parameter counts."""
    s = _param_sizes(cfg)
    E, K = max(cfg.num_experts, 1), max(cfg.experts_per_token, 1)
    active = s["total"] - s["experts"] * (1.0 - K / E)
    return {"total": s["total"], "active": active, "emb": s["emb"],
            "experts": s["experts"]}


def _attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for k in cfg.layer_kinds if k in ("attn", "moe"))


def _matmul_params(cfg: ModelConfig, active: bool = True) -> float:
    c = count_params(cfg)
    n = c["active"] if active else c["total"]
    n -= c["emb"]                     # token gather is not a matmul
    if cfg.tie_embeddings:
        n += c["emb"]                 # ...but the tied unembed matmul is
    return n


def model_flops(cfg: ModelConfig, shape: shp.ShapeSpec) -> float:
    B, S = shape.batch, shape.seq
    H, hd = cfg.num_heads, cfg.head_dim
    La = _attn_layers(cfg)
    n_mm = _matmul_params(cfg, active=True)
    eff_kv = min(S, cfg.sliding_window) if cfg.sliding_window else S

    if shape.kind in ("train", "prefill"):
        fwd = 2.0 * n_mm * B * S + 4.0 * B * S * eff_kv * H * hd * La
        return fwd * (3.0 if shape.kind == "train" else 1.0)

    # decode: one token, full cache
    return 2.0 * n_mm * B + 4.0 * B * eff_kv * H * hd * La
