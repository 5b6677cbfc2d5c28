"""The assigned input shapes, a host batch builder and the batch's and
caches' logical axes (twin of ``repro.launch.shapes``, without the jax
shape builders).

    train_4k     seq 4,096   global_batch 256   (train_step)
    prefill_32k  seq 32,768  global_batch 32    (prefill_step)
    decode_32k   seq 32,768  global_batch 128   (serve_step: 1 new token,
                                                 KV cache of seq_len)
    long_500k    seq 524,288 global_batch 1     (serve_step; SSM/hybrid only)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["ShapeSpec", "SHAPES", "shape_applicable", "make_batch",
           "batch_logical_specs", "cache_logical_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the reason for the skip
    (the reference's rules: long_500k needs sub-quadratic attention, which
    rwkv6-7b and zamba2-7b have; an encoder-only model has no decode)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "long_500k needs sub-quadratic attention (pure full-attention arch)"
    if shape.kind == "decode" and not cfg.has_decoder:
        return "encoder-only arch has no decode step"
    return None


def make_batch(cfg, shape: ShapeSpec, seed: int = 0) -> Dict[str, np.ndarray]:
    """A real host batch drawn from ``seed`` as the reference's
    ``make_batch`` draws it, in its order: int32 tokens and next-token
    labels; a vlm's sequence of ``shape.seq`` holds ``vlm_patches`` patch
    embeddings (B, P, d) and S - P tokens, with (3, B, S) int32 M-RoPE
    positions, each stream 0..S-1; an encoder-decoder adds the frames
    (B, encoder_seq, d). The embeddings are f32 here; the reference's
    model-dtype values are these rounded once more (``jnp.asarray`` of the
    f64 draw rounds through f32 as well), where the model casts them."""
    rng = np.random.default_rng(seed)
    B, S = shape.batch, shape.seq
    out: Dict[str, np.ndarray] = {}
    if cfg.family == "vlm":
        P = cfg.vlm_patches
        toks = rng.integers(0, cfg.vocab_size, (B, S - P + 1), dtype=np.int32)
        out["tokens"], out["labels"] = toks[:, :-1], toks[:, 1:]
        out["patch_embeds"] = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
        out["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    else:
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
        out["tokens"], out["labels"] = toks[:, :-1], toks[:, 1:]
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def batch_logical_specs(cfg) -> Dict[str, Any]:
    """Logical axes of ``make_batch``'s entries."""
    specs: Dict[str, Any] = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.family == "vlm":
        specs["patch_embeds"] = ("batch", "seq", None)
        specs["positions"] = (None, "batch", "seq")
    if cfg.is_encdec:
        specs["frames"] = ("batch", None, None)
    return specs


def _cache_specs(kind: str) -> Dict[str, tuple]:
    """One layer's cache entries' logical axes, behind the reference's
    leading 'layers' axis."""
    if kind in ("attn", "moe"):
        return {"k": ("layers", "batch", "kvseq", "kv", None),
                "v": ("layers", "batch", "kvseq", "kv", None)}
    if kind == "xattn":
        return {"k": ("layers", "batch", "kvseq", "kv", None),
                "v": ("layers", "batch", "kvseq", "kv", None),
                "xk": ("layers", "batch", None, "kv", None),
                "xv": ("layers", "batch", None, "kv", None)}
    if kind == "mamba":
        return {"ssm": ("layers", "batch", "heads", None, None),
                "conv_x": ("layers", "batch", None, "dff"),
                "conv_bc": ("layers", "batch", None, None)}
    if kind == "rwkv":
        return {"S": ("layers", "batch", "heads", None, None),
                "xp_t": ("layers", "batch", None),
                "xp_c": ("layers", "batch", None)}
    raise ValueError(kind)


def cache_logical_specs(cfg, stacked: bool = False) -> List[Any]:
    """Logical axes of the decode caches: one dict per decoder layer, the
    port's layout, or, with ``stacked``, the reference's (one dict of
    ``p<j>`` per group, each entry behind a 'layers' axis)."""
    if stacked:
        return [{f"p{j}": _cache_specs(kind) for j, kind in enumerate(pattern)}
                for pattern, _ in cfg.groups]
    return [{k: v[1:] for k, v in _cache_specs(kind).items()}
            for kind in cfg.layer_kinds]
