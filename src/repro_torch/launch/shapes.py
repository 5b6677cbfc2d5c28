"""The assigned input shapes (twin of ``repro.launch.shapes``, without the
jax shape builders).

    train_4k     seq 4,096   global_batch 256   (train_step)
    prefill_32k  seq 32,768  global_batch 32    (prefill_step)
    decode_32k   seq 32,768  global_batch 128   (serve_step: 1 new token,
                                                 KV cache of seq_len)
    long_500k    seq 524,288 global_batch 1     (serve_step; SSM/hybrid only)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["ShapeSpec", "SHAPES", "shape_applicable"]


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
    """None if the (arch, shape) cell runs; else the reason for the skip.
    Every architecture of the port is a causal decoder with full attention."""
    if shape.name == "long_500k" and not getattr(cfg, "sub_quadratic", False):
        return "long_500k needs sub-quadratic attention (pure full-attention arch)"
    if shape.kind == "decode" and not getattr(cfg, "has_decoder", True):
        return "encoder-only arch has no decode step"
    return None
