"""Model configuration (twin of ``repro.models.config``, trimmed to what
the port runs: causal-attention decoders, dense or mixture-of-experts).

A model is a list of ``groups``; each group is ``(pattern, repeats)`` with
``pattern`` a tuple of layer kinds. The port runs two kinds, both with GQA
attention and RMSNorm: 'attn' (dense SwiGLU MLP: llama3-8b, and phi4-mini
with tied embeddings) and 'moe' (top-k routed SwiGLU experts with capacity
dropping, plus an optional shared expert: llama4-maverick interleaves the
two). Its layers are a plain list, one entry per layer, where the reference
scans stacked parameters. The reference's other options (sliding windows,
GELU, LayerNorm, state-space and encoder layers) come with the configs that
need them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.quant import QuantConfig

LayerKind = str
Group = Tuple[Tuple[LayerKind, ...], int]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    groups: Tuple[Group, ...]
    head_dim: Optional[int] = None   # None -> d_model // num_heads
    rope_theta: float = 10000.0
    num_experts: int = 0
    experts_per_token: int = 0
    moe_shared_expert: bool = False  # llama4
    capacity_factor: float = 1.25
    vocab_pad_multiple: int = 256
    weight_quant: str = "none"       # none | int8 (weight-only storage, serving)
    tie_embeddings: bool = False     # logits contract with emb^T; no unemb
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    dtype: str = "bfloat16"
    remat: str = "dots"              # none | dots | full: recompute each block in
                                     # the backward pass unless "none"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def num_layers(self) -> int:
        return sum(len(p) * r for p, r in self.groups)

    @property
    def layer_kinds(self) -> Tuple[LayerKind, ...]:
        """Every layer's kind, in order (groups unrolled)."""
        return tuple(k for p, r in self.groups for _ in range(r) for k in p)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def with_quant(self, quant: QuantConfig) -> "ModelConfig":
        return dataclasses.replace(self, quant=quant)

    def scaled_down(self, **overrides) -> "ModelConfig":
        """Reduced config for CPU tests: shrink the capacity knobs, keep
        the GQA ratio, the power-of-2-ness of d_ff, tied embeddings, the MoE
        routing (at most 4 experts, at most 2 per token) and the quant
        settings (the reference's rule, restricted to these fields)."""
        ratio = max(1, self.num_heads // max(self.num_kv_heads, 1))
        heads = max(2, ratio)
        small = dict(
            d_model=32 * heads,
            num_heads=heads,
            num_kv_heads=max(1, heads // ratio),
            d_ff=128 if self.d_ff & (self.d_ff - 1) == 0 else 96,
            vocab_size=512,
            groups=tuple((p, min(r, 2)) for p, r in self.groups),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=(min(self.experts_per_token, 2)
                               if self.experts_per_token else 0),
            head_dim=None,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
