"""Model configuration (twin of ``repro.models.config``).

A model is a list of ``groups``; each group is ``(pattern, repeats)`` with
``pattern`` a tuple of layer kinds. The port runs six kinds: four with GQA
attention -- 'attn' (causal, a dense MLP), 'moe' (causal, top-k routed
experts with capacity dropping, plus an optional shared expert), and the
encoder-decoder pair of whisper: 'enc_attn' (the encoder's non-causal
self-attention and MLP, in ``encoder_groups``) and 'xattn' (the decoder's
causal self-attention, cross-attention to the encoder output, MLP) -- and
two with a recurrent state in place of a KV cache: 'rwkv' (RWKV6's time
mix and channel mix, ``rwkv_head_dim``, ``rwkv_impl``, ``rwkv_chunk``) and
'mamba' (Mamba2's chunked SSD, ``ssm_state``, ``ssm_head_dim``,
``ssm_expand``). ``sub_quadratic`` marks the models eligible for the
long_500k shape. The attention flavour and the MLP are the reference's
options:
``sliding_window`` (mixtral), ``qkv_bias`` (qwen1.5, starcoder2), ``mrope``
(qwen2-vl's three position streams), ``act`` (SwiGLU, or the tanh GELU MLP
without a gate) and ``norm`` (RMSNorm or LayerNorm). A vlm prepends
``vlm_patches`` precomputed patch embeddings to the tokens; an
encoder-decoder reads ``encoder_seq`` precomputed frame embeddings (the
reference stubs both frontends alike). Its layers are a plain list, one
entry per layer, where the reference scans stacked parameters.
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
    family: str                      # dense | moe | vlm | audio | ssm | hybrid
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    groups: Tuple[Group, ...]        # decoder stack (or the only stack)
    head_dim: Optional[int] = None   # None -> d_model // num_heads
    encoder_groups: Tuple[Group, ...] = ()   # whisper's encoder stack
    encoder_seq: int = 1500          # precomputed frame embeddings per input
    sliding_window: int = 0          # 0 = full attention
    rope_theta: float = 10000.0
    qkv_bias: bool = False           # qwen1.5, starcoder2
    mrope: bool = False              # qwen2-vl M-RoPE (3 position streams)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    num_experts: int = 0
    experts_per_token: int = 0
    moe_shared_expert: bool = False  # llama4
    capacity_factor: float = 1.25
    ssm_state: int = 0               # mamba2 N
    ssm_head_dim: int = 64           # mamba2 P
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    rwkv_impl: str = "chunked"       # chunked (GLA-style) | scan (the recurrence)
    rwkv_chunk: int = 32             # chunk length of the chunked form
    act: str = "swiglu"              # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    vocab_pad_multiple: int = 256
    weight_quant: str = "none"       # none | int8 (weight-only storage, serving)
    tie_embeddings: bool = False     # logits contract with emb^T; no unemb
    vlm_patches: int = 1024          # precomputed patch embeddings (vlm only)
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    dtype: str = "bfloat16"
    remat: str = "dots"              # none | dots | full: recompute each block in
                                     # the backward pass unless "none"
    sub_quadratic: bool = False      # eligible for long_500k
    has_decoder: bool = True         # encoder-only models skip decode shapes

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
    def encoder_layer_kinds(self) -> Tuple[LayerKind, ...]:
        """Every encoder layer's kind, in order (empty without an encoder)."""
        return tuple(k for p, r in self.encoder_groups for _ in range(r) for k in p)

    @property
    def is_encdec(self) -> bool:
        return bool(self.encoder_groups)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def with_quant(self, quant: QuantConfig) -> "ModelConfig":
        return dataclasses.replace(self, quant=quant)

    def scaled_down(self, **overrides) -> "ModelConfig":
        """Reduced config for CPU tests: shrink the capacity knobs, keep
        the GQA ratio, the power-of-2-ness of d_ff, tied embeddings, the MoE
        routing (at most 4 experts, at most 2 per token), the attention and
        MLP flavour (a window of at most 8 tokens, so that it bites at test
        lengths), M-RoPE and its sections, the encoder (at most 2 repeats
        of each group, 16 frames) and 4 patches, and the quant settings
        (the reference's rule, restricted to these fields). The state
        sizes shrink as the reference's do (an SSM state of at most 16, SSM
        and RWKV heads of 16), and zamba2-7b keeps a head_dim that is not a
        power of 2 (d_model 28 x heads)."""
        ratio = max(1, self.num_heads // max(self.num_kv_heads, 1))
        heads = max(2, ratio)
        small = dict(
            d_model=32 * heads,
            num_heads=heads,
            num_kv_heads=max(1, heads // ratio),
            d_ff=128 if self.d_ff & (self.d_ff - 1) == 0 else 96,
            vocab_size=512,
            groups=tuple((p, min(r, 2)) for p, r in self.groups),
            encoder_groups=tuple((p, min(r, 2)) for p, r in self.encoder_groups),
            encoder_seq=16,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=(min(self.experts_per_token, 2)
                               if self.experts_per_token else 0),
            sliding_window=(min(self.sliding_window, 8)
                            if self.sliding_window else 0),
            vlm_patches=4,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            rwkv_head_dim=16,
            head_dim=None,
        )
        if self.name == "zamba2-7b":
            small["d_model"] = 28 * heads
        small.update(overrides)
        return dataclasses.replace(self, **small)
