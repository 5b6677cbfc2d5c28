"""Architecture registry of the port: one module per architecture, each
exporting ``CONFIG`` (the published configuration); select with
``--arch <id>``. The port carries llama3-8b, the paper's own end-to-end
model; phi4-mini-3.8b, whose power-of-2 d_ff runs the fused quantized down
projection; llama4-maverick-400b-a17b, whose 128 experts run theirs as one
fused launch per MoE layer; and the causal decoders whose d_ff is not a
power of 2, so their down projections rotate as grouped transforms:
llama3-405b, qwen1.5-4b (QKV biases), starcoder2-15b (LayerNorm, GELU, QKV
biases) and mixtral-8x7b (top-2 experts, sliding-window attention); the
encoder-decoder whisper-base (fused 2048 -> 512 down projections, head_dim
64), the vlm qwen2-vl-7b (M-RoPE, patch embeddings, d_ff 37 x 512), and
the recurrent-state families: rwkv6-7b (RWKV6 time and channel mix) and the
hybrid zamba2-7b (Mamba2 SSD layers with an attention layer every sixth,
head_dim 112). These are all 11 of the reference's architectures."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["llama3_8b", "phi4_mini_3_8b",
                       "llama4_maverick_400b_a17b", "llama3_405b", "qwen1_5_4b",
                       "starcoder2_15b", "mixtral_8x7b", "whisper_base", "qwen2_vl_7b",
                       "rwkv6_7b", "zamba2_7b"]

_ALIASES = {"llama3-8b": "llama3_8b", "phi4-mini-3.8b": "phi4_mini_3_8b",
            "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
            "llama3-405b": "llama3_405b", "qwen1.5-4b": "qwen1_5_4b",
            "starcoder2-15b": "starcoder2_15b", "mixtral-8x7b": "mixtral_8x7b",
            "whisper-base": "whisper_base", "qwen2-vl-7b": "qwen2_vl_7b",
            "rwkv6-7b": "rwkv6_7b", "zamba2-7b": "zamba2_7b"}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
