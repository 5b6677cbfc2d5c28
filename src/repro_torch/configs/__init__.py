"""Architecture registry of the port: one module per architecture, each
exporting ``CONFIG`` (the published configuration); select with
``--arch <id>``. The port carries llama3-8b, the paper's own end-to-end
model; phi4-mini-3.8b, whose power-of-2 d_ff runs the fused quantized down
projection; llama4-maverick-400b-a17b, whose 128 experts run theirs as one
fused launch per MoE layer; and the causal decoders whose d_ff is not a
power of 2, so their down projections rotate as grouped transforms:
llama3-405b, qwen1.5-4b (QKV biases), starcoder2-15b (LayerNorm, GELU, QKV
biases) and mixtral-8x7b (top-2 experts, sliding-window attention). The
other families of the reference come with later slices."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["llama3_8b", "phi4_mini_3_8b",
                       "llama4_maverick_400b_a17b", "llama3_405b", "qwen1_5_4b",
                       "starcoder2_15b", "mixtral_8x7b"]

_ALIASES = {"llama3-8b": "llama3_8b", "phi4-mini-3.8b": "phi4_mini_3_8b",
            "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
            "llama3-405b": "llama3_405b", "qwen1.5-4b": "qwen1_5_4b",
            "starcoder2-15b": "starcoder2_15b", "mixtral-8x7b": "mixtral_8x7b"}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
