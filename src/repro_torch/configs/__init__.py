"""Architecture registry of the port: one module per architecture, each
exporting ``CONFIG`` (the published configuration); select with
``--arch <id>``. The port carries llama3-8b, the paper's own end-to-end
model; phi4-mini-3.8b, whose power-of-2 d_ff runs the fused quantized down
projection; and llama4-maverick-400b-a17b, whose 128 experts run theirs as
one fused launch per MoE layer. The other families of the reference come
with later slices."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["llama3_8b", "phi4_mini_3_8b",
                       "llama4_maverick_400b_a17b"]

_ALIASES = {"llama3-8b": "llama3_8b", "phi4-mini-3.8b": "phi4_mini_3_8b",
            "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b"}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
