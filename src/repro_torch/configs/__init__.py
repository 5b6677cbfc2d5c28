"""Architecture registry of the port: one module per architecture, each
exporting ``CONFIG`` (the published configuration); select with
``--arch <id>``. The port carries llama3-8b, the paper's own end-to-end
model, and phi4-mini-3.8b, whose power-of-2 d_ff runs the fused quantized
down projection; the other families of the reference come with later
slices."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["llama3_8b", "phi4_mini_3_8b"]

_ALIASES = {"llama3-8b": "llama3_8b", "phi4-mini-3.8b": "phi4_mini_3_8b"}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
