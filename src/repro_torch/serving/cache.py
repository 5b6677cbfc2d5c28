"""Slot-based KV cache for the continuous-batching engine (twin of
``repro.serving.cache``).

The cache is allocated ONCE per engine: one (layers, slots, max_len, KH,
hd) buffer each for K and V in the serving KV dtype (real fp8 when the
config quantizes the cache). The engine and the model see it as one
``{"k", "v"}`` dict of (slots, max_len, KH, hd) views per layer -- the
layout ``lm_decode_step`` takes -- and only ever update it in place:
prefill-insert writes a newcomer's rows into its slot, the decode step
writes each slot's token at its own position. Rows past a slot's position
may hold stale data; the per-slot causal mask never attends them and the
decode step overwrites row ``pos`` before attending it.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.models.common import dtype_of
from repro_torch.models.config import ModelConfig


def _shape(cfg: ModelConfig, slots: int, max_len: int):
    return (cfg.num_layers, slots, max_len, cfg.num_kv_heads, cfg.head_dim)


def alloc_kv_caches(cfg: ModelConfig, slots: int, max_len: int,
                    device) -> List[dict]:
    """Zero-initialized per-layer views into one K and one V allocation."""
    kvdt = cfg.quant.kv_cache_dtype(dtype_of(cfg))
    k = torch.zeros(_shape(cfg, slots, max_len), dtype=kvdt, device=device)
    v = torch.zeros(_shape(cfg, slots, max_len), dtype=kvdt, device=device)
    return [{"k": k[i], "v": v[i]} for i in range(cfg.num_layers)]


def cache_bytes(cfg: ModelConfig, slots: int, max_len: int) -> int:
    """Total cache allocation in bytes."""
    kvdt = cfg.quant.kv_cache_dtype(dtype_of(cfg))
    n = 1
    for d in _shape(cfg, slots, max_len):
        n *= d
    return 2 * n * torch.empty((), dtype=kvdt).element_size()


def insert_kv(caches: List[dict], kv: List[dict], slot: int) -> None:
    """Prefill-insert: write a (1, P, KH, hd) prefilled KV block per layer
    into rows [0, P) of ``slot``, in place."""
    for c, p in zip(caches, kv):
        for key in ("k", "v"):
            src = p[key][0]
            c[key][slot, :src.shape[0]] = src.to(c[key].dtype)
