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

On a mesh (``mesh=``) a rank's cache holds the KV heads its layers compute
(``models.lm.kv_heads``): KH / D of them where 'model' splits the KV heads,
all KH where it does not; the layers of each head count share one
allocation. Where the rules split the cache's sequence ('kvseq', the
serving preset ``launch.dryrun.decode_rules``; ``seq_split``), a rank holds
``max_len / D`` contiguous rows of every slot it holds, for all the KV heads
the 'kv' rule leaves it: its share (``sharding.local_kvseq``, which the
functions below read; the rows it owns are ``sharding.kvseq_row``'s).
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.distributed.sharding import (WHOLE, Split, _build_parts, _split_of, axes_of,
                                              current_mesh, kvseq_split, kvseq_start,
                                              sharding_rules)
from repro_torch.models.common import dtype_of
from repro_torch.models.config import ModelConfig


def _heads(cfg: ModelConfig, mesh=None) -> List[int]:
    """Each layer's cached KV heads on this rank of ``mesh``: under the
    active rules where ``mesh`` is the active mesh, else under the default
    ones (all of them off a mesh)."""
    if mesh is None:
        return [cfg.num_kv_heads] * cfg.num_layers
    from repro_torch.models.lm import kv_heads

    if current_mesh() is mesh:
        return kv_heads(cfg)
    with sharding_rules(mesh):
        return kv_heads(cfg)


def seq_split(cfg: ModelConfig, slots: int, max_len: int) -> Split:
    """This rank's share of the cache rows on the active mesh under the
    active rules: the cache spec ``("batch", "kvseq", "kv", None)`` resolved
    on the whole cache's shape (``slots`` slots of ``max_len`` rows), with
    the divisibility guard and the de-duplication (the batch dim takes its
    axes first); ``WHOLE`` off a mesh. Raises where the KV heads the layers
    compute split over the axes the rows take."""
    mesh = current_mesh()
    if mesh is None:
        return WHOLE
    parts = _build_parts(mesh, ("batch", "kvseq", "kv", None),
                         (slots, max_len, cfg.num_kv_heads, cfg.head_dim))
    seq = _split_of(axes_of(parts[1]))
    if seq.size > 1:
        from repro_torch.models.attention import head_splits

        ks = head_splits(cfg)[1]
        if set(ks.axes) & set(seq.axes):
            raise NotImplementedError(f"the KV heads split over {ks.axes} and the cache "
                                      f"rows over {seq.axes}")
    return seq


def alloc_kv_caches(cfg: ModelConfig, slots: int, max_len: int,
                    device, mesh=None) -> List[dict]:
    """Zero-initialized per-layer views into one K and one V allocation per
    head count (one off a mesh), each of this rank's share of ``max_len``
    rows."""
    kvdt = cfg.quant.kv_cache_dtype(dtype_of(cfg))
    heads = _heads(cfg, mesh)
    caches: List[dict] = [{} for _ in heads]
    for kh in sorted(set(heads)):
        layers = [i for i, h in enumerate(heads) if h == kh]
        shape = (len(layers), slots, max_len // kvseq_split().size, kh, cfg.head_dim)
        k = torch.zeros(shape, dtype=kvdt, device=device)
        v = torch.zeros(shape, dtype=kvdt, device=device)
        for j, i in enumerate(layers):
            caches[i].update(k=k[j], v=v[j])
    return caches


def cache_bytes(cfg: ModelConfig, slots: int, max_len: int, mesh=None) -> int:
    """Cache allocation in bytes (of one rank of ``mesh`` holding ``slots``
    slots and its share of the rows)."""
    kvdt = cfg.quant.kv_cache_dtype(dtype_of(cfg))
    n = sum(_heads(cfg, mesh)) * slots * (max_len // kvseq_split().size) * cfg.head_dim
    return 2 * n * torch.empty((), dtype=kvdt).element_size()


def insert_kv(caches: List[dict], kv: List[dict], slot: int) -> None:
    """Prefill-insert: write a (1, P, KH, hd) prefilled KV block per layer
    into rows [0, P) of ``slot``, in place: of a cache split over its rows,
    the rows of [0, P) this rank's share holds."""
    for c, p in zip(caches, kv):
        for key in ("k", "v"):
            dst = c[key]
            T = dst.shape[1]
            start = kvseq_start(T)
            src = p[key][0, start:start + T]
            dst[slot, :src.shape[0]] = src.to(dst.dtype)
