"""Model assembly for causal decoders, dense and MoE (twin of
``repro.models.lm``).

The reference stacks each group's parameters over a leading layer axis and
runs the group as one ``lax.scan``; the port keeps the layers as a plain
list of per-layer dicts, in execution order, and loops over them.
Parameters:

    {"emb": (padded_vocab, d), "final_norm": {...}, "unemb": (d, padded_vocab),
     "layers": [{"norm1", "attn": {wq, wk, wv, wo}, "norm2",
                 "mlp": {w_gate, w_up, w_down}}, ...]}

with no "unemb" when ``cfg.tie_embeddings`` (the logits contract with
``emb`` transposed). A layer of kind 'moe' holds "moe": {router, experts:
{w_gate, w_up (E, d, f), w_down (E, f, d)}, shared: {...}} in place of
"mlp"; ``cfg.layer_kinds`` names each layer's kind.

Any matrix may be a pre-quantized :class:`~repro_torch.core.wquant.QTensor`.
KV caches are a list with one ``{"k", "v"}`` dict per layer, each
(B, T, KH, hd) in the KV dtype -- the reference's per-layer layout.

Entry points: ``init_lm``, ``lm_forward``, ``lm_loss`` (training: raw
weights, quantized on the fly at the consumer sites, straight-through
gradients), ``lm_prefill``, ``pad_kv_caches``, ``lm_decode_step``.

Training recomputes each block in the backward pass when ``cfg.remat`` is
not "none" (``torch.utils.checkpoint``; the reference's jax.checkpoint of
its scan body): the same values, one block's activations held at a time.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.wquant import (_is_consumer, dequant_tree, is_qleaf,
                                     quantize_leaf)
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models.common import (apply_norm, dense_init, dtype_of,
                                       init_norm)
from repro_torch.models.config import ModelConfig


KINDS = ("attn", "moe")


def _check_kinds(cfg: ModelConfig) -> None:
    bad = set(cfg.layer_kinds) - set(KINDS)
    if bad:
        raise NotImplementedError(
            f"the port runs the layer kinds {KINDS}; {cfg.name!r} has "
            f"{sorted(bad)}")


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, device) -> dict:
    d = cfg.d_model
    p = {"norm1": init_norm(cfg, d, device),
         "attn": A.init_attention(gen, cfg, device),
         "norm2": init_norm(cfg, d, device)}
    if kind == "moe":
        p["moe"] = M.init_moe(gen, cfg, device)
    else:
        p["mlp"] = M.init_mlp(gen, cfg, device)
    return p


def _quantized(cfg: ModelConfig, tree, keys=()):
    """Pre-quantize one freshly initialized subtree (``weight_quant ==
    'int8'``: the serving storage of ``wquant.quantize_lm_weights``)."""
    if cfg.weight_quant != "int8":
        return tree
    if isinstance(tree, dict):
        return {k: _quantized(cfg, v, keys + (k,)) for k, v in tree.items()}
    return quantize_leaf(keys, tree, cfg)


def init_lm(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``. With ``cfg.weight_quant == 'int8'`` each leaf
    is quantized as soon as it is drawn, layer by layer (expert stacks a
    chunk of experts at a time), so the full 16-bit copy of the model never
    exists at once."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = dtype_of(cfg)
    params: Dict[str, Any] = {
        "emb": _quantized(cfg, dense_init(gen, cfg.padded_vocab, cfg.d_model,
                                          dt, scale=0.02), ("emb",)),
        "final_norm": init_norm(cfg, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["unemb"] = _quantized(
            cfg, dense_init(gen, cfg.d_model, cfg.padded_vocab, dt), ("unemb",))
    params["layers"] = [_quantized(cfg, _init_block(gen, cfg, kind, dev), ("layers",))
                        for kind in cfg.layer_kinds]
    return params


def _dequant_layer(cfg: ModelConfig, lp: dict, dtype) -> dict:
    """Dequantize a layer's QTensor leaves, keeping the quant_dot CONSUMER
    leaves (down projections, dense or per expert, stored in the config's
    rotation-quant mode) quantized: the ``QuantDotSpec`` site contracts them
    directly. Expert stacks dequantize a chunk of experts at a time
    (``QTensor.dequant``): one MoE layer's gate and up in f32 at maverick's
    width would be 43 GB."""
    qc = cfg.quant

    def one(p, keys):
        if is_qleaf(p):
            if (qc.rotating and qc.enabled and p.mode == qc.mode
                    and _is_consumer(keys)):
                return p
            return p.dequant(dtype)
        if isinstance(p, dict):
            return {k: one(v, keys + (k,)) for k, v in p.items()}
        return p

    return {k: one(v, (k,)) for k, v in lp.items()}


def _layer_params(cfg: ModelConfig, lp: dict, dtype) -> dict:
    if cfg.weight_quant == "int8":
        return _dequant_layer(cfg, lp, dtype)
    return dequant_tree(lp, dtype)


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows for ``tokens``; a quantized table is dequantized
    after the gather (elementwise, so the same values as dequantizing the
    whole table first)."""
    emb = params["emb"]
    if is_qleaf(emb):
        return (emb.q[tokens].to(torch.float32) * emb.scale[0]).to(dtype_of(cfg))
    return emb[tokens]


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x @ dequant_tree(params["emb"], x.dtype).T
    else:
        logits = x @ dequant_tree(params["unemb"], x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = float("-inf")
    return logits


def _ffn(cfg, kind: str, p, h: torch.Tensor):
    """The block's feed-forward half: (y, aux); aux is the MoE load-
    balancing loss (0 for a dense MLP)."""
    if kind == "moe":
        return M.apply_moe(cfg, p["moe"], h)
    return M.apply_mlp(cfg, p["mlp"], h), 0.0


def _block_prefill(cfg, kind, p, x, positions, want_cache: bool):
    h = apply_norm(cfg, p["norm1"], x)
    cache = None
    if want_cache:
        y, (ck, cv) = A.apply_attention(cfg, p["attn"], h, positions,
                                        return_kv=True)
        cache = {"k": ck, "v": cv}
    else:
        y = A.apply_attention(cfg, p["attn"], h, positions)
    x = x + y
    y, aux = _ffn(cfg, kind, p, apply_norm(cfg, p["norm2"], x))
    return x + y, aux, cache


def lm_forward(cfg: ModelConfig, params, batch, want_cache: bool = False):
    """Full-sequence forward. ``batch["tokens"]``: (B, S) int. Returns
    (logits (B, S, padded_vocab), aux (the MoE layers' load-balancing
    losses summed; 0 for a dense model), caches or None). Each layer's
    dequantized parameters live only while the layer runs."""
    _check_kinds(cfg)
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    caches: Optional[List[dict]] = [] if want_cache else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat != "none" and not want_cache and torch.is_grad_enabled()
    for kind, lp in zip(cfg.layer_kinds, params["layers"]):
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _block_train, cfg, kind, lp, x, positions, use_reentrant=False)
        else:
            x, a, cache = _block_prefill(cfg, kind, _layer_params(cfg, lp, x.dtype),
                                         x, positions, want_cache)
            if want_cache:
                caches.append(cache)
        aux = aux + a
    return _logits(cfg, params, x), aux, caches


def _block_train(cfg, kind, lp, x, positions):
    x, aux, _ = _block_prefill(cfg, kind, _layer_params(cfg, lp, x.dtype), x,
                               positions, False)
    return x, torch.as_tensor(aux, dtype=torch.float32, device=x.device)


def lm_loss(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over the labels >= 0 (f32 log-softmax
    over the padded vocabulary, whose padding columns are -inf), plus 0.01 x
    the MoE load-balancing loss. Returns (loss, {"ce", "aux"})."""
    logits, aux, _ = lm_forward(cfg, params, batch)
    labels = batch["labels"].to(torch.int64)
    lf = logits.to(torch.float32)
    del logits
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    ce = ((lse - ll) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


def lm_prefill(cfg: ModelConfig, params, batch):
    """Forward pass returning (last-position logits, caches)."""
    logits, _, caches = lm_forward(cfg, params, batch, want_cache=True)
    return logits[:, -1:], caches


def pad_kv_caches(cfg: ModelConfig, caches, max_len: int):
    """Grow every layer's K/V cache along seq to ``max_len``."""
    out = []
    for c in caches:
        grown = {}
        for key, t in c.items():
            if t.shape[1] < max_len:
                g = torch.zeros((t.shape[0], max_len) + tuple(t.shape[2:]),
                                dtype=t.dtype, device=t.device)
                g[:, :t.shape[1]] = t
                t = g
            grown[key] = t
        out.append(grown)
    return out


def lm_decode_step(cfg: ModelConfig, params, caches, tokens: torch.Tensor,
                   cache_pos: torch.Tensor):
    """One decode step. tokens: (B, 1) int; cache_pos: () int shared by the
    batch, or (B,) per-slot positions (continuous batching). The caches
    are updated in place and returned with the logits."""
    _check_kinds(cfg)
    x = _embed(cfg, params, tokens)
    B = x.shape[0]
    if cache_pos.ndim == 1:
        positions = cache_pos[:, None].to(torch.int32)
    else:
        positions = cache_pos.reshape(1, 1).expand(B, 1).to(torch.int32)
    for kind, lp, c in zip(cfg.layer_kinds, params["layers"], caches):
        x = _block_decode(cfg, kind, _layer_params(cfg, lp, x.dtype), x, c,
                          cache_pos, positions)
    return _logits(cfg, params, x), caches


def _block_decode(cfg, kind, p, x, c, cache_pos, positions):
    h = apply_norm(cfg, p["norm1"], x)
    y, c["k"], c["v"] = A.decode_attention(cfg, p["attn"], h, c["k"], c["v"],
                                           cache_pos, positions)
    x = x + y
    return x + _ffn(cfg, kind, p, apply_norm(cfg, p["norm2"], x))[0]
