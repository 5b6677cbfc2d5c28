"""GQA causal attention, optionally sliding-window and with QKV biases,
with the QuaRot rotation hooks (twin of ``repro.models.attention``,
self-attention only).

The paper's deployment (section 4.2): FP8 attention where Q and K are
Hadamard-rotated per head before quantization -- the rotation cancels in
QK^T (H H^T = I) while crushing per-head outliers; V's rotation is fused
offline into (W_v, W_o). With rotation and KV quantization on, each of the
Q and K sites is one K2 launch on the card (``RotationSpec``).

Layouts follow the reference at the public functions: activations
(B, S, d), heads (B, S, H, hd), KV caches (B, T, KH, hd).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.api import RotationSpec
from repro_torch.kernels.registry import cast_to, f32_reciprocal
from repro_torch.models.common import (apply_rope_angles, dense_init, dtype_of,
                                      rope_freqs)


def init_attention(gen: torch.Generator, cfg, device) -> dict:
    """The projections, plus zero biases ``bq`` / ``bk`` / ``bv`` in the
    model dtype when ``cfg.qkv_bias``."""
    d, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    p = {
        "wq": dense_init(gen, d, H * hd, dt, device=device),
        "wk": dense_init(gen, d, KH * hd, dt, device=device),
        "wv": dense_init(gen, d, KH * hd, dt, device=device),
        "wo": dense_init(gen, H * hd, d, dt, scale=1.0 / math.sqrt(H * hd),
                         device=device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KH * hd), ("bv", KH * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=device)
    return p


def _positions_angles(cfg, positions: torch.Tensor) -> torch.Tensor:
    """positions: (B, S) int -> (B, S, half) f32 RoPE angles."""
    freqs = rope_freqs(cfg.head_dim, cfg.rope_theta, device=positions.device)
    return positions[..., None].to(torch.float32) * freqs


def _project_qkv(cfg, p, x):
    B, S, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:   # added to the 16-bit products, as the reference does
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q.reshape(B, S, H, hd), k.reshape(B, S, KH, hd), v.reshape(B, S, KH, hd)


def _qk_spec(cfg, hd: int) -> RotationSpec:
    """The per-head Q/K site: rotate when the config rotates, fake-quantize
    when the KV cache quantizes."""
    return RotationSpec.for_config(hd, cfg.quant)


def _v_spec(cfg, hd: int) -> RotationSpec:
    """The V site: quantize only (its rotation is fused offline)."""
    return RotationSpec.for_config(hd, cfg.quant, rotate=False)


def _rotate_quant_qk(cfg, q, k):
    spec = _qk_spec(cfg, q.shape[-1])
    return spec(q), spec(k)


def _scores(q, k):
    """f32 attention scores (B, KH, G, S, T) of q (B, S, KH, G, hd) and k
    (B, T, KH, hd): exact products of the operands, f32 sums, as the
    reference's ``preferred_element_type=f32`` einsum. On the card a 16-bit
    pair goes into one batched product with an f32 result
    (``torch.bmm(..., out_dtype=float32)``), so serving makes no f32 copy
    of the KV cache (the linter's dtype-flow rule); the CPU has no bf16 x
    bf16 -> f32 product, and that product has no derivative, so the CPU and
    a pass that records gradients (training) widen both sides first."""
    B, S, KH, G, hd = q.shape
    T = k.shape[1]
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad)
    if q.device.type == "cuda" and q.dtype in (torch.bfloat16, torch.float16) \
            and k.dtype == q.dtype and not grad:
        a = q.permute(0, 2, 3, 1, 4).reshape(B * KH, G * S, hd)
        b = k.permute(0, 2, 3, 1).reshape(B * KH, hd, T)
        return torch.bmm(a, b, out_dtype=torch.float32).reshape(B, KH, G, S, T)
    return torch.einsum("bskgd,btkd->bkgst", q.to(torch.float32), k.to(torch.float32))


def _sdpa(cfg, q, k, v, mask):
    """q: (B,S,H,hd), k/v: (B,T,KH,hd), mask: broadcastable (B,1,S,T)
    bool. Written out as the reference does: f32 scores (exact products of
    the 16-bit operands, f32 sums; ``_scores``), mask, f32 softmax, then
    the weights in the value dtype."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    scores = _scores(q.reshape(B, S, KH, G, hd), k)
    # the reference divides by sqrt(hd); XLA compiles that to a product
    # with the f32 reciprocal
    scores = scores * f32_reciprocal(math.sqrt(hd))
    neg = torch.finfo(torch.float32).min
    scores = torch.where(mask[:, :, None] if mask.ndim == 4 else mask,
                         scores, torch.full_like(scores, neg))
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return ctx.reshape(B, S, H * hd)


def _causal_mask(cfg, S: int, T: int, device) -> torch.Tensor:
    """Batch-independent (1, 1, S, T) causal mask; with a sliding window W
    a query sees the keys k with q - W < k <= q."""
    q = torch.arange(S, dtype=torch.int32, device=device)[:, None]
    k = torch.arange(T, dtype=torch.int32, device=device)[None, :]
    m = k <= q
    if cfg.sliding_window:
        m &= k > q - cfg.sliding_window
    return m[None, None]


def _decode_mask(cfg, cache_pos: torch.Tensor, T: int, device) -> torch.Tensor:
    """The decode step's mask over the T cache rows: (B, 1, 1, T) for
    per-slot positions (B,), (1, 1, 1, T) for a shared scalar position;
    the same window rule as ``_causal_mask``."""
    kpos = torch.arange(T, dtype=torch.int32, device=device)
    pos = cache_pos[:, None] if cache_pos.ndim == 1 else cache_pos.reshape(1, 1)
    m = kpos[None] <= pos
    if cfg.sliding_window:
        m &= kpos[None] > pos - cfg.sliding_window
    return m[:, None, None]


def apply_attention(cfg, p, x: torch.Tensor, positions: torch.Tensor, *,
                    return_kv: bool = False):
    """Full-sequence causal attention (prefill). With ``return_kv`` also
    returns the (B, S, KH, hd) K/V rows in the KV-cache dtype."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    ang = _positions_angles(cfg, positions)
    q = apply_rope_angles(q, ang)
    k = apply_rope_angles(k, ang)
    q, k = _rotate_quant_qk(cfg, q, k)
    v = _v_spec(cfg, v.shape[-1])(v)
    ctx = _sdpa(cfg, q, k, v, _causal_mask(cfg, S, S, x.device))
    y = ctx @ p["wo"]
    if return_kv:
        kvdt = cfg.quant.kv_cache_dtype(x.dtype)
        return y, (cast_to(k, kvdt), cast_to(v, kvdt))
    return y


def decode_attention(cfg, p, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_pos: torch.Tensor,
                     positions: torch.Tensor):
    """Single-token decode. x: (B, 1, d); cache_k/v: (B, T, KH, hd) in the
    KV dtype; cache_pos: () int shared by the batch, or (B,) per-slot
    positions (continuous batching: each slot writes and attends at its
    own depth). The caches are updated IN PLACE (row ``pos`` of each slot)
    and returned, where the reference returns updated copies."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode_attention takes one token, got S={S}")
    q, k, v = _project_qkv(cfg, p, x)
    ang = _positions_angles(cfg, positions)
    q = apply_rope_angles(q, ang)
    k = apply_rope_angles(k, ang)
    q, k = _rotate_quant_qk(cfg, q, k)
    v = _v_spec(cfg, v.shape[-1])(v)
    per_slot = cache_pos.ndim == 1
    if per_slot:
        rows = torch.arange(B, device=x.device)
        cache_k[rows, cache_pos] = cast_to(k[:, 0], cache_k.dtype)
        cache_v[rows, cache_pos] = cast_to(v[:, 0], cache_v.dtype)
    else:
        cache_k[:, cache_pos] = cast_to(k[:, 0], cache_k.dtype)
        cache_v[:, cache_pos] = cast_to(v[:, 0], cache_v.dtype)
    mask = _decode_mask(cfg, cache_pos, cache_k.shape[1], x.device)
    ctx = _sdpa(cfg, q, cache_k.to(q.dtype), cache_v.to(q.dtype), mask)
    return ctx @ p["wo"], cache_k, cache_v
