"""GQA attention -- causal (optionally sliding-window), non-causal (an
encoder's) and cross attention (decoder to encoder), with QKV biases and
RoPE or M-RoPE -- with the QuaRot rotation hooks (twin of
``repro.models.attention``).

The paper's deployment (section 4.2): FP8 attention where Q and K are
Hadamard-rotated per head before quantization -- the rotation cancels in
QK^T (H H^T = I) while crushing per-head outliers; V's rotation is fused
offline into (W_v, W_o). With rotation and KV quantization on, each of the
Q and K sites is one K2 launch on the card (``RotationSpec``), and so is
the cross-attention K site (``cross_kv``), once per prefill.

Layouts follow the reference at the public functions: activations
(B, S, d), heads (B, S, H, hd), KV caches (B, T, KH, hd).

Tensor parallelism over 'model' (``head_splits``; the reference names the
Q / K / V heads 'heads' / 'kv' and GSPMD splits them): a rank holds the
columns of ``wq`` / ``wk`` / ``wv`` (and their biases) of its H / D query
heads and KH / D KV heads, and the rows of ``wo`` of its query heads. The
heads, RoPE, the Q / K sites (per-head rows: K2 runs on the rank's rows
alone), the GQA grouping and the masks are local; the output projection is
this rank's partial sum, taken in f32 and completed by an all-reduce
(``reduce_from_model``), then rounded once to the model dtype. The KV
caches hold the rank's KV heads. Where 'kv' does not divide but 'heads'
does, K / V stay whole on every rank (cache included) and each rank reads
the KV heads its query heads map to.

The KV cache split over its sequence ('kvseq', the serving preset
``launch.dryrun.decode_rules``; ``sharding.kvseq_split``): a decode step's
caches hold this rank's contiguous share of the T rows. The new row goes
to the rank that owns row ``pos`` (a position past the cache to the last
row, which the last rank owns). Each rank computes the partial softmax of
its rows with their global positions in the mask (so a sliding window
stays right): the scores' row max and exp-sum all-reduced first, then the
globally normalised weights rounded to the value dtype as ``_sdpa`` rounds
them, their f32 product with the rank's V rows summed over the ranks and
rounded once (``_split_sdpa``). Where the query heads split over axes the cache rows
split over too, a rank lacks the queries of heads it holds rows for: the
(B, 1, H_rank, hd) queries are all-gathered over the heads' axes first (a
few KB a step), every head's partials computed and merged, and the rank's
own heads taken before the output projection. Prefill stays local.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.api import RotationSpec
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (WHOLE, constrain, kvseq_row, kvseq_split,
                                              kvseq_start, model_split)
from repro_torch.kernels.registry import cast_to, f32_reciprocal
from repro_torch.models.common import (apply_rope_angles, dense_init, dtype_of,
                                      mrope_angles, rope_freqs)


def init_attention(gen: torch.Generator, cfg, device) -> dict:
    """The projections, plus zero biases ``bq`` / ``bk`` / ``bv`` in the
    model dtype when ``cfg.qkv_bias``. Cross attention has the same leaves
    (its K / V project the encoder output)."""
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
    """positions: (B, S) int, or (3, B, S) under M-RoPE -> (B, S, half) f32
    RoPE angles."""
    if cfg.mrope:
        return mrope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)
    freqs = rope_freqs(cfg.head_dim, cfg.rope_theta, device=positions.device)
    return positions[..., None].to(torch.float32) * freqs


def head_splits(cfg):
    """(this rank's split of the query heads, of the KV heads) over
    'model' (``sharding.model_split``): the KV heads split only where the
    query heads split over the same axes."""
    hs = model_split("heads", cfg.num_heads)
    ks = model_split("kv", cfg.num_kv_heads) if hs.size > 1 else WHOLE
    return hs, (ks if ks.axes == hs.axes else WHOLE)


def local_kv_heads(cfg) -> int:
    """The KV heads this rank computes and caches."""
    return cfg.num_kv_heads // head_splits(cfg)[1].size


def _kv_for_heads(cfg, k, v):
    """K / V (B, T, KH_rank, hd) for this rank's query heads: themselves,
    or, where the KV heads stay whole while the query heads split, the KV
    head of each of the rank's query heads (one per query head). Whole K /
    V are computed alike on every rank and read in part by each, so their
    gradient is summed over the query heads' ranks (``copy_to_model``)."""
    hs, ks = head_splits(cfg)
    if hs.size == 1 or ks.size > 1:
        return k, v
    h_rank = cfg.num_heads // hs.size
    group = cfg.num_heads // cfg.num_kv_heads
    idx = torch.arange(hs.index * h_rank, (hs.index + 1) * h_rank, device=k.device) // group
    return tuple(C.copy_to_model(t, hs.axes).index_select(2, idx) for t in (k, v))


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 sums and an f32 result: on the card a 16-bit pair
    goes into one product with an f32 output (as ``_scores``); the CPU and
    a pass that records gradients widen both sides (exact)."""
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.device.type == "cuda" and a.dtype in (torch.bfloat16, torch.float16) \
            and b.dtype == a.dtype and not grad:
        a2 = a.reshape(1, -1, a.shape[-1])
        out = torch.bmm(a2, b[None], out_dtype=torch.float32)
        return out.reshape(a.shape[:-1] + (b.shape[-1],))
    return a.to(torch.float32) @ b.to(torch.float32)


def _out_proj(cfg, ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """ctx (B, S, H_rank * hd) through ``wo``: whole, or this rank's rows'
    partial sum in f32, summed over the query heads' ranks and rounded once
    to ctx's dtype."""
    hs = head_splits(cfg)[0]
    if hs.size == 1:
        return ctx @ wo
    return C.reduce_from_model(_f32_product(ctx, wo), hs.axes).to(ctx.dtype)


def _project(cfg, p, x, names, split):
    """x (B, S, d) through the projections ``names`` (with their biases
    under ``cfg.qkv_bias``, added to the 16-bit products as the reference
    does), each as (B, S, heads, hd) over this rank's heads."""
    B, S, _ = x.shape
    x = C.copy_to_model(x, split.axes)
    out = []
    for name in names:
        y = x @ p["w" + name]
        if cfg.qkv_bias:
            y = y + p["b" + name]
        out.append(y.reshape(B, S, -1, cfg.head_dim))
    return out


def _project_qkv(cfg, p, x):
    hs, ks = head_splits(cfg)
    if ks.size == hs.size:
        q, k, v = _project(cfg, p, x, "qkv", hs)
    else:                       # K / V whole on every rank (``_kv_for_heads``)
        (q,), (k, v) = _project(cfg, p, x, "q", hs), _project(cfg, p, x, "kv", ks)
    return (constrain(q, "batch", "seq", "heads", None),
            constrain(k, "batch", "seq", "kv", None),
            constrain(v, "batch", "seq", "kv", None))


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


def _decode_mask(cfg, cache_pos: torch.Tensor, T: int, device, start: int = 0) -> torch.Tensor:
    """The decode step's mask over the T cache rows from global row
    ``start``: (B, 1, 1, T) for per-slot positions (B,), (1, 1, 1, T) for a
    shared scalar position; the same window rule as ``_causal_mask``."""
    kpos = torch.arange(start, start + T, dtype=torch.int32, device=device)
    pos = cache_pos[:, None] if cache_pos.ndim == 1 else cache_pos.reshape(1, 1)
    m = kpos[None] <= pos
    if cfg.sliding_window:
        m &= kpos[None] > pos - cfg.sliding_window
    return m[:, None, None]


def _full_mask(device) -> torch.Tensor:
    """The mask of attention that sees every key (an encoder's, cross
    attention): (1, 1, 1, 1) True, as the reference writes it."""
    return torch.ones((1, 1, 1, 1), dtype=torch.bool, device=device)


def attention_specs(cfg, cross: bool = False) -> dict:
    """Logical sharding axes of the attention's parameters (``cross``: the
    cross attention's, the same leaves)."""
    p = {"wq": ("fsdp", "heads"), "wk": ("fsdp", "kv"), "wv": ("fsdp", "kv"),
         "wo": ("heads", "fsdp")}
    if cfg.qkv_bias:
        p.update({"bq": ("heads",), "bk": ("kv",), "bv": ("kv",)})
    return p


def apply_attention(cfg, p, x: torch.Tensor, positions: torch.Tensor, *,
                    causal: bool = True, return_kv: bool = False):
    """Full-sequence attention (prefill; ``causal=False``: an encoder's,
    every query seeing every key). With ``return_kv`` also returns the
    (B, S, KH, hd) K/V rows in the KV-cache dtype."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    ang = _positions_angles(cfg, positions)
    q = apply_rope_angles(q, ang)
    k = apply_rope_angles(k, ang)
    q, k = _rotate_quant_qk(cfg, q, k)
    v = _v_spec(cfg, v.shape[-1])(v)
    mask = _causal_mask(cfg, S, S, x.device) if causal else _full_mask(x.device)
    ctx = _sdpa(cfg, q, *_kv_for_heads(cfg, k, v), mask)
    y = constrain(_out_proj(cfg, ctx, p["wo"]), "batch", "seq", None)
    if return_kv:
        kvdt = cfg.quant.kv_cache_dtype(x.dtype)
        return y, (cast_to(k, kvdt), cast_to(v, kvdt))
    return y


def apply_cross_attention(cfg, p, x: torch.Tensor, kv) -> torch.Tensor:
    """Decoder -> encoder cross attention of x (B, S, d) on the precomputed
    ``kv`` (``cross_kv``: (B, T, KH, hd) each), every query seeing every
    encoder frame.

    Q is neither rotated nor quantized here, while ``cross_kv`` rotates K:
    with rotation on, the scores are q . (H k), not q . k. This is the
    reference's own code (``repro.models.attention.apply_cross_attention``),
    carried as it is because the port is held to it; ROADMAP.md, "Reference
    health", records the fault."""
    q, = _project(cfg, p, x, "q", head_splits(cfg)[0])
    ctx = _sdpa(cfg, q, *_kv_for_heads(cfg, *kv), _full_mask(x.device))
    return constrain(_out_proj(cfg, ctx, p["wo"]), "batch", "seq", None)


def cross_kv(cfg, p, enc_out: torch.Tensor):
    """The cross-attention K / V of the encoder output (B, T, d), computed
    once per prefill and kept in the decoder's cache: K through the Q / K
    site (rotated and fake-quantized: one K2 launch on the card), V through
    the V site (quantized only), both in the model dtype."""
    hd = cfg.head_dim
    k, v = _project(cfg, p, enc_out, "kv", head_splits(cfg)[1])
    # K rotates here but Q never does (apply_cross_attention): the
    # reference's fault, carried as it is (ROADMAP.md, "Reference health")
    return _qk_spec(cfg, hd)(k), _v_spec(cfg, hd)(v)


def decode_attention(cfg, p, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_pos: torch.Tensor,
                     positions: torch.Tensor):
    """Single-token decode. x: (B, 1, d); cache_k/v: (B, T, KH, hd) in the
    KV dtype; cache_pos: () int shared by the batch, or (B,) per-slot
    positions (continuous batching: each slot writes and attends at its
    own depth). The caches are updated IN PLACE (row ``pos`` of each slot)
    and returned, where the reference returns updated copies. A position
    past the cache writes its row onto the cache's last row, as the
    reference's ``dynamic_update_slice`` clamps its start; the mask still
    reads the position itself."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode_attention takes one token, got S={S}")
    q, k, v = _project_qkv(cfg, p, x)
    ang = _positions_angles(cfg, positions)
    q = apply_rope_angles(q, ang)
    k = apply_rope_angles(k, ang)
    q, k = _rotate_quant_qk(cfg, q, k)
    v = _v_spec(cfg, v.shape[-1])(v)
    seq = kvseq_split()
    if seq.size > 1:
        return _decode_attention_kvseq(cfg, p, q, k, v, cache_k, cache_v, cache_pos, seq)
    row = cache_pos.clamp(0, cache_k.shape[1] - 1)
    if cache_pos.ndim == 1:
        slots = torch.arange(B, device=x.device)
        cache_k[slots, row] = cast_to(k[:, 0], cache_k.dtype)
        cache_v[slots, row] = cast_to(v[:, 0], cache_v.dtype)
    else:
        _write_row(cache_k, k, row)
        _write_row(cache_v, v, row)
    mask = _decode_mask(cfg, cache_pos, cache_k.shape[1], x.device)
    ctx = _sdpa(cfg, q, *_kv_for_heads(cfg, cache_k.to(q.dtype), cache_v.to(q.dtype)),
                mask)
    return (constrain(_out_proj(cfg, ctx, p["wo"]), "batch", "seq", None),
            cache_k, cache_v)


def _bits(cache: torch.Tensor) -> torch.dtype:
    """An integer dtype of the cache's element width: rows are written as
    bits, since not every device copies or selects the fp8 dtypes."""
    return {1: torch.uint8, 2: torch.int16, 4: torch.int32}[cache.element_size()]


def _write_row(cache: torch.Tensor, new: torch.Tensor, row: torch.Tensor) -> None:
    """Write ``new`` (B, 1, KH, hd) at row ``row`` (a 0-d tensor) of every
    slot: an indexed copy, which reads the row on the device (indexing with
    the 0-d tensor itself would read it on the host, a sync a step)."""
    cache.view(_bits(cache)).index_copy_(1, row.reshape(1).to(torch.int64),
                                         cast_to(new, cache.dtype).view(_bits(cache)))


def _write_owned_row(cache: torch.Tensor, new: torch.Tensor, cache_pos: torch.Tensor) -> None:
    """Write ``new`` (B, KH, hd) at global row ``cache_pos`` of every slot
    whose row this rank's share of the rows holds (``sharding.kvseq_row``);
    the other slots' rows are rewritten with their own values (a select, no
    host sync)."""
    B, T = cache.shape[0], cache.shape[1]
    pos = cache_pos if cache_pos.ndim == 1 else cache_pos.reshape(1).expand(B)
    row, mine = kvseq_row(pos, T)
    slots = torch.arange(B, device=cache.device)
    bits = cache.view(_bits(cache))
    bits[slots, row] = torch.where(mine[:, None, None],
                                   cast_to(new, cache.dtype).view(bits.dtype), bits[slots, row])


def _weighted_values(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """f32 (B, KH, G, S, hd) of the weights w (B, KH, G, S, T) times v (B,
    T, KH, hd): exact products, f32 sums. On the card a 16-bit pair goes
    into one batched product with an f32 result, as in ``_scores`` (no f32
    copy of the cache); the CPU widens both sides."""
    B, KH, G, S, T = w.shape
    hd = v.shape[-1]
    if w.device.type == "cuda" and w.dtype in (torch.bfloat16, torch.float16) \
            and v.dtype == w.dtype:
        a = w.reshape(B * KH, G * S, T)
        b = v.permute(0, 2, 1, 3).reshape(B * KH, T, hd)
        return torch.bmm(a, b, out_dtype=torch.float32).reshape(B, KH, G, S, hd)
    return torch.einsum("bkgst,btkd->bkgsd", w.to(torch.float32), v.to(torch.float32))


def _split_sdpa(q, k, v, mask, axes) -> torch.Tensor:
    """``_sdpa`` of the queries q (B, S, H, hd) over the KV rows k / v (B,
    T, KH, hd) this rank holds of a cache split over ``axes`` (mask (B or
    1, 1, 1, T) at their global positions): the f32 scores' row max and
    then their exp-sum all-reduced (tiny (B, KH, G, S, 1) tensors), the
    weights divided by the global sum and rounded to the value dtype as
    ``_sdpa`` rounds them, their product with this rank's V rows in f32,
    summed over the ranks and rounded once. A rank whose rows are all
    masked reads the f32 minimum, which the common maximum sends to 0."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    scores = _scores(q.reshape(B, S, KH, H // KH, hd), k) * f32_reciprocal(math.sqrt(hd))
    neg = torch.finfo(torch.float32).min
    scores = torch.where(mask[:, :, None], scores, torch.full_like(scores, neg))
    mx = C.kvseq_all_reduce(scores.amax(-1, keepdim=True), axes, "max")
    e = torch.exp(scores - mx)
    w = e / C.kvseq_all_reduce(e.sum(-1, keepdim=True), axes)
    ctx = C.kvseq_all_reduce(_weighted_values(w.to(v.dtype), v), axes)
    return ctx.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd).to(v.dtype)


def _decode_attention_kvseq(cfg, p, q, k, v, cache_k, cache_v, cache_pos, seq):
    """``decode_attention`` with the caches' rows split over ``seq`` (module
    docstring): the owned write, the attention over this rank's rows
    merged over the ranks, then the rank's heads through the output
    projection."""
    B, S, H_rank, hd = q.shape
    T = cache_k.shape[1]
    _write_owned_row(cache_k, k[:, 0], cache_pos)
    _write_owned_row(cache_v, v[:, 0], cache_pos)
    hs, ks = head_splits(cfg)
    gather = bool(set(hs.axes) & set(seq.axes))
    if gather and ks.size > 1:
        raise NotImplementedError(f"the KV heads split over {ks.axes} beside cache rows "
                                  f"split over {seq.axes}")
    mask = _decode_mask(cfg, cache_pos, T, q.device, kvseq_start(T))
    ck, cv = cache_k.to(q.dtype), cache_v.to(q.dtype)
    if gather:
        q = C.gather_from_model(q, hs.axes, 2)        # every head's queries
    else:
        ck, cv = _kv_for_heads(cfg, ck, cv)
    ctx = _split_sdpa(q, ck, cv, mask, seq.axes)
    if gather:
        ctx = ctx.narrow(-1, hs.index * H_rank * hd, H_rank * hd)
    return (constrain(_out_proj(cfg, ctx, p["wo"]), "batch", "seq", None),
            cache_k, cache_v)
