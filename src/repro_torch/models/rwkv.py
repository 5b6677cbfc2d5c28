"""RWKV6 "Finch" (attention-free): the data-dependent-decay time mix and
the squared-ReLU channel mix (twin of ``repro.models.rwkv``).

Time-mix recurrence (per head, state S in R^{K x V}):
    out_t = r_t (S_t + diag(u) k_t^T v_t)
    S_{t+1} = diag(w_t) S_t + k_t^T v_t
with the per-channel decay w_t = exp(-exp(w0 + lora_w(x_t))).

A full sequence runs in one of the reference's two forms, by its rule: the
chunked form (``_tmix_chunked``: C-token chunks, the pairwise decays in
log space) when ``cfg.rwkv_impl == "chunked"`` and the length is a
multiple of ``cfg.rwkv_chunk``, else the recurrence itself (``_tmix_scan``).
The two round differently in f32, so the port takes the form the
reference takes. Decode is the recurrence's step on the carried state.
Both are plain torch ops: neither is a Pallas kernel in the reference.

The channel mix's down projection is the model's one rotation site, a
``QuantDotSpec`` (rwkv6-7b's d_ff = 14336 = 7 x 2048: one grouped K1
launch on the card, then the per-row quantize and contraction).

The ops keep the reference's dtypes: the token-shift interpolation in f32
(bf16 activations against the f32 ``mu_base`` / ``mu``, the bf16
``mix_w2`` in an f32 product), the projections in the model dtype, the
decay, the recurrence and its state in f32, ``u`` in f32. The sigmoid and
SiLU are written out as ``jax.nn``'s lower, every op rounded to the io
dtype.

Tensor parallelism over 'model' (``head_split``; the reference's specs
split the time mix by 'heads' and the channel mix's ``wk`` by 'dff'): the
token-shift interpolation and the decay's LoRA run whole and alike on every
rank; a rank holds the columns of ``wr`` / ``wk`` / ``wv`` / ``wg`` and the
rows of ``u`` of its H / D heads, and the rows of ``wo``. Each mixed input
and the decay pass through ``copy_to_model`` before they are sliced or fed
to a split product, the recurrence, its state (B, H / D, K, K) and the
per-head GroupNorm are local, and ``wo``'s partial products are summed in
f32 over 'model' and rounded once. The channel mix splits ``wk`` by column
and gathers k whole (``gather_from_model``) into the down site, which runs
whole on every rank as the dense MLP's does; ``wr`` stays whole.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.api import QuantDotSpec
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import constrain, model_split
from repro_torch.models.attention import _f32_product
from repro_torch.models.common import dense_init, dtype_of
from repro_torch.models.mlp import _silu, dff_split

_LORA = 32
_MIXES = 5  # r, k, v, w, g
_TMIX_CHUNK = 32


def _dims(cfg):
    K = cfg.rwkv_head_dim
    return cfg.d_model // K, K


def head_split(cfg):
    """This rank's split of the time mix's heads over 'model'."""
    return model_split("heads", _dims(cfg)[0])


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.sigmoid lowers to 1 / (1 + exp(-x)), every op rounded to the
    # io dtype (torch.sigmoid rounds once)
    return 1.0 / (1.0 + torch.exp(-x))


def _randn(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(scale).to(dtype)


def _full(shape, value: float, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.float32, device=device)


def _shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token of every position, zeros before the first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def init_rwkv_tmix(gen: torch.Generator, cfg, device) -> dict:
    d = cfg.d_model
    H, K = _dims(cfg)
    dt = dtype_of(cfg)
    return {
        "mu_base": _full((d,), 0.5, device),
        "mix_w1": dense_init(gen, d, _MIXES * _LORA, dt, scale=0.01, device=device),
        "mix_w2": _randn(gen, (_MIXES, _LORA, d), 0.01, dt, device),
        "mu": _full((_MIXES, d), 0.5, device),
        "w0": _full((d,), -2.0, device),
        "w_lora_a": dense_init(gen, d, 2 * _LORA, dt, scale=0.01, device=device),
        "w_lora_b": dense_init(gen, 2 * _LORA, d, dt, scale=0.01, device=device),
        "u": _randn(gen, (H, K), 0.1, torch.float32, device),
        "wr": dense_init(gen, d, d, dt, device=device),
        "wk": dense_init(gen, d, d, dt, device=device),
        "wv": dense_init(gen, d, d, dt, device=device),
        "wg": dense_init(gen, d, d, dt, device=device),
        "wo": dense_init(gen, d, d, dt, scale=1.0 / math.sqrt(d), device=device),
        "ln_scale": _full((d,), 1.0, device),
        "ln_bias": _full((d,), 0.0, device),
    }


def rwkv_tmix_specs(cfg) -> dict:
    """Logical sharding axes of the time mix's parameters."""
    return {
        "mu_base": (None,), "mix_w1": ("fsdp", None), "mix_w2": (None, None, None),
        "mu": (None, None), "w0": (None,), "w_lora_a": ("fsdp", None),
        "w_lora_b": (None, None), "u": ("heads", None),
        "wr": ("fsdp", "heads"), "wk": ("fsdp", "heads"), "wv": ("fsdp", "heads"),
        "wg": ("fsdp", "heads"), "wo": ("heads", "fsdp"),
        "ln_scale": (None,), "ln_bias": (None,),
    }


def _ddlerp(p, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """The data-dependent token-shift interpolation: the 5 mixed inputs
    (B, S, 5, d), computed in f32 and rounded to the io dtype."""
    dx = x_prev - x                                           # (B, S, d)
    base = x + dx * p["mu_base"]                              # f32
    lora = torch.tanh(base @ p["mix_w1"].to(torch.float32))   # (B, S, 5 * LORA)
    B, S, _ = lora.shape
    lora = lora.reshape(B, S, _MIXES, _LORA)
    dyn = torch.einsum("bsml,mld->bsmd", lora, p["mix_w2"].to(torch.float32))
    mix = p["mu"][None, None] + dyn
    return (x[:, :, None, :] + dx[:, :, None, :] * mix).to(x.dtype)


def _tmix_inputs(cfg, p, x: torch.Tensor, x_prev: torch.Tensor):
    """(r, k, v) (B, S, H, K) in the io dtype, the gate g (B, S, d) and the
    f32 decay w (B, S, H, K) in (0, 1), over this rank's heads (module
    docstring)."""
    K = cfg.rwkv_head_dim
    B, S, _ = x.shape
    hs = head_split(cfg)
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev).unbind(2)
    xr, xk, xv, xg = (C.copy_to_model(t, hs.axes) for t in (xr, xk, xv, xg))
    r = (xr @ p["wr"]).reshape(B, S, -1, K)
    k = (xk @ p["wk"]).reshape(B, S, -1, K)
    v = (xv @ p["wv"]).reshape(B, S, -1, K)
    g = _silu(xg @ p["wg"])
    lw = p["w0"] + (torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]).to(torch.float32)
    lw = C.model_slice(lw, hs)
    w = torch.exp(-torch.exp(lw)).reshape(B, S, -1, K)
    return r, k, v, g, w


def _groupnorm_heads(cfg, p, out: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """Per-head LayerNorm of the f32 wkv output (RWKV's GroupNorm), with
    ``jnp.var``'s population variance, then the f32 affine (this rank's
    heads' channels of it)."""
    mu = out.mean(-1, keepdim=True)
    var = (out - out.mean(-1, keepdim=True)).square().mean(-1, keepdim=True)
    out = (out - mu) * torch.rsqrt(var + 1e-5)
    hs = head_split(cfg)
    return (out.reshape(B, S, -1) * C.model_slice(p["ln_scale"], hs)
            + C.model_slice(p["ln_bias"], hs))


def _tmix_out(cfg, p, out: torch.Tensor, g: torch.Tensor, dtype) -> torch.Tensor:
    """The gated wkv output through ``wo``: whole, or this rank's rows'
    partial product in f32, summed over 'model' and rounded once."""
    y = out.to(dtype) * g
    hs = head_split(cfg)
    if hs.size == 1:
        return y @ p["wo"]
    return C.reduce_from_model(_f32_product(y, p["wo"]), hs.axes).to(dtype)


def _tmix_scan(B, S, H, K, r, k, v, w, u):
    """The recurrence, one token at a time: (out (B, S, H, K), last state
    (B, H, K, K)), in f32."""
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w))
    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], state + u[None, :, :, None] * kv))
        state = state * wf[:, t, :, :, None] + kv
    return torch.stack(outs, dim=1), state


def _tmix_chunked(B, S, H, K, r, k, v, w, u, C: int = _TMIX_CHUNK):
    """The chunked parallel form (GLA-style): the state crosses once per
    C-token chunk, the intra-chunk work is matmul-shaped, and every decay
    ratio is exp(<= 0) of a pairwise difference of log-space cumulative
    decays. Per chunk and head:

        out_t = (r_t (.) ew_t) S + sum_{j<t} [sum_k r_tk k_jk e^(L_(t-1)k - L_jk)] v_j
                + (r_t . u . k_t) v_t
        S'    = S (.) e^(L_(C-1)) + sum_j (k_j (.) e^(L_(C-1) - L_j)) v_j

    The decays are clamped to 1e-30 before the log (a flushed subnormal
    would give -inf and poison the masked differences), and the pairs j >=
    t take -1e30, whose exp is exactly 0."""
    nc = S // C
    rc, kc, vc = (t.to(torch.float32).reshape(B, nc, C, H, K) for t in (r, k, v))
    lw = torch.log(torch.clamp_min(w.to(torch.float32), 1e-30)).reshape(B, nc, C, H, K)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device), diagonal=-1)
    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    outs = []
    for c in range(nc):
        rci, kci, vci, lwi = rc[:, c], kc[:, c], vc[:, c], lw[:, c]   # (B, C, H, K)
        L = torch.cumsum(lwi, dim=1)                   # inclusive within the chunk
        Lx = L - lwi                                   # exclusive: chunk start -> t
        ew = torch.exp(Lx)
        diff = Lx[:, :, None] - L[:, None]             # (B, t, j, H, K), <= 0 where valid
        diff = torch.where(mask[None, :, :, None, None], diff, -1e30)
        A = torch.einsum("btjhk,bjhk->bhtj", rci[:, :, None] * torch.exp(diff), kci)
        out = torch.einsum("bhtj,bjhk->bthk", A, vci)                  # intra-chunk
        out = out + (rci * u * kci).sum(-1)[..., None] * vci            # the bonus
        out = out + torch.einsum("bthk,bhkv->bthv", rci * ew, state)    # carry readout
        kdec = kci * torch.exp(L[:, -1:] - L)          # k_j decayed to the chunk end
        state = state * torch.exp(L[:, -1])[..., None] + torch.einsum(
            "bjhk,bjhv->bhkv", kdec, vci)
        outs.append(out)
    return torch.stack(outs, dim=1).reshape(B, S, H, K), state


def apply_rwkv_tmix(cfg, p, x: torch.Tensor, x_prev=None, *, return_state: bool = False):
    """Full-sequence time mix of x (B, S, d); the form by the reference's
    rule (module docstring). With ``return_state`` also returns (the f32
    state (B, H, K, K) of this rank's heads, the last input (B, d))."""
    B, S, d = x.shape
    K = cfg.rwkv_head_dim
    if x_prev is None:
        x_prev = _shift(x)
    r, k, v, g, w = _tmix_inputs(cfg, p, x, x_prev)
    H = r.shape[2]
    if cfg.rwkv_impl == "chunked" and S % cfg.rwkv_chunk == 0:
        out, state = _tmix_chunked(B, S, H, K, r, k, v, w, p["u"], C=cfg.rwkv_chunk)
    else:
        out, state = _tmix_scan(B, S, H, K, r, k, v, w, p["u"])
    out = _groupnorm_heads(cfg, p, out, B, S)
    y = constrain(_tmix_out(cfg, p, out, g, x.dtype), "batch", "seq", None)
    if return_state:    # the last input copied: the cache holds no view of x
        return y, (state, x[:, -1, :].clone())
    return y


def decode_rwkv_tmix(cfg, p, x: torch.Tensor, state):
    """One token. x: (B, 1, d); state = (S (B, H, K, K) f32, x_prev (B, d)).
    Returns (y, (new S, x's last row))."""
    B = x.shape[0]
    S0, xp = state
    r, k, v, g, w = _tmix_inputs(cfg, p, x, xp[:, None, :])
    rt, kt, vt, wt = (t[:, 0].to(torch.float32) for t in (r, k, v, w))
    kv = kt[..., :, None] * vt[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", rt, S0 + p["u"][None, :, :, None] * kv)
    S1 = S0 * wt[..., None] + kv
    out = _groupnorm_heads(cfg, p, out.reshape(B, 1, *out.shape[1:]), B, 1)
    return _tmix_out(cfg, p, out, g, x.dtype), (S1, x[:, -1, :])


# ------------------------------------------------------------- channel mix
def init_rwkv_cmix(gen: torch.Generator, cfg, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    return {
        "mu_r": _full((d,), 0.5, device),
        "mu_k": _full((d,), 0.5, device),
        "wr": dense_init(gen, d, d, dt, device=device),
        "wk": dense_init(gen, d, f, dt, device=device),
        "wv": dense_init(gen, f, d, dt, scale=1.0 / math.sqrt(f), device=device),
    }


def rwkv_cmix_specs(cfg) -> dict:
    """Logical sharding axes of the channel mix's parameters."""
    return {"mu_r": (None,), "mu_k": (None,),
            "wr": ("fsdp", None), "wk": ("fsdp", "dff"), "wv": ("dff", "fsdp")}


def apply_rwkv_cmix(cfg, p, x: torch.Tensor, x_prev=None, *, return_state: bool = False):
    """sigmoid(receptance) * (relu(k)^2 through the down-projection site):
    the site rotates, quantizes and contracts (``QuantDotSpec``); with
    ``return_state`` also returns the last input (B, d). Under a split of
    'dff' over 'model' k is this rank's columns, gathered whole into the
    site."""
    if x_prev is None:
        x_prev = _shift(x)
    dx = x_prev - x
    xr = (x + dx * p["mu_r"]).to(x.dtype)
    xk = (x + dx * p["mu_k"]).to(x.dtype)
    r = _sigmoid(xr @ p["wr"])
    axes = dff_split(cfg).axes
    k = torch.relu(C.copy_to_model(xk, axes) @ p["wk"]).square()
    k = constrain(C.gather_from_model(k, axes, -1), "batch", "seq", "dff")
    spec = QuantDotSpec.for_config(k.shape[-1], cfg.quant, weight_axes=("dff", "fsdp"))
    y = constrain(r * spec.bind(p["wv"])(k), "batch", "seq", None)
    if return_state:
        return y, x[:, -1, :].clone()
    return y


def decode_rwkv_cmix(cfg, p, x: torch.Tensor, x_prev: torch.Tensor):
    """One token: (y, x's last row)."""
    return apply_rwkv_cmix(cfg, p, x, x_prev[:, None, :]), x[:, -1, :]
