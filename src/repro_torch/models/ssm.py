"""Mamba2 (SSD) mixer of the zamba2 hybrid architecture (twin of
``repro.models.ssm``).

A full sequence runs the chunked SSD algorithm (chunks of 128 tokens, or
the whole sequence when it is shorter): a scalar decay per head makes the
pairwise intra-chunk decay exact and stable in log space, and a carry
across chunks hands each chunk its starting state. Decode is the exact
recurrence on the (P, N) state, one token at a time. Both are plain torch
ops (the reference's are plain jnp, no Pallas kernel), and a Mamba layer
has no rotation site.

Recurrence (per head, state S in R^{P x N}):
    S_t = exp(dt_t * A) * S_{t-1} + dt_t * x_t (x) B_t
    y_t = S_t C_t + D * x_t

The causal depthwise conv (4 taps, then SiLU) rounds as the reference's
two forms do: over a sequence a sum of 16-bit products in tap order, every
product and sum rounded to the io dtype; at decode a product over the taps
accumulated in f32 and rounded once (the reference's einsum). The
projections are in the model dtype; the SSD, its state, ``A_log``, ``D``,
``dt_bias`` and the gated RMSNorm in f32; the conv states in the model
dtype. ``jax.nn.softplus`` (``logaddexp(x, 0)``: no threshold, unlike
torch's) is written out op by op. The intra-chunk decays are masked in
log space, so the gradient stays finite where the reference's is NaN
(ROADMAP.md, "Carried reference faults and known divergences").

Tensor parallelism over 'model' (``head_split``: the SSD's H = d_inner / P
heads; the reference's specs split ``w_zx``, ``conv_x``, ``norm`` and
``w_out`` by 'dff' and the SSD by 'heads'): a rank computes its H / D
heads, whole heads of d_inner columns. It holds its heads' columns of
``conv_x`` and ``norm`` and rows of ``w_out``; its state is those heads'
``ssm`` (B, H / D, P, N) and ``conv_x`` (B, W-1, d_inner / D), while
``conv_bc`` and ``w_bcdt`` stay whole. ``w_zx`` rests as the reference lays
it out, its concatenated (z | x) columns split contiguously, which at D = 2
puts all of z on one rank and all of x on the other: the layer gathers it
whole and takes this rank's heads' columns of both halves
(``_zx_columns``), whose gradient ``copy_to_model`` sums over 'model', so
that each rank's shard gets the whole gradient of its own columns. B, C
and dt (every head's, computed alike on every rank) pass through
``copy_to_model`` (B and C after their conv); dt, ``A_log``, ``D`` and
``dt_bias`` are then cut to this rank's heads. The gated RMSNorm means
over the whole d_inner: each rank's sum of squares is summed over 'model'
by ``sum_for_split``, whose backward sums too (what follows is split, not
replicated). ``w_out``'s partial products are summed in f32 over 'model'
and rounded once.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import constrain, model_split
from repro_torch.models.attention import _f32_product
from repro_torch.models.common import dense_init, dtype_of
from repro_torch.models.mlp import _silu

_CONV_W = 4
_CHUNK = 128


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    return d_inner, d_inner // P, P, cfg.ssm_state


def head_split(cfg):
    """This rank's split of the SSD's heads over 'model'."""
    return model_split("heads", _dims(cfg)[1])


def _head_params(cfg, p):
    """(A_log, D, dt_bias) of this rank's heads (module docstring)."""
    hs = head_split(cfg)
    return tuple(C.model_slice(p[k], hs) for k in ("A_log", "D", "dt_bias"))


def _zx_columns(cfg, w: torch.Tensor) -> torch.Tensor:
    """``w_zx`` (d, 2 d_inner), gathered whole, as this rank's heads'
    columns of z followed by theirs of x (module docstring)."""
    hs = head_split(cfg)
    if hs.size == 1:
        return w
    d_inner = _dims(cfg)[0]
    n = d_inner // hs.size
    w = C.copy_to_model(w, hs.axes)
    lo = hs.index * n
    return torch.cat([w[:, lo:lo + n], w[:, d_inner + lo:d_inner + lo + n]], dim=1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jnp.logaddexp(x, 0): max(x, 0) + log1p(exp(-|x - 0|))
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def init_mamba(gen: torch.Generator, cfg, device) -> dict:
    d = cfg.d_model
    d_inner, H, P, N = _dims(cfg)
    dt = dtype_of(cfg)

    def conv(width):
        return torch.randn((_CONV_W, width), generator=gen, dtype=torch.float32,
                           device=device).mul_(0.2).to(dt)

    def full(value):
        return torch.full((H,), value, dtype=torch.float32, device=device)

    return {
        "w_zx": dense_init(gen, d, 2 * d_inner, dt, device=device),
        "w_bcdt": dense_init(gen, d, 2 * N + H, dt, device=device),
        "conv_x": conv(d_inner),
        "conv_bc": conv(2 * N),
        "A_log": full(0.0),
        "D": full(1.0),
        "dt_bias": full(math.log(math.e - 1)),      # softplus^-1(1)
        "norm": torch.ones((d_inner,), dtype=torch.float32, device=device),
        "w_out": dense_init(gen, d_inner, d, dt, scale=1.0 / math.sqrt(d_inner),
                            device=device),
    }


def _split_proj(cfg, p, x: torch.Tensor):
    """(z, x, B, C, dt): z, x and dt of this rank's heads, B and C (before
    their conv) whole."""
    N = _dims(cfg)[3]
    hs = head_split(cfg)
    zx = C.copy_to_model(x, hs.axes) @ _zx_columns(cfg, p["w_zx"])
    bcdt = x @ p["w_bcdt"]
    di = zx.shape[-1] // 2
    return (zx[..., :di], zx[..., di:], bcdt[..., :N], bcdt[..., N:2 * N],
            C.model_slice(bcdt[..., 2 * N:], head_split(cfg)))


def _causal_depthwise(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C), w: (W, C) -> the causal depthwise conv, then SiLU: the
    reference's sum of 16-bit products in tap order, every product and sum
    rounded to the io dtype (not ``F.conv1d``, which accumulates wider)."""
    W, S = w.shape[0], x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], W - 1, x.shape[2])), x], dim=1)
    y = xp[:, :S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i]
    return _silu(y)


def _conv_step(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The decode conv over (B, W, C) ``window`` (the state, then the new
    token): the reference's einsum, each tap's product summed in f32 in tap
    order and rounded once to the io dtype, then SiLU."""
    wf = w.to(torch.float32)
    acc = window[:, 0].to(torch.float32) * wf[0]
    for i in range(1, w.shape[0]):
        acc = acc + window[:, i].to(torch.float32) * wf[i]
    return _silu(acc.to(window.dtype))


class MambaState(NamedTuple):
    ssm: torch.Tensor       # (B, H, P, N) f32
    conv_x: torch.Tensor    # (B, W-1, d_inner)
    conv_bc: torch.Tensor   # (B, W-1, 2N)


def mamba_specs(cfg) -> dict:
    """Logical sharding axes of the Mamba2 block's parameters."""
    return {"w_zx": ("fsdp", "dff"), "w_bcdt": ("fsdp", None),
            "conv_x": (None, "dff"), "conv_bc": (None, None), "A_log": (None,),
            "D": (None,), "dt_bias": (None,), "norm": ("dff",),
            "w_out": ("dff", "fsdp")}


def init_mamba_state(cfg, batch: int, dtype=torch.float32, device=None) -> MambaState:
    """A zero state of this rank's heads (all of them off a split)."""
    d_inner, H, P, N = _dims(cfg)
    D = head_split(cfg).size
    d_inner, H = d_inner // D, H // D
    return MambaState(
        ssm=torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        conv_x=torch.zeros((batch, _CONV_W - 1, d_inner), dtype=dtype, device=device),
        conv_bc=torch.zeros((batch, _CONV_W - 1, 2 * N), dtype=dtype, device=device))


def _gated_norm(cfg, p, y: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    """y (f32) gated by SiLU(z) in f32, RMS-normalized (eps 1e-6) over the
    whole d_inner with the f32 ``norm`` scale, rounded to the io dtype, then
    the out projection (under a split of the heads: this rank's columns, the
    sum of squares and ``w_out``'s partial products summed over 'model')."""
    y = y * _silu(z.to(torch.float32))
    hs = head_split(cfg)
    if hs.size == 1:
        y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + 1e-6) * p["norm"]
        return constrain(y.to(dtype) @ p["w_out"], "batch", "seq", None)
    ss = C.sum_for_split(y.square().sum(-1, keepdim=True), hs.axes)
    y = y * torch.rsqrt(ss / _dims(cfg)[0] + 1e-6) * p["norm"]
    out = C.reduce_from_model(_f32_product(y.to(dtype), p["w_out"]), hs.axes)
    return constrain(out.to(dtype), "batch", "seq", None)


def apply_mamba(cfg, p, x: torch.Tensor, *, return_state: bool = False):
    """Full-sequence chunked SSD of x (B, S, d). A sequence of 128 tokens
    or more must be a multiple of the chunk (the reference's ValueError).
    With ``return_state`` also returns the ``MambaState`` after it."""
    B, S, d = x.shape
    _, H, P, N = _dims(cfg)
    z, xs_raw, b_raw, c_raw, dt_raw = _split_proj(cfg, p, x)
    d_inner, H = xs_raw.shape[-1], dt_raw.shape[-1]           # this rank's
    A_log, Dh, dt_bias = _head_params(cfg, p)
    bc_raw = torch.cat([b_raw, c_raw], dim=-1)
    xs = _causal_depthwise(xs_raw, p["conv_x"])
    bc = C.copy_to_model(_causal_depthwise(bc_raw, p["conv_bc"]), head_split(cfg).axes)
    b, c = bc[..., :N], bc[..., N:]

    Tc = _CHUNK if S % _CHUNK == 0 else (S if S < _CHUNK else None)
    if Tc is None:
        raise ValueError(f"seq {S} not divisible by chunk {_CHUNK}")
    nc = S // Tc
    f32 = torch.float32
    xh = constrain(xs.reshape(B, nc, Tc, H, P), "batch", None, None, "heads",
                   None).to(f32)
    bv = b.reshape(B, nc, Tc, N).to(f32)
    cv = c.reshape(B, nc, Tc, N).to(f32)
    dtv = _softplus(dt_raw.reshape(B, nc, Tc, H).to(f32) + dt_bias)
    A = -torch.exp(A_log)                                      # (H,) negative
    L = torch.cumsum(dtv * A, dim=2)                           # inclusive log-decay

    # intra-chunk: W[t, j] = (C_t . B_j) exp(L_t - L_j) dt_j, j <= t
    cb = torch.einsum("bctn,bcjn->bctj", cv, bv)
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]           # (B, nc, t, j, H)
    mask = torch.tril(torch.ones((Tc, Tc), dtype=torch.bool, device=x.device))
    # masked before the exp (exp(-inf) = 0: the reference's values); the
    # reference's where(mask, exp(diff), 0) overflows above the diagonal
    # once a chunk's decay passes ~88 and its backward turns 0 * inf to NaN
    M = torch.exp(torch.where(mask[None, None, :, :, None], diff, float("-inf")))
    W = cb[..., None] * M * dtv[:, :, None, :, :]
    y_intra = torch.einsum("bctjh,bcjhp->bcthp", W, xh)

    # the carry across chunks: each chunk's contribution, decayed to its end
    kx = torch.einsum("bcjh,bcjhp,bcjn->bchpn",
                      dtv * torch.exp(L[:, :, -1:, :] - L), xh, bv)
    chunk_decay = torch.exp(L[:, :, -1, :])                    # (B, nc, H)
    state = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    starts = []
    for i in range(nc):
        starts.append(state)
        state = state * chunk_decay[:, i, :, None, None] + kx[:, i]
    y_carry = torch.einsum("bctn,bchpn,bcth->bcthp", cv, torch.stack(starts, dim=1),
                           torch.exp(L))
    y = (y_intra + y_carry).reshape(B, S, H, P)
    y = y + Dh[None, None, :, None] * xs.reshape(B, S, H, P).to(f32)
    out = _gated_norm(cfg, p, y.reshape(B, S, d_inner), z, x.dtype)
    if return_state:
        return out, MambaState(ssm=state, conv_x=_tail(xs_raw, x.dtype),
                               conv_bc=_tail(bc_raw, x.dtype))
    return out


def _tail(seq: torch.Tensor, dtype) -> torch.Tensor:
    """The last W-1 *pre-conv* inputs: the decode conv state (a copy, so
    that the cache holds no view of the whole sequence)."""
    return seq[:, -(_CONV_W - 1):, :].to(dtype, copy=True)


def decode_mamba(cfg, p, x: torch.Tensor, state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """One token of the recurrence. x: (B, 1, d). Returns (y, the new
    state)."""
    B, _, d = x.shape
    _, H, P, N = _dims(cfg)
    z, xs, b, c, dt_raw = _split_proj(cfg, p, x)
    d_inner, H = xs.shape[-1], dt_raw.shape[-1]               # this rank's
    A_log, Dh, dt_bias = _head_params(cfg, p)
    cx = torch.cat([state.conv_x, xs], dim=1)                 # (B, W, d_inner)
    cbc = torch.cat([state.conv_bc, torch.cat([b, c], dim=-1)], dim=1)
    xs1 = _conv_step(cx, p["conv_x"])
    bc1 = C.copy_to_model(_conv_step(cbc, p["conv_bc"]), head_split(cfg).axes)
    b1, c1 = bc1[..., :N].to(torch.float32), bc1[..., N:].to(torch.float32)

    dtv = _softplus(dt_raw[:, 0].to(torch.float32) + dt_bias)       # (B, H)
    decay = torch.exp(dtv * -torch.exp(A_log))
    xh = xs1.reshape(B, H, P).to(torch.float32)
    S1 = state.ssm * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtv, xh, b1)
    y = torch.einsum("bhpn,bn->bhp", S1, c1) + Dh[None, :, None] * xh
    out = _gated_norm(cfg, p, y.reshape(B, 1, d_inner), z, x.dtype)
    return out, MambaState(ssm=S1, conv_x=cx[:, 1:], conv_bc=cbc[:, 1:])
