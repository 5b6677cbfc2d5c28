"""SwiGLU / GELU MLPs with the QuaRot online Hadamard on the down-projection
input: the dense block and the top-k mixture of experts (twin of
``repro.models.mlp``).

The down projection is a ``QuantDotSpec`` site: rotate (K1 on the card;
grouped 2048-point transforms for llama3-8b's d_ff = 14336 = 7 * 2048),
per-token quantize, and contract against the pre-quantized weight -- one
K4 launch when d_ff is a power of 2. The MoE block uses the reference's
GShard-style capacity-factor dense dispatch (one-hot dispatch and combine
einsums). All experts share one d_ff Hadamard, so the expert down
projection is one ``bind_experts`` site over the stacked weights: one K6
launch for every expert on the card when d_ff is a power of 2, else one
grouped K1 launch over the dispatched rows and the einsum form (mixtral's
14336 = 7 * 2048).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import wquant
from repro_torch.core.api import QuantDotSpec
from repro_torch.kernels.registry import QSPECS
from repro_torch.models.common import dense_init, dtype_of


def _silu(g: torch.Tensor) -> torch.Tensor:
    # jax.nn.silu lowers to g * (1 / (1 + exp(-g))) with every op rounded
    # to the io dtype; torch.sigmoid rounds once and differs from it in about
    # a third of bf16 values
    return g * (1.0 / (1.0 + torch.exp(-g)))


def _gelu(g: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu (approximate=True, its default: the tanh form) lowers to
    # g * (0.5 * (1 + tanh(c1 * (g + c0 * ((g * g) * g))))) with every op
    # rounded to the io dtype and the constants c0 = 0.044715, c1 =
    # sqrt(2 / pi) rounded to it first (0-dim host tensors: scalars to a
    # CUDA op, no copy); F.gelu's default is the erf form
    c0 = torch.tensor(0.044715, dtype=g.dtype)
    c1 = torch.tensor(math.sqrt(2.0 / math.pi), dtype=g.dtype)
    return g * (0.5 * (1.0 + torch.tanh(c1 * (g + c0 * (g * g * g)))))


def _act(cfg, g: torch.Tensor) -> torch.Tensor:
    return _silu(g) if cfg.act == "swiglu" else _gelu(g)


# -------------------------------------------------------------------- dense
def init_mlp(gen: torch.Generator, cfg, device) -> dict:
    """{w_gate (SwiGLU only), w_up, w_down}."""
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    p = {}
    if cfg.act == "swiglu":
        p["w_gate"] = dense_init(gen, d, f, dt, device=device)
    p["w_up"] = dense_init(gen, d, f, dt, device=device)
    p["w_down"] = dense_init(gen, f, d, dt, scale=1.0 / math.sqrt(f), device=device)
    return p


def apply_mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    h = (_act(cfg, x @ p["w_gate"]) * (x @ p["w_up"]) if cfg.act == "swiglu"
         else _act(cfg, x @ p["w_up"]))
    spec = QuantDotSpec.for_config(h.shape[-1], cfg.quant)
    return spec.bind(p["w_down"])(h)


# ---------------------------------------------------------------------- MoE
def _expert_stack(gen: torch.Generator, cfg, device, n: int, d: int,
                  scale: float, name: str):
    """Stacked (E, n, d) expert weights, N(0, 1) * scale cast to the model
    dtype, drawn a chunk of experts at a time. With int8 weight storage
    each chunk is quantized as soon as it is drawn, per (expert,
    out-channel), into the stack's storage: an f32 draw of a whole
    128-expert stack at maverick's width would be 21.5 GB. Under ABFT
    (``wquant.wants_checks``) each chunk's column checksums are stored as
    it is quantized."""
    E, dt = cfg.num_experts, dtype_of(cfg)
    mode = None
    if cfg.weight_quant == "int8":
        mode = wquant.leaf_mode(("layers", "moe", "experts", name), (E, n, d), dt, cfg)
    check = None
    if mode is None:
        out = torch.empty((E, n, d), dtype=dt, device=device)
    else:
        q = torch.empty((E, n, d), dtype=QSPECS[mode][1], device=device)
        s = torch.empty((E, 1, d), dtype=torch.float32, device=device)
        if wquant.wants_checks(cfg):
            check = torch.empty((E, 1, n), dtype=torch.float32, device=device)
    step = wquant.chunk_len(n * d)
    for i in range(0, E, step):
        j = min(i + step, E)
        w = torch.randn((j - i, n, d), generator=gen, dtype=torch.float32,
                        device=device).mul_(scale).to(dt)
        if mode is None:
            out[i:j] = w
        else:
            qt = wquant.quantize_weight(w, mode, with_check=check is not None)
            q[i:j], s[i:j] = qt.q, qt.scale
            if check is not None:
                check[i:j] = qt.check
    return out if mode is None else wquant.QTensor(q, s, mode, check)


def init_moe(gen: torch.Generator, cfg, device) -> dict:
    """Router (d, E) f32, stacked experts {w_gate, w_up (E, d, f), w_down
    (E, f, d)}, and the shared expert's dense MLP when the config has one."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": dense_init(gen, d, E, torch.float32, device=device),
         "experts": {
             "w_gate": _expert_stack(gen, cfg, device, d, f, 1.0 / math.sqrt(d), "w_gate"),
             "w_up": _expert_stack(gen, cfg, device, d, f, 1.0 / math.sqrt(d), "w_up"),
             "w_down": _expert_stack(gen, cfg, device, f, d, 1.0 / math.sqrt(f), "w_down")}}
    if cfg.moe_shared_expert:
        p["shared"] = init_mlp(gen, cfg, device)
    return p


def apply_moe(cfg, p, x: torch.Tensor):
    """x: (B, S, d). Top-k routing with capacity-factor dense dispatch, as
    the reference writes it: f32 router logits, softmax, top-k gates
    renormalized, each token's position within its expert from a cumsum
    over the flattened (S * K) axis, tokens past the capacity dropped.
    Returns (y (B, S, d), the Switch-style load-balancing loss)."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    cap = max(1, int(cfg.capacity_factor * S * K / E))

    logits = x.to(torch.float32) @ p["router"].to(torch.float32)   # (B,S,E)
    ex = torch.exp(logits - logits.amax(-1, keepdim=True))
    gates = ex / ex.sum(-1, keepdim=True)
    topw, topi = torch.topk(gates, K, dim=-1)                      # (B,S,K)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    sel = F.one_hot(topi, E).to(torch.float32)                     # (B,S,K,E)
    flat = sel.reshape(B, S * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, S, K, E)   # tokens before me
    keep = sel * (pos < cap)                                       # capacity dropping
    cap1h = F.one_hot(pos.clamp(0, cap - 1).long(), cap).to(torch.float32)
    dispatch = (keep[..., None] * cap1h).sum(2)                    # (B,S,E,cap)
    combine = ((keep * topw[..., None])[..., None] * cap1h).sum(2)

    xin = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), x)
    we = p["experts"]
    h = (_act(cfg, torch.einsum("becd,edf->becf", xin, we["w_gate"]))
         * torch.einsum("becd,edf->becf", xin, we["w_up"]))
    spec = QuantDotSpec.for_config(h.shape[-1], cfg.quant)
    yout = spec.bind_experts(we["w_down"])(h)                      # (B,E,cap,d)
    y = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), yout)
    if cfg.moe_shared_expert:
        y = y + apply_mlp(cfg, p["shared"], x)
    density = sel.sum(2).mean(dim=(0, 1))                          # (E,)
    aux = E * (density * gates.mean(dim=(0, 1))).sum()
    return y, aux
