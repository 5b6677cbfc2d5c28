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

Tensor parallelism over 'model' (``dff_split``; the reference names the
hidden width 'dff'): a rank holds the columns of ``w_gate`` / ``w_up`` of its
d_ff / D hidden units, so h and the activation are local; h is then
all-gathered whole (``gather_from_model``) into the down projection, whose
contraction axis the reference never splits (its Hadamard spans it): that
one site runs as it does off the split -- its weight's out-channels over
'fsdp', the fused kernel shard-local -- on every rank of 'model' alike.

The MoE block splits its experts over 'model' (``expert_split``; the
reference's specs put 'experts' first on 'model'): the router, the softmax,
top-k, the capacity positions and the aux loss are computed whole and alike
on every rank; each rank slices the dispatch and combine tensors to its E /
D experts, runs gate / up and the down site (one K6 launch over its experts
when d_ff is a power of 2) on its experts' weights, combines its experts'
outputs in f32, and the ranks' sums are all-reduced (``reduce_from_model``)
and rounded once to the model dtype. Where 'experts' does not divide the
axis the parameters give 'model' to the hidden width (``_build_parts``), and
the experts split as the dense MLP does (``expert_dff_split``). x reaches the
split products through ``copy_to_model``; the router's gradient through the
combine weights is summed over 'model' (``copy_to_model`` on ``combine``
before its slice), through the aux loss counted once (it is replicated).

Experts over the batch rows' own axes (the serving preset
``launch.dryrun.decode_rules``: experts over 'data', their hidden width
over 'model', the dispatch replicated over the rows, 'moebatch' None): the
layer all-gathers the rows' tokens over the axes they split over
(``collectives.gather_rows``), routes every gathered token alike on every
rank, runs its E / D experts on them (one K6 launch, or mixtral's grouped
path), sums the experts' f32 share over the experts' axes and keeps its
own rows, rounded once. The experts' hidden width splits over 'model'
wherever 'dff' and 'experts' take different axes (``expert_dff_split``);
the down site contracts the gathered hidden width whole, so nothing is
summed over 'model'. That layout trains too: the gathered tokens' gradient
is reduce-scattered back to each rank's rows (``gather_rows``), and the
kept rows' gradient all-gathered before the experts' sum (``keep_slice``);
the router's statistics stay the rank's rows' (``_batch_mean``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import wquant
from repro_torch.core.api import QuantDotSpec
from repro_torch.distributed import collectives as C
from repro_torch.distributed.collectives import row_sum
from repro_torch.distributed.sharding import (WHOLE, constrain, current_mesh, model_split,
                                              row_axes)
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


# logical axes of the down projections' weights: the sharded quant_dot's
# column split under a mesh
_DOWN_AXES = ("dff", "fsdp")
_EXPERT_DOWN_AXES = ("experts", "dff", "fsdp")


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


def mlp_specs(cfg) -> dict:
    """Logical sharding axes of the MLP's parameters."""
    p = {"w_up": ("fsdp", "dff"), "w_down": ("dff", "fsdp")}
    if cfg.act == "swiglu":
        p["w_gate"] = ("fsdp", "dff")
    return p


def dff_split(cfg):
    """This rank's split of the dense MLP's hidden width over 'model'."""
    return model_split("dff", cfg.d_ff)


def expert_split(cfg):
    """This rank's split of the MoE layer's experts (over 'model' by
    default; over the rows' 'data' under ``decode_rules``, module
    docstring)."""
    return model_split("experts", cfg.num_experts, rows_ok=True)


def expert_dff_split(cfg):
    """This rank's split of the experts' hidden width: the dense MLP's
    where it takes other axes than the experts (``_build_parts`` hands
    'model' to 'dff' where the experts do not divide it, and the serving
    preset splits the experts over 'data'), else whole."""
    es, fs = expert_split(cfg), dff_split(cfg)
    return WHOLE if set(es.axes) & set(fs.axes) else fs


def apply_mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    axes = dff_split(cfg).axes
    x = C.copy_to_model(x, axes)
    h = (_act(cfg, x @ p["w_gate"]) * (x @ p["w_up"]) if cfg.act == "swiglu"
         else _act(cfg, x @ p["w_up"]))
    h = constrain(C.gather_from_model(h, axes, -1), "batch", "seq", "dff")
    # under a mesh the site shards: the weight's columns over 'fsdp' (the
    # data axes), the fused kernel shard-local (core.api)
    spec = QuantDotSpec.for_config(h.shape[-1], cfg.quant, weight_axes=_DOWN_AXES)
    return constrain(spec.bind(p["w_down"])(h), "batch", "seq", None)


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


def moe_specs(cfg) -> dict:
    """Logical sharding axes of the MoE block's parameters."""
    p = {"router": ("fsdp", None),
         "experts": {"w_gate": ("experts", "fsdp", "dff"),
                     "w_up": ("experts", "fsdp", "dff"),
                     "w_down": ("experts", "dff", "fsdp")}}
    if cfg.moe_shared_expert:
        p["shared"] = mlp_specs(cfg)
    return p


def _route(p, x: torch.Tensor) -> torch.Tensor:
    """The router's probabilities (B, S, E) in f32: the softmax of the f32
    logits."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    ex = torch.exp(logits - logits.amax(-1, keepdim=True))
    return ex / ex.sum(-1, keepdim=True)


def apply_moe(cfg, p, x: torch.Tensor):
    """x: (B, S, d). Top-k routing with capacity-factor dense dispatch, as
    the reference writes it: f32 router logits, softmax, top-k gates
    renormalized, each token's position within its expert from a cumsum
    over the flattened (S * K) axis, tokens past the capacity dropped.
    Returns (y (B, S, d), the Switch-style load-balancing loss).

    Under a mesh whose step splits the batch rows, the loss of a pass that
    records gradients is the whole batch's, as the reference's: the expert
    densities and the mean router probabilities are summed over the row
    ranks (``row_sum``) before their product. Inference, which drops the
    loss, keeps this rank's rows' statistics and moves nothing. Capacity
    and dispatch stay per row."""
    E, K = cfg.num_experts, cfg.experts_per_token
    x_own, rows = x, _gathered_rows(cfg)
    x = C.gather_rows(x, rows)
    B, S, _ = x.shape
    cap = max(1, int(cfg.capacity_factor * S * K / E))

    gates = _route(p, x)                                           # (B,S,E)
    topw, topi = torch.topk(gates, K, dim=-1)                      # (B,S,K)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    sel = F.one_hot(topi, E).to(torch.float32)                     # (B,S,K,E)
    flat = sel.reshape(B, S * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, S, K, E)   # tokens before me
    keep = sel * (pos < cap)                                       # capacity dropping
    cap1h = F.one_hot(pos.clamp(0, cap - 1).long(), cap).to(torch.float32)
    dispatch = (keep[..., None] * cap1h).sum(2)                    # (B,S,E,cap)
    combine = ((keep * topw[..., None])[..., None] * cap1h).sum(2)

    es, fs = expert_split(cfg), expert_dff_split(cfg)
    we = p["experts"]
    if es.size > 1:
        # this rank's experts: its slice of the dispatch and combine (the
        # gathered rows' combine is this rank's alone: no sum to take)
        n = E // es.size
        dispatch = dispatch.narrow(2, es.index * n, n)
        combine = (combine.narrow(2, es.index * n, n) if rows
                   else C.model_slice(combine, es, 2))
    axes = fs.axes if rows else (es.axes or fs.axes)
    xin = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), C.copy_to_model(x, axes))
    xin = constrain(xin, "moebatch", "experts", None, None)
    h = (_act(cfg, torch.einsum("becd,edf->becf", xin, we["w_gate"]))
         * torch.einsum("becd,edf->becf", xin, we["w_up"]))
    h = constrain(C.gather_from_model(h, fs.axes, -1), "moebatch", "experts", None, "dff")
    # weight_axes is declarative at the expert site, as in the reference
    spec = QuantDotSpec.for_config(h.shape[-1], cfg.quant,
                                   weight_axes=_EXPERT_DOWN_AXES)
    yout = spec.bind_experts(we["w_down"])(h)                      # (B,E,cap,d)
    if es.size > 1:
        # this rank's experts' share in f32, summed over their axes, rounded once
        y = torch.einsum("bsec,becd->bsd", combine.to(x.dtype).to(torch.float32),
                         yout.to(torch.float32))
        y = C.reduce_from_model(y, es.axes)
        if rows:
            y = C.keep_slice(y, rows, 0)                  # this rank's rows
            sel, gates = (current_mesh().chunk(t, rows, 0) for t in (sel, gates))
        y = y.to(x.dtype)
    else:
        y = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), yout)
    y = constrain(y, "batch", "seq", None)
    if cfg.moe_shared_expert:
        shared = apply_mlp(cfg, p["shared"], x_own)
        # under 'seqpar' the experts' sum is this rank's positions already
        y = y + (shared if shared.shape[1] == y.shape[1] else C.local_positions(shared))
    density, router = _batch_mean(sel.sum(2)), _batch_mean(gates)  # (E,)
    aux = E * (density * router).sum()
    return y, aux


def _gathered_rows(cfg):
    """The row axes the MoE layer gathers its tokens over: the batch rows'
    where the experts split over some of them (module docstring), else
    ``()``."""
    rows = row_axes()
    return rows if set(expert_split(cfg).axes) & set(rows) else ()


def _batch_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over the (B, S) dims of the whole batch when the pass
    records gradients (every rank's rows under a row split: ``row_sum``),
    else of this rank's rows."""
    if not torch.is_grad_enabled():
        return t.mean(dim=(0, 1))
    total, n = row_sum(t.sum(dim=(0, 1)))
    if n == 1:
        return t.mean(dim=(0, 1))
    return total / (t.shape[0] * t.shape[1] * n)
