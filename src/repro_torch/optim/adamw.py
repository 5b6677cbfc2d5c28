"""AdamW with global-norm clipping, a warmup + cosine schedule, optional
blockwise-int8 moments (8-bit Adam) and optional error-feedback int8
gradient compression (twin of ``repro.optim.adamw``).

Every function takes and returns trees of tensors (``repro_torch.tree``:
nested dicts and lists, leaves in jax's order); the update runs in f32 per
parameter and casts back to the parameter's dtype. Divisions by constants
are written as products with the f32 reciprocal, as XLA compiles the
reference's.

Under a mesh the parameters, gradients and state are this rank's shards;
``shards`` (per leaf, in order: the mesh axes the leaf is split over) makes
the two whole-tensor reductions whole again: each leaf's squared norm is
summed over its shards before the global norm adds it in (leaf order kept,
so a mesh of one rank gives the unsharded value bitwise), and int8_ef's
per-tensor absmax is the maximum over them. ``last_axes`` (per leaf: the
mesh axes its last dim is split over) places blockwise-int8 moments in the
whole tensor's blocks (``optim.qstate``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.kernels.registry import f32_reciprocal
from repro_torch.optim.qstate import (dequantize_state, is_qstate, quantize_state,
                                      zeros_like_qstate)

__all__ = ["OptConfig", "schedule", "init_opt_state", "compress_grads",
           "apply_updates"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    state_dtype: str = "f32"        # f32 | int8 (blockwise 8-bit Adam)
    grad_compression: str = "none"  # none | int8_ef (error-feedback int8)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine decay to ``min_lr_frac * lr``;
    ``step`` an int tensor, the result f32."""
    s = step.to(torch.float32)
    warm = s * f32_reciprocal(max(cfg.warmup_steps, 1))
    t = (s - cfg.warmup_steps) * f32_reciprocal(max(cfg.total_steps - cfg.warmup_steps, 1))
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32, device=s.device) * t))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    """Zero moments (f32, or blockwise int8 dicts) per parameter, the step
    counter (int32), and the error-feedback residuals under int8_ef."""
    def f32_zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    moment = zeros_like_qstate if cfg.state_dtype == "int8" else f32_zeros
    dev = T.leaves(params)[0].device
    state = {"m": T.tree_map(moment, params), "v": T.tree_map(moment, params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.grad_compression == "int8_ef":
        state["ef"] = T.tree_map(f32_zeros, params)
    return state


def _mesh_of(shards):
    from repro_torch.distributed.sharding import current_mesh

    return current_mesh() if shards is not None else None


def _global_norm(grads, shards=None) -> torch.Tensor:
    mesh = _mesh_of(shards)
    total = 0
    for i, g in enumerate(T.leaves(grads)):
        sq = g.to(torch.float32).square().sum()
        if mesh is not None:
            mesh.all_reduce(sq, shards[i])
        total = total + sq
    return torch.sqrt(total)


def compress_grads(grads, ef, shards=None):
    """Error-feedback int8 compression: g_q = Q(g + e), e' = (g + e) - g_q,
    one absmax scale per tensor (over every shard of it, under a mesh)."""
    mesh = _mesh_of(shards)

    def one(g, e, axes):
        x = g.to(torch.float32) + e
        a = x.abs().amax()
        if mesh is not None:
            mesh.all_reduce(a, axes, dist.ReduceOp.MAX)
        s = torch.clamp_min(a, 1e-12) * f32_reciprocal(127.0)
        q = torch.clamp(torch.round(x / s), -127, 127)
        gq = q * s
        return gq, x - gq

    flat = T.leaves(grads)
    axes = shards if shards is not None else [()] * len(flat)
    out = [one(g, e, a) for g, e, a in zip(flat, T.leaves(ef), axes)]
    return (T.unflatten(grads, [o[0] for o in out]),
            T.unflatten(grads, [o[1] for o in out]))


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig, shards=None,
                  last_axes=None) -> Tuple[Any, Any, Dict]:
    """One AdamW step: (params, state, {"gnorm", "lr"}). The parameters and
    the f32 moments are updated IN PLACE, one parameter at a time (the
    reference's jitted step donates them), so the step needs one f32 copy of
    the largest parameter beside the model and its state; the same values
    as the reference's out-of-place update, op for op. ``shards``: under a
    mesh, each leaf's split axes, and ``last_axes`` those of its last dim
    (module docstring)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)

    new_state: Dict[str, Any] = {"step": step}
    if cfg.grad_compression == "int8_ef":
        grads, new_state["ef"] = compress_grads(grads, state["ef"], shards)

    gnorm = _global_norm(grads, shards)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)

    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=sf.device), sf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=sf.device), sf)

    q8 = cfg.state_dtype == "int8"
    flat_m = T.leaves(state["m"], is_qstate)
    flat_v = T.leaves(state["v"], is_qstate)
    new_m, new_v = [], []
    mesh = _mesh_of(shards)
    for i, (p, g, m, v) in enumerate(zip(T.leaves(params), T.leaves(grads), flat_m, flat_v)):
        split = None if mesh is None or last_axes is None else (mesh, last_axes[i])
        gf = g.to(torch.float32) * scale
        mf = dequantize_state(m, p.shape, split) if q8 else m
        vf = dequantize_state(v, p.shape, split) if q8 else v
        mf.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        vf.mul_(cfg.b2).add_((1 - cfg.b2) * gf.square())
        del gf
        upd = (mf / b1c).div_(torch.sqrt(vf / b2c).add_(cfg.eps))
        pf = p.to(torch.float32)
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        p.copy_(pf.sub_(lr * upd.add_(decay * pf)))
        del upd, pf
        new_m.append(quantize_state(mf, split) if q8 else mf)
        new_v.append(quantize_state(vf, split) if q8 else vf)
    new_state["m"] = T.unflatten(params, new_m)
    new_state["v"] = T.unflatten(params, new_v)
    return params, new_state, {"gnorm": gnorm, "lr": lr}
