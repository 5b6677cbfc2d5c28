"""The training step as a plain function (twin of
``repro.launch.steps.make_train_step``, without the mesh's sharding trees).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch import tree as T
from repro_torch.kernels.registry import f32_reciprocal
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import lm_loss
from repro_torch.optim import OptConfig, apply_updates

__all__ = ["make_train_step", "batch_to", "split_microbatches"]


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A numpy batch (``data.SyntheticDataset``) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def split_microbatches(batch: Dict[str, torch.Tensor],
                       microbatches: int) -> List[Dict[str, torch.Tensor]]:
    """``batch`` as ``microbatches`` consecutive slices of its batch axis,
    as the reference splits it: a tensor led by the batch axis (that of
    "tokens") is cut along dim 0; the M-RoPE "positions" (3, B, S) along
    dim 1, each microbatch (3, B / M, S); any other tensor is passed whole
    to every microbatch."""
    B = batch["tokens"].shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
    parts: List[Dict[str, torch.Tensor]] = [{} for _ in range(microbatches)]
    for k, v in batch.items():
        if k == "positions" and v.ndim == 3 and v.shape[1] == B:
            pieces = v.chunk(microbatches, dim=1)
        elif v.ndim >= 1 and v.shape[0] == B:
            pieces = v.chunk(microbatches, dim=0)
        else:
            pieces = (v,) * microbatches
        for part, piece in zip(parts, pieces):
            part[k] = piece
    return parts


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients (``lm_loss``, straight-through
    through the quantized sites), then ``apply_updates``, which updates the
    parameters and the f32 moments in place. ``microbatches > 1`` splits the
    batch along its batch axis and accumulates the gradients in f32 over the
    microbatches one after another (the reference scans them), dividing by
    the count at the end (``split_microbatches`` cuts the batch); the loss
    and metrics are the microbatches' means. ``params`` are leaf tensors;
    the step sets ``requires_grad`` on them."""

    def grads_of(params, batch):
        flat = T.leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, metrics = lm_loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, flat)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            g_acc, loss, seen = None, torch.zeros((), dtype=torch.float32), []
            for part in split_microbatches(batch, microbatches):
                l_i, m_i, g = grads_of(params, part)
                if g_acc is None:
                    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                             for p in g]
                    loss = loss.to(l_i.device)
                for a, b in zip(g_acc, g):
                    a.add_(b)
                del g
                loss = loss + l_i
                seen.append(m_i)
            inv = f32_reciprocal(microbatches)
            grads = [a.mul_(inv) for a in g_acc]
            loss = loss * inv
            metrics = {k: torch.stack([m[k] for m in seen]).mean() for k in seen[0]}
        grads = T.unflatten(params, list(grads))
        with torch.no_grad():
            params, opt_state, opt_metrics = apply_updates(params, grads, opt_state,
                                                           opt_cfg)
        del grads
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step
