"""The training step as a plain function, and the sharding trees of the
parameters, the optimizer state and the batch (twin of
``repro.launch.steps``).

Under a mesh (``make_train_step(..., mesh=)``) the step takes this rank's
parameter and state shards (the ZeRO-3 layout of ``param_parts`` /
``opt_state_parts``, made by ``distributed.collectives.shard_tree``) and
the whole batch, of which it keeps this rank's rows (``batch_row_axes``:
the 'batch' rule's axes, divisibility-guarded). Each layer gathers its
parameters whole just before it runs; the gradients come back reduce-
scattered to the shards, the mean over the data ranks; then int8_ef (when
on) and AdamW run on the shards, their whole-tensor reductions (the global
norm, int8_ef's absmax) taken over every shard. The loss and metrics are
the means over the data ranks.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch import tree as T
from repro_torch.distributed.collectives import leaf_axes
from repro_torch.distributed.sharding import (_build_parts, axes_of, local_rows,
                                              sharding_rules)
from repro_torch.kernels.registry import f32_reciprocal
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import lm_loss, lm_param_specs, param_parts
from repro_torch.optim import OptConfig, apply_updates
from repro_torch.optim.qstate import qstate_specs

__all__ = ["make_train_step", "batch_to", "split_microbatches", "opt_state_specs",
           "opt_state_parts", "param_parts", "batch_row_axes", "local_batch",
           "MESH_ARCHS", "check_mesh_run"]

# the architectures the launchers run on a mesh; the other families' specs
# are ported, their mesh runs are not
MESH_ARCHS = ("phi4-mini-3.8b", "llama3-8b")


def check_mesh_run(cfg: ModelConfig, mp: int, opt_cfg: OptConfig = None) -> None:
    """Raise NotImplementedError for a launcher run the mesh does not take:
    an architecture outside ``MESH_ARCHS``, or blockwise-int8 moments with
    ``--mp`` > 1 or a world of more than one rank."""
    import os

    if cfg.name not in MESH_ARCHS:
        raise NotImplementedError(f"--mp / torchrun runs of {cfg.name} are not "
                                  f"ported; the mesh runs {MESH_ARCHS}")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if opt_cfg is not None and opt_cfg.state_dtype == "int8" and (mp > 1 or world > 1):
        raise NotImplementedError("--opt-state int8 with --mp > 1 or several ranks: "
                                  "blockwise-int8 moments need a mesh of one rank")


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _map_specs(fn, tree):
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return [_map_specs(fn, v) for v in tree]


def opt_state_specs(cfg: ModelConfig, opt_cfg: OptConfig, stacked: bool = False):
    """The optimizer state's logical axes: the moments' (the parameters',
    or ``qstate_specs`` of them for int8 moments), the step's (), and
    int8_ef's residuals'; ``stacked``: in the reference's layout."""
    pspecs = lm_param_specs(cfg, stacked)
    moments = (_map_specs(qstate_specs, pspecs) if opt_cfg.state_dtype == "int8"
               else pspecs)
    state = {"m": moments, "v": moments, "step": ()}
    if opt_cfg.grad_compression == "int8_ef":
        state["ef"] = pspecs
    return state


def opt_state_parts(cfg: ModelConfig, opt_cfg: OptConfig, mesh):
    """The optimizer state's mesh axes beside ``param_parts``: f32 moments
    and int8_ef residuals are split as their parameters are. Blockwise-int8
    moments are blocked along each shard's own last dim, so they are whole
    only on a mesh of one rank; on a larger mesh they raise."""
    pparts = param_parts(cfg, mesh)
    if opt_cfg.state_dtype == "int8":
        if mesh.size > 1:
            raise NotImplementedError("blockwise-int8 moments on a mesh of more "
                                      "than one rank")
        moments = _map_specs(lambda p: {"q": (None, None), "s": (None, None)}, pparts)
    else:
        moments = pparts
    state = {"m": moments, "v": moments, "step": ()}
    if opt_cfg.grad_compression == "int8_ef":
        state["ef"] = pparts
    return state


def batch_row_axes(mesh, batch: int) -> Tuple[str, ...]:
    """The mesh axes a batch of ``batch`` rows splits over: the 'batch'
    rule's, divisibility-guarded (``()``: every rank takes every row)."""
    return axes_of(_build_parts(mesh, ("batch",), (batch,))[0])


def local_batch(batch: Dict[str, torch.Tensor], mesh, rows) -> Dict[str, torch.Tensor]:
    """This rank's rows of a whole batch, split over the mesh axes ``rows``:
    a tensor led by the batch axis is cut along dim 0, the M-RoPE
    "positions" (3, B, S) along dim 1."""
    B = batch["tokens"].shape[0]
    out = {}
    for k, v in batch.items():
        if k == "positions" and v.ndim == 3 and v.shape[1] == B:
            out[k] = mesh.chunk(v, rows, 1)
        elif v.ndim >= 1 and v.shape[0] == B:
            out[k] = mesh.chunk(v, rows, 0)
        else:
            out[k] = v
    return out


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


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, microbatches: int = 1,
                    mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients (``lm_loss``, straight-through
    through the quantized sites), then ``apply_updates``, which updates the
    parameters and the f32 moments in place. ``microbatches > 1`` splits the
    batch along its batch axis and accumulates the gradients in f32 over the
    microbatches one after another (the reference scans them), dividing by
    the count at the end (``split_microbatches`` cuts the batch); the loss
    and metrics are the microbatches' means. ``params`` are leaf tensors;
    the step sets ``requires_grad`` on them. ``mesh``: the sharded step of
    the module docstring."""

    def grads_of(params, batch):
        flat = T.leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, metrics = lm_loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, flat)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch, shards=None):
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
                                                           opt_cfg, shards)
        del grads
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    if mesh is None:
        return train_step

    def sharded_step(params, opt_state, batch):
        with sharding_rules(mesh):
            shards = [leaf_axes(pp) for pp in T.leaves(param_parts(cfg, mesh), _is_spec)]
            rows = batch_row_axes(mesh, batch["tokens"].shape[0])
            with local_rows(rows):
                params, opt_state, metrics = train_step(
                    params, opt_state, local_batch(batch, mesh, rows), shards)
            n = mesh.group_size(rows)
            for k in ("loss", "ce", "aux"):
                metrics[k] = mesh.all_reduce(metrics[k].clone(), rows) / n
        return params, opt_state, metrics

    return sharded_step
