"""The training step as a plain function, and the sharding trees of the
parameters, the optimizer state and the batch (twin of
``repro.launch.steps``).

Under a mesh (``make_train_step(..., mesh=)``) the step takes this rank's
parameter and state shards (the ZeRO-3 layout of ``param_parts`` /
``opt_state_parts``, made by ``distributed.collectives.shard_tree``) and
the whole batch, of which it keeps this rank's rows (``batch_row_axes``:
the 'batch' rule's axes, divisibility-guarded). Each layer gathers its
parameters over the data axes just before it runs, keeping what it splits
over 'model' (tensor parallelism, ``models.lm``) as this rank's slice; the
gradients come back reduce-scattered to the shards, the sum over the data
ranks of each rank's share of the loss (a slice split over 'model' keeps
its own gradient, a replicated parameter is not summed over 'model'); then int8_ef (when on) and AdamW run on the shards, their
whole-tensor reductions (the global norm, int8_ef's absmax, the int8
moments' block scales) taken over every shard. The cross-entropy and the
MoE load-balancing loss are the whole batch's (``lm_loss``), whatever the
row split. ``make_train_step(..., rules_overrides=)`` runs the sharded
step under the default rules updated by the overrides (``FSDP_ONLY_RULES``,
``{"seqpar": "model"}``, experts over 'data': ``launch.dryrun``), its
layouts resolved under them too (``state_parts``).
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
from repro_torch.models.lm import init_lm, lm_loss, lm_param_specs, param_parts
from repro_torch.optim import OptConfig, apply_updates
from repro_torch.optim.qstate import QStateParts, qstate_specs

__all__ = ["make_train_step", "batch_to", "split_microbatches", "opt_state_specs",
           "opt_state_parts", "param_parts", "batch_row_axes", "local_batch", "state_parts"]


def _is_spec(x) -> bool:
    """A leaf of a specs or parts tree: a tuple of per-dim entries, each
    None, an axis name or a tuple of axis names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e)) for e in x)


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
    and int8_ef residuals are split as their parameters are; a blockwise-
    int8 moment is a ``QStateParts`` of its parameter's parts and shape (its
    shard holds the whole tensor's blocks: ``optim.qstate``)."""
    pparts = param_parts(cfg, mesh)
    if opt_cfg.state_dtype == "int8":
        shapes = T.leaves(init_lm(cfg, device="meta"))
        flat = T.leaves(pparts, _is_spec)
        moments = T.unflatten(pparts, [QStateParts(pp, t.shape) for pp, t in
                                       zip(flat, shapes)], _is_spec)
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


def state_parts(cfg: ModelConfig, opt_cfg: OptConfig, mesh, rules_overrides=None):
    """(``param_parts``, ``opt_state_parts``) on ``mesh`` under the default
    rules updated by ``rules_overrides``: the layouts the initial parameters
    and optimizer state are sharded with (``collectives.shard_tree``) for
    ``make_train_step(..., mesh=mesh, rules_overrides=rules_overrides)``,
    and gathered with for a checkpoint."""
    with sharding_rules(mesh, rules_overrides):
        return param_parts(cfg, mesh), opt_state_parts(cfg, opt_cfg, mesh)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, microbatches: int = 1,
                    mesh=None, rules_overrides=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients (``lm_loss``, straight-through
    through the quantized sites), then ``apply_updates``, which updates the
    parameters and the f32 moments in place. ``microbatches > 1`` splits the
    batch along its batch axis and accumulates the gradients in f32 over the
    microbatches one after another (the reference scans them), dividing by
    the count at the end (``split_microbatches`` cuts the batch); the loss
    and metrics are the microbatches' means. ``params`` are leaf tensors;
    the step sets ``requires_grad`` on them. ``mesh``: the sharded step of
    the module docstring, run, with its parts, shards and rows resolved,
    under the default rules updated by ``rules_overrides`` (the reference's
    ``jit_train_step(..., rules_overrides=)``; ``launch.dryrun.cell_rules``
    composes them; ``state_parts`` gives the layouts to shard the initial
    state with). Off a mesh the overrides change nothing."""

    def grads_of(params, batch):
        flat = T.leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, metrics = lm_loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, flat)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch, shards=None, lasts=None):
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
                                                           opt_cfg, shards, lasts)
        del grads
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    if mesh is None:
        return train_step

    def sharded_step(params, opt_state, batch):
        with sharding_rules(mesh, rules_overrides):
            flat = T.leaves(param_parts(cfg, mesh), _is_spec)
            shards = [leaf_axes(pp) for pp in flat]
            lasts = [axes_of(pp[-1]) if pp else () for pp in flat]
            rows = batch_row_axes(mesh, batch["tokens"].shape[0])
            with local_rows(rows):
                params, opt_state, metrics = train_step(
                    params, opt_state, local_batch(batch, mesh, rows), shards, lasts)
            # each rank's ce is its share of the whole batch's (``lm_loss``):
            # the loss adds the other ranks' shares; aux is already whole
            if mesh.group_size(rows) > 1:
                ce = mesh.all_reduce(metrics["ce"].clone(), rows)
                metrics["loss"] = metrics["loss"] + (ce - metrics["ce"])
                metrics["ce"] = ce
        return params, opt_state, metrics

    return sharded_step
