"""The training, prefill and serving steps as plain functions, the shapes
of their arguments on the meta device, and the sharding trees of the
parameters, the optimizer state, the batch and the caches (twin of
``repro.launch.steps``). The launchers, the serving engine (whose decode
is ``decode_tokens``) and the dry run (``launch.dryrun``) run these same
functions.

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

``make_prefill_step`` and ``make_serve_step`` take a mesh the same way:
the parameters are this rank's shards, the batch (the tokens, the per-slot
positions) whole, of which the step keeps this rank's rows, and the caches
this rank's: its rows, its KV heads or recurrent heads, and, where the
rules split them over 'kvseq' (``launch.dryrun.decode_rules``), its share
of their sequence (``cache_parts``; the engine allocates the same).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core import guards
from repro_torch.distributed.collectives import leaf_axes
from repro_torch.distributed.sharding import (WHOLE, _build_parts, axes_of, local_kvseq,
                                              local_rows, make_resolver, sharding_rules)
from repro_torch.kernels.registry import f32_reciprocal
from repro_torch.launch import shapes as shp
from repro_torch.models.common import dtype_of
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (_resolve, init_lm, lm_decode_step, lm_forward, lm_loss,
                                   lm_param_specs, param_parts)
from repro_torch.optim import OptConfig, apply_updates, init_opt_state
from repro_torch.optim.qstate import QStateParts, qstate_specs

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step", "decode_tokens",
           "batch_to", "split_microbatches", "opt_state_specs", "opt_state_parts",
           "param_parts", "batch_row_axes", "local_batch", "state_parts", "param_shapes",
           "opt_state_shapes", "batch_shapes", "cache_shapes", "batch_parts", "cache_parts"]


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


# ------------------------------------------------- shapes on the meta device
def param_shapes(cfg: ModelConfig):
    """The parameters on the meta device, as ``init_lm`` builds them (with
    ``cfg.weight_quant == 'int8'``, the QTensors the launchers serve)."""
    return init_lm(cfg, device="meta")


def opt_state_shapes(cfg: ModelConfig, opt_cfg: OptConfig):
    """The optimizer state of ``param_shapes`` on the meta device."""
    return init_opt_state(param_shapes(cfg), opt_cfg)


def batch_shapes(cfg: ModelConfig, shape: shp.ShapeSpec):
    """A whole batch of ``shape`` on the meta device: the
    entries of ``shapes.make_batch``, the embeddings in the model dtype, as
    the reference's ``batch_specs``."""
    B, S = shape.batch, shape.seq
    dt = dtype_of(cfg)
    i32 = dict(dtype=torch.int32, device="meta")
    out = {}
    if cfg.family == "vlm":
        P = cfg.vlm_patches
        out["tokens"] = torch.empty((B, S - P), **i32)
        out["labels"] = torch.empty((B, S - P), **i32)
        out["patch_embeds"] = torch.empty((B, P, cfg.d_model), dtype=dt, device="meta")
        out["positions"] = torch.empty((3, B, S), **i32)
    else:
        out["tokens"] = torch.empty((B, S), **i32)
        out["labels"] = torch.empty((B, S), **i32)
    if cfg.is_encdec:
        out["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model), dtype=dt,
                                    device="meta")
    return out


def cache_shapes(cfg: ModelConfig, batch: int, seq: int) -> List[dict]:
    """The whole decode caches of ``batch`` rows of ``seq`` positions on
    the meta device, in the layout ``lm_prefill`` returns and
    ``lm_decode_step`` takes (``models.lm``): K / V in the KV dtype, an
    'xattn' layer's cross K / V in the model dtype, the recurrent states."""
    dt = dtype_of(cfg)
    kvdt = cfg.quant.kv_cache_dtype(dt)
    KH, hd = cfg.num_kv_heads, cfg.head_dim

    def new(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    caches = []
    for kind in cfg.layer_kinds:
        if kind in ("attn", "moe", "xattn"):
            c = {"k": new((batch, seq, KH, hd), kvdt), "v": new((batch, seq, KH, hd), kvdt)}
            if kind == "xattn":
                c["xk"] = new((batch, cfg.encoder_seq, KH, hd), dt)
                c["xv"] = new((batch, cfg.encoder_seq, KH, hd), dt)
        elif kind == "mamba":
            d_inner = cfg.ssm_expand * cfg.d_model
            H = d_inner // cfg.ssm_head_dim
            c = {"ssm": new((batch, H, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
                 "conv_x": new((batch, 3, d_inner), dt),
                 "conv_bc": new((batch, 3, 2 * cfg.ssm_state), dt)}
        elif kind == "rwkv":
            K = cfg.rwkv_head_dim
            H = cfg.d_model // K
            c = {"S": new((batch, H, K, K), torch.float32),
                 "xp_t": new((batch, cfg.d_model), dt), "xp_c": new((batch, cfg.d_model), dt)}
        else:
            raise ValueError(kind)
        caches.append(c)
    return caches


def batch_parts(cfg: ModelConfig, shape: shp.ShapeSpec, mesh):
    """The batch's mesh axes under the active rules (the reference's
    ``batch_shardings``)."""
    return _resolve(shp.batch_logical_specs(cfg), batch_shapes(cfg, shape),
                    make_resolver(mesh))


def cache_parts(cfg: ModelConfig, batch: int, seq: int, mesh):
    """The caches' mesh axes under the active rules (the reference's
    ``cache_shardings``): ``shapes.cache_logical_specs`` resolved on the
    whole caches, with the divisibility guard. ``collectives.shard_tree``
    of ``cache_shapes`` with them is what one rank holds."""
    return _resolve(shp.cache_logical_specs(cfg), cache_shapes(cfg, batch, seq),
                    make_resolver(mesh))


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


def make_prefill_step(cfg: ModelConfig, mesh=None, rules_overrides=None):
    """``prefill_step(params, batch) -> (last-position logits (B, 1, V),
    caches)``: ``lm_forward(..., want_cache=True)`` with no gradients.
    ``mesh``: the sharded step of the module docstring, under the default
    rules updated by ``rules_overrides``; the logits and caches are this
    rank's rows'."""

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _, caches = lm_forward(cfg, params, batch, want_cache=True)
        return logits[:, -1:], caches

    if mesh is None:
        return prefill_step

    def sharded_step(params, batch):
        with sharding_rules(mesh, rules_overrides):
            rows = batch_row_axes(mesh, batch["tokens"].shape[0])
            with local_rows(rows):
                return prefill_step(params, local_batch(batch, mesh, rows))

    return sharded_step


def decode_tokens(cfg: ModelConfig, params, caches, tokens: torch.Tensor,
                  cache_pos: torch.Tensor, guard: bool = False):
    """One greedy decode step: (argmax tokens (B,), the logits (B, 1, V) or,
    with ``guard``, the (B,) ok-vector of ``core.guards.rows_ok`` over the
    last position's real-vocabulary logits, the caches updated in place).
    The serving engine's decode and ``make_serve_step`` both run it."""
    logits, caches = lm_decode_step(cfg, params, caches, tokens, cache_pos)
    last = logits[:, -1]
    tok = torch.argmax(last, dim=-1)
    if guard:
        return tok, guards.rows_ok(last[:, :cfg.vocab_size], tok.shape[0]), caches
    return tok, logits, caches


def make_serve_step(cfg: ModelConfig, guard: bool = False, mesh=None, rules_overrides=None,
                    max_len: Optional[int] = None):
    """``serve_step(params, caches, tokens, cache_pos) -> (tokens (B, 1)
    int32, logits or, with ``guard``, the (B,) ok-vector, caches)``: one
    ``decode_tokens`` step with no gradients, the caches updated in place.
    ``cache_pos`` is a scalar shared by the batch, or (B,) per-slot
    positions (continuous batching; the reference's ``per_slot``, read off
    the shape). ``mesh``: the sharded step of the module docstring under the
    default rules updated by ``rules_overrides``; ``max_len``, the whole
    caches' rows, on which their 'kvseq' split is resolved (as the engine
    resolves it: None, no split)."""

    @torch.inference_mode()
    def serve_step(params, caches, tokens, cache_pos):
        tok, second, caches = decode_tokens(cfg, params, caches, tokens, cache_pos, guard)
        return tok[:, None].to(torch.int32), second, caches

    if mesh is None:
        return serve_step

    def sharded_step(params, caches, tokens, cache_pos):
        from repro_torch.serving.cache import seq_split

        B = tokens.shape[0]
        with sharding_rules(mesh, rules_overrides):
            rows = batch_row_axes(mesh, B)
            seq = WHOLE if max_len is None else seq_split(cfg, B, max_len)
            if cache_pos.ndim == 1:
                cache_pos = mesh.chunk(cache_pos, rows, 0)
            with local_rows(rows), local_kvseq(seq):
                return serve_step(params, caches, mesh.chunk(tokens, rows, 0), cache_pos)

    return sharded_step
