"""Teacher-forced logits of a serving engine: the readings the mesh and
rules holds compare (the CPU tests and ``chip_smoke.py``).

``forced_logits(engine, prompts, forced)`` admits one prompt per slot
through the engine's own prefill and insert (no scheduler), then runs
``len(forced)`` decode steps over every slot, each fed the given tokens at
each slot's next position, and records the logits of every step: the same
context for every engine it is given, whatever tokens each would pick. On
a mesh every rank returns the whole logits (the slots gathered in slot
order).

``split_output_projection(parts)``: within it, the attention's output
projection on one process sums the f32 products of ``parts`` row blocks
and rounds once, the sum a split of the query heads over ``parts`` ranks
takes: the witness of a split over 'heads', a correct path that differs
from world 1's only in summation order.

``split_positions(parts)``: within it, each block's norms on one process
run on ``parts`` contiguous runs of the positions apart, so a norm leaf's
gradient is the sum of the runs' sums, as the 'seqpar' rule's ranks sum
it: the witness of a split of the residual stream's positions.

``saved_block_inputs()``: within it, the bytes of the residual stream that
autograd keeps for the backward at the checkpointed blocks' inputs
(``torch.autograd.graph.saved_tensors_hooks``): what the 'seqpar' rule
cuts to 1 / D a rank.

``step_zero(cfg, params, batch, mesh, rules)``: a training step's loss and
gradients, as ``launch.steps.make_train_step`` takes them under ``rules``
on ``mesh`` (this rank's shards, this rank's rows), the gradients gathered
whole: the readings the training-rules holds compare. Two controls of
those holds: ``norms_unsummed()`` (the 'seqpar' block norms' gradient not
summed over the positions' ranks) and ``summed_over_model()`` (the
parameters' backward summing over 'model' too, which the ranks of
``FSDP_ONLY_RULES``' 'model' computed alike).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["forced_logits", "split_output_projection", "split_positions",
           "saved_block_inputs", "step_zero", "norms_unsummed", "summed_over_model"]


@torch.inference_mode()
def forced_logits(engine, prompts: Sequence[Sequence[int]],
                  forced: np.ndarray) -> Dict[str, torch.Tensor]:
    """``prompts``: one token list per slot (each at most the prefill
    bucket); ``forced``: (steps, slots) tokens. Returns {"prefill": (slots,
    vocab) f32 logits at each prompt's last position, "decode": (steps,
    slots, vocab) f32 logits of each decode step}, on the CPU."""
    from repro_torch.launch import steps as S
    from repro_torch.serving import engine as E

    V = engine.cfg.vocab_size
    seen = []
    real_forward, real_decode = E.lm_forward, S.lm_decode_step

    def forward(*a, **k):
        out = real_forward(*a, **k)
        seen.append(out[0])
        return out

    def decode(*a, **k):
        out = real_decode(*a, **k)
        seen.append(out[0])
        return out

    E.lm_forward, S.lm_decode_step = forward, decode
    try:
        first = []
        for slot, toks in enumerate(prompts):
            padded = np.zeros((1, engine.prefill_len), np.int64)
            padded[0, :len(toks)] = toks
            engine._insert(slot, engine._prefill(padded, len(toks))[-1])
            first.append(seen[-1][0, len(toks) - 1, :V].float())
            engine.positions_h[slot] = len(toks)
        steps = []
        for tokens in np.asarray(forced):
            engine.tokens_h[:, 0] = tokens
            engine._decode()
            steps.append(engine._gather(seen[-1][:, -1, :V].float().contiguous()))
            engine.positions_h += 1
    finally:
        E.lm_forward, S.lm_decode_step = real_forward, real_decode
    return {"prefill": torch.stack(first).cpu(),
            "decode": torch.stack(steps).cpu() if steps else torch.zeros((0, len(prompts), V))}


@contextlib.contextmanager
def split_output_projection(parts: int):
    """Within the block, ``models.attention``'s output projection on one
    process is the sum of ``parts`` row blocks' f32 products, rounded once
    (module docstring)."""
    from repro_torch.models import attention as A

    real = A._out_proj

    def split(cfg, ctx, wo):
        n = ctx.shape[-1] // parts
        acc = A._f32_product(ctx[..., :n], wo[:n])
        for i in range(1, parts):
            acc = acc + A._f32_product(ctx[..., i * n:(i + 1) * n], wo[i * n:(i + 1) * n])
        return acc.to(ctx.dtype)

    A._out_proj = split
    try:
        yield
    finally:
        A._out_proj = real


@contextlib.contextmanager
def split_positions(parts: int):
    """Within the block, ``models.lm``'s block norms on one process run on
    ``parts`` contiguous runs of the positions apart (module docstring)."""
    from repro_torch.models import lm

    real = lm._block_norm

    def split(cfg, p, x):
        n = x.shape[1] // parts
        return torch.cat([real(cfg, p, x[:, i * n:(i + 1) * n]) for i in range(parts)], dim=1)

    lm._block_norm = split
    try:
        yield
    finally:
        lm._block_norm = real


@contextlib.contextmanager
def saved_block_inputs():
    """Within the block, count what autograd saves of each checkpointed
    block's residual-stream input (``models.lm`` with ``cfg.remat`` on):
    yields a dict whose "bytes" and "blocks" grow as the blocks run."""
    from repro_torch.models import lm

    seen = {"bytes": 0, "blocks": 0}
    entering = []
    real = torch.utils.checkpoint.checkpoint

    def checkpoint(fn, cfg, kind, lp, x, *args, **kw):
        entering.append(x)
        try:
            return real(fn, cfg, kind, lp, x, *args, **kw)
        finally:
            entering.pop()

    def pack(t):
        if entering and t.data_ptr() == entering[-1].data_ptr() \
                and t.shape == entering[-1].shape:
            seen["bytes"] += t.numel() * t.element_size()
            seen["blocks"] += 1
        return t

    lm.torch.utils.checkpoint.checkpoint = checkpoint
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            yield seen
    finally:
        lm.torch.utils.checkpoint.checkpoint = real


def step_zero(cfg, params, batch, mesh=None, rules=None, gather: bool = True) -> dict:
    """``lm_loss`` and its gradients on ``batch`` (whole; this rank keeps
    its rows) from ``params`` (whole; under ``mesh`` this rank shards them
    under ``rules``, as ``launch.steps.make_train_step`` does): {"ce" (the
    whole batch's), "aux", "grads" (the leaves' gradients in the
    parameters' dtype, gathered whole; with ``gather`` off this rank's
    shards, and "parts" their layouts), "saved" / "blocks"
    (``saved_block_inputs`` on this rank)}."""
    from repro_torch import tree as T
    from repro_torch.distributed.collectives import gather_tree, shard_tree
    from repro_torch.distributed.sharding import local_rows, sharding_rules
    from repro_torch.launch.steps import batch_row_axes, local_batch
    from repro_torch.models.lm import lm_loss, param_parts

    def grads(p, b):
        flat = T.leaves(p)
        for t in flat:
            t.requires_grad_(True)
        with saved_block_inputs() as seen:
            loss, m = lm_loss(cfg, p, b)
        g = torch.autograd.grad(loss, flat)
        for t in flat:
            t.requires_grad_(False)
        return T.unflatten(p, list(g)), {k: v.detach() for k, v in m.items()}, seen

    if mesh is None:
        g, m, seen = grads(params, batch)
        ce = m["ce"]
    else:
        with sharding_rules(mesh, rules):
            parts = param_parts(cfg, mesh)
            shards = shard_tree(params, parts, mesh)
            rows = batch_row_axes(mesh, batch["tokens"].shape[0])
            with local_rows(rows):
                g, m, seen = grads(shards, local_batch(batch, mesh, rows))
            del shards
            ce = mesh.all_reduce(m["ce"].clone().reshape(1), rows)[0]
        if gather:
            g = gather_tree(g, parts, mesh)
    out = {"ce": float(ce), "aux": float(m["aux"]), "grads": T.leaves(g),
           "saved": seen["bytes"], "blocks": seen["blocks"]}
    if mesh is not None and not gather:
        from repro_torch.launch.steps import _is_spec

        out["parts"] = T.leaves(parts, _is_spec)
    return out


@contextlib.contextmanager
def norms_unsummed():
    """Within the block, ``models.lm``'s block norms under the 'seqpar'
    rule leave their leaves' gradient unsummed over the positions' ranks
    (module docstring)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import seq_split
    from repro_torch.models import lm

    real = lm._block_norm

    def norm(cfg, p, x):
        sp = seq_split()
        if sp.size == 1:
            return real(cfg, p, x)
        return C.gather_from_model(lm.apply_norm(cfg, p, x), sp.axes, 1)

    lm._block_norm = norm
    try:
        yield
    finally:
        lm._block_norm = real


@contextlib.contextmanager
def summed_over_model():
    """Within the block, the parameters' gathers take 'model' for a batch
    row axis, so their backward sums over 'model' too (module docstring)."""
    from repro_torch.distributed import collectives as C

    real = C.gather_param

    def gather(t, parts, mesh, skip=()):
        if t.requires_grad and torch.is_grad_enabled():
            return C._GatherParam.apply(t, parts, mesh, C.row_axes() + ("model",), tuple(skip))
        return real(t, parts, mesh, skip)

    C.gather_param = gather
    try:
        yield
    finally:
        C.gather_param = real