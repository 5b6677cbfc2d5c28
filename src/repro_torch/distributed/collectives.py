"""Collectives of the port's multi-device layer (``repro.distributed.
collectives``'s twin, and the ZeRO-3 layout's moves).

``int8_ring_all_reduce``: a store-and-forward ring over one mesh axis whose
every hop moves an int8 payload and one f32 scale and accumulates in f32
(each hop's add a fused multiply-add, as the compiled reference's), a
quarter of an f32 all-reduce's bytes per hop. Standalone, as in the
reference: the training step does not call it.

The ZeRO-3 layout: parameters (and the optimizer state beside them) live at
rest as each rank's shard (``shard_tree``); a parts tree (per tensor dim,
the mesh axes it is split over: ``launch.steps.param_parts``) says how.
``gather_param`` rebuilds a whole parameter just before use; its gradient
is reduce-scattered back to the shard with the sum over the ranks the
batch rows are split over (``distributed.sharding.row_axes``): a dim split
over those axes reduce-scatters, a dim split over other axes (whose ranks
computed the same gradient) is sliced, a dim split over both (the
``FSDP_ONLY_RULES`` layout: ('data', 'model') beside rows over 'data') is
sliced along the others and reduce-scattered along the row axes, in the
shard order, and the row axes no dim uses are all-reduced. Each rank's
loss is its share of the whole batch's (``models.lm.lm_loss``), so the sum
is the whole batch's gradient.
``gather_tree`` gathers a whole tree (checkpoints); parts that move their
own leaves (an object with ``shard`` / ``gather`` methods, as the
blockwise-int8 moments' ``optim.qstate.QStateParts``) do so.

``row_sum``: a statistic of the whole batch from each rank's rows (the MoE
load-balancing densities, the count of labels). Its backward is the
identity: a function of the sum that every rank adds to its loss sends
each rank the gradient of its own rows' part, and the sum above adds them.

Tensor parallelism over 'model' (``distributed.sharding.model_split``):
the activations between the split layers are whole and the same on every
rank of the split, and so is the loss, so each rank's backward pass must
give the gradient of its own slice of the weights and the whole gradient
of what is replicated.

  * ``copy_to_model`` sits at the input of a column-split product (Q / K /
    V, gate / up, the logits): identity forward; the backward all-reduces
    the input's gradient, which each rank holds for its own columns only.
  * ``reduce_from_model`` completes a row-split product (the attention's
    output projection, the vocabulary-split embedding lookup): all-reduce
    forward, identity backward.
  * ``gather_from_model`` all-gathers along a dim (the MLP's hidden
    columns before the down projection, the logits along the vocabulary);
    the backward keeps this rank's slice, since what follows is replicated
    and every rank holds the whole gradient.
  * ``sum_for_split`` sums the ranks' partials of a statistic that split
    work goes on to use (the Mamba2 gated RMSNorm's sum of squares over
    d_inner): all-reduce forward and backward, since each rank's gradient
    of the sum comes from its own columns only.

The sums run in f32 (a 16-bit tensor is widened, summed and rounded once).
A parameter a layer keeps split (``gather_param(..., skip=)``) keeps its
gradient on its rank: nothing sums it over 'model'.

The serving presets' layouts (``launch.dryrun``):

  * ``gather_rows`` all-gathers the batch rows over the axes they are split
    over (a MoE layer whose experts share those axes routes every row on
    every rank); its backward reduce-scatters the rows' gradient back.
    ``keep_slice`` is its mirror: this rank's rows of a sum that is whole
    and alike on every rank, its backward all-gathering the rows'
    gradients (the layer's output, in training).
  * ``kvseq_all_reduce`` completes an attention split over the KV cache's
    sequence ('kvseq'): the ranks' row maxima, then exp-sums, then f32
    weighted V sums, each all-reduced (``models.attention._split_sdpa``).
    Serving only: it raises under autograd. Only the decode attention over
    a cache reads 'kvseq', and a training pass builds no cache.

Residual sequence parallelism (the 'seqpar' rule, ``models.lm``): between
a stack's blocks each rank holds S / D of the positions. ``local_positions``
keeps this rank's positions of a tensor whole and alike (backward: the
positions' gradients all-gathered), ``gather_from_model`` along the
positions gathers them where a block needs the whole sequence, and
``reduce_from_model`` over the positions' axes reduce-scatters them inside
a block (``sharding.seq_split``).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import axes_of, current_mesh, row_axes, seq_split
from repro_torch.kernels.registry import f32_reciprocal
from repro_torch.launch.mesh import note_collective

__all__ = ["int8_ring_all_reduce", "shard_tree", "gather_tree", "gather_param",
           "gather_leaf", "leaf_axes", "row_sum", "copy_to_model", "reduce_from_model",
           "gather_from_model", "sum_for_split", "model_slice", "gather_rows",
           "kvseq_all_reduce", "keep_slice", "local_positions"]


def _quant(v: torch.Tensor):
    """One hop's payload: int8 values and their f32 absmax scale, as the
    compiled reference quantizes (``max(absmax, 1e-12) * f32(1 / 127)``,
    then a true division)."""
    s = torch.clamp_min(v.abs().amax(), 1e-12) * f32_reciprocal(127.0)
    q = torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)
    return q, s.reshape(1)


def int8_ring_all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's summand ``x`` ring-reduced over the mesh axis ``axis``:
    ``n - 1`` hops, each sending the last received contribution (at first
    ``x``) to the next rank along the axis as int8 + one f32 scale and
    adding what arrives from the previous one, in f32. Returns the sum as
    accumulated at this rank (f32)."""
    n = mesh.group_size((axis,))
    idx = mesh.index((axis,))
    _, members = mesh._groups[mesh._key((axis,))]
    by_index = {mesh.index((axis,), r): r for r in members}
    nxt, prv = by_index[(idx + 1) % n], by_index[(idx - 1) % n]
    group = mesh.group((axis,))
    send = x.to(torch.float32)
    acc = send.clone()
    for _ in range(n - 1):
        q, s = _quant(send)
        q_in, s_in = torch.empty_like(q), torch.empty_like(s)
        note_collective("collective-permute", q.numel() + 4 * s.numel(), n, (axis,))
        ops = [dist.P2POp(dist.isend, q, nxt, group), dist.P2POp(dist.isend, s, nxt, group),
               dist.P2POp(dist.irecv, q_in, prv, group),
               dist.P2POp(dist.irecv, s_in, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        recv = q_in.to(torch.float32) * s_in
        # the compiled reference contracts acc + q * s into one fused
        # multiply-add: the exact sum rounded once (q * s is exact in f64)
        acc = (acc.to(torch.float64) + q_in.to(torch.float64) * s_in.to(torch.float64)
               ).to(torch.float32)
        send = recv
    return acc


# ------------------------------------------------------------------ ZeRO-3
def leaf_axes(parts) -> Tuple[str, ...]:
    """Every mesh axis a tensor of these parts is split over."""
    return tuple(a for p in parts for a in axes_of(p))


def _shard(t: torch.Tensor, parts, mesh) -> torch.Tensor:
    out = t
    for dim, p in enumerate(parts):
        out = mesh.chunk(out, axes_of(p), dim)
    return t if out.shape == t.shape else out.clone()


def gather_leaf(t: torch.Tensor, parts, mesh, skip=()) -> torch.Tensor:
    """The whole tensor from this rank's shard (``skip``: dims left split)."""
    for dim, p in enumerate(parts):
        if dim not in skip:
            t = mesh.gather(t, axes_of(p), dim)
    return t


def _map(fn, tree, parts, method: str, mesh):
    from repro_torch.core.wquant import QTensor

    if hasattr(parts, method):       # parts that move their own leaves
        return getattr(parts, method)(tree, mesh)
    if isinstance(tree, QTensor):
        return QTensor(fn(tree.q, parts["q"]), fn(tree.scale, parts["scale"]), tree.mode,
                       None if tree.check is None else fn(tree.check, parts["check"]))
    if isinstance(tree, dict):
        return {k: _map(fn, v, parts[k], method, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, pp, method, mesh) for v, pp in zip(tree, parts)]
    if isinstance(tree, torch.Tensor) and tree.ndim:
        return fn(tree, parts)
    return tree


def shard_tree(tree: Any, parts: Any, mesh) -> Any:
    """This rank's shards of a whole tree (tensors, QTensors, nested dicts
    and lists): each a copy of its slice, or the tensor itself when it is
    not split."""
    return _map(lambda t, pp: _shard(t, pp, mesh), tree, parts, "shard", mesh)


@torch.no_grad()
def gather_tree(tree: Any, parts: Any, mesh) -> Any:
    """The whole tree from every rank's shards (a collective: every rank
    calls it)."""
    return _map(lambda t, pp: gather_leaf(t, pp, mesh), tree, parts, "gather", mesh)


class _GatherParam(torch.autograd.Function):
    """Gather a parameter whole (but for the dims ``skip``, left as this
    rank's slice); the backward returns its shard's gradient, the sum over
    the batch-row ranks (module docstring), in the parameter's dtype. A
    slice kept along the row axes (the MoE experts over 'data', whose layer
    gathers every rank's rows) already holds the whole batch's gradient:
    nothing sums it over those axes."""

    @staticmethod
    def forward(ctx, local, parts, mesh, rows, skip):
        ctx.parts, ctx.mesh, ctx.rows, ctx.dtype = parts, mesh, rows, local.dtype
        ctx.skip = skip
        return gather_leaf(local, parts, mesh, skip)

    @staticmethod
    def backward(ctx, g):
        mesh, rows = ctx.mesh, ctx.rows
        g = g.to(torch.float32)
        scatter, kept = [], set()
        for dim, p in enumerate(ctx.parts):
            if dim in ctx.skip:          # this rank's slice's own gradient
                # (over the row axes too: its layer ran on every rank's rows)
                kept.update(axes_of(p))
                continue
            axes = axes_of(p)
            inside = [a in rows for a in axes]
            if axes and all(inside):
                scatter.append((dim, axes))
            elif any(inside):
                g = _cut_outside_rows(g, mesh, axes, rows, dim)
                scatter.append((dim, tuple(a for a in axes if a in rows)))
            else:
                g = mesh.chunk(g, axes, dim)
        for dim, axes in scatter:
            g = mesh.reduce_scatter(g.contiguous(), axes, dim)
        done = {a for _, axes in scatter for a in axes} | kept
        g = g.contiguous()
        mesh.all_reduce(g, tuple(a for a in rows if a not in done))
        return g.to(ctx.dtype), None, None, None, None


def _cut_outside_rows(g: torch.Tensor, mesh, axes, rows, dim: int) -> torch.Tensor:
    """The gradient ``g`` of a dim split over ``axes``, some of them the
    batch rows' (``FSDP_ONLY_RULES``: ('data', 'model') beside rows over
    'data'), cut to this rank's index along the other axes: the dim's
    shards, laid out row-major over ``axes`` (``_build_parts``' order), keep
    every row axis' shards in order, ready for a reduce-scatter over those.
    The ranks along the other axes computed the same rows, so their
    gradient is cut, never summed."""
    sizes = [mesh.sizes()[a] for a in axes]
    n = 1
    for s in sizes:
        n *= s
    shape = g.shape
    g = g.reshape(shape[:dim] + tuple(sizes) + (shape[dim] // n,) + shape[dim + 1:])
    for i, a in enumerate(axes):
        if a not in rows:
            g = g.narrow(dim + i, mesh.coords()[a], 1)
    kept = 1
    for s, a in zip(sizes, axes):
        kept *= s if a in rows else 1
    return g.reshape(shape[:dim] + (kept * (shape[dim] // n),) + shape[dim + 1:])


def gather_param(t: torch.Tensor, parts, mesh, skip=()) -> torch.Tensor:
    """A parameter whole for use in this step (``skip``: dims left as this
    rank's slice); differentiable when ``t`` takes gradients
    (``_GatherParam``)."""
    if t.requires_grad and torch.is_grad_enabled():
        return _GatherParam.apply(t, parts, mesh, row_axes(), tuple(skip))
    return gather_leaf(t, parts, mesh, skip)


class _RowSum(torch.autograd.Function):
    """``t`` summed over the ranks ``rows`` on every rank; the backward is
    the identity (module docstring)."""

    @staticmethod
    def forward(ctx, t, mesh, rows):
        return mesh.all_reduce(t.clone(), rows)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def row_sum(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(``t`` summed over the ranks the running step's batch rows split
    over, their count): a whole-batch statistic from this rank's rows,
    differentiable. ``(t, 1)`` off a mesh or without a row split."""
    mesh, rows = current_mesh(), row_axes()
    n = 1 if mesh is None else mesh.group_size(rows)
    if n == 1:
        return t, 1
    return _RowSum.apply(t, mesh, rows), n


# ------------------------------------------------- tensor parallelism
def _sum_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` summed over the ranks along ``axes``, in f32, in ``t``'s dtype
    (a new tensor)."""
    f = t.to(torch.float32).contiguous()
    f = f.clone() if f.data_ptr() == t.data_ptr() else f
    return mesh.all_reduce(f, axes).to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.mesh, ctx.axes), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return _sum_over(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceScatterFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.reduce_scatter(t.to(torch.float32).contiguous(), axes, dim).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.gather(g.contiguous(), ctx.axes, ctx.dim), None, None, None


class _KeepSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.chunk(t, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.gather(g.contiguous(), ctx.axes, ctx.dim), None, None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.gather(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.chunk(g, ctx.axes, ctx.dim).contiguous(), None, None, None


class _SumForSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _sum_over(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.mesh, ctx.axes), None, None


def copy_to_model(t: torch.Tensor, axes) -> torch.Tensor:
    """``t`` (whole on every rank along ``axes``) as the input of a product
    split over them: the identity; its gradient is summed over the ranks
    (module docstring). ``t`` itself when ``axes`` is empty."""
    if not axes:
        return t
    return _CopyToModel.apply(t, current_mesh(), tuple(axes))


def reduce_from_model(t: torch.Tensor, axes) -> torch.Tensor:
    """The sum over the ranks along ``axes`` of this rank's partial ``t``
    (in f32, rounded once to ``t``'s dtype); the gradient passes unchanged.
    Inside a block of a stack whose positions split over the same axes
    (``sharding.seq_split``, the 'seqpar' rule), ``t`` (B, S, ...) is
    reduce-scattered over its positions instead: this rank's S / D of the
    sum, whose backward all-gathers the positions' gradients. ``t`` itself
    when ``axes`` is empty."""
    if not axes:
        return t
    sp = seq_split()
    if sp.size > 1 and sp.axes == tuple(axes):
        return _ReduceScatterFromModel.apply(t, current_mesh(), tuple(axes), 1)
    return _ReduceFromModel.apply(t, current_mesh(), tuple(axes))


def gather_from_model(t: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The ranks' slices along ``axes`` concatenated along ``dim`` in
    shard order; the backward keeps this rank's slice of the gradient.
    ``t`` itself when ``axes`` is empty."""
    if not axes:
        return t
    return _GatherFromModel.apply(t, current_mesh(), tuple(axes), dim % t.ndim)


def keep_slice(t: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``t``, whole and alike on every
    rank along ``axes`` (shard order); each rank's loss then reads its own
    slice, so the backward all-gathers the slices' gradients whole. ``t``
    itself when ``axes`` is empty; a view of it in a pass that records no
    gradient."""
    if not axes:
        return t
    mesh = current_mesh()
    if not (torch.is_grad_enabled() and t.requires_grad):
        return mesh.chunk(t, axes, dim)
    return _KeepSlice.apply(t, mesh, tuple(axes), dim % t.ndim)


def local_positions(t: torch.Tensor) -> torch.Tensor:
    """This rank's positions (dim 1) of ``t`` (B, S, ...), whole and alike
    over the residual stream's position split (``sharding.seq_split``):
    ``keep_slice`` over its axes; ``t`` itself off a split."""
    return keep_slice(t, seq_split().axes, 1)


def sum_for_split(t: torch.Tensor, axes) -> torch.Tensor:
    """The sum over the ranks along ``axes`` of this rank's partial ``t``
    (in f32, rounded once to ``t``'s dtype), for a computation that stays
    split after it: the gradient is summed over the ranks too. ``t`` itself
    when ``axes`` is empty."""
    if not axes:
        return t
    return _SumForSplit.apply(t, current_mesh(), tuple(axes))


def model_slice(t: torch.Tensor, split, dim: int = -1) -> torch.Tensor:
    """This rank's part of ``t`` (whole and alike on every rank along
    ``split.axes``) along ``dim``, for split work: the ``split.index``-th of
    ``split.size`` equal parts, its gradient summed over the ranks
    (``copy_to_model``). ``t`` itself off a split."""
    if split.size == 1:
        return t
    n = t.shape[dim] // split.size
    return copy_to_model(t, split.axes).narrow(dim, split.index * n, n)


# ------------------------------------------------- the serving presets
class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.gather(t, axes, 0)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g.contiguous(), ctx.axes, 0), None, None


def gather_rows(t: torch.Tensor, axes) -> torch.Tensor:
    """Every rank's batch rows (dim 0, split over ``axes`` in shard order),
    concatenated; the backward sums the gradient over the ranks and keeps
    this rank's rows (a reduce-scatter). ``t`` itself when ``axes`` is
    empty."""
    if not axes:
        return t
    return _GatherRows.apply(t, current_mesh(), tuple(axes))


def kvseq_all_reduce(t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """``t`` summed (``op`` "sum") or maximised ("max") over the ranks
    along ``axes``: the attention over a KV cache split over 'kvseq' merges
    its ranks' row maxima, exp-sums and f32 weighted V sums with it.
    Forward only: the decode attention over a cache is its one caller, and
    a training pass builds no cache (module docstring)."""
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError("the attention over a KV cache split over 'kvseq' "
                                  "serves only: it has no backward")
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    return current_mesh().all_reduce(t.contiguous(), axes, reduce_op)
