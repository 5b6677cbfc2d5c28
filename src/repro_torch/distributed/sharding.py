"""Logical-axis sharding (twin of ``repro.distributed.sharding``): one
rules table maps model-level axis names to mesh axes; the models name
their parameters' and activations' axes logically only.

Mesh layout: (pod, data, model) = (2, 16, 16) multi-pod, (data, model)
otherwise (``launch.mesh``). Default rules:

  batch   -> (pod, data)        data-parallel axes
  fsdp    -> (pod, data)        parameter and optimizer-state shards (ZeRO-3)
  heads/kv/dff/vocab/experts -> model
  embed/seq -> replicated

A mesh is anything with ``axis_names`` and ``shape`` (sizes in the same
order): a ``launch.mesh.Mesh``, which also holds the process groups, or a
bare description of one. Resolution returns, per tensor dim, None, one
mesh-axis name, or a tuple of them -- the entries of the reference's
``PartitionSpec``.

Activations under a mesh: the batch rows of a step are split over the data
axes (``local_rows`` names them). Over 'model' the layers split their own
compute (tensor parallelism, the reference's GSPMD split of heads, kv, dff
and vocab): a layer asks ``model_split(logical, n)`` for this rank's part of
a dim of ``n`` heads, KV heads, hidden columns or vocabulary rows -- the
rules' axes for that name, divisibility-guarded as the parameters are
(``_build_parts``) -- and runs on that slice of its weights, moving what it
must through ``distributed.collectives`` (``copy_to_model``,
``reduce_from_model``, ``gather_from_model``, ``sum_for_split``,
``model_slice``). The layers place their data themselves, so ``constrain``
only checks the logical axes' count and returns its input: the identity, on
and off a mesh.

Residual sequence parallelism (the 'seqpar' rule, off by default): a
stack's residual stream between its blocks holds this rank's contiguous
share of the positions; ``local_seq(split)`` says so, as ``local_rows``
does for the rows, and ``seq_split()`` reads it (``models.lm``, which
gathers the positions inside each block, and
``collectives.reduce_from_model``, which reduce-scatters them there). A
training pass reads no 'kvseq' (it builds no cache), so that rule changes
nothing in it.

Two splits over the batch rows' own axes are taken on purpose
(``model_split(..., rows_ok=True)``): the experts over 'data' of the
serving preset ``launch.dryrun.decode_rules`` (the MoE layer gathers the
rows first, ``models.mlp``; it trains too) and the vocabulary over every
axis of ``FSDP_ONLY_RULES`` (the table is then storage only,
``models.lm``).

The KV cache rows a rank holds: ``local_kvseq(split)`` says, as
``local_rows`` does for the batch rows, that every cache's sequence dim is
this rank's contiguous share ``split`` (the 'kvseq' rule's, resolved on the
whole cache by its owner, ``serving.cache.seq_split``); ``kvseq_split()``
reads it. The ownership of the rows is decided here and only here:
``kvseq_start(T)`` is the global row of a share of T rows' first, and
``kvseq_row(pos, T)`` places a global row (clamped onto the cache's last,
which the last rank holds) in this rank's share. The attention's decode,
the cache's insert, the ABFT KV sums and the engine's fault pokes read
them.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]

__all__ = ["DEFAULT_RULES", "sharding_rules", "resolve_spec", "constrain",
           "make_resolver", "current_mesh", "local_rows", "row_axes", "axes_of",
           "snapshot", "restored", "Split", "model_split", "model_size", "WHOLE",
           "local_kvseq", "kvseq_split", "kvseq_start", "kvseq_row", "local_seq",
           "seq_split"]

_state = threading.local()

DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "moebatch": ("pod", "data"),  # batch dim of MoE dispatch tensors
    "fsdp": ("pod", "data"),
    "heads": "model",
    "kv": "model",
    "dff": "model",
    "vocab": "model",
    "experts": "model",
    "embed": None,
    "seq": None,
    "seqpar": None,   # residual-stream sequence parallelism (opt-in)
    "kvseq": None,
    "state": None,
    "layers": None,
}


def _ctx():
    if not hasattr(_state, "mesh"):
        _state.mesh = None
        _state.rules = dict(DEFAULT_RULES)
        _state.rows = ()
        _state.kvseq = WHOLE
        _state.seq = WHOLE
    return _state


@contextlib.contextmanager
def sharding_rules(mesh, overrides: Optional[Dict[str, Axis]] = None):
    """Run the block under ``mesh`` with the default rules updated by
    ``overrides``; restores the previous mesh and rules after."""
    st = _ctx()
    prev = (st.mesh, st.rules)
    st.mesh = mesh
    st.rules = dict(DEFAULT_RULES)
    if overrides:
        st.rules.update(overrides)
    try:
        yield
    finally:
        st.mesh, st.rules = prev


@contextlib.contextmanager
def local_rows(axes: Tuple[str, ...]):
    """Within the block, activations hold this rank's share of the batch
    rows: the rows split, in order, over the mesh axes ``axes`` (``()``:
    every rank holds every row)."""
    st = _ctx()
    prev = st.rows
    st.rows = tuple(axes)
    try:
        yield
    finally:
        st.rows = prev


@contextlib.contextmanager
def local_kvseq(split: "Split"):
    """Within the block, every KV cache holds this rank's contiguous share
    ``split`` of its sequence rows (``WHOLE``: every row)."""
    st = _ctx()
    prev = st.kvseq
    st.kvseq = split
    try:
        yield
    finally:
        st.kvseq = prev


@contextlib.contextmanager
def local_seq(split: "Split"):
    """Within the block, the residual stream between a stack's blocks holds
    this rank's contiguous share ``split`` of the positions (the 'seqpar'
    rule's, ``models.lm``; ``WHOLE``: every position)."""
    st = _ctx()
    prev = st.seq
    st.seq = split
    try:
        yield
    finally:
        st.seq = prev


def snapshot():
    """The calling thread's mesh, rules (the overrides included), row,
    cache-row and position splits, for ``restored``: the autograd engine
    runs a CUDA backward (and the recomputation of a checkpointed block) on
    a thread of its own."""
    st = _ctx()
    return st.mesh, st.rules, st.rows, st.kvseq, st.seq


@contextlib.contextmanager
def restored(snap):
    """Run the block under a ``snapshot`` taken on another thread."""
    st = _ctx()
    prev = snapshot()
    st.mesh, st.rules, st.rows, st.kvseq, st.seq = snap
    try:
        yield
    finally:
        st.mesh, st.rules, st.rows, st.kvseq, st.seq = prev


def row_axes() -> Tuple[str, ...]:
    """The mesh axes the running step's batch rows are split over."""
    return _ctx().rows


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def _resolve_axis(mesh, logical: Optional[str]) -> Axis:
    if logical is None:
        return None
    st = _ctx()
    ax = st.rules.get(logical, None)
    if ax is None:
        return None
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    present = tuple(a for a in axes if a in mesh.axis_names)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def resolve_spec(logical_axes: Sequence[Optional[str]], mesh=None) -> Tuple[Axis, ...]:
    """The mesh axes of each logical axis, without the divisibility guard;
    ``()`` without a mesh."""
    mesh = mesh if mesh is not None else _ctx().mesh
    if mesh is None:
        return ()
    return tuple(_resolve_axis(mesh, a) for a in logical_axes)


def constrain(x, *logical_axes: Optional[str]):
    """Name ``x``'s axes logically. The layers place their data themselves
    (``model_split``, module docstring), so this is the identity, on and off
    a mesh; on a mesh the axes' count must match ``x.ndim``."""
    if _ctx().mesh is not None and len(logical_axes) != x.ndim:
        raise ValueError(f"constrain: {len(logical_axes)} logical axes for a "
                         f"{x.ndim}-d tensor {tuple(x.shape)}")
    return x


def _build_parts(mesh, logical_axes, shape):
    """Resolve logical axes to mesh axes with (a) the divisibility guard
    (a mesh axis whose running size does not divide the dim is dropped)
    and (b) first-occurrence-wins de-duplication (a mesh axis shards at
    most one dim; MoE maps both 'experts' and 'dff' to 'model', and the
    earlier dim takes it)."""
    sizes = _sizes(mesh)
    used = set()
    parts = []
    for dim, a in zip(shape, logical_axes):
        r = _resolve_axis(mesh, a)
        if r is None:
            parts.append(None)
            continue
        axes = (r,) if isinstance(r, str) else r
        keep = []
        total = 1
        for ax in axes:
            if ax not in used and dim % (total * sizes[ax]) == 0:
                keep.append(ax)
                used.add(ax)
                total *= sizes[ax]
        parts.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return parts


def make_resolver(mesh):
    """``one(spec, shape) -> parts``: the rules table, the divisibility
    guard and mesh-axis de-duplication applied to one tensor."""
    def one(spec, shape):
        return tuple(_build_parts(mesh, spec, shape))
    return one


def axes_of(part: Axis) -> Tuple[str, ...]:
    """One dim's entry as a tuple of mesh axes (``()`` when whole)."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def current_mesh():
    return _ctx().mesh


class Split(NamedTuple):
    """This rank's part of a dim split over 'model': ``index`` of ``size``
    equal parts, split over the mesh axes ``axes`` (``()`` and 1 when
    whole)."""
    index: int
    size: int
    axes: Tuple[str, ...]


WHOLE = Split(0, 1, ())


def _split_of(axes: Tuple[str, ...]) -> Split:
    """This rank's part of a dim split over ``axes`` of the active mesh
    (index 0 on a mesh that only describes a layout)."""
    mesh = _ctx().mesh
    if mesh is None or not axes or mesh.group_size(axes) == 1:
        return WHOLE
    index = 0 if getattr(mesh, "rank", None) is None else mesh.index(axes)
    return Split(index, mesh.group_size(axes), tuple(axes))


def model_split(logical: str, n: int, rows_ok: bool = False) -> Split:
    """The part of a dim of ``n`` units (heads, KV heads, hidden columns,
    vocabulary rows, experts) named ``logical`` that this rank computes: the
    rules' mesh axes for that name, dropped where their size does not divide
    ``n`` (the parameters' guard, ``_build_parts``; index 0 on a mesh that
    only describes a layout). ``WHOLE`` off a mesh and where no axis is
    left. Raises when the axes are also the batch rows' (ranks that hold
    other rows cannot share a row's heads), unless ``rows_ok``: the caller
    handles that layout itself (module docstring)."""
    st = _ctx()
    if st.mesh is None:
        return WHOLE
    axes = axes_of(_build_parts(st.mesh, (logical,), (n,))[0])
    split = _split_of(axes)
    if split.size > 1 and set(axes) & set(st.rows) and not rows_ok:
        raise NotImplementedError(f"{logical!r} split over {axes}, which the batch rows "
                                  f"{st.rows} are split over too")
    return split


def seq_split() -> Split:
    """This rank's share of the residual stream's positions (``local_seq``):
    ``WHOLE`` unless a stack runs under the 'seqpar' rule."""
    return _ctx().seq


def kvseq_split() -> Split:
    """This rank's share of the KV caches' sequence rows (``local_kvseq``):
    ``WHOLE`` unless a cache owner split them."""
    return _ctx().kvseq


def kvseq_start(T: int) -> int:
    """The global row of this rank's first cache row, of a share of T."""
    return kvseq_split().index * T


def kvseq_row(pos, T: int):
    """Global cache row ``pos`` (an int, or a tensor of them), clamped onto
    the last of the cache's rows, within this rank's share of T rows: (the
    local row, clamped into the share, and whether this rank holds it)."""
    seq = kvseq_split()
    total = seq.size * T
    if isinstance(pos, int):
        row = min(max(pos, 0), total - 1) - seq.index * T
        return min(max(row, 0), T - 1), 0 <= row < T
    row = pos.clamp(0, total - 1) - seq.index * T
    return row.clamp(0, T - 1), (row >= 0) & (row < T)


def model_size() -> int:
    """The number of ranks the 'heads' rule splits over on the active mesh,
    whatever a dim's divisibility: above 1 when the mesh runs tensor-
    parallel layers (1 off a mesh)."""
    st = _ctx()
    if st.mesh is None:
        return 1
    return st.mesh.group_size(axes_of(_resolve_axis(st.mesh, "heads")))
