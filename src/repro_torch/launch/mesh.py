"""Device meshes (twin of ``repro.launch.mesh``).

``make_production_mesh`` describes the reference's production layouts
(shapes and names only; it initialises nothing), or, given a rank, builds
their groups on the default process group. ``make_local_mesh``
builds the (data, model) mesh over the ranks of the initialised default
process group, with one process group per set of mesh axes, which the
collectives run on (``Mesh.gather``, ``Mesh.reduce_scatter``,
``Mesh.all_reduce``). Rank r sits at the row-major coordinates of r in
the mesh shape, as ``jax.make_mesh`` lays devices out.

``init_distributed`` starts the default process group for a launcher:
from torchrun's ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` (and its
``MASTER_ADDR`` / ``MASTER_PORT``) when they are set, else as a world of
one at ``tcp://localhost`` on a free port; NCCL on a CUDA device, gloo on
the CPU, unless a backend is named. NCCL refuses two ranks on one device
("Duplicate GPU detected"); gloo takes them, and moves CUDA tensors in
all_gather, reduce_scatter and all_reduce, but not in point-to-point sends
(PERF.md, section 7).

``fake_world(world)`` starts a default group of ``world`` ranks on
torch's ``"fake"`` backend, on which this process is rank 0 and every
collective returns at once, moving nothing: the dry run
(``launch.dryrun``) plans a production mesh on it, its tensors on the meta
device. ``record_collectives()`` lists every collective this process runs
while it is entered (``Collective``: its kind, the bytes of the
reference's ring models, the group's size and mesh axes): each of
``Mesh.gather`` / ``reduce_scatter`` / ``all_reduce`` and each hop of
``distributed.collectives.int8_ring_all_reduce``, whose
``kvseq_all_reduce`` is a ``Mesh.all_reduce``. Off, it changes nothing.
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import os
import socket
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_local_mesh", "make_production_mesh", "init_distributed",
           "distributed_requested", "COLLECTIVE_TIMEOUT_S", "fake_world",
           "Collective", "record_collectives", "note_collective"]

# a gather moves bits: dtypes not every backend takes (bfloat16, float8,
# int16) cross as a same-width dtype every backend takes
_TAKEN = (torch.float32, torch.float64, torch.float16, torch.int32, torch.int64,
          torch.uint8, torch.int8)
_RAW = {1: torch.uint8, 2: torch.float16, 4: torch.int32, 8: torch.int64}


class Collective(NamedTuple):
    """One collective as this rank runs it: ``kind`` (the HLO opcode's
    name), ``nbytes`` (the size the reference's ring models take: an
    all-gather's output, a reduce-scatter's input, an all-reduce's tensor,
    the bytes a collective-permute sends), ``group`` (the ranks in it) and
    ``axes`` (the mesh axes it runs over)."""
    kind: str
    nbytes: int
    group: int
    axes: Tuple[str, ...]


_RECORDS: List[List[Collective]] = []


@contextlib.contextmanager
def record_collectives():
    """Within the block, every collective this process runs is appended to
    the yielded list (module docstring)."""
    seen: List[Collective] = []
    _RECORDS.append(seen)
    try:
        yield seen
    finally:
        _RECORDS.remove(seen)


def note_collective(kind: str, nbytes: int, group: int, axes) -> None:
    """Add one collective to every open record; nothing when none is."""
    for seen in _RECORDS:
        seen.append(Collective(kind, int(nbytes), int(group), tuple(axes)))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Mesh:
    """A named grid of ranks. ``shape`` and ``axis_names`` describe it;
    with ``rank`` given (``make_local_mesh``) it also holds the process
    groups of every set of its axes and runs collectives over them.
    ``index(axes)`` is this rank's position along ``axes`` taken together,
    row-major in the order given: the shard a dim split over ``axes``
    gives this rank."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: Optional[int] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)}")
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.size = 1
        for s in self.shape:
            self.size *= s
        self.rank = rank
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
        if rank is not None:
            self._make_groups()

    def __repr__(self):
        return f"Mesh({dict(zip(self.axis_names, self.shape))})"

    # ----------------------------------------------------------- geometry
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        r = self.rank if rank is None else rank
        out = {}
        for name, s in zip(reversed(self.axis_names), reversed(self.shape)):
            out[name] = r % s
            r //= s
        return out

    def group_size(self, axes: Sequence[str]) -> int:
        n = 1
        for a in axes:
            n *= self.sizes()[a]
        return n

    def index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        c, sizes = self.coords(rank), self.sizes()
        i = 0
        for a in axes:
            i = i * sizes[a] + c[a]
        return i

    def _key(self, axes) -> Tuple[str, ...]:
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"{self!r} has no axes {unknown}")
        return tuple(a for a in self.axis_names if a in axes)

    def _make_groups(self) -> None:
        """One process group per non-empty set of axes and per coordinate
        of the other axes; every rank creates every group, in one order."""
        for k in range(1, len(self.axis_names) + 1):
            for key in itertools.combinations(self.axis_names, k):
                blocks: Dict[tuple, List[int]] = {}
                for r in range(self.size):
                    c = self.coords(r)
                    blocks.setdefault(tuple(c[a] for a in self.axis_names
                                            if a not in key), []).append(r)
                for members in blocks.values():
                    g = dist.new_group(members)
                    if self.rank in members:
                        self._groups[key] = (g, members)

    def group(self, axes: Sequence[str]):
        return self._groups[self._key(axes)][0]

    # -------------------------------------------------------- collectives
    def chunk(self, t: torch.Tensor, axes: Sequence[str], dim: int) -> torch.Tensor:
        """This rank's shard of ``t`` along ``dim`` split over ``axes``
        (a view)."""
        n = self.group_size(axes)
        if n == 1:
            return t
        size = t.shape[dim] // n
        if size * n != t.shape[dim]:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {n} ways")
        return t.narrow(dim, self.index(axes) * size, size)

    def gather(self, t: torch.Tensor, axes: Sequence[str], dim: int) -> torch.Tensor:
        """The shards of every rank along ``axes``, concatenated along
        ``dim`` in shard order (an all_gather; bits move unchanged). Along
        axes of size 1 there is nothing to move: ``t`` itself."""
        if self.group_size(axes) == 1:
            return t
        g, members = self._groups[self._key(axes)]
        t = t.contiguous()
        raw = t if t.dtype in _TAKEN else t.view(_RAW[t.element_size()])
        pieces = [torch.empty_like(raw) for _ in members]
        note_collective("all-gather", _nbytes(raw) * len(members), len(members), self._key(axes))
        dist.all_gather(pieces, raw, group=g)
        order = sorted(range(len(members)), key=lambda i: self.index(axes, members[i]))
        out = torch.cat([pieces[i] for i in order], dim=dim)
        return out.view(t.dtype) if raw is not t else out

    def reduce_scatter(self, t: torch.Tensor, axes: Sequence[str], dim: int) -> torch.Tensor:
        """The sum over the ranks along ``axes`` of ``t``, this rank's
        shard of it along ``dim``."""
        if self.group_size(axes) == 1:
            return t
        g, members = self._groups[self._key(axes)]
        n = len(members)
        chunks = list(t.chunk(n, dim=dim))
        # the list is read in group-rank order, which need not be shard order
        by_rank = [chunks[self.index(axes, r)].contiguous() for r in members]
        out = torch.empty_like(by_rank[0])
        note_collective("reduce-scatter", _nbytes(out) * n, n, self._key(axes))
        dist.reduce_scatter(out, by_rank, group=g)
        return out

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str],
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced in place over the ranks along ``axes``."""
        if axes:
            n = self.group_size(axes)
            if n > 1:
                note_collective("all-reduce", _nbytes(t), n, self._key(axes))
            dist.all_reduce(t, op=op, group=self.group(axes))
        return t


def make_production_mesh(*, multi_pod: bool = False, rank: Optional[int] = None) -> Mesh:
    """The reference's production layouts: 16 x 16 (data, model), or 2
    pods of those with a leading 'pod' axis. Described only (initialising
    nothing) without ``rank``; with it, that rank of the mesh, its groups
    built on the default process group (of the mesh's size: a
    ``fake_world`` for the dry run), as ``make_local_mesh`` builds them."""
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else (
        (16, 16), ("data", "model"))
    if rank is not None and dist.get_world_size() != Mesh(shape, axes).size:
        raise ValueError(f"a {shape} mesh needs a world of its size, not "
                         f"{dist.get_world_size()} ranks")
    return Mesh(shape, axes, rank=rank)


@contextlib.contextmanager
def fake_world(world: int):
    """The default process group as rank 0 of ``world`` ranks on the
    ``"fake"`` backend (module docstring), destroyed on exit. Refuses when
    a default group already exists."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group already exists")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_local_mesh(model_parallel: int = 1) -> Mesh:
    """(world / mp, mp) over ("data", "model") from the initialised
    default process group. Raises ValueError when ``model_parallel`` does
    not divide the world (the reference asserts)."""
    world = dist.get_world_size()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model-parallel size {model_parallel} does not divide "
                         f"the world of {world} ranks")
    return Mesh((world // model_parallel, model_parallel), ("data", "model"),
                rank=dist.get_rank())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def distributed_requested(mp: int = 1) -> bool:
    """Does a launcher run distributed: under torchrun, or asked for a
    model-parallel size above 1?"""
    return "WORLD_SIZE" in os.environ or mp > 1


# how long a collective waits for its peers before it fails (the launchers'
# process groups): a rank that raised alone never leaves the others hanging
COLLECTIVE_TIMEOUT_S = 300.0


def init_distributed(device: torch.device, backend: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> None:
    """Start the default process group for this process (module
    docstring); a CUDA launcher's rank takes device ``LOCAL_RANK`` unless
    ``device`` names one. ``timeout_s``: the collectives' timeout (torch's
    default when None)."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        init = "env://"
    else:
        world, rank = 1, 0
        init = f"tcp://localhost:{_free_port()}"
    if device.type == "cuda":
        torch.cuda.set_device(device if device.index is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank, **kw)
