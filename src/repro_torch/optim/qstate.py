"""Blockwise-int8 optimizer state (8-bit Adam; twin of
``repro.optim.qstate``): each moment tensor is flattened to (rows, last
dim), padded to whole blocks of 256 along the last dim, and stored as int8
with one f32 absmax scale per block. Stacking the states of the layers of a
group row-wise gives the reference's state of the stacked parameter.

On a mesh (``split``: the mesh and the axes the parameter's last dim is
split over) the moments of a parameter's shard hold the values of the
WHOLE tensor quantized in blocks of 256 along its global last dim, as the
reference's do. A rank stores the global blocks its columns overlap: codes
(rows, blocks x 256) with its columns at their offset in the first block
and zeros elsewhere, and those blocks' scales. Where a block spans ranks
(a shard width that is not a multiple of 256), its scale is the all-reduce
MAX of the pieces' absmax, and each rank rounds its own values with it;
where every shard width is a multiple of 256, the shard-local blocks are
the global ones and nothing moves. The rows follow the parameter's
leading dims as they are split (``QStateParts``: the parameter's parts);
the reference shards its (rows, cols) storage over (lead, last) instead,
a layout the port's shard-local optimizer cannot take (ROADMAP section 3).
``QStateParts.gather`` / ``.shard`` move between a shard's state and the
whole tensor's ``(q, s)`` in the reference's layout (checkpoints).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed

from repro_torch.distributed.collectives import gather_leaf
from repro_torch.distributed.sharding import axes_of
from repro_torch.kernels.registry import f32_reciprocal

__all__ = ["quantize_state", "dequantize_state", "zeros_like_qstate", "is_qstate",
           "qstate_specs", "QStateParts"]

_BLOCK = 256


def is_qstate(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def _span(w: int, split) -> Tuple[int, int, int, int]:
    """(offset of this rank's first column in its first block, that
    block's global index, the blocks its ``w`` columns overlap, the global
    last dim) for a last dim split as ``split`` says (None: whole)."""
    k, j = (1, 0) if split is None else (split[0].group_size(split[1]),
                                         split[0].index(split[1]))
    c0 = j * w
    b0 = c0 // _BLOCK
    return c0 - b0 * _BLOCK, b0, (c0 + max(w, 1) - 1) // _BLOCK - b0 + 1, k * w


def _blocks(L: int) -> int:
    return -(-L // _BLOCK)


def quantize_state(x: torch.Tensor, split=None) -> Dict[str, torch.Tensor]:
    """f32 tensor -> {'q': int8 (rows, padded), 's': f32 (rows, blocks)}.
    The reference's ``max(absmax, 1e-12) / 127`` compiles to a product with
    f32(1 / 127); so does this. ``split``: (mesh, axes) when ``x`` is a
    shard split along its last dim over those mesh axes (module
    docstring)."""
    shape = x.shape
    last = shape[-1] if len(shape) else 1
    off, b0, nb, L = _span(last, split)
    xf = x.to(torch.float32).reshape(-1, last)
    pad = nb * _BLOCK - off - last
    if off or pad:
        xf = torch.nn.functional.pad(xf, (off, pad))
    xb = xf.reshape(xf.shape[0], -1, _BLOCK)
    a = xb.abs().amax(-1, keepdim=True)
    if last % _BLOCK and L != last:
        # blocks that span ranks: the max of every piece's absmax
        full = a.new_zeros((xf.shape[0], _blocks(L)))
        full[:, b0:b0 + nb] = a[..., 0]
        mesh, axes = split
        mesh.all_reduce(full, axes, torch.distributed.ReduceOp.MAX)
        a = full[:, b0:b0 + nb, None]
    s = torch.clamp_min(a, 1e-12) * f32_reciprocal(127.0)
    q = torch.clamp(torch.round(xb / s), -127, 127).to(torch.int8)
    return {"q": q.reshape(xf.shape[0], -1), "s": s[..., 0].reshape(xf.shape[0], -1)}


def dequantize_state(t: Dict[str, torch.Tensor], shape, split=None) -> torch.Tensor:
    q = t["q"].to(torch.float32).reshape(t["q"].shape[0], -1, _BLOCK)
    x = (q * t["s"][..., None]).reshape(t["q"].shape[0], -1)
    last = shape[-1] if len(shape) else 1
    off = _span(last, split)[0]
    return x[:, off:off + last].reshape(shape)


def zeros_like_qstate(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    return quantize_state(torch.zeros(x.shape, dtype=torch.float32, device=x.device))


class QStateParts:
    """The mesh layout of a blockwise-int8 moment: its parameter's parts
    (per dim, the mesh axes it is split over) and whole shape; the entry
    of ``launch.steps.opt_state_parts``. ``distributed.collectives``'
    ``shard_tree`` / ``gather_tree`` call its ``shard`` / ``gather``."""

    def __init__(self, parts, shape):
        self.parts, self.shape = tuple(parts), tuple(shape)

    def __repr__(self):
        return f"QStateParts({self.parts}, {self.shape})"

    def split(self, mesh):
        """The ``split`` of ``quantize_state`` for this moment on ``mesh``."""
        return (mesh, axes_of(self.parts[-1])) if self.parts else None

    def local(self, mesh) -> Tuple[int, ...]:
        """This rank's shard shape of the parameter."""
        return tuple(g // mesh.group_size(axes_of(p)) for g, p in zip(self.shape, self.parts))

    def shard(self, st: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
        """This rank's moment state from the whole tensor's ``(q, s)``: the
        codes of its shard placed as ``quantize_state(..., split)`` places
        them, and the scales of the blocks they overlap."""
        G = self.shape
        last = G[-1] if G else 1
        q = _chunk_dims(st["q"][:, :last].reshape(G), self.parts, mesh)
        w = q.shape[-1] if q.ndim else 1
        off, b0, nb, L = _span(w, self.split(mesh))
        q = q.reshape(-1, w)
        codes = q.new_zeros((q.shape[0], nb * _BLOCK))
        codes[:, off:off + w] = q
        lead = tuple(self.parts[:-1]) + (None,)
        s = _chunk_dims(st["s"].reshape(*G[:-1], -1), lead, mesh).reshape(q.shape[0], -1)
        return {"q": codes, "s": s[:, b0:b0 + nb].contiguous()}

    def gather(self, st: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
        """The whole tensor's ``(q, s)`` in the reference's layout from every
        rank's moment state (a collective: every rank calls it)."""
        G, local = self.shape, self.local(mesh)
        last = G[-1] if G else 1
        w = local[-1] if local else 1
        split = self.split(mesh)
        off, b0, nb, L = _span(w, split)
        rows = st["q"].shape[0]
        q = gather_leaf(st["q"][:, off:off + w].reshape(local), self.parts,
                        mesh).reshape(-1, last)
        codes = q.new_zeros((q.shape[0], _blocks(last) * _BLOCK))
        codes[:, :last] = q
        s = st["s"].new_zeros((rows, _blocks(last)))
        s[:, b0:b0 + nb] = st["s"]
        if split is not None:
            # each block's scale from the ranks that hold it (equal where shared)
            mesh.all_reduce(s, split[1], torch.distributed.ReduceOp.MAX)
        lead = tuple(self.parts[:-1]) + (None,)
        s = gather_leaf(s.reshape(*local[:-1], -1), lead, mesh).reshape(q.shape[0], -1)
        return {"q": codes, "s": s}


def _chunk_dims(t: torch.Tensor, parts, mesh) -> torch.Tensor:
    for dim, p in enumerate(parts):
        t = mesh.chunk(t, axes_of(p), dim)
    return t


def qstate_specs(param_spec: tuple) -> Dict[str, Any]:
    """Logical sharding of a blockwise-int8 moment of a parameter with
    logical axes ``param_spec``: the (rows, cols) storage takes rows on the
    first named leading axis and cols on the parameter's last axis (a 1-D
    parameter's one axis goes to the rows), for both "q" and "s" -- the
    reference's rule, name for name."""
    lead = next((a for a in param_spec[:-1] if a is not None), None)
    last = param_spec[-1] if len(param_spec) > 1 else None
    if lead is None and param_spec and len(param_spec) == 1:
        lead = param_spec[-1]
        last = None
    return {"q": (lead, last), "s": (lead, last)}
