"""Evidence recorders for the kernel-contract linter: the port's
counterpart of ``repro.analysis.jaxpr_utils``.

The reference reads a traced jaxpr and compiled HLO. PyTorch runs eagerly,
so the port records what a call actually did, with three recorders:

* ``OpRecorder``, a ``TorchDispatchMode``: every aten op that runs during
  the call, with its tensor inputs' and outputs' shapes, dtypes and
  storage addresses (enough to follow a value from op to op). The CUDA kernels launch through ctypes, below
  the dispatcher, so they never show here; that is what makes "no aten
  contraction inside a kernel site" a fusion check, and why the launch
  counters below cover the kernels themselves.
* launch-counter deltas: each kernel wrapper's ``.launches`` (K1-K8, the
  ABFT twins and the linter's mutants), ``wquant.QUANTIZE_WEIGHT_CALLS``
  and the deprecated shims' ``TRACE_COUNTS`` ticks (``recording``);
* ``cache_snapshot``: each KV-cache leaf's ``data_ptr``, shape and dtype,
  and the storage it lives in.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpRecord", "OpRecorder", "Evidence", "recording", "kernel_wrappers",
           "FUSED_WRAPPERS", "CONTRACTIONS", "SHIM_KEYS", "cache_snapshot",
           "dtype_name", "itemsize"]

# aten ops that contract (what the reference counts as dot_general)
CONTRACTIONS = frozenset({"mm", "bmm", "matmul", "_int_mm", "_scaled_mm", "addmm",
                          "baddbmm", "addbmm", "einsum", "dot", "mv", "linear"})

# the deprecated shims' warn-once keys (their TRACE_COUNTS ticks)
SHIM_KEYS = (
    ("deprecated", "kernels.ops.hadamard"),
    ("deprecated", "kernels.fused_quant.fused_hadamard_quantize"),
)

# the fused consumer kernels' wrappers: one of them is a fused site's launch
FUSED_WRAPPERS = frozenset({
    "quant_dot_cuda", "quant_dot_streamed_cuda", "quant_dot_revisit_cuda",
    "quant_dot_experts_cuda", "quant_dot_experts_streamed_cuda",
    "quant_dot_abft_cuda", "quant_dot_abft_streamed_cuda", "quant_dot_abft_revisit_cuda",
    "quant_dot_experts_abft_cuda", "quant_dot_experts_abft_streamed_cuda",
    "mutant_unguarded_rotate_cuda", "mutant_dangling_dma_cuda",
})

Desc = Tuple[Tuple[int, ...], str, int]     # (shape, dtype, storage address)


def dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def itemsize(name: str) -> int:
    return torch.empty((), dtype=getattr(torch, name)).element_size()


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op: ``name`` its overload packet (``mm``, ``_to_copy``,
    ...), ``inputs`` its tensor arguments and ``outputs`` its tensor
    results, each as (shape, dtype, storage address)."""

    name: str
    inputs: Tuple[Desc, ...] = ()
    outputs: Tuple[Desc, ...] = ()


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _storage(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return 0


class OpRecorder(TorchDispatchMode):
    """Records every aten op dispatched while the mode is active."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = tuple((tuple(t.shape), dtype_name(t.dtype), _storage(t))
                    for t in _tensors(list(args) + list(kwargs.values())))
        outs = tuple((tuple(t.shape), dtype_name(t.dtype), _storage(t))
                     for t in _tensors(out))
        self.ops.append(OpRecord(func.overloadpacket.__name__, ins, outs))
        return out


def kernel_wrappers() -> Dict[str, object]:
    """Every kernel wrapper that counts its launches, by name."""
    from repro_torch.analysis import mutations
    from repro_torch.kernels import fused_quant, hadacore
    from repro_torch.kernels import quant_dot as qd

    fns = [hadacore.hadacore_cuda, hadacore.fwht_cuda, fused_quant.fused_dequant_cuda,
           fused_quant.fused_cuda,
           mutations.mutant_unguarded_rotate_cuda, mutations.mutant_dangling_dma_cuda]
    fns += [getattr(qd, name) for name in sorted(FUSED_WRAPPERS) if hasattr(qd, name)]
    return {f.__name__: f for f in fns}


@dataclasses.dataclass
class Evidence:
    """What one recorded call did: its aten ops, the launches per kernel
    wrapper (nonzero deltas only), the ``quantize_weight`` calls and the
    deprecated shims' ticks."""

    ops: Tuple[OpRecord, ...] = ()
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    qw_calls: int = 0
    shim_calls: Dict[str, int] = dataclasses.field(default_factory=dict)


@contextlib.contextmanager
def recording():
    """Record the call made inside the context into the yielded
    ``Evidence`` (filled in when the context exits)."""
    from repro_torch.core import wquant
    from repro_torch.kernels.registry import TRACE_COUNTS

    ev = Evidence()
    wrappers = kernel_wrappers()
    l0 = {k: f.launches for k, f in wrappers.items()}
    qw0 = wquant.QUANTIZE_WEIGHT_CALLS
    shim0 = {k: TRACE_COUNTS[k] for k in SHIM_KEYS}
    rec = OpRecorder()
    with rec:
        yield ev
    ev.ops = tuple(rec.ops)
    ev.launches = {k: f.launches - l0[k] for k, f in wrappers.items()
                   if f.launches != l0[k]}
    ev.qw_calls = wquant.QUANTIZE_WEIGHT_CALLS - qw0
    ev.shim_calls = {"/".join(k): TRACE_COUNTS[k] - shim0[k] for k in SHIM_KEYS
                     if TRACE_COUNTS[k] != shim0[k]}


def cache_snapshot(caches) -> Tuple[Tuple[int, Tuple[int, ...], str, int], ...]:
    """Per KV-cache leaf (layer order, k then v): (data_ptr, shape, dtype,
    storage address)."""
    return tuple((t.data_ptr(), tuple(t.shape), dtype_name(t.dtype), _storage(t))
                 for c in caches for t in (c["k"], c["v"]))
