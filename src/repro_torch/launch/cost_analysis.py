"""Per-rank cost of one step, read off its aten ops (twin of
``repro.launch.hlo_analysis``, which reads a compiled XLA program).

The port compiles no program to read, so the step itself is run, once, on
the meta device (shapes only: nothing is computed or allocated) under
``StepCost``, a ``TorchDispatchMode`` that sees every aten op of the
forward pass and of the backward pass (the autograd engine carries the mode
onto its threads), and under ``launch.mesh.record_collectives``, on a rank
of a ``launch.mesh.fake_world``. It yields ``analyze_hlo``'s keys:

  * flops          -- matmul / bmm / addmm / baddbmm / SDPA / conv FLOPs,
                      by ``torch.utils.flop_counter``'s formulas (what HLO
                      counts as dot and convolution), plus ``_int_mm`` and
                      the CPU flash attention at theirs
  * hbm_bytes      -- operand plus result bytes of every aten op that is
                      not a view: the eager twin of the HLO model in which
                      each op reads and writes HBM once. Where the card
                      fuses ops (a kernel of this port, a cuBLAS epilogue)
                      the intermediates never reach HBM, so this is an
                      upper bound there; a collective adds its input and
                      output once, as in the HLO model
  * collectives    -- per-kind counts and wire bytes per device from the
                      recorded collectives, by the reference's ring models:
                        all-reduce       2 * size * (n-1)/n
                        all-gather       out_size * (n-1)/n
                        reduce-scatter   in_size * (n-1)/n
                        all-to-all       size * (n-1)/n
                        collective-permute  size

and the peak of live bytes (``peak_bytes``): the storages alive at once,
the step's arguments (registered before it runs) included. Each storage is
counted from the op that makes it until its last tensor dies (a weakref
finalizer on the storage). The dry run's ``temp_bytes`` is the peak less
the arguments.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, sdpa_backward_flop_count, sdpa_flop_count

from repro_torch.core.wquant import QTensor
from repro_torch.launch.mesh import Collective

__all__ = ["MetaMemo", "StepCost", "ring_factor", "collective_costs", "analyze", "tensors"]

aten = torch.ops.aten


def _int_mm_flops(a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _cpu_flash_flops(q, k, v, *args, out_val=None, **kwargs) -> int:
    return sdpa_flop_count(q.shape, k.shape, v.shape)


def _cpu_flash_backward_flops(grad_out, q, k, v, *args, out_val=None, **kwargs) -> int:
    return sdpa_backward_flop_count(grad_out.shape, q.shape, k.shape, v.shape)


_FLOPS = dict(flop_registry)
_FLOPS[aten._int_mm] = _int_mm_flops
for _name, _fn in (("_scaled_dot_product_flash_attention_for_cpu", _cpu_flash_flops),
                   ("_scaled_dot_product_flash_attention_for_cpu_backward",
                    _cpu_flash_backward_flops)):
    if hasattr(aten, _name):
        _FLOPS[getattr(aten, _name)] = _fn

# ops that move no data of their own: allocations, and the process group's
# ops (their bytes come from the recorded collectives)
_NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
             aten.new_empty_strided}
_OWN_NAMESPACES = ("c10d",)


_COMPOSITE: set = set()
_LEAF: set = set()


def _composite(func) -> bool:
    hit = torch._C._dispatch_has_kernel_for_dispatch_key(func.name(),
                                                         "CompositeImplicitAutograd")
    (_COMPOSITE if hit else _LEAF).add(func)
    return hit


# Meta kernels are slow (many run Python reference implementations), and a
# step repeats ops on the same shapes (its layers, a chunked recurrence's
# chunks): a pure op on meta tensors is answered from the first call with
# the same operands' shapes, strides and dtypes and the same other arguments
# -- its outputs' metadata, FLOPs and bytes.
class _Metas(tuple):
    tuple_out = False


_MEMO: Dict[tuple, tuple] = {}
_MEMO_OK: Dict[Any, bool] = {}


def _memoizable(func) -> bool:
    ok = _MEMO_OK.get(func)
    if ok is None:
        schema = func._schema
        ok = (not func.is_view and not schema.is_mutable and func.namespace == "aten"
              and not any(r.alias_info for r in schema.returns)
              and all(str(r.type) == "Tensor" for r in schema.returns)
              and bool(schema.returns))
        _MEMO_OK[func] = ok
    return ok


def _arg_key(a):
    if isinstance(a, torch.Tensor):
        if a.device.type != "meta":
            raise TypeError
        return (a.shape, a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple(_arg_key(x) for x in a)
    if isinstance(a, (int, float, bool, str, type(None), torch.dtype, torch.device,
                      torch.layout, torch.memory_format)):
        return (type(a), a)
    if isinstance(a, torch.Generator):     # draws no value on the meta device
        return torch.Generator
    raise TypeError


def _memo_key(func, args, kwargs):
    if not _memoizable(func):
        return None
    try:
        return (func, _arg_key(args), _arg_key(tuple(sorted(kwargs.items()))))
    except TypeError:
        return None


_ALIASED = ("aliased",)


def _remember(key, flops, nbytes, out, args, kwargs) -> None:
    outs = out if isinstance(out, tuple) else (out,)
    ins = {t.untyped_storage()._cdata for t in tensors((args, kwargs))}
    if any(isinstance(t, torch.Tensor) and t.untyped_storage()._cdata in ins for t in outs):
        _MEMO[key] = _ALIASED        # a kernel that may return an operand itself
    elif all(isinstance(t, torch.Tensor) and t.device.type == "meta" for t in outs):
        metas = _Metas((tuple(t.shape), t.stride(), t.dtype) for t in outs)
        metas.tuple_out = isinstance(out, tuple)
        _MEMO[key] = (flops, nbytes, metas)


def tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a tree of dicts, lists, tuples and QTensors: an aten
    op's arguments and outputs, or a step's."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, QTensor):
        return [t for t in (tree.q, tree.scale, tree.check) if t is not None]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in tensors(x)]


def _bytes(ts: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class MetaMemo(TorchDispatchMode):
    """Runs the aten ops under it on the meta device, a repeated pure op
    answered from its first call (the memo above); an op whose kernel is its
    decomposition (``aten.matmul`` under inference mode) runs as the ops it
    decomposes into. ``_count`` sees each op's outputs, FLOPs and bytes."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _COMPOSITE or (func not in _LEAF and _composite(func)):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        key = _memo_key(func, args, kwargs)
        hit = _MEMO.get(key) if key is not None else None
        if hit is _ALIASED:
            hit, key = None, None
        if hit is not None:
            flops, nbytes, metas = hit
            out = tuple(torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                        for shape, stride, dtype in metas)
            out = out if len(out) > 1 or metas.tuple_out else out[0]
        else:
            out = func(*args, **kwargs)
            packet = func.overloadpacket
            flops = _FLOPS[packet](*args, **kwargs, out_val=out) if packet in _FLOPS else 0
            nbytes = 0
            if not (func.is_view or packet in _NO_BYTES
                    or func.namespace in _OWN_NAMESPACES):
                nbytes = _bytes(tensors((args, kwargs))) + _bytes(tensors(out))
            if key is not None:
                _remember(key, flops, nbytes, out, args, kwargs)
        self._count(out, flops, nbytes)
        return out

    def _count(self, out, flops, nbytes) -> None:
        pass


class StepCost(MetaMemo):
    """Counts the ops, FLOPs, HBM bytes and live bytes of the aten ops run
    under it (module docstring). ``track(tree)`` registers tensors that
    exist before the step (its arguments) as live."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        self._sizes[key] = n = st.nbytes()
        self.live += n
        weakref.finalize(st, self._drop, key)

    def _drop(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def track(self, tree: Any) -> None:
        for t in tensors(tree):
            self._hold(t)
        self.peak = max(self.peak, self.live)

    def _count(self, out, flops, nbytes) -> None:
        self.ops += 1
        self.flops += flops
        self.hbm_bytes += nbytes
        for t in tensors(out):
            self._hold(t)
        self.peak = max(self.peak, self.live)


def ring_factor(kind: str, nrep: int) -> float:
    """The reference's ``_ring_factor``: (n - 1) / n of a ring over n."""
    return (nrep - 1) / max(nrep, 1)


def _wire(c: Collective) -> float:
    if c.kind == "all-reduce":
        return 2 * c.nbytes * ring_factor(c.kind, c.group)
    if c.kind == "collective-permute":
        return float(c.nbytes)
    return c.nbytes * ring_factor(c.kind, c.group)


def _hbm(c: Collective) -> float:
    """Input plus output bytes of one collective on this rank."""
    if c.kind == "all-gather":
        return c.nbytes / c.group + c.nbytes
    if c.kind == "reduce-scatter":
        return c.nbytes + c.nbytes / c.group
    return 2.0 * c.nbytes


def collective_costs(seen: Iterable[Collective]) -> Dict[str, Any]:
    """Per-kind wire bytes and counts of recorded collectives, and the HBM
    bytes they read and write."""
    wire: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    hbm = 0.0
    for c in seen:
        wire[c.kind] += _wire(c)
        count[c.kind] += 1
        hbm += _hbm(c)
    return {"wire": dict(wire), "counts": dict(count), "hbm": hbm}


def analyze(cost: StepCost, seen: Iterable[Collective]) -> Dict[str, Any]:
    """``analyze_hlo``'s keys for one step run under ``cost`` with its
    collectives recorded in ``seen``, plus ``peak_bytes``."""
    coll = collective_costs(seen)
    return {
        "flops_per_device": float(cost.flops),
        "hbm_bytes_per_device": float(cost.hbm_bytes + coll["hbm"]),
        "collective_wire_bytes_per_device": coll["wire"],
        "collective_counts": coll["counts"],
        "collective_total_bytes_per_device": float(sum(coll["wire"].values())),
        "peak_bytes": int(cost.peak),
    }
