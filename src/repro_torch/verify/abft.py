"""ABFT primitives: checksum tolerance, weight audits and KV-cache
conservation (twin of ``repro.verify.abft``).

The quantized GEMM ``y = (s * q) @ (W_q * s_w)`` is linear in the weight,
so one f32 vector stored with the weight -- the column checksum
``check[k] = sum_d W_q[k, d] * s_w[d]`` (``wquant.weight_checksum``) --
verifies every output row:

    sum_d y[i, d]  ==  s[i] * sum_k q[i, k] * check[k]

exactly in real arithmetic. The fused kernels (K7a, K7b) sum the left side
beside the real output and return the per-row residual (left minus right);
the unfused path (``kernels.quant_dot.xla_quant_dot_resid``) recomputes
the checksum from the live weight and contracts the difference. A healthy
residual is rounding-small; a corrupted weight element, a mis-delivered
weight tile or a broken sum shifts every affected row's residual by the
corruption times the activation.

Tolerance (``abft_tolerance``): both sides are f32 sums of about n + d
terms over the same values, so they differ by about eps_f32 * sqrt(n + d)
of the row's absolute output mass; the reference's constant 4 has ~500x
headroom over its measured healthy worst case.

KV integrity is a per-slot conservation law: the engine carries
``[sum, abs_sum]`` over each slot's valid rows and recomputes it from the
cache before each decode step; a write outside the step's own row breaks
the match. Non-finite differences are left to the logits guard
(``core.guards``), so the engine can tell silent corruption from numeric
overflow. The port's caches are per-layer (slots, T, KH, hd) views of one
K and one V allocation (``serving.cache``): the sums reduce over those
allocations, a few operations per step rather than a few per layer. Of a
cache split over its rows (this rank's share of a mesh's 'kvseq' split,
``distributed.sharding.local_kvseq``) the sums are this rank's share: its
own rows' against its own running sums, the rows' positions global; the
engine's verdict is the minimum over the ranks that hold the slot.
"""
from __future__ import annotations

import math
import os
from typing import List, Tuple

import torch

from repro_torch.core import wquant
from repro_torch.distributed.sharding import kvseq_row, kvseq_start

__all__ = [
    "ABFT_ENV",
    "abft_enabled",
    "abft_tolerance",
    "residual_ok",
    "with_checks",
    "params_ok",
    "kv_tree_sums",
    "kv_row_delta",
    "kv_sums_ok",
    "kv_slot_reset",
    "kv_check",
    "kv_roll",
]

ABFT_ENV = "REPRO_ABFT"


def abft_enabled() -> bool:
    return os.environ.get(ABFT_ENV, "").lower() in ("1", "true", "on")


# ------------------------------------------------------------ GEMM residual
def abft_tolerance(n: int, d: int) -> Tuple[float, float]:
    """(rtol, atol) of the quant_dot checksum residual at contraction width
    n and out-channel width d: rtol scales the row's absolute output mass,
    atol only breaks ties for all-zero rows."""
    eps = float(torch.finfo(torch.float32).eps)
    return 4.0 * eps * math.sqrt(n + d), 1e-20


def residual_ok(y: torch.Tensor, resid: torch.Tensor, *, n: int,
                d: int) -> torch.Tensor:
    """Per-row verdict: y (..., d) output, resid (..., 1) f32 residual ->
    bool (..., 1), True = row verified (a NaN row fails)."""
    rtol, atol = abft_tolerance(n, d)
    mass = y.to(torch.float32).abs().sum(-1, keepdim=True)
    return resid.abs() <= rtol * mass + atol


# ------------------------------------------------------------ weight checks
def with_checks(params):
    """The params tree with the ABFT column checksum attached to every
    QTensor leaf that lacks one (new QTensor objects sharing ``q`` and
    ``scale``; leaves that carry a checksum, and the input tree, are left
    as they are). Stacked leaves are summed a chunk at a time."""
    def fix(_keys, t):
        if wquant.is_qleaf(t) and t.check is None:
            return wquant.QTensor(t.q, t.scale, t.mode,
                                  wquant.weight_checksum(t.q, t.scale))
        return t

    return wquant._map_with_keys(fix, params)


def _qleaves(tree) -> List[wquant.QTensor]:
    out: List[wquant.QTensor] = []
    wquant._map_with_keys(lambda _k, t: out.append(t) if wquant.is_qleaf(t) else None,
                          tree)
    return out


def params_ok(params, *, rtol: float = 1e-5) -> bool:
    """Recompute every stored checksum from the live weight (the op order
    of ``wquant.weight_checksum``) and compare: False means the weights
    themselves are corrupt. One host sync; run only after a trip."""
    oks = []
    for t in _qleaves(params):
        if t.check is not None:
            rec = wquant.weight_checksum(t.q, t.scale)
            bound = rtol * t.check.abs().amax() + 1e-12
            oks.append((rec - t.check).abs().amax() <= bound)
    if not oks:
        return True
    return bool(torch.stack(oks).all())


# ---------------------------------------------------------- KV conservation
def _kv_storage(caches) -> List[torch.Tensor]:
    """The caches' leaves as (layers, slots, T, KH, hd) tensors: a set of
    per-layer views that covers a whole allocation (``serving.cache``)
    becomes that allocation, any other leaf a 1-layer tensor."""
    groups = {}
    for c in caches:
        for t in c.values():
            base = t._base
            whole = (base is not None and base.dim() == t.dim() + 1
                     and tuple(base.shape[1:]) == tuple(t.shape)
                     and base.is_contiguous())
            key = (base.data_ptr(), tuple(base.shape)) if whole else id(t)
            groups.setdefault(key, (base if whole else None, []))[1].append(t)
    out = []
    for base, views in groups.values():
        if base is not None and len({v.data_ptr() for v in views}) == base.shape[0]:
            out.append(base)
        else:
            out.extend(v[None] for v in views)
    return out


def kv_tree_sums(caches, pos: torch.Tensor) -> torch.Tensor:
    """Per-slot [sum, abs_sum] over the valid rows [0, pos[slot]) of every
    cache leaf (of this rank's share of them) -> (slots, 2) f32.
    Rows at or after pos (prefill padding, a retired slot's leftovers) are
    masked by a select after the per-row sums, so stale values -- even
    non-finite ones -- never reach them."""
    total = None
    for leaf in _kv_storage(caches):
        T = leaf.shape[2]
        start = kvseq_start(T)
        rows = torch.arange(start, start + T, device=leaf.device)
        keep = rows[None, :] < pos.to(leaf.device)[:, None]
        f = leaf.to(torch.float32)
        zero = torch.zeros((), dtype=torch.float32, device=leaf.device)
        s = torch.where(keep, f.sum(dim=(-2, -1)), zero).sum(dim=(0, 2))
        a = torch.where(keep, f.abs().sum(dim=(-2, -1)), zero).sum(dim=(0, 2))
        cur = torch.stack([s, a], -1)
        total = cur if total is None else total + cur
    return total


def kv_row_delta(caches, pos: torch.Tensor) -> torch.Tensor:
    """Per-slot [sum, abs_sum] of the one row at pos[slot] of every cache
    leaf -> (slots, 2) f32: the row the decode step just wrote (0 where
    another rank holds that row)."""
    total = None
    for leaf in _kv_storage(caches):
        slots, T = leaf.shape[1], leaf.shape[2]
        idx, mine = kvseq_row(pos.to(leaf.device), T)
        raw = leaf.view(torch.uint8) if leaf.element_size() == 1 else leaf
        rows = raw[:, torch.arange(slots, device=leaf.device), idx]
        rows = rows.view(leaf.dtype).to(torch.float32)
        cur = torch.stack([rows.sum(dim=(0, 2, 3)), rows.abs().sum(dim=(0, 2, 3))], -1)
        cur = torch.where(mine[:, None], cur, torch.zeros((), device=cur.device))
        total = cur if total is None else total + cur
    return total


def kv_sums_ok(cur: torch.Tensor, expected: torch.Tensor, *,
               rtol: float = 1e-4, atol: float = 1e-3) -> torch.Tensor:
    """Per-slot verdict (slots,) bool: does the recomputed state match the
    carried one? Trips only on finite mismatches (NaN / inf go to the
    logits guard); rtol covers the two summation orders."""
    mass = torch.maximum(cur[:, 1], expected[:, 1])
    diff = cur - expected
    bad = (torch.isfinite(diff) & (diff.abs() > rtol * mass[:, None] + atol)).any(-1)
    return ~bad


def kv_check(caches, pos: torch.Tensor,
             kv_sums: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Before a decode step: recompute the state from the caches the step
    is about to read and compare it with the carried one. Returns (ok
    (slots,) bool, cur (slots, 2) f32); ``cur`` feeds ``kv_roll``."""
    cur = kv_tree_sums(caches, pos)
    return kv_sums_ok(cur, kv_sums), cur


def kv_roll(caches, pos: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """After a decode step: the step wrote one row per slot, at the pre-step
    ``pos``; fold it into ``cur`` for the state the next step must find."""
    return cur + kv_row_delta(caches, pos)


def kv_slot_reset(kv_sums: torch.Tensor, caches, slot: int,
                  upto: int) -> torch.Tensor:
    """Re-anchor one slot's state to the cache over rows [0, upto) (after
    prefill-insert rewrote the slot, or when a slot retires mid-trip).
    Updates ``kv_sums`` in place and returns it."""
    pos = torch.zeros(kv_sums.shape[0], dtype=torch.long, device=kv_sums.device)
    pos[slot] = upto
    kv_sums[slot] = kv_tree_sums(caches, pos)[slot]
    return kv_sums
