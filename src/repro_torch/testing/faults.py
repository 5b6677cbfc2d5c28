"""Fault injection for the serving engine (twin of
``repro.testing.faults``).

Every recovery path of ``serving.engine`` -- retry, the degradation
ladder, the watchdog, the numeric guards, the ABFT retirements -- is
exercised by injecting its triggering fault at a chosen step of a real
serve run, then checking each request's ``Completion`` and the
``health()`` counters.

  * ``FaultPlan.maybe_raise`` fires before the decode step runs, so the
    caches are as the last step left them and a retry runs on them.
  * ``poke_nan`` writes NaN into an already-written KV row of a live slot;
    the next step attends it, so the NaN reaches that slot's logits and
    trips the numeric guard.
  * ``FaultPlan.delay_s`` sleeps on the host around a step (the watchdog).
  * the silent injectors (``flip_weight_bit``, ``perturb_kv_row``,
    ``clobber_stream_tile``, scheduled by ``corrupt_at_step``) write
    finite wrong values, invisible to every isfinite guard: only the ABFT
    layer (``repro_torch.verify``) can catch them.

The port corrupts in place, on the device, through a ``uint8`` view of
the tensor; the stored ABFT checksum is left as it was, so it goes stale.
The weight injectors pick the first checksum-covered consumer leaf
(``w_down``, contracted through the verified quant_dot at every step),
as the reference's ``_map_first_qleaf`` does, and return a callable that
undoes the change; corruptions the engine makes under ``inject(plan)``
are undone when that scope exits, so a fault never outlives its scope.
The engine polls ``active()``: with no plan, one attribute load and a
None check per step.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "FaultPlan",
    "InjectedKernelError",
    "inject",
    "active",
    "poke_nan",
    "flip_weight_bit",
    "perturb_kv_row",
    "clobber_stream_tile",
    "arrival_flood",
]


class InjectedKernelError(RuntimeError):
    """The synthetic kernel failure raised by ``FaultPlan.maybe_raise``."""


@dataclasses.dataclass
class FaultPlan:
    """What to break, and when (steps in engine step-clock units).

    kernel_raise_at_step / kernel_raise_count: raise ``InjectedKernelError``
        at decode dispatch from this step on, this many attempts in a row
        (1 exercises the retry, 2 or more the degradation ladder).
    step_delay_s / delay_at_steps: host latency added to the listed steps
        (all steps when empty), for the watchdog.
    nan_poke_step / nan_poke_slot: before this step, NaN into the slot's
        most recent KV row.
    corrupt_at_step / corrupt_kind: silent corruption, once, at the first
        dispatch at or after the step: 'weight' flips ``corrupt_bit`` of
        one byte of a checksum-covered weight; 'kv' overwrites the
        ``kv_corrupt_slot``'s most recent KV row with a large finite value;
        'tile' zeroes a 128-wide out-channel slab of that weight (what a
        mis-delivered weight tile leaves).
    """

    kernel_raise_at_step: Optional[int] = None
    kernel_raise_count: int = 1
    step_delay_s: float = 0.0
    delay_at_steps: Tuple[int, ...] = ()
    nan_poke_step: Optional[int] = None
    nan_poke_slot: int = 0
    corrupt_at_step: Optional[int] = None
    corrupt_kind: str = "weight"    # 'weight' | 'kv' | 'tile'
    corrupt_bit: int = 6
    kv_corrupt_slot: int = 0

    # bookkeeping, reset by ``inject`` on entry
    raises_done: int = 0
    corrupt_done: bool = False
    log: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    undo: List[Callable[[], None]] = dataclasses.field(default_factory=list)

    def maybe_raise(self, step: int) -> None:
        """Called by the engine just before each decode dispatch."""
        if (self.kernel_raise_at_step is not None
                and step >= self.kernel_raise_at_step
                and self.raises_done < self.kernel_raise_count):
            self.raises_done += 1
            self.log.append((step, "kernel_raise"))
            raise InjectedKernelError(
                f"injected kernel failure at step {step} "
                f"({self.raises_done}/{self.kernel_raise_count})")

    def delay_s(self, step: int) -> float:
        if self.step_delay_s <= 0.0:
            return 0.0
        if self.delay_at_steps and step not in self.delay_at_steps:
            return 0.0
        self.log.append((step, "delay"))
        return self.step_delay_s

    def should_poke(self, step: int) -> bool:
        if self.nan_poke_step is not None and step == self.nan_poke_step:
            self.log.append((step, "nan_poke"))
            return True
        return False

    def should_corrupt(self, step: int) -> bool:
        """The one-shot silent-corruption trigger."""
        if (self.corrupt_at_step is not None and not self.corrupt_done
                and step >= self.corrupt_at_step):
            self.corrupt_done = True
            self.log.append((step, f"corrupt_{self.corrupt_kind}"))
            return True
        return False


# One active plan, context-scoped; the engine reads it through ``active()``.
_ACTIVE: List[Optional[FaultPlan]] = [None]


def active() -> Optional[FaultPlan]:
    return _ACTIVE[0]


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Scope in which the serving engine sees ``plan``: resets its
    bookkeeping on entry; on exit undoes the in-place corruptions made
    under it (newest first) and clears the slot."""
    plan.raises_done = 0
    plan.corrupt_done = False
    plan.log = []
    plan.undo = []
    prev, _ACTIVE[0] = _ACTIVE[0], plan
    try:
        yield plan
    finally:
        _ACTIVE[0] = prev
        while plan.undo:
            plan.undo.pop()()


def poke_nan(caches, slot: int, row: int):
    """NaN into ``row`` of ``slot`` of every layer's K and V (every KV dtype
    the port stores has a NaN). In place; returns the caches."""
    for c in caches:
        for t in c.values():
            t[slot, row] = float("nan")
    return caches


def perturb_kv_row(caches, slot: int, row: int, value: float = 448.0):
    """Overwrite ``row`` of ``slot`` with a large finite value in every
    layer's K and V: silent KV corruption (448 is e4m3's largest normal,
    so the write stays finite in every cache dtype). In place; returns the
    caches."""
    for c in caches:
        for t in c.values():
            t[slot, row] = value
    return caches


def _first_qleaf(params):
    """The first checksum-covered QTensor leaf: a rotation consumer
    (``w_down``), else a stacked leaf, else any QTensor."""
    from repro_torch.core import wquant

    found = []
    wquant._map_with_keys(
        lambda keys, t: found.append((keys, t)) if wquant.is_qleaf(t) else None, params)
    if not found:
        raise ValueError("params have no QTensor leaf to corrupt; build the model "
                         "with weight_quant='int8'")
    consumer = [t for k, t in found if wquant._is_consumer(k)]
    hot = [t for _, t in found if t.q.ndim >= 3]
    return (consumer or hot or [t for _, t in found])[0]


def _finite_after_flip(byte: int, bit: int, mode: str) -> bool:
    """Is the storage byte with ``bit`` flipped a finite value of ``mode``?
    (e4m3fn: 0x7f / 0xff are NaN; e5m2: an all-ones exponent is inf / NaN.)
    Flipping bit 6 of 0x3f gives 0x7f: NaN, the numeric guard's fault, not
    a silent one."""
    f = byte ^ (1 << bit)
    if mode == "fp8_e4m3":
        return (f & 0x7F) != 0x7F
    if mode == "fp8_e5m2":
        return (f & 0x7C) != 0x7C
    return True


def flip_weight_bit(params, *, bit: int = 6, flat_byte: Optional[int] = None):
    """Flip one bit of one byte of the first checksum-covered weight, in
    place: a single-event upset in weight memory. ``flat_byte`` picks the
    byte (default: the first byte from the middle of the leaf on whose
    flip the value stays finite, so the fault stays silent). Returns the
    undo callable."""
    t = _first_qleaf(params)
    raw = t.q.view(torch.uint8).reshape(-1)
    if flat_byte is None:
        mid = raw.numel() // 2
        window = raw[mid:mid + 256].cpu().numpy()
        hits = [i for i, b in enumerate(window) if _finite_after_flip(int(b), bit, t.mode)]
        if not hits:
            raise ValueError("no byte near the middle of the leaf flips to a finite value")
        flat_byte = mid + hits[0]
    old = raw[flat_byte:flat_byte + 1].clone()
    raw[flat_byte:flat_byte + 1].bitwise_xor_(1 << bit)

    def undo():
        raw[flat_byte:flat_byte + 1].copy_(old)

    return undo


def clobber_stream_tile(params, *, width: int = 128):
    """Zero a ``width``-wide out-channel slab in the middle of the first
    checksum-covered weight, in place: the footprint of a mis-delivered
    weight-stream tile (all finite, guard-invisible). Returns the undo
    callable."""
    t = _first_qleaf(params)
    d = t.q.shape[-1]
    w = min(width, d)
    lo = max(d // 2 - w // 2, 0)
    raw = t.q.view(torch.uint8)
    old = raw[..., lo:lo + w].clone()
    raw[..., lo:lo + w] = 0

    def undo():
        raw[..., lo:lo + w] = old

    return undo


def arrival_flood(num: int, *, prompt_len: int, max_new_tokens: int,
                  arrival_time: float = 0.0, deadline: Optional[float] = None,
                  vocab: int = 256, seed: int = 0, rid_base: int = 0) -> list:
    """A burst of ``num`` same-shape requests arriving at once: the overload
    pattern for bounded-queue rejection and deadline shedding."""
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=rid_base + i,
                    tokens=rng.integers(1, vocab, size=(prompt_len,)).astype(np.int32),
                    max_new_tokens=max_new_tokens, arrival_time=arrival_time,
                    deadline=deadline)
            for i in range(num)]
