"""Request-level scheduler for the continuous-batching engine (twin of
``repro.serving.scheduler``; host-only bookkeeping, no tensors).

    submit -> [bounded arrival queue | rejected]
           -> admit (free slot + arrived; expired queued requests are shed
                     before admission)
           -> prefill-insert (engine) -> decode steps -> retire
           (EOS / max-new-tokens / cache-full / deadline / guard or ABFT
            trip / engine failure)
           -> slot back on the free list

The free list gives retired slots back in LIFO order; admission is FCFS;
a step where the queue head has arrived but no slot is free counts one
``queue_full_stall``. ``now`` values pass through a monotonic high-water
mark, so a backwards clock jump cannot stall admission. Every transition
bumps ``kernels.registry.TRACE_COUNTS[("serving", <event>)]`` and the
scheduler's own counters, which also hold the engine's robustness
counts (``guard_trips``, ``sdc_retired``, ``degrades``, ``step_retries``,
``watchdog_trips``, ``deadline_retired``). Every Completion carries
``status``: 'ok', 'timed_out', 'rejected' or 'degraded'.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.kernels.registry import TRACE_COUNTS


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request; ``arrival_time`` and ``deadline`` are in
    decode-step units (the synthetic streams are step-clocked)."""

    rid: int
    tokens: np.ndarray              # (prompt_len,) int32 prompt ids
    max_new_tokens: int
    arrival_time: float = 0.0
    deadline: Optional[float] = None  # absolute step-clock TTL; None = none

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


@dataclasses.dataclass
class SlotState:
    """Host mirror of one active slot."""

    rid: int
    prompt_len: int
    pos: int                        # rows already in the slot's KV cache
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    admitted_step: int = 0
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    deadline: Optional[float] = None


# finish_reason -> Completion.status
STATUS_OF_REASON = {
    "eos": "ok",
    "length": "ok",
    "cache_full": "ok",
    "deadline": "timed_out",        # in-flight slot past its TTL
    "deadline_shed": "timed_out",   # shed from the queue, never admitted
    "queue_full": "rejected",       # bounded-queue backpressure
    "nan_guard": "degraded",        # the numeric guard tripped the slot
    "sdc_detected": "degraded",     # ABFT caught silent corruption
    "engine_failed": "degraded",    # the step failed beyond the ladder
    "shed_engine_failed": "degraded",  # queued when the ladder ran out
}


@dataclasses.dataclass(frozen=True)
class Completion:
    rid: int
    prompt_len: int
    tokens: Tuple[int, ...]         # generated ids (the first from prefill)
    finish_reason: str              # a STATUS_OF_REASON key
    admitted_step: int
    retired_step: int
    latencies_ms: Tuple[float, ...]
    status: str = "ok"              # 'ok' | 'timed_out' | 'rejected' | 'degraded'


class Scheduler:
    """Slot allocator + arrival queue: the engine owns the tensors, this
    class owns which request lives in which slot."""

    def __init__(self, num_slots: int, max_len: int, prefill_len: int,
                 max_queue: Optional[int] = None):
        if prefill_len > max_len:
            raise ValueError(f"prefill_len {prefill_len} > max_len {max_len}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue {max_queue} < 1")
        self.num_slots = num_slots
        self.max_len = max_len
        self.prefill_len = prefill_len
        self.max_queue = max_queue
        # LIFO free list, seeded so the first admissions get slots 0, 1, 2...
        self.free: List[int] = list(range(num_slots))[::-1]
        self.queue: Deque[Request] = collections.deque()
        self.active: Dict[int, SlotState] = {}
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self._clock = float("-inf")

    def _mono(self, now: float) -> float:
        """Clamp ``now`` to the monotonic high-water mark."""
        self._clock = max(self._clock, float(now))
        return self._clock

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> Optional[Completion]:
        """Enqueue; None on acceptance, or a ``rejected`` Completion when
        the bounded queue is full."""
        if req.prompt_len < 1 or req.prompt_len > self.prefill_len:
            raise ValueError(
                f"request {req.rid}: prompt_len {req.prompt_len} outside "
                f"[1, prefill_len={self.prefill_len}]")
        if req.max_new_tokens < 1 or \
                req.prompt_len + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt_len + max_new_tokens "
                f"{req.prompt_len + req.max_new_tokens} > max_len "
                f"{self.max_len} (or max_new_tokens < 1)")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.counters["rejected"] += 1
            TRACE_COUNTS[("serving", "queue_reject")] += 1
            return self._unadmitted_completion(req, "queue_full")
        self.queue.append(req)
        self.counters["submitted"] += 1
        return None

    def _unadmitted_completion(self, req: Request, reason: str) -> Completion:
        now = self._clock if self._clock > float("-inf") else 0.0
        return Completion(
            rid=req.rid, prompt_len=req.prompt_len, tokens=(),
            finish_reason=reason, admitted_step=-1, retired_step=int(now),
            latencies_ms=(), status=STATUS_OF_REASON[reason])

    # --------------------------------------------------------- admission
    def shed_expired(self, now: float,
                     reason: str = "deadline_shed") -> List[Completion]:
        """Drop every queued request whose deadline has passed."""
        now = self._mono(now)
        shed: List[Completion] = []
        if not self.queue:
            return shed
        keep: Deque[Request] = collections.deque()
        for req in self.queue:
            if req.deadline is not None and req.deadline <= now:
                self.counters["shed"] += 1
                TRACE_COUNTS[("serving", "deadline_shed")] += 1
                shed.append(self._unadmitted_completion(req, reason))
            else:
                keep.append(req)
        self.queue = keep
        return shed

    def next_admission(self, now: float) -> Optional[Tuple[int, Request]]:
        """Pop (slot, request) if the queue head has arrived and a slot is
        free; None otherwise (a stall is counted when work waits on slots)."""
        now = self._mono(now)
        if not self.queue or self.queue[0].arrival_time > now:
            return None
        if not self.free:
            self.counters["queue_full_stalls"] += 1
            TRACE_COUNTS[("serving", "queue_full_stall")] += 1
            return None
        req = self.queue.popleft()
        slot = self.free.pop()
        self.active[slot] = SlotState(
            rid=req.rid, prompt_len=req.prompt_len, pos=req.prompt_len,
            max_new_tokens=req.max_new_tokens, admitted_step=int(now),
            deadline=req.deadline)
        self.counters["admitted"] += 1
        TRACE_COUNTS[("serving", "admit")] += 1
        return slot, req

    # -------------------------------------------------------- retirement
    def retire(self, slot: int, finish_reason: str, now: float) -> Completion:
        st = self.active.pop(slot)
        self.free.append(slot)          # immediate LIFO reuse
        self.counters["retired"] += 1
        TRACE_COUNTS[("serving", "retire")] += 1
        return Completion(
            rid=st.rid, prompt_len=st.prompt_len,
            tokens=tuple(st.generated), finish_reason=finish_reason,
            admitted_step=st.admitted_step, retired_step=int(now),
            latencies_ms=tuple(st.latencies_ms),
            status=STATUS_OF_REASON[finish_reason])

    # ------------------------------------------------------------- state
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active)

    def next_arrival(self) -> Optional[float]:
        return self.queue[0].arrival_time if self.queue else None

    @property
    def occupancy(self) -> float:
        return len(self.active) / max(self.num_slots, 1)
