"""Continuous-batching serving engine over pre-quantized QTensor weights
(twin of ``repro.serving.engine``).

Three device operations, all with fixed shapes:

  prefill  one request's prompt, right-padded to the prefill bucket P;
           under the causal mask the padding never reaches positions
           < length, so the first token is the argmax at length-1.
  insert   the newcomer's KV rows into its slot (``serving.cache``).
  decode   one step over ALL slots with a (slots,) position vector:
           every slot writes and attends at its own depth.

The KV cache is allocated once and updated in place; admissions,
retirements and slot reuse are host-side scheduler bookkeeping
(``serving.scheduler``). With ``cfg.weight_quant == 'int8'`` the weights
are pre-quantized QTensors and serving performs no ``quantize_weight``
call. ``warmup()`` runs one dummy prefill + insert + decode first, so the
kernels' build and the first-use costs stay out of request latencies; a
kernel that fails to build or launch there raises. The decode step runs
eagerly (capturing it as a CUDA graph is later work).

Robustness (the reference's hardened serving and ABFT layers, its
DESIGN.md sections 12 and 14):

  * request lifecycle -- deadlines (expired queued requests shed, in-flight
    slots retired ``timed_out``), a bounded queue (``max_queue``) whose
    overflow is ``rejected`` at once;
  * degradation ladder -- a decode step that raises is retried once (the
    fault hooks fire before the step; a step that fails part-way rewrites
    the same rows with the same values when it runs again), then the
    engine moves one rung down: cuda + streamed (or revisit) -> cuda +
    rotate-once, and on the CPU -> torch (the plain versions). On the card
    no rung swaps a kernel for its plain version: the schedules are
    bitwise equal, and below the last kernel rung the step has failed. A rung
    change is loud: a warning, the ``degrades`` counter and
    ``health()["rung"]``. Below the last rung the in-flight requests fail
    (``engine_failed``) and the queue is shed; the caller never sees the
    raise, ``launch/serve_loop.py`` exits non-zero;
  * watchdog -- ``watchdog_ms`` bounds a step's wall time after the fact
    (a step cannot be preempted; its result is used), and two slow steps
    in a row move one rung down;
  * numeric guards (``REPRO_NUMERIC_GUARDS=1``) -- the guarded prefill and
    decode also return ``core.guards.rows_ok`` of the logits per slot (of
    the real vocabulary: the padding columns hold -inf by design, which
    the reference's guard counts as a trip); a tripped slot retires as
    ``nan_guard`` without emitting its token.
    Guards-off steps run unchanged, and guards never change a healthy
    token;
  * ABFT (``REPRO_ABFT=1`` or ``QuantConfig.abft``) -- the weights get
    their column checksums (``verify.with_checks``), every fused
    quant_dot site runs its verified twin and NaN-poisons failing rows
    (so the guarded step sees them), and a per-slot KV conservation sum is
    checked before and rolled after each decode step. A KV trip retires
    the slot as ``sdc_detected``; a logits trip is ``sdc_detected`` when
    the live weights no longer match their checksums (``verify.params_ok``)
    and ``nan_guard`` otherwise. Two SDC detections within
    ``_SDC_WINDOW_STEPS`` steps move one rung down. A healthy ABFT-on run
    is bitwise the ABFT-off run (exact selects only).

Fault injection (``repro_torch.testing.faults``): a context-scoped
``FaultPlan`` that the engine polls at each decode step -- kernel raises,
step latency, NaN pokes, silent weight / KV / tile corruption.
``health()`` reports the robustness counters of this engine.

On a mesh (``mesh=``: a ``launch.mesh.Mesh`` over the process group; the
launchers' layout, ``launch.steps``): each rank holds its shards of the
weights (``param_parts``), every layer gathered just before it runs, and
the slots split over ``batch_row_axes(mesh, num_slots)`` in the mesh's
chunk order; a rank's KV caches (and ABFT sums) hold only its slots. Over
'model' every layer is tensor-parallel (``models.lm``; a MoE layer's
experts too, whose checksum-verified K7b verdicts reach every rank through
the combine's sum: a poisoned row is NaN on all of them): a rank's caches
hold its KV heads
(``serving.cache``), and its ABFT KV check covers them, the verdicts agreed
over 'model' (a slot is sound when every rank's heads of it are); the
logits are whole on every rank. The host state --
scheduler, positions, completions, counters -- is the same on every rank:

  * prefill runs on EVERY rank (its layer gathers are collectives); the
    rank that owns the slot inserts the caches, and its token and guard
    verdict are taken on every rank;
  * each rank decodes its slots; the new tokens and the per-slot guard /
    ABFT verdicts are all-gathered, so every rank retires, degrades and
    counts the same at the same step;
  * the watchdog reads the all-reduce MAX of the ranks' step times;
  * the pre-step fault hooks (a ``FaultPlan`` raise or delay) are agreed
    before the step: a hook that raises on any rank fails the attempt on
    every rank, which retry and walk the ladder in lockstep. A step that
    raises on one rank alone cannot be: its peers wait in a collective. It
    raises ``RankStepError`` out of ``run`` on that rank, and the peers'
    collective fails when the connection closes or at the process group's
    timeout (``launch.mesh.init_distributed``), so every rank ends non-zero;
  * a silent weight corruption of a ``FaultPlan`` lands in each rank's own
    shard; the ABFT weight audit (``verify.params_ok``) gathers the
    weights a layer at a time.

``summary()`` and ``health()`` are then the global counts (a world-1
engine's); the times are each rank's.

Per-launch sharding rules (``rules_overrides``: the reference's argument;
the presets ``launch.dryrun.decode_rules`` and ``FSDP_ONLY_RULES``): the
engine resolves its weight shards, its slot split and its caches, and runs
every prefill, insert, decode, guard and ABFT step, under the default rules
updated by them (``distributed.sharding.sharding_rules``); off a mesh they
change nothing. Where they split the KV cache's sequence ('kvseq',
``serving.cache.seq_split``) a rank holds ``max_len / D`` rows of each of
its slots: it inserts the prompt rows it owns, the decode step writes row
``pos`` on its owner and merges the ranks' partial attention
(``models.attention``), and the ABFT KV sums are each rank's share, the
verdicts agreed as the heads' are (a fault in one rank's rows retires the
slot everywhere). Where they split the experts over the slots' own axes
(``decode_rules`` for MoE) each MoE layer gathers the rows first
(``models.mlp``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

import torch.distributed as dist

from repro_torch import verify
from repro_torch.core import guards, wquant
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import gather_tree, shard_tree
from repro_torch.distributed.sharding import (WHOLE, kvseq_row, local_kvseq, local_rows,
                                              sharding_rules)
from repro_torch.kernels.registry import TRACE_COUNTS, warn_once
from repro_torch.launch.steps import batch_row_axes, decode_tokens
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import lm_forward, param_parts
from repro_torch.serving.cache import alloc_kv_caches, cache_bytes, insert_kv, seq_split
from repro_torch.serving.scheduler import Completion, Request, Scheduler
from repro_torch.testing import faults

# TRACE_COUNTS keys snapshotted at construction, so ``health()`` reports
# this engine's share of the process-wide counters.
_HEALTH_TRACE_KEYS = (
    ("abft", "kv_trip"),
    ("abft", "sdc_detected"),
    ("abft", "params_check"),
    ("serving", "guard_trip"),
    ("serving", "watchdog_trip"),
    ("serving", "step_retry"),
    ("serving", "deadline_retire"),
)

# Two SDC detections within this many steps move the ladder one rung.
_SDC_WINDOW_STEPS = 16


class RankStepError(RuntimeError):
    """A decode step raised on this rank of a mesh, past the point where
    its peers could retry with it: the engine cannot recover in lockstep."""


class PeerHookError(RuntimeError):
    """A pre-step fault hook raised on another rank of the mesh."""


_SUPPORTED_KINDS = ("attn", "moe")


def _validate_config(cfg: ModelConfig) -> None:
    """Continuous batching needs position-addressable per-token caches and
    causal attention (right-padded prefill is exact only then): stacks of
    'attn' and 'moe' layers, and neither an encoder-decoder nor a vlm (the
    engine's batches carry tokens only), as the reference rules. (A MoE
    layer's capacity counts the padding too, but only after the real
    tokens, so it never drops one of them.)"""
    kinds = set(cfg.layer_kinds)
    if not kinds <= set(_SUPPORTED_KINDS) or cfg.is_encdec or cfg.family == "vlm":
        raise ValueError(
            f"serving engine supports causal attention stacks only "
            f"(kinds {_SUPPORTED_KINDS}); config {cfg.name!r} has "
            f"kinds={sorted(kinds)} family={cfg.family!r} "
            f"encdec={cfg.is_encdec}")


def _degradation_ladder(cfg: ModelConfig, device: torch.device) -> List[ModelConfig]:
    """The rungs, most capable first: cuda + streamed (or revisit) -> cuda +
    rotate-once, then, on the CPU only, torch (the plain versions). On the
    card the ladder never leaves the kernels: a failure below the last
    kernel rung fails the requests instead. A config already on 'torch'
    has no lower rung."""
    ladder = [cfg]
    q = cfg.quant
    if q.backend in ("cuda", "auto") and q.schedule != "rotate_once":
        ladder.append(cfg.with_quant(dataclasses.replace(q, schedule="rotate_once")))
    if device.type == "cpu" and q.backend in ("cuda", "auto", "ref"):
        ladder.append(cfg.with_quant(dataclasses.replace(q, backend="torch", schedule=None)))
    return ladder


def _rung_name(cfg: ModelConfig) -> str:
    q = cfg.quant
    if q.backend == "torch":
        return "torch"
    return q.schedule or "default"


class ServeEngine:
    """Drives prefill / insert / decode over a request stream on
    ``device`` (the params must already live there). ``mesh``: serve on
    it (module docstring); ``params`` are then the whole model, of which
    the engine keeps this rank's shards. ``rules_overrides``: the sharding
    rules' overrides it serves under (module docstring)."""

    def __init__(self, cfg: ModelConfig, params, *, num_slots: int,
                 max_len: int, prefill_len: int, eos_id: Optional[int] = None,
                 device="cuda", max_queue: Optional[int] = None,
                 watchdog_ms: Optional[float] = None, mesh=None,
                 rules_overrides: Optional[Dict[str, Any]] = None):
        _validate_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.eos_id = eos_id
        self.prefill_len = prefill_len
        self.max_len = max_len
        self.sched = Scheduler(num_slots, max_len, prefill_len, max_queue=max_queue)
        self._guard = guards.guards_enabled()
        self._abft = bool(cfg.quant.abft) or verify.abft_enabled()
        # ABFT: weights quantized without checksums get them here, once
        params = verify.with_checks(params) if self._abft else params
        self.mesh = mesh
        self.rules_overrides = rules_overrides
        self._rows: tuple = ()                  # the mesh axes the slots split over
        self._slots = np.arange(num_slots)      # the slots this rank decodes
        self._seq = WHOLE                       # this rank's share of the cache rows
        if mesh is not None:
            with self._rules():
                self._parts = param_parts(cfg, mesh)
                params = shard_tree(params, self._parts, mesh)
                self._rows = batch_row_axes(mesh, num_slots)
                self._seq = seq_split(cfg, num_slots, max_len)
            self._slots = mesh.chunk(torch.arange(num_slots), self._rows, 0).numpy()
        self._local = {int(s): i for i, s in enumerate(self._slots)}
        self.params = params
        # the ONE cache allocation of the engine's lifetime (this rank's
        # slots, its share of their rows)
        with self._rules(), self._kv_rows():
            self.caches = alloc_kv_caches(cfg, len(self._slots), max_len, self.device, mesh)
        # ABFT KV conservation state: per slot [sum, abs_sum] of its valid rows
        self.kv_sums = (torch.zeros((len(self._slots), 2), dtype=torch.float32,
                                    device=self.device) if self._abft else None)
        self.tokens_h = np.zeros((num_slots, 1), np.int64)
        self.positions_h = np.zeros((num_slots,), np.int64)

        self._ladder = _degradation_ladder(cfg, self.device)
        self._rung = 0
        self._run_cfg = cfg
        self._sdc_trips: collections.deque = collections.deque(maxlen=8)
        self._params_check_step = -1
        self._params_check_ok = True
        self._trace_base = {k: TRACE_COUNTS[k] for k in _HEALTH_TRACE_KEYS}
        self._watchdog_ms = watchdog_ms
        self._watchdog_skip = 0
        self._consec_slow = 0

        self.step = 0
        self.completions: List[Completion] = []
        self.prefill_calls = 0        # model passes, warm-up included
        self.decode_calls = 0
        self._step_latencies_ms: List[float] = []
        self._occupancy: List[float] = []
        self._decode_s = 0.0
        self._warmup_s: Optional[float] = None
        self._idle_steps = 0
        self._qw_calls_baseline = wquant.QUANTIZE_WEIGHT_CALLS

    @property
    def _guarded(self) -> bool:
        # ABFT surfaces its kernel trips as NaN rows: it needs the guard seam
        return self._guard or self._abft

    # ------------------------------------------------------------- mesh
    def _rules(self):
        """The engine's sharding rules on its mesh; none off a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return sharding_rules(self.mesh, self.rules_overrides)

    def _kv_rows(self):
        """The context in which the caches hold this rank's share of their
        rows (``sharding.local_kvseq``): every op that reads or writes
        them runs in it."""
        return local_kvseq(self._seq)

    def _on_mesh(self, rows):
        """The sharding context of a device op whose batch rows split over
        ``rows`` (``()``: every rank holds every row); none off a mesh."""
        stack = contextlib.ExitStack()
        if self.mesh is not None:
            stack.enter_context(self._rules())
            stack.enter_context(local_rows(rows))
        return stack

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's per-slot values, in slot order."""
        return t if self.mesh is None else self.mesh.gather(t, self._rows, 0)

    def _agree(self, ok: torch.Tensor) -> torch.Tensor:
        """Per-slot verdicts of this rank's slots, each true only where it
        is on every rank that holds the slot (their KV heads differ under
        tensor parallelism, their cache rows under a 'kvseq' split); ``ok``
        off a mesh."""
        if self.mesh is None:
            return ok
        others = tuple(a for a in self.mesh.axis_names if a not in self._rows)
        if self.mesh.group_size(others) == 1:
            return ok
        t = self.mesh.all_reduce(ok.to(torch.int32), others, dist.ReduceOp.MIN)
        return t.bool()

    def _max(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum over every rank of the mesh (``t`` off a mesh)."""
        if self.mesh is None:
            return t
        return self.mesh.all_reduce(t, self.mesh.axis_names, dist.ReduceOp.MAX)

    def _owns(self, slot: int) -> bool:
        return slot in self._local

    def _local_row(self, row: int) -> Optional[int]:
        """Cache row ``row`` within this rank's share of the rows; None
        where another rank holds it (or ``row`` is negative)."""
        with self._kv_rows():
            local, mine = kvseq_row(row, self.caches[0]["k"].shape[1])
        return local if mine and row >= 0 else None

    def _insert(self, slot: int, kv) -> None:
        """Write a prefill's KV block into ``slot``'s rows this rank holds
        (none where another rank holds the slot)."""
        if self._owns(slot):
            with self._kv_rows():
                insert_kv(self.caches, kv, self._local[slot])

    # --------------------------------------------------------- device ops
    @torch.inference_mode()
    def _prefill(self, padded: np.ndarray, length: int):
        """(1, P) right-padded prompt -> (first token, per-layer KV), or,
        guarded, (first token, ok (1,) bool, per-layer KV). On a mesh every
        rank runs it."""
        self.prefill_calls += 1
        tokens = torch.from_numpy(padded).to(self.device)
        with self._on_mesh(()):
            logits, _, kv = lm_forward(self._run_cfg, self.params, {"tokens": tokens},
                                       want_cache=True)
        last = logits[:, length - 1]
        tok = torch.argmax(last[0])
        if self._guarded:
            return tok, guards.rows_ok(last[:, :self.cfg.vocab_size], 1), kv
        return tok, kv

    @torch.inference_mode()
    def _decode(self):
        """One step over every slot -> (slots,) next tokens, or, guarded,
        (tokens, ok (slots,) bool); on a mesh over this rank's slots, the
        results gathered from every rank."""
        self.decode_calls += 1
        tokens = torch.from_numpy(self.tokens_h[self._slots]).to(self.device)
        pos = torch.from_numpy(self.positions_h[self._slots]).to(self.device)
        with self._on_mesh(self._rows), self._kv_rows():
            tok, ok, self.caches = decode_tokens(self._run_cfg, self.params, self.caches,
                                                 tokens, pos, self._guarded)
        if self._guarded:
            return self._gather(tok), self._gather(ok)
        return self._gather(tok)

    # ---------------------------------------------------------- warm-up
    def warmup(self) -> float:
        """One dummy prefill + insert + decode before serving, so no
        request's latency includes the kernels' build or first-use costs;
        a kernel that fails to build or launch raises here. It writes
        garbage into slot 0's rows, which are never attended before being
        overwritten (insert rewrites [0, P) on admission; decode rewrites
        row ``pos`` before attending it). The ABFT state stays zero: every
        slot is re-anchored when it is admitted."""
        if self._warmup_s is not None:
            return self._warmup_s
        t0 = time.perf_counter()
        out = self._prefill(np.zeros((1, self.prefill_len), np.int64), 1)
        with self._kv_rows():
            insert_kv(self.caches, out[-1], 0)
        out = self._decode()
        int((out[0] if self._guarded else out)[0])
        if self._abft:
            pos = torch.zeros(len(self._slots), dtype=torch.long, device=self.device)
            with self._kv_rows():
                _, cur = verify.kv_check(self.caches, pos, self.kv_sums)
                verify.kv_roll(self.caches, pos, cur).sum().item()
        self._warmup_s = time.perf_counter() - t0
        self._qw_calls_baseline = wquant.QUANTIZE_WEIGHT_CALLS
        return self._warmup_s

    # ------------------------------------------------------- degradation
    def _bind_rung(self, i: int) -> None:
        self._rung = i
        self._run_cfg = self._ladder[i]

    def _degrade(self, why: str) -> bool:
        """Move one rung down the ladder, loudly; False when there is none.
        The next step is exempt from the watchdog."""
        if self._rung + 1 >= len(self._ladder):
            warn_once(("serving", "ladder_exhausted"),
                      f"serving degradation ladder exhausted ({why}); a decode "
                      "step that fails now fails the in-flight requests (warned "
                      "once per process; TRACE_COUNTS[('serving', "
                      "'ladder_exhausted')] keeps counting)")
            return False
        self._bind_rung(self._rung + 1)
        name = _rung_name(self._run_cfg)
        self.sched.counters["degrades"] += 1
        warn_once(("serving", f"degrade_{name}"),
                  f"serving engine degraded to rung '{name}' ({self._rung + 1}/"
                  f"{len(self._ladder)}) after {why} (warned once per process; "
                  f"TRACE_COUNTS[('serving', 'degrade_{name}')] keeps counting)")
        self._watchdog_skip = 1
        self._consec_slow = 0
        return True

    def _fail_inflight(self, why: str) -> None:
        """Ladder exhausted: retire every active slot and shed the queue,
        all as ``degraded``; the engine never raises to the caller."""
        now = float(self.step)
        TRACE_COUNTS[("serving", "ladder_exhausted")] += 1
        for slot in sorted(self.sched.active):
            self.completions.append(self.sched.retire(slot, "engine_failed", now))
        queued = list(self.sched.queue)
        self.sched.queue.clear()
        self.sched.counters["shed"] += len(queued)
        for req in queued:
            self.completions.append(
                self.sched._unadmitted_completion(req, "shed_engine_failed"))

    # --------------------------------------------------------- lifecycle
    def submit(self, req: Request) -> Optional[Completion]:
        """None on acceptance, or the ``rejected`` completion (also kept in
        ``self.completions``) when the bounded queue pushes back."""
        rejected = self.sched.submit(req)
        if rejected is not None:
            self.completions.append(rejected)
        return rejected

    def _admit(self, slot: int, req: Request) -> None:
        padded = np.zeros((1, self.prefill_len), np.int64)
        padded[0, :req.prompt_len] = req.tokens
        t0 = time.perf_counter()
        out = self._prefill(padded, req.prompt_len)
        tok, kv = out[0], out[-1]
        ok = out[1][0] if self._guarded else None
        if self.mesh is not None:
            # the owner's token and verdict on every rank (the others'
            # prefill computed the same; the host state must not part)
            own = torch.full((2,), -1, dtype=torch.long, device=self.device)
            if self._owns(slot):
                own = torch.stack([tok, torch.ones_like(tok) if ok is None else ok.long()])
            tok, flag = self._max(own)
            ok = None if ok is None else flag.bool()
        if ok is not None and not bool(ok):
            # poisoned prefill: never insert, never emit
            self.completions.append(self.sched.retire(
                slot, self._trip_reason(), float(self.step)))
            return
        self._insert(slot, kv)
        tok_h = int(tok)                  # waits for the device
        dt_ms = (time.perf_counter() - t0) * 1e3
        TRACE_COUNTS[("serving", "prefill_insert")] += 1
        self.sched.counters["prefill_inserts"] += 1
        st = self.sched.active[slot]
        st.generated.append(tok_h)
        st.latencies_ms.append(dt_ms)
        self.tokens_h[slot, 0] = tok_h
        self.positions_h[slot] = st.pos
        if self._abft and self._owns(slot):
            # insert rewrote the slot's rows: re-anchor its conservation sum
            with self._kv_rows():
                verify.kv_slot_reset(self.kv_sums, self.caches, self._local[slot], st.pos)
        self._maybe_retire(slot, tok_h)

    def _maybe_retire(self, slot: int, last_tok: int) -> bool:
        st = self.sched.active[slot]
        reason = None
        if self.eos_id is not None and last_tok == self.eos_id:
            reason = "eos"
        elif len(st.generated) >= st.max_new_tokens:
            reason = "length"
        elif st.pos >= self.max_len:
            reason = "cache_full"
        if reason is None:
            return False
        self.completions.append(
            self.sched.retire(slot, reason, float(self.step)))
        return True

    def _retire_expired_inflight(self, now: float) -> None:
        for slot in sorted(self.sched.active):
            st = self.sched.active[slot]
            if st.deadline is not None and st.deadline <= now:
                self.sched.counters["deadline_retired"] += 1
                TRACE_COUNTS[("serving", "deadline_retire")] += 1
                self.completions.append(
                    self.sched.retire(slot, "deadline", now))

    # -------------------------------------------------------------- run
    def run(self, requests: Sequence[Request]) -> List[Completion]:
        """Serve a whole arrival stream to completion; returns the
        completion records (also accumulated on ``self.completions``)."""
        self.warmup()
        for req in requests:
            self.submit(req)
        while self.sched.has_work():
            now = float(self.step)
            self.completions.extend(self.sched.shed_expired(now))
            self._retire_expired_inflight(now)
            while True:
                adm = self.sched.next_admission(now)
                if adm is None:
                    break
                self._admit(*adm)
            if not self.sched.active:
                nxt = self.sched.next_arrival()
                if nxt is None:
                    break
                # idle: jump the step clock to the next arrival
                self.step = max(self.step + 1, int(np.ceil(nxt)))
                self._idle_steps += 1
                continue
            self._decode_step()
        return self.completions

    # ------------------------------------------------------ fault hooks
    def _inject_faults(self) -> None:
        """This step's scheduled state corruptions, at the top of the step
        (before the ABFT KV check reads the caches), like a flip that
        landed between two steps."""
        plan = faults.active()
        if plan is None:
            return
        if plan.should_poke(self.step):
            row = self._local_row(int(self.positions_h[plan.nan_poke_slot]) - 1)
            if row is not None and self._owns(plan.nan_poke_slot):
                faults.poke_nan(self.caches, self._local[plan.nan_poke_slot], row)
        if plan.should_corrupt(self.step):
            kind = plan.corrupt_kind
            if kind == "weight":
                plan.undo.append(faults.flip_weight_bit(self.params, bit=plan.corrupt_bit))
            elif kind == "tile":
                plan.undo.append(faults.clobber_stream_tile(self.params))
            elif kind == "kv":
                row = self._local_row(int(self.positions_h[plan.kv_corrupt_slot]) - 1)
                if row is not None and self._owns(plan.kv_corrupt_slot):
                    faults.perturb_kv_row(self.caches, self._local[plan.kv_corrupt_slot],
                                          row)
            else:
                raise ValueError(f"unknown corrupt_kind {kind!r}")

    def _dispatch_decode(self):
        """One decode step at the current rung, with the per-attempt fault
        hooks (delay, raise) before it. On a mesh the hooks' outcome is
        agreed first (a hook that raised anywhere fails the attempt on
        every rank), and a raise in the step itself is ``RankStepError``."""
        plan = faults.active()
        err = None
        try:
            if plan is not None:
                d = plan.delay_s(self.step)
                if d > 0.0:
                    time.sleep(d)
                plan.maybe_raise(self.step)
        except Exception as e:   # noqa: BLE001 -- re-raised below, after agreeing
            err = e
        if self.mesh is not None:
            failed = self._max(torch.tensor(int(err is not None), device=self.device))
            if err is None and int(failed):
                err = PeerHookError(f"a pre-step hook raised on another rank at "
                                    f"step {self.step}")
        if err is not None:
            raise err
        if self.mesh is None:
            return self._decode()
        try:
            return self._decode()
        except Exception as e:   # noqa: BLE001 -- its peers cannot retry with it
            raise RankStepError(f"decode step {self.step} raised on rank "
                                f"{self.mesh.rank}: {e!r}") from e

    def _attempt(self):
        """(result, None), or (None, the exception) when the attempt failed
        in a way every rank retries; a ``RankStepError`` propagates."""
        try:
            return self._dispatch_decode(), None
        except RankStepError:
            raise
        except Exception as e:   # noqa: BLE001 -- any step failure is recovered
            return None, e

    def _decode_with_recovery(self):
        """Run the step; on failure retry it once on the same rung, then
        walk the ladder. None when every rung failed."""
        out, first = self._attempt()
        if first is None:
            return out
        self.sched.counters["step_retries"] += 1
        TRACE_COUNTS[("serving", "step_retry")] += 1
        out, err = self._attempt()
        if err is None:
            return out
        while self._degrade(f"decode failure: {first!r}"):
            out, err = self._attempt()
            if err is None:
                return out
        return None

    # -------------------------------------------------------------- abft
    def _weights_corrupt(self) -> bool:
        """After a logits trip: do the live weights still match their
        checksums? Checked once per step however many slots tripped."""
        if self._params_check_step != self.step:
            self._params_check_step = self.step
            TRACE_COUNTS[("abft", "params_check")] += 1
            self._params_check_ok = self._params_ok()
        return not self._params_check_ok

    def _params_ok(self) -> bool:
        """``verify.params_ok`` of the whole weights: on a mesh gathered a
        top-level entry or a layer at a time (a collective)."""
        if self.mesh is None:
            return verify.params_ok(self.params)
        ok = True
        for key, sub in self.params.items():
            parts = self._parts[key]
            pieces = zip(sub, parts) if isinstance(sub, list) else [(sub, parts)]
            for tree, pp in pieces:
                ok = verify.params_ok(gather_tree(tree, pp, self.mesh)) and ok
        return ok

    def _trip_reason(self) -> str:
        """The retirement reason of a logits trip, with its counters: with
        ABFT on, ``sdc_detected`` when the weights no longer match their
        checksums; ``nan_guard`` otherwise."""
        if self._abft and self._weights_corrupt():
            self._note_sdc()
            return "sdc_detected"
        self.sched.counters["guard_trips"] += 1
        TRACE_COUNTS[("serving", "guard_trip")] += 1
        return "nan_guard"

    def _note_sdc(self) -> None:
        """Record an SDC detection; two within ``_SDC_WINDOW_STEPS`` steps
        move one rung down (a sick kernel path clears; corruption that
        persists exhausts the ladder, loudly)."""
        TRACE_COUNTS[("abft", "sdc_detected")] += 1
        self.sched.counters["sdc_retired"] += 1
        self._sdc_trips.append(self.step)
        if sum(self.step - s <= _SDC_WINDOW_STEPS for s in self._sdc_trips) >= 2:
            self._sdc_trips.clear()
            self._degrade("repeated ABFT SDC detections")

    def _abft_rebase_slot(self, slot: int) -> None:
        """Re-anchor a slot retired mid-trip to the cache as it is now: its
        position stops advancing, so it verifies trivially until reuse."""
        if self._owns(slot):
            with self._kv_rows():
                verify.kv_slot_reset(self.kv_sums, self.caches, self._local[slot],
                                     int(self.positions_h[slot]))

    def _decode_step(self) -> None:
        t0 = time.perf_counter()
        self._inject_faults()
        pos = kv_ok = cur = None
        if self._abft:
            # the integrity gate on the caches the step is about to read
            pos = torch.from_numpy(self.positions_h[self._slots]).to(self.device)
            with self._kv_rows():
                kv_ok, cur = verify.kv_check(self.caches, pos, self.kv_sums)
            kv_ok = self._gather(self._agree(kv_ok))
        out = self._decode_with_recovery()
        if out is None:
            self._fail_inflight("decode failed on every ladder rung")
            return
        new_tok, ok = out if self._guarded else (out, None)
        if self._abft:
            # roll the state over the row the step wrote per slot
            with self._kv_rows():
                self.kv_sums = verify.kv_roll(self.caches, pos, cur)
        new_tok_h = new_tok.cpu().numpy()       # waits for the device
        ok_h = ok.cpu().numpy() if ok is not None else None
        kv_ok_h = kv_ok.cpu().numpy() if kv_ok is not None else None
        dt_ms = (time.perf_counter() - t0) * 1e3
        if self.mesh is not None:
            # the watchdog reads the slowest rank's step
            dt_ms = float(self._max(torch.tensor(dt_ms, dtype=torch.float64,
                                                 device=self.device)))
        self._decode_s += dt_ms * 1e-3
        self._step_latencies_ms.append(dt_ms)
        self._occupancy.append(self.sched.occupancy)
        self.step += 1
        self._watchdog(dt_ms)
        for slot in sorted(self.sched.active):
            st = self.sched.active[slot]
            reason = None
            if kv_ok_h is not None and not kv_ok_h[slot]:
                # finite KV mismatch: silent corruption of written rows
                TRACE_COUNTS[("abft", "kv_trip")] += 1
                self._note_sdc()
                reason = "sdc_detected"
            elif ok_h is not None and not ok_h[slot]:
                reason = self._trip_reason()
            if reason is not None:
                self.completions.append(self.sched.retire(slot, reason, float(self.step)))
                if self._abft:
                    self._abft_rebase_slot(slot)
                continue
            tok = int(new_tok_h[slot])
            st.generated.append(tok)
            st.latencies_ms.append(dt_ms)
            st.pos += 1
            self.tokens_h[slot, 0] = tok
            self.positions_h[slot] = st.pos
            self._maybe_retire(slot, tok)

    def _watchdog(self, dt_ms: float) -> None:
        """After-the-fact step bound: a slow step's result is used; two in
        a row move one rung down."""
        if self._watchdog_ms is None:
            return
        if self._watchdog_skip > 0:      # the first step on a new rung
            self._watchdog_skip -= 1
            return
        if dt_ms <= self._watchdog_ms:
            self._consec_slow = 0
            return
        self._consec_slow += 1
        self.sched.counters["watchdog_trips"] += 1
        TRACE_COUNTS[("serving", "watchdog_trip")] += 1
        if self._consec_slow >= 2:
            self._consec_slow = 0
            self._degrade(f"watchdog: 2 consecutive steps over {self._watchdog_ms} ms")

    # ------------------------------------------------------ observability
    def quantize_weight_calls_during_serve(self) -> int:
        """quantize_weight calls since warm-up (0 on the prequant path)."""
        return wquant.QUANTIZE_WEIGHT_CALLS - self._qw_calls_baseline

    def health(self) -> Dict[str, int]:
        """This engine's robustness counters: ladder, watchdog, guards and
        ABFT (process-wide TRACE_COUNTS as deltas since construction)."""
        delta = {k: int(TRACE_COUNTS[k] - self._trace_base[k]) for k in _HEALTH_TRACE_KEYS}
        c = self.sched.counters
        return {
            "abft_enabled": int(self._abft),
            "guards_enabled": int(self._guard),
            "rung": int(self._rung),
            "degrades": int(c.get("degrades", 0)),
            "watchdog_trips": int(c.get("watchdog_trips", 0)),
            "step_retries": int(c.get("step_retries", 0)),
            "deadline_retired": int(c.get("deadline_retired", 0)),
            "nan_guard_trips": int(c.get("guard_trips", 0)),
            "sdc_retired": int(c.get("sdc_retired", 0)),
            "abft_kv_trips": delta[("abft", "kv_trip")],
            "abft_sdc_detections": delta[("abft", "sdc_detected")],
            "abft_params_checks": delta[("abft", "params_check")],
        }

    def summary(self) -> Dict[str, Any]:
        # per-token latencies: decode-produced tokens only (index 0 is the
        # prefill-produced first token, whose cost is the admission)
        lat = np.asarray([ms for c in self.completions
                          for ms in c.latencies_ms[1:]] or [0.0])
        gen = sum(len(c.tokens) for c in self.completions)
        gen_decode = sum(max(len(c.tokens) - 1, 0) for c in self.completions)
        by_status: Dict[str, int] = {}
        for c in self.completions:
            by_status[c.status] = by_status.get(c.status, 0) + 1
        with self._rules(), self._kv_rows():
            rank_bytes = cache_bytes(self.cfg, len(self._slots), self.max_len, self.mesh)
        return {
            "requests": len(self.completions),
            "generated_tokens": gen,
            "decode_steps": len(self._step_latencies_ms),
            "idle_steps": self._idle_steps,
            "tokens_per_s": (gen_decode / self._decode_s
                             if self._decode_s else 0.0),
            "occupancy": float(np.mean(self._occupancy)) if self._occupancy
            else 0.0,
            "p50_token_ms": float(np.percentile(lat, 50)),
            "p99_token_ms": float(np.percentile(lat, 99)),
            "warmup_s": self._warmup_s or 0.0,
            "decode_s": self._decode_s,
            "prefill_calls": self.prefill_calls,
            "decode_calls": self.decode_calls,
            "quantize_weight_calls": self.quantize_weight_calls_during_serve(),
            "kv_cache_bytes": cache_bytes(self.cfg, self.sched.num_slots,
                                          self.max_len),
            "kv_cache_bytes_rank": rank_bytes,
            "rung": self._rung,
            "guards_enabled": int(self._guard),
            "abft_enabled": int(self._abft),
            "health": self.health(),
            **{f"status_{k}": v for k, v in sorted(by_status.items())},
            **{k: int(v) for k, v in self.sched.counters.items()},
        }
