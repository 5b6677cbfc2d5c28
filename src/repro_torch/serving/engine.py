"""Continuous-batching serving engine over pre-quantized QTensor weights
(twin of the core of ``repro.serving.engine``).

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
kernels' build and the first-use costs stay out of request latencies.

The decode step runs eagerly (capturing it as a CUDA graph is later work),
as do the robustness layers of the reference engine -- degradation ladder,
watchdog, numeric guards, ABFT and fault hooks -- which are not ported yet.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import wquant
from repro_torch.device import resolve_device
from repro_torch.kernels.registry import TRACE_COUNTS
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import lm_decode_step, lm_forward
from repro_torch.serving.cache import alloc_kv_caches, cache_bytes, insert_kv
from repro_torch.serving.scheduler import Completion, Request, Scheduler


def _validate_config(cfg: ModelConfig) -> None:
    """Continuous batching needs position-addressable per-token caches and
    causal attention (right-padded prefill is exact only then): stacks of
    'attn' and 'moe' layers. (A MoE layer's capacity counts the padding
    too, but only after the real tokens, so it never drops one of them.)"""
    kinds = set(cfg.layer_kinds)
    if not kinds <= {"attn", "moe"}:
        raise ValueError(
            f"serving engine supports causal attention stacks only; config "
            f"{cfg.name!r} has kinds={sorted(kinds)}")


class ServeEngine:
    """Drives prefill / insert / decode over a request stream on
    ``device`` (the params must already live there)."""

    def __init__(self, cfg: ModelConfig, params, *, num_slots: int,
                 max_len: int, prefill_len: int, eos_id: Optional[int] = None,
                 device="cuda"):
        _validate_config(cfg)
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.eos_id = eos_id
        self.prefill_len = prefill_len
        self.max_len = max_len
        self.sched = Scheduler(num_slots, max_len, prefill_len)
        # the ONE cache allocation of the engine's lifetime
        self.caches = alloc_kv_caches(cfg, num_slots, max_len, self.device)
        self.tokens_h = np.zeros((num_slots, 1), np.int64)
        self.positions_h = np.zeros((num_slots,), np.int64)

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

    # --------------------------------------------------------- device ops
    @torch.inference_mode()
    def _prefill(self, padded: np.ndarray, length: int):
        """(1, P) right-padded prompt -> (first token tensor, per-layer KV)."""
        self.prefill_calls += 1
        tokens = torch.from_numpy(padded).to(self.device)
        logits, _, kv = lm_forward(self.cfg, self.params, {"tokens": tokens},
                                   want_cache=True)
        return torch.argmax(logits[0, length - 1]), kv

    @torch.inference_mode()
    def _decode(self) -> torch.Tensor:
        """One step over every slot -> (slots,) next tokens."""
        self.decode_calls += 1
        tokens = torch.from_numpy(self.tokens_h).to(self.device)
        pos = torch.from_numpy(self.positions_h).to(self.device)
        logits, self.caches = lm_decode_step(self.cfg, self.params,
                                             self.caches, tokens, pos)
        return torch.argmax(logits[:, -1], dim=-1)

    # ---------------------------------------------------------- warm-up
    def warmup(self) -> float:
        """One dummy prefill + insert + decode before serving, so no
        request's latency includes the kernels' build or first-use costs.
        It writes garbage into slot 0's rows, which are never attended
        before being overwritten (insert rewrites [0, P) on admission;
        decode rewrites row ``pos`` before attending it)."""
        if self._warmup_s is not None:
            return self._warmup_s
        t0 = time.perf_counter()
        _, kv = self._prefill(np.zeros((1, self.prefill_len), np.int64), 1)
        insert_kv(self.caches, kv, 0)
        int(self._decode()[0])
        self._warmup_s = time.perf_counter() - t0
        self._qw_calls_baseline = wquant.QUANTIZE_WEIGHT_CALLS
        return self._warmup_s

    # --------------------------------------------------------- lifecycle
    def _admit(self, slot: int, req: Request) -> None:
        padded = np.zeros((1, self.prefill_len), np.int64)
        padded[0, :req.prompt_len] = req.tokens
        t0 = time.perf_counter()
        tok, kv = self._prefill(padded, req.prompt_len)
        insert_kv(self.caches, kv, slot)
        tok_h = int(tok)                  # waits for the device
        dt_ms = (time.perf_counter() - t0) * 1e3
        TRACE_COUNTS[("serving", "prefill_insert")] += 1
        self.sched.counters["prefill_inserts"] += 1
        st = self.sched.active[slot]
        st.generated.append(tok_h)
        st.latencies_ms.append(dt_ms)
        self.tokens_h[slot, 0] = tok_h
        self.positions_h[slot] = st.pos
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
            self.sched.submit(req)
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

    def _decode_step(self) -> None:
        t0 = time.perf_counter()
        new_tok_h = self._decode().cpu().numpy()      # waits for the device
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._decode_s += dt_ms * 1e-3
        self._step_latencies_ms.append(dt_ms)
        self._occupancy.append(self.sched.occupancy)
        self.step += 1
        for slot in sorted(self.sched.active):
            st = self.sched.active[slot]
            tok = int(new_tok_h[slot])
            st.generated.append(tok)
            st.latencies_ms.append(dt_ms)
            st.pos += 1
            self.tokens_h[slot, 0] = tok
            self.positions_h[slot] = st.pos
            self._maybe_retire(slot, tok)

    # ------------------------------------------------------ observability
    def quantize_weight_calls_during_serve(self) -> int:
        """quantize_weight calls since warm-up (0 on the prequant path)."""
        return wquant.QUANTIZE_WEIGHT_CALLS - self._qw_calls_baseline

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
            **{f"status_{k}": v for k, v in sorted(by_status.items())},
            **{k: int(v) for k, v in self.sched.counters.items()},
        }
