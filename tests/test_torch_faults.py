"""PyTorch port, hardened serving: the degradation ladder, the watchdog,
the numeric guards, ABFT and the fault hooks of ``ServeEngine``, on the
CPU, port against port (the reference's ``tests/test_faults.py`` needs a
mesh that fails here), plus the model with ABFT on against the reference.

Each case of ``tests/test_faults.py`` has its twin here under the same
name, except ``test_rewarmed_executable_still_passes_lint``: the port has
no linter (ROADMAP item 14), so nothing of it carries over. Each twin
injects its fault into a real serve run and checks (a) the run completes,
(b) every request's ``Completion`` status and reason, and (c) the healthy
requests' tokens are bitwise those of a fault-free run. The port's models
are small (``scaled_config`` at 0.004, 2 layers, fp8_e4m3 + Hadamard + fp8
KV, int8 weight storage): llama3-8b, whose d_ff = 896 here is no power of 2
(the unfused site, ``xla_quant_dot_resid``), and phi4-mini, whose d_ff is
a power of 2 (the fused site, K7a's plain version). On the CPU every ladder rung runs
the plain versions, so a rung change never changes a token.

The model-level cases hold scaled-down phi4-mini and llama4-maverick with
ABFT on against the reference's un-meshed jitted ``lm_prefill`` with
``abft=True`` (the Pallas ABFT kernels in interpret mode,
``pltpu.TPUCompilerParams`` aliased inside the tests only), with the
tolerances of ``tests/test_torch_phi4.py`` / ``tests/test_torch_moe.py``:
the prefill logits within 0.05 of the largest |logit| and 0.04 relative
RMS, the same greedy token wherever the reference's top-2 margin exceeds
twice the largest logit gap; and the port's ABFT-on logits bitwise its
ABFT-off logits (no row tripped).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.quant import QuantConfig as JQuantConfig
from repro.core.wquant import QTensor as JQTensor
from repro.core.wquant import quantize_lm_weights as jquantize_lm_weights
from repro.models import init_lm as jinit_lm
from repro.models import lm_prefill as jlm_prefill

from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels.registry import TRACE_COUNTS, WARN_ONCE_SEEN
from repro_torch.launch.serve_loop import scaled_config
from repro_torch.models.lm import init_lm, lm_prefill
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import _degradation_ladder
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.testing import faults
from repro_torch.testing.faults import (FaultPlan, InjectedKernelError,
                                        arrival_flood, inject)

P, MAXLEN = 8, 32
AS_WRITTEN = {"xla_allow_excess_precision": False}
LOGIT_TOL, REL_TOL = 0.05, 0.04


# --------------------------------------------------------------- fixtures
def _setup(backend, arch="llama3-8b"):
    quant = QuantConfig(mode="fp8_e4m3", rotate="hadamard", backend=backend,
                        kv_quant=True)
    cfg = scaled_config(get_config(arch), 0.004).with_quant(quant)
    cfg = dataclasses.replace(cfg, weight_quant="int8")
    return cfg, init_lm(cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def torch_setup():
    """backend 'torch': one rung (the plain versions), nothing below it --
    the reference's 'xla' setup."""
    return _setup("torch")


@pytest.fixture(scope="module")
def auto_setup():
    """backend 'auto': the plain versions on the CPU, but the whole ladder
    (default schedule -> rotate-once -> torch)."""
    return _setup("auto")


@pytest.fixture(scope="module")
def phi4_setup():
    """phi4-mini: d_ff a power of 2, so every down projection is the fused
    site (K7a's plain version under ABFT)."""
    return _setup("auto", "phi4-mini-3.8b")


def _engine(setup, **kw):
    cfg, params = setup
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", MAXLEN)
    kw.setdefault("prefill_len", P)
    return ServeEngine(cfg, params, device="cpu", **kw)


def _reqs(cfg, n, gen=4, seed=1, **kw):
    return arrival_flood(n, prompt_len=P, max_new_tokens=gen,
                         vocab=cfg.vocab_size, seed=seed, **kw)


def _reference_tokens(setup, reqs):
    """Fault-free run of the same requests (deadlines stripped): rid ->
    tokens."""
    plain = [dataclasses.replace(r, deadline=None) for r in reqs]
    comps = _engine(setup).run(plain)
    assert all(c.status == "ok" for c in comps)
    return {c.rid: c.tokens for c in comps}


# ---------------------------------------------------- scheduler (host-only)
def test_clock_jump_does_not_stall_admission():
    sched = Scheduler(num_slots=2, max_len=32, prefill_len=8)
    sched.submit(Request(0, np.zeros(4, np.int32), 4, arrival_time=5.0))
    assert sched.next_admission(5.0) is not None
    sched.submit(Request(1, np.zeros(4, np.int32), 4, arrival_time=5.0))
    adm = sched.next_admission(1.0)          # the clock jumps backwards
    assert adm is not None and adm[1].rid == 1
    assert sched._clock == 5.0


def test_bounded_queue_rejects_with_backpressure():
    sched = Scheduler(num_slots=1, max_len=32, prefill_len=8, max_queue=2)
    before = TRACE_COUNTS[("serving", "queue_reject")]
    assert sched.submit(Request(0, np.zeros(4, np.int32), 4)) is None
    assert sched.submit(Request(1, np.zeros(4, np.int32), 4)) is None
    c = sched.submit(Request(2, np.zeros(4, np.int32), 4))
    assert c is not None and c.status == "rejected" \
        and c.finish_reason == "queue_full" and c.tokens == ()
    assert sched.counters["rejected"] == 1
    assert TRACE_COUNTS[("serving", "queue_reject")] == before + 1
    with pytest.raises(ValueError, match="prompt_len"):
        sched.submit(Request(3, np.zeros(9, np.int32), 2))


def test_shed_expired_scans_whole_queue():
    sched = Scheduler(num_slots=1, max_len=32, prefill_len=8)
    sched.submit(Request(0, np.zeros(4, np.int32), 4))
    sched.submit(Request(1, np.zeros(4, np.int32), 4, deadline=2.0))
    sched.submit(Request(2, np.zeros(4, np.int32), 4, deadline=9.0))
    shed = sched.shed_expired(5.0)
    assert [c.rid for c in shed] == [1]
    assert shed[0].status == "timed_out" and shed[0].finish_reason == "deadline_shed"
    assert [r.rid for r in sched.queue] == [0, 2]
    assert sched.counters["shed"] == 1


# ------------------------------------------------------------ engine paths
def test_degradation_ladder_rungs(auto_setup, torch_setup):
    """cuda / auto + default schedule -> rotate-once -> torch on the CPU;
    on the card no torch rung (a kernel is never swapped for its plain
    version); a config on 'torch' has no lower rung; a pinned rotate-once
    skips that rung."""
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    cfg = auto_setup[0]

    def rungs(c, dev):
        return [(r.quant.backend, r.quant.schedule) for r in _degradation_ladder(c, dev)]

    assert rungs(cfg, cpu) == [("auto", None), ("auto", "rotate_once"), ("torch", None)]
    assert rungs(cfg, gpu) == [("auto", None), ("auto", "rotate_once")]
    cuda = cfg.with_quant(dataclasses.replace(cfg.quant, backend="cuda",
                                              schedule="streamed"))
    assert rungs(cuda, cpu) == [("cuda", "streamed"), ("cuda", "rotate_once"),
                                ("torch", None)]
    assert rungs(cuda, gpu) == [("cuda", "streamed"), ("cuda", "rotate_once")]
    ro = cfg.with_quant(dataclasses.replace(cfg.quant, schedule="rotate_once"))
    assert len(_degradation_ladder(ro, cpu)) == 2
    assert len(_degradation_ladder(ro, gpu)) == 1
    assert len(_degradation_ladder(torch_setup[0], cpu)) == 1
    assert len(_degradation_ladder(torch_setup[0], gpu)) == 1


def test_deadline_shed_and_inflight_timeout(torch_setup):
    cfg, _ = torch_setup
    r_long, r_queued = _reqs(cfg, 2, gen=12)
    r_long = dataclasses.replace(r_long, deadline=5.0)
    r_queued = dataclasses.replace(r_queued, deadline=3.0)
    before = TRACE_COUNTS[("serving", "deadline_shed")]
    eng = _engine(torch_setup, num_slots=1)
    comps = {c.rid: c for c in eng.run([r_long, r_queued])}
    long_c, queued_c = comps[r_long.rid], comps[r_queued.rid]
    assert long_c.status == "timed_out" and long_c.finish_reason == "deadline"
    assert 0 < len(long_c.tokens) < 12
    assert queued_c.status == "timed_out" \
        and queued_c.finish_reason == "deadline_shed" \
        and queued_c.tokens == () and queued_c.admitted_step == -1
    assert TRACE_COUNTS[("serving", "deadline_shed")] == before + 1
    assert eng.health()["deadline_retired"] == 1


def test_kernel_raise_retried_once_bitwise(torch_setup):
    cfg, _ = torch_setup
    reqs = _reqs(cfg, 2, gen=5)
    ref = _reference_tokens(torch_setup, reqs)
    eng = _engine(torch_setup)
    with inject(FaultPlan(kernel_raise_at_step=1, kernel_raise_count=1)) as plan:
        comps = eng.run(reqs)
    s = eng.summary()
    assert plan.log == [(1, "kernel_raise")]
    assert all(c.status == "ok" for c in comps)
    assert all(c.tokens == ref[c.rid] for c in comps)
    assert s["step_retries"] == 1 and s.get("degrades", 0) == 0 and s["rung"] == 0


def test_persistent_failure_degrades_and_rewarm_bitwise(auto_setup):
    """Two failures in a row exhaust the retry and move one rung down
    (rotate-once pinned), loudly; the stream finishes with the same
    tokens."""
    cfg, _ = auto_setup
    reqs = _reqs(cfg, 2, gen=5)
    ref = _reference_tokens(auto_setup, reqs)
    WARN_ONCE_SEEN.discard(("serving", "degrade_rotate_once"))
    before = TRACE_COUNTS[("serving", "degrade_rotate_once")]
    eng = _engine(auto_setup)
    with pytest.warns(RuntimeWarning, match="degraded to rung"), \
            inject(FaultPlan(kernel_raise_at_step=1, kernel_raise_count=2)):
        comps = eng.run(reqs)
    s = eng.summary()
    assert all(c.status == "ok" for c in comps)
    assert all(c.tokens == ref[c.rid] for c in comps)
    assert s["rung"] == 1 and s["degrades"] == 1 and s["health"]["rung"] == 1
    assert eng._run_cfg.quant.schedule == "rotate_once"
    assert TRACE_COUNTS[("serving", "degrade_rotate_once")] == before + 1


def test_ladder_exhaustion_fails_loudly_not_crashily(torch_setup):
    cfg, _ = torch_setup
    reqs = _reqs(cfg, 3, gen=5)
    WARN_ONCE_SEEN.discard(("serving", "ladder_exhausted"))
    eng = _engine(torch_setup, num_slots=2)
    with pytest.warns(RuntimeWarning, match="ladder exhausted"), \
            inject(FaultPlan(kernel_raise_at_step=1, kernel_raise_count=99)):
        comps = {c.rid: c for c in eng.run(reqs)}
    assert all(c.status == "degraded" for c in comps.values())
    inflight = [c for c in comps.values() if c.finish_reason == "engine_failed"]
    drained = [c for c in comps.values() if c.finish_reason == "shed_engine_failed"]
    assert len(inflight) == 2 and len(drained) == 1


def test_ladder_walks_to_the_torch_rung(auto_setup):
    """A failure that persists through the retry and the rotate-once rung
    ends on the torch rung, two rungs down, still bitwise."""
    cfg, _ = auto_setup
    reqs = _reqs(cfg, 2, gen=5)
    ref = _reference_tokens(auto_setup, reqs)
    WARN_ONCE_SEEN.discard(("serving", "degrade_torch"))
    eng = _engine(auto_setup)
    with pytest.warns(RuntimeWarning, match="degraded to rung 'torch'"), \
            inject(FaultPlan(kernel_raise_at_step=1, kernel_raise_count=3)):
        comps = eng.run(reqs)
    assert all(c.status == "ok" and c.tokens == ref[c.rid] for c in comps)
    assert eng.health()["rung"] == 2 and eng.health()["degrades"] == 2
    assert eng._run_cfg.quant.backend == "torch"


def test_watchdog_trips_on_slow_steps(torch_setup):
    cfg, _ = torch_setup
    reqs = _reqs(cfg, 2, gen=5)
    ref = _reference_tokens(torch_setup, reqs)
    before = TRACE_COUNTS[("serving", "watchdog_trip")]
    WARN_ONCE_SEEN.discard(("serving", "ladder_exhausted"))
    eng = _engine(torch_setup, watchdog_ms=250.0)
    with pytest.warns(RuntimeWarning, match="ladder exhausted"), \
            inject(FaultPlan(step_delay_s=0.4, delay_at_steps=(1, 2))):
        comps = eng.run(reqs)
    s = eng.summary()
    assert all(c.status == "ok" for c in comps)
    assert all(c.tokens == ref[c.rid] for c in comps)
    assert s["watchdog_trips"] >= 2 and s["health"]["watchdog_trips"] >= 2
    assert TRACE_COUNTS[("serving", "watchdog_trip")] >= before + 2


# --------------------------------------------------------- numeric guards
def test_nan_poke_retires_only_the_poisoned_slot(torch_setup, monkeypatch):
    monkeypatch.setenv("REPRO_NUMERIC_GUARDS", "1")
    cfg, _ = torch_setup
    reqs = _reqs(cfg, 2, gen=6)
    monkeypatch.delenv("REPRO_NUMERIC_GUARDS")
    ref = _reference_tokens(torch_setup, reqs)
    monkeypatch.setenv("REPRO_NUMERIC_GUARDS", "1")
    before = TRACE_COUNTS[("serving", "guard_trip")]
    eng = _engine(torch_setup)
    with inject(FaultPlan(nan_poke_step=2, nan_poke_slot=0)):
        comps = {c.rid: c for c in eng.run(reqs)}
    poisoned, clean = comps[reqs[0].rid], comps[reqs[1].rid]
    assert poisoned.status == "degraded" and poisoned.finish_reason == "nan_guard"
    assert len(poisoned.tokens) < 6
    assert poisoned.tokens == ref[poisoned.rid][:len(poisoned.tokens)]
    assert clean.status == "ok" and clean.tokens == ref[clean.rid]
    assert TRACE_COUNTS[("serving", "guard_trip")] >= before + 1
    s = eng.summary()
    assert s["guards_enabled"] == 1 and s["health"]["nan_guard_trips"] == 1


def test_guards_on_is_bitwise_guard_off(torch_setup, monkeypatch):
    cfg, _ = torch_setup
    reqs = _reqs(cfg, 3, gen=5)
    ref = _reference_tokens(torch_setup, reqs)
    monkeypatch.setenv("REPRO_NUMERIC_GUARDS", "1")
    comps = _engine(torch_setup).run(reqs)
    assert all(c.status == "ok" for c in comps)
    assert all(c.tokens == ref[c.rid] for c in comps)


def test_guards_ignore_the_vocab_padding(monkeypatch):
    """A vocabulary that is no multiple of 256 (phi4-mini's 200064,
    maverick's 202048) pads the logits with -inf columns; the guarded
    steps judge the real vocabulary only, so a healthy guarded run trips
    nothing and gives the unguarded tokens."""
    cfg, params = _setup("torch")
    cfg = dataclasses.replace(cfg, vocab_size=500)
    assert cfg.padded_vocab == 512
    reqs = _reqs(cfg, 2, gen=4)
    comps = ServeEngine(cfg, params, num_slots=2, max_len=MAXLEN, prefill_len=P,
                        device="cpu").run(reqs)
    ref = {c.rid: c.tokens for c in comps}
    monkeypatch.setenv("REPRO_NUMERIC_GUARDS", "1")
    eng = ServeEngine(cfg, params, num_slots=2, max_len=MAXLEN, prefill_len=P,
                      device="cpu")
    assert all(c.status == "ok" and c.tokens == ref[c.rid] for c in eng.run(reqs))
    assert eng.health()["nan_guard_trips"] == 0


def test_guard_dequant_poisons_bad_scales_only():
    """The quantize seam: rows of a non-finite or zero scale become NaN,
    every other row is bitwise the unguarded result."""
    from repro_torch.core import guards

    y = torch.randn(4, 8).to(torch.bfloat16)
    s = torch.tensor([[1.0], [float("nan")], [0.0], [float("inf")]])
    g = guards.guard_dequant(y, s)
    assert torch.equal(g[0], y[0]) and torch.isnan(g[1:].float()).all()
    assert guards.scale_rows_ok(s, 4).tolist() == [True, False, False, False]
    assert guards.rows_ok(g, 4).tolist() == [True, False, False, False]
    assert guards.rows_ok(g[1:2], 3).tolist() == [False] * 3   # unattributable


# ------------------------------------------------------ combined acceptance
def test_combined_chaos_run(auto_setup, monkeypatch):
    monkeypatch.setenv("REPRO_NUMERIC_GUARDS", "1")
    cfg, _ = auto_setup
    r = _reqs(cfg, 6, gen=4)
    r[0] = dataclasses.replace(r[0], max_new_tokens=6)
    r[2] = dataclasses.replace(r[2], deadline=2.0)
    ok_rids = {r[0].rid, r[1].rid, r[3].rid}
    ref = _reference_tokens(auto_setup, [r[0], r[1], r[3]])
    WARN_ONCE_SEEN.discard(("serving", "degrade_rotate_once"))
    eng = _engine(auto_setup, max_queue=4)
    with pytest.warns(RuntimeWarning, match="degraded to rung"), \
            inject(FaultPlan(kernel_raise_at_step=1, kernel_raise_count=2)):
        comps = {c.rid: c for c in eng.run(r)}
    s = eng.summary()
    assert len(comps) == 6
    for rid in ok_rids:
        assert comps[rid].status == "ok" and comps[rid].tokens == ref[rid]
    assert comps[r[2].rid].status == "timed_out" \
        and comps[r[2].rid].finish_reason == "deadline_shed"
    assert comps[r[4].rid].status == "rejected"
    assert comps[r[5].rid].status == "rejected"
    assert s["rung"] == 1
    assert s["status_ok"] == 3 and s["status_rejected"] == 2 \
        and s["status_timed_out"] == 1
    assert s.get("guard_trips", 0) == 0


# ------------------------------------------------------- ABFT SDC detection
@pytest.mark.parametrize("which", ["llama3", "phi4"])
def test_abft_healthy_run_bitwise_and_health_dict(torch_setup, phi4_setup,
                                                  monkeypatch, which):
    setup = torch_setup if which == "llama3" else phi4_setup
    cfg, _ = setup
    reqs = _reqs(cfg, 3, gen=5)
    ref = _reference_tokens(setup, reqs)
    monkeypatch.setenv("REPRO_ABFT", "1")
    site = TRACE_COUNTS[("abft", "quant_dot_site")]
    eng = _engine(setup)
    comps = eng.run(reqs)
    assert all(c.status == "ok" for c in comps)
    assert all(c.tokens == ref[c.rid] for c in comps)
    h = eng.summary()["health"]
    assert h["abft_enabled"] == 1 and h["rung"] == 0 and h["degrades"] == 0
    assert h["abft_sdc_detections"] == 0 and h["abft_kv_trips"] == 0
    assert h["abft_params_checks"] == 0
    # every pass verified its down projections
    passes = eng.prefill_calls + eng.decode_calls
    assert TRACE_COUNTS[("abft", "quant_dot_site")] - site == passes * cfg.num_layers
    # the engine's checksummed copy shares the weights, it does not copy them
    w0 = setup[1]["layers"][0]["mlp"]["w_down"]
    e0 = eng.params["layers"][0]["mlp"]["w_down"]
    assert e0.check is not None and w0.check is None and e0.q is w0.q


@pytest.mark.parametrize("which", ["llama3", "phi4"])
def test_abft_weight_bitflip_retires_as_sdc(torch_setup, phi4_setup, monkeypatch,
                                            which):
    """A finite bit flip in the checksum-covered down projection at step 2:
    invisible to the guards, caught by the site's residual that same step
    (llama3: the unfused ``xla_quant_dot_resid``; phi4: the fused K7a's
    plain version), attributed by the weight audit; no corrupt token is
    emitted and the engine keeps serving. Undone when the scope exits."""
    setup = torch_setup if which == "llama3" else phi4_setup
    cfg, params = setup
    reqs = _reqs(cfg, 2, gen=6)
    ref = _reference_tokens(setup, reqs)
    monkeypatch.setenv("REPRO_ABFT", "1")
    before = TRACE_COUNTS[("abft", "sdc_detected")]
    w = params["layers"][0]["mlp"]["w_down"].q.clone()
    eng = _engine(setup)
    with inject(FaultPlan(corrupt_at_step=2, corrupt_kind="weight")) as plan:
        comps = {c.rid: c for c in eng.run(reqs)}
        assert not torch.equal(params["layers"][0]["mlp"]["w_down"].q, w)
    assert torch.equal(params["layers"][0]["mlp"]["w_down"].q, w)   # undone
    assert plan.log == [(2, "corrupt_weight")]
    sdc = [c for c in comps.values() if c.finish_reason == "sdc_detected"]
    assert sdc, "weight bit flip went undetected"
    for c in sdc:
        assert c.status == "degraded"
        assert c.tokens == ref[c.rid][:len(c.tokens)] and len(c.tokens) < 6
    h = eng.summary()["health"]
    assert h["abft_sdc_detections"] >= 1 and h["abft_params_checks"] >= 1
    assert h["nan_guard_trips"] == 0
    assert TRACE_COUNTS[("abft", "sdc_detected")] >= before + 1
    comps2 = _engine(setup).run([dataclasses.replace(r) for r in reqs])
    assert all(c.status == "ok" and c.tokens == ref[c.rid] for c in comps2)


def test_abft_tile_clobber_retires_as_sdc(phi4_setup, monkeypatch):
    """A zeroed 128-column slab of the down projection (a mis-delivered
    weight-stream tile) trips the fused site's residual."""
    cfg, _ = phi4_setup
    reqs = _reqs(cfg, 2, gen=6)
    ref = _reference_tokens(phi4_setup, reqs)
    monkeypatch.setenv("REPRO_ABFT", "1")
    eng = _engine(phi4_setup)
    with inject(FaultPlan(corrupt_at_step=2, corrupt_kind="tile")):
        comps = eng.run(reqs)
    sdc = [c for c in comps if c.finish_reason == "sdc_detected"]
    assert sdc and all(c.tokens == ref[c.rid][:len(c.tokens)] for c in sdc)
    assert eng.health()["abft_params_checks"] >= 1


def test_guards_alone_miss_the_silent_flip(torch_setup, monkeypatch):
    """The contrast ABFT exists for: with only the numeric guards on, the
    same weight flip trips nothing (the values stay finite)."""
    cfg, _ = torch_setup
    monkeypatch.setenv("REPRO_NUMERIC_GUARDS", "1")
    eng = _engine(torch_setup)
    with inject(FaultPlan(corrupt_at_step=2, corrupt_kind="weight")):
        comps = eng.run(_reqs(cfg, 2, gen=6))
    assert all(c.status == "ok" for c in comps)
    assert eng.health()["nan_guard_trips"] == 0


def test_abft_kv_corruption_retires_only_that_slot(torch_setup, monkeypatch):
    cfg, _ = torch_setup
    reqs = _reqs(cfg, 2, gen=6, seed=5)
    ref = _reference_tokens(torch_setup, reqs)
    monkeypatch.setenv("REPRO_ABFT", "1")
    before = TRACE_COUNTS[("abft", "kv_trip")]
    eng = _engine(torch_setup)
    with inject(FaultPlan(corrupt_at_step=2, corrupt_kind="kv", kv_corrupt_slot=0)):
        comps = {c.rid: c for c in eng.run(reqs)}
    poisoned, clean = comps[reqs[0].rid], comps[reqs[1].rid]
    assert poisoned.status == "degraded" and poisoned.finish_reason == "sdc_detected"
    assert poisoned.tokens == ref[poisoned.rid][:len(poisoned.tokens)]
    assert clean.status == "ok" and clean.tokens == ref[clean.rid]
    assert TRACE_COUNTS[("abft", "kv_trip")] == before + 1
    assert eng.summary()["health"]["abft_kv_trips"] == 1


def test_fault_plan_is_context_scoped():
    plan = FaultPlan(kernel_raise_at_step=0)
    assert faults.active() is None
    with inject(plan):
        assert faults.active() is plan
        with pytest.raises(InjectedKernelError):
            plan.maybe_raise(0)
    assert faults.active() is None
    assert plan.log == [(0, "kernel_raise")]


def test_flip_picks_a_byte_that_stays_finite():
    """e4m3 0x3f with bit 6 flipped is 0x7f, a NaN: the injector skips such
    bytes so the fault stays silent; the undo restores the byte."""
    from repro_torch.core.wquant import QTensor

    raw = torch.full((4, 128), 0x3F, dtype=torch.uint8)
    raw.view(-1)[300] = 0x10
    qt = QTensor(raw.view(torch.float8_e4m3fn), torch.ones(1, 128), "fp8_e4m3")
    params = {"layers": [{"mlp": {"w_down": qt}}]}
    undo = faults.flip_weight_bit(params, bit=6)
    flipped = raw.view(-1)
    assert int(flipped[300]) == 0x50 and torch.isfinite(qt.q.float()).all()
    undo()
    assert int(flipped[300]) == 0x10


# ---------------------------------------------- the model against the ref
def _np_tree(t):
    if isinstance(t, JQTensor):
        out = {"q": np.asarray(t.q), "scale": np.asarray(t.scale), "mode": t.mode}
        if t.check is not None:
            out["check"] = np.asarray(t.check)
        return out
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


def _abft_model(jarch, arch, over, mode="fp8_e4m3"):
    jq = JQuantConfig(mode=mode, rotate="hadamard", backend="pallas", kv_quant=True,
                      abft=True)
    tq = QuantConfig(mode=mode, rotate="hadamard", backend="cuda", kv_quant=True,
                     abft=True)
    jcfg = dataclasses.replace(jget_config(jarch).scaled_down(**over).with_quant(jq),
                               weight_quant="int8")
    tcfg = dataclasses.replace(get_config(arch).scaled_down(**over).with_quant(tq),
                               weight_quant="int8")
    jp = jax.jit(lambda k: jquantize_lm_weights(jinit_lm(k, jcfg), jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_reference(_np_tree(jp), device="cpu")


@pytest.mark.parametrize("jarch, arch, over, mode", [
    ("phi4_mini_3_8b", "phi4-mini-3.8b",
     dict(d_model=384, num_heads=3, num_kv_heads=1, head_dim=128, d_ff=512), "int8"),
    ("llama4_maverick_400b_a17b", "llama4-maverick-400b-a17b",
     dict(d_model=256, num_heads=2, num_kv_heads=1, head_dim=128, d_ff=256), "fp8_e4m3"),
])
def test_abft_prefill_matches_reference(jarch, arch, over, mode):
    from jax.experimental.pallas import tpu as pltpu

    jcfg, tcfg, jp, params = _abft_model(jarch, arch, over, mode)
    down = params["layers"][0]["mlp"]["w_down"]
    assert down.check is not None            # carried across by the bridge
    np.testing.assert_array_equal(down.check.numpy(),
                                  np.asarray(jp["groups"][0]["p0"]["mlp"]["w_down"].check[0]))
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        jl, _ = jax.jit(lambda p, b: jlm_prefill(jcfg, p, b),
                        compiler_options=AS_WRITTEN)(jp, {"tokens": jnp.asarray(toks)})
    sites = (TRACE_COUNTS[("abft", "quant_dot_site")],
             TRACE_COUNTS[("abft", "quant_dot_experts_site")])
    tl, _ = lm_prefill(tcfg, params, {"tokens": torch.from_numpy(toks).long()})
    moe = sum(k == "moe" for k in tcfg.layer_kinds)
    dense = tcfg.num_layers - moe
    assert (TRACE_COUNTS[("abft", "quant_dot_site")] - sites[0],
            TRACE_COUNTS[("abft", "quant_dot_experts_site")] - sites[1]) == (
        dense + (moe if tcfg.moe_shared_expert else 0), moe)
    off = dataclasses.replace(tcfg, quant=dataclasses.replace(tcfg.quant, abft=False))
    tl_off, _ = lm_prefill(off, params, {"tokens": torch.from_numpy(toks).long()})
    assert torch.equal(tl, tl_off)           # healthy: exact selects only
    V = tcfg.vocab_size
    g = tl[:, -1, :V].float().numpy()
    w = np.asarray(jl[:, -1, :V], np.float32)
    assert np.isfinite(g).all() and np.isfinite(w).all()
    gap = np.abs(g - w).max()
    assert gap / np.abs(w).max() <= LOGIT_TOL
    assert np.linalg.norm(g - w) / np.linalg.norm(w) <= REL_TOL
    top = np.sort(w, -1)
    sure = top[:, -1] - top[:, -2] > 2 * gap
    assert ((g.argmax(-1) == w.argmax(-1)) | ~sure).all()
