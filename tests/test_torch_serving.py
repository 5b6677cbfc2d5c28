"""PyTorch port, serving stage: the continuous-batching engine, its
scheduler and the CLI, on the CPU.

  * The port's engine against the un-meshed reference loop (jitted
    ``lm_prefill`` + ``lm_decode_step``, backend pallas in interpret mode,
    compiled as written -- see ``test_torch_model`` -- one request at a
    time) on the reference's own bridged parameters: the engine's tokens
    are the port's own greedy tokens, and the reference agrees with them
    within the model test's logit tolerances.
  * The engine against the port's one-shot path (batch prefill + shared
    scalar position): staggered arrivals with slot reuse give bitwise the
    same tokens per request.
  * Slot reuse leaks no stale KV, EOS retires on the step it appears, the
    cache is allocated once, and serving quantizes no weight.
  * Scheduler and stream units.
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
from repro.models import lm_decode_step as jlm_decode_step
from repro.models import lm_prefill as jlm_prefill
from repro.models.lm import pad_kv_caches as jpad_kv_caches

from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.core import wquant
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels.registry import TRACE_COUNTS
from repro_torch.models.lm import lm_decode_step, lm_prefill, pad_kv_caches
from repro_torch.serving import (Request, Scheduler, ServeEngine,
                                 synthetic_stream)
from repro_torch.serving.cache import cache_bytes
from repro_torch.serving.engine import _validate_config

OVER = dict(d_model=512, num_heads=4, num_kv_heads=1, d_ff=384)
P = 16
LOGIT_TOL, REL_TOL = 0.05, 0.04   # as test_torch_model, from its readings


def _np_tree(t):
    if isinstance(t, JQTensor):
        return {"q": np.asarray(t.q), "scale": np.asarray(t.scale), "mode": t.mode}
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


@pytest.fixture(scope="module")
def setup():
    jq = JQuantConfig(mode="fp8_e4m3", rotate="hadamard", backend="pallas",
                      kv_quant=True)
    jcfg = dataclasses.replace(
        jget_config("llama3_8b").scaled_down(**OVER).with_quant(jq),
        weight_quant="int8")
    tq = QuantConfig(mode="fp8_e4m3", rotate="hadamard", backend="cuda",
                     kv_quant=True)
    cfg = dataclasses.replace(
        get_config("llama3_8b").scaled_down(**OVER).with_quant(tq),
        weight_quant="int8")
    jp = jax.jit(lambda k: jquantize_lm_weights(jinit_lm(k, jcfg), jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_reference(_np_tree(jp), device="cpu")


def _prompts(cfg, n, length, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (n, length)).astype(np.int32)


def _engine(cfg, params, **kw):
    kw.setdefault("prefill_len", P)
    return ServeEngine(cfg, params, device="cpu", **kw)


def _one_shot(cfg, params, prompts, gen, max_len):
    """The port's one-shot path: batch prefill + shared scalar position."""
    logits, caches = lm_prefill(cfg, params, {"tokens": torch.from_numpy(prompts).long()})
    caches = pad_kv_caches(cfg, caches, max_len)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    out = [tok]
    for i in range(gen - 1):
        logits, caches = lm_decode_step(cfg, params, caches, tok,
                                        torch.tensor(prompts.shape[1] + i))
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        out.append(tok)
    return torch.cat(out, 1).numpy()


# ------------------------------------------------------------- parity
def test_engine_matches_reference_loop(setup):
    """Requests of different lengths, right-padded into the prefill bucket
    and decoded on shared slots. Each request's tokens are bitwise the
    port's greedy tokens for it run alone and unpadded. The reference, run
    the same way and fed the same tokens, gives logits within LOGIT_TOL of
    the largest |logit| and REL_TOL relative RMS of the port's at every
    step, and the same greedy token wherever its top-2 margin exceeds twice
    that step's largest logit gap (no smaller gap can reorder the top two;
    a bf16 flip in a matmul sum, amplified by the fp8 sites, can split the
    two streams at a narrower near-tie). Here 13 of the 18 steps are wide
    enough to decide; at least half must be."""
    jcfg, cfg, jp, params = setup
    gen, lens = 6, (16, 11, 7)
    reqs = [Request(rid=rid, tokens=_prompts(cfg, 1, L, seed=10 + rid)[0],
                    max_new_tokens=gen, arrival_time=float(rid))
            for rid, L in enumerate(lens)]
    comps = _engine(cfg, params, num_slots=2, max_len=32).run(reqs)
    assert sorted(c.rid for c in comps) == [0, 1, 2]
    as_written = {"xla_allow_excess_precision": False}
    jpre = jax.jit(lambda p, b: jlm_prefill(jcfg, p, b),
                   compiler_options=as_written)
    jdec = jax.jit(lambda p, c, t, pos: jlm_decode_step(jcfg, p, c, t, pos),
                   compiler_options=as_written)
    V, decided = cfg.vocab_size, 0
    for c in comps:
        assert c.finish_reason == "length" and len(c.tokens) == gen
        req = reqs[c.rid]
        prompt = req.tokens[None]
        jl, jc = jpre(jp, {"tokens": jnp.asarray(prompt)})
        jc = jpad_kv_caches(jcfg, jc, 32)
        tl, tc = lm_prefill(cfg, params, {"tokens": torch.from_numpy(prompt).long()})
        tc = pad_kv_caches(cfg, tc, 32)
        for i, tok in enumerate(c.tokens):
            mine = tl[0, -1, :V].float().numpy()
            ref = np.asarray(jl[0, -1, :V], np.float32)
            assert tok == int(mine.argmax()), (c.rid, i)
            gap = np.abs(mine - ref)
            assert gap.max() <= LOGIT_TOL * np.abs(ref).max(), (c.rid, i)
            assert np.linalg.norm(mine - ref) <= REL_TOL * np.linalg.norm(ref)
            top2 = np.sort(ref)[-2:]
            if top2[1] - top2[0] > 2 * gap.max():
                assert tok == int(ref.argmax()), (c.rid, i)
                decided += 1
            jl, jc = jdec(jp, jc, jnp.asarray([[tok]], jnp.int32),
                          jnp.asarray(req.prompt_len + i, jnp.int32))
            tl, tc = lm_decode_step(cfg, params, tc, torch.tensor([[tok]]),
                                    torch.tensor(req.prompt_len + i))
    assert decided >= len(lens) * gen // 2, decided


def test_staggered_parity_bitwise(setup):
    """Fewer slots than requests, so admission waits on a retirement and a
    slot is reused: every request's greedy stream is bitwise the one-shot
    path's."""
    _, cfg, _, params = setup
    GEN, MAXLEN, B = 6, 48, 3
    prompts = _prompts(cfg, B, P)
    base = _one_shot(cfg, params, prompts, GEN, MAXLEN)
    eng = _engine(cfg, params, num_slots=2, max_len=MAXLEN)
    ptr = eng.caches[0]["k"].data_ptr()
    calls = wquant.QUANTIZE_WEIGHT_CALLS
    comps = eng.run([Request(rid=i, tokens=prompts[i], max_new_tokens=GEN,
                             arrival_time=[0.0, 2.0, 4.0][i]) for i in range(B)])
    assert len(comps) == B
    for c in comps:
        assert c.finish_reason == "length" and c.status == "ok"
        assert np.array_equal(np.array(c.tokens), base[c.rid]), c.rid
    s = eng.summary()
    assert s["queue_full_stalls"] >= 1
    assert s["quantize_weight_calls"] == 0 and wquant.QUANTIZE_WEIGHT_CALLS == calls
    assert s["prefill_inserts"] == B and s["admitted"] == B and s["retired"] == B
    assert s["prefill_calls"] == B + 1 and s["decode_calls"] == s["decode_steps"] + 1
    assert s["generated_tokens"] == B * GEN and s["tokens_per_s"] > 0
    # the cache was allocated once and updated in place
    assert eng.caches[0]["k"].data_ptr() == ptr
    assert s["kv_cache_bytes"] == cache_bytes(cfg, 2, MAXLEN) == \
        2 * cfg.num_layers * 2 * MAXLEN * cfg.num_kv_heads * cfg.head_dim


def test_slot_reuse_no_stale_kv(setup):
    """A reused slot's follow-up request streams bitwise what it gets in a
    fresh engine, although the slot still holds its predecessor's rows
    beyond the new request's range."""
    _, cfg, _, params = setup
    MAXLEN = 64
    prompts = _prompts(cfg, 2, P, seed=7)
    r1 = Request(rid=0, tokens=prompts[0], max_new_tokens=24)
    r2 = Request(rid=1, tokens=prompts[1], max_new_tokens=6, arrival_time=1.0)
    reuse = _engine(cfg, params, num_slots=1, max_len=MAXLEN)
    reused = {c.rid: c for c in reuse.run([r1, r2])}
    fresh = _engine(cfg, params, num_slots=1, max_len=MAXLEN)
    got = {c.rid: c for c in fresh.run([dataclasses.replace(r2, arrival_time=0.0)])}
    assert reused[1].tokens == got[1].tokens
    k_reuse = reuse.caches[0]["k"].float()
    k_fresh = fresh.caches[0]["k"].float()
    depth = P + r2.max_new_tokens - 1
    assert not torch.equal(k_reuse[:, depth:], k_fresh[:, depth:])
    assert torch.equal(k_reuse[:, :depth], k_fresh[:, :depth])


def test_eos_retirement(setup):
    _, cfg, _, params = setup
    req = Request(rid=0, tokens=_prompts(cfg, 1, P, seed=3)[0], max_new_tokens=8)
    full = _engine(cfg, params, num_slots=1, max_len=48).run([req])[0]
    assert full.finish_reason == "length" and len(full.tokens) == 8
    eos = full.tokens[2]
    early = _engine(cfg, params, num_slots=1, max_len=48, eos_id=int(eos)).run([req])[0]
    assert early.finish_reason == "eos" and len(early.tokens) <= 3
    assert early.tokens == full.tokens[:len(early.tokens)]


def test_engine_honours_request_deadlines(setup):
    """A request past its deadline in flight retires as timed_out; one
    whose deadline passes while it waits for a slot is shed unserved."""
    _, cfg, _, params = setup
    prompts = _prompts(cfg, 2, P, seed=5)
    reqs = [Request(rid=0, tokens=prompts[0], max_new_tokens=10, deadline=3.0),
            Request(rid=1, tokens=prompts[1], max_new_tokens=4, deadline=2.0)]
    comps = {c.rid: c for c in _engine(cfg, params, num_slots=1, max_len=32).run(reqs)}
    assert comps[0].finish_reason == "deadline" and comps[0].status == "timed_out"
    assert 1 <= len(comps[0].tokens) < 10
    assert comps[1].finish_reason == "deadline_shed" and comps[1].tokens == ()


def test_engine_rejects_non_attention_stacks(setup):
    _, cfg, _, _ = setup
    with pytest.raises(ValueError, match="causal attention"):
        _validate_config(dataclasses.replace(cfg, groups=((("mamba",), 2),)))


def test_serve_loop_cli_on_cpu(capsys):
    from repro_torch.launch.serve_loop import main

    eng = main(["--device", "cpu", "--scale", "0.005", "--quant", "fp8_e4m3",
                "--rotate", "hadamard", "--requests", "3", "--slots", "2",
                "--max-len", "48", "--prefill-len", "16"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "quantize_weight_calls=0" in out
    assert eng.summary()["status_ok"] == 3


# ---------------------------------------------------------- scheduler
def _req(rid, plen=4, gen=4, t=0.0, deadline=None):
    return Request(rid=rid, tokens=np.zeros(plen, np.int32), max_new_tokens=gen,
                   arrival_time=t, deadline=deadline)


def test_scheduler_free_list_is_lifo_and_fcfs():
    s = Scheduler(num_slots=2, max_len=16, prefill_len=8)
    for i in range(3):
        assert s.submit(_req(i)) is None
    assert s.next_admission(0.0)[0] == 0
    assert s.next_admission(0.0)[0] == 1
    stalls = TRACE_COUNTS[("serving", "queue_full_stall")]
    assert s.next_admission(0.0) is None
    assert s.counters["queue_full_stalls"] == 1
    assert TRACE_COUNTS[("serving", "queue_full_stall")] == stalls + 1
    assert s.occupancy == 1.0
    c = s.retire(0, "length", 1.0)
    assert c.status == "ok" and c.rid == 0
    slot, req = s.next_admission(1.0)
    assert (slot, req.rid) == (0, 2)        # the freed slot, reused at once
    assert not s.queue and s.has_work()


def test_scheduler_validates_requests():
    s = Scheduler(num_slots=1, max_len=16, prefill_len=8)
    with pytest.raises(ValueError, match="prompt_len"):
        s.submit(_req(0, plen=9))
    with pytest.raises(ValueError, match="max_len"):
        s.submit(_req(0, plen=8, gen=9))
    with pytest.raises(ValueError):
        Scheduler(num_slots=1, max_len=8, prefill_len=16)
    with pytest.raises(ValueError):
        Scheduler(num_slots=1, max_len=16, prefill_len=8, max_queue=0)


def test_scheduler_bounded_queue_and_deadlines():
    s = Scheduler(num_slots=1, max_len=16, prefill_len=8, max_queue=2)
    assert s.submit(_req(0, deadline=3.0)) is None
    assert s.submit(_req(1, t=1.0)) is None
    rej = s.submit(_req(2))
    assert rej.status == "rejected" and rej.finish_reason == "queue_full"
    shed = s.shed_expired(5.0)
    assert [c.rid for c in shed] == [0] and shed[0].status == "timed_out"
    assert [r.rid for r in s.queue] == [1] and s.next_arrival() == 1.0


def test_scheduler_clock_never_runs_backwards():
    s = Scheduler(num_slots=1, max_len=16, prefill_len=8)
    s.submit(_req(0, t=5.0))
    assert s.next_admission(6.0) is not None
    s.retire(0, "eos", 6.0)
    s.submit(_req(1, t=5.5))
    # a backwards clock jump to 0 still admits the already-arrived request
    assert s.next_admission(0.0) is not None


def test_synthetic_stream_is_seeded():
    a = synthetic_stream(5, vocab_size=100, prompt_len=(2, 6),
                         max_new_tokens=(1, 3), rate=0.5, seed=4)
    b = synthetic_stream(5, vocab_size=100, prompt_len=(2, 6),
                         max_new_tokens=(1, 3), rate=0.5, seed=4)
    assert [r.rid for r in a] == list(range(5))
    for x, y in zip(a, b):
        assert np.array_equal(x.tokens, y.tokens) and x.arrival_time == y.arrival_time
        assert 2 <= x.prompt_len <= 6 and 1 <= x.max_new_tokens <= 3
    times = [r.arrival_time for r in a]
    assert times == sorted(times)
    d = synthetic_stream(2, vocab_size=10, prompt_len=(1, 1),
                         max_new_tokens=(2, 2), seed=0, deadline_slack=1.0)
    assert d[0].deadline == d[0].arrival_time + 3.0
    with pytest.raises(ValueError):
        synthetic_stream(1, vocab_size=10, prompt_len=(1, 1),
                         max_new_tokens=(1, 1), rate=0.0)
