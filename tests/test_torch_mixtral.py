"""PyTorch port, mixtral-8x7b: top-2 routing over 8 experts, sliding-window
attention, and an expert d_ff (14336 = 7 x 2048; 96 = 3 x 32 scaled) that
is not a power of 2, so the expert down projection never fuses into K6: one
grouped rotation over the dispatched rows per layer (K1 on the card), then
the einsum form per expert. Scaled down by the reference's own
``scaled_down`` (2 layers, 4 experts top-2, window 8 tokens), int8 W8A8 +
Hadamard with the KV cache quantized alike and int8 weight storage, with
the reference's own parameters carried across by ``repro_torch.bridge``,
against the un-meshed reference ``lm_prefill`` + ``lm_decode_step``
(backend ``pallas``, jitted as written: ``xla_allow_excess_precision``
off) on the CPU. int8 only: the reference's fp8 expert einsum does not run
on XLA's CPU backend (``BF16 x BF16 = F32`` dots), so mixtral's fp8 path is
held on the card, against the port's plain path.

Prompts are 16 tokens against the window of 8, so the window bites in the
prefill and at every decode step, with a shared scalar ``cache_pos`` (the
one-shot launcher's form) and with per-slot positions (the engine's).

Tolerances, as ``test_torch_moe.py``'s: logits within ``LOGIT_TOL`` of the
largest |logit| elementwise and ``REL_TOL`` relative RMS at every step up
to the first at which some token's top-2 experts differ from the
reference's (in order) at a near tie (after it the two packages run
different experts for that token); greedy tokens by the margin rule; every
routing flip at a gate margin (the smallest gap among the token's 3
largest gates) below the step's largest gate gap.
``apply_moe`` within ``MOE_TOL`` of its largest |value|. Readings over
prompt seeds 0-5: ``python tests/test_torch_mixtral.py``.
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
from repro.models import mlp as jmlp
from repro.models.lm import pad_kv_caches as jpad_kv_caches

from repro_torch.bridge import params_from_reference, to_torch
from repro_torch.configs import get_config
from repro_torch.core import wquant
from repro_torch.core.api import QuantEpilogue, _qd_experts_fusable, plan_for
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import registry
from repro_torch.kernels.hadacore import hadacore_cuda
from repro_torch.kernels.quant_dot import _resolve_schedule
from repro_torch.kernels.registry import WARN_ONCE_SEEN
from repro_torch.models import mlp
from repro_torch.models.lm import (_layer_params, lm_decode_step, lm_forward,
                                   lm_prefill, pad_kv_caches)
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import _degradation_ladder
from repro_torch.testing.faults import FaultPlan, arrival_flood, inject

B, S, GEN, T = 2, 16, 8, 32
MOE_TOL = 0.015
LOGIT_TOL, REL_TOL = 0.05, 0.04
AS_WRITTEN = {"xla_allow_excess_precision": False}


def _np_tree(t):
    if isinstance(t, JQTensor):
        return {"q": np.asarray(t.q), "scale": np.asarray(t.scale), "mode": t.mode}
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


def _configs(backend="cuda", **over):
    jq = JQuantConfig(mode="int8", rotate="hadamard", backend="pallas", kv_quant=True)
    tq = QuantConfig(mode="int8", rotate="hadamard", backend=backend, kv_quant=True)
    jcfg = jget_config("mixtral_8x7b").scaled_down(**over).with_quant(jq)
    tcfg = get_config("mixtral-8x7b").scaled_down(**over).with_quant(tq)
    return (dataclasses.replace(jcfg, weight_quant="int8"),
            dataclasses.replace(tcfg, weight_quant="int8"))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _configs()
    assert (tcfg.sliding_window, tcfg.num_experts, tcfg.experts_per_token,
            tcfg.d_ff) == (8, 4, 2, 96)
    jp = jax.jit(lambda k: jquantize_lm_weights(jinit_lm(k, jcfg), jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_reference(_np_tree(jp), device="cpu")


def _prompt(cfg, seed, length=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, length)).astype(np.int32)


def _gates_spy(record):
    """The reference's ``apply_moe``, handing each call's router gates to
    ``record`` (a host callback) before it runs."""
    real = jmlp.apply_moe

    def spy(cfg, p, x):
        gates = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
        jax.debug.callback(lambda g: record.append(np.asarray(g)), gates)
        return real(cfg, p, x)

    return spy


def _run(model, toks, per_slot=False, lag=0):
    """Prefill, then 8 decode steps in each package, both fed the
    reference's greedy token, at a shared scalar position or (``per_slot``)
    at per-slot positions, slot 1 ``lag`` rows behind slot 0 (it rewrites
    cache rows it already holds; the masks follow each slot's position).
    Per step: (largest logit gap / largest |logit|, relative RMS gap,
    tokens agree by the margin rule, routing flips beyond the gate-gap
    rule, routing flips in all, top-2 ties)."""
    jcfg, tcfg, jp, params = model
    V = tcfg.vocab_size
    jgates, tgates = [], []
    treal = mlp.apply_moe

    def tspy(cfg, p, x):
        tgates.append(torch.softmax(x.to(torch.float32) @ p["router"].to(torch.float32),
                                    -1).numpy())
        return treal(cfg, p, x)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmlp, "apply_moe", _gates_spy(jgates))
        mp.setattr(mlp, "apply_moe", tspy)
        jpre = jax.jit(lambda p, b: jlm_prefill(jcfg, p, b), compiler_options=AS_WRITTEN)
        jdec = jax.jit(lambda p, c, t, pos: jlm_decode_step(jcfg, p, c, t, pos),
                       compiler_options=AS_WRITTEN)
        jl, jc = jpre(jp, {"tokens": jnp.asarray(toks)})
        jc = jpad_kv_caches(jcfg, jc, T)
        tl, tc = lm_prefill(tcfg, params, {"tokens": torch.from_numpy(toks).long()})
        tc = pad_kv_caches(tcfg, tc, T)
        steps = []
        for i in range(GEN + 1):
            jax.effects_barrier()
            g = tl[:, -1, :V].float().numpy()
            w = np.asarray(jl[:, -1, :V], np.float32)
            assert np.isfinite(g).all()
            gap = np.abs(g - w).max()
            top = np.sort(w, -1)
            sure = top[:, -1] - top[:, -2] > 2 * gap
            flips = beyond = ties = 0
            assert len(jgates) == len(tgates) == tcfg.num_layers
            K = tcfg.experts_per_token
            for jg, tg in zip(jgates, tgates):
                # a token flips when its top-K experts (in order) differ; its
                # margin is the smallest gap among its K + 1 largest gates
                srt = -np.sort(-jg, -1)[..., :K + 1]
                margin = (srt[..., :-1] - srt[..., 1:]).min(-1)
                differ = (np.argsort(-jg, -1, kind="stable")[..., :K]
                          != np.argsort(-tg, -1, kind="stable")[..., :K]).any(-1)
                flips += int(differ.sum())
                beyond += int((differ & (margin > np.abs(jg - tg).max())).sum())
                ties += int((margin == 0).sum())
            jgates.clear()
            tgates.clear()
            steps.append((gap / np.abs(w).max(), np.linalg.norm(g - w) / np.linalg.norm(w),
                          bool(((g.argmax(-1) == w.argmax(-1)) | ~sure).all()), beyond,
                          flips, ties))
            if i < GEN:
                jt = jnp.argmax(jl[:, -1, :V], -1).astype(jnp.int32)[:, None]
                tt = torch.from_numpy(np.array(jt)).long()
                if per_slot:
                    pos = np.array([S + i, S - lag + i], np.int32)
                    jl, jc = jdec(jp, jc, jt, jnp.asarray(pos))
                    tl, tc = lm_decode_step(tcfg, params, tc, tt, torch.from_numpy(pos))
                else:
                    jl, jc = jdec(jp, jc, jt, jnp.asarray(S + i, jnp.int32))
                    tl, tc = lm_decode_step(tcfg, params, tc, tt, torch.tensor(S + i))
    return steps


def _check(steps, min_held):
    held = 0
    for i, (gap, rel, same, beyond, flips, ties) in enumerate(steps):
        assert same and beyond == 0 and ties == 0, (i, same, beyond, ties)
        if flips:
            break
        assert gap <= LOGIT_TOL and rel <= REL_TOL, (i, gap, rel)
        held += 1
    assert held >= min_held, held


# --------------------------------------------------- model against ref
@pytest.mark.parametrize("per_slot, lag", [(False, 0), (True, 0), (True, 3)])
def test_prefill_and_decode_match_reference(model, per_slot, lag):
    """The windowed prefill and 8 windowed decode steps against the
    reference: at a shared scalar position, at per-slot positions, and with
    slot 1 three rows behind slot 0; CPU tensors launch no kernel."""
    before = hadacore_cuda.launches
    _check(_run(model, _prompt(model[1], 0), per_slot, lag), GEN + 1)
    assert hadacore_cuda.launches == before


def test_per_slot_positions_are_the_scalar_position(model):
    """Per-slot positions that all equal the scalar one give bitwise its
    logits and caches (the two decode masks agree)."""
    _, tcfg, _, params = model
    toks = torch.from_numpy(_prompt(tcfg, 1)).long()
    runs = []
    for per_slot in (False, True):
        logits, caches = lm_prefill(tcfg, params, {"tokens": toks})
        caches = pad_kv_caches(tcfg, caches, T)
        tok = logits[:, -1, :tcfg.vocab_size].argmax(-1)[:, None]
        outs = []
        for i in range(4):
            pos = torch.full((B,), S + i) if per_slot else torch.tensor(S + i)
            logits, caches = lm_decode_step(tcfg, params, caches, tok, pos)
            tok = logits[:, -1, :tcfg.vocab_size].argmax(-1)[:, None]
            outs.append(logits)
        runs.append((outs, caches))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_the_window_bites(model):
    """With the window of 8 the prefill's first 8 positions are bitwise
    those of full attention (the masks agree there) and every later
    position differs; decode steps past the window differ too. The control
    ``sliding_window=0`` is full attention."""
    _, tcfg, _, params = model
    full = dataclasses.replace(tcfg, sliding_window=0)
    toks = torch.from_numpy(_prompt(tcfg, 2)).long()
    win, _, cw = lm_forward(tcfg, params, {"tokens": toks}, want_cache=True)
    ctl, _, cf = lm_forward(full, params, {"tokens": toks}, want_cache=True)
    w = tcfg.sliding_window
    assert torch.equal(win[:, :w], ctl[:, :w])
    V = tcfg.vocab_size
    rel = ((win[:, w:, :V] - ctl[:, w:, :V]).float().norm(dim=-1)
           / ctl[:, w:, :V].float().norm(dim=-1))
    assert bool((rel > 0.05).all()), rel
    tok = win[:, -1, :V].argmax(-1)[:, None]
    lw, _ = lm_decode_step(tcfg, params, pad_kv_caches(tcfg, cw, T), tok, torch.tensor(S))
    lf, _ = lm_decode_step(full, params, pad_kv_caches(full, cf, T), tok, torch.tensor(S))
    assert float((lw - lf)[..., :V].float().norm() / lf[..., :V].float().norm()) > 0.05


# ---------------------------------------------------------- the MoE block
def _moe_case(seed, seq=64, skew=1.5):
    """A reference mixtral MoE layer (init_moe, then the stacked storage
    rule) and its twin through each package's per-layer dequantization,
    plus bf16 input; ``skew`` adds a multiple of router column 0 to every
    token, so most tokens pick expert 0 and the capacity drops some."""
    from repro.core.wquant import _is_consumer

    jcfg, tcfg = _configs()
    jp = jax.jit(lambda k: jquantize_lm_weights(
        {"groups": [{"p0": {"moe": jax.tree.map(
            lambda a: a[None], jmlp.init_moe(k, jcfg))}}]}, jcfg))(jax.random.PRNGKey(seed))
    jlayer = jax.tree.map(lambda a: a[0], jp["groups"][0]["p0"])

    def jdequant(t, keys=()):
        if isinstance(t, JQTensor):
            keep = t.mode == jcfg.quant.mode and _is_consumer(keys)
            return t if keep else t.dequant(jnp.bfloat16)
        if isinstance(t, dict):
            return {k: jdequant(v, keys + (k,)) for k, v in t.items()}
        return t

    def port(t):
        if isinstance(t, JQTensor):
            return wquant.QTensor(to_torch(np.asarray(t.q), "cpu"),
                                  to_torch(np.asarray(t.scale), "cpu"), t.mode)
        if isinstance(t, dict):
            return {k: port(v) for k, v in t.items()}
        return to_torch(np.asarray(t), "cpu")

    jmoe = jdequant(jlayer)["moe"]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, seq, jcfg.d_model)).astype(np.float32)
    r0 = np.asarray(jmoe["router"], np.float32)[:, 0]
    x = x + skew * r0 / np.linalg.norm(r0) * np.sqrt(jcfg.d_model)
    tp = _layer_params(tcfg, port(jlayer), torch.bfloat16)["moe"]
    return jcfg, tcfg, jmoe, tp, x


def test_top2_dispatch_with_capacity_drops_matches_reference():
    """The MoE block on a skewed batch (64 tokens, most routed to expert 0:
    capacity 40 per expert, some top-2 assignments dropped) against the
    reference's ``apply_moe``: the output within ``MOE_TOL`` of its largest
    |value|, the load-balancing loss to 1e-5. The expert down projection is
    the einsum form (d_ff 96 is not a power of 2) on int8 weights."""
    jcfg, tcfg, jmoe, tp, x = _moe_case(3)
    assert isinstance(tp["experts"]["w_down"], wquant.QTensor)
    assert tp["experts"]["w_down"].mode == "int8"
    cap = max(1, int(tcfg.capacity_factor * 64 * 2 / tcfg.num_experts))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gates = torch.softmax(xb.float() @ tp["router"].float(), -1)
    counts = torch.zeros(tcfg.num_experts)
    for b in range(B):
        counts = torch.maximum(counts, torch.bincount(
            gates[b].topk(2, -1).indices.reshape(-1), minlength=tcfg.num_experts).float())
    assert cap == 40 and counts.max() > cap            # some tokens dropped
    g, w, jaux, taux = _moe_outputs((jcfg, tcfg, jmoe, tp, x))
    assert np.isfinite(g).all() and g.shape == x.shape
    assert np.abs(g - w).max() <= MOE_TOL * np.abs(w).max(), np.abs(g - w).max()
    assert taux == pytest.approx(jaux, rel=1e-5)


def _moe_outputs(case):
    jcfg, tcfg, jmoe, tp, x = case
    jy, jaux = jax.jit(lambda p, a: jmlp.apply_moe(jcfg, p, a),
                       compiler_options=AS_WRITTEN)(jmoe, jnp.asarray(x, jnp.bfloat16))
    ty, taux = mlp.apply_moe(tcfg, tp, torch.from_numpy(x).to(torch.bfloat16))
    return ty.float().numpy(), np.asarray(jy.astype(jnp.float32)), float(jaux), float(taux)


def test_expert_site_is_one_grouped_rotation_per_layer(model, monkeypatch):
    """Each MoE layer's expert down projection reaches the backend's
    standalone transform once (grouped: K1 on the card) and never the fused
    expert kernel (K6); the Q and K sites reach fused_dequant (K2); no
    weight is quantized."""
    _, tcfg, _, params = model
    calls = {n: 0 for n in ("transform", "fused_dequant", "fused", "quant_dot",
                            "quant_dot_experts")}
    for name in calls:
        real = getattr(registry.CudaBackend, name)

        def spy(self, *a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(registry.CudaBackend, name, spy)
    before = wquant.QUANTIZE_WEIGHT_CALLS
    logits, aux, _ = lm_forward(tcfg, params, {"tokens": torch.from_numpy(
        _prompt(tcfg, 1)).long()})
    assert torch.isfinite(logits[..., :tcfg.vocab_size]).all() and float(aux) > 0
    L = tcfg.num_layers
    assert calls == {"transform": L, "fused_dequant": 2 * L, "fused": 0,
                     "quant_dot": 0, "quant_dot_experts": 0}
    assert wquant.QUANTIZE_WEIGHT_CALLS == before


# ------------------------------------------------------------- serving
def test_right_padded_bucket_prefill_is_exact_with_the_window(model):
    """The engine's prefill right-pads a prompt to its bucket: under the
    window (and causal) mask no real position sees the padding, so with a
    capacity that drops no token the real positions' logits are bitwise
    those of the unpadded prompt (12 tokens, bucket 16, window 8); the
    engine's first token is the unpadded prefill's greedy token."""
    _, tcfg, _, params = model
    cfg = dataclasses.replace(tcfg, capacity_factor=4.0)
    toks = torch.from_numpy(_prompt(cfg, 5, 12)).long()
    padded = torch.cat([toks, torch.zeros((B, S - 12), dtype=torch.long)], 1)
    got = lm_forward(cfg, params, {"tokens": padded})[0][:, :12]
    want = lm_forward(cfg, params, {"tokens": toks})[0]
    assert torch.equal(got, want)
    reqs = arrival_flood(1, prompt_len=12, max_new_tokens=2, vocab=cfg.vocab_size, seed=6)
    comp = ServeEngine(cfg, params, num_slots=2, max_len=T, prefill_len=S,
                       device="cpu").run(reqs)[0]
    first = lm_forward(cfg, params, {"tokens": torch.from_numpy(reqs[0].tokens[None]).long()})[0]
    assert comp.status == "ok" and comp.tokens[0] == int(first[0, -1, :cfg.vocab_size].argmax())


def test_ladder_rungs_never_fuse_the_expert_site():
    """At the published width the expert site has no fused kernel on any
    rung of the card's ladder (streamed -> rotate-once) or of the CPU's
    (then torch): each rung is the einsum form."""
    for sched in ("streamed", "revisit", None, "rotate_once"):
        q = QuantConfig(mode="fp8_e4m3", rotate="hadamard", backend="cuda",
                        kv_quant=True, schedule=sched)
        cfg = get_config("mixtral-8x7b").with_quant(q)
        for dev in ("cuda", "cpu"):
            rungs = _degradation_ladder(cfg, torch.device(dev))
            assert len(rungs) == 1 + (sched != "rotate_once") + (dev == "cpu"), (sched, dev)
            for c in rungs:
                plan = plan_for(cfg.d_ff, dtype="bfloat16", backend=c.quant.backend,
                                epilogue=QuantEpilogue(c.quant.mode), device_type=dev)
                assert plan.grouped
                assert not _qd_experts_fusable(plan, _resolve_schedule(
                    c.quant.schedule, experts=True))


def test_engine_serves_scaled_mixtral_down_the_ladder(model):
    """The engine serves 4 requests on 2 slots (prompts of 16 tokens, twice
    the window) to completion; each request's first token is the argmax of
    its own prompt's prefill; then the same requests with a kernel raise
    that persists through the retry and the rotate-once rung finish on the
    torch rung with bitwise the same tokens."""
    _, tcfg, _, params = model
    cfg = tcfg.with_quant(dataclasses.replace(tcfg.quant, backend="auto"))
    reqs = arrival_flood(4, prompt_len=S, max_new_tokens=6, vocab=cfg.vocab_size, seed=4)
    before = wquant.QUANTIZE_WEIGHT_CALLS

    def engine():
        return ServeEngine(cfg, params, num_slots=2, max_len=T + 8, prefill_len=S,
                           device="cpu")

    comps = {c.rid: c for c in engine().run(reqs)}
    assert len(comps) == 4 and all(c.status == "ok" and len(c.tokens) == 6
                                   for c in comps.values())
    for r in reqs:
        logits, _ = lm_prefill(cfg, params, {"tokens": torch.from_numpy(r.tokens[None]).long()})
        assert comps[r.rid].tokens[0] == int(logits[0, -1, :cfg.vocab_size].argmax())
    assert wquant.QUANTIZE_WEIGHT_CALLS == before
    WARN_ONCE_SEEN.discard(("serving", "degrade_torch"))
    eng = engine()
    with pytest.warns(RuntimeWarning, match="degraded to rung 'torch'"), \
            inject(FaultPlan(kernel_raise_at_step=1, kernel_raise_count=3)):
        again = eng.run(reqs)
    assert all(c.status == "ok" and c.tokens == comps[c.rid].tokens for c in again)
    assert eng.health()["rung"] == 2 and eng._run_cfg.quant.backend == "torch"


if __name__ == "__main__":
    # The readings behind the tolerances:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_mixtral.py
    jcfg, tcfg = _configs()
    jp = jax.jit(lambda k: jquantize_lm_weights(jinit_lm(k, jcfg), jcfg))(jax.random.PRNGKey(0))
    m = (jcfg, tcfg, jp, params_from_reference(_np_tree(jp), device="cpu"))
    worst = 0.0
    for seed in range(6):
        g, w, _, _ = _moe_outputs(_moe_case(seed))
        worst = max(worst, float(np.abs(g - w).max() / np.abs(w).max()))
    print(f"apply_moe: largest gap {worst:.5f} of max |y| over seeds 0-5")
    for per_slot, lag in ((False, 0), (True, 3)):
        for seed in range(6):
            st = _run(m, _prompt(tcfg, seed), per_slot, lag)
            held = [s for s in st[:next((i for i, s in enumerate(st) if s[4]), len(st))]]
            print(f"per_slot={per_slot} lag={lag} seed {seed}: {len(held)} steps before a "
                  f"routing flip, largest gap there "
                  f"{max((s[0] for s in held), default=float('nan')):.4f}, relative RMS "
                  f"{max((s[1] for s in held), default=float('nan')):.4f}; tokens agree "
                  f"{all(s[2] for s in st)}, flips {sum(s[4] for s in st)} "
                  f"({sum(s[3] for s in st)} beyond the gate gap), ties {sum(s[5] for s in st)}")
