"""PyTorch port, mixture of experts and llama4-maverick-400b-a17b: the
published config, the MoE block against the reference's ``apply_moe``, the
bridge's (attn, moe) interleave, and a scaled-down maverick (2 (attn, moe)
groups, 4 experts top-1 plus a shared expert; fp8_e4m3 and int8 Hadamard
quantization with the KV cache quantized alike, int8 weight storage) with
the reference's own parameters carried across by ``repro_torch.bridge``,
against the un-meshed reference ``lm_prefill`` + ``lm_decode_step``
(backend ``pallas`` in interpret mode, jitted as written:
``xla_allow_excess_precision`` off) on the CPU. d_ff is a power of 2, so
both packages run the fused expert down projection: the reference its
rotate-once Pallas expert kernel (``pltpu.TPUCompilerParams`` aliased to
``CompilerParams`` inside the tests only), the port K6's plain version
through its ``cuda`` backend.

Tolerances, from readings over seeds (``python tests/test_torch_moe.py``
prints them):

* ``apply_moe``: the block's output within ``MOE_TOL`` of its largest
  |value|, elementwise. The expert and shared-expert GEMMs sum bf16 products
  in another order on XLA's CPU dot than on torch's, so single bf16 values
  of h flip; the rotation spreads a flip over its row and the fp8 / int8
  step after it can move a grid point.
* the model: logits at every one of the 9 steps (prefill, then 8 decode
  steps, both packages fed the reference's greedy token) within
  ``LOGIT_TOL`` of the largest |logit| elementwise and ``REL_TOL``
  relative RMS; the port's greedy token equals the reference's wherever the
  reference's top-1/top-2 logit margin exceeds twice the step's largest
  logit gap (the margin rule of ``test_torch_phi4.py``); and every MoE
  layer routes each token to the reference's top-1 expert wherever the
  reference's top-1/top-2 gate margin exceeds the step's largest gate gap.
  After a step at which some token's routing flipped (a near tie), that
  token runs another expert in the two packages and its state carries the
  difference on, so the logit tolerances hold up to that step.

Readings (``python tests/test_torch_moe.py``): ``apply_moe`` at most
0.00558 of max |y| over seeds 0-7 (capacity drops 0.00558, top-2 int8
0.00467, quantized router 0.00345, unrotated int8 0.00250, unquantized
0.00208). The model, seeds 0-7: fp8 logit gaps at
most 0.0326 of max |logit| and 0.0270 relative RMS, int8 0.0154 and 0.0130;
one routing flip at fp8 seed 2 (decode step 3) and int8 seeds 1 and 5
(prefill), each at a top-1/top-2 gate margin below the step's gate gap;
greedy tokens agree by the margin rule at every seed and step. The tests
take fp8 seeds 0, 1 and 2 (a flip) and int8 seed 0.
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
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import wquant
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import quant_dot as qd
from repro_torch.kernels import registry
from repro_torch.models import mlp
from repro_torch.models.lm import (_layer_params, init_lm, lm_decode_step,
                                   lm_forward, lm_prefill, pad_kv_caches)

OVER = dict(d_model=256, num_heads=2, num_kv_heads=1, head_dim=128, d_ff=256)
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


def _port_tree(t):
    """A reference subtree (QTensors, arrays) as the port's, on the CPU."""
    if isinstance(t, JQTensor):
        return wquant.QTensor(to_torch(np.asarray(t.q), "cpu"),
                              to_torch(np.asarray(t.scale), "cpu"), t.mode)
    if isinstance(t, dict):
        return {k: _port_tree(v) for k, v in t.items()}
    return to_torch(np.asarray(t), "cpu")


def _configs(mode="fp8_e4m3", rotate="hadamard", **over):
    kv = mode != "none"
    jq = JQuantConfig(mode=mode, rotate=rotate, backend="pallas", kv_quant=kv)
    tq = QuantConfig(mode=mode, rotate=rotate, backend="cuda", kv_quant=kv)
    over = dict(OVER, **over)
    jcfg = jget_config("llama4_maverick_400b_a17b").scaled_down(**over).with_quant(jq)
    tcfg = get_config("llama4-maverick-400b-a17b").scaled_down(**over).with_quant(tq)
    return (dataclasses.replace(jcfg, weight_quant="int8"),
            dataclasses.replace(tcfg, weight_quant="int8"))


@pytest.fixture
def pallas_alias(monkeypatch):
    """The reference's quant_dot launchers as jax 0.9 can run them."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


# ---------------------------------------------------------------- config
def test_config_is_the_published_shape():
    """The port's maverick config carries the reference's field for field,
    and ``scaled_down`` follows the reference's MoE rule (at most 4
    experts, at most 2 per token)."""
    cfg, ref = (get_config("llama4-maverick-400b-a17b"),
                jget_config("llama4_maverick_400b_a17b"))
    assert "llama4_maverick_400b_a17b" in ARCH_IDS
    assert get_config("llama4_maverick_400b_a17b") is cfg
    for f in ("name", "family", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "groups", "head_dim", "rope_theta",
              "vocab_pad_multiple", "tie_embeddings", "num_experts",
              "experts_per_token", "moe_shared_expert", "capacity_factor"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.num_layers, cfg.num_experts, cfg.experts_per_token,
            cfg.moe_shared_expert, cfg.capacity_factor) == (
        5120, 40, 8, 128, 8192, 202048, 48, 128, 1, True, 1.25)
    assert cfg.layer_kinds[:4] == ("attn", "moe", "attn", "moe")
    for over in ({}, OVER, dict(experts_per_token=3)):
        small, jsmall = cfg.scaled_down(**over), ref.scaled_down(**over)
        for f in ("num_experts", "experts_per_token", "d_ff", "groups"):
            assert getattr(small, f) == getattr(jsmall, f), (over, f)
    assert cfg.scaled_down().num_experts == 4
    mixtral = dataclasses.replace(cfg, num_experts=8, experts_per_token=2)
    assert (mixtral.scaled_down().num_experts,
            mixtral.scaled_down().experts_per_token) == (4, 2)


# ---------------------------------------------------------- the MoE block
def _jlayer_params(jcfg, tree, keys=()):
    """The reference's per-layer dequantization (``lm._dequant_layer``):
    every QTensor to bf16 except a consumer stored in the rotation-quant
    mode."""
    from repro.core.wquant import _is_consumer

    qc = jcfg.quant
    if isinstance(tree, JQTensor):
        if qc.rotating and qc.enabled and tree.mode == qc.mode and _is_consumer(keys):
            return tree
        return tree.dequant(jnp.bfloat16)
    if isinstance(tree, dict):
        return {k: _jlayer_params(jcfg, v, keys + (k,)) for k, v in tree.items()}
    return tree


def _moe_case(seed, mode="fp8_e4m3", seq=S, skew=0.0, rotate="hadamard", **over):
    """A reference MoE layer (init_moe, then quantize_lm_weights' storage
    with the stacked (layers=1) size rule) and its twin through each
    package's per-layer dequantization (the router dequantized to bf16 when
    quantized, gate/up dequantized, the expert w_down kept in the rotation-
    quant mode), plus seeded bf16 input. ``skew`` adds a multiple of
    router column 0 to every token, so most tokens pick expert 0 and the
    capacity drops some."""
    jcfg, tcfg = _configs(mode, rotate, **over)
    key = jax.random.PRNGKey(seed)
    jp = jax.jit(lambda k: jquantize_lm_weights(
        {"groups": [{"p1": {"moe": jax.tree.map(
            lambda a: a[None], jmlp.init_moe(k, jcfg))}}]}, jcfg))(key)
    jlayer = jax.tree.map(lambda a: a[0], jp["groups"][0]["p1"])
    jmoe = _jlayer_params(jcfg, jlayer)["moe"]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, seq, jcfg.d_model)).astype(np.float32)
    if skew:
        r0 = np.asarray(jmoe["router"], np.float32)[:, 0]
        x = x + skew * r0 / np.linalg.norm(r0) * np.sqrt(jcfg.d_model)
    tp = _layer_params(tcfg, _port_tree(jlayer), torch.bfloat16)["moe"]
    return jcfg, tcfg, jmoe, tp, x


def _moe_outputs(case):
    jcfg, tcfg, jmoe, tp, x = case
    jy, jaux = jax.jit(lambda p, a: jmlp.apply_moe(jcfg, p, a),
                       compiler_options=AS_WRITTEN)(jmoe, jnp.asarray(x, jnp.bfloat16))
    ty, taux = mlp.apply_moe(tcfg, tp, torch.from_numpy(x).to(torch.bfloat16))
    w = np.asarray(jy.astype(jnp.float32))
    g = ty.float().numpy()
    return g, w, float(jaux), float(taux)


def _routing(cfg, router, x):
    """Top-1 expert, top-1/top-2 gate margin and per-expert token counts of
    x (B, S, d) f32 against a (d, E) router, in numpy f64."""
    logits = x.astype(np.float64) @ np.asarray(router, np.float64)
    g = np.exp(logits - logits.max(-1, keepdims=True))
    g /= g.sum(-1, keepdims=True)
    top = np.sort(g, -1)
    counts = np.stack([np.bincount(r, minlength=cfg.num_experts)
                       for r in g.argmax(-1)])
    return g.argmax(-1), top[..., -1] - top[..., -2], counts


MOE_CASES = [   # name, mode, rotate, config overrides, skew
    ("capacity_drops", "fp8_e4m3", "hadamard", dict(), 1.5),
    ("top2", "int8", "hadamard", dict(experts_per_token=2), 0.0),
    ("quantized_router", "fp8_e4m3", "hadamard",
     dict(d_model=512, num_experts=128, d_ff=128), 0.0),
    ("unrotated", "int8", "none", dict(), 0.0),
    ("unquantized", "none", "hadamard", dict(), 0.0),
]


@pytest.mark.parametrize("name, mode, rotate, over, skew", MOE_CASES)
def test_apply_moe_matches_reference(pallas_alias, name, mode, rotate, over, skew):
    """The port's ``apply_moe`` on the reference's parameters and input:
    capacity dropping (64 tokens routed mostly to one of 4 experts, cap 20),
    top-2 routing, a router large enough to be stored in int8 (512 x 128 =
    2^16 elements), dequantized to bf16 as the layer body does; and the
    expert sites without a rotation (int8 fake-quantized operands) and
    without quantization (the rotated bf16 einsum)."""
    seq = 64 if name == "capacity_drops" else S
    case = _moe_case(3, mode, seq=seq, skew=skew, rotate=rotate, **over)
    jcfg, tcfg, jmoe, tp, x = case
    router = tp["router"].float().numpy()
    if name == "quantized_router":
        assert tp["router"].dtype == torch.bfloat16      # dequantized int8 router
        assert wquant.leaf_mode(("layers", "moe", "router"),
                                (jcfg.d_model, jcfg.num_experts), torch.float32,
                                tcfg) == "int8"
    else:
        assert tp["router"].dtype == torch.float32
    down = tp["experts"]["w_down"]
    if rotate == "hadamard" and mode != "none":
        assert isinstance(down, wquant.QTensor) and down.mode == mode
    else:                       # dequantized: no site consumes it quantized
        assert down.dtype == torch.bfloat16
    top1, _, counts = _routing(tcfg, router, torch.from_numpy(x).to(
        torch.bfloat16).float().numpy())
    cap = max(1, int(tcfg.capacity_factor * seq * tcfg.experts_per_token
                     / tcfg.num_experts))
    if name == "capacity_drops":
        assert cap == 20 and counts.max() > cap          # some tokens dropped
    g, w, jaux, taux = _moe_outputs(case)
    assert g.shape == w.shape == x.shape and np.isfinite(g).all()
    assert np.abs(g - w).max() <= MOE_TOL * np.abs(w).max(), np.abs(g - w).max()
    assert taux == pytest.approx(jaux, rel=1e-5)


# ------------------------------------------------------------- the bridge
def test_bridge_interleaves_attn_and_moe(model_fp8):
    """The reference stacks each pattern position over the repeats (``p0``
    attention + dense MLP, ``p1`` attention + MoE); the bridge unrolls them
    into execution order, the expert stacks (layers, E, ...) sliced per
    layer with their per-(expert, out-channel) scales."""
    jcfg, tcfg, jp, params = model_fp8
    assert len(params["layers"]) == tcfg.num_layers == 4
    assert [("moe" in lp) for lp in params["layers"]] == [False, True, False, True]
    g = jp["groups"][0]
    for i, lp in enumerate(params["layers"]):
        src = g[f"p{i % 2}"]
        r = i // 2
        np.testing.assert_array_equal(lp["attn"]["wq"].q.numpy(),
                                      np.asarray(src["attn"]["wq"].q[r]))
        if i % 2:
            ex, jex = lp["moe"]["experts"], src["moe"]["experts"]
            assert ex["w_down"].mode == "fp8_e4m3" and ex["w_gate"].mode == "int8"
            assert ex["w_down"].q.shape == (4, jcfg.d_ff, jcfg.d_model)
            assert ex["w_down"].scale.shape == (4, 1, jcfg.d_model)
            np.testing.assert_array_equal(
                ex["w_down"].q.view(torch.uint8).numpy(),
                np.asarray(jex["w_down"].q[r]).view(np.uint8))
            np.testing.assert_array_equal(ex["w_gate"].scale.numpy(),
                                          np.asarray(jex["w_gate"].scale[r]))
            np.testing.assert_array_equal(lp["moe"]["router"].numpy(),
                                          np.asarray(src["moe"]["router"][r]))
            assert lp["moe"]["shared"]["w_down"].mode == "fp8_e4m3"
        else:
            assert lp["mlp"]["w_down"].mode == "fp8_e4m3"


# --------------------------------------------------- model against ref
def _build_model(mode):
    jcfg, tcfg = _configs(mode)
    jp = jax.jit(lambda k: jquantize_lm_weights(jinit_lm(k, jcfg), jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_reference(_np_tree(jp), device="cpu")


@pytest.fixture(scope="module")
def model_fp8():
    return _build_model("fp8_e4m3")


@pytest.fixture(scope="module")
def model_int8():
    return _build_model("int8")


def _prompt(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _gates_spy(record):
    """A stand-in for the reference's ``apply_moe`` that hands each call's
    router gates to ``record`` (a host callback) and then runs the real
    block."""
    real = jmlp.apply_moe

    def spy(cfg, p, x):
        gates = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
        jax.debug.callback(lambda g: record.append(np.asarray(g)), gates)
        return real(cfg, p, x)

    return spy


def _run(model, toks):
    """Prefill, then 8 decode steps in each package, both fed the
    reference's greedy token. Returns per step (prefill first): (largest
    logit gap / largest |logit|, relative RMS gap, tokens-agree-or-near-
    tie, routing flips beyond the margin rule, routing flips in all)."""
    from jax.experimental.pallas import tpu as pltpu

    jcfg, tcfg, jp, params = model
    V = tcfg.vocab_size
    jgates, tgates = [], []
    treal = mlp.apply_moe

    def tspy(cfg, p, x):
        y, aux = treal(cfg, p, x)
        logits = x.to(torch.float32) @ p["router"].to(torch.float32)
        tgates.append(torch.softmax(logits, -1).numpy())
        return y, aux

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        mp.setattr(jmlp, "apply_moe", _gates_spy(jgates))
        mp.setattr(mlp, "apply_moe", tspy)
        jpre = jax.jit(lambda p, b: jlm_prefill(jcfg, p, b),
                       compiler_options=AS_WRITTEN)
        jdec = jax.jit(lambda p, c, t, pos: jlm_decode_step(jcfg, p, c, t, pos),
                       compiler_options=AS_WRITTEN)
        steps = []
        jl, jc = jpre(jp, {"tokens": jnp.asarray(toks)})
        jc = jpad_kv_caches(jcfg, jc, T)
        tl, tc = lm_prefill(tcfg, params, {"tokens": torch.from_numpy(toks).long()})
        tc = pad_kv_caches(tcfg, tc, T)
        for i in range(GEN + 1):
            jax.effects_barrier()
            g = tl[:, -1, :V].float().numpy()
            w = np.asarray(jl[:, -1, :V], np.float32)
            assert np.isfinite(g).all()
            gap = np.abs(g - w).max()
            top = np.sort(w, -1)
            sure = top[:, -1] - top[:, -2] > 2 * gap
            same = (g.argmax(-1) == w.argmax(-1)) | ~sure
            flips = beyond = 0
            assert len(jgates) == len(tgates) == 2
            for jg, tg in zip(jgates, tgates):
                ggap = np.abs(jg - tg).max()
                srt = np.sort(jg, -1)
                differ = jg.argmax(-1) != tg.argmax(-1)
                flips += int(differ.sum())
                beyond += int((differ & (srt[..., -1] - srt[..., -2] > ggap)).sum())
            jgates.clear()
            tgates.clear()
            steps.append((gap / np.abs(w).max(), np.linalg.norm(g - w) / np.linalg.norm(w),
                          bool(same.all()), beyond, flips))
            if i < GEN:
                jt = jnp.argmax(jl[:, -1, :V], -1).astype(jnp.int32)[:, None]
                tt = torch.from_numpy(np.array(jt)).long()
                jl, jc = jdec(jp, jc, jt, jnp.asarray(S + i, jnp.int32))
                tl, tc = lm_decode_step(tcfg, params, tc, tt, torch.tensor(S + i))
    return steps


def _held(steps):
    """The logit gaps the tolerances hold: the steps before the first one
    at which some token's routing flipped (a near tie; after it the two
    packages run different experts for that token, and its state carries
    the difference on)."""
    held = []
    for gap, rel, _, _, flips in steps:
        if flips:
            break
        held.append((gap, rel))
    return held


@pytest.mark.parametrize("mode, seed", [("fp8_e4m3", 0), ("fp8_e4m3", 1),
                                        ("fp8_e4m3", 2), ("int8", 0)])
def test_prefill_and_decode_match_reference(model_fp8, model_int8, mode, seed):
    """Seeds 0 and 1 route every token as the reference does; at fp8 seed 2
    one token's top-1 expert flips at a near tie (allowed by the margin
    rule), after which its logits part from the reference's."""
    model = model_fp8 if mode == "fp8_e4m3" else model_int8
    before = (qd.quant_dot_cuda.launches, qd.quant_dot_experts_cuda.launches)
    steps = _run(model, _prompt(model[1], seed))
    for i, (_, _, same, beyond, _) in enumerate(steps):
        assert same and beyond == 0, (i, same, beyond)
    held = _held(steps)
    assert len(held) >= (1 if seed == 2 else GEN + 1)
    for i, (gap, rel) in enumerate(held):
        assert gap <= LOGIT_TOL and rel <= REL_TOL, (i, gap, rel)
    # CPU tensors launch nothing
    assert (qd.quant_dot_cuda.launches, qd.quant_dot_experts_cuda.launches) == before


def test_moe_layer_is_one_fused_expert_call(model_fp8, monkeypatch):
    """Each MoE layer's expert down projection reaches the backend's
    quant_dot_experts once (K6 on the card); the dense and shared-expert
    down projections reach quant_dot once each (K4); nothing runs the
    standalone transform or the (q, scales) kernel; no weight is quantized."""
    jcfg, tcfg, jp, params = model_fp8
    calls = {"quant_dot": 0, "quant_dot_experts": 0, "transform": 0, "fused": 0,
             "fused_dequant": 0}
    for name in calls:
        real = getattr(registry.CudaBackend, name)

        def spy(self, *a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(registry.CudaBackend, name, spy)
    before = wquant.QUANTIZE_WEIGHT_CALLS
    logits, aux, _ = lm_forward(tcfg, params, {"tokens": torch.from_numpy(
        _prompt(tcfg, 1)).long()})
    assert torch.isfinite(logits[..., :tcfg.vocab_size]).all()
    assert float(aux) > 0
    assert calls == {"quant_dot": 4, "quant_dot_experts": 2, "transform": 0,
                     "fused": 0, "fused_dequant": 8}
    assert wquant.QUANTIZE_WEIGHT_CALLS == before


def test_init_lm_draws_expert_stacks_in_chunks(monkeypatch):
    """init_lm draws and quantizes each expert stack a chunk of experts at
    a time (here 1 expert per chunk) into the stack's storage; dequantizing
    by chunks gives the whole-stack values."""
    _, tcfg = _configs("fp8_e4m3")
    monkeypatch.setattr(wquant, "CHUNK_ELEMS", tcfg.d_model * tcfg.d_ff)
    calls = wquant.QUANTIZE_WEIGHT_CALLS
    params = init_lm(tcfg, seed=1, device="cpu")
    ex = params["layers"][1]["moe"]["experts"]
    # 3 stacks x 4 experts per MoE layer, one call per chunk
    assert wquant.QUANTIZE_WEIGHT_CALLS - calls >= 2 * 3 * 4
    assert ex["w_gate"].mode == "int8" and ex["w_down"].mode == "fp8_e4m3"
    assert ex["w_gate"].q.shape == (4, tcfg.d_model, tcfg.d_ff)
    assert ex["w_down"].scale.shape == (4, 1, tcfg.d_model)
    assert params["layers"][1]["moe"]["router"].dtype == torch.float32
    whole = (ex["w_gate"].q.float() * ex["w_gate"].scale).to(torch.bfloat16)
    assert torch.equal(ex["w_gate"].dequant(torch.bfloat16), whole)
    assert "mlp" in params["layers"][0] and "moe" not in params["layers"][0]
    # without weight quantization the stacks stay in the model dtype
    raw = init_lm(dataclasses.replace(tcfg, weight_quant="none"), seed=1,
                  device="cpu")["layers"][1]["moe"]["experts"]
    assert raw["w_down"].dtype == torch.bfloat16
    assert raw["w_down"].shape == (4, tcfg.d_ff, tcfg.d_model)


def test_serve_loop_serves_maverick_on_cpu(capsys):
    from repro_torch.launch import serve_loop

    engine = serve_loop.main([
        "--arch", "llama4-maverick-400b-a17b", "--device", "cpu", "--scale",
        "0.005", "--quant", "fp8_e4m3", "--rotate", "hadamard", "--requests", "3",
        "--slots", "2", "--max-len", "64", "--prefill-len", "16"])
    s = engine.summary()
    assert s["requests"] == 3 and s["quantize_weight_calls"] == 0
    assert engine.cfg.num_experts == 128 and "moe" in engine.cfg.layer_kinds
    out = capsys.readouterr().out
    assert "llama4-maverick-400b-a17b" in out and "quant=fp8_e4m3" in out


if __name__ == "__main__":
    # The readings behind MOE_TOL, LOGIT_TOL and REL_TOL:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_moe.py
    from jax.experimental.pallas import tpu as _pltpu

    _pltpu.TPUCompilerParams = _pltpu.CompilerParams
    for name, mode, rotate, over, skew in MOE_CASES:
        worst = 0.0
        for seed in range(8):
            g, w, _, _ = _moe_outputs(_moe_case(
                seed, mode, seq=64 if name == "capacity_drops" else S, skew=skew,
                rotate=rotate, **over))
            worst = max(worst, np.abs(g - w).max() / np.abs(w).max())
        print(f"apply_moe {name}: largest gap {worst:.5f} of max |y| over seeds 0-7")
    for mode in ("fp8_e4m3", "int8"):
        m = _build_model(mode)
        for seed in range(8):
            st = _run(m, _prompt(m[1], seed))
            held = _held(st) or [(np.nan, np.nan)]
            print(f"{mode} seed {seed}: {len(_held(st))} steps before a routing "
                  f"flip, largest gap there {max(x[0] for x in held):.4f} of max "
                  f"|logit|, relative RMS {max(x[1] for x in held):.4f}; tokens "
                  f"agree (margin rule) {all(x[2] for x in st)}, routing flips "
                  f"{sum(x[4] for x in st)} ({sum(x[3] for x in st)} beyond the margin)")
