"""PyTorch port, zamba2-7b: the Mamba2 SSD mixer (the chunked prefill, the
carry across chunks, the recurrent decode, the depthwise conv in both of
the reference's roundings), the hybrid stack of 'mamba' layers with an
'attn' layer every sixth whose head_dim is not a power of 2 (its Q / K
rotation the grouped I_g (x) H_p), ``launch/flops.py``, the bridge of its
two layer groups, the one-shot launcher and the engine's refusal, against
the reference on the CPU: the model scaled down by the reference's own
``scaled_down`` (d_model 56 = 28 x 2 heads, head_dim 28 = 7 x 4 grouped,
d_inner 112 in 7 SSD heads of 16, state 16, d_ff 96 = 3 x 32; 2 x (5 mamba
+ 1 attn) + 2 mamba = 14 layers), the reference's parameters carried across
by ``repro_torch.bridge`` (``init_lm`` and ``quantize_lm_weights``; the
constant f32 leaves ``A_log``, ``D``, ``dt_bias`` and ``norm`` redrawn from
a numpy seed on both sides), the reference jitted as written
(``xla_allow_excess_precision`` off, backend ``pallas`` in interpret mode).

Tolerances (readings: ``python tests/test_torch_zamba2.py``):

* The depthwise conv: bitwise at prefill (a sum of bf16 products in tap
  order, each op rounded) and at decode (f32 sums of the exact products,
  rounded once).
* ``apply_mamba`` and ``decode_mamba`` from the same bf16 inputs: the
  output within ``BF16_TOL`` of the largest |output| (read: bitwise at 40
  tokens, 18 single bf16 flips of 28672 at 256), the f32 state within
  ``STATE_TOL`` relative RMS (read: <= 2.7e-6; XLA's f32 ``exp`` and its
  cumsum order are not torch's), the conv states bitwise.
* The models: logits at every step (prefill, then ``STEPS`` decode steps,
  both packages fed the reference's greedy token) within ``LOGIT_TOL`` of
  the largest |logit| and ``REL_TOL`` relative RMS, tokens by the margin
  rule, as ``tests/test_torch_families.py`` holds its families.
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
from repro.launch import flops as jflops
from repro.launch import shapes as jshapes
from repro.models import init_lm as jinit_lm
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models.lm import pad_kv_caches as jpad_kv_caches

from repro_torch.bridge import params_from_reference, to_reference, to_torch
from repro_torch.configs import get_config
from repro_torch.core import wquant
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import registry
from repro_torch.kernels.fused_quant import fused_dequant_cuda
from repro_torch.kernels.hadacore import hadacore_cuda
from repro_torch.launch import flops, shapes
from repro_torch.models import lm, ssm
from repro_torch.models.lm import init_lm, lm_decode_step, lm_prefill, pad_kv_caches
from test_torch_rwkv import _read, launcher_against_reference

B, S, STEPS = 2, 64, 3
BF16_TOL, STATE_TOL = 0.02, 1e-5
LOGIT_TOL, REL_TOL = 0.05, 0.04
AS_WRITTEN = {"xla_allow_excess_precision": False}
FIELDS = ("name", "family", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
          "groups", "head_dim", "ssm_state", "ssm_head_dim", "ssm_expand", "sub_quadratic",
          "rope_theta", "vocab_pad_multiple", "tie_embeddings", "norm", "dtype")
# the constant f32 leaves of the reference's init, redrawn (mean, spread)
REDRAW = {"A_log": (0.0, 0.5), "D": (1.0, 0.3), "dt_bias": (0.54, 0.5), "norm": (1.0, 0.2)}


def _np_tree(t):
    if isinstance(t, JQTensor):
        return {"q": np.asarray(t.q), "scale": np.asarray(t.scale), "mode": t.mode}
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


def _redraw(tree, rng):
    if isinstance(tree, dict):
        return {k: (jnp.asarray(REDRAW[k][0] + REDRAW[k][1] * rng.standard_normal(v.shape),
                                jnp.float32) if k in REDRAW else _redraw(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_redraw(v, rng) for v in tree]
    return tree


def _configs(mode="fp8_e4m3", rotate="hadamard", weight_quant="int8"):
    jq = JQuantConfig(mode=mode, rotate=rotate, backend="pallas", kv_quant=mode != "none")
    tq = QuantConfig(mode=mode, rotate=rotate, backend="cuda", kv_quant=mode != "none")
    jcfg = jget_config("zamba2_7b").scaled_down().with_quant(jq)
    tcfg = get_config("zamba2-7b").scaled_down().with_quant(tq)
    return (dataclasses.replace(jcfg, weight_quant=weight_quant),
            dataclasses.replace(tcfg, weight_quant=weight_quant))


_MODELS = {}
_JITS = {}     # (mode, rotate) -> the reference's jitted (lm_prefill, lm_decode_step)


def _model(mode, rotate):
    if (mode, rotate) not in _MODELS:
        jcfg, tcfg = _configs(mode, rotate)
        raw = _redraw(jinit_lm(jax.random.PRNGKey(0), jcfg), np.random.default_rng(0))
        jp = jax.jit(lambda p: jquantize_lm_weights(p, jcfg))(raw)
        _MODELS[mode, rotate] = (jcfg, tcfg, jp,
                                 params_from_reference(_np_tree(jp), device="cpu"))
        _JITS[mode, rotate] = (
            jax.jit(lambda p, t: jlm.lm_prefill(jcfg, p, {"tokens": t}),
                    compiler_options=AS_WRITTEN),
            jax.jit(lambda p, c, t, pos: jlm.lm_decode_step(jcfg, p, c, t, pos),
                    compiler_options=AS_WRITTEN))
    return _MODELS[mode, rotate]


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    return to_torch(np.asarray(a), "cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _gap(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------------------------------------------------- config
def test_config_is_the_reference_config():
    """zamba2-7b carries the reference's config field for field (81 layers:
    13 x (5 mamba + 1 attn) + 3 mamba, head_dim 112), and ``scaled_down``
    keeps what the reference's keeps (head_dim 28, not a power of 2)."""
    cfg, ref = get_config("zamba2-7b"), jget_config("zamba2_7b")
    assert get_config("zamba2_7b") is cfg
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(ref, f), f
    small, jsmall = cfg.scaled_down(), ref.scaled_down()
    for f in FIELDS:
        assert getattr(small, f) == getattr(jsmall, f), f
    assert cfg.num_layers == 81 and cfg.layer_kinds.count("attn") == 13
    assert cfg.head_dim == 112 and cfg.layer_kinds[5] == "attn"
    assert (small.d_model, small.head_dim, small.ssm_state, small.ssm_head_dim,
            small.num_layers) == (56, 28, 16, 16, 14)
    assert ssm._dims(small) == (112, 7, 16, 16) == jssm._dims(jsmall)


def test_published_sites_are_grouped():
    """The Q / K site at head_dim 112 is the grouped I_7 (x) H_16 and the
    down projection 7 groups of 2048: each a K1 launch on the card, neither
    a K2 (powers of 2 only)."""
    from repro_torch.core.api import RotationSpec, plan_for

    cfg = get_config("zamba2-7b")
    qk = RotationSpec.for_config(cfg.head_dim, QuantConfig(
        mode="fp8_e4m3", rotate="hadamard", kv_quant=True)).plan(torch.bfloat16, "cpu")
    assert qk.grouped and (qk.n // qk.p, qk.p) == (7, 16) and qk.epilogue is not None
    plan = plan_for(cfg.d_ff, device_type="cpu")
    assert plan.grouped and (plan.n // plan.p, plan.p) == (7, 2048)


# ---------------------------------------------------------------- mixer
def _mamba_params(seed=0):
    jcfg, tcfg = _configs()
    jp = _redraw({"mamba": jssm.init_mamba(jax.random.PRNGKey(seed), jcfg)},
                 np.random.default_rng(seed))["mamba"]
    return jcfg, tcfg, jp, {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("seq", [40, 256])
def test_causal_depthwise_is_bitwise(seq):
    """The prefill conv (the reference's Python sum of bf16 products) is
    bitwise the reference's, SiLU included."""
    _, _, jp, tp = _mamba_params()
    x = jnp.asarray(np.random.default_rng(seq).standard_normal((B, seq, 112))).astype(jnp.bfloat16)
    want = jax.jit(jssm._causal_depthwise, compiler_options=AS_WRITTEN)(x, jp["conv_x"])
    got = ssm._causal_depthwise(_t(x), tp["conv_x"])
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


def test_decode_conv_is_bitwise():
    """The decode conv over (state, new token): the reference's
    ``einsum("bwc,wc->bc")`` (f32 sums, one rounding), then SiLU."""
    _, _, jp, tp = _mamba_params()
    cx = jnp.asarray(np.random.default_rng(1).standard_normal((4, 4, 112))).astype(jnp.bfloat16)
    want = jax.jit(lambda c, w: jax.nn.silu(jnp.einsum("bwc,wc->bc", c, w)),
                   compiler_options=AS_WRITTEN)(cx, jp["conv_x"])
    np.testing.assert_array_equal(ssm._conv_step(_t(cx), tp["conv_x"]).float().numpy(),
                                  _f32(want))


def test_softplus_is_logaddexp():
    """``_softplus`` is ``jax.nn.softplus`` (``logaddexp(x, 0)``, no
    threshold) within 2 f32 ulps of its value where that is a normal
    number (read: 3 of 2004 values 1 to 2 ulps apart, torch's f32 ``exp`` /
    ``log1p`` against XLA's), also where torch's softplus switches to the
    identity (x > 20); where XLA flushes a subnormal result to 0, the port's
    is that subnormal."""
    x = np.concatenate([np.linspace(-30, 30, 2001), [-100.0, 100.0, 0.0]]).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x)))
    got = ssm._softplus(torch.from_numpy(x)).numpy()
    normal = np.abs(want) >= np.finfo(np.float32).tiny
    assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want)))[normal].all()
    assert (got[~normal] < np.finfo(np.float32).tiny).all() and (~normal).sum() == 1
    np.testing.assert_array_equal(got[x > 20], x[x > 20])


@pytest.mark.parametrize("seq", [40, 256])
def test_apply_mamba_matches_reference(seq):
    """The chunked SSD with its state: one chunk of 40 tokens and two of
    128 (the carry crosses a chunk boundary); the output within BF16_TOL,
    the f32 state within STATE_TOL, the conv states (the last 3 pre-conv
    inputs) bitwise."""
    jcfg, tcfg, jp, tp = _mamba_params(1)
    x = jnp.asarray(np.random.default_rng(seq + 1).standard_normal(
        (B, seq, tcfg.d_model))).astype(jnp.bfloat16)
    jy, jst = jax.jit(lambda p, a: jssm.apply_mamba(jcfg, p, a, return_state=True),
                      compiler_options=AS_WRITTEN)(jp, x)
    ty, tst = ssm.apply_mamba(tcfg, tp, _t(x), return_state=True)
    assert _gap(ty.float().numpy(), _f32(jy)) <= BF16_TOL
    assert _rel(tst.ssm.numpy(), np.asarray(jst.ssm)) <= STATE_TOL
    for got, want in zip(tst[1:], jst[1:]):
        assert got.shape == (B, 3, want.shape[-1])
        np.testing.assert_array_equal(got.float().numpy(), _f32(want))


def test_apply_mamba_rejects_a_ragged_long_sequence():
    """128 tokens or more must be a multiple of the chunk, as the
    reference rules (its ValueError and message)."""
    jcfg, tcfg, jp, tp = _mamba_params()
    x = np.zeros((1, 200, tcfg.d_model), np.float32)
    with pytest.raises(ValueError) as mine:
        ssm.apply_mamba(tcfg, tp, torch.from_numpy(x).to(torch.bfloat16))
    with pytest.raises(ValueError) as ref:
        jssm.apply_mamba(jcfg, jp, jnp.asarray(x).astype(jnp.bfloat16))
    assert str(mine.value) == str(ref.value)


def test_decode_mamba_matches_reference():
    """``decode_mamba`` from the reference's state after 256 tokens (two
    chunks): the output within BF16_TOL, the f32 state within STATE_TOL,
    the conv states bitwise (shifted by one token)."""
    jcfg, tcfg, jp, tp = _mamba_params(2)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((B, 256, tcfg.d_model))).astype(jnp.bfloat16)
    x1 = jnp.asarray(rng.standard_normal((B, 1, tcfg.d_model))).astype(jnp.bfloat16)
    _, st = jax.jit(lambda p, a: jssm.apply_mamba(jcfg, p, a, return_state=True),
                    compiler_options=AS_WRITTEN)(jp, x)
    jy, jst = jax.jit(lambda p, a, s: jssm.decode_mamba(jcfg, p, a, s),
                      compiler_options=AS_WRITTEN)(jp, x1, st)
    ty, tst = ssm.decode_mamba(tcfg, tp, _t(x1), ssm.MambaState(*map(_t, st)))
    assert _gap(ty.float().numpy(), _f32(jy)) <= BF16_TOL
    assert _rel(tst.ssm.numpy(), np.asarray(jst.ssm)) <= STATE_TOL
    for got, want in zip(tst[1:], jst[1:]):
        np.testing.assert_array_equal(got.float().numpy(), _f32(want))
    zero = ssm.init_mamba_state(tcfg, 3)
    jzero = jssm.init_mamba_state(jcfg, 3)
    assert [tuple(t.shape) for t in zero] == [tuple(t.shape) for t in jzero]


# ---------------------------------------------------------------- model
def _batch(cfg, seq, seed):
    tb = shapes.make_batch(cfg, shapes.ShapeSpec("serve", "prefill", seq, B), seed=seed)
    return jnp.asarray(tb["tokens"]), {"tokens": torch.from_numpy(tb["tokens"]).long()}


def _run(mode, rotate, seed, seq=S):
    """Prefill of ``seq`` tokens, then STEPS decode steps in each package,
    both fed the reference's greedy token: per step (largest gap / largest
    |logit|, relative RMS, tokens agree by the margin rule)."""
    jcfg, tcfg, jp, params = _model(mode, rotate)
    V = tcfg.vocab_size
    jt, tb = _batch(tcfg, seq, seed)
    jpre, jdec = _JITS[mode, rotate]
    jl, jc = jpre(jp, jt)
    jc = jpad_kv_caches(jcfg, jc, seq + STEPS)
    with torch.inference_mode():
        tl, tc = lm_prefill(tcfg, params, tb)
        tc = pad_kv_caches(tcfg, tc, seq + STEPS)
    steps = []
    for i in range(STEPS + 1):
        steps.append(_read(tl, jl, V))
        if i < STEPS:
            tok = jnp.argmax(jl[:, -1, :V], -1).astype(jnp.int32)[:, None]
            jl, jc = jdec(jp, jc, tok, jnp.asarray(seq + i, jnp.int32))
            with torch.inference_mode():
                tl, tc = lm_decode_step(tcfg, params, tc, torch.from_numpy(np.array(tok)).long(),
                                        torch.tensor(seq + i))
    return steps


@pytest.mark.parametrize("mode,rotate", [("fp8_e4m3", "hadamard"), ("int8", "none")])
def test_prefill_and_decode_match_reference(mode, rotate):
    """The scaled zamba2 with rotation on (fp8_e4m3 + Hadamard + fp8 KV,
    the card's deployment) and off (int8): prefill logits and 3 decode
    steps within the logit tolerances, tokens by the margin rule; CPU
    tensors launch no kernel."""
    before = (hadacore_cuda.launches, fused_dequant_cuda.launches)
    for i, (gap, rel, same) in enumerate(_run(mode, rotate, 0)):
        assert gap <= LOGIT_TOL and rel <= REL_TOL and same, (mode, rotate, i, gap, rel, same)
    assert (hadacore_cuda.launches, fused_dequant_cuda.launches) == before


def test_state_handoff_matches_prefill_in_both_packages():
    """Prefill of 64 tokens then one decode step of token 65, against a
    prefill of all 65, in each package: the two routes agree within the
    logit tolerances in the reference and in the port, and the port's
    decode step is the reference's. The mamba states come back updated in
    place; the attention layers' K / V caches grow by the decoded row."""
    jcfg, tcfg, jp, params = _model("fp8_e4m3", "hadamard")
    V = tcfg.vocab_size
    jt, tb = _batch(tcfg, S + 1, 6)
    pre, dec = _JITS["fp8_e4m3", "hadamard"]
    jl_all, _ = pre(jp, jt)
    _, jc = pre(jp, jt[:, :S])
    jl_dec, _ = dec(jp, jpad_kv_caches(jcfg, jc, S + 1), jt[:, S:], jnp.asarray(S, jnp.int32))
    with torch.inference_mode():
        tl_all, _ = lm_prefill(tcfg, params, tb)
        _, tc = lm_prefill(tcfg, params, {"tokens": tb["tokens"][:, :S]})
        tc = pad_kv_caches(tcfg, tc, S + 1)
        state, before = tc[0]["ssm"], tc[0]["ssm"].clone()
        tl_dec, tc2 = lm_decode_step(tcfg, params, tc, tb["tokens"][:, S:], torch.tensor(S))
    assert tc2[0]["ssm"] is state and not torch.equal(state, before)
    assert set(tc2[0]) == {"ssm", "conv_x", "conv_bc"} and set(tc2[5]) == {"k", "v"}
    assert tc2[5]["k"].shape[1] == S + 1 and tc2[5]["k"][:, S].float().abs().sum() > 0
    as_j = lambda t: jnp.asarray(t.float().numpy())                  # noqa: E731
    as_t = lambda a: torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))  # noqa: E731
    for got, want in ((as_t(jl_dec), jl_all), (tl_dec, as_j(tl_all)), (tl_dec, jl_dec),
                      (tl_all, jl_all)):
        gap, rel, same = _read(got, want, V)
        assert gap <= LOGIT_TOL and rel <= REL_TOL and same, (gap, rel, same)


def test_lm_loss_matches_reference():
    """``lm_loss`` (forward) on ``make_batch``'s batch agrees with the
    reference's within 2e-3 relative, rotation on."""
    jcfg, tcfg, jp, params = _model("fp8_e4m3", "hadamard")
    shape = jshapes.ShapeSpec("t", "train", S, B)
    jb = jshapes.make_batch(jcfg, shape, seed=4)
    tb = {k: torch.from_numpy(v) for k, v in shapes.make_batch(tcfg, shape, seed=4).items()}
    tb["tokens"] = tb["tokens"].long()
    want = float(jax.jit(lambda p, b: jlm.lm_loss(jcfg, p, b)[0],
                         compiler_options=AS_WRITTEN)(jp, jb))
    with torch.inference_mode():
        got = float(lm.lm_loss(tcfg, params, tb)[0])
    assert abs(got - want) <= 2e-3 * abs(want), (got, want)


# ------------------------------------------------------ bridge, counts
def test_bridge_both_ways():
    """The scaled zamba2's two layer groups (2 x (5 mamba + 1 attn), then 2
    mamba) unstack into 14 layers in the reference's order and stack back
    bit for bit, per leaf -- the bf16 conv weights, the f32 ``A_log``,
    ``D``, ``dt_bias`` -- and the port's own init has the reference's tree,
    scaled and, on the meta device, at the published 81 layers."""
    jcfg, tcfg = _configs(weight_quant="none")
    ref = _np_tree(jinit_lm(jax.random.PRNGKey(3), jcfg))
    params = params_from_reference(ref, device="cpu")
    kinds = tuple("mamba" if "mamba" in p else "attn" for p in params["layers"])
    assert kinds == tcfg.layer_kinds and len(kinds) == 14
    np.testing.assert_array_equal(params["layers"][7]["mamba"]["conv_x"].view(torch.int16).numpy(),
                                  ref["groups"][0]["p1"]["mamba"]["conv_x"][1].view(np.int16))
    assert params["layers"][12]["mamba"]["A_log"].dtype == torch.float32
    back = to_reference(params, tcfg)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]).view(np.uint8),
                                      np.asarray(leaf).view(np.uint8))
    for cfg, jc in ((tcfg, jcfg), (get_config("zamba2-7b"), jget_config("zamba2_7b"))):
        want = jax.eval_shape(lambda k: jinit_lm(k, jc), jax.random.PRNGKey(0))
        mine = to_reference(init_lm(cfg, seed=0, device="meta"), cfg, meta=True)
        assert {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for p, v in jax.tree_util.tree_leaves_with_path(mine)} == {
            p: (tuple(v.shape), v.dtype.name)
            for p, v in jax.tree_util.tree_leaves_with_path(want)}, cfg.name


def test_count_params_and_model_flops_match_reference():
    for cfg, ref in ((get_config("zamba2-7b"), jget_config("zamba2_7b")),
                     (get_config("zamba2-7b").scaled_down(),
                      jget_config("zamba2_7b").scaled_down())):
        assert flops.count_params(cfg) == jflops.count_params(ref)
        for name, shape in shapes.SHAPES.items():
            assert flops.model_flops(cfg, shape) == jflops.model_flops(
                ref, jshapes.SHAPES[name]), name


def test_transform_harness_times_the_recurrent_path_shapes():
    """``bench/hadamard.py`` times K1 at the recurrent families' path
    shapes: the 7 x 2048 down projection of rwkv6-7b and zamba2-7b and
    zamba2-7b's Q / K sites (n = 16, 32 heads x 7 groups a token), at a
    decode step of 4 and a 4 x 512-token prefill."""
    from repro_torch.bench import hadamard as bench

    path = {(c.kernel, c.site, c.rows, c.n) for c in bench.CASES if c.group == "path"}
    tok = bench.SLOTS * bench.RECURRENT_PROMPT
    assert {("K1", "rwkv6 / zamba2 decode down-proj", 28, 2048),
            ("K1", "rwkv6 / zamba2 prefill down-proj", 7 * tok, 2048),
            ("K1", "zamba2-7b decode Q / K", 896, 16),
            ("K1", "zamba2-7b prefill Q / K", 458752, 16)} <= path
    assert tok * 32 * 7 == 458752


# ------------------------------------------------- sites, launcher, engine
def test_each_attention_layer_reaches_three_grouped_rotations(monkeypatch):
    """Per pass, prefill and decode, each attention layer reaches the
    standalone transform three times -- Q, K (the grouped I_7 (x) H_4 here,
    I_7 (x) H_16 at the published width) and the down projection: grouped
    K1 on the card, 39 per pass at full depth -- and no other kernel
    entry; the mamba layers none; no weight is quantized while serving."""
    _, tcfg, _, params = _model("fp8_e4m3", "hadamard")
    calls = {n: 0 for n in ("transform", "fused_dequant", "fused", "quant_dot",
                            "quant_dot_experts")}
    for name in calls:
        real = getattr(registry.CudaBackend, name)

        def spy(self, *a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(registry.CudaBackend, name, spy)
    before = wquant.QUANTIZE_WEIGHT_CALLS
    _, tb = _batch(tcfg, S, 2)
    want = {"transform": 3 * tcfg.layer_kinds.count("attn"), "fused_dequant": 0, "fused": 0,
            "quant_dot": 0, "quant_dot_experts": 0}
    with torch.inference_mode():
        logits, c = lm_prefill(tcfg, params, tb)
        assert calls == want
        c = pad_kv_caches(tcfg, c, S + 1)
        for k in calls:
            calls[k] = 0
        lm_decode_step(tcfg, params, c, logits[:, -1, :tcfg.vocab_size].argmax(-1)[:, None],
                       torch.tensor(S))
    assert calls == want and want["transform"] == 6
    assert wquant.QUANTIZE_WEIGHT_CALLS == before


def test_serve_launcher_runs_on_cpu(capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --device cpu --arch zamba2-7b``
    at ``--scale 0.005`` (fp8_e4m3 + Hadamard + fp8 KV; 32 prompt tokens, one
    SSD chunk): the tokens and every step's logits against the reference's
    driven the same way, under the margin rule; a 200-token prompt is
    refused by the chunk rule."""
    argv = ["--device", "cpu", "--arch", "zamba2-7b", "--scale", "0.005", "--batch", "2",
            "--prompt-len", "32", "--gen", "4", "--quant", "fp8_e4m3", "--rotate",
            "hadamard", "--seed", "3"]
    out, steps = launcher_against_reference("zamba2-7b", "zamba2_7b", argv, 32, 2, 4,
                                            monkeypatch)
    cfg, toks = out["cfg"], out["tokens"]
    assert cfg.layer_kinds == ("mamba",) * 5 + ("attn", "mamba") and toks.shape == (2, 4)
    assert out["decode_steps"] == 2 and out["tokens_per_s"] > 0
    assert "zamba2-7b" in capsys.readouterr().out
    for i, (gap, rel, same) in enumerate(steps):
        assert gap <= LOGIT_TOL and rel <= REL_TOL and same, (i, gap, rel, same)
    with pytest.raises(ValueError, match="not divisible by chunk 128"):
        from repro_torch.launch import serve

        serve.main([("200" if a == "32" else a) for a in argv])


def test_engine_rejects_the_hybrid():
    """The serving engine refuses zamba2 (its mamba layers' scan state)
    with the reference's message."""
    from repro.serving.engine import _validate_config as jvalidate
    from repro_torch.serving.engine import _validate_config

    jcfg, tcfg = _configs()
    with pytest.raises(ValueError) as mine:
        _validate_config(tcfg)
    with pytest.raises(ValueError) as ref:
        jvalidate(jcfg)
    assert str(mine.value) == str(ref.value) and "kinds=['attn', 'mamba']" in str(mine.value)


if __name__ == "__main__":
    # The readings behind the model tolerances:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_zamba2.py
    for mode, rotate in (("fp8_e4m3", "hadamard"), ("int8", "none")):
        for seed in range(6):
            st = _run(mode, rotate, seed)
            print(f"zamba2 {mode} {rotate} seed {seed}: largest gap "
                  f"{max(s[0] for s in st):.4f} of max |logit|, relative RMS "
                  f"{max(s[1] for s in st):.4f}, tokens agree (margin rule) "
                  f"{all(s[2] for s in st)}")
