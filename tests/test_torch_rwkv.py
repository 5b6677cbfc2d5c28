"""PyTorch port, rwkv6-7b: the RWKV6 time mix (both of the reference's
forms) and channel mix, the 'rwkv' layer kind with its recurrent state in
place of a KV cache, ``launch/flops.py`` and ``launch/shapes.py``, the
bridge, the one-shot launcher and the engine's refusal, against the
reference on the CPU: the model scaled down by the reference's own
``scaled_down`` (d_model 64, 4 heads of 16, d_ff 96 = 3 x 32 grouped, 2
layers), the reference's parameters carried across by ``repro_torch.bridge``
(``init_lm`` and ``quantize_lm_weights``; the constant f32 leaves -- the
mixing weights, the decay base, the GroupNorm affine -- redrawn from a
numpy seed on both sides, so that a misplaced add cannot hide), the
reference jitted as written (``xla_allow_excess_precision`` off, backend
``pallas`` in interpret mode).

Tolerances (readings: ``python tests/test_torch_rwkv.py``):

* ``_tmix_scan`` and ``_tmix_chunked`` on the same f32 inputs: relative
  RMS within ``FORM_TOL`` of the reference's. The scan reads <= 8.6e-8
  (its sums run in another order). The chunked form reads 1.2e-6 to 2.1e-5:
  its log-space cumulative decays grow to |L| ~ 10^3 over a chunk of small
  decays, XLA's cumsum (a reduce-window, rewritten as a tree) adds them in
  another order than torch's running sum, and the pairwise differences
  and their exps carry that |L| x 2^-24 error.
* The time mix, channel mix and their decode steps from the same bf16
  inputs: within ``BF16_TOL`` of the largest |output| (single bf16 flips
  where a matmul sums in another order; the decay ``exp(-exp(.))`` is
  within a few f32 ulps), the f32 state within ``STATE_TOL`` relative RMS.
* The models: logits at every step (prefill, then ``STEPS`` decode steps,
  both packages fed the reference's greedy token) within ``LOGIT_TOL`` of
  the largest |logit| and ``REL_TOL`` relative RMS, tokens by the margin
  rule (the port's greedy token equals the reference's wherever the
  reference's top-1/top-2 margin exceeds twice the step's largest logit
  gap), as ``tests/test_torch_families.py`` holds its families.
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
from repro.launch.train import scaled_config as jscaled_config
from repro.models import init_lm as jinit_lm
from repro.models import lm as jlm
from repro.models import rwkv as jrwkv
from repro.models.lm import pad_kv_caches as jpad_kv_caches

from repro_torch.bridge import params_from_reference, to_reference, to_torch
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import wquant
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import registry
from repro_torch.kernels.hadacore import hadacore_cuda
from repro_torch.launch import flops, serve, shapes
from repro_torch.models import lm, rwkv
from repro_torch.models.lm import init_lm, lm_decode_step, lm_prefill, pad_kv_caches

B, S, STEPS = 2, 64, 3
FORM_TOL = {"scan": 1e-6, "chunked": 5e-5}
BF16_TOL, STATE_TOL = 0.02, 2e-4
LOGIT_TOL, REL_TOL = 0.05, 0.04
AS_WRITTEN = {"xla_allow_excess_precision": False}
FIELDS = ("name", "family", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
          "groups", "head_dim", "rwkv_head_dim", "rwkv_impl", "rwkv_chunk",
          "sub_quadratic", "vocab_pad_multiple", "tie_embeddings", "norm", "dtype")
# the constant f32 leaves of the reference's init, redrawn (mean, spread)
REDRAW = {"mu_base": (0.5, 0.2), "mu": (0.5, 0.2), "w0": (-2.0, 0.5),
          "ln_scale": (1.0, 0.2), "ln_bias": (0.0, 0.2), "mu_r": (0.5, 0.2),
          "mu_k": (0.5, 0.2)}


def _np_tree(t):
    if isinstance(t, JQTensor):
        return {"q": np.asarray(t.q), "scale": np.asarray(t.scale), "mode": t.mode}
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


def _redraw(tree, rng):
    """The reference tree with its REDRAW leaves drawn from ``rng``."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(REDRAW[k][0] + REDRAW[k][1] * rng.standard_normal(v.shape),
                                jnp.float32) if k in REDRAW else _redraw(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_redraw(v, rng) for v in tree]
    return tree


def _configs(mode="int8", rotate="hadamard", weight_quant="int8"):
    jq = JQuantConfig(mode=mode, rotate=rotate, backend="pallas")
    tq = QuantConfig(mode=mode, rotate=rotate, backend="cuda")
    jcfg = jget_config("rwkv6_7b").scaled_down().with_quant(jq)
    tcfg = get_config("rwkv6-7b").scaled_down().with_quant(tq)
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
    """rwkv6-7b carries the reference's config field for field, and
    ``scaled_down`` keeps what the reference's keeps (heads of 16, d_ff 96 =
    3 x 32, 2 layers); ``ARCH_IDS`` holds all 11 of the reference's
    architectures."""
    from repro.configs import ARCH_IDS as JARCH_IDS

    cfg, ref = get_config("rwkv6-7b"), jget_config("rwkv6_7b")
    assert get_config("rwkv6_7b") is cfg and sorted(ARCH_IDS) == sorted(JARCH_IDS)
    assert len(ARCH_IDS) == 11
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(ref, f), f
    small, jsmall = cfg.scaled_down(), ref.scaled_down()
    for f in FIELDS:
        assert getattr(small, f) == getattr(jsmall, f), f
    assert (small.d_model, small.rwkv_head_dim, small.d_ff, small.num_layers) == (64, 16, 96, 2)
    assert cfg.layer_kinds == ("rwkv",) * 32 and cfg.sub_quadratic


def test_published_down_projection_is_7_groups_of_2048():
    from repro_torch.core.api import plan_for

    plan = plan_for(get_config("rwkv6-7b").d_ff, device_type="cpu")
    assert plan.grouped and (plan.n // plan.p, plan.p) == (7, 2048)


def test_long_500k_eligibility_and_shapes():
    """Both recurrent models are eligible for long_500k, as in the
    reference; every shape rule agrees with the reference's."""
    for arch in ("rwkv6_7b", "zamba2_7b"):
        cfg, ref = get_config(arch), jget_config(arch)
        for name, shape in shapes.SHAPES.items():
            assert shapes.shape_applicable(cfg, shape) == jshapes.shape_applicable(
                ref, jshapes.SHAPES[name]), (arch, name)
        assert shapes.shape_applicable(cfg, shapes.SHAPES["long_500k"]) is None
    assert shapes.shape_applicable(get_config("llama3-8b"), shapes.SHAPES["long_500k"])


# ------------------------------------------------------------- time mix
def _tmix_params(seed=0):
    jcfg, tcfg = _configs()
    jp = _redraw(jrwkv.init_rwkv_tmix(jax.random.PRNGKey(seed), jcfg),
                 np.random.default_rng(seed))
    return jcfg, tcfg, jp, {k: _t(v) for k, v in jp.items()}


def _recurrence_inputs(seed, S_, H, K, spread, subnormal):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S_, H, K)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S_, H, K)) * spread)).astype(np.float32)
    if subnormal:
        w[:, ::5] = 1e-45     # flushed to zero by XLA's CPU code: the 1e-30 clamp
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("spread,subnormal", [(0.5, False), (2.0, True)])
@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_recurrence_forms_match_reference(form, spread, subnormal):
    """``_tmix_scan`` and ``_tmix_chunked`` (chunk 32, 3 chunks) on the same
    f32 inputs, with decays exp(-exp(N(0, spread^2))), every fifth token's
    below the f32 subnormal range in the second case: output and last
    state within FORM_TOL relative RMS of the reference's, finite."""
    H, K, S_ = 2, 16, 96
    ins = _recurrence_inputs(7, S_, H, K, spread, subnormal)
    jf = jrwkv._tmix_scan if form == "scan" else jrwkv._tmix_chunked
    tf = rwkv._tmix_scan if form == "scan" else rwkv._tmix_chunked
    want = jax.jit(lambda *a: jf(B, S_, H, K, *a), compiler_options=AS_WRITTEN)(
        *map(jnp.asarray, ins))
    got = tf(B, S_, H, K, *map(torch.from_numpy, ins))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g.numpy(), np.asarray(w)) <= FORM_TOL[form], form


@pytest.mark.parametrize("seq,form", [(S, "chunked"), (40, "scan")])
def test_time_mix_matches_reference_and_takes_its_form(seq, form, monkeypatch):
    """``apply_rwkv_tmix`` with its state, at a length that is a multiple of
    the chunk (the chunked form) and one that is not (the scan): the output
    within BF16_TOL of the reference's, the f32 state within STATE_TOL, the
    last input bitwise; the port runs the form the reference's rule
    picks."""
    jcfg, tcfg, jp, tp = _tmix_params(1)
    x = np.random.default_rng(seq).standard_normal((B, seq, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jy, (jS, jxp) = jax.jit(lambda p, a: jrwkv.apply_rwkv_tmix(jcfg, p, a, return_state=True),
                            compiler_options=AS_WRITTEN)(jp, jx)
    ran = []
    for name in ("_tmix_scan", "_tmix_chunked"):
        real = getattr(rwkv, name)
        monkeypatch.setattr(rwkv, name, lambda *a, _r=real, _n=name, **k: (
            ran.append(_n), _r(*a, **k))[1])
    ty, (tS, txp) = rwkv.apply_rwkv_tmix(tcfg, tp, _t(jx), return_state=True)
    assert ran == [f"_tmix_{form}"]
    assert _gap(ty.float().numpy(), _f32(jy)) <= BF16_TOL
    assert _rel(tS.numpy(), np.asarray(jS)) <= STATE_TOL
    np.testing.assert_array_equal(txp.float().numpy(), _f32(jxp))


def test_time_mix_stages_match_reference():
    """The token-shift interpolation and the projections bitwise but for
    single bf16 flips; the f32 decay within a few f32 ulps."""
    jcfg, tcfg, jp, tp = _tmix_params(2)
    x = np.random.default_rng(3).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jxp = jnp.pad(jx, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    want = jax.jit(lambda p, a, b: jrwkv._tmix_inputs(jcfg, p, a, b),
                   compiler_options=AS_WRITTEN)(jp, jx, jxp)
    got = rwkv._tmix_inputs(tcfg, tp, _t(jx), rwkv._shift(_t(jx)))
    np.testing.assert_array_equal(rwkv._shift(_t(jx)).float().numpy(), _f32(jxp))
    for name, g, w in zip("rkvgw", got, want):
        g, w = g.float().numpy(), _f32(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g != w).mean() <= 0.01 if name != "w" else _gap(g, w) <= 1e-5, name


def test_time_mix_decode_matches_reference():
    """``decode_rwkv_tmix`` from the reference's state after 64 tokens: the
    output within BF16_TOL, the new state within STATE_TOL."""
    jcfg, tcfg, jp, tp = _tmix_params(3)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((B, S, tcfg.d_model))).astype(jnp.bfloat16)
    x1 = jnp.asarray(rng.standard_normal((B, 1, tcfg.d_model))).astype(jnp.bfloat16)
    _, st = jax.jit(lambda p, a: jrwkv.apply_rwkv_tmix(jcfg, p, a, return_state=True),
                    compiler_options=AS_WRITTEN)(jp, x)
    jy, (jS, _) = jax.jit(lambda p, a, s: jrwkv.decode_rwkv_tmix(jcfg, p, a, s),
                          compiler_options=AS_WRITTEN)(jp, x1, st)
    ty, (tS, txp) = rwkv.decode_rwkv_tmix(tcfg, tp, _t(x1), (_t(st[0]), _t(st[1])))
    assert _gap(ty.float().numpy(), _f32(jy)) <= BF16_TOL
    assert _rel(tS.numpy(), np.asarray(jS)) <= STATE_TOL
    np.testing.assert_array_equal(txp.float().numpy(), _f32(x1[:, -1]))


# ---------------------------------------------------------- channel mix
@pytest.mark.parametrize("mode,rotate", [("int8", "hadamard"), ("int8", "none")])
def test_channel_mix_matches_reference(mode, rotate):
    """``apply_rwkv_cmix`` (the down projection through its QuantDotSpec
    site: grouped 3 x 32 rotation, the per-row quantize and contraction)
    and ``decode_rwkv_cmix`` with the reference's parameters: within
    BF16_TOL, the last input bitwise; on CPU tensors no kernel launches."""
    jcfg, tcfg, jp, tp = _model(mode, rotate)
    jc = jp["groups"][0]["p0"]["cmix"]
    jc = jax.tree_util.tree_map(lambda a: a[0], jc)
    tc = tp["layers"][0]["cmix"]
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((B, S, tcfg.d_model))).astype(jnp.bfloat16)
    xp = jnp.asarray(rng.standard_normal((B, tcfg.d_model))).astype(jnp.bfloat16)
    before = hadacore_cuda.launches
    deq = lm._dequant_layer(tcfg, {"cmix": tc}, torch.bfloat16)["cmix"]
    jdeq = jlm._dequant_layer(jcfg, {"cmix": jc}, {"cmix": jrwkv.rwkv_cmix_specs(jcfg)},
                              jnp.bfloat16)["cmix"]
    jy, jxc = jax.jit(lambda p, a: jrwkv.apply_rwkv_cmix(jcfg, p, a, return_state=True),
                      compiler_options=AS_WRITTEN)(jdeq, x)
    ty, txc = rwkv.apply_rwkv_cmix(tcfg, deq, _t(x), return_state=True)
    assert _gap(ty.float().numpy(), _f32(jy)) <= BF16_TOL
    np.testing.assert_array_equal(txc.float().numpy(), _f32(jxc))
    jy1, _ = jax.jit(lambda p, a, b: jrwkv.decode_rwkv_cmix(jcfg, p, a, b),
                     compiler_options=AS_WRITTEN)(jdeq, x[:, :1], xp)
    ty1, _ = rwkv.decode_rwkv_cmix(tcfg, deq, _t(x[:, :1]), _t(xp))
    assert _gap(ty1.float().numpy(), _f32(jy1)) <= BF16_TOL
    assert hadacore_cuda.launches == before


# ---------------------------------------------------------------- model
def _batch(cfg, seq, seed):
    tb = shapes.make_batch(cfg, shapes.ShapeSpec("serve", "prefill", seq, B), seed=seed)
    return jnp.asarray(tb["tokens"]), {"tokens": torch.from_numpy(tb["tokens"]).long()}


def _read(tl, jl, V):
    g, w = tl[:, -1, :V].float().numpy(), np.asarray(jl[:, -1, :V], np.float32)
    assert np.isfinite(g).all()
    gap = np.abs(g - w).max()
    top = np.sort(w, -1)
    sure = top[:, -1] - top[:, -2] > 2 * gap
    return (gap / np.abs(w).max(), _rel(g, w),
            bool(((g.argmax(-1) == w.argmax(-1)) | ~sure).all()))


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


@pytest.mark.parametrize("mode,rotate", [("int8", "hadamard"), ("int8", "none")])
def test_prefill_and_decode_match_reference(mode, rotate):
    """The scaled rwkv6 with rotation on (int8 W8A8 + Hadamard, the card's
    deployment) and off: prefill logits (the chunked form) and 3 decode
    steps within the logit tolerances, tokens by the margin rule; CPU
    tensors launch no kernel."""
    before = hadacore_cuda.launches
    for i, (gap, rel, same) in enumerate(_run(mode, rotate, 0)):
        assert gap <= LOGIT_TOL and rel <= REL_TOL and same, (mode, rotate, i, gap, rel, same)
    assert hadacore_cuda.launches == before


def test_state_handoff_matches_prefill_in_both_packages():
    """Prefill of 64 tokens (chunked) then one decode step of token 65,
    against a prefill of all 65 (the scan form), in each package: the two
    routes agree within the logit tolerances in the reference and in the
    port, and the port's decode step is the reference's. The state caches
    come back updated in place."""
    jcfg, tcfg, jp, params = _model("int8", "hadamard")
    V = tcfg.vocab_size
    jt, tb = _batch(tcfg, S + 1, 6)
    pre, dec = _JITS["int8", "hadamard"]
    jl_all, _ = pre(jp, jt)
    _, jc = pre(jp, jt[:, :S])
    jl_dec, _ = dec(jp, jc, jt[:, S:], jnp.asarray(S, jnp.int32))
    with torch.inference_mode():
        tl_all, _ = lm_prefill(tcfg, params, tb)
        _, tc = lm_prefill(tcfg, params, {"tokens": tb["tokens"][:, :S]})
        state = tc[0]["S"]
        before = state.clone()
        tl_dec, tc2 = lm_decode_step(tcfg, params, tc, tb["tokens"][:, S:], torch.tensor(S))
    assert tc2[0]["S"] is state and not torch.equal(state, before)
    assert set(tc2[0]) == {"S", "xp_t", "xp_c"}
    for got, want in ((jl_dec, jl_all), (tl_dec, tl_all), (tl_dec, jl_dec), (tl_all, jl_all)):
        got = torch.from_numpy(np.array(jnp.asarray(got).astype(jnp.float32))) \
            if not isinstance(got, torch.Tensor) else got
        gap, rel, same = _read(got, want if not isinstance(want, torch.Tensor)
                               else jnp.asarray(want.float().numpy()), V)
        assert gap <= LOGIT_TOL and rel <= REL_TOL and same, (gap, rel, same)


def test_lm_loss_matches_reference():
    """``lm_loss`` (forward) on ``make_batch``'s batch agrees with the
    reference's within 2e-3 relative, rotation on."""
    jcfg, tcfg, jp, params = _model("int8", "hadamard")
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
    """The scaled rwkv6's reference parameters (the 3-D ``mix_w2``, the f32
    ``u`` and mixing weights) cross into the port's per-layer list and back
    bit for bit, per leaf; the port's own init has the reference's tree, on
    the CPU and on the meta device."""
    jcfg, tcfg = _configs(weight_quant="none")
    ref = _np_tree(jinit_lm(jax.random.PRNGKey(3), jcfg))
    params = params_from_reference(ref, device="cpu")
    assert len(params["layers"]) == 2 and params["layers"][0]["tmix"]["mix_w2"].ndim == 3
    assert params["layers"][1]["tmix"]["u"].dtype == torch.float32
    back = to_reference(params, tcfg)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]).view(np.uint8),
                                      np.asarray(leaf).view(np.uint8))
    want = {p: (tuple(v.shape), v.dtype.name) for p, v in flat_ref}
    for device in ("cpu", "meta"):
        mine = to_reference(init_lm(tcfg, seed=0, device=device), tcfg, meta=True)
        assert {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for p, v in jax.tree_util.tree_leaves_with_path(mine)} == want, device


def test_quantized_leaves_match_reference_at_this_scale():
    """At the scaled-down size the port's per-layer size floor and the
    reference's per-stack floor quantize the same leaves (full-width
    splits: ``core/wquant.py``), and the consumer ``wv`` takes the serving
    mode."""
    jcfg, tcfg, jp, params = _model("int8", "hadamard")
    jq = {tuple(str(getattr(k, "key", k)) for k in p)[3:]
          for p, v in jax.tree_util.tree_flatten_with_path(
              jp, is_leaf=lambda x: isinstance(x, JQTensor))[0] if isinstance(v, JQTensor)
          and "groups" in str(p[0])}
    tq = {keys[1:] for keys, v in _walk(params["layers"][0]) if wquant.is_qleaf(v)}
    assert jq == tq and ("cmix", "wv") in tq and ("tmix", "u") not in tq


def _walk(tree, keys=("layer",)):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, keys + (k,))
        else:
            yield keys + (k,), v


def test_count_params_and_model_flops_match_reference():
    for cfg, ref in ((get_config("rwkv6-7b"), jget_config("rwkv6_7b")),
                     (get_config("rwkv6-7b").scaled_down(), jget_config("rwkv6_7b").scaled_down())):
        assert flops.count_params(cfg) == jflops.count_params(ref)
        for name, shape in shapes.SHAPES.items():
            assert flops.model_flops(cfg, shape) == jflops.model_flops(
                ref, jshapes.SHAPES[name]), name


# ------------------------------------------------- sites, launcher, engine
def test_each_layer_reaches_one_grouped_rotation(monkeypatch):
    """Per pass, prefill and decode, each layer's channel-mix down
    projection reaches the standalone transform once (grouped K1 on the
    card: 32 per pass at full depth) and no other kernel entry; no weight
    is quantized while serving."""
    _, tcfg, _, params = _model("int8", "hadamard")
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
    want = {"transform": tcfg.num_layers, "fused_dequant": 0, "fused": 0, "quant_dot": 0,
            "quant_dot_experts": 0}
    with torch.inference_mode():
        logits, c = lm_prefill(tcfg, params, tb)
        assert calls == want
        for k in calls:
            calls[k] = 0
        lm_decode_step(tcfg, params, c, logits[:, -1, :tcfg.vocab_size].argmax(-1)[:, None],
                       torch.tensor(S))
    assert calls == want
    assert wquant.QUANTIZE_WEIGHT_CALLS == before


def launcher_against_reference(arch, jarch, argv, prompt, batch, gen, monkeypatch):
    """``serve.main(argv)`` on the CPU with the reference's parameters for
    the launcher's config (drawn from the seed, quantized at load, carried
    across) in place of its own draw; the reference's un-meshed jitted
    ``lm_prefill`` / ``pad_kv_caches`` / ``lm_decode_step`` driven the same
    way (caches padded to prompt + gen, decode from ``start``) and fed the
    launcher's tokens. Returns (the launcher's output, per step (gap, rel,
    tokens agree by the margin rule))."""
    out_cfg = {}

    def init(cfg, *, seed, device):
        jcfg = dataclasses.replace(
            jscaled_config(jget_config(jarch), 0.005).with_quant(JQuantConfig(
                mode=cfg.quant.mode, rotate=cfg.quant.rotate, backend="pallas",
                kv_quant=cfg.quant.kv_quant)), weight_quant=cfg.weight_quant)
        jp = jax.jit(lambda k: jquantize_lm_weights(jinit_lm(k, jcfg), jcfg))(
            jax.random.PRNGKey(seed))
        out_cfg.update(jcfg=jcfg, jp=jp)
        return params_from_reference(_np_tree(jp), device=device)

    logits = []
    real_prefill, real_decode = serve.lm_prefill, serve.lm_decode_step

    def prefill(*a, **k):
        out = real_prefill(*a, **k)
        logits.append(out[0].float().clone())
        return out

    def decode(*a, **k):
        out = real_decode(*a, **k)
        logits.append(out[0].float().clone())
        return out

    monkeypatch.setattr(serve, "init_lm", init)
    monkeypatch.setattr(serve, "lm_prefill", prefill)
    monkeypatch.setattr(serve, "lm_decode_step", decode)
    out = serve.main(argv)
    cfg, toks = out["cfg"], out["tokens"]
    jcfg, jp = out_cfg["jcfg"], out_cfg["jp"]
    assert jcfg.d_model == cfg.d_model and jcfg.groups == cfg.groups
    jb = jshapes.make_batch(jcfg, jshapes.ShapeSpec("serve", "prefill", prompt, batch),
                            seed=int(argv[argv.index("--seed") + 1]))
    jb.pop("labels")
    jl, jc = jax.jit(lambda p, b: jlm.lm_prefill(jcfg, p, b), compiler_options=AS_WRITTEN)(jp, jb)
    jc = jpad_kv_caches(jcfg, jc, prompt + gen)
    jdec = jax.jit(lambda p, c, t, pos: jlm.lm_decode_step(jcfg, p, c, t, pos),
                   compiler_options=AS_WRITTEN)
    start = prompt + (cfg.vlm_patches if cfg.family == "vlm" else 0)
    steps = [_read(logits[0], jl, cfg.vocab_size)]
    for i in range(gen - 1):
        jl, jc = jdec(jp, jc, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                      jnp.asarray(start + i, jnp.int32))
        steps.append(_read(logits[i + 1], jl, cfg.vocab_size))
    return out, steps


def test_serve_launcher_runs_on_cpu(capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --device cpu --arch rwkv6-7b``
    at ``--scale 0.005`` (int8 W8A8 + Hadamard, 40 prompt tokens: the scan
    form): the tokens and every step's logits against the reference's
    driven the same way, under the margin rule."""
    argv = ["--device", "cpu", "--arch", "rwkv6-7b", "--scale", "0.005", "--batch", "2",
            "--prompt-len", "40", "--gen", "4", "--quant", "int8", "--rotate", "hadamard",
            "--seed", "3"]
    out, steps = launcher_against_reference("rwkv6-7b", "rwkv6_7b", argv, 40, 2, 4,
                                            monkeypatch)
    cfg, toks = out["cfg"], out["tokens"]
    assert cfg.layer_kinds == ("rwkv",) * 2 and toks.shape == (2, 4)
    assert out["decode_steps"] == 2 and out["tokens_per_s"] > 0
    assert "rwkv6-7b" in capsys.readouterr().out
    for i, (gap, rel, same) in enumerate(steps):
        assert gap <= LOGIT_TOL and rel <= REL_TOL and same, (i, gap, rel, same)


def test_engine_rejects_the_recurrent_kinds():
    """The serving engine refuses rwkv6 (a scan state would fold a padded
    prefill into it) with the reference's message."""
    from repro.serving.engine import _validate_config as jvalidate
    from repro_torch.serving.engine import _validate_config

    jcfg, tcfg = _configs()
    with pytest.raises(ValueError) as mine:
        _validate_config(tcfg)
    with pytest.raises(ValueError) as ref:
        jvalidate(jcfg)
    assert str(mine.value) == str(ref.value) and "kinds=['rwkv']" in str(mine.value)


if __name__ == "__main__":
    # The readings behind the model tolerances:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_rwkv.py
    for mode, rotate in (("int8", "hadamard"), ("int8", "none")):
        for seed in range(6):
            st = _run(mode, rotate, seed)
            print(f"rwkv6 {mode} {rotate} seed {seed}: largest gap {max(s[0] for s in st):.4f} "
                  f"of max |logit|, relative RMS {max(s[1] for s in st):.4f}, tokens agree "
                  f"(margin rule) {all(s[2] for s in st)}")
