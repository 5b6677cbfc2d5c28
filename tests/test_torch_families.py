"""PyTorch port, the dense families whose d_ff is not a power of 2:
llama3-405b (fp8_e4m3), qwen1.5-4b (int8 W8A8; QKV biases) and
starcoder2-15b (fp8_e4m3; QKV biases, LayerNorm, the tanh-GELU MLP without a
gate), each Hadamard-rotated with its KV cache quantized alike and int8
weight storage. The published configs, the new blocks against the
reference's, ``launch/flops.py`` and the one-shot launcher ``launch/serve.py``,
and each family scaled down by the reference's own ``scaled_down`` (2
layers) with the reference's parameters carried across by
``repro_torch.bridge`` -- the QKV biases and the LayerNorm scales and biases
redrawn from a numpy seed on both sides (the reference initialises them to
ones and zeros, which would hide a misplaced add) -- against the un-meshed
reference ``lm_prefill`` + ``lm_decode_step`` (backend ``pallas`` in
interpret mode, jitted as written: ``xla_allow_excess_precision`` off) on
the CPU. d_ff = 96 = 3 x 32 at this scale: both packages run the grouped
rotation and the unfused down projection, as the published d_ff (27 x 256,
13 x 4096, 3 x 8192) do.

What is bitwise and what is not:

* GELU is bitwise for every bf16 input whose result is a normal number
  (XLA's CPU code flushes subnormal results to zero; torch keeps them).
* The QKV bias adds are bitwise on the same 16-bit products, and the
  prefill mask equals the reference's.
* LayerNorm (like the port's RMSNorm) differs by at most 1 bf16 ulp in a
  few elements per thousand: XLA sums each row's f32 values in its own
  vectorised order and its f32 rsqrt is not torch's ``1 / sqrt``, so the
  f32 normalised values differ in their last bits and now and then round
  to neighbouring bf16 values.
* The models: logits at every one of the 9 steps (prefill, then 8 decode
  steps, both packages fed the reference's greedy token) within
  ``LOGIT_TOL`` of the largest |logit| elementwise and ``REL_TOL`` relative
  RMS (the contract of ``test_torch_model.py``: single bf16 flips where a
  matmul sums in another order); the port's greedy token equals the
  reference's wherever the reference's top-1/top-2 margin exceeds twice the
  step's largest logit gap (the margin rule). Readings over prompt seeds
  0-5 (``python tests/test_torch_families.py``): see ``READINGS``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.quant import QuantConfig as JQuantConfig
from repro.core.wquant import QTensor as JQTensor
from repro.core.wquant import quantize_lm_weights as jquantize_lm_weights
from repro.launch import flops as jflops
from repro.launch import shapes as jshapes
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import init_lm as jinit_lm
from repro.models import lm_decode_step as jlm_decode_step
from repro.models import lm_prefill as jlm_prefill
from repro.models.lm import pad_kv_caches as jpad_kv_caches

from repro_torch.bridge import params_from_reference, to_reference
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import registry
from repro_torch.kernels.fused_quant import fused_dequant_cuda
from repro_torch.kernels.hadacore import hadacore_cuda
from repro_torch.launch import env, flops, serve, shapes
from repro_torch.models import attention, common, mlp
from repro_torch.models.lm import init_lm, lm_decode_step, lm_prefill, pad_kv_caches

FAMILIES = {   # arch -> quant mode of its card run (and of its test here)
    "llama3-405b": "fp8_e4m3",
    "qwen1.5-4b": "int8",
    "starcoder2-15b": "fp8_e4m3",
}
B, S, GEN, T = 2, 16, 8, 32
LOGIT_TOL, REL_TOL = 0.05, 0.04
AS_WRITTEN = {"xla_allow_excess_precision": False}
FIELDS = ("name", "family", "d_model", "num_heads", "num_kv_heads", "d_ff",
          "vocab_size", "groups", "head_dim", "rope_theta", "vocab_pad_multiple",
          "tie_embeddings", "num_experts", "experts_per_token", "moe_shared_expert",
          "capacity_factor", "sliding_window", "qkv_bias", "act", "norm", "dtype")


def _np_tree(t):
    if isinstance(t, JQTensor):
        return {"q": np.asarray(t.q), "scale": np.asarray(t.scale), "mode": t.mode}
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


def _jname(arch):
    return arch.replace("-", "_").replace(".", "_")


def _configs(arch, mode):
    jq = JQuantConfig(mode=mode, rotate="hadamard", backend="pallas", kv_quant=True)
    tq = QuantConfig(mode=mode, rotate="hadamard", backend="cuda", kv_quant=True)
    jcfg = jget_config(_jname(arch)).scaled_down().with_quant(jq)
    tcfg = get_config(arch).scaled_down().with_quant(tq)
    return (dataclasses.replace(jcfg, weight_quant="int8"),
            dataclasses.replace(tcfg, weight_quant="int8"))


def _with_drawn_leaves(tree, seed=11):
    """A reference tree with every QKV bias drawn N(0, 0.5^2) and every
    LayerNorm (a norm dict with a bias) scale 1 + N(0, 0.2^2) and bias
    N(0, 0.2^2), from a numpy seed, each in its leaf's dtype."""
    rng = np.random.default_rng(seed)

    def draw(leaf, loc, sd):
        return jnp.asarray((loc + sd * rng.standard_normal(leaf.shape)).astype(
            np.float32)).astype(leaf.dtype)

    def walk(t):
        if isinstance(t, list):
            return [walk(v) for v in t]
        if not isinstance(t, dict):
            return t
        if set(t) == {"scale", "bias"}:
            return {"scale": draw(t["scale"], 1.0, 0.2), "bias": draw(t["bias"], 0.0, 0.2)}
        return {k: draw(v, 0.0, 0.5) if k in ("bq", "bk", "bv") else walk(v)
                for k, v in t.items()}

    return walk(tree)


def _build(arch):
    jcfg, tcfg = _configs(arch, FAMILIES[arch])
    jp = jax.jit(lambda k: jquantize_lm_weights(jinit_lm(k, jcfg), jcfg))(
        jax.random.PRNGKey(0))
    jp = _with_drawn_leaves(jp)
    return jcfg, tcfg, jp, params_from_reference(_np_tree(jp), device="cpu")


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = _build(arch)
    return _MODELS[arch]


def _prompt(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ["llama3-405b", "qwen1.5-4b", "starcoder2-15b",
                                  "mixtral-8x7b"])
def test_config_is_the_reference_config(arch):
    """Each new config carries the reference's field for field, and
    ``scaled_down`` keeps what the reference's keeps (the window cut to at
    most 8 tokens, the MLP and norm flavour, the biases)."""
    cfg, ref = get_config(arch), jget_config(_jname(arch))
    assert _jname(arch) in ARCH_IDS and get_config(_jname(arch)) is cfg
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(ref, f), f
    small, jsmall = cfg.scaled_down(), ref.scaled_down()
    for f in FIELDS:
        assert getattr(small, f) == getattr(jsmall, f), f
    assert small.num_layers == 2 and small.d_ff == 96
    if arch == "mixtral-8x7b":
        assert (small.sliding_window, small.num_experts, small.experts_per_token) == (8, 4, 2)


def test_published_shapes_are_grouped_down_projections():
    """No new family's d_ff is a power of 2: each down projection rotates
    as grouped transforms of the largest power-of-2 divisor."""
    from repro_torch.core.api import plan_for

    want = {"llama3-405b": (13, 4096), "qwen1.5-4b": (27, 256),
            "starcoder2-15b": (3, 8192), "mixtral-8x7b": (7, 2048)}
    for arch, (g, p) in want.items():
        plan = plan_for(get_config(arch).d_ff, device_type="cpu")
        assert plan.grouped and (plan.n // plan.p, plan.p) == (g, p), arch


def test_transform_harness_times_the_grouped_path_shapes():
    """``bench/hadamard.py`` times K1 at each new family's grouped down
    projection at decode (4 slots) and prefill (64 tokens), and at
    mixtral's expert site over the dispatched rows (batch x 8 experts x
    capacity: 1 slot each at decode, 20 at prefill)."""
    from repro_torch.bench import hadamard as bench

    path = {(c.site, c.rows, c.n) for c in bench.CASES if c.group == "path"}
    T_, P_ = bench.SLOTS, bench.PREFILL_LEN
    for name, g, p in (("qwen1.5-4b", 27, 256), ("llama3-405b", 13, 4096),
                       ("starcoder2-15b", 3, 8192)):
        assert {(f"{name} decode down-proj", T_ * g, p),
                (f"{name} prefill down-proj", P_ * g, p)} <= path
    assert {("mixtral-8x7b decode experts down-proj", T_ * 8 * 1 * 7, 2048),
            ("mixtral-8x7b prefill experts down-proj", 8 * 20 * 7, 2048)} <= path


@pytest.mark.parametrize("arch", ["llama3_8b", "phi4_mini_3_8b",
                                  "llama4_maverick_400b_a17b", "llama3_405b",
                                  "qwen1_5_4b", "starcoder2_15b", "mixtral_8x7b"])
def test_count_params_and_model_flops_match_reference(arch):
    """``launch/flops.py`` from the port's own parameter shapes (``init_lm``
    on the meta device) gives the reference's counts and FLOPs for every
    ported architecture and assigned shape."""
    assert set(ARCH_IDS) >= {arch}
    cfg, ref = get_config(arch), jget_config(arch)
    assert flops.count_params(cfg) == jflops.count_params(ref)
    for name, shape in shapes.SHAPES.items():
        assert flops.model_flops(cfg, shape) == jflops.model_flops(
            ref, jshapes.SHAPES[name]), name


# ---------------------------------------------------------------- blocks
def test_gelu_is_bitwise_the_reference_for_every_bf16_value():
    """Every finite bf16 value through the tanh GELU, op by op in bf16,
    against the compiled ``jax.nn.gelu``: bitwise for every input of
    magnitude 2^-120 or more, and 0 (below that the result is subnormal,
    which XLA's CPU code flushes to zero and torch keeps). ``F.gelu``'s
    erf form would differ."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    x = bits.view(ml_dtypes.bfloat16)
    xf = x.astype(np.float32)
    x, xf = x[np.isfinite(xf)], xf[np.isfinite(xf)]
    want = np.asarray(jax.jit(jax.nn.gelu, compiler_options=AS_WRITTEN)(
        jnp.asarray(x))).astype(np.float32)
    got = mlp._gelu(torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)).float().numpy()
    held = (np.abs(xf) >= 2.0 ** -120) | (xf == 0)
    assert held.sum() > 60000
    np.testing.assert_array_equal(got[held], want[held])
    erf = torch.nn.functional.gelu(torch.from_numpy(xf).to(torch.bfloat16)).float().numpy()
    assert (erf[held] != want[held]).sum() > 1000
    cfg = get_config("starcoder2-15b")
    t = torch.from_numpy(xf[:4096]).to(torch.bfloat16)
    assert torch.equal(mlp._act(cfg, t), mlp._gelu(t))


def _bf16_spacing(v):
    """The distance from |v| to the next bf16 value up (2^-126-7 at 0)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [64, 384, 6144])
def test_layernorm_matches_reference(d, dtype):
    """LayerNorm (eps 1e-5, the population variance of the centred values,
    f32 throughout, scale and bias) against the compiled reference, on rows
    of spread 3 and rows whose variance is near eps. XLA's row sums and
    rsqrt round differently from torch's, so the f32 values differ by a
    few f32 ulps of the row's largest |value| (of |x| rsqrt(var + eps) |scale|
    where that is larger: the rows of small variance): in bf16 every element
    is within 1 ulp of its value or those few f32 ulps (where the bias add
    cancels), and at most 2 of every 1000 differ at all. Controls, each
    off by far more: the unbiased variance (``torch.var``'s default) and
    RMSNorm's eps."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((4, 33, d)) * 3 + 0.7).astype(np.float32)
    x[:, :4] = (0.7 + 3e-3 * rng.standard_normal((4, 4, d))).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(d)).astype(np.float32)
    jcfg, tcfg = jget_config("starcoder2_15b"), get_config("starcoder2-15b")
    assert tcfg.norm == "layernorm"
    p = common.init_norm(tcfg, d, "cpu")
    assert set(p) == {"scale", "bias"} and not p["bias"].any() and bool((p["scale"] == 1).all())
    want = np.asarray(jax.jit(lambda s, b, a: jcommon.apply_norm(
        jcfg, {"scale": s, "bias": b}, a), compiler_options=AS_WRITTEN)(
        scale, bias, jnp.asarray(x, jnp.dtype(dtype))).astype(jnp.float32))
    tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = common.apply_norm(tcfg, tp, tx).float().numpy()
    # f32 rounding of the mean and the centred values, amplified by
    # rsqrt(var + eps) * scale (large on the rows of small variance)
    xd = tx.double().numpy()
    r = 1 / np.sqrt(xd.var(-1, keepdims=True) + 1e-5)
    gain = np.abs(xd).max(-1, keepdims=True) * r * np.abs(scale).max()
    f32_ulps = 4 * 2.0 ** -23 * np.maximum(np.abs(want).max(-1, keepdims=True), gain)
    tol = np.maximum(_bf16_spacing(want), f32_ulps) if dtype == "bfloat16" else f32_ulps
    assert (np.abs(got - want) <= tol).all()
    noise = (got != want).mean()
    if dtype == "bfloat16":
        assert noise <= 2e-3, noise
    xf = tx.float()
    mu = xf.mean(-1, keepdim=True)
    for var, eps in ((xf.var(-1, keepdim=True), 1e-5),
                     ((xf - mu).square().mean(-1, keepdim=True), 1e-6)):
        bad = ((xf - mu) * torch.rsqrt(var + eps) * tp["scale"] + tp["bias"]).to(
            tx.dtype).float().numpy()
        if dtype == "bfloat16":
            assert (bad != want).mean() > 10 * max(noise, 1e-4)
        else:
            assert (np.abs(bad - want) > 10 * tol).any()


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "starcoder2-15b"])
def test_qkv_bias_adds_are_bitwise(arch):
    """``_project_qkv`` with drawn biases: the bias add on the 16-bit
    products is bitwise the reference's (held on the reference's own
    products), the whole projection within 1 bf16 ulp, and a missing bias
    is caught."""
    jcfg, tcfg = _configs(arch, FAMILIES[arch])
    jp = _with_drawn_leaves(jax.tree.map(lambda a: a[0], jinit_lm(
        jax.random.PRNGKey(1), jcfg)["groups"][0]["p0"]["attn"]))
    assert {"bq", "bk", "bv"} <= set(jp) and float(jnp.abs(jp["bq"].astype(jnp.float32)).max()) > 0.1
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16)
          for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jax.jit(lambda p, a: jattn._project_qkv(jcfg, p, a),
                   compiler_options=AS_WRITTEN)(jp, jx)
    got = attention._project_qkv(tcfg, tp, torch.from_numpy(x).to(torch.bfloat16))
    nob = jax.jit(lambda p, a: jattn._project_qkv(
        dataclasses.replace(jcfg, qkv_bias=False), p, a))(jp, jx)
    for name, w, g, n in zip("qkv", want, got, nob):
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        assert np.all(np.abs(g - w) <= np.abs(w) * 2.0 ** -7), name
        assert np.abs(np.asarray(n.astype(jnp.float32)) - w).max() > 0.1, name
    # the add alone, on the reference's products
    H, KH, hd = jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    for w_name, b_name, heads in (("wq", "bq", H), ("wk", "bk", KH), ("wv", "bv", KH)):
        prod = jax.jit(lambda a, w: a @ w, compiler_options=AS_WRITTEN)(jx, jp[w_name])
        ref = jax.jit(lambda a, b: a + b, compiler_options=AS_WRITTEN)(prod, jp[b_name])
        tprod = torch.from_numpy(np.asarray(prod.astype(jnp.float32))).to(torch.bfloat16)
        np.testing.assert_array_equal((tprod + tp[b_name]).float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
        assert ref.shape[-1] == heads * hd


def test_prefill_mask_is_the_reference_mask():
    """The prefill mask, full and windowed, is the reference's elementwise
    (``k > q - W`` with ``k <= q``)."""
    for w in (0, 1, 3, 8, 40):
        jcfg = dataclasses.replace(jget_config("mixtral_8x7b"), sliding_window=w)
        tcfg = dataclasses.replace(get_config("mixtral-8x7b"), sliding_window=w)
        for S_, T_ in ((16, 16), (5, 24)):
            np.testing.assert_array_equal(
                attention._causal_mask(tcfg, S_, T_, "cpu").numpy(),
                np.asarray(jattn._causal_mask(jcfg, S_, T_)))


def test_bridge_carries_the_new_leaves_both_ways():
    """The QKV biases (bf16) and the LayerNorm biases (f32) cross from the
    reference's stacked layout into the port's per-layer list and back,
    bit for bit; the GELU MLP has no gate on either side."""
    jcfg, tcfg = _configs("starcoder2-15b", "none")
    jcfg = dataclasses.replace(jcfg, weight_quant="none")
    tcfg = dataclasses.replace(tcfg, weight_quant="none")
    jp = _with_drawn_leaves(jinit_lm(jax.random.PRNGKey(3), jcfg))
    ref = _np_tree(jp)
    params = params_from_reference(ref, device="cpu")
    layer = params["layers"][1]
    assert set(layer["attn"]) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
    assert set(layer["mlp"]) == {"w_up", "w_down"}
    assert set(layer["norm1"]) == {"scale", "bias"} and set(params["final_norm"]) == {"scale", "bias"}
    assert layer["attn"]["bk"].dtype == torch.bfloat16 and layer["norm2"]["bias"].dtype == torch.float32
    np.testing.assert_array_equal(layer["attn"]["bq"].view(torch.int16).numpy(),
                                  ref["groups"][0]["p0"]["attn"]["bq"][1].view(np.int16))
    back = to_reference(params, tcfg)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        got = flat_back[path]
        np.testing.assert_array_equal(np.asarray(got).view(np.uint8),
                                      np.asarray(leaf).view(np.uint8))
    # the port's own init has the reference's tree: the same leaves, shapes, dtypes
    mine = to_reference(init_lm(tcfg, seed=0, device="cpu"), tcfg, meta=True)
    shapes_of = {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                 for p, v in jax.tree_util.tree_leaves_with_path(mine)}
    assert shapes_of == {p: (tuple(v.shape), v.dtype.name) for p, v in flat_ref}


# --------------------------------------------------- model against ref
def _run(arch, seed):
    """Prefill, then 8 decode steps in each package, both fed the
    reference's greedy token. Per step (prefill first): (largest logit gap
    / largest |logit|, relative RMS gap, tokens agree by the margin
    rule)."""
    jcfg, tcfg, jp, params = _model(arch)
    toks = _prompt(tcfg, seed)
    V = tcfg.vocab_size
    jpre = jax.jit(lambda p, b: jlm_prefill(jcfg, p, b), compiler_options=AS_WRITTEN)
    jdec = jax.jit(lambda p, c, t, pos: jlm_decode_step(jcfg, p, c, t, pos),
                   compiler_options=AS_WRITTEN)
    jl, jc = jpre(jp, {"tokens": jnp.asarray(toks)})
    jc = jpad_kv_caches(jcfg, jc, T)
    tl, tc = lm_prefill(tcfg, params, {"tokens": torch.from_numpy(toks).long()})
    tc = pad_kv_caches(tcfg, tc, T)
    steps = []
    for i in range(GEN + 1):
        g = tl[:, -1, :V].float().numpy()
        w = np.asarray(jl[:, -1, :V], np.float32)
        assert np.isfinite(g).all()
        gap = np.abs(g - w).max()
        top = np.sort(w, -1)
        sure = top[:, -1] - top[:, -2] > 2 * gap
        steps.append((gap / np.abs(w).max(), np.linalg.norm(g - w) / np.linalg.norm(w),
                      bool(((g.argmax(-1) == w.argmax(-1)) | ~sure).all())))
        if i < GEN:
            jt = jnp.argmax(jl[:, -1, :V], -1).astype(jnp.int32)[:, None]
            jl, jc = jdec(jp, jc, jt, jnp.asarray(S + i, jnp.int32))
            tl, tc = lm_decode_step(tcfg, params, tc, torch.from_numpy(np.array(jt)).long(),
                                    torch.tensor(S + i))
    return steps


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and 8 decode steps of each scaled family against the
    reference, on the reference's parameters with drawn biases: within the
    logit tolerances at every step, tokens by the margin rule; CPU tensors
    launch no kernel."""
    before = (hadacore_cuda.launches, fused_dequant_cuda.launches)
    for i, (gap, rel, same) in enumerate(_run(arch, 0)):
        assert gap <= LOGIT_TOL and rel <= REL_TOL and same, (arch, i, gap, rel, same)
    assert (hadacore_cuda.launches, fused_dequant_cuda.launches) == before


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_each_layer_reaches_one_grouped_rotation_and_two_fused_qk_sites(arch, monkeypatch):
    """Per layer the down projection reaches the backend's standalone
    transform once (K1, grouped, on the card) and never the fused
    quant_dot (K4); the Q and K sites reach fused_dequant once each (K2);
    no weight is quantized while serving."""
    from repro_torch.core import wquant

    jcfg, tcfg, jp, params = _model(arch)
    calls = {n: 0 for n in ("transform", "fused_dequant", "fused", "quant_dot",
                            "quant_dot_experts")}
    for name in calls:
        real = getattr(registry.CudaBackend, name)

        def spy(self, *a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(registry.CudaBackend, name, spy)
    before = wquant.QUANTIZE_WEIGHT_CALLS
    with torch.inference_mode():
        lm_prefill(tcfg, params, {"tokens": torch.from_numpy(_prompt(tcfg, 1)).long()})
    L = tcfg.num_layers
    assert calls == {"transform": L, "fused_dequant": 2 * L, "fused": 0,
                     "quant_dot": 0, "quant_dot_experts": 0}
    assert wquant.QUANTIZE_WEIGHT_CALLS == before


# ----------------------------------------------------------- launcher
def test_serve_launcher_runs_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` end to end on a
    scaled qwen1.5-4b (int8 W8A8 + Hadamard): prefill, 5 greedy decode
    steps at a shared scalar position, tokens in the vocabulary, the
    steady-state rate printed; its tokens are the port's own one-shot
    greedy decode's. ``--mp 2`` at a world of
    one rank raises the mesh's ValueError."""
    argv = ["--device", "cpu", "--arch", "qwen1.5-4b", "--scale", "0.005",
            "--batch", "2", "--prompt-len", "12", "--gen", "6", "--quant", "int8",
            "--rotate", "hadamard", "--seed", "3"]
    out = serve.main(argv)
    cfg = out["cfg"]
    assert cfg.qkv_bias and cfg.weight_quant == "int8" and cfg.quant.mode == "int8"
    toks = out["tokens"]
    assert toks.shape == (2, 6) and ((0 <= toks) & (toks < cfg.vocab_size)).all()
    assert out["decode_steps"] == 4 and out["tokens_per_s"] > 0
    text = capsys.readouterr().out
    assert "qwen1.5-4b" in text and "tok/s" in text and "sample token ids" in text
    # the same model, prefill and greedy steps by hand
    params = init_lm(cfg, seed=3, device="cpu")
    batch = shapes.make_batch(cfg, shapes.ShapeSpec("serve", "prefill", 12, 2), seed=3)
    with torch.inference_mode():
        logits, caches = lm_prefill(cfg, params, {"tokens": torch.from_numpy(batch["tokens"]).long()})
        caches = pad_kv_caches(cfg, caches, 18)
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        mine = [tok]
        for i in range(5):
            logits, caches = lm_decode_step(cfg, params, caches, tok, torch.tensor(12 + i))
            tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
            mine.append(tok)
    np.testing.assert_array_equal(torch.cat(mine, 1).numpy(), toks)
    # every family runs on the mesh; at a world of one rank --mp 2 is the
    # mesh's own ValueError
    with pytest.raises(ValueError, match="does not divide"):
        serve.main(argv + ["--mp", "2"])


def test_env_hardening_sets_only_host_variables():
    """``harden_host_env`` sets tcmalloc's report threshold (and its preload
    where one is installed) and no XLA / TF variable; the opt-out makes it a
    no-op; an injected environment is never re-exec'd."""
    environ = {}
    applied = env.harden_host_env(environ=environ, reexec=True)
    assert environ["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "60000000000"
    assert not any(k.startswith(("XLA", "TF_")) for k in environ)
    assert set(applied) <= {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "LD_PRELOAD"}
    assert ("LD_PRELOAD" in applied) == (env.find_tcmalloc() is not None)
    assert env.harden_host_env(environ={"REPRO_NO_ENV_HARDEN": "1"}) == {}
    assert env.harden_host_env(environ=dict(environ)) == {}


if __name__ == "__main__":
    # The readings behind the tolerances:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_families.py
    for arch in FAMILIES:
        for seed in range(6):
            st = _run(arch, seed)
            print(f"{arch} seed {seed}: largest gap {max(s[0] for s in st):.4f} of "
                  f"max |logit|, relative RMS {max(s[1] for s in st):.4f}, tokens "
                  f"agree (margin rule) {all(s[2] for s in st)}")
