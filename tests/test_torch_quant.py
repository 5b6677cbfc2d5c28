"""PyTorch port, quantize stage: the plain versions of the K2 fused
rotate -> fake-quant and K3 fused rotate -> (q, scales) kernels, the shared
epilogue math, the fp8 casts, weight quantization and the quantized-GEMM
host math, held against the JAX reference on the CPU.

Tolerances:

  * K2's plain version against ``_pallas_fused_dequant`` in interpret
    mode, all three modes: bitwise at n <= 2048.
  * K3's plain version against ``_pallas_fused`` in interpret mode, all
    three modes, bf16 and f32: q (as stored bytes) and s bitwise at
    n <= 2048; the oracle ``ref_fused`` bitwise against the reference's.
  * ``quantize``, ``_quantize_rows`` / ``_dequantize``, ``quantize_weight``
    and ``quantize_lm_weights`` against the COMPILED reference (jax.jit):
    bitwise. XLA compiles the reference's ``absmax / qmax`` into a product
    with the f32 reciprocal of qmax, which the port mirrors; an eager
    reference call divides and can differ in the last bit of a scale.
  * The fp8 casts: bitwise against ml_dtypes, NaN on e4m3 overflow.
  * ``epilogue_dot`` against the reference's: int8 bitwise (exact int32
    accumulation, then the same f32 epilogue); fp8 within 1e-5 relative to
    the row's largest |output| (both sum exact products in f32, in another
    order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.api import QuantDotSpec as JQuantDotSpec
from repro.core.api import QuantEpilogue as JQuantEpilogue
from repro.core.api import RotationSpec as JRotationSpec
from repro.core.api import hadamard as jhadamard
from repro.core.api import plan_for as jplan_for
from repro.core.quant import QuantConfig as JQuantConfig
from repro.core.quant import quantize as jquantize
from repro.core.wquant import QTensor as JQTensor
from repro.core.wquant import quantize_lm_weights as jquantize_lm_weights
from repro.core.wquant import quantize_weight as jquantize_weight
from repro.kernels import quant_dot as jqd
from repro.kernels import registry as jreg
from repro.models import init_lm as jinit_lm

from repro_torch.bridge import params_from_reference, to_torch
from repro_torch.configs import get_config
from repro_torch.core import wquant
from repro_torch.core.api import (QuantDotSpec, QuantEpilogue, RotationSpec,
                                  hadamard, plan_for)
from repro_torch.core.quant import QuantConfig, kv_quantize, quantize
from repro_torch.kernels import registry
from repro_torch.kernels import fused_quant as fq
from repro_torch.kernels.fused_quant import (fused, fused_cuda, fused_dequant,
                                             fused_dequant_cuda,
                                             fused_dequant_plain, fused_plain)
from repro_torch.kernels.quant_dot import epilogue_dot

MODES = ["int8", "fp8_e4m3", "fp8_e5m2"]
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(x) -> np.ndarray:
    """A jax or torch array as f32 numpy (fp8 / int8 values included)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _same(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _same_bytes(t: torch.Tensor, j) -> None:
    """A port tensor and a reference array hold the same bytes (int8 / fp8
    storage, so NaN encodings compare too)."""
    np.testing.assert_array_equal(t.contiguous().view(torch.uint8).numpy(),
                                  np.asarray(j).view(np.uint8))


# ------------------------------------------------------------ K2 parity
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [32, 128, 2048])
def test_plain_k2_matches_pallas_kernel_interpret(n, mode, dt):
    x = _inputs((16, n), seed=n)
    xj = jnp.asarray(x).astype(dt)
    jplan = jplan_for(n, dtype=xj.dtype, backend="pallas",
                      epilogue=JQuantEpilogue(mode, dequant=True))
    want = jreg._pallas_fused_dequant(xj, jplan, True)
    xt = torch.from_numpy(x).to(TDT[dt])
    plan = plan_for(n, dtype=xt.dtype, backend="cuda", device_type="cpu",
                    epilogue=QuantEpilogue(mode, dequant=True))
    got = fused_dequant_plain(xt, plan)
    assert got.dtype == xt.dtype
    _same(got, want)
    # the cuda backend takes a CPU tensor to the same plain version
    before = fused_dequant_cuda.launches
    _same(hadamard(xt, plan), want)
    assert fused_dequant_cuda.launches == before


# ------------------------------------------------------------ K3 parity
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [32, 128, 2048])
def test_plain_k3_matches_pallas_kernel_interpret(n, mode, dt):
    x = _inputs((16, n), seed=n + 1)
    xj = jnp.asarray(x).astype(dt)
    jplan = jplan_for(n, dtype=xj.dtype, backend="pallas",
                      epilogue=JQuantEpilogue(mode))
    jq, js = jreg._pallas_fused(xj, jplan, True)
    xt = torch.from_numpy(x).to(TDT[dt])
    plan = plan_for(n, dtype=xt.dtype, backend="cuda", device_type="cpu",
                    epilogue=QuantEpilogue(mode))
    q, s = fused_plain(xt, plan)
    assert q.dtype == registry.QSPECS[mode][1] and s.shape == (16, 1)
    _same_bytes(q, jq)
    _same(s, js)
    # the entry point takes a CPU tensor to the same plain version
    before = fused_cuda.launches
    q2, s2 = hadamard(xt, plan)
    _same_bytes(q2, jq)
    _same(s2, js)
    assert fused_cuda.launches == before


def test_fused_dispatch_runs_k3_only_when_the_plan_fuses(monkeypatch):
    """A per-token power-of-2 plan goes to the backend's ``fused`` (K3 on
    the card); grouped sizes and per-tensor scales run transform + the plain
    epilogue over the full row, as in the reference."""
    calls = []
    real = registry.CudaBackend.fused

    def spy(self, x, plan):
        calls.append(plan.n)
        return real(self, x, plan)

    monkeypatch.setattr(registry.CudaBackend, "fused", spy)
    for n, per_token, fused_ in ((128, True, True), (96, True, False),
                                 (128, False, False)):
        x = _inputs((4, n), seed=22)
        epi = QuantEpilogue("int8", per_token=per_token)
        jepi = JQuantEpilogue("int8", per_token=per_token)
        calls.clear()
        q, s = hadamard(torch.from_numpy(x).to(torch.bfloat16), epilogue=epi,
                        backend="cuda")
        jq, js = jax.jit(lambda a: jhadamard(a, epilogue=jepi, backend="pallas",
                                             interpret=True))(
            jnp.asarray(x, jnp.bfloat16))
        assert calls == ([n] if fused_ else [])
        _same_bytes(q, jq)
        _same(s, js)


@pytest.mark.parametrize("mode", MODES)
def test_ref_fused_and_deprecated_shim_match_reference(mode):
    from repro.kernels import fused_quant as jfq

    x = _inputs((6, 64), seed=23)
    jq, js = jax.jit(lambda a: jfq.ref_fused(a, mode=mode))(jnp.asarray(x))
    q, s = fq.ref_fused(torch.from_numpy(x), mode=mode)
    _same_bytes(q, jq)
    _same(s, js)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with pytest.warns(DeprecationWarning):
        registry.WARN_ONCE_SEEN.discard(fq.WARN_KEY)
        q, s = fq.fused_hadamard_quantize(xt, mode=mode)
    want = fused(xt, plan_for(64, dtype=torch.bfloat16, backend="cuda",
                              device_type="cpu", epilogue=QuantEpilogue(mode)))
    _same_bytes(q, np.asarray(want[0].view(torch.uint8)))
    assert torch.equal(s, want[1])
    with pytest.raises(ValueError, match="power of 2"):
        fq.fused_hadamard_quantize(xt[:, :48])


def test_k3_kernel_wrapper_takes_cuda_tensors_only():
    x = torch.zeros(4, 128, dtype=torch.bfloat16)
    plan = plan_for(128, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                    epilogue=QuantEpilogue("int8"))
    before = fused_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_cuda(x, torch.zeros(4, 128, dtype=torch.int8),
                   torch.zeros(4, 1), plan)
    with pytest.raises(ValueError, match="per-token"):
        fused_cuda(x, x, x, plan_for(128, dtype=torch.bfloat16, device_type="cpu",
                                     epilogue=QuantEpilogue("int8", dequant=True)))
    assert fused_cuda.launches == before


@pytest.mark.parametrize("mode", MODES)
def test_rotation_spec_matches_reference(mode):
    """The attention Q/K site (rotate + fake-quant, n = head_dim) and the V
    site (quantize only), bf16."""
    x = _inputs((2, 5, 4, 128), seed=11)
    jq = JQuantConfig(mode=mode, rotate="hadamard", backend="pallas", kv_quant=True)
    tq = QuantConfig(mode=mode, rotate="hadamard", backend="cuda", kv_quant=True)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    _same(RotationSpec.for_config(128, tq)(xt),
          JRotationSpec.for_config(128, jq)(xj, interpret=True))
    _same(RotationSpec.for_config(128, tq, rotate=False)(xt),
          jax.jit(lambda a: JRotationSpec.for_config(128, jq, rotate=False)(a))(xj))


@pytest.mark.parametrize("mode", MODES)
def test_q_scales_epilogue_matches_reference(mode):
    """``(q, scales)`` epilogue (transform + plain epilogue in the port; the
    reference's fused K3 kernel in interpret mode)."""
    x = _inputs((8, 256), seed=12)
    jq, js = jhadamard(jnp.asarray(x), backend="pallas", interpret=True,
                       epilogue=JQuantEpilogue(mode))
    tq, ts = hadamard(torch.from_numpy(x), epilogue=QuantEpilogue(mode))
    assert tq.dtype == registry.QSPECS[mode][1]
    _same(tq, jq)
    _same(ts, js)


# ----------------------------------------------------- epilogue math
@pytest.mark.parametrize("axis", [-1, -2, None])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_rows_and_quantize_match_reference(mode, axis):
    x = _inputs((6, 40), seed=13)
    jq, js = jax.jit(lambda a: jreg._quantize_rows(a, mode, axis))(jnp.asarray(x))
    tq, ts = registry._quantize_rows(torch.from_numpy(x), mode, axis)
    _same(tq, jq)
    _same(ts, js)
    _same(registry._dequantize(tq, ts, mode),
          jax.jit(lambda q, s: jreg._dequantize(q, s, mode))(jq, js))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    _same(quantize(xb, mode, axis=axis),
          jax.jit(lambda a: jquantize(a, mode, axis=axis))(
              jnp.asarray(x, jnp.bfloat16)))


def test_quantize_none_and_kv_quantize():
    x = torch.from_numpy(_inputs((2, 3, 8), seed=14))
    assert quantize(x, "none") is x
    k, v = kv_quantize(x, x, QuantConfig(mode="int8"))
    assert k is x and v is x
    k, v = kv_quantize(x, x, QuantConfig(mode="int8", kv_quant=True))
    assert torch.equal(k, quantize(x, "int8"))
    with pytest.raises(ValueError):
        QuantConfig(backend="pallas")
    cfg = QuantConfig(mode="fp8_e4m3", kv_quant=True)
    assert cfg.kv_cache_dtype(torch.bfloat16) == torch.float8_e4m3fn
    assert QuantConfig(mode="fp8_e5m2", kv_quant=True).kv_cache_dtype(
        torch.bfloat16) == torch.float8_e5m2
    assert QuantConfig(mode="int8", kv_quant=True).kv_cache_dtype(
        torch.bfloat16) == torch.bfloat16


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_cast_matches_ml_dtypes_including_overflow(fmt, src):
    """torch saturates e4m3 overflow to +-448; the reference (ml_dtypes /
    XLA) gives NaN above the 464 rounding midpoint. The port's cast keeps
    the NaN; e5m2 already agrees (inf)."""
    v = np.array([0.0, 1e-9, 9e-4, 1.95e-3, 440, 448, 455, 464, 464.01, 470,
                  480, 500, 1e4, 57344, 61439, 61440, 1e6, np.inf, -np.inf,
                  np.nan, -464.5, -3.3], np.float32)
    v = np.concatenate([v, _inputs((500,), seed=15, scale=100.0)])
    if src == "bfloat16":
        v = v.astype(ml_dtypes.bfloat16).astype(np.float32)
    want = v.astype(ml_dtypes.bfloat16 if src == "bfloat16" else np.float32)
    want = want.astype(getattr(ml_dtypes, fmt)).astype(np.float32)
    got = registry.cast_to(torch.from_numpy(v).to(TDT[src]),
                           getattr(torch, fmt)).to(torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ weight storage
@pytest.mark.parametrize("mode", MODES)
def test_quantize_weight_matches_reference(mode):
    w = _inputs((3, 64, 48), seed=16, scale=0.05).astype(ml_dtypes.bfloat16)
    jt = jax.jit(lambda a: jquantize_weight(a, mode))(jnp.asarray(w))
    calls = wquant.QUANTIZE_WEIGHT_CALLS
    tt = wquant.quantize_weight(to_torch(w, "cpu"), mode)
    assert wquant.QUANTIZE_WEIGHT_CALLS == calls + 1
    assert tt.q.dtype == registry.QSPECS[mode][1] and tt.mode == mode
    assert tt.scale.shape == (3, 1, 48)
    np.testing.assert_array_equal(tt.q.view(torch.uint8).numpy(),
                                  np.asarray(jt.q).view(np.uint8))
    _same(tt.scale, jt.scale)
    _same(tt.dequant(torch.bfloat16), jt.dequant(jnp.bfloat16))


def _np_tree(t):
    """A reference param tree as nested dicts of numpy arrays, each QTensor
    as {"q", "scale", "mode"} (the bridge's input form)."""
    if isinstance(t, JQTensor):
        return {"q": np.asarray(t.q), "scale": np.asarray(t.scale), "mode": t.mode}
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


def test_quantize_lm_weights_matches_reference():
    """Port quantization of the bridged bf16 params == the reference's
    stacked quantization, leaf for leaf (a config whose per-layer matrices
    all clear the 2^16-element floor, which the port applies per layer)."""
    over = dict(d_model=512, num_heads=4, num_kv_heads=1, d_ff=384)
    jq = JQuantConfig(mode="fp8_e4m3", rotate="hadamard", backend="xla",
                      kv_quant=True)
    jcfg = jget_config("llama3_8b").scaled_down(**over).with_quant(jq)
    tcfg = get_config("llama3_8b").scaled_down(**over).with_quant(
        QuantConfig(mode="fp8_e4m3", rotate="hadamard", kv_quant=True))
    raw = jax.jit(lambda k: jinit_lm(k, jcfg))(jax.random.PRNGKey(0))
    want = params_from_reference(_np_tree(
        jax.jit(lambda p: jquantize_lm_weights(p, jcfg))(raw)), "cpu")
    got = wquant.quantize_lm_weights(params_from_reference(_np_tree(raw), "cpu"),
                                     tcfg)

    def walk(a, b, keys=()):
        if isinstance(b, dict):
            assert set(a) == set(b), keys
            for k in b:
                walk(a[k], b[k], keys + (k,))
        elif isinstance(b, list):
            for x, y in zip(a, b):
                walk(x, y, keys)
        elif isinstance(b, wquant.QTensor):
            assert isinstance(a, wquant.QTensor) and a.mode == b.mode, keys
            assert torch.equal(a.q.view(torch.uint8), b.q.view(torch.uint8))
            assert torch.equal(a.scale, b.scale), keys
        else:
            assert not isinstance(a, wquant.QTensor), keys
            assert torch.equal(a, b), keys

    walk(got, want)
    layer = got["layers"][0]
    assert layer["mlp"]["w_down"].mode == "fp8_e4m3"
    assert layer["attn"]["wq"].mode == "int8"
    assert not isinstance(layer["norm1"]["scale"], wquant.QTensor)


# ------------------------------------------------------- quantized GEMM
@pytest.mark.parametrize("mode", MODES)
def test_epilogue_dot_matches_reference(mode):
    rng = np.random.default_rng(17)
    x = rng.standard_normal((5, 2, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) * 0.1).astype(np.float32)
    jt = jax.jit(lambda a: jquantize_weight(a, mode))(jnp.asarray(w))
    jqx, jsx = jax.jit(lambda a: jreg._quantize_rows(a, mode))(jnp.asarray(x))
    want = jax.jit(lambda *a: jqd.epilogue_dot(*a, mode, jnp.float32))(
        jqx, jsx, jt.q, jt.scale)
    tq, ts = registry._quantize_rows(torch.from_numpy(x), mode)
    got = epilogue_dot(tq, ts, to_torch(np.asarray(jt.q), "cpu"),
                       to_torch(np.asarray(jt.scale), "cpu"), mode, torch.float32)
    if mode == "int8":
        _same(got, want)
    else:
        g, wn = _np(got), _np(want)
        tol = 1e-5 * np.abs(wn).max(-1, keepdims=True)
        assert (np.abs(g - wn) <= tol).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [96, 256])
def test_quant_dot_spec_bind_matches_reference(n, mode):
    """The down-projection site, bound to a pre-quantized weight (serving)
    and to a raw weight (quantized on the fly), against the reference's
    unfused oracle; n = 96 is grouped (3 x 32), 256 a power of 2."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, 4, n)).astype(np.float32)
    w = (rng.standard_normal((n, 64)) * 0.1).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    jq = JQuantConfig(mode=mode, rotate="hadamard", backend="xla")
    jspec = JQuantDotSpec.for_config(n, jq)
    tspec = QuantDotSpec.for_config(n, QuantConfig(mode=mode, rotate="hadamard"))
    jt = jax.jit(lambda a: jquantize_weight(a, mode))(jnp.asarray(w))
    tt = wquant.QTensor(to_torch(np.asarray(jt.q), "cpu"),
                        to_torch(np.asarray(jt.scale), "cpu"), mode)
    want = jax.jit(lambda a: jspec.bind(jt, interpret=True)(a))(xj)
    got = tspec.bind(tt)(xt)
    assert got.shape == (3, 4, 64) and got.dtype == torch.bfloat16
    wn, g = _np(want), _np(got)
    if mode == "int8":
        np.testing.assert_array_equal(g, wn)
    else:   # f32 sums of exact fp8 products in another order, then bf16
        tol = 2.0 ** -7 * np.abs(wn).max(-1, keepdims=True)
        assert (np.abs(g - wn) <= tol).all()
    # raw weight: quantized on the fly, same contraction
    wb = w.astype(ml_dtypes.bfloat16)
    want_raw = _np(jax.jit(lambda a: jspec.bind(jnp.asarray(wb),
                                                interpret=True)(a))(xj))
    got_raw = _np(tspec.bind(to_torch(wb, "cpu"))(xt))
    tol = 2.0 ** -7 * np.abs(want_raw).max(-1, keepdims=True)
    assert (np.abs(got_raw - want_raw) <= tol).all()


def test_quant_dot_spec_rejects_wrong_storage_dtype():
    """A pre-quantized weight whose values are not stored in its mode's
    dtype never reaches a site."""
    with pytest.raises(ValueError, match="storage dtype"):
        wquant.QTensor(torch.zeros(32, 8, dtype=torch.int8), torch.ones(1, 8),
                       "fp8_e4m3")
    with pytest.raises(ValueError, match="unknown quantization mode"):
        QuantDotSpec(n=32, mode="int4")


def test_storage_only_qtensor_is_dequantized_not_requantized():
    """An int8-stored weight at a site that does not consume int8 natively
    runs the raw path on its dequantized values."""
    w = torch.from_numpy(_inputs((64, 16), seed=18, scale=0.1))
    qt = wquant.quantize_weight(w, "int8")
    x = torch.from_numpy(_inputs((2, 64), seed=19))
    spec = QuantDotSpec(n=64, mode="none", rotate=False)
    calls = wquant.QUANTIZE_WEIGHT_CALLS
    assert torch.equal(spec.bind(qt)(x), x @ qt.dequant(torch.float32))
    assert wquant.QUANTIZE_WEIGHT_CALLS == calls


def test_fused_dequant_dispatch_falls_back_for_grouped_and_per_tensor():
    """Grouped sizes and per-tensor scales never reach the K2 kernel: the
    dispatcher runs transform + plain epilogue (scales over the full row /
    the whole tensor), as the reference does."""
    x = torch.from_numpy(_inputs((4, 96), seed=20)).to(torch.bfloat16)
    xj = jnp.asarray(_inputs((4, 96), seed=20), jnp.bfloat16)
    for per_token in (True, False):
        epi = QuantEpilogue("fp8_e4m3", per_token=per_token, dequant=True)
        jepi = JQuantEpilogue("fp8_e4m3", per_token=per_token, dequant=True)
        _same(hadamard(x, epilogue=epi, backend="cuda"),
              jax.jit(lambda a: jhadamard(a, epilogue=jepi, backend="pallas",
                                          interpret=True))(xj))
    x = torch.from_numpy(_inputs((4, 128), seed=21)).to(torch.bfloat16)
    xj = jnp.asarray(_inputs((4, 128), seed=21), jnp.bfloat16)
    epi = QuantEpilogue("int8", per_token=False, dequant=True)
    _same(fused_dequant(x, plan_for(128, dtype=torch.bfloat16, device_type="cpu",
                                    epilogue=QuantEpilogue("int8", dequant=True))),
          jax.jit(lambda a: jhadamard(a, epilogue=JQuantEpilogue(
              "int8", dequant=True), backend="pallas", interpret=True))(xj))
    _same(hadamard(x, epilogue=epi),
          jax.jit(lambda a: jhadamard(a, epilogue=JQuantEpilogue(
              "int8", per_token=False, dequant=True), backend="xla"))(xj))


def test_quant_config_names_follow_the_port():
    assert {"cuda", "torch", "ref", "auto"} == set(QuantConfig._BACKENDS)
    assert dataclasses.replace(QuantConfig(), mode="int8").enabled
