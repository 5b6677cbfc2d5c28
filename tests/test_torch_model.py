"""PyTorch port, model stage: scaled-down llama3 (fp8_e4m3 + Hadamard +
fp8 KV cache + int8 weight storage) with the reference's own parameters
carried across by ``repro_torch.bridge``, against the un-meshed reference
``lm_prefill`` + ``lm_decode_step`` (backend ``pallas``, interpret mode,
jitted) on the CPU. The port runs its ``cuda`` backend, whose wrappers take
CPU tensors to the kernels' plain versions.

The reference is compiled as written (``xla_allow_excess_precision`` off):
by default XLA may drop the bf16 rounding between fused elementwise ops (it
keeps the residual sum that feeds the second norm in f32), which the port,
rounding every op, does not copy. Compiled so, the two agree bitwise layer
by layer; what remains are single bf16 flips where a matmul sums in another
order, which the fp8 steps of the Q/K sites amplify.

Tolerances: the layer-0 K cache agrees bitwise (projection, RoPE, the K2
site and the fp8 cast); free-running greedy decode gives the reference's
tokens at every one of 8 steps; logits at every step lie within
``LOGIT_TOL`` of the largest |logit| elementwise and within ``REL_TOL``
relative RMS. Over prompt seeds 0-11 (``python tests/test_torch_model.py``
prints them) the widest gaps read were 3.3% and 0.026 (seeds 7 and 5,
tested below beside seed 0, which agrees bitwise).
The port against itself: teacher-forced decode within 2% of the
full forward's largest |logit| unquantized and 10% with the fp8 KV cache
(the decode attends to the fp8-cast cache where the forward attends to the
bf16 fake-quantized K/V; a wrong cache row or mask is off by O(1)),
per-slot positions bitwise equal to a shared scalar position.
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
from repro.models import common as jcommon
from repro.models import init_lm as jinit_lm
from repro.models import lm_decode_step as jlm_decode_step
from repro.models import lm_prefill as jlm_prefill
from repro.models.lm import pad_kv_caches as jpad_kv_caches

from repro_torch.bridge import params_from_reference, to_torch
from repro_torch.configs import get_config
from repro_torch.core import wquant
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels.fused_quant import fused_dequant_cuda
from repro_torch.kernels.hadacore import hadacore_cuda
from repro_torch.models import common
from repro_torch.models.lm import (init_lm, lm_decode_step, lm_forward,
                                   lm_prefill, pad_kv_caches)

OVER = dict(d_model=512, num_heads=4, num_kv_heads=1, d_ff=384)
B, S, GEN, T = 2, 16, 8, 32
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


def _configs(quant=True):
    jq = JQuantConfig(mode="fp8_e4m3", rotate="hadamard", backend="pallas",
                      kv_quant=True) if quant else JQuantConfig()
    tq = QuantConfig(mode="fp8_e4m3", rotate="hadamard", backend="cuda",
                     kv_quant=True) if quant else QuantConfig()
    jcfg = jget_config("llama3_8b").scaled_down(**OVER).with_quant(jq)
    tcfg = get_config("llama3_8b").scaled_down(**OVER).with_quant(tq)
    if quant:
        jcfg = dataclasses.replace(jcfg, weight_quant="int8")
        tcfg = dataclasses.replace(tcfg, weight_quant="int8")
    return jcfg, tcfg


def _prompt(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _build_model():
    jcfg, tcfg = _configs()
    jp = jax.jit(lambda k: jquantize_lm_weights(jinit_lm(k, jcfg), jcfg))(
        jax.random.PRNGKey(0))
    params = params_from_reference(_np_tree(jp), device="cpu")
    return jcfg, tcfg, jp, params, _prompt(tcfg, 0)


@pytest.fixture(scope="module")
def model():
    return _build_model()


def _logits_close(got, want, vocab, frac):
    g = got.float().numpy()[..., :vocab]
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    w = np.asarray(want, np.float32)[..., :vocab]
    assert np.isfinite(g).all()
    assert np.abs(g - w).max() <= frac * np.abs(w).max(), np.abs(g - w).max()
    return g, w


# ------------------------------------------------------------ bridge
def test_bridge_carries_bits_and_layout(model):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    for dt in (ml_dtypes.bfloat16, ml_dtypes.float8_e4m3fn, ml_dtypes.float8_e5m2):
        v = a.astype(dt)
        t = to_torch(v, "cpu")
        assert t.element_size() == v.dtype.itemsize
        np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                      v.astype(np.float32))
    np.testing.assert_array_equal(to_torch(a, "cpu").numpy(), a)
    jcfg, tcfg, jp, params, _ = model
    assert len(params["layers"]) == tcfg.num_layers == jcfg.num_layers
    layer = params["layers"][1]
    ref_wq = jp["groups"][0]["p0"]["attn"]["wq"]
    assert isinstance(layer["attn"]["wq"], wquant.QTensor)
    np.testing.assert_array_equal(layer["attn"]["wq"].q.numpy(),
                                  np.asarray(ref_wq.q[1]))
    assert layer["mlp"]["w_down"].mode == "fp8_e4m3"
    assert layer["norm1"]["scale"].shape == (tcfg.d_model,)


# --------------------------------------------------- model against ref
def _greedy_run(model, toks):
    """Prefill, then 8 free-running greedy decode steps in each package
    (the layer-0 K cache checked bitwise). Returns, for each of the 9
    logits steps, (largest gap / largest |logit|, relative RMS gap, same
    greedy token)."""
    jcfg, tcfg, jp, params, _ = model
    V = tcfg.vocab_size
    jpre = jax.jit(lambda p, b: jlm_prefill(jcfg, p, b),
                   compiler_options=AS_WRITTEN)
    jdec = jax.jit(lambda p, c, t, pos: jlm_decode_step(jcfg, p, c, t, pos),
                   compiler_options=AS_WRITTEN)
    jl, jc = jpre(jp, {"tokens": jnp.asarray(toks)})
    jc = jpad_kv_caches(jcfg, jc, T)
    tl, tc = lm_prefill(tcfg, params, {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == (B, 1, tcfg.padded_vocab)
    # the first layer's K cache: projection, RoPE, K2 site, fp8 cast
    np.testing.assert_array_equal(
        tc[0]["k"].float().numpy(),
        np.asarray(jc[0]["p0"]["k"][0, :, :S].astype(jnp.float32)))
    tc = pad_kv_caches(tcfg, tc, T)
    steps = []
    for i in range(GEN + 1):
        g = tl[:, -1, :V].float().numpy()
        w = np.asarray(jl[:, -1, :V], np.float32)
        assert np.isfinite(g).all()
        jt = jnp.argmax(jl[:, -1, :V], -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1, :V], -1)[:, None]
        steps.append((np.abs(g - w).max() / np.abs(w).max(),
                      np.linalg.norm(g - w) / np.linalg.norm(w),
                      bool((tt.numpy() == np.asarray(jt)).all())))
        if i < GEN:
            jl, jc = jdec(jp, jc, jt, jnp.asarray(S + i, jnp.int32))
            tl, tc = lm_decode_step(tcfg, params, tc, tt, torch.tensor(S + i))
    return steps


def _greedy_against_reference(model, toks):
    for i, (gap, rel, same) in enumerate(_greedy_run(model, toks)):
        assert gap <= LOGIT_TOL and rel <= REL_TOL and same, (i, gap, rel, same)


def test_prefill_and_greedy_decode_match_reference(model):
    before = (hadacore_cuda.launches, fused_dequant_cuda.launches)
    _greedy_against_reference(model, model[4])
    # CPU tensors never launch a kernel
    assert (hadacore_cuda.launches, fused_dequant_cuda.launches) == before


@pytest.mark.parametrize("seed", [5, 7])
def test_greedy_decode_matches_reference_at_widest_gaps(model, seed):
    """The prompt seeds whose logits differed most from the reference's
    over seeds 0-11: the tokens still agree at every step."""
    _greedy_against_reference(model, _prompt(model[1], seed))


def test_padded_vocab_is_masked(model):
    jcfg, tcfg, jp, params, toks = model
    cfg = dataclasses.replace(tcfg, vocab_size=500)
    logits, _, _ = lm_forward(cfg, params, {"tokens": torch.from_numpy(toks[:, :4]).long()})
    assert torch.isinf(logits[..., 500:]).all() and torch.isfinite(logits[..., :500]).all()


# ------------------------------------------------ port against itself
@pytest.mark.parametrize("quant", [False, True])
def test_decode_matches_prefill_logits(model, quant):
    """Teacher-forced decode reproduces the full forward's next-token
    logits (the reference's test_decode_matches_prefill_logits)."""
    jcfg, tcfg, jp, params, toks = model
    if not quant:
        tcfg = _configs(quant=False)[1]
        params = init_lm(tcfg, seed=1, device="cpu")
    V = tcfg.vocab_size
    tokens = torch.from_numpy(toks).long()
    full, _, _ = lm_forward(tcfg, params, {"tokens": tokens})
    cut = S - 4
    logits, caches = lm_prefill(tcfg, params, {"tokens": tokens[:, :cut]})
    caches = pad_kv_caches(tcfg, caches, S + 4)
    frac = 0.1 if quant else 0.02
    _logits_close(logits[:, -1], full[:, cut - 1], V, frac)
    for i in range(4):
        logits, caches = lm_decode_step(tcfg, params, caches,
                                        tokens[:, cut + i][:, None],
                                        torch.tensor(cut + i))
        _logits_close(logits[:, -1], full[:, cut + i], V, frac)


def test_vector_positions_match_scalar(model):
    """A (B,) position vector of equal entries is bitwise the shared scalar
    position: logits and every cache row."""
    jcfg, tcfg, jp, params, toks = model
    tokens = torch.from_numpy(toks).long()
    logits, caches = lm_prefill(tcfg, params, {"tokens": tokens})
    tok = torch.argmax(logits[:, -1, :tcfg.vocab_size], -1)[:, None]
    a = pad_kv_caches(tcfg, caches, T)
    b = [{k: v.clone() for k, v in c.items()} for c in a]
    la, a = lm_decode_step(tcfg, params, a, tok, torch.tensor(S))
    lb, b = lm_decode_step(tcfg, params, b, tok, torch.full((B,), S))
    assert torch.equal(la, lb)
    for ca, cb in zip(a, b):
        for k in ("k", "v"):
            assert torch.equal(ca[k].view(torch.uint8), cb[k].view(torch.uint8))


# ----------------------------------------------------------- init, API
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """The CPU runs only when asked for by name: with no GPU, the default
    device raises instead of falling back quietly."""
    from repro_torch import resolve_device
    from repro_torch.serving import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_config("llama3_8b").scaled_down(), weight_quant="int8")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_torch(np.zeros(3, np.float32))
    params = init_lm(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params, num_slots=1, max_len=16, prefill_len=8)
    assert resolve_device("cpu").type == "cpu"


def test_init_lm_quantizes_layer_by_layer_and_is_seeded():
    _, tcfg = _configs()
    a = init_lm(tcfg, seed=3, device="cpu")
    b = init_lm(tcfg, seed=3, device="cpu")
    c = init_lm(tcfg, seed=4, device="cpu")
    assert isinstance(a["emb"], wquant.QTensor) and a["emb"].mode == "int8"
    lay = a["layers"][0]
    assert lay["mlp"]["w_down"].mode == "fp8_e4m3"
    assert lay["mlp"]["w_down"].q.dtype == torch.float8_e4m3fn
    assert all(lay["attn"][k].mode == "int8" for k in ("wq", "wk", "wv", "wo"))
    assert lay["norm1"]["scale"].dtype == torch.float32
    assert torch.equal(a["layers"][1]["attn"]["wq"].q, b["layers"][1]["attn"]["wq"].q)
    assert not torch.equal(a["layers"][1]["attn"]["wq"].q, c["layers"][1]["attn"]["wq"].q)
    logits, _, _ = lm_forward(tcfg, a, {"tokens": torch.zeros(1, 4, dtype=torch.long)})
    assert torch.isfinite(logits[..., :tcfg.vocab_size]).all()


def test_pad_kv_caches_grows_seq_only(model):
    jcfg, tcfg, jp, params, toks = model
    _, caches = lm_prefill(tcfg, params, {"tokens": torch.from_numpy(toks).long()})
    grown = pad_kv_caches(tcfg, caches, T)
    assert grown[0]["k"].shape == (B, T, tcfg.num_kv_heads, tcfg.head_dim)
    assert grown[0]["k"].dtype == torch.float8_e4m3fn
    assert torch.equal(grown[1]["v"][:, :S].view(torch.uint8),
                       caches[1]["v"].view(torch.uint8))
    assert not grown[1]["v"][:, S:].float().any()


def test_common_blocks_match_reference():
    """Norms in f32 and RoPE: within 2 ulps of the io dtype (f32 transcen-
    dentals differ in the last bit between XLA and torch)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    got = common.apply_norm(get_config("llama3_8b"),
                            {"scale": torch.from_numpy(p["scale"])},
                            torch.from_numpy(x)).numpy()
    want = np.asarray(jcommon.apply_norm(jget_config("llama3_8b"), p,
                                         jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2 * 2.0 ** -23, atol=1e-6)
    fr = common.rope_freqs(128, 500000.0).numpy()
    np.testing.assert_allclose(fr, np.asarray(jcommon.rope_freqs(128, 500000.0)),
                               rtol=2 * 2.0 ** -23)
    q = rng.standard_normal((2, 5, 4, 128)).astype(np.float32)
    ang = (np.arange(5, dtype=np.float32)[None, :, None] * fr[None, None]).repeat(2, 0)
    got = common.apply_rope_angles(torch.from_numpy(q).to(torch.bfloat16),
                                   torch.from_numpy(ang)).float().numpy()
    want = np.asarray(jcommon.apply_rope_angles(jnp.asarray(q, jnp.bfloat16),
                                                jnp.asarray(ang)).astype(jnp.float32))
    assert np.abs(got - want).max() <= 2 * 2.0 ** -7 * np.abs(want).max()


if __name__ == "__main__":
    # The readings behind LOGIT_TOL and REL_TOL, over prompt seeds 0-11:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_model.py
    m = _build_model()
    for seed in range(12):
        steps = _greedy_run(m, _prompt(m[1], seed))
        print(f"seed {seed:2d}: largest gap {max(x[0] for x in steps):.4f} of "
              f"max |logit|, relative RMS {max(x[1] for x in steps):.4f}, "
              f"same greedy token at every step: {all(x[2] for x in steps)}")
