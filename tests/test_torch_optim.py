"""PyTorch port, optimizer: ``repro_torch.optim`` (AdamW, blockwise-int8
state, error-feedback int8 compression, the warmup + cosine schedule)
against ``repro.optim`` on the same parameters and gradients (numpy,
seeded), the reference compiled (``jax.jit``, as a train step runs it).

The two packages sum the global gradient norm in other orders (XLA's
reduction against torch's), so the clipping scale, and with it every
update, can differ in its last f32 bits. Tolerances, each over the
measured worst of the tests below (readings in brackets): learning rate
within 1 f32 ulp [1 ulp]; global norm 2e-6 relative [7.3e-7]; bf16
parameters within 2 ulps in at most 0.1% of the elements [2 ulps in 0.010%,
1 ulp in 0.049%]; f32 parameters 1e-7 relative L2 [1.4e-8]; f32 moments
1e-5 [7.2e-6]; error-feedback residuals 5e-5 [1.3e-5: a residual is the
small difference x - Q(x)]; int8 moment codes within 1 in at most 0.1%
[1 in 0.012%], their scales 1e-5. The schedule's f32 arithmetic and the
int8 state's quantization are held bitwise where their inputs are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import qstate as jqstate

from repro_torch import tree as T
from repro_torch.bridge import to_torch
from repro_torch.optim import adamw, qstate

CFG = adamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=6)


def _jcfg(cfg):
    return jadamw.OptConfig(**dataclasses.asdict(cfg))


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"emb": rng.standard_normal((64, 32)).astype(ml_dtypes.bfloat16),
            "layers": [{"w": (rng.standard_normal((32, 300)) * 0.1).astype(ml_dtypes.bfloat16),
                        "scale": rng.standard_normal((32,)).astype(np.float32)}
                       for _ in range(2)]}


def _grads(seed, params):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.5).astype(p.dtype),
                        params)


def _torch(tree):
    return T.tree_map(lambda a: to_torch(a, "cpu"), tree)


def _np(t):
    t = t.detach()
    return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _ulps_bf16(a, b):
    a = np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).view(np.int16).astype(np.int64)
    b = np.asarray(b, np.float32).astype(ml_dtypes.bfloat16).view(np.int16).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 6, 9])
def test_schedule_matches_reference(step):
    """Linear warmup then cosine to 10% of lr (past the end: the floor)."""
    want = float(jax.jit(lambda s: jadamw.schedule(_jcfg(CFG), s))(jnp.int32(step)))
    got = float(adamw.schedule(CFG, torch.tensor(step, dtype=torch.int32)))
    assert abs(got - want) <= np.spacing(np.float32(want))


def _run(cfg, steps=3):
    jp = jax.tree.map(jnp.asarray, _params(0))
    jstate = jax.jit(lambda p: jadamw.init_opt_state(p, _jcfg(cfg)))(jp)
    tp = _torch(_params(0))
    tstate = adamw.init_opt_state(tp, cfg)
    jstep = jax.jit(lambda p, g, s: jadamw.apply_updates(p, g, s, _jcfg(cfg)))
    for k in range(steps):
        g = _grads(10 + k, _params(0))
        jp, jstate, jm = jstep(jp, jax.tree.map(jnp.asarray, g), jstate)
        tp, tstate, tm = adamw.apply_updates(tp, _torch(g), tstate, cfg)
        assert abs(float(tm["gnorm"]) - float(jm["gnorm"])) <= 2e-6 * float(jm["gnorm"])
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= np.spacing(np.float32(jm["lr"]))
    return jp, jstate, tp, tstate


def _check_params(jp, tp):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jp)[0], T.leaves(tp)):
        w = np.asarray(w.astype(jnp.float32)) if w.dtype == jnp.bfloat16 else np.asarray(w)
        if g.dtype == torch.bfloat16:
            ulps = _ulps_bf16(_np(g), w)
            assert ulps.max() <= 2 and (ulps > 0).mean() <= 1e-3, (path, ulps.max())
        else:
            assert np.linalg.norm(_np(g) - w) <= 1e-7 * np.linalg.norm(w), path


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_adamw_f32_state_matches_reference():
    """Three steps with f32 moments (decay on matrices only, clipping at
    norm 1: the gradients' norm is ~8, so every step clips)."""
    jp, jstate, tp, tstate = _run(CFG)
    _check_params(jp, tp)
    for key in ("m", "v"):
        for w, g in zip(jax.tree.leaves(jstate[key]), T.leaves(tstate[key])):
            assert _rel(_np(g), w) <= 1e-5
    assert int(tstate["step"]) == int(jstate["step"]) == 3


def test_adamw_int8_state_matches_reference():
    """Three steps with blockwise-int8 moments (blocks of 256 along the last
    axis: the 300-wide matrices pad to 512)."""
    cfg = dataclasses.replace(CFG, state_dtype="int8")
    jp, jstate, tp, tstate = _run(cfg)
    _check_params(jp, tp)
    for key in ("m", "v"):
        jl = jax.tree.leaves(jstate[key])
        tl = T.leaves(tstate[key])
        assert len(jl) == len(tl)
        for w, g in zip(jl, tl):
            if g.dtype == torch.int8:
                diff = np.abs(_np(g).astype(np.int32) - np.asarray(w, np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
            else:
                assert _rel(_np(g), w) <= 1e-5


def test_adamw_int8_ef_compression_matches_reference():
    """Error-feedback int8 gradient compression: the quantized gradients and
    the carried residuals, inside three AdamW steps."""
    cfg = dataclasses.replace(CFG, grad_compression="int8_ef")
    jp, jstate, tp, tstate = _run(cfg)
    _check_params(jp, tp)
    for w, g in zip(jax.tree.leaves(jstate["ef"]), T.leaves(tstate["ef"])):
        assert _rel(_np(g), w) <= 5e-5
    g = _grads(3, _params(0))
    want = jax.jit(jadamw.compress_grads)(jax.tree.map(jnp.asarray, g), jstate["ef"])
    got = adamw.compress_grads(_torch(g), tstate["ef"])
    for part in range(2):
        for w, t in zip(jax.tree.leaves(want[part]), T.leaves(got[part])):
            assert _rel(_np(t), w) <= 5e-5


@pytest.mark.parametrize("shape", [(3, 300), (2, 4, 256), (17,)])
def test_qstate_round_trip_matches_reference(shape):
    """quantize_state / dequantize_state: codes and scales bitwise, the
    round trip equal."""
    x = (np.random.default_rng(7).standard_normal(shape) * 1e-3).astype(np.float32)
    jq = jax.jit(jqstate.quantize_state)(jnp.asarray(x))
    tq = qstate.quantize_state(torch.from_numpy(x))
    assert np.array_equal(_np(tq["q"]), np.asarray(jq["q"]))
    assert np.array_equal(_np(tq["s"]), np.asarray(jq["s"]))
    back = qstate.dequantize_state(tq, shape)
    want = jax.jit(lambda t: jqstate.dequantize_state(t, shape))(jq)
    assert np.array_equal(_np(back), np.asarray(want))
    z = qstate.zeros_like_qstate(torch.zeros(shape))
    assert not z["q"].any() and qstate.is_qstate(z)
