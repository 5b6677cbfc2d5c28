"""PyTorch port, a gradient outlier without a mesh, settled: phi4-mini
scaled to d_model 256 (8 / 4 heads of 64, d_ff 512, int8 + Hadamard, 2
layers, vocabulary 512), whose layer-1 ``attn.wv`` step-0 gradient reads
0.163 relative L2 from ``jax.grad`` of the reference's ``lm_loss`` where
every other leaf reads at most 0.065 and d_model 384 / 512 read 0.009 /
0.015 (``tests/test_torch_tensor_parallel.py``'s scale).

The cause is a divergence of rounding, not a fault of the port:

  * the V site fake-quantizes without a straight-through estimator, as the
    reference writes it: ``round`` has no gradient, so a row's gradient
    reaches only its absmax entry, through the scale, as ``sum_j g_j q_j /
    127`` over the row's int8 grid values ``q_j`` (both packages, here
    equal to f32 rounding);
  * in bf16, layer 1's V input differs from the reference's in 2660 of its
    8192 values (bf16 flips born upstream; layer 0's differs in 1), and
    1258 of its int8 grid values differ: the sums above move with them;
  * fed the reference's own V values at the V sites (forward only; the
    port's gradient machinery unchanged), the port reads 0.0137 on that
    leaf and at most 0.0156 on every leaf, within ``GRAD_TOL``; in f32
    every leaf reads at most 1.3e-6;
  * the witness, a correct path that differs only in rounding: the
    reference itself compiled with XLA's excess precision (its default,
    f32 intermediates kept) reads 0.058 on that leaf from the reference as
    written -- beyond ``GRAD_TOL``, and its largest leaf.

Readings printed by ``python tests/test_torch_v_site_gradient.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.core.quant import QuantConfig as JQuantConfig
from repro.core.quant import quantize as jquantize
from repro.data import SyntheticDataset as JSyntheticDataset
from repro.launch.shapes import ShapeSpec as JShapeSpec
from repro.models import attention as jattn
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss

from repro_torch import tree as T
from repro_torch.bridge import params_from_reference

SHAPE = dict(d_model=256, num_heads=8, num_kv_heads=4, head_dim=64, d_ff=512)
B, S = 2, 16
GRAD_TOL, F32_TOL = 0.03, 1e-5
LEAF = "['layers'][1]['attn']['wv']"
AS_WRITTEN = {"xla_allow_excess_precision": False}


def _configs(dtype: str):
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig

    kw = dict(SHAPE, dtype=dtype)
    jcfg = jget_config("phi4_mini_3_8b").scaled_down(**kw).with_quant(
        JQuantConfig(mode="int8", rotate="hadamard", backend="xla", kv_quant=True))
    tcfg = get_config("phi4-mini-3.8b").scaled_down(**kw).with_quant(
        QuantConfig(mode="int8", rotate="hadamard", backend="cuda", kv_quant=True))
    return jcfg, tcfg


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _rel(got, want) -> float:
    got, want = _f64(got), _f64(want)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else float(np.abs(got).max())


def _grid(v: np.ndarray) -> np.ndarray:
    """The int8 grid values of the V site's per-row quantize."""
    s = np.maximum(np.abs(v).max(-1, keepdims=True), 1e-8) * np.float32(1 / 127)
    return np.clip(np.round(v / s), -127, 127)


def _reference_grads(jcfg, jp, batch, options):
    g = jax.jit(jax.grad(lambda p, b: jlm_loss(jcfg, p, b)[0]), compiler_options=options)(
        jp, batch)
    return [_f64(t) for t in T.leaves(params_from_reference(_np_tree(g), "cpu"))]


def _reference_v(jcfg, jp, batch):
    """The V site's inputs of the reference's forward, in layer order (f32)."""
    seen, real = [], jattn._v_spec

    def spy(cfg, hd):
        spec = real(cfg, hd)

        def site(v):
            jax.debug.callback(lambda a: seen.append(np.asarray(a)), v.astype(jnp.float32))
            return spec(v)

        return site

    jattn._v_spec = spy
    try:
        jax.jit(lambda p, b: jlm_loss(jcfg, p, b)[0], compiler_options=AS_WRITTEN)(
            jp, batch).block_until_ready()
    finally:
        jattn._v_spec = real
    return seen


def _port_grads(tcfg, params, batch, feed=None):
    """The port's step-0 gradients; ``feed``: the V inputs to use in the
    forward, in layer order (the gradient flows to the port's own V)."""
    from repro_torch.launch.steps import batch_to
    from repro_torch.models import attention as A
    from repro_torch.models.lm import lm_loss

    params = T.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    seen, real = [], A._v_spec
    calls = []

    def spy(cfg, hd):
        spec = real(cfg, hd)

        def site(v):
            # the forward runs layers 0, 1; remat recomputes 1, 0 in the backward
            i = len(calls) if len(calls) < tcfg.num_layers else 2 * tcfg.num_layers - 1 - len(calls)
            calls.append(i)
            if len(seen) < tcfg.num_layers:
                seen.append(v.detach().float().numpy())
            if feed is not None:
                v = v + (torch.tensor(feed[i]).to(v.dtype) - v).detach()
            return spec(v)

        return site

    flat = T.leaves(params)
    A._v_spec = spy
    try:
        g = torch.autograd.grad(lm_loss(tcfg, params, batch_to(batch, "cpu"))[0], flat)
    finally:
        A._v_spec = real
    return [_f64(t) for t in g], seen


def _all_runs():
    from repro_torch.models.lm import init_lm

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for dtype in ("float32", "bfloat16"):
            jcfg, tcfg = _configs(dtype)
            jp = jax.jit(lambda k: jinit_lm(k, jcfg))(jax.random.PRNGKey(0))
            port = params_from_reference(_np_tree(jp), "cpu")
            batch = JSyntheticDataset(jcfg, JShapeSpec("v", "train", S, B), seed=0).batch(0)
            r = {"ref": _reference_grads(jcfg, jp, batch, AS_WRITTEN)}
            r["port"], r["port_v"] = _port_grads(tcfg, port, batch)
            if dtype == "bfloat16":
                r["witness"] = _reference_grads(jcfg, jp, batch, {})
                r["ref_v"] = _reference_v(jcfg, jp, batch)
                r["fed"], _ = _port_grads(tcfg, port, batch, feed=r["ref_v"])
            out[dtype] = r
        out["paths"] = [k for k, _ in T.leaves_with_paths(init_lm(tcfg, device="meta"))]
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    return _all_runs()


def _leaf(runs, key, dtype="bfloat16", against="ref"):
    i = runs["paths"].index(LEAF)
    r = runs[dtype]
    return _rel(r[key][i], r[against][i])


def test_v_site_gradient_reaches_only_each_rows_absmax():
    """Both packages' V-site quantize (int8, per token) pass a row's
    gradient to its absmax entry alone, the same value up to f32
    rounding: ``round`` has no gradient, only the scale does."""
    from repro_torch.core.quant import quantize

    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    g = rng.standard_normal((8, 64)).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: (jquantize(a, "int8") * g).sum())(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    got, = torch.autograd.grad((quantize(t, "int8") * torch.from_numpy(g)).sum(), t)
    got = got.numpy()
    absmax = np.abs(x).argmax(-1)
    for row in range(8):
        assert np.flatnonzero(got[row]).tolist() == [absmax[row]]
        assert np.flatnonzero(want[row]).tolist() == [absmax[row]]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_wv_outlier_is_born_in_the_v_values_rounding(runs):
    """At d_model 256 layer 1's ``wv`` gradient reads beyond GRAD_TOL in
    bf16, every leaf within F32_TOL in f32; layer 1's V input and its int8
    grid values differ from the reference's where layer 0's V input is
    nearly equal; fed the reference's V values, the port's every leaf is
    within GRAD_TOL of the reference's."""
    f32 = runs["float32"]
    assert max(_rel(a, b) for a, b in zip(f32["port"], f32["ref"])) <= F32_TOL
    assert _leaf(runs, "port") > GRAD_TOL
    r = runs["bfloat16"]
    v0, v1 = (np.not_equal(a, b).sum() for a, b in zip(r["port_v"], r["ref_v"]))
    assert v0 <= 8 and v1 > 1000
    assert np.not_equal(_grid(r["port_v"][1]), _grid(r["ref_v"][1])).sum() > 500
    assert max(_rel(a, b) for a, b in zip(r["fed"], r["ref"])) <= GRAD_TOL


def test_witness_reference_with_excess_precision_parts_on_the_same_leaf(runs):
    """The witness: the reference compiled with excess precision, a path
    that differs from it only in rounding, reads beyond GRAD_TOL on the
    same leaf, and that leaf is its largest."""
    r = runs["bfloat16"]
    assert _leaf(runs, "witness") > GRAD_TOL
    rels = [_rel(a, b) for a, b in zip(r["witness"], r["ref"])]
    assert runs["paths"][int(np.argmax(rels))] == LEAF


if __name__ == "__main__":
    runs_ = _all_runs()
    r = runs_["bfloat16"]
    print("bf16 port", _leaf(runs_, "port"), "fed", _leaf(runs_, "fed"), "witness",
          _leaf(runs_, "witness"), "max fed", max(_rel(a, b) for a, b in zip(r["fed"], r["ref"])))
    print("f32 max", max(_rel(a, b) for a, b in zip(runs_["float32"]["port"],
                                                    runs_["float32"]["ref"])))
    print("V differing", [int(np.not_equal(a, b).sum()) for a, b in zip(r["port_v"], r["ref_v"])],
          "grid differing", [int(np.not_equal(_grid(a), _grid(b)).sum())
                             for a, b in zip(r["port_v"], r["ref_v"])])
