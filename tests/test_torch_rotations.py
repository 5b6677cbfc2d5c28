"""PyTorch port, ``core/rotations.py`` and the ``kernels/ops.py`` shim,
against ``repro.core.rotations`` and ``repro.kernels.ops`` on the CPU (the
port's ``cuda`` and ``auto`` backends take CPU tensors to the kernels'
plain versions; the reference runs its ``xla`` backend, jitted where it
quantizes, since XLA compiles ``x / qmax`` into ``x * f32(1 / qmax)`` and
the port mirrors the compiled form).

* ``rotation_matrix``: the reference's randomized Hadamard bitwise, its
  Rademacher signs handed in (the two random streams differ); grouped for
  sizes that are not powers of 2.
* ``fuse_down_proj_rotations`` on the reference's own parameters carried
  across by ``repro_torch.bridge`` (scaled-down llama3-8b, d_ff 96 = 3 x 32,
  and llama4-maverick with its expert stack and shared expert): every
  ``w_down`` within one bf16 ulp of the reference's (both rotate in f32
  and round once; the matmuls sum in other orders), in at most 1% of the
  elements; every other leaf untouched.
* ``online_hadamard`` bitwise; the deprecated shims bitwise in int8, each
  warning once and ticking ``TRACE_COUNTS[("deprecated", name)]`` on every
  call.
* The offline-fusion checks of ``tests/test_archs.py:58-88`` through both
  packages at the reference's scaled-down size: without quantization the
  fused, rotated model's loss equals the unrotated one's within 2e-2 (the
  reference's bound); with int8 + Hadamard + int8 KV within 0.15 (int8
  only: the reference's fp8 einsum fails on XLA CPU). Each port loss is
  also held to the reference's own within ``LOSS_TOL`` (read: the
  unrotated and the int8 losses equal, the unquantized fused one 9.6e-5
  apart; the fused losses 2.2e-4 / 2.6e-3 from the unrotated ones).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import rotations as JR
from repro.core.quant import QuantConfig as JQuantConfig
from repro.kernels import ops as jops
from repro.launch.shapes import ShapeSpec as JShapeSpec
from repro.launch.shapes import make_batch as jmake_batch
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss

from repro_torch import tree as T
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.core import rotations as R
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops, registry
from repro_torch.launch.steps import batch_to
from repro_torch.models.lm import lm_loss

AS_WRITTEN = {"xla_allow_excess_precision": False}
LOSS_TOL = 2e-3      # port loss against the reference's, same params and config
BF16_ULP = 2.0 ** -7


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bf16_close(got: torch.Tensor, want: np.ndarray, frac: float = 0.01):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    diff = np.abs(g - w)
    assert (diff <= BF16_ULP * np.abs(w) + 1e-30).all(), diff.max()
    assert (diff > 0).mean() <= frac, (diff > 0).mean()


@pytest.mark.parametrize("n", [64, 96, 2048])
def test_rotation_matrix_matches_reference(n):
    key = jax.random.PRNGKey(n)
    signs = np.array(jax.random.rademacher(key, (n,), dtype=jnp.float32))
    want = np.asarray(JR.rotation_matrix(n, key))
    got = R.rotation_matrix(n, signs=torch.from_numpy(signs))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(R.rotation_matrix(n).numpy(),
                                  np.asarray(JR.rotation_matrix(n)))
    q = R.rotation_matrix(n, torch.Generator().manual_seed(0)).double()
    np.testing.assert_allclose((q @ q.T).numpy(), np.eye(n), atol=1e-6)


def test_fuse_rotation_helpers_match_reference():
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((4, 64), np.float32), rng.standard_normal((64, 32), np.float32)
    ws = rng.standard_normal((2, 64, 32), np.float32)
    q = np.array(JR.rotation_matrix(64, jax.random.PRNGKey(1)))
    tq = torch.from_numpy(q)
    np.testing.assert_allclose(R.rotate_activation_in(torch.from_numpy(x), tq).numpy(),
                               np.asarray(JR.rotate_activation_in(x, q)), rtol=1e-5, atol=1e-5)
    assert R.rotate_activation_in(torch.from_numpy(x), None) is not None
    np.testing.assert_allclose(R.fuse_rotation_rhs(torch.from_numpy(w.T.copy()), tq).numpy(),
                               np.asarray(JR.fuse_rotation_rhs(w.T, q)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(R.fuse_rotation_lhs(torch.from_numpy(ws), tq).numpy(),
                               np.asarray(JR.fuse_rotation_lhs(ws, q)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["llama3_8b", "llama4_maverick_400b_a17b"])
def test_fuse_down_proj_rotations_on_bridged_params(arch):
    jcfg = jget_config(arch).scaled_down()
    jp = jax.jit(lambda k: jinit_lm(k, jcfg))(jax.random.PRNGKey(2))
    want = params_from_reference(_np(jax.jit(JR.fuse_down_proj_rotations)(jp)), "cpu")
    tp = params_from_reference(_np(jp), "cpu")
    got = R.fuse_down_proj_rotations(tp)
    fused = 0
    for (path, g), (_, w), (_, o) in zip(T.leaves_with_paths(got),
                                         T.leaves_with_paths(want),
                                         T.leaves_with_paths(tp)):
        if path.endswith("['w_down']"):
            fused += 1
            assert g.dtype == o.dtype and g.shape == o.shape
            _bf16_close(g, w.float().numpy())
            assert not torch.equal(g, o)
        else:
            assert g is o, path
    cfg = get_config(arch).scaled_down()
    # one w_down per dense MLP; a MoE layer's expert stack and shared expert
    assert fused == sum(1 + (k == "moe" and cfg.moe_shared_expert) for k in cfg.layer_kinds)


def test_online_hadamard_matches_reference():
    x = np.random.default_rng(3).standard_normal((5, 96)).astype(np.float32)
    for jb, tb in (("xla", "auto"), ("xla", "cuda")):
        jc = JQuantConfig(mode="int8", rotate="hadamard", backend=jb)
        tc = QuantConfig(mode="int8", rotate="hadamard", backend=tb)
        want = np.asarray(jax.jit(lambda a: JR.online_hadamard(a, jc))(x))
        got = R.online_hadamard(torch.from_numpy(x), tc).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    same = torch.from_numpy(x)
    assert R.online_hadamard(same, QuantConfig(mode="int8")) is same


def _ticks(name):
    return registry.TRACE_COUNTS[("deprecated", name)]


def _warned_once(name, fn):
    registry.WARN_ONCE_SEEN.discard(("deprecated", name))
    t0 = _ticks(name)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
        fn()
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1, [str(w.message) for w in dep]
    assert _ticks(name) - t0 == 2
    return out


def test_deprecated_shims_match_reference_warn_once_and_tick():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, 64)) * 3).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    we = rng.standard_normal((2, 64, 48)).astype(np.float32)
    xe = rng.standard_normal((1, 2, 3, 64)).astype(np.float32)
    jc = JQuantConfig(mode="int8", rotate="hadamard", backend="xla", kv_quant=True)
    tc = QuantConfig(mode="int8", rotate="hadamard", backend="cuda", kv_quant=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cases = [
            ("online_hadamard_quantize", lambda a: JR.online_hadamard_quantize(a, jc),
             lambda: R.online_hadamard_quantize(torch.from_numpy(x), tc), x),
            ("rotated_quant_dot", lambda a: JR.rotated_quant_dot(a, w, jc),
             lambda: R.rotated_quant_dot(torch.from_numpy(x), torch.from_numpy(w), tc), x),
            ("rotated_quant_dot_experts", lambda a: JR.rotated_quant_dot_experts(a, we, jc),
             lambda: R.rotated_quant_dot_experts(torch.from_numpy(xe), torch.from_numpy(we),
                                                 tc), xe),
        ]
        wants = [np.asarray(jax.jit(f)(a)) for _, f, _, a in cases]
    for (name, _, port, _), want in zip(cases, wants):
        got = _warned_once(name, port)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_ops_hadamard_shim():
    x = np.random.default_rng(5).standard_normal((3, 128)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(jax.jit(lambda a: jops.hadamard(a, backend="xla"))(x))
    got = _warned_once("kernels.ops.hadamard", lambda: ops.hadamard(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    assert ops.WARN_KEY == jops.WARN_KEY
    with pytest.raises(ValueError, match="power of 2"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ops.hadamard(torch.zeros(2, 96))


def _losses(quant):
    """Unrotated loss and fused + rotated loss, reference and port, on the
    reference's scaled-down llama3-8b (PRNGKey(2), its smoke batch)."""
    jcfg0, tcfg0 = jget_config("llama3_8b").scaled_down(), \
        get_config("llama3_8b").scaled_down()
    jq, tq = quant
    jcfg, tcfg = jcfg0.with_quant(jq), tcfg0.with_quant(tq)
    batch = jmake_batch(jcfg0, JShapeSpec("smoke", "train", 32, 2))
    jp = jax.jit(lambda k: jinit_lm(k, jcfg0))(jax.random.PRNGKey(2))
    jloss = jax.jit(lambda c, p: jlm_loss(c, p, batch)[0], static_argnums=0,
                    compiler_options=AS_WRITTEN)
    ref0, ref1 = float(jloss(jcfg0, jp)), float(jloss(jcfg, JR.fuse_down_proj_rotations(jp)))
    tp = params_from_reference(_np(jp), "cpu")
    tb = batch_to(batch, "cpu")
    with torch.no_grad():
        port0 = float(lm_loss(tcfg0, tp, tb)[0])
        port1 = float(lm_loss(tcfg, R.fuse_down_proj_rotations(tp), tb)[0])
    return ref0, ref1, port0, port1


def test_offline_fusion_exact_without_quant():
    ref0, ref1, port0, port1 = _losses((
        JQuantConfig(mode="none", rotate="hadamard", backend="xla"),
        QuantConfig(mode="none", rotate="hadamard", backend="cuda")))
    assert abs(ref0 - ref1) < 2e-2 and abs(port0 - port1) < 2e-2, (ref0, ref1, port0, port1)
    assert abs(port0 - ref0) <= LOSS_TOL and abs(port1 - ref1) <= LOSS_TOL, \
        (ref0, ref1, port0, port1)


def test_offline_fusion_with_int8_rotation_quant():
    ref0, ref1, port0, port1 = _losses((
        JQuantConfig(mode="int8", rotate="hadamard", backend="xla", kv_quant=True),
        QuantConfig(mode="int8", rotate="hadamard", backend="cuda", kv_quant=True)))
    assert np.isfinite(port1)
    assert abs(ref0 - ref1) < 0.15 and abs(port0 - port1) < 0.15, (ref0, ref1, port0, port1)
    assert abs(port0 - ref0) <= LOSS_TOL and abs(port1 - ref1) <= LOSS_TOL, \
        (ref0, ref1, port0, port1)
