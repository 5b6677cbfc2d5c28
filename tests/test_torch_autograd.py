"""PyTorch port, gradients: the nine ``torch.autograd.Function``s of
``repro_torch.core.api`` against ``jax.vjp`` of the reference's
``custom_vjp``s on the same inputs and cotangents (numpy, seeded), on the
CPU: the reference on its ``xla`` backend (the ABFT expert form, which only
the fused kernel hosts, on ``pallas`` in interpret mode, with
``pltpu.TPUCompilerParams`` aliased inside that test only), the port on its
plain versions (``torch`` backend).

Both sides compute the same operations; the straight-through backward of
the quant_dot forms contracts ``g @ W^T`` (and ``rotate(x)^T g``) in f32,
which XLA and torch may sum in other orders. The reference runs compiled
(``jax.jit``: XLA turns its divisions by constants into the products the
port writes). Tolerance: relative L2 <= ``TOL`` = 1e-6 for every output and
gradient, int8 forwards bitwise, fp8 forwards within 2^-7. Measured: every
output and gradient bitwise except one f32 gradient at 5.8e-8. int8's
``(q, s)`` form gives x a zero gradient, as the reference's float0
cotangent does.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.api import QuantEpilogue as JQuantEpilogue
from repro.core.api import plan_for as jplan_for
from repro.core.wquant import quantize_weight as jquantize_weight

from repro_torch.bridge import to_torch
from repro_torch.core import api
from repro_torch.core.api import QuantEpilogue, plan_for
from repro_torch.core.wquant import quantize_weight
from repro_torch.kernels.hadacore import hadacore

DT = {"float32": (torch.float32, jnp.float32, np.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16, ml_dtypes.bfloat16)}
TOL = 1e-6


def _rel(got: torch.Tensor, want) -> float:
    g = got.detach().to(torch.float32).numpy().astype(np.float64)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32)).astype(np.float64)
    assert g.shape == w.shape
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _arr(shape, seed, dt, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32).astype(DT[dt][2])


def _plans(n, dt, epi=None, jbackend="xla"):
    tdt, jdt, _ = DT[dt]
    return (plan_for(n, dtype=tdt, backend="torch", device_type="cpu", epilogue=epi),
            jplan_for(n, dtype=jdt, backend=jbackend,
                      epilogue=None if epi is None else JQuantEpilogue(
                          epi.mode, per_token=epi.per_token, dequant=epi.dequant)))


def _grad(out, inputs, cot):
    return torch.autograd.grad(out, inputs, grad_outputs=cot)


def _ref_vjp(fn, primals, cot):
    """(y, cotangents of every primal) of the reference, compiled: XLA
    rewrites its divisions by constants as the port's products do."""
    def run(primals, cot):
        y, vjp = jax.vjp(fn, *primals)
        return y, vjp(cot)

    return jax.jit(run)(tuple(jnp.asarray(p) for p in primals), jnp.asarray(cot))


# ------------------------------------------------------- transform family
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [128, 96])
def test_transform_is_self_adjoint_like_the_reference(n, dt):
    """``_Transform`` (pow2 and a grouped 96 = 3 x 32) against ``_transform``:
    forward and x-gradient (the transform of the cotangent)."""
    x, g = _arr((6, n), 0, dt), _arr((6, n), 1, dt)
    plan, jplan = _plans(n, dt)
    y, (want,) = _ref_vjp(lambda a: japi._transform(a, jplan, True), (x,), g)
    xt = to_torch(x, "cpu").requires_grad_(True)
    got_y = api.hadamard(xt, plan)
    (got,) = _grad(got_y, xt, to_torch(g, "cpu"))
    assert _rel(got_y, y) <= TOL and _rel(got, want) <= TOL


def test_hadacore_is_differentiable_and_in_place_refuses_grad():
    """The kernel entry point's out-of-place form differentiates through the
    transform; the in-place form raises on a tensor that requires grad and
    still works on one that does not."""
    x = torch.randn(3, 64)
    xg = x.clone().requires_grad_(True)
    y = hadacore(xg)
    (gx,) = torch.autograd.grad(y, xg, grad_outputs=torch.ones_like(y))
    assert torch.allclose(gx, hadacore(torch.ones(3, 64)), atol=1e-6)
    with pytest.raises(ValueError, match="requires grad"):
        hadacore(xg, in_place=True)
    z = x.clone()
    assert torch.equal(hadacore(z, in_place=True), y.detach()) and torch.equal(z, y.detach())


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_fused_dequant_straight_through(mode):
    """``_FusedDequant`` (K2's form) against ``_fused_dequant``: the forward
    fake-quantized rotation, and the gradient = the plain rotation of g."""
    x, g = _arr((5, 128), 2, "bfloat16", 3.0), _arr((5, 128), 3, "bfloat16")
    plan, jplan = _plans(128, "bfloat16", QuantEpilogue(mode, dequant=True))
    y, (want,) = _ref_vjp(lambda a: japi._fused_dequant(a, jplan, True), (x,), g)
    xt = to_torch(x, "cpu").requires_grad_(True)
    got_y = api.hadamard(xt, plan)
    (got,) = _grad(got_y, xt, to_torch(g, "cpu"))
    assert _rel(got_y, y) == 0.0 and _rel(got, want) == 0.0


def test_fused_int8_has_zero_cotangent():
    """The (q, s) form: int8 q carries no gradient (the reference's float0
    cotangent) and the scales' cotangent is dropped, so x gets zeros of its
    dtype -- from a cotangent on s alone, as in the reference."""
    x, gs = _arr((4, 128), 4, "bfloat16", 3.0), _arr((4, 1), 5, "float32")
    plan, jplan = _plans(128, "bfloat16", QuantEpilogue("int8"))
    (q, s), vjp = jax.vjp(lambda a: japi._fused(a, jplan, True), jnp.asarray(x))
    (want,) = vjp((np.zeros(q.shape, jax.dtypes.float0), jnp.asarray(gs)))
    xt = to_torch(x, "cpu").requires_grad_(True)
    tq, ts = api.hadamard(xt, plan)
    assert not tq.requires_grad and ts.requires_grad
    assert torch.equal(tq.to(torch.float32), torch.from_numpy(np.asarray(q, np.float32)))
    (got,) = _grad(ts, xt, to_torch(gs, "cpu"))
    assert got.dtype == torch.bfloat16 and not got.any()
    assert not np.asarray(want.astype(jnp.float32)).any()


# ----------------------------------------------------- quant_dot family
def _weight(n, d, seed, mode, dt="bfloat16", check=False):
    w = _arr((n, d), seed, dt, 1.0 / np.sqrt(n))
    jt = jax.jit(lambda a: jquantize_weight(a, mode, with_check=check))(jnp.asarray(w))
    return w, jt


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_quant_dot_qtensor_form(mode, dt):
    """``_QuantDotQW`` against ``_quant_dot_qw``: the forward (int8 bitwise,
    fp8 within 2^-7 of the row max) and x's straight-through gradient
    rotate(g @ W^T); the weight gets none."""
    x, g = _arr((6, 128), 6, dt, 2.0), _arr((6, 40), 7, dt)
    _, jt = _weight(128, 40, 8, mode, dt)
    plan, jplan = _plans(128, dt, QuantEpilogue(mode))
    y, (want,) = _ref_vjp(lambda a: japi._quant_dot_qw(a, jt.q, jt.scale, jplan, True),
                          (x,), g)
    xt = to_torch(x, "cpu").requires_grad_(True)
    got_y = api._QuantDotQW.apply(xt, to_torch(jt.q, "cpu"), to_torch(jt.scale, "cpu"),
                                  plan, None)
    (got,) = _grad(got_y, xt, to_torch(g, "cpu"))
    tol = 0.0 if mode == "int8" else 2.0 ** -7
    assert _rel(got_y, y) <= tol and _rel(got, want) <= TOL


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_quant_dot_raw_weight_form(dt):
    """``_QuantDotW`` (the training form: the weight quantized on the fly)
    against ``_quant_dot_w``: forward bitwise (int8), gx = rotate(g @ w^T)
    and gw = rotate(x)^T g, through the public ``quant_dot``."""
    x, g = _arr((2, 3, 128), 9, dt, 2.0), _arr((2, 3, 24), 10, dt)
    w, _ = _weight(128, 24, 11, "int8", dt)
    plan, jplan = _plans(128, dt, QuantEpilogue("int8"))
    y, (want_x, want_w) = _ref_vjp(lambda a, b: japi._quant_dot_w(a, b, jplan, True),
                                   (x, w), g)
    xt = to_torch(x, "cpu").requires_grad_(True)
    wt = to_torch(w, "cpu").requires_grad_(True)
    got_y = api.quant_dot(xt, wt, plan)
    got_x, got_w = _grad(got_y, (xt, wt), to_torch(g, "cpu"))
    assert _rel(got_y, y) == 0.0
    assert _rel(got_x, want_x) <= TOL and _rel(got_w, want_w) <= TOL
    assert got_w.dtype == wt.dtype


def test_quant_dot_spec_site_binds_the_training_form():
    """The MLP's down-projection site bound to a raw weight runs
    ``_QuantDotW``: gradients reach both operands; bound to a QTensor, only
    x (the serving form)."""
    spec = api.QuantDotSpec(n=128, mode="int8", backend="torch")
    x = torch.randn(3, 128, requires_grad=True)
    w = torch.randn(128, 16, requires_grad=True)
    spec.bind(w)(x).sum().backward()
    assert x.grad is not None and w.grad is not None and w.grad.abs().sum() > 0
    x.grad = None
    out = spec.bind(quantize_weight(w.detach(), "int8"))(x)
    assert out.grad_fn is not None and "QuantDotQW" in type(out.grad_fn).__name__
    out.sum().backward()
    assert x.grad.abs().sum() > 0


def test_quant_dot_abft_form():
    """``_QuantDotQWAbft`` against ``_quant_dot_qw_abft``: the verified
    forward (healthy: the unverified output) and the same straight-through
    gradient; the checksum is a statistic."""
    x, g = _arr((4, 128), 12, "float32", 2.0), _arr((4, 32), 13, "float32")
    _, jt = _weight(128, 32, 14, "int8", "float32", check=True)
    plan, jplan = _plans(128, "float32", QuantEpilogue("int8"))
    y, (want,) = _ref_vjp(lambda a: japi._quant_dot_qw_abft(a, jt.q, jt.scale, jt.check,
                                                            jplan, True), (x,), g)
    xt = to_torch(x, "cpu").requires_grad_(True)
    got_y = api._QuantDotQWAbft.apply(xt, to_torch(jt.q, "cpu"), to_torch(jt.scale, "cpu"),
                                      to_torch(jt.check, "cpu"), plan, None)
    (got,) = _grad(got_y, xt, to_torch(g, "cpu"))
    assert _rel(got_y, y) == 0.0 and _rel(got, want) <= TOL


# ------------------------------------------------------- expert family
def _experts(shape, seed, check=False):
    Bt, E, c, n, d = shape
    x = _arr((Bt, E, c, n), seed, "bfloat16", 2.0)
    g = _arr((Bt, E, c, d), seed + 1, "bfloat16")
    w = _arr((E, n, d), seed + 2, "bfloat16", 1.0 / np.sqrt(n))
    jt = jax.jit(lambda a: jquantize_weight(a, "int8", with_check=check))(jnp.asarray(w))
    return x, g, w, jt


def test_quant_dot_experts_qtensor_form():
    """``_QuantDotExpertsQW`` against ``_quant_dot_experts_qw`` (int8; the
    reference's einsum form on xla): forward bitwise, x's gradient the
    rotation of g contracted with each expert's dequantized weight."""
    x, g, _, jt = _experts((2, 3, 2, 128, 24), 20)
    plan, jplan = _plans(128, "bfloat16", QuantEpilogue("int8"))
    y, (want,) = _ref_vjp(
        lambda a: japi._quant_dot_experts_qw(a, jt.q, jt.scale, jplan, True), (x,), g)
    xt = to_torch(x, "cpu").requires_grad_(True)
    got_y = api._QuantDotExpertsQW.apply(xt, to_torch(jt.q, "cpu"),
                                         to_torch(jt.scale, "cpu"), plan, None)
    (got,) = _grad(got_y, xt, to_torch(g, "cpu"))
    assert _rel(got_y, y) == 0.0 and _rel(got, want) <= TOL


def test_quant_dot_experts_raw_weight_form():
    """``_QuantDotExpertsW`` against ``_quant_dot_experts_w`` through the
    public ``quant_dot_experts`` with a raw (E, f, d) weight: both
    operands' straight-through gradients."""
    x, g, w, _ = _experts((2, 2, 3, 128, 16), 30)
    plan, jplan = _plans(128, "bfloat16", QuantEpilogue("int8"))
    y, (want_x, want_w) = _ref_vjp(
        lambda a, b: japi._quant_dot_experts_w(a, b, jplan, True), (x, w), g)
    xt = to_torch(x, "cpu").requires_grad_(True)
    wt = to_torch(w, "cpu").requires_grad_(True)
    got_y = api.quant_dot_experts(xt, wt, plan)
    got_x, got_w = _grad(got_y, (xt, wt), to_torch(g, "cpu"))
    assert _rel(got_y, y) == 0.0
    assert _rel(got_x, want_x) <= TOL and _rel(got_w, want_w) <= TOL


def test_quant_dot_experts_abft_form(monkeypatch):
    """``_QuantDotExpertsQWAbft`` against ``_quant_dot_experts_qw_abft`` on
    the reference's fused expert kernel (interpret mode): the verified
    forward equals the unverified one, and the gradient is the same STE."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    x, g, _, jt = _experts((1, 2, 2, 128, 16), 40, check=True)
    plan, jplan = _plans(128, "bfloat16", QuantEpilogue("int8"), jbackend="pallas")
    y, (want,) = _ref_vjp(lambda a: japi._quant_dot_experts_qw_abft(
        a, jt.q, jt.scale, jt.check, jplan, True), (x,), g)
    xt = to_torch(x, "cpu").requires_grad_(True)
    got_y = api._QuantDotExpertsQWAbft.apply(
        xt, to_torch(jt.q, "cpu"), to_torch(jt.scale, "cpu"), to_torch(jt.check, "cpu"),
        plan, None)
    (got,) = _grad(got_y, xt, to_torch(g, "cpu"))
    assert _rel(got_y, y) == 0.0 and _rel(got, want) <= TOL
