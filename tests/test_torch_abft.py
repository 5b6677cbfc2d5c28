"""PyTorch port, ABFT (algorithm-based fault tolerance): the plain versions
of the checksum-verified quant_dot kernels K7a (rotate-once, streamed,
revisit) and
K7b (the same over stacked experts), ``xla_quant_dot_resid``, the
tolerance, the weight checksums and audit, the KV conservation sums and
the rotation check, held against the JAX reference on the CPU.

The reference's verified kernels (``pallas_quant_dot(..., check=)``,
``pallas_quant_dot_experts(..., check=)``) run here in interpret mode once
``pltpu.TPUCompilerParams`` names jax's ``pltpu.CompilerParams``; the tests
set that alias, and ``REPRO_QUANT_DOT_STREAM_INTERPRET`` for the streamed
cases, inside themselves only (``monkeypatch``).

Tolerances: outputs as the K4 tests hold them (int8 bitwise; fp8 within
2^-7 of the row's largest |output|). Residuals are sums in other orders,
so the port's and the reference's differ in their last bits; what must
match is the verdict (``residual_ok``) on every row -- healthy (every row
passes, the residual a few thousandths of the tolerance) and corrupted (a
weight bit flipped, or a 128-column slab zeroed, with the stored checksum
left stale: exactly the rows whose operand touches the change fail) --
and, on every row the reference passes, the value, within RESID_C = 1e-2
of the tolerance of the reference's (the two orders read at most 4e-3 at
these sizes; a residual summed from bf16 outputs, or with a bf16
checksum, reads ~1). The
checksums, f32 sums over d of q * scale in another order, agree within
2 f32 ulps of the row's absolute mass sum_d |q * scale|; the KV sums
within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import verify as jverify
from repro.core.api import QuantEpilogue as JQuantEpilogue
from repro.core.api import plan_for as jplan_for
from repro.core.hadamard import hadamard_check as jhadamard_check
from repro.core.hadamard import hadamard_transform as jhadamard_transform
from repro.core.wquant import quantize_weight as jquantize_weight
from repro.kernels import quant_dot as jqd

from repro_torch import verify
from repro_torch.bridge import to_torch
from repro_torch.core import wquant
from repro_torch.core.api import (QuantDotSpec, QuantEpilogue, RotationSpec,
                                  plan_for)
from repro_torch.core.hadamard import hadamard_check, hadamard_transform
from repro_torch.kernels import quant_dot as qd
from repro_torch.kernels.registry import TRACE_COUNTS
from repro_torch.testing.faults import _finite_after_flip

MODES = ["int8", "fp8_e4m3", "fp8_e5m2"]
RESID_C = 1e-2


@pytest.fixture
def pallas_alias(monkeypatch):
    """The reference's quant_dot launchers as jax 0.9 can run them."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


def _weights(shape, mode, seed):
    """The reference's quantized weight with its checksum, and the port's
    QTensor carrying the same bytes and checksum."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(ml_dtypes.bfloat16)
    jt = jax.jit(lambda a: jquantize_weight(a, mode, with_check=True))(jnp.asarray(w))
    tt = wquant.QTensor(to_torch(np.asarray(jt.q), "cpu"),
                        to_torch(np.asarray(jt.scale), "cpu"), mode,
                        to_torch(np.asarray(jt.check), "cpu"))
    return jt, tt


def _corrupt(q: np.ndarray, kind: str, mode: str):
    """A copy of the storage bytes q (..., n, d) with one finite bit flip
    at (k, col) of every leading index, or a zeroed 128-column slab; also
    the contraction rows k it touches (None: the slab touches them all)."""
    raw = q.view(np.uint8).copy()
    n, d = raw.shape[-2:]
    if kind == "slab":
        lo = max(d // 2 - 64, 0)
        raw[..., lo:lo + 128] = 0
        return raw.view(q.dtype), None
    k, col, bit = n // 3, d // 2, 6
    while not _finite_after_flip(int(raw[(0,) * (raw.ndim - 2) + (k, col)]), bit, mode):
        col += 1
    raw[..., k, col] ^= np.uint8(1 << bit)
    return raw.view(q.dtype), k


def _close(got: torch.Tensor, want, mode: str) -> None:
    g = got.to(torch.float32).numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    if mode == "int8":
        np.testing.assert_array_equal(g, w)
    else:
        tol = 2.0 ** -7 * np.abs(w).max(-1, keepdims=True)
        assert (np.abs(g - w) <= tol).all(), np.abs(g - w).max()


def _verdicts(y, r, n, d):
    return verify.residual_ok(y, r, n=n, d=d).numpy()


def _jverdicts(y, r, n, d):
    return np.asarray(jverify.residual_ok(y, r, n=n, d=d))


def _value_gap(y, r, jr, n, d) -> float:
    """max of |r - r_reference| over the tolerance, over the rows the
    reference passes (a tripped row's residual carries the corruption's
    own rounding; its verdict is what is held there)."""
    rtol, atol = verify.abft_tolerance(n, d)
    jr = torch.from_numpy(np.array(jr, dtype=np.float32))
    tol = rtol * y.to(torch.float32).abs().sum(-1, keepdim=True) + atol
    passing = jr.abs() <= tol
    return float(((r - jr).abs() / tol)[passing].max())


# ------------------------------------------------------------ K7a parity
@pytest.mark.parametrize("schedule", ["rotate_once", "streamed", "revisit"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_k7a_matches_pallas_abft_kernel(pallas_alias, monkeypatch, mode, schedule):
    """n = 256, d = 384, 8 rows: the output as K4's tests hold it, the
    residual's verdict equal on every row, healthy and with the weight
    corrupted (bit flip, zeroed slab) under a stale checksum. ``revisit``
    holds K7a-rv's plain version against the reference's
    ``_quant_dot_kernel_revisit_abft``."""
    if schedule == "streamed":
        monkeypatch.setenv("REPRO_QUANT_DOT_STREAM_INTERPRET", "1")
    m, n, d = 8, 256, 384
    jt, tt = _weights((n, d), mode, seed=7)
    x = (np.random.default_rng(3).standard_normal((m, n)) * 3).astype(np.float32)
    x[5] = 0.0                                   # an all-zero row passes too
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    jplan = jplan_for(n, dtype=jnp.bfloat16, backend="pallas",
                      epilogue=JQuantEpilogue(mode))
    plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                    epilogue=QuantEpilogue(mode))
    wrappers = (qd.quant_dot_abft_cuda, qd.quant_dot_abft_streamed_cuda,
                qd.quant_dot_abft_revisit_cuda)
    before = [w.launches for w in wrappers]
    for kind in ("healthy", "flip", "slab"):
        q, touched = (np.asarray(jt.q), None) if kind == "healthy" else \
            _corrupt(np.asarray(jt.q), kind, mode)
        jy, jr = jqd.pallas_quant_dot(xj, jnp.asarray(q), jt.scale, jplan, True,
                                      schedule=schedule, check=jt.check)
        y, r = qd.quant_dot(xt, to_torch(q, "cpu"), tt.scale, plan, schedule,
                            check=tt.check)
        assert r.shape == (m, 1) and r.dtype == torch.float32
        _close(y, jy, mode)
        got, want = _verdicts(y, r, n, d), _jverdicts(jy, jr, n, d)
        np.testing.assert_array_equal(got, want)
        assert _value_gap(y, r, jr, n, d) <= RESID_C
        if kind == "healthy":
            assert got.all()
            rtol, _ = verify.abft_tolerance(n, d)
            mass = y.float().abs().sum(-1, keepdim=True)
            assert float((r.abs() / (rtol * mass).clamp_min(1e-30)).max()) < 0.05
            # bitwise the unverified plain version
            assert torch.equal(y, qd.quant_dot_plain(xt, tt.q, tt.scale, plan))
        else:   # the zero row's operand touches nothing; most rows trip
            assert got[5] and (~got).sum() >= m // 2, got[:, 0]
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("schedule", ["rotate_once", "streamed"])
@pytest.mark.parametrize("mode", MODES)
def test_plain_k7b_matches_pallas_experts_abft_kernel(pallas_alias, monkeypatch, mode,
                                                      schedule):
    """(2, 3, 2, 128) -> 96 over 3 experts, expert 1's rows all zero in
    batch 0: outputs and per-(expert, row) verdicts, healthy and with one
    expert's weight corrupted -- only that expert's non-zero rows fail."""
    if schedule == "streamed":
        monkeypatch.setenv("REPRO_QUANT_DOT_STREAM_INTERPRET", "1")
    Bt, E, c, n, d = 2, 3, 2, 128, 96
    jt, tt = _weights((E, n, d), mode, seed=11)
    x = (np.random.default_rng(5).standard_normal((Bt, E, c, n)) * 3).astype(np.float32)
    x[0, 1] = 0.0
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    jplan = jplan_for(n, dtype=jnp.bfloat16, backend="pallas",
                      epilogue=JQuantEpilogue(mode))
    plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                    epilogue=QuantEpilogue(mode))
    for kind in ("healthy", "flip", "slab"):
        q = np.asarray(jt.q).copy()
        if kind != "healthy":
            q[1], _ = _corrupt(q[1], kind, mode)        # expert 1 only
        jy, jr = jqd.pallas_quant_dot_experts(xj, jnp.asarray(q), jt.scale, jplan,
                                              True, schedule=schedule, check=jt.check)
        y, r = qd.quant_dot_experts(xt, to_torch(q, "cpu"), tt.scale, plan, schedule,
                                    check=tt.check)
        assert y.shape == (Bt, E, c, d) and r.shape == (Bt, E, c, 1)
        _close(y.reshape(-1, d), jnp.asarray(jy).reshape(-1, d), mode)
        got, want = _verdicts(y, r, n, d), _jverdicts(jy, jr, n, d)
        np.testing.assert_array_equal(got, want)
        assert _value_gap(y, r, jr, n, d) <= RESID_C
        if kind == "healthy":
            assert got.all()
            assert torch.equal(y, qd.quant_dot_experts_plain(xt, tt.q, tt.scale, plan))
        else:
            bad = ~got[..., 0]
            assert bad[1, 1].any() and not bad[:, [0, 2]].any() and not bad[0, 1].any()


@pytest.mark.parametrize("mode", MODES)
def test_residual_value_limit_separates_orders_from_mutants(mode):
    """The value limit RESID_C (here and on the card) passes a correct
    residual summed in another order and fails broken ones: r from bf16
    outputs instead of the f32 contributions, the checksum or the row
    scale rounded to bf16, one split's partial sums dropped. 16 x 2048 ->
    1024, plain versions."""
    m, n, d = 16, 2048, 1024
    _, tt = _weights((n, d), mode, seed=13)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((m, n)) * 3).to(
        torch.bfloat16)
    plan = plan_for(n, dtype=torch.bfloat16, backend="torch", device_type="cpu",
                    epilogue=QuantEpilogue(mode))
    q, s = qd._rotate_quantize_plain(x, plan)
    contrib = qd._epilogue_f32(q, s, tt.q, tt.scale.reshape(1, d), mode)
    op = qd._operand_from_q(q, mode).to(torch.float32)
    cw = tt.check.reshape(-1)
    y, r = qd.quant_dot_abft_plain(x, tt.q, tt.scale, tt.check, plan)

    def gap(r2):
        return _value_gap(y, r2, r.numpy(), n, d)

    def chk(c):
        return (op * c).sum(-1, keepdim=True)

    reordered = (contrib.flip(-1).cumsum(-1)[:, -1:]
                 - s * (op * cw).flip(-1).cumsum(-1)[:, -1:])
    assert gap(reordered) <= RESID_C / 10
    mutants = {
        "bf16 outputs": y.to(torch.float32).sum(-1, keepdim=True) - s * chk(cw),
        "bf16 checksum": contrib.sum(-1, keepdim=True)
        - s * chk(cw.to(torch.bfloat16).to(torch.float32)),
        "bf16 row scale": contrib.sum(-1, keepdim=True)
        - s.to(torch.bfloat16).to(torch.float32) * chk(cw),
        "a split dropped": contrib[:, 32:].sum(-1, keepdim=True) - s * chk(cw),
    }
    for name, bad in mutants.items():
        assert gap(bad) > 10 * RESID_C, name


@pytest.mark.parametrize("n", [256, 384])
def test_xla_quant_dot_resid_matches_reference(n):
    """The unfused residual (``n`` = 384: a grouped plan of 3 x 128):
    exactly 0 on a healthy weight in both packages, each against its own
    stored checksum (the recomputation repeats the stored one's op order);
    with the weight corrupted under a stale checksum the same residuals
    within 1e-5 relative."""
    d, mode = 96, "fp8_e4m3"
    jt, tt = _weights((n, d), mode, seed=n)
    x = (np.random.default_rng(n + 1).standard_normal((5, n))).astype(np.float32)
    jplan = jplan_for(n, dtype=jnp.float32, backend="xla",
                      epilogue=JQuantEpilogue(mode))
    plan = plan_for(n, dtype=torch.float32, backend="torch", device_type="cpu",
                    epilogue=QuantEpilogue(mode))
    assert plan.grouped == (n == 384)
    xt = torch.from_numpy(x)
    own = wquant.weight_checksum(tt.q, tt.scale)
    r = qd.xla_quant_dot_resid(xt, tt.q, tt.scale, own, plan)
    jr = jqd.xla_quant_dot_resid(jnp.asarray(x), jt.q, jt.scale, jt.check, jplan, True)
    assert r.shape == (5, 1) and (r == 0).all() and (np.asarray(jr) == 0).all()
    q, _ = _corrupt(np.asarray(jt.q), "flip", mode)
    r = qd.xla_quant_dot_resid(xt, to_torch(q, "cpu"), tt.scale, own, plan)
    jr = np.asarray(jqd.xla_quant_dot_resid(jnp.asarray(x), jnp.asarray(q), jt.scale,
                                            jt.check, jplan, True))
    assert (r != 0).all()
    np.testing.assert_allclose(r.numpy(), jr, rtol=1e-5)


def test_abft_tolerance_and_residual_ok_match_reference():
    for n, d in ((256, 384), (8192, 3072), (8192, 5120), (14336, 4096)):
        assert verify.abft_tolerance(n, d) == jverify.abft_tolerance(n, d)
    rng = np.random.default_rng(0)
    y = (rng.standard_normal((64, 384)) * 3).astype(np.float32)
    rtol, _ = verify.abft_tolerance(256, 384)
    mass = np.abs(y).sum(-1, keepdims=True)
    r = (rng.uniform(-2, 2, (64, 1)) * rtol * mass).astype(np.float32)
    r[0] = 0.0
    y[1, 0] = np.nan
    got = verify.residual_ok(torch.from_numpy(y), torch.from_numpy(r), n=256, d=384)
    want = np.asarray(jverify.residual_ok(jnp.asarray(y), jnp.asarray(r), n=256, d=384))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all() and not want[1]


@pytest.mark.parametrize("mode", MODES)
def test_weight_checksum_matches_reference(mode):
    """Dense and stacked (3 experts, summed a chunk of experts at a time by
    the port), within 2 f32 ulps of each row's absolute mass."""
    for shape in ((256, 384), (3, 128, 96)):
        jt, tt = _weights(shape, mode, seed=shape[-1])
        got = wquant.weight_checksum(tt.q, tt.scale)
        assert got.shape == tuple(np.asarray(jt.check).shape)
        want = np.asarray(jt.check)
        mass = (tt.q.float() * tt.scale).abs().sum(-1)[..., None, :].numpy()
        ulps = np.abs(got.numpy() - want) / (np.finfo(np.float32).eps * mass)
        assert ulps.max() <= 2.0, ulps.max()
        # the port's own quantize_weight stores the same checksum
        assert torch.equal(got, tt.check) or np.abs(
            tt.check.numpy() - got.numpy()).max() <= 2 * np.finfo(np.float32).eps * mass.max()


def test_weight_checksum_chunks_give_the_whole_stack(monkeypatch):
    q = torch.randint(-127, 128, (5, 64, 48), dtype=torch.int8)
    s = torch.rand(5, 1, 48)
    whole = (q.float() * s).sum(-1)[..., None, :]
    monkeypatch.setattr(wquant, "CHUNK_ELEMS", 64 * 48 * 2)
    assert torch.equal(wquant.weight_checksum(q, s), whole)


def test_params_ok_and_with_checks_match_reference():
    """The weight audit on the same tree: both packages True when
    healthy, both False after one byte of one leaf changes."""
    n, d = 256, 96
    jt, tt = _weights((n, d), "int8", seed=9)
    bare = {"layers": [{"mlp": {"w_down": wquant.QTensor(tt.q, tt.scale, "int8")}}]}
    checked = verify.with_checks(bare)
    leaf = checked["layers"][0]["mlp"]["w_down"]
    assert bare["layers"][0]["mlp"]["w_down"].check is None and leaf.q is tt.q
    assert torch.equal(leaf.check, wquant.weight_checksum(tt.q, tt.scale))
    assert verify.with_checks(checked)["layers"][0]["mlp"]["w_down"].check is leaf.check
    jtree = {"w": jt}
    assert verify.params_ok(checked) and bool(jverify.params_ok(jtree))
    q = np.asarray(jt.q).copy()
    q[17, 5] = np.int8(q[17, 5] ^ 0x40)
    jbad = {"w": jt.__class__(q=jnp.asarray(q), scale=jt.scale, check=jt.check,
                              mode="int8")}
    tbad = {"w": wquant.QTensor(to_torch(q, "cpu"), tt.scale, "int8", tt.check)}
    assert not verify.params_ok(tbad) and not bool(jverify.params_ok(jbad))
    assert verify.params_ok({"w": torch.zeros(3)})   # no checksums: nothing to audit


# --------------------------------------------------------- KV conservation
def _caches(dtype, seed=71, layers=2, slots=3, t=8, kh=2, hd=4):
    """One K and one V allocation (layers, slots, t, kh, hd) as numpy, the
    reference's caches (the two leaves), and the port's (per-layer views
    of the two allocations, as ``serving.cache`` lays them out)."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((layers, slots, t, kh, hd)).astype(dtype)
            for _ in range(2))
    K, V = to_torch(k, "cpu"), to_torch(v, "cpu")
    return (k, v), [jnp.asarray(k), jnp.asarray(v)], \
        [{"k": K[i], "v": V[i]} for i in range(layers)]


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16,
                                   ml_dtypes.float8_e4m3fn])
def test_kv_sums_match_reference(dtype):
    (k, _), jc, tc = _caches(dtype)
    assert len(verify.abft._kv_storage(tc)) == 2     # the two allocations
    pos = np.array([3, 5, 0])
    got = verify.kv_tree_sums(tc, torch.from_numpy(pos))
    want = np.asarray(jverify.kv_tree_sums(jc, jnp.asarray(pos, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    got = verify.kv_row_delta(tc, torch.from_numpy(pos))
    want = np.asarray(jverify.kv_row_delta(jc, jnp.asarray(pos, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # separate per-layer tensors (a bridged cache) give the same sums
    loose = [{"k": c["k"].clone(), "v": c["v"].clone()} for c in tc]
    assert len(verify.abft._kv_storage(loose)) == 4
    np.testing.assert_allclose(verify.kv_tree_sums(loose, torch.from_numpy(pos)).numpy(),
                               verify.kv_tree_sums(tc, torch.from_numpy(pos)).numpy(),
                               rtol=1e-6)


def test_kv_verdicts_match_reference():
    """Finite corruption of a valid row trips that slot only; NaN in a valid
    row is left to the guard; stale rows past pos are masked; the roll
    forward equals a recompute; a slot reset re-anchors one slot."""
    (k, v), jc, tc = _caches(np.float32)
    pos = np.array([3, 5, 2])
    jpos, tpos = jnp.asarray(pos, jnp.int32), torch.from_numpy(pos)
    jsums = jverify.kv_tree_sums(jc, jpos)
    tsums = verify.kv_tree_sums(tc, tpos)

    def both(edit):
        kk, vv = k.copy(), v.copy()
        edit(kk, vv)
        tcc = [{"k": torch.from_numpy(kk)[i], "v": torch.from_numpy(vv)[i]}
               for i in range(k.shape[0])]
        jok, _ = jverify.kv_check([jnp.asarray(kk), jnp.asarray(vv)], jpos, jsums)
        tok, _ = verify.kv_check(tcc, tpos, tsums)
        return tok.numpy(), np.asarray(jok)

    def finite(kk, vv):
        kk[0, 1, 2, 0, 0] += 448.0

    def nan(kk, vv):
        kk[0, 0, 1, 0, 0] = np.nan

    def stale(kk, vv):
        kk[0, 0, 6] = np.nan
        vv[1, 2, 7] = 1e9

    for edit, want in ((finite, [True, False, True]), (nan, [True] * 3),
                       (stale, [True] * 3)):
        got, jgot = both(edit)
        np.testing.assert_array_equal(got, jgot)
        assert got.tolist() == want
    # roll forward over a rewritten row 4 = recompute at pos + 1
    new = [{"k": c["k"].clone(), "v": c["v"].clone()} for c in tc]
    for c in new:
        c["k"][:, 4] += 1.0
    pos4 = torch.full((3,), 4)
    rolled = verify.kv_roll(new, pos4, verify.kv_tree_sums(new, pos4))
    np.testing.assert_allclose(rolled.numpy(),
                               verify.kv_tree_sums(new, pos4 + 1).numpy(), rtol=1e-5)
    # a drifted slot re-anchored from the cache
    drift = tsums.clone()
    drift[1] += 99.0
    fixed = verify.kv_slot_reset(drift, tc, 1, 5)
    jfixed = jverify.kv_slot_reset(jsums.at[1].add(99.0), jc, jnp.asarray(1, jnp.int32),
                                   jnp.asarray(5, jnp.int32))
    np.testing.assert_allclose(fixed.numpy(), np.asarray(jfixed), rtol=1e-6)
    assert verify.kv_check(tc, tpos, fixed)[0].all()


# -------------------------------------------------------- rotation check
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hadamard_check_matches_reference(dtype):
    rng = np.random.default_rng(41)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jy = jhadamard_transform(jx)
    ty = hadamard_transform(tx)
    cases = {"healthy": (lambda y: y), "flip": None, "nan": None}
    for name in cases:
        jyy, tyy = jy, ty.clone()
        if name == "flip":
            jyy = jy.at[3, 7].add(jnp.asarray(1.0, jy.dtype))
            tyy[3, 7] += 1.0
        elif name == "nan":
            jyy = jy.at[0, 0].set(jnp.nan)
            tyy[0, 0] = float("nan")
        got = bool(hadamard_check(tx, tyy))
        assert got == bool(jhadamard_check(jx, jyy)) == (name == "healthy"), name


def test_rotation_spec_abft_bitwise_and_counted():
    x = torch.randn(8, 128)
    plain = RotationSpec(n=128, mode="none")(x)
    before = TRACE_COUNTS[("abft", "rotation_site")]
    checked = RotationSpec(n=128, mode="none", abft=True)(x)
    assert TRACE_COUNTS[("abft", "rotation_site")] == before + 1
    assert torch.equal(plain, checked)


def test_quant_dot_spec_abft_healthy_bitwise_corrupt_nan(monkeypatch):
    """The spec-level switch: the healthy verified site is bitwise the
    unverified one; a corrupted weight's rows become NaN; a checksum
    without the switch is inert; the einsum form warns it runs
    unverified."""
    monkeypatch.delenv(verify.ABFT_ENV, raising=False)
    n, d = 256, 128
    _, tt = _weights((n, d), "int8", seed=62)
    x = torch.randn(7, n)
    spec = QuantDotSpec(n=n, mode="int8")
    y = spec.bind(tt)(x)
    on = QuantDotSpec(n=n, mode="int8", abft=True)
    assert torch.equal(on.bind(tt)(x), y)
    bad = wquant.QTensor(tt.q.clone(), tt.scale, "int8", tt.check)
    bad.q[:, 0] = 127
    assert torch.isnan(on.bind(bad)(x)).all(-1).any()
    assert torch.isfinite(spec.bind(bad)(x)).all()
    assert torch.isfinite(QuantDotSpec(n=n, mode="int8", abft=True).bind(
        wquant.QTensor(bad.q, bad.scale, "int8"))(x)).all()


def test_expert_einsum_form_warns_it_runs_unverified(monkeypatch):
    """Checksums at an expert site the expert kernel does not take (a
    grouped d_ff of 3 x 32): the einsum form runs, with a loud warning and
    its counter, and gives the unverified result."""
    from repro_torch.kernels.registry import WARN_ONCE_SEEN

    monkeypatch.delenv(verify.ABFT_ENV, raising=False)
    E, n, d = 2, 96, 64
    _, tt = _weights((E, n, d), "int8", seed=3)
    x = torch.randn(1, E, 2, n)
    key = ("abft", "experts_einsum_fallback")
    WARN_ONCE_SEEN.discard(key)
    before = TRACE_COUNTS[key]
    with pytest.warns(RuntimeWarning, match="UNVERIFIED"):
        y = QuantDotSpec(n=n, mode="int8", abft=True).bind_experts(tt)(x)
    assert TRACE_COUNTS[key] == before + 1
    assert torch.equal(y, QuantDotSpec(n=n, mode="int8").bind_experts(tt)(x))
