"""PyTorch port, fused quantized GEMMs (K4, K5, K6, K6s): the plain
versions of the rotate -> per-token quantize -> int8 / fp8 GEMM kernels,
dense and over stacked experts, under both ported schedules; the public
``quant_dot`` / ``quant_dot_experts`` and their dispatch rules, held against
the JAX reference on the CPU.

The reference's fused kernels (``pallas_quant_dot``,
``pallas_quant_dot_experts``) run here in interpret mode once
``pltpu.TPUCompilerParams`` names jax's ``pltpu.CompilerParams`` (renamed
in jax 0.9); the tests set that alias inside themselves only
(``monkeypatch``), so no other test sees it. Their streamed kernels run
(rather than fall back to rotate-once) when
``REPRO_QUANT_DOT_STREAM_INTERPRET`` is set, which the streamed tests also
do inside themselves only.

Tolerances: int8 bitwise (exact int32 accumulation, then ``acc * s * sw``
in the reference's order); fp8 within 2^-7 of the row's largest |output|
(both sum exact products in f32, in another order, then round to bf16).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.api import plan_for as jplan_for
from repro.core.api import QuantEpilogue as JQuantEpilogue
from repro.core.api import quant_dot as jquant_dot
from repro.core.api import quant_dot_experts as jquant_dot_experts
from repro.core.wquant import quantize_weight as jquantize_weight
from repro.kernels import quant_dot as jqd

from repro_torch.bridge import to_torch
from repro_torch.core import api, wquant
from repro_torch.core.api import (QuantDotSpec, QuantEpilogue, plan_for, quant_dot,
                                  quant_dot_experts)
from repro_torch.kernels import quant_dot as qd
from repro_torch.kernels import registry

MODES = ["int8", "fp8_e4m3", "fp8_e5m2"]
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def pallas_alias(monkeypatch):
    """The reference's quant_dot launchers as jax 0.9 can run them."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


def _case(m, n, d, mode, seed, dt="bfloat16"):
    """Seeded activations (as numpy f32), the reference's quantized weight
    and the same weight as a port QTensor."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, n)) * 3).astype(np.float32)
    w = (rng.standard_normal((n, d)) / np.sqrt(n)).astype(ml_dtypes.bfloat16)
    jt = jax.jit(lambda a: jquantize_weight(a, mode))(jnp.asarray(w))
    tt = wquant.QTensor(to_torch(np.asarray(jt.q), "cpu"),
                        to_torch(np.asarray(jt.scale), "cpu"), mode)
    return x, w, jt, tt


def _experts_case(shape, mode, seed):
    """Seeded expert activations (Bt, E, c, n) as numpy f32 with all-zero
    rows (all of expert 1's rows in batch 0, and the last row), the
    reference's stacked (E, n, d) weight quantized per (expert,
    out-channel), and the same weight as a port QTensor."""
    Bt, E, c, n, d = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((Bt, E, c, n)) * 3).astype(np.float32)
    x[0, 1] = 0.0
    x[-1, -1, -1] = 0.0
    w = (rng.standard_normal((E, n, d)) / np.sqrt(n)).astype(ml_dtypes.bfloat16)
    jt = jax.jit(lambda a: jquantize_weight(a, mode))(jnp.asarray(w))
    tt = wquant.QTensor(to_torch(np.asarray(jt.q), "cpu"),
                        to_torch(np.asarray(jt.scale), "cpu"), mode)
    return x, jt, tt, w


def _close(got: torch.Tensor, want, mode: str) -> None:
    g = got.to(torch.float32).numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    if mode == "int8":
        np.testing.assert_array_equal(g, w)
    else:
        tol = 2.0 ** -7 * np.abs(w).max(-1, keepdims=True)
        assert (np.abs(g - w) <= tol).all(), np.abs(g - w).max()


# ------------------------------------------------------------ K4 parity
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(8, 256, 384), (5, 128, 40)])
def test_plain_k4_matches_pallas_kernel_interpret(pallas_alias, shape, mode, dt):
    """The rotate-once kernel of the reference on 8 x 256 -> 384 and a
    ragged 5 x 128 -> 40 (rows and columns off its tiles)."""
    m, n, d = shape
    x, _, jt, tt = _case(m, n, d, mode, seed=m * n + d)
    xj = jnp.asarray(x).astype(dt)
    jplan = jplan_for(n, dtype=xj.dtype, backend="pallas",
                      epilogue=JQuantEpilogue(mode))
    want = jqd.pallas_quant_dot(xj, jt.q, jt.scale, jplan, True)
    xt = torch.from_numpy(x).to(TDT[dt])
    plan = plan_for(n, dtype=xt.dtype, backend="cuda", device_type="cpu",
                    epilogue=QuantEpilogue(mode))
    got = qd.quant_dot_plain(xt, tt.q, tt.scale, plan)
    assert got.dtype == xt.dtype and got.shape == (m, d)
    _close(got, want, mode)
    # the public entry point takes a CPU tensor to the same plain version
    before = qd.quant_dot_cuda.launches
    _close(quant_dot(xt, tt, plan), want, mode)
    assert qd.quant_dot_cuda.launches == before


@pytest.mark.parametrize("mode", MODES)
def test_public_quant_dot_matches_reference(mode):
    """``quant_dot`` with a pre-quantized QTensor and with a raw weight
    (quantized on the fly), leading axes kept, against the reference's
    public ``quant_dot`` on its unfused ``xla`` backend."""
    x, w, jt, tt = _case(6, 256, 72, mode, seed=31)
    x3 = x.reshape(2, 3, 256)
    xj = jnp.asarray(x3, jnp.bfloat16)
    xt = torch.from_numpy(x3).to(torch.bfloat16)
    want = jax.jit(lambda a: jquant_dot(a, jt, mode=mode, backend="xla",
                                        interpret=True))(xj)
    got = quant_dot(xt, tt, mode=mode)
    assert got.shape == (2, 3, 72)
    _close(got.reshape(6, 72), want.reshape(6, 72), mode)
    _close(quant_dot(xt, tt, mode=mode, backend="cuda").reshape(6, 72),
           want.reshape(6, 72), mode)
    want_raw = jax.jit(lambda a: jquant_dot(a, jnp.asarray(w), mode=mode,
                                            backend="xla", interpret=True))(xj)
    calls = wquant.QUANTIZE_WEIGHT_CALLS
    got_raw = quant_dot(xt, to_torch(np.asarray(w), "cpu"), mode=mode)
    assert wquant.QUANTIZE_WEIGHT_CALLS == calls + 1
    _close(got_raw.reshape(6, 72), want_raw.reshape(6, 72), mode)


# ------------------------------------------------------------ K6 parity
EXPERT_SHAPES = [(2, 3, 2, 128, 40), (1, 4, 1, 256, 96)]   # (Bt, E, c, n, d)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", EXPERT_SHAPES)
def test_plain_k6_matches_pallas_experts_kernel_interpret(pallas_alias, shape, mode):
    """The reference's 3-D expert kernel on (Bt, E, c, n) -> d with Bt > 1
    and c > 1, all-zero rows, and d off the tiles (40 and 96 columns):
    int8 bitwise, fp8 within 2^-7 of the row max; the all-zero rows give
    exact zeros in both. The public ``quant_dot_experts`` and the
    ``bind_experts`` site take a CPU tensor to the same plain version."""
    Bt, E, c, n, d = shape
    x, jt, tt, w = _experts_case(shape, mode, seed=n + d)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    jplan = jplan_for(n, dtype=jnp.bfloat16, backend="pallas",
                      epilogue=JQuantEpilogue(mode))
    want = jqd.pallas_quant_dot_experts(xj, jt.q, jt.scale, jplan, True)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                    epilogue=QuantEpilogue(mode))
    got = qd.quant_dot_experts_plain(xt, tt.q, tt.scale, plan)
    assert got.dtype == torch.bfloat16 and got.shape == (Bt, E, c, d)
    _close(got.reshape(-1, d), want.reshape(-1, d), mode)
    assert not got[0, 1].any() and not got[-1, -1, -1].any()
    assert not np.asarray(want[0, 1].astype(jnp.float32)).any()
    before = qd.quant_dot_experts_cuda.launches
    assert torch.equal(quant_dot_experts(xt, tt, plan), got)
    spec = QuantDotSpec(n=n, mode=mode, backend="cuda")
    assert torch.equal(spec.bind_experts(tt)(xt), got)
    # a raw weight is quantized per (expert, out-channel) on the fly
    calls = wquant.QUANTIZE_WEIGHT_CALLS
    assert torch.equal(quant_dot_experts(xt, to_torch(w, "cpu"), plan), got)
    assert wquant.QUANTIZE_WEIGHT_CALLS == calls + 1
    assert qd.quant_dot_experts_cuda.launches == before


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("form", ["dense", "experts"])
def test_plain_streamed_matches_reference_streamed_kernels(pallas_alias, monkeypatch,
                                                           form, mode):
    """``schedule="streamed"`` (K5 / K6s on the card) against the
    reference's streamed kernels, run on the interpreter's synchronous DMA
    simulation: int8 bitwise, fp8 within 2^-7 of the row max. The
    reference's streamed outputs equal its rotate-once outputs bitwise, the
    property the port's kernels keep on the card."""
    monkeypatch.setenv(jqd.STREAM_INTERPRET_ENV, "1")
    jplan = jplan_for(128, dtype=jnp.bfloat16, backend="pallas",
                      epilogue=JQuantEpilogue(mode))
    plan = plan_for(128, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                    epilogue=QuantEpilogue(mode))
    if form == "dense":
        x, _, jt, tt = _case(9, 128, 300, mode, seed=11)
        xj = jnp.asarray(x, jnp.bfloat16)
        want = jqd.pallas_quant_dot(xj, jt.q, jt.scale, jplan, True, schedule="streamed")
        once = jqd.pallas_quant_dot(xj, jt.q, jt.scale, jplan, True)
        got = quant_dot(torch.from_numpy(x).to(torch.bfloat16), tt, plan,
                        schedule="streamed")
    else:
        x, jt, tt, _ = _experts_case((2, 3, 2, 128, 300), mode, seed=12)
        xj = jnp.asarray(x, jnp.bfloat16)
        want = jqd.pallas_quant_dot_experts(xj, jt.q, jt.scale, jplan, True,
                                            schedule="streamed")
        once = jqd.pallas_quant_dot_experts(xj, jt.q, jt.scale, jplan, True)
        got = quant_dot_experts(torch.from_numpy(x).to(torch.bfloat16), tt, plan,
                                schedule="streamed")
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)),
                                  np.asarray(once.astype(jnp.float32)))
    _close(got.reshape(-1, 300), want.reshape(-1, 300), mode)


def test_experts_revisit_runs_rotate_once(pallas_alias):
    """The reference's expert grid has no revisit body and runs rotate-once
    for it; so does the port. The dense revisit (K8 on the card) runs its
    plain version here and equals the reference's revisit kernel
    (interpret mode) bitwise in int8."""
    x, jt, tt, _ = _experts_case((1, 2, 3, 128, 24), "int8", seed=13)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    plan = plan_for(128, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                    epilogue=QuantEpilogue("int8"))
    once = quant_dot_experts(xt, tt, plan, schedule="rotate_once")
    assert torch.equal(quant_dot_experts(xt, tt, plan, schedule="revisit"), once)
    assert torch.equal(registry.get_backend("torch").quant_dot_experts(
        xt, tt.q, tt.scale, plan, "revisit"), once)
    jplan = jplan_for(128, dtype=jnp.bfloat16, backend="pallas",
                      epilogue=JQuantEpilogue("int8"))
    want = jqd.pallas_quant_dot_experts(jnp.asarray(x, jnp.bfloat16), jt.q, jt.scale,
                                        jplan, True, schedule="revisit")
    _close(once.reshape(-1, 24), want.reshape(-1, 24), "int8")
    dense = quant_dot(xt[0, 0], wquant.QTensor(tt.q[0], tt.scale[0], "int8"), plan,
                      schedule="revisit")
    want = jqd.pallas_quant_dot(jnp.asarray(x[0, 0], jnp.bfloat16), jt.q[0], jt.scale[0],
                                jplan, True, schedule="revisit")
    _close(dense, want, "int8")


@pytest.mark.parametrize("n", [128, 96])
def test_experts_einsum_form_matches_reference(n):
    """The unfused expert form -- the (q, scales) epilogue, then the int8
    contraction per expert -- at a grouped size (96 = 3 x 32: scales over
    the full row) and on the reference's xla backend, which hosts no expert
    kernel, against the reference's einsum form: bitwise."""
    x, jt, tt, _ = _experts_case((2, 3, 1, n, 16), "int8", seed=n)
    jplan = jplan_for(n, dtype=jnp.bfloat16, backend="xla",
                      epilogue=JQuantEpilogue("int8"))
    want = jax.jit(lambda a: jquant_dot_experts(a, jt, jplan, interpret=True))(
        jnp.asarray(x, jnp.bfloat16))
    plan = plan_for(n, dtype=torch.bfloat16, backend="torch", device_type="cpu",
                    epilogue=QuantEpilogue("int8"))
    assert api._qd_experts_fusable(plan) == (n == 128)
    got = quant_dot_experts(torch.from_numpy(x).to(torch.bfloat16), tt, plan)
    _close(got.reshape(-1, 16), want.reshape(-1, 16), "int8")


# ------------------------------------------------------- dispatch rule
def _spy(monkeypatch, cls=registry.CudaBackend):
    calls = []
    real = cls.quant_dot

    def spy(self, x, wq, sw, plan, schedule=None):
        calls.append(plan.n)
        return real(self, x, wq, sw, plan, schedule)

    monkeypatch.setattr(cls, "quant_dot", spy)
    return calls


@pytest.mark.parametrize("n, per_token, fused", [
    (128, True, True),      # power of 2, per token: the backend's kernel
    (96, True, False),      # grouped 3 x 32: unfused, scales over the row
    (128, False, False),    # per-tensor scale: unfused
])
def test_quant_dot_dispatch_rule(monkeypatch, n, per_token, fused):
    calls = _spy(monkeypatch)
    x, _, jt, tt = _case(4, n, 24, "int8", seed=n)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    epi = QuantEpilogue("int8", per_token=per_token)
    plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                    epilogue=epi)
    assert api._qd_fusable(plan) == fused
    got = quant_dot(xt, tt, plan)
    assert calls == ([n] if fused else [])
    jplan = jplan_for(n, dtype=jnp.bfloat16, backend="xla",
                      epilogue=JQuantEpilogue("int8", per_token=per_token))
    want = jax.jit(lambda a: jquant_dot(a, jt, jplan, interpret=True))(
        jnp.asarray(x, jnp.bfloat16))
    _close(got, want, "int8")


def test_quant_dot_spec_site_takes_the_fused_path(monkeypatch):
    """The serving down-projection site (a QuantDotSpec bound to a
    pre-quantized weight) reaches the backend's quant_dot at a power-of-2
    size and the unfused path at a grouped one."""
    calls = _spy(monkeypatch)
    for n, want in ((256, [256]), (96, [])):
        x, _, _, tt = _case(3, n, 16, "int8", seed=7)
        calls.clear()
        out = QuantDotSpec(n=n, mode="int8", backend="cuda").bind(tt)(
            torch.from_numpy(x).to(torch.bfloat16))
        assert out.shape == (3, 16) and calls == want


def test_kernel_size_rule():
    """The port's fusability rule comes from K4's shared-memory layout: one
    row of operand + work area fits the 227 KB block limit for every power
    of 2 up to the 32768 cap, int8 and fp8 alike (the operand holds one
    byte a value: the fp8 storage bytes the tensor cores read); the torch
    backend hosts the unfused math as quant_dot (the reference's xla
    backend does too)."""
    for n in (2, 128, 8192, 32768):
        for mode in MODES:
            assert qd.kernel_fits(n, mode)
    # one row at the cap: 32800 operand bytes + 4 f32 rows of 32768 + its
    # scale and absmax
    assert qd._smem_bytes(32768, 1, "fp8_e4m3") == 163880
    assert qd._smem_bytes(8192, 16, "int8") <= qd._SMEM_LIMIT
    assert qd._smem_bytes(8192, 8, "fp8_e4m3") <= qd._SMEM_LIMIT
    assert qd._smem_bytes(8192, 16, "fp8_e4m3") == qd._smem_bytes(8192, 16, "int8")
    assert qd._smem_bytes(8192, 16, "fp8_e4m3") <= qd._SMEM_LIMIT
    assert not qd.kernel_fits(1 << 17, "int8")
    # the streamed schedule charges its 64 KB weight ring (16 warps x 4
    # k-steps of 1 KB) beside the work area instead of inside it: 16 rows
    # still fit at n = 8192, and one row at n = 32768
    assert qd._smem_bytes(8192, 16, "int8", "streamed") <= qd._SMEM_LIMIT
    assert qd._smem_bytes(8192, 16, "fp8_e4m3", "streamed") <= qd._SMEM_LIMIT
    assert qd._smem_bytes(32768, 2, "int8", "streamed") > qd._SMEM_LIMIT
    assert qd.kernel_fits(32768, "int8", "streamed")
    assert not qd.kernel_fits(1 << 16, "int8", "streamed")
    big = plan_for(32768, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                   epilogue=QuantEpilogue("int8"))
    assert api._qd_fusable(big) and api._qd_fusable(big, "streamed")
    assert api._qd_experts_fusable(big, "streamed")
    torch_plan = plan_for(256, dtype=torch.bfloat16, backend="torch",
                          device_type="cpu", epilogue=QuantEpilogue("int8"))
    assert api._qd_fusable(torch_plan)
    assert registry.get_backend("ref").quant_dot is None


# Rows per block at the training phase's 2048 rows, by (n, schedule): the
# same in every mode and with or without ABFT, now that the operand holds
# one byte a value (the bf16 embedding of fp8 halved fp8's rows at 8192)
ROWS_PER_BLOCK = {
    (2048, "rotate_once"): 16, (2048, "streamed"): 16, (2048, "revisit"): 16,
    (8192, "rotate_once"): 16, (8192, "streamed"): 16, (8192, "revisit"): 16,
    (32768, "rotate_once"): 2, (32768, "streamed"): 1, (32768, "revisit"): 2,
}


@pytest.mark.parametrize("abft", [False, True], ids=["plain", "abft"])
@pytest.mark.parametrize("schedule", qd.SCHEDULES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [2048, 8192, 32768])
def test_rows_per_block(n, mode, schedule, abft):
    """The launcher's rows per block (pick_bm) from the layout: the table's,
    fewer rows for fewer needed, and the layout of those rows fits."""
    bm = qd._rows_per_block(2048, n, mode, schedule, abft)
    assert bm == ROWS_PER_BLOCK[n, schedule]
    assert qd._smem_bytes(n, bm, mode, schedule, abft) <= qd._SMEM_LIMIT
    assert bm == 16 or qd._smem_bytes(n, 2 * bm, mode, schedule, abft) > qd._SMEM_LIMIT
    assert qd._rows_per_block(4, n, mode, schedule, abft) == min(4, bm)
    assert qd._rows_per_block(1, n, mode, schedule, abft) == 1


@pytest.mark.parametrize("abft", [False, True], ids=["plain", "abft"])
@pytest.mark.parametrize("schedule", qd.SCHEDULES)
def test_kernel_fits_every_promised_power_of_two(schedule, abft):
    """kernel_fits holds for every power of 2 up to the 32768 cap, in every
    mode (its docstring's promise), and not beyond."""
    for lg in range(1, 16):
        for mode in MODES:
            assert qd.kernel_fits(1 << lg, mode, schedule, abft), (1 << lg, mode)
    assert not any(qd.kernel_fits(1 << 16, mode, schedule, abft) for mode in MODES)


# The sites' launch geometry on an H100 (132 SMs): (m, n, d, mode, experts,
# schedule) -> (rows per block, row blocks, splits, cluster, tiles per
# block); each row is rotated splits / cluster times (revisit: splits)
GEOMETRY = {
    # phi4-mini's down projection: decode, prefill, the training step's rows
    (4, 8192, 3072, "int8", 0, "rotate_once"): (4, 1, 96, 4, 1),
    (4, 8192, 3072, "int8", 0, "streamed"): (4, 1, 96, 4, 1),
    (4, 8192, 3072, "int8", 0, "revisit"): (4, 1, 24, 1, 4),
    (64, 8192, 3072, "int8", 0, "rotate_once"): (16, 4, 32, 8, 3),
    (64, 8192, 3072, "int8", 0, "revisit"): (16, 4, 24, 1, 4),
    (2048, 8192, 3072, "int8", 0, "rotate_once"): (16, 128, 2, 2, 48),
    (2048, 8192, 3072, "int8", 0, "revisit"): (16, 128, 24, 1, 4),
    # llama4-maverick's dense and expert down projections
    (4, 8192, 5120, "fp8_e4m3", 0, "rotate_once"): (4, 1, 80, 4, 2),
    (4, 8192, 5120, "fp8_e4m3", 0, "streamed"): (4, 1, 80, 4, 2),
    (64, 8192, 5120, "fp8_e4m3", 0, "rotate_once"): (16, 4, 32, 8, 5),
    (64, 8192, 5120, "fp8_e4m3", 0, "streamed"): (16, 4, 32, 8, 5),
    (4, 8192, 5120, "fp8_e4m3", 128, "rotate_once"): (4, 1, 2, 2, 80),
    (4, 8192, 5120, "fp8_e4m3", 128, "streamed"): (4, 1, 2, 2, 80),
}


@pytest.mark.parametrize("site", list(GEOMETRY), ids=lambda s: "-".join(map(str, s)))
def test_launch_geometry_rotations_per_row(site):
    """launch_grid's geometry at phi4-mini's and llama4-maverick's sites
    from the launcher's rules, and the rotations per row the linter's
    rotate-once rule expects of it: splits / cluster, every split a whole
    cluster, the tiles covered; revisit one rotation per 128-column tile."""
    m, n, d, mode, experts, schedule = site
    g = qd._grid_plan(m, n, d, mode, experts, schedule)
    assert (g["bm"], g["row_blocks"], g["splits"], g["cluster"],
            g["tiles_per_block"]) == GEOMETRY[site]
    assert g["smem"] == qd._smem_bytes(n, g["bm"], mode, schedule)
    assert g["row_blocks"] * g["bm"] >= m > (g["row_blocks"] - 1) * g["bm"]
    assert g["splits"] * g["tiles_per_block"] >= -(-d // 32)
    assert g["splits"] % g["cluster"] == 0 and g["bm"] % g["cluster"] == 0
    per_row = g["splits"] // g["cluster"]
    if schedule == "revisit":
        assert per_row == -(-d // qd.REVISIT_BLOCK_N)
    else:
        # the clusters of a row block split its tiles: fewer tiles per
        # block than a cluster's worth would leave a member idle
        assert g["tiles_per_block"] * (g["splits"] - g["cluster"]) < -(-d // 32)


# ------------------------------------------------------------ schedules
def test_schedules_resolve_or_raise(monkeypatch, pallas_alias):
    """rotate_once, streamed and revisit (K4, K5 and K8 on the card) give
    the plain result on a CPU tensor, named or through
    REPRO_QUANT_DOT_SCHEDULE; the dense revisit equals the reference's
    revisit kernel (interpret mode) bitwise in int8. An unknown name
    raises, on the grouped (unfused) path too."""
    x, _, jt, tt = _case(2, 64, 8, "int8", seed=3)
    xt = torch.from_numpy(x)
    ref = quant_dot(xt, tt)
    for name in ("rotate_once", "streamed", "revisit"):
        assert torch.equal(quant_dot(xt, tt, schedule=name), ref)
        assert torch.equal(quant_dot(xt, tt, schedule=name, backend="torch"), ref)
        assert torch.equal(quant_dot(xt, tt, schedule=name, backend="cuda"), ref)
        monkeypatch.setenv(qd.SCHEDULE_ENV_VAR, name)
        assert torch.equal(quant_dot(xt, tt), ref)
    jplan = jplan_for(64, dtype=jnp.float32, backend="pallas",
                      epilogue=JQuantEpilogue("int8"))
    want = jqd.pallas_quant_dot(jnp.asarray(x), jt.q, jt.scale, jplan, True,
                                schedule="revisit")
    _close(ref, want, "int8")
    monkeypatch.setenv(qd.SCHEDULE_ENV_VAR, "rotate_once")
    with pytest.raises(ValueError, match="unknown quant_dot schedule"):
        quant_dot(xt, tt, schedule="rotate_twice")
    # the grouped (unfused) path validates the schedule too
    xg, _, _, tg = _case(2, 96, 8, "int8", seed=4)
    xg = torch.from_numpy(xg)
    assert torch.equal(quant_dot(xg, tg, schedule="revisit"), quant_dot(xg, tg))
    with pytest.raises(ValueError, match="unknown quant_dot schedule"):
        quant_dot(xg, tg, schedule="rotate_twice")


# --------------------------------------------------------------- errors
def test_quant_dot_rejects_bad_calls():
    x, _, _, tt = _case(2, 64, 8, "int8", seed=5)
    xt = torch.from_numpy(x)
    plan = plan_for(64, dtype=torch.float32, device_type="cpu",
                    epilogue=QuantEpilogue("int8"))
    with pytest.raises(ValueError, match="explicit plan"):
        quant_dot(xt, tt, plan, mode="int8")
    with pytest.raises(ValueError, match="non-dequant"):
        quant_dot(xt, tt, plan_for(64, dtype=torch.float32, device_type="cpu",
                                   epilogue=QuantEpilogue("int8", dequant=True)))
    with pytest.raises(ValueError, match="non-dequant"):
        quant_dot(xt, tt, plan_for(64, dtype=torch.float32, device_type="cpu"))
    with pytest.raises(ValueError, match="stored as 'int8'"):
        quant_dot(xt, tt, mode="fp8_e4m3")
    with pytest.raises(ValueError, match="contraction dim"):
        quant_dot(xt[:, :32], wquant.quantize_weight(torch.ones(64, 8), "int8"))
    with pytest.raises(ValueError, match="contraction dim"):
        quant_dot(xt, torch.ones(32, 8))
    with pytest.raises(ValueError, match="n=64"):
        quant_dot(xt[:, :32], tt, plan)
    with pytest.raises(ValueError, match="dtype"):
        quant_dot(xt.to(torch.bfloat16), tt, plan)


def test_k4_kernel_wrapper_takes_cuda_tensors_only():
    x, _, _, tt = _case(2, 64, 8, "int8", seed=6)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    plan = plan_for(64, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                    epilogue=QuantEpilogue("int8"))
    before = qd.quant_dot_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        qd.quant_dot_cuda(xt, tt.q, tt.scale.reshape(-1),
                          torch.empty(2, 8, dtype=torch.bfloat16), plan)
    with pytest.raises(ValueError, match="per-token"):
        qd.quant_dot_cuda(xt, tt.q, tt.scale.reshape(-1), xt, plan_for(
            64, dtype=torch.bfloat16, device_type="cpu",
            epilogue=QuantEpilogue("int8", per_token=False)))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        qd.quant_dot(xt.to("meta"), tt.q, tt.scale, plan)
    assert qd.quant_dot_cuda.launches == before


def test_k5_k6_wrappers_take_cuda_tensors_only():
    """The streamed and expert kernels' wrappers raise on CPU tensors and
    count no launch; the expert dispatcher checks the expert axis."""
    x, _, tt, _ = _experts_case((1, 2, 1, 64, 8), "int8", seed=8)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    plan = plan_for(64, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                    epilogue=QuantEpilogue("int8"))
    counters = [qd.quant_dot_streamed_cuda, qd.quant_dot_experts_cuda,
                qd.quant_dot_experts_streamed_cuda]
    before = [f.launches for f in counters]
    out = torch.empty(1, 2, 1, 8, dtype=torch.bfloat16)
    for fn in (qd.quant_dot_experts_cuda, qd.quant_dot_experts_streamed_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(xt, tt.q, tt.scale.reshape(2, 8), out, plan)
    with pytest.raises(ValueError, match="CUDA"):
        qd.quant_dot_streamed_cuda(xt[0, 0], tt.q[0], tt.scale[0].reshape(-1),
                                   out[0, 0], plan)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        qd.quant_dot_experts(xt.to("meta"), tt.q, tt.scale, plan, "streamed")
    with pytest.raises(ValueError, match="expert"):
        quant_dot_experts(xt[:, :1], tt, plan)
    assert [f.launches for f in counters] == before


def test_k8_k7a_rv_wrappers_and_size_rule():
    """K8 and K7a-rv take CUDA tensors only (a CPU call raises and counts no
    launch); revisit has rotate-once's shared-memory layout, so the same
    sizes fuse (up to the 32768 cap, ABFT or not), and a training row count
    changes nothing in the rule."""
    x, _, _, tt = _case(2, 64, 8, "int8", seed=6)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    plan = plan_for(64, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                    epilogue=QuantEpilogue("int8"))
    before = qd.quant_dot_revisit_cuda.launches, qd.quant_dot_abft_revisit_cuda.launches
    out = torch.empty(2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        qd.quant_dot_revisit_cuda(xt, tt.q, tt.scale.reshape(-1), out, plan)
    with pytest.raises(ValueError, match="CUDA"):
        qd.quant_dot_abft_revisit_cuda(xt, tt.q, tt.scale.reshape(-1), torch.zeros(64),
                                       out, torch.empty(2, 1), plan)
    assert (qd.quant_dot_revisit_cuda.launches,
            qd.quant_dot_abft_revisit_cuda.launches) == before
    for n in (2, 128, 8192, 32768):
        for mode in MODES:
            for abft in (False, True):
                assert qd.kernel_fits(n, mode, "revisit", abft) == \
                    qd.kernel_fits(n, mode, "rotate_once", abft)
    assert qd._smem_bytes(8192, 16, "int8", "revisit") == qd._smem_bytes(8192, 16, "int8")
    assert qd._smem_bytes(8192, 16, "fp8_e4m3", "revisit") == \
        qd._smem_bytes(8192, 16, "fp8_e4m3")
    big = plan_for(32768, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                   epilogue=QuantEpilogue("fp8_e4m3"))
    assert api._qd_fusable(big, "revisit")
    assert qd.REVISIT_BLOCK_N % 32 == 0
