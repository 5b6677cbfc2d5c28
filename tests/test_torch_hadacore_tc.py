"""PyTorch port, K1 in the paper's form: the tensor-core schedule of the
HadaCore transform (``repro_torch.kernels.hadacore.tc_stages`` /
``tc_passes`` / ``tc_launch``, run by ``csrc/hadacore_tc.cuh``), held
against the JAX reference on the CPU.

The CUDA kernel cannot run here; what surrounds it can:

  * the schedule: its factors multiply to n and it rounds exactly at the
    reference plan's pass boundaries;
  * an f32 emulation of the schedule (compute-dtype operands, f32 sums,
    rounding only at the pass boundaries) against the reference's ``xla``
    transform and its Pallas kernel in interpret mode: within 1 ulp of the
    compute dtype at the row's largest value (only the f32 summation order
    inside a pass differs);
  * a lane-level model of the kernel's addressing (the A, B and C fragments
    of mma.sync m16n8k16, the register butterflies, the padded shared
    layout, the task bits, and K2 / K3's absmax reduction across lanes),
    which must give the same values within the same tolerance and every
    row's absmax exactly;
  * the wrappers' refusals and the timing harness's behaviour without a card.

Inputs come from a numpy seed. The kernel itself is held against the plain
version on the card by ``chip_smoke.py``.
"""
import itertools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hadamard as jhad
from repro.core.api import plan_for as jplan_for
from repro.kernels.registry import _pallas_transform, _xla_transform

from repro_torch.core.api import QuantEpilogue, plan_for
from repro_torch.kernels import hadacore as hc
from repro_torch.kernels.fused_quant import fused_cuda, fused_dequant_cuda
from repro_torch.kernels.hadacore import (fwht_cuda, hadacore_cuda, plan_passes,
                                          scale_in_compute_dtype, tc_geometry,
                                          tc_launch,
                                          tc_passes, tc_rows_per_block, tc_stages)
from repro_torch.kernels.ref import hadamard_matrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TDT = {"bfloat16": torch.bfloat16, "float16": torch.float16}
JDT = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}
EPS = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
SIZES = [2, 8, 16, 128, 256, 512, 2048, 4096]


def _inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ulps(got, want, dt: str) -> float:
    g = np.asarray(got, np.float64).reshape(-1, got.shape[-1])
    w = np.asarray(want, np.float64).reshape(-1, want.shape[-1])
    unit = EPS[dt] * np.maximum(np.abs(w).max(-1, keepdims=True), 1e-30)
    return float((np.abs(g - w) / unit).max())


def _cd(v: np.ndarray, dt: str) -> np.ndarray:
    """f32 values rounded to the compute dtype (nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(TDT[dt]).float().numpy()


def _plan(n: int, dt: str):
    return plan_for(n, dtype=TDT[dt], backend="cuda", device_type="cpu")


# ------------------------------------------------------------- the schedule
@pytest.mark.parametrize("n", [1 << k for k in range(16)])
def test_stages_multiply_to_n_and_round_at_the_reference_pass_ends(n):
    plan = _plan(n, "bfloat16")
    stages = tc_stages(n, plan.r)
    assert int(np.prod([s.factor for s in stages])) == n
    assert stages[-1].round_after and stages[0].tensor_core
    # the bits each stretch between two roundings covers, against the
    # reference plan's passes (its base matrices, minor pass first)
    covered, passes = set(), []
    for s in stages:
        lo = s.stride.bit_length() - 1
        new = set(range(lo, lo + s.factor.bit_length() - 1))
        assert not new & covered, "a bit transformed twice in one pass"
        covered |= new
        if s.round_after:
            passes.append(covered)
            covered = set()
    k, r = jhad.factorize(n) if n > 1 else (0, 1)
    mats = jhad.base_matrices_np(n, None) if n > 1 else [np.ones((1, 1))]
    assert len(passes) == len(mats)
    want = [set(range(int(np.log2(n))))] if n < 128 else (
        [set(range(int(np.log2(r if r > 1 else 128))))]
        + [set(range(b, b + 7)) for b in
           [int(np.log2(n)) - 7 * (j + 1) for j in range(len(mats) - 1)]])
    assert passes == want
    assert passes == [set(range(lo, lo + w)) for lo, w in plan_passes(n, plan.r)]


@pytest.mark.parametrize("n", [1 << k for k in range(16)])
def test_launch_layout_partitions_each_block(n):
    """Every pass's k, n, register and task bits split the block's element
    bits exactly; register bits stay inside a row (K2 / K3's absmax relies
    on it); the block fits the card."""
    r = _plan(n, "bfloat16").r
    lg_n = max(n.bit_length() - 1, 0)
    for rows in (1, 5, 28, 448, 1 << 20):
        rpb = tc_rows_per_block(n, rows)
        launch = tc_launch(n, r, tc_geometry(n, rows))
        assert rpb & (rpb - 1) == 0 and launch.threads in (128, 256)
        assert launch.lg_block - launch.lg_pitch == rpb.bit_length() - 1
        padded = tc_launch(n, r, tc_geometry(n, rows, epilogue=True))
        assert padded.threads in (128, 256) and padded.lg_pitch >= launch.lg_pitch
        assert hc.tc_shared_bytes(launch) <= 227 * 1024
        for p, c in zip(tc_passes(n, r), launch.passes):
            tbits = hc.task_bits(p, launch.lg_block)
            bits = list(p.kbits) + list(p.nbits) + list(p.rbits) + list(tbits)
            assert sorted(bits) == list(range(launch.lg_block))
            assert all(b < lg_n for b in p.rbits)
            assert c.nb == len(p.bbits) <= len(p.rbits) <= 3
            assert c.ntask * c.nmma * 128 == 1 << launch.lg_block


# ------------------------------------------------- f32 emulation of stages
def emulate(x: np.ndarray, n: int, r: int, dt: str, scale: float) -> np.ndarray:
    """The schedule in f32: each stage a product along its bits with
    compute-dtype operands (the f32 products of 16-bit values are exact),
    the scale in the operand of the first stage, f32 sums, and a rounding
    to the compute dtype after each pass only."""
    y = _cd(x, dt)
    m = y.shape[0]
    for i, s in enumerate(tc_stages(n, r)):
        op = hadamard_matrix(s.factor).astype(np.float32)
        if i == 0:
            op = _cd(op * np.float32(scale), dt)
        v = y.reshape(m, n // (s.factor * s.stride), s.factor, s.stride)
        y = np.einsum("abfc,gf->abgc", v, op, dtype=np.float32).reshape(m, n)
        if s.round_after:
            y = _cd(y, dt)
    return y


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("n", SIZES)
def test_emulated_schedule_matches_reference(n, dt):
    x = _inputs((4, n), seed=n + 11)
    plan = _plan(n, dt)
    got = emulate(x, n, plan.r, dt, scale_in_compute_dtype(plan))
    xj = jnp.asarray(x).astype(JDT[dt])
    want = np.asarray(_xla_transform(xj, jplan_for(n, dtype=xj.dtype, backend="xla"))
                      .astype(jnp.float32))
    assert _ulps(got, want, dt) <= 1.0
    pal = np.asarray(_pallas_transform(xj, jplan_for(n, dtype=xj.dtype, backend="pallas"),
                                       True).astype(jnp.float32))
    assert _ulps(got, pal, dt) <= 1.0


# -------------------------------------- lane-level model of the kernel
_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3


def _dep(bits, v):
    out = np.zeros_like(v)
    for j, b in enumerate(bits):
        out |= ((v >> j) & 1) << b
    return out


def _phys(e):
    return e + ((e >> 7) << 3)


def _coef(c, m, k, s):
    f = c.fbits
    on = ((m | k) >> f) == 0 if c.amode == 2 else ((m ^ k) >> f) == 0
    sign = np.where(np.vectorize(lambda v: bin(v).count("1") & 1)(m & k & ((1 << f) - 1)),
                    -s, s)
    return np.where(on, sign, 0.0).astype(np.float32)


def simulate(x: np.ndarray, n: int, r: int, dt: str, scale: float, epilogue: bool = False):
    """The kernel's data movement, lane by lane as csrc/hadacore_tc.cuh
    runs it (K2 / K3's geometry with ``epilogue``): returns (rotated rows,
    per-row absmax from the fragments)."""
    rows = x.shape[0]
    L = tc_launch(n, r, tc_geometry(n, rows, epilogue))
    rpb = 1 << (L.lg_block - L.lg_pitch)
    warps = L.threads // 32
    E, pitch = 1 << L.lg_block, 1 << L.lg_pitch
    ph = _phys(np.arange(E))
    assert len(np.unique(ph)) == E and 2 * int(ph.max() + 1) <= hc.tc_shared_bytes(L)
    out = np.zeros((rows, n), np.float32)
    amax_out = np.zeros(rows, np.float32)
    for row0 in range(0, rows, rpb):
        sm = np.zeros(int(ph.max()) + 1, np.float32)         # compute-dtype values
        blk = np.zeros((rpb, pitch), np.float32)
        take = x[row0:row0 + rpb]
        blk[:len(take), :n] = _cd(take, dt)
        sm[ph] = blk.reshape(-1)
        amax = np.zeros(rpb, np.int64)
        for pi in range(L.npass):
            c = L.passes[pi]
            kb, nb_ = list(c.kbits), list(c.nbits)
            s = np.float32(scale if c.scaled else 1.0)
            # A from the lanes' registers, as the kernel builds them
            A = np.zeros((16, 16), np.float32)
            for dm, dk in itertools.product((0, 8), (0, 1, 8, 9)):
                A[_G + dm, 2 * _T + dk] = _coef(c, _G + dm, 2 * _T + dk, s)
            A = _cd(A, dt)
            b_lo = _dep(kb, 2 * _T) | _dep(nb_, _G)
            c_lo = _dep(kb, _G) | _dep(nb_, 2 * _T)
            k1, k8, n1 = 1 << kb[0], 1 << kb[3], 1 << nb_[0]
            nmma = c.nmma
            last = pi == L.npass - 1
            bases = []
            for warp in range(min(warps, c.ntask)):
                base = c.tbase[warp]
                for task in range(warp, c.ntask, warps):
                    bases.append(base)
                    base = ((base | ~c.tmask) + c.tstep) & c.tmask
            assert sorted(bases) == sorted({int(b) for b in bases})
            # tile moves: lane l addresses row l % 8 of tile l / 8
            lj, lhi, lsec = _LANE & 7, (_LANE >> 3) & 1, _LANE >> 4
            prow = (_phys(_dep(nb_, lj)) + lhi * _phys(k8) if c.mode == hc.K_ROWS
                    else _phys(_dep(kb, lj + 8 * lhi)))
            for base in bases:
                acc = np.zeros((8, 32, 4), np.float32)
                for i in range(0, 8, 2):
                    if c.mode == hc.SCALAR:
                        bs = []
                        for d in (0, 1):
                            q = _phys(base) + c.proff[i + d] + _phys(b_lo)
                            B = np.zeros((16, 8), np.float32)
                            for dk, off in ((0, 0), (1, k1), (8, k8), (9, k8 | k1)):
                                B[2 * _T + dk, _G] = sm[q + _phys(off)]
                            bs.append(B)
                    else:   # ldmatrix: tile q's 8 rows from lanes 8q .. 8q + 7
                        addr = _phys(base) + prow + np.where(lsec, c.proff[i + 1], c.proff[i])
                        tiles = sm[addr[:, None] + np.arange(8)].reshape(4, 8, 8)
                        pair = 2 * _T[:, None] + [0, 1]          # (32, 2)
                        if c.mode == hc.K_ROWS:      # lane (g, t) <- tile[g][2t, 2t + 1]
                            regs = tiles[:, _G[:, None], pair]
                        else:                        # .trans: tile[2t, 2t + 1][g]
                            regs = tiles[:, pair, _G[:, None]]
                        bs = []                      # regs (4 tiles, 32 lanes, 2)
                        for d in (0, 1):
                            B = np.zeros((16, 8), np.float32)
                            for hh in (0, 1):
                                for dk in (0, 1):
                                    B[8 * hh + 2 * _T + dk, _G] = regs[2 * d + hh][:, dk]
                            bs.append(B)
                    for d in (0, 1):
                        D = np.matmul(A, bs[d], dtype=np.float32)
                        acc[i + d] = np.stack([D[_G, 2 * _T], D[_G, 2 * _T + 1],
                                               D[_G + 8, 2 * _T], D[_G + 8, 2 * _T + 1]], -1)
                for h in (1, 2, 4)[:c.nb]:
                    for i in range(8):
                        if i & h:
                            continue
                        a, b = acc[i].copy(), acc[i | h].copy()
                        acc[i], acc[i | h] = a + b, a - b
                for i in range(nmma, 8):     # the copies hold the real registers' values
                    np.testing.assert_array_equal(acc[i], acc[i % nmma])
                for i in range(0, 8, 2):
                    v = [_cd(acc[i + d], dt) for d in (0, 1)]
                    if c.mode == hc.SCALAR:
                        for d in (0, 1):
                            q = _phys(base) + c.proff[i + d] + _phys(c_lo)
                            for cc, off in enumerate((0, n1, k8, k8 | n1)):
                                sm[q + _phys(off)] = v[d][:, cc]
                        continue
                    # stmatrix: tile q = (mma i + q // 2, m half q % 2); lane (g, t)
                    # holds its (g, 2t | 2t + 1)
                    addr = _phys(base) + prow + np.where(lsec, c.proff[i + 1], c.proff[i])
                    for q in range(4):
                        vals = v[q >> 1][:, 2 * (q & 1): 2 * (q & 1) + 2]
                        for dk in (0, 1):
                            if c.mode == hc.N_ROWS:      # row g, column 2t + dk
                                sm[addr[8 * q + _G] + 2 * _T + dk] = vals[:, dk]
                            else:                        # .trans: row 2t + dk, column g
                                sm[addr[8 * q + 2 * _T + dk] + _G] = vals[:, dk]
                m = np.zeros((2, 32), np.int64)
                for i in range(8):
                    for cc in range(4):
                        ok = (n >= 16) | (_G + 8 * (cc >> 1) < n)
                        bits = np.abs(acc[i][:, cc]).view(np.int32).astype(np.int64)
                        m[cc & 1] = np.where(ok, np.maximum(m[cc & 1], bits), m[cc & 1])
                if not last:
                    continue
                for o in (4, 8, 16):
                    m = np.maximum(m, m[:, _LANE ^ o])
                t0_in, t1_in = nb_[1] < L.lg_pitch, nb_[2] < L.lg_pitch
                c_in = nb_[0] < L.lg_pitch
                if t0_in:
                    m = np.maximum(m, m[:, _LANE ^ 1])
                if t1_in:
                    m = np.maximum(m, m[:, _LANE ^ 2])
                if c_in:
                    m[:] = m.max(0)
                # the lane's maxima rounded once (rounding is monotone)
                m = _cd(m.astype(np.int32).view(np.float32), dt).view(np.int32)
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    if g or (t0_in and t & 1) or (t1_in and t & 2):
                        continue
                    amax[(base | c_lo[lane]) >> L.lg_pitch] = max(
                        amax[(base | c_lo[lane]) >> L.lg_pitch], m[0, lane])
                    if not c_in:
                        row = (base | c_lo[lane] | n1) >> L.lg_pitch
                        amax[row] = max(amax[row], m[1, lane])
        res = sm[ph].reshape(rpb, pitch)[:len(take), :n]
        out[row0:row0 + len(take)] = res
        amax_out[row0:row0 + len(take)] = amax[:len(take)].astype(np.int32).view(np.float32)
    return out, amax_out


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("n,rows", [(2, 5), (8, 70), (16, 9), (64, 3), (128, 28),
                                    (256, 5), (1024, 1), (2048, 3), (4096, 2),
                                    (32768, 1)])
def test_lane_model_of_the_kernel_matches_reference(n, rows, dt):
    x = _inputs((rows, n), seed=3 * n + rows)
    plan = _plan(n, dt)
    got, amax = simulate(x, n, plan.r, dt, scale_in_compute_dtype(plan))
    # K2 / K3's geometry (rows below 1024 values padded to one task each)
    # rotates bitwise alike
    got2, amax2 = simulate(x, n, plan.r, dt, scale_in_compute_dtype(plan), epilogue=True)
    np.testing.assert_array_equal(got2, got)
    np.testing.assert_array_equal(amax2, amax)
    xj = jnp.asarray(x).astype(JDT[dt])
    want = np.asarray(_xla_transform(xj, jplan_for(n, dtype=xj.dtype, backend="xla"))
                      .astype(jnp.float32))
    assert _ulps(got, want, dt) <= 1.0
    np.testing.assert_array_equal(amax, np.abs(got).max(-1))
    if n <= 4096:   # the kernel and the emulation share every rounding point
        assert _ulps(got, emulate(x, n, plan.r, dt, scale_in_compute_dtype(plan)), dt) <= 1.0


# --------------------------------------------------- wrappers, harness
def test_wrappers_refuse_cpu_tensors_and_count_nothing():
    x = torch.zeros(2, 128, dtype=torch.bfloat16)
    plan = _plan(128, "bfloat16")
    counters = (hadacore_cuda, fwht_cuda, fused_dequant_cuda, fused_cuda)
    before = [f.launches for f in counters]
    for fn in (hadacore_cuda, fwht_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, torch.empty_like(x), plan)
    qplan = plan_for(128, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                     epilogue=QuantEpilogue("int8", dequant=True))
    with pytest.raises(ValueError, match="CUDA"):
        fused_dequant_cuda(x, torch.empty_like(x), qplan)
    assert [f.launches for f in counters] == before


def test_bench_exits_2_without_cuda_and_lists_the_path_shapes():
    from repro_torch.bench import hadamard as bench

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.bench.hadamard"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    shapes = {(c.kernel, c.rows, c.n) for c in bench.CASES}
    assert {("K1", 28, 2048), ("K1", 448, 2048)} <= shapes
    assert {("K2", 4 * h, 128) for h in (32, 8)} | {("K2", 64 * h, 128) for h in (32, 8)} \
        <= shapes
    sweep = {(c.n, c.dtype) for c in bench.CASES if c.site == "sweep"}
    assert sweep == {(1 << k, d) for k in range(7, 16) for d in ("bfloat16", "float16")}


_ANON_H = "_ZN44_GLOBAL__N__c6d9e24c_11_hadacore_cu_153aa0a8"
_ANON_F = "_ZN47_GLOBAL__N__a5083585_14_fused_quant_cu_58335181"


@pytest.mark.parametrize("name,want", [
    (_ANON_H + "18hadacore_tc_kernelI13__nv_bfloat16S1_EEvPKT_PS2_xfbN11hadacore_tc4PlanE",
     ("hadacore_tc_kernel", "bfloat16", "bfloat16")),
    (_ANON_H + "18hadacore_tc_kernelIf6__halfEEvPKT_PS2_xfbN11hadacore_tc4PlanE",
     ("hadacore_tc_kernel", "float32", "float16")),
    (_ANON_H + "11fwht_kernelIfEEvPKT_PS1_xiiifi", ("fwht_kernel", "float32", None)),
    (_ANON_F + "15fused_tc_kernelI6__half13__nv_bfloat16EEvPKT_PhPfxfibN11hadacore_tc4PlanE",
     ("fused_tc_kernel", "float16", "bfloat16")),
    (_ANON_F + "12fused_kernelI13__nv_bfloat16EEvPKT_PhPfxiiifii",
     ("fused_kernel", "bfloat16", None)),
    (_ANON_F + "20fused_dequant_kernelI6__halfEEvPKT_PS2_xiiifii",
     ("fused_dequant_kernel", "float16", None)),
    (_ANON_F + "23fused_dequant_tc_kernelI13__nv_bfloat16S1_EEvPKT_PS2_xfibN11hadacore_tc4PlanE",
     ("fused_dequant_tc_kernel", "bfloat16", "bfloat16")),
    ("_Z16quant_dot_kernelI13__nv_bfloat16Li16ELb1ELb0ELb0ELb0EEvv", None),
])
def test_ptx_reader_parses_the_transform_kernels_entries(name, want):
    from repro_torch.analysis.ptx import parse_transform_name

    assert parse_transform_name(name) == want


def test_harness_cases_follow_the_configs_and_the_traffic():
    from repro_torch.bench import hadamard as bench
    from repro_torch.configs import get_config

    phi4 = get_config("phi4-mini-3.8b")
    tokens = bench.TRAIN_BATCH * bench.TRAIN_SEQ
    train = {(c.rows, c.n): c.per_step for c in bench.CASES if c.group == "train"}
    assert train == {(tokens, phi4.d_ff): 2 * phi4.num_layers,
                     (tokens * phi4.num_heads, phi4.head_dim): phi4.num_layers,
                     (tokens * phi4.num_kv_heads, phi4.head_dim): phi4.num_layers}
    # the training phase's K1 launches per step (chip_smoke.py TRAIN_PER_STEP)
    assert sum(train.values()) == 128
    path = {(c.kernel, c.rows) for c in bench.CASES if c.group == "path"}
    assert ("K1", bench.SLOTS * 7) in path and ("K2", bench.PREFILL_LEN * 8) in path


def test_phase_stamps_refuse_cpu_tensors_and_count_nothing():
    from repro_torch.kernels.fused_quant import PHASES, fused_dequant_phases

    x = torch.zeros(2, 128, dtype=torch.bfloat16)
    qplan = plan_for(128, dtype=torch.bfloat16, backend="cuda", device_type="cpu",
                     epilogue=QuantEpilogue("fp8_e4m3", dequant=True))
    before = fused_dequant_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_dequant_phases(x, qplan)
    assert fused_dequant_cuda.launches == before
    assert len(PHASES) == 7
