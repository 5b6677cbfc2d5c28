"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--seed 0]

Runs from the repository root and needs the repository's ``src/``. It

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
     per source, in parallel) and prints the build seconds;
  3. kernel phase: holds every kernel against its plain PyTorch version on
     the card -- K1 ``hadacore`` at n in {128, 2048, 32768} x {bf16, fp16,
     f32} and grouped 14336; K2 ``fused_dequant`` at n in {128, 2048} x
     {int8, fp8_e4m3, fp8_e5m2}, bf16; K3 ``fused`` at n in {128, 2048,
     8192} x the 3 modes (q and s bitwise); K4 ``quant_dot`` at phi4-mini's
     down projection (4 and 64 x 8192 -> 3072) and a ragged 5 x 8192 ->
     3000 in the 3 modes (int8 bitwise, fp8 within 2^-7 of the row max);
     K5 (streamed K4) against K4 bitwise and its plain version at
     llama4-maverick's 4 and 64 x 8192 -> 5120; K6 ``quant_dot_experts``
     and K6s (streamed K6) at maverick's (4 | 1, 128, 1, 8192) -> 5120 over
     128 experts, with every third expert's rows all zero: K6s equal to K6,
     K6 to K4 per expert, bitwise, zero rows exact zeros, K6 against its
     plain version (int8 and fp8_e4m3 for K5/K6/K6s) -- and times each at
     the shapes its path gives it (CUDA events, and a profile for K4-K6s)
     beside its bound, its plain version and one PyTorch library call where
     there is one (for K4-K6s the contraction alone, per weight matrix:
     ``torch._int_mm`` in int8, ``torch._scaled_mm`` in fp8_e4m3);
  4. entry-point phase: ``hadamard(x, epilogue=QuantEpilogue(mode))`` and
     ``quant_dot`` on CUDA tensors launch K3 and K4 once per call, K1 never;
  5. model phases, each at full width from ``--seed`` with int8 weight
     storage: llama3-8b (fp8_e4m3 + Hadamard + fp8 KV cache, 32 layers),
     phi4-mini-3.8b (int8 W8A8 + Hadamard + int8 fake-quantized KV, tied
     embeddings, 32 layers) and llama4-maverick-400b-a17b (fp8_e4m3 +
     Hadamard + fp8 KV, 128 experts top-1 + a shared expert; depth cut to 2
     of its 24 (attn, moe) groups, 4 of 48 layers, ~35 GB of weights). Each
     reports which layer-0 stage first differs between the kernels and the
     plain versions, holds a prefill through the kernels against one
     through the plain versions (a limit calibrated in the same run:
     witnesses, correct paths that differ as a kernel may, must pass it and
     controls, known faults, must fail it; for maverick every held run
     routes as the plain run did, and the unpinned runs report the tokens
     whose top-1 expert differs, with their gate margins), then serves 8
     requests on 4 slots through ``ServeEngine`` with the launch counters
     zeroed just before and read just after, and checks the launches per
     model pass (llama3: 32 K1 + 64 K2; phi4-mini: 32 K4 + 64 K2; maverick:
     8 K2 + 4 K4 + 2 K6; every other kernel 0), the peak device memory and
     a profile of the decode step. Maverick then runs a prefill and 4
     decode steps under ``REPRO_QUANT_DOT_SCHEDULE=streamed``: logits and
     KV caches bitwise equal to rotate-once, with 4 K5 + 2 K6s launches per
     pass in place of K4 and K6;
  6. prints the kernels' JSON line, then the result line
     ``{"ok": true, "device": {...}}`` last.

Any failed check raises: the script then exits non-zero and prints no
result line. Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SLOTS, PREFILL_LEN, MAX_LEN = 4, 64, 256   # the serving run's engine
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
F32_CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12           # H100 SXM, dense int8 tensor cores
FP8_OPS_PER_S = 1979e12            # H100 SXM, dense fp8 tensor cores
MODES = ("int8", "fp8_e4m3", "fp8_e5m2")
PHI4_DOWN = (8192, 3072)           # phi4-mini's down projection, n -> d
MAVERICK_DOWN = (8192, 5120)       # llama4-maverick's down projections, n -> d
EXPERTS = 128                      # llama4-maverick's experts per MoE layer
IO_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
EPS = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7,
       torch.float16: 2.0 ** -10}


def fail(msg: str) -> None:
    raise AssertionError(msg)


def cuda_time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time of ``fn()`` on the current stream, from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_ulps(got: torch.Tensor, want: torch.Tensor, cd: torch.dtype) -> float:
    """Largest |got - want| per row, in compute-dtype ulps at the row's
    largest magnitude."""
    g, w = got.float().reshape(-1, got.shape[-1]), want.float().reshape(-1, want.shape[-1])
    unit = EPS[cd] * w.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(((g - w).abs() / unit).max())


def k1_tolerance(n: int, cd: torch.dtype) -> float:
    """K1 against its plain version, in ulps at the row max: 1 for 16-bit
    compute (both round every pass to the compute dtype; only f32 sums in
    another order differ); log2(n) for f32 compute, where nothing rounds
    the two summation orders back together (the rounding model of a
    log2(n)-stage transform)."""
    return 1.0 if cd != torch.float32 else float(max(1, int(math.log2(n))))


def k2_excess(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor, plan) -> float:
    """Largest |got - want| / (one storage-grid step x the row's scale +
    one io ulp of the value); <= 1 passes."""
    from repro_torch.kernels.hadacore import transform_plain
    from repro_torch.kernels.registry import QSPECS, _quantize_rows

    mode = plan.epilogue.mode
    y = transform_plain(x, plan).float()
    q, s = _quantize_rows(y, mode)
    if QSPECS[mode][2]:
        step = torch.ones_like(q)
    else:
        mbits, emin = (3, -6) if mode == "fp8_e4m3" else (2, -14)
        e = torch.floor(torch.log2(q.abs().clamp_min(2.0 ** emin)))
        step = torch.exp2(e - mbits)
    w = want.float()
    tol = step * s + EPS[x.dtype] * w.abs()
    return float(((got.float() - w).abs() / tol).max())


def kernel_phase(gen: torch.Generator):
    """Build-free check and timing of K1 and K2 (the build happened
    before). Returns the two kernels' entries of the JSON line."""
    from repro_torch.core.api import QuantEpilogue, hadamard, plan_for
    from repro_torch.kernels.fused_quant import fused_dequant, fused_dequant_plain
    from repro_torch.kernels.hadacore import transform, transform_plain
    from repro_torch.kernels.ref import hadamard_matrix

    print("-- kernel phase: K1 hadacore against its plain version")
    for n in (128, 2048, 32768):
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            x = torch.randn(64, n, generator=gen, device="cuda").to(dt)
            plan = plan_for(n, dtype=dt, backend="cuda", device_type="cuda")
            got = transform(x, plan)
            torch.cuda.synchronize()
            err = k1_ulps(got, transform_plain(x, plan), dt)
            tol = k1_tolerance(n, dt)
            print(f"K1 n={n:5d} {str(dt):15s} max err {err:.3f} ulp(row max) "
                  f"(tolerance {tol:g})")
            if not err <= tol:
                fail(f"K1 n={n} {dt}: {err} ulps > {tol}")
    x = torch.randn(4, 14336, generator=gen, device="cuda").to(torch.bfloat16)
    plan = plan_for(14336, dtype=torch.bfloat16, backend="cuda", device_type="cuda")
    got = hadamard(x, plan)
    want = hadamard(x, plan_for(14336, dtype=torch.bfloat16, backend="torch",
                                device_type="cuda"))
    torch.cuda.synchronize()
    err = k1_ulps(got.reshape(-1, 2048), want.reshape(-1, 2048), torch.bfloat16)
    print(f"K1 grouped n=14336 (7 x 2048) bf16 max err {err:.3f} ulp (tolerance 1)")
    if not err <= 1.0:
        fail(f"K1 grouped 14336: {err} ulps")

    print("-- kernel phase: K2 fused_dequant against its plain version")
    for n in (128, 2048):
        for mode in ("int8", "fp8_e4m3", "fp8_e5m2"):
            x = (torch.randn(256, n, generator=gen, device="cuda") * 3).to(torch.bfloat16)
            plan = plan_for(n, dtype=torch.bfloat16, backend="cuda",
                            device_type="cuda",
                            epilogue=QuantEpilogue(mode, dequant=True))
            got = fused_dequant(x, plan)
            torch.cuda.synchronize()
            want = fused_dequant_plain(x, plan)
            exc = k2_excess(got, want, x, plan)
            bitwise = bool(torch.equal(got, want))
            print(f"K2 n={n:5d} {mode:9s} error / (grid step x row scale) "
                  f"{exc:.3f} (tolerance 1), bitwise={bitwise}")
            if not exc <= 1.0:
                fail(f"K2 n={n} {mode}: {exc} grid steps")

    print("-- kernel phase: times at the serving path's shapes "
          "(llama3-8b, bf16; decode = one token on each of "
          f"{SLOTS} slots, prefill = {PREFILL_LEN} tokens)")
    entries = {}
    shapes = [  # (kernel, site, rows, n, mode)
        ("K1", "decode down-proj", SLOTS * 7, 2048, None),
        ("K1", "prefill down-proj", PREFILL_LEN * 7, 2048, None),
        ("K2", "decode Q", SLOTS * 32, 128, "fp8_e4m3"),
        ("K2", "decode K", SLOTS * 8, 128, "fp8_e4m3"),
        ("K2", "prefill Q", PREFILL_LEN * 32, 128, "fp8_e4m3"),
        ("K2", "prefill K", PREFILL_LEN * 8, 128, "fp8_e4m3"),
    ]
    for kern, site, rows, n, mode in shapes:
        x = torch.randn(rows, n, generator=gen, device="cuda").to(torch.bfloat16)
        epi = QuantEpilogue(mode, dequant=True) if mode else None
        plan = plan_for(n, dtype=torch.bfloat16, backend="cuda",
                        device_type="cuda", epilogue=epi)
        if kern == "K1":
            run = lambda: transform(x, plan)                       # noqa: E731
            plain = lambda: transform_plain(x, plan)               # noqa: E731
            H = torch.from_numpy(hadamard_matrix(n, 1.0 / math.sqrt(n))).to(
                device="cuda", dtype=torch.bfloat16)
            library = lambda: torch.matmul(x, H)                   # noqa: E731
            ops = rows * n * math.log2(n)
        else:
            run = lambda: fused_dequant(x, plan)                   # noqa: E731
            plain = lambda: fused_dequant_plain(x, plan)           # noqa: E731
            library = None
            ops = rows * n * (math.log2(n) + 6)
        got, want = run(), plain()
        err = float((got.float() - want.float()).abs().max())
        if kern == "K1":
            exc = k1_ulps(got, want, torch.bfloat16)
        else:
            exc = k2_excess(got, want, x, plan)
        if not exc <= 1.0:
            fail(f"{kern} {site}: error {exc} of its tolerance")
        ms = cuda_time_ms(run)
        plain_ms = cuda_time_ms(plain, iters=50)
        library_ms = cuda_time_ms(library) if library else None
        nbytes = 2 * rows * n * IO_BYTES[torch.bfloat16]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_CUDA_CORE_OPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        lib = f"{library_ms:.5f}" if library_ms is not None else "none"
        print(f"{kern} {site:18s} ({rows} x {n}): kernel {ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms, torch.matmul(x, H_n) {lib} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}), max abs err {err:g}")
        if kern not in entries:    # the decode shape: the path's most frequent
            entries[kern] = {"mode": mode, "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": library_ms}
    # device throughput at a size where launch overhead does not dominate
    x = torch.randn(16384, 2048, generator=gen, device="cuda").to(torch.bfloat16)
    plan = plan_for(2048, dtype=torch.bfloat16, backend="cuda", device_type="cuda")
    ms = cuda_time_ms(lambda: transform(x, plan), iters=50)
    print(f"K1 16384 x 2048 bf16 (not a path shape): {ms:.4f} ms, "
          f"{2 * x.numel() * 2 / ms / 1e6:.0f} GB/s of {HBM_BYTES_PER_S / 1e9:.0f}")
    plan = plan_for(128, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                    epilogue=QuantEpilogue("fp8_e4m3", dequant=True))
    x = x.reshape(-1, 128)
    ms = cuda_time_ms(lambda: fused_dequant(x, plan), iters=50)
    print(f"K2 262144 x 128 bf16 fp8_e4m3 (not a path shape): {ms:.4f} ms, "
          f"{2 * x.numel() * 2 / ms / 1e6:.0f} GB/s")
    return entries


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8) if t.element_size() == 1 else t


def _same_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row (last axis), are a and b bitwise equal?"""
    return (_bits(a) == _bits(b)).reshape(a.shape[0], -1).all(-1)


def _rel_rows(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row, the largest |got - want| over the row's largest |want|."""
    rowmax = want.float().abs().amax(-1).clamp_min(1e-30)
    return (got.float() - want.float()).abs().amax(-1) / rowmax


def _k34_input(gen, rows: int, n: int, kind: str) -> torch.Tensor:
    """bf16 rows. 'exact': integers in [-8, 8], on which every sum of the
    rotation is exact in f32 (n <= 8192) whatever its order, so the kernel's
    butterflies and the plain version's cuBLAS products give the same bits.
    'gaussian': N(0, 9), where the two orders can round a sum to the other
    side of a bf16 midpoint."""
    if kind == "exact":
        return torch.randint(-8, 9, (rows, n), generator=gen, device="cuda").to(
            torch.bfloat16)
    return (torch.randn(rows, n, generator=gen, device="cuda") * 3).to(torch.bfloat16)


def hold_k3_k4(gen) -> None:
    """K3 and K4 against their plain versions on both kinds of input.

    A kernel rotates with K1's arithmetic (butterflies); the plain version
    with cuBLAS products. Where the two rotations agree bitwise, K3 must
    give the plain q and s bitwise and K4 (int8) the plain output bitwise;
    on 'exact' inputs they must agree everywhere. On every input the kernel
    must equal the plain epilogue applied to K1's own rotation bitwise (K3,
    K4 int8), so any difference left is the rotation's, which K1's
    tolerance holds. fp8 K4 sums exact products in another order: within
    2^-7 of the row's largest |value| of the plain GEMM on K1's rotation
    (every row), and of the plain version (rows whose rotations agree)."""
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.core.wquant import quantize_weight
    from repro_torch.kernels.fused_quant import fused, fused_plain
    from repro_torch.kernels.hadacore import transform, transform_plain
    from repro_torch.kernels.quant_dot import (epilogue_dot, quant_dot,
                                               quant_dot_plain)
    from repro_torch.kernels.registry import QSPECS, _quantize_rows, cast_to

    print("-- kernel phase: K3 fused (q, scales) against its plain version")
    for n in (128, 2048, 8192):
        for mode in MODES:
            for kind in ("exact", "gaussian"):
                x = _k34_input(gen, 64, n, kind)
                plan = plan_for(n, dtype=torch.bfloat16, backend="cuda",
                                device_type="cuda", epilogue=QuantEpilogue(mode))
                q, sc = fused(x, plan)
                torch.cuda.synchronize()
                qp, sp = fused_plain(x, plan)
                y1 = transform(x, plan_for(n, dtype=torch.bfloat16, backend="cuda",
                                           device_type="cuda"))
                agree = _same_rows(y1, transform_plain(x, plan))
                q1, s1 = _quantize_rows(y1.float(), mode)
                q1 = cast_to(q1, QSPECS[mode][1])
                same = _same_rows(q, qp) & _same_rows(sc, sp)
                own = bool(_same_rows(q, q1).all() and _same_rows(sc, s1).all())
                err = float((q.float() - qp.float()).abs().max())
                print(f"K3 n={n:5d} {mode:9s} {kind:8s}: rows with the plain "
                      f"rotation {int(agree.sum())}/64, bitwise to plain "
                      f"{int(same.sum())}/64, to K1's rotation + plain epilogue "
                      f"{own}, max |dq| {err:g}")
                if not own or not bool(same[agree].all()):
                    fail(f"K3 n={n} {mode} {kind}: q or s differ from the plain "
                         "version beyond the rotation's flips")
                if kind == "exact" and not bool(same.all()):
                    fail(f"K3 n={n} {mode}: exact input not bitwise")

    print("-- kernel phase: K4 quant_dot against its plain version "
          "(phi4-mini down projection and a ragged case)")
    n = PHI4_DOWN[0]
    cpu = torch.Generator().manual_seed(1)
    for m, d in ((SLOTS, PHI4_DOWN[1]), (PREFILL_LEN, PHI4_DOWN[1]), (5, 3000)):
        w = (torch.randn(n, d, generator=cpu) / math.sqrt(n)).to("cuda", torch.bfloat16)
        for mode in MODES:
            qt = quantize_weight(w, mode)
            plan = plan_for(n, dtype=torch.bfloat16, backend="cuda",
                            device_type="cuda", epilogue=QuantEpilogue(mode))
            for kind in ("exact", "gaussian"):
                x = _k34_input(gen, m, n, kind)
                got = quant_dot(x, qt.q, qt.scale, plan)
                torch.cuda.synchronize()
                y1, (q1, s1) = _k1_epilogue(x, plan)
                agree = _same_rows(y1, transform_plain(x, plan))
                from_k1 = epilogue_dot(q1, s1, qt.q, qt.scale, mode, torch.bfloat16)
                _hold_rows(f"K4 {m:2d} x {n} -> {d} {mode:9s} {kind:8s}", got,
                           quant_dot_plain(x, qt.q, qt.scale, plan), from_k1, agree,
                           mode, kind == "exact")


def time_k3_k4(gen) -> dict:
    """K3 and K4 at phi4-mini's shapes, CUDA events, beside their bounds,
    their plain versions and (K4) ``torch._int_mm`` on the already-quantized
    operand: the contraction alone, since no single PyTorch call computes
    rotate + quantize + GEMM. K3 has no library counterpart. The JSON
    entries take the decode shape, with the largest |kernel - plain| there
    (K3: in q's grid units)."""
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.core.wquant import quantize_weight
    from repro_torch.kernels.fused_quant import fused, fused_plain
    from repro_torch.kernels.quant_dot import launch_shape, quant_dot, quant_dot_plain
    from repro_torch.kernels.registry import _quantize_rows

    n, d = PHI4_DOWN
    print("-- kernel phase: K3 and K4 times at phi4-mini's down projection "
          f"(bf16 activations, int8; decode = {SLOTS} rows, prefill = "
          f"{PREFILL_LEN})")
    entries = {}
    w = (torch.randn(n, d, generator=gen, device="cuda") / math.sqrt(n)).to(torch.bfloat16)
    qt = quantize_weight(w, "int8")
    plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                    epilogue=QuantEpilogue("int8"))
    for m in (SLOTS, PREFILL_LEN):
        x = (torch.randn(m, n, generator=gen, device="cuda") * 3).to(torch.bfloat16)
        # K4
        run = lambda: quant_dot(x, qt.q, qt.scale, plan)             # noqa: E731
        plain = lambda: quant_dot_plain(x, qt.q, qt.scale, plan)     # noqa: E731
        q, _ = _quantize_rows(x.float(), "int8")
        a = torch.zeros(max(32, m), n, dtype=torch.int8, device="cuda")
        a[:m] = q.to(torch.int8)
        library = lambda: torch._int_mm(a, qt.q)                     # noqa: E731
        err = float((run().float() - plain().float()).abs().max())
        ms, plain_ms, lib_ms = (cuda_time_ms(run), cuda_time_ms(plain, iters=50),
                                cuda_time_ms(library))
        nbytes = m * n * 2 + n * d + d * 4 + m * d * 2
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (2 * m * n * d / INT8_OPS_PER_S
                 + m * n * (math.log2(n) + 6) / F32_CUDA_CORE_OPS_PER_S) * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        bm, smem, blocks = launch_shape(m, n, d, "int8")
        print(f"K4 {m:2d} x {n} -> {d}: max abs err {err:g}, kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              f"torch._int_mm (contraction only) {lib_ms:.5f} ms, bound {bound:.6f} ms "
              f"({by}); launch: {blocks} blocks of {bm} rows, {smem} B shared")
        if "K4" not in entries:   # the decode shape: the path's most frequent
            entries["K4"] = {"mode": "int8", "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms,
                             "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
        # K3 on the same rows
        run = lambda: fused(x, plan)                                 # noqa: E731
        plain = lambda: fused_plain(x, plan)                         # noqa: E731
        (q, sc), (qp, sp) = run(), plain()
        err = max(float((q.float() - qp.float()).abs().max()),
                  float((sc - sp).abs().max()))
        ms, plain_ms = cuda_time_ms(run), cuda_time_ms(plain, iters=50)
        nbytes = m * n * 2 + m * n + m * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = m * n * (math.log2(n) + 6) / F32_CUDA_CORE_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"K3 {m:2d} x {n}: max abs err {err:g}, kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              f"library none, bound {bound:.6f} ms ({by})")
        if "K3" not in entries:
            entries["K3"] = {"mode": "int8", "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms,
                             "bound_ms": bound, "bound_by": by, "library_ms": None}
    # device throughput at a size where launch overhead does not dominate
    x = (torch.randn(1024, n, generator=gen, device="cuda") * 3).to(torch.bfloat16)
    ms = cuda_time_ms(lambda: quant_dot(x, qt.q, qt.scale, plan), iters=20)
    print(f"K4 1024 x {n} -> {d} int8 (not a path shape): {ms:.4f} ms, "
          f"{2 * 1024 * n * d / ms / 1e9:.1f} TOP/s")
    return entries


def _expert_weights(gen, n: int, d: int, mode: str):
    """(EXPERTS, n, d) expert weights ~ N(0, 1/n) in bf16, drawn and
    quantized per (expert, out-channel) 8 experts at a time on the card."""
    from repro_torch.core.wquant import QTensor, quantize_weight
    from repro_torch.kernels.registry import QSPECS

    q = torch.empty((EXPERTS, n, d), dtype=QSPECS[mode][1], device="cuda")
    sc = torch.empty((EXPERTS, 1, d), dtype=torch.float32, device="cuda")
    for i in range(0, EXPERTS, 8):
        w = (torch.randn((8, n, d), generator=gen, device="cuda") / math.sqrt(n)).to(
            torch.bfloat16)
        qt = quantize_weight(w, mode)
        q[i:i + 8], sc[i:i + 8] = qt.q, qt.scale
    return QTensor(q, sc, mode)


def _k1_epilogue(x2, plan):
    """The plain epilogue on K1's own rotation of the rows x2: (q, s)."""
    from repro_torch.core.api import plan_for
    from repro_torch.kernels.hadacore import transform
    from repro_torch.kernels.registry import _quantize_rows

    y1 = transform(x2, plan_for(plan.n, dtype=x2.dtype, backend="cuda",
                                device_type="cuda"))
    return y1, _quantize_rows(y1.float(), plan.epilogue.mode)


def _hold_rows(tag, got, want, from_k1, agree, mode, exact) -> None:
    """The K4 rule on rows: int8 bitwise to the plain GEMM on K1's own
    rotation in every row, to the plain version where the two rotations
    agree (everywhere on exact inputs); fp8 within 2^-7 of the row max of
    both (the plain version where the rotations agree)."""
    same = _same_rows(got, want)
    own = bool(_same_rows(got, from_k1).all())
    rel_k1 = float(_rel_rows(got, from_k1).max())
    rel = _rel_rows(got, want)
    rel_agree = float(rel[agree].max()) if bool(agree.any()) else 0.0
    print(f"{tag}: rows with the plain rotation {int(agree.sum())}/{len(agree)}, bitwise "
          f"to plain {int(same.sum())}/{len(agree)}, to K1's rotation + plain GEMM "
          f"{own}; max |d| / row max {rel_k1:.3e} against K1's rotation + plain "
          f"GEMM, {rel_agree:.3e} against plain where the rotations agree")
    if mode == "int8":
        if not own or not bool(same[agree].all()):
            fail(f"{tag}: not bitwise beyond the rotation's flips")
        if exact and not bool(same.all()):
            fail(f"{tag}: exact input not bitwise")
    elif not (rel_k1 <= 2.0 ** -7 and rel_agree <= 2.0 ** -7):
        fail(f"{tag}: beyond 2^-7 of the row max")


def hold_k5_k6(gen) -> None:
    """K5, K6 and K6s at llama4-maverick's shapes, int8 and fp8_e4m3, on
    exact-sum and Gaussian rows.

    Dense (K4 / K5), 4 and 64 x 8192 -> 5120: K5 equals K4 bitwise, and
    both follow the K4 rule against the plain version (``_hold_rows``).
    Experts (K6 / K6s), (4, 128, 1, 8192) and (1, 128, 1, 8192) -> 5120
    against 128 experts, every third expert's rows all zero (the dense
    dispatch sends zero rows to most experts): K6s equals K6 bitwise; K6 on
    expert e equals K4 on expert e's rows and weight bitwise; the zero rows
    give exact zeros; and K6 follows the K4 rule against its plain
    version, which contracts one expert at a time."""
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.core.wquant import quantize_weight
    from repro_torch.kernels.hadacore import transform_plain
    from repro_torch.kernels.quant_dot import (epilogue_dot, experts_epilogue_dot,
                                               quant_dot, quant_dot_experts,
                                               quant_dot_experts_plain,
                                               quant_dot_plain)

    n, d = MAVERICK_DOWN
    print("-- kernel phase: K5, K6 and K6s against K4, their plain versions and "
          f"each other (llama4-maverick's down projections, {n} -> {d}, "
          f"{EXPERTS} experts)")
    cpu = torch.Generator().manual_seed(2)
    for mode in ("int8", "fp8_e4m3"):
        plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                        epilogue=QuantEpilogue(mode))
        w = (torch.randn(n, d, generator=cpu) / math.sqrt(n)).to("cuda", torch.bfloat16)
        qt = quantize_weight(w, mode)
        for m in (SLOTS, PREFILL_LEN):
            for kind in ("exact", "gaussian"):
                x = _k34_input(gen, m, n, kind)
                k4 = quant_dot(x, qt.q, qt.scale, plan, "rotate_once")
                k5 = quant_dot(x, qt.q, qt.scale, plan, "streamed")
                torch.cuda.synchronize()
                same45 = bool(_same_rows(k5, k4).all())
                y1, (q1, s1) = _k1_epilogue(x, plan)
                agree = _same_rows(y1, transform_plain(x, plan))
                from_k1 = epilogue_dot(q1, s1, qt.q, qt.scale, mode, torch.bfloat16)
                print(f"K5 {m:2d} x {n} -> {d} {mode:8s} {kind:8s}: bitwise to K4 {same45}")
                if not same45:
                    fail(f"K5 {m}x{n}->{d} {mode} {kind}: differs from K4")
                _hold_rows(f"K5 {m:2d} x {n} -> {d} {mode:8s} {kind:8s}", k5,
                           quant_dot_plain(x, qt.q, qt.scale, plan), from_k1, agree,
                           mode, kind == "exact")
        del w, qt
        ex = _expert_weights(gen, n, d, mode)
        for bt in (SLOTS, 1):
            for kind in ("exact", "gaussian"):
                x = _k34_input(gen, bt * EXPERTS, n, kind).view(bt, EXPERTS, 1, n)
                x[:, ::3] = 0
                k6 = quant_dot_experts(x, ex.q, ex.scale, plan, "rotate_once")
                k6s = quant_dot_experts(x, ex.q, ex.scale, plan, "streamed")
                k4 = torch.stack([quant_dot(x[:, e, 0], ex.q[e], ex.scale[e], plan)
                                  for e in range(EXPERTS)], 1)[:, :, None]
                torch.cuda.synchronize()
                tag = f"K6 ({bt}, {EXPERTS}, 1, {n}) -> {d} {mode:8s} {kind:8s}"
                same6s = bool(torch.equal(_bits(k6s), _bits(k6)))
                same64 = bool(torch.equal(_bits(k4), _bits(k6)))
                zeros = bool((k6[:, ::3] == 0).all() and (k6s[:, ::3] == 0).all())
                print(f"{tag}: K6s bitwise to K6 {same6s}, K6 bitwise to K4 per "
                      f"expert {same64}, zero rows exact zeros {zeros}")
                if not (same6s and same64 and zeros):
                    fail(f"{tag}: K6s == K6 {same6s}, K6 == K4 {same64}, zeros {zeros}")
                x2 = x.reshape(-1, n)
                y1, (q1, s1) = _k1_epilogue(x2, plan)
                agree = _same_rows(y1, transform_plain(x2, plan))
                from_k1 = experts_epilogue_dot(q1.view(*x.shape), s1.view(*x.shape[:-1], 1),
                                               ex.q, ex.scale, mode, torch.bfloat16)
                want = quant_dot_experts_plain(x, ex.q, ex.scale, plan)
                _hold_rows(tag, k6.reshape(-1, d), want.reshape(-1, d),
                           from_k1.reshape(-1, d), agree, mode, kind == "exact")
        del ex
        torch.cuda.empty_cache()


def _bound(nbytes: float, int_ops: float, f32_ops: float, low_rate: float):
    """(bound ms, 'bytes' or 'operations'): the larger of the bytes over
    the HBM rate and the operations over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (int_ops / low_rate + f32_ops / F32_CUDA_CORE_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _profile_ms(fn, name: str, streamed: bool, calls: int = 5) -> float:
    """Device time per call of the quant_dot kernel ``name`` of the
    schedule (the last template argument of its name), from
    ``torch.profiler`` over ``calls`` calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if (evt.device_type == DeviceType.CUDA and f"{name}<" in evt.key
                and (", true>" in evt.key) == streamed):
            dev = getattr(evt, "self_device_time_total", None)
            total += evt.self_cuda_time_total if dev is None else dev
    return total / calls / 1e3


def _library_dot(x, wq, sw, mode: str, experts: bool):
    """One PyTorch library call per weight matrix (per expert for the
    expert form) that contracts the already-quantized rows of x with wq:
    ``torch._int_mm`` for int8, ``torch._scaled_mm`` with row-wise scales
    for fp8_e4m3. The contraction alone, since no PyTorch call rotates,
    quantizes and contracts. Returns (call, its name)."""
    from repro_torch.kernels.registry import QSPECS, _quantize_rows, cast_to

    n = x.shape[-1]
    m = x.shape[0]
    E = wq.shape[0] if experts else 1
    w = wq if experts else wq[None]
    q, s = _quantize_rows(x.reshape(-1, n).float(), mode)
    if mode == "int8":
        per = max(32, m)      # _int_mm wants more than 16 rows
        a = torch.zeros(E, per, n, dtype=torch.int8, device="cuda")
        a[:, :m] = q.to(torch.int8).view(m, E, n).transpose(0, 1)
        return (lambda: [torch._int_mm(a[e], w[e]) for e in range(E)]), "torch._int_mm"
    per = -(-m // 16) * 16    # _scaled_mm wants rows in multiples of 16
    a = torch.zeros(E, per, n, dtype=QSPECS[mode][1], device="cuda")
    a[:, :m] = cast_to(q, QSPECS[mode][1]).view(m, E, n).transpose(0, 1)
    sa = torch.ones(E, per, 1, device="cuda")
    sa[:, :m] = s.view(m, E, 1).transpose(0, 1)
    wt = w.transpose(1, 2).contiguous()     # column-major (n, d) per expert
    sb = sw.reshape(E, 1, -1).contiguous()
    return (lambda: [torch._scaled_mm(a[e], wt[e].t(), scale_a=sa[e], scale_b=sb[e],
                                      out_dtype=torch.bfloat16)
                     for e in range(E)]), "torch._scaled_mm"


def time_k5_k6(gen) -> dict:
    """K4, K5, K6 and K6s at llama4-maverick's decode and prefill shapes,
    fp8_e4m3 (the path's mode) and int8, Gaussian rows in every expert (so
    the whole weight is needed): CUDA events and a profile per kernel,
    beside the bound, the plain version and one library contraction per
    weight matrix on the already-quantized operand (``_library_dot``). The
    JSON entries take the fp8_e4m3 decode shape, every field of an entry
    from that run."""
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.core.wquant import quantize_weight
    from repro_torch.kernels.quant_dot import (launch_shape, quant_dot,
                                               quant_dot_experts,
                                               quant_dot_experts_plain,
                                               quant_dot_plain)

    n, d = MAVERICK_DOWN
    print("-- kernel phase: K4, K5, K6 and K6s times at llama4-maverick's down "
          f"projections (bf16 activations; decode = {SLOTS} rows, prefill = "
          f"{PREFILL_LEN}; experts: {SLOTS} and 1 rows per expert, {EXPERTS} experts)")
    entries = {}
    for mode in ("int8", "fp8_e4m3"):
        low = INT8_OPS_PER_S if mode == "int8" else FP8_OPS_PER_S
        plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                        epilogue=QuantEpilogue(mode))
        qt = quantize_weight((torch.randn(n, d, generator=gen, device="cuda")
                              / math.sqrt(n)).to(torch.bfloat16), mode)
        ex = _expert_weights(gen, n, d, mode)
        cases = [("K4", "rotate_once", m) for m in (SLOTS, PREFILL_LEN)]
        cases += [("K5", "streamed", m) for m in (SLOTS, PREFILL_LEN)]
        cases += [("K6", "rotate_once", bt) for bt in (SLOTS, 1)]
        cases += [("K6s", "streamed", bt) for bt in (SLOTS, 1)]
        for kern, sched, m in cases:
            experts = kern.startswith("K6")
            rows = m * EXPERTS if experts else m
            x = (torch.randn(rows, n, generator=gen, device="cuda") * 3).to(torch.bfloat16)
            if experts:
                x = x.view(m, EXPERTS, 1, n)
                run = lambda: quant_dot_experts(x, ex.q, ex.scale, plan, sched)  # noqa: E731
                plain = lambda: quant_dot_experts_plain(x, ex.q, ex.scale, plan)  # noqa: E731
                wbytes = ex.q.numel() + ex.scale.numel() * 4
                key = "quant_dot_experts_kernel"
            else:
                run = lambda: quant_dot(x, qt.q, qt.scale, plan, sched)       # noqa: E731
                plain = lambda: quant_dot_plain(x, qt.q, qt.scale, plan)      # noqa: E731
                wbytes = qt.q.numel() + qt.scale.numel() * 4
                key = "quant_dot_kernel"
            err = float((run().float() - plain().float()).abs().max())
            ms = cuda_time_ms(run, iters=20 if experts else 200)
            dev_ms = _profile_ms(run, key, sched == "streamed")
            plain_ms = cuda_time_ms(plain, iters=3 if experts else 20, warmup=1)
            lib, lib_name = (_library_dot(x, ex.q, ex.scale, mode, True) if experts
                              else _library_dot(x, qt.q, qt.scale, mode, False))
            lib_ms = cuda_time_ms(lib, iters=10 if experts else 200)
            del lib
            bound, by = _bound(2 * rows * n + wbytes + 2 * rows * d, 2 * rows * n * d,
                               rows * n * (math.log2(n) + 6), low)
            bm, smem, blocks = launch_shape(m, n, d, mode, EXPERTS if experts else 0,
                                            sched)
            print(f"{kern:3s} {mode:8s} {tuple(x.shape)} -> {d}: max abs err {err:g}, "
                  f"kernel {ms:.5f} ms (events), {dev_ms:.5f} ms (profile), plain "
                  f"{plain_ms:.5f} ms, {lib_name} {lib_ms:.5f} ms, bound {bound:.6f} "
                  f"ms ({by}); launch: {blocks} blocks of {bm} rows, {smem} B shared")
            if mode == "fp8_e4m3" and m == SLOTS:   # the decode shape, the path's mode
                entries[kern] = {"mode": mode, "max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": bound,
                                 "bound_by": by, "library_ms": lib_ms}
        del ex, qt
        torch.cuda.empty_cache()
    entries.pop("K4")      # K4's entry is phi4-mini's (time_k3_k4)
    return entries


def entry_point_phase(gen) -> dict:
    """The library's own entry points on CUDA tensors: each
    ``hadamard(x, epilogue=QuantEpilogue(mode))`` is one K3 launch and each
    ``quant_dot`` one K4 launch; neither launches K1. Returns the launch
    counts of the phase (counters zeroed just before)."""
    from repro_torch.core.api import QuantEpilogue, hadamard, quant_dot
    from repro_torch.core.wquant import quantize_weight
    from repro_torch.kernels.fused_quant import fused_cuda
    from repro_torch.kernels.hadacore import hadacore_cuda
    from repro_torch.kernels.quant_dot import quant_dot_cuda

    n, d = PHI4_DOWN
    x = (torch.randn(PREFILL_LEN, n, generator=gen, device="cuda") * 3).to(torch.bfloat16)
    weights = {mode: quantize_weight(
        torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16), mode)
        for mode in MODES}
    hadacore_cuda.launches = fused_cuda.launches = quant_dot_cuda.launches = 0
    for mode in MODES:
        q, sc = hadamard(x, epilogue=QuantEpilogue(mode))
        out = quant_dot(x, weights[mode], mode=mode)
    torch.cuda.synchronize()
    got = {"K1": hadacore_cuda.launches, "K3": fused_cuda.launches,
           "K4": quant_dot_cuda.launches}
    print(f"-- entry points: 3 x hadamard(x, epilogue=QuantEpilogue(mode)) and 3 x "
          f"quant_dot on {tuple(x.shape)} bf16: launches {got}")
    if got != {"K1": 0, "K3": 3, "K4": 3}:
        fail(f"entry points launched {got}, expected K3 3, K4 3, K1 0")
    if not (torch.isfinite(sc).all() and torch.isfinite(out.float()).all()
            and q.shape == x.shape and out.shape == (PREFILL_LEN, d)):
        fail("entry points gave non-finite or misshapen results")
    return got


# The model-phase limits on the relative RMS difference of the prefill
# logits (all 64 positions) between the kernels and the plain versions, at
# depth 1 (the first layer alone, then the head) and at full depth, per
# model (a MoE model's with routing pinned to the plain run's). Each sits
# near the geometric mean of the largest reading of the kernels and the
# witnesses (correct paths that differ from the plain one as the kernels
# may) and the smallest reading of the controls (paths with a known fault)
# on an H100 (PERF.md); the run re-measures all of them and re-asserts the
# order.
PREFILL_LIMITS = {
    "llama3-8b": {1: 3e-3, 32: 0.045},
    "phi4-mini-3.8b": {1: 3e-3, 32: 0.0275},
    # depth 2 is the first (dense, MoE) pair, 4 the whole cut model
    "llama4-maverick-400b-a17b": {2: 0.03, 4: 0.044},
}


def _calibration_backends():
    """Registers (once) the backends that calibrate the prefill limit; the
    model reaches them through ``REPRO_HADAMARD_BACKEND``.

    The witness, a correct path that differs from the plain one as the
    kernels may:

      k1_rotations   every site rotates with K1 (butterflies, the kernels'
                     summation order) and applies the plain epilogue, and
                     the down projections contract with the plain GEMM:
                     the kernels' arithmetic up to the fp8 GEMM's summation
                     order, without K2-K6

    The controls, paths with a known fault:

      k2_no_quant    the Q/K sites rotate but skip the fake-quant (K2
                     without its epilogue)
      k1_exact_scale every rotation runs its passes unscaled and applies
                     the exact f32 1/sqrt(n) at the end, instead of folding
                     the compute-dtype-rounded scale into pass 0
      k4_no_rotate   the fused down projection quantizes and contracts the
                     unrotated row (K4 without its rotation)
      k6_no_rotate   the fused expert down projection does the same (K6
                     without its rotation); every other site is plain
    """
    import functools

    from repro_torch.core.hadamard import (_apply_passes, base_matrices_np,
                                           torch_dtype)
    from repro_torch.kernels import registry
    from repro_torch.kernels.fused_quant import fused_dequant_plain
    from repro_torch.core.api import plan_for
    from repro_torch.kernels.hadacore import transform, transform_plain
    from repro_torch.kernels.quant_dot import (epilogue_dot, experts_epilogue_dot,
                                               quant_dot_plain)

    if "k2_no_quant" in registry.available_backends():
        return

    class Calibration(registry.Backend):
        priority = -1

        def auto_on(self, device_type):
            return False

        def supports(self, p):
            return True

    @registry.register_backend
    class K2NoQuant(Calibration):
        name = "k2_no_quant"

        def transform(self, x, plan, in_place=False):
            return transform_plain(x, plan)

        def fused_dequant(self, x, plan):
            return transform_plain(x, plan)

    def k1_rows(x, plan):
        """K1's rotation of x, then the plain per-token quantization."""
        y = transform(x.to(torch_dtype(plan.compute_dtype)),
                      plan_for(plan.p, dtype=torch_dtype(plan.compute_dtype),
                               backend="cuda", device_type="cuda"))
        return registry._quantize_rows(y.float(), plan.epilogue.mode)

    @registry.register_backend
    class K1Rotations(Calibration):
        name = "k1_rotations"

        def transform(self, x, plan, in_place=False):
            return transform(x, plan, in_place)

        def fused_dequant(self, x, plan):
            q, s = k1_rows(x, plan)
            return registry._dequantize(q, s, plan.epilogue.mode).to(x.dtype)

        def quant_dot(self, x, wq, sw, plan, schedule=None):
            q, s = k1_rows(x, plan)
            return epilogue_dot(q, s, wq, sw.reshape(1, -1), plan.epilogue.mode,
                                x.dtype)

        def quant_dot_experts(self, x, wq, sw, plan, schedule=None):
            q, s = k1_rows(x, plan)
            return experts_epilogue_dot(q, s, wq, sw, plan.epilogue.mode, x.dtype)

    @functools.lru_cache(maxsize=None)
    def unscaled_mats(p, device):
        return [torch.from_numpy(m).to(device) for m in base_matrices_np(p, None)]

    @registry.register_backend
    class K1ExactScale(Calibration):
        name = "k1_exact_scale"

        def transform(self, x, plan, in_place=False):
            cd = torch_dtype(plan.compute_dtype)
            y = _apply_passes(x.to(cd).reshape(-1, plan.p), plan.p,
                              unscaled_mats(plan.p, x.device))
            return (y.float() * (1.0 / math.sqrt(plan.p))).to(x.dtype).reshape(
                x.shape)

    @registry.register_backend
    class K4NoRotate(Calibration):
        name = "k4_no_rotate"

        def transform(self, x, plan, in_place=False):
            return transform_plain(x, plan)

        def fused_dequant(self, x, plan):
            return fused_dequant_plain(x, plan)

        def quant_dot(self, x, wq, sw, plan, schedule=None):
            mode = plan.epilogue.mode
            q, s = registry._quantize_rows(x.float(), mode)
            return epilogue_dot(q, s, wq, sw.reshape(1, -1), mode, x.dtype)

    @registry.register_backend
    class K6NoRotate(Calibration):
        name = "k6_no_rotate"

        def transform(self, x, plan, in_place=False):
            return transform_plain(x, plan)

        def fused_dequant(self, x, plan):
            return fused_dequant_plain(x, plan)

        def quant_dot(self, x, wq, sw, plan, schedule=None):
            return quant_dot_plain(x, wq, sw, plan)

        def quant_dot_experts(self, x, wq, sw, plan, schedule=None):
            mode = plan.epilogue.mode
            q, s = registry._quantize_rows(x.float(), mode)
            return experts_epilogue_dot(q, s, wq, sw, mode, x.dtype)


class _one_flip:
    """A context in which the first MLP output (layer 0) has its largest
    value moved by 1 ulp: the smallest change a rounding can make to the
    residual stream that every later layer reads. (A flip inside a rotation
    is mostly absorbed by the quantization step of the site after it.)"""

    def __enter__(self):
        from repro_torch.models import mlp

        self.mlp, self.apply = mlp, mlp.apply_mlp
        armed = [True]

        def apply_mlp(cfg, p, x):
            y = self.apply(cfg, p, x).contiguous()
            if armed[0]:
                flat = y.view(-1)
                flat.view(torch.int16)[int(flat.float().abs().argmax())] ^= 1
                armed[0] = False
            return y

        mlp.apply_mlp = apply_mlp

    def __exit__(self, *exc):
        self.mlp.apply_mlp = self.apply


def _with_backend(cfg, quant, backend: str):
    import dataclasses

    return cfg.with_quant(dataclasses.replace(quant, backend=backend))


def trace_layer0(cfg, params, quant, prompt) -> None:
    """Which layer-0 stage first differs between the kernels and the plain
    versions, and by how many elements: the prompt runs through layer 0
    once with the kernels and once with the plain versions, recording each
    rotation site (Q, K, V) and the down projection in call order. For every
    site it prints how many output elements differ between the two runs and
    how many the site itself makes differ (the plain version of the site on
    the kernel run's own input); the first site whose own count is not 0 is
    where the difference is born."""
    import dataclasses

    from repro_torch.core import api
    from repro_torch.models.lm import lm_forward

    records = {}
    rot_call, qd_apply = api.RotationSpec.__call__, api.QuantDotSpec._apply_qtensor

    def rot(spec, x):
        y = rot_call(spec, x)
        name = ("Q", "K")[sum(1 for k in records[run] if k[0] in "QK") % 2] \
            if spec.rotate else "V"
        records[run].append((name, spec, None, x, y))
        return y

    def down(spec, w, x):
        y = qd_apply(spec, w, x)
        records[run].append(("down-proj", spec, w, x, y))
        return y

    p0 = dict(params, layers=params["layers"][:1])
    api.RotationSpec.__call__, api.QuantDotSpec._apply_qtensor = rot, down
    try:
        for run in ("cuda", "torch"):
            records[run] = []
            with torch.inference_mode():
                lm_forward(_with_backend(cfg, quant, run), p0, {"tokens": prompt})
    finally:
        api.RotationSpec.__call__, api.QuantDotSpec._apply_qtensor = rot_call, qd_apply
    first = None
    for (name, spec, w, x, y), (_, _, _, _, yp) in zip(records["cuda"], records["torch"]):
        plain = dataclasses.replace(spec, backend="torch")
        with torch.inference_mode():
            own = rot_call(plain, x) if w is None else qd_apply(plain, w, x)
        diff = int((_bits(y) != _bits(yp)).sum())
        born = int((_bits(y) != _bits(own)).sum())
        if first is None and born:
            first = name
        inside = ""
        if w is not None:   # the down projection's rotation, kernel vs plain
            with torch.inference_mode():
                yk, yq = (api.hadamard(x, dataclasses.replace(spec, backend=b)
                                       ._transform_plan(x.dtype, "cuda"))
                          for b in ("cuda", "torch"))
            flips = _bits(yk) != _bits(yq)
            inside = (f"; its rotation: {int(flips.sum())} of {yk.numel()} bf16 "
                      f"values differ, in {int(flips.reshape(-1, yk.shape[-1]).any(-1).sum())}"
                      f" of {yk.numel() // yk.shape[-1]} rows")
        print(f"   layer 0 {name:9s} {tuple(y.shape)}: {diff} of {y.numel()} "
              f"elements differ from the plain run, {born} made by the site"
              + inside)
    print(f"   first stage where the kernels differ: {first or 'none'}")


def hold_prefill_against_plain(cfg, params, quant, seed: int, controls) -> None:
    """One 64-token prompt through the kernels, the plain versions, the
    witnesses and the controls, at each depth of the model's limits. The
    kernels' difference from the plain versions must stay within the limit,
    every witness's too, and every control's beyond it. Prints every
    reading before it checks any.

    In a MoE model every held run routes each token to the experts the
    plain run chose (``_routing``; the gate values stay the run's own):
    with one capacity slot per expert a near-tie flip moves whole tokens
    between experts and drops others, a jump no rounding bound covers. The
    unpinned kernel and ``k1_rotations`` runs are then read as well, with
    the tokens whose top-1 expert differs and their gate margins."""
    import contextlib

    from repro_torch.kernels.registry import BACKEND_ENV_VAR
    from repro_torch.models.lm import lm_forward

    _calibration_backends()
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))).cuda()
    trace_layer0(cfg, params, quant, prompt)
    named = {b: _with_backend(cfg, quant, b) for b in ("cuda", "torch", "auto")}

    def logits(route, depth, routing):
        p = dict(params, layers=params["layers"][:depth])
        if route in ("cuda", "torch", "one_flip"):
            c = named["torch" if route == "one_flip" else route]
        else:
            c = named["auto"]
            os.environ[BACKEND_ENV_VAR] = route
        flip = _one_flip() if route == "one_flip" else contextlib.nullcontext()
        try:
            with torch.inference_mode(), flip, routing:
                out = lm_forward(c, p, {"tokens": prompt})[0]
        finally:
            os.environ.pop(BACKEND_ENV_VAR, None)
        out = out[..., :cfg.vocab_size].float()
        if not torch.isfinite(out).all():
            fail(f"non-finite prefill logits ({route}, depth {depth})")
        return out

    def read(depth, route, got, plain, pinned):
        r = float((got - plain).norm() / plain.norm())
        top1 = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
        print(f"prefill depth {depth:2d}, {route:14s} vs plain{pinned}: relative "
              f"RMS {r:.6f}, max |dlogit| {float((got - plain).abs().max()):.5f} "
              f"of {float(plain.abs().max()):.3f}, top-1 {top1 * 100:.1f}%")
        return r

    witnesses = ("one_flip", "k1_rotations")
    limits = PREFILL_LIMITS[cfg.name]
    moe = bool(cfg.num_experts)
    pinned = ", routing pinned" if moe else ""
    rel = {}
    for depth in sorted(limits):
        plain_routing = _routing()
        plain = logits("torch", depth, plain_routing)
        for route in ("cuda",) + witnesses + controls:
            got = logits(route, depth, _routing(plain_routing.experts))
            rel[depth, route] = read(depth, route, got, plain, pinned)
        for route in ("cuda", "k1_rotations") if moe else ():
            free = _routing()
            read(depth, route, logits(route, depth, free), plain, "")
            routing_flips(free, plain_routing)
    for depth in sorted(limits):
        limit = limits[depth]
        print(f"prefill depth {depth:2d}: limit {limit:g}{pinned}")
        for route in ("cuda",) + witnesses:
            if not rel[depth, route] <= limit:
                fail(f"prefill depth {depth}: {route} at {rel[depth, route]} "
                     f"> {limit}")
        for route in controls:
            if not rel[depth, route] > limit:
                fail(f"prefill depth {depth}: control {route} at "
                     f"{rel[depth, route]} passes the limit {limit}")


class _routing:
    """A context that records, per call of ``apply_moe`` (one per MoE
    layer, in order), the router gates (B, S, E) and the top-k experts
    (B, S, K) the layer chose. Given ``pin`` (another run's ``experts``),
    call i routes to ``pin[i]`` instead, with its own gate values there.
    It swaps ``torch.topk`` for the duration of each ``apply_moe`` call,
    which calls it once, on the gates."""

    def __init__(self, pin=None):
        self.pin, self.gates, self.experts = pin, [], []

    def __enter__(self):
        from repro_torch.models import mlp

        self.mlp, self.apply = mlp, mlp.apply_moe
        topk = torch.topk

        def route(gates, k, dim=-1):
            i = len(self.gates)
            idx = topk(gates, k, dim=dim).indices if self.pin is None else self.pin[i]
            self.gates.append(gates)
            self.experts.append(idx)
            return gates.gather(dim, idx), idx

        def apply_moe(cfg, p, x):
            torch.topk = route
            try:
                return self.apply(cfg, p, x)
            finally:
                torch.topk = topk

        mlp.apply_moe = apply_moe
        return self

    def __exit__(self, *exc):
        self.mlp.apply_moe = self.apply


def routing_flips(got, plain) -> None:
    """Per MoE layer, the tokens whose top-1 expert differs between the
    run ``got`` and the plain run (two ``_routing`` records), each with its
    top-1/top-2 gate margin in the plain run."""
    for layer, (g, p) in enumerate(zip(got.gates, plain.gates)):
        flips = (g.argmax(-1) != p.argmax(-1)).reshape(-1)
        top2 = p.reshape(-1, p.shape[-1]).topk(2, -1).values
        margin = (top2[:, 0] - top2[:, 1])[flips]
        print(f"   MoE layer {layer}: {int(flips.sum())} of {flips.numel()} tokens "
              "route to another top-1 expert than in the plain run"
              + (", gate margins " + ", ".join(f"{float(v):.2e}" for v in margin)
                 if bool(flips.any()) else ""))


def _counters():
    from repro_torch.kernels.fused_quant import fused_cuda, fused_dequant_cuda
    from repro_torch.kernels.hadacore import hadacore_cuda
    from repro_torch.kernels.quant_dot import (quant_dot_cuda,
                                               quant_dot_experts_cuda,
                                               quant_dot_experts_streamed_cuda,
                                               quant_dot_streamed_cuda)

    return {"K1": hadacore_cuda, "K2": fused_dequant_cuda, "K3": fused_cuda,
            "K4": quant_dot_cuda, "K5": quant_dot_streamed_cuda,
            "K6": quant_dot_experts_cuda, "K6s": quant_dot_experts_streamed_cuda}


# The models served, each with its quantization, the launches one model
# pass must make (every kernel not named: 0), the controls of its prefill
# check, and (maverick) the depth it is cut to.
MODELS = {
    "llama3-8b": dict(mode="fp8_e4m3", per_pass={"K1": 32, "K2": 64},
                      controls=("k2_no_quant", "k1_exact_scale")),
    "phi4-mini-3.8b": dict(mode="int8", per_pass={"K2": 64, "K4": 32},
                           controls=("k4_no_rotate", "k2_no_quant")),
    # 2 of the 24 (attn, moe) groups: 4 of 48 layers, ~35 GB of int8 / fp8
    # weights; all 48 would take ~390 GB, beyond one 80 GB card
    "llama4-maverick-400b-a17b": dict(
        mode="fp8_e4m3", per_pass={"K2": 8, "K4": 4, "K6": 2},
        controls=("k6_no_rotate", "k4_no_rotate", "k2_no_quant"),
        groups=((("attn", "moe"), 2),)),
}
PEAK_LIMIT = 72e9   # bytes: "well under" the card's 80 GB


def model_phase(args, arch: str):
    """One model at full width and depth: the layer-0 stage trace and the
    calibrated prefill check, then the serving run with the launch counters
    zeroed just before and read just after, then a decode profile. Returns
    (summary, launches)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.lm import init_lm
    from repro_torch.serving import ServeEngine, synthetic_stream

    spec = MODELS[arch]
    quant = QuantConfig(mode=spec["mode"], rotate="hadamard", backend="cuda",
                        kv_quant=True)
    full = get_config(arch)
    cfg = dataclasses.replace(full.with_quant(quant), weight_quant="int8",
                              groups=spec.get("groups", full.groups))
    print(f"-- model phase: {cfg.name} d_model={cfg.d_model} heads="
          f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff="
          f"{cfg.d_ff} vocab={cfg.vocab_size} layers={cfg.num_layers} tied="
          f"{cfg.tie_embeddings} experts={cfg.num_experts} top-"
          f"{cfg.experts_per_token} shared={cfg.moe_shared_expert}, {spec['mode']} "
          f"+ hadamard + {spec['mode']} KV quantization, int8 weights")
    if cfg.num_layers != full.num_layers:
        print(f"depth cut: {cfg.groups} of the published {full.groups}: "
              f"{cfg.num_layers} of {full.num_layers} layers at full width")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"init + quantize layer by layer: {time.perf_counter() - t0:.1f} s, "
          f"{wbytes / 1e9:.2f} GB of weights, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()

    hold_prefill_against_plain(cfg, params, quant, args.seed, spec["controls"])

    engine = ServeEngine(cfg, params, num_slots=SLOTS, max_len=MAX_LEN,
                         prefill_len=PREFILL_LEN, device="cuda")
    stream = synthetic_stream(8, vocab_size=cfg.vocab_size,
                              prompt_len=(16, PREFILL_LEN),
                              max_new_tokens=(16, 32), rate=1.0,
                              seed=args.seed)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    comps = engine.run(stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    s = engine.summary()
    passes = s["prefill_calls"] + s["decode_calls"]
    print(f"served {s['requests']} requests / {s['generated_tokens']} tokens in "
          f"{s['decode_steps']} decode steps ({wall:.1f} s wall): "
          f"{s['tokens_per_s']:.1f} tok/s, p50 {s['p50_token_ms']:.2f} ms / "
          f"p99 {s['p99_token_ms']:.2f} ms per token, occupancy "
          f"{s['occupancy'] * 100:.0f}%, warm-up {s['warmup_s']:.2f} s")
    print(f"launches: {launches} over {passes} model passes ({s['prefill_calls']} "
          f"prefills + {s['decode_calls']} decode steps, warm-up included) = "
          + ", ".join(f"{k} {v / passes:g}" for k, v in launches.items())
          + " per pass")
    for k in counters:
        per = spec["per_pass"].get(k, 0)
        if launches[k] != per * passes:
            fail(f"{arch}: {k} launches {launches[k]} != {per} x {passes}")
    if len(comps) != 8 or any(c.status != "ok" for c in comps):
        fail(f"not every request completed: {comps}")
    for c in comps:
        if not (1 <= len(c.tokens) <= 32 and all(0 <= t < cfg.vocab_size
                                                 for t in c.tokens)):
            fail(f"request {c.rid}: bad tokens {c.tokens}")
    if s["quantize_weight_calls"] != 0:
        fail("weights were quantized while serving")
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory from the prefill check through serving: "
          f"{peak / 1e9:.2f} GB (limit {PEAK_LIMIT / 1e9:g} GB)")
    if peak > PEAK_LIMIT:
        fail(f"{arch}: peak memory {peak / 1e9:.2f} GB")
    profile_decode(engine)
    if cfg.num_experts:
        streamed = streamed_pass(cfg, params, args.seed)
        launches.update({k: streamed[k] for k in ("K5", "K6s")})
    return s, launches


def streamed_pass(cfg, params, seed: int) -> dict:
    """The prefill of 4 prompts of 64 tokens plus 4 greedy decode steps,
    once with the rotate-once kernels and once under
    ``REPRO_QUANT_DOT_SCHEDULE=streamed``, the launch counters zeroed just
    before the second and read just after: the logits of every pass and the
    KV caches must be bitwise equal, and the streamed run must launch K5
    where rotate-once launches K4 and K6s where it launches K6. Returns the
    streamed run's launches."""
    from repro_torch.kernels.quant_dot import SCHEDULE_ENV_VAR
    from repro_torch.models.lm import lm_decode_step, lm_prefill, pad_kv_caches

    rng = np.random.default_rng(seed + 1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SLOTS, PREFILL_LEN))).cuda()

    def run():
        with torch.inference_mode():
            logits, caches = lm_prefill(cfg, params, {"tokens": prompt})
            caches = pad_kv_caches(cfg, caches, PREFILL_LEN + 4)
            outs = [logits]
            for i in range(4):
                tok = outs[-1][:, -1].argmax(-1, keepdim=True)
                logits, caches = lm_decode_step(
                    cfg, params, caches, tok,
                    torch.tensor(PREFILL_LEN + i, device="cuda"))
                outs.append(logits)
        torch.cuda.synchronize()
        return outs, caches

    once = run()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    os.environ[SCHEDULE_ENV_VAR] = "streamed"
    try:
        got = run()
    finally:
        os.environ.pop(SCHEDULE_ENV_VAR, None)
    launches = {k: fn.launches for k, fn in counters.items()}
    same_logits = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got[0], once[0]))
    same_kv = all(torch.equal(_bits(a[k]), _bits(b[k]))
                  for a, b in zip(got[1], once[1]) for k in ("k", "v"))
    print(f"-- streamed pass: prefill {tuple(prompt.shape)} + 4 decode steps under "
          f"schedule=streamed: logits bitwise to rotate-once {same_logits}, KV caches "
          f"{same_kv}; launches {launches} over 5 model passes")
    if not (same_logits and same_kv):
        fail("the streamed schedule's logits or caches differ from rotate-once")
    want = {"K1": 0, "K2": 8 * 5, "K3": 0, "K4": 0, "K5": 4 * 5, "K6": 0, "K6s": 2 * 5}
    if launches != want:
        fail(f"streamed pass launched {launches}, expected {want}")
    return launches


def profile_decode(engine, steps: int = 3) -> None:
    """Where a decode step's time goes: ``torch.profiler`` over a few
    decode steps on the engine's 4 slots (after the counted run, at the
    positions the run left), device time by kernel and the device's busy
    share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine._decode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine._decode()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:   # kernels, not the ops
            continue                             # that launched them
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = evt.self_cuda_time_total
        if dev > 0:
            rows.append((dev, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"-- profile: {steps} decode steps, {wall_us / steps / 1e3:.2f} ms "
          f"wall per step (profiler on), kernels busy {busy / steps / 1e3:.2f} "
          f"ms per step ({100 * busy / wall_us:.1f}% of the window)")
    ours = ("hadacore_kernel", "fused_dequant_kernel", "fused_kernel",
            "quant_dot_kernel", "quant_dot_experts_kernel")
    for i, (dev, count, key) in enumerate(rows):
        if i < 8 or any(k in key for k in ours):
            print(f"   {dev / steps / 1e3:8.3f} ms/step  {count // steps:5d} "
                  f"calls/step  {key[:90]}")


def _leaves(tree):
    from repro_torch.core.wquant import QTensor

    if isinstance(tree, QTensor):
        yield tree.q
        yield tree.scale
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    spent = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          + " ".join(f"{k}={v:.1f}s" for k, v in spent.items()))

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timed = kernel_phase(gen)
    hold_k3_k4(gen)
    timed.update(time_k3_k4(gen))
    hold_k5_k6(gen)
    timed.update(time_k5_k6(gen))
    entry = entry_point_phase(gen)
    launches = {}
    for arch in MODELS:
        _, got = model_phase(args, arch)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    launches["K3"] = entry["K3"]    # K3's path is the entry point

    quant_dot_cu = "src/repro_torch/csrc/quant_dot.cu"
    experts_cu = "src/repro_torch/csrc/quant_dot_experts.cu"
    meta = {
        "K1": {"name": "hadacore", "source": "src/repro_torch/csrc/hadacore.cu",
               "replaces": "src/repro/kernels/registry.py:224"},
        "K2": {"name": "fused_dequant",
               "source": "src/repro_torch/csrc/fused_quant.cu",
               "replaces": "src/repro/kernels/registry.py:283"},
        "K3": {"name": "fused", "source": "src/repro_torch/csrc/fused_quant.cu",
               "replaces": "src/repro/kernels/registry.py:268"},
        "K4": {"name": "quant_dot", "source": quant_dot_cu,
               "replaces": "src/repro/kernels/quant_dot.py:339"},
        "K5": {"name": "quant_dot_streamed", "source": quant_dot_cu,
               "replaces": "src/repro/kernels/quant_dot.py:401"},
        "K6": {"name": "quant_dot_experts", "source": experts_cu,
               "replaces": "src/repro/kernels/quant_dot.py:787"},
        "K6s": {"name": "quant_dot_experts_streamed", "source": experts_cu,
                "replaces": "src/repro/kernels/quant_dot.py:807"},
    }
    kernels = [{"name": meta[k]["name"], "route": "cuda",
                "source": meta[k]["source"], "replaces": meta[k]["replaces"],
                "launches": launches[k], **timed[k]} for k in meta]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
