"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--seed 0]

Runs from the repository root and needs the repository's ``src/``. It

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
     per source, in parallel) and prints the build seconds;
  3. kernel phase: holds every kernel against its plain PyTorch version on
     the card -- K1 ``hadacore`` on the tensor cores at n in {8, 16, 128,
     256, 512, 1024, 2048, 4096, 32768} x {bf16, fp16} x {1, 5, 28, 64}
     rows (1 ulp at the row max; in place bitwise out of place), at f32
     compute (the CUDA-core body) and the baseline FWHT (``fwht_cuda``) in
     the 3 dtypes at n in {128, 2048, 32768}, and grouped 14336; K2
     ``fused_dequant`` at 32, 256 and 2048 x 128 and 256 x 2048 x {int8,
     fp8_e4m3, fp8_e5m2}, bf16, and at the path shapes it is timed at (128,
     32, 2048 and 512 x 128 fp8_e4m3), each against its plain version and
     bitwise the plain epilogue on K1's own rotation; K3 ``fused`` at n in
     {128, 2048, 8192} x the 3 modes (q and s bitwise, and on K1's
     rotation); K4 ``quant_dot`` at phi4-mini's
     down projection (4 and 64 x 8192 -> 3072) and a ragged 5 x 8192 ->
     3000 in the 3 modes (int8 bitwise, fp8 within 2^-7 of the row max; the
     quant_dot family against the plain GEMM on the rotation it runs, the
     CUDA-core FWHT's);
     K5 (streamed K4) against K4 bitwise and its plain version at
     llama4-maverick's 4 and 64 x 8192 -> 5120; K6 ``quant_dot_experts``
     and K6s (streamed K6) at maverick's (4 | 1, 128, 1, 8192) -> 5120 over
     128 experts, with every third expert's rows all zero: K6s equal to K6,
     K6 to K4 per expert, bitwise, zero rows exact zeros, K6 against its
     plain version (int8 and fp8_e4m3 for K5/K6/K6s) -- and times each at
     the shapes its path gives it (CUDA events and a profile; K1 and K2
     through the transform harness, ``repro_torch.bench.hadamard``, K1
     beside the FWHT; the quant_dot family through its harness,
     ``repro_torch.bench.quant_dot``) beside its bound, its plain version
     and one PyTorch library call where there is one (K1
     ``torch.matmul(x, H_n)``; for K4-K6s the
     contraction alone, per weight matrix: ``torch._int_mm`` in int8,
     ``torch._scaled_mm`` in fp8_e4m3); K4 and K5 at 512 x 8192 -> 3072,
     where a block runs whole rounds of tiles and then split ones, in the 3
     modes (K5 bitwise K4, both under K4's rule); K8 (the
     revisit schedule: a (row block, 128-column tile) grid without
     clusters) bitwise to K4 and under K4's rule against its plain version
     at phi4-mini's 4 and 2048 (training) rows and maverick's 4 x 8192 ->
     5120, int8 and fp8_e4m3, and timed beside K4 (the schedule A/B);
  4. entry-point phase: ``hadamard(x, epilogue=QuantEpilogue(mode))`` and
     ``quant_dot`` on CUDA tensors launch K3 and K4 once per call, K1 never;
  5. model phases, each at full width from ``--seed`` with int8 weight
     storage: llama3-8b (fp8_e4m3 + Hadamard + fp8 KV cache, 32 layers),
     phi4-mini-3.8b (int8 W8A8 + Hadamard + int8 fake-quantized KV, tied
     embeddings, 32 layers), llama4-maverick-400b-a17b (fp8_e4m3 +
     Hadamard + fp8 KV, 128 experts top-1 + a shared expert; depth cut to 2
     of its 24 (attn, moe) groups, 4 of 48 layers, ~35 GB of weights), and
     the families whose d_ff is not a power of 2, so that each down
     projection is one grouped K1 launch: llama3-405b (fp8, depth cut to
     ``LLAMA3_405B_LAYERS`` of 126 layers), qwen1.5-4b (int8 W8A8, QKV
     biases, 40 layers), starcoder2-15b (fp8; LayerNorm, tanh-GELU MLP, QKV
     biases; 40 layers) and mixtral-8x7b (fp8; 8 experts top-2, the expert
     site in its einsum form, a 4096-token window; 32 layers). Each checks
     that its weights hold ``launch.flops.count_params`` values, reports
     which layer-0 stage first differs between the kernels and the
     plain versions, holds a prefill through the kernels against one
     through the plain versions (a limit calibrated in the same run:
     witnesses, correct paths that differ as a kernel may, must pass it and
     controls, known faults, must fail it; for maverick every held run
     routes as the plain run did, and the unpinned runs report the tokens
     whose top-1 expert differs, with their gate margins), then serves 8
     requests on 4 slots through ``ServeEngine`` with the launch counters
     zeroed just before and read just after, and checks the launches per
     model pass (llama3: 32 K1 + 64 K2; phi4-mini: 32 K4 + 64 K2; maverick:
     8 K2 + 4 K4 + 2 K6; llama3-405b: one K1 and two K2 per layer;
     qwen1.5-4b and starcoder2-15b 40 K1 + 80 K2; mixtral 32 K1 + 64 K2;
     every other kernel 0), the peak device memory and a profile of the
     decode step. Maverick then runs a prefill and 4
     decode steps under ``REPRO_QUANT_DOT_SCHEDULE=streamed``: logits and
     KV caches bitwise equal to rotate-once, with 4 K5 + 2 K6s launches per
     pass in place of K4 and K6;
  6. ABFT (checksum-verified serving), after the model phases of llama3-8b,
     phi4-mini-3.8b and llama4-maverick-400b-a17b, on its own
     weights with their checksums attached: a prefill + 4 decode steps
     with ABFT on bitwise equal to ABFT off (logits and caches; maverick
     also under the streamed schedule), every verified site's healthy
     residual printed (llama3's unfused sites exactly 0); the same 8
     requests served with ABFT on, tokens bitwise those of ABFT off, with
     per pass llama3 64 K1 + 64 K2, phi4-mini 32 K7a-ro + 64 K2, maverick
     8 K2 + 4 K7a-ro + 2 K7b (streamed: 4 K7a-s + 2 K7b-s), and health()
     free of trips, retries and ladder steps; then, on phi4-mini, fault
     runs (a tile clobber, a KV perturbation, a NaN poke, one and two
     kernel raises, a single bit flip) with their retirements and
     counters checked (``fault_runs``), and the same 8 requests served with
     ABFT on under the revisit schedule (32 K7a-rv + 64 K2 per pass). The
     kernel phase before holds the ABFT twins K7a-ro / K7a-s / K7a-rv / K7b
     / K7b-s against K4 / K5 / K8 / K6 / K6s (bitwise) and their plain
     versions (residual values within 1e-2 of the tolerance and verdicts,
     healthy and corrupted) and times them beside their twins;
  7. window phase (``window_phase``): mixtral-8x7b at full width, 2 of its
     32 layers, one prompt of 4096 + 128 tokens and 8 decode steps at a
     scalar position: past the window the kernels (one K1 and two K2 per
     layer and pass) and the witnesses within a limit of the plain versions,
     full attention (``sliding_window=0``) beyond it, and bitwise the window
     run before it; launcher phase (``launcher_phase``): the one-shot
     launcher ``repro_torch.launch.serve.main`` at full width on qwen1.5-4b,
     4 prompts of 64 tokens and 16 greedy tokens each, with its tok/s and
     exactly 40 K1 + 80 K2 per model pass;
     training phase (``train_phase``): phi4-mini-3.8b at full width and
     depth (int8 + Hadamard, int8 fake-quantized Q/K/V, tied embeddings,
     per-block recomputation), 4 x 512 tokens per step from the
     ``SyntheticDataset``: the step-0 loss and every gradient leaf through
     the kernels against the plain versions on the card, within limits set
     between two witnesses and two controls printed beside them; 3 AdamW
     steps with f32 moments (step time, tokens/s, peak memory < 72 GB,
     launches per step: 128 K1, 128 K2, 64 K4, checked) and a profile of
     one more; the same 3 steps under the revisit schedule (64 K8 per step)
     bitwise equal in losses and parameters; 3 steps with int8 moments; a
     checkpoint at step 2 and a restart that resumes bitwise (at 2 layers,
     full width);
  8. lint phase (``lint_phase``): the kernel-contract linter
     (``repro_torch.analysis.lint``) in process at full width over
     phi4-mini's int8 8192 -> 3072 and llama4-maverick's fp8_e4m3 8192 ->
     5120 fused sites under rotate-once, streamed and revisit with their
     ABFT twins (K4-K8, K7a-*, K7b-*), the MLP model sites and the serving
     sites (a decode step and a prefill-insert) of the llama3-8b and
     phi4-mini engines the model phases served with: the clean run must
     exit 0, printing each site's launches, rotations per row against the
     launch geometry and shared-memory readings; every instantiation of the
     four quant_dot sources and of M2 must contract on the tensor cores
     (``mma.sync`` and no ``dp4a`` in its PTX, counts printed per kernel),
     and every bf16 / fp16-compute instantiation of K1, K2 and K3 must
     rotate there (``mma.sync`` in its PTX entry);
     ``--mutation`` must exit
     non-zero with M1 (K4 re-rotating before every tile) flagged by the
     rotate-once rule and M2 (K5 without its ring's final drain) by the DMA
     rule, their launches counted from 0 just before; M1 bitwise K4 in int8
     and fp8_e4m3 and M2 bitwise K5 in fp8_e4m3, each timed beside its twin
     and held against its plain version (its twin's) under the K4 rule;
  9. rotation phase (``rotation_phase``): llama3-8b at full width, random
     bf16 weights, ``fuse_down_proj_rotations`` through K1 (one grouped
     launch per layer), then the fused model's 64-token prefill with the
     online rotations against the unrotated model, without quantization
     and with fp8_e4m3 + Hadamard + fp8 KV, each within a limit set between
     its witness (the plain rotation) and control (no online rotation);
 10. prints the kernels' JSON line (K1-K8, the ABFT twins, M1 and M2), then
     the result line ``{"ok": true, "device": {...}}`` last.

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

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
# the serving run's and the training phase's traffic, which the transform
# harness's path and train cases stand for
from repro_torch.bench.hadamard import PREFILL_LEN, SLOTS, TRAIN_BATCH, TRAIN_SEQ  # noqa: E402

MAX_LEN = 256                      # the serving run's engine: SLOTS slots of MAX_LEN
MODES = ("int8", "fp8_e4m3", "fp8_e5m2")
PHI4_DOWN = (8192, 3072)           # phi4-mini's down projection, n -> d
MAVERICK_DOWN = (8192, 5120)       # llama4-maverick's down projections, n -> d
EXPERTS = 128                      # llama4-maverick's experts per MoE layer
IO_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
EPS = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7,
       torch.float16: 2.0 ** -10}


def fail(msg: str) -> None:
    raise AssertionError(msg)


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


def _k2_plan(n: int, mode: str):
    from repro_torch.core.api import QuantEpilogue, plan_for

    return plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                    epilogue=QuantEpilogue(mode, dequant=True))


def hold_k2(x: torch.Tensor, mode: str, got: torch.Tensor) -> None:
    """K2's output ``got`` on bf16 rows ``x`` against its plain version
    (``k2_excess`` <= 1) and bitwise the plain epilogue on K1's own
    rotation of ``x``; prints the readings."""
    from repro_torch.core.api import plan_for
    from repro_torch.kernels.fused_quant import fused_dequant_plain
    from repro_torch.kernels.hadacore import transform
    from repro_torch.kernels.registry import _dequantize, _quantize_rows

    rows, n = x.shape
    plan = _k2_plan(n, mode)
    y1 = transform(x, plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cuda"))
    torch.cuda.synchronize()
    own = _dequantize(*_quantize_rows(y1.float(), mode), mode).to(torch.bfloat16)
    want = fused_dequant_plain(x, plan)
    exc = k2_excess(got, want, x, plan)
    bitwise = bool(torch.equal(got, want))
    on_k1 = bool(torch.equal(got.view(torch.int16), own.view(torch.int16)))
    print(f"K2 {rows:4d} x {n:4d} {mode:9s} error / (grid step x row scale) "
          f"{exc:.3f} (tolerance 1), bitwise to plain {bitwise}, to K1's rotation "
          f"+ plain epilogue {on_k1}")
    if not exc <= 1.0:
        fail(f"K2 {rows} x {n} {mode}: {exc} grid steps")
    if not on_k1:
        fail(f"K2 {rows} x {n} {mode}: not the plain epilogue on K1's rotation")


K1_SIZES = (8, 16, 128, 256, 512, 1024, 2048, 4096, 32768)  # every r and log16 remainder
K1_ROWS = (1, 5, 28, 64)


def kernel_phase(gen: torch.Generator):
    """Build-free check and timing of K1 and K2 (the build happened
    before): K1 on the tensor cores against its plain version at K1_SIZES x
    {bf16, fp16} x K1_ROWS, in place bitwise out of place; f32 compute (the
    CUDA-core body) and the baseline FWHT (``fwht_cuda``) as before; the
    grouped 14336; K2 against its plain version and bitwise the plain
    epilogue on K1's own rotation; then the path shapes through the
    transform timing harness (``repro_torch.bench.hadamard.measure``).
    Returns the two kernels' entries of the JSON line."""
    from repro_torch.bench.hadamard import CASES, measure
    from repro_torch.bench.quant_dot import HBM_BYTES_PER_S, cuda_time_ms, profile_ms
    from repro_torch.core.api import QuantEpilogue, hadamard, plan_for
    from repro_torch.kernels.fused_quant import fused_dequant
    from repro_torch.kernels.hadacore import fwht_cuda, transform, transform_plain

    print("-- kernel phase: K1 hadacore on the tensor cores against its plain version "
          f"(rows {K1_ROWS}; in place against out of place)")
    for n in K1_SIZES:
        for dt in (torch.bfloat16, torch.float16):
            plan = plan_for(n, dtype=dt, backend="cuda", device_type="cuda")
            worst = 0.0
            for rows in K1_ROWS:
                x = torch.randn(rows, n, generator=gen, device="cuda").to(dt)
                got = transform(x, plan)
                buf = x.clone()
                transform(buf, plan, in_place=True)
                torch.cuda.synchronize()
                err = k1_ulps(got, transform_plain(x, plan), dt)
                worst = max(worst, err)
                if not err <= k1_tolerance(n, dt):
                    fail(f"K1 n={n} {dt} rows={rows}: {err} ulps > {k1_tolerance(n, dt)}")
                if not torch.equal(buf, got):
                    fail(f"K1 n={n} {dt} rows={rows}: in place differs from out of place")
            print(f"K1 n={n:5d} {str(dt):14s} max err {worst:.3f} ulp(row max) "
                  f"(tolerance {k1_tolerance(n, dt):g}); in place bitwise out of place")
    print("-- kernel phase: K1 at f32 compute (the CUDA-core body) and the baseline FWHT "
          "(fwht_cuda) against the plain version")
    for n in (128, 2048, 32768):
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            x = torch.randn(64, n, generator=gen, device="cuda").to(dt)
            plan = plan_for(n, dtype=dt, backend="cuda", device_type="cuda")
            want = transform_plain(x, plan)
            base = fwht_cuda(x, torch.empty_like(x), plan)
            got = transform(x, plan) if dt == torch.float32 else None
            torch.cuda.synchronize()
            tol = k1_tolerance(n, dt)
            errs = {"FWHT": k1_ulps(base, want, dt)}
            if got is not None:
                errs["K1"] = k1_ulps(got, want, dt)
            print(f"n={n:5d} {str(dt):14s} " + ", ".join(
                f"{k} max err {v:.3f} ulp(row max)" for k, v in errs.items())
                + f" (tolerance {tol:g})")
            for k, v in errs.items():
                if not v <= tol:
                    fail(f"{k} n={n} {dt}: {v} ulps > {tol}")
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

    print("-- kernel phase: K2 fused_dequant against its plain version, and bitwise the "
          "plain epilogue on K1's own rotation")
    for n, rows in ((128, 32), (128, 256), (128, 2048), (2048, 256)):
        for mode in MODES:
            x = (torch.randn(rows, n, generator=gen, device="cuda") * 3).to(torch.bfloat16)
            hold_k2(x, mode, fused_dequant(x, _k2_plan(n, mode)))

    print("-- kernel phase: times at the serving path's shapes (llama3-8b, bf16; decode = "
          f"one token on each of {SLOTS} slots, prefill = {PREFILL_LEN} tokens) through "
          "repro_torch.bench.hadamard.measure")
    entries = {}
    for case in CASES:
        if case.group != "path":
            continue
        x = None
        if case.kernel == "K2":
            x = torch.randn(case.rows, case.n, generator=gen, device="cuda").to(torch.bfloat16)
            hold_k2(x, case.mode, fused_dequant(x, _k2_plan(case.n, case.mode)))
        rec = measure(case, gen, x)
        fwht = (f", FWHT {rec['baseline_ms']:.5f} ms / {_dev(rec['baseline_device_ms'])} "
                f"(K1 {_dev_ratio(rec['baseline_device_ms'], rec['device_ms'])} faster)"
                if case.kernel == "K1" else "")
        lib = (f", {rec['library']} {rec['library_ms']:.5f} ms / "
               f"{_dev(rec['library_device_ms'])} (K1 / library "
               f"{_dev_ratio(rec['device_ms'], rec['library_device_ms'])})"
               if rec["library"] else ", library none")
        print(f"{case.kernel} {case.site:28s} ({case.rows} x {case.n}"
              f"{' ' + case.mode if case.mode else ''}): kernel {rec['ms']:.5f} ms (events) "
              f"{_dev(rec['device_ms'])} (profile){fwht}{lib}, plain {rec['plain_ms']:.5f} "
              f"ms, bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}), max abs err "
              f"{rec['max_abs_err']:g}" + (f", {rec['ulps']:.3f} ulp" if rec["ulps"] is not None
                                           else ""))
        if case.kernel == "K1" and not rec["ulps"] <= 1.0:
            fail(f"K1 {case.site}: {rec['ulps']} ulps")
        if case.kernel not in entries:    # the decode shape: the path's most frequent
            entries[case.kernel] = {k: rec[k] for k in (
                "mode", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}
    # device throughput at a size where launch overhead does not dominate
    x = torch.randn(16384, 2048, generator=gen, device="cuda").to(torch.bfloat16)
    plan = plan_for(2048, dtype=torch.bfloat16, backend="cuda", device_type="cuda")
    out = torch.empty_like(x)
    for name, fn, key in (("K1", lambda: transform(x, plan), "hadacore_tc_kernel"),
                          ("FWHT", lambda: fwht_cuda(x, out, plan), "fwht_kernel")):
        ms, dev = cuda_time_ms(fn, iters=50), profile_ms(fn, key)
        print(f"{name} 16384 x 2048 bf16 (not a path shape): {ms:.4f} ms (events), "
              f"{_dev(dev)} (profile), {2 * x.numel() * 2 / dev / 1e6 if dev else 0:.0f} "
              f"GB/s of {HBM_BYTES_PER_S / 1e9:.0f}")
    plan = plan_for(128, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                    epilogue=QuantEpilogue("fp8_e4m3", dequant=True))
    x = x.reshape(-1, 128)
    run = lambda: fused_dequant(x, plan)                          # noqa: E731
    ms, dev = cuda_time_ms(run, iters=50), profile_ms(run, "fused_dequant_tc_kernel")
    print(f"K2 262144 x 128 bf16 fp8_e4m3 (not a path shape): {ms:.4f} ms (events), "
          f"{_dev(dev)} (profile), {2 * x.numel() * 2 / dev / 1e6 if dev else 0:.0f} GB/s")
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

    A kernel rotates with its own arithmetic -- K3 with K1's tensor-core
    routine, K4 with the CUDA-core FWHT (``fwht_cuda``'s body) -- the plain
    version with cuBLAS products. Where the two rotations agree bitwise, K3
    must give the plain q and s bitwise and K4 (int8) the plain output
    bitwise; on 'exact' inputs they must agree everywhere. On every input
    the kernel must equal the plain epilogue applied to its own rotation
    bitwise (K3: K1's; K4 int8: the FWHT's), so any difference left is the
    rotation's, which K1's tolerance holds. fp8 K4 sums exact products in
    another order: within 2^-7 of the row's largest |value| of the plain
    GEMM on the FWHT's rotation (every row), and of the plain version (rows
    whose rotations agree)."""
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
                y1, (q1, s1) = _fwht_epilogue(x, plan)
                agree = _same_rows(y1, transform_plain(x, plan))
                from_rot = epilogue_dot(q1, s1, qt.q, qt.scale, mode, torch.bfloat16)
                _hold_rows(f"K4 {m:2d} x {n} -> {d} {mode:9s} {kind:8s}", got,
                           quant_dot_plain(x, qt.q, qt.scale, plan), from_rot, agree,
                           mode, kind == "exact")



def hold_mixed_rounds(seed: int) -> None:
    """K4 and K5 at 512 x 8192 -> 3072 (phi4-mini's down projection at a
    prefill or training size), where each block runs whole rounds of 16
    tiles and then split rounds (the launcher's geometry, read and checked
    here): K5 bitwise K4, and K4 under K4's rule against its plain version,
    in the 3 modes on both kinds of input. No other hold has both kinds of
    round in one block. Its own generator leaves the later phases' draws as
    they were."""
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.core.wquant import quantize_weight
    from repro_torch.kernels.hadacore import transform_plain
    from repro_torch.kernels.quant_dot import (epilogue_dot, launch_grid, quant_dot,
                                               quant_dot_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    (n, d), m = PHI4_DOWN, 512
    print(f"-- kernel phase: K4 and K5 at {m} x {n} -> {d}, whole rounds then split rounds")
    cpu = torch.Generator().manual_seed(2)
    w = (torch.randn(n, d, generator=cpu) / math.sqrt(n)).to("cuda", torch.bfloat16)
    for mode in MODES:
        qt = quantize_weight(w, mode)
        plan = plan_for(n, dtype=torch.bfloat16, backend="cuda",
                        device_type="cuda", epilogue=QuantEpilogue(mode))
        for sched in ("rotate_once", "streamed"):
            g = launch_grid(m, n, d, mode, 0, sched)
            whole, rest = divmod(g["tiles_per_block"], 16)
            print(f"{sched} {mode}: {g['row_blocks']} x {g['splits']} blocks of {g['bm']} "
                  f"rows, {whole} whole and {rest} split rounds each")
            if not (whole and rest):
                fail(f"{m} x {n} -> {d} {mode} {sched}: not a mixed shape {g}")
        for kind in ("exact", "gaussian"):
            x = _k34_input(gen, m, n, kind)
            got = quant_dot(x, qt.q, qt.scale, plan)
            streamed = quant_dot(x, qt.q, qt.scale, plan, "streamed")
            torch.cuda.synchronize()
            differ = int((got.view(torch.int16) != streamed.view(torch.int16)).sum())
            print(f"K5 {m} x {n} -> {d} {mode:9s} {kind:8s}: {differ} elements differ from K4")
            if differ:
                fail(f"K5 {m} x {n} -> {d} {mode} {kind}: not bitwise K4")
            y1, (q1, s1) = _fwht_epilogue(x, plan)
            agree = _same_rows(y1, transform_plain(x, plan))
            from_rot = epilogue_dot(q1, s1, qt.q, qt.scale, mode, torch.bfloat16)
            _hold_rows(f"K4 {m} x {n} -> {d} {mode:9s} {kind:8s}", got,
                       quant_dot_plain(x, qt.q, qt.scale, plan), from_rot, agree,
                       mode, kind == "exact")

def _record_line(tag: str, rec: dict) -> str:
    """One record of the quant_dot timing harness, for print."""
    lib = (f"{rec['library']} {rec['library_ms']:.5f} ms (events) "
           f"{_dev(rec['library_device_ms'])} (device)" if rec["library"] else "library none")
    g = rec["grid"]
    return (f"{tag}: kernel {rec['ms']:.5f} ms (events) {_dev(rec['device_ms'])} (profile), "
            f"plain {rec['plain_ms']:.5f} ms, {lib}, bound {rec['bound_ms']:.6f} ms "
            f"({rec['bound_by']}), max abs err {rec['max_abs_err']:g}; launch: "
            f"{g['row_blocks']} x {g['splits']} blocks of {g['bm']} rows, "
            f"{g['tiles_per_block']} tiles each, cluster {g['cluster']}, {g['smem']} B shared")


def _measure(case, gen, qt, cw, x) -> dict:
    """``repro_torch.bench.quant_dot.measure`` of one case, with the launch
    geometry it read from the launcher held to the size rule's Python
    mirror (``kernels.quant_dot._grid_plan``) on this card's SM count."""
    from repro_torch.bench.quant_dot import KERNELS, measure
    from repro_torch.kernels.quant_dot import _grid_plan

    rec = measure(case, gen, qt, cw, x)
    sched, _, abft = KERNELS[case.kernel]
    want = _grid_plan(case.rows, case.n, case.d, case.mode, case.experts, sched, abft,
                      sms=torch.cuda.get_device_properties(0).multi_processor_count)
    if rec["grid"] != want:
        fail(f"{case}: the launcher's geometry {rec['grid']} is not the size rule's {want}")
    return rec


def _entry(rec: dict) -> dict:
    """A kernel's entry of the JSON line from one harness record."""
    return {k: rec[k] for k in ("mode", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}


def time_k3_k4(gen) -> dict:
    """K3 and K4 at phi4-mini's shapes. K4 through the quant_dot timing
    harness (``repro_torch.bench.quant_dot.measure``: CUDA events and the
    profiler, beside its bound, its plain version and ``torch._int_mm`` on
    the already-quantized operand -- the contraction alone, since no single
    PyTorch call computes rotate + quantize + GEMM); K3 with the harness's
    timers (no library counterpart). The JSON entries take the decode
    shape, with the largest |kernel - plain| there (K3: in q's grid units).
    The draws from ``gen`` are the earlier script's, so the phases after
    this one see the same inputs."""
    from repro_torch.bench.quant_dot import (INT8_OPS_PER_S, Case, bound, cuda_time_ms,
                                             profile_ms)
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.core.wquant import quantize_weight
    from repro_torch.kernels.fused_quant import fused, fused_plain
    from repro_torch.kernels.quant_dot import quant_dot

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
        rec = _measure(Case("K4", "int8", m, n, d), gen, qt, None, x)
        print(_record_line(f"K4 {m:2d} x {n} -> {d} int8", rec))
        entries.setdefault("K4", _entry(rec))   # the decode shape: the path's most frequent
        # K3 on the same rows
        run = lambda: fused(x, plan)                                 # noqa: E731
        plain = lambda: fused_plain(x, plan)                         # noqa: E731
        (q, sc), (qp, sp) = run(), plain()
        err = max(float((q.float() - qp.float()).abs().max()),
                  float((sc - sp).abs().max()))
        ms, plain_ms = cuda_time_ms(run), cuda_time_ms(plain, iters=50)
        dev_ms = profile_ms(run, "fused_tc_kernel")
        bound_ms, by = bound(m * n * 2 + m * n + m * 4, 0, m * n * (math.log2(n) + 6),
                             INT8_OPS_PER_S)
        print(f"K3 {m:2d} x {n}: max abs err {err:g}, kernel {ms:.5f} ms (events), "
              f"{_dev(dev_ms)} (profile), plain {plain_ms:.5f} ms, "
              f"library none, bound {bound_ms:.6f} ms ({by})")
        if "K3" not in entries:
            entries["K3"] = {"mode": "int8", "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
    # device throughput at a size where launch overhead does not dominate
    x = (torch.randn(1024, n, generator=gen, device="cuda") * 3).to(torch.bfloat16)
    ms = cuda_time_ms(lambda: quant_dot(x, qt.q, qt.scale, plan), iters=20)
    print(f"K4 1024 x {n} -> {d} int8 (not a path shape): {ms:.4f} ms, "
          f"{2 * 1024 * n * d / ms / 1e9:.1f} TOP/s")
    return entries


def _fwht_epilogue(x2, plan):
    """The rotation the quant_dot family runs inside its kernels -- the
    CUDA-core FWHT, ``fwht_cuda`` -- of the rows x2, and the plain
    epilogue on it: (y, (q, s))."""
    from repro_torch.core.api import plan_for
    from repro_torch.kernels.hadacore import fwht_cuda
    from repro_torch.kernels.registry import _quantize_rows

    x2 = x2.contiguous()
    y1 = fwht_cuda(x2, torch.empty_like(x2), plan_for(plan.n, dtype=x2.dtype,
                                                      backend="cuda", device_type="cuda"))
    return y1, _quantize_rows(y1.float(), plan.epilogue.mode)


def _hold_rows(tag, got, want, from_rot, agree, mode, exact) -> None:
    """The K4 rule on rows: int8 bitwise to the plain GEMM on the kernel's own
    rotation in every row, to the plain version where the two rotations
    agree (everywhere on exact inputs); fp8 within 2^-7 of the row max of
    both (the plain version where the rotations agree)."""
    same = _same_rows(got, want)
    own = bool(_same_rows(got, from_rot).all())
    rel_rot = float(_rel_rows(got, from_rot).max())
    rel = _rel_rows(got, want)
    rel_agree = float(rel[agree].max()) if bool(agree.any()) else 0.0
    print(f"{tag}: rows with the plain rotation {int(agree.sum())}/{len(agree)}, bitwise "
          f"to plain {int(same.sum())}/{len(agree)}, to the FWHT's rotation + plain GEMM "
          f"{own}; max |d| / row max {rel_rot:.3e} against the FWHT's rotation + plain "
          f"GEMM, {rel_agree:.3e} against plain where the rotations agree")
    if mode == "int8":
        if not own or not bool(same[agree].all()):
            fail(f"{tag}: not bitwise beyond the rotation's flips")
        if exact and not bool(same.all()):
            fail(f"{tag}: exact input not bitwise")
    elif not (rel_rot <= 2.0 ** -7 and rel_agree <= 2.0 ** -7):
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
    from repro_torch.bench.quant_dot import expert_weights
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
                y1, (q1, s1) = _fwht_epilogue(x, plan)
                agree = _same_rows(y1, transform_plain(x, plan))
                from_rot = epilogue_dot(q1, s1, qt.q, qt.scale, mode, torch.bfloat16)
                print(f"K5 {m:2d} x {n} -> {d} {mode:8s} {kind:8s}: bitwise to K4 {same45}")
                if not same45:
                    fail(f"K5 {m}x{n}->{d} {mode} {kind}: differs from K4")
                _hold_rows(f"K5 {m:2d} x {n} -> {d} {mode:8s} {kind:8s}", k5,
                           quant_dot_plain(x, qt.q, qt.scale, plan), from_rot, agree,
                           mode, kind == "exact")
        del w, qt
        ex = expert_weights(gen, n, d, mode)
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
                y1, (q1, s1) = _fwht_epilogue(x2, plan)
                agree = _same_rows(y1, transform_plain(x2, plan))
                from_rot = experts_epilogue_dot(q1.view(*x.shape), s1.view(*x.shape[:-1], 1),
                                               ex.q, ex.scale, mode, torch.bfloat16)
                want = quant_dot_experts_plain(x, ex.q, ex.scale, plan)
                _hold_rows(tag, k6.reshape(-1, d), want.reshape(-1, d),
                           from_rot.reshape(-1, d), agree, mode, kind == "exact")
        del ex
        torch.cuda.empty_cache()


def _dev(ms) -> str:
    """A device time for print: 'not measured' where the profiler captured
    no matching device event, never 0."""
    return "not measured" if ms is None else f"{ms:.5f} ms"


def _dev_ratio(a, b) -> str:
    return "not measured" if a is None or b is None else f"{a / b:.2f}x"


def time_k5_k6(gen) -> dict:
    """K4, K5, K6 and K6s at llama4-maverick's decode and prefill shapes,
    fp8_e4m3 (the path's mode) and int8, Gaussian rows in every expert (so
    the whole weight is needed), through the quant_dot timing harness
    (``repro_torch.bench.quant_dot.measure``): CUDA events and a profile per
    kernel, beside the bound, the plain version and one library contraction
    per weight matrix on the already-quantized operand. The JSON entries
    take the fp8_e4m3 decode shape, every field of an entry from that run."""
    from repro_torch.bench.quant_dot import Case, expert_weights
    from repro_torch.core.wquant import quantize_weight

    n, d = MAVERICK_DOWN
    print("-- kernel phase: K4, K5, K6 and K6s times at llama4-maverick's down "
          f"projections (bf16 activations; decode = {SLOTS} rows, prefill = "
          f"{PREFILL_LEN}; experts: {SLOTS} and 1 rows per expert, {EXPERTS} experts)")
    entries = {}
    for mode in ("int8", "fp8_e4m3"):
        qt = quantize_weight((torch.randn(n, d, generator=gen, device="cuda")
                              / math.sqrt(n)).to(torch.bfloat16), mode)
        ex = expert_weights(gen, n, d, mode)
        cases = [("K4", m) for m in (SLOTS, PREFILL_LEN)]
        cases += [("K5", m) for m in (SLOTS, PREFILL_LEN)]
        cases += [("K6", bt) for bt in (SLOTS, 1)]
        cases += [("K6s", bt) for bt in (SLOTS, 1)]
        for kern, m in cases:
            experts = kern.startswith("K6")
            rows = m * EXPERTS if experts else m
            x = (torch.randn(rows, n, generator=gen, device="cuda") * 3).to(torch.bfloat16)
            if experts:
                x = x.view(m, EXPERTS, 1, n)
            rec = _measure(Case(kern, mode, m, n, d), gen, ex if experts else qt, None, x)
            print(_record_line(f"{kern:3s} {mode:8s} {tuple(x.shape)} -> {d}", rec))
            if mode == "fp8_e4m3" and m == SLOTS:   # the decode shape, the path's mode
                entries[kern] = _entry(rec)
        del ex, qt
        torch.cuda.empty_cache()
    entries.pop("K4")      # K4's entry is phi4-mini's (time_k3_k4)
    return entries


# ------------------------------------------------------------------ ABFT
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ   # the training phase's rows
ABFT_SHAPES = (  # (label, rows per expert, n, d, experts (0 = dense), schedules)
    ("phi4-mini decode", SLOTS, *PHI4_DOWN, 0, ("rotate_once", "streamed", "revisit")),
    ("phi4-mini training rows", TRAIN_ROWS, *PHI4_DOWN, 0, ("revisit",)),
    ("maverick dense decode", SLOTS, *MAVERICK_DOWN, 0,
     ("rotate_once", "streamed", "revisit")),
    ("maverick experts decode", SLOTS, *MAVERICK_DOWN, EXPERTS, ("rotate_once", "streamed")),
)
BAND = 0.01   # verdicts may differ only where |r| is within 1% of the tolerance
# |r - r_plain| on the kernels' rotation (the FWHT's), over the tolerance, must stay below this
# on the rows r_plain passes: two correct summation orders read ~1e-4..1e-3
# of the tolerance, a residual summed from bf16 outputs or with a bf16
# checksum ~1 (tests/test_torch_abft.py holds both sides of this limit)
RESID_C = 1e-2


def _ratio(y, r, n: int, d: int) -> torch.Tensor:
    """Per row, |r| over the residual's tolerance rtol * sum |y| (+ atol)."""
    from repro_torch import verify

    rtol, atol = verify.abft_tolerance(n, d)
    return (r.abs() / (rtol * y.float().abs().sum(-1, keepdim=True) + atol)).reshape(-1)


def _geometry(m, n, d, mode, experts, sched, abft) -> str:
    """Rows per block, column splits, cluster size and shared memory of a
    launch, as the launcher decides them (cluster: the largest power of 2
    up to 8 within the rows per block and the splits; revisit: none)."""
    from repro_torch.kernels.quant_dot import launch_shape

    bm, smem, blocks = launch_shape(m, n, d, mode, experts, sched, abft)
    splits = blocks // (-(-m // bm) * max(experts, 1))
    cl = 1 if sched == "revisit" else 8      # revisit: no cluster
    while cl > 1 and (cl > bm or cl > splits):
        cl //= 2
    return f"BM {bm}, {splits} splits, cluster {cl}, {smem} B shared"


def _abft_from_q(q, s, wq, sw, cw, mode, experts: bool):
    """The plain ABFT math (output and residual) on given (q, s)."""
    from repro_torch.kernels.quant_dot import _abft_parts

    if not experts:
        return _abft_parts(q, s, wq, sw, cw, mode, torch.bfloat16)
    y = torch.empty((*q.shape[:-1], wq.shape[-1]), dtype=torch.bfloat16, device=q.device)
    r = torch.empty((*q.shape[:-1], 1), dtype=torch.float32, device=q.device)
    for e in range(wq.shape[0]):
        y[:, e], r[:, e] = _abft_parts(q[:, e], s[:, e], wq[e], sw[e], cw[e], mode,
                                       torch.bfloat16)
    return y, r


def _corrupt_weight(qt, kind: str, expert: int):
    """In place, through a byte view, in expert ``expert`` (dense: the
    whole weight): one finite bit flip (bit 6) at row k = n / 3 near column
    d / 2, or a zeroed 128-column slab. Returns (undo, k or None)."""
    from repro_torch.testing.faults import _finite_after_flip

    raw = qt.q.view(torch.uint8)
    w = raw[expert] if raw.ndim == 3 else raw
    n, d = w.shape
    if kind == "slab":
        lo = d // 2 - 64
        old = w[:, lo:lo + 128].clone()
        w[:, lo:lo + 128] = 0
        return (lambda: w[:, lo:lo + 128].copy_(old)), None
    k, col = n // 3, d // 2
    while not _finite_after_flip(int(w[k, col]), 6, qt.mode):
        col += 1
    old = w[k, col].clone()
    w[k, col] ^= 64
    return (lambda: w[k, col].copy_(old)), k


def hold_abft_kernels(gen) -> tuple:
    """K7a-ro, K7a-s, K7a-rv, K7b and K7b-s against their twins K4, K5, K8,
    K6, K6s and their plain versions, at phi4-mini's decode shape (4 x 8192
    -> 3072; K7a-rv also at the training phase's 2048 rows), maverick's
    dense one (4 x 8192 -> 5120) and its expert one ((4, 128, 1, 8192) ->
    5120, every third expert's rows zero), in int8 and fp8_e4m3, on
    exact-sum and Gaussian rows:

      * the output is bitwise the twin's;
      * the residual's value is the plain ABFT math's on the rotation the
        kernels run (the CUDA-core FWHT, ``fwht_cuda``)
        within RESID_C of the tolerance on every row that math passes,
        healthy and corrupted (the largest reading is printed beside
        RESID_C; a tripped row's value carries the corruption's own
        rounding, and its verdict is held);
      * the residual's verdict equals the plain ABFT math's on that
        rotation on every row (outside a band of 1% around the tolerance,
        where two summation orders may land on either side; the band's
        rows are counted), and the plain version's on every row whose
        rotation agrees; healthy, every row passes;
      * the weight corrupted in place under its stale checksum (one finite
        bit flip at row k; a zeroed 128-column slab): the same verdict
        rule; no row whose operand misses the change (op[k] = 0, or an
        all-zero row) trips; the slab trips some row. The trips and the
        residual against the tolerance are printed: at these widths a
        single flipped bit shifts a row's residual by less than its
        tolerance unless the row's operand at k is large, and a slab's
        shift, a sum of 128 outputs, falls below it in about 1% of rows.

    Returns (the largest healthy |r| / tolerance, the largest |r -
    r_plain| / tolerance)."""
    from repro_torch.bench.quant_dot import expert_weights
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.core.wquant import quantize_weight, weight_checksum
    from repro_torch.kernels.hadacore import transform_plain
    from repro_torch.kernels.quant_dot import (_operand_from_q, quant_dot,
                                               quant_dot_abft_plain, quant_dot_experts,
                                               quant_dot_experts_abft_plain)

    print("-- kernel phase: ABFT twins K7a-ro / K7a-s / K7a-rv / K7b / K7b-s against K4 / "
          "K5 / K8 / K6 / K6s and their plain versions")
    worst = worst_dev = 0.0
    cpu = torch.Generator().manual_seed(3)
    names = {(0, "rotate_once"): ("K7a-ro", "K4"), (0, "streamed"): ("K7a-s", "K5"),
             (0, "revisit"): ("K7a-rv", "K8"),
             (1, "rotate_once"): ("K7b", "K6"), (1, "streamed"): ("K7b-s", "K6s")}
    for label, m, n, d, E, schedules in ABFT_SHAPES:
        for mode in ("int8", "fp8_e4m3"):
            plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                            epilogue=QuantEpilogue(mode))
            if E:
                qt = expert_weights(gen, n, d, mode)
                cw = weight_checksum(qt.q, qt.scale)
            else:
                w = (torch.randn(n, d, generator=cpu) / math.sqrt(n)).to("cuda", torch.bfloat16)
                qt = quantize_weight(w, mode, with_check=True)
                cw = qt.check
            for sched in schedules:
                name, twin = names[(int(E > 0), sched)]
                print(f"{name} {label} {mode}: {_geometry(m, n, d, mode, E, sched, True)}; "
                      f"{twin}: {_geometry(m, n, d, mode, E, sched, False)}")
                for kind in ("exact", "gaussian", "flip", "slab"):
                    x = _k34_input(gen, m * max(E, 1), n,
                                   "exact" if kind == "exact" else "gaussian")
                    if E:
                        x = x.view(m, E, 1, n)
                        x[:, ::3] = 0
                    undo, k = None, None
                    if kind in ("flip", "slab"):
                        undo, k = _corrupt_weight(qt, kind, 1 if E else 0)
                    if E:
                        base = quant_dot_experts(x, qt.q, qt.scale, plan, sched)
                        y, r = quant_dot_experts(x, qt.q, qt.scale, plan, sched, check=cw)
                        yp, rp = quant_dot_experts_abft_plain(x, qt.q, qt.scale, cw, plan)
                    else:
                        base = quant_dot(x, qt.q, qt.scale, plan, sched)
                        y, r = quant_dot(x, qt.q, qt.scale, plan, sched, check=cw)
                        yp, rp = quant_dot_abft_plain(x, qt.q, qt.scale, cw, plan)
                    torch.cuda.synchronize()
                    x2 = x.reshape(-1, n)
                    y1, (q1, s1) = _fwht_epilogue(x2, plan)
                    agree = _same_rows(y1, transform_plain(x2, plan))
                    shp = (m, E, 1, n) if E else (m, n)
                    yk1, rk1 = _abft_from_q(q1.view(shp), s1.view(*shp[:-1], 1), qt.q,
                                            qt.scale, cw, mode, bool(E))
                    if undo is not None:
                        undo()
                    same = bool(torch.equal(_bits(y), _bits(base)))
                    ratio, k1_ratio = _ratio(y, r, n, d), _ratio(yk1, rk1, n, d)
                    ok, ok1 = ratio <= 1.0, k1_ratio <= 1.0
                    gaps = _ratio(y, r - rk1, n, d)
                    dev = float(gaps[ok1].max()) if bool(ok1.any()) else 0.0
                    worst_dev = max(worst_dev, dev)
                    okp = _ratio(yp, rp, n, d) <= 1.0
                    band = (k1_ratio - 1.0).abs() <= BAND
                    bad1 = int(((ok != ok1) & ~band).sum())
                    badp = int(((ok != okp) & agree & ~band).sum())
                    op = _operand_from_q(q1, mode).to(torch.float32)
                    if E:   # the corruption is in expert 1: other experts' rows miss it
                        other = torch.ones(m, E, dtype=torch.bool, device=op.device)
                        other[:, 1] = False
                        other = other.reshape(-1)
                    else:
                        other = torch.zeros(len(ok), dtype=torch.bool, device=op.device)
                    missed = other | ((op[:, k] == 0) if k is not None else (op == 0).all(-1))
                    false_pos = int((~ok & missed).sum())
                    trips = int((~ok).sum())
                    print(f"  {kind:8s} {name:6s} bitwise to {twin} {same}; trips {trips}/"
                          f"{len(ok)} of which touched by the change {int((~missed).sum())} "
                          f"(plain on the FWHT's rotation {int((~ok1).sum())}, plain "
                          f"{int((~okp).sum())}); |r| / tolerance max {float(ratio.max()):.3e}"
                          f", over touched rows min "
                          f"{float(ratio[~missed].min()) if bool((~missed).any()) else 0:.3e}; "
                          f"verdicts off the FWHT's {bad1}, off plain where rotations agree {badp}, "
                          f"rows in the 1% band {int(band.sum())}; untouched rows tripped "
                          f"{false_pos}; |r - r_plain on the FWHT's rotation| / tolerance max "
                          f"{dev:.3e} over the rows it passes (limit {RESID_C:g}), "
                          f"{float(gaps.max()):.3e} over all rows")
                    if not same:
                        fail(f"{name} {label} {mode} {kind}: output differs from {twin}")
                    if bad1 or badp or false_pos:
                        fail(f"{name} {label} {mode} {kind}: verdicts differ or an untouched "
                             "row tripped")
                    if not dev <= RESID_C:
                        fail(f"{name} {label} {mode} {kind}: residual {dev:.3e} of the "
                             f"tolerance off the plain version's (limit {RESID_C:g})")
                    if kind in ("exact", "gaussian"):
                        worst = max(worst, float(ratio.max()))
                        if trips:
                            fail(f"{name} {label} {mode} {kind}: a healthy row tripped")
                    elif kind == "slab" and not trips:
                        fail(f"{name} {label} {mode}: the slab tripped no row")
            del qt, cw
            torch.cuda.empty_cache()
    print(f"largest healthy |r| / tolerance: {worst:.3e}; largest |r - r_plain on the FWHT's "
          f"rotation| / tolerance: {worst_dev:.3e} (limit {RESID_C:g})")
    return worst, worst_dev


def time_abft(gen) -> dict:
    """The ABFT twins beside their twins at the decode shapes of their
    paths, each through the quant_dot timing harness (CUDA events and the
    profiler): K7a-ro at phi4-mini (int8) and maverick's dense sites
    (fp8_e4m3), K7a-s at maverick's dense sites, K7b and K7b-s at
    maverick's experts (fp8_e4m3), each with its twin on the same rows. The
    bound is the twin's bytes plus the checksum read and the residual
    written; no PyTorch call computes the product with its residual, so
    there is no library time: the device-time overhead against the twin
    stands in its place. Returns the JSON entries (K7a-ro: phi4-mini's)."""
    from repro_torch.bench.quant_dot import Case, expert_weights
    from repro_torch.core.wquant import quantize_weight, weight_checksum

    print("-- kernel phase: ABFT twins' times beside their twins (decode shapes)")
    entries = {}
    cases = [("K7a-ro", "K4", "int8", *PHI4_DOWN, 0),
             ("K7a-ro", "K4", "fp8_e4m3", *MAVERICK_DOWN, 0),
             ("K7a-s", "K5", "fp8_e4m3", *MAVERICK_DOWN, 0),
             ("K7b", "K6", "fp8_e4m3", *MAVERICK_DOWN, EXPERTS),
             ("K7b-s", "K6s", "fp8_e4m3", *MAVERICK_DOWN, EXPERTS)]
    weights = {}
    for name, twin, mode, n, d, E in cases:
        if (mode, n, d, E) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            if E:
                qt = expert_weights(gen, n, d, mode)
                weights[(mode, n, d, E)] = (qt, weight_checksum(qt.q, qt.scale))
            else:
                qt = quantize_weight((torch.randn(n, d, generator=gen, device="cuda")
                                      / math.sqrt(n)).to(torch.bfloat16), mode,
                                     with_check=True)
                weights[(mode, n, d, E)] = (qt, qt.check)
        qt, cw = weights[(mode, n, d, E)]
        x = (torch.randn(SLOTS * max(E, 1), n, generator=gen, device="cuda") * 3).to(
            torch.bfloat16)
        if E:
            x = x.view(SLOTS, E, 1, n)
        base = _measure(Case(twin, mode, SLOTS, n, d), gen, qt, cw, x)
        rec = _measure(Case(name, mode, SLOTS, n, d), gen, qt, cw, x)
        print(_record_line(f"{twin:6s} {mode:8s} {tuple(x.shape)} -> {d}", base))
        print(_record_line(f"{name:6s} {mode:8s} {tuple(x.shape)} -> {d}", rec)
              + f"; device time over {twin} {_dev_ratio(rec['device_ms'], base['device_ms'])}")
        entries.setdefault(name, _entry(rec))
    weights.clear()
    torch.cuda.empty_cache()
    return entries


REVISIT_SHAPES = (  # (label, rows, n, d): the paths that give K8 and K7a-rv rows
    ("phi4-mini decode", SLOTS, *PHI4_DOWN),
    ("phi4-mini training rows", TRAIN_ROWS, *PHI4_DOWN),
    ("maverick dense decode", SLOTS, *MAVERICK_DOWN),
)


def hold_k8(gen) -> None:
    """K8 (the revisit schedule) at phi4-mini's decode and training row
    counts and maverick's dense decode shape, int8 and fp8_e4m3, exact-sum
    and Gaussian rows: bitwise K4's output, and the K4 rule against the
    plain version (``_hold_rows``)."""
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.core.wquant import quantize_weight
    from repro_torch.kernels.hadacore import transform_plain
    from repro_torch.kernels.quant_dot import epilogue_dot, quant_dot, quant_dot_plain

    print("-- kernel phase: K8 (revisit) against K4 and its plain version")
    cpu = torch.Generator().manual_seed(4)
    for label, m, n, d in REVISIT_SHAPES:
        w = (torch.randn(n, d, generator=cpu) / math.sqrt(n)).to("cuda", torch.bfloat16)
        for mode in ("int8", "fp8_e4m3"):
            qt = quantize_weight(w, mode)
            plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                            epilogue=QuantEpilogue(mode))
            print(f"K8 {label} {mode}: {_geometry(m, n, d, mode, 0, 'revisit', False)}; "
                  f"K4: {_geometry(m, n, d, mode, 0, 'rotate_once', False)}")
            for kind in ("exact", "gaussian"):
                x = _k34_input(gen, m, n, kind)
                k8 = quant_dot(x, qt.q, qt.scale, plan, "revisit")
                k4 = quant_dot(x, qt.q, qt.scale, plan, "rotate_once")
                torch.cuda.synchronize()
                same = bool(torch.equal(_bits(k8), _bits(k4)))
                tag = f"K8 {m:4d} x {n} -> {d} {mode:8s} {kind:8s}"
                print(f"{tag}: bitwise to K4 {same}")
                if not same:
                    fail(f"{tag}: differs from K4")
                y1, (q1, s1) = _fwht_epilogue(x, plan)
                agree = _same_rows(y1, transform_plain(x, plan))
                from_rot = epilogue_dot(q1, s1, qt.q, qt.scale, mode, torch.bfloat16)
                _hold_rows(tag, k8, quant_dot_plain(x, qt.q, qt.scale, plan), from_rot,
                           agree, mode, kind == "exact")
        del w, qt
        torch.cuda.empty_cache()


def time_revisit(gen) -> dict:
    """The schedule A/B: K8 beside K4 at the revisit shapes, int8 and
    fp8_e4m3, both through the quant_dot timing harness on the same rows;
    the rotations each row block gets (K8: one per weight tile of 128
    columns; K4: one per cluster); the bound (the same work as K4's: the
    redundant rotations are not needed work), the plain version and the
    library contraction. Then K7a-rv beside K8 at phi4-mini's decode shape
    (int8; the ABFT revisit serving path). The JSON entries: K8 at the
    training rows in int8 (the training path's shape), K7a-rv at
    phi4-mini's decode shape."""
    from repro_torch.bench.quant_dot import Case
    from repro_torch.core.wquant import quantize_weight
    from repro_torch.kernels.quant_dot import REVISIT_BLOCK_N

    print("-- kernel phase: schedule A/B, K8 (revisit) beside K4 (rotate-once)")
    entries = {}
    for label, m, n, d in REVISIT_SHAPES:
        w = (torch.randn(n, d, generator=gen, device="cuda") / math.sqrt(n)).to(
            torch.bfloat16)
        for mode in ("int8", "fp8_e4m3"):
            qt = quantize_weight(w, mode, with_check=True)
            x = (torch.randn(m, n, generator=gen, device="cuda") * 3).to(torch.bfloat16)
            r4 = _measure(Case("K4", mode, m, n, d), gen, qt, qt.check, x)
            r8 = _measure(Case("K8", mode, m, n, d), gen, qt, qt.check, x)
            g4 = r4["grid"]
            print(_record_line(f"K4 {label} {mode:8s} {m} x {n} -> {d}", r4))
            print(_record_line(f"K8 {label} {mode:8s} {m} x {n} -> {d}", r8)
                  + f"; device time over K4 {_dev_ratio(r8['device_ms'], r4['device_ms'])}; "
                  f"rotations per row block K8 {-(-d // REVISIT_BLOCK_N)}, K4 "
                  f"{g4['splits'] // g4['cluster']}")
            if label == "phi4-mini training rows" and mode == "int8":
                entries["K8"] = _entry(r8)
            if label == "phi4-mini decode" and mode == "int8":
                rv = _measure(Case("K7a-rv", mode, m, n, d), gen, qt, qt.check, x)
                print(_record_line(f"K7a-rv {label} int8", rv) + f"; device time over K8 "
                      f"{_dev_ratio(rv['device_ms'], r8['device_ms'])}")
                entries["K7a-rv"] = _entry(rv)
            del qt
        del w
        torch.cuda.empty_cache()
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
# of llama3-405b's 126 layers: the most that keep every peak of its model
# phase under PEAK_LIMIT; the binding one is init's (an f32 draw of a 16384 x
# 53248 matrix and its quantization, ~18.6 GB above the weights)
LLAMA3_405B_LAYERS = 15
PREFILL_LIMITS = {
    "llama3-8b": {1: 3e-3, 32: 0.045},
    "phi4-mini-3.8b": {1: 3e-3, 32: 0.0275},
    # depth 2 is the first (dense, MoE) pair, 4 the whole cut model
    "llama4-maverick-400b-a17b": {2: 0.03, 4: 0.044},
    "llama3-405b": {1: 8.9e-3, LLAMA3_405B_LAYERS: 0.041},
    "qwen1.5-4b": {1: 1.5e-3, 40: 0.030},
    "starcoder2-15b": {1: 3.9e-3, 40: 0.032},
    # depth 1 is the first MoE layer, 32 the whole model
    "mixtral-8x7b": {1: 3.4e-3, 32: 0.036},
}


def _calibration_backends():
    """Registers (once) the backends that calibrate the prefill limit; the
    model reaches them through ``REPRO_HADAMARD_BACKEND``.

    The witness, a correct path that differs from the plain one as the
    kernels may:

      k1_rotations   every site rotates with the routine its kernel runs
                     -- K1's tensor cores at the transform and K2 sites,
                     the CUDA-core FWHT (``fwht_cuda``) at the K4 / K6
                     sites -- and applies the plain epilogue, and the
                     down projections contract with the plain GEMM: the
                     kernels' arithmetic up to the fp8 GEMM's summation
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
    from repro_torch.kernels.hadacore import fwht_cuda, transform, transform_plain
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

    def k1_rows(x, plan, fwht=False):
        """K1's rotation of x (``fwht``: the CUDA-core FWHT's, the quant_dot
        kernels' own), then the plain per-token quantization."""
        cd = torch_dtype(plan.compute_dtype)
        rplan = plan_for(plan.p, dtype=cd, backend="cuda", device_type="cuda")
        x2 = x.to(cd).reshape(-1, plan.p).contiguous()
        y = fwht_cuda(x2, torch.empty_like(x2), rplan) if fwht else transform(x2, rplan)
        q, s = registry._quantize_rows(y.float(), plan.epilogue.mode)
        return q.reshape(x.shape), s.reshape(*x.shape[:-1], 1)

    @registry.register_backend
    class K1Rotations(Calibration):
        name = "k1_rotations"

        def transform(self, x, plan, in_place=False):
            return transform(x, plan, in_place)

        def fused_dequant(self, x, plan):
            q, s = k1_rows(x, plan)
            return registry._dequantize(q, s, plan.epilogue.mode).to(x.dtype)

        def quant_dot(self, x, wq, sw, plan, schedule=None):
            q, s = k1_rows(x, plan, fwht=True)
            return epilogue_dot(q, s, wq, sw.reshape(1, -1), plan.epilogue.mode,
                                x.dtype)

        def quant_dot_experts(self, x, wq, sw, plan, schedule=None):
            q, s = k1_rows(x, plan, fwht=True)
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
    """A context in which the first feed-forward output (layer 0's MLP, or
    its MoE block in a model without dense layers) has its largest value
    moved by 1 ulp: the smallest change a rounding can make to the residual
    stream that every later layer reads. (A flip inside a rotation is
    mostly absorbed by the quantization step of the site after it.)"""

    def __enter__(self):
        from repro_torch.models import mlp

        self.mlp, self.apply, self.apply_moe = mlp, mlp.apply_mlp, mlp.apply_moe
        armed = [True]

        def flip(y):
            y = y.contiguous()
            if armed[0]:
                flat = y.view(-1)
                flat.view(torch.int16)[int(flat.float().abs().argmax())] ^= 1
                armed[0] = False
            return y

        def apply_mlp(cfg, p, x):
            return flip(self.apply(cfg, p, x))

        def apply_moe(cfg, p, x):
            y, aux = self.apply_moe(cfg, p, x)
            return flip(y), aux

        mlp.apply_mlp, mlp.apply_moe = apply_mlp, apply_moe

    def __exit__(self, *exc):
        self.mlp.apply_mlp, self.mlp.apply_moe = self.apply, self.apply_moe


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
    """Every launch counter by kernel; "FWHT", the baseline, is on no path
    (every expected count of it is 0: nothing falls back to it)."""
    from repro_torch.kernels.fused_quant import fused_cuda, fused_dequant_cuda
    from repro_torch.kernels.hadacore import fwht_cuda, hadacore_cuda
    from repro_torch.kernels import quant_dot as qd

    return {"K1": hadacore_cuda, "FWHT": fwht_cuda, "K2": fused_dequant_cuda,
            "K3": fused_cuda,
            "K4": qd.quant_dot_cuda, "K5": qd.quant_dot_streamed_cuda,
            "K6": qd.quant_dot_experts_cuda, "K6s": qd.quant_dot_experts_streamed_cuda,
            "K7a-ro": qd.quant_dot_abft_cuda, "K7a-s": qd.quant_dot_abft_streamed_cuda,
            "K7b": qd.quant_dot_experts_abft_cuda,
            "K7b-s": qd.quant_dot_experts_abft_streamed_cuda,
            "K8": qd.quant_dot_revisit_cuda, "K7a-rv": qd.quant_dot_abft_revisit_cuda}


# The models served, each with its quantization, the launches one model
# pass must make (every kernel not named: 0) with ABFT off and on, the
# controls of its prefill check, the depth a model is cut to, and whether
# its ABFT phase (and, dense, its linter serving sites) runs: the ABFT-on
# and fault runs stay on the three models of the earlier slices.
MODELS = {
    # ABFT on: the unfused down projection (d_ff = 14336) rotates twice,
    # the second time in xla_quant_dot_resid
    "llama3-8b": dict(mode="fp8_e4m3", per_pass={"K1": 32, "K2": 64},
                      abft_per_pass={"K1": 64, "K2": 64},
                      controls=("k2_no_quant", "k1_exact_scale")),
    "phi4-mini-3.8b": dict(mode="int8", per_pass={"K2": 64, "K4": 32},
                           abft_per_pass={"K2": 64, "K7a-ro": 32},
                           revisit_abft_per_pass={"K2": 64, "K7a-rv": 32},
                           controls=("k4_no_rotate", "k2_no_quant")),
    # 2 of the 24 (attn, moe) groups: 4 of 48 layers, ~35 GB of int8 / fp8
    # weights; all 48 would take ~390 GB, beyond one 80 GB card
    "llama4-maverick-400b-a17b": dict(
        mode="fp8_e4m3", per_pass={"K2": 8, "K4": 4, "K6": 2},
        abft_per_pass={"K2": 8, "K7a-ro": 4, "K7b": 2},
        streamed_abft_per_pass={"K2": 8, "K7a-s": 4, "K7b-s": 2},
        controls=("k6_no_rotate", "k4_no_rotate", "k2_no_quant"),
        groups=((("attn", "moe"), 2),)),
    # d_ff not a power of 2: the down projection (mixtral: the expert site,
    # over the dispatched rows) is one grouped K1 launch per layer, then
    # the unfused quantize and contraction; K2 at the Q and K sites
    "llama3-405b": dict(mode="fp8_e4m3",
                        per_pass={"K1": LLAMA3_405B_LAYERS, "K2": 2 * LLAMA3_405B_LAYERS},
                        controls=("k2_no_quant", "k1_exact_scale"), abft=False,
                        groups=((("attn",), LLAMA3_405B_LAYERS),)),
    "qwen1.5-4b": dict(mode="int8", per_pass={"K1": 40, "K2": 80},
                       controls=("k2_no_quant", "k1_exact_scale"), abft=False),
    "starcoder2-15b": dict(mode="fp8_e4m3", per_pass={"K1": 40, "K2": 80},
                           controls=("k2_no_quant", "k1_exact_scale"), abft=False),
    "mixtral-8x7b": dict(mode="fp8_e4m3", per_pass={"K1": 32, "K2": 64},
                         controls=("k2_no_quant", "k1_exact_scale"), abft=False),
}
# health() counters a healthy run must leave at 0
HEALTH_ZERO = ("rung", "degrades", "watchdog_trips", "step_retries", "nan_guard_trips",
               "sdc_retired", "abft_kv_trips", "abft_sdc_detections", "abft_params_checks")
PEAK_LIMIT = 72e9   # bytes: "well under" the card's 80 GB


def model_phase(args, arch: str, lint_sites=None):
    """One model at full width and depth: the layer-0 stage trace and the
    calibrated prefill check, then the serving run with the launch counters
    zeroed just before and read just after, then a decode profile; for the
    dense models the linter's serving sites of the engine that served (a
    decode step and a prefill-insert, appended to ``lint_sites``). Returns
    (summary, launches)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.lm import init_lm
    from repro_torch.serving import synthetic_stream

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
          f"{cfg.experts_per_token} shared={cfg.moe_shared_expert} act={cfg.act} "
          f"norm={cfg.norm} qkv_bias={cfg.qkv_bias} window={cfg.sliding_window}, "
          f"{spec['mode']} + hadamard + {spec['mode']} KV quantization, int8 weights")
    if cfg.num_layers != full.num_layers:
        print(f"depth cut: {cfg.groups} of the published {full.groups}: "
              f"{cfg.num_layers} of {full.num_layers} layers at full width")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    peak = torch.cuda.max_memory_allocated()
    print(f"init + quantize layer by layer: {time.perf_counter() - t0:.1f} s, "
          f"{wbytes / 1e9:.2f} GB of weights, peak {peak / 1e9:.2f} GB")
    if peak > PEAK_LIMIT:
        fail(f"{arch}: init's peak memory {peak / 1e9:.2f} GB")
    check_param_count(cfg, params)
    torch.cuda.reset_peak_memory_stats()

    hold_prefill_against_plain(cfg, params, quant, args.seed, spec["controls"])

    stream = synthetic_stream(8, vocab_size=cfg.vocab_size,
                              prompt_len=(16, PREFILL_LEN),
                              max_new_tokens=(16, 32), rate=1.0,
                              seed=args.seed)
    engine, comps, launches, wall = _serve(cfg, params, stream)
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
    for k in launches:
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
    if not spec.get("abft", True):
        return s, launches
    if lint_sites is not None and not cfg.num_experts:
        from repro_torch.analysis.sites import serving_sites

        lint_sites += serving_sites(arch, engine=engine)
    if cfg.num_experts:
        streamed = streamed_pass(cfg, params, args.seed)
        launches.update({k: streamed[k] for k in ("K5", "K6s")})
    got = abft_phase(arch, cfg, params, stream, engine, args.seed)
    launches = {k: launches[k] + got[k] for k in launches}
    return s, launches


def check_param_count(cfg, params) -> None:
    """The weights on the card hold ``launch.flops.count_params``'s number
    of values (a quantized leaf's values and scales), counted from the
    port's own parameter shapes on the meta device."""
    from repro_torch.launch.flops import count_params

    held = sum(t.numel() for t in _leaves(params))
    want = count_params(cfg)["total"]
    print(f"parameters on the card: {held} values, count_params {want:.0f}")
    if held != want:
        fail(f"{cfg.name}: {held} parameter values on the card, count_params {want}")


# The window check: mixtral-8x7b at full width, depth cut to 2 of its 32
# layers, one prompt of WINDOW_PROMPT tokens (the 4096-token window plus
# 128) and WINDOW_STEPS greedy decode steps at a shared scalar position. The
# limit on the relative RMS difference of the logits past the window
# (prefill positions >= 4096 and every decode step) between the kernels and
# the plain versions sits between the witnesses and the control (full
# attention, ``sliding_window=0``), PERF.md.
WINDOW_PROMPT, WINDOW_STEPS, WINDOW_LAYERS = 4096 + 128, 8, 2
WINDOW_LIMIT = 0.07


def window_phase(args) -> dict:
    """mixtral-8x7b's sliding window where it bites: the prefill of one
    prompt longer than the window, then ``WINDOW_STEPS`` decode steps fed the
    plain run's greedy tokens, through the plain versions, the kernels (the
    launch counters zeroed just before and read just after: one K1 and two
    K2 per layer and pass), the witnesses ``one_flip`` and ``k1_rotations``
    and the control, the kernels without the window (every run but the plain
    one routed as the plain run was, as the prefill holds are). Past the
    window the kernels and witnesses must stay within ``WINDOW_LIMIT`` of
    the plain run and the control beyond it; before the window the control
    is bitwise the kernels' run (the masks agree there). Returns the
    kernels' launches."""
    import contextlib
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels.registry import BACKEND_ENV_VAR
    from repro_torch.models.lm import init_lm, lm_decode_step, lm_forward, pad_kv_caches

    quant = QuantConfig(mode="fp8_e4m3", rotate="hadamard", backend="cuda", kv_quant=True)
    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full.with_quant(quant), weight_quant="int8",
                              groups=((("moe",), WINDOW_LAYERS),))
    W, P, V = cfg.sliding_window, WINDOW_PROMPT, cfg.vocab_size
    print(f"-- window phase: {cfg.name} at full width, depth cut to {cfg.num_layers} of "
          f"{full.num_layers} layers; one prompt of {P} tokens against the window of {W}, "
          f"then {WINDOW_STEPS} decode steps at a scalar position")
    _calibration_backends()
    params = init_lm(cfg, seed=args.seed, device="cuda")
    rng = np.random.default_rng(args.seed + 7)
    prompt = torch.from_numpy(rng.integers(0, V, (1, P))).cuda()
    forced = []

    def run(route, window=W, routing=None):
        c = _with_backend(cfg, quant, "torch" if route in ("torch", "one_flip") else
                          "cuda" if route == "cuda" else "auto")
        c = dataclasses.replace(c, sliding_window=window)
        if route not in ("torch", "one_flip", "cuda"):
            os.environ[BACKEND_ENV_VAR] = route
        flip = _one_flip() if route == "one_flip" else contextlib.nullcontext()
        try:
            with torch.inference_mode(), flip, routing or contextlib.nullcontext():
                logits, _, caches = lm_forward(c, params, {"tokens": prompt}, want_cache=True)
                caches = pad_kv_caches(c, caches, P + WINDOW_STEPS)
                outs = [logits[0, :, :V].float()]
                for i in range(WINDOW_STEPS):
                    if len(forced) <= i:
                        forced.append(outs[-1][-1].argmax().reshape(1, 1))
                    step, caches = lm_decode_step(c, params, caches, forced[i],
                                                  torch.tensor(P + i, device="cuda"))
                    outs.append(step[0, :, :V].float())
            torch.cuda.synchronize()
        finally:
            os.environ.pop(BACKEND_ENV_VAR, None)
        out = torch.cat(outs)
        if not torch.isfinite(out).all():
            fail(f"window phase: non-finite logits ({route}, window {window})")
        return out

    plain_routing = _routing()
    plain = run("torch", routing=plain_routing)
    kern, launches = _counted(lambda: run("cuda", routing=_routing(plain_routing.experts)))
    passes = 1 + WINDOW_STEPS
    want = {k: 0 for k in launches}
    want.update({"K1": cfg.num_layers * passes, "K2": 2 * cfg.num_layers * passes})
    print(f"kernels' launches over {passes} passes: {launches}")
    if launches != want:
        fail(f"window phase: launches {launches}, expected {want}")
    ctl = run("cuda", window=0, routing=_routing(plain_routing.experts))
    same_before = torch.equal(kern[:W], ctl[:W])
    rel = {}
    for name, got in (("cuda", kern),
                      ("one_flip", run("one_flip", routing=_routing(plain_routing.experts))),
                      ("k1_rotations", run("k1_rotations",
                                           routing=_routing(plain_routing.experts))),
                      ("full attention", ctl)):
        before = float((got[:W] - plain[:W]).norm() / plain[:W].norm())
        rel[name] = float((got[W:] - plain[W:]).norm() / plain[W:].norm())
        print(f"window: {name:14s} vs plain: relative RMS past the window {rel[name]:.6f} "
              f"(positions {W}..{P + WINDOW_STEPS - 1}), before it {before:.6f}")
    print(f"window: control before the window bitwise the kernels' run: "
          f"{same_before}; limit {WINDOW_LIMIT:g}")
    if not same_before:
        fail("window phase: full attention differs from the window before the window bites")
    for name in ("cuda", "one_flip", "k1_rotations"):
        if not rel[name] <= WINDOW_LIMIT:
            fail(f"window phase: {name} at {rel[name]} > {WINDOW_LIMIT}")
    if not rel["full attention"] > WINDOW_LIMIT:
        fail(f"window phase: the control (no window) at {rel['full attention']} passes "
             f"{WINDOW_LIMIT}")
    del params
    torch.cuda.empty_cache()
    return launches


LAUNCHER_GEN = 16


def launcher_phase(args) -> dict:
    """The one-shot launcher, ``repro_torch.launch.serve.main``, once at full
    width on qwen1.5-4b (int8 W8A8 + Hadamard + int8 KV, int8 weights; 4
    prompts of 64 tokens, 16 greedy tokens each at a scalar position), the
    launch counters zeroed just before and read just after: 40 K1 and 80 K2
    per model pass (the prefill and 15 decode steps), nothing else. Returns
    the launches."""
    from repro_torch.launch import serve

    argv = ["--arch", "qwen1.5-4b", "--scale", "1.0", "--batch", str(SLOTS),
            "--prompt-len", str(PREFILL_LEN), "--gen", str(LAUNCHER_GEN), "--quant",
            "int8", "--rotate", "hadamard", "--kernel", "cuda", "--device", "cuda",
            "--seed", str(args.seed)]
    print("-- launcher phase: python -m repro_torch.launch.serve " + " ".join(argv))
    out, launches = _counted(lambda: serve.main(argv))
    cfg, toks = out["cfg"], out["tokens"]
    want = {k: 0 for k in launches}
    want.update({"K1": 40 * LAUNCHER_GEN, "K2": 80 * LAUNCHER_GEN})
    print(f"launcher: {out['tokens_per_s']:.1f} tok/s steady state, prefill "
          f"{out['prefill_s']:.3f} s; launches {launches} over {LAUNCHER_GEN} model passes")
    if launches != want:
        fail(f"launcher phase: launches {launches}, expected {want}")
    if toks.shape != (SLOTS, LAUNCHER_GEN) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"launcher phase: bad tokens {toks}")
    if not out["tokens_per_s"] > 0:
        fail("launcher phase: no steady-state decode rate")
    torch.cuda.empty_cache()
    return launches


def streamed_pass(cfg, params, seed: int) -> dict:
    """The prefill of 4 prompts of 64 tokens plus 4 greedy decode steps,
    once with the rotate-once kernels and once under
    ``REPRO_QUANT_DOT_SCHEDULE=streamed``, the launch counters zeroed just
    before the second and read just after: the logits of every pass and the
    KV caches must be bitwise equal, and the streamed run must launch K5
    where rotate-once launches K4 and K6s where it launches K6. Returns the
    streamed run's launches."""
    once = _prefill_decode(cfg, params, seed)
    got, launches = _counted(lambda: _streamed(lambda: _prefill_decode(cfg, params, seed)))
    same = _same_run(got, once)
    print(f"-- streamed pass: prefill ({SLOTS}, {PREFILL_LEN}) + 4 decode steps under "
          f"schedule=streamed: logits and KV caches bitwise to rotate-once {same}; "
          f"launches {launches} over 5 model passes")
    if not same:
        fail("the streamed schedule's logits or caches differ from rotate-once")
    want = {k: 0 for k in launches}
    want.update({"K2": 8 * 5, "K5": 4 * 5, "K6s": 2 * 5})
    if launches != want:
        fail(f"streamed pass launched {launches}, expected {want}")
    return launches


def _counted(fn):
    """``fn()`` with the launch counters zeroed just before and read just
    after: (its result, the launches)."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def _streamed(fn):
    """``fn()`` under ``REPRO_QUANT_DOT_SCHEDULE=streamed``."""
    from repro_torch.kernels.quant_dot import SCHEDULE_ENV_VAR

    os.environ[SCHEDULE_ENV_VAR] = "streamed"
    try:
        return fn()
    finally:
        os.environ.pop(SCHEDULE_ENV_VAR, None)


def _abft_cfg(cfg, schedule=None):
    """``cfg`` with ABFT switched on (and the kernels' schedule pinned)."""
    import dataclasses

    return cfg.with_quant(dataclasses.replace(cfg.quant, abft=True, schedule=schedule))


class _residual_spy:
    """Records, while active, every verified site's largest |r| /
    tolerance (``verify.residual_ok``) and every unfused site's largest
    |r| (``xla_quant_dot_resid``), as device tensors read once at the end;
    both functions still run as they are."""

    def __enter__(self):
        from repro_torch import verify
        from repro_torch.kernels import quant_dot as qd

        self.ratios, self.xla = [], []
        self._ok, self._xla = verify.residual_ok, qd.xla_quant_dot_resid

        def ok(y, r, *, n, d):
            self.ratios.append(_ratio(y, r, n, d).max())
            return self._ok(y, r, n=n, d=d)

        def xla(*a, **kw):
            r = self._xla(*a, **kw)
            self.xla.append(r.abs().max())
            return r

        verify.residual_ok, qd.xla_quant_dot_resid = ok, xla
        return self

    def __exit__(self, *exc):
        from repro_torch import verify
        from repro_torch.kernels import quant_dot as qd

        verify.residual_ok, qd.xla_quant_dot_resid = self._ok, self._xla

    def worst(self):
        r = float(torch.stack(self.ratios).max()) if self.ratios else None
        x = float(torch.stack(self.xla).max()) if self.xla else None
        return r, x


def _prefill_decode(cfg, params, seed: int, steps: int = 4):
    """The prefill of 4 prompts of 64 tokens plus ``steps`` greedy decode
    steps: (every pass's logits, the KV caches)."""
    from repro_torch.models.lm import lm_decode_step, lm_prefill, pad_kv_caches

    rng = np.random.default_rng(seed + 1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SLOTS, PREFILL_LEN))).cuda()
    with torch.inference_mode():
        logits, caches = lm_prefill(cfg, params, {"tokens": prompt})
        caches = pad_kv_caches(cfg, caches, PREFILL_LEN + steps)
        outs = [logits]
        for i in range(steps):
            tok = outs[-1][:, -1].argmax(-1, keepdim=True)
            logits, caches = lm_decode_step(cfg, params, caches, tok,
                                            torch.tensor(PREFILL_LEN + i, device=tok.device))
            outs.append(logits)
    torch.cuda.synchronize()
    return outs, caches


def _same_run(a, b) -> bool:
    """Are two ``_prefill_decode`` results bitwise equal?"""
    return (all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a[0], b[0]))
            and all(torch.equal(_bits(x[k]), _bits(y[k]))
                    for x, y in zip(a[1], b[1]) for k in ("k", "v")))


def _serve(cfg, params, stream, **kw):
    """Serve ``stream`` on a fresh engine with the launch counters zeroed
    just before and read just after: (engine, completions, launches,
    wall seconds)."""
    from repro_torch.serving import ServeEngine

    engine = ServeEngine(cfg, params, num_slots=SLOTS, max_len=MAX_LEN,
                         prefill_len=PREFILL_LEN, device="cuda", **kw)
    t0 = time.perf_counter()
    comps, launches = _counted(lambda: engine.run(stream))
    return engine, comps, launches, time.perf_counter() - t0


def abft_serving(tag, cfg, params, stream, off, per_pass) -> dict:
    """Serve ``stream`` with ABFT on (``cfg`` has it): every request ok and
    its tokens bitwise those of the ABFT-off run (``off``: rid -> tokens),
    the ABFT launches per model pass, and a health() with no trip, no
    retry, no ladder step. Returns the launches."""
    engine, comps, launches, wall = _serve(cfg, params, stream)
    s = engine.summary()
    h = s["health"]
    passes = s["prefill_calls"] + s["decode_calls"]
    same = all(c.tokens == off[c.rid] for c in comps)
    print(f"-- ABFT serving, {tag}: {s['requests']} requests / {s['generated_tokens']} "
          f"tokens in {s['decode_steps']} decode steps ({wall:.1f} s wall): "
          f"{s['tokens_per_s']:.1f} tok/s, p50 {s['p50_token_ms']:.2f} ms / p99 "
          f"{s['p99_token_ms']:.2f} ms per token; tokens bitwise to ABFT off {same}; "
          f"launches per pass " + ", ".join(f"{k} {v / passes:g}" for k, v in launches.items()
                                            if v))
    print("   health: " + " ".join(f"{k}={v}" for k, v in h.items()))
    for k, v in launches.items():
        if v != per_pass.get(k, 0) * passes:
            fail(f"ABFT {tag}: {k} launches {v} != {per_pass.get(k, 0)} x {passes}")
    if len(comps) != len(stream) or any(c.status != "ok" for c in comps) or not same:
        fail(f"ABFT {tag}: not every request ok and bitwise to ABFT off")
    if h["abft_enabled"] != 1 or any(h[k] for k in HEALTH_ZERO):
        fail(f"ABFT {tag}: a healthy run reported {h}")
    return launches, engine


class _no_verdicts:
    """While active, the verified sites skip their verdict and select
    (``verify.residual_ok``, ``api._poison``): the residuals alone (the K7
    launches; llama3's unfused ``xla_quant_dot_resid``), for
    ``abft_step_split``'s measurement."""

    def __enter__(self):
        from repro_torch import verify
        from repro_torch.core import api

        self._ok, self._poison = verify.residual_ok, api._poison
        verify.residual_ok = lambda y, r, *, n, d: None
        api._poison = lambda y, ok: y
        return self

    def __exit__(self, *exc):
        from repro_torch import verify
        from repro_torch.core import api

        verify.residual_ok, api._poison = self._ok, self._poison


def abft_step_split(off_engine, on_engine, rounds: int = 15) -> None:
    """Where ABFT's decode-step overhead goes, at the positions the two
    serving runs left: the wall time (host clock, the device synchronized
    after each part) of the ABFT-off model pass beside the ABFT-on step's
    parts -- the KV check before the pass (``verify.kv_check``), the
    verified, guarded model pass (the K7 twins, every site's verdict and
    select, the logits guard), the same pass without the sites' verdicts
    and selects (``_no_verdicts``), those verdicts and selects alone
    (replayed on one pass's inputs), and the KV roll after it
    (``verify.kv_roll``). The parts run in turn, ``rounds`` times, and the
    medians are printed (the host's clock spreads from call to call); then
    one profiled call of each part gives its device operations and device
    time, the quant_dot kernels apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import verify
    from repro_torch.core import api

    pos = torch.from_numpy(on_engine.positions_h).to(on_engine.device)
    cur = {}

    def kv_check():
        cur["sums"] = verify.kv_check(on_engine.caches, pos, on_engine.kv_sums)[1]

    def kv_roll():
        verify.kv_roll(on_engine.caches, pos, cur["sums"])

    def bare_pass():
        with _no_verdicts():
            on_engine._decode()

    # one pass's verdict inputs, replayed alone: the sites' verdicts and
    # selects without the rest of the pass
    calls, ok_fn = [], verify.residual_ok

    def record(y, r, *, n, d):
        calls.append((y, r, n, d))
        return ok_fn(y, r, n=n, d=d)

    verify.residual_ok = record
    try:
        on_engine._decode()
    finally:
        verify.residual_ok = ok_fn

    def verdicts():
        for y, r, n, d in calls:
            api._poison(y, verify.residual_ok(y, r, n=n, d=d))

    parts = (("ABFT off: model pass", off_engine._decode),
             ("ABFT on: KV check", kv_check),
             ("ABFT on: model pass", on_engine._decode),
             ("ABFT on: pass, no verdicts", bare_pass),
             (f"ABFT on: {len(calls)} verdicts alone", verdicts),
             ("ABFT on: KV roll", kv_roll))
    for _, fn in parts:
        fn()
    torch.cuda.synchronize()
    walls = {label: [] for label, _ in parts}
    for _ in range(rounds):
        for label, fn in parts:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[label].append((time.perf_counter() - t0) * 1e3)
    print(f"   decode-step split, {rounds} rounds of the parts in turn (synchronized after "
          "every part), median wall:")
    for label, fn in parts:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = dev = qd = 0
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            t = getattr(evt, "self_device_time_total", None)
            if t is None:
                t = evt.self_cuda_time_total
            ops += evt.count
            dev += t
            if "quant_dot" in evt.key:
                qd += t
        w = sorted(walls[label])
        device = (f"{ops:5d} device operations, device {dev / 1e3:8.3f} ms, of it quant_dot "
                  f"kernels {qd / 1e3:.3f} ms" if ops else
                  "device not measured (the profiler captured no device event)")
        print(f"   {label:27s} {float(np.median(w)):9.3f} ms wall (min {w[0]:.3f}, max "
              f"{w[-1]:.3f}); {device}")


def abft_phase(arch, cfg, params, stream, off_engine, seed: int) -> dict:
    """The model's checksum-verified serving (ABFT on), on the model phase's
    own weights with their checksums attached (``verify.with_checks``, a
    chunk of experts at a time): a prefill + 4 decode steps bitwise equal
    to ABFT off (logits and caches) with every site's healthy residual
    printed (the unfused sites' exactly 0), then the serving run and its
    decode step split against ABFT off (``abft_step_split``). Returns the
    launches of the serving run(s)."""
    from repro_torch import verify

    spec = MODELS[arch]
    t0 = time.perf_counter()
    checked = verify.with_checks(params)
    torch.cuda.synchronize()
    print(f"-- ABFT phase: {arch}: checksums attached in {time.perf_counter() - t0:.2f} s")
    on = _abft_cfg(cfg)
    off_run = _prefill_decode(cfg, params, seed)
    with _residual_spy() as spy:
        on_run = _prefill_decode(on, checked, seed)
    ratio, xla = spy.worst()
    same = _same_run(on_run, off_run)
    print(f"prefill + 4 decode steps, ABFT on: logits and caches bitwise to ABFT off "
          f"{same}; {len(spy.ratios)} verified site calls, largest |r| / tolerance "
          f"{ratio}; {len(spy.xla)} of them unfused, largest |r| there {xla}")
    if not same:
        fail(f"{arch}: ABFT-on logits or caches differ from ABFT off")
    if (ratio is not None and not ratio <= 1.0) or (xla is not None and xla != 0.0):
        fail(f"{arch}: a healthy residual tripped or an unfused residual is not 0")
    launches = {k: 0 for k in _counters()}
    if "streamed_abft_per_pass" in spec:
        s_run, launches = _counted(lambda: _streamed(lambda: _prefill_decode(on, checked,
                                                                              seed)))
        want = {k: 5 * spec["streamed_abft_per_pass"].get(k, 0) for k in launches}
        same = _same_run(s_run, off_run)
        print(f"the same under schedule=streamed, ABFT on: bitwise to ABFT off rotate-once "
              f"{same}; launches {launches} over 5 model passes")
        if not same or launches != want:
            fail(f"{arch}: streamed ABFT run differs or launched {launches}, not {want}")
    off = {c.rid: c.tokens for c in off_engine.completions}
    got, on_engine = abft_serving(f"{arch} rotate-once", on, checked, stream, off,
                                  spec["abft_per_pass"])
    launches = {k: launches[k] + got[k] for k in launches}
    abft_step_split(off_engine, on_engine)
    del on_engine
    for sched in ("streamed", "revisit"):
        if f"{sched}_abft_per_pass" in spec:
            got, _ = abft_serving(f"{arch} {sched}", _abft_cfg(cfg, sched), checked,
                                  stream, off, spec[f"{sched}_abft_per_pass"])
            launches = {k: launches[k] + got[k] for k in launches}
    if arch == "phi4-mini-3.8b":
        fault_runs(cfg, checked, seed)
    return launches


def fault_runs(cfg, params, seed: int) -> None:
    """Faults injected into ABFT-on serving of the model (phi4-mini at full
    width; ``params`` carry their checksums), 6 requests on 4 slots (rids 1 and 2 end after one decode step;
    at step 3 rids 0, 3, 4, 5 are in flight, rid 0 in slot 0), each run
    checked for its completions and health() against an ABFT-off run of
    the same requests:

      * a zeroed 128-column slab of layer 0's down projection at step 3
        (a mis-delivered weight-stream tile): the four slots in flight
        retire ``sdc_detected`` (those caught at that step with clean token
        prefixes; a row's slab shift can fall under its tolerance, about 1
        row in 100, and is caught a step later: printed), the weight audit
        runs, rids 1 and 2 finish bitwise clean;
      * a KV row of slot 0 perturbed at step 3: only rid 0 retires
        ``sdc_detected``, ``abft_kv_trips`` = 1;
      * NaN in a KV row of slot 0 at step 3: only rid 0 retires
        ``nan_guard`` (the audit finds the weights clean);
      * one injected kernel raise at step 2: retried once, every token
        bitwise the clean run's;
      * two raises in a row: one rung down (cuda + rotate-once), loudly,
        every token bitwise the clean run's;
      * raises on every attempt from step 2: the ladder runs out at cuda +
        rotate-once (on the card it has no plain rung), loudly; the slots
        in flight retire ``engine_failed``, the queue is shed, and the
        requests that finished before keep their clean tokens;
      * one flipped bit (bit 6) of layer 0's down projection at step 3
        (the reference's single-event upset): printed -- how many slots
        the residual catches -- and the host audit ``params_ok`` must see
        it; at this width one bit shifts a row's residual by less than its
        tolerance (the kernel phase prints by how much).
    Every corruption is undone when its scope exits."""
    import dataclasses
    import warnings

    from repro_torch import verify
    from repro_torch.kernels.registry import WARN_ONCE_SEEN
    from repro_torch.testing.faults import FaultPlan, arrival_flood, inject

    def reqs():
        plen = min(32, PREFILL_LEN)
        longs = arrival_flood(4, prompt_len=plen, max_new_tokens=12, vocab=cfg.vocab_size,
                              seed=seed + 7)
        shorts = arrival_flood(2, prompt_len=plen, max_new_tokens=2, vocab=cfg.vocab_size,
                               seed=seed + 8)
        out = [longs[0], shorts[0], shorts[1], longs[1], longs[2], longs[3]]
        return [dataclasses.replace(r, rid=i) for i, r in enumerate(out)]

    _, clean, _, _ = _serve(cfg, params, reqs())
    ref = {c.rid: c.tokens for c in clean}
    on = _abft_cfg(cfg)
    print("-- fault runs (ABFT on), phi4-mini: 6 requests on 4 slots")

    def prefix(c):
        return c.tokens == ref[c.rid][:len(c.tokens)]

    def run(plan):
        with warnings.catch_warnings(record=True) as warned, inject(plan):
            warnings.simplefilter("always")
            engine, comps, _, _ = _serve(on, params, reqs())
            audit = verify.params_ok(engine.params)
        comps = {c.rid: c for c in comps}
        h = engine.health()
        print(f"{plan.log}: " + ", ".join(
            f"rid {r} {c.finish_reason} {len(c.tokens)} tokens"
            + ("" if c.tokens == ref[r] else " (a clean prefix)" if prefix(c)
               else " (NOT the clean tokens)")
            for r, c in sorted(comps.items())))
        print("   health: " + " ".join(f"{k}={v}" for k, v in h.items())
              + f"; weights audit in scope {audit}; warnings "
              + str([str(w.message)[:60] for w in warned]))
        return comps, h, audit, warned

    comps, h, audit, _ = run(FaultPlan(corrupt_at_step=3, corrupt_kind="tile"))
    print("   retired at step: " + ", ".join(f"rid {r} {comps[r].retired_step}"
                                            for r in (0, 3, 4, 5)))
    if not all(comps[r].finish_reason == "sdc_detected"
               and (prefix(comps[r]) or comps[r].retired_step > 4) for r in (0, 3, 4, 5)) \
            or not all(comps[r].status == "ok" and comps[r].tokens == ref[r] for r in (1, 2)) \
            or h["abft_params_checks"] < 1 or h["sdc_retired"] != 4 or audit:
        fail("tile clobber: wrong retirements or counters")
    comps, h, _, _ = run(FaultPlan(corrupt_at_step=3, corrupt_kind="kv", kv_corrupt_slot=0))
    if not (comps[0].finish_reason == "sdc_detected" and prefix(comps[0])
            and all(comps[r].status == "ok" and comps[r].tokens == ref[r] for r in range(1, 6))
            and h["abft_kv_trips"] == 1 and h["rung"] == 0):
        fail("KV perturbation: wrong retirements or counters")
    comps, h, _, _ = run(FaultPlan(nan_poke_step=3, nan_poke_slot=0))
    if not (comps[0].finish_reason == "nan_guard" and prefix(comps[0])
            and all(comps[r].status == "ok" and comps[r].tokens == ref[r] for r in range(1, 6))
            and h["nan_guard_trips"] == 1 and h["abft_params_checks"] == 1
            and h["sdc_retired"] == 0 and h["rung"] == 0):
        fail("NaN poke: wrong retirements or counters")
    comps, h, _, _ = run(FaultPlan(kernel_raise_at_step=2, kernel_raise_count=1))
    if not (all(c.status == "ok" and c.tokens == ref[r] for r, c in comps.items())
            and h["step_retries"] == 1 and h["rung"] == 0 and h["degrades"] == 0):
        fail("one kernel raise: not retried bitwise")
    WARN_ONCE_SEEN.discard(("serving", "degrade_rotate_once"))
    comps, h, _, warned = run(FaultPlan(kernel_raise_at_step=2, kernel_raise_count=2))
    if not (all(c.status == "ok" and c.tokens == ref[r] for r, c in comps.items())
            and h["step_retries"] == 1 and h["rung"] == 1 and h["degrades"] == 1
            and any("degraded to rung" in str(w.message) for w in warned)):
        fail("persistent raise: not one rung down, loudly")
    WARN_ONCE_SEEN.discard(("serving", "ladder_exhausted"))
    comps, h, _, warned = run(FaultPlan(kernel_raise_at_step=2, kernel_raise_count=10 ** 6))
    failed = {r for r, c in comps.items() if c.finish_reason in ("engine_failed",
                                                                  "shed_engine_failed")}
    if not (failed and all(comps[r].status == "degraded" for r in failed)
            and all(c.status == "ok" and c.tokens == ref[r]
                    for r, c in comps.items() if r not in failed)
            and h["rung"] == 1 and h["degrades"] == 1
            and any("ladder exhausted" in str(w.message) for w in warned)):
        fail("raises on every rung: the requests did not fail loudly on the kernel rungs")
    comps, h, audit, _ = run(FaultPlan(corrupt_at_step=3, corrupt_kind="weight"))
    caught = [r for r, c in comps.items() if c.finish_reason == "sdc_detected"]
    print(f"   single bit flip: {len(caught)} of 4 slots in flight caught by the residual")
    if audit or not all(prefix(comps[r]) for r in caught) \
            or any(c.finish_reason not in ("length", "sdc_detected") for c in comps.values()):
        fail("bit flip: the audit missed it, or a slot retired otherwise")
    if not verify.params_ok(params):
        fail("the fault runs left the weights corrupted")


# The training phase: phi4-mini at full width and depth, W8A8 int8 +
# Hadamard + int8 fake-quantized Q/K/V, remat per block (the config's
# default), batch x sequence cut from train_4k's 256 x 4096 to 4 x 512.
TRAIN_STEPS = 3
# Launches per step: the forward (64 K2 at the Q/K sites, 32 K4 at the down
# projections) twice -- the recomputation of each block in the backward
# pass -- and the backward's K1: 64 at n = 128 (the Q/K sites'
# straight-through rotation) and 2 x 32 at n = 8192 (the down projection's
# gx, and the rotated x for gw). Revisit: K8 in K4's place.
TRAIN_PER_STEP = {"K1": 128, "K2": 128, "K4": 64}
# Largest per-leaf relative L2 of the step-0 gradients against the plain
# versions' on the card, per class of leaf, and the loss's difference:
# limits set between the witnesses (correct paths that differ as the kernels
# may: the rotation as f32 butterflies rounded once, the ``ref`` backend;
# the gradient accumulated over 2 microbatches in f32) and the controls (the
# plain path without its rotations; without quantization), PERF.md section
# 6, PR 15. The V projections form their own class: the V site
# fake-quantizes without a straight-through estimator, as the reference
# does, so their gradient is only the scales' (through each row's absmax)
# and moves with any change of the forward's values.
# "global" is the relative L2 over all leaves. Each limit is the geometric
# mean of the class's largest witness or kernel reading and its smallest
# control reading in the calibration call (PERF.md).
TRAIN_GRAD_LIMITS = {"v_proj": 0.57, "other": 0.38, "global": 0.24}
TRAIN_LOSS_LIMIT = 2e-3
CKPT_LAYERS = 2     # the checkpoint / restart check's depth (full width)


def _train_cfg(backend="cuda", schedule=None, rotate="hadamard", mode="int8", layers=None):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig

    cfg = get_config("phi4-mini-3.8b").with_quant(QuantConfig(
        mode=mode, rotate=rotate, backend=backend, kv_quant=mode != "none",
        schedule=schedule))
    if layers is not None:
        cfg = dataclasses.replace(cfg, groups=((("attn",), layers),))
    return cfg


def _grads(cfg, params, batch, microbatches: int = 1):
    """(loss, gradients as a list in leaf order): the loss's gradients, over
    ``microbatches`` slices of the batch accumulated in f32 when > 1."""
    from repro_torch import tree as T
    from repro_torch.models.lm import lm_loss

    flat = T.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    acc, total = None, 0.0
    for i in range(microbatches):
        part = {k: v.chunk(microbatches)[i] for k, v in batch.items()}
        loss, _ = lm_loss(cfg, params, part)
        g = torch.autograd.grad(loss, flat)
        total += float(loss.detach())
        if microbatches == 1:
            acc = list(g)
        elif acc is None:
            acc = [t.float() for t in g]
        else:
            for a, t in zip(acc, g):
                a.add_(t)
        del g
    if microbatches > 1:
        acc = [a.mul_(1.0 / microbatches) for a in acc]
    for p in flat:
        p.requires_grad_(False)
    return total / microbatches, acc


def _leaf_class(path: str) -> str:
    return "v_proj" if "['attn']['wv']" in path else "other"


def _leaf_rel(got, want, paths) -> dict:
    """Per class of leaf: (largest per-leaf relative L2 of got against
    want, that leaf's path); and "global": the relative L2 over every
    leaf."""
    out, num, den = {}, 0.0, 0.0
    for g, w, path in zip(got, want, paths):
        d2 = float((g.double() - w.double()).square().sum())
        w2 = float(w.double().square().sum())
        num, den = num + d2, den + w2
        r = math.sqrt(d2 / max(w2, 1e-60))
        c = _leaf_class(path)
        if r >= out.get(c, (-1.0, ""))[0]:
            out[c] = (r, path)
    out["global"] = (math.sqrt(num / max(den, 1e-60)), "all leaves")
    return out


def train_phase(args) -> dict:
    """phi4-mini training at full width and depth through the kernels
    (rotate-once K4, K8 under revisit; K2; K1 in the backward): the step-0
    loss and gradients held against the plain versions' on the card (a
    witness and two controls printed beside them), then TRAIN_STEPS AdamW
    steps with f32 moments (step time, tokens/s, peak memory, launches per
    step), the same steps under the revisit schedule bitwise equal, the
    same steps with int8 moments, and a checkpoint / restart at
    CKPT_LAYERS layers resuming bitwise. Returns the launches."""
    import shutil
    import tempfile

    from repro_torch import tree as T
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch.shapes import SHAPES, ShapeSpec
    from repro_torch.launch.steps import batch_to, make_train_step
    from repro_torch.launch.train import restore_state, save_state
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import OptConfig, init_opt_state

    cfg = _train_cfg()
    full = SHAPES["train_4k"]
    shape = ShapeSpec("train_4k", "train", TRAIN_SEQ, TRAIN_BATCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"-- training phase: {cfg.name} at full width and depth ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied), "
          f"int8 + hadamard + int8 KV fake quantization, remat {cfg.remat}; batch x seq "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} (cut from {full.name}'s {full.batch} x {full.seq})")
    ds = SyntheticDataset(cfg, shape, seed=args.seed)
    batches = [batch_to(ds.batch(k), "cuda") for k in range(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in T.leaves(params))
    print(f"init: {n_params / 1e9:.3f} B parameters in {time.perf_counter() - t0:.1f} s")

    # ---- step-0 loss and gradients against the plain versions
    loss_p, plain = _grads(_train_cfg("torch"), params, batches[0])
    paths = [p for p, _ in T.leaves_with_paths(params)]
    readings = {}
    for name, c, mb in (("kernels", cfg, 1),
                        ("witness_ref_rotation", _train_cfg("ref"), 1),
                        ("witness_microbatches_2", _train_cfg("torch"), 2),
                        ("control_no_rotate", _train_cfg("torch", rotate="none"), 1),
                        ("control_no_quant", _train_cfg("torch", mode="none"), 1)):
        loss, g = _grads(c, params, batches[0], mb)
        rel = _leaf_rel(g, plain, paths)
        readings[name] = (rel, abs(loss - loss_p))
        print(f"step-0 gradients, {name}: |loss - plain loss| {abs(loss - loss_p):.3e} "
              f"(plain loss {loss_p:.6f}); relative L2 against the plain versions, "
              + "; ".join(f"{k} {v:.6f} ({where})" for k, (v, where) in rel.items()))
        del g
    torch.cuda.empty_cache()
    del plain

    def passes(name):
        rel, dloss = readings[name]
        return dloss <= TRAIN_LOSS_LIMIT and all(rel[c][0] <= lim
                                                 for c, lim in TRAIN_GRAD_LIMITS.items())

    print(f"limits: {TRAIN_GRAD_LIMITS} (a class's largest leaf; global over every "
          f"leaf), loss {TRAIN_LOSS_LIMIT:g}; within them: "
          + ", ".join(f"{k} {passes(k)}" for k in readings))
    for name in readings:
        if passes(name) != (not name.startswith("control")):
            fail(f"training: {name} {'fails' if passes(name) is False else 'passes'} the "
                 "gradient limits")

    # ---- AdamW steps, f32 moments: rotate-once, then revisit from the same init
    def steps(c, opt_cfg, params, what, profile=False):
        """TRAIN_STEPS steps from ``params`` (launches counted): (the
        parameters after them, on the host; the losses; the launches).
        ``profile``: then one more step under the profiler."""
        opt_state = init_opt_state(params, opt_cfg)
        step = make_train_step(c, opt_cfg)
        losses, times = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def run():
            nonlocal params, opt_state
            for b in batches:
                t = time.perf_counter()
                params, opt_state, m = step(params, opt_state, b)
                losses.append(float(m["loss"]))
                times.append(time.perf_counter() - t)
            return params

        params, launches = _counted(run)
        peak = torch.cuda.max_memory_allocated()
        per = {k: v / TRAIN_STEPS for k, v in launches.items() if v}
        step_s = sum(times[1:]) / (len(times) - 1)
        print(f"{what}: losses {losses}; step {step_s * 1e3:.1f} ms (mean of steps 1-"
              f"{TRAIN_STEPS - 1}; step 0 {times[0] * 1e3:.1f} ms), {tokens / step_s:.0f} "
              f"tokens/s; peak {peak / 1e9:.2f} GB (limit {PEAK_LIMIT / 1e9:g}); launches "
              f"per step {per}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"training {what}: a loss is not finite")
        if peak > PEAK_LIMIT:
            fail(f"training {what}: peak memory {peak / 1e9:.2f} GB")
        host = [p.detach().cpu() for p in T.leaves(params)]
        if profile:
            def one():
                nonlocal params, opt_state
                params, opt_state, _ = step(params, opt_state, batches[0])

            _profile_window(one, 1, f"training step ({what})")
        del opt_state, params
        torch.cuda.empty_cache()
        return host, losses, launches

    opt_cfg = OptConfig(lr=1e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    after, losses, launches = steps(cfg, opt_cfg, params, "rotate-once, f32 moments",
                                    profile=True)
    del params
    want = {k: TRAIN_STEPS * TRAIN_PER_STEP.get(k, 0) for k in launches}
    if launches != want:
        fail(f"training launched {launches}, expected {want}")
    rv_cfg = _train_cfg(schedule="revisit")
    params = init_lm(rv_cfg, seed=args.seed, device="cuda")
    rv_after, rv_losses, rv_launches = steps(rv_cfg, opt_cfg, params,
                                             "revisit, f32 moments")
    del params
    same = rv_losses == losses and all(torch.equal(a, b) for a, b in zip(after, rv_after))
    print(f"revisit against rotate-once: losses and parameters bitwise {same}")
    want = {k: TRAIN_STEPS * ({**TRAIN_PER_STEP, "K8": TRAIN_PER_STEP["K4"], "K4": 0}
                              ).get(k, 0) for k in rv_launches}
    if not same or rv_launches != want:
        fail(f"training under revisit: bitwise {same}, launched {rv_launches}, "
             f"expected {want}")
    launches = {k: launches[k] + rv_launches[k] for k in launches}
    del after, rv_after

    # ---- int8 moments
    params = init_lm(cfg, seed=args.seed, device="cuda")
    q8 = OptConfig(lr=1e-4, warmup_steps=1, total_steps=TRAIN_STEPS, state_dtype="int8")
    steps(cfg, q8, params, "rotate-once, int8 moments")
    del params
    torch.cuda.empty_cache()

    # ---- checkpoint at step 2, restart, step 2 again (CKPT_LAYERS layers)
    small = _train_cfg(layers=CKPT_LAYERS)
    step = make_train_step(small, q8)
    params = init_lm(small, seed=args.seed, device="cuda")
    opt_state = init_opt_state(params, q8)
    for b in batches[:2]:
        params, opt_state, _ = step(params, opt_state, b)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        save_state(ckpt, 2, small, params, opt_state)
        _, opt_state, m = step(params, opt_state, batches[2])
        from repro_torch.checkpoint import wait_for_writes

        wait_for_writes()
        t_save = time.perf_counter() - t0
        fresh = init_lm(small, seed=args.seed + 1, device="cuda")
        t0 = time.perf_counter()
        p2, o2 = restore_state(ckpt, 2, small, fresh, init_opt_state(fresh, q8), "cuda")
        t_load = time.perf_counter() - t0
        _, _, m2 = step(p2, o2, batches[2])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    same = float(m["loss"]) == float(m2["loss"]) and all(
        torch.equal(a, b) for a, b in zip(T.leaves(params), T.leaves(p2)))
    print(f"checkpoint ({CKPT_LAYERS} layers, full width, int8 moments): saved at step 2 "
          f"in {t_save:.1f} s with step 2 running, restored in {t_load:.1f} s; step-2 "
          f"loss {float(m['loss']):.6f} before, {float(m2['loss']):.6f} after the "
          f"restart; loss and updated parameters bitwise {same}")
    if not same:
        fail("training: the restart did not resume bitwise")
    del params, opt_state, p2, o2, fresh
    torch.cuda.empty_cache()
    return launches


def profile_decode(engine, steps: int = 3) -> None:
    """Where a decode step's time goes: ``torch.profiler`` over a few
    decode steps on the engine's 4 slots (after the counted run, at the
    positions the run left), device time by kernel and the device's busy
    share of the window."""
    engine._decode()
    torch.cuda.synchronize()
    _profile_window(engine._decode, steps, "decode steps")


def _profile_window(fn, steps: int, what: str) -> None:
    """``steps`` calls of ``fn`` under ``torch.profiler``: the wall time per
    call, the device's busy share of the window and the device time by
    kernel (the 8 largest, and the port's own kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
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
    if not rows:
        print(f"-- profile: {steps} {what}, {wall_us / steps / 1e3:.2f} ms wall per step "
              "(profiler on), device time not measured (no device event captured)")
        return
    print(f"-- profile: {steps} {what}, {wall_us / steps / 1e3:.2f} ms "
          f"wall per step (profiler on), kernels busy {busy / steps / 1e3:.2f} "
          f"ms per step ({100 * busy / wall_us:.1f}% of the window)")
    ours = ("hadacore_tc_kernel", "fwht_kernel", "fused_dequant_tc_kernel",
            "fused_tc_kernel", "fused_dequant_kernel", "fused_kernel",
            "quant_dot_kernel", "quant_dot_experts_kernel")
    for i, (dev, count, key) in enumerate(rows):
        if i < 8 or any(k in key for k in ours):
            print(f"   {dev / steps / 1e3:8.3f} ms/step  {count // steps:5d} "
                  f"calls/step  {key[:90]}")


# ---------------------------------------------------------------- linter
LINT_ARGS = ["--config", "phi4-mini-3.8b", "--config", "llama4-maverick-400b-a17b",
             "--schedule", "rotate_once", "--schedule", "streamed", "--schedule", "revisit",
             "--abft", "--no-serving"]


def _site_line(site) -> str:
    """One lint site's readings: launches, rotations per row against the
    geometry, shared memory, PTX verdicts."""
    parts = [f"launches {site.launches}"]
    if site.rotations is not None:
        c = site.rotations
        g = site.geometry
        parts.append(f"rotations/row {int(c.min())}..{int(c.max())} over {len(c)} rows "
                     f"(expected {site.expected_rotations}: {g.get('splits')} splits / "
                     f"cluster {g.get('cluster')}, {g.get('tiles_per_block')} tiles/block, "
                     f"bm {g.get('bm')})")
    if site.smem:
        sm = site.smem
        libs = ", ".join(f"{k} static {v['static_smem']} + dynamic {v['max_dynamic_smem']} "
                         f"({v['regs']} regs, {v['local']} B local)"
                         for k, v in sm.items() if isinstance(v, dict))
        parts.append(f"smem planned {sm['planned']} requested {sm['requested']}; {libs}; "
                     f"optin {sm['optin']}")
    if site.ptx_events is not None:
        from repro_torch.analysis.ptx import dma_findings

        kinds = [e.kind for e in site.ptx_events]
        parts.append(f"PTX {kinds.count('copy')} cp.async, {kinds.count('commit')} commits, "
                     f"{kinds.count('wait')} waits, {len(dma_findings(site.ptx_events))} "
                     "findings")
    return f"   {site.name}: " + "; ".join(parts)


def _kernel_of(inst) -> str:
    """The kernel name (K4 ... K8, K7a-*, K7b-*) of a PTX entry's
    instantiation."""
    if inst.kernel == "quant_dot_experts_kernel":
        return ("K7b" if inst.abft else "K6") + ("-s" if inst.abft and inst.streamed
                                                 else "s" if inst.streamed else "")
    if inst.revisit:
        return "K7a-rv" if inst.abft else "K8"
    if inst.streamed:
        return "K7a-s" if inst.abft else "K5"
    return "K7a-ro" if inst.abft else "K4"


# K1 / K2 / K3 entries in their sources' PTX: the tensor-core kernels and
# the CUDA-core ones (``analysis.ptx.TRANSFORM_KERNELS``)
TC_KERNELS = {"hadacore.cu": {"hadacore_tc_kernel": "K1", "fwht_kernel": "FWHT (f32 K1)"},
              "fused_quant.cu": {"fused_dequant_tc_kernel": "K2", "fused_tc_kernel": "K3",
                                 "fused_dequant_kernel": "K2 f32", "fused_kernel": "K3 f32"}}


def tensor_core_check(build) -> None:
    """The contraction of every instantiation of the four main quant_dot
    sources, and of M2, runs on the tensor cores: its PTX (``nvcc -ptx``,
    the linter's own build) has ``mma.sync`` and no ``dp4a``. And every
    bf16 / fp16-compute instantiation of K1, K2 and K3 (io f32, bf16, fp16
    x compute bf16, fp16: six each) rotates on the tensor cores: its entry
    has ``mma.sync``. Prints the counts per kernel (over its io dtypes, rows
    per block and modes)."""
    from repro_torch.analysis.ptx import contraction_counts, parse_name, parse_transform_name

    print("-- lint phase: tensor-core contraction, mma.sync / dp4a per instantiation (PTX)")
    for source in [f"{s}.cu" for s in build.QUANT_DOT_SOURCES] + ["mutants/dangling_dma.cu"]:
        kernels = {}
        for name, c in contraction_counts(build.ptx_text(source)).items():
            inst = parse_name(name)
            if inst is not None:
                k = "M2" if source.startswith("mutants") else _kernel_of(inst)
                kernels.setdefault(k, []).append(c)
        if not kernels:
            fail(f"no quant_dot entry in the PTX of {source}")
        for k, counts in sorted(kernels.items()):
            mma = [c["mma"] for c in counts]
            dp4a = [c["dp4a"] for c in counts]
            print(f"   {source} {k}: {len(counts)} instantiations, mma.sync {min(mma)}..{max(mma)}"
                  f" per entry, dp4a {min(dp4a)}..{max(dp4a)}")
            if min(mma) == 0 or max(dp4a) > 0:
                fail(f"{source} {k}: an instantiation contracts off the tensor cores "
                     f"(mma.sync {min(mma)}..{max(mma)}, dp4a up to {max(dp4a)})")
    every = {(io, cd) for io in ("float32", "bfloat16", "float16")
             for cd in ("bfloat16", "float16")}
    for source, kinds in TC_KERNELS.items():
        counts = contraction_counts(build.ptx_text(source))
        for kernel, label in kinds.items():
            found = {}
            for name, c in counts.items():
                inst = parse_transform_name(name)
                if inst is not None and inst[0] == kernel:
                    found[inst[1:]] = c["mma"]
            if kernel.endswith("tc_kernel"):
                print(f"   {source} {label} ({kernel}): " + ", ".join(
                    f"{io}/{cd} {m}" for (io, cd), m in sorted(found.items()))
                    + " mma.sync per entry (io / compute)")
                if set(found) != every or min(found.values()) == 0:
                    fail(f"{source} {label}: a bf16 / fp16 instantiation lacks mma.sync or is "
                         f"missing ({sorted(found.items())})")
            else:
                print(f"   {source} {label} ({kernel}, CUDA cores): {len(found)} "
                      f"instantiations, mma.sync {sorted(set(found.values()))}")


def lint_phase(seed: int, serving_sites) -> dict:
    """The kernel-contract linter in process at full width: the clean run
    (phi4-mini's int8 8192 -> 3072 sites: K4, K5, K8 and their ABFT twins;
    llama4-maverick's fp8_e4m3 8192 -> 5120 sites: K4, K5, K8, K6, K6s and
    theirs; the MLP model sites; the serving sites the model phases
    recorded) must exit 0; ``--mutation`` must exit non-zero with both
    mutants among the violations, M1 by the rotate-once rule (its counts
    strictly above K4's) and M2 by the DMA rule. Then M1 is held bitwise to
    K4 in int8 and fp8_e4m3 and M2 bitwise to K5 at 64 x 8192 -> 5120
    fp8_e4m3 (it lacks only the ring's final drain, after which no real
    copy is left), each timed beside its twin and held against its plain
    version (its twin's) under the K4 rule (``_hold_rows``). Returns M1's
    and M2's entries of the JSON line, their launches from the mutation
    run."""
    from repro_torch.analysis import lint
    from repro_torch.analysis import mutations as mu
    from repro_torch.analysis.rules import all_rules
    from repro_torch.bench.quant_dot import (FP8_OPS_PER_S, INT8_OPS_PER_S, bound,
                                             cuda_time_ms, device_ms, library_dot,
                                             profile_ms)
    from repro_torch.kernels import build
    from repro_torch.kernels.hadacore import transform_plain
    from repro_torch.kernels.quant_dot import epilogue_dot, quant_dot, quant_dot_plain

    print("-- lint phase: python -m repro_torch.analysis.lint " + " ".join(LINT_ARGS)
          + f" (+ {len(serving_sites)} serving sites of the model phases)")
    t0 = time.perf_counter()
    code, report, sites = lint.run(LINT_ARGS, extra_sites=serving_sites)
    for site in sites:
        print(_site_line(site))
    print(f"clean lint: exit {code}, {len(report.checked)} (site, rule) pairs, "
          f"{time.perf_counter() - t0:.1f} s")
    if code != 0:
        fail(f"the clean lint exited {code}: {report.format_text()}")
    # every rule but deprecated-shim-in-trace, which applies where a shim ran
    missing = set(all_rules()) - {"deprecated-shim-in-trace"} - {r for _, r in report.checked}
    if missing:
        fail(f"the clean lint never ran {sorted(missing)}")
    del sites
    tensor_core_check(build)

    report_path = str(build.BUILD_DIR / "lint_mutation.json")
    mu.mutant_unguarded_rotate_cuda.launches = mu.mutant_dangling_dma_cuda.launches = 0
    code, report, msites = lint.run(["--mutation", "--json", report_path])
    launches = {"M1": mu.mutant_unguarded_rotate_cuda.launches,
                "M2": mu.mutant_dangling_dma_cuda.launches}
    for site in msites:
        print(_site_line(site))
    flagged = {(v.site, v.rule) for v in report.violations}
    print(f"mutation lint: exit {code}; launches {launches}; flagged {sorted(flagged)}")
    with open(report_path) as f:
        named = {v["site"] for v in json.load(f)["violations"]}
    if code == 0 or {"mutant[unguarded_rotate]", "mutant[dangling_dma]"} - named:
        fail(f"--mutation exited {code} naming {sorted(named)}: the rules lost their teeth")
    if ("mutant[unguarded_rotate]", "rotate-once-contract") not in flagged or \
            ("mutant[dangling_dma]", "dma-safety") not in flagged:
        fail(f"the mutants were not caught by their own rules: {sorted(flagged)}")
    m1 = msites[0]
    if not int(m1.rotations.min()) > m1.expected_rotations:
        fail(f"M1 rotates {int(m1.rotations.min())} times per row, not above K4's "
             f"{m1.expected_rotations}")

    entries = {}
    for name, kern, sched in (("unguarded_rotate", "M1", "rotate_once"),
                              ("dangling_dma", "M2", "streamed")):
        twin = "K4" if kern == "M1" else "K5"
        for mode in ("int8", "fp8_e4m3") if kern == "M1" else ("fp8_e4m3",):
            x, qt, plan = mu.mutant_inputs(name, seed=seed + 1, mode=mode)
            m, n = x.shape
            d = qt.q.shape[-1]
            sw = qt.scale.reshape(d).contiguous()
            out = torch.empty((m, d), dtype=x.dtype, device="cuda")
            run = lambda: mu.WRAPPERS[name](x, qt.q, sw, out, plan)         # noqa: E731
            ref = lambda: quant_dot(x, qt.q, qt.scale, plan, sched)          # noqa: E731
            plain = lambda: quant_dot_plain(x, qt.q, qt.scale, plan)         # noqa: E731
            got = run().clone()
            want = ref()
            torch.cuda.synchronize()
            same = bool(torch.equal(got.view(torch.int16), want.view(torch.int16)))
            differ = int((got.view(torch.int16) != want.view(torch.int16)).sum())
            err = float((got.float() - plain().float()).abs().max())
            ms, twin_ms = cuda_time_ms(run, iters=50), cuda_time_ms(ref, iters=50)
            dev = profile_ms(run, "quant_dot_kernel", sched == "streamed")
            twin_dev = profile_ms(ref, "quant_dot_kernel", sched == "streamed")
            plain_ms = cuda_time_ms(plain, iters=20, warmup=2)
            lib, lib_name = library_dot(x, qt.q, qt.scale, mode, False)
            lib_ms, lib_dev = cuda_time_ms(lib, iters=50), device_ms(lib)
            low = INT8_OPS_PER_S if mode == "int8" else FP8_OPS_PER_S
            bound_ms, by = bound(2 * m * n + qt.q.numel() + 4 * d + 2 * m * d, 2 * m * n * d,
                                 m * n * (math.log2(n) + 6), low)
            print(f"{kern} {mode:8s} {m} x {n} -> {d}: {differ} of {got.numel()} elements "
                  f"differ from {twin} (bitwise {same}), max abs err vs plain {err:g}; "
                  f"{kern} {ms:.5f} ms (events) {_dev(dev)} (profile), {twin} {twin_ms:.5f} "
                  f"ms / {_dev(twin_dev)}, plain {plain_ms:.5f} ms, {lib_name} {lib_ms:.5f} "
                  f"ms / {_dev(lib_dev)}, bound {bound_ms:.6f} ms ({by})")
            if (kern, mode) in (("M1", "int8"), ("M2", "fp8_e4m3")):
                entries[kern] = {"mode": mode, "max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                                 "library_ms": lib_ms, "launches": launches[kern]}
            if not same:
                fail(f"{kern} differs from {twin} in {differ} elements ({mode})")
            y1, (q1, s1) = _fwht_epilogue(x, plan)
            agree = _same_rows(y1, transform_plain(x, plan))
            _hold_rows(f"{kern} {m} x {n} -> {d} {mode:8s} against plain", got,
                       plain(), epilogue_dot(q1, s1, qt.q, qt.scale, mode, torch.bfloat16),
                       agree, mode, False)
    return entries


# ------------------------------------------------------- offline rotation
# The rotation phase's limits on the relative RMS difference of the
# prefill logits (64 positions, full depth) between llama3-8b with its
# down projections fused (fuse_down_proj_rotations through K1) and served
# with the online rotations, and the unrotated model with no quantization:
# "exact" with no quantization (the rotations cancel up to bf16 roundings),
# "fp8" with fp8_e4m3 + Hadamard + fp8 KV. Each sits between the witness
# (the same comparison with the plain rotation on the card) and the control
# (the fused weights served without the online rotation), PERF.md.
ROTATION_LIMITS = {"exact": 0.16, "fp8": 0.35}


def rotation_phase(args) -> dict:
    """llama3-8b at full width from ``--seed`` (random bf16 weights, the
    model phase's draws unquantized): ``fuse_down_proj_rotations`` through
    K1 (the grouped 7 x 2048 transform, one launch per layer), then the
    prefill logits of the fused model with the online rotations, against
    the unrotated model without quantization, with no quantization and with
    fp8_e4m3 + Hadamard + fp8 KV (the reference's ``tests/test_archs.py``
    offline-fusion checks at full width), each beside its witness and
    control. Prints every reading before it checks any. Returns the
    launches of the fusion."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.rotations import fuse_down_proj_rotations
    from repro_torch.kernels.hadacore import hadacore_cuda
    from repro_torch.models.lm import init_lm, lm_forward

    cfg0 = get_config("llama3-8b")
    print(f"-- rotation phase: {cfg0.name} d_model={cfg0.d_model} d_ff={cfg0.d_ff} "
          f"layers={cfg0.num_layers}, bf16 weights (seed {args.seed}), offline fusion of "
          "the down projections, prefill of 64 tokens")
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(cfg0, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    hadacore_cuda.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        fused = fuse_down_proj_rotations(params)
    torch.cuda.synchronize()
    k1 = hadacore_cuda.launches
    print(f"fuse_down_proj_rotations: {time.perf_counter() - t0:.2f} s, {k1} K1 launches "
          f"(expected {cfg0.num_layers}), peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if k1 != cfg0.num_layers:
        fail(f"the fusion launched K1 {k1} times, expected {cfg0.num_layers}")
    prompt = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg0.vocab_size, (1, 64))).cuda()

    def logits(quant, p):
        with torch.inference_mode():
            out = lm_forward(cfg0.with_quant(quant), p, {"tokens": prompt})[0]
        out = out[..., :cfg0.vocab_size].float()
        if not torch.isfinite(out).all():
            fail(f"non-finite prefill logits ({quant})")
        return out

    base = logits(QuantConfig(), params)
    runs = {
        "exact": dict(mode="none", kv_quant=False),
        "fp8": dict(mode="fp8_e4m3", kv_quant=True),
    }
    rel = {}
    for label, kw in runs.items():
        for route, quant in (("kernels", QuantConfig(rotate="hadamard", backend="cuda", **kw)),
                             ("witness", QuantConfig(rotate="hadamard", backend="torch", **kw)),
                             ("control", QuantConfig(rotate="none", backend="cuda", **kw))):
            hadacore_cuda.launches = 0
            got = logits(quant, fused)
            r = float((got - base).norm() / base.norm())
            top1 = float((got.argmax(-1) == base.argmax(-1)).float().mean())
            rel[label, route] = r
            print(f"rotation {label:5s} {route:8s} vs unrotated bf16: relative RMS {r:.6f}, "
                  f"top-1 {top1 * 100:.1f}%, K1 launches {hadacore_cuda.launches}")
    print(f"peak device memory in the rotation phase: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for label in runs:
        limit = ROTATION_LIMITS[label]
        print(f"rotation {label}: limit {limit}")
        for route in ("kernels", "witness"):
            if not rel[label, route] <= limit:
                fail(f"rotation {label}: {route} at {rel[label, route]} > {limit}")
        if not rel[label, "control"] > limit:
            fail(f"rotation {label}: control at {rel[label, 'control']} passes {limit}")
    del params, fused
    torch.cuda.empty_cache()
    return {"K1": k1}


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
    spent = build.build_all(lint=True)   # the linter's builds too, all in parallel
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          + " ".join(f"{k}={v:.1f}s" for k, v in spent.items()))

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timed = kernel_phase(gen)
    hold_k3_k4(gen)
    hold_mixed_rounds(args.seed)
    timed.update(time_k3_k4(gen))
    hold_k5_k6(gen)
    timed.update(time_k5_k6(gen))
    hold_k8(gen)
    timed.update(time_revisit(gen))
    hold_abft_kernels(gen)
    timed.update(time_abft(gen))
    entry = entry_point_phase(gen)
    launches = {}
    serving_sites = []
    for arch in MODELS:
        _, got = model_phase(args, arch, serving_sites)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    for phase in (window_phase, launcher_phase, train_phase):
        for k, v in phase(args).items():
            launches[k] += v
    launches["K3"] = entry["K3"]    # K3's path is the entry point
    t0 = time.perf_counter()
    mutants = lint_phase(args.seed, serving_sites)
    del serving_sites
    t1 = time.perf_counter()
    rotation_phase(args)
    print(f"lint phase {t1 - t0:.1f} s, rotation phase {time.perf_counter() - t1:.1f} s")

    quant_dot_cu = "src/repro_torch/csrc/quant_dot.cu"
    experts_cu = "src/repro_torch/csrc/quant_dot_experts.cu"
    abft_cu = "src/repro_torch/csrc/quant_dot_abft.cu"
    experts_abft_cu = "src/repro_torch/csrc/quant_dot_experts_abft.cu"
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
        "K7a-ro": {"name": "quant_dot_abft", "source": abft_cu,
                   "replaces": "src/repro/kernels/quant_dot.py:465"},
        "K7a-s": {"name": "quant_dot_abft_streamed", "source": abft_cu,
                  "replaces": "src/repro/kernels/quant_dot.py:497"},
        "K7b": {"name": "quant_dot_experts_abft", "source": experts_abft_cu,
                "replaces": "src/repro/kernels/quant_dot.py:845"},
        "K7b-s": {"name": "quant_dot_experts_abft_streamed", "source": experts_abft_cu,
                  "replaces": "src/repro/kernels/quant_dot.py:872"},
        "K8": {"name": "quant_dot_revisit", "source": quant_dot_cu,
               "replaces": "src/repro/kernels/quant_dot.py:440"},
        "K7a-rv": {"name": "quant_dot_abft_revisit", "source": abft_cu,
                   "replaces": "src/repro/kernels/quant_dot.py:540"},
        "M1": {"name": "mutant_unguarded_rotate",
               "source": "src/repro_torch/csrc/mutants/unguarded_rotate.cu",
               "replaces": "src/repro/analysis/mutations.py:30"},
        "M2": {"name": "mutant_dangling_dma",
               "source": "src/repro_torch/csrc/mutants/dangling_dma.cu",
               "replaces": "src/repro/analysis/mutations.py:46"},
    }
    for k, e in mutants.items():   # their path is the mutation lint
        launches[k] = e.pop("launches")
        timed[k] = e
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
