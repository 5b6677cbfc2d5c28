"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --build-ab   # the build timed alone and beside the dry run

Runs from the repository root and needs the repository's ``src/``. It

  1. prints the card's name and power limit (nvidia-smi);
  2. starts the dry run on the host's CPU (``python -m
     repro_torch.launch.dryrun --all --mesh both``, DRYRUN_JOBS cells at
     once, and the world-1 plan of WORLD_ONE_ARCH's training cell), stopped
     while the kernels are timed and joined before the phases' line: it
     must report no error; builds the port's CUDA kernels from
     ``src/repro_torch/csrc`` (one nvcc
     per source, all in parallel, the mutants with them) and prints the
     build seconds; the linter's counting and PTX builds run beside the
     phases from the entry point to the lint phase (after the kernels'
     timings), four nvcc at a time, and each phase line taken beside them
     ends ``(beside nvcc)``;
  3. kernel phase: holds every kernel against its plain PyTorch version on
     the card -- K1 ``hadacore`` on the tensor cores at n in {8, 16, 64, 128,
     256, 512, 1024, 2048, 4096, 32768} x {bf16, fp16} x {1, 5, 28, 64}
     rows (1 ulp at the row max; in place bitwise out of place), at f32
     compute (the CUDA-core body) and the baseline FWHT (``fwht_cuda``) in
     the 3 dtypes at n in {128, 2048, 32768}, and grouped 14336; K2
     ``fused_dequant`` at 32, 256 and 2048 x 128 and 256 x 2048 x {int8,
     fp8_e4m3, fp8_e5m2}, bf16, at whisper-base's n = 64 (32, 512 and 48000
     rows x {int8, fp8_e4m3}), and at the path shapes it is timed at (128,
     32, 2048 and 512 x 128 fp8_e4m3; qwen2-vl-7b's and whisper-base's, see
     the launcher model phases), each against its plain version and
     bitwise the plain epilogue on K1's own rotation; K3 ``fused`` at n in
     {128, 2048, 8192} x the 3 modes (q and s bitwise, and on K1's
     rotation); K4 ``quant_dot`` at phi4-mini's
     down projection (4 and 64 x 8192 -> 3072) and a ragged 5 x 8192 ->
     3000 in the 3 modes, and at whisper-base's 4 and 6000 x 2048 -> 512 in
     int8 (int8 bitwise, fp8 within 2^-7 of the row max; the
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
     5120, int8 and fp8_e4m3, and timed beside K4 (the schedule A/B); K1
     at the training steps' backward shapes (the transform harness's
     ``train`` and ``backward`` cases) and K6 fp8_e4m3 at a training step's
     capacity rows (4, 128, 5, 8192), timed the same way;
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
     launcher model phases (``launcher_model_phase``), the families the
     serving engine refuses, at full width and depth: whisper-base (int8
     W8A8 + Hadamard + int8 KV; 6 encoder + 6 decoder layers, LayerNorm,
     GELU, tied embeddings, 1500 frames an input), qwen2-vl-7b (fp8_e4m3
     + Hadamard + fp8 KV; 28 layers, M-RoPE, 1024 patch embeddings, d_ff 37 x
     512), rwkv6-7b (int8 W8A8 + Hadamard; 32 RWKV6 layers, d_ff 7 x 2048)
     and zamba2-7b (fp8_e4m3 + Hadamard + fp8 KV; 68 Mamba2 layers and 13
     attention layers of head_dim 112 = I_7 (x) H_16): each checks its
     weights against ``count_params`` and its init peak, holds a prefill
     (whisper: 64 tokens and 1500 frames; qwen2-vl: 1024 patches on a 32 x
     32 (t = 0, h, w) grid and 64 tokens after it; rwkv6 and zamba2: 512
     tokens, the chunked forms' carry across 16 and 4 chunks) against the
     plain path at its first depth (zamba2: the first 6 layers) and at full
     depth and 4 decode steps after it (the recurrent decode from the
     chunked prefill's state), rwkv6 also a 100-token prompt at depth 1
     (the recurrence's form) (limits between witnesses and controls,
     PERF.md), counts the kernels' launches per prefill and decode step
     (whisper 30 K2 + 12 K4 / 12 K2 + 6 K4, qwen2-vl 28 K1 + 56 K2 both,
     rwkv6 32 K1, zamba2 39 K1), profiles a decode step of 4 requests, then
     serves 4 requests through the launcher (whisper: 16 prompt tokens, 64
     greedy tokens; qwen2-vl: 1024 patches + 64 tokens, 16 greedy tokens;
     rwkv6 and zamba2: 512 tokens, 32 greedy tokens) with its prefill s,
     steady tok/s, launches and peak;
     training phases (``train_phase``, one per ``TRAIN_FAMILIES`` entry):
     phi4-mini-3.8b, qwen1.5-4b and whisper-base at full width and depth;
     starcoder2-15b, mixtral-8x7b, qwen2-vl-7b, rwkv6-7b and zamba2-7b at
     full width, cut to whole pattern units under the peak limit; each in
     its serving mode with per-block recomputation, ``train_traffic``'s
     batches from the ``SyntheticDataset`` (4 x 512 tokens; whisper: 4 x 64
     tokens beside 1500 frames; qwen2-vl: 2 x (1024 patches + 64 tokens) in
     2 microbatches): the weights against ``count_params``, the step-0 loss
     and every gradient leaf through the kernels against the plain versions
     on the card beside a witness (K1's rotations under the plain epilogue
     and GEMM; phi4-mini also 2 microbatches) and a control (no rotation;
     phi4-mini also no quantization), within ``TRAIN_LIMITS``; 2 AdamW steps
     with f32 moments (phi4-mini 3), the launches per step checked against
     ``per_step`` (phi4-mini: 128 K1, 128 K2, 64 K4), step time, tokens/s,
     peak memory < 72 GB, and a profile of one more step; for phi4-mini the
     same steps under the revisit schedule (64 K8 per step) bitwise equal
     and with int8 moments; for phi4-mini, rwkv6-7b and zamba2-7b a
     checkpoint before the last step and a restart (2 layers / one
     superblock, full width) that resumes bitwise; after phi4-mini,
     ``dryrun:world1``: the dry run's world-1 plan of the same cell against
     the phase's readings -- its ``argument_bytes`` equal to the bytes the
     parameters, f32 moments and one batch asked the allocator for, its
     peak and ``roofline.bound_s`` printed beside the measured peak and
     step time; then
     ``train_experts_phase``: ``_QuantDotExpertsW`` at one llama4-maverick
     expert layer ((4, 128, 5, 8192) -> 5120, fp8_e4m3: a training step's
     capacity rows), forward (1 K6) and backward (2 K1) against the plain
     versions (the kernel phase times K1 at every family's backward shapes
     and K6 at this one);
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
     rule, their launches counted from 0 just before (``hold_mutants``,
     with the kernel timings before the model phases, holds M1 bitwise K4
     in int8 and fp8_e4m3 and M2 bitwise K5 in fp8_e4m3, each timed beside
     its twin and held against its plain version under the K4 rule);
  9. rotation phase (``rotation_phase``): llama3-8b at full width, random
     bf16 weights, ``fuse_down_proj_rotations`` through K1 (one grouped
     launch per layer), then the fused model's 64-token prefill with the
     online rotations against the unrotated model, without quantization
     and with fp8_e4m3 + Hadamard + fp8 KV, each within a limit set between
     its witness (the plain rotation) and control (no online rotation);
 10. multidevice phase (``multidevice_phase``): (a) K4 and K5 as the ranks of
     the rules' full-width mesh layouts launch them -- phi4-mini's 256 x
     8192 -> 3072 prefill rows, columns split over D = 2 and 4 ('dff',
     'fsdp'), and rows and columns split at (2, 2) (None, 'dff') -- one
     launch per shard with its scale slice, assembled, against the whole
     launch (int8 bitwise, fp8_e4m3 within K4's rule), the whole launch and
     a shard of each layout timed through the quant_dot harness; (b) the distributed path at world 1 over
     NCCL: ``launch.serve --mp 1`` for phi4-mini-3.8b (int8) and llama3-8b
     (fp8_e4m3) at full width and depth, and a 2-step ``launch.train --mp
     1`` of phi4-mini at full width and 4 layers, each under torchrun's
     variables against the same launcher without them (tokens, launches and
     losses bitwise); (c) two ranks on the one card over gloo (NCCL refuses
     a second rank on a device), mesh (2, 1): phi4-mini served -- its tokens
     against (b)'s wherever world 1's top-1 / top-2 margin exceeds
     ``MD_MARGIN``, each rank's down projections the fused sharded K4, no
     ``unfused_local`` -- and trained 2 steps at 4 layers, losses within
     ``MD_LOSS_LIMIT`` of (b)'s; (d) ``serve_loop --mp 1`` at world 1 over
     NCCL for phi4-mini-3.8b (int8, full depth) and mixtral-8x7b
     (fp8_e4m3, ``MD_MIXTRAL_LAYERS`` layers) at full width on its seeded
     stream of 8 requests, against the
     engine without a process group (completions, statuses, ``health()``
     and launches equal); (e) phi4-mini's engine at two ranks on the card
     over gloo, mesh (2, 1), 2 of the 4 slots a rank, ``MD_ENGINE_LAYERS``
     layers: its completions against a world-1 engine at the same cut
     (tokens may part only at a near tie, world 1's margin there at most
     ``MD_MARGIN``), then a FaultPlan raise at step 3 on both ranks (both
     degrade one rung, with world 1's completions and health), the ranks
     started beside (d); (f) the
     nine other families' ``launch.serve --mp 1`` at world 1 over NCCL at
     the model and launcher phases' depths (maverick, llama3-405b and
     mixtral cut to 2 layers; tokens and launches equal), beside
     mixtral-8x7b at two ranks over gloo, ``MD_MIXTRAL_LAYERS`` layers at
     full width (each rank's launches as derived from its rows, tokens
     under the margin rule); (g) tensor parallelism over 'model':
     two ranks on the card over gloo at mesh (1, 2), full width,
     ``TP_LAYERS`` layers -- phi4-mini's engine (``serve_loop --mp 2``; its
     completions world 1's but at a near tie, each rank's KV cache half
     world 1's bytes), llama3-8b's one-shot launcher (tokens under the
     margin rule, the Q / K sites' rows -- K2's -- half world 1's at world
     1's launches, every layer ticked ``split``, the prefill logits within
     ``TP_PREFILL_LIMIT`` of world 1's beside a witness) and its control (the
     heads' all-reduce dropped: must part above the margin and fall outside
     the logits' limit), phi4-mini's 2
     training steps (losses within ``MD_LOSS_LIMIT`` of (b)'s); (h) the
     experts, RWKV6 and Mamba2 over 'model', its ranks started beside (g)'s:
     two ranks at (1, 2), full width, ``launch.serve --mp 2`` for
     llama4-maverick (one (attn, moe) group), mixtral-8x7b (2 layers),
     rwkv6-7b (2) and zamba2-7b (its first superblock) against world 1 at
     the same cut -- tokens under the margin rule, launches world 1's (K6
     over a rank's 64 of maverick's 128 experts), every layer ticked
     ``split``, each rank's expert weights, MoE KV caches and recurrent
     states at half world 1's bytes -- mixtral's control (the combine's
     reduce dropped: must part above the margin) and 2 training steps
     (losses within ``MD_LOSS_LIMIT`` of world 1's), then the shard-local
     K6 at a rank's 64 experts bitwise the whole launch's rows, both timed;
     (i) per-launch sharding rules when serving, its ranks started beside
     (g): ``ServeEngine(rules_overrides=launch.dryrun.decode_rules(...))``
     at two ranks over gloo, full width, teacher-forced, against world 1 --
     phi4-mini (4 layers) at (1, 2), the KV cache's rows over 'model' (each
     rank's KV bytes exactly half world 1's; 8 K2 + 4 K4 a pass, world 1's
     launches; tokens under the margin rule; prefill and decode logits
     within ``TPI_LIMITS`` beside a witness and a control, the merge without
     the common row maximum), llama4-maverick (one (attn, moe) group) at
     (2, 1), its experts over 'data' beside the slots (one K6 a pass over a
     rank's 64 experts, at decode on the 4 gathered rows; expert bytes
     exactly half; tokens and logits held the same way, the control the
     combine's sum dropped); then each serves serve_loop's stream through
     ``engine.run`` (phi4 with ABFT on, its prompts and decodes crossing row
     128): every request ok, no ABFT trip, rung 0, completions world 1's
     under the margin rule; (j) per-launch sharding rules in training:
     phi4-mini at full width, ``TPJ_LAYERS``
     layers, 4 x 512 tokens, f32 moments, two ranks at (1, 2) through
     ``make_train_step(..., rules_overrides=)`` -- {"seqpar": "model"} over
     the default rules against the same ranks without it (step-0 loss
     bitwise, gradients within ``TPJ_SEQPAR_LIMIT`` beside a witness and a
     control, each rank's bytes saved at the blocks' inputs half) and
     ``FSDP_ONLY_RULES`` against world 1 (step-0 loss and gradients
     bitwise, the control -- a backward summing over 'model' -- rejected,
     parameter and moment bytes world 1's over the ranks), launches world
     1's, 2 steps each (its ranks run beside the window, launcher and
     launcher-family phases, and its phase line follows theirs); a ``phase
     multidevice:<x>`` line follows each of (d)-(j);
 11. prints the kernels' JSON line (K1-K8, the ABFT twins, M1 and M2), then
     the result line ``{"ok": true, "device": {...}}`` last.

A line ``phase <name> <s> s`` follows the build and each phase (each
model of a model phase apart), ``phase total <s> s`` the last phase, and
``phases: <name> <s>, ...`` repeats every one of them on one line just
before the kernels' line.

Any failed check raises: the script then exits non-zero and prints no
result line. Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
# the serving run's and the training phase's traffic, which the transform
# harness's path and train cases stand for
from repro_torch.bench.hadamard import (ENCDEC_PROMPT, PREFILL_LEN,  # noqa: E402
                                        RECURRENT_PROMPT, SLOTS, TRAIN_BATCH,
                                        TRAIN_SEQ, VLM_TEXT, train_traffic)
from repro_torch.bench.quant_dot import WHISPER_ENCODER_ROWS  # noqa: E402

MAX_LEN = 256                      # the serving run's engine: SLOTS slots of MAX_LEN
MODES = ("int8", "fp8_e4m3", "fp8_e5m2")
PHI4_DOWN = (8192, 3072)           # phi4-mini's down projection, n -> d
MAVERICK_DOWN = (8192, 5120)       # llama4-maverick's down projections, n -> d
WHISPER_DOWN = (2048, 512)         # whisper-base's down projections, n -> d
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


K1_SIZES = (8, 16, 64, 128, 256, 512, 1024, 2048, 4096, 32768)  # every r and log16 remainder
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
    # whisper-base's head_dim 64: its decode (4 slots x 8 heads), decoder
    # prefill (4 x 16 tokens x 8 heads) and encoder / cross K rows (4 x 1500
    # frames x 8 heads), where 16 rows share a block's tile and each keeps
    # its own absmax
    for rows in (32, 512, 48000):
        for mode in ("int8", "fp8_e4m3"):
            x = (torch.randn(rows, 64, generator=gen, device="cuda") * 3).to(torch.bfloat16)
            hold_k2(x, mode, fused_dequant(x, _k2_plan(64, mode)))

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
    print("-- kernel phase: K1 at the training steps' backward shapes (one microbatch of "
          "each family's step, the harness's train and backward cases)")
    for case in CASES:
        if case.group not in ("train", "backward"):
            continue
        rec = measure(case, gen)
        print(f"K1 {case.site} ({case.rows} x {case.n}, {case.per_step} a step at the "
              f"published depth): kernel {rec['ms']:.5f} ms (events) "
              f"{_dev(rec['device_ms'])} (profile), "
              + (f"{rec['library']} {_dev(rec['library_device_ms'])}, "
                 if rec["library"] else "")
              + f"plain {rec['plain_ms']:.5f} ms, bound {rec['bound_ms']:.6f} ms "
              f"({rec['bound_by']}), {rec['ulps']:.3f} ulp")
        if not rec["ulps"] <= 1.0:
            fail(f"K1 {case.site}: {rec['ulps']} ulps")
        torch.cuda.empty_cache()
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

    print("-- kernel phase: K4 quant_dot against its plain version (phi4-mini's down "
          "projection, a ragged case, whisper-base's 2048 -> 512 at decode and at its "
          f"encoder's {WHISPER_ENCODER_ROWS} rows, not a multiple of the row block)")
    cpu = torch.Generator().manual_seed(1)
    for m, n, d, modes in ((SLOTS, *PHI4_DOWN, MODES), (PREFILL_LEN, *PHI4_DOWN, MODES),
                           (5, PHI4_DOWN[0], 3000, MODES), (SLOTS, *WHISPER_DOWN, ("int8",)),
                           (WHISPER_ENCODER_ROWS, *WHISPER_DOWN, ("int8",))):
        w = (torch.randn(n, d, generator=cpu) / math.sqrt(n)).to("cuda", torch.bfloat16)
        for mode in modes:
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
    want = _grid_plan(case.rows * case.cap, case.n, case.d, case.mode, case.experts, sched,
                      abft,
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
    # whisper-base's down projections (its own generator: the draws above
    # stay the earlier script's)
    wgen = torch.Generator(device="cuda").manual_seed(23)
    (n, d) = WHISPER_DOWN
    w = (torch.randn(n, d, generator=wgen, device="cuda") / math.sqrt(n)).to(torch.bfloat16)
    qt = quantize_weight(w, "int8")
    for m in (SLOTS, WHISPER_ENCODER_ROWS):
        x = (torch.randn(m, n, generator=wgen, device="cuda") * 3).to(torch.bfloat16)
        rec = _measure(Case("K4", "int8", m, n, d), wgen, qt, None, x)
        print(_record_line(f"K4 {m:4d} x {n} -> {d} int8 (whisper-base)", rec))
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
    per weight matrix on the already-quantized operand; and K6 fp8_e4m3 at
    a training step's capacity rows (4, 128, 5, 8192). The JSON entries
    take the fp8_e4m3 decode shape, every field of an entry from that run."""
    from repro_torch.bench.quant_dot import MAVERICK_TRAIN_CAP, Case, expert_weights
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
        if mode == "fp8_e4m3":   # a training step's capacity rows (train_experts_phase)
            x = (torch.randn(TRAIN_BATCH * EXPERTS * MAVERICK_TRAIN_CAP, n, generator=gen,
                             device="cuda") * 3).to(torch.bfloat16)
            x = x.view(TRAIN_BATCH, EXPERTS, MAVERICK_TRAIN_CAP, n)
            rec = _measure(Case("K6", mode, TRAIN_BATCH, n, d, cap=MAVERICK_TRAIN_CAP), gen,
                           ex, None, x)
            print(_record_line(f"K6  {mode:8s} {tuple(x.shape)} -> {d} (training rows)", rec))
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
    # depth 1: the first encoder and decoder layers
    "whisper-base": {1: 0.0123, 6: 0.0263},
    "qwen2-vl-7b": {1: 0.0094, 28: 0.070},
    # 512 tokens: the chunked time mix (16 chunks of 32)
    "rwkv6-7b": {1: 1.9e-3, 32: 0.326},
    # depth 6: the first superblock (5 mamba + 1 attn; a mamba layer alone
    # has no rotation site); 512 tokens: 4 SSD chunks of 128
    "zamba2-7b": {6: 1.4e-3, 81: 0.065},
}
# The same for the DECODE_STEPS greedy decode steps after the full-depth
# prefill (every run fed the plain run's tokens): their logits together.
DECODE_LIMITS = {"whisper-base": 0.0259, "qwen2-vl-7b": 0.127,
                 "rwkv6-7b": 0.368, "zamba2-7b": 0.068}
# rwkv6-7b's hold of a prompt whose length is no multiple of the chunk (the
# reference's rule then runs the time mix's recurrence, ``_tmix_scan``),
# at depth 1.
SCAN_PROMPT = 100
SCAN_LIMITS = {"rwkv6-7b": {1: 2.0e-3}}


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
      k1_no_rotate   every standalone transform returns its input (K1
                     without its rotation): the grouped sites, whose
                     quantize and contraction run outside the kernel, see
                     the unrotated rows; every other site is plain
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
    class K1NoRotate(Calibration):
        name = "k1_no_rotate"

        def transform(self, x, plan, in_place=False):
            return x

        def fused_dequant(self, x, plan):
            return fused_dequant_plain(x, plan)

        def quant_dot(self, x, wq, sw, plan, schedule=None):
            return quant_dot_plain(x, wq, sw, plan)

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
    """A context in which the first feed-forward output (the first MLP, MoE
    block or RWKV channel mix the model runs) has its largest value moved by
    1 ulp: the smallest change a rounding can make to the residual stream
    that every later layer reads. (A flip inside a rotation is mostly
    absorbed by the quantization step of the site after it.)"""

    def __enter__(self):
        from repro_torch.models import mlp, rwkv

        self.mlp, self.apply, self.apply_moe = mlp, mlp.apply_mlp, mlp.apply_moe
        self.rwkv, self.cmix = rwkv, rwkv.apply_rwkv_cmix
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

        def cmix(cfg, p, x, x_prev=None, *, return_state=False):
            out = self.cmix(cfg, p, x, x_prev, return_state=return_state)
            return (flip(out[0]), out[1]) if return_state else flip(out)

        mlp.apply_mlp, mlp.apply_moe, rwkv.apply_rwkv_cmix = apply_mlp, apply_moe, cmix

    def __exit__(self, *exc):
        self.mlp.apply_mlp, self.mlp.apply_moe = self.apply, self.apply_moe
        self.rwkv.apply_rwkv_cmix = self.cmix


def _with_backend(cfg, quant, backend: str):
    import dataclasses

    return cfg.with_quant(dataclasses.replace(quant, backend=backend))


def _cut(params, depth: int):
    """The model cut to its first ``depth`` layers (an encoder-decoder: the
    first ``depth`` of each stack)."""
    p = dict(params, layers=params["layers"][:depth])
    if "enc_layers" in params:
        p["enc_layers"] = params["enc_layers"][:depth]
    return p


def trace_layer0(cfg, params, quant, batch, depth: int = 1) -> None:
    """Which layer-0 stage first differs between the kernels and the plain
    versions, and by how many elements: the batch runs through layer 0
    (of each stack; the first ``depth`` layers, where layer 0 has no
    rotation site) once with the kernels and once with the plain versions,
    recording each
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

    # an encoder-decoder's sites in call order: the encoder layer's, then
    # the decoder layer's with the cross attention's K and V
    encdec = ("enc Q", "enc K", "enc V", "enc down", "Q", "K", "V", "cross K",
              "cross V", "down-proj")

    def rot(spec, x):
        y = rot_call(spec, x)
        if cfg.is_encdec:
            name = encdec[len(records[run])]
        else:
            name = ("Q", "K")[sum(1 for k in records[run] if k[0] in "QK") % 2] \
                if spec.rotate else "V"
        records[run].append((name, spec, None, x, y))
        return y

    def down(spec, w, x):
        y = qd_apply(spec, w, x)
        name = encdec[len(records[run])] if cfg.is_encdec else "down-proj"
        records[run].append((name, spec, w, x, y))
        return y

    p0 = _cut(params, depth)
    where = "layer 0" if depth == 1 else f"layers 0-{depth - 1}"
    api.RotationSpec.__call__, api.QuantDotSpec._apply_qtensor = rot, down
    try:
        for run in ("cuda", "torch"):
            records[run] = []
            with torch.inference_mode():
                lm_forward(_with_backend(cfg, quant, run), p0, batch)
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
        print(f"   {where} {name:9s} {tuple(y.shape)}: {diff} of {y.numel()} "
              f"elements differ from the plain run, {born} made by the site"
              + inside)
    print(f"   first stage where the kernels differ ({where}): {first or 'none'}")


def hold_prefill_against_plain(cfg, params, quant, seed: int, controls, batch=None,
                               decode_steps: int = 0, limits=None) -> dict:
    """One 64-token prompt (or ``batch``, one prompt) through the kernels,
    the plain versions, the witnesses and the controls, at each depth of the
    model's limits (``PREFILL_LIMITS``, or ``limits``). The kernels'
    difference from the plain versions must stay within the limit, every
    witness's too, and every control's beyond it. Prints every reading
    before it checks any.

    With ``decode_steps``, each run at full depth goes on past its prefill
    for that many greedy decode steps at a scalar position, every run fed
    the plain run's tokens: their logits are held the same way to
    ``DECODE_LIMITS``, and the kernels' launches of the prefill and of the
    decode steps (the counters zeroed just before each and read just after)
    are returned as {"prefill": ..., "decode": ...}.

    In a MoE model every held run routes each token to the experts the
    plain run chose (``_routing``; the gate values stay the run's own):
    with one capacity slot per expert a near-tie flip moves whole tokens
    between experts and drops others, a jump no rounding bound covers. The
    unpinned kernel and ``k1_rotations`` runs are then read as well, with
    the tokens whose top-1 expert differs and their gate margins."""
    import contextlib

    from repro_torch.kernels.registry import BACKEND_ENV_VAR
    from repro_torch.models.lm import lm_decode_step, lm_forward, pad_kv_caches

    _calibration_backends()
    if batch is None:
        rng = np.random.default_rng(seed)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))).cuda()}
    limits = dict(PREFILL_LIMITS[cfg.name] if limits is None else limits)
    trace_layer0(cfg, params, quant, batch, min(limits))
    named = {b: _with_backend(cfg, quant, b) for b in ("cuda", "torch", "auto")}
    full = len(params["layers"])
    S = batch["tokens"].shape[1] + (batch["patch_embeds"].shape[1]
                                    if "patch_embeds" in batch else 0)
    forced, launches = [], {}

    def logits(route, depth, routing):
        p = _cut(params, depth)
        if route in ("cuda", "torch", "one_flip"):
            c = named["torch" if route == "one_flip" else route]
        else:
            c = named["auto"]
            os.environ[BACKEND_ENV_VAR] = route
        flip = _one_flip() if route == "one_flip" else contextlib.nullcontext()
        steps = decode_steps if depth == full else 0
        count = route == "cuda" and steps
        try:
            with torch.inference_mode(), flip, routing:
                if count:
                    (out, _, caches), launches["prefill"] = _counted(
                        lambda: lm_forward(c, p, batch, want_cache=True))
                else:
                    out, _, caches = lm_forward(c, p, batch, want_cache=bool(steps))
                outs = []

                def decode():
                    nonlocal caches
                    caches = pad_kv_caches(c, caches, S + steps)
                    last = out[:, -1]
                    for i in range(steps):
                        if len(forced) <= i:
                            forced.append(last[:, :cfg.vocab_size].argmax(-1, keepdim=True))
                        step, caches = lm_decode_step(c, p, caches, forced[i],
                                                      torch.tensor(S + i, device="cuda"))
                        last = step[:, -1]
                        outs.append(last[:, :cfg.vocab_size].float())

                if count:
                    _, launches["decode"] = _counted(decode)
                elif steps:
                    decode()
        finally:
            os.environ.pop(BACKEND_ENV_VAR, None)
        out = out[..., :cfg.vocab_size].float()
        dec = torch.cat(outs) if steps else None
        if not torch.isfinite(out).all() or (steps and not torch.isfinite(dec).all()):
            fail(f"non-finite logits ({route}, depth {depth})")
        return out if not steps else (out, dec)

    def read(depth, route, got, plain, pinned):
        r = float((got - plain).norm() / plain.norm())
        top1 = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
        print(f"{_stage(depth)}, {route:14s} vs plain{pinned}: relative "
              f"RMS {r:.6f}, max |dlogit| {float((got - plain).abs().max()):.5f} "
              f"of {float(plain.abs().max()):.3f}, top-1 {top1 * 100:.1f}%")
        return r

    witnesses = ("one_flip", "k1_rotations")
    moe = bool(cfg.num_experts)
    pinned = ", routing pinned" if moe else ""
    rel = {}
    for depth in sorted(limits):
        plain_routing = _routing()
        plain = logits("torch", depth, plain_routing)
        if isinstance(plain, tuple):
            plain, plain_dec = plain
        for route in ("cuda",) + witnesses + controls:
            got = logits(route, depth, _routing(plain_routing.experts))
            if isinstance(got, tuple):
                got, dec = got
                rel["decode", route] = read("decode", route, dec, plain_dec, pinned)
            rel[depth, route] = read(depth, route, got, plain, pinned)
        for route in ("cuda", "k1_rotations") if moe else ():
            free = _routing()
            read(depth, route, logits(route, depth, free), plain, "")
            routing_flips(free, plain_routing)
    if decode_steps:
        limits["decode"] = DECODE_LIMITS[cfg.name]
    for depth in limits:
        limit = limits[depth]
        print(f"{_stage(depth)}: limit {limit:g}{pinned}")
        for route in ("cuda",) + witnesses:
            if not rel[depth, route] <= limit:
                fail(f"{_stage(depth)}: {route} at {rel[depth, route]} > {limit}")
        for route in controls:
            if not rel[depth, route] > limit:
                fail(f"{_stage(depth)}: control {route} at "
                     f"{rel[depth, route]} passes the limit {limit}")
    return launches


def _stage(depth) -> str:
    return "decode after the full prefill" if depth == "decode" else f"prefill depth {depth:2d}"


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


# The models the serving engine refuses (an encoder-decoder and a vlm: its
# batches carry tokens only; the recurrent kinds: a padded prefill would fold
# the padding into their state -- as the reference's engine rules), served
# through the one-shot launcher at full width and depth: each with its
# quantization, its kernels' launches per prefill and per decode step (every
# kernel not named: 0), the controls of its holds and its launcher traffic
# (SLOTS requests of ``_launcher_prompt`` tokens -- for the vlm its
# vlm_patches patches and VLM_TEXT tokens -- and ``gen`` greedy tokens each).
LAUNCHER_MODELS = {
    # 6 encoder + 6 decoder layers: a prefill rotates the encoder's Q / K
    # (12 K2) and the decoder's Q / K / cross K (18), and every down
    # projection is one fused K4 (2048 -> 512; 12); a decode step 12 K2 and
    # 6 K4, the cross K / V read from the cache
    "whisper-base": dict(mode="int8", prefill={"K2": 30, "K4": 12},
                         decode={"K2": 12, "K4": 6},
                         controls=("k4_no_rotate", "k2_no_quant"), gen=64),
    # 28 layers: one grouped K1 (37 x 512) and two K2 per layer and pass
    "qwen2-vl-7b": dict(mode="fp8_e4m3", prefill={"K1": 28, "K2": 56},
                        decode={"K1": 28, "K2": 56},
                        controls=("k2_no_quant", "k1_exact_scale"), gen=16),
    # 32 layers: the channel mix's down projection is one grouped K1 (7 x
    # 2048) per layer and pass; no KV cache, no other site
    "rwkv6-7b": dict(mode="int8", prefill={"K1": 32}, decode={"K1": 32},
                     controls=("k1_no_rotate", "k1_exact_scale"), gen=32),
    # 68 mamba layers (no site) and 13 attention layers, each with one
    # grouped K1 at Q and at K (head_dim 112 = I_7 (x) H_16, not a K2) and one
    # at the down projection (7 x 2048): 39 per pass
    "zamba2-7b": dict(mode="fp8_e4m3", prefill={"K1": 39}, decode={"K1": 39},
                      controls=("k1_no_rotate", "k1_exact_scale"), gen=32),
}
DECODE_STEPS = 4   # the decode hold's greedy steps after the full-depth prefill


def _recurrent(cfg) -> bool:
    return bool({"rwkv", "mamba"} & set(cfg.layer_kinds))


def _launcher_prompt(cfg) -> int:
    """The launcher cell's ``--prompt-len``: a vlm's patches and VLM_TEXT
    tokens, RECURRENT_PROMPT tokens for a recurrent model, else
    ENCDEC_PROMPT tokens (beside the encoder's frames)."""
    if cfg.family == "vlm":
        return cfg.vlm_patches + VLM_TEXT
    return RECURRENT_PROMPT if _recurrent(cfg) else ENCDEC_PROMPT


def _hold_batch(cfg, seed: int, text: int = 64) -> dict:
    """The holds' one prompt: ``text`` tokens; a vlm's after its vlm_patches
    N(0, 1) patch embeddings on a sqrt(P) x sqrt(P) (t = 0, h, w) position
    grid, the text after it at t = h = w = side + j, so that the three
    M-RoPE sections read different streams; an encoder-decoder's beside
    encoder_seq N(0, 1) frames (``make_batch``'s draws)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, text))).cuda()}
    if cfg.family == "vlm":
        P = cfg.vlm_patches
        side = math.isqrt(P)
        i = np.arange(P)
        grid = np.stack([np.zeros(P), i // side, i % side]).astype(np.int32)
        txt = np.broadcast_to(np.arange(side, side + text, dtype=np.int32), (3, text))
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((1, P, cfg.d_model)).astype(np.float32)).cuda()
        batch["positions"] = torch.from_numpy(
            np.concatenate([grid, txt], 1)[:, None].copy()).cuda()
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((1, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).cuda()
    return batch


def _per_pass(want: dict, passes: int, keys) -> dict:
    out = {k: 0 for k in keys}
    out.update({k: v * passes for k, v in want.items()})
    return out


def launcher_model_phase(args, arch: str) -> dict:
    """One of ``LAUNCHER_MODELS`` at full width and depth: init (its peak),
    the weights against ``count_params``, the layer-0 stage trace, the
    prefill held against the plain path at its first depth and at full
    depth and ``DECODE_STEPS`` greedy decode steps after it (a recurrent
    model: a RECURRENT_PROMPT-token prompt, so that the chunked prefill's
    state goes to the recurrent decode; rwkv6-7b also a SCAN_PROMPT-token
    prompt at depth 1, the recurrence's form; witnesses and controls as the
    model phases'; the kernels' launches per prefill and per decode
    step counted there and checked), the holds' peak, a decode profile on
    SLOTS requests of the launcher traffic, then the one-shot launcher
    ``repro_torch.launch.serve.main`` on that traffic with the launch
    counters zeroed just before and read just after (checked: one prefill
    and gen - 1 decode steps), its prefill seconds and steady tok/s and its
    peak. Returns the launcher's launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch import serve
    from repro_torch.launch.shapes import ShapeSpec, make_batch
    from repro_torch.models.lm import init_lm, lm_decode_step, lm_prefill, pad_kv_caches

    spec = LAUNCHER_MODELS[arch]
    quant = QuantConfig(mode=spec["mode"], rotate="hadamard", backend="cuda", kv_quant=True)
    cfg = dataclasses.replace(get_config(arch).with_quant(quant), weight_quant="int8")
    print(f"-- launcher model phase: {cfg.name} d_model={cfg.d_model} heads="
          f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers} encoder layers="
          f"{len(cfg.encoder_layer_kinds)} frames={cfg.encoder_seq if cfg.is_encdec else 0} "
          f"patches={cfg.vlm_patches if cfg.family == 'vlm' else 0} mrope="
          f"{cfg.mrope_sections if cfg.mrope else None} act={cfg.act} norm={cfg.norm} "
          f"tied={cfg.tie_embeddings} kinds={sorted(set(cfg.layer_kinds))} rwkv heads of "
          f"{cfg.rwkv_head_dim} ssm state={cfg.ssm_state} head_dim={cfg.ssm_head_dim}, "
          f"{spec['mode']} + hadamard + {spec['mode']} KV, int8 weights; nothing cut")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    peak = torch.cuda.max_memory_allocated()
    print(f"init + quantize layer by layer: {time.perf_counter() - t0:.1f} s, "
          f"{wbytes / 1e9:.3f} GB of weights, peak {peak / 1e9:.2f} GB")
    if peak > PEAK_LIMIT:
        fail(f"{arch}: init's peak memory {peak / 1e9:.2f} GB")
    check_param_count(cfg, params)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prompt = _launcher_prompt(cfg) if _recurrent(cfg) else 64
    got = hold_prefill_against_plain(cfg, params, quant, args.seed, spec["controls"],
                                     _hold_batch(cfg, args.seed, prompt), DECODE_STEPS)
    if cfg.name in SCAN_LIMITS:
        print(f"-- hold of a {SCAN_PROMPT}-token prompt (no multiple of the chunk "
              f"{cfg.rwkv_chunk}: the time mix's recurrence)")
        hold_prefill_against_plain(cfg, params, quant, args.seed, spec["controls"],
                                   _hold_batch(cfg, args.seed, SCAN_PROMPT),
                                   limits=SCAN_LIMITS[cfg.name])
    peak = torch.cuda.max_memory_allocated()
    print(f"holds: {time.perf_counter() - t0:.1f} s; the kernels' launches: prefill "
          f"{got['prefill']}, {DECODE_STEPS} decode steps {got['decode']}; peak device "
          f"memory of the prefill and decode holds {peak / 1e9:.2f} GB")
    keys = got["prefill"].keys()
    for stage, passes in (("prefill", 1), ("decode", DECODE_STEPS)):
        want = _per_pass(spec[stage], passes, keys)
        if got[stage] != want:
            fail(f"{arch}: {stage} launches {got[stage]}, expected {want}")
    if peak > PEAK_LIMIT:
        fail(f"{arch}: the holds' peak memory {peak / 1e9:.2f} GB")

    prompt = _launcher_prompt(cfg)
    b = make_batch(cfg, ShapeSpec("serve", "prefill", prompt, SLOTS), seed=args.seed)
    b = {k: torch.from_numpy(v).cuda() for k, v in b.items() if k != "labels"}
    b["tokens"] = b["tokens"].long()
    with torch.inference_mode():
        logits, caches = lm_prefill(cfg, params, b)
        caches = pad_kv_caches(cfg, caches, prompt + 1)
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    pos = torch.tensor(prompt, device="cuda")

    def step():
        with torch.inference_mode():
            lm_decode_step(cfg, params, caches, tok, pos)

    step()
    torch.cuda.synchronize()
    print(f"decode profile: {SLOTS} requests after a prefill of {prompt} positions")
    _profile_window(step, 3, "decode steps")
    del params, caches, logits, b
    torch.cuda.empty_cache()

    argv = ["--arch", arch, "--scale", "1.0", "--batch", str(SLOTS), "--prompt-len",
            str(prompt), "--gen", str(spec["gen"]), "--quant", spec["mode"], "--rotate",
            "hadamard", "--kernel", "cuda", "--device", "cuda", "--seed", str(args.seed)]
    print("-- launcher: python -m repro_torch.launch.serve " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    out, launches = _counted(lambda: serve.main(argv))
    peak = torch.cuda.max_memory_allocated()
    toks = out["tokens"]
    want = _per_pass(spec["prefill"], 1, launches)
    for k, v in spec["decode"].items():
        want[k] += v * (spec["gen"] - 1)
    print(f"launcher: prefill {out['prefill_s']:.3f} s, {out['tokens_per_s']:.1f} tok/s "
          f"steady state ({out['decode_steps']} steps); launches {launches} over one "
          f"prefill and {spec['gen'] - 1} decode steps; peak device memory "
          f"{peak / 1e9:.2f} GB (init included)")
    if launches != want:
        fail(f"{arch} launcher: launches {launches}, expected {want}")
    if toks.shape != (SLOTS, spec["gen"]) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"{arch} launcher: bad tokens {toks}")
    if not out["tokens_per_s"] > 0 or peak > PEAK_LIMIT:
        fail(f"{arch} launcher: rate {out['tokens_per_s']}, peak {peak / 1e9:.2f} GB")
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


# ---------------------------------------------------------------- training
# Each family trains in its serving mode at full width, remat per block (the
# configs' default), f32 moments, "steps" AdamW steps (TRAIN_STEPS where not
# given) on SyntheticDataset batches of ``train_traffic``: TRAIN_BATCH x
# TRAIN_SEQ tokens (cut from train_4k's 256 x 4096); whisper-base 4 x 64
# tokens beside 1500 frames each; qwen2-vl-7b 2 x (1024 patches + 64 tokens)
# in 2 microbatches, the train step's split. "units": the whole pattern units
# kept (the first layer group's repeats; None: every layer), the most whose
# init + step peak stays under 70 GB (PEAK_LIMIT less 2 GB for what earlier
# phases leave allocated) at ~12 bytes a parameter (bf16 weights and
# gradients, two f32 moments) and ~3 f32 copies of the largest leaf (the
# update's temporaries), as a calibration call measured them, PERF.md
# section 4. "per_step": the launches of one step, derived site by site
# (``site_launches`` in tests/test_torch_train_families.py, which holds the
# derivation on the CPU): a Q / K site runs K2 forward twice (the block's
# recomputation) and K1 once backward -- zamba2's head_dim 112 = I_7 (x)
# H_16 the grouped K1 all three times -- and whisper's cross attention
# rotates K only; a down projection runs K4 twice (d_ff a power of 2) or a
# grouped K1 twice (dense or over the experts' dispatched rows), and K1 twice
# backward (gx, and the rotated x for gw); a mamba layer has none; qwen2-vl's
# per microbatch (its microbatches keep f32 gradient sums: ~16 bytes a
# parameter). "hold": the depth of the step-0 gradient hold where it is not
# the training depth (rwkv6-7b: past a few layers its random state turns a
# 1-ulp difference into gradients as far from the plain path's as the
# control's, the kernels' own included, PERF.md). "checks": the step-0
# hold's witnesses and controls (TRAIN_CHECKS) where not
# TRAIN_CHECKS_DEFAULT. "revisit": the steps again from the same init under
# the revisit schedule, bitwise equal, K8 in K4's place. "int8_moments": the
# steps again with int8 moments. "restart": the depth (units) of a
# checkpoint after the next-to-last step and a restart that resumes bitwise.
TRAIN_STEPS = 2
# The step-0 hold's readings (``_hold_step0``), each a path against the plain
# versions': its backend, rotation and mode, and its microbatches as a
# multiple of the step's. The witnesses are correct paths that differ from
# the plain one as the kernels may (K1's and the FWHT's rotations under the
# plain epilogue and GEMM, the calibration backend of the prefill holds; the
# gradient accumulated over twice the microbatches in f32); the controls
# paths with a known fault.
TRAIN_CHECKS = {
    "kernels": dict(backend="cuda"),
    "witness_k1_rotations": dict(backend="k1_rotations"),
    "witness_microbatches_2": dict(split=2),
    "control_no_rotate": dict(rotate="none"),
    "control_no_quant": dict(mode="none"),
}
TRAIN_CHECKS_DEFAULT = ("witness_k1_rotations", "control_no_rotate")
TRAIN_FAMILIES = {
    "phi4-mini-3.8b": dict(mode="int8", units=None, steps=3,
                           per_step={"K1": 128, "K2": 128, "K4": 64},
                           checks=tuple(TRAIN_CHECKS)[1:], revisit=True,
                           int8_moments=True, restart=2),
    "qwen1.5-4b": dict(mode="int8", units=None, per_step={"K1": 240, "K2": 160}),
    "starcoder2-15b": dict(mode="fp8_e4m3", units=12, per_step={"K1": 72, "K2": 48}),
    "mixtral-8x7b": dict(mode="fp8_e4m3", units=3, per_step={"K1": 18, "K2": 12}),
    "whisper-base": dict(mode="int8", units=None, per_step={"K1": 54, "K2": 60, "K4": 24}),
    "qwen2-vl-7b": dict(mode="fp8_e4m3", units=13, per_step={"K1": 156, "K2": 104}),
    "rwkv6-7b": dict(mode="int8", units=22, hold=2, per_step={"K1": 88}, restart=2),
    "zamba2-7b": dict(mode="fp8_e4m3", units=9, per_step={"K1": 90}, restart=1),
}
# Step-0 limits per family: the largest per-leaf relative L2 of the
# gradients against the plain versions' per class of leaf (``_leaf_rel``),
# over all leaves ("global"), and the loss's difference ("loss"); each the
# geometric mean of the largest kernels' or witness's reading and the
# control's (no rotation) in the calibration call, PERF.md section 6, and
# never above the limit the family held before (phi4-mini's loss).
TRAIN_LIMITS = {
    "phi4-mini-3.8b": {"other": 0.33, "v_proj": 0.47, "global": 0.20, "loss": 0.002},
    "qwen1.5-4b": {"other": 0.38, "v_proj": 0.41, "global": 0.21, "loss": 0.0015},
    "starcoder2-15b": {"other": 0.43, "v_proj": 0.41, "global": 0.16, "loss": 0.0032},
    "mixtral-8x7b": {"other": 0.55, "v_proj": 0.50, "global": 0.35, "loss": 0.0013},
    "whisper-base": {"other": 0.35, "v_proj": 0.36, "global": 0.15, "loss": 0.0031},
    "qwen2-vl-7b": {"other": 0.48, "v_proj": 0.71, "global": 0.32, "loss": 0.028},
    "rwkv6-7b": {"other": 0.18, "global": 0.10, "loss": 0.00076},
    "zamba2-7b": {"other": 0.47, "v_proj": 0.69, "global": 0.30, "loss": 0.0030},
}


def _family_cfg(arch: str, units, backend="cuda", rotate="hadamard", mode=None,
                schedule=None):
    """``arch`` at full width, ``units`` whole pattern units deep (None:
    every layer), in its TRAIN_FAMILIES mode unless ``mode`` is given (KV
    fake quantization on unless "none")."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig

    mode = mode or TRAIN_FAMILIES[arch]["mode"]
    cfg = get_config(arch).with_quant(QuantConfig(
        mode=mode, rotate=rotate, backend=backend, kv_quant=mode != "none",
        schedule=schedule))
    if units is not None:
        cfg = dataclasses.replace(cfg, groups=((cfg.groups[0][0], units),))
    return cfg


def _grads(cfg, params, batch, microbatches: int = 1):
    """(loss, gradients as a list in leaf order): the loss's gradients, over
    ``microbatches`` slices of the batch (``split_microbatches``, the train
    step's split) accumulated in f32 when > 1."""
    from repro_torch import tree as T
    from repro_torch.launch.steps import split_microbatches
    from repro_torch.models.lm import lm_loss

    flat = T.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    acc, total = None, 0.0
    for part in split_microbatches(batch, microbatches):
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
    """The V projections form their own class: the V site fake-quantizes
    without a straight-through estimator, as the reference does, so their
    gradient is only the scales' (through each row's absmax) and moves with
    any change of the forward's values."""
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


def _hold_step0(arch: str, units, params, batch, mb: int) -> None:
    """The step-0 loss and every gradient leaf of ``arch`` at ``units``
    through the kernels against the plain versions' on the card, beside the
    family's witnesses and controls (TRAIN_CHECKS): the kernels and the
    witnesses within TRAIN_LIMITS, every control outside."""
    from repro_torch import tree as T
    from repro_torch.kernels.registry import BACKEND_ENV_VAR

    _calibration_backends()
    t0 = time.perf_counter()
    paths = [p for p, _ in T.leaves_with_paths(params)]
    loss_p, plain = _grads(_family_cfg(arch, units, "torch"), params, batch, mb)
    readings = {}
    for name in ("kernels",) + TRAIN_FAMILIES[arch].get("checks", TRAIN_CHECKS_DEFAULT):
        c = TRAIN_CHECKS[name]
        be = c.get("backend", "torch")   # a calibration backend: through the registry
        cfg = _family_cfg(arch, units, be if be in ("cuda", "torch") else "auto",
                          c.get("rotate", "hadamard"), c.get("mode"))
        os.environ[BACKEND_ENV_VAR] = be
        try:
            loss, g = _grads(cfg, params, batch, mb * c.get("split", 1))
        finally:
            os.environ.pop(BACKEND_ENV_VAR, None)
        rel = _leaf_rel(g, plain, paths)
        readings[name] = (rel, abs(loss - loss_p))
        print(f"step-0 gradients at {cfg.num_layers} layers, {name}: |loss - plain loss| "
              f"{abs(loss - loss_p):.3e} (plain loss {loss_p:.6f}); relative L2 against "
              "the plain versions, "
              + "; ".join(f"{k} {v:.6f} ({where})" for k, (v, where) in rel.items()))
        del g
    del plain
    torch.cuda.empty_cache()
    limits = TRAIN_LIMITS[arch]

    def passes(name):
        rel, dloss = readings[name]
        return dloss <= limits["loss"] and all(rel[c][0] <= limits[c] for c in rel)

    print(f"limits: {limits} (a class's largest leaf; global over every leaf); within "
          "them: " + ", ".join(f"{k} {passes(k)}" for k in readings)
          + f" ({time.perf_counter() - t0:.1f} s)")
    for name in readings:
        if passes(name) != (not name.startswith("control")):
            fail(f"training {arch}: {name} {'passes' if passes(name) else 'fails'} the "
                 "gradient limits")


def train_phase(args, arch: str) -> dict:
    """One family's training at full width and its TRAIN_FAMILIES depth,
    through the kernels: the weights against ``count_params``; the step-0
    loss and every gradient leaf against the plain versions' on the card
    (``_hold_step0``, at the "hold" depth where one is given); then the
    AdamW steps with f32 moments, the launch counters zeroed just before
    and read just after (launches per step checked, step time, tokens/s,
    finite losses, peak memory from init on) and a profile of one more
    step; where the entry asks, the same steps under the revisit schedule
    (bitwise equal), with int8 moments, and a checkpoint / restart that
    resumes bitwise. Returns the counted steps' launches. (The kernel phase
    times K1 at the step's backward shapes.)"""
    from repro_torch import tree as T
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import batch_to, make_train_step
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import OptConfig, init_opt_state

    spec = TRAIN_FAMILIES[arch]
    units, steps = spec["units"], spec.get("steps", TRAIN_STEPS)
    cfg = _family_cfg(arch, units)
    B, S, mb = train_traffic(cfg)
    extra = (f", {cfg.encoder_seq} frames an input through {len(cfg.encoder_layer_kinds)} "
             "encoder layers" if cfg.is_encdec else "")
    extra += (f", {cfg.vlm_patches} patches + {S - cfg.vlm_patches} tokens an input"
              if cfg.family == "vlm" else "")
    print(f"-- training phase: {arch} at full width (d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}), {cfg.num_layers} of {_family_cfg(arch, None).num_layers} layers, "
          f"{spec['mode']} + hadamard, remat {cfg.remat}, f32 moments; batch x seq {B} x "
          f"{S}{extra}, {mb} microbatch(es), {steps} steps")
    ds = SyntheticDataset(cfg, ShapeSpec("train", "train", S, B), seed=args.seed)
    seen = WORLD_ONE.setdefault(arch, {}) if arch == WORLD_ONE_ARCH else {}
    b0 = _held()
    batches = [batch_to(ds.batch(k), "cuda") for k in range(steps)]
    seen["batch"] = tuple((b - a) / steps for a, b in zip(b0, _held()))

    def init(c):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return init_lm(c, seed=args.seed, device="cuda")

    t0 = time.perf_counter()
    m0 = _held()
    params = init(cfg)
    torch.cuda.synchronize()
    seen["params"] = tuple(b - a for a, b in zip(m0, _held()))
    print(f"init: {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check_param_count(cfg, params)
    hold = spec.get("hold", units)
    hold_params = params if hold == units else init_lm(_family_cfg(arch, hold),
                                                       seed=args.seed, device="cuda")
    _hold_step0(arch, hold, hold_params, batches[0], mb)
    del hold_params
    torch.cuda.empty_cache()

    def run(c, opt_cfg, params, what, per_step):
        """The steps from ``params``, launches counted and checked: (the
        parameters and optimizer state after them, the step function, the
        losses, the launches)."""
        a0 = _held()
        opt_state = init_opt_state(params, opt_cfg)
        seen.setdefault("moments", tuple(b - a for a, b in zip(a0, _held())))
        step = make_train_step(c, opt_cfg, microbatches=mb)
        losses, times = [], []

        def go():
            nonlocal params, opt_state
            for b in batches:
                t = time.perf_counter()
                params, opt_state, m = step(params, opt_state, b)
                losses.append(float(m["loss"]))
                times.append(time.perf_counter() - t)

        _, launches = _counted(go)
        peak = torch.cuda.max_memory_allocated()
        step_s = sum(times[1:]) / (steps - 1)
        seen.setdefault("peak", peak)
        seen.setdefault("step_s", step_s)
        print(f"{what}: losses {losses}; step {step_s * 1e3:.1f} ms (mean of steps 1-"
              f"{steps - 1}; step 0 {times[0] * 1e3:.1f} ms), {B * S / step_s:.0f} tokens/s; "
              f"peak {peak / 1e9:.2f} GB from init through the steps (limit "
              f"{PEAK_LIMIT / 1e9:g}); launches per step "
              f"{ {k: v / steps for k, v in launches.items() if v} }, expected {per_step}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"training {arch} {what}: a loss is not finite")
        if peak > PEAK_LIMIT:
            fail(f"training {arch} {what}: peak memory {peak / 1e9:.2f} GB")
        want = {k: steps * per_step.get(k, 0) for k in launches}
        if launches != want:
            fail(f"training {arch} {what} launched {launches}, expected {want}")
        return params, opt_state, step, losses, launches

    opt_cfg = OptConfig(lr=1e-4, warmup_steps=1, total_steps=steps)
    params, opt_state, step, losses, launches = run(cfg, opt_cfg, params,
                                                    "rotate-once, f32 moments",
                                                    spec["per_step"])
    after = [p.detach().cpu() for p in T.leaves(params)] if spec.get("revisit") else None
    t0 = time.perf_counter()

    def one():
        nonlocal params, opt_state
        params, opt_state, _ = step(params, opt_state, batches[0])

    _profile_window(one, 1, f"training step ({arch})")
    print(f"profile: {time.perf_counter() - t0:.1f} s")
    del opt_state, params, step
    torch.cuda.empty_cache()

    if spec.get("revisit"):
        per = {**spec["per_step"], "K8": spec["per_step"]["K4"], "K4": 0}
        rv = _family_cfg(arch, units, schedule="revisit")
        params, _, _, rv_losses, got = run(rv, opt_cfg, init(rv), "revisit, f32 moments", per)
        same = rv_losses == losses and all(torch.equal(a, b.cpu())
                                           for a, b in zip(after, T.leaves(params)))
        print(f"revisit against rotate-once: losses and parameters bitwise {same}")
        if not same:
            fail(f"training {arch} under revisit: not bitwise the rotate-once steps")
        launches = {k: launches[k] + got[k] for k in launches}
        del params, after
        torch.cuda.empty_cache()
    if spec.get("int8_moments"):
        q8 = OptConfig(lr=1e-4, warmup_steps=1, total_steps=steps, state_dtype="int8")
        got = run(cfg, q8, init(cfg), "rotate-once, int8 moments", spec["per_step"])[-1]
        launches = {k: launches[k] + got[k] for k in launches}
        torch.cuda.empty_cache()
    if "restart" in spec:
        _restart_check(arch, spec["restart"], batches, args.seed, mb)
    return launches


def _restart_check(arch: str, units: int, batches, seed: int, mb: int) -> None:
    """A checkpoint after all but the last of ``batches``' steps at
    ``units`` pattern units (full width, int8 moments: a quarter of the f32
    moments' bytes to write and read), the last step run on, then a restart
    onto a fresh init that runs the last step again: loss and updated
    parameters bitwise."""
    import shutil
    import tempfile

    from repro_torch import tree as T
    from repro_torch.checkpoint import wait_for_writes
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import restore_state, save_state
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import OptConfig, init_opt_state

    small = _family_cfg(arch, units)
    k = len(batches) - 1
    opt_cfg = OptConfig(lr=1e-4, warmup_steps=1, total_steps=len(batches),
                        state_dtype="int8")
    step = make_train_step(small, opt_cfg, microbatches=mb)
    params = init_lm(small, seed=seed, device="cuda")
    opt_state = init_opt_state(params, opt_cfg)
    for b in batches[:k]:
        params, opt_state, _ = step(params, opt_state, b)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        save_state(ckpt, k, small, params, opt_state)
        _, opt_state, m = step(params, opt_state, batches[k])
        wait_for_writes()
        t_save = time.perf_counter() - t0
        fresh = init_lm(small, seed=seed + 1, device="cuda")
        t0 = time.perf_counter()
        p2, o2 = restore_state(ckpt, k, small, fresh, init_opt_state(fresh, opt_cfg), "cuda")
        t_load = time.perf_counter() - t0
        _, _, m2 = step(p2, o2, batches[k])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    same = float(m["loss"]) == float(m2["loss"]) and all(
        torch.equal(a, b) for a, b in zip(T.leaves(params), T.leaves(p2)))
    print(f"checkpoint ({small.num_layers} layers, full width, int8 moments): saved at "
          f"step {k} in {t_save:.1f} s with step {k} running, restored in {t_load:.1f} s; "
          f"step-{k} loss {float(m['loss']):.6f} before, {float(m2['loss']):.6f} after the "
          f"restart; loss and updated parameters bitwise {same}")
    if not same:
        fail(f"training {arch}: the restart did not resume bitwise")
    del params, opt_state, p2, o2, fresh
    torch.cuda.empty_cache()


def train_experts_phase(args) -> None:
    """``_QuantDotExpertsW`` -- the MoE kernel's training path -- at one of
    llama4-maverick's layers: 128 experts of 8192 -> 5120, fp8_e4m3, the
    capacity rows of a TRAIN_BATCH x TRAIN_SEQ step (top-1: 5 slots an
    expert, every slot a Gaussian row). Forward (K6) and backward (K1 at n =
    8192 for gx and for the rotated x of gw, the f32 einsums) through the
    kernels, launches counted (1 K6 + 2 K1), against the same Function on
    the plain versions: y by the K4 rule (``_hold_rows``, fp8: within 2^-7
    of the row max, on the FWHT's rotation and where the rotations agree),
    gx within K1's 1 ulp at the row max (both rotate the same f32
    product), gw within 2^-8 relative L2 (x's rotation within 1 bf16 ulp
    an element). The weight stack is quantized a chunk of experts at a
    time; the backward holds one f32 copy of the stack at a time. (The
    kernel phase times K6 at this shape, ``time_k5_k6``.)"""
    from repro_torch.bench.quant_dot import MAVERICK_TRAIN_CAP
    from repro_torch.core.api import QuantEpilogue, _QuantDotExpertsW, plan_for
    from repro_torch.core.wquant import quantize_weight
    from repro_torch.kernels.hadacore import transform_plain
    from repro_torch.kernels.quant_dot import experts_epilogue_dot

    n, d = MAVERICK_DOWN
    E, cap, mode, bf16 = EXPERTS, MAVERICK_TRAIN_CAP, "fp8_e4m3", torch.bfloat16
    print(f"-- training phase: _QuantDotExpertsW at llama4-maverick's expert layer, "
          f"({TRAIN_BATCH}, {E}, {cap}, {n}) -> {d}, {mode}, forward and backward against "
          "the plain versions")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w = torch.empty((E, n, d), dtype=bf16, device="cuda")
    for i in range(0, E, 8):
        w[i:i + 8] = (torch.randn((8, n, d), generator=gen, device="cuda")
                      / math.sqrt(n)).to(bf16)
    x = (torch.randn((TRAIN_BATCH, E, cap, n), generator=gen, device="cuda") * 3).to(bf16)
    g = torch.randn((TRAIN_BATCH, E, cap, d), generator=gen, device="cuda").to(bf16)
    plans = {be: plan_for(n, dtype=bf16, backend=be, device_type="cuda",
                          epilogue=QuantEpilogue(mode)) for be in ("cuda", "torch")}

    def run(be):
        xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
        t = time.perf_counter()
        y = _QuantDotExpertsW.apply(xr, wr, plans[be], None)
        gx, gw = torch.autograd.grad(y, (xr, wr), g)
        torch.cuda.synchronize()
        return y.detach(), gx, gw, time.perf_counter() - t

    (y, gx, gw, t_k), launches = _counted(lambda: run("cuda"))
    peak_k = torch.cuda.max_memory_allocated()
    yp, gxp, gwp, t_p = run("torch")
    peak = torch.cuda.max_memory_allocated()
    got = {k: v for k, v in launches.items() if v}
    print(f"kernels: forward + backward {t_k * 1e3:.1f} ms (wall, one call), launches "
          f"{got}; plain versions {t_p * 1e3:.1f} ms; peak {peak_k / 1e9:.2f} GB through "
          f"the kernels' pass, {peak / 1e9:.2f} GB with the plain pass (limit "
          f"{PEAK_LIMIT / 1e9:g})")
    if got != {"K6": 1, "K1": 2}:
        fail(f"_QuantDotExpertsW launched {got}, expected 1 K6 + 2 K1")
    if peak > PEAK_LIMIT:
        fail(f"_QuantDotExpertsW: peak memory {peak / 1e9:.2f} GB")
    gx_ulps = k1_ulps(gx.reshape(-1, n), gxp.reshape(-1, n), bf16)
    num = den = 0.0
    for i in range(0, E, 16):
        a, b = gw[i:i + 16].double(), gwp[i:i + 16].double()
        num += float((a - b).square().sum())
        den += float(b.square().sum())
    gw_rel = math.sqrt(num / den)
    print(f"backward: gx {gx_ulps:.3f} ulp(row max) from the plain version (tolerance "
          f"{k1_tolerance(n, bf16):g}); gw relative L2 {gw_rel:.3e} (limit {2.0 ** -8:.3e})")
    if not (gx_ulps <= k1_tolerance(n, bf16) and gw_rel <= 2.0 ** -8):
        fail(f"_QuantDotExpertsW backward: gx {gx_ulps} ulp, gw {gw_rel}")
    del gw, gwp, gx, gxp
    torch.cuda.empty_cache()
    x2 = x.reshape(-1, n)
    y1, (q1, s1) = _fwht_epilogue(x2, plans["cuda"])
    agree = _same_rows(y1, transform_plain(x2, plans["cuda"]))
    qt = quantize_weight(w, mode)
    from_rot = experts_epilogue_dot(q1.view(*x.shape), s1.view(*x.shape[:-1], 1), qt.q,
                                    qt.scale, mode, bf16)
    _hold_rows(f"K6 forward {tuple(x.shape)} -> {d} {mode}", y.reshape(-1, d),
               yp.reshape(-1, d), from_rot.reshape(-1, d), agree, mode, False)
    del from_rot, y1, q1, s1, w, y, yp
    torch.cuda.empty_cache()
    del qt, x, g
    torch.cuda.empty_cache()


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
    kernel (the 8 largest, and the port's own kernels). It records the
    device's activity alone, all it reads: with the host's ops too, a
    training step of ~20000 small launches took the profiler up to a minute
    to summarize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def lint_phase(serving_sites) -> dict:
    """The kernel-contract linter in process at full width: the clean run
    (phi4-mini's int8 8192 -> 3072 sites: K4, K5, K8 and their ABFT twins;
    llama4-maverick's fp8_e4m3 8192 -> 5120 sites: K4, K5, K8, K6, K6s and
    theirs; the MLP model sites; the serving sites the model phases
    recorded) must exit 0; ``--mutation`` must exit non-zero with both
    mutants among the violations, M1 by the rotate-once rule (its counts
    strictly above K4's) and M2 by the DMA rule. Returns M1's and M2's
    launches from the mutation run, their path. (``hold_mutants`` holds
    and times them.)"""
    from repro_torch.analysis import lint
    from repro_torch.analysis import mutations as mu
    from repro_torch.analysis.rules import all_rules
    from repro_torch.kernels import build

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
    return launches


def hold_mutants(seed: int) -> dict:
    """M1 held bitwise to K4 in int8 and fp8_e4m3 and M2 bitwise to K5 at
    64 x 8192 -> 5120 fp8_e4m3 (it lacks only the ring's final drain, after
    which no real copy is left), each timed beside its twin and held
    against its plain version (its twin's) under the K4 rule
    (``_hold_rows``). It runs with the other kernels' timings, before the
    model phases: late in the run, after the linter's runs, the profiler
    often captured no device event of these short windows. Returns M1's and
    M2's entries of the JSON line but their launches (the lint phase's)."""
    from repro_torch.analysis import mutations as mu
    from repro_torch.bench.quant_dot import (FP8_OPS_PER_S, INT8_OPS_PER_S, bound,
                                             cuda_time_ms, device_ms, library_dot,
                                             profile_ms)
    from repro_torch.kernels.hadacore import transform_plain
    from repro_torch.kernels.quant_dot import epilogue_dot, quant_dot, quant_dot_plain

    print("-- mutants: M1 bitwise K4, M2 bitwise K5, each timed beside its twin")
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
                                 "library_ms": lib_ms}
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


# ------------------------------------------------------------ multidevice
# phi4-mini's down projection (8192 -> 3072) on its prefill batch, split as
# the rules split it: (label, row shards, column shards). ('dff', 'fsdp')
# puts the columns on 'data' (D = 2, 4) with every row; (None, 'dff') at
# (2, 2) the rows on 'data' and the columns on 'model'.
MD_LAYOUTS = (("('dff','fsdp') D=2", 1, 2), ("('dff','fsdp') D=4", 1, 4),
              ("(None,'dff') (2,2)", 2, 2))
MD_GEN = 8              # greedy tokens of the launcher runs
MD_TRAIN_LAYERS = 4     # phi4-mini's training runs: full width, 4 of 32 layers
MD_TRAIN = ("--seq", "512", "--batch", "4", "--steps", "2")
# two ranks against one: the losses of a batch split over 'data' (bf16
# gradients of half the rows each, summed); the margin below which a greedy
# token may flip (the top-1 / top-2 logit gap of the world-1 run)
MD_LOSS_LIMIT = 5e-3
MD_MARGIN = 0.125
MD_RANK_ARGS = ("--device", "cuda:0", "--dist-backend", "gloo", "--mp", "1")

# one rank of the two-ranks run: a launcher's main, then its results as JSON
_RANK_CODE = """
import json, sys
from repro_torch.core import api
from repro_torch.kernels import quant_dot as qd, registry
from repro_torch.kernels.fused_quant import fused_dequant_cuda
from repro_torch.kernels.hadacore import hadacore_cuda
from repro_torch.launch import serve, train
kind, path, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
qd.quant_dot_cuda.launches = qd.quant_dot_experts_cuda.launches = 0
hadacore_cuda.launches = fused_dequant_cuda.launches = 0
registry.TRACE_COUNTS.clear()
res = {}
if kind == "serve":
    out = serve.main(argv)
    res = {"tokens": out["tokens"].tolist(), "margins": out["margins"].tolist()}
else:
    assert train.main(argv) == 0
res.update(k4=qd.quant_dot_cuda.launches, k1=hadacore_cuda.launches,
           k2=fused_dequant_cuda.launches, k6=qd.quant_dot_experts_cuda.launches,
           counts={"/".join(k): v for k, v in registry.TRACE_COUNTS.items()},
           dispatch={k: (list(v) if isinstance(v, tuple) else v)
                     for k, v in api._LAST_SHARDED_DISPATCH.items()})
json.dump(res, open(path, "w"))
"""


def _md_shards(gen, seed: int) -> None:
    """(a) K4 and K5 as the ranks of each ``MD_LAYOUTS`` split launch them:
    one launch per shard on its rows and its columns with their scale
    slice, the shards assembled, against one launch on the whole -- int8
    bitwise, fp8_e4m3 within K4's rule (2^-7 of the row's largest |value|).
    The whole launch and one shard of each layout are timed through the
    quant_dot harness (events, profile, plain version, library, bound)."""
    from repro_torch.bench.quant_dot import Case
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.core.wquant import QTensor, quantize_weight
    from repro_torch.kernels import quant_dot as qd

    n, d = PHI4_DOWN
    m = SLOTS * PREFILL_LEN
    cpu = torch.Generator().manual_seed(seed + 23)
    w = (torch.randn(n, d, generator=cpu) / math.sqrt(n)).to("cuda", torch.bfloat16)
    x = _k34_input(gen, m, n, "gaussian")
    print(f"-- multidevice (a): K4 / K5 shard-local at phi4-mini's {m} x {n} -> {d}")
    for mode in ("int8", "fp8_e4m3"):
        qt = quantize_weight(w, mode)
        plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                        epilogue=QuantEpilogue(mode))
        for kernel, sched in (("K4", "rotate_once"), ("K5", "streamed")):
            full = qd.quant_dot(x, qt.q, qt.scale, plan, sched)
            print(_record_line(f"{kernel} {mode:8s} whole {m} x {n} -> {d}",
                               _measure(Case(kernel, mode, m, n, d), gen, qt, None, x)))
            for label, R, C in MD_LAYOUTS:
                rows, cols = m // R, d // C
                got = torch.empty_like(full)
                for c in range(C):
                    shard = QTensor(qt.q[:, c * cols:(c + 1) * cols].contiguous(),
                                    qt.scale[..., c * cols:(c + 1) * cols].contiguous(), mode)
                    for r in range(R):
                        xs = x[r * rows:(r + 1) * rows].contiguous()
                        got[r * rows:(r + 1) * rows, c * cols:(c + 1) * cols] = \
                            qd.quant_dot(xs, shard.q, shard.scale, plan, sched)
                torch.cuda.synchronize()
                rel = float(((got.float() - full.float()).abs().amax(-1)
                             / full.float().abs().amax(-1).clamp_min(1e-30)).max())
                same = torch.equal(got, full)
                rec = _measure(Case(kernel, mode, rows, n, cols), gen, shard, None, xs)
                print(f"{kernel} {mode:8s} {label}: {R * C} shards bitwise the whole launch "
                      f"{same} (max |diff| / row max {rel:g}); "
                      + _record_line(f"shard {rows} x {n} -> {cols}", rec))
                if mode == "int8" and not same:
                    fail(f"multidevice (a): {kernel} {mode} {label} shards differ from the "
                         "whole launch")
                if rel > 2.0 ** -7:
                    fail(f"multidevice (a): {kernel} {mode} {label} shards {rel:g} of the "
                         "row max from the whole launch (K4's rule: 2^-7)")


class _Torchrun:
    """torchrun's variables for rank ``rank`` of ``world`` while inside."""

    def __init__(self, world: int, rank: int, port: int):
        self.env = {"WORLD_SIZE": str(world), "RANK": str(rank), "LOCAL_RANK": str(rank),
                    "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}

    def __enter__(self):
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k in self.env:
            os.environ.pop(k, None)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _md_argv(arch: str, mode: str, seed: int):
    return ["--arch", arch, "--scale", "1.0", "--quant", mode, "--rotate", "hadamard",
            "--kernel", "cuda", "--device", "cuda", "--seed", str(seed)]


def _md_serve_argv(arch: str, mode: str, seed: int):
    return _md_argv(arch, mode, seed) + ["--batch", str(SLOTS), "--prompt-len",
                                         str(PREFILL_LEN), "--gen", str(MD_GEN)]


def _md_train_argv(seed: int):
    return _md_argv("phi4-mini-3.8b", "int8", seed) + [
        "--layers", str(MD_TRAIN_LAYERS), "--log-every", "1", *MD_TRAIN]


def _md_losses(path: str):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


def _md_world_one(seed: int, tmp: str):
    """(b) The distributed path at world 1 over NCCL: each launcher under
    torchrun's variables (``init_process_group("nccl", world_size=1)``,
    mesh (1, 1)) against the same launcher without them -- phi4-mini (int8)
    and llama3-8b (fp8_e4m3) served at full width and depth, tokens and
    launches equal; phi4-mini trained 2 steps at full width and
    ``MD_TRAIN_LAYERS`` layers, losses bitwise. Returns (the world-1 runs'
    launches, phi4-mini's world-1 serving and training results)."""
    from repro_torch.launch import serve, train

    launches, kept = {}, {}
    print("-- multidevice (b): the launchers at world 1 over NCCL")
    for arch, mode in (("phi4-mini-3.8b", "int8"), ("llama3-8b", "fp8_e4m3")):
        argv = _md_serve_argv(arch, mode, seed)
        alone, l_alone = _counted(lambda: serve.main(argv))
        torch.cuda.empty_cache()
        with _Torchrun(1, 0, _free_port()):
            one, l_one = _counted(lambda: serve.main(argv + ["--mp", "1"]))
        torch.cuda.empty_cache()
        same = np.array_equal(one["tokens"], alone["tokens"])
        print(f"{arch} serve --mp 1 at world 1: tokens equal to the non-distributed "
              f"launcher's {same}; launches {l_one} (non-distributed {l_alone}); "
              f"{one['tokens_per_s']:.1f} tok/s ({alone['tokens_per_s']:.1f})")
        if not same or l_one != l_alone:
            fail(f"multidevice (b): {arch} at world 1 differs from the non-distributed run")
        for k, v in l_one.items():
            launches[k] = launches.get(k, 0) + v
        if arch == "phi4-mini-3.8b":
            kept["serve"] = one
    paths = [os.path.join(tmp, f"train_{k}.jsonl") for k in ("alone", "one")]
    train.main(_md_train_argv(seed) + ["--metrics-out", paths[0]])
    torch.cuda.empty_cache()
    with _Torchrun(1, 0, _free_port()):
        _, l_train = _counted(lambda: train.main(_md_train_argv(seed) + [
            "--mp", "1", "--metrics-out", paths[1]]))
    torch.cuda.empty_cache()
    alone, one = _md_losses(paths[0]), _md_losses(paths[1])
    print(f"phi4-mini train --mp 1 at world 1 ({MD_TRAIN_LAYERS} layers): losses {one}, "
          f"non-distributed {alone}; launches {l_train}")
    if one != alone:
        fail("multidevice (b): phi4-mini's world-1 losses are not the non-distributed ones")
    for k, v in l_train.items():
        launches[k] = launches.get(k, 0) + v
    kept["train"] = one
    return launches, kept


def _md_ranks(kind: str, argv, tmp: str, world: int = 2):
    """``world`` ranks of a launcher on the one card (gloo), each its own
    process: their JSON results, rank by rank."""
    procs, paths = _spawn_ranks(_RANK_CODE, argv, tmp, kind, world, lead=(kind,))
    return _join_ranks(procs, paths, f"multidevice (c): {kind}")


def _md_two_ranks(seed: int, tmp: str, kept: dict) -> None:
    """(c) Two ranks on the one card over gloo (NCCL refuses a second rank
    on a device: PERF.md section 7): ``--mp 1`` at world 2, mesh (2, 1) --
    phi4-mini served (each rank 2 of the 4 prompts; the down projection's
    sharded quant_dot gathers the rows and runs K4 shard-locally on its
    1536 columns: fused, no ``unfused_local``), its tokens against (b)'s
    world-1 run wherever world 1's top-1 / top-2 margin exceeds
    MD_MARGIN, and trained 2 steps at ``MD_TRAIN_LAYERS`` layers, losses
    within MD_LOSS_LIMIT of (b)'s."""
    print("-- multidevice (c): two ranks on the one card over gloo, mesh (2, 1)")
    base = list(MD_RANK_ARGS)
    path = os.path.join(tmp, "train_two.jsonl")
    # the training ranks run beside the serving ones
    training = _spawn_ranks(_RANK_CODE, _md_train_argv(seed) + base + ["--metrics-out", path],
                            tmp, "train", lead=("train",))
    ranks = _md_ranks("serve", _md_serve_argv("phi4-mini-3.8b", "int8", seed) + base, tmp)
    want, margins = np.array(kept["serve"]["tokens"]), np.array(kept["serve"]["margins"])
    from repro_torch.configs import get_config

    layers, passes = get_config("phi4-mini-3.8b").num_layers, MD_GEN
    for r, res in enumerate(ranks):
        got = np.array(res["tokens"])
        differ = got != want
        # a row may part from world 1 at a near tie; after that its context differs
        first = [int(np.argmax(row)) if row.any() else None for row in differ]
        close = [f is not None and margins[i, f] <= MD_MARGIN for i, f in enumerate(first)]
        unfused = res["counts"].get("sharded_quant_dot/unfused_local", 0)
        print(f"rank {r}: tokens equal to world 1's {not differ.any()} (rows parting at "
              f"{first}, world-1 margins there "
              f"{[round(float(margins[i, f]), 4) if f is not None else None for i, f in enumerate(first)]}); "
              f"K4 launches {res['k4']} ({layers * passes} expected: {layers} layers x "
              f"{passes} passes), sharded dispatch {res['dispatch']}, unfused_local {unfused}")
        if any(f is not None and not c for f, c in zip(first, close)):
            fail(f"multidevice (c): rank {r}'s tokens part from world 1's above the margin")
        if res["k4"] != layers * passes or unfused or not res["dispatch"].get("fused") \
                or res["dispatch"].get("mesh_axes") != ["data"]:
            fail(f"multidevice (c): rank {r} did not run the fused sharded quant_dot")
    _join_ranks(*training, "multidevice (c): train")
    two = _md_losses(path)
    gap = max(abs(a - b) for a, b in zip(two, kept["train"]))
    print(f"phi4-mini train at world 2 ({MD_TRAIN_LAYERS} layers): losses {two}, world 1 "
          f"{kept['train']}, max |diff| {gap:g} (limit {MD_LOSS_LIMIT})")
    if len(two) != 2 or gap > MD_LOSS_LIMIT:
        fail("multidevice (c): the two-rank losses are not world 1's")


# (d)-(f): the engine and every family on the mesh. (d) serve_loop at world 1
# over NCCL against the engine without a process group, on serve_loop's
# seeded stream of MD_LOOP_REQUESTS requests: phi4-mini at model_phase's
# depth, mixtral-8x7b at MD_MIXTRAL_LAYERS layers (world 1 bit for bit is a
# property of the code path, not of depth; model_phase serves mixtral whole);
# (e) phi4-mini's engine at two ranks on the card, depth cut to
# MD_ENGINE_LAYERS layers; (f) the nine other families through launch.serve
# at world 1 over NCCL (arch -> (mode, layers or None: the depth
# launcher_model_phase / model_phase use; maverick, llama3-405b and mixtral
# cut to 2 layers, as (d)'s mixtral), MD_FAMILY_GEN greedy tokens after a
# prompt of MD_FAMILY_PROMPT tokens (a vlm's after its patches), beside
# mixtral-8x7b at two ranks, MD_MIXTRAL_LAYERS layers.
MD_MIXTRAL_LAYERS = 2   # (d)'s mixtral; (f)'s two ranks: a 64-token prompt, MD_FAMILY_GEN greedy
MD_LOOP_MODELS = (("phi4-mini-3.8b", "int8", None),
                  ("mixtral-8x7b", "fp8_e4m3", MD_MIXTRAL_LAYERS))
MD_LOOP_REQUESTS = 8
MD_ENGINE_LAYERS = 4
MD_FAMILIES = {
    "llama4-maverick-400b-a17b": ("fp8_e4m3", 2), "llama3-405b": ("fp8_e4m3", 2),
    "qwen1.5-4b": ("int8", None), "starcoder2-15b": ("fp8_e4m3", None),
    "mixtral-8x7b": ("fp8_e4m3", 2), "whisper-base": ("int8", None),
    "qwen2-vl-7b": ("fp8_e4m3", None), "rwkv6-7b": ("int8", None),
    "zamba2-7b": ("fp8_e4m3", None)}
MD_FAMILY_PROMPT = 16
MD_FAMILY_GEN = 4
# one rank of the two-ranks engine run: the process group first, then
# serve_loop on it, then the engine under a FaultPlan raise, results as JSON
_LOOP_RANK_CODE = """
import json, sys, torch
from repro_torch.kernels import quant_dot as qd
from repro_torch.kernels.fused_quant import fused_dequant_cuda
from repro_torch.launch import serve_loop
from repro_torch.launch.mesh import init_distributed, make_local_mesh, COLLECTIVE_TIMEOUT_S
from repro_torch.testing import faults
path, argv = sys.argv[1], sys.argv[2:]
args = serve_loop.parse_args(argv)
init_distributed(torch.device(args.device), args.dist_backend, COLLECTIVE_TIMEOUT_S)
def record(engine):
    return {"completions": sorted([c.rid, c.status, c.finish_reason, list(c.tokens)]
                                  for c in engine.completions),
            "health": engine.health(), "slots": engine._slots.tolist()}
qd.quant_dot_cuda.launches = fused_dequant_cuda.launches = 0
res = {"serve": record(serve_loop.main(argv))}
res["k4"], res["k2"] = qd.quant_dot_cuda.launches, fused_dequant_cuda.launches
engine, cfg = serve_loop.build_engine(args, make_local_mesh(args.mp))
reqs = faults.arrival_flood(SLOTS_, prompt_len=16, max_new_tokens=8, vocab=cfg.vocab_size,
                            seed=1)
with faults.inject(faults.FaultPlan(kernel_raise_at_step=3, kernel_raise_count=2)):
    engine.run(reqs)
res["fault"] = record(engine)
json.dump(res, open(path, "w"))
torch.distributed.destroy_process_group()
"""


def _loop_argv(arch: str, mode: str, seed: int, requests: int):
    return ["--arch", arch, "--scale", "1.0", "--quant", mode, "--rotate", "hadamard",
            "--kernel", "cuda", "--device", "cuda", "--seed", str(seed), "--requests",
            str(requests), "--slots", str(SLOTS), "--max-len", str(MAX_LEN),
            "--prefill-len", str(PREFILL_LEN)]


def _engine_record(engine) -> dict:
    return {"completions": sorted([c.rid, c.status, c.finish_reason, list(c.tokens)]
                                  for c in engine.completions),
            "health": engine.health(), "slots": engine._slots.tolist()}


def _md_loop_world_one(seed: int) -> dict:
    """(d) ``serve_loop --mp 1`` under torchrun's variables at world 1
    (NCCL, mesh (1, 1)) against ``serve_loop`` without a process group:
    phi4-mini (int8, full depth) and mixtral-8x7b (fp8_e4m3,
    MD_MIXTRAL_LAYERS layers) at full width on serve_loop's seeded stream
    -- completions, statuses, ``health()`` and launches equal. Returns the
    world-1 runs' launches."""
    import contextlib
    import gc
    import io

    from repro_torch.launch import serve_loop

    print("-- multidevice (d): serve_loop --mp 1 at world 1 over NCCL")
    launches = {}
    for arch, mode, layers in MD_LOOP_MODELS:
        argv = _loop_argv(arch, mode, seed, MD_LOOP_REQUESTS) + (
            ["--layers", str(layers)] if layers else [])
        got = []
        for extra, env in (([], None), (["--mp", "1"], _Torchrun(1, 0, _free_port()))):
            t0 = time.perf_counter()
            with env or contextlib.nullcontext(), contextlib.redirect_stdout(io.StringIO()):
                engine, counts = _counted(lambda: serve_loop.main(argv + extra))
            got.append((_engine_record(engine), counts, engine.summary(),
                        time.perf_counter() - t0))
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        (alone, l_alone, s_alone, t_alone), (one, l_one, s_one, t_one) = got
        oks = sum(c[1] == "ok" for c in one["completions"])
        print(f"{arch}: serve_loop --mp 1 at world 1: completions equal {one == alone} "
              f"({len(one['completions'])} requests, {oks} ok, {s_one['generated_tokens']} "
              f"tokens in {s_one['decode_steps']} decode steps); health {one['health']}; "
              f"launches {l_one} (no process group {l_alone}); {s_one['tokens_per_s']:.1f} "
              f"tok/s ({s_alone['tokens_per_s']:.1f}); {t_one:.1f} s ({t_alone:.1f} s)")
        if one != alone or l_one != l_alone:
            fail(f"multidevice (d): {arch}'s serve_loop at world 1 differs from the engine "
                 "without a process group")
        if oks != MD_LOOP_REQUESTS or any(one["health"][k] for k in HEALTH_ZERO):
            fail(f"multidevice (d): {arch} did not serve every request cleanly")
        for k, v in l_one.items():
            launches[k] = launches.get(k, 0) + v
    return launches


def _spawn_ranks(code: str, argv, tmp: str, tag: str, world: int = 2, lead=()):
    """Start ``world`` ranks of ``code`` on the one card (each its own
    process, torchrun's variables set; its arguments ``lead``, its result
    path, ``argv``): (processes, result paths)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    procs, paths = [], []
    for r in range(world):
        paths.append(os.path.join(tmp, f"{tag}_rank{r}.json"))
        renv = dict(env, WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                    MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-c", code, *lead, paths[-1], *argv],
                                      env=renv, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs, paths


def _join_ranks(procs, paths, what: str, timeout: float = 240):
    """Wait for the ranks (killing any left at the timeout): their JSON
    results; a rank that failed fails the phase."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(o[-4000:])
            fail(f"{what}: rank {r} exited {p.returncode}")
    return [json.load(open(path)) for path in paths]


def _teacher_margin(cfg, params, prompt, tokens) -> float:
    """World 1's top-1 / top-2 logit gap at the token after ``prompt`` +
    ``tokens`` (one prefill of them)."""
    from repro_torch.models.lm import lm_forward

    seq = torch.tensor([list(prompt) + list(tokens)], dtype=torch.long, device="cuda")
    with torch.inference_mode():
        last = lm_forward(cfg, params, {"tokens": seq})[0][0, -1, :cfg.vocab_size]
    top = last.float().topk(2).values
    return float(top[0] - top[1])


MD_ENGINE_REQUESTS = 6


def _md_engine_argv(seed: int):
    return _loop_argv("phi4-mini-3.8b", "int8", seed, MD_ENGINE_REQUESTS) + [
        "--layers", str(MD_ENGINE_LAYERS)]


def _md_engine_spawn(seed: int, tmp: str):
    """Start (e)'s two ranks, to run beside (d): (processes, result paths,
    start time)."""
    return _spawn_ranks(_LOOP_RANK_CODE.replace("SLOTS_", str(SLOTS)),
                        _md_engine_argv(seed) + list(MD_RANK_ARGS), tmp,
                        "loop") + (time.perf_counter(),)


def _md_engine_two_ranks(seed: int, started) -> None:
    """(e) phi4-mini's engine at two ranks on the card over gloo, mesh (2,
    1), started by ``_md_engine_spawn``: 2 of the SLOTS slots a rank, full
    width, MD_ENGINE_LAYERS layers, ``serve_loop --mp 1`` on its seeded
    stream, its completions against a world-1 engine at the same cut (a
    request whose tokens part must part at a near tie: world 1's margin
    there at most MD_MARGIN); then a FaultPlan raise at step 3 on both
    ranks, twice: both degrade one rung, with world 1's completions and
    health under the same plan."""
    import contextlib
    import io

    from repro_torch.launch import serve_loop
    from repro_torch.serving import synthetic_stream
    from repro_torch.testing import faults

    print(f"-- multidevice (e): phi4-mini's engine at two ranks on the card over gloo, "
          f"mesh (2, 1), {MD_ENGINE_LAYERS} layers (the ranks started beside (d))")
    procs, paths, t0 = started
    requests, argv = MD_ENGINE_REQUESTS, _md_engine_argv(seed)
    with contextlib.redirect_stdout(io.StringIO()):
        engine = serve_loop.main(argv)
    want = _engine_record(engine)
    args = serve_loop.parse_args(argv)
    fault_engine, cfg = serve_loop.build_engine(args)
    reqs = faults.arrival_flood(SLOTS, prompt_len=16, max_new_tokens=8,
                                vocab=cfg.vocab_size, seed=1)
    with faults.inject(faults.FaultPlan(kernel_raise_at_step=3, kernel_raise_count=2)):
        fault_engine.run(reqs)
    want_fault = _engine_record(fault_engine)
    del fault_engine
    ranks = _join_ranks(procs, paths, "multidevice (e)")
    stream = {r.rid: r.tokens for r in synthetic_stream(
        requests, vocab_size=cfg.vocab_size, prompt_len=(min(8, PREFILL_LEN), PREFILL_LEN),
        max_new_tokens=(8, 32), rate=0.5, seed=seed)}
    for r, res in enumerate(ranks):
        parted = _stream_parting(cfg, engine.params, stream, res["serve"]["completions"],
                                 want["completions"])
        statuses = [c[1:3] for c in res["serve"]["completions"]]
        print(f"rank {r}: slots {res['serve']['slots']}; {len(statuses)} requests, "
              f"statuses equal to world 1's "
              f"{statuses == [c[1:3] for c in want['completions']]}; tokens parting at "
              f"(rid, index, world-1 margin) {parted}; health equal "
              f"{res['serve']['health'] == want['health']}; K4 {res['k4']}, K2 {res['k2']}")
        same = all(res["fault"][k] == want_fault[k] for k in ("completions", "health"))
        print(f"rank {r} fault plan (raise at step 3, twice): health {res['fault']['health']}; "
              f"completions and health equal to world 1's {same}")
        if any(m > MD_MARGIN for _, _, m in parted) or res["serve"]["health"] != want["health"]:
            fail(f"multidevice (e): rank {r}'s engine parts from world 1's")
        if not same or res["fault"]["health"]["degrades"] != 1 or \
                res["fault"]["health"]["rung"] != 1:
            fail(f"multidevice (e): rank {r} did not degrade with world 1")
        if not res["k4"] or not res["k2"]:
            fail(f"multidevice (e): rank {r} launched no K4 / K2")
    print(f"(e) took {time.perf_counter() - t0:.1f} s from the ranks' start")
    del engine
    torch.cuda.empty_cache()


def _family_argv(arch: str, seed: int, gen: int = MD_FAMILY_GEN):
    from repro_torch.configs import get_config

    mode, layers = MD_FAMILIES[arch]
    cfg = get_config(arch)
    prompt = MD_FAMILY_PROMPT + (cfg.vlm_patches if cfg.family == "vlm" else 0)
    return _md_argv(arch, mode, seed) + ["--batch", str(SLOTS), "--prompt-len",
                                         str(prompt), "--gen", str(gen)] + (
        [] if layers is None else ["--layers", str(layers)])


def _md_families(seed: int, tmp: str) -> dict:
    """(f) ``launch.serve --mp 1`` of the nine other families at world 1
    over NCCL against the launcher without a process group: tokens and
    launches equal; then mixtral-8x7b at two ranks over gloo, mesh (2, 1),
    MD_MIXTRAL_LAYERS layers at full width: each rank's launches per pass as
    derived from its rows (its expert site, d_ff 14336 = 7 x 2048, one
    grouped K1 a layer over the rank's dispatched rows; K2 twice a layer),
    its tokens world 1's under the margin rule. The two ranks run beside
    the families and mixtral's world-1 run at their depth. Returns the
    world-1 runs' launches."""
    import contextlib
    import gc
    import io

    from repro_torch.launch import serve

    print("-- multidevice (f): launch.serve --mp 1 at world 1 over NCCL, nine families; "
          f"mixtral-8x7b at two ranks over gloo, {MD_MIXTRAL_LAYERS} layers, beside them")
    t0 = time.perf_counter()
    mixtral = _family_argv("mixtral-8x7b", seed)
    mixtral[mixtral.index("--prompt-len") + 1] = str(PREFILL_LEN)
    mixtral += ["--layers", str(MD_MIXTRAL_LAYERS)]
    launches = {}

    def world_one(arch):
        argv = _family_argv(arch, seed)
        got = []
        t1 = time.perf_counter()
        for extra, env in (([], None), (["--mp", "1"], _Torchrun(1, 0, _free_port()))):
            with env or contextlib.nullcontext(), contextlib.redirect_stdout(io.StringIO()):
                out, counts = _counted(lambda: serve.main(argv + extra))
            got.append((out["tokens"], counts))
            del out
            gc.collect()
            torch.cuda.empty_cache()
        (alone, l_alone), (one, l_one) = got
        same = np.array_equal(one, alone)
        mode, layers = MD_FAMILIES[arch]
        print(f"{arch} ({mode}, {layers or 'all'} layers): tokens equal {same}; launches "
              f"{l_one} (no process group {l_alone}); {time.perf_counter() - t1:.1f} s")
        if not same or l_one != l_alone:
            fail(f"multidevice (f): {arch} at world 1 differs from the non-distributed run")
        for k, v in l_one.items():
            launches[k] = launches.get(k, 0) + v

    procs, paths = _spawn_ranks(_RANK_CODE, mixtral + list(MD_RANK_ARGS), tmp, "mixtral",
                                lead=("serve",))
    for arch in MD_FAMILIES:
        world_one(arch)
    with contextlib.redirect_stdout(io.StringIO()):
        want, _ = _counted(lambda: serve.main(mixtral))
    ranks = _join_ranks(procs, paths, "multidevice (f)")
    toks, margins = np.array(want["tokens"]), np.array(want["margins"])
    per_rank = {"K1": MD_MIXTRAL_LAYERS * MD_FAMILY_GEN,
                "K2": 2 * MD_MIXTRAL_LAYERS * MD_FAMILY_GEN}
    for r, res in enumerate(ranks):
        got = np.array(res["tokens"])
        first = [int(np.argmax(row)) if row.any() else None for row in got != toks]
        parted = [(i, f, round(float(margins[i, f]), 4)) for i, f in enumerate(first)
                  if f is not None]
        far = [p for p in parted if p[2] > MD_MARGIN]
        print(f"mixtral rank {r}: tokens equal to world 1's {not parted} (rows parting at "
              f"(row, index, world-1 margin) {parted}); launches K1 {res['k1']}, K2 "
              f"{res['k2']}, K6 {res['k6']} (derived: {per_rank})")
        if far:
            fail(f"multidevice (f): mixtral rank {r}'s tokens part from world 1's")
        if (res["k1"], res["k2"], res["k6"]) != (per_rank["K1"], per_rank["K2"], 0):
            fail(f"multidevice (f): mixtral rank {r}'s launches are not as derived")
    print(f"(f) took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return launches


# (g): tensor parallelism over 'model' on the one card -- two ranks over
# gloo at mesh (1, 2), each holding H / 2 query heads, KH / 2 KV heads,
# d_ff / 2 hidden columns and half the vocabulary, full width, TP_LAYERS
# layers: phi4-mini's engine (serve_loop --mp 2), llama3-8b's one-shot
# launcher and its control (the heads' all-reduce dropped), phi4-mini's
# MD_TRAIN steps.
TP_LAYERS = 4
TP_RANK_ARGS = ("--device", "cuda:0", "--dist-backend", "gloo", "--mp", "2")
# llama3-8b's prefill logits at (1, 2) against world 1's, relative L2: set
# between the witness and the control (PERF.md, section 6)
TP_PREFILL_LIMIT = 0.2

# one rank of (g): the process group, then the three launchers on it, each
# with its launches, its Q / K sites' rows (K2's) and its tensor_parallel
# ticks counted, results as JSON
_TP_RANK_CODE = """
import json, sys, torch
from repro_torch.distributed import collectives as C
from repro_torch.kernels import quant_dot as qd, registry
from repro_torch.kernels.fused_quant import fused_dequant_cuda
from repro_torch.kernels.hadacore import hadacore_cuda
from repro_torch.launch import serve, serve_loop, train
from repro_torch.launch.mesh import COLLECTIVE_TIMEOUT_S, init_distributed
from repro_torch.models import attention as A
path, loop, one, learn = sys.argv[1], *(json.loads(a) for a in sys.argv[2:5])
init_distributed(torch.device("cuda:0"), "gloo", COLLECTIVE_TIMEOUT_S)
rows, real = [0], A._rotate_quant_qk
def spy(cfg, q, k):
    rows[0] += q.numel() // q.shape[-1] + k.numel() // k.shape[-1]
    return real(cfg, q, k)
A._rotate_quant_qk = spy
def counted(fn):
    rows[0] = 0
    qd.quant_dot_cuda.launches = hadacore_cuda.launches = fused_dequant_cuda.launches = 0
    registry.TRACE_COUNTS.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, {"k1": hadacore_cuda.launches, "k2": fused_dequant_cuda.launches,
                 "k4": qd.quant_dot_cuda.launches, "rows": rows[0],
                 "ticks": {"/".join(k[1:]): v for k, v in registry.TRACE_COUNTS.items()
                           if k[0] == "tensor_parallel"}}
res = {}
engine, res["loop"] = counted(lambda: serve_loop.main(loop))
res["completions"] = sorted([c.rid, c.status, c.finish_reason, list(c.tokens)]
                            for c in engine.completions)
res["health"], res["kv_bytes"] = engine.health(), engine.summary()["kv_cache_bytes_rank"]
del engine
torch.cuda.empty_cache()
out, res["serve"] = counted(lambda: serve.main(one))
res["tokens"] = out["tokens"].tolist()
logits = {"tokens": torch.from_numpy(out["prefill_logits"])}
reduce, C.reduce_from_model = C.reduce_from_model, lambda t, axes: t
out = serve.main(one)
res["control"], logits["control"] = out["tokens"].tolist(), torch.from_numpy(out["prefill_logits"])
C.reduce_from_model = reduce
torch.save(logits, path + ".pt")
del out
torch.cuda.empty_cache()
assert train.main(learn) == 0
json.dump(res, open(path, "w"))
torch.distributed.destroy_process_group()
"""


class _QKRows:
    """Counts, while inside, the rows the attention's Q / K sites take
    (each site one K2 launch on its rows)."""

    def __enter__(self):
        from repro_torch.models import attention as A

        self.rows, self.real = 0, A._rotate_quant_qk

        def spy(cfg, q, k):
            self.rows += q.numel() // q.shape[-1] + k.numel() // k.shape[-1]
            return self.real(cfg, q, k)

        A._rotate_quant_qk = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as A

        A._rotate_quant_qk = self.real


def _tp_argvs(seed: int, tmp: str):
    """(g)'s three launchers' arguments: phi4-mini's engine, llama3-8b's
    one-shot launcher, phi4-mini's training (world 1's: no --mp)."""
    loop = _loop_argv("phi4-mini-3.8b", "int8", seed, MD_ENGINE_REQUESTS) + [
        "--layers", str(TP_LAYERS)]
    # 2 x SLOTS prompts: at random weights a greedy token's margin is often
    # below MD_MARGIN, so the control's rejection rests on the rows above it
    one = _md_serve_argv("llama3-8b", "fp8_e4m3", seed) + [
        "--layers", str(TP_LAYERS), "--batch", str(2 * SLOTS)]
    learn = _md_train_argv(seed) + ["--metrics-out", os.path.join(tmp, "train_tp.jsonl")]
    return loop, one, learn


def _rel_l2(got, want) -> float:
    """Relative L2 distance of ``got`` from ``want`` (in f64)."""
    got = torch.as_tensor(got).double()
    want = torch.as_tensor(want).double()
    return float((got - want).norm() / want.norm())


def hold_logits(what: str, got, want, limit: float, witness=None, control=None) -> dict:
    """``got`` within ``limit`` (relative L2) of world 1's ``want``; the
    ``witness`` (a correct path that differs from world 1 only in rounding
    order) within it too, the ``control`` (a broken path) outside it.
    Returns the readings."""
    r = {k: _rel_l2(v, want) for k, v in (("got", got), ("witness", witness),
                                          ("control", control)) if v is not None}
    print(f"{what}: relative L2 from world 1 " + ", ".join(f"{k} {v:.6g}" for k, v in r.items())
          + f" (limit {limit})")
    if r["got"] > limit:
        fail(f"{what}: {r['got']:.6g} from world 1's logits, over {limit}")
    if r.get("witness", 0.0) > limit:
        fail(f"{what}: the witness reads {r['witness']:.6g}, over {limit}")
    if "control" in r and r["control"] <= limit:
        fail(f"{what}: the control was not rejected ({r['control']:.6g} <= {limit})")
    return r


def _tp_spawn(seed: int, tmp: str):
    """Start (g)'s two ranks (beside (f)): (processes, result paths)."""
    loop, one, learn = _tp_argvs(seed, tmp)
    return _spawn_ranks(_TP_RANK_CODE, [json.dumps(a + list(TP_RANK_ARGS))
                                        for a in (loop, one, learn)], tmp, "tp")


def _md_tensor_parallel(seed: int, tmp: str, train_want, started) -> None:
    """(g) tensor parallelism over 'model' at two ranks on the card over
    gloo, mesh (1, 2), full width, TP_LAYERS layers: phi4-mini's engine
    (int8, the fused down site) -- each rank's completions world 1's but
    where they part at a near tie (world 1's margin at most MD_MARGIN),
    its KV cache half world 1's bytes; llama3-8b's one-shot launcher
    (fp8_e4m3, the grouped down site) -- tokens world 1's under the margin
    rule, its prefill logits within TP_PREFILL_LIMIT of world 1's (the
    witness: world 1 with the output projection summed in the split's two
    row blocks), the Q / K sites' rows (K2's) half world 1's at world 1's
    K1 / K2 / K4 launches, one ``("tensor_parallel", "attn", "split")``
    tick a layer and pass -- and its control, the heads' all-reduce
    dropped, which must part above the margin and fall outside the logits'
    limit; phi4-mini's MD_TRAIN steps, losses within MD_LOSS_LIMIT of
    (b)'s world-1 losses (``train_want``). World 1's engine and launcher
    run beside the ranks (``started``: ``_tp_spawn``'s, beside (f))."""
    import contextlib
    import io

    from repro_torch.launch import serve, serve_loop
    from repro_torch.serving import synthetic_stream
    from repro_torch.testing.forcing import split_output_projection

    print(f"-- multidevice (g): tensor parallelism, two ranks on the card over gloo, "
          f"mesh (1, 2), full width, {TP_LAYERS} layers")
    loop, one, learn = _tp_argvs(seed, tmp)
    procs, paths = started
    with contextlib.redirect_stdout(io.StringIO()):
        engine = serve_loop.main(loop)
        with _QKRows() as qk:
            want, l_want = _counted(lambda: serve.main(one))
        with split_output_projection(2):
            witness = serve.main(one)["prefill_logits"]
    record, kv_bytes = _engine_record(engine), engine.summary()["kv_cache_bytes"]
    ranks = _join_ranks(procs, paths, "multidevice (g)")
    pcfg = engine.cfg
    stream = {r.rid: r.tokens for r in synthetic_stream(
        MD_ENGINE_REQUESTS, vocab_size=pcfg.vocab_size,
        prompt_len=(min(8, PREFILL_LEN), PREFILL_LEN), max_new_tokens=(8, 32), rate=0.5,
        seed=seed)}
    wanted = {c[0]: c for c in record["completions"]}
    toks, margins = np.array(want["tokens"]), np.array(want["margins"])
    for r, res in enumerate(ranks):
        parted = []
        for rid, status, reason, got in res["completions"]:
            ref = wanted[rid][3]
            if got == ref:
                continue
            j = next(i for i in range(min(len(got), len(ref)) + 1)
                     if i >= min(len(got), len(ref)) or got[i] != ref[i])
            parted.append((rid, j, _teacher_margin(pcfg, engine.params, stream[rid], ref[:j])))
        print(f"rank {r} engine: {len(res['completions'])} requests, tokens parting at (rid, "
              f"index, world-1 margin) {parted}; health equal {res['health'] == record['health']}"
              f"; KV cache {res['kv_bytes']} bytes (world 1 {kv_bytes}); launches "
              f"{ {k: res['loop'][k] for k in ('k1', 'k2', 'k4')} }; ticks {res['loop']['ticks']}")
        if any(m > MD_MARGIN for _, _, m in parted) or res["health"] != record["health"]:
            fail(f"multidevice (g): rank {r}'s engine parts from world 1's")
        if 2 * res["kv_bytes"] != kv_bytes:
            fail(f"multidevice (g): rank {r}'s KV cache is not half world 1's")
        s = res["serve"]
        layer_passes = s["k2"] // 2
        for name, got in (("tokens", res["tokens"]), ("control", res["control"])):
            first = [int(np.argmax(row)) if row.any() else None
                     for row in np.array(got) != toks]
            far = [(i, f, round(float(margins[i, f]), 4)) for i, f in enumerate(first)
                   if f is not None and margins[i, f] > MD_MARGIN]
            print(f"rank {r} llama3-8b {name}: rows parting at {first}, above the margin "
                  f"{far}")
            if (name == "tokens") == bool(far):
                fail(f"multidevice (g): rank {r}'s llama3-8b {name} "
                     + ("part from world 1's" if far else "were not rejected"))
        logits = torch.load(paths[r] + ".pt")
        hold_logits(f"multidevice (g): rank {r} llama3-8b prefill logits", logits["tokens"],
                    want["prefill_logits"], TP_PREFILL_LIMIT, witness, logits["control"])
        print(f"rank {r} llama3-8b: Q / K rows {s['rows']} (world 1 {qk.rows}); launches "
              f"K1 {s['k1']}, K2 {s['k2']}, K4 {s['k4']} (world 1 {l_want['K1']}, "
              f"{l_want['K2']}, {l_want['K4']}); ticks {s['ticks']}")
        if 2 * s["rows"] != qk.rows:
            fail(f"multidevice (g): rank {r}'s Q / K rows are not half world 1's")
        if (s["k1"], s["k2"], s["k4"]) != (l_want["K1"], l_want["K2"], l_want["K4"]):
            fail(f"multidevice (g): rank {r}'s launches are not world 1's")
        if s["ticks"] != {"attn/split": layer_passes} or not layer_passes:
            fail(f"multidevice (g): rank {r}'s layers did not all run split")
    got = _md_losses(os.path.join(tmp, "train_tp.jsonl"))
    gap = max(abs(a - b) for a, b in zip(got, train_want))
    print(f"phi4-mini train at (1, 2) ({MD_TRAIN_LAYERS} layers): losses {got}, world 1 "
          f"{train_want}, max |diff| {gap:g} (limit {MD_LOSS_LIMIT})")
    if len(got) != len(train_want) or gap > MD_LOSS_LIMIT:
        fail("multidevice (g): the tensor-parallel losses are not world 1's")
    del engine
    torch.cuda.empty_cache()


# (h): the experts, RWKV6 and Mamba2 over 'model' on the one card -- two
# ranks over gloo at mesh (1, 2), full width, each family cut as below
# (mode, layers), in this order: every rank holds its E / 2 experts, H / 2
# RWKV6 or SSD heads and their states, its MoE layers' KV heads halved; then
# mixtral's control (the combine's reduce over 'model' dropped) and its
# MD_TRAIN steps. The ranks start beside (g) and wait for its end, and for
# world 1's other (h) runs, before maverick: its whole draw (a rank's 16 GB of
# experts, before it keeps its half) beside (g)'s runs, and beside those,
# ran the card out of memory.
TPH_MODELS = {"mixtral-8x7b": ("fp8_e4m3", 2), "rwkv6-7b": ("int8", 2),
              "zamba2-7b": ("fp8_e4m3", 6), "llama4-maverick-400b-a17b": ("fp8_e4m3", 2)}
TPH_WAITS = "llama4-maverick-400b-a17b"   # the run the ranks start after the go file
TPH_TRAIN = ("--opt-state", "int8")   # int8 moments: world 1 and both ranks fit beside (g)

# the probe (h) runs in each rank and in this process: the launch counters,
# the tensor_parallel ticks, the bytes of the first MoE layer's expert
# weights a rank holds live (and their count), and the prefill's caches'
# bytes by kind, around one call
_TPH_PROBE = """
import torch
from repro_torch.kernels import registry
from repro_torch.launch import serve as _serve
from repro_torch.models import mlp as _M


def _nbytes(tree):
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if hasattr(tree, "q"):
        return sum(t.numel() * t.element_size() for t in (tree.q, tree.scale, tree.check)
                   if t is not None)
    return tree.numel() * tree.element_size()


def probe(fn, counters):
    seen = {}
    moe, prefill = _M.apply_moe, _serve.lm_prefill

    def spy_moe(cfg, p, x):
        if "experts" not in seen:
            w = p["experts"]["w_down"]
            seen["experts"] = (_nbytes(p["experts"]), (w.q if hasattr(w, "q") else w).shape[0])
        return moe(cfg, p, x)

    def spy_prefill(cfg, params, batch):
        logits, caches = prefill(cfg, params, batch)
        got = {}
        for c in caches:
            for k, t in c.items():
                got[k] = got.get(k, 0) + t.numel() * t.element_size()
        seen["caches"] = got
        return logits, caches

    for c in counters.values():
        c.launches = 0
    for key in [k for k in registry.TRACE_COUNTS if k[0] == "tensor_parallel"]:
        del registry.TRACE_COUNTS[key]
    _M.apply_moe, _serve.lm_prefill = spy_moe, spy_prefill
    try:
        out = fn()
    finally:
        _M.apply_moe, _serve.lm_prefill = moe, prefill
    torch.cuda.synchronize()
    seen["launches"] = {k: c.launches for k, c in counters.items()}
    seen["ticks"] = {"/".join(k[1:]): v for k, v in registry.TRACE_COUNTS.items()
                     if k[0] == "tensor_parallel"}
    return out, seen
"""

# one rank of (h): the process group, each family's launcher under the probe
# (TPH_WAITS once the go file exists; the rank exits if its parent ends
# first), mixtral's control, then mixtral's training, results as JSON
_TPH_RANK_CODE = """
import json, os, sys, time, types, torch
from repro_torch.distributed import collectives as C
from repro_torch.kernels import quant_dot as qd
from repro_torch.kernels.fused_quant import fused_dequant_cuda
from repro_torch.kernels.hadacore import hadacore_cuda
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import COLLECTIVE_TIMEOUT_S, init_distributed
from repro_torch.models import mlp as M
PROBE_
path, runs, learn, go = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3]), sys.argv[4]
parent = os.getppid()
init_distributed(torch.device("cuda:0"), "gloo", COLLECTIVE_TIMEOUT_S)
counters = {"K1": hadacore_cuda, "K2": fused_dequant_cuda, "K4": qd.quant_dot_cuda,
            "K6": qd.quant_dot_experts_cuda}
res = {}
for name, argv in runs:
    while name == "WAITS_" and not os.path.exists(go):
        if os.getppid() != parent:
            sys.exit(3)
        time.sleep(0.2)
    if name == "control":
        M.C = types.SimpleNamespace(**dict(vars(C), reduce_from_model=lambda t, axes: t))
    out, res[name] = probe(lambda: serve.main(argv), counters)
    M.C = C
    res[name]["tokens"] = out["tokens"].tolist()
    del out
    torch.cuda.empty_cache()
assert train.main(learn) == 0
json.dump(res, open(path, "w"))
torch.distributed.destroy_process_group()
"""


def _tph_argvs(seed: int):
    """(h)'s launcher runs ((name, world-1 arguments), ...) and mixtral's
    training arguments (world 1's: no --mp)."""
    runs = []
    for arch, (mode, layers) in TPH_MODELS.items():
        runs.append((arch, _md_argv(arch, mode, seed) + [
            "--batch", str(SLOTS), "--prompt-len", str(PREFILL_LEN), "--gen",
            str(MD_FAMILY_GEN), "--layers", str(layers)]))
        if arch == "mixtral-8x7b":
            runs.append(("control", list(runs[-1][1])))
    mode, layers = TPH_MODELS["mixtral-8x7b"]
    learn = _md_argv("mixtral-8x7b", mode, seed) + [
        "--layers", str(layers), "--log-every", "1", *MD_TRAIN, *TPH_TRAIN]
    return runs, learn


def _tph_spawn(seed: int, tmp: str):
    """Start (h)'s two ranks (beside (g)'s)."""
    runs, learn = _tph_argvs(seed)
    ranked = [(name, argv + list(TP_RANK_ARGS)) for name, argv in runs]
    learn = learn + list(TP_RANK_ARGS) + ["--metrics-out", os.path.join(tmp, "train_tph.jsonl")]
    code = _TPH_RANK_CODE.replace("PROBE_", _TPH_PROBE).replace("WAITS_", TPH_WAITS)
    return _spawn_ranks(code, [json.dumps(ranked), json.dumps(learn), _tph_go(tmp)], tmp,
                        "tph")


def _tph_go(tmp: str) -> str:
    """The file whose existence lets (h)'s ranks go on past (g)."""
    return os.path.join(tmp, "tph_go")


def _md_moe_recurrent(seed: int, tmp: str, started) -> None:
    """(h) experts, RWKV6 and Mamba2 over 'model' at two ranks on the card
    over gloo, mesh (1, 2), full width, ``TPH_MODELS``' depths, against the
    same launcher at world 1 (no process group; run here after (g), maverick
    and the training after the ranks end): each
    rank's tokens world 1's under the margin rule, its launches world 1's
    (one K6 a MoE layer and pass, over its 64 of maverick's 128 experts; one
    grouped K1 a layer and pass at mixtral's and rwkv6's down sites), every
    layer of every pass ticked ``split``, its expert weights (mixtral: 4 of 8
    experts) and its caches -- the MoE layers' KV, RWKV6's ``S``, Mamba2's
    ``ssm`` and ``conv_x`` -- at half world 1's bytes; mixtral's control (the
    combine's reduce dropped) parts above the margin; mixtral's MD_TRAIN
    steps (int8 moments) within MD_LOSS_LIMIT of world 1's losses. Then the
    shard-local K6: a rank's 64 of maverick's 128 experts at decode rows,
    bitwise the whole launch's rows of those experts, both timed through
    ``bench/quant_dot.py``."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.launch.serve_loop import cut_depth

    print("-- multidevice (h): experts, RWKV6 and Mamba2 over 'model', two ranks on the card "
          f"over gloo, mesh (1, 2), full width: {TPH_MODELS}")
    t0 = time.perf_counter()
    runs, learn = _tph_argvs(seed)
    ns = {}
    exec(_TPH_PROBE, ns)
    counters = {k: v for k, v in _counters().items() if k in ("K1", "K2", "K4", "K6")}
    want = {}

    def world_one(names):
        with contextlib.redirect_stdout(io.StringIO()):
            for name, argv in runs:
                if name in names:
                    out, want[name] = ns["probe"](lambda: serve.main(argv), counters)
                    want[name]["tokens"], want[name]["margins"] = out["tokens"], out["margins"]
                    del out
                    torch.cuda.empty_cache()

    # the ranks' maverick draws (a rank's whole 16 GB of experts before it
    # keeps its half) start once world 1's other families have run: beside
    # both, the card ran out of memory
    torch.cuda.empty_cache()
    world_one([a for a in TPH_MODELS if a != TPH_WAITS])
    open(_tph_go(tmp), "w").close()
    t1 = time.perf_counter()
    procs, paths = started
    ranks = _join_ranks(procs, paths, "multidevice (h)", timeout=600)
    t2 = time.perf_counter()
    # world 1's maverick and training after the ranks end: beside their
    # maverick draws it ran the card out of memory
    world_one([TPH_WAITS])
    path = os.path.join(tmp, "train_tph_w1.jsonl")
    with contextlib.redirect_stdout(io.StringIO()):
        assert train.main(learn + ["--metrics-out", path]) == 0
    w1_losses = _md_losses(path)
    torch.cuda.empty_cache()
    halves = {"llama4-maverick-400b-a17b": ("experts", "k", "v"),
              "mixtral-8x7b": ("experts", "k", "v"), "rwkv6-7b": ("S",),
              "zamba2-7b": ("ssm", "conv_x")}
    for r, res in enumerate(ranks):
        for arch, (mode, layers) in TPH_MODELS.items():
            got, w1 = res[arch], want[arch]
            toks, margins = w1["tokens"], w1["margins"]
            first = [int(np.argmax(row)) if row.any() else None
                     for row in np.array(got["tokens"]) != toks]
            parted = [(i, f, round(float(margins[i, f]), 4)) for i, f in enumerate(first)
                      if f is not None]
            kinds = cut_depth(get_config(arch), layers).layer_kinds
            ticks = {}
            for kind in kinds:
                ticks[f"{kind}/split"] = ticks.get(f"{kind}/split", 0) + MD_FAMILY_GEN
            sizes = {k: (got["caches"].get(k), w1["caches"].get(k)) for k in halves[arch]
                     if k != "experts"}
            if "experts" in halves[arch]:
                sizes["experts"] = (got["experts"][0], w1["experts"][0])
            print(f"rank {r} {arch} ({mode}, {layers} layers): rows parting at (row, index, "
                  f"world-1 margin) {parted}; launches {got['launches']} (world 1 "
                  f"{w1['launches']}); ticks {got['ticks']}; bytes (rank, world 1) {sizes}"
                  + (f"; experts {got['experts'][1]} of {w1['experts'][1]}"
                     if "experts" in got else ""))
            if any(m > MD_MARGIN for _, _, m in parted):
                fail(f"multidevice (h): rank {r}'s {arch} tokens part from world 1's")
            if got["launches"] != w1["launches"] or not any(got["launches"].values()):
                fail(f"multidevice (h): rank {r}'s {arch} launches are not world 1's")
            if got["ticks"] != ticks:
                fail(f"multidevice (h): rank {r}'s {arch} layers did not all run split")
            if any(a is None or 2 * a != b for a, b in sizes.values()):
                fail(f"multidevice (h): rank {r}'s {arch} weights or states are not half "
                     "world 1's")
            if "experts" in got and 2 * got["experts"][1] != w1["experts"][1]:
                fail(f"multidevice (h): rank {r}'s {arch} experts are not half world 1's")
        mix = want["mixtral-8x7b"]
        first = [int(np.argmax(row)) if row.any() else None
                 for row in np.array(res["control"]["tokens"]) != mix["tokens"]]
        far = [(i, f, round(float(mix["margins"][i, f]), 4)) for i, f in enumerate(first)
               if f is not None and mix["margins"][i, f] > MD_MARGIN]
        print(f"rank {r} mixtral control (the combine's reduce dropped): rows parting at "
              f"{first}, above the margin {far}")
        if not far:
            fail(f"multidevice (h): rank {r}'s mixtral control was not rejected")
    got = _md_losses(os.path.join(tmp, "train_tph.jsonl"))
    gap = max(abs(a - b) for a, b in zip(got, w1_losses))
    print(f"mixtral-8x7b train at (1, 2) ({TPH_MODELS['mixtral-8x7b'][1]} layers, int8 "
          f"moments): losses {got}, world 1 {w1_losses}, max |diff| {gap:g} (limit "
          f"{MD_LOSS_LIMIT})")
    if len(got) != len(w1_losses) or gap > MD_LOSS_LIMIT:
        fail("multidevice (h): mixtral's tensor-parallel losses are not world 1's")
    t3 = time.perf_counter()
    _k6_shard_local(seed)
    print(f"(h) world 1's serving beside the ranks {t1 - t0:.1f} s, ranks' wait "
          f"{t2 - t1:.1f} s, world 1's maverick, training and the checks {t3 - t2:.1f} s, "
          f"shard-local K6 {time.perf_counter() - t3:.1f} s")


def _k6_shard_local(seed: int) -> None:
    """K6 over a rank's 64 of maverick's 128 experts (8192 -> 5120 fp8_e4m3,
    decode rows (SLOTS, 64, 1, 8192)) bitwise the whole launch's rows of
    those experts, and both timed through ``bench/quant_dot.py``."""
    from repro_torch.bench.quant_dot import Case, expert_weights
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.kernels import quant_dot as qd

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, d = MAVERICK_DOWN
    mode, half = "fp8_e4m3", EXPERTS // 2
    ex = expert_weights(gen, n, d, mode)
    x = (torch.randn(SLOTS * EXPERTS, n, generator=gen, device="cuda") * 3).to(
        torch.bfloat16).view(SLOTS, EXPERTS, 1, n)
    plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                    epilogue=QuantEpilogue(mode))
    whole = qd.quant_dot_experts(x, ex.q, ex.scale, plan, "rotate_once")
    mine = x[:, :half].contiguous()
    shard = qd.quant_dot_experts(mine, ex.q[:half], ex.scale[:half], plan, "rotate_once")
    same = torch.equal(_bits(shard), _bits(whole[:, :half]))
    print(f"-- multidevice (h): shard-local K6, {half} of {EXPERTS} experts at "
          f"{tuple(mine.shape)} -> {d} {mode}: bitwise the whole launch's rows {same}")
    if not same:
        fail("multidevice (h): the shard-local K6 differs from the whole launch's rows")
    for e, xs, w in ((EXPERTS, x, ex), (half, mine, type(ex)(ex.q[:half], ex.scale[:half],
                                                             mode))):
        rec = _measure(Case("K6", mode, SLOTS, n, d, n_experts=e), gen, w, None, xs)
        print(_record_line(f"K6  {mode:8s} {tuple(xs.shape)} -> {d} ({e} experts)", rec))
    del ex, x, whole, shard
    torch.cuda.empty_cache()


# (i): per-launch sharding rules when serving -- two ranks over gloo on the
# one card, ``ServeEngine(rules_overrides=decode_rules(cfg, ShapeSpec("engine",
# "decode", max_len, slots)))``, teacher-forced (``testing.forcing``) and
# serving a greedy stream through ``engine.run``, full width, each family
# cut as below (mode, layers, model-parallel size):
# phi4-mini at (1, 2) -- the KV cache's rows over 'model', the query heads
# over 'model', the KV heads whole, fsdp None -- and maverick at (2, 1) --
# its experts over 'data', the slots over 'data' too, so each MoE layer
# gathers the rows. Each against world 1 at the same cut and rules. The
# ranks start beside (g) (beside (d) a rank's draw ran the card out of
# memory: (d)'s world-1 mixtral holds most of it) and have run phi4 before
# (h)'s maverick draws begin; they wait for (h)'s end before maverick.
TPI_MODELS = {"phi4-mini-3.8b": ("int8", 4, 2), "llama4-maverick-400b-a17b": ("fp8_e4m3", 2, 1)}
TPI_WAITS = "llama4-maverick-400b-a17b"   # the run the ranks start after (h) ends
TPI_PREFILL = {"phi4-mini-3.8b": 192, "llama4-maverick-400b-a17b": PREFILL_LEN}
TPI_GEN = {"phi4-mini-3.8b": 24, "llama4-maverick-400b-a17b": 8}
# phi4's teacher-forced prompt lengths, one a slot: decode crosses the
# ranks' row boundary at 128 (112, 127), an insert splits over both ranks
# (150), the whole bucket (192)
TPI_PROMPTS = {"phi4-mini-3.8b": (112, 150, 127, 192)}
# the served streams (serve_loop's knobs): phi4's prompts and decodes cross
# row 128, with ABFT on (REPRO_ABFT=1)
TPI_STREAM = {"phi4-mini-3.8b": ("--requests", "6", "--rate", "2.0", "--prompt-min", "100",
                                 "--prompt-max", "192", "--gen-min", "16", "--gen-max", "32"),
              "llama4-maverick-400b-a17b": ("--requests", "4", "--rate", "2.0", "--prompt-min",
                                            "32", "--gen-min", "4", "--gen-max", "8")}
TPI_ABFT = ("phi4-mini-3.8b",)
# relative L2 of the ranks' logits from world 1's, (prefill, decode): above
# the reading and its witness, below the control (PERF.md, section 6)
TPI_LIMITS = {"phi4-mini-3.8b": (0.06, 0.08), "llama4-maverick-400b-a17b": (0.01, 0.01)}

# one rank of (i): the process group, then per family its seeded weights
# drawn once, the engine under decode_rules driven teacher-forced, itself
# and under its control, with the launch counters zeroed just before and
# read just after (K6's (rows, experts) per launch recorded); then a fresh
# engine under the same rules serves serve_loop's stream (ABFT on where
# asked); logits to a .pt beside the JSON results
_TPI_RANK_CODE = """
import json, os, sys, time, types, numpy as np, torch
from repro_torch.distributed import collectives as C
from repro_torch.kernels import quant_dot as qd
from repro_torch.kernels.fused_quant import fused_dequant_cuda
from repro_torch.kernels.hadacore import hadacore_cuda
from repro_torch.launch import serve_loop
from repro_torch.launch.dryrun import decode_rules
from repro_torch.launch.mesh import COLLECTIVE_TIMEOUT_S, init_distributed, make_local_mesh
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import mlp as M
from repro_torch.models.lm import init_lm
from repro_torch.serving import ServeEngine
from repro_torch.testing.forcing import forced_logits
path, runs, go = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
parent = os.getppid()
init_distributed(torch.device("cuda:0"), "gloo", COLLECTIVE_TIMEOUT_S)
k6_rows, k6 = [], qd.quant_dot_experts_cuda
def spy(x4, *a):
    k6_rows.append(list(x4.shape[:2]))
    return k6(x4, *a)
spy.launches = 0              # K6's own count lands here: it counts by its module name
qd.quant_dot_experts_cuda = spy
counters = {"K1": hadacore_cuda, "K2": fused_dequant_cuda, "K4": qd.quant_dot_cuda, "K6": spy}
def no_common_max(t, axes, op="sum"):
    return t if op == "max" else reduce(t, axes, op)
def nbytes(tree):
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if hasattr(tree, "q"):
        return sum(t.numel() * t.element_size() for t in (tree.q, tree.scale) if t is not None)
    return tree.numel() * tree.element_size()
res, logits, reduce = {}, {}, C.kvseq_all_reduce
for arch, argv, mp, prompts, forced, control, wait, abft in runs:
    while wait and not os.path.exists(go):
        if os.getppid() != parent:
            sys.exit(3)
        time.sleep(0.2)
    args = serve_loop.parse_args(argv)
    cfg = serve_loop.config_of(args)
    mesh = make_local_mesh(mp)
    rules = decode_rules(cfg, ShapeSpec("engine", "decode", args.max_len, args.slots))
    # the engine keeps its shards: the whole draw goes before the passes, and
    # the control re-admits its prompts into the same engine
    engine = ServeEngine(cfg, init_lm(cfg, seed=args.seed, device="cuda"),
                         num_slots=args.slots, max_len=args.max_len,
                         prefill_len=args.prefill_len, device="cuda", mesh=mesh,
                         rules_overrides=rules)
    torch.cuda.empty_cache()
    for ctl in (None, control):
        if ctl == "rescale":
            C.kvseq_all_reduce = no_common_max
        if ctl == "experts":
            M.C = types.SimpleNamespace(**dict(vars(C), reduce_from_model=lambda t, axes: t))
        for c in counters.values():
            c.launches = 0
        k6_rows.clear()
        out = forced_logits(engine, prompts, np.array(forced))
        torch.cuda.synchronize()
        C.kvseq_all_reduce, M.C = reduce, C
        logits[f"{arch}/{ctl}"] = out
        if ctl is None:
            experts = [nbytes(lp["moe"]["experts"]) for lp in engine.params["layers"] if "moe" in lp]
            res[arch] = {"launches": {k: c.launches for k, c in counters.items()},
                         "k6_rows": list(k6_rows), "experts": sum(experts),
                         "kv_bytes": engine.summary()["kv_cache_bytes_rank"],
                         "seq": [engine._seq.index, engine._seq.size, list(engine._seq.axes)],
                         "slots": engine._slots.tolist(), "rules": rules}
        del out
    del engine
    torch.cuda.empty_cache()
    if abft:
        os.environ["REPRO_ABFT"] = "1"
    engine = ServeEngine(cfg, init_lm(cfg, seed=args.seed, device="cuda"),
                         num_slots=args.slots, max_len=args.max_len,
                         prefill_len=args.prefill_len, device="cuda", mesh=mesh,
                         rules_overrides=rules)
    torch.cuda.empty_cache()
    engine.run(serve_loop.request_stream(args, cfg.vocab_size))
    os.environ.pop("REPRO_ABFT", None)
    res[arch]["stream"] = {"completions": sorted([c.rid, c.status, c.finish_reason,
                                                  list(c.tokens)] for c in engine.completions),
                           "health": engine.health()}
    del engine
    torch.cuda.empty_cache()
    open(path + "." + arch, "w").close()
torch.save(logits, path + ".pt")
json.dump(res, open(path, "w"))
torch.distributed.destroy_process_group()
"""


def _tpi_argv(arch: str, seed: int):
    mode, layers, _ = TPI_MODELS[arch]
    return _md_argv(arch, mode, seed) + ["--slots", str(SLOTS), "--max-len", str(MAX_LEN),
                                         "--prefill-len", str(TPI_PREFILL[arch]),
                                         "--layers", str(layers), *TPI_STREAM[arch]]


def _tpi_traffic(arch: str, seed: int):
    """(i)'s prompts, one per slot (TPI_PROMPTS' lengths, else 3/4 of the
    prefill bucket up to all of it), and its (TPI_GEN, SLOTS) forced
    tokens, drawn from ``seed``."""
    from repro_torch.launch import serve_loop

    vocab = serve_loop.config_of(serve_loop.parse_args(_tpi_argv(arch, seed))).vocab_size
    P = TPI_PREFILL[arch]
    rng = np.random.default_rng(seed + 27)
    lengths = rng.integers(3 * P // 4, P + 1, SLOTS)
    prompts = [rng.integers(0, vocab, int(n)).tolist()
               for n in TPI_PROMPTS.get(arch, lengths)]
    return prompts, rng.integers(0, vocab, (TPI_GEN[arch], SLOTS)).tolist()


def _tpi_spawn(seed: int, tmp: str):
    """Start (i)'s two ranks (beside (g)): (processes, result paths)."""
    runs = []
    for arch, (_, _, mp) in TPI_MODELS.items():
        prompts, forced = _tpi_traffic(arch, seed)
        control = "experts" if _num_experts(arch) else "rescale"
        runs.append((arch, _tpi_argv(arch, seed), mp, prompts, forced, control,
                     arch == TPI_WAITS, arch in TPI_ABFT))
    return _spawn_ranks(_TPI_RANK_CODE, [json.dumps(runs), os.path.join(tmp, "tpi_go")],
                        tmp, "tpi")


def _num_experts(arch: str) -> int:
    from repro_torch.configs import get_config

    return get_config(arch).num_experts


def _tpi_wait(started, arch: str, timeout: float = 600) -> None:
    """Wait until both of (i)'s ranks have run ``arch`` (a rank that ended
    fails the phase)."""
    procs, paths = started
    deadline = time.monotonic() + timeout
    while not all(os.path.exists(p + "." + arch) for p in paths):
        if any(p.poll() is not None for p in procs):
            _join_ranks(procs, paths, "multidevice (i)")
        if time.monotonic() > deadline:
            fail(f"multidevice (i): the ranks did not finish {arch} within {timeout} s")
        time.sleep(0.5)


def _md_rules(seed: int, tmp: str, started) -> None:
    """(i) per-launch sharding rules when serving at two ranks on the card
    over gloo, ``decode_rules`` through ``ServeEngine(rules_overrides=)``,
    full width, against world 1 (the engine without a mesh, the same cut
    and rules; run here): phi4-mini (int8 + Hadamard, 4 layers) at (1, 2)
    -- each rank's KV cache exactly half world 1's bytes; teacher-forced,
    its greedy tokens world 1's under the margin rule, its prefill and
    decode logits within TPI_LIMITS of world 1's (the witness: world 1
    with its output projection summed in two row blocks; the control: the
    merge without the common row maximum, outside), its K2 / K4 launches
    world 1's, 8 K2 and 4 K4 a pass -- and llama4-maverick (fp8_e4m3, one
    (attn, moe) group) at (2, 1) -- one K6 launch a pass over its 64 of
    the 128 experts, on the whole batch's rows at decode (the rows
    gathered), its expert weights exactly half world 1's bytes, its tokens
    under the margin rule and its logits within TPI_LIMITS (the control:
    the combine's sum over the experts' ranks dropped, outside). Each
    family then serves serve_loop's stream (TPI_STREAM) through
    ``engine.run`` on the ranks and at world 1, phi4 with ABFT on: every
    request ok, no ABFT trip and rung 0 on every rank, the completions
    world 1's under the margin rule (``_stream_parting``)."""
    import io

    from repro_torch.launch import serve_loop
    from repro_torch.launch.dryrun import decode_rules
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models.lm import init_lm
    from repro_torch.serving import ServeEngine
    from repro_torch.testing.forcing import forced_logits, split_output_projection

    print("-- multidevice (i): per-launch sharding rules (decode_rules), two ranks on the "
          f"card over gloo, full width: {TPI_MODELS}")
    t0 = time.perf_counter()
    # the ranks' maverick draws start now: nothing of this process's cache
    # may stand in their way
    torch.cuda.empty_cache()
    print(f"this process before the ranks' draws: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved", flush=True)
    open(os.path.join(tmp, "tpi_go"), "w").close()
    counters = {k: v for k, v in _counters().items() if k in ("K1", "K2", "K4", "K6")}
    want = {}

    def world_one(arch):
        args = serve_loop.parse_args(_tpi_argv(arch, seed))
        cfg = serve_loop.config_of(args)
        rules = decode_rules(cfg, ShapeSpec("engine", "decode", args.max_len, args.slots))
        params = init_lm(cfg, seed=args.seed, device="cuda")
        prompts, forced = _tpi_traffic(arch, seed)
        got = {"rules": rules, "cfg": cfg, "params": params}
        witnesses = [("world 1", contextlib.nullcontext)]
        if not cfg.num_experts:
            witnesses.append(("witness", lambda: split_output_projection(2)))
        for name, ctx in witnesses:
            engine = ServeEngine(cfg, params, num_slots=args.slots, max_len=args.max_len,
                                 prefill_len=args.prefill_len, device="cuda",
                                 rules_overrides=rules)
            with ctx(), contextlib.redirect_stdout(io.StringIO()):
                out, launches = _counted(lambda: forced_logits(engine, prompts,
                                                               np.array(forced)))
            got[name] = out
            if name == "world 1":
                got["launches"] = {k: launches[k] for k in counters}
                got["kv_bytes"] = engine.summary()["kv_cache_bytes_rank"]
                got["experts"] = sum(_nbytes(lp["moe"]["experts"])
                                     for lp in engine.params["layers"] if "moe" in lp)
            del engine
        stream = serve_loop.request_stream(args, cfg.vocab_size)
        with _abft_env(arch in TPI_ABFT):
            engine = ServeEngine(cfg, params, num_slots=args.slots, max_len=args.max_len,
                                 prefill_len=args.prefill_len, device="cuda",
                                 rules_overrides=rules)
            engine.run(stream)
        got["stream"] = _engine_record(engine)
        got["prompts"] = {r.rid: r.tokens for r in stream}
        del engine
        torch.cuda.empty_cache()
        want[arch] = got

    def hold(arch, ranks, logits):
        mode, layers, mp = TPI_MODELS[arch]
        w1 = want.pop(arch)
        passes = SLOTS + TPI_GEN[arch]
        ref = torch.cat([w1["world 1"]["prefill"][None], w1["world 1"]["decode"]])
        for r, res in enumerate(ranks):
            got, out = res[arch], logits[r][f"{arch}/None"]
            ctl = logits[r][f"{arch}/{'experts' if _num_experts(arch) else 'rescale'}"]
            print(f"rank {r} {arch} ({mode}, {layers} layers, mesh ({2 // mp}, {mp})): rules "
                  f"{got['rules']}; slots {got['slots']}; cache rows {got['seq']}; KV bytes "
                  f"{got['kv_bytes']} (world 1 {w1['kv_bytes']}); expert bytes {got['experts']} "
                  f"(world 1 {w1['experts']}); launches {got['launches']} (world 1 "
                  f"{w1['launches']}, {passes} passes)")
            if got["rules"] != json.loads(json.dumps(w1["rules"])):
                fail(f"multidevice (i): rank {r}'s {arch} rules are not world 1's")
            steps = torch.cat([out["prefill"][None], out["decode"]])
            bad = _margin_parting(steps, ref)
            print(f"rank {r} {arch}: tokens parting above the margin rule (step, row) {bad}; "
                  f"argmax equal {float((steps.argmax(-1) == ref.argmax(-1)).float().mean()):.4f}")
            if bad:
                fail(f"multidevice (i): rank {r}'s {arch} tokens part from world 1's")
            lim_pre, lim_dec = TPI_LIMITS[arch]
            wit = w1.get("witness")
            # no prefill control: the merge's takes no part in a prefill, and
            # the combine's drop moves a prefill's last position only where
            # its token routes to the other rank's experts
            hold_logits(f"multidevice (i): rank {r} {arch} prefill logits", out["prefill"],
                        w1["world 1"]["prefill"], lim_pre,
                        None if wit is None else wit["prefill"])
            hold_logits(f"multidevice (i): rank {r} {arch} decode logits", out["decode"],
                        w1["world 1"]["decode"], lim_dec,
                        None if wit is None else wit["decode"], ctl["decode"])
            if got["launches"] != w1["launches"]:
                fail(f"multidevice (i): rank {r}'s {arch} launches are not world 1's")
            if _num_experts(arch):
                e = _num_experts(arch)
                rows = got["k6_rows"]
                print(f"rank {r} {arch}: K6 launches (rows, experts) {rows}")
                if 2 * got["experts"] != w1["experts"]:
                    fail(f"multidevice (i): rank {r}'s maverick expert bytes are not half")
                if len(rows) != passes or any(x[1] != e // 2 for x in rows) or \
                        any(x[0] != SLOTS for x in rows[SLOTS:]):
                    fail(f"multidevice (i): rank {r}'s maverick did not run one K6 a pass "
                         "over its experts on the gathered rows")
            else:
                if 2 * got["kv_bytes"] != w1["kv_bytes"] or got["seq"][1] != 2:
                    fail(f"multidevice (i): rank {r}'s phi4 KV cache is not half world 1's")
                want_l = {"K1": 0, "K2": 2 * layers * passes, "K4": layers * passes, "K6": 0}
                if got["launches"] != want_l:
                    fail(f"multidevice (i): rank {r}'s phi4 launches are not {want_l}")
            stream, ws = got["stream"], w1["stream"]
            parted = _stream_parting(w1["cfg"], w1["params"], w1["prompts"],
                                     stream["completions"], ws["completions"])
            statuses = [c[1:3] for c in stream["completions"]]
            print(f"rank {r} {arch} stream ({len(statuses)} requests, ABFT "
                  f"{stream['health']['abft_enabled']}): statuses world 1's "
                  f"{statuses == [c[1:3] for c in ws['completions']]}; tokens parting at (rid, "
                  f"index, world-1 margin) {parted}; health {stream['health']} (world 1 "
                  f"{ws['health']})")
            for h in (stream["health"], ws["health"]):
                if any(h[k] for k in HEALTH_ZERO) or h["abft_enabled"] != (arch in TPI_ABFT):
                    fail(f"multidevice (i): {arch}'s stream did not serve cleanly: {h}")
            if any(c[1] != "ok" for c in stream["completions"]) or \
                    statuses != [c[1:3] for c in ws["completions"]]:
                fail(f"multidevice (i): rank {r}'s {arch} stream statuses are not world 1's")
            if any(m > MD_MARGIN for _, _, m in parted):
                fail(f"multidevice (i): rank {r}'s {arch} stream parts from world 1's")
        del w1
        torch.cuda.empty_cache()

    world_one("phi4-mini-3.8b")
    t1 = time.perf_counter()
    procs, paths = started
    ranks = _join_ranks(procs, paths, "multidevice (i)", timeout=600)
    logits = [torch.load(p + ".pt") for p in paths]
    t2 = time.perf_counter()
    hold("phi4-mini-3.8b", ranks, logits)
    world_one(TPI_WAITS)          # after the ranks' maverick draws end
    hold(TPI_WAITS, ranks, logits)
    t3 = time.perf_counter()
    print(f"(i) world 1's phi4 beside the ranks {t1 - t0:.1f} s, the ranks' wait "
          f"{t2 - t1:.1f} s, world 1's maverick {t3 - t2:.1f} s")
    torch.cuda.empty_cache()


# (j): per-launch sharding rules in training on the one card -- two ranks over
# gloo at mesh (1, 2), phi4-mini at full width, TPJ_LAYERS of its 32 layers,
# int8 + Hadamard, 4 x 512 tokens (MD_TRAIN's), f32 moments: (a) residual
# sequence parallelism ({"seqpar": "model"}) over the default, tensor-parallel
# rules, against the same ranks without it; (b) FSDP_ONLY_RULES against world
# 1, which each rank runs first. The ranks start before the window phase
# and run beside it, the launcher and the launcher families.
TPJ_LAYERS = TP_LAYERS
TPJ_STEPS = 2
TPJ_SEQ, TPJ_BATCH = 512, 4
# (a)'s step-0 gradients, relative L2 per leaf from the same ranks' without
# 'seqpar': set between the witness (world 1 with its block norms summed
# over the two halves of the positions) and the control (the norms'
# gradient not summed over 'model'); PERF.md, section 6
TPJ_SEQPAR_LIMIT = 1e-4
TPJ_SEQPAR = {"seqpar": "model"}

# one rank of (j): this file's ``_tpj_rank``
_TPJ_RANK_CODE = """
import sys
sys.path.insert(0, sys.argv[2])
import chip_smoke
chip_smoke._tpj_rank(sys.argv[1], int(sys.argv[3]))
"""


def _tpj_config():
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch.serve_loop import cut_depth

    quant = QuantConfig(mode="int8", rotate="hadamard", backend="cuda", kv_quant=True)
    return cut_depth(get_config("phi4-mini-3.8b").with_quant(quant), TPJ_LAYERS)


def _tree_bytes(tree) -> int:
    from repro_torch import tree as T

    return sum(t.numel() * t.element_size() for t in T.leaves(tree)
               if isinstance(t, torch.Tensor))


def _per_leaf_rel(got, want) -> list:
    """Each leaf's relative L2 distance of ``got`` from ``want`` (on the
    card, in f32)."""
    out = []
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        den = float(b.norm())
        out.append(float((a - b).norm()) / den if den else float(a.abs().max()))
    return out


def _shard_rel(mesh, got, want) -> tuple:
    """(the largest relative L2 distance over the leaves, whether every
    leaf is bitwise equal) of two sets of shards in one layout, whole: each
    leaf's squared sums all-reduced (a leaf every rank holds whole counts
    alike in both)."""
    worst, same = 0.0, True
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        sums = torch.stack([(a - b).square().sum(), b.square().sum(),
                            (a != b).sum().float()]).double()
        mesh.all_reduce(sums, ("data", "model"))
        num, den, off = (float(x) for x in sums)
        worst = max(worst, math.sqrt(num / den) if den else math.sqrt(num))
        same = same and off == 0
    return worst, same


def _tpj_rank(path: str, seed: int) -> None:
    """One rank of (j) (the comment above ``TPJ_LAYERS``): every reading as
    JSON at ``path``. Each rank holds its gradient shards against world 1's
    (which both ranks compute) or the same ranks' without 'seqpar', the
    squared sums all-reduced, so no gradient is gathered; rank 0 runs world
    1's steps while rank 1 reads the witness."""
    import torch.distributed as dist

    from repro_torch.data import SyntheticDataset
    from repro_torch.distributed.collectives import shard_tree
    from repro_torch.kernels import quant_dot as qd
    from repro_torch.kernels.fused_quant import fused_dequant_cuda
    from repro_torch.kernels.hadacore import hadacore_cuda
    from repro_torch.launch.dryrun import FSDP_ONLY_RULES
    from repro_torch.launch.mesh import (COLLECTIVE_TIMEOUT_S, init_distributed,
                                         make_local_mesh)
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import batch_to, make_train_step, state_parts
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.testing.forcing import (norms_unsummed, split_positions, step_zero,
                                             summed_over_model)

    init_distributed(torch.device("cuda:0"), "gloo", COLLECTIVE_TIMEOUT_S)
    mesh = make_local_mesh(2)
    cfg = _tpj_config()
    opt = OptConfig(lr=3e-4, warmup_steps=1, total_steps=TPJ_STEPS)
    ds = SyntheticDataset(cfg, ShapeSpec("j", "train", TPJ_SEQ, TPJ_BATCH), seed=seed)
    batches = [batch_to(ds.batch(i), "cuda") for i in range(TPJ_STEPS)]
    counters = {"K1": hadacore_cuda, "K2": fused_dequant_cuda, "K4": qd.quant_dot_cuda}

    def fresh():
        return init_lm(cfg, seed=seed, device="cuda")

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}

    def train(rules):
        """TPJ_STEPS steps: losses, each step's launches and ms, this
        rank's parameter and moment bytes."""
        params = fresh()
        state = init_opt_state(params, opt)
        if rules != "world 1":
            pparts, oparts = state_parts(cfg, opt, mesh, rules)
            params, state = shard_tree(params, pparts, mesh), shard_tree(state, oparts, mesh)
        step = make_train_step(cfg, opt, **({} if rules == "world 1"
                                            else {"mesh": mesh, "rules_overrides": rules}))
        out = {"param_bytes": _tree_bytes(params),
               "moment_bytes": _tree_bytes(state["m"]) + _tree_bytes(state["v"]),
               "losses": [], "launches": [], "ms": []}
        for b in batches:
            t0 = time.perf_counter()
            (params, state, m), n = counted(lambda: step(params, state, b))
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            out["losses"].append(float(m["loss"]))
            out["launches"].append(n)
        del params, state
        torch.cuda.empty_cache()
        return out

    res = {"rank": mesh.rank}
    torch.cuda.reset_peak_memory_stats()
    # world 1 on both ranks; then rank 0 its steps, rank 1 the witness of (a)
    want, res["launches_w1"] = counted(lambda: step_zero(cfg, fresh(), batches[0]))
    res["ce_w1"], res["saved_w1"] = want["ce"], want["saved"]
    if mesh.rank == 0:
        res["train_w1"] = train("world 1")
    else:
        with split_positions(2):
            wit = step_zero(cfg, fresh(), batches[0])
        res["witness"] = max(_per_leaf_rel(wit["grads"], want["grads"]))
        del wit
    dist.barrier()
    # (a) the default rules with and without 'seqpar', then its control
    base, res["launches_tp"] = counted(
        lambda: step_zero(cfg, fresh(), batches[0], mesh, gather=False))
    got, res["launches_seqpar"] = counted(
        lambda: step_zero(cfg, fresh(), batches[0], mesh, TPJ_SEQPAR, gather=False))
    with norms_unsummed():
        ctrl = step_zero(cfg, fresh(), batches[0], mesh, TPJ_SEQPAR, gather=False)
    for key, run in (("tp", base), ("seqpar", got)):
        res[f"ce_{key}"], res[f"saved_{key}"], res[f"blocks_{key}"] = (
            run["ce"], run["saved"], run["blocks"])
    res["seqpar_grads"] = _shard_rel(mesh, got["grads"], base["grads"])[0]
    res["seqpar_control"] = _shard_rel(mesh, ctrl["grads"], base["grads"])[0]
    del base, got, ctrl
    res["train_tp"], res["train_seqpar"] = train(None), train(TPJ_SEQPAR)
    # (b) FSDP_ONLY_RULES against world 1's gradients cut to this rank's
    # shards, then its control
    fsdp, res["launches_fsdp"] = counted(
        lambda: step_zero(cfg, fresh(), batches[0], mesh, FSDP_ONLY_RULES, gather=False))
    mine = [shard_tree(t, pp, mesh) for t, pp in zip(want["grads"], fsdp["parts"])]
    del want
    res["ce_fsdp"] = fsdp["ce"]
    res["fsdp_grads"], res["fsdp_bitwise"] = _shard_rel(mesh, fsdp["grads"], mine)
    del fsdp
    with summed_over_model():
        ctrl = step_zero(cfg, fresh(), batches[0], mesh, FSDP_ONLY_RULES, gather=False)
    res["fsdp_control"], res["fsdp_control_bitwise"] = _shard_rel(mesh, ctrl["grads"], mine)
    del ctrl, mine
    res["train_fsdp"] = train(FSDP_ONLY_RULES)
    res["peak"] = torch.cuda.max_memory_allocated()
    json.dump(res, open(path, "w"))
    dist.destroy_process_group()


def _tpj_spawn(seed: int, tmp: str):
    """Start (j)'s two ranks: (processes, result paths)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return _spawn_ranks(_TPJ_RANK_CODE, [here, str(seed)], tmp, "tpj")


def _split_bytes(cfg, rules) -> dict:
    """World 1's parameter and f32-moment bytes, and a rank's under
    ``rules`` at mesh (1, 2): each leaf's bytes over the ranks it splits
    over."""
    from repro_torch import tree as T
    from repro_torch.distributed.collectives import leaf_axes
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import _is_spec, param_parts
    from repro_torch.models.lm import init_lm

    mesh = Mesh((1, 2), ("data", "model"))
    shapes = T.leaves(init_lm(cfg, device="meta"))
    with sharding_rules(mesh, rules):
        parts = T.leaves(param_parts(cfg, mesh), _is_spec)
    out = {"param": 0, "moment": 0, "param_rank": 0, "moment_rank": 0}
    for t, pp in zip(shapes, parts):
        n = mesh.group_size(leaf_axes(pp))
        for key, size in (("param", t.element_size()), ("moment", 8)):
            out[key] += t.numel() * size
            out[key + "_rank"] += t.numel() * size // n
    return out


def _md_train_rules(seed: int, tmp: str, started) -> None:
    """(j) per-launch sharding rules in training at two ranks on the card
    over gloo, mesh (1, 2), phi4-mini at full width and TPJ_LAYERS layers,
    int8 + Hadamard, TPJ_BATCH x TPJ_SEQ tokens, f32 moments, TPJ_STEPS
    steps under each rule set. (a) {"seqpar": "model"} over the default
    rules against the same ranks without it: the step-0 loss bitwise; the
    gathered step-0 gradients within TPJ_SEQPAR_LIMIT (the witness inside,
    the control outside); each rank's bytes saved at the blocks' inputs
    half theirs; its K1 / K2 / K4 launches world 1's. (b) FSDP_ONLY_RULES
    against world 1: the step-0 loss and gathered gradients bitwise (the
    control, a backward that sums over 'model' too, not); each rank's
    parameter and moment bytes world 1's over the ranks each leaf splits
    over (half, but for the replicated norms); its launches world 1's. The
    steps' losses within MD_LOSS_LIMIT of world 1's (and (a)'s of the
    ranks' without 'seqpar'). Each rank's peak is printed."""
    from repro_torch.launch.dryrun import FSDP_ONLY_RULES

    procs, paths = started
    print(f"-- multidevice (j): training under per-launch rules, two ranks on the card over "
          f"gloo, mesh (1, 2), phi4-mini at full width, {TPJ_LAYERS} layers")
    ranks = _join_ranks(procs, paths, "multidevice (j)", timeout=900)
    lead = dict(ranks[0], witness=ranks[1]["witness"])
    cfg = _tpj_config()
    w1 = lead["train_w1"]
    print(f"world 1 (rank 0): step-0 ce {lead['ce_w1']!r}, saved at the blocks' inputs "
          f"{lead['saved_w1']} bytes, launches {lead['launches_w1']}; steps: losses "
          f"{w1['losses']}, ms {[round(x, 1) for x in w1['ms']]}, launches "
          f"{w1['launches']}, parameter bytes {w1['param_bytes']}, moment bytes "
          f"{w1['moment_bytes']}")
    print(f"(a) seqpar: gradients from the ranks' without it {lead['seqpar_grads']:.6g}, the "
          f"witness {lead['witness']:.6g}, the control {lead['seqpar_control']:.6g} (limit "
          f"{TPJ_SEQPAR_LIMIT})")
    if lead["seqpar_grads"] > TPJ_SEQPAR_LIMIT or lead["witness"] > TPJ_SEQPAR_LIMIT:
        fail("multidevice (j): the seqpar gradients (or the witness) are over the limit")
    if lead["seqpar_control"] <= TPJ_SEQPAR_LIMIT:
        fail("multidevice (j): the seqpar control was not rejected")
    print(f"(b) FSDP_ONLY: gradients bitwise world 1's {lead['fsdp_bitwise']} (relative "
          f"{lead['fsdp_grads']:.6g}); the control bitwise {lead['fsdp_control_bitwise']} "
          f"(relative {lead['fsdp_control']:.6g})")
    if not lead["fsdp_bitwise"] or lead["fsdp_control_bitwise"]:
        fail("multidevice (j): FSDP_ONLY's gradients are not world 1's, or the control "
             "was not rejected")
    want = _split_bytes(cfg, FSDP_ONLY_RULES)
    if (w1["param_bytes"], w1["moment_bytes"]) != (want["param"], want["moment"]):
        fail("multidevice (j): world 1's parameter / moment bytes are not the model's")
    for r, res in enumerate(ranks):
        tp, sp, fs = res["train_tp"], res["train_seqpar"], res["train_fsdp"]
        print(f"rank {r}: step-0 ce tp {res['ce_tp']!r} seqpar {res['ce_seqpar']!r} fsdp "
              f"{res['ce_fsdp']!r}; saved at the blocks' inputs tp {res['saved_tp']} seqpar "
              f"{res['saved_seqpar']} ({res['blocks_seqpar']} blocks); launches tp "
              f"{res['launches_tp']} seqpar {res['launches_seqpar']} fsdp "
              f"{res['launches_fsdp']}; peak {res['peak'] / 1e9:.2f} GB")
        for name, run in (("tp", tp), ("seqpar", sp), ("fsdp", fs)):
            print(f"rank {r} {name} steps: losses {run['losses']}, ms "
                  f"{[round(x, 1) for x in run['ms']]}, launches {run['launches']}, "
                  f"parameter bytes {run['param_bytes']}, moment bytes {run['moment_bytes']}")
        if res["ce_seqpar"] != res["ce_tp"]:
            fail(f"multidevice (j): rank {r}'s seqpar step-0 loss is not the ranks' without it")
        if 2 * res["saved_seqpar"] != res["saved_tp"] or res["blocks_seqpar"] != TPJ_LAYERS:
            fail(f"multidevice (j): rank {r}'s seqpar block inputs are not half")
        if res["ce_fsdp"] != lead["ce_w1"]:
            fail(f"multidevice (j): rank {r}'s FSDP_ONLY step-0 loss is not world 1's")
        if (fs["param_bytes"], fs["moment_bytes"]) != (want["param_rank"],
                                                        want["moment_rank"]):
            fail(f"multidevice (j): rank {r}'s FSDP_ONLY parameter / moment bytes are not "
                 f"world 1's over the ranks ({want['param_rank']} / {want['moment_rank']})")
        for name in ("seqpar", "fsdp"):
            if res[f"launches_{name}"] != lead["launches_w1"] or any(
                    n != w1["launches"][0] for n in res[f"train_{name}"]["launches"]):
                fail(f"multidevice (j): rank {r}'s {name} launches are not world 1's")
        gaps = {"seqpar": max(abs(a - b) for a, b in zip(sp["losses"], tp["losses"])),
                "fsdp": max(abs(a - b) for a, b in zip(fs["losses"], w1["losses"]))}
        print(f"rank {r}: losses' largest gap, seqpar from tp {gaps['seqpar']:g}, FSDP_ONLY "
              f"from world 1 {gaps['fsdp']:g} (limit {MD_LOSS_LIMIT})")
        if max(gaps.values()) > MD_LOSS_LIMIT:
            fail(f"multidevice (j): rank {r}'s losses part from world 1's")
    print(f"(j) FSDP_ONLY bytes a rank: parameters {want['param_rank']} of world 1's "
          f"{want['param']} ({want['param_rank'] / want['param']:.6f}), moments "
          f"{want['moment_rank']} of {want['moment']} "
          f"({want['moment_rank'] / want['moment']:.6f})")


@contextlib.contextmanager
def _abft_env(on: bool):
    """``REPRO_ABFT=1`` within the block where ``on``: the engine reads it
    when it is built, the layers at every pass."""
    from repro_torch.verify.abft import ABFT_ENV

    prev = os.environ.pop(ABFT_ENV, None)
    if on:
        os.environ[ABFT_ENV] = "1"
    try:
        yield
    finally:
        os.environ.pop(ABFT_ENV, None)
        if prev is not None:
            os.environ[ABFT_ENV] = prev


def _stream_parting(cfg, params, prompts, got, want):
    """The requests whose tokens part from world 1's: (rid, first index
    that differs, world 1's top-1 / top-2 margin there, one prefill of the
    prompt and world 1's tokens before it). ``got`` / ``want``: sorted
    [rid, status, reason, tokens] completions; ``prompts``: rid -> prompt
    tokens. A parting above MD_MARGIN fails the hold that reads it."""
    wanted = {c[0]: c for c in want}
    parted = []
    for rid, _, _, toks in got:
        ref = wanted[rid][3]
        if toks == ref:
            continue
        j = next(i for i in range(min(len(toks), len(ref)) + 1)
                 if i >= min(len(toks), len(ref)) or toks[i] != ref[i])
        parted.append((rid, j, _teacher_margin(cfg, params, prompts[rid], ref[:j])))
    return parted


def _nbytes(tree) -> int:
    """Bytes of a parameter tree's tensors (a QTensor's values and scales)."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if hasattr(tree, "q"):
        return sum(t.numel() * t.element_size() for t in (tree.q, tree.scale) if t is not None)
    return tree.numel() * tree.element_size()


def _margin_parting(got, want):
    """(step, row) where the greedy tokens differ although world 1's top-1
    / top-2 margin exceeds twice the row's largest logit gap."""
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        top2 = w.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        gap = (g - w).abs().amax(-1)
        for r in torch.nonzero((g.argmax(-1) != w.argmax(-1)) & (margin > 2 * gap)):
            bad.append((i, int(r)))
    return bad


def multidevice_phase(args, gen) -> dict:
    """The multi-device layer on the one card: (a) the sharded quant_dot's
    shard-local kernels at the full-width mesh layouts' shard shapes, (b)
    the distributed path at world 1 over NCCL, (c) two ranks on the card
    over gloo. Returns (the launches of (b)'s distributed runs, (b)'s
    world-1 training losses)."""
    import tempfile

    t0 = time.perf_counter()
    _md_shards(gen, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        launches, kept = _md_world_one(args.seed, tmp)
        t2 = time.perf_counter()
        _md_two_ranks(args.seed, tmp, kept)
    print(f"(a) took {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) {time.perf_counter() - t2:.1f} s")
    return launches, kept["train"]


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


class _BuildBeside(threading.Thread):
    """``kernels.build.build`` of ``targets`` on a thread, ``width`` nvcc
    at a time, once started, while the phases run; ``join()``, then
    ``error`` (None) and ``spent`` (its wall seconds). ``LIVE``: the
    builds started, which ``phase`` reads."""

    LIVE = []

    def __init__(self, targets, width: int = 4):
        super().__init__(daemon=True)
        self.targets, self.width, self.error, self.spent = list(targets), width, None, 0.0

    def start(self):
        _BuildBeside.LIVE.append(self)
        super().start()

    def run(self):
        from repro_torch.kernels import build

        t0 = time.perf_counter()
        try:
            for i in range(0, len(self.targets), self.width):
                build.build(self.targets[i:i + self.width])
        except Exception as e:   # noqa: BLE001 -- raised on the main thread at join
            self.error = e
        self.spent = time.perf_counter() - t0


# ------------------------------------------------------------- the dry run
DRYRUN_JOBS = 2            # cells planned at once, beside nvcc and the phases
DRYRUN_NICE = 19           # nvcc and the phases take the host's cores first
WORLD_ONE_ARCH = "phi4-mini-3.8b"
WORLD_ONE = {}             # the training phase's readings of WORLD_ONE_ARCH


def _held():
    """(bytes the live tensors asked for, bytes their blocks hold) on the
    card: the allocator's ``requested_bytes`` and ``memory_allocated``."""
    return (torch.cuda.memory_stats().get("requested_bytes.all.current", 0),
            torch.cuda.memory_allocated())


def _dryrun_env() -> dict:
    root = os.path.dirname(os.path.abspath(__file__))
    # the planning runs on the meta device: no CUDA context on the card
    return dict(os.environ, PYTHONPATH=os.path.join(root, "src"), CUDA_VISIBLE_DEVICES="")


def dryrun_start(tmp: str, nice: int = DRYRUN_NICE) -> dict:
    """Start, beside the build and the phases, the whole dry run
    (``python -m repro_torch.launch.dryrun --all --mesh both``: every cell
    of the reference's ten architectures on both production meshes, planned
    on the host's CPU) and the world-1 plan of the training phase's
    WORLD_ONE_ARCH cell (``world_one_plan``), each a process group of its
    own at niceness ``nice`` (its workers inherit it), their output in
    ``tmp``. The groups stay in this session: a session of their own would
    be a scheduler autogroup of its own, where a niceness weighs only
    against the group's own processes."""
    root = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    for name, argv in (
            ("cells", ["-m", "repro_torch.launch.dryrun", "--all", "--mesh", "both",
                       "--jobs", str(DRYRUN_JOBS), "--out", os.path.join(tmp, "cells")]),
            ("world_one", ["-c", "import chip_smoke, sys; "
                                 "chip_smoke.world_one_plan(sys.argv[1])",
                           os.path.join(tmp, "world_one.json")])):
        log = open(os.path.join(tmp, f"{name}.log"), "w")
        runs[name] = (subprocess.Popen([sys.executable] + argv, cwd=root, env=_dryrun_env(),
                                       stdout=log, stderr=subprocess.STDOUT,
                                       process_group=0), log)
        os.setpriority(os.PRIO_PROCESS, runs[name][0].pid, nice)
    runs["t0"], runs["tmp"] = time.perf_counter(), tmp
    return runs


def dryrun_pause(runs: dict, stop: bool) -> None:
    """Stop (SIGSTOP) or continue (SIGCONT) the dry run's process groups,
    so the kernels are timed with the host's cores idle; the seconds it was
    stopped are kept in ``runs["paused"]``."""
    import signal

    for name in ("cells", "world_one"):
        proc, _ = runs[name]
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGSTOP if stop else signal.SIGCONT)
    if stop:
        runs["stopped_at"] = time.perf_counter()
    else:
        runs["paused"] = time.perf_counter() - runs.pop("stopped_at")


def dryrun_stop(runs: dict) -> None:
    """End the dry run's process groups (a failed script leaves none)."""
    import signal

    for name in ("cells", "world_one"):
        proc, log = runs[name]
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)   # a stopped group dies too
            proc.wait()
        log.close()


def dryrun_join(runs: dict) -> None:
    """Wait for the whole dry run, print its cells line and its seconds;
    fail when it exits non-zero (an error in any cell)."""
    proc, log = runs["cells"]
    rc = proc.wait()
    spent = time.perf_counter() - runs["t0"]
    log.close()
    with open(os.path.join(runs["tmp"], "cells.log")) as f:
        lines = f.read().splitlines()
    cells = [ln for ln in lines if ln.startswith(("dry-run cells:", "dry-run seconds:"))]
    print(f"dryrun: {'; '.join(cells) or 'no cells line'}; joined {spent:.1f} s after its "
          f"start, beside the build and the phases ({DRYRUN_JOBS} cells at once), stopped "
          f"{runs.get('paused', 0.0):.1f} s of it while the kernels were timed", flush=True)
    PHASES.append(("dryrun (beside)", spent))
    if rc != 0:
        print("\n".join(ln for ln in lines if "ERROR" in ln or "Error" in ln)[-4000:])
        fail(f"the dry run exited {rc}")


def world_one_plan(path: str) -> None:
    """The dry run's plan (``launch.dryrun.plan``, no mesh) of the training
    phase's WORLD_ONE_ARCH cell -- its config with the plain versions
    (``backend="torch"``: the meta device runs no kernel), its batch x seq,
    microbatches and f32 moments -- written to ``path`` as JSON."""
    import dataclasses

    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.optim import OptConfig

    spec = TRAIN_FAMILIES[WORLD_ONE_ARCH]
    cfg = _family_cfg(WORLD_ONE_ARCH, spec["units"], backend="torch")
    B, S, mb = train_traffic(cfg)
    shape = ShapeSpec("train", "train", S, B)
    steps = spec.get("steps", TRAIN_STEPS)
    opt_cfg = OptConfig(lr=1e-4, warmup_steps=1, total_steps=steps)
    got = dryrun.plan(cfg, shape, opt_cfg, microbatches=mb)
    got["roofline"] = dryrun.roofline_terms(got["cost_analysis"], 1)
    got["cfg"] = {"layers": cfg.num_layers, "batch": B, "seq": S, "microbatches": mb,
                  "quant": dataclasses.asdict(cfg.quant)}
    with open(path, "w") as f:
        json.dump(got, f)


def dryrun_world_one(runs: dict, smi: str) -> None:
    """The dry run against the card at world 1 (the training phase's
    readings of WORLD_ONE_ARCH, no extra draws): its argument bytes must
    equal the bytes the parameters, the f32 moments and one batch asked the
    allocator for (``requested_bytes`` deltas) exactly. Their blocks
    (``memory_allocated`` deltas) are printed beside them, with no limit:
    what the caching allocator adds (512-byte rounding, a segment's tail
    under 1 MiB left in a block) is its own, not the plan's. Its peak and
    ``roofline.bound_s`` are printed beside the measured peak and step
    time, with their ratios (no limit)."""
    proc, log = runs["world_one"]
    rc = proc.wait()
    log.close()
    if rc != 0:
        with open(os.path.join(runs["tmp"], "world_one.log")) as f:
            print(f.read()[-4000:])
        fail(f"the world-1 plan exited {rc}")
    with open(os.path.join(runs["tmp"], "world_one.json")) as f:
        plan = json.load(f)
    got = WORLD_ONE[WORLD_ONE_ARCH]
    mem, rt = plan["memory"], plan["roofline"]
    asked, held = (got["params"][i] + got["moments"][i] + got["batch"][i] for i in (0, 1))
    want, n = mem["argument_bytes"], plan["argument_tensors"]
    peak = mem["argument_bytes"] + mem["temp_bytes"]
    print(f"dryrun world 1 ({WORLD_ONE_ARCH}, {plan['cfg']}; {smi}): argument bytes "
          f"{want} planned; asked on the card {asked:.0f} (parameters {got['params'][0]}, "
          f"moments {got['moments'][0]}, one batch {got['batch'][0]:.0f}), difference "
          f"{asked - want:.0f} (limit 0); held in blocks {held:.0f}, {held - want:.0f} over "
          f"on {n} tensors (no limit); peak planned "
          f"{peak / 1e9:.3f} GB, measured {got['peak'] / 1e9:.3f} GB (ratio "
          f"{got['peak'] / peak:.3f}); step bound {rt['bound_s'] * 1e3:.2f} ms "
          f"({rt['dominant']}: compute {rt['compute_s'] * 1e3:.2f}, memory "
          f"{rt['memory_s'] * 1e3:.2f} ms), measured {got['step_s'] * 1e3:.1f} ms (ratio "
          f"{got['step_s'] / rt['bound_s']:.2f})", flush=True)
    if asked != want:
        fail(f"world-1 argument bytes: {asked} asked on the card, {want} planned")


def build_ab(smi: str) -> int:
    """``--build-ab``: the script's build (every source and the mutants, as
    ``main`` starts it) timed from nothing five times on one host: alone,
    beside the whole dry run as ``main`` starts it (at DRYRUN_NICE), beside
    it at niceness 0, beside it at DRYRUN_NICE again, alone again. One line
    a build; runs no kernel."""
    import tempfile

    from repro_torch.kernels import build

    targets = ([build.Target(f"{stem}.cu") for stem in build.sources()]
               + [build.mutant(m) for m in build.MUTANTS])
    try:
        with open("/proc/sys/kernel/sched_autogroup_enabled") as f:
            autogroup = f.read().strip()
    except OSError:
        autogroup = "unreadable"
    print(f"build-ab: {len(targets)} nvcc at once, {len(os.sched_getaffinity(0))} cores, "
          f"sched_autogroup_enabled {autogroup}")
    for label, nice in (("alone", None), ("beside", DRYRUN_NICE), ("beside", 0),
                        ("beside", DRYRUN_NICE), ("alone", None)):
        for t in targets:
            if t.path().exists():
                t.path().unlink()
        with tempfile.TemporaryDirectory() as tmp:
            runs = None if nice is None else dryrun_start(tmp, nice)
            try:
                t0 = time.perf_counter()
                spent = build.build(targets)
                wall = time.perf_counter() - t0
            finally:
                if runs is not None:
                    dryrun_stop(runs)
        label += "" if nice is None else f" (nice {nice})"
        print(f"build-ab {label} ({smi}): {wall:.1f} s "
              + " ".join(f"{k}={v:.1f}s" for k, v in spent.items()), flush=True)
    return 0


def phase(name: str, fn, *args):
    """``fn(*args)``, then a line ``phase <name> <s> s``: its wall seconds,
    the card synchronized; ``(beside nvcc)`` after it when the linter's
    builds ran during the phase, so its host-clock readings (tok/s, step
    ms) were taken with nvcc on the host's cores."""
    beside = any(b.is_alive() for b in _BuildBeside.LIVE)
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    beside = beside or any(b.is_alive() for b in _BuildBeside.LIVE)
    spent = time.perf_counter() - t0
    PHASES.append((name, spent))
    print(f"phase {name} {spent:.1f} s" + (" (beside nvcc)" if beside else ""), flush=True)
    return out


PHASES = []   # (name, wall s) of every phase line, in order


def main() -> int:
    start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--build-ab", action="store_true",
                    help="time the build alone and beside the dry run (build_ab), then exit")
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
    if args.build_ab:
        return build_ab(smi)

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        # the dry run plans on the host's CPU beside everything that follows
        runs = dryrun_start(tmp)
        try:
            t0 = time.perf_counter()
            # the six sources and the mutants (hold_mutants runs early) all at
            # once; the linter's counting and PTX builds beside the phases after
            # the kernels' timings (``_phases``)
            mutants = [build.mutant(m) for m in build.MUTANTS]
            spent = build.build([build.Target(f"{stem}.cu") for stem in build.sources()]
                                + mutants)
            print(f"kernel build: {time.perf_counter() - t0:.1f} s "
                  + " ".join(f"{k}={v:.1f}s" for k, v in spent.items()))
            PHASES.append(("build", time.perf_counter() - t0))
            print(f"phase build {PHASES[-1][1]:.1f} s", flush=True)
            later = _BuildBeside([t for t in build.LINT_TARGETS
                                  if t.name not in {m.name for m in mutants}])
            try:
                return _phases(args, start, later, runs, smi)
            finally:
                if later.ident is not None:
                    later.join()    # no nvcc outlives the script, whatever failed
        finally:
            dryrun_stop(runs)


def _phases(args, start: float, later, runs: dict, smi: str) -> int:
    """Every phase after the build, then the kernels' line and the result
    line. The dry run (``runs``) is stopped while the kernels are timed and
    the linter's builds (``later``) start once they are: the device ms in
    the kernels' line are taken with the host idle. The dry run is joined
    before the phases' line."""
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    dryrun_pause(runs, stop=True)
    timed = phase("kernel", kernel_phase, gen)
    phase("hold_k3_k4", hold_k3_k4, gen)
    phase("hold_mixed_rounds", hold_mixed_rounds, args.seed)
    timed.update(phase("time_k3_k4", time_k3_k4, gen))
    phase("hold_k5_k6", hold_k5_k6, gen)
    timed.update(phase("time_k5_k6", time_k5_k6, gen))
    phase("hold_k8", hold_k8, gen)
    timed.update(phase("time_revisit", time_revisit, gen))
    phase("hold_abft_kernels", hold_abft_kernels, gen)
    timed.update(phase("time_abft", time_abft, gen))
    timed.update(phase("hold_mutants", hold_mutants, args.seed))
    dryrun_pause(runs, stop=False)
    later.start()
    entry = phase("entry_point", entry_point_phase, gen)
    launches = {}
    serving_sites = []
    for arch in MODELS:
        _, got = phase(f"model:{arch}", model_phase, args, arch, serving_sites)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        # (j)'s ranks run beside the window, the launcher and the launcher
        # families (at most ~20 GB of the card's 80 beside the ranks' ~40)
        rules_trained = _tpj_spawn(args.seed, tmp)
        for name, fn in (("window", window_phase), ("launcher", launcher_phase)):
            for k, v in phase(name, fn, args).items():
                launches[k] += v
        for arch in LAUNCHER_MODELS:
            for k, v in phase(f"launcher_model:{arch}", launcher_model_phase, args,
                              arch).items():
                launches[k] += v
        phase("multidevice:j", _md_train_rules, args.seed, tmp, rules_trained)
    for arch in TRAIN_FAMILIES:
        for k, v in phase(f"train:{arch}", train_phase, args, arch).items():
            launches[k] += v
        torch.cuda.empty_cache()
        if arch == WORLD_ONE_ARCH:
            phase("dryrun:world1", dryrun_world_one, runs, smi)
    phase("train:experts", train_experts_phase, args)
    launches["K3"] = entry["K3"]    # K3's path is the entry point
    later.join()
    if later.error is not None:
        raise later.error
    print(f"linter's builds beside the phases: {later.spent:.1f} s", flush=True)
    launches.update(phase("lint", lint_phase, serving_sites))   # M1's and M2's path
    del serving_sites
    phase("rotation", rotation_phase, args)
    got, train_want = phase("multidevice", multidevice_phase, args, gen)
    for k, v in got.items():
        launches[k] += v
    with tempfile.TemporaryDirectory() as tmp:
        # (e)'s ranks run beside (d)
        started = _md_engine_spawn(args.seed, tmp)
        for k, v in phase("multidevice:d", _md_loop_world_one, args.seed).items():
            launches[k] += v
        phase("multidevice:e", _md_engine_two_ranks, args.seed, started)
        # (g)'s ranks run beside (f); (h)'s and (i)'s beside (g); (i)'s phi4
        # ends before (h)'s maverick draws begin, and (i)'s maverick waits
        # for (h)'s end
        tp_started = _tp_spawn(args.seed, tmp)
        for k, v in phase("multidevice:f", _md_families, args.seed, tmp).items():
            launches[k] += v
        started = _tph_spawn(args.seed, tmp)
        rules_started = _tpi_spawn(args.seed, tmp)
        phase("multidevice:g", _md_tensor_parallel, args.seed, tmp, train_want, tp_started)
        _tpi_wait(rules_started, "phi4-mini-3.8b")
        phase("multidevice:h", _md_moe_recurrent, args.seed, tmp, started)
        phase("multidevice:i", _md_rules, args.seed, tmp, rules_started)

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
    kernels = [{"name": meta[k]["name"], "route": "cuda",
                "source": meta[k]["source"], "replaces": meta[k]["replaces"],
                "launches": launches[k], **timed[k]} for k in meta]
    dryrun_join(runs)
    print(f"phase total {time.perf_counter() - start:.1f} s")
    print("phases: " + ", ".join(f"{name} {s:.1f}" for name, s in PHASES))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
