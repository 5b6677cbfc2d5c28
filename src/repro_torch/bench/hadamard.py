"""Timing harness of the HadaCore transform kernels on one CUDA card: K1 on
the tensor cores (``hadacore_cuda``) beside the CUDA-core FWHT
(``fwht_cuda``, the in-repo stand-in for the FWHT the paper compares
against), ``torch.matmul(x, H_n)`` and the plain version; and K2
(``fused_dequant_cuda``) at the serving path's attention shapes.

    PYTHONPATH=src python -m repro_torch.bench.hadamard [--json PATH]

Prints the card's name and power limit (nvidia-smi), then one JSON record
per case: ``benchmarks/run.py``'s fields (``bench, shape, dtype, backend,
ms, gbps``) plus ``kernel``, ``site``, ``mode`` (K2's quantization),
``device_ms`` (``torch.profiler``, the kernel's own instantiations),
``baseline_ms`` / ``baseline_device_ms`` (the FWHT on the same rows; K1
only) and ``speedup`` (baseline over kernel, device time), ``library`` /
``library_ms`` / ``library_device_ms`` (``torch.matmul`` with the bf16 /
fp16 Hadamard matrix, n <= 8192; none for K2), ``plain_ms``, ``bound_ms`` /
``bound_by`` (one read and one write of every element over the HBM rate,
or the transform's log2(n) adds per element over the f32 CUDA-core rate,
the larger), ``max_abs_err`` and ``ulps`` (K1 and the FWHT against the
plain version, in compute-dtype ulps at the row max; K2: the largest
|kernel - plain|) and ``per_step`` (calls per training step for the
``train`` and ``backward`` cases). ``ms`` is CUDA events over many calls, the host's
launch path included; ``gbps`` the bytes the bound counts over the device
time. ``--json`` also writes the records to PATH. Without a CUDA device it
exits at once (code 2) and prints nothing on stdout.

The cases (``CASES``, from the models' configs and the traffic constants
below), in three groups:

  * ``sweep``: n = 2^7 .. 2^15, bf16 and fp16, rows giving 64 MB of input
    (the paper's sweep);
  * ``path``: K1 at llama3-8b's down projection, 7 groups of 2048 at decode
    (4 slots: 28 rows) and prefill (64 tokens: 448 rows); K2 fp8_e4m3 at
    its Q and K sites (32 and 8 heads of 128) at decode and prefill; K1 at
    the grouped down projections of qwen1.5-4b (27 x 256), llama3-405b (13
    x 4096) and starcoder2-15b (3 x 8192) and at mixtral-8x7b's expert site
    (7 x 2048 over the dispatched rows: every expert's capacity slots), at
    decode and prefill; the one-shot launcher's cells: qwen2-vl-7b (K1 at
    37 x 512; K2 fp8_e4m3 at its Q and K sites, 28 and 4 heads of 128) at
    decode and at a prefill of 4 x (1024 patches + VLM_TEXT tokens), and
    whisper-base (K2 int8 at n = 64, 8 heads) at decode, at its decoder's
    prefill of 4 x ENCDEC_PROMPT tokens (Q, K and the cross K over 4 x 1500
    frames) and at its encoder's Q and K; the recurrent-state cells
    (RECURRENT_PROMPT tokens a request): K1 at the channel-mix / MLP down
    projection of rwkv6-7b and zamba2-7b (7 x 2048) at decode and prefill,
    and at zamba2-7b's Q / K sites, head_dim 112 = I_7 (x) H_16 (32 heads x
    7 groups of 16 points per token);
  * ``train``: the phi4-mini training step's K1 calls (4 x 512 tokens): the
    straight-through backward of the down projection (2 per layer, 8192
    points) and of the Q / K fake-quantized rotations (24 and 8 heads of
    128), 32 layers;
  * ``backward``: K1 in the training backward of the other families the
    card trains (qwen1.5-4b, starcoder2-15b, mixtral-8x7b, whisper-base,
    qwen2-vl-7b, rwkv6-7b, zamba2-7b), one microbatch of ``train_traffic``
    each: the down projection's (2 per layer that has one; mixtral over the
    experts' dispatched rows) and the Q site's (1 per attention layer; the
    grouped I_7 (x) H_16 at zamba2's head_dim 112), whisper-base's encoder
    rows apart; ``per_step`` at the published depth.

Then, for each K2 case, where its blocks spend their time (``phases``:
the SM clock at each phase's end, from fused_quant.cu's phase-stamping
build). ``chip_smoke.py``'s kernel phase calls ``measure`` for the path
and backward shapes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
from typing import Optional

import torch

from repro_torch.bench.quant_dot import (INT8_OPS_PER_S, bound, card, cuda_time_ms,
                                         device_ms, profile_ms)

EPS = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10, torch.float32: 2.0 ** -23}
SWEEP_BYTES = 64 << 20
# The traffic of the path and train cases, which chip_smoke.py's serving run
# and training phase drive (and import from here): a decode step is one
# token on each of SLOTS slots, a prefill PREFILL_LEN tokens; a training
# step TRAIN_BATCH x TRAIN_SEQ tokens.
SLOTS, PREFILL_LEN = 4, 64
TRAIN_BATCH, TRAIN_SEQ = 4, 512
# The one-shot launcher's cells (SLOTS requests each): qwen2-vl-7b's prompts
# are its vlm_patches patch embeddings and VLM_TEXT tokens; whisper-base's
# ENCDEC_PROMPT tokens beside its encoder_seq frames.
VLM_TEXT, ENCDEC_PROMPT = 64, 16
# The recurrent-state cells (rwkv6-7b, zamba2-7b): prompts of RECURRENT_PROMPT
# tokens, 16 chunks of the RWKV6 time mix and 4 of the Mamba2 SSD.
RECURRENT_PROMPT = 512
# A training step of the other families (chip_smoke.py's training phases):
# TRAIN_BATCH x TRAIN_SEQ tokens; an encoder-decoder's TRAIN_BATCH inputs of
# ENCDEC_TRAIN_SEQ tokens beside its encoder_seq frames; a vlm's
# VLM_TRAIN_BATCH inputs of vlm_patches + VLM_TEXT positions in
# VLM_MICROBATCHES microbatches.
ENCDEC_TRAIN_SEQ = 64
VLM_TRAIN_BATCH = VLM_MICROBATCHES = 2


def train_traffic(cfg) -> tuple:
    """(batch, seq, microbatches) of one training step of ``cfg``."""
    if cfg.family == "vlm":
        return VLM_TRAIN_BATCH, cfg.vlm_patches + VLM_TEXT, VLM_MICROBATCHES
    if cfg.is_encdec:
        return TRAIN_BATCH, ENCDEC_TRAIN_SEQ, 1
    return TRAIN_BATCH, TRAIN_SEQ, 1


@dataclasses.dataclass(frozen=True)
class Case:
    """``kernel`` ("K1" or "K2") on ``rows`` rows of ``n`` in ``dtype``
    (K2: quantization ``mode``); ``site`` names the path or group;
    ``per_step``: calls per training step (train cases)."""

    kernel: str
    site: str
    rows: int
    n: int
    dtype: str = "bfloat16"
    mode: Optional[str] = None
    per_step: int = 0

    @property
    def group(self) -> str:
        return self.site.split(" ", 1)[0] \
            if self.site.startswith(("sweep", "train", "backward")) \
            else "path"


def _groups(cfg, n=None) -> tuple:
    """The plan of a rotation of ``n`` points (the down projection's d_ff
    when not given): (groups per row, p)."""
    from repro_torch.core.api import plan_for

    n = n or cfg.d_ff
    plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cuda")
    return n // plan.p, plan.p


def _dispatched(cfg, batch: int, seq: int) -> int:
    """Rows at the expert site: batch x experts x capacity slots."""
    E, K = cfg.num_experts, cfg.experts_per_token
    return batch * E * max(1, int(cfg.capacity_factor * seq * K / E))


def backward_cases(cfg) -> list:
    """K1's calls in the backward of one microbatch of a training step of
    ``cfg`` at ``train_traffic``: the down projection's (gx and the rotated
    x for gw: 2 per layer that has one, over the experts' dispatched rows
    for a MoE layer), the Q site's straight-through rotation (1 per
    attention layer) and an encoder's rows apart; ``per_step`` at the
    config's depth, every microbatch counted."""
    batch, seq, mb = train_traffic(cfg)
    b = batch // mb
    g, p = _groups(cfg)
    hg, hp = _groups(cfg, cfg.head_dim)
    downs = sum(k != "mamba" for k in cfg.layer_kinds)
    attn = sum(k not in ("rwkv", "mamba") for k in cfg.layer_kinds)
    rows = _dispatched(cfg, b, seq) if cfg.num_experts else b * seq
    out = [Case("K1", f"backward {cfg.name} down-proj", rows * g, p, per_step=2 * mb * downs)]
    if attn:
        out.append(Case("K1", f"backward {cfg.name} Q", b * seq * cfg.num_heads * hg, hp,
                        per_step=mb * attn))
    if cfg.is_encdec:
        frames, enc = b * cfg.encoder_seq, len(cfg.encoder_layer_kinds)
        out += [Case("K1", f"backward {cfg.name} encoder down-proj", frames * g, p,
                     per_step=2 * enc),
                Case("K1", f"backward {cfg.name} encoder Q", frames * cfg.num_heads * hg, hp,
                     per_step=enc)]
    return out


def _cases() -> tuple:
    """The cases from the models' configs: llama3-8b's down projection (its
    d_ff in the plan's groups) and Q / K sites (heads x head_dim) served,
    phi4-mini-3.8b's straight-through backward (2 K1 calls per layer at
    d_ff, one at each of the Q and K sites) and the other families'."""
    from repro_torch.configs import get_config
    from repro_torch.core.api import plan_for

    groups, dispatched = _groups, _dispatched

    def qk(name, cfg, phase, tokens, mode, sites=("Q", "K")):
        heads = {"Q": cfg.num_heads, "K": cfg.num_kv_heads, "cross K": cfg.num_kv_heads}
        return [Case("K2", f"{name} {phase} {site}", tokens * heads[site], cfg.head_dim,
                     mode=mode) for site in sites]

    llama, phi4 = get_config("llama3-8b"), get_config("phi4-mini-3.8b")
    qwen2vl, whisper = get_config("qwen2-vl-7b"), get_config("whisper-base")
    vg, vp = groups(qwen2vl)
    vlm_prefill = SLOTS * (qwen2vl.vlm_patches + VLM_TEXT)
    frames = SLOTS * whisper.encoder_seq
    g, p = groups(llama)
    serve = (("decode", SLOTS), ("prefill", PREFILL_LEN))
    train = TRAIN_BATCH * TRAIN_SEQ
    mixtral = get_config("mixtral-8x7b")
    mg, mp = groups(mixtral)
    rwkv, zamba = get_config("rwkv6-7b"), get_config("zamba2-7b")
    assert rwkv.d_ff == zamba.d_ff
    rg, rp = groups(rwkv)
    zp = plan_for(zamba.head_dim, dtype=torch.bfloat16, backend="cuda", device_type="cuda").p
    zg = zamba.head_dim // zp
    recurrent = (("decode", SLOTS), ("prefill", SLOTS * RECURRENT_PROMPT))
    return tuple(
        [Case("K1", "sweep", SWEEP_BYTES // (2 << k), 1 << k, dt)
         for k in range(7, 16) for dt in ("bfloat16", "float16")]
        + [Case("K1", f"llama3 {phase} down-proj", tokens * g, p)
           for phase, tokens in serve]
        + [Case("K2", f"llama3 {phase} {site}", tokens * heads, llama.head_dim,
                mode="fp8_e4m3")
           for phase, tokens in serve
           for site, heads in (("Q", llama.num_heads), ("K", llama.num_kv_heads))]
        + [Case("K1", f"{name} {phase} down-proj", tokens * groups(cfg)[0], groups(cfg)[1])
           for name, cfg in ((n, get_config(n)) for n in
                             ("qwen1.5-4b", "llama3-405b", "starcoder2-15b"))
           for phase, tokens in serve]
        + [Case("K1", f"mixtral-8x7b {phase} experts down-proj",
                dispatched(mixtral, batch, seq) * mg, mp)
           for phase, batch, seq in (("decode", SLOTS, 1), ("prefill", 1, PREFILL_LEN))]
        + [Case("K1", f"qwen2-vl-7b {phase} down-proj", tokens * vg, vp)
           for phase, tokens in (("decode", SLOTS), ("prefill", vlm_prefill))]
        + qk("qwen2-vl-7b", qwen2vl, "decode", SLOTS, "fp8_e4m3")
        + qk("qwen2-vl-7b", qwen2vl, "prefill", vlm_prefill, "fp8_e4m3")
        + qk("whisper-base", whisper, "decode", SLOTS, "int8")
        + qk("whisper-base", whisper, "prefill", SLOTS * ENCDEC_PROMPT, "int8")
        + qk("whisper-base", whisper, "prefill", frames, "int8", ("cross K",))
        + qk("whisper-base", whisper, "encoder", frames, "int8")
        + [Case("K1", f"rwkv6 / zamba2 {phase} down-proj", tokens * rg, rp)
           for phase, tokens in recurrent]
        + [Case("K1", f"zamba2-7b {phase} Q / K", tokens * zamba.num_heads * zg, zp)
           for phase, tokens in recurrent]
        + [Case("K1", "train down-proj backward", train, phi4.d_ff,
                per_step=2 * phi4.num_layers),
           Case("K1", "train Q backward", train * phi4.num_heads, phi4.head_dim,
                per_step=phi4.num_layers),
           Case("K1", "train K backward", train * phi4.num_kv_heads, phi4.head_dim,
                per_step=phi4.num_layers)]
        + [c for name in ("qwen1.5-4b", "starcoder2-15b", "mixtral-8x7b", "whisper-base",
                          "qwen2-vl-7b", "rwkv6-7b", "zamba2-7b")
           for c in backward_cases(get_config(name))])


CASES = _cases()


def ulps(got: torch.Tensor, want: torch.Tensor, cd: torch.dtype) -> float:
    """Largest |got - want| per row, in compute-dtype ulps at the row's
    largest magnitude."""
    g, w = got.float().reshape(-1, got.shape[-1]), want.float().reshape(-1, want.shape[-1])
    unit = EPS[cd] * w.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(((g - w).abs() / unit).max())


def measure(case: Case, gen, x: Optional[torch.Tensor] = None) -> dict:
    """Time one case on the card (events and profile), beside the FWHT
    (K1), the library product (K1, n <= 8192), the plain version and the
    bound. ``x`` (rows, n) is drawn from ``gen`` (N(0, 1)) when not given.
    Returns the record."""
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.core.hadamard import torch_dtype
    from repro_torch.kernels.fused_quant import fused_dequant_cuda, fused_dequant_plain
    from repro_torch.kernels.hadacore import fwht_cuda, hadacore_cuda, transform_plain
    from repro_torch.kernels.ref import hadamard_matrix

    dt = torch_dtype(case.dtype)
    rows, n = case.rows, case.n
    if x is None:
        x = torch.randn(rows, n, generator=gen, device="cuda").to(dt)
    out = torch.empty_like(x)
    epi = QuantEpilogue(case.mode, dequant=True) if case.kernel == "K2" else None
    plan = plan_for(n, dtype=dt, backend="cuda", device_type="cuda", epilogue=epi)
    big = rows * n > (1 << 22)
    iters = 20 if big else 200
    rec = {"bench": "hadamard", "kernel": case.kernel, "site": case.site,
           "shape": f"{rows}x{n}", "dtype": case.dtype, "mode": case.mode,
           "per_step": case.per_step}
    if case.kernel == "K1":
        run = lambda: hadacore_cuda(x, out, plan)            # noqa: E731
        base = lambda: fwht_cuda(x, out, plan)               # noqa: E731
        want = transform_plain(x, plan)
        got = run().clone()
        rec["ulps"] = ulps(got, want, dt)
        rec["baseline_ulps"] = ulps(base(), want, dt)
        rec["max_abs_err"] = float((got.float() - want.float()).abs().max())
        del got, want
        rec["ms"] = cuda_time_ms(run, iters=iters)
        rec["device_ms"] = profile_ms(run, "hadacore_tc_kernel")
        rec["baseline_ms"] = cuda_time_ms(base, iters=iters)
        rec["baseline_device_ms"] = profile_ms(base, "fwht_kernel")
        rec["speedup"] = (rec["baseline_device_ms"] / rec["device_ms"]
                          if rec["device_ms"] and rec["baseline_device_ms"] else None)
        rec["library"] = rec["library_ms"] = rec["library_device_ms"] = None
        if n <= 8192:
            H = torch.from_numpy(hadamard_matrix(n, 1.0 / math.sqrt(n))).to("cuda", dt)
            lib = lambda: torch.matmul(x, H)                 # noqa: E731
            rec["library"] = "torch.matmul(x, H_n)"
            rec["library_ms"] = cuda_time_ms(lib, iters=iters)
            rec["library_device_ms"] = device_ms(lib)
            del H
        plain = lambda: transform_plain(x, plan)             # noqa: E731
        ops = rows * n * math.log2(n)
    else:
        run = lambda: fused_dequant_cuda(x, out, plan)       # noqa: E731
        plain = lambda: fused_dequant_plain(x, plan)         # noqa: E731
        got = run().clone()
        rec["max_abs_err"] = float((got.float() - plain().float()).abs().max())
        del got
        rec["ms"] = cuda_time_ms(run, iters=iters)
        rec["device_ms"] = profile_ms(run, "fused_dequant_tc_kernel")
        rec["ulps"] = rec["baseline_ulps"] = rec["speedup"] = None
        rec["baseline_ms"] = rec["baseline_device_ms"] = None
        rec["library"] = rec["library_ms"] = rec["library_device_ms"] = None
        ops = rows * n * (math.log2(n) + 6)
    rec["plain_ms"] = cuda_time_ms(plain, iters=5 if big else 20, warmup=1)
    nbytes = 2 * rows * n * x.element_size()
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 0, ops, INT8_OPS_PER_S)
    dev = rec["device_ms"]
    rec["gbps"] = nbytes / dev / 1e6 if dev else None
    rec["backend"] = "cuda_tc"
    return rec


def phases(case: Case, gen) -> dict:
    """Where a K2 case's block spends its time: the phase-stamping build's
    SM clock readings (``fused_dequant_phases``), the median over blocks of
    each of ``fused_quant.PHASES`` in cycles and of the whole block, and
    the same in us at the card's largest SM clock, beside the main build's
    device time (the rest is the launch and the blocks' spread). Returns
    the record."""
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.kernels.fused_quant import (PHASES, fused_dequant_cuda,
                                                 fused_dequant_phases)

    x = torch.randn(case.rows, case.n, generator=gen, device="cuda").to(torch.bfloat16)
    plan = plan_for(case.n, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                    epilogue=QuantEpilogue(case.mode, dequant=True))
    for _ in range(10):                                       # warm
        st = fused_dequant_phases(x, plan)
    d = (st[:, 1:] - st[:, :-1]).double().median(0).values
    med = {k: float(v) for k, v in zip(PHASES, d)}
    med["block"] = float((st[:, -1] - st[:, 0]).double().median())
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    out = torch.empty_like(x)
    return {"bench": "hadamard_phases", "kernel": case.kernel, "site": case.site,
            "shape": f"{case.rows}x{case.n}", "mode": case.mode, "blocks": st.shape[0],
            "cycles": med, "us_at_max_clock": {k: v / mhz for k, v in med.items()},
            "sm_clock_max_mhz": mhz,
            "device_ms": profile_ms(lambda: fused_dequant_cuda(x, out, plan),
                                    "fused_dequant_tc_kernel")}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench hadamard: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    build.build([build.Target("hadacore.cu"), build.Target("fused_quant.cu"),
                 build.Target("fused_quant.cu", (build.STAMP_DEFINE,))])
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for case in CASES:
        rec = measure(case, gen)
        records.append(rec)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    for case in CASES:
        if case.kernel == "K2":
            rec = phases(case, gen)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
