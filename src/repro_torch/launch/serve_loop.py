"""Continuous-batching serving launcher of the port: admit and retire
requests mid-decode over pre-quantized weights (twin of
``repro.launch.serve_loop``).

    PYTHONPATH=src python -m repro_torch.launch.serve_loop --arch llama3-8b \
        --scale 1.0 --quant fp8_e4m3 --rotate hadamard
    PYTHONPATH=src python -m repro_torch.launch.serve_loop \
        --arch phi4-mini-3.8b --scale 1.0 --quant int8 --rotate hadamard
    PYTHONPATH=src python -m repro_torch.launch.serve_loop \
        --arch llama4-maverick-400b-a17b --scale 0.005 --quant fp8_e4m3 \
        --rotate hadamard --device cpu

(phi4-mini's power-of-2 d_ff runs the down projection as one fused
rotate -> quantize -> GEMM launch, K4, per layer; llama4-maverick's MoE
layers run their 128 experts' down projections as one K6 launch. At full
scale maverick's 48 layers do not fit one 80 GB card.
``REPRO_QUANT_DOT_SCHEDULE=streamed`` takes the streamed kernels, K5 and
K6s.) Serves a seeded Poisson arrival stream (``--rate`` arrivals per
decode step, 0.5 by default; prompts of ``--prompt-min`` to ``--prompt-max``
tokens, 8 to --prefill-len by default; ``--gen-min`` to ``--gen-max`` new
tokens each, 8 to 32; ``--eos-id`` retires a request at that token) on
the CUDA device (``--device cpu`` runs the plain versions on the CPU)
and prints tokens/s, slot occupancy, p50/p99 per-token latency, the
scheduler counters, the requests by status and the engine's ``health:``
line (ladder rung, retries, watchdog, guard and ABFT trips). A warm-up
step runs before the first request. With ``--quant`` set the weights are
pre-quantized at load; ``--no-prequant`` keeps them bf16, quantized at
every consumer site (counted by ``quantize_weight_calls``), as the
reference serves them. ``REPRO_ABFT=1`` serves checksum-
verified steps (the ABFT twins K7a / K7b of the quant_dot kernels and the
KV conservation check; a healthy run shows zero ``abft_*`` trips and
rung=0), ``REPRO_NUMERIC_GUARDS=1`` the numerically guarded ones;
``--max-queue``, ``--deadline-slack`` and ``--watchdog-ms`` set the
engine's bounded queue, request deadlines and step watchdog. The command
exits non-zero when a decode step failed on every rung of the engine's
degradation ladder. ``--layers N`` keeps the first N layers.

Several ranks: under torchrun, or with ``--mp`` > 1, the launcher starts
the process group (``launch.train``'s docstring; NCCL on a CUDA device,
gloo on the CPU, or ``--dist-backend``; the collectives time out after
``launch.mesh.COLLECTIVE_TIMEOUT_S``) and serves on the (world / mp, mp)
("data", "model") mesh: the engine's weights are this rank's shards, its
slots split over 'data', its layers tensor-parallel over 'model' (``--mp
D``: heads, hidden columns and experts; its KV cache holds KH / D heads a
layer), every
rank prefills, decodes its slots and keeps the same scheduler
(``serving.engine``'s docstring). Every rank builds
the same seeded stream; rank 0 prints. A decode step that raises on one
rank alone ends every rank non-zero. The engine serves the seven 'attn' /
'moe' architectures (whisper, qwen2-vl and the recurrent kinds are
refused, on a mesh or not):

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve_loop --device cpu \
        --mp 1 --arch phi4-mini-3.8b --scale 0.005 --quant int8 \
        --rotate hadamard --requests 4 --slots 2 --max-len 96 --prefill-len 32
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.quant import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (COLLECTIVE_TIMEOUT_S, distributed_requested,
                                    init_distributed, make_local_mesh)
from repro_torch.models.lm import init_lm
from repro_torch.serving import ServeEngine, synthetic_stream


def scaled_config(cfg, scale: float):
    """Shrink a config by ~scale in parameter count, keeping the family
    structure (the reference's ``launch.train.scaled_config``)."""
    if scale >= 1.0:
        return cfg
    f = max(0.05, math.sqrt(scale))
    heads = max(2, int(cfg.num_heads * f))
    ratio = max(1, cfg.num_heads // cfg.num_kv_heads)
    return dataclasses.replace(
        cfg, d_model=max(128, int(cfg.d_model * f) // 128 * 128),
        num_heads=heads, num_kv_heads=max(1, heads // ratio),
        d_ff=max(256, int(cfg.d_ff * f) // 128 * 128),
        vocab_size=min(cfg.vocab_size, 32768),
        groups=tuple((p, max(1, int(r * f))) for p, r in cfg.groups),
        encoder_groups=tuple((p, max(1, int(r * f))) for p, r in cfg.encoder_groups),
        head_dim=None)


def cut_depth(cfg, layers: int):
    """``cfg`` with only its first ``layers`` layers: its groups in order,
    the last one kept in whole units of its pattern (zamba2-7b's 6: one
    superblock); any other count raises."""
    groups, left = [], layers
    for pattern, repeats in cfg.groups:
        units = min(repeats, left // len(pattern))
        if units:
            groups.append((pattern, units))
            left -= units * len(pattern)
        if units < repeats:
            break
    if left or not groups:
        raise ValueError(f"{cfg.name}: {layers} layers are not whole units of its "
                         f"groups {cfg.groups}")
    return dataclasses.replace(cfg, groups=tuple(groups))


def config_of(args):
    """The served config the arguments ask for: scaled, cut in depth, its
    quantization, its weights pre-quantized unless ``--no-prequant``."""
    quant = QuantConfig(mode=args.quant, rotate=args.rotate,
                        backend=args.kernel, kv_quant=args.quant != "none")
    cfg = scaled_config(get_config(args.arch), args.scale).with_quant(quant)
    if getattr(args, "layers", None):
        cfg = cut_depth(cfg, args.layers)
    prequant = args.quant != "none" if args.prequant is None else args.prequant
    if prequant:
        cfg = dataclasses.replace(cfg, weight_quant="int8")
    return cfg


def build_engine(args, mesh=None):
    """Arguments -> (engine, cfg): config (``config_of``), seeded weights
    (pre-quantized layer by layer on the device unless ``--no-prequant``),
    engine (on ``mesh``: every rank draws the whole model, the engine keeps
    its shards)."""
    cfg = config_of(args)
    params = init_lm(cfg, seed=args.seed, device=args.device)
    engine = ServeEngine(cfg, params, num_slots=args.slots,
                         max_len=args.max_len, prefill_len=args.prefill_len,
                         eos_id=args.eos_id, device=args.device,
                         max_queue=args.max_queue, watchdog_ms=args.watchdog_ms,
                         mesh=mesh)
    return engine, cfg


def request_stream(args, vocab_size: int):
    """The seeded Poisson stream the arguments ask for (the reference's
    ``synthetic_stream`` call)."""
    return synthetic_stream(
        args.requests, vocab_size=vocab_size,
        prompt_len=(args.prompt_min, args.prompt_max or args.prefill_len),
        max_new_tokens=(args.gen_min, args.gen_max), rate=args.rate, seed=args.seed,
        deadline_slack=args.deadline_slack)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=192)
    ap.add_argument("--prefill-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="mean arrivals per decode step (Poisson)")
    ap.add_argument("--prompt-min", type=int, default=8)
    ap.add_argument("--prompt-max", type=int, default=0,
                    help="0 = prefill-len")
    ap.add_argument("--gen-min", type=int, default=8)
    ap.add_argument("--gen-max", type=int, default=32)
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "fp8_e4m3", "fp8_e5m2"])
    ap.add_argument("--rotate", default="none", choices=["none", "hadamard"])
    ap.add_argument("--kernel", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--prequant", dest="prequant", action="store_true",
                    default=None,
                    help="pre-quantize weights ONCE at load into QTensors; "
                         "default: on whenever --quant is not 'none'")
    ap.add_argument("--no-prequant", dest="prequant", action="store_false")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="keep only the first N layers (whole pattern units)")
    ap.add_argument("--mp", type=int, default=1, help="model-parallel size")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission queue: submits beyond this depth "
                         "are rejected at once (backpressure)")
    ap.add_argument("--deadline-slack", type=float, default=None,
                    help="per-request TTL = arrival + max_new_tokens + slack "
                         "steps; expired queued requests are shed, expired "
                         "in-flight slots retired as timed_out")
    ap.add_argument("--watchdog-ms", type=float, default=None,
                    help="decode-step wall-clock bound; two consecutive trips "
                         "move the engine one ladder rung down")
    return ap.parse_args(argv)


def main(argv=None):
    """Serve the stream; returns the engine (on every rank of a mesh)."""
    args = parse_args(argv)
    mesh, started, on_mesh = None, False, distributed_requested(args.mp)
    if on_mesh:
        started = not dist.is_initialized()
        init_distributed(resolve_device(args.device), args.dist_backend,
                         COLLECTIVE_TIMEOUT_S)
    try:
        if on_mesh:
            mesh = make_local_mesh(args.mp)
        return _serve_loop(args, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _serve_loop(args, mesh):
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    engine, cfg = build_engine(args, mesh)
    if mesh is not None:
        say(f"mesh {mesh.sizes()} | slots of rank 0: {engine._slots.tolist()}")
    say(f"{cfg.name}: d_model={cfg.d_model} layers={cfg.num_layers} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} quant={cfg.quant.mode} "
        f"rotate={cfg.quant.rotate} kernel={cfg.quant.backend} "
        f"weights={cfg.weight_quant} device={engine.device}")
    say(f"warmup: {engine.warmup():.2f}s")
    engine.run(request_stream(args, cfg.vocab_size))
    s = engine.summary()
    say(f"served {s['requests']} requests / {s['generated_tokens']} tokens "
        f"in {s['decode_steps']} decode steps ({s['idle_steps']} idle)")
    say(f"throughput: {s['tokens_per_s']:.1f} tok/s, occupancy "
        f"{s['occupancy'] * 100:.0f}%, per-token latency p50 "
        f"{s['p50_token_ms']:.1f} ms / p99 {s['p99_token_ms']:.1f} ms")
    say(f"scheduler: admitted={s.get('admitted', 0)} "
        f"retired={s.get('retired', 0)} "
        f"prefill_inserts={s.get('prefill_inserts', 0)} "
        f"queue_full_stalls={s.get('queue_full_stalls', 0)}")
    say(f"robustness: ok={s.get('status_ok', 0)} "
        f"timed_out={s.get('status_timed_out', 0)} "
        f"rejected={s.get('status_rejected', 0)} "
        f"degraded={s.get('status_degraded', 0)} (shed={s.get('shed', 0)} "
        f"rung={s['rung']} guards={'on' if s['guards_enabled'] else 'off'} "
        f"abft={'on' if s['abft_enabled'] else 'off'})")
    say("health: " + " ".join(f"{k}={v}" for k, v in s["health"].items()))
    say(f"invariants: quantize_weight_calls={s['quantize_weight_calls']} "
        "during serve")
    return engine


if __name__ == "__main__":
    # requests failed below the ladder's last rung: the run is not a success
    if any(c.finish_reason in ("engine_failed", "shed_engine_failed")
           for c in main().completions):
        raise SystemExit("serve_loop: the degradation ladder was exhausted; "
                         "in-flight requests failed (engine_failed)")
