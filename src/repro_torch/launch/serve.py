"""Batched one-shot serving launcher of the port: prefill a prompt batch,
then decode greedily with the (optionally fp8-quantized, Hadamard-rotated)
KV cache -- the paper's deployment scenario (twin of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --scale 0.02 --batch 8 --prompt-len 128 --gen 32 \
        --quant fp8_e4m3 --rotate hadamard
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \
        --scale 1.0 --batch 4 --prompt-len 64 --gen 16 --quant int8 \
        --rotate hadamard

Runs on the CUDA device unless ``--device cpu`` (the plain versions). The
weights are drawn from ``--seed`` and pre-quantized layer by layer at load
whenever ``--quant`` is not 'none' (``--no-prequant``: raw weights,
quantized on the fly at the consumer sites). The prompt batch is
``shapes.make_batch``'s. Prefill, ``pad_kv_caches`` to prompt + gen, then
``--gen - 1`` greedy decode steps at a shared scalar ``cache_pos``; the
first decode step is timed apart (it pays the first-use costs), so the
reported tok/s is the steady state. ``--mp`` > 1 (model parallelism) is
not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.quant import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.launch import shapes as shp
from repro_torch.launch.env import harden_host_env
from repro_torch.launch.serve_loop import scaled_config
from repro_torch.models.lm import init_lm, lm_decode_step, lm_prefill, pad_kv_caches


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "fp8_e4m3", "fp8_e5m2"])
    ap.add_argument("--rotate", default="none", choices=["none", "hadamard"])
    ap.add_argument("--kernel", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--prequant", dest="prequant", action="store_true",
                    default=None,
                    help="pre-quantize the weights once at load (int8 storage; "
                         "the rotation-consumer weights in the serving quant "
                         "mode). Default: on whenever --quant is not 'none'.")
    ap.add_argument("--no-prequant", dest="prequant", action="store_false")
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Serve one batch; returns {"cfg", "tokens" ((batch, gen) int64 numpy),
    "prefill_s", "decode_steps", "decode_s", "tokens_per_s"}."""
    harden_host_env()                 # variables only; re-exec is __main__'s
    args = parse_args(argv)
    if args.mp > 1:
        raise NotImplementedError("--mp > 1: multi-device serving is not ported yet "
                                  "(ROADMAP section 1, item 9)")
    device = resolve_device(args.device)
    quant = QuantConfig(mode=args.quant, rotate=args.rotate, backend=args.kernel,
                        kv_quant=args.quant != "none")
    cfg = scaled_config(get_config(args.arch), args.scale).with_quant(quant)
    prequant = args.quant != "none" if args.prequant is None else args.prequant
    if prequant:
        cfg = dataclasses.replace(cfg, weight_quant="int8")
    print(f"{cfg.name}: d_model={cfg.d_model} layers={cfg.num_layers} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} quant={cfg.quant.mode} rotate={cfg.quant.rotate} "
          f"kernel={cfg.quant.backend} weights={cfg.weight_quant} device={device}")
    params = init_lm(cfg, seed=args.seed, device=device)
    if prequant:
        print("weights pre-quantized once at load (QTensor leaves; "
              f"consumer mode={args.quant})")
    max_len = args.prompt_len + args.gen
    batch = shp.make_batch(cfg, shp.ShapeSpec("serve", "prefill", args.prompt_len,
                                              args.batch), seed=args.seed)
    tokens = torch.from_numpy(batch["tokens"]).long().to(device)

    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = lm_prefill(cfg, params, {"tokens": tokens})
        caches = pad_kv_caches(cfg, caches, max_len)
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        _sync(device)
        t_prefill = time.perf_counter() - t0
        print(f"prefill: B={args.batch} S={args.prompt_len} in {t_prefill:.2f}s")

        out = [tok]
        pos = args.prompt_len

        def step(i):
            logits, _ = lm_decode_step(cfg, params, caches, out[-1],
                                       torch.tensor(pos + i, device=device))
            out.append(logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None])

        # the first decode step pays the first-use costs: timed apart, so
        # the reported tok/s is the steady state
        steps, t_warm, dt = 0, 0.0, 0.0
        if args.gen > 1:
            t0 = time.perf_counter()
            step(0)
            _sync(device)
            t_warm = time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(1, args.gen - 1):
                step(i)
            _sync(device)
            dt = time.perf_counter() - t0
            steps = args.gen - 2
    toks = torch.cat(out, dim=1).cpu().numpy()
    rate = steps * args.batch / max(dt, 1e-9)
    if steps > 0:
        print(f"decode: first step {t_warm:.2f}s; {steps} steady-state steps in "
              f"{dt:.2f}s ({rate:.1f} tok/s)")
    else:
        print(f"decode: {args.gen - 1} steps in {t_warm:.2f}s (0.0 tok/s "
              "steady-state; too few steps to separate the first)")
    print("sample token ids:", toks[0, :16].tolist())
    return {"cfg": cfg, "tokens": toks, "prefill_s": t_prefill,
            "decode_steps": steps, "decode_s": dt,
            "tokens_per_s": rate if steps > 0 else 0.0}


if __name__ == "__main__":
    harden_host_env(reexec=True)
    main()
