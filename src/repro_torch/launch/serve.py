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

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --scale 1.0 --batch 4 --prompt-len 16 --gen 64 --quant int8 \
        --rotate hadamard
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \
        --scale 1.0 --batch 4 --prompt-len 1088 --gen 16 --quant fp8_e4m3 \
        --rotate hadamard
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --scale 1.0 --batch 4 --prompt-len 512 --gen 32 --quant int8 \
        --rotate hadamard
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --scale 1.0 --batch 4 --prompt-len 512 --gen 32 --quant fp8_e4m3 \
        --rotate hadamard

Runs on the CUDA device unless ``--device cpu`` (the plain versions). The
weights are drawn from ``--seed`` and pre-quantized layer by layer at load
whenever ``--quant`` is not 'none' (``--no-prequant``: raw weights,
quantized on the fly at the consumer sites). The prompt batch is
``shapes.make_batch``'s, all of it to ``lm_prefill``: a vlm's
``--prompt-len`` positions are ``vlm_patches`` patch embeddings and the
tokens after them; an encoder-decoder's batch adds ``encoder_seq`` frames
per prompt, which the prefill encodes once. Then ``--gen - 1`` greedy
decode steps at a shared scalar ``cache_pos``, from ``--prompt-len``, or,
for a vlm, from ``--prompt-len`` + ``vlm_patches``, in KV caches padded to
``--prompt-len`` + ``--gen``: the reference's launcher (``repro.launch.
serve``), whose vlm decode starts past its cache's end, so that every
step writes the cache's last row (``decode_attention`` clamps the row as
JAX's ``dynamic_update_slice`` does) and attends to every row, the zero
rows of the padding included (ROADMAP.md, "Reference health"). A
recurrent model (rwkv, mamba) carries its state instead; a mamba prompt
of 128 tokens or more must be a multiple of 128 (the SSD's chunk). The
first decode step is timed apart (it pays the first-use costs), so the
reported tok/s is the steady state.

Several ranks (torchrun, or ``--mp`` > 1; ``launch.train``'s docstring):
the weights are this rank's shards at rest, each layer's gathered just
before it runs (int8 storage as int8; the down projections' consumer
weights stay split by their out-channels into the sharded quant_dot); the
prompt batch's rows split over 'data'; with ``--mp D`` every layer and the
vocabulary split over 'model' -- heads, hidden columns, experts, RWKV6 and
SSD heads (each rank's KV caches hold its KH / D heads, its recurrent
states its heads); the tokens are gathered whole on every
rank. Every architecture serves on the mesh: a vlm's M-RoPE
positions and patch embeddings, an encoder-decoder's frames and a
recurrent model's states are split by rows like the tokens. ``--layers N``
keeps the first N layers:

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu \
        --mp 1 --arch phi4-mini-3.8b --scale 0.005 --batch 4 \
        --prompt-len 16 --gen 6 --quant int8 --rotate hadamard --kernel cuda
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.quant import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import shard_tree
from repro_torch.distributed.sharding import local_rows, sharding_rules
from repro_torch.launch import shapes as shp
from repro_torch.launch.env import harden_host_env
from repro_torch.launch.mesh import (COLLECTIVE_TIMEOUT_S, distributed_requested,
                                    init_distributed, make_local_mesh)
from repro_torch.launch.serve_loop import cut_depth, scaled_config
from repro_torch.launch.steps import batch_row_axes, local_batch
from repro_torch.models.lm import (init_lm, lm_decode_step, lm_prefill, pad_kv_caches,
                                   param_parts)


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
    ap.add_argument("--layers", type=int, default=None,
                    help="keep only the first N layers (whole pattern units)")
    ap.add_argument("--mp", type=int, default=1, help="model-parallel size")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Serve one batch; returns {"cfg", "tokens" ((batch, gen) int64 numpy),
    "margins" ((batch, gen) f32 numpy: each greedy token's top-1 / top-2
    logit gap), "prefill_logits" ((batch, vocab) f32 numpy: the prefill's
    last-position logits), "prefill_s", "decode_steps", "decode_s",
    "tokens_per_s"}."""
    harden_host_env()                 # variables only; re-exec is __main__'s
    args = parse_args(argv)
    device = resolve_device(args.device)
    quant = QuantConfig(mode=args.quant, rotate=args.rotate, backend=args.kernel,
                        kv_quant=args.quant != "none")
    cfg = scaled_config(get_config(args.arch), args.scale).with_quant(quant)
    if args.layers:
        cfg = cut_depth(cfg, args.layers)
    prequant = args.quant != "none" if args.prequant is None else args.prequant
    if prequant:
        cfg = dataclasses.replace(cfg, weight_quant="int8")
    mesh, started, on_mesh = None, False, distributed_requested(args.mp)
    if on_mesh:
        started = not dist.is_initialized()
        init_distributed(device, args.dist_backend, COLLECTIVE_TIMEOUT_S)
    try:
        if on_mesh:
            mesh = make_local_mesh(args.mp)
        return _serve(args, device, mesh, cfg, prequant)
    finally:
        if started:
            dist.destroy_process_group()


def _serve(args, device, mesh, cfg, prequant: bool) -> dict:
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    if mesh is not None:
        say(f"mesh {mesh.sizes()}")
    say(f"{cfg.name}: d_model={cfg.d_model} layers={cfg.num_layers} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} quant={cfg.quant.mode} rotate={cfg.quant.rotate} "
        f"kernel={cfg.quant.backend} weights={cfg.weight_quant} device={device}")
    params = init_lm(cfg, seed=args.seed, device=device)
    if prequant:
        say("weights pre-quantized once at load (QTensor leaves; "
            f"consumer mode={args.quant})")
    pos = args.prompt_len + (cfg.vlm_patches if cfg.family == "vlm" else 0)
    max_len = args.prompt_len + args.gen
    batch = shp.make_batch(cfg, shp.ShapeSpec("serve", "prefill", args.prompt_len,
                                              args.batch), seed=args.seed)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items() if k != "labels"}
    batch["tokens"] = batch["tokens"].long()
    rows = ()
    if mesh is not None:
        # every rank draws the whole model, then keeps its shards
        with sharding_rules(mesh):
            params = shard_tree(params, param_parts(cfg, mesh), mesh)
        rows = batch_row_axes(mesh, args.batch)
        batch = local_batch(batch, mesh, rows)
    with sharding_rules(mesh), local_rows(rows):
        out = _generate(args, device, cfg, params, batch, pos, max_len, say)
    for key in ("tokens", "margins", "prefill_logits"):
        if mesh is not None:
            out[key] = mesh.gather(out[key], rows, 0)
        out[key] = out[key].cpu().numpy()
    say("sample token ids:", out["tokens"][0, :16].tolist())
    return dict(out, cfg=cfg)


def _greedy(cfg, logits):
    """The greedy token of the last position, (B, 1), and its top-1 /
    top-2 logit gap, (B, 1) f32."""
    last = logits[:, -1, :cfg.vocab_size]
    top = last.float().topk(2, dim=-1).values
    return last.argmax(-1)[:, None], top[:, :1] - top[:, 1:]


def _generate(args, device, cfg, params, batch, pos: int, max_len: int, say) -> dict:
    """Prefill ``batch``, then ``--gen - 1`` greedy decode steps: the
    tokens (a tensor on the device) and the timings."""
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = lm_prefill(cfg, params, batch)
        caches = pad_kv_caches(cfg, caches, max_len)
        tok, gap = _greedy(cfg, logits)
        first = logits[:, -1, :cfg.vocab_size].float()
        _sync(device)
        t_prefill = time.perf_counter() - t0
        say(f"prefill: B={args.batch} S={args.prompt_len} in {t_prefill:.2f}s")

        out, gaps = [tok], [gap]

        def step(i):
            logits, _ = lm_decode_step(cfg, params, caches, out[-1],
                                       torch.tensor(pos + i, device=device))
            tok, gap = _greedy(cfg, logits)
            out.append(tok)
            gaps.append(gap)

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
    rate = steps * args.batch / max(dt, 1e-9)
    if steps > 0:
        say(f"decode: first step {t_warm:.2f}s; {steps} steady-state steps in "
            f"{dt:.2f}s ({rate:.1f} tok/s)")
    else:
        say(f"decode: {args.gen - 1} steps in {t_warm:.2f}s (0.0 tok/s "
            "steady-state; too few steps to separate the first)")
    return {"tokens": torch.cat(out, dim=1), "margins": torch.cat(gaps, dim=1),
            "prefill_logits": first, "prefill_s": t_prefill,
            "decode_steps": steps, "decode_s": dt,
            "tokens_per_s": rate if steps > 0 else 0.0}


if __name__ == "__main__":
    harden_host_env(reexec=True)
    main()
