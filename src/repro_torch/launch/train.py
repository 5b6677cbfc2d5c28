"""Training launcher of the port (twin of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --scale 0.005 --steps 4 --seq 32 --batch 4 --quant int8 \
        --rotate hadamard --device cpu --ckpt-dir /tmp/ckpt

Trains on ``SyntheticDataset`` batches (a pure function of seed and step)
from random parameters drawn from ``--seed``, on the CUDA device unless
``--device cpu``. With int8 / fp8 quantization and Hadamard rotation the
attention Q/K sites run K2 and a power-of-2 d_ff's down projection the fused
rotate -> quantize -> GEMM kernel on the card (``--schedule``: rotate_once
K4, revisit K8, streamed K5; the backward pass runs K1), with
straight-through gradients.

Fault tolerance, as the reference's:

  * checkpoint / restart: asynchronous checkpoints every ``--ckpt-every``
    steps in the reference's layout (parameters in ``--ckpt-dir``, the
    optimizer state in ``--ckpt-dir/opt``, each leaf CRC-checked); at launch
    the newest valid step is restored and the data resumes bit-identically;
  * preemption: SIGTERM / SIGINT write a checkpoint of the finished step and
    exit 0;
  * stragglers: a step slower than ``--straggler-z`` sigma above the running
    mean is reported.

Several ranks: under torchrun, or with ``--mp`` > 1, the launcher starts
the process group (NCCL on a CUDA device, gloo on the CPU, or
``--dist-backend``), builds the (world / mp, mp) ("data", "model") mesh
and runs every step under it (``launch.steps``: the ZeRO-3 layout, batch
rows split over 'data', and ``--mp D`` tensor parallelism over 'model': a
rank computes H / D query heads, KH / D KV heads, d_ff / D hidden columns,
E / D experts, H / D RWKV6 or SSD heads and 1 / D of the vocabulary;
``models.lm``'s docstring):

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
        --mp 1 --arch phi4-mini-3.8b --scale 0.005 --steps 2 --seq 32 \
        --batch 4 --quant int8 --rotate hadamard --kernel cuda

Checkpoints are whole tensors in the same layout whatever the mesh: rank 0
writes them, gathered, and a restart slices them onto its own mesh, so
``--mp`` and the world may change between runs; blockwise-int8 moments
(``--opt-state int8``) too, their blocks the whole tensor's
(``optim.qstate``). Every architecture runs on the mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.bridge import opt_state_from_reference, params_from_reference, to_reference
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.store import wait_for_writes
from repro_torch.configs import get_config
from repro_torch.core.quant import QuantConfig
from repro_torch.data import SyntheticDataset
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import gather_tree, shard_tree
from repro_torch.kernels.quant_dot import SCHEDULES
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import (COLLECTIVE_TIMEOUT_S, distributed_requested,
                                    init_distributed, make_local_mesh)
from repro_torch.launch.serve_loop import cut_depth, scaled_config
from repro_torch.launch.steps import batch_to, make_train_step, state_parts
from repro_torch.models.lm import init_lm
from repro_torch.optim import OptConfig, init_opt_state


def save_state(ckpt_dir: str, step: int, cfg, params, opt_state, layout=None) -> None:
    """Checkpoint ``params`` and ``opt_state`` as step ``step`` in the
    reference's layout (``ckpt_dir`` and ``ckpt_dir/opt``). ``layout``:
    (mesh, parameter parts, state parts) when they are shards -- every rank
    gathers, rank 0 writes."""
    if layout is not None:
        mesh, pparts, oparts = layout
        params = gather_tree(params, pparts, mesh)
        opt_state = gather_tree(opt_state, oparts, mesh)
        if mesh.rank != 0:
            return
    save_checkpoint(ckpt_dir, step, to_reference(params, cfg))
    save_checkpoint(ckpt_dir + "/opt", step, to_reference(opt_state, cfg))


def restore_state(ckpt_dir: str, step: int, cfg, params, opt_state, device):
    """(params, opt_state) of checkpoint step ``step``, onto the structure
    of the given ones (which may be freshly initialized)."""
    p = restore_checkpoint(ckpt_dir, step, to_reference(params, cfg, meta=True), device)
    o = restore_checkpoint(ckpt_dir + "/opt", step, to_reference(opt_state, cfg, meta=True),
                           device)
    return params_from_reference(p, device), opt_state_from_reference(o, cfg, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None, help="override seq len")
    ap.add_argument("--batch", type=int, default=None, help="override global batch")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="model scale factor (e.g. 0.005 for a CPU run)")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep only the first N layers (whole pattern units)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "fp8_e4m3", "fp8_e5m2"])
    ap.add_argument("--rotate", default="none", choices=["none", "hadamard"])
    ap.add_argument("--kernel", default="auto", choices=["auto", "cuda", "torch"],
                    help="rotation backend: the CUDA kernels or their plain versions")
    ap.add_argument("--schedule", default=None, choices=list(SCHEDULES),
                    help="the fused quant_dot kernels' schedule (default: "
                         "REPRO_QUANT_DOT_SCHEDULE, then rotate_once)")
    ap.add_argument("--opt-state", default="f32", choices=["f32", "int8"])
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8_ef"])
    ap.add_argument("--mp", type=int, default=1, help="model-parallel size")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None,
                    help="append every step's metrics to this file, one JSON line each")
    ap.add_argument("--straggler-z", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    quant = QuantConfig(mode=args.quant, rotate=args.rotate, backend=args.kernel,
                        kv_quant=args.quant != "none", schedule=args.schedule)
    cfg = scaled_config(get_config(args.arch), args.scale).with_quant(quant)
    if args.layers:
        cfg = cut_depth(cfg, args.layers)
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(1, args.steps // 20),
                        state_dtype=args.opt_state,
                        grad_compression=args.grad_compression)
    mesh, started, on_mesh = None, False, distributed_requested(args.mp)
    if on_mesh:
        started = not dist.is_initialized()
        init_distributed(device, args.dist_backend, COLLECTIVE_TIMEOUT_S)
    try:
        if on_mesh:
            mesh = make_local_mesh(args.mp)
        return _train(args, device, mesh, cfg, opt_cfg)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, device, mesh, cfg, opt_cfg) -> int:
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    shape = shp.SHAPES[args.shape]
    if args.seq or args.batch:
        shape = dataclasses.replace(shape, seq=args.seq or shape.seq,
                                    batch=args.batch or shape.batch)
    if mesh is not None:
        say(f"mesh {mesh.sizes()} | ", end="")
    say(f"device {device} | arch {cfg.name} scale {args.scale} | {shape}")
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatch, mesh=mesh)

    # every rank draws (or restores) the whole model, then keeps its shards
    params = init_lm(cfg, seed=args.seed, device=device)
    opt_state = init_opt_state(params, opt_cfg)
    start_step = 0
    if args.ckpt_dir and (lk := latest_step(args.ckpt_dir)) is not None:
        say(f"restoring checkpoint step {lk}")
        params, opt_state = restore_state(args.ckpt_dir, lk, cfg, params, opt_state, device)
        start_step = lk
    n_params = sum(p.numel() for p in T.leaves(params))
    say(f"params: {n_params / 1e6:.1f}M")
    layout = None
    if mesh is not None:
        layout = (mesh, *state_parts(cfg, opt_cfg, mesh))
        params = shard_tree(params, layout[1], mesh)
        opt_state = shard_tree(opt_state, layout[2], mesh)

    ds = SyntheticDataset(cfg, shape, seed=args.seed)
    stop = {"now": False}

    def handle(sig, frame):
        say(f"signal {sig}: checkpointing and exiting")
        stop["now"] = True

    signal.signal(signal.SIGTERM, handle)
    signal.signal(signal.SIGINT, handle)

    times = []
    t_train0 = time.time()
    for step in range(start_step, args.steps):
        batch = batch_to(ds.batch(step), device)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        if args.metrics_out and (mesh is None or mesh.rank == 0):
            with open(args.metrics_out, "a") as f:
                f.write(json.dumps(dict(metrics, step=step)) + "\n")
        times.append(dt)
        if len(times) > 5:
            mu, sd = np.mean(times[1:]), np.std(times[1:]) + 1e-9
            if dt > mu + args.straggler_z * sd:
                say(f"[straggler] step {step}: {dt:.2f}s vs mean {mu:.2f}s "
                      f"(z={(dt - mu) / sd:.1f}) -- flagging host set for quarantine")
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['gnorm']:.3f} lr {metrics['lr']:.2e} {dt:.2f}s")
        if args.ckpt_dir and ((step + 1) % args.ckpt_every == 0 or stop["now"]
                              or step == args.steps - 1):
            save_state(args.ckpt_dir, step + 1, cfg, params, opt_state, layout)
        if stop["now"]:
            wait_for_writes()
            return 0
    wait_for_writes()
    total = time.time() - t_train0
    steps_run = args.steps - start_step
    if steps_run > 0:
        say(f"done: {steps_run} steps in {total:.1f}s "
              f"({np.mean(times[1:]) if len(times) > 1 else times[0]:.2f}s/step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
