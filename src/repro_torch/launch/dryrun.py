"""The dry run: plan every (architecture x input shape) cell on the
production meshes of H100 ranks, and the per-launch sharding-rule presets
(twin of ``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \
      --shape train_4k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
      --out artifacts/dryrun

A cell is one architecture, one shape (``launch.shapes.SHAPES``) and one
production mesh, 16 x 16 ranks or 2 x 16 x 16 (``launch.mesh``). Its step
(``launch.steps``: the train step, the prefill step, or the serve step
over caches of the shape's length) runs once on the meta device, on rank 0
of a ``launch.mesh.fake_world`` of the mesh's size, under
``launch.cost_analysis.StepCost`` and the collective recorder: nothing is
computed or allocated, and every collective returns at once. Rank 0 stands
for every rank: the divisibility guard of ``distributed.sharding`` makes
every split even, so every rank runs the same ops on the same shapes. Two
writes belong to some ranks only: the KV row a decode writes is one rank's
of a 'kvseq' split, yet every rank runs the same select over its own rows
(``models.attention._write_owned_row``), so rank 0's cost is every rank's;
and a prefill's insertion into a slot is made by the ranks that hold the
slot (``serving.engine``), in no step planned here.

On the meta device the quantized sites take their plain versions, as the
reference's dry run takes its XLA path: the cells' quantization configs
name the ``"torch"`` backend, and a cell fails if a kernel wrapper counted
a launch. The result of a cell (``run_cell``; one JSON each with ``--out``)
holds the reference's keys:

  * ``status`` ok, skipped (with ``shapes.shape_applicable``'s reason) or
    error (with the exception and its traceback);
  * ``memory``: per-rank ``argument_bytes`` (the parameter, optimizer-state
    and cache shards and the batch rows a rank holds), ``output_bytes``,
    ``alias_bytes`` (outputs that are arguments updated in place: the train
    step's parameters and moments, the serve step's caches), ``temp_bytes``
    (the peak of live bytes less the arguments) and ``per_device_total_gb``
    (argument + temp: the peak). The reference's sum, argument + temp -
    alias of XLA's buffers, leaves out the donated buffers' own bytes;
  * ``cost_analysis`` (``launch.cost_analysis.analyze``'s keys, the twin of
    ``hlo_analysis``) and ``aten_ops`` (the ops seen, the twin of
    ``xla_cost_analysis``);
  * ``params``, ``model_flops`` (``launch.flops``), ``useful_flops_ratio``
    (model FLOPs over every rank's counted FLOPs) and ``roofline``.

Each cell runs in a child process of its own (spawned), which starts and
ends its fake world: neither importing this module nor calling
``run_cell`` starts a process group or sets an environment variable in
the caller.

``decode_rules(cfg, shape)`` and ``FSDP_ONLY_RULES`` are the reference's
overrides of ``distributed.sharding.DEFAULT_RULES``, with its names and
logic; ``serving.ServeEngine(..., rules_overrides=)`` takes either, and
``launch.steps.make_train_step(..., rules_overrides=)`` any of them.
``cell_rules(cfg, shape, seqpar, rules_preset)`` composes a cell's
overrides as the reference's ``run_cell`` does.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from typing import Any, Dict, Optional

from repro_torch.launch import shapes as shp
from repro_torch.launch.flops import count_params, model_flops
from repro_torch.launch.shapes import ShapeSpec

__all__ = ["decode_rules", "FSDP_ONLY_RULES", "cell_rules", "roofline_terms", "plan",
           "argument_bytes",
           "run_cell", "DRYRUN_ARCHS", "PEAK_FLOPS", "HBM_BW", "NET_BW", "main"]

# ------------------------------------------------- H100 SXM5 roofline model
PEAK_FLOPS = 989.4e12   # bf16 dense tensor-core FLOP/s, H100 SXM5 (NVIDIA H100 datasheet)
HBM_BW = 3.35e12        # HBM3 bytes/s, H100 SXM5 (the datasheet; PERF.md's bounds)
NET_BW = 50e9           # bytes/s a GPU: one 400 Gb/s NIC per GPU. Every group of
                        # both production meshes spans more than one 8-GPU NVLink
                        # node, so one constant serves, as one served the reference

# the reference's ``ARCH_IDS[:10]``: every architecture but llama3-8b
DRYRUN_ARCHS = ("whisper-base", "mixtral-8x7b", "llama4-maverick-400b-a17b", "llama3-405b",
                "phi4-mini-3.8b", "starcoder2-15b", "qwen1.5-4b", "zamba2-7b", "rwkv6-7b",
                "qwen2-vl-7b")


def roofline_terms(per_device: dict, n_chips: int) -> dict:
    """Three roofline terms in seconds (per step), from per-device costs."""
    t_compute = per_device["flops_per_device"] / PEAK_FLOPS
    t_memory = per_device["hbm_bytes_per_device"] / HBM_BW
    t_coll = per_device["collective_total_bytes_per_device"] / NET_BW
    dom = max((t_compute, "compute"), (t_memory, "memory"), (t_coll, "collective"))
    return {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "dominant": dom[1],
        "bound_s": dom[0],
    }


def decode_rules(cfg, shape: ShapeSpec):
    """Per-cell sharding-rule overrides.

    decode: the KV cache shards its sequence dim over 'model'
    (flash-decoding style); batch < 32 (long context) also spans 'data'
    and splits the query heads over 'model'.

    Serving weight layout: FSDP-sharded weights must be all-gathered every
    decode step. So at serve time:
      * MoE archs shard experts over 'data' (EP) x expert-ffn over 'model'
        (TP), the dispatch replicated over the rows ('moebatch' None);
      * dense archs replicate the 'fsdp' dims IF the model-sharded weights
        fit comfortably (< 6 GB a device at 16 devices, bf16); giant dense
        models (405B) keep FSDP storage and pay the gather.

    None for a cell that is not a decode."""
    if shape.kind != "decode":
        return None
    rules = {"kvseq": "model", "kv": None}
    if shape.batch < 32:
        rules["kvseq"] = ("data", "model")
        rules["heads"] = "model"
    if cfg.num_experts:
        rules.update({"experts": "data", "dff": "model", "fsdp": None,
                      "moebatch": None})
    else:
        per_dev_gb = count_params(cfg)["total"] * 2 / 16 / 1e9  # TP-sharded bf16
        if per_dev_gb < 6.0:
            rules["fsdp"] = None
    return rules


# every layer computes whole; only the weights (and the vocabulary table,
# storage only) are split, over every mesh axis (ZeRO-3)
FSDP_ONLY_RULES = {
    "heads": None, "kv": None, "dff": None, "experts": None,
    "vocab": ("pod", "data", "model"),
    "fsdp": ("pod", "data", "model"),
}


def cell_rules(cfg, shape: ShapeSpec, seqpar: bool = False, rules_preset=None):
    """A cell's sharding-rule overrides, composed as the reference's
    ``run_cell`` composes them: ``decode_rules``, then residual sequence
    parallelism over 'model' with ``seqpar``, then ``FSDP_ONLY_RULES``
    with ``rules_preset == "fsdp_only"`` (any other preset adds nothing,
    as there). None when nothing overrides the defaults."""
    rules = decode_rules(cfg, shape)
    if seqpar:
        rules = dict(rules or {}, seqpar="model")
    if rules_preset == "fsdp_only":
        rules = dict(rules or {}, **FSDP_ONLY_RULES)
    return rules


# ------------------------------------------------------------- the plan
def _storages(tree) -> Dict[int, int]:
    """Bytes of every storage the tree's tensors use, by storage."""
    from repro_torch.launch.cost_analysis import tensors

    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in tensors(tree)}


def _launches() -> int:
    from repro_torch.analysis.dispatch_trace import kernel_wrappers

    return sum(f.launches for f in kernel_wrappers().values())


def _cell_args(cfg, shape: ShapeSpec, opt_cfg, mesh, rules, microbatches: int):
    """(step, its arguments, the batch part of them whole, the same part as
    this rank's rows) on the meta device, the state as this rank's shards."""
    from repro_torch.launch.cost_analysis import MetaMemo

    with MetaMemo():
        return _build_cell_args(cfg, shape, opt_cfg, mesh, rules, microbatches)


def _build_cell_args(cfg, shape: ShapeSpec, opt_cfg, mesh, rules, microbatches: int):
    import torch

    from repro_torch.distributed.collectives import shard_tree
    from repro_torch.distributed.sharding import make_resolver, sharding_rules
    from repro_torch.launch import steps as S

    B, T = shape.batch, shape.seq

    def local(tree, parts_fn):
        if mesh is None:
            return tree
        with sharding_rules(mesh, rules):
            return shard_tree(tree, parts_fn(), mesh)

    params = S.param_shapes(cfg)
    if shape.kind == "decode":
        caches = local(S.cache_shapes(cfg, B, T), lambda: S.cache_parts(cfg, B, T, mesh))
        tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
        rows = local(tokens, lambda: make_resolver(mesh)(("batch", None), (B, 1)))
        params = local(params, lambda: S.param_parts(cfg, mesh))
        step = S.make_serve_step(cfg, mesh=mesh, rules_overrides=rules, max_len=T)
        pos = torch.zeros((), dtype=torch.int32, device="meta")
        return step, (params, caches, tokens, pos), tokens, rows
    batch = S.batch_shapes(cfg, shape)
    rows = local(batch, lambda: S.batch_parts(cfg, shape, mesh))
    if shape.kind == "train":
        if cfg.weight_quant != "none":
            raise ValueError("int8 weight storage serves only: a train step takes the "
                             "gradients of raw weights (the reference's fails alike)")
        state = S.opt_state_shapes(cfg, opt_cfg)
        if mesh is not None:
            pparts, oparts = S.state_parts(cfg, opt_cfg, mesh, rules)
            params, state = shard_tree(params, pparts, mesh), shard_tree(state, oparts, mesh)
        step = S.make_train_step(cfg, opt_cfg, microbatches, mesh=mesh, rules_overrides=rules)
        return step, (params, state, batch), batch, rows
    params = local(params, lambda: S.param_parts(cfg, mesh))
    return S.make_prefill_step(cfg, mesh=mesh, rules_overrides=rules), (params, batch), batch, rows


def _held(args, whole, rows) -> Dict[int, int]:
    """The storages of a step's arguments that one rank holds, by storage:
    the step takes the whole batch (``whole``) and keeps this rank's rows
    (``rows``)."""
    held = _storages(args)
    for k in _storages(whole):
        held.pop(k, None)
    return {**held, **_storages(rows)}


def argument_bytes(cfg, shape: ShapeSpec, opt_cfg, mesh=None, rules=None) -> int:
    """``plan``'s ``argument_bytes`` of a cell, without running its step:
    the parameter, optimizer-state and cache shards and the batch rows one
    rank of ``mesh`` holds."""
    _, args, whole, rows = _cell_args(cfg, shape, opt_cfg, mesh, rules, 1)
    return sum(_held(args, whole, rows).values())


def plan(cfg, shape: ShapeSpec, opt_cfg, mesh=None, rules=None, microbatches: int = 1) -> dict:
    """One step of ``cfg`` at ``shape`` run on the meta device under
    ``cost_analysis.StepCost`` (module docstring): {"build_s", "trace_s",
    "memory", "argument_tensors" (the storages ``argument_bytes`` sums),
    "cost_analysis", "aten_ops"}. ``mesh``: this rank's step on
    it, under the default rules updated by ``rules`` (its groups built on
    an initialised default process group: a ``launch.mesh.fake_world``);
    None: the step of one device, which needs no process group."""
    from repro_torch.launch.cost_analysis import StepCost, analyze
    from repro_torch.launch.mesh import record_collectives

    t0 = time.time()
    step, args, whole, rows = _cell_args(cfg, shape, opt_cfg, mesh, rules, microbatches)
    launches = _launches()
    t_build = time.time() - t0
    cost = StepCost()
    with record_collectives() as seen, cost:
        cost.track(args)
        out = step(*args)
    t_trace = time.time() - t0 - t_build
    if _launches() != launches:
        raise RuntimeError("a kernel wrapper launched on the meta device")
    ins, outs, held = _storages(args), _storages(out), _held(args, whole, rows)
    argument = sum(held.values())
    extra = sum(ins.values()) - argument
    analysis = analyze(cost, seen)
    temp = analysis.pop("peak_bytes") - extra - argument
    return {
        "build_s": round(t_build, 1),
        "trace_s": round(t_trace, 1),
        "memory": {
            "argument_bytes": argument,
            "output_bytes": sum(outs.values()),
            "temp_bytes": temp,
            "alias_bytes": sum(v for k, v in outs.items() if k in ins),
            "per_device_total_gb": round((argument + temp) / 1e9, 3),
        },
        "argument_tensors": len(held),
        "aten_ops": {"ops": cost.ops, "flops": analysis["flops_per_device"],
                     "bytes accessed": analysis["hbm_bytes_per_device"]},
        "cost_analysis": analysis,
    }


def _cell_config(arch: str, quant, remat=None, rwkv_chunk=None, weight_quant="none"):
    from repro_torch.configs import get_config

    cfg = get_config(arch).with_quant(quant)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    if rwkv_chunk:
        cfg = dataclasses.replace(cfg, rwkv_chunk=rwkv_chunk)
    if weight_quant != "none":
        cfg = dataclasses.replace(cfg, weight_quant=weight_quant)
    return cfg


def _cell(arch: str, shape_name: str, multi_pod: bool, quant, opt_cfg, remat=None,
          seqpar: bool = False, rules_preset=None, rwkv_chunk=None, microbatches: int = 1,
          weight_quant: str = "none") -> dict:
    """``run_cell``'s result, computed in this process: a skipped cell
    starts nothing; a cell that runs starts and ends a fake world here."""
    cfg = _cell_config(arch, quant, remat, rwkv_chunk, weight_quant)
    shape = shp.SHAPES[shape_name]
    skip = shp.shape_applicable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "quant": dataclasses.asdict(quant)}
    if skip:
        result["status"] = "skipped"
        result["reason"] = skip
        return result
    rules = cell_rules(cfg, shape, seqpar, rules_preset)
    if seqpar:
        result["seqpar"] = True
    if rules_preset == "fsdp_only":
        result["rules_preset"] = rules_preset
    if microbatches > 1:
        result["microbatches"] = microbatches
    try:
        import torch

        from repro_torch.launch.mesh import fake_world, make_production_mesh

        torch.set_num_threads(1)
        n_chips = 512 if multi_pod else 256
        with fake_world(n_chips):
            mesh = make_production_mesh(multi_pod=multi_pod, rank=0)
            got = plan(cfg, shape, opt_cfg, mesh, rules, microbatches)
        analysis = got["cost_analysis"]
        mf = model_flops(cfg, shape)
        result.update({
            "status": "ok",
            "build_s": got["build_s"],
            "trace_s": got["trace_s"],
            "n_chips": n_chips,
            "memory": got["memory"],
            "aten_ops": got["aten_ops"],
            "cost_analysis": analysis,
            "params": count_params(cfg),
            "model_flops": mf,
            "useful_flops_ratio": mf / max(analysis["flops_per_device"] * n_chips, 1.0),
            "roofline": roofline_terms(analysis, n_chips),
        })
    except Exception as e:  # noqa: BLE001 -- a failing cell is a recorded bug
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
    return result


def _pool(jobs: int) -> cf.ProcessPoolExecutor:
    """Spawned workers; each cell starts and ends its own fake world in one."""
    return cf.ProcessPoolExecutor(max_workers=jobs,
                                  mp_context=multiprocessing.get_context("spawn"))


def _weight(kw: dict) -> float:
    """A cell's rough planning cost, to start the slowest first: the ops a
    step runs grow with its layers, and a chunked recurrence's with its
    chunks."""
    cfg = _cell_config(kw["arch"], kw["quant"], kw.get("remat"), kw.get("rwkv_chunk"))
    shape = shp.SHAPES[kw["shape_name"]]
    if shape.kind == "decode":
        return cfg.num_layers
    chunks = shape.seq / cfg.rwkv_chunk if "rwkv" in cfg.layer_kinds else 1
    return cfg.num_layers * (3 if shape.kind == "train" else 1) * 8 * chunks


def _in_child(pool, kw: dict):
    """A future of ``_cell(**kw)`` in a worker of ``pool``; a skipped cell is
    answered here, starting nothing."""
    cfg = _cell_config(kw["arch"], kw["quant"], kw.get("remat"), kw.get("rwkv_chunk"),
                       kw.get("weight_quant", "none"))
    if shp.shape_applicable(cfg, shp.SHAPES[kw["shape_name"]]):
        done = cf.Future()
        done.set_result(_cell(**kw))
        return done
    return pool.submit(_cell, **kw)


def _result(fut, kw: dict) -> dict:
    try:
        return fut.result()
    except Exception as e:  # noqa: BLE001 -- a lost child is a failed cell
        return {"arch": kw["arch"], "shape": kw["shape_name"],
                "mesh": "pod2x16x16" if kw["multi_pod"] else "pod16x16",
                "quant": dataclasses.asdict(kw["quant"]), "status": "error",
                "error": f"{type(e).__name__}: {e}"}


def run_cell(arch: str, shape_name: str, multi_pod: bool, quant, opt_cfg,
             verbose: bool = True, remat: str = None, seqpar: bool = False,
             rules_preset: str = None, rwkv_chunk: int = None, microbatches: int = 1,
             weight_quant: str = "none") -> dict:
    """Plan one cell in a spawned child process (module docstring) and
    return its result; the reference's arguments."""
    kw = dict(arch=arch, shape_name=shape_name, multi_pod=multi_pod, quant=quant,
              opt_cfg=opt_cfg, remat=remat, seqpar=seqpar, rules_preset=rules_preset,
              rwkv_chunk=rwkv_chunk, microbatches=microbatches, weight_quant=weight_quant)
    with _pool(1) as pool:
        r = _result(_in_child(pool, kw), kw)
    if verbose:
        _print_cell(r)
    return r


def _print_cell(r: dict):
    hdr = f"[{r['mesh']}] {r['arch']} x {r['shape']}"
    if r["status"] == "skipped":
        print(f"{hdr}: SKIP ({r['reason']})")
    elif r["status"] == "error":
        print(f"{hdr}: ERROR {r['error']}")
    else:
        rt = r["roofline"]
        print(f"{hdr}: ok build={r['build_s']}s trace={r['trace_s']}s "
              f"mem/dev={r['memory']['per_device_total_gb']}GB "
              f"compute={rt['compute_s']*1e3:.2f}ms memory={rt['memory_s']*1e3:.2f}ms "
              f"coll={rt['collective_s']*1e3:.2f}ms dom={rt['dominant']} "
              f"useful={r['useful_flops_ratio']:.2f}", flush=True)


def main(argv=None):
    from repro_torch.core.quant import QuantConfig
    from repro_torch.optim import OptConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(shp.SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="all assigned (arch, shape) cells")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "fp8_e4m3", "fp8_e5m2"])
    ap.add_argument("--rotate", default="none", choices=["none", "hadamard"])
    ap.add_argument("--opt-state", default="f32", choices=["f32", "int8"])
    ap.add_argument("--remat", default=None, choices=[None, "none", "dots", "full"])
    ap.add_argument("--seqpar", action="store_true",
                    help="sequence-shard the residual stream over the TP axis")
    ap.add_argument("--rules-preset", default=None, choices=[None, "fsdp_only"],
                    help="fsdp_only: no tensor parallelism -- params sharded "
                         "over every mesh axis (ZeRO-3), activations batch-"
                         "sharded; trades per-layer weight all-gathers for "
                         "the elimination of TP activation all-reduces")
    ap.add_argument("--rwkv-chunk", type=int, default=None)
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--weight-quant", default="none", choices=["none", "int8"],
                    help="weight-only int8 storage (serving)")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--out", default=None, help="artifact directory (JSON per cell)")
    ap.add_argument("--jobs", type=int, default=min(4, os.cpu_count() or 1),
                    help="cells planned at once, each in a process of its own")
    args = ap.parse_args(argv)

    quant = QuantConfig(mode=args.quant, rotate=args.rotate,
                        kv_quant=args.quant != "none", backend="torch")
    opt_cfg = OptConfig(state_dtype=args.opt_state)

    archs = DRYRUN_ARCHS if args.all else [args.arch]
    shapes = list(shp.SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    t0 = time.time()
    cells = [dict(arch=arch, shape_name=shape_name, multi_pod=multi, quant=quant,
                  opt_cfg=opt_cfg, remat=args.remat, seqpar=args.seqpar,
                  rules_preset=args.rules_preset, rwkv_chunk=args.rwkv_chunk,
                  microbatches=args.microbatch, weight_quant=args.weight_quant)
             for arch in archs for shape_name in shapes for multi in meshes]
    results = []
    with _pool(max(1, args.jobs)) as pool:
        futures = {_in_child(pool, kw): kw for kw in sorted(cells, key=_weight, reverse=True)}
        for fut in cf.as_completed(futures):
            kw = futures[fut]
            r = _result(fut, kw)
            _print_cell(r)
            results.append(r)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                tag = f"{kw['arch']}__{kw['shape_name']}__{r['mesh']}"
                if args.quant != "none" or args.rotate != "none":
                    tag += f"__{args.quant}_{args.rotate}"
                if args.tag:
                    tag += f"__{args.tag}"
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(r, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run cells: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    print(f"dry-run seconds: {time.time() - t0:.1f}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
