"""PyTorch port, the dry run (``repro_torch.launch.dryrun``) and what it
runs: the step builders of ``launch.steps`` on the meta device, the
per-rank cost of ``launch.cost_analysis``, the collective recorder and the
fake worlds of ``launch.mesh``; plus the legacy ``(wq, sw)`` weight form of
``core.api.QuantDotSpec``. Held against the reference on the CPU:

  * ``roofline_terms`` and the ring models are the reference's, given its
    constants (exact);
  * the FLOPs of the prefill, serve and train steps of scaled-down
    llama3-8b, phi4-mini and mixtral at world 1 are those of
    ``analyze_hlo`` over the reference's compiled steps: exactly, with
    recomputation off. With ``remat="dots"`` each recomputes its own set
    (the port every block's forward, the reference its batched dots), and
    the recompute stage's FLOPs are held each to its own count;
  * every rank's argument bytes at 16 x 16 and 2 x 16 x 16, for every cell
    of the reference's ten architectures, are the byte sum of the
    reference's shardings' shard shapes (parameters, optimizer state,
    batch, caches): exactly;
  * the collectives a fake world of 2 records are a real two-rank gloo
    run's, kind for kind and byte for byte, and a hand count's;
  * the skipped cells and their reasons are the reference's.

The reference's ``launch.dryrun`` sets ``XLA_FLAGS`` when imported: it is
imported with the flags put back at once (``_reference_dryrun``), and its
512-device shardings are resolved in a subprocess of their own. Every fake
world of the port runs in a spawned child process.
"""
import concurrent.futures as cf
import dataclasses
import functools
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["llama3-8b", "phi4-mini-3.8b", "mixtral-8x7b"]
SHAPE = (2, 32)                      # (batch, seq) of the FLOP holds


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.update(extra)
    return env


def _reference_dryrun():
    """The reference's ``launch.dryrun`` with ``XLA_FLAGS`` put back at once,
    so neither this process's jax nor any process it starts sees them."""
    prev = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return dryrun


# ------------------------------------------------ the reference's shardings
_REF_ARG_BYTES = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.launch import shapes as shp
from repro.launch import steps as S
from repro.launch.dryrun import decode_rules
from repro.launch.mesh import make_production_mesh
from repro.optim import OptConfig

def nbytes(shardings, shapes):
    return sum(int(np.prod(sh.shard_shape(sd.shape))) * jnp.dtype(sd.dtype).itemsize
               for sh, sd in zip(jax.tree.leaves(shardings), jax.tree.leaves(shapes)))

out = {}
opt = OptConfig()
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in json.loads(sys.argv[1]):
        cfg = get_config(arch)
        for name, shape in shp.SHAPES.items():
            if shp.shape_applicable(cfg, shape):
                continue
            with shd.sharding_rules(mesh, decode_rules(cfg, shape)):
                n = nbytes(S.param_shardings(cfg, mesh), S.param_shapes(cfg))
                if shape.kind == "train":
                    n += nbytes(S.opt_state_shardings(cfg, opt, mesh),
                                S.opt_state_shapes(cfg, opt))
                if shape.kind == "decode":
                    n += nbytes(S.cache_shardings(cfg, shape.batch, shape.seq, mesh),
                                shp.cache_specs(cfg, shape.batch, shape.seq))
                    tok = shd.make_resolver(mesh)(("batch", None), (shape.batch, 1))
                    n += int(np.prod(tok.shard_shape((shape.batch, 1)))) * 4 + 4
                else:
                    n += nbytes(S.batch_shardings(cfg, shape, mesh),
                                shp.batch_specs(cfg, shape))
            out[f"{arch}|{name}|{int(multi)}"] = n
print(json.dumps(out))
"""


def _port_arg_bytes(archs):
    """Every cell's per-rank argument bytes as the dry run counts them, on
    rank 0 of fake worlds of 256 and 512 ranks."""
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.launch.shapes import SHAPES, shape_applicable
    from repro_torch.optim import OptConfig

    out = {}
    for multi in (False, True):
        with fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, rank=0)
            for arch in archs:
                cfg = dryrun._cell_config(arch, QuantConfig(backend="torch"))
                for name, shape in SHAPES.items():
                    if not shape_applicable(cfg, shape):
                        out[f"{arch}|{name}|{int(multi)}"] = dryrun.argument_bytes(
                            cfg, shape, OptConfig(), mesh, dryrun.cell_rules(cfg, shape))
    return out


# ------------------------------------------------------ the recorder's runs
def _small(arch="llama3-8b"):
    from repro_torch.configs import get_config

    return get_config(arch).scaled_down()


def _records(kind, mesh, cfg, shape, params=None, device="meta"):
    """The collectives one step of ``kind`` records on this rank: on the
    meta device (the dry run's state), or, given whole ``params``, on their
    device."""
    from repro_torch.distributed.collectives import shard_tree
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import record_collectives
    from repro_torch.launch.shapes import make_batch
    from repro_torch.optim import OptConfig, init_opt_state

    opt = OptConfig()
    if params is None:
        with record_collectives() as seen:
            dryrun.plan(cfg, shape, opt, mesh)
        return [tuple(c) for c in seen]
    batch = S.batch_to(make_batch(cfg, shape, seed=0), device)
    with record_collectives() as seen:
        if kind == "train":
            pparts, oparts = S.state_parts(cfg, opt, mesh)
            state = shard_tree(init_opt_state(params, opt), oparts, mesh)
            S.make_train_step(cfg, opt, mesh=mesh)(shard_tree(params, pparts, mesh),
                                                   state, batch)
        else:
            S.make_prefill_step(cfg, mesh=mesh)(
                shard_tree(params, S.param_parts(cfg, mesh), mesh), batch)
    return [tuple(c) for c in seen]


RECORDED = [("prefill", (1, 2)), ("train", (1, 2)), ("train", (2, 1))]


def _gloo_rank(rank, world):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models.lm import init_lm

    cfg = _small()
    out = {}
    for kind, shape in RECORDED:
        mesh = Mesh(shape, ("data", "model"), rank=rank)
        out[(kind, shape)] = _records(kind, mesh, cfg, ShapeSpec("t", kind, 16, 4),
                                      init_lm(cfg, seed=0, device="cpu"), "cpu")
    return out


def _fake_runs():
    """The same steps on rank 0 of a fake world of 2 (meta device); then a
    scaled-down mixtral train step on rank 0 of a (2, 2, 2) fake world."""
    from repro_torch.launch.mesh import Mesh, fake_world
    from repro_torch.launch.shapes import ShapeSpec

    out = {}
    with fake_world(2):
        for kind, shape in RECORDED:
            mesh = Mesh(shape, ("data", "model"), rank=0)
            out[(kind, shape)] = _records(kind, mesh, _small(), ShapeSpec("t", kind, 16, 4))
    with fake_world(8):
        mesh = Mesh((2, 2, 2), ("pod", "data", "model"), rank=0)
        out["minipod"] = _records("train", mesh, _small("mixtral-8x7b"),
                                  ShapeSpec("t", "train", 64, 8))
    return out


@pytest.fixture(scope="module", autouse=True)
def background():
    """The runs that take seconds, started with the module's first test,
    beside each other: the reference's shardings (a subprocess with 512
    host devices), the CLI, the port's argument bytes and the fake-world
    runs (spawned processes), the gloo ranks and ``run_cell`` (from threads
    of this process)."""
    from repro_torch.launch.dryrun import DRYRUN_ARCHS
    from repro_torch.testing.ranks import run_ranks

    jarchs = [a.replace("-", "_").replace(".", "_") for a in DRYRUN_ARCHS]
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_ARG_BYTES, json.dumps(jarchs)], cwd=ROOT,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=512",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    tmp = tempfile.TemporaryDirectory()
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "phi4-mini-3.8b",
         "--shape", "prefill_32k", "--out", tmp.name], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pool = cf.ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"))
    threads = cf.ThreadPoolExecutor(1)
    jobs = {"ref": ref, "cli": cli, "tmp": tmp.name,
            "port": pool.submit(_port_arg_bytes, list(DRYRUN_ARCHS)),
            "fake": pool.submit(_fake_runs),
            "gloo": threads.submit(run_ranks, _gloo_rank, 2)}
    yield jobs
    threads.shutdown()
    pool.shutdown()
    for p in (ref, cli):
        if p.poll() is None:
            p.kill()
    tmp.cleanup()


def _finished(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


# ------------------------------------------------------------------ tests
def test_run_cell_leaves_no_group_or_environment():
    """``run_cell`` plans in a child process: the caller has no process
    group and the same environment after it (and after importing the
    module), and a decode cell on 512 ranks aliases its caches."""
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch import dryrun
    from repro_torch.optim import OptConfig

    env = dict(os.environ)
    r = dryrun.run_cell("whisper-base", "decode_32k", True, QuantConfig(backend="torch"),
                        OptConfig(), verbose=False)
    assert not dist.is_initialized() and dict(os.environ) == env
    # and importing the module, in a fresh process
    subprocess.run([sys.executable, "-c", (
        "import os, torch.distributed as d; e = dict(os.environ); "
        "import repro_torch.launch.dryrun; "
        "assert dict(os.environ) == e and not d.is_initialized()")],
        cwd=ROOT, env=_env(), check=True)
    assert r["status"] == "ok" and r["n_chips"] == 512, r.get("error")
    mem = r["memory"]
    assert 0 < mem["alias_bytes"] <= mem["output_bytes"]
    assert mem["per_device_total_gb"] * 1e9 >= mem["argument_bytes"]


def test_roofline_and_ring_models_are_the_reference(monkeypatch):
    """``roofline_terms`` given the reference's TPU constants is its
    ``roofline_terms``; each collective's wire bytes are what
    ``analyze_hlo`` bills the same collective in an HLO module."""
    from repro.launch.hlo_analysis import _ring_factor, analyze_hlo

    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Collective

    jd = _reference_dryrun()
    for name in ("PEAK_FLOPS", "HBM_BW"):
        monkeypatch.setattr(dryrun, name, getattr(jd, name))
    monkeypatch.setattr(dryrun, "NET_BW", jd.ICI_BW)
    for per in ({"flops_per_device": 3e15, "hbm_bytes_per_device": 2e12,
                 "collective_total_bytes_per_device": 7e10},
                {"flops_per_device": 1e12, "hbm_bytes_per_device": 5e12,
                 "collective_total_bytes_per_device": 1e9},
                {"flops_per_device": 1e12, "hbm_bytes_per_device": 1e9,
                 "collective_total_bytes_per_device": 9e11}):
        assert dryrun.roofline_terms(per, 256) == jd.roofline_terms(per, 256)
    for n in (1, 2, 16, 256, 512):
        assert CA.ring_factor("all-gather", n) == _ring_factor("all-gather", n)

    size = 64 * 64 * 4
    for op, out_shape, nbytes in [("all-reduce", "f32[64,64]", size),
                                  ("all-gather", "f32[64,64]", size),
                                  ("reduce-scatter", "f32[16,64]", size),
                                  ("all-to-all", "f32[64,64]", size),
                                  ("collective-permute", "f32[64,64]", size)]:
        attrs = "replica_groups={{0,1,2,3}}" + (", to_apply=%sum" if op == "all-reduce"
                                                 else "")
        hlo = f"""HloModule m, entry_computation_layout={{()->f32[]}}

%sum (a: f32[], b: f32[]) -> f32[] {{
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %r = f32[] add(%a, %b)
}}

ENTRY %main (p: f32[64,64]) -> f32[] {{
  %p = f32[64,64] parameter(0)
  %o = {out_shape} {op}(%p), {attrs}
  %z = f32[] constant(0)
  ROOT %s = f32[] reduce(%o, %z), dimensions={{0,1}}, to_apply=%sum
}}
"""
        want = analyze_hlo(hlo)["collective_wire_bytes_per_device"][op]
        got = CA.collective_costs([Collective(op, nbytes, 4, ("model",))])
        assert got["wire"] == {op: want} and got["counts"] == {op: 1}, op


@functools.lru_cache(maxsize=None)
def _ref_flops(arch, kind, remat):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.launch import shapes as jshp
    from repro.launch import steps as jsteps
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.optim import OptConfig as JOpt

    cfg = dataclasses.replace(jget(arch).scaled_down(), remat=remat)
    B, S = SHAPE
    if kind == "train":
        fn = jsteps.make_train_step(cfg, JOpt())
        args = (jsteps.param_shapes(cfg), jsteps.opt_state_shapes(cfg, JOpt()),
                jshp.batch_specs(cfg, jshp.ShapeSpec("t", kind, S, B)))
    elif kind == "prefill":
        fn = jsteps.make_prefill_step(cfg)
        args = (jsteps.param_shapes(cfg), jshp.batch_specs(cfg, jshp.ShapeSpec("t", kind, S, B)))
    else:
        fn = jsteps.make_serve_step(cfg)
        args = (jsteps.param_shapes(cfg), jshp.cache_specs(cfg, B, S),
                jax.ShapeDtypeStruct((B, 1), jnp.int32), jax.ShapeDtypeStruct((), jnp.int32))
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())["flops_per_device"]


@functools.lru_cache(maxsize=None)
def _port_flops(arch, kind, remat):
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.optim import OptConfig

    cfg = dataclasses.replace(_small(arch), remat=remat)
    B, S = SHAPE
    return dryrun.plan(cfg, ShapeSpec("t", kind, S, B),
                       OptConfig())["cost_analysis"]["flops_per_device"]


def _port_batched_flops(arch):
    """FLOPs of the batched products (``bmm`` / ``baddbmm``: the einsums
    with batch dims) in the port's forward of the prefill."""
    from torch.utils.flop_counter import flop_registry

    from repro_torch.launch import steps as S
    from repro_torch.launch.cost_analysis import MetaMemo
    from repro_torch.launch.shapes import ShapeSpec

    aten = torch.ops.aten
    total = []

    class Batched(MetaMemo):
        def _count(self, out, flops, nbytes):
            pass

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if func.overloadpacket in (aten.bmm, aten.baddbmm):
                total.append(flop_registry[func.overloadpacket](*args, **(kwargs or {}),
                                                                out_val=out))
            return out

    cfg = _small(arch)
    B, T = SHAPE
    with Batched():
        S.make_prefill_step(cfg)(S.param_shapes(cfg),
                                 S.batch_shapes(cfg, ShapeSpec("t", "prefill", T, B)))
    return sum(total)


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_at_world_one_are_the_reference_hlo(arch):
    """Tolerance 0: the prefill, the serve step and the train step with
    recomputation off count the reference's HLO FLOPs exactly (the same
    dots, the full attention square, the MoE's dense dispatch). The
    recompute stage differs by design and each side is held to its own
    count: the port's ``torch.utils.checkpoint`` runs each block's forward
    again up to the last tensor its backward saved (every product but a
    dense block's final ``w_down``), the reference's ``dots`` policy runs
    its batched dots again (the attention's scores and context, the MoE's
    dispatch and expert einsums) but for those whose output no gradient
    reads (the MoE's combine)."""
    for kind in ("prefill", "decode"):
        assert _port_flops(arch, kind, "dots") == _ref_flops(arch, kind, "dots"), kind
    none = _port_flops(arch, "train", "none")
    assert none == _ref_flops(arch, "train", "none")
    cfg = _small(arch)
    B, S = SHAPE
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    blocks = _port_flops(arch, "prefill", "dots") - 2.0 * B * S * d * cfg.padded_vocab
    combine = 0.0
    if cfg.num_experts:
        E, K = cfg.num_experts, cfg.experts_per_token
        cap = max(1, int(cfg.capacity_factor * S * K / E))
        combine = L * 2.0 * B * S * E * cap * d
    else:
        blocks -= L * 2.0 * B * S * f * d
    assert _port_flops(arch, "train", "dots") - none == blocks
    assert _ref_flops(arch, "train", "dots") - none == _port_batched_flops(arch) - combine


def test_argument_bytes_are_the_reference_shard_shapes(background):
    """Tolerance 0: every rank's argument bytes of every cell of the
    reference's ten architectures, at 16 x 16 and 2 x 16 x 16 (the
    parameter and optimizer-state shards, the batch rows, the caches' shards
    under ``decode_rules``), are the byte sums of the reference's shardings'
    shard shapes."""
    want = json.loads(_finished(background["ref"]).strip().splitlines()[-1])
    got = background["port"].result(timeout=300)
    jname = {a.replace("-", "_").replace(".", "_"): a for a in
             [k.split("|")[0] for k in got]}
    want = {f"{jname[k.split('|')[0]]}|{k.split('|', 1)[1]}": v for k, v in want.items()}
    assert len(got) == 64 and got == want


def test_recorder_matches_gloo_and_a_hand_count(background):
    """A fake world of 2 on the meta device records what a real two-rank
    gloo run of the same steps records, kind for kind and byte for byte: a
    (1, 2) prefill, a (1, 2) and a (2, 1) train step of a 2-layer
    scaled-down llama3-8b. The (1, 2) prefill is also its hand count."""
    ranks = background["gloo"].result(timeout=300)
    fake = background["fake"].result(timeout=300)
    for key in RECORDED:
        assert fake[key] == ranks[0][key], key
        assert [(k, n) for k, n, *_ in ranks[1][key]] == [(k, n) for k, n, *_ in fake[key]]
    cfg = _small()
    B, S, d, f = 4, 16, cfg.d_model, cfg.d_ff
    m = ("model",)
    rows = B * S * d * 4                                # f32 sums of (B, S, d)
    kv = d * cfg.num_kv_heads * cfg.head_dim * 2        # wk / wv rest split, used whole
    layer = [("all-gather", kv, 2, m), ("all-gather", kv, 2, m),
             ("all-gather", f * d * 2, 2, m),           # w_down's rows, contracted whole
             ("all-reduce", rows, 2, m),                # attention output, row-split
             ("all-gather", B * S * f * 2, 2, m)]       # the MLP's hidden columns
    want = ([("all-reduce", rows, 2, m)]                # the vocabulary-split lookup
            + layer * cfg.num_layers
            + [("all-gather", B * S * cfg.padded_vocab * 2, 2, m)])   # the logits
    assert fake[("prefill", (1, 2))] == want


def test_minipod_train_records_collectives_over_pod(background):
    """Scaled-down mixtral's train step on rank 0 of a (2, 2, 2) fake world
    (pod, data, model): its gradients reduce over 'pod' too (the twin of
    the reference's miniature multi-pod dry run)."""
    seen = background["fake"].result(timeout=300)["minipod"]
    assert seen and sum(n for _, n, *_ in seen) > 0
    assert any("pod" in axes for *_, axes in seen)
    assert {k for k, *_ in seen} >= {"all-gather", "reduce-scatter", "all-reduce"}


def test_skipped_cells_are_the_reference():
    """Every (architecture, shape) the reference skips, the port skips with
    the same reason, and runs every other: no process is started for a
    skipped cell."""
    from repro.configs import ARCH_IDS as JARCH_IDS
    from repro.configs import get_config as jget
    from repro.launch import shapes as jshp

    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch import dryrun
    from repro_torch.optim import OptConfig

    skipped = 0
    for jarch in JARCH_IDS:
        for name in jshp.SHAPES:
            want = jshp.shape_applicable(jget(jarch), jshp.SHAPES[name])
            arch = jget(jarch).name
            cfg = dryrun._cell_config(arch, QuantConfig(backend="torch"))
            assert dryrun.shp.shape_applicable(cfg, dryrun.shp.SHAPES[name]) == want
            if want:
                r = dryrun.run_cell(arch, name, True, QuantConfig(backend="torch"),
                                    OptConfig(), verbose=False)
                assert (r["status"], r["reason"]) == ("skipped", want)
                skipped += 1
    assert skipped == 9
    assert [jget(a).name for a in JARCH_IDS[:10]] == list(dryrun.DRYRUN_ARCHS)


KEYS = {"arch", "shape", "mesh", "quant", "status", "build_s", "trace_s", "n_chips",
        "memory", "aten_ops", "cost_analysis", "params", "model_flops",
        "useful_flops_ratio", "roofline"}


def test_cli_writes_one_ok_cell(background):
    """``--arch phi4-mini-3.8b --shape prefill_32k`` writes one JSON under
    the reference's file name, status ok, with the reference's result keys
    (``cost_analysis`` and ``aten_ops`` for its ``hlo_analysis`` and
    ``xla_cost_analysis``)."""
    out = _finished(background["cli"])
    assert "dry-run cells: 1 ok, 0 skipped, 0 errors" in out
    files = os.listdir(background["tmp"])
    assert files == ["phi4-mini-3.8b__prefill_32k__pod16x16.json"]
    with open(os.path.join(background["tmp"], files[0])) as f:
        r = json.load(f)
    assert r["status"] == "ok" and set(r) == KEYS and r["n_chips"] == 256
    assert set(r["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                "alias_bytes", "per_device_total_gb"}
    assert set(r["cost_analysis"]) == {
        "flops_per_device", "hbm_bytes_per_device", "collective_wire_bytes_per_device",
        "collective_counts", "collective_total_bytes_per_device"}
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant",
                                  "bound_s"}
    # phi4's 24 query heads do not split 16 ways: its attention runs whole
    # on every 'model' rank, and the ratio shows it
    assert r["useful_flops_ratio"] < 0.1


def test_meta_decode_writes_its_row_without_a_host_read():
    """The decode step's KV write at a shared scalar position reads the
    position on the device, and the guarded step's ok-vector reads nothing
    on the host: both serve steps run on meta tensors at world 1, where a
    host read raises."""
    from repro_torch.launch import steps as S

    cfg = _small()
    for guard in (False, True):
        caches = S.cache_shapes(cfg, 2, 32)
        tok, second, out = S.make_serve_step(cfg, guard=guard)(
            S.param_shapes(cfg), caches, torch.empty((2, 1), dtype=torch.int32, device="meta"),
            torch.zeros((), dtype=torch.int32, device="meta"))
        assert tok.shape == (2, 1) and out is caches
        assert second.shape == ((2,) if guard else (2, 1, cfg.padded_vocab))


def test_step_cost_holds_qtensor_arguments_live():
    """A step's QTensor arguments count toward the peak of live bytes:
    ``cost_analysis.tensors`` walks into them, as ``argument_bytes`` does,
    so an int8-weight cell's ``temp_bytes`` leaves them out."""
    from repro_torch.core.wquant import QTensor
    from repro_torch.launch.cost_analysis import StepCost, tensors

    q = torch.empty((64, 32), dtype=torch.int8, device="meta")
    s = torch.empty((1, 32), dtype=torch.float32, device="meta")
    tree = {"w": QTensor(q, s), "b": [torch.empty(8, device="meta")]}
    assert [tuple(t.shape) for t in tensors(tree)] == [(64, 32), (1, 32), (8,)]
    cost = StepCost()
    cost.track(tree)
    assert cost.peak == 64 * 32 + 32 * 4 + 8 * 4


def test_serve_step_is_the_engine_decode():
    """``make_serve_step`` and the engine's decode share ``decode_tokens``:
    the same tokens and caches on the CPU, the guarded form's ok-vector all
    true on healthy logits."""
    from repro_torch.launch import steps as S
    from repro_torch.models.lm import init_lm, lm_prefill, pad_kv_caches

    cfg = _small()
    params = init_lm(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 500, (2, 8))).to(torch.int32)
    _, caches = S.make_prefill_step(cfg)(params, {"tokens": toks})
    assert [tuple(c["k"].shape) for c in caches] == [
        tuple(c["k"].shape[:1]) + (8,) + tuple(c["k"].shape[2:])
        for c in S.cache_shapes(cfg, 2, 8)]
    want_logits, want_caches = lm_prefill(cfg, params, {"tokens": toks})
    a = pad_kv_caches(cfg, want_caches, 12)
    b = pad_kv_caches(cfg, caches, 12)
    pos = torch.tensor(8, dtype=torch.int32)
    tok = torch.argmax(want_logits[:, -1], -1)[:, None].to(torch.int32)
    t1, logits, _ = S.make_serve_step(cfg)(params, a, tok, pos)
    t2, ok, _ = S.make_serve_step(cfg, guard=True)(params, b, tok, pos)
    assert torch.equal(t1, t2) and t1.dtype == torch.int32 and bool(ok.all())
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    t3, _, _ = S.decode_tokens(cfg, params, pad_kv_caches(cfg, caches, 12), tok, pos)
    assert torch.equal(t3[:, None].to(torch.int32), t1)
    assert logits.shape == (2, 1, cfg.padded_vocab)


# ------------------------------------------------ the legacy tuple form
@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_tuple_weight_form_is_the_qtensor_form_and_the_reference(mode):
    """A ``(wq, sw)`` tuple bound to a QuantDotSpec gives the QTensor
    form's output bit for bit, and the reference's tuple form's (int8
    bitwise; fp8 within 2^-7 of the row's largest |output|, the quant_dot
    tests' tolerance); a tuple in another storage dtype raises, as the
    reference's does."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from repro.core.api import QuantDotSpec as JQuantDotSpec
    from repro.core.wquant import quantize_weight as jquantize_weight

    from repro_torch.bridge import to_torch
    from repro_torch.core.api import QuantDotSpec
    from repro_torch.core.wquant import QTensor

    n, d = 128, 48
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, n)) * 3).astype(np.float32)
    w = (rng.standard_normal((n, d)) / np.sqrt(n)).astype(ml_dtypes.bfloat16)
    jt = jax.jit(lambda a: jquantize_weight(a, mode))(jnp.asarray(w))
    q, s = to_torch(np.asarray(jt.q), "cpu"), to_torch(np.asarray(jt.scale), "cpu")
    xt = torch.from_numpy(x).to(torch.bfloat16)
    spec = QuantDotSpec(n=n, mode=mode, backend="torch")
    got = spec.bind((q, s))(xt)
    assert torch.equal(got, spec.bind(QTensor(q, s, mode))(xt))
    want = jax.jit(lambda a: JQuantDotSpec(n=n, mode=mode, backend="xla").bind(
        (jt.q, jt.scale))(a))(jnp.asarray(x, jnp.bfloat16))
    g = got.to(torch.float32).numpy()
    wnp = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if mode == "int8":
        np.testing.assert_array_equal(g, wnp)
    else:
        assert (np.abs(g - wnp) <= 2.0 ** -7 * np.abs(wnp).max(-1, keepdims=True)).all()
    other = "fp8_e4m3" if mode == "int8" else "int8"
    with pytest.raises(ValueError, match="storage dtype"):
        QuantDotSpec(n=n, mode=other, backend="torch").bind((q, s))
    # a spec that does not quantize dequantizes the tuple and runs raw
    plain = QuantDotSpec(n=n, mode="none", rotate=False).bind((q, s))(xt)
    assert torch.equal(plain, xt @ QTensor(q, s, mode).dequant(torch.bfloat16))
