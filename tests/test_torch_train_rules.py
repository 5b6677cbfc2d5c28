"""PyTorch port, per-launch sharding rules in training:
``launch.steps.make_train_step(..., rules_overrides=)`` with the reference's
presets (``launch.dryrun``: ``FSDP_ONLY_RULES``, residual sequence
parallelism ``{"seqpar": "model"}``, the MoE experts over 'data'), on CPU
ranks of a gloo process group (``repro_torch.testing.ranks``), held against
the step without a mesh (world 1), and world 1 against the reference's
un-meshed ``jax.jit(make_train_step(cfg, opt_cfg))`` on the port's seeded
weights (``bridge.to_reference``; backend 'xla', excess precision off).

Three scaled-down families, 2 layers, vocabulary 512, raw bf16 weights
(the sites quantize them on the fly), int8 + Hadamard, remat per block,
batch 4 x 16 tokens, lr 1e-3:

  * phi4: phi4-mini-3.8b at d_model 256, 8 query and 4 KV heads of 32,
    d_ff 512 (the fused down site);
  * mixtral: 2 'moe' layers, d_model 256, 4 / 2 heads of 64, 4 experts
    top-2, d_ff 896 (the grouped expert site); int8, as the reference's fp8
    expert einsum fails on XLA CPU;
  * rwkv: rwkv6-7b's own ``scaled_down`` (the time mix's chunked form, the
    channel mix's down site).

Held:

  * ``cell_rules`` composes the overrides as the reference's ``run_cell``;
  * at (1, 1) every preset is the no-mesh step bit for bit (step-0 loss and
    gradients, the parameters after 2 steps);
  * world 1 against the reference's step, from the same weights: the loss
    within ``LOSS_TOL``, each leaf's first moment after the step (0.1 x the
    clipped gradient) within its limit in ``GRAD_TOLS`` relative L2 [phi4
    0.0478 at layer 1's V site, a known divergence, its other leaves at most
    0.0253; mixtral 0.0107]; the control, phi4 without its rotations,
    outside on the down projections;
  * ``FSDP_ONLY_RULES`` at (1, 2) -- every layer whole on every rank, the
    weights and moments split over ('data', 'model'), the vocabulary table
    storage only -- is world 1 bit for bit in step 0's loss and gathered
    gradients and both steps' losses; the parameters and moments after 2
    steps differ only where the global norm's sum over the two shards
    rounds 1 ulp from world 1's [parameters 3.2e-13, moments 1.7e-7: within
    ``ULP_TOL``], the int8 moments gathered to world 1's ``(q, s)`` within
    one code; the controls -- the backward summing over 'model' too, which
    every rank of 'model' computed alike [gradients 1.0], and the next
    shard of 'model' cut [parameters 0.048] -- outside; at (2, 1) and
    (2, 2), where ``_GatherParam``'s backward raised before, step 0's loss,
    gradient norm and gradients and the parameters after one step within
    the row-split limits of ``tests/test_torch_mesh_families.py``
    (``LOSS_TOL``, ``GNORM_TOL``, ``PARAM_TOL``) and ``ROWS_TOL`` [at most
    0.0032 and 0.0015 relative]; the control, every rank's own shard tiled
    into each gather, outside all four;
  * 'seqpar' at (1, 2) (each rank's residual stream S / 2 of the positions
    between the blocks) for the three families: the step-0 loss bitwise the
    same ranks' without it (the reduce-scatter adds the same two f32
    partials as the all-reduce), every gradient leaf within ``SEQPAR_TOL``
    of theirs -- between the witness, world 1 with its block norms run on
    the two halves of the positions apart (``forcing.split_positions``),
    and the control, the norms' gradient not summed over 'model', outside
    -- and the bytes saved at the blocks' inputs
    (``forcing.saved_block_inputs``) exactly half [the gradients read
    1.18e-7 to 1.27e-7, the witness 1.14e-7 to 1.25e-7, the control 0.82
    and 0.86]; together with ``FSDP_ONLY_RULES`` at (2, 2) within the
    row-split limits;
  * 'seqpar' at (1, 2) for the other layer kinds (``KINDS``: Mamba2, the
    encoder and cross attention, a shared expert beside attention that
    stays whole): the loss bitwise, the gradients within ``SEQPAR_TOL``
    [at most 1.31e-7], the saved bytes half;
  * mixtral at (2, 1) with its experts over 'data' (``{"experts": "data",
    "moebatch": None}``: the tokens gathered, the experts' sum kept to a
    rank's rows): loss and aux within ``LOSS_TOL`` of world 1's [equal],
    every gradient leaf within ``ROWS_TOL`` [0.0103]; the control, the
    kept rows' backward leaving the other rows' gradient zero, outside
    [0.82];
  * a step under ``{"kvseq": "model"}`` at (1, 2) never calls
    ``kvseq_all_reduce`` and is the default rules' step bit for bit;
  * a checkpoint saved under ``FSDP_ONLY_RULES`` at (1, 2) restores, shards
    and gathers under the default rules to the same whole tensors.

Readings: ``python tests/test_torch_train_rules.py`` prints them.
"""
import contextlib
import os
import tempfile
import threading

import numpy as np
import pytest
import torch

from repro_torch.testing import forcing
from repro_torch.testing.ranks import run_ranks

# the reference (jax) is imported inside the functions that run it: the
# ranks, which import this module, run the port alone

FAMILIES = {   # family -> (reference config, port config, overrides)
    "phi4": ("phi4_mini_3_8b", "phi4-mini-3.8b",
             dict(num_heads=8, head_dim=32, d_model=256, num_kv_heads=4, d_ff=512)),
    "mixtral": ("mixtral_8x7b", "mixtral-8x7b",
                dict(num_heads=4, head_dim=64, d_model=256, num_kv_heads=2, d_ff=896,
                     num_experts=4, experts_per_token=2, groups=((("moe",), 2),))),
    "rwkv": ("rwkv6_7b", "rwkv6-7b", {}),
}
# the other layer kinds, under 'seqpar' at (1, 2) only: Mamba2 beside
# attention (zamba2-7b at scale 0.005, whose SSD heads split), the encoder
# and the cross attention (whisper-base), a MoE layer with a shared expert
# beside attention heads that do not split (llama4-maverick: 5 heads)
KINDS = {"zamba2": "zamba2-7b", "whisper": "whisper-base",
         "maverick": "llama4-maverick-400b-a17b"}
BATCH, SEQ, STEPS = 4, 16, 2
AS_WRITTEN = {"xla_allow_excess_precision": False}
LOSS_TOL, GNORM_TOL, PARAM_TOL = 2e-3, 5e-3, 2e-3    # test_torch_mesh_families.py's
# the families whose (1, 1) presets are held against the reference's step
REFERENCE_HELD = ("phi4", "mixtral")
# per leaf, by a substring of its path (the longest that matches): phi4's V
# site, whose int8 fake-quantize reaches a row's gradient through its scale
# alone, so bf16 flips born upstream move it (the divergence that
# tests/test_torch_v_site_gradient.py shows at this width: 0.163 there)
GRAD_TOLS = {"phi4": {"['attn']['wv']": 0.2, "": 0.03}, "mixtral": {"": 0.03}}
SEQPAR_TOL = 1e-5
ULP_TOL = 1e-6
ROWS_TOL = 0.03
RULES = {
    "default": None,
    "fsdp": "fsdp_only",
    "seqpar": {"seqpar": "model"},
    "seqpar+fsdp": "seqpar+fsdp",
    "experts": {"experts": "data", "moebatch": None},
    "kvseq": {"kvseq": "model"},
}


# ------------------------------------------------------------- configs
def _config(fam: str, rotate: str = "hadamard"):
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch.serve_loop import scaled_config

    quant = QuantConfig(mode="int8", rotate=rotate, backend="cuda", kv_quant=True)
    if fam == "zamba2":
        return scaled_config(get_config(KINDS[fam]), 0.005).with_quant(quant)
    if fam in KINDS:
        return get_config(KINDS[fam]).scaled_down().with_quant(quant)
    _, tname, over = FAMILIES[fam]
    return get_config(tname).scaled_down(**over).with_quant(quant)


def _reference_config(fam: str):
    from repro.configs import get_config as jget_config
    from repro.core.quant import QuantConfig as JQuantConfig

    jname, _, over = FAMILIES[fam]
    return jget_config(jname).scaled_down(**over).with_quant(
        JQuantConfig(mode="int8", rotate="hadamard", backend="xla", kv_quant=True))


def _opt(state: str = "f32"):
    from repro_torch.optim import OptConfig

    return OptConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS, state_dtype=state)


def _rules(key: str):
    """The overrides of ``RULES[key]``, the presets from ``launch.dryrun``."""
    from repro_torch.launch.dryrun import FSDP_ONLY_RULES

    r = RULES[key]
    if r == "fsdp_only":
        return dict(FSDP_ONLY_RULES)
    if r == "seqpar+fsdp":
        return dict(FSDP_ONLY_RULES, seqpar="model")
    return r


def _batches(cfg, steps: int):
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import batch_to

    ds = SyntheticDataset(cfg, ShapeSpec("rules", "train", SEQ, BATCH), seed=0)
    return [batch_to(ds.batch(i), "cpu") for i in range(steps)]


# ------------------------------------------------------------- controls
@contextlib.contextmanager
def _other_shard():
    """FSDP control: the backward cuts the next shard of 'model' along a
    dim split partly over the rows' axes, not this rank's."""
    from repro_torch.distributed import collectives as C

    real = C._cut_outside_rows

    def cut(g, mesh, axes, rows, dim):
        n = 1
        for a in axes:
            n *= mesh.sizes()[a]
        return real(g.roll(g.shape[dim] // n, dims=dim), mesh, axes, rows, dim)

    C._cut_outside_rows = cut
    try:
        yield
    finally:
        C._cut_outside_rows = real


@contextlib.contextmanager
def _rows_not_gathered():
    """experts-over-'data' control: the kept rows' backward leaves the
    other rows' gradient zero (a plain narrow)."""
    from repro_torch.distributed import collectives as C

    real = C.keep_slice
    C.keep_slice = lambda t, axes, dim: C.current_mesh().chunk(t, axes, dim)
    try:
        yield
    finally:
        C.keep_slice = real


@contextlib.contextmanager
def _own_shard_tiled():
    """FSDP control of the forward: each gather repeats this rank's shard
    in place of the other ranks'."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import axes_of

    def tiled(t, parts, mesh, skip=()):
        for dim, p in enumerate(parts):
            n = mesh.group_size(axes_of(p))
            if dim not in skip and n > 1:
                t = torch.cat([t] * n, dim)
        return t

    real = C.gather_leaf
    C.gather_leaf = tiled
    try:
        yield
    finally:
        C.gather_leaf = real


CONTROLS = {None: contextlib.nullcontext, "sum_model": forcing.summed_over_model,
            "tiled": _own_shard_tiled,
            "other_shard": _other_shard,
            "norms": forcing.norms_unsummed, "rows": _rows_not_gathered}


# ----------------------------------------------------------- the runs
def _f64(t):
    return t.detach().to(torch.float64).numpy()


def _leaves(tree):
    from repro_torch import tree as T

    return [_f64(t) for t in T.leaves(tree)]


def _step0(cfg, params, batch, mesh, rules):
    """``forcing.step_zero``'s readings, the gradients as f64 arrays."""
    out = forcing.step_zero(cfg, params, batch, mesh, rules)
    out["grads"] = [_f64(t) for t in out["grads"]]
    return out


def _train(cfg, params, batches, mesh, rules, state: str = "f32"):
    """``len(batches)`` steps of ``make_train_step`` under ``rules``: the
    losses and gradient norms, the parameters and optimizer state after
    them (gathered whole)."""
    from repro_torch.distributed.collectives import gather_tree, shard_tree
    from repro_torch.launch.steps import make_train_step, state_parts
    from repro_torch.optim import init_opt_state

    opt = _opt(state)
    ostate = init_opt_state(params, opt)
    step = make_train_step(cfg, opt, mesh=mesh, rules_overrides=rules)
    if mesh is not None:
        pparts, oparts = state_parts(cfg, opt, mesh, rules)
        params, ostate = shard_tree(params, pparts, mesh), shard_tree(ostate, oparts, mesh)
    losses, gnorms, first = [], [], None
    for b in batches:
        params, ostate, m = step(params, ostate, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        if first is None:
            first = {"params": _leaves(gather_tree(params, pparts, mesh)
                                       if mesh is not None else params)}
            if (mesh is None or mesh.size == 1) and state == "f32":
                first["m"] = _leaves(ostate["m"])
    if mesh is not None:
        params, ostate = gather_tree(params, pparts, mesh), gather_tree(ostate, oparts, mesh)
    return {"losses": losses, "gnorms": gnorms, "params": _leaves(params),
            "state": _leaves(ostate), "p1": first["params"], "m1": first.get("m")}


def _job(fam, mesh, rules_key, control=None, steps=0, state="f32", rotate="hadamard"):
    """One run of ``fam`` under ``RULES[rules_key]`` (on ``mesh``, or
    without one) with ``CONTROLS[control]`` on: step 0's readings, and
    ``steps`` training steps' when asked."""
    from repro_torch.models.lm import init_lm

    cfg = _config(fam, rotate)
    rules = _rules(rules_key)
    batches = _batches(cfg, max(steps, 1))
    with CONTROLS[control]():
        out = _step0(cfg, init_lm(cfg, seed=0, device="cpu"), batches[0], mesh, rules)
        if steps:
            out.update(_train(cfg, init_lm(cfg, seed=0, device="cpu"), batches, mesh, rules,
                              state))
    return out


# (name, family, data, model, rules, control, steps, moments, set): every
# mesh run, on data x model ranks; the ranks run in three sets side by side
# ("a", "b": world 2; "c": world 4), world 1's (1, 1) runs ("w1") beside
# them in the test's own process
JOBS = [
    ("phi4 (1,1) fsdp", "phi4", 1, 1, "fsdp", None, 1, "f32", "w1"),
    ("phi4 (1,1) seqpar", "phi4", 1, 1, "seqpar", None, 1, "f32", "w1"),
    ("phi4 (1,1) seqpar+fsdp", "phi4", 1, 1, "seqpar+fsdp", None, 1, "f32", "w1"),
    ("mixtral (1,1) experts", "mixtral", 1, 1, "experts", None, 1, "f32", "w1"),
    ("phi4 (1,2) fsdp", "phi4", 1, 2, "fsdp", None, STEPS, "f32", "a"),
    ("phi4 (1,2) fsdp int8", "phi4", 1, 2, "fsdp", None, STEPS, "int8", "a"),
    ("phi4 (1,2) fsdp control", "phi4", 1, 2, "fsdp", "sum_model", 0, None, "a"),
    ("phi4 (1,2) fsdp other shard", "phi4", 1, 2, "fsdp", "other_shard", STEPS, "f32", "a"),
    ("phi4 (1,2) default", "phi4", 1, 2, "default", None, 0, None, "a"),
    ("phi4 (1,2) kvseq", "phi4", 1, 2, "kvseq", None, 0, None, "a"),
    ("phi4 (1,2) seqpar", "phi4", 1, 2, "seqpar", None, 0, None, "b"),
    ("phi4 (1,2) seqpar control", "phi4", 1, 2, "seqpar", "norms", 0, None, "b"),
    ("mixtral (1,2) default", "mixtral", 1, 2, "default", None, 0, None, "b"),
    ("mixtral (1,2) seqpar", "mixtral", 1, 2, "seqpar", None, 0, None, "b"),
    ("rwkv (1,2) default", "rwkv", 1, 2, "default", None, 0, None, "b"),
    ("rwkv (1,2) seqpar", "rwkv", 1, 2, "seqpar", None, 0, None, "b"),
    *[(f"{k} (1,2) {r}", k, 1, 2, r, None, 0, None, "a") for k in KINDS
      for r in ("default", "seqpar")],
    ("phi4 (2,1) fsdp", "phi4", 2, 1, "fsdp", None, 1, "f32", "b"),
    ("phi4 (2,1) fsdp tiled", "phi4", 2, 1, "fsdp", "tiled", 1, "f32", "b"),
    ("mixtral (2,1) experts", "mixtral", 2, 1, "experts", None, 0, None, "b"),
    ("mixtral (2,1) experts control", "mixtral", 2, 1, "experts", "rows", 0, None, "b"),
    ("phi4 (2,2) fsdp", "phi4", 2, 2, "fsdp", None, 1, "f32", "c"),
    ("phi4 (2,2) seqpar+fsdp", "phi4", 2, 2, "seqpar+fsdp", None, 1, "f32", "c"),
]


def _kvseq_calls(job):
    """``_job`` with every ``kvseq_all_reduce`` call counted."""
    from repro_torch.distributed import collectives as C

    calls, real = [0], C.kvseq_all_reduce

    def spy(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    C.kvseq_all_reduce = spy
    try:
        out = job()
    finally:
        C.kvseq_all_reduce = real
    out["kvseq_calls"] = calls[0]
    return out


def _checkpoint_round_trip(mesh):
    """phi4's parameters and f32 state after a step under ``FSDP_ONLY_RULES``,
    saved (every rank gathers, rank 0 writes), then restored, sharded and
    gathered under the default rules: the largest difference from the
    gathered tensors."""
    from repro_torch import tree as T
    from repro_torch.checkpoint.store import wait_for_writes
    from repro_torch.distributed.collectives import gather_tree, shard_tree
    from repro_torch.launch.steps import make_train_step, state_parts
    from repro_torch.launch.train import restore_state, save_state
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import init_opt_state

    cfg, opt, rules = _config("phi4"), _opt(), _rules("fsdp")
    params = init_lm(cfg, seed=0, device="cpu")
    ostate = init_opt_state(params, opt)
    layout = (mesh, *state_parts(cfg, opt, mesh, rules))
    params, ostate = shard_tree(params, layout[1], mesh), shard_tree(ostate, layout[2], mesh)
    params, ostate, _ = make_train_step(cfg, opt, mesh=mesh, rules_overrides=rules)(
        params, ostate, _batches(cfg, 1)[0])
    whole = T.leaves(gather_tree(params, layout[1], mesh)) + T.leaves(
        gather_tree(ostate, layout[2], mesh))
    box = [tempfile.mkdtemp() if mesh.rank == 0 else None]
    torch.distributed.broadcast_object_list(box, src=0)
    save_state(box[0], 1, cfg, params, ostate, layout)
    wait_for_writes()
    torch.distributed.barrier()
    fresh = init_lm(cfg, seed=1, device="cpu")
    p2, s2 = restore_state(box[0], 1, cfg, fresh, init_opt_state(fresh, opt), "cpu")
    pp, op = state_parts(cfg, opt, mesh)
    back = T.leaves(gather_tree(shard_tree(p2, pp, mesh), pp, mesh)) + T.leaves(
        gather_tree(shard_tree(s2, op, mesh), op, mesh))
    torch.distributed.barrier()
    if mesh.rank == 0:
        import shutil

        shutil.rmtree(box[0], ignore_errors=True)
    return max(float((a.detach().double() - b.detach().double()).abs().max())
               for a, b in zip(whole, back)) \
        if len(whole) == len(back) else float("inf")


def _rank(rank, world, part):
    """The jobs of set ``part`` on this rank (set "a" also the checkpoint's
    round trip)."""
    from repro_torch.launch.mesh import make_local_mesh

    out, meshes = {}, {}
    for name, fam, data, model, rules, control, steps, state, where in JOBS:
        if where != part:
            continue
        mesh = meshes.setdefault(model, make_local_mesh(model))
        run = lambda: _job(fam, mesh, rules, control, steps, state)  # noqa: E731
        out[name] = _kvseq_calls(run) if rules in ("kvseq", "default") else run()
    if part == "a":
        out["checkpoint"] = _checkpoint_round_trip(meshes[2])
    return out


def _world_one(rank, world):
    """World 1: each family without a mesh (phi4 also with int8 moments
    and without its rotations), the seqpar witness, the (1, 1) meshes."""
    from repro_torch.launch.mesh import make_local_mesh

    out = {}
    for fam in FAMILIES:
        out[fam] = _job(fam, None, "default",
                        steps={"phi4": STEPS, "mixtral": 1}.get(fam, 0))
        with forcing.split_positions(2):
            out[(fam, "witness")] = _job(fam, None, "default")
    out[("phi4", "int8")] = _job("phi4", None, "default", steps=STEPS, state="int8")
    out[("phi4", "no rotation")] = _job("phi4", None, "default", steps=1, rotate="none")
    mesh = make_local_mesh(1)
    for name, fam, data, model, rules, control, steps, state, where in JOBS:
        if where == "w1":
            out[name] = _job(fam, mesh, rules, control, steps, state)
    return out


def _jax_tree(t):
    import jax.numpy as jnp

    if isinstance(t, dict):
        return {k: _jax_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_jax_tree(v) for v in t]
    t = np.asarray(t)
    return jnp.asarray(t.view(jnp.bfloat16) if t.dtype == np.uint16 else t)


def _reference(fam: str):
    """The reference's un-meshed step on the port's seeded weights and
    batch 0: its loss and the first moment after it (0.1 x the clipped
    gradient), in the port's leaf order."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.optim import adamw as jadamw

    from repro_torch.bridge import opt_state_from_reference, to_reference
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models.lm import init_lm

    jcfg, cfg = _reference_config(fam), _config(fam)
    jp = _jax_tree(to_reference(init_lm(cfg, seed=0, device="cpu"), cfg))
    jo = jadamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS)
    batch = SyntheticDataset(cfg, ShapeSpec("rules", "train", SEQ, BATCH), seed=0).batch(0)
    step = jax.jit(jmake_train_step(jcfg, jo), compiler_options=AS_WRITTEN)
    _, js, jm = step(jp, jadamw.init_opt_state(jp, jo), jax.tree.map(jnp.asarray, batch))
    state = opt_state_from_reference(jax.tree.map(np.asarray, js), cfg, "cpu")
    return {"loss": float(jm["loss"]), "m1": _leaves(state["m"])}


@contextlib.contextmanager
def _group_of_one():
    """A gloo process group of this process alone (world 1's (1, 1) mesh),
    destroyed after the block."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _all_runs() -> dict:
    """The three sets of ranks side by side, from threads, while the
    reference and then world 1 (on one torch thread, in a process group of
    its own for the (1, 1) mesh) run here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    box = {}

    def ranks(part):
        try:
            box[part] = run_ranks(_rank, 4 if part == "c" else 2, part, timeout=300)
        except BaseException as e:      # re-raised below
            box["error"] = e

    started = [threading.Thread(target=ranks, args=(p,)) for p in ("a", "b", "c")]
    for th in started:
        th.start()
    try:
        ref = {fam: _reference(fam) for fam in REFERENCE_HELD}
        with _group_of_one():
            one = _world_one(0, 1)
    finally:
        for th in started:
            th.join()
        torch.set_num_threads(threads)
    if "error" in box:
        raise box["error"]
    ranks = {}
    for part in ("a", "b", "c"):
        for r, res in enumerate(box[part]):
            for name, v in res.items():
                ranks.setdefault(name, [None] * len(box[part]))[r] = v
    return {"ref": ref, "one": one, "ranks": ranks}


@pytest.fixture(scope="module")
def runs():
    return _all_runs()


def _rel(got, want) -> float:
    """Relative L2 distance (the largest element of ``got`` where ``want``
    is 0)."""
    den = float(np.linalg.norm(want))
    return float(np.linalg.norm(got - want)) / den if den else float(np.abs(got).max())


def _worst(got, want) -> float:
    return max(_rel(a, b) for a, b in zip(got, want))


def _bitwise(got, want) -> bool:
    return len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


def _leaf_limit(fam: str, path: str) -> float:
    """A leaf's limit against the reference: ``GRAD_TOLS``' longest name
    that matches its path."""
    named = [k for k in GRAD_TOLS[fam] if k in path]
    return GRAD_TOLS[fam][max(named, key=len)]


def _paths(fam: str):
    from repro_torch import tree as T
    from repro_torch.models.lm import init_lm

    return [k for k, _ in T.leaves_with_paths(init_lm(_config(fam), device="meta"))]


def _got(runs, name):
    """A mesh job's readings: every rank's alike (rank 0's returned)."""
    one = runs["one"].get(name)
    if one is not None:
        return one
    got = runs["ranks"][name]
    if next(j for j in JOBS if j[0] == name)[5] is None:
        for g in got[1:]:
            assert _bitwise(g["grads"], got[0]["grads"])
    return got[0]


# -------------------------------------------------------------- tests
def _reference_dryrun():
    """The reference's ``launch.dryrun`` module. It sets ``XLA_FLAGS`` to
    512 host devices when imported (for its dry run): the flags are put
    back at once, so neither this process's jax nor any process it starts
    later sees them."""
    prev = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return dryrun


class _Composed(Exception):
    pass


@pytest.mark.parametrize("seqpar, preset", [(False, None), (True, None),
                                             (False, "fsdp_only"), (True, "fsdp_only")])
@pytest.mark.parametrize("arch, shape", [("phi4-mini-3.8b", "train_4k"),
                                         ("phi4-mini-3.8b", "decode_32k"),
                                         ("mixtral-8x7b", "decode_32k")])
def test_cell_rules_compose_as_run_cell(arch, shape, seqpar, preset, monkeypatch):
    """``cell_rules`` is the overrides the reference's ``run_cell`` hands
    its step (read by stopping it there)."""
    from repro.core.quant import QuantConfig as JQuantConfig
    from repro.optim.adamw import OptConfig as JOptConfig

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import cell_rules
    from repro_torch.launch.shapes import SHAPES

    dryrun = _reference_dryrun()
    seen = []

    def stop(cfg, shape, mesh, opt_cfg, rules, microbatches):
        seen.append(rules)
        raise _Composed

    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: type("M", (), {"devices": np.zeros(256)})())
    monkeypatch.setattr(dryrun, "_cell_step", stop)
    jarch = {"phi4-mini-3.8b": "phi4_mini_3_8b", "mixtral-8x7b": "mixtral_8x7b"}[arch]
    try:
        dryrun.run_cell(jarch, shape, False, JQuantConfig(), JOptConfig(), verbose=False,
                        seqpar=seqpar, rules_preset=preset)
    except _Composed:
        pass
    assert len(seen) == 1
    assert cell_rules(get_config(arch), SHAPES[shape], seqpar, preset) == seen[0]


def test_one_by_one_mesh_under_every_preset_is_the_no_mesh_step(runs):
    """At (1, 1) every preset's step-0 loss and gradients, and its first
    step's loss and first moment, are the no-mesh step's bit for bit."""
    for name, fam, *_ in [j for j in JOBS if j[8] == "w1"]:
        got, want = runs["one"][name], runs["one"][fam]
        assert got["ce"] == want["ce"] and got["aux"] == want["aux"], name
        assert _bitwise(got["grads"], want["grads"]), name
        assert got["losses"] == want["losses"][:1], name
        assert _bitwise(got["m1"], want["m1"]), name


@pytest.mark.parametrize("fam", REFERENCE_HELD)
def test_world_one_matches_reference_step(fam, runs):
    """World 1 (every preset's (1, 1) step, above) against the reference's
    step from the same weights: the loss within LOSS_TOL, each leaf's
    first moment within GRAD_TOLS; phi4 without its rotations outside on
    its down projections."""
    ref, got = runs["ref"][fam], runs["one"][fam]
    assert abs(got["losses"][0] - ref["loss"]) <= LOSS_TOL
    paths = _paths(fam)
    for path, a, b in zip(paths, got["m1"], ref["m1"]):
        assert _rel(a, b) <= _leaf_limit(fam, path), path
    if fam == "phi4":
        ctrl = runs["one"][("phi4", "no rotation")]["m1"]
        downs = [i for i, p in enumerate(paths) if "w_down" in p]
        assert downs and all(_rel(ctrl[i], ref["m1"][i]) > _leaf_limit(fam, paths[i])
                             for i in downs)


def test_fsdp_only_at_1x2_is_world_one(runs):
    """FSDP_ONLY_RULES at (1, 2): step 0's loss and gathered gradients are
    world 1's bit for bit, and so are both steps' losses; the parameters
    and moments after 2 steps differ from world 1's only where the global
    norm's sum over the two shards rounds 1 ulp apart: within ULP_TOL, the
    int8 moments' codes within one step of world 1's. The controls: the
    backward summing over 'model' too (gradients), the next shard of
    'model' cut (parameters)."""
    one = runs["one"]["phi4"]
    got = _got(runs, "phi4 (1,2) fsdp")
    assert got["ce"] == one["ce"] and _bitwise(got["grads"], one["grads"])
    assert got["losses"] == one["losses"]
    assert all(abs(a - b) <= 4e-7 * b for a, b in zip(got["gnorms"], one["gnorms"]))
    assert _worst(got["params"], one["params"]) <= ULP_TOL
    assert _worst(got["state"], one["state"]) <= ULP_TOL
    i8, w8 = _got(runs, "phi4 (1,2) fsdp int8"), runs["one"][("phi4", "int8")]
    assert i8["losses"] == w8["losses"] and _bitwise(i8["grads"], w8["grads"])
    for a, b in zip(i8["state"], w8["state"]):
        if a.dtype == np.float64 and np.array_equal(a, np.round(a)) and np.abs(a).max() <= 127:
            assert np.abs(a - b).max() <= 1
        else:
            assert _rel(a, b) <= ULP_TOL
    assert _worst(_got(runs, "phi4 (1,2) fsdp control")["grads"], one["grads"]) > ULP_TOL
    assert _worst(_got(runs, "phi4 (1,2) fsdp other shard")["params"],
                  one["params"]) > ULP_TOL


@pytest.mark.parametrize("name", ["phi4 (2,1) fsdp", "phi4 (2,2) fsdp",
                                  "phi4 (2,2) seqpar+fsdp"])
def test_fsdp_only_on_row_split_meshes_within_limits(name, runs):
    """FSDP_ONLY_RULES (with 'seqpar' too at (2, 2)) where the batch rows
    split over 'data': step 0's loss within LOSS_TOL and its gradient norm
    within GNORM_TOL relative, every gradient leaf within ROWS_TOL, the
    parameters after the step within PARAM_TOL relative L2 of world 1's;
    the control (every rank's own shard tiled into each gather) outside
    each."""
    one = runs["one"]["phi4"]
    got = _got(runs, name)
    ctrl = _got(runs, "phi4 (2,1) fsdp tiled")
    for run, inside in ((got, True), (ctrl, False)):
        assert (abs(run["losses"][0] - one["losses"][0]) <= LOSS_TOL) == inside
        assert (abs(run["gnorms"][0] - one["gnorms"][0]) <= GNORM_TOL * one["gnorms"][0]) \
            == inside
        assert (_worst(run["grads"], one["grads"]) <= ROWS_TOL) == inside
        assert all(np.linalg.norm(a - b) <= PARAM_TOL * np.linalg.norm(b)
                   for a, b in zip(run["p1"], one["p1"])) == inside


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_seqpar_at_1x2_splits_the_residual_stream(fam, runs):
    """'seqpar' at (1, 2): the step-0 loss bitwise the same ranks' without
    it; every gradient leaf within SEQPAR_TOL of theirs, the witness within
    it of world 1 (phi4: the control outside); the bytes saved at the
    blocks' inputs half theirs, at every block."""
    base, got = _got(runs, f"{fam} (1,2) default"), _got(runs, f"{fam} (1,2) seqpar")
    assert got["ce"] == base["ce"] and got["aux"] == base["aux"]
    assert _worst(got["grads"], base["grads"]) <= SEQPAR_TOL
    one, wit = runs["one"][fam], runs["one"][(fam, "witness")]
    assert _worst(wit["grads"], one["grads"]) <= SEQPAR_TOL
    assert got["blocks"] == base["blocks"] == 2
    assert 2 * got["saved"] == base["saved"] == one["saved"]
    if fam == "phi4":
        ctrl = runs["ranks"][f"{fam} (1,2) seqpar control"]
        assert all(_worst(c["grads"], base["grads"]) > SEQPAR_TOL for c in ctrl)


@pytest.mark.parametrize("kind", list(KINDS))
def test_seqpar_at_1x2_for_every_layer_kind(kind, runs):
    """'seqpar' at (1, 2) for the other layer kinds (``KINDS``): the step-0
    loss and aux bitwise the same ranks' without it, every gradient leaf
    within SEQPAR_TOL of theirs, the bytes saved at the blocks' inputs
    half."""
    base, got = _got(runs, f"{kind} (1,2) default"), _got(runs, f"{kind} (1,2) seqpar")
    assert got["ce"] == base["ce"] and got["aux"] == base["aux"]
    assert _worst(got["grads"], base["grads"]) <= SEQPAR_TOL
    assert got["blocks"] == base["blocks"] > 0 and 2 * got["saved"] == base["saved"]


def test_experts_over_data_train_at_2x1(runs):
    """mixtral at (2, 1) with its experts over 'data' (rows gathered into
    the MoE layer): loss and aux within LOSS_TOL of world 1's, every
    gradient leaf within ROWS_TOL; the control (the kept rows' backward
    leaving the others' gradient zero) outside on the experts."""
    one = runs["one"]["mixtral"]
    got, ctrl = (_got(runs, f"mixtral (2,1) experts{c}") for c in ("", " control"))
    assert abs(got["ce"] - one["ce"]) <= LOSS_TOL and abs(got["aux"] - one["aux"]) <= LOSS_TOL
    assert _worst(got["grads"], one["grads"]) <= ROWS_TOL
    assert _worst(ctrl["grads"], one["grads"]) > ROWS_TOL


def test_kvseq_rule_leaves_a_training_step_unchanged(runs):
    """A step under {"kvseq": "model"} at (1, 2) calls no
    ``kvseq_all_reduce`` and is the default rules' step bit for bit (no
    training pass reads 'kvseq')."""
    got, base = _got(runs, "phi4 (1,2) kvseq"), _got(runs, "phi4 (1,2) default")
    assert got["kvseq_calls"] == base["kvseq_calls"] == 0
    assert got["ce"] == base["ce"] and _bitwise(got["grads"], base["grads"])


def test_fsdp_only_checkpoint_restores_under_default_rules(runs):
    """A checkpoint saved under FSDP_ONLY_RULES at (1, 2) restores, shards
    and gathers under the default rules to the same whole tensors."""
    assert runs["ranks"]["checkpoint"] == [0.0, 0.0]


def _readings(runs):
    one = runs["one"]
    for fam in FAMILIES:
        if fam in runs["ref"]:
            print(f"{fam}: reference loss {runs['ref'][fam]['loss']:.6f}, world 1 "
                  f"{one[fam]['losses'][0]:.6f}; first moment from the reference's "
                  f"{_worst(one[fam]['m1'], runs['ref'][fam]['m1']):.4g}")
        base, got = _got(runs, f"{fam} (1,2) default"), _got(runs, f"{fam} (1,2) seqpar")
        print(f"  seqpar (1,2): ce {got['ce']!r} ({base['ce']!r} without); gradients "
              f"{_worst(got['grads'], base['grads']):.4g} (witness "
              f"{_worst(one[(fam, 'witness')]['grads'], one[fam]['grads']):.4g}); saved "
              f"{got['saved']} of {base['saved']} bytes")
    ctrl = runs["ranks"]["phi4 (1,2) seqpar control"]
    print(f"seqpar control: {[round(_worst(c['grads'], _got(runs, 'phi4 (1,2) default')['grads']), 4) for c in ctrl]}")
    p4 = one["phi4"]
    for name in [j[0] for j in JOBS if j[1] == "phi4" and "fsdp" in j[0] and j[8] != "w1"]:
        g = _got(runs, name)
        print(f"{name}: ce {g['ce'] - p4['ce']:+.3g}, gradients {_worst(g['grads'], p4['grads']):.4g}"
              + (f", losses {g['losses']}, gnorms {g['gnorms']}, parameters after step 1 "
                 f"{_worst(g['p1'], p4['p1']):.4g}" if g.get("losses") else ""))
    print(f"world 1: losses {p4['losses']}, gnorms {p4['gnorms']}")
    m = one["mixtral"]
    for c in ("", " control"):
        g = _got(runs, f"mixtral (2,1) experts{c}")
        print(f"mixtral (2,1) experts{c}: ce {g['ce'] - m['ce']:+.3g}, aux {g['aux'] - m['aux']:+.3g}, "
              f"gradients {_worst(g['grads'], m['grads']):.4g}")


if __name__ == "__main__":
    _readings(_all_runs())
