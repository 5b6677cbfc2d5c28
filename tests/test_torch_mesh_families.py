"""PyTorch port, every architecture on the mesh: ``launch.train --mp`` and
``launch.serve --mp`` for all 11 families at world 2, run by CPU ranks of
a gloo process group (``repro_torch.testing.ranks.run_ranks``), against
the same launchers at world 1 (no process group), port against port.

Each family at ``--scale 0.005`` (llama3-405b cut to its first 2 layers),
int8 + Hadamard through the 'cuda' backend (its plain versions on CPU
tensors), batch 4 x 16 tokens (a vlm's 1024 patch embeddings before
them), two AdamW steps at lr 1e-3, f32 moments; serving 4 prompts of 16
tokens and 4 greedy tokens. World 1 runs in this process on one torch
thread, as the ranks do (a bf16 GEMM's result depends on the thread
count at llama3-405b's widths), beside the ranks.

  * Mesh (1, 2) (``--mp 2``: tensor-parallel over 'model' -- the
    attention heads, the dense MLP's hidden width, the vocabulary, the
    experts, RWKV6's heads and hidden width and Mamba2's SSD heads split --
    every rank every row): the gradient of every leaf at step 0
    (``lm_loss`` under the mesh, gathered) is world 1's within its limit
    relative L2 -- ``TP_GRAD_TOL``, or its own where ``TP_LIMITS`` names
    the leaf -- and the cross-entropy and aux loss within ``LOSS_TOL``; the
    control, ``copy_to_model`` summing nothing in its backward, falls
    outside its limit on some leaf. Readings on this CPU: at most 0.0162
    (phi4-mini's leaves; the others 0.0092-0.0155; mixtral-8x7b 0.0125,
    rwkv6-7b 0.0153), controls 0.78-1.35. The leaves named in
    ``TP_LIMITS``: zamba2-7b's Mamba2 ``dt_bias`` [0.0524, layer 0's; an
    f32 leaf whose gradient sums over every position and head; its other
    leaves at most 0.0274], and llama4-maverick, whose MoE layer routes a
    near-tie token to another expert once layer 0's attention sums its
    heads in another order (in f32 every leaf reads 1.5e-6): its experts'
    gradients read 0.244-0.267 (control 0.948), its every other leaf 0.073
    -0.161 (layer 1's ``norm2``), its aux loss 0.014 from world 1's
    (``TP_LOSS_LIMITS``). The launchers print world 1's step-0 loss within
    ``LOSS_TOL`` (maverick: its own limit; reads 1.9e-3) and gradient norm
    within ``GNORM_TOL`` [at most 1.9e-3 relative], and serve world 1's
    tokens under the margin rule [every token equal].
  * Mesh (2, 1) (``--mp 1``: the batch rows split over 'data') for the
    MoE (mixtral-8x7b, llama4-maverick) and recurrent (rwkv6-7b,
    zamba2-7b) families, within the limits of ``tests/
    test_torch_multidevice_launch.py``: step 0's loss within ``LOSS_TOL``
    and its gradient norm within ``GNORM_TOL`` of world 1's (the same
    parameters; the bf16 gradients of half the rows each, summed);
    the MoE families' final checkpoint within ``PARAM_TOL``; the served
    tokens world 1's wherever world 1's top-1 / top-2 margin exceeds
    ``MARGIN``. Readings on this CPU: step-0 losses equal to the 4 printed
    decimals, gradient norms within 1.1e-4 relative, checkpoints within
    1.0e-3 (mixtral) and 7.0e-4 (maverick), every token equal.
    Step 1 is not held there: Adam's first step moves each element by
    +-lr whatever its gradient's size, so a near-zero gradient whose sign
    the row split flips moves the element the other way. rwkv6's time-mix
    leaves read 3.6e-3 after that step (1.6% of mix_w1's elements), and
    its step-1 loss and norm differ by 2.7e-3 and 40% between two world-1
    runs on 1 and 4 threads (zamba2's loss: 2.3e-3).
  * The MoE load-balancing loss at (2, 1) is the whole batch's: world 1's
    within ``AUX_TOL`` [reads 5e-7 for mixtral], while its control, the
    mean over the ranks of each rank's own aux (the port before it
    reduced the statistics globally), falls outside [0.38]. The gradient
    of that aux loss alone with respect to every layer's router, summed
    over the ranks as the step sums it, is world 1's within
    ``AUX_GRAD_TOL`` relative L2 [reads 1.3e-7]; its control, a
    ``row_sum`` whose backward all-reduces (the adjoint under a mean over
    the ranks), falls outside [reads 1.0: twice the gradient].
"""
import contextlib
import io
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.testing.ranks import run_ranks

LOSS_TOL, GNORM_TOL, PARAM_TOL = 2e-3, 5e-3, 2e-3
TP_GRAD_TOL = 0.03
# the leaves with their own gradient limit at (1, 2), by a substring of the
# leaf's path (the longest that matches; every other leaf TP_GRAD_TOL), and
# the families' own loss limits (module docstring)
TP_LIMITS = {"llama4-maverick-400b-a17b": {"['moe']['experts']": 0.5, "": 0.25},
             "zamba2-7b": {"['mamba']['dt_bias']": 0.1}}
TP_LOSS_LIMITS = {"llama4-maverick-400b-a17b": 0.05}
AUX_TOL = LOSS_TOL
AUX_GRAD_TOL = 1e-4
MARGIN = 0.125
ARCHS = [get_config(a).name for a in ARCH_IDS]
ROW_SPLIT = ("mixtral-8x7b", "llama4-maverick-400b-a17b", "rwkv6-7b", "zamba2-7b")
MOE = ROW_SPLIT[:2]
BATCH, SEQ, GEN = 4, 16, 4


def _text_len(arch: str) -> int:
    """The launchers' sequence: a vlm's counts its 1024 patches."""
    return SEQ + (1024 if arch == "qwen2-vl-7b" else 0)


def _depth(arch: str):
    return ["--layers", "2"] if arch == "llama3-405b" else []


def _common(arch: str):
    return ["--device", "cpu", "--arch", arch, "--scale", "0.005", "--quant", "int8",
            "--rotate", "hadamard", "--kernel", "cuda"] + _depth(arch)


def _train_argv(arch: str, ckpt=None, mp=None):
    out = _common(arch) + ["--steps", "2", "--seq", str(_text_len(arch)), "--batch",
                           str(BATCH), "--log-every", "1", "--lr", "1e-3"]
    if ckpt is not None:
        out += ["--ckpt-dir", ckpt, "--ckpt-every", "2"]
    return out + ([] if mp is None else ["--mp", str(mp)])


def _serve_argv(arch: str, mp=None):
    return _common(arch) + ["--batch", str(BATCH), "--prompt-len", str(_text_len(arch)),
                            "--gen", str(GEN)] + ([] if mp is None else ["--mp", str(mp)])


def _cfg(arch: str):
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch.serve_loop import cut_depth, scaled_config

    cfg = scaled_config(get_config(arch), 0.005).with_quant(
        QuantConfig(mode="int8", rotate="hadamard", backend="cuda", kv_quant=True))
    return cut_depth(cfg, 2) if arch == "llama3-405b" else cfg


class _UnsummedCopy(torch.autograd.Function):
    """The control's ``copy_to_model``: identity both ways, so each rank
    keeps the input gradient of its own columns only."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _step0(arch: str, mesh=None, per_rank_aux: bool = False, control: bool = False):
    """lm_loss and its gradients at step 0 of the train launcher's run
    (seed 0, the dataset's batch 0): (grads gathered whole, {ce, aux}).
    ``per_rank_aux``: under a (2, 1) mesh, also each rank's own aux (its
    rows' statistics alone), the mean over the ranks. ``control``: under a
    tensor-parallel mesh, ``copy_to_model``'s backward sums nothing
    (``_UnsummedCopy``)."""
    from repro_torch import tree as T
    from repro_torch.data import SyntheticDataset
    from repro_torch.distributed.collectives import gather_tree, shard_tree
    from repro_torch.distributed.sharding import local_rows, sharding_rules
    from repro_torch.launch import shapes as shp
    from repro_torch.launch.steps import batch_row_axes, batch_to, local_batch
    from repro_torch.models.lm import init_lm, lm_loss, param_parts

    cfg = _cfg(arch)
    params = init_lm(cfg, seed=0, device="cpu")
    spec = shp.ShapeSpec("mesh", "train", _text_len(arch), BATCH)
    batch = batch_to(SyntheticDataset(cfg, spec, seed=0).batch(0), "cpu")

    def grads(params, batch):
        flat = T.leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, m = lm_loss(cfg, params, batch)
        g = torch.autograd.grad(loss, flat)
        return T.unflatten(params, list(g)), {k: float(v.detach()) for k, v in m.items()}

    if mesh is None:
        return grads(params, batch)
    from repro_torch.distributed import collectives as C

    with sharding_rules(mesh):
        parts = param_parts(cfg, mesh)
        shards = shard_tree(params, parts, mesh)
        rows = batch_row_axes(mesh, BATCH)
        mine = local_batch(batch, mesh, rows)
        copy = C._CopyToModel
        C._CopyToModel = _UnsummedCopy if control else copy
        try:
            with local_rows(rows):
                g, m = grads(shards, mine)
        finally:
            C._CopyToModel = copy
        g = gather_tree(g, parts, mesh)
        if per_rank_aux:
            with torch.no_grad(), local_rows(()):
                own = lm_loss(cfg, shards, mine)[1]["aux"].reshape(1)
            m["aux_per_rank_mean"] = float(mesh.all_reduce(own, rows) / mesh.group_size(rows))
    return g, m


class _AllReducedBackward(torch.autograd.Function):
    """The control's ``row_sum``: the forward's all-reduce, and a backward
    that all-reduces the gradient too."""

    @staticmethod
    def forward(ctx, t, mesh, rows):
        ctx.mesh, ctx.rows = mesh, rows
        return mesh.all_reduce(t.clone(), rows)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.rows), None, None


def _aux_router_grads(mesh=None, control: bool = False):
    """mixtral-8x7b's aux loss alone at step 0 (the batch of ``_step0``),
    differentiated with respect to every layer's router: the gradients,
    gathered whole (under ``mesh``, reduced over the ranks as the step
    reduces them), as f64 arrays. ``control``: ``row_sum``'s backward
    all-reduces (``_AllReducedBackward``)."""
    from repro_torch import tree as T
    from repro_torch.data import SyntheticDataset
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import local_rows, sharding_rules
    from repro_torch.launch import shapes as shp
    from repro_torch.launch.steps import _is_spec, batch_row_axes, batch_to, local_batch
    from repro_torch.models.lm import init_lm, lm_loss, param_parts

    cfg = _cfg("mixtral-8x7b")
    params = init_lm(cfg, seed=0, device="cpu")
    spec = shp.ShapeSpec("mesh", "train", _text_len(cfg.name), BATCH)
    batch = batch_to(SyntheticDataset(cfg, spec, seed=0).batch(0), "cpu")

    def routers(tree, is_leaf=None):
        return [(p, t) for p, t in T.leaves_with_paths(tree, is_leaf) if "'router'" in p]

    def grads(params, batch):
        rs = [t.requires_grad_(True) for _, t in routers(params)]
        return torch.autograd.grad(lm_loss(cfg, params, batch)[1]["aux"], rs)

    if mesh is None:
        return [g.double().numpy() for g in grads(params, batch)]
    with sharding_rules(mesh):
        parts = param_parts(cfg, mesh)
        shards = C.shard_tree(params, parts, mesh)
        rows = batch_row_axes(mesh, BATCH)
        row_sum = C._RowSum
        C._RowSum = _AllReducedBackward if control else row_sum
        try:
            with local_rows(rows):
                g = grads(shards, local_batch(batch, mesh, rows))
        finally:
            C._RowSum = row_sum
        return [C.gather_leaf(x, pp, mesh).double().numpy()
                for x, (_, pp) in zip(g, routers(parts, _is_spec))]


def _launch(train_runs, serve_runs):
    """Each train run's printed text (rank 0's) and each serve run's
    tokens and margins."""
    from repro_torch.launch import serve, train

    texts, served = [], []
    for argv in train_runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert train.main(argv) == 0
        texts.append(buf.getvalue())
    for argv in serve_runs:
        with contextlib.redirect_stdout(io.StringIO()):
            out = serve.main(argv)
        served.append((out["tokens"], out["margins"]))
    return texts, served


def _world_two(rank, world, root, part):
    """The mesh runs of this file, in two sets of ranks that run side by
    side: ``part`` "mp2", the launchers at --mp 2 for every family; "rows",
    the (1, 2) step-0 gradients of every family, mixtral's (2, 1) aux and
    its routers' gradient beside their controls, and the launchers at
    --mp 1 for ``ROW_SPLIT``. Rank 0's results (the others' equal them)."""
    from repro_torch.launch.mesh import make_local_mesh

    out = {}
    if part == "rows":
        wide, rows = make_local_mesh(2), make_local_mesh(1)
        out["grads"] = {arch: _f64_of(_step0(arch, wide)) for arch in ARCHS}
        out["grads_control"] = {arch: _f64_of(_step0(arch, wide, control=True))
                                for arch in ARCHS}
        _, out["aux"] = _step0("mixtral-8x7b", rows, per_rank_aux=True)
        out["aux_grad"] = _aux_router_grads(rows)
        out["aux_grad_control"] = _aux_router_grads(rows, control=True)
    runs = [(a, 2) for a in ARCHS] if part == "mp2" else [(a, 1) for a in ROW_SPLIT]
    texts, served = _launch(
        [_train_argv(a, os.path.join(root, f"{a}-mp{mp}") if a in MOE else None, mp)
         for a, mp in runs],
        [_serve_argv(a, mp) for a, mp in runs])
    out["train"] = dict(zip(runs, texts))
    out["serve"] = dict(zip(runs, served))
    return out if rank == 0 else None


def _world_one(root):
    """Every world-1 run (no process group), on one torch thread."""
    torch.set_num_threads(1)
    out = {"grads1": {arch: _f64_of(_step0(arch)) for arch in ARCHS},
           "aux_grad1": _aux_router_grads()}
    texts, served = _launch(
        [_train_argv(a, os.path.join(root, f"{a}-w1") if a in MOE else None)
         for a in ARCHS], [_serve_argv(a) for a in ARCHS])
    out["train1"], out["serve1"] = dict(zip(ARCHS, texts)), dict(zip(ARCHS, served))
    return out


def _f64_of(step0):
    from repro_torch import tree as T

    g, m = step0
    return [t.detach().to(torch.float64).numpy() for t in T.leaves(g)], m


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two sets of 2 ranks (``_world_two``'s parts), each started from a
    thread, beside world 1 in this process (its ops leave the GIL, so the
    three overlap)."""
    root = str(tmp_path_factory.mktemp("families"))
    box, threads = {}, torch.get_num_threads()

    def ranks(part):
        try:
            box[part] = run_ranks(_world_two, 2, root, part, timeout=600)[0]
        except BaseException as e:   # re-raised below
            box["error"] = e

    started = [threading.Thread(target=ranks, args=(p,)) for p in ("mp2", "rows")]
    for th in started:
        th.start()
    try:
        out = _world_one(root)
    finally:
        for th in started:
            th.join()
        torch.set_num_threads(threads)
    if "error" in box:
        raise box["error"]
    out.update(box["rows"], root=root)
    for k in ("train", "serve"):
        out[k].update(box["mp2"][k])
    yield out
    shutil.rmtree(root, ignore_errors=True)


def _lines(text: str, key: str):
    return [float(ln.split(key)[1].split()[0]) for ln in text.splitlines()
            if ln.startswith("step")]


def _ckpt(d):
    import json

    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    p = os.path.join(d, steps[-1])
    n = len(json.load(open(os.path.join(p, "tree.json")))["leaves"])
    return [np.load(os.path.join(p, f"arr_{i}.npy")) for i in range(n)]


def _f64(a):
    if a.dtype == np.uint16:                                   # bf16 bits
        a = (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float64)


def _leaf_rel(got, want):
    """Each leaf's relative L2 distance (0 where both are 0)."""
    out = []
    for a, b in zip(got, want):
        den = float(np.linalg.norm(b))
        out.append(float(np.linalg.norm(a - b)) / den if den else float(np.abs(a).max()))
    return out


def _leaf_paths(arch: str):
    from repro_torch import tree as T
    from repro_torch.models.lm import init_lm

    return [k for k, _ in T.leaves_with_paths(init_lm(_cfg(arch), device="meta"))]


def _leaf_limit(arch: str, path: str) -> float:
    """A leaf's gradient limit at (1, 2): ``TP_LIMITS``' longest matching
    name, else TP_GRAD_TOL."""
    named = [k for k in TP_LIMITS.get(arch, {}) if k in path]
    return TP_LIMITS[arch][max(named, key=len)] if named else TP_GRAD_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_at_1x2_are_world_one_bitwise(arch, runs):
    """(1, 2), tensor-parallel: every leaf's step-0 gradient, gathered
    whole, is world 1's within its limit (TP_GRAD_TOL, or ``TP_LIMITS``'
    for the leaves named there) relative L2, and the control's
    (``copy_to_model`` summing nothing) is outside its limit on some leaf;
    the cross-entropy and the aux loss within LOSS_TOL (``TP_LOSS_LIMITS``'
    where the family has its own)."""
    loss_tol = TP_LOSS_LIMITS.get(arch, LOSS_TOL)
    (g1, m1), (g2, m2) = runs["grads1"][arch], runs["grads"][arch]
    gc = runs["grads_control"][arch][0]
    paths = _leaf_paths(arch)
    assert len(g1) == len(g2) == len(gc) == len(paths)
    for path, rel in zip(paths, _leaf_rel(g2, g1)):
        assert rel <= _leaf_limit(arch, path), (path, rel)
    assert any(rel > _leaf_limit(arch, path) for path, rel in zip(paths, _leaf_rel(gc, g1)))
    for k in m1:
        assert abs(m2[k] - m1[k]) <= loss_tol, (k, m1[k], m2[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_at_1x2_match_world_one(arch, runs):
    """``launch.train --mp 2`` (tensor-parallel) prints world 1's step-0
    loss within LOSS_TOL (``TP_LOSS_LIMITS``' where the family has its own) and
    gradient norm within GNORM_TOL (step 1 is not held: module docstring);
    ``launch.serve --mp 2`` serves world 1's greedy tokens under the margin
    rule."""
    one, two = runs["train1"][arch], runs["train"][arch, 2]
    assert "mesh {'data': 1, 'model': 2}" in two
    assert len(_lines(two, "loss")) == len(_lines(one, "loss")) == 2
    loss_tol = TP_LOSS_LIMITS.get(arch, LOSS_TOL)
    assert abs(_lines(two, "loss")[0] - _lines(one, "loss")[0]) <= loss_tol
    g1, g2 = _lines(one, "gnorm")[0], _lines(two, "gnorm")[0]
    assert abs(g2 - g1) <= GNORM_TOL * g1
    toks, _ = runs["serve"][arch, 2]
    want, margins = runs["serve1"][arch]
    assert not _parting(toks, want, margins)


def _parting(got, want, margins):
    """Rows whose tokens part from world 1's where world 1's margin at
    the first differing token exceeds MARGIN (after it, the context
    differs)."""
    bad = []
    for i, row in enumerate(got != want):
        if row.any():
            j = int(np.argmax(row))
            if margins[i, j] > MARGIN:
                bad.append((i, j, float(margins[i, j])))
    return bad


@pytest.mark.parametrize("arch", ROW_SPLIT)
def test_row_split_families_at_2x1(arch, runs):
    """(2, 1): step 0's loss within LOSS_TOL and gradient norm within
    GNORM_TOL of world 1's; the MoE families' final parameters within
    PARAM_TOL; the tokens world 1's under the margin rule (module
    docstring)."""
    one, two = runs["train1"][arch], runs["train"][arch, 1]
    assert "mesh {'data': 2, 'model': 1}" in two
    assert abs(_lines(two, "loss")[0] - _lines(one, "loss")[0]) <= LOSS_TOL
    g1, g2 = _lines(one, "gnorm")[0], _lines(two, "gnorm")[0]
    assert abs(g2 - g1) <= GNORM_TOL * g1
    if arch in MOE:
        root = runs["root"]
        for a, b in zip(_ckpt(os.path.join(root, f"{arch}-w1")),
                        _ckpt(os.path.join(root, f"{arch}-mp1"))):
            a, b = _f64(a), _f64(b)
            assert a.shape == b.shape
            assert np.linalg.norm(a - b) <= PARAM_TOL * np.linalg.norm(a)
    toks, _ = runs["serve"][arch, 1]
    want, margins = runs["serve1"][arch]
    assert not _parting(toks, want, margins)


def test_moe_aux_is_the_whole_batch(runs):
    """mixtral-8x7b at (2, 1): each rank's aux loss is world 1's within
    AUX_TOL; the mean of the per-rank aux losses (each from its rows
    alone) is outside it."""
    want = runs["grads1"]["mixtral-8x7b"][1]["aux"]
    got = runs["aux"]
    assert abs(got["aux"] - want) <= AUX_TOL
    assert abs(got["aux_per_rank_mean"] - want) > AUX_TOL


def _rel_l2(got, want) -> float:
    num = sum(float(np.sum((a - b) ** 2)) for a, b in zip(got, want))
    return (num / sum(float(np.sum(b ** 2)) for b in want)) ** 0.5


def test_moe_aux_gradient_is_the_whole_batch(runs):
    """mixtral-8x7b at (2, 1): the routers' gradient of the aux loss alone
    is world 1's within AUX_GRAD_TOL; with ``row_sum``'s backward
    all-reducing (the control) it is outside."""
    want = runs["aux_grad1"]
    assert len(want) == _cfg("mixtral-8x7b").num_layers
    assert _rel_l2(runs["aux_grad"], want) <= AUX_GRAD_TOL
    assert _rel_l2(runs["aux_grad_control"], want) > AUX_GRAD_TOL
