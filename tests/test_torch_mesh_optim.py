"""PyTorch port, the training objective and the optimizer state on a mesh:
the cross-entropy reduced over the whole batch, and blockwise-int8 AdamW
moments (``--opt-state int8``) on meshes of 2 and 4 ranks, on CPU ranks of
a gloo process group (``repro_torch.testing.ranks.run_ranks``) against
world 1, port against port.

phi4-mini-3.8b at ``--scale 0.005`` (d_model 128, d_ff 512, 2 layers),
int8 + Hadamard through the 'cuda' backend's plain versions, batch 4 x 16
tokens; world 1 on one torch thread, as the ranks.

  * The cross-entropy at (2, 1): rows 0-1 carry 16 labels each, rows 2-3
    two each (the rest -1), the latter the model's own greedy tokens, so
    the two halves' means differ. The step's loss and cross-entropy are
    world 1's within ``LOSS_TOL`` [reads 1e-6], its gradient norm within
    ``GNORM_TOL`` and its parameters within ``PARAM_TOL``; the control,
    the mean of each rank's own masked mean (the port before it divided
    by the global count), falls outside [0.31].
  * int8 moments hold each leaf's whole tensor in blocks of 256 along its
    global last dim (``optim.qstate``; d_model 128 split 2 ways puts one
    block on two ranks). Two steps of ``make_train_step`` with the clip
    off (a clip scale from a norm summed in another order may differ by
    an ulp). Neither at (1, 2) nor at (2, 2) are the gradients world 1's:
    (1, 2) runs the attention, the MLP and the vocabulary tensor-parallel
    (f32 sums of the heads' partial products, the input gradients summed
    over 'model'), (2, 2) also sums bf16 gradients of half the rows each;
    at (2, 2) after one step even f32 moments read 7.2e-3 from world 1's,
    int8 ones 1.25e-2. So at both the int8 moments are held to the f32
    moments of the same step on the same mesh: gathered, they are
    ``quantize_state`` of those, bitwise; the two steps' losses and
    gradient norms are world 1's within ``LOSS_TOL`` / ``GNORM_TOL``.
    Every leaf's layout at (1, 2), (2, 1) and (2, 2) quantizes a random
    tensor's shards to the whole tensor's codes and scales, bitwise.
  * ``launch.train --opt-state int8`` at world 2 ((2, 1)) and world 4
    ((2, 2)): step 0's loss within ``LOSS_TOL`` of world 1's; the world-2
    checkpoint of step 1 (parameters and moments, whole tensors) restores
    bitwise at world 1 and onto world 4's mesh (sharded and gathered
    back), and a world-4 restart from it gives world 2's step-2 loss
    within ``LOSS_TOL``.
"""
import contextlib
import io
import shutil
import threading

import numpy as np
import pytest
import torch

from repro_torch.testing.ranks import run_ranks

LOSS_TOL, GNORM_TOL, PARAM_TOL = 2e-3, 5e-3, 2e-3
ARCH, BATCH, SEQ = "phi4-mini-3.8b", 4, 16
TRAIN = ["--device", "cpu", "--arch", ARCH, "--scale", "0.005", "--steps", "2", "--seq",
         str(SEQ), "--batch", str(BATCH), "--quant", "int8", "--rotate", "hadamard",
         "--kernel", "cuda", "--log-every", "1", "--lr", "1e-3", "--opt-state", "int8"]


def _cfg():
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch.serve_loop import scaled_config

    return scaled_config(get_config(ARCH), 0.005).with_quant(
        QuantConfig(mode="int8", rotate="hadamard", backend="cuda", kv_quant=True))


def _uneven_batch(cfg, params):
    """The dataset's batch 0 with rows 2-3 labelled by the model's greedy
    tokens at their first two positions and -1 after."""
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch import shapes as shp
    from repro_torch.launch.steps import batch_to
    from repro_torch.models.lm import lm_forward

    spec = shp.ShapeSpec("mesh", "train", SEQ, BATCH)
    b = batch_to(SyntheticDataset(cfg, spec, seed=0).batch(0), "cpu")
    with torch.no_grad():
        logits = lm_forward(cfg, params, b)[0]
    b["labels"][2:] = logits[2:, :, :cfg.vocab_size].argmax(-1).to(b["labels"].dtype)
    b["labels"][2:, 2:] = -1
    return b


def _steps(opt, mesh=None, steps=1, uneven=True):
    """``steps`` of ``make_train_step`` from seed 0 on the uneven batch (or
    the dataset's batches): (metrics of each step, the parameters gathered
    whole as numpy leaves in the port's order, the optimizer state gathered
    whole as a tree of numpy arrays)."""
    from repro_torch import tree as T
    from repro_torch.data import SyntheticDataset
    from repro_torch.distributed.collectives import gather_tree, shard_tree
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.launch import shapes as shp
    from repro_torch.launch.steps import batch_to, make_train_step, opt_state_parts
    from repro_torch.models.lm import init_lm, param_parts
    from repro_torch.optim import init_opt_state

    cfg = _cfg()
    params = init_lm(cfg, seed=0, device="cpu")
    ds = SyntheticDataset(cfg, shp.ShapeSpec("mesh", "train", SEQ, BATCH), seed=0)
    batches = [_uneven_batch(cfg, params) if uneven else batch_to(ds.batch(i), "cpu")
               for i in range(steps)]
    state = init_opt_state(params, opt)
    step = make_train_step(cfg, opt, mesh=mesh)
    if mesh is not None:
        with sharding_rules(mesh):
            parts = (param_parts(cfg, mesh), opt_state_parts(cfg, opt, mesh))
        params, state = shard_tree(params, parts[0], mesh), shard_tree(state, parts[1], mesh)
    seen = []
    for b in batches:
        params, state, m = step(params, state, b)
        seen.append({k: float(v) for k, v in m.items()})
    if mesh is not None:
        params, state = gather_tree(params, parts[0], mesh), gather_tree(state, parts[1], mesh)
    leaves = [t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()
              for t in T.leaves(params)]
    return seen, leaves, T.tree_map(lambda t: t.numpy(), state)


def _control():
    """The mean over the two halves of the uneven batch of each half's own
    masked mean: what (2, 1) ranks averaged before."""
    from repro_torch.launch.steps import split_microbatches
    from repro_torch.models.lm import init_lm, lm_loss

    cfg = _cfg()
    params = init_lm(cfg, seed=0, device="cpu")
    with torch.no_grad():
        halves = [lm_loss(cfg, params, p)[1]["ce"]
                  for p in split_microbatches(_uneven_batch(cfg, params), 2)]
    return float(sum(halves) / 2)


def _restored(ckpt_dir, mesh):
    """Checkpoint step 1 restored (the reference's layout, numpy leaves),
    and, on ``mesh``, sharded onto it and gathered back."""
    from repro_torch import tree as T
    from repro_torch.bridge import to_reference
    from repro_torch.distributed.collectives import gather_tree, shard_tree
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.launch.steps import opt_state_parts, param_parts
    from repro_torch.launch.train import restore_state
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import OptConfig, init_opt_state

    cfg, opt = _cfg(), OptConfig(state_dtype="int8")
    fresh = init_lm(cfg, seed=7, device="cpu")
    whole = restore_state(ckpt_dir, 1, cfg, fresh, init_opt_state(fresh, opt), "cpu")
    back = whole
    if mesh is not None:
        with sharding_rules(mesh):
            parts = (param_parts(cfg, mesh), opt_state_parts(cfg, opt, mesh))
        back = [gather_tree(shard_tree(t, pp, mesh), pp, mesh) for t, pp in zip(whole, parts)]

    def ref(trees):
        return [[np.asarray(x) for x in T.leaves(to_reference(t, cfg))] for t in trees]
    return ref(back), ref(whole)


def _layout(mesh):
    """The leaves whose int8 state, quantized from a random tensor's
    shards on ``mesh`` and gathered, is not the whole tensor's."""
    from repro_torch import tree as T
    from repro_torch.distributed.collectives import shard_tree
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.launch.steps import _is_spec, param_parts
    from repro_torch.models.lm import init_lm
    from repro_torch.optim.qstate import QStateParts, quantize_state

    cfg = _cfg()
    with sharding_rules(mesh):
        parts = T.leaves(param_parts(cfg, mesh), _is_spec)
    bad = []
    for i, (pp, p) in enumerate(zip(parts, T.leaves(init_lm(cfg, device="meta")))):
        gen = torch.Generator().manual_seed(i)
        x = torch.randn(p.shape, generator=gen) * torch.rand(p.shape[-1], generator=gen)
        qp = QStateParts(pp, p.shape)
        got = qp.gather(quantize_state(shard_tree(x, pp, mesh), qp.split(mesh)), mesh)
        want = quantize_state(x)
        if not all(torch.equal(got[k], want[k]) for k in ("q", "s")):
            bad.append((i, pp))
    return bad


def _train(argv):
    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train.main(argv) == 0
    return buf.getvalue()


def _rank(rank, world, root):
    """World 2: the uneven cross-entropy step at (2, 1), the int8 steps and
    one f32 step at (1, 2), the launcher at --mp 1 with checkpoints. World 4: the int8
    steps at (2, 2), the world-2 checkpoint restored onto (2, 2), the
    launcher at --mp 2 and its restart from the world-2 checkpoint."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import OptConfig

    q8 = OptConfig(state_dtype="int8", clip_norm=1e30)
    out = {}
    if world == 2:
        out["ce"] = _steps(OptConfig(), make_local_mesh(1))
        out["q8"] = _steps(q8, make_local_mesh(2), steps=2, uneven=False)
        out["q8_1"] = _steps(q8, make_local_mesh(2), uneven=False)
        out["f32_1"] = _steps(OptConfig(clip_norm=1e30), make_local_mesh(2), uneven=False)
        out["layouts"] = [_layout(make_local_mesh(mp)) for mp in (1, 2)]
        out["train"] = _train(TRAIN + ["--mp", "1", "--ckpt-dir", f"{root}/w2",
                                       "--ckpt-every", "1"])
    else:
        mesh = make_local_mesh(2)
        out["q8"] = _steps(q8, mesh, steps=2, uneven=False)
        out["q8_1"] = _steps(q8, mesh, uneven=False)
        out["f32_1"] = _steps(OptConfig(clip_norm=1e30), mesh, uneven=False)
        out["layouts"] = [_layout(mesh)]
        out["restored"] = _restored(f"{root}/w2", mesh)
        out["train"] = _train(TRAIN + ["--mp", "2"])
        d = f"{root}/w4"
        if rank == 0:
            shutil.copytree(f"{root}/w2", d)
            for sub in ("step_000000002", "opt/step_000000002"):
                shutil.rmtree(f"{d}/{sub}")
        mesh.all_reduce(torch.zeros(1), mesh.axis_names)     # the copy is in place
        out["restart"] = _train(TRAIN + ["--mp", "2", "--ckpt-dir", d, "--ckpt-every", "1"])
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Worlds 2 then 4, started from a thread, beside world 1 in this
    process (one thread)."""
    from repro_torch.optim import OptConfig

    root = str(tmp_path_factory.mktemp("optim"))
    box, threads = {}, torch.get_num_threads()

    def ranks():
        try:
            box[2] = run_ranks(_rank, 2, root, timeout=400)[0]
            box[4] = run_ranks(_rank, 4, root, timeout=400)[0]
        except BaseException as e:   # re-raised below
            box["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    try:
        torch.set_num_threads(1)
        one = {"ce": _steps(OptConfig()), "control": _control(),
               "q8": _steps(OptConfig(state_dtype="int8", clip_norm=1e30), steps=2,
                            uneven=False),
               "train": _train(TRAIN)}
    finally:
        th.join()
        torch.set_num_threads(threads)
    if "error" in box:
        raise box["error"]
    one["restored"] = _restored(f"{root}/w2", None)
    yield {1: one, 2: box[2], 4: box[4]}
    shutil.rmtree(root, ignore_errors=True)


def _lines(text: str, key: str):
    return [float(ln.split(key)[1].split()[0]) for ln in text.splitlines()
            if ln.startswith("step")]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def test_cross_entropy_is_the_whole_batch_mean(runs):
    """(2, 1) on the uneven batch: world 1's loss and cross-entropy within
    LOSS_TOL, gradient norm within GNORM_TOL, parameters within PARAM_TOL;
    the mean of the halves' means outside LOSS_TOL."""
    (m1,), p1, _ = runs[1]["ce"]
    (m2,), p2, _ = runs[2]["ce"]
    for k in ("loss", "ce"):
        assert abs(m2[k] - m1[k]) <= LOSS_TOL, (k, m1[k], m2[k])
    assert abs(m2["gnorm"] - m1["gnorm"]) <= GNORM_TOL * m1["gnorm"]
    for a, b in zip(p1, p2):
        assert _rel(a, b) <= PARAM_TOL
    assert abs(runs[1]["control"] - m1["ce"]) > LOSS_TOL


def _held_to_f32_moments(runs, world):
    """The world's int8 moments after one step, gathered, are
    ``quantize_state`` of the f32 moments of the same step, bitwise; its
    two int8 steps' losses and gradient norms are world 1's within
    LOSS_TOL / GNORM_TOL."""
    from repro_torch import tree as T
    from repro_torch.optim.qstate import is_qstate, quantize_state

    _, _, q8 = runs[world]["q8_1"]
    _, _, f32 = runs[world]["f32_1"]
    for key in ("m", "v"):
        got, want = T.leaves(q8[key], is_qstate), T.leaves(f32[key])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            q = quantize_state(torch.from_numpy(w))
            np.testing.assert_array_equal(g["q"], q["q"].numpy())
            np.testing.assert_array_equal(g["s"], q["s"].numpy())
    for m1, m in zip(runs[1]["q8"][0], runs[world]["q8"][0]):
        assert abs(m["loss"] - m1["loss"]) <= LOSS_TOL
        assert abs(m["gnorm"] - m1["gnorm"]) <= GNORM_TOL * m1["gnorm"]


def test_int8_moments_at_1x2_are_world_one_bitwise(runs):
    """(1, 2), tensor-parallel, clip off: the int8 moments hold to the f32
    moments of the same step as at (2, 2) (``_held_to_f32_moments``)."""
    _held_to_f32_moments(runs, 2)


def test_int8_moments_at_2x2_are_the_whole_tensors_blocks(runs):
    """(2, 2), clip off: ``_held_to_f32_moments``; every leaf's layout at
    (1, 2), (2, 1) and (2, 2) gives the whole tensor's codes and scales."""
    _held_to_f32_moments(runs, 4)
    assert runs[2]["layouts"] == [[], []] and runs[4]["layouts"] == [[]]


def test_int8_launcher_on_two_and_four_ranks(runs):
    """``--opt-state int8`` at world 2 ((2, 1)) and 4 ((2, 2)): step 0's
    loss within LOSS_TOL of world 1's."""
    l1 = _lines(runs[1]["train"], "loss")
    for world, mesh in ((2, "{'data': 2, 'model': 1}"), (4, "{'data': 2, 'model': 2}")):
        text = runs[world]["train"]
        assert f"mesh {mesh}" in text
        assert len(_lines(text, "loss")) == 2
        assert abs(_lines(text, "loss")[0] - l1[0]) <= LOSS_TOL


def test_int8_checkpoint_moves_between_worlds(runs):
    """The world-2 checkpoint of step 1 restores bitwise at world 1 and
    through world 4's shards; a world-4 restart from it repeats world 2's
    step-2 loss within LOSS_TOL."""
    for world in (1, 4):
        back, whole = runs[world]["restored"]
        for bt, wt in zip(back, whole):
            assert len(bt) == len(wt)
            for a, b in zip(bt, wt):
                assert a.dtype == b.dtype and np.array_equal(a, b), world
    w1_whole = runs[1]["restored"][1]
    for a_tree, b_tree in zip(runs[4]["restored"][1], w1_whole):
        for a, b in zip(a_tree, b_tree):
            np.testing.assert_array_equal(a, b)
    text = runs[4]["restart"]
    assert "restoring checkpoint step 1" in text
    step2 = _lines(runs[2]["train"], "loss")[1]
    assert abs(_lines(text, "loss")[0] - step2) <= LOSS_TOL
