"""PyTorch port, the launchers on a mesh: ``launch.train`` and
``launch.serve`` run by CPU ranks of a gloo process group
(``repro_torch.testing.ranks.run_ranks`` sets torchrun's variables, so the
launchers take the group and build ``make_local_mesh(--mp)``) against the
same launcher at world 1, port against port.

phi4-mini-3.8b at ``--scale 0.005`` (d_model 128, d_ff 512, 2 layers),
int8 + Hadamard through the 'cuda' backend (its plain versions on CPU
tensors; the down projection's sharded quant_dot fused shard-locally),
batch 4 x 16 tokens, two AdamW steps, f32 moments.

Limits (readings on this CPU in brackets):

  * the printed losses (4 decimals) within ``LOSS_TOL`` = 2e-3 of world 1's
    [at most 7e-4], the printed gradient norms within ``GNORM_TOL`` = 5e-3
    relative [at most 2.3e-3, at (4, 1)]: a batch split over 'data' sums
    bf16 gradients of half (a quarter of) the rows, and the norm adds
    shard norms in another order (a rank's whole-batch mean where its
    share belongs doubles the norm);
  * every parameter leaf of the final checkpoint (gathered whole) within
    ``PARAM_TOL`` = 2e-3 relative L2 of world 1's [at most 8.4e-4]: one
    bf16 rounding of an update can flip where an ulp of the clip scale
    differs;
  * a mesh with 'data' of size 1 ((1, 2): compute replicated, nothing
    split but the parameters) gives world 1's gradients bitwise; only
    the norm's summation order differs there.

A checkpoint written at world 2 restores bitwise at worlds 1 and 4 (sliced
onto the mesh and gathered back), a restart at world 2 repeats the next
step's loss bitwise and restarts at worlds 1 and 4 within LOSS_TOL. Serving
at world 2, ``--mp`` 2 and 1, gives world 1's tokens; llama3-8b's grouped
d_ff (896 = 7 x 128) runs the counted ``unfused_local`` path, phi4-mini's
the fused one.
"""
import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest

from repro_torch import tree as T
from repro_torch.testing.ranks import run_ranks

LOSS_TOL, GNORM_TOL, PARAM_TOL = 2e-3, 5e-3, 2e-3
TRAIN = ["--device", "cpu", "--arch", "phi4-mini-3.8b", "--scale", "0.005", "--steps", "2",
         "--seq", "16", "--batch", "4", "--quant", "int8", "--rotate", "hadamard",
         "--kernel", "cuda", "--log-every", "1", "--lr", "1e-3"]
SERVE = ["--device", "cpu", "--scale", "0.005", "--batch", "4", "--prompt-len", "16",
         "--gen", "6", "--quant", "int8", "--rotate", "hadamard", "--kernel", "cuda"]


def _world_rank(rank, world, train_runs, serve_runs):
    """Several launcher runs in one set of ranks (the process group is
    theirs to share): each train run's printed text (rank 0's; the others
    print nothing) and each serve run's tokens and trace counts."""
    from repro_torch.kernels import registry
    from repro_torch.launch import serve, train

    texts = []
    for argv in train_runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert train.main(argv) == 0
        texts.append(buf.getvalue())
    served = []
    for argv in serve_runs:
        registry.TRACE_COUNTS.clear()
        with contextlib.redirect_stdout(io.StringIO()):
            toks = serve.main(argv)["tokens"]
        served.append((toks, dict(registry.TRACE_COUNTS)))
    return texts, served


def _restore_rank(rank, world, mp, ckpt_dir, argv):
    """Checkpoint step 1 restored onto this world's (world / mp, mp) mesh
    and gathered back whole, beside the restored whole trees (both in the
    reference's layout, numpy); then the launcher's restart from it
    (``argv``), its printed text."""
    from repro_torch.bridge import to_reference
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.distributed.collectives import gather_tree, shard_tree
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve_loop import scaled_config
    from repro_torch.launch.steps import opt_state_parts, param_parts
    from repro_torch.launch.train import restore_state
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import OptConfig, init_opt_state

    cfg = scaled_config(get_config("phi4-mini-3.8b"), 0.005).with_quant(
        QuantConfig(mode="int8", rotate="hadamard", backend="cuda", kv_quant=True))
    opt = OptConfig()
    mesh = make_local_mesh(mp)
    fresh = init_lm(cfg, seed=7, device="cpu")
    whole = restore_state(ckpt_dir, 1, cfg, fresh, init_opt_state(fresh, opt), "cpu")
    with sharding_rules(mesh):
        parts = (param_parts(cfg, mesh), opt_state_parts(cfg, opt, mesh))
    back = [gather_tree(shard_tree(t, pp, mesh), pp, mesh) for t, pp in zip(whole, parts)]
    restored = ([to_reference(t, cfg) for t in back], [to_reference(t, cfg) for t in whole])
    texts, _ = _world_rank(rank, world, [argv], [])
    return restored, texts[0]


def _lines(out: str, key: str):
    return [float(ln.split(key)[1].split()[0]) for ln in out.splitlines()
            if ln.startswith("step")]


def _ckpt(d):
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    p = os.path.join(d, steps[-1])
    n = len(json.load(open(os.path.join(p, "tree.json")))["leaves"])
    return [np.load(os.path.join(p, f"arr_{i}.npy")) for i in range(n)]


def _f64(a):
    if a.dtype == np.uint16:                                   # bf16 bits
        a = (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float64)


def _train_argv(d, mp=None):
    return TRAIN + ["--ckpt-dir", d, "--ckpt-every", "1"] + (
        [] if mp is None else ["--mp", str(mp)])


def _serve_argv(arch, mp=None):
    return SERVE + ["--arch", arch] + ([] if mp is None else ["--mp", str(mp)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World 1 (in this process, no process group), then every mesh run:
    world 2 trains at --mp 1 and 2 and serves phi4-mini at --mp 2 and 1 and
    llama3-8b at --mp 1; world 4 trains at --mp 1 and 2."""
    from repro_torch.launch import serve, train

    root = tmp_path_factory.mktemp("mesh")
    out = {"root": root}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train.main(_train_argv(str(root / "w1"))) == 0
        out["serve1"] = {a: serve.main(_serve_argv(a))["tokens"]
                         for a in ("phi4-mini-3.8b", "llama3-8b")}
    out["train", 1, 1] = buf.getvalue()
    texts, served = run_ranks(
        _world_rank, 2, [_train_argv(str(root / f"w2m{m}"), m) for m in (1, 2)],
        [_serve_argv("phi4-mini-3.8b", 2), _serve_argv("phi4-mini-3.8b", 1),
         _serve_argv("llama3-8b", 1)])[0]
    out["train", 2, 1], out["train", 2, 2] = texts
    out["serve", 2], out["serve", 1], out["llama3"] = served
    texts, _ = run_ranks(_world_rank, 4, [_train_argv(str(root / f"w4m{m}"), m)
                                          for m in (1, 2)], [])[0]
    out["train", 4, 1], out["train", 4, 2] = texts
    return out


@pytest.mark.parametrize("world,mp", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_train_on_mesh_matches_world_one(world, mp, runs):
    out1, text = runs["train", 1, 1], runs["train", world, mp]
    assert f"mesh {{'data': {world // mp}, 'model': {mp}}}" in text
    l1, ln = _lines(out1, "loss"), _lines(text, "loss")
    g1, gn = _lines(out1, "gnorm"), _lines(text, "gnorm")
    assert len(ln) == 2 and np.allclose(ln, l1, rtol=0, atol=LOSS_TOL), (l1, ln)
    assert np.allclose(gn, g1, rtol=GNORM_TOL, atol=0), (g1, gn)
    for a, b in zip(_ckpt(runs["root"] / "w1"), _ckpt(runs["root"] / f"w{world}m{mp}")):
        a, b = _f64(a), _f64(b)
        assert a.shape == b.shape
        assert np.linalg.norm(a - b) <= PARAM_TOL * np.linalg.norm(a)


def test_checkpoint_moves_between_worlds(runs, tmp_path):
    """World 2's (2, 1) checkpoint of step 1 (batch rows split) restores
    bitwise onto worlds 1 ((1, 1)) and 4 ((2, 2)); a world-2 restart
    repeats step 2 bitwise (its final checkpoint is the uninterrupted
    run's); world 1 and world 4 restarts give step 2's loss within
    LOSS_TOL."""
    src = runs["root"] / "w2m1"
    final = _ckpt(src)
    snap = tmp_path / "snap"
    shutil.copytree(src, snap)
    for sub in ("step_000000002", "opt/step_000000002"):
        shutil.rmtree(snap / sub)
    step2 = _lines(runs["train", 2, 1], "loss")[1]
    d = str(tmp_path / "w2")
    shutil.copytree(snap, d)
    again = run_ranks(_world_rank, 2, [_train_argv(d, 1)], [])[0][0][0]
    assert "restoring checkpoint step 1" in again and _lines(again, "loss") == [step2]
    assert all(np.array_equal(a, b) for a, b in zip(_ckpt(d), final))
    for world, mp in ((1, 1), (4, 2)):
        d = str(tmp_path / f"w{world}")
        shutil.copytree(snap, d)
        restored, text = run_ranks(_restore_rank, world, mp, d, _train_argv(d, mp))[0]
        for back, want in zip(*restored):
            for a, b in zip(T.leaves(back), T.leaves(want)):
                assert a.dtype == b.dtype and np.array_equal(a, b), world
        assert "restoring checkpoint step 1" in text
        assert abs(_lines(text, "loss")[0] - step2) <= LOSS_TOL, world


@pytest.mark.parametrize("mp", [2, 1])
def test_serve_on_mesh_gives_world_one_tokens(mp, runs):
    """phi4-mini at world 2: ``--mp 2`` ((1, 2): the weights split, the
    rows whole) and ``--mp 1`` ((2, 1): the rows split, the down
    projection's sharded quant_dot fused shard-locally) give world 1's
    greedy tokens, bitwise."""
    toks, counts = runs["serve", mp]
    np.testing.assert_array_equal(toks, runs["serve1"]["phi4-mini-3.8b"])
    assert counts.get(("sharded_quant_dot", "unfused_local"), 0) == 0


def test_llama3_records_unfused_local(runs):
    """llama3-8b's d_ff 896 = 7 x 128 is grouped: at (2, 1) the down
    projection's sharded quant_dot runs the unfused path shard-locally and
    counts it at every call (2 layers x (prefill + 5 decode steps)); the
    tokens are world 1's."""
    toks, counts = runs["llama3"]
    np.testing.assert_array_equal(toks, runs["serve1"]["llama3-8b"])
    assert counts[("sharded_quant_dot", "unfused_local")] == 2 * 6


def test_launchers_refuse_what_the_mesh_does_not_take(monkeypatch):
    """What the mesh still refuses, leaving no process group behind: the
    engine's whisper-base, qwen2-vl-7b and recurrent kinds on a mesh (the
    ValueError it raises off one; here under torchrun's variables at world
    1, so ``serve_loop`` builds the (1, 1) mesh), and an ``--mp`` that does
    not divide the world (``make_local_mesh``'s ValueError) in all three
    launchers."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch import serve, serve_loop, train

    loop = ["--device", "cpu", "--scale", "0.005", "--quant", "int8", "--rotate",
            "hadamard", "--requests", "2", "--slots", "2", "--max-len", "32",
            "--prefill-len", "8"]
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    with monkeypatch.context() as m:
        for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="localhost",
                         MASTER_PORT=str(port)).items():
            m.setenv(k, v)
        for arch in ("whisper-base", "qwen2-vl-7b", "rwkv6-7b", "zamba2-7b"):
            with pytest.raises(ValueError, match="causal attention stacks only"):
                serve_loop.main(loop + ["--arch", arch, "--mp", "1"])
            assert not dist.is_initialized()
    for main, argv in ((train.main, TRAIN), (serve.main, SERVE + ["--arch", "phi4-mini-3.8b"]),
                       (serve_loop.main, loop + ["--arch", "phi4-mini-3.8b"])):
        with pytest.raises(ValueError, match="does not divide"):
            main(argv + ["--mp", "2"])
        assert not dist.is_initialized()
