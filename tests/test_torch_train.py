"""PyTorch port, training: a scaled-down phi4-mini (2 layers, d_model 384,
d_ff 512, head_dim 128; W8A8 int8 + Hadamard, int8 fake-quantized Q/K/V,
tied embeddings, bf16) trained by ``repro_torch.launch.steps`` against the
reference's un-meshed train step on bridged parameters:
``jax.jit(repro.launch.steps.make_train_step(cfg, opt_cfg))`` compiled with
``xla_allow_excess_precision`` off (backend ``pallas``: its rotate-once or
revisit kernel in interpret mode, ``pltpu.TPUCompilerParams`` aliased inside
the tests only; ``constrain`` is a no-op without a mesh). The port runs its
plain versions through the ``cuda`` backend; the data is the reference's
``SyntheticDataset`` (seq 32, batch 2), which the port's reproduces bitwise.

The two packages' bf16 backward passes round at the same points but sum in
other orders (every matmul's gradient, the tied embedding's two paths, the
scatter of the embedding gradient), so gradients are held per leaf to a
relative L2 limit, not bitwise. Limits, each between a witness and a
control (readings in brackets, this CPU):

  * ``GRAD_TOL`` = 0.03: step-0 gradients of every leaf [witness, the
    port's gradients: at most 0.0110; control, the port with its rotations
    dropped (rotate 'none'): 1.030 and 1.042 on the w_down leaves, held
    above 10 x GRAD_TOL];
  * three steps, each started from the reference's parameters and state,
    so a difference cannot compound: the loss within ``LOSS_TOL`` = 2e-3
    [at most 9e-4]; with f32 moments every parameter leaf within
    ``PARAM_TOL`` = 0.01 relative L2 [at most 3.3e-3]; with int8 moments
    at most ``INT8_FRAC`` = 2% of a leaf's elements off by more than 1% of
    their value [at most 0.98%]: blockwise-int8 second moments round small
    entries to 0 code, where the update becomes m / eps, so a 1% gradient
    difference that moves a code across 0 moves that element by O(1) --
    the reference's 8-bit Adam does the same to itself (its loss rises at
    step 2 of this run, 6.31 -> 6.81);
  * two microbatches: the loss within LOSS_TOL of the reference's scanned
    accumulation [1.2e-5] and of one microbatch [0], the parameters within
    PARAM_TOL of both [3.4e-3, 1.4e-3].

Readings: the tests' own quantities, printed from an instrumented copy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.quant import QuantConfig as JQuantConfig
from repro.data import SyntheticDataset as JSyntheticDataset
from repro.launch.shapes import ShapeSpec as JShapeSpec
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro.optim import adamw as jadamw

from repro_torch import tree as T
from repro_torch.bridge import opt_state_from_reference, params_from_reference
from repro_torch.configs import get_config
from repro_torch.core.quant import QuantConfig
from repro_torch.data import SyntheticDataset
from repro_torch.launch.shapes import SHAPES, ShapeSpec, shape_applicable
from repro_torch.launch.steps import batch_to, make_train_step
from repro_torch.models.lm import init_lm, lm_loss
from repro_torch.optim import adamw

OVER = dict(d_model=384, num_heads=3, num_kv_heads=1, head_dim=128, d_ff=512)
SHAPE = (32, 2)                                   # seq, batch
AS_WRITTEN = {"xla_allow_excess_precision": False}
GRAD_TOL, LOSS_TOL, PARAM_TOL, INT8_FRAC = 0.03, 2e-3, 0.01, 0.02


@pytest.fixture
def pallas_alias(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)


def _configs(schedule="rotate_once", rotate="hadamard"):
    jq = JQuantConfig(mode="int8", rotate="hadamard", backend="pallas", kv_quant=True,
                      schedule=schedule)
    tq = QuantConfig(mode="int8", rotate=rotate, backend="cuda", kv_quant=True,
                     schedule=schedule)
    return (jget_config("phi4_mini_3_8b").scaled_down(**OVER).with_quant(jq),
            get_config("phi4-mini-3.8b").scaled_down(**OVER).with_quant(tq))


def _opt(state_dtype):
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3, state_dtype=state_dtype)
    return jadamw.OptConfig(**kw), adamw.OptConfig(**kw)


def _batch(jcfg, step):
    return JSyntheticDataset(jcfg, JShapeSpec("t", "train", *SHAPE), seed=0).batch(step)


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = _configs()
    return jax.jit(lambda k: jinit_lm(k, jcfg))(jax.random.PRNGKey(0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(t):
    return t.detach().to(torch.float64)


def _rel(got, want):
    g, w = _f32(got), _f32(want)
    return float((g - w).norm() / w.norm())


def _port_grads(cfg, jp, batch):
    tp = params_from_reference(_np(jp), "cpu")
    flat = T.leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = lm_loss(cfg, tp, batch_to(batch, "cpu"))
    return T.leaves_with_paths(T.unflatten(tp, torch.autograd.grad(loss, flat)))


def test_gradients_match_reference(pallas_alias, ref_params):
    """Step-0 gradients of every leaf within GRAD_TOL of the reference's
    (``jax.grad`` of its ``lm_loss``); the control, the port without the
    rotation, sits far outside on the down projections."""
    jcfg, cfg = _configs()
    batch = _batch(jcfg, 0)
    jg = jax.jit(jax.grad(lambda p, b: jlm_loss(jcfg, p, b)[0]),
                 compiler_options=AS_WRITTEN)(ref_params, jax.tree.map(jnp.asarray, batch))
    want = T.leaves(params_from_reference(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jg), "cpu"))
    got = _port_grads(cfg, ref_params, batch)
    worst = max(_rel(g, w) for (_, g), w in zip(got, want))
    assert worst <= GRAD_TOL, worst
    _, no_rot = _configs(rotate="none")
    ctrl = _port_grads(no_rot, ref_params, batch)
    for (path, g), w in zip(ctrl, want):
        if "w_down" in path:
            assert _rel(g, w) > GRAD_TOL * 10, path


@pytest.mark.parametrize("schedule, state", [("rotate_once", "f32"), ("revisit", "int8")])
def test_three_steps_match_reference(pallas_alias, ref_params, schedule, state):
    """Three steps of the port's train step, each from the reference's
    parameters and optimizer state, against the reference's step: loss,
    gradient norm and the updated parameters (see the module docstring)."""
    jcfg, cfg = _configs(schedule)
    jo, to = _opt(state)
    jstep = jax.jit(jmake_train_step(jcfg, jo), compiler_options=AS_WRITTEN)
    tstep = make_train_step(cfg, to)
    jp = ref_params
    js = jax.jit(lambda p: jadamw.init_opt_state(p, jo))(jp)
    for k in range(3):
        batch = _batch(jcfg, k)
        tp = params_from_reference(_np(jp), "cpu")
        ts = opt_state_from_reference(_np(js), cfg, "cpu")
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tm = tstep(tp, ts, batch_to(batch, "cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
        assert int(ts["step"]) == int(js["step"]) == k + 1
        want = T.leaves(params_from_reference(
            jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp), "cpu"))
        for (path, g), w in zip(T.leaves_with_paths(tp), want):
            if state == "f32":
                assert _rel(g, w) <= PARAM_TOL, (k, path)
            else:
                off = ((_f32(g) - _f32(w)).abs() > 1e-2 * _f32(w).abs() + 1e-6)
                assert off.double().mean() <= INT8_FRAC, (k, path)


def test_revisit_trains_bitwise_as_rotate_once():
    """The revisit schedule computes what rotate-once computes: two steps
    from the same parameters give the same losses and parameters."""
    runs = []
    for schedule in ("rotate_once", "revisit"):
        _, cfg = _configs(schedule)
        _, to = _opt("f32")
        step = make_train_step(cfg, to)
        p = init_lm(cfg, seed=3, device="cpu")
        s = adamw.init_opt_state(p, to)
        losses = []
        for k in range(2):
            p, s, m = step(p, s, batch_to(SyntheticDataset(cfg, ShapeSpec(
                "t", "train", 16, 2), seed=1).batch(k), "cpu"))
            losses.append(float(m["loss"]))
        runs.append((losses, [t.detach().clone() for t in T.leaves(p)]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_microbatches_match_reference(pallas_alias, ref_params):
    """Two microbatches (gradients accumulated in f32) against the
    reference's scanned accumulation, and against one microbatch."""
    jcfg, cfg = _configs()
    jo, to = _opt("f32")
    batch = _batch(jcfg, 0)
    jp, js, jm = jax.jit(jmake_train_step(jcfg, jo, microbatches=2),
                         compiler_options=AS_WRITTEN)(
        ref_params, jax.jit(lambda p: jadamw.init_opt_state(p, jo))(ref_params),
        jax.tree.map(jnp.asarray, batch))
    results = {}
    for mb in (1, 2):
        tp = params_from_reference(_np(ref_params), "cpu")
        tp, _, tm = make_train_step(cfg, to, microbatches=mb)(
            tp, adamw.init_opt_state(tp, to), batch_to(batch, "cpu"))
        results[mb] = (float(tm["loss"]), T.leaves(tp))
    want = T.leaves(params_from_reference(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp), "cpu"))
    assert abs(results[2][0] - float(jm["loss"])) <= LOSS_TOL
    assert abs(results[2][0] - results[1][0]) <= LOSS_TOL
    for g, g1, w in zip(results[2][1], results[1][1], want):
        assert _rel(g, w) <= PARAM_TOL and _rel(g, g1) <= PARAM_TOL


def test_synthetic_dataset_is_the_references_bitwise(tmp_path):
    """SyntheticDataset and MemmapDataset (over a corpus either package's
    ``write_synthetic_corpus`` wrote) give the reference's batches bitwise."""
    from repro.data.pipeline import MemmapDataset as JMemmapDataset
    from repro.data.pipeline import write_synthetic_corpus as jwrite

    from repro_torch.data.pipeline import MemmapDataset, write_synthetic_corpus

    jcfg, cfg = _configs()
    mine, theirs = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    write_synthetic_corpus(mine, 5000, 700, seed=2)
    jwrite(theirs, 5000, 700, seed=2)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    for step in (0, 9):
        want = JMemmapDataset(jcfg, JShapeSpec("t", "train", 20, 3), theirs).batch(step)
        got = MemmapDataset(cfg, ShapeSpec("t", "train", 20, 3), mine).batch(step)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    for step in (0, 7):
        want = JSyntheticDataset(jcfg, JShapeSpec("t", "train", 24, 3), seed=5).batch(step)
        got = SyntheticDataset(cfg, ShapeSpec("t", "train", 24, 3), seed=5).batch(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    assert SHAPES["train_4k"] == ShapeSpec("train_4k", "train", 4096, 256)
    assert shape_applicable(cfg, SHAPES["train_4k"]) is None
    assert "sub-quadratic" in shape_applicable(cfg, SHAPES["long_500k"])


def _losses(out: str):
    return [line.split("loss")[1].split()[0] for line in out.splitlines()
            if line.startswith("step")]


def test_train_cli_runs_and_restart_resumes_identically(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu``: a 6-step run
    checkpoints at steps 3 and 6; with step 6's checkpoints removed (a run
    lost after step 3) a restart resumes from step 3 and prints the same
    losses at steps 3-5, bitwise (int8 moments, int8 error-feedback
    compression, revisit schedule)."""
    import shutil

    from repro_torch.launch.train import main

    ck = tmp_path / "ck"
    args = ["--device", "cpu", "--arch", "phi4-mini-3.8b", "--scale", "0.005",
            "--seq", "16", "--batch", "2", "--quant", "int8", "--rotate", "hadamard",
            "--opt-state", "int8", "--grad-compression", "int8_ef", "--schedule",
            "revisit", "--log-every", "1", "--steps", "6", "--ckpt-every", "3",
            "--ckpt-dir", str(ck)]
    assert main(args) == 0
    full = _losses(capsys.readouterr().out)
    for d in (ck / "step_000000006", ck / "opt" / "step_000000006"):
        shutil.rmtree(d)
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "restoring checkpoint step 3" in out
    assert len(full) == 6 and _losses(out) == full[3:]
    assert all(np.isfinite(float(v)) for v in full)
    # int8 moments run on any mesh; at a world of one rank --mp 2 is the
    # mesh's own ValueError
    with pytest.raises(ValueError, match="does not divide"):
        main(args + ["--mp", "2"])
