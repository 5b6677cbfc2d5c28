"""PyTorch port, training of the attention families beyond phi4-mini:
qwen1.5-4b (int8; QKV biases), starcoder2-15b (fp8_e4m3; LayerNorm, tanh
GELU, biases), llama3-405b (fp8_e4m3), whisper-base (int8; the encoder,
cross attention with K rotated only, LayerNorm, biases) and qwen2-vl-7b
(fp8_e4m3; M-RoPE, patch embeddings), each scaled down by the reference's
own ``scaled_down`` (2 layers; d_ff 96 = 3 x 32, a grouped rotation, as the
published 27 x 256, 3 x 8192, 13 x 4096 and 37 x 512 are; whisper 128) with
raw bf16 weights (training's form: quantized on the fly at the consumer
sites, straight-through gradients) and Hadamard rotation. The reference's
parameters cross through ``repro_torch.bridge`` with every QKV bias and
LayerNorm affine redrawn from a numpy seed (the reference initialises them
to zeros and ones, which would hide a misplaced add); the reference runs as
``jax.jit(jax.grad(lm_loss), compiler_options=AS_WRITTEN)`` and
``jax.jit(make_train_step)`` (backend ``pallas`` in interpret mode), the
port through its ``cuda`` backend, whose wrappers run their plain versions
on CPU tensors. Also here: the microbatch split
(``launch.steps.split_microbatches``), the data pipeline's vlm and encoder-
decoder batches, launches per training step, and checkpoint round trips of
every family's parameters and moments.

The two packages' bf16 backward passes round at the same points but sum in
other orders, so gradients are held per leaf by relative L2 (the contract
of ``tests/test_torch_train.py``). ``GRAD_TOL`` is set per family, each
between the port's readings and the control's (the port with its rotations
dropped, ``rotate='none'``), which must read above ``CONTROL_FACTOR`` x the
tolerance on every leaf of a rotated site (the down projections and the Q /
K projections; whisper's cross-attention K too). Readings (largest per-leaf
relative L2 of the port's step-0 gradients, then the control's smallest on
a rotated site; ``python tests/test_torch_train_families.py``, this CPU):

  * qwen1.5-4b 0.0188 (``bk``), control 1.032;
  * starcoder2-15b 0.0176 (``bk``), control 1.026;
  * llama3-405b 0.0111 (``emb``), control 1.011;
  * whisper-base 0.0191 (the encoder's ``norm1`` bias), control 1.046;
  * qwen2-vl-7b 0.0100 (``emb``), control 1.011.

Every family holds to 0.03, phi4's ``GRAD_TOL``: the largest reading is
0.64 of it, and the controls read 34x it. The readings are taken as the
tests run, on one intra-op thread (``one_torch_thread``).

Three steps of ``make_train_step`` on qwen2-vl-7b, each started from the
reference's parameters and state so that differences cannot compound:
the loss within ``LOSS_TOL`` of the reference's, every parameter within
``PARAM_TOL`` relative L2 (phi4's limits), at 1 microbatch and at 2 against
the reference's ``make_train_step(..., microbatches=2)``, whose (3, B, S)
M-RoPE positions the port splits along their batch axis (before, it cut
them along the streams).
"""
import dataclasses
import time

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
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.quant import QuantConfig
from repro_torch.data import SyntheticDataset
from repro_torch.kernels import registry
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.launch.steps import batch_to, make_train_step, split_microbatches
from repro_torch.models.lm import init_lm
from repro_torch.optim import OptConfig, init_opt_state

AS_WRITTEN = {"xla_allow_excess_precision": False}
SEQ, BATCH = 32, 2
LOSS_TOL, PARAM_TOL = 2e-3, 0.01     # phi4's (tests/test_torch_train.py)
CONTROL_FACTOR = 10
FAMILIES = {   # arch -> (quant mode, GRAD_TOL)
    "qwen1.5-4b": ("int8", 0.03),
    "starcoder2-15b": ("fp8_e4m3", 0.03),
    "llama3-405b": ("fp8_e4m3", 0.03),
    "whisper-base": ("int8", 0.03),
    "qwen2-vl-7b": ("fp8_e4m3", 0.03),
}
# the leaves of a rotated site: what the control must move
ROTATED = ("['w_down']", "['attn']['wq']", "['attn']['wk']", "['xattn']['wk']",
           "['cmix']['wv']")
# constant leaves redrawn (mean, spread), per arch; every family also has
# its QKV biases and LayerNorm affines redrawn
REDRAW = {}


def _jname(arch):
    return arch.replace("-", "_").replace(".", "_")


def configs(arch, mode, rotate="hadamard", dtype=None):
    """(reference config, port config): scaled down, raw weights."""
    jq = JQuantConfig(mode=mode, rotate=rotate, backend="pallas", kv_quant=mode != "none")
    tq = QuantConfig(mode=mode, rotate=rotate, backend="cuda", kv_quant=mode != "none")
    jcfg = jget_config(_jname(arch)).scaled_down().with_quant(jq)
    tcfg = get_config(arch).scaled_down().with_quant(tq)
    if dtype is not None:
        jcfg, tcfg = (dataclasses.replace(jcfg, dtype=dtype),
                      dataclasses.replace(tcfg, dtype=dtype))
    return jcfg, tcfg


def _draw(tree, rng, spec):
    """The reference tree with the leaves named in ``spec`` drawn N(mean,
    spread^2), every QKV bias N(0, 0.5^2) and every LayerNorm (a norm dict
    with a bias) scale 1 + N(0, 0.2^2) and bias N(0, 0.2^2), from ``rng``,
    each in its leaf's dtype."""
    def draw(leaf, loc, sd):
        return jnp.asarray((loc + sd * rng.standard_normal(leaf.shape)).astype(
            np.float32)).astype(leaf.dtype)

    def walk(t):
        if isinstance(t, list):
            return [walk(v) for v in t]
        if not isinstance(t, dict):
            return t
        if set(t) == {"scale", "bias"}:
            return {"scale": draw(t["scale"], 1.0, 0.2), "bias": draw(t["bias"], 0.0, 0.2)}
        out = {}
        for k, v in t.items():
            if k in ("bq", "bk", "bv"):
                out[k] = draw(v, 0.0, 0.5)
            elif k in spec and not isinstance(v, dict):
                out[k] = draw(v, *spec[k])
            else:
                out[k] = walk(v)
        return out

    return walk(tree)


_PARAMS = {}


def ref_params(arch, mode, dtype=None):
    """The reference's raw parameters of the scaled model (seed 0), with the
    drawn leaves (cached)."""
    key = (arch, mode, dtype)
    if key not in _PARAMS:
        jcfg, _ = configs(arch, mode, dtype=dtype)
        jp = jax.jit(lambda k: jinit_lm(k, jcfg))(jax.random.PRNGKey(0))
        _PARAMS[key] = _draw(jp, np.random.default_rng(0), REDRAW.get(arch, {}))
    return _PARAMS[key]


def ref_batch(jcfg, step, seq=SEQ, batch=BATCH):
    return JSyntheticDataset(jcfg, JShapeSpec("t", "train", seq, batch), seed=0).batch(step)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_f32(jtree):
    return T.leaves(params_from_reference(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jtree), "cpu"))


def _f64(t):
    return t.detach().to(torch.float64)


def rel(got, want):
    g, w = _f64(got), _f64(want)
    return float((g - w).norm() / w.norm())


def ref_grads(jcfg, jp, batch):
    """The reference's step-0 gradients in the port's leaf order, f32."""
    jg = jax.jit(jax.grad(lambda p, b: jlm_loss(jcfg, p, b)[0]),
                 compiler_options=AS_WRITTEN)(jp, jax.tree.map(jnp.asarray, batch))
    return _port_f32(jg)


def port_grads(tcfg, jp, batch):
    """[(path, gradient)] of the port's ``lm_loss`` on the bridged parameters."""
    from repro_torch.models.lm import lm_loss

    tp = params_from_reference(_np(jp), "cpu")
    flat = T.leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = lm_loss(tcfg, tp, batch_to(batch, "cpu"))
    return T.leaves_with_paths(T.unflatten(tp, torch.autograd.grad(loss, flat)))


def gradient_readings(arch, mode, seq=SEQ, dtype=None):
    """(the port's per-leaf relative L2 against the reference, the
    control's), each {path: reading}."""
    jcfg, tcfg = configs(arch, mode, dtype=dtype)
    jp = ref_params(arch, mode, dtype)
    batch = ref_batch(jcfg, 0, seq)
    want = ref_grads(jcfg, jp, batch)
    got = {p: rel(g, w) for (p, g), w in zip(port_grads(tcfg, jp, batch), want)}
    _, no_rot = configs(arch, mode, rotate="none", dtype=dtype)
    ctrl = {p: rel(g, w) for (p, g), w in zip(port_grads(no_rot, jp, batch), want)}
    return got, ctrl


def hold_gradients(arch, mode, tol, seq=SEQ):
    """Every leaf's step-0 gradient within ``tol`` of the reference's; the
    control beyond ``CONTROL_FACTOR`` x ``tol`` on every rotated site."""
    got, ctrl = gradient_readings(arch, mode, seq)
    worst = max(got.items(), key=lambda kv: kv[1])
    assert worst[1] <= tol, worst
    rotated = {p: r for p, r in ctrl.items() if any(s in p for s in ROTATED)}
    assert rotated
    for p, r in rotated.items():
        assert r > CONTROL_FACTOR * tol, (p, r)


def _opt(state_dtype="f32"):
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3, state_dtype=state_dtype)
    return jadamw.OptConfig(**kw), OptConfig(**kw)


def three_steps(arch, mode, microbatches=1, steps=3, seq=SEQ, param_tol=PARAM_TOL):
    """``steps`` steps of the port's train step, each from the reference's
    parameters and optimizer state, against the reference's step: the loss
    within LOSS_TOL and every updated parameter within ``param_tol`` (f32
    moments)."""
    jcfg, tcfg = configs(arch, mode)
    jo, to = _opt()
    jstep = jax.jit(jmake_train_step(jcfg, jo, microbatches=microbatches),
                    compiler_options=AS_WRITTEN)
    tstep = make_train_step(tcfg, to, microbatches=microbatches)
    jp = ref_params(arch, mode)
    js = jax.jit(lambda p: jadamw.init_opt_state(p, jo))(jp)
    for k in range(steps):
        batch = ref_batch(jcfg, k, seq)
        tp = params_from_reference(_np(jp), "cpu")
        ts = opt_state_from_reference(_np(js), tcfg, "cpu")
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tm = tstep(tp, ts, batch_to(batch, "cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL, k
        assert int(ts["step"]) == int(js["step"]) == k + 1
        for (path, g), w in zip(T.leaves_with_paths(tp), _port_f32(jp)):
            assert rel(g, w) <= param_tol, (k, path)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module's tests run, restored after:
    they run many small torch ops, and beside the suite's other parallel
    workers each op's thread pool spins for cores the others hold (six
    copies of the checkpoint round trips, 14 s alone, ran past 900 s with 8
    threads each, and in 17 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_alias(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)


# ------------------------------------------------------------- gradients
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_gradients_match_reference(pallas_alias, arch):
    """Step-0 gradients of every leaf within the family's GRAD_TOL of the
    reference's ``jax.grad(lm_loss)``; the rotation-off control far
    outside on every rotated site (module docstring)."""
    mode, tol = FAMILIES[arch]
    hold_gradients(arch, mode, tol)


# ------------------------------------------------------------- the vlm
def test_split_microbatches():
    """Batch-led tensors are cut along dim 0, the (3, B, S) M-RoPE
    positions along dim 1, anything else passes whole; a batch that does
    not divide raises."""
    B, S = 4, 6
    pos = torch.arange(3 * B * S).reshape(3, B, S)
    batch = {"tokens": torch.arange(B * S).reshape(B, S), "positions": pos,
             "patch_embeds": torch.randn(B, 2, 8), "table": torch.ones(3)}
    parts = split_microbatches(batch, 2)
    assert len(parts) == 2
    for i, part in enumerate(parts):
        assert torch.equal(part["tokens"], batch["tokens"][2 * i:2 * i + 2])
        assert torch.equal(part["patch_embeds"], batch["patch_embeds"][2 * i:2 * i + 2])
        assert part["positions"].shape == (3, 2, S)
        assert torch.equal(part["positions"], pos[:, 2 * i:2 * i + 2])
        assert part["table"] is batch["table"]
    with pytest.raises(ValueError, match="microbatches"):
        split_microbatches(batch, 3)


def test_vlm_three_steps_match_reference(pallas_alias):
    """qwen2-vl-7b: three train steps (patches, M-RoPE positions) against
    the reference's ``make_train_step``."""
    three_steps("qwen2-vl-7b", "fp8_e4m3")


def test_vlm_microbatches_match_reference(pallas_alias):
    """qwen2-vl-7b at 2 microbatches against the reference's
    ``make_train_step(..., microbatches=2)``, and against 1 microbatch on
    the same batch: the loss within LOSS_TOL, every parameter within
    PARAM_TOL. Before the split was repaired the step raised: the (3, B,
    S) positions were cut into a (2, B, S) and a (1, B, S) piece."""
    arch, mode = "qwen2-vl-7b", "fp8_e4m3"
    jcfg, tcfg = configs(arch, mode)
    jo, to = _opt()
    jp = ref_params(arch, mode)
    batch = ref_batch(jcfg, 0)
    jp2, _, jm = jax.jit(jmake_train_step(jcfg, jo, microbatches=2),
                         compiler_options=AS_WRITTEN)(
        jp, jax.jit(lambda p: jadamw.init_opt_state(p, jo))(jp),
        jax.tree.map(jnp.asarray, batch))
    want = _port_f32(jp2)
    results = {}
    for mb in (1, 2):
        tp = params_from_reference(_np(jp), "cpu")
        tp, _, tm = make_train_step(tcfg, to, microbatches=mb)(
            tp, init_opt_state(tp, to), batch_to(batch, "cpu"))
        results[mb] = (float(tm["loss"]), T.leaves(tp))
    assert abs(results[2][0] - float(jm["loss"])) <= LOSS_TOL
    assert abs(results[2][0] - results[1][0]) <= LOSS_TOL
    for g, g1, w in zip(results[2][1], results[1][1], want):
        assert rel(g, w) <= PARAM_TOL and rel(g, g1) <= PARAM_TOL


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-base"])
def test_synthetic_dataset_is_the_references_bitwise(arch):
    """A vlm's batch (tokens, patches, positions) and an encoder-decoder's
    (tokens, frames) are the reference's ``SyntheticDataset`` bitwise."""
    jcfg, tcfg = configs(arch, FAMILIES[arch][0])
    for step in (0, 5):
        want = ref_batch(jcfg, step, 36, 3)
        got = SyntheticDataset(tcfg, ShapeSpec("t", "train", 36, 3), seed=0).batch(step)
        assert set(got) == set(want) == {"tokens", "labels"} | (
            {"patch_embeds", "positions"} if tcfg.family == "vlm" else {"frames"})
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


# -------------------------------------------------- launches per step
def site_launches(cfg):
    """The kernels one training step launches on the card (remat on: every
    block's forward runs twice), by site: {"K1", "K2", "K4", "K6"}. A Q / K
    site whose head_dim is a power of 2 runs K2 forward and K1 backward; one
    that is not (zamba2's 112) the grouped K1 both ways; a decoder's cross
    attention rotates K only. A down projection whose d_ff is a power of 2
    runs K4 forward (K6 over the experts), one that is not a grouped K1
    (dense, or over the experts' dispatched rows); either runs two K1
    backward (gx, and the rotated x for gw). A MoE layer's shared expert is
    a dense down projection more; a mamba layer has no site."""
    from repro_torch.core.hadamard import largest_pow2_divisor

    def pow2(v):
        return v == largest_pow2_divisor(v)

    n = {"K1": 0, "K2": 0, "K4": 0, "K6": 0}
    for kind in list(cfg.layer_kinds) + list(cfg.encoder_layer_kinds):
        qk = {"attn": 2, "moe": 2, "enc_attn": 2, "xattn": 3}.get(kind, 0)
        if pow2(cfg.head_dim):
            n["K2"] += 2 * qk
            n["K1"] += qk
        else:
            n["K1"] += 3 * qk
        downs = {"attn": ["K4"], "xattn": ["K4"], "enc_attn": ["K4"], "rwkv": ["K4"],
                 "moe": ["K6"] + (["K4"] if cfg.moe_shared_expert else [])}.get(kind, [])
        for k in downs:
            n[k if pow2(cfg.d_ff) else "K1"] += 2
            n["K1"] += 2
    return {k: v for k, v in n.items() if v}


def count_step_launches(tcfg, params, batch, monkeypatch):
    """One train step's calls into the cuda backend (each a kernel launch
    on the card) on the CPU: {"K1", "K2", "K4", ...}."""
    names = {"transform": "K1", "fused_dequant": "K2", "fused": "K3",
             "quant_dot": "K4", "quant_dot_experts": "K6"}
    calls = {k: 0 for k in names.values()}
    for name, k in names.items():
        real = getattr(registry.CudaBackend, name)

        def spy(self, *a, _real=real, _k=k, **kw):
            calls[_k] += 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(registry.CudaBackend, name, spy)
    _, to = _opt()
    make_train_step(tcfg, to)(params, init_opt_state(params, to), batch)
    return {k: v for k, v in calls.items() if v}


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_launches_per_step(arch, monkeypatch):
    """One train step calls the kernels as ``site_launches`` counts them
    (the derivation behind ``chip_smoke.py``'s training counts)."""
    hold_launches(arch, FAMILIES[arch][0], monkeypatch)


def hold_launches(arch, mode, monkeypatch):
    _, tcfg = configs(arch, mode)
    params = init_lm(tcfg, seed=1, device="cpu")
    seq = tcfg.vlm_patches + 20 if tcfg.family == "vlm" else 24
    batch = batch_to(SyntheticDataset(tcfg, ShapeSpec("t", "train", seq, 2)).batch(0), "cpu")
    assert count_step_launches(tcfg, params, batch, monkeypatch) == site_launches(tcfg)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "starcoder2-15b", "mixtral-8x7b",
                                  "whisper-base", "qwen2-vl-7b", "rwkv6-7b", "zamba2-7b"])
def test_harness_backward_cases_are_the_steps_k1_calls(arch, monkeypatch):
    """``bench.hadamard.backward_cases`` -- the K1 shapes ``chip_smoke.py``
    times for the training phases -- of a scaled-down config at its training
    traffic: each case's (rows, n) is a K1 call of the backward of one
    microbatch, made there at least ``per_step`` / microbatches times."""
    import collections

    from repro_torch.bench.hadamard import backward_cases, train_traffic
    from repro_torch.models.lm import lm_loss

    cfg = dataclasses.replace(get_config(arch).scaled_down().with_quant(
        QuantConfig(mode="int8", rotate="hadamard", backend="cuda", kv_quant=True)),
        remat="none")
    batch, seq, mb = train_traffic(cfg)
    full = SyntheticDataset(cfg, ShapeSpec("t", "train", seq, batch), seed=3).batch(0)
    part = split_microbatches(batch_to(full, "cpu"), mb)[0]
    params = init_lm(cfg, seed=3, device="cpu")
    flat = T.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = lm_loss(cfg, params, part)
    calls = collections.Counter()
    real = registry.CudaBackend.transform

    def spy(self, x, plan, in_place=False):
        calls[(x.numel() // plan.p, plan.p)] += 1
        return real(self, x, plan, in_place)

    monkeypatch.setattr(registry.CudaBackend, "transform", spy)
    torch.autograd.grad(loss, flat)
    cases = backward_cases(cfg)
    assert len(cases) == (4 if cfg.is_encdec else 1 + any(
        k not in ("rwkv", "mamba") for k in cfg.layer_kinds))
    for case in cases:
        assert calls[(case.rows, case.n)] * mb >= case.per_step > 0, (case, dict(calls))


# ---------------------------------------------------------------- remat
def remat_is_bitwise(arch, mode):
    """The loss and every gradient with per-block recomputation
    (``cfg.remat`` "dots", ``torch.utils.checkpoint``) against the pass
    without it, bitwise."""
    import dataclasses

    from repro_torch.models.lm import lm_loss

    _, tcfg = configs(arch, mode)
    params = init_lm(tcfg, seed=4, device="cpu")
    seq = tcfg.vlm_patches + 20 if tcfg.family == "vlm" else 24
    batch = batch_to(SyntheticDataset(tcfg, ShapeSpec("t", "train", seq, 2), seed=2).batch(0),
                     "cpu")
    flat = T.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    runs = []
    for remat in ("dots", "none"):
        loss, _ = lm_loss(dataclasses.replace(tcfg, remat=remat), params, batch)
        runs.append((loss.detach(), torch.autograd.grad(loss, flat)))
    assert torch.equal(runs[0][0], runs[1][0])
    for (path, _), a, b in zip(T.leaves_with_paths(params), runs[0][1], runs[1][1]):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-7b"])
def test_remat_is_bitwise(arch):
    """Recomputing each block in the backward pass -- the encoder's and
    the decoder's with its cross attention; M-RoPE -- changes no bit of
    the loss or the gradients."""
    remat_is_bitwise(arch, FAMILIES[arch][0])


# ------------------------------------------- checkpoints, every family
@pytest.mark.parametrize("state", ["f32", "int8"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_checkpoint_round_trip(arch, state, tmp_path):
    """Every family's parameters and moments after one step survive a
    checkpoint written in the reference's layout and restored onto a fresh
    init, bitwise, and the next step from either is bitwise the same."""
    from repro_torch.launch.train import restore_state, save_state
    from repro_torch.checkpoint import wait_for_writes

    cfg = get_config(arch).scaled_down().with_quant(
        QuantConfig(mode="int8", rotate="hadamard", backend="cuda", kv_quant=True))
    to = OptConfig(lr=1e-3, warmup_steps=1, total_steps=3, state_dtype=state)
    step = make_train_step(cfg, to)
    seq = 16 if cfg.family != "vlm" else cfg.vlm_patches + 12
    ds = SyntheticDataset(cfg, ShapeSpec("t", "train", seq, 2), seed=1)
    params = init_lm(cfg, seed=2, device="cpu")
    opt_state = init_opt_state(params, to)
    params, opt_state, _ = step(params, opt_state, batch_to(ds.batch(0), "cpu"))
    save_state(str(tmp_path), 1, cfg, params, opt_state)
    wait_for_writes()
    fresh = init_lm(cfg, seed=3, device="cpu")
    p2, o2 = restore_state(str(tmp_path), 1, cfg, fresh, init_opt_state(fresh, to), "cpu")
    for a, b in zip(T.leaves(params) + T.leaves(opt_state), T.leaves(p2) + T.leaves(o2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    b1 = batch_to(ds.batch(1), "cpu")
    _, _, m1 = step(params, opt_state, b1)
    _, _, m2 = step(p2, o2, b1)
    assert float(m1["loss"]) == float(m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params), T.leaves(p2)))


# --------------------------------------------------------- the launcher
@pytest.mark.parametrize("arch", list(FAMILIES) + ["llama3-8b"])
def test_train_cli_runs_every_arch(arch, capsys):
    """``python -m repro_torch.launch.train --device cpu --arch <any>``
    trains two steps with finite losses (a vlm at 2 microbatches); the
    other families' files run it on theirs."""
    train_cli_runs(arch, capsys)


def train_cli_runs(arch, capsys):
    from repro_torch.launch.train import main

    cfg = get_config(arch)
    seq = 1040 if cfg.family == "vlm" else 32
    args = ["--device", "cpu", "--arch", arch, "--scale", "0.0025", "--seq", str(seq),
            "--batch", "2", "--quant", "int8", "--rotate", "hadamard", "--steps", "2",
            "--log-every", "1"]
    if cfg.family == "vlm":
        args += ["--microbatch", "2"]
    assert main(args) == 0
    losses = [float(line.split("loss")[1].split()[0])
              for line in capsys.readouterr().out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


if __name__ == "__main__":
    from jax.experimental.pallas import tpu as pltpu

    pltpu.TPUCompilerParams = pltpu.CompilerParams
    torch.set_num_threads(1)      # as the tests run (one_torch_thread)
    for arch, (mode, tol) in FAMILIES.items():
        t0 = time.time()
        got, ctrl = gradient_readings(arch, mode)
        worst = max(got.items(), key=lambda kv: kv[1])
        rot = min((r, p) for p, r in ctrl.items() if any(s in p for s in ROTATED))
        print(f"{arch}: port {worst[1]:.4f} ({worst[0]}), control on a rotated site "
              f">= {rot[0]:.4f} ({rot[1]}); GRAD_TOL {tol} [{time.time() - t0:.1f} s]")
