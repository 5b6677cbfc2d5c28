"""PyTorch port, training of the MoE families: mixtral-8x7b (8 experts top-2
and a sliding window; d_ff 14336 = 7 x 2048, so the experts' down
projection is a grouped rotation over the dispatched rows and the einsum
contraction) and llama4-maverick-400b-a17b (128 experts top-1 and a shared
expert; d_ff 8192, so the experts' site is the fused ``quant_dot_experts``,
K6 on the card), against the reference on the CPU, scaled down by the
reference's own ``scaled_down`` (4 experts, at most 2 a token; mixtral d_ff
96 = 3 x 32, maverick 128), raw bf16 weights, int8 + Hadamard (the
reference's fp8 expert einsum fails on XLA CPU, ROADMAP "Reference
health"; the card runs mixtral in fp8). What the helpers of
``tests/test_torch_train_families.py`` hold there they hold here: the
step-0 gradients of every leaf -- the router's through its softmax / top-k
gates and the load-balancing loss, the experts' through
``_QuantDotExpertsW`` -- against ``jax.jit(jax.grad(lm_loss))``, the
control (rotation off) beyond ``CONTROL_FACTOR`` x the tolerance on every
rotated site, and three steps of mixtral against the reference's
``make_train_step``, each from the reference's state (``LOSS_TOL``,
``PARAM_TOL``).

Readings (largest per-leaf relative L2 of the port's step-0 gradients, then
the control's smallest on a rotated site; ``python
tests/test_torch_train_moe.py``, this CPU):

  * mixtral-8x7b 0.0096 (layer 0's ``norm1``), control 1.007;
  * llama4-maverick-400b-a17b 0.0142 (layer 2's ``attn.wv``), control 1.010.

Both hold to 0.03, phi4's ``GRAD_TOL``.
"""
import time

import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core.quant import QuantConfig
from repro_torch.data import SyntheticDataset
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.launch.steps import batch_to
from repro_torch.models import mlp
from repro_torch.models.lm import init_lm, lm_loss
from test_torch_train_families import (  # noqa: F401  (two fixtures)
    CONTROL_FACTOR, ROTATED, gradient_readings, hold_gradients, hold_launches,
    one_torch_thread, pallas_alias, three_steps, train_cli_runs)

FAMILIES = {   # arch -> (quant mode, GRAD_TOL)
    "mixtral-8x7b": ("int8", 0.03),
    "llama4-maverick-400b-a17b": ("int8", 0.03),
}


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_gradients_match_reference(pallas_alias, arch):
    """Step-0 gradients of every leaf, the router and the expert stacks
    included, within GRAD_TOL of the reference's; the control far
    outside on every rotated site."""
    mode, tol = FAMILIES[arch]
    hold_gradients(arch, mode, tol)


def test_mixtral_three_steps_match_reference(pallas_alias):
    """mixtral-8x7b: three train steps against the reference's
    ``make_train_step`` (loss and every parameter)."""
    three_steps("mixtral-8x7b", "int8")


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_remat_carries_the_load_balancing_gradient(arch):
    """Per-block remat (``torch.utils.checkpoint``) computes what the
    un-rematerialized pass computes, bitwise: the loss, the aux loss and
    every gradient -- the router's load-balancing term included, which the
    checkpointed block returns beside x. Without the aux term the router's
    gradient moves."""
    import dataclasses

    cfg = get_config(arch).scaled_down().with_quant(
        QuantConfig(mode="int8", rotate="hadamard", backend="cuda", kv_quant=True))
    params = init_lm(cfg, seed=4, device="cpu")
    batch = batch_to(SyntheticDataset(cfg, ShapeSpec("t", "train", 24, 2), seed=2).batch(0),
                     "cpu")
    flat = T.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    paths = [p for p, _ in T.leaves_with_paths(params)]
    runs = {}
    for remat in ("dots", "none"):
        loss, m = lm_loss(dataclasses.replace(cfg, remat=remat), params, batch)
        runs[remat] = (loss, m["aux"], torch.autograd.grad(loss, flat, retain_graph=True))
        ce_only = torch.autograd.grad(m["ce"], flat)
    assert float(runs["dots"][1].detach()) > 0
    assert torch.equal(runs["dots"][0], runs["none"][0])
    assert torch.equal(runs["dots"][1], runs["none"][1])
    for path, a, b, c in zip(paths, runs["dots"][2], runs["none"][2], ce_only):
        assert torch.equal(a, b), path
        if "['router']" in path:
            assert not torch.equal(a, c), path


def test_aux_is_the_switch_loss():
    """``apply_moe``'s aux is the Switch load-balancing loss, E x
    sum_e(density_e x mean gate_e), over the gates that route."""
    cfg = get_config("mixtral-8x7b").scaled_down()
    params = init_lm(cfg, seed=5, device="cpu")
    p = params["layers"][0]["moe"]
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    _, aux = mlp.apply_moe(cfg, p, x)
    logits = x.float() @ p["router"].float()
    gates = torch.softmax(logits, -1)
    top = torch.topk(gates, cfg.experts_per_token, -1).indices
    density = torch.nn.functional.one_hot(top, cfg.num_experts).float().sum(2).mean((0, 1))
    want = cfg.num_experts * (density * gates.mean((0, 1))).sum()
    assert abs(float(aux) - float(want)) <= 1e-5 * float(want)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_launches_per_step(arch, monkeypatch):
    """One train step's kernel calls: mixtral's experts a grouped K1 (2
    forward, remat, and 2 backward per layer); maverick's K6 forward at its
    moe layers, K4 at its dense and shared-expert down projections, K1
    backward for each, K2 at every Q / K site."""
    hold_launches(arch, FAMILIES[arch][0], monkeypatch)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_cli_runs(arch, capsys):
    """``launch.train --device cpu --arch <moe>``: two finite steps."""
    train_cli_runs(arch, capsys)


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
              f">= {rot[0]:.4f} ({rot[1]}); GRAD_TOL {tol}, control factor "
              f"{CONTROL_FACTOR} [{time.time() - t0:.1f} s]")
