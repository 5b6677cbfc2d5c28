"""PyTorch port, training of the recurrent-state families: rwkv6-7b (int8;
the RWKV6 time mix in its chunked form and the channel mix, whose ``wv`` is
the rotated down projection, d_ff 96 = 3 x 32 at this scale) and zamba2-7b
(fp8_e4m3; Mamba2's chunked SSD and the hybrid stack, its attention's Q / K
at head_dim 28 = I_7 (x) H_4 and its down projection grouped), scaled down by
the reference's own ``scaled_down``, raw bf16 weights, Hadamard rotation,
against the reference on the CPU with the helpers of
``tests/test_torch_train_families.py``: the step-0 gradients of every leaf
(backward through the chunked time mix and the chunked SSD) against
``jax.jit(jax.grad(lm_loss))``, the control (rotation off) beyond
``CONTROL_FACTOR`` x the tolerance on every rotated site, three rwkv6 steps
against the reference's ``make_train_step`` (``LOSS_TOL``, and
``RWKV_PARAM_TOL`` = 0.02 on the parameters, below), and
``launch.train``'s checkpoint restart for both.

The constant f32 leaves are redrawn from a numpy seed on both sides, as in
the serving tests (rwkv6: the mixing weights, the decay base, the GroupNorm
affine; zamba2: ``A_log``, ``D``, ``dt_bias`` and the gated norm's scale,
drawn so that a 32-token chunk's log-decay stays inside f32's exp range --
see below).

Readings (largest per-leaf relative L2 of the port's step-0 gradients, then
the control's smallest on a rotated site; ``python
tests/test_torch_train_recurrent.py``, this CPU), and ``GRAD_TOL``:

  * rwkv6-7b 0.0151 (layer 0's ``norm1``), control 1.048 (``cmix.wv``);
    GRAD_TOL 0.03, phi4's;
  * zamba2-7b 0.0396 (layer 1's ``mamba.A_log``), control 1.032 (the
    attention's ``wq``); GRAD_TOL 0.06.

zamba2's reading is above phi4's 0.03, and it is bf16 rounding: with the
model in f32 (``dtype='float32'``, everything else the same) the largest
reading falls to 0.00053 (rwkv6: 0.00008), which ``F32_TOL`` holds. The
per-head SSD leaves (``A_log``, ``dt_bias``, ``D``: a few values, each the
sum of a whole sequence's terms) collect the bf16 flips of the
projections that feed them. A first probe (the reference's default
``A_log`` and ``dt_bias``, no redraw) read 0.049 at ``dt_bias``; rerun,
it read 0.0218 (fp8) and 0.0246 (int8) in bf16, 0.0004 and 0.0037 in f32,
and 0.0000 in f32 with rotation off: no port fault.

rwkv6's parameters after each step: at most 0.0112 relative L2 at step 0
(``mix_w2``, then ``w_lora_b`` 0.0108 and ``mix_w1`` 0.0103), 0.0012 and
0.0004 at steps 1 and 2; the loss within 6.6e-4. The step-0 readings are
the time mix's LoRA leaves, drawn at 0.01 scale: AdamW's first update is
lr x sign(g) = 1e-3 for every element, 10% of such a value, so the few
elements whose tiny gradient rounds to the other sign move by 2e-3 and
take the leaf past phi4's ``PARAM_TOL`` of 0.01. Hence 0.02.

A fault of the reference's SSD, not carried: its intra-chunk decay is
``where(mask, exp(L_t - L_j), 0)``, whose upper triangle overflows to inf
once a chunk's log-decay spans more than ~88 (a 128-token chunk at the
default init, dt ~ 1 and A = -1), and whose backward then multiplies the
masked zero by inf: every gradient is NaN. The port masks in log space
first, exp(-inf) = 0, the same forward values.
``test_ssd_gradient_is_finite_past_the_exp_range`` shows the reference's
NaN and holds the port's gradient there to the recurrence's.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.data import SyntheticDataset
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.launch.steps import batch_to, make_train_step
from repro_torch.models import lm, ssm
from repro_torch.optim import OptConfig, init_opt_state
from test_torch_train_families import (  # noqa: F401  (two fixtures)
    CONTROL_FACTOR, REDRAW, ROTATED, configs, gradient_readings, hold_gradients,
    hold_launches, one_torch_thread, pallas_alias, remat_is_bitwise, three_steps)

FAMILIES = {   # arch -> (quant mode, GRAD_TOL)
    "rwkv6-7b": ("int8", 0.03),
    "zamba2-7b": ("fp8_e4m3", 0.06),
}
F32_TOL = 2e-3
RWKV_PARAM_TOL = 0.02
REDRAW.update({
    "rwkv6-7b": {"mu_base": (0.5, 0.2), "mu": (0.5, 0.2), "w0": (-2.0, 0.5),
                 "ln_scale": (1.0, 0.2), "ln_bias": (0.0, 0.2), "mu_r": (0.5, 0.2),
                 "mu_k": (0.5, 0.2)},
    "zamba2-7b": {"A_log": (-0.5, 0.3), "D": (1.0, 0.3), "dt_bias": (0.0, 0.3),
                  "norm": (1.0, 0.2)},
})


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_gradients_match_reference(pallas_alias, arch):
    """Step-0 gradients of every leaf -- the time mix's decays, mixing
    weights and bonus, the SSD's ``A_log``, ``D``, ``dt_bias`` and convs --
    within GRAD_TOL of the reference's; the control far outside on every
    rotated site."""
    mode, tol = FAMILIES[arch]
    hold_gradients(arch, mode, tol)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_gradients_in_f32_match_reference(pallas_alias, arch):
    """The same with the model in f32: every leaf within F32_TOL, so the
    bf16 readings are rounding, not a difference of the math."""
    got, _ = gradient_readings(arch, FAMILIES[arch][0], dtype="float32")
    worst = max(got.items(), key=lambda kv: kv[1])
    assert worst[1] <= F32_TOL, worst


def test_rwkv6_three_steps_match_reference(pallas_alias):
    """rwkv6-7b: three train steps against the reference's
    ``make_train_step``: the loss within LOSS_TOL, every parameter within
    RWKV_PARAM_TOL (module docstring)."""
    three_steps("rwkv6-7b", "int8", param_tol=RWKV_PARAM_TOL)


def test_ssd_gradient_is_finite_past_the_exp_range():
    """One 128-token chunk at the default decay (A = -1, dt ~ 1): the
    reference's SSD gradient is NaN (exp overflows above the mask); the
    port's is finite, its forward equal to the reference's, and its
    gradient within 1e-4 relative L2 of the exact recurrence's
    (``decode_mamba`` stepped token by token) in f32."""
    import dataclasses

    jcfg = dataclasses.replace(jget_config("zamba2_7b").scaled_down(), dtype="float32")
    cfg = dataclasses.replace(get_config("zamba2-7b").scaled_down(), dtype="float32")
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jssm.init_mamba(jax.random.PRNGKey(0), jcfg))
    x = np.random.default_rng(0).standard_normal((1, 128, cfg.d_model)).astype(np.float32)
    r = np.random.default_rng(1).standard_normal((1, 128, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jssm.apply_mamba(jcfg, p, xx) * r)

    jy = jax.jit(lambda p, xx: jssm.apply_mamba(jcfg, p, xx))(jp, x)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x)
    assert np.isnan(np.asarray(jg[1])).all()

    p = {k: to_torch(np.asarray(v), "cpu").requires_grad_(True) for k, v in jp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    rt = torch.from_numpy(r)
    y = ssm.apply_mamba(cfg, p, xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    names = sorted(p)
    got = torch.autograd.grad((y * rt).sum(), [xt] + [p[k] for k in names])
    st = ssm.init_mamba_state(cfg, 1, torch.float32)
    ys = []
    for t in range(128):
        yt, st = ssm.decode_mamba(cfg, p, xt[:, t:t + 1], st)
        ys.append(yt)
    want = torch.autograd.grad((torch.cat(ys, 1) * rt).sum(), [xt] + [p[k] for k in names])
    for name, g, w in zip(["x"] + names, got, want):
        assert torch.isfinite(g).all(), name
        assert float((g - w).double().norm() / w.double().norm()) <= 1e-4, name


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_remat_is_bitwise(arch):
    """Recomputing each block in the backward pass (the chunked time mix,
    the chunked SSD) changes no bit of the loss or the gradients."""
    remat_is_bitwise(arch, FAMILIES[arch][0])


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_training_leaves_the_decode_path_alone(arch, monkeypatch):
    """A train step never reaches the decode blocks, whose recurrent states
    are updated in place: ``lm_loss`` runs the full-sequence forms only."""
    def refuse(*a, **k):
        raise AssertionError("a decode block ran in training")

    monkeypatch.setattr(lm, "_block_decode", refuse)
    monkeypatch.setattr(lm, "_recurrent_decode", refuse)
    _, tcfg = configs(arch, FAMILIES[arch][0])
    params = lm.init_lm(tcfg, seed=6, device="cpu")
    to = OptConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    batch = batch_to(SyntheticDataset(tcfg, ShapeSpec("t", "train", 24, 2)).batch(0), "cpu")
    _, _, m = make_train_step(tcfg, to)(params, init_opt_state(params, to), batch)
    assert torch.isfinite(m["loss"])


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_launches_per_step(arch, monkeypatch):
    """One train step's kernel calls: rwkv6 a grouped K1 at each channel
    mix's ``wv`` (2 forward, remat, 2 backward); zamba2 the grouped K1 at
    each attention layer's Q / K (3 each) and down projection (4), none at
    a mamba layer."""
    hold_launches(arch, FAMILIES[arch][0], monkeypatch)


def _losses(out: str):
    return [line.split("loss")[1].split()[0] for line in out.splitlines()
            if line.startswith("step")]


@pytest.mark.parametrize("arch, state", [("rwkv6-7b", "int8"), ("zamba2-7b", "f32")])
def test_train_cli_restart_resumes_identically(arch, state, tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu --arch <arch>``: a
    6-step run checkpoints at steps 3 and 6; with step 6's checkpoints
    removed, a restart resumes from step 3 and prints the same losses at
    steps 3-5, bitwise."""
    import shutil

    from repro_torch.launch.train import main

    ck = tmp_path / "ck"
    args = ["--device", "cpu", "--arch", arch, "--scale", "0.0025", "--seq", "32",
            "--batch", "2", "--quant", FAMILIES[arch][0], "--rotate", "hadamard",
            "--opt-state", state, "--log-every", "1", "--steps", "6",
            "--ckpt-every", "3", "--ckpt-dir", str(ck)]
    assert main(args) == 0
    full = _losses(capsys.readouterr().out)
    for d in (ck / "step_000000006", ck / "opt" / "step_000000006"):
        shutil.rmtree(d)
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "restoring checkpoint step 3" in out
    assert len(full) == 6 and _losses(out) == full[3:]
    assert all(np.isfinite(float(v)) for v in full)


if __name__ == "__main__":
    from jax.experimental.pallas import tpu as pltpu

    pltpu.TPUCompilerParams = pltpu.CompilerParams
    torch.set_num_threads(1)      # as the tests run (one_torch_thread)
    for arch, (mode, tol) in FAMILIES.items():
        for dtype in (None, "float32"):
            t0 = time.time()
            got, ctrl = gradient_readings(arch, mode, dtype=dtype)
            worst = max(got.items(), key=lambda kv: kv[1])
            rot = min((r, p) for p, r in ctrl.items() if any(s in p for s in ROTATED))
            print(f"{arch} {dtype or 'bfloat16'}: port {worst[1]:.5f} ({worst[0]}), "
                  f"control on a rotated site >= {rot[0]:.4f} ({rot[1]}); GRAD_TOL {tol}, "
                  f"F32_TOL {F32_TOL} [{time.time() - t0:.1f} s]")
