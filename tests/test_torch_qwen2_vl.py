"""PyTorch port, qwen2-vl-7b: the vlm family. The published config,
``mrope_angles`` and the M-RoPE attention against the reference's, the
prepended patch embeddings, ``make_batch``, ``lm_loss`` with patches,
``launch/flops.py``, the one-shot launcher, the engine's refusal, and the
model scaled down by the reference's own ``scaled_down`` (2 layers, 4
patches; Hadamard rotation with the KV cache quantized alike, int8 weight
storage) with the reference's parameters carried across by
``repro_torch.bridge``, against the un-meshed reference ``lm_prefill`` +
``lm_decode_step`` (backend ``pallas`` in interpret mode, jitted as
written: ``xla_allow_excess_precision`` off) on the CPU, in fp8_e4m3 (the
deployment of the card run) and int8. d_ff = 96 = 3 x 32 at this scale:
both packages run the grouped rotation and the unfused down projection, as
the published d_ff = 18944 = 37 x 512 does (one grouped K1 launch per
layer on the card).

At the scaled-down head_dim 32 (16 rotary frequencies) the published
sections (16, 24, 24) would give every frequency to the temporal stream;
the model tests override them with (4, 6, 6), the published proportions,
so that all three streams reach the angles, and feed a position grid whose
streams differ: the 4 patches at (t, h, w) = (0, i // 2, i % 2), the text
after them at t = h = w = 2 + j (``make_batch``'s positions are one stream
repeated three times).

Tolerances: ``mrope_angles`` bitwise given the same rotary frequencies
(the port's ``rope_freqs`` is within 1 f32 ulp of the reference's:
``tests/test_torch_model.py``); the model's logits at every step
(prefill, then 3 decode steps, both packages fed the reference's greedy
token) within ``LOGIT_TOL`` of the largest |logit| and ``REL_TOL`` relative
RMS, tokens by the margin rule, as ``tests/test_torch_families.py`` holds
its families. Readings over prompt seeds 0-5 (``python
tests/test_torch_qwen2_vl.py``): fp8_e4m3 bitwise or within 1.3e-7 at 5
seeds, 0.0279 / 0.0243 relative RMS at seed 3; int8 0.0069 and 0.0110 at
seeds 3 and 4, bitwise elsewhere; tokens agree at every step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.quant import QuantConfig as JQuantConfig
from repro.core.wquant import QTensor as JQTensor
from repro.core.wquant import quantize_lm_weights as jquantize_lm_weights
from repro.launch import flops as jflops
from repro.launch import shapes as jshapes
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import init_lm as jinit_lm
from repro.models import lm as jlm
from repro.models import lm_decode_step as jlm_decode_step
from repro.models import lm_prefill as jlm_prefill
from repro.models.lm import pad_kv_caches as jpad_kv_caches

from repro_torch.bridge import params_from_reference, to_reference
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import wquant
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import registry
from repro_torch.kernels.fused_quant import fused_dequant_cuda
from repro_torch.kernels.hadacore import hadacore_cuda
from repro_torch.launch import flops, serve, shapes
from repro_torch.models import attention, common, lm
from repro_torch.models.lm import init_lm, lm_decode_step, lm_prefill, pad_kv_caches

B, TEXT, STEPS = 2, 10, 3
SECTIONS = (4, 6, 6)
LOGIT_TOL, REL_TOL = 0.05, 0.04
AS_WRITTEN = {"xla_allow_excess_precision": False}
FIELDS = ("name", "family", "d_model", "num_heads", "num_kv_heads", "d_ff",
          "vocab_size", "groups", "head_dim", "rope_theta", "mrope", "mrope_sections",
          "vlm_patches", "vocab_pad_multiple", "tie_embeddings", "act", "norm",
          "qkv_bias", "is_encdec", "has_decoder", "dtype")


def _np_tree(t):
    if isinstance(t, JQTensor):
        return {"q": np.asarray(t.q), "scale": np.asarray(t.scale), "mode": t.mode}
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


def _configs(mode, weight_quant="int8"):
    jq = JQuantConfig(mode=mode, rotate="hadamard", backend="pallas", kv_quant=True)
    tq = QuantConfig(mode=mode, rotate="hadamard", backend="cuda", kv_quant=True)
    jcfg = jget_config("qwen2_vl_7b").scaled_down(mrope_sections=SECTIONS).with_quant(jq)
    tcfg = get_config("qwen2-vl-7b").scaled_down(mrope_sections=SECTIONS).with_quant(tq)
    return (dataclasses.replace(jcfg, weight_quant=weight_quant),
            dataclasses.replace(tcfg, weight_quant=weight_quant))


_MODELS = {}


def _model(mode):
    if mode not in _MODELS:
        jcfg, tcfg = _configs(mode)
        jp = jax.jit(lambda k: jquantize_lm_weights(jinit_lm(k, jcfg), jcfg))(
            jax.random.PRNGKey(0))
        _MODELS[mode] = (jcfg, tcfg, jp, params_from_reference(_np_tree(jp), device="cpu"))
    return _MODELS[mode]


def _grid(P: int, text: int, batch: int) -> np.ndarray:
    """(3, B, P + text) positions: the patches on a square (t, h, w) grid
    at t = 0, the text after them with its three streams equal."""
    side = int(round(P ** 0.5))
    i = np.arange(P)
    patch = np.stack([np.zeros(P), i // side, i % side]).astype(np.int32)
    start = int(patch.max()) + 1
    txt = np.broadcast_to(np.arange(start, start + text, dtype=np.int32), (3, text))
    return np.broadcast_to(np.concatenate([patch, txt], 1)[:, None],
                           (3, batch, P + text)).copy()


def _inputs(cfg, seed):
    """(reference batch, port batch): ``make_batch``'s tokens and patch
    embeddings for a prompt of P patches + TEXT tokens, with the position
    grid of ``_grid`` in place of its single repeated stream."""
    S = cfg.vlm_patches + TEXT
    tb = shapes.make_batch(cfg, shapes.ShapeSpec("serve", "prefill", S, B), seed=seed)
    pos = _grid(cfg.vlm_patches, TEXT, B)
    jb = {"tokens": jnp.asarray(tb["tokens"]),
          "patch_embeds": jnp.asarray(tb["patch_embeds"]).astype(jnp.bfloat16),
          "positions": jnp.asarray(pos)}
    return jb, {"tokens": torch.from_numpy(tb["tokens"]).long(),
                "patch_embeds": torch.from_numpy(tb["patch_embeds"]),
                "positions": torch.from_numpy(pos)}


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# --------------------------------------------------------------- config
def test_config_is_the_reference_config():
    """qwen2-vl-7b carries the reference's config field for field (M-RoPE,
    its sections, 1024 patches), and ``scaled_down`` keeps what the
    reference's keeps (4 patches, 2 layers, the GQA ratio 7)."""
    cfg, ref = get_config("qwen2-vl-7b"), jget_config("qwen2_vl_7b")
    assert "qwen2_vl_7b" in ARCH_IDS and get_config("qwen2_vl_7b") is cfg
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(ref, f), f
    small, jsmall = cfg.scaled_down(), ref.scaled_down()
    for f in FIELDS:
        assert getattr(small, f) == getattr(jsmall, f), f
    assert (cfg.head_dim, cfg.d_ff, cfg.vlm_patches, cfg.mrope_sections) == (
        128, 18944, 1024, (16, 24, 24))
    assert small.vlm_patches == 4 and small.num_layers == 2 and small.d_ff == 96
    assert sum(cfg.mrope_sections) == cfg.head_dim // 2


def test_published_down_projection_is_37_groups_of_512():
    from repro_torch.core.api import plan_for

    plan = plan_for(get_config("qwen2-vl-7b").d_ff, device_type="cpu")
    assert plan.grouped and (plan.n // plan.p, plan.p) == (37, 512)


# ---------------------------------------------------------------- M-RoPE
@pytest.mark.parametrize("hd,sections", [(128, (16, 24, 24)), (32, SECTIONS),
                                         (32, (16, 24, 24)), (64, (4, 4, 4))])
def test_mrope_angles_are_the_reference_angles(hd, sections, monkeypatch):
    """``mrope_angles`` on (3, B, S) positions whose streams differ, against
    the compiled reference given the same rotary frequencies: bitwise (its
    one-hot einsum adds exact zeros to the chosen product; an index
    gather). Frequencies past the sections take the temporal stream. Each
    frequency takes its own stream's angle, and the port's ``rope_freqs``
    is within 1 f32 ulp of the reference's."""
    rng = np.random.default_rng(hd)
    pos = rng.integers(0, 40000, (3, 2, 37)).astype(np.int32)
    freqs = common.rope_freqs(hd, 1e6)
    ref_freqs = np.asarray(jcommon.rope_freqs(hd, 1e6))
    assert (np.abs(freqs.numpy().view(np.int32) - ref_freqs.view(np.int32)) <= 1).all()
    monkeypatch.setattr(jcommon, "rope_freqs", lambda h, t: jnp.asarray(freqs.numpy()))
    want = np.asarray(jax.jit(lambda p: jcommon.mrope_angles(p, hd, 1e6, sections))(pos))
    got = common.mrope_angles(torch.from_numpy(pos), hd, 1e6, sections).numpy()
    assert got.shape == (2, 37, hd // 2)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    stream = ([i for i, s in enumerate(sections) for _ in range(s)] + [0] * hd)[:hd // 2]
    for h in range(hd // 2):
        np.testing.assert_array_equal(got[..., h], pos[stream[h]].astype(np.float32) * freqs[h].item())


def test_attention_takes_the_three_streams():
    """Under M-RoPE the attention's angles are ``mrope_angles`` of the
    (3, B, S) positions; moving only the height stream moves the output,
    and the reference's ``_positions_angles`` agrees bitwise on the same
    frequencies."""
    jcfg, tcfg = _configs("int8")
    pos = _grid(4, 3, B)
    got = attention._positions_angles(tcfg, torch.from_numpy(pos))
    np.testing.assert_array_equal(
        got.numpy(), common.mrope_angles(torch.from_numpy(pos), tcfg.head_dim,
                                         tcfg.rope_theta, SECTIONS).numpy())
    moved = pos.copy()
    moved[1] += 3
    assert not torch.equal(attention._positions_angles(tcfg, torch.from_numpy(moved)), got)
    assert jattn._positions_angles(jcfg, jnp.asarray(pos)).shape == tuple(got.shape)


# ---------------------------------------------------------------- model
def _run(mode, seed):
    """Prefill of 4 patches + TEXT tokens on the position grid, then
    ``STEPS`` decode steps in each package, both fed the reference's greedy
    token. Per step: (largest gap / largest |logit|, relative RMS gap,
    tokens agree by the margin rule)."""
    jcfg, tcfg, jp, params = _model(mode)
    V = tcfg.vocab_size
    jb, tb = _inputs(tcfg, seed)
    S = tcfg.vlm_patches + TEXT
    T = S + STEPS + 1
    jpre = jax.jit(lambda p, b: jlm_prefill(jcfg, p, b), compiler_options=AS_WRITTEN)
    jdec = jax.jit(lambda p, c, t, pos: jlm_decode_step(jcfg, p, c, t, pos),
                   compiler_options=AS_WRITTEN)
    jl, jc = jpre(jp, jb)
    jc = jpad_kv_caches(jcfg, jc, T)
    with torch.inference_mode():
        tl, tc = lm_prefill(tcfg, params, tb)
        tc = pad_kv_caches(tcfg, tc, T)
    steps = []
    for i in range(STEPS + 1):
        g = tl[:, -1, :V].float().numpy()
        w = np.asarray(jl[:, -1, :V], np.float32)
        assert np.isfinite(g).all()
        gap = np.abs(g - w).max()
        top = np.sort(w, -1)
        sure = top[:, -1] - top[:, -2] > 2 * gap
        steps.append((gap / np.abs(w).max(), np.linalg.norm(g - w) / np.linalg.norm(w),
                      bool(((g.argmax(-1) == w.argmax(-1)) | ~sure).all())))
        if i < STEPS:
            jt = jnp.argmax(jl[:, -1, :V], -1).astype(jnp.int32)[:, None]
            jl, jc = jdec(jp, jc, jt, jnp.asarray(S + i, jnp.int32))
            with torch.inference_mode():
                tl, tc = lm_decode_step(tcfg, params, tc, torch.from_numpy(np.array(jt)).long(),
                                        torch.tensor(S + i))
    return steps


@pytest.mark.parametrize("mode", ["fp8_e4m3", "int8"])
def test_prefill_and_decode_match_reference(mode):
    """Prefill logits (patches prepended, three distinct position streams)
    and 3 decode steps of the scaled qwen2-vl against the reference, in
    fp8_e4m3 and in int8: within the logit tolerances at every step, tokens
    by the margin rule; CPU tensors launch no kernel."""
    before = (hadacore_cuda.launches, fused_dequant_cuda.launches)
    for i, (gap, rel, same) in enumerate(_run(mode, 0)):
        assert gap <= LOGIT_TOL and rel <= REL_TOL and same, (mode, i, gap, rel, same)
    assert (hadacore_cuda.launches, fused_dequant_cuda.launches) == before


def test_prefill_reads_the_patches_and_every_stream():
    """The prefill's last logits move when a patch embedding moves and when
    only the height stream of the patches' positions moves: the patches
    and the grid reach the model."""
    _, tcfg, _, params = _model("int8")
    _, tb = _inputs(tcfg, 1)
    with torch.inference_mode():
        base = lm_prefill(tcfg, params, tb)[0]
        p2 = dict(tb, patch_embeds=tb["patch_embeds"] * 2)
        pos = tb["positions"].clone()
        pos[1, :, :tcfg.vlm_patches] += 1
        for moved in (p2, dict(tb, positions=pos)):
            assert not torch.equal(lm_prefill(tcfg, params, moved)[0], base)


def test_lm_loss_with_patches_matches_reference():
    """``lm_loss`` drops the patch positions' logits before the
    cross-entropy over the text labels, as the reference does; the loss on
    ``make_batch``'s batch agrees with the reference's."""
    jcfg, tcfg, jp, params = _model("int8")
    S = tcfg.vlm_patches + TEXT
    shape = jshapes.ShapeSpec("t", "train", S, B)
    jb = jshapes.make_batch(jcfg, shape, seed=4)
    tb = {k: torch.from_numpy(v) for k, v in shapes.make_batch(tcfg, shape, seed=4).items()}
    tb["tokens"] = tb["tokens"].long()
    assert tb["labels"].shape == (B, TEXT)
    want = float(jax.jit(lambda p, b: jlm.lm_loss(jcfg, p, b)[0], compiler_options=AS_WRITTEN)(jp, jb))
    with torch.inference_mode():
        got = float(lm.lm_loss(tcfg, params, tb)[0])
    assert abs(got - want) <= 2e-3 * abs(want), (got, want)


# ------------------------------------------------------ bridge, batches
def test_bridge_both_ways():
    """The scaled qwen2-vl's reference parameters cross into the port's
    per-layer list and back bit for bit, and the port's own init has the
    reference's tree."""
    jcfg, tcfg = _configs("fp8_e4m3", weight_quant="none")
    ref = _np_tree(jinit_lm(jax.random.PRNGKey(3), jcfg))
    params = params_from_reference(ref, device="cpu")
    assert len(params["layers"]) == 2 and "enc_layers" not in params
    back = to_reference(params, tcfg)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back) and "enc_groups" not in back
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]).view(np.uint8),
                                      np.asarray(leaf).view(np.uint8))
    mine = to_reference(init_lm(tcfg, seed=0, device="cpu"), tcfg, meta=True)
    shapes_of = {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                 for p, v in jax.tree_util.tree_leaves_with_path(mine)}
    assert shapes_of == {p: (tuple(v.shape), v.dtype.name) for p, v in flat_ref}


def test_make_batch_is_the_reference_batch():
    """``make_batch`` draws the reference's tokens (S - P), labels, patch
    embeddings and (3, B, S) positions from the same seed in its order:
    integers bitwise, the embeddings bitwise once rounded to bf16."""
    cfg, ref = get_config("qwen2-vl-7b").scaled_down(), jget_config("qwen2_vl_7b").scaled_down()
    for seq, batch in ((12, 3), (5, 1)):
        got = shapes.make_batch(cfg, shapes.ShapeSpec("p", "prefill", seq, batch), seed=6)
        want = jshapes.make_batch(ref, jshapes.ShapeSpec("p", "prefill", seq, batch), seed=6)
        assert set(got) == set(want) == {"tokens", "labels", "patch_embeds", "positions"}
        assert got["tokens"].shape == (batch, seq - cfg.vlm_patches)
        assert got["positions"].shape == (3, batch, seq)
        for k in ("tokens", "labels", "positions"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_array_equal(
            torch.from_numpy(got["patch_embeds"]).to(torch.bfloat16).float().numpy(),
            _f32(want["patch_embeds"]))
    for name, shape in shapes.SHAPES.items():
        assert shapes.shape_applicable(cfg, shape) == jshapes.shape_applicable(
            ref, jshapes.SHAPES[name]), name


def test_count_params_and_model_flops_match_reference():
    cfg, ref = get_config("qwen2-vl-7b"), jget_config("qwen2_vl_7b")
    assert flops.count_params(cfg) == jflops.count_params(ref)
    for name, shape in shapes.SHAPES.items():
        assert flops.model_flops(cfg, shape) == jflops.model_flops(ref, jshapes.SHAPES[name]), name


def test_transform_harness_times_the_vlm_path_shapes():
    """``bench/hadamard.py`` times grouped K1 at qwen2-vl's down projection
    (37 x 512) and K2 fp8_e4m3 at its Q / K sites (28 / 4 heads of 128),
    at decode (4 slots) and at the launcher cell's prefill (4 x (1024
    patches + 64 tokens))."""
    from repro_torch.bench import hadamard as bench

    path = {(c.kernel, c.site, c.rows, c.n, c.mode) for c in bench.CASES if c.group == "path"}
    tok = bench.SLOTS * (1024 + bench.VLM_TEXT)
    assert {("K1", "qwen2-vl-7b decode down-proj", 148, 512, None),
            ("K1", "qwen2-vl-7b prefill down-proj", 161024, 512, None),
            ("K2", "qwen2-vl-7b decode Q", 112, 128, "fp8_e4m3"),
            ("K2", "qwen2-vl-7b decode K", 16, 128, "fp8_e4m3"),
            ("K2", "qwen2-vl-7b prefill Q", 28 * tok, 128, "fp8_e4m3"),
            ("K2", "qwen2-vl-7b prefill K", 4 * tok, 128, "fp8_e4m3")} <= path
    assert tok * 28 == 121856


# ------------------------------------------------------ sites, launcher
def test_each_layer_reaches_one_grouped_rotation_and_two_fused_qk_sites(monkeypatch):
    """Per pass, prefill and decode, each layer's down projection reaches
    the standalone transform once (grouped K1 on the card: 28 per pass at
    full depth) and the Q and K sites fused_dequant once each (K2: 56);
    never the fused quant_dot."""
    _, tcfg, _, params = _model("fp8_e4m3")
    calls = {n: 0 for n in ("transform", "fused_dequant", "fused", "quant_dot",
                            "quant_dot_experts")}
    for name in calls:
        real = getattr(registry.CudaBackend, name)

        def spy(self, *a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(registry.CudaBackend, name, spy)
    before = wquant.QUANTIZE_WEIGHT_CALLS
    _, tb = _inputs(tcfg, 2)
    S = tcfg.vlm_patches + TEXT
    L = tcfg.num_layers
    want = {"transform": L, "fused_dequant": 2 * L, "fused": 0, "quant_dot": 0,
            "quant_dot_experts": 0}
    with torch.inference_mode():
        logits, c = lm_prefill(tcfg, params, tb)
        assert calls == want
        c = pad_kv_caches(tcfg, c, S + 1)
        for k in calls:
            calls[k] = 0
        lm_decode_step(tcfg, params, c, logits[:, -1, :tcfg.vocab_size].argmax(-1)[:, None],
                       torch.tensor(S))
    assert calls == want
    assert wquant.QUANTIZE_WEIGHT_CALLS == before


def test_serve_launcher_runs_on_cpu(capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --device cpu --arch qwen2-vl-7b``
    at ``--scale 0.005``: ``--prompt-len`` 1040 holds the 1024 patches and
    16 tokens, all of ``make_batch``'s batch goes to the prefill, and decode
    starts at 1040 + 1024 in caches padded to 1040 + 4, past their end, as
    the reference's launcher runs it (every step writes the last row). The
    tokens and every step's logits, with the reference's parameters,
    against the reference's un-meshed jitted ``lm_prefill`` /
    ``pad_kv_caches`` / ``lm_decode_step`` driven the same way and fed the
    launcher's tokens, under the margin rule."""
    from test_torch_rwkv import launcher_against_reference

    argv = ["--device", "cpu", "--arch", "qwen2-vl-7b", "--scale", "0.005",
            "--batch", "2", "--prompt-len", "1040", "--gen", "4", "--quant", "fp8_e4m3",
            "--rotate", "hadamard", "--seed", "3"]
    out, steps = launcher_against_reference("qwen2-vl-7b", "qwen2_vl_7b", argv, 1040, 2, 4,
                                            monkeypatch)
    cfg, toks = out["cfg"], out["tokens"]
    assert cfg.mrope and cfg.vlm_patches == 1024 and cfg.quant.mode == "fp8_e4m3"
    assert toks.shape == (2, 4) and ((0 <= toks) & (toks < cfg.vocab_size)).all()
    assert out["decode_steps"] == 2 and out["tokens_per_s"] > 0
    assert "qwen2-vl-7b" in capsys.readouterr().out
    for i, (gap, rel, same) in enumerate(steps):
        assert gap <= LOGIT_TOL and rel <= REL_TOL and same, (i, gap, rel, same)


def test_decode_past_the_cache_writes_its_last_row():
    """A decode position past the cache writes the cache's last row (the
    reference's ``dynamic_update_slice`` clamps its start) and attends to
    every row; positions inside the cache are unaffected -- scalar and
    per-slot."""
    _, tcfg, _, params = _model("int8")
    p = lm._dequant_layer(tcfg, params["layers"][0], torch.bfloat16)["attn"]
    x = torch.randn(2, 1, tcfg.d_model, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    T, KH, hd = 6, tcfg.num_kv_heads, tcfg.head_dim
    for pos in (torch.tensor(9), torch.tensor([2, 9])):
        ck = torch.zeros((2, T, KH, hd), dtype=torch.bfloat16)
        cv = torch.zeros_like(ck)
        positions = (pos if pos.ndim else pos.expand(2))[:, None].to(torch.int32)
        attention.decode_attention(tcfg, p, x, ck, cv, pos, positions[None].expand(3, 2, 1))
        rows = pos.clamp(max=T - 1).expand(2)
        for b in range(2):
            written = ck[b].float().abs().sum((-1, -2)) > 0
            assert written.nonzero().flatten().tolist() == [int(rows[b])], (pos, b)


def test_engine_rejects_the_vlm():
    """The serving engine refuses qwen2-vl with the reference's message."""
    from repro.serving.engine import _validate_config as jvalidate
    from repro_torch.serving.engine import _validate_config

    jcfg, tcfg = _configs("fp8_e4m3")
    with pytest.raises(ValueError) as mine:
        _validate_config(tcfg)
    with pytest.raises(ValueError) as ref:
        jvalidate(jcfg)
    assert str(mine.value) == str(ref.value) and "family='vlm'" in str(mine.value)


if __name__ == "__main__":
    # The readings behind the tolerances:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_qwen2_vl.py
    for mode in ("fp8_e4m3", "int8"):
        for seed in range(6):
            st = _run(mode, seed)
            print(f"qwen2-vl {mode} seed {seed}: largest gap {max(s[0] for s in st):.4f} of "
                  f"max |logit|, relative RMS {max(s[1] for s in st):.4f}, tokens agree "
                  f"(margin rule) {all(s[2] for s in st)}")
