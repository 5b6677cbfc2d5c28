"""PyTorch port, tensor parallelism over 'model': the attention heads, the
KV heads, the dense MLP's hidden width and the vocabulary split across the
ranks of the mesh's 'model' axis (``distributed.sharding.model_split``),
on CPU ranks of a gloo process group (``repro_torch.testing.ranks``),
held against the reference's un-meshed functions on bridged parameters
(``jax.jit``, ``xla_allow_excess_precision`` off, backend 'xla': the
reference's plain path) and against the port without a mesh.

Two scaled-down models, 2 layers, vocabulary 512, head_dim 64, with int8
weight storage when serving (every matrix at least 2^16 entries a layer, so
the port's per-layer size floor quantizes what the reference's stacked one
does):

  * phi4-mini-3.8b, d_model 384, int8 + Hadamard, 8 query and 4 KV heads,
    d_ff 512 (the fused down projection: K4's plain version), tied
    embeddings;
  * llama3-8b, d_model 512, fp8_e4m3 + Hadamard, 8 query and 2 KV heads,
    d_ff 896 = 7 x 128 (the grouped down projection); at D = 4 its KV heads
    do not split, so K / V stay whole on every rank.

Meshes (1, 2) and (1, 4) (world 2 and 4) and (2, 2) (world 4; rows over
'data' too). Held, for both models:

  * one attention block and one MLP block (layer 0, raw weights) against
    the reference's ``apply_attention`` / ``apply_mlp``: in f32 within
    ``F32_TOL`` relative L2 [reads at most 5.7e-7]; in bf16 within
    ``BF16_TOL`` [the meshes read at most 1.11e-3; the witness, the port
    without a mesh, 1.11e-3; the controls at (1, 2) -- the attention's
    ``reduce_from_model`` dropped, the MLP's ``gather_from_model`` leaving
    the other ranks' hidden columns zero -- at least 0.71];
  * prefill and 8 decode steps, teacher-forced with the reference's greedy
    tokens (the same context in both packages at every step): the logits'
    greedy token the reference's wherever its top-1 / top-2 margin exceeds
    twice the step's largest logit gap (the margin rule);
  * the weights a rank holds live in a layer: Q / K / V and gate / up on
    1 / D of their columns, O on 1 / D of its rows, the down projection
    whole over d_ff, the embedding 1 / D of the vocabulary;
  * each rank's KV cache at KH / D heads (KH where 'kv' does not divide),
    ``serving.cache.cache_bytes`` on the mesh at that share, and the Q / K
    sites' rows (K2's on the card) at H / D and KH / D heads;
  * ``TRACE_COUNTS[("tensor_parallel", kind, "split")]`` once per layer
    and pass; for mixtral-8x7b (MoE), rwkv6-7b, zamba2-7b (Mamba2 beside
    attention; SSD heads of 8) and whisper-base (the encoder and cross
    attention) at (1, 2), every layer ``split`` (the MoE, RWKV6 and Mamba2
    layers since their split, ``tests/test_torch_tensor_parallel_moe_
    recurrent.py``), none ``replicated``; zamba2-7b's 7 SSD heads of 16
    at the default scale raise;
  * step-0 gradients of every leaf (training's raw bf16 weights) against
    ``jax.grad`` of the reference's ``lm_loss`` within ``GRAD_TOL``
    relative L2, ``tests/test_torch_train.py``'s limit [the meshes read
    at most 0.0117; the witness, the port without a mesh, 0.0097]; at
    (1, 2) the control, ``copy_to_model`` summing nothing in its backward,
    falls outside it on some leaf [reads 0.96 at least].

A (1, 1) mesh (world 1) gives the no-mesh path's blocks, logits and
gradients bit for bit. A checkpoint written by ``launch.train --mp 2`` at
world 2 (mesh (1, 2)) restores bitwise onto (2, 1) (sharded and gathered
back), and a ``--mp 1`` restart from it at world 2 repeats a world-1
restart's next loss within ``LOSS_TOL``.

Readings: this file's own quantities, printed by ``python
tests/test_torch_tensor_parallel.py``.
"""
import contextlib
import copy
import dataclasses
import io
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.quant import QuantConfig as JQuantConfig
from repro.core.wquant import QTensor as JQTensor
from repro.core.wquant import quantize_lm_weights as jquantize_lm_weights
from repro.data import SyntheticDataset as JSyntheticDataset
from repro.launch.shapes import ShapeSpec as JShapeSpec
from repro.models import attention as jattn
from repro.models import init_lm as jinit_lm
from repro.models import lm_decode_step as jlm_decode_step
from repro.models import lm_loss as jlm_loss
from repro.models import lm_prefill as jlm_prefill
from repro.models import mlp as jmlp
from repro.models.lm import pad_kv_caches as jpad_kv_caches

from repro_torch import tree as T
from repro_torch.bridge import params_from_reference
from repro_torch.testing.ranks import run_ranks

ARCHS = {"phi4-mini-3.8b": ("phi4_mini_3_8b", "int8",
                             dict(d_model=384, num_kv_heads=4, d_ff=512)),
         "llama3-8b": ("llama3_8b", "fp8_e4m3", dict(d_model=512, num_kv_heads=2, d_ff=896))}
SHAPE = dict(num_heads=8, head_dim=64)
MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}
B, S, GEN = 2, 16, 8
F32_TOL, BF16_TOL, GRAD_TOL, LOSS_TOL = 1e-5, 1e-2, 0.03, 2e-3
AS_WRITTEN = {"xla_allow_excess_precision": False}
FAMILIES = ("mixtral-8x7b", "rwkv6-7b", "zamba2-7b", "whisper-base")
# zamba2-7b scaled down has 7 SSD heads of 16, which no 'model' axis of 2
# splits: its heads of 8 (14 of them) do; at 7 heads the layer raises
FAMILY_OVERRIDES = {"zamba2-7b": dict(ssm_head_dim=8)}


# ------------------------------------------------------------- configs
def _configs(arch: str, dtype: str = "bfloat16", serving: bool = False):
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig

    jname, mode, over = ARCHS[arch]
    kw = dict(SHAPE, dtype=dtype, **over)
    jcfg = jget_config(jname).scaled_down(**kw).with_quant(
        JQuantConfig(mode=mode, rotate="hadamard", backend="xla", kv_quant=True))
    tcfg = get_config(arch).scaled_down(**kw).with_quant(
        QuantConfig(mode=mode, rotate="hadamard", backend="cuda", kv_quant=True))
    if serving:
        jcfg = dataclasses.replace(jcfg, weight_quant="int8")
        tcfg = dataclasses.replace(tcfg, weight_quant="int8")
    return jcfg, tcfg


def _np_tree(t):
    if isinstance(t, JQTensor):
        return {"q": np.asarray(t.q), "scale": np.asarray(t.scale), "mode": t.mode}
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _rel(got, want) -> float:
    got, want = _f64(got), _f64(want)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else float(np.abs(got).max())


def _inputs(cfg):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return x, prompt


def _train_batch(jcfg):
    return JSyntheticDataset(jcfg, JShapeSpec("tp", "train", S, B), seed=0).batch(0)


# ------------------------------------------------------- the reference
def _reference(arch: str):
    """The reference's blocks (f32, bf16), teacher-forced prefill + decode
    logits with its greedy tokens, and step-0 gradients; the bridged
    parameters of each."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _configs(arch, dtype)
        jp = jax.jit(lambda k: jinit_lm(k, jcfg))(jax.random.PRNGKey(0))
        layer = jax.tree.map(lambda a: a[0], jp["groups"][0]["p0"])
        x, _ = _inputs(jcfg)
        jx = jnp.asarray(x, jcfg.dtype)
        pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
        attn = jax.jit(lambda p, a: jattn.apply_attention(jcfg, p, a, pos),
                       compiler_options=AS_WRITTEN)(layer["attn"], jx)
        mlp = jax.jit(lambda p, a: jmlp.apply_mlp(jcfg, p, a),
                      compiler_options=AS_WRITTEN)(layer["mlp"], jx)
        out[dtype] = {"params": params_from_reference(_np_tree(jp), "cpu"),
                      "attn": _f64(attn), "mlp": _f64(mlp)}
        if dtype == "bfloat16":
            grad = jax.jit(jax.grad(lambda p, b: jlm_loss(jcfg, p, b)[0]),
                           compiler_options=AS_WRITTEN)(jp, _train_batch(jcfg))
            out["grads"] = [_f64(t) for t in
                            T.leaves(params_from_reference(_np_tree(grad), "cpu"))]
    jcfg, _ = _configs(arch, serving=True)
    jp = jax.jit(lambda k: jquantize_lm_weights(jinit_lm(k, jcfg), jcfg))(
        jax.random.PRNGKey(0))
    _, prompt = _inputs(jcfg)
    pre = jax.jit(lambda p, b: jlm_prefill(jcfg, p, b), compiler_options=AS_WRITTEN)
    dec = jax.jit(lambda p, c, t, i: jlm_decode_step(jcfg, p, c, t, i),
                  compiler_options=AS_WRITTEN)
    logits, caches = pre(jp, {"tokens": jnp.asarray(prompt)})
    caches = jpad_kv_caches(jcfg, caches, S + GEN)
    steps, tokens = [], []
    for i in range(GEN + 1):
        last = np.asarray(logits[:, -1, :jcfg.vocab_size].astype(jnp.float32), np.float64)
        steps.append(last)
        tok = last.argmax(-1).astype(np.int32)[:, None]
        tokens.append(tok)
        if i < GEN:
            logits, caches = dec(jp, caches, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
    out["serve"] = {"params": params_from_reference(_np_tree(jp), "cpu"),
                    "prompt": prompt, "logits": steps, "tokens": tokens,
                    "batch": _train_batch(jcfg)}
    return out


# ---------------------------------------------------------- the port
class _UnsummedCopy(torch.autograd.Function):
    """The gradient control's ``copy_to_model``: identity both ways."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _zero_padded_gather(t, axes, dim):
    """The MLP control's ``gather_from_model``: this rank's columns in
    place, the other ranks' zero."""
    from repro_torch.distributed.sharding import current_mesh

    mesh = current_mesh()
    n, i = mesh.group_size(axes), mesh.index(axes)
    shape = list(t.shape)
    shape[dim] *= n
    out = t.new_zeros(shape)
    out.narrow(dim, i * t.shape[dim], t.shape[dim]).copy_(t)
    return out


@contextlib.contextmanager
def _on(mesh, rows=()):
    from repro_torch.distributed.sharding import local_rows, sharding_rules

    if mesh is None:
        yield
        return
    with sharding_rules(mesh), local_rows(rows):
        yield


def _shards(cfg, params, mesh):
    """(params as this rank's shards, their parts) on ``mesh``; the whole
    tree and None off a mesh."""
    from repro_torch.distributed.collectives import shard_tree
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.models.lm import param_parts

    if mesh is None:
        return params, None
    with sharding_rules(mesh):
        parts = param_parts(cfg, mesh)
    return shard_tree(params, parts, mesh), parts


def _rows(mesh):
    from repro_torch.launch.steps import batch_row_axes

    return () if mesh is None else batch_row_axes(mesh, B)


def _gathered(t, mesh, rows):
    return t if mesh is None else mesh.gather(t, rows, 0)


def _blocks(cfg, params, mesh, control: bool = False):
    """Layer 0's attention and MLP blocks on the inputs of ``_inputs``:
    (attention, MLP) outputs, whole, f64. ``control``: the attention's
    reduce dropped, the MLP's gather zero-padded."""
    from repro_torch.distributed import collectives as C
    from repro_torch.models import attention as A
    from repro_torch.models import mlp as M
    from repro_torch.models.common import dtype_of
    from repro_torch.models.lm import _layer_params

    from repro_torch.models.lm import _top

    dt = dtype_of(cfg)
    shards, parts = _shards(cfg, params, mesh)
    rows = _rows(mesh)
    x, _ = _inputs(cfg)
    x = torch.from_numpy(x).to(dt)
    x = x if mesh is None else mesh.chunk(x, rows, 0)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(x.shape[0], S)
    saved = C.reduce_from_model, C.gather_from_model
    if control:
        C.reduce_from_model, C.gather_from_model = (lambda t, axes: t), _zero_padded_gather
    try:
        with _on(mesh, rows), torch.no_grad():
            lp = _layer_params(cfg, shards["layers"][0], dt,
                               None if parts is None else parts["layers"][0], "attn")
            ya = A.apply_attention(cfg, lp["attn"], x, pos)
            ym = M.apply_mlp(cfg, lp["mlp"], x)
            live = {k: tuple(lp[b][k].shape) for b in ("attn", "mlp") for k in lp[b]}
            live["emb"] = tuple(_top(cfg, shards, "emb").shape)
    finally:
        C.reduce_from_model, C.gather_from_model = saved
    return _f64(_gathered(ya, mesh, rows)), _f64(_gathered(ym, mesh, rows)), live


def _serve(cfg, params, prompt, ref_tokens, mesh):
    """Prefill + GEN decode steps, teacher-forced with ``ref_tokens``:
    (each step's last logits, f64; per-layer cache shapes; cache_bytes on
    the mesh; the Q / K sites' (q, k) head counts; the tensor_parallel
    ticks of the prefill)."""
    from repro_torch.kernels.registry import TRACE_COUNTS
    from repro_torch.models import attention as A
    from repro_torch.models.lm import lm_decode_step, lm_prefill, pad_kv_caches
    from repro_torch.serving.cache import cache_bytes

    shards, _ = _shards(cfg, params, mesh)
    rows = _rows(mesh)
    toks = torch.from_numpy(prompt).long()
    toks = toks if mesh is None else mesh.chunk(toks, rows, 0)
    sites, real = [], A._rotate_quant_qk

    def seen(c, q, k):
        sites.append((q.shape[2], k.shape[2]))
        return real(c, q, k)

    for key in [k for k in TRACE_COUNTS if k[0] == "tensor_parallel"]:
        del TRACE_COUNTS[key]
    steps = []
    A._rotate_quant_qk = seen
    try:
        with _on(mesh, rows), torch.no_grad():
            logits, caches = lm_prefill(cfg, shards, {"tokens": toks})
            ticks = {k: v for k, v in TRACE_COUNTS.items() if k[0] == "tensor_parallel"}
            shapes = [tuple(c["k"].shape) for c in caches]
            caches = pad_kv_caches(cfg, caches, S + GEN)
            for i in range(GEN + 1):
                steps.append(_f64(_gathered(logits[:, -1, :cfg.vocab_size], mesh, rows)))
                if i < GEN:
                    t = torch.from_numpy(ref_tokens[i]).long()
                    t = t if mesh is None else mesh.chunk(t, rows, 0)
                    logits, caches = lm_decode_step(cfg, shards, caches, t,
                                                    torch.tensor(S + i))
    finally:
        A._rotate_quant_qk = real
    per_rank = cache_bytes(cfg, B // (1 if mesh is None else mesh.group_size(rows)),
                           S, mesh)
    return {"logits": steps, "shapes": shapes, "bytes": per_rank, "sites": sites[0],
            "ticks": ticks}


def _grads(cfg, params, batch, mesh, control: bool = False):
    """Step-0 gradients of every leaf (gathered whole, f64), in the port's
    leaf order. ``control``: ``copy_to_model`` sums nothing."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.collectives import gather_tree
    from repro_torch.launch.steps import batch_to, local_batch
    from repro_torch.models.lm import lm_loss

    params = T.tree_map(lambda t: t.detach().clone(), params)
    shards, parts = _shards(cfg, params, mesh)
    rows = _rows(mesh)
    b = batch_to(batch, "cpu")
    b = b if mesh is None else local_batch(b, mesh, rows)
    flat = T.leaves(shards)
    for p in flat:
        p.requires_grad_(True)
    copy = C._CopyToModel
    C._CopyToModel = _UnsummedCopy if control else copy
    try:
        with _on(mesh, rows):
            g = torch.autograd.grad(lm_loss(cfg, shards, b)[0], flat)
    finally:
        C._CopyToModel = copy
    g = T.unflatten(shards, list(g))
    if mesh is not None:
        g = gather_tree(g, parts, mesh)
    return [_f64(t) for t in T.leaves(g)]


def _port(arch: str, ref, mesh, controls: bool = False):
    """Every port reading of ``arch`` on ``mesh`` (None: no mesh)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        _, tcfg = _configs(arch, dtype)
        out[dtype] = _blocks(tcfg, ref[dtype]["params"], mesh)
        if controls and dtype == "bfloat16":
            out["control"] = _blocks(tcfg, ref[dtype]["params"], mesh, control=True)
    _, tcfg = _configs(arch)
    out["grads"] = _grads(tcfg, ref["bfloat16"]["params"], ref["serve"]["batch"], mesh)
    if controls:
        out["grads_control"] = _grads(tcfg, ref["bfloat16"]["params"], ref["serve"]["batch"],
                                      mesh, control=True)
    _, scfg = _configs(arch, serving=True)
    sv = ref["serve"]
    out["serve"] = _serve(scfg, sv["params"], sv["prompt"], sv["tokens"], mesh)
    return out


def _families():
    """The tensor_parallel ticks of one prefill of each of FAMILIES
    (scaled down, seeded weights) on the active mesh."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.distributed.collectives import shard_tree
    from repro_torch.kernels.registry import TRACE_COUNTS
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import batch_to
    from repro_torch.data import SyntheticDataset
    from repro_torch.distributed.sharding import current_mesh
    from repro_torch.models.lm import init_lm, lm_forward, param_parts

    mesh, out = current_mesh(), {}
    quant = QuantConfig(mode="int8", rotate="hadamard", backend="cuda", kv_quant=True)

    def forward(cfg):
        params = shard_tree(init_lm(cfg, seed=0, device="cpu"), param_parts(cfg, mesh), mesh)
        batch = batch_to(SyntheticDataset(cfg, ShapeSpec("tp", "train", S, B)).batch(0), "cpu")
        with torch.no_grad():
            lm_forward(cfg, params, batch)

    for arch in FAMILIES:
        cfg = get_config(arch).scaled_down(**FAMILY_OVERRIDES.get(arch, {})).with_quant(quant)
        for key in [k for k in TRACE_COUNTS if k[0] == "tensor_parallel"]:
            del TRACE_COUNTS[key]
        forward(cfg)
        out[arch] = ({k[1:]: v for k, v in TRACE_COUNTS.items() if k[0] == "tensor_parallel"},
                     list(cfg.layer_kinds), list(cfg.encoder_layer_kinds))
    try:
        forward(get_config("zamba2-7b").scaled_down().with_quant(quant))
        out["unsplit"] = None
    except NotImplementedError as e:
        out["unsplit"] = str(e)
    return out


def _train(argv):
    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train.main(argv) == 0
    return buf.getvalue()


TRAIN = ["--device", "cpu", "--arch", "phi4-mini-3.8b", "--scale", "0.005", "--seq", "16",
         "--batch", str(2 * B), "--quant", "int8", "--rotate", "hadamard", "--kernel", "cuda",
         "--log-every", "1", "--lr", "1e-3", "--ckpt-every", "1"]


def _checkpoint(root: str, mesh):
    """At world 2: ``launch.train --mp 2`` writes step 1; it is restored,
    sharded onto ``mesh`` ((2, 1)) and gathered back; ``--mp 1`` restarts
    from it. (whole trees, round-tripped trees, the restart's text)."""
    from repro_torch.distributed.collectives import gather_tree, shard_tree
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.launch.serve_loop import scaled_config
    from repro_torch.launch.steps import opt_state_parts, param_parts
    from repro_torch.launch.train import restore_state
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig

    d = os.path.join(root, "mp2")
    _train(TRAIN + ["--mp", "2", "--steps", "1", "--ckpt-dir", d])
    mesh.all_reduce(torch.zeros(1), mesh.axis_names)      # rank 0 has written it
    cfg = scaled_config(get_config("phi4-mini-3.8b"), 0.005).with_quant(
        QuantConfig(mode="int8", rotate="hadamard", backend="cuda", kv_quant=True))
    fresh, opt = init_lm(cfg, seed=7, device="cpu"), OptConfig()
    whole = restore_state(d, 1, cfg, fresh, init_opt_state(fresh, opt), "cpu")
    with sharding_rules(mesh):
        parts = (param_parts(cfg, mesh), opt_state_parts(cfg, opt, mesh))
    back = [gather_tree(shard_tree(t, pp, mesh), pp, mesh) for t, pp in zip(whole, parts)]
    if mesh.rank == 0:
        shutil.copytree(d, os.path.join(root, "w1"))
    mesh.all_reduce(torch.zeros(1), mesh.axis_names)
    text = _train(TRAIN + ["--mp", "1", "--steps", "2", "--ckpt-dir", d])
    leaves = [[[_f64(t) for t in T.leaves(tree)] for tree in trees] for trees in (whole, back)]
    return leaves, text


def _rank(rank, world, refs, root):
    """The mesh runs of ``world`` (``MESHES``): rank 0's readings."""
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.launch.mesh import Mesh, make_local_mesh

    out = {}
    for shape in MESHES.get(world, ((1, 1),)):
        mesh = make_local_mesh(shape[1])
        controls = shape == (1, 2)
        out[shape] = {arch: _port(arch, refs[arch], mesh, controls) for arch in ARCHS}
        if controls:
            with sharding_rules(mesh):
                out["families"] = _families()
    if world == 2:
        out["checkpoint"] = _checkpoint(root, Mesh((2, 1), ("data", "model"), rank=rank))
    return out if rank == 0 else None


def _all_runs(root: str) -> dict:
    """The reference in this process; worlds 1, 2 and 4 started from
    threads beside the port without a mesh (one torch thread, as the
    ranks)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {arch: _reference(arch) for arch in ARCHS}
        # each world its own copy: sending a tensor to a spawned process moves
        # its storage into shared memory in place, which must not happen to
        # one tensor from several threads, nor under the no-mesh run below
        copies = {w: copy.deepcopy(refs) for w in (1, 2, 4)}
        box = {}

        def ranks(world):
            try:
                box[world] = run_ranks(_rank, world, copies[world], root, timeout=600)[0]
            except BaseException as e:   # re-raised below
                box["error"] = e

        started = [threading.Thread(target=ranks, args=(w,)) for w in (1, 2, 4)]
        for th in started:
            th.start()
        try:
            none = {arch: _port(arch, refs[arch], None) for arch in ARCHS}
        finally:
            for th in started:
                th.join()
        if "error" in box:
            raise box["error"]
        restart = _train(TRAIN + ["--steps", "2", "--ckpt-dir", os.path.join(root, "w1")])
    finally:
        torch.set_num_threads(threads)
    meshes = {}
    for world in (2, 4):
        meshes.update({k: v for k, v in box[world].items() if isinstance(k, tuple)})
    return {"ref": refs, "none": none, "one": box[1][(1, 1)], "meshes": meshes,
            "families": box[2]["families"], "checkpoint": box[2]["checkpoint"],
            "restart": restart}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp"))
    yield _all_runs(root)
    shutil.rmtree(root, ignore_errors=True)


MESH_IDS = [(1, 2), (1, 4), (2, 2)]


def _heads(arch: str, model: int):
    """(query heads, KV heads) a rank computes at a 'model' size."""
    _, tcfg = _configs(arch)
    kv = tcfg.num_kv_heads
    return tcfg.num_heads // model, (kv // model if kv % model == 0 else kv)


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("mesh", MESH_IDS, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_reference(arch, mesh, runs):
    """Layer 0's attention and MLP blocks at f32 within F32_TOL and at bf16
    within BF16_TOL of the reference's; bf16's witness (no mesh) inside,
    its controls (at (1, 2)) outside."""
    ref, got, none = runs["ref"][arch], runs["meshes"][mesh][arch], runs["none"][arch]
    for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        for i, block in enumerate(("attn", "mlp")):
            assert _rel(got[dtype][i], ref[dtype][block]) <= tol, (dtype, block)
            assert _rel(none[dtype][i], ref[dtype][block]) <= tol, (dtype, block)
    if mesh == (1, 2):
        for i, block in enumerate(("attn", "mlp")):
            assert _rel(got["control"][i], ref["bfloat16"][block]) > BF16_TOL, block


@pytest.mark.parametrize("mesh", MESH_IDS, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_layers_hold_this_ranks_slices(arch, mesh, runs):
    """The weights a rank holds live while a layer runs: Q / K / V and
    gate / up on 1 / D of their columns (K / V whole where 'kv' does not
    divide), O on 1 / D of its rows, the down projection whole over d_ff,
    the embedding 1 / D of the vocabulary; without a mesh, all of them."""
    _, tcfg = _configs(arch)
    d, hd, f, v = tcfg.d_model, tcfg.head_dim, tcfg.d_ff, tcfg.padded_vocab
    h, kh = _heads(arch, mesh[1])
    want = {"wq": (d, h * hd), "wk": (d, kh * hd), "wv": (d, kh * hd), "wo": (h * hd, d),
            "w_gate": (d, f // mesh[1]), "w_up": (d, f // mesh[1]), "w_down": (f, d),
            "emb": (v // mesh[1], d)}
    assert runs["meshes"][mesh][arch]["bfloat16"][2] == want
    whole = dict(want, wq=(d, tcfg.num_heads * hd), wk=(d, tcfg.num_kv_heads * hd),
                 wv=(d, tcfg.num_kv_heads * hd), wo=(tcfg.num_heads * hd, d),
                 w_gate=(d, f), w_up=(d, f), emb=(v, d))
    assert runs["none"][arch]["bfloat16"][2] == whole


def _parting(got_steps, ref_steps):
    """(step, row) where the greedy tokens differ although the reference's
    top-1 / top-2 margin exceeds twice the row's largest logit gap."""
    bad = []
    for i, (g, w) in enumerate(zip(got_steps, ref_steps)):
        top2 = np.sort(w, -1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        gap = np.abs(g - w).max(-1)
        for r in np.nonzero((g.argmax(-1) != w.argmax(-1)) & (margin > 2 * gap))[0]:
            bad.append((i, int(r)))
    return bad


@pytest.mark.parametrize("mesh", MESH_IDS, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_tokens_under_the_margin_rule(arch, mesh, runs):
    """Prefill and 8 teacher-forced decode steps: the greedy tokens are the
    reference's under the margin rule, on the mesh and without one."""
    want = runs["ref"][arch]["serve"]["logits"]
    got = runs["meshes"][mesh][arch]["serve"]["logits"]
    assert len(got) == len(want) == GEN + 1
    assert all(np.isfinite(g).all() for g in got)
    assert not _parting(got, want)
    assert not _parting(runs["none"][arch]["serve"]["logits"], want)


@pytest.mark.parametrize("mesh", MESH_IDS, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_caches_and_sites_hold_this_ranks_heads(arch, mesh, runs):
    """Each rank's KV cache holds KH / D heads (KH where 'kv' does not
    divide), ``cache_bytes`` on the mesh is that share of its slots, the
    Q / K sites run H / D and KH / D heads, and every layer of the prefill
    ticks ``("tensor_parallel", "attn", "split")`` once."""
    got, none = runs["meshes"][mesh][arch]["serve"], runs["none"][arch]["serve"]
    h, kh = _heads(arch, mesh[1])
    rows = B // mesh[0]
    _, tcfg = _configs(arch)
    assert got["shapes"] == [(rows, S, kh, tcfg.head_dim)] * tcfg.num_layers
    assert none["shapes"] == [(B, S, tcfg.num_kv_heads, tcfg.head_dim)] * tcfg.num_layers
    assert got["bytes"] * tcfg.num_kv_heads * mesh[0] == none["bytes"] * kh
    assert got["sites"] == (h, kh) and none["sites"] == (tcfg.num_heads, tcfg.num_kv_heads)
    assert got["ticks"] == {("tensor_parallel", "attn", "split"): tcfg.num_layers}
    assert none["ticks"] == {}


def test_layer_kinds_tick_split_or_replicated(runs):
    """At (1, 2): every layer ``split`` -- MoE, RWKV6, Mamba2 and every
    attention layer (the encoder's and the decoder's with cross attention
    too) -- once per layer of a prefill, none ``replicated``; a Mamba2
    layer whose SSD heads the axis does not divide raises."""
    families = dict(runs["families"])
    assert "cannot split over 'model'" in families.pop("unsplit")
    for arch, (ticks, kinds, enc) in families.items():
        want = {}
        for kind in kinds + enc:
            want[(kind, "split")] = want.get((kind, "split"), 0) + 1
        assert ticks == want, arch
        assert not any(k[1] == "replicated" for k in ticks), arch


@pytest.mark.parametrize("mesh", MESH_IDS, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_step0_gradients_match_reference(arch, mesh, runs):
    """Every leaf's step-0 gradient, gathered whole, within GRAD_TOL of
    ``jax.grad`` of the reference's loss, as without a mesh; at (1, 2) the
    control's (``copy_to_model`` summing nothing) outside it on some
    leaf."""
    want = runs["ref"][arch]["grads"]
    got = runs["meshes"][mesh][arch]["grads"]
    assert len(got) == len(want)
    assert max(_rel(g, w) for g, w in zip(got, want)) <= GRAD_TOL
    assert max(_rel(g, w) for g, w in zip(runs["none"][arch]["grads"], want)) <= GRAD_TOL
    if mesh == (1, 2):
        ctl = runs["meshes"][mesh][arch]["grads_control"]
        assert max(_rel(g, w) for g, w in zip(ctl, want)) > GRAD_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_is_the_no_mesh_path_bitwise(arch, runs):
    """A (1, 1) mesh: blocks, every step's logits and every gradient are
    the no-mesh path's bit for bit."""
    one, none = runs["one"][arch], runs["none"][arch]
    for dtype in ("float32", "bfloat16"):
        for a, b in zip(one[dtype][:2], none[dtype][:2]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(one["serve"]["logits"] + one["grads"],
                    none["serve"]["logits"] + none["grads"]):
        np.testing.assert_array_equal(a, b)
    assert one["serve"]["ticks"] == {}


def _lines(text: str, key: str):
    return [float(ln.split(key)[1].split()[0]) for ln in text.splitlines()
            if ln.startswith("step")]


def test_checkpoint_from_1x2_restores_at_2x1(runs):
    """The (1, 2) checkpoint of step 1 restores onto (2, 1) bitwise
    (sharded and gathered back), and the (2, 1) restart's step-1 loss is a
    world-1 restart's within LOSS_TOL."""
    (whole, back), text = runs["checkpoint"]
    assert len(whole) == len(back) == 2
    for wt, bt in zip(whole, back):
        assert len(wt) == len(bt)
        for a, b in zip(wt, bt):
            np.testing.assert_array_equal(a, b)
    assert "mesh {'data': 2, 'model': 1}" in text
    got, want = _lines(text, "loss"), _lines(runs["restart"], "loss")
    assert len(got) == len(want) == 1
    assert abs(got[0] - want[0]) <= LOSS_TOL


def _readings(runs):
    """The quantities behind the limits above."""
    for arch in ARCHS:
        ref = runs["ref"][arch]
        for name, got in [("none", runs["none"][arch])] + [
                (str(m), runs["meshes"][m][arch]) for m in MESH_IDS]:
            blocks = {f"{d}/{b}": _rel(got[d][i], ref[d][b]) for d in ("float32", "bfloat16")
                      for i, b in enumerate(("attn", "mlp"))}
            grads = max(_rel(g, w) for g, w in zip(got["grads"], ref["grads"]))
            print(arch, name, blocks, "grads", grads, "parting",
                  _parting(got["serve"]["logits"], ref["serve"]["logits"]))
            if "control" in got:
                print("  control", [_rel(got["control"][i], ref["bfloat16"][b])
                                    for i, b in enumerate(("attn", "mlp"))],
                      "grads", max(_rel(g, w) for g, w in zip(got["grads_control"],
                                                              ref["grads"])))


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        _readings(_all_runs(d))
