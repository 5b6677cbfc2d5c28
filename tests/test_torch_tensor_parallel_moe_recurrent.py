"""PyTorch port, tensor parallelism over 'model' for the layer kinds beyond
attention and the dense MLP: the MoE layer (its attention split by head,
its experts over 'model', each rank's expert site one K6 launch over E / D
experts on the card), RWKV6 (the time mix by head, its state included; the
channel mix's ``wk`` by 'dff') and Mamba2 (the SSD by head, its states
included), on CPU ranks of a gloo process group
(``repro_torch.testing.ranks``), held against the reference's un-meshed
functions on bridged parameters (``jax.jit``, ``xla_allow_excess_precision``
off, backend 'xla') and against the port without a mesh, as
``tests/test_torch_tensor_parallel.py`` holds attention.

Four scaled-down families, head_dim 64, vocabulary 512, the port's seeded
weights (the reference's through ``bridge.to_reference``), raw bf16 when
serving (the sites quantize the weights on the fly):

  * mixtral-like: 2 'moe' layers, d_model 256, 4 query and 2 KV heads, 4
    experts top-2, d_ff 896 = 7 x 128 (the grouped expert site: grouped K1
    and the einsum form), int8 + Hadamard;
  * maverick-like: one (attn, moe) group, d_model 256, 4 / 2 heads, 8
    experts top-1 plus the shared expert, d_ff 512 (K6's plain version),
    int8 + Hadamard;
  * rwkv6: 2 layers, d_model 256, 4 heads of 64, d_ff 896, int8 + Hadamard;
  * zamba2: one superblock (5 mamba layers and the attention layer),
    d_model 256, 4 / 4 heads, d_inner 512 in 8 SSD heads of 64, state 16,
    d_ff 896, fp8_e4m3 + Hadamard;

plus the mixtral-like with 2 experts ("mixtral2"), whose experts do not
divide a 'model' axis of 4: the parameters give 'model' to the experts'
hidden width and the layer splits gate / up by column.

Meshes (1, 2) (world 2) and (2, 2) (world 4, rows over 'data' too) for the
four; (1, 4) (world 4) for the maverick-like, rwkv6 and mixtral2. Held per
family and mesh:

  * one block (raw weights) against the reference's ``apply_moe`` /
    ``apply_rwkv_tmix`` and ``apply_rwkv_cmix`` / ``apply_mamba``: in f32
    within ``F32_TOL`` and in bf16 within ``BF16_TOL``, the limits of
    ``tests/test_torch_tensor_parallel.py`` [f32 reads at most 8.5e-7, bf16
    at most 5.9e-4; the witness, the port without a mesh, as much]; at
    (1, 2) the control -- ``reduce_from_model`` dropped,
    ``gather_from_model`` leaving the other ranks' columns zero -- outside
    [at least 0.69];
  * prefill and 8 decode steps, teacher-forced with the same seeded tokens
    in both packages: the greedy token the reference's wherever its top-1 /
    top-2 margin exceeds twice the step's largest logit gap;
  * the weights a rank holds live in the block: its experts' 1 / D of all
    three expert leaves (mixtral2 at D = 4: 1 / D of gate / up's columns),
    its heads' columns of ``wr`` / ``wk`` / ``wv`` / ``wg`` and rows of
    ``u`` and ``wo``, its heads' columns of ``conv_x``, ``norm`` and
    ``w_zx`` (both halves) and rows of ``w_out``; the down sites whole;
  * its state and cache at 1 / D: RWKV6's ``S`` (B, H / D, K, K), Mamba2's
    ``ssm`` (B, H / D, P, N) and ``conv_x`` (B, 3, d_inner / D), the MoE
    layers' KV caches at KH / D heads (KH where 'kv' does not divide);
  * the router's probabilities bitwise equal on every rank of 'model';
  * one ``("tensor_parallel", kind, "split")`` tick per layer and pass,
    none ``replicated``;
  * step-0 gradients of every leaf (raw bf16 weights) against ``jax.grad``
    of the reference's ``lm_loss`` within ``GRAD_TOL``, as without a mesh
    [the meshes read at most 0.0192, the witness 0.0142]; but for zamba2's
    leaves named in ``LEAF_LIMITS``, each held within its limit and within
    ``WITNESS_GAP`` of the witness's reading: four of its attention layer
    at 0.1 [``wv`` 0.0703, ``norm1`` 0.0416, ``wk`` 0.0341, ``wq`` 0.0323
    on the meshes; the witness 0.0702, 0.0400, 0.0341, 0.0322], the
    divergence of rounding behind its fp8 V site that
    ``tests/test_torch_v_site_gradient.py`` settles for int8 (the V site's
    gradient reaches each row through its scale), and its per-head SSD
    leaves ``A_log`` / ``D`` / ``dt_bias`` at 0.06,
    ``tests/test_torch_train_recurrent.py``'s zamba2 limit [at most 0.0332,
    layer 2's ``A_log``; the witness 0.0271; in f32 with quantization off
    the meshes read 7.1e-6 of world 1's]; at (1, 2) three
    controls fall outside on some leaf: ``copy_to_model`` summing nothing
    (every family) [reads at least 0.96], Mamba2's sum of squares with an
    identity backward (zamba2) [0.59], the router counted twice, its
    probabilities summed over 'model' on top of the combine weights
    (the MoE families) [at least 0.99].

A (1, 1) mesh (world 1) gives the no-mesh path's blocks, logits and
gradients bit for bit.

The reference runs in this process while the ranks run, from the same
bridged parameters and inputs. Readings: this file's own quantities,
printed by ``python tests/test_torch_tensor_parallel_moe_recurrent.py``.
"""
import contextlib
import copy
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.quant import QuantConfig as JQuantConfig
from repro.data import SyntheticDataset as JSyntheticDataset
from repro.launch.shapes import ShapeSpec as JShapeSpec
from repro.models import init_lm as jinit_lm
from repro.models import lm_decode_step as jlm_decode_step
from repro.models import lm_loss as jlm_loss
from repro.models import lm_prefill as jlm_prefill
from repro.models import mlp as jmlp
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models.lm import pad_kv_caches as jpad_kv_caches

from repro_torch import tree as T
from repro_torch.bridge import params_from_reference
from repro_torch.testing.ranks import run_ranks

_HEADS = dict(num_heads=4, head_dim=64, d_model=256)
_MIXTRAL = dict(_HEADS, num_kv_heads=2, d_ff=896, num_experts=4, experts_per_token=2,
                groups=((("moe",), 2),))
# family -> (reference config, port config, quant mode, overrides, the block's layer)
FAMILIES = {
    "mixtral": ("mixtral_8x7b", "mixtral-8x7b", "int8", _MIXTRAL, 0),
    "maverick": ("llama4_maverick_400b_a17b", "llama4-maverick-400b-a17b", "int8",
                 dict(_HEADS, num_kv_heads=2, d_ff=512, num_experts=8, experts_per_token=1,
                      groups=((("attn", "moe"), 1),)), 1),
    "rwkv6": ("rwkv6_7b", "rwkv6-7b", "int8",
              dict(_HEADS, num_kv_heads=4, d_ff=896, rwkv_head_dim=64,
                   groups=((("rwkv",), 2),)), 0),
    "zamba2": ("zamba2_7b", "zamba2-7b", "fp8_e4m3",
               dict(_HEADS, num_kv_heads=4, d_ff=896, ssm_head_dim=64, ssm_state=16,
                    groups=((("mamba",) * 5 + ("attn",), 1),)), 0),
    "mixtral2": ("mixtral_8x7b", "mixtral-8x7b", "int8", dict(_MIXTRAL, num_experts=2), 0),
}
# world -> ((mesh shape, families), ...)
MESHES = {1: (((1, 1), ("mixtral", "maverick", "rwkv6", "zamba2", "mixtral2")),),
          2: (((1, 2), ("mixtral", "maverick", "rwkv6", "zamba2")),),
          4: (((2, 2), ("mixtral", "maverick", "rwkv6", "zamba2")),
              ((1, 4), ("maverick", "rwkv6", "mixtral2")))}
CASES = [(fam, shape) for w in (2, 4) for shape, fams in MESHES[w] for fam in fams]
CONTROLS = {"mixtral": ("copy", "router"), "maverick": ("copy", "router"),
            "rwkv6": ("copy",), "zamba2": ("copy", "norm")}
B, S, GEN = 2, 16, 8
F32_TOL, BF16_TOL, GRAD_TOL = 1e-5, 1e-2, 0.03
# leaves with their own gradient limit, by family and a substring of the
# leaf's path (module docstring): zamba2's attention layer behind its fp8 V
# site, and its per-head SSD leaves at tests/test_torch_train_recurrent.py's
# zamba2 limit, without a mesh as on every mesh
LEAF_LIMITS = {"zamba2": {**{f"['layers'][5]{leaf}": 0.1
                             for leaf in ("['norm1']['scale']", "['attn']['wq']",
                                          "['attn']['wk']", "['attn']['wv']")},
                          **{f"['mamba']['{leaf}']": 0.06 for leaf in ("A_log", "D", "dt_bias")}}}
# how far a named leaf's mesh reading may stand from the witness's
WITNESS_GAP = 0.01
AS_WRITTEN = {"xla_allow_excess_precision": False}


# ------------------------------------------------------------- configs
def _configs(fam: str, dtype: str = "bfloat16"):
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig

    jname, tname, mode, over, _ = FAMILIES[fam]
    kw = dict(over, dtype=dtype)
    jcfg = jget_config(jname).scaled_down(**kw).with_quant(
        JQuantConfig(mode=mode, rotate="hadamard", backend="xla", kv_quant=True))
    tcfg = get_config(tname).scaled_down(**kw).with_quant(
        QuantConfig(mode=mode, rotate="hadamard", backend="cuda", kv_quant=True))
    return jcfg, tcfg


def _kind(fam: str) -> str:
    _, tcfg = _configs(fam)
    return tcfg.layer_kinds[FAMILIES[fam][4]]


def _np_tree(t):
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
    """The block's input x (B, S, d), the prompt (B, S) and the tokens the
    decode steps are forced with (GEN, B, 1)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (GEN, B, 1)).astype(np.int32)
    return x, prompt, forced


def _train_batch(jcfg):
    return JSyntheticDataset(jcfg, JShapeSpec("tp", "train", S, B), seed=0).batch(0)


# ------------------------------------------------------- the reference
def _jax_tree(t):
    """The reference's layout (``bridge.to_reference``'s numpy, bf16 as its
    uint16 view) as jax arrays."""
    if isinstance(t, dict):
        return {k: _jax_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_jax_tree(v) for v in t]
    t = np.asarray(t)
    return jnp.asarray(t.view(jnp.bfloat16) if t.dtype == np.uint16 else t)


def _params(fam: str):
    """The port's seeded parameters in f32 and bf16, the reference's twins
    of them (``bridge.to_reference``) and the training batch."""
    from repro_torch.bridge import to_reference
    from repro_torch.models.lm import init_lm

    port, jp = {}, {}
    for dtype in ("float32", "bfloat16"):
        _, tcfg = _configs(fam, dtype)
        port[dtype] = init_lm(tcfg, seed=0, device="cpu")
        jp[dtype] = _jax_tree(to_reference(port[dtype], tcfg))
    port["batch"] = _train_batch(_configs(fam)[0])
    return jp, port


def _block_reference(fam: str, jcfg, jp):
    gi, j = 0, FAMILIES[fam][4]
    layer = jax.tree.map(lambda a: a[0], jp["groups"][gi][f"p{j}"])
    x, _, _ = _inputs(jcfg)
    jx = jnp.asarray(x, jcfg.dtype)
    kind = jcfg.groups[gi][0][j]

    def run(p, a):
        if kind == "moe":
            return (jmlp.apply_moe(jcfg, p["moe"], a)[0],)
        if kind == "rwkv":
            return (jrwkv.apply_rwkv_tmix(jcfg, p["tmix"], a),
                    jrwkv.apply_rwkv_cmix(jcfg, p["cmix"], a))
        return (jssm.apply_mamba(jcfg, p["mamba"], a),)

    return [_f64(y) for y in jax.jit(run, compiler_options=AS_WRITTEN)(layer, jx)]


def _reference(fam: str, jp, port):
    """The reference's blocks (f32, bf16), its teacher-forced prefill +
    decode logits and its step-0 gradients (in the port's leaf order)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, _ = _configs(fam, dtype)
        out[dtype] = _block_reference(fam, jcfg, jp[dtype])
    jcfg, _ = _configs(fam)
    grad = jax.jit(jax.grad(lambda p, b: jlm_loss(jcfg, p, b)[0]),
                   compiler_options=AS_WRITTEN)(jp["bfloat16"], port["batch"])
    out["grads"] = [_f64(t) for t in T.leaves(params_from_reference(_np_tree(grad), "cpu"))]
    _, prompt, forced = _inputs(jcfg)
    pre = jax.jit(lambda p, b: jlm_prefill(jcfg, p, b), compiler_options=AS_WRITTEN)
    dec = jax.jit(lambda p, c, t, i: jlm_decode_step(jcfg, p, c, t, i),
                  compiler_options=AS_WRITTEN)
    logits, caches = pre(jp["bfloat16"], {"tokens": jnp.asarray(prompt)})
    caches = jpad_kv_caches(jcfg, caches, S + GEN)
    steps = []
    for i in range(GEN + 1):
        steps.append(np.asarray(logits[:, -1, :jcfg.vocab_size].astype(jnp.float32),
                                np.float64))
        if i < GEN:
            logits, caches = dec(jp["bfloat16"], caches, jnp.asarray(forced[i]),
                                 jnp.asarray(S + i, jnp.int32))
    out["logits"] = steps
    return out


# ---------------------------------------------------------- the port
class _UnsummedCopy(torch.autograd.Function):
    """The control's ``copy_to_model``: identity both ways."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _zero_padded_gather(t, axes, dim):
    """The block control's ``gather_from_model``: this rank's columns in
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


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _shards(cfg, params, mesh):
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


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def _block(fam, cfg, params, mesh, control: bool = False):
    """The family's block on ``_inputs``' x: (outputs whole, f64; the
    shapes of its live weights). ``control``: ``reduce_from_model`` dropped,
    ``gather_from_model`` zero-padded."""
    from repro_torch.distributed import collectives as C
    from repro_torch.models import mlp as M
    from repro_torch.models import rwkv as R
    from repro_torch.models import ssm as SSM
    from repro_torch.models.common import dtype_of
    from repro_torch.models.lm import _layer_params

    dt, i = dtype_of(cfg), FAMILIES[fam][4]
    kind = cfg.layer_kinds[i]
    shards, parts = _shards(cfg, params, mesh)
    rows = _rows(mesh)
    x = torch.from_numpy(_inputs(cfg)[0]).to(dt)
    x = x if mesh is None else mesh.chunk(x, rows, 0)
    stack = contextlib.ExitStack()
    if control:
        stack.enter_context(_patched(C, "reduce_from_model", lambda t, axes: t))
        stack.enter_context(_patched(C, "gather_from_model", _zero_padded_gather))
    with stack, _on(mesh, rows), torch.no_grad():
        lp = _layer_params(cfg, shards["layers"][i], dt,
                           None if parts is None else parts["layers"][i], kind)
        if kind == "moe":
            ys = [M.apply_moe(cfg, lp["moe"], x)[0]]
            live = _shapes(lp["moe"])
        elif kind == "rwkv":
            ys = [R.apply_rwkv_tmix(cfg, lp["tmix"], x), R.apply_rwkv_cmix(cfg, lp["cmix"], x)]
            live = _shapes({"tmix": lp["tmix"], "cmix": lp["cmix"]})
        else:
            ys = [SSM.apply_mamba(cfg, lp["mamba"], x)]
            live = _shapes(lp["mamba"])
            live["w_zx (used)"] = tuple(SSM._zx_columns(cfg, lp["mamba"]["w_zx"]).shape)
    return [_f64(_gathered(y, mesh, rows)) for y in ys], live


def _serve(cfg, params, prompt, forced, mesh):
    """Prefill + GEN decode steps forced with ``forced``: (each step's last
    logits, f64; each layer's state / cache shapes; the tensor_parallel
    ticks; whether the router's probabilities were bitwise equal on every
    rank of 'model')."""
    from repro_torch.kernels.registry import TRACE_COUNTS
    from repro_torch.models import mlp as M
    from repro_torch.models.lm import lm_decode_step, lm_prefill, pad_kv_caches

    shards, _ = _shards(cfg, params, mesh)
    rows = _rows(mesh)

    def mine(t):
        t = torch.from_numpy(t).long()
        return t if mesh is None else mesh.chunk(t, rows, 0)

    gates, real = [], M._route

    def spy(p, x):
        g = real(p, x)
        gates.append(g)
        return g

    for key in [k for k in TRACE_COUNTS if k[0] == "tensor_parallel"]:
        del TRACE_COUNTS[key]
    steps = []
    with _patched(M, "_route", spy), _on(mesh, rows), torch.no_grad():
        logits, caches = lm_prefill(cfg, shards, {"tokens": mine(prompt)})
        states = [{k: tuple(t.shape) for k, t in c.items()} for c in caches]
        caches = pad_kv_caches(cfg, caches, S + GEN)
        for i in range(GEN + 1):
            steps.append(_f64(_gathered(logits[:, -1, :cfg.vocab_size], mesh, rows)))
            if i < GEN:
                logits, caches = lm_decode_step(cfg, shards, caches, mine(forced[i]),
                                                torch.tensor(S + i))
    ticks = {k[1:]: v for k, v in TRACE_COUNTS.items() if k[0] == "tensor_parallel"}
    agree = True
    if mesh is not None:
        model = tuple(a for a in mesh.axis_names if a not in rows)
        for g in gates:
            every = mesh.gather(g[None].contiguous(), model, 0)
            agree &= bool((every == every[:1]).all())
    return {"logits": steps, "states": states, "ticks": ticks, "gates": len(gates),
            "agree": agree}


def _grads(cfg, params, batch, mesh, control=None):
    """Step-0 gradients of every leaf (gathered whole, f64), in the port's
    leaf order. ``control``: "copy" (``copy_to_model`` sums nothing),
    "norm" (Mamba2's sum of squares with an identity backward), "router"
    (the router's probabilities also summed over 'model')."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.collectives import gather_tree
    from repro_torch.launch.steps import batch_to, local_batch
    from repro_torch.models import mlp as M
    from repro_torch.models.lm import lm_loss

    params = T.tree_map(lambda t: t.detach().clone(), params)
    shards, parts = _shards(cfg, params, mesh)
    rows = _rows(mesh)
    b = batch_to(batch, "cpu")
    b = b if mesh is None else local_batch(b, mesh, rows)
    flat = T.leaves(shards)
    for p in flat:
        p.requires_grad_(True)
    route = M._route
    patch = {None: contextlib.nullcontext(),
             "copy": _patched(C, "_CopyToModel", _UnsummedCopy),
             "norm": _patched(C, "_SumForSplit", C._ReduceFromModel),
             "router": _patched(M, "_route", lambda p, x: C.copy_to_model(
                 route(p, x), M.expert_split(cfg).axes))}[control]
    with patch, _on(mesh, rows):
        g = torch.autograd.grad(lm_loss(cfg, shards, b)[0], flat)
    g = T.unflatten(shards, list(g))
    if mesh is not None:
        g = gather_tree(g, parts, mesh)
    return [_f64(t) for t in T.leaves(g)]


def _port(fam: str, port, mesh, controls=()):
    """Every port reading of ``fam`` on ``mesh`` (None: no mesh)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        _, tcfg = _configs(fam, dtype)
        out[dtype] = _block(fam, tcfg, port[dtype], mesh)
    _, tcfg = _configs(fam)
    if controls:
        out["control"] = _block(fam, tcfg, port["bfloat16"], mesh, control=True)[0]
    out["grads"] = _grads(tcfg, port["bfloat16"], port["batch"], mesh)
    for c in controls:
        out[f"grads_{c}"] = _grads(tcfg, port["bfloat16"], port["batch"], mesh, c)
    _, prompt, forced = _inputs(tcfg)
    out["serve"] = _serve(tcfg, port["bfloat16"], prompt, forced, mesh)
    return out


def _rank(rank, world, ports):
    """The mesh runs of ``world`` (``MESHES``): rank 0's readings; world 1
    also runs the port without a mesh."""
    from repro_torch.launch.mesh import make_local_mesh

    out = {}
    for shape, fams in MESHES[world]:
        mesh = make_local_mesh(shape[1])
        out[shape] = {f: _port(f, ports[f], mesh, CONTROLS[f] if shape == (1, 2) else ())
                      for f in fams}
    if world == 1:
        out[None] = {f: _port(f, ports[f], None) for f in MESHES[1][0][1]}
    return out if rank == 0 else None


def _all_runs() -> dict:
    """The reference's parameters first, then worlds 1, 2 and 4 started
    from threads beside the reference's runs in this process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        made = {f: _params(f) for f in FAMILIES}
        ports = {f: port for f, (_, port) in made.items()}
        # each world its own copy: sending a tensor to a spawned process moves
        # its storage into shared memory in place
        copies = {w: copy.deepcopy(ports) for w in MESHES}
        box = {}

        def ranks(world):
            try:
                box[world] = run_ranks(_rank, world, copies[world], timeout=600)[0]
            except BaseException as e:   # re-raised below
                box["error"] = e

        started = [threading.Thread(target=ranks, args=(w,)) for w in (4, 2, 1)]
        for th in started:
            th.start()
        try:
            # the reference's compiles release the GIL: one thread a family
            with ThreadPoolExecutor(len(FAMILIES)) as pool:
                refs = dict(zip(FAMILIES, pool.map(lambda f: _reference(f, *made[f]),
                                                   FAMILIES)))
        finally:
            for th in started:
                th.join()
        if "error" in box:
            raise box["error"]
    finally:
        torch.set_num_threads(threads)
    meshes = {}
    for world in (2, 4):
        meshes.update(box[world])
    return {"ref": refs, "none": box[1][None], "one": box[1][(1, 1)], "meshes": meshes}


@pytest.fixture(scope="module")
def runs():
    return _all_runs()


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


def _max_rel(got, want) -> float:
    assert len(got) == len(want)
    return max(_rel(g, w) for g, w in zip(got, want))


def _ids(case):
    return f"{case[0]}-{case[1]}"


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_blocks_match_reference(case, runs):
    """The family's block at f32 within F32_TOL and at bf16 within BF16_TOL
    of the reference's, the witness (no mesh) as well; at (1, 2) the
    control (the reduce dropped, the gather zero-padded) outside."""
    fam, mesh = case
    ref, got, none = runs["ref"][fam], runs["meshes"][mesh][fam], runs["none"][fam]
    for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        assert _max_rel(got[dtype][0], ref[dtype]) <= tol, dtype
        assert _max_rel(none[dtype][0], ref[dtype]) <= tol, dtype
    if mesh == (1, 2):
        assert _max_rel(got["control"], ref["bfloat16"]) > BF16_TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_prefill_and_decode_tokens_under_the_margin_rule(case, runs):
    """Prefill and 8 forced decode steps: the greedy tokens are the
    reference's under the margin rule, on the mesh and without one."""
    fam, mesh = case
    want = runs["ref"][fam]["logits"]
    got = runs["meshes"][mesh][fam]["serve"]["logits"]
    assert len(got) == len(want) == GEN + 1
    assert all(np.isfinite(g).all() for g in got)
    assert not _parting(got, want)
    assert not _parting(runs["none"][fam]["serve"]["logits"], want)


def _live_want(fam: str, D: int, whole: bool = False) -> dict:
    """The shapes of the block's weights a rank holds live at a 'model'
    size D (``whole``: without a mesh)."""
    _, cfg = _configs(fam)
    d, f, D = cfg.d_model, cfg.d_ff, 1 if whole else D
    kind = _kind(fam)
    if kind == "moe":
        E = cfg.num_experts
        e, fe = (E // D, f) if E % D == 0 else (E, f // D)
        want = {"router": (d, E), "experts/w_gate": (e, d, fe), "experts/w_up": (e, d, fe),
                "experts/w_down": (e, f, d)}
        if cfg.moe_shared_expert:
            want.update({"shared/w_gate": (d, f // D), "shared/w_up": (d, f // D),
                         "shared/w_down": (f, d)})
        return want
    if kind == "rwkv":
        K = cfg.rwkv_head_dim
        want = {f"tmix/{k}": (d, d // D) for k in ("wr", "wk", "wv", "wg")}
        want.update({"tmix/wo": (d // D, d), "tmix/u": (d // K // D, K),
                     "tmix/mu_base": (d,), "tmix/mix_w1": (d, 160), "tmix/mix_w2": (5, 32, d),
                     "tmix/mu": (5, d), "tmix/w0": (d,), "tmix/w_lora_a": (d, 64),
                     "tmix/w_lora_b": (64, d), "tmix/ln_scale": (d,), "tmix/ln_bias": (d,),
                     "cmix/mu_r": (d,), "cmix/mu_k": (d,), "cmix/wr": (d, d),
                     "cmix/wk": (d, f // D), "cmix/wv": (f, d)})
        return want
    di, H, N = 2 * d, 2 * d // cfg.ssm_head_dim, cfg.ssm_state
    return {"w_zx": (d, 2 * di), "w_zx (used)": (d, 2 * di // D), "w_bcdt": (d, 2 * N + H),
            "conv_x": (4, di // D), "conv_bc": (4, 2 * N), "A_log": (H,), "D": (H,),
            "dt_bias": (H,), "norm": (di // D,), "w_out": (di // D, d)}


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_layers_hold_this_ranks_slices(case, runs):
    """The block's live weights: its experts' 1 / D of every expert leaf
    (mixtral2 at D = 4: 1 / D of gate / up's columns), its heads' columns
    and rows, the down sites whole; without a mesh, all of them."""
    fam, mesh = case
    assert runs["meshes"][mesh][fam]["bfloat16"][1] == _live_want(fam, mesh[1])
    assert runs["none"][fam]["bfloat16"][1] == _live_want(fam, 1, whole=True)


def _state_want(fam: str, D: int, rows: int) -> list:
    """Each layer's state / cache shapes after the prefill at a 'model'
    size D and ``rows`` batch rows a rank."""
    _, cfg = _configs(fam)
    out = []
    for kind in cfg.layer_kinds:
        if kind == "rwkv":
            H, K = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
            out.append({"S": (rows, H // D, K, K), "xp_t": (rows, cfg.d_model),
                        "xp_c": (rows, cfg.d_model)})
        elif kind == "mamba":
            di = 2 * cfg.d_model
            H = di // cfg.ssm_head_dim
            out.append({"ssm": (rows, H // D, cfg.ssm_head_dim, cfg.ssm_state),
                        "conv_x": (rows, 3, di // D), "conv_bc": (rows, 3, 2 * cfg.ssm_state)})
        else:
            kh = cfg.num_kv_heads
            kh = kh // D if kh % D == 0 else kh
            out.append({"k": (rows, S, kh, cfg.head_dim), "v": (rows, S, kh, cfg.head_dim)})
    return out


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_states_and_caches_hold_this_ranks_heads(case, runs):
    """RWKV6's S, Mamba2's ssm and conv_x at H / D heads and the MoE
    layers' KV caches at KH / D heads (KH where 'kv' does not divide)."""
    fam, mesh = case
    got = runs["meshes"][mesh][fam]["serve"]["states"]
    assert got == _state_want(fam, mesh[1], B // mesh[0])
    assert runs["none"][fam]["serve"]["states"] == _state_want(fam, 1, B)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_gates_agree_and_every_layer_ticks_split(case, runs):
    """The router's probabilities are bitwise equal on every rank of
    'model' (the MoE families: every layer of every pass); every layer of
    every pass ticks ``split`` once, none ``replicated``."""
    fam, mesh = case
    sv = runs["meshes"][mesh][fam]["serve"]
    _, cfg = _configs(fam)
    moe = cfg.layer_kinds.count("moe")
    assert sv["agree"] and sv["gates"] == moe * (GEN + 1)
    want = {}
    for kind in cfg.layer_kinds:
        want[(kind, "split")] = want.get((kind, "split"), 0) + GEN + 1
    assert sv["ticks"] == want
    assert runs["none"][fam]["serve"]["ticks"] == {}


def _paths(fam: str):
    from repro_torch.models.lm import init_lm

    return [k for k, _ in T.leaves_with_paths(init_lm(_configs(fam)[1], device="meta"))]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_step0_gradients_match_reference(case, runs):
    """Every leaf's step-0 gradient, gathered whole, within GRAD_TOL of
    ``jax.grad`` of the reference's loss (a leaf of ``LEAF_LIMITS`` within
    its own limit, and within WITNESS_GAP of the witness's reading), as
    without a mesh; at (1, 2) each of the family's controls outside
    GRAD_TOL on some leaf."""
    fam, mesh = case
    want = runs["ref"][fam]["grads"]
    got = runs["meshes"][mesh][fam]
    none = runs["none"][fam]["grads"]
    assert len(got["grads"]) == len(none) == len(want)
    for path, g, n, w in zip(_paths(fam), got["grads"], none, want):
        tol = next((v for k, v in LEAF_LIMITS.get(fam, {}).items() if k in path), GRAD_TOL)
        assert _rel(g, w) <= tol and _rel(n, w) <= tol, path
        if tol != GRAD_TOL:
            assert abs(_rel(g, w) - _rel(n, w)) <= WITNESS_GAP, path
    if mesh == (1, 2):
        for c in CONTROLS[fam]:
            assert _max_rel(got[f"grads_{c}"], want) > GRAD_TOL, c


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_one_by_one_mesh_is_the_no_mesh_path_bitwise(fam, runs):
    """A (1, 1) mesh: blocks, every step's logits and every gradient are
    the no-mesh path's bit for bit, and nothing ticks."""
    one, none = runs["one"][fam], runs["none"][fam]
    for dtype in ("float32", "bfloat16"):
        for a, b in zip(one[dtype][0], none[dtype][0]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(one["serve"]["logits"] + one["grads"],
                    none["serve"]["logits"] + none["grads"]):
        np.testing.assert_array_equal(a, b)
    assert one["serve"]["ticks"] == {}


def test_cut_depth_keeps_whole_groups():
    """``launch.serve_loop.cut_depth`` (``--layers``) keeps a config's
    groups in order, the last in whole units of its pattern: zamba2-7b's
    first 6 layers are its first superblock, as ``chip_smoke.py`` serves
    it on a mesh; a count inside a unit raises."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_loop import cut_depth

    cfg = get_config("zamba2-7b")
    assert cut_depth(cfg, 6).layer_kinds == ("mamba",) * 5 + ("attn",)
    assert cut_depth(cfg, 81).layer_kinds == cfg.layer_kinds
    assert cut_depth(get_config("mixtral-8x7b"), 2).num_layers == 2
    for bad in (4, 7, 82):
        with pytest.raises(ValueError):
            cut_depth(cfg, bad)


def _readings(runs):
    """The quantities behind the limits above."""
    for fam in FAMILIES:
        ref = runs["ref"][fam]
        named = [("none", runs["none"][fam])] + [
            (str(m), runs["meshes"][m][fam]) for f, m in CASES if f == fam]
        for name, got in named:
            blocks = {d: _max_rel(got[d][0], ref[d]) for d in ("float32", "bfloat16")}
            grads = [_rel(g, w) for g, w in zip(got["grads"], ref["grads"])]
            print(fam, name, blocks, "grads", max(grads), int(np.argmax(grads)), "parting",
                  _parting(got["serve"]["logits"], ref["logits"]))
            if "control" in got:
                print("  control", _max_rel(got["control"], ref["bfloat16"]),
                      {c: _max_rel(got[f"grads_{c}"], ref["grads"]) for c in CONTROLS[fam]})


if __name__ == "__main__":
    _readings(_all_runs())
