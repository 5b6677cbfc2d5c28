"""PyTorch port, multi-device on ``torch.distributed``: the int8 ring
all-reduce and the sharded quant_dot, on CPU ranks of a gloo process group
(``repro_torch.testing.ranks.run_ranks``), against the JAX reference.

The reference's sharded runs fail under jax 0.9 (its explicit-sharding
gather), so the sharded quant_dot is held to the reference's SINGLE-device
output -- the contract the reference's own tests assert
(``tests/test_distributed.py``): int8 bitwise, fp8_e4m3 within ``rtol=1e-5,
atol=1e-6`` -- and to the port's single-device output, bitwise in both
modes. The reference's ring runs on 4 fake host devices in a subprocess
(``subproc``) and the port's at 4 gloo ranks on the same inputs: bitwise
(the same f32 operations in the same order), and within the reference's
own 5% of the exact sum.

Cases (``tests/test_distributed.py:130-365`` rebuilt): meshes (2,)
'model', (1, 2), (2, 1) and (2, 2) over ('data', 'model'); weight axes
(None, 'dff') (columns over 'model', rows over 'data') and ('dff', 'fsdp')
(columns over 'data'); the 'cuda' backend (its fused path: the plain
version on CPU tensors) and 'torch' (the unfused path, counted as
``unfused_local``); per-shard scales; the grouped n = 96; 9 rows, which
drop the row split; mesh axes in the plan key; ``_LAST_SHARDED_DISPATCH``;
the three fallback counters, each warned once. And the recomputation of a
checkpointed block on another thread (a CUDA backward's) under the mesh.

Rank bodies are module-level and import no jax (the spawned ranks import
this module); the reference runs in the test process.
"""
import base64
import io
import warnings

import numpy as np
import pytest
import torch

from repro_torch.testing.ranks import run_ranks

MESHES = {2: [((2,), ("model",)), ((1, 2), ("data", "model")), ((2, 1), ("data", "model"))],
          4: [((2, 2), ("data", "model"))]}
WEIGHT_AXES = [(None, "dff"), ("dff", "fsdp")]
MODES = ["int8", "fp8_e4m3"]
BACKENDS = ["cuda", "torch"]


def _inputs(seed=0, m=16, n=256, d=128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)).astype(np.float32),
            (rng.standard_normal((n, d)) * 0.05).astype(np.float32))


# ------------------------------------------------------------ rank bodies
def _qd_rank(rank, world, x, w, weights):
    """Every (mesh, weight axes, mode, backend) case of this world: the
    assembled output and the dispatch record."""
    from repro_torch.core import api
    from repro_torch.core.wquant import QTensor
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh

    xt = torch.from_numpy(x)
    out = {}
    for shape, names in MESHES[world]:
        mesh = Mesh(shape, names, rank=rank)
        for wa in WEIGHT_AXES:
            for mode in MODES:
                q, s = weights[mode]
                qt = QTensor(torch.from_numpy(q).view(_storage(mode)), torch.from_numpy(s), mode)
                for be in BACKENDS:
                    api._LAST_SHARDED_DISPATCH.clear()
                    with shd.sharding_rules(mesh):
                        y = api.quant_dot(xt, qt, mode=mode, backend=be, weight_axes=wa)
                    out[(shape, wa, mode, be)] = (y, dict(api._LAST_SHARDED_DISPATCH))
    return out


def _storage(mode):
    return torch.int8 if mode == "int8" else torch.float8_e4m3fn


def _extras_rank(rank, world, x, w):
    """World 2: per-shard scales, the grouped n = 96, mesh axes in the plan
    key; world 4: 16 rows split over 'data', 9 rows not."""
    from repro_torch.core import api
    from repro_torch.core.api import QuantDotSpec, QuantEpilogue, plan_for, quant_dot
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.wquant import QTensor, quantize_weight
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh

    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    qt = quantize_weight(wt, "int8")
    res = {}
    if world == 2:
        mesh = Mesh((1, 2), ("data", "model"), rank=rank)
        with shd.sharding_rules(mesh):
            spec = QuantDotSpec.for_config(256, QuantConfig(mode="int8", rotate="hadamard",
                                                            backend="cuda"),
                                           weight_axes=(None, "dff"))
            plan = spec.plan(torch.float32, "cpu", d=128)
            res["plan_axes"] = plan.mesh_axes
            res["plan_distinct"] = plan is not plan_for(
                256, backend="cuda", epilogue=QuantEpilogue("int8"), device_type="cpu")
            res["spec_out"] = spec.bind(qt)(xt)
            sw2 = qt.scale.clone()
            sw2[:, 64:] *= 2.0
            res["o1"] = quant_dot(xt, qt, mode="int8", backend="cuda", weight_axes=(None, "dff"))
            res["o2"] = quant_dot(xt, QTensor(qt.q, sw2, "int8"), mode="int8", backend="cuda",
                                  weight_axes=(None, "dff"))
            rng = np.random.default_rng(3)
            xg = torch.tensor(rng.standard_normal((8, 96)), dtype=torch.float32)
            wg = quantize_weight(torch.tensor(rng.standard_normal((96, 64)) * 0.05,
                                              dtype=torch.float32), "int8")
            res["grouped"] = quant_dot(xg, wg, mode="int8", backend="cuda",
                                       weight_axes=(None, "dff"))
            res["grouped_disp"] = dict(api._LAST_SHARDED_DISPATCH)
        res["grouped_ref"] = quant_dot(xg, wg, mode="int8", backend="cuda")
    else:
        mesh = Mesh((2, 2), ("data", "model"), rank=rank)
        rng = np.random.default_rng(1)
        for rows in (16, 9):
            xr = torch.tensor(rng.standard_normal((rows, 256)), dtype=torch.float32)
            with shd.sharding_rules(mesh):
                got = quant_dot(xr, qt, mode="int8", backend="cuda", weight_axes=(None, "dff"))
            res[rows] = (got, quant_dot(xr, qt, mode="int8", backend="cuda"),
                         api._LAST_SHARDED_DISPATCH["row_axes"])
    return res


def _fallbacks_rank(rank, world, x, w):
    """The three fallbacks: counted every time, warned once per process."""
    from repro_torch.core.api import QuantEpilogue, plan_for, quant_dot
    from repro_torch.core.wquant import QTensor, quantize_weight
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import registry
    from repro_torch.launch.mesh import Mesh

    xt = torch.from_numpy(x[:8])
    qt = quantize_weight(torch.from_numpy(w), "int8")
    mesh = Mesh((2,), ("model",), rank=rank)
    res = {}
    key = ("sharded_quant_dot", "unfused_local")
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        before = registry.TRACE_COUNTS[key]
        with shd.sharding_rules(mesh):
            quant_dot(xt, qt, mode="int8", backend="torch", weight_axes=(None, "dff"))
            quant_dot(xt * 2, qt, mode="int8", backend="torch", weight_axes=(None, "dff"))
    res["unfused"] = (registry.TRACE_COUNTS[key] - before,
                      [str(v.message) for v in wl if "unfused_local" in str(v.message)])
    key = ("sharded_quant_dot", "mesh_mismatch")
    plan = plan_for(256, backend="cuda", epilogue=QuantEpilogue("int8"), device_type="cpu",
                    mesh_axes=("model",))
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        before = registry.TRACE_COUNTS[key]
        out = quant_dot(xt, QTensor(qt.q, qt.scale, "int8"), plan)    # no active mesh
    res["mismatch"] = (registry.TRACE_COUNTS[key] - before,
                       [str(v.message) for v in wl if "mesh_mismatch" in str(v.message)],
                       torch.equal(out, quant_dot(xt, qt, mode="int8", backend="cuda")))
    key = ("sharded_quant_dot", "unshardable_site")
    plan_pt = plan_for(256, backend="torch", device_type="cpu", mesh_axes=("model",),
                       epilogue=QuantEpilogue("int8", per_token=False))
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        before = registry.TRACE_COUNTS[key]
        with shd.sharding_rules(mesh):
            outp = quant_dot(xt, qt, plan_pt)
    res["unshardable"] = (registry.TRACE_COUNTS[key] - before,
                          [str(v.message) for v in wl if "unshardable_site" in str(v.message)],
                          bool(torch.isfinite(outp).all()))
    return res


def _ring_rank(rank, world, contribs):
    from repro_torch.distributed.collectives import int8_ring_all_reduce
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh((world,), ("data",), rank=rank)
    return int8_ring_all_reduce(torch.from_numpy(contribs[rank]), mesh, "data")


# ----------------------------------------------------------------- tests
def _reference_weights(w):
    """The reference's quantized weights, as numpy bits (fp8 as uint8)."""
    import jax
    import jax.numpy as jnp

    from repro.core.wquant import quantize_weight as jquantize_weight

    out = {}
    for mode in MODES:
        qt = jax.jit(lambda a, m=mode: jquantize_weight(a, m))(jnp.asarray(w))
        q = np.asarray(qt.q)
        out[mode] = (q.view(np.uint8) if mode != "int8" else q, np.asarray(qt.scale))
    return out


def _reference_out(x, weights, mode):
    import jax.numpy as jnp
    import ml_dtypes

    from repro.core.api import quant_dot as jquant_dot
    from repro.core.wquant import QTensor as JQTensor

    q, s = weights[mode]
    if mode != "int8":
        q = q.view(ml_dtypes.float8_e4m3fn)
    jt = JQTensor(q=jnp.asarray(q), scale=jnp.asarray(s), mode=mode)
    return np.asarray(jquant_dot(jnp.asarray(x), jt, mode=mode, backend="xla"), np.float32)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_quant_dot_matches_single_device(world):
    """Every case of the world: the port's sharded output bitwise its own
    single-device output, and the reference's single-device output
    bitwise in int8, within rtol 1e-5 / atol 1e-6 in fp8_e4m3; the
    dispatch record names the axes and the shard-local path."""
    from repro_torch.core.api import quant_dot
    from repro_torch.core.wquant import QTensor

    x, w = _inputs()
    weights = _reference_weights(w)
    ranks = run_ranks(_qd_rank, world, x, w, weights)
    for case, (y, disp) in ranks[0].items():
        shape, wa, mode, be = case
        for other in ranks[1:]:
            assert torch.equal(other[case][0], y), case       # every rank, the whole output
        q, s = weights[mode]
        qt = QTensor(torch.from_numpy(q).view(_storage(mode)), torch.from_numpy(s), mode)
        single = quant_dot(torch.from_numpy(x), qt, mode=mode, backend=be)
        assert torch.equal(y, single), case
        ref = _reference_out(x, weights, mode)
        if mode == "int8":
            np.testing.assert_array_equal(y.numpy(), ref, err_msg=str(case))
        else:
            np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-6, err_msg=str(case))
        sizes = dict(zip(("data", "model") if len(shape) == 2 else ("model",), shape))
        col_axis = "model" if wa == (None, "dff") else "data"
        if sizes.get(col_axis, 1) == 1:
            assert disp == {}, case                          # a size-1 split: no mesh plan
            continue
        assert disp["mesh_axes"] == (col_axis,) and disp["backend"] == be, case
        assert disp["fused"] == (be == "cuda"), case
        want_rows = ("data",) if col_axis == "model" and "data" in sizes else ()
        assert disp["row_axes"] == want_rows, case


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_quant_dot_scales_groups_and_rows(world):
    """World 2: mesh axes key the plan; perturbing the second shard's scale
    slice changes exactly its columns; the grouped n = 96 (3 x 32) shards,
    unfused shard-locally, bitwise. World 4: 16 rows split over 'data', 9
    rows drop the split; both bitwise."""
    x, w = _inputs(2)
    r = run_ranks(_extras_rank, world, x, w)[0]
    if world == 2:
        assert r["plan_axes"] == ("model",) and r["plan_distinct"]
        assert torch.equal(r["o1"][:, :64], r["o2"][:, :64])
        assert not torch.equal(r["o1"][:, 64:], r["o2"][:, 64:])
        assert torch.equal(r["spec_out"], r["o1"])
        assert torch.equal(r["grouped"], r["grouped_ref"])
        assert r["grouped_disp"]["fused"] is False
    else:
        for rows, want in ((16, ("data",)), (9, ())):
            got, single, axes = r[rows]
            assert torch.equal(got, single) and axes == want, rows


def test_sharded_quant_dot_fallbacks_are_counted_and_warned_once():
    x, w = _inputs(2)
    for r in run_ranks(_fallbacks_rank, 2, x, w):
        count, msgs = r["unfused"]
        assert count == 2 and len(msgs) == 1 and "'torch'" in msgs[0]
        count, msgs, same = r["mismatch"]
        assert count == 1 and len(msgs) == 1 and same
        count, msgs, finite = r["unshardable"]
        assert count == 1 and len(msgs) == 1 and finite


RING_REF = """
import base64, io
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.distributed.collectives import int8_ring_all_reduce

mesh = jax.make_mesh((4,), ("data",))
rng = np.random.default_rng(0)
contribs = jnp.asarray(rng.standard_normal((4, 32, 16)) * 5, jnp.float32)
contribs = jax.device_put(contribs, NamedSharding(mesh, P("data")))
out = np.asarray(int8_ring_all_reduce(contribs, mesh, "data"))
buf = io.BytesIO(); np.save(buf, out)
print("RING", base64.b64encode(buf.getvalue()).decode())
"""


def test_int8_ring_all_reduce_matches_reference(subproc):
    """4 ranks against the reference's ring on 4 fake host devices, same
    inputs: bitwise at every rank, and within 5% of the exact sum (the
    reference's own bound)."""
    line = [ln for ln in subproc(RING_REF, devices=4).splitlines() if ln.startswith("RING")][0]
    want = np.load(io.BytesIO(base64.b64decode(line.split()[1])))
    rng = np.random.default_rng(0)
    contribs = (rng.standard_normal((4, 32, 16)) * 5).astype(np.float32)
    got = run_ranks(_ring_rank, 4, contribs)
    exact = contribs.astype(np.float64).sum(0)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), want[i])
        rel = np.abs(g.numpy() - exact).max() / np.abs(exact).max()
        assert rel < 0.05, (i, rel)


def _thread_backward_rank(rank, world):
    """phi4-mini scaled down on mesh (2, 1), per-block recomputation: the
    gradients of this rank's shards with the backward run on the calling
    thread and on another one (as the autograd engine runs a CUDA
    backward)."""
    import threading

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.distributed.collectives import shard_tree
    from repro_torch.distributed.sharding import local_rows, sharding_rules
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import batch_row_axes, batch_to, local_batch
    from repro_torch.models.lm import init_lm, lm_loss, param_parts

    cfg = get_config("phi4-mini-3.8b").scaled_down().with_quant(
        QuantConfig(mode="int8", rotate="hadamard", backend="cuda", kv_quant=True))
    assert cfg.remat != "none"
    mesh = Mesh((2, 1), ("data", "model"), rank=rank)
    batch = batch_to(SyntheticDataset(cfg, ShapeSpec("t", "train", 16, 4), seed=0).batch(0),
                     "cpu")
    grads = []
    for on_thread in (False, True):
        with sharding_rules(mesh):
            params = shard_tree(init_lm(cfg, seed=0, device="cpu"), param_parts(cfg, mesh),
                                mesh)
            flat = T.leaves(params)
            for p in flat:
                p.requires_grad_(True)
            rows = batch_row_axes(mesh, 4)
            with local_rows(rows):
                loss, _ = lm_loss(cfg, params, local_batch(batch, mesh, rows))
        out = {}
        run = lambda: out.setdefault("g", torch.autograd.grad(loss, flat))  # noqa: E731
        if on_thread:
            t = threading.Thread(target=run)
            t.start()
            t.join()
        else:
            with sharding_rules(mesh):
                run()
        grads.append(out.get("g"))
    return grads


def test_recomputation_keeps_the_mesh_on_another_thread():
    """A CUDA backward runs on the autograd engine's own thread, where the
    thread-local mesh is unset: the recomputed blocks must still gather and
    shard as in the forward. Bitwise the calling thread's gradients."""
    for same_thread, other_thread in run_ranks(_thread_backward_rank, 2):
        assert other_thread is not None
        assert all(torch.equal(a, b) for a, b in zip(same_thread, other_thread))
