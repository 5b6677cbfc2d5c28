"""PyTorch port, the multi-device layer's pure parts against the JAX
reference: the logical-axis rules table, the resolver (``_resolve_axis``,
``resolve_spec``, ``_build_parts``: the divisibility guard and first-
occurrence de-duplication), the spec trees of every architecture
(parameters with ``qweight_specs``, optimizer state, batch, caches),
``constrain`` and the meshes.

The reference's resolver runs on duck-typed meshes (``axis_names`` and
``devices.shape``: all it reads), the port's on ``launch.mesh.Mesh``
descriptions of the same shapes. Every comparison is exact equality.
"""
import dataclasses
import itertools
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.core.quant import QuantConfig as JQuantConfig
from repro.distributed import sharding as jshd
from repro.launch import shapes as jshapes
from repro.launch import steps as jsteps
from repro.models import lm_param_specs as jlm_param_specs
from repro.optim import OptConfig as JOptConfig

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.quant import QuantConfig
from repro_torch.core.wquant import qweight_specs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import shapes
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_production_mesh
from repro_torch.launch.steps import opt_state_specs
from repro_torch.models.lm import init_lm, lm_param_specs
from repro_torch.optim import OptConfig

MESHES = [((1,), ("data",)), ((2,), ("model",)), ((1, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model"))]
LOGICAL = list(shd.DEFAULT_RULES) + [None, "unknown"]


def _jmesh(shape, names):
    return types.SimpleNamespace(axis_names=names,
                                 devices=types.SimpleNamespace(shape=shape))


def test_default_rules_equal_the_reference():
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES


@pytest.mark.parametrize("shape,names", MESHES)
def test_resolve_axis_and_spec_match_reference(shape, names):
    mesh, jmesh = Mesh(shape, names), _jmesh(shape, names)
    for a in LOGICAL:
        assert shd._resolve_axis(mesh, a) == jshd._resolve_axis(jmesh, a), a
    axes = ("batch", "seq", "heads", None)
    assert shd.resolve_spec(axes, mesh) == tuple(jshd.resolve_spec(axes, jmesh))
    assert shd.resolve_spec(axes) == ()          # no mesh, no spec


@pytest.mark.parametrize("shape,names", MESHES)
def test_build_parts_match_reference(shape, names):
    """Every pair of logical axes over dims of sizes that do and do not
    divide: the guard (whisper's vocab 51865 never splits) and the
    de-duplication (experts and dff both on 'model': the first dim wins)."""
    mesh, jmesh = Mesh(shape, names), _jmesh(shape, names)
    one = shd.make_resolver(mesh)
    dims = (1, 2, 6, 16, 51865, 512)
    for a, b in itertools.product(LOGICAL[:-1], repeat=2):
        for d0, d1 in ((16, 512), (51865, 6), (2, 1)):
            got = shd._build_parts(mesh, (a, b), (d0, d1))
            assert got == jshd._build_parts(jmesh, (a, b), (d0, d1)), (a, b, d0, d1)
            assert one((a, b), (d0, d1)) == tuple(got)
    for spec in (("experts", "dff", "fsdp"), ("vocab",), ("layers", "batch", "kvseq", "kv", None)):
        for shp in itertools.product(dims, repeat=len(spec)):
            assert shd._build_parts(mesh, spec, shp) == jshd._build_parts(jmesh, spec, shp)
    if mesh.sizes().get("model", 1) > 1:
        assert shd._build_parts(mesh, ("vocab",), (51865,)) == [None]
        assert shd._build_parts(mesh, ("experts", None, "dff"), (16, 4, 16))[2] is None


def _jcfg(arch):
    return jget_config(arch).scaled_down()


def _cfg(arch):
    return get_config(arch).scaled_down()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch):
    """``lm_param_specs(stacked=True)`` is the reference's tree; the port's
    per-layer layout is the same specs without the leading 'layers' axis,
    layer for layer."""
    cfg, jcfg = _cfg(arch), _jcfg(arch)
    assert lm_param_specs(cfg, stacked=True) == jlm_param_specs(jcfg)
    stacked, flat = lm_param_specs(cfg, stacked=True), lm_param_specs(cfg)
    i = 0
    for (pattern, repeats), group in zip(cfg.groups, stacked["groups"]):
        for _ in range(repeats):
            for j in range(len(pattern)):
                assert _unstack(group[f"p{j}"]) == flat["layers"][i]
                i += 1
    assert i == len(flat["layers"]) == cfg.num_layers


def _unstack(tree):
    if isinstance(tree, dict):
        return {k: _unstack(v) for k, v in tree.items()}
    assert tree[0] == "layers"
    return tuple(tree[1:])


def _jqnode(tree, lead: int = 1):
    """The reference's QTensor spec nodes as the port's dicts, with the
    first ``lead`` axes (a stacked group's 'layers') dropped."""
    from repro.core.wquant import QTensor as JQTensor

    if isinstance(tree, JQTensor):
        out = {"q": tree.q[lead:], "scale": tree.scale[lead:]}
        if tree.check is not None:
            out["check"] = tree.check[lead:]
        return out
    if isinstance(tree, dict):
        return {k: _jqnode(v, lead) for k, v in tree.items()}
    return tuple(tree[lead:])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_qweight_specs_match_reference(arch):
    """Serving storage (int8 weights, the down projections in the serving
    mode): the port's ``qweight_specs`` over its meta-initialized
    parameters is the reference's ``param_specs`` tree, layer for layer
    (the reference's QTensor nodes as dicts)."""
    quant = QuantConfig(mode="fp8_e4m3", rotate="hadamard", backend="torch", kv_quant=True)
    jquant = JQuantConfig(mode="fp8_e4m3", rotate="hadamard", backend="xla", kv_quant=True)
    cfg = dataclasses.replace(_cfg(arch).with_quant(quant), weight_quant="int8")
    jcfg = dataclasses.replace(_jcfg(arch).with_quant(jquant), weight_quant="int8")
    params = init_lm(cfg, device="meta")
    got = qweight_specs(lm_param_specs(cfg), params)
    want = jsteps.param_specs(jcfg)
    for key in ("emb", "final_norm", "unemb", "enc_norm"):
        if key in want:
            _same_qnodes(got[key], _jqnode(want[key], 0), params[key])
    for stack, name, groups in (("groups", "layers", cfg.groups),
                                ("enc_groups", "enc_layers", cfg.encoder_groups)):
        if stack not in want:
            continue
        i = 0
        for (pattern, repeats), group in zip(groups, want[stack]):
            for _ in range(repeats):
                for j in range(len(pattern)):
                    _same_qnodes(got[name][i], _jqnode(group[f"p{j}"]), params[name][i])
                    i += 1
    consumers = [lp["mlp"]["w_down"] for lp in got["layers"] if "mlp" in lp]
    assert all(set(c) == {"q", "scale"} for c in consumers)


def _same_qnodes(got, want, params):
    """Equal spec trees, but for one documented difference: a leaf the
    reference quantizes because its stacked (layers, ...) size passes the
    size floor while one layer's does not (``core.wquant``'s docstring;
    llama3-405b's scaled-down w_gate / w_up). There the port's leaf stays
    unquantized, and its spec is the reference's ``q`` spec."""
    from repro_torch.core.wquant import _MIN_SIZE

    if isinstance(want, dict) and set(want) <= {"q", "scale", "check"} and \
            not isinstance(got, dict):
        assert params.numel() < _MIN_SIZE and got == want["q"]
        return
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same_qnodes(got[k], want[k], params[k] if isinstance(params, dict) else None)
        return
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("state,compression", [("f32", "none"), ("int8", "none"),
                                               ("f32", "int8_ef")])
def test_opt_state_specs_match_reference(arch, state, compression):
    cfg, jcfg = _cfg(arch), _jcfg(arch)
    got = opt_state_specs(cfg, OptConfig(state_dtype=state, grad_compression=compression),
                          stacked=True)
    want = jsteps.opt_state_specs(jcfg, JOptConfig(state_dtype=state,
                                                   grad_compression=compression))
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch):
    cfg, jcfg = _cfg(arch), _jcfg(arch)
    assert shapes.batch_logical_specs(cfg) == jshapes.batch_logical_specs(jcfg)
    assert shapes.cache_logical_specs(cfg, stacked=True) == jshapes.cache_logical_specs(jcfg)
    per_layer = shapes.cache_logical_specs(cfg)
    assert len(per_layer) == cfg.num_layers
    assert all(v[0] == "batch" for c in per_layer for v in c.values())


def test_constrain_is_the_identity():
    x = torch.randn(2, 3, 4)
    assert shd.constrain(x, "batch", "seq", None) is x          # off a mesh
    with shd.sharding_rules(Mesh((2, 2), ("data", "model"))):
        assert shd.constrain(x, "batch", "seq", None) is x
        with pytest.raises(ValueError, match="3-d"):
            shd.constrain(x, "batch", None)
    assert shd.current_mesh() is None


def test_sharding_rules_overrides_and_local_rows_restore():
    mesh = Mesh((2, 2), ("data", "model"))
    with shd.sharding_rules(mesh, {"seq": "model"}):
        assert shd._resolve_axis(mesh, "seq") == "model"
        with shd.local_rows(("data",)):
            assert shd.row_axes() == ("data",)
        assert shd.row_axes() == ()
    assert shd._ctx().rules == shd.DEFAULT_RULES and shd.current_mesh() is None


def test_production_mesh_shapes():
    m = make_production_mesh()
    assert (m.shape, m.axis_names, m.size) == ((16, 16), ("data", "model"), 256)
    m = make_production_mesh(multi_pod=True)
    assert (m.shape, m.axis_names, m.size) == ((2, 16, 16), ("pod", "data", "model"), 512)
    assert not dist.is_initialized()                            # initialises nothing


def test_mesh_coordinates_are_row_major():
    m = Mesh((2, 3), ("data", "model"))
    assert [m.coords(r) for r in (0, 4, 5)] == [
        {"data": 0, "model": 0}, {"data": 1, "model": 1}, {"data": 1, "model": 2}]
    assert m.index(("data", "model"), 4) == 4 and m.index(("model", "data"), 4) == 3
    want = np.arange(6).reshape(2, 3)
    assert all(want[m.coords(r)["data"], m.coords(r)["model"]] == r for r in range(6))


def test_make_local_mesh_raises_when_mp_does_not_divide(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1,
                            rank=0)
    try:
        with pytest.raises(ValueError, match="does not divide"):
            make_local_mesh(2)
        m = make_local_mesh(1)
        assert (m.shape, m.axis_names, m.rank) == ((1, 1), ("data", "model"), 0)
    finally:
        dist.destroy_process_group()
