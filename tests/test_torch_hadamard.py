"""PyTorch port, transform stage: the plain version of the K1 HadaCore
kernel (``repro_torch.kernels.hadacore.transform_plain``) and the plan /
registry layer, held against the JAX reference on the CPU.

Inputs come from a numpy seed and go through both packages. Tolerances:

  * f32: bitwise against the reference's ``_xla_transform`` and its Pallas
    kernel in interpret mode. The one exception is n = 8, where XLA's CPU
    dot emitter sums an 8-long contraction in an order no torch matmul
    reproduces: there the bound is log2(n) = 3 f32 ulps at the row's
    largest value, the rounding model of a transform summed in another
    order (the bound chip_smoke.py holds the f32 kernel to).
  * bf16 / fp16: at most 1 ulp of the dtype at the row's largest value
    (every pass rounds to the compute dtype, so only the f32 summation
    order inside a pass can differ).

The CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py``.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hadamard as jhad
from repro.core.api import hadamard as jhadamard
from repro.core.api import plan_for as jplan_for
from repro.kernels import ref as jref
from repro.kernels.registry import _pallas_transform, _xla_transform

from repro_torch.core import hadamard as thad
from repro_torch.core.api import (QuantEpilogue, hadamard, plan_cache_info,
                                  plan_for)
from repro_torch.kernels import ref as tref
from repro_torch.kernels import registry
from repro_torch.kernels.hadacore import (hadacore, hadacore_cuda,
                                          scale_in_compute_dtype, transform,
                                          transform_plain)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16}
EPS = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _inputs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ulps(got: np.ndarray, want: np.ndarray, dt: str) -> float:
    """Largest |got - want| in ulps of ``dt`` at the row's largest value."""
    g = got.reshape(-1, got.shape[-1]).astype(np.float64)
    w = want.reshape(-1, want.shape[-1]).astype(np.float64)
    unit = EPS[dt] * np.maximum(np.abs(w).max(-1, keepdims=True), 1e-30)
    return float((np.abs(g - w) / unit).max())


def _check(got: np.ndarray, want: np.ndarray, dt: str, n: int):
    if dt == "float32" and n != 8:
        np.testing.assert_array_equal(got, want)
    elif dt == "float32":
        assert _ulps(got, want, dt) <= np.log2(n)
    else:
        assert _ulps(got, want, dt) <= 1.0


def _port_rows(x: np.ndarray, dt: str, n: int):
    xt = torch.from_numpy(x).to(TDT[dt])
    plan = plan_for(n, dtype=xt.dtype, backend="cuda", device_type="cpu")
    return transform_plain(xt, plan).float().numpy()


# ------------------------------------------------------------ K1 parity
@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n", [8, 32, 128, 2048, 16384])
def test_plain_k1_matches_xla_transform(n, dt):
    x = _inputs((16, n), seed=n)
    xj = jnp.asarray(x).astype(dt)
    want = np.asarray(_xla_transform(xj, jplan_for(
        n, dtype=xj.dtype, backend="xla")).astype(jnp.float32))
    _check(_port_rows(x, dt, n), want, dt, n)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8, 32, 128, 2048, 16384])
def test_plain_k1_matches_pallas_kernel_interpret(n, dt):
    x = _inputs((16, n), seed=n + 1)
    xj = jnp.asarray(x).astype(dt)
    want = np.asarray(_pallas_transform(xj, jplan_for(
        n, dtype=xj.dtype, backend="pallas"), True).astype(jnp.float32))
    _check(_port_rows(x, dt, n), want, dt, n)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("n", [96, 14336])
def test_grouped_transform_matches_reference(n, backend):
    """Non-power-of-2 sizes run I_g (x) H_p on the largest pow2 divisor
    (96 = 3 x 32; llama3-8b's d_ff 14336 = 7 x 2048): bitwise in bf16."""
    x = _inputs((2, 3, n), seed=7)
    want = np.asarray(jhadamard(jnp.asarray(x, jnp.bfloat16), backend="pallas",
                                interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = hadamard(xt, backend=backend)
    assert got.shape == xt.shape and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("scale", [None, "ortho", 0.25])
def test_scales_match_reference(scale):
    x = _inputs((4, 256), seed=3)
    want = np.asarray(jhadamard(jnp.asarray(x), scale=scale, backend="xla"))
    got = hadamard(torch.from_numpy(x), scale=scale).numpy()
    np.testing.assert_array_equal(got, want)


def test_scale_is_folded_in_compute_dtype():
    """The kernel gets the scale as the plan's bf16 base matrices carry it:
    f32(1/sqrt(n)) rounded to bf16, which for n = 128 and 2048 is not
    1/sqrt(n) itself."""
    for n in (128, 2048):
        plan = plan_for(n, dtype=torch.bfloat16, device_type="cpu")
        s = scale_in_compute_dtype(plan)
        ref = float(jnp.asarray(jplan_for(n, dtype=jnp.bfloat16).mats[0][0, 0],
                                jnp.bfloat16).astype(jnp.float32))
        assert s == ref and s != float(np.float32(1 / np.sqrt(n)))


def test_ref_backend_matches_reference_fwht():
    x = _inputs((5, 64), seed=4)
    want = np.asarray(jref.fwht(jnp.asarray(x), 0.125))
    np.testing.assert_array_equal(tref.fwht(torch.from_numpy(x), 0.125).numpy(), want)
    got = hadamard(torch.from_numpy(x), scale=0.125, backend="ref").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 64, 128, 256, 4096, 32768])
def test_factorization_and_base_matrices_match_reference(n):
    assert thad.factorize(n) == jhad.factorize(n)
    for scale in (None, thad.resolve_scale("ortho", n)):
        for a, b in zip(thad.base_matrices_np(n, scale),
                        jhad.base_matrices_np(n, scale)):
            np.testing.assert_array_equal(a, b)
    if n <= 1024:      # the explicit matrix is n x n
        np.testing.assert_array_equal(tref.hadamard_matrix(n),
                                      jref.hadamard_matrix(n))
    assert tref.is_pow2(n) == jref.is_pow2(n)


def test_resolve_helpers_match_reference():
    for n in (12, 96, 14336, 1024):
        assert thad.largest_pow2_divisor(n) == jhad.largest_pow2_divisor(n)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16),
                    (torch.float32, jnp.float32)):
        assert thad.resolve_compute_dtype(dt) == jhad.resolve_compute_dtype(jdt)
        assert thad.resolve_compute_dtype(dt, "float32") == "float32"
    with pytest.raises(ValueError):
        thad.resolve_scale("orth", 8)
    with pytest.raises(ValueError):
        thad.resolve_compute_dtype(torch.float32, "int8")


def test_hadamard_transform_and_grouped_match_reference():
    x = _inputs((3, 384), seed=5)
    np.testing.assert_array_equal(
        thad.grouped_hadamard(torch.from_numpy(x)).numpy(),
        np.asarray(jhad.grouped_hadamard(jnp.asarray(x))))
    x = _inputs((3, 512), seed=6)
    np.testing.assert_array_equal(
        thad.hadamard_transform(torch.from_numpy(x)).numpy(),
        np.asarray(jhad.hadamard_transform(jnp.asarray(x))))


# --------------------------------------------------- entry point, wrapper
def test_hadacore_entry_point_and_in_place():
    x = torch.from_numpy(_inputs((4, 1024), seed=8)).to(torch.bfloat16)
    want = hadamard(x, backend="torch")
    y = hadacore(x)
    assert torch.equal(y, want) and not torch.equal(x, want)
    buf = x.clone()
    out = hadacore(buf, in_place=True)
    assert out.data_ptr() == buf.data_ptr() and torch.equal(buf, want)
    with pytest.raises(ValueError, match="power of 2"):
        hadacore(torch.zeros(2, 96))
    with pytest.raises(ValueError, match="32768"):
        hadacore(torch.zeros(1, 65536))


def test_cuda_wrapper_refuses_cpu_tensors_and_counts_nothing():
    """The kernel wrapper takes CUDA rows only; a CPU tensor reaches the
    plain version through ``transform`` instead, with no launch counted."""
    x = torch.zeros(2, 128, dtype=torch.bfloat16)
    plan = plan_for(128, dtype=torch.bfloat16, backend="cuda", device_type="cpu")
    before = hadacore_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        hadacore_cuda(x, torch.empty_like(x), plan)
    transform(x, plan)
    assert hadacore_cuda.launches == before


# ----------------------------------------------------- plans, registry
def test_registry_selection_by_device_and_size(monkeypatch):
    monkeypatch.delenv(registry.BACKEND_ENV_VAR, raising=False)
    assert registry.select_backend(128, None, "cuda") == "cuda"
    assert registry.select_backend(128, None, "cpu") == "torch"
    assert registry.select_backend(65536, None, "cpu") == "torch"
    assert registry.select_backend(65536, "torch", "cuda") == "torch"
    # nothing falls back to the plain version on the card
    with pytest.raises(ValueError, match="name backend='torch'"):
        registry.select_backend(65536, None, "cuda")
    with pytest.raises(ValueError, match="does not take a 65536-point"):
        registry.select_backend(65536, "cuda", "cuda")
    assert registry.select_backend(128, "ref", "cuda") == "ref"
    assert registry.select_backend(128, "cuda", "cpu") == "cuda"
    monkeypatch.setenv(registry.BACKEND_ENV_VAR, "ref")
    assert registry.select_backend(128, None, "cuda") == "ref"
    assert registry.select_backend(128, "torch", "cuda") == "torch"
    with pytest.raises(ValueError, match="unknown Hadamard backend"):
        registry.select_backend(128, "pallas", "cuda")


def test_plan_cache_and_plan_checks():
    a = plan_for(2048, dtype=torch.bfloat16, device_type="cpu")
    hits = plan_cache_info().hits
    assert plan_for(2048, dtype=torch.bfloat16, device_type="cpu") is a
    assert plan_cache_info().hits == hits + 1
    assert a.compute_dtype == "bfloat16" and (a.k, a.r) == (1, 16)
    assert a.num_passes == 2 and not a.grouped
    g = plan_for(14336, dtype=torch.bfloat16, device_type="cpu")
    assert g.grouped and g.p == 2048
    assert plan_for(128, device_type="cuda") is not plan_for(128, device_type="cpu")
    x = torch.zeros(2, 2048, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="explicit plan"):
        hadamard(x, a, scale=None)
    with pytest.raises(ValueError, match="n=2048"):
        hadamard(torch.zeros(2, 1024, dtype=torch.bfloat16), a)
    with pytest.raises(ValueError, match="dtype"):
        hadamard(torch.zeros(2, 2048), a)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        QuantEpilogue("int4")


def test_warn_once_counts_every_call():
    key = ("test_torch", "warn")
    registry.WARN_ONCE_SEEN.discard(key)
    before = registry.TRACE_COUNTS[key]
    with pytest.warns(RuntimeWarning):
        registry.warn_once(key, "first")
    registry.warn_once(key, "second")
    assert registry.TRACE_COUNTS[key] == before + 2


# ------------------------------------------------------------ boundaries
def test_port_imports_no_jax_and_nothing_of_the_reference():
    """Importing every module of the port loads no jax, ml_dtypes or repro
    module (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]), bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    count, bad = r.stdout.strip().split(" ", 1)
    assert int(count) >= 20 and bad == "[]", r.stdout


def test_port_sources_never_name_the_reference():
    """No module of the port and no line of chip_smoke.py imports jax,
    ml_dtypes or the reference package."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    for path in files:
        for line in open(path):
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "ml_dtypes", "repro"), \
                    (path, s)
