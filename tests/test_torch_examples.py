"""PyTorch port, the four example twins (``examples/torch_*.py``) run on
the CPU at their ``--smoke`` sizes, each through the port's entry points
(the reference's four examples stay as they are)."""
import contextlib
import importlib.util
import io
import os

import pytest

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name: str, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = _example(name).main(argv)
    return out, buf.getvalue()


def test_quickstart_twin_runs_on_cpu():
    """The transform within f32 rounding of the butterfly oracle, the
    Hadamard self-inverse, the quantized site bitwise between a raw and a
    pre-quantized weight, and the rotation's gain on an outlier channel."""
    out, text = _run("torch_quickstart", ["--device", "cpu", "--smoke"])
    assert out["kernel_err"] < 1e-5 and out["self_inverse_err"] < 1e-5
    assert out["train_serve_bitwise"] and out["gain"] > 2.0
    assert "serving bind quantize_weight calls: 0" in text


def test_serve_quantized_twin_runs_on_cpu():
    out, text = _run("torch_serve_quantized", ["--device", "cpu", "--smoke"])
    assert out["tokens"].shape == (2, 4)
    assert "tok/s" in text


def test_train_100m_twin_runs_on_cpu(tmp_path):
    out, text = _run("torch_train_100m", ["--device", "cpu", "--smoke", "--ckpt-dir",
                                          str(tmp_path)])
    assert out == 0 and "done: 2 steps" in text
    assert any(d.startswith("step_") for d in os.listdir(tmp_path))


@pytest.mark.parametrize("variant", ["bf16_baseline", "fp8_attn_no_rotation",
                                     "fp8_attn_rotation_plain", "fp8_attn_rotation_hadacore"])
def test_rotation_accuracy_twin_runs_on_cpu(variant, accuracy):
    """Every variant's eval cross-entropy is finite and near ln(512) after
    3 steps; on CPU tensors the 'cuda' backend runs the plain versions, so
    the kernel column equals the plain one."""
    out, text = accuracy
    assert 0.5 < out[variant] < 10.0
    assert out["fp8_attn_rotation_hadacore"] == out["fp8_attn_rotation_plain"]
    assert "hadacore_matches_plain=True" in text


@pytest.fixture(scope="module")
def accuracy():
    return _run("torch_rotation_accuracy", ["--device", "cpu", "--smoke"])
