"""Quickstart (PyTorch / CUDA port): the HadaCore Hadamard transform and
rotation-quantization through ``repro_torch``, on the card by default.

    PYTHONPATH=src python examples/torch_quickstart.py                  # H100, full sizes
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --smoke

On a CUDA device the 'cuda' backend launches the hand-written kernels (K1
on the tensor cores, the fused rotate -> quantize K2 / K3, the fused
rotate -> quantize -> GEMM K4); on CPU tensors the same backend runs their
plain PyTorch versions.
"""
import argparse
import math

import numpy as np
import torch

from repro_torch.core import wquant
from repro_torch.core.api import QuantDotSpec, QuantEpilogue, hadamard, plan_for
from repro_torch.core.hadamard import hadamard_transform
from repro_torch.core.quant import QuantConfig
from repro_torch.core.rotations import fuse_rotation_lhs, rotation_matrix
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import fwht


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="small sizes")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = 512 if args.smoke else 4096          # transform size
    d = 128 if args.smoke else 512           # matmul out-channels
    rows = 16 if args.smoke else 64
    rng = np.random.default_rng(0)
    out = {}

    # 1. The transform: the backend's kernel against two plain versions
    x = torch.from_numpy(rng.standard_normal((8, n)).astype(np.float32)).to(dev)
    y_kernel = hadamard(x, backend="cuda")       # K1 on the card
    y_plain = hadamard_transform(x)              # the factored passes, in f32
    y_ref = fwht(x, scale=1 / math.sqrt(n))      # the paper's Listing-1 butterfly
    out["kernel_err"] = float((y_kernel - y_ref).abs().max())
    print("kernel vs oracle max err:", out["kernel_err"])
    print("plain  vs oracle max err:", float((y_plain - y_ref).abs().max()))

    # 2. One entry point, plans cached per shape
    plan = plan_for(n, backend="cuda", device_type=dev.type)
    print(f"plan: n={plan.n} backend={plan.backend} passes={plan.num_passes}")
    out["self_inverse_err"] = float((hadamard(hadamard(x)) - x).abs().max())
    print("self-inverse err:", out["self_inverse_err"])
    print("norm ratio:", float(hadamard(x, plan).norm() / x.norm()))

    # rotate + quantize in one kernel: the quantized rows and per-token
    # scales are its only outputs
    q, s = hadamard(x, epilogue=QuantEpilogue("int8"), backend="cuda")
    print("fused int8:", q.dtype, tuple(q.shape), "scales:", tuple(s.shape))
    qf, sf = hadamard(x, epilogue=QuantEpilogue("fp8_e4m3"), backend="cuda")
    print("fused fp8_e4m3:", qf.dtype, "dequant err:",
          float((qf.to(torch.float32) * sf - y_ref).abs().max()))

    # 3. Why LLM quantization wants it: one outlier channel smeared out
    acts = rng.standard_normal((rows, n)).astype(np.float32)
    acts[:, 17] *= 80.0
    a = torch.from_numpy(acts).to(dev)
    print(f"abs-max before rotation: {a.abs().max().item():8.1f}  "
          f"after: {hadamard(a).abs().max().item():8.1f}")

    # 4. The declarative consumer site: QuantDotSpec + QTensor. A raw
    # weight quantizes on the fly (training); a pre-quantized QTensor is
    # consumed directly (serving)
    w = torch.from_numpy((rng.standard_normal((n, d)) * 0.02).astype(np.float32)).to(dev)
    spec = QuantDotSpec.for_config(n, QuantConfig(mode="int8", rotate="hadamard",
                                                  backend="cuda"),
                                   weight_axes=("dff", "fsdp"))
    y_train = spec.bind(w)(a)
    qt = wquant.quantize_weight(w, "int8")          # once, at load time
    print("QTensor:", qt.q.dtype, tuple(qt.q.shape), "scales:", tuple(qt.scale.shape),
          "mode:", qt.mode)
    before = wquant.QUANTIZE_WEIGHT_CALLS
    y_serve = spec.bind(qt)(a)
    out["train_serve_bitwise"] = bool(torch.equal(y_train, y_serve))
    print("serving bind quantize_weight calls:", wquant.QUANTIZE_WEIGHT_CALLS - before,
          " train-vs-serve bitwise:", out["train_serve_bitwise"])

    # 5. Why rotation helps the int8 grid: the offline half fused into W
    ref = a @ w
    plain = QuantDotSpec.for_config(n, QuantConfig(mode="int8", backend="cuda"))
    wr = fuse_rotation_lhs(w, rotation_matrix(n).to(dev))    # W <- Q^T W
    err0 = float((plain.bind(w)(a) - ref).abs().mean())
    err1 = float((spec.bind(wr)(a) - ref).abs().mean())
    out["gain"] = err0 / err1
    print(f"int8 matmul error: plain {err0:.4f} -> rotated {err1:.4f} "
          f"({out['gain']:.1f}x better)")
    return out


if __name__ == "__main__":
    main()
