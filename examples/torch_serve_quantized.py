"""Serve a small model with batched requests and the paper's FP8 +
Hadamard-rotation KV-cache path (prefill -> decode loop) through the
PyTorch port's one-shot launcher: weights are pre-quantized once at load
into ``QTensor`` leaves, so the forward contracts the rotated activations
against fp8 weights directly (K4 at the down projection, K2 at the Q / K
sites on the card).

    PYTHONPATH=src python examples/torch_serve_quantized.py                  # H100
    PYTHONPATH=src python examples/torch_serve_quantized.py --device cpu --smoke

Any other argument goes to ``repro_torch.launch.serve`` (``--mp 2`` under
torchrun serves tensor-parallel over two ranks).
"""
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    smoke = "--smoke" in argv
    rest = [a for a in argv if a != "--smoke"]
    args = ["--arch", "llama3-8b", "--quant", "fp8_e4m3", "--rotate", "hadamard",
            "--prequant"]
    if smoke:
        # tiny shapes: a check that the pre-quantized serving path runs,
        # not a measurement
        args += ["--scale", "0.005", "--batch", "2", "--prompt-len", "16", "--gen", "4"]
    else:
        args += ["--scale", "0.05", "--batch", "8", "--prompt-len", "128", "--gen", "32"]
    return serve_main(args + rest)


if __name__ == "__main__":
    main()
