"""Train a ~100M-parameter llama3-family model for a few hundred steps
with the paper's rotation-quantization on, through the PyTorch port's
training launcher, with checkpoints (kill and re-run: it resumes from the
newest one).

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 300]         # H100
    PYTHONPATH=src python examples/torch_train_100m.py --device cpu --smoke

``--smoke`` trains a tiny model for 2 steps (a check that the path runs).
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_100m_ckpt"))
    ap.add_argument("--quant", default="int8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    # scale 0.12 of llama3-8b: d_model 1408, 11 layers, the reference
    # example's sizes (``launch.flops.count_params`` counts its parameters)
    size = (["--scale", "0.005", "--seq", "32", "--batch", "2", "--steps", "2",
             "--ckpt-every", "2", "--log-every", "1"] if args.smoke else
            ["--scale", "0.12", "--seq", "512", "--batch", "8", "--steps", str(args.steps),
             "--ckpt-every", "50", "--log-every", "10"])
    return train_main(["--arch", "llama3-8b", "--quant", args.quant, "--rotate", "hadamard",
                       "--ckpt-dir", args.ckpt_dir, "--device", args.device] + size)


if __name__ == "__main__":
    raise SystemExit(main())
