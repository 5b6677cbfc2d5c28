"""A/B of the transform kernels K1 (``hadacore_cuda``) and K2
(``fused_dequant_cuda``) between two checkouts of this repository on one
CUDA card.

    python src/repro_torch/bench/ab_transform.py A_ROOT B_ROOT [--json PATH]

A_ROOT and B_ROOT are the roots of two checkouts, e.g. a parent commit
unpacked with ``git archive`` into a directory that .gitignore lists, and
this one. Each tree runs in its own process, with its own build, in turns
A, B, B, A; each turn times every case by its device time
(``torch.profiler``: every kernel of 20 calls, summed, per call) and by
CUDA events. The script prints the card's name and power limit
(nvidia-smi), one JSON line per case with each turn's readings, the mean
of each tree's two turns and B's over A's, and with ``--json`` writes the
records to PATH. Without a CUDA device it exits at once (code 2).

The cases are the transform harness's (``repro_torch.bench.hadamard``,
this file's own tree) path and train cases, and two throughput shapes (K1
at 16384 x 2048 bf16, K2 fp8_e4m3 at 262144 x 128). A turn imports only
what both trees have: ``core.api.plan_for``, ``kernels.build``,
``kernels.hadacore.hadacore_cuda`` and ``kernels.fused_quant.
fused_dequant_cuda``. The script itself imports neither tree: a turn runs
it again as ``--turn ROOT`` with ROOT's ``src`` first on the path.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CALLS = 20


def _cases() -> list:
    """[kernel, rows, n, mode] of this tree's harness cases, in a child
    process (the parent of this script must not import either tree)."""
    src = os.path.normpath(os.path.join(HERE, "..", ".."))
    code = ("import json; from repro_torch.bench.hadamard import CASES; print(json.dumps("
            "[[c.kernel, c.rows, c.n, c.mode] for c in CASES if c.group != 'sweep']))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=dict(os.environ, PYTHONPATH=src))
    return json.loads(out.stdout) + [["K1", 16384, 2048, None],
                                     ["K2", 262144, 128, "fp8_e4m3"]]


def _device_ms(fn) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            dev = getattr(evt, "self_device_time_total", None)
            total += evt.self_cuda_time_total if dev is None else dev
    return total / CALLS / 1e3 if total > 0 else None


def _events_ms(fn, iters: int = 200) -> float:
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def turn(root: str, cases: list) -> list:
    """Every case through ROOT's kernels: [device ms, events ms] each."""
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_quant import fused_dequant_cuda
    from repro_torch.kernels.hadacore import hadacore_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build([build.Target("hadacore.cu"), build.Target("fused_quant.cu")])
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for kernel, rows, n, mode in cases:
        x = torch.randn(rows, n, generator=gen, device="cuda").to(torch.bfloat16)
        y = torch.empty_like(x)
        if kernel == "K1":
            plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cuda")
            fn = lambda: hadacore_cuda(x, y, plan)            # noqa: E731
        else:
            plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                            epilogue=QuantEpilogue(mode, dequant=True))
            fn = lambda: fused_dequant_cuda(x, y, plan)       # noqa: E731
        out.append([_device_ms(fn), _events_ms(fn, 20 if rows * n > (1 << 22) else 200)])
        del x, y
        torch.cuda.empty_cache()
    return out


def _mean(a, b):
    return None if a is None or b is None else (a + b) / 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", metavar="ROOT")
    ap.add_argument("--turn", default=None, metavar="ROOT")
    ap.add_argument("--cases", default=None)
    ap.add_argument("--json", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_transform: no CUDA device", file=sys.stderr)
        return 2
    if args.turn:
        print(json.dumps(turn(args.turn, json.loads(args.cases))))
        return 0
    if len(args.roots) != 2:
        ap.error("give two checkout roots, A and B")
    a, b = (os.path.abspath(r) for r in args.roots)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
        flush=True)
    cases = _cases()
    turns = []
    for root in (a, b, b, a):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", root,
                               "--cases", json.dumps(cases)],
                              capture_output=True, text=True, cwd=root)
        if done.returncode != 0:
            print(done.stdout + done.stderr, file=sys.stderr)
            return 1
        turns.append(json.loads(done.stdout.strip().splitlines()[-1]))
    records = []
    for i, (kernel, rows, n, mode) in enumerate(cases):
        r = [t[i] for t in turns]
        dev_a, dev_b = _mean(r[0][0], r[3][0]), _mean(r[1][0], r[2][0])
        rec = {"bench": "hadamard_ab", "kernel": kernel, "shape": f"{rows}x{n}",
               "mode": mode, "a": a, "b": b,
               "device_ms_turns": [t[0] for t in r], "events_ms_turns": [t[1] for t in r],
               "a_device_ms": dev_a, "b_device_ms": dev_b,
               "a_ms": _mean(r[0][1], r[3][1]), "b_ms": _mean(r[1][1], r[2][1]),
               "b_over_a": dev_b / dev_a if dev_a and dev_b else None}
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
