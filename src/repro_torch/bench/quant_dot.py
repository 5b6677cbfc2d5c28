"""Timing harness of the fused quant_dot family on one CUDA card: K4, K5,
K8, K6, K6s and the ABFT twins K7a-ro, K7a-s, K7a-rv, K7b, K7b-s.

    PYTHONPATH=src python -m repro_torch.bench.quant_dot [--json PATH]

Prints the card's name and power limit (nvidia-smi), then one JSON record
per case: ``benchmarks/run.py``'s fields (``bench, shape, dtype, backend,
ms, gbps``) plus ``kernel``, ``mode``, ``device_ms`` (``torch.profiler``,
the kernel's own instantiation), ``bound_ms`` / ``bound_by`` (the bytes
read once over the HBM rate or the operations over their peak rate, the
larger), ``plain_ms`` (the plain PyTorch version on the card),
``library_ms`` / ``library_device_ms`` (one PyTorch call per weight matrix
that contracts the already-quantized operand: ``torch._int_mm`` in int8,
``torch._scaled_mm`` in fp8_e4m3; none for fp8_e5m2 and the ABFT twins,
whose residual no library call computes) and ``max_abs_err`` against the
plain version. ``ms`` is CUDA events over many calls (the host's launch
path included); ``gbps`` the bytes the bound counts over ``ms``. ``--json``
also writes the records to PATH as a list. Without a CUDA device it exits
at once (code 2) and prints nothing.

The default cases are the shapes of the port's paths: phi4-mini's down
projection (8192 -> 3072, int8) at decode (4 rows), prefill (64) and the
training step's rows (2048); llama4-maverick's (8192 -> 5120, fp8_e4m3)
dense at 4 and 64 rows and over 128 experts at (4, 128, 1, 8192) and at a
training step's capacity (4, 128, 5, 8192), and over the 64 experts a rank
holds when 'model' splits them in two (4, 64, 1, 8192); fp8 at the training
rows;
whisper-base's (2048 -> 512, int8) at decode (4 rows) and at its encoder's
rows (4 inputs of 1500 frames: 6000, not a multiple of
the row block); the ABFT twins at their decode shapes. Two cases at the
training rows against 64 columns (2 tiles of the 96 at 3072) read the
rotation's share of K4 there: the rotation of every row is the same work,
the contraction a 48th of it. ``chip_smoke.py`` times its kernels through
``measure`` and the helpers here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
from typing import Optional

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
F32_CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12           # H100 SXM, dense int8 tensor cores
FP8_OPS_PER_S = 1979e12            # H100 SXM, dense fp8 tensor cores
EXPERTS = 128                      # llama4-maverick's experts per MoE layer

# kernel -> (schedule, experts, abft)
KERNELS = {
    "K4": ("rotate_once", False, False), "K5": ("streamed", False, False),
    "K8": ("revisit", False, False), "K6": ("rotate_once", True, False),
    "K6s": ("streamed", True, False), "K7a-ro": ("rotate_once", False, True),
    "K7a-s": ("streamed", False, True), "K7a-rv": ("revisit", False, True),
    "K7b": ("rotate_once", True, True), "K7b-s": ("streamed", True, True),
}


@dataclasses.dataclass(frozen=True)
class Case:
    """One timing: ``kernel`` (a key of KERNELS) in ``mode`` on ``rows``
    rows (experts: batch rows per expert, each of ``cap`` capacity slots)
    of n -> d."""

    kernel: str
    mode: str
    rows: int
    n: int
    d: int
    cap: int = 1
    n_experts: int = EXPERTS     # an expert kernel's experts (a rank's share under a split)

    @property
    def experts(self) -> int:
        return self.n_experts if KERNELS[self.kernel][1] else 0

    @property
    def shape(self) -> str:
        if self.experts:
            return f"{self.rows}x{self.experts}x{self.cap}x{self.n}x{self.d}"
        return f"{self.rows}x{self.n}x{self.d}"


PHI4, MAVERICK, WHISPER = (8192, 3072), (8192, 5120), (2048, 512)
WHISPER_ENCODER_ROWS = 4 * 1500    # 4 inputs of whisper's 1500 frames
# maverick's capacity slots per expert in a training step of 4 x 512 tokens:
# int(capacity_factor 1.25 x 512 tokens x top-1 / 128 experts)
MAVERICK_TRAIN_CAP = 5
CASES = (
    Case("K4", "int8", 4, *PHI4), Case("K5", "int8", 4, *PHI4), Case("K4", "int8", 64, *PHI4),
    Case("K4", "int8", 2048, *PHI4), Case("K8", "int8", 2048, *PHI4),
    Case("K4", "fp8_e4m3", 2048, *PHI4),
    Case("K4", "int8", 2048, 8192, 64), Case("K4", "fp8_e4m3", 2048, 8192, 64),
    Case("K4", "fp8_e4m3", 4, *MAVERICK), Case("K5", "fp8_e4m3", 4, *MAVERICK),
    Case("K4", "fp8_e4m3", 64, *MAVERICK), Case("K5", "fp8_e4m3", 64, *MAVERICK),
    Case("K8", "fp8_e4m3", 4, *MAVERICK),
    Case("K4", "int8", 4, *WHISPER), Case("K4", "int8", WHISPER_ENCODER_ROWS, *WHISPER),
    Case("K6", "fp8_e4m3", 4, *MAVERICK), Case("K6s", "fp8_e4m3", 4, *MAVERICK),
    Case("K6", "fp8_e4m3", 4, *MAVERICK, cap=MAVERICK_TRAIN_CAP),
    Case("K6", "fp8_e4m3", 4, *MAVERICK, n_experts=EXPERTS // 2),
    Case("K7a-ro", "int8", 4, *PHI4), Case("K7a-rv", "int8", 4, *PHI4),
    Case("K7a-ro", "fp8_e4m3", 4, *MAVERICK), Case("K7a-s", "fp8_e4m3", 4, *MAVERICK),
    Case("K7b", "fp8_e4m3", 4, *MAVERICK), Case("K7b-s", "fp8_e4m3", 4, *MAVERICK),
)


def cuda_time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time of ``fn()`` on the current stream, from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, low_ops: float, f32_ops: float, low_rate: float):
    """(bound ms, 'bytes' or 'operations'): the larger of the bytes over
    the HBM rate and the operations over their peak rates (``low_ops`` at
    the int8 / fp8 tensor-core rate ``low_rate``, ``f32_ops`` on CUDA
    cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (low_ops / low_rate + f32_ops / F32_CUDA_CORE_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_times(fn, calls: int = 5):
    """(kernel name, device microseconds) of every kernel that ``calls``
    calls of ``fn`` launch, from ``torch.profiler``: empty when the capture
    holds no device event. It records the device's activity alone, as
    ``chip_smoke.py``'s profiles of whole steps do: in a process that has
    run such a window, a later one that also records the host's ops
    captured no device event on an H100."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            dev = getattr(evt, "self_device_time_total", None)
            us = evt.self_cuda_time_total if dev is None else dev
            if us > 0:
                rows.append((evt.key, us))
    return rows


def profile_ms(fn, name: str, streamed: bool = False, abft: bool = False,
               calls: int = 5, revisit: bool = False):
    """Device time per call of the kernel ``name`` from ``torch.profiler``
    over ``calls`` calls of ``fn``, or None when no device event of it was
    captured. For the quant_dot kernels (template arguments T, BM, kInt,
    kStreamed, kAbft, and for the dense kernel kRevisit) only the
    instantiations of the schedule and the ABFT flag asked for count."""
    total, matched = 0.0, False
    for key, us in kernel_times(fn, calls):
        if f"{name}<" not in key:
            continue
        if name.startswith("quant_dot"):
            args = key.split(f"{name}<", 1)[1].split(">", 1)[0].split(", ")
            if (args[3] == "true") != streamed or (args[4] == "true") != abft:
                continue
            if len(args) > 5 and (args[5] == "true") != revisit:
                continue
        total, matched = total + us, True
    return total / calls / 1e3 if matched else None


def device_ms(fn, calls: int = 5):
    """Device time per call of ``fn`` from ``torch.profiler``: every kernel
    it launches, summed (a library call may launch more than one); None
    when the capture holds no device event."""
    rows = kernel_times(fn, calls)
    return sum(us for _, us in rows) / calls / 1e3 if rows else None


def library_dot(x, wq, sw, mode: str, experts: bool):
    """One PyTorch library call per weight matrix (per expert for the
    expert form) that contracts the already-quantized rows of x with wq:
    ``torch._int_mm`` for int8, ``torch._scaled_mm`` with row-wise scales
    for fp8_e4m3. The contraction alone, since no PyTorch call rotates,
    quantizes and contracts. Returns (call, its name)."""
    from repro_torch.kernels.registry import QSPECS, _quantize_rows, cast_to

    n = x.shape[-1]
    E = wq.shape[0] if experts else 1
    w = wq if experts else wq[None]
    q, s = _quantize_rows(x.reshape(-1, n).float(), mode)

    def per_expert(t):   # (rows, k) -> (E, rows per expert, k); x (..., E, c, n)
        k = t.shape[-1]
        if not experts:
            return t.view(1, -1, k)
        return t.view(-1, E, x.shape[-2], k).transpose(0, 1).reshape(E, -1, k)

    q, s = per_expert(q), per_expert(s)
    m = q.shape[1]
    if mode == "int8":
        per = max(32, m)      # _int_mm wants more than 16 rows
        a = torch.zeros(E, per, n, dtype=torch.int8, device="cuda")
        a[:, :m] = q.to(torch.int8)
        return (lambda: [torch._int_mm(a[e], w[e]) for e in range(E)]), "torch._int_mm"
    per = -(-m // 16) * 16    # _scaled_mm wants rows in multiples of 16
    a = torch.zeros(E, per, n, dtype=QSPECS[mode][1], device="cuda")
    a[:, :m] = cast_to(q, QSPECS[mode][1])
    sa = torch.ones(E, per, 1, device="cuda")
    sa[:, :m] = s
    wt = w.transpose(1, 2).contiguous()     # column-major (n, d) per expert
    sb = sw.reshape(E, 1, -1).contiguous()
    return (lambda: [torch._scaled_mm(a[e], wt[e].t(), scale_a=sa[e], scale_b=sb[e],
                                      out_dtype=torch.bfloat16)
                     for e in range(E)]), "torch._scaled_mm"


def expert_weights(gen, n: int, d: int, mode: str, experts: int = EXPERTS):
    """(experts, n, d) weights ~ N(0, 1/n) in bf16, drawn and quantized per
    (expert, out-channel) 8 experts at a time on the card."""
    from repro_torch.core.wquant import QTensor, quantize_weight
    from repro_torch.kernels.registry import QSPECS

    q = torch.empty((experts, n, d), dtype=QSPECS[mode][1], device="cuda")
    sc = torch.empty((experts, 1, d), dtype=torch.float32, device="cuda")
    for i in range(0, experts, 8):
        k = min(8, experts - i)
        w = (torch.randn((k, n, d), generator=gen, device="cuda") / math.sqrt(n)).to(
            torch.bfloat16)
        qt = quantize_weight(w, mode)
        q[i:i + k], sc[i:i + k] = qt.q, qt.scale
    return QTensor(q, sc, mode)


def weights(gen, case: Case):
    """The case's quantized weight (a QTensor) and its column checksum cw
    (dense (n,), experts (E, 1, n)), drawn from ``gen``."""
    from repro_torch.core.wquant import quantize_weight, weight_checksum

    if case.experts:
        qt = expert_weights(gen, case.n, case.d, case.mode, case.experts)
        return qt, weight_checksum(qt.q, qt.scale)
    w = (torch.randn(case.n, case.d, generator=gen, device="cuda")
         / math.sqrt(case.n)).to(torch.bfloat16)
    qt = quantize_weight(w, case.mode, with_check=True)
    return qt, qt.check


def measure(case: Case, gen, qt=None, cw=None, x=None) -> dict:
    """Time one case on the card: its kernel (events and profile), the
    plain version, the library call, the bound. ``qt`` / ``cw`` (from
    ``weights``) and the bf16 rows ``x`` are drawn from ``gen`` when not
    given. Returns the record."""
    from repro_torch.core.api import QuantEpilogue, plan_for
    from repro_torch.kernels import quant_dot as qd

    sched, experts, abft = KERNELS[case.kernel]
    if qt is None:
        qt, cw = weights(gen, case)
    n, d, E = case.n, case.d, case.experts
    rows = case.rows * max(E, 1) * case.cap
    plan = plan_for(n, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                    epilogue=QuantEpilogue(case.mode))
    if x is None:
        x = (torch.randn(rows, n, generator=gen, device="cuda") * 3).to(torch.bfloat16)
        if E:
            x = x.view(case.rows, E, case.cap, n)
    check = cw if abft else None
    if E:
        run = lambda: qd.quant_dot_experts(  # noqa: E731
            x, qt.q, qt.scale, plan, sched, check=check)
        plain = ((lambda: qd.quant_dot_experts_abft_plain(x, qt.q, qt.scale, cw, plan))
                 if abft else (lambda: qd.quant_dot_experts_plain(x, qt.q, qt.scale, plan)))
        key = "quant_dot_experts_kernel"
    else:
        run = lambda: qd.quant_dot(x, qt.q, qt.scale, plan, sched, check=check)  # noqa: E731
        plain = ((lambda: qd.quant_dot_abft_plain(x, qt.q, qt.scale, cw, plan))
                 if abft else (lambda: qd.quant_dot_plain(x, qt.q, qt.scale, plan)))
        key = "quant_dot_kernel"
    got, want = run(), plain()
    if abft:
        got, want = got[0], want[0]
    err = float((got.float() - want.float()).abs().max())
    del got, want
    big = E or case.rows > 64
    ms = cuda_time_ms(run, iters=20 if big else 200)
    dev = profile_ms(run, key, sched == "streamed", abft, revisit=sched == "revisit")
    plain_ms = cuda_time_ms(plain, iters=3 if E else (5 if big else 20), warmup=1)
    lib_ms = lib_dev = lib_name = None
    if not abft and case.mode in ("int8", "fp8_e4m3"):
        lib, lib_name = library_dot(x, qt.q, qt.scale, case.mode, bool(E))
        lib_ms = cuda_time_ms(lib, iters=10 if E else (20 if big else 200))
        lib_dev = device_ms(lib)
        del lib
    wbytes = qt.q.numel() + qt.scale.numel() * 4 + (cw.numel() * 4 if abft else 0)
    nbytes = 2 * rows * n + wbytes + 2 * rows * d + (4 * rows if abft else 0)
    low = INT8_OPS_PER_S if case.mode == "int8" else FP8_OPS_PER_S
    bound_ms, by = bound(nbytes, 2 * rows * n * d,
                         rows * n * (math.log2(n) + (8 if abft else 6)), low)
    g = qd.launch_grid(case.rows * case.cap, n, d, case.mode, E, sched, abft)
    return {"bench": f"quant_dot_{case.mode}", "shape": case.shape, "dtype": "bfloat16",
            "backend": f"cuda_{case.kernel}_{sched}", "ms": ms,
            "gbps": nbytes / ms / 1e6, "kernel": case.kernel, "mode": case.mode,
            "device_ms": dev, "bound_ms": bound_ms, "bound_by": by, "plain_ms": plain_ms,
            "library": lib_name, "library_ms": lib_ms, "library_device_ms": lib_dev,
            "max_abs_err": err, "grid": g}


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench quant_dot: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    records, cache = [], {}
    for case in CASES:
        key = (case.mode, case.n, case.d, case.experts)
        if key not in cache:
            cache.clear()
            torch.cuda.empty_cache()
            cache[key] = weights(gen, case)
        rec = measure(case, gen, *cache[key])
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
