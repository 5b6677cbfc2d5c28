"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--seed 0]

Runs from the repository root and needs the repository's ``src/``. It

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
     per source, in parallel) and prints the build seconds;
  3. kernel phase: holds every kernel of the serving path against its plain
     PyTorch version on the card (K1 ``hadacore`` at n in {128, 2048,
     32768} x {bf16, fp16, f32} and grouped 14336; K2 ``fused_dequant`` at
     n in {128, 2048} x {int8, fp8_e4m3, fp8_e5m2}, bf16) and times each at
     the shapes the serving path gives it (CUDA events) beside its bound,
     its plain version and, for K1, one ``torch.matmul`` against H_n;
  4. model phase: builds full-width llama3-8b (fp8_e4m3 + Hadamard + fp8
     KV cache, int8 weight storage) on the card from ``--seed``, holds a
     prefill through the kernels against one through the plain versions,
     then serves 8 requests on 4 slots through ``ServeEngine`` with the
     kernels' launch counters zeroed just before and read just after,
     and checks 32 K1 and 64 K2 launches per model pass. The prefill
     limit is calibrated in the same run: witnesses (correct paths that
     differ as a kernel may) must pass it and controls (known faults)
     must fail it;
  5. prints the kernels' JSON line, then the result line
     ``{"ok": true, "device": {...}}`` last.

Any failed check raises: the script then exits non-zero and prints no
result line. Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SLOTS, PREFILL_LEN, MAX_LEN = 4, 64, 256   # the serving run's engine
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
F32_CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
IO_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
EPS = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7,
       torch.float16: 2.0 ** -10}


def fail(msg: str) -> None:
    raise AssertionError(msg)


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


def k1_ulps(got: torch.Tensor, want: torch.Tensor, cd: torch.dtype) -> float:
    """Largest |got - want| per row, in compute-dtype ulps at the row's
    largest magnitude."""
    g, w = got.float().reshape(-1, got.shape[-1]), want.float().reshape(-1, want.shape[-1])
    unit = EPS[cd] * w.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(((g - w).abs() / unit).max())


def k1_tolerance(n: int, cd: torch.dtype) -> float:
    """K1 against its plain version, in ulps at the row max: 1 for 16-bit
    compute (both round every pass to the compute dtype; only f32 sums in
    another order differ); log2(n) for f32 compute, where nothing rounds
    the two summation orders back together (the rounding model of a
    log2(n)-stage transform)."""
    return 1.0 if cd != torch.float32 else float(max(1, int(math.log2(n))))


def k2_excess(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor, plan) -> float:
    """Largest |got - want| / (one storage-grid step x the row's scale +
    one io ulp of the value); <= 1 passes."""
    from repro_torch.kernels.hadacore import transform_plain
    from repro_torch.kernels.registry import QSPECS, _quantize_rows

    mode = plan.epilogue.mode
    y = transform_plain(x, plan).float()
    q, s = _quantize_rows(y, mode)
    if QSPECS[mode][2]:
        step = torch.ones_like(q)
    else:
        mbits, emin = (3, -6) if mode == "fp8_e4m3" else (2, -14)
        e = torch.floor(torch.log2(q.abs().clamp_min(2.0 ** emin)))
        step = torch.exp2(e - mbits)
    w = want.float()
    tol = step * s + EPS[x.dtype] * w.abs()
    return float(((got.float() - w).abs() / tol).max())


def kernel_phase(gen: torch.Generator):
    """Build-free check and timing of K1 and K2 (the build happened
    before). Returns the two kernels' entries of the JSON line."""
    from repro_torch.core.api import QuantEpilogue, hadamard, plan_for
    from repro_torch.kernels.fused_quant import fused_dequant, fused_dequant_plain
    from repro_torch.kernels.hadacore import transform, transform_plain
    from repro_torch.kernels.ref import hadamard_matrix

    print("-- kernel phase: K1 hadacore against its plain version")
    for n in (128, 2048, 32768):
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            x = torch.randn(64, n, generator=gen, device="cuda").to(dt)
            plan = plan_for(n, dtype=dt, backend="cuda", device_type="cuda")
            got = transform(x, plan)
            torch.cuda.synchronize()
            err = k1_ulps(got, transform_plain(x, plan), dt)
            tol = k1_tolerance(n, dt)
            print(f"K1 n={n:5d} {str(dt):15s} max err {err:.3f} ulp(row max) "
                  f"(tolerance {tol:g})")
            if not err <= tol:
                fail(f"K1 n={n} {dt}: {err} ulps > {tol}")
    x = torch.randn(4, 14336, generator=gen, device="cuda").to(torch.bfloat16)
    plan = plan_for(14336, dtype=torch.bfloat16, backend="cuda", device_type="cuda")
    got = hadamard(x, plan)
    want = hadamard(x, plan_for(14336, dtype=torch.bfloat16, backend="torch",
                                device_type="cuda"))
    torch.cuda.synchronize()
    err = k1_ulps(got.reshape(-1, 2048), want.reshape(-1, 2048), torch.bfloat16)
    print(f"K1 grouped n=14336 (7 x 2048) bf16 max err {err:.3f} ulp (tolerance 1)")
    if not err <= 1.0:
        fail(f"K1 grouped 14336: {err} ulps")

    print("-- kernel phase: K2 fused_dequant against its plain version")
    for n in (128, 2048):
        for mode in ("int8", "fp8_e4m3", "fp8_e5m2"):
            x = (torch.randn(256, n, generator=gen, device="cuda") * 3).to(torch.bfloat16)
            plan = plan_for(n, dtype=torch.bfloat16, backend="cuda",
                            device_type="cuda",
                            epilogue=QuantEpilogue(mode, dequant=True))
            got = fused_dequant(x, plan)
            torch.cuda.synchronize()
            want = fused_dequant_plain(x, plan)
            exc = k2_excess(got, want, x, plan)
            bitwise = bool(torch.equal(got, want))
            print(f"K2 n={n:5d} {mode:9s} error / (grid step x row scale) "
                  f"{exc:.3f} (tolerance 1), bitwise={bitwise}")
            if not exc <= 1.0:
                fail(f"K2 n={n} {mode}: {exc} grid steps")

    print("-- kernel phase: times at the serving path's shapes "
          "(llama3-8b, bf16; decode = one token on each of "
          f"{SLOTS} slots, prefill = {PREFILL_LEN} tokens)")
    entries = {}
    shapes = [  # (kernel, site, rows, n, mode)
        ("K1", "decode down-proj", SLOTS * 7, 2048, None),
        ("K1", "prefill down-proj", PREFILL_LEN * 7, 2048, None),
        ("K2", "decode Q", SLOTS * 32, 128, "fp8_e4m3"),
        ("K2", "decode K", SLOTS * 8, 128, "fp8_e4m3"),
        ("K2", "prefill Q", PREFILL_LEN * 32, 128, "fp8_e4m3"),
        ("K2", "prefill K", PREFILL_LEN * 8, 128, "fp8_e4m3"),
    ]
    for kern, site, rows, n, mode in shapes:
        x = torch.randn(rows, n, generator=gen, device="cuda").to(torch.bfloat16)
        epi = QuantEpilogue(mode, dequant=True) if mode else None
        plan = plan_for(n, dtype=torch.bfloat16, backend="cuda",
                        device_type="cuda", epilogue=epi)
        if kern == "K1":
            run = lambda: transform(x, plan)                       # noqa: E731
            plain = lambda: transform_plain(x, plan)               # noqa: E731
            H = torch.from_numpy(hadamard_matrix(n, 1.0 / math.sqrt(n))).to(
                device="cuda", dtype=torch.bfloat16)
            library = lambda: torch.matmul(x, H)                   # noqa: E731
            ops = rows * n * math.log2(n)
        else:
            run = lambda: fused_dequant(x, plan)                   # noqa: E731
            plain = lambda: fused_dequant_plain(x, plan)           # noqa: E731
            library = None
            ops = rows * n * (math.log2(n) + 6)
        got, want = run(), plain()
        err = float((got.float() - want.float()).abs().max())
        if kern == "K1":
            exc = k1_ulps(got, want, torch.bfloat16)
        else:
            exc = k2_excess(got, want, x, plan)
        if not exc <= 1.0:
            fail(f"{kern} {site}: error {exc} of its tolerance")
        ms = cuda_time_ms(run)
        plain_ms = cuda_time_ms(plain, iters=50)
        library_ms = cuda_time_ms(library) if library else None
        nbytes = 2 * rows * n * IO_BYTES[torch.bfloat16]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_CUDA_CORE_OPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        lib = f"{library_ms:.5f}" if library_ms is not None else "none"
        print(f"{kern} {site:18s} ({rows} x {n}): kernel {ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms, torch.matmul(x, H_n) {lib} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}), max abs err {err:g}")
        if kern not in entries:    # the decode shape: the path's most frequent
            entries[kern] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": library_ms}
    # device throughput at a size where launch overhead does not dominate
    x = torch.randn(16384, 2048, generator=gen, device="cuda").to(torch.bfloat16)
    plan = plan_for(2048, dtype=torch.bfloat16, backend="cuda", device_type="cuda")
    ms = cuda_time_ms(lambda: transform(x, plan), iters=50)
    print(f"K1 16384 x 2048 bf16 (not a path shape): {ms:.4f} ms, "
          f"{2 * x.numel() * 2 / ms / 1e6:.0f} GB/s of {HBM_BYTES_PER_S / 1e9:.0f}")
    plan = plan_for(128, dtype=torch.bfloat16, backend="cuda", device_type="cuda",
                    epilogue=QuantEpilogue("fp8_e4m3", dequant=True))
    x = x.reshape(-1, 128)
    ms = cuda_time_ms(lambda: fused_dequant(x, plan), iters=50)
    print(f"K2 262144 x 128 bf16 fp8_e4m3 (not a path shape): {ms:.4f} ms, "
          f"{2 * x.numel() * 2 / ms / 1e6:.0f} GB/s")
    return entries


# The model-phase limits on the relative RMS difference of the prefill
# logits (all 64 positions) between the kernels and the plain versions, at
# depth 1 (the first layer alone, then the head) and at full depth. Each
# sits near the geometric mean of the largest reading of the kernels and
# the witness (a correct path one rounding away from the plain one) and
# the smallest reading of the controls (paths with a known fault) on an
# H100 (PERF.md); the run re-measures all of them and re-asserts the order.
PREFILL_LIMITS = {1: 3e-3, 32: 0.045}


def _calibration_backends():
    """Registers (once) the faulty backends that calibrate the prefill
    limit; the model reaches them through ``REPRO_HADAMARD_BACKEND``.

      k2_no_quant    the Q/K sites rotate but skip the fp8 fake-quant (K2
                     without its epilogue)
      k1_exact_scale every rotation runs its passes unscaled and applies
                     the exact f32 1/sqrt(n) at the end, instead of folding
                     the compute-dtype-rounded scale into pass 0
    """
    import functools

    from repro_torch.core.hadamard import (_apply_passes, base_matrices_np,
                                           torch_dtype)
    from repro_torch.kernels import registry
    from repro_torch.kernels.hadacore import transform_plain

    if "k2_no_quant" in registry.available_backends():
        return

    class Calibration(registry.Backend):
        priority = -1

        def auto_on(self, device_type):
            return False

        def supports(self, p):
            return True

    @registry.register_backend
    class K2NoQuant(Calibration):
        name = "k2_no_quant"

        def transform(self, x, plan, in_place=False):
            return transform_plain(x, plan)

        def fused_dequant(self, x, plan):
            return transform_plain(x, plan)

    @functools.lru_cache(maxsize=None)
    def unscaled_mats(p, device):
        return [torch.from_numpy(m).to(device) for m in base_matrices_np(p, None)]

    @registry.register_backend
    class K1ExactScale(Calibration):
        name = "k1_exact_scale"

        def transform(self, x, plan, in_place=False):
            cd = torch_dtype(plan.compute_dtype)
            y = _apply_passes(x.to(cd).reshape(-1, plan.p), plan.p,
                              unscaled_mats(plan.p, x.device))
            return (y.float() * (1.0 / math.sqrt(plan.p))).to(x.dtype).reshape(
                x.shape)


class _one_flip:
    """A context in which the first MLP output (layer 0) has its largest
    value moved by 1 ulp: the smallest change a rounding can make to the
    residual stream that every later layer reads. (A flip inside a rotation
    is mostly absorbed by the fp8 step of the site after it.)"""

    def __enter__(self):
        from repro_torch.models import mlp

        self.mlp, self.apply = mlp, mlp.apply_mlp
        armed = [True]

        def apply_mlp(cfg, p, x):
            y = self.apply(cfg, p, x).contiguous()
            if armed[0]:
                flat = y.view(-1)
                flat.view(torch.int16)[int(flat.float().abs().argmax())] ^= 1
                armed[0] = False
            return y

        mlp.apply_mlp = apply_mlp

    def __exit__(self, *exc):
        self.mlp.apply_mlp = self.apply


def hold_prefill_against_plain(cfg, params, quant, seed: int) -> None:
    """One 64-token prompt through the kernels, the plain versions, the
    witness (``_one_flip``) and the controls, at depth 1 and at full depth.
    The kernels' difference from the plain versions must stay within the
    limit, the witness's too, and every control's beyond it. Prints every
    reading before it checks any."""
    import contextlib
    import dataclasses

    from repro_torch.kernels.registry import BACKEND_ENV_VAR
    from repro_torch.models.lm import lm_forward

    _calibration_backends()
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))).cuda()
    named = {b: cfg.with_quant(dataclasses.replace(quant, backend=b))
             for b in ("cuda", "torch", "auto")}

    def logits(route, depth):
        p = dict(params, layers=params["layers"][:depth])
        if route in ("cuda", "torch", "one_flip"):
            c = named["torch" if route == "one_flip" else route]
        else:
            c = named["auto"]
            os.environ[BACKEND_ENV_VAR] = route
        flip = _one_flip() if route == "one_flip" else contextlib.nullcontext()
        try:
            with torch.inference_mode(), flip:
                out = lm_forward(c, p, {"tokens": prompt})[0]
        finally:
            os.environ.pop(BACKEND_ENV_VAR, None)
        out = out[..., :cfg.vocab_size].float()
        if not torch.isfinite(out).all():
            fail(f"non-finite prefill logits ({route}, depth {depth})")
        return out

    witnesses = ("one_flip",)
    controls = ("k2_no_quant", "k1_exact_scale")
    rel = {}
    for depth in (1, cfg.num_layers):
        plain = logits("torch", depth)
        for route in ("cuda",) + witnesses + controls:
            got = logits(route, depth)
            rel[depth, route] = float((got - plain).norm() / plain.norm())
            top1 = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
            print(f"prefill depth {depth:2d}, {route:14s} vs plain: relative "
                  f"RMS {rel[depth, route]:.6f}, max |dlogit| "
                  f"{float((got - plain).abs().max()):.5f} of "
                  f"{float(plain.abs().max()):.3f}, top-1 {top1 * 100:.1f}%")
    for depth in (1, cfg.num_layers):
        limit = PREFILL_LIMITS[depth]
        print(f"prefill depth {depth:2d}: limit {limit:g}")
        for route in ("cuda",) + witnesses:
            if not rel[depth, route] <= limit:
                fail(f"prefill depth {depth}: {route} at {rel[depth, route]} "
                     f"> {limit}")
        for route in controls:
            if not rel[depth, route] > limit:
                fail(f"prefill depth {depth}: control {route} at "
                     f"{rel[depth, route]} passes the limit {limit}")



def model_phase(args):
    """Full-width llama3-8b: kernels-vs-plain prefill, then the serving
    run with the launch counters. Returns (summary, launches)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels.fused_quant import fused_dequant_cuda
    from repro_torch.kernels.hadacore import hadacore_cuda
    from repro_torch.models.lm import init_lm
    from repro_torch.serving import ServeEngine, synthetic_stream

    quant = QuantConfig(mode="fp8_e4m3", rotate="hadamard", backend="cuda",
                        kv_quant=True)
    cfg = dataclasses.replace(get_config("llama3-8b").with_quant(quant),
                              weight_quant="int8")
    print(f"-- model phase: {cfg.name} d_model={cfg.d_model} heads="
          f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff="
          f"{cfg.d_ff} vocab={cfg.vocab_size} layers={cfg.num_layers}, "
          "fp8_e4m3 + hadamard + fp8 KV, int8 weights")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"init + quantize layer by layer: {time.perf_counter() - t0:.1f} s, "
          f"{wbytes / 1e9:.2f} GB of weights, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    hold_prefill_against_plain(cfg, params, quant, args.seed)

    engine = ServeEngine(cfg, params, num_slots=SLOTS, max_len=MAX_LEN,
                         prefill_len=PREFILL_LEN, device="cuda")
    stream = synthetic_stream(8, vocab_size=cfg.vocab_size,
                              prompt_len=(16, PREFILL_LEN),
                              max_new_tokens=(16, 32), rate=1.0,
                              seed=args.seed)
    hadacore_cuda.launches = 0
    fused_dequant_cuda.launches = 0
    t0 = time.perf_counter()
    comps = engine.run(stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": hadacore_cuda.launches, "K2": fused_dequant_cuda.launches}
    s = engine.summary()
    passes = s["prefill_calls"] + s["decode_calls"]
    print(f"served {s['requests']} requests / {s['generated_tokens']} tokens in "
          f"{s['decode_steps']} decode steps ({wall:.1f} s wall): "
          f"{s['tokens_per_s']:.1f} tok/s, p50 {s['p50_token_ms']:.2f} ms / "
          f"p99 {s['p99_token_ms']:.2f} ms per token, occupancy "
          f"{s['occupancy'] * 100:.0f}%, warm-up {s['warmup_s']:.2f} s")
    print(f"launches: K1 {launches['K1']}, K2 {launches['K2']} over {passes} "
          f"model passes ({s['prefill_calls']} prefills + {s['decode_calls']} "
          f"decode steps, warm-up included) = {launches['K1'] / passes:g} and "
          f"{launches['K2'] / passes:g} per pass")
    if launches["K1"] != cfg.num_layers * passes:
        fail(f"K1 launches {launches['K1']} != {cfg.num_layers} x {passes}")
    if launches["K2"] != 2 * cfg.num_layers * passes:
        fail(f"K2 launches {launches['K2']} != {2 * cfg.num_layers} x {passes}")
    if len(comps) != 8 or any(c.status != "ok" for c in comps):
        fail(f"not every request completed: {comps}")
    for c in comps:
        if not (1 <= len(c.tokens) <= 32 and all(0 <= t < cfg.vocab_size
                                                 for t in c.tokens)):
            fail(f"request {c.rid}: bad tokens {c.tokens}")
    if s["quantize_weight_calls"] != 0:
        fail("weights were quantized while serving")
    profile_decode(engine)
    return s, launches


def profile_decode(engine, steps: int = 3) -> None:
    """Where a decode step's time goes: ``torch.profiler`` over a few
    decode steps on the engine's 4 slots (after the counted run, at the
    positions the run left), device time by kernel and the device's busy
    share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine._decode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine._decode()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:   # kernels, not the ops
            continue                             # that launched them
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = evt.self_cuda_time_total
        if dev > 0:
            rows.append((dev, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"-- profile: {steps} decode steps, {wall_us / steps / 1e3:.2f} ms "
          f"wall per step (profiler on), kernels busy {busy / steps / 1e3:.2f} "
          f"ms per step ({100 * busy / wall_us:.1f}% of the window)")
    ours = ("hadacore_kernel", "fused_dequant_kernel")
    for i, (dev, count, key) in enumerate(rows):
        if i < 8 or any(k in key for k in ours):
            print(f"   {dev / steps / 1e3:8.3f} ms/step  {count // steps:5d} "
                  f"calls/step  {key[:90]}")


def _leaves(tree):
    from repro_torch.core.wquant import QTensor

    if isinstance(tree, QTensor):
        yield tree.q
        yield tree.scale
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    spent = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          + " ".join(f"{k}={v:.1f}s" for k, v in spent.items()))

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timed = kernel_phase(gen)
    _, launches = model_phase(args)

    meta = {
        "K1": {"name": "hadacore", "source": "src/repro_torch/csrc/hadacore.cu",
               "replaces": "src/repro/kernels/registry.py:224"},
        "K2": {"name": "fused_dequant",
               "source": "src/repro_torch/csrc/fused_quant.cu",
               "replaces": "src/repro/kernels/registry.py:283"},
    }
    kernels = [{"name": meta[k]["name"], "route": "cuda",
                "source": meta[k]["source"], "replaces": meta[k]["replaces"],
                "launches": launches[k], **timed[k]} for k in ("K1", "K2")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
