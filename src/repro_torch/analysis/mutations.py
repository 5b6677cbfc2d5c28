"""The mutation fixture of the port's kernel-contract linter (twin of
``repro.analysis.mutations``): two deliberately broken Hopper kernels the
linter MUST flag, the proof that its rules have teeth
(``python -m repro_torch.analysis.lint --mutation`` exits non-zero with
both named).

* M1 ``mutant_unguarded_rotate_cuda`` (``csrc/mutants/unguarded_rotate.cu``,
  replacing ``repro/analysis/mutations.py::_mutant_unguarded_rotate``): K4
  with its rotation moved inside the column-tile loop, so each block
  re-rotates its row block before every tile. Its output is bitwise K4's;
  the ``rotate-once-contract`` rule must catch it from the rotation counts.
* M2 ``mutant_dangling_dma_cuda`` (``csrc/mutants/dangling_dma.cu``,
  replacing ``mutations.py::_mutant_dangling_dma``): K5 with the ring's
  final drain removed, so copies may dangle when a block ends. Its per-step
  waits stay, so its output is bitwise K5's; the ``dma-safety`` rule must
  catch it from its PTX alone.

Both are built only by the linter (``kernels/build.py``, ``LINT_TARGETS``)
and reached by no dispatch. They compute K4's and K5's function, so their
plain versions are K4's and K5's, ``kernels.quant_dot.quant_dot_plain``: no
new plain code. Each wrapper counts its launches, as the kernels' do.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from repro_torch.analysis.sites import Site

__all__ = ["mutant_unguarded_rotate_cuda", "mutant_dangling_dma_cuda", "mutant_sites",
           "mutant_lib", "MUTANT_SHAPES", "MUTANT_ROWS"]

# (config whose down projection it runs at, the schedule of the kernel it breaks)
MUTANT_SHAPES = {
    "unguarded_rotate": ("phi4-mini-3.8b", "rotate_once"),
    "dangling_dma": ("llama4-maverick-400b-a17b", "streamed"),
}
# rows of a mutant site: at phi4-mini's full width a 64-row call gives K4
# 3 column tiles per block, so M1 rotates each row 3x as often as K4
MUTANT_ROWS = 64


def mutant_lib(name: str) -> Tuple[ctypes.CDLL, str]:
    """(the loaded library of ``csrc/mutants/<name>.cu``, its export
    prefix), built first if needed."""
    from repro_torch.kernels import build

    lib = build.load_target(build.mutant(name))
    prefix = f"mutant_{name}"
    fn = getattr(lib, f"{prefix}_launch")
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 4 + [LL, I, I, I, I, I, ctypes.c_float, I, P]
        fn.restype = I
        grid = getattr(lib, f"{prefix}_grid")
        grid.argtypes = [LL, I, I, I, ctypes.POINTER(LL)]
        grid.restype = I
        attrs = getattr(lib, f"{prefix}_attributes")
        attrs.argtypes = [LL, I, I, ctypes.POINTER(LL)]
        attrs.restype = I
    return lib, prefix


def _launch(name: str, x2, wq, sw, out, plan) -> None:
    """One launch of mutant ``name`` on contiguous (m, n) bf16 CUDA rows
    ``x2`` against the (n, d) weight ``wq`` and its (d,) f32 scales, into
    ``out`` ((m, d) bf16), on the current stream; K4's argument checks."""
    from repro_torch.core.hadamard import torch_dtype
    from repro_torch.kernels.fused_quant import MODE_CODES
    from repro_torch.kernels.hadacore import (DTYPE_CODES, check_rows,
                                              scale_in_compute_dtype)
    from repro_torch.kernels.registry import QSPECS

    epi = plan.epilogue
    if epi is None or epi.dequant or not epi.per_token or plan.grouped:
        raise ValueError(f"mutant {name} takes per-token (q, scales) plans, got {epi!r}")
    m, n = x2.shape
    d = wq.shape[-1]
    check_rows(x2, x2, plan)
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"mutant {name} takes bf16 rows, got {x2.dtype}")
    if not all(t.is_cuda and t.device == x2.device and t.is_contiguous()
               for t in (wq, sw, out)):
        raise ValueError(f"mutant {name} operands must be contiguous CUDA tensors "
                         "on one device")
    if wq.shape != (n, d) or wq.dtype != QSPECS[epi.mode][1] or sw.shape != (d,) \
            or sw.dtype != torch.float32 or out.shape != (m, d) or out.dtype != x2.dtype:
        raise ValueError(f"mutant {name}: bad operands wq {tuple(wq.shape)} {wq.dtype}, "
                         f"sw {tuple(sw.shape)} {sw.dtype}, out {tuple(out.shape)}")
    lib, prefix = mutant_lib(name)
    rc = getattr(lib, f"{prefix}_launch")(
        x2.data_ptr(), wq.data_ptr(), sw.data_ptr(), out.data_ptr(), m, n, d, plan.r,
        DTYPE_CODES[x2.dtype], DTYPE_CODES[torch_dtype(plan.compute_dtype)],
        scale_in_compute_dtype(plan), MODE_CODES[epi.mode],
        torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mutant {name} launch failed: CUDA error {rc}")


def mutant_unguarded_rotate_cuda(x2, wq, sw, out, plan) -> torch.Tensor:
    """Launch M1: K4's output, every row block re-rotated before each of
    its column tiles."""
    _launch("unguarded_rotate", x2, wq, sw, out, plan)
    mutant_unguarded_rotate_cuda.launches += 1
    return out


def mutant_dangling_dma_cuda(x2, wq, sw, out, plan) -> torch.Tensor:
    """Launch M2: K5 ending its blocks without draining its ring."""
    _launch("dangling_dma", x2, wq, sw, out, plan)
    mutant_dangling_dma_cuda.launches += 1
    return out


mutant_unguarded_rotate_cuda.launches = 0
mutant_dangling_dma_cuda.launches = 0
WRAPPERS = {"unguarded_rotate": mutant_unguarded_rotate_cuda,
            "dangling_dma": mutant_dangling_dma_cuda}


def grid(name: str, m: int, n: int, d: int, mode: str) -> dict:
    """The launch geometry of a mutant call (K4's or K5's)."""
    from repro_torch.kernels.fused_quant import MODE_CODES

    lib, prefix = mutant_lib(name)
    out = (ctypes.c_longlong * 6)()
    if getattr(lib, f"{prefix}_grid")(m, n, d, MODE_CODES[mode], out) != 0:
        raise ValueError(f"no launch of mutant {name} fits m={m} n={n} d={d}")
    return dict(zip(("bm", "smem", "row_blocks", "splits", "tiles_per_block", "cluster"),
                    list(out)))


def _attributes(name: str, m: int, n: int, mode: str) -> dict:
    from repro_torch.kernels.fused_quant import MODE_CODES

    lib, prefix = mutant_lib(name)
    out = (ctypes.c_longlong * 5)()
    rc = getattr(lib, f"{prefix}_attributes")(m, n, MODE_CODES[mode], out)
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes of mutant {name}: CUDA error {rc}")
    return dict(zip(("bm", "static_smem", "max_dynamic_smem", "regs", "local"), list(out)))


def mutant_inputs(name: str, device="cuda", seed: int = 0, mode=None):
    """(x (MUTANT_ROWS, n) bf16, quantized weight, plan) of a mutant's
    site: its config's down projection in ``mode`` (default the config's),
    from a ``torch.Generator`` seeded with ``seed``."""
    from repro_torch.analysis.sites import SITE_MODES, _cfg, site_dims
    from repro_torch.core.api import QuantDotSpec
    from repro_torch.core.wquant import quantize_weight

    config, _ = MUTANT_SHAPES[name]
    n, d, _ = site_dims(config)
    mode = mode or SITE_MODES[_cfg(config).name]
    gen = torch.Generator(device=device).manual_seed(seed)
    w = (torch.randn((n, d), generator=gen, device=device) / n ** 0.5).to(torch.bfloat16)
    x = (torch.randn((MUTANT_ROWS, n), generator=gen, device=device) * 3).to(torch.bfloat16)
    plan = QuantDotSpec(n=n, mode=mode).plan(torch.bfloat16, "cuda")
    return x, quantize_weight(w, mode), plan


def mutant_sites(device="cuda", seed: int = 0) -> List[Site]:
    """The two mutants as kernel sites, ``mutant[unguarded_rotate]`` and
    ``mutant[dangling_dma]``, each launched once through its wrapper on its
    config's down projection (M1 phi4-mini int8, M2 llama4-maverick
    fp8_e4m3; ``MUTANT_ROWS`` rows) with the evidence a kernel site
    carries. Their expected rotations are K4's and K5's geometry's. Raises
    when M1's geometry gives a block one column tile: it would then rotate
    as often as K4 and prove nothing."""
    from repro_torch.analysis import ptx
    from repro_torch.analysis.dispatch_trace import dtype_name, recording
    from repro_torch.analysis.sites import _plain_ops, ptx_entry
    from repro_torch.kernels import quant_dot as qd

    if torch.device(device).type != "cuda":
        raise ValueError("the mutants run on the card")
    sites = []
    for name, (_, schedule) in MUTANT_SHAPES.items():
        x, qt, plan = mutant_inputs(name, device, seed)
        m, n = x.shape
        d = qt.q.shape[-1]
        mode = plan.epilogue.mode
        geo = grid(name, m, n, d, mode)
        if name == "unguarded_rotate" and geo["tiles_per_block"] < 2:
            raise ValueError(f"M1 at {m} x {n} -> {d}: one column tile per block, so it "
                             "rotates as often as K4 and proves nothing")
        lib, prefix = mutant_lib(name)
        qd.rotation_counts(lib, prefix, 0)
        out = torch.empty((m, d), dtype=x.dtype, device=x.device)
        sw = qt.scale.reshape(d).contiguous()
        with torch.inference_mode(), recording() as ev:
            WRAPPERS[name](x, qt.q, sw, out, plan)
        counts, lost = qd.rotation_counts(lib, prefix, m)
        smem = {"planned": qd._smem_bytes(n, geo["bm"], mode, schedule),
                "fits": qd.kernel_fits(n, mode, schedule), "requested": geo["smem"],
                "mutant": _attributes(name, m, n, mode),
                "optin": torch.cuda.get_device_properties(x.device)
                .shared_memory_per_block_optin}
        entry = events = None
        if schedule == "streamed":
            want = ptx.Instantiation("quant_dot_kernel", "bfloat16", geo["bm"],
                                     mode == "int8", True, False, False)
            entry, events = ptx_entry(f"mutants/{name}.cu", want)
        sites.append(Site(
            name=f"mutant[{name}]", kind="kernel", schedule=schedule, plan=plan,
            io_dtype=dtype_name(x.dtype), n=n, ops=ev.ops, plain_ops=_plain_ops(x[:8], plan),
            launches=ev.launches, qw_calls=ev.qw_calls, shim_calls=ev.shim_calls,
            rotations=counts, rotations_lost=lost,
            expected_rotations=geo["splits"] // geo["cluster"], geometry=geo, smem=smem,
            ptx_entry=entry, ptx_events=events))
    return sites
