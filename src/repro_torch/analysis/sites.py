"""Lint sites of the port's kernel-contract linter (twin of
``repro.analysis.sites``).

A ``Site`` is one call the rules run over, with the evidence recorded while
it ran (``dispatch_trace``) in place of the reference's jaxpr and HLO: a
fused-kernel dispatch (its aten ops, launch deltas, per-row rotation counts
from the counting build, launch geometry, shared-memory readings and, for a
streamed kernel, the PTX events of its instantiation), a model forward (the
MLP with its bound down-projection spec), or a serving step (a decode step
or a prefill-insert of a ``ServeEngine``, with its cache leaves' pointers
before and after).

The builders go through the entry points production uses --
``QuantDotSpec.bind`` / ``bind_experts``, ``models.mlp.apply_mlp``,
``ServeEngine`` -- so the lint asserts the paths the model and the server
take, not a lookalike. Kernel and model sites run on the card only (their
rules read the kernels); serving sites run on either device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.dispatch_trace import (OpRecord, OpRecorder, cache_snapshot,
                                                 dtype_name, recording)

__all__ = ["Site", "kernel_sites", "model_sites", "serving_sites", "default_sites",
           "site_dims", "site_weights", "SITE_MODES", "ROWS", "EXPERT_BATCH"]

# The mode each model's fused sites serve in (the port's serving runs):
# W8A8 int8 for phi4-mini, fp8_e4m3 for llama3-8b and llama4-maverick.
SITE_MODES = {"llama3-8b": "fp8_e4m3", "phi4-mini-3.8b": "int8",
              "llama4-maverick-400b-a17b": "fp8_e4m3"}
ROWS = 64          # dense kernel sites: one prefill bucket of rows
EXPERT_BATCH = 4   # expert kernel sites: (4, E, 1, n), a decode step of 4 slots


@dataclasses.dataclass
class Site:
    """One recorded call plus the facts the rules check it against. Every
    evidence field is optional: each rule's ``applies()`` keys off what the
    site carries."""

    name: str
    kind: str                                  # "kernel" | "model" | "serving"
    schedule: Optional[str] = None             # resolved kernel schedule
    plan: Any = None                           # HadamardPlan of the fused site
    io_dtype: Optional[str] = None
    n: Optional[int] = None                    # the fused contraction's width
    ops: Tuple[OpRecord, ...] = ()             # aten ops of the call
    plain_ops: Tuple[OpRecord, ...] = ()       # the plain transform's ops, same plan
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    qw_calls: int = 0
    shim_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    # rotate-once evidence: per-row counts from the counting build, and the
    # count per row the launch geometry implies
    rotations: Optional[np.ndarray] = None
    rotations_lost: int = 0
    expected_rotations: Optional[int] = None
    geometry: Dict[str, int] = dataclasses.field(default_factory=dict)
    same_as_uninstrumented: Optional[bool] = None
    # smem-budget evidence: planned (kernel_fits' layout), requested (the
    # launch), per library the cudaFuncGetAttributes reading, the card's limit
    smem: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # dma-safety evidence: the PTX entry of the instantiation and its events
    ptx_entry: Optional[str] = None
    ptx_events: Optional[tuple] = None
    # serving evidence
    decode: bool = False
    cache_leaves: Tuple[Tuple[Tuple[int, ...], str], ...] = ()
    cache_before: tuple = ()
    cache_after: tuple = ()


def _cfg(config: str):
    from repro_torch.configs import get_config

    return get_config(config)


def site_dims(config: str) -> Optional[Tuple[int, int, int]]:
    """(n, d, experts) of the config's fused down projection at its own
    width, n = d_ff -> d = d_model. None when d_ff is not a power of 2: the
    site then runs the grouped rotation and the unfused GEMM, no fused
    kernel."""
    cfg = _cfg(config)
    if cfg.d_ff & (cfg.d_ff - 1):
        return None
    return cfg.d_ff, cfg.d_model, cfg.num_experts


def site_weights(config: str, device="cuda", seed: int = 0):
    """The dense (n, d) and, for a MoE config, the stacked (E, n, d) weight
    of the config's fused sites, N(0, 1/n) in bf16, quantized per
    out-channel in the config's mode with their ABFT checksums, drawn from a
    ``torch.Generator`` seeded with ``seed`` (experts a chunk at a time).
    Returns (dense QTensor, expert QTensor or None)."""
    from repro_torch.core import wquant
    from repro_torch.kernels.registry import QSPECS

    n, d, E = site_dims(config)
    mode = SITE_MODES[_cfg(config).name]
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return (torch.randn(shape, generator=gen, device=device)
                / math.sqrt(n)).to(torch.bfloat16)

    dense = wquant.quantize_weight(draw(n, d), mode, with_check=True)
    if not E:
        return dense, None
    q = torch.empty((E, n, d), dtype=QSPECS[mode][1], device=device)
    s = torch.empty((E, 1, d), dtype=torch.float32, device=device)
    c = torch.empty((E, 1, n), dtype=torch.float32, device=device)
    step = wquant.chunk_len(n * d)
    for i in range(0, E, step):
        j = min(i + step, E)
        qt = wquant.quantize_weight(draw(j - i, n, d), mode, with_check=True)
        q[i:j], s[i:j], c[i:j] = qt.q, qt.scale, qt.check
    return dense, wquant.QTensor(q, s, mode, c)


_PTX: Dict[str, dict] = {}


def ptx_entry(source: str, want) -> Tuple[str, tuple]:
    """(mangled name, events) of the instantiation ``want``
    (``ptx.Instantiation``) in the PTX of ``csrc/<source>``, built and
    parsed once per source."""
    from repro_torch.analysis import ptx
    from repro_torch.kernels import build

    if source not in _PTX:
        _PTX[source] = ptx.events_of(build.ptx_text(source))
    if want not in _PTX[source]:
        raise LookupError(f"no PTX entry of {want} in {source}")
    name, events = _PTX[source][want]
    return name, tuple(events)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def _plain_ops(x: torch.Tensor, plan) -> Tuple[OpRecord, ...]:
    """The aten ops of the plain transform of ``plan`` on x's device."""
    from repro_torch.core.api import _strip
    from repro_torch.kernels.hadacore import transform_plain

    rec = OpRecorder()
    with torch.inference_mode(), rec:
        transform_plain(x, _strip(plan))
    return tuple(rec.ops)


def _kernel_site(name, call, x, plan, *, experts: bool, schedule: str, abft: bool,
                 mode: str, m: int, n: int, d: int, E: int, rows: int) -> "Site":
    """Run ``call`` (the production entry point of one fused site) once
    with the main kernels and once, recorded, with their rotation-counting
    builds, and gather the evidence of every kernel rule."""
    from repro_torch.analysis import ptx
    from repro_torch.kernels import quant_dot as qd

    with torch.inference_mode():
        y0 = call()
    torch.cuda.synchronize()
    attrs_main = qd.kernel_attributes(m, n, mode, x.dtype, experts, schedule, abft)
    lib, stem = qd.counting_lib(experts, abft)
    qd.rotation_counts(lib, stem, 0)           # zero the counters
    with qd.counting_rotations():
        with torch.inference_mode(), recording() as ev:
            y1 = call()
        counts, lost = qd.rotation_counts(lib, stem, rows)
        attrs_count = qd.kernel_attributes(m, n, mode, x.dtype, experts, schedule, abft)
    y0 = y0[0] if isinstance(y0, tuple) else y0
    y1 = y1[0] if isinstance(y1, tuple) else y1
    geo = qd.launch_grid(m, n, d, mode, E if experts else 0, schedule, abft)
    per_row = geo["splits"] // geo["cluster"]
    smem = {"planned": qd._smem_bytes(n, geo["bm"], mode, schedule, abft),
            "fits": qd.kernel_fits(n, mode, schedule, abft),
            "requested": geo["smem"], "main": attrs_main, "counting": attrs_count,
            "optin": torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin}
    entry = events = None
    if schedule == "streamed":
        src = ("quant_dot_experts" if experts else "quant_dot") + ("_abft" if abft else "")
        want = ptx.Instantiation(
            "quant_dot_experts_kernel" if experts else "quant_dot_kernel", "bfloat16",
            geo["bm"], mode == "int8", True, abft, False)
        entry, events = ptx_entry(f"{src}.cu", want)
    return Site(name=name, kind="kernel", schedule=schedule, plan=plan,
                io_dtype=dtype_name(x.dtype), n=n, ops=ev.ops,
                plain_ops=_plain_ops(x.reshape(-1, n)[:8], plan), launches=ev.launches,
                qw_calls=ev.qw_calls, shim_calls=ev.shim_calls, rotations=counts,
                rotations_lost=lost, expected_rotations=per_row, geometry=geo,
                same_as_uninstrumented=bool(torch.equal(_bits(y0), _bits(y1))),
                smem=smem, ptx_entry=entry, ptx_events=events)


def kernel_sites(config: str, schedule: str = "rotate_once", *, abft: bool = False,
                 weights=None, device="cuda", seed: int = 0) -> List[Site]:
    """The fused quant_dot sites of ``config`` under ``schedule``: the dense
    down projection (``QuantDotSpec.bind``, ``ROWS`` rows) and, for a MoE
    config, the expert one (``bind_experts`` over every expert, a decode
    step's ``EXPERT_BATCH`` x E x 1 rows; not under revisit, which the
    expert grid does not have), at ``site_dims`` in the config's
    ``SITE_MODES`` mode, bf16 activations. ``abft=True`` runs the
    checksum-verified twins instead. ``weights``: ``site_weights``' pair,
    drawn here when None. Empty when d_ff is not a power of 2."""
    from repro_torch.core.api import QuantDotSpec

    if torch.device(device).type != "cuda":
        raise ValueError("kernel sites run on the card: their rules read the kernels")
    dims = site_dims(config)
    if dims is None:
        return []
    n, d, E = dims
    mode = SITE_MODES[_cfg(config).name]
    dense, stack = weights if weights is not None else site_weights(config, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    spec = QuantDotSpec(n=n, mode=mode, schedule=schedule, abft=abft)
    tag = f"{config}/{schedule}" + ("/abft" if abft else "")
    x = (torch.randn((ROWS, n), generator=gen, device=device) * 3).to(torch.bfloat16)
    plan = spec.plan(x.dtype, "cuda")
    sites = [_kernel_site(f"quant_dot[{tag}]", lambda: spec.bind(dense)(x), x, plan,
                          experts=False, schedule=schedule, abft=abft, mode=mode, m=ROWS,
                          n=n, d=d, E=0, rows=ROWS)]
    if stack is not None and schedule != "revisit":
        xe = (torch.randn((EXPERT_BATCH, E, 1, n), generator=gen, device=device)
              * 3).to(torch.bfloat16)
        sites.append(_kernel_site(
            f"quant_dot_experts[{tag}]", lambda: spec.bind_experts(stack)(xe), xe, plan,
            experts=True, schedule=schedule, abft=abft, mode=mode, m=EXPERT_BATCH, n=n,
            d=d, E=E, rows=EXPERT_BATCH * E))
    return sites


def model_sites(config: str, *, device="cuda", seed: int = 0) -> List[Site]:
    """The bound-spec model forward: the config's dense MLP
    (``apply_mlp``) with its down projection pre-quantized in the config's
    mode as serving stores it, Hadamard rotation, on 2 x 4 tokens. Empty
    when d_ff is not a power of 2 (no fused site)."""
    import dataclasses as dc

    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.wquant import quantize_weight
    from repro_torch.models.mlp import apply_mlp, init_mlp

    if torch.device(device).type != "cuda":
        raise ValueError("model sites run on the card: their rule reads the kernels")
    dims = site_dims(config)
    if dims is None:
        return []
    n, d, _ = dims
    mode = SITE_MODES[_cfg(config).name]
    cfg = dc.replace(_cfg(config), d_model=d, d_ff=n).with_quant(
        QuantConfig(mode=mode, rotate="hadamard"))
    gen = torch.Generator(device=device).manual_seed(seed)
    p = init_mlp(gen, cfg, device)
    p["w_down"] = quantize_weight(p["w_down"], mode)
    x = torch.randn((2, 4, d), generator=gen, device=device).to(torch.bfloat16)
    with torch.inference_mode(), recording() as ev:
        apply_mlp(cfg, p, x)
    torch.cuda.synchronize()
    return [Site(name=f"mlp_down_proj[{config}]", kind="model", io_dtype="bfloat16", n=n,
                 ops=ev.ops, launches=ev.launches, qw_calls=ev.qw_calls,
                 shim_calls=ev.shim_calls)]


def _scaled_engine(config: str, device, seed: int):
    """A small ``ServeEngine`` of ``config`` (the reference's scaled
    serving site): scaled-down widths, the config's mode + Hadamard +
    quantized KV, int8 weight storage, 2 slots of 32 positions."""
    import dataclasses as dc

    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.lm import init_lm
    from repro_torch.serving import ServeEngine

    quant = QuantConfig(mode=SITE_MODES[_cfg(config).name], rotate="hadamard",
                        kv_quant=True)
    cfg = dc.replace(_cfg(config).scaled_down().with_quant(quant), weight_quant="int8")
    params = init_lm(cfg, seed=seed, device=device)
    engine = ServeEngine(cfg, params, num_slots=2, max_len=32, prefill_len=8,
                         device=device)
    engine.warmup()
    return engine


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serving_sites(config: str, *, engine=None, device="cuda",
                  seed: int = 0) -> List[Site]:
    """One decode step and one prefill-insert of a real ``ServeEngine``:
    ``engine`` (already warm, e.g. one that just served) or a scaled one
    built here. Each records its aten ops, launches and ``quantize_weight``
    calls, and each cache leaf's pointer, shape and dtype before and after.
    The decode step writes each slot's row at its position and the insert
    writes slot 0's first rows, as the engine's own warm-up does."""
    from repro_torch.serving.cache import insert_kv

    if engine is None:
        engine = _scaled_engine(config, device, seed)
    dev = engine.device
    leaves = tuple((s, dt) for _, s, dt, _ in cache_snapshot(engine.caches))
    io = dtype_name(getattr(torch, engine.cfg.dtype))
    rung = engine._rung

    before = cache_snapshot(engine.caches)
    with recording() as ev:
        engine._decode()
    _sync(dev)
    decode = Site(name=f"serve_decode[{config}/rung{rung}]", kind="serving", io_dtype=io,
                  ops=ev.ops, launches=ev.launches, qw_calls=ev.qw_calls,
                  shim_calls=ev.shim_calls, decode=True, cache_leaves=leaves,
                  cache_before=before, cache_after=cache_snapshot(engine.caches))

    before = cache_snapshot(engine.caches)
    with recording() as ev:
        out = engine._prefill(np.zeros((1, engine.prefill_len), np.int64), 1)
        with torch.inference_mode():
            insert_kv(engine.caches, out[-1], 0)
    _sync(dev)
    insert = Site(name=f"serve_insert[{config}]", kind="serving", io_dtype=io, ops=ev.ops,
                  launches=ev.launches, qw_calls=ev.qw_calls, shim_calls=ev.shim_calls,
                  cache_leaves=leaves, cache_before=before,
                  cache_after=cache_snapshot(engine.caches))
    return [decode, insert]


def default_sites(config: str, schedules=("rotate_once",), *, serving: bool = True,
                  abft: bool = False, device="cuda",
                  seed: int = 0) -> List[Site]:
    """Every lint site of one config: its kernel sites under each schedule
    (``abft``: their verified twins too; one draw of the weights for all),
    the model site and, with ``serving``, the serving sites of a scaled
    engine. On the CPU only the serving sites exist (the others read the
    kernels)."""
    if torch.device(device).type != "cuda":
        return serving_sites(config, device=device, seed=seed) if serving else []
    weights = None
    if site_dims(config) is not None:
        weights = site_weights(config, device, seed)
    sites = []
    for schedule in schedules:
        for verified in (False, True) if abft else (False,):
            sites += kernel_sites(config, schedule, abft=verified, weights=weights,
                                  device=device, seed=seed)
    del weights
    sites += model_sites(config, device=device, seed=seed)
    if serving:
        sites += serving_sites(config, device=device, seed=seed)
    return sites
