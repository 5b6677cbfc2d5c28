"""The kernel-contract rules of the port (twin of
``repro.analysis.rules``: the same seven names, the same registry).

Each rule is a class decorated with :func:`register_rule`; ``applies(site)``
keys off the evidence the :class:`~.sites.Site` carries, ``check(site)``
returns the violations, and :func:`run_rules` drives every registered rule
over every site into a :class:`~.report.Report`.

What each rule proves, from the port's evidence (``dispatch_trace``,
``ptx``) in place of the reference's jaxpr and HLO:

* ``fusion-contract``    -- a kernel or model site on the card is ONE fused
  kernel launch (one wrapper's ``.launches`` + 1) with no aten contraction
  doing its work (a kernel site runs none at all; a model site none over
  the fused width), and serving never calls ``quantize_weight``.
* ``rotate-once-contract`` -- each row is rotated as often as the launch
  geometry allows and no more (per-row counters of the counting build).
* ``dma-safety``         -- in the PTX of a streamed instantiation every
  ``cp.async`` group is waited on before the ring is read, and the ring
  drains before the block ends.
* ``dtype-flow``         -- decode never builds a cache-shaped tensor wider
  than the io dtype, and a 16-bit plan's plain transform multiplies 16-bit
  operands.
* ``smem-budget``        -- the shared memory the size rule charges, the
  launch requests and the built kernel takes agree and fit the card (the
  reference's ``vmem-budget``).
* ``donation``           -- the KV cache is updated in place: every leaf
  keeps its pointer, and no decode op makes a fresh cache-shaped copy.
* ``deprecated-shim-in-trace`` -- no site calls the deprecated shims.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from repro_torch.analysis import ptx
from repro_torch.analysis.dispatch_trace import CONTRACTIONS, FUSED_WRAPPERS, itemsize
from repro_torch.analysis.report import Report, Violation
from repro_torch.analysis.sites import Site

__all__ = ["Rule", "register_rule", "all_rules", "run_rules", "CARD_RULES"]

_RULES: Dict[str, "Rule"] = {}

# rules whose evidence only the card and nvcc give (launch counters of the
# kernels, rotation counters, PTX, kernel attributes)
CARD_RULES = frozenset({"fusion-contract", "rotate-once-contract", "dma-safety",
                        "smem-budget"})


def register_rule(cls):
    """Class decorator: instantiate and register (mirrors
    ``kernels.registry.register_backend``)."""
    inst = cls()
    _RULES[inst.name] = inst
    return cls


def all_rules() -> Dict[str, "Rule"]:
    return dict(_RULES)


class Rule:
    """One invariant. ``applies`` gates on the evidence the site carries;
    ``check`` returns Violations (empty == contract holds)."""

    name = "unnamed"

    def applies(self, site: Site) -> bool:
        raise NotImplementedError

    def check(self, site: Site) -> List[Violation]:
        raise NotImplementedError

    def _v(self, site: Site, msg: str) -> Violation:
        return Violation(rule=self.name, site=site.name, message=msg)


def run_rules(sites: Iterable[Site], rules: Optional[Iterable[str]] = None) -> Report:
    """Every (applicable) registered rule over every site."""
    picked = [_RULES[r] for r in rules] if rules is not None else list(_RULES.values())
    rep = Report()
    for site in sites:
        for rule in picked:
            if not rule.applies(site):
                continue
            rep.checked.append((site.name, rule.name))
            rep.violations.extend(rule.check(site))
    return rep


# --------------------------------------------------------------- fusion
@register_rule
class FusionContract(Rule):
    """A kernel or model site on the card adds exactly 1 to exactly one
    fused wrapper's ``.launches`` (none: the site resolved to the plain
    backend, "fell back to the unfused path"; more: rotate / quantize / GEMM
    split across launches). A kernel site runs no aten contraction (``mm``,
    ``bmm``, ``matmul``, ``_int_mm``, ``_scaled_mm``, ``addmm``, ...): its
    contraction belongs to the kernel, which launches below the dispatcher;
    a model site runs none over the fused width n (its gate and up
    projections contract over d_model). Serving sites make 0
    ``quantize_weight`` calls: serving weights are pre-quantized."""

    name = "fusion-contract"

    def applies(self, site: Site) -> bool:
        return site.kind in ("kernel", "model", "serving")

    def check(self, site: Site) -> List[Violation]:
        out = []
        if site.kind in ("kernel", "model"):
            fused = {k: v for k, v in site.launches.items() if k in FUSED_WRAPPERS}
            if sum(fused.values()) != 1 or len(fused) != 1:
                out.append(self._v(
                    site, f"expected exactly 1 fused kernel launch, got {fused or 'none'} "
                    "(the site resolved to the plain path, or its rotate / quantize / "
                    "GEMM split across launches)"))
            dots = [op for op in site.ops if op.name in CONTRACTIONS]
            if site.kind == "model":
                dots = [op for op in dots if op.inputs and op.inputs[0][0]
                        and op.inputs[0][0][-1] == site.n]
            if dots:
                out.append(self._v(
                    site, f"{len(dots)} aten contraction(s) "
                    f"({', '.join(sorted({op.name for op in dots}))}) outside the fused "
                    "kernel -- contraction work escaped it"))
        if site.kind == "serving" and site.qw_calls:
            out.append(self._v(
                site, f"{site.qw_calls} quantize_weight call(s) in a serving step -- "
                "serving weights must be pre-quantized QTensors, never re-quantized "
                "per step"))
        return out


# ---------------------------------------------------------- rotate-once
@register_rule
class RotateOnceContract(Rule):
    """Each row of a fused site is rotated exactly as often as its launch
    geometry (``quant_dot.launch_grid``) requires, read from the per-row
    counters of the counting build (``-DREPRO_COUNT_ROTATIONS``, whose
    output must be bitwise the main build's):

    * rotate-once and streamed (K4, K5, K7a-ro, K7a-s, K6, K6s, K7b, K7b-s):
      once per thread-block cluster covering the row block, so splits /
      cluster times. The port rotates once per cluster, not once per row
      block (``csrc/quant_dot.cuh``, "Revisit schedule" and "Launch");
    * revisit (K8, K7a-rv): once per ``block_n`` column tile, the splits
      (no cluster).

    A row rotated more often (M1: before every 32-column tile) or less
    often, or rotated where the counters cannot see it, breaks it."""

    name = "rotate-once-contract"

    def applies(self, site: Site) -> bool:
        return site.kind == "kernel" and site.rotations is not None

    def check(self, site: Site) -> List[Violation]:
        out = []
        counts = site.rotations
        want = site.expected_rotations
        if site.rotations_lost:
            out.append(self._v(site, f"{site.rotations_lost} rotation(s) of rows past "
                               "the counter array: the counts are incomplete"))
        if len(counts) == 0 or (counts != want).any():
            lo = int(counts.min()) if len(counts) else 0
            hi = int(counts.max()) if len(counts) else 0
            bad = int((counts != want).sum())
            out.append(self._v(
                site, f"rows rotated {lo}..{hi} times, expected {want} per row from the "
                f"launch geometry {site.geometry} ({bad} of {len(counts)} rows off) -- "
                "an unguarded rotation re-transforms the row block for every tile"))
        if site.same_as_uninstrumented is False:
            out.append(self._v(site, "the counting build's output differs from the main "
                               "build's: the counter changed the kernel"))
        return out


# ----------------------------------------------------------- DMA safety
@register_rule
class DmaSafety(Rule):
    """The streamed ring, from the PTX of the exact instantiation the
    dispatcher launches (``ptx.dma_findings``): ``cp.async`` is issued at
    all; every ``cp.async.commit_group`` is followed by a
    ``cp.async.wait_group`` before the next ``ld.shared`` (the reference's
    "no start without a wait"); a ``cp.async.wait_group 0`` comes before
    ``ret`` ("the ring drains"). It never reads outputs: a race can still
    give the right answer."""

    name = "dma-safety"

    def applies(self, site: Site) -> bool:
        return site.kind == "kernel" and site.schedule == "streamed"

    def check(self, site: Site) -> List[Violation]:
        if site.ptx_events is None:
            return [self._v(site, "no PTX of the streamed instantiation was read")]
        return [self._v(site, f"{msg} ({site.ptx_entry})")
                for msg in ptx.dma_findings(site.ptx_events)]


# ----------------------------------------------------------- dtype flow
@register_rule
class DtypeFlow(Rule):
    """No op of a serving decode step outputs a tensor shaped like a KV
    cache leaf in a float dtype wider than the io dtype (an f32 copy of the
    cache per layer and step). For a plan that computes in 16 bits, the
    plain transform's passes compute in 16 bits: each pass matmul takes the
    compute dtype's values (16-bit operands, or f32 copies widened exactly
    from 16-bit tensors) and each pass result is rounded back to 16 bits
    before anything reads it again -- no silent f32 pass compute. This half
    applies to the plain version only: the CUDA K1 sums in f32 butterflies
    by design (PERF.md). The plain version widens its operands, on the card
    too, because a 16-bit product with an f32 result runs on tensor cores
    whose accumulator is not IEEE f32 (PERF.md)."""

    name = "dtype-flow"

    def applies(self, site: Site) -> bool:
        return ((site.kind == "serving" and site.decode and bool(site.cache_leaves))
                or (site.kind == "kernel" and bool(site.plain_ops)
                    and site.plan is not None))

    def check(self, site: Site) -> List[Violation]:
        out = []
        if site.kind == "serving":
            shapes = {tuple(s) for s, _ in site.cache_leaves}
            io = itemsize(site.io_dtype)
            seen = set()
            for op in site.ops:
                for shape, dt, _ in op.outputs:
                    if (shape in shapes and dt.startswith(("float", "bfloat"))
                            and itemsize(dt) > io and (op.name, shape, dt) not in seen):
                        seen.add((op.name, shape, dt))
                        out.append(self._v(
                            site, f"cache-shaped {shape} tensor made as {dt} (wider than "
                            f"the io dtype {site.io_dtype}) by aten.{op.name} -- a widened "
                            "copy of the cache in the decode step"))
        if site.kind == "kernel" and itemsize(str(site.plan.compute_dtype)) == 2:
            out += [self._v(site, msg) for msg in _pass_flow(site.plain_ops,
                                                             site.plan.compute_dtype)]
        return out


_COPIES = frozenset({"_to_copy", "to", "copy_", "copy"})


def _pass_flow(ops, compute_dtype: str) -> List[str]:
    """What breaks 16-bit pass compute in a recorded plain transform: a
    pass matmul operand wider than 16 bits that is not an exact widening of
    a 16-bit tensor, or a wide pass result never rounded back to 16 bits."""
    made, unrounded, bad = {}, {}, []
    for op in ops:
        if op.name in _COPIES and op.inputs and op.outputs:
            src, out = op.inputs[0], op.outputs[0]
            if src[2] in unrounded and itemsize(out[1]) == 2:
                del unrounded[src[2]]
        if op.name in CONTRACTIONS:
            for shape, dt, st in op.inputs[:2]:
                prod = made.get(st)
                widened = (prod is not None and prod.name in _COPIES and prod.inputs
                           and itemsize(prod.inputs[0][1]) == 2)
                if itemsize(dt) > 2 and not widened:
                    bad.append(f"a pass matmul takes a {dt} {shape} operand that is not the "
                               f"{compute_dtype} values widened -- silent f32 pass compute")
            for shape, dt, st in op.outputs:
                if itemsize(dt) > 2:
                    unrounded[st] = shape
        for desc in op.outputs:
            made[desc[2]] = op
    bad += [f"a pass result {shape} is never rounded to {compute_dtype} -- the next pass "
            "reads f32: silent f32 pass compute" for shape in unrounded.values()]
    return bad


# ---------------------------------------------------------- smem budget
@register_rule
class SmemBudget(Rule):
    """Three readings of one built instantiation agree: the bytes the size
    rule charges (``quant_dot._smem_bytes``, behind ``kernel_fits``), the
    dynamic shared memory the launch requests (``launch_grid``, the
    launcher's own layout), and ``cudaFuncGetAttributes`` of the kernel
    that ran (its largest dynamic size, as the launch set it; static plus
    dynamic). All stay within the card's per-block opt-in limit
    (``shared_memory_per_block_optin``). A layout change the size rule
    does not know about fails here before it fails a launch."""

    name = "smem-budget"

    def applies(self, site: Site) -> bool:
        return site.kind == "kernel" and bool(site.smem)

    def check(self, site: Site) -> List[Violation]:
        s = site.smem
        out = []
        if not s.get("fits", True):
            out.append(self._v(site, "kernel_fits says the kernel cannot take this size"))
        if s["planned"] != s["requested"]:
            out.append(self._v(site, f"the size rule charges {s['planned']} B but the "
                               f"launch requests {s['requested']} B"))
        for lib, a in s.items():
            if not isinstance(a, dict):
                continue
            if a["max_dynamic_smem"] != s["requested"]:
                out.append(self._v(site, f"{lib} build: the kernel takes "
                                   f"{a['max_dynamic_smem']} B dynamic, the launch "
                                   f"requested {s['requested']} B"))
            total = a["static_smem"] + a["max_dynamic_smem"]
            if total > s["optin"]:
                out.append(self._v(site, f"{lib} build: static + dynamic shared memory "
                                   f"{total} B exceeds the card's {s['optin']} B"))
        if max(s["planned"], s["requested"]) > s["optin"]:
            out.append(self._v(site, f"charged {s['planned']} B, over the card's "
                               f"{s['optin']} B per block"))
        return out


# ------------------------------------------------------------- donation
@register_rule
class Donation(Rule):
    """The KV cache is updated in place (the port's counterpart of donated
    buffers): every cache leaf keeps its ``data_ptr``, shape and dtype
    across a decode step and a prefill-insert, and no op of a decode step
    outputs a fresh tensor (outside the cache's storage) of a leaf's shape
    and dtype -- a defensive copy of the cache."""

    name = "donation"

    def applies(self, site: Site) -> bool:
        return site.kind == "serving" and bool(site.cache_leaves)

    def check(self, site: Site) -> List[Violation]:
        out = []
        before = [(p, s, d) for p, s, d, _ in site.cache_before]
        after = [(p, s, d) for p, s, d, _ in site.cache_after]
        moved = sum(1 for a, b in zip(before, after) if a != b)
        if moved or len(before) != len(after):
            out.append(self._v(
                site, f"{moved} of {len(before)} cache leaves changed pointer, shape or "
                "dtype -- a fresh cache allocation instead of an in-place update"))
        if site.decode:
            leaves = {(tuple(s), d) for s, d in site.cache_leaves}
            storage = {st for *_, st in site.cache_before}
            fresh = [op for op in site.ops for shape, dt, st in op.outputs
                     if (shape, dt) in leaves and st not in storage]
            if fresh:
                out.append(self._v(
                    site, f"{len(fresh)} op(s) ({', '.join(sorted({o.name for o in fresh}))}) "
                    "made a fresh tensor of a cache leaf's shape and dtype -- a defensive "
                    "copy of the cache in the decode step"))
        return out


# ----------------------------------------------------- deprecated shims
@register_rule
class DeprecatedShim(Rule):
    """No lint site calls the deprecated ``kernels.ops.hadamard`` /
    ``kernels.fused_quant.fused_hadamard_quantize`` shims (their
    ``TRACE_COUNTS`` ticks): new code that imports them fails the lint
    instead of warning once at run time."""

    name = "deprecated-shim-in-trace"

    def applies(self, site: Site) -> bool:
        return bool(site.shim_calls)

    def check(self, site: Site) -> List[Violation]:
        return [self._v(site, f"deprecated shim {shim} called {n}x -- route through "
                        "the plan API (core.api.hadamard / RotationSpec) instead")
                for shim, n in sorted(site.shim_calls.items()) if n]
