"""Build-time reader of the PTX that ``nvcc -ptx`` emits for the quant_dot
kernels: the event order the ``dma-safety`` rule reads, as
``repro.analysis.jaxpr_utils.stream_events`` gives the reference's.

A race can still give the right answer, so the rule reads code, not
outputs. It reads PTX, in program order, and not SASS: ptxas schedules
SASS instructions around each other, while PTX keeps the order of the
source, with the ``asm volatile`` copies and waits where the source put
them. Each ``.entry`` is one template instantiation; its mangled name
carries the template arguments (``Instantiation``), so the rule checks the
exact instantiation the dispatcher launches. The shared body is inlined
into every entry, so an entry's lines hold the whole kernel.

Events, one per instruction of interest: ``copy`` (``cp.async`` into shared
memory), ``commit`` (``cp.async.commit_group``), ``wait N``
(``cp.async.wait_group N``; ``cp.async.wait_all`` is ``wait 0``),
``ld_shared`` (any ``ld`` from shared memory), ``barrier`` (a block or
cluster barrier that blocks: ``bar.sync``, ``barrier.sync``, ``bar.red``,
``barrier.cluster.wait``) and ``ret``.

``contraction_counts`` counts, per entry, the instructions that say where
the contraction runs: ``mma.sync`` (the tensor cores) and ``dp4a`` (CUDA
cores). Every quant_dot instantiation contracts through ``mma.sync`` and
has no ``dp4a``; ``chip_smoke.py``'s lint phase prints and checks the
counts of every entry of the built sources.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Instantiation", "Event", "entries", "events_of", "parse_name",
           "TRANSFORM_KERNELS", "parse_transform_name", "dma_findings",
           "contraction_counts"]

_ENTRY = re.compile(r"^\s*(?:\.visible\s+|\.weak\s+)?\.entry\s+([\w$.]+)")
_KERNEL = re.compile(r"(quant_dot(?:_experts)?_kernel)I(13__nv_bfloat16|6__half|f)"
                     r"Li(\d+)E((?:Lb[01]E)+)E")
_IO = {"13__nv_bfloat16": "bfloat16", "6__half": "float16", "f": "float32"}
_PRED = re.compile(r"^@!?%\w+\s+")
_WAIT = re.compile(r"^cp\.async\.wait_group\s+(\d+)")
_LD_SHARED = re.compile(r"^ld(?:\.\w+)*\.shared\b")
_CONTRACTIONS = {"mma": re.compile(r"^mma\.sync\."), "dp4a": re.compile(r"^dp4a\.")}
_BARRIER = re.compile(r"^(?:(?:bar|barrier)(?:\.cta)?\.(?:sync|red)\b|barrier\.cluster\.wait\b)")


@dataclasses.dataclass(frozen=True)
class Instantiation:
    """The template arguments of one quant_dot kernel entry: ``kernel``
    (``quant_dot_kernel`` or ``quant_dot_experts_kernel``), ``io`` the
    activation dtype, ``bm`` rows per block, then the bool flags kInt,
    kStreamed, kAbft and (dense only) kRevisit."""

    kernel: str
    io: str
    bm: int
    is_int: bool
    streamed: bool
    abft: bool
    revisit: bool = False


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str          # copy | commit | wait | ld_shared | barrier | ret
    line: int          # line number in the PTX
    arg: int = -1      # wait: the group count N

    def __str__(self) -> str:
        return f"{self.kind}{'' if self.arg < 0 else ' ' + str(self.arg)}@{self.line}"


def parse_name(name: str) -> Optional[Instantiation]:
    """The instantiation a mangled entry name encodes, or None."""
    m = _KERNEL.search(name)
    if m is None:
        return None
    flags = [f == "Lb1E" for f in re.findall(r"Lb[01]E", m.group(4))]
    if len(flags) < 3:
        return None
    return Instantiation(m.group(1), _IO[m.group(2)], int(m.group(3)), *flags[:4])


# The transform kernels' entries (hadacore.cu, fused_quant.cu): the
# tensor-core bodies are templated on (io dtype, compute dtype), the
# CUDA-core ones on the io dtype alone.
TRANSFORM_KERNELS = ("hadacore_tc_kernel", "fwht_kernel", "fused_dequant_tc_kernel",
                     "fused_tc_kernel", "fused_dequant_kernel", "fused_kernel")
_DT = "f|13__nv_bfloat16|6__half"


def parse_transform_name(name: str) -> Optional[Tuple[str, str, Optional[str]]]:
    """(kernel, io dtype, compute dtype) of a mangled transform kernel
    entry, or None for another entry. The compute dtype is None where it is
    no template argument (the CUDA-core bodies), the io dtype where the
    mangling repeats it (``S_``). The length prefix tells ``fused_kernel``
    from the end of ``fused_dequant_kernel``."""
    for kernel in TRANSFORM_KERNELS:
        m = re.search(rf"{len(kernel)}{kernel}I({_DT})({_DT}|S\d*_)?E", name)
        if m is not None:
            io, cd = _IO[m.group(1)], m.group(2)
            return kernel, io, (None if cd is None else io if cd.startswith("S")
                                else _IO[cd])
    return None


def _classify(instr: str) -> Optional[Tuple[str, int]]:
    instr = _PRED.sub("", instr.strip())
    if instr.startswith("cp.async.commit_group"):
        return "commit", -1
    w = _WAIT.match(instr)
    if w:
        return "wait", int(w.group(1))
    if instr.startswith("cp.async.wait_all"):
        return "wait", 0
    if instr.startswith("cp.async.") and ".shared" in instr:
        return "copy", -1
    if _LD_SHARED.match(instr):
        return "ld_shared", -1
    if _BARRIER.match(instr):
        return "barrier", -1
    if re.match(r"^ret(?:\.uni)?\s*;", instr):
        return "ret", -1
    return None


def entries(text: str) -> Dict[str, List[Event]]:
    """Every ``.entry`` of a PTX text with its events in program order."""
    out: Dict[str, List[Event]] = {}
    name, body, depth = None, None, 0
    for no, raw in enumerate(text.splitlines(), 1):
        line = raw.split("//", 1)[0]
        if name is None:
            m = _ENTRY.match(line)
            if m:
                name, body, depth = m.group(1), [], 0
            continue
        depth += line.count("{") - line.count("}")
        for instr in line.split(";"):
            if instr.strip():
                ev = _classify(instr + ";")
                if ev is not None:
                    body.append(Event(ev[0], no, ev[1]))
        if depth <= 0 and "}" in line:
            out[name] = body
            name = None
    return out


def events_of(text: str) -> Dict[Instantiation, Tuple[str, List[Event]]]:
    """The quant_dot entries of a PTX text by instantiation: (mangled name,
    events)."""
    out = {}
    for name, evs in entries(text).items():
        inst = parse_name(name)
        if inst is not None:
            out[inst] = (name, evs)
    return out


def dma_findings(events: Iterable[Event]) -> List[str]:
    """What breaks the streamed ring's contract in one entry's events (empty
    when it holds): cp.async is issued at all; some wait exists; after every
    commit_group, a wait_group comes before the next ld.shared of the same
    phase (a blocking barrier ends the phase: the warm-up copies fly across
    the rotation phase, whose shared reads are of the work area, and the
    contraction's first wait settles them); and a wait_group 0 comes after
    the last commit before every ret (the ring drains)."""
    evs = list(events)
    kinds = [e.kind for e in evs]
    if "copy" not in kinds:
        return ["no cp.async is issued: the streamed ring is gone"]
    out = []
    if "wait" not in kinds:
        out.append(f"{kinds.count('commit')} cp.async.commit_group(s) and no "
                   "cp.async.wait_group: no copy is ever waited on")
    for i, e in enumerate(evs):
        if e.kind != "commit":
            continue
        for f in evs[i + 1:]:
            if f.kind in ("wait", "barrier", "ret"):
                break
            if f.kind == "ld_shared":
                out.append(f"commit_group at PTX line {e.line} is followed by "
                           f"ld.shared at line {f.line} with no wait_group between: "
                           "the ring is read while its copies may be in flight")
                break
    last_commit, drained = None, True
    for e in evs:
        if e.kind == "commit":
            last_commit, drained = e, False
        elif e.kind == "wait" and e.arg == 0:
            drained = True
        elif e.kind == "ret" and not drained:
            out.append(f"ret at PTX line {e.line} with no cp.async.wait_group 0 after "
                       f"the commit_group at line {last_commit.line}: copies may still "
                       "be in flight when the block ends (the ring does not drain)")
    return out


def contraction_counts(text: str) -> Dict[str, Dict[str, int]]:
    """Per ``.entry`` of a PTX text (by mangled name), the count of its
    ``mma.sync`` and ``dp4a`` instructions (predicated ones included)."""
    out: Dict[str, Dict[str, int]] = {}
    name, depth = None, 0
    for raw in text.splitlines():
        line = raw.split("//", 1)[0]
        if name is None:
            m = _ENTRY.match(line)
            if m:
                name, depth = m.group(1), 0
                out[name] = {k: 0 for k in _CONTRACTIONS}
            continue
        depth += line.count("{") - line.count("}")
        for instr in line.split(";"):
            instr = _PRED.sub("", instr.strip())
            for key, pat in _CONTRACTIONS.items():
                if pat.match(instr):
                    out[name][key] += 1
        if depth <= 0 and "}" in line:
            name = None
    return out
