"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``repro_torch/csrc/*.cu`` source compiles, with ``nvcc`` alone, into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). The sources build in parallel, one ``nvcc`` each.
Libraries land in ``repro_torch/_build/`` (listed in ``.gitignore``) under
a name that hashes the sources and flags, so an edited kernel never loads
a stale library; a finished library is moved into place atomically, so
two processes building at once do not see a half-written file.

The kernel-contract linter (``repro_torch.analysis``) needs more builds,
its ``LINT_TARGETS``, which ``build_all(lint=True)`` starts beside the
main ones: the four quant_dot sources again with
``-DREPRO_COUNT_ROTATIONS`` (a per-row rotation counter; each a library of
its own name and hash, which only the linter loads), the two mutants of
``csrc/mutants/`` (not picked up by ``sources()``, whose glob does not
recurse, so no dispatch reaches them), and the PTX of the streamed
kernels' sources and of the M2 mutant (``nvcc -ptx`` with the same
front-end flags), for the DMA rule, and of K1 / K2 / K3's sources, for
the check that their 16-bit rotation runs on the tensor cores.

Nothing here runs at import time: the tests import every module on
machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# sm_90a: Hopper with its architecture-specific instructions. Not
# --use_fast_math: the kernels rely on IEEE division and rounding.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

# PTX: the same front end (NVVM) and its flags, without ptxas or linking
PTX_FLAGS = ("-arch=compute_90a", "-std=c++17", "-O3", "--fmad=false", "-ptx")
COUNT_DEFINE = "REPRO_COUNT_ROTATIONS"
STAMP_DEFINE = "REPRO_STAMP_PHASES"   # fused_quant.cu's phase-stamping build
QUANT_DOT_SOURCES = ("quant_dot", "quant_dot_abft", "quant_dot_experts",
                     "quant_dot_experts_abft")
MUTANTS = ("unguarded_rotate", "dangling_dma")

_LIBS: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class Target:
    """One nvcc job: ``source`` relative to ``csrc/`` (``mutants/x.cu``),
    ``defines`` passed as ``-D``, a shared library or (``ptx``) PTX."""

    source: str
    defines: Tuple[str, ...] = ()
    ptx: bool = False

    @property
    def name(self) -> str:
        stem = self.source[:-3].replace("/", "_")
        tag = "".join(".count" if d == COUNT_DEFINE else "." + d.lower()
                      for d in self.defines)
        return stem + tag if self.ptx else f"lib{stem}{tag}"

    def flags(self) -> Tuple[str, ...]:
        return (PTX_FLAGS if self.ptx else NVCC_FLAGS) + tuple(
            f"-D{d}" for d in self.defines)

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(self.flags()).encode())
        for p in sorted(CSRC.glob("*.cuh")) + [CSRC / self.source]:
            h.update(p.read_bytes())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:12]}.{'ptx' if self.ptx else 'so'}"


def counting(stem: str) -> Target:
    """The rotation-counting build of ``csrc/<stem>.cu``."""
    return Target(f"{stem}.cu", (COUNT_DEFINE,))


def mutant(name: str) -> Target:
    """The library of ``csrc/mutants/<name>.cu``, with the counter."""
    return Target(f"mutants/{name}.cu", (COUNT_DEFINE,))


def ptx(source: str) -> Target:
    """The PTX of ``csrc/<source>`` as the library's build compiles it."""
    return Target(source, ptx=True)


# the sources of K1, K2 and K3, whose PTX shows their 16-bit rotation on
# the tensor cores (chip_smoke.py's tensor-core check)
TRANSFORM_SOURCES = ("hadacore", "fused_quant")

LINT_TARGETS = (tuple(counting(s) for s in QUANT_DOT_SOURCES)
                + tuple(mutant(m) for m in MUTANTS)
                + tuple(ptx(f"{s}.cu") for s in QUANT_DOT_SOURCES)  # each has a streamed kernel
                + (ptx("mutants/dangling_dma.cu"),)
                + tuple(ptx(f"{s}.cu") for s in TRANSFORM_SOURCES))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources() -> Tuple[str, ...]:
    """Stems of the kernel sources, e.g. ('fused_quant', 'hadacore')."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def _start(target: Target):
    out = target.path()
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    cmd = [_nvcc(), *target.flags(), "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / target.source)]
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log


def build(targets) -> Dict[str, float]:
    """Compile every target that has no current output, all at once.
    Returns the wall seconds spent per target name (0.0 when already
    built); raises with the compiler's output when a build fails, after
    every job has ended."""
    t0 = time.perf_counter()
    jobs = {t.name: _start(t) for t in targets}
    spent, failed = {}, []
    for name, job in jobs.items():
        if job is None:
            spent[name] = 0.0
            continue
        proc, tmp, out, log = job
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"nvcc failed for {name} (exit {rc}):\n"
                          + out.with_suffix(".log").read_text())
            continue
        os.replace(tmp, out)
        spent[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return spent


def build_all(lint: bool = False) -> Dict[str, float]:
    """Compile every source that has no current library (with ``lint``
    also the ``LINT_TARGETS``), all at once. Returns the wall seconds spent
    per target (0.0 when already built); raises with the compiler's output
    when a build fails."""
    targets = [Target(f"{stem}.cu") for stem in sources()]
    return build(targets + (list(LINT_TARGETS) if lint else []))


def load_target(target: Target) -> ctypes.CDLL:
    """The loaded library of ``target``, building it first if needed."""
    lib = _LIBS.get(target.name)
    if lib is None:
        path = target.path()
        if not path.exists():
            build([target])
        lib = ctypes.CDLL(str(path))
        _LIBS[target.name] = lib
    return lib


def load(stem: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<stem>.cu``, building every main
    source first if it is not built. Called on every launch: a loaded
    library is returned without hashing the sources again."""
    target = Target(f"{stem}.cu")
    lib = _LIBS.get(target.name)
    if lib is not None:
        return lib
    if not target.path().exists():
        build_all()
    return load_target(target)


def ptx_text(source: str) -> str:
    """The PTX of ``csrc/<source>`` (built first if needed)."""
    target = ptx(source)
    if not target.path().exists():
        build([target])
    return target.path().read_text()
