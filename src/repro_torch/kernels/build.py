"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``repro_torch/csrc/*.cu`` source compiles, with ``nvcc`` alone, into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). The sources build in parallel, one ``nvcc`` each.
Libraries land in ``repro_torch/_build/`` (listed in ``.gitignore``) under
a name that hashes the sources and flags, so an edited kernel never loads
a stale library; a finished library is moved into place atomically, so
two processes building at once do not see a half-written file.

Nothing here runs at import time: the tests import every module on
machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
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

_LIBS: Dict[str, ctypes.CDLL] = {}


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


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:12]}.so"


def _start(stem: str):
    out = _lib_path(stem)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{stem}.cu")]
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log


def build_all() -> Dict[str, float]:
    """Compile every source that has no current library, all at once.
    Returns the wall seconds spent per stem (0.0 when already built);
    raises with the compiler's output when a build fails."""
    t0 = time.perf_counter()
    jobs = {stem: _start(stem) for stem in sources()}
    spent = {}
    for stem, job in jobs.items():
        if job is None:
            spent[stem] = 0.0
            continue
        proc, tmp, out, log = job
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {stem}.cu (exit {rc}):\n"
                               + out.with_suffix(".log").read_text())
        os.replace(tmp, out)
        spent[stem] = time.perf_counter() - t0
    return spent


def load(stem: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<stem>.cu``, building it first if
    needed."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = _lib_path(stem)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[stem] = lib
    return lib
