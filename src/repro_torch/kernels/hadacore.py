"""K1, the HadaCore Walsh-Hadamard transform: the CUDA kernel's wrapper,
its plain PyTorch version, and the direct ``hadacore`` entry point (twin
of ``repro.kernels.hadacore`` and of the ``_pallas_transform`` launcher in
``repro.kernels.registry``).

The kernel (``repro_torch/csrc/hadacore.cu``) replaces the TPU kernel
``repro/kernels/registry.py::_hadacore_kernel``. On an H100 it is bound by
bytes (one read and one write of each element); it keeps each row in
shared memory across the plan's passes so HBM sees nothing else. A 16-bit
compute dtype runs on the tensor cores (``csrc/hadacore_tc.cuh``: one
mma.sync stage per pass, laid out by ``tc_passes`` here), f32 compute on
the CUDA-core FWHT, which ``fwht_cuda`` also launches for any plan as the
in-repo baseline.

``transform`` is what the ``cuda`` backend calls: a CPU tensor goes to the
plain version (``transform_plain``, the reference's ``_xla_transform``
math), a CUDA tensor to the kernel. ``hadacore_cuda.launches`` and
``fwht_cuda.launches`` count the kernels' launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hadamard import _apply_passes, torch_dtype
from repro_torch.kernels.ref import is_pow2
from repro_torch.kernels.registry import MAX_KERNEL_SIZE, _rows

__all__ = ["hadacore", "hadacore_cuda", "fwht_cuda", "transform", "transform_plain",
           "tc_stages", "tc_passes", "tc_launch", "plan_passes", "Stage", "TcPass",
           "MAX_KERNEL_SIZE", "DTYPE_CODES"]

# io / compute dtype codes of csrc/hadacore.cuh (hadacore::Dtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_PTR = ctypes.c_void_p


_ARGS = [_PTR, _PTR, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float]


def _lib():
    from repro_torch.kernels import build

    lib = build.load("hadacore")
    if lib.hadacore_launch.argtypes is None:
        lib.hadacore_launch.argtypes = _ARGS + [_PTR, _PTR]
        lib.hadacore_launch.restype = ctypes.c_int
        lib.fwht_launch.argtypes = _ARGS + [_PTR]
        lib.fwht_launch.restype = ctypes.c_int
    return lib


def scale_in_compute_dtype(plan) -> float:
    """The scale folded into pass 0 as the plan's base matrices carry it:
    the f32 scale rounded to the compute dtype (for n = 128 or 2048 in
    bf16 that is not exactly 1/sqrt(n))."""
    return _rounded_scale(plan.scale, plan.compute_dtype)


@functools.lru_cache(maxsize=None)
def _rounded_scale(scale: Optional[float], compute_dtype: str) -> float:
    if scale is None:
        return 1.0
    cd = torch_dtype(compute_dtype)
    return float(torch.tensor(np.float32(scale)).to(cd).to(torch.float32))


def check_rows(x2: torch.Tensor, out: torch.Tensor, plan) -> None:
    """What the transform kernels take: contiguous (m, p) CUDA rows of the
    plan's io dtype (f32 / bf16 / fp16), p a power of 2 <= 32768, and an
    output of the same shape, dtype and device."""
    if not (x2.is_cuda and out.is_cuda and x2.device == out.device):
        raise ValueError("kernel inputs must be CUDA tensors on one device")
    if x2.dtype not in DTYPE_CODES or out.dtype != x2.dtype:
        raise ValueError(f"kernel takes f32/bf16/fp16 rows, got {x2.dtype} "
                         f"-> {out.dtype}")
    if x2.ndim != 2 or x2.shape != out.shape or x2.shape[1] != plan.p:
        raise ValueError(f"kernel takes (m, {plan.p}) rows, got "
                         f"{tuple(x2.shape)} -> {tuple(out.shape)}")
    if not (x2.is_contiguous() and out.is_contiguous()):
        raise ValueError("kernel takes contiguous rows")
    if not is_pow2(plan.p) or plan.p > MAX_KERNEL_SIZE:
        raise ValueError(f"kernel takes a power of 2 <= {MAX_KERNEL_SIZE}, "
                         f"got {plan.p}")
    if torch_dtype(plan.dtype) != x2.dtype:
        raise ValueError(f"plan was built for {plan.dtype}, rows are {x2.dtype}")


# ------------------------------------------------ the tensor-core schedule
# K1, K2 and K3 run a plan of 16-bit compute dtype on the tensor cores
# (csrc/hadacore_tc.cuh). Each pass of the reference plan (``plan_passes``)
# is one mma.sync stage, the 16-point factor (or, below 16 points, the
# pass's whole factor) as the constant operand, followed by the pass's
# remaining bits as f32 butterflies across the accumulator fragments a
# thread holds; the values round to the compute dtype only at the end of
# each pass, where the reference rounds. ``tc_passes`` chooses which element
# bits of a row form the mma's k axis, its n axis and the registers, and
# ``tc_launch`` turns that into the kernel's launch; the kernel reads its
# layout from that struct and hard-codes none of it.

@dataclasses.dataclass(frozen=True)
class Stage:
    """One factor of the schedule: ``factor`` points along the element bits
    from ``stride`` (a power of 2) up, on the tensor cores (an mma.sync with
    the factor as its operand, the scale folded in on pass 0) or as f32
    butterflies in registers; ``round_after`` marks the end of a reference
    pass, where every value rounds to the compute dtype."""

    factor: int
    stride: int
    tensor_core: bool
    round_after: bool


@dataclasses.dataclass(frozen=True)
class TcPass:
    """One reference pass as the kernel runs it, in element bits of a block
    of rows (row pitch max(n, 16)): the mma's k axis ``kbits`` (4 bits; the
    operand applies a 2^``fbits``-point factor on them: ``amode`` 0 H_16,
    1 the block diagonal I (x) H_f, 2 H_f in the top-left corner with the
    rest zero, for rows below 16 points), its n axis ``nbits`` (3 bits),
    the register bits ``bbits`` (butterflies) and ``xbits`` (none),
    whether the scale is folded into the operand, and how the fragments
    move (``mode``: SCALAR, K_ROWS, N_ROWS)."""

    kbits: Tuple[int, ...]
    fbits: int
    amode: int
    bbits: Tuple[int, ...]
    xbits: Tuple[int, ...]
    nbits: Tuple[int, ...]
    scaled: bool
    mode: int = 0

    @property
    def rbits(self) -> Tuple[int, ...]:
        return self.bbits + self.xbits


TILE_BITS = 10      # a warp's task: 16 (k) x 8 (n) x up to 8 (registers) values
MAX_WARPS = 8


def _lg(v: int) -> int:
    return v.bit_length() - 1


def pitch(n: int) -> int:
    """Elements between rows in shared memory: rows below 16 points are
    padded with zeros to one mma k axis."""
    return max(n, 16)


def plan_passes(n: int, r: int) -> Tuple[Tuple[int, int], ...]:
    """The reference plan's passes as (lowest element bit, bits): the minor
    factor first (H_n below 128 points, else H_r or, for r = 1, H_128 on
    contiguous 128-chunks), then one 128-point pass per major factor, most
    significant first (``core.hadamard._apply_passes``)."""
    if n < 128:
        return ((0, _lg(n)),)
    first = r if r > 1 else 128
    out = [(0, _lg(first))]
    post = n // 128
    while post >= first:
        out.append((_lg(post), 7))
        post //= 128
    return tuple(out)


def _dep(bits, v):
    """Scatter the bits of v (an int or an int array) to the positions
    ``bits``."""
    out = 0
    for j, b in enumerate(bits):
        out = out + (((v >> j) & 1) << b)
    return out


def phys(e):
    """Shared-memory index of element e: 8 values of padding after every
    128 (additive over disjoint bits)."""
    return e + ((e >> 7) << 3)


def _conflicts(elems: np.ndarray) -> int:
    """Shared-memory wavefronts of one warp access to the 16-bit elements
    ``elems`` in the padded layout (8 elements of padding after every 128):
    the most distinct 32-bit words that fall in one of the 32 banks."""
    words = np.unique(phys(elems) >> 1)
    return int(np.bincount(words % 32).max())


_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3
_J8 = np.arange(8)

# How a pass moves its fragments (TcPass.mode): 16-bit loads and stores of
# single values (0), or ldmatrix / stmatrix of 8 x 8 tiles whose 16-byte
# rows are 8 contiguous values along the k axis (1: its bits 0-2 are the
# element bits 0-2) or along the n axis (2: the n bits are 0-2).
SCALAR, K_ROWS, N_ROWS = 0, 1, 2


def _mode(kbits, nbits) -> int:
    if tuple(kbits[:3]) == (0, 1, 2):
        return K_ROWS
    return N_ROWS if tuple(nbits) == (0, 1, 2) else SCALAR


def _cost(kbits, nbits) -> Tuple[int, int]:
    """(scalar?, wavefronts) of one mma's operand loads and result stores:
    a tile layout (8 rows of 16 bytes per access, one wavefront unless two
    rows share banks) before any scalar one."""
    mode = _mode(kbits, nbits)
    if mode != SCALAR:
        rows = [_dep(nbits, _J8) + h * (1 << kbits[3]) for h in (0, 1)] if mode == K_ROWS \
            else [_dep(kbits, _J8 + 8 * h) for h in (0, 1)]
        return 0, 2 * sum(int(np.bincount((phys(r) >> 3) % 8).max()) for r in rows)
    cost = 0
    for j in (0, 1, 8, 9):
        cost += _conflicts(_dep(kbits, 2 * _T + j) + _dep(nbits, _G))
    for h in (0, 8):
        for c in (0, 1):
            cost += _conflicts(_dep(kbits, _G + h) + _dep(nbits, 2 * _T + c))
    return 1, cost


@functools.lru_cache(maxsize=None)
def tc_passes(n: int, r: int) -> Tuple[TcPass, ...]:
    """The kernel's layout of each pass of the plan (n, r), in the element
    bits of a tile of max(2^TILE_BITS, pitch(n)) values. Chosen here, once:
    tile moves (ldmatrix / stmatrix) where the bits allow, then the fewest
    shared-memory bank conflicts of the fragments' loads and stores;
    register bits stay inside a row, so a thread's values of one n column
    belong to one row (the absmax of K2 and K3 reduces on that)."""
    lg_n, tile = _lg(n), max(TILE_BITS, _lg(pitch(n)))
    out = []
    for i, (lo, w) in enumerate(plan_passes(n, r)):
        own = set(range(lo, lo + w))
        if w >= 4:
            options = [tuple(range(lo, lo + 4)), tuple(range(lo + w - 4, lo + w))]
            amode, fbits = 0, 4
        else:
            options, amode, fbits = [(0, 1, 2, 3)], (2 if n < 16 else 1), w
        best = None
        for kbits in dict.fromkeys(options):
            bbits = tuple(sorted(own - set(kbits)))
            free = [b for b in range(tile) if b not in own and b not in kbits]
            for nbits in itertools.combinations(free, 3):
                cost = _cost(kbits, nbits)
                if best is None or cost < best[0]:
                    xbits = tuple(b for b in free if b not in nbits and b < lg_n)
                    best = (cost, TcPass(kbits, fbits, amode, bbits, xbits[:3 - len(bbits)],
                                         nbits, i == 0, _mode(kbits, nbits)))
        out.append(best[1])
    return tuple(out)


def tc_stages(n: int, r: int) -> Tuple[Stage, ...]:
    """The schedule of the plan (n, r) as factors, in order: per pass an
    mma stage, then the pass's other bits as one butterfly stage; the last
    stage of each pass rounds."""
    out = []
    for p in tc_passes(n, r):
        stride = 1 if p.amode else 1 << p.kbits[0]
        out.append(Stage(1 << p.fbits, stride, True, not p.bbits))
        if p.bbits:
            out.append(Stage(1 << len(p.bbits), 1 << p.bbits[0], False, True))
    return tuple(out)


def tc_rows_per_block(n: int, rows: int) -> int:
    """Rows per block (a power of 2) at the natural pitch: at least a tile
    of 1024 values, up to 4096 values where the rows allow ~264 blocks (two
    per SM of the H100's 132) without; rows of 4096 and more take a block
    each."""
    p = pitch(n)
    lo = max(1, (1 << TILE_BITS) // p)
    hi = max(lo, 4096 // p)
    want = min(max(-(-rows // 264), lo), hi)
    return 1 << (want - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class TcGeometry:
    """A launch's block: rows ``pitch`` values apart in shared memory,
    ``rows_per_block`` of them, ``threads`` threads."""

    pitch: int
    rows_per_block: int
    threads: int


def tc_geometry(n: int, rows: int, epilogue: bool = False) -> TcGeometry:
    """The block for ``rows`` rows: a warp per 1024-value task of a pass,
    between 4 and 8 warps (the loads and stores spread over at least 128
    threads). K2 / K3 (``epilogue``), whose per-value quantize epilogue is
    the longest chain where the grid does not fill the card (fewer than
    ~264 blocks), take 8 warps there; and at most ~264 rows below 1024
    values (decode) one row per block, padded with zero columns to one
    task, so that the rows run on different SMs. The geometry moves no
    value: K1, K2 and K3 rotate bitwise alike (padding columns are zeros
    and never mix with a row's)."""
    rpb = tc_rows_per_block(n, rows)
    if epilogue and n < (1 << TILE_BITS) and rows <= 264:
        return TcGeometry(1 << TILE_BITS, 1, 128)
    if epilogue and -(-rows // rpb) < 264:
        return TcGeometry(pitch(n), rpb, 32 * MAX_WARPS)
    return TcGeometry(pitch(n), rpb, 32 * min(MAX_WARPS, max(4, pitch(n) * rpb >> TILE_BITS)))


class _CPass(ctypes.Structure):
    _fields_ = [("kbits", ctypes.c_int * 4), ("nbits", ctypes.c_int * 3),
                ("fbits", ctypes.c_int), ("amode", ctypes.c_int), ("scaled", ctypes.c_int),
                ("nb", ctypes.c_int), ("nmma", ctypes.c_int), ("ntask", ctypes.c_int),
                ("tmask", ctypes.c_int), ("tstep", ctypes.c_int),
                ("tbase", ctypes.c_int * 8), ("proff", ctypes.c_int * 8),
                ("mode", ctypes.c_int)]


class TcLaunch(ctypes.Structure):
    """csrc/hadacore_tc.cuh's hadacore_tc::Plan: each pass's layout with the
    constants the kernel would otherwise derive bit by bit (the task bits'
    mask, a warp's first task and stride, each register's shared index),
    and the launch (rows per block, threads)."""

    _fields_ = [("npass", ctypes.c_int), ("n", ctypes.c_int),
                ("lg_pitch", ctypes.c_int), ("lg_block", ctypes.c_int),
                ("threads", ctypes.c_int), ("passes", _CPass * 3)]


def task_bits(p: TcPass, lg_block: int) -> Tuple[int, ...]:
    """The element bits of a block of 2^lg_block values that index a
    pass's warp tasks: every bit the pass's k, n and registers leave."""
    used = set(p.kbits) | set(p.nbits) | set(p.rbits)
    return tuple(b for b in range(lg_block) if b not in used)


@functools.lru_cache(maxsize=None)
def tc_launch(n: int, r: int, geom: TcGeometry) -> TcLaunch:
    """The kernel's launch struct for the plan (n, r) on blocks ``geom``."""
    passes = tc_passes(n, r)
    lg_block = _lg(geom.pitch * geom.rows_per_block)
    out = TcLaunch(npass=len(passes), n=n, lg_pitch=_lg(geom.pitch), lg_block=lg_block,
                   threads=geom.threads)
    for i, p in enumerate(passes):
        tbits = task_bits(p, lg_block)
        c = out.passes[i]
        c.kbits[:], c.nbits[:] = p.kbits, p.nbits
        c.fbits, c.amode, c.scaled, c.mode = p.fbits, p.amode, int(p.scaled), p.mode
        c.nb, c.nmma, c.ntask = len(p.bbits), 1 << len(p.rbits), 1 << len(tbits)
        c.tmask, c.tstep = _dep(tbits, -1), _dep(tbits, geom.threads // 32)
        c.tbase[:] = [_dep(tbits, w) for w in range(8)]
        # registers past nmma repeat the real offsets (the kernel's task body
        # runs 8 mmas and stores nmma of them)
        c.proff[:] = [phys(_dep(p.rbits, j % c.nmma)) for j in range(8)]
    return out


def tc_shared_bytes(launch: TcLaunch) -> int:
    """Dynamic shared memory of a block: its values in the compute dtype,
    8 of padding per 128, and one int per row (K2 / K3's absmax)."""
    e = 1 << launch.lg_block
    return 2 * (e + e // 16) + 4 * (e >> launch.lg_pitch)


def tc_launch_arg(m: int, plan, epilogue: bool = False):
    """The tensor-core layout of ``plan`` for m rows, as the kernels'
    ctypes argument; None for f32 compute (the CUDA-core passes)."""
    if plan.compute_dtype == "float32":
        return None
    return ctypes.byref(tc_launch(plan.p, plan.r, tc_geometry(plan.p, m, epilogue)))


def _launch_args(x2: torch.Tensor, plan):
    cd = torch_dtype(plan.compute_dtype)
    return (x2.shape[0], plan.p, plan.r, DTYPE_CODES[x2.dtype], DTYPE_CODES[cd],
            scale_in_compute_dtype(plan))


def hadacore_cuda(x2: torch.Tensor, out: torch.Tensor, plan) -> torch.Tensor:
    """Launch K1 on contiguous (m, p) CUDA rows into ``out`` (which may be
    ``x2`` itself: the in-place form) on the current stream: the
    tensor-core kernel for a 16-bit compute dtype, the CUDA-core FWHT for
    f32 compute (the reference's f32 passes are full f32; TF32 would not
    be)."""
    check_rows(x2, out, plan)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    rc = _lib().hadacore_launch(x2.data_ptr(), out.data_ptr(), *_launch_args(x2, plan),
                                tc_launch_arg(x2.shape[0], plan), stream)
    if rc != 0:
        raise RuntimeError(f"hadacore kernel launch failed: CUDA error {rc}")
    hadacore_cuda.launches += 1
    return out


hadacore_cuda.launches = 0


def fwht_cuda(x2: torch.Tensor, out: torch.Tensor, plan) -> torch.Tensor:
    """Launch the CUDA-core FWHT (K1's first body, kept as the baseline)
    on contiguous (m, p) CUDA rows into ``out`` (``x2`` itself for the
    in-place form): the plan's passes as f32 butterfly stages in shared
    memory, one barrier per stage, any compute dtype. The quant_dot family
    (K4-K8, the ABFT twins) rotates with this routine inside its kernels."""
    check_rows(x2, out, plan)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    rc = _lib().fwht_launch(x2.data_ptr(), out.data_ptr(), *_launch_args(x2, plan),
                            stream)
    if rc != 0:
        raise RuntimeError(f"fwht kernel launch failed: CUDA error {rc}")
    fwht_cuda.launches += 1
    return out


fwht_cuda.launches = 0


def transform_plain(x: torch.Tensor, plan) -> torch.Tensor:
    """K1's plain PyTorch version: cast to the compute dtype, run the
    plan's passes (``core.hadamard._apply_passes``), cast back."""
    cd = torch_dtype(plan.compute_dtype)
    x2, _ = _rows(x.to(cd), plan.p)
    return _apply_passes(x2, plan.p, _plan_mats(plan, x.device)).reshape(
        x.shape).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _plan_mats(plan, device: torch.device):
    """The plan's f32 base matrices on ``device``, copied there once."""
    return [torch.from_numpy(m).to(device) for m in plan.mats]


def transform(x: torch.Tensor, plan, in_place: bool = False) -> torch.Tensor:
    """Rotate the last axis (== plan.p): the plain version for a CPU
    tensor, the kernel for a CUDA tensor. ``in_place`` writes the result
    into ``x`` (contiguous ``x`` only on the card)."""
    if x.device.type == "cpu":
        y = transform_plain(x, plan)
        return x.copy_(y) if in_place else y
    if x.device.type != "cuda":
        raise ValueError(f"hadacore runs on CPU or CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        if in_place:
            raise ValueError("in-place hadacore needs a contiguous tensor")
        x = x.contiguous()
    x2 = x.view(-1, plan.p)
    out = x2 if in_place else torch.empty_like(x2)
    return hadacore_cuda(x2, out, plan).view(x.shape)


def hadacore(x: torch.Tensor, scale: Optional[str] = "ortho", *,
             in_place: bool = False) -> torch.Tensor:
    """HadaCore Walsh-Hadamard transform of the last axis with the kernel
    backend: the CUDA kernel on a CUDA tensor, its plain version on a CPU
    tensor. n must be a power of 2 <= 32768; ``scale`` is "ortho"
    (1/sqrt(n)), None (+-1) or a number; ``in_place`` writes the result
    into ``x`` (the paper's Appendix B). The out-of-place form is
    differentiable (the transform is self-adjoint: its backward is the
    transform); the in-place form refuses a tensor that requires grad
    rather than drop its graph."""
    from repro_torch.core.api import _Transform, plan_for

    n = x.shape[-1]
    if n > MAX_KERNEL_SIZE:
        raise ValueError(
            f"hadacore kernel supports n <= {MAX_KERNEL_SIZE} (paper cap); "
            f"got {n}. Use repro_torch.core.hadamard.hadamard_transform.")
    if not is_pow2(n):
        raise ValueError(f"Hadamard size must be a power of 2, got {n}")
    plan = plan_for(n, dtype=x.dtype, scale=scale, backend="cuda",
                    device_type=x.device.type)
    if not in_place:
        return _Transform.apply(x, plan)
    if x.requires_grad:
        raise ValueError("hadacore(in_place=True) got a tensor that requires grad: "
                         "an in-place transform would drop its graph; call it "
                         "with in_place=False to differentiate through it")
    return transform(x, plan, in_place=True)
