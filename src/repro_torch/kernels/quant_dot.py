"""The fused rotate -> per-token quantize -> GEMM consumers: the CUDA
kernels' wrappers, their plain PyTorch versions, and the quantized-GEMM
host math (twin of ``repro.kernels.quant_dot``).

Ten kernels in four CUDA sources (``repro_torch/csrc/quant_dot.cu``:
K4, K5 and K8; ``quant_dot_experts.cu``: K6 and K6s; ``quant_dot_abft.cu``:
K7a-ro, K7a-s and K7a-rv; ``quant_dot_experts_abft.cu``: K7b and K7b-s;
their shared body in ``quant_dot.cuh``), each replacing a TPU kernel of
``repro/kernels/quant_dot.py``:

  K4     ``_quant_dot_kernel_rotate_once``           x (..., n) @ wq (n, d)
  K5     ``_quant_dot_kernel_streamed``              K4, weight tiles streamed
                                                     through a shared-memory ring
  K8     ``_quant_dot_kernel_revisit``               K4's math, every block re-rotating
                                                     its row block for its one
                                                     weight tile of block_n columns
  K6     ``_quant_dot_experts_kernel``               x (..., E, c, n) @ wq (E, n, d)
  K6s    ``_quant_dot_experts_kernel_streamed``      K6, streamed as K5
  K7a-ro ``_quant_dot_kernel_rotate_once_abft``      K4 + per-row checksum residual
  K7a-s  ``_quant_dot_kernel_streamed_abft``         K5 + the same
  K7a-rv ``_quant_dot_kernel_revisit_abft``          K8 + the same
  K7b    ``_quant_dot_experts_kernel_abft``          K6 + a residual per (expert, row)
  K7b-s  ``_quant_dot_experts_kernel_streamed_abft`` K6s + the same

Each block rotates and quantizes its rows once into shared memory (one
byte a value) and contracts them with its run of weight-column tiles on
the tensor cores (``mma.sync`` m16n8k32; int8: exact int32 accumulation;
fp8: exact products, at most 128 k on the tensor core, then f32 sums in a
fixed order), then applies ``acc * s * sw``; the rotated activations never
reach HBM. At a decode step they are bound by the bytes of the weight. K4 is the MLP
down-projection site when d_ff is a power of 2 (phi4-mini: 8192 -> 3072;
llama4-maverick's dense and shared-expert MLPs: 8192 -> 5120), K6 the MoE
expert down projection (maverick: 128 experts of 8192 -> 5120). The
streamed schedule gives the same bits as rotate-once: the ring changes
where a weight word waits, not the order of any sum; so does the revisit
schedule, which changes how often a row is rotated (ceil(d / block_n)
times), not how.

``quant_dot`` and ``quant_dot_experts`` are what the ``cuda`` backend
calls: a CPU tensor goes to the plain version (K1's plain passes,
``_quantize_rows``, ``epilogue_dot``; per expert for the stacked form), a
CUDA tensor to the kernel of the resolved schedule. Each kernel's wrapper
counts its launches (``quant_dot_cuda.launches`` and so on).
``kernel_fits`` is the port's size rule for the fused path, from the
kernels' shared-memory layout.

The ABFT twins (``check=`` the weight's column checksum ``cw``, from
``wquant.weight_checksum``) return ``(y, resid)``: ``y`` bitwise the
unverified kernel's, ``resid`` the per-row f32
``sum_d (acc * s * sw) - s * (op . cw)``, ``op`` the quantized operand as
the reference's ``_abft_check_col`` forms it; ``verify.residual_ok``
turns it into a verdict. ``xla_quant_dot_resid`` is the residual of a site
that runs no fused kernel (grouped sizes such as llama3-8b's d_ff =
14336): it recomputes the checksum from the live weight and contracts the
difference, so a healthy weight gives exactly 0.

``epilogue_dot`` is the quantized contraction outside any kernel: the
unfused path (grouped sizes such as llama3-8b's d_ff = 14336, per-tensor
scales) and the plain version use it:

  * int8: exact int32 accumulation (``torch._int_mm``), or above
    ``_INT32_SAFE_K`` an f32 accumulation of the exact grid products;
  * fp8: both operands cast exactly to f32 (every fp8 value and every
    product of two is exact there), f32 accumulation with TF32 off;

then ``acc * s * sw`` in that order.

``revisit`` is the reference's A/B baseline for rotate-once: a dense call
runs K8 (K7a-rv under ABFT) on the card and the plain version on the CPU;
an expert call runs rotate-once, as the reference's expert grid does.

For the kernel-contract linter (``repro_torch.analysis``): inside
``counting_rotations()`` every wrapper launches the same kernels from their
rotation-counting builds (``build.counting``; the same outputs, bitwise),
whose per-row counters ``rotation_counts`` reads; ``launch_grid`` gives a
call's whole launch geometry and ``kernel_attributes`` the
``cudaFuncGetAttributes`` of the instantiation it launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import os

import torch
import torch.nn.functional as F

from repro_torch.core.hadamard import torch_dtype
from repro_torch.kernels.registry import QSPECS, _quantize_rows, cast_to

__all__ = ["epilogue_dot", "experts_epilogue_dot", "quant_dot",
           "quant_dot_cuda", "quant_dot_streamed_cuda", "quant_dot_revisit_cuda",
           "quant_dot_plain",
           "quant_dot_experts", "quant_dot_experts_cuda",
           "quant_dot_experts_streamed_cuda", "quant_dot_experts_plain",
           "quant_dot_abft_cuda", "quant_dot_abft_streamed_cuda",
           "quant_dot_abft_revisit_cuda",
           "quant_dot_experts_abft_cuda", "quant_dot_experts_abft_streamed_cuda",
           "quant_dot_abft_plain", "quant_dot_experts_abft_plain",
           "xla_quant_dot_resid", "kernel_fits", "launch_shape", "launch_grid",
           "kernel_attributes", "counting_rotations", "rotation_counts", "counting_lib",
           "SCHEDULE_ENV_VAR", "SCHEDULES", "REVISIT_BLOCK_N"]

SCHEDULE_ENV_VAR = "REPRO_QUANT_DOT_SCHEDULE"
SCHEDULES = ("rotate_once", "revisit", "streamed")
# The revisit schedule's weight tile (columns per block), as the reference's
# schedule A/B pins it; a positive multiple of the kernels' 32-column tile.
REVISIT_BLOCK_N = 128
_SCHEDULE_CODES = {"rotate_once": 0, "streamed": 1, "revisit": 2}

# Largest contraction whose worst-case int8 x int8 row sum stays in int32:
# 127 * 127 * 2^17 ~= 2.11e9 < 2^31 - 1.
_INT32_SAFE_K = 1 << 17


def _operand_from_q(q: torch.Tensor, mode: str) -> torch.Tensor:
    """``_quantize_rows`` output on the grid the contraction runs on: int8
    for the int path, the fp8 storage grid otherwise (the reference embeds
    it in bf16 for the TPU's matrix unit; the values are the same)."""
    if QSPECS[mode][2]:
        return q.to(torch.int8)
    return cast_to(q, QSPECS[mode][1])


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 (m, k) @ (k, d). ``torch._int_mm`` on the
    card wants more than 16 rows and k, d multiples of 8: zero padding
    changes no sum."""
    m, k = a.shape
    d = b.shape[1]
    mp = max(32, -(-m // 8) * 8)
    kp, dp = -(-k // 8) * 8, -(-d // 8) * 8
    if (mp, kp, dp) != (m, k, d):
        a = F.pad(a, (0, kp - k, 0, mp - m))
        b = F.pad(b, (0, dp - d, 0, kp - k))
    return torch._int_mm(a, b)[:m, :d]


def _low_precision_dot(q: torch.Tensor, wq: torch.Tensor, mode: str) -> torch.Tensor:
    """The quantized contraction on the mode's exact arithmetic; ``q`` is
    (m, n) f32 grid values, ``wq`` (n, d) storage dtype. Returns f32."""
    is_int = QSPECS[mode][2]
    if is_int and q.shape[-1] > _INT32_SAFE_K:
        return torch.matmul(q.to(torch.float32), wq.to(torch.float32))
    a = _operand_from_q(q, mode)
    if is_int:
        return _int8_mm(a, wq.to(torch.int8)).to(torch.float32)
    return torch.matmul(a.to(torch.float32), wq.to(torch.float32))


def _epilogue_f32(q, s, wq, sw, mode: str) -> torch.Tensor:
    """``epilogue_dot`` before its cast: the f32 ``acc * s * sw``."""
    lead = q.shape[:-1]
    n, d = q.shape[-1], wq.shape[-1]
    acc = _low_precision_dot(q.reshape(-1, n), wq, mode).reshape(*lead, d)
    return acc * s * sw.reshape((1,) * len(lead) + (d,))


def epilogue_dot(q, s, wq, sw, mode: str, out_dtype) -> torch.Tensor:
    """``(q * s) @ (wq * sw)`` with the scales factored out of the matmul:
    ``(q @ wq) * s * sw``. q: (..., n) grid values, s per-token (or per-
    tensor) scales, wq: (n, d) storage dtype, sw: (1, d)."""
    return _epilogue_f32(q, s, wq, sw, mode).to(out_dtype)


def experts_epilogue_dot(q, s, wq, sw, mode: str, out_dtype) -> torch.Tensor:
    """``epilogue_dot`` per expert: q (..., E, c, n) f32 grid values, s
    (..., E, c, 1), wq (E, n, d) storage dtype, sw (E, 1, d); returns
    (..., E, c, d). One expert at a time, so no f32 copy of the stack
    exists (a 128-expert f32 stack at maverick's width is 21.5 GB)."""
    E, _, d = wq.shape
    out = torch.empty((*q.shape[:-1], d), dtype=out_dtype, device=q.device)
    for e in range(E):
        out[..., e, :, :] = epilogue_dot(q[..., e, :, :], s[..., e, :, :],
                                         wq[e], sw[e], mode, out_dtype)
    return out


# ------------------------------------------------------------ schedules
def _resolve_schedule(schedule=None, experts: bool = False) -> str:
    """The grid schedule: the argument, then ``REPRO_QUANT_DOT_SCHEDULE``,
    then ``rotate_once``. ``streamed`` runs K5 (dense) or K6s (experts),
    ``revisit`` K8 (dense); an expert call runs ``rotate_once`` for
    ``revisit``, as the reference's expert grid has no revisit body. An
    unknown name raises ValueError."""
    if schedule is None:
        schedule = os.environ.get(SCHEDULE_ENV_VAR) or "rotate_once"
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown quant_dot schedule {schedule!r}; expected one "
                         f"of {SCHEDULES}")
    if schedule == "revisit" and experts:
        return "rotate_once"
    return schedule


# ------------------------------------------------------ the kernels' sizes
# Shared-memory layout of csrc/quant_dot.cuh, for the size rule: the
# operand (rows x n one-byte values -- int8, or the fp8 storage bytes the
# tensor cores read -- each row padded to a multiple of 128 bytes plus 32
# so that the 8 rows of an MMA fragment start in distinct banks), under the
# streamed schedule the weight ring (_STAGES k-steps of 1 KB for each of the
# 16 warps), a work area (the f32 rows rotated at once -- all of them when
# they fit, else the most, a power of 2, that do -- or the split rounds'
# 16 x rows x 32 partial sums, and under rotate-once also the ring), one f32
# scale per row and one absmax per rotated row; the ABFT twins add one
# checksum per row, one tile of f32 contributions (rows x 32), one sum per
# warp and a flag. The layout is the same for int8 and fp8. A call needs at
# least one row to fit the per-block limit. The revisit schedule's layout is
# rotate-once's: a K4 block also holds every row of its row block (the
# cluster's members store into each other), so K8 takes the same rows.
_SMEM_LIMIT = 232448     # 227 KB on sm_90
_KW, _BN = 16, 32        # warps (and k-slices of a split tile), columns per tile
_STAGES, _STAGE_BYTES = 4, 32 * 32   # a warp's ring: k-steps of 32 rows x 32 columns
_RING = _KW * _STAGES * _STAGE_BYTES


def _op_stride(n: int) -> int:
    """Bytes per operand row: the k extent (n, at least 32) rounded up to
    128, plus 32."""
    return -(-max(n, 32) // 128) * 128 + 32


def _smem_bytes(n: int, rows: int, mode: str, schedule: str = "rotate_once",
                abft: bool = False) -> int:
    """The dynamic shared memory of a launch of ``rows`` rows per block (the
    same for every mode: the operand holds one byte a value)."""
    streamed = schedule == "streamed"
    red = _KW * rows * _BN * 4
    scratch = (rows + rows * _BN + _KW + 1) * 4 if abft else 0

    def layout(rw):
        work = max(rw * n * 4, red + (0 if streamed else _RING))
        return (rows * _op_stride(n) + (_RING if streamed else 0) + work + rows * 4
                + rw * 4 + scratch)

    rw = rows
    while rw > 1 and layout(rw) > _SMEM_LIMIT:
        rw //= 2
    return layout(rw)


def kernel_fits(n: int, mode: str, schedule: str = "rotate_once",
                abft: bool = False) -> bool:
    """Can the kernel of ``schedule`` (``abft``: its checksum-verified
    twin) take an n-point contraction in ``mode``: does one row of its
    shared-memory layout fit the 227 KB per-block limit? (True for every
    power of 2 up to the 32768 cap under every schedule, with or without
    ABFT, in every mode.)"""
    return _smem_bytes(n, 1, mode, schedule, abft) <= _SMEM_LIMIT


_SMEM_PER_SM = 233472   # 228 KB of shared memory on an SM
_SMS = 132              # an H100 SXM's SMs


def _rows_per_block(m: int, n: int, mode: str, schedule: str = "rotate_once",
                    abft: bool = False) -> int:
    """The launcher's rows per block (``pick_bm``): the largest of 16, 8, 4,
    2, 1 that m rows need and the layout fits; 0 when none fits."""
    bm = 16
    while bm > 1 and bm // 2 >= m:
        bm //= 2
    while bm >= 1 and _smem_bytes(n, bm, mode, schedule, abft) > _SMEM_LIMIT:
        bm //= 2
    return bm


def _grid_plan(m: int, n: int, d: int, mode: str, experts: int = 0,
               schedule: str = "rotate_once", abft: bool = False,
               block_n: int = REVISIT_BLOCK_N, sms: int = _SMS) -> dict:
    """``launch_grid``'s geometry from the launcher's rules (``pick_bm``,
    ``grid_for`` in csrc/quant_dot.cuh) on a card of ``sms`` SMs, without
    the library: splits for about one wave of resident blocks, a multiple
    of the cluster (the largest power of 2 up to 8 within the rows per
    block and the splits); revisit one split per weight tile of block_n
    columns and no cluster. Each row is rotated splits / cluster times
    (revisit: splits)."""
    schedule = _resolve_schedule(schedule, experts=bool(experts))
    bm = _rows_per_block(m, n, mode, schedule, abft)
    if bm == 0:
        raise ValueError(f"no launch fits n={n} {mode} {schedule}")
    smem = _smem_bytes(n, bm, mode, schedule, abft)
    row_blocks, tiles = -(-m // bm), -(-d // _BN)
    if schedule == "revisit":
        tpb = block_n // _BN
        return dict(bm=bm, smem=smem, row_blocks=row_blocks, splits=-(-tiles // tpb),
                    tiles_per_block=tpb, cluster=1)
    per_sm = min(2, max(1, _SMEM_PER_SM // (smem + 1024)))   # 1 KB reserved per block
    tpb = max(1, -(-(tiles * row_blocks * max(experts, 1)) // (per_sm * sms)))
    splits = -(-tiles // tpb)
    cluster = 8
    while cluster > 1 and (cluster > bm or cluster > splits):
        cluster //= 2
    splits = splits // cluster * cluster
    return dict(bm=bm, smem=smem, row_blocks=row_blocks, splits=splits,
                tiles_per_block=-(-tiles // splits), cluster=cluster)


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
# True while counting_rotations() is active: the wrappers load the
# rotation-counting builds
_COUNTING = [False]


@contextlib.contextmanager
def counting_rotations():
    """Launch the kernels from their rotation-counting builds while the
    context is active (the linter's rotate-once evidence)."""
    prev = _COUNTING[0]
    _COUNTING[0] = True
    try:
        yield
    finally:
        _COUNTING[0] = prev


def _lint_queries(lib, stem: str) -> None:
    """argtypes of the linter's queries of ``lib`` (``quant_dot.cuh``)."""
    grid = getattr(lib, f"{stem}_grid")
    if grid.argtypes is None:
        grid.argtypes = [_LL, _INT, _INT, _INT, _INT, _INT, _INT, ctypes.POINTER(_LL)]
        grid.restype = _INT
        attrs = getattr(lib, f"{stem}_attributes")
        attrs.argtypes = [_LL, _INT, _INT, _INT, _INT, ctypes.POINTER(_LL)]
        attrs.restype = _INT


def _lib(experts: bool, abft: bool = False):
    """The loaded library of the dense kernels (``csrc/quant_dot.cu``: K4,
    K5), of the expert kernels (``csrc/quant_dot_experts.cu``: K6, K6s), or
    of their ABFT twins (``quant_dot_abft.cu``: K7a-ro, K7a-s;
    ``quant_dot_experts_abft.cu``: K7b, K7b-s), built first if needed. The
    expert entry points take the expert count and the rows per expert and
    batch row (c) after d, then the schedule (0 or 1); the dense ones the
    schedule code and block_n; the ABFT entry points take cw after sw and
    resid, the workspace and the counters after out."""
    from repro_torch.kernels import build

    stem = ("quant_dot_experts" if experts else "quant_dot") + ("_abft" if abft else "")
    lib = build.load_target(build.counting(stem)) if _COUNTING[0] else build.load(stem)
    fn = getattr(lib, f"{stem}_launch")
    if fn.argtypes is None:
        # experts: E, c, schedule; dense: schedule, block_n
        extra = [_INT] * 3 if experts else [_INT] * 2
        fn.argtypes = ([_PTR] * (8 if abft else 4) + [ctypes.c_longlong, _INT, _INT] + extra
                       + [_INT] * 3 + [ctypes.c_float, _INT, _PTR])
        fn.restype = _INT
        _lint_queries(lib, stem)
    return lib, stem


def launch_shape(m: int, n: int, d: int, mode: str, experts: int = 0,
                 schedule: str = "rotate_once", abft: bool = False,
                 block_n: int = REVISIT_BLOCK_N):
    """(rows per block, dynamic shared-memory bytes, blocks) of a launch
    over ``experts`` experts of m rows each (0: the dense kernels), as the
    kernels' launcher decides them (builds the kernels); ``abft`` asks for
    the checksum-verified twin's, ``block_n`` is revisit's weight tile."""
    g = launch_grid(m, n, d, mode, experts, schedule, abft, block_n)
    return g["bm"], g["smem"], g["row_blocks"] * g["splits"] * max(experts, 1)


def launch_grid(m: int, n: int, d: int, mode: str, experts: int = 0,
                schedule: str = "rotate_once", abft: bool = False,
                block_n: int = REVISIT_BLOCK_N) -> dict:
    """A call's whole launch geometry, as the launcher decides it: rows
    per block ``bm``, dynamic shared bytes ``smem``, ``row_blocks``,
    column ``splits``, ``tiles_per_block`` (of 32 columns) and the
    thread-block ``cluster`` size (1 under revisit, which runs no
    cluster). An expert call under revisit runs rotate-once, as its
    dispatch does."""
    from repro_torch.kernels.fused_quant import MODE_CODES

    schedule = _resolve_schedule(schedule, experts=bool(experts))
    lib, stem = _lib(bool(experts), abft)
    out = (_LL * 6)()
    rc = getattr(lib, f"{stem}_grid")(m, n, d, max(experts, 1), _SCHEDULE_CODES[schedule],
                                      block_n, MODE_CODES[mode], out)
    if rc != 0:
        raise ValueError(f"no launch of {stem} fits m={m} n={n} d={d} {mode} {schedule}")
    return dict(zip(("bm", "smem", "row_blocks", "splits", "tiles_per_block", "cluster"),
                    list(out)))


def kernel_attributes(m: int, n: int, mode: str, io_dtype, experts: bool = False,
                      schedule: str = "rotate_once", abft: bool = False) -> dict:
    """``cudaFuncGetAttributes`` of the instantiation a call of m rows (per
    expert) launches, from the library the wrappers load now (the counting
    build inside ``counting_rotations``): ``bm``, ``static_smem``,
    ``max_dynamic_smem`` (what its last launch set), ``regs``, ``local``."""
    from repro_torch.kernels.fused_quant import MODE_CODES
    from repro_torch.kernels.hadacore import DTYPE_CODES

    lib, stem = _lib(experts, abft)
    out = (_LL * 5)()
    rc = getattr(lib, f"{stem}_attributes")(m, n, _SCHEDULE_CODES[schedule],
                                            DTYPE_CODES[io_dtype], MODE_CODES[mode], out)
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes of {stem} failed: CUDA error {rc}")
    return dict(zip(("bm", "static_smem", "max_dynamic_smem", "regs", "local"), list(out)))


def rotation_counts(lib, prefix: str, rows: int):
    """The first ``rows`` per-row rotation counters of a counting build
    ``lib`` (exports ``<prefix>_rotations``), as a numpy uint32 array, and
    the rotations of rows past the counter array; then every counter back
    to 0. Synchronizes the device."""
    import numpy as np

    fn = getattr(lib, f"{prefix}_rotations")
    if fn.argtypes is None:
        fn.argtypes = [_PTR, _LL, _PTR]
        fn.restype = _INT
        getattr(lib, f"{prefix}_rotations_reset").argtypes = []
        getattr(lib, f"{prefix}_rotations_reset").restype = _INT
    host = np.zeros(max(rows, 1), dtype=np.uint32)
    lost = np.zeros(1, dtype=np.uint32)
    rc = fn(host.ctypes.data, rows, lost.ctypes.data)
    if rc == 0:
        rc = getattr(lib, f"{prefix}_rotations_reset")()
    if rc != 0:
        raise RuntimeError(f"{prefix} rotation counters: CUDA error {rc}")
    return host[:rows], int(lost[0])


def counting_lib(experts: bool, abft: bool = False):
    """(library, export prefix) of the counting build the wrappers launch
    inside ``counting_rotations``."""
    with counting_rotations():
        return _lib(experts, abft)


# ------------------------------------------------------------ the launches
# The ABFT twins' arrival counters, one zeroed buffer per device that every
# launch leaves zeroed (the last block of each row block resets its own);
# launches on one stream use it in turn.
_COUNTERS = {}


def _abft_workspace(device, m: int, d: int, E: int):
    """(partial-sum workspace, counters) for an ABFT launch of E experts of
    m rows each against d columns: at most E x (m + 15) x ceil(d / 32)
    floats (row blocks x rows per block <= m + 15, splits <= the 32-column
    tiles), at most E x m counters."""
    part = torch.empty(E * (m + 15) * -(-d // 32), dtype=torch.float32, device=device)
    need = E * max(m, 1)
    count = _COUNTERS.get(device)
    if count is None or count.numel() < need:
        count = torch.zeros(need, dtype=torch.int32, device=device)
        _COUNTERS[device] = count
    return part, count


def _launch(x, wq, sw, out, plan, schedule: str, cw=None, resid=None,
            block_n: int = REVISIT_BLOCK_N) -> None:
    """Check the operands of one launch of ``schedule``'s kernel and launch
    it on the current stream (revisit: dense only, ``block_n`` a positive
    multiple of 32). Dense: x (m, n), wq (n, d), sw (d,), out (m, d). Experts: x
    (B, E, c, n), wq (E, n, d), sw (E, d), out (B, E, c, d). All
    contiguous CUDA tensors on one device; x and out in the io dtype, wq in
    the mode's storage dtype, sw f32. The ABFT twins also take cw ((n,),
    experts (E, n)) f32 and resid (x's shape with last axis 1) f32."""
    from repro_torch.kernels.fused_quant import MODE_CODES
    from repro_torch.kernels.hadacore import (DTYPE_CODES, check_rows,
                                              scale_in_compute_dtype)

    epi = plan.epilogue
    if epi is None or epi.dequant or not epi.per_token or plan.grouped:
        raise ValueError("quant_dot kernel takes per-token (q, scales) plans "
                         f"of a power-of-2 size, got {epi!r} n={plan.n}")
    n = x.shape[-1]
    experts = x.ndim == 4
    abft = cw is not None
    E, cap = (x.shape[1], x.shape[2]) if experts else (1, 1)
    m = x.numel() // (n * E) if n * E else 0
    d = wq.shape[-1]
    check_rows(x.view(-1, n), x.view(-1, n), plan)
    tensors = (wq, sw, out) + ((cw, resid) if abft else ())
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("quant_dot kernel operands must be CUDA tensors on one device")
    wshape = (E, n, d) if experts else (n, d)
    if wq.shape != wshape or wq.dtype != QSPECS[epi.mode][1] or not wq.is_contiguous():
        raise ValueError(f"wq must be contiguous {wshape} {QSPECS[epi.mode][1]}, got "
                         f"{tuple(wq.shape)} {wq.dtype}")
    sshape = (E, d) if experts else (d,)
    if sw.shape != sshape or sw.dtype != torch.float32 or not sw.is_contiguous():
        raise ValueError(f"sw must be contiguous {sshape} float32, got "
                         f"{tuple(sw.shape)} {sw.dtype}")
    oshape = (*x.shape[:-1], d)
    if out.shape != oshape or out.dtype != x.dtype or not out.is_contiguous():
        raise ValueError(f"out must be contiguous {oshape} {x.dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if abft:
        cshape = (E, n) if experts else (n,)
        if cw.shape != cshape or cw.dtype != torch.float32 or not cw.is_contiguous():
            raise ValueError(f"cw must be contiguous {cshape} float32, got "
                             f"{tuple(cw.shape)} {cw.dtype}")
        rshape = (*x.shape[:-1], 1)
        if resid.shape != rshape or resid.dtype != torch.float32 \
                or not resid.is_contiguous():
            raise ValueError(f"resid must be contiguous {rshape} float32, got "
                             f"{tuple(resid.shape)} {resid.dtype}")
    if schedule == "revisit" and (experts or block_n <= 0 or block_n % _BN):
        raise ValueError(f"the revisit kernel is dense with block_n a positive multiple "
                         f"of {_BN}, got block_n={block_n} experts={experts}")
    if not kernel_fits(n, epi.mode, schedule, abft):
        raise ValueError(f"quant_dot kernel ({schedule}) cannot take n={n} in {epi.mode}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if experts:
        lead = (m, n, d, E, cap, int(schedule == "streamed"))
    else:
        lead = (m, n, d, _SCHEDULE_CODES[schedule], block_n)
    lib, stem = _lib(experts, abft)
    ptrs = [x.data_ptr(), wq.data_ptr(), sw.data_ptr()]
    if abft:
        part, count = _abft_workspace(x.device, m, d, E)
        ptrs += [cw.data_ptr(), out.data_ptr(), resid.data_ptr(), part.data_ptr(),
                 count.data_ptr()]
    else:
        ptrs.append(out.data_ptr())
    rc = getattr(lib, f"{stem}_launch")(
        *ptrs, *lead, plan.r, DTYPE_CODES[x.dtype],
        DTYPE_CODES[torch_dtype(plan.compute_dtype)], scale_in_compute_dtype(plan),
        MODE_CODES[epi.mode], stream)
    if rc != 0:
        raise RuntimeError(f"quant_dot kernel launch failed: CUDA error {rc}")


def quant_dot_cuda(x2, wq, sw, out, plan) -> torch.Tensor:
    """Launch K4 (rotate-once) on contiguous (m, n) CUDA rows ``x2``
    against the (n, d) storage-dtype weight ``wq`` and its (d,) f32 scales
    ``sw``, into ``out`` ((m, d), the io dtype), on the current stream."""
    _launch(x2, wq, sw, out, plan, "rotate_once")
    quant_dot_cuda.launches += 1
    return out


def quant_dot_streamed_cuda(x2, wq, sw, out, plan) -> torch.Tensor:
    """Launch K5: K4 with the weight tiles streamed through the ring."""
    _launch(x2, wq, sw, out, plan, "streamed")
    quant_dot_streamed_cuda.launches += 1
    return out


def quant_dot_revisit_cuda(x2, wq, sw, out, plan,
                           block_n: int = REVISIT_BLOCK_N) -> torch.Tensor:
    """Launch K8: K4's output (bitwise) from a (row block, weight tile of
    ``block_n`` columns) grid, each block rotating its row block anew."""
    _launch(x2, wq, sw, out, plan, "revisit", block_n=block_n)
    quant_dot_revisit_cuda.launches += 1
    return out


def quant_dot_experts_cuda(x4, wq, sw, out, plan) -> torch.Tensor:
    """Launch K6 (rotate-once) on contiguous (B, E, c, n) CUDA rows ``x4``
    against the (E, n, d) expert weights ``wq`` and their (E, d) f32
    scales ``sw``, into ``out`` ((B, E, c, d), the io dtype). The kernel
    reads expert e's B * c rows in place, through their strides."""
    _launch(x4, wq, sw, out, plan, "rotate_once")
    quant_dot_experts_cuda.launches += 1
    return out


def quant_dot_experts_streamed_cuda(x4, wq, sw, out, plan) -> torch.Tensor:
    """Launch K6s: K6 with the weight tiles streamed through the ring."""
    _launch(x4, wq, sw, out, plan, "streamed")
    quant_dot_experts_streamed_cuda.launches += 1
    return out


def quant_dot_abft_cuda(x2, wq, sw, cw, out, resid, plan):
    """Launch K7a-ro: K4 plus each row's checksum residual, against the
    (n,) f32 column checksum ``cw``, into ``out`` and ``resid`` ((m, 1)
    f32)."""
    _launch(x2, wq, sw, out, plan, "rotate_once", cw=cw, resid=resid)
    quant_dot_abft_cuda.launches += 1
    return out, resid


def quant_dot_abft_streamed_cuda(x2, wq, sw, cw, out, resid, plan):
    """Launch K7a-s: K5 plus the residual (cw read outside the ring)."""
    _launch(x2, wq, sw, out, plan, "streamed", cw=cw, resid=resid)
    quant_dot_abft_streamed_cuda.launches += 1
    return out, resid


def quant_dot_abft_revisit_cuda(x2, wq, sw, cw, out, resid, plan,
                                block_n: int = REVISIT_BLOCK_N):
    """Launch K7a-rv: K8 plus the residual (the row sums of the weight
    tiles added in tile order by the last block of each row block)."""
    _launch(x2, wq, sw, out, plan, "revisit", cw=cw, resid=resid, block_n=block_n)
    quant_dot_abft_revisit_cuda.launches += 1
    return out, resid


def quant_dot_experts_abft_cuda(x4, wq, sw, cw, out, resid, plan):
    """Launch K7b: K6 plus a residual per (expert, row) against expert
    e's checksum ``cw[e]`` ((E, n) f32), into ``resid`` ((B, E, c, 1))."""
    _launch(x4, wq, sw, out, plan, "rotate_once", cw=cw, resid=resid)
    quant_dot_experts_abft_cuda.launches += 1
    return out, resid


def quant_dot_experts_abft_streamed_cuda(x4, wq, sw, cw, out, resid, plan):
    """Launch K7b-s: K6s plus the residual (cw read outside the ring)."""
    _launch(x4, wq, sw, out, plan, "streamed", cw=cw, resid=resid)
    quant_dot_experts_abft_streamed_cuda.launches += 1
    return out, resid


for _fn in (quant_dot_cuda, quant_dot_streamed_cuda, quant_dot_revisit_cuda,
            quant_dot_experts_cuda, quant_dot_experts_streamed_cuda, quant_dot_abft_cuda,
            quant_dot_abft_streamed_cuda, quant_dot_abft_revisit_cuda,
            quant_dot_experts_abft_cuda,
            quant_dot_experts_abft_streamed_cuda):
    _fn.launches = 0


# --------------------------------------------------------- plain versions
def _rotate_quantize_plain(x: torch.Tensor, plan):
    """K1's plain passes in the compute dtype, then per-token
    ``_quantize_rows`` of the f32 copy: (q, s)."""
    from repro_torch.kernels.hadacore import transform_plain

    y = transform_plain(x.to(torch_dtype(plan.compute_dtype)), plan)
    return _quantize_rows(y.to(torch.float32), plan.epilogue.mode)


def quant_dot_plain(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                    plan) -> torch.Tensor:
    """The plain version of K4, K5 and K8 (the reference's ``xla_quant_dot``):
    rotate, quantize per token, then ``epilogue_dot`` against ``wq`` (n, d)
    and ``sw``. Returns (..., d) in x's dtype."""
    q, s = _rotate_quantize_plain(x, plan)
    d = wq.shape[-1]
    return epilogue_dot(q, s, wq, sw.reshape(1, d), plan.epilogue.mode, x.dtype)


def quant_dot_experts_plain(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                            plan) -> torch.Tensor:
    """The plain version of K6 and K6s: rotate and quantize every row of
    x (..., E, c, n) as ``quant_dot_plain`` does, then contract expert e's
    rows with ``wq[e]`` (n, d) and ``sw[e]``, one expert at a time.
    Returns (..., E, c, d) in x's dtype."""
    q, s = _rotate_quantize_plain(x, plan)
    E, _, d = wq.shape
    return experts_epilogue_dot(q, s, wq, sw.reshape(E, 1, d), plan.epilogue.mode,
                                x.dtype)


def _abft_parts(q, s, wq, sw, cw, mode: str, out_dtype):
    """One weight's output and residual from (q, s): the f32 contributions
    cast to the output, and ``contrib.sum(-1) - s * (op . cw)`` with op the
    quantized operand (int8, or the fp8 grid value) as f32."""
    d = wq.shape[-1]
    contrib = _epilogue_f32(q, s, wq, sw.reshape(1, d), mode)
    op = _operand_from_q(q, mode).to(torch.float32)
    chk = (op * cw.reshape(-1)).sum(-1, keepdim=True)
    return contrib.to(out_dtype), contrib.sum(-1, keepdim=True) - s * chk


def quant_dot_abft_plain(x, wq, sw, cw, plan):
    """The plain version of K7a-ro, K7a-s and K7a-rv: ``quant_dot_plain``'s output
    (bitwise) and the per-row residual against the column checksum ``cw``
    ((1, n) or (n,)). Returns (y (..., d), resid (..., 1) f32)."""
    q, s = _rotate_quantize_plain(x, plan)
    return _abft_parts(q, s, wq, sw, cw, plan.epilogue.mode, x.dtype)


def quant_dot_experts_abft_plain(x, wq, sw, cw, plan):
    """The plain version of K7b and K7b-s: per expert e,
    ``quant_dot_abft_plain``'s output and residual against ``wq[e]``,
    ``sw[e]`` and ``cw[e]`` ((E, 1, n)). Returns (y (..., E, c, d), resid
    (..., E, c, 1) f32)."""
    q, s = _rotate_quantize_plain(x, plan)
    E, n, d = wq.shape
    cw3 = cw.reshape(E, 1, n)
    y = torch.empty((*q.shape[:-1], d), dtype=x.dtype, device=x.device)
    r = torch.empty((*q.shape[:-1], 1), dtype=torch.float32, device=x.device)
    for e in range(E):
        y[..., e, :, :], r[..., e, :, :] = _abft_parts(
            q[..., e, :, :], s[..., e, :, :], wq[e], sw[e], cw3[e],
            plan.epilogue.mode, x.dtype)
    return y, r


def xla_quant_dot_resid(x, wq, sw, cw, plan) -> torch.Tensor:
    """The residual of a site that runs no fused kernel (the reference's
    ``xla_quant_dot_resid``): rotate and quantize x as the unfused path
    does (grouped plans rotate per group), recompute the weight's column
    checksum from the live ``wq`` and ``sw`` in ``wquant.weight_checksum``'s
    op order, and contract q with the difference from the stored ``cw``:
    ``s * (q . (recomputed - cw))``. Healthy weights make the difference,
    and so the residual, exactly 0; a weight changed since quantization
    shows as the change times the activation. One more rotation of x.
    Returns (..., 1) f32."""
    from repro_torch.core.api import _dispatch_transform, _strip
    from repro_torch.core.wquant import weight_checksum

    n, d = wq.shape
    y = _dispatch_transform(x, _strip(plan))
    epi = plan.epilogue
    q, s = _quantize_rows(y.to(torch.float32), epi.mode,
                          axis=-1 if epi.per_token else None)
    dvec = weight_checksum(wq, sw.reshape(1, d)).reshape(n) - cw.reshape(n)
    return s * (q.to(torch.float32) @ dvec)[..., None]


# ------------------------------------------------------------ dispatchers
def _on_cuda(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {x.device}")
    return True


def quant_dot(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, plan,
              schedule=None, check=None, block_n: int = REVISIT_BLOCK_N):
    """Rotate x's last axis (== plan.p), quantize per token and contract
    with ``wq`` (n, d): the plain version for a CPU tensor, the kernel of
    the resolved schedule for a CUDA tensor (K4 rotate-once, K5
    streamed, K8 revisit with ``block_n``-column weight tiles). With
    ``check`` (the weight's (1, n) column checksum) the ABFT twin runs
    instead (K7a-ro, K7a-s, K7a-rv) and the result is ``(y, resid)``,
    resid (..., 1) f32."""
    sched = _resolve_schedule(schedule)
    if not _on_cuda(x, "quant_dot"):
        if check is not None:
            return quant_dot_abft_plain(x, wq, sw, check, plan)
        return quant_dot_plain(x, wq, sw, plan)
    d = wq.shape[-1]
    x2 = x.contiguous().view(-1, plan.p)
    out = torch.empty((x2.shape[0], d), dtype=x.dtype, device=x.device)
    sw1 = sw.reshape(d).to(torch.float32).contiguous()
    if check is None:
        if sched == "revisit":
            quant_dot_revisit_cuda(x2, wq.contiguous(), sw1, out, plan, block_n)
        else:
            launch = quant_dot_streamed_cuda if sched == "streamed" else quant_dot_cuda
            launch(x2, wq.contiguous(), sw1, out, plan)
        return out.view(*x.shape[:-1], d)
    resid = torch.empty((x2.shape[0], 1), dtype=torch.float32, device=x.device)
    cw = check.reshape(plan.p).to(torch.float32).contiguous()
    if sched == "revisit":
        quant_dot_abft_revisit_cuda(x2, wq.contiguous(), sw1, cw, out, resid, plan, block_n)
    else:
        launch = (quant_dot_abft_streamed_cuda if sched == "streamed"
                  else quant_dot_abft_cuda)
        launch(x2, wq.contiguous(), sw1, cw, out, resid, plan)
    return out.view(*x.shape[:-1], d), resid.view(*x.shape[:-1], 1)


def quant_dot_experts(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, plan,
                      schedule=None, check=None):
    """The stacked-expert form, ``(..., E, c, n) x (E, n, d) -> (..., E, c,
    d)`` with per-(expert, out-channel) scales ``sw`` (E, 1, d): the plain
    version for a CPU tensor, the kernel of the resolved schedule for a
    CUDA tensor (K6 rotate-once, K6s streamed; ``revisit`` runs
    rotate-once). With ``check`` (the (E, 1, n) column checksums) the ABFT
    twin runs instead (K7b, K7b-s) and the result is ``(y, resid)``, resid
    (..., E, c, 1) f32."""
    streamed = _resolve_schedule(schedule, experts=True) == "streamed"
    if not _on_cuda(x, "quant_dot_experts"):
        if check is not None:
            return quant_dot_experts_abft_plain(x, wq, sw, check, plan)
        return quant_dot_experts_plain(x, wq, sw, plan)
    E, n, d = wq.shape
    if x.ndim < 3 or x.shape[-3] != E:
        raise ValueError(f"expert activations must be (..., {E}, c, {n}), got "
                         f"{tuple(x.shape)}")
    x4 = x.contiguous().view(-1, E, x.shape[-2], n)
    out = torch.empty((*x4.shape[:-1], d), dtype=x.dtype, device=x.device)
    sw2 = sw.reshape(E, d).to(torch.float32).contiguous()
    if check is None:
        launch = quant_dot_experts_streamed_cuda if streamed else quant_dot_experts_cuda
        launch(x4, wq.contiguous(), sw2, out, plan)
        return out.view(*x.shape[:-1], d)
    resid = torch.empty((*x4.shape[:-1], 1), dtype=torch.float32, device=x.device)
    launch = (quant_dot_experts_abft_streamed_cuda if streamed
              else quant_dot_experts_abft_cuda)
    launch(x4, wq.contiguous(), sw2, check.reshape(E, n).to(torch.float32).contiguous(),
           out, resid, plan)
    return out.view(*x.shape[:-1], d), resid.view(*x.shape[:-1], 1)
