"""K4, the fused rotate -> per-token quantize -> GEMM consumer: the CUDA
kernel's wrapper, its plain PyTorch version, and the quantized-GEMM host
math (twin of ``repro.kernels.quant_dot``, rotate-once schedule only).

The kernel (``repro_torch/csrc/quant_dot.cu``) replaces the TPU kernel
``repro/kernels/quant_dot.py::_quant_dot_kernel_rotate_once``. Each block
rotates and quantizes its rows once into shared memory and contracts them
with its run of weight-column tiles (int8: exact int32 accumulation; fp8:
exact products, f32 accumulation), then applies ``acc * s * sw``; the
rotated activations never reach HBM. At a decode step it is bound by the
bytes of the weight. It is the MLP down-projection site when d_ff is a
power of 2 (phi4-mini: 8192 -> 3072).

``quant_dot`` is what the ``cuda`` backend calls: a CPU tensor goes to
``quant_dot_plain`` (K1's plain passes, ``_quantize_rows``,
``epilogue_dot``), a CUDA tensor to the kernel. ``quant_dot_cuda.launches``
counts the kernel's launches. ``kernel_fits`` is the port's size rule for
the fused path, from the kernel's shared-memory layout.

``epilogue_dot`` is the quantized contraction outside any kernel: the
unfused path (grouped sizes such as llama3-8b's d_ff = 14336, per-tensor
scales) and the plain version use it:

  * int8: exact int32 accumulation (``torch._int_mm``), or above
    ``_INT32_SAFE_K`` an f32 accumulation of the exact grid products;
  * fp8: both operands cast exactly to f32 (every fp8 value and every
    product of two is exact there), f32 accumulation with TF32 off;

then ``acc * s * sw`` in that order.

The reference's other grid schedules (``revisit``, ``streamed``) are later
slices of the port (ROADMAP section 2, K8 and K5): asking for one raises.
"""
from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from repro_torch.core.hadamard import torch_dtype
from repro_torch.kernels.registry import QSPECS, _quantize_rows, cast_to

__all__ = ["epilogue_dot", "quant_dot", "quant_dot_cuda", "quant_dot_plain",
           "kernel_fits", "SCHEDULE_ENV_VAR", "SCHEDULES"]

SCHEDULE_ENV_VAR = "REPRO_QUANT_DOT_SCHEDULE"
SCHEDULES = ("rotate_once", "revisit", "streamed")

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


def epilogue_dot(q, s, wq, sw, mode: str, out_dtype) -> torch.Tensor:
    """``(q * s) @ (wq * sw)`` with the scales factored out of the matmul:
    ``(q @ wq) * s * sw``. q: (..., n) grid values, s per-token (or per-
    tensor) scales, wq: (n, d) storage dtype, sw: (1, d)."""
    lead = q.shape[:-1]
    n, d = q.shape[-1], wq.shape[-1]
    acc = _low_precision_dot(q.reshape(-1, n), wq, mode).reshape(*lead, d)
    return (acc * s * sw.reshape((1,) * len(lead) + (d,))).to(out_dtype)


# ------------------------------------------------------------ schedules
def _resolve_schedule(schedule=None) -> str:
    """The grid schedule: the argument, then ``REPRO_QUANT_DOT_SCHEDULE``,
    then ``rotate_once``. Only ``rotate_once`` (K4) is ported: ``revisit``
    and ``streamed`` raise rather than run ``rotate_once`` in their place;
    an unknown name raises ValueError."""
    if schedule is None:
        schedule = os.environ.get(SCHEDULE_ENV_VAR) or "rotate_once"
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown quant_dot schedule {schedule!r}; expected one "
                         f"of {SCHEDULES}")
    if schedule != "rotate_once":
        raise NotImplementedError(
            f"quant_dot schedule {schedule!r} is not ported yet (ROADMAP "
            "section 2: K5 streamed and K8 revisit are queued as K4 "
            "schedules); only 'rotate_once' runs")
    return schedule


# --------------------------------------------------------- the K4 kernel
# Shared-memory layout of csrc/quant_dot.cu, for the size rule: the
# operand (rows x n, 1 byte for int8, 2 for fp8 as bf16), a work area
# (the f32 rows rotated at once -- all of them when they fit, else the most,
# a power of 2, that do -- or the 16 x rows x 32 partial sums), one f32
# scale per row and one absmax per rotated row. A call needs at least one
# row to fit the per-block limit.
_SMEM_LIMIT = 232448     # 227 KB on sm_90
_KW, _BN = 16, 32        # partial sums per output, columns per tile


def _smem_bytes(n: int, rows: int, mode: str) -> int:
    opb = 1 if QSPECS[mode][2] else 2

    def layout(rw):
        return (rows * max(n, 4) * opb + max(rw * n * 4, _KW * rows * _BN * 4)
                + rows * 4 + rw * 4)

    rw = rows
    while rw > 1 and layout(rw) > _SMEM_LIMIT:
        rw //= 2
    return layout(rw)


def kernel_fits(n: int, mode: str) -> bool:
    """Can K4 take an n-point contraction in ``mode``: does one row of
    its shared-memory layout fit the 227 KB per-block limit? (True for every
    power of 2 up to the 32768 cap: 192 KB at 32768 for fp8.)"""
    return _smem_bytes(n, 1, mode) <= _SMEM_LIMIT


_PTR = ctypes.c_void_p


def _lib():
    from repro_torch.kernels import build

    lib = build.load("quant_dot")
    fn = lib.quant_dot_launch
    if fn.argtypes is None:
        fn.argtypes = [_PTR, _PTR, _PTR, _PTR, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, _PTR]
        fn.restype = ctypes.c_int
        shape = lib.quant_dot_shape
        shape.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(ctypes.c_longlong),
                          ctypes.POINTER(ctypes.c_longlong)]
        shape.restype = ctypes.c_int
    return lib


def launch_shape(m: int, n: int, d: int, mode: str):
    """(rows per block, dynamic shared-memory bytes, blocks) of a K4 call,
    as the kernel's launcher decides them (builds the kernel)."""
    from repro_torch.kernels.fused_quant import MODE_CODES

    bm, smem, blocks = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong()
    _lib().quant_dot_shape(m, n, d, MODE_CODES[mode], ctypes.byref(bm),
                           ctypes.byref(smem), ctypes.byref(blocks))
    return bm.value, smem.value, blocks.value


def quant_dot_cuda(x2: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                   out: torch.Tensor, plan) -> torch.Tensor:
    """Launch K4 on contiguous (m, p) CUDA rows ``x2`` against the
    contiguous (p, d) storage-dtype weight ``wq`` and its (d,) f32 scales
    ``sw``, into ``out`` ((m, d), the io dtype), on the current stream."""
    from repro_torch.kernels.fused_quant import MODE_CODES
    from repro_torch.kernels.hadacore import (DTYPE_CODES, check_rows,
                                              scale_in_compute_dtype)

    epi = plan.epilogue
    if epi is None or epi.dequant or not epi.per_token or plan.grouped:
        raise ValueError("quant_dot kernel takes per-token (q, scales) plans "
                         f"of a power-of-2 size, got {epi!r} n={plan.n}")
    check_rows(x2, x2, plan)
    m, n = x2.shape
    d = wq.shape[-1]
    if not (wq.is_cuda and sw.is_cuda and out.is_cuda
            and wq.device == sw.device == out.device == x2.device):
        raise ValueError("quant_dot kernel operands must be CUDA tensors on one device")
    if wq.shape != (n, d) or wq.dtype != QSPECS[epi.mode][1] or not wq.is_contiguous():
        raise ValueError(f"wq must be contiguous ({n}, d) {QSPECS[epi.mode][1]}, got "
                         f"{tuple(wq.shape)} {wq.dtype}")
    if sw.shape != (d,) or sw.dtype != torch.float32 or not sw.is_contiguous():
        raise ValueError(f"sw must be contiguous ({d},) float32, got "
                         f"{tuple(sw.shape)} {sw.dtype}")
    if out.shape != (m, d) or out.dtype != x2.dtype or not out.is_contiguous():
        raise ValueError(f"out must be contiguous ({m}, {d}) {x2.dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if not kernel_fits(n, epi.mode):
        raise ValueError(f"quant_dot kernel cannot take n={n} in {epi.mode}")
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    rc = _lib().quant_dot_launch(
        x2.data_ptr(), wq.data_ptr(), sw.data_ptr(), out.data_ptr(), m, n, d,
        plan.r, DTYPE_CODES[x2.dtype], DTYPE_CODES[torch_dtype(plan.compute_dtype)],
        scale_in_compute_dtype(plan), MODE_CODES[epi.mode], stream)
    if rc != 0:
        raise RuntimeError(f"quant_dot kernel launch failed: CUDA error {rc}")
    quant_dot_cuda.launches += 1
    return out


quant_dot_cuda.launches = 0


def quant_dot_plain(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                    plan) -> torch.Tensor:
    """K4's plain PyTorch version (the reference's ``xla_quant_dot``): K1's
    plain passes in the compute dtype, per-token ``_quantize_rows`` of the
    f32 copy, then ``epilogue_dot`` against ``wq`` (n, d) and ``sw``.
    Returns (..., d) in x's dtype."""
    from repro_torch.kernels.hadacore import transform_plain

    mode = plan.epilogue.mode
    y = transform_plain(x.to(torch_dtype(plan.compute_dtype)), plan)
    q, s = _quantize_rows(y.to(torch.float32), mode)
    d = wq.shape[-1]
    return epilogue_dot(q, s, wq, sw.reshape(1, d), mode, x.dtype)


def quant_dot(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, plan,
              schedule=None) -> torch.Tensor:
    """Rotate x's last axis (== plan.p), quantize per token and contract
    with ``wq`` (n, d): the plain version for a CPU tensor, the kernel for
    a CUDA tensor. ``schedule`` must resolve to ``rotate_once``."""
    _resolve_schedule(schedule)
    if x.device.type == "cpu":
        return quant_dot_plain(x, wq, sw, plan)
    if x.device.type != "cuda":
        raise ValueError(f"quant_dot runs on CPU or CUDA tensors, got {x.device}")
    d = wq.shape[-1]
    x2 = x.contiguous().view(-1, plan.p)
    out = torch.empty((x2.shape[0], d), dtype=x.dtype, device=x.device)
    quant_dot_cuda(x2, wq.contiguous(), sw.reshape(d).to(torch.float32).contiguous(),
                   out, plan)
    return out.view(*x.shape[:-1], d)
