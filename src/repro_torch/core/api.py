"""Plan-based Hadamard API: one entry point for every transform (twin of
``repro.core.api``).

``plan_for`` builds (and caches) a :class:`HadamardPlan` per
``(n, dtype, compute_dtype, backend, epilogue, scale, device type, mesh
axes)``: the
128-factorization, the stacked base matrices with the scale folded into
pass 0, and the backend resolved from the registry. ``hadamard(x, plan)``
dispatches:

  * ``epilogue=None``                        -> the rotated tensor
  * ``QuantEpilogue(mode)``                  -> ``(q, scales)``
  * ``QuantEpilogue(mode, dequant=True)``    -> the fake-quantized rotated
                                                tensor (K2 on the card)

Non-power-of-2 sizes run the grouped transform I_g (x) H_p on the largest
power-of-2 divisor p; epilogue scales then span the full token row and are
computed outside the kernel, as in the reference.

``quant_dot(x, w)`` is the quantized GEMM consumer: rotate, per-token
quantize and contract with an int8 / fp8 weight, as one K4 (or, streamed,
K5) launch on the card when the plan fuses (``_qd_fusable``: a power-of-2
size, per-token scales, a backend hosting ``quant_dot``, and the kernel's
shared-memory rule), else the unfused path (rotation, quantize,
``epilogue_dot``). ``quant_dot_experts(x, w)`` is its MoE form,
``(..., E, c, n) x (E, n, d)`` with per-(expert, out-channel) scales: one
K6 (or K6s) launch over every expert when the plan fuses
(``_qd_experts_fusable``), else the einsum form.

Declarative sites: :class:`RotationSpec` (attention Q/K/V) and
:class:`QuantDotSpec` (the down-projection consumer, bound to a weight
with ``bind``, or to a stacked expert weight with ``bind_experts``).

Meshes (``distributed.sharding``): a consumer site's ``weight_axes`` (e.g.
``("dff", "fsdp")``) resolve, under an active mesh, to the mesh axes its
weight's out-channels split over (``_resolve_mesh_axes``); they key the
plan (``HadamardPlan.mesh_axes``), and such a plan dispatches through
``_sharded_quant_dot``: this rank's rows (the batch axes the weight does
not use), its columns of the weight and their scales, the contraction
whole; the fused kernel (K4, or K5 streamed) runs shard-locally when the
mesh-stripped plan fuses, else the unfused path, counted and warned
(``unfused_local``); the result is assembled with all_gathers over the
column and row groups, bitwise the single-device int8 output. The fallbacks
``mesh_mismatch`` and ``unshardable_site`` are counted and warned the same
way (``registry.TRACE_COUNTS[("sharded_quant_dot", reason)]``). The expert
form takes no mesh axes: under the port's mesh each rank computes its own
rows, so K6 / K6s run there as they run off a mesh.

Gradients: the reference's nine ``custom_vjp``s are ``torch.autograd.
Function``s around the same forwards. The transform is self-adjoint (its
backward is the transform); the fused epilogues and both quant_dot forms
are straight-through: the backward of quantize(rotate(x)) is the rotation
(of g / s for the (q, s) form; int8 q carries no gradient, so x gets
zeros), the pre-quantized forms give x ``rotate(g @ W^T)`` and the weight
none, and the raw-weight forms also give ``gw = rotate(x)^T g`` (on the
card: K1 twice per call, for gx and for y).

ABFT (``REPRO_ABFT=1`` or ``QuantConfig.abft``): a consumer site whose
weight carries its column checksum runs the verified twin
(``_abft_quant_dot_impl``, ``_abft_quant_dot_experts_impl``: K7a-ro /
K7a-s / K7b / K7b-s on the card) and NaN-poisons every row whose residual
exceeds the tolerance, by an exact select: a healthy run is bitwise the
unverified one, and a tripped row reaches the serving step's logits
guard. A pure-rotation ``RotationSpec`` site is held to
``hadamard_check``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.hadamard import (base_matrices_np, dtype_name, factorize,
                                       largest_pow2_divisor,
                                       resolve_compute_dtype, resolve_scale,
                                       torch_dtype)
from repro_torch.kernels import registry
from repro_torch.kernels.ref import is_pow2
from repro_torch.kernels.registry import QSPECS, get_backend, select_backend

__all__ = [
    "QuantEpilogue",
    "HadamardPlan",
    "QuantDotSpec",
    "RotationSpec",
    "plan_for",
    "hadamard",
    "quant_dot",
    "quant_dot_experts",
    "plan_cache_info",
]


@dataclasses.dataclass(frozen=True)
class QuantEpilogue:
    """Quantization applied to the rotated tensor before write-back.

    mode:      'int8' | 'fp8_e4m3' | 'fp8_e5m2'
    per_token: one symmetric absmax scale per (full-length) token row;
               False = one scale per tensor
    dequant:   return the fake-quantized tensor in the input dtype instead
               of ``(q, scales)``
    """

    mode: str
    per_token: bool = True
    dequant: bool = False

    def __post_init__(self):
        if self.mode not in QSPECS:
            raise ValueError(
                f"unknown quantization mode {self.mode!r}; "
                f"expected one of {sorted(QSPECS)}")


@dataclasses.dataclass(frozen=True)
class HadamardPlan:
    """Everything shape-dependent about one Hadamard configuration,
    computed once and cached (the base matrices are excluded from
    eq/hash)."""

    n: int                           # full last-axis size
    p: int                           # per-group pow2 transform size (== n when pow2)
    dtype: str                       # canonical io dtype name
    compute_dtype: str               # dtype the passes round to
    backend: str                     # resolved registry backend name
    scale: Optional[float]           # scale folded into pass 0 (None = +-1)
    epilogue: Optional[QuantEpilogue]
    k: int                           # number of 128-factors of p
    r: int                           # residual pow2 factor (1 <= r < 128)
    device_type: str                 # 'cuda' or 'cpu': part of the key
    mesh_axes: Optional[Tuple[str, ...]] = None
                                     # mesh axes a quant_dot weight's out-
                                     # channels split over: part of the key,
                                     # so plans built under a mesh never
                                     # alias single-device plans
    mats: np.ndarray = dataclasses.field(repr=False, compare=False, default=None)

    @property
    def grouped(self) -> bool:
        return self.p != self.n

    @property
    def num_passes(self) -> int:
        return 0 if self.p == 1 else int(self.mats.shape[0])


@functools.lru_cache(maxsize=None)
def _build_plan(n, p, dtype_name_, compute_dtype, scale_val, backend, epilogue,
                device_type, mesh_axes=None):
    if p == 1:
        k, r, mats = 0, 1, np.ones((1, 1, 1), np.float32)
    else:
        k, r = factorize(p)
        mats = np.stack(base_matrices_np(p, scale_val))
    return HadamardPlan(
        n=n, p=p, dtype=dtype_name_, compute_dtype=compute_dtype,
        backend=backend, scale=scale_val, epilogue=epilogue, k=k, r=r,
        device_type=device_type, mesh_axes=mesh_axes, mats=mats)


def plan_for(
    n: int,
    *,
    dtype: Any = torch.float32,
    scale: Union[str, float, None] = "ortho",
    backend: Optional[str] = None,
    epilogue: Optional[QuantEpilogue] = None,
    compute_dtype: Any = None,
    device_type: str = "cuda",
    mesh_axes: Optional[Tuple[str, ...]] = None,
) -> HadamardPlan:
    """Build (or fetch from the cache) the plan for an n-point transform
    of tensors on ``device_type``. ``backend=None`` resolves through the
    registry (``REPRO_HADAMARD_BACKEND``, then auto: the kernels on
    'cuda', the plain versions on 'cpu'). ``mesh_axes`` marks a quant_dot
    plan as sharded over those mesh axes (its weight's out-channels).
    Repeated calls with the same key return the same plan object."""
    if n < 1:
        raise ValueError(f"Hadamard size must be >= 1, got {n}")
    p = n if is_pow2(n) else largest_pow2_divisor(n)
    scale_val = resolve_scale(scale, p)
    resolved = select_backend(p, backend, device_type)
    return _build_plan(n, p, dtype_name(dtype),
                       resolve_compute_dtype(dtype, compute_dtype), scale_val,
                       resolved, epilogue, device_type, mesh_axes)


def plan_cache_info():
    """Plan-cache statistics (functools.lru_cache CacheInfo)."""
    return _build_plan.cache_info()


def _strip(plan: HadamardPlan) -> HadamardPlan:
    """The epilogue-free twin of a plan; mesh axes are dropped too (the
    plain transform never shards)."""
    if plan.epilogue is None and plan.mesh_axes is None:
        return plan
    return _build_plan(plan.n, plan.p, plan.dtype, plan.compute_dtype,
                       plan.scale, plan.backend, None, plan.device_type)


# -------------------------------------------------------------- dispatch
def _group(x: torch.Tensor, plan: HadamardPlan) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], plan.n // plan.p, plan.p)


def _dispatch_transform(x: torch.Tensor, plan: HadamardPlan) -> torch.Tensor:
    if plan.p == 1:
        if plan.scale is None:
            return x
        return x * torch.tensor(plan.scale, dtype=x.dtype, device=x.device)
    be = get_backend(plan.backend)
    if plan.grouped:
        return be.transform(_group(x, plan), plan).reshape(x.shape)
    return be.transform(x, plan)


def _apply_epilogue_torch(y, epi: QuantEpilogue, out_dtype):
    """The epilogue on an already-rotated tensor (the reference's
    ``_apply_epilogue_xla``): backends without a fused path, per-tensor
    scales, and grouped transforms whose scale spans the full row."""
    q, s = registry._quantize_rows(
        y.to(torch.float32), epi.mode, axis=-1 if epi.per_token else None)
    if epi.dequant:
        return registry._dequantize(q, s, epi.mode).to(out_dtype)
    return registry.cast_to(q, QSPECS[epi.mode][1]), s


def _fusable(plan: HadamardPlan) -> bool:
    """Can the epilogue run inside the backend's kernel (K3 for (q, scales),
    K2 for a dequant epilogue)? Grouped sizes and per-tensor scales need the
    full row or tensor, so they run transform + plain epilogue."""
    be = get_backend(plan.backend)
    kernel = be.fused_dequant if plan.epilogue.dequant else be.fused
    return (not plan.grouped and plan.p > 1 and plan.epilogue.per_token
            and kernel is not None and be.supports(plan.p))


def _dispatch_fused(x, plan: HadamardPlan):
    if _fusable(plan):
        return get_backend(plan.backend).fused(x, plan)
    y = _dispatch_transform(x, _strip(plan))
    return _apply_epilogue_torch(y, plan.epilogue, x.dtype)


def _dispatch_fused_dequant(x, plan: HadamardPlan):
    if _fusable(plan):
        return get_backend(plan.backend).fused_dequant(x, plan)
    y = _dispatch_transform(x, _strip(plan))
    return _apply_epilogue_torch(y, plan.epilogue, x.dtype)


# --------------------------------------------------------------- autograd
class _Transform(torch.autograd.Function):
    """The rotation: H^T = H and the scale is scalar, so the op is
    self-adjoint (``_transform`` of the reference)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _dispatch_transform(x, plan)

    @staticmethod
    def backward(ctx, g):
        return _dispatch_transform(g.contiguous(), ctx.plan), None


class _Fused(torch.autograd.Function):
    """The (q, scales) epilogue with a straight-through backward: q =
    had(x) / s with s a statistic, so the pullback of gq is had(gq / s) and
    the scales contribute nothing. int8 q is integer-typed and carries no
    gradient: x then gets zeros in its dtype (``_fused`` of the reference,
    whose int8 cotangent is float0)."""

    @staticmethod
    def forward(ctx, x, plan):
        q, s = _dispatch_fused(x, plan)
        ctx.plan = plan
        ctx.x_meta = (x.shape, x.dtype)
        if not q.is_floating_point():
            ctx.mark_non_differentiable(q)
        ctx.save_for_backward(s)
        return q, s

    @staticmethod
    def backward(ctx, gq, _gs):
        (s,) = ctx.saved_tensors
        shape, dtype = ctx.x_meta
        if not QSPECS[ctx.plan.epilogue.mode][1].is_floating_point or gq is None:
            return torch.zeros(shape, dtype=dtype, device=s.device), None
        gy = gq.to(torch.float32) / s
        return _dispatch_transform(gy.contiguous(), _strip(ctx.plan)).to(dtype), None


class _FusedDequant(torch.autograd.Function):
    """Quantize-dequantize of the rotation, straight-through: the backward
    is the plain rotation (``_fused_dequant``; the raw fake-quant gradient,
    round()'s, is zero almost everywhere)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _dispatch_fused_dequant(x, plan)

    @staticmethod
    def backward(ctx, g):
        return _dispatch_transform(g.contiguous(), _strip(ctx.plan)), None


def _ste_gx(g, W, plan, spec: str):
    """x's straight-through gradient of a quant_dot against the f32 weight
    ``W``: the rotation of ``g @ W^T`` (``spec`` the einsum for experts),
    in the plan's dtype."""
    gf = g.to(torch.float32)
    if spec:
        gy = torch.einsum(spec, gf, W)
    else:
        gy = torch.matmul(gf, W.T)
    return _dispatch_transform(gy.to(torch_dtype(plan.dtype)).contiguous(), _strip(plan))


class _QuantDotQW(torch.autograd.Function):
    """The serving form (``_quant_dot_qw``): pre-quantized weight,
    differentiable in x only; the weight and its scales are statistics.
    ``cols_local``: the weight is this rank's column shard (serving under
    a mesh; no backward)."""

    @staticmethod
    def forward(ctx, x, wq, sw, plan, schedule, cols_local=False):
        ctx.plan, ctx.cols_local = plan, cols_local
        ctx.save_for_backward(wq, sw)
        return _dispatch_quant_dot(x, wq, sw, plan, schedule, cols_local)

    @staticmethod
    def backward(ctx, g):
        if ctx.cols_local:
            raise NotImplementedError("x's gradient through a column shard of a "
                                      "pre-quantized weight")
        wq, sw = ctx.saved_tensors
        W = wq.to(torch.float32) * sw
        return _ste_gx(g, W, ctx.plan, ""), None, None, None, None, None


class _QuantDotQWAbft(torch.autograd.Function):
    """ABFT twin of ``_QuantDotQW`` (``_quant_dot_qw_abft``): the verified
    forward, the same straight-through backward; ``cw`` is a statistic."""

    @staticmethod
    def forward(ctx, x, wq, sw, cw, plan, schedule):
        ctx.plan = plan
        ctx.save_for_backward(wq, sw)
        return _abft_quant_dot_impl(x, wq, sw, cw, plan, schedule)

    @staticmethod
    def backward(ctx, g):
        wq, sw = ctx.saved_tensors
        W = wq.to(torch.float32) * sw
        return _ste_gx(g, W, ctx.plan, ""), None, None, None, None, None


class _QuantDotW(torch.autograd.Function):
    """The training form (``_quant_dot_w``): a full-precision weight,
    quantized per out-channel on the fly; straight-through in both
    operands: out ~= had(x) @ w, so gx = had(g @ w^T) and gw = had(x)^T g,
    f32 products, gw cast to w's dtype."""

    @staticmethod
    def forward(ctx, x, w, plan, schedule):
        from repro_torch.core.wquant import quantize_weight

        ctx.plan = plan
        ctx.save_for_backward(x, w)
        qt = quantize_weight(w, plan.epilogue.mode)
        return _dispatch_quant_dot(x, qt.q, qt.scale, plan, schedule)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = _ste_gx(g, w.to(torch.float32), ctx.plan, "")
        y = _dispatch_transform(x.contiguous(), _strip(ctx.plan))
        gf = g.to(torch.float32)
        gw = torch.matmul(y.reshape(-1, y.shape[-1]).to(torch.float32).T,
                          gf.reshape(-1, gf.shape[-1]))
        return gx, gw.to(w.dtype), None, None


class _QuantDotExpertsQW(torch.autograd.Function):
    """The serving expert form (``_quant_dot_experts_qw``): pre-quantized
    stacked weights, differentiable in x only."""

    @staticmethod
    def forward(ctx, x, wq, sw, plan, schedule):
        ctx.plan = plan
        ctx.save_for_backward(wq, sw)
        return _quant_dot_experts_qw(x, wq, sw, plan, schedule)

    @staticmethod
    def backward(ctx, g):
        wq, sw = ctx.saved_tensors
        W = wq.to(torch.float32) * sw                      # (E, f, d)
        return _ste_gx(g, W, ctx.plan, "...ecd,efd->...ecf"), None, None, None, None


class _QuantDotExpertsQWAbft(torch.autograd.Function):
    """ABFT twin of ``_QuantDotExpertsQW`` (``_quant_dot_experts_qw_abft``)."""

    @staticmethod
    def forward(ctx, x, wq, sw, cw, plan, schedule):
        ctx.plan = plan
        ctx.save_for_backward(wq, sw)
        return _abft_quant_dot_experts_impl(x, wq, sw, cw, plan, schedule)

    @staticmethod
    def backward(ctx, g):
        wq, sw = ctx.saved_tensors
        W = wq.to(torch.float32) * sw
        return (_ste_gx(g, W, ctx.plan, "...ecd,efd->...ecf"),
                None, None, None, None, None)


class _QuantDotExpertsW(torch.autograd.Function):
    """The training expert form (``_quant_dot_experts_w``): raw (E, f, d)
    weights quantized per (expert, out-channel) on the fly; straight-
    through in both operands."""

    @staticmethod
    def forward(ctx, x, w, plan, schedule):
        from repro_torch.core.wquant import quantize_weight

        ctx.plan = plan
        ctx.save_for_backward(x, w)
        qt = quantize_weight(w, plan.epilogue.mode)
        return _quant_dot_experts_qw(x, qt.q, qt.scale, plan, schedule)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.to(torch.float32)
        gx = _ste_gx(g, w.to(torch.float32), ctx.plan, "...ecd,efd->...ecf")
        y = _dispatch_transform(x.contiguous(), _strip(ctx.plan))
        gw = torch.einsum("becf,becd->efd",
                          y.reshape(-1, *y.shape[-3:]).to(torch.float32),
                          gf.reshape(-1, *gf.shape[-3:]))
        return gx, gw.to(w.dtype), None, None


_UNSET = object()  # distinguishes "not passed" from an explicit default


def hadamard(
    x: torch.Tensor,
    plan: Optional[HadamardPlan] = None,
    *,
    scale: Union[str, float, None] = _UNSET,
    backend: Optional[str] = _UNSET,
    epilogue: Optional[QuantEpilogue] = _UNSET,
    compute_dtype: Any = _UNSET,
):
    """Walsh-Hadamard transform of the last axis -- THE entry point. With
    ``plan=None`` a plan is built from the keywords and ``x`` (shape,
    dtype, device type); an explicit plan pins all of that, and passing
    configuration keywords beside it raises."""
    n = x.shape[-1]
    if plan is None:
        plan = plan_for(
            n, dtype=x.dtype,
            scale="ortho" if scale is _UNSET else scale,
            backend=None if backend is _UNSET else backend,
            epilogue=None if epilogue is _UNSET else epilogue,
            compute_dtype=None if compute_dtype is _UNSET else compute_dtype,
            device_type=x.device.type)
    else:
        passed = [name for name, v in (("scale", scale), ("backend", backend),
                                       ("epilogue", epilogue),
                                       ("compute_dtype", compute_dtype))
                  if v is not _UNSET]
        if passed:
            raise ValueError(
                f"hadamard() got both an explicit plan and {passed}; plan "
                "configuration is fixed at plan_for() time")
        if plan.n != n:
            raise ValueError(
                f"plan was built for n={plan.n} but x has last axis {n}")
        if torch_dtype(plan.dtype) != x.dtype:
            raise ValueError(
                f"plan was built for dtype {plan.dtype} but x is "
                f"{dtype_name(x.dtype)}")
    if plan.epilogue is None:
        return _Transform.apply(x, plan)
    if plan.epilogue.dequant:
        return _FusedDequant.apply(x, plan)
    return _Fused.apply(x, plan)


# ------------------------------------------------------- quantized GEMM
def _qd_fusable(plan: HadamardPlan, schedule: str = "rotate_once") -> bool:
    """Can rotate + quantize + GEMM run as the backend's single kernel? As
    ``_fusable``, plus the backend must host ``quant_dot`` and the size must
    meet the shared-memory rule of the schedule's kernel
    (``kernels.quant_dot.kernel_fits``: one row's operand, work area and,
    streamed, weight ring within the 227 KB per-block limit; it stands
    where the reference tests its TPU VMEM budget)."""
    from repro_torch.kernels.quant_dot import kernel_fits

    be = get_backend(plan.backend)
    return (not plan.grouped and plan.p > 1 and plan.epilogue.per_token
            and be.quant_dot is not None and be.supports(plan.p)
            and kernel_fits(plan.p, plan.epilogue.mode, schedule))


def _dispatch_quant_dot(x, wq, sw, plan: HadamardPlan, schedule=None,
                        cols_local: bool = False):
    """rotate(x) -> per-token quantize -> contract against the offline-
    quantized weight with ``scale_x * scale_w`` in the epilogue: the
    backend's single kernel (K4, or K5 streamed, on the card) when the plan
    fuses, else the unfused path (grouped transforms, per-tensor scales).
    Decided from the plan, as the reference decides it; the two agree
    bitwise for int8. A mesh plan goes through ``_sharded_quant_dot``
    (``cols_local``: ``wq`` / ``sw`` are already this rank's columns);
    when it cannot, the replicated path runs, counted and warned."""
    from repro_torch.kernels.quant_dot import _resolve_schedule

    if plan.mesh_axes and wq.ndim == 2 and plan.epilogue.per_token:
        out = _sharded_quant_dot(x, wq, sw, plan, schedule, cols_local)
        if out is not None:
            return out
        _sharded_fallback(
            "mesh_mismatch",
            f"plan was built for mesh axes {plan.mesh_axes} but the current "
            "mesh does not provide them; quant_dot runs the replicated "
            "single-device path")
    elif plan.mesh_axes:
        _sharded_fallback(
            "unshardable_site",
            f"plan carries mesh axes {plan.mesh_axes} but the site cannot "
            "shard (needs a 2-D weight and per-token scales; got "
            f"wq.ndim={wq.ndim}, per_token={plan.epilogue.per_token}); "
            "quant_dot runs the replicated single-device path")
    if cols_local:
        raise ValueError("a column shard of a weight runs only through the "
                         "sharded quant_dot of its own mesh")
    if _qd_fusable(plan, _resolve_schedule(schedule)):
        return get_backend(plan.backend).quant_dot(x, wq, sw, plan, schedule)
    return _unfused_quant_dot(x, wq, sw, plan)


# ------------------------------------------------------------ on a mesh
def _resolve_mesh_axes(weight_axes, d: Optional[int]) -> Optional[Tuple[str, ...]]:
    """A weight's logical out-channel axis -> the mesh axes the sharded
    quant_dot splits its columns over. None (a single-device plan) when no
    mesh is active, the axis maps to nothing, the mapped axes' total size
    is 1, or it does not divide ``d`` (``distributed.sharding``'s guard)."""
    if not weight_axes or d is None:
        return None
    from repro_torch.distributed.sharding import _resolve_axis, _sizes, current_mesh

    mesh = current_mesh()
    if mesh is None:
        return None
    ax = _resolve_axis(mesh, weight_axes[-1])
    if ax is None:
        return None
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    sizes = _sizes(mesh)
    total = 1
    for a in axes:
        total *= sizes[a]
    if total <= 1 or d % total:
        return None
    return axes


# The last sharded dispatch's decision (whether the shard-local compute was
# the fused kernel, the row and column axes, the backend): an observation
# hook for tests, not an API.
_LAST_SHARDED_DISPATCH: dict = {}


def _sharded_fallback(reason: str, msg: str) -> None:
    """Count ``TRACE_COUNTS[("sharded_quant_dot", reason)]`` and warn once
    per process per reason (``registry.warn_once``): a mesh plan that
    leaves the sharded or fused path stays observable."""
    registry.warn_once(
        ("sharded_quant_dot", reason),
        f"sharded quant_dot fallback [{reason}]: {msg} (warned once per "
        "process; TRACE_COUNTS[('sharded_quant_dot', "
        f"{reason!r})] keeps counting)")


def _strip_mesh(plan: HadamardPlan) -> HadamardPlan:
    """The single-device twin of a mesh plan: the plan the shard-local
    compute runs."""
    if plan.mesh_axes is None:
        return plan
    return _build_plan(plan.n, plan.p, plan.dtype, plan.compute_dtype, plan.scale,
                       plan.backend, plan.epilogue, plan.device_type)


def _row_shard_axes(mesh, plan: HadamardPlan, m: int) -> Tuple[str, ...]:
    """The mesh axes the sharded quant_dot splits the activation's ``m``
    rows over: the rules' 'batch' axes, minus those the weight's columns
    use, minus any whose running size does not divide ``m``. Size-1 axes
    are kept."""
    from repro_torch.distributed.sharding import _resolve_axis, _sizes

    ax = _resolve_axis(mesh, "batch")
    if ax is None:
        return ()
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    sizes = _sizes(mesh)
    keep, total = [], 1
    for a in axes:
        if a in plan.mesh_axes:
            continue
        if m % (total * sizes[a]) == 0:
            keep.append(a)
            total *= sizes[a]
    return tuple(keep)


def _sharded_quant_dot(x, wq, sw, plan: HadamardPlan, schedule=None,
                       cols_local: bool = False):
    """quant_dot over the current mesh, each rank one block of the output:

      * rows: the activation's rows split over ``_row_shard_axes`` (the
        batch axes the weight does not use), so each rank rotates and
        quantizes only its rows. ``x`` holds the rows
        ``distributed.sharding.row_axes()`` gives this rank (all of them
        off a step's row split); rows it lacks are gathered first, and
        its own are cut from the result last;
      * columns: this rank's slice of the weight's out-channels over
        ``plan.mesh_axes`` and the same slice of the per-channel scales
        (``cols_local``: ``wq`` / ``sw`` are that slice already), so
        per-shard scales are used end to end; the contraction is never
        split (the Hadamard spans it);
      * compute: the backend's fused kernel when the mesh-stripped plan
        fuses (K4, or K5 under 'streamed', on the card), else the
        unfused path (grouped sizes, the torch backend), counted and
        warned as ``unfused_local``;
      * assembly: all_gather over the column group, then over the row
        group. Every output element is computed as the single-device
        call computes it, so the result is bitwise its int8 output.

    Returns None when the current mesh lacks the plan's axes (the caller
    records ``mesh_mismatch``)."""
    from repro_torch.distributed.sharding import current_mesh, row_axes
    from repro_torch.kernels.quant_dot import _resolve_schedule

    mesh = current_mesh()
    if mesh is None or any(a not in mesh.axis_names for a in plan.mesh_axes):
        return None
    local_plan = _strip_mesh(plan)
    lead, n = x.shape[:-1], plan.n
    x2 = x.reshape(-1, n)
    have = row_axes()
    rows = _row_shard_axes(mesh, plan, x2.shape[0] * mesh.group_size(have))
    be = get_backend(local_plan.backend)
    fused = (_qd_fusable(local_plan, _resolve_schedule(schedule))
             and be.quant_dot_fused)
    _LAST_SHARDED_DISPATCH.update(fused=fused, row_axes=rows,
                                  mesh_axes=plan.mesh_axes,
                                  backend=local_plan.backend)
    if have != rows:
        x2 = mesh.chunk(mesh.gather(x2, have, 0), rows, 0)
    if cols_local:
        wl, sl = wq, sw.reshape(1, -1)
    else:
        wl = mesh.chunk(wq, plan.mesh_axes, 1)
        sl = mesh.chunk(sw.reshape(1, -1), plan.mesh_axes, 1)
    if fused:
        out = be.quant_dot(x2.contiguous(), wl, sl, local_plan, schedule)
    else:
        _sharded_fallback(
            "unfused_local",
            f"shard-local compute for the n={plan.n} {plan.epilogue.mode} plan "
            f"runs the unfused path (backend {local_plan.backend!r}, "
            f"grouped={plan.grouped}); the fused kernel needs a backend that "
            "hosts it, a power-of-2 size it takes, and per-token scales")
        out = _unfused_quant_dot(x2, wl, sl, local_plan)
    out = mesh.gather(out, plan.mesh_axes, 1)
    if have != rows:
        out = mesh.chunk(mesh.gather(out, rows, 0), have, 0)
    return out.reshape(*lead, out.shape[-1])


def _unfused_quant_dot(x, wq, sw, plan: HadamardPlan):
    """The rotation, the epilogue outside any kernel and ``epilogue_dot``."""
    from repro_torch.kernels.quant_dot import epilogue_dot

    y = _dispatch_transform(x, _strip(plan))
    epi = plan.epilogue
    q, s = registry._quantize_rows(
        y.to(torch.float32), epi.mode, axis=-1 if epi.per_token else None)
    return epilogue_dot(q, s, wq, sw, epi.mode, x.dtype)


def _poison(y: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """y where ok, NaN elsewhere: an exact select."""
    return torch.where(ok, y, torch.full((), float("nan"), dtype=y.dtype,
                                         device=y.device))


def _shard_operands(w, plan: HadamardPlan):
    """(wq, sw, cols_local) of a QTensor for ``plan``: a column shard
    (``w.shard``) whose mesh axes are the plan's stays one; any other is
    gathered whole first."""
    if w.shard is None:
        return w.q, w.scale, False
    axes, _ = w.shard
    if plan.mesh_axes == axes:
        return w.q, w.scale, True
    from repro_torch.distributed.sharding import current_mesh

    mesh = current_mesh()
    return mesh.gather(w.q, axes, -1), mesh.gather(w.scale, axes, -1), False


def _abft_quant_dot_impl(x, wq, sw, cw, plan: HadamardPlan, schedule=None):
    """Checksum-verified quant_dot (forward only): a fusable plan runs the
    backend's verified kernel (K7a-ro, or K7a-s streamed, on the card; the
    plain ABFT version on the ``torch`` backend), which returns the output
    with its per-row residual; any other plan runs the unfused path and
    ``xla_quant_dot_resid``. Rows whose residual exceeds the tolerance
    become NaN."""
    from repro_torch import verify
    from repro_torch.kernels.quant_dot import _resolve_schedule, xla_quant_dot_resid

    registry.TRACE_COUNTS[("abft", "quant_dot_site")] += 1
    if _qd_fusable(plan, _resolve_schedule(schedule)):
        y, resid = get_backend(plan.backend).quant_dot(x, wq, sw, plan, schedule,
                                                       check=cw)
    else:
        y = _unfused_quant_dot(x, wq, sw, plan)
        resid = xla_quant_dot_resid(x, wq, sw, cw, plan)
    return _poison(y, verify.residual_ok(y, resid, n=wq.shape[0], d=wq.shape[-1]))


def _abft_quant_dot_experts_impl(x, wq, sw, cw, plan: HadamardPlan, schedule=None):
    """Checksum-verified expert consumer: the backend's verified expert
    kernel (K7b, or K7b-s streamed, on the card) returns a residual per
    (expert, row); failing rows become NaN. Callers check
    ``_qd_experts_fusable`` first: the einsum form has no residual."""
    from repro_torch import verify

    registry.TRACE_COUNTS[("abft", "quant_dot_experts_site")] += 1
    y, resid = get_backend(plan.backend).quant_dot_experts(x, wq, sw, plan, schedule,
                                                           check=cw)
    return _poison(y, verify.residual_ok(y, resid, n=wq.shape[1], d=wq.shape[-1]))


def quant_dot(
    x: torch.Tensor,
    w,
    plan: Optional[HadamardPlan] = None,
    *,
    mode: str = _UNSET,
    scale: Union[str, float, None] = _UNSET,
    backend: Optional[str] = _UNSET,
    compute_dtype: Any = _UNSET,
    weight_axes: Optional[Tuple] = _UNSET,
    schedule: Optional[str] = None,
) -> torch.Tensor:
    """``quantize(hadamard(x)) @ quantize(w)`` as one consumer path: the row
    is rotated, per-token quantized and contracted with the int8 / fp8
    weight, ``scale_x * scale_w`` applied in the epilogue -- one K4 launch
    on the card when the plan fuses. Differentiable (straight-through): in
    x for a QTensor, in x and w for a raw weight.

    ``w`` is a pre-quantized :class:`~repro_torch.core.wquant.QTensor` (the
    serving form, in the plan's mode) or a raw (n, d) weight, quantized per
    out-channel on the fly. ``plan=None`` builds the plan from the keywords
    and ``x`` (``mode`` defaults to 'int8'); an explicit plan must carry a
    non-dequant :class:`QuantEpilogue`, and configuration keywords beside it
    raise. ``schedule`` picks the kernel's grid schedule: None (then
    ``REPRO_QUANT_DOT_SCHEDULE``), 'rotate_once' (K4), 'streamed' (K5) or
    'revisit' (K8).

    ``weight_axes`` (the weight's logical axes, e.g. ``("dff", "fsdp")``)
    makes the call mesh-aware: under an active mesh the out-channel axis
    resolves to mesh axes, which key the plan, and the call runs the
    sharded quant_dot on the whole ``x`` and ``w`` given on every rank.
    Without a mesh it changes nothing."""
    from repro_torch.core.wquant import QTensor

    n = x.shape[-1]
    if plan is None:
        d_out = w.q.shape[-1] if isinstance(w, QTensor) else w.shape[-1]
        plan = plan_for(
            n, dtype=x.dtype,
            scale="ortho" if scale is _UNSET else scale,
            backend=None if backend is _UNSET else backend,
            epilogue=QuantEpilogue("int8" if mode is _UNSET else mode),
            compute_dtype=None if compute_dtype is _UNSET else compute_dtype,
            device_type=x.device.type,
            mesh_axes=_resolve_mesh_axes(
                None if weight_axes is _UNSET else weight_axes, d_out))
    else:
        passed = [name for name, v in (("mode", mode), ("scale", scale),
                                       ("backend", backend),
                                       ("compute_dtype", compute_dtype),
                                       ("weight_axes", weight_axes))
                  if v is not _UNSET]
        if passed:
            raise ValueError(
                f"quant_dot() got both an explicit plan and {passed}; plan "
                "configuration is fixed at plan_for() time")
        if plan.n != n:
            raise ValueError(
                f"plan was built for n={plan.n} but x has last axis {n}")
        if torch_dtype(plan.dtype) != x.dtype:
            raise ValueError(
                f"plan was built for dtype {plan.dtype} but x is "
                f"{dtype_name(x.dtype)}")
    if plan.epilogue is None or plan.epilogue.dequant:
        raise ValueError(
            "quant_dot requires a plan with a non-dequant QuantEpilogue (got "
            f"{plan.epilogue!r}); use plan_for(n, epilogue=QuantEpilogue(mode))")
    epi_mode = plan.epilogue.mode
    if isinstance(w, QTensor):
        if w.q.shape[0] != n:
            raise ValueError(f"quantized weight has contraction dim "
                             f"{w.q.shape[0]}, expected {n}")
        if w.mode != epi_mode:
            raise ValueError(
                f"pre-quantized weight is stored as {w.mode!r}, not the plan's "
                f"{epi_mode!r}; quantize with wquant.quantize_weight(w, mode)")
        wq, sw, cols_local = _shard_operands(w, plan)
        return _QuantDotQW.apply(x, wq, sw, plan, schedule, cols_local)
    if w.shape[0] != n:
        raise ValueError(f"weight has contraction dim {w.shape[0]}, expected {n}")
    return _QuantDotW.apply(x, w, plan, schedule)


# ---------------------------------------------------- expert consumers
def _qd_experts_fusable(plan: HadamardPlan, schedule: str = "rotate_once") -> bool:
    """Can the expert site run as the backend's single kernel over every
    expert (K6 / K6s on the card)? ``_qd_fusable`` plus a backend hosting
    ``quant_dot_experts``. The reference sends an active mesh to the einsum
    form, which GSPMD partitions; under the port's mesh each rank computes
    its own rows, so the kernel form stays (module docstring)."""
    return (_qd_fusable(plan, schedule)
            and get_backend(plan.backend).quant_dot_experts is not None)


def _experts_einsum_qw(x, wq, sw, plan: HadamardPlan):
    """The einsum form of the expert consumer: the (q, scales) epilogue on
    the activation side (all experts share d_ff, so one rotation), then the
    low-precision contraction per expert against the pre-quantized weights,
    ``acc * s * sw`` in that order. The scales factor out of each expert's
    product exactly (s per token row, sw per (expert, out-channel))."""
    from repro_torch.kernels.quant_dot import experts_epilogue_dot

    q, s = hadamard(x, plan)
    return experts_epilogue_dot(q.to(torch.float32), s, wq, sw,
                                plan.epilogue.mode, x.dtype)


def _quant_dot_experts_qw(x, wq, sw, plan: HadamardPlan, schedule=None):
    """Serving form for stacked, pre-quantized expert weights (forward
    only): the backend's single kernel over every expert when the plan
    fuses, else the einsum form (grouped sizes, backends without the
    expert kernel). ``schedule`` picks the kernel's schedule; the einsum
    form has none, so there it is only validated."""
    from repro_torch.kernels.quant_dot import _resolve_schedule

    if _qd_experts_fusable(plan, _resolve_schedule(schedule, experts=True)):
        return get_backend(plan.backend).quant_dot_experts(x, wq, sw, plan, schedule)
    return _experts_einsum_qw(x, wq, sw, plan)


def quant_dot_experts(x: torch.Tensor, w, plan: HadamardPlan,
                      schedule: Optional[str] = None) -> torch.Tensor:
    """Per-expert quant_dot, ``einsum('becf,efd->becd')`` semantics: the
    shared online Hadamard on the dispatched activations x (..., E, c, f)
    (all experts share d_ff) and real int8 / fp8 expert weights with
    per-(expert, out-channel) scales. ``w`` is a pre-quantized stacked
    :class:`~repro_torch.core.wquant.QTensor` (serving) or a raw (E, f, d)
    weight, quantized per (expert, out-channel) on the fly. Fusable plans
    run one K6 (streamed: K6s) launch on the card. Differentiable
    (straight-through): in x for a QTensor, in x and w for a raw weight."""
    from repro_torch.core.wquant import QTensor

    if plan.epilogue is None or plan.epilogue.dequant:
        raise ValueError("quant_dot_experts requires a plan with a non-dequant "
                         f"QuantEpilogue (got {plan.epilogue!r})")
    raw = not isinstance(w, QTensor)
    wshape = tuple(w.shape) if raw else tuple(w.q.shape)
    if not raw and w.mode != plan.epilogue.mode:
        raise ValueError(f"expert weights are stored as {w.mode!r}, not the "
                         f"plan's {plan.epilogue.mode!r}")
    if len(wshape) != 3 or wshape[1] != plan.n or x.shape[-1] != plan.n \
            or x.ndim < 3 or x.shape[-3] != wshape[0]:
        raise ValueError(f"expert form takes x (..., E, c, {plan.n}) and w (E, "
                         f"{plan.n}, d), got {tuple(x.shape)} and {wshape}")
    if raw:
        return _QuantDotExpertsW.apply(x, w, plan, schedule)
    return _QuantDotExpertsQW.apply(x, w.q, w.scale, plan, schedule)


def _cfg_backend_name(backend: str) -> Optional[str]:
    # "auto" defers to the registry (env override, then device and size)
    return None if backend == "auto" else backend


# --------------------------------------------- declarative rotation sites
@dataclasses.dataclass(frozen=True)
class RotationSpec:
    """An activation-only rotation site (the attention Q/K/V hook): rotate
    (unless ``rotate=False``, the V site whose rotation is fused offline)
    and, when ``mode`` is not 'none', fake-quantize -- as one K2 launch on
    the card when the plan fuses. Under ABFT (``abft`` or ``REPRO_ABFT``)
    a pure-rotation site (mode 'none') is held to ``hadamard_check`` and
    NaN-poisoned when it fails."""

    n: int
    mode: str = "none"
    rotate: bool = True
    per_token: bool = True
    dequant: bool = True
    scale: Union[str, float, None] = "ortho"
    backend: Optional[str] = None
    compute_dtype: Optional[str] = None
    abft: bool = False

    def __post_init__(self):
        if self.mode != "none" and self.mode not in QSPECS:
            raise ValueError(
                f"unknown quantization mode {self.mode!r}; expected 'none' "
                f"or one of {sorted(QSPECS)}")

    @classmethod
    def for_config(cls, n: int, cfg, *, rotate: Optional[bool] = None,
                   quantize: Optional[bool] = None,
                   per_token: bool = True) -> "RotationSpec":
        """The spec a QuantConfig implies for an n-point site: quantize by
        the KV-site rule (cfg.enabled and cfg.kv_quant) unless told,
        rotate when the config rotates unless told."""
        q = (cfg.enabled and cfg.kv_quant) if quantize is None else \
            (quantize and cfg.enabled)
        return cls(n=n, mode=cfg.mode if q else "none",
                   rotate=cfg.rotating if rotate is None else rotate,
                   per_token=per_token, backend=_cfg_backend_name(cfg.backend),
                   abft=bool(getattr(cfg, "abft", False)))

    def plan(self, dtype, device_type: str = "cuda") -> HadamardPlan:
        epi = None
        if self.mode != "none":
            epi = QuantEpilogue(self.mode, per_token=self.per_token,
                                dequant=self.dequant)
        return plan_for(self.n, dtype=dtype, scale=self.scale,
                        backend=self.backend, epilogue=epi,
                        compute_dtype=self.compute_dtype,
                        device_type=device_type)

    def __call__(self, x: torch.Tensor):
        if x.shape[-1] != self.n:
            raise ValueError(
                f"RotationSpec was built for n={self.n} but x has last "
                f"axis {x.shape[-1]}")
        if self.rotate:
            y = hadamard(x, self.plan(x.dtype, x.device.type))
            if self.mode == "none" and self._abft_verifying():
                from repro_torch.core.hadamard import hadamard_check

                registry.TRACE_COUNTS[("abft", "rotation_site")] += 1
                y = _poison(y, hadamard_check(x, y, scale=self.scale,
                                              compute_dtype=self.compute_dtype))
            return y
        if self.mode != "none":
            from repro_torch.core.quant import quantize

            return quantize(x, self.mode, axis=-1 if self.per_token else None)
        return x

    def _abft_verifying(self) -> bool:
        from repro_torch.verify.abft import abft_enabled

        return self.abft or abft_enabled()


@dataclasses.dataclass(frozen=True)
class QuantDotSpec:
    """A rotation-consumer site, ``x @ w`` with the online Hadamard on x's
    contraction axis and low-precision operands, bound to a weight with
    ``spec.bind(w)``: a raw weight is quantized per out-channel on the fly;
    a pre-quantized :class:`~repro_torch.core.wquant.QTensor` (serving) is
    contracted directly, with zero per-forward weight quantization.
    ``schedule`` pins the fused kernels' schedule (None: the env, then
    rotate-once); ``abft`` verifies the site when its weight carries a
    checksum (as does ``REPRO_ABFT``). ``weight_axes``, the weight's
    logical axes, make the bound call mesh-aware: under an active mesh the
    out-channel axis resolves to mesh axes, which key the plan, and the
    call runs the sharded quant_dot (module docstring)."""

    n: int
    mode: str = "int8"
    rotate: bool = True
    per_token: bool = True
    scale: Union[str, float, None] = "ortho"
    backend: Optional[str] = None
    compute_dtype: Optional[str] = None
    weight_axes: Optional[Tuple[Optional[str], ...]] = None
    schedule: Optional[str] = None
    abft: bool = False

    def __post_init__(self):
        if self.mode != "none" and self.mode not in QSPECS:
            raise ValueError(
                f"unknown quantization mode {self.mode!r}; expected 'none' "
                f"or one of {sorted(QSPECS)}")
        if self.schedule is not None:
            from repro_torch.kernels.quant_dot import SCHEDULES

            if self.schedule not in SCHEDULES:
                raise ValueError(f"unknown quant_dot schedule {self.schedule!r}; "
                                 f"expected one of {SCHEDULES}")

    @classmethod
    def for_config(cls, n: int, cfg, *,
                   weight_axes: Optional[Tuple] = None) -> "QuantDotSpec":
        """The spec a QuantConfig implies; ``cfg.schedule`` pins the kernels'
        schedule (the serving ladder's rungs rely on it)."""
        return cls(n=n, mode=cfg.mode, rotate=cfg.rotating,
                   per_token=cfg.per_token,
                   backend=_cfg_backend_name(cfg.backend),
                   weight_axes=weight_axes,
                   schedule=getattr(cfg, "schedule", None),
                   abft=bool(getattr(cfg, "abft", False)))

    def _abft_verifying(self, w) -> bool:
        """Verify this site? Needs both the stored checksum and the switch
        (the spec's ``abft`` or ``REPRO_ABFT``)."""
        from repro_torch.verify.abft import abft_enabled

        return getattr(w, "check", None) is not None and (self.abft or abft_enabled())

    @property
    def quantizing(self) -> bool:
        return self.mode != "none"

    def plan(self, dtype, device_type: str = "cuda",
             d: Optional[int] = None) -> HadamardPlan:
        """The quant_dot plan for io ``dtype`` and a weight of ``d`` out-
        channels, its mesh axes resolved against the current mesh."""
        return plan_for(self.n, dtype=dtype, scale=self.scale,
                        backend=self.backend,
                        epilogue=QuantEpilogue(self.mode,
                                               per_token=self.per_token),
                        compute_dtype=self.compute_dtype,
                        device_type=device_type,
                        mesh_axes=_resolve_mesh_axes(self.weight_axes, d))

    def _transform_plan(self, dtype, device_type: str) -> HadamardPlan:
        return plan_for(self.n, dtype=dtype, scale=self.scale,
                        backend=self.backend,
                        compute_dtype=self.compute_dtype,
                        device_type=device_type)

    def _coerce_weight(self, w):
        """The bound weight as the sites take it: a QTensor or a raw tensor
        passes through; a legacy ``(wq, sw)`` pre-quantized tuple is wrapped
        into a QTensor in the spec's mode, its storage dtype checked (the
        reference's ``_coerce_weight``). At a spec that does not quantize
        the tuple's mode is its storage dtype's, and the site dequantizes."""
        from repro_torch.core.wquant import QTensor

        if isinstance(w, QTensor) or not isinstance(w, tuple):
            return w
        wq, sw = w
        if self.quantizing:
            want_dt = QSPECS[self.mode][1]
            if wq.dtype != want_dt:
                raise ValueError(
                    f"pre-quantized weight dtype {wq.dtype} does not match the "
                    f"spec's {self.mode!r} storage dtype {want_dt}; quantize with "
                    "wquant.quantize_weight(w, mode)")
            return QTensor(wq, sw, self.mode)
        modes = [m for m, spec in QSPECS.items() if spec[1] == wq.dtype]
        if not modes:
            raise ValueError(f"pre-quantized weight dtype {wq.dtype} is no quantized "
                             f"storage dtype ({sorted(QSPECS)})")
        return QTensor(wq, sw, modes[0])

    def bind(self, w):
        """Bind the site to a weight (a QTensor, a raw tensor, or a legacy
        ``(wq, sw)`` tuple: ``_coerce_weight``); returns ``fn(x) -> (...,
        d)``."""
        from repro_torch.core.wquant import QTensor

        w = self._coerce_weight(w)
        if isinstance(w, QTensor):
            return functools.partial(self._apply_qtensor, w)
        return functools.partial(self._apply_raw, w)

    def __call__(self, x, w):
        return self.bind(w)(x)

    def _apply_qtensor(self, w, x):
        from repro_torch.kernels.quant_dot import epilogue_dot

        if not self.quantizing or w.mode != self.mode:
            # storage-only weight at a site that does not consume it
            # natively: dequantize (NOT re-quantize) and run raw
            return self._apply_raw(w.dequant(x.dtype), x)
        if self.rotate:
            plan = self.plan(x.dtype, x.device.type, d=w.cols)
            if self._abft_verifying(w):
                if plan.mesh_axes is None:
                    return _QuantDotQWAbft.apply(x, w.q, w.scale, w.check, plan,
                                                 self.schedule)
                registry.warn_once(
                    ("abft", "sharded_fallback"),
                    "ABFT checksums are present but the plan shards over mesh "
                    f"axes {plan.mesh_axes}; the sharded quant_dot has no "
                    "checksum output, so this site runs UNVERIFIED")
            wq, sw, cols_local = _shard_operands(w, plan)
            return _QuantDotQW.apply(x, wq, sw, plan, self.schedule, cols_local)
        q, s = registry._quantize_rows(
            x.to(torch.float32), self.mode,
            axis=-1 if self.per_token else None)
        return epilogue_dot(q, s, w.q, w.scale, self.mode, x.dtype)

    def bind_experts(self, w):
        """Bind the MoE expert form (``'becf,efd->becd'`` semantics, stacked
        expert weights sharing one d_ff Hadamard) to a stacked QTensor or a
        raw (E, f, d) weight (or a legacy ``(wq, sw)`` tuple:
        ``_coerce_weight``); returns ``fn(x) -> (..., E, c, d)``. Fusable
        plans run one K6 launch over every expert on the card."""
        from repro_torch.core.wquant import QTensor

        w = self._coerce_weight(w)
        if isinstance(w, QTensor):
            return functools.partial(self._apply_experts_qtensor, w)
        return functools.partial(self._apply_experts_raw, w)

    def _apply_experts_qtensor(self, w, x):
        if not self.quantizing or w.mode != self.mode:
            return self._apply_experts_raw(w.dequant(x.dtype), x)
        if self.rotate:
            plan = self.plan(x.dtype, x.device.type)
            if self._abft_verifying(w):
                from repro_torch.kernels.quant_dot import _resolve_schedule

                if _qd_experts_fusable(plan, _resolve_schedule(self.schedule,
                                                               experts=True)):
                    return _QuantDotExpertsQWAbft.apply(x, w.q, w.scale, w.check,
                                                        plan, self.schedule)
                registry.warn_once(
                    ("abft", "experts_einsum_fallback"),
                    "ABFT checksums are present but the expert site runs the "
                    "einsum form (a plan the expert kernel does not take), "
                    "which has no checksum output; it runs UNVERIFIED")
            return quant_dot_experts(x, w, plan, self.schedule)
        from repro_torch.core.quant import quantize

        xq = quantize(x, self.mode, axis=-1 if self.per_token else None)
        return torch.einsum("becf,efd->becd", xq, w.dequant(x.dtype)).to(x.dtype)

    def _apply_experts_raw(self, w, x):
        if not self.quantizing:
            if self.rotate:
                x = hadamard(x, self._transform_plan(x.dtype, x.device.type))
            return torch.einsum("becf,efd->becd", x, w)
        if not self.rotate:
            from repro_torch.core.quant import quantize

            xq = quantize(x, self.mode, axis=-1 if self.per_token else None)
            return torch.einsum("becf,efd->becd", xq,
                                quantize(w, self.mode, axis=-2))
        return quant_dot_experts(x, w, self.plan(x.dtype, x.device.type),
                                 self.schedule)

    def _apply_raw(self, w, x):
        if not self.quantizing:
            if self.rotate:
                return hadamard(x, self._transform_plan(
                    x.dtype, x.device.type)) @ w
            return x @ w
        if not self.rotate:
            from repro_torch.core.quant import QuantConfig
            from repro_torch.core.quant import quant_dot as _fake_quant_dot

            return _fake_quant_dot(
                x, w, QuantConfig(mode=self.mode, per_token=self.per_token))
        return _QuantDotW.apply(x, w, self.plan(x.dtype, x.device.type, d=w.shape[-1]),
                                self.schedule)
