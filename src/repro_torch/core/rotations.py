"""QuaRot-style rotation plumbing: offline weight fusion + online Hadamard
(twin of ``repro.core.rotations``).

The paper's kernel exists to make the *online* rotations cheap. This
module holds both halves:

offline (free at run time -- exact algebraic weight rewrites):
    ``rotation_matrix`` Q = D H (a random-sign diagonal times the
    orthonormal Walsh-Hadamard matrix, grouped I_g (x) H_p for sizes that
    are not powers of 2), applied with ``rotate_activation_in`` /
    ``fuse_rotation_rhs`` / ``fuse_rotation_lhs``; and
    ``fuse_down_proj_rotations``, which pre-rotates the rows of every
    down-projection weight so ``had(h) @ W' == h @ W``: the paper's
    post-training deployment of a model trained without rotations.

online (every token -- where HadaCore runs): ``online_hadamard`` rotates
    the last axis through the plan API (K1 on the card, grouped for
    llama3-8b's d_ff = 14336 = 7 x 2048).

The reference draws the signs from a ``jax.random`` key; the port takes a
``torch.Generator`` or an explicit +-1 ``signs`` tensor (the two random
streams differ, so a test hands both packages the same signs). The
deprecated ``QuantConfig``-threading consumers (``online_hadamard_quantize``,
``rotated_quant_dot``, ``rotated_quant_dot_experts``) are kept as shims over
the spec API; each warns once and ticks ``TRACE_COUNTS[("deprecated",
name)]`` on every call.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.api import QuantDotSpec, RotationSpec, hadamard, plan_for
from repro_torch.core.hadamard import largest_pow2_divisor
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels.ref import hadamard_matrix

__all__ = [
    "online_hadamard",
    "online_hadamard_quantize",
    "rotated_quant_dot",
    "rotated_quant_dot_experts",
    "rotation_matrix",
    "rotate_activation_in",
    "fuse_rotation_rhs",
    "fuse_rotation_lhs",
    "fuse_down_proj_rotations",
]


def _cfg_backend(cfg: QuantConfig):
    # "auto" defers to the registry (env override, then device and size)
    return None if cfg.backend == "auto" else cfg.backend


def online_hadamard(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Online orthonormal Hadamard rotation of the last axis: a plan lookup
    into :mod:`repro_torch.core.api` (the kernel on a CUDA tensor, the
    grouped transform I_g (x) H_p for sizes that are not powers of 2)."""
    if not cfg.rotating:
        return x
    plan = plan_for(x.shape[-1], dtype=x.dtype, backend=_cfg_backend(cfg),
                    device_type=x.device.type)
    return hadamard(x, plan)


# --------------------------------------------------------- DEPRECATED shims
# The QuantConfig-threading consumer entry points predate the declarative
# spec API and are kept only for backward compatibility: each builds the
# equivalent RotationSpec / QuantDotSpec and applies it. New code declares
# the site once and binds weights:
#
#     spec = QuantDotSpec.for_config(n, cfg)
#     y = spec.bind(w)(x)
#
def _warn_once(name: str, repl: str) -> None:
    # one DeprecationWarning per process per shim, counted every call in
    # TRACE_COUNTS[("deprecated", name)] (the registry's warn-once idiom)
    from repro_torch.kernels.registry import warn_once

    warn_once(("deprecated", name),
              f"repro_torch.core.rotations.{name} is deprecated; use {repl}",
              category=DeprecationWarning, stacklevel=4)


def online_hadamard_quantize(x: torch.Tensor, cfg: QuantConfig, *,
                             per_token: Optional[bool] = None) -> torch.Tensor:
    """DEPRECATED: use :class:`repro_torch.core.api.RotationSpec`.

    Online rotation + fake quantization of the last axis (one K2 launch on
    the card when the plan fuses), through the equivalent RotationSpec."""
    _warn_once("online_hadamard_quantize",
               "repro_torch.core.api.RotationSpec.for_config(n, cfg)(x)")
    pt = cfg.per_token if per_token is None else per_token
    spec = RotationSpec(n=x.shape[-1], mode=cfg.mode if cfg.enabled else "none",
                        rotate=cfg.rotating, per_token=pt, dequant=True,
                        backend=_cfg_backend(cfg))
    return spec(x)


def rotated_quant_dot(x: torch.Tensor, w, cfg: QuantConfig) -> torch.Tensor:
    """DEPRECATED: use :class:`repro_torch.core.api.QuantDotSpec`.

    ``x @ w`` with the online Hadamard on x's contraction axis and real
    low-precision operands (raw weight, or a pre-quantized QTensor)."""
    _warn_once("rotated_quant_dot",
               "repro_torch.core.api.QuantDotSpec.for_config(n, cfg).bind(w)(x)")
    return QuantDotSpec.for_config(x.shape[-1], cfg).bind(w)(x)


def rotated_quant_dot_experts(x: torch.Tensor, w, cfg: QuantConfig) -> torch.Tensor:
    """DEPRECATED: use :meth:`repro_torch.core.api.QuantDotSpec.bind_experts`.

    Per-expert ``rotated_quant_dot``: ``einsum('becf,efd->becd')`` with the
    shared online Hadamard on the dispatched activations."""
    _warn_once("rotated_quant_dot_experts",
               "repro_torch.core.api.QuantDotSpec.for_config(n, cfg).bind_experts(w)(x)")
    return QuantDotSpec.for_config(x.shape[-1], cfg).bind_experts(w)(x)


def rotation_matrix(n: int, generator: Optional[torch.Generator] = None, *,
                    signs: Optional[torch.Tensor] = None,
                    device="cpu") -> torch.Tensor:
    """Orthonormal rotation Q (n, n) f32 for offline fusion: Q = D H, D a
    random-sign diagonal and H the orthonormal Hadamard (QuaRot's
    randomized Hadamard); for n not a power of 2, H = I_g (x) H_p with p
    its largest power-of-2 divisor and D spanning the full size. The signs
    are ``signs`` (n,) +-1, or drawn from ``generator``; with neither, the
    plain (deterministic) Hadamard."""
    p = largest_pow2_divisor(n)
    Hp = hadamard_matrix(p, scale=1.0 / np.sqrt(p))
    H = np.kron(np.eye(n // p, dtype=np.float32), Hp) if p != n else Hp
    Q = torch.from_numpy(np.ascontiguousarray(H, dtype=np.float32)).to(device)
    if signs is None and generator is not None:
        signs = (torch.randint(0, 2, (n,), generator=generator,
                               device=generator.device) * 2 - 1).to(torch.float32)
    if signs is not None:
        if signs.shape != (n,):
            raise ValueError(f"signs must be ({n},), got {tuple(signs.shape)}")
        Q = signs.to(device=Q.device, dtype=torch.float32)[:, None] * Q
    return Q


def rotate_activation_in(x: torch.Tensor, Q: Optional[torch.Tensor]) -> torch.Tensor:
    """x <- x Q (activations live in rows; residual-stream rotation)."""
    if Q is None:
        return x
    return x @ Q


def fuse_rotation_rhs(w: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """W <- W Q for weights *writing* to the rotated stream.
    w: (..., d_in, d_out_rotated)."""
    return w @ Q


def fuse_rotation_lhs(w: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """W <- Q^T W for weights *reading* from the rotated stream.
    w: (d_in_rotated, ...); stacked (layers, d_in, d_out) too."""
    return torch.einsum("ij,...jk->...ik", Q.T, w)


def _rotate_rows_grouped(w: torch.Tensor) -> torch.Tensor:
    """W <- (I (x) H) W: the grouped orthonormal Hadamard along the row
    (contraction) axis, in f32, rounded back to w's dtype once. H is
    symmetric, so this is the exact inverse pairing of an online-rotated
    input. w: (..., d_in, d_out). The rows go through the plan API (K1 on a
    CUDA tensor), one 2-D slice at a time, so a stacked (E, n, d) expert
    weight never has a whole f32 copy."""
    if w.ndim > 2:
        return torch.stack([_rotate_rows_grouped(s) for s in w])
    wt = w.to(torch.float32).transpose(0, 1).contiguous()        # (d_out, d_in)
    plan = plan_for(wt.shape[-1], dtype=torch.float32, device_type=w.device.type)
    return hadamard(wt, plan).transpose(0, 1).to(w.dtype).contiguous()


def fuse_down_proj_rotations(params):
    """Offline half of the paper's online rotation: pre-rotate the rows of
    every down-projection weight so ``had(h) @ W' == h @ W`` exactly.

    Apply ONCE to a model trained WITHOUT rotations (the post-training
    quantization deployment of QuaRot and the paper); a model trained with
    rotations on learned the rotated basis and must not be fused again.
    Walks the whole parameter tree (dicts and per-layer lists, the
    encoder's ``enc_layers`` too, as the reference walks its whole tree) and
    rewrites every 'w_down' -- the dense MLP's, the encoder's, the MoE
    experts' stack and the shared expert's -- and the RWKV channel mix's
    'wv' where present;
    returns a new tree (other leaves shared). The weights must be raw:
    quantize after fusing."""
    from repro_torch.core.wquant import is_qleaf

    def fix(tree, keys):
        if isinstance(tree, dict):
            return {k: fix(v, keys + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fix(v, keys) for v in tree]
        if keys and (keys[-1] == "w_down" or (keys[-1] == "wv" and "cmix" in keys)):
            if is_qleaf(tree):
                raise ValueError(f"{'/'.join(keys)} is already quantized: fuse the "
                                 "rotations into the raw weights, then quantize")
            return _rotate_rows_grouped(tree)
        return tree

    return fix(params, ())
