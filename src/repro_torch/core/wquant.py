"""Quantized weight storage: ``QTensor`` (twin of ``repro.core.wquant``)
and the logical sharding of its parts (``qweight_specs``).

Matmul weights are stored quantized (int8 / fp8) with f32 per-output-
channel scales and dequantized per layer in the forward. The rotation-
consumer leaves (the down-projection weights the online Hadamard feeds,
dense or stacked per expert) are stored in the serving quant mode and
contracted directly by the ``QuantDotSpec`` site: the serving forward never
re-quantizes a weight.

Stacked expert weights (E, n, d) carry per-(expert, out-channel) scales
(E, 1, d). Quantization and dequantization are separable per expert, so
the port draws, quantizes and dequantizes such stacks a chunk of experts
at a time (``CHUNK_ELEMS``): an f32 copy of a whole 128-expert stack at
llama4-maverick's width would be 21.5 GB.

ABFT: a QTensor may carry ``check``, the column checksum of its
dequantized weight (``weight_checksum``), which the checksum-verified
quant_dot kernels and ``verify.params_ok`` hold the live weight against.
``quantize_weight(..., with_check=True)`` attaches it at quantization
time; ``quantize_lm_weights`` and ``init_lm`` do so under
``QuantConfig.abft`` or ``REPRO_ABFT=1``.

The size floor (``_MIN_SIZE`` values) applies to each layer's leaf here and
to the stacked (layers, ...) leaf in the reference. The two rules agree at
the scaled-down test sizes; at full width the reference also quantizes
these small leaves (int8, the port keeps them as drawn): rwkv6-7b's f32
``tmix`` ``mu_base``, ``mu``, ``w0``, ``u``, ``ln_scale``, ``ln_bias`` and
``cmix`` ``mu_r``, ``mu_k`` (32 layers stacked); zamba2-7b's bf16 mamba
``conv_x`` in both groups, and its f32 mamba ``norm`` in the 13-repeat
group only (13 x 7168 values pass the floor, 3 x 7168 do not).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.kernels.registry import QSPECS, _quantize_rows, cast_to

__all__ = ["QTensor", "quantize_weight", "quantize_lm_weights", "dequant_tree",
           "qweight_specs",
           "is_qleaf", "leaf_mode", "chunk_len", "weight_checksum",
           "QUANTIZE_WEIGHT_CALLS"]

_MIN_SIZE = 1 << 16   # don't quantize tiny leaves (norms, biases)

_FLOATS = (torch.bfloat16, torch.float16, torch.float32)

# Elements per chunk of a stacked leaf (2^28: 1 GiB of f32), for the
# chunked draw, quantization and dequantization of expert stacks.
CHUNK_ELEMS = 1 << 28

# Number of quantize_weight calls; serving tests reset it and assert it
# stays 0 while requests are served (pre-quantized weights only).
QUANTIZE_WEIGHT_CALLS: int = 0


class QTensor:
    """A quantized weight: ``q`` (..., n, d) storage-dtype values (int8 /
    fp8) and ``scale`` (..., 1, d) f32 absmax scales over the contraction
    axis; ``mode`` is 'int8' | 'fp8_e4m3' | 'fp8_e5m2', and ``q`` must be
    stored in that mode's dtype. ``check`` is None or the (..., 1, n) f32
    ABFT column checksum ``weight_checksum(q, scale)``: row k holds
    sum_d q[k, d] * scale[d], so ``sum_d (a @ W)[d] == a . check`` in real
    arithmetic for any activation row a. ``shard`` is None, or ``(axes,
    d)`` when ``q`` and ``scale`` hold only this rank's out-channels of a
    (n, d) weight split over the mesh axes ``axes`` (the sharded
    quant_dot's operand under a mesh)."""

    __slots__ = ("q", "scale", "mode", "check", "shard")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, mode: str = "int8",
                 check=None, shard=None):
        if q.dtype != QSPECS[mode][1]:
            raise ValueError(
                f"QTensor values are {q.dtype}, not the {mode!r} storage "
                f"dtype {QSPECS[mode][1]}")
        self.q, self.scale, self.mode, self.check = q, scale, mode, check
        self.shard = shard

    @property
    def cols(self) -> int:
        """The whole weight's out-channels."""
        return self.shard[1] if self.shard is not None else self.q.shape[-1]

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        """``(q.float() * scale).to(dtype)``, computed in f32 and rounded
        once into a ``dtype`` buffer (one pass, no f32 copy); a stacked
        leaf goes a chunk of its leading axis at a time. Elementwise, so
        the values are those of the whole-tensor expression."""
        out = torch.empty(self.q.shape, dtype=dtype, device=self.q.device)
        if self.q.ndim < 3:
            return _mul_into(self.q, self.scale, out)
        step = chunk_len(self.q[0].numel())
        for i in range(0, self.q.shape[0], step):
            _mul_into(self.q[i:i + step], self.scale[i:i + step], out[i:i + step])
        return out

    def __repr__(self):
        return (f"QTensor(q={tuple(self.q.shape)} {self.q.dtype}, "
                f"mode={self.mode!r}, check={self.check is not None})")


def _mul_into(q: torch.Tensor, s: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out = q * s computed in f32, rounded once to out's dtype. torch
    promotes int8 against f32 inside the kernel; fp8 has no promotion rule,
    so its values are widened first (exactly)."""
    if q.dtype != torch.int8:
        q = q.to(torch.float32)
    return torch.mul(q, s, out=out)


def is_qleaf(x: Any) -> bool:
    return isinstance(x, QTensor)


def chunk_len(per_item: int) -> int:
    """Items of a stacked leaf per chunk, for items of ``per_item``
    elements."""
    return max(1, CHUNK_ELEMS // max(per_item, 1))


def weight_checksum(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The ABFT column checksum of a quantized weight: f32 (..., 1, n) with
    entry k = sum_d q[..., k, d] * scale[..., 0, d], the row sums of the
    dequantized weight, in the reference's op order
    (``(q.float() * scale).sum(-1)``; ``verify.params_ok`` recomputes it
    verbatim). A stacked leaf goes a chunk of its leading axis at a time,
    so no f32 copy of a whole expert stack exists."""
    if q.ndim < 3:
        return (q.to(torch.float32) * scale).sum(-1)[..., None, :]
    out = torch.empty((*q.shape[:-2], 1, q.shape[-2]), dtype=torch.float32,
                      device=q.device)
    step = chunk_len(q[0].numel())
    for i in range(0, q.shape[0], step):
        j = i + step
        out[i:j] = (q[i:j].to(torch.float32) * scale[i:j]).sum(-1)[..., None, :]
    return out


def quantize_weight(w: torch.Tensor, mode: str, *,
                    with_check: bool = False) -> QTensor:
    """Offline weight quantization: ``q`` in the mode's storage dtype and
    f32 per-OUT-channel scales (absmax over ``axis=-2``), through the same
    ``_quantize_rows`` math as the activation epilogues. w: (..., n, d).
    ``with_check`` also stores the ABFT column checksum. A stacked leaf
    goes a chunk of its leading axis at a time (the scales are per item and
    out-channel, so the values are the whole tensor's): the f32 temporaries
    of a whole 128-expert stack at llama4-maverick's width would be ~86 GB."""
    global QUANTIZE_WEIGHT_CALLS
    QUANTIZE_WEIGHT_CALLS += 1
    if w.ndim < 3:
        q, s = _quantize_rows(w.to(torch.float32), mode, axis=-2)
        q = cast_to(q, QSPECS[mode][1])
    else:
        q = torch.empty(w.shape, dtype=QSPECS[mode][1], device=w.device)
        s = torch.empty((*w.shape[:-2], 1, w.shape[-1]), dtype=torch.float32,
                        device=w.device)
        step = chunk_len(w[0].numel())
        for i in range(0, w.shape[0], step):
            j = i + step
            qi, s[i:j] = _quantize_rows(w[i:j].to(torch.float32), mode, axis=-2)
            q[i:j] = cast_to(qi, QSPECS[mode][1])
    return QTensor(q=q, scale=s, mode=mode,
                   check=weight_checksum(q, s) if with_check else None)


def wants_checks(cfg=None) -> bool:
    """Do the weights of this model config carry ABFT checksums
    (``QuantConfig.abft`` or ``REPRO_ABFT``)?"""
    from repro_torch.verify.abft import abft_enabled

    return bool(getattr(getattr(cfg, "quant", None), "abft", False)) or abft_enabled()


def _is_consumer(keys: Tuple[str, ...]) -> bool:
    """Is this leaf a quant_dot rotation consumer (a down-projection
    input fed by the online Hadamard)?"""
    if not keys:
        return False
    return keys[-1] == "w_down" or (keys[-1] == "wv" and "cmix" in keys)


def _should_quantize(keys: Tuple[str, ...], shape, dtype) -> bool:
    """Large float matrices outside the norms. The port's layer leaves
    are per layer, so the size floor applies per layer (the reference
    applies it to the stacked (layers, ...) leaf)."""
    numel = 1
    for n in shape:
        numel *= n
    if len(shape) < 2 or numel < _MIN_SIZE or dtype not in _FLOATS:
        return False
    return not any(k in ("norm1", "norm2", "norm_x", "final_norm", "enc_norm")
                   for k in keys)


def leaf_mode(keys: Tuple[str, ...], shape, dtype, cfg=None):
    """The storage mode ``quantize_lm_weights`` picks for a leaf of this
    path, shape and dtype: a consumer leaf of a rotating + quantizing
    config takes the config's mode (whatever its size), other large
    matrices int8; None leaves it unquantized."""
    qc = getattr(cfg, "quant", None)
    consuming = qc is not None and qc.rotating and qc.enabled
    if consuming and _is_consumer(keys) and len(shape) >= 2 and dtype in _FLOATS:
        return qc.mode
    return "int8" if _should_quantize(keys, shape, dtype) else None


def quantize_leaf(keys: Tuple[str, ...], leaf, cfg=None):
    """The ``quantize_lm_weights`` decision for one leaf at path ``keys``
    (``leaf_mode``), applied."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    mode = leaf_mode(keys, tuple(leaf.shape), leaf.dtype, cfg)
    if mode is None:
        return leaf
    return quantize_weight(leaf, mode, with_check=wants_checks(cfg))


def _map_with_keys(fn, tree, keys=()):
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, keys + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_keys(fn, v, keys) for v in tree)
    return fn(keys, tree)


def quantize_lm_weights(params, cfg=None):
    """Replace every large matmul weight with a :class:`QTensor`, once at
    load (the serving-path pre-quantization pass), over the whole tree: the
    decoder's layers, an encoder's ``enc_layers`` and the cross-attention
    matrices alike. ``cfg`` (a ModelConfig)
    selects the consumer mode, as in ``quantize_leaf``; every leaf carries
    its ABFT checksum when ``wants_checks(cfg)``."""
    return _map_with_keys(lambda keys, leaf: quantize_leaf(keys, leaf, cfg),
                          params)


def dequant_tree(tree, dtype):
    """Dequantize every QTensor leaf of a (nested dict/list) tree."""
    if is_qleaf(tree):
        return tree.dequant(dtype)
    return _map_with_keys(
        lambda _k, x: x.dequant(dtype) if is_qleaf(x) else x, tree)


def qweight_specs(spec_tree, params):
    """Mirror a parameter spec tree (``models.lm.lm_param_specs``) onto the
    QTensor leaves of ``params`` (real or meta tensors): each becomes
    ``{"q": spec, "scale": spec}`` -- ``q`` keeps the leaf's logical axes,
    the (..., 1, d) scales the same with the contraction dim whole -- plus
    ``"check"`` ((..., 1, n): the contraction axis last) when the leaf
    carries its ABFT checksum. The reference's ``qweight_specs``, with
    dicts where it builds QTensor nodes."""
    if is_qleaf(params):
        axes = tuple(spec_tree)
        out = {"q": axes, "scale": axes[:-2] + (None, axes[-1])}
        if params.check is not None:
            out["check"] = axes[:-2] + (None, axes[-2])
        return out
    if isinstance(params, dict):
        return {k: qweight_specs(spec_tree[k], v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [qweight_specs(sp, v) for sp, v in zip(spec_tree, params)]
    return spec_tree
