"""Carry the reference package's parameters into the port.

The reference (JAX) keeps a model's parameters as a pytree whose layer
groups are stacked over a leading ``(layers, ...)`` axis and whose
quantized leaves are ``QTensor``s. ``params_from_reference`` takes that
tree as nested dicts and lists of numpy arrays -- a quantized leaf given as
``{"q", "scale", "mode"}``, plus ``"check"`` when the reference leaf carries
its ABFT column checksum -- and returns the port's parameters on a
device: the same leaves, the stacked groups split into the port's per-layer
list, quantized leaves as :class:`~repro_torch.core.wquant.QTensor`. An
encoder-decoder's ``"enc_groups"`` become ``"enc_layers"`` the same way
(``"enc_norm"`` crosses as it is).

bf16 and fp8 arrays (numpy extension dtypes that ``torch.from_numpy``
rejects) cross through a same-width unsigned-integer view; nothing here
imports the reference's packages.

Training state crosses both ways: ``opt_state_from_reference`` takes the
reference's AdamW state (f32 moments or blockwise-int8 ``{"q", "s"}``
moments, ``step``, error-feedback ``ef``) into the port's per-layer layout,
and ``to_reference`` stacks a port tree (parameters or optimizer state)
back into the reference's layout as numpy (bf16 and fp8 as their unsigned
views), which is what the checkpoint store writes -- or, ``meta=True``, as
data-free tensors of the stacked shapes and dtypes, a restore template.
Every function here that takes the reference's layout also takes it with
torch leaves (a restored checkpoint).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.wquant import QTensor
from repro_torch.device import resolve_device

__all__ = ["to_torch", "params_from_reference", "opt_state_from_reference",
           "to_reference"]

# numpy extension dtype name -> (same-width view dtype, torch dtype)
_VIEWED = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def to_torch(arr, device="cuda") -> torch.Tensor:
    """One numpy array (bf16 / fp8 extension dtypes included) as a torch
    tensor of the same dtype and bits on ``device``; a torch tensor moves
    there as it is."""
    dev = resolve_device(device)
    if isinstance(arr, torch.Tensor):
        return arr.to(dev)
    arr = np.asarray(arr)
    viewed = _VIEWED.get(arr.dtype.name)
    if viewed is not None:
        raw, tdt = viewed
        t = torch.from_numpy(arr.copy(order="C").view(raw)).view(tdt)
    else:
        t = torch.from_numpy(arr.copy(order="C"))
    return t.to(dev)


def _is_qdict(x) -> bool:
    return isinstance(x, dict) and set(x) >= {"q", "scale", "mode"}


def _convert(tree, device):
    if _is_qdict(tree):
        check = tree.get("check")
        return QTensor(q=to_torch(tree["q"], device),
                       scale=to_torch(tree["scale"], device), mode=tree["mode"],
                       check=None if check is None else to_torch(check, device))
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return to_torch(tree, device)


def _is_qstate(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def _slice(tree, i: int, repeats: int = 0):
    """Layer ``i`` of a stacked subtree (numpy level, before conversion).
    A blockwise-int8 moment ``{"q", "s"}`` of a stacked parameter holds its
    ``repeats`` layers as consecutive row ranges."""
    if _is_qdict(tree):
        return {k: (v if k == "mode" or v is None else v[i]) for k, v in tree.items()}
    if _is_qstate(tree):
        rows = tree["q"].shape[0] // repeats
        return {k: v[i * rows:(i + 1) * rows] for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: _slice(v, i, repeats) for k, v in tree.items()}
    return tree[i]


def _repeats(tree) -> int:
    if _is_qdict(tree):
        return int(tree["q"].shape[0])
    if isinstance(tree, dict):
        return _repeats(next(iter(tree.values())))
    return int(tree.shape[0])


def params_from_reference(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The reference's ``init_lm`` (optionally ``quantize_lm_weights``)
    tree -> the port's ``init_lm`` layout on ``device``. Each entry of
    ``tree["groups"]`` maps ``p<j>`` to the stacked params of pattern
    position j; layers come out in execution order (repeat r, then j)."""
    return _from_reference(tree, resolve_device(device))


# the reference's stacked groups -> the port's per-layer list
_STACKS = {"groups": "layers", "enc_groups": "enc_layers"}


def _unstack(groups, dev, repeats: List[int] = ()) -> List[dict]:
    layers: List[dict] = []
    for gi, group in enumerate(groups):
        positions = sorted(group, key=lambda k: int(k[1:]))
        reps = repeats[gi] if repeats else _repeats(group[positions[0]])
        for r in range(reps):
            for pj in positions:
                layers.append(_convert(_slice(group[pj], r, reps), dev))
    return layers


def _from_reference(tree, dev, repeats: Dict[str, List[int]] = None):
    out: Dict[str, Any] = {k: _convert(v, dev) for k, v in tree.items()
                           if k not in _STACKS}
    for key, name in _STACKS.items():
        if key in tree:
            out[name] = _unstack(tree[key], dev, (repeats or {}).get(key, ()))
    return out


def opt_state_from_reference(state: Dict[str, Any], cfg, device="cuda") -> Dict[str, Any]:
    """The reference's ``init_opt_state`` / ``apply_updates`` state as numpy
    -- {"m", "v"} shaped like the parameters (f32 arrays, or ``{"q", "s"}``
    blockwise-int8 dicts), "step", and "ef" under int8_ef -- in the port's
    per-layer layout on ``device``; ``cfg`` gives each group's repeats."""
    dev = resolve_device(device)
    reps = {"groups": [r for _, r in cfg.groups],
            "enc_groups": [r for _, r in cfg.encoder_groups]}
    out = {k: _from_reference(v, dev, reps) for k, v in state.items() if k != "step"}
    out["step"] = to_torch(state["step"], dev)
    return out


class _Numpy:
    """Leaves as numpy (bf16 / fp8 as their unsigned views)."""

    @staticmethod
    def leaf(t):
        from repro_torch.checkpoint.store import _to_numpy

        return _to_numpy(t)

    stack, cat = staticmethod(np.stack), staticmethod(np.concatenate)


class _Meta:
    """Leaves as data-free tensors (shape and dtype only)."""

    @staticmethod
    def leaf(t):
        return t.to("meta")

    stack, cat = staticmethod(torch.stack), staticmethod(torch.cat)


def _stack(items, to):
    """Stack one leaf of every layer of a group: arrays along a new axis 0,
    blockwise-int8 moments row-wise (the reference's state of the stacked
    parameter)."""
    first = items[0]
    if _is_qstate(first):
        return {k: to.cat([to.leaf(it[k]) for it in items]) for k in first}
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items], to) for k in first}
    return to.stack([to.leaf(it) for it in items])


def _to_reference_tree(tree, cfg, to):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return to.leaf(x)

    out = {k: conv(v) for k, v in tree.items() if k not in ("layers", "enc_layers")}
    out["groups"] = _restack(tree["layers"], cfg.groups, to)
    if "enc_layers" in tree:
        out["enc_groups"] = _restack(tree["enc_layers"], cfg.encoder_groups, to)
    return out


def _restack(layers, groups_cfg, to) -> List[dict]:
    groups, i = [], 0
    for pattern, repeats in groups_cfg:
        width = len(pattern)
        groups.append({f"p{j}": _stack([layers[i + r * width + j]
                                        for r in range(repeats)], to)
                       for j in range(width)})
        i += width * repeats
    return groups


def to_reference(tree: Dict[str, Any], cfg, meta: bool = False) -> Dict[str, Any]:
    """A port tree of raw (training) parameters in the reference's layout
    (the per-layer lists stacked back into ``groups`` and, for an
    encoder-decoder, ``enc_groups``), or of an AdamW state
    ({"m", "v", "step", "ef"}, each moment tree converted the same way).
    Leaves as numpy, or with ``meta`` as data-free tensors (a restore
    template)."""
    to = _Meta if meta else _Numpy
    if "layers" in tree:
        return _to_reference_tree(tree, cfg, to)
    return {k: (to.leaf(v) if k == "step" else _to_reference_tree(v, cfg, to))
            for k, v in tree.items()}
