"""Carry the reference package's parameters into the port.

The reference (JAX) keeps a model's parameters as a pytree whose layer
groups are stacked over a leading ``(layers, ...)`` axis and whose
quantized leaves are ``QTensor``s. ``params_from_reference`` takes that
tree as nested dicts and lists of numpy arrays -- a quantized leaf given as
``{"q", "scale", "mode"}``, plus ``"check"`` when the reference leaf carries
its ABFT column checksum -- and returns the port's parameters on a
device: the same leaves, the stacked groups split into the port's per-layer
list, quantized leaves as :class:`~repro_torch.core.wquant.QTensor`.

bf16 and fp8 arrays (numpy extension dtypes that ``torch.from_numpy``
rejects) cross through a same-width unsigned-integer view; nothing here
imports the reference's packages.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.wquant import QTensor
from repro_torch.device import resolve_device

__all__ = ["to_torch", "params_from_reference"]

# numpy extension dtype name -> (same-width view dtype, torch dtype)
_VIEWED = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def to_torch(arr, device="cuda") -> torch.Tensor:
    """One numpy array (bf16 / fp8 extension dtypes included) as a torch
    tensor of the same dtype and bits on ``device``."""
    arr = np.asarray(arr)
    dev = resolve_device(device)
    viewed = _VIEWED.get(arr.dtype.name)
    if viewed is not None:
        raw, tdt = viewed
        t = torch.from_numpy(np.ascontiguousarray(arr).view(raw).copy()).view(tdt)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
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


def _slice(tree, i: int):
    """Layer ``i`` of a stacked subtree (numpy level, before conversion)."""
    if _is_qdict(tree):
        return {k: (v if k == "mode" or v is None else v[i]) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i]


def _repeats(tree) -> int:
    if _is_qdict(tree):
        return int(np.shape(tree["q"])[0])
    if isinstance(tree, dict):
        return _repeats(next(iter(tree.values())))
    return int(np.shape(tree)[0])


def params_from_reference(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The reference's ``init_lm`` (optionally ``quantize_lm_weights``)
    tree -> the port's ``init_lm`` layout on ``device``. Each entry of
    ``tree["groups"]`` maps ``p<j>`` to the stacked params of pattern
    position j; layers come out in execution order (repeat r, then j)."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {k: _convert(v, dev) for k, v in tree.items()
                           if k != "groups"}
    layers: List[dict] = []
    for group in tree["groups"]:
        positions = sorted(group, key=lambda k: int(k[1:]))
        for r in range(_repeats(group[positions[0]])):
            for pj in positions:
                layers.append(_convert(_slice(group[pj], r), dev))
    out["layers"] = layers
    return out
