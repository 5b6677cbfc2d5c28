"""Checkpoints in the reference's on-disk layout, with async writes and
per-leaf CRC-32 (twin of ``repro.checkpoint.store``).

Layout:  <dir>/step_<k:09d>/arr_<i>.npy + tree.json (+ .done marker)

  * One ``.npy`` per leaf, in jax's flatten order (``repro_torch.tree``);
    bf16 and fp8 leaves are written through a same-width unsigned view, as
    the reference writes them, and read back onto the template's dtype.
    ``tree.json`` lists each leaf's shape, stored dtype, path and the CRC-32
    of the bytes written. A tree in the reference's layout (``bridge.
    to_reference``) therefore restores in either package.
  * Writes run on a background thread, one in flight at a time; a step is
    valid once its ``.done`` marker exists, so a crash mid-write leaves the
    previous step as the newest valid one.
  * Restore recomputes every leaf's CRC and raises, naming the leaf, on a
    mismatch: a flipped byte on disk never becomes a silently wrong model.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T

__all__ = ["save_checkpoint", "wait_for_writes", "latest_step", "restore_checkpoint"]

_WRITER: Optional[threading.Thread] = None

# torch dtypes numpy lacks -> the same-width unsigned view they are stored as
_VIEWS = {torch.bfloat16: (torch.int16, np.uint16),
          torch.float8_e4m3fn: (torch.uint8, np.uint8),
          torch.float8_e5m2: (torch.uint8, np.uint8)}


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    t = x.detach().to("cpu")
    view = _VIEWS.get(t.dtype)
    if view is not None:
        return t.contiguous().view(view[0]).numpy().view(view[1])
    return t.numpy()


def _from_numpy(a: np.ndarray, template, device):
    """The stored array as the template leaf's kind: a torch tensor of its
    dtype (bf16 / fp8 from the unsigned view) on ``device`` (default: the
    template's), or numpy."""
    if isinstance(template, np.ndarray):
        return a
    view = _VIEWS.get(template.dtype)
    t = torch.from_numpy(a if a.flags.c_contiguous else a.copy(order="C"))
    if view is not None and a.dtype.kind == "u":
        t = t.view(view[0]).view(template.dtype)
    return t.to(device=device or template.device, dtype=template.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *, async_write: bool = True):
    """Write a tree of tensors as step ``step``. The arrays are copied to
    the host before this returns; with ``async_write`` the files are
    written on a background thread."""
    flat = T.leaves_with_paths(tree)
    host = [_to_numpy(x) for _, x in flat]
    paths = [p for p, _ in flat]

    def write():
        out = os.path.join(ckpt_dir, f"step_{step:09d}")
        tmp = out + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "treedef": f"{len(host)} leaves", "leaves": []}
        for i, arr in enumerate(host):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
            manifest["leaves"].append({
                "shape": list(arr.shape), "dtype": str(arr.dtype), "path": paths[i],
                "crc": zlib.crc32(np.ascontiguousarray(arr).tobytes())})
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(out):
            shutil.rmtree(out)
        os.replace(tmp, out)
        open(os.path.join(out, ".done"), "w").close()

    global _WRITER
    wait_for_writes()                              # backpressure: one in flight
    if async_write:
        _WRITER = threading.Thread(target=write, daemon=True)
        _WRITER.start()
    else:
        write()


def wait_for_writes():
    if _WRITER is not None and _WRITER.is_alive():
        _WRITER.join()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, ".done"))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, template: Any, device=None) -> Any:
    """Restore step ``step`` onto ``template``'s structure, each leaf as the
    template leaf's dtype, on ``device`` (default: the template leaf's; a
    data-free ``meta`` template from ``bridge.to_reference(..., meta=True)``
    needs one). Raises on a leaf count, shape or CRC-32 mismatch, naming
    the leaf."""
    out = os.path.join(ckpt_dir, f"step_{step:09d}")
    flat_t = T.leaves(template)
    with open(os.path.join(out, "tree.json")) as f:
        manifest = json.load(f)
    if len(manifest["leaves"]) != len(flat_t):
        raise ValueError(
            f"checkpoint at {out} has {len(manifest['leaves'])} leaves but the "
            f"restore template flattens to {len(flat_t)}: the saved tree "
            "structure does not match")
    arrs = []
    for i, t in enumerate(flat_t):
        a = np.load(os.path.join(out, f"arr_{i}.npy"))
        entry = manifest["leaves"][i]
        name = entry.get("path", f"leaf[{i}]")
        if "crc" in entry:
            got = zlib.crc32(np.ascontiguousarray(a).tobytes())
            if got != entry["crc"]:
                raise ValueError(
                    f"checkpoint leaf {name} (arr_{i}.npy in {out}) is CORRUPT: "
                    f"stored CRC-32 {entry['crc']:#010x} != recomputed {got:#010x} "
                    f"over {a.nbytes} bytes; restore from an older .done step")
        if list(a.shape) != entry["shape"] or str(a.dtype) != entry["dtype"] \
                or tuple(a.shape) != tuple(t.shape):
            raise ValueError(
                f"checkpoint leaf {name} (arr_{i}.npy in {out}) has shape "
                f"{a.shape}/{a.dtype}; its manifest says {tuple(entry['shape'])}/"
                f"{entry['dtype']} and the template {tuple(t.shape)}")
        arrs.append(_from_numpy(a, t, device))
    return T.unflatten(template, arrs)
