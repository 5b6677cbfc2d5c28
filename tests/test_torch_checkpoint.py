"""PyTorch port, checkpoints: ``repro_torch.checkpoint`` writes and reads
the reference's on-disk layout (``step_<k>/arr_<i>.npy`` + ``tree.json``
with per-leaf CRC-32), so a checkpoint written by either package restores
in the other -- parameters and AdamW state (f32 and blockwise-int8
moments) of a scaled-down phi4-mini (2 layers), carried between the
packages' layouts by ``repro_torch.bridge``. Restores are held bitwise; a
flipped byte in a leaf file raises, naming the leaf.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config as jget_config
from repro.models import init_lm as jinit_lm
from repro.optim import adamw as jadamw

from repro_torch import tree as T
from repro_torch.bridge import (opt_state_from_reference, params_from_reference,
                                to_reference)
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.store import wait_for_writes
from repro_torch.configs import get_config

OVER = dict(d_model=128, num_heads=2, num_kv_heads=1, head_dim=64, d_ff=256,
            vocab_size=512)


def _np(x):
    """A leaf as comparable numpy bits (bf16 through its uint16 view)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(a, b):
    la, lb = T.leaves(a), T.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.array_equal(_np(x), _np(y))


@pytest.fixture(scope="module", params=["f32", "int8"])
def reference_state(request):
    """The reference's params and its AdamW state after one update."""
    jcfg = jget_config("phi4_mini_3_8b").scaled_down(**OVER)
    cfg = get_config("phi4-mini-3.8b").scaled_down(**OVER)
    ocfg = jadamw.OptConfig(state_dtype=request.param, grad_compression="int8_ef")
    p = jax.jit(lambda k: jinit_lm(k, jcfg))(jax.random.PRNGKey(0))
    s = jax.jit(lambda q: jadamw.init_opt_state(q, ocfg))(p)
    g = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype), p)
    p, s, _ = jax.jit(lambda q, gg, st: jadamw.apply_updates(q, gg, st, ocfg))(p, g, s)
    return cfg, p, s


def test_reference_checkpoint_restores_in_the_port(tmp_path, reference_state):
    cfg, p, s = reference_state
    ck = str(tmp_path / "ck")
    jstore.save_checkpoint(ck, 3, p, async_write=False)
    jstore.save_checkpoint(ck + "/opt", 3, s, async_write=False)
    assert latest_step(ck) == 3 and latest_step(ck + "/opt") == 3
    tp = params_from_reference(jax.tree.map(np.asarray, p), device="cpu")
    ts = opt_state_from_reference(jax.tree.map(np.asarray, s), cfg, device="cpu")
    rp = restore_checkpoint(ck, 3, to_reference(tp, cfg, meta=True), device="cpu")
    rs = restore_checkpoint(ck + "/opt", 3, to_reference(ts, cfg, meta=True), device="cpu")
    _same(rp, p)
    _same(rs, s)
    _same(params_from_reference(rp, "cpu"), tp)
    _same(opt_state_from_reference(rs, cfg, "cpu"), ts)
    assert rp["emb"].dtype == torch.bfloat16 and rs["step"].dtype == torch.int32


def test_port_checkpoint_restores_in_the_reference(tmp_path, reference_state):
    cfg, p, s = reference_state
    ck = str(tmp_path / "ck")
    tp = params_from_reference(jax.tree.map(np.asarray, p), device="cpu")
    ts = opt_state_from_reference(jax.tree.map(np.asarray, s), cfg, device="cpu")
    save_checkpoint(ck, 5, to_reference(tp, cfg))
    save_checkpoint(ck + "/opt", 5, to_reference(ts, cfg))
    wait_for_writes()
    assert jstore.latest_step(ck) == 5
    _same(jstore.restore_checkpoint(ck, 5, p), p)
    _same(jstore.restore_checkpoint(ck + "/opt", 5, s), s)


def test_flipped_byte_raises_naming_the_leaf(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": [torch.ones(5, dtype=torch.bfloat16), torch.zeros((), dtype=torch.int32)]}
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, 1, tree, async_write=False)
    _same(restore_checkpoint(ck, 1, tree), tree)
    path = os.path.join(ck, "step_000000001", "arr_1.npy")
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0x01
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match=r"\['b'\]\[0\].*CORRUPT"):
        restore_checkpoint(ck, 1, tree)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(ck, 1, {"a": tree["a"]})


def test_latest_step_takes_the_newest_finished_step(tmp_path):
    ck = str(tmp_path / "ck")
    assert latest_step(ck) is None
    tree = {"w": torch.ones(3)}
    for k in (2, 10):
        save_checkpoint(ck, k, tree)
    wait_for_writes()
    os.makedirs(os.path.join(ck, "step_000000020"))    # no .done: a crash mid-write
    assert latest_step(ck) == 10
    os.remove(os.path.join(ck, "step_000000010", ".done"))
    assert latest_step(ck) == 2
