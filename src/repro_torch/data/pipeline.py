"""Deterministic, stateless data pipeline (twin of ``repro.data.pipeline``).

``batch(step)`` is a pure function of (seed, step, shape): after a restart
from checkpoint step k the batches k, k + 1, ... come back bit for bit with
no loader state to restore. The draws are numpy's, as the reference's, so
the two packages give the same batches bitwise.

  * SyntheticDataset -- token streams from ``default_rng((seed, step))``
                        (a vlm's patches and positions, an encoder-
                        decoder's frames too).
  * MemmapDataset    -- a flat int32 token file read in deterministic
                        strided windows.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig

__all__ = ["SyntheticDataset", "MemmapDataset", "write_synthetic_corpus"]


class SyntheticDataset:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, seed: int = 0):
        self.cfg, self.shape, self.seed = cfg, shape, seed

    def batch(self, step: int) -> Dict[str, Any]:
        """{"tokens", "labels"}: (batch, seq) int32 numpy arrays, labels the
        tokens shifted by one. A vlm's sequence of ``seq`` holds
        ``vlm_patches`` f32 patch embeddings (batch, P, d) and seq - P
        tokens, with (3, batch, seq) int32 M-RoPE positions, each stream
        0..seq-1; an encoder-decoder adds f32 frames (batch, encoder_seq,
        d). Drawn in the reference's order."""
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, step))
        B, S = self.shape.batch, self.shape.seq
        out: Dict[str, Any] = {}
        if cfg.family == "vlm":
            P = cfg.vlm_patches
            toks = rng.integers(0, cfg.vocab_size, (B, S - P + 1), dtype=np.int32)
            out["tokens"], out["labels"] = toks[:, :-1], toks[:, 1:]
            out["patch_embeds"] = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
            out["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
        else:
            toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
            out["tokens"], out["labels"] = toks[:, :-1], toks[:, 1:]
        if cfg.is_encdec:
            out["frames"] = rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        return out


class MemmapDataset:
    """Flat int32 token file; batch(step) takes deterministic strided
    windows so every step maps to a fixed corpus slice."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, path: str):
        self.cfg, self.shape = cfg, shape
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.ntok = len(self.tokens)

    def batch(self, step: int) -> Dict[str, Any]:
        B, S = self.shape.batch, self.shape.seq
        need = S + 1
        starts = (np.arange(B, dtype=np.int64) * self.ntok // B
                  + step * need) % max(self.ntok - need, 1)
        toks = np.stack([np.asarray(self.tokens[s:s + need]) for s in starts])
        toks = toks % self.cfg.vocab_size
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def write_synthetic_corpus(path: str, ntok: int, vocab: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    rng.integers(0, vocab, ntok, dtype=np.int32).tofile(path)
    return path
