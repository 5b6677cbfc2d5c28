"""Teacher-forced logits of a serving engine: the readings the mesh and
rules holds compare (the CPU tests and ``chip_smoke.py``).

``forced_logits(engine, prompts, forced)`` admits one prompt per slot
through the engine's own prefill and insert (no scheduler), then runs
``len(forced)`` decode steps over every slot, each fed the given tokens at
each slot's next position, and records the logits of every step: the same
context for every engine it is given, whatever tokens each would pick. On
a mesh every rank returns the whole logits (the slots gathered in slot
order).

``split_output_projection(parts)``: within it, the attention's output
projection on one process sums the f32 products of ``parts`` row blocks
and rounds once, the sum a split of the query heads over ``parts`` ranks
takes: the witness of a split over 'heads', a correct path that differs
from world 1's only in summation order.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["forced_logits", "split_output_projection"]


@torch.inference_mode()
def forced_logits(engine, prompts: Sequence[Sequence[int]],
                  forced: np.ndarray) -> Dict[str, torch.Tensor]:
    """``prompts``: one token list per slot (each at most the prefill
    bucket); ``forced``: (steps, slots) tokens. Returns {"prefill": (slots,
    vocab) f32 logits at each prompt's last position, "decode": (steps,
    slots, vocab) f32 logits of each decode step}, on the CPU."""
    from repro_torch.serving import engine as E

    V = engine.cfg.vocab_size
    seen = []
    real_forward, real_decode = E.lm_forward, E.lm_decode_step

    def forward(*a, **k):
        out = real_forward(*a, **k)
        seen.append(out[0])
        return out

    def decode(*a, **k):
        out = real_decode(*a, **k)
        seen.append(out[0])
        return out

    E.lm_forward, E.lm_decode_step = forward, decode
    try:
        first = []
        for slot, toks in enumerate(prompts):
            padded = np.zeros((1, engine.prefill_len), np.int64)
            padded[0, :len(toks)] = toks
            engine._insert(slot, engine._prefill(padded, len(toks))[-1])
            first.append(seen[-1][0, len(toks) - 1, :V].float())
            engine.positions_h[slot] = len(toks)
        steps = []
        for tokens in np.asarray(forced):
            engine.tokens_h[:, 0] = tokens
            engine._decode()
            steps.append(engine._gather(seen[-1][:, -1, :V].float().contiguous()))
            engine.positions_h += 1
    finally:
        E.lm_forward, E.lm_decode_step = real_forward, real_decode
    return {"prefill": torch.stack(first).cpu(),
            "decode": torch.stack(steps).cpu() if steps else torch.zeros((0, len(prompts), V))}


@contextlib.contextmanager
def split_output_projection(parts: int):
    """Within the block, ``models.attention``'s output projection on one
    process is the sum of ``parts`` row blocks' f32 products, rounded once
    (module docstring)."""
    from repro_torch.models import attention as A

    real = A._out_proj

    def split(cfg, ctx, wo):
        n = ctx.shape[-1] // parts
        acc = A._f32_product(ctx[..., :n], wo[:n])
        for i in range(1, parts):
            acc = acc + A._f32_product(ctx[..., i * n:(i + 1) * n], wo[i * n:(i + 1) * n])
        return acc.to(ctx.dtype)

    A._out_proj = split
    try:
        yield
    finally:
        A._out_proj = real
