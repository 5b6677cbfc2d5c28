"""Synthetic arrival streams for the serving engine (twin of
``repro.serving.stream``): a seeded Poisson process in decode-step units,
prompt and generation lengths uniform over closed ranges."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serving.scheduler import Request


def synthetic_stream(
    num_requests: int,
    *,
    vocab_size: int,
    prompt_len: Tuple[int, int],
    max_new_tokens: Tuple[int, int],
    rate: float = 1.0,
    seed: int = 0,
    deadline_slack: Optional[float] = None,
) -> List[Request]:
    """``rate`` is mean arrivals per decode step; ``prompt_len`` and
    ``max_new_tokens`` are inclusive (lo, hi) ranges; ids run 0..n-1 in
    arrival order. ``deadline_slack`` gives each request the TTL
    ``arrival + max_new_tokens + slack`` steps."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    t = 0.0
    out: List[Request] = []
    for rid in range(num_requests):
        t += float(rng.exponential(1.0 / rate))
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        gen = int(rng.integers(max_new_tokens[0], max_new_tokens[1] + 1))
        toks = rng.integers(0, vocab_size, (plen,), dtype=np.int32)
        ddl = t + gen + deadline_slack if deadline_slack is not None else None
        out.append(Request(rid=rid, tokens=toks, max_new_tokens=gen,
                           arrival_time=t, deadline=ddl))
    return out
