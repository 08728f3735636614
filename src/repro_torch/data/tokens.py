"""Synthetic LM token stream (numpy; bit-identical to ``repro.data.tokens``).

The serving traces of both packages draw their prompts from this stream,
so the same seed gives the same requests on either side.
"""
from __future__ import annotations

import numpy as np


def token_stream(n: int, vocab: int, seed: int = 0) -> np.ndarray:
    """Markov-ish token stream: next token depends on previous two."""
    rng = np.random.default_rng(seed)
    a, b = 6364136223846793005, 1442695040888963407
    mask = (1 << 64) - 1
    toks = np.empty(n, np.int64)
    t1, t2 = 1, 2
    noise = rng.integers(0, vocab, size=n)
    for i in range(n):
        det = (((t1 * a + t2 * b) & mask) >> 17) % vocab
        toks[i] = det if (i % 4) else int(noise[i])
        t1, t2 = int(toks[i]), t1
    return toks.astype(np.int32)
