"""Synthetic LM token stream (numpy; bit-identical to ``repro.data.tokens``).

The serving traces of both packages draw their prompts from this stream,
and the training batches their tokens, so the same seed gives the same
requests and batches on either side.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


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


def lm_batches(num_batches: int, batch: int, seq: int, vocab: int,
               seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """``num_batches`` consecutive (tokens, next-token labels) batches of
    ``(batch, seq)`` cut from one stream."""
    stream = token_stream(num_batches * batch * (seq + 1), vocab, seed)
    stream = stream.reshape(num_batches, batch, seq + 1)
    for i in range(num_batches):
        yield {"tokens": stream[i, :, :-1], "labels": stream[i, :, 1:]}


def train_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0
                ) -> Dict[str, np.ndarray]:
    """One LM train batch: ``tokens`` and next-token ``labels``, each
    ``(batch, seq)`` int32 (the token-model branch of the JAX package's
    ``train_batch``; the port has no VLM frontend)."""
    if cfg.family == "vlm":
        raise NotImplementedError(
            "the VLM stub frontend is not ported to repro_torch yet; see "
            "ROADMAP.md queue A")
    toks = token_stream(batch * (seq + 1), cfg.vocab_size, seed) \
        .reshape(batch, seq + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
