"""Synthetic LM token stream and token shards (numpy; bit-identical to
``repro.data.tokens``).

The serving traces of both packages draw their prompts from this stream,
and the training batches their tokens, so the same seed gives the same
requests and batches on either side.  The token shards are the LM
analogue of the JAG bundles: ``.npz`` files of ``(seq + 1)``-token rows
that the datastore partitions and preloads for LTFB trainers; each
package reads the other's.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List

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
    """One LM train batch, bit-identical to the JAX package's
    ``train_batch``: ``tokens`` and next-token ``labels``, each ``(batch,
    seq)`` int32, cut from the token stream; for a vlm the stub
    frontend's inputs instead: ``embeds`` ``(batch, seq, d_model)`` f32
    drawn N(0, 0.02^2), M-RoPE ``positions`` ``(3, batch, seq)`` int32 (t,
    t // 8, t % 8) and random int32 ``labels``, all from
    ``default_rng(seed)``."""
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed)
        embeds = rng.normal(0, 0.02, (batch, seq, cfg.d_model)) \
            .astype(np.float32)
        t = np.tile(np.arange(seq, dtype=np.int32), (batch, 1))
        labels = rng.integers(0, cfg.vocab_size, (batch, seq)) \
            .astype(np.int32)
        return {"embeds": embeds, "positions": np.stack([t, t // 8, t % 8]),
                "labels": labels}
    toks = token_stream(batch * (seq + 1), cfg.vocab_size, seed) \
        .reshape(batch, seq + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# Token shards: on-disk files for the distributed datastore
# ---------------------------------------------------------------------------


def shard_path(root: str, i: int) -> str:
    """Path of token shard ``i`` under ``root``."""
    return os.path.join(root, f"tokens_{i:05d}.npz")


def write_token_shards(root: str, num_samples: int, seq_len: int,
                       vocab: int, samples_per_file: int = 256,
                       seed: int = 0) -> List[str]:
    """Write ``num_samples`` (seq_len+1)-token rows into shard files.

    Each row holds input tokens and next-token labels in one array
    (split by :func:`lm_shard_batch` at batch-assembly time).
    """
    os.makedirs(root, exist_ok=True)
    stream = token_stream(num_samples * (seq_len + 1), vocab, seed)
    rows = stream.reshape(num_samples, seq_len + 1)
    paths = []
    for fi in range(0, num_samples, samples_per_file):
        path = shard_path(root, fi // samples_per_file)
        np.savez(path, tokens=rows[fi:fi + samples_per_file])
        paths.append(path)
    return paths


def read_token_shard(path: str) -> Dict[str, np.ndarray]:
    """A shard's rows as ``{"tokens": (n, seq + 1) int32}``."""
    with np.load(path) as z:
        return {"tokens": z["tokens"]}


def list_token_shards(root: str) -> List[str]:
    """The shard files under ``root``, sorted (none if it does not
    exist)."""
    if not os.path.isdir(root):
        return []
    return sorted(os.path.join(root, f) for f in os.listdir(root)
                  if f.startswith("tokens_") and f.endswith(".npz"))


def lm_shard_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """DataStore batch (stacked shard rows) -> LM train batch."""
    rows = batch["tokens"]
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
