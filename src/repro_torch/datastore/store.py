"""Distributed in-memory data store (paper Section III-B, Figs. 5/10): a
numpy and threading copy of ``repro.datastore.store``, giving the same
epoch permutations, batches and counters.

Each *rank* of a trainer owns a subset of the sample bundles and caches
its samples in host memory; per-mini-batch, samples are exchanged from
owner to consumer (non-blocking, overlapped — here: a background
prefetch thread).  Two population modes:

  * ``preload`` — ranks bulk-read disjoint file subsets before training
    (each file opened by exactly one rank; optimal for bundle formats).
  * ``dynamic`` — epoch 1 reads from files on demand (naive access
    pattern) but caches; epochs 2+ never touch the filesystem.
  * ``none``    — the naive reader (every access opens a file).

This is a single-process simulation of the multi-rank protocol with
faithful accounting (file opens, bytes read, exchange volume).  Batches
stay numpy: the trainer's loader uploads each to its device in one copy.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


class StoreStats:
    """Counters of one trainer's store."""

    def __init__(self):
        self.file_opens = 0
        self.bytes_read = 0
        self.exchange_bytes = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.samples_fetched = 0
        self.preload_seconds = 0.0

    def as_dict(self):
        """The counters as a plain dict."""
        return dict(self.__dict__)


class DataStore:
    """In-memory sample store for one trainer.

    Parameters
    ----------
    files : bundle file paths (this trainer's data partition).
    reader : callable(path) -> dict[str, np.ndarray] with leading sample dim.
    num_ranks : simulated MPI ranks within the trainer.
    mode : 'preload' | 'dynamic' | 'none'.
    """

    def __init__(self, files: Sequence[str], reader: Callable,
                 num_ranks: int = 1, mode: str = "preload", seed: int = 0):
        assert mode in ("preload", "dynamic", "none")
        self.files = list(files)
        self.reader = reader
        self.num_ranks = num_ranks
        self.mode = mode
        self.seed = seed
        self.stats = StoreStats()
        # sample index: probe first file for samples/file
        first = reader(self.files[0])
        self._keys = sorted(first.keys())
        self.samples_per_file = len(first[self._keys[0]])
        self.stats.file_opens += 1
        self.stats.bytes_read += sum(v.nbytes for v in first.values())
        last = None
        if len(self.files) > 1:
            # sample-id -> file arithmetic assumes uniform bundles; a
            # short final bundle would index past its end — fail loudly
            last = reader(self.files[-1])
            self.stats.file_opens += 1
            self.stats.bytes_read += sum(v.nbytes for v in last.values())
            n_last = len(last[self._keys[0]])
            if n_last != self.samples_per_file:
                raise ValueError(
                    f"non-uniform bundle manifest: {self.files[-1]} has "
                    f"{n_last} samples, expected {self.samples_per_file} "
                    "— write num_samples as a multiple of "
                    "samples_per_file or drop the short bundle")
        self.num_samples = self.samples_per_file * len(self.files)
        # rank-owned caches: rank -> {sample_id: {key: np.ndarray}}
        self._cache: List[Dict[int, dict]] = [dict() for _ in range(num_ranks)]
        if mode != "none":
            self._adopt_file(0, first)
            if last is not None:
                self._adopt_file(len(self.files) - 1, last)

    # -- ownership ---------------------------------------------------------
    def owner_of_file(self, file_idx: int) -> int:
        """Rank that owns (reads and caches) bundle ``file_idx``."""
        return file_idx % self.num_ranks

    def owner_of_sample(self, sid: int) -> int:
        """Rank that owns sample ``sid``."""
        return self.owner_of_file(sid // self.samples_per_file)

    # -- population --------------------------------------------------------
    def _adopt_file(self, file_idx: int, bundle: dict):
        rank = self.owner_of_file(file_idx)
        base = file_idx * self.samples_per_file
        n = len(bundle[self._keys[0]])
        for j in range(n):
            self._cache[rank][base + j] = {k: bundle[k][j]
                                           for k in self._keys}

    def preload(self, parallel: bool = True):
        """Populate the store before training (paper: each file is opened
        by exactly one process; ranks read their files in parallel)."""
        assert self.mode == "preload"
        t0 = time.perf_counter()

        def load(fi):
            b = self.reader(self.files[fi])
            self.stats.file_opens += 1
            self.stats.bytes_read += sum(v.nbytes for v in b.values())
            return fi, b

        todo = [fi for fi in range(len(self.files))
                if fi * self.samples_per_file not in self._cache[
                    self.owner_of_file(fi)]]
        if parallel and self.num_ranks > 1:
            with ThreadPoolExecutor(max_workers=min(self.num_ranks, 16)) as ex:
                for fi, b in ex.map(load, todo):
                    self._adopt_file(fi, b)
        else:
            for fi in todo:
                self._adopt_file(*load(fi))
        self.stats.preload_seconds = time.perf_counter() - t0

    # -- access ------------------------------------------------------------
    def _fetch_sample(self, sid: int) -> dict:
        self.stats.samples_fetched += 1
        rank = self.owner_of_sample(sid)
        hit = self._cache[rank].get(sid)
        if hit is not None:
            self.stats.cache_hits += 1
            return hit
        self.stats.cache_misses += 1
        fi = sid // self.samples_per_file
        bundle = self.reader(self.files[fi])
        self.stats.file_opens += 1
        j = sid - fi * self.samples_per_file
        sample = {k: bundle[k][j] for k in self._keys}
        self.stats.bytes_read += sum(bundle[k][j].nbytes for k in self._keys)
        if self.mode == "dynamic":
            # cache the whole bundle — we already paid for the read
            self._adopt_file(fi, bundle)
        return sample

    def epoch_permutation(self, epoch: int) -> np.ndarray:
        """The sample order of ``epoch`` (seeded by the store's seed)."""
        rng = np.random.default_rng(self.seed * 100_003 + epoch)
        return rng.permutation(self.num_samples)

    def get_batch(self, perm: np.ndarray, step: int, batch_size: int,
                  consumer_rank: int = 0) -> Dict[str, np.ndarray]:
        """Assemble a mini-batch; counts owner->consumer exchange volume."""
        lo = (step * batch_size) % self.num_samples
        idx = perm[lo:lo + batch_size]
        if len(idx) < batch_size:    # wrap
            idx = np.concatenate([idx, perm[:batch_size - len(idx)]])
        samples = []
        for sid in idx:
            s = self._fetch_sample(int(sid))
            if self.owner_of_sample(int(sid)) != consumer_rank:
                self.stats.exchange_bytes += sum(v.nbytes for v in s.values())
            samples.append(s)
        return {k: np.stack([s[k] for s in samples]) for k in self._keys}

    def steps_per_epoch(self, batch_size: int) -> int:
        """Whole batches in one pass over the partition (at least 1)."""
        return max(1, self.num_samples // batch_size)


class PrefetchLoader:
    """Background-thread batch assembly (the paper's non-blocking shuffle
    overlap).  ``depth`` is the double-buffering depth.

    ``consumer_rank`` selects which simulated rank assembles each batch:
    a fixed int, or ``None`` to rotate ranks per step (each rank takes
    its turn consuming, so owner->consumer exchange volume accrues the
    way it does across the trainer's real ranks).
    """

    def __init__(self, store: DataStore, batch_size: int, depth: int = 2,
                 epoch: int = 0, consumer_rank: Optional[int] = 0):
        self.store = store
        self.batch_size = batch_size
        self.consumer_rank = consumer_rank
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._epoch = epoch
        # prefetch-stall accounting: wall seconds the consumer spent
        # blocked in next() (queue empty = producer behind), and how
        # many of those gets actually blocked
        self.wait_seconds = 0.0
        self.stalls = 0
        self.batches_delivered = 0
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = 0
        perm = self.store.epoch_permutation(self._epoch)
        spe = self.store.steps_per_epoch(self.batch_size)
        while not self._stop.is_set():
            if step and step % spe == 0:
                self._epoch += 1
                perm = self.store.epoch_permutation(self._epoch)
            rank = self.consumer_rank if self.consumer_rank is not None \
                else step % self.store.num_ranks
            batch = self.store.get_batch(perm, step, self.batch_size,
                                         consumer_rank=rank)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self, timeout: float = 60.0):
        """The next batch, blocking (and counting the stall) when the
        producer is behind."""
        try:
            batch = self._q.get_nowait()
        except queue.Empty:
            t0 = time.perf_counter()
            batch = self._q.get(timeout=timeout)
            self.wait_seconds += time.perf_counter() - t0
            self.stalls += 1
        self.batches_delivered += 1
        return batch

    def close(self):
        """Stop the producer thread and drop queued batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def partition_files(files: Sequence[str], num_trainers: int,
                    trainer_idx: int, strategy: str = "stride") -> List[str]:
    """LTFB data partitioning (disjoint, load-balanced; paper §III-C).

    ``stride``: trainer k owns files[k::num_trainers] (interleaved —
    every trainer samples the whole exploration order).
    ``block``: trainer k owns a contiguous chunk — since bundles are
    written in parameter-space exploration order this approximates the
    paper's data-silo scenario (each trainer sees one region of input
    space, and tournaments propagate the encoded partitions).
    """
    if strategy == "stride":
        return list(files[trainer_idx::num_trainers])
    if strategy == "block":
        n = len(files)
        lo = trainer_idx * n // num_trainers
        hi = (trainer_idx + 1) * n // num_trainers
        return list(files[lo:hi])
    raise ValueError(f"unknown partition strategy {strategy!r}")


def aggregate_stats(stores: Sequence[DataStore]) -> Dict[str, float]:
    """Sum StoreStats across a population of per-trainer stores."""
    total: Dict[str, float] = collections.defaultdict(float)
    for s in stores:
        for k, v in s.stats.as_dict().items():
            total[k] += v
    return dict(total)
