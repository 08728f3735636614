"""Serving metrics of the port: throughput / latency / queue accounting.

``percentile``, ``Histogram`` and ``BoundedSeries`` are copies of
``repro.serve.metrics``; :class:`ServeStats` keeps the counters the
port's scheduler updates (speculative decoding, faults, the gateway and
the arena are not ported yet) under the same names.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union


def percentile(xs: Union[Sequence[float], "BoundedSeries"],
               q: float) -> float:
    """Nearest-rank percentile (no numpy dependency on the hot path).

    Accepts a plain sequence or a :class:`BoundedSeries` (which answers
    from its exact list or its reservoir, whichever it currently holds).
    """
    if isinstance(xs, BoundedSeries):
        return xs.percentile(q)
    if not xs:
        return float("nan")
    ys = sorted(xs)
    k = min(len(ys) - 1, max(0, int(round(q / 100.0 * (len(ys) - 1)))))
    return ys[k]


# Fixed latency bucket upper bounds (seconds), ~1ms .. 2min exponential:
# bounded memory regardless of how long the gateway runs.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


class Histogram:
    """Fixed-bucket histogram: O(len(bounds)) memory forever.

    ``bounds`` are inclusive upper edges; values above the last bound
    land in the implicit ``+Inf`` bucket.
    """

    __slots__ = ("bounds", "counts", "total", "sum")

    def __init__(self, bounds: Sequence[float] = LATENCY_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        """Count one sample."""
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.total += 1
        self.sum += v


class BoundedSeries:
    """Latency series with bounded memory.

    Short runs (benchmarks, tests) keep every sample exactly; past
    ``exact_cap`` samples the storage degrades to a deterministic
    Algorithm-R reservoir of ``reservoir`` samples, while a fixed-bucket
    :class:`Histogram` keeps exact counts/sum forever.  ``percentile``
    answers from whichever representation is live; ``mean`` is always
    exact (from the histogram accumulators).
    """

    __slots__ = ("exact_cap", "reservoir", "hist", "_sample", "_rng")

    def __init__(self, exact_cap: int = 4096, reservoir: int = 1024,
                 bounds: Sequence[float] = LATENCY_BUCKETS):
        self.exact_cap = int(exact_cap)
        self.reservoir = min(int(reservoir), self.exact_cap)
        self.hist = Histogram(bounds)
        self._sample: List[float] = []
        self._rng = random.Random(0x5EED)  # deterministic across runs

    @property
    def mean(self) -> float:
        """Exact mean of all samples observed (NaN when empty)."""
        n = self.hist.total
        return self.hist.sum / n if n else float("nan")

    def append(self, v: float) -> None:
        """Observe one sample (list-compatible name)."""
        v = float(v)
        self.hist.observe(v)
        n = self.hist.total
        if n <= self.exact_cap:
            self._sample.append(v)
            return
        if n == self.exact_cap + 1:
            # first overflow: collapse the exact list to a seeded
            # uniform subsample, then run standard Algorithm R
            self._sample = self._rng.sample(self._sample, self.reservoir)
        j = self._rng.randrange(n)
        if j < self.reservoir:
            self._sample[j] = v

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile from the exact list or the reservoir."""
        if not self._sample:
            return float("nan")
        ys = sorted(self._sample)
        k = min(len(ys) - 1, max(0, int(round(q / 100.0 * (len(ys) - 1)))))
        return ys[k]

    def __len__(self) -> int:
        return self.hist.total


@dataclass
class ServeStats:
    """Counter bundle for one scheduler lifetime.

    All counters are plain ints mutated on the host control path; times
    are ``time.perf_counter`` seconds.  ``as_dict`` derives the rates and
    percentiles, ``report`` prints the ``[serve]`` summary lines.
    """

    slots: int = 0
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    prefills: int = 0
    prefill_chunks: int = 0        # chunked-prefill slices processed
    prefill_tokens: int = 0        # true prompt tokens processed
    padded_prefill_tokens: int = 0  # incl. bucket padding (waste measure)
    decode_steps: int = 0
    decode_tokens: int = 0         # useful generated tokens
    decode_slot_steps: int = 0     # slots * steps actually computed
    ragged_splits: int = 0         # width-split subset decode dispatches
    steps: int = 0
    queue_depth_sum: int = 0
    queue_depth_max: int = 0
    slot_busy_sum: int = 0
    ttft: BoundedSeries = field(default_factory=BoundedSeries)
    tpot: BoundedSeries = field(default_factory=BoundedSeries)
    latency: BoundedSeries = field(default_factory=BoundedSeries)
    started: Optional[float] = None
    finished: Optional[float] = None

    def start(self):
        """Arm the wall clock on the first scheduler step (idempotent)."""
        if self.started is None:
            self.started = time.perf_counter()

    def stop(self):
        """Freeze the wall clock; rates in :meth:`as_dict` stop growing."""
        self.finished = time.perf_counter()

    @property
    def wall(self) -> float:
        """Elapsed serving seconds (live until :meth:`stop` is called)."""
        if self.started is None:
            return 0.0
        end = self.finished if self.finished is not None \
            else time.perf_counter()
        return max(end - self.started, 1e-9)

    def sample_step(self, queue_depth: int, busy_slots: int):
        """Record one scheduler step's queue depth and busy-slot count."""
        self.steps += 1
        self.queue_depth_sum += queue_depth
        self.queue_depth_max = max(self.queue_depth_max, queue_depth)
        self.slot_busy_sum += busy_slots

    def as_dict(self) -> Dict[str, float]:
        """One flat summary dict: raw counters plus derived rates (req/s,
        tok/s), latency stats (TTFT / TPOT / e2e: mean, p50, p95, p99
        seconds) and occupancy.  NaN where no samples exist."""
        wall = self.wall
        occ = self.slot_busy_sum / max(self.steps * max(self.slots, 1), 1)
        d = {
            "slots": self.slots,
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "prefills": self.prefills,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "padded_prefill_tokens": self.padded_prefill_tokens,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "decode_slot_steps": self.decode_slot_steps,
            "ragged_splits": self.ragged_splits,
            "wall_s": wall,
            "requests_per_s": self.completed / max(wall, 1e-9),
            "tokens_per_s": self.decode_tokens / max(wall, 1e-9),
            "queue_depth_mean": self.queue_depth_sum / max(self.steps, 1),
            "queue_depth_max": self.queue_depth_max,
            "slot_occupancy": occ,
        }
        for name in ("ttft", "tpot", "latency"):
            series = getattr(self, name)
            d[f"{name}_mean_s"] = series.mean
            for q in (50, 95, 99):
                d[f"{name}_p{q}_s"] = series.percentile(q)
        return d

    def report(self, log: Callable[[str], None] = print,
               prefix: str = "[serve]"):
        """Print the human-readable ``[serve]`` summary via ``log``."""
        d = self.as_dict()
        log(f"{prefix} requests: submitted={d['submitted']} "
            f"completed={d['completed']} rejected={d['rejected']}")
        log(f"{prefix} throughput: {d['requests_per_s']:.2f} req/s "
            f"{d['tokens_per_s']:.1f} tok/s "
            f"(decode_steps={d['decode_steps']} "
            f"useful/slot-step="
            f"{d['decode_tokens'] / max(d['decode_slot_steps'], 1):.2f})")
        log(f"{prefix} latency: ttft_mean={d['ttft_mean_s'] * 1e3:.1f}ms "
            f"ttft_p95={d['ttft_p95_s'] * 1e3:.1f}ms "
            f"tpot_mean={d['tpot_mean_s'] * 1e3:.1f}ms "
            f"e2e_mean={d['latency_mean_s'] * 1e3:.1f}ms "
            f"e2e_p95={d['latency_p95_s'] * 1e3:.1f}ms")
        log(f"{prefix} occupancy: slots={d['slots']} "
            f"busy={d['slot_occupancy'] * 100:.0f}% "
            f"queue_mean={d['queue_depth_mean']:.1f} "
            f"queue_max={d['queue_depth_max']}")
