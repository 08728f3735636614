"""Serving metrics of the port: throughput / latency / queue accounting.

``percentile``, ``Histogram`` and ``BoundedSeries`` are copies of
``repro.serve.metrics``; :class:`ServeStats` keeps the counters the
port's scheduler updates under the JAX package's names: population
speculative decoding's ``spec_*``, the request lifecycle's sheds,
cancellations and deadline misses, the faults fired, the requests a
journal requeued and the online arena's matches and promotions.  It
keeps no counter of a path the port does not run: the mesh's
``plan_retries`` (ROADMAP.md queue A6), which the Prometheus export
reads as 0.
Under ``--log-json``
:meth:`ServeStats.report` also emits the summary as one ``serve_report``
record.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

from repro_torch.telemetry import json_logs_enabled, log_event


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
    land in the implicit ``+Inf`` bucket.  ``bucket_counts`` yields
    per-bucket (non-cumulative) counts for the finite bounds — the
    Prometheus exporter accumulates them into cumulative ``le`` series.
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

    def bucket_counts(self) -> List[tuple]:
        """Per-bucket ``(upper_bound, count)`` pairs for finite bounds."""
        return list(zip(self.bounds, self.counts[:-1]))


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
    # SLO-aware admission (the gateway's front door)
    shed_overload: int = 0         # submits refused: queue at max_queue
    shed_deadline: int = 0         # queued requests dropped: TTFT deadline
    cancelled: int = 0             # in-flight requests cancelled by caller
    ttft_deadline_misses: int = 0  # completed, but first token was late
    tpot_deadline_misses: int = 0  # completed, but mean TPOT was over
    prefills: int = 0
    prefill_chunks: int = 0        # chunked-prefill slices processed
    prefill_tokens: int = 0        # true prompt tokens processed
    padded_prefill_tokens: int = 0  # incl. bucket padding (waste measure)
    decode_steps: int = 0
    decode_tokens: int = 0         # useful generated tokens
    decode_slot_steps: int = 0     # slots * steps actually computed
    # speculative decoding (population drafter)
    spec_rounds: int = 0           # target verify steps
    spec_draft_steps: int = 0      # drafter decode dispatches
    spec_draft_proposed: int = 0   # draft tokens offered for verify
    spec_draft_accepted: int = 0   # draft tokens the target kept
    spec_replays: int = 0          # rollback replay steps
    spec_k_sum: int = 0            # proposals offered, summed per row-round
    spec_k_rows: int = 0           # row-rounds that offered proposals
    ragged_splits: int = 0         # width-split subset decode dispatches
    hot_swaps: int = 0             # weight swaps applied between steps
    # fault tolerance (serve/journal.py, serve/faults.py, the registry)
    fault_injected: int = 0        # harness faults fired (--fault-spec)
    swap_rejected_corrupt: int = 0  # hot swaps refused: corrupt checkpoint
    journal_replayed: int = 0      # requests requeued from a journal
    # online LTFB arena (serve/arena.py)
    arena_matches: int = 0         # match evaluations run
    arena_promotions: int = 0      # champion promotions applied
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
            "shed_overload": self.shed_overload,
            "shed_deadline": self.shed_deadline,
            "cancelled": self.cancelled,
            "ttft_deadline_misses": self.ttft_deadline_misses,
            "tpot_deadline_misses": self.tpot_deadline_misses,
            "prefills": self.prefills,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "padded_prefill_tokens": self.padded_prefill_tokens,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "decode_slot_steps": self.decode_slot_steps,
            "spec_rounds": self.spec_rounds,
            "spec_draft_steps": self.spec_draft_steps,
            "spec_draft_proposed": self.spec_draft_proposed,
            "spec_draft_accepted": self.spec_draft_accepted,
            "spec_replays": self.spec_replays,
            "spec_accept_rate": self.spec_draft_accepted
            / max(self.spec_draft_proposed, 1),
            "spec_k_mean": self.spec_k_sum / max(self.spec_k_rows, 1),
            "ragged_splits": self.ragged_splits,
            "hot_swaps": self.hot_swaps,
            "fault_injected": self.fault_injected,
            "swap_rejected_corrupt": self.swap_rejected_corrupt,
            "journal_replayed": self.journal_replayed,
            "arena_matches": self.arena_matches,
            "arena_promotions": self.arena_promotions,
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
        """Print the human-readable ``[serve]`` summary via ``log``;
        under ``--log-json`` the same summary also goes out as one
        ``serve_report`` JSON record."""
        d = self.as_dict()
        if json_logs_enabled():
            log_event("serve_report", **d)
        log(f"{prefix} requests: submitted={d['submitted']} "
            f"completed={d['completed']} rejected={d['rejected']} "
            f"hot_swaps={d['hot_swaps']}")
        if self.shed_overload or self.shed_deadline or self.cancelled \
                or self.ttft_deadline_misses or self.tpot_deadline_misses:
            log(f"{prefix} admission: shed_overload={d['shed_overload']} "
                f"shed_deadline={d['shed_deadline']} "
                f"cancelled={d['cancelled']} "
                f"ttft_misses={d['ttft_deadline_misses']} "
                f"tpot_misses={d['tpot_deadline_misses']}")
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
        if self.fault_injected or self.swap_rejected_corrupt \
                or self.journal_replayed:
            log(f"{prefix} robustness: fault_injected={d['fault_injected']} "
                f"swap_rejected_corrupt={d['swap_rejected_corrupt']} "
                f"journal_replayed={d['journal_replayed']}")
        if self.arena_matches or self.arena_promotions:
            log(f"{prefix} arena: matches={d['arena_matches']} "
                f"promotions={d['arena_promotions']}")
        if self.spec_rounds:
            log(f"{prefix} speculative: rounds={d['spec_rounds']} "
                f"accept_rate={d['spec_accept_rate'] * 100:.0f}% "
                f"accepted={d['spec_draft_accepted']}"
                f"/{d['spec_draft_proposed']} "
                f"draft_steps={d['spec_draft_steps']} "
                f"replays={d['spec_replays']} "
                f"k_mean={d['spec_k_mean']:.2f}")
