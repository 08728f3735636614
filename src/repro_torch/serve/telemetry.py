"""Serving telemetry of the port (``repro.serve.telemetry``): request
tracing, Prometheus export, the profiler window.

* :class:`ServeTelemetry` — the per-scheduler façade: owns a
  :class:`~repro_torch.telemetry.Tracer` that takes one span chain per
  request (``enqueue`` → ``queued`` → ``admit`` → ``prefill`` /
  ``prefill_chunk`` → ``first_token`` → ``finish``, or a terminal
  ``shed`` / ``cancel`` wherever the request was dropped) plus per-step phase
  spans, accumulates per-phase host wall time (``admit`` / ``prefill`` /
  ``decode`` / ``draft`` / ``verify``), and arms ``torch.profiler``
  around a window of scheduler steps (``--profile-steps``), which writes
  one Chrome trace per window.  Phase times are host time: a ``decode``
  phase ends after its logits are read to the host, so it covers the
  device work it waited for, but no phase adds a synchronize of its own.
* :func:`prometheus_text` / :func:`scheduler_prometheus` — Prometheus
  text-format (0.0.4) exposition of every ``[serve]`` counter, the
  bounded latency histograms, the page pool's occupancy, the phase
  times, with an online LTFB arena attached its per-member accept rate
  and served tokens and its promotions, and on rank 0 of a serving mesh
  every rank's counters, page high waters and arena series
  (``{rank=...}``, from the gathered ``remote_stats``), in the JAX
  package's text.
* :func:`stats_snapshot` — the compact JSON stats a mesh follower
  ships to host 0 (the arena's counters included).

The tracing and JSON-log primitives live in :mod:`repro_torch.telemetry` and are
re-exported here; nothing imports the scheduler, so the scheduler and
the metrics import this module freely.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from repro_torch.telemetry import (  # noqa: F401  (re-exported surface)
    SCHED_TID,
    Tracer,
    enable_json_logs,
    json_logs_enabled,
    log_event,
    prom_fmt as _fmt,
    write_trace,
)

__all__ = [
    "Tracer",
    "ServeTelemetry",
    "prometheus_text",
    "scheduler_prometheus",
    "stats_snapshot",
    "write_trace",
    "enable_json_logs",
    "json_logs_enabled",
    "log_event",
]


class ServeTelemetry:
    """Per-scheduler telemetry: tracer + phase attribution + profiler.

    ``enabled=False`` turns tracing and phase spans into no-ops (the
    counters of :class:`~repro_torch.serve.metrics.ServeStats` and the
    phase times stay on); the profiler window works regardless, so
    ``--profile-steps`` composes with ``--no-telemetry``.
    """

    def __init__(self, enabled: bool = True, trace_capacity: int = 8192):
        self.enabled = bool(enabled)
        self.tracer = Tracer(trace_capacity)
        # cumulative wall seconds per phase: admit / prefill / decode /
        # draft / verify
        self.phase_seconds: Dict[str, float] = {}
        self.phase_calls: Dict[str, int] = {}
        self._profile_req: Optional[tuple] = None  # (steps, outdir)
        self._profiler = None
        self._profile_left = 0
        self._profile_dir: Optional[str] = None
        self._profile_first = 0
        self.profiles_taken = 0
        self.profile_error: Optional[str] = None
        self.profile_files: List[str] = []

    # ---- request lifecycle ------------------------------------------------

    def req_instant(self, rid: Any, name: str, t: Optional[float] = None,
                    **args: Any) -> None:
        """Emit an instant event on the request's trace row (if enabled)."""
        if self.enabled:
            self.tracer.req_instant(name, rid, t, **args)

    def req_span(self, rid: Any, name: str, t0: Optional[float], t1: float,
                 **args: Any) -> None:
        """Emit a complete span on the request's trace row (if enabled)."""
        if self.enabled and t0 is not None:
            self.tracer.req_span(name, rid, t0, t1, **args)

    def terminal(self, rid: Any, kind: str, t: Optional[float] = None,
                 **args: Any) -> None:
        """Emit the request's terminal instant: finish / shed / cancel."""
        if self.enabled:
            self.tracer.req_instant(kind, rid, t, terminal=True, **args)

    def event(self, name: str, **args: Any) -> None:
        """Emit a scheduler-level instant event (a hot swap, …)."""
        if self.enabled:
            self.tracer.instant(name, SCHED_TID, **args)

    # ---- per-step phase attribution ---------------------------------------

    def phase(self, name: str, t0: float, t1: float, emit: bool = True,
              **args: Any) -> None:
        """Accumulate phase wall time; optionally emit a scheduler span."""
        dur = max(0.0, t1 - t0)
        self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) + dur
        self.phase_calls[name] = self.phase_calls.get(name, 0) + 1
        if self.enabled and emit:
            self.tracer.complete(name, SCHED_TID, t0, t1, **args)

    @contextmanager
    def timed_phase(self, name: str, emit: bool = True,
                    **args: Any) -> Iterator[None]:
        """Context manager sugar around :meth:`phase`."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase(name, t0, time.perf_counter(), emit=emit, **args)

    # ---- torch.profiler window --------------------------------------------

    def arm_profile(self, steps: int, outdir: str) -> None:
        """Arm ``torch.profiler`` around the next ``steps`` scheduler
        steps; the window's Chrome trace lands in ``outdir``."""
        self._profile_req = (max(1, int(steps)), str(outdir))

    def profile_armed(self) -> bool:
        """Whether a profile window is pending or currently recording."""
        return self._profile_req is not None or self._profiler is not None

    def step_begin(self, step: int) -> None:
        """Scheduler-step hook: start the profiler if a window is armed.

        A profiler that fails to start (another one already records, say)
        sets :attr:`profile_error` and the steps run unprofiled."""
        if self._profile_req is None or self._profiler is not None:
            return
        steps, outdir = self._profile_req
        self._profile_req = None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            if torch._C._autograd._profiler_enabled():
                # a second profiler would stop the one already recording
                raise RuntimeError("another profiler is already recording")
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:
            self.profile_error = f"{type(e).__name__}: {e}"
            log_event("profile_error", error=self.profile_error)
            return
        self._profiler = prof
        self._profile_left = steps
        self._profile_dir = outdir
        self._profile_first = step
        log_event("profile_start", steps=steps, dir=outdir, step=step)

    def step_end(self) -> None:
        """Scheduler-step hook: stop the profiler when the window closes
        and write its Chrome trace (``profile_step<first>.json``)."""
        if self._profiler is None:
            return
        self._profile_left -= 1
        if self._profile_left > 0:
            return
        prof, self._profiler = self._profiler, None
        try:
            prof.stop()
            os.makedirs(self._profile_dir, exist_ok=True)
            path = os.path.join(self._profile_dir,
                                f"profile_step{self._profile_first}.json")
            prof.export_chrome_trace(path)
        except Exception as e:
            self.profile_error = f"{type(e).__name__}: {e}"
            log_event("profile_error", error=self.profile_error)
            return
        self.profiles_taken += 1
        self.profile_files.append(path)
        log_event("profile_done", dir=self._profile_dir, path=path,
                  phase_seconds=dict(self.phase_seconds))


# ---- mesh stats snapshot --------------------------------------------------

# every [serve] counter a follower ships to host 0 (and prometheus
# exports)
_SNAPSHOT_COUNTERS = (
    "submitted",
    "completed",
    "rejected",
    "shed_overload",
    "shed_deadline",
    "cancelled",
    "ttft_deadline_misses",
    "tpot_deadline_misses",
    "prefills",
    "prefill_chunks",
    "prefill_tokens",
    "padded_prefill_tokens",
    "decode_steps",
    "decode_tokens",
    "decode_slot_steps",
    "ragged_splits",
    "spec_rounds",
    "spec_draft_steps",
    "spec_draft_proposed",
    "spec_draft_accepted",
    "spec_replays",
    "steps",
    "hot_swaps",
    "fault_injected",
    "swap_rejected_corrupt",
    "plan_retries",
    "journal_replayed",
    "arena_matches",
    "arena_promotions",
)


def _pool_shards(sched: Any) -> List[dict]:
    """Per-``data``-shard block-manager dicts for a scheduler's pool."""
    pool = getattr(sched, "pool", None)
    if pool is None:
        return []
    if hasattr(pool, "shard_dicts"):
        return pool.shard_dicts()
    blocks = getattr(pool, "blocks", None)
    return [blocks.as_dict()] if blocks is not None else []


def stats_snapshot(sched: Any, rank: int = 0) -> dict:
    """Compact per-process stats: every ``[serve]`` counter (0 where the
    scheduler keeps none), queue depth, busy slots, the pool's block
    counters and, with an arena attached, its :meth:`Arena.counters`, as
    a JAX mesh follower ships them to host 0."""
    s = sched.stats
    snap: Dict[str, Any] = {"rank": int(rank)}
    for k in _SNAPSHOT_COUNTERS:
        snap[k] = int(getattr(s, k, 0))
    snap["queue_depth"] = len(getattr(sched, "queue", ()))
    snap["slots_busy"] = len(getattr(sched, "active", ())) + len(
        getattr(sched, "prefilling", ())
    )
    snap["shards"] = _pool_shards(sched)
    arena = getattr(sched, "arena", None)
    if arena is not None:
        snap["arena"] = arena.counters()
    return snap


# ---- prometheus exposition ------------------------------------------------

_PREFIX = "repro_serve_"

_COUNTER_HELP = {
    "submitted": "requests submitted",
    "completed": "requests completed",
    "rejected": "requests rejected at submit (queue full)",
    "shed_overload": "requests shed for overload",
    "shed_deadline": "queued requests shed on expired TTFT deadline",
    "cancelled": "requests cancelled",
    "ttft_deadline_misses": "completions whose first token was late",
    "tpot_deadline_misses": "completions whose mean TPOT was over budget",
    "prefills": "prefill dispatches",
    "prefill_chunks": "chunked-prefill slices",
    "prefill_tokens": "prompt tokens prefilled",
    "padded_prefill_tokens": "prompt tokens incl. bucket padding",
    "decode_steps": "batched decode steps",
    "decode_tokens": "tokens decoded",
    "decode_slot_steps": "per-slot decode steps",
    "ragged_splits": "ragged gather-width split dispatches",
    "spec_rounds": "speculative verify rounds",
    "spec_draft_steps": "drafter decode dispatches",
    "spec_draft_proposed": "draft tokens proposed",
    "spec_draft_accepted": "draft tokens accepted",
    "spec_replays": "speculative rollback replay steps",
    "steps": "scheduler steps",
    "hot_swaps": "weight hot swaps applied",
    "fault_injected": "harness faults fired (--fault-spec)",
    "swap_rejected_corrupt":
        "hot swaps rejected on a corrupt/torn winner checkpoint",
    "plan_retries": "mesh plan-channel fetch retries before success",
    "journal_replayed": "requests requeued from the request journal",
    "arena_matches": "online-LTFB arena match evaluations",
    "arena_promotions": "online-LTFB arena champion promotions",
}

_SHARD_GAUGES = {
    "used_blocks": "KV pages currently allocated",
    "committed_blocks": "KV pages reserved by admitted requests",
    "pinned_blocks": "KV pages pinned by the prefix pin tier",
    "high_water_blocks": "peak KV pages allocated",
    "num_blocks": "KV page capacity",
}


def _hist_lines(out: List[str], name: str, help_: str, series: Any) -> None:
    """Append one histogram family from a BoundedSeries to ``out``."""
    out.append(f"# HELP {name} {help_}")
    out.append(f"# TYPE {name} histogram")
    cum = 0
    for le, n in series.hist.bucket_counts():
        cum += n
        out.append(f'{name}_bucket{{le="{_fmt(le)}"}} {cum}')
    out.append(f'{name}_bucket{{le="+Inf"}} {series.hist.total}')
    out.append(f"{name}_sum {_fmt(series.hist.sum)}")
    out.append(f"{name}_count {series.hist.total}")


def _arena_lines(out: List[str], arena: dict) -> None:
    """Append the online arena's families (per-member accept-rate and
    served-token gauges, the promotion counter) from an
    ``Arena.counters()`` dict."""
    members = arena.get("members", {})
    fams = (
        ("accept_rate", "gauge",
         "per-member sliding-window spec accept rate",
         lambda m: m.get("accept_rate", 0.0)),
        ("served_tokens", "gauge",
         "tokens served while the member was champion",
         lambda m: int(m.get("served_tokens", 0))),
    )
    for suffix, typ, help_, get in fams:
        name = f"{_PREFIX}arena_{suffix}"
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {typ}")
        for member in sorted(members):
            out.append(f'{name}{{member="{member}"}} '
                       f"{_fmt(get(members[member]))}")
    name = f"{_PREFIX}arena_promotions_total"
    out.append(f"# HELP {name} arena champion promotions")
    out.append(f"# TYPE {name} counter")
    out.append(f"{name} {int(arena.get('promotions', 0))}")


def _mesh_arena_lines(out: List[str], ranked: List[tuple]) -> None:
    """Append the per-rank arena member series (``{rank=,member=}``): one
    HELP/TYPE header a family, every rank's samples under it."""
    fams = (
        ("accept_rate", "gauge",
         "per-rank per-member spec accept rate",
         lambda m: m.get("accept_rate", 0.0)),
        ("served_tokens", "gauge",
         "per-rank tokens served while the member was champion",
         lambda m: int(m.get("served_tokens", 0))),
    )
    for suffix, typ, help_, get in fams:
        name = f"{_PREFIX}mesh_arena_{suffix}"
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {typ}")
        for rank, arena in ranked:
            for member in sorted(arena.get("members", {})):
                out.append(
                    f'{name}{{rank="{rank}",member="{member}"}} '
                    f"{_fmt(get(arena['members'][member]))}")
    name = f"{_PREFIX}mesh_arena_promotions_total"
    out.append(f"# HELP {name} per-rank arena champion promotions")
    out.append(f"# TYPE {name} counter")
    for rank, arena in ranked:
        out.append(f'{name}{{rank="{rank}"}} '
                   f"{int(arena.get('promotions', 0))}")


def _mesh_lines(out: List[str], remote_stats: Dict[int, dict]) -> None:
    """Append the serving mesh's per-rank families from the gathered
    :func:`stats_snapshot` dicts: every counter, each rank's page high
    water per data shard and, where ranks carry an arena, its series."""
    name = f"{_PREFIX}mesh"
    out.append(f"# HELP {name}_counters per-rank mesh counters")
    for k in _SNAPSHOT_COUNTERS:
        fam = f"{name}_{k}_total"
        out.append(f"# TYPE {fam} counter")
        for rank in sorted(remote_stats):
            snap = remote_stats[rank]
            out.append(f'{fam}{{rank="{rank}"}} {int(snap.get(k, 0))}')
    fam = f"{name}_pool_high_water_blocks"
    out.append(f"# HELP {fam} peak KV pages per rank and data shard")
    out.append(f"# TYPE {fam} gauge")
    for rank in sorted(remote_stats):
        for i, sh in enumerate(remote_stats[rank].get("shards", [])):
            out.append(
                f'{fam}{{rank="{rank}",shard="{i}"}} '
                f"{int(sh.get('high_water_blocks', 0))}"
            )
    ranked = [(r, remote_stats[r]["arena"])
              for r in sorted(remote_stats)
              if remote_stats[r].get("arena")]
    if ranked:
        _mesh_arena_lines(out, ranked)


def prometheus_text(
    stats: Any,
    pool_shards: Optional[List[dict]] = None,
    phase_seconds: Optional[Dict[str, float]] = None,
    remote_stats: Optional[Dict[int, dict]] = None,
    queue_depth: Optional[int] = None,
    slots_busy: Optional[int] = None,
    arena: Optional[dict] = None,
) -> str:
    """Render a ServeStats (+ pool/phase context) as Prometheus text.

    Exposition format 0.0.4: ``# HELP`` / ``# TYPE`` per family,
    counters suffixed ``_total``, latency histograms with cumulative
    ``_bucket{le=...}`` + ``_sum`` + ``_count``, per-shard pool gauges
    labelled ``{shard=...}``, per-phase seconds ``{phase=...}``, the
    arena's per-member series ``{member=...}`` from ``arena`` (an
    ``Arena.counters()`` dict) and the serving mesh's per-rank series
    ``{rank=...}`` from ``remote_stats`` (rank -> :func:`stats_snapshot`).
    """
    out: List[str] = []
    for k, help_ in _COUNTER_HELP.items():
        name = f"{_PREFIX}{k}_total"
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} counter")
        out.append(f"{name} {int(getattr(stats, k, 0))}")

    wall = stats.wall
    gauges = [
        ("wall_seconds", "serving wall-clock seconds", wall),
        ("slots", "decode slot capacity", getattr(stats, "slots", 0)),
    ]
    if queue_depth is not None:
        gauges.append(("queue_depth", "requests waiting for admission",
                       queue_depth))
    if slots_busy is not None:
        gauges.append(("slots_busy", "slots prefilling or decoding",
                       slots_busy))
    d = stats.as_dict()
    for k in ("tokens_per_s", "requests_per_s", "spec_accept_rate",
              "spec_k_mean", "queue_depth_mean", "slot_occupancy"):
        v = d.get(k)
        if v is not None:
            gauges.append((k, k.replace("_", " "), v))
    for k, help_, v in gauges:
        name = f"{_PREFIX}{k}"
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} gauge")
        out.append(f"{name} {_fmt(v)}")

    _hist_lines(out, f"{_PREFIX}ttft_seconds", "time to first token",
                stats.ttft)
    _hist_lines(out, f"{_PREFIX}tpot_seconds", "time per output token",
                stats.tpot)
    _hist_lines(out, f"{_PREFIX}latency_seconds", "request latency",
                stats.latency)

    if phase_seconds:
        name = f"{_PREFIX}phase_seconds_total"
        out.append(f"# HELP {name} cumulative wall seconds per step phase")
        out.append(f"# TYPE {name} counter")
        for ph in sorted(phase_seconds):
            out.append(f'{name}{{phase="{ph}"}} {_fmt(phase_seconds[ph])}')

    if pool_shards:
        for k, help_ in _SHARD_GAUGES.items():
            name = f"{_PREFIX}pool_{k}"
            out.append(f"# HELP {name} {help_} (per data shard)")
            out.append(f"# TYPE {name} gauge")
            for i, sh in enumerate(pool_shards):
                out.append(f'{name}{{shard="{i}"}} {int(sh.get(k, 0))}')

    if arena:
        _arena_lines(out, arena)
    if remote_stats:
        _mesh_lines(out, remote_stats)
    return "\n".join(out) + "\n"


def scheduler_prometheus(sched: Any) -> str:
    """Prometheus text for a live scheduler (stats + pool + phases + the
    online arena when one is attached + every mesh rank's series on rank
    0 of a serving mesh)."""
    tel = getattr(sched, "telemetry", None)
    arena = getattr(sched, "arena", None)
    return prometheus_text(
        sched.stats,
        pool_shards=_pool_shards(sched),
        phase_seconds=tel.phase_seconds if tel is not None else None,
        remote_stats=getattr(sched, "remote_stats", None),
        queue_depth=len(getattr(sched, "queue", ())),
        slots_busy=len(getattr(sched, "active", ()))
        + len(getattr(sched, "prefilling", ())),
        arena=arena.counters() if arena is not None else None,
    )
