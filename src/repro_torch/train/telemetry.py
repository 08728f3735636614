"""The LTFB round's parallel-efficiency figures
(``repro.train.telemetry.efficiency_snapshot``).

Tracing, the Prometheus export, the genealogy log and ``step_flops`` are
not ported yet (ROADMAP.md queue A5).
"""
from __future__ import annotations

from typing import Any, Dict, List


def efficiency_snapshot(per_trainer: List[Dict[str, float]],
                        batch_size: int, tournament_seconds: float,
                        round_wall_seconds: float) -> Dict[str, Any]:
    """The paper's speedup/efficiency figures from one round's timings.

    ``per_trainer`` holds per-trainer deltas for the round: ``steps``,
    ``train_seconds`` (wall inside the train loop) and
    ``data_wait_seconds``.  The single-trainer baseline is the mean
    per-trainer training rate (samples per train-loop second); the
    parallel rate divides aggregate samples by the *parallel* round time,
    the slowest trainer plus the tournament, as if every trainer ran on a
    card of its own.  On one card the trainers time-share it, and
    ``round_wall_seconds`` reports the measured serialized wall beside.
    ``speedup`` is the parallel rate over the single-trainer rate;
    ``efficiency`` divides by the trainer count.
    """
    active = [d for d in per_trainer if d.get("steps", 0) > 0]
    k = len(active)
    out: Dict[str, Any] = {
        "trainers": k,
        "tournament_seconds": tournament_seconds,
        "round_wall_seconds": round_wall_seconds,
        "data_wait_seconds": sum(d.get("data_wait_seconds", 0.0)
                                 for d in active),
    }
    if not active:
        return out
    samples = sum(d["steps"] * batch_size for d in active)
    rates = [d["steps"] * batch_size / d["train_seconds"]
             for d in active if d.get("train_seconds", 0.0) > 0]
    slowest = max(d.get("train_seconds", 0.0) for d in active)
    parallel_seconds = slowest + max(0.0, tournament_seconds)
    out["samples"] = samples
    if not rates or parallel_seconds <= 0:
        return out
    single_rate = sum(rates) / len(rates)
    parallel_rate = samples / parallel_seconds
    out["single_trainer_samples_per_s"] = single_rate
    out["parallel_samples_per_s"] = parallel_rate
    out["speedup"] = parallel_rate / single_rate if single_rate else 0.0
    out["efficiency"] = out["speedup"] / k
    return out
