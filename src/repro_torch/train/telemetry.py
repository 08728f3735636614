"""Training-side telemetry of the port's LTFB tournament
(``repro.train.telemetry``; the paper's §IV measurements).

The paper's headline results are measurements -- speedup, parallel
efficiency, exchange bytes -- and the port reports them in the JAX
package's dialect (one trace viewer, one log pipeline, one Prometheus
scraper for either package):

* :class:`TrainTelemetry` — per-trainer step-time attribution.  Every
  trainer gets its own Chrome-trace row (``trainer N``); the population
  loop emits ``data_wait`` / ``step`` / ``train_round`` spans, the
  tournament emits ``tournament_eval`` / ``partner_exchange`` spans
  (also from executor threads — emission is locked), and the
  orchestrator emits round/checkpoint spans on the orchestrator row.
  Export with :func:`repro_torch.telemetry.write_trace` (``--trace-out``).
  Spans are host time: a ``step`` span ends when the step's launches
  are queued, not when the card has run them; ``train_round`` ends after
  the round's last metrics are read to the host, so it covers the
  device work.
* :class:`GenealogyLog` / :func:`replay_genealogy` — the tournament
  genealogy: one JSONL record per match / round / rescale / failure /
  recovery / checkpoint, flushed per record, with torn-tail-tolerant
  replay, so a champion's descent is reconstructable from artifacts
  (``python -m repro_torch.launch.lineage``).  Either package replays
  the other's file.
* :func:`train_prometheus` / :func:`write_prom` /
  :class:`MetricsServer` — Prometheus text exposition (``repro_train_``
  prefix, the JAX package's text for the same stats) written to
  ``--prom-out`` each round or served from a stdlib HTTP endpoint
  (``--metrics-port``).
* :func:`efficiency_snapshot` / :func:`step_flops` — the paper's
  speedup/efficiency from instrumented timings, in samples/s and, when
  a step's FLOPs are countable, in model-FLOP/s.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional

from repro_torch.telemetry import (
    SCHED_TID,
    Tracer,
    log_event,
    prom_counter,
    prom_gauge,
    prom_labeled,
)

__all__ = [
    "TrainTelemetry",
    "GenealogyLog",
    "replay_genealogy",
    "train_prometheus",
    "write_prom",
    "MetricsServer",
    "efficiency_snapshot",
    "step_flops",
]


class TrainTelemetry:
    """Per-trainer tracing + phase attribution for the LTFB loop.

    Wraps a :class:`repro_torch.telemetry.Tracer` whose per-entity rows
    are keyed by trainer index (``trainer 0``, ``trainer 1``, …; the
    orchestrator row is tid 0).  Tournament-eval spans are emitted from
    the async-eval executor's threads, so every tracer mutation is
    guarded by one lock.  ``phase_seconds`` accumulates wall time per
    phase (``data_wait`` / ``compute`` / ``tournament_eval`` /
    ``partner_exchange`` / ``checkpoint`` / ``restore``) for the
    Prometheus export.
    """

    def __init__(self, enabled: bool = True, trace_capacity: int = 8192):
        self.enabled = bool(enabled)
        self.tracer = Tracer(trace_capacity, row_name="orchestrator",
                             row_prefix="trainer")
        self.phase_seconds: Dict[str, float] = {}
        self.phase_calls: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add_phase(self, name: str, seconds: float) -> None:
        """Accumulate phase wall time without emitting a span."""
        with self._lock:
            self.phase_seconds[name] = \
                self.phase_seconds.get(name, 0.0) + max(0.0, seconds)
            self.phase_calls[name] = self.phase_calls.get(name, 0) + 1

    def trainer_span(self, name: str, trainer: int, t0: float, t1: float,
                     phase: Optional[str] = None, **args: Any) -> None:
        """Emit a complete span on a trainer's trace row (thread-safe).

        ``phase`` additionally accumulates the duration into
        :attr:`phase_seconds` under that name.
        """
        if phase is not None:
            self.add_phase(phase, t1 - t0)
        if not self.enabled:
            return
        with self._lock:
            self.tracer.req_span(name, trainer, t0, t1, **args)

    def span(self, name: str, t0: float, t1: float,
             phase: Optional[str] = None, **args: Any) -> None:
        """Emit a complete span on the orchestrator row (thread-safe)."""
        if phase is not None:
            self.add_phase(phase, t1 - t0)
        if not self.enabled:
            return
        with self._lock:
            self.tracer.complete(name, SCHED_TID, t0, t1, **args)

    def event(self, name: str, **args: Any) -> None:
        """Emit an instant event on the orchestrator row (failure,
        recovery, …)."""
        if not self.enabled:
            return
        with self._lock:
            self.tracer.instant(name, SCHED_TID, **args)


# ---- tournament genealogy -------------------------------------------------


class GenealogyLog:
    """Append-only JSONL genealogy of an LTFB population.

    One record per event, ``{"t": <kind>, ...}``: ``init``, ``match``
    (one per pairwise comparison: round, trainer, partner, both metric
    values, winner, whether the model was adopted, the pairing seed),
    ``round`` (per round: best metric, timings, efficiency),
    ``rescale`` / ``fail`` / ``recover`` (ancestry-relevant topology
    changes) and ``checkpoint`` / ``resume``; the serving arena of either
    package (:mod:`repro_torch.serve.arena`) appends ``promotion``
    records to the same file.  Records are flushed
    per append and fsynced on :meth:`sync`/:meth:`close`; a torn final
    line is tolerated on replay.
    """

    def __init__(self, path: str):
        self.path = str(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "a")
        self.records_written = 0

    def append(self, t: str, **fields: Any) -> None:
        """Append one ``{"t": t, **fields}`` record (flushed, not yet
        fsynced — call :meth:`sync` at durability points)."""
        rec = {"t": t}
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self.records_written += 1

    def sync(self) -> None:
        """fsync the log (ordered before a checkpoint's effects)."""
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        """Sync and close (idempotent)."""
        if not self._f.closed:
            self.sync()
            self._f.close()


def replay_genealogy(path: str) -> List[dict]:
    """Read a genealogy JSONL, tolerating a torn final line.

    Replay stops at the first undecodable record (the writer died
    mid-line), so a crashed run's log is still usable up to its last
    durable record.  A missing file replays as no records.
    """
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return []
    records: List[dict] = []
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            break                       # torn tail — stop replay here
        records.append(rec)
    return records


# ---- live parallel-efficiency accounting ----------------------------------


def _to_meta(tree):
    """``tree`` with every tensor replaced by an empty one of its shape
    and dtype on the ``meta`` device (no storage, no copy)."""
    import torch

    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device="meta")
    return tree


def step_flops(train_step, *example_args) -> Optional[float]:
    """FLOPs of one train step, counted by
    ``torch.utils.flop_counter.FlopCounterMode``.

    The step runs once on ``meta`` copies of ``example_args`` (one step's
    arguments): nothing is computed, no tensor of the caller's is read or
    written, and no second weight or optimizer state is allocated.  The
    count covers the products PyTorch dispatches (matmuls, convolutions,
    attention); a step marked ``hidden_kernel_flops`` launches kernels of
    its own through ``ctypes``, which the counter cannot see, and gets
    None, as does a step that fails on ``meta`` tensors (the efficiency
    figures then stay in samples/s only; the failure goes out as a
    ``step_flops_error`` record under ``--log-json``).
    """
    if getattr(train_step, "hidden_kernel_flops", False):
        return None
    try:
        from torch.utils.flop_counter import FlopCounterMode

        args = _to_meta(example_args)
        with FlopCounterMode(display=False) as counter:
            train_step(*args)
        flops = counter.get_total_flops()
        return float(flops) if flops else None
    except Exception as e:      # the count is optional: training goes on
        log_event("step_flops_error", error=f"{type(e).__name__}: {e}")
        return None


def efficiency_snapshot(per_trainer: List[Dict[str, float]],
                        batch_size: int, tournament_seconds: float,
                        round_wall_seconds: float,
                        flops_per_step: Optional[float] = None
                        ) -> Dict[str, Any]:
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
    ``efficiency`` divides by the trainer count.  With
    ``flops_per_step`` the same figures are restated in model-FLOP/s.
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
    if flops_per_step:
        steps = sum(d["steps"] for d in active)
        out["flops_per_step"] = flops_per_step
        out["model_flops_per_s"] = flops_per_step * steps / parallel_seconds
    return out


# ---- prometheus exposition ------------------------------------------------

_PREFIX = "repro_train_"

# StoreStats counters exported per trainer and in total (keys match
# repro_torch.datastore.store.StoreStats.as_dict)
_STORE_COUNTERS = (
    ("samples_fetched", "samples fetched from the datastore"),
    ("file_opens", "bundle file opens"),
    ("bytes_read", "bytes read from bundle files"),
    ("exchange_bytes", "datastore owner->consumer exchange bytes"),
    ("cache_hits", "datastore cache hits"),
    ("cache_misses", "datastore cache misses"),
)


def train_prometheus(stats: Dict[str, Any],
                     phase_seconds: Optional[Dict[str, float]] = None
                     ) -> str:
    """Render :meth:`TournamentOrchestrator.stats` as Prometheus text.

    Format 0.0.4, ``repro_train_`` prefix, the JAX package's text for the
    same stats: round/step/sample counters, per-trainer ``{trainer=...}``
    gauges for the last train-step metrics and tournament metric,
    wins/adoptions, partition sizes, datastore ingestion counters,
    model-exchange bytes + effective exchange bandwidth,
    checkpoint/restore durations, phase attribution and the live
    speedup/efficiency figures.
    """
    out: List[str] = []
    per = stats.get("per_trainer", [])
    total = stats.get("total", {})
    prom_counter(out, f"{_PREFIX}rounds_total", "tournament rounds",
                 int(stats.get("round", 0)))
    prom_counter(out, f"{_PREFIX}steps_total", "train steps (all trainers)",
                 int(sum(d.get("steps", 0) for d in per)))
    prom_counter(out, f"{_PREFIX}tournament_exchange_bytes_total",
                 "model bytes exchanged by tournaments",
                 int(stats.get("tournament_exchange_bytes", 0)))
    for key, help_ in (
            ("train_seconds", "wall seconds inside the train loop"),
            ("data_wait_seconds", "wall seconds waiting on batches"),
            ("tournament_seconds", "wall seconds running tournaments"),
            ("checkpoint_seconds", "wall seconds saving checkpoints"),
            ("restore_seconds", "wall seconds restoring checkpoints"),
            ("prefetch_wait_seconds",
             "wall seconds the train loop blocked on the prefetch queue"),
    ):
        v = stats.get(key)
        if v is None:
            v = sum(d.get(key, 0.0) for d in per)
        prom_counter(out, f"{_PREFIX}{key}_total", help_, float(v))
    for key, help_ in (
            ("rescales", "elastic rescale events"),
            ("failures", "trainer failure events"),
            ("recoveries", "trainer recovery events"),
            ("checkpoints", "population checkpoints saved"),
            ("restores", "population checkpoints restored"),
    ):
        prom_counter(out, f"{_PREFIX}{key}_total", help_,
                     int(stats.get("events", {}).get(key, 0)))
    for key, help_ in _STORE_COUNTERS:
        prom_counter(out, f"{_PREFIX}datastore_{key}_total", help_,
                     int(total.get(key, 0)))
        prom_labeled(
            out, f"{_PREFIX}trainer_{key}_total", "counter",
            f"{help_} (per trainer)",
            [({"trainer": i}, int(d.get(key, 0)))
             for i, d in enumerate(per)])

    def per_gauge(key: str, help_: str, cast=float) -> None:
        prom_labeled(out, f"{_PREFIX}trainer_{key}", "gauge", help_,
                     [({"trainer": i}, cast(d.get(key, 0)))
                      for i, d in enumerate(per)])

    per_gauge("wins", "pairwise tournament wins", int)
    per_gauge("adoptions", "partner models adopted", int)
    per_gauge("steps", "train steps taken", int)
    per_gauge("alive", "trainer liveness", bool)
    per_gauge("files", "manifest files in the trainer's partition", int)
    per_gauge("partition_samples", "samples in the trainer's partition",
              int)
    prom_labeled(
        out, f"{_PREFIX}trainer_tournament_metric", "gauge",
        "last tournament metric on local held-out data (lower is better)",
        [({"trainer": i}, float(d["tournament_metric"]))
         for i, d in enumerate(per)
         if d.get("tournament_metric") is not None])
    metric_samples = []
    for i, d in enumerate(per):
        for name, v in sorted(d.get("train_metrics", {}).items()):
            metric_samples.append(({"trainer": i, "metric": name},
                                   float(v)))
    prom_labeled(out, f"{_PREFIX}trainer_loss", "gauge",
                 "last train-step metrics", metric_samples)

    exch = int(stats.get("tournament_exchange_bytes", 0))
    tourn_s = float(stats.get("tournament_seconds", 0.0))
    prom_gauge(out, f"{_PREFIX}exchange_bandwidth_bytes_per_s",
               "effective model-exchange bandwidth "
               "(tournament bytes / tournament seconds)",
               exch / tourn_s if tourn_s > 0 else 0.0)
    eff = stats.get("efficiency") or {}
    for key, help_ in (
            ("single_trainer_samples_per_s",
             "single-trainer-equivalent training rate"),
            ("parallel_samples_per_s", "aggregate parallel training rate"),
            ("speedup", "parallel speedup over one trainer (paper fig11)"),
            ("efficiency", "parallel efficiency = speedup / trainers"),
            # the JAX package's help text, kept so both packages expose
            # the same bytes; the port counts with FlopCounterMode
            ("flops_per_step", "XLA-estimated FLOPs per compiled step"),
            ("model_flops_per_s", "aggregate model FLOP/s"),
    ):
        v = eff.get(key)
        if v is not None:
            prom_gauge(out, f"{_PREFIX}{key}", help_, float(v))
    if phase_seconds:
        prom_labeled(out, f"{_PREFIX}phase_seconds_total", "counter",
                     "cumulative wall seconds per phase",
                     [({"phase": ph}, float(phase_seconds[ph]))
                      for ph in sorted(phase_seconds)])
    return "\n".join(out) + "\n"


def write_prom(text: str, path: str) -> None:
    """Atomically write a Prometheus exposition snapshot (tmp+rename,
    so a scraper reading mid-round never sees a half-written file)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


class MetricsServer:
    """Tiny stdlib HTTP endpoint serving the latest Prometheus snapshot.

    Any ``GET`` path (``/metrics`` by convention) returns the text last
    passed to :meth:`update`, on ``127.0.0.1:port`` (``port=0``: an
    ephemeral port, read back from :attr:`port`).
    """

    def __init__(self, port: int = 0):
        import http.server

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            """Serves the owning MetricsServer's latest snapshot."""

            def do_GET(self):  # noqa: N802 (stdlib handler API)
                """Return the latest exposition text."""
                body = server.text.encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                """Silence per-request stderr logging."""

        self.text = ""
        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", int(port)), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        log_event("metrics_server_started", port=self.port)

    def update(self, text: str) -> None:
        """Swap in a fresh exposition snapshot."""
        self.text = text

    def close(self) -> None:
        """Stop serving and join the thread."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
