"""Shared telemetry core of the port (``repro.telemetry``): tracing, JSON
logs, Prometheus formatting.

Training and serving speak one dialect, the JAX package's, so one trace
viewer, one log pipeline and one Prometheus scraper cover a deployment of
either package:

* :class:`Tracer` — a bounded ring buffer of Chrome-trace events
  (``ph: X`` complete spans / ``i`` instants / ``M`` metadata), with
  per-entity trace rows lazily assigned by key.  Serving keys rows by
  request id; training keys them by trainer index.
* :func:`enable_json_logs` / :func:`log_event` — one-line structured
  JSON records (``--log-json``) sharing ONE global switch, so a
  process that both trains and serves emits a single stream.
* :func:`prom_fmt` / :func:`prom_counter` / :func:`prom_gauge` /
  :func:`prom_labeled` — Prometheus text exposition (0.0.4)
  building blocks: every family gets ``# HELP`` + ``# TYPE`` headers,
  counters are suffixed ``_total`` by the caller, values are
  formatted per the text-format conventions (``NaN``/``+Inf``).

The event schema and the exposition text are the JAX package's, byte for
byte.  :mod:`repro_torch.serve.telemetry` and
:mod:`repro_torch.train.telemetry` layer serving's and training's
exposition on top.  Everything here is stdlib-only.
"""

from __future__ import annotations

import json
import math
import sys
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Tracer",
    "write_trace",
    "enable_json_logs",
    "json_logs_enabled",
    "log_event",
    "prom_fmt",
    "prom_counter",
    "prom_gauge",
    "prom_labeled",
    "SCHED_TID",
]

# Chrome-trace identifiers: one fake process, tid 0 for scheduler/
# orchestrator-level events, tid 1.. assigned per entity (request id on
# the serve side, trainer index on the train side) in sighting order.
_TRACE_PID = 1
SCHED_TID = 0


class Tracer:
    """Bounded ring buffer of Chrome-trace events.

    Events follow the Chrome trace-event JSON schema (``ph`` = ``"X"``
    complete spans, ``"i"`` instant events, ``"M"`` metadata);
    timestamps are microseconds from a per-tracer ``perf_counter``
    epoch.  The buffer is a ``deque(maxlen=capacity)`` so a long-running
    process holds at most ``capacity`` events; ``dropped`` counts how
    many were evicted.

    ``row_prefix`` names the lazily-assigned per-entity rows (``"req"``
    for serving, ``"trainer"`` for training).
    """

    def __init__(self, capacity: int = 8192, row_name: str = "scheduler",
                 row_prefix: str = "req"):
        self.capacity = int(capacity)
        self.events: deque = deque(maxlen=self.capacity)
        self.epoch = time.perf_counter()
        self.emitted = 0  # total events ever emitted (dropped = emitted - len)
        self.row_prefix = row_prefix
        self._tids: Dict[str, int] = {}  # str(key) -> tid
        self._next_tid = SCHED_TID + 1
        self._meta: List[dict] = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": _TRACE_PID,
                "tid": SCHED_TID,
                "args": {"name": row_name},
            }
        ]

    @property
    def dropped(self) -> int:
        """Events evicted from the ring so far."""
        return self.emitted - len(self.events)

    def _ts(self, t: float) -> float:
        """Convert a ``perf_counter`` reading to trace microseconds."""
        return (t - self.epoch) * 1e6

    def _tid(self, key: Any) -> int:
        """Stable numeric thread id for an entity key (lazily assigned)."""
        skey = str(key)
        tid = self._tids.get(skey)
        if tid is None:
            # keep the key->tid map bounded alongside the ring
            if len(self._tids) >= 4 * self.capacity:
                self._tids.clear()
            tid = self._next_tid
            self._next_tid += 1
            self._tids[skey] = tid
            self._meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": _TRACE_PID,
                    "tid": tid,
                    "args": {"name": f"{self.row_prefix} {skey}"},
                }
            )
            if len(self._meta) > 4 * self.capacity:
                del self._meta[1 : len(self._meta) // 2]
        return tid

    def _push(self, ev: dict) -> None:
        self.events.append(ev)
        self.emitted += 1

    def complete(
        self, name: str, tid: int, t0: float, t1: float, **args: Any
    ) -> None:
        """Record a complete span (``ph: X``) on a numeric tid."""
        self._push(
            {
                "name": name,
                "ph": "X",
                "ts": self._ts(t0),
                "dur": max(0.0, (t1 - t0) * 1e6),
                "pid": _TRACE_PID,
                "tid": tid,
                "args": args,
            }
        )

    def instant(
        self, name: str, tid: int, t: Optional[float] = None, **args: Any
    ) -> None:
        """Record an instant event (``ph: i``) on a numeric tid."""
        self._push(
            {
                "name": name,
                "ph": "i",
                "s": "t",
                "ts": self._ts(time.perf_counter() if t is None else t),
                "pid": _TRACE_PID,
                "tid": tid,
                "args": args,
            }
        )

    def req_span(
        self, name: str, rid: Any, t0: float, t1: float, **args: Any
    ) -> None:
        """Record a complete span on the entity's own trace row."""
        self.complete(name, self._tid(rid), t0, t1, rid=str(rid), **args)

    def req_instant(
        self, name: str, rid: Any, t: Optional[float] = None, **args: Any
    ) -> None:
        """Record an instant event on the entity's own trace row."""
        self.instant(name, self._tid(rid), t, rid=str(rid), **args)

    def export(self) -> dict:
        """Export the buffer as a Chrome-trace JSON object."""
        return {
            "traceEvents": self._meta + list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {
                "emitted": self.emitted,
                "dropped": self.dropped,
                "capacity": self.capacity,
            },
        }


def write_trace(tracer: Tracer, path: str) -> None:
    """Write a tracer's Chrome-trace JSON export to ``path``."""
    with open(path, "w") as f:
        json.dump(tracer.export(), f)


# ---- structured JSON logs -------------------------------------------------

_JSON_LOGS = {"enabled": False}


def enable_json_logs(enabled: bool = True) -> None:
    """Globally enable/disable one-line JSON log records (``--log-json``)."""
    _JSON_LOGS["enabled"] = bool(enabled)


def json_logs_enabled() -> bool:
    """Whether JSON log records are currently enabled."""
    return bool(_JSON_LOGS["enabled"])


def _json_safe(v: Any) -> Any:
    """Coerce a value to something ``json.dumps`` emits as valid JSON."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return str(v)


def log_event(event: str, **fields: Any) -> None:
    """Emit one JSON log line (monotonic + unix timestamps) if enabled."""
    if not _JSON_LOGS["enabled"]:
        return
    rec = {"event": event, "ts_monotonic": time.monotonic(),
           "ts_unix": time.time()}
    rec.update({k: _json_safe(v) for k, v in fields.items()})
    sys.stdout.write(json.dumps(rec, allow_nan=False) + "\n")
    sys.stdout.flush()


# ---- prometheus text-format building blocks -------------------------------


def prom_fmt(v: Any) -> str:
    """Format a sample value per Prometheus text conventions."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def _labels(labels: Dict[str, Any]) -> str:
    """Render a label dict as ``{k="v",...}`` (empty string for none)."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
    return "{" + inner + "}"


def prom_counter(out: List[str], name: str, help_: str, value: Any) -> None:
    """Append one unlabelled counter family (caller includes ``_total``)."""
    out.append(f"# HELP {name} {help_}")
    out.append(f"# TYPE {name} counter")
    out.append(f"{name} {prom_fmt(value)}")


def prom_gauge(out: List[str], name: str, help_: str, value: Any) -> None:
    """Append one unlabelled gauge family."""
    out.append(f"# HELP {name} {help_}")
    out.append(f"# TYPE {name} gauge")
    out.append(f"{name} {prom_fmt(value)}")


def prom_labeled(out: List[str], name: str, typ: str, help_: str,
                 samples: Iterable[Tuple[Dict[str, Any], Any]]) -> None:
    """Append one labelled family: ONE HELP/TYPE header, then one
    sample line per ``(labels, value)`` pair."""
    out.append(f"# HELP {name} {help_}")
    out.append(f"# TYPE {name} {typ}")
    for labels, value in samples:
        out.append(f"{name}{_labels(labels)} {prom_fmt(value)}")
