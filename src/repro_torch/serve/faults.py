"""Deterministic fault injection for the port's serving stack.

A copy of ``repro.serve.faults`` (the port imports nothing of
``repro``).  Faults are scheduled at EXACT scheduler step numbers from a
compact spec string (``--fault-spec``), so every failure-handling path —
journal crash recovery, the registry's quarantine of a corrupt winner,
pool exhaustion, client disconnects — is tested by *reproducible* runs
instead of sleeps and signals sent by hand.

Spec syntax: comma-separated events, each ``kind@step[:key=val...]``::

    kill@12                       SIGKILL this process at step 12
    crash@12                      raise InjectedFault (in-process tests)
    stall@5:secs=0.2              sleep 0.2s inside step 5
    corrupt@8                     truncate the newest winner checkpoint
    oom@7:hold=3                  block admission for steps 7..9
    disconnect@6                  cancel the oldest in-flight request
    kill@12:rank=1                same, but only on mesh rank 1

Each event fires on exactly ONE process: ``rank`` defaults to 0, is
parsed as the JAX package parses it, and names the mesh rank whose
scheduler fires it (``repro_torch.launch.distributed``).  The injector is invoked at the top of every
scheduler step (before the hot-swap poll, so ``corrupt@N`` lands before
step N's registry refresh) and counts each firing into
``stats.fault_injected``.
"""
from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.serve.telemetry import log_event


class InjectedFault(RuntimeError):
    """Raised by ``crash`` events — the in-process stand-in for a
    SIGKILL that unit tests can catch (the process state after the
    raise is exactly what a kill leaves behind: an un-flushed step)."""


KINDS = ("kill", "crash", "stall", "corrupt", "oom", "disconnect")


@dataclass
class FaultEvent:
    """One scheduled fault: ``kind`` at scheduler ``step`` with
    key=value ``args`` (``rank`` selects the target process)."""

    kind: str
    step: int
    args: Dict[str, str] = field(default_factory=dict)

    @property
    def rank(self) -> int:
        """The mesh rank this event targets (default 0)."""
        return int(self.args.get("rank", 0))


def parse_fault_spec(spec: str) -> List[FaultEvent]:
    """Parse a ``--fault-spec`` string into sorted fault events.

    Raises ``ValueError`` on unknown kinds or malformed events so a
    typo fails the launch instead of silently never firing.
    """
    events: List[FaultEvent] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        head = fields[0]
        if "@" not in head:
            raise ValueError(
                f"fault event {part!r}: expected kind@step[:key=val...]")
        kind, step_s = head.split("@", 1)
        if kind not in KINDS:
            raise ValueError(
                f"fault event {part!r}: unknown kind {kind!r} "
                f"(known: {', '.join(KINDS)})")
        args: Dict[str, str] = {}
        for kv in fields[1:]:
            if "=" not in kv:
                raise ValueError(
                    f"fault event {part!r}: bad arg {kv!r} (want key=val)")
            k, v = kv.split("=", 1)
            args[k] = v
        events.append(FaultEvent(kind=kind, step=int(step_s), args=args))
    events.sort(key=lambda e: e.step)
    return events


class FaultInjector:
    """Fires scheduled faults at exact scheduler steps.

    Attach via ``Scheduler(..., faults=FaultInjector(spec, rank=r))``;
    the scheduler calls :meth:`on_step` at the top of each step and
    :meth:`admission_blocked` inside the admission phase (the ``oom``
    kind simulates pool exhaustion by refusing admission for ``hold``
    steps — layout-agnostic and identical on every mesh host).
    """

    def __init__(self, spec, rank: int = 0):
        self.events = parse_fault_spec(spec) if isinstance(spec, str) \
            else list(spec)
        self.rank = int(rank)
        self.injected = 0
        self._oom_until = 0
        self._fired: List[FaultEvent] = []

    def admission_blocked(self, step: int) -> bool:
        """True while an ``oom`` event holds admission shut."""
        return step < self._oom_until

    def on_step(self, sched, step: int) -> None:
        """Fire every event scheduled for ``step`` on this rank."""
        for ev in self.events:
            if ev.step == step and ev.rank == self.rank \
                    and ev not in self._fired:
                self._fired.append(ev)
                self._fire(ev, sched, step)

    def _count(self, sched, ev: FaultEvent, step: int) -> None:
        self.injected += 1
        sched.stats.fault_injected += 1
        log_event("fault_injected", kind=ev.kind, step=step,
                  rank=self.rank)

    def _fire(self, ev: FaultEvent, sched, step: int) -> None:
        if ev.kind == "kill":
            # the real thing: no cleanup, no flush — exactly what the
            # journal's torn-tail tolerance is specified against.
            # counted BEFORE the kill lands only in the journal's favor
            self._count(sched, ev, step)
            print(f"[faults] SIGKILL self at step {step} (rank "
                  f"{self.rank})", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        elif ev.kind == "crash":
            self._count(sched, ev, step)
            raise InjectedFault(f"injected crash at step {step}")
        elif ev.kind == "stall":
            self._count(sched, ev, step)
            time.sleep(float(ev.args.get("secs", 0.05)))
        elif ev.kind == "corrupt":
            self._count(sched, ev, step)
            self._corrupt_winner(sched, ev)
        elif ev.kind == "oom":
            self._count(sched, ev, step)
            self._oom_until = step + int(ev.args.get("hold", 1))
        elif ev.kind == "disconnect":
            rid = self._disconnect_victim(sched, ev)
            if rid is not None:
                self._count(sched, ev, step)
                sched.cancel(rid)

    def _corrupt_winner(self, sched, ev: FaultEvent) -> None:
        """Truncate the newest winner checkpoint in the registry's
        directory to half its size — a torn file exactly like a writer
        that died mid-copy."""
        from repro_torch.serve.registry import (latest_winner_step,
                                                winner_path)
        d = ev.args.get("dir") or getattr(
            getattr(sched, "registry", None), "ckpt_dir", None)
        if d is None:
            return
        step = latest_winner_step(d)
        if step is None:
            return
        path = winner_path(d, step)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
        print(f"[faults] truncated {path} ({size} -> {size // 2} bytes)",
              flush=True)

    def _disconnect_victim(self, sched, ev: FaultEvent):
        """Pick the cancellation victim deterministically: an explicit
        ``rid=`` arg, else the oldest in-flight request, else the queue
        head."""
        if "rid" in ev.args:
            rid = ev.args["rid"]
            return int(rid) if rid.lstrip("-").isdigit() else rid
        for pool in (sched.active, sched.prefilling):
            for rid in pool:
                return rid
        for q in sched.queue:
            return q.rid
        return None
