"""Write-ahead request journal of the port: crash recovery for serving.

A copy of ``repro.serve.journal`` (the port imports nothing of
``repro``): every admitted request and every emitted token is appended
to a JSONL file, flushed every scheduler step and fsync'd at a bounded
interval, so a new scheduler or gateway generation requeues unfinished
work after a crash (SIGKILL, OOM) or a SIGTERM restart and, because host
sampling is deterministic in ``(seed, ntok)``, resumes emission
**token-identically** from the last journaled token.  Records carry no
timestamps, so the two packages write the same lines for the same trace
and each replays the other's files.

Record types (one JSON object per line):

  * ``submit``   — the full request encoding at admission time
    (prompt ids, ``max_new``, ``eos_id``, ``temperature``, ``seed``,
    ``ntok_base``, optional gateway ``Idempotency-Key``).
  * ``tokens``   — one batched record per scheduler step mapping
    ``rid -> [tokens appended this step]``.
  * ``finish``   — rids completed this step (written after their
    tokens, same flush).
  * ``cancel``   — a request cancelled or shed before completion.
  * ``note``     — a free-form operational marker (``shutdown``), so a
    replay can tell a clean drain from a crash.
  * ``match`` / ``promotion`` — an online-LTFB arena's match evaluation
    and champion promotion with the arena's snapshot, written by the
    scheduler's arena (:mod:`repro_torch.serve.arena`) and read back by
    :func:`replay_arena`.

Replay ignores record types it does not know.

Durability contract: :meth:`RequestJournal.step_commit` performs ONE
``write + flush`` per scheduler step (submits and cancels fsync at once:
they happen between steps and must never be lost once acknowledged).
The flush lands the step's records in the OS page cache, which survives
a *process* death (SIGKILL, OOM-kill, segfault); the ``fsync`` that also
survives a *machine* death is issued at most every ``fsync_interval_s``
(default 250 ms, 0 = every step).  A machine loss costs at most the last
interval's tokens, a process crash at most the step in progress, and
:func:`replay` tolerates a torn final line.  Lost steps are harmless for
token identity: the resumed request re-derives them deterministically.

Resume model — *a resumed request is just a longer prompt*.  For an
unfinished entry with ``k`` emitted tokens, :func:`resume_request`
rebuilds the request as ``prompt = original_prompt + emitted``,
``max_new = original_max_new - k`` and ``ntok_base = k``.  The
scheduler's sampler seeds ``rng([seed, ntok_base + ntok])``, so decode
step ``j`` of the resumed run conditions on the tokens and rng stream
the uninterrupted run used at step ``k + j``.  (The resumed run prefills
those ``k`` tokens in one pass where the uninterrupted run decoded them
one at a time, so identity of the two streams is exact save where the
two passes' rounding moves a top-2 tie: an f32 guarantee, as the rest of
the port's token identity.)  The new generation's ``results[rid]`` holds
only the NEW tokens; :func:`stitched_results` prepends the journaled
prefix to recover the full stream.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _encode_req(req) -> dict:
    """Journal encoding of a Request (wire-stable, JSON-only types)."""
    return {
        "rid": req.rid,
        "prompt": np.asarray(req.prompt, np.int32).tolist(),
        "max_new": int(req.max_new),
        "eos_id": None if req.eos_id is None else int(req.eos_id),
        "temperature": float(req.temperature),
        "seed": None if req.seed is None else int(req.seed),
        "ntok_base": int(getattr(req, "ntok_base", 0)),
        "idem_key": getattr(req, "idem_key", None),
    }


class RequestJournal:
    """Append-only fsync'd WAL attached to ONE scheduler generation.

    The scheduler calls :meth:`record_submit` / :meth:`record_cancel`
    as they happen (each fsyncs immediately) and batches per-step token
    emission + completions into one :meth:`step_commit` — flushed every
    step, fsync'd at a bounded wall-clock interval.
    """

    def __init__(self, path: str, fsync: bool = True,
                 fsync_interval_s: float = 0.25):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "ab")
        self._fsync = bool(fsync)
        self._interval = max(0.0, float(fsync_interval_s))
        self._last_fsync = time.monotonic()
        self.records = 0

    def _append(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, separators=(",", ":")).encode()
                      + b"\n")
        self.records += 1

    def _sync(self) -> None:
        """Full durability barrier: returns with all records on disk."""
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())
            self._last_fsync = time.monotonic()

    def _sync_step(self) -> None:
        """Per-step barrier: flush always (survives process death via
        the page cache), fsync only when the interval elapsed (bounds
        the machine-death loss window without putting a disk barrier on
        every decode step)."""
        self._f.flush()
        if self._fsync and \
                time.monotonic() - self._last_fsync >= self._interval:
            os.fsync(self._f.fileno())
            self._last_fsync = time.monotonic()

    def record_submit(self, req) -> None:
        """Journal an accepted submit (synced immediately: admission
        happens between steps, outside the per-step batch)."""
        self._append({"t": "submit", "req": _encode_req(req)})
        self._sync()

    def record_cancel(self, rid, reason: str) -> None:
        """Journal a cancellation/shed; the rid will not be resumed."""
        self._append({"t": "cancel", "rid": rid, "reason": reason})
        self._sync()

    def record_note(self, kind: str, **fields) -> None:
        """Journal an operational marker (``peer_death``, ``shutdown``)."""
        rec = {"t": "note", "kind": kind}
        rec.update(fields)
        self._append(rec)
        self._sync()

    def record_match(self, step: int, arena: dict) -> None:
        """Journal one arena match evaluation with the full arena
        snapshot — replayed by :func:`replay_arena` so sliding windows
        and hysteresis streaks survive a crash."""
        self._append({"t": "match", "step": int(step), "arena": arena})
        self._sync()

    def record_promotion(self, step: int, winner: str, loser: str,
                         rate: float, forced: bool,
                         arena: dict) -> None:
        """Journal an arena promotion (synced immediately, BEFORE the
        weight swap): ``arena`` is the post-promotion snapshot, so a
        torn record means the swap never happened and replay lands on
        the pre-promotion state — either way consistent."""
        self._append({"t": "promotion", "step": int(step),
                      "winner": winner, "loser": loser,
                      "rate": float(rate), "forced": bool(forced),
                      "arena": arena})
        self._sync()

    def step_commit(self, tokens: Dict[Any, List[int]],
                    finished: List[Any]) -> None:
        """Commit one scheduler step: tokens appended per rid, then the
        rids that completed — ONE write + flush for the whole step,
        fsync'd when the interval elapsed."""
        if not tokens and not finished:
            return
        if tokens:
            self._append({"t": "tokens",
                          "toks": {str(r): t for r, t in tokens.items()}})
        if finished:
            self._append({"t": "finish", "rids": list(finished)})
        self._sync_step()

    def close(self) -> None:
        """Flush, fsync and close the journal file (idempotent)."""
        if not self._f.closed:
            self._sync()
            self._f.close()


@dataclass
class JournalEntry:
    """Replayed per-request state: the original request encoding, the
    tokens emitted before the cut, and whether it completed."""

    req: dict
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    cancelled: bool = False


def replay(path: str) -> Dict[Any, JournalEntry]:
    """Rebuild per-request state from a journal file.

    Tolerates a torn final line (the generation died mid-write): replay
    stops at the first undecodable record.  Returns ``rid ->``
    :class:`JournalEntry`; rids are the journal's JSON representation
    (``tokens`` records key by ``str(rid)``, matched back to the submit
    record's rid).
    """
    entries: Dict[Any, JournalEntry] = {}
    by_str: Dict[str, Any] = {}
    try:
        raw = open(path, "rb").read()
    except FileNotFoundError:
        return entries
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            break                       # torn tail — stop replay here
        t = rec.get("t")
        if t == "submit":
            rid = rec["req"]["rid"]
            entries[rid] = JournalEntry(req=rec["req"])
            by_str[str(rid)] = rid
        elif t == "tokens":
            for srid, toks in rec.get("toks", {}).items():
                rid = by_str.get(srid)
                if rid in entries:
                    entries[rid].tokens.extend(int(x) for x in toks)
        elif t == "finish":
            for rid in rec.get("rids", []):
                rid = by_str.get(str(rid), rid)
                if rid in entries:
                    entries[rid].done = True
        elif t == "cancel":
            rid = rec.get("rid")
            rid = by_str.get(str(rid), rid)
            if rid in entries:
                entries[rid].cancelled = True
        # "note" records carry no per-request state
    return entries


def replay_arena(path: str) -> Optional[dict]:
    """Reconstruct arena state from a journal: the LAST durable
    ``match``/``promotion`` record's snapshot (None when the journal
    holds neither).

    Stops at the first undecodable line, exactly like :func:`replay`:
    a promotion record torn mid-write is NOT durable, and because the
    journal sync is ordered before the weight swap, the crashed
    generation never served the new champion — so resuming from the
    preceding snapshot is token-identical.
    """
    state: Optional[dict] = None
    try:
        raw = open(path, "rb").read()
    except FileNotFoundError:
        return None
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            break                       # torn tail — stop replay here
        if rec.get("t") in ("match", "promotion"):
            arena = rec.get("arena")
            if isinstance(arena, dict):
                state = arena
    return state


def resume_request(entry: JournalEntry):
    """Build the resume request for one unfinished entry.

    Returns ``(Request, prefix)`` where ``prefix`` is the already-
    emitted token list.  The request's prompt is the original prompt
    plus the prefix, ``max_new`` is the remaining budget and
    ``ntok_base`` offsets the sampler's rng stream — see the module
    docstring for why this is token-identical to the uninterrupted run.
    """
    from repro_torch.serve.scheduler import Request
    r = entry.req
    prefix = list(entry.tokens)
    k = len(prefix)
    base = int(r.get("ntok_base", 0))
    prompt = np.asarray(list(r["prompt"]) + prefix, np.int32)
    req = Request(rid=r["rid"], prompt=prompt,
                  max_new=int(r["max_new"]) - k,
                  eos_id=r.get("eos_id"),
                  temperature=float(r.get("temperature", 0.0)),
                  seed=r.get("seed"),
                  ntok_base=base + k,
                  idem_key=r.get("idem_key"))
    return req, prefix


def resume_scheduler(sched, entries: Dict[Any, JournalEntry]
                     ) -> Dict[Any, List[int]]:
    """Requeue unfinished journal entries into a fresh scheduler.

    Finished entries preload ``sched.results`` directly (so client
    retries and out-json see them); cancelled entries are skipped;
    unfinished entries are re-submitted as resume requests.  Returns
    ``rid -> journaled prefix`` for the resumed rids (feed it to
    :func:`stitched_results` once the run completes) and sets
    ``stats.journal_replayed`` to the resumed count.
    """
    prefixes: Dict[Any, List[int]] = {}
    for rid, e in entries.items():
        if e.cancelled:
            continue
        hit_eos = e.req.get("eos_id") is not None and e.tokens \
            and e.tokens[-1] == e.req["eos_id"]
        if e.done or len(e.tokens) >= int(e.req["max_new"]) or hit_eos:
            sched.results[rid] = np.asarray(e.tokens, np.int32)
            continue
        req, prefix = resume_request(e)
        sched.submit(req)
        prefixes[rid] = prefix
    sched.stats.journal_replayed += len(prefixes)
    return prefixes


def stitched_results(results: Dict[Any, np.ndarray],
                     prefixes: Dict[Any, List[int]]
                     ) -> Dict[Any, np.ndarray]:
    """Full token streams: journaled prefix + this generation's tokens
    for resumed rids, pass-through for everything else."""
    out: Dict[Any, np.ndarray] = {}
    for rid, toks in results.items():
        pre = prefixes.get(rid)
        if pre:
            out[rid] = np.concatenate(
                [np.asarray(pre, np.int32), np.asarray(toks, np.int32)])
        else:
            out[rid] = np.asarray(toks, np.int32)
    return out


def idempotency_map(entries: Dict[Any, JournalEntry]
                    ) -> Dict[str, Tuple[Any, bool]]:
    """``Idempotency-Key -> (rid, done)`` for journaled requests that
    carried a key — seeds the gateway's dedup map across a restart so
    a client retry does not double-admit."""
    out: Dict[str, Tuple[Any, bool]] = {}
    for rid, e in entries.items():
        key = e.req.get("idem_key")
        if key:
            out[key] = (rid, e.done)
    return out


def unfinished(entries: Dict[Any, JournalEntry]) -> List[Any]:
    """The rids a resume will requeue (not done, not cancelled,
    budget remaining)."""
    out = []
    for rid, e in entries.items():
        if e.cancelled or e.done:
            continue
        if len(e.tokens) >= int(e.req["max_new"]):
            continue
        out.append(rid)
    return out


def last_note(path: str) -> Optional[dict]:
    """The final ``note`` record in a journal (None when absent) —
    distinguishes a clean ``shutdown`` from a crash cut."""
    note = None
    try:
        raw = open(path, "rb").read()
    except FileNotFoundError:
        return None
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            break
        if rec.get("t") == "note":
            note = rec
    return note
