"""Online LTFB arena of the port: live traffic runs the tournament.

The counterpart of ``repro.serve.arena``, with the same rules, names and
JSON snapshots.  The LTFB tournament picks winners *offline* between
training rounds; the arena makes the selection *online*, scored by the
serving traffic itself.  An :class:`Arena` keeps an N-member roster of
population checkpoints resident on the serving device (each member's
weights a state dict in the port's layout), the champion serving in the
scheduler's target session and one challenger at a time drafting in its
drafter session; the speculative accept rate of the active challenger
drafting for the champion, which the speculative path computes anyway,
is the match metric.

**Match scoring.**  Every speculative round contributes one
``(offered, accepted)`` sample per active row to the drafting member's
sliding window (:class:`MemberStats`; rates are zero-guarded so an empty
window or a zero-proposal drafter never reads as NaN).  The scheduler
evaluates a *match* every ``check_every`` steps.

**Promotion rule** (deterministic in the arena's state):

* *min-samples*: a challenger qualifies once its window holds at least
  ``min_samples`` offered proposals;
* *margin*: the best qualifying challenger's window accept rate must
  reach ``baseline + margin``, where ``baseline`` is the accept rate the
  current champion had when *it* was promoted (0 for the first one);
* *hysteresis*: the same challenger must win ``hysteresis`` consecutive
  match evaluations before the promotion fires.

**Promotion mechanics** reuse the registry's transactional hot swap:
rank 0 archives the dethroned champion as a dated generation
(``<pop>/arena/gen_NNNN_<date>_retired_<name>.ckpt`` + sha256 sidecar,
:func:`repro_torch.serve.registry.archive_member`, in the checkpoint's
layout through ``to_ckpt``), exports the winner the same way and verifies
its sidecar, and only then is the promotion journaled and the weights
swapped -- drain-aware (``swap_mode="drain"`` lets in-flight requests
finish on the old champion through the scheduler's pending swap).  A
failed verification aborts the promotion and the old champion keeps
serving.

**Durability.**  Every match evaluation and promotion is journaled
(``match`` / ``promotion`` records carrying a full :meth:`Arena.snapshot`),
so :func:`repro_torch.serve.journal.replay_arena` rebuilds the arena's
state after a crash: a promotion counts iff its record is durable, and
since the weight swap is ordered after the journal's sync, a torn record
means the swap never happened.

**Write-back.**  Finished request streams (prompt + generated tokens) are
written as datastore token shards (:class:`TokenWriteback`,
``tokens_NNNNN.npz`` as :mod:`repro_torch.data.tokens` names them), so
the next ``repro_torch.launch.ltfb`` round trains on served traffic.  A
JSON state file dedupes request ids across a crash and a resume.

Routing policies (``--arena-policy``) pick which challenger drafts:

* ``champion`` — the *best* challenger (by window rate) drafts,
  re-evaluated at stint boundaries (pure exploit);
* ``epsilon`` — mostly the best challenger, but every ~``1/epsilon``-th
  stint rotates round-robin through the roster (explore/exploit);
* ``shadow`` — round-robin every stint, so every challenger gathers
  samples evenly (pure explore).

Only rank 0 archives, writes back and appends to the genealogy.  On a
serving mesh (:mod:`repro_torch.serve.mesh`) every rank mirrors the
roster: the rotation is a pure function of the replicated state, and a
follower applies rank 0's promotion from the step plan's ``promote``.
"""
from __future__ import annotations

import json
import os
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.telemetry import log_event

POLICIES = ("champion", "epsilon", "shadow")


def safe_rate(accepted: int, offered: int) -> float:
    """Accept rate guarded against empty windows and zero proposals: a
    drafter with no proposals reads 0.0 (never NaN), so the promotion
    rule, the Prometheus export and the JSON snapshots stay ordered and
    JSON-safe."""
    return accepted / offered if offered > 0 else 0.0


@dataclass
class ArenaConfig:
    """Tunables of the online tournament (the module docstring says how
    each enters the promotion rule)."""

    policy: str = "champion"      # champion | epsilon | shadow
    window: int = 128             # sliding window, in spec row-rounds
    min_samples: int = 32         # offered proposals needed to qualify
    margin: float = 0.02          # rate must reach baseline + margin
    hysteresis: int = 2           # consecutive winning matches needed
    check_every: int = 8          # scheduler steps between matches
    rotate_every: int = 16        # steps per drafter stint
    epsilon: float = 0.25         # explore share of stints (epsilon)
    seq_len: int = 64             # write-back row width is seq_len + 1
    samples_per_file: int = 8     # write-back rows per token shard

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown arena policy {self.policy!r} "
                             f"(choose from {POLICIES})")
        self.window = max(1, int(self.window))
        self.min_samples = max(1, int(self.min_samples))
        self.hysteresis = max(1, int(self.hysteresis))
        self.check_every = max(1, int(self.check_every))
        self.rotate_every = max(1, int(self.rotate_every))


class MemberStats:
    """One roster member's live scorecard.

    ``window`` holds the last ``maxlen`` per-row ``(offered, accepted)``
    speculative samples (the match metric reads only the window);
    ``offered``/``accepted`` accumulate over the member's lifetime;
    ``served_tokens`` counts tokens emitted while the member was the
    serving champion; ``promotions`` counts its wins.
    """

    def __init__(self, window: int):
        self.window: deque = deque(maxlen=int(window))
        self.offered = 0
        self.accepted = 0
        self.served_tokens = 0
        self.promotions = 0

    def add(self, offered: int, accepted: int) -> None:
        """Record one speculative row-round's proposal and accept counts."""
        self.window.append((int(offered), int(accepted)))
        self.offered += int(offered)
        self.accepted += int(accepted)

    # the readers copy the window first: ``tuple`` takes it in one step
    # under the interpreter lock, while the gateway's event loop reads a
    # scorecard that the scheduler's driver thread appends to
    @property
    def win_offered(self) -> int:
        """Proposals offered inside the sliding window."""
        return sum(o for o, _ in tuple(self.window))

    @property
    def win_accepted(self) -> int:
        """Proposals accepted inside the sliding window."""
        return sum(a for _, a in tuple(self.window))

    @property
    def rate(self) -> float:
        """Window accept rate, zero-guarded (0.0 for an empty window)."""
        win = tuple(self.window)
        return safe_rate(sum(a for _, a in win), sum(o for o, _ in win))

    def as_dict(self) -> dict:
        """JSON-safe scorecard (journaled in match records)."""
        win = tuple(self.window)
        offered = sum(o for o, _ in win)
        return {"window": [[o, a] for o, a in win],
                "offered": self.offered, "accepted": self.accepted,
                "rate": safe_rate(sum(a for _, a in win), offered),
                "win_offered": offered,
                "served_tokens": self.served_tokens,
                "promotions": self.promotions}

    def load(self, d: dict) -> None:
        """Restore the scorecard from :meth:`as_dict` output."""
        self.window.clear()
        self.window.extend((int(o), int(a))
                           for o, a in d.get("window", []))
        self.offered = int(d.get("offered", 0))
        self.accepted = int(d.get("accepted", 0))
        self.served_tokens = int(d.get("served_tokens", 0))
        self.promotions = int(d.get("promotions", 0))


class TokenWriteback:
    """Served streams to datastore token shards (train, serve, train).

    Buffers one ``(seq_len + 1)``-token row per finished request (prompt
    + generated tokens, truncated or zero-padded) and writes a
    ``tokens_NNNNN.npz`` shard whenever ``samples_per_file`` rows have
    gathered: every shard holds exactly that many rows, so the
    datastore's uniform-bundle check passes and the ltfb launcher can
    list the directory as a training manifest.

    Crash safety: a ``writeback_state.json`` file (written to a temporary
    name, fsynced and renamed) records the written request ids, the
    pending rows and the next shard index after every change, so a
    restarted server never writes a request twice and never loses a
    buffered row.  The two packages write the same state file and the
    same shard arrays for the same streams.
    """

    STATE = "writeback_state.json"

    def __init__(self, root: str, seq_len: int, vocab: int,
                 samples_per_file: int = 8):
        self.root = root
        self.seq_len = int(seq_len)
        self.vocab = int(vocab)
        self.samples_per_file = max(1, int(samples_per_file))
        os.makedirs(root, exist_ok=True)
        self.written: set = set()
        self.pending: List[List[int]] = []   # rows awaiting a full shard
        self._pending_rids: List[str] = []
        self.shards_written = 0
        self.rows_written = 0
        self._load_state()

    # -- persistence --------------------------------------------------------
    def _state_path(self) -> str:
        return os.path.join(self.root, self.STATE)

    def _load_state(self) -> None:
        try:
            with open(self._state_path()) as f:
                st = json.load(f)
        except (FileNotFoundError, ValueError):
            # no state, or a corrupt one: the shards on disk say where the
            # next one goes
            from repro_torch.data.tokens import list_token_shards
            self._next_shard = len(list_token_shards(self.root))
            return
        self.written = set(st.get("written", []))
        self.pending = [list(map(int, r)) for r in st.get("pending", [])]
        self._pending_rids = list(st.get("pending_rids", []))
        self._next_shard = int(st.get("next_shard", 0))
        self.rows_written = int(st.get("rows_written", 0))

    def _save_state(self) -> None:
        st = {"written": sorted(self.written),
              "pending": self.pending,
              "pending_rids": self._pending_rids,
              "next_shard": self._next_shard,
              "rows_written": self.rows_written}
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(st, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path())

    # -- ingestion ----------------------------------------------------------
    def add(self, rid: Any, stream) -> bool:
        """Buffer one finished request's stream as a shard row.

        ``stream`` is the whole prompt + generated token sequence; it is
        truncated (or zero-padded) to ``seq_len + 1`` ids.  Returns False,
        writing nothing, when ``rid`` was already written back by this
        or an earlier generation (the crash/resume dedup); raises
        ``ValueError`` for a token id outside the vocab.
        """
        key = str(rid)
        if key in self.written or key in self._pending_rids:
            return False
        toks = np.asarray(stream, np.int32).reshape(-1)
        width = self.seq_len + 1
        row = np.zeros((width,), np.int32)
        n = min(width, toks.shape[0])
        row[:n] = toks[:n]
        if int(row.max(initial=0)) >= self.vocab:
            raise ValueError(
                f"write-back row for request {rid!r} holds token id "
                f"{int(row.max())} >= vocab {self.vocab}")
        self.pending.append([int(t) for t in row])
        self._pending_rids.append(key)
        self._flush_full()
        self._save_state()
        return True

    def _flush_full(self) -> None:
        """Write every complete ``samples_per_file`` batch of pending rows
        as one uniform token shard."""
        from repro_torch.data.tokens import shard_path
        while len(self.pending) >= self.samples_per_file:
            rows = self.pending[:self.samples_per_file]
            rids = self._pending_rids[:self.samples_per_file]
            path = shard_path(self.root, self._next_shard)
            np.savez(path, tokens=np.asarray(rows, np.int32))
            self._next_shard += 1
            self.shards_written += 1
            self.rows_written += len(rows)
            self.pending = self.pending[self.samples_per_file:]
            self._pending_rids = self._pending_rids[
                self.samples_per_file:]
            self.written.update(rids)

    def close(self) -> None:
        """Persist the final state (pending rows stay buffered for the
        next generation: shards must stay uniform for the datastore)."""
        self._save_state()

    def as_dict(self) -> dict:
        """Progress counters for reports and snapshots."""
        return {"root": self.root, "shards": self._next_shard,
                "rows_written": self.rows_written,
                "pending_rows": len(self.pending),
                "written_rids": len(self.written)
                + len(self._pending_rids)}


class Arena:
    """The online tournament: roster, routing, match scoring, promotion.

    The scheduler drives it: :meth:`drafter_for_step` (deterministic in
    the step count) picks which challenger drafts, :meth:`record_spec` /
    :meth:`record_finished` gather the match metric and the write-back
    stream, :meth:`decide` applies the promotion rule,
    :meth:`prepare_promotion` (rank 0) runs the checksum-verified registry
    transaction, and :meth:`promote` changes the roster's state and hands
    back the new champion's weights for the drain-aware swap.

    ``members`` maps a name to its weights: in a server a state dict in
    the port's layout, resident on the serving device, which the
    scheduler copies into its target or drafter model.  ``to_ckpt`` turns
    a member's weights into the checkpoint's layout for its archive
    (identity when None: the weights are already in that layout).
    """

    def __init__(self, members: Dict[str, Any], champion: str,
                 cfg: Optional[ArenaConfig] = None,
                 ckpt_dir: Optional[str] = None,
                 writeback: Optional[TokenWriteback] = None,
                 rank: int = 0,
                 to_ckpt: Optional[Callable[[Any], Any]] = None):
        if len(members) < 2:
            raise ValueError(
                f"an arena needs >= 2 resident members, got "
                f"{sorted(members)} — train a larger population or "
                "serve without --arena")
        if champion not in members:
            raise ValueError(f"champion {champion!r} is not in the "
                             f"roster {sorted(members)}")
        self.cfg = cfg or ArenaConfig()
        self.order: List[str] = list(members)        # stable roster order
        self.members: Dict[str, MemberStats] = {
            n: MemberStats(self.cfg.window) for n in self.order}
        self.params: Dict[str, Any] = dict(members)
        self.champion = champion
        self.baseline = 0.0          # rate the champion was promoted at
        self.streak = 0
        self.streak_member: Optional[str] = None
        self.generation = 0
        self.matches = 0
        self.promotions = 0
        self.forced: Optional[str] = None   # POST /arena/promote override
        self.last_forced = False     # was the last decide() an override?
        self.last_promotion: Optional[dict] = None
        self.ckpt_dir = ckpt_dir
        self.writeback = writeback
        self.rank = int(rank)
        self.to_ckpt = to_ckpt
        # rank 0 of a from_population arena appends its promotions to the
        # population's genealogy log, so arena generations and LTFB
        # rounds form one ancestry chain
        self.genealogy = None
        self.active_drafter = self.drafter_for_step(0)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_population(cls, pop_dir: str, like_params,
                        cfg: Optional[ArenaConfig] = None,
                        step: Optional[int] = None,
                        writeback_dir: Optional[str] = None,
                        vocab: Optional[int] = None,
                        rank: int = 0,
                        from_ckpt: Optional[Callable[[Any], Any]] = None,
                        to_ckpt: Optional[Callable[[Any], Any]] = None
                        ) -> "Arena":
        """Build a roster from an LTFB population checkpoint directory.

        Loads every trainer of the newest population step (``step``
        picks another) as members ``trainer_<i>``; the first champion is
        the trainer the offline tournament would export (most recorded
        wins).  ``like_params`` is a template in the checkpoint's layout
        and ``from_ckpt`` turns each restored tree into the served
        weights (the port's layout on the serving device), ``to_ckpt``
        back for the archives.  Only rank 0 gets the registry directory
        (promotion archives), the write-back writer and the genealogy.
        """
        from repro_torch.serve.registry import (load_population_params,
                                                population_steps,
                                                select_winner)
        cfg = cfg or ArenaConfig()
        steps = population_steps(pop_dir)
        if not steps:
            raise FileNotFoundError(
                f"no population checkpoint in {pop_dir!r} — --arena "
                "needs a launch/ltfb.py checkpoint dir")
        s = step if step is not None else steps[-1]
        params, metas = load_population_params(pop_dir, s, like_params)
        idx, _ = select_winner(params, metas)
        if from_ckpt is not None:
            params = [from_ckpt(p) for p in params]
        members = {f"trainer_{i}": p for i, p in enumerate(params)}
        wb = None
        if writeback_dir and rank == 0:
            wb = TokenWriteback(writeback_dir, seq_len=cfg.seq_len,
                                vocab=int(vocab or 1 << 30),
                                samples_per_file=cfg.samples_per_file)
        arena = cls(members, f"trainer_{idx}", cfg,
                    ckpt_dir=pop_dir if rank == 0 else None,
                    writeback=wb, rank=rank, to_ckpt=to_ckpt)
        if rank == 0:
            from repro_torch.train.telemetry import GenealogyLog
            arena.genealogy = GenealogyLog(
                os.path.join(pop_dir, "genealogy.jsonl"))
        return arena

    # -- routing -------------------------------------------------------------
    @property
    def challengers(self) -> List[str]:
        """Roster members other than the champion, in roster order."""
        return [n for n in self.order if n != self.champion]

    @property
    def champion_params(self):
        """The serving champion's weights (the scheduler's target)."""
        return self.params[self.champion]

    @property
    def drafter_params(self):
        """The active challenger's weights (the drafter session)."""
        return self.params[self.active_drafter]

    def best_challenger(self) -> str:
        """Highest window accept rate; roster order breaks ties."""
        chs = self.challengers
        return max(chs, key=lambda n: (self.members[n].rate,
                                       -self.order.index(n)))

    def drafter_for_step(self, step: int) -> str:
        """The challenger that drafts at ``step``: a pure function of
        (step, roster, windows)."""
        chs = self.challengers
        stint = step // self.cfg.rotate_every
        if self.cfg.policy == "shadow":
            return chs[stint % len(chs)]
        if self.cfg.policy == "epsilon":
            period = max(1, round(1.0 / max(self.cfg.epsilon, 1e-9)))
            if stint % period == 0:
                return chs[(stint // period) % len(chs)]
        return self.best_challenger()

    def set_drafter(self, name: str) -> None:
        """Record a drafter rotation (the scheduler loads the weights;
        this tracks the attribution)."""
        self.active_drafter = name

    # -- match metric --------------------------------------------------------
    def record_spec(self, offered: int, accepted: int) -> None:
        """Attribute one speculative row-round to the active drafter."""
        self.members[self.active_drafter].add(offered, accepted)

    def record_finished(self, rid: Any, prompt, tokens) -> None:
        """Account a completed request: its tokens credit the champion,
        its whole stream goes to the write-back buffer."""
        self.members[self.champion].served_tokens += len(tokens)
        if self.writeback is not None:
            stream = list(np.asarray(prompt, np.int32)) + list(tokens)
            self.writeback.add(rid, stream)

    # -- promotion rule ------------------------------------------------------
    def decide(self, step: int) -> Optional[str]:
        """One match evaluation; returns the member to promote or None.

        A pending admin override (:attr:`forced`) wins at once -- still
        through the transactional swap, but not subject to min-samples or
        margin.
        """
        self.matches += 1
        self.last_forced = False
        if self.forced is not None:
            forced, self.forced = self.forced, None
            if forced in self.members and forced != self.champion:
                self.last_forced = True
                return forced
        cand = self.best_challenger()
        m = self.members[cand]
        ok = (m.win_offered >= self.cfg.min_samples
              and m.rate >= self.baseline + self.cfg.margin)
        if ok and cand == self.streak_member:
            self.streak += 1
        else:
            self.streak = 1 if ok else 0
            self.streak_member = cand if ok else None
        if self.streak >= self.cfg.hysteresis:
            return cand
        return None

    def _ckpt_tree(self, name: str):
        params = self.params[name]
        return self.to_ckpt(params) if self.to_ckpt is not None else params

    def prepare_promotion(self, winner: str) -> Optional[str]:
        """Rank 0's transactional half of a promotion (file I/O only).

        Archives the dethroned champion as a dated generation, exports
        the winner the same way and verifies the winner's sidecar -- all
        before any state changes.  Returns ``winner``, or None when the
        export failed verification (the promotion is aborted and the old
        champion keeps serving, as a corrupt winner is quarantined).
        """
        if self.ckpt_dir is None or self.rank != 0:
            return winner
        from repro_torch.serve import registry as reg
        gen = self.generation + 1
        try:
            reg.archive_member(self.ckpt_dir, self.champion,
                               self._ckpt_tree(self.champion), gen,
                               tag="retired")
            path = reg.archive_member(self.ckpt_dir, winner,
                                      self._ckpt_tree(winner), gen,
                                      tag="champion")
            reg.verify_checkpoint(path)
        except (OSError, ValueError) as e:
            print(f"[arena] promotion of {winner!r} ABORTED: "
                  f"{type(e).__name__}: {e} — champion "
                  f"{self.champion!r} keeps serving", flush=True)
            log_event("arena_promotion_aborted", winner=winner,
                      error=str(e))
            return None
        return winner

    def promote(self, winner: str, step: int) -> Any:
        """Apply a promotion.

        The winner becomes champion, its window rate the new
        ``baseline``; every window and the hysteresis streak reset
        (accept rates against the new champion are a fresh measurement)
        and the drafter rotation is recomputed.  Returns the new
        champion's weights for the scheduler's drain-aware swap.
        """
        record = {"winner": winner, "loser": self.champion,
                  "rate": self.members[winner].rate, "step": int(step)}
        self.baseline = record["rate"]
        self.members[winner].promotions += 1
        self.champion = winner
        self.generation += 1
        self.promotions += 1
        self.streak = 0
        self.streak_member = None
        for m in self.members.values():
            m.window.clear()
        self.active_drafter = self.drafter_for_step(step)
        self.last_promotion = record
        if self.genealogy is not None:
            self.genealogy.append(
                "promotion", winner=winner, loser=record["loser"],
                rate=record["rate"], step=record["step"],
                generation=self.generation)
            self.genealogy.sync()
        log_event("arena_promotion", winner=winner,
                  loser=record["loser"], rate=record["rate"],
                  step=record["step"], generation=self.generation)
        return self.params[winner]

    # -- durability ----------------------------------------------------------
    def snapshot(self) -> dict:
        """The arena's whole state, JSON-safe: journaled with every match
        and promotion record, served at ``GET /population``, restored by
        :meth:`restore` after a crash."""
        return {"policy": self.cfg.policy,
                "champion": self.champion,
                "drafter": self.active_drafter,
                "baseline": self.baseline,
                "streak": self.streak,
                "streak_member": self.streak_member,
                "generation": self.generation,
                "matches": self.matches,
                "promotions": self.promotions,
                "order": list(self.order),
                "members": {n: self.members[n].as_dict()
                            for n in self.order},
                "writeback": (self.writeback.as_dict()
                              if self.writeback is not None else None)}

    def restore(self, state: Optional[dict]) -> None:
        """Rebuild the arena's state from a journaled snapshot (see
        :func:`repro_torch.serve.journal.replay_arena`).  Weights are not
        in the journal: the roster must already hold every member the
        snapshot names; a promotion is rebuilt by pointing ``champion``
        back at the journaled name."""
        if not state:
            return
        missing = [n for n in state.get("order", [])
                   if n not in self.members]
        if missing:
            raise ValueError(
                f"journal names arena member(s) {missing} that the "
                f"roster {sorted(self.members)} does not hold — resume "
                "with the same population dir the journal was written "
                "against")
        self.champion = state["champion"]
        self.baseline = float(state.get("baseline", 0.0))
        self.streak = int(state.get("streak", 0))
        self.streak_member = state.get("streak_member")
        self.generation = int(state.get("generation", 0))
        self.matches = int(state.get("matches", 0))
        self.promotions = int(state.get("promotions", 0))
        for n, d in state.get("members", {}).items():
            self.members[n].load(d)
        self.active_drafter = state.get("drafter")
        if self.active_drafter not in self.challengers:
            self.active_drafter = self.drafter_for_step(0)

    # -- export --------------------------------------------------------------
    def counters(self) -> dict:
        """Compact per-member counters for telemetry snapshots and the
        Prometheus export (rates zero-guarded, never NaN)."""
        return {"champion": self.champion,
                "drafter": self.active_drafter,
                "promotions": self.promotions,
                "matches": self.matches,
                "members": {n: {"accept_rate": self.members[n].rate,
                                "served_tokens":
                                    self.members[n].served_tokens,
                                "offered": self.members[n].offered,
                                "accepted": self.members[n].accepted}
                            for n in self.order}}

    def close(self) -> None:
        """Flush the write-back state file and the genealogy log
        (idempotent)."""
        if self.writeback is not None:
            self.writeback.close()
        if self.genealogy is not None:
            self.genealogy.close()

    def report(self, log=print, prefix: str = "[arena]") -> None:
        """Print the human-readable arena summary lines."""
        log(f"{prefix} policy={self.cfg.policy} champion={self.champion} "
            f"generation={self.generation} matches={self.matches} "
            f"promotions={self.promotions} baseline={self.baseline:.2f}")
        for n in self.order:
            m = self.members[n]
            tag = "champion" if n == self.champion else (
                "drafting" if n == self.active_drafter else "idle")
            log(f"{prefix}   {n}: rate={m.rate:.2f} "
                f"accepted={m.accepted}/{m.offered} "
                f"served_tokens={m.served_tokens} "
                f"promotions={m.promotions} [{tag}]")
        if self.writeback is not None:
            w = self.writeback.as_dict()
            log(f"{prefix} write-back: {w['shards']} shard(s), "
                f"{w['rows_written']} row(s) in {w['root']} "
                f"(+{w['pending_rows']} pending)")
