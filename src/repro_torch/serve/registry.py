"""Population-aware model loading: serve the tournament winner
(``repro.serve.registry``).

Bridges training and serving: ``launch/ltfb.py`` checkpoints its whole
population through :mod:`repro_torch.checkpoint.ckpt`
(``step_<n>_trainer_<i>.ckpt`` + ``step_<n>.manifest``); this module

  * **exports a winner** from a population step -- by tournament metric
    on a validation batch when one is supplied, else by the win counts
    the tournament recorded in each trainer's checkpoint metadata -- to a
    self-contained ``winner_step_<n>.ckpt``;
  * **hot-swaps** newer winners into a running server: a
    :class:`ModelRegistry` polled between scheduler steps reloads when a
    newer winner file (or, with ``auto_export``, a newer population step)
    appears, so serving follows training live.

Hot swap is **transactional**: exports write a sha256 sidecar
(``winner_step_<n>.ckpt.sha256``, the same bytes as the JAX package's)
next to the atomically renamed checkpoint, and the polling path verifies
it before touching ``self.params``.  A corrupt or torn winner is
*quarantined* -- renamed to ``*.corrupt`` and counted in
``rejected_corrupt`` -- while the previous winner keeps serving.

Every file holds the checkpoint's layout (JAX's, so either package serves
the other's winners); ``like_params`` is a template in that layout.  A
``from_ckpt(tree) -> params`` hook turns a restored tree into the port's
layout on its device: ``registry.params`` and the ``metric_fn`` of
:func:`select_winner` see the port's layout, as a trainer's
``TrainerFns.from_ckpt`` gives it.

The population is also a free source of draft models for speculative
decoding: :func:`load_draft` loads an earlier (or smaller) checkpoint as
the drafter, and :func:`check_draft_compat` refuses a drafter whose vocab
differs from the target's.  A quarantined winner also goes out as a
``swap_rejected_corrupt`` JSON-log record under ``--log-json``.
:func:`archive_member` writes the online arena's dated generations
(:mod:`repro_torch.serve.arena`) in the same layout, with the same
sidecars.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import ckpt
from repro_torch.telemetry import log_event

Params = Any

_WINNER_RE = re.compile(r"^winner_step_(\d+)\.ckpt$")


def checksum_path(path: str) -> str:
    """The sha256 sidecar manifest for a checkpoint file."""
    return path + ".sha256"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_checksum(path: str) -> str:
    """Write the sha256+size sidecar for ``path`` (atomic tmp+rename);
    returns the sidecar path."""
    side = checksum_path(path)
    rec = {"sha256": _sha256(path), "size": os.path.getsize(path)}
    tmp = side + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, side)
    return side


def verify_checkpoint(path: str) -> None:
    """Verify a checkpoint against its sidecar manifest.

    Raises ``ValueError`` on a size or sha256 mismatch (torn/corrupt
    file).  A missing sidecar passes silently -- a legacy export or one
    mid-write; ``ckpt.restore`` itself still raises on an unreadable file.
    """
    side = checksum_path(path)
    if not os.path.exists(side):
        return
    with open(side) as f:
        rec = json.load(f)
    size = os.path.getsize(path)
    if size != int(rec.get("size", -1)):
        raise ValueError(
            f"checkpoint {path!r} is {size} bytes, manifest says "
            f"{rec.get('size')} (torn write?)")
    digest = _sha256(path)
    if digest != rec.get("sha256"):
        raise ValueError(
            f"checkpoint {path!r} sha256 mismatch: file {digest[:12]}… "
            f"!= manifest {str(rec.get('sha256'))[:12]}… (corrupt)")


def winner_path(ckpt_dir: str, step: int) -> str:
    """The exported-winner checkpoint file for ``step``."""
    return os.path.join(ckpt_dir, f"winner_step_{step}.ckpt")


def latest_winner_step(ckpt_dir: str) -> Optional[int]:
    """Newest exported-winner step in a checkpoint dir (None if none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := _WINNER_RE.match(f))]
    return max(steps) if steps else None


def population_steps(ckpt_dir: str) -> List[int]:
    """All population-checkpoint steps in a dir, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(f[len("step_"):-len(".manifest")])
                  for f in os.listdir(ckpt_dir)
                  if f.startswith("step_") and f.endswith(".manifest"))


def check_draft_compat(target_cfg, draft_cfg,
                       member: Optional[str] = None) -> None:
    """Refuse a drafter whose vocab differs from the target's.

    Another arch may draft -- the drafter only proposes tokens -- but the
    two must share a token space: draft samples index the target's
    embedding, so an unequal vocab is a tokenizer mismatch.  Raises
    ``ValueError`` naming the member (``member``) or the draft arch and
    both vocab sizes, with the JAX package's words."""
    if draft_cfg.vocab_size != target_cfg.vocab_size:
        who = f"draft member {member!r} (arch {draft_cfg.name!r})" \
            if member else f"draft arch {draft_cfg.name!r}"
        raise ValueError(
            f"{who} has vocab_size "
            f"{draft_cfg.vocab_size} but the target {target_cfg.name!r} "
            f"has {target_cfg.vocab_size}: the two models are tokenizer-"
            "incompatible — draft proposals would index the wrong "
            "embedding rows. Pick a drafter trained on the same "
            "tokenizer (any LTFB population checkpoint of the target "
            "arch qualifies).")


def _embed_vocab(params: Params) -> Optional[int]:
    embed = params.get("embed") if isinstance(params, dict) else None
    return None if embed is None else int(embed.shape[0])


def load_draft(path: str, like_params: Params,
               step: Optional[int] = None,
               expect_vocab: Optional[int] = None,
               from_ckpt: Optional[Callable] = None
               ) -> Tuple[Params, dict]:
    """Load a drafter for population speculative decoding.

    ``path`` is a self-contained ``.ckpt`` file or a population
    checkpoint directory; there the earliest step's winner drafts by
    default (``step`` picks another), exported first if it is not yet.
    ``like_params`` is the draft arch's template in the checkpoint's
    layout (JAX's); ``expect_vocab`` is the target's vocab size, checked
    against the restored embedding so a tokenizer-incompatible drafter
    fails here, not mid-serve.  ``from_ckpt`` turns the restored tree
    into the port's layout.  Returns (params, info).
    """
    if os.path.isfile(path):
        params, meta = _restore_draft(path, like_params)
    else:
        steps = population_steps(path)
        if not steps:
            raise FileNotFoundError(f"no population checkpoint in {path!r}")
        s = step if step is not None else steps[0]
        if not os.path.exists(winner_path(path, s)):
            export_winner(path, like_params, step=s)
        params, meta = _restore_draft(winner_path(path, s), like_params)
    if expect_vocab is not None:
        got = _embed_vocab(params)
        if got is not None and got != expect_vocab:
            kind = "member dir" if os.path.isdir(path) else "checkpoint"
            raise ValueError(
                f"draft {kind} {path!r} has vocab_size {got} but "
                f"the serving target expects vocab_size {expect_vocab}: "
                "the drafter is tokenizer-incompatible with the target.")
    if from_ckpt is not None:
        params = from_ckpt(params)
    return params, meta


def _restore_draft(path: str, like_params: Params) -> Tuple[Params, dict]:
    try:
        verify_checkpoint(path)
        tree, meta = ckpt.restore(path, {"params": like_params})
    except Exception as e:
        raise ValueError(
            f"draft checkpoint {path!r} does not match the draft arch's "
            f"parameter tree (wrong --draft-arch for this checkpoint?): "
            f"{type(e).__name__}: {e}") from e
    return tree["params"], meta


def load_population_params(ckpt_dir: str, step: int, like_params: Params
                           ) -> Tuple[List[Params], List[dict]]:
    """All trainer params (checkpoint layout) and checkpoint metadata of
    one population step.  Only the ``params`` subtree is read: trainer
    checkpoints also hold optimizer state, which serving never needs."""
    with open(os.path.join(ckpt_dir, f"step_{step}.manifest")) as f:
        manifest = json.load(f)
    params, metas = [], []
    for i in range(manifest["num_trainers"]):
        member = os.path.join(ckpt_dir, f"step_{step}_trainer_{i}.ckpt")
        try:
            tree, meta = ckpt.restore(member, {"params": like_params})
        except Exception as e:
            raise ValueError(
                f"population member trainer_{i} of {ckpt_dir!r} failed "
                f"to restore from {member!r}: {type(e).__name__}: {e} "
                "(wrong --arch for this population, or a torn trainer "
                "checkpoint?)") from e
        params.append(tree["params"])
        metas.append(meta)
    return params, metas


def select_winner(params: List[Params], metas: List[dict],
                  metric_fn: Optional[Callable] = None,
                  val_batch: Optional[dict] = None
                  ) -> Tuple[int, Dict[str, float]]:
    """Winning trainer index: tournament metric (lower = better) on
    ``val_batch`` when given, else the trainer with the most recorded
    tournament wins."""
    if metric_fn is not None and val_batch is not None:
        scores = [float(metric_fn(p, val_batch)) for p in params]
        idx = int(np.argmin(scores))
        return idx, {"selected_by": "metric", "metric": scores[idx]}
    wins = [int(m.get("wins", 0)) for m in metas]
    idx = int(np.argmax(wins))
    return idx, {"selected_by": "wins"}


def export_winner(ckpt_dir: str, like_params: Params,
                  step: Optional[int] = None,
                  metric_fn: Optional[Callable] = None,
                  val_batch: Optional[dict] = None,
                  from_ckpt: Optional[Callable] = None
                  ) -> Tuple[str, dict]:
    """Export the winning trainer of a population step to
    ``winner_step_<n>.ckpt`` with its sidecar; returns (path, info).
    ``metric_fn`` scores each member after ``from_ckpt`` (the port's
    layout); the file holds the checkpoint's layout."""
    if step is None:
        step = ckpt.latest_population_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no population checkpoint in {ckpt_dir!r}")
    params, metas = load_population_params(ckpt_dir, step, like_params)
    scored = [from_ckpt(p) for p in params] \
        if from_ckpt and metric_fn and val_batch else params
    idx, how = select_winner(scored, metas, metric_fn, val_batch)
    info = {"step": step, "trainer": idx,
            "steps": int(metas[idx].get("steps", 0)),
            "wins": int(metas[idx].get("wins", 0)), **how}
    path = winner_path(ckpt_dir, step)
    ckpt.save(path, {"params": params[idx]}, metadata=info)
    write_checksum(path)
    return path, info


def archive_member(ckpt_dir: str, name: str, params: Params,
                   generation: int, tag: str = "retired") -> str:
    """Archive an arena roster member as a dated registry generation.

    A promotion of the online arena (:mod:`repro_torch.serve.arena`)
    calls this twice -- once for the dethroned champion
    (``tag="retired"``), once to export the winner (``tag="champion"``)
    -- writing ``<ckpt_dir>/arena/gen_<NNNN>_<date>_<tag>_<name>.ckpt``
    with a sha256 sidecar, so every promotion leaves a restorable trail.
    ``params`` is in the checkpoint's layout (JAX's), so either package
    restores the archive.  Returns the checkpoint path.
    """
    import datetime

    adir = os.path.join(ckpt_dir, "arena")
    os.makedirs(adir, exist_ok=True)
    date = datetime.date.today().isoformat()
    path = os.path.join(
        adir, f"gen_{int(generation):04d}_{date}_{tag}_{name}.ckpt")
    ckpt.save(path, {"params": params},
              metadata={"member": name, "generation": int(generation),
                        "tag": tag, "date": date})
    write_checksum(path)
    return path


class ModelRegistry:
    """Winner loading + between-steps hot swap for a serving process.

    ``refresh()`` is the scheduler-facing poll: it returns True when a
    newer winner was loaded into ``self.params`` (the port's layout when
    ``from_ckpt`` is given).  With ``auto_export`` the registry also
    exports winners for population steps the trainer has checkpointed
    since the last poll.
    """

    def __init__(self, ckpt_dir: str, like_params: Params,
                 metric_fn: Optional[Callable] = None,
                 val_batch: Optional[dict] = None,
                 auto_export: bool = False,
                 from_ckpt: Optional[Callable] = None):
        self.ckpt_dir = ckpt_dir
        self.like_params = like_params
        self.metric_fn = metric_fn
        self.val_batch = val_batch
        self.auto_export = auto_export
        self.from_ckpt = from_ckpt
        self.params: Optional[Params] = None
        self.step: int = -1
        self.info: dict = {}
        self.swaps: int = 0
        # corrupt winners are renamed to *.corrupt (or, if the rename
        # fails, remembered here) so the poll never re-trips on them
        self.rejected_corrupt: int = 0
        self._quarantined: set = set()

    def _maybe_export(self) -> None:
        pop_step = ckpt.latest_population_step(self.ckpt_dir)
        if pop_step is None:
            return
        win_step = latest_winner_step(self.ckpt_dir)
        if win_step is None or pop_step > win_step:
            export_winner(self.ckpt_dir, self.like_params, step=pop_step,
                          metric_fn=self.metric_fn, val_batch=self.val_batch,
                          from_ckpt=self.from_ckpt)
            # a fresh export supersedes any quarantine of that step
            self._quarantined.discard(pop_step)

    def refresh(self) -> bool:
        """Load the newest winner if it is newer than what is serving.

        Never raises on a corrupt or torn winner file: the file is
        quarantined, ``rejected_corrupt`` counts it, and the previous
        winner keeps serving.
        """
        if self.auto_export:
            self._maybe_export()
        step = latest_winner_step(self.ckpt_dir)
        if step is None or step <= self.step \
                or step in self._quarantined:
            return False
        return self.load_step(step, strict=False)

    def _quarantine(self, step: int, err: Exception) -> None:
        """Reject a corrupt winner: rename it (and its sidecar) to
        ``*.corrupt`` so ``latest_winner_step`` stops seeing it, falling
        back to an in-memory skip set when the rename fails."""
        self.rejected_corrupt += 1
        self._quarantined.add(step)
        path = winner_path(self.ckpt_dir, step)
        for p in (path, checksum_path(path)):
            try:
                if os.path.exists(p):
                    os.replace(p, p + ".corrupt")
            except OSError:
                pass
        print(f"[registry] REJECTED corrupt winner step {step}: "
              f"{type(err).__name__}: {err} — previous winner "
              f"(step {self.step}) keeps serving", flush=True)
        log_event("swap_rejected_corrupt", step=step,
                  serving_step=self.step, error=str(err))

    def load_step(self, step: int, strict: bool = True) -> bool:
        """Load a specific exported winner (no newer-than scan).

        ``strict=True`` (startup) raises on a corrupt file;
        ``strict=False`` (polling) quarantines it and returns False,
        keeping the previous winner serving.
        """
        if step == self.step:
            return False
        path = winner_path(self.ckpt_dir, step)
        try:
            verify_checkpoint(path)
            tree, meta = ckpt.restore(path, {"params": self.like_params})
        except FileNotFoundError:
            if strict:
                raise
            return False        # raced a quarantine/cleanup: just skip
        except Exception as e:
            if strict:
                raise ValueError(
                    f"winner checkpoint {path!r} is corrupt or torn: "
                    f"{type(e).__name__}: {e}") from e
            self._quarantine(step, e)
            return False
        params = tree["params"]
        if self.from_ckpt is not None:
            params = self.from_ckpt(params)
        had = self.params is not None
        self.params = params
        self.step = step
        self.info = meta
        if had:
            self.swaps += 1
        return True

    def load(self) -> Params:
        """Initial load (export first if allowed); raises if nothing to
        serve."""
        if not self.refresh() and self.params is None:
            raise FileNotFoundError(
                f"no winner or population checkpoint in {self.ckpt_dir!r}")
        return self.params
