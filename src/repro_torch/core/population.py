"""Host-orchestrated LTFB population trainer (``repro.core.population``;
paper §III-C, Figs. 6/11-13).

Drives K trainers with their own data partitions, optimizer states and
hyperparameters; between tournaments trainers are fully independent (on
a machine with a card per trainer each runs on its own; on one card they
time-share it, and per-trainer step counts/wall-times are accounted
separately).

  * generator-only exchange for GANs (``scope="generator"``)
  * PBT-style hyperparameter perturbation on model adoption
  * straggler mitigation: late/dead trainers self-pair for the round
  * checkpoint/restart of the whole population (fault tolerance)
  * elastic rescale: grow/shrink K, re-partitioning data and cloning
    tournament winners into new slots

An adopted generator is the partner's tensors themselves (see
:mod:`repro_torch.core.ltfb`); each trainer keeps its own optimizer state,
which is never exchanged.

On the mesh backend each process rank holds one trainer
(``Population(..., local=r)``): the other trainers are *remote* stubs
whose counters the orchestrator keeps in step with their ranks, and whose
weights, optimizer state and data live on those ranks only.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import ltfb

Params = Any


@dataclass
class TrainerFns:
    """Model-agnostic plumbing for one trainer.

    init(seed) -> (params, opt_state, hparams)
    train_step(params, opt_state, batch, hparams)
        -> (params, opt_state, metrics)   [returns new state, writes none]
    metric(params, batch) -> scalar       [tournament metric, lower=better]
    to_ckpt(params, opt_state) -> (params_tree, opt_tree) and
    from_ckpt(params_tree, opt_tree) -> (params, opt_state): the trees a
    checkpoint holds (:mod:`repro_torch.checkpoint.ckpt`) and back; the
    identity when not given.
    """

    init: Callable
    train_step: Callable
    metric: Callable
    to_ckpt: Optional[Callable] = None
    from_ckpt: Optional[Callable] = None


@dataclass
class TrainerState:
    """One trainer: its weights, optimizer state, hparams, data and
    accounting."""

    params: Params
    opt_state: Any
    hparams: Dict[str, float]
    loader: Callable[[], Dict[str, Any]]
    tournament_batches: List[Dict[str, Any]]
    alive: bool = True
    steps: int = 0
    train_seconds: float = 0.0
    data_wait_seconds: float = 0.0   # slice of train_seconds spent in loader()
    wins: int = 0           # pairwise comparisons this trainer's model won
    adoptions: int = 0      # times this trainer adopted a partner's model
    history: List[float] = field(default_factory=list)
    # last train-step metrics and last tournament metric
    last_metrics: Dict[str, float] = field(default_factory=dict)
    tournament_metric: Optional[float] = None
    # held by another process rank (mesh backend): no weights, state or
    # data here, only the counters
    remote: bool = False


class Population:
    """K trainers trained independently between tournaments."""

    def __init__(self, fns: TrainerFns, loaders: Sequence[Callable],
                 tournament_batches: Sequence[List[dict]],
                 scope: str = "full", seed: int = 0,
                 perturb_factor: float = 1.2,
                 perturb_hparams: bool = True,
                 local: Optional[int] = None):
        self.fns = fns
        self.scope = scope
        self.seed = seed
        self.perturb_factor = perturb_factor
        self.perturb_hparams = perturb_hparams
        self.round = 0
        self.rng = np.random.default_rng(seed)
        # optional repro_torch.train.telemetry.TrainTelemetry (set by the
        # orchestrator); None keeps the loop span-free
        self.telemetry = None
        self.trainers: List[TrainerState] = []
        for i, (loader, tb) in enumerate(zip(loaders, tournament_batches)):
            if local is not None and i != local:
                self.trainers.append(TrainerState(None, None, {}, None, [],
                                                  remote=True))
                continue
            params, opt_state, hparams = fns.init(seed + 1000 * i + 1)
            self.trainers.append(TrainerState(params, opt_state, hparams,
                                              loader, list(tb)))

    # -- independent training ------------------------------------------------
    def train_round(self, steps: int) -> Dict[str, Any]:
        """Each alive trainer held here runs `steps` mini-batch steps
        independently.

        Wall time is attributed per trainer: ``data_wait_seconds`` is the
        slice of ``train_seconds`` spent blocked in ``loader()``, the rest
        is compute.  The last step's metrics are read to the host before
        the clock is read, so ``train_seconds`` covers the device work and
        not only its launches.  With ``telemetry`` set, each step emits
        ``data_wait`` + ``step`` spans on the trainer's trace row (host
        time: a ``step`` span ends once the step's launches are queued)
        and each trainer a ``train_round`` span, which ends after that
        read.
        """
        metrics = []
        tel = self.telemetry
        for i, t in enumerate(self.trainers):
            if not t.alive or t.remote:
                continue
            t0 = time.perf_counter()
            wait = 0.0
            m = None
            for _ in range(steps):
                w0 = time.perf_counter()
                batch = t.loader()
                w1 = time.perf_counter()
                wait += w1 - w0
                t.params, t.opt_state, m = self.fns.train_step(
                    t.params, t.opt_state, batch, t.hparams)
                t.steps += 1
                if tel is not None:
                    tel.trainer_span("data_wait", i, w0, w1)
                    tel.trainer_span("step", i, w1, time.perf_counter(),
                                     step=t.steps)
            if m is not None:
                # waits for the device: makes the timing honest
                t.last_metrics = {k: float(v) for k, v in m.items()}
            t1 = time.perf_counter()
            t.train_seconds += t1 - t0
            t.data_wait_seconds += wait
            if tel is not None:
                tel.trainer_span("train_round", i, t0, t1, round=self.round,
                                 steps=steps)
                tel.add_phase("data_wait", wait)
                tel.add_phase("compute", (t1 - t0) - wait)
            metrics.append(m)
        return {"last_metrics": metrics}

    # -- tournament ------------------------------------------------------------
    def _metric_on(self, idx: int, params: Params) -> float:
        tel = self.telemetry
        t0 = time.perf_counter()
        vals = [float(self.fns.metric(params, b))
                for b in self.trainers[idx].tournament_batches]
        if tel is not None:
            tel.trainer_span("tournament_eval", idx, t0,
                             time.perf_counter(), phase="tournament_eval",
                             batches=len(vals))
        return float(np.mean(vals))

    def tournament(self, executor=None) -> Dict[str, Any]:
        """One tournament round.

        With ``executor`` (a ``concurrent.futures`` executor), metric
        evaluation is overlapped with the partner exchange
        (:func:`repro_torch.core.ltfb.host_tournament_async`).
        """
        t0 = time.perf_counter()
        alive = [t.alive for t in self.trainers]
        partner = ltfb.random_pairing(len(self.trainers), self.round,
                                      self.seed, alive)
        pop = [t.params for t in self.trainers]
        winners, log = ltfb.host_tournament_async(
            pop, self._metric_on, partner, self.scope, executor,
            telemetry=self.telemetry)
        for i, j, m_local, m_other in log["metrics"]:
            winner_idx = j if m_other < m_local else i
            self.trainers[winner_idx].wins += 1
            self.trainers[i].tournament_metric = m_local
        for t, won in zip(self.trainers, winners):
            adopted = won is not t.params
            t.params = won
            if adopted:
                t.adoptions += 1
                if self.perturb_hparams:
                    f = self.perturb_factor if self.rng.random() < 0.5 \
                        else 1.0 / self.perturb_factor
                    t.hparams = {k: v * f if k == "lr" else v
                                 for k, v in t.hparams.items()}
        self.round += 1
        log["partner"] = partner.tolist()
        log["seconds"] = time.perf_counter() - t0
        log["pairing_seed"] = self.seed
        if self.telemetry is not None:
            self.telemetry.span("tournament", t0, time.perf_counter(),
                                round=self.round - 1,
                                exchanged=log["exchanged"],
                                exchange_bytes=log["exchange_bytes"])
        return log

    def run(self, rounds: int, steps_per_round: int,
            eval_batch: Optional[dict] = None) -> List[float]:
        """Full LTFB loop; returns best-trainer validation trace."""
        trace = []
        for _ in range(rounds):
            self.train_round(steps_per_round)
            self.tournament()
            if eval_batch is not None:
                best = self.best_metric(eval_batch)
                trace.append(best)
                for t in self.trainers:
                    t.history.append(best)
        return trace

    def best_metric(self, batch: dict) -> float:
        """Lowest metric over the alive trainers on ``batch``."""
        return min(float(self.fns.metric(t.params, batch))
                   for t in self.trainers if t.alive)

    def best_index(self, batch: dict) -> int:
        """Index of the alive trainer with the lowest metric on ``batch``."""
        vals = [(float(self.fns.metric(t.params, batch)), i)
                for i, t in enumerate(self.trainers) if t.alive]
        return min(vals)[1]

    def best_params(self, batch: dict) -> Params:
        """Weights of :meth:`best_index`'s trainer."""
        return self.trainers[self.best_index(batch)].params

    # -- fault tolerance / elasticity -----------------------------------------
    def fail(self, idx: int):
        """Simulate a node failure: trainer drops out of tournaments."""
        self.trainers[idx].alive = False

    def recover(self, idx: int,
                from_best_of: Optional[dict] = None) -> Optional[int]:
        """Restart a failed trainer, optionally cloning the current best.

        Returns the trainer index the weights were cloned from (None
        when the trainer resumed with its own stale weights).
        """
        t = self.trainers[idx]
        t.alive = True
        if from_best_of is not None:
            src = self.best_index(from_best_of)
            t.params = self.trainers[src].params
            return src
        return None

    def resize(self, new_k: int, loaders: Sequence[Callable],
               tournament_batches: Sequence[List[dict]],
               clone_batch: Optional[dict] = None) -> Dict[str, Any]:
        """Elastic rescale to `new_k` trainers.

        Returns a provenance dict: ``kept`` maps each surviving slot to its
        pre-rescale trainer index, ``cloned`` lists the new slots (grow),
        ``clone_src`` is the pre-rescale index the clones warm-started
        from.
        """
        old_k = len(self.trainers)
        info: Dict[str, Any] = {"from_k": old_k, "to_k": new_k,
                                "cloned": [], "clone_src": None}
        if new_k < old_k:
            # keep the best new_k trainers
            if clone_batch is not None:
                scored = sorted(
                    (float(self.fns.metric(t.params, clone_batch)), i)
                    for i, t in enumerate(self.trainers))
                keep = sorted(i for _, i in scored[:new_k])
            else:
                keep = list(range(new_k))
            self.trainers = [self.trainers[i] for i in keep]
            info["kept"] = keep
        else:
            if clone_batch is not None:
                scored = sorted(
                    (float(self.fns.metric(t.params, clone_batch)), i)
                    for i, t in enumerate(self.trainers) if t.alive)
                src_idx = scored[0][1]
            else:
                src_idx = 0
            src = self.trainers[src_idx].params
            for i in range(old_k, new_k):
                params, opt_state, hparams = self.fns.init(
                    self.seed + 7777 * i)
                st = TrainerState(params, opt_state, hparams,
                                  loaders[i], list(tournament_batches[i]))
                st.params = src          # warm-start from the current best
                self.trainers.append(st)
            info["kept"] = list(range(old_k))
            info["cloned"] = list(range(old_k, new_k))
            info["clone_src"] = src_idx
        for i, t in enumerate(self.trainers):
            t.loader = loaders[i]
            t.tournament_batches = list(tournament_batches[i])
        return info

    # -- checkpointing ----------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Round, seed, scope and every trainer's state (live tensors)."""
        return {
            "round": self.round,
            "seed": self.seed,
            "scope": self.scope,
            "trainers": [
                {"params": t.params, "opt_state": t.opt_state,
                 "hparams": t.hparams, "steps": t.steps, "alive": t.alive,
                 "wins": t.wins, "adoptions": t.adoptions}
                for t in self.trainers],
        }

    def load_state_dict(self, state: Dict[str, Any]):
        """Take a :meth:`state_dict` of the same size (use :meth:`resize`
        for an elastic restore)."""
        self.round = state["round"]
        if len(state["trainers"]) != len(self.trainers):
            raise ValueError("use resize() for elastic restore")
        for t, s in zip(self.trainers, state["trainers"]):
            t.params = s["params"]
            t.opt_state = s["opt_state"]
            t.hparams = dict(s["hparams"])
            t.steps = int(s["steps"])
            t.alive = bool(s["alive"])
            t.wins = int(s.get("wins", 0))
            t.adoptions = int(s.get("adoptions", 0))
