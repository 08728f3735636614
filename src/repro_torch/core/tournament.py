"""End-to-end LTFB tournament orchestrator (``repro.core.tournament``,
host backend; paper §III-B + §III-C).

The LTFB tournament running on top of the distributed in-memory data
store: each of the K trainers owns a disjoint partition of the bundle
manifest, serves its mini-batches from its own
:class:`~repro_torch.datastore.store.DataStore` through a background
:class:`~repro_torch.datastore.store.PrefetchLoader`, uploads each batch
to the device in one copy, and exchanges models through host tournaments
(random pairing, metric evaluation overlapped with the exchange on a
thread pool).  Failure/recovery, elastic rescale and population
checkpoint/restart as in the JAX package.

``telemetry=`` (a :class:`repro_torch.train.telemetry.TrainTelemetry`)
traces every trainer's steps, data waits, evals and exchanges and the
orchestrator's tournaments, rescales, checkpoints and restores;
``genealogy=`` (a :class:`~repro_torch.train.telemetry.GenealogyLog`)
appends the JAX package's genealogy records; the ``ltfb_*`` JSON-log
records go out under ``--log-json``.  Not ported yet: ``backend="mesh"``
and the int8 exchange (ROADMAP.md queue A6).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.core.population import Population, TrainerFns
from repro_torch.datastore.store import (
    DataStore,
    PrefetchLoader,
    aggregate_stats,
    partition_files,
)
from repro_torch.telemetry import log_event
from repro_torch.train.telemetry import efficiency_snapshot, step_flops


@dataclass
class DataPlan:
    """File manifest + decode/adapt plumbing for one dataset.

    ``reader(path)`` -> dict of per-sample arrays (leading sample dim);
    ``adapt(store_batch)`` -> the batch dict (numpy) the train step
    consumes once uploaded.
    """

    files: List[str]
    reader: Callable[[str], Dict[str, np.ndarray]]
    adapt: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]] = \
        field(default=lambda b: b)

    @classmethod
    def jag_cyclegan(cls, files: List[str]) -> "DataPlan":
        """JAG ICF bundles -> CycleGAN (x, y) batches."""
        from repro_torch.data import jag

        def adapt(b):
            return {"x": b["x"], "y": jag.flatten_outputs(b)}

        return cls(files=list(files), reader=jag.read_bundle, adapt=adapt)

    @classmethod
    def lm_tokens(cls, files: List[str]) -> "DataPlan":
        """Token shards -> (tokens, labels) LM batches."""
        from repro_torch.data import tokens

        return cls(files=list(files), reader=tokens.read_token_shard,
                   adapt=tokens.lm_shard_batch)


@dataclass
class TournamentConfig:
    """Population, datastore, tournament and persistence settings."""

    trainers: int = 4
    scope: str = "full"              # 'full' | 'generator' (GANs)
    backend: str = "host"            # 'host' ('mesh': queue A6)
    # datastore
    store_mode: str = "preload"      # 'preload' | 'dynamic' | 'none'
    num_ranks: int = 2               # simulated ranks per trainer
    partition: str = "stride"        # 'stride' | 'block' (data silos)
    batch_size: int = 128
    prefetch_depth: int = 2
    # tournament
    tournament_batches: int = 2      # held-out batches per metric eval
    tournament_batch_size: int = 64
    async_eval: bool = True          # overlap metric eval with exchange
    eval_workers: int = 4
    quantize_exchange: bool = False  # int8 mesh exchange (queue A6)
    # PBT
    perturb_hparams: bool = True
    perturb_factor: float = 1.2
    # reserve the manifest's last file as a shared held-out validation
    # set (never assigned to a trainer); falls back to file 0 (training
    # data — biased) when the manifest is too small to spare a file
    holdout: bool = True
    # persistence
    ckpt_dir: Optional[str] = None
    seed: int = 0
    # where batches go: the card unless the caller asks for "cpu"
    device: str = "cuda"


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                             torch.Tensor]:
    """A numpy batch as tensors on ``device``, one copy per array."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class TournamentOrchestrator:
    """Drives a K-trainer LTFB population fed from datastore partitions."""

    def __init__(self, fns: TrainerFns, plan: DataPlan,
                 cfg: TournamentConfig, mesh=None, telemetry=None,
                 genealogy=None):
        if cfg.backend == "mesh" or mesh is not None \
                or cfg.quantize_exchange:
            raise NotImplementedError(
                "the mesh tournament backend and its int8 exchange are not "
                "ported to repro_torch yet; see ROADMAP.md queue A6")
        if cfg.backend != "host":
            raise ValueError(f"unknown backend {cfg.backend!r}")
        self.device = resolve_device(cfg.device)
        self.fns = fns
        self.plan = plan
        self.cfg = cfg
        self._retired_stats: Dict[str, float] = {}
        self.tournament_exchange_bytes = 0
        # observability: tracing (TrainTelemetry), the genealogy JSONL
        # (GenealogyLog), per-round wall/tournament/checkpoint timings,
        # event counters and the live efficiency
        self.telemetry = telemetry
        self.genealogy = genealogy
        self.events = {"rescales": 0, "failures": 0, "recoveries": 0,
                       "checkpoints": 0, "restores": 0}
        self.tournament_seconds = 0.0
        self.round_wall_seconds = 0.0
        self.last_round_seconds = 0.0
        self.checkpoint_seconds = 0.0
        self.restore_seconds = 0.0
        self.last_efficiency: Optional[Dict[str, Any]] = None
        self._flops_per_step: Optional[float] = None
        self._flops_probed = False
        # per-round hook, called with the orchestrator after each round's
        # accounting (the launcher writes the Prometheus snapshot and
        # updates the metrics endpoint from here)
        self.on_round: Optional[Callable[["TournamentOrchestrator"],
                                         None]] = None
        self._executor = ThreadPoolExecutor(max_workers=cfg.eval_workers) \
            if cfg.async_eval else None
        # global held-out batch for best-of reporting, warm-start cloning
        # on rescale, and failure recovery: the manifest's last file,
        # excluded from every trainer's partition
        if cfg.holdout and len(plan.files) > cfg.trainers + 1:
            self._train_files = list(plan.files[:-1])
            val_file = plan.files[-1]
        else:
            self._train_files = list(plan.files)
            val_file = plan.files[0]      # too few files: biased fallback
        probe = plan.adapt(plan.reader(val_file))
        n_val = min(cfg.tournament_batch_size,
                    len(next(iter(probe.values()))))
        self.val_batch = _to_device({k: v[:n_val] for k, v in probe.items()},
                                    self.device)
        self._build_data(cfg.trainers)
        self.population = Population(
            fns, self._loader_fns, self._tournament_batches,
            scope=cfg.scope, seed=cfg.seed,
            perturb_factor=cfg.perturb_factor,
            perturb_hparams=cfg.perturb_hparams)
        self.population.telemetry = telemetry
        if self.genealogy is not None:
            self.genealogy.append(
                "init", trainers=cfg.trainers, backend=cfg.backend,
                scope=cfg.scope, seed=cfg.seed,
                partition=cfg.partition, files=len(self._train_files))

    # -- data plumbing -----------------------------------------------------
    def _build_data(self, k: int):
        """Partition the manifest across k trainers; build stores,
        prefetchers and per-trainer held-out tournament batches."""
        if len(self._train_files) < k:
            raise ValueError(
                f"manifest has {len(self._train_files)} training files "
                f"(after the held-out reserve) < {k} trainers — write "
                "more bundles or lower --trainers")
        cfg = self.cfg
        parts = [partition_files(self._train_files, k, i, cfg.partition)
                 for i in range(k)]
        self.stores = [DataStore(p, self.plan.reader,
                                 num_ranks=cfg.num_ranks,
                                 mode=cfg.store_mode, seed=cfg.seed + i)
                       for i, p in enumerate(parts)]
        for s in self.stores:
            if cfg.store_mode == "preload":
                s.preload()
        self.loaders = [PrefetchLoader(s, cfg.batch_size,
                                       depth=cfg.prefetch_depth,
                                       consumer_rank=None)
                        for s in self.stores]
        self._loader_fns = [self._make_loader_fn(ld) for ld in self.loaders]
        self._tournament_batches = [self._held_out_batches(s, i)
                                    for i, s in enumerate(self.stores)]

    def _make_loader_fn(self, loader: PrefetchLoader):
        adapt, device = self.plan.adapt, self.device

        def next_batch():
            return _to_device(adapt(loader.next()), device)

        return next_batch

    def _held_out_batches(self, store: DataStore, idx: int) -> List[dict]:
        """Tournament set: a dedicated permutation of the trainer's own
        partition (candidates are evaluated on LOCAL held-out data),
        uploaded once."""
        perm = store.epoch_permutation(999_983 + idx)
        return [_to_device(self.plan.adapt(
                    store.get_batch(perm, s, self.cfg.tournament_batch_size)),
                    self.device)
                for s in range(self.cfg.tournament_batches)]

    def _teardown_data(self):
        for ld in self.loaders:
            ld.close()
        retired = aggregate_stats(self.stores)
        retired["prefetch_wait_seconds"] = sum(ld.wait_seconds
                                               for ld in self.loaders)
        for k, v in retired.items():
            self._retired_stats[k] = self._retired_stats.get(k, 0) + v

    # -- training + tournaments --------------------------------------------
    def train_round(self, steps: int) -> Dict[str, Any]:
        """Every alive trainer takes ``steps`` steps."""
        return self.population.train_round(steps)

    def tournament(self) -> Dict[str, Any]:
        """One host tournament, its time and exchange bytes accounted."""
        t0 = time.perf_counter()
        log = self.population.tournament(executor=self._executor)
        log.setdefault("seconds", time.perf_counter() - t0)
        self.tournament_seconds += float(log["seconds"])
        self.tournament_exchange_bytes += int(log.get("exchange_bytes", 0))
        return log

    def _maybe_probe_flops(self):
        """FLOPs of one train step (once, lazily, telemetry runs only),
        so the efficiency is also stated in model-FLOP/s.  The probe
        batch is read from trainer 0's store as JAX's probe reads it, and
        the step runs on ``meta`` copies
        (:func:`repro_torch.train.telemetry.step_flops`): trainer 0 is
        not stepped."""
        if self._flops_probed or self.telemetry is None:
            return
        self._flops_probed = True
        t0 = self.population.trainers[0]
        perm = self.stores[0].epoch_permutation(0)
        batch = _to_device(self.plan.adapt(
            self.stores[0].get_batch(perm, 0, self.cfg.batch_size)), "meta")
        self._flops_per_step = step_flops(
            self.fns.train_step, t0.params, t0.opt_state, batch, t0.hparams)

    def run(self, rounds: int, steps_per_round: int, ckpt_every: int = 0,
            log: Optional[Callable[[str], None]] = None) -> List[float]:
        """rounds x (independent training, tournament[, checkpoint]).

        Returns the best-trainer validation trace (one entry/round).
        Each round also computes the parallel-efficiency figures
        (:func:`repro_torch.train.telemetry.efficiency_snapshot`),
        appends ``match`` + ``round`` genealogy records, and emits an
        ``ltfb_round`` structured log record (``--log-json``).
        """
        trace = []
        self._maybe_probe_flops()
        for _ in range(rounds):
            r0 = time.perf_counter()
            before = {id(t): (t.steps, t.train_seconds, t.data_wait_seconds)
                      for t in self.population.trainers}
            self.train_round(steps_per_round)
            tlog = self.tournament()
            round_idx = self.population.round - 1
            deltas = []
            for t in self.population.trainers:
                s0, tr0, dw0 = before.get(id(t), (t.steps, 0.0, 0.0))
                deltas.append({"steps": t.steps - s0,
                               "train_seconds": t.train_seconds - tr0,
                               "data_wait_seconds":
                                   t.data_wait_seconds - dw0})
            vals = [(float(self.fns.metric(t.params, self.val_batch)), i)
                    for i, t in enumerate(self.population.trainers)
                    if t.alive]
            best, best_idx = min(vals)
            trace.append(best)
            self.last_round_seconds = time.perf_counter() - r0
            self.round_wall_seconds += self.last_round_seconds
            eff = efficiency_snapshot(
                deltas, self.cfg.batch_size,
                float(tlog.get("seconds", 0.0)), self.last_round_seconds,
                flops_per_step=self._flops_per_step)
            self.last_efficiency = eff
            if self.genealogy is not None:
                seed = tlog.get("pairing_seed", self.cfg.seed)
                for i, j, m_local, m_other in tlog["metrics"]:
                    adopted = m_other < m_local
                    self.genealogy.append(
                        "match", round=round_idx, trainer=i, partner=j,
                        m_local=m_local, m_other=m_other,
                        winner=(j if adopted else i), adopted=adopted,
                        seed=seed)
                self.genealogy.append(
                    "round", round=round_idx, best_val=best,
                    best_trainer=best_idx,
                    exchanged=tlog["exchanged"],
                    exchange_bytes=int(tlog.get("exchange_bytes", 0)),
                    efficiency=eff)
            log_event("ltfb_round", round=round_idx, best_val=best,
                      best_trainer=best_idx, exchanged=tlog["exchanged"],
                      exchange_bytes=int(tlog.get("exchange_bytes", 0)),
                      tournament_seconds=float(tlog.get("seconds", 0.0)),
                      wall_seconds=self.last_round_seconds,
                      efficiency=eff)
            if log is not None:
                sp = eff.get("speedup")
                eff_txt = (f" speedup={sp:.2f}x "
                           f"eff={eff['efficiency'] * 100:.0f}%"
                           if sp is not None else "")
                log(f"[ltfb] round={self.population.round} "
                    f"best_val={best:.4f} exchanged={tlog['exchanged']} "
                    f"model_MB={tlog.get('exchange_bytes', 0) / 1e6:.2f}"
                    f"{eff_txt}")
            if self.on_round is not None:
                self.on_round(self)
            if (ckpt_every and self.cfg.ckpt_dir
                    and self.population.round % ckpt_every == 0):
                self.save_checkpoint()
        return trace

    # -- fault tolerance / elasticity ---------------------------------------
    def fail(self, idx: int):
        """Take trainer ``idx`` out of training and tournaments."""
        self.population.fail(idx)
        self.events["failures"] += 1
        if self.genealogy is not None:
            self.genealogy.append("fail", trainer=idx,
                                  round=self.population.round)
        if self.telemetry is not None:
            self.telemetry.event("trainer_fail", trainer=idx)
        log_event("ltfb_trainer_fail", trainer=idx,
                  round=self.population.round)

    def recover(self, idx: int, from_best: bool = True):
        """Bring trainer ``idx`` back, cloning the best trainer's weights
        on the held-out batch (or resuming its own)."""
        src = self.population.recover(
            idx, from_best_of=self.val_batch if from_best else None)
        self.events["recoveries"] += 1
        if self.genealogy is not None:
            self.genealogy.append("recover", trainer=idx, cloned_from=src,
                                  round=self.population.round)
        if self.telemetry is not None:
            self.telemetry.event("trainer_recover", trainer=idx,
                                 cloned_from=src)
        log_event("ltfb_trainer_recover", trainer=idx, cloned_from=src,
                  round=self.population.round)

    def rescale(self, new_k: int):
        """Elastic rescale: re-partition the datastore manifest across
        `new_k` trainers and grow (cloning tournament winners) or shrink
        (keeping the best) the population."""
        t0 = time.perf_counter()
        self._teardown_data()
        self._build_data(new_k)
        info = self.population.resize(new_k, self._loader_fns,
                                      self._tournament_batches,
                                      clone_batch=self.val_batch)
        self.events["rescales"] += 1
        if self.genealogy is not None:
            self.genealogy.append("rescale", round=self.population.round,
                                  **info)
        if self.telemetry is not None:
            self.telemetry.span("rescale", t0, time.perf_counter(),
                                **info)
        log_event("ltfb_rescale", round=self.population.round, **info)

    # -- checkpoint / restart -----------------------------------------------
    def _to_ckpt(self, params, opt_state):
        if self.fns.to_ckpt is None:
            return params, opt_state
        return self.fns.to_ckpt(params, opt_state)

    def save_checkpoint(self):
        """Write the population to ``cfg.ckpt_dir`` at the current round."""
        if not self.cfg.ckpt_dir:
            raise ValueError("TournamentConfig.ckpt_dir not set")
        t0 = time.perf_counter()
        state = self.population.state_dict()
        for tr in state["trainers"]:
            tr["params"], tr["opt_state"] = self._to_ckpt(tr["params"],
                                                          tr["opt_state"])
        ckpt.save_population(self.cfg.ckpt_dir, self.population.round,
                             state)
        dur = time.perf_counter() - t0
        self.checkpoint_seconds += dur
        self.events["checkpoints"] += 1
        if self.genealogy is not None:
            self.genealogy.append("checkpoint",
                                  round=self.population.round,
                                  seconds=dur)
            # a checkpoint is a durability point for the ancestry too
            self.genealogy.sync()
        if self.telemetry is not None:
            self.telemetry.span("checkpoint", t0, time.perf_counter(),
                                phase="checkpoint",
                                round=self.population.round)
        log_event("ltfb_checkpoint", round=self.population.round,
                  seconds=dur)

    def maybe_resume(self) -> bool:
        """Restore the newest population checkpoint, if any.  Elastic:
        a checkpoint with K' != K trainers restores into K slots."""
        if not self.cfg.ckpt_dir:
            return False
        step = ckpt.latest_population_step(self.cfg.ckpt_dir)
        if step is None:
            return False
        t0 = self.population.trainers[0]
        like_p, like_o = self._to_ckpt(t0.params, t0.opt_state)
        w0 = time.perf_counter()
        state = ckpt.restore_population(
            self.cfg.ckpt_dir, step, {"params": like_p, "opt_state": like_o},
            num_trainers=len(self.population.trainers))
        if self.fns.from_ckpt is not None:
            for tr in state["trainers"]:
                tr["params"], tr["opt_state"] = self.fns.from_ckpt(
                    tr["params"], tr["opt_state"])
        self.population.load_state_dict(state)
        dur = time.perf_counter() - w0
        self.restore_seconds += dur
        self.events["restores"] += 1
        if self.genealogy is not None:
            self.genealogy.append("resume", round=self.population.round,
                                  step=step, seconds=dur)
        if self.telemetry is not None:
            self.telemetry.span("restore", w0, time.perf_counter(),
                                phase="restore", step=step)
        log_event("ltfb_resume", round=self.population.round, step=step,
                  seconds=dur)
        return True

    # -- accounting ----------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Unified per-trainer + total data/tournament accounting.

        Per trainer: datastore counters plus partition sizes, step/wall
        attribution (``train_seconds`` / ``data_wait_seconds``), the
        last train-step metrics and tournament metric.  Totals include
        round wall time, tournament/checkpoint/restore durations,
        prefetch-stall time and rescale/fail/recover event counts.
        """
        per = []
        for store, loader, t in zip(self.stores, self.loaders,
                                    self.population.trainers):
            d = store.stats.as_dict()
            d.update(files=len(store.files),
                     partition_samples=store.num_samples,
                     wins=t.wins, adoptions=t.adoptions, steps=t.steps,
                     alive=t.alive,
                     train_seconds=t.train_seconds,
                     data_wait_seconds=t.data_wait_seconds,
                     prefetch_wait_seconds=loader.wait_seconds,
                     train_metrics=dict(t.last_metrics),
                     tournament_metric=t.tournament_metric)
            per.append(d)
        total = aggregate_stats(self.stores)
        for k, v in self._retired_stats.items():
            total[k] = total.get(k, 0) + v
        return {"per_trainer": per, "total": total,
                "tournament_exchange_bytes": self.tournament_exchange_bytes,
                "round": self.population.round,
                "steps": sum(t.steps for t in self.population.trainers),
                "train_seconds": sum(t.train_seconds
                                     for t in self.population.trainers),
                "data_wait_seconds": sum(
                    t.data_wait_seconds
                    for t in self.population.trainers),
                "prefetch_wait_seconds": (
                    sum(ld.wait_seconds for ld in self.loaders)
                    + self._retired_stats.get("prefetch_wait_seconds", 0)),
                "tournament_seconds": self.tournament_seconds,
                "round_wall_seconds": self.round_wall_seconds,
                "last_round_seconds": self.last_round_seconds,
                "checkpoint_seconds": self.checkpoint_seconds,
                "restore_seconds": self.restore_seconds,
                "events": dict(self.events),
                "efficiency": self.last_efficiency,
                "flops_per_step": self._flops_per_step}

    # -- lifecycle -----------------------------------------------------------
    def close(self):
        """Stop the prefetch threads and the eval pool."""
        for ld in self.loaders:
            ld.close()
        if self._executor is not None:
            self._executor.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
