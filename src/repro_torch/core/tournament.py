"""End-to-end LTFB tournament orchestrator (``repro.core.tournament``;
paper §III-B + §III-C).

The LTFB tournament running on top of the distributed in-memory data
store: each of the K trainers owns a disjoint partition of the bundle
manifest, serves its mini-batches from its own
:class:`~repro_torch.datastore.store.DataStore` through a background
:class:`~repro_torch.datastore.store.PrefetchLoader`, uploads each batch
to the device in one copy, and exchanges models through tournaments.

One API, two backends, as in the JAX package:

  * ``backend='host'`` — every trainer in this process; random pairing,
    metric evaluation overlapped with the exchange on a thread pool,
    failure/recovery and elastic rescale.
  * ``backend='mesh'`` — SPMD over ``torch.distributed``: one process
    rank a trainer (the ``('trainer', 'model')`` grid of
    :func:`repro_torch.launch.mesh.make_ltfb_mesh` with one model rank a
    trainer), every rank constructing the orchestrator and calling each
    method in the same order.  Rank r holds trainer r's weights,
    optimizer state, loader and datastore partition; the tournament is
    the butterfly exchange of :func:`repro_torch.core.ltfb.make_ltfb_step`
    (power-of-two K, no random pairing, no hyper-parameter perturbation,
    one concatenated tournament batch, optionally int8 on the wire).
    Each round's metrics, counters and validation scores are gathered,
    so that every rank holds the same log, counters and stats; rank 0
    alone writes the genealogy and the JSON records, and
    :meth:`TournamentOrchestrator.gather_trace` brings the other ranks'
    trainer spans to its trace.  A checkpoint keeps the host backend's
    layout (each rank writes its member, rank 0 the manifest), so either
    backend, and the JAX package, resumes it.  ``stats()`` is a
    collective there.  Elastic rescale across ranks is not ported
    (ROADMAP.md queue A17).

Failure/recovery, elastic rescale and population checkpoint/restart as
in the JAX package.

``telemetry=`` (a :class:`repro_torch.train.telemetry.TrainTelemetry`)
traces every trainer's steps, data waits, evals and exchanges and the
orchestrator's tournaments, rescales, checkpoints and restores;
``genealogy=`` (a :class:`~repro_torch.train.telemetry.GenealogyLog`)
appends the JAX package's genealogy records; the ``ltfb_*`` JSON-log
records go out under ``--log-json``.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.core import ltfb
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
    backend: str = "host"            # 'host' | 'mesh' (process ranks)
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
    quantize_exchange: bool = False  # int8 mesh exchange (beyond-paper)
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
        if cfg.backend not in ("host", "mesh"):
            raise ValueError(f"unknown backend {cfg.backend!r}")
        self.device = resolve_device(cfg.device)
        self.fns = fns
        self.plan = plan
        self.cfg = cfg
        # mesh backend: this rank's trainer index and the trainer process
        # group (None on the host backend)
        self._rank: Optional[int] = None
        self._group = None
        self._mesh_step = None
        if cfg.backend == "mesh":
            self._join_mesh(mesh, cfg.trainers)
        # rank 0 alone writes the genealogy, the JSON records and the log
        self._writer = self._rank in (None, 0)
        self._retired_stats: Dict[str, float] = {}
        self.tournament_exchange_bytes = 0
        # observability: tracing (TrainTelemetry), the genealogy JSONL
        # (GenealogyLog), per-round wall/tournament/checkpoint timings,
        # event counters and the live efficiency
        self.telemetry = telemetry
        self.genealogy = genealogy if self._writer else None
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
            if (cfg.async_eval and cfg.backend == "host") else None
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
            perturb_hparams=cfg.perturb_hparams, local=self._rank)
        self.population.telemetry = telemetry
        if self.genealogy is not None:
            self.genealogy.append(
                "init", trainers=cfg.trainers, backend=cfg.backend,
                scope=cfg.scope, seed=cfg.seed,
                partition=cfg.partition, files=len(self._train_files))

    # -- mesh plumbing -------------------------------------------------------
    @staticmethod
    def _check_mesh_fits(k: int):
        from repro_torch.launch.mesh import world_size

        if k < 2 or k & (k - 1):
            raise ValueError(
                f"mesh backend needs power-of-two trainers >= 2, got {k}")
        if world_size() < k:
            raise ValueError(
                f"mesh backend needs >= {k} process ranks (have "
                f"{world_size()}) — launch the ranks with torchrun or "
                "repro_torch.launch.mesh.spawn and call init_ranks(), or "
                "use backend='host'")

    def _join_mesh(self, mesh, k: int):
        """Take this rank's place in the trainer grid (JAX's
        ``make_ltfb_mesh(K, per_trainer_model=1)`` unless ``mesh`` is
        given)."""
        from repro_torch.launch.mesh import make_ltfb_mesh

        if mesh is None:
            self._check_mesh_fits(k)
            mesh = make_ltfb_mesh(k, per_trainer_model=1)
        if mesh.shape[mesh.axes.index("trainer")] != k:
            raise ValueError(f"the mesh has {mesh.shape} ranks along "
                             f"{mesh.axes}, not {k} trainers")
        if "trainer" not in mesh.groups:
            raise ValueError(f"rank {dist.get_rank()} is outside the "
                             f"{mesh.shape} trainer grid")
        self._group = mesh.groups["trainer"]
        self._rank = dist.get_rank(self._group)

    def _gather(self, obj) -> List[Any]:
        """``obj`` of every trainer rank, by trainer index."""
        out: List[Any] = [None] * dist.get_world_size(self._group)
        dist.all_gather_object(out, obj, group=self._group)
        return out

    @property
    def _home(self) -> int:
        """The trainer index held in this process (0 on the host)."""
        return self._rank or 0

    def _record(self, event: str, **fields):
        if self._writer:
            log_event(event, **fields)

    # -- data plumbing -----------------------------------------------------
    def _build_data(self, k: int):
        """Partition the manifest across k trainers; build stores,
        prefetchers and per-trainer held-out tournament batches (on the
        mesh backend for this rank's trainer only: the other slots hold
        ``None``)."""
        if len(self._train_files) < k:
            raise ValueError(
                f"manifest has {len(self._train_files)} training files "
                f"(after the held-out reserve) < {k} trainers — write "
                "more bundles or lower --trainers")
        cfg = self.cfg
        mine = range(k) if self._rank is None else [self._rank]
        self.stores: List[Optional[DataStore]] = [None] * k
        self.loaders: List[Optional[PrefetchLoader]] = [None] * k
        self._loader_fns: List[Optional[Callable]] = [None] * k
        self._tournament_batches: List[List[dict]] = [[] for _ in range(k)]
        for i in mine:
            store = DataStore(
                partition_files(self._train_files, k, i, cfg.partition),
                self.plan.reader, num_ranks=cfg.num_ranks,
                mode=cfg.store_mode, seed=cfg.seed + i)
            if cfg.store_mode == "preload":
                store.preload()
            self.stores[i] = store
            self.loaders[i] = PrefetchLoader(store, cfg.batch_size,
                                             depth=cfg.prefetch_depth,
                                             consumer_rank=None)
            self._loader_fns[i] = self._make_loader_fn(self.loaders[i])
            self._tournament_batches[i] = self._held_out_batches(store, i)

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

    def _local_stores(self) -> List[DataStore]:
        return [s for s in self.stores if s is not None]

    def _local_loaders(self) -> List[PrefetchLoader]:
        return [ld for ld in self.loaders if ld is not None]

    def _teardown_data(self):
        for ld in self._local_loaders():
            ld.close()
        retired = aggregate_stats(self._local_stores())
        retired["prefetch_wait_seconds"] = sum(
            ld.wait_seconds for ld in self._local_loaders())
        for k, v in retired.items():
            self._retired_stats[k] = self._retired_stats.get(k, 0) + v

    # -- training + tournaments --------------------------------------------
    def train_round(self, steps: int) -> Dict[str, Any]:
        """Every alive trainer (held here) takes ``steps`` steps."""
        return self.population.train_round(steps)

    def tournament(self) -> Dict[str, Any]:
        """One tournament, its time and exchange bytes accounted."""
        t0 = time.perf_counter()
        if self.cfg.backend == "mesh":
            log = self._tournament_mesh()
            if self.telemetry is not None:
                self.telemetry.span("mesh_tournament", t0,
                                    time.perf_counter(),
                                    phase="tournament_eval",
                                    round=self.population.round - 1,
                                    exchange_bytes=log["exchange_bytes"])
        else:
            log = self.population.tournament(executor=self._executor)
        log.setdefault("seconds", time.perf_counter() - t0)
        self.tournament_seconds += float(log["seconds"])
        self.tournament_exchange_bytes += int(log.get("exchange_bytes", 0))
        return log

    def _maybe_probe_flops(self):
        """FLOPs of one train step (once, lazily, telemetry runs only),
        so the efficiency is also stated in model-FLOP/s.  The probe
        batch is read from the first held trainer's store as JAX's probe
        reads trainer 0's, and the step runs on ``meta`` copies
        (:func:`repro_torch.train.telemetry.step_flops`): the trainer is
        not stepped."""
        if self._flops_probed or self.telemetry is None:
            return
        self._flops_probed = True
        t0 = self.population.trainers[self._home]
        store = self.stores[self._home]
        perm = store.epoch_permutation(0)
        batch = _to_device(self.plan.adapt(
            store.get_batch(perm, 0, self.cfg.batch_size)), "meta")
        self._flops_per_step = step_flops(
            self.fns.train_step, t0.params, t0.opt_state, batch, t0.hparams)

    def _round_figures(self, before) -> tuple:
        """(per-trainer step/time deltas, [(val metric, trainer)] of the
        alive trainers) for the round just run; on the mesh backend
        gathered from every rank, which also brings the remote trainers'
        counters up to date."""
        def delta(t):
            s0, tr0, dw0 = before.get(id(t), (t.steps, 0.0, 0.0))
            return {"steps": t.steps - s0,
                    "train_seconds": t.train_seconds - tr0,
                    "data_wait_seconds": t.data_wait_seconds - dw0}

        trainers = self.population.trainers
        if self._rank is None:
            vals = [(float(self.fns.metric(t.params, self.val_batch)), i)
                    for i, t in enumerate(trainers) if t.alive]
            return [delta(t) for t in trainers], vals
        me = trainers[self._rank]
        val = float(self.fns.metric(me.params, self.val_batch)) \
            if me.alive else None
        mine = {"delta": delta(me), "val": val, "steps": me.steps,
                "train_seconds": me.train_seconds,
                "data_wait_seconds": me.data_wait_seconds,
                "last_metrics": me.last_metrics}
        got = self._gather(mine)
        for t, g in zip(trainers, got):
            if t.remote:
                t.steps, t.train_seconds = g["steps"], g["train_seconds"]
                t.data_wait_seconds = g["data_wait_seconds"]
                t.last_metrics = g["last_metrics"]
        vals = [(g["val"], i) for i, g in enumerate(got)
                if g["val"] is not None]
        return [g["delta"] for g in got], vals

    def run(self, rounds: int, steps_per_round: int, ckpt_every: int = 0,
            log: Optional[Callable[[str], None]] = None) -> List[float]:
        """rounds x (independent training, tournament[, checkpoint]).

        Returns the best-trainer validation trace (one entry/round).
        Each round also computes the parallel-efficiency figures
        (:func:`repro_torch.train.telemetry.efficiency_snapshot`),
        appends ``match`` + ``round`` genealogy records, and emits an
        ``ltfb_round`` structured log record (``--log-json``); on the
        mesh backend rank 0 alone writes them and calls ``log``.
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
            deltas, vals = self._round_figures(before)
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
            self._record("ltfb_round", round=round_idx, best_val=best,
                         best_trainer=best_idx, exchanged=tlog["exchanged"],
                         exchange_bytes=int(tlog.get("exchange_bytes", 0)),
                         tournament_seconds=float(tlog.get("seconds", 0.0)),
                         wall_seconds=self.last_round_seconds,
                         efficiency=eff)
            if log is not None and self._writer:
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

    # -- mesh backend ----------------------------------------------------------
    def _ensure_mesh_step(self):
        def metric(params, batch):
            return self.fns.metric(params, batch)

        self._mesh_step = ltfb.make_ltfb_step(
            metric, len(self.population.trainers), self._group,
            scope=self.cfg.scope, quantize=self.cfg.quantize_exchange)
        # the full tournament set as one eval batch, as JAX's mesh
        # backend evaluates it (the host backend averages batch by batch)
        tb = self._tournament_batches[self._rank]
        self._mesh_batch = {k: torch.cat([b[k] for b in tb]) for k in tb[0]}

    def _tournament_mesh(self) -> Dict[str, Any]:
        """Butterfly tournament over the trainer ranks: this rank swaps
        its exchanged part with its partner and keeps the better model;
        every rank then holds every pair's metrics and counters."""
        trainers = self.population.trainers
        if not all(t.alive for t in trainers):
            raise RuntimeError(
                "mesh tournament schedule is static and cannot self-pair "
                "dead trainers — recover() them first or use the host "
                "backend for failure handling")
        if self._mesh_step is None:
            self._ensure_mesh_step()
        k = len(trainers)
        me = trainers[self._rank]
        round_idx = self.population.round
        me.params, m_local, m_other = self._mesh_step(
            me.params, self._mesh_batch, round_idx)
        pairs = self._gather((float(m_local), float(m_other)))
        partner = ltfb.butterfly_pairing(k, round_idx)
        exch, _ = ltfb.split_scope(me.params, self.cfg.scope)
        per_model = ltfb.tree_nbytes(exch)
        if self.cfg.quantize_exchange:
            per_model //= 4          # int8 payload vs f32 (+ small scales)
        log = {"exchanged": 0, "kept_local": 0, "metrics": [],
               "exchange_bytes": per_model * k,
               "partner": partner.tolist(),
               "wire_bytes": int(self._mesh_step.last["wire_bytes"]),
               "exchange_seconds": self._mesh_step.last["exchange_s"]}
        for i, t in enumerate(trainers):
            ml, mo = pairs[i]
            adopted = mo < ml
            j = int(partner[i])
            log["metrics"].append((i, j, ml, mo))
            if adopted:
                t.adoptions += 1
                log["exchanged"] += 1
                trainers[j].wins += 1
            else:
                t.wins += 1
                log["kept_local"] += 1
        self.population.round += 1
        return log

    def gather_trace(self) -> None:
        """Bring every other rank's trainer spans into rank 0's trace (a
        collective on the mesh backend, every rank with its telemetry;
        nothing to do on the host backend).  Span times are moved to rank
        0's clock through each rank's wall clock."""
        if self._rank is None or self.telemetry is None:
            return
        tracer = self.telemetry.tracer
        shift = time.time() - time.perf_counter()
        spans = [(e["name"], e["args"], tracer.epoch + e["ts"] / 1e6,
                  e["dur"] / 1e6) for e in list(tracer.events)
                 if e["ph"] == "X" and "rid" in e["args"]]
        got = self._gather((shift, spans))
        if not self._writer:
            return
        for r, (their_shift, their_spans) in enumerate(got):
            if r == self._rank:
                continue
            for name, args, t0, dur in their_spans:
                t0 = t0 + their_shift - shift
                args = dict(args)
                trainer = args.pop("rid")
                self.telemetry.trainer_span(name, trainer, t0, t0 + dur,
                                            **args)

    # -- fault tolerance / elasticity ---------------------------------------
    def fail(self, idx: int):
        """Take trainer ``idx`` out of training and tournaments (on the
        mesh backend every rank calls it)."""
        self.population.fail(idx)
        self.events["failures"] += 1
        if self.genealogy is not None:
            self.genealogy.append("fail", trainer=idx,
                                  round=self.population.round)
        if self.telemetry is not None:
            self.telemetry.event("trainer_fail", trainer=idx)
        self._record("ltfb_trainer_fail", trainer=idx,
                     round=self.population.round)

    def recover(self, idx: int, from_best: bool = True):
        """Bring trainer ``idx`` back, cloning the best trainer's weights
        on the held-out batch (or resuming its own).  On the mesh backend
        every rank calls it, and the best trainer's rank sends its
        weights to ``idx``'s."""
        if self._rank is None:
            src = self.population.recover(
                idx, from_best_of=self.val_batch if from_best else None)
        else:
            src = self._recover_mesh(idx, from_best)
        self.events["recoveries"] += 1
        if self.genealogy is not None:
            self.genealogy.append("recover", trainer=idx, cloned_from=src,
                                  round=self.population.round)
        if self.telemetry is not None:
            self.telemetry.event("trainer_recover", trainer=idx,
                                 cloned_from=src)
        self._record("ltfb_trainer_recover", trainer=idx, cloned_from=src,
                     round=self.population.round)

    def _recover_mesh(self, idx: int, from_best: bool) -> Optional[int]:
        me = self.population.trainers[self._rank]
        self.population.trainers[idx].alive = True
        if not from_best:
            return None
        val = float(self.fns.metric(me.params, self.val_batch)) \
            if me.alive else float("inf")
        scores = self._gather(val)
        src = min((v, i) for i, v in enumerate(scores))[1]
        if src != idx:
            if self._rank == src:
                ltfb.send_tree(me.params, ltfb.global_rank(self._group, idx),
                               self._group)
            elif self._rank == idx:
                me.params = ltfb.recv_tree(
                    me.params, ltfb.global_rank(self._group, src),
                    self._group)
        return src

    def rescale(self, new_k: int):
        """Elastic rescale: re-partition the datastore manifest across
        `new_k` trainers and grow (cloning tournament winners) or shrink
        (keeping the best) the population."""
        if self._rank is not None:
            raise NotImplementedError(
                "elastic rescale of the mesh backend (a new number of "
                "process ranks) is not ported; see ROADMAP.md queue A17")
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
        self._record("ltfb_rescale", round=self.population.round, **info)

    # -- checkpoint / restart -----------------------------------------------
    def _to_ckpt(self, params, opt_state):
        if self.fns.to_ckpt is None:
            return params, opt_state
        return self.fns.to_ckpt(params, opt_state)

    def save_checkpoint(self):
        """Write the population to ``cfg.ckpt_dir`` at the current round
        (on the mesh backend each rank writes its member, and rank 0 the
        manifest once every member is written)."""
        if not self.cfg.ckpt_dir:
            raise ValueError("TournamentConfig.ckpt_dir not set")
        t0 = time.perf_counter()
        state = self.population.state_dict()
        step = self.population.round
        if self._rank is None:
            for tr in state["trainers"]:
                tr["params"], tr["opt_state"] = self._to_ckpt(
                    tr["params"], tr["opt_state"])
            ckpt.save_population(self.cfg.ckpt_dir, step, state)
        else:
            tr = state["trainers"][self._rank]
            tr["params"], tr["opt_state"] = self._to_ckpt(tr["params"],
                                                          tr["opt_state"])
            ckpt.save_member(self.cfg.ckpt_dir, step, self._rank, tr)
            dist.barrier(group=self._group)
            if self._writer:
                ckpt.write_manifest(self.cfg.ckpt_dir, step,
                                    len(state["trainers"]), state["round"],
                                    state["seed"], state["scope"])
            dist.barrier(group=self._group)
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
        self._record("ltfb_checkpoint", round=self.population.round,
                     seconds=dur)

    def maybe_resume(self) -> bool:
        """Restore the newest population checkpoint, if any.  Elastic:
        a checkpoint with K' != K trainers restores into K slots.  On the
        mesh backend each rank reads its own member's weights and every
        member's counters."""
        if not self.cfg.ckpt_dir:
            return False
        step = ckpt.latest_population_step(self.cfg.ckpt_dir)
        if step is None:
            return False
        home = self.population.trainers[self._home]
        like_p, like_o = self._to_ckpt(home.params, home.opt_state)
        like = {"params": like_p, "opt_state": like_o}
        w0 = time.perf_counter()
        if self._rank is None:
            state = ckpt.restore_population(
                self.cfg.ckpt_dir, step, like,
                num_trainers=len(self.population.trainers))
        else:
            state = self._restore_mesh(step, like)
        if self.fns.from_ckpt is not None:
            for tr in state["trainers"]:
                if tr["params"] is not None:
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
        self._record("ltfb_resume", round=self.population.round, step=step,
                     seconds=dur)
        return True

    def _restore_mesh(self, step: int, like: dict) -> Dict[str, Any]:
        manifest = ckpt.read_manifest(self.cfg.ckpt_dir, step)
        k_stored = manifest["num_trainers"]
        trainers = [ckpt.restore_member(
            self.cfg.ckpt_dir, step, i % k_stored,
            like if i == self._rank else None)
            for i in range(len(self.population.trainers))]
        return {"round": manifest["round"], "trainers": trainers}

    # -- accounting ----------------------------------------------------------
    def _trainer_stats(self, i: int) -> Dict[str, Any]:
        store, loader = self.stores[i], self.loaders[i]
        t = self.population.trainers[i]
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
        return d

    def stats(self) -> Dict[str, Any]:
        """Unified per-trainer + total data/tournament accounting.

        Per trainer: datastore counters plus partition sizes, step/wall
        attribution (``train_seconds`` / ``data_wait_seconds``), the
        last train-step metrics and tournament metric.  Totals include
        round wall time, tournament/checkpoint/restore durations,
        prefetch-stall time and rescale/fail/recover event counts.  On
        the mesh backend a collective: every rank calls it, and each
        trainer's entry comes from its rank.
        """
        held = [i for i, s in enumerate(self.stores) if s is not None]
        mine = ([self._trainer_stats(i) for i in held],
                aggregate_stats(self._local_stores()),
                sum(ld.wait_seconds for ld in self._local_loaders()),
                dict(self._retired_stats))
        parts = [mine] if self._rank is None else self._gather(mine)
        per = [d for p in parts for d in p[0]]
        total: Dict[str, float] = {}
        prefetch = 0.0
        for _, agg, wait, retired in parts:
            prefetch += wait + retired.get("prefetch_wait_seconds", 0)
            for src in (agg, retired):
                for k, v in src.items():
                    total[k] = total.get(k, 0) + v
        return {"per_trainer": per, "total": total,
                "tournament_exchange_bytes": self.tournament_exchange_bytes,
                "round": self.population.round,
                "steps": sum(d["steps"] for d in per),
                "train_seconds": sum(d["train_seconds"] for d in per),
                "data_wait_seconds": sum(d["data_wait_seconds"]
                                         for d in per),
                "prefetch_wait_seconds": prefetch,
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
        for ld in self._local_loaders():
            ld.close()
        if self._executor is not None:
            self._executor.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
