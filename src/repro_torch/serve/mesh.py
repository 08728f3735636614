"""Mesh serving of the port: data-sharded page pools and a host-0 step plan.

The counterpart of ``repro.serve.mesh``, in PyTorch's idiom.

**Inside one process a mesh is a geometry** (:class:`ServeMesh`), not a
device placement.  JAX lays a ``(data, model)`` device mesh out under
GSPMD; the port keeps every ``data`` shard on the session's one device
(the card, or the CPU when asked).  Each shard keeps its own slots, its
own sub-pool of every paged KV pool with its own null page, and its own
:class:`~repro_torch.serve.kv_cache.PageShard` accounting (a sharded
:class:`~repro_torch.serve.kv_cache.PagedLayout`); decode and verify
attention run once a shard over that shard's view of the pool with its
tables rebased (:func:`repro_torch.kernels.ops.paged_attention_sharded`),
so no row reads another shard's pages.

**The ``model`` axis spans process ranks.**  JAX lays ``model`` over the
local devices of one process; a port process drives one device, so a
mesh with ``model = M > 1`` runs in a job of ``R * M`` ranks
(``python -m repro_torch.launch.distributed --procs N --mesh D,M``, or
torchrun): ``R`` replicas of ``M`` model ranks each, on the ``('replica',
'model')`` grid of :func:`repro_torch.launch.mesh.make_serve_mesh`.  Each
model rank holds its cut of the weights
(:func:`repro_torch.parallel.tensor.shard_lm` under JAX's
``MESH_SERVE_RULES``) and of every KV pool (the rank's kv heads), and
the model group's collectives (an all-reduce after each row-parallel
``wo``, the vocab-parallel lookup, the logits gathered in vocab order)
keep the ranks' activations and sampled tokens identical.  In one
process ``model > 1`` raises.  The speculative round (A18), MoE FFNs
(A19) and recurrent or hybrid mixers (A20) are refused at ``model > 1``.

**Across processes the port follows JAX's multi-process design**: every
rank holds a full replica on its own device (JAX's ``local_mesh=True``)
and the ranks stay in lockstep through the step plan.  Rank 0 decides
admission, hot swaps, submits, cancels and arena promotions and
broadcasts them as a :class:`StepPlan`; followers replay the plan and
land in an identical state.  Everything else a scheduler does is a
deterministic function of the replicated state.  Plan transports
(:func:`make_plan_channel` picks one):

* one process: :class:`LoopbackChannel`, the plan round-tripping its wire
  encoding every step;
* several ranks of ``torch.distributed``: :class:`ProcessGroupChannel`,
  ``broadcast_object_list`` from rank 0 and ``gather_object`` to it over a
  gloo group of its own (plans and stats are host bytes, whatever the
  default group's backend), every call bounded by the step timeout so a
  dead peer raises instead of hanging.
"""
from __future__ import annotations

import datetime
import json
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import RankLayoutError
from repro_torch.models import lm
from repro_torch.parallel.tensor import (plan_shards, shard_lm,
                                         tensor_parallel)
from repro_torch.serve.kv_cache import PagedLayout, SlotLayout, blocks_for
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.session import DecodeSession, MeshDecodeSession
from repro_torch.serve.telemetry import stats_snapshot

__all__ = ["LoopbackChannel", "MeshDecodeSession", "MeshScheduler",
           "PlanChannel", "ProcessGroupChannel", "ServeMesh", "StepPlan",
           "check_model_axis", "decode_request", "encode_request",
           "make_engine_session", "make_plan_channel", "mesh_model",
           "parse_mesh"]


# ---------------------------------------------------------------------------
# the mesh's geometry
# ---------------------------------------------------------------------------


def parse_mesh(spec: str) -> Tuple[int, int]:
    """Parse ``--mesh`` values: "4,2" / "data=4,model=2" / "8" (pure
    data parallelism) -> (data, model), as JAX parses them."""
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    named = {}
    sizes = []
    for p in parts:
        if "=" in p:
            k, v = p.split("=", 1)
            named[k.strip()] = int(v)
        else:
            sizes.append(int(p))
    if named:
        return named.get("data", 1), named.get("model", 1)
    if len(sizes) == 1:
        return sizes[0], 1
    if len(sizes) == 2:
        return sizes[0], sizes[1]
    raise ValueError(f"cannot parse mesh spec {spec!r}")


def check_model_axis(model: int, world: Optional[int]) -> None:
    """Raise :class:`~repro_torch.launch.mesh.RankLayoutError` unless a
    ``model`` axis of this size can be laid over ``world`` process ranks
    (``None``: no process group).  ``model = 1`` always can."""
    if model <= 1:
        return
    if world is None or world % model:
        have = "one process with no process group" if world is None \
            else f"a job of {world} ranks"
        raise RankLayoutError(
            f"a serving mesh with model={model} spans process ranks: each "
            f"of the {model} model ranks of a replica holds its cut of the "
            f"weights on its own device, so it runs in a job of a multiple "
            f"of {model} ranks, not in {have}; launch it with `python -m "
            f"repro_torch.launch.distributed --procs N --mesh DATA,{model}` "
            f"(or torchrun)")


@dataclass(frozen=True)
class ServeMesh:
    """A serving mesh's ``(data, model)`` axis sizes.

    ``data`` shards the decode batch and every page pool into private
    sub-pools on one device.  ``model`` > 1 cuts the weights and the KV
    heads over that many process ranks: it needs this process to be a
    rank of a job whose size ``model`` divides
    (:func:`check_model_axis`), else it raises naming
    ``repro_torch.launch.distributed``.
    """

    data: int = 1
    model: int = 1

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"mesh axes must be >= 1, got data={self.data} "
                             f"model={self.model}")
        check_model_axis(self.model, dist.get_world_size()
                         if dist.is_initialized() else None)


def mesh_model(model: lm.LM, mesh: ServeMesh,
               timeout_s: float = mesh_lib.DEFAULT_TIMEOUT_S) -> lm.LM:
    """The model this rank serves on ``mesh``: ``model`` itself at
    ``model = 1`` or when it is a shard already; else this rank's shard
    (:func:`repro_torch.parallel.tensor.shard_lm`) with its collectives
    on a model group of its own (:func:`repro_torch.launch.mesh.
    make_serve_mesh`; every rank of the job calls this together, and
    each collective waits at most ``timeout_s``)."""
    tp = tensor_parallel(model)
    if tp is not None:
        if tp.size != mesh.model:
            raise ValueError(f"a shard over {tp.size} model ranks on a mesh "
                             f"with model={mesh.model}")
        return model
    if mesh.model == 1:
        return model
    ranks = mesh_lib.make_serve_mesh(mesh.model, timeout_s=timeout_s)
    coords = ranks.coords(dist.get_rank())
    return shard_lm(model, mesh, coords[1], ranks.groups["model"])


# ---------------------------------------------------------------------------
# the host-0 decision record
# ---------------------------------------------------------------------------


def encode_request(req: Request) -> Dict[str, Any]:
    """Wire-encode a :class:`~repro_torch.serve.scheduler.Request` for the
    plan broadcast (JSON scalars + a token-id list; the rid must be a JSON
    scalar to be mesh-servable)."""
    return {"rid": req.rid,
            "prompt": [int(t) for t in req.prompt],
            "max_new": int(req.max_new),
            "eos_id": req.eos_id,
            "temperature": float(req.temperature),
            "seed": req.seed,
            "ttft_deadline_ms": req.ttft_deadline_ms,
            "tpot_deadline_ms": req.tpot_deadline_ms,
            "ntok_base": int(req.ntok_base)}


def decode_request(d: Dict[str, Any]) -> Request:
    """Inverse of :func:`encode_request` (follower-side)."""
    return Request(rid=d["rid"],
                   prompt=np.asarray(d["prompt"], np.int32),
                   max_new=d["max_new"], eos_id=d.get("eos_id"),
                   temperature=d.get("temperature", 0.0),
                   seed=d.get("seed"),
                   ttft_deadline_ms=d.get("ttft_deadline_ms"),
                   tpot_deadline_ms=d.get("tpot_deadline_ms"),
                   ntok_base=int(d.get("ntok_base", 0)))


@dataclass
class StepPlan:
    """One scheduler step's broadcastable decisions (the whole
    control-plane wire format, JAX's byte for byte).

    ``winner`` — registry step of a newly found tournament winner (None:
    no swap this step); ``admits`` — rids admitted, in order; ``submits``
    — wire-encoded requests that entered rank 0's queue since the last
    step (followers enqueue them verbatim); ``cancels`` — ``[rid,
    reason]`` pairs applied before admission (client cancels and deadline
    sheds, clock-driven rank-0 decisions); ``stop`` — the coordinated
    shutdown; ``promote`` — the arena member rank 0's match evaluation
    promoted this step (None: none), applied before the admissions.
    """

    winner: Optional[int] = None
    admits: List[Any] = field(default_factory=list)
    submits: List[Dict[str, Any]] = field(default_factory=list)
    cancels: List[List[Any]] = field(default_factory=list)
    stop: bool = False
    promote: Optional[str] = None

    def encode(self) -> bytes:
        """Serialize to the JSON wire format (bytes)."""
        return json.dumps({"winner": self.winner,
                           "admits": list(self.admits),
                           "submits": list(self.submits),
                           "cancels": [list(c) for c in self.cancels],
                           "stop": self.stop,
                           "promote": self.promote}).encode()

    @classmethod
    def decode(cls, payload: bytes) -> "StepPlan":
        """Parse the JSON wire format (plans from writers without the
        submit/cancel/stop/promote fields included)."""
        d = json.loads(payload.decode())
        return cls(winner=d["winner"], admits=d["admits"],
                   submits=d.get("submits", []),
                   cancels=d.get("cancels", []),
                   stop=d.get("stop", False),
                   promote=d.get("promote"))


# ---------------------------------------------------------------------------
# plan transports
# ---------------------------------------------------------------------------


class PlanChannel:
    """Rank 0 -> every rank transport of :class:`StepPlan` bytes.

    ``broadcast(plan)`` takes the decided plan on rank 0 and ``None`` on
    followers; every rank receives the plan rank 0 sent, round-tripped
    through its encoding.  ``gather(payload)`` sends every rank's stats
    bytes to rank 0.  ``rank`` is this process's place; ``retries``
    counts transient retries before a success (the ``plan_retries``
    counter; no port transport retries, so it stays 0).
    """

    rank: int = 0
    retries: int = 0

    def broadcast(self, plan: Optional[StepPlan]) -> StepPlan:
        """Send (rank 0) / receive (followers) one plan; blocking."""
        raise NotImplementedError

    def gather(self, payload: bytes) -> Optional[List[bytes]]:
        """Every rank's payload, in rank order, on rank 0; ``None`` on the
        followers.  Symmetric, like a collective: every rank calls it once
        an exchange."""
        raise NotImplementedError

    def close(self) -> None:
        """Release the transport's resources (idempotent)."""


class LoopbackChannel(PlanChannel):
    """One-process transport: the plan round-trips its wire encoding, so
    the format runs on every step."""

    def broadcast(self, plan: Optional[StepPlan]) -> StepPlan:
        """Encode + decode the plan in-process (rank 0 only)."""
        if plan is None:
            raise RuntimeError(
                "LoopbackChannel has no peer to receive from "
                "(follower replay passes the plan explicitly)")
        return StepPlan.decode(plan.encode())

    def gather(self, payload: bytes) -> Optional[List[bytes]]:
        """Rank 0 is the only rank: its own payload."""
        return [bytes(payload)]


class ProcessGroupChannel(PlanChannel):
    """Transport over ``torch.distributed``: a gloo process group made for
    it (every rank constructs it, in the same order), whatever the
    default group's backend; ``broadcast_object_list`` from rank 0 and
    ``gather_object`` to it.  Each call waits at most ``timeout_s`` (the
    group's timeout), so a dead or stalled peer raises ``RuntimeError``
    naming the step instead of hanging.  ``timing`` sums the calls' host
    seconds (waiting for the peers included) and counts them."""

    def __init__(self, timeout_s: float = 60.0):
        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessGroupChannel needs torch.distributed initialised "
                "(repro_torch.launch.mesh.init_ranks)")
        self.timeout_s = float(timeout_s)
        self.group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self._seq = 0
        self._gseq = 0
        self._closed = False
        self.timing = {"broadcasts": 0, "broadcast_s": 0.0, "gathers": 0,
                       "gather_s": 0.0}

    def _fail(self, what: str, e: Exception) -> RuntimeError:
        return RuntimeError(
            f"{what} failed or timed out (limit {self.timeout_s} s) — a "
            f"peer process likely died ({type(e).__name__}: {e})")

    def broadcast(self, plan: Optional[StepPlan]) -> StepPlan:
        """Rank 0 sends ``plan`` (an empty one when None), the followers
        receive it."""
        box = [(plan or StepPlan()).encode() if self.rank == 0 else None]
        t0 = time.perf_counter()
        try:
            dist.broadcast_object_list(box, src=0, group=self.group)
        except Exception as e:          # gloo: closed peer or timeout
            raise self._fail(f"plan broadcast for step {self._seq}",
                             e) from e
        self.timing["broadcast_s"] += time.perf_counter() - t0
        self.timing["broadcasts"] += 1
        self._seq += 1
        return StepPlan.decode(box[0])

    def gather(self, payload: bytes) -> Optional[List[bytes]]:
        """Every rank's payload on rank 0, ``None`` elsewhere."""
        out = [None] * self.world if self.rank == 0 else None
        t0 = time.perf_counter()
        try:
            dist.gather_object(bytes(payload), out, dst=0, group=self.group)
        except Exception as e:
            raise self._fail(f"stats gather {self._gseq}", e) from e
        self.timing["gather_s"] += time.perf_counter() - t0
        self.timing["gathers"] += 1
        self._gseq += 1
        return out

    def close(self) -> None:
        """Destroy the channel's group (once)."""
        if not self._closed:
            self._closed = True
            dist.destroy_process_group(self.group)


def make_plan_channel(timeout_s: float = 60.0) -> PlanChannel:
    """The plan transport for this process: loopback with one rank, the
    process-group channel across several."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return ProcessGroupChannel(timeout_s=timeout_s)
    return LoopbackChannel()


def make_engine_session(cfg: ModelConfig, model: lm.LM, mesh: ServeMesh,
                        batch: int, max_len: int) -> MeshDecodeSession:
    """A mesh session over dense slot rows for the batch
    :class:`~repro_torch.serve.engine.Engine`; ``batch`` must divide
    into the ``data`` shards."""
    if batch % mesh.data:
        raise ValueError(
            f"engine batch {batch} must be divisible by the mesh data "
            f"axis ({mesh.data})")
    model = mesh_model(model, mesh)
    rows = plan_shards(cfg, mesh).rank_cfg if mesh.model > 1 else cfg
    return MeshDecodeSession(cfg, model, SlotLayout(
        rows, batch, max_len, device=model.device))


# ---------------------------------------------------------------------------
# the mesh scheduler
# ---------------------------------------------------------------------------


class MeshScheduler(Scheduler):
    """Continuous-batching scheduler over a serving mesh (JAX's
    ``MeshScheduler``).

    Every scheduling rule is :class:`Scheduler`'s, with three mesh
    specifics:

    * **geometry** — ``num_slots`` and ``num_blocks`` round up to
      multiples of ``data``; a request's pages live wholly in its slot's
      shard, so its cap is the shard's capacity, not the pool's;
    * **decisions** — :meth:`step` decides a :class:`StepPlan` on rank 0
      and routes it through ``channel``; a follower replays it with
      ``step(plan=...)`` (or receives it from the channel) and lands in
      an identical state, any divergence raising;
    * **dispatch** — every session is a
      :class:`~repro_torch.serve.session.MeshDecodeSession`; the ragged
      width-split subset dispatch is off (a subset of rows would leave
      its shards).

    ``model`` is the replica's :class:`~repro_torch.models.lm.LM` (the
    full weights, or this rank's shard); ``mesh`` a :class:`ServeMesh`
    (or ``mesh_shape`` its sizes; default one shard).  With ``model`` >
    1 every rank of the job builds its shard (:func:`mesh_model`) and
    pools of its kv heads; every rank replays rank 0's plan, and the
    gathered logits keep the model ranks' streams identical, which the
    stats exchange asserts (a digest of every token a rank accepted).
    ``stats_every`` N: every N steps each rank ships a
    :func:`~repro_torch.serve.telemetry.stats_snapshot` to rank 0
    (``remote_stats``); it must be the same on every rank (0: never).
    The other keywords are :class:`Scheduler`'s.
    """

    def __init__(self, cfg: ModelConfig, model: lm.LM, *,
                 mesh: Optional[ServeMesh] = None,
                 mesh_shape: Optional[Tuple[int, int]] = None,
                 channel: Optional[PlanChannel] = None,
                 step_timeout_s: float = 60.0,
                 stats_every: int = 1, **kwargs):
        if mesh is None:
            mesh = ServeMesh(*(mesh_shape or (1, 1)))
        self.mesh = mesh
        self.channel = channel if channel is not None \
            else make_plan_channel(timeout_s=step_timeout_s)
        self.stats_every = max(0, int(stats_every))
        # rank-0 decisions waiting for the next step's plan
        self._pending_submits: List[Dict[str, Any]] = []
        self._pending_cancels: List[Tuple[Any, str]] = []
        if mesh.model > 1 and kwargs.get("draft_params") is not None:
            raise NotImplementedError(
                f"speculative decoding on a serving mesh with model="
                f"{mesh.model} (the drafter's sessions over the model "
                "ranks) is not ported to repro_torch yet; see ROADMAP.md "
                "queue A18")
        model = mesh_model(model, mesh, timeout_s=step_timeout_s)
        # the pools hold this rank's kv heads (None: the whole config's)
        self._rank_cfg = plan_shards(cfg, mesh).rank_cfg \
            if mesh.model > 1 else None
        # crc32 over every (rid, token) this rank accepted, in order
        self._digest = 0
        self.data_shards = mesh.data
        D = self.data_shards
        num_slots = kwargs.get("num_slots", 8)
        kwargs["num_slots"] = -(-num_slots // D) * D
        max_len = kwargs.get("max_len", 1024)
        block_size = kwargs.get("block_size", 16)
        n_blocks = kwargs.get("num_blocks")
        if n_blocks is None:
            n_blocks = kwargs["num_slots"] * blocks_for(max_len, block_size)
        kwargs["num_blocks"] = -(-n_blocks // D) * D
        super().__init__(cfg, model, **kwargs)
        # the subset dispatch cannot keep rows in their shard's partition
        self._group_decode = False

    # -- construction hooks --------------------------------------------------
    def _make_layout(self, cfg: ModelConfig):
        if cfg is self.cfg and self._rank_cfg is not None:
            cfg = self._rank_cfg
        g = self._geom
        if self.paged:
            return PagedLayout(cfg, g["num_slots"], g["n_blocks"],
                               block_size=g["block_size"],
                               max_seq=g["max_seq"],
                               pin_prefix=g["pin_prefix"],
                               data_shards=self.data_shards,
                               device=self.device)
        return SlotLayout(cfg, g["num_slots"], g["max_len"],
                          block_size=g["block_size"],
                          num_blocks=g["n_blocks"], device=self.device)

    def _make_session(self, cfg: ModelConfig, model: lm.LM,
                      layout) -> DecodeSession:
        return MeshDecodeSession(cfg, model, layout)

    # -- admission (shard-aligned drafter) -----------------------------------
    def _can_admit_head(self) -> bool:
        if not super()._can_admit_head():
            return False
        if not self.paged or self.draft is None or self.data_shards == 1:
            return True
        req = self.queue[0]
        total = req.prompt_len + req.max_new
        head = self._head_share
        shared = head[1][0] if head is not None and head[0] == req.rid \
            else ()
        shard = self.pool.peek_shard(total, shared)
        if shard is None:
            return False
        # the drafter's mirror admit lands at the same slot, hence the
        # same shard: its capacity must hold there, not just anywhere
        return self.draft.layout.shards[shard].blocks.can_allocate(total)

    # -- rank-0 intake (recorded for the next plan) --------------------------
    def submit(self, req: Request) -> None:
        """Enqueue a request and record its wire encoding for the next
        plan, so followers that never saw it (a gateway's requests reach
        rank 0 only) enqueue an identical copy before the admissions."""
        super().submit(req)
        self._pending_submits.append(encode_request(req))

    def cancel(self, rid) -> bool:
        """Cancel ``rid`` at the next :meth:`step` (rank 0), at the same
        point of the step on every rank (the plan's ``cancels``).  True if
        the rid is live now; a no-op if it finishes first."""
        if rid not in self.active and rid not in self.prefilling and \
                not any(q.rid == rid for q in self.queue):
            return False
        self._pending_cancels.append((rid, "cancel"))
        return True

    def shed_expired(self) -> List[Any]:
        """Rank 0's TTFT-deadline shedding: the clock is read here only;
        the shed rids ride the next plan's ``cancels`` so followers drop
        the same queued requests.  Returns the rids shed."""
        now = time.perf_counter()
        pending = {rid for rid, _ in self._pending_cancels}
        shed = [q.rid for q in self.queue
                if q.rid not in pending
                and q.ttft_deadline_ms is not None
                and (now - getattr(q, "_submit_t", now)) * 1e3
                > q.ttft_deadline_ms]
        self._pending_cancels.extend((rid, "deadline") for rid in shed)
        return shed

    # -- rank-0 plan / broadcast / replay ------------------------------------
    def step(self, plan: Optional[StepPlan] = None) -> StepPlan:
        """One scheduler iteration; returns the plan it executed.

        ``plan=None`` on rank 0: poll, decide and broadcast (the plan
        always round-trips its wire encoding).  ``plan=None`` on a
        follower: receive rank 0's plan from the channel (blocking, within
        its timeout).  ``plan=...``: replay rank 0's decisions verbatim,
        then run the same phases.  ``plan.stop``: rank 0 shut down and
        no phase ran.
        """
        self.stats.start()
        self.telemetry.step_begin(self._step_count + 1)
        if self.faults is not None:
            self.faults.on_step(self, self._step_count + 1)
        if plan is None and self.channel.rank == 0:
            winner = self._poll_registry()
            self._step_count += 1
            self._apply_swap(winner)
            self._arena_rotate()
            promote = self._arena_decide()
            self._arena_apply(promote)
            submits = list(self._pending_submits)
            self._pending_submits.clear()
            cancels = [[rid, reason] for rid, reason
                       in self._pending_cancels
                       if self._cancel_now(rid, reason)]
            self._pending_cancels.clear()
            admits = self._admission_phase()
            plan = self.channel.broadcast(StepPlan(
                winner=winner, admits=admits, submits=submits,
                cancels=cancels, promote=promote))
        else:
            if plan is None:
                plan = self.channel.broadcast(None)
            if plan.stop:
                # balance step_begin (closes an armed profiler window)
                self.telemetry.step_end()
                return plan
            self._step_count += 1
            if plan.winner is not None and self.registry is not None:
                self.registry.load_step(plan.winner)
                self._apply_swap(plan.winner)
            else:
                # nothing to swap to, but a pending drain may land
                self._apply_swap(None)
            # arena: the rotation is a pure function of replicated state;
            # the promotion is rank 0's, replayed verbatim
            self._arena_rotate()
            self._arena_apply(plan.promote)
            self._apply_submits(plan.submits)
            for rid, reason in plan.cancels:
                self._cancel_now(rid, reason)
            self._replay_admissions(plan.admits)
        tel = self.telemetry
        had_pf = bool(self._pending_draft or self._pending_onepass
                      or self.prefilling)
        t0 = time.perf_counter()
        self._prefill_phase()
        t1 = time.perf_counter()
        tel.phase("prefill", t0, t1, emit=had_pf)
        had_dec = bool(self.active)
        self._decode_phase()
        tel.phase("decode", t1, time.perf_counter(), emit=had_dec)
        self._exchange_stats()
        self.stats.sample_step(len(self.queue),
                               len(self.active) + len(self.prefilling))
        self.stats.plan_retries = getattr(self.channel, "retries", 0)
        self._journal_step()
        tel.step_end()
        return plan

    def _exchange_stats(self) -> None:
        """Every ``stats_every`` steps every rank ships its stats snapshot
        to rank 0 through the channel's gather, and rank 0 keeps the
        latest one a rank in ``remote_stats`` (the per-rank Prometheus
        series).  All ranks or none: the gather is a collective."""
        if not self.stats_every or self._step_count % self.stats_every:
            return
        snap = stats_snapshot(self, rank=self.channel.rank)
        snap["state_digest"] = self._digest
        got = self.channel.gather(json.dumps(snap).encode())
        if got is not None:
            snaps = [json.loads(p.decode()) for p in got]
            digests = {int(s["rank"]): s.pop("state_digest") for s in snaps}
            parted = sorted(r for r, d in digests.items()
                            if d != self._digest)
            if parted:
                raise RuntimeError(
                    f"rank(s) {parted} accepted other tokens than rank 0 by "
                    f"step {self._step_count}: the replicas' states "
                    "diverged")
            self.remote_stats = {int(s["rank"]): s for s in snaps}

    def _accept_token(self, act, tok: int) -> None:
        self._digest = zlib.crc32(f"{act.req.rid!r}:{int(tok)};".encode(),
                                  self._digest)
        super()._accept_token(act, tok)

    def shutdown(self) -> StepPlan:
        """Rank 0: broadcast the stop plan and close the channel; the
        followers leave :meth:`run_follower` at the same step."""
        plan = self.channel.broadcast(StepPlan(stop=True))
        self.stats.stop()
        self.channel.close()
        return plan

    def run_follower(self) -> Dict[Any, np.ndarray]:
        """A follower's serve loop: replay rank 0's plans until its stop
        plan (a dead rank 0 raises from the channel instead of hanging).
        Returns the replica's results, equal to rank 0's."""
        while True:
            plan = self.step()
            if plan.stop:
                break
        self.stats.stop()
        self.channel.close()
        return self.results

    def _apply_submits(self, submits: List[Dict[str, Any]]) -> None:
        """Enqueue rank 0's new requests on a follower.  Requests this
        process holds already (a replicated feed, or rank 0's replica
        replaying its own plan) are known by rid and skipped; the
        ``max_queue`` check, ruled on by rank 0 at its intake, is off for
        the replay (the batched queue depth could diverge)."""
        self._pending_submits.clear()
        known = {q.rid for q in self.queue}
        saved, self.max_queue = self.max_queue, None
        try:
            for d in submits:
                rid = d["rid"]
                if rid in known or rid in self.active \
                        or rid in self.prefilling or rid in self.results:
                    continue
                Scheduler.submit(self, decode_request(d))
        finally:
            self.max_queue = saved

    def _replay_admissions(self, admits: List[Any]) -> None:
        """Apply rank 0's admissions on a follower: the local queue's head
        must be each rid in turn and local accounting must accept it; any
        divergence raises rather than drift."""
        for rid in admits:
            if not self.queue or self.queue[0].rid != rid:
                raise RuntimeError(
                    f"follower queue diverged from rank 0: expected "
                    f"{rid!r} at the head, have "
                    f"{self.queue[0].rid if self.queue else None!r}")
            if not self._can_admit_head():
                raise RuntimeError(
                    f"follower cannot admit {rid!r}: scheduler state "
                    "diverged from rank 0")
            self._admit(self.queue.popleft())
