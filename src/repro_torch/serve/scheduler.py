"""Continuous-batching LM serving scheduler of the port.

The counterpart of ``repro.serve.scheduler.Scheduler`` for both cache
layouts -- paged (:class:`~repro_torch.serve.kv_cache.PagedLayout`, the
default) and the dense slot rows kept as the serving benchmark's baseline
(``layout="dense"``, :class:`~repro_torch.serve.kv_cache.SlotLayout`) --
and every token-input family: dense, moe, audio, hybrid (jamba) and ssm
(xLSTM); a vlm is refused, as in JAX (its prompts would be embeddings).
Every model call goes through a
:class:`~repro_torch.serve.session.DecodeSession`.  Per scheduler step:

  1. *admission* — pop queued requests while a slot AND a full
     token-budget page reservation (prompt + max new tokens) are
     available.  A prompt whose prefix is already resident (another
     request's registered prompt pages) maps those pages read-only into
     its block table and skips their prefill (copy-on-admit prefix
     sharing; ``pin_prefix=True`` keeps registered pages resident across
     idle periods).  ``policy="static"`` admits only into an empty batch.
  2. *prefill* — one ``prefill_chunk``-token slice per step and
     prefilling request (``prefill_chunk=0``: the whole prompt, padded to
     a pow2 bucket), interleaved with decode.  A stack with any recurrent
     (Mamba / xLSTM) layer instead prefills each admitted prompt in one
     shot at its exact length, and shares no prefixes: padding would feed
     its state extra steps, a shared prefix would skip them, and the state
     cannot resume mid-prompt.  On dense rows every prompt is prefilled in
     one shot when admitted, padded to its pow2 bucket (attention-only
     stacks) or at its exact length, and no prefix is shared.
  3. *decode* — one batched ``session.step`` over every slot (an idle
     row decodes at index -1 on paged pools, writing the null page, and
     at index 0 on dense rows, its own); each row's next token is sampled
     on the host.  On the CPU (the plain-version gather pays each row's
     full table width) a paged round whose one long row is >= 4x wider
     than every other row splits into (narrow, wide) groups; on the card
     the paged-attention kernel skips each row's unused pages by itself,
     so the round stays one dispatch.  With a
     drafter (``draft_params`` + ``spec_tokens`` K) each round is
     **population speculative decoding** instead: the drafter (an
     earlier or smaller LTFB checkpoint, in its own pool at the same
     slots) proposes up to K tokens a row, the target verifies them all
     in one (K+1)-token ``session.step``, each row keeps its longest
     matching prefix plus one target token, and a row that kept fewer
     tokens than it fed rolls its recurrent state back
     (``session.restore`` + a ``valid``-masked replay).
  4. *completion* — requests hitting EOS or their token budget free their
     slot and page refs immediately.

Before admission, every ``watch_every`` steps, an attached
:class:`repro_torch.serve.registry.ModelRegistry` is polled for a newer
tournament winner.  ``swap_mode="immediate"`` loads it between steps
(in-flight caches stay valid: their layout depends only on the config);
``swap_mode="drain"`` holds it, stops admitting, lets every in-flight
request finish on the old weights, then swaps.  Either way the prefix
cache is flushed, so no request admitted after a swap maps a page written
before it.

Sampling stays on the host exactly as in the JAX package: greedy argmax,
or a Gumbel draw from ``default_rng([seed, ntok])`` at temperature > 0,
so both packages emit the same tokens for the same logits -- and a
speculative run emits the target-only tokens at any temperature, since
every emitted token is sampled from the target's logits.

Telemetry as in JAX (``telemetry=True``, the default): every request
leaves a span chain on its own trace row (``enqueue`` → ``queued`` →
``admit`` → ``prefill`` / ``prefill_chunk`` → ``first_token`` →
``finish``), every step's host wall time is split into ``admit`` /
``prefill`` / ``decode`` phases (``draft`` / ``verify`` inside a
speculative round), a hot swap is an event and a JSON-log record, and
:meth:`Scheduler.profile_steps` arms ``torch.profiler`` around a window
of steps (:class:`~repro_torch.serve.telemetry.ServeTelemetry`).
``telemetry=False`` keeps the counters and phase times and drops the
spans.

The request lifecycle, as in JAX: ``max_queue`` bounds the queue (an
over-bound :meth:`Scheduler.submit` raises :class:`Overloaded`, the
gateway's HTTP 429), a request may declare TTFT / TPOT deadlines
(:meth:`Scheduler.shed_expired` drops a queued request whose TTFT
deadline has passed; a completion that missed one is counted), and
:meth:`Scheduler.cancel` drops a request wherever it is, freeing its
slot, its pages (a shared prefix page loses one reference) and its
drafter rows.  An optional ``journal``
(:class:`repro_torch.serve.journal.RequestJournal`) records every
submit, token, completion and cancel (one write a step), from which a
fresh scheduler resumes every unfinished request token-identically
(``ntok_base`` offsets the sampler's rng stream), and optional
``faults`` (:class:`repro_torch.serve.faults.FaultInjector`) fire
scripted faults at exact steps.

The online LTFB arena (``arena``, :class:`repro_torch.serve.arena.Arena`)
runs the tournament on the serving traffic, as in JAX: the champion's
weights serve in the target model, one challenger at a time drafts in
the drafter model (rotated per the arena's policy at the top of each
step), every speculative row-round scores the drafting challenger, and
every ``check_every`` steps a match is evaluated, journaled and, when
the promotion rule fires, archived through the registry and journaled
again before the target swaps to the winner (drain-aware with
``swap_mode="drain"``).  Rotations and promotions copy a member's state
dict into the models (:meth:`DecodeSession.set_params`); the drafter
never shares the target's model in an arena.
"""
from __future__ import annotations

import copy
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import MAX_ROWS
from repro_torch.models import lm
from repro_torch.serve.kv_cache import PagedLayout, SlotLayout, blocks_for
from repro_torch.serve.metrics import ServeStats
from repro_torch.serve.registry import check_draft_compat
from repro_torch.serve.session import DecodeSession
from repro_torch.serve.telemetry import ServeTelemetry, log_event

# profiler ranges of a speculative round: a profile splits its device time
# between the drafter, the target's verify and the rollback (snapshots,
# restores and replays)
SPEC_RANGES = ("draft", "verify", "rollback")


class Overloaded(RuntimeError):
    """Raised by :meth:`Scheduler.submit` when the request queue is at
    its ``max_queue`` bound — the load-shedding signal the gateway maps
    to HTTP 429 instead of queueing without bound."""


@dataclass
class Request:
    """One generation request.

    ``prompt`` is a (P,) int32 token-id array; ``max_new`` bounds the
    generated tokens; ``temperature > 0`` requires ``seed`` (sampling is
    host-side and deterministic in ``(seed, ntok)``).  The optional
    deadlines are SLOs in milliseconds: a queued request whose
    ``ttft_deadline_ms`` has passed is shed by
    :meth:`Scheduler.shed_expired`, and a completion that missed its TTFT
    or TPOT deadline is counted.  ``ntok_base`` offsets the sampler's rng
    stream: a journal resume submits a request with ``k`` emitted tokens
    folded into its prompt and ``ntok_base=k``, so its first sample draws
    ``rng([seed, k])``, as the uninterrupted run did.  ``idem_key``
    carries the gateway's ``Idempotency-Key`` into the journal.
    """

    rid: Any
    prompt: np.ndarray              # (P,) int32 token ids
    max_new: int
    eos_id: Optional[int] = None
    temperature: float = 0.0
    seed: Optional[int] = None
    ttft_deadline_ms: Optional[float] = None   # first token due (ms)
    tpot_deadline_ms: Optional[float] = None   # mean ms/token budget
    ntok_base: int = 0              # rng-stream offset (journal resume)
    idem_key: Optional[str] = None  # gateway Idempotency-Key, journaled

    @property
    def prompt_len(self) -> int:
        """Prompt length P in tokens."""
        return int(len(self.prompt))


@dataclass
class _Active:
    req: Request
    slot: int
    ntok: int = 0                   # tokens generated so far
    pf_pos: int = 0                 # prompt tokens prefilled so far
    tokens: List[int] = field(default_factory=list)
    submit_t: float = 0.0
    first_token_t: Optional[float] = None


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class Scheduler:
    """Continuous-batching scheduler over a paged KV-cache pool, or over
    dense slot rows with ``layout="dense"`` (``max_len`` tokens a row;
    ``max_seq``, if given, must equal it).

    ``model`` is a :class:`repro_torch.models.lm.LM` on ``device`` (the
    card unless ``device="cpu"``; without a card the default raises).
    ``registry`` (polled every ``watch_every`` steps) hands over weights
    in the port's layout (its ``from_ckpt`` hook), which ``set_params``
    copies into ``model``.

    ``draft_params`` (the drafter: an :class:`~repro_torch.models.lm.LM`
    on ``device``, the target's own model for a self drafter) with
    ``spec_tokens`` K > 0 turns every decode round
    into a speculative one; ``draft_cfg`` is the drafter's config when it
    is another arch (its vocab must equal the target's), ``spec_fused``
    drafts a round in one fused call (else K+1 single steps) and
    ``spec_adapt`` adapts each row's depth within [1, K].  On the card
    a paged verify's K+1 query tokens times the target's query heads per
    KV head must fit the paged kernel's ``MAX_ROWS`` (a dense verify runs
    no kernel).

    ``telemetry`` turns the trace spans on (the default) or off;
    ``trace_capacity`` bounds the trace's ring of events.

    ``max_queue`` bounds the request queue (None: unbounded);
    ``journal`` is a :class:`~repro_torch.serve.journal.RequestJournal`
    to record the lifecycle in, ``faults`` a
    :class:`~repro_torch.serve.faults.FaultInjector` fired at the top of
    every step.

    ``arena`` (an :class:`~repro_torch.serve.arena.Arena`) needs a
    drafter model other than ``model`` and ``spec_tokens > 0``; the
    champion's and the active challenger's weights are loaded into the
    two models here, whatever they held.
    """

    _SPLIT_RATIO = 4

    def __init__(self, cfg: ModelConfig, model: lm.LM, num_slots: int = 8,
                 max_len: int = 1024, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 max_seq: Optional[int] = None,
                 layout: str = "paged",
                 policy: str = "continuous",
                 prefill_chunk: int = 0,
                 prefix_sharing: bool = True,
                 pin_prefix: bool = False,
                 max_prefills_per_step: int = 1,
                 min_prefill_bucket: int = 8,
                 registry=None, watch_every: int = 0,
                 swap_mode: str = "immediate",
                 draft_params=None, spec_tokens: int = 0,
                 draft_cfg: Optional[ModelConfig] = None,
                 spec_fused: bool = True, spec_adapt: bool = False,
                 max_queue: Optional[int] = None,
                 telemetry: bool = True, trace_capacity: int = 8192,
                 journal=None, faults=None, arena=None,
                 device="cuda", **unknown):
        self.device = resolve_device(device)
        if unknown:
            raise TypeError(f"unexpected arguments {sorted(unknown)}")
        if layout not in ("paged", "dense"):
            raise ValueError(f"unknown layout {layout!r}")
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {policy!r}")
        if swap_mode not in ("immediate", "drain"):
            raise ValueError(f"unknown swap_mode {swap_mode!r}")
        if cfg.family == "vlm":
            raise ValueError(
                "serving scheduler supports token-input families only "
                "(vlm prompts need precomputed embeddings)")
        lm.layer_specs(cfg)             # raises for a non-LM config
        if spec_tokens > 0 and draft_params is None:
            raise ValueError("spec_tokens > 0 needs draft_params "
                             "(the population drafter)")
        self.spec_tokens = int(spec_tokens) if draft_params is not None \
            else 0
        self.spec_fused = bool(spec_fused)
        self.spec_adapt = bool(spec_adapt)
        self.max_queue = max_queue if max_queue is None else int(max_queue)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        # the drafter may be another (smaller) arch: its token ids index
        # the target's embedding, so the vocabs must agree
        self.draft_cfg = draft_cfg if draft_cfg is not None else cfg
        if draft_params is not None and self.draft_cfg is not cfg:
            check_draft_compat(cfg, self.draft_cfg)
        if self.device.type == "cuda" and self.spec_tokens > 0 \
                and layout == "paged":
            for c in (cfg, self.draft_cfg):
                self._check_verify_rows(c)
        self.cfg = cfg
        self.policy = policy
        self.paged = layout == "paged"
        if max_seq is not None and max_seq != max_len and not self.paged:
            raise ValueError("layout='dense' caps requests at max_len")
        self.prefill_chunk = int(prefill_chunk)
        self.max_prefills_per_step = max_prefills_per_step
        self.min_prefill_bucket = min_prefill_bucket
        self.registry = registry
        self.watch_every = watch_every
        self.swap_mode = swap_mode
        n_blocks = num_blocks if num_blocks is not None \
            else num_slots * blocks_for(max_len, block_size)
        # the geometry the layout hook reads (the mesh scheduler's sharded
        # pools reuse it)
        self._geom = {"num_slots": num_slots, "max_len": max_len,
                      "block_size": block_size, "n_blocks": n_blocks,
                      "max_seq": max_seq or max_len,
                      "pin_prefix": pin_prefix}
        self.pool = self._make_layout(cfg)
        self.max_seq = self.pool.max_seq if self.paged else max_len
        self.session = self._make_session(cfg, model, self.pool)
        # the drafter: a second session over its own pool of the same
        # geometry, admitted at the same slots (the batches stay aligned)
        self.draft: Optional[DecodeSession] = None
        if draft_params is not None:
            if not isinstance(draft_params, lm.LM):
                raise TypeError("draft_params must be the drafter's LM "
                                f"(got {type(draft_params).__name__})")
            self.draft = self._make_session(
                self.draft_cfg, draft_params,
                self._make_layout(self.draft_cfg))
        # right-padding and chunking prompts is only sound for
        # attention-only stacks: recurrent layers prefill one-shot at the
        # exact prompt length, with no prefix sharing (as in JAX);
        # chunking and prefix sharing need the paged pools
        self._can_pad = not self.pool.has_recurrent
        self._draft_can_pad = self.draft is not None \
            and not self.draft.layout.has_recurrent
        self._chunked = self.paged and self._can_pad
        self.prefix_sharing = bool(prefix_sharing) and self._chunked
        # ragged gather-width grouping pays only for the plain version on
        # the CPU (the CUDA kernel skips each row's unused pages itself),
        # and needs paged pools with no per-slot rows
        self._group_decode = self.device.type == "cpu" and self._chunked
        self.queue: deque[Request] = deque()
        self.active: Dict[Any, _Active] = {}
        self.prefilling: Dict[Any, _Active] = {}
        # one-shot prefills admitted this step, run after admission
        self._pending_onepass: List[_Active] = []
        self._pending_draft: List[Request] = []
        self._by_slot: Dict[int, _Active] = {}
        self._next_token = np.zeros((num_slots,), np.int32)
        # the index an idle row decodes at: -1 on paged pools (its KV
        # writes go to the null page), 0 on dense rows (the row is the
        # slot's own, so its writes are harmless)
        self._idle_index = -1 if self.paged else 0
        self._index = np.full((num_slots,), self._idle_index, np.int32)
        # per-row speculative depth (spec_adapt): proposals offered next
        # round to the request in each slot, within [1, spec_tokens]
        self._spec_k = np.full((num_slots,), max(self.spec_tokens, 1),
                               np.int32)
        self.spec_k_by_rid: Dict[Any, int] = {}
        self.results: Dict[Any, np.ndarray] = {}
        self.stats = ServeStats(slots=num_slots)
        # request tracing + phase attribution + profiler window;
        # telemetry=False keeps the counters but drops the spans
        self.telemetry = ServeTelemetry(enabled=telemetry,
                                        trace_capacity=trace_capacity)
        # rank -> the latest stats snapshot of every mesh rank (rank 0's
        # mesh scheduler gathers them); {} on a single process
        self.remote_stats: Dict[int, dict] = {}
        # fault tolerance: the write-ahead journal (one write a step, the
        # step's tokens and completions buffered below) and the injector
        # fired at the top of each step
        self.journal = journal
        self.faults = faults
        # online LTFB: the resident population roster and its tournament
        # (serve/arena.py); drives the drafter's rotation and the
        # champion's promotions from inside step()
        self.arena = arena
        if arena is not None:
            if self.draft is None or self.spec_tokens <= 0:
                raise ValueError(
                    "an online-LTFB arena scores challengers through the "
                    "speculative path: pass draft_params (the active "
                    "challenger's weights) and spec_tokens > 0")
            if self.draft.model is self.session.model:
                raise ValueError(
                    "an arena's drafter must be a model of its own: "
                    "rotations load challengers into it while the "
                    "champion serves from the target model")
            self.session.set_params(arena.champion_params)
            self.draft.set_params(arena.drafter_params)
        self._journal_tokens: Dict[Any, List[int]] = {}
        self._journal_finished: List[Any] = []
        self._pending_params = None
        self._head_share = None
        self._step_count = 0

    # -- construction hooks (the mesh scheduler overrides them) -------------
    def _make_layout(self, cfg: ModelConfig):
        """A pool of this scheduler's geometry for ``cfg``: the target's,
        or the drafter's mirror at the same slots."""
        g = self._geom
        if self.paged:
            return PagedLayout(cfg, g["num_slots"], g["n_blocks"],
                               block_size=g["block_size"],
                               max_seq=g["max_seq"],
                               pin_prefix=g["pin_prefix"],
                               device=self.device)
        return SlotLayout(cfg, g["num_slots"], g["max_len"],
                          block_size=g["block_size"],
                          num_blocks=g["n_blocks"], device=self.device)

    def _make_session(self, cfg: ModelConfig, model: lm.LM,
                      layout) -> DecodeSession:
        """The session over ``layout`` (the target's or the drafter's)."""
        return DecodeSession(cfg, model, layout)

    def _check_verify_rows(self, cfg: ModelConfig) -> None:
        """On the card a verify (and a replay, on either model) runs the
        paged kernel with K+1 query tokens a row: (K+1) times the query
        heads per KV head must fit its ``MAX_ROWS`` accumulator rows.
        Raise with both numbers rather than serve some other way."""
        if not any(s.kind == "a" for s in lm.layer_specs(cfg)):
            return
        g = cfg.num_heads // cfg.num_kv_heads
        rows = (self.spec_tokens + 1) * g
        if rows > MAX_ROWS:
            raise ValueError(
                f"spec_tokens={self.spec_tokens}: a verify of "
                f"{self.spec_tokens + 1} tokens at {g} query heads per KV "
                f"head of {cfg.name} needs {rows} accumulator rows of the "
                f"paged-attention kernel, which takes at most {MAX_ROWS}; "
                f"use spec_tokens <= {MAX_ROWS // g - 1}")

    # -- request intake ----------------------------------------------------
    def _reject(self, msg: str):
        self.stats.rejected += 1
        raise ValueError(msg)

    def submit(self, req: Request) -> None:
        """Validate + enqueue a request (host-side only, non-blocking).

        Raises :class:`Overloaded` when the queue is at ``max_queue``
        (counted as ``shed_overload``; the caller should shed or back
        off) and ``ValueError`` for malformed requests (duplicate rid,
        empty prompt, budget over the pool ceiling, missing seed),
        counted as ``rejected``.  An accepted submit is journaled at
        once.  Admission happens inside :meth:`step`.
        """
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.stats.shed_overload += 1
            raise Overloaded(
                f"request queue is at max_queue={self.max_queue}; "
                f"request {req.rid!r} shed (retry with backoff)")
        total = req.prompt_len + req.max_new
        if req.rid in self.active or req.rid in self.prefilling or \
                req.rid in self.results or \
                any(q.rid == req.rid for q in self.queue):
            self._reject(f"duplicate request id {req.rid!r}")
        if req.prompt_len < 1 or req.max_new < 1:
            self._reject("need a non-empty prompt and max_new >= 1")
        if total > self.max_seq:
            self._reject(
                f"request {req.rid!r} needs {total} tokens > the "
                f"per-request cap (max_len/max_seq {self.max_seq})")
        if blocks_for(total, self.pool.blocks.block_size) \
                > self.pool.blocks.num_blocks:
            self._reject(
                f"request {req.rid!r} exceeds the pool's total token "
                "budget")
        if req.temperature > 0.0 and req.seed is None:
            self._reject(
                f"request {req.rid!r}: temperature > 0 requires a seed "
                "(refusing to silently fall back to greedy)")
        self.stats.submitted += 1
        if self.journal is not None:
            self.journal.record_submit(req)
        req._submit_t = time.perf_counter()   # TTFT includes queueing delay
        self.queue.append(req)
        self.telemetry.req_instant(req.rid, "enqueue", t=req._submit_t,
                                   queue_depth=len(self.queue))

    # -- scheduling ---------------------------------------------------------
    def _bucket(self, n: int, cap: Optional[int] = None) -> int:
        cap = cap or self.max_seq
        return min(max(self.min_prefill_bucket, _next_pow2(n)), cap)

    def _can_admit_head(self) -> bool:
        req = self.queue[0]
        total = req.prompt_len + req.max_new
        if not self.pool.free_slots:        # skip prefix hashing when full
            return False
        if self.draft is not None and \
                not self.draft.layout.can_admit(total):
            return False
        if not self.paged:
            return self.pool.can_admit(total)
        self._head_share = None
        shared = ()
        if self.prefix_sharing:
            # cache the match: _admit reuses it instead of re-hashing
            self._head_share = (req.rid,
                                self.pool.find_shared_prefix(req.prompt))
            shared = self._head_share[1][0]
        return self.pool.can_admit(total, shared_pages=shared)

    def _admit(self, req: Request) -> None:
        """Claim slot + pages; the prefill runs in :meth:`_prefill_phase`
        (chunked) or one-shot right after admission."""
        total = req.prompt_len + req.max_new
        now = time.perf_counter()
        self.telemetry.req_span(req.rid, "queued",
                                getattr(req, "_submit_t", None), now)
        if not self.paged:
            slot = self.pool.admit(req.rid, total)
            self._admit_draft(req, slot, total)
            self._spec_k[slot] = max(self.spec_tokens, 1)
            self._pending_onepass.append(_Active(
                req=req, slot=slot, submit_t=getattr(
                    req, "_submit_t", time.perf_counter())))
            self.telemetry.req_instant(req.rid, "admit", t=now, slot=slot)
            return
        head = self._head_share
        shared = head[1] if head is not None and head[0] == req.rid \
            else None
        self._head_share = None
        slot, shared_len = self.pool.admit(
            req.rid, total, shared=shared,
            prompt=req.prompt if self.prefix_sharing else None)
        self._admit_draft(req, slot, total)
        act = _Active(req=req, slot=slot, pf_pos=shared_len,
                      submit_t=getattr(req, "_submit_t", time.perf_counter()))
        self._spec_k[slot] = max(self.spec_tokens, 1)
        self.telemetry.req_instant(req.rid, "admit", t=now, slot=slot,
                                   shared_prefix_tokens=shared_len)
        if self._chunked:
            self.prefilling[req.rid] = act
        else:
            self._pending_onepass.append(act)

    def _admit_draft(self, req: Request, slot: int, total: int) -> None:
        """Mirror an admission into the drafter's pool at the same slot
        (the two decode batches stay row-aligned); its exact-length
        prompt prefill runs in :meth:`_prefill_phase`."""
        if self.draft is None:
            return
        self.draft.layout.admit(req.rid, total, slot=slot)
        self._pending_draft.append(req)

    def _prefill_onepass(self, act: _Active) -> None:
        """One-shot prefill into the request's pages or slot row: at the
        exact length, but on dense rows padded to the prompt's bucket for
        an attention-only stack (``ServeStats`` counts the padded
        tokens, as JAX's ``_prefill_dense`` does)."""
        P = act.req.prompt_len
        bucket = self._bucket(P) if not self.paged and self._can_pad \
            else None
        t0 = time.perf_counter()
        last = self.session.prefill(act.req.rid, act.req.prompt,
                                    bucket=bucket)
        # JAX's span names the dense path's bucket (the exact length when
        # the stack cannot pad), the paged one-shot's tokens only
        extra = {} if self.paged else {"bucket": bucket or P}
        self.telemetry.req_span(act.req.rid, "prefill", t0,
                                time.perf_counter(), tokens=P, **extra)
        self.stats.prefills += 1
        self.stats.prefill_tokens += P
        self.stats.padded_prefill_tokens += bucket or P
        self._start_decoding(act, last)

    def _prefill_draft(self, req: Request) -> None:
        """The drafter's prompt: padded to its bucket on dense rows when
        the drafter is attention-only, as JAX's ``_prefill_draft``."""
        bucket = self._bucket(req.prompt_len) \
            if not self.paged and self._draft_can_pad else None
        self.draft.prefill(req.rid, req.prompt, bucket=bucket)

    def _prefill_phase(self) -> None:
        """The prefills admission deferred: the drafter's prompts, every
        one-shot prefill, then one round of chunked-prefill slices."""
        for req in self._pending_draft:
            self._prefill_draft(req)
        self._pending_draft.clear()
        for act in self._pending_onepass:
            self._prefill_onepass(act)
        self._pending_onepass.clear()
        if self.prefilling:
            self._prefill_step()

    def _prefill_step(self) -> None:
        """Advance chunked prefills: one chunk per prefilling request,
        at most ``max_prefills_per_step`` chunk calls per step."""
        for act in list(self.prefilling.values())[
                :self.max_prefills_per_step]:
            self._prefill_chunk_once(act)

    def _prefill_chunk_once(self, act: _Active) -> None:
        req = act.req
        P = req.prompt_len
        # one-shot (prefill_chunk=0) still buckets the chunk size, so a
        # mixed-length trace runs per pow2 bucket, not per length
        chunk = self.prefill_chunk if self.prefill_chunk > 0 \
            else self._bucket(P)
        n = min(chunk, P - act.pf_pos)
        final = act.pf_pos + n >= P
        Cb = chunk if (not final or n == chunk) \
            else self._bucket(n, cap=chunk)
        self.pool.ensure(req.rid, act.pf_pos + n)
        W = self._table_bucket(act.pf_pos + n)
        t0 = time.perf_counter()
        last = self.session.prefill_chunk(
            req.rid, req.prompt[act.pf_pos:act.pf_pos + n],
            hist_len=act.pf_pos, prompt_len=P, chunk_bucket=Cb, width=W)
        self.telemetry.req_span(
            req.rid, "prefill_chunk", t0, time.perf_counter(),
            tokens=n, pos=act.pf_pos, prompt_len=P)
        act.pf_pos += n
        self.stats.prefills += 1
        self.stats.prefill_chunks += 1
        self.stats.prefill_tokens += n
        self.stats.padded_prefill_tokens += Cb
        if self.prefix_sharing:
            # pages fully covered by prefilled prompt tokens are
            # immutable from here on — offer them to future admissions
            self.pool.register_prefix(req.rid, req.prompt[:act.pf_pos])
        if final:
            del self.prefilling[req.rid]
            self._start_decoding(act, last)

    def _start_decoding(self, act: _Active, last_logits: np.ndarray) -> None:
        """Sample the first token off the prefill logits and move the
        request into the decode batch."""
        self.active[act.req.rid] = act
        self._by_slot[act.slot] = act
        tok = self._sample(last_logits, act.req, 0)
        act.first_token_t = time.perf_counter()
        self.stats.ttft.append(act.first_token_t - act.submit_t)
        self.telemetry.req_instant(
            act.req.rid, "first_token", t=act.first_token_t,
            ttft_s=act.first_token_t - act.submit_t)
        self._accept_token(act, tok)

    @staticmethod
    def _sample(logits_row: np.ndarray, req: Request, ntok: int) -> int:
        """logits_row: (V,) host array.  Greedy at temperature 0, else the
        Gumbel trick with ``default_rng([seed, ntok_base + ntok])`` —
        deterministic, and the same draw the JAX package makes; a
        journal-resumed request's ``ntok_base`` continues the stream where
        the interrupted run left it."""
        if req.temperature <= 0.0:
            return int(np.argmax(logits_row))
        rng = np.random.default_rng([req.seed, req.ntok_base + ntok])
        g = rng.gumbel(size=logits_row.shape[-1])
        return int(np.argmax(
            np.asarray(logits_row, np.float64) / req.temperature + g))

    def _accept_token(self, act: _Active, tok: int) -> None:
        act.tokens.append(tok)
        act.ntok += 1
        self.stats.decode_tokens += 1
        if self.journal is not None:
            self._journal_tokens.setdefault(act.req.rid, []).append(tok)
        # write position of `tok`'s KV on the NEXT decode step
        self._index[act.slot] = act.req.prompt_len + act.ntok - 1
        self._next_token[act.slot] = tok
        if act.ntok >= act.req.max_new or \
                (act.req.eos_id is not None and tok == act.req.eos_id):
            self._finish(act)

    def _finish(self, act: _Active) -> None:
        rid = act.req.rid
        self.results[rid] = np.asarray(act.tokens, np.int32)
        if self.arena is not None:
            self.arena.record_finished(rid, act.req.prompt, act.tokens)
        if self.journal is not None:
            self._journal_finished.append(rid)
        if self.spec_adapt:
            self.spec_k_by_rid[rid] = int(self._spec_k[act.slot])
        self.stats.completed += 1
        now = time.perf_counter()
        self.stats.latency.append(now - act.submit_t)
        ttft = (act.first_token_t or now) - act.submit_t
        tpot = None
        if act.ntok > 1 and act.first_token_t is not None:
            tpot = (now - act.first_token_t) / (act.ntok - 1)
            self.stats.tpot.append(tpot)
        if act.req.ttft_deadline_ms is not None \
                and ttft * 1e3 > act.req.ttft_deadline_ms:
            self.stats.ttft_deadline_misses += 1
        if act.req.tpot_deadline_ms is not None and tpot is not None \
                and tpot * 1e3 > act.req.tpot_deadline_ms:
            self.stats.tpot_deadline_misses += 1
        self.telemetry.terminal(rid, "finish", t=now, ntok=act.ntok,
                                latency_s=now - act.submit_t)
        slot = self.pool.release(rid)
        if self.draft is not None:
            self.draft.layout.release(rid)
        del self.active[rid]
        del self._by_slot[slot]
        self._next_token[slot] = 0
        self._index[slot] = self._idle_index

    # -- cancellation / load shedding ---------------------------------------
    def cancel(self, rid) -> bool:
        """Drop a request wherever it is in its lifecycle.

        A queued request leaves the queue; an admitted one (waiting for
        its one-shot prefill, prefilling in chunks or decoding) releases
        its slot, its pages (a prefix page it shares loses one reference
        and stays) and its drafter rows at once, and its deferred prefills
        never run.  Its partial tokens are not recorded in ``results``: a
        streaming caller already has them.  Returns True if the rid was
        found, False if it is unknown or already completed; counted as
        ``cancelled``.
        """
        return self._cancel_now(rid, "cancel")

    def shed_expired(self) -> List[Any]:
        """Shed queued requests whose TTFT deadline has already passed.

        Such a request can no longer meet its SLO, so admitting it would
        waste a slot: it is dropped and counted as ``shed_deadline``.
        Returns the shed rids (the gateway answers each with a 429).
        In-flight requests are never shed: their misses are counted at
        completion.
        """
        now = time.perf_counter()
        shed = [q.rid for q in self.queue
                if q.ttft_deadline_ms is not None
                and (now - getattr(q, "_submit_t", now)) * 1e3
                > q.ttft_deadline_ms]
        for rid in shed:
            self._cancel_now(rid, "deadline")
        return shed

    def _cancel_now(self, rid, reason: str) -> bool:
        """Remove ``rid`` now; ``reason`` picks the counter ("cancel" ->
        cancelled, "deadline" -> shed_deadline), the journal record and
        the request's terminal trace instant."""
        found = False
        for i, q in enumerate(self.queue):
            if q.rid == rid:
                del self.queue[i]
                found = True
                break
        if not found:
            act = self.active.get(rid) or self.prefilling.get(rid) or next(
                (a for a in self._pending_onepass if a.req.rid == rid),
                None)
            if act is None:
                return False
            # deferred device work for this rid must not run
            self._pending_onepass = [a for a in self._pending_onepass
                                     if a.req.rid != rid]
            self._pending_draft = [r for r in self._pending_draft
                                   if r.rid != rid]
            slot = self.pool.release(rid)
            if self.draft is not None:
                self.draft.layout.release(rid)
            self.active.pop(rid, None)
            self.prefilling.pop(rid, None)
            self._by_slot.pop(slot, None)
            self._next_token[slot] = 0
            self._index[slot] = self._idle_index
        if self._head_share is not None and self._head_share[0] == rid:
            self._head_share = None
        kind = "shed" if reason == "deadline" else "cancel"
        if self.journal is not None:
            self.journal.record_cancel(rid, reason)
            self._journal_tokens.pop(rid, None)
        self.telemetry.terminal(rid, kind, reason=reason)
        log_event(kind, rid=rid, reason=reason)
        if reason == "deadline":
            self.stats.shed_deadline += 1
        else:
            self.stats.cancelled += 1
        return True

    # -- hot swap -------------------------------------------------------------
    def set_params(self, params) -> None:
        """Hot-swap the target's weights between steps (``params`` in the
        port's layout; the cache layout is unchanged).  The prefix cache is
        flushed: old-weight pages must not be shared into post-swap
        admissions.  The drafter keeps its weights -- its tokens are only
        proposals, verified against the new target -- so a self drafter
        that shares the target's model gets a copy of the old weights
        first."""
        if self.draft is not None and \
                self.draft.model is self.session.model:
            self.draft.model = copy.deepcopy(self.session.model)
        self.session.set_params(params)
        if self.paged:
            self.pool.invalidate_prefix()
            self._head_share = None
        self.stats.hot_swaps += 1
        self.telemetry.event("hot_swap", step=self._step_count,
                             swaps=self.stats.hot_swaps)
        log_event("hot_swap", step=self._step_count,
                  swaps=self.stats.hot_swaps)

    @property
    def draining(self) -> bool:
        """True while new weights wait for in-flight requests to finish."""
        return self._pending_params is not None

    def _poll_registry(self) -> Optional[int]:
        """Poll for a newer winner every ``watch_every`` steps; returns its
        step when one was loaded."""
        if self.registry is not None and self.watch_every > 0 \
                and self._step_count % self.watch_every == 0:
            found = self.registry.refresh()
            # mirror the registry's corrupt-swap rejections into the stats
            self.stats.swap_rejected_corrupt = getattr(
                self.registry, "rejected_corrupt", 0)
            if found:
                return getattr(self.registry, "step", 0)
        return None

    def _apply_swap(self, winner: Optional[int]) -> None:
        """Apply or defer a found winner per ``swap_mode``; a deferred one
        lands once nothing is in flight."""
        if winner is not None:
            if self.swap_mode == "drain" and (self.active
                                              or self.prefilling):
                self._pending_params = self.registry.params
            else:
                self._pending_params = None
                self.set_params(self.registry.params)
        if self._pending_params is not None and not self.active \
                and not self.prefilling:
            self.set_params(self._pending_params)
            self._pending_params = None

    # -- online LTFB arena (serve/arena.py) ----------------------------------
    def _arena_rotate(self) -> None:
        """Rotate the drafter to the policy's pick for this step (a pure
        function of the step and the arena's state)."""
        if self.arena is None:
            return
        want = self.arena.drafter_for_step(self._step_count)
        if want != self.arena.active_drafter:
            self.arena.set_drafter(want)
            self.draft.set_params(self.arena.params[want])

    def _arena_decide(self) -> Optional[str]:
        """The deciding half of a promotion: run the match evaluation,
        journal it and, when the rule fires, run the checksum-verified
        registry archive before anything changes.  Returns the winner,
        or None."""
        if self.arena is None:
            return None
        a = self.arena
        if a.forced is None and self._step_count % a.cfg.check_every != 0:
            return None
        winner = a.decide(self._step_count)
        self.stats.arena_matches = a.matches
        if self.journal is not None:
            self.journal.record_match(self._step_count, a.snapshot())
        if winner is None:
            return None
        prepared = a.prepare_promotion(winner)
        if prepared is None:
            # the archive failed verification: abort, keep serving
            self.stats.swap_rejected_corrupt += 1
            return None
        return prepared

    def _arena_apply(self, winner: Optional[str]) -> None:
        """The applying half of a promotion: change the arena's state,
        journal the promotion (synced before the weight swap, so a torn
        record means no swap), then swap the target to the new champion
        -- drain-aware: in-flight requests finish on the old weights."""
        if self.arena is None or winner is None:
            return
        a = self.arena
        loser = a.champion
        new_params = a.promote(winner, self._step_count)
        rec = a.last_promotion
        self.stats.arena_promotions = a.promotions
        if self.journal is not None:
            self.journal.record_promotion(
                self._step_count, winner, loser, rec["rate"],
                a.last_forced, a.snapshot())
        if self.swap_mode == "drain" and (self.active or self.prefilling):
            self._pending_params = new_params
        else:
            self._pending_params = None
            self.set_params(new_params)
        # the promotion recomputed the rotation: resync the drafter
        self.draft.set_params(a.params[a.active_drafter])
        log_event("arena_promotion", step=self._step_count,
                  winner=winner, loser=loser, rate=rec["rate"],
                  generation=a.generation)

    def arena_force(self, member: str) -> None:
        """Queue an admin promotion (``POST /arena/promote``): the next
        match evaluation promotes ``member`` unconditionally -- still
        through the transactional archive and the drain-aware swap."""
        if self.arena is None:
            raise ValueError("no arena attached to this scheduler")
        if member not in self.arena.members:
            raise ValueError(
                f"unknown arena member {member!r}; roster is "
                f"{sorted(self.arena.members)}")
        self.arena.forced = member

    def _admission_phase(self) -> List[Any]:
        """Admit what fits; returns the admitted rids in order (the
        decision record a mesh's step plan carries)."""
        admitted: List[Any] = []
        if self.draining:
            return admitted
        if self.faults is not None \
                and self.faults.admission_blocked(self._step_count):
            return admitted     # injected pool exhaustion (oom@step)
        if self.policy == "static":
            if not (self.active or self.prefilling):
                while self.queue and self._can_admit_head():
                    admitted.append(self.queue[0].rid)
                    self._admit(self.queue.popleft())
            return admitted
        while (len(admitted) < self.max_prefills_per_step and self.queue
               and self._can_admit_head()):
            admitted.append(self.queue[0].rid)
            self._admit(self.queue.popleft())
        return admitted

    def _decode_phase(self) -> None:
        if self.active:
            if self.spec_tokens > 0:
                self._spec_round()
            else:
                self._decode_round()

    def _timed_phases(self) -> None:
        """Run admission → prefill → decode with per-phase host wall-time
        attribution (``telemetry.phase_seconds`` + step-timeline spans,
        emitted only for phases that had work)."""
        tel = self.telemetry
        t0 = time.perf_counter()
        admitted = self._admission_phase()
        t1 = time.perf_counter()
        tel.phase("admit", t0, t1, emit=bool(admitted))
        had_pf = bool(self._pending_draft or self._pending_onepass
                      or self.prefilling)
        t0 = t1
        self._prefill_phase()
        t1 = time.perf_counter()
        tel.phase("prefill", t0, t1, emit=had_pf)
        had_dec = bool(self.active)
        t0 = t1
        self._decode_phase()
        tel.phase("decode", t0, time.perf_counter(), emit=had_dec)

    def profile_steps(self, steps: int, outdir: str) -> None:
        """Arm ``torch.profiler`` around the next ``steps`` scheduler
        steps (``--profile-steps``): it starts at the next :meth:`step`
        and stops after the window closes, writing one Chrome trace
        under ``outdir``.  No other profiler may record meanwhile: a
        failure to start or stop is kept in
        ``telemetry.profile_error``."""
        self.telemetry.arm_profile(steps, outdir)

    def _journal_step(self) -> None:
        """Commit this step's tokens and completions to the journal: one
        batched write + flush (see :mod:`repro_torch.serve.journal`)."""
        if self.journal is None:
            return
        self.journal.step_commit(self._journal_tokens,
                                 self._journal_finished)
        self._journal_tokens = {}
        self._journal_finished = []

    def step(self) -> None:
        """One scheduler iteration: the scripted faults of this step, the
        hot-swap check, the arena's drafter rotation and match, admission,
        the one-shot prefills and one round of chunked prefill, one
        batched decode round, completion, and the journal's commit of the
        step."""
        self.stats.start()
        self.telemetry.step_begin(self._step_count + 1)
        if self.faults is not None:
            self.faults.on_step(self, self._step_count + 1)
        self._apply_swap(self._poll_registry())
        self._step_count += 1
        self._arena_rotate()
        self._arena_apply(self._arena_decide())
        self._timed_phases()
        self.stats.sample_step(len(self.queue),
                               len(self.active) + len(self.prefilling))
        self._journal_step()
        self.telemetry.step_end()

    # -- decode --------------------------------------------------------------
    def _ensure_decode_pages(self, pool: PagedLayout,
                             last_token_pos: Dict[int, int]) -> None:
        """Materialize every page a row's writes of this round land on in
        ``pool``: ``last_token_pos[slot]`` is the row's last write
        position (a speculative round writes from its index up to K+1
        positions, across as many page boundaries as they hold; ensure is
        idempotent, and page boundaries are the only times new pages
        appear)."""
        bs = pool.block_size
        for act in self.active.values():
            first = int(self._index[act.slot])
            last = last_token_pos[act.slot]
            if first // bs != (first - 1) // bs or last // bs != first // bs:
                pool.ensure(act.req.rid, last + 1)

    def _width_split(self) -> List[tuple]:
        """Partition active rows by pow2 table width: when one long
        request's width is >= ``_SPLIT_RATIO``x every other row's (and
        grouping is on), split the round into (narrow, wide) groups.
        Returns [(width_bucket, [slots])]."""
        buckets = {act.slot: self._table_bucket(
            int(self._index[act.slot]) + 1)
            for act in self.active.values()}
        wide_w = max(buckets.values())
        narrow = [s for s, w in buckets.items() if w < wide_w]
        narrow_w = max((buckets[s] for s in narrow), default=0)
        if not self._group_decode or not narrow \
                or wide_w < self._SPLIT_RATIO * narrow_w:
            return [(wide_w, list(buckets))]
        wide = [s for s, w in buckets.items() if w == wide_w]
        return [(narrow_w, narrow), (wide_w, wide)]

    def _decode_round(self) -> None:
        if self.paged:
            self._ensure_decode_pages(self.pool, {
                a.slot: int(self._index[a.slot])
                for a in self.active.values()})
            groups = self._width_split()
        else:
            groups = [(None, None)]
        self.stats.decode_steps += 1
        if len(groups) == 1:
            # common path: one full-batch dispatch
            logits = self.session.step(self._next_token[:, None],
                                       self._index, width=groups[0][0])
            rows = logits.float().cpu().numpy()
            self.stats.decode_slot_steps += self.pool.num_slots
            # sample per active slot; finishing frees the slot in place
            for act in list(self.active.values()):
                self._accept_token(
                    act, self._sample(rows[act.slot, 0], act.req, act.ntok))
            return
        # ragged split: one subset dispatch per width group (row counts
        # pow2-bucketed, as in the JAX package)
        for W, slots in groups:
            n = min(_next_pow2(len(slots)), self.pool.num_slots)
            tokens = np.zeros((n, 1), np.int32)
            index = np.full((n,), -1, np.int32)
            tables = np.full((n, W), self.pool.null_page, np.int32)
            for i, s in enumerate(slots):
                tokens[i, 0] = self._next_token[s]
                index[i] = self._index[s]
                tables[i] = self.pool.tables[s, :W]
            rows = self.session.step(tokens, index, tables=tables) \
                .float().cpu().numpy()
            self.stats.decode_slot_steps += n
            self.stats.ragged_splits += 1
            for i, s in enumerate(slots):
                act = self._by_slot.get(s)
                if act is not None:
                    self._accept_token(
                        act, self._sample(rows[i, 0], act.req, act.ntok))

    # -- speculative decode --------------------------------------------------
    def _spec_round(self) -> None:
        """One population-speculative round (``Scheduler._spec_round`` of
        the JAX package).

        The drafter proposes up to ``spec_tokens`` tokens a row
        (``spec_adapt`` sets each row's depth from its accept history);
        the target verifies the row's pending token and every proposal in
        one (K+1)-token ``session.step``; the row keeps its longest prefix
        of proposals the target's own samples match, plus one target token
        (the correction or the bonus), so every emitted token is a target
        sample and the stream equals target-only decoding.

        The fused draft (``spec_fused``) is one call,
        :meth:`DecodeSession.draft_block`, that feeds each step's greedy
        argmax into the next on the device; the host then resamples the
        proposals from its logits with the request's own sampling.  At
        temperature > 0 a resample may part from the greedy feed: the
        drafter then holds wrong tokens in its history, which the repair
        below replays away.  The sequential draft takes K+1 single steps
        fed with the host's samples.

        Rollback: a row that kept fewer tokens than it fed restores the
        target's recurrent state and replays its kept prefix (attention
        K/V needs none: the stale tail is causally masked until it is
        overwritten); the drafter repairs a row whose fed block parted
        from the host's, or whose recurrent state ran past the kept
        prefix, the same way.
        """
        B = self.pool.num_slots
        acts = list(self.active.values())
        t_rec = self.pool.has_recurrent
        d_rec = self.draft.layout.has_recurrent
        base = self._index.copy()
        # per-row cap: writes at base .. base + cap - 1 stay inside the
        # prompt + max_new reservation (a cap-truncated row finishes this
        # round anyway)
        cap = np.zeros((B,), np.int32)
        for act in acts:
            k_row = int(self._spec_k[act.slot]) if self.spec_adapt \
                else self.spec_tokens
            cap[act.slot] = min(k_row + 1, act.req.max_new - act.ntok + 1)
        Kv = int(cap.max())
        if self.paged:
            targets = {a.slot: int(base[a.slot]) + int(cap[a.slot]) - 1
                       for a in acts}
            self._ensure_decode_pages(self.pool, targets)
            self._ensure_decode_pages(self.draft.layout, targets)
            W = self._table_bucket(int((base + cap).max()))
        else:
            W = None
        block = np.zeros((B, Kv), np.int32)
        block[:, 0] = self._next_token
        ntok0 = {act.slot: act.ntok for act in acts}

        with record_function("rollback"):
            d_snap = self.draft.snapshot() if d_rec else ()
        t_draft = time.perf_counter()
        with record_function("draft"):
            if self.spec_fused:
                dlogits, fed_dev = self.draft.draft_block(
                    self._next_token[:, None], base, Kv, valid=cap, width=W)
                drows = dlogits.float().cpu().numpy()        # (B, Kv, V)
                dev = fed_dev.cpu().numpy()                  # (B, Kv)
                self.stats.spec_draft_steps += 1
                for act in acts:
                    s = act.slot
                    for t in range(int(cap[s]) - 1):
                        block[s, t + 1] = self._sample(drows[s, t], act.req,
                                                       ntok0[s] + t)
            else:
                # Kv single steps; the last feeds the final proposal, so
                # drafter and target caches stay aligned when every
                # proposal is accepted
                for t in range(Kv):
                    valid_t = (cap > t).astype(np.int32)
                    idx_t = np.where(self._index >= 0, base + t,
                                     self._idle_index).astype(np.int32)
                    logits = self.draft.step(block[:, t:t + 1], idx_t,
                                             valid=valid_t, width=W)
                    self.stats.spec_draft_steps += 1
                    if t + 1 >= Kv:
                        break
                    rows = logits.float().cpu().numpy()
                    for act in acts:
                        s = act.slot
                        if t + 1 < cap[s]:
                            block[s, t + 1] = self._sample(
                                rows[s, 0], act.req, ntok0[s] + t)
                dev = block         # the drafter was fed the host's block
        t_verify = time.perf_counter()
        self.telemetry.phase("draft", t_draft, t_verify, k=Kv - 1)

        # the target verifies the whole block in one K-token step
        with record_function("rollback"):
            t_snap = self.session.snapshot() if t_rec else ()
        with record_function("verify"):
            vlogits = self.session.step(block, base, valid=cap, width=W)
            rows = vlogits.float().cpu().numpy()             # (B, Kv, V)
        self.telemetry.phase("verify", t_verify, time.perf_counter(), k=Kv)
        self.stats.decode_steps += 1
        self.stats.spec_rounds += 1
        self.stats.decode_slot_steps += B

        # acceptance: the longest matching prefix + one target token
        fed_valid = np.zeros((B,), np.int32)
        for act in acts:
            s = act.slot
            c = int(cap[s])
            n0 = ntok0[s]
            appended = 0
            for t in range(c):
                g = self._sample(rows[s, t], act.req, n0 + t)
                self._accept_token(act, g)                   # may finish
                appended += 1
                if act.req.rid not in self.active:
                    break
                if t + 1 >= c or g != int(block[s, t + 1]):
                    break
            fed_valid[s] = appended
            offered = max(0, c - 1)
            accepted = max(0, appended - 1)
            self.stats.spec_draft_proposed += offered
            self.stats.spec_draft_accepted += accepted
            if self.arena is not None:
                self.arena.record_spec(offered, accepted)
            if offered:
                self.stats.spec_k_sum += offered
                self.stats.spec_k_rows += 1
                if self.spec_adapt:
                    self._adapt_depth(act, offered, accepted)

        # rollback
        rb_t = np.zeros((B,), bool)
        rep_t = np.zeros((B,), np.int32)
        rb_d = np.zeros((B,), bool)
        rep_d = np.zeros((B,), np.int32)
        for act in acts:
            s = act.slot
            if act.req.rid not in self.active:
                continue
            fed = int(fed_valid[s])
            if fed < cap[s]:
                # the target kept fewer tokens than it fed: its recurrent
                # state (if any) rolls back to the kept prefix
                rb_t[s] = True
                rep_t[s] = fed
            diverged = dev[s, 1:fed].tolist() != block[s, 1:fed].tolist()
            if diverged or (d_rec and fed < cap[s]):
                rb_d[s] = True
                rep_d[s] = fed
        with record_function("rollback"):
            if t_rec and rb_t.any():
                self.session.restore(t_snap, rb_t)
                self.session.step(block, base, valid=rep_t, width=W)
                self.stats.spec_replays += 1
            if rb_d.any():
                if d_rec:
                    self.draft.restore(d_snap, rb_d)
                self.draft.step(block, base, valid=rep_d, width=W)
                self.stats.spec_replays += 1

    def _adapt_depth(self, act: _Active, offered: int,
                     accepted: int) -> None:
        """Per-row speculative depth (``spec_adapt``): one more after a
        fully accepted block, half after a complete rejection, else what
        the row just proved it can absorb -- within [1, spec_tokens]."""
        k = int(self._spec_k[act.slot])
        if accepted >= offered:
            k = min(self.spec_tokens, k + 1)
        elif accepted == 0:
            k = max(1, k // 2)
        else:
            k = max(1, min(k, accepted + 1))
        self._spec_k[act.slot] = k
        self.spec_k_by_rid[act.req.rid] = k

    def _table_bucket(self, max_tokens: int) -> int:
        """Gather width (block-table columns) for this step, pow2-bucketed
        and capped at the table width."""
        w = self.pool.table_width_for(max_tokens)
        return min(_next_pow2(w), self.pool.max_blocks_per_seq)

    def run(self, max_steps: Optional[int] = None) -> Dict[Any, np.ndarray]:
        """Drive until the queue and the batch drain; returns results
        (rid -> generated token ids)."""
        steps = 0
        while self.queue or self.active or self.prefilling:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self.stats.stop()
        return self.results

    def full_sequence(self, req: Request) -> np.ndarray:
        """Prompt + generated tokens for a completed request."""
        return np.concatenate([np.asarray(req.prompt, np.int32),
                               self.results[req.rid]])
