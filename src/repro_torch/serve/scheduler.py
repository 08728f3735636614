"""Continuous-batching LM serving scheduler of the port (paged KV cache).

The counterpart of ``repro.serve.scheduler.Scheduler`` for the paged
layout and every token-input family: dense, moe, audio, hybrid (jamba)
and ssm (xLSTM); a vlm is refused, as in JAX (its prompts would be
embeddings).  Per scheduler step:

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
     cannot resume mid-prompt.
  3. *decode* — one batched ``session.step`` over every slot; each row's
     next token is sampled on the host.  On the CPU (the plain-version
     gather pays each row's full table width) a round whose one long row
     is >= 4x wider than every other row splits into (narrow, wide)
     groups; on the card the paged-attention kernel skips each row's
     unused pages by itself, so the round stays one dispatch.
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
so both packages emit the same tokens for the same logits.  Speculative
decoding, the journal, fault injection, the arena and trace spans are not
ported yet: the constructor raises on their arguments.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serve.kv_cache import PagedLayout, blocks_for
from repro_torch.serve.metrics import ServeStats
from repro_torch.serve.session import DecodeSession

# constructor arguments of the JAX scheduler this port does not serve yet
# (ROADMAP queue A); passing any of them raises rather than being ignored
UNPORTED_ARGS = ("draft_params", "spec_tokens", "draft_cfg", "spec_fused",
                 "spec_adapt", "max_queue", "telemetry", "trace_capacity",
                 "journal", "faults", "arena")


@dataclass
class Request:
    """One generation request.

    ``prompt`` is a (P,) int32 token-id array; ``max_new`` bounds the
    generated tokens; ``temperature > 0`` requires ``seed`` (sampling is
    host-side and deterministic in ``(seed, ntok)``).
    """

    rid: Any
    prompt: np.ndarray              # (P,) int32 token ids
    max_new: int
    eos_id: Optional[int] = None
    temperature: float = 0.0
    seed: Optional[int] = None

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
    """Continuous-batching scheduler over a paged KV-cache pool.

    ``model`` is a :class:`repro_torch.models.lm.LM` on ``device`` (the
    card unless ``device="cpu"``; without a card the default raises).
    ``registry`` (polled every ``watch_every`` steps) hands over weights
    in the port's layout (its ``from_ckpt`` hook), which ``set_params``
    copies into ``model``.
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
                 device="cuda", **unported):
        self.device = resolve_device(device)
        bad = sorted(set(unported) & set(UNPORTED_ARGS))
        if bad:
            raise NotImplementedError(
                f"Scheduler arguments {bad} are not ported to repro_torch "
                "yet; see ROADMAP.md queue A")
        if unported:
            raise TypeError(f"unexpected arguments {sorted(unported)}")
        if layout != "paged":
            raise NotImplementedError(
                f"layout {layout!r} is not ported; the port serves the "
                "paged layout")
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {policy!r}")
        if swap_mode not in ("immediate", "drain"):
            raise ValueError(f"unknown swap_mode {swap_mode!r}")
        if cfg.family == "vlm":
            raise ValueError(
                "serving scheduler supports token-input families only "
                "(vlm prompts need precomputed embeddings)")
        lm.layer_specs(cfg)             # raises for a non-LM config
        self.cfg = cfg
        self.policy = policy
        self.prefill_chunk = int(prefill_chunk)
        self.max_prefills_per_step = max_prefills_per_step
        self.min_prefill_bucket = min_prefill_bucket
        self.registry = registry
        self.watch_every = watch_every
        self.swap_mode = swap_mode
        n_blocks = num_blocks if num_blocks is not None \
            else num_slots * blocks_for(max_len, block_size)
        self.pool = PagedLayout(cfg, num_slots, n_blocks,
                                block_size=block_size,
                                max_seq=max_seq or max_len,
                                pin_prefix=pin_prefix, device=self.device)
        self.max_seq = self.pool.max_seq
        self.session = DecodeSession(cfg, model, self.pool)
        # right-padding and chunking prompts is only sound for
        # attention-only stacks: recurrent layers prefill one-shot at the
        # exact prompt length, with no prefix sharing (as in JAX)
        self._can_pad = not self.pool.has_recurrent
        self.prefix_sharing = bool(prefix_sharing) and self._can_pad
        # ragged gather-width grouping pays only for the plain version on
        # the CPU (the CUDA kernel skips each row's unused pages itself),
        # and needs a cache with no per-slot rows
        self._group_decode = self.device.type == "cpu" and self._can_pad
        self.queue: deque[Request] = deque()
        self.active: Dict[Any, _Active] = {}
        self.prefilling: Dict[Any, _Active] = {}
        # one-shot prefills admitted this step, run after admission
        self._pending_onepass: List[_Active] = []
        self._by_slot: Dict[int, _Active] = {}
        self._next_token = np.zeros((num_slots,), np.int32)
        # -1 marks a row that holds no request (KV writes go to the null
        # page)
        self._index = np.full((num_slots,), -1, np.int32)
        self.results: Dict[Any, np.ndarray] = {}
        self.stats = ServeStats(slots=num_slots)
        self._pending_params = None
        self._head_share = None
        self._step_count = 0

    # -- request intake ----------------------------------------------------
    def _reject(self, msg: str):
        self.stats.rejected += 1
        raise ValueError(msg)

    def submit(self, req: Request) -> None:
        """Validate + enqueue a request (host-side only, non-blocking).

        Raises ``ValueError`` for malformed requests (duplicate rid,
        empty prompt, budget over the pool ceiling, missing seed),
        counted as ``rejected``.  Admission happens inside :meth:`step`.
        """
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
        req._submit_t = time.perf_counter()   # TTFT includes queueing delay
        self.queue.append(req)

    # -- scheduling ---------------------------------------------------------
    def _bucket(self, n: int, cap: Optional[int] = None) -> int:
        cap = cap or self.max_seq
        return min(max(self.min_prefill_bucket, _next_pow2(n)), cap)

    def _can_admit_head(self) -> bool:
        req = self.queue[0]
        total = req.prompt_len + req.max_new
        if not self.pool.free_slots:        # skip prefix hashing when full
            return False
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
        head = self._head_share
        shared = head[1] if head is not None and head[0] == req.rid \
            else None
        self._head_share = None
        slot, shared_len = self.pool.admit(
            req.rid, total, shared=shared,
            prompt=req.prompt if self.prefix_sharing else None)
        act = _Active(req=req, slot=slot, pf_pos=shared_len,
                      submit_t=getattr(req, "_submit_t", time.perf_counter()))
        if self._can_pad:
            self.prefilling[req.rid] = act
        else:
            self._pending_onepass.append(act)

    def _prefill_onepass(self, act: _Active) -> None:
        """Exact-length one-shot prefill into the request's pages and slot
        row (stacks with recurrent layers)."""
        P = act.req.prompt_len
        last = self.session.prefill(act.req.rid, act.req.prompt)
        self.stats.prefills += 1
        self.stats.prefill_tokens += P
        self.stats.padded_prefill_tokens += P
        self._start_decoding(act, last)

    def _prefill_phase(self) -> None:
        """The prefills admission deferred: every one-shot prefill, then
        one round of chunked-prefill slices."""
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
        last = self.session.prefill_chunk(
            req.rid, req.prompt[act.pf_pos:act.pf_pos + n],
            hist_len=act.pf_pos, prompt_len=P, chunk_bucket=Cb, width=W)
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
        self._accept_token(act, tok)

    @staticmethod
    def _sample(logits_row: np.ndarray, req: Request, ntok: int) -> int:
        """logits_row: (V,) host array.  Greedy at temperature 0, else the
        Gumbel trick with ``default_rng([seed, ntok])`` — deterministic,
        and the same draw the JAX package makes."""
        if req.temperature <= 0.0:
            return int(np.argmax(logits_row))
        rng = np.random.default_rng([req.seed, ntok])
        g = rng.gumbel(size=logits_row.shape[-1])
        return int(np.argmax(
            np.asarray(logits_row, np.float64) / req.temperature + g))

    def _accept_token(self, act: _Active, tok: int) -> None:
        act.tokens.append(tok)
        act.ntok += 1
        self.stats.decode_tokens += 1
        # write position of `tok`'s KV on the NEXT decode step
        self._index[act.slot] = act.req.prompt_len + act.ntok - 1
        self._next_token[act.slot] = tok
        if act.ntok >= act.req.max_new or \
                (act.req.eos_id is not None and tok == act.req.eos_id):
            self._finish(act)

    def _finish(self, act: _Active) -> None:
        rid = act.req.rid
        self.results[rid] = np.asarray(act.tokens, np.int32)
        self.stats.completed += 1
        now = time.perf_counter()
        self.stats.latency.append(now - act.submit_t)
        if act.ntok > 1 and act.first_token_t is not None:
            self.stats.tpot.append(
                (now - act.first_token_t) / (act.ntok - 1))
        slot = self.pool.release(rid)
        del self.active[rid]
        del self._by_slot[slot]
        self._next_token[slot] = 0
        self._index[slot] = -1

    # -- hot swap -------------------------------------------------------------
    def set_params(self, params) -> None:
        """Hot-swap the weights between steps (``params`` in the port's
        layout; the cache layout is unchanged).  The prefix cache is
        flushed: old-weight pages must not be shared into post-swap
        admissions."""
        self.session.set_params(params)
        self.pool.invalidate_prefix()
        self._head_share = None
        self.stats.hot_swaps += 1

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

    def _admission_phase(self) -> None:
        if self.draining:
            return
        if self.policy == "static":
            if not (self.active or self.prefilling):
                while self.queue and self._can_admit_head():
                    self._admit(self.queue.popleft())
            return
        admitted = 0
        while (admitted < self.max_prefills_per_step and self.queue
               and self._can_admit_head()):
            self._admit(self.queue.popleft())
            admitted += 1

    def step(self) -> None:
        """One scheduler iteration: the hot-swap check, admission, the
        one-shot prefills and one round of chunked prefill, one batched
        decode round, completion."""
        self.stats.start()
        self._apply_swap(self._poll_registry())
        self._step_count += 1
        self._admission_phase()
        self._prefill_phase()
        if self.active:
            self._decode_round()
        self.stats.sample_step(len(self.queue),
                               len(self.active) + len(self.prefilling))

    # -- decode --------------------------------------------------------------
    def _ensure_decode_pages(self) -> None:
        """Materialize the page each row's next write lands on (page
        boundaries are the only times new pages appear)."""
        bs = self.pool.block_size
        for act in self.active.values():
            pos = int(self._index[act.slot])
            if pos // bs != (pos - 1) // bs:
                self.pool.ensure(act.req.rid, pos + 1)

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
        self._ensure_decode_pages()
        groups = self._width_split()
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
