"""Paged KV-cache management of the port: block accounting + page pools.

The host-side accounting — :class:`BlockManager` (token-budget admission,
lazy page materialization, refcounts, pinning) and :class:`PageShard`
(the prefix cache: copy-on-admit sharing of fully filled prompt pages) —
is a copy of ``repro.serve.kv_cache``, the weight epoch that a hot swap
bumps (:meth:`PageShard.invalidate_prefix`) included.
:class:`PagedLayout` is the single-shard layout:
one ``(num_pages + 1, block_size, Hkv, D)`` pool per attention layer on the
device (the last page is the null page), ``num_slots`` dense state rows per
recurrent (Mamba / xLSTM) layer, and host-side numpy block tables,
uploaded to the device for each step.  Decode and prefill write the pools
and rows in place.  :meth:`PagedLayout.snapshot` and
:meth:`PagedLayout.restore` copy the recurrent rows out and masked back
in per slot, the rollback of speculative decoding.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Pages needed to hold `n_tokens` cache entries."""
    return max(1, -(-int(n_tokens) // int(block_size)))


@dataclass
class BlockManager:
    """Token-budget page accounting over a fixed pool of cache blocks."""

    num_blocks: int
    block_size: int
    _free: List[int] = field(default_factory=list)
    _tables: Dict[Any, List[int]] = field(default_factory=dict)
    # pages a request may still claim from the free list (its
    # reservation minus what it has already materialized); admission
    # budgets against free - sum(_pending), so shared pages cost the
    # pool ONCE no matter how many tables map them — that is the
    # prefix-sharing capacity win
    _pending: Dict[Any, int] = field(default_factory=dict)
    _refs: Dict[int, int] = field(default_factory=dict)
    # eviction-priority tier: pages held alive ONLY by a pin (insertion
    # order = pin age); reclaimed oldest-first under allocation
    # pressure, with ``on_reclaim`` notifying the owner (prefix cache)
    _pinned: Dict[int, None] = field(default_factory=dict)
    on_reclaim: Optional[Callable[[List[int]], None]] = None
    high_water: int = 0
    allocs: int = 0
    frees: int = 0
    reclaims: int = 0

    def __post_init__(self):
        self._free = list(range(self.num_blocks))

    @property
    def used_blocks(self) -> int:
        """Pages materialized to some request (incl. pinned/shared)."""
        return self.num_blocks - len(self._free)

    @property
    def pending_blocks(self) -> int:
        """Free-list pages promised to live requests but not yet
        materialized (lazy allocation)."""
        return sum(self._pending.values())

    @property
    def committed_blocks(self) -> int:
        """Blocks spoken for: materialized + promised."""
        return self.used_blocks + self.pending_blocks

    @property
    def reclaimable_blocks(self) -> int:
        """Pinned pages with no live holder — the eviction-priority
        tier: counted as capacity for admission, stolen only when the
        free list runs dry."""
        return sum(1 for b in self._pinned if self._refs.get(b) == 1)

    @property
    def available_blocks(self) -> int:
        """Pages an admission may budget against: free-list pages not
        promised to anyone, plus idle pinned pages (reclaimable)."""
        return len(self._free) + self.reclaimable_blocks \
            - self.pending_blocks

    def table(self, rid) -> List[int]:
        """The request's page table: global page ids, in order."""
        return list(self._tables[rid])

    def _lost_reclaimable(self, shared: Sequence[int]) -> int:
        """Idle pinned pages in `shared`: mapping them refcounts them to
        2, so they stop being reclaimable — admission must not count
        them BOTH as free prefix pages and as reclaimable capacity."""
        return sum(1 for b in set(shared)
                   if b in self._pinned and self._refs.get(b) == 1)

    def can_allocate(self, n_tokens: int,
                     shared: Sequence[int] = ()) -> bool:
        """Would an allocation of ``n_tokens`` (minus ``shared`` prefix
        pages) fit the available capacity right now?"""
        need = blocks_for(n_tokens, self.block_size) - len(shared)
        return need <= self.available_blocks \
            - self._lost_reclaimable(shared)

    # -- pinning (prefix residency) ----------------------------------------
    def pin(self, page: int) -> None:
        """Keep `page` resident after its last holder releases it (an
        extra refcount held by the pin)."""
        if page not in self._pinned and page in self._refs:
            self._refs[page] += 1
            self._pinned[page] = None

    def unpin_all(self) -> List[int]:
        """Drop every pin; returns the pages that hit refcount zero
        (returned to the free list) -- the hot-swap flush path."""
        released = []
        for page in list(self._pinned):
            self._refs[page] -= 1
            if self._refs[page] == 0:
                del self._refs[page]
                self._free.append(page)
                released.append(page)
        self._pinned.clear()
        self.frees += len(released)
        return released

    def _reclaim(self, n: int) -> None:
        """Steal `n` idle pinned pages (oldest pin first) back onto the
        free list; the owner is told via ``on_reclaim`` so it can drop
        the pages from its prefix cache.  Candidates are collected
        BEFORE any mutation, so an insufficient tier raises with the
        pin bookkeeping (and the owner's prefix cache) fully intact."""
        taken = [page for page in self._pinned
                 if self._refs.get(page) == 1][:n]
        if len(taken) < n:
            raise RuntimeError(
                f"out of cache blocks: need {n - len(taken)} more, "
                f"free {len(self._free)}")
        for page in taken:
            del self._pinned[page]
            del self._refs[page]
            self._free.append(page)
        self.reclaims += len(taken)
        if self.on_reclaim is not None:
            self.on_reclaim(taken)

    def _claim(self, rid, n: int) -> List[int]:
        if n > len(self._free):
            self._reclaim(n - len(self._free))
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._refs[b] = 1
        self._tables[rid].extend(got)
        self._pending[rid] -= n
        self.allocs += n
        self.high_water = max(self.high_water, self.used_blocks)
        return got

    def reserve(self, rid, n_tokens: int,
                shared: Sequence[int] = ()) -> None:
        """Budget `n_tokens` for `rid`, mapping `shared` pages (already
        live, refcounted up) as its first pages; the rest materialize
        lazily via :meth:`ensure`.  Shared pages are free — they are
        someone's materialized pages already."""
        if rid in self._tables:
            raise ValueError(f"request {rid!r} already holds blocks")
        need = blocks_for(n_tokens, self.block_size) - len(shared)
        # refcounting the shared pages removes any idle pinned ones
        # from the reclaim tier — budget as if that already happened
        usable = self.available_blocks - self._lost_reclaimable(shared)
        if need > usable:
            raise RuntimeError(
                f"out of cache blocks: need {need}, available {usable}")
        for b in shared:
            self._refs[b] += 1
        self._tables[rid] = list(shared)
        self._pending[rid] = need
        self.high_water = max(self.high_water, self.used_blocks)

    def ensure(self, rid, n_tokens: int) -> List[int]:
        """Materialize physical pages so `rid` can hold `n_tokens`;
        returns the newly claimed page ids (page-overflow allocation).
        Growing past the reservation raises — the scheduler budgets
        prompt + max_new up front precisely so this cannot happen."""
        have = self._tables[rid]
        need = blocks_for(n_tokens, self.block_size) - len(have)
        if need <= 0:
            return []
        if need > self._pending[rid]:
            raise RuntimeError(
                f"request {rid!r} overflows its reservation "
                f"({len(have) + self._pending[rid]} blocks)")
        return self._claim(rid, need)

    def free(self, rid) -> List[int]:
        """Release `rid`'s pages; returns the page ids whose refcount
        hit zero (returned to the free list)."""
        blocks = self._tables.pop(rid)
        self._pending.pop(rid)
        released = []
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)
                released.append(b)
        self.frees += len(released)
        return released

    def refcount(self, page: int) -> int:
        """Number of page tables (plus pins) referencing ``page``."""
        return self._refs.get(page, 0)

    def as_dict(self) -> Dict[str, int]:
        """Counters for the ``[serve] pool`` summary line."""
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "used_blocks": self.used_blocks,
                "committed_blocks": self.committed_blocks,
                "pinned_blocks": len(self._pinned),
                "block_reclaims": self.reclaims,
                "high_water_blocks": self.high_water,
                "block_allocs": self.allocs, "block_frees": self.frees}



class PageShard:
    """Host-side accounting of one page pool: a :class:`BlockManager` plus
    the prefix cache (copy-on-admit sharing of fully filled prompt pages,
    optional pinning)."""

    def __init__(self, num_pages: int, block_size: int,
                 pin_prefix: bool = False):
        self.blocks = BlockManager(num_pages, block_size)
        self.blocks.on_reclaim = self._evict
        self.null_page = num_pages
        self.pin_prefix = bool(pin_prefix)
        # prefix cache: chained token-chunk key -> canonical physical
        # page, plus every live page known to hold that content (a
        # follower that prefilled its own copy before the prefix was
        # registered is still a valid donor once the original dies)
        self._prefix: Dict[Any, int] = {}
        self._key_pages: Dict[Any, set] = {}
        self._page_key: Dict[int, Any] = {}
        # per-rid incremental registration cursor: (pages done, last key)
        self._reg_state: Dict[Any, Tuple[int, Any]] = {}
        # weight epoch: bumped by invalidate_prefix() on hot swap so pages
        # computed under old weights are never shared forward
        self._epoch = 0
        self._admit_epoch: Dict[Any, int] = {}
        self.prefix_hits = 0
        self.prefix_shared_tokens = 0

    # -- prefix sharing ----------------------------------------------------
    @staticmethod
    def _chunk_keys(prompt: np.ndarray, block_size: int, start: int = 0,
                    prev=None):
        """Chained keys for fully-filled prompt pages ``start..``: key_i
        commits to ALL tokens up to and including page i (so equal keys
        mean equal prefixes, not just equal pages).  ``prev`` must be
        the chain key of page ``start - 1`` when resuming."""
        keys = []
        for i in range(start, len(prompt) // block_size):
            chunk = tuple(int(t) for t in
                          prompt[i * block_size:(i + 1) * block_size])
            prev = (prev, chunk)
            keys.append(prev)
        return keys

    def find_shared_prefix(self, prompt: np.ndarray
                           ) -> Tuple[List[int], int]:
        """Longest registered prefix of `prompt` in live pages.

        Returns (page ids, shared token count).  Capped at
        ``len(prompt) - 1`` so at least one suffix token is always
        prefilled (its hidden state supplies the first sampled token).
        Keys are derived lazily page by page, so a miss on page 0 costs
        one chunk hash — this runs on every admission check.
        """
        bs = self.blocks.block_size
        key_at = _prefix_key_memo(prompt, bs)
        pages = []
        for i in range((len(prompt) - 1) // bs):
            page = self._prefix.get(key_at(i))
            if page is None or self.blocks.refcount(page) == 0:
                break
            pages.append(page)
        return pages, len(pages) * bs

    def admit(self, rid, n_tokens: int,
              shared: Tuple[List[int], int]) -> None:
        """Page-budget side of an admission: reserve ``n_tokens`` with
        ``shared`` (prefix pages) mapped in, stamp the weight epoch, and
        resume the registration cursor past the shared pages."""
        shared_pages, shared_len = shared
        self.blocks.reserve(rid, n_tokens, shared=shared_pages)
        self._admit_epoch[rid] = self._epoch
        if shared_pages:
            self.prefix_hits += 1
            self.prefix_shared_tokens += shared_len
            # registration resumes after the shared pages — their keys
            # are already in the cache
            self._reg_state[rid] = (len(shared_pages),
                                    self._page_key[shared_pages[-1]])

    def register_prefix(self, rid, prompt: np.ndarray) -> None:
        """Offer `rid`'s fully-filled prompt pages to future requests.

        Incremental: per-chunk calls during chunked prefill only hash
        the pages filled since the last call, resuming the key chain
        instead of re-deriving it from page 0 every time.  Requests
        admitted before the last weight swap are refused: their pages (or
        their pages' attention context) came from the old weights.
        """
        if self._admit_epoch.get(rid, -1) != self._epoch:
            return
        table = self.blocks.table(rid)
        start, prev = self._reg_state.get(rid, (0, None))
        keys = self._chunk_keys(prompt, self.blocks.block_size,
                                start=start, prev=prev)
        for i, key in zip(range(start, start + len(keys)), keys):
            if i >= len(table):
                break
            page = table[i]
            if self._page_key.get(page) != key:
                self._page_key[page] = key
                self._key_pages.setdefault(key, set()).add(page)
                self._prefix.setdefault(key, page)
            if self.pin_prefix:
                # eviction-priority residency: the page survives its
                # holders (reclaimed oldest-first under pressure)
                self.blocks.pin(page)
            self._reg_state[rid] = (i + 1, key)

    def _evict(self, released_pages: List[int]) -> None:
        """Drop freed pages from the prefix cache; if a freed page was
        the canonical holder of its key, re-point the key at another
        live copy before giving up on it."""
        for page in released_pages:
            key = self._page_key.pop(page, None)
            if key is None:
                continue
            copies = self._key_pages.get(key, set())
            copies.discard(page)
            if self._prefix.get(key) == page:
                if copies:
                    self._prefix[key] = next(iter(copies))
                else:
                    self._prefix.pop(key, None)
            if not copies:
                self._key_pages.pop(key, None)

    def release(self, rid) -> None:
        """Drop the request's pages (prefix-shared ones survive as
        cache entries until evicted or invalidated)."""
        self._reg_state.pop(rid, None)
        self._admit_epoch.pop(rid, None)
        self._evict(self.blocks.free(rid))

    def invalidate_prefix(self) -> None:
        """Flush the prefix cache (hot swap): pages computed under the old
        weights must not be mapped into post-swap admissions, and
        still-prefilling pre-swap requests stop registering (their
        remaining chunks attend over old-weight history).  Pins die with
        the index.  Live tables and refcounts are untouched."""
        self._prefix.clear()
        self._key_pages.clear()
        self._page_key.clear()
        self.blocks.unpin_all()
        self._epoch += 1


def _prefix_key_memo(prompt: np.ndarray, block_size: int):
    """Lazy chain-key supplier for ``prompt``: ``key_at(i)`` hashes
    chunks only up to page i, memoized — a page-0 miss costs one hash."""
    keys: List[Any] = []

    def key_at(i: int):
        while len(keys) <= i:
            j = len(keys)
            prev = keys[-1] if keys else None
            chunk = tuple(int(t) for t in
                          prompt[j * block_size:(j + 1) * block_size])
            keys.append((prev, chunk))
        return keys[i]

    return key_at



class PagedLayout:
    """Paged decode cache on one device: page pools + per-slot tables.

    ``num_slots`` bounds the decode batch width; memory capacity is
    ``num_pages * block_size`` tokens shared by every request.
    ``max_seq`` caps a single request (it sizes the block-table width)
    and defaults to the whole pool.  With ``pin_prefix=True`` registered
    prompt pages stay resident after their holders release (reclaimed
    oldest-first under pressure).  ``cache`` is a list of per-layer
    entries on ``device`` (:func:`repro_torch.models.lm.init_cache`):
    ``{"k", "v"}`` pools for attention layers and ``num_slots`` state rows
    for recurrent ones, row ``slot`` belonging to the request in that
    slot.  A pure-recurrent stack (xLSTM) holds no pools at all; its page
    accounting still runs, as in JAX.  ``tables`` (num_slots,
    max_blocks_per_seq) int32 lives on the host, idle rows pointing at the
    null page.  The one-shot prefill writes a request's pages and its slot
    row in place (:func:`~repro_torch.models.lm.lm_prefill_exact`), where
    the JAX layout scatters a dense prefill cache (``insert_prefill``).
    ``snapshot`` / ``restore`` roll the recurrent rows back per slot
    (attention K/V needs no rollback: a stale tail position is causally
    masked until it is overwritten).
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, num_pages: int,
                 block_size: int = 16, max_seq: Optional[int] = None,
                 pin_prefix: bool = False, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.block_size = block_size
        pool_tokens = num_pages * block_size
        self.max_seq = min(max_seq or pool_tokens, pool_tokens)
        self.max_blocks_per_seq = blocks_for(self.max_seq, block_size)
        self.shard = PageShard(num_pages, block_size, pin_prefix=pin_prefix)
        self.null_page = num_pages
        self.cache = lm.init_cache(cfg, pages=(num_pages, block_size),
                                   num_slots=num_slots, device=self.device)
        self.has_recurrent = lm.has_recurrent(cfg)
        # the (layer, state name) of every per-slot recurrent leaf, in the
        # order snapshot() copies them
        self._rec_leaves = [(i, k) for i, s in enumerate(lm.layer_specs(cfg))
                            if s.kind in lm.RECURRENT
                            for k in sorted(self.cache[i])]
        self.num_slots = num_slots
        self._free_slots = list(range(num_slots))
        self._slot_of: Dict[Any, int] = {}
        self.tables = np.full((num_slots, self.max_blocks_per_seq),
                              self.null_page, np.int32)

    @property
    def free_slots(self) -> int:
        """Decode slots not currently assigned to a request."""
        return len(self._free_slots)

    def slot_of(self, rid) -> int:
        """The decode-batch row assigned to ``rid``."""
        return self._slot_of[rid]

    @property
    def blocks(self) -> BlockManager:
        """The pool's page accountant."""
        return self.shard.blocks

    @property
    def prefix_hits(self) -> int:
        """Admissions that mapped shared prefix pages."""
        return self.shard.prefix_hits

    @property
    def prefix_shared_tokens(self) -> int:
        """Prompt tokens served from shared prefix pages."""
        return self.shard.prefix_shared_tokens

    def find_shared_prefix(self, prompt: np.ndarray
                           ) -> Tuple[List[int], int]:
        """Longest registered prefix of ``prompt`` (page ids, tokens)."""
        return self.shard.find_shared_prefix(prompt)

    def register_prefix(self, rid, prompt: np.ndarray) -> None:
        """Publish ``rid``'s fully filled prompt pages to the prefix cache."""
        self.shard.register_prefix(rid, prompt)

    def invalidate_prefix(self) -> None:
        """Flush the prefix cache and its pins (hot swap; see
        :meth:`PageShard.invalidate_prefix`)."""
        self.shard.invalidate_prefix()

    def step_tables(self, width: int) -> torch.Tensor:
        """The first ``width`` block-table columns of every slot, uploaded
        to the device as int32 (the decode step's tables)."""
        return torch.from_numpy(
            np.ascontiguousarray(self.tables[:, :width])).to(self.device)

    def can_admit(self, n_tokens: int,
                  shared_pages: Sequence[int] = ()) -> bool:
        """Is there a free slot and room for ``n_tokens`` (given
        ``shared_pages`` already mapped)?"""
        if not self._free_slots or n_tokens > self.max_seq:
            return False
        blocks = self.shard.blocks
        return blocks.can_allocate(n_tokens, shared=shared_pages) \
            or blocks.can_allocate(n_tokens)

    def admit(self, rid, n_tokens: int,
              prompt: Optional[np.ndarray] = None,
              shared: Optional[Tuple[List[int], int]] = None,
              slot: Optional[int] = None) -> Tuple[int, int]:
        """Claim a slot + a token-budget reservation for `rid`.

        With `prompt` given, maps any prefix-cached pages into the new
        table (copy-on-admit sharing); pass ``shared`` to reuse a
        :meth:`find_shared_prefix` result the admission check already
        computed.  ``slot`` claims that free slot (a drafter's pool
        mirrors the target's rows).  Returns (slot, shared_len).
        """
        if not self._free_slots:
            raise RuntimeError("no free cache slots")
        if n_tokens > self.max_seq:
            raise ValueError(
                f"request needs {n_tokens} tokens > pool max_seq "
                f"{self.max_seq}")
        if shared is None:
            shared = ([], 0) if prompt is None else \
                self.find_shared_prefix(prompt)
        shared_pages, shared_len = shared
        if slot is None:
            slot = self._free_slots[-1]
        elif slot not in self._free_slots:
            raise RuntimeError(f"cache slot {slot} is not free")
        self.shard.admit(rid, n_tokens, (shared_pages, shared_len))
        self._free_slots.remove(slot)
        self._slot_of[rid] = slot
        self.tables[slot, :] = self.null_page
        if shared_pages:
            self.tables[slot, :len(shared_pages)] = shared_pages
        return slot, shared_len

    def ensure(self, rid, n_tokens: int) -> None:
        """Materialize pages so `rid` can hold `n_tokens`; updates the
        slot's block table in place."""
        slot = self._slot_of[rid]
        have = len(self.shard.blocks.table(rid))
        new = self.shard.blocks.ensure(rid, n_tokens)
        if new:
            self.tables[slot, have:have + len(new)] = new

    def release(self, rid) -> int:
        """Free `rid`'s slot + page refs; returns the freed slot."""
        slot = self._slot_of.pop(rid)
        self._free_slots.append(slot)
        self.tables[slot, :] = self.null_page
        self.shard.release(rid)
        return slot

    def snapshot(self) -> Tuple[torch.Tensor, ...]:
        """Copies (``clone``, never views: a decode step writes the rows in
        place) of every recurrent layer's per-slot state; empty for an
        attention-only stack, whose rollback is free."""
        return tuple(self.cache[i][k].clone() for i, k in self._rec_leaves)

    def restore(self, snap: Tuple[torch.Tensor, ...], rows) -> None:
        """Roll the slots with ``rows[b]`` true back to ``snap`` (a
        :meth:`snapshot`); the other rows keep their state."""
        if not snap:
            return
        mask = torch.from_numpy(np.asarray(rows, bool)).to(self.device)
        for (i, k), saved in zip(self._rec_leaves, snap):
            leaf = self.cache[i][k]
            sel = mask.view((-1,) + (1,) * (leaf.dim() - 1))
            leaf.copy_(torch.where(sel, saved, leaf))

    def table_width_for(self, max_tokens: int) -> int:
        """Block-table columns needed to cover `max_tokens`."""
        return min(self.max_blocks_per_seq,
                   blocks_for(max(max_tokens, 1), self.block_size))

    def as_dict(self) -> Dict[str, int]:
        """Pool summary: slot/prefix counters + block accounting (the
        same keys as ``repro.serve.kv_cache.PagedLayout.as_dict``)."""
        return {"num_slots": self.num_slots, "max_seq": self.max_seq,
                "free_slots": self.free_slots,
                "prefix_hits": self.prefix_hits,
                "prefix_shared_tokens": self.prefix_shared_tokens,
                "data_shards": 1, **self.shard.blocks.as_dict()}
