"""KV-cache management of the port: block accounting, page pools, slot rows.

The host-side accounting — :class:`BlockManager` (token-budget admission,
lazy page materialization, refcounts, pinning) and :class:`PageShard`
(the prefix cache: copy-on-admit sharing of fully filled prompt pages) —
is a copy of ``repro.serve.kv_cache``, the weight epoch that a hot swap
bumps (:meth:`PageShard.invalidate_prefix`) included.
:class:`PagedLayout` is the paged layout: one ``(num_pages + 1,
block_size, Hkv, D)`` pool per attention layer on the device (the last page
is the null page; split into ``data_shards`` sub-pools, each with its own
null page, on the serving mesh), ``num_slots`` dense state rows per
recurrent (Mamba / xLSTM) layer, and host-side numpy block tables,
uploaded to the device for each step.  Decode and prefill write the pools
and rows in place.  :meth:`PagedLayout.snapshot` and
:meth:`PagedLayout.restore` copy the recurrent rows out and masked back
in per slot, the rollback of speculative decoding.  Both come from
:class:`CacheLayout`, the surface the session is written against, which
:class:`SlotLayout` shares: the dense layout of ``num_slots`` contiguous
``max_len`` rows per attention layer, its pages bookkeeping only.
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

    def allocate(self, rid, n_tokens: int) -> List[int]:
        """Reserve AND materialize pages for `n_tokens` (eager; the
        dense layout's bookkeeping).  Raises if rid is live or over
        budget."""
        if rid in self._tables:
            raise ValueError(f"request {rid!r} already holds blocks")
        need = blocks_for(n_tokens, self.block_size)
        if not self.can_allocate(n_tokens):
            raise RuntimeError(
                f"out of cache blocks: need {need}, "
                f"available {self.available_blocks}")
        self._tables[rid] = []
        self._pending[rid] = need
        return self._claim(rid, need)

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
    """Host-side accounting of one page pool: a :class:`BlockManager` over
    shard-local page ids plus the prefix cache (copy-on-admit sharing of
    fully filled prompt pages, optional pinning).  The single-shard
    :class:`PagedLayout` holds one; a sharded one (the serving mesh's
    ``data`` axis) holds one per shard, each the private accountant of its
    slice of the pool.  ``offset`` is the shard's base in the global page
    ids block tables hold: local page ``p`` is global ``offset + p`` and
    the shard's null page is ``offset + num_pages``."""

    def __init__(self, num_pages: int, block_size: int,
                 pin_prefix: bool = False, offset: int = 0):
        self.blocks = BlockManager(num_pages, block_size)
        self.blocks.on_reclaim = self._evict
        self.null_page = num_pages              # local id
        self.offset = offset
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

    def probe_prefix(self, key_at, max_pages: int) -> List[int]:
        """Longest live prefix run in this shard, from chain keys derived
        outside (``key_at(i)``: the key of page i), so a sharded layout
        hashes a prompt once for every shard's probe."""
        pages = []
        for i in range(max_pages):
            page = self._prefix.get(key_at(i))
            if page is None or self.blocks.refcount(page) == 0:
                break
            pages.append(page)
        return pages

    def find_shared_prefix(self, prompt: np.ndarray
                           ) -> Tuple[List[int], int]:
        """Longest registered prefix of `prompt` in live local pages.

        Returns (page ids, shared token count).  Capped at
        ``len(prompt) - 1`` so at least one suffix token is always
        prefilled (its hidden state supplies the first sampled token).
        Keys are derived lazily page by page, so a miss on page 0 costs
        one chunk hash — this runs on every admission check.
        """
        bs = self.blocks.block_size
        pages = self.probe_prefix(_prefix_key_memo(prompt, bs),
                                  (len(prompt) - 1) // bs)
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



class CacheLayout:
    """The cache surface :class:`repro_torch.serve.session.DecodeSession`
    is written against (``repro.serve.kv_cache.CacheLayout``), shared by
    the paged and the dense layout: the per-layer ``cache`` on ``device``
    (:func:`repro_torch.models.lm.init_cache`), slot bookkeeping
    (``admit`` / ``release`` / ``slot_of``), and ``snapshot`` /
    ``restore`` of the recurrent rows, the rollback of speculative
    decoding (attention K/V needs none: a stale tail position is causally
    masked until it is overwritten).  Page accounting is the subclass's
    :class:`BlockManager`."""

    def _init_layout(self, cfg: ModelConfig, num_slots: int,
                     cache: List[dict], device: torch.device) -> None:
        self.cfg = cfg
        self.device = device
        self.cache = cache
        self.has_recurrent = lm.has_recurrent(cfg)
        # the (layer, state name) of every per-slot recurrent leaf, in the
        # order snapshot() copies them
        self._rec_leaves = [(i, k) for i, s in enumerate(lm.layer_specs(cfg))
                            if s.kind in lm.RECURRENT
                            for k in sorted(self.cache[i])]
        self.num_slots = num_slots
        self._free_slots = list(range(num_slots))
        self._slot_of: Dict[Any, int] = {}

    @property
    def free_slots(self) -> int:
        """Decode slots not currently assigned to a request."""
        return len(self._free_slots)

    def slot_of(self, rid) -> int:
        """The decode-batch row assigned to ``rid``."""
        return self._slot_of[rid]

    def _pick_slot(self, slot: Optional[int]) -> int:
        """The slot an admission takes: ``slot`` when given (it must be
        free), else the last free one."""
        if not self._free_slots:
            raise RuntimeError("no free cache slots")
        if slot is None:
            return self._free_slots[-1]
        if slot not in self._free_slots:
            raise RuntimeError(f"cache slot {slot} is not free")
        return slot

    def _bind_slot(self, rid, slot: int) -> None:
        self._free_slots.remove(slot)
        self._slot_of[rid] = slot

    def _unbind_slot(self, rid) -> int:
        slot = self._slot_of.pop(rid)
        self._free_slots.append(slot)
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


class PagedLayout(CacheLayout):
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

    **Sharded mode** (``data_shards > 1``, the serving mesh's ``data``
    axis; ``repro.serve.kv_cache.PagedLayout`` with ``data_shards``):
    slots and pages split into ``data_shards`` equal groups; group i's
    slots map only group i's pages, each group is accounted by its own
    :class:`PageShard` (admission, prefix cache, pinning, reclaim), and
    each group ends with its own null page.  The pool is one ``(
    data_shards * (pps + 1), block_size, Hkv, D)`` tensor a layer in
    global id order, so shard i's sub-pool is the view ``[i * (pps + 1),
    (i + 1) * (pps + 1))``; block tables hold global ids ``offset +
    local``, which the sharded paged dispatch
    (:func:`repro_torch.kernels.ops.paged_attention_sharded`) rebases per
    shard, so no row reads another shard's pages.  A request's cap is its
    shard's capacity.
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, num_pages: int,
                 block_size: int = 16, max_seq: Optional[int] = None,
                 pin_prefix: bool = False, data_shards: int = 1,
                 device="cuda"):
        dev = resolve_device(device)
        self.block_size = block_size
        self.data_shards = int(data_shards)
        if num_slots % self.data_shards or num_pages % self.data_shards:
            raise ValueError(
                f"num_slots ({num_slots}) and num_pages ({num_pages}) "
                f"must be divisible by data_shards ({data_shards})")
        pps = num_pages // self.data_shards     # usable pages per shard
        self._slots_per_shard = num_slots // self.data_shards
        shard_tokens = pps * block_size
        self.max_seq = min(max_seq or shard_tokens, shard_tokens)
        self.max_blocks_per_seq = blocks_for(self.max_seq, block_size)
        self.shards = tuple(
            PageShard(pps, block_size, pin_prefix=pin_prefix,
                      offset=i * (pps + 1))
            for i in range(self.data_shards))
        # shard 0's null page: THE null page of the single-shard layout
        # (== num_pages); a sharded caller asks null_page_of(slot)
        self.null_page = pps
        total = self.data_shards * (pps + 1)
        self._init_layout(cfg, num_slots, lm.init_cache(
            cfg, pages=(total - 1, block_size), num_slots=num_slots,
            device=dev), dev)
        self.tables = np.empty((num_slots, self.max_blocks_per_seq),
                               np.int32)
        for s in range(num_slots):
            self.tables[s, :] = self.null_page_of(s)
        self._shard_of_rid: Dict[Any, int] = {}
        self._share_shard: Optional[int] = None
        # the pool-wide concurrent page peak (sharded mode): the sum of the
        # shards' high waters overstates it when they peak apart
        self._hw_total = 0

    # -- shard routing -----------------------------------------------------
    def shard_of_slot(self, slot: int) -> int:
        """The data shard whose sub-pool holds this slot's pages."""
        return slot // self._slots_per_shard

    def null_page_of(self, slot: int) -> int:
        """The global id of the slot's shard's null page, where its idle
        row points."""
        shard = self.shards[self.shard_of_slot(slot)]
        return shard.offset + shard.null_page

    @property
    def blocks(self) -> BlockManager:
        """Shard 0's page accountant: the pool's in the single-shard
        layout; in a sharded one the per-shard geometry (every shard has
        the same)."""
        return self.shards[0].blocks

    @property
    def prefix_hits(self) -> int:
        """Admissions that mapped shared prefix pages, over all shards."""
        return sum(s.prefix_hits for s in self.shards)

    @property
    def prefix_shared_tokens(self) -> int:
        """Prompt tokens served from shared prefix pages, all shards."""
        return sum(s.prefix_shared_tokens for s in self.shards)

    def _free_slots_in(self, shard_i: int) -> List[int]:
        lo = shard_i * self._slots_per_shard
        hi = lo + self._slots_per_shard
        return [s for s in self._free_slots if lo <= s < hi]

    def _choose_shard(self, n_tokens: int,
                      shared_pages: Sequence[int] = (),
                      hint: Optional[int] = None) -> Optional[int]:
        """The admission's shard: the prefix-hinted one when it still
        fits, else the free-slot shard with the most available pages
        (lowest index on ties); None when none fits."""
        if hint is not None and self._free_slots_in(hint) and \
                self.shards[hint].blocks.can_allocate(
                    n_tokens, shared=shared_pages):
            return hint
        best, best_avail = None, -1
        for i, shard in enumerate(self.shards):
            if not self._free_slots_in(i):
                continue
            if not shard.blocks.can_allocate(n_tokens):
                continue
            if shard.blocks.available_blocks > best_avail:
                best, best_avail = i, shard.blocks.available_blocks
        return best

    def peek_shard(self, n_tokens: int,
                   shared_pages: Sequence[int] = ()) -> Optional[int]:
        """The shard :meth:`admit` would pick now, with no change: the
        mesh scheduler checks the drafter's mirror pool in that shard
        before it admits."""
        hint = self._share_shard if shared_pages else None
        return self._choose_shard(n_tokens, shared_pages, hint)

    def find_shared_prefix(self, prompt: np.ndarray
                           ) -> Tuple[List[int], int]:
        """Longest registered prefix of ``prompt`` over the shards an
        admission could land in: (local page ids of the best shard,
        tokens); the shard is kept for the admit that follows.  The chain
        keys are derived once for every shard's probe."""
        bs = self.block_size
        max_pages = (len(prompt) - 1) // bs
        key_at = _prefix_key_memo(prompt, bs)
        best, best_shard = ([], 0), None
        for i, shard in enumerate(self.shards):
            if self.data_shards > 1 and not self._free_slots_in(i):
                continue        # a match in a slot-full shard is unusable
            pages = shard.probe_prefix(key_at, max_pages)
            if len(pages) * bs > best[1]:
                best, best_shard = (pages, len(pages) * bs), i
        self._share_shard = best_shard if best[0] else None
        return best

    def register_prefix(self, rid, prompt: np.ndarray) -> None:
        """Publish ``rid``'s fully filled prompt pages to its shard's
        prefix cache."""
        self.shards[self._shard_of_rid[rid]].register_prefix(rid, prompt)

    def invalidate_prefix(self) -> None:
        """Flush every shard's prefix cache and pins (hot swap; see
        :meth:`PageShard.invalidate_prefix`)."""
        for shard in self.shards:
            shard.invalidate_prefix()

    def step_tables(self, width: int) -> torch.Tensor:
        """The first ``width`` block-table columns of every slot, uploaded
        to the device as int32 (the decode step's tables)."""
        return torch.from_numpy(
            np.ascontiguousarray(self.tables[:, :width])).to(self.device)

    def can_admit(self, n_tokens: int,
                  shared_pages: Sequence[int] = ()) -> bool:
        """Can some shard hold ``n_tokens`` (given ``shared_pages``
        already mapped) with a free slot to go with it?"""
        if not self._free_slots or n_tokens > self.max_seq:
            return False
        hint = self._share_shard if shared_pages else None
        return self._choose_shard(n_tokens, shared_pages, hint) is not None

    def admit(self, rid, n_tokens: int,
              prompt: Optional[np.ndarray] = None,
              shared: Optional[Tuple[List[int], int]] = None,
              slot: Optional[int] = None) -> Tuple[int, int]:
        """Claim a slot + a token-budget reservation for `rid`.

        With `prompt` given, maps any prefix-cached pages into the new
        table (copy-on-admit sharing); pass ``shared`` to reuse a
        :meth:`find_shared_prefix` result the admission check already
        computed.  ``slot`` claims that free slot, and so its shard (a
        drafter's pool mirrors the target's rows); else the slot is the
        last free one of the shard :meth:`_choose_shard` picks.  Returns
        (slot, shared_len).
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
        hint = self._share_shard if shared_pages else None
        if slot is None:
            shard_i = self._choose_shard(n_tokens, shared_pages, hint)
            if shard_i is None:
                shard_i = self.shard_of_slot(self._free_slots[-1])
            slot = self._free_slots_in(shard_i)[-1]
        else:
            if slot not in self._free_slots:
                raise RuntimeError(f"cache slot {slot} is not free")
            shard_i = self.shard_of_slot(slot)
        if hint is not None and hint != shard_i:
            # the prefix lives in another shard's pool: unusable here
            shared_pages, shared_len = [], 0
        shard = self.shards[shard_i]
        shard.admit(rid, n_tokens, (shared_pages, shared_len))
        self._bind_slot(rid, slot)
        self._shard_of_rid[rid] = shard_i
        self.tables[slot, :] = self.null_page_of(slot)
        if shared_pages:
            self.tables[slot, :len(shared_pages)] = \
                shard.offset + np.asarray(shared_pages, np.int32)
        self._note_usage()
        return slot, shared_len

    def ensure(self, rid, n_tokens: int) -> None:
        """Materialize pages so `rid` can hold `n_tokens`; updates the
        slot's block table in place (global ids)."""
        slot = self._slot_of[rid]
        shard = self.shards[self._shard_of_rid[rid]]
        have = len(shard.blocks.table(rid))
        new = shard.blocks.ensure(rid, n_tokens)
        if new:
            self.tables[slot, have:have + len(new)] = \
                shard.offset + np.asarray(new, np.int32)
            self._note_usage()

    def _note_usage(self) -> None:
        if self.data_shards > 1:
            used = sum(s.blocks.used_blocks for s in self.shards)
            self._hw_total = max(self._hw_total, used)

    def release(self, rid) -> int:
        """Free `rid`'s slot + page refs; returns the freed slot."""
        slot = self._unbind_slot(rid)
        self.tables[slot, :] = self.null_page_of(slot)
        self.shards[self._shard_of_rid.pop(rid)].release(rid)
        return slot

    def table_width_for(self, max_tokens: int) -> int:
        """Block-table columns needed to cover `max_tokens`."""
        return min(self.max_blocks_per_seq,
                   blocks_for(max(max_tokens, 1), self.block_size))

    def as_dict(self) -> Dict[str, int]:
        """Pool summary: slot/prefix counters + the block accounting summed
        over shards, the high water the pool-wide concurrent peak (the
        keys and values of ``repro.serve.kv_cache.PagedLayout.as_dict``);
        :meth:`shard_dicts` has each shard's own."""
        d = {"num_slots": self.num_slots, "max_seq": self.max_seq,
             "free_slots": self.free_slots,
             "prefix_hits": self.prefix_hits,
             "prefix_shared_tokens": self.prefix_shared_tokens,
             "data_shards": self.data_shards}
        agg = self.shards[0].blocks.as_dict()
        for shard in self.shards[1:]:
            for k, v in shard.blocks.as_dict().items():
                if k != "block_size":
                    agg[k] += v
        if self.data_shards > 1:
            agg["high_water_blocks"] = self._hw_total
        return {**d, **agg}

    def shard_dicts(self) -> List[Dict[str, int]]:
        """Each shard's block accounting (``BlockManager.as_dict``), in
        shard order: the per-shard pool gauges of the Prometheus export."""
        return [shard.blocks.as_dict() for shard in self.shards]


class SlotLayout(CacheLayout):
    """One preallocated dense decode cache shared by all requests
    (``repro.serve.kv_cache.SlotLayout``, the serving benchmark's
    baseline layout).

    ``cache`` holds ``num_slots`` rows of ``max_len`` tokens per
    attention layer (``(num_slots, max_len, Hkv, D)``) and ``num_slots``
    state rows per recurrent layer, allocated once on ``device``; a
    request's cache is its contiguous slot row.  Pages are bookkeeping
    only (a :class:`BlockManager`, as in JAX), so ``as_dict`` reports
    the same counters.  :meth:`insert` / :meth:`insert_batch` copy a
    prefill cache (:func:`repro_torch.models.lm.lm_prefill_dense`) into
    one row or every row, zeroing what the prompt does not cover, as
    JAX pads its prefill cache to the row.
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 device="cuda"):
        dev = resolve_device(device)
        self.max_len = max_len
        self.blocks = BlockManager(
            num_blocks if num_blocks is not None
            else num_slots * blocks_for(max_len, block_size), block_size)
        self._init_layout(cfg, num_slots, lm.init_cache(
            cfg, num_slots=num_slots, max_len=max_len, device=dev), dev)

    def can_admit(self, n_tokens: int) -> bool:
        """Room for a request reserving ``n_tokens`` (prompt + max new)?"""
        return bool(self._free_slots) and n_tokens <= self.max_len \
            and self.blocks.can_allocate(n_tokens)

    def admit(self, rid, n_tokens: int, slot: Optional[int] = None) -> int:
        """Claim a slot + pages for ``rid``; returns the slot index.
        ``slot`` claims that free slot (a drafter's pool mirrors the
        target's rows)."""
        slot = self._pick_slot(slot)
        if n_tokens > self.max_len:
            raise ValueError(
                f"request needs {n_tokens} tokens > pool max_len "
                f"{self.max_len}")
        self.blocks.allocate(rid, n_tokens)
        self._bind_slot(rid, slot)
        return slot

    def _insert_rows(self, rows, prefill_cache: List[dict]) -> None:
        for leaf, new in zip(self.cache, prefill_cache):
            for name, src in new.items():
                dst = leaf[name]
                if name in ("k", "v"):
                    # attention K/V (B, L, Hkv, D) into rows of max_len:
                    # slot reuse must not leak the last occupant's tail
                    L = src.shape[1]
                    dst[rows, :L] = src.to(dst.dtype)
                    dst[rows, L:] = 0
                else:
                    dst[rows] = src.to(dst.dtype)

    def insert(self, rid, prefill_cache: List[dict]) -> None:
        """Overwrite ``rid``'s slot row with a (batch = 1) prefill cache."""
        slot = self._slot_of[rid]
        self._insert_rows(slice(slot, slot + 1), prefill_cache)

    def insert_batch(self, prefill_cache: List[dict]) -> None:
        """Overwrite every slot row with a (batch = num_slots) prefill
        cache: the engine's path, where one uniform-length batch fills
        the whole pool at once."""
        B = next(iter(prefill_cache[0].values())).shape[0]
        if B != self.num_slots:
            raise ValueError(f"a prefill of {B} rows into {self.num_slots} "
                             "slots")
        self._insert_rows(slice(None), prefill_cache)

    def release(self, rid) -> int:
        """Free ``rid``'s slot + pages; returns the freed slot index."""
        slot = self._unbind_slot(rid)
        self.blocks.free(rid)
        return slot

    def as_dict(self) -> Dict[str, int]:
        """Counters for the ``[serve] pool`` summary line (the keys of
        ``repro.serve.kv_cache.SlotLayout.as_dict``)."""
        return {"num_slots": self.num_slots, "max_len": self.max_len,
                "free_slots": self.free_slots, **self.blocks.as_dict()}
