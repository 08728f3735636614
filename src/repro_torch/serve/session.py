"""DecodeSession of the port: weights + a cache layout behind one API.

The counterpart of ``repro.serve.session.DecodeSession`` for both
layouts, paged (:class:`~repro_torch.serve.kv_cache.PagedLayout`) and
dense slot rows (:class:`~repro_torch.serve.kv_cache.SlotLayout`):

  ``prefill(rid, prompt, bucket)``  the whole prompt into rid's pages or
                                    slot row: exact length on paged pools
                                    (any stack); on dense rows right-padded
                                    to ``bucket`` (attention-only stacks;
                                    None = exact length, the recurrent ones)
  ``prefill_batch(tokens)``         one uniform batch into every slot row
                                    (dense; the engine's path)
  ``prefill_chunk(rid, ...)``       one chunked-prefill slice into rid's pages
                                    (paged, attention-only stacks)
  ``step(tokens, index, ...)``      K >= 1 tokens per row, either layout
  ``draft_block(tok0, ...)``        the fused drafter round: ``steps``
                                    single-token decodes in one call, each
                                    fed the last one's greedy argmax
  ``snapshot() / restore(...)``     recurrent-state rollback

Host arrays (numpy) go in; the session uploads them to the layout's
device, runs :func:`repro_torch.models.lm.lm_prefill_exact` /
:func:`~repro_torch.models.lm.lm_prefill_dense` /
:func:`~repro_torch.models.lm.lm_prefill` /
:func:`~repro_torch.models.lm.lm_decode`, which write the pools and rows
in place (a dense prefill's cache is copied into its rows by the layout),
and hands back logits.  The JAX session instead donates the cache pytree
to a jitted step and rebinds the returned one.

:class:`MeshDecodeSession` is the serving mesh's session (JAX's
``repro.serve.mesh.MeshDecodeSession``): over a pool split into data
shards, its decode and verify steps read attention once a shard over that
shard's sub-pool, and it refuses the explicit-tables subset step.  On a
mesh with ``model`` > 1 its model is the rank's tensor-parallel shard
(:mod:`repro_torch.parallel.tensor`) and its pools hold the rank's kv
heads; the steps are the same calls.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.parallel.tensor import tensor_parallel
from repro_torch.serve.kv_cache import CacheLayout, PagedLayout


def _upload(a, dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


class DecodeSession:
    """Model weights + a cache layout (:class:`PagedLayout` or
    :class:`~repro_torch.serve.kv_cache.SlotLayout`), driven through one
    API; ``paged`` says which."""

    # data shards the decode attention reads the pool in (the mesh
    # session's are its layout's)
    shards = 1

    def __init__(self, cfg: ModelConfig, model: lm.LM, layout: CacheLayout):
        if model.device != layout.device:
            raise ValueError(f"model weights on {model.device} but the KV "
                             f"pools on {layout.device}")
        self.cfg = cfg
        self.model = model
        self.layout = layout

    @property
    def paged(self) -> bool:
        """True when the KV cache is the paged (scattered-page) layout."""
        return isinstance(self.layout, PagedLayout)

    @property
    def device(self) -> torch.device:
        """Device the weights and pools live on."""
        return self.layout.device

    def set_params(self, params) -> None:
        """Hot-swap the weights between steps: ``params`` is a state dict
        in the port's layout (``{name: tensor}``, any device and dtype),
        copied into the model on its device in its dtype (on a
        tensor-parallel shard, first cut to this rank's slices).  The
        cache layout depends only on the config, so the pools stay."""
        tp = tensor_parallel(self.model)
        if tp is not None:
            params = tp.plan.shard_state(params, tp.rank)
        with torch.no_grad():
            self.model.load_state_dict(params, strict=True)

    def prefill(self, rid, prompt: np.ndarray,
                bucket: Optional[int] = None) -> np.ndarray:
        """The whole prompt of `rid`, written into its pages or slot row.
        Returns the last real token's logits row (V,) as float32 on the
        host.

        Paged pools take it at its exact length (no padding: a recurrent
        layer would fold padding into its state).  Dense rows take it
        right-padded to ``bucket`` (attention-only stacks; the pad K/V
        past the prompt stay in the row, hidden by the causal mask until
        decode overwrites them) or, with ``bucket=None``, at its exact
        length (the recurrent families), as the JAX session does.
        """
        P = int(len(prompt))
        if not self.paged:
            toks = np.zeros((1, bucket or P), np.int64)
            toks[0, :P] = prompt
            logits, cache = lm.lm_prefill_dense(
                self.model, _upload(toks, np.int64, self.device),
                torch.tensor([P - 1], device=self.device))
            self.layout.insert(rid, cache)
            return logits[0, -1].float().cpu().numpy()
        self.layout.ensure(rid, P)
        slot = self.layout.slot_of(rid)
        width = self.layout.table_width_for(P)
        tables = _upload(self.layout.tables[slot:slot + 1, :width],
                         np.int32, self.device)
        logits = lm.lm_prefill_exact(
            self.model, _upload(np.asarray(prompt)[None], np.int64,
                                self.device),
            self.layout.cache, tables, slot)
        return logits[0, -1].float().cpu().numpy()

    def prefill_batch(self, tokens: np.ndarray) -> torch.Tensor:
        """A uniform-length batch (B = num_slots, S) prefilled into every
        slot row (the engine's path; dense rows only).  Returns logits
        (B, 1, V) at each row's last position, on the device."""
        logits, cache = lm.lm_prefill_dense(
            self.model, _upload(tokens, np.int64, self.device))
        self.layout.insert_batch(cache)
        return logits

    def prefill_chunk(self, rid, chunk: np.ndarray, hist_len: int,
                      prompt_len: int, chunk_bucket: int,
                      width: int) -> np.ndarray:
        """One chunked-prefill slice scattered into `rid`'s pages.

        chunk: the real tokens of this slice (right-padded to
        ``chunk_bucket`` here); hist_len: prompt tokens already
        prefilled; width: block-table columns to expose.  Returns the
        slice's last-real-token logits row (V,) as float32 on the host —
        only meaningful on the final slice.
        """
        n = int(len(chunk))
        toks = np.zeros((1, chunk_bucket), np.int64)
        toks[0, :n] = chunk
        slot = self.layout.slot_of(rid)
        tables = _upload(self.layout.tables[slot:slot + 1, :width],
                         np.int32, self.device)
        logits = lm.lm_prefill(self.model, _upload(toks, np.int64,
                                                   self.device),
                               self.layout.cache, tables, hist_len,
                               prompt_len, n - 1)
        return logits[0, -1].float().cpu().numpy()

    def step(self, tokens: np.ndarray, index: np.ndarray,
             valid: Optional[np.ndarray] = None,
             width: Optional[int] = None,
             tables: Optional[np.ndarray] = None) -> torch.Tensor:
        """One decode/verify step: K >= 1 tokens per row.

        tokens: (B, K) ints; index: (B,) first-token write positions (-1
        = idle row on paged pools, 0 on dense rows); valid: optional (B,)
        real-token counts; width: block-table columns of the layout's
        tables to expose; tables: an explicit (B, W) block-table array
        instead of the layout's (the ragged-split subset calls).  On dense
        rows ``width`` and ``tables`` are unused.  Returns logits (B, K,
        V) on the device (callers cast/copy).
        """
        dev = self.device
        if not self.paged:
            t = None
        elif tables is None:
            t = self.layout.step_tables(
                width if width is not None
                else self.layout.max_blocks_per_seq)
        else:
            t = _upload(tables, np.int32, dev)
        v = None if valid is None else _upload(valid, np.int64, dev)
        return lm.lm_decode(self.model, _upload(tokens, np.int64, dev),
                            self.layout.cache,
                            _upload(index, np.int64, dev), t, valid=v,
                            shards=self.shards)

    def draft_block(self, tok0: np.ndarray, index: np.ndarray, steps: int,
                    valid: Optional[np.ndarray] = None,
                    width: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fused drafter round (``_draft_unroll`` in JAX): ``steps``
        single-token :func:`~repro_torch.models.lm.lm_decode` calls in
        one Python call, each fed the previous step's greedy argmax on
        the device -- no host sync between steps; the tables, index and
        ``valid`` are uploaded once.

        tok0: (B, 1) each row's pending token; index: (B,) its write
        position (-1 = idle row on paged pools); valid: (B,) real steps
        per row (step t of row b writes to the null page, or on dense rows
        at a masked future position, and freezes its recurrent state when
        ``t >= valid[b]``); width: block-table columns (paged).  Returns
        (logits (B, steps, V), the tokens fed (B, steps)) on the device:
        the caller resamples proposals from the logits with each
        request's own sampling and repairs the rows where they differ
        from the greedy feed.
        """
        dev = self.device
        tables = None if not self.paged else self.layout.step_tables(
            width if width is not None else self.layout.max_blocks_per_seq)
        tok = _upload(tok0, np.int64, dev)
        idx = _upload(index, np.int64, dev)
        v = torch.full((tok.shape[0],), steps, dtype=torch.long,
                       device=dev) if valid is None \
            else _upload(valid, np.int64, dev)
        fed, logits_all = [], []
        for t in range(steps):
            valid_t = (v - t).clamp(0, 1)
            idx_t = torch.where(idx >= 0, idx + t, idx)
            logits = lm.lm_decode(self.model, tok, self.layout.cache, idx_t,
                                  tables, valid=valid_t, shards=self.shards)
            fed.append(tok[:, 0])
            logits_all.append(logits[:, 0])
            # greedy device feed; the host resamples from the logits
            tok = logits[:, 0].float().argmax(dim=-1)[:, None]
        return torch.stack(logits_all, dim=1), torch.stack(fed, dim=1)

    def snapshot(self) -> Tuple[torch.Tensor, ...]:
        """Copy of the recurrent rows (empty for attention-only stacks:
        their rollback is free)."""
        return self.layout.snapshot()

    def restore(self, snap: Tuple[torch.Tensor, ...], rows) -> None:
        """Roll the slots with ``rows[b]`` true back to ``snap``; pair
        with a ``valid``-masked replay :meth:`step` to rebuild the
        accepted prefix."""
        self.layout.restore(snap, rows)


class MeshDecodeSession(DecodeSession):
    """A :class:`DecodeSession` of the serving mesh
    (:mod:`repro_torch.serve.mesh`).

    Inside one process every data shard lives on the session's device:
    over a paged pool of ``data_shards`` sub-pools each decode and verify
    step reads attention once a shard, over that shard's sub-pool with its
    tables rebased (:func:`repro_torch.kernels.ops.paged_attention_sharded`),
    so no row reads another shard's pages.  Dense rows (the engine's
    :class:`~repro_torch.serve.kv_cache.SlotLayout`) are each their own
    and need no dispatch.  The row-subset step with explicit ``tables`` is
    refused, as in JAX: a subset of rows would leave its shards.
    """

    def __init__(self, cfg: ModelConfig, model: lm.LM, layout: CacheLayout):
        super().__init__(cfg, model, layout)
        self.shards = getattr(layout, "data_shards", 1)
        # the model group's collectives inside decode/verify steps (a
        # shard's; :attr:`TensorParallel.timing` counts every call)
        self.decode_collectives = {"calls": 0, "bytes": 0, "seconds": 0.0}

    def step(self, tokens: np.ndarray, index: np.ndarray,
             valid: Optional[np.ndarray] = None,
             width: Optional[int] = None,
             tables: Optional[np.ndarray] = None) -> torch.Tensor:
        """One full-batch decode/verify step (see :meth:`DecodeSession.step`);
        explicit ``tables`` raise."""
        if tables is not None:
            raise ValueError(
                "row-subset / explicit-table steps cannot run on the mesh "
                "(rows must stay in their data shard)")
        tp = tensor_parallel(self.model)
        if tp is None:
            return super().step(tokens, index, valid=valid, width=width)
        before = dict(tp.timing)
        out = super().step(tokens, index, valid=valid, width=width)
        for k in self.decode_collectives:
            self.decode_collectives[k] += tp.timing[k] - before[k]
        return out
