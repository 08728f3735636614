"""DecodeSession of the port: weights + a paged layout behind two calls.

The counterpart of ``repro.serve.session.DecodeSession`` for the paged
layout:

  ``prefill(rid, prompt)``        the whole prompt at exact length into
                                  rid's pages and slot row (any stack)
  ``prefill_chunk(rid, ...)``     one chunked-prefill slice into rid's pages
                                  (attention-only stacks)
  ``step(tokens, index, ...)``    K >= 1 tokens per row over the pools
  ``draft_block(tok0, ...)``      the fused drafter round: ``steps``
                                  single-token decodes in one call, each
                                  fed the last one's greedy argmax
  ``snapshot() / restore(...)``   recurrent-state rollback

Host arrays (numpy) go in; the session uploads them to the layout's
device, runs :func:`repro_torch.models.lm.lm_prefill_exact` /
:func:`~repro_torch.models.lm.lm_prefill` /
:func:`~repro_torch.models.lm.lm_decode`, which write the pools and state
rows in place, and hands back logits.  The JAX session instead donates the cache
pytree to a jitted step and rebinds the returned one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serve.kv_cache import PagedLayout


def _upload(a, dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


class DecodeSession:
    """Model weights + a :class:`PagedLayout`, driven through one API."""

    def __init__(self, cfg: ModelConfig, model: lm.LM, layout: PagedLayout):
        if model.device != layout.device:
            raise ValueError(f"model weights on {model.device} but the KV "
                             f"pools on {layout.device}")
        self.cfg = cfg
        self.model = model
        self.layout = layout

    @property
    def device(self) -> torch.device:
        """Device the weights and pools live on."""
        return self.layout.device

    def set_params(self, params) -> None:
        """Hot-swap the weights between steps: ``params`` is a state dict
        in the port's layout (``{name: tensor}``, any device and dtype),
        copied into the model on its device in its dtype.  The cache
        layout depends only on the config, so the pools stay."""
        with torch.no_grad():
            self.model.load_state_dict(params, strict=True)

    def prefill(self, rid, prompt: np.ndarray) -> np.ndarray:
        """The whole prompt of `rid` at its exact length (no padding: a
        recurrent layer would fold padding into its state), written into
        rid's pages and slot row.  Returns the last token's logits row
        (V,) as float32 on the host."""
        P = int(len(prompt))
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
        = idle row); valid: optional (B,) real-token counts; width:
        block-table columns of the layout's tables to expose; tables: an
        explicit (B, W) block-table array instead of the layout's (the
        ragged-split subset calls).  Returns logits (B, K, V) on the
        device (callers cast/copy).
        """
        dev = self.device
        if tables is None:
            t = self.layout.step_tables(
                width if width is not None
                else self.layout.max_blocks_per_seq)
        else:
            t = _upload(tables, np.int32, dev)
        v = None if valid is None else _upload(valid, np.int64, dev)
        return lm.lm_decode(self.model, _upload(tokens, np.int64, dev),
                            self.layout.cache,
                            _upload(index, np.int64, dev), t, valid=v)

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
        position (-1 = idle row); valid: (B,) real steps per row (step t
        of row b writes to the null page and freezes its recurrent state
        when ``t >= valid[b]``); width: block-table columns.  Returns
        (logits (B, steps, V), the tokens fed (B, steps)) on the device:
        the caller resamples proposals from the logits with each
        request's own sampling and repairs the rows where they differ
        from the greedy feed.
        """
        dev = self.device
        tables = self.layout.step_tables(
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
                                  tables, valid=valid_t)
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
