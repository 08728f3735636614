"""DecodeSession of the port: weights + a paged layout behind two calls.

The counterpart of ``repro.serve.session.DecodeSession`` for the paged
layout and the dense family:

  ``prefill_chunk(rid, ...)``     one chunked-prefill slice into rid's pages
  ``step(tokens, index, ...)``    K >= 1 tokens per row over the pools

Host arrays (numpy) go in; the session uploads them to the layout's
device, runs :func:`repro_torch.models.lm.lm_prefill` /
:func:`~repro_torch.models.lm.lm_decode`, which write the pools in
place, and hands back logits.  The JAX session instead donates the cache
pytree to a jitted step and rebinds the returned one.
"""
from __future__ import annotations

from typing import Optional

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
