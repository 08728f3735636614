"""Batched serving engine of the port: one uniform batch, prefill + decode.

The counterpart of ``repro.serve.engine.Engine``: ``generate`` is a host
loop over ONE uniform-length batch on the same
:class:`~repro_torch.serve.session.DecodeSession` +
:class:`~repro_torch.serve.kv_cache.SlotLayout` surface the scheduler uses
with ``layout="dense"`` (no engine-private cache plumbing): the batch is
prefilled into every slot row at once, then decoded a token a step.  For
request-level serving (queueing, continuous batching, slot reuse, hot swap,
speculative decoding) use :class:`repro_torch.serve.scheduler.Scheduler`.

With ``mesh`` (a :class:`~repro_torch.serve.mesh.ServeMesh`) the batch's
session is the serving mesh's (:func:`repro_torch.serve.mesh.
make_engine_session`): dense slot rows whose batch divides into the
``data`` shards, as JAX's ``Engine(mesh=...)``; with ``model`` > 1 (a
rank of a job, :class:`~repro_torch.serve.mesh.ServeMesh`) the rows hold
this rank's kv heads and the model is its tensor-parallel shard.

Sampling runs on the device: greedy argmax, or at temperature > 0 a draw
from ``softmax(logits / temperature)`` through an explicit
``torch.Generator``.  JAX's ``jax.random.categorical`` stream cannot be
reproduced without JAX, so only the greedy tokens equal the JAX engine's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serve.kv_cache import SlotLayout
from repro_torch.serve.mesh import make_engine_session
from repro_torch.serve.session import DecodeSession


class Engine:
    """Batched decode executor over one model on its device (the card
    unless the model was built on the CPU), on a serving ``mesh`` when
    one is given."""

    def __init__(self, cfg: ModelConfig, model: lm.LM, max_len: int = 1024,
                 mesh=None):
        self.cfg = cfg
        self.model = model
        self.max_len = max_len
        self.mesh = mesh
        # one session per batch size, made on first use and kept: its
        # slot rows are allocated once
        self._sessions: Dict[int, DecodeSession] = {}

    def _session(self, batch: int) -> DecodeSession:
        if batch not in self._sessions and self.mesh is not None:
            self._sessions[batch] = make_engine_session(
                self.cfg, self.model, self.mesh, batch, self.max_len)
            # on a model axis > 1 that is this rank's shard from here on
            self.model = self._sessions[batch].model
        elif batch not in self._sessions:
            self._sessions[batch] = DecodeSession(
                self.cfg, self.model,
                SlotLayout(self.cfg, batch, self.max_len,
                           device=self.model.device))
        return self._sessions[batch]

    def generate(self, tokens, steps: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """tokens: (B, S) prompt ids (numpy or a tensor) -> (B, S + steps)
        int64 on the model's device: the prompts, then ``steps`` sampled
        tokens a row.  ``temperature > 0`` requires ``generator`` (on the
        model's device)."""
        if temperature > 0.0 and generator is None:
            raise ValueError(
                "temperature > 0 requires a torch.Generator (refusing to "
                "silently fall back to greedy)")
        tokens = np.asarray(tokens.cpu() if torch.is_tensor(tokens)
                            else tokens)
        B, S = tokens.shape
        if S + steps > self.max_len:
            raise ValueError(f"{S} prompt + {steps} new tokens > max_len "
                             f"{self.max_len}")
        sess = self._session(B)
        logits = sess.prefill_batch(tokens)
        cur = self._sample(logits[:, -1], temperature, generator)
        out = [torch.from_numpy(tokens.astype(np.int64)).to(cur.device)]
        for i in range(steps):
            out.append(cur)
            if i == steps - 1:
                break
            logits = sess.step(cur.cpu().numpy(),
                               np.full((B,), S + i, np.int64))
            cur = self._sample(logits[:, -1], temperature, generator)
        return torch.cat(out, dim=1)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """(B, V) logits -> (B, 1) token ids on their device."""
        if temperature <= 0.0:
            return logits.argmax(dim=-1, keepdim=True)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
