"""Batched ICF-surrogate serving (``repro.serve.surrogate``): the paper's
end product.

The trained CycleGAN surrogate answers "what does the experiment produce
for inputs x?" queries -- ``x (5,) -> output bundle (15 scalars + 12
images)`` through :func:`repro_torch.models.icf_cyclegan.predict`.
Queries of any size are micro-batched: the queue is drained up to
``max_batch`` rows a step and padded to a multiple of ``bucket`` rows.  A
:class:`repro_torch.serve.registry.ModelRegistry` polled every
``watch_every`` steps hot-swaps a newer tournament winner in between
steps, as the LM scheduler does.

**Host/device overlap**, the JAX engine's software pipeline: each
:meth:`~SurrogateEngine.step` (1) dispatches the batch staged on the
previous step, (2) stages the next one (drain, concatenate, pad) while
the device computes, and only then (3) collects the dispatched batch.  On
the card the dispatch runs on a stream of the engine's own: the staged
rows go up from pinned memory with ``non_blocking=True``, ``predict``
runs, its output starts its copy into the engine's pinned host buffer,
and an event is recorded; the collect waits on that event and copies the
rows out.  The buffer is reused batch after batch: pinning 25 MB afresh
for each 128-row batch of the full-width surrogate costs the host more
than the copy out, and a copy into pageable memory runs some 25x slower
than into pinned (``PERF.md``).  On the CPU the dispatch
computes at once and the pipeline keeps only its bookkeeping (the same
counters as JAX's).  Telemetry as in JAX: an ``enqueue`` instant and a
``finish`` terminal per query and a ``surrogate_collect`` phase per
batch (``telemetry=False`` drops the events, keeps the counters).  The forward is the CycleGAN's f32 MLP (``F.linear``),
as JAX computes it outside any Pallas kernel.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.icf_cyclegan import CycleGANConfig
from repro_torch.models import icf_cyclegan as cg
from repro_torch.serve.metrics import ServeStats
from repro_torch.serve.telemetry import ServeTelemetry

# a staged micro-batch: (taken queue items, true rows, padded rows)
_Staged = Tuple[List[Tuple[Any, np.ndarray, float]], int, torch.Tensor]


class SurrogateEngine:
    """Micro-batching front end over the surrogate forward.

    ``params`` are the port's CycleGAN weights (``{"gen": {...}, ...}``)
    on ``device`` (the card unless ``device="cpu"``; without a card the
    default raises).  ``served_by[rid]`` is the number of hot swaps applied
    when query ``rid`` was dispatched: which weights answered it.
    """

    def __init__(self, cfg: CycleGANConfig, params, max_batch: int = 64,
                 bucket: int = 8, registry=None, watch_every: int = 0,
                 telemetry: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.bucket = bucket
        self.registry = registry
        self.watch_every = watch_every
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda \
            else None
        self.queue: deque[Tuple[Any, np.ndarray, float]] = deque()
        self.results: Dict[Any, np.ndarray] = {}
        self.served_by: Dict[Any, int] = {}
        self.stats = ServeStats(slots=max_batch)
        self.telemetry = ServeTelemetry(enabled=telemetry)
        self._step_count = 0
        # software pipeline state: the batch staged for the next dispatch,
        # and the batch whose device compute is in flight
        self._staged: Optional[_Staged] = None
        self._pending = None
        self._out: Optional[torch.Tensor] = None    # pinned, reused
        self.overlapped_stages = 0

    def submit(self, rid: Any, x: np.ndarray) -> None:
        """x: (n, input_dim) float batch of experiment-parameter rows;
        a wrong width raises ``ValueError``, counted as ``rejected``."""
        x = np.atleast_2d(np.asarray(x, np.float32))
        if x.shape[1] != self.cfg.input_dim:
            self.stats.rejected += 1
            raise ValueError(
                f"query {rid!r}: expected (n, {self.cfg.input_dim}), "
                f"got {x.shape}")
        self.stats.submitted += 1
        t0 = time.perf_counter()
        self.queue.append((rid, x, t0))
        self.telemetry.req_instant(rid, "enqueue", t=t0,
                                   rows=int(x.shape[0]))

    def _pad(self, n: int) -> int:
        b = self.bucket
        return ((n + b - 1) // b) * b

    def _stage(self) -> Optional[_Staged]:
        """Drain up to max_batch rows off the queue and assemble the
        padded host rows (pinned on the card's path): the host work the
        pipeline overlaps."""
        taken, rows = [], 0
        while self.queue and rows + self.queue[0][1].shape[0] \
                <= self.max_batch:
            item = self.queue.popleft()
            taken.append(item)
            rows += item[1].shape[0]
        if not taken and self.queue:
            # the head query alone exceeds max_batch: serve it as its own
            # (oversized) micro-batch rather than stall the queue
            item = self.queue.popleft()
            taken.append(item)
            rows = item[1].shape[0]
        if not taken:
            return None
        x = torch.zeros((self._pad(rows), self.cfg.input_dim),
                        dtype=torch.float32, pin_memory=self._cuda)
        x[:rows] = torch.from_numpy(np.concatenate([t[1] for t in taken]))
        return taken, rows, x

    @torch.no_grad()
    def _dispatch(self, staged: _Staged) -> None:
        taken, rows, x = staged
        gen = self.params["gen"]
        swaps = self.stats.hot_swaps
        for rid, _, _ in taken:
            self.served_by[rid] = swaps
        if not self._cuda:
            self._pending = (taken, rows, x.shape[0], cg.predict(gen, x),
                             None)
            return
        stream = self._stream
        # the weights (a hot swap's too) were written on the caller's stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            y_dev = cg.predict(gen, x.to(self.device, non_blocking=True))
            if self._out is None or self._out.shape[0] < y_dev.shape[0]:
                self._out = torch.empty(y_dev.shape, dtype=y_dev.dtype,
                                        pin_memory=True)
            y = self._out[:y_dev.shape[0]]
            y.copy_(y_dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        # x stays referenced until the collect: the upload reads it
        # asynchronously
        self._pending = (taken, rows, x.shape[0], y, (done, x))

    def _collect(self) -> None:
        """Wait for the in-flight batch and distribute its results."""
        taken, rows, padded, y, inflight = self._pending
        self._pending = None
        tc = time.perf_counter()
        if inflight is not None:
            inflight[0].synchronize()
            y = y[:rows].numpy().copy()     # the pinned buffer is reused
        else:
            y = y.numpy()
        now = time.perf_counter()
        self.telemetry.phase("surrogate_collect", tc, now, rows=rows)
        off = 0
        for rid, q, t0 in taken:
            n = q.shape[0]
            self.results[rid] = y[off:off + n]
            off += n
            self.stats.completed += 1
            self.stats.ttft.append(now - t0)
            self.stats.latency.append(now - t0)
            self.telemetry.terminal(rid, "finish", t=now,
                                    latency_s=now - t0, rows=n)
        self.stats.prefills += 1
        self.stats.prefill_tokens += rows       # true query rows
        self.stats.padded_prefill_tokens += padded
        self.stats.decode_steps += 1
        self.stats.decode_tokens += rows
        self.stats.decode_slot_steps += padded
        self.stats.sample_step(len(self.queue), rows)

    def step(self) -> None:
        """One pipeline step: the hot-swap check, dispatch the staged
        batch, stage the next one while the device computes, collect."""
        self.stats.start()
        self._step_count += 1
        if (self.registry is not None and self.watch_every > 0
                and self._step_count % self.watch_every == 0
                and self.registry.refresh()):
            self.params = self.registry.params
            self.stats.hot_swaps += 1
        if self.registry is not None:
            self.stats.swap_rejected_corrupt = getattr(
                self.registry, "rejected_corrupt", 0)
        staged = self._staged if self._staged is not None else self._stage()
        self._staged = None
        if staged is not None:
            self._dispatch(staged)
        # overlap: assemble the NEXT micro-batch while the device is busy
        # with the one just dispatched
        self._staged = self._stage()
        if self._pending is not None:
            if self._staged is not None:
                self.overlapped_stages += 1
            self._collect()
        else:
            self.stats.sample_step(len(self.queue), 0)

    def run(self, max_steps: Optional[int] = None) -> Dict[Any, np.ndarray]:
        """Drain the query queue (optionally bounded); returns results
        keyed by query id."""
        steps = 0
        while self.queue or self._staged is not None \
                or self._pending is not None:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        if self._pending is not None:    # flush the in-flight batch
            self._collect()
        self.stats.stop()
        return self.results
