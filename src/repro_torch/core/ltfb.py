"""LTFB, "Let a Thousand Flowers Bloom" tournament training (paper §III-C):
the host half of ``repro.core.ltfb``.

Pairing schedules (the paper's random pairing and the hypercube
butterfly), the exchange scope (a GAN exchanges its generator and keeps
its discriminator local) and the host tournament over an explicit
population.  A candidate is built by reference: trainer i's candidate
holds its partner's generator tensors themselves, not a copy, which is
safe because no train step writes into a weight tensor
(:mod:`repro_torch.train.steps`).

The mesh-native tournament (``make_ltfb_step``, ``tournament_shard``:
the exchange as a collective over a trainer axis, optionally in int8) is
not ported yet (ROADMAP.md queue A6).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Params = Any


# ---------------------------------------------------------------------------
# Pairing schedules
# ---------------------------------------------------------------------------


def random_pairing(num_trainers: int, round_idx: int, seed: int = 0,
                   alive: Optional[Sequence[bool]] = None) -> np.ndarray:
    """Paper pairing: random disjoint pairs each round.

    Returns ``partner[i]`` (an involution).  Trainers that are down
    (``alive[i] == False``) or the odd one out self-pair — this is the
    straggler/failure mitigation: a missing partner never blocks a round.
    """
    rng = np.random.default_rng(hash((seed, round_idx)) % (2 ** 63))
    partner = np.arange(num_trainers)
    idx = [i for i in range(num_trainers)
           if alive is None or alive[i]]
    rng.shuffle(idx)
    for a, b in zip(idx[::2], idx[1::2]):
        partner[a], partner[b] = b, a
    return partner


def butterfly_pairing(num_trainers: int, round_idx: int) -> np.ndarray:
    """Hypercube schedule: i <-> i XOR 2^(r mod log2 K). Static involution."""
    assert num_trainers & (num_trainers - 1) == 0, "power-of-two trainers"
    bit = 1 << (round_idx % max(1, num_trainers.bit_length() - 1))
    return np.arange(num_trainers) ^ bit


def pairing_to_perm(partner: np.ndarray) -> List[Tuple[int, int]]:
    """(source, destination) pairs for a partner involution."""
    return [(int(i), int(partner[i])) for i in range(len(partner))]


# ---------------------------------------------------------------------------
# Exchange scope (GAN: generator only)
# ---------------------------------------------------------------------------


def split_scope(params: Params, scope: str) -> Tuple[Params, Params]:
    """Split params into (exchanged, local) per the exchange scope."""
    if scope == "full":
        return params, None
    if scope == "generator":
        local = {k: v for k, v in params.items() if k != "gen"}
        return params["gen"], local
    raise ValueError(scope)


def merge_scope(exchanged: Params, local: Params, scope: str) -> Params:
    """Inverse of :func:`split_scope`."""
    if scope == "full":
        return exchanged
    return {**local, "gen": exchanged}


# ---------------------------------------------------------------------------
# Host-side tournament (population trainer)
# ---------------------------------------------------------------------------


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif tree is not None:
        yield tree


def tree_nbytes(tree) -> int:
    """Byte size of a tree of tensors from their metadata (``numel *
    element_size``; exchange-volume accounting, no copy to the host)."""
    return int(sum(t.numel() * t.element_size()
                   if isinstance(t, torch.Tensor) else np.asarray(t).nbytes
                   for t in _tensors(tree)))


def _exchange(population: List[Params], i: int, j: int, scope: str,
              log: Dict[str, Any], telemetry) -> Params:
    """Trainer ``i``'s candidate: ``j``'s exchanged part merged with
    ``i``'s local part; its bytes go to ``log`` and, with ``telemetry``, a
    ``partner_exchange`` span to trainer ``i``'s row."""
    x0 = time.perf_counter()
    exch_j, _ = split_scope(population[j], scope)
    _, local_i = split_scope(population[i], scope)
    cand = merge_scope(exch_j, local_i, scope)
    nbytes = tree_nbytes(exch_j)
    log["exchange_bytes"] += nbytes
    if telemetry is not None:
        telemetry.trainer_span("partner_exchange", i, x0,
                               time.perf_counter(), phase="partner_exchange",
                               partner=j, bytes=nbytes)
    return cand


def host_tournament(population: List[Params], metrics_eval: Callable,
                    partner: np.ndarray, scope: str = "full",
                    telemetry=None
                    ) -> Tuple[List[Params], Dict[str, Any]]:
    """One tournament round over an explicit population.

    metrics_eval(trainer_idx, candidate_params) -> float (lower better);
    candidate evaluation uses trainer_idx's LOCAL tournament data.
    ``telemetry`` (a :class:`repro_torch.train.telemetry.TrainTelemetry`)
    gets one ``partner_exchange`` span per receiving trainer.
    """
    K = len(population)
    winners: List[Params] = [None] * K
    log = {"exchanged": 0, "kept_local": 0, "metrics": [],
           "exchange_bytes": 0}
    for i in range(K):
        j = int(partner[i])
        if j == i:
            winners[i] = population[i]
            log["kept_local"] += 1
            continue
        cand = _exchange(population, i, j, scope, log, telemetry)
        m_local = float(metrics_eval(i, population[i]))
        m_other = float(metrics_eval(i, cand))
        if m_other < m_local:
            winners[i] = cand
            log["exchanged"] += 1
        else:
            winners[i] = population[i]
            log["kept_local"] += 1
        log["metrics"].append((i, j, m_local, m_other))
    return winners, log


def host_tournament_async(population: List[Params], metrics_eval: Callable,
                          partner: np.ndarray, scope: str = "full",
                          executor=None, telemetry=None
                          ) -> Tuple[List[Params], Dict[str, Any]]:
    """Tournament round with evaluation overlapped with the exchange.

    The paper's non-blocking sendrecv: each trainer evaluates its OWN
    model on the held-out tournament set while the partner's model is in
    flight.  The local-metric evaluations are submitted to ``executor``
    *before* the exchange (split/merge + byte accounting) runs, then the
    received-candidate evaluations are submitted, so the two phases
    overlap instead of strictly alternating per trainer.  ``telemetry``
    gets one ``partner_exchange`` span per receiving trainer (the eval
    spans come from ``metrics_eval`` itself).
    """
    if executor is None:
        return host_tournament(population, metrics_eval, partner, scope,
                               telemetry=telemetry)
    K = len(population)
    log = {"exchanged": 0, "kept_local": 0, "metrics": [],
           "exchange_bytes": 0}
    active = [i for i in range(K) if int(partner[i]) != i]
    # phase 1: local evals in flight while the exchange happens
    local_f = {i: executor.submit(metrics_eval, i, population[i])
               for i in active}
    cands: Dict[int, Params] = {}
    for i in active:
        cands[i] = _exchange(population, i, int(partner[i]), scope, log,
                             telemetry)
    # phase 2: received-candidate evals
    other_f = {i: executor.submit(metrics_eval, i, cands[i]) for i in active}
    winners = list(population)
    for i in range(K):
        j = int(partner[i])
        if j == i:
            log["kept_local"] += 1
            continue
        m_local = float(local_f[i].result())
        m_other = float(other_f[i].result())
        if m_other < m_local:
            winners[i] = cands[i]
            log["exchanged"] += 1
        else:
            log["kept_local"] += 1
        log["metrics"].append((i, j, m_local, m_other))
    return winners, log
