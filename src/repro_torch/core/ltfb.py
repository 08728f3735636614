"""LTFB, "Let a Thousand Flowers Bloom" tournament training (paper §III-C;
``repro.core.ltfb``).

Pairing schedules (the paper's random pairing and the hypercube
butterfly), the exchange scope (a GAN exchanges its generator and keeps
its discriminator local), and two realizations of a tournament round:

1. **Across process ranks** (:func:`tournament_shard`,
   :func:`make_ltfb_step`): one rank a trainer, the exchange a
   point-to-point swap with the butterfly partner over the trainer
   process group, as the paper's MPI sendrecv (JAX's
   ``collective-permute``).  The exchanged tensors travel packed, one
   contiguous buffer a dtype, or with ``quantize`` one int8 buffer and
   one f32 vector of per-tensor scales, in a single
   ``batch_isend_irecv``; they are unpacked into new tensors, so that
   both candidates can be evaluated.  Under ``gloo`` on a card the
   buffers are staged through pinned host memory.
2. **Host tournament** over an explicit population.  A candidate is built
   by reference: trainer i's candidate holds its partner's generator
   tensors themselves, not a copy, which is safe because no train step
   writes into a weight tensor (:mod:`repro_torch.train.steps`).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

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


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list/tuple tree in JAX's flatten order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves: Sequence[torch.Tensor]):
    """A tree shaped as ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: v for k, v in ((k, build(node[k]))
                                      for k in sorted(node))}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(like)



# ---------------------------------------------------------------------------
# Point-to-point exchange between process ranks
# ---------------------------------------------------------------------------

# every packed tensor starts on a 16-byte boundary of its buffer, so that
# an unpacked view is as aligned as a fresh allocation's start would be
_ALIGN_BYTES = 16


def global_rank(group, rank: int) -> int:
    """The global rank of ``group``'s rank ``rank`` (``group=None``: the
    default group)."""
    return rank if group is None else dist.get_global_rank(group, rank)


def comm_device(group=None) -> torch.device:
    """Where ``group``'s point-to-point ops take their tensors: the
    current card under ``nccl``, the host under ``gloo``."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _staged(buf: torch.Tensor, dev: torch.device) -> torch.Tensor:
    if buf.device == dev:
        return buf
    host = torch.empty(buf.shape, dtype=buf.dtype,
                       pin_memory=buf.device.type == "cuda")
    return host.copy_(buf)


def post_swap(bufs: Sequence[torch.Tensor], peer: int, group=None):
    """Post the swap of ``bufs`` with global rank ``peer`` (each side
    sends its buffers and receives the partner's, same shapes and dtypes,
    in one ``batch_isend_irecv``).  Returns a handle for
    :func:`finish_swap`; the caller may compute while it is in flight."""
    dev = comm_device(group)
    send = [_staged(b.contiguous(), dev) for b in bufs]
    recv = [torch.empty(b.shape, dtype=b.dtype, device=dev,
                        pin_memory=dev.type == "cpu"
                        and b.device.type == "cuda") for b in send]
    ops = [op for s, r in zip(send, recv)
           for op in (dist.P2POp(dist.isend, s, peer, group),
                      dist.P2POp(dist.irecv, r, peer, group))]
    return dist.batch_isend_irecv(ops), send, recv, [b.device for b in bufs]


def finish_swap(handle) -> List[torch.Tensor]:
    """Wait for a :func:`post_swap` and return the partner's buffers on
    the devices the sent ones came from (raises when the partner died or
    the group's timeout passed)."""
    works, _, recv, devices = handle
    for w in works:
        w.wait()
    return [r.to(d) for r, d in zip(recv, devices)]


def swap_buffers(bufs: Sequence[torch.Tensor], peer: int, group=None
                 ) -> List[torch.Tensor]:
    """Swap ``bufs`` with global rank ``peer``; returns the partner's."""
    return finish_swap(post_swap(bufs, peer, group))


def _aligned(n: int, itemsize: int) -> int:
    step = max(1, _ALIGN_BYTES // itemsize)
    return -(-n // step) * step


def pack(leaves: Sequence[torch.Tensor], quantize: bool = False
         ) -> List[torch.Tensor]:
    """The buffers that carry ``leaves``: one contiguous buffer a dtype
    (in the order the dtypes first appear), or with ``quantize`` one int8
    buffer of every leaf's values and one f32 vector of their scales."""
    if quantize:
        from repro_torch.optim.compression import quantize_int8

        qs, ss = zip(*(quantize_int8(t) for t in leaves))
        return [concat(qs), torch.stack([s.reshape(()) for s in ss])]
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in leaves:
        by_dtype.setdefault(t.dtype, []).append(t)
    return [concat(ts) for ts in by_dtype.values()]


def concat(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """One buffer holding ``ts`` (one dtype) flattened, each from a
    16-byte boundary; :func:`split` takes it apart."""
    isz = ts[0].element_size()
    total = sum(_aligned(t.numel(), isz) for t in ts)
    buf = torch.zeros(total, dtype=ts[0].dtype, device=ts[0].device)
    off = 0
    for t in ts:
        buf[off:off + t.numel()].copy_(t.reshape(-1))
        off += _aligned(t.numel(), isz)
    return buf


def unpack(bufs: Sequence[torch.Tensor], like: Sequence[torch.Tensor],
           quantize: bool = False) -> List[torch.Tensor]:
    """Tensors shaped and typed as ``like`` from buffers made by
    :func:`pack`: views into the received buffers, or with ``quantize``
    the dequantized values cast back to each leaf's dtype."""
    if quantize:
        from repro_torch.optim.compression import dequantize_int8

        qs = split(bufs[0], like)
        return [dequantize_int8(q, s).to(t.dtype)
                for q, s, t in zip(qs, bufs[1], like)]
    dtypes = list(dict.fromkeys(t.dtype for t in like))
    parts = {d: iter(split(b, [t for t in like if t.dtype == d]))
             for d, b in zip(dtypes, bufs)}
    return [next(parts[t.dtype]) for t in like]


def split(buf: torch.Tensor, like: Sequence[torch.Tensor]
          ) -> List[torch.Tensor]:
    """Views into ``buf`` shaped as ``like``, as :func:`concat` laid them
    out."""
    out, off = [], 0
    for t in like:
        out.append(buf[off:off + t.numel()].view(t.shape))
        off += _aligned(t.numel(), buf.element_size())
    return out


def tournament_shard(params: Params, batch: Dict[str, torch.Tensor],
                     metric_fn: Callable, partner: int, group=None,
                     scope: str = "full", quantize: bool = False,
                     info: Optional[Dict[str, float]] = None):
    """One rank's tournament round (JAX's body inside ``shard_map``).

    Swaps the exchanged part of ``params`` with ``partner`` (a rank of
    ``group``), evaluates this rank's model and the candidate (the
    partner's exchanged part merged with this rank's local part) on this
    rank's ``batch``, and keeps the candidate iff its metric is lower.
    The local model is evaluated while the exchange is in flight.
    Returns ``(new_params, m_local, m_other)``.

    ``quantize=True``: the model crosses the wire as int8 + per-tensor
    scales (4x less than f32, 2x less than bf16), and the candidate holds
    the dequantized values cast back to the local dtypes.  ``info``, when
    given, receives ``wire_bytes`` (this rank's bytes sent) and
    ``exchange_s`` (host seconds from packing to the received tensors,
    the local evaluation included).
    """
    exch, local = split_scope(params, scope)
    leaves = tree_leaves(exch)
    x0 = time.perf_counter()
    bufs = pack(leaves, quantize)
    handle = post_swap(bufs, global_rank(group, partner), group)
    m_local = metric_fn(params, batch)
    received = tree_unflatten(exch, unpack(finish_swap(handle), leaves,
                                           quantize))
    if info is not None:
        info["wire_bytes"] = sum(b.numel() * b.element_size() for b in bufs)
        info["exchange_s"] = time.perf_counter() - x0
    cand_other = merge_scope(received, local, scope)
    m_other = metric_fn(cand_other, batch)
    take_other = bool(m_other < m_local)
    return (cand_other if take_other else params), m_local, m_other


class LTFBStep:
    """A trainer rank's tournament step over a trainer process group
    (:func:`make_ltfb_step`).

    ``step(params, batch, round_idx) -> (params, m_local, m_other)``
    pairs this rank with its butterfly partner
    ``butterfly_pairing(K, round_idx % log2 K)``.  ``last`` holds the
    last call's ``wire_bytes`` and ``exchange_s``
    (:func:`tournament_shard`).
    """

    def __init__(self, metric_fn: Callable, num_trainers: int, group=None,
                 scope: str = "full", quantize: bool = False):
        k = num_trainers
        if k < 2 or k & (k - 1):
            raise ValueError(f"the butterfly needs a power-of-two number "
                             f"of trainers >= 2, got {k}")
        if dist.get_world_size(group) != k:
            raise ValueError(f"the trainer group has "
                             f"{dist.get_world_size(group)} ranks, not {k}")
        self.metric_fn, self.k, self.group = metric_fn, k, group
        self.scope, self.quantize = scope, quantize
        self.n_bits = max(1, k.bit_length() - 1)
        self.last: Dict[str, float] = {}

    def partner(self, round_idx: int) -> int:
        """This rank's partner (a rank of the group) in round
        ``round_idx``."""
        pairing = butterfly_pairing(self.k, round_idx % self.n_bits)
        return int(pairing[dist.get_rank(self.group)])

    def __call__(self, params: Params, batch: Dict[str, torch.Tensor],
                 round_idx: int):
        return tournament_shard(params, batch, self.metric_fn,
                                self.partner(round_idx), self.group,
                                self.scope, self.quantize, info=self.last)


def make_ltfb_step(metric_fn: Callable, num_trainers: int, group=None,
                   scope: str = "full", quantize: bool = False) -> LTFBStep:
    """This rank's LTFB tournament step over the trainer process group
    ``group`` (the default group when ``None``) of ``num_trainers``
    ranks; every rank of the group calls it in the same round."""
    return LTFBStep(metric_fn, num_trainers, group, scope, quantize)


def send_tree(tree: Params, dst: int, group=None) -> None:
    """Send every tensor of ``tree`` to global rank ``dst`` (one buffer a
    dtype); :func:`recv_tree` there receives it."""
    for buf in pack(tree_leaves(tree)):
        dist.send(_staged(buf, comm_device(group)), dst, group)


def recv_tree(like: Params, src: int, group=None) -> Params:
    """A new tree shaped and typed as ``like``, received from global rank
    ``src``'s :func:`send_tree`."""
    leaves = tree_leaves(like)
    dev = comm_device(group)
    got = []
    for buf in pack(leaves):
        r = torch.empty(buf.shape, dtype=buf.dtype, device=dev)
        dist.recv(r, src, group)
        got.append(r.to(buf.device))
    return tree_unflatten(like, unpack(got, leaves))


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
