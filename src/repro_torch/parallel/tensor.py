"""Tensor parallelism of the dense LMs over the ``model`` ranks.

JAX serves a ``(data, model)`` mesh by tracing the model under
``SERVE_RULES`` and letting GSPMD place every weight and insert the
collectives.  The port makes that lowering explicit, the Megatron way:

* :func:`plan_shards` resolves every parameter's logical axes
  (:func:`repro_torch.parallel.sharding.param_axes`) under
  :data:`~repro_torch.parallel.sharding.MESH_SERVE_RULES`: ``wq``/``wk``/
  ``wv`` and their biases are cut by output rows over ``heads_w``, ``wo``
  by input columns; the MLP's ``wi``/``wg`` by rows over ``mlp`` and its
  ``wo`` by columns; the embedding (and an untied head) by vocab rows;
  norms are replicated.  The attention heads split only when both ``H``
  and ``Hkv`` divide ``model`` (JAX's rule in ``kernels/ops.py``
  ``paged_attention_sharded``): a contiguous cut of q heads then maps to
  the same rank's kv heads, so the GQA grouping holds.  Otherwise the
  rank keeps every head and attention runs replicated, while the MLP and
  the vocab still split by :func:`~repro_torch.parallel.sharding.resolve`.
* :func:`shard_lm` builds a rank's :class:`~repro_torch.models.lm.LM`
  over the rank's :class:`~repro_torch.configs.base.ModelConfig`
  (``num_heads``, ``num_kv_heads``, ``d_ff`` and ``vocab_size`` divided
  where they are cut, ``head_dim`` pinned) and hands its attention, MLP
  and model modules a :class:`TensorParallel`, the one explicit carrier
  of the model group.
* :class:`TensorParallel` issues the collectives on that group: an
  all-reduce after attention's ``wo`` and after the MLP's ``wo``; for the
  vocab-parallel lookup, ids outside the rank's range zeroed, looked up,
  all-reduced; for the logits, the rank's vocab slice all-gathered into
  the full row in vocab order, so every rank samples the same token from
  the shared host-side draw.  A model without one (``model.tp is None``)
  issues no collective and runs exactly the single-device ops.

Recurrent and hybrid mixers (``state_w`` over ``model``, ROADMAP.md queue
A20) and MoE FFNs (``experts`` over ``model``, JAX's expert parallelism,
A19) are refused at ``model > 1``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, replace
from repro_torch.parallel.sharding import (MESH_SERVE_RULES, axes_of,
                                           mesh_axes, param_axes, resolve)


@dataclass(frozen=True)
class ShardPlan:
    """How a model of ``cfg`` is cut over ``size`` model ranks: whether the
    attention heads, the MLP's d_ff and the vocab split, and each rank's
    config (``rank_cfg``)."""

    cfg: ModelConfig
    size: int
    heads: bool
    mlp: bool
    vocab: bool
    rank_cfg: ModelConfig

    def placement(self, name: str, shape, axes=None
                  ) -> Tuple[Optional[int], ...]:
        """Per dim of parameter ``name`` (full shape ``shape``; ``axes``:
        its logical axes, looked up when not given): the model axis' cut
        (``size``) or None (whole)."""
        if axes is None:
            axes = param_axes(self.cfg)[name]
        spec = resolve(axes, {"model": self.size}, MESH_SERVE_RULES,
                       tuple(shape))
        if ".mixer." in name and not self.heads:
            spec = (None,) * len(shape)
        return tuple(self.size if p else None for p in spec)

    def shard(self, name: str, full: torch.Tensor, rank: int,
              axes=None) -> torch.Tensor:
        """Model rank ``rank``'s slice of parameter ``name``."""
        out = full
        for dim, cut in enumerate(self.placement(name, full.shape, axes)):
            if cut:
                out = out.chunk(cut, dim=dim)[rank]
        return out

    def shard_state(self, state: Dict[str, torch.Tensor],
                    rank: int) -> Dict[str, torch.Tensor]:
        """A full state dict (the port's names) cut to rank ``rank``'s."""
        axes = param_axes(self.cfg)
        return {k: self.shard(k, v, rank, axes[k]).contiguous()
                for k, v in state.items()}

    def vocab_range(self, rank: int) -> Optional[Tuple[int, int]]:
        """The ``[lo, hi)`` token ids whose rows rank ``rank`` holds (None
        when the vocab is whole on every rank)."""
        if not self.vocab:
            return None
        n = self.cfg.vocab_size // self.size
        return rank * n, (rank + 1) * n


def plan_shards(cfg: ModelConfig, mesh) -> ShardPlan:
    """The cut of ``cfg`` over ``mesh``'s ``model`` axis (a ``{axis:
    size}`` dict, a :class:`~repro_torch.launch.mesh.RankMesh` or a
    :class:`~repro_torch.serve.mesh.ServeMesh`)."""
    from repro_torch.models.lm import has_recurrent, layer_specs

    size = getattr(mesh, "model", None)
    if size is None:
        size = mesh_axes(mesh).get("model", 1)
    size = int(size)
    if size > 1:
        if has_recurrent(cfg):
            raise NotImplementedError(
                f"{cfg.name}: recurrent or hybrid mixers over a model axis "
                f"of {size} (their state dims split over `model`, "
                "`state_w`) are not ported to repro_torch yet; see "
                "ROADMAP.md queue A20")
        if any(s.ffn == "moe" for s in layer_specs(cfg)):
            raise NotImplementedError(
                f"{cfg.name}: MoE FFNs over a model axis of {size} (the "
                "experts split over `model`, JAX's expert parallelism) are "
                "not ported to repro_torch yet; see ROADMAP.md queue A19")
    sizes = {"model": size}

    def cut(axes, shape) -> bool:
        spec = resolve(axes, sizes, MESH_SERVE_RULES, shape)
        return any("model" in axes_of(p) for p in spec)

    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    heads = size > 1 and H % size == 0 and Hkv % size == 0
    mlp = size > 1 and cut(("mlp", "embed"), (cfg.d_ff, cfg.d_model))
    vocab = size > 1 and cut(("vocab", "embed"),
                             (cfg.vocab_size, cfg.d_model))
    fields = {"head_dim": cfg.resolved_head_dim}
    if heads:
        fields.update(num_heads=H // size, num_kv_heads=Hkv // size)
    if mlp:
        fields["d_ff"] = cfg.d_ff // size
    if vocab:
        fields["vocab_size"] = cfg.vocab_size // size
    return ShardPlan(cfg, size, heads, mlp, vocab, replace(cfg, **fields))


class TensorParallel:
    """One rank's place on the model axis and the collectives over its
    group (``group``: a ``torch.distributed`` process group of the
    replica's ``size`` model ranks; ``rank``: this rank's index in it).

    ``plan`` is the :class:`ShardPlan` the rank's weights were cut by;
    ``vocab`` the rank's ``[lo, hi)`` token ids when the vocab is cut
    (None: whole).  ``timing`` counts the collectives, the bytes each
    hands the group (an all-reduce's tensor, an all-gather's part) and
    their host seconds (a blocking collective's wait for the device to
    reach it included).  A failed or timed-out collective raises
    ``RuntimeError`` saying a peer likely died."""

    def __init__(self, plan: ShardPlan, rank: int, group=None):
        self.plan = plan
        self.size = plan.size
        self.rank = int(rank)
        self.group = group
        self.vocab = plan.vocab_range(self.rank)
        self.timing = {"calls": 0, "bytes": 0, "seconds": 0.0}

    def __deepcopy__(self, memo):
        # a process group cannot be copied: a copied model shares it
        return self

    def _run(self, what: str, fn, nbytes: int) -> None:
        if self.group is None:
            raise RuntimeError(
                f"a {what} over the model axis needs a process group: "
                "shard_lm(..., group=) (repro_torch.launch.mesh."
                "make_serve_mesh)")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:      # gloo: closed peer or timeout
            raise RuntimeError(
                f"model-group {what} failed or timed out — a peer process "
                f"likely died ({type(e).__name__}: {e})") from e
        self.timing["seconds"] += time.perf_counter() - t0
        self.timing["calls"] += 1
        self.timing["bytes"] += nbytes

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the model ranks, in place of ``x`` (a
        layer's fresh output)."""
        x = x.contiguous()
        self._run("all-reduce",
                  lambda: dist.all_reduce(x, group=self.group),
                  x.numel() * x.element_size())
        return x

    def gather_vocab(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's vocab slice of ``x`` (..., V / size), concatenated
        in rank order: the full (..., V)."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._run("all-gather",
                  lambda: dist.all_gather(parts, x, group=self.group),
                  x.numel() * x.element_size())
        return torch.cat(parts, dim=-1)

    def embed(self, weight: torch.Tensor,
              tokens: torch.Tensor) -> torch.Tensor:
        """The vocab-parallel lookup: this rank's rows ``weight`` (V /
        size, d) for the ids in its range, zero for the others, summed
        over the ranks (one nonzero term a token: exact)."""
        lo, hi = self.vocab
        inside = (tokens >= lo) & (tokens < hi)
        local = torch.where(inside, tokens - lo, torch.zeros_like(tokens))
        rows = F.embedding(local, weight).masked_fill(~inside[..., None], 0)
        return self.all_reduce(rows)

    def reset_timing(self) -> None:
        """Zero the counters (a run's figures start here)."""
        self.timing = {"calls": 0, "bytes": 0, "seconds": 0.0}


def build_shard(plan: ShardPlan, state: Dict[str, torch.Tensor], rank: int,
                group=None, device="cuda"):
    """Model rank ``rank``'s :class:`~repro_torch.models.lm.LM` from a full
    state dict in the port's names (any device and dtype): cut by
    ``plan``, built over ``plan.rank_cfg`` on ``device``, and handed a
    :class:`TensorParallel` over ``group`` where its weights are cut."""
    from repro_torch import resolve_device
    from repro_torch.models.lm import LM

    dev = resolve_device(device)
    with torch.device(dev):
        shard = LM(plan.rank_cfg)
    with torch.no_grad():
        shard.load_state_dict(plan.shard_state(state, rank), strict=True)
    if plan.size > 1:
        tp = TensorParallel(plan, rank, group)
        shard.tp = tp
        for block in shard.blocks:
            if plan.heads:
                block.mixer.tp = tp
            if plan.mlp:
                block.ffn.tp = tp
    return shard.eval()


def shard_lm(model, mesh, rank: int, group=None):
    """Model rank ``rank``'s shard of a full ``model`` over ``mesh``'s
    ``model`` axis (:func:`plan_shards`), on the model's device, its
    collectives on ``group``.  ``model = 1`` returns a copy of the full
    weights with no collective."""
    plan = plan_shards(model.cfg, mesh)
    return build_shard(plan, model.state_dict(), rank, group, model.device)


def tensor_parallel(model) -> Optional[TensorParallel]:
    """The :class:`TensorParallel` of a shard (None for a whole model)."""
    return model.tp
