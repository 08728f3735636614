"""Logical-axis sharding rules of the port (``repro.parallel.sharding``).

Weights and activations carry *logical* axis names ("embed", "heads_w",
"mlp", "vocab", ...); a rule set maps each name onto physical mesh axes
("pod", "data", "model").  :func:`resolve` turns one tensor's logical axes
into a per-dim tuple of mesh axes, exactly as JAX's
``ShardingRules.resolve`` builds its ``PartitionSpec``: rules override
:data:`DEFAULT_RULES`, a mesh axis is used at most once per tensor, axes
the mesh lacks are dropped, and when a dim does not divide, trailing mesh
axes are dropped until it does (replicated when none is left).

A mesh here is a :class:`repro_torch.launch.mesh.RankMesh` (a grid of
process ranks), a ``{axis: size}`` dict, or anything with ``axis_names``
and a ``shape`` mapping (JAX's ``Mesh`` has both), never a device list:
the port lays ranks out, one rank a device.

:func:`param_axes` gives the logical axes of every named parameter of
:class:`repro_torch.models.lm.LM` in the port's layout: ``nn.Linear``
keeps ``(d_out, d_in)``, so JAX's ``("embed", "heads_w")`` on ``wq``
reads ``("heads_w", "embed")`` here.  :data:`MESH_SERVE_RULES` is the
serving mesh's rule set (JAX's ``repro.serve.mesh.MESH_SERVE_RULES``),
which :func:`repro_torch.parallel.tensor.shard_lm` cuts the weights by.

JAX's ``use_sharding``, ``constrain``, ``tree_shardings`` and
``shard_map_compat`` are GSPMD placement hints with no PyTorch meaning:
the port's tensor parallelism is explicit (:mod:`repro_torch.parallel.
tensor`), so no caller needs them and they are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ModelConfig

AxisName = Union[str, None]
LogicalAxes = Tuple[AxisName, ...]
# one dim's placement: None (replicated), a mesh axis, or several
Placement = Union[None, str, Tuple[str, ...]]

# ---------------------------------------------------------------------------
# logical -> physical rules (JAX's, name for name)
# ---------------------------------------------------------------------------

# Weight axes
#   "embed"    : the d_model dim of weights — FSDP (ZeRO-3) over the data axes
#   "heads_w"  : flattened (num_heads*head_dim) projection dim — TP
#   "mlp"      : FFN hidden dim — TP
#   "experts"  : MoE expert dim — EP
#   "vocab"    : embedding/logits vocab dim — TP
#   "layers"/"period" : scan-stacking dims — never sharded
# Activation axes
#   "batch"    : global batch — DP over (pod, data)
#   "seq"      : sequence — unsharded (or "model" when seq_parallel)
#   "heads"    : per-head activation dim — TP
#   "mlp_act"  : FFN hidden activation — TP
#   "kv_seq"   : KV-cache sequence dim — TP (flash-decode style)
#   "pages"    : paged-KV pool page dim — DP over `data` (serving mesh)
DEFAULT_RULES: Dict[AxisName, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": None,          # becomes "model" when seq_parallel is on
    "act_embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp_act": "model",
    "experts_act": "model",
    "kv_seq": "model",
    "state": "model",        # SSM/mLSTM inner state dim
    # weights
    "embed": ("pod", "data"),
    "vocab": "model",
    "heads_w": "model",
    "mlp": "model",
    "experts": "model",
    "state_w": "model",
    "layers": None,
    "period": None,
    "conv": None,
    "pages": "data",
    None: None,
}

# serve — weights-stationary decode: pure TP over `model` (weights never
# gathered; per-token collectives are small activation all-reduces), the
# decode batch DP over (pod, data), and every KV-cache leaf over `data`:
# dense rows / recurrent state on their batch dim, paged pools on the
# page dim (each data shard owns a private sub-pool its block tables
# address — see repro_torch.serve.mesh)
SERVE_RULES: Dict[AxisName, Any] = {
    "batch": ("pod", "data"),
    "seq_sp": None,
    "embed": None,
    "vocab": "model",
    "heads_w": "model",
    "mlp": "model",
    "experts": "model",
    "state_w": "model",
    "kv_seq": "model",
    "kv_heads": "model",
    "pages": "data",
}


def serve_rules(**overrides) -> Dict[AxisName, Any]:
    """The weights-stationary serving rule set (a copy; override freely)."""
    rules = dict(SERVE_RULES)
    rules.update(overrides)
    return rules


def seq_parallel_rules() -> Dict[AxisName, Any]:
    """Rule overrides enabling sequence parallelism on the residual stream."""
    return {"seq_sp": "model"}


# The serving mesh's rule set: dense KV rows shard their HEADS over
# `model` instead of the sequence dim (a row's decode write stays local to
# its shard), and recurrent STATE rows stay whole per slot (JAX's
# ``repro.serve.mesh.MESH_SERVE_RULES``)
MESH_SERVE_RULES = serve_rules(kv_seq=None, state=None)


# ---------------------------------------------------------------------------
# resolve
# ---------------------------------------------------------------------------


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a :class:`~repro_torch.launch.mesh.RankMesh`, a
    dict, or an object with ``axis_names`` and a ``shape`` mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    if hasattr(mesh, "axes") and hasattr(mesh, "ranks"):
        return dict(zip(mesh.axes, mesh.shape))
    if hasattr(mesh, "axis_names"):
        shape = mesh.shape
        sizes = shape.values() if hasattr(shape, "values") else shape
        return dict(zip(mesh.axis_names, (int(s) for s in sizes)))
    raise TypeError(f"not a mesh: {type(mesh).__name__}")


def _prod(sizes: Dict[str, int], phys: Sequence[str]) -> int:
    t = 1
    for a in phys:
        t *= sizes[a]
    return t


@dataclass
class ShardingRules:
    """A mesh (``None``: no mesh) and rule overrides over
    :data:`DEFAULT_RULES`."""

    mesh: Any = None
    rules: Dict[AxisName, Any] = field(default_factory=dict)

    def resolve(self, axes: Sequence[AxisName],
                shape: Optional[Sequence[int]] = None
                ) -> Tuple[Placement, ...]:
        """Logical axes -> a placement per dim (JAX's ``PartitionSpec`` as
        a tuple; ``()`` without a mesh): mesh axes absent from the mesh,
        already used by an earlier dim, or (with ``shape``) not dividing
        the dim are dropped, trailing ones first."""
        if self.mesh is None:
            return ()
        sizes = mesh_axes(self.mesh)
        spec = []
        used = set()
        for i, name in enumerate(axes):
            phys = self.rules.get(name, DEFAULT_RULES.get(name))
            if phys is None:
                spec.append(None)
                continue
            if isinstance(phys, str):
                phys = (phys,)
            phys = tuple(a for a in phys if a in sizes and a not in used)
            if shape is not None:
                while phys and shape[i] % _prod(sizes, phys) != 0:
                    phys = phys[:-1]
            if not phys:
                spec.append(None)
                continue
            used.update(phys)
            spec.append(phys if len(phys) > 1 else phys[0])
        return tuple(spec)


def resolve(axes: Sequence[AxisName], mesh,
            rules: Optional[Dict[AxisName, Any]] = None,
            shape: Optional[Sequence[int]] = None) -> Tuple[Placement, ...]:
    """``ShardingRules(mesh, rules).resolve(axes, shape)``."""
    return ShardingRules(mesh, dict(rules or {})).resolve(axes, shape)


def axes_of(placement: Placement) -> Tuple[str, ...]:
    """The mesh axes one dim's placement names (``()`` when replicated)."""
    if placement is None:
        return ()
    return (placement,) if isinstance(placement, str) else tuple(placement)


# ---------------------------------------------------------------------------
# the port's parameter axes
# ---------------------------------------------------------------------------

# per mixer / FFN kind, the JAX axes of each weight (``repro.models``'s
# ``init_*``) under the port's names and in its layout
_NORM = {"scale": (None,)}
_ATTENTION = {"wq.weight": ("heads_w", "embed"),
              "wk.weight": ("heads_w", "embed"),
              "wv.weight": ("heads_w", "embed"),
              "wo.weight": ("embed", "heads_w")}
_ATTENTION_BIAS = {"wq.bias": ("heads_w",), "wk.bias": ("heads_w",),
                   "wv.bias": ("heads_w",)}
_ATTENTION_QK_NORM = {"q_norm.scale": (None,), "k_norm.scale": (None,)}
_MLP = {"wi.weight": ("mlp", "embed"), "wg.weight": ("mlp", "embed"),
        "wo.weight": ("embed", "mlp")}
_MOE = {"router": ("embed", None), "wi": ("experts", "embed", "mlp"),
        "wg": ("experts", "embed", "mlp"), "wo": ("experts", "mlp", "embed")}
_MAMBA = {"in_proj.weight": ("mlp", "embed"), "conv_w": ("conv", "mlp"),
          "conv_b": ("mlp",), "x_proj.weight": (None, "mlp"),
          "dt_proj.weight": ("mlp", None), "dt_bias": ("mlp",),
          "A_log": ("mlp", None), "D": ("mlp",),
          "out_proj.weight": ("embed", "mlp")}
_MLSTM = {"up.weight": ("mlp", "embed"), "wq.weight": ("state_w", "mlp"),
          "wk.weight": ("state_w", "mlp"), "wv.weight": ("state_w", "mlp"),
          "w_if.weight": (None, "mlp"), "b_if": (None,),
          "down.weight": ("embed", "mlp")}
_SLSTM = {"w_x.weight": (None, "embed"), "r_h": ("heads", None, None),
          "bias": (None,), "up_g.weight": ("mlp", "embed"),
          "up_v.weight": ("mlp", "embed"), "down.weight": ("embed", "mlp")}


def _attention_axes(cfg: ModelConfig) -> Dict[str, LogicalAxes]:
    out = dict(_ATTENTION)
    if cfg.qkv_bias:
        out.update(_ATTENTION_BIAS)
    if cfg.qk_norm:
        out.update(_ATTENTION_QK_NORM)
    return out


def param_axes(cfg: ModelConfig) -> Dict[str, LogicalAxes]:
    """``{name: logical axes}`` for every named parameter of
    :class:`repro_torch.models.lm.LM` of ``cfg``, in the port's layout
    (the keys of ``model.named_parameters()``)."""
    from repro_torch.models.lm import layer_specs

    mixers = {"a": _attention_axes(cfg), "M": _MAMBA, "m": _MLSTM,
              "s": _SLSTM}
    out: Dict[str, LogicalAxes] = {"embed.weight": ("vocab", "embed")}
    for i, spec in enumerate(layer_specs(cfg)):
        parts = [("ln1", _NORM), ("mixer", mixers[spec.kind])]
        if spec.ffn == "dense":
            parts += [("ln2", _NORM), ("ffn", _MLP)]
        elif spec.ffn == "moe":
            moe = dict(_MOE)
            if cfg.moe.num_shared_experts:
                moe.update({f"shared.{k}": v for k, v in _MLP.items()})
            parts += [("ln2", _NORM), ("ffn", moe)]
        for part, table in parts:
            for name, axes in table.items():
                out[f"blocks.{i}.{part}.{name}"] = axes
    out["final_norm.scale"] = (None,)
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = ("vocab", "embed")
    return out
