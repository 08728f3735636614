"""Carry weights (and optimizer state) of the JAX package's LMs and of its
CycleGAN into the port, and the CycleGAN's back into JAX's layout.

Input is the JAX params pytree already converted to numpy (the caller
runs ``jax.tree.map(np.asarray, params)``; this module imports no JAX):

* ``embed`` (V, d);
* ``prefix`` (MoE configs with ``first_k_dense`` = k0 > 0 only): one stack
  of the k0 dense layers before the body, entry i layer i;
* ``body``: a tuple of R stacks, one per position j of the layer period
  (``repro.models.lm._grouping``); each leaf of ``body[j]`` has a leading
  axis over the P periods, and entry p is layer ``k0 + j + p*R``;
* ``final_norm.scale``; ``lm_head`` (d, V) only when embeddings are not
  tied.

A layer's leaves: ``ln1.scale`` (and ``ln2.scale`` with an FFN), the
mixer's — attention ``wq, wk, wv, wo`` (plus ``bq, bk, bv`` with qkv bias
and ``q_norm, k_norm`` with qk-norm); Mamba ``in_proj, conv_w, conv_b,
x_proj, dt_proj, dt_bias, A_log, D, out_proj``; mLSTM ``up, wq, wk, wv,
w_if, b_if, down``; sLSTM ``w_x, r_h, bias, up_g, up_v, down`` — and the
SwiGLU ``ffn.{wi, wg, wo}`` or, in a MoE layer, ``ffn.router`` (d, E),
the expert stacks ``ffn.{wi, wg}`` (E, d, d_e) and ``ffn.wo`` (E, d_e, d)
and the shared SwiGLU ``ffn.shared.{wi, wg, wo}``.

JAX keeps dense weights ``(d_in, d_out)`` for ``x @ W``; the port's
``nn.Linear`` keeps ``(d_out, d_in)``, so those are transposed here.  The
other weights (conv, ``A_log``, ``r_h``, biases, scales, and the MoE
router and expert stacks, which the port keeps as JAX does) keep JAX's
layout.

:func:`shard_from_jax` carries the tree straight to one model rank's
tensor-parallel shard (:mod:`repro_torch.parallel.tensor`).
:func:`opt_state_from_jax` carries an optimizer state of
``repro.optim.optimizers`` the same way (Adam, AdamW, SGD and Adafactor).
:func:`params_to_jax_layout` and :func:`opt_state_to_jax_layout` go back:
the port's per-layer tensors stacked into JAX's periods (Adafactor's
grouped factors to their leaves), as CPU tensors (bf16 has no numpy dtype;
the checkpoint stores its bits), so that an LM checkpoint either package
writes restores in the other.

The CycleGAN (``repro.models.icf_cyclegan``) keeps each MLP stack as
``{"w": (W_0, ...), "b": (b_0, ...)}`` under ``gen.{fwd, inv, enc, dec}``
and ``disc``; the port names layer i of stack ``fwd``
``gen["fwd.{i}.weight"]`` (:mod:`repro_torch.models.icf_cyclegan`), again
transposed.  :func:`cyclegan_params_to_jax_layout` and
:func:`cyclegan_opt_state_to_jax_layout` go the other way, to numpy: the
checkpoint files hold JAX's layout, so either package restores what the
other saved.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.icf_cyclegan import GEN_PARTS, num_layers
from repro_torch.models.lm import LM, group_key, grouping, layer_specs

# optimizer-state entries shaped like the parameters (Adam, SGD)
_PARAM_SHAPED = ("m", "v", "mom")
# JAX leaves that are dense (d_in, d_out) weights: nn.Linear in the port
_DENSE = {"wq", "wk", "wv", "wo", "in_proj", "x_proj", "dt_proj",
          "out_proj", "up", "w_if", "down", "w_x", "up_g", "up_v", "wi",
          "wg"}
# JAX leaf paths whose port name is not ``<path>`` / ``<path>.weight``
_RENAME = {"embed": "embed.weight", "mixer.bq": "mixer.wq.bias", "mixer.bk": "mixer.wk.bias",
           "mixer.bv": "mixer.wv.bias", "mixer.q_norm": "mixer.q_norm.scale",
           "mixer.k_norm": "mixer.k_norm.scale"}


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):     # a restored checkpoint's leaf
        return a.detach().clone(memory_format=torch.contiguous_format)
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: exact via f32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _flat(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(dotted path, leaf) of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


# the expert stacks of a MoE layer: raw parameters in JAX's layout
_EXPERTS = ("ffn.wi", "ffn.wg", "ffn.wo")


def _port_name(path: str, moe: bool = False) -> Tuple[str, bool]:
    """The port's name for a JAX leaf path within a layer (or at the top;
    ``moe``: the layer's FFN is a MoE) and whether the weight is
    transposed on the way."""
    if path in _RENAME:
        return _RENAME[path], False
    if moe and path in _EXPERTS:
        return path, False
    if path.split(".")[-1] in _DENSE or path == "lm_head":
        return path + ".weight", True
    return path, False


def _leaves(tree, cfg: ModelConfig) -> Iterator[
        Tuple[Optional[Tuple[int, ...]], str, bool, object]]:
    """(the layers a stacked leaf holds, in stack order, or None outside
    the blocks; port name; whether transposed; JAX leaf) of every leaf of
    a params-shaped tree; a block leaf is the whole ``prefix`` or
    ``body[j]`` stack."""
    k0, R, P = grouping(cfg)
    specs = layer_specs(cfg)
    top = {k: v for k, v in tree.items() if k not in ("prefix", "body")}
    for path, leaf in _flat(top):
        yield (None, *_port_name(path), leaf)
    stacks = [(tuple(range(k0)), tree["prefix"])] if k0 else []
    stacks += [(tuple(k0 + j + p * R for p in range(P)), tree["body"][j])
               for j in range(R)]
    for layers, stack in stacks:
        moe = specs[layers[0]].ffn == "moe"
        for path, leaf in _flat(stack):
            yield (layers, *_port_name(path, moe), leaf)


def params_from_jax(tree, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """State dict for :class:`repro_torch.models.lm.LM` from the JAX tree."""
    sd = {}
    for layers, name, transpose, leaf in _leaves(tree, cfg):
        entries = [(name, leaf)] if layers is None else \
            [(f"blocks.{i}.{name}", leaf[p]) for p, i in enumerate(layers)]
        for key, a in entries:
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a)
            sd[key] = a.T if transpose else a
    return {k: _tensor(v) for k, v in sd.items()}


def load_jax_params(model: LM, tree) -> LM:
    """Copy the JAX weights into ``model`` (strict: every key must match;
    values are cast to the model's dtype and device)."""
    model.load_state_dict(params_from_jax(tree, model.cfg), strict=True)
    return model


def shard_from_jax(tree, cfg: ModelConfig, mesh, rank: int, group=None,
                   device="cuda") -> LM:
    """Model rank ``rank``'s tensor-parallel shard over ``mesh``'s
    ``model`` axis, straight from the JAX tree: the full state dict on
    the host, cut by :func:`repro_torch.parallel.tensor.plan_shards` (the
    cut :func:`~repro_torch.parallel.tensor.shard_lm` makes of a full
    model) and loaded once on ``device``, its collectives on ``group``."""
    from repro_torch.parallel.tensor import build_shard, plan_shards

    return build_shard(plan_shards(cfg, mesh), params_from_jax(tree, cfg),
                       rank, group, device)


def opt_state_from_jax(opt_state, cfg: ModelConfig) -> Dict[str, object]:
    """The port's optimizer state (:mod:`repro_torch.optim.optimizers`)
    from a JAX one already converted to numpy.

    Adam's ``m``/``v`` and SGD's ``mom`` are params-shaped and cross like
    the weights.  Adafactor's ``vr``/``vc`` are keyed by leaf, as the
    port's are by group (:func:`repro_torch.models.lm.param_groups`): a
    stacked leaf of ``prefix`` or ``body[j]`` crosses whole under its
    group key (:func:`repro_torch.models.lm.group_key`).  For a transposed
    dense weight JAX's row factor is the port's column factor and the
    other way round.
    ``step`` becomes a 0-dim int32 tensor.
    """
    out: Dict[str, object] = {"step": torch.tensor(int(opt_state["step"]),
                                                   dtype=torch.int32)}
    for key in ("m", "v", "mom"):
        if key in opt_state:
            out[key] = params_from_jax(opt_state[key], cfg)
    if "vr" not in opt_state:
        return out
    out["vr"], out["vc"] = {}, {}
    for (layers, name, transpose, vr), (_, _, _, vc) in zip(
            _leaves(opt_state["vr"], cfg), _leaves(opt_state["vc"], cfg)):
        key = name if layers is None else group_key(cfg, layers[0], name)
        if transpose:
            vr, vc = vc, vr
        out["vr"][key], out["vc"][key] = _tensor(vr), _tensor(vc)
    return out


_JAX_NAME = {port: jax for jax, port in _RENAME.items()}


def _jax_path(name: str) -> Tuple[str, bool]:
    """The JAX leaf path of a port name within a layer (or at the top) and
    whether the weight is transposed on the way: :func:`_port_name`
    inverted."""
    if name in _JAX_NAME:
        return _JAX_NAME[name], False
    base = name[:-len(".weight")] if name.endswith(".weight") else None
    if base is not None and (base.split(".")[-1] in _DENSE
                             or base == "lm_head"):
        return base, True
    return name, False


def _put(tree: dict, path: str, leaf) -> None:
    *parents, last = path.split(".")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[last] = leaf


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu")


def params_to_jax_layout(model_or_params, cfg: ModelConfig) -> dict:
    """JAX's params tree from the port's weights (an :class:`LM` or its
    ``{name: tensor}`` dict): ``embed``, with k0 = ``first_k_dense`` > 0
    ``prefix`` (entry i layer i), ``body`` (a tuple of R stacks, entry p
    of ``body[j]`` layer ``k0 + j + p*R``), ``final_norm`` and, untied,
    ``lm_head``; dense weights transposed to ``(d_in, d_out)``.  Leaves
    are new contiguous CPU tensors in the weights' dtypes."""
    params = dict(model_or_params.named_parameters()) \
        if isinstance(model_or_params, torch.nn.Module) else model_or_params
    k0, R, P = grouping(cfg)
    tree: dict = {}
    body = [dict() for _ in range(R)]
    prefix: dict = {}
    stacks: Dict[Tuple[int, str], list] = {}
    for name, t in params.items():
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            i = int(i)
            path, transpose = _jax_path(rest)
            t = _host(t)
            j, p, n = (-1, i, k0) if i < k0 else \
                ((i - k0) % R, (i - k0) // R, P)
            stacks.setdefault((j, path), [None] * n)[p] = \
                t.T if transpose else t
        else:
            path, transpose = _jax_path(name)
            t = _host(t)
            _put(tree, path, (t.T if transpose else t).clone(
                memory_format=torch.contiguous_format))
    for (j, path), layers in stacks.items():
        _put(prefix if j < 0 else body[j], path, torch.stack(layers))
    if k0:
        tree["prefix"] = prefix
    tree["body"] = tuple(body)
    return tree


def _group_path(key: str, cfg: ModelConfig) -> Tuple[Optional[int], str]:
    """(position j of JAX's ``body[j]``, -1 for ``prefix``, None outside
    the blocks; port name within the layer) of a group key of
    :func:`repro_torch.models.lm.group_key`: :func:`group_key` inverted."""
    if not key.startswith("blocks["):
        return None, key
    span, rest = key[len("blocks["):].split("].", 1)
    k0, R, _ = grouping(cfg)
    start = int(span.split(":")[0])
    return (-1 if span == f"0:{k0}" else start - k0), rest


def opt_state_to_jax_layout(opt_state, cfg: ModelConfig) -> dict:
    """JAX's optimizer state from the port's: Adam/AdamW ``m``/``v`` and
    SGD ``mom`` stacked like the weights (:func:`params_to_jax_layout`),
    ``step`` a 0-dim int32 array.

    Adafactor's ``vr``/``vc`` (:func:`opt_state_from_jax` inverted): each
    group key goes back to its leaf, ``prefix`` or ``body[j]`` (the group
    is already stacked over its layers, as JAX's leaf is) or a top-level
    weight, and for a transposed dense weight the port's row factor is
    JAX's column factor and the other way round.  An unfactored leaf
    keeps its ``vc`` pad slot of shape (1,), as ``make_adafactor``
    initialises it.  Leaves are contiguous CPU tensors.
    """
    out = {k: params_to_jax_layout(opt_state[k], cfg)
           for k in _PARAM_SHAPED if k in opt_state}
    if "vr" in opt_state:
        k0, R, _ = grouping(cfg)
        out["vr"], out["vc"] = {}, {}
        body = {"vr": [dict() for _ in range(R)],
                "vc": [dict() for _ in range(R)]}
        prefix: Dict[str, dict] = {"vr": {}, "vc": {}}
        for key, vr in opt_state["vr"].items():
            j, name = _group_path(key, cfg)
            path, transpose = _jax_path(name)
            pair = {"vr": vr, "vc": opt_state["vc"][key]}
            if transpose:
                pair = {"vr": pair["vc"], "vc": pair["vr"]}
            for which, leaf in pair.items():
                tree = out[which] if j is None else \
                    prefix[which] if j < 0 else body[which][j]
                _put(tree, path, _host(leaf).clone(
                    memory_format=torch.contiguous_format))
        for which in ("vr", "vc"):
            if k0:
                out[which]["prefix"] = prefix[which]
            out[which]["body"] = tuple(body[which])
    out["step"] = np.asarray(_np(opt_state["step"]), np.int32)
    return out


# ---------------------------------------------------------------------------
# CycleGAN
# ---------------------------------------------------------------------------

def _stack_from_jax(stack, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for i, (w, b) in enumerate(zip(stack["w"], stack["b"])):
        out[f"{prefix}{i}.weight"] = _tensor(np.asarray(w).T)
        out[f"{prefix}{i}.bias"] = _tensor(b)
    return out


def _gen_from_jax(tree) -> Dict[str, torch.Tensor]:
    out = {}
    for part in GEN_PARTS:
        out.update(_stack_from_jax(tree[part], part + "."))
    return out


def _stack_to_jax(p: Dict[str, torch.Tensor], prefix: str):
    n = num_layers(p, prefix)
    return {"w": tuple(np.ascontiguousarray(_np(p[f"{prefix}{i}.weight"]).T)
                       for i in range(n)),
            "b": tuple(np.array(_np(p[f"{prefix}{i}.bias"]))
                       for i in range(n))}


def _gen_to_jax(gen: Dict[str, torch.Tensor]):
    return {part: _stack_to_jax(gen, part + ".") for part in GEN_PARTS}


_HALVES = {"gen": (_gen_from_jax, _gen_to_jax),
           "disc": (lambda t: _stack_from_jax(t, ""),
                    lambda p: _stack_to_jax(p, ""))}


def cyclegan_params_from_jax(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's ``{"gen": {...}, "disc": {...}}`` weight dicts (CPU
    tensors) from JAX's CycleGAN params tree (numpy leaves)."""
    return {half: conv(tree[half]) for half, (conv, _) in _HALVES.items()}


def cyclegan_params_to_jax_layout(params) -> dict:
    """JAX's CycleGAN params tree (numpy leaves, dense weights
    ``(d_in, d_out)``) from the port's weight dicts."""
    return {half: conv(params[half]) for half, (_, conv) in _HALVES.items()}


def cyclegan_opt_state_from_jax(state) -> Dict[str, dict]:
    """The port's ``{"gen": opt_state, "disc": opt_state}`` from JAX's:
    Adam's ``m``/``v`` and SGD's ``mom`` cross like the weights, ``step``
    becomes a 0-dim int32 tensor (Adafactor's factored moments are keyed
    by JAX leaf, not by weight, and do not cross)."""
    out = {}
    for half, (conv, _) in _HALVES.items():
        st = state[half]
        _only_param_shaped(st)
        out[half] = {k: conv(v) for k, v in st.items() if k != "step"}
        out[half]["step"] = torch.tensor(int(np.asarray(st["step"])),
                                         dtype=torch.int32)
    return out


def cyclegan_opt_state_to_jax_layout(state) -> Dict[str, dict]:
    """JAX's CycleGAN optimizer state (numpy leaves) from the port's;
    ``step`` becomes a 0-dim int32 array, as JAX keeps it."""
    out = {}
    for half, (_, conv) in _HALVES.items():
        st = state[half]
        _only_param_shaped(st)
        out[half] = {k: conv(v) for k, v in st.items() if k != "step"}
        out[half]["step"] = np.asarray(_np(st["step"]), np.int32)
    return out


def _only_param_shaped(st) -> None:
    other = sorted(set(st) - set(_PARAM_SHAPED) - {"step"})
    if other:
        raise NotImplementedError(
            f"optimizer state entries {other}: only Adam/SGD state "
            "(m, v, mom) crosses between the CycleGAN layouts")
