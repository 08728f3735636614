"""Optimizers as plain functions over named parameters: Adam/AdamW,
Adafactor and SGD, with the update formulas of ``repro.optim.optimizers``
as written there.

* every update runs in f32 and casts back to the parameter's dtype once;
* Adam's moments are kept in ``moment_dtype``; weight decay adds
  ``lr * wd * p`` to the step; ``eps`` comes after the ``sqrt`` of the
  bias-corrected ``v``;
* the global-norm clip scales in f32 and casts back to the gradient's
  dtype.

``torch.optim.Adam`` is not used: it keeps bf16 moments for bf16
parameters and rounds the update twice.  Parameters, gradients and
moments are ``{name: tensor}`` dicts (the model's ``named_parameters``);
``update`` returns new dicts and changes nothing in place.

One difference from the JAX package is structural, not in the formulas:
JAX stacks each weight of the layers of a period into one leaf, the port
keeps one tensor per layer.  Adam and SGD work element by element and do
not see it.  Adafactor does: its update clip is the RMS of a whole leaf's
update, and it factors a stacked norm scale as an (L, d) matrix.  So
Adafactor takes a ``grouping`` (:func:`repro_torch.models.lm.param_groups`
for a model), stacks each group's tensors as JAX stacks the leaf, and
clips and factors over the stack; its ``vr``/``vc`` are keyed by group.
"""
from __future__ import annotations

import math
from typing import (Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Tuple)

import torch

from repro_torch.configs.base import OptimizerConfig

Tensors = Dict[str, torch.Tensor]
# parameter names -> {group key: member names in stack order}
Grouping = Callable[[Iterable[str]], Dict[str, List[str]]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Optimizer(NamedTuple):
    """``init(params) -> state`` and ``update(grads, state, params, lr)
    -> (new_params, new_state)``."""

    init: Callable[[Tensors], dict]
    update: Callable[..., Tuple[Tensors, dict]]


def global_norm(tensors: Tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors.values()))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The global-norm clip's factor ``min(1, max_norm / max(norm,
    1e-9))``."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def scale_grads(grads: Tensors, scale: torch.Tensor) -> Tensors:
    """Every gradient times ``scale`` in f32, cast back to its dtype."""
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}


def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-9))`` in
    f32, cast back to its dtype; returns (clipped, norm)."""
    norm = global_norm(grads)
    return scale_grads(grads, clip_scale(norm, max_norm)), norm


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then constant, cosine or linear decay; f32.  Step 0
    gives lr 0."""
    step = step.float()
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    if cfg.schedule in ("cosine", "linear"):
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(1, cfg.total_steps - cfg.warmup_steps),
                           0.0, 1.0)
        decay = 0.5 * (1 + torch.cos(math.pi * frac)) \
            if cfg.schedule == "cosine" else 1.0 - frac
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def _step0(params: Tensors) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def make_adam(cfg: OptimizerConfig) -> Optimizer:
    """Adam, or AdamW when ``cfg.weight_decay`` is set."""
    mdt = _DTYPES[cfg.moment_dtype]

    def init(params: Tensors) -> dict:
        return {"m": {n: torch.zeros_like(p, dtype=mdt)
                      for n, p in params.items()},
                "v": {n: torch.zeros_like(p, dtype=mdt)
                      for n, p in params.items()},
                "step": _step0(params)}

    def update(grads: Tensors, state: dict, params: Tensors,
               lr: Optional[torch.Tensor] = None):
        lr_ = cfg.lr if lr is None else lr
        step = state["step"] + 1
        t = step.float()
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        new_p, new_m, new_v = {}, {}, {}
        for n, p in params.items():
            g32 = grads[n].float()
            m32 = b1 * state["m"][n].float() + (1 - b1) * g32
            v32 = b2 * state["v"][n].float() + (1 - b2) * g32 * g32
            mh = m32 / bc1
            vh = v32 / bc2
            delta = lr_ * mh / (torch.sqrt(vh) + cfg.eps)
            if cfg.weight_decay:
                delta = delta + lr_ * cfg.weight_decay * p.float()
            new_p[n] = (p.float() - delta).to(p.dtype)
            new_m[n], new_v[n] = m32.to(mdt), v32.to(mdt)
        return new_p, {"m": new_m, "v": new_v, "step": step}

    return Optimizer(init, update)


def _stacked(tensors: Tensors, key: str, members: List[str]
             ) -> torch.Tensor:
    """A group's tensors as one leaf: stacked along a new leading axis, as
    JAX stacks a period's layers; a lone tensor outside the stack (its
    key is its own name) as it is."""
    if members == [key]:
        return tensors[key]
    return torch.stack([tensors[n] for n in members])


def make_adafactor(cfg: OptimizerConfig,
                   grouping: Optional[Grouping] = None) -> Optimizer:
    """Adafactor: factored second moments for leaves of rank >= 2, the
    ``1 - t**-0.8`` decay, update clipping at RMS 1.

    A leaf is a group of ``grouping(names)`` (each tensor its own leaf
    without one): the group's tensors stacked, so the clip and the
    factoring span the stack as in the JAX package.  ``vr``/``vc`` are
    keyed by group.
    """

    def groups_of(params: Tensors) -> Dict[str, List[str]]:
        return grouping(params) if grouping is not None \
            else {n: [n] for n in params}

    def init(params: Tensors) -> dict:
        vr, vc = {}, {}
        for key, members in groups_of(params).items():
            p0 = params[members[0]]
            shape = p0.shape if members == [key] \
                else (len(members),) + p0.shape
            kw = dict(dtype=torch.float32, device=p0.device)
            if len(shape) >= 2:
                vr[key] = torch.zeros(shape[:-1], **kw)
                vc[key] = torch.zeros(shape[:-2] + shape[-1:], **kw)
            else:
                vr[key] = torch.zeros(shape, **kw)
                vc[key] = torch.zeros((1,), **kw)    # unused pad slot
        return {"vr": vr, "vc": vc, "step": _step0(params)}

    def update(grads: Tensors, state: dict, params: Tensors,
               lr: Optional[torch.Tensor] = None):
        lr_ = cfg.lr if lr is None else lr
        step = state["step"] + 1
        t = step.float()
        beta = 1.0 - t ** (-0.8)
        eps = 1e-30
        new_p, new_vr, new_vc = {}, {}, {}
        for key, members in groups_of(params).items():
            p = _stacked(params, key, members)
            g32 = _stacked(grads, key, members).float()
            vr, vc = state["vr"][key], state["vc"][key]
            if p.dim() >= 2:
                nvr = beta * vr + (1 - beta) * torch.mean(g32 * g32, dim=-1)
                nvc = beta * vc + (1 - beta) * torch.mean(g32 * g32, dim=-2)
                denom = torch.clamp(torch.mean(nvr, dim=-1, keepdim=True),
                                    min=eps)
                v = (nvr[..., None] * nvc[..., None, :]) / denom[..., None]
            else:
                nvr = beta * vr + (1 - beta) * g32 * g32
                nvc = vc
                v = nvr
            u = g32 / torch.sqrt(v + 1e-12)
            rms = torch.sqrt(torch.mean(u ** 2) + 1e-12)
            u = u / torch.clamp(rms, min=1.0)
            new = (p.float() - lr_ * u).to(p.dtype)
            if members == [key]:
                new_p[key] = new
            else:
                new_p.update(zip(members, new.unbind(0)))
            new_vr[key], new_vc[key] = nvr, nvc
        return new_p, {"vr": new_vr, "vc": new_vc, "step": step}

    return Optimizer(init, update)


def make_sgd(cfg: OptimizerConfig, momentum: float = 0.9) -> Optimizer:
    """SGD with heavy-ball momentum kept in f32."""

    def init(params: Tensors) -> dict:
        return {"mom": {n: torch.zeros_like(p, dtype=torch.float32)
                        for n, p in params.items()},
                "step": _step0(params)}

    def update(grads: Tensors, state: dict, params: Tensors,
               lr: Optional[torch.Tensor] = None):
        lr_ = cfg.lr if lr is None else lr
        new_p, new_m = {}, {}
        for n, p in params.items():
            m32 = momentum * state["mom"][n] + grads[n].float()
            new_p[n] = (p.float() - lr_ * m32).to(p.dtype)
            new_m[n] = m32
        return new_p, {"mom": new_m, "step": state["step"] + 1}

    return Optimizer(init, update)


def make_optimizer(cfg: OptimizerConfig,
                   grouping: Optional[Grouping] = None) -> Optimizer:
    """The optimizer ``cfg.name`` names; ``grouping`` reaches Adafactor,
    the only leaf-wise one."""
    if cfg.name in ("adam", "adamw"):
        return make_adam(cfg)
    if cfg.name == "adafactor":
        return make_adafactor(cfg, grouping)
    if cfg.name == "sgd":
        return make_sgd(cfg)
    raise ValueError(cfg.name)
