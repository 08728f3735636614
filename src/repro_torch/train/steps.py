"""LM train and eval steps of the port (``repro.train.steps``, LM part).

``init_lm_state``        model and optimizer state from a seed
``make_optimizer``       the optimizer, its leaves grouped as JAX stacks
                         them (Adafactor clips and factors per group)
``make_lm_train_step``   loss + grads + global-norm clip + lr schedule +
                         optimizer update (the ``train_4k`` cells' step)
``make_lm_eval_metric``  held-out cross entropy (the tournament metric)

The state is ``{"model": LM, "opt_state": dict}``.  Unlike JAX's
functional step, which returns a new state, the train step copies the new
weights into the model's parameters **in place** and replaces
``opt_state``'s entries; it returns the same state dict.  The raw
(unclipped) gradients of the last step stay in each parameter's ``.grad``
until the next step.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.models import lm
from repro_torch.optim import optimizers as opt_lib

State = Dict[str, Any]


def init_lm_state(cfg: ModelConfig, opt_cfg: OptimizerConfig, seed: int = 0,
                  device="cuda") -> State:
    """Random weights from ``seed`` on ``device`` (the card unless the
    caller asks for ``"cpu"``) and the optimizer's zero state."""
    model = lm.init_lm(cfg, seed=seed, device=device).train()
    params = dict(model.named_parameters())
    return {"model": model,
            "opt_state": make_optimizer(cfg, opt_cfg).init(params)}


def make_optimizer(cfg: ModelConfig,
                   opt_cfg: OptimizerConfig) -> opt_lib.Optimizer:
    """The optimizer for a model of ``cfg``, its leaves grouped as the JAX
    package stacks them (:func:`repro_torch.models.lm.param_groups`)."""
    return opt_lib.make_optimizer(
        opt_cfg, grouping=functools.partial(lm.param_groups, cfg))


def make_lm_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                       remat: str = "full") -> Callable:
    """``step(state, batch) -> (state, metrics)``: one optimizer step on
    ``batch`` (``tokens``/``labels`` tensors on the model's device).

    The lr is ``lr_schedule`` at the optimizer's step count BEFORE the
    update, so step 0 runs at lr 0 and leaves the weights unchanged, as in
    JAX.  Metrics are 0-dim tensors on the device: ``loss``, ``ce``,
    ``lr`` and, with clipping, ``grad_norm``.
    """
    optimizer = make_optimizer(cfg, opt_cfg)

    def train_step(state: State, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[State, Dict[str, torch.Tensor]]:
        model = state["model"]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, metrics = lm.lm_loss(model, batch, remat=remat)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if opt_cfg.grad_clip_norm:
            grads, gnorm = opt_lib.clip_by_global_norm(
                grads, opt_cfg.grad_clip_norm)
            metrics["grad_norm"] = gnorm
        lr = opt_lib.lr_schedule(opt_cfg, state["opt_state"]["step"])
        with torch.no_grad():
            new_params, state["opt_state"] = optimizer.update(
                grads, state["opt_state"],
                {n: p.detach() for n, p in params.items()}, lr)
            for n, p in params.items():
                p.copy_(new_params[n])
        return state, {**metrics, "loss": loss.detach(), "lr": lr}

    return train_step


def make_lm_eval_metric(cfg: ModelConfig) -> Callable:
    """``metric(model, batch) -> loss``: held-out cross entropy (lower is
    better), without gradients."""

    @torch.no_grad()
    def metric(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return lm.lm_loss(model, batch)[0]

    return metric
