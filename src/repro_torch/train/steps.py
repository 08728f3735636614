"""Train and eval steps of the port (``repro.train.steps``): the LM steps
and the CycleGAN's.

``init_lm_state``        model and optimizer state from a seed
``make_optimizer``       the optimizer, its leaves grouped as JAX stacks
                         them (Adafactor clips and factors per group)
``make_lm_train_step``   loss + grads + global-norm clip + lr schedule +
                         optimizer update (the ``train_4k`` cells' step)
``make_lm_eval_metric``  held-out cross entropy (the tournament metric)
``make_lm_population_fns`` the LM as an LTFB trainer: a functional step
                         over ``{name: tensor}`` weights, the metric, and
                         the checkpoint layout of the JAX package
``make_gan_steps``       the paper's CycleGAN: ``(init, train_step,
                         metric)`` for an LTFB trainer
``make_gan_disc_metric`` the GAN tournament metric against the local
                         discriminator

The state is ``{"model": LM, "opt_state": dict}``.  Unlike JAX's
functional step, which returns a new state, the train step copies the new
weights into the model's parameters **in place** and replaces
``opt_state``'s entries; it returns the same state dict.  The raw
(unclipped) gradients of the last step stay in each parameter's ``.grad``
until the next step.

The population's LM step and the CycleGAN step are functional, as JAX's:
their weights and optimizer state are ``{name: tensor}`` dicts and they
return new ones, writing into none they were given (the tournament hands
an adopted model over by reference; see
:mod:`repro_torch.models.icf_cyclegan`).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from repro_torch import bridge, resolve_device
from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.configs.icf_cyclegan import CycleGANConfig
from repro_torch.models import icf_cyclegan as cg
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
    ``batch`` (``tokens``/``labels``, or a vlm's ``embeds``/``positions``/
    ``labels``, tensors on the model's device).

    The lr is ``lr_schedule`` at the optimizer's step count BEFORE the
    update, so step 0 runs at lr 0 and leaves the weights unchanged, as in
    JAX.  Metrics are 0-dim tensors on the device: ``loss``, ``ce``,
    ``moe_load_balance``, ``moe_z`` (zero without MoE), ``lr`` and, with
    clipping, ``grad_norm``.

    The clip and the update run one parameter group
    (:func:`repro_torch.models.lm.param_groups`) at a time, each group's
    new moments replacing its old ones before the next group's are made:
    the numbers are those of one update over every weight (Adam and SGD
    work element by element, Adafactor leaf by leaf), but the step holds
    one group's new state at a time instead of a second copy of the
    whole optimizer state, as JAX's step reuses its donated buffers.
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
        # a weight the loss does not read (a vlm's token embedding, which
        # the patch embeddings replace) gets the zero gradient JAX gives it
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        metrics = {k: v.detach() for k, v in metrics.items()}
        scale = None
        if opt_cfg.grad_clip_norm:
            gnorm = opt_lib.global_norm(grads)
            scale = opt_lib.clip_scale(gnorm, opt_cfg.grad_clip_norm)
            metrics["grad_norm"] = gnorm
        opt_state = state["opt_state"]
        lr = opt_lib.lr_schedule(opt_cfg, opt_state["step"])
        step = None
        with torch.no_grad():
            for key, members in lm.param_groups(cfg, params).items():
                g = {n: grads[n] for n in members}
                if scale is not None:
                    g = opt_lib.scale_grads(g, scale)
                new_params, new_opt = optimizer.update(
                    g, _substate(opt_state, members + [key]),
                    {n: params[n].detach() for n in members}, lr)
                for n in members:
                    params[n].copy_(new_params[n])
                for k, v in new_opt.items():
                    if isinstance(v, dict):
                        opt_state[k].update(v)
                step = new_opt["step"]
            opt_state["step"] = step
        return state, {**metrics, "loss": loss.detach(), "lr": lr}

    return train_step


def _substate(opt_state: dict, keys) -> dict:
    """An optimizer state cut to the entries of ``keys`` (weight names and
    group keys) in each of its dicts; ``step`` as it is."""
    return {k: {n: v[n] for n in keys if n in v} if isinstance(v, dict)
            else v for k, v in opt_state.items()}


def make_lm_eval_metric(cfg: ModelConfig) -> Callable:
    """``metric(model, batch) -> loss``: held-out cross entropy (lower is
    better), without gradients."""

    @torch.no_grad()
    def metric(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return lm.lm_loss(model, batch)[0]

    return metric


class _Skeleton:
    """An LM module with no weights of its own, bound to a trainer's
    ``{name: tensor}`` weights for the length of one call.

    Binding sets each parameter slot to an ``nn.Parameter`` that shares the
    given tensor's storage (no copy); unbinding empties the slots again, so
    an idle skeleton holds no weights.  ``torch.func.functional_call``
    would not do here: its substitution ends when the forward returns,
    and ``remat="full"`` recomputes each block during the backward, which
    must see the same weights.  One skeleton serves every call in turn
    (the tournament's metrics run on a pool of threads): on one card the
    forwards run one after another anyway, and each holds a tournament
    batch's ``(B, S, V)`` logits.
    """

    def __init__(self, cfg: ModelConfig, device: torch.device):
        with torch.device(device):
            model = lm.LM(cfg)
        self._slots = []
        for name, _ in model.named_parameters():
            owner, _, leaf = name.rpartition(".")
            self._slots.append((model.get_submodule(owner), leaf, name))
        self._empty()
        self.model = model
        self._lock = threading.Lock()

    @property
    def names(self) -> List[str]:
        """The model's parameter names, in order."""
        return [name for _, _, name in self._slots]

    def ordered(self, tensors: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """``tensors`` in the model's parameter order (the global-norm
        clip sums the gradients in this order)."""
        return {name: tensors[name] for _, _, name in self._slots}

    def _empty(self) -> None:
        for module, leaf, _ in self._slots:
            module._parameters[leaf] = None

    @contextlib.contextmanager
    def bound(self, params: Dict[str, torch.Tensor], grad: bool = False
              ) -> Iterator[Tuple[lm.LM, Dict[str, nn.Parameter]]]:
        """``(model, leaves)``: the skeleton holding ``params`` (``leaves``
        the bound parameters by name, requiring grad when ``grad``); the
        call waits while another holds the skeleton."""
        with self._lock:
            try:
                leaves = {}
                for module, leaf, name in self._slots:
                    p = nn.Parameter(params[name].detach(),
                                     requires_grad=grad)
                    module._parameters[leaf] = leaves[name] = p
                self.model.train(grad)
                yield self.model, leaves
            finally:
                self._empty()


def make_lm_population_fns(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                           remat: str = "full", device="cuda"
                           ) -> Tuple[Callable, ...]:
    """``(init, train_step, metric, to_ckpt, from_ckpt)`` for an LM
    trainer in an LTFB tournament
    (:class:`repro_torch.core.population.TrainerFns`;
    ``repro.train.steps.make_lm_population_fns``), on ``device`` (the card
    unless the caller asks for ``"cpu"``).

    * ``init(seed) -> (params, opt_state, hparams)``: weights from
      :func:`~repro_torch.models.lm.init_lm` as a ``{name: tensor}`` dict,
      the optimizer's zero state, ``{"lr": opt_cfg.lr}``;
    * ``train_step(params, opt_state, batch, hparams) -> (params,
      opt_state, metrics)``: the step of :func:`make_lm_train_step` (loss,
      gradients, global-norm clip, the lr schedule at the optimizer's step
      count, the update), returning new tensors and writing into none of
      the given ones; as in JAX the lr follows the schedule, and
      ``hparams["lr"]`` is PBT bookkeeping only;
    * ``metric(params, batch)``: held-out cross entropy, without gradients
      (it runs on the tournament's worker threads, where grad mode is the
      thread's own);
    * ``to_ckpt`` / ``from_ckpt``: weights and optimizer state to JAX's
      stacked layout (:func:`repro_torch.bridge.params_to_jax_layout`) and
      back onto ``device``, so that either package restores the other's
      population checkpoints (Adafactor's grouped factors included).
    """
    dev = resolve_device(device)
    optimizer = make_optimizer(cfg, opt_cfg)
    skeleton = _Skeleton(cfg, dev)

    def init(seed: int):
        model = lm.init_lm(cfg, seed=seed, device=dev)
        params = {n: p.detach() for n, p in model.named_parameters()}
        return params, optimizer.init(params), {"lr": opt_cfg.lr}

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor],
                   hparams):
        with skeleton.bound(params, grad=True) as (model, leaves):
            loss, metrics = lm.lm_loss(model, batch, remat=remat)
            grads = {n: torch.zeros_like(leaves[n]) if g is None else g
                     for n, g in zip(leaves, torch.autograd.grad(
                         loss, list(leaves.values()), allow_unused=True))}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if opt_cfg.grad_clip_norm:
            grads, gnorm = opt_lib.clip_by_global_norm(
                grads, opt_cfg.grad_clip_norm)
            metrics["grad_norm"] = gnorm
        lr = opt_lib.lr_schedule(opt_cfg, opt_state["step"])
        with torch.no_grad():
            new_params, new_opt = optimizer.update(grads, opt_state, params,
                                                   lr)
        return new_params, new_opt, {**metrics, "loss": loss.detach(),
                                     "lr": lr}

    # the step launches the port's kernels through ctypes, whose FLOPs
    # FlopCounterMode cannot see: step_flops reports None for it, as the
    # JAX package's step_flops does for its LM step
    train_step.hidden_kernel_flops = True

    @torch.no_grad()
    def metric(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with skeleton.bound(params) as (model, _):
            return lm.lm_loss(model, batch)[0]

    def to_ckpt(params, opt_state):
        return (bridge.params_to_jax_layout(params, cfg),
                bridge.opt_state_to_jax_layout(opt_state, cfg))

    def from_ckpt(params, opt_state):
        # the layout conversion (stack splits, transposes) runs on the
        # trainers' device: one upload a leaf, no strided copy on the host
        opt = tree_to(bridge.opt_state_from_jax(
            tensors_to(opt_state, dev), cfg), dev)
        # per-weight moments in parameter order, Adafactor's factors in
        # the optimizer's group order
        groups = list(lm.param_groups(cfg, skeleton.names))
        opt = {k: v if not isinstance(v, dict)
               else {g: v[g] for g in groups} if k in ("vr", "vc")
               else skeleton.ordered(v) for k, v in opt.items()}
        return skeleton.ordered(params_from_ckpt(cfg, params, dev)), opt

    return init, train_step, metric, to_ckpt, from_ckpt


def params_from_ckpt(cfg: ModelConfig, tree, device,
                     dtype: torch.dtype = None) -> Dict[str, torch.Tensor]:
    """An LM's ``{name: tensor}`` weights on ``device`` (cast to ``dtype``
    when given) from a checkpoint's params tree in JAX's layout; the
    layout conversion runs on ``device``."""
    return {n: t.to(device=device, dtype=dtype or t.dtype)
            for n, t in bridge.params_from_jax(
                tensors_to(tree, device), cfg).items()}


def tree_to(tree, device):
    """A nested dict of tensors with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def tensors_to(tree, device):
    """``tree`` (nested dicts, lists and tuples) with its tensor leaves
    moved to ``device`` and its other leaves as they are."""
    if isinstance(tree, dict):
        return {k: tensors_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tensors_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------------
# CycleGAN steps (the paper's model)
# ---------------------------------------------------------------------------


# profiler range around the GAN step's two optimizer updates: a profile
# of the step reads the optimizer's device time under this name
OPTIMIZER_RANGE = "gan_step.optimizer"


def _value_and_grad(loss_fn, wrt: Dict[str, torch.Tensor], *args):
    """(loss, metrics, grads) of ``loss_fn(wrt, *args)`` with respect to
    ``wrt``, on leaves that share ``wrt``'s storage (no copy); everything
    returned is detached."""
    leaves = {n: p.detach().requires_grad_() for n, p in wrt.items()}
    loss, metrics = loss_fn(leaves, *args)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(leaves, grads)))


def make_gan_steps(ccfg: CycleGANConfig, opt_cfg: OptimizerConfig,
                   device="cuda") -> Tuple[Callable, Callable, Callable]:
    """``(init, train_step, metric)`` for an LTFB trainer
    (:class:`repro_torch.core.population.TrainerFns`), on ``device`` (the
    card unless the caller asks for ``"cpu"``).

    * ``init(seed) -> (params, opt_state, hparams)``: weights from
      :func:`~repro_torch.models.icf_cyclegan.init_cyclegan`, one Adam
      state each for ``gen`` and ``disc``, ``{"lr": opt_cfg.lr}``;
    * ``train_step(params, opt_state, batch, hparams) -> (params,
      opt_state, metrics)``: a discriminator update, then a generator
      update against the UPDATED discriminator, both at ``hparams["lr"]``
      (no schedule, no clip); new dicts, nothing written in place;
      metrics are 0-dim tensors (``g_loss``, ``d_loss``, ``disc_loss``,
      ``disc_acc``, ``recon``, ``forward``, ``cycle``, ``adv_gen``,
      ``latent``);
    * ``metric(params, batch)``: the validation metric, without gradients
      (it runs on the tournament's worker threads, where grad mode is the
      thread's own).
    """
    dev = resolve_device(device)
    optimizer = opt_lib.make_optimizer(opt_cfg)

    def init(seed: int):
        params = cg.init_cyclegan(ccfg, seed, dev)
        opt_state = {"gen": optimizer.init(params["gen"]),
                     "disc": optimizer.init(params["disc"])}
        return params, opt_state, {"lr": opt_cfg.lr}

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor],
                   hparams):
        lr = hparams["lr"]
        # --- discriminator ---
        d_loss, d_metrics, d_grads = _value_and_grad(
            cg.discriminator_loss, params["disc"], params["gen"], ccfg,
            batch)
        with torch.no_grad(), record_function(OPTIMIZER_RANGE):
            new_disc, new_dopt = optimizer.update(
                d_grads, opt_state["disc"], params["disc"], lr)
        # --- generator ---
        g_loss, g_metrics, g_grads = _value_and_grad(
            cg.generator_loss, params["gen"], new_disc, ccfg, batch)
        with torch.no_grad(), record_function(OPTIMIZER_RANGE):
            new_gen, new_gopt = optimizer.update(
                g_grads, opt_state["gen"], params["gen"], lr)
        metrics = {"g_loss": g_loss, "d_loss": d_loss, **d_metrics,
                   **g_metrics}
        return ({"gen": new_gen, "disc": new_disc},
                {"gen": new_gopt, "disc": new_dopt}, metrics)

    @torch.no_grad()
    def metric(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return cg.validation_metric(params, ccfg, batch)

    return init, train_step, metric


def make_gan_disc_metric(ccfg: CycleGANConfig) -> Callable:
    """The GAN tournament metric: score a (possibly foreign) generator
    against the LOCAL discriminator, without gradients."""

    @torch.no_grad()
    def metric(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return cg.discriminator_metric(params, ccfg, batch)

    return metric
