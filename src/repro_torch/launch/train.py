"""Training launcher of the port (``repro.launch.train``): an LM on the
synthetic token stream, or the paper's CycleGAN on JAG samples.

Trains on one CUDA card (unless ``--device cpu`` is given), with random
weights from ``--seed``.  The LM path takes the same step and validation
batches as the JAX launcher (step ``i`` uses ``train_batch(seed=i)``,
validation ``seed=987654``), the same warmup (``min(100, steps // 10 +
1)``) and prints the same ``step ... loss= lr=`` and ``[train] done: val=``
lines.  ``--arch icf-cyclegan`` mirrors the JAX launcher's CycleGAN path:
its config (64 x 64 images, or 16 x 16 under ``--smoke``, with the
narrower autoencoder ``enc_hidden=(256, 64)``, ``dec_hidden=(64, 256)``),
``--samples`` JAG samples plus 512 held out, batches of 128 drawn with
numpy from ``--seed``, and its ``step ... g= d= val=`` lines.

  python -m repro_torch.launch.train --arch qwen3-0.6b --batch 4 --seq 4096
  python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --device cpu
  python -m repro_torch.launch.train --arch icf-cyclegan --smoke --device cpu
  python -m repro_torch.launch.train --arch deepseek-moe-16b --smoke \
      --device cpu
  python -m repro_torch.launch.train --arch qwen2-vl-7b --smoke --device cpu
  python -m repro_torch.launch.train --arch xlstm-125m --batch 4 --seq 4096
  python -m repro_torch.launch.train --arch jamba-1.5-large-398b --smoke \
      --device cpu

Every LM arch trains: the recurrent ones (xlstm-125m, jamba) through the
scans' backward kernels, the MoE archs with capacity
dispatch and their aux losses in the loss, qwen2-vl-7b on the stub
frontend's ``embeds`` and M-RoPE ``positions``, musicgen-medium on folded
codebook token ids.  The ``[train]`` line counts the parameters and the
active ones (those a token runs through: its top-k experts), on which an
mfu is reckoned (6 * active * tokens).

The LM path checkpoints as the JAX launcher does: every ``--ckpt-every``
steps (step 0 excepted) ``<ckpt-dir>/step_<i>.ckpt`` is written in the
background (``ckpt.AsyncCheckpointer``) in JAX's state layout
(``{"params", "opt_state"}``, weights stacked into periods by
:func:`repro_torch.bridge.params_to_jax_layout`, metadata ``{"step": i}``),
and a rerun resumes from the newest one at its step unless
``--no-resume``; either package resumes the other's files.

Not ported yet: Adafactor's state in a checkpoint (ROADMAP.md queue A14).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import bridge, resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.configs.icf_cyclegan import ARCH_ID as CYCLEGAN_ID
from repro_torch.configs.icf_cyclegan import CycleGANConfig
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.data import jag
from repro_torch.data.tokens import train_batch
from repro_torch.train.steps import (init_lm_state, make_gan_steps,
                                     make_lm_eval_metric,
                                     make_lm_train_step, tree_to)

VAL_SEED = 987654


class Trainer(NamedTuple):
    """What one LM training run holds: configs, device, state and steps."""

    cfg: ModelConfig
    opt_cfg: OptimizerConfig
    device: torch.device
    state: Dict
    step: Callable
    metric: Callable


def build_trainer(args) -> Trainer:
    """Config, optimizer, seeded state and the step/metric functions the
    flags describe (raises without a card unless ``--device cpu``)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    opt_cfg = OptimizerConfig(name=args.optimizer, lr=args.lr,
                              warmup_steps=min(100, args.steps // 10 + 1))
    state = init_lm_state(cfg, opt_cfg, seed=args.seed, device=device)
    return Trainer(cfg, opt_cfg, device, state,
                   make_lm_train_step(cfg, opt_cfg, remat=args.remat),
                   make_lm_eval_metric(cfg))


def device_batch(cfg: ModelConfig, batch: int, seq: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """``train_batch`` (numpy, bit-identical to JAX's) as tensors on
    ``device``: integer arrays as int64, the others (a vlm's ``embeds``)
    in their own dtype."""
    out = {}
    for k, v in train_batch(cfg, batch, seq, seed=seed).items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.long() if not t.is_floating_point() else t).to(device)
    return out


def checkpoint_tree(tr: Trainer) -> Dict[str, dict]:
    """The trainer's state in the JAX launcher's checkpoint layout:
    ``{"params", "opt_state"}`` stacked into periods, on the host."""
    return {"params": bridge.params_to_jax_layout(tr.state["model"],
                                                  tr.cfg),
            "opt_state": bridge.opt_state_to_jax_layout(
                tr.state["opt_state"], tr.cfg)}


def restore_trainer(tr: Trainer, path: str) -> int:
    """Load a ``step_<i>.ckpt`` (either package's) into the trainer's
    model and optimizer state; returns the step it was saved at."""
    tree, meta = ckpt.restore(path, checkpoint_tree(tr))
    with torch.no_grad():
        tr.state["model"].load_state_dict(
            bridge.params_from_jax(tree["params"], tr.cfg), strict=True)
    opt = bridge.opt_state_from_jax(tree["opt_state"], tr.cfg)
    tr.state["opt_state"] = tree_to(opt, tr.device)
    return int(meta.get("step", 0))


def _saves(args) -> bool:
    every = args.ckpt_every
    return bool(every) and any(i % every == 0 for i in range(1, args.steps))


def train_lm(args) -> Dict[str, object]:
    """Run ``--steps`` steps (from the newest checkpoint's step when one
    is found and ``--no-resume`` is not given), printing the JAX
    launcher's lines and checkpointing every ``--ckpt-every`` steps;
    returns the per-step losses and lrs, the final validation loss and
    the step it started at."""
    tr = build_trainer(args)
    latest: Optional[str] = None if args.no_resume \
        else ckpt.latest_step_path(args.ckpt_dir)
    if args.optimizer == "adafactor" and (latest or _saves(args)):
        raise NotImplementedError(
            "--optimizer adafactor with checkpoints: Adafactor's factored "
            "state does not cross to the JAX checkpoint layout yet; see "
            "ROADMAP.md queue A14 (or pass --ckpt-every 0 --no-resume)")
    n_params = sum(p.numel() for p in tr.state["model"].parameters())
    print(f"[train] arch={tr.cfg.name} params={n_params / 1e6:.1f}M "
          f"active={tr.cfg.param_count(active_only=True) / 1e6:.1f}M "
          f"device={tr.device} dtype={tr.cfg.dtype} remat={args.remat} "
          f"batch={args.batch} seq={args.seq}")
    start = 0
    if latest:
        start = restore_trainer(tr, latest)
        print(f"[train] resumed from {latest} at step {start}")
    saver = ckpt.AsyncCheckpointer()
    val = device_batch(tr.cfg, args.batch, args.seq, VAL_SEED, tr.device)
    losses, lrs = [], []
    t0 = time.time()
    for i in range(start, args.steps):
        batch = device_batch(tr.cfg, args.batch, args.seq, i, tr.device)
        _, m = tr.step(tr.state, batch)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        if i % args.log_every == 0:
            print(f"step {i:5d} loss={losses[-1]:.4f} lr={lrs[-1]:.2e} "
                  f"({(time.time() - t0):.1f}s)")
        if args.ckpt_every and i and i % args.ckpt_every == 0:
            saver.save(os.path.join(args.ckpt_dir, f"step_{i}.ckpt"),
                       checkpoint_tree(tr), {"step": i})
    saver.wait()
    val_loss = float(tr.metric(tr.state["model"], val))
    print(f"[train] done: val={val_loss:.4f}")
    return {"losses": losses, "lrs": lrs, "val": val_loss, "start": start}


CYCLEGAN_BATCH = 128
CYCLEGAN_VAL = 512


def cyclegan_config(smoke: bool) -> CycleGANConfig:
    """The JAX launcher's CycleGAN config (not FULL: a narrower
    autoencoder, 16 x 16 images under ``--smoke``)."""
    return CycleGANConfig(image_size=16 if smoke else 64,
                          enc_hidden=(256, 64), dec_hidden=(64, 256))


def train_cyclegan(args) -> Dict[str, object]:
    """The paper's model: ``--steps`` GAN steps on batches of 128 from
    ``--samples`` JAG samples, validated on the next 512; returns the
    per-step losses and the final validation metric."""
    device = resolve_device(args.device)
    ccfg = cyclegan_config(args.smoke)
    init, train_step, metric = make_gan_steps(
        ccfg, OptimizerConfig(name="adam", lr=args.lr), device)
    params, opt_state, hparams = init(args.seed)
    print(f"[train] arch={ccfg.name} params={ccfg.param_count() / 1e6:.1f}M "
          f"device={device} dtype={ccfg.dtype} batch={CYCLEGAN_BATCH} "
          f"image_size={ccfg.image_size}")
    xs = jag.sample_inputs(args.samples + CYCLEGAN_VAL, seed=0)
    sim = jag.jag_simulate(xs, ccfg.image_size)
    x = torch.from_numpy(sim["x"]).to(device)
    y = torch.from_numpy(jag.flatten_outputs(sim)).to(device)
    val = {"x": x[args.samples:], "y": y[args.samples:]}
    rng = np.random.default_rng(args.seed)
    g_losses, d_losses = [], []
    for i in range(args.steps):
        idx = torch.from_numpy(
            rng.integers(0, args.samples, CYCLEGAN_BATCH)).to(device)
        batch = {"x": x[idx], "y": y[idx]}
        params, opt_state, m = train_step(params, opt_state, batch, hparams)
        g_losses.append(float(m["g_loss"]))
        d_losses.append(float(m["d_loss"]))
        if i % args.log_every == 0:
            print(f"step {i:5d} g={g_losses[-1]:.4f} d={d_losses[-1]:.4f} "
                  f"val={float(metric(params, val)):.4f}")
    val_metric = float(metric(params, val))
    print(f"[train] done: val={val_metric:.4f}")
    return {"g_losses": g_losses, "d_losses": d_losses, "val": val_metric}


def build_parser() -> argparse.ArgumentParser:
    """The port's train CLI argument parser."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.train",
        description="LM or CycleGAN training on one CUDA card (PyTorch "
                    "port)")
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where weights, optimizer state and kernels run; "
                         "cuda raises when no card is visible")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--samples", type=int, default=8000,
                    help="JAG training samples (icf-cyclegan)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adam",
                    choices=("adam", "adamw", "adafactor", "sgd"))
    ap.add_argument("--remat", default="full",
                    choices=("none", "full", "dots", "dots_no_batch"),
                    help="per-block rematerialization (dots* not ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_ckpt"),
                    help="step checkpoints of the LM path (default: "
                         "repro_ckpt in the temp dir)")
    ap.add_argument("--ckpt-every", type=int, default=100,
                    help="checkpoint every N steps (0 = never)")
    ap.add_argument("--no-resume", action="store_true",
                    help="start at step 0 even when --ckpt-dir holds a "
                         "checkpoint")
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None) -> int:
    """CLI entry point: train the selected arch."""
    args = build_parser().parse_args(argv)
    if args.arch == CYCLEGAN_ID:
        train_cyclegan(args)
    else:
        train_lm(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
