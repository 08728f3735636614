"""Training launcher of the port: the LM path of ``repro.launch.train``.

Trains an LM architecture on the synthetic token stream on one CUDA card
(unless ``--device cpu`` is given), with random weights from ``--seed``:
the same step and validation batches as the JAX launcher (step ``i`` uses
``train_batch(seed=i)``, validation ``seed=987654``), the same warmup
(``min(100, steps // 10 + 1)``) and the same ``step ... loss= lr=`` and
``[train] done: val=`` lines.

  python -m repro_torch.launch.train --arch qwen3-0.6b --batch 4 --seq 4096
  python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --device cpu

Not ported yet: training the recurrent archs (``xlstm-125m``,
``jamba-1.5-large-398b``; ROADMAP.md queue A7), ``--arch icf-cyclegan`` (the
paper's CycleGAN) and the checkpoint flags (``--ckpt-dir``,
``--ckpt-every``, ``--no-resume``; ``checkpoint/ckpt.py`` writes a JAX
tree-path format and is ported with the LTFB slice; queue A3).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.configs.registry import ARCHS, UNPORTED, get_config
from repro_torch.data.tokens import train_batch
from repro_torch.models.lm import has_recurrent
from repro_torch.train.steps import (init_lm_state, make_lm_eval_metric,
                                     make_lm_train_step)

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
    if args.arch == "icf-cyclegan":
        raise NotImplementedError(
            "--arch icf-cyclegan (the paper's CycleGAN) is not ported to "
            "repro_torch yet; see ROADMAP.md queue A3")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if has_recurrent(cfg):
        raise NotImplementedError(
            f"--arch {args.arch}: training the recurrent families is not "
            "ported to repro_torch yet (the scan kernels have no backward); "
            "see ROADMAP.md queue A7")
    opt_cfg = OptimizerConfig(name=args.optimizer, lr=args.lr,
                              warmup_steps=min(100, args.steps // 10 + 1))
    state = init_lm_state(cfg, opt_cfg, seed=args.seed, device=device)
    return Trainer(cfg, opt_cfg, device, state,
                   make_lm_train_step(cfg, opt_cfg, remat=args.remat),
                   make_lm_eval_metric(cfg))


def device_batch(cfg: ModelConfig, batch: int, seq: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """``train_batch`` (numpy, bit-identical to JAX's) as int64 tensors on
    ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long().to(device)
            for k, v in train_batch(cfg, batch, seq, seed=seed).items()}


def train_lm(args) -> Dict[str, object]:
    """Run ``--steps`` steps, printing the JAX launcher's lines; returns
    the per-step losses and lrs and the final validation loss."""
    tr = build_trainer(args)
    n_params = sum(p.numel() for p in tr.state["model"].parameters())
    print(f"[train] arch={tr.cfg.name} params={n_params / 1e6:.1f}M "
          f"device={tr.device} dtype={tr.cfg.dtype} remat={args.remat} "
          f"batch={args.batch} seq={args.seq}")
    val = device_batch(tr.cfg, args.batch, args.seq, VAL_SEED, tr.device)
    losses, lrs = [], []
    t0 = time.time()
    for i in range(args.steps):
        batch = device_batch(tr.cfg, args.batch, args.seq, i, tr.device)
        _, m = tr.step(tr.state, batch)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        if i % args.log_every == 0:
            print(f"step {i:5d} loss={losses[-1]:.4f} lr={lrs[-1]:.2e} "
                  f"({(time.time() - t0):.1f}s)")
    val_loss = float(tr.metric(tr.state["model"], val))
    print(f"[train] done: val={val_loss:.4f}")
    return {"losses": losses, "lrs": lrs, "val": val_loss}


def build_parser() -> argparse.ArgumentParser:
    """The port's train CLI argument parser."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.train",
        description="LM training on one CUDA card (PyTorch port)")
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=sorted(ARCHS) + sorted(UNPORTED))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where weights, optimizer state and kernels run; "
                         "cuda raises when no card is visible")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adam",
                    choices=("adam", "adamw", "adafactor", "sgd"))
    ap.add_argument("--remat", default="full",
                    choices=("none", "full", "dots", "dots_no_batch"),
                    help="per-block rematerialization (dots* not ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None) -> int:
    """CLI entry point."""
    train_lm(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
