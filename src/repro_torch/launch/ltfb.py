"""LTFB population-training launcher of the port (``repro.launch.ltfb``;
paper §III: datastore + tournament).

Runs K trainers, each fed from its own datastore partition of an on-disk
manifest (JAG bundles for the ICF CycleGAN, token shards for an LM), with
host tournaments between rounds and checkpoint/restart of the whole
population, on one CUDA card (the trainers time-share it) unless
``--device cpu`` is given.  The defaults are the JAX launcher's: FULL
widths, 16,384 samples in files of 512 (1,024 / 64 and SMOKE widths under
``--smoke``), batch 32, 25 steps a round, scope ``generator`` for the
CycleGAN and ``full`` for an LM, LM rows of ``--seq`` 64 tokens.

  python -m repro_torch.launch.ltfb --arch icf-cyclegan
  python -m repro_torch.launch.ltfb --arch icf-cyclegan --smoke --device cpu
  python -m repro_torch.launch.ltfb --arch qwen3-0.6b --seq 4096 --batch 2
  python -m repro_torch.launch.ltfb --arch qwen3-0.6b --smoke --device cpu
  python -m repro_torch.launch.ltfb --arch xlstm-125m --seq 1024 --batch 2

Resumes from --ckpt-dir automatically unless --no-resume.  Checkpoints
hold the JAX package's layout, so either package resumes the other's.
LM tournaments run over every token arch (the recurrent ones, MoE and
audio included).  Not ported yet: LM tournaments over qwen2-vl-7b, whose
token shards hold no embeddings (A15; the JAX launcher fails on them
too), ``--backend mesh`` and ``--quantize-exchange`` (A6),
``--log-json``, ``--trace-out``, ``--prom-out``, ``--metrics-port`` and
``--genealogy`` (A5).  ``--optimizer adafactor`` trains and checkpoints
every LM arch; the CycleGAN's checkpoint layout carries Adam and SGD
state only, so it refuses Adafactor there.
"""
from __future__ import annotations

import argparse
import sys
import tempfile

from repro_torch import bridge, resolve_device
from repro_torch.configs.base import OptimizerConfig
from repro_torch.configs.icf_cyclegan import ARCH_ID, FULL, SMOKE
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core.population import TrainerFns
from repro_torch.core.tournament import (
    DataPlan,
    TournamentConfig,
    TournamentOrchestrator,
)
from repro_torch.data import jag, tokens
from repro_torch.train.steps import (make_gan_steps,
                                     make_lm_population_fns, tree_to)

# flags of the JAX launcher the port refuses, and the queue that ports them
_UNPORTED_FLAGS = (("quantize_exchange", "--quantize-exchange", "A6"),
                   ("log_json", "--log-json", "A5"),
                   ("trace_out", "--trace-out", "A5"),
                   ("prom_out", "--prom-out", "A5"),
                   ("metrics_port", "--metrics-port", "A5"),
                   ("genealogy", "--genealogy", "A5"))


def check_ported(args) -> None:
    """Raise ``NotImplementedError``, naming the ROADMAP queue, for an
    arch or a flag the port does not run yet."""
    cfg = None if args.arch == ARCH_ID else get_config(args.arch,
                                                       args.smoke)
    if cfg is not None and cfg.family == "vlm":
        raise NotImplementedError(
            f"--arch {args.arch}: an LM tournament reads token shards, and "
            "a vlm backbone takes patch embeddings and (3, B, S) M-RoPE "
            "positions the shards do not hold (the JAX launcher fails on "
            "them in apply_mrope); see ROADMAP.md queue A15")
    if args.optimizer == "adafactor" and cfg is None:
        raise NotImplementedError(
            "--optimizer adafactor with --arch icf-cyclegan: the CycleGAN "
            "checkpoint layout carries Adam and SGD state only (JAX keys "
            "Adafactor's factors there by leaf, not by weight)")
    if args.backend == "mesh":
        raise NotImplementedError(
            "--backend mesh is not ported to repro_torch yet; see "
            "ROADMAP.md queue A6")
    for dest, flag, queue in _UNPORTED_FLAGS:
        value = getattr(args, dest)
        if value is not None and value is not False:    # port 0 counts
            raise NotImplementedError(
                f"{flag} is not ported to repro_torch yet; see ROADMAP.md "
                f"queue {queue}")


def build_plan(args) -> DataPlan:
    """Materialize (or reuse) the on-disk manifest: JAG bundles for the
    CycleGAN, token shards for an LM."""
    root = args.data_dir or tempfile.mkdtemp(prefix="repro_torch_ltfb_")
    if args.arch != ARCH_ID:
        return _token_plan(args, root)
    image_size = 8 if args.smoke else 64
    files = jag.list_bundles(root)
    if files:
        got = jag.read_bundle(files[0])["images"].shape[-1]
        if got != image_size:
            raise SystemExit(
                f"[ltfb] --data-dir {root} holds bundles at image size "
                f"{got}, this run needs {image_size} — use a fresh "
                "--data-dir")
    else:
        files = jag.write_bundles(root, args.samples, args.samples_per_file,
                                  image_size=image_size, seed=args.seed)
    print(f"[ltfb] manifest: {len(files)} JAG bundles in {root}")
    return DataPlan.jag_cyclegan(files)


def _token_plan(args, root: str) -> DataPlan:
    cfg = get_config(args.arch, smoke=args.smoke)
    files = tokens.list_token_shards(root)
    if files:
        probe = tokens.read_token_shard(files[0])["tokens"]
        if probe.shape[1] != args.seq + 1 or probe.max() >= cfg.vocab_size:
            raise SystemExit(
                f"[ltfb] --data-dir {root} holds shards of seq "
                f"{probe.shape[1] - 1} / max token {probe.max()}, this run "
                f"needs seq {args.seq} / vocab {cfg.vocab_size} — use a "
                "fresh --data-dir")
    else:
        files = tokens.write_token_shards(
            root, args.samples, seq_len=args.seq, vocab=cfg.vocab_size,
            samples_per_file=args.samples_per_file, seed=args.seed)
    print(f"[ltfb] manifest: {len(files)} token shards in {root}")
    return DataPlan.lm_tokens(files)


def build_fns(args) -> TrainerFns:
    """The trainer functions (FULL or SMOKE) on ``--device``, with the
    checkpoint layout of the JAX package: the CycleGAN's, or an LM's
    (:func:`repro_torch.train.steps.make_lm_population_fns`)."""
    device = resolve_device(args.device)
    opt = OptimizerConfig(name=args.optimizer, lr=args.lr, warmup_steps=1)
    if args.arch != ARCH_ID:
        return TrainerFns(*make_lm_population_fns(
            get_config(args.arch, smoke=args.smoke), opt, device=device))
    init, step, metric = make_gan_steps(SMOKE if args.smoke else FULL, opt,
                                        device)

    def to_ckpt(params, opt_state):
        return (bridge.cyclegan_params_to_jax_layout(params),
                bridge.cyclegan_opt_state_to_jax_layout(opt_state))

    def from_ckpt(params, opt_state):
        return (tree_to(bridge.cyclegan_params_from_jax(params), device),
                tree_to(bridge.cyclegan_opt_state_from_jax(opt_state),
                        device))

    return TrainerFns(init, step, metric, to_ckpt=to_ckpt,
                      from_ckpt=from_ckpt)


def report(orch: TournamentOrchestrator):
    """Print the per-trainer, datastore, tournament and efficiency lines."""
    st = orch.stats()
    for i, d in enumerate(st["per_trainer"]):
        print(f"[ltfb] trainer {i}: files={d['files']} "
              f"cache_hits={d['cache_hits']} "
              f"cache_misses={d['cache_misses']} "
              f"file_opens={d['file_opens']} "
              f"exchange_MB={d['exchange_bytes'] / 1e6:.2f} "
              f"wins={d['wins']} adoptions={d['adoptions']} "
              f"steps={d['steps']} "
              f"data_wait_s={d['data_wait_seconds']:.2f}")
    tot = st["total"]
    print(f"[ltfb] datastore total: read_MB={tot['bytes_read'] / 1e6:.2f} "
          f"exchange_MB={tot['exchange_bytes'] / 1e6:.2f} "
          f"cache_hits={int(tot['cache_hits'])} "
          f"cache_misses={int(tot['cache_misses'])} "
          f"samples={int(tot.get('samples_fetched', 0))} "
          f"prefetch_wait_s={st['prefetch_wait_seconds']:.2f}")
    wins = [d["wins"] for d in st["per_trainer"]]
    print(f"[ltfb] tournament: rounds={st['round']} win_counts={wins} "
          f"model_exchange_MB="
          f"{st['tournament_exchange_bytes'] / 1e6:.2f} "
          f"tournament_s={st['tournament_seconds']:.2f} "
          f"ckpt_s={st['checkpoint_seconds']:.2f}")
    eff = st.get("efficiency") or {}
    if eff.get("speedup") is not None:
        print(f"[ltfb] efficiency: speedup={eff['speedup']:.2f}x "
              f"efficiency={eff['efficiency'] * 100:.0f}% "
              f"parallel_samples_per_s="
              f"{eff['parallel_samples_per_s']:.0f}")


def build_parser() -> argparse.ArgumentParser:
    """The port's ltfb CLI argument parser (the JAX launcher's flags, plus
    ``--device``)."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.ltfb",
        description="LTFB tournament training over the distributed "
                    "datastore (PyTorch port)")
    ap.add_argument("--arch", default=ARCH_ID,
                    choices=sorted(ARCHS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where weights, optimizer state and batches live; "
                         "cuda raises when no card is visible")
    ap.add_argument("--trainers", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps-per-round", type=int, default=25)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--backend", default="host", choices=("host", "mesh"),
                    help="mesh: not ported (ROADMAP A6)")
    ap.add_argument("--scope", default=None,
                    help="exchange scope (default: generator for the "
                         "CycleGAN, full otherwise)")
    ap.add_argument("--store-mode", default="preload",
                    choices=("preload", "dynamic", "none"))
    ap.add_argument("--num-ranks", type=int, default=2,
                    help="simulated datastore ranks per trainer")
    ap.add_argument("--partition", default="stride",
                    choices=("stride", "block"))
    ap.add_argument("--quantize-exchange", action="store_true",
                    help="int8 model exchange on the mesh backend "
                         "(not ported: ROADMAP A6)")
    ap.add_argument("--no-async-eval", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + dataset (CPU-runnable)")
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--samples-per-file", type=int, default=None)
    ap.add_argument("--seq", type=int, default=64,
                    help="tokens a row (LM archs)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adam",
                    choices=("adam", "adamw", "adafactor", "sgd"),
                    help="adafactor: LM archs only")
    ap.add_argument("--data-dir", default=None,
                    help="bundle manifest dir (default: fresh tempdir)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="checkpoint every N rounds (0 = never)")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--rescale-to", type=int, default=0,
                    help="elastically rescale to K' trainers mid-run")
    ap.add_argument("--seed", type=int, default=0)
    # observability of the JAX launcher: not ported (ROADMAP A5)
    ap.add_argument("--log-json", action="store_true")
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--prom-out", default=None)
    ap.add_argument("--metrics-port", type=int, default=None)
    ap.add_argument("--genealogy", default=None)
    return ap


def finish_args(args):
    """The JAX launcher's sample defaults, rounded to whole bundles."""
    if args.samples is None:
        args.samples = 1024 if args.smoke else 16_384
    if args.samples_per_file is None:
        args.samples_per_file = 64 if args.smoke else 512
    rounded = (args.samples // args.samples_per_file) * args.samples_per_file
    if rounded != args.samples:
        print(f"[ltfb] rounding --samples {args.samples} -> {rounded} "
              "(datastore bundles must be uniform)")
        args.samples = max(rounded, args.samples_per_file)
    return args


def build_config(args) -> TournamentConfig:
    """The tournament the flags describe."""
    return TournamentConfig(
        trainers=args.trainers,
        scope=args.scope or ("generator" if args.arch == ARCH_ID
                             else "full"),
        backend=args.backend, store_mode=args.store_mode,
        num_ranks=args.num_ranks, partition=args.partition,
        batch_size=args.batch,
        tournament_batch_size=min(args.batch * 2, args.samples_per_file),
        async_eval=not args.no_async_eval,
        quantize_exchange=args.quantize_exchange,
        ckpt_dir=args.ckpt_dir, seed=args.seed, device=args.device)


def main(argv=None) -> int:
    """CLI entry point: parse args, run the LTFB tournament."""
    args = finish_args(build_parser().parse_args(argv))
    check_ported(args)
    fns = build_fns(args)                  # raises first without a card
    plan = build_plan(args)
    cfg = build_config(args)
    orch = TournamentOrchestrator(fns, plan, cfg)
    try:
        if not args.no_resume and orch.maybe_resume():
            print(f"[ltfb] resumed at round {orch.population.round}")
        print(f"[ltfb] arch={args.arch} K={args.trainers} "
              f"backend={args.backend} scope={cfg.scope} "
              f"store={args.store_mode}/{args.partition} "
              f"ranks={args.num_ranks} device={orch.device}")
        first = args.rounds // 2 if args.rescale_to else args.rounds
        orch.run(first, args.steps_per_round,
                 ckpt_every=args.ckpt_every, log=print)
        if args.rescale_to:
            print(f"[ltfb] elastic rescale {args.trainers} -> "
                  f"{args.rescale_to}")
            orch.rescale(args.rescale_to)
            orch.run(args.rounds - first, args.steps_per_round,
                     ckpt_every=args.ckpt_every, log=print)
        report(orch)
    finally:
        orch.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
