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
  python -m repro_torch.launch.ltfb --backend mesh --trainers 4 \
      --smoke --device cpu                 # 4 ranks over gloo
  torchrun --nproc-per-node 4 -m repro_torch.launch.ltfb --backend mesh

``--backend mesh`` runs one process rank a trainer (SPMD over
``torch.distributed``), the tournament a point-to-point butterfly
exchange between the ranks (``--quantize-exchange``: int8 on the wire).
Started without torchrun's environment the CLI spawns ``--trainers``
ranks of itself on this host (:func:`repro_torch.launch.mesh.spawn`);
under torchrun it joins as a rank.  ``--dist-backend`` is ``nccl`` on
``cuda`` (one card a rank) and ``gloo`` on ``cpu``; ranks that share a
card must ask for ``gloo``.  ``--dist-timeout`` bounds every collective,
so a dead rank fails the run.  Rank 0 prints the records; the others are
silent.  Rank 0 writes the manifest, the genealogy, the trace and the
Prometheus snapshot; every rank writes its own checkpoint member, in the
host backend's layout.

Resumes from --ckpt-dir automatically unless --no-resume.  Checkpoints
hold the JAX package's layout, so either package resumes the other's.
LM tournaments run over every token arch (the recurrent ones, MoE and
audio included).  Telemetry as in the JAX launcher: ``--log-json`` turns
every report line into one JSON record, ``--trace-out`` writes a
Chrome trace of every trainer's steps, data waits, evals and exchanges,
``--prom-out`` a Prometheus snapshot each round, ``--metrics-port``
serves it over HTTP (0 = an ephemeral port), and ``--genealogy``
(default ``<ckpt-dir>/genealogy.jsonl`` with ``--ckpt-dir``) logs the
tournament's ancestry for ``python -m repro_torch.launch.lineage``.
Not ported yet: LM tournaments over qwen2-vl-7b, whose token shards hold
no embeddings (A15; the JAX launcher fails on them too), and
``--rescale-to`` on the mesh backend (A17).  ``--optimizer adafactor``
trains and checkpoints every LM arch; the CycleGAN's checkpoint layout
carries Adam and SGD state only, so it refuses Adafactor there.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from repro_torch import bridge, resolve_device
from repro_torch.configs.base import OptimizerConfig, replace
from repro_torch.configs.icf_cyclegan import ARCH_ID, FULL, SMOKE
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core.population import TrainerFns
from repro_torch.core.tournament import (
    DataPlan,
    TournamentConfig,
    TournamentOrchestrator,
)
from repro_torch.data import jag, tokens
from repro_torch.launch import mesh
from repro_torch.telemetry import (enable_json_logs, json_logs_enabled,
                                   log_event, write_trace)
from repro_torch.train import telemetry as train_tel
from repro_torch.train.steps import (make_gan_steps,
                                     make_lm_population_fns, tree_to)

def say(human: str, event: str, **fields):
    """Report line: one-line JSON under --log-json, human text otherwise
    (the JAX launcher's records, same event names)."""
    if json_logs_enabled():
        log_event(event, **fields)
    else:
        print(human)


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
    if args.backend == "mesh" and args.rescale_to:
        raise NotImplementedError(
            "--rescale-to with --backend mesh (a new number of process "
            "ranks mid-run) is not ported to repro_torch yet; see "
            "ROADMAP.md queue A17")


def check_mesh(args) -> None:
    """Refuse, in the launching process and before any rank starts, a
    mesh the ranks could not lay out: a trainer count that is not a power
    of two, no card for ``--device cuda``, or ``nccl`` with the CPU or
    with more ranks than cards."""
    k = args.trainers
    if k < 2 or k & (k - 1):
        raise ValueError(
            f"--backend mesh needs power-of-two --trainers >= 2, got {k}")
    dev = resolve_device(args.device)
    mesh.choose_backend(args.dist_backend, dev.type, k,
                        torch.cuda.device_count() if dev.type == "cuda"
                        else 0)


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
    say(f"[ltfb] manifest: {len(files)} JAG bundles in {root}",
        "ltfb_manifest", files=len(files), root=root, kind="jag")
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
    say(f"[ltfb] manifest: {len(files)} token shards in {root}",
        "ltfb_manifest", files=len(files), root=root, kind="tokens")
    return DataPlan.lm_tokens(files)


def lm_config(args):
    """The LM arch's config, cut to its first ``--num-layers`` layers at
    full width when that is given."""
    cfg = get_config(args.arch, smoke=args.smoke)
    return replace(cfg, num_layers=args.num_layers) if args.num_layers \
        else cfg


def build_fns(args) -> TrainerFns:
    """The trainer functions (FULL or SMOKE) on ``--device``, with the
    checkpoint layout of the JAX package: the CycleGAN's, or an LM's
    (:func:`repro_torch.train.steps.make_lm_population_fns`)."""
    device = resolve_device(args.device)
    opt = OptimizerConfig(name=args.optimizer, lr=args.lr, warmup_steps=1)
    if args.arch != ARCH_ID:
        return TrainerFns(*make_lm_population_fns(lm_config(args), opt,
                                                  device=device))
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
    """Report the per-trainer, datastore, tournament and efficiency
    lines (one JSON record each under --log-json)."""
    st = orch.stats()
    for i, d in enumerate(st["per_trainer"]):
        say(f"[ltfb] trainer {i}: files={d['files']} "
            f"cache_hits={d['cache_hits']} "
            f"cache_misses={d['cache_misses']} "
            f"file_opens={d['file_opens']} "
            f"exchange_MB={d['exchange_bytes'] / 1e6:.2f} "
            f"wins={d['wins']} adoptions={d['adoptions']} "
            f"steps={d['steps']} "
            f"data_wait_s={d['data_wait_seconds']:.2f}",
            "ltfb_trainer_stats", trainer=i, **d)
    tot = st["total"]
    say(f"[ltfb] datastore total: read_MB={tot['bytes_read'] / 1e6:.2f} "
        f"exchange_MB={tot['exchange_bytes'] / 1e6:.2f} "
        f"cache_hits={int(tot['cache_hits'])} "
        f"cache_misses={int(tot['cache_misses'])} "
        f"samples={int(tot.get('samples_fetched', 0))} "
        f"prefetch_wait_s={st['prefetch_wait_seconds']:.2f}",
        "ltfb_datastore_stats",
        prefetch_wait_seconds=st["prefetch_wait_seconds"], **tot)
    wins = [d["wins"] for d in st["per_trainer"]]
    say(f"[ltfb] tournament: rounds={st['round']} win_counts={wins} "
        f"model_exchange_MB="
        f"{st['tournament_exchange_bytes'] / 1e6:.2f} "
        f"tournament_s={st['tournament_seconds']:.2f} "
        f"ckpt_s={st['checkpoint_seconds']:.2f}",
        "ltfb_tournament_stats", rounds=st["round"], win_counts=wins,
        tournament_exchange_bytes=st["tournament_exchange_bytes"],
        tournament_seconds=st["tournament_seconds"],
        checkpoint_seconds=st["checkpoint_seconds"],
        restore_seconds=st["restore_seconds"], events=st["events"])
    eff = st.get("efficiency") or {}
    if eff.get("speedup") is not None:
        say(f"[ltfb] efficiency: speedup={eff['speedup']:.2f}x "
            f"efficiency={eff['efficiency'] * 100:.0f}% "
            f"parallel_samples_per_s="
            f"{eff['parallel_samples_per_s']:.0f}",
            "ltfb_efficiency", **eff)


def build_parser() -> argparse.ArgumentParser:
    """The port's ltfb CLI argument parser (the JAX launcher's flags, plus
    ``--device``)."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.ltfb",
        description="LTFB tournament training over the distributed "
                    "datastore (PyTorch port)")
    ap.add_argument("--arch", default=ARCH_ID,
                    choices=sorted(ARCHS))
    ap.add_argument("--num-layers", type=int, default=None,
                    help="train an LM arch cut to its first N layers, at "
                         "full width (serve its population with "
                         "repro_torch.launch.serve --num-layers N)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where weights, optimizer state and batches live; "
                         "cuda raises when no card is visible")
    ap.add_argument("--trainers", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps-per-round", type=int, default=25)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--backend", default="host", choices=("host", "mesh"),
                    help="mesh: one process rank a trainer, the exchange "
                         "point to point between ranks (spawns --trainers "
                         "ranks unless started by torchrun)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend of --backend mesh (default: "
                         "nccl on cuda, gloo on cpu; ranks sharing a card "
                         "need gloo)")
    ap.add_argument("--dist-timeout", type=float,
                    default=mesh.DEFAULT_TIMEOUT_S,
                    help="seconds a collective waits for its peers under "
                         "--backend mesh (a dead rank fails the run)")
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
                    help="int8 model exchange on the mesh backend")
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
    # telemetry, as in the JAX launcher
    ap.add_argument("--log-json", action="store_true",
                    help="one-line JSON log records instead of human text")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace JSON of per-trainer "
                         "step/exchange/eval spans here on exit")
    ap.add_argument("--prom-out", default=None,
                    help="write a Prometheus text snapshot here each round")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the Prometheus snapshot on this HTTP "
                         "port of 127.0.0.1 (0 = ephemeral)")
    ap.add_argument("--genealogy", default=None,
                    help="tournament genealogy JSONL (default: "
                         "<ckpt-dir>/genealogy.jsonl when --ckpt-dir is "
                         "set; see repro_torch.launch.lineage)")
    return ap


def finish_args(args):
    """The JAX launcher's sample defaults, rounded to whole bundles."""
    if args.samples is None:
        args.samples = 1024 if args.smoke else 16_384
    if args.samples_per_file is None:
        args.samples_per_file = 64 if args.smoke else 512
    rounded = (args.samples // args.samples_per_file) * args.samples_per_file
    if rounded != args.samples:
        say(f"[ltfb] rounding --samples {args.samples} -> {rounded} "
            "(datastore bundles must be uniform)",
            "ltfb_samples_rounded", requested=args.samples, used=rounded)
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


def _on_round(args, tel, server, write: bool = True):
    """The per-round hook writing ``--prom-out`` and updating the
    ``--metrics-port`` endpoint (None when neither is asked for).  Under
    ``--backend mesh`` every rank runs it (``stats()`` is a collective)
    and rank 0 alone writes (``write``)."""
    if not args.prom_out and args.metrics_port is None:
        return None

    def on_round(o: TournamentOrchestrator):
        text = train_tel.train_prometheus(
            o.stats(), tel.phase_seconds if tel else None)
        if args.prom_out and write:
            train_tel.write_prom(text, args.prom_out)
        if server is not None:
            server.update(text)

    return on_round


def _mesh_plan(args, ranks: mesh.Ranks) -> DataPlan:
    """Rank 0 writes (or reuses) the manifest, in a fresh temp dir unless
    ``--data-dir``; the other ranks read the directory it names."""
    root = [None]
    if ranks.rank == 0:
        args.data_dir = args.data_dir or tempfile.mkdtemp(
            prefix="repro_torch_ltfb_")
        plan = build_plan(args)
        root = [args.data_dir]
    dist.broadcast_object_list(root, src=0)
    if ranks.rank != 0:
        args.data_dir = root[0]
        plan = build_plan(args)
    return plan


def main(argv=None) -> int:
    """CLI entry point: parse args, run the LTFB tournament (under
    ``--backend mesh``, spawn the ranks or run as one)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.log_json:
        enable_json_logs()
    if args.backend == "mesh" and not mesh.launched():
        check_ported(args)
        check_mesh(args)                   # raises first without a card
        return mesh.spawn([sys.executable, "-m", "repro_torch.launch.ltfb",
                           *argv], args.trainers)
    args = finish_args(args)
    check_ported(args)
    if args.backend != "mesh":
        return _run(args, None)
    ranks = mesh.init_ranks(args.dist_backend, args.device,
                            args.dist_timeout)
    args.device = str(ranks.device)
    # rank 0 prints the records; the other ranks run silent
    with open(os.devnull, "w") as devnull, contextlib.redirect_stdout(
            devnull if ranks.rank else sys.stdout):
        rc = _run(args, ranks)
    dist.destroy_process_group()
    return rc


def _run(args, ranks) -> int:
    writer = ranks is None or ranks.rank == 0
    fns = build_fns(args)                  # raises first without a card
    plan = _mesh_plan(args, ranks) if ranks else build_plan(args)
    cfg = build_config(args)
    tel = train_tel.TrainTelemetry() \
        if (args.trace_out or args.prom_out
            or args.metrics_port is not None) else None
    gen_path = args.genealogy or (
        os.path.join(args.ckpt_dir, "genealogy.jsonl")
        if args.ckpt_dir else None)
    gen = train_tel.GenealogyLog(gen_path) if gen_path and writer else None
    server = train_tel.MetricsServer(args.metrics_port) \
        if args.metrics_port is not None and writer else None
    if server is not None:
        say(f"[ltfb] metrics endpoint: "
            f"http://127.0.0.1:{server.port}/metrics",
            "ltfb_metrics_endpoint", port=server.port)
    orch = None
    try:
        orch = TournamentOrchestrator(fns, plan, cfg, telemetry=tel,
                                      genealogy=gen)
        orch.on_round = _on_round(args, tel, server, write=writer)
        log_line = None if args.log_json else print
        if not args.no_resume and orch.maybe_resume():
            say(f"[ltfb] resumed at round {orch.population.round}",
                "ltfb_resumed", round=orch.population.round)
        say(f"[ltfb] arch={args.arch} K={args.trainers} "
            f"backend={args.backend} scope={cfg.scope} "
            f"store={args.store_mode}/{args.partition} "
            f"ranks={args.num_ranks} device={orch.device}",
            "ltfb_start", arch=args.arch, trainers=args.trainers,
            backend=args.backend, scope=cfg.scope,
            store_mode=args.store_mode, partition=args.partition,
            num_ranks=args.num_ranks, device=str(orch.device))
        first = args.rounds // 2 if args.rescale_to else args.rounds
        orch.run(first, args.steps_per_round,
                 ckpt_every=args.ckpt_every, log=log_line)
        if args.rescale_to:
            if not args.log_json:
                print(f"[ltfb] elastic rescale {args.trainers} -> "
                      f"{args.rescale_to}")
            orch.rescale(args.rescale_to)
            orch.run(args.rounds - first, args.steps_per_round,
                     ckpt_every=args.ckpt_every, log=log_line)
        report(orch)
        if args.trace_out and tel is not None:
            orch.gather_trace()
            if writer:
                write_trace(tel.tracer, args.trace_out)
            say(f"[ltfb] wrote {args.trace_out} "
                f"(Perfetto/chrome://tracing)",
                "ltfb_trace_written", path=args.trace_out,
                events=tel.tracer.emitted, dropped=tel.tracer.dropped)
    finally:
        if orch is not None:
            orch.close()
        if gen is not None:
            gen.close()
        if server is not None:
            server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
