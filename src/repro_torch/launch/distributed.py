"""Multi-process mesh serving of the port (``repro.launch.distributed``).

Runs :class:`repro_torch.serve.mesh.MeshScheduler` across OS processes,
one rank a device (``cuda:LOCAL_RANK % device_count``, as
:func:`repro_torch.launch.mesh.init_ranks` pins it; ranks share a card
over ``--dist-backend gloo``).  ``--mesh DATA,MODEL``: DATA splits each
replica's slots and page pools into in-process shards, and MODEL cuts
the weights and KV heads over MODEL ranks (N / MODEL replicas of MODEL
ranks each, on the ``('replica', 'model')`` grid of
:func:`repro_torch.launch.mesh.make_serve_mesh`; the model group's
collectives run on the default group's backend, gloo for ranks sharing a
card, nccl for a card a rank).  JAX's MODEL counts local devices inside
one process; the port's spans process ranks, because a port process
drives one device.  Every replica holds the whole model (the same seed),
whole or cut over its model ranks; rank 0 decides
(admission, hot swap, submits, cancels, arena promotions) and broadcasts
a :class:`~repro_torch.serve.mesh.StepPlan` every step over a gloo group
of the plan channel's own, followers replay it and land in an identical
state, and each plan broadcast and stats gather waits at most
``--step-timeout`` seconds, so a dead peer makes the survivors raise
instead of hanging; a dead model peer makes its survivors' next
collective on the model group raise within the same limit.

Two modes in one CLI:

* **spawn** (``--procs N``): launch N worker copies of this module on a
  fresh rendezvous port (:func:`repro_torch.launch.mesh.spawn`, torchrun's
  environment), supervise them (the first failure takes the rest down)
  and exit with the workers' status; ``--restart-on-failure`` relaunches
  a failed job on a fresh port, resuming from the previous generation's
  ``--journal``;
* **worker**: a rank of a job launched so (or by ``torchrun``, or by hand
  with ``--process-id I --num-processes N --coordinator HOST:PORT``):
  rank 0 serves the request trace, followers replay plans, and each rank
  writes its results to ``--out-json`` (followers append ``.pI``), rank 0
  also the Prometheus text of every rank's series (``.prom``).

  python -m repro_torch.launch.distributed --procs 2 --dist-backend gloo \
      --requests 4 --max-new 8 --out-json /tmp/dist.json
  python -m repro_torch.launch.distributed --procs 2 --smoke --device cpu \
      --mesh 2,1 --out-json /tmp/dist.json
  python -m repro_torch.launch.distributed --procs 2 --mesh 1,2 \
      --dist-backend gloo --out-json /tmp/tp.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.launch import mesh as mesh_lib


def build_parser() -> argparse.ArgumentParser:
    """The distributed CLI's argument parser: JAX's flags and defaults,
    and the port's ``--device``, ``--dtype`` and ``--dist-backend``."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.distributed",
        description="Multi-process mesh serving over torch.distributed "
                    "(PyTorch port)")
    # spawn mode
    ap.add_argument("--procs", type=int, default=0,
                    help="spawn N worker processes and supervise them "
                         "(0 = run as a worker in THIS process)")
    # worker topology (torchrun's environment, when set, wins)
    ap.add_argument("--process-id", type=int, default=0,
                    help="this worker's rank (0 = host-0 scheduler)")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="total worker count in the job")
    ap.add_argument("--coordinator", default="127.0.0.1:0",
                    help="rendezvous HOST:PORT of rank 0 (the spawner "
                         "sets torchrun's environment instead)")
    ap.add_argument("--step-timeout", type=float, default=60.0,
                    help="per-step plan-broadcast timeout in seconds; "
                         "a dead peer raises instead of hanging")
    ap.add_argument("--feed", default="host0",
                    choices=("host0", "replicated"),
                    help="host0: only host 0 sees the requests "
                         "(followers receive them in the plan, the "
                         "gateway path); replicated: every process "
                         "submits the trace locally")
    # model / trace (mirrors launch.serve)
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="registered LM arch to serve")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--mesh", default="1,1",
                    help="mesh 'DATA,MODEL': each replica's slots and "
                         "page pools split into DATA shards on its device; "
                         "MODEL > 1 cuts the weights and KV heads over "
                         "MODEL process ranks (--procs a multiple of it)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-request cap + pool sizing (0 = fit the "
                         "trace)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-lens", default="8,16",
                    help="comma list; requests cycle through these")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-json", default=None,
                    help="write {rid: tokens} + stats here (followers "
                         "append .p<rank>)")
    # fault tolerance
    ap.add_argument("--journal", default=None,
                    help="host-0 write-ahead request journal (JSONL); "
                         "restarted generations resume unfinished "
                         "requests from it token-identically")
    ap.add_argument("--resume-journal", default=None,
                    help="replay a previous generation's --journal on "
                         "host 0 before serving the trace")
    ap.add_argument("--fault-spec", default=None,
                    help="deterministic fault injection, comma list of "
                         "kind@step[:key=val...] (kinds kill|crash|"
                         "stall|corrupt|oom|disconnect; rank= picks "
                         "the victim process, default 0) — stripped "
                         "automatically on supervised restarts")
    ap.add_argument("--restart-on-failure", type=int, default=0,
                    help="spawn mode: on a worker failure, restart the "
                         "whole job up to N times on a fresh rendezvous "
                         "port, resuming from the previous generation's "
                         "--journal")
    # online LTFB arena (mirrors launch.serve; every rank mirrors the
    # roster, rank 0 owns the registry archive + write-back)
    ap.add_argument("--arena", default=None,
                    help="serve an N-member population roster from this "
                         "LTFB checkpoint dir as an ONLINE tournament: "
                         "champion serves, challengers draft, accept "
                         "rate scores matches, winners hot-swap in — "
                         "host 0 decides, the promotion rides the step "
                         "plan")
    ap.add_argument("--arena-policy", default="champion",
                    choices=("champion", "epsilon", "shadow"),
                    help="challenger routing: champion = best "
                         "challenger drafts (exploit); epsilon = mostly "
                         "best, periodically round-robin; shadow = "
                         "round-robin every stint (even sampling)")
    ap.add_argument("--arena-window", type=int, default=128,
                    help="sliding accept-rate window per member, in "
                         "speculative row-rounds (the match metric)")
    ap.add_argument("--arena-margin", type=float, default=0.02,
                    help="a challenger must beat the champion's "
                         "promotion-time accept rate by this margin to "
                         "win a match")
    ap.add_argument("--arena-min-samples", type=int, default=32,
                    help="proposals a challenger's window must hold "
                         "before it can qualify for promotion")
    ap.add_argument("--arena-hysteresis", type=int, default=2,
                    help="consecutive winning match evaluations before "
                         "a promotion fires")
    ap.add_argument("--arena-check-every", type=int, default=8,
                    help="scheduler steps between match evaluations")
    ap.add_argument("--arena-writeback", default=None,
                    help="rank 0 writes finished request/response "
                         "streams back as datastore token shards in "
                         "this dir (train->serve->train)")
    ap.add_argument("--arena-seq", type=int, default=64,
                    help="write-back row width minus one: rows are "
                         "(seq+1) tokens, matching launch/ltfb.py "
                         "--seq so shards re-ingest directly")
    # the port's own
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where each rank's replica, pools and kernels "
                         "run (cuda: card LOCAL_RANK %% count); cuda "
                         "raises when no card is visible")
    ap.add_argument("--dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="serve in this dtype instead of the config's "
                         "(weights drawn in f32 from the seed, then cast)")
    ap.add_argument("--dist-backend", default=None,
                    choices=("nccl", "gloo"),
                    help="the default process group's backend (default: "
                         "nccl on cuda, gloo on cpu; ranks sharing a card "
                         "need gloo).  Plans and stats always travel "
                         "over a gloo group of their own")
    return ap


def _strip_flags(argv: List[str], names) -> List[str]:
    """Drop ``--flag value`` / ``--flag=value`` pairs from an argv."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a.split("=", 1)[0] in names:
            skip = "=" not in a
            continue
        out.append(a)
    return out


def spawn(args, argv: List[str]) -> int:
    """Launch ``--procs`` worker copies of this module and supervise them
    (:func:`repro_torch.launch.mesh.spawn`: the first nonzero exit kills
    the remaining workers).

    With ``--restart-on-failure N`` a failed job is relaunched up to N
    times on a fresh port, ``--fault-spec`` stripped (the drill already
    fired) and, with a ``--journal``, each new generation journaling to
    ``<journal>.r<k>`` and resuming from the previous generation's, so the
    combined output equals an uninterrupted run's."""
    from repro_torch.launch.serve import parse_lens
    from repro_torch.serve.mesh import check_model_axis, parse_mesh

    data, model = parse_mesh(args.mesh)  # fail fast on a bad mesh ...
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {args.mesh!r}")
    check_model_axis(model, args.procs)  # ... or one --procs cannot hold
    parse_lens(args.prompt_lens)        # ... and on a bad trace spec
    passthrough = _strip_flags(argv, ("--procs",))
    restarts = max(0, int(args.restart_on_failure or 0))
    journal = args.journal
    attempt = 0
    while True:
        extra = passthrough
        if attempt > 0:
            extra = _strip_flags(passthrough, ("--fault-spec", "--journal",
                                               "--resume-journal"))
            if journal is not None:
                prev = journal if attempt == 1 \
                    else f"{journal}.r{attempt - 1}"
                extra += ["--journal", f"{journal}.r{attempt}",
                          "--resume-journal", prev]
        status = mesh_lib.spawn(
            [sys.executable, "-m", "repro_torch.launch.distributed", *extra],
            args.procs)
        if status == 0 or attempt >= restarts:
            return status
        attempt += 1
        print(f"[dist] worker failure (rc={status}); restarting the "
              f"job (attempt {attempt}/{restarts})"
              + (f", resuming from the generation-{attempt - 1} "
                 f"journal" if journal else ""), flush=True)


def _join(args):
    """This worker's (rank, world, device): a rank of a launched job
    (torchrun's environment, or the topology flags), else one process."""
    from repro_torch import resolve_device

    if not mesh_lib.launched() and args.num_processes > 1:
        host, port = args.coordinator.rsplit(":", 1)
        os.environ.update(RANK=str(args.process_id),
                          WORLD_SIZE=str(args.num_processes),
                          MASTER_ADDR=host, MASTER_PORT=port)
    if not mesh_lib.launched():
        return 0, 1, resolve_device(args.device)
    ranks = mesh_lib.init_ranks(args.dist_backend, args.device,
                                timeout_s=max(args.step_timeout, 10.0))
    return ranks.rank, ranks.world, ranks.device


def run_worker(args) -> int:
    """One worker process: join the job, serve the trace (rank 0) or
    replay plans (followers), write results."""
    rank, world, device = _join(args)
    import torch.distributed as dist

    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_requests, parse_lens
    from repro_torch.models.lm import init_lm
    from repro_torch.serve import journal as journal_mod
    from repro_torch.serve import telemetry as telemetry_mod
    from repro_torch.parallel.tensor import tensor_parallel
    from repro_torch.serve.mesh import MeshScheduler, parse_mesh

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.dtype:
        cfg = replace(cfg, dtype=args.dtype)
    # the same seed on every rank: identical replica weights
    model = init_lm(cfg, seed=args.seed, device=device)
    lens = parse_lens(args.prompt_lens)
    max_len = args.max_len or max(lens) + args.max_new
    journal = None
    if args.journal and rank == 0:
        journal = journal_mod.RequestJournal(args.journal)
    faults = None
    if args.fault_spec:
        from repro_torch.serve.faults import FaultInjector
        faults = FaultInjector(args.fault_spec, rank=rank)
    # online LTFB arena: every rank mirrors the roster (promotions are
    # replayed from the plan); rank 0 alone archives and writes back.
    # Every rank replays the journaled arena state on resume (a shared
    # filesystem), so the mesh starts on the same champion
    arena, spec_tokens, draft = None, 0, None
    if args.arena:
        from repro_torch.launch.serve import make_arena
        arena = make_arena(args, cfg, model, device, rank=rank)
        spec_tokens = 4
        draft = init_lm(cfg, seed=args.seed, device=device)
    sched = MeshScheduler(
        cfg, model, mesh_shape=parse_mesh(args.mesh),
        step_timeout_s=args.step_timeout,
        num_slots=args.slots, max_len=max_len,
        journal=journal, faults=faults, arena=arena,
        draft_params=draft, spec_tokens=spec_tokens, device=device)
    tp = tensor_parallel(sched.session.model)
    shard = ""
    if tp is not None:
        rank_cfg = sched.session.model.cfg
        cut = ",".join(k for k in ("heads", "mlp", "vocab")
                       if getattr(tp.plan, k))
        shard = (f" model_rank={tp.rank}/{tp.size} heads="
                 f"{rank_cfg.num_heads}/{rank_cfg.num_kv_heads} cut={cut}")
    print(f"[dist] rank={rank}/{world} arch={cfg.name} device={device} "
          f"mesh={args.mesh} feed={args.feed} "
          f"slots={sched.pool.num_slots} "
          f"channel={type(sched.channel).__name__}{shard}", flush=True)
    reqs = build_requests(cfg, args.requests, lens, args.max_new,
                          temperature=args.temperature, seed=args.seed)
    prefixes: dict = {}
    resumed: set = set()
    if rank == 0 and args.resume_journal:
        entries = journal_mod.replay(args.resume_journal)
        prefixes = journal_mod.resume_scheduler(sched, entries)
        resumed = set(entries)
        print(f"[dist] rank=0 journal: replayed {len(entries)} "
              f"request(s) from {args.resume_journal} "
              f"(requeued {sched.stats.journal_replayed} unfinished)",
              flush=True)
    if rank == 0:
        for r in reqs:
            if r.rid in resumed:    # the journal already owns this rid
                continue
            sched.submit(r)
        try:
            while sched.queue or sched.active or sched.prefilling:
                sched.step()
        except RuntimeError as e:
            # a peer died: make the in-flight state durable before dying
            # so that a restarted generation can resume
            if journal is not None:
                journal.record_note("peer_death", error=str(e)[:200])
                journal.close()
            raise
        sched.shutdown()
        results = sched.results
        if prefixes:
            results = journal_mod.stitched_results(results, prefixes)
    else:
        if args.feed == "replicated":
            # the dedupe path: the plan's submits must be recognised as
            # copies already held, not enqueued twice
            for r in reqs:
                sched.submit(r)
        results = sched.run_follower()
    if journal is not None:
        journal.close()
    sched.stats.stop()
    if rank == 0:
        sched.stats.report(prefix="[dist]")
        if arena is not None:
            arena.report(prefix="[dist][arena]")
    if arena is not None:
        arena.close()
    out = {"rank": rank,
           "results": {str(rid): [int(t) for t in toks]
                       for rid, toks in results.items()},
           "stats": sched.stats.as_dict(),
           # the plan channel's host seconds (ProcessGroupChannel only)
           "channel": getattr(sched.channel, "timing", None),
           # the model group's collectives (model > 1 only)
           "model_group": None if tp is None else {
               "all": dict(tp.timing),
               "decode": dict(sched.session.decode_collectives)}}
    if arena is not None:
        out["arena"] = arena.snapshot()
    if rank == 0:
        # the gathered per-rank snapshots: rank 0's export covers every
        # process's counters
        out["mesh_stats"] = {str(r): s
                             for r, s in sched.remote_stats.items()}
    if args.out_json:
        path = args.out_json if rank == 0 \
            else f"{args.out_json}.p{rank}"
        with open(path, "w") as f:
            json.dump(out, f)
        print(f"[dist] rank={rank} wrote {path} "
              f"({len(results)} results)", flush=True)
        if rank == 0:
            with open(path + ".prom", "w") as f:
                f.write(telemetry_mod.scheduler_prometheus(sched))
            print(f"[dist] rank=0 wrote {path}.prom "
                  f"(Prometheus exposition, all ranks)", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry point: spawn mode with ``--procs``, else worker."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.procs > 0:
        return spawn(args, argv)
    try:
        return run_worker(args)
    except Exception:
        import traceback
        traceback.print_exc()
        # hard exit: a failed worker must die, not wait in an exit
        # handler for the peers it just lost; the supervisor takes the
        # rest down
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


if __name__ == "__main__":
    sys.exit(main())
